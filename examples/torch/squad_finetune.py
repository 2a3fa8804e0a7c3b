"""BERT-Large SQuAD-style fine-tune on the port: the compressed-comm workload.

Counterpart of ``examples/squad_finetune.py`` (the reference Bagua's
``examples/squad/main.py``, the workload its BASELINE names for ByteGrad and
QAdam).  A span head (start/end logits) sits on the Transformer encoder
trunk (``TransformerLM(head=False)``); the data is SQuAD-shaped and
synthetic (seq 384, span labels) unless ``--dataset`` names a tokenized
``.npz`` (``input_ids``, ``start_positions``, ``end_positions``).

    python examples/torch/squad_finetune.py --algorithm bytegrad --steps 10
    bagua-tpu-torch-run --nproc_per_node 2 examples/torch/squad_finetune.py
    python examples/torch/squad_finetune.py --tiny --device cpu --seq 64 --batch 1

On the card it runs the flash kernels (K6a-c, head_dim 64) and, under
ByteGrad at world 2 or more, the MinMaxUInt8 codec (K1, K2).
"""

import argparse
import functools
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch import nn  # noqa: E402

import bagua_tpu_torch as bt  # noqa: E402
from bagua_tpu_torch.device import resolve_device  # noqa: E402
from bagua_tpu_torch.models.transformer import (  # noqa: E402
    TransformerConfig,
    TransformerLM,
    bert_large_config,
)


class SquadModel(nn.Module):
    """Encoder trunk + span-extraction head (start/end logits), with flax's
    module names (``TransformerLM_0``, ``qa_head``)."""

    def __init__(self, cfg: TransformerConfig, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.TransformerLM_0 = TransformerLM(cfg, device=device, seed=seed, head=False)
        self.qa_head = nn.Linear(cfg.d_model, 2, device=device)
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        with torch.no_grad():
            self.qa_head.weight.normal_(0.0, 1.0 / math.sqrt(cfg.d_model), generator=gen)
            self.qa_head.bias.zero_()

    def forward(self, input_ids):
        logits = self.qa_head(self.TransformerLM_0(input_ids))
        return logits[..., 0], logits[..., 1]    # start, end: [B, S]


def squad_loss_fn(model, batch):
    """The mean of the start and end cross-entropies."""
    s_logits, e_logits = model(batch["ids"].long())
    return 0.5 * (F.cross_entropy(s_logits, batch["start"].long())
                  + F.cross_entropy(e_logits, batch["end"].long()))


def make_algorithm(name: str, lr: float):
    """The algorithm and the optimizer factory (None where the algorithm
    owns its optimizer); AdamW with optax's defaults (weight decay 1e-4)."""
    adamw = functools.partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=1e-4)
    if name == "bytegrad":
        return bt.ByteGradAlgorithm(hierarchical=False), adamw
    if name == "qadam":
        return bt.QAdamAlgorithm(warmup_steps=20, lr=lr, hierarchical=False), None
    return bt.GradientAllReduceAlgorithm(), adamw


def model_config(args) -> TransformerConfig:
    dtype = getattr(torch, args.dtype)
    if args.tiny:
        return TransformerConfig(vocab_size=1024, d_model=128, n_heads=4, n_layers=4,
                                 d_ff=512, max_seq_len=args.seq, dtype=dtype)
    return bert_large_config(max_seq_len=args.seq, dtype=dtype)


def make_data(args, cfg, batch):
    """The rows the run cycles through: the whole ``--dataset`` file cut to
    whole global batches, or one synthetic batch from seed 0."""
    if args.dataset:
        data = np.load(args.dataset)
        n_rows = (len(data["input_ids"]) // batch) * batch
        if n_rows == 0:
            raise SystemExit(f"dataset has fewer than {batch} rows")
        return (data["input_ids"][:n_rows].astype(np.int64),
                data["start_positions"][:n_rows].astype(np.int64),
                data["end_positions"][:n_rows].astype(np.int64))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (batch, args.seq)).astype(np.int64)
    starts = rng.integers(0, args.seq, batch).astype(np.int64)
    ends = np.minimum(starts + rng.integers(1, 16, batch), args.seq - 1).astype(np.int64)
    return ids, starts, ends


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--algorithm", default="bytegrad",
                    choices=["gradient_allreduce", "bytegrad", "qadam"])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8, help="rows a rank")
    ap.add_argument("--seq", type=int, default=384)
    ap.add_argument("--lr", type=float, default=3e-5)
    ap.add_argument("--tiny", action="store_true", help="4-layer config for CPU runs")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                    help="the activations' dtype (parameters are f32)")
    ap.add_argument("--dataset", type=str, default=None,
                    help=".npz with input_ids/start_positions/end_positions")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def run(args, params=None) -> dict:
    """Fine-tune for ``args.steps`` steps.  ``params``: a flax param tree of
    ``SquadModel`` as numpy arrays (the JAX example's init), loaded through
    ``models.convert.params_from_jax``; None draws the weights from seed 0.
    Returns the losses, the throughput and the trained model and trainer."""
    device = resolve_device(args.device)
    bt.init_process_group(device=device)
    world = bt.get_world_size()
    batch = args.batch * world
    cfg = model_config(args)
    model = SquadModel(cfg, device=device)
    if params is not None:
        from bagua_tpu_torch.models.convert import params_from_jax

        model.load_state_dict(params_from_jax(params, model))
    ids, starts, ends = make_data(args, cfg, batch)
    algo, opt = make_algorithm(args.algorithm, args.lr)
    trainer = bt.BaguaTrainer(squad_loss_fn, opt, algo, device=device, model_name="squad")
    state = trainer.init(model)
    n_batches = max(1, len(ids) // batch)
    shards = {}     # shard lazily: only the batches --steps touches

    def shard(k):
        if k not in shards:
            rows = slice(k * batch, (k + 1) * batch)
            shards[k] = trainer.shard_batch(
                {"ids": ids[rows], "start": starts[rows], "end": ends[rows]},
                global_batch=True)
        return shards[k]

    losses, t0 = [], None
    for step in range(args.steps):
        state, loss = trainer.train_step(state, shard(step % n_batches))
        losses.append(loss.item())      # reads the loss: the step has finished
        if step == 0:
            t0 = time.perf_counter()
    dt = time.perf_counter() - t0
    seq_per_sec = (args.steps - 1) * batch / dt if args.steps > 1 else float("nan")
    print(f"algorithm={args.algorithm} first_loss={losses[0]:.4f} "
          f"final_loss={losses[-1]:.4f} throughput={seq_per_sec:.2f} seq/s", flush=True)
    return {"losses": losses, "seq_per_sec": seq_per_sec, "world": world, "batch": batch,
            "model": model, "trainer": trainer, "state": state}


def main(argv=None):
    out = run(parser().parse_args(argv))
    assert out["losses"][-1] < out["losses"][0], "no learning signal"


if __name__ == "__main__":
    main()
