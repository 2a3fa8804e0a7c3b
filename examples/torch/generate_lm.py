"""Train a tiny LM on the port, then decode with the KV cache: one rank's
``generate`` and, at two ranks or more, tensor-parallel ``generate_tp``.

Counterpart of ``examples/generate_lm.py``.  The LM memorizes a fixed token
sequence, fed through the prefetching input pipeline
(``contrib.prefetch_to_device``); then both decoders must regenerate the
sequence's continuation from its first four tokens.

    python examples/torch/generate_lm.py --device cpu
    bagua-tpu-torch-run --nproc_per_node 2 examples/torch/generate_lm.py

At world 2 or more the trained (replicated) weights are cut into tp 2
slices (heads and MLP width split two ways) over a ``{"rep": world / 2,
"tp": 2}`` mesh.
"""

import argparse
import dataclasses
import functools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import bagua_tpu_torch as bt  # noqa: E402
from bagua_tpu_torch.contrib import prefetch_to_device  # noqa: E402
from bagua_tpu_torch.device import resolve_device  # noqa: E402
from bagua_tpu_torch.models.generate import generate, generate_tp  # noqa: E402
from bagua_tpu_torch.models.transformer import (  # noqa: E402
    TransformerConfig,
    TransformerLM,
    lm_loss_fn,
)

SEQ = np.array([3, 14, 15, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 31, 8], np.int64)
CFG = TransformerConfig(vocab_size=32, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                        max_seq_len=24, dtype=torch.float32)


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=int(os.environ.get("BAGUA_EXAMPLE_STEPS", "80")),
                    help="training steps (default: BAGUA_EXAMPLE_STEPS, else 80)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def run(args, params=None) -> dict:
    """Train, then decode.  ``params``: a flax param tree of the JAX
    example's ``TransformerLM`` (numpy), loaded through ``params_from_jax``;
    None draws from seed 0.  Returns the losses and both decoders' tokens
    (``tp`` None below two ranks); raises if a decoder does not regenerate
    the sequence."""
    device = resolve_device(args.device)
    bt.init_process_group(device=device)
    world = bt.get_world_size()
    model = TransformerLM(CFG, device=device, seed=0)
    if params is not None:
        from bagua_tpu_torch.models.convert import params_from_jax

        model.load_state_dict(params_from_jax(params, model))
    tokens = np.tile(SEQ, (8, 1))       # this rank's 8 rows
    trainer = bt.BaguaTrainer(lm_loss_fn, functools.partial(torch.optim.Adam, lr=1e-2),
                              bt.GradientAllReduceAlgorithm(), device=device, autotune=False)
    state = trainer.init(model)
    losses = []
    for batch in prefetch_to_device(({"tokens": tokens} for _ in range(args.steps)),
                                    trainer=trainer, size=2):
        state, loss = trainer.train_step(state, batch)
        losses.append(loss.item())
    print(f"final train loss: {losses[-1]:.5f}", flush=True)

    trained = trainer.unstack_params(state)
    prompt = torch.from_numpy(tokens[:2, :4]).to(device)
    expect = np.tile(SEQ[4:-1], (2, 1))
    out = generate(state.model, prompt, SEQ.size - 5).cpu().numpy()
    print("generated (1 device):", out[0].tolist(), flush=True)
    assert (out == expect).all(), (out[0], expect[0])

    out_tp = None
    if world >= 2 and world % 2 == 0:
        # the replicated weights drive tensor-parallel decode: generate_tp
        # cuts every rank's heads and MLP width out of the global tensors
        cfg_tp = dataclasses.replace(CFG, tp_axis="tp", tp_size=2)
        mesh = bt.build_mesh({"rep": world // 2, "tp": 2})
        out_tp = generate_tp(TransformerLM(cfg_tp, device=device), trained, prompt,
                             SEQ.size - 5, mesh).cpu().numpy()
        print("generated (tp=2):    ", out_tp[0].tolist(), flush=True)
        assert (out_tp == expect).all(), (out_tp[0], expect[0])
    print("generate_lm OK", flush=True)
    return {"losses": losses, "tokens": out.tolist(),
            "tokens_tp": None if out_tp is None else out_tp.tolist(), "world": world}


def main(argv=None):
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
