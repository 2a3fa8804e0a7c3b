"""Every parallelism axis of the port in one script: dp, hierarchical, tp, pp,
sp, ep, dp x pp x tp, and ZeRO-1 with gradient accumulation.

Counterpart of ``examples/parallelism_zoo.py``, which runs its rows on 8
virtual CPU devices.  Here every row runs on the ranks of the launcher's
world, its mesh sized from the world: the JAX rows' model axis (tp, pp, sp,
ep 4; the 3-D row's pp 2 x tp 2) is capped at half the world (at least 2),
and dp takes the rest.  At world 8 the meshes are the JAX example's.  A row
that needs more ranks than the world has is printed as skipped with its
reason.

    bagua-tpu-torch-run --nproc_per_node 8 examples/torch/parallelism_zoo.py --device cpu
    bagua-tpu-torch-run --nproc_per_node 4 examples/torch/parallelism_zoo.py --backend gloo

On the card the sp row's ring attention runs the flash kernels (K6a-c) and
the ep row's dropless MoE the grouped matmul (K7a, K7b).
"""

import argparse
import functools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import bagua_tpu_torch as bt  # noqa: E402
from bagua_tpu_torch.device import resolve_device  # noqa: E402
from bagua_tpu_torch.models.transformer import TransformerConfig  # noqa: E402

VOCAB, SEQ, ROWS, STEPS = 64, 16, 16, 5


def _cfg(**kw):
    return TransformerConfig(vocab_size=VOCAB, d_model=32, n_heads=4, n_layers=4, d_ff=64,
                             max_seq_len=SEQ, dtype=torch.float32, **kw)


def _model_axis(world: int, want: int) -> int:
    """The size of a row's model axis at ``world`` ranks: the JAX row's
    ``want``, at most half the world, at least 2."""
    return min(want, max(2, world // 2))


def rows(world: int):
    """``(name, mesh axes or None, why skipped)`` of every row at ``world``."""
    x = _model_axis(world, 4)
    out = [(f"dp={world}", {"dp": world}, None)]
    if world >= 4:
        out.append((f"hierarchical inter=2 x intra={world // 2}",
                    {"inter": 2, "intra": world // 2}, None))
    else:
        out.append(("hierarchical", None, f"needs 2 nodes of 2 ranks or more (world {world})"))
    for axis, label in (("tp", "tp={x}"), ("pp", "pp={x} (2 microbatches)"),
                        ("sp", "sp={x} (ring attention)"), ("ep", "ep={x} (dropless MoE)")):
        if world >= 2:
            out.append((f"dp={world // x} x " + label.format(x=x), {"dp": world // x, axis: x},
                        None))
        else:
            out.append((axis, None, "needs 2 ranks or more"))
    if world >= 4 and world % 4 == 0:
        out.append((f"dp={world // 4} x pp=2 x tp=2 (3-D)", {"dp": world // 4, "pp": 2, "tp": 2},
                    None))
    else:
        out.append(("dp x pp x tp (3-D)", None, f"needs a multiple of 4 ranks (world {world})"))
    out.append((f"dp={world} ZeRO-1 + accum=2", {"dp": world}, None))
    return out


def _build(name, axes, device, adam):
    """The row's model and trainer (the global mesh is set)."""
    import bagua_tpu_torch.parallel.pipeline as pipe
    from bagua_tpu_torch.models.transformer import TransformerLM, lm_loss_fn, sp_lm_loss_fn

    mesh = bt.get_global_mesh()
    gen = torch.Generator(device=device)
    if "ZeRO" in name:
        model = TransformerLM(_cfg(), device=device, seed=1)
        algo = bt.ZeroOptimizerAlgorithm(adam, clip_global_norm=1.0)
        return model, bt.BaguaTrainer(lm_loss_fn, None, algo, device=device, mesh=mesh,
                                      accum_steps=2, autotune=False)
    ga = bt.GradientAllReduceAlgorithm(hierarchical="inter" in axes)
    kw = dict(device=device, mesh=mesh, autotune=False)
    if "pp" in axes:
        tp = axes.get("tp", 1)
        cfg = _cfg(tp_axis="tp", tp_size=tp) if tp > 1 else _cfg()
        model = pipe.PipelinedTransformerLM(cfg, axes["pp"], n_microbatches=2, device=device)
        pipe.globalize_pp_params(model, gen.manual_seed(5), axes["pp"], tp_size=tp)
        if tp > 1:
            kw["tp_axis"] = "tp"
        return model, bt.BaguaTrainer(pipe.pp_lm_loss_fn, adam, ga, pp_axis="pp", **kw)
    if "tp" in axes:
        model = TransformerLM(_cfg(tp_axis="tp", tp_size=axes["tp"]), device=device, seed=2)
        bt.globalize_tp_params(model, gen.manual_seed(3), axes["tp"])
        return model, bt.BaguaTrainer(lm_loss_fn, adam, ga, tp_axis="tp", **kw)
    if "sp" in axes:
        model = TransformerLM(_cfg(sp_axis="sp"), device=device, seed=6,
                              attn_fn=bt.make_ring_attention(axes["sp"]))
        return model, bt.BaguaTrainer(sp_lm_loss_fn(axes["sp"]), adam, ga, seq_axis="sp", **kw)
    if "ep" in axes:
        def mlp(i):
            if i != 1:
                return None
            return lambda: bt.MoEMLP(8, 64, d_model=32, k=2, ep_size=axes["ep"], dropless=True,
                                     dtype=torch.float32)

        model = TransformerLM(_cfg(), device=device, seed=7, mlp_factory=mlp)
        bt.globalize_expert_params(model, gen.manual_seed(8))
        return model, bt.BaguaTrainer(bt.moe_lm_loss_fn(), adam, ga, expert_axis="ep", **kw)
    model = TransformerLM(_cfg(), device=device, seed=1)
    return model, bt.BaguaTrainer(lm_loss_fn, adam, ga, **kw)


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None,
                    help="nccl (the card's default) or gloo (the CPU's; several ranks on "
                         "one card)")
    return ap


def run(args, params=None) -> dict:
    """Every row for ``args.steps`` Adam steps on one batch of 16 sequences
    (numpy seed 0).  ``params`` is unused.  Returns each row's losses and
    the skipped rows with their reasons."""
    device = resolve_device(args.device)
    bt.init_process_group(device=device, backend=args.backend)
    world = bt.get_world_size()
    tokens = np.random.default_rng(0).integers(0, VOCAB, (ROWS, SEQ + 1)).astype(np.int64)
    adam = functools.partial(torch.optim.Adam, lr=1e-2)
    losses, skipped = {}, {}
    for name, axes, why in rows(world):
        if axes is None:
            skipped[name] = why
            print(f"{name:32s} skipped: {why}", flush=True)
            continue
        bt.set_global_mesh(bt.build_mesh(axes))
        try:
            model, trainer = _build(name, axes, device, adam)
            state = trainer.init(model)
            batch = trainer.shard_batch({"tokens": tokens}, global_batch=True)
            losses[name] = []
            for _ in range(args.steps):
                state, loss = trainer.train_step(state, batch)
                losses[name].append(loss.item())
            print(f"{name:32s} loss after {args.steps} steps: {losses[name][-1]:.4f}",
                  flush=True)
            del model, trainer, state
        finally:
            bt.set_global_mesh(None)
    print("all parallelism axes ran", flush=True)
    return {"losses": losses, "skipped": skipped, "world": world}


def main(argv=None):
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
