"""One rank of the port's trainer-feature runs over gloo
(tests/test_torch_grad_accum.py, tests/test_torch_flat_resident.py,
tests/test_torch_grad_guard.py).

    python torch_features_worker.py RANK WORLD INIT_METHOD DATA_NPZ PARAMS_NPZ OUT_NPZ STEPS RUNS

Trains the golden-task MLP (the flax params of ``PARAMS_NPZ`` held in flax's
layout, ``torch_trainer_worker.FlaxLayoutMLP``) on this rank's contiguous
slice of the one fixed batch of ``DATA_NPZ`` for each run of the
comma-separated ``RUNS``.  A run is ``BASE[:OPTION...]``: ``BASE`` a name of
``BASES`` below, each option one of ``accum=K`` (``accum_steps``), ``leaf``
(``flat_resident="off"``), ``on`` (``"on"``), ``guard`` (``grad_guard=
"skip"``), ``poison=K`` (``grad.poison`` armed in code at step K),
``steps=N`` (else ``STEPS``), ``rebucket=K`` (re-bucket to 64-byte buckets
before step K), ``overlap=on|off|auto`` (the overlap scheduler), ``chunk=B``
(``overlap_chunk_bytes``), ``bucket=B`` (``bucket_bytes``).  A ``grad.poison`` plan in ``BAGUA_FAULT_PLAN`` arms it where
the spawner set it.  Keys of ``OUT_NPZ``, under ``<run>/``: the losses, the
final parameters by name, whether the layout was resident, the plan's bucket
sizes (``padded``), the error-feedback residual (``ef``, its buckets
concatenated, empty without one) and its bucket sizes (``ef_sizes``), the
element counts of the optimizer state tensors shaped like a flat
(``opt_sizes``), the guard counters' and async counters' deltas
(``counter/<name>``), the trainer's ``_guard_rewinds_total``, and for the
gossip families the parameter flats and the peer weights after every step
(``trace/params``, ``trace/peer_weights``, buckets concatenated), the final
plan's tensor names a bucket (``plan``, one ``,``-joined string a bucket),
whether the overlap scheduler ran (``overlapped``) and whether it rebucketed
by readiness (``ordered``).
Imports only torch, numpy and the port.
"""

import contextlib
import functools
import os
import subprocess
import sys

import numpy as np
import torch

import bagua_tpu_torch as bt
from bagua_tpu_torch.bucket import split_bucket_by_bucket_size
from bagua_tpu_torch.faults.inject import FaultSpec, fault_scope
from bagua_tpu_torch.telemetry import counters

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_trainer_worker import FlaxLayoutMLP  # noqa: E402

SGD = functools.partial(torch.optim.SGD, lr=0.1)
SGD_MOMENTUM = functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9)
ADAM = functools.partial(torch.optim.Adam, lr=1e-2)
ADAMW = functools.partial(torch.optim.AdamW, lr=1e-2)

#: name -> (algorithm factory, optimizer factory, BaguaTrainer keywords)
BASES = {
    "ga": (bt.GradientAllReduceAlgorithm, SGD, {}),
    "ga_momentum": (bt.GradientAllReduceAlgorithm, SGD_MOMENTUM, {}),
    "adamw": (bt.GradientAllReduceAlgorithm, ADAMW, {}),
    "zero_adam": (lambda: bt.ZeroOptimizerAlgorithm(ADAM), None, {}),
    "qadam": (lambda: bt.QAdamAlgorithm(warmup_steps=2, lr=1e-2, hierarchical=False), None, {}),
    "bytegrad": (lambda: bt.ByteGradAlgorithm(hierarchical=False), SGD, {}),
    # the two-level forms where LOCAL_WORLD_SIZE makes two nodes
    "ga_hier": (lambda: bt.GradientAllReduceAlgorithm(hierarchical=True), SGD, {}),
    "bytegrad_hier": (bt.ByteGradAlgorithm, SGD, {}),
    "dec_all": (lambda: bt.DecentralizedAlgorithm(hierarchical=False, track_peer_weights=True),
                SGD, {}),
    "lowprec": (lambda: bt.LowPrecisionDecentralizedAlgorithm(hierarchical=False), SGD, {}),
    "onebit": (bt.GradientAllReduceAlgorithm, SGD, {"compress_intra": "onebit_ef"}),
    # tests/test_async_model_average.py's grad-guard veto: warmup 1, period 3
    "async": (lambda: bt.AsyncModelAverageAlgorithm(warmup_steps=1, period_steps=3,
                                                    max_staleness_rounds=0),
              functools.partial(torch.optim.SGD, lr=0.05), {}),
}
COUNTERS = ("grad_guard/skipped_steps", "grad_guard/unhealthy_steps", "grad_guard/aborts",
            "faults/grad.poison/fired", "faults/grad.poison/recovered",
            "async/rounds_dropped", "async/missed_boundaries")


def parse(run, steps):
    base, *opts = run.split(":")
    cfg = {"base": base, "steps": steps, "kw": {}, "poison": None, "rebucket": None}
    for opt in opts:
        key, _, value = opt.partition("=")
        if key == "accum":
            cfg["kw"]["accum_steps"] = int(value)
        elif key in ("leaf", "on"):
            cfg["kw"]["flat_resident"] = "off" if key == "leaf" else "on"
        elif key == "guard":
            cfg["kw"]["grad_guard"] = "skip"
        elif key == "overlap":
            cfg["kw"]["overlap"] = value
        elif key in ("chunk", "bucket"):
            cfg["kw"]["overlap_chunk_bytes" if key == "chunk" else "bucket_bytes"] = int(value)
        elif key in ("poison", "steps", "rebucket"):
            cfg[key] = int(value)
        else:
            raise ValueError(f"unknown option {opt!r} of run {run!r}")
    return cfg


def flat_trace(trainer, model, algo_state):
    named = {n: p.detach() for n, p in model.named_parameters()}
    out = {"params": torch.cat(trainer.plan.flatten(named)).numpy().copy()}
    if algo_state and "peer_weights" in algo_state:
        out["peer_weights"] = torch.cat(algo_state["peer_weights"]).numpy().copy()
    return out


def run_one(run, steps, batch, params_path):
    cfg = parse(run, steps)
    algo_factory, opt, kw = BASES[cfg["base"]]
    model = FlaxLayoutMLP(np.load(params_path))
    trainer = bt.BaguaTrainer(lambda m, b: torch.nn.functional.cross_entropy(m(b["x"]), b["y"]),
                              opt, algo_factory(), device="cpu", **kw, **cfg["kw"])
    state = trainer.init(model)
    batch = trainer.shard_batch(batch)
    before = counters.snapshot()
    scope = (fault_scope(FaultSpec("grad.poison", step=cfg["poison"]))
             if cfg["poison"] is not None else contextlib.nullcontext())
    losses, trace = [], {}
    gossip = not trainer.algorithm.replicated_params and "peer_weights" in (state.algo_state or {})
    with scope:
        for i in range(cfg["steps"]):
            if i == cfg["rebucket"]:
                decls = [t.declaration() for b in trainer.plan.buckets for t in b.tensors]
                trainer.rebucket(split_bucket_by_bucket_size(decls, 64))
            state, loss = trainer.train_step(state, batch)
            losses.append(loss.item())
            if gossip:
                for k, v in flat_trace(trainer, model, state.algo_state).items():
                    trace.setdefault(k, []).append(v)
        trainer.flush_grad_health()
    if cfg["base"] == "async":
        state = trainer.algorithm.barrier(trainer, state)
    ef = (state.algo_state or {}).get("ef")
    ef = [] if ef is None else list(ef["buckets"])
    opt_obj = state.optimizer if state.optimizer is not None else getattr(
        state.opt_state, "optimizer", None)
    opt_sizes = [] if opt_obj is None else [
        t.numel() for st in opt_obj.state.values() for t in st.values()
        if torch.is_tensor(t) and t.dim() == 1]
    out = {"losses": np.array(losses), "resident": trainer._flat_resident,
           "padded": np.array([b.padded_numel for b in trainer.plan.buckets]),
           "ef": torch.cat(ef).numpy() if ef else np.zeros(0, np.float32),
           "ef_sizes": np.array([r.numel() for r in ef]), "opt_sizes": np.array(opt_sizes),
           "rewinds_total": trainer._guard_rewinds_total,
           "plan": np.array([",".join(t.name for t in b.tensors) for b in trainer.plan.buckets]),
           "overlapped": trainer._ctx.overlap, "ordered": trainer._overlap_ordered}
    out.update({f"counter/{c}": counters.get(c) - before.get(c, 0) for c in COUNTERS})
    out.update({n: p.detach().numpy().copy() for n, p in model.named_parameters()})
    out.update({f"trace/{k}": np.stack(v) for k, v in trace.items()})
    return {f"{run}/{k}": v for k, v in out.items()}


def spawn(world, runs, tmp, steps, rank_env=None):
    """Run ``world`` ranks of this worker on the golden task (the caller's
    test process imports the JAX package; the workers do not) and return
    each rank's outputs.  ``rank_env[r]`` adds to rank r's environment."""
    import bench

    _, params, batch = bench.golden_task()
    np.savez(tmp / "data.npz", x=np.asarray(batch["x"]), y=np.asarray(batch["y"]))
    np.savez(tmp / "params.npz", **{f"{layer}.{k}": np.asarray(v)
                                    for layer, leaves in params.items()
                                    for k, v in leaves.items()})
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    base = {**os.environ, "OMP_NUM_THREADS": "1",
            "PYTHONPATH": os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")])}
    outs = [tmp / f"out{r}.npz" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         f"file://{tmp / 'store'}", str(tmp / "data.npz"), str(tmp / "params.npz"),
         str(outs[r]), str(steps), ",".join(runs)],
        env={**base, **((rank_env or {}).get(r, {}))}) for r in range(world)]
    try:
        codes = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert codes == [0] * world, codes
    return [dict(np.load(o)) for o in outs]


def main(rank, world, init_method, data_path, params_path, out_path, steps, runs):
    torch.set_num_threads(1)
    bt.init_process_group(init_method, world_size=world, rank=rank, device="cpu")
    data = np.load(data_path)
    rows = data["x"].shape[0] // world
    part = slice(rank * rows, (rank + 1) * rows)
    batch = {"x": data["x"][part], "y": data["y"][part].astype(np.int64)}
    out = {}
    for run in runs.split(","):
        out.update(run_one(run, steps, batch, params_path))
    np.savez(out_path, **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    r, w, init, data, params, out, steps, runs = sys.argv[1:]
    main(int(r), int(w), init, data, params, out, int(steps), runs)
