"""One rank of the port's checkpoint runs over gloo
(tests/test_torch_checkpoint.py, tests/test_torch_elastic_resume.py,
tests/test_torch_async_model_average.py).

    python torch_checkpoint_worker.py RANK WORLD INIT_METHOD DATA_NPZ PARAMS_NPZ OUT_JSON CKPT_ROOT RUNS

Trains the golden-task MLP (the flax params of ``PARAMS_NPZ`` in flax's
layout, ``torch_trainer_worker.FlaxLayoutMLP``) on this rank's contiguous
slice of the one fixed batch of ``DATA_NPZ``.  ``RUNS`` is a comma-separated
list of ``KIND:FAMILY[:N]`` (``FAMILY`` a name of ``FAMILIES`` below):

- ``resume:F``: an uninterrupted run of ``STEPS`` steps against a run of
  ``SAVE_AT`` steps, an async save, one more step before ``wait()`` (the
  snapshot must hold the state at the save), then a fresh trainer that
  restores and runs the rest.  Both runs call ``prepare`` at the save point
  (async model average's ``sync_for_checkpoint``), and the uninterrupted one
  then the algorithm's ``on_restore``, as the restore does.  Records both
  runs' losses, the restored step and the digest of each run's final state
  (``trainer._checkpoint_state``).
- ``fallback:write`` / ``fallback:sidecar``: saves at steps 2 and 4, the
  second with ``ckpt.write`` armed on rank 1 alone (``torn``), or
  ``ckpt.sidecar`` on rank 0, the sidecar's writer; then a restore of the
  newest verified step on every rank.  Records the restored step and the
  integrity counters' deltas.
- ``save:F:N[:DIR]``: ``N`` steps (``prepare`` after them), then a save
  under ``CKPT_ROOT/DIR`` (``DIR`` defaults to ``F``).  ``nosync:F:N[:DIR]``
  the same without ``prepare``.  Records the losses, the parameters' digest
  and the error-feedback residual's digest a tensor (``ef``).
- ``load:F:N[:DIR]``: a fresh trainer restores the newest step of
  ``CKPT_ROOT/DIR`` (converting what the layouts ask for), then trains ``N``
  steps.  Records the step, the parameters' digest right after the restore,
  the residual's digest a tensor and its absolute sum, the trainer's log
  lines, the losses; an exception is recorded by its message.
- ``reset:async:N``: ``N`` steps, ``sync_for_checkpoint``, a save; a second
  trainer takes ``N - 2`` steps of its own schedule, restores, and records
  its schedule right after the restore and after ``N`` more steps.
- ``meta:F``: the layout metadata of a fresh trainer.

The JSON output holds, by run, what each kind records.  Imports only torch,
numpy and the port.
"""

import functools
import json
import logging
import os
import subprocess
import sys

import numpy as np
import torch

import bagua_tpu_torch as bt
from bagua_tpu_torch.checkpoint import compute_state_digest
from bagua_tpu_torch.faults.inject import FaultSpec, fault_scope
from bagua_tpu_torch.telemetry import counters

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_trainer_worker import FlaxLayoutMLP  # noqa: E402

SGD = functools.partial(torch.optim.SGD, lr=0.1)
ADAM = functools.partial(torch.optim.Adam, lr=1e-2)
ADAMW = functools.partial(torch.optim.AdamW, lr=1e-2)
STEPS, SAVE_AT = 6, 3

#: name -> (algorithm factory, optimizer factory, BaguaTrainer keywords)
FAMILIES = {
    "ga": (bt.GradientAllReduceAlgorithm, SGD, {}),
    "ga_leaf": (bt.GradientAllReduceAlgorithm, SGD, {"flat_resident": "off"}),
    "ga_adamw": (bt.GradientAllReduceAlgorithm, ADAMW, {}),
    "bytegrad": (lambda: bt.ByteGradAlgorithm(hierarchical=False), SGD, {}),
    "onebit": (bt.GradientAllReduceAlgorithm, SGD, {"compress_intra": "onebit_ef"}),
    "onebit_4096": (bt.GradientAllReduceAlgorithm, SGD,
                    {"compress_intra": "onebit_ef", "bucket_bytes": 4096}),
    "zero": (lambda: bt.ZeroOptimizerAlgorithm(ADAM), None, {}),
    "zero_leaf": (lambda: bt.ZeroOptimizerAlgorithm(ADAM), None, {"flat_resident": "off"}),
    "zero_staged": (lambda: bt.ZeroOptimizerAlgorithm(ADAM, hierarchical=True), None, {}),
    "dec_all": (lambda: bt.DecentralizedAlgorithm(hierarchical=False, track_peer_weights=True),
                SGD, {}),
    "lowprec": (lambda: bt.LowPrecisionDecentralizedAlgorithm(hierarchical=False), SGD, {}),
    "async": (lambda: bt.AsyncModelAverageAlgorithm(warmup_steps=1, period_steps=3), SGD, {}),
    "async_nosync": (lambda: bt.AsyncModelAverageAlgorithm(warmup_steps=0, period_steps=100),
                     SGD, {}),
}


def make(family, params_path):
    algo_fn, opt, kw = FAMILIES[family]
    model = FlaxLayoutMLP(np.load(params_path))
    trainer = bt.BaguaTrainer(
        lambda m, b: torch.nn.functional.cross_entropy(m(b["x"]), b["y"]), opt, algo_fn(),
        device="cpu", **{"bucket_bytes": 256, **kw})
    return trainer, trainer.init(model)


def train(trainer, state, batch, n):
    losses = []
    for _ in range(n):
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    return state, losses


def prepare(trainer, state):
    """What a run does right before a checkpoint it means to resume from on
    any world: async model average's blocking average."""
    algo = trainer.algorithm
    if isinstance(algo, bt.AsyncModelAverageAlgorithm):
        return algo.sync_for_checkpoint(trainer, state)
    return state


def digest(trainer, state):
    return compute_state_digest(trainer._checkpoint_state(state))["digest"]


def run_resume(family, batch, params_path, root):
    t0, s0 = make(family, params_path)
    s0, ref = train(t0, s0, batch, SAVE_AT)
    s0 = prepare(t0, s0)
    t0.algorithm.on_restore(t0)
    s0, tail = train(t0, s0, batch, STEPS - SAVE_AT)
    mgr = bt.BaguaCheckpointManager(os.path.join(root, f"resume_{family}"), async_save=True)
    t1, s1 = make(family, params_path)
    s1, head = train(t1, s1, batch, SAVE_AT)
    s1 = prepare(t1, s1)
    assert t1.save_checkpoint(mgr, SAVE_AT, s1)
    s1, _ = train(t1, s1, batch, 1)   # in place, before the save is durable
    mgr.wait()
    t2, s2 = make(family, params_path)
    step, s2 = t2.restore_checkpoint(mgr, s2)
    s2, resumed = train(t2, s2, batch, STEPS - SAVE_AT)
    mgr.close()
    return {"ref": ref + tail, "run": head + resumed, "step": step,
            "ref_digest": digest(t0, s0), "run_digest": digest(t2, s2),
            "meta": t2.checkpoint_layout_metadata()}


def run_fallback(kind, rank, batch, params_path, root):
    mgr = bt.BaguaCheckpointManager(os.path.join(root, f"fallback_{kind}"), async_save=False)
    t, s = make("ga", params_path)
    s, _ = train(t, s, batch, 2)
    assert t.save_checkpoint(mgr, 2, s)
    s, _ = train(t, s, batch, 2)
    specs = []
    if kind == "write" and rank == 1:
        specs = [FaultSpec("ckpt.write", step=4, kind="torn")]
    if kind == "sidecar" and rank == 0:
        specs = [FaultSpec("ckpt.sidecar", step=4, kind="corrupt")]
    before = counters.snapshot()
    with fault_scope(*specs):
        assert t.save_checkpoint(mgr, 4, s)
    t2, s2 = make("ga", params_path)
    step, _ = t2.restore_checkpoint(mgr, s2)
    mgr.close()
    delta = {k: counters.get(k) - before.get(k, 0)
             for k in ("ckpt/fallback_restores", "ckpt/integrity_failures")}
    return {"step": step, "counters": delta}


def params_digest(state):
    return compute_state_digest({n: p.detach() for n, p in state.model.named_parameters()})[
        "digest"]


def ef_by_tensor(trainer, state):
    """The error-feedback residual cut into the plan's tensors, a digest a
    tensor (the bucket padding left out), and its absolute sum."""
    a = state.algo_state
    if not isinstance(a, dict) or "ef" not in a:
        return None, 0.0
    named = trainer.plan.unflatten(list(a["ef"]["buckets"]))
    return ({n: compute_state_digest(t.contiguous())["digest"] for n, t in named.items()},
            float(sum(b.abs().sum() for b in a["ef"]["buckets"])))


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def run_save(family, n, batch, params_path, root, where, sync=True):
    t, s = make(family, params_path)
    s, losses = train(t, s, batch, n)
    if sync:
        s = prepare(t, s)
    mgr = bt.BaguaCheckpointManager(os.path.join(root, where), async_save=False)
    assert t.save_checkpoint(mgr, n, s)
    mgr.close()
    return {"losses": losses, "digest": params_digest(s), "ef": ef_by_tensor(t, s)[0]}


def run_load(family, n, batch, params_path, root, where):
    mgr = bt.BaguaCheckpointManager(os.path.join(root, where))
    t, s = make(family, params_path)
    before = counters.get("ckpt/stacked_resize_restores")
    lines = _Lines()
    log = logging.getLogger("bagua_tpu_torch.core.backend")
    log.addHandler(lines)
    log.setLevel(logging.INFO)
    try:
        step, s = t.restore_checkpoint(mgr, s)
    except Exception as e:  # noqa: BLE001 - recorded for the test
        return {"error": f"{type(e).__name__}: {e}"}
    finally:
        log.removeHandler(lines)
    digest_after = params_digest(s)
    ef, ef_abs = ef_by_tensor(t, s)
    s, losses = train(t, s, batch, n)
    return {"step": step, "losses": losses, "params_digest": digest_after, "ef": ef,
            "ef_abs": ef_abs, "algo_state_none": s.algo_state is None, "log": lines.lines,
            "resized": counters.get("ckpt/stacked_resize_restores") - before}


def run_reset(family, n, batch, params_path, root):
    t, s = make(family, params_path)
    s, _ = train(t, s, batch, n)
    s = prepare(t, s)
    mgr = bt.BaguaCheckpointManager(os.path.join(root, f"reset_{family}"), async_save=False)
    assert t.save_checkpoint(mgr, n, s)
    t2, s2 = make(family, params_path)
    s2, _ = train(t2, s2, batch, n - 2)
    algo = t2.algorithm

    def schedule():
        return {"pending": algo._pending is not None, "period": algo._period,
                "anchor": algo._anchor, "launched": algo._rounds_launched,
                "applied": algo._rounds_applied}

    before = schedule()
    step, s2 = t2.restore_checkpoint(mgr, s2)
    after = schedule()
    s2, losses = train(t2, s2, batch, n)
    mgr.close()
    return {"step": step, "before": before, "after": after, "later": schedule(),
            "losses": losses}


def main(rank, world, init_method, data_path, params_path, out_path, root, runs):
    torch.set_num_threads(1)
    bt.init_process_group(init_method, world_size=world, rank=rank, device="cpu")
    data = np.load(data_path)
    rows = data["x"].shape[0] // world
    part = slice(rank * rows, (rank + 1) * rows)
    batch = {"x": torch.from_numpy(data["x"][part]),
             "y": torch.from_numpy(data["y"][part].astype(np.int64))}
    out = {}
    for run in runs.split(","):
        kind, family, *rest = run.split(":")
        if kind == "resume":
            out[run] = run_resume(family, batch, params_path, root)
        elif kind == "fallback":
            out[run] = run_fallback(family, rank, batch, params_path, root)
        elif kind in ("save", "nosync"):
            out[run] = run_save(family, int(rest[0]), batch, params_path, root,
                                rest[1] if len(rest) > 1 else family, sync=kind == "save")
        elif kind == "load":
            out[run] = run_load(family, int(rest[0]), batch, params_path, root,
                                rest[1] if len(rest) > 1 else family)
        elif kind == "reset":
            out[run] = run_reset(family, int(rest[0]), batch, params_path, root)
        elif kind == "meta":
            out[run] = make(family, params_path)[0].checkpoint_layout_metadata()
        else:
            raise ValueError(f"unknown run {run!r}")
    with open(out_path, "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def spawn(world, runs, tmp, root, rank_env=None, timeout=300):
    """Run ``world`` ranks of this worker on the golden task and return each
    rank's output.  ``root`` holds the checkpoints; ``rank_env[r]`` adds to
    rank r's environment (``LOCAL_WORLD_SIZE`` for two nodes)."""
    import bench

    _, params, batch = bench.golden_task()
    np.savez(tmp / "data.npz", x=np.asarray(batch["x"]), y=np.asarray(batch["y"]))
    np.savez(tmp / "params.npz", **{f"{layer}.{k}": np.asarray(v)
                                    for layer, leaves in params.items()
                                    for k, v in leaves.items()})
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    base = {**os.environ, "OMP_NUM_THREADS": "1",
            "PYTHONPATH": os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")])}
    base.pop("BAGUA_FAULT_PLAN", None)
    store = tmp / f"store{world}_{abs(hash(tuple(runs))) % 10 ** 8}"
    outs = [tmp / f"ckpt_out{world}_{r}.json" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world), f"file://{store}",
         str(tmp / "data.npz"), str(tmp / "params.npz"), str(outs[r]), str(root),
         ",".join(runs)],
        env={**base, **((rank_env or {}).get(r, {}))}) for r in range(world)]
    try:
        codes = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert codes == [0] * world, codes
    out = []
    for o in outs:
        with open(o) as f:
            out.append(json.load(f))
    return out


if __name__ == "__main__":
    r, w, init, data, params, out, root, runs = sys.argv[1:]
    main(int(r), int(w), init, data, params, out, root, runs)
