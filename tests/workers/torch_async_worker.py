"""One rank of the port's async model average runs
(tests/test_torch_async_model_average.py).

    python torch_async_worker.py RANK WORLD INIT_METHOD DATA_NPZ PARAMS_NPZ OUT_NPZ RUNS

Trains each run of the comma-separated ``RUNS`` (names of ``RUNS`` below) on
this rank with ``AsyncModelAverageAlgorithm`` over gloo and writes, under
``<run>/``, after every step: the loss, the parameters by name
(``trace/<name>``) and as their bucket flats (``trace/params``), the round
counts launched, applied and dropped, the catch-up averages so far, the
negotiated status and the agreed period (-1 before one is agreed); the
parameters right after each catch-up average (``catchup_params``) and the
steps it ran at; and the parameters after the run's ``finish``
(``barrier`` or ``sync_for_checkpoint``).

Tasks: ``golden`` is the golden task of ``bench.golden_task`` (``DATA_NPZ``,
the flax params of ``PARAMS_NPZ`` in flax's layout), one fixed batch, each
rank its contiguous slice; ``stream`` draws a new batch every step from a
seeded stream, the same on every rank, each rank its slice (the tasks of
``tests/test_async_model_average.py`` and ``tests/workers/family_worker.py``).
``events`` call ``abort()``/``resume()`` on one rank only, before a step;
``sleep_rank`` sleeps 10 ms before each step on that rank (skewed hosts).
``fault="all"`` arms ``async.partition`` on every rank for the run; a plan
in ``BAGUA_FAULT_PLAN`` arms it where the spawner set it.
Imports only torch, numpy and the port.
"""

import contextlib
import functools
import os
import sys
import time

import numpy as np
import torch

import bagua_tpu_torch as bt
from bagua_tpu_torch.faults import inject
from bagua_tpu_torch.faults.inject import FaultSpec, fault_scope
from bagua_tpu_torch.models.mlp import MLP
from bagua_tpu_torch.telemetry import counters

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_trainer_worker import FlaxLayoutMLP  # noqa: E402

A = bt.AsyncModelAverageAlgorithm
#: the tasks of the JAX async tests (DIM 10, 5 classes, 32 rows, SGD 0.05) and
#: of the family worker (DIM 8, 64 rows, SGD 0.5)
ASYNC_TEST = dict(task="stream", dim=10, rows=32, lr=0.05)
FAMILY = dict(task="stream", dim=8, rows=64, lr=0.5, seed=0)

#: name -> run.  ``events``: {step index: [(rank, "abort" | "resume")]},
#: ``rank`` -1 being the last rank
RUNS = {
    # against the JAX trainer on the golden task (SGD 0.1)
    "pinned_w2p2": dict(algo=lambda: A(warmup_steps=2, period_steps=2), steps=12,
                        finish="sync"),
    "pinned_w0p3": dict(algo=lambda: A(warmup_steps=0, period_steps=3), steps=12),
    "interval0_abort": dict(algo=lambda: A(sync_interval_ms=0), steps=16,
                            events={8: [(0, "abort")], 12: [(-1, "resume")]}),
    "partition_all": dict(algo=lambda: A(warmup_steps=2, period_steps=2,
                                         max_staleness_rounds=2), steps=24, fault="all"),
    # async.partition armed on rank 1 alone, through BAGUA_FAULT_PLAN
    "partition_r1": dict(algo=lambda: A(warmup_steps=2, period_steps=2,
                                        max_staleness_rounds=2), steps=24),
    # the golden bound of tests/test_loss_goldens.py (bench.py:88)
    "golden_bound": dict(algo=lambda: A(sync_interval_ms=100), steps=30),
    # tests/test_async_model_average.py's own runs
    "convergence": dict(algo=lambda: A(sync_interval_ms=0, warmup_steps=2), steps=20,
                        finish="barrier", seed=0, **ASYNC_TEST),
    "abort_resume": dict(algo=lambda: A(sync_interval_ms=0), steps=15, finish="barrier",
                         events={5: [(0, "abort")], 10: [(-1, "resume")]}, seed=1,
                         **ASYNC_TEST),
    "pinned_exact": dict(algo=lambda: A(warmup_steps=2, period_steps=3), steps=14,
                         finish="barrier", seed=2, **ASYNC_TEST),
    "recalibrate": dict(algo=lambda: A(sync_interval_ms=0, warmup_steps=1, calibration_steps=1,
                                       recalibrate_rounds=3), steps=30, finish="barrier",
                        seed=4, **ASYNC_TEST),
    "cap_zero": dict(algo=lambda: A(warmup_steps=2, period_steps=2, max_staleness_rounds=0),
                     steps=20, fault="all", seed=11, **ASYNC_TEST),
    # tests/workers/family_worker.py's async family: skewed hosts, abort and
    # resume from rank 0 alone
    "family": dict(algo=lambda: A(sync_interval_ms=50, warmup_steps=4, calibration_steps=2),
                   steps=60, finish="barrier", sleep_rank=1,
                   events={25: [(0, "abort")], 40: [(0, "resume")]}, **FAMILY),
}
NCLASS = 5
COUNTS = ("launched", "applied", "dropped", "catchups", "status", "period")


def _ce(m, b):
    return torch.nn.functional.cross_entropy(m(b["x"]), b["y"])


def _batches(run, rank, world, data):
    """This rank's batch of every step."""
    if run.get("task", "golden") == "golden":
        rows = data["x"].shape[0] // world
        part = slice(rank * rows, (rank + 1) * rows)
        local = {"x": torch.from_numpy(data["x"][part]),
                 "y": torch.from_numpy(data["y"][part].astype(np.int64))}
        while True:
            yield local
    rng = np.random.default_rng(run["seed"])   # the same stream on every rank
    w = rng.normal(size=(run["dim"], NCLASS))
    rows = run["rows"] // world
    while True:
        x = rng.normal(size=(run["rows"], run["dim"])).astype(np.float32)
        y = np.argmax(x @ w, 1).astype(np.int64)
        part = slice(rank * rows, (rank + 1) * rows)
        yield {"x": torch.from_numpy(x[part]), "y": torch.from_numpy(y[part])}


def _model(run, params_path):
    if run.get("task", "golden") == "golden":
        return FlaxLayoutMLP(np.load(params_path))
    return MLP(run["dim"], features=(12, NCLASS), device="cpu", seed=0)


def _run(name, rank, world, data, params_path):
    run = RUNS[name]
    inject.clear_plan()   # the environment's plan is read again
    algo = run["algo"]()
    sgd = functools.partial(torch.optim.SGD, lr=run.get("lr", 0.1))
    trainer = bt.BaguaTrainer(_ce, sgd, algo, device="cpu")
    model = _model(run, params_path)
    state = trainer.init(model)   # every rank starts from rank 0's weights

    def flat_params():
        with torch.no_grad():
            return torch.cat(trainer.plan.flatten(trainer._params)).numpy().copy()

    catchups, catchup_steps = [], []
    orig = algo._catchup_sync

    def spy(tr, step, reason):
        orig(tr, step, reason)
        catchups.append(flat_params())
        catchup_steps.append(step)

    algo._catchup_sync = spy
    before = counters.snapshot()
    scope = (fault_scope(FaultSpec("async.partition", count=-1)) if run.get("fault") == "all"
             else contextlib.nullcontext())
    trace = {k: [] for k in ("losses", "params", *COUNTS)}
    trace.update({f"param/{n}": [] for n in trainer._params})
    events = run.get("events", {})
    with scope:
        for s, batch in zip(range(run["steps"]), _batches(run, rank, world, data)):
            for who, what in events.get(s, []):
                if who % world == rank:
                    getattr(algo, what)()
            if run.get("sleep_rank") == rank:
                time.sleep(0.01)
            state, loss = trainer.train_step(state, batch)
            trace["losses"].append(loss.item())
            trace["params"].append(flat_params())
            for n, p in trainer._params.items():
                trace[f"param/{n}"].append(p.detach().numpy().copy())
            trace["launched"].append(algo._rounds_launched)
            trace["applied"].append(algo._rounds_applied)
            trace["dropped"].append(algo._rounds_dropped)
            trace["catchups"].append(counters.get("async/catchup_syncs")
                                     - before.get("async/catchup_syncs", 0))
            trace["status"].append(algo._status)
            trace["period"].append(-1 if algo._period is None else algo._period)
    out = {f"{name}/trace/{k.replace('param/', '')}": np.array(v) for k, v in trace.items()}
    if run.get("finish"):
        getattr(algo, {"sync": "sync_for_checkpoint"}.get(run["finish"], run["finish"]))(
            trainer, state)
        out[f"{name}/final"] = flat_params()
        out[f"{name}/final_status"] = algo._status
    after = counters.snapshot()
    for key in ("async/rounds_launched", "async/rounds_applied", "async/rounds_dropped",
                "async/missed_boundaries", "async/catchup_syncs",
                "faults/async.partition/fired", "faults/async.partition/recovered"):
        out[f"{name}/delta/{key}"] = after.get(key, 0) - before.get(key, 0)
    out[f"{name}/catchup_params"] = (np.stack(catchups) if catchups
                                     else np.zeros((0, flat_params().size), np.float32))
    out[f"{name}/catchup_steps"] = np.array(catchup_steps, dtype=np.int64)
    out[f"{name}/host_staged_bytes"] = trainer.host_staged_bytes
    out[f"{name}/groups"] = len(algo.communicators())
    return out


def main(rank, world, init_method, data_path, params_path, out_path, runs):
    torch.set_num_threads(1)
    bt.init_process_group(init_method, world_size=world, rank=rank, device="cpu")
    data = np.load(data_path)
    out = {}
    for name in runs.split(","):
        out.update(_run(name, rank, world, data, params_path))
    np.savez(out_path, **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    r, w, init, data, params, out, runs = sys.argv[1:]
    main(int(r), int(w), init, data, params, out, runs)
