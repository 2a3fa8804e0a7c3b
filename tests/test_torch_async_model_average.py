"""The port's ``AsyncModelAverageAlgorithm`` against the JAX package.

``tests/workers/torch_async_worker.py`` trains every run on 2 and 4 gloo
ranks, one launch a world (and one each for the runs that need their own
environment); the JAX trainer runs the same configuration on a mesh of as
many CPU devices, its parameters stacked ``[world, ...]``.

- Against JAX, rank by rank at every step, on the golden task
  (``bench.golden_task()``, SGD 0.1): a pinned period (``warmup_steps=2,
  period_steps=2``; ``warmup_steps=0, period_steps=3``), ``sync_interval_ms=0``
  with an abort before one step and a resume before a later one (in the port
  the abort goes to rank 0 only and the resume to the last rank only), and
  ``async.partition`` armed on every rank under ``max_staleness_rounds=2``.
  Under a pinned period or ``sync_interval_ms=0`` the schedule is a function
  of the step count, so every rank's parameters equal JAX's ``params[r]``
  within rtol 1e-5 / atol 1e-6 (the full-precision gossip's tolerance), and
  the rounds launched, applied and dropped, the catch-ups and the status
  equal JAX's at every step.  ``sync_for_checkpoint`` leaves the ranks
  bitwise equal, and equal to JAX's.
- Mirrors of ``tests/test_async_model_average.py:59-258``: convergence,
  abort and resume, a pinned period's exact rounds, no rounds at world 1,
  periodic recalibration, the staleness bound with bitwise-equal ranks after
  each catch-up, a cap of 0, the knob's validation.
- What one JAX process cannot show: ``async.partition`` armed on rank 1
  alone (through ``BAGUA_FAULT_PLAN``), where the catch-up fires at the same
  boundary on every rank; the acceptance run of
  ``tests/workers/family_worker.py`` (skewed hosts, abort and resume from
  rank 0 alone); the golden bound of ``tests/test_loss_goldens.py:89-90``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

import bench
import bagua_tpu_torch as bt
from bagua_tpu import telemetry as jax_telemetry
from bagua_tpu.algorithms.async_model_average import AsyncModelAverageAlgorithm as JAsync
from bagua_tpu.core.backend import BaguaTrainer as JTrainer
from bagua_tpu.faults import inject as jax_inject
from bagua_tpu.parallel.mesh import build_mesh
from bagua_tpu_torch.faults import inject
from bagua_tpu_torch.models.mlp import MLP

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "workers" / "torch_async_worker.py"
NAMES = ("dense_0.bias", "dense_0.kernel", "dense_1.bias", "dense_1.kernel")
#: the runs compared with JAX: name -> (JAX algorithm, steps, events, fault
#: armed on every rank, finish)
JAX_RUNS = {
    "pinned_w2p2": (lambda: JAsync(warmup_steps=2, period_steps=2), 12, {}, False, "sync"),
    "pinned_w0p3": (lambda: JAsync(warmup_steps=0, period_steps=3), 12, {}, False, None),
    "interval0_abort": (lambda: JAsync(sync_interval_ms=0), 16,
                        {8: ["abort"], 12: ["resume"]}, False, None),
    "partition_all": (lambda: JAsync(warmup_steps=2, period_steps=2, max_staleness_rounds=2),
                      24, {}, True, None),
}
MIRRORS = ("convergence", "abort_resume", "pinned_exact", "recalibrate", "cap_zero")
WORLD_RUNS = (*JAX_RUNS, "golden_bound", *MIRRORS)
COUNTS = ("launched", "applied", "dropped", "catchups", "status")
_RUNS = {}
_JAX = {}


def _spawn(world, runs, tmp, env_by_rank=None, timeout=300):
    """``world`` ranks of the worker over ``runs``; each rank's output."""
    base = {**os.environ, "OMP_NUM_THREADS": "1",
            "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
    base.pop("BAGUA_FAULT_PLAN", None)
    _, params, batch = bench.golden_task()
    np.savez(tmp / "data.npz", x=np.asarray(batch["x"]), y=np.asarray(batch["y"]))
    np.savez(tmp / "params.npz", **{f"{layer}.{k}": np.asarray(v)
                                    for layer, leaves in params.items()
                                    for k, v in leaves.items()})
    outs = [tmp / f"out{r}.npz" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(world), f"file://{tmp / 'store'}",
         str(tmp / "data.npz"), str(tmp / "params.npz"), str(outs[r]), ",".join(runs)],
        env={**base, **(env_by_rank or {}).get(r, {})}) for r in range(world)]
    try:
        assert [p.wait(timeout=timeout) for p in procs] == [0] * world
    finally:
        for p in procs:
            p.kill()
    return [np.load(o) for o in outs]


def _run(world, tmp_path_factory):
    if world not in _RUNS:
        _RUNS[world] = _spawn(world, WORLD_RUNS, tmp_path_factory.mktemp(f"async{world}"))
    return _RUNS[world]


def _ranks(outs, key):
    """``[ranks, ...]`` of one output."""
    return np.stack([o[key] for o in outs])


@pytest.fixture(autouse=True)
def _clean():
    inject.clear_plan()
    jax_inject.clear_plan()
    bt.reset_abort()
    yield
    inject.clear_plan()
    jax_inject.clear_plan()


def _jax_run(world, name):
    """The JAX trainer's run: its losses, its stacked parameters after every
    step by the port's names, its counts after every step (as the worker
    records them) and its parameters after ``finish``."""
    if (world, name) not in _JAX:
        factory, steps, events, fault, finish = JAX_RUNS[name]
        loss_fn, params, batch = bench.golden_task()
        algo = factory()
        trainer = JTrainer(loss_fn, optax.sgd(0.1), algo, autotune=False,
                           mesh=build_mesh({"dp": world}, jax.devices()[:world]),
                           flat_resident="off")
        state = trainer.init(params)
        before = jax_telemetry.counters.snapshot()
        scope = (jax_inject.fault_scope(jax_inject.FaultSpec("async.partition", count=-1))
                 if fault else jax_inject.fault_scope())
        trace = {k: [] for k in ("losses", *COUNTS, *NAMES)}
        with scope:
            for s in range(steps):
                for what in events.get(s, []):
                    getattr(algo, what)()
                state, loss = trainer.train_step(state, batch)
                trace["losses"].append(float(loss))
                for n in NAMES:
                    layer, leaf = n.split(".")
                    trace[n].append(np.asarray(state.params[layer][leaf]))
                trace["launched"].append(algo._rounds_launched)
                trace["applied"].append(algo._rounds_applied)
                trace["dropped"].append(algo._rounds_dropped)
                trace["catchups"].append(jax_telemetry.counters.get("async/catchup_syncs")
                                         - before.get("async/catchup_syncs", 0))
                trace["status"].append(algo._status)
        final = None
        if finish == "sync":
            state = algo.sync_for_checkpoint(trainer, state)
            final = {n: np.asarray(state.params[n.split(".")[0]][n.split(".")[1]])
                     for n in NAMES}
        _JAX[world, name] = {k: np.array(v) for k, v in trace.items()}, final
    return _JAX[world, name]


# ---------------------------------------------------------------------------
# against the JAX trainer, rank by rank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_tracks_the_jax_trainer_rank_by_rank(world, name, tmp_path_factory):
    outs = _run(world, tmp_path_factory)
    want, _ = _jax_run(world, name)
    for n in NAMES:
        got = _ranks(outs, f"{name}/trace/{n}").swapaxes(0, 1)   # [steps, ranks, ...]
        np.testing.assert_allclose(got, want[n], rtol=1e-5, atol=1e-6, err_msg=n)
    for o in outs:
        np.testing.assert_allclose(o[f"{name}/trace/losses"], want["losses"], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_schedule_equals_jax(world, name, tmp_path_factory):
    # the steps a round launches, applies, drops or is caught up at, and the
    # negotiated status, on every rank
    outs = _run(world, tmp_path_factory)
    want, _ = _jax_run(world, name)
    for key in COUNTS:
        for r, o in enumerate(outs):
            np.testing.assert_array_equal(o[f"{name}/trace/{key}"], want[key],
                                          err_msg=f"{key} on rank {r}")
    assert want["launched"][-1] >= 3


@pytest.mark.parametrize("world", [2, 4])
def test_sync_for_checkpoint_leaves_ranks_bitwise_equal(world, tmp_path_factory):
    outs = _run(world, tmp_path_factory)
    final = _ranks(outs, "pinned_w2p2/final")
    for r in range(1, world):
        np.testing.assert_array_equal(final[r], final[0])
    # the ranks differed before it
    assert not np.array_equal(outs[0]["pinned_w2p2/trace/params"][-1],
                              outs[-1]["pinned_w2p2/trace/params"][-1])
    _, want = _jax_run(world, "pinned_w2p2")
    # the worker's flats are in bucket order: reversed registration order
    got = np.concatenate([outs[0][f"pinned_w2p2/trace/{n}"][-1].ravel()
                          for n in reversed(NAMES)])
    assert got.shape == final[0].shape
    start = 0
    for n in reversed(NAMES):
        size = want[n][0].size
        for r in range(world):
            np.testing.assert_allclose(final[r][start:start + size], want[n][r].ravel(),
                                       rtol=1e-5, atol=1e-6, err_msg=n)
        start += size


def test_abort_and_resume_from_different_ranks_take_effect_together(tmp_path_factory):
    # the abort went to rank 0 before step 9 and the resume to the last rank
    # before step 13: the status turns at those boundaries on every rank
    for world in (2, 4):
        status = _ranks(_run(world, tmp_path_factory), "interval0_abort/trace/status")
        assert (status == status[0]).all()
        assert list(status[0]) == [0] * 8 + [1] * 4 + [0] * 4, status[0]


# ---------------------------------------------------------------------------
# mirrors of tests/test_async_model_average.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_convergence_with_background_averaging(world, tmp_path_factory):
    outs = _run(world, tmp_path_factory)
    losses = outs[0]["convergence/trace/losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert outs[0]["convergence/trace/launched"][-1] > 5


@pytest.mark.parametrize("world", [2, 4])
def test_abort_resume(world, tmp_path_factory):
    outs = _run(world, tmp_path_factory)
    for o in outs:
        losses = o["abort_resume/trace/losses"]
        assert np.isfinite(losses).all()
        launched = o["abort_resume/trace/launched"]
        status = o["abort_resume/trace/status"]
        # no round launches while aborted; rounds launch again after resume
        assert (np.diff(launched)[status[1:] == 1] == 0).all()
        assert 1 in status and status[-1] == 0 and launched[-1] > launched[10]
        assert int(o["abort_resume/final_status"]) == 0


@pytest.mark.parametrize("world", [2, 4])
def test_pinned_period_schedules_exact_rounds(world, tmp_path_factory):
    outs = _run(world, tmp_path_factory)
    launched = outs[0]["pinned_exact/trace/launched"]
    steps = 1 + np.flatnonzero(np.diff(np.concatenate([[0], launched])))
    # the anchor is the first step after the warmup; rounds every 3rd step
    assert list(steps) == [6, 9, 12], steps
    assert (outs[0]["pinned_exact/trace/period"][2:] == 3).all()


def test_single_rank_comm_world_skips_rounds():
    bt.init_process_group(device="cpu")
    algo = bt.AsyncModelAverageAlgorithm(sync_interval_ms=0, warmup_steps=1)
    model = MLP(10, features=(12, 5), device="cpu", seed=3)
    trainer = bt.BaguaTrainer(lambda m, b: torch.nn.functional.cross_entropy(m(b["x"]), b["y"]),
                              lambda p: torch.optim.SGD(p, lr=0.05), algo, device="cpu")
    state = trainer.init(model)
    rng = np.random.default_rng(3)
    w = rng.normal(size=(10, 5))
    for _ in range(10):
        x = rng.normal(size=(8, 10)).astype(np.float32)
        batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(np.argmax(x @ w, 1))}
        state, loss = trainer.train_step(state, batch)
    # no group, no snapshot, no period
    assert algo._pending is None and algo._period is None and algo.communicators() == []
    assert algo._avg_comm is None and algo._control is None
    assert np.isfinite(loss.item())
    assert algo.sync_for_checkpoint(trainer, state) is state


@pytest.mark.parametrize("world", [2, 4])
def test_periodic_recalibration_rederives_period(world, tmp_path_factory):
    for o in _run(world, tmp_path_factory):
        period = o["recalibrate/trace/period"]
        agreed = np.flatnonzero(period > 0)
        # agreed, then reset for a recalibration, then agreed again
        assert agreed.size and (period[agreed[0]:] == -1).any(), period
        assert period[-1] > 0, period
        np.testing.assert_array_equal(period, _run(world, tmp_path_factory)[0][
            "recalibrate/trace/period"])


@pytest.mark.parametrize("world", [2, 4])
def test_bounded_staleness_invariant_and_catchup_bitident(world, tmp_path_factory):
    k = 2
    outs = _run(world, tmp_path_factory)
    for o in outs:
        lag = o["partition_all/trace/launched"] - o["partition_all/trace/applied"]
        assert lag.max() <= k, lag
        delta = lambda key: int(o[f"partition_all/delta/{key}"])
        assert delta("async/catchup_syncs") >= 1
        assert delta("async/rounds_dropped") >= 1
        assert delta("async/missed_boundaries") >= 1
        assert delta("async/rounds_launched") >= delta("async/catchup_syncs")
        assert delta("faults/async.partition/fired") >= 1
        assert delta("faults/async.partition/recovered") >= 1
    # every catch-up left the ranks' parameters bitwise equal
    synced = _ranks(outs, "partition_all/catchup_params")
    assert synced.shape[1] >= 1
    for r in range(1, world):
        np.testing.assert_array_equal(synced[r], synced[0])
    np.testing.assert_array_equal(_ranks(outs, "partition_all/catchup_steps")[1:],
                                  _ranks(outs, "partition_all/catchup_steps")[:1].repeat(
                                      world - 1, 0))


@pytest.mark.parametrize("world", [2, 4])
def test_staleness_cap_zero_disables_catchup(world, tmp_path_factory):
    for o in _run(world, tmp_path_factory):
        assert int(o["cap_zero/delta/async/catchup_syncs"]) == 0
        assert o["cap_zero/trace/launched"][-1] - o["cap_zero/trace/applied"][-1] > 2
        assert np.isfinite(o["cap_zero/trace/losses"]).all()


def test_staleness_knob_validation(monkeypatch):
    with pytest.raises(ValueError, match="max_staleness_rounds"):
        bt.AsyncModelAverageAlgorithm(max_staleness_rounds=-1)
    monkeypatch.setenv("BAGUA_ASYNC_MAX_STALENESS", "7")
    assert bt.AsyncModelAverageAlgorithm().max_staleness_rounds == 7
    monkeypatch.delenv("BAGUA_ASYNC_MAX_STALENESS")
    assert bt.AsyncModelAverageAlgorithm().max_staleness_rounds == 4
    with pytest.raises(ValueError, match="peer_selection_mode"):
        bt.AsyncModelAverageAlgorithm(peer_selection_mode="shift_one")
    algo = bt.AsyncModelAverageAlgorithm()
    assert algo.name == "async" and algo.replicated_params is False
    assert (algo.sync_interval_ms, algo.warmup_steps, algo.calibration_steps,
            algo.period_steps, algo.recalibrate_rounds) == (500, 0, 4, None, 64)


# ---------------------------------------------------------------------------
# what one JAX process cannot show
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_golden_bound(world, tmp_path_factory):
    # tests/test_loss_goldens.py:89-90 bounds the timing-dependent loss of
    # bench.py's AsyncModelAverageAlgorithm(sync_interval_ms=100)
    for o in _run(world, tmp_path_factory):
        assert 0.0 < o["golden_bound/trace/losses"][-1] < 1.0
        assert int(o["golden_bound/groups"]) == 1


def test_partition_on_one_rank_catches_up_everywhere(tmp_path_factory):
    plan = json.dumps([{"point": "async.partition", "count": -1}])
    outs = _spawn(2, ["partition_r1"], tmp_path_factory.mktemp("partition_r1"),
                  env_by_rank={1: {"BAGUA_FAULT_PLAN": plan}})
    r0, r1 = outs
    # rank 1 drops every round it launches, rank 0 applies them
    assert int(r1["partition_r1/delta/faults/async.partition/fired"]) >= 1
    assert int(r0["partition_r1/delta/faults/async.partition/fired"]) == 0
    assert int(r0["partition_r1/delta/async/missed_boundaries"]) == 0
    assert int(r1["partition_r1/delta/async/missed_boundaries"]) >= 1
    # the catch-up fires at the same boundaries on both ranks, and leaves
    # them bitwise equal
    steps = r0["partition_r1/catchup_steps"]
    assert steps.size >= 2
    np.testing.assert_array_equal(r1["partition_r1/catchup_steps"], steps)
    np.testing.assert_array_equal(r0["partition_r1/catchup_params"],
                                  r1["partition_r1/catchup_params"])
    for o in outs:
        lag = o["partition_r1/trace/launched"] - o["partition_r1/trace/applied"]
        assert lag.max() <= 2, lag
    np.testing.assert_array_equal(r0["partition_r1/trace/launched"],
                                  r1["partition_r1/trace/launched"])


def test_skewed_hosts_abort_and_resume_from_rank_zero(tmp_path_factory):
    # tests/workers/family_worker.py's async family at world 2: rank 1
    # sleeps 10 ms a step, abort and resume go to rank 0 alone
    outs = _spawn(2, ["family"], tmp_path_factory.mktemp("family"), timeout=240)
    r0, r1 = outs
    np.testing.assert_array_equal(r0["family/trace/period"], r1["family/trace/period"])
    np.testing.assert_array_equal(r0["family/trace/launched"], r1["family/trace/launched"])
    np.testing.assert_array_equal(r0["family/trace/status"], r1["family/trace/status"])
    assert r0["family/trace/period"][-1] > 0
    assert 1 in r0["family/trace/status"]
    for o in outs:
        assert int(o["family/final_status"]) == 0
        losses = o["family/trace/losses"]
        assert np.isfinite(losses).all()
        assert np.mean(losses[-4:]) < np.mean(losses[:4]), losses
