"""The port's gradient-health guard (``BaguaTrainer(grad_guard=...)``) and the
``grad.poison`` fault against the JAX package.

Mirrors ``tests/test_faults.py``'s grad-guard tests,
``tests/test_ef_residual.py``'s rebucket migration and guard rewind of the
residual, and ``tests/test_async_model_average.py``'s veto of a round in
flight over a rewound step.  The task is the golden task (one fixed batch,
so that a rewound step is a step not taken).

- ``skip`` with no fault is byte-identical to ``off``; the port's guarded
  runs track the JAX trainer's within 1e-5 relative at every step.
- ``skip`` rewinds exactly: a run poisoned at step 3 over 6 steps equals a
  clean run of 5, bitwise, in both layouts, with accumulation, and for the
  families whose verdict is taken on the updated parameters (ZeRO, gossip:
  a snapshot restored); ``state.step`` still advances.
- ``warn`` lets the poison through; ``abort`` fails the next step with
  ``BaguaAborted``; the skip budget escalates to an abort; the env knob and
  the constructor validate their values.
- Two gloo ranks (``tests/workers/torch_features_worker.py``): the 1-bit
  ring's error-feedback residual is rewound with the parameters, bitwise,
  and a rebucket carries it onto the new plan; a rewound step vetoes async
  model average's round in flight; ``grad.poison`` armed on rank 1 alone
  through ``BAGUA_FAULT_PLAN`` under ``DecentralizedAlgorithm``: rank 1
  rewinds and counts the skip, rank 0 neither (each process acts on its own
  verdict, where the JAX package's one process counts every rank's), and the
  next exchange brings their peer weights back together.
"""

import contextlib
import functools
import json

import jax
import numpy as np
import optax
import pytest
import torch

import bench
import bagua_tpu_torch as bt
from bagua_tpu import faults as jfaults
from bagua_tpu.algorithms import GradientAllReduceAlgorithm as JGA
from bagua_tpu.core.backend import BaguaTrainer as JTrainer
from bagua_tpu.parallel.mesh import build_mesh
from bagua_tpu_torch import env
from bagua_tpu_torch.faults.inject import FaultSpec, fault_scope
from bagua_tpu_torch.models.convert import params_from_jax
from bagua_tpu_torch.models.mlp import MLP
from bagua_tpu_torch.telemetry import counters

from workers import torch_features_worker as features

torch.set_num_threads(1)

SGD = functools.partial(torch.optim.SGD, lr=0.1)
_RUNS = {}


@pytest.fixture(scope="module", autouse=True)
def process_group():
    bt.init_process_group(device="cpu")


@pytest.fixture(autouse=True)
def clean_abort():
    yield
    bt.reset_abort()


def _delta(before, name):
    return counters.get(name) - before.get(name, 0)


def _make(guard="off", poison=None, steps=0, algo=bt.GradientAllReduceAlgorithm, opt=SGD,
          poison_spec=None, **kw):
    _, params, batch = bench.golden_task()
    model = MLP(4, features=(32, 8), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), model))
    spec = poison_spec or (FaultSpec("grad.poison", step=poison) if poison is not None else None)
    scope = fault_scope(spec) if spec is not None else contextlib.nullcontext()
    with scope:
        trainer = bt.BaguaTrainer(lambda m, b: torch.nn.functional.cross_entropy(m(b["x"]), b["y"]),
                                  opt, algo(), device="cpu", bucket_bytes=256, grad_guard=guard,
                                  **kw)
        state = trainer.init(model)
        b = trainer.shard_batch({"x": np.array(batch["x"]),
                                 "y": np.array(batch["y"]).astype(np.int64)})
        losses = []
        for _ in range(steps):
            state, loss = trainer.train_step(state, b)
            losses.append(loss.item())
        if guard != "off" and steps:
            trainer.flush_grad_health()
    return trainer, state, b, np.array(losses)


def _jax_losses(guard, poison, steps):
    loss_fn, params, batch = bench.golden_task()
    scope = (jfaults.fault_scope(jfaults.FaultSpec("grad.poison", step=poison))
             if poison is not None else contextlib.nullcontext())
    with scope:
        trainer = JTrainer(loss_fn, optax.sgd(0.1), JGA(), mesh=build_mesh({"dp": 1},
                           jax.devices()[:1]), autotune=False, grad_guard=guard)
        state = trainer.init(params)
        losses = []
        for _ in range(steps):
            state, loss = trainer.train_step(state, batch)
            losses.append(float(loss))
        trainer.flush_grad_health()
    return np.array(losses)


def _same_params(sa, sb):
    pa, pb = dict(sa.model.named_parameters()), dict(sb.model.named_parameters())
    return all(torch.equal(pa[n], pb[n]) for n in pa)


@pytest.mark.parametrize("layout", ["off", "on"])
def test_guard_on_is_byte_identical_without_faults(layout):
    _, s_off, _, l_off = _make("off", steps=5, flat_resident=layout)
    t_on, s_on, _, l_on = _make("skip", steps=5, flat_resident=layout)
    np.testing.assert_array_equal(l_on, l_off)
    assert _same_params(s_off, s_on)
    assert float(t_on.step_metrics["grad_healthy"]) == 1.0
    assert t_on.step_metrics["grad_health_buckets"].min().item() == 1.0
    assert len(t_on.step_metrics["grad_health_buckets"]) == len(t_on.plan.buckets)
    np.testing.assert_allclose(l_on, _jax_losses("skip", None, 5), rtol=1e-5)


@pytest.mark.parametrize("layout,accum", [("off", 1), ("on", 1), ("on", 2)])
def test_skip_rewind_is_exact(layout, accum):
    _, s_clean, _, l_clean = _make("off", steps=5, flat_resident=layout, accum_steps=accum)
    before = counters.snapshot()
    t, s_skip, _, l_skip = _make("skip", poison=3, steps=6, flat_resident=layout,
                                 accum_steps=accum)
    assert _delta(before, "grad_guard/skipped_steps") == 1
    assert _delta(before, "faults/grad.poison/fired") == 1
    assert _delta(before, "faults/grad.poison/recovered") == 1
    assert t._guard_skips == 0 and t._guard_rewinds_total == 1
    assert _same_params(s_clean, s_skip)
    assert s_skip.step == 6
    np.testing.assert_array_equal(np.delete(l_skip, 3), l_clean)
    if accum == 1:
        want = _jax_losses("skip", 3, 6)
        np.testing.assert_allclose(l_skip[np.isfinite(want)], want[np.isfinite(want)],
                                   rtol=1e-5)


@pytest.mark.parametrize("name", ["zero", "decentralized"])
def test_skip_rewinds_families_verdicted_on_params(name):
    """ZeRO and the gossip families change the parameters before the verdict:
    the snapshot taken before the step restores them, and the optimizer
    state (ZeRO's chunk Adam; SGD with momentum), exactly."""
    algo, opt = {
        "zero": (lambda: bt.ZeroOptimizerAlgorithm(functools.partial(torch.optim.Adam,
                                                                      lr=1e-2)), None),
        "decentralized": (lambda: bt.DecentralizedAlgorithm(hierarchical=False,
                                                            track_peer_weights=True),
                          functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9)),
    }[name]
    for layout in ("off", "on"):
        _, s_clean, _, _ = _make("off", steps=5, algo=algo, opt=opt, flat_resident=layout)
        t, s_skip, _, _ = _make("skip", poison=3, steps=6, algo=algo, opt=opt,
                                flat_resident=layout)
        assert not t.algorithm.grad_health_replicated
        assert _same_params(s_clean, s_skip), layout
        assert t._guard_rewinds_total == 1


def test_warn_policy_lets_poison_through():
    before = counters.snapshot()
    t, s, _, _ = _make("warn", poison=1, steps=2)
    assert _delta(before, "grad_guard/unhealthy_steps") >= 1
    leaves = [p.detach() for p in s.model.parameters()]
    assert not all(bool(torch.isfinite(x).all()) for x in leaves)
    assert float(t.step_metrics["grad_healthy"]) == 0.0
    assert t.step_metrics["grad_health_buckets"].min().item() == 0.0


def test_abort_policy_fails_fast():
    t, s, b, _ = _make("abort", poison=1, steps=3)
    with pytest.raises(bt.BaguaAborted, match="grad guard"):
        t.train_step(s, b)


def test_skip_budget_escalates_to_abort():
    before = counters.snapshot()
    spec = FaultSpec("grad.poison", step=None, count=-1)
    with fault_scope(spec):
        t, s, b, _ = _make("skip", grad_guard_budget=2)
        with pytest.raises(bt.BaguaAborted, match="skip budget"):
            for _ in range(10):
                s, _ = t.train_step(s, b)
            t.flush_grad_health()
    assert t._guard_skips >= 2
    assert _delta(before, "grad_guard/aborts") == 1


def test_grad_guard_env_and_validation(monkeypatch):
    monkeypatch.setenv("BAGUA_GRAD_GUARD", "skip")
    assert env.get_grad_guard_mode() == "skip"
    assert bt.BaguaTrainer(None, SGD, bt.GradientAllReduceAlgorithm(),
                           device="cpu").grad_guard == "skip"
    monkeypatch.setenv("BAGUA_GRAD_GUARD", "bogus")
    with pytest.raises(ValueError, match="BAGUA_GRAD_GUARD"):
        env.get_grad_guard_mode()
    monkeypatch.delenv("BAGUA_GRAD_GUARD")
    with pytest.raises(ValueError, match="grad_guard must be"):
        _make("bogus")
    with pytest.raises(ValueError, match="grad_guard_budget must be"):
        _make("skip", grad_guard_budget=0)
    monkeypatch.setenv("BAGUA_FLAT_RESIDENT", "sideways")
    with pytest.raises(ValueError, match="BAGUA_FLAT_RESIDENT"):
        env.get_flat_resident_mode()


# ---- two gloo ranks -----------------------------------------------------------


def _two_ranks(tmp_path_factory):
    if "runs" not in _RUNS:
        runs = ["onebit:guard:steps=5", "onebit:guard:poison=3:steps=6",
                "onebit:rebucket=3:steps=5", "async:guard:poison=3:steps=8"]
        _RUNS["runs"] = features.spawn(2, runs, tmp_path_factory.mktemp("guard2"), 6)
    return _RUNS["runs"]


def test_guard_rewinds_the_ef_residual_bitwise(tmp_path_factory):
    outs = _two_ranks(tmp_path_factory)
    clean, poisoned = "onebit:guard:steps=5", "onebit:guard:poison=3:steps=6"
    for o in outs:
        assert o[f"{poisoned}/counter/grad_guard/skipped_steps"] == 1
        assert o[f"{clean}/counter/grad_guard/skipped_steps"] == 0
        for key in ("ef", "dense_0.kernel", "dense_0.bias", "dense_1.kernel", "dense_1.bias"):
            np.testing.assert_array_equal(o[f"{poisoned}/{key}"], o[f"{clean}/{key}"])
        assert o[f"{poisoned}/ef"].size and np.isfinite(o[f"{poisoned}/ef"]).all()
        np.testing.assert_array_equal(np.delete(o[f"{poisoned}/losses"], 3), o[f"{clean}/losses"])


def test_rebucket_migrates_ef_residual(tmp_path_factory):
    outs = _two_ranks(tmp_path_factory)
    run = "onebit:rebucket=3:steps=5"
    for o in outs:
        np.testing.assert_array_equal(o[f"{run}/ef_sizes"], o[f"{run}/padded"])
        assert len(o[f"{run}/padded"]) == 3 and o[f"{run}/resident"]
        ef = o[f"{run}/ef"]
        assert np.isfinite(ef).all() and np.abs(ef).sum() > 0
        assert np.isfinite(o[f"{run}/losses"]).all()


def test_grad_guard_rewind_vetoes_inflight_round(tmp_path_factory):
    outs = _two_ranks(tmp_path_factory)
    run = "async:guard:poison=3:steps=8"
    for o in outs:
        assert o[f"{run}/rewinds_total"] >= 1
        assert o[f"{run}/counter/grad_guard/skipped_steps"] == 1
        assert o[f"{run}/counter/async/rounds_dropped"] >= 1
        assert o[f"{run}/counter/async/missed_boundaries"] >= 1
        assert np.isfinite(o[f"{run}/losses"]).all()


def test_gossip_verdict_is_per_rank(tmp_path_factory):
    run = "dec_all:guard:steps=6"
    plan = json.dumps([{"point": "grad.poison", "step": 3}])
    outs = features.spawn(2, [run], tmp_path_factory.mktemp("gossip_guard"), 6,
                          rank_env={1: {"BAGUA_FAULT_PLAN": plan}})
    assert outs[0][f"{run}/counter/grad_guard/skipped_steps"] == 0
    assert outs[1][f"{run}/counter/grad_guard/skipped_steps"] == 1
    assert outs[1][f"{run}/counter/faults/grad.poison/fired"] == 1
    peers = [o[f"{run}/trace/peer_weights"] for o in outs]
    params = [o[f"{run}/trace/params"] for o in outs]
    # before the poisoned step the ranks' exchanged weights agree
    np.testing.assert_array_equal(peers[0][:3], peers[1][:3])
    # rank 1 rewound its step 3 (exchange included), rank 0 did not
    assert not np.array_equal(peers[0][3], peers[1][3])
    np.testing.assert_array_equal(peers[1][3], peers[1][2])
    assert np.isfinite(params[1]).all()
    # the next exchange averages both ranks' weights again
    np.testing.assert_array_equal(peers[0][4], peers[1][4])
    np.testing.assert_array_equal(peers[0][5], peers[1][5])


@pytest.mark.parametrize("spec,fired_at", [
    (dict(step=2), [2]),
    (dict(step=None, count=2), [0, 1]),
    (dict(step=None, count=-1), [0, 1, 2, 3]),
], ids=["step", "count", "every"])
def test_poison_fires_on_the_jax_window(spec, fired_at):
    """``grad.poison`` is keyed on ``state.step`` with the JAX package's
    window (``step=K`` at K, ``step=None`` on the first ``count`` steps,
    every step when ``count < 0``): under ``warn`` each fired step's verdict
    is unhealthy, each other one healthy on the state it was given."""
    before = counters.snapshot()
    verdicts = []
    with fault_scope(FaultSpec("grad.poison", **spec)):
        t, s, b, _ = _make("warn", steps=0)
        for _ in range(4):
            before_step = [p.detach().clone() for p in s.model.parameters()]
            s, _ = t.train_step(s, b)
            verdicts.append(t.step_metrics["grad_healthy"].item())
            for p, q in zip(s.model.parameters(), before_step):
                p.data.copy_(q)   # the next step starts from finite weights
        t.flush_grad_health()
    assert [i for i, v in enumerate(verdicts) if v == 0.0] == fired_at
    assert _delta(before, "faults/grad.poison/fired") == len(fired_at)


def test_traced_specs_are_read_from_the_plan():
    from bagua_tpu_torch.faults import inject

    assert inject.armed_traced_specs("grad.poison") == ()
    spec = FaultSpec("grad.poison", step=5, kind="inf")
    with fault_scope(spec, FaultSpec("async.partition")) as plan:
        assert inject.armed_traced_specs("grad.poison") == (spec,)
        before = counters.snapshot()
        inject.note_traced_fire(spec)
        assert _delta(before, "faults/grad.poison/fired") == 1
        assert plan.fired("grad.poison") and not plan.fired("async.partition")
