"""The port's layout-aware restore (``BaguaTrainer.restore_checkpoint``)
across layouts, plans and worlds.

Mirrors ``tests/test_ef_residual.py:211-340`` (the error-feedback residual's
restore paths) and ``tests/test_flat_resident.py:208-242, 367-387, 436-563``:

- The residual at world 2 over gloo (``tests/workers/torch_checkpoint_worker.py``):
  kept bitwise at the same plan, relaid out tensor by tensor (bitwise, the
  bucket padding left out) across plans, zero-initialized loudly from a
  checkpoint saved without it, dropped loudly by a trainer without it (the
  parameters still restored bitwise), and zero-reset loudly across a world
  resize (saved at 2, restored at 4).
- Flat -> leaf -> flat (another plan) continuity on the golden task with
  Adam: the three legs' losses equal the uninterrupted run's exactly, and the
  JAX trainer's same legs within rtol 1e-5; flat -> flat under another plan
  (SGD with momentum) exactly; QAdam's moments leaf -> flat -> leaf exactly; ZeRO
  across plans blocked with the actionable layout error.
- A cross-layout restore of an optimizer of several parameter groups raises
  the actionable error: the port's counterpart of the JAX package's
  ``fuse_optimizer`` case (torch has no such wrapper; what has no flat
  mirror here is a group structure the flat layout's one group over the
  bucket flats cannot hold).
- The stacked world check; a save refused while a rebucket's migration is
  pending; ``layout_descriptor`` round trips between the two packages.
"""

import functools

import numpy as np
import optax
import pytest
import torch

import bench
import bagua_tpu_torch as bt
from bagua_tpu.algorithms import GradientAllReduceAlgorithm as JGA
from bagua_tpu.bucket import BucketPlan as JPlan
from bagua_tpu.checkpoint import BaguaCheckpointManager as JManager
from bagua_tpu.core.backend import BaguaTrainer as JTrainer
from bagua_tpu.tensor import build_params as jbuild_params
from bagua_tpu_torch.bucket import BucketPlan, split_bucket_by_bucket_size
from bagua_tpu_torch.checkpoint import BaguaCheckpointManager
from bagua_tpu_torch.tensor import build_params

from workers import torch_checkpoint_worker as worker
from test_torch_checkpoint import _Params, _steps, _trainer

torch.set_num_threads(1)

ADAM = functools.partial(torch.optim.Adam, lr=1e-2)
SGD_MOMENTUM = functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9)
#: the error-feedback runs at world 2: saved family, restored family, the
#: directory, steps before the save
EF_RUNS = ["save:onebit:3:ef_same", "load:onebit:2:ef_same",
           "save:onebit:3:ef_cross", "load:onebit_4096:2:ef_cross",
           "save:ga:2:ef_pre", "load:onebit:2:ef_pre",
           "save:onebit:2:ef_drop", "load:ga:2:ef_drop",
           "save:onebit:3:ef_world"]
_SPAWNED = {}


@pytest.fixture(scope="module", autouse=True)
def process_group():
    bt.init_process_group(device="cpu")


def _ef_runs(tmp_path_factory):
    if not _SPAWNED:
        tmp = tmp_path_factory.mktemp("ef")
        two = worker.spawn(2, EF_RUNS, tmp, tmp / "ck")
        four = worker.spawn(4, ["load:onebit:2:ef_world"], tmp, tmp / "ck")
        _SPAWNED.update(two=two, four=four)
    return _SPAWNED


# ---- the error-feedback residual -------------------------------------------


def test_ef_same_plan_roundtrip_bit_exact(tmp_path_factory):
    for out in _ef_runs(tmp_path_factory)["two"]:
        saved, got = out["save:onebit:3:ef_same"], out["load:onebit:2:ef_same"]
        assert got["step"] == 3 and got["params_digest"] == saved["digest"]
        assert got["ef"] == saved["ef"] and got["ef_abs"] > 0.0
        assert all(np.isfinite(got["losses"]))


def test_ef_cross_plan_relayouts_residual(tmp_path_factory):
    for out in _ef_runs(tmp_path_factory)["two"]:
        saved, got = out["save:onebit:3:ef_cross"], out["load:onebit_4096:2:ef_cross"]
        assert any("relaying out the error-feedback residual" in line for line in got["log"])
        # tensor by tensor, bitwise: relayout is slicing and copying
        assert got["ef"] == saved["ef"] and got["ef_abs"] > 0.0
        assert got["params_digest"] == saved["digest"]
        assert all(np.isfinite(got["losses"]))


def test_ef_pre_ef_checkpoint_zero_inits_loudly(tmp_path_factory):
    for out in _ef_runs(tmp_path_factory)["two"]:
        got = out["load:onebit:2:ef_pre"]
        assert any("starting from ZERO residuals" in line for line in got["log"])
        assert got["ef_abs"] == 0.0 and got["ef"] is not None
        assert all(np.isfinite(got["losses"]))


def test_ef_restore_into_non_ef_trainer_drops_loudly(tmp_path_factory):
    for out in _ef_runs(tmp_path_factory)["two"]:
        saved, got = out["save:onebit:2:ef_drop"], out["load:ga:2:ef_drop"]
        assert any("discarding the checkpoint's error-feedback residual" in line
                   for line in got["log"])
        assert got["ef"] is None and got["algo_state_none"]
        assert got["params_digest"] == saved["digest"]


def test_ef_world_resize_zero_resets_residual(tmp_path_factory):
    runs = _ef_runs(tmp_path_factory)
    saved = runs["two"][0]["save:onebit:3:ef_world"]
    for out in runs["four"]:
        got = out["load:onebit:2:ef_world"]
        assert got["step"] == 3
        assert any("elastic resize" in line for line in got["log"])
        assert got["ef_abs"] == 0.0
        assert got["params_digest"] == saved["digest"]


# ---- layouts and plans -------------------------------------------------------


def _run(trainer, state, n):
    return _steps(trainer, state, n)


def _jax_continuity(tmp_path):
    """``tests/test_flat_resident.py:439-493`` on the JAX trainer: 3 flat
    steps, save; restore leaf, 3 steps, save; restore flat under 32-byte
    buckets, 3 steps."""
    loss_fn, params, batch = bench.golden_task()

    def make(mode, bucket_bytes=256):
        return JTrainer(loss_fn, optax.adam(1e-2), JGA(), bucket_bytes=bucket_bytes,
                        autotune=False, flat_resident=mode)

    def run(trainer, state, n):
        out = []
        for _ in range(n):
            state, loss = trainer.train_step(state, batch)
            out.append(float(loss))
        return state, out

    mgr = JManager(str(tmp_path / "jax"), async_save=False)
    t1 = make("on")
    s1, l1 = run(t1, t1.init(params), 3)
    t1.save_checkpoint(mgr, 3, s1)
    t2 = make("off")
    _, s2 = t2.restore_checkpoint(mgr, t2.init(params))
    s2, l2 = run(t2, s2, 3)
    t2.save_checkpoint(mgr, 6, s2)
    t3 = make("on", 32)
    _, s3 = t3.restore_checkpoint(mgr, t3.init(params), step=6)
    _, l3 = run(t3, s3, 3)
    mgr.close()
    return l1 + l2 + l3


def test_checkpoint_flat_leaf_flat_continuity(tmp_path):
    """Save flat -> restore leaf -> restore flat under another plan, against
    the uninterrupted run exactly and the JAX trainer's within 1e-5."""
    t_ref, s_ref = _trainer(opt=ADAM, flat_resident="on")
    _, base = _run(t_ref, s_ref, 9)
    mgr = BaguaCheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    t1, s1 = _trainer(opt=ADAM, flat_resident="on")
    s1, l1 = _run(t1, s1, 3)
    assert t1.save_checkpoint(mgr, 3, s1)
    t2, s2 = _trainer(opt=ADAM, flat_resident="off")
    step, s2 = t2.restore_checkpoint(mgr, s2)
    assert step == 3 and not t2._flat_resident
    s2, l2 = _run(t2, s2, 3)
    assert t2.save_checkpoint(mgr, 6, s2)
    t3, s3 = _trainer(opt=ADAM, flat_resident="on", bucket_bytes=32)
    assert t3.plan.signature() != t1.plan.signature()
    views = {n: p.data_ptr() for n, p in t3._params.items()}
    step, s3 = t3.restore_checkpoint(mgr, s3, step=6)
    assert step == 6
    # the module's parameters stay views of the resident flats
    assert {n: p.data_ptr() for n, p in t3._params.items()} == views
    s3, l3 = _run(t3, s3, 3)
    assert l1 + l2 + l3 == base
    np.testing.assert_allclose(l1 + l2 + l3, _jax_continuity(tmp_path), rtol=1e-5)
    mgr.close()


def test_checkpoint_flat_to_flat_replan(tmp_path):
    t_ref, s_ref = _trainer(opt=SGD_MOMENTUM, flat_resident="on")
    _, base = _run(t_ref, s_ref, 6)
    mgr = BaguaCheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    t1, s1 = _trainer(opt=SGD_MOMENTUM, flat_resident="on")
    s1, head = _run(t1, s1, 3)
    assert t1.save_checkpoint(mgr, 3, s1)
    t2, s2 = _trainer(opt=SGD_MOMENTUM, flat_resident="on", bucket_bytes=32)
    assert t2.plan.signature() != t1.plan.signature()
    step, s2 = t2.restore_checkpoint(mgr, s2)
    assert step == 3
    assert set(s2.optimizer.state) == set(t2._flats)
    _, tail = _run(t2, s2, 3)
    assert head + tail == base
    mgr.close()


def test_checkpoint_qadam_moments_across_layouts(tmp_path):
    """QAdam's moments, laid out like the parameters, move leaf -> flat
    (another plan) -> leaf with them, exactly."""
    def qadam():
        return bt.QAdamAlgorithm(warmup_steps=100, lr=1e-2, hierarchical=False)

    t_ref, s_ref = _trainer(qadam, None, flat_resident="on")
    _, base = _run(t_ref, s_ref, 6)
    mgr = BaguaCheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    t1, s1 = _trainer(qadam, None, flat_resident="off")
    s1, l1 = _run(t1, s1, 3)
    assert t1.save_checkpoint(mgr, 3, s1)
    t2, s2 = _trainer(qadam, None, flat_resident="on", bucket_bytes=128)
    step, s2 = t2.restore_checkpoint(mgr, s2)
    assert step == 3 and isinstance(s2.opt_state.exp_avg, tuple)
    s2, l2 = _run(t2, s2, 2)
    assert t2.save_checkpoint(mgr, 5, s2)
    t3, s3 = _trainer(qadam, None, flat_resident="off")
    step, s3 = t3.restore_checkpoint(mgr, s3)
    assert step == 5 and isinstance(s3.opt_state.exp_avg, dict)
    _, l3 = _run(t3, s3, 1)
    np.testing.assert_array_equal(np.array(l1 + l2 + l3), np.array(base))
    mgr.close()


def test_checkpoint_zero_cross_plan_still_blocked(tmp_path):
    def zero():
        return bt.ZeroOptimizerAlgorithm(ADAM)

    t1, s1 = _trainer(zero, None)
    s1, _ = _run(t1, s1, 1)
    mgr = BaguaCheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    assert t1.save_checkpoint(mgr, 1, s1)
    t2, s2 = _trainer(zero, None, bucket_bytes=32)
    assert t2.plan.signature() != t1.plan.signature()
    with pytest.raises(ValueError, match="checkpoint layout mismatch"):
        t2.restore_checkpoint(mgr, s2)
    mgr.close()


def test_checkpoint_grouped_optimizer_cross_layout_raises_actionably(tmp_path):
    def grouped(params):
        params = list(params)
        return torch.optim.AdamW([{"params": [p for p in params if p.dim() > 1]},
                                  {"params": [p for p in params if p.dim() == 1],
                                   "weight_decay": 0.0}], lr=1e-2)

    t1, s1 = _trainer(opt=grouped, flat_resident="off")
    s1, _ = _run(t1, s1, 1)
    mgr = BaguaCheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    assert t1.save_checkpoint(mgr, 1, s1)
    # the same layout restores, groups and all
    t2, s2 = _trainer(opt=grouped, flat_resident="off")
    assert t2.restore_checkpoint(mgr, s2)[0] == 1
    t3, s3 = _trainer(opt=ADAM, flat_resident="on")
    with pytest.raises(ValueError, match="parameter groups"):
        t3.restore_checkpoint(mgr, s3)
    mgr.close()


def test_checkpoint_stacked_world_size_still_checked():
    M = BaguaCheckpointManager
    base = {"layout": "flat", "plan_signature": "abc", "world_size": 4,
            "bucket_bytes": 256, "plan_dependent": True}
    other = dict(base, world_size=8, bucket_bytes=128)
    M._check_layout(dict(base), dict(other))
    with pytest.raises(ValueError, match="checkpoint layout mismatch"):
        M._check_layout(dict(base, stacked=True), dict(other, stacked=True))


def test_save_checkpoint_refuses_pending_migration(tmp_path):
    t, s = _trainer(flat_resident="on")
    s, _ = _run(t, s, 1)
    decls = [p.declaration() for p in t._named_params]
    t.rebucket(split_bucket_by_bucket_size(decls, 1024))
    assert t._pending_state_migration is not None
    mgr = BaguaCheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    with pytest.raises(RuntimeError, match="migration pending"):
        t.save_checkpoint(mgr, 1, s)
    with pytest.raises(RuntimeError, match="migration pending"):
        t.restore_checkpoint(mgr, s)
    s, _ = _run(t, s, 1)
    assert t.save_checkpoint(mgr, 2, s)
    mgr.close()


def test_layout_descriptor_roundtrips_between_packages():
    """A descriptor written by either package rebuilds the same plan in the
    other: the JAX plan's signature equals the port plan's portable one."""
    from workers.torch_trainer_worker import FlaxLayoutMLP

    _, params, _ = bench.golden_task()
    jplan = JPlan.build(jbuild_params(params), bucket_bytes=256, alignment=2)
    model = FlaxLayoutMLP(_Params({f"{layer}.{k}": np.array(v)
                                   for layer, leaves in params.items()
                                   for k, v in leaves.items()}))
    plan = BucketPlan.build(build_params(model), bucket_bytes=256, alignment=2)
    assert plan.layout_descriptor() == jplan.layout_descriptor()
    assert BucketPlan.from_layout_descriptor(
        jplan.layout_descriptor()).portable_signature() == jplan.signature()
    assert JPlan.from_layout_descriptor(
        plan.layout_descriptor()).signature() == plan.portable_signature()
    back = BucketPlan.from_layout_descriptor(plan.layout_descriptor())
    assert back.signature() == plan.signature()
    bf16 = [{"alignment": 1, "tensors": [{"name": "w", "shape": [2, 3], "dtype": "bfloat16"}]}]
    assert BucketPlan.from_layout_descriptor(bf16).buckets[0].dtype == torch.bfloat16
    assert JPlan.from_layout_descriptor(bf16).layout_descriptor() == bf16
