"""The port's checkpointing (``bagua_tpu_torch/checkpoint.py`` and the
trainer's ``save_checkpoint``/``restore_checkpoint``) against its own
uninterrupted runs and against the JAX package.

Mirrors ``tests/test_checkpoint.py:40-95, 154-205, 260-484``:

- Save -> restore -> resume equals the uninterrupted run bitwise (losses and
  the digest of the whole final state: parameters, optimizer state, the
  algorithm's optimizer and algorithm state) for GradientAllReduce (flat and
  leaf, SGD and AdamW), ByteGrad, the 1-bit ring with its residual, ZeRO
  (flat, leaf, and staged at 2 x 2), both gossip families and async model
  average, at world 1 in this process and at world 2 (and 4 for staged ZeRO)
  over gloo (``tests/workers/torch_checkpoint_worker.py``).  Every save is
  async and is followed by an in-place step before ``wait()``.  The
  interrupted run's losses are within rtol 1e-5 of the JAX trainer's
  interrupted run (orbax's ``BaguaCheckpointManager``) on the golden task.
- Retention pruning, ``try_restore`` on an empty directory, the ZeRO-sharded
  and the hierarchical ZeRO state, ``flush_all_checkpoints``.
- The sidecar round trip and the actionable mismatch error; saves with and
  without metadata mixed in one manager; a legacy sidecar without the newer
  keys.
- ``ckpt.write`` (torn, corrupt) and ``ckpt.sidecar`` fall back to the newest
  verified step; at world 2 a torn part on rank 1 alone, and a torn sidecar,
  make both ranks restore the same older step; an explicit step never falls
  back.
- The quarantine redirect: saves go to ``<dir>.redirect``, restores walk
  both directories.
- ``checkpoint_layout_metadata()`` equals the JAX trainer's key by key for
  GradientAllReduce, ZeRO (flat and staged), 1-bit EF and gossip at world 2
  and 4 (the same named tensors: the port's MLP in flax's layout), and
  ``compute_state_digest`` equals the JAX package's on the same arrays.
"""

import functools
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench
import bagua_tpu_torch as bt
from bagua_tpu.algorithms import DecentralizedAlgorithm as JDecentralized
from bagua_tpu.algorithms import GradientAllReduceAlgorithm as JGA
from bagua_tpu.algorithms import LowPrecisionDecentralizedAlgorithm as JLowPrec
from bagua_tpu.algorithms import ZeroOptimizerAlgorithm as JZero
from bagua_tpu.checkpoint import BaguaCheckpointManager as JManager
from bagua_tpu.checkpoint import compute_state_digest as jdigest
from bagua_tpu.core.backend import BaguaTrainer as JTrainer
from bagua_tpu.parallel.mesh import build_mesh
from bagua_tpu_torch import checkpoint as ck
from bagua_tpu_torch.faults.inject import FaultSpec, fault_scope
from bagua_tpu_torch.telemetry import counters

from workers import torch_checkpoint_worker as worker

torch.set_num_threads(1)

#: the families resumed at world 1 in this process
WORLD1 = ("ga", "ga_leaf", "ga_adamw", "bytegrad", "zero", "zero_leaf", "dec_all", "lowprec",
          "async")
#: the families resumed at world 2 over gloo
WORLD2 = ("ga", "ga_leaf", "bytegrad", "onebit", "zero", "zero_leaf", "dec_all", "lowprec",
          "async")
#: worker family -> the JAX algorithm and optimizer of the same run
JAX_FAMILIES = {
    "ga": (JGA, optax.sgd(0.1), {}),
    "ga_leaf": (JGA, optax.sgd(0.1), {"flat_resident": "off"}),
    "onebit": (JGA, optax.sgd(0.1), {"compress_intra": "onebit_ef"}),
    "zero": (lambda: JZero(optax.adam(1e-2)), None, {}),
    "zero_staged": (lambda: JZero(optax.adam(1e-2), hierarchical=True), None, {}),
    "dec_all": (lambda: JDecentralized(hierarchical=False), optax.sgd(0.1), {}),
    "lowprec": (lambda: JLowPrec(hierarchical=False), optax.sgd(0.1), {}),
}
#: the interrupted run's losses against the JAX trainer's (relative)
JAX_RTOL = 1e-5
_SPAWNED = {}


@pytest.fixture(scope="module", autouse=True)
def process_group():
    bt.init_process_group(device="cpu")


@pytest.fixture(autouse=True)
def no_quarantine():
    ck.clear_quarantine()
    yield
    ck.clear_quarantine()


def _golden(tmp_path):
    """The golden task as the worker reads it: the params file and the
    whole batch (world 1)."""
    _, params, batch = bench.golden_task()
    path = tmp_path / "params.npz"
    np.savez(path, **{f"{layer}.{k}": np.asarray(v) for layer, leaves in params.items()
                      for k, v in leaves.items()})
    return str(path), {"x": torch.from_numpy(np.array(batch["x"])),
                       "y": torch.from_numpy(np.array(batch["y"]).astype(np.int64))}


def _spawned(tmp_path_factory, world):
    """Every multi-rank run of this module, one launch a world."""
    if world not in _SPAWNED:
        tmp = tmp_path_factory.mktemp(f"ckpt{world}")
        if world == 2:
            runs = ([f"resume:{f}" for f in WORLD2]
                    + ["fallback:write", "fallback:sidecar"]
                    + [f"meta:{f}" for f in ("ga", "zero", "onebit", "dec_all", "lowprec")])
            env = None
        else:
            runs = ["resume:zero_staged"] + [f"meta:{f}" for f in ("ga", "zero", "zero_staged",
                                                                    "onebit", "dec_all")]
            env = {r: {"LOCAL_WORLD_SIZE": "2"} for r in range(world)}
        _SPAWNED[world] = worker.spawn(world, runs, tmp, tmp / "ck", rank_env=env)
    return _SPAWNED[world]


def _jax_loss(params, batch):
    from bagua_tpu.models.mlp import MLP

    logits = MLP(features=(32, 8)).apply({"params": params}, batch["x"])
    return optax.softmax_cross_entropy_with_integer_labels(logits, batch["y"]).mean()


def _jax_trainer(family, world):
    algo, opt, kw = JAX_FAMILIES[family]
    axes = {"inter": world // 2, "intra": 2} if family == "zero_staged" else {"dp": world}
    return JTrainer(_jax_loss, opt, algo(), mesh=build_mesh(axes, jax.devices()[:world]),
                    bucket_bytes=256, autotune=False, **kw)


def _jax_interrupted(family, world, tmp_path):
    """The JAX trainer's interrupted run: ``SAVE_AT`` steps, an orbax save,
    a fresh trainer restoring it, the rest."""
    _, params, batch = bench.golden_task()
    t1 = _jax_trainer(family, world)
    s1 = t1.init(params)
    data = t1.shard_batch(batch)
    losses = []
    for _ in range(worker.SAVE_AT):
        s1, loss = t1.train_step(s1, data)
        losses.append(float(loss))
    mgr = JManager(str(tmp_path / f"jax_{family}_{world}"), async_save=False)
    assert t1.save_checkpoint(mgr, worker.SAVE_AT, s1)
    t2 = _jax_trainer(family, world)
    step, s2 = t2.restore_checkpoint(mgr, t2.init(params))
    assert step == worker.SAVE_AT
    for _ in range(worker.STEPS - worker.SAVE_AT):
        s2, loss = t2.train_step(s2, data)
        losses.append(float(loss))
    mgr.close()
    return losses


# ---- resume equals the uninterrupted run ----------------------------------


@pytest.mark.parametrize("family", WORLD1)
def test_resume_equals_uninterrupted_world1(tmp_path, family):
    params_path, batch = _golden(tmp_path)
    rec = worker.run_resume(family, batch, params_path, str(tmp_path))
    assert rec["step"] == worker.SAVE_AT
    assert rec["run"] == rec["ref"]
    assert rec["run_digest"] == rec["ref_digest"]
    if family in ("ga", "ga_leaf"):
        np.testing.assert_allclose(rec["run"], _jax_interrupted(family, 1, tmp_path),
                                   rtol=JAX_RTOL)


@pytest.mark.parametrize("family", WORLD2)
def test_resume_equals_uninterrupted_world2(tmp_path_factory, tmp_path, family):
    ranks = _spawned(tmp_path_factory, 2)
    for r, out in enumerate(ranks):
        rec = out[f"resume:{family}"]
        assert rec["step"] == worker.SAVE_AT, r
        assert rec["run"] == rec["ref"], r
        assert rec["run_digest"] == rec["ref_digest"], r
    if family in ("ga", "onebit", "zero", "dec_all"):
        np.testing.assert_allclose(ranks[0][f"resume:{family}"]["run"],
                                   _jax_interrupted(family, 2, tmp_path), rtol=JAX_RTOL)


def test_resume_hierarchical_zero_state(tmp_path_factory, tmp_path):
    """``test_checkpoint.py:430-484``: the staged ZeRO state (sharded over
    the two ranks of a node, replicated across the nodes) resumes bitwise at
    2 x 2, its losses on the JAX trainer's, ``opt_shards`` the intra size."""
    ranks = _spawned(tmp_path_factory, 4)
    for r, out in enumerate(ranks):
        rec = out["resume:zero_staged"]
        assert rec["run"] == rec["ref"] and rec["run_digest"] == rec["ref_digest"], r
        assert rec["meta"]["opt_shards"] == 2
    np.testing.assert_allclose(ranks[0]["resume:zero_staged"]["run"],
                               _jax_interrupted("zero_staged", 4, tmp_path), rtol=JAX_RTOL)


def test_gossip_ranks_save_their_own_state(tmp_path_factory):
    """The gossip families' per-rank state: the ranks' final states differ,
    and each resumed its own."""
    ranks = _spawned(tmp_path_factory, 2)
    for family in ("dec_all", "lowprec", "async"):
        digests = [out[f"resume:{family}"]["run_digest"] for out in ranks]
        assert digests[0] != digests[1], family


# ---- the manager -----------------------------------------------------------


class _Params(dict):
    """The golden params by flat name, read as the worker's npz file."""

    @property
    def files(self):
        return list(self)


def _trainer(algo=bt.GradientAllReduceAlgorithm, opt=functools.partial(torch.optim.SGD, lr=0.1),
             **kw):
    from workers.torch_trainer_worker import FlaxLayoutMLP

    _, params, _ = bench.golden_task()
    model = FlaxLayoutMLP(_Params({f"{layer}.{k}": np.array(v) for layer, leaves in params.items()
                                   for k, v in leaves.items()}))
    trainer = bt.BaguaTrainer(lambda m, b: torch.nn.functional.cross_entropy(m(b["x"]), b["y"]),
                              opt, algo(), device="cpu", **{"bucket_bytes": 256, **kw})
    return trainer, trainer.init(model)


def _batch():
    _, _, batch = bench.golden_task()
    return {"x": torch.from_numpy(np.array(batch["x"])),
            "y": torch.from_numpy(np.array(batch["y"]).astype(np.int64))}


def _steps(trainer, state, n):
    batch, losses = _batch(), []
    for _ in range(n):
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    return state, losses


def _zero(**kw):
    return _trainer(lambda: bt.ZeroOptimizerAlgorithm(functools.partial(torch.optim.Adam,
                                                                        lr=1e-2)), None, **kw)


def test_raw_manager_resume_of_a_train_state(tmp_path):
    """``test_checkpoint.py:40-69``: the manager alone saves a ``TrainState``
    and restores it into a fresh one in place, and the run goes on as if
    uninterrupted."""
    t0, s0 = _trainer()
    _, ref = _steps(t0, s0, 6)
    t1, s1 = _trainer()
    s1, head = _steps(t1, s1, 3)
    mgr = bt.BaguaCheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    assert mgr.save(3, s1)
    mgr.wait()
    t2, s2 = _trainer()
    flats = [f.data_ptr() for f in t2._flats]
    step, s2 = mgr.restore(s2)
    assert step == 3 and s2.step == 3
    assert [f.data_ptr() for f in t2._flats] == flats   # copied in place
    _, tail = _steps(t2, s2, 3)
    assert head + tail == ref
    # the trainer restores what the manager alone saved, in place too
    t3, s3 = _trainer()
    step, s3 = t3.restore_checkpoint(mgr, s3)
    assert step == 3
    assert head + _steps(t3, s3, 3)[1] == ref
    mgr.close()


def test_retention_pruning(tmp_path):
    t, s = _trainer()
    mgr = bt.BaguaCheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2, async_save=False)
    for step in range(5):
        s, _ = _steps(t, s, 1)
        t.save_checkpoint(mgr, step, s)
    mgr.wait()
    assert mgr.latest_step() == 4
    assert mgr.all_steps() == [3, 4]
    assert sorted(p.name for p in (tmp_path / "ckpt").glob("*.layout.json")) == [
        "3.layout.json", "4.layout.json"]
    mgr.close()


def test_save_interval_skips(tmp_path):
    t, s = _trainer()
    mgr = bt.BaguaCheckpointManager(str(tmp_path / "ckpt"), save_interval_steps=2,
                                    async_save=False)
    assert not mgr.save(1, {"w": torch.zeros(2)})
    assert mgr.save(2, {"w": torch.zeros(2)})
    assert not mgr.save(2, {"w": torch.ones(2)})
    assert mgr.all_steps() == [2]
    mgr.close()


def test_try_restore_empty_dir(tmp_path):
    t, s = _trainer()
    mgr = bt.BaguaCheckpointManager(str(tmp_path / "none"), async_save=False)
    step, s2 = mgr.try_restore(s)
    assert step is None and s2 is s
    with pytest.raises(FileNotFoundError):
        t.restore_checkpoint(mgr, s)
    mgr.close()


def test_save_restore_zero_sharded_opt_state(tmp_path):
    """``test_checkpoint.py:154-203``: ZeRO's optimizer shard round-trips and
    the resumed run equals the uninterrupted one, bitwise."""
    t0, s0 = _zero()
    _, ref = _steps(t0, s0, 6)
    t1, s1 = _zero()
    s1, head = _steps(t1, s1, 3)
    mgr = bt.BaguaCheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    assert t1.save_checkpoint(mgr, 3, s1)
    t2, s2 = _zero()
    chunks = [c.data_ptr() for c in s2.opt_state.chunks]
    step, s2 = t2.restore_checkpoint(mgr, s2)
    assert step == 3
    assert [c.data_ptr() for c in s2.opt_state.chunks] == chunks
    _, tail = _steps(t2, s2, 3)
    assert head + tail == ref
    mgr.close()


def test_flush_all_checkpoints_drains_async_saves(tmp_path):
    mgr = bt.BaguaCheckpointManager(str(tmp_path / "ck"), async_save=True)
    assert mgr.save(0, {"w": torch.arange(8.0)})
    bt.flush_all_checkpoints(timeout_s=30.0)
    assert mgr.all_steps() == [0]
    step, restored = mgr.restore({"w": torch.zeros(8)})
    assert step == 0
    np.testing.assert_array_equal(restored["w"].numpy(), np.arange(8.0))
    mgr.close()


def test_async_save_snapshot_survives_in_place_step(tmp_path):
    """An async save followed at once by an in-place step restores the state
    at the save, bitwise: the snapshot is taken before ``save`` returns."""
    t, s = _trainer(opt=functools.partial(torch.optim.AdamW, lr=1e-2))
    s, _ = _steps(t, s, 2)
    want = ck.compute_state_digest(t._checkpoint_state(s))
    mgr = bt.BaguaCheckpointManager(str(tmp_path / "ckpt"), async_save=True)
    assert t.save_checkpoint(mgr, 2, s)
    s, _ = _steps(t, s, 1)
    assert ck.compute_state_digest(t._checkpoint_state(s)) != want
    mgr.wait()
    t2, s2 = _trainer(opt=functools.partial(torch.optim.AdamW, lr=1e-2))
    step, s2 = t2.restore_checkpoint(mgr, s2)
    assert step == 2
    assert ck.compute_state_digest(t2._checkpoint_state(s2)) == want
    mgr.close()


def test_layout_metadata_roundtrip_and_mismatch(tmp_path):
    """``test_checkpoint.py:281-333``: the sidecar round-trips at the same
    plan and a raw restore under another plan raises the actionable layout
    error before any shape error."""
    t1, s1 = _zero()
    s1, _ = _steps(t1, s1, 1)
    meta = t1.checkpoint_layout_metadata()
    assert meta["layout"] == "flat" and meta["plan_dependent"] and meta["flat_layout"]
    mgr = bt.BaguaCheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    assert mgr.save(1, s1, metadata=meta)
    assert mgr.read_layout(1)["plan_signature"] == meta["plan_signature"]
    t2, s2 = _zero()
    step, s2 = mgr.restore(s2, expect_metadata=t2.checkpoint_layout_metadata())
    assert step == 1
    s2, losses = _steps(t2, s2, 1)
    assert np.isfinite(losses[0])
    t3, s3 = _zero(bucket_bytes=32)
    assert t3.plan.signature() != t1.plan.signature()
    with pytest.raises(ValueError, match="checkpoint layout mismatch"):
        mgr.restore(s3, expect_metadata=t3.checkpoint_layout_metadata())
    mgr.close()


def test_checkpoint_without_metadata_still_restores(tmp_path):
    t, s = _trainer()
    s, _ = _steps(t, s, 1)
    mgr = bt.BaguaCheckpointManager(str(tmp_path / "ckpt"), async_save=False, integrity=False)
    assert mgr.save(1, s)
    assert mgr.read_layout(1) is None
    t2, s2 = _trainer()
    step, s2 = mgr.restore(s2, expect_metadata=t2.checkpoint_layout_metadata())
    assert step == 1
    s2, losses = _steps(t2, s2, 1)
    assert np.isfinite(losses[0])
    mgr.close()


def test_mixed_metadata_and_plain_saves_one_manager(tmp_path):
    """``test_checkpoint.py:356-387``: plain and metadata saves in one
    manager; a leaf-layout metadata difference only logs."""
    t, s = _trainer(flat_resident="off")
    s, _ = _steps(t, s, 1)
    mgr = bt.BaguaCheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    assert mgr.save(1, s)
    assert mgr.save(2, s, metadata=t.checkpoint_layout_metadata())
    assert mgr.save(3, s)
    t2, s2 = _trainer(flat_resident="off")
    other = dict(t2.checkpoint_layout_metadata())
    other["world_size"] += 1
    step, s2 = mgr.restore(s2, step=2, expect_metadata=other)
    assert step == 2
    s2, losses = _steps(t2, s2, 1)
    assert np.isfinite(losses[0])
    step, _ = mgr.try_restore(_trainer(flat_resident="off")[1],
                              expect_metadata=t2.checkpoint_layout_metadata())
    assert step == 3
    mgr.close()


def test_legacy_sidecar_missing_new_keys_still_restores(tmp_path, caplog):
    t, s = _zero()
    s, _ = _steps(t, s, 1)
    legacy = dict(t.checkpoint_layout_metadata())
    legacy.pop("opt_shards")
    mgr = bt.BaguaCheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    assert mgr.save(1, s, metadata=legacy)
    t2, s2 = _zero()
    with caplog.at_level(logging.WARNING, logger="bagua_tpu_torch.checkpoint"):
        step, s2 = mgr.restore(s2, expect_metadata=t2.checkpoint_layout_metadata())
    assert step == 1
    assert any("predates field(s) opt_shards" in r.getMessage() for r in caplog.records)
    s2, losses = _steps(t2, s2, 1)
    assert np.isfinite(losses[0])
    mgr.close()


def test_ranked_state_and_plain_tree_roundtrip(tmp_path):
    """A ``RankedState`` restores as one, a plain tree as the tree, with the
    devices of ``state_like``; a tree that does not fit raises."""
    mgr = bt.BaguaCheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": [torch.ones(2, dtype=torch.bfloat16), 3]}
    assert mgr.save(1, tree)
    assert mgr.save(2, ck.RankedState({"s": torch.zeros(3)}, {"r": torch.ones(4)}))
    step, got = mgr.restore(step=1)
    assert step == 1 and torch.equal(got["a"], tree["a"]) and got["b"][1] == 3
    assert got["b"][0].dtype == torch.bfloat16
    step, got = mgr.restore(step=2)
    assert isinstance(got, ck.RankedState) and torch.equal(got.per_rank["r"], torch.ones(4))
    with pytest.raises(ck.CheckpointIntegrityError, match="does not fit"):
        mgr.restore({"a": torch.zeros(3), "b": [torch.ones(2), 3]}, step=1)
    mgr.close()


# ---- integrity ---------------------------------------------------------------


@pytest.mark.parametrize("kind", ["torn", "corrupt"])
def test_ckpt_write_falls_back_to_previous_step(tmp_path, kind, caplog):
    t, s = _trainer()
    mgr = bt.BaguaCheckpointManager(str(tmp_path / "ckpt"), async_save=True)
    s, _ = _steps(t, s, 2)
    assert t.save_checkpoint(mgr, 2, s)
    s, _ = _steps(t, s, 2)
    before = counters.snapshot()
    with fault_scope(FaultSpec("ckpt.write", step=4, kind=kind, seed=3)):
        assert t.save_checkpoint(mgr, 4, s)
        mgr.wait()
        assert counters.get("faults/ckpt.write/fired") - before.get(
            "faults/ckpt.write/fired", 0) == 1
        t2, s2 = _trainer()
        with caplog.at_level(logging.WARNING, logger="bagua_tpu_torch.checkpoint"):
            step, s2 = t2.restore_checkpoint(mgr, s2)
    assert step == 2
    assert any("FAILED verification" in r.getMessage() for r in caplog.records)
    assert counters.get("ckpt/fallback_restores") - before.get("ckpt/fallback_restores", 0) == 1
    assert counters.get("faults/ckpt.write/recovered") - before.get(
        "faults/ckpt.write/recovered", 0) == 1
    # an explicit step never falls back
    with pytest.raises(ck.CheckpointIntegrityError):
        t2.restore_checkpoint(mgr, s2, step=4)
    s2, losses = _steps(t2, s2, 1)
    assert np.isfinite(losses[0])
    mgr.close()


@pytest.mark.parametrize("kind", ["truncate", "corrupt"])
def test_ckpt_sidecar_falls_back_to_previous_step(tmp_path, kind):
    t, s = _trainer()
    mgr = bt.BaguaCheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    assert t.save_checkpoint(mgr, 1, s)
    s, _ = _steps(t, s, 1)
    with fault_scope(FaultSpec("ckpt.sidecar", step=2, kind=kind)):
        assert t.save_checkpoint(mgr, 2, s)
    step, _ = t.restore_checkpoint(mgr, _trainer()[1])
    assert step == 1
    mgr.close()


def test_no_verified_step_raises(tmp_path):
    mgr = bt.BaguaCheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    with fault_scope(FaultSpec("ckpt.write", count=-1, kind="torn")):
        assert mgr.save(1, {"w": torch.ones(64)})
    with pytest.raises(ck.CheckpointIntegrityError, match="passed verification"):
        mgr.restore({"w": torch.zeros(64)})
    mgr.close()


@pytest.mark.parametrize("kind", ["write", "sidecar"])
def test_ranks_agree_on_the_fallback(tmp_path_factory, kind):
    """A torn part on rank 1 alone, or a torn sidecar, makes both ranks
    restore the same older step."""
    for out in _spawned(tmp_path_factory, 2):
        rec = out[f"fallback:{kind}"]
        assert rec["step"] == 2
        assert rec["counters"] == {"ckpt/fallback_restores": 1, "ckpt/integrity_failures": 1}


def test_quarantine_redirect_restores_walk_both(tmp_path, monkeypatch):
    root = tmp_path / "ckpt"
    t, s = _trainer()
    mgr = bt.BaguaCheckpointManager(str(root), async_save=False)
    assert t.save_checkpoint(mgr, 1, s)
    assert ck.quarantine_storage_path(str(root))
    assert not ck.quarantine_storage_path(str(root))
    assert ck.is_quarantined(str(root)) and ck.quarantined_paths() == [str(root)]
    s, _ = _steps(t, s, 1)
    with fault_scope(FaultSpec("ckpt.write", step=2, kind="torn")):
        assert t.save_checkpoint(mgr, 2, s)
    assert mgr.directory == ck.redirect_directory(str(root))
    assert (tmp_path / "ckpt.redirect" / "2" / "manifest.json").exists()
    assert mgr.latest_step() == 2
    # the redirect's step is torn: the walk reaches the quarantined history
    step, _ = t.restore_checkpoint(mgr, _trainer()[1])
    assert step == 1
    # a new manager on the quarantined path (and the env seed) resolves it
    ck.clear_quarantine()
    monkeypatch.setattr(ck, "_QUARANTINE_SEEDED", False)
    monkeypatch.setenv("BAGUA_CKPT_QUARANTINED_PATHS", f"{root}\n")
    assert ck.active_directory(str(root)) == str(root) + ".redirect"
    mgr2 = bt.BaguaCheckpointManager(str(root), async_save=False)
    assert mgr2.directory == str(root) + ".redirect" and mgr2._fallbacks == [str(root)]
    assert mgr2.restore(_trainer()[1], step=1)[0] == 1
    mgr.close()
    mgr2.close()


# ---- parity with the JAX package -------------------------------------------


def _jax_meta(family, world):
    _, params, _ = bench.golden_task()
    t = _jax_trainer(family, world)
    t.init(params)
    return t.checkpoint_layout_metadata()


@pytest.mark.parametrize("world,family", [
    (2, "ga"), (2, "zero"), (2, "onebit"), (2, "dec_all"), (2, "lowprec"),
    (4, "ga"), (4, "zero"), (4, "zero_staged"), (4, "onebit"), (4, "dec_all")])
def test_layout_metadata_matches_jax(tmp_path_factory, world, family):
    ranks = _spawned(tmp_path_factory, world)
    port = ranks[0][f"meta:{family}"]
    assert all(out[f"meta:{family}"] == port for out in ranks)
    want = json.loads(json.dumps(_jax_meta(family, world)))
    assert sorted(port) == sorted(want)
    for key in want:
        assert port[key] == want[key], key


def test_compute_state_digest_matches_jax():
    rng = np.random.default_rng(0)
    arrays = {"w": rng.standard_normal((3, 5)).astype(np.float32),
              "b": [rng.standard_normal(4).astype(np.float32), np.arange(3, dtype=np.int32)],
              "n": 7}
    port = ck.compute_state_digest({"w": torch.from_numpy(arrays["w"]),
                                    "b": [torch.from_numpy(a) for a in arrays["b"]], "n": 7})
    assert port == jdigest({"w": jnp.asarray(arrays["w"]),
                            "b": [jnp.asarray(a) for a in arrays["b"]], "n": 7})
