"""The port's communicator against the JAX package's.

Mirrors ``tests/test_communication.py`` (``:30-76, 149``) at world 2 and 4:
``tests/workers/torch_collectives_worker.py`` runs each case on as many gloo
ranks, and the JAX ``BaguaCommunicator`` runs it under ``shard_map`` on as
many CPU devices, on the same numpy inputs (row r is rank r's operand).

- ``allreduce`` computes every ``ReduceOp``: SUM, AVG, MIN and MAX on f32,
  PRODUCT on f32 in (0.5, 1.5), BOR, BAND and BXOR on int32 and bool, the
  bitwise ones once through gloo's own reductions and once through the
  gather an NCCL group takes (NCCL has none);
- ``allgather`` (tiled and stacked), ``reduce_scatter`` (SUM and AVG) and
  ``alltoall`` take axes 0, 1 and -1.  JAX's ``psum_scatter`` and
  ``all_to_all`` lower a negative axis to an invalid program, so their side
  gets it counted from the front;
- ``ppermute`` with fixed points returns the rank's own operand there, beside
  a swap, a cycle, and ranks that receive nothing (zeros);
- ``barrier``, and the process-wide abort flag.

Floating results within rtol 1e-6 (the sums of four ranks may run in another
order), the others exactly.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import bagua_tpu_torch as bt
from bagua_tpu.communication import BaguaCommunicator as JComm
from bagua_tpu.communication import ReduceOp as JReduceOp
from bagua_tpu.compat import shard_map
from bagua_tpu_torch import communication
from bagua_tpu_torch.models.mlp import MLP
from bagua_tpu_torch.telemetry import counters

sys.path.insert(0, str(Path(__file__).resolve().parent / "workers"))
from torch_collectives_worker import ALLREDUCE, ALLTOALL, AXES, ppermutes  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "workers" / "torch_collectives_worker.py"
WORLDS = (2, 4)
_RUNS = {}


def _inputs(world):
    rng = np.random.default_rng(world)
    return {"x": rng.normal(size=(world, 4, 8)).astype(np.float32),
            "p": rng.uniform(0.5, 1.5, size=(world, 4, 8)).astype(np.float32),
            "i": rng.integers(0, 2 ** 20, size=(world, 4, 8)).astype(np.int32),
            "b": rng.integers(0, 2, size=(world, 4, 8)).astype(bool),
            "t": rng.normal(size=(world, world, world, world)).astype(np.float32)}


def _run(world, tmp_path_factory):
    """Every rank's results, ``[world, ...]`` by case name."""
    if world not in _RUNS:
        tmp = tmp_path_factory.mktemp(f"collectives{world}")
        np.savez(tmp / "in.npz", **_inputs(world))
        env = {**os.environ, "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
        outs = [tmp / f"out{r}.npz" for r in range(world)]
        procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(world),
                                   f"file://{tmp / 'store'}", str(tmp / "in.npz"), str(outs[r])],
                                  env=env) for r in range(world)]
        try:
            assert [p.wait(timeout=300) for p in procs] == [0] * world
        finally:
            for p in procs:
                p.kill()
        loaded = [np.load(o) for o in outs]
        _RUNS[world] = {k: np.stack([o[k] for o in loaded]) for k in loaded[0].files}
    return _RUNS[world]


def _jax(world, fn, x):
    """``fn(comm, row)`` on every rank's row of ``x`` under ``shard_map`` over
    ``world`` CPU devices; ``[world, ...]``."""
    mesh = Mesh(np.array(jax.devices()[:world]), ("dp",))
    comm = JComm("dp", mesh)
    f = shard_map(lambda v: fn(comm, v[0])[None], mesh=mesh, in_specs=P("dp"),
                  out_specs=P("dp"), check_vma=False)
    return np.asarray(f(jnp.asarray(x)))


def _check(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape,
                                                                  got.dtype, want.dtype)
    if np.issubdtype(got.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("op,key", [(op.name, key) for op, key in ALLREDUCE])
def test_allreduce_every_op_matches_jax(world, op, key, tmp_path_factory):
    got = _run(world, tmp_path_factory)
    want = _jax(world, lambda c, v: c.allreduce(v, JReduceOp[op]), _inputs(world)[key])
    _check(got[f"allreduce/{op}/{key}"], want)
    if f"allreduce_gathered/{op}/{key}" in got:
        _check(got[f"allreduce_gathered/{op}/{key}"], want)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("tiled", [True, False])
def test_allgather_along_any_axis_matches_jax(world, axis, tiled, tmp_path_factory):
    got = _run(world, tmp_path_factory)[f"allgather/{axis}/{tiled}"]
    _check(got, _jax(world, lambda c, v: c.allgather(v, axis=axis, tiled=tiled),
                     _inputs(world)["x"]))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("op", ["SUM", "AVG"])
def test_reduce_scatter_along_any_axis_matches_jax(world, axis, op, tmp_path_factory):
    got = _run(world, tmp_path_factory)[f"reduce_scatter/{axis}/{op}"]
    _check(got, _jax(world, lambda c, v: c.reduce_scatter(v, JReduceOp[op], axis=axis % 2),
                     _inputs(world)["x"]))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("split,concat", ALLTOALL)
def test_alltoall_along_any_axis_matches_jax(world, split, concat, tmp_path_factory):
    got = _run(world, tmp_path_factory)[f"alltoall/{split}/{concat}"]
    s, c = split % 3, concat % 3
    _check(got, _jax(world, lambda comm, v: comm.alltoall(v, s, c), _inputs(world)["t"]))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(ppermutes(4)))
def test_ppermute_with_fixed_points_matches_jax(world, name, tmp_path_factory):
    perm = ppermutes(world)[name]
    x = _inputs(world)["x"]
    got = _run(world, tmp_path_factory)[f"ppermute/{name}"]
    _check(got, _jax(world, lambda c, v: c.ppermute(v, perm), x))
    for s, d in perm:
        if s == d:
            np.testing.assert_array_equal(got[d], x[d])


@pytest.mark.parametrize("world", WORLDS)
def test_barrier_and_no_staging_on_the_cpu(world, tmp_path_factory):
    # every rank passed both barriers and wrote its results; CPU operands
    # never stage through the host
    assert (_run(world, tmp_path_factory)["host_staged_bytes"] == 0).all()


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------


@pytest.fixture
def _clear_abort():
    bt.reset_abort()
    yield
    bt.reset_abort()


def test_abort_flag(_clear_abort):
    before = counters.snapshot()
    assert not bt.is_aborted()
    bt.check_abort()
    bt.abort("drill")
    assert bt.is_aborted()
    with pytest.raises(bt.BaguaAborted, match="drill"):
        bt.check_abort()
    bt.reset_abort()
    assert not bt.is_aborted()
    bt.check_abort()
    bt.reset_abort()   # a reset with no abort counts nothing
    assert counters.get("comm/aborts") - before.get("comm/aborts", 0) == 1
    assert counters.get("comm/abort_resets") - before.get("comm/abort_resets", 0) == 1


def test_trainer_refuses_a_step_after_abort(_clear_abort):
    bt.init_process_group(device="cpu")
    model = MLP(4, features=(8, 3), device="cpu", seed=0)
    trainer = bt.BaguaTrainer(lambda m, b: m(b["x"]).sum(),
                              lambda p: torch.optim.SGD(p, lr=0.1),
                              bt.GradientAllReduceAlgorithm(), device="cpu")
    state = trainer.init(model)
    batch = {"x": torch.ones(2, 4)}
    state, _ = trainer.train_step(state, batch)
    bt.abort()
    with pytest.raises(bt.BaguaAborted):
        trainer.train_step(state, batch)
    assert trainer._step_counter == 1
    bt.reset_abort()
    trainer.train_step(state, batch)
    assert trainer._step_counter == 2


def test_bitwise_ops_take_integers_and_axes_are_checked():
    bt.init_process_group(device="cpu")
    comm = bt.get_backend().global_communicator
    for op in (bt.ReduceOp.BOR, bt.ReduceOp.BAND, bt.ReduceOp.BXOR):
        with pytest.raises(TypeError, match="integer or bool"):
            comm.allreduce(torch.ones(3), op)
    x = torch.arange(6).reshape(2, 3)
    assert torch.equal(comm.allreduce(x.clone(), bt.ReduceOp.BXOR), x)
    with pytest.raises(ValueError, match="out of range"):
        comm.allgather(x, axis=2)
    with pytest.raises(ValueError, match="out of range"):
        comm.reduce_scatter(x, axis=-3)
    assert comm.allgather(x, axis=2, tiled=False).shape == (2, 3, 1)
    assert communication._axis(-1, 3) == 2
