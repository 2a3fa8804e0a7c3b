"""The port's eager collective API against the JAX package's.

Mirrors ``tests/test_communication.py``, ``tests/test_alltoall_v.py`` and the
dispatch case of ``tests/test_abort.py`` (``:142-170``); the in-place names
(``allgather_inplace``, ``reduce_scatter_inplace``, ``alltoall_inplace``)
are cases of their own.  JAX's eager calls
take a leading rank axis, since one process holds every rank; the port's
take each process's own tensor.  So ``tests/workers/torch_overlap_worker.py``
runs every call on world 2 and 4 gloo ranks, row r of the inputs on rank r,
and the stacked results are held against JAX's eager function on the same
stacked inputs over as many CPU devices, row by row: sums within 1e-6
(four ranks may add in another order), everything else exactly.  Non-root
ranks of ``reduce`` and ``gather`` get their ``recv`` back, or zeros;
``alltoall_v`` zero-pads to the largest receive total or to
``output_size``, equals the dense ``alltoall`` under uniform counts and
refuses counts or an output size that do not fit.  After ``abort`` every
eager call raises ``BaguaAborted`` at dispatch; after ``reset_abort`` the
calls run again.
"""

import jax
import numpy as np
import pytest
import torch

import bagua_tpu
import bagua_tpu_torch as bt
from bagua_tpu.communication import BaguaCommunicator as JComm
from bagua_tpu.communication import ReduceOp as JReduceOp
from bagua_tpu.parallel.mesh import build_mesh

from test_torch_overlap import WORLDS, worker_inputs, worker_run


def _jcomm(world):
    return JComm("dp", build_mesh({"dp": world}, jax.devices()[:world]))


def _check(got, want, exact=True):
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _jax_calls(world):
    """case -> (JAX eager call on the stacked inputs, exact)."""
    d = worker_inputs(world)
    c = _jcomm(world)
    e = d["e"]
    perm = [(r, (r + 1) % world) for r in range(world)]
    calls = {f"eager/allreduce/{op}": (lambda op=op: bagua_tpu.allreduce(e, JReduceOp[op], comm=c),
                                       op in ("MAX", "MIN"))
             for op in ("AVG", "SUM", "MAX", "MIN")}
    calls.update({
        "eager/allreduce_inplace": (lambda: bagua_tpu.allreduce_inplace(e, JReduceOp.SUM, comm=c),
                                    False),
        "eager/allgather": (lambda: bagua_tpu.allgather(e, comm=c), True),
        "eager/reduce_scatter": (lambda: bagua_tpu.reduce_scatter(e, JReduceOp.SUM, comm=c),
                                 False),
        "eager/alltoall": (lambda: bagua_tpu.alltoall(e, comm=c), True),
        "eager/allgather_inplace": (lambda: bagua_tpu.allgather_inplace(e, comm=c), True),
        "eager/reduce_scatter_inplace": (
            lambda: bagua_tpu.reduce_scatter_inplace(e, JReduceOp.SUM, comm=c), False),
        "eager/alltoall_inplace": (lambda: bagua_tpu.alltoall_inplace(e, comm=c), True),
        "eager/broadcast": (lambda: bagua_tpu.broadcast(e, src=world - 1, comm=c), True),
        "eager/reduce": (lambda: bagua_tpu.reduce(e, 1, JReduceOp.SUM, comm=c), False),
        "eager/reduce_recv": (lambda: bagua_tpu.reduce(e, 1, JReduceOp.SUM, comm=c,
                                                       recv=d["recv"]), False),
        "eager/gather": (lambda: bagua_tpu.gather(e, world - 1, comm=c), True),
        "eager/gather_recv": (lambda: bagua_tpu.gather(e, world - 1, comm=c, recv=d["grecv"]),
                              True),
        "eager/scatter": (lambda: bagua_tpu.scatter(e, 1, comm=c), True),
        "eager/send_recv": (lambda: bagua_tpu.send_recv(e, perm, comm=c), True),
        "eager/alltoall_v": (lambda: bagua_tpu.alltoall_v(d["v"], d["counts"], comm=c), True),
        "eager/alltoall_v_padded": (lambda: bagua_tpu.alltoall_v(
            d["v"], d["counts"], output_size=int(d["counts"].sum(axis=0).max()) + 3, comm=c),
            True),
        "eager/alltoall_v_uniform": (lambda: bagua_tpu.alltoall_v(
            e[:, :2 * world], np.full((world, world), 2), comm=c), True),
        "eager/alltoall_uniform": (lambda: bagua_tpu.alltoall(e[:, :2 * world], comm=c), True),
    })
    return calls


CASES = sorted(_jax_calls(2))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_eager_call_matches_jax_row_by_row(world, case, tmp_path_factory):
    got = worker_run(world, tmp_path_factory)[case]
    call, exact = _jax_calls(world)[case]
    _check(got, call(), exact)


@pytest.mark.parametrize("world", WORLDS)
def test_eager_semantics_against_numpy(world, tmp_path_factory):
    got = worker_run(world, tmp_path_factory)
    d = worker_inputs(world)
    e = d["e"]
    assert got["eager/allreduce_inplace_same"].all()   # in place: the caller's tensor
    for r in range(world):
        # non-root ranks: their recv, or zeros
        if r != 1:
            _check(got["eager/reduce"][r], np.zeros_like(e[r]))
            _check(got["eager/reduce_recv"][r], d["recv"][r])
        if r != world - 1:
            _check(got["eager/gather"][r], np.zeros((4 * world * world, 6), np.float32))
            _check(got["eager/gather_recv"][r], d["grecv"][r])
        # scatter reads rank 1's buffer alone
        _check(got["eager/scatter"][r], e[1].reshape(world, 4, 6)[r])
    _check(got["eager/reduce"][1], e.sum(0), exact=False)
    _check(got["eager/gather"][world - 1], e.reshape(-1, 6))
    # alltoall_v: uniform counts are the dense alltoall; padding is zeros
    _check(got["eager/alltoall_v_uniform"], got["eager/alltoall_uniform"])
    need = int(d["counts"].sum(axis=0).max())
    _check(got["eager/alltoall_v_padded"][:, :need], got["eager/alltoall_v"])
    assert not got["eager/alltoall_v_padded"][:, need:].any()


@pytest.fixture(scope="module")
def process_group():
    bt.init_process_group(device="cpu")


def test_alltoall_v_validation(process_group):
    x = torch.ones(3, 2)
    np.testing.assert_array_equal(bt.alltoall_v(x, [[3]], output_size=5).numpy(),
                                  np.concatenate([np.ones((3, 2)), np.zeros((2, 2))]))
    with pytest.raises(ValueError, match="output_size"):
        bt.alltoall_v(x, [[3]], output_size=1)
    with pytest.raises(ValueError, match=r"send_counts must be \[1, 1\]"):
        bt.alltoall_v(x, np.zeros((3, 3), np.int64))
    with pytest.raises(ValueError, match="non-negative"):
        bt.alltoall_v(x, [[-1]])
    with pytest.raises(ValueError, match="sends 4 rows"):
        bt.alltoall_v(x, [[4]])


def test_eager_calls_refuse_to_dispatch_after_abort(process_group):
    x = torch.ones(2, 3)
    calls = {"allreduce": lambda: bt.allreduce(x), "allreduce_inplace":
             lambda: bt.allreduce_inplace(x.clone()), "allgather": lambda: bt.allgather(x),
             "reduce_scatter": lambda: bt.reduce_scatter(x), "alltoall": lambda: bt.alltoall(x),
             "alltoall_v": lambda: bt.alltoall_v(x, [[2]]), "broadcast": lambda: bt.broadcast(x),
             "reduce": lambda: bt.reduce(x, 0), "gather": lambda: bt.gather(x, 0),
             "scatter": lambda: bt.scatter(x, 0), "send_recv": lambda: bt.send_recv(x, [(0, 0)]),
             "barrier": bt.barrier}
    bt.abort("test")
    try:
        for name, call in calls.items():
            with pytest.raises(bt.BaguaAborted, match="test"):
                call()
    finally:
        bt.reset_abort()
    for name, call in calls.items():
        call()   # dispatches again
    np.testing.assert_array_equal(bt.allreduce(x).numpy(), x.numpy())
