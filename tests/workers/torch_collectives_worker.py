"""One rank of the communicator checks against the JAX package
(tests/test_torch_communication.py).

    python torch_collectives_worker.py RANK WORLD INIT_METHOD IN_NPZ OUT_NPZ

Rank r takes row r of every array in ``IN_NPZ`` and runs every case of
``cases`` on it over gloo: ``allreduce`` with each ``ReduceOp`` (the bitwise
ones on int32 and bool, and once more through the gather that NCCL groups
take), ``allgather``, ``reduce_scatter`` and ``alltoall`` along several
axes, ``ppermute`` with fixed points, and the barriers.  Writes each result
to ``OUT_NPZ`` under the case's name, with the communicator's
``host_staged_bytes``.  Imports only torch, numpy and the port.
"""

import sys
from unittest import mock

import numpy as np
import torch

import bagua_tpu_torch as bt
from bagua_tpu_torch import communication
from bagua_tpu_torch.communication import ReduceOp

#: (ReduceOp, input array) of the allreduce cases
ALLREDUCE = [(ReduceOp.SUM, "x"), (ReduceOp.AVG, "x"), (ReduceOp.MIN, "x"),
             (ReduceOp.MAX, "x"), (ReduceOp.PRODUCT, "p"),
             (ReduceOp.BOR, "i"), (ReduceOp.BAND, "i"), (ReduceOp.BXOR, "i"),
             (ReduceOp.BOR, "b"), (ReduceOp.BAND, "b"), (ReduceOp.BXOR, "b")]
AXES = (0, 1, -1)
#: (split_axis, concat_axis) of the alltoall cases on a [world, world, world]
#: block
ALLTOALL = [(0, 0), (1, 0), (0, 1), (-1, -1), (1, -1), (-1, 0)]


def ppermutes(world):
    """name -> perm: fixed points alone, beside a swap, and a partial one."""
    swap = [(0, 1), (1, 0)]
    return {"fixed": [(r, r) for r in range(world)],
            "swap_fixed": swap + [(r, r) for r in range(2, world)],
            "fixed_partial": [(0, 0)] + ([(1, 2), (2, 1)] if world > 2 else []),
            "shift_fixed": [(0, 0)] + [(r, r % (world - 1) + 1) for r in range(1, world)]}


def cases(comm, d, world):
    """name -> result of this rank for every case."""
    out = {}
    for op, key in ALLREDUCE:
        out[f"allreduce/{op.name}/{key}"] = comm.allreduce(d[key].clone(), op)
        if op in communication._BITWISE_OPS:
            # an NCCL group's form: gather, then fold locally
            with mock.patch.object(communication.dist, "get_backend", return_value="nccl"):
                out[f"allreduce_gathered/{op.name}/{key}"] = comm.allreduce(d[key].clone(), op)
    for axis in AXES:
        for tiled in (True, False):
            out[f"allgather/{axis}/{tiled}"] = comm.allgather(d["x"], axis=axis, tiled=tiled)
        for op in (ReduceOp.SUM, ReduceOp.AVG):
            out[f"reduce_scatter/{axis}/{op.name}"] = comm.reduce_scatter(d["x"], op, axis=axis)
    for split, concat in ALLTOALL:
        out[f"alltoall/{split}/{concat}"] = comm.alltoall(d["t"], split, concat)
    for name, perm in ppermutes(world).items():
        out[f"ppermute/{name}"] = comm.ppermute(d["x"], perm)
    comm.barrier()
    bt.barrier()
    return out


def main(rank, world, init_method, in_path, out_path):
    torch.set_num_threads(1)
    bt.init_process_group(init_method, world_size=world, rank=rank, device="cpu")
    comm = bt.get_backend().global_communicator
    data = {k: torch.from_numpy(v[rank]) for k, v in np.load(in_path).items()}
    out = {k: v.numpy() for k, v in cases(comm, data, world).items()}
    np.savez(out_path, host_staged_bytes=comm.host_staged_bytes, **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    r, w, init, inp, out = sys.argv[1:]
    main(int(r), int(w), init, inp, out)
