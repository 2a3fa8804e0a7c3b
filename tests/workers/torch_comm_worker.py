"""One rank of the port's collective checks (tests/test_torch_compressed.py,
tests/test_torch_hierarchical.py).

    python torch_comm_worker.py RANK WORLD INIT_METHOD IN_NPZ OUT_NPZ

Rank r takes row r of every array in ``IN_NPZ`` (``xs`` ``[world, size]``
f32, ``xs_odd`` ``[world, size_odd]`` f32), runs each collective of ``OPS``
on it over gloo and writes the results to ``OUT_NPZ`` under the op's name.
The ``tier_*`` ops run the two-level allreduce over the tiers, whose size is
``LOCAL_WORLD_SIZE`` (else the world).  Imports only torch, numpy and the
port.
"""

import sys

import numpy as np
import torch

import bagua_tpu_torch as bt
from bagua_tpu_torch.algorithms import AlgorithmContext
from bagua_tpu_torch.communication import ReduceOp
from bagua_tpu_torch.compression import compressed_scatter_gather_allreduce


def _ctx(comm, **kw):
    return AlgorithmContext(comm=comm, plan=None, world_size=comm.nranks(), **kw)


def _tier_ctx(comm, **kw):
    backend = bt.get_backend()
    return _ctx(comm, intranode=backend.intranode_communicator,
                internode=backend.internode_communicator, **kw)


OPS = {
    "sg_avg": lambda c, x, y: compressed_scatter_gather_allreduce(c, x, average=True),
    "sg_sum": lambda c, x, y: compressed_scatter_gather_allreduce(c, x, average=False),
    "ring_int8": lambda c, x, y: c.ring_allreduce(x, ReduceOp.AVG, codec="int8"),
    "ring_fp8_e4m3": lambda c, x, y: c.ring_allreduce(x, ReduceOp.AVG, codec="fp8_e4m3"),
    "ring_fp8_e5m2": lambda c, x, y: c.ring_allreduce(x, ReduceOp.AVG, codec="fp8_e5m2"),
    "ring_minmax_uint8_sum": lambda c, x, y: c.ring_allreduce(x, ReduceOp.SUM,
                                                              codec="minmax_uint8"),
    "ring_int8_odd": lambda c, x, y: c.ring_allreduce(y, ReduceOp.AVG, codec="int8"),
    "ring_sum_odd": lambda c, x, y: c.ring_allreduce(y, ReduceOp.SUM),
    "ring_rs": lambda c, x, y: c.ring_reduce_scatter(x, ReduceOp.SUM),
    "ring_ag": lambda c, x, y: c.ring_allgather(x[:8]),
    "ring_rs_int8": lambda c, x, y: c.ring_reduce_scatter(x, ReduceOp.AVG, codec="int8"),
    "ring_ag_int8": lambda c, x, y: c.ring_allgather(x[:16], codec="int8"),
    "allgather": lambda c, x, y: c.allgather(x[:4], tiled=False),
    "reduce_scatter_avg": lambda c, x, y: c.reduce_scatter(x, ReduceOp.AVG),
    "alltoall": lambda c, x, y: c.alltoall(x.reshape(c.nranks(), -1)),
    "ppermute_shift": lambda c, x, y: c.ppermute(x[:4], [(i, (i + 1) % c.nranks())
                                                         for i in range(c.nranks())]),
    "ppermute_partial": lambda c, x, y: c.ppermute(x[:4], [(0, 1)]),
    # the bucket allreduce: the fused allreduce by default and with
    # compress_intra "off", the compressed ring with a forced codec
    "ctx_default": lambda c, x, y: _ctx(c).bucket_allreduce(x.clone(), ReduceOp.AVG),
    "ctx_off": lambda c, x, y: _ctx(c, intra_codec="off").bucket_allreduce(
        y.clone(), ReduceOp.SUM),
    "ctx_forced_int8": lambda c, x, y: _ctx(c, intra_codec="int8").bucket_allreduce(
        x.clone(), ReduceOp.AVG),
    # the two-level allreduce: full precision (an odd length, padded to the
    # intra-node tier), and the inter-node ring with a codec
    "tier_avg_odd": lambda c, x, y: _tier_ctx(c).bucket_allreduce(
        y.clone(), ReduceOp.AVG, hierarchical=True),
    "tier_sum": lambda c, x, y: _tier_ctx(c).bucket_allreduce(
        x.clone(), ReduceOp.SUM, hierarchical=True),
    "tier_int8": lambda c, x, y: _tier_ctx(c, inter_codec="int8").bucket_allreduce(
        x.clone(), ReduceOp.AVG, hierarchical=True),
    "tier_onebit": lambda c, x, y: _tier_ctx(c, inter_codec="onebit_ef").bucket_allreduce(
        x.clone(), ReduceOp.AVG, hierarchical=True),
    "tier_rs_int8": lambda c, x, y: _tier_ctx(
        c, intra_codec="int8").tier_reduce_scatter(x.clone(), ReduceOp.SUM),
    "tier_ranks": lambda c, x, y: torch.tensor(
        [bt.get_backend().intranode_communicator.rank(),
         bt.get_backend().internode_communicator.rank()]),
}


def main(rank, world, init_method, in_path, out_path):
    torch.set_num_threads(1)
    bt.init_process_group(init_method, world_size=world, rank=rank, device="cpu")
    comm = bt.get_backend().global_communicator
    data = np.load(in_path)
    x = torch.from_numpy(data["xs"][rank])
    y = torch.from_numpy(data["xs_odd"][rank])
    out = {name: op(comm, x, y).numpy() for name, op in OPS.items()}
    np.savez(out_path, host_staged_bytes=comm.host_staged_bytes, **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    r, w, init, inp, out = sys.argv[1:]
    main(int(r), int(w), init, inp, out)
