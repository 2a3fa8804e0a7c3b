"""One rank of the checks of the chunked rings, the overlap scheduler's issue
order and the eager collective API (tests/test_torch_overlap.py,
tests/test_torch_compressed_ring.py, tests/test_torch_eager.py).

    python torch_overlap_worker.py RANK WORLD INIT_METHOD IN_NPZ OUT_NPZ

Rank r takes row r of the arrays of ``IN_NPZ`` (``x`` and ``c`` ``[world,
64]``, ``odd`` ``[world, 50]``, ``e`` ``[world, 4 world, 6]`` and the
receive buffers ``recv`` and ``grecv``, ``v`` ``[world, L, 3]``) and the whole
``counts`` matrix, runs every case of :func:`cases` over gloo and writes each
result to ``OUT_NPZ`` under its name.  ``order/*`` is the overlap
scheduler's issue order when this rank's hooks fire in an order of its own.
Imports only torch, numpy and the port.
"""

import sys

import numpy as np
import torch

import bagua_tpu_torch as bt
from bagua_tpu_torch.algorithms import AlgorithmContext
from bagua_tpu_torch.bucket import BucketPlan
from bagua_tpu_torch.communication import ReduceOp
from bagua_tpu_torch.core.overlap import CommWorker, OverlapStep
from bagua_tpu_torch.tensor import NamedParam

CHUNKS = (1, 2, 4)
CODECS = ("minmax_uint8", "int8", "fp8_e4m3", "fp8_e5m2", "onebit_ef", "topk")
#: the scheduler's launch orders of the issue-order case: the plan's, and one
#: of its own (as ``bucket_launch_order`` gives on two tiers)
LAUNCH_ORDERS = {"plan": [0, 1, 2, 3, 4, 5], "custom": [5, 3, 1, 0, 2, 4]}


def ring_cases(comm, d):
    out = {}
    for k in CHUNKS:
        for op in (ReduceOp.SUM, ReduceOp.AVG):
            out[f"ring/allreduce/{op.name}/{k}"] = comm.ring_allreduce(d["x"], op, num_chunks=k)
        out[f"ring/reduce_scatter/{k}"] = comm.ring_reduce_scatter(d["x"], ReduceOp.AVG,
                                                                   num_chunks=k)
        out[f"ring/allgather/{k}"] = comm.ring_allgather(d["x"][:8], num_chunks=k)
    for op in (ReduceOp.SUM, ReduceOp.AVG):
        out[f"fused/allreduce/{op.name}"] = comm.allreduce(d["x"].clone(), op)
    out["fused/reduce_scatter"] = comm.reduce_scatter(d["x"], ReduceOp.AVG)
    out["fused/allgather"] = comm.allgather(d["x"][:8])
    out["ring/pair"] = comm.ring_allgather(comm.ring_reduce_scatter(d["x"], ReduceOp.AVG, 4), 4)
    for k in (1, 2):
        out[f"ring/pad/{k}"] = comm.ring_allreduce(d["odd"], ReduceOp.AVG, num_chunks=k)
    out["fused/pad"] = comm.allreduce(d["odd"].clone(), ReduceOp.AVG)
    for name in CODECS:
        for k in (1, 4):
            out[f"codec/{name}/{k}"] = comm.ring_allreduce(d["c"], ReduceOp.AVG, num_chunks=k,
                                                           codec=name)
    for name in ("minmax_uint8", "int8"):
        out[f"codec_pair/{name}"] = comm.ring_allgather(
            comm.ring_reduce_scatter(d["c"], ReduceOp.SUM, codec=name), codec=name)
    # ZeRO's scatter/gather pair under a forced flat codec, and chunked
    for key, kw in (("forced", {"intra_codec": "int8"}),
                    ("chunked", {"overlap": True, "overlap_chunk_bytes": 64})):
        ctx = AlgorithmContext(comm=comm, plan=None, world_size=comm.nranks(), **kw)
        chunk = ctx.bucket_reduce_scatter(d["c"], ReduceOp.AVG)
        out[f"bucket/{key}/rs"] = chunk
        out[f"bucket/{key}/ag"] = ctx.bucket_allgather(chunk)
        out[f"bucket/{key}/allreduce"] = ctx.bucket_allreduce(d["c"].clone(), ReduceOp.AVG)
    return out


def eager_cases(comm, d, counts):
    world = comm.nranks()
    e = d["e"]
    inplace = e.clone()
    out = {"eager/allreduce_inplace": bt.allreduce_inplace(inplace, ReduceOp.SUM)}
    out["eager/allreduce_inplace_same"] = torch.tensor(out["eager/allreduce_inplace"] is inplace)
    for op in (ReduceOp.AVG, ReduceOp.SUM, ReduceOp.MAX, ReduceOp.MIN):
        out[f"eager/allreduce/{op.name}"] = bt.allreduce(e, op)
    out["eager/allgather"] = bt.allgather(e)
    out["eager/reduce_scatter"] = bt.reduce_scatter(e, ReduceOp.SUM)
    out["eager/alltoall"] = bt.alltoall(e)
    out["eager/broadcast"] = bt.broadcast(e, src=world - 1)
    out["eager/reduce"] = bt.reduce(e, dst=1, op=ReduceOp.SUM)
    out["eager/reduce_recv"] = bt.reduce(e, dst=1, op=ReduceOp.SUM, recv=d["recv"])
    out["eager/gather"] = bt.gather(e, dst=world - 1)
    out["eager/gather_recv"] = bt.gather(e, dst=world - 1, recv=d["grecv"])
    out["eager/scatter"] = bt.scatter(e, 1)
    out["eager/send_recv"] = bt.send_recv(e, [(r, (r + 1) % world) for r in range(world)])
    out["eager/alltoall_v"] = bt.alltoall_v(d["v"], counts)
    out["eager/alltoall_v_padded"] = bt.alltoall_v(d["v"], counts, output_size=int(
        counts.sum(axis=0).max()) + 3)
    uniform = np.full((world, world), 2)
    out["eager/alltoall_v_uniform"] = bt.alltoall_v(e[:2 * world], uniform)
    out["eager/alltoall_uniform"] = bt.alltoall(e[:2 * world])
    bt.barrier()
    return out


def order_cases(comm, rank):
    """The scheduler over six one-tensor buckets, this rank's hooks firing in
    a permutation of its own: the buckets the worker issued, in order, and
    each bucket's sum over the ranks."""
    named = [NamedParam(f"t{i}", (3,), torch.float32) for i in range(6)]
    plan = BucketPlan.from_declaration_buckets([[p.declaration()] for p in named], named)
    out = {}
    worker = CommWorker(torch.device("cpu"))
    try:
        for key, order in LAUNCH_ORDERS.items():
            flats = [torch.full((3,), float(10 * i + rank)) for i in range(6)]
            step = OverlapStep(worker, plan, order, lambda i: flats[i],
                               lambda i, f: comm.allreduce(f, ReduceOp.SUM))
            for i in np.random.default_rng(100 + rank).permutation(6):
                step.on_grad(f"t{i}")
            reduced = step.wait()
            out[f"order/{key}/issued"] = torch.tensor(step.issued)
            out[f"order/{key}/reduced"] = torch.stack(reduced)
    finally:
        worker.close()
    return out


def main(rank, world, init_method, in_path, out_path):
    torch.set_num_threads(1)
    bt.init_process_group(init_method, world_size=world, rank=rank, device="cpu")
    comm = bt.get_backend().global_communicator
    data = np.load(in_path)
    d = {k: torch.from_numpy(v[rank]) for k, v in data.items() if k != "counts"}
    out = {**ring_cases(comm, d), **eager_cases(comm, d, data["counts"]),
           **order_cases(comm, rank)}
    np.savez(out_path, **{k: v.numpy() for k, v in out.items()})
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    r, w, init, inp, out = sys.argv[1:]
    main(int(r), int(w), init, inp, out)
