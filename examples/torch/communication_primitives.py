"""Cross-check every eager communication primitive of the port against numpy.

Counterpart of ``examples/communication_primitives.py`` (the reference
Bagua's ``examples/communication_primitives/main.py``, which checks each
primitive against ``torch.distributed``).  The oracle is explicit numpy math
over the rank axis: every rank draws the same ``[world, ...]`` arrays from
seed 0, sends its own row and checks its own result.  Same coverage:
send/recv, broadcast, allreduce (+inplace), reduce, allgather, gather,
scatter, reduce_scatter, alltoall, alltoall_v, barrier.

    bagua-tpu-torch-run --nproc_per_node 2 examples/torch/communication_primitives.py
    bagua-tpu-torch-run --nproc_per_node 4 examples/torch/communication_primitives.py --device cpu

On the card the ranks use NCCL, one card a rank, unless ``--backend gloo``
(several ranks on one card, through host memory).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import bagua_tpu_torch as bt  # noqa: E402
from bagua_tpu_torch import ReduceOp  # noqa: E402
from bagua_tpu_torch.device import resolve_device  # noqa: E402


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None,
                    help="nccl (the card's default) or gloo (the CPU's; several ranks on "
                         "one card)")
    return ap


def run(args, params=None) -> dict:
    """Every primitive once on this rank; raises on the first mismatch.
    ``params`` is unused (the signature every example shares)."""
    device = resolve_device(args.device)
    bt.init_process_group(device=device, backend=args.backend)
    comm = bt.get_backend().global_communicator
    n, r = comm.nranks(), comm.rank()
    assert n >= 2, "world size must be at least 2 (bagua-tpu-torch-run --nproc_per_node 2)"
    rng = np.random.default_rng(0)

    def rand(*shape):
        return rng.normal(size=shape).astype(np.float32)

    def mine(x):     # a copy: the in-place calls must not write into x
        return torch.tensor(x[r], device=device)

    def host(t):
        return t.cpu().numpy()

    checked = []
    # send/recv (rank 0 -> rank 1, as a permutation)
    x = rand(n, 4)
    out = host(bt.send_recv(mine(x), [(0, 1), (1, 0)] + [(k, k) for k in range(2, n)],
                            comm=comm))
    np.testing.assert_allclose(out, x[{0: 1, 1: 0}.get(r, r)], err_msg="send/recv")
    checked.append("send_recv")

    x = rand(n, 4)
    np.testing.assert_allclose(host(bt.broadcast(mine(x), 0, comm=comm)), x[0],
                               err_msg="broadcast")
    checked.append("broadcast")

    x = rand(n, 4)
    out = host(bt.allreduce(mine(x), ReduceOp.SUM, comm=comm))
    out_inplace = host(bt.allreduce_inplace(mine(x), ReduceOp.SUM, comm=comm))
    np.testing.assert_allclose(out, x.sum(0), rtol=1e-5, err_msg="allreduce")
    np.testing.assert_allclose(out, out_inplace, err_msg="allreduce_inplace")
    checked += ["allreduce", "allreduce_inplace"]

    # reduce: only dst holds the result; the others get recv back
    x, recv = rand(n, 4), rand(n, 4)
    out = host(bt.reduce(mine(x), 1, ReduceOp.SUM, comm=comm, recv=mine(recv)))
    np.testing.assert_allclose(out, x.sum(0) if r == 1 else recv[r], rtol=1e-5,
                               err_msg="reduce")
    checked.append("reduce")

    x = rand(n, 3)
    out = host(bt.allgather(mine(x), comm=comm))
    np.testing.assert_allclose(out.reshape(n, 3), x, err_msg="allgather")
    checked.append("allgather")

    # gather: dst holds everyone's row; the others zeros
    out = host(bt.gather(mine(x), 0, comm=comm))
    np.testing.assert_allclose(out.reshape(n, 3) if r == 0 else out,
                               x if r == 0 else np.zeros_like(out), err_msg="gather")
    checked.append("gather")

    # scatter: rank k gets chunk k of src's buffer
    x = rand(n, n * 2)
    np.testing.assert_allclose(host(bt.scatter(mine(x), 0, comm=comm)),
                               x[0].reshape(n, 2)[r], err_msg="scatter")
    checked.append("scatter")

    x = rand(n, n * 2)
    np.testing.assert_allclose(host(bt.reduce_scatter(mine(x), ReduceOp.SUM, comm=comm)),
                               x.sum(0).reshape(n, 2)[r], rtol=1e-5, err_msg="reduce_scatter")
    checked.append("reduce_scatter")

    x = rand(n, n * 2)
    np.testing.assert_allclose(host(bt.alltoall(mine(x), comm=comm)).reshape(n, 2),
                               x[:, r * 2:(r + 1) * 2], err_msg="alltoall")
    checked.append("alltoall")

    # alltoall_v (ragged)
    counts = rng.integers(0, 3, (n, n))
    width = int(counts.sum(1).max())
    send = np.zeros((n, max(1, width)), np.float32)
    for k in range(n):
        send[k, :counts[k].sum()] = rng.normal(size=counts[k].sum())
    out = host(bt.alltoall_v(mine(send), counts, comm=comm))
    in_off = np.concatenate([np.zeros((n, 1), np.int64), np.cumsum(counts, 1)[:, :-1]], 1)
    pos = 0
    for s in range(n):
        c = counts[s][r]
        np.testing.assert_allclose(out[pos:pos + c], send[s, in_off[s][r]:in_off[s][r] + c],
                                   err_msg="alltoall_v")
        pos += c
    checked.append("alltoall_v")

    bt.barrier(comm=comm)
    checked.append("barrier")
    print(f"communication primitives OK (world={n})", flush=True)
    return {"world": n, "rank": r, "checked": checked}


def main(argv=None):
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
