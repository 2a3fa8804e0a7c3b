"""Differentiable collectives over a mesh axis.

What ``lax``'s transposes give the JAX package's autodiff, as
``torch.autograd.Function``\\ s: each forward is one collective of a
:class:`~bagua_tpu_torch.communication.BaguaCommunicator` (so a CUDA tensor
on a gloo group keeps its pinned host staging and its byte count), and each
backward is the collective that moves the cotangent back the way the values
came:

- :func:`all_to_all` (``lax.all_to_all``): the inverse all-to-all;
- :func:`ppermute` (``lax.ppermute``): the inverse permutation;
- :func:`alltoall_v`, the exact-count transfer (``lax.ragged_all_to_all``
  with packed rows): the reverse transfer with the counts swapped;
- :func:`pmean` (``lax.pmean``): the mean of the cotangents over the ranks.

Every rank of the group runs the same collectives in the same order, in the
forward and again, reversed, in the backward; each axis has a process group
of its own (:class:`~bagua_tpu_torch.parallel.mesh.Mesh`), so they do not
interleave with the trainer's bucket collectives.  A ``comm`` of None (an
axis of size 1) makes :func:`all_to_all`, :func:`ppermute` and :func:`pmean`
the identity.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..communication import BaguaCommunicator, ReduceOp, _axis


def _all_to_all(x, comm: BaguaCommunicator, split_axis: int, concat_axis: int, tiled: bool):
    if not tiled:
        return comm.alltoall(x, split_axis, concat_axis)
    n = comm.nranks()
    s, c = _axis(split_axis, x.dim()), _axis(concat_axis, x.dim())
    if x.shape[s] % n:
        raise ValueError(f"all_to_all: dim {s} of {tuple(x.shape)} does not split over {n} ranks")
    # block j along the split axis goes to rank j; the blocks received, in
    # rank order, are concatenated along the concat axis
    blocks = x.unflatten(s, (n, x.shape[s] // n)).movedim(s, 0)
    return comm.alltoall(blocks, 0, 0).movedim(0, c).flatten(c, c + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, split_axis, concat_axis, tiled):
        ctx.args = (comm, split_axis, concat_axis, tiled)
        return _all_to_all(x, comm, split_axis, concat_axis, tiled)

    @staticmethod
    def backward(ctx, g):
        comm, split_axis, concat_axis, tiled = ctx.args
        return _all_to_all(g.contiguous(), comm, concat_axis, split_axis, tiled), None, None, \
            None, None


def all_to_all(x: torch.Tensor, comm: Optional[BaguaCommunicator], split_axis: int,
               concat_axis: int, tiled: bool = False) -> torch.Tensor:
    """``lax.all_to_all`` over ``comm``'s ranks.  ``tiled``: ``x`` is cut
    into ``n`` equal blocks along ``split_axis``, block j goes to rank j, and
    the blocks received are concatenated along ``concat_axis`` in rank order.
    Not tiled: ``x.shape[split_axis]`` is ``n``, and the blocks received make
    that axis at ``concat_axis`` of the result."""
    if comm is None or comm.nranks() == 1:
        return x
    return _AllToAll.apply(x, comm, split_axis, concat_axis, tiled)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, perm):
        ctx.comm, ctx.perm = comm, perm
        return comm.ppermute(x, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return ctx.comm.ppermute(g.contiguous(), inverse), None, None


def ppermute(x: torch.Tensor, comm: Optional[BaguaCommunicator],
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute`` over ``comm``'s ranks: ``perm`` pairs ``(src,
    dst)``; this rank gets what its ``src`` sent, zeros if none."""
    if comm is None or comm.nranks() == 1:
        return x
    return _PPermute.apply(x, comm, [(int(s), int(d)) for s, d in perm])


class _AllToAllV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, send, recv):
        ctx.args = (comm, send, recv)
        return comm.alltoall_packed(x, send, recv)

    @staticmethod
    def backward(ctx, g):
        comm, send, recv = ctx.args
        return comm.alltoall_packed(g.contiguous(), recv, send), None, None, None


def alltoall_v(x: torch.Tensor, comm: BaguaCommunicator, send_counts: Sequence[int],
               recv_counts: Sequence[int]) -> torch.Tensor:
    """Exact-count all-to-all: ``x`` holds this rank's outgoing rows packed
    by destination (``send_counts[i]`` rows for rank i, rank 0's first); the
    result holds the ``recv_counts[j]`` rows from each rank j, packed in
    source order.  The counts are host integers (gloo sizes its transfer
    from them), and ``recv_counts`` must be what the peers send."""
    send, recv = [int(v) for v in send_counts], [int(v) for v in recv_counts]
    if len(send) != comm.nranks() or len(recv) != comm.nranks():
        raise ValueError(f"alltoall_v needs {comm.nranks()} counts each way, got {send} "
                         f"and {recv}")
    if x.shape[0] < sum(send):
        raise ValueError(f"alltoall_v sends {sum(send)} rows of a {x.shape[0]}-row tensor")
    return _AllToAllV.apply(x, comm, send, recv)


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.allreduce(x.clone(), ReduceOp.AVG)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.allreduce(g.clone(), ReduceOp.AVG), None


def pmean(x: torch.Tensor, comm: Optional[BaguaCommunicator]) -> torch.Tensor:
    """``lax.pmean`` over ``comm``'s ranks: the mean of every rank's ``x``,
    the same tensor on every rank.  Its backward is the mean of the ranks'
    cotangents, ``pmean``'s transpose: summed over the ranks, the gradients
    of each rank's loss through it are those of the sum of the losses."""
    if comm is None or comm.nranks() == 1:
        return x
    return _PMean.apply(x, comm)
