"""Tensor parallelism (Megatron) over a mesh axis.

Port of ``bagua_tpu/parallel/tensor_parallel.py`` (Shoeybi et al., arXiv
1909.08053).  The column-parallel products (the q/k/v projections, the MLP's
``wi_gate``/``wi_up``) hold ``heads / tp`` heads or ``d_ff / tp`` rows of
the output features and take the whole activation; the row-parallel products
(attention's ``o``, the MLP's ``wo``) hold the matching input columns, and
their partial outputs are summed over the axis once a block.  Two conjugate
autograd functions carry the sums, each over the axis's communicator
(:meth:`~bagua_tpu_torch.parallel.mesh.Mesh.comm`):

- :func:`tp_gather_grad` ("g"): the identity forward, an allreduce (sum) of
  the cotangent backward, placed before each column-parallel product, so
  that the gradients of what feeds it (norms, embeddings) come out whole;
- :func:`tp_reduce` ("f"): an allreduce (sum) forward, the identity
  backward, after each row-parallel product.

Each rank's module holds its LOCAL slices (contiguous blocks of heads or
rows); the trainer's ``tp_axis`` places them (``tp_param_dim``).  A model
built on every rank from one seed holds the same local slices everywhere:
:func:`globalize_tp_params` redraws each sharded leaf at its global shape
from one generator and keeps the rank's slice.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from ..communication import BaguaCommunicator, ReduceOp
from .mesh import require_axis


class _GatherGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # the cotangent may be shared with another branch: sum a copy
        return ctx.comm.allreduce(g.clone(memory_format=torch.contiguous_format),
                                  ReduceOp.SUM), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.allreduce(x.clone(memory_format=torch.contiguous_format), ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_gather_grad(x: torch.Tensor, comm: Optional[BaguaCommunicator]) -> torch.Tensor:
    """The identity forward, the sum of the cotangent over ``comm``'s ranks
    backward (Megatron's "g").  Place it right before a column-parallel
    product.  A ``comm`` of None (an axis of one rank) is the identity."""
    if comm is None or comm.nranks() == 1:
        return x
    return _GatherGrad.apply(x, comm)


def tp_reduce(x: torch.Tensor, comm: Optional[BaguaCommunicator]) -> torch.Tensor:
    """The sum of ``x`` over ``comm``'s ranks forward, the identity backward
    (Megatron's "f"), closing a row-parallel product.  An allreduce whose
    backward were an allreduce too would multiply the already replicated
    cotangent by the axis size at every block, and the error compounds
    through the network."""
    if comm is None or comm.nranks() == 1:
        return x
    return _Reduce.apply(x, comm)


#: flax's truncated normal divides by the stddev of the [-2, 2]-truncated
#: unit normal, so that the DRAWN stddev is the target
_TRUNC_STD = 0.87962566103423978


def redraw_lecun(shape, contracting, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One lecun-normal draw at ``shape`` (a truncated normal whose stddev
    is ``1 / sqrt(fan_in)``, the fan-in the product of the ``contracting``
    dims), on ``generator``'s device; shared by the tp and pp redraws."""
    fan_in = math.prod(shape[a] for a in contracting)
    out = torch.empty(tuple(shape), dtype=torch.float32, device=generator.device)
    nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (out * ((1.0 / max(fan_in, 1)) ** 0.5 / _TRUNC_STD)).to(dtype)


def tp_slice(t: torch.Tensor, dim: int, tp_size: int, tp_rank: int) -> torch.Tensor:
    """Rank ``tp_rank``'s contiguous block of ``tp_size`` along ``dim``."""
    n = t.shape[dim] // tp_size
    return t.narrow(dim, tp_rank * n, n)


def axis_rank(axis: str, size: int, what: str) -> int:
    """This rank's coordinate on ``axis`` of the global mesh (0 for an axis
    of one rank, which needs no mesh)."""
    return 0 if size == 1 else require_axis(axis, size, what).coords[axis]


def globalize_tp_params(model: nn.Module, generator: torch.Generator, tp_size: int,
                        tp_param_dim: Optional[Callable[[str], Optional[int]]] = None,
                        fan_in_dims: Optional[Callable] = None,
                        tp_rank: Optional[int] = None) -> nn.Module:
    """Re-draw every tensor-parallel leaf of ``model`` at its GLOBAL shape,
    in place (``tensor_parallel.py:97-132``): the sharded dim
    (``tp_param_dim(name)``, default the transformer's table) times
    ``tp_size``, lecun-normal over the GLOBAL fan-in (``fan_in_dims(name)``,
    the global weight's contracting dims, default the transformer's table),
    from ``generator``, which must be seeded alike on every rank; each rank
    keeps its slice (``tp_rank``, default its coordinate on the model's
    ``cfg.tp_axis`` of the global mesh).  Returns ``model``."""
    from ..models.transformer import tp_param_dim as default_dim
    from ..models.transformer import tp_param_fan_in_dims

    tp_param_dim = tp_param_dim or default_dim
    fan_in_dims = fan_in_dims or tp_param_fan_in_dims
    if tp_size == 1:
        return model
    if tp_rank is None:
        tp_rank = axis_rank(model.cfg.tp_axis, tp_size, "globalize_tp_params")
    with torch.no_grad():
        for name, p in model.named_parameters():
            dim = tp_param_dim(name)
            if dim is None:
                continue
            shape = list(p.shape)
            shape[dim] *= tp_size
            contracting = fan_in_dims(name) or (len(shape) - 1,)
            full = redraw_lecun(shape, contracting, generator, p.dtype)
            p.copy_(tp_slice(full, dim, tp_size, tp_rank))
    return model
