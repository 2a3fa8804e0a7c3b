"""Algorithm base class: the pluggable "what to communicate" contract.

Port of the core of ``bagua_tpu/algorithms/base.py``.  An algorithm picks the
tensors to communicate and their buckets (``init_tensors``,
``tensors_to_buckets``) and transforms the gradients between the backward
pass and the optimizer step (``process_grads``).  Dense families implement
``reduce_bucket_grad`` for one bucket's flat gradient and alias
``process_grads`` to ``process_grads_bucketed``, which runs it over every
bucket in plan order.  Gradients travel between the stages as a
``name -> tensor`` dict.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence

import torch

from ..bucket import BucketPlan
from ..communication import BaguaCommunicator, ReduceOp
from ..define import TensorDeclaration
from ..tensor import NamedParam


@dataclass
class AlgorithmContext:
    """Per-trainer context handed to the algorithm stages."""

    comm: BaguaCommunicator
    plan: BucketPlan

    def bucket_flats(self, tensors: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """One flat buffer per bucket from tensors by name."""
        return self.plan.flatten(tensors)

    def from_bucket_flats(self, flats) -> Dict[str, torch.Tensor]:
        """Inverse of :meth:`bucket_flats`: views into the flats, by name."""
        return self.plan.unflatten(flats)

    def bucket_allreduce(self, flat: torch.Tensor, op: ReduceOp) -> torch.Tensor:
        """One bucket's allreduce over every rank (the flat path; the
        hierarchical one is not ported yet)."""
        return self.comm.allreduce(flat, op)


class Algorithm:
    """Base algorithm: plain data parallelism hooks; gradients unchanged."""

    def init_tensors(self, named_params: Sequence[NamedParam]) -> List[NamedParam]:
        """Which tensors to communicate, in registration order (the caller
        passes reversed module order)."""
        return list(named_params)

    def tensors_to_buckets(
        self,
        decl_buckets: Sequence[Sequence[TensorDeclaration]],
        named_params: Sequence[NamedParam],
    ) -> BucketPlan:
        """Declarations -> concrete plan."""
        return BucketPlan.from_declaration_buckets(decl_buckets, named_params)

    def init_state(self, ctx: AlgorithmContext, params) -> Any:
        """Algorithm state (peer replicas, momenta, ...); none by default."""
        return None

    def process_grads(self, ctx: AlgorithmContext, grads, params, algo_state, step):
        """Gradient communication stage, after the full backward."""
        return grads, algo_state

    def reduce_bucket_grad(self, ctx: AlgorithmContext, index: int,
                           flat: torch.Tensor) -> torch.Tensor:
        """Communicate one bucket's flat gradient; returns the reduced flat."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement reduce_bucket_grad")

    def process_grads_bucketed(self, ctx: AlgorithmContext, grads, params,
                               algo_state, step):
        """Flatten the gradients per bucket, reduce each bucket with
        :meth:`reduce_bucket_grad` in plan order, and hand back views into
        the reduced flats by name."""
        flats = ctx.bucket_flats(grads)
        reduced = [self.reduce_bucket_grad(ctx, i, f) for i, f in enumerate(flats)]
        return ctx.from_bucket_flats(reduced), algo_state
