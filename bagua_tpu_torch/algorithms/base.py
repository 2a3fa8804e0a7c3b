"""Algorithm base class: the pluggable "what to communicate" contract.

Port of the core of ``bagua_tpu/algorithms/base.py``.  An algorithm picks the
tensors to communicate and their buckets (``init_tensors``,
``tensors_to_buckets``) and transforms the gradients between the backward
pass and the optimizer step (``process_grads``).  Dense families implement
``reduce_bucket_grad`` for one bucket's flat gradient and alias
``process_grads`` to ``process_grads_bucketed``, which runs it over every
bucket in plan order.  A family that owns its optimizer (QAdam) sets
``owns_optimizer`` and provides ``init_optimizer_state`` and
``optimizer_update``.  Gradients travel between the stages as a
``name -> tensor`` dict.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

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
    world_size: int = 1
    #: codec policy of the flat ring (``BAGUA_COMPRESS_INTRA`` values):
    #: ``auto`` defers to the algorithm family's own wire codec, ``off``
    #: forces full precision, a codec name forces that codec
    intra_codec: Optional[str] = None

    def bucket_flats(self, tensors: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """One flat buffer per bucket from tensors by name."""
        return self.plan.flatten(tensors)

    def from_bucket_flats(self, flats) -> Dict[str, torch.Tensor]:
        """Inverse of :meth:`bucket_flats`: views into the flats, by name."""
        return self.plan.unflatten(flats)

    def codec_for(self, family_default=None):
        """The flat ring's wire codec: the policy knob where it names a
        codec or forces ``off``, else the family's default (None = full
        precision)."""
        knob = self.intra_codec
        if knob in (None, "", "auto"):
            return family_default
        if knob == "off":
            return None
        return knob

    def flat_ring_codec(self):
        """The knob-forced codec of the flat (whole world) ring, or None when
        there is none or the world is a single rank (no ring, no wire: the
        codec is dropped, as on the JAX package's single-rank meshes)."""
        codec = self.codec_for(None)
        return codec if codec is not None and self.comm.nranks() > 1 else None

    def bucket_allreduce(self, flat: torch.Tensor, op: ReduceOp) -> torch.Tensor:
        """One bucket's allreduce over every rank: the ring with the forced
        flat codec where one resolves, else one fused allreduce
        (``base.py:325-350``).  The JAX package's two-tier hierarchical
        decomposition and the chunked ring of its overlap scheduler are not
        ported (a family that asks for the former raises at construction)."""
        codec = self.flat_ring_codec()
        if codec is not None:
            return self.comm.ring_allreduce(flat, op, codec=codec)
        return self.comm.allreduce(flat, op)


class Algorithm:
    """Base algorithm: plain data parallelism hooks; gradients unchanged."""

    #: True when the algorithm provides its own optimizer update (QAdam)
    owns_optimizer: bool = False
    #: True pads every bucket to a multiple of the world size (the
    #: compressed scatter-gather gives each rank an equal chunk)
    align_to_world: bool = False

    def need_reset(self, step: int) -> bool:
        """Host-side, at the top of every step (``step`` counts the
        trainer's steps from 0): True at a phase switch (QAdam's warmup
        boundary).  PyTorch runs eagerly, so there is nothing to rebuild;
        the algorithm flips its own phase."""
        return False

    def init_tensors(self, named_params: Sequence[NamedParam]) -> List[NamedParam]:
        """Which tensors to communicate, in registration order (the caller
        passes reversed module order)."""
        return list(named_params)

    def tensors_to_buckets(
        self,
        decl_buckets: Sequence[Sequence[TensorDeclaration]],
        named_params: Sequence[NamedParam],
        world_size: int,
    ) -> BucketPlan:
        """Declarations -> concrete plan."""
        return BucketPlan.from_declaration_buckets(
            decl_buckets, named_params, alignment=world_size if self.align_to_world else 1)

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

    def init_optimizer_state(self, params: Dict[str, torch.Tensor]):
        """Optimizer state of an ``owns_optimizer`` family."""
        raise NotImplementedError("only algorithms with owns_optimizer=True")

    def optimizer_update(self, ctx: AlgorithmContext, params, grads, opt_state,
                         algo_state, step):
        """The optimizer step of an ``owns_optimizer`` family: updates
        ``params`` (name -> parameter) in place; returns ``(params,
        opt_state, algo_state)``."""
        raise NotImplementedError("only algorithms with owns_optimizer=True")
