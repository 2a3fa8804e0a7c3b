"""Centralized synchronous full-precision data parallelism.

Port of ``bagua_tpu/algorithms/gradient_allreduce.py``: one allreduce per
bucket, averaged (or summed) over the ranks, through
``AlgorithmContext.bucket_allreduce``: the two-level form with
``hierarchical=True`` where the tiers allow it (a codec forced with
``compress_inter`` rides its inter-node ring), the compressed flat ring with
a codec forced by ``compress_intra``, chunked into sub-rings where the
overlap scheduler sets a chunk target.  A stateful codec (``onebit_ef``,
``topk``) carries the error-feedback residual.  The per-bucket allreduce is
the overlap contract: under the scheduler it runs from the backward.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..communication import ReduceOp
from .base import Algorithm, AlgorithmContext


class GradientAllReduceAlgorithm(Algorithm):
    name = "gradient_allreduce"
    #: the per-bucket reduction carries the residual of a stateful codec
    supports_ef_state = True
    supports_flat_resident = True
    supports_overlap = True
    #: ``auto`` overlaps (with accumulation or a chunk target), as measured
    #: in the JAX package's record
    overlap_auto = True
    #: the reduced buckets are the same on every rank: the guard's verdict
    #: rides them with no collective of its own
    grad_health_replicated = True

    def __init__(
        self,
        hierarchical: bool = False,
        average: bool = True,
        comm_dtype: Optional[torch.dtype] = None,
    ):
        """
        Args:
            hierarchical: intra-node then inter-node communication (the
                two-level allreduce); on a world whose tiers do not allow it,
                the flat path.
            average: If True average gradients over ranks, else sum.
            comm_dtype: Optional on-the-wire dtype for the allreduce (e.g.
                ``torch.bfloat16`` halves the bytes); gradients are cast
                back afterwards, so params and optimizer state stay in full
                precision.
        """
        self.hierarchical = hierarchical
        self.average = average
        self.comm_dtype = comm_dtype

    def reduce_bucket_grad(self, ctx: AlgorithmContext, index: int, flat):
        op = ReduceOp.AVG if self.average else ReduceOp.SUM
        if self.comm_dtype is None:
            return ctx.bucket_allreduce(flat, op, self.hierarchical)
        orig = flat.dtype
        return ctx.bucket_allreduce(flat.to(self.comm_dtype), op, self.hierarchical).to(orig)

    process_grads = Algorithm.process_grads_bucketed
