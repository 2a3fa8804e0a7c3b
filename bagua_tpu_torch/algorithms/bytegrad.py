"""ByteGrad: 8-bit compressed gradient allreduce.

Port of ``bagua_tpu/algorithms/bytegrad.py``: buckets aligned to the world
size, and per bucket the compressed scatter-gather of
:func:`~bagua_tpu_torch.compression.minmax_uint8.compressed_scatter_gather_allreduce`
(MinMaxUInt8, kernels K1 and K2) at world size > 1.  A single rank has no
wire: the flat is returned untouched and no codec runs.  The hierarchical
two-tier form (full-precision in-node reduce, compressed cross-node ring)
is not ported yet.
"""

from __future__ import annotations

from ..communication import ReduceOp
from ..compression import compressed_scatter_gather_allreduce
from .base import Algorithm, AlgorithmContext


class ByteGradAlgorithm(Algorithm):
    name = "bytegrad"
    #: every rank owns an equal chunk of the scatter-gather
    align_to_world = True

    def __init__(self, hierarchical: bool = True, average: bool = True):
        """
        Args:
            hierarchical: slice-local full-precision reduce, compressed
                cross-node ring; not ported yet, so True raises
                ``NotImplementedError``.
            average: If True average the reduced gradients, else sum.
        """
        if hierarchical:
            raise NotImplementedError(
                "ByteGradAlgorithm(hierarchical=True) is not ported yet")
        self.hierarchical = hierarchical
        self.average = average

    def reduce_bucket_grad(self, ctx: AlgorithmContext, index: int, flat):
        if ctx.comm.nranks() <= 1:
            return flat
        if ctx.codec_for("minmax_uint8") is None:
            # compress_intra="off": full precision, the escape hatch for
            # debugging a divergence (a forced codec name keeps the
            # scatter-gather, which has one wire format)
            op = ReduceOp.AVG if self.average else ReduceOp.SUM
            return ctx.bucket_allreduce(flat, op)
        return compressed_scatter_gather_allreduce(ctx.comm, flat, average=self.average)

    process_grads = Algorithm.process_grads_bucketed
