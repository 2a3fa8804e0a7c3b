"""ByteGrad: 8-bit compressed gradient allreduce.

Port of ``bagua_tpu/algorithms/bytegrad.py``: buckets aligned to the world
size, and per bucket either

- the two-level form (``hierarchical=True``, the default, where the tiers
  allow it): a full-precision intra-node reduce-scatter, the compressed ring
  allreduce of the ``1 / intra`` shard across nodes (the codec on every
  inter-node hop, MinMaxUInt8 unless ``compress_inter`` names another:
  kernels K1 and K2), a full-precision intra-node allgather; or
- the compressed scatter-gather of
  :func:`~bagua_tpu_torch.compression.minmax_uint8.compressed_scatter_gather_allreduce`
  (K1 and K2) over the whole world.

A single rank has no wire: the flat is returned untouched and no codec runs.
The whole per-bucket codec pipeline is the overlap contract: under the
overlap scheduler (``overlap="on"``) K1 and K2 run from the backward, on the
trainer's comm stream.
"""

from __future__ import annotations

from ..communication import LINK_ICI, ReduceOp
from ..compression import compressed_scatter_gather_allreduce
from .base import Algorithm, AlgorithmContext


class ByteGradAlgorithm(Algorithm):
    name = "bytegrad"
    #: every rank owns an equal chunk of the scatter-gather
    align_to_world = True
    #: the wire formats of the inter-node ring hops and of the flat pipeline
    wire_codec_dcn = "minmax_uint8"
    wire_codec_flat = "minmax_uint8"
    #: the inter-node stage carries a residual when ``compress_inter`` names a
    #: stateful codec; the flat scatter-gather never does
    supports_ef_state = True
    supports_flat_resident = True
    supports_overlap = True
    #: the JAX package measured the overlap no faster for the codec pipeline
    #: (``BENCH_OVERLAP.json``, 0.69-0.95x on its CPU simulation), so
    #: ``auto`` keeps ByteGrad serialized; ``overlap="on"`` opts in
    overlap_auto = False

    def __init__(self, hierarchical: bool = True, average: bool = True):
        """
        Args:
            hierarchical: intra-node full-precision reduce, compressed
                inter-node ring; the flat scatter-gather where the tiers do
                not allow it.
            average: If True average the reduced gradients, else sum.
        """
        self.hierarchical = hierarchical
        self.average = average

    def reduce_bucket_grad(self, ctx: AlgorithmContext, index: int, flat):
        op = ReduceOp.AVG if self.average else ReduceOp.SUM
        if self.hierarchical and ctx.two_tier():
            # the shard divides the inter-node world: buckets are padded to
            # the whole world's size
            chunk = ctx.tier_reduce_scatter(flat, op)
            chunk = ctx.tier_allreduce(chunk, op, codec=self.wire_codec_dcn)
            return ctx.tier_allgather(chunk)
        if ctx.comm.nranks() <= 1:
            return flat
        if ctx.codec_for(LINK_ICI, self.wire_codec_flat) is None:
            # compress_intra="off": full precision, the escape hatch for
            # debugging a divergence (a forced codec name keeps the
            # scatter-gather, which has one wire format)
            return ctx.bucket_allreduce(flat, op)
        return compressed_scatter_gather_allreduce(ctx.comm, flat, average=self.average)

    process_grads = Algorithm.process_grads_bucketed
