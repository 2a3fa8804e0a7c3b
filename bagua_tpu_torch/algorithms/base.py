"""Algorithm base class: the pluggable "what to communicate" contract.

Port of the core of ``bagua_tpu/algorithms/base.py``.  An algorithm picks the
tensors to communicate and their buckets (``init_tensors``,
``tensors_to_buckets``) and transforms the gradients between the backward
pass and the optimizer step (``process_grads``).  Dense families implement
``reduce_bucket_grad`` for one bucket's flat gradient and alias
``process_grads`` to ``process_grads_bucketed``, which folds in the
error-feedback residual, runs it over every bucket in launch order and
hands the results to ``grads_from_reduced``.  Those that set
``supports_overlap`` let the trainer's overlap scheduler call
``reduce_bucket_grad`` from the backward instead, bucket by bucket as each
gradient finalizes (``core/backend.py``).  A
family that owns its optimizer (QAdam, ZeRO) sets ``owns_optimizer`` and
provides ``init_optimizer_state`` (or, with ``sharded_opt_state``,
``init_optimizer_state_sharded``) and ``optimizer_update``.  The gossip
families (``decentralized.py``) set ``replicated_params`` False and
transform the weights instead, before the optimizer step
(``process_pre_step``) or after it (``process_post_step``).  Gradients and
weights travel between the stages as ``name -> tensor`` dicts.  Async model
average works between steps, in the host-side hook ``host_pre_step``, on
process groups of its own (``communicators``).

The context carries the two tiers of the hierarchical collectives (the
intra-node and inter-node communicators, ``communication.py``), their codec
policy and, under the overlap scheduler, their ring chunk targets, and
composes the two-level allreduce from them: an intra-node reduce-scatter,
the inter-node allreduce of the ``1 / intra`` shard (through the compressed
ring where a codec resolves), an intra-node allgather; each stage rides the
chunked ring where a chunk target sizes it to more than one sub-ring.  It
also holds the byte accounting of a bucket's collective by tier
(``bucket_tier_bytes``) and the scheduler's launch order
(``bucket_launch_order``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..bucket import BucketPlan, relayout_flats
from ..communication import LINK_DCN, LINK_ICI, BaguaCommunicator, ReduceOp, ring_chunks_for
from ..compression.codecs import get_codec
from ..define import TensorDeclaration
from ..tensor import NamedParam

logger = logging.getLogger(__name__)

#: (family, codec, reason) triples whose stateless-EF warning was logged:
#: an error-feedback codec riding without its residual says so once a run
_EF_STATELESS_WARNED: set = set()


@dataclass
class AlgorithmContext:
    """Per-trainer context handed to the algorithm stages."""

    comm: BaguaCommunicator
    plan: BucketPlan
    world_size: int = 1
    #: codec policy of the intra-node tier and the flat ring
    #: (``BAGUA_COMPRESS_INTRA`` values): ``auto`` defers to the algorithm
    #: family's own wire codec, ``off`` forces full precision, a codec name
    #: forces that codec
    intra_codec: Optional[str] = None
    #: codec policy of the inter-node tier (``BAGUA_COMPRESS_INTER``)
    inter_codec: Optional[str] = None
    #: the communicators of the two tiers (None: no tiers)
    intranode: Optional[BaguaCommunicator] = None
    internode: Optional[BaguaCommunicator] = None
    #: whether the error-feedback residual may be carried (off with
    #: ``BAGUA_EF_RESIDUAL=off``); :meth:`Algorithm.ef_codec` reads it
    ef_enabled: bool = False
    #: where the algorithm's state lives
    device: Optional[torch.device] = None
    #: the flat-resident layout: params, gradients and optimizer state are
    #: one flat a bucket across steps, and the stages get those flats
    flat_resident: bool = False
    #: the overlap scheduler is active: each bucket's collective is issued
    #: from the backward through :meth:`Algorithm.reduce_bucket_grad`
    overlap: bool = False
    #: target bytes a rank of one ring sub-collective (None: one collective
    #: a bucket); the fallback of the two tier targets below
    overlap_chunk_bytes: Optional[int] = None
    #: the tier targets: the intra-node tier and the flat ring, and the
    #: inter-node tier, which a larger target suits (None: the fallback)
    intra_chunk_bytes: Optional[int] = None
    inter_chunk_bytes: Optional[int] = None

    def bucket_flats(self, tensors) -> List[torch.Tensor]:
        """One flat buffer per bucket: under the resident layout the flats
        the stage was given, with no copy (``base.py:139-147``); else new
        flats from tensors by name."""
        if self.flat_resident:
            return list(tensors)
        return self.plan.flatten(tensors)

    def bucket_flat_copies(self, tensors) -> List[torch.Tensor]:
        """Like :meth:`bucket_flats`, but flats of their own in either
        layout: state a stage keeps across steps (the gossip families'
        replicas) must not share the resident flats' storage."""
        if self.flat_resident:
            return [f.clone() for f in tensors]
        return self.plan.flatten(tensors)

    def from_bucket_flats(self, flats):
        """Inverse of :meth:`bucket_flats`: the flats themselves (resident),
        or views into them by name."""
        if self.flat_resident:
            return tuple(flats)
        return self.plan.unflatten(flats)

    def codec_for(self, link_class: str, family_default=None):
        """The wire codec of one link class: the tier's policy knob where it
        names a codec or forces ``off``, else the family's default (None =
        full precision)."""
        knob = self.inter_codec if link_class == LINK_DCN else self.intra_codec
        if knob in (None, "", "auto"):
            return family_default
        if knob == "off":
            return None
        return knob

    def flat_ring_codec(self):
        """The knob-forced codec of the flat (whole world) ring, or None when
        there is none or the world is a single rank (no ring, no wire: the
        codec is dropped, as on the JAX package's single-rank meshes)."""
        codec = self.codec_for(LINK_ICI, None)
        return codec if codec is not None and self.comm.nranks() > 1 else None

    # -- the two tiers --------------------------------------------------------

    def two_tier(self) -> bool:
        """Whether the two-level decomposition is available: both tiers exist,
        are distinct, each has more than one rank, and the two together tile
        the world (``base.py:174-187``).  The JAX condition lets a one-node
        world (inter-node tier of one rank) through, where the inter-node
        ring sends its shard exactly while an error-feedback codec on that
        tier still keeps a residual; a one-node world takes the flat path
        here instead."""
        return (
            self.internode is not None
            and self.intranode is not None
            and self.internode is not self.intranode
            and self.intranode.nranks() > 1
            and self.internode.nranks() > 1
            and self.world_size == self.internode.nranks() * self.intranode.nranks()
        )

    def chunk_bytes_for(self, link_class: str) -> Optional[int]:
        """The ring chunk target of one link class: the tier's own where
        set, else :attr:`overlap_chunk_bytes` (``base.py:189-196``)."""
        tier = self.inter_chunk_bytes if link_class == LINK_DCN else self.intra_chunk_bytes
        return tier if tier else self.overlap_chunk_bytes

    def _comm_chunks(self, comm: BaguaCommunicator, numel: int, itemsize: int,
                     link_class: str) -> int:
        """Sub-rings of one collective over ``comm`` (1: one collective).
        The one gate of every bucket collective, flat and tiered, so that the
        ring never applies to one half of a scatter/gather pair alone."""
        target = self.chunk_bytes_for(link_class)
        if not target or comm.nranks() <= 1:
            return 1
        return ring_chunks_for(numel, itemsize, comm.nranks(), target, link_class)

    def _ring_chunks(self, numel: int, itemsize: int) -> int:
        """The chunk gate of the flat (whole world) path."""
        return self._comm_chunks(self.comm, numel, itemsize, LINK_ICI)

    def tier_reduce_scatter(self, flat, op: ReduceOp, codec=None):
        """Intra-node reduce-scatter of ``flat``: this rank's contiguous
        ``1 / intra`` chunk, through the compressed ring where the intra-node
        policy resolves a codec (``codec`` is the family default), through
        the chunked ring where the intra-node target sizes more than one
        sub-ring."""
        codec = self.codec_for(LINK_ICI, codec)
        k = self._comm_chunks(self.intranode, flat.shape[0], flat.element_size(), LINK_ICI)
        if codec is not None or k > 1:
            return self.intranode.ring_reduce_scatter(flat, op, num_chunks=k, codec=codec)
        return self.intranode.reduce_scatter(flat, op)

    def tier_allreduce(self, chunk, op: ReduceOp, codec=None):
        """Inter-node allreduce of this rank's shard, the only stage whose
        bytes cross nodes and so the one the codec policy compresses: with a
        resolved codec it rides the compressed ring, sized against the
        inter-node chunk target."""
        codec = self.codec_for(LINK_DCN, codec)
        k = self._comm_chunks(self.internode, chunk.shape[0], chunk.element_size(), LINK_DCN)
        if codec is not None or k > 1:
            return self.internode.ring_allreduce(chunk, op, num_chunks=k, codec=codec)
        return self.internode.allreduce(chunk, op)

    def tier_allgather(self, chunk, codec=None):
        """Intra-node allgather of this rank's chunk back to the full flat,
        under the same gate as :meth:`tier_reduce_scatter` (sized on the
        full flat the chunk tiles), so that the pair keeps one layout."""
        codec = self.codec_for(LINK_ICI, codec)
        k = self._comm_chunks(self.intranode, chunk.shape[0] * self.intranode.nranks(),
                              chunk.element_size(), LINK_ICI)
        if codec is not None or k > 1:
            return self.intranode.ring_allgather(chunk, num_chunks=k, codec=codec)
        return self.intranode.allgather(chunk, axis=0, tiled=True)

    def two_level_allreduce(self, flat, op: ReduceOp):
        """Intra-node reduce-scatter, inter-node allreduce of the ``1 /
        intra`` shard, intra-node allgather.  A flat that does not split
        into ``intra`` rank blocks of the intra-node tier's sub-rings is
        zero-padded and sliced back.  AVG divides once, by the world, after
        the summing stages, as the flat allreduce does, so only the order of
        the sum differs from it.  The inter-node stage is compressed only
        where ``compress_inter`` names a codec."""
        if op not in (ReduceOp.SUM, ReduceOp.AVG):
            raise ValueError(f"two_level_allreduce supports SUM/AVG, got {op}")
        size = flat.shape[0]
        n_intra = self.intranode.nranks()
        ki = self._comm_chunks(self.intranode, size, flat.element_size(), LINK_ICI)
        pad = (-size) % (n_intra * ki)
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        chunk = self.tier_reduce_scatter(flat, ReduceOp.SUM)
        chunk = self.tier_allreduce(chunk, ReduceOp.SUM)
        if op == ReduceOp.AVG:
            chunk = chunk / self.world_size
        full = self.tier_allgather(chunk)
        return full[:size] if pad else full

    def bucket_reduce_scatter(self, flat: torch.Tensor, op: ReduceOp) -> torch.Tensor:
        """One bucket's reduce-scatter, ZeRO's gradient half (``base.py:352-367``):
        this rank's contiguous ``1 / world`` slice, through the flat ring
        where the forced flat codec resolves or the chunk target sizes more
        than one sub-ring, else one reduce-scatter (the same layout)."""
        codec = self.flat_ring_codec()
        k = self._ring_chunks(flat.shape[0], flat.element_size())
        if codec is not None or k > 1:
            return self.comm.ring_reduce_scatter(flat, op, num_chunks=k, codec=codec)
        return self.comm.reduce_scatter(flat, op)

    def bucket_allgather(self, chunk: torch.Tensor) -> torch.Tensor:
        """The inverse of :meth:`bucket_reduce_scatter`, ZeRO's
        re-replication (``base.py:369-381``): every rank's chunk in rank
        order, under the same gate (sized on the full flat the chunk
        tiles)."""
        codec = self.flat_ring_codec()
        k = self._ring_chunks(chunk.shape[0] * self.comm.nranks(), chunk.element_size())
        if codec is not None or k > 1:
            return self.comm.ring_allgather(chunk, num_chunks=k, codec=codec)
        return self.comm.allgather(chunk, axis=0, tiled=True)

    def bucket_allreduce(self, flat: torch.Tensor, op: ReduceOp,
                         hierarchical: bool = False) -> torch.Tensor:
        """One bucket's allreduce (``base.py:325-350``): the two-level form
        where ``hierarchical`` and the tiers allow it; else the flat ring
        with the forced flat codec where one resolves, or chunked where the
        target sizes more than one sub-ring and the call is not
        hierarchical; else one allreduce."""
        if hierarchical and self.two_tier():
            return self.two_level_allreduce(flat, op)
        codec = self.flat_ring_codec()
        k = self._ring_chunks(flat.shape[0], flat.element_size())
        if codec is not None or (k > 1 and not hierarchical):
            return self.comm.ring_allreduce(flat, op, num_chunks=k, codec=codec)
        return self.comm.allreduce(flat, op)

    # -- byte accounting and the launch order -----------------------------

    @staticmethod
    def _wire_bytes(numel: int, itemsize: int, codec_name) -> int:
        """Wire bytes of one ``numel``-element operand under a codec name
        (None: full precision)."""
        if codec_name is None:
            return int(numel) * int(itemsize)
        return get_codec(codec_name).wire_bytes(int(numel))

    def bucket_tier_bytes(self, index: int, hierarchical: bool = True, dcn_codec=None,
                          flat_codec=None) -> dict:
        """Bytes on the wire of one bucket's gradient collective by tier
        (``base.py:385-484``), in the ring model: a tier's allreduce moves
        ``2 (n - 1) / n`` of its operand, a scatter or gather half ``(n - 1)
        / n``.  ``dcn_bytes`` crosses nodes: 0 without tiers; on tiers with
        ``hierarchical=False`` the bytes the flat collective sends across
        them.  ``dcn_codec`` and ``flat_codec`` are the family's wire codecs
        (``Algorithm.wire_codec_dcn``, ``wire_codec_flat``); the tier knobs
        override them through :meth:`codec_for`, exactly as the collectives
        resolve them, so compressed bytes are reported where a codec rides
        the tier."""
        b = self.plan.buckets[index]
        itemsize = b.dtype.itemsize
        numel = int(b.padded_numel)
        nbytes = numel * itemsize
        if flat_codec is not None:
            # a family's own flat pipeline compresses unless the knob forces
            # "off" (a forced name keeps its one wire format)
            resolved_flat = flat_codec if self.codec_for(LINK_ICI, flat_codec) is not None else None
        else:
            resolved_flat = self.flat_ring_codec()
        if not self.two_tier():
            return {"tier": "flat", "bytes": nbytes,
                    "ici_bytes": self._wire_bytes(numel, itemsize, resolved_flat),
                    "dcn_bytes": 0, "dcn_codec": None, "flat_codec": resolved_flat}
        ni, ne = self.intranode.nranks(), self.internode.nranks()
        if not hierarchical:
            wire = self._wire_bytes(numel, itemsize, resolved_flat)
            return {"tier": "flat", "bytes": nbytes, "ici_bytes": wire,
                    "dcn_bytes": int(2 * wire * (ne - 1) // ne), "dcn_codec": resolved_flat,
                    "flat_codec": resolved_flat}
        resolved_dcn = self.codec_for(LINK_DCN, dcn_codec)
        ici_wire = self._wire_bytes(numel, itemsize, self.codec_for(LINK_ICI, None))
        # full precision: the shard in bytes; a codec's payload is per
        # element, so its shard is counted in elements
        dcn_wire = (-(-numel * itemsize // ni) if resolved_dcn is None
                    else self._wire_bytes(-(-numel // ni), itemsize, resolved_dcn))
        return {"tier": "two_level", "bytes": nbytes,
                "ici_bytes": int(2 * ici_wire * (ni - 1) // ni),
                "dcn_bytes": int(2 * dcn_wire * (ne - 1) // ne),
                "dcn_codec": resolved_dcn, "flat_codec": None}

    def bucket_launch_order(self, hierarchical: bool, dcn_codec=None) -> List[int]:
        """The order the overlap scheduler issues the buckets' collectives in
        (``base.py:486-505``): on two tiers with the hierarchical path under
        the scheduler, the buckets by their inter-node bytes, most first
        (stable), so that the slow link is busy through the whole backward;
        else the plan's order.  Results are assembled in plan order, so the
        order changes no number."""
        n = len(self.plan.buckets)
        if not (self.overlap and hierarchical and self.two_tier()):
            return list(range(n))
        dcn = [self.bucket_tier_bytes(i, hierarchical, dcn_codec=dcn_codec)["dcn_bytes"]
               for i in range(n)]
        return sorted(range(n), key=lambda i: -dcn[i])


class Algorithm:
    """Base algorithm: plain data parallelism hooks; gradients unchanged."""

    #: False for the gossip families, whose weights differ between ranks
    #: after the first step (every rank still starts from rank 0's)
    replicated_params: bool = True
    #: True when the algorithm provides its own optimizer update (QAdam, ZeRO)
    owns_optimizer: bool = False
    #: True when each rank keeps only its shard of the optimizer state (ZeRO):
    #: the trainer builds it with :meth:`init_optimizer_state_sharded`
    sharded_opt_state: bool = False
    #: True pads every bucket to a multiple of the world size (the
    #: compressed scatter-gather gives each rank an equal chunk)
    align_to_world: bool = False
    #: intra-node then inter-node communication
    hierarchical: bool = False
    #: the family's wire codecs: on the inter-node stage of its hierarchical
    #: path (ByteGrad and QAdam compress it), and on its own flat pipeline
    #: (ByteGrad's and QAdam's scatter-gather); None = full precision.  They
    #: are what the codec policy's ``auto`` resolves to.
    wire_codec_dcn: Optional[str] = None
    wire_codec_flat: Optional[str] = None
    #: True when the family's gradient communication is the per-bucket
    #: reduction of :meth:`process_grads_bucketed`, so a per-bucket f32
    #: residual can ride ``algo_state`` and :meth:`compensate_flats` can fold
    #: it in; an error-feedback codec forced onto another family rides
    #: without it, with a warning
    supports_ef_state: bool = False
    #: the overlap contract: the trainer's overlap scheduler may call
    #: :meth:`reduce_bucket_grad` once a bucket, from the backward, as each
    #: bucket's gradient finalizes, and hand the results to
    #: :meth:`grads_from_reduced` in place of :meth:`process_grads`.
    #: Families whose communication is not a map over the buckets (the
    #: gossip exchanges, QAdam's momentum pipeline) keep False
    supports_overlap: bool = False
    #: whether ``overlap="auto"`` may pick the overlap path for this family
    #: (``on`` always does): the JAX package's values, measured on its own
    #: hardware (``BENCH_OVERLAP.json``)
    overlap_auto: bool = True
    #: True when the trainer may keep params, gradients and optimizer state
    #: as resident bucket flats (every stage goes through
    #: ``AlgorithmContext.bucket_flats``/``from_bucket_flats``)
    supports_flat_resident: bool = False
    #: whether ``flat_resident="auto"`` may pick the resident layout for
    #: this family (``on`` always does): the JAX package's values, measured
    #: on its own hardware (``BENCH_FLAT.json``)
    flat_resident_auto: bool = True
    #: True when the family's reduced gradients are the same on every rank
    #: (a plain summed or averaged bucket reduction), so the guard's verdict
    #: on them needs no collective of its own; the others' verdict is taken
    #: on the updated parameters
    grad_health_replicated: bool = False

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
        """Algorithm state: the error-feedback residual where an EF codec is
        active under ``ctx``, else None."""
        return self.ef_init_state(ctx, None)

    # -- error-feedback residual (the stateful codecs) -----------------------
    #
    # The 1-bit and top-k codecs are biased: SGD on their raw output does not
    # converge.  Error feedback (EF-SignSGD, arXiv:1901.09847; 1-bit Adam,
    # arXiv:2102.02888) carries the quantization error forward: each step
    # sends ``grad + residual`` and keeps what the wire lost.  One local
    # encode/decode per bucket models the wire's error; the ring's
    # re-quantization of partial sums is not captured (``base.py:618-636``).
    # The residual is ``algo_state["ef"]["buckets"]``: one f32 flat per
    # bucket.  Each process is one rank, so it has no leading rank axis.

    def ef_codec(self, ctx: AlgorithmContext):
        """The error-feedback codec whose residual this family carries under
        ``ctx``, or None (``base.py:637-680``): the inter-node then
        intra-node codec on the two-level path, the flat ring's codec
        otherwise (not for a family with its own flat pipeline, where a
        forced codec name never reaches the wire).  An EF codec on a family
        without EF state, or with the residual off, rides without it and
        warns once."""
        names: List = []
        if self.hierarchical and ctx.two_tier():
            names.append(ctx.codec_for(LINK_DCN, self.wire_codec_dcn))
            names.append(ctx.codec_for(LINK_ICI, None))
        elif self.wire_codec_flat is None:
            names.append(ctx.flat_ring_codec())
        codec = next((c for c in (get_codec(n) for n in names if n is not None)
                      if c.error_feedback), None)
        if codec is None:
            return None
        if self.supports_ef_state and ctx.ef_enabled:
            return codec
        reason = "unsupported_family" if not self.supports_ef_state else "residual_disabled"
        key = (type(self).__name__, codec.name, reason)
        if key not in _EF_STATELESS_WARNED:
            _EF_STATELESS_WARNED.add(key)
            logger.warning(
                "codec %r is an error-feedback codec but its residual is OFF (%s) for %s: "
                "the wire carries raw %s output, whose bias is known to stall or diverge "
                "SGD; use this only as a convergence control",
                codec.name, reason, type(self).__name__, codec.name)
        return None

    def ef_init_state(self, ctx: AlgorithmContext, state: Any) -> Any:
        """``state`` with the residual added: one zero f32 flat of
        ``padded_numel`` per bucket.  ``state`` unchanged when no EF codec
        is active."""
        if self.ef_codec(ctx) is None:
            return state
        ef = {"buckets": tuple(torch.zeros(b.padded_numel, dtype=torch.float32,
                                           device=ctx.device)
                               for b in ctx.plan.buckets)}
        if state is None:
            return {"ef": ef}
        if not isinstance(state, dict) or "ef" in state:
            raise ValueError(f"cannot add the EF residual to algorithm state {state!r}")
        return {**state, "ef": ef}

    def compensate_flats(self, ctx: AlgorithmContext, flats, algo_state):
        """Fold the residual into the bucket flats about to go on the wire and
        keep the new quantization error (``base.py:708-731``): ``c = g + r``;
        the wire carries ``encode(c)``; ``r' = c - decode(encode(c))``.
        Identity when no EF codec is active."""
        out = [self.compensate_flat(ctx, i, f, algo_state) for i, f in enumerate(flats)]
        return [f for f, _ in out], self.with_residuals(algo_state, [r for _, r in out])

    def compensate_flat(self, ctx: AlgorithmContext, index: int, flat, algo_state):
        """:meth:`compensate_flats` for bucket ``index`` alone, as the overlap
        scheduler runs it from the backward: ``(c, r')``, ``(flat, None)``
        when no EF codec is active.  Nothing is changed in place, so a
        rewound step keeps the residual it started from."""
        codec = self.ef_codec(ctx)
        ef = algo_state.get("ef") if isinstance(algo_state, dict) else None
        if codec is None or ef is None:
            return flat, None
        c = flat.float() + ef["buckets"][index]
        dec = codec.decode(codec.encode(c[None]), c.shape[0])[0]
        return c.to(flat.dtype), c - dec

    @staticmethod
    def with_residuals(algo_state, residuals):
        """``algo_state`` with the new residuals of :meth:`compensate_flat`
        (unchanged where it returned None)."""
        if not residuals or residuals[0] is None:
            return algo_state
        return {**algo_state, "ef": {"buckets": tuple(residuals)}}

    def process_grads(self, ctx: AlgorithmContext, grads, params, algo_state, step):
        """Gradient communication stage, after the full backward."""
        return grads, algo_state

    def reduce_bucket_grad(self, ctx: AlgorithmContext, index: int,
                           flat: torch.Tensor) -> torch.Tensor:
        """Communicate one bucket's final flat gradient; returns the reduced
        flat (dense families) or this rank's chunk of it (ZeRO).  Under the
        overlap scheduler it runs on the trainer's comm worker thread and
        comm stream."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement reduce_bucket_grad")

    def grads_from_reduced(self, ctx: AlgorithmContext, reduced, grads, algo_state, step):
        """The gradients after communication, from the per-bucket results of
        :meth:`reduce_bucket_grad` in plan order (``base.py:752-759``): the
        reduced flats (resident), or views into them by name."""
        return ctx.from_bucket_flats(reduced), algo_state

    def process_grads_bucketed(self, ctx: AlgorithmContext, grads, params,
                               algo_state, step):
        """The serialized communication of the ``supports_overlap`` families
        (``base.py:761-781``): flatten the gradients per bucket, fold in the
        error-feedback residual, issue :meth:`reduce_bucket_grad` in
        :meth:`AlgorithmContext.bucket_launch_order` and assemble the results
        in plan order through :meth:`grads_from_reduced`: the overlap
        scheduler's per-bucket reduction, issued after the whole backward."""
        flats = ctx.bucket_flats(grads)
        flats, algo_state = self.compensate_flats(ctx, flats, algo_state)
        reduced: List[Optional[torch.Tensor]] = [None] * len(flats)
        for i in ctx.bucket_launch_order(self.hierarchical, dcn_codec=self.wire_codec_dcn):
            reduced[i] = self.reduce_bucket_grad(ctx, i, flats[i])
        return self.grads_from_reduced(ctx, reduced, grads, algo_state, step)

    def process_pre_step(self, ctx: AlgorithmContext, params, algo_state, step):
        """Weight transformation after the gradient stage, before the
        optimizer step (the full-precision gossip exchange).  ``params`` is
        name -> tensor; returns ``(params, algo_state)``, the trainer copying
        every returned tensor that is not the module's own parameter into
        it."""
        return params, algo_state

    def process_post_step(self, ctx: AlgorithmContext, params, algo_state, step):
        """Weight transformation after the optimizer step (the low-precision
        gossip ring), under the same contract as :meth:`process_pre_step`."""
        return params, algo_state

    def host_pre_step(self, trainer, state):
        """Host-side hook at the top of every ``BaguaTrainer.train_step``,
        under ``torch.no_grad()``: the boundary between steps where async
        model average swaps weights (the reference's weight lock,
        ``async_model_average.py:156-168``).  A hook that changes the
        weights writes them into the module's parameters in place; returns
        the state."""
        return state

    def relayout_algo_state(self, old_plan: BucketPlan, new_plan: BucketPlan, algo_state):
        """``algo_state`` moved from ``old_plan``'s buckets onto
        ``new_plan``'s when the trainer re-buckets (``base.py:783-800``):
        the error-feedback residual ``{"ef": ...}`` through
        :func:`~bagua_tpu_torch.bucket.relayout_flats`; a family whose own
        state holds bucket flats overrides this."""
        if algo_state is None:
            return None
        if isinstance(algo_state, dict) and set(algo_state) == {"ef"}:
            flats = relayout_flats(old_plan, new_plan, list(algo_state["ef"]["buckets"]))
            # the residual is f32 whatever the bucket's dtype the segments
            # went through (exact for f32 plans)
            return {"ef": {"buckets": tuple(f.float() for f in flats)}}
        raise NotImplementedError(
            f"{type(self).__name__} carries algorithm state but does not implement "
            "relayout_algo_state; re-bucketing it would orphan that state")

    def on_restore(self, trainer) -> None:
        """Host-side hook after a checkpoint restore: an algorithm whose
        host-side schedule belongs to the run before it (async model
        average's round in flight, anchor and period) resets it here."""
        return None

    def communicators(self) -> List[BaguaCommunicator]:
        """The communicators of the algorithm's own process groups, whose
        host-staged bytes the trainer counts beside its own."""
        return []

    def init_optimizer_state(self, params: Dict[str, torch.Tensor]):
        """Optimizer state of an ``owns_optimizer`` family."""
        raise NotImplementedError("only algorithms with owns_optimizer=True")

    def init_optimizer_state_sharded(self, ctx: AlgorithmContext,
                                     params: Dict[str, torch.Tensor]):
        """This rank's shard of the optimizer state of a
        ``sharded_opt_state`` family; the trainer calls it in place of
        :meth:`init_optimizer_state`."""
        raise NotImplementedError("only algorithms with sharded_opt_state=True")

    def optimizer_update(self, ctx: AlgorithmContext, params, grads, opt_state,
                         algo_state, step):
        """The optimizer step of an ``owns_optimizer`` family: updates
        ``params`` (name -> parameter) in place; returns ``(params,
        opt_state, algo_state)``."""
        raise NotImplementedError("only algorithms with owns_optimizer=True")
