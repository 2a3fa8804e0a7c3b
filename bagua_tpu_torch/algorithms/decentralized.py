"""Decentralized SGD: the gossip families, whose weights differ between ranks.

Port of ``bagua_tpu/algorithms/decentralized.py`` (the reference's
``decentralized.py`` and its Rust comm ops):

- :class:`DecentralizedAlgorithm`: full-precision weight averaging before
  the optimizer step, with peer mode ``all`` (the allreduce mean of every
  bucket flat of the weights) or ``shift_one`` (the mean with one partner
  that rotates with the step, :func:`shift_one_peer`, over
  ``exchange_with_peer``).
- :class:`LowPrecisionDecentralizedAlgorithm`: the ring exchange of
  compressed weight differences after the optimizer step
  (``decentralized_low_precision_synchronous.rs:45-151``).  Each rank keeps
  f32 replicas of its left and right ring neighbours' weights and of its
  own, compresses ``x + left/3 + right/3 - 5 self/3`` of a whole bucket as
  one MinMaxUInt8 chunk (K1), sends it both ways, and decodes three payloads
  (K2): from the left into ``left``, from the right into ``right``, its own
  into the new weights ``self + D(own)``, which ``self`` becomes.

The gradient is taken at the weights from before the full-precision
exchange and applied to the exchanged weights, as in the JAX package (the
reference starts the exchange in the forward-pre hook and copies the result
back after the backward; the weights do not change between the two).

Hierarchical: where the algorithm asks for it and the intra-node tier has
more than one rank, the weights are first averaged within the node and the
gossip runs over the inter-node tier.  This is the JAX package's own
condition (``decentralized.py:91-97, 184-190``), not
``AlgorithmContext.two_tier()``: on one node the inter-node tier has one rank,
so the exchange is the intra-node average alone, with no ring and no codec.
"""

from __future__ import annotations

from typing import Any

import torch

from ..bucket import relayout_flats
from ..communication import ReduceOp
from ..compression import compress_chunked, decompress_chunked
from .base import Algorithm, AlgorithmContext


def shift_one_peer(rank: int, nranks: int, step: int) -> int:
    """Partner formula of ``decentralized_full_precision_synchronous.rs:79-83``:
    ranks of the lower half pair with a step-rotating rank of the upper half
    (an involution for an even world size)."""
    half = nranks // 2
    if rank < half:
        return (step + rank) % ((nranks + 1) // 2) + half
    return (rank - half - step) % half


def _gossip_tiers(ctx: AlgorithmContext, hierarchical: bool):
    """``(intra-node communicator or None, gossip communicator)``: the
    intra-node tier averages first where ``hierarchical`` and that tier has
    more than one rank and is not the inter-node tier."""
    if (hierarchical and ctx.internode is not None and ctx.intranode is not None
            and ctx.intranode.nranks() > 1 and ctx.internode is not ctx.intranode):
        return ctx.intranode, ctx.internode
    return None, ctx.comm


class DecentralizedAlgorithm(Algorithm):
    """Full-precision gossip.

    Args:
        hierarchical: average within the node first and gossip across nodes.
        peer_selection_mode: ``"all"`` (average every rank) or
            ``"shift_one"`` (average with one rotating partner; an even
            number of gossip ranks).
        communication_interval: steps between exchanges; partner ``k`` of
            ``shift_one`` is that of the ``k``-th exchange.
        track_peer_weights: keep the weights just after each exchange in
            ``algo_state["peer_weights"]``, one flat a bucket updated in
            place (the reference's ``peer_weight`` bucket tensor); a step
            without an exchange keeps the last ones.
    """

    replicated_params = False
    supports_flat_resident = True

    def __init__(self, hierarchical: bool = True, peer_selection_mode: str = "all",
                 communication_interval: int = 1, track_peer_weights: bool = False):
        if peer_selection_mode not in ("all", "shift_one"):
            raise ValueError(f"peer_selection_mode must be 'all' or 'shift_one', "
                             f"got {peer_selection_mode!r}")
        if communication_interval < 1:
            raise ValueError(f"communication_interval must be >= 1, got "
                             f"{communication_interval}")
        self.hierarchical = hierarchical
        self.peer_selection_mode = peer_selection_mode
        self.communication_interval = communication_interval
        self.track_peer_weights = track_peer_weights

    def init_state(self, ctx: AlgorithmContext, params) -> Any:
        if not self.track_peer_weights:
            return None
        return {"peer_weights": ctx.bucket_flat_copies(params)}

    def relayout_algo_state(self, old_plan, new_plan, algo_state):
        if algo_state is None:
            return None
        return {"peer_weights": relayout_flats(old_plan, new_plan, algo_state["peer_weights"])}

    def _exchange(self, ctx: AlgorithmContext, flat: torch.Tensor, step: int) -> torch.Tensor:
        intra, gossip = _gossip_tiers(ctx, self.hierarchical)
        if intra is not None:
            flat = intra.allreduce(flat, ReduceOp.AVG)
        n = gossip.nranks()
        if n <= 1:
            return flat
        if self.peer_selection_mode == "all":
            return gossip.allreduce(flat, ReduceOp.AVG)
        if n % 2:
            raise ValueError(f"shift_one needs an even number of ranks, got {n}")
        peer = gossip.exchange_with_peer(flat, shift_one_peer,
                                         step // self.communication_interval)
        return (flat + peer) * 0.5

    def process_pre_step(self, ctx: AlgorithmContext, params, algo_state, step):
        if step % self.communication_interval:
            return params, algo_state
        flats = [self._exchange(ctx, f, step) for f in ctx.bucket_flats(params)]
        if self.track_peer_weights:
            # in place: new tensors would leave the caller's previous state
            # holding a second set through the optimizer step
            for peer, f in zip(algo_state["peer_weights"], flats):
                peer.copy_(f)
        return ctx.from_bucket_flats(flats), algo_state


class LowPrecisionDecentralizedAlgorithm(Algorithm):
    """Low-precision gossip over a ring (see the module docstring).

    Args:
        hierarchical: average within the node first and run the ring across
            nodes.
        communication_interval: steps between exchanges.
    """

    replicated_params = False
    supports_flat_resident = True

    def __init__(self, hierarchical: bool = True, communication_interval: int = 1):
        if communication_interval < 1:
            raise ValueError(f"communication_interval must be >= 1, got "
                             f"{communication_interval}")
        self.hierarchical = hierarchical
        self.communication_interval = communication_interval

    def init_state(self, ctx: AlgorithmContext, params) -> Any:
        """The three replicas of every bucket, copies of the weights every
        rank starts from (the reference's ``_init_states``,
        ``decentralized.py:154-165``)."""
        flats = ctx.bucket_flat_copies(params)
        return {"left": flats, "right": [f.clone() for f in flats],
                "self": [f.clone() for f in flats]}

    def relayout_algo_state(self, old_plan, new_plan, algo_state):
        if algo_state is None:
            return None
        return {key: relayout_flats(old_plan, new_plan, algo_state[key])
                for key in ("left", "right", "self")}

    def _ring_step(self, ctx: AlgorithmContext, x, left, right, mine):
        """One compressed ring exchange of one bucket; updates the replicas
        in place and returns the new weights (``mine`` itself after an
        exchange)."""
        intra, ring = _gossip_tiers(ctx, self.hierarchical)
        if intra is not None:
            x = intra.allreduce(x, ReduceOp.AVG)
        n = ring.nranks()
        if n <= 1:
            return x
        diff = x + left / 3.0 + right / 3.0 - (5.0 / 3.0) * mine
        mn, mx, payload = compress_chunked(diff, 1)
        del diff
        # (mn, mx) travel as one f32 [2]; what is sent right arrives from
        # the left.  At two ranks both neighbours are the one other rank and
        # both directions carry the same bytes, as in the JAX package.
        stats = torch.cat([mn, mx])
        to_right = [(i, (i + 1) % n) for i in range(n)]
        to_left = [(i, (i - 1) % n) for i in range(n)]
        for replica, perm in ((left, to_right), (right, to_left)):
            got = ring.ppermute(stats, perm)
            replica.add_(decompress_chunked(got[:1], got[1:], ring.ppermute(payload, perm)))
        return mine.add_(decompress_chunked(mn, mx, payload))

    def process_post_step(self, ctx: AlgorithmContext, params, algo_state, step):
        if step % self.communication_interval:
            return params, algo_state
        flats = [self._ring_step(ctx, f, l, r, w) for f, l, r, w in zip(
            ctx.bucket_flats(params), algo_state["left"], algo_state["right"],
            algo_state["self"])]
        return ctx.from_bucket_flats(flats), algo_state
