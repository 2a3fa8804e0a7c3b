"""ZeRO-1: optimizer-state sharding over the data-parallel ranks.

Port of ``bagua_tpu/algorithms/zero.py`` on the port's collectives: the
function the JAX trainer runs on a pure data-parallel mesh,
``_optimizer_update_flat`` (``zero.py:353-393``).  Every bucket is padded to a
multiple of the world size, so it splits into equal rank chunks, and a step
is, bucket by bucket,

    reduce-scatter(grads, AVG)  ->  update of this rank's chunk  ->  allgather(params)

which moves the bytes of the allreduce it replaces while each rank keeps only
``1 / world`` of the optimizer state: one torch optimizer over one chunk
tensor per bucket.  A codec forced with ``compress_intra`` rides the scatter
and the gather rings (at world size 2 one K3 launch each per bucket under
``int8``).

``hierarchical=True`` on a world of more than one node is the staged form:
the gradient chunk is an intra-node reduce-scatter then the inter-node
allreduce of that ``1 / intra`` shard, the state is sharded over the
intra-node ranks only (replicated across nodes), and the gather is
intra-node.  On one node the flag takes the flat path, as the other
families' does.

Under the flat-resident layout the chunk tensors are views of the trainer's
parameter flats, so the optimizer steps this rank's chunk of the parameters
in place and no second copy of it is kept; the allgather's result is then
written back into the flats.  Under the leaf layout the chunk tensors are
copies: each step copies this rank's chunk of the current parameters into
them (as JAX re-reads it from the replicated flat, ``:377``; a codec's gather
is lossy, so a chunk kept across steps would leave the JAX trajectory) and
writes the gathered flats back into the parameters in place.  Under expert,
tensor or pipeline parallelism the leaf layout's model-parallel ("local")
leaves, which stay out of the bucket plan (the expert tables, the tp and pp
shards), take the replicated path (``zero.py:240-351``): a second optimizer
of the same factory over the module's local parameters themselves, stepped
on their gradients, which the trainer has averaged over dp (an expert
table's after its ``1 / ep_size`` rescale).  Clipping with local leaves is
not ported: its norm would need every model-parallel axis (JAX raises
too).

The per-bucket reduce-scatter is the overlap contract, on the resident layout
only: under the overlap scheduler ``reduce_bucket_grad`` issues it from the
backward, ``grads_from_reduced`` wraps the chunks in :class:`ReducedChunks`,
and ``optimizer_update`` takes them in place of its own reduce-scatter.

The optimizer must be elementwise (Adam, AdamW, SGD, RMSprop, ...): each rank
updates its own chunk alone, so an update that couples elements (a
global-norm clip inside the optimizer) would train on per-chunk norms.  The
constructor probes for that.  Global-norm clipping is built in
(``clip_global_norm``): the norm of the averaged gradient from one scalar
allreduce over the shard ranks.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..checkpoint import check_optimizer_state_tree, load_optimizer_state_tree, optimizer_state_tree
from ..communication import ReduceOp, recording_tag
from .base import Algorithm, AlgorithmContext


class ZeroOptState(NamedTuple):
    """This rank's optimizer state: its chunk of every bucket's flat (the
    optimizer's parameters) and the optimizer, whose state is therefore this
    rank's shard; the local leaves' names and their optimizer (None without
    local leaves)."""

    chunks: Tuple[torch.Tensor, ...]
    optimizer: torch.optim.Optimizer
    local_names: Tuple[str, ...] = ()
    local: Optional[torch.optim.Optimizer] = None


class ReducedChunks(NamedTuple):
    """The gradient chunks the overlap scheduler already reduced, one a
    bucket: what ``optimizer_update`` takes in place of the gradients."""

    chunks: Tuple[torch.Tensor, ...]


class ZeroOptimizerAlgorithm(Algorithm):
    """ZeRO stage 1: replicated parameters, sharded optimizer state,
    reduce-scatter gradient averaging.

    Args:
        optimizer: an elementwise optimizer factory, ``params ->
            torch.optim.Optimizer`` (default ``Adam(lr=1e-3)``, the JAX
            package's ``optax.adam(1e-3)``); it is given this rank's chunk
            tensors.
        clip_global_norm: optional largest global gradient norm, computed on
            the averaged gradient, so that every rank applies the same scale.
        hierarchical: the staged form where the tiers allow it (above).
        check_elementwise: probe the optimizer for coupled elements at
            construction and raise ``ValueError`` if it couples them.
    """

    name = "zero"
    owns_optimizer = True
    sharded_opt_state = True
    #: every bucket splits into equal rank chunks
    align_to_world = True
    supports_flat_resident = True
    #: on the resident layout only (the trainer's gate)
    supports_overlap = True
    #: the JAX package measured ZeRO slower under the overlap (0.9x on its
    #: CPU simulation, ``BENCH_OVERLAP.json``): ``auto`` keeps it serialized
    overlap_auto = False

    def __init__(
        self,
        optimizer: Optional[Callable] = None,
        clip_global_norm: Optional[float] = None,
        hierarchical: bool = False,
        check_elementwise: bool = True,
    ):
        self.optimizer = (optimizer if optimizer is not None
                          else functools.partial(torch.optim.Adam, lr=1e-3))
        self.clip_global_norm = clip_global_norm
        self.hierarchical = hierarchical
        if check_elementwise:
            self._check_elementwise()

    def _check_elementwise(self) -> None:
        """Raise when the optimizer is not elementwise (``zero.py:115-163``):
        stepping a 2-vector must equal stepping its two halves apart.  Three
        gradients of varying norm (5, 0.14, 2.2), because an Adam-family
        update does not change under one constant scale of the gradient, so
        one step cannot expose a clip.  On CPU tensors."""
        grads = [torch.tensor([3.0, -4.0]), torch.tensor([0.1, 0.1]), torch.tensor([-1.0, 2.0])]

        def run(part):
            p = torch.tensor([0.5, -1.5])[part].clone()
            opt = self.optimizer([p])
            for g in grads:
                p.grad = g[part].clone()
                opt.step()
            return p

        full = run(slice(0, 2))
        halves = torch.cat([run(slice(0, 1)), run(slice(1, 2))])
        if not torch.allclose(full, halves, rtol=1e-5, atol=1e-7):
            raise ValueError(
                "ZeroOptimizerAlgorithm requires an ELEMENTWISE optimizer "
                "(Adam/AdamW/SGD/RMSprop/...): updating a vector and updating its "
                "halves independently disagree, so the optimizer couples elements "
                "(global-norm clipping?).  Use the built-in clip_global_norm= for "
                "distributed clipping, or pass check_elementwise=False if the "
                "coupling is intentional.")

    # ---- chunks -------------------------------------------------------------

    def _staged(self, ctx: AlgorithmContext) -> bool:
        """Whether the staged (intra-node sharded) form is taken."""
        return self.hierarchical and ctx.two_tier()

    def _shard_comm(self, ctx: AlgorithmContext):
        """The ranks the optimizer state shards over: intra-node when
        staged, the whole world otherwise."""
        return ctx.intranode if self._staged(ctx) else ctx.comm

    def _my_chunk(self, ctx: AlgorithmContext, flat: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous chunk of a bucket flat (a view)."""
        shard = self._shard_comm(ctx)
        size = flat.shape[0] // shard.nranks()
        return flat[shard.rank() * size:(shard.rank() + 1) * size]

    def _avg_scatter(self, ctx: AlgorithmContext, flat: torch.Tensor) -> torch.Tensor:
        """The average of ``flat`` over the world, this rank's chunk of it:
        one reduce-scatter (flat), or an intra-node reduce-scatter then the
        inter-node allreduce of the chunk (staged: the average of equal-sized
        averages is the world's)."""
        if not self._staged(ctx):
            return ctx.bucket_reduce_scatter(flat, ReduceOp.AVG)
        return ctx.tier_allreduce(ctx.tier_reduce_scatter(flat, ReduceOp.AVG), ReduceOp.AVG)

    # ---- checkpoints --------------------------------------------------------

    def opt_shard_ranks(self, ctx: AlgorithmContext) -> int:
        return self._shard_comm(ctx).nranks()

    @staticmethod
    def _chunk_keys(opt_state: ZeroOptState):
        return [str(i) for i in range(len(opt_state.chunks))]

    def checkpoint_opt_state(self, opt_state: ZeroOptState):
        """This rank's shard: the optimizer's state over its chunk of each
        bucket (the chunks themselves are the parameters', which the
        checkpoint holds already), and the local leaves' optimizer state by
        name."""
        tree = {"optimizer": optimizer_state_tree(opt_state.optimizer,
                                                  self._chunk_keys(opt_state))}
        if opt_state.local is not None:
            tree["local"] = optimizer_state_tree(opt_state.local, list(opt_state.local_names))
        return tree

    def check_opt_state(self, opt_state: ZeroOptState, tree) -> None:
        from ..checkpoint import CheckpointIntegrityError

        if not isinstance(tree, dict) or "optimizer" not in tree:
            raise CheckpointIntegrityError("checkpoint holds no ZeRO optimizer shard")
        check_optimizer_state_tree(opt_state.optimizer, tree["optimizer"],
                                   self._chunk_keys(opt_state), "['opt_state']")
        for k, st in tree["optimizer"]["state"].items():
            chunk = opt_state.chunks[int(k)]
            for name, v in st.items():
                if torch.is_tensor(v) and v.dim() and v.shape != chunk.shape:
                    raise CheckpointIntegrityError(
                        f"ZeRO shard {k} holds {name} of shape {tuple(v.shape)}, the live chunk "
                        f"{tuple(chunk.shape)}")
        if (opt_state.local is None) != ("local" not in tree):
            raise CheckpointIntegrityError("the checkpoint's local leaves' ZeRO state does not "
                                           "match the live trainer's")
        if opt_state.local is not None:
            check_optimizer_state_tree(opt_state.local, tree["local"],
                                       list(opt_state.local_names), "['opt_state']['local']")

    def restore_opt_state(self, opt_state: ZeroOptState, tree):
        load_optimizer_state_tree(opt_state.optimizer, tree["optimizer"],
                                  self._chunk_keys(opt_state))
        if opt_state.local is not None:
            load_optimizer_state_tree(opt_state.local, tree["local"],
                                      list(opt_state.local_names))
        return opt_state

    # ---- overlap contract ---------------------------------------------------

    def reduce_bucket_grad(self, ctx: AlgorithmContext, index: int, flat):
        """One bucket's communication: the averaging reduce-scatter; returns
        this rank's chunk."""
        return self._avg_scatter(ctx, flat)

    def grads_from_reduced(self, ctx: AlgorithmContext, reduced, grads, algo_state, step):
        """The reduced chunks, for ``optimizer_update`` (``zero.py:240-250``)."""
        return ReducedChunks(tuple(reduced)), algo_state

    # ---- optimizer ----------------------------------------------------------

    def init_optimizer_state_sharded(self, ctx: AlgorithmContext, params) -> ZeroOptState:
        """One chunk tensor per bucket, holding this rank's chunk of the
        parameters (a view of the resident parameter flat, else a copy),
        and the optimizer over them; on the leaf layout, a second optimizer
        over the local leaves outside the plan, if any."""
        with torch.no_grad():
            chunks = [self._my_chunk(ctx, f) for f in ctx.bucket_flats(params)]
            if not ctx.flat_resident:
                chunks = [c.clone() for c in chunks]
        local = () if ctx.flat_resident else _local_names(ctx, params)
        return ZeroOptState(tuple(chunks), self.optimizer(chunks), local,
                            self.optimizer([params[n] for n in local]) if local else None)

    @torch.no_grad()
    def optimizer_update(self, ctx: AlgorithmContext, params, grads, opt_state: ZeroOptState,
                         algo_state, step):
        shard = self._shard_comm(ctx)
        if self.clip_global_norm is not None and opt_state.local_names:
            # the local slices live on model-parallel axes outside the
            # shard ranks, whose norm this one allreduce would miss
            raise NotImplementedError(
                "clip_global_norm with model-parallel (tp/pp/expert) leaves is not supported")
        if isinstance(grads, ReducedChunks):
            # the overlap scheduler issued the reduce-scatters from the backward
            gchunks = list(grads.chunks)
        else:
            gchunks = []
            for i, f in enumerate(ctx.bucket_flats(grads)):
                with recording_tag(i):   # the collective log's bucket
                    gchunks.append(self._avg_scatter(ctx, f))
        if self.clip_global_norm is not None:
            # the chunks over the shard ranks tile every flat once (staged:
            # replicated across nodes, so the intra-node sum is the whole
            # norm); the zero pad tail adds nothing
            ssq = sum(g.float().square().sum() for g in gchunks)
            gnorm = shard.allreduce(ssq, ReduceOp.SUM).sqrt()
            scale = torch.clamp(torch.full_like(gnorm, self.clip_global_norm) / (gnorm + 1e-12),
                                max=1.0)
            gchunks = [g * scale.to(g.dtype) for g in gchunks]
        pflats = ctx.bucket_flats(params)
        for chunk, pflat, g in zip(opt_state.chunks, pflats, gchunks):
            if not ctx.flat_resident:   # resident: the chunk is that view
                chunk.copy_(self._my_chunk(ctx, pflat))
            chunk.grad = g
        opt_state.optimizer.step()
        del gchunks   # no gradient chunk outlives the step
        flats = []
        for i, chunk in enumerate(opt_state.chunks):
            chunk.grad = None
            with recording_tag(i):
                flats.append(ctx.bucket_allgather(chunk) if shard is ctx.comm
                             else ctx.tier_allgather(chunk))
        if ctx.flat_resident:
            for pflat, value in zip(pflats, flats):
                pflat.copy_(value)
            return params, opt_state, algo_state
        for name, value in ctx.from_bucket_flats(flats).items():
            params[name].copy_(value)
        if opt_state.local is not None:
            # the replicated path: the module's own local leaves, stepped on
            # their dp-averaged gradients
            for n in opt_state.local_names:
                params[n].grad = grads[n]
            opt_state.local.step()
            for n in opt_state.local_names:
                params[n].grad = None
        return params, opt_state, algo_state


def _local_names(ctx: AlgorithmContext, params) -> Tuple[str, ...]:
    """The parameters outside the bucket plan (the model-parallel leaves),
    in the trainer's order."""
    planned = set(ctx.plan.tensor_names)
    return tuple(n for n in params if n not in planned)
