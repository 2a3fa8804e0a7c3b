"""BaguaTrainer: the data-parallel training step.

Port of the main path of ``bagua_tpu/core/backend.py``.  One step is: the
abort check, a state migration queued by :meth:`BaguaTrainer.rebucket`, the
algorithm's ``host_pre_step`` (async model average's boundary, where a round
is launched or applied), its ``need_reset`` (QAdam's phase switch), the
per-rank mean loss and its backward (``accum_steps`` microbatches, their
losses and gradients summed in order and divided by ``accum_steps``), an
armed ``grad.poison`` fault, the algorithm's ``process_grads`` (for
``GradientAllReduceAlgorithm``, one allreduce per bucket; under the overlap
scheduler the same per-bucket collectives issued from the backward, below),
its
``process_pre_step`` (the full-precision gossip exchange of the weights), the
optimizer step on the reduced gradients, its ``process_post_step`` (the
low-precision gossip ring), the gradient-health verdict, and the loss
averaged over the ranks.  The weight hooks' results, and whatever
``host_pre_step`` changes, go into the module's parameters in place.  An
algorithm that owns its optimizer (QAdam, ZeRO) gets no torch optimizer: its
``optimizer_update`` runs after ``process_grads`` (ZeRO's holds its
collectives, and its state is this rank's shard).  Where a stateful codec
(``onebit_ef``, ``topk``) rides the wire, ``state.algo_state["ef"]["buckets"]``
carries the error-feedback residual, one f32 flat per bucket.

Two layouts hold the training state.  The leaf layout keeps each parameter's
own storage, and the stages get gradients and weights as ``name -> tensor``
dicts that they flatten into bucket flats each step.  The flat-resident
layout (``flat_resident``) keeps one parameter flat a bucket for the whole
run: every module ``Parameter`` keeps its identity, but its storage is a view
of its bucket's parameter flat.  Its ``.grad`` is a view of the bucket's
gradient flat, into which autograd accumulates in place; the stages get the
flats themselves, and the optimizer steps the flats.  A gradient flat is
allocated when the backward reaches the first parameter of its bucket (a
hook on each parameter) and let go at the start of the next step, so that
the gradients grow bucket by bucket through the backward as the leaf
layout's do, rather than all being held from its start.

The overlap scheduler (``overlap``, ``core/overlap.py``) moves the
communication of the families that support it (``Algorithm.supports_overlap``)
into the backward.  On the resident layout a hook on every parameter marks a
bucket ready during the last microbatch's backward once all of its gradients
have accumulated; the bucket's flat is then divided by ``accum_steps``,
poisoned where ``grad.poison`` fires on it, compensated with the bucket's
error-feedback residual, and handed to the trainer's comm worker, which runs
the family's ``reduce_bucket_grad`` on its own stream while the backward goes
on.  A bucket the backward never reached goes after the backward, with its
zero flat.  The main thread waits for every bucket before the guard, the
optimizer and the loss allreduce, and hands the results to the family's
``grads_from_reduced``.  On the leaf layout the scheduler runs
``process_grads_bucketed`` after the backward.  Once a trainer, after its
first overlapped step, the plan is rebucketed in the order the hooks saw the
gradients arrive (rank 0's order, on every rank), so that the first bucket
issued is the first one finished.

PyTorch runs eagerly, so there is no compiled-step cache; the state is the
module and the optimizer, updated in place, rather than an immutable pytree.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .. import env
from ..algorithms.base import Algorithm, AlgorithmContext
from ..bucket import BucketPlan, relayout_flats, split_bucket_by_bucket_size
from ..communication import ReduceOp, abort, check_abort, get_backend
from ..compression.codecs import validate_codec_policy
from .overlap import CommWorker, OverlapStep
from ..device import resolve_device
from ..faults import inject as _inject
from ..telemetry import counters
from ..tensor import build_params

logger = logging.getLogger(__name__)

#: the flat-safety probe's verdict by optimizer factory (hashable factories
#: only), so that repeated trainers over one factory pay it once
_FLAT_SAFE_MEMO: Dict[Any, bool] = {}


def _optimizer_flattens_safely(factory) -> bool:
    """Whether the optimizer's update commutes with flattening, the
    precondition for stepping bucket flats (memoized; ``backend.py:72-127``)."""
    try:
        hash(factory)
        key = factory
    except TypeError:
        key = None
    if key is not None and key in _FLAT_SAFE_MEMO:
        return _FLAT_SAFE_MEMO[key]
    safe = _probe_flatten_safety(factory)
    if key is not None:
        _FLAT_SAFE_MEMO[key] = safe
    return safe


def _probe_flatten_safety(factory) -> bool:
    """Two updates of a 128 x 130 parameter must equal the same updates of
    its ravel: elementwise optimizers agree exactly, shape-aware ones
    (factored second moments, e.g. ``torch.optim.Adafactor``) differ from the
    first update on.  128 x 130 because factored moments engage only on
    dimensions of 128 and up in some optimizers, and full-rank pseudo-noise
    because a rank-1 pattern makes factored and full moments coincide.  On
    CPU tensors.  An optimizer the probe cannot run is reported unsafe: the
    leaf layout only costs the per-step flatten."""
    try:
        n = 128 * 130
        base = torch.sin(torch.arange(n, dtype=torch.float32) * 0.37) * 0.5
        p2 = nn.Parameter(base.reshape(128, 130).clone())
        p1 = nn.Parameter(base.clone())
        grads = [torch.cos(torch.arange(n, dtype=torch.float32) * k + k) * s
                 for k, s in ((0.11, 0.1), (0.41, 1.0))]
        o2, o1 = factory([p2]), factory([p1])
        for g in grads:
            p2.grad = g.reshape(128, 130).clone()
            o2.step()
            p1.grad = g.clone()
            o1.step()
        return bool(torch.allclose(p2.detach().reshape(-1), p1.detach(), rtol=1e-5, atol=1e-7))
    except Exception as e:  # optimizer-dependent
        logger.info("flat-safety probe could not run (%s); keeping the leaf layout", e)
        return False


def _tensors_in(obj, out: List[torch.Tensor], optimizers: List[torch.optim.Optimizer]):
    """Collect every tensor and every torch optimizer reachable through
    dicts, lists and tuples (named tuples included) of ``obj``."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, torch.optim.Optimizer):
        optimizers.append(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensors_in(v, out, optimizers)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _tensors_in(v, out, optimizers)


@dataclass
class TrainState:
    """The module (params), its optimizer (and thus the optimizer state),
    the algorithm's state and the step count.  ``train_step`` updates the
    module and optimizer in place and returns a new ``TrainState``.  For an
    algorithm that owns its optimizer, ``optimizer`` is None and
    ``opt_state`` holds the algorithm's optimizer state."""

    step: int
    model: nn.Module
    optimizer: Optional[torch.optim.Optimizer]
    algo_state: Any = None
    opt_state: Any = None


class BaguaTrainer:
    """Owns the bucket plan and drives the algorithm around each step.

    Args:
        loss_fn: ``loss_fn(model, batch) -> scalar tensor`` (per-rank mean).
        optimizer_factory: ``optimizer_factory(params) -> Optimizer``, e.g.
            ``functools.partial(torch.optim.AdamW, lr=1e-4)``; unused (and
            may be None) for an algorithm that owns its optimizer.  Under the
            flat-resident layout it is given the parameter flats, one
            ``nn.Parameter`` a bucket whose ``.grad`` is the reduced gradient
            flat, so per-parameter groups (a weight decay by name, say) are
            not available there; use ``flat_resident="off"`` for them.
        algorithm: a :class:`bagua_tpu_torch.algorithms.base.Algorithm`.
        device: where the model and batches live; ``cuda`` by default.
        bucket_bytes: bucket size in bytes (default env
            ``BAGUA_DEFAULT_BUCKET_SIZE``, 10 MiB).
        compress_intra: codec policy of the intra-node tier and the flat
            ring (default env ``BAGUA_COMPRESS_INTRA``, ``auto``): ``auto``
            keeps the family's own wire format, ``off`` forces full
            precision, a codec name (``minmax_uint8``, ``int8``,
            ``fp8_e4m3``, ``fp8_e5m2``, ``onebit_ef``, ``topk``) makes every
            bucket allreduce ride the compressed ring at world size > 1.
        compress_inter: codec policy of the inter-node tier of the
            hierarchical forms (default env ``BAGUA_COMPRESS_INTER``, same
            values).
        accum_steps: gradient accumulation.  Every batch tensor is split
            along dim 0 into ``accum_steps`` microbatches (``ValueError``
            when that does not divide); forward and backward run once a
            microbatch, the losses and gradients are summed in microbatch
            order and divided by ``accum_steps`` before any algorithm stage,
            and communication happens once a step, as if the whole batch had
            fit.
        flat_resident: the training-state layout (default env
            ``BAGUA_FLAT_RESIDENT``, ``auto``): ``on`` keeps params,
            gradients and optimizer state in the bucket plan's flats across
            steps (the module description above), ``off`` the leaf layout,
            ``auto`` the resident one wherever the family supports it
            (``Algorithm.supports_flat_resident`` and
            ``flat_resident_auto``) and the optimizer is elementwise.  A
            shape-aware optimizer keeps ``auto`` on the leaf layout and makes
            ``on`` raise at :meth:`init`.
        grad_guard: the gradient-health sentinel (default env
            ``BAGUA_GRAD_GUARD``, ``off``).  Every step takes a per-bucket
            ``isfinite`` verdict: on the reduced gradients where the family
            replicates them (no collective of its own), else on the updated
            parameters, combined over the ranks by a MIN allreduce (the
            gossip families keep one verdict a rank).  It is
            ``step_metrics["grad_healthy"]`` and
            ``step_metrics["grad_health_buckets"]``.  ``warn`` logs an
            unhealthy step; ``skip`` rewinds it (params, optimizer state and
            algorithm state keep their pre-step values exactly, while
            ``state.step`` advances) and aborts after ``grad_guard_budget``
            consecutive skips; ``abort`` raises the abort flag.  The
            counters, warnings and aborts act one step behind, at the next
            step or at :meth:`flush_grad_health`.
        grad_guard_budget: consecutive skipped steps before ``skip``
            escalates to an abort.
        overlap: the overlap scheduler (default env ``BAGUA_OVERLAP``,
            ``auto``): ``on`` issues each bucket's collective from the
            backward (the module description above) for every family that
            supports it (``Algorithm.supports_overlap``; ZeRO on the
            resident layout only), ``off`` keeps the serialized step,
            ``auto`` overlaps where the family's ``overlap_auto`` agrees and
            there is something to overlap: ``accum_steps > 1`` or a ring
            chunk target.  Families outside the contract never overlap.
        overlap_chunk_bytes: target bytes a rank of one ring sub-collective
            under the scheduler (default env ``BAGUA_OVERLAP_CHUNK_BYTES``,
            0: one collective a bucket); the bucket collectives then ride
            the chunked rings sized by
            :func:`~bagua_tpu_torch.communication.ring_chunks_for`.
        overlap_chunk_bytes_intra: the target of the intra-node tier and the
            flat ring (default env ``BAGUA_OVERLAP_CHUNK_BYTES_INTRA``, 0:
            ``overlap_chunk_bytes``).
        overlap_chunk_bytes_inter: the target of the inter-node tier
            (default env ``BAGUA_OVERLAP_CHUNK_BYTES_INTER``, 0:
            ``overlap_chunk_bytes``).
    """

    def __init__(
        self,
        loss_fn: Callable,
        optimizer_factory: Callable,
        algorithm: Algorithm,
        device=None,
        bucket_bytes: Optional[int] = None,
        compress_intra: Optional[str] = None,
        compress_inter: Optional[str] = None,
        accum_steps: int = 1,
        flat_resident: Optional[str] = None,
        grad_guard: Optional[str] = None,
        grad_guard_budget: int = 3,
        overlap: Optional[str] = None,
        overlap_chunk_bytes: Optional[int] = None,
        overlap_chunk_bytes_intra: Optional[int] = None,
        overlap_chunk_bytes_inter: Optional[int] = None,
    ):
        self.loss_fn = loss_fn
        self.optimizer_factory = optimizer_factory
        self.algorithm = algorithm
        self.device = resolve_device(device)
        self.bucket_bytes = (env.get_default_bucket_size()
                             if bucket_bytes is None else bucket_bytes)
        self.backend = get_backend()
        self.comm = self.backend.global_communicator
        self.world_size = self.comm.nranks()
        self.compress_intra = validate_codec_policy(
            env.get_compress_intra() if compress_intra is None else compress_intra,
            "compress_intra")
        self.compress_inter = validate_codec_policy(
            env.get_compress_inter() if compress_inter is None else compress_inter,
            "compress_inter")
        #: whether the error-feedback residual may be carried; whether it is
        #: is the algorithm's call (``Algorithm.ef_codec``)
        self._ef_enabled = not env.is_ef_residual_disabled()
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.accum_steps = int(accum_steps)
        self.flat_resident = (flat_resident or env.get_flat_resident_mode()).strip().lower()
        if self.flat_resident not in ("auto", "on", "off"):
            raise ValueError(f"flat_resident must be auto|on|off, got {flat_resident!r}")
        if self.flat_resident == "on" and not self._flat_supported():
            # "on" where the layout cannot hold the state is a user error,
            # never a silent fallback
            raise ValueError(
                f"flat_resident='on' is not supported here: {type(algorithm).__name__} "
                f"(supports_flat_resident={algorithm.supports_flat_resident}); use "
                "flat_resident='auto' or 'off'")
        self.grad_guard = (grad_guard or env.get_grad_guard_mode()).strip().lower()
        if self.grad_guard not in ("off", "warn", "skip", "abort"):
            raise ValueError(f"grad_guard must be off|warn|skip|abort, got {grad_guard!r}")
        if grad_guard_budget < 1:
            raise ValueError(f"grad_guard_budget must be >= 1, got {grad_guard_budget}")
        self.grad_guard_budget = int(grad_guard_budget)
        self.overlap = (overlap or env.get_overlap_mode()).strip().lower()
        if self.overlap not in ("auto", "on", "off"):
            raise ValueError(f"overlap must be auto|on|off, got {overlap!r}")
        chunks = {}
        for name, value, default in (
                ("overlap_chunk_bytes", overlap_chunk_bytes, env.get_overlap_chunk_bytes),
                ("overlap_chunk_bytes_intra", overlap_chunk_bytes_intra,
                 env.get_overlap_chunk_bytes_intra),
                ("overlap_chunk_bytes_inter", overlap_chunk_bytes_inter,
                 env.get_overlap_chunk_bytes_inter)):
            chunks[name] = int(default() if value is None else value)
            if chunks[name] < 0:
                raise ValueError(f"{name} must be >= 0, got {chunks[name]}")
        self.overlap_chunk_bytes = chunks["overlap_chunk_bytes"]
        self.overlap_chunk_bytes_intra = chunks["overlap_chunk_bytes_intra"]
        self.overlap_chunk_bytes_inter = chunks["overlap_chunk_bytes_inter"]
        #: the comm worker of the overlap scheduler (made at the first
        #: overlapped step), the hooks that drive it, the schedule of the
        #: backward in flight, and whether the readiness rebucket was done
        self._worker: Optional[CommWorker] = None
        self._overlap_hooks: list = []
        self._live_step: Optional[OverlapStep] = None
        #: the parameter names in the order their gradients arrived, recorded
        #: in the first overlapped step for the readiness rebucket
        self._grad_order: Optional[List[str]] = None
        self._overlap_ordered = False
        self._guard_skips = 0
        #: monotonic count of guard rewinds (never reset): async model
        #: average compares it across a round's flight to veto applying the
        #: round on a rewound state
        self._guard_rewinds_total = 0
        self._pending_health: list = []
        #: after each step under an active guard: ``grad_healthy``, the
        #: step's verdict, and ``grad_health_buckets``, one a bucket (device
        #: tensors: reading them synchronizes)
        self.step_metrics: Dict[str, Any] = {}
        self._ctx: Optional[AlgorithmContext] = None
        self._named_params = None
        self._params = None
        #: the resident layout is active (resolved by init())
        self._flat_resident = False
        #: resident layout: the parameter flats (what the optimizer steps)
        #: and this step's gradient flats (None until the backward reaches
        #: the bucket), and the hooks that allocate the latter
        self._flats: Optional[List[nn.Parameter]] = None
        self._grad_flats: Optional[List[Optional[torch.Tensor]]] = None
        self._grad_hooks: list = []
        self._grad_views_checked = False
        self._pending_state_migration: Optional[Callable] = None
        #: train_step calls on this trainer, the counter ``need_reset`` reads
        self._step_counter = 0

    @property
    def plan(self) -> BucketPlan:
        return self._ctx.plan

    @property
    def host_staged_bytes(self) -> int:
        """Bytes staged through the host for gloo so far, summed over the
        global and the two tier communicators and the algorithm's own
        (async model average's averaging group)."""
        comms = self.backend.communicators() + self.algorithm.communicators()
        return sum(c.host_staged_bytes for c in comms)

    def _ef_active(self) -> bool:
        """Whether this configuration carries the error-feedback residual in
        ``algo_state``."""
        return self._ctx is not None and self.algorithm.ef_codec(self._ctx) is not None

    # ---- overlap gate ----------------------------------------------------

    def _make_ctx(self, plan: BucketPlan, overlap: bool) -> AlgorithmContext:
        """The algorithm context of ``plan`` (``backend.py:633-650``): the
        chunk targets only under the overlap scheduler."""
        return AlgorithmContext(
            comm=self.comm, plan=plan, world_size=self.world_size,
            intra_codec=self.compress_intra, inter_codec=self.compress_inter,
            intranode=self.backend.intranode_communicator,
            internode=self.backend.internode_communicator,
            ef_enabled=self._ef_enabled, device=self.device,
            flat_resident=self._flat_resident, overlap=overlap,
            overlap_chunk_bytes=(self.overlap_chunk_bytes or None) if overlap else None,
            intra_chunk_bytes=(self.overlap_chunk_bytes_intra or None) if overlap else None,
            inter_chunk_bytes=(self.overlap_chunk_bytes_inter or None) if overlap else None)

    def _overlap_active(self) -> bool:
        """The overlap gate (``backend.py:715-755``): never for a family
        outside the contract, nor for a sharded-state family on the leaf
        layout (its communication runs inside ``optimizer_update`` there);
        explicit ``on``/``off`` win; ``auto`` overlaps where the family's
        ``overlap_auto`` agrees and there is an accumulation to overlap or a
        chunk target set."""
        algo = self.algorithm
        if not algo.supports_overlap:
            return False
        if algo.sharded_opt_state and not self._flat_resident:
            return False
        if self.overlap != "auto":
            return self.overlap == "on"
        return algo.overlap_auto and (self.accum_steps > 1 or self._any_chunk_bytes())

    def _any_chunk_bytes(self) -> bool:
        """Whether any ring chunk target is set: each opts into the rings."""
        return bool(self.overlap_chunk_bytes or self.overlap_chunk_bytes_intra
                    or self.overlap_chunk_bytes_inter)

    # ---- layout ----------------------------------------------------------

    def _flat_supported(self) -> bool:
        """Whether the resident layout can hold this configuration: the
        family implements it (the port has no model-parallel axes, whose
        sharded leaves would live outside the bucket plan)."""
        return self.algorithm.supports_flat_resident

    def _resolve_flat_resident(self) -> bool:
        """The layout of this ``init()`` (``backend.py:671-707``): explicit
        on/off win (``on`` on an unsupported family already raised); ``auto``
        takes the resident layout where the family supports it, its
        ``flat_resident_auto`` agrees and the optimizer commutes with
        flattening.  ``on`` with a shape-aware optimizer raises."""
        algo = self.algorithm
        if self.flat_resident == "off" or (self.flat_resident == "auto" and not (
                self._flat_supported() and algo.flat_resident_auto)):
            return False
        safe = algo.owns_optimizer or _optimizer_flattens_safely(self.optimizer_factory)
        if self.flat_resident == "on" and not safe:
            raise ValueError(
                "flat_resident='on' with an optimizer whose update does not commute with "
                "flattening (shape-aware, e.g. factored second moments): updating a matrix "
                "and updating its raveled vector disagree, so bucket-flat state would "
                "silently change the training math.  Use flat_resident='off' (or an "
                "elementwise optimizer).")
        if not safe:
            logger.info("flat_resident auto: the optimizer's update does not commute with "
                        "flattening (shape-aware?); keeping the leaf layout")
        return safe

    @torch.no_grad()
    def _lay_out(self, plan: BucketPlan, flats: List[torch.Tensor]) -> None:
        """Make ``flats`` (one a bucket of ``plan``, holding the parameters)
        the resident storage: every module parameter's data becomes a view of
        its parameter flat, and a hook on it allocates its bucket's gradient
        flat when the backward reaches it."""
        views = plan.unflatten(flats)
        for handle in self._grad_hooks:
            handle.remove()
        self._grad_hooks = []
        for i, b in enumerate(plan.buckets):
            for t in b.tensors:
                p = self._params[t.name]
                p.data = views[t.name]
                p.grad = None
                self._grad_hooks.append(p.register_hook(
                    functools.partial(_grad_ready, weakref.ref(self), i)))
        self._flats = [nn.Parameter(f, requires_grad=False) for f in flats]
        self._grad_flats = [None] * len(plan.buckets)
        self._grad_views_checked = False

    @torch.no_grad()
    def _alloc_grad_flat(self, i: int) -> torch.Tensor:
        b = self.plan.buckets[i]
        flat = b.zeros(self.device)
        for name, view in b.views(flat).items():
            self._params[name].grad = view
        self._grad_flats[i] = flat
        return flat

    def _stage_params(self):
        """The parameters as the stages take them: the flats (resident) or
        the module's parameters by name."""
        return tuple(self._flats) if self._flat_resident else self._params

    def _stage_grads(self):
        if self._flat_resident:
            # a bucket the backward never reached has a zero gradient
            return tuple(g if g is not None else self._alloc_grad_flat(i)
                         for i, g in enumerate(self._grad_flats))
        return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                for n, p in self._params.items()}

    # ---- state init ------------------------------------------------------

    def init(self, model: nn.Module) -> TrainState:
        """Move ``model`` to the trainer's device, give every rank rank 0's
        weights, build the bucket plan, lay the state out (resident flats or
        leaves) and build the optimizer (or the algorithm's optimizer
        state)."""
        model.to(self.device)
        with torch.no_grad():
            for p in model.parameters():
                dist.broadcast(p.data, src=0)
        algo = self.algorithm
        named = algo.init_tensors(build_params(model))
        self._named_params = named
        decls = [p.declaration() for p in named]
        plan = algo.tensors_to_buckets(
            split_bucket_by_bucket_size(decls, self.bucket_bytes), named, self.world_size)
        self._flat_resident = self._resolve_flat_resident()
        self._ctx = self._make_ctx(plan, self._overlap_active())
        self._params = dict(model.named_parameters())
        if self._flat_resident:
            with torch.no_grad():
                self._lay_out(plan, plan.flatten(self._params))
        for handle in self._overlap_hooks:
            handle.remove()
        self._overlap_hooks = []
        if self._ctx.overlap:
            self._overlap_hooks = [
                p.register_post_accumulate_grad_hook(
                    functools.partial(_grad_accumulated, weakref.ref(self), name))
                for name, p in self._params.items()]
        params = self._stage_params()
        with torch.no_grad():
            algo_state = algo.init_state(self._ctx, params)
        if algo.owns_optimizer:
            opt_state = (algo.init_optimizer_state_sharded(self._ctx, params)
                         if algo.sharded_opt_state else algo.init_optimizer_state(params))
            return TrainState(0, model, None, algo_state, opt_state)
        optimizer = self.optimizer_factory(list(params) if self._flat_resident
                                           else model.parameters())
        return TrainState(0, model, optimizer, algo_state)

    def shard_batch(self, local_batch: Mapping) -> dict:
        """This rank's batch on the trainer's device.  Each rank feeds its
        own slice of the global batch, as each reference rank feeds its own
        DataLoader split."""
        def put(x):
            if not isinstance(x, torch.Tensor):
                x = torch.tensor(np.asarray(x))
            return x.to(self.device, non_blocking=True)

        return {k: put(v) for k, v in local_batch.items()}

    def unstack_params(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """The parameters by name as tensors of their own (for eval,
        checkpoints, user code), whatever the layout: this rank's copy."""
        return {n: p.detach().clone() for n, p in state.model.named_parameters()}

    # ---- step ------------------------------------------------------------

    def _microbatches(self, batch) -> List[Dict[str, torch.Tensor]]:
        """``batch`` split along dim 0 into ``accum_steps`` equal parts."""
        accum = self.accum_steps
        if accum == 1:
            return [batch]
        for x in batch.values():
            if x.shape[0] % accum:
                raise ValueError(f"batch leading dim {x.shape[0]} is not divisible by "
                                 f"accum_steps={accum}")
        parts = {k: torch.chunk(x, accum, dim=0) for k, x in batch.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(accum)]

    def _forward_backward(self, model: nn.Module, batch,
                          overlap_step: Optional[OverlapStep] = None) -> torch.Tensor:
        """The loss of this rank's batch and its gradients in the
        parameters' ``.grad`` (resident: accumulated in place into the
        gradient flats, allocated as the backward reaches them), summed over
        the microbatches in order and divided by ``accum_steps``.  With
        ``overlap_step`` the last microbatch's backward drives it through the
        hooks, and the division is the scheduler's, bucket by bucket (the
        same arithmetic).  In the first overlapped step that may rebucket,
        the hooks also record the order the gradients arrive in."""
        for p in self._params.values():
            p.grad = None
        if self._flat_resident:
            self._grad_flats = [None] * len(self._grad_flats)
        loss = None
        mbs = self._microbatches(batch)
        observe = (self._ctx.overlap and not self._overlap_ordered
                   and not self.algorithm.sharded_opt_state)
        for k, mb in enumerate(mbs):
            mb_loss = self.loss_fn(model, mb)
            if k == len(mbs) - 1:
                self._live_step = overlap_step
                self._grad_order = [] if observe else None
            try:
                mb_loss.backward()
            finally:
                self._live_step = None
            loss = mb_loss.detach() if loss is None else loss + mb_loss.detach()
        if self._flat_resident and not self._grad_views_checked:
            self._check_grad_views()
        if self.accum_steps > 1:
            loss = loss / self.accum_steps
            if overlap_step is None:
                with torch.no_grad():
                    grads = (self._grad_flats if self._flat_resident else
                             [p.grad for p in self._params.values()])
                    for g in grads:
                        if g is not None:
                            g.div_(self.accum_steps)
        return loss

    @torch.no_grad()
    def _finalize_bucket(self, fires, algo_state, residuals, i: int) -> torch.Tensor:
        """Bucket ``i``'s flat as the overlap scheduler sends it, from the
        backward: its gradient flat (zero where the backward never reached
        it) divided by ``accum_steps``, an armed ``grad.poison`` on it, then
        folded with its error-feedback residual, whose new value goes to
        ``residuals[i]``: the serialized step's order, one bucket at a
        time."""
        flat = self._grad_flats[i]
        if flat is None:
            flat = self._alloc_grad_flat(i)
        if self.accum_steps > 1:
            flat.div_(self.accum_steps)
        for spec in fires:
            b, bad = self._poison_target(spec)
            if b == i:
                flat[0] = bad
        flat, residuals[i] = self.algorithm.compensate_flat(self._ctx, i, flat, algo_state)
        return flat

    def _comm_worker(self) -> CommWorker:
        if self._worker is None:
            self._worker = CommWorker(self.device)
            weakref.finalize(self, self._worker.close)
        return self._worker

    def _overlap_step(self, state: TrainState, fires):
        """The schedule of this step's backward (resident layout), and the
        list its buckets' new error-feedback residuals go to."""
        algo, ctx = self.algorithm, self._ctx
        residuals: List[Optional[torch.Tensor]] = [None] * len(self.plan.buckets)
        order = ctx.bucket_launch_order(algo.hierarchical, dcn_codec=algo.wire_codec_dcn)
        step = OverlapStep(
            self._comm_worker(), self.plan, order,
            functools.partial(self._finalize_bucket, fires, state.algo_state, residuals),
            functools.partial(algo.reduce_bucket_grad, ctx))
        return step, residuals

    def _wait_overlap(self, step: OverlapStep) -> List[torch.Tensor]:
        """The main thread's wait after the backward: every bucket's result,
        the worker's failure raised here, and no step once aborted."""
        reduced = step.wait()
        check_abort()
        return reduced

    def _rebucket_by_readiness(self, order: List[str]) -> None:
        """Rebucket the plan in the order its gradients arrived
        (``backend.py:757-781``), rank 0's order on every rank, so that
        every rank keeps one plan; tensors that got no gradient keep their
        plan order at the end.  The migration runs at the next step."""
        names = self.plan.tensor_names
        index = {n: i for i, n in enumerate(names)}
        seen = [index[n] for n in dict.fromkeys(order)]
        perm = seen + [i for i in range(len(names)) if i not in set(seen)]
        perm = self.comm.broadcast(torch.tensor(perm, dtype=torch.int64, device=self.device),
                                   0).tolist()
        decls = {p.name: p.declaration() for p in self._named_params}
        before = len(self.plan.buckets)
        self.rebucket(split_bucket_by_bucket_size([decls[names[i]] for i in perm],
                                                  self.bucket_bytes))
        logger.info("overlap: rebucketed %d tensors by gradient readiness (%d -> %d buckets)",
                    len(names), before, len(self.plan.buckets))

    def _check_grad_views(self) -> None:
        """After the first backward: every gradient of a bucket the backward
        reached must be the view of its gradient flat that autograd
        accumulated into (a ``zero_grad(set_to_none=True)`` inside the loss
        function, say, would have replaced it)."""
        for b, flat in zip(self.plan.buckets, self._grad_flats):
            if flat is None:
                continue
            for t, off in zip(b.tensors, b.offsets()):
                g = self._params[t.name].grad
                if g is None or g.data_ptr() != flat[off:].data_ptr():
                    raise RuntimeError(
                        f"the gradient of {t.name} no longer lies in its bucket's gradient "
                        "flat under flat_resident: something replaced the .grad view")
        self._grad_views_checked = True

    def train_step(self, state: TrainState, batch) -> Tuple[TrainState, torch.Tensor]:
        """One step; returns the new state and the loss averaged over ranks."""
        check_abort()   # no new step once a rank flagged an abort
        if self._pending_state_migration is not None:
            # a rebucket's migration, applied before the step consumes it
            state = self._pending_state_migration(state)
            self._pending_state_migration = None
        algo, ctx, guard = self.algorithm, self._ctx, self.grad_guard
        self._step_counter += 1
        # the boundary between steps, before the phase switch, as in the
        # JAX trainer
        with torch.no_grad():
            state = algo.host_pre_step(self, state)
        model, optimizer = state.model, state.optimizer
        # the phase switch (QAdam's warmup boundary) on the trainer's own
        # step count, at the top of the step, as the JAX trainer does
        algo.need_reset(self._step_counter - 1)
        model.train()
        poison = _inject.armed_traced_specs("grad.poison")
        fires = [s for s in poison if self._poison_fires(s, state.step)]
        for spec in fires:
            _inject.note_traced_fire(spec)
        params = self._stage_params()
        replicated_health = algo.grad_health_replicated
        if ctx.overlap and self._flat_resident:
            overlap_step, residuals = self._overlap_step(state, fires)
            try:
                loss = self._forward_backward(model, batch, overlap_step)
                overlap_step.submit_pending()
            except BaseException as e:   # re-raised once the worker is idle
                overlap_step.abandon(e)
                raise
            reduced = self._wait_overlap(overlap_step)
            grads = self._stage_grads()
            snapshot = (self._snapshot(state) if guard == "skip" and not replicated_health
                        else None)
            algo_state = algo.with_residuals(state.algo_state, residuals)
            grads, algo_state = algo.grads_from_reduced(ctx, reduced, grads, algo_state,
                                                        state.step)
        else:
            loss = self._forward_backward(model, batch)
            grads = self._stage_grads()
            if fires:
                # into the accumulated gradient, before any communication, so
                # the verdict sees what the collectives would spread
                self._apply_grad_poison(grads, fires)
            snapshot = (self._snapshot(state) if guard == "skip" and not replicated_health
                        else None)
            process = algo.process_grads_bucketed if ctx.overlap else algo.process_grads
            grads, algo_state = process(ctx, grads, params, state.algo_state, state.step)
        opt_state, health, rewind = state.opt_state, None, False
        if guard != "off" and replicated_health:
            # the reduced buckets are the same on every rank and a non-finite
            # contribution survives the sum: a verdict with no collective of
            # its own, read before any state changes
            health = self._grad_health_vec(grads)
            rewind = guard == "skip" and not self._healthy(health)
        if not rewind:
            # the gossip exchange: the gradient was taken at the weights
            # from before it and is applied to the exchanged weights
            algo_state = self._weight_hook(algo.process_pre_step, algo_state, state.step)
            if algo.owns_optimizer:
                _, opt_state, algo_state = algo.optimizer_update(
                    ctx, params, grads, opt_state, algo_state, state.step)
            else:
                self._optimizer_step(optimizer, grads)
            algo_state = self._weight_hook(algo.process_post_step, algo_state, state.step)
            if guard != "off" and not replicated_health:
                # every elementwise update carries a non-finite gradient into
                # its parameter; the family's own collectives spread it, the
                # MIN makes the verdict one for all ranks, except for the
                # gossip families, whose ranks each rewind their own weights
                health = self._grad_health_vec(self._stage_params())
                if algo.replicated_params:
                    health = self.comm.allreduce(health, ReduceOp.MIN)
                if snapshot is not None and not self._healthy(health):
                    self._restore(snapshot)
                    rewind = True
        if rewind:
            algo_state, opt_state = state.algo_state, state.opt_state
        loss = self.comm.allreduce(loss.clone(), ReduceOp.AVG)
        if health is not None:
            self.step_metrics = {"grad_healthy": health.min(), "grad_health_buckets": health}
            self._note_step_health(health)
        if self._grad_order is not None:
            order, self._grad_order = self._grad_order, None
            self._overlap_ordered = True
            self._rebucket_by_readiness(order)
        return TrainState(state.step + 1, model, optimizer, algo_state, opt_state), loss

    def _optimizer_step(self, optimizer, grads) -> None:
        """The torch optimizer's step on the reduced gradients: each
        parameter's ``.grad`` (leaf), or each flat's (resident;
        none afterwards, so that no reduced copy outlives the step)."""
        if self._flat_resident:
            for f, g in zip(self._flats, grads):
                f.grad = g
            optimizer.step()
            for f in self._flats:
                f.grad = None
        else:
            for n, g in grads.items():
                self._params[n].grad = g
            optimizer.step()

    @torch.no_grad()
    def _weight_hook(self, hook, algo_state, step):
        """Run a weight hook (``process_pre_step``, ``process_post_step``)
        outside autograd, copy the weights it returns into the module's
        parameters (or the resident flats) in place (the optimizer keys its
        state by those objects) and return the algorithm state."""
        params, algo_state = hook(self._ctx, self._stage_params(), algo_state, step)
        if self._flat_resident:
            for f, t in zip(self._flats, params):
                if t is not f:
                    f.copy_(t)
            return algo_state
        for n, t in params.items():
            p = self._params[n]
            if t is not p:
                p.copy_(t)
        return algo_state

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch) -> torch.Tensor:
        """Forward-only loss of this rank's weights (the gossip families'
        differ between ranks) averaged over the ranks; the state is
        untouched."""
        state.model.eval()
        loss = self.loss_fn(state.model, batch)
        return self.comm.allreduce(loss.detach().clone(), ReduceOp.AVG)

    # ---- gradient-health sentinel ----------------------------------------

    @staticmethod
    def _poison_fires(spec, step: int) -> bool:
        """The JAX package's window of a traced fault: ``step=K`` fires at
        step K exactly, ``step=None`` on the first ``count`` steps (every
        step when ``count < 0``)."""
        if spec.step is not None:
            return step == spec.step
        return spec.count < 0 or step < spec.count

    @torch.no_grad()
    def _apply_grad_poison(self, grads, specs) -> None:
        """``grad.poison``: the first element of the target bucket's
        gradient becomes NaN (or inf) (``backend.py:1288-1322``)."""
        for spec in specs:
            b, bad = self._poison_target(spec)
            if self._flat_resident:
                grads[b][0] = bad
            else:
                grads[self.plan.buckets[b].tensors[0].name].view(-1)[0] = bad

    def _poison_target(self, spec) -> Tuple[int, float]:
        """The bucket a ``grad.poison`` spec hits and the value it writes."""
        return (spec.bucket % max(1, len(self.plan.buckets)),
                float("nan") if spec.kind == "nan" else float("inf"))

    @torch.no_grad()
    def _grad_health_vec(self, tensors) -> torch.Tensor:
        """Per-bucket finiteness of ``tensors`` (the flats, or tensors by
        name) as an f32 vector on the device: 1.0 where every element of
        the bucket is finite."""
        if isinstance(tensors, dict):
            flags = [torch.stack([torch.isfinite(tensors[t.name]).all() for t in b.tensors]).all()
                     for b in self.plan.buckets]
        else:
            flags = [torch.isfinite(f).all() for f in tensors]
        return torch.stack(flags).float()

    @staticmethod
    def _healthy(health: torch.Tensor) -> bool:
        return bool(health.min().item() > 0.5)

    def _snapshot(self, state: TrainState):
        """Copies of everything a step may change in place: the parameters,
        every tensor of the optimizer state and of the algorithm state, and
        each torch optimizer's state (a view of a parameter's storage, such
        as ZeRO's resident chunk, is covered by the parameter's copy)."""
        tensors: List[torch.Tensor] = []
        optimizers: List[torch.optim.Optimizer] = []
        params = list(self._stage_params()) if self._flat_resident else list(self._params.values())
        _tensors_in([state.optimizer, state.opt_state, state.algo_state], tensors, optimizers)
        storages = {p.untyped_storage().data_ptr() for p in params}
        seen, kept = set(), []
        for t in tensors:
            key = t.untyped_storage().data_ptr()
            if key not in storages and id(t) not in seen:
                seen.add(id(t))
                kept.append(t)
        with torch.no_grad():
            copies = [(t, t.detach().clone()) for t in params + kept]
            opts = [(o, {p: {k: (v.clone() if torch.is_tensor(v) else v)
                             for k, v in st.items()} for p, st in o.state.items()})
                    for o in optimizers]
        return copies, opts

    @staticmethod
    @torch.no_grad()
    def _restore(snapshot) -> None:
        copies, opts = snapshot
        for t, c in copies:
            t.copy_(c)
        for o, st in opts:
            o.state.clear()
            o.state.update(st)

    def _note_step_health(self, health) -> None:
        """Queue this step's verdict and act on the ones before it: the
        host policy runs one step behind (``backend.py:2180-2189``)."""
        self._pending_health.append((self._step_counter, health))
        while len(self._pending_health) > 1:
            self._consume_health(*self._pending_health.pop(0))

    def flush_grad_health(self) -> None:
        """Act on every verdict not inspected yet; call at the end of a
        training loop so that the last step's verdict is acted on too."""
        while self._pending_health:
            self._consume_health(*self._pending_health.pop(0))

    def _consume_health(self, step_no: int, health) -> None:
        """The host policy on one step's verdict (``backend.py:2209-2307``):
        counters, ``warn``, ``abort`` and the skip budget."""
        hv = health.cpu().numpy()
        if hv.min() > 0.5:
            self._guard_skips = 0
            return
        bad = [i for i, v in enumerate(hv) if v <= 0.5]
        counters.incr("grad_guard/unhealthy_steps")
        abort_msg = None
        if self.grad_guard == "warn":
            logger.warning(
                "grad guard: step %d produced non-finite gradients (buckets %s): policy "
                "'warn': the update was APPLIED and the state is now poisoned; use "
                "BAGUA_GRAD_GUARD=skip to rewind such steps", step_no, bad)
        elif self.grad_guard == "abort":
            counters.incr("grad_guard/aborts")
            # later verdicts describe steps on the poisoned state
            self._pending_health.clear()
            abort_msg = f"grad guard: step {step_no} produced non-finite gradients (buckets {bad})"
        elif self.grad_guard == "skip":
            self._guard_skips += 1
            self._guard_rewinds_total += 1
            counters.incr("grad_guard/skipped_steps")
            _inject.record_recovery("grad.poison")
            logger.warning(
                "grad guard: step %d produced non-finite gradients (buckets %s): step "
                "rewound (params/opt state untouched; %d/%d consecutive skips)", step_no,
                bad, self._guard_skips, self.grad_guard_budget)
            if self._guard_skips >= self.grad_guard_budget:
                counters.incr("grad_guard/aborts")
                self._pending_health.clear()
                abort_msg = (
                    f"grad guard: {self._guard_skips} consecutive unhealthy steps reached the "
                    f"skip budget ({self.grad_guard_budget}): systematic divergence, not a "
                    "transient bad batch")
        if abort_msg is not None:
            abort(abort_msg)

    # ---- rebucketing -----------------------------------------------------

    def rebucket(self, decl_buckets) -> None:
        """Apply new bucket boundaries (an autotune bucketing suggestion,
        ``backend.py:895-924``).  Under the resident layout, or with the
        error-feedback residual, the state is laid out in the old plan's
        flats, so a plan change queues a flat-to-flat migration
        (:func:`~bagua_tpu_torch.bucket.relayout_flats`) that the next
        :meth:`train_step` applies before the step."""
        if self.algorithm.sharded_opt_state:
            raise ValueError("cannot rebucket: the algorithm's optimizer state is sharded per "
                             "bucket and would be invalidated by new bucket boundaries")
        old_plan = self._ctx.plan
        self._ctx.plan = self.algorithm.tensors_to_buckets(
            decl_buckets, self._named_params, self.world_size)
        if ((self._flat_resident or self._ef_active())
                and old_plan.signature() != self._ctx.plan.signature()):
            self._queue_state_migration(self._make_flat_migration(old_plan, self._ctx.plan))

    def _queue_state_migration(self, fn) -> None:
        """Compose ``fn`` after the migration already queued."""
        prev = self._pending_state_migration
        self._pending_state_migration = fn if prev is None else (lambda s: fn(prev(s)))

    def _make_flat_migration(self, old_plan: BucketPlan, new_plan: BucketPlan):
        @torch.no_grad()
        def migrate(state: TrainState) -> TrainState:
            logger.info("flat-resident relayout: migrating training state %d -> %d buckets",
                        len(old_plan.buckets), len(new_plan.buckets))
            opt_state = state.opt_state
            if self._flat_resident:
                old_flats = self._flats
                self._lay_out(new_plan, relayout_flats(old_plan, new_plan,
                                                       [f.data for f in old_flats]))
                if state.optimizer is not None:
                    self._relayout_optimizer(state.optimizer, old_flats, old_plan, new_plan)
                opt_state = _relayout_container(opt_state, old_plan, new_plan)
            algo_state = self.algorithm.relayout_algo_state(old_plan, new_plan,
                                                            state.algo_state)
            return dataclasses.replace(state, opt_state=opt_state, algo_state=algo_state)

        return migrate

    def _relayout_optimizer(self, opt, old_flats, old_plan, new_plan) -> None:
        """Move a torch optimizer from the old parameter flats onto the new
        ones: its parameter group, and its state, keyed by the flat objects:
        every tensor shaped like its flat (AdamW's moments) through
        ``relayout_flats``, anything else (the step count) copied."""
        if len(opt.param_groups) != 1:
            raise ValueError("rebucket under flat_resident needs an optimizer with one "
                             f"parameter group, got {len(opt.param_groups)}")
        old = [opt.state.get(f, {}) for f in old_flats]
        new: List[dict] = [{} for _ in new_plan.buckets]
        for key in sorted({k for st in old for k in st}):
            values = [st.get(key) for st in old]
            if all(torch.is_tensor(v) and v.shape == (b.padded_numel,)
                   for v, b in zip(values, old_plan.buckets)):
                for st, v in zip(new, relayout_flats(old_plan, new_plan, values)):
                    st[key] = v
            else:
                for st in new:
                    st[key] = values[0].clone() if torch.is_tensor(values[0]) else values[0]
        opt.state.clear()
        for f, st in zip(self._flats, new):
            if st:
                opt.state[f] = st
        opt.param_groups[0]["params"] = list(self._flats)


def _grad_ready(trainer_ref, i: int, grad) -> None:
    """Hook on a parameter of bucket ``i``, run before autograd accumulates
    its gradient: the first one of the bucket allocates the bucket's zero
    gradient flat and makes every ``.grad`` of the bucket a view of it, so
    that autograd accumulates into the flat in place.  It holds the trainer
    weakly: the model's parameters would otherwise keep the trainer, its
    flats and its optimizer alive in a cycle until a garbage collection."""
    trainer = trainer_ref()
    if trainer is not None and trainer._grad_flats[i] is None:
        trainer._alloc_grad_flat(i)


def _grad_accumulated(trainer_ref, name: str, param) -> None:
    """Hook on parameter ``name``, run after autograd accumulated its
    gradient (on the card, in autograd's backward thread): in the last
    microbatch of an overlapped step it records the arrival and hands it to
    the step's schedule.  It holds the trainer weakly, as
    :func:`_grad_ready` does."""
    trainer = trainer_ref()
    if trainer is None:
        return
    if trainer._grad_order is not None:
        trainer._grad_order.append(name)
    if trainer._live_step is not None:
        trainer._live_step.on_grad(name)


def _relayout_container(obj, old_plan: BucketPlan, new_plan: BucketPlan):
    """``obj`` (an algorithm's optimizer state) with every sequence of one
    flat a bucket of ``old_plan`` moved onto ``new_plan``; other parts kept."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_relayout_container(v, old_plan, new_plan) for v in obj))
    if isinstance(obj, (list, tuple)):
        if len(obj) == len(old_plan.buckets) and all(
                torch.is_tensor(t) and t.shape[-1:] == (b.padded_numel,)
                for t, b in zip(obj, old_plan.buckets)):
            return type(obj)(relayout_flats(old_plan, new_plan, obj))
        return type(obj)(_relayout_container(v, old_plan, new_plan) for v in obj)
    if isinstance(obj, dict):
        return {k: _relayout_container(v, old_plan, new_plan) for k, v in obj.items()}
    return obj
