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

Expert, sequence, tensor and pipeline parallelism (``mesh``,
``expert_axis``, ``seq_axis``, ``tp_axis``, ``pp_axis``;
``backend.py:336-404``) run their model-side collectives inside the forward
and backward (``MoEMLP``, ring and Ulysses attention, the tensor-parallel
conjugates, the pipeline's transfers, each over its axis's process group of
the mesh).  The bucket collectives span the comm axes ``dp + ep + sp + pp``
(``backend.py:393-404``): the global communicator where they cover the mesh,
else the communicator of their sub-world (``Mesh.comm``), a rank alone on a
tensor-parallel-only mesh.  The leaves that differ between ranks stay out of
the bucket plan: the expert tables, divided by ``ep_size`` (the all-to-all
backward already summed every ep peer's contribution into the owner's
table), and the tensor- and pipeline-sharded leaves, complete on their
shard, are averaged over dp (+ sp) after the backward, on that group's
communicator (``backend.py:1532-1562``).  Under pipeline parallelism the
replicated leaves' gradients are partial on each stage; they are multiplied
by ``pp_size`` before the bucket reduction, whose average over a world that
spans pp is then their sum (``backend.py:1456-1465``).

PyTorch runs eagerly, so there is no compiled-step cache; the state is the
module and the optimizer, updated in place, rather than an immutable pytree.

The observability plane (``BAGUA_OBS``, on by default; ``bagua_tpu_torch.obs``)
rides the step on the host: the ``step/*`` and ``trace/*`` spans, the
goodput ledger's windows, the step cadence, ``obs/mfu`` (the model flops
counted in the first step of each step key, ``obs/flops.py``), the anomaly
detector, the static footprint and a live memory poll on the beacon's 2 s
cadence, the ``StepProfiler`` window (``BAGUA_PROFILE_DIR``) and the grad
guard's flight record.  It adds no device synchronization to the step: the
parameters are bitwise equal with it on and off.  The JAX package's step
key names a compiled program; here it is the plan, the algorithm's phase
and the layout, and the first step of each key is the ``step/build``
window that the ledger books as ``compile`` (it builds the kernels, imports
``torch._dynamo`` at the first optimizer and autotunes cuBLAS).

Autotune (``autotune``, ``model_name``; ``backend.py:2505-3160``): the
trainer registers its plan's tensors with the autotune service at
:meth:`BaguaTrainer.init` and applies the first recommendation before the
state is built; every 100th step it reports its windowed speed, goodput
window and perf hints and applies the round's recommendation (the service
gives every rank the same one).  A rebucket, a family switch (QAdam's
optimizer-ownership migration, async's catch-up average on the way out), a
codec flip (the error-feedback residual added or dropped), a flat-residency
flip or an overlap change each queue a migration that the same step applies
before it runs; the context is rebuilt from the knobs.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import logging
import time
import weakref
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .. import env
from ..algorithms.base import Algorithm, AlgorithmContext
from ..bucket import BucketPlan, relayout_flats, split_bucket_by_bucket_size
from ..checkpoint import (CheckpointIntegrityError, RankedState, apply_tree,
                          check_optimizer_state_tree, check_train_state, check_tree,
                          compute_state_digest, copy_tree, load_optimizer_state_tree,
                          optimizer_state_tree, restore_train_state, to_tree)
from ..communication import (ReduceOp, SelfCommunicator, abort, check_abort, get_backend,
                             recording_tag)
from ..compression.codecs import validate_codec_policy
from .overlap import CommWorker, OverlapStep
from ..device import resolve_device
from ..faults import inject as _inject
from ..model_parallel.moe.layer import is_expert_param
from ..obs import flops as _obs_flops
from ..obs import spans as _obs_spans
from ..obs.spans import trace_span
from ..parallel.mesh import Mesh, get_global_mesh_if_set
from ..profiling import StepProfiler
from ..telemetry import counters
from ..tensor import build_params
from ..utils import StatisticalAverage

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
            not available there; use ``flat_resident="off"`` for them.  A
            :func:`~bagua_tpu_torch.contrib.fuse_optimizer` factory is
            unwrapped there (``backend.py:1063-1069``): the bucket flats
            already are a fused layout, so its ``fused_inner`` factory steps
            them (:attr:`opt_factory`); on the leaf layout the wrapper runs.
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
        mesh: the :class:`~bagua_tpu_torch.parallel.mesh.Mesh` of named rank
            axes (default: the global mesh where one is set, else the 1-D
            ``dp`` layout of every rank, with no groups of its own).
        dp_axes: the data-parallel axes (default: the mesh's ``dp``,
            ``inter`` and ``intra`` axes that are neither ``expert_axis``
            nor ``seq_axis``; the first axis where there is none and no
            model axis is given).
        expert_axis: the mesh axis of expert parallelism (MoE).  The expert
            tables leave the bucket plan and are averaged over the dp (+ sp)
            axes after a ``1 / ep_size`` rescale; the batch is split over dp
            x ep.  The layout stays the leaf one and the error-feedback
            residual is off, as in the JAX package.  ZeRO's and QAdam's
            optimizer state covers the expert tables as local leaves
            (``zero.py:245-351``); the ep axis folded into the comm axes
            leaves the tiers untiled, so ``hierarchical=True`` takes the flat
            path, as it does under ``seq_axis``.
        expert_params: which parameters are expert tables: a ``name ->
            bool`` callable or a collection of names (default: the exact
            names ``MoEMLP`` creates, ``is_expert_param``).
        expert_keyword: deprecated substring marking (warns).
        seq_axis: the mesh axis of sequence parallelism (ring attention,
            Ulysses).  Ranks along it take the same batch (each cuts its
            chunk, see ``sp_lm_loss_fn``) and the bucket collectives span
            it, which turns their partial gradients into the whole one.
        tp_axis: the mesh axis of tensor parallelism (``TransformerConfig(
            tp_axis=, tp_size=)``).  The tensor-parallel leaves (each rank's
            slice) leave the bucket plan and are averaged over dp (+ sp);
            the replicated leaves' gradients are whole and the same on the
            tp ranks (the model's conjugates), so the bucket collectives do
            not span tp, and the batch is not split over it.  Where the
            comm axes are the mesh's ``inter`` and ``intra`` axes, a
            hierarchical family runs the two-level form within each tp
            coordinate (hierarchical ZeRO refuses the leaf layout there, as
            in the JAX package).
        tp_param_dim: ``name -> dim`` of a parameter's GLOBAL tensor sharded
            over ``tp_axis`` (None: replicated); default the transformer's
            table, ``models.transformer.tp_param_dim``.
        pp_axis: the mesh axis of pipeline parallelism
            (``PipelinedTransformerLM``).  The stage-stacked leaves leave
            the plan as the tp slices do; the replicated ones (embedding,
            position table, final norm, head) get partial gradients on each
            stage, multiplied by ``pp_size`` before the bucket collectives,
            which span pp.  With ``tp_axis`` as well (3-D parallelism) a
            stacked tensor-parallel leaf carries both placements, its tp dim
            shifted past the stage dim.  Both axes keep the leaf layout and
            turn the error-feedback residual off, refuse ``expert_axis`` and
            the gossip families, as the JAX package does; pp in the comm
            axes sends a hierarchical family down the flat path.
        pp_param_dim: ``name -> dim`` of the stage stacking (0 for the
            pipeline's ``blocks`` leaves); default
            ``parallel.pipeline.pp_param_dim``.
        model_name: the autotune service's task this trainer reports to.
        autotune: check in with the autotune service (default: env
            ``BAGUA_AUTOTUNE`` >= 1; refused, with a warning, for a family
            whose optimizer state is sharded per bucket).  The trainer
            registers its tensors at :meth:`init` (with its capabilities,
            unless ``BAGUA_AUTOTUNE_SPACE=legacy``) and applies the
            service's first recommendation there; then every 100th step
            (``autotune_checkin_steps``) it reports its windowed speed
            (samples a second of the batches' dim 0, or
            :meth:`record_speed`'s counts) with its goodput
            window and the anomaly detector's perf hints, and applies the
            recommendation: a rebucket, a family switch, the codec, overlap
            and flat-resident knobs, each state migration queued for the
            step (:meth:`_apply_recommendation`).  Three failed check-ins
            in a row turn it off.  ``autotune_checkins`` keeps each
            check-in's speed, times and resulting bucket count.
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
        mesh: Optional[Mesh] = None,
        dp_axes: Optional[Tuple[str, ...]] = None,
        expert_axis: Optional[str] = None,
        expert_params=None,
        expert_keyword: Optional[str] = None,
        seq_axis: Optional[str] = None,
        tp_axis: Optional[str] = None,
        tp_param_dim: Optional[Callable[[str], Optional[int]]] = None,
        pp_axis: Optional[str] = None,
        pp_param_dim: Optional[Callable[[str], Optional[int]]] = None,
        model_name: str = "bagua_module",
        autotune: Optional[bool] = None,
    ):
        self.loss_fn = loss_fn
        self.optimizer_factory = optimizer_factory
        self.algorithm = algorithm
        self.device = resolve_device(device)
        self.bucket_bytes = (env.get_default_bucket_size()
                             if bucket_bytes is None else bucket_bytes)
        self.backend = get_backend()
        self._setup_mesh(mesh, dp_axes, expert_axis, expert_params, expert_keyword, seq_axis,
                         tp_axis, tp_param_dim, pp_axis, pp_param_dim)
        #: the bucket collectives' communicator: the comm axes' world
        self.comm = self._comm_over(self.comm_axes)
        self.world_size = self.comm.nranks()
        self.compress_intra = validate_codec_policy(
            env.get_compress_intra() if compress_intra is None else compress_intra,
            "compress_intra")
        self.compress_inter = validate_codec_policy(
            env.get_compress_inter() if compress_inter is None else compress_inter,
            "compress_inter")
        #: whether the error-feedback residual may be carried; whether it is
        #: is the algorithm's call (``Algorithm.ef_codec``)
        self._ef_enabled = (not env.is_ef_residual_disabled() and self.expert_axis is None
                            and self._shard_axis is None)
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
                f"(supports_flat_resident={algorithm.supports_flat_resident}) with tp/pp "
                f"axis={self._shard_axis!r}, expert axis={self.expert_axis!r}: model-parallel "
                "leaves live outside the bucket plan; use flat_resident='auto' or 'off'")
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
        #: the factory :meth:`init` built the optimizer with: a fused
        #: wrapper's ``fused_inner`` on the resident layout
        self.opt_factory: Optional[Callable] = None
        #: train_step calls on this trainer, the counter ``need_reset`` reads
        self._step_counter = 0
        #: the host cadence of the steps (``step.straggle``'s base): the
        #: previous step's entry, its seconds less the injected stalls in it
        self._last_step_mono: Optional[float] = None
        self._step_dt: Optional[float] = None
        self._last_straggle_sleep = 0.0
        # the hang watchdog (``backend.py:554-557``), on by default: each
        # step's and eval's result is handed to its waiter thread
        from ..watchdog import get_comm_timeout_s, get_global_watchdog

        timeout = get_comm_timeout_s()
        self._watchdog = get_global_watchdog(timeout) if timeout else None
        self._init_autotune(model_name, autotune)
        self._init_obs()

    def _init_autotune(self, model_name: str, autotune: Optional[bool]) -> None:
        """The autotune check-in's state (``backend.py:487-536``)."""
        self.model_name = model_name
        # the user's configured instances by family name, so that a switch
        # back to one of them restores their settings
        name = getattr(self.algorithm, "name", None)
        self._user_algorithms = {name: self.algorithm} if name else {}
        self.autotune = env.get_autotune_level() >= 1 if autotune is None else bool(autotune)
        if self.autotune and self.algorithm.sharded_opt_state:
            # a rebucket would orphan the per-bucket chunk states
            logger.warning("autotune disabled: %s shards optimizer state per bucket, which "
                           "autotune rebucketing would invalidate",
                           type(self.algorithm).__name__)
            self.autotune = False
        self._autotune_client = None
        #: steps between check-ins: the JAX package's 100; a harness that
        #: must see a decision in fewer steps sets it on the instance
        self.autotune_checkin_steps = 100
        self._autotune_failures = 0
        self._autotune_completed = not self.autotune
        #: the goodput ledger's cumulative classes at the last check-in
        self._autotune_ledger_prev = None
        self._telemetry_reported = False
        #: each check-in: its step, the speed reported, the ms of the
        #: synchronization, the report, the ask and the apply, and the
        #: buckets after it
        self.autotune_checkins: List[dict] = []
        #: a torch optimizer displaced by a switch to a family that owns its
        #: optimizer (QAdam): its state tree, layout and plan, for the way back
        self._stashed_opt_state = None
        #: whether init() has laid the state out: before, a flat_resident
        #: recommendation sets the mode; after, it queues a live migration
        self._flat_layout_live = False
        #: the plan the state is laid out under right now (behind
        #: ``self.plan`` between a rebucket and its migration)
        self._live_plan: Optional[BucketPlan] = None
        #: the throughput tracker behind the reported speed
        self._speed_tracker = StatisticalAverage()
        now = time.time()
        self._last_report_time = now
        self._last_speed_time = now
        self._prev_speed_time = now
        self._manual_speed = False
        self._skip_next_speed_sample = True

    def _init_obs(self) -> None:
        """The observability plane's state (``backend.py:560-618``),
        resolved once: the per-step hooks gate on ``_obs_enabled``, so
        ``BAGUA_OBS=off`` restores the exact pre-obs host behavior."""
        self._profiler = StepProfiler.from_env()
        self._obs_enabled = _obs_spans.enabled()
        self._last_beacon_write = 0.0
        #: the goodput ledger (fed from the cadence windows, the span sink,
        #: stall reports and the grad guard's rewinds), the card's peak
        #: FLOP/s (None off the listed cards: obs/mfu null-with-rationale)
        #: and the model flops of a step of the current key
        self._ledger = None
        self._peak_flops = None
        self._device_kind = (torch.cuda.get_device_name(self.device)
                             if self.device.type == "cuda" else str(self.device))
        self._mfu_flops: Optional[float] = None
        self._mfu_noted_unavailable = False
        #: the current step's window is a build or a state migration: the
        #: cadence hook books it there, not as productive_step
        self._ledger_window_class: Optional[str] = None
        self._footprint_noted = False
        self._mem_poll_dead = False
        self._mem_poll_failures = 0
        #: the step key (the plan object and the algorithm's phase) of the
        #: last step, and the phase count (``need_reset`` switches)
        self._step_key: Optional[tuple] = None
        self._phase = 0
        self.anomaly_detector = None
        if self._obs_enabled:
            from ..obs import export as _obs_export
            from ..obs import http as _obs_http
            from ..obs import ledger as _obs_ledger
            from ..obs import recorder as _obs_recorder

            _obs_export.maybe_start_global_exporter(self)
            # the per-process HTTP status plane (off unless
            # BAGUA_OBS_HTTP_PORT is set; the launcher offsets each worker's
            # port): /metrics serves the exporter's prepared snapshot
            _obs_http.maybe_start_global_http_server()
            _obs_recorder.maybe_install_signal_hook()
            self._ledger = _obs_ledger.install()
            self._peak_flops = _obs_ledger.peak_flops_for_device_kind(self._device_kind)
            if env.get_obs_anomaly_mode() == "on":
                from ..obs.anomaly import StepAnomalyDetector

                self.anomaly_detector = StepAnomalyDetector()
        #: host phase durations of the step being driven (dispatch,
        #: collective, optimizer), harvested when the next cadence sample
        #: closes its window; a build or migration window is skipped
        self._phase_durations: Dict[str, float] = {}
        self._anomaly_skip_window = False
        #: the model-flops counter of a build step's forward (else None)
        self._flop_counter = None

    def _setup_mesh(self, mesh, dp_axes, expert_axis, expert_params, expert_keyword,
                    seq_axis, tp_axis, tp_param_dim, pp_axis, pp_param_dim) -> None:
        """The mesh and its axes' roles, with the JAX trainer's checks
        (``backend.py:336-404``)."""
        algo = self.algorithm
        self._replica_comm, self._ep_size, self._pp_size = None, 1, 1
        self.mesh = mesh if mesh is not None else get_global_mesh_if_set()
        axis_names = self.mesh.axis_names if self.mesh is not None else ("dp",)
        # fail fast on typo'd axis names: silently nulling them would put the
        # expert tables into the dense plan and corrupt MoE training
        for label, ax in (("expert_axis", expert_axis), ("seq_axis", seq_axis),
                          ("tp_axis", tp_axis), ("pp_axis", pp_axis)):
            if ax is not None and ax not in axis_names:
                raise ValueError(f"{label}={ax!r} is not a mesh axis (mesh axes: {axis_names})")
        if tp_axis is not None or pp_axis is not None:
            label = "tp_axis" if tp_axis is not None else "pp_axis"
            if expert_axis is not None:
                raise NotImplementedError(f"combining {label} with expert_axis is not supported yet")
            if not algo.replicated_params:
                raise NotImplementedError(f"{label} requires a replicated-params algorithm "
                                          "(gossip state is per-rank)")
        self.expert_axis, self.seq_axis = expert_axis, seq_axis
        self.tp_axis, self.pp_axis = tp_axis, pp_axis
        if tp_param_dim is None and tp_axis is not None:
            from ..models.transformer import tp_param_dim
        if pp_param_dim is None and pp_axis is not None:
            from ..parallel.pipeline import pp_param_dim
        self._tp_param_dim, self._pp_param_dim = tp_param_dim, pp_param_dim
        self._expert_filter = self._make_expert_filter(expert_params, expert_keyword)
        model_axes = (expert_axis, seq_axis, tp_axis, pp_axis)
        if dp_axes is None:
            dp_axes = tuple(a for a in axis_names if a in ("dp", "inter", "intra")
                            and a not in model_axes)
            if not dp_axes and all(a is None for a in model_axes):
                dp_axes = (axis_names[0],)
        self.dp_axes = tuple(dp_axes)
        # the batch is split over dp and ep; sp's partial gradients and pp's
        # prescaled partial ones are summed by spanning their axes
        self.comm_axes = self.dp_axes + tuple(a for a in (expert_axis, seq_axis, pp_axis) if a)
        if all(a is None for a in model_axes):
            return
        if (expert_axis is not None or seq_axis is not None) and not algo.replicated_params:
            raise NotImplementedError(
                "expert/sequence parallelism with gossip (per-rank-weight) algorithms is not "
                "supported yet")
        if (algo.sharded_opt_state and getattr(algo, "hierarchical", False)
                and self._shard_axis is not None
                and self.mesh.size_of(self.comm_axes) == self.mesh.size_of(
                    [a for a in ("inter", "intra") if a in self.mesh.shape])
                and all(self.mesh.shape.get(a, 1) > 1 for a in ("inter", "intra"))):
            # the staged form's collectives span exactly inter x intra
            raise NotImplementedError(
                "hierarchical ZeRO supports the flat-resident (pure-dp) layout only; drop "
                "hierarchical=True when composing with tp/pp/expert axes")
        left = [a for a in axis_names
                if a not in self.comm_axes + (tp_axis,) and self.mesh.shape[a] > 1]
        if left:
            raise NotImplementedError(
                f"mesh axes {left} are none of the data, expert, sequence, tensor and pipeline "
                "axes the trainer was given")
        replica = self.dp_axes + ((seq_axis,) if seq_axis else ())
        self._replica_comm = self.mesh.comm(replica) if replica else None
        if expert_axis is not None:
            self._ep_size = self.mesh.shape[expert_axis]
        if pp_axis is not None:
            self._pp_size = self.mesh.shape[pp_axis]

    def _comm_over(self, axes):
        """The communicator of the ranks along ``axes``: the global one where
        they cover every mesh axis of more than one rank (or there is no
        mesh), else their group's, or this rank alone."""
        mesh = self.mesh
        if mesh is None or all(a in axes for a in mesh.axis_names if mesh.shape[a] > 1):
            return self.backend.global_communicator
        return mesh.comm(axes) or SelfCommunicator()

    @property
    def _shard_axis(self) -> Optional[str]:
        """The model-parallel axis (tp, else pp) where one is given: its
        leaves leave the bucket plan."""
        return self.tp_axis if self.tp_axis is not None else self.pp_axis

    def _shard_entries(self, name: str) -> Tuple[Tuple[int, str], ...]:
        """``((dim, axis), ...)``: the placements of a parameter
        (``backend.py:814-841``): the stage stacking at its dim, the tp slice
        at its dim, shifted one right past a stage dim (3-D parallelism)."""
        entries = []
        if self.pp_axis is not None:
            d = self._pp_param_dim(name)
            if d is not None:
                entries.append((d, self.pp_axis))
        if self.tp_axis is not None:
            d = self._tp_param_dim(name)
            if d is not None:
                entries.append((d + (1 if entries else 0), self.tp_axis))
        return tuple(entries)

    def _is_sharded(self, name: str) -> bool:
        return bool(self._shard_entries(name))

    @staticmethod
    def _make_expert_filter(expert_params, expert_keyword):
        """``backend.py:784-806``: a name filter, a collection of names, the
        deprecated keyword, or the exact names ``MoEMLP`` creates."""
        if expert_params is not None and expert_keyword is not None:
            raise ValueError("pass expert_params OR expert_keyword, not both")
        if expert_keyword is not None:
            import warnings

            warnings.warn("expert_keyword substring matching is deprecated; pass "
                          "expert_params (a name filter or collection of names)",
                          DeprecationWarning, stacklevel=4)
            return lambda name: expert_keyword in name
        if expert_params is None:
            return is_expert_param
        if callable(expert_params):
            return expert_params
        names = frozenset(expert_params)
        return lambda name: name in names

    def _is_expert_name(self, name: str) -> bool:
        return self.expert_axis is not None and self._expert_filter(name)

    def _expert_names(self) -> List[str]:
        return [n for n in self._params if self._is_expert_name(n)]

    def _local_names(self) -> List[str]:
        """The parameters outside the bucket plan, which differ between
        ranks (the JAX package's "local" leaves): the expert tables and the
        tensor- and pipeline-sharded leaves."""
        return [n for n in self._params if self._is_expert_name(n) or self._is_sharded(n)]

    @property
    def data_rank(self) -> int:
        """This rank's slice of the global batch: its index along dp x ep
        (the ranks of one sequence-, tensor- or pipeline-parallel group
        share it)."""
        if self.mesh is None or all(a is None for a in (self.expert_axis, self.seq_axis,
                                                        self.tp_axis, self.pp_axis)):
            return self.comm.rank()
        return self.mesh.index(self.dp_axes + ((self.expert_axis,) if self.expert_axis else ()))

    @property
    def data_world(self) -> int:
        """The number of distinct batch slices: the size of dp x ep."""
        if self.mesh is None or all(a is None for a in (self.expert_axis, self.seq_axis,
                                                        self.tp_axis, self.pp_axis)):
            return self.world_size
        return self.mesh.size_of(self.dp_axes + ((self.expert_axis,) if self.expert_axis else ()))

    @torch.no_grad()
    def _local_grads(self) -> Dict[str, torch.Tensor]:
        """The gradients of the leaves outside the plan, averaged over dp
        (+ sp) in one allreduce of their concatenation: an expert table's
        divided by ``ep_size`` first, a tensor- or pipeline-sharded leaf's as
        it is (complete on its shard)."""
        names = self._local_names()
        if not names:
            return {}
        grads = [(self._params[n].grad if self._params[n].grad is not None
                  else torch.zeros_like(self._params[n])) for n in names]
        # bagua: lint-ignore[per-step-reflatten] -- the few leaves outside the bucket plan (expert tables, tp/pp shards) ride one allreduce a step by design
        flat = torch.cat([g.reshape(-1) / (self._ep_size if self._is_expert_name(n) else 1)
                          for n, g in zip(names, grads)])
        if self._replica_comm is not None:
            flat = self._replica_comm.allreduce(flat, ReduceOp.AVG)
        out, off = {}, 0
        for n, g in zip(names, grads):
            out[n] = flat[off:off + g.numel()].view_as(g)
            off += g.numel()
        return out

    @property
    def plan(self) -> BucketPlan:
        return self._ctx.plan

    @property
    def host_staged_bytes(self) -> int:
        """Bytes staged through the host for gloo so far, summed over the
        global and the two tier communicators and the algorithm's own
        (async model average's averaging group)."""
        comms = self.backend.communicators() + self.algorithm.communicators()
        if self.mesh is not None:
            comms += [c for c in self.mesh.communicators() if all(c is not d for d in comms)]
        return sum(c.host_staged_bytes for c in comms)

    def _ef_active(self) -> bool:
        """Whether this configuration carries the error-feedback residual in
        ``algo_state``."""
        return self._ctx is not None and self.algorithm.ef_codec(self._ctx) is not None

    # ---- overlap gate ----------------------------------------------------

    def _tiers(self):
        """``(intranode, internode)``, the tier communicators of the
        algorithm context (``backend.py:491-493``).  Without a model axis,
        the backend's tiers where the buckets reduce over the whole world,
        else none.  On a model-parallel mesh, the mesh's own ``intra`` and
        ``inter`` axes, each within this rank's coordinates on the other
        axes (none without both axes).  They tile the bucket world only
        where the comm axes are exactly ``inter`` and ``intra`` (a tp mesh):
        an ep, sp or pp axis folded into the comm axes leaves
        ``two_tier()`` false, and a hierarchical family takes the flat
        path, as in the JAX package (``base.py:174-187``)."""
        if all(a is None for a in (self.expert_axis, self.seq_axis, self.tp_axis,
                                   self.pp_axis)):
            if self.comm is not self.backend.global_communicator:
                return None, None
            return self.backend.intranode_communicator, self.backend.internode_communicator
        if not all(a in self.mesh.shape for a in ("inter", "intra")):
            return None, None
        return self.mesh.comm(("intra",)), self.mesh.comm(("inter",))

    def _make_ctx(self, plan: BucketPlan, overlap: bool) -> AlgorithmContext:
        """The algorithm context of ``plan`` (``backend.py:633-650``): the
        chunk targets only under the overlap scheduler; the tiers of
        :meth:`_tiers`."""
        intranode, internode = self._tiers()
        return AlgorithmContext(
            comm=self.comm, plan=plan, world_size=self.world_size,
            intra_codec=self.compress_intra, inter_codec=self.compress_inter,
            intranode=intranode, internode=internode,
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
        """Whether the resident layout can hold this configuration
        (``backend.py:659-668``): the family implements it and every
        parameter is in the bucket plan, which the expert tables and the
        tensor- and pipeline-sharded leaves leave (so those keep the leaf
        layout; sequence parallelism does not change the plan)."""
        return (self.algorithm.supports_flat_resident and self.expert_axis is None
                and self._shard_axis is None)

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
        safe = algo.owns_optimizer or _optimizer_flattens_safely(self._flat_opt_factory())
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

    def _flat_opt_factory(self) -> Callable:
        """The factory that would step the flats: a fused wrapper's inner
        one (``backend.py:709-713``), else the trainer's."""
        inner = getattr(self.optimizer_factory, "fused_inner", None)
        return inner if inner is not None else self.optimizer_factory

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
        weights (a leaf outside the plan: the first rank's of the ranks that
        hold the same slice), build the bucket plan, lay the state out
        (resident flats or leaves) and build the optimizer (or the
        algorithm's optimizer state)."""
        model.to(self.device)
        self._params = dict(model.named_parameters())
        local = set(self._local_names())
        # the broadcasts block on gloo until every rank has joined: a rank
        # that hangs before its own must not hold the others forever
        watched = self._watchdog.watch("init:broadcast") if self._watchdog else nullcontext()
        with torch.no_grad(), watched:
            for n, p in self._params.items():
                if n not in local:
                    dist.broadcast(p.data, src=0)
                elif self._replica_comm is not None:
                    # an expert, tensor or pipeline shard: the same on its
                    # dp (+ sp) replicas
                    c = self._replica_comm
                    dist.broadcast(p.data, src=c._global_rank(0), group=c.group)
        algo = self.algorithm
        # the local leaves stay out of the bucket plan (``backend.py:843-856``)
        named = [p for p in algo.init_tensors(build_params(model)) if p.name not in local]
        self._named_params = named
        decls = [p.declaration() for p in named]
        plan = algo.tensors_to_buckets(
            split_bucket_by_bucket_size(decls, self.bucket_bytes), named, self.world_size)
        self._flat_layout_live = False
        if self.autotune and not self._autotune_completed:
            # the service's first recommendation lands before the state is
            # built, which is then built in its plan, family and layout: no
            # migration (``backend.py:1051-1055``)
            self._ctx = self._make_ctx(plan, False)
            self._autotune_register_tensors()
            self._pending_state_migration = None
            algo, plan = self.algorithm, self._ctx.plan
        self._flat_resident = self._resolve_flat_resident()
        self._ctx = self._make_ctx(plan, self._overlap_active())
        self._live_plan = plan
        if self._flat_resident:
            with torch.no_grad():
                self._lay_out(plan, plan.flatten(self._params))
        for handle in self._overlap_hooks:
            handle.remove()
        self._overlap_hooks = []
        if self._ctx.overlap:
            self._install_overlap_hooks()
        params = self._stage_params()
        with torch.no_grad():
            algo_state = algo.init_state(self._ctx, params)
        self._flat_layout_live = True
        if algo.owns_optimizer:
            opt_state = (algo.init_optimizer_state_sharded(self._ctx, params)
                         if algo.sharded_opt_state else algo.init_optimizer_state(params))
            return TrainState(0, model, None, algo_state, opt_state)
        self.opt_factory = (self._flat_opt_factory() if self._flat_resident
                            else self.optimizer_factory)
        optimizer = self.opt_factory(list(params) if self._flat_resident else model.parameters())
        return TrainState(0, model, optimizer, algo_state)

    def _install_overlap_hooks(self) -> None:
        """The overlap scheduler's hook on every plan parameter, run after
        autograd accumulated its gradient (:func:`_grad_accumulated`)."""
        local = set(self._local_names())
        self._overlap_hooks = [
            p.register_post_accumulate_grad_hook(
                functools.partial(_grad_accumulated, weakref.ref(self), name))
            for name, p in self._params.items() if name not in local]

    def shard_batch(self, local_batch: Mapping, global_batch: bool = False) -> dict:
        """This rank's batch on the trainer's device.  Each rank feeds its
        own slice of the global batch, as each reference rank feeds its own
        DataLoader split.  With ``global_batch`` the mapping holds the whole
        global batch and this rank's slice along dim 0 is taken: slice
        :attr:`data_rank` of :attr:`data_world` (``backend.py:3159-3161``:
        the data rank is the index along dp x ep, and the ranks of one
        sequence-parallel group take the same slice)."""
        def put(x):
            if not isinstance(x, torch.Tensor):
                x = torch.tensor(np.asarray(x))
            if global_batch:
                n, r = self.data_world, self.data_rank
                if x.shape[0] % n:
                    raise ValueError(f"global batch of {x.shape[0]} rows does not split over "
                                     f"{n} data ranks")
                rows = x.shape[0] // n
                x = x[r * rows:(r + 1) * rows]
            return x.to(self.device, non_blocking=True)

        return {k: put(v) for k, v in local_batch.items()}

    def unstack_params(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """The parameters by name as tensors of their own (for eval,
        checkpoints, user code), whatever the layout: this rank's copy, with
        the expert tables gathered over the expert axis into their global
        ``[n_experts, ...]`` shape (``backend.py:3714-3748``) and every
        tensor- or pipeline-sharded leaf over its axes into its global shape
        (collective under model parallelism)."""
        out = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        for n in self._local_names():
            for dim, axis in self._placements(n):
                comm = self.mesh.comm(axis)
                if comm is not None:
                    out[n] = comm.allgather(out[n], axis=dim, tiled=True)
        return out

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
        # the readiness rebucket is skipped under autotune: the service's
        # recommendations own the bucket order there (``backend.py:2102-2115``)
        observe = (self._ctx.overlap and not self._overlap_ordered
                   and not self.algorithm.sharded_opt_state and not self.autotune)
        counter = self._flop_counter
        for k, mb in enumerate(mbs):
            if counter is not None:
                # the model flops of the loss forward only: a rematerialized
                # forward inside the backward is not counted again
                counter.enabled = True
                try:
                    mb_loss = self.loss_fn(model, mb)
                finally:
                    counter.enabled = False
            else:
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
            functools.partial(algo.traced_reduce_bucket_grad, ctx))
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
        # the plan's upkeep, not the step's construction: the collective
        # log tags it (bagua_tpu_torch.analysis.collective_check)
        with recording_tag("plan"):
            # bagua: lint-ignore[host-sync-in-step] -- once per plan: the first overlapped step's readiness order, rank 0's, to every rank
            perm = self.comm.broadcast(
                torch.tensor(perm, dtype=torch.int64, device=self.device), 0).tolist()
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

    def measured_step_dt(self) -> Optional[float]:
        """Host cadence of the previous step in seconds, the injected
        ``step.straggle`` stalls in it subtracted, so a dilation never
        compounds into its own base (``backend.py:1773-1779``)."""
        return self._step_dt

    def note_injected_stall(self, seconds: float) -> None:
        """Record an injected stall inside the current step (an async
        boundary's ``step.straggle`` sleep), so the next cadence sample
        subtracts it; the ledger books it as ``stall``."""
        self._last_straggle_sleep += float(seconds)
        self._note_stall_phase(seconds)
        if self._ledger is not None and seconds > 0:
            self._ledger.note_class_window("stall", float(seconds))

    def note_phase_duration(self, phase: str, seconds: float) -> None:
        """Attribute host seconds of the current step to a phase
        (``dispatch`` / ``collective`` / ``optimizer``) for the anomaly
        detector's ``straggler_suspect`` breakdown (``backend.py:1789``)."""
        if self.anomaly_detector is None or seconds <= 0:
            return
        self._phase_durations[phase] = self._phase_durations.get(phase, 0.0) + float(seconds)

    def _note_stall_phase(self, seconds: float) -> None:
        """An injected ``step.straggle`` stall: the straggler's own process
        is locally slow (``dispatch``), a gated peer is waiting
        (``collective``)."""
        if self.anomaly_detector is None or seconds <= 0:
            return
        self.note_phase_duration(
            "dispatch" if _inject.straggle_targets_self() else "collective", seconds)

    def _note_step_cadence(self) -> None:
        """Close the previous step's wall window (``backend.py:1855-1900``):
        its cadence sample, its ledger window (productive, or the class of
        a build or migration window), its MFU and its anomaly sample."""
        now = time.monotonic()
        if self._last_step_mono is not None:
            raw = now - self._last_step_mono
            dt = raw - self._last_straggle_sleep
            if dt > 0:
                self._step_dt = dt
            window_cls = None
            if self._ledger is not None and raw > 0:
                window_cls = self._ledger_window_class or "productive_step"
                self._ledger_window_class = None
                self._ledger.note_step_window(self._step_counter - 1, raw, window_cls)
            if window_cls in (None, "productive_step"):
                # MFU from productive windows only: a build window's dt
                # would publish a garbage-low sample
                self._maybe_note_mfu()
            if self.anomaly_detector is not None and raw > 0:
                phases, self._phase_durations = self._phase_durations, {}
                if self._anomaly_skip_window:
                    self._anomaly_skip_window = False
                else:
                    self.anomaly_detector.observe(self._step_counter - 1, raw, phases)
        self._last_step_mono = now
        if self._obs_enabled:
            from ..obs import export as _obs_export

            _obs_export.note_step(self._step_counter, self._step_dt)

    def _maybe_note_mfu(self) -> None:
        """Per-step MFU gauge: the step's model flops over (measured step
        cadence x the card's peak FLOP/s); null-with-rationale on a device
        the peak table does not list, published once
        (``backend.py:1911-1929``)."""
        if not self._obs_enabled:
            return
        from ..obs import export as _obs_export

        if self._peak_flops is None:
            if not self._mfu_noted_unavailable:
                self._mfu_noted_unavailable = True
                _obs_export.note_mfu({
                    "available": False,
                    "rationale": (f"no peak-FLOPS table entry for device {self._device_kind!r} "
                                  "(the CPU or an unlisted card) — MFU needs the card's "
                                  "peak as its denominator"),
                })
            return
        if not self._mfu_flops or not self._step_dt:
            return
        _obs_export.note_mfu({
            "available": True,
            "mfu": round(self._mfu_flops / self._step_dt / self._peak_flops, 4),
            "flops_per_step": self._mfu_flops,
            "peak_flops": self._peak_flops,
            "step_dt": round(self._step_dt, 6),
        })

    def _note_static_footprint(self, state: TrainState) -> None:
        """One-shot static footprint of the live training state and the
        bucket plan (:func:`bagua_tpu_torch.obs.memory.static_footprint`)
        into the obs summary and the exporter's gauges."""
        self._footprint_noted = True
        try:
            from ..obs import export as _obs_export
            from ..obs.memory import static_footprint

            _obs_export.note_hbm_footprint(static_footprint(self, state))
        except Exception as e:  # noqa: BLE001 - accounting must not kill
            logger.debug("static footprint not computed: %s", e)

    def _maybe_poll_device_memory(self) -> None:
        """Live allocator poll (peak bytes and headroom gauges), on the
        beacon's cadence.  A stable unavailable answer (the CPU) stops the
        polling after publishing its rationale once; transient failures
        keep polling up to a budget (``backend.py:2010-2047``)."""
        if self._mem_poll_dead:
            return
        try:
            from ..obs import export as _obs_export
            from ..obs.memory import live_memory_stats

            record = live_memory_stats(self.device)
            if record.get("available"):
                self._mem_poll_failures = 0
            elif record.get("transient"):
                self._mem_poll_failures += 1
                if self._mem_poll_failures >= 5:
                    self._mem_poll_dead = True
            else:
                self._mem_poll_dead = True
            _obs_export.note_hbm_live(record)
        except Exception as e:  # noqa: BLE001
            self._mem_poll_failures += 1
            if self._mem_poll_failures >= 5:
                self._mem_poll_dead = True
            logger.debug("device memory poll failed: %s", e)

    def _note_device_attribution(self, trace_dir: str) -> None:
        """A ``BAGUA_PROFILE_DIR`` window just closed: attribute its device
        comm time per bucket (null-with-rationale where the device did no
        communication work) into the obs summary, in a daemon thread off
        the step; the launch schedule is read from the ring here."""
        import threading

        from ..obs.attribution import bucket_launches_from_ring

        launches = bucket_launches_from_ring()

        def parse():
            try:
                from ..obs import export as _obs_export
                from ..obs.attribution import attribute_device_comm

                record = attribute_device_comm(trace_dir, bucket_launches=launches)
                _obs_export.note_device_attribution(record)
                if record.get("available"):
                    logger.info("device attribution: comm %.6fs/step over %s (%s)",
                                record.get("comm_s_per_step") or 0.0, record.get("transport"),
                                trace_dir)
                else:
                    logger.info("device attribution unavailable: %s", record.get("rationale"))
            except Exception as e:  # noqa: BLE001
                logger.warning("device attribution failed: %s", e)

        threading.Thread(target=parse, name="bagua-obs-attribution", daemon=True).start()

    def train_step(self, state: TrainState, batch) -> Tuple[TrainState, torch.Tensor]:
        """One step; returns the new state and the loss averaged over ranks."""
        check_abort()   # no new step once a rank flagged an abort
        self._step_counter += 1
        if self._obs_enabled:
            # every span opened while this step is driven (the watchdog
            # waiter's and the comm worker's too) carries the step number
            _obs_spans.set_current_step(self._step_counter)
        if self._profiler is not None:
            self._profiler.on_step(self._step_counter - 1)
        # step.straggle (``backend.py:2069-2077``): a slow peer gates this
        # step only when the family's step synchronizes with every rank;
        # async families pay at their own negotiated boundaries
        self._note_step_cadence()
        if self._profiler is not None and self._obs_enabled:
            closed = self._profiler.consume_closed_dir()
            if closed:
                self._note_device_attribution(closed)
        if self.autotune and not self._autotune_completed:
            # the check-in every 100 steps (``backend.py:2088-2099``), before
            # the queued migrations so that what it recommends applies to
            # this step
            if self._step_counter % self.autotune_checkin_steps == 0:
                self._autotune_step(state)
            if (self.autotune and not self._autotune_completed and not self._telemetry_reported
                    and env.get_autotune_level() >= 2):
                self._report_tensor_execution_order(state, batch)
        if self._pending_state_migration is not None:
            # a rebucket's migration, applied before the step consumes it;
            # the span feeds the ledger's state_migration class
            with trace_span("step/state_migration"):
                state = self._pending_state_migration(state)
            self._pending_state_migration = None
            self._anomaly_skip_window = True
            self._skip_next_speed_sample = True
            if self._ledger_window_class is None:
                self._ledger_window_class = "state_migration"
        algo, ctx = self.algorithm, self._ctx
        self._last_straggle_sleep = _inject.maybe_straggle(
            "step", base_dt=self._step_dt, gated=algo.straggler_gates_step)
        self._note_stall_phase(self._last_straggle_sleep)
        if self._ledger is not None and self._last_straggle_sleep > 0:
            self._ledger.note_class_window("stall", self._last_straggle_sleep)
        # the boundary between steps, before the phase switch, as in the
        # JAX trainer
        with torch.no_grad():
            state = algo.host_pre_step(self, state)
        # the phase switch (QAdam's warmup boundary) on the trainer's own
        # step count, at the top of the step, as the JAX trainer does
        if algo.need_reset(self._step_counter - 1):
            self._phase += 1
        # the first step of a step key (plan, phase) is the port's build:
        # it runs as any step, but its window is the ledger's compile
        # class, the anomaly detector skips it, and its forward's model
        # flops become the MFU numerator of the key
        key = (ctx.plan, self._phase, type(algo), ctx.intra_codec, ctx.inter_codec,
               ctx.overlap, ctx.flat_resident)
        build = (self._step_key is None or key[0] is not self._step_key[0]
                 or key[1:] != self._step_key[1:])
        if build:
            self._step_key = key
            self._anomaly_skip_window = True
            self._skip_next_speed_sample = True
            self._ledger_window_class = "compile"
        counter = (_obs_flops.StepFlopCounter(state.model)
                   if build and self._obs_enabled else None)
        t0 = time.monotonic()
        with (trace_span("step/build", phase=self._phase, buckets=len(ctx.plan.buckets),
                         overlap=ctx.overlap) if build else nullcontext()), \
                trace_span("step/dispatch"), (counter or nullcontext()):
            self._flop_counter = counter
            try:
                new_state, loss = self._run_step(state, batch)
            finally:
                self._flop_counter = None
        self.note_phase_duration("dispatch", time.monotonic() - t0)
        if counter is not None:
            self._mfu_flops = counter.step or None
        if self._obs_enabled and not self._footprint_noted:
            # after the first step: a torch optimizer makes its state there
            self._note_static_footprint(new_state)
        if self._watchdog is not None:
            # the waiter blocks on an event recorded after the step (the
            # main thread keeps dispatching); a wedged collective or kernel
            # pins it past the timeout (``backend.py:2152-2159``).  The
            # step's blocking collectives (gloo's) ran inside the
            # communicator's own watched sections
            self._watchdog.watch_result(loss, f"train_step[{self._step_counter}]")
        if self._obs_enabled:
            # the fleet view's worker half: refresh this rank's beacon and
            # poll the allocator, throttled to one small file write every
            # 2 s (``backend.py:2163-2175``); no-op without the launcher's
            # beacon path
            now = time.monotonic()
            if now - self._last_beacon_write > 2.0:
                self._last_beacon_write = now
                self._maybe_poll_device_memory()
                from ..elastic.membership import write_health_beacon

                write_health_beacon()
        self._auto_record_speed(batch)
        return new_state, loss

    def _run_step(self, state: TrainState, batch) -> Tuple[TrainState, torch.Tensor]:
        """The step's work after the host prologue: forward and backward,
        the communication, the guard, the optimizer and the loss."""
        algo, ctx, guard = self.algorithm, self._ctx, self.grad_guard
        model, optimizer = state.model, state.optimizer
        model.train()
        poison = _inject.armed_traced_specs("grad.poison")
        fires = [s for s in poison if self._poison_fires(s, state.step)]
        for spec in fires:
            _inject.note_traced_fire(spec)
        params = self._stage_params()
        # under model parallelism the local leaves differ between ranks: the
        # verdict is then taken on the updated parameters, MIN over all
        replicated_health = (algo.grad_health_replicated and self.expert_axis is None
                             and self._shard_axis is None)
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
            if self._pp_size > 1:
                self._prescale_partial_grads(grads)
            snapshot = (self._snapshot(state) if guard == "skip" and not replicated_health
                        else None)
            process = algo.process_grads_bucketed if ctx.overlap else algo.process_grads
            with trace_span("trace/comm_stage", overlap=ctx.overlap,
                            buckets=len(ctx.plan.buckets)):
                grads, algo_state = process(ctx, grads, params, state.algo_state, state.step)
        if self.expert_axis is not None or self._shard_axis is not None:
            grads = {**grads, **self._local_grads()}
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
            with trace_span("trace/optimizer_apply", owned=algo.owns_optimizer):
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
                    # every mesh axis (``mp_health``, ``backend.py:1345-1354``)
                    health = self.backend.global_communicator.allreduce(health, ReduceOp.MIN)
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

    @torch.no_grad()
    def _prescale_partial_grads(self, grads) -> None:
        """Multiply the replicated leaves' gradients by ``pp_size``, in
        place (``backend.py:1456-1465``): each stage's is partial, and the
        bucket collectives' average over a world that spans pp becomes their
        sum."""
        for n, g in grads.items():
            if not self._is_sharded(n):
                g.mul_(self._pp_size)

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
        loss = self.comm.allreduce(loss.detach().clone(), ReduceOp.AVG)
        if self._watchdog is not None:
            # a wedged eval allreduce must pin the waiter, not hang silently
            self._watchdog.watch_result(loss, "eval_step")
        return loss

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
            # the tensors outside the plan (expert tables, tensor- and
            # pipeline-sharded leaves) share one last slot
            extras = [torch.isfinite(tensors[n]).all() for n in self._local_names()
                      if n in tensors]
            if extras:
                flags.append(torch.stack(extras).all())
        else:
            flags = [torch.isfinite(f).all() for f in tensors]
        return torch.stack(flags).float()

    @staticmethod
    def _healthy(health: torch.Tensor) -> bool:
        # bagua: lint-ignore[host-sync-in-step] -- the grad guard's verdict: skip and rewind need it on the host before the update
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
        counters, ``warn``, ``abort`` and the skip budget; a rewound step's
        ledger window moves to ``rewind``, an abort leaves a
        ``grad_guard_abort`` flight record."""
        t0 = time.monotonic()
        with trace_span("step/grad_guard_verdict", step=step_no):
            hv = health.cpu().numpy()  # bagua: lint-ignore[host-sync-in-step] -- the grad guard's verdict, the policy's one readback
        # the readback blocks on the step's update: optimizer-adjacent work
        self.note_phase_duration("optimizer", time.monotonic() - t0)
        if self._obs_enabled:
            # a host-safe mirror of the verdict: the flight recorder
            # republishes it from abort paths, where touching a device
            # tensor could hang
            from ..obs import export as _obs_export

            _obs_export.note_step_metrics({"grad_health_step": step_no,
                                           "grad_healthy": float(hv.min())})  # bagua: lint-ignore[host-sync-in-step] -- hv is the host copy read above: no device read
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
            if self._ledger is not None:
                # the step's wall was spent, its update discarded
                self._ledger.reclassify_step_rewind(step_no)
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
        # the event reaches the elastic coordinator after the policy's
        # counters, so the payload holds this event's skip or abort: the
        # launcher's lease heartbeat carries the beacon, and a rank with
        # repeated non-finite gradients can be fenced (a no-op without the
        # launcher's BAGUA_ELASTIC_HEALTH_FILE; ``backend.py:2284-2294``)
        from ..elastic.membership import write_health_beacon

        write_health_beacon()
        if abort_msg is not None:
            # flight recorder: the post-mortem names the step and the
            # buckets before the abort flag stops every control loop
            from ..obs.recorder import dump_flight_record

            dump_flight_record(
                "grad_guard_abort", reason=abort_msg,
                extra={"step": step_no, "unhealthy_buckets": bad,
                       "policy": self.grad_guard,
                       "consecutive_skips": self._guard_skips})
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
                self._lay_out(new_plan, relayout_flats(old_plan, new_plan,
                                                       [f.data for f in self._flats]))
                if state.optimizer is not None:
                    self._relayout_optimizer(state.optimizer, old_plan)
                opt_state = _relayout_container(opt_state, old_plan, new_plan)
            algo_state = self.algorithm.relayout_algo_state(old_plan, new_plan,
                                                            state.algo_state)
            self._live_plan = new_plan
            return dataclasses.replace(state, opt_state=opt_state, algo_state=algo_state)

        return migrate

    def _relayout_optimizer(self, opt, old_plan: BucketPlan) -> None:
        """Move a torch optimizer from the old parameter flats onto the new
        ones (``self._flats``): its state through the parameters' names, as a
        restore across plans moves it (:meth:`_convert_optimizer`), and its
        one parameter group."""
        if len(opt.param_groups) != 1:
            raise ValueError("rebucket under flat_resident needs an optimizer with one "
                             f"parameter group, got {len(opt.param_groups)}")
        tree = optimizer_state_tree(opt, [str(i) for i in range(len(old_plan.buckets))])
        opt.param_groups[0]["params"] = list(self._flats)
        load_optimizer_state_tree(opt, self._convert_optimizer(tree, "flat", old_plan),
                                  self._param_keys())

    # ---- autotune: the trainer's half (``backend.py:2505-3160``) ---------

    def _report_tensor_execution_order(self, state: TrainState, batch) -> None:
        """Send the service the gradient-readiness order of one backward
        (the reference's tensor_ready spans), once, at level >= 2
        (``backend.py:2510``)."""
        self._telemetry_reported = True
        try:
            from ..communication import get_hyperparameters_service_client
            from ..telemetry import profile_tensor_execution_order

            spans = profile_tensor_execution_order(self.loss_fn, state.model, batch)
            if self._autotune_client is None:
                self._autotune_client = get_hyperparameters_service_client()
            self._autotune_client.report_tensor_execution_order(spans,
                                                                model_name=self.model_name)
            logger.info("telemetry: reported execution order for %d tensors", len(spans))
        except Exception as e:  # telemetry must never take down training
            logger.warning("telemetry report failed: %s", e)

    def _autotune_register_tensors(self) -> None:
        """Declare the plan's tensors (and the capabilities) to the service
        and apply its first recommendation (``backend.py:2535``); a failure
        turns autotune off with a warning."""
        from ..communication import get_hyperparameters_service_client
        from ..define import BaguaHyperparameter

        try:
            if self._autotune_client is None:
                self._autotune_client = get_hyperparameters_service_client()
            rsp = self._autotune_client.register_tensors(
                model_name=self.model_name,
                tensor_list=[p.declaration().model_dump() for p in self._named_params],
                capabilities=self._autotune_capabilities())
            self._apply_recommendation(
                BaguaHyperparameter(**rsp.get("recommended_hyperparameters", {})))
        except Exception as e:  # autotune must never take down training
            logger.warning("autotune register_tensors failed: %s", e)
            self.autotune = False

    def _switch_refused(self, proto: Algorithm, live: bool) -> Optional[str]:
        """Why this trainer cannot switch to ``proto``'s family, or None
        (``backend.py:2820-2868``; ``live`` adds the checks that depend on
        the current layout)."""
        algo = self.algorithm
        if algo.owns_optimizer and not proto.owns_optimizer and self.optimizer_factory is None:
            return "without a trainer optimizer"
        if live and self._flat_resident and not proto.supports_flat_resident:
            return "flat-resident state needs a supports_flat_resident family"
        if proto.replicated_params != algo.replicated_params:
            if algo.owns_optimizer or proto.owns_optimizer:
                return ("a replication-boundary switch cannot also cross the "
                        "optimizer-ownership boundary")
            if self.expert_axis is not None or self._shard_axis is not None \
                    or self.seq_axis is not None:
                return "replication-boundary switches need a pure data-parallel mesh"
        return None

    def _family(self, name: str) -> Algorithm:
        """The user's instance of family ``name``, else a new one."""
        from ..algorithms import SWITCHABLE_ALGORITHMS

        return self._user_algorithms.get(name) or SWITCHABLE_ALGORITHMS[name](False)

    def _autotune_capabilities(self) -> Optional[dict]:
        """What this trainer's mesh, family and layout make legal, sent once
        at registration so the service builds the v2 knob space of exactly
        the knobs it can apply (``backend.py:2559``); None keeps the legacy
        two-knob space (``BAGUA_AUTOTUNE_SPACE=legacy``)."""
        if env.get_autotune_space() == "legacy":
            return None
        from ..algorithms import SWITCHABLE_ALGORITHMS

        current = getattr(self.algorithm, "name", None) or ""
        families: list = []
        flat_families: list = []
        if current in SWITCHABLE_ALGORITHMS:
            for name in SWITCHABLE_ALGORITHMS:
                proto = self._family(name)
                if name != current and self._switch_refused(proto, False):
                    continue
                families.append(name)
                if proto.supports_flat_resident:
                    flat_families.append(name)
        algo, factory = self.algorithm, self.optimizer_factory
        flat_ok = (self._flat_supported() and algo.replicated_params
                   and not algo.owns_optimizer and not algo.sharded_opt_state
                   and factory is not None and getattr(factory, "fused_inner", None) is None
                   and _optimizer_flattens_safely(factory))
        return {"space": "v2", "two_tier": bool(self._ctx.two_tier()),
                "ef_ok": bool(self._ef_enabled), "flat_ok": bool(flat_ok),
                "families": families, "flat_families": flat_families,
                "current_algorithm": current}

    def _refresh_ctx(self) -> None:
        """Rebuild the algorithm context over the current plan from the
        knobs (codecs, overlap, chunk targets, layout), as the JAX package's
        step key re-jits; the overlap hooks are installed when the
        scheduler turns on."""
        self._ctx = self._make_ctx(self._ctx.plan, self._overlap_active())
        if self._ctx.overlap and not self._overlap_hooks:
            self._install_overlap_hooks()

    def _apply_recommendation(self, recommended) -> None:
        """Apply the service's recommendation (``backend.py:2617``): a
        family switch, the overlap knobs, the codec policy, the buckets
        (:meth:`rebucket`), flat residency and the hierarchical toggle,
        then the error-feedback residual's migration where the knobs
        flipped whether it is carried.  Every state change is a migration
        queued for the next :meth:`train_step`, before its step runs."""
        from ..compression.codecs import validate_codec_policy

        ef_was = self._ef_active()
        self._maybe_switch_algorithm(recommended)
        if recommended.overlap in ("auto", "on", "off"):
            self.overlap = recommended.overlap
        for attr in ("overlap_chunk_bytes", "overlap_chunk_bytes_intra",
                     "overlap_chunk_bytes_inter"):
            value = getattr(recommended, attr)
            if value:
                setattr(self, attr, int(value))
        # the codec policy ("" = keep current): the autopilot's compress_dcn
        # hint reaches compress_inter here, on every rank at the same step
        for attr in ("compress_intra", "compress_inter"):
            value = getattr(recommended, attr, "")
            if value:
                try:
                    setattr(self, attr, validate_codec_policy(value, attr))
                except ValueError as e:
                    logger.warning("autotune recommendation ignored: %s", e)
        if recommended.buckets:
            names = {p.name for p in self._named_params}
            decl_buckets = [[d for d in bucket if d.name in names]
                            for bucket in recommended.buckets]
            decl_buckets = [b for b in decl_buckets if b]
            if decl_buckets:
                self.rebucket(decl_buckets)
                self.bucket_bytes = recommended.bucket_size
        # after any rebucket: the layout conversion runs under the plan the
        # step will run (migrations apply in queue order)
        if getattr(recommended, "flat_resident", ""):
            self._apply_flat_resident(recommended.flat_resident)
        # the hierarchical toggle only where the two tiers exist; never for
        # a sharded-state family, whose staged form changes its state layout
        if self._ctx.two_tier() and not self.algorithm.sharded_opt_state:
            self.algorithm.hierarchical = bool(recommended.is_hierarchical_reduce)
        self._refresh_ctx()
        self._sync_ef_state(ef_was)

    def _sync_ef_state(self, was_active: bool) -> None:
        """Queue a migration where a knob flipped whether the error-feedback
        residual is carried (``backend.py:935``): newly active starts from
        zero residuals, one f32 flat a bucket; newly inactive drops it."""
        now = self._ef_active()
        if now == was_active:
            return
        if now:
            @torch.no_grad()
            def add_ef(state: TrainState) -> TrainState:
                a = state.algo_state
                if isinstance(a, dict) and "ef" in a:
                    return state   # already carried (an idempotent re-queue)
                logger.info("error-feedback residual enabled (codec policy flip): starting "
                            "from zero residuals for %d buckets", len(self.plan.buckets))
                return dataclasses.replace(
                    state, algo_state=self.algorithm.ef_init_state(self._ctx, a))

            self._queue_state_migration(add_ef)
        else:
            def drop_ef(state: TrainState) -> TrainState:
                a = state.algo_state
                if not (isinstance(a, dict) and "ef" in a):
                    return state
                logger.info("error-feedback residual disabled (codec policy flip): dropping "
                            "the accumulated residual")
                rest = {k: v for k, v in a.items() if k != "ef"}
                return dataclasses.replace(state, algo_state=rest or None)

            self._queue_state_migration(drop_ef)

    def _apply_flat_resident(self, want: str) -> None:
        """Apply a ``flat_resident`` recommendation (``"on"``/``"off"``,
        ``backend.py:2682``).  Before :meth:`init` lays the state out it
        sets the mode; after, it queues a live leaf <-> flat migration of
        the parameters and the optimizer's state under the current plan
        (the conversion a restore across layouts makes), so no training
        math changes.  Refused, with a log line, for families whose state
        does not mirror replicated parameters, a fused-wrapper optimizer,
        and where the resident layout cannot hold the configuration."""
        if want not in ("on", "off"):
            return
        algo, factory = self.algorithm, self.optimizer_factory
        if not self._flat_layout_live:
            if want == "off" or (self._flat_supported() and not algo.owns_optimizer
                                 and not algo.sharded_opt_state
                                 and _optimizer_flattens_safely(self._flat_opt_factory())):
                self.flat_resident = want
            else:
                logger.info("autotune: flat_resident=%s not supported by this configuration; "
                            "keeping mode %r", want, self.flat_resident)
            return
        want_on = want == "on"
        if want_on == self._flat_resident:
            return
        if algo.owns_optimizer or algo.sharded_opt_state or not algo.replicated_params:
            logger.info("autotune: live flat_resident=%s ignored — %s state is not "
                        "param-mirrored replicated", want, type(algo).__name__)
            return
        if getattr(factory, "fused_inner", None) is not None:
            logger.info("autotune: live flat_resident flip ignored — fused-wrapper optimizer "
                        "state is not convertible in place")
            return
        if want_on and not (self._flat_supported() and factory is not None
                            and _optimizer_flattens_safely(factory)):
            logger.info("autotune: flat_resident=on refused — layout unsupported or optimizer "
                        "does not commute with flattening")
            return
        self._queue_state_migration(self._make_layout_migration(want_on))
        logger.info("autotune: flat_resident -> %s (migration queued)", want)

    def _make_layout_migration(self, want_on: bool):
        """The live leaf <-> flat conversion, run at the next step under the
        plan then current: the parameters (views of new flats, or storage
        of their own again), the torch optimizer rebuilt over them with its
        state converted by parameter name, and the context."""
        @torch.no_grad()
        def migrate(state: TrainState) -> TrainState:
            if want_on == self._flat_resident:
                return state
            plan, opt = self.plan, state.optimizer
            tree = optimizer_state_tree(opt, self._param_keys()) if opt is not None else None
            old_layout, old_plan = ("flat" if self._flat_resident else "leaf"), self._live_plan
            if want_on:
                logger.info("autotune: relaying state leaf -> bucket-flat")
                self._flat_resident = True
                self._lay_out(plan, plan.flatten(self._params))
            else:
                logger.info("autotune: relaying state bucket-flat -> leaf")
                for handle in self._grad_hooks:
                    handle.remove()
                self._grad_hooks = []
                for p in self._params.values():
                    p.data = p.data.clone()
                    p.grad = None
                self._flats, self._grad_flats = None, None
                self._flat_resident = False
            self._live_plan = plan
            self.opt_factory = self._flat_opt_factory() if want_on else self.optimizer_factory
            new_opt = None
            if opt is not None:
                new_opt = self.opt_factory(list(self._flats) if want_on
                                           else state.model.parameters())
                load_optimizer_state_tree(
                    new_opt, self._convert_optimizer(tree, old_layout, old_plan, plan),
                    self._param_keys())
            self._refresh_ctx()
            return dataclasses.replace(state, optimizer=new_opt)

        return migrate

    def _maybe_switch_algorithm(self, recommended) -> None:
        """Swap the algorithm family where the recommendation names another
        switchable one (``backend.py:2802``): the user's own instance when
        it is theirs, else a new one; the state migrations across the
        optimizer-ownership and replication boundaries are queued, and the
        plan is rebuilt under the new family's alignment."""
        from ..algorithms import SWITCHABLE_ALGORITHMS

        target = recommended.algorithm
        current = getattr(self.algorithm, "name", None)
        if (not target or target == current or current not in SWITCHABLE_ALGORITHMS
                or target not in SWITCHABLE_ALGORITHMS):
            return
        old = self.algorithm
        proto = self._family(target)
        why = self._switch_refused(proto, True)
        if why is not None:
            logger.info("autotune: cannot switch %s -> %s — %s", current, target, why)
            return
        logger.info("autotune: switching algorithm %s -> %s", current, target)
        if target in self._user_algorithms:
            self.algorithm = proto
            self.algorithm.hierarchical = bool(recommended.is_hierarchical_reduce)
        else:
            self.algorithm = SWITCHABLE_ALGORITHMS[target](
                bool(recommended.is_hierarchical_reduce))
        if hasattr(old, "reset_schedule"):
            # leaving a scheduled family: its round in flight is dropped
            old.reset_schedule()
        if hasattr(self.algorithm, "reset_schedule"):
            # (re-)entering one: the period calibrates against the current
            # cadence, and no stale round survives a previous stint
            self.algorithm.reset_schedule()
        if not recommended.buckets:
            # the plan under the new family's alignment (ByteGrad and QAdam
            # pad buckets to the world); a recommendation with buckets of
            # its own rebuckets after this
            self.rebucket([[t.declaration() for t in b.tensors] for b in self.plan.buckets])
        self._prepare_state_migration(old, self.algorithm)
        self._prepare_replication_migration(old, self.algorithm)
        new = self.algorithm

        @torch.no_grad()
        def enter(state: TrainState) -> TrainState:
            # the new family's own state (async model average's groups,
            # collective on every rank at this same step); a residual the
            # old family carried stays, and _sync_ef_state adds or drops it
            fresh = new.init_state(self._ctx, self._stage_params())
            a = state.algo_state
            keep = a is None or (isinstance(a, dict) and set(a) <= {"ef"})
            return dataclasses.replace(state, algo_state=a if keep else fresh)

        self._queue_state_migration(enter)

    def _prepare_state_migration(self, old: Algorithm, new: Algorithm) -> None:
        """Queue the optimizer-state migration of a switch across the
        trainer-optimizer / owned-optimizer boundary (allreduce | bytegrad
        <-> QAdam, ``backend.py:2900``).  Into QAdam its momenta are adopted
        from a torch Adam-family optimizer's ``exp_avg`` and ``exp_avg_sq``
        (else zeros) and its warmup is re-anchored at the switch step; the
        displaced optimizer's state is stashed by parameter and restored on
        the way back, into an optimizer built over the live parameters.
        Queued after the switch's rebucket, so it runs on the plan the step
        will run."""
        if old.owns_optimizer == new.owns_optimizer:
            return
        from ..algorithms.q_adam import QAdamAlgorithm, QAdamOptState

        if new.owns_optimizer:
            assert isinstance(new, QAdamAlgorithm), type(new)
            # re-anchor warmup at the switch, from the family's RELATIVE
            # warmup, so repeated round trips do not compound the anchor
            if not hasattr(new, "_base_warmup"):
                new._base_warmup = new.warmup_steps
            new._compressed = False
            new.warmup_steps = self._step_counter + new._base_warmup

            @torch.no_grad()
            def to_owned(state: TrainState) -> TrainState:
                opt = state.optimizer
                params = self._stage_params()
                keyed = (dict(enumerate(params)) if self._flat_resident else params)
                moments = None
                if opt is not None:
                    self._stashed_opt_state = (
                        copy_tree(optimizer_state_tree(opt, self._param_keys())),
                        "flat" if self._flat_resident else "leaf", self._live_plan)
                    sts = {k: opt.state.get(p, {}) for k, p in keyed.items()}
                    if all("exp_avg" in s and "exp_avg_sq" in s for s in sts.values()):
                        moments = tuple(
                            {k: s[m].detach().clone() for k, s in sts.items()}
                            for m in ("exp_avg", "exp_avg_sq"))
                fresh = new.init_optimizer_state(params)
                if moments is not None:
                    if self._flat_resident:
                        moments = tuple(tuple(d[i] for i in range(len(params))) for d in moments)
                    fresh = QAdamOptState(exp_avg=moments[0], exp_avg_sq=moments[1])
                self.opt_factory = None
                return dataclasses.replace(state, optimizer=None, opt_state=fresh)

            self._queue_state_migration(to_owned)
        else:
            @torch.no_grad()
            def from_owned(state: TrainState) -> TrainState:
                self.opt_factory = (self._flat_opt_factory() if self._flat_resident
                                    else self.optimizer_factory)
                opt = self.opt_factory(list(self._flats) if self._flat_resident
                                       else state.model.parameters())
                stashed, self._stashed_opt_state = self._stashed_opt_state, None
                if stashed is not None:
                    tree, layout, plan = stashed
                    load_optimizer_state_tree(
                        opt, self._convert_optimizer(tree, layout, plan, self._live_plan),
                        self._param_keys())
                return dataclasses.replace(state, optimizer=opt, opt_state=None)

            self._queue_state_migration(from_owned)

    def _prepare_replication_migration(self, old: Algorithm, new: Algorithm) -> None:
        """Queue the migration of a switch across the replication boundary
        (allreduce | bytegrad <-> async model average,
        ``backend.py:2953-3020``).  The JAX package stacks the replicated
        state into one row a rank on the way in and collapses the rows on
        the way out.  Here every rank holds its own weights in either
        family, so the way in moves nothing; the way out is one
        synchronous catch-up average of the weights and the optimizer's
        floating state over the ranks (MAX for its step counts and for
        integers, an exact consensus), the semantics of one catch-up sync."""
        if old.replicated_params == new.replicated_params or new.replicated_params is False:
            return
        comm = self.comm

        @torch.no_grad()
        def collapse(state: TrainState) -> TrainState:
            logger.info("replication migration: per-rank replicas -> replicated via "
                        "catch-up average (%s)", type(new).__name__)
            for p in self._params.values():
                comm.allreduce(p.data, ReduceOp.AVG)
            opt = state.optimizer
            if opt is not None:
                for st in opt.state.values():
                    for k, v in st.items():
                        if not torch.is_tensor(v):
                            continue
                        exact = k == "step" or not v.is_floating_point()
                        comm.allreduce(v, ReduceOp.MAX if exact else ReduceOp.AVG)
            return state

        self._queue_state_migration(collapse)

    def _autotune_step(self, state: TrainState) -> None:
        """The check-in (``backend.py:3022``): the windowed speed and
        goodput window with the anomaly detector's perf hints reported, the
        round's recommendation asked for and applied.  Hints are put back
        when the report fails; three failures in a row turn autotune off.

        The card's queue can run ahead of the host, so the check-in first
        synchronizes once, and the wait joins the window as time with no
        samples: the window's rate counts only finished work.  No other
        step synchronizes."""
        from ..communication import get_hyperparameters_service_client
        from ..define import BaguaHyperparameter
        from ..obs import anomaly as _obs_anomaly

        rank = env.get_rank()
        t0 = time.monotonic()
        if self.device.type == "cuda":
            # bagua: lint-ignore[host-sync-in-step] -- the check-in's one sync: the speed window counts finished work only
            torch.cuda.synchronize(self.device)
        if not self._manual_speed and not self._skip_next_speed_sample:
            self._speed_tracker.record(0.0)
            self._last_speed_time = time.time()
        t_sync = time.monotonic()
        now = time.time()
        speed = self._speed_tracker.get(now - self._last_report_time)
        self._last_report_time = now
        hints = _obs_anomaly.drain_perf_hints()
        delivered = False
        try:
            if self._autotune_client is None:
                self._autotune_client = get_hyperparameters_service_client()
            client = self._autotune_client
            client.report_metrics(
                model_name=self.model_name, rank=rank, train_iter=self._step_counter,
                hyperparameters=self._current_hyperparameters().model_dump(), speed=speed,
                perf_hints=hints or None, obs=self._autotune_obs_window())
            delivered = True
            t_report = time.monotonic()
            rsp = client.ask_hyperparameters(model_name=self.model_name, rank=rank,
                                             train_iter=self._step_counter)
            t_ask = time.monotonic()
            recommended = BaguaHyperparameter(**rsp["recommended_hyperparameters"])
            self._autotune_completed = bool(rsp.get("is_autotune_completed", False))
            self._apply_recommendation(recommended)
            t_apply = time.monotonic()
            self._autotune_failures = 0
            self.autotune_checkins.append({
                "step": self._step_counter, "speed": speed,
                "sync_ms": (t_sync - t0) * 1e3, "report_ms": (t_report - t_sync) * 1e3,
                "ask_ms": (t_ask - t_report) * 1e3, "apply_ms": (t_apply - t_ask) * 1e3,
                "buckets": len(self.plan.buckets),
                "completed": self._autotune_completed})
        except Exception as e:  # autotune must never take down training
            if hints and not delivered:
                # a transient sidecar hiccup must not discard the taint
                # signal: the next successful check-in carries it
                _obs_anomaly.requeue_perf_hints(hints)
            self._autotune_failures += 1
            logger.warning("autotune check-in failed (%d/3): %s", self._autotune_failures, e)
            if self._autotune_failures >= 3:
                logger.warning("autotune disabled after repeated failures")
                self.autotune = False

    def _autotune_obs_window(self) -> Optional[dict]:
        """The rank's efficiency window for the check-in (``backend.py:3076``):
        the goodput fraction since the last report (a delta of the ledger's
        cumulative classes), MFU, the DCN share of the step, HBM headroom
        and the anomaly flag from the obs summary; None with the obs plane
        or goodput reporting off (``BAGUA_AUTOTUNE_GOODPUT=0``) or before a
        window has elapsed."""
        if self._ledger is None or not env.get_autotune_goodput():
            return None
        try:
            rep = self._ledger.report()
        except Exception:  # the score input must never take down training
            return None
        if not rep:
            return None
        classes = dict(rep.get("classes") or {})
        snap = {"wall_s": float(rep.get("wall_s") or 0.0), "classes": classes}
        prev, self._autotune_ledger_prev = self._autotune_ledger_prev, snap
        if prev is None:
            # the first window opens at the ledger's first second, so the
            # initial configuration's build lands in its own score
            prev = {"wall_s": 0.0, "classes": {}}
        dwall = snap["wall_s"] - prev["wall_s"]
        if dwall <= 0:
            return None
        from ..obs.ledger import GOODPUT_CLASSES

        dgood = sum(classes.get(c, 0.0) - prev["classes"].get(c, 0.0) for c in GOODPUT_CLASSES)
        obs = {"goodput_fraction": max(0.0, min(1.0, dgood / dwall)),
               "window_wall_s": round(dwall, 3)}
        try:
            from ..obs import export as _obs_export

            summary = _obs_export.local_obs_summary() or {}
        except Exception:
            summary = {}
        if summary.get("mfu") is not None:
            obs["mfu"] = summary["mfu"]
        dcn = summary.get("device_comm_dcn_s_per_step")
        if dcn is not None:
            obs["dcn_s_per_step"] = dcn
            dt = summary.get("step_dt_p50")
            if dt:
                obs["dcn_share"] = max(0.0, min(1.0, float(dcn) / float(dt)))
        if summary.get("hbm_headroom_bytes") is not None:
            obs["hbm_headroom_bytes"] = summary["hbm_headroom_bytes"]
        if summary.get("straggler_suspect"):
            # the service re-measures anomaly-flagged windows
            obs["anomaly"] = True
        return obs

    def _current_hyperparameters(self):
        """What this trainer runs, as a :class:`BaguaHyperparameter`
        (``backend.py:3138``)."""
        from ..define import BaguaHyperparameter

        return BaguaHyperparameter(
            buckets=[[t.declaration() for t in b.tensors] for b in self.plan.buckets],
            is_hierarchical_reduce=bool(self.algorithm.hierarchical),
            bucket_size=int(self.bucket_bytes), overlap=self.overlap,
            overlap_chunk_bytes=int(self.overlap_chunk_bytes),
            overlap_chunk_bytes_intra=int(self.overlap_chunk_bytes_intra),
            overlap_chunk_bytes_inter=int(self.overlap_chunk_bytes_inter),
            compress_intra=self.compress_intra, compress_inter=self.compress_inter,
            flat_resident="on" if self._flat_resident else "off")

    def _auto_record_speed(self, batch) -> None:
        """One throughput sample a step (``backend.py:2331``): the batch's
        dim 0 over the host interval since the previous step; a build or a
        migration's interval is dropped and restarts the clock.  Off once
        the search completed or :meth:`record_speed` took over."""
        if self._manual_speed or self._autotune_completed:
            return
        first = next((v for v in batch.values() if torch.is_tensor(v) and v.dim()), None) \
            if isinstance(batch, Mapping) else None
        if first is None:
            return
        now = time.time()
        dt = now - self._last_speed_time
        self._prev_speed_time = self._last_speed_time
        self._last_speed_time = now
        if self._skip_next_speed_sample:
            self._skip_next_speed_sample = False
            return
        if dt > 0:
            self._speed_tracker.record(first.shape[0] / dt)

    def record_speed(self, n_samples: float) -> None:
        """Count ``n_samples`` since the previous call, in place of the
        automatic samples of the batches' dim 0 (``backend.py:3749``), e.g.
        for token-weighted scoring."""
        now = time.time()
        if not self._manual_speed:
            # the first call drops the automatic samples (other units) and
            # records this one against the interval the automatic path
            # measured for the same step, so a check-in before the second
            # call never scores 0
            self._manual_speed = True
            self._speed_tracker = StatisticalAverage()
            dt = now - self._prev_speed_time
            self._last_speed_time = now
            if dt > 0:
                self._speed_tracker.record(n_samples / dt)
            return
        dt = now - self._last_speed_time
        self._last_speed_time = now
        if dt > 0:
            self._speed_tracker.record(n_samples / dt)

    # ---- checkpointing ---------------------------------------------------

    def checkpoint_layout_metadata(self) -> dict:
        """Layout descriptor stored beside this trainer's checkpoints (the
        ``metadata=`` of :meth:`BaguaCheckpointManager.save`), with the JAX
        package's keys and values (``backend.py:3219-3280``): ``layout``
        (``flat`` or ``leaf``), ``plan_signature`` (a hash of the bucket
        plan, equal to the JAX package's for the same named tensors),
        ``world_size``, ``bucket_bytes``, ``plan_dependent`` (flat layouts'
        shapes depend on the plan), ``stacked`` (per-rank state), and where
        they apply ``flat_layout`` (the plan's layout descriptor),
        ``opt_shards`` (the ranks ZeRO's optimizer state is sharded over: the
        intra-node ones when staged), ``ef`` (the error-feedback residual's
        world and plan) and, under expert, sequence, tensor or pipeline
        parallelism, ``mesh`` (the mesh's axis sizes; the JAX package records
        no mesh) and the model axes (``expert_axis``, ``tp_axis``,
        ``pp_axis``).  ``world_size`` is the comm axes' world, as JAX's."""
        if self._ctx is None:
            raise RuntimeError("checkpoint_layout_metadata() needs the bucket plan — call "
                               "trainer.init(model) first")
        algo, plan = self.algorithm, self.plan
        meta = {
            "layout": "flat" if self._flat_resident else "leaf",
            "plan_signature": hashlib.blake2b(repr(plan.portable_signature()).encode(),
                                              digest_size=8).hexdigest(),
            "world_size": int(self.comm.nranks()),
            "bucket_bytes": int(self.bucket_bytes),
            "plan_dependent": bool(self._flat_resident),
            "stacked": not algo.replicated_params,
        }
        if self._flat_resident:
            meta["flat_layout"] = plan.layout_descriptor()
        if algo.sharded_opt_state:
            meta["opt_shards"] = int(algo.opt_shard_ranks(self._ctx))
        if self._ef_active():
            meta["ef"] = {"world": int(self.comm.nranks()),
                          "flat_layout": plan.layout_descriptor()}
        if any(a is not None for a in (self.expert_axis, self.seq_axis, self.tp_axis,
                                       self.pp_axis)):
            meta["mesh"] = {a: int(n) for a, n in self.mesh.shape.items()}
        for key in ("expert_axis", "tp_axis", "pp_axis"):
            if getattr(self, key) is not None:
                meta[key] = getattr(self, key)
        local = self._local_names()
        if local:
            meta["local_dims"] = {n: [list(e) for e in self._placements(n)] for n in local}
        return meta

    def _placements(self, name: str) -> Tuple[Tuple[int, str], ...]:
        """``((dim, axis), ...)``: where a local leaf's GLOBAL tensor is cut
        (an expert table along dim 0 over the expert axis)."""
        if self._is_expert_name(name):
            return ((0, self.expert_axis),)
        return self._shard_entries(name)

    def _require_no_pending_migration(self, what: str) -> None:
        """Between a :meth:`rebucket` and the next step the state still lies
        in the old plan's buffers while the plan is the new one: a sidecar
        written then would describe the wrong layout."""
        if self._pending_state_migration is not None:
            raise RuntimeError(
                f"{what} with a state migration pending (a rebucket queued a layout "
                "change): run one train_step first so the resident state is migrated to "
                "the new bucket plan")

    def _param_keys(self) -> List[str]:
        """The names of the live torch optimizer's parameters, in its order:
        bucket indices (resident) or parameter names (leaf)."""
        if self._flat_resident:
            return [str(i) for i in range(len(self._flats))]
        return list(self._params)

    def _checkpoint_state(self, state: TrainState) -> RankedState:
        """The state a checkpoint holds, split into the part every rank
        shares (written once) and this rank's own: the parameters (the
        bucket flats, or the tensors by name), the optimizer's state by
        parameter key, the algorithm's optimizer state and algorithm state.
        Parameters and optimizer state are per rank where the family's
        weights differ between ranks (gossip, async), and so are the local
        leaves (expert tables, tensor- and pipeline-sharded leaves) and their
        optimizer state; the algorithm's optimizer state is per rank where it
        is sharded (ZeRO) or covers local leaves (QAdam's moments under
        tensor or pipeline parallelism), and the algorithm state (the
        error-feedback residual, peer weights, replicas) always is."""
        algo = self.algorithm
        params = ({"flats": list(self._flats)} if self._flat_resident else dict(self._params))
        optimizer = (None if state.optimizer is None
                     else optimizer_state_tree(state.optimizer, self._param_keys()))
        shared = {"step": int(state.step)}
        own = {"algo_state": to_tree(state.algo_state)}
        local = self._local_names()
        if local:
            # a shard's own leaves and their optimizer state
            own["local_params"] = {n: params.pop(n) for n in local}
            if optimizer is not None:
                own["local_optimizer"] = {n: optimizer["state"].pop(n) for n in local
                                          if n in optimizer["state"]}
        (shared if algo.replicated_params else own).update(params=params, optimizer=optimizer)
        opt_state = algo.checkpoint_opt_state(state.opt_state)
        if algo.sharded_opt_state or not algo.replicated_params or local:
            own["opt_state"] = opt_state
        else:
            shared["opt_state"] = opt_state
        return RankedState(shared, own)

    def save_checkpoint(self, manager, step: int, state: TrainState) -> bool:
        """Save ``state`` with this trainer's layout sidecar: a checkpoint
        saved here restores through :meth:`restore_checkpoint` into any
        compatible trainer layout (flat or leaf, same plan or not).  Call it
        on every rank."""
        self._require_no_pending_migration("save_checkpoint")
        return manager.save(int(step), self._checkpoint_state(state),
                            metadata=self.checkpoint_layout_metadata())

    def restore_checkpoint(self, manager, state_like: TrainState, step: Optional[int] = None):
        """Restore ``step`` (default: the newest verified) into this
        trainer's layout (``backend.py:3307-3356``), converting through the
        saved sidecar where the layouts differ:

        - same layout, and for flat the same plan and world: direct;
        - flat checkpoint -> flat trainer under another plan or world: the
          parameters and optimizer state moved flat to flat
          (:func:`~bagua_tpu_torch.bucket.relayout_flats`);
        - flat checkpoint -> leaf trainer: the tensors rebuilt from the
          sidecar's ``flat_layout``;
        - leaf checkpoint -> flat trainer: the tensors flattened into the
          live plan.

        The error-feedback residual is kept at the same plan, relaid out
        across plans, zero-initialized (loudly) from a checkpoint without
        one, dropped (loudly) by a trainer without one and zero-reset across
        a world resize.  ZeRO's sharded optimizer state stays plan-locked: a
        cross-plan restore raises the manager's layout error.  Per-rank leaf
        state (async model average) restores at another world size only
        when every saved rank's state is bitwise equal
        (``sync_for_checkpoint`` before the save); the other per-rank
        conversions need the saved plan and world.

        Everything is loaded, verified and converted before anything is
        written; then the values are copied in place into the module's
        parameters (or the resident flats, whose views survive) and the
        optimizer's state, and the algorithm's :meth:`on_restore` runs.
        Call it on every rank.  Returns ``(step, state)``."""
        if self._ctx is None:
            raise RuntimeError("restore_checkpoint() needs the bucket plan — call "
                               "trainer.init(model) first")
        self._require_no_pending_migration("restore_checkpoint")
        manager._ensure_active_manager()
        manager.wait()

        def one(s):
            return self._load_checkpoint_at(manager, state_like, s)

        if step is not None:
            s, finish = manager._restore_explicit(int(step), one,
                                                  comm=self.backend.global_communicator)
        else:
            # integrity fallback: a corrupted newest step degrades to the
            # previous verified one on every rank
            s, finish = manager._restore_newest_verified(
                one, comm=self.backend.global_communicator)
        state = finish()
        self.algorithm.on_restore(self)
        return s, state

    def _load_checkpoint_at(self, manager, state_like: TrainState, step: int):
        """Load, verify and convert ``step`` into the live layout; ``(step,
        finish)`` where ``finish()`` copies it into the live state."""
        algo = self.algorithm
        saved = manager.read_layout(step)
        expected = self.checkpoint_layout_metadata()
        if self._check_mesh(step, saved, expected):
            tree = self._load_across_meshes(manager, step, saved)
            tree["algo_state"] = self._ef_restore_adapter(state_like, saved,
                                                          tree.get("algo_state"))
            self._check_restored(state_like, tree)
            return step, functools.partial(self._apply_restored, state_like, tree)
        saved_layout = (manager._normalize_layout(saved) or {}).get("layout")
        same_plan = saved is not None and saved.get("plan_signature") == expected["plan_signature"]
        saved_world = (saved or {}).get("world_size")
        stacked = not algo.replicated_params
        convert = None
        if (stacked and not self._flat_resident and saved_layout == "leaf" and saved_world
                and int(saved_world) != self.comm.nranks()):
            tree = self._load_stacked_resized(manager, step, saved, int(saved_world))
        else:
            direct = (saved is None or (saved_layout == expected["layout"]
                                        and (saved_layout == "leaf" or same_plan))
                      or saved_layout not in ("flat", "leaf") or algo.sharded_opt_state
                      or stacked or saved.get("stacked")
                      or (saved_layout == "flat" and "flat_layout" not in saved))
            if direct:
                manager._check_layout(saved, expected)
            else:
                convert = (saved_layout, (BucketPlan.from_layout_descriptor(saved["flat_layout"])
                                          if saved_layout == "flat" else None))
            manifest, shared, parts = manager._load_step(step, saved)
            own = parts.get(dist.get_rank())
            if manifest["kind"] == "train_state":
                # saved by the manager alone (``mgr.save(step, state)``)
                check_train_state(state_like, own)
                return step, functools.partial(restore_train_state, state_like, own)
            tree = dict(shared or {})
            tree.update(own or {})
            _merge_local_parts(tree)
        if convert is not None:
            tree = self._convert_layout(tree, *convert)
            logger.info("restore_checkpoint: converted step %s from %s layout to %s", step,
                        saved_layout, expected["layout"])
        tree["algo_state"] = self._ef_restore_adapter(state_like, saved,
                                                      tree.get("algo_state"))
        self._check_restored(state_like, tree)
        return step, functools.partial(self._apply_restored, state_like, tree)

    def _check_mesh(self, step: int, saved: Optional[dict], expected: dict) -> bool:
        """Whether ``step`` was saved on another model-parallel mesh, and
        must be re-sliced (:meth:`_load_across_meshes`).  The JAX package
        restores its GLOBAL arrays onto the live shardings
        (``checkpoint.py:702-760``), so it completes such a restore wherever
        the global shapes agree: across tp and pp sizes, and across dp.
        A checkpoint saved with no model axis holds every leaf whole.  Its
        expert tables are stacked by ep rank, so another ep size fails
        there, and raises here; so does ZeRO, whose chunks follow the comm
        world (JAX's restore fails on their shapes too), a family whose
        weights are each rank's own, or a checkpoint with model axes that
        does not record its leaves' placements.  Each error names both
        meshes."""
        saved_mesh, live_mesh = (saved or {}).get("mesh"), expected.get("mesh")
        axes = ("expert_axis", "tp_axis", "pp_axis")
        saved_axes = {k: v for k, v in ((k, (saved or {}).get(k)) for k in axes) if v}
        live_axes = {k: v for k, v in ((k, getattr(self, k)) for k in axes) if v}
        if saved is None or saved_mesh == live_mesh or not (saved_axes or live_axes):
            return False
        reason = None
        ep = lambda mesh, ax: int((mesh or {}).get(ax, 1)) if ax else 1
        if ep(saved_mesh, saved_axes.get("expert_axis")) != ep(live_mesh, self.expert_axis):
            reason = ("another expert-parallel size changes the per-rank expert stacks, which "
                      "the JAX package does not restore either")
        elif self.algorithm.sharded_opt_state:
            reason = (f"{type(self.algorithm).__name__}'s optimizer state is sharded over the "
                      "comm world, whose chunks change with the mesh, as the JAX package's do")
        elif not self.algorithm.replicated_params:
            reason = f"{type(self.algorithm).__name__}'s weights are each rank's own"
        elif saved_axes and (saved.get("layout") != "leaf" or "local_dims" not in saved):
            reason = "the checkpoint records no placements of its sharded leaves"
        if reason is None:
            return True
        saved_text = saved_mesh or f"of world {saved.get('world_size')} (no mesh recorded)"
        live_text = live_mesh or f"of world {self.comm.nranks()} (no mesh)"
        raise ValueError(
            f"checkpoint step {step} was saved on the mesh {saved_text} (model axes "
            f"{saved_axes}), this trainer runs {live_text} (model axes {live_axes}): "
            f"{reason}.  Restore on the saved mesh.")

    def _load_across_meshes(self, manager, step: int, saved: dict) -> dict:
        """A checkpoint of a replicated family saved on another mesh, on
        this one.  Each leaf the saved trainer kept local, and each state
        tensor kept for it by name (the torch optimizer's, QAdam's moments),
        is put together into its GLOBAL tensor from the saved ranks of the
        first replica (coordinate 0 on every axis it is not cut over), so
        only rank 0's part and theirs are read; the other leaves were saved
        whole.  The tree is laid out as the live trainer's state
        (:meth:`_convert_layout`), and every tensor kept by the name of a
        live local leaf is then cut to this rank's slice."""
        placements = {n: [(int(d), a) for d, a in e]
                      for n, e in saved.get("local_dims", {}).items()}
        holders: Dict[str, Dict[tuple, int]] = {}
        if placements:
            saved_mesh = Mesh({a: int(n) for a, n in saved["mesh"].items()}, 0)
            coords = [dict(zip(saved_mesh.axis_names, (int(c) for c in np.unravel_index(
                r, saved_mesh.ranks.shape)))) for r in range(saved_mesh.size)]
            # name -> {its coordinates on the axes it is cut over: saved rank}
            holders = {n: {tuple(coords[r][a] for _, a in e): r for r in range(saved_mesh.size)
                           if not any(coords[r][a] for a in saved_mesh.axis_names
                                      if a not in [ax for _, ax in e])}
                       for n, e in placements.items()}
        wanted = sorted({0}.union(*(h.values() for h in holders.values())))
        _, shared, parts = manager._load_step(step, saved, ranks=wanted)

        def whole(name, pieces):
            return _put_together({k: pieces[r] for k, r in holders[name].items()},
                                 placements[name], saved_mesh.shape)

        def merge(trees, name=None):
            """``trees`` (saved rank -> the same subtree) as one tree: a
            tensor kept under a local leaf's name put together, the rest
            rank 0's."""
            first = trees[0]
            if isinstance(first, dict):
                return {k: merge({r: t[k] for r, t in trees.items()},
                                 k if k in placements else name) for k in first}
            if isinstance(first, (list, tuple)):
                return type(first)(merge({r: t[i] for r, t in trees.items()}, name)
                                   for i in range(len(first)))
            return whole(name, trees) if name and torch.is_tensor(first) and first.dim() else first

        tree = dict(shared or {})
        tree.update({k: v for k, v in parts[0].items()
                     if k not in ("local_params", "local_optimizer")})
        if placements:
            params = dict(tree["params"])
            params.update(merge({r: p["local_params"] for r, p in parts.items()}))
            tree["params"] = params
            if tree.get("optimizer") is not None:
                # a local leaf's moments are shaped like its slice; its step
                # count is rank 0's
                state = dict(tree["optimizer"]["state"])
                state.update(merge({r: p.get("local_optimizer", {}) for r, p in parts.items()}))
                tree["optimizer"] = {**tree["optimizer"], "state": state}
            if tree.get("opt_state") is not None:
                tree["opt_state"] = merge({r: p["opt_state"] for r, p in parts.items()})
        saved_layout = saved.get("layout", "leaf")
        tree = self._convert_layout(tree, saved_layout, (
            BucketPlan.from_layout_descriptor(saved["flat_layout"])
            if saved_layout == "flat" else None))
        live_local = set(self._local_names())

        def cut(x, name=None):
            if isinstance(x, dict):
                return {k: cut(v, k if k in live_local else name) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(cut(v, name) for v in x)
            return self._live_slice(name, x) if name and torch.is_tensor(x) and x.dim() else x

        for key in ("params", "optimizer", "opt_state"):
            if tree.get(key) is not None:
                tree[key] = cut(tree[key])
        logger.info("restore_checkpoint: re-sliced step %s from the mesh %s onto %s", step,
                    saved.get("mesh"), {a: int(n) for a, n in self.mesh.shape.items()}
                    if self.mesh is not None else None)
        return tree

    def _live_slice(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the GLOBAL tensor ``t`` of a local leaf."""
        for dim, axis in self._placements(name):
            n = self.mesh.shape[axis]
            size = t.shape[dim] // n
            t = t.narrow(dim, self.mesh.coords[axis] * size, size)
        return t.clone()

    def _load_stacked_resized(self, manager, step: int, saved: dict, saved_world: int) -> dict:
        """Per-rank leaf state across a world resize (``backend.py:3625-3713``):
        every saved rank's part is loaded and must be bitwise equal to rank
        0's (``AsyncModelAverageAlgorithm.sync_for_checkpoint`` before the
        save); rank 0's is then every live rank's."""
        _, shared, parts = manager._load_step(step, saved, ranks=range(saved_world))
        first = compute_state_digest(parts[0])["digest"]
        for r in range(1, saved_world):
            if compute_state_digest(parts[r])["digest"] != first:
                raise ValueError(
                    f"stacked checkpoint step {step} (world {saved_world}) has DIVERGENT "
                    "per-rank rows — it cannot restore onto a resized world "
                    f"({self.comm.nranks()} ranks).  Save resize-portable async checkpoints "
                    "via algorithm.sync_for_checkpoint(trainer, state) (a blocking "
                    "synchronous model average) right before save_checkpoint, or restore at "
                    "the original world size.")
        counters.incr("ckpt/stacked_resize_restores")
        logger.info("restore_checkpoint: re-tiled stacked step %s from world %d onto world %d "
                    "(rank rows verified bit-identical)", step, saved_world, self.comm.nranks())
        tree = dict(shared or {})
        tree.update(parts[0])
        return tree

    def _convert_layout(self, tree: dict, saved_layout: str,
                        old_plan: Optional[BucketPlan]) -> dict:
        """A replicated family's checkpoint tree moved from the saved layout
        (``flat`` under ``old_plan``, or ``leaf``) onto the live one: the
        parameters, the optimizer's state, and every part of the
        algorithm's optimizer state laid out like the parameters (QAdam's
        moments).  The algorithm state (the residual) is the adapter's."""
        plan = self.plan
        names = [t.name for b in plan.buckets for t in b.tensors]
        if tree.get("optimizer") is not None and len(tree["optimizer"]["groups"]) > 1:
            want = "off" if saved_layout == "leaf" else "on"
            raise ValueError(
                "restore_checkpoint cannot convert across layouts or plans for an optimizer of "
                f"{len(tree['optimizer']['groups'])} parameter groups: the flat layout steps "
                "one group over the bucket flats, so the groups have no flat mirror.  Restore "
                f"into a trainer with the checkpoint's own layout (flat_resident='{want}') and "
                "bucket plan.")

        def to_named(x):
            if saved_layout == "leaf":
                return dict(x)
            return {n: v.clone() for n, v in old_plan.unflatten(list(x)).items()}

        def from_named(named):
            if not self._flat_resident:
                return named
            return plan.flatten(named)

        def is_param_like(x):
            if saved_layout == "leaf":
                return isinstance(x, dict) and set(x) == set(names)
            return (isinstance(x, (list, tuple)) and len(x) == len(old_plan.buckets)
                    and all(isinstance(t, torch.Tensor) and t.shape == (b.padded_numel,)
                            for t, b in zip(x, old_plan.buckets)))

        def walk(x):
            if is_param_like(x):
                return from_named(to_named(x))
            if isinstance(x, dict):
                return {k: walk(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(walk(v) for v in x)
            return x

        out = dict(tree)
        params = tree["params"]
        named = to_named(params["flats"] if saved_layout == "flat" else params)
        out["params"] = {"flats": plan.flatten(named)} if self._flat_resident else named
        if tree.get("optimizer") is not None:
            out["optimizer"] = self._convert_optimizer(tree["optimizer"], saved_layout, old_plan)
        if tree.get("opt_state") is not None:
            out["opt_state"] = walk(tree["opt_state"])
        return out

    def _convert_optimizer(self, opt_tree: dict, saved_layout: str,
                           old_plan: Optional[BucketPlan],
                           plan: Optional[BucketPlan] = None) -> dict:
        """An optimizer state tree (:func:`optimizer_state_tree`) moved from
        the saved layout onto the live one (the flats of ``plan``, by
        default the trainer's), through the state by parameter name: a
        tensor shaped like its parameter (AdamW's moments) is sliced or
        flattened, anything else (the step count) taken from the first
        parameter of the bucket."""
        named: Dict[str, dict] = {}
        if saved_layout == "leaf":
            named = {n: dict(st) for n, st in opt_tree["state"].items()}
        else:
            for i, b in enumerate(old_plan.buckets):
                st = opt_tree["state"].get(str(i))
                if st is None:
                    continue
                for t, off in zip(b.tensors, b.offsets()):
                    named[t.name] = {
                        k: (v[off:off + t.numel].reshape(t.shape).clone()
                            if torch.is_tensor(v) and v.shape == (b.padded_numel,)
                            else (v.clone() if torch.is_tensor(v) else v))
                        for k, v in st.items()}
        keys = self._param_keys()
        hyper = opt_tree["groups"][0]["hyper"]
        if not self._flat_resident:
            return {"groups": [{"hyper": hyper, "params": keys}],
                    "state": {n: named[n] for n in keys if n in named}}
        state = {}
        for i, b in enumerate((plan or self.plan).buckets):
            sts = [named.get(t.name) for t in b.tensors]
            if sts[0] is None:
                continue
            st = {}
            for k, v0 in sts[0].items():
                if torch.is_tensor(v0) and all(
                        torch.is_tensor(s[k]) and s[k].shape == t.shape
                        for s, t in zip(sts, b.tensors)):
                    st[k] = b.flatten_of({t.name: s[k] for s, t in zip(sts, b.tensors)})
                else:
                    st[k] = v0
            state[str(i)] = st
        return {"groups": [{"hyper": hyper, "params": keys}], "state": state}

    def _ef_restore_adapter(self, state_like: TrainState, saved: Optional[dict], restored):
        """The error-feedback residual of a restore (``backend.py:3372-3475``):
        ``restored`` (the checkpoint's algorithm state) moved into the live
        trainer's.  Kept at the same plan and world; relaid out across plans;
        zero from a checkpoint without one (saved before the codec was
        enabled); dropped where the live trainer carries none; zero across a
        world resize, whose ranks' residuals have no meaning in the new
        world.  Unchanged when neither side carries one, or the checkpoint
        has no sidecar."""
        a = state_like.algo_state
        has_live = isinstance(a, dict) and "ef" in a
        saved_ef = (saved or {}).get("ef")
        if saved is None or (not has_live and saved_ef is None):
            return restored
        if not has_live:
            if isinstance(restored, dict) and "ef" in restored:
                logger.warning(
                    "restore_checkpoint: discarding the checkpoint's error-feedback residual — "
                    "no stateful codec is active in this trainer (compress knobs / "
                    "BAGUA_EF_RESIDUAL).  Re-enable the codec policy before restoring to keep "
                    "the accumulated error.")
                rest = {k: v for k, v in restored.items() if k != "ef"}
                return rest or None
            return restored
        zeros = {"buckets": tuple(torch.zeros_like(b) for b in a["ef"]["buckets"])}
        merged = dict(restored) if isinstance(restored, dict) else {}
        if saved_ef is None:
            logger.warning(
                "restore_checkpoint: checkpoint carries no error-feedback residual (saved "
                "before the stateful codec was enabled): starting from ZERO residuals — "
                "convergence-neutral, the error feedback re-warms within a few steps")
            merged["ef"] = zeros
            return merged
        live_world = int(self.comm.nranks())
        if int(saved_ef["world"]) != live_world:
            logger.warning(
                "restore_checkpoint: error-feedback residual was saved at world_size=%d, "
                "trainer runs %d (elastic resize): zero-resetting the residual — "
                "convergence-neutral, the error feedback re-warms within a few steps",
                int(saved_ef["world"]), live_world)
            merged["ef"] = zeros
            return merged
        ef_plan = BucketPlan.from_layout_descriptor(saved_ef["flat_layout"])
        if ef_plan.signature() != self.plan.signature():
            logger.info("restore_checkpoint: relaying out the error-feedback residual %d -> %d "
                        "buckets", len(ef_plan.buckets), len(self.plan.buckets))
            merged["ef"] = self.algorithm.relayout_algo_state(
                ef_plan, self.plan, {"ef": merged["ef"]})["ef"]
        return merged

    def _check_restored(self, state_like: TrainState, tree: dict) -> None:
        """Raise :class:`CheckpointIntegrityError` unless the converted
        ``tree`` fits the live state (structure and shapes), before any rank
        writes anything."""
        for key in ("step", "params", "algo_state"):
            if key not in tree:
                raise CheckpointIntegrityError(f"checkpoint misses the {key!r} part")
        live_params = ({"flats": list(self._flats)} if self._flat_resident
                       else dict(self._params))
        check_tree(live_params, tree["params"], "['params']")
        if state_like.optimizer is not None:
            check_optimizer_state_tree(state_like.optimizer, tree.get("optimizer"),
                                       self._param_keys(), "['optimizer']")
        self.algorithm.check_opt_state(state_like.opt_state, tree.get("opt_state"))

    @torch.no_grad()
    def _apply_restored(self, state_like: TrainState, tree: dict) -> TrainState:
        """Copy a checked tree into the live state in place: the parameters
        (or the resident flats), the optimizer's state through its
        ``load_state_dict``, the algorithm's optimizer state; the algorithm
        state is copied in place where it has the live structure."""
        if self._flat_resident:
            for f, v in zip(self._flats, tree["params"]["flats"]):
                f.copy_(v)
        else:
            for n, v in tree["params"].items():
                self._params[n].copy_(v)
        if state_like.optimizer is not None:
            load_optimizer_state_tree(state_like.optimizer, tree["optimizer"],
                                      self._param_keys())
        opt_state = self.algorithm.restore_opt_state(state_like.opt_state, tree.get("opt_state"))
        saved_algo = tree["algo_state"]
        try:
            check_tree(state_like.algo_state, saved_algo)
            algo_state = apply_tree(state_like.algo_state, saved_algo)
        except CheckpointIntegrityError:
            algo_state = copy_tree(saved_algo, device=self.device)
        return dataclasses.replace(state_like, step=int(tree["step"]), opt_state=opt_state,
                                   algo_state=algo_state)



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


def _put_together(pieces: Dict[tuple, torch.Tensor], entries, sizes) -> torch.Tensor:
    """The GLOBAL tensor of the blocks ``pieces`` (keyed by the coordinates
    on the axes of ``entries``, in order), each ``(dim, axis)`` of
    ``entries`` concatenated along its dim."""
    if not entries:
        return pieces[()]
    (dim, axis), rest = entries[0], entries[1:]
    return torch.cat([_put_together({k[1:]: v for k, v in pieces.items() if k[0] == c},
                                    rest, sizes)
                      for c in range(int(sizes[axis]))], dim=dim)


def _merge_local_parts(tree: dict) -> None:
    """Put a rank's own local leaves and their optimizer state (saved apart
    from the shared parameters) back into the tree's ``params`` and
    ``optimizer``, in place."""
    local_params = tree.pop("local_params", None)
    local_opt = tree.pop("local_optimizer", None)
    if local_params:
        tree["params"] = {**tree["params"], **local_params}
    if local_opt and tree.get("optimizer") is not None:
        tree["optimizer"] = {**tree["optimizer"],
                             "state": {**tree["optimizer"]["state"], **local_opt}}


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
