"""Process group, collectives and the ring collectives over
``torch.distributed``.

Port of ``bagua_tpu/communication.py``: ``ReduceOp``,
:func:`init_process_group`, a :class:`BaguaCommunicator` over a process group
(allreduce of every ``ReduceOp``, allgather, reduce_scatter and alltoall
along any axis, the ragged ``alltoall_v``, broadcast, ppermute, the pairwise
``exchange_with_peer``, barrier, the ring reduce-scatter / allgather /
allreduce, chunked into independent sub-rings and with an optional wire
codec), the chunk sizing of the overlap scheduler (:func:`ring_chunks_for`),
:func:`get_backend`, whose :class:`BaguaBackend` holds the global
communicator and the two tiers of the hierarchical collectives, the eager
collective API (:func:`allreduce`, :func:`allgather`, ...,
:func:`send_recv`, :func:`barrier`) and the process-wide abort flag
(:func:`abort`, :func:`check_abort`), and the autotune sidecar's start on
rank 0 (:func:`start_autotune_server`) with its client
(:func:`get_hyperparameters_service_client`).  NCCL carries the collectives
on the card, gloo on the CPU.  Even at world size 1 every bucket goes through a real
``all_reduce``.

The eager API takes this process's own rank's tensor and returns its own
result: the JAX package's calls take a leading rank axis, because one process
holds every rank there.

Tiers.  The JAX package splits its device mesh into an ``intra`` axis
(slice-local ICI) and an ``inter`` axis (cross-slice DCN,
``parallel/mesh.py:66-85``).  Here they are process groups: the intra-node
groups hold ``intra_size`` consecutive ranks, the inter-node groups the ranks
of one local index; rank ``r`` is intra-node rank ``r % intra_size`` and
inter-node rank ``r // intra_size``.

gloo takes CUDA tensors for ``all_reduce`` and ``broadcast`` only.  On a gloo
group (which a caller may pick for CUDA tensors, for example to run two
ranks on one card, where NCCL refuses a second rank on the same device) the
other collectives copy a CUDA operand to the host, run there and copy the
result back; gloo's own CUDA ``all_reduce`` and ``broadcast`` do the same
inside gloo.  ``BaguaCommunicator.host_staged_bytes`` counts the bytes of
both (each direction) for the communicator's collectives.  An NCCL group
never stages.  The port's staging goes through pinned host buffers that the
communicator keeps from call to call (one a shape, dtype and role), with
non-blocking copies on the current stream: the copy to the host is waited
for through an event before gloo reads the buffer, and the copy back is
ordered by an event that the next user of the buffer waits for.  The
current stream is the caller's, so the overlap scheduler's comm stream
stages on its own stream.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import threading
from enum import IntEnum
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from . import env
from . import watchdog as _watchdog
from .device import resolve_device
from .telemetry import counters

logger = logging.getLogger(__name__)


# Numbering matches the reference (and hence Aluminum's ReductionOperator).
class ReduceOp(IntEnum):
    SUM = 0
    PRODUCT = 1
    MIN = 2
    MAX = 3
    BOR = 7
    BAND = 8
    BXOR = 9
    AVG = 10


#: the reductions the process groups carry themselves (AVG is a SUM then a
#: division: gloo has no AVG)
_DIST_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG: dist.ReduceOp.SUM,
             ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT, ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.MAX: dist.ReduceOp.MAX}
#: the bitwise reductions: gloo's own op, and the local fold of the gathered
#: operands where the group has none (NCCL)
_BITWISE_OPS = {ReduceOp.BOR: (dist.ReduceOp.BOR, torch.bitwise_or),
                ReduceOp.BAND: (dist.ReduceOp.BAND, torch.bitwise_and),
                ReduceOp.BXOR: (dist.ReduceOp.BXOR, torch.bitwise_xor)}

#: payload types no collective backend is relied on to carry; they move as
#: bytes (every collective that carries them only moves data)
_BYTE_VIEW_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)

# the flat-output collectives under their newer names where this PyTorch has
# them (the older ones are deprecated there)
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_flat = (getattr(dist, "reduce_scatter_single", None)
                        or dist.reduce_scatter_tensor)


#: link classes of the two tiers, under the JAX package's names (there ICI is
#: the slice-local interconnect and DCN the cross-slice network), so that the
#: codec policy reads the same: here ``LINK_ICI`` is the intra-node tier and
#: the flat ring, ``LINK_DCN`` the inter-node tier
LINK_ICI = "ici"
LINK_DCN = "dcn"


# -- the abort flag (``bagua_tpu/communication.py:64-121``) --------------------
#
# A process-wide flag: once raised, the trainer refuses new steps
# (:func:`check_abort` at the top of ``train_step``) and async model averaging
# stops launching rounds.  PyTorch cannot cancel a collective in flight
# either, so a raised flag stops new work only.

_ABORT_EVENT = threading.Event()
_ABORT_REASON: Optional[str] = None


class BaguaAborted(RuntimeError):
    """Raised by :func:`check_abort` after :func:`abort` was called."""


def abort(reason: str = "user abort") -> None:
    """Flag every communicator as aborted: collectives in flight finish, no
    new communication is started."""
    global _ABORT_REASON
    # lock-free by design (as ``bagua_tpu/communication.py:84-88``): the
    # Event is the synchronization point (the reason is written before
    # set(), so a reader that saw the event sees the reason), the store is
    # one GIL-atomic reference assignment, and check_abort falls back to
    # "aborted" on a stale read
    _ABORT_REASON = reason  # bagua: lint-ignore[unguarded-shared-write] -- Event-published; GIL-atomic store; stale read falls back to "aborted"
    _ABORT_EVENT.set()
    counters.incr("comm/aborts")
    logger.error("bagua_tpu_torch: communication aborted: %s", reason)


def is_aborted() -> bool:
    return _ABORT_EVENT.is_set()


def check_abort() -> None:
    """Raise :class:`BaguaAborted` if :func:`abort` has been called."""
    if _ABORT_EVENT.is_set():
        raise BaguaAborted(_ABORT_REASON or "aborted")


def reset_abort() -> None:
    """Clear the abort flag (the recovery path once the cause is handled)."""
    global _ABORT_REASON
    was_aborted = _ABORT_EVENT.is_set()
    _ABORT_REASON = None
    _ABORT_EVENT.clear()
    if was_aborted:
        from .faults import inject as _inject

        counters.incr("comm/abort_resets")
        # an injected collective hang that reached the abort and was reset
        # is a completed recovery
        _inject.record_recovery("collective.hang")


def _launcher_init_method() -> Optional[str]:
    """The rendezvous the launcher injected (``bagua_tpu_torch.distributed.run``):
    ``BAGUA_COORDINATOR_ADDR``, else ``MASTER_ADDR:MASTER_PORT``, as a
    ``tcp://`` init method; None without either."""
    addr = env.get_coordinator_addr()
    if addr is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return f"tcp://{addr}" if addr else None


def init_process_group(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device=None,
    backend: Optional[str] = None,
    intra_size: Optional[int] = None,
) -> "BaguaBackend":
    """Initialize distributed state; call before the other APIs.

    ``device`` is where this rank's tensors live: ``cuda`` (the default; an
    index-less ``cuda`` means ``cuda:<LOCAL_RANK>``) or ``cpu``.
    ``backend`` is the collective backend, by default NCCL for ``cuda`` and
    gloo for ``cpu``; gloo with ``cuda`` stages what gloo cannot take
    through host memory (see the module docstring).  Without
    ``init_method`` a single process forms a world of 1 from an in-process
    store (no network), and a process of a larger world joins the
    launcher's rendezvous (``BAGUA_COORDINATOR_ADDR``, else
    ``MASTER_ADDR:MASTER_PORT``, hosted by rank 0); processes started
    otherwise pass ``init_method`` (``tcp://host:port``, ``file://path`` or
    ``env://``).  ``world_size`` and ``rank`` default to
    ``WORLD_SIZE``/``RANK``.  The device is the caller's: the launcher
    picks none.  ``intra_size``
    is the ranks per node of the two tiers (default ``LOCAL_WORLD_SIZE``,
    else the world size).  Calling it again returns the existing backend.
    """
    device = resolve_device(device)
    if not dist.is_initialized():
        if backend is None:
            backend = "nccl" if device.type == "cuda" else "gloo"
        world_size = env.get_world_size() if world_size is None else world_size
        rank = env.get_rank() if rank is None else rank
        if rank == 0 and env.get_bagua_service_port() > 0:
            # before the rendezvous: the sidecar is listening before any
            # rank can get past it and register its tensors
            start_autotune_server(world_size)
        if device.type == "cuda":
            torch.cuda.set_device(env.get_local_rank() if device.index is None
                                  else device.index)
        if init_method is None and world_size != 1:
            init_method = _launcher_init_method()
            if init_method is None:
                raise ValueError(f"world_size {world_size} needs an init_method (or the "
                                 "launcher's BAGUA_COORDINATOR_ADDR / MASTER_ADDR and "
                                 "MASTER_PORT)")
        if init_method is None:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
        else:
            dist.init_process_group(backend, init_method=init_method,
                                    world_size=world_size, rank=rank)
    global _BACKEND
    if _BACKEND is None:
        _BACKEND = BaguaBackend(intra_size)
    return _BACKEND


_AUTOTUNE_SERVER = None
_AUTOTUNE_SERVER_LOCK = threading.Lock()


def start_autotune_server(world_size: Optional[int] = None):
    """Start the autotune sidecar on this process (reference
    communication.py:95-104; ``bagua_tpu/communication.py:638``), on
    ``BAGUA_SERVICE_PORT`` with the ``BAGUA_AUTOTUNE_*`` settings, and
    return its HTTP server.

    It runs on a daemon thread of the calling process, where the JAX
    package forks a process.  A fork of a process that holds a CUDA
    context, gloo's threads and the watchdog is not safe, and a spawned
    process would import torch first (seconds) while the ranks register
    at once.  The server is bound, so listening, when this returns; its
    handlers are host-side JSON and the optimizer's arithmetic.  It lives
    as long as the process: rank 0's exit ends it, as the JAX package's
    daemon process ends with its parent.  Idempotent; None (with a
    warning) where the port cannot be bound."""
    global _AUTOTUNE_SERVER
    with _AUTOTUNE_SERVER_LOCK:
        if _AUTOTUNE_SERVER is not None:
            return _AUTOTUNE_SERVER
        from .service.autotune_service import AutotuneService, make_server

        service = AutotuneService(
            world_size=env.get_world_size() if world_size is None else world_size,
            autotune_level=env.get_autotune_level(),
            max_samples=env.get_autotune_max_samples(),
            sampling_confidence_time_s=env.get_autotune_sampling_confidence_time_s(),
            warmup_time_s=env.get_autotune_warmup_time_s(),
            is_output_autotune_log=env.is_output_autotune_log(),
            default_bucket_size=env.get_default_bucket_size(),
            tune_algorithm=env.is_autotune_algorithm_on(),
        )
        try:
            server = make_server(env.get_bagua_service_port(), service)
        except OSError as e:
            # as the JAX package's child process fails alone: the run goes
            # on, and its trainers talk to whatever listens on the port
            logger.warning("autotune service not started on :%d: %s",
                           env.get_bagua_service_port(), e)
            return None
        server.daemon_threads = True
        threading.Thread(target=server.serve_forever, name="bagua-autotune-service",
                         daemon=True).start()
        logger.info("autotune service listening on :%d", server.server_address[1])
        _AUTOTUNE_SERVER = server
        return server


def stop_autotune_server() -> None:
    """Shut the sidecar started by :func:`start_autotune_server` down (a
    later start brings up a new one)."""
    global _AUTOTUNE_SERVER
    with _AUTOTUNE_SERVER_LOCK:
        server, _AUTOTUNE_SERVER = _AUTOTUNE_SERVER, None
    if server is not None:
        server.shutdown()
        server.server_close()


@functools.lru_cache(maxsize=None)
def get_hyperparameters_service_client():
    """The autotune service's client, at ``MASTER_ADDR`` (default
    127.0.0.1) and ``BAGUA_SERVICE_PORT`` (``bagua_tpu/communication.py:667``)."""
    from .service.autotune_service import AutotuneClient

    return AutotuneClient(os.environ.get("MASTER_ADDR", "127.0.0.1"),
                          env.get_bagua_service_port())


class _HostBuffers:
    """Pinned host buffers of one communicator, one a (shape, dtype, role),
    kept from call to call.  A buffer that a copy back to the card still
    reads carries that copy's event; handing the buffer out again waits for
    it.  One thread at a time uses a communicator (the overlap scheduler's
    comm worker holds it through the backward, the main thread otherwise),
    so the dicts need no lock."""

    def __init__(self):
        self._bufs: Dict[tuple, torch.Tensor] = {}
        #: data pointer of a buffer -> the event of the last copy reading it
        self._pending: Dict[int, torch.cuda.Event] = {}

    def get(self, shape, dtype, role: str) -> torch.Tensor:
        key = (tuple(shape), dtype, role)
        buf = self._bufs.get(key)
        if buf is None:
            buf = self._bufs[key] = torch.empty(key[0], dtype=dtype, pin_memory=True)
        done = self._pending.pop(buf.data_ptr(), None)
        if done is not None:
            done.synchronize()
        return buf

    def read_by_device(self, buf: torch.Tensor) -> None:
        """Note that a copy enqueued on the current stream reads ``buf`` (one
        of these buffers)."""
        done = torch.cuda.Event()
        done.record()
        self._pending[buf.data_ptr()] = done


# -- the collective-call log (``bagua_tpu_torch.analysis.collective_check``) --
#
# Every blocking call of a communicator passes through ``_watched``; while a
# recorder is installed it reports ``(op, communicator, args)`` there: the
# operand's shape and dtype are metadata, so recording adds no device
# synchronization.  ``recording_tag`` tags the calls made on this thread:
# a bucket's reduction with the bucket's index, the plan's upkeep (the
# overlap scheduler's readiness negotiation) with ``"plan"``.

#: None, or the callable every blocking communicator call reports to
_COLLECTIVE_RECORDER: Optional[Callable] = None
_RECORD_TAG = threading.local()


@contextlib.contextmanager
def recording_tag(tag: Union[int, str]):
    """Tag the collectives of this thread with ``tag`` (a bucket index, or
    ``"plan"``) while a recorder is installed (a no-op otherwise)."""
    if _COLLECTIVE_RECORDER is None:
        yield
        return
    prev = getattr(_RECORD_TAG, "tag", None)
    _RECORD_TAG.tag = tag
    try:
        yield
    finally:
        _RECORD_TAG.tag = prev


def recorded_tag() -> Optional[Union[int, str]]:
    """The tag this thread's collectives carry, if any."""
    return getattr(_RECORD_TAG, "tag", None)


def collapse_trivial_axes(mesh, axes) -> Tuple[str, ...]:
    """``axes`` of ``mesh`` (a :class:`~bagua_tpu_torch.parallel.mesh.Mesh`)
    without the size-1 ones, keeping at least the last
    (``communication.py:124-129``)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    nontrivial = tuple(a for a in axes if mesh.shape[a] > 1)
    return nontrivial if nontrivial else axes[-1:]


def _watched(fn):
    """Run a blocking call of the communicator inside a section of the
    process's hang watchdog, when it has one.  A gloo collective blocks the
    calling thread until every peer has joined, so a peer that hangs with
    its socket open (a deadlock, a stopped process, a partition) keeps the
    section open past the timeout; an NCCL call returns once enqueued, and
    the step's event fences its device work.  An installed collective
    recorder sees the call first."""
    label = f"comm.{fn.__name__}"
    op = fn.__name__

    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        recorder = _COLLECTIVE_RECORDER
        if recorder is not None:
            recorder(op, self, args)
        watchdog = _watchdog.active()
        if watchdog is None:
            return fn(self, *args, **kwargs)
        with watchdog.watch(label):
            return fn(self, *args, **kwargs)
    return call


class BaguaCommunicator:
    """The ranks of one process group (``None``: the default group, every
    rank).  ``nranks`` and ``rank`` count within the group."""

    def __init__(self, group=None):
        self.group = group
        self.stages_cuda = dist.get_backend(group) == "gloo"
        #: bytes of CUDA operands copied to and from the host for gloo (by
        #: this port or inside gloo's all_reduce and broadcast)
        self.host_staged_bytes = 0
        self._host = _HostBuffers()

    def nranks(self) -> int:
        return dist.get_world_size(self.group)

    def rank(self) -> int:
        return dist.get_rank(self.group)

    def _global_rank(self, r: int) -> int:
        """The global rank of group rank ``r``: a point-to-point peer is
        named by its global rank even inside a group."""
        return r if self.group is None else dist.get_global_rank(self.group, r)

    # -- host staging for gloo ----------------------------------------------

    def _to_wire(self, x: torch.Tensor, role: str = "send") -> torch.Tensor:
        """The contiguous tensor a data-moving collective sends for ``x``:
        bytes for the types in ``_BYTE_VIEW_DTYPES``, and for a CUDA tensor
        on a gloo group its copy in the pinned buffer of ``role``, complete
        when this returns."""
        x = x.contiguous()
        if x.dtype in _BYTE_VIEW_DTYPES:
            x = x.view(torch.uint8)
        if self.stages_cuda and x.is_cuda:
            self.host_staged_bytes += x.numel() * x.element_size()
            buf = self._host.get(x.shape, x.dtype, role)
            buf.copy_(x, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record()
            copied.synchronize()   # gloo reads the buffer on the host
            x = buf
        return x

    def _wire_empty(self, shape, like: torch.Tensor, role: str = "recv") -> torch.Tensor:
        """The tensor a collective receives into for an operand like
        ``like``: for a CUDA tensor on a gloo group the pinned buffer of
        ``role``."""
        dtype = torch.uint8 if like.dtype in _BYTE_VIEW_DTYPES else like.dtype
        if self.stages_cuda and like.is_cuda:
            return self._host.get(shape, dtype, role)
        device = "cpu" if self.stages_cuda else like.device
        return torch.empty(shape, dtype=dtype, device=device)

    def _from_wire(self, y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`_to_wire` for a received tensor: a staged one
        comes back to ``like``'s device by a copy on the current stream,
        which the buffer's next user waits for."""
        if y.device != like.device:
            self.host_staged_bytes += y.numel() * y.element_size()
            out = torch.empty(y.shape, dtype=y.dtype, device=like.device)
            out.copy_(y, non_blocking=True)
            self._host.read_by_device(y)
            y = out
        return y.view(like.dtype) if like.dtype in _BYTE_VIEW_DTYPES else y

    # -- collectives ---------------------------------------------------------

    def _count_allreduce_staging(self, x: torch.Tensor) -> None:
        if self.stages_cuda and x.is_cuda:
            # gloo copies the operand to the host and the result back
            self.host_staged_bytes += 2 * x.numel() * x.element_size()

    @_watched
    def allreduce(self, x: torch.Tensor, op: ReduceOp = ReduceOp.AVG) -> torch.Tensor:
        """The reduction of ``x`` over the ranks by ``op``, in place in
        ``x``'s storage, returned.  AVG is a sum then a division, since gloo
        has no AVG.  The bitwise ops (BOR, BAND, BXOR) take integer and bool
        tensors only; gloo reduces them itself, NCCL, which has no bitwise
        reductions, gathers the operands and folds them locally in rank
        order (JAX's form for its rare ops, ``communication.py:176-186``)."""
        if op in _BITWISE_OPS:
            return self._allreduce_bitwise(x, op)
        if op not in _DIST_OPS:
            raise ValueError(f"unsupported ReduceOp {op!r}")
        self._count_allreduce_staging(x)
        dist.all_reduce(x, _DIST_OPS[op], group=self.group)
        if op == ReduceOp.AVG:
            x.div_(self.nranks())
        return x

    def _allreduce_bitwise(self, x: torch.Tensor, op: ReduceOp) -> torch.Tensor:
        if x.is_floating_point() or x.is_complex():
            raise TypeError(f"{op.name} takes integer or bool tensors, got {x.dtype}")
        dist_op, fold = _BITWISE_OPS[op]
        if dist.get_backend(self.group) == "gloo":
            # gloo carries no bool: a bool's byte is 0 or 1, and the bitwise
            # ops keep it so
            wire = x.view(torch.uint8) if x.dtype == torch.bool else x
            self._count_allreduce_staging(wire)
            dist.all_reduce(wire, dist_op, group=self.group)
            return x
        gathered = self.allgather(x, tiled=False)
        return x.copy_(functools.reduce(fold, gathered.unbind(0)))

    def allreduce_start(self, x: torch.Tensor):
        """Start the sum of ``x`` over the ranks, in place, without waiting:
        returns the collective's work, which the caller waits on before it
        reads ``x`` (async model average's round on its own group)."""
        recorder = _COLLECTIVE_RECORDER
        if recorder is not None:
            recorder("allreduce_start", self, (x,))
        self._count_allreduce_staging(x)
        return dist.all_reduce(x, dist.ReduceOp.SUM, group=self.group, async_op=True)

    @_watched
    def barrier(self) -> None:
        """Block until every rank of the group has reached the barrier."""
        dist.barrier(group=self.group)

    @_watched
    def allgather(self, x: torch.Tensor, axis: int = 0, tiled: bool = True) -> torch.Tensor:
        """Every rank's ``x`` in rank order (``lax.all_gather``):
        concatenated along ``axis`` (``tiled``), or stacked on a new axis at
        ``axis`` of the result (a negative ``axis`` counts from the end of
        the result, which has one more dim than ``x``)."""
        n = self.nranks()
        if tiled:
            axis = _axis(axis, x.dim())
            x = x.movedim(axis, 0)
        else:
            axis = _axis(axis, x.dim() + 1)
        wire = self._to_wire(x)
        out = self._wire_empty((n * x.shape[0],) + tuple(x.shape[1:]), x)
        _all_gather_flat(out, wire, group=self.group)
        out = self._from_wire(out, x)
        if tiled:
            return out.movedim(0, axis)
        return out.reshape((n,) + tuple(x.shape)).movedim(0, axis)

    @_watched
    def reduce_scatter(self, x: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
                       axis: int = 0) -> torch.Tensor:
        """This rank's contiguous 1/n block along ``axis`` of the sum (SUM)
        or mean (AVG) of ``x`` over the ranks (``lax.psum_scatter``,
        ``tiled=True``)."""
        if op not in (ReduceOp.SUM, ReduceOp.AVG):
            raise ValueError(f"reduce_scatter supports SUM/AVG, got {op}")
        n = self.nranks()
        axis = _axis(axis, x.dim())
        if x.shape[axis] % n:
            raise ValueError(f"dim {axis} of {tuple(x.shape)} does not split over {n} ranks")
        x = x.movedim(axis, 0)
        wire = self._to_wire(x)
        out = self._wire_empty((x.shape[0] // n,) + tuple(x.shape[1:]), x)
        _reduce_scatter_flat(out, wire, group=self.group)
        out = self._from_wire(out, x).movedim(0, axis)
        return out / n if op == ReduceOp.AVG else out

    @_watched
    def alltoall(self, x: torch.Tensor, split_axis: int = 0,
                 concat_axis: int = 0) -> torch.Tensor:
        """``lax.all_to_all`` with ``tiled=False``: ``x.shape[split_axis]``
        is the number of ranks; block ``j`` along it goes to rank ``j``, and
        the blocks received, in rank order, make a new axis at
        ``concat_axis`` of the result (which has ``x``'s number of dims)."""
        n = self.nranks()
        split_axis, concat_axis = _axis(split_axis, x.dim()), _axis(concat_axis, x.dim())
        if x.shape[split_axis] != n:
            raise ValueError(f"alltoall needs dim {split_axis} of {n}, got {tuple(x.shape)}")
        x = x.movedim(split_axis, 0)
        wire = self._to_wire(x)
        out = self._wire_empty(tuple(x.shape), x)
        dist.all_to_all_single(out, wire, group=self.group)
        return self._from_wire(out, x).movedim(0, concat_axis)

    @_watched
    def ppermute(self, x: torch.Tensor, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """``perm`` pairs ``(src, dst)`` of group ranks: this rank sends
        ``x`` to its ``dst`` and returns what its ``src`` sent, zeros if no
        rank sends to it (``lax.ppermute``'s contract).  A fixed point
        ``(r, r)`` returns a copy of ``x`` at rank r and sends nothing; the
        pairs between distinct ranks go over ``batch_isend_irecv``."""
        r = self.rank()
        dst = [d for s, d in perm if s == r]
        src = [s for s, d in perm if d == r]
        if len(dst) > 1 or len(src) > 1:
            raise ValueError(f"perm {perm} sends or receives twice at rank {r}")
        if src == [r]:
            return x.clone()
        wire = self._to_wire(x)
        out = self._wire_empty(tuple(x.shape), x)
        ops = [dist.P2POp(dist.isend, wire, self._global_rank(d), self.group) for d in dst]
        ops += [dist.P2POp(dist.irecv, out, self._global_rank(s), self.group) for s in src]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if not src:
            out.zero_()
        return self._from_wire(out, x)

    def exchange_with_peer(self, x: torch.Tensor, peer_fn: Callable[[int, int, int], int],
                           step: int) -> torch.Tensor:
        """Pairwise send and receive with a step-dependent symmetric pairing
        (``communication.py:477-520``): ``peer_fn(rank, nranks, step)`` is
        this step's partner and must be an involution over the ranks
        (``peer(peer(r)) == r``), as the reference's shift_one exchange is
        (``decentralized_full_precision_synchronous.rs:79-83``); a rank that
        is its own partner keeps ``x``.  PyTorch runs eagerly, so this is
        one ``ppermute`` with this step's pairing: the JAX package's
        precompiled branch per step of the pairing's period, and its cap on
        that period, have no counterpart."""
        n, r = self.nranks(), self.rank()
        peers = [int(peer_fn(i, n, int(step))) for i in range(n)]
        for i, p in enumerate(peers):
            if not 0 <= p < n or peers[p] != i:
                raise ValueError(f"exchange_with_peer: the pairing {peers} of step {step} "
                                 f"is not an involution of {n} ranks (rank {i} -> {p})")
        if peers[r] == r:
            return x.clone()
        return self.ppermute(x, [(i, p) for i, p in enumerate(peers) if p != i])

    @_watched
    def alltoall_packed(self, x: torch.Tensor, send_sizes: Sequence[int],
                        recv_sizes: Sequence[int]) -> torch.Tensor:
        """Exact-count all-to-all with packed rows: ``x`` holds this rank's
        outgoing rows packed by destination (``send_sizes[i]`` rows for rank
        ``i``, rank 0's first); returns the ``recv_sizes[j]`` rows from each
        rank ``j``, packed in source rank order.  The sizes are host
        integers, and ``recv_sizes`` must be what the peers send."""
        n = self.nranks()
        for name, v in (("send_sizes", send_sizes), ("recv_sizes", recv_sizes)):
            if len(v) != n:
                raise ValueError(f"alltoall_packed: {name} needs {n} entries, got {len(v)}")
        send_sizes, recv_sizes = [int(v) for v in send_sizes], [int(v) for v in recv_sizes]
        wire = self._to_wire(x[:sum(send_sizes)])
        recv = self._wire_empty((sum(recv_sizes),) + tuple(x.shape[1:]), x)
        dist.all_to_all_single(recv, wire, output_split_sizes=recv_sizes,
                               input_split_sizes=send_sizes, group=self.group)
        return self._from_wire(recv, x)

    def alltoall_v(self, x: torch.Tensor, output: torch.Tensor, input_offsets: Sequence[int],
                   send_sizes: Sequence[int], output_offsets: Sequence[int],
                   recv_sizes: Sequence[int]) -> torch.Tensor:
        """Ragged all-to-all (the reference's ``alltoall_v``,
        ``communicators/mod.rs:632-676``; ``lax.ragged_all_to_all``): this
        rank sends ``x[input_offsets[i]:input_offsets[i] + send_sizes[i]]``
        (along dim 0) to rank ``i``, where it lands at ``output_offsets[i]``
        of rank ``i``'s output, and receives ``recv_sizes[j]`` rows from
        each rank ``j``.  Returns a copy of ``output`` (which gives the
        capacity, the type and the rows nothing lands on) with the received
        rows in place.  The landing offsets are the senders', so they cross
        the group in one alltoall of ``n`` integers before the data."""
        n = self.nranks()
        for name, v in (("input_offsets", input_offsets), ("send_sizes", send_sizes),
                        ("output_offsets", output_offsets), ("recv_sizes", recv_sizes)):
            if len(v) != n:
                raise ValueError(f"alltoall_v: {name} needs {n} entries, got {len(v)}")
        send_sizes, recv_sizes = [int(v) for v in send_sizes], [int(v) for v in recv_sizes]
        send = torch.cat([x[int(o):int(o) + s] for o, s in zip(input_offsets, send_sizes)])
        offsets = torch.tensor([[int(o)] for o in output_offsets], dtype=torch.int64,
                               device=x.device)
        lands = self.alltoall(offsets).reshape(n).tolist()
        recv = self.alltoall_packed(send, send_sizes, recv_sizes)
        out = output.clone()
        start = 0
        for land, size in zip(lands, recv_sizes):
            if land < 0 or land + size > out.shape[0]:
                raise ValueError(f"alltoall_v: {size} rows at offset {land} overflow an "
                                 f"output of {out.shape[0]}")
            out[land:land + size] = recv[start:start + size]
            start += size
        return out

    @_watched
    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Group rank ``src``'s ``x`` on every rank, as a new tensor (the
        reference's broadcast, ``communication.py:270-300``)."""
        out = x.detach().clone()
        if x.dtype in _BYTE_VIEW_DTYPES:
            out = out.view(torch.uint8)
        self._count_allreduce_staging(out)
        dist.broadcast(out, self._global_rank(src), group=self.group)
        return out.view(x.dtype)

    # -- ring collectives -----------------------------------------------------
    #
    # The ring forms decompose a collective into ``ppermute`` hops and local
    # adds (``:233-457``); rank r owns the r-th contiguous slice, as
    # ``reduce_scatter`` does.  ``num_chunks`` (the overlap scheduler's
    # sizing, :func:`ring_chunks_for`) splits a ring into that many
    # independent sub-rings, each over one slice of every rank block, whose
    # results are re-interleaved into the same contiguous layout.
    # ``codec=`` quantizes on the hop: every reduce-scatter hop carries the
    # codec's payload and f32 sidecar, the receiver decodes and adds its own
    # block in f32, and the allgather phase encodes each rank's finished
    # chunk once and forwards that payload unchanged, so every rank decodes
    # the same bytes.

    def _ring_valid(self) -> bool:
        """A ring needs more than one rank."""
        return self.nranks() > 1

    def _ring_blocks(self, x: torch.Tensor, n: int):
        """``[n * m, ...]`` -> its ``n`` rank blocks, indexed modulo ``n``."""
        if x.shape[0] % n:
            raise ValueError(f"{tuple(x.shape)} does not split into {n} blocks")
        blocks = x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
        return lambda i: blocks[i % n]

    def _ring_chunk_views(self, x: torch.Tensor, num_chunks: int, n: int) -> List[torch.Tensor]:
        """Flat ``x`` as ``num_chunks`` independent sub-buffers (``:349-357``):
        sub-buffer j is every rank block's j-th slice, in rank order
        (``x.reshape(n, k, -1)[:, j]``), so that each rank's sub-results
        concatenate into its contiguous block."""
        m = x.shape[0] // n
        if x.shape[0] % n or m % num_chunks:
            raise ValueError(f"{x.shape[0]} elements do not split into {n} rank blocks of "
                             f"{num_chunks} chunks")
        view = x.reshape(n, num_chunks, m // num_chunks)
        return [view[:, j].reshape(-1) for j in range(num_chunks)]

    def _ring_reduce_scatter_1(self, x, op: ReduceOp, codec=None):
        """One ring: rank r ends with the reduction of every rank's r-th
        block.  The partial sum for block b starts at rank ``b + 1`` and
        travels +1 per hop, each rank adding its own block: n-1 hops of 1/n
        of the bytes.  With ``codec`` every hop carries the encoded partial
        sum and the result is f32."""
        n, r = self.nranks(), self.rank()
        if op not in (ReduceOp.SUM, ReduceOp.AVG):
            raise ValueError(f"ring reduce_scatter supports SUM/AVG, got {op}")
        block = self._ring_blocks(x, n)
        perm = [(i, (i + 1) % n) for i in range(n)]
        if codec is None:
            buf = block(r - 1)
            for s in range(n - 1):
                buf = self.ppermute(buf, perm) + block(r - 2 - s)
        else:
            buf = block(r - 1).float()
            m = buf.shape[0]
            for s in range(n - 1):
                parts = tuple(self.ppermute(p, perm) for p in codec.encode(buf[None]))
                buf = codec.decode(parts, m)[0] + block(r - 2 - s).float()
        return buf / n if op == ReduceOp.AVG else buf

    def _ring_allgather_1(self, x, codec=None):
        """One ring: this rank's block in, every block in rank order out
        (``[n * m, ...]``).  With ``codec`` the block is encoded once, the
        hops forward the payload, and the stacked parts decode in one pass
        at the end."""
        n, r = self.nranks(), self.rank()
        perm = [(i, (i + 1) % n) for i in range(n)]
        cur = [x] if codec is None else [p[0] for p in codec.encode(x[None])]
        stacked = [c.new_zeros((n,) + tuple(c.shape)) for c in cur]
        for o, c in zip(stacked, cur):
            o[r] = c
        for s in range(n - 1):
            cur = [self.ppermute(c, perm) for c in cur]
            for o, c in zip(stacked, cur):
                o[(r - 1 - s) % n] = c
        if codec is None:
            return stacked[0].reshape((n * x.shape[0],) + tuple(x.shape[1:]))
        return codec.decode(tuple(stacked), x.shape[0]).reshape(-1)

    @staticmethod
    def _interleave(outs: List[torch.Tensor], n: int) -> torch.Tensor:
        """The sub-rings' gathered results (each ``[n * mk]`` in rank order)
        back in the flat's element order."""
        mk = outs[0].shape[0] // n
        return torch.stack([o.reshape(n, mk) for o in outs], dim=1).reshape(-1)

    @staticmethod
    def _resolve_codec(codec):
        if codec is None:
            return None
        from .compression.codecs import resolve_codec

        return resolve_codec(codec)

    def ring_reduce_scatter(self, x, op: ReduceOp = ReduceOp.SUM, num_chunks: int = 1,
                            codec=None):
        """Ring reduce-scatter of flat ``x`` (``numel % nranks == 0``, and
        ``num_chunks`` divides the rank block): this rank's contiguous
        slice, as :meth:`reduce_scatter` gives it.  With ``codec`` the f32
        accumulation is cast back to ``x``'s dtype.  A single rank falls
        back to :meth:`reduce_scatter` (no wire to compress)."""
        codec = self._resolve_codec(codec)
        if not self._ring_valid():
            return self.reduce_scatter(x, op)
        parts = ([x] if num_chunks <= 1
                 else self._ring_chunk_views(x, num_chunks, self.nranks()))
        outs = [self._ring_reduce_scatter_1(p, op, codec) for p in parts]
        out = outs[0] if len(outs) == 1 else torch.cat(outs)
        return out.to(x.dtype) if codec is not None else out

    def ring_allgather(self, x, num_chunks: int = 1, codec=None):
        """Ring all-gather of this rank's flat chunk, the inverse of
        :meth:`ring_reduce_scatter` (``[m] -> [nranks * m]`` in rank order;
        ``num_chunks`` divides ``m``).  ``codec`` encodes the chunk once;
        every receiver decodes the same payload."""
        codec = self._resolve_codec(codec)
        if not self._ring_valid():
            return self.allgather(x, axis=0, tiled=True)
        if num_chunks <= 1:
            out = self._ring_allgather_1(x, codec)
        else:
            if x.shape[0] % num_chunks:
                raise ValueError(f"{x.shape[0]} elements do not split into {num_chunks} chunks")
            subs = x.reshape(num_chunks, -1)
            out = self._interleave([self._ring_allgather_1(subs[j], codec)
                                    for j in range(num_chunks)], self.nranks())
        return out.to(x.dtype) if codec is not None else out

    def ring_allreduce(self, x, op: ReduceOp = ReduceOp.AVG, num_chunks: int = 1, codec=None):
        """Ring allreduce: a reduce-scatter ring then an all-gather ring, in
        ``num_chunks`` independent sub-rings.  A buffer that does not split
        into ``nranks * num_chunks`` is zero-padded (sound for SUM/AVG) and
        sliced back.  With ``codec`` the hops carry encoded partial sums,
        the finished chunk (already divided for AVG) is encoded once and
        forwarded unchanged."""
        codec = self._resolve_codec(codec)
        if not self._ring_valid():
            return self.allreduce(x, op)
        n, size = self.nranks(), x.shape[0]
        pad = (-size) % (n * max(1, num_chunks))
        if pad:
            x = torch.cat([x, x.new_zeros(pad)])
        if num_chunks <= 1:
            out = self._ring_allgather_1(self._ring_reduce_scatter_1(x, op, codec), codec)
        else:
            out = self._interleave([
                self._ring_allgather_1(self._ring_reduce_scatter_1(p, op, codec), codec)
                for p in self._ring_chunk_views(x, num_chunks, n)], n)
        if codec is not None:
            out = out.to(x.dtype)
        return out[:size] if pad else out


class SelfCommunicator(BaguaCommunicator):
    """The group of this rank alone, with no process group: what the
    trainer reduces its buckets over where its comm axes hold one rank (a
    mesh of a tensor-parallel axis only, JAX's empty axis tuple).  Every
    collective returns this rank's own operand (a new tensor where the
    group's collective returns one) and moves no byte."""

    def __init__(self):
        self.group = None
        self.stages_cuda = False
        self.host_staged_bytes = 0

    def nranks(self) -> int:
        return 1

    def rank(self) -> int:
        return 0

    def _global_rank(self, r: int) -> int:
        return dist.get_rank() if dist.is_initialized() else 0

    def allreduce(self, x: torch.Tensor, op: ReduceOp = ReduceOp.AVG) -> torch.Tensor:
        return x

    def barrier(self) -> None:
        return None

    def allgather(self, x: torch.Tensor, axis: int = 0, tiled: bool = True) -> torch.Tensor:
        return x.clone() if tiled else x.unsqueeze(_axis(axis, x.dim() + 1)).clone()

    def reduce_scatter(self, x: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
                       axis: int = 0) -> torch.Tensor:
        return x.clone()

    def alltoall(self, x: torch.Tensor, split_axis: int = 0,
                 concat_axis: int = 0) -> torch.Tensor:
        if x.shape[_axis(split_axis, x.dim())] != 1:
            raise ValueError(f"alltoall needs dim {split_axis} of 1, got {tuple(x.shape)}")
        return x.movedim(split_axis, 0).movedim(0, concat_axis).clone()

    def ppermute(self, x: torch.Tensor, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        return x.clone() if (0, 0) in [tuple(p) for p in perm] else torch.zeros_like(x)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        return x.detach().clone()


def _axis(axis: int, ndim: int) -> int:
    """``axis`` in ``[0, ndim)``, a negative one counted from the end."""
    if not -ndim <= axis < ndim:
        raise ValueError(f"axis {axis} is out of range for {ndim} dims")
    return axis % ndim


#: the cap on a chunked ring's sub-collectives (:func:`ring_chunks_for`)
MAX_RING_CHUNKS = env.get_max_ring_chunks()


def largest_divisor_leq(m: int, k: int) -> int:
    """The largest divisor of ``m`` that is at most ``k`` (``m, k >= 1``),
    by enumerating divisors up to ``sqrt(m)``."""
    if k >= m:
        return m
    best, i = 1, 1
    while i * i <= m:
        if m % i == 0:
            for d in (i, m // i):
                if best < d <= k:
                    best = d
        i += 1
    return best


def ring_chunks_for(numel: int, itemsize: int, nranks: int,
                    chunk_bytes: Union[None, int, Dict[str, int]],
                    link_class: str = LINK_ICI) -> int:
    """The overlap scheduler's sizing of a chunked ring (``:548-588``): the
    number of independent sub-rings such that each carries about
    ``chunk_bytes`` of this rank's block a hop (the block after the ring's
    padding, ``ceil(numel / nranks)``), capped at :data:`MAX_RING_CHUNKS`
    and cut to a divisor of the block; 1 is one ring.  ``chunk_bytes`` is
    one target for every link, or ``{link_class: bytes}``, where a class it
    does not name is not chunked."""
    if isinstance(chunk_bytes, dict):
        chunk_bytes = chunk_bytes.get(link_class) or 0
    if not chunk_bytes or nranks <= 1:
        return 1
    m = -(-numel // nranks)
    k = max(1, int(round(m * itemsize / chunk_bytes)))
    return largest_divisor_leq(m, min(k, m, MAX_RING_CHUNKS))


def _tier_groups(world: int, rank: int, intra: int):
    """``(intra-node group, inter-node group)`` of this rank.  Every rank
    creates every group, in the same order, as ``new_group`` requires."""
    intra_groups = [dist.new_group(list(range(i, i + intra))) for i in range(0, world, intra)]
    inter_groups = [dist.new_group(list(range(j, world, intra))) for j in range(intra)]
    return intra_groups[rank // intra], inter_groups[rank % intra]


class BaguaBackend:
    """Per-process comm backend: the global communicator and the intra-node
    and inter-node communicators of the two tiers (``communication.py:582-609``).
    Where ``intra_size`` does not tile the world into groups of more than one
    node's ranks, or at world size 1, both tiers are the global communicator,
    as on the JAX package's single-axis meshes."""

    def __init__(self, intra_size: Optional[int] = None):
        if not dist.is_initialized():
            raise RuntimeError("call init_process_group() first")
        self.global_communicator = BaguaCommunicator()
        world, rank = dist.get_world_size(), dist.get_rank()
        intra = intra_size or env.get_local_world_size() or world
        if world > 1 and 1 <= intra <= world and world % intra == 0:
            intra_group, inter_group = _tier_groups(world, rank, intra)
            self.intranode_communicator = BaguaCommunicator(intra_group)
            self.internode_communicator = BaguaCommunicator(inter_group)
        else:
            self.intranode_communicator = self.global_communicator
            self.internode_communicator = self.global_communicator

    def communicators(self):
        """The distinct communicators (the tiers may be the global one)."""
        comms = [self.global_communicator, self.intranode_communicator,
                 self.internode_communicator]
        return [c for i, c in enumerate(comms) if all(c is not d for d in comms[:i])]


_BACKEND: Optional[BaguaBackend] = None


def get_backend() -> BaguaBackend:
    """The process's backend, made on first use."""
    global _BACKEND
    if _BACKEND is None:
        _BACKEND = BaguaBackend()
    return _BACKEND


# -- the eager collective API (``communication.py:864-1053``) -----------------
#
# Each call checks the abort flag first (an aborted process starts no new
# collective), takes this process's own rank's tensor and returns its own
# result, and is fenced by the global hang watchdog (``_watch_eager``).


def _comm_for(comm: Optional[BaguaCommunicator]) -> BaguaCommunicator:
    check_abort()
    return comm if comm is not None else get_backend().global_communicator


def _watch_eager(fn):
    """Fence an eager collective with the global hang watchdog
    (``communication.py:831-855``): the trainer's steps are fenced through
    ``watch_result``; without this a wedged ``allreduce()`` outside the
    trainer would hang silently, where the reference's comm monitor covers
    every scheduled op.  The call runs inside a watched section (a gloo
    collective blocks the caller), and its result's fence goes to the
    waiter (an NCCL collective returns before it completes)."""
    label = f"eager:{fn.__name__}"

    @functools.wraps(fn)
    def call(*args, **kwargs):
        from .watchdog import get_comm_timeout_s, get_global_watchdog

        timeout = get_comm_timeout_s()
        if timeout is None:
            return fn(*args, **kwargs)
        watchdog = get_global_watchdog(timeout)
        with watchdog.watch(label):
            out = fn(*args, **kwargs)
        if isinstance(out, torch.Tensor):
            watchdog.watch_result(out, label)
        return out

    return call


@_watch_eager
def allreduce(send: torch.Tensor, op: ReduceOp = ReduceOp.AVG,
              comm: Optional[BaguaCommunicator] = None) -> torch.Tensor:
    """The reduction of every rank's ``send`` by ``op``, as a new tensor
    (the reference's ``communication.py:427-495``)."""
    return _comm_for(comm).allreduce(send.detach().clone(), op)


@_watch_eager
def allreduce_inplace(tensor: torch.Tensor, op: ReduceOp = ReduceOp.AVG,
                      comm: Optional[BaguaCommunicator] = None) -> torch.Tensor:
    """:func:`allreduce` into ``tensor``'s own storage; returns it."""
    return _comm_for(comm).allreduce(tensor, op)


@_watch_eager
def allgather(send: torch.Tensor, comm: Optional[BaguaCommunicator] = None) -> torch.Tensor:
    """Every rank's ``send`` concatenated along dim 0 in rank order
    (``communication.py:498-560``)."""
    return _comm_for(comm).allgather(send, axis=0, tiled=True)


@_watch_eager
def reduce_scatter(send: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
                   comm: Optional[BaguaCommunicator] = None) -> torch.Tensor:
    """This rank's contiguous ``1 / nranks`` block along dim 0 of the SUM or
    AVG of every rank's ``send``."""
    return _comm_for(comm).reduce_scatter(send, op, axis=0)


@_watch_eager
def alltoall(send: torch.Tensor, comm: Optional[BaguaCommunicator] = None) -> torch.Tensor:
    """``send``'s dim 0 cut into ``nranks`` equal blocks, block j to rank j;
    the blocks received, in rank order, concatenated along dim 0."""
    c = _comm_for(comm)
    n = c.nranks()
    if send.shape[0] % n:
        raise ValueError(f"alltoall: dim 0 of {tuple(send.shape)} does not split over {n} ranks")
    blocks = send.reshape((n, send.shape[0] // n) + tuple(send.shape[1:]))
    return c.alltoall(blocks).reshape(send.shape)


#: in-place names of the JAX package's eager API (``communication.py:883,
#: 892, 900``): there they are the same functions, and so here
allgather_inplace = allgather
reduce_scatter_inplace = reduce_scatter
alltoall_inplace = alltoall


@_watch_eager
def alltoall_v(send: torch.Tensor, send_counts, output_size: Optional[int] = None,
               comm: Optional[BaguaCommunicator] = None) -> torch.Tensor:
    """Ragged all-to-all (the reference's ``alltoall_v``).  ``send`` packs
    this rank's outgoing rows along dim 0, those for rank 0 first;
    ``send_counts`` is the static ``[nranks, nranks]`` matrix of every
    rank's counts, ``send_counts[r][d]`` rows from rank r to rank d.
    Returns the rows received from ranks 0, 1, ... packed along dim 0 and
    zero-padded to ``output_size`` rows (default: the largest receive total
    of any rank, one shape on every rank as in the JAX package)."""
    c = _comm_for(comm)
    n, r = c.nranks(), c.rank()
    counts = [[int(v) for v in row] for row in send_counts]
    if len(counts) != n or any(len(row) != n for row in counts):
        raise ValueError(f"send_counts must be [{n}, {n}], got {send_counts!r}")
    if any(v < 0 for row in counts for v in row):
        raise ValueError(f"send_counts must be non-negative, got {send_counts!r}")
    need = max(sum(counts[s][d] for s in range(n)) for d in range(n))
    out_size = need if output_size is None else int(output_size)
    if out_size < need:
        raise ValueError(f"output_size {out_size} < the largest receive total {need}")
    if send.shape[0] < sum(counts[r]):
        raise ValueError(f"alltoall_v: rank {r} sends {sum(counts[r])} rows of a "
                         f"{send.shape[0]}-row tensor")
    input_offsets = [sum(counts[r][:d]) for d in range(n)]
    # where this rank's rows land in rank d's output: after those of ranks < r
    output_offsets = [sum(counts[s][d] for s in range(r)) for d in range(n)]
    output = send.new_zeros((out_size,) + tuple(send.shape[1:]))
    return c.alltoall_v(send, output, input_offsets, counts[r], output_offsets,
                        [counts[s][r] for s in range(n)])


@_watch_eager
def broadcast(tensor: torch.Tensor, src: int = 0,
              comm: Optional[BaguaCommunicator] = None) -> torch.Tensor:
    """Rank ``src``'s ``tensor`` on every rank, as a new tensor."""
    return _comm_for(comm).broadcast(tensor, src)


@_watch_eager
def reduce(send: torch.Tensor, dst: int, op: ReduceOp = ReduceOp.SUM,
           comm: Optional[BaguaCommunicator] = None,
           recv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reduction of every rank's ``send`` on rank ``dst``; the other ranks
    get ``recv`` back (the reference writes only ``dst``'s receive buffer,
    ``communication.py:331-375``), or zeros."""
    c = _comm_for(comm)
    red = c.allreduce(send.detach().clone(), op)
    if c.rank() == dst:
        return red
    return recv if recv is not None else torch.zeros_like(red)


@_watch_eager
def gather(send: torch.Tensor, dst: int, comm: Optional[BaguaCommunicator] = None,
           recv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every rank's ``send`` concatenated along dim 0 on rank ``dst``; the
    other ranks get ``recv`` back (``communication.py:576-614``), or
    zeros."""
    c = _comm_for(comm)
    full = c.allgather(send, axis=0, tiled=True)
    if c.rank() == dst:
        return full
    return recv if recv is not None else torch.zeros_like(full)


@_watch_eager
def scatter(send: torch.Tensor, src: int, comm: Optional[BaguaCommunicator] = None
            ) -> torch.Tensor:
    """Block r along dim 0 of rank ``src``'s ``send`` (``nranks`` equal
    blocks) on rank r.  Every rank passes a tensor of ``send``'s shape."""
    c = _comm_for(comm)
    n = c.nranks()
    if send.shape[0] % n:
        raise ValueError(f"scatter: dim 0 of {tuple(send.shape)} does not split over {n} ranks")
    full = c.broadcast(send, src)
    return full.reshape((n, send.shape[0] // n) + tuple(send.shape[1:]))[c.rank()]


@_watch_eager
def send_recv(send: torch.Tensor, peer_perm: Sequence[Tuple[int, int]],
              comm: Optional[BaguaCommunicator] = None) -> torch.Tensor:
    """Point-to-point exchange as a permutation of ``(src, dst)`` pairs
    (the reference's send/recv, ``communication.py:233-267``): what this
    rank's ``src`` sent, zeros if none."""
    perm = [(int(a), int(b)) for a, b in peer_perm]
    return _comm_for(comm).ppermute(send, perm)


@_watch_eager
def barrier(comm: Optional[BaguaCommunicator] = None) -> None:
    """Block until every rank of ``comm`` (default: the global
    communicator) has reached the barrier."""
    _comm_for(comm).barrier()
