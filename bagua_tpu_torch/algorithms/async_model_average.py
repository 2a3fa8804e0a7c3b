"""Asynchronous model averaging.

Port of ``bagua_tpu/algorithms/async_model_average.py`` (the reference's
``async_model_average.py:156-233`` and
``decentralized_full_precision_asynchronous.rs``): between steps, a round
averages the weights over the ranks while the following steps run on each
rank's own weights, and its result is applied as a delta at a later step
boundary, ``cur + avg - snap``, so that the progress made while it was in
flight is kept.  ``warmup_steps`` of synchronous gradient allreduce come
first (reference ``:60, :125-131``).

The round is a non-blocking collective on a process group of its own (the
averaging group).  At a boundary the bucket flats of the weights are copied
as the snapshot (the optimizer writes the parameters in place, so the
snapshot needs its own storage), copied again as the buffer to average, and
``all_reduce(buffer, SUM, async_op=True)`` starts on the averaging group.  At
the next boundary the rank waits on the work, divides by the number of
ranks and adds ``avg - snap`` to the parameters in place.  The trainer's
own collectives (the warmup's allreduce, the loss) go over the default
group meanwhile.  The averaging group is NCCL where the trainer's
communicator is, else gloo; a second, gloo, group carries the negotiation
gather, a small f64 CPU tensor a rank, which NCCL cannot carry.  At world 1
nothing is built or launched.

Every rank is a process, and every rank must run the collectives of a group
in the same order, so the reference's "launch a round whenever the local
clock says so" cannot be ported as it is.  As in the JAX package, the
launch schedule is a function of the step count: after the warmup, a short
window measures the step time, the ranks agree on the slowest rank's, and
rounds launch every ``k``-th step with ``k`` derived from
``sync_interval_ms`` (or pinned by ``period_steps``).  ``abort()`` and
``resume()`` requests, from any rank, ride the negotiation gather and take
effect at the same boundary on every rank.

Bounded staleness: launching a round is global, applying it is local, so a
rank may sit a round out (an ``async.partition`` fault, or a grad-guard
rewind while the round was in flight) without breaking the schedule.  Each
rank's applied-round count rides the gather; when the worst rank lags the
launched count by ``max_staleness_rounds``, every rank agrees on a blocking
catch-up average that leaves the weights bitwise equal on every rank.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import torch
import torch.distributed as dist

from .. import env
from ..communication import BaguaCommunicator, ReduceOp, is_aborted
from ..faults import inject as _inject
from ..telemetry import counters
from .base import Algorithm, AlgorithmContext

logger = logging.getLogger(__name__)

_RUNNING = 0
_ABORTED = 1

# per-boundary control requests (edge-triggered: consumed at negotiation, so
# a later resume() from another rank than the aborter still takes effect)
_REQ_NONE = 0
_REQ_RESUME = 1
_REQ_ABORT = 2  # highest: abort wins when both are requested in one round


def _negotiate(control: Optional[BaguaCommunicator], payload) -> torch.Tensor:
    """Every rank's control vector, ``[ranks, len(payload)]`` f64, gathered
    over the control group (without one, the payload as one row).  Every
    rank calls it at the same step boundary: the schedule guarantees it."""
    vec = torch.tensor(payload, dtype=torch.float64)
    if control is None:
        return vec[None]
    return control.allgather(vec, tiled=False)


def _agree_max(control: Optional[BaguaCommunicator], value: float) -> float:
    """The maximum of a host scalar over the ranks."""
    return float(_negotiate(control, [float(value)])[:, 0].max())


def _fence(trainer) -> None:
    """Wait for the work queued on the card (a no-op on the CPU): the host
    runs ahead of the device, so an unfenced window measures the enqueue."""
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)


class AsyncModelAverageAlgorithm(Algorithm):
    """Asynchronous model averaging (see the module docstring).

    Args:
        peer_selection_mode: only ``"all"``, as in the reference.
        sync_interval_ms: target milliseconds between rounds, turned into a
            period in steps by the calibration; 0 means every step.
        warmup_steps: steps of synchronous gradient allreduce first.
        calibration_steps: steps of the window that measures the slowest
            rank's step time before the first round.
        period_steps: pin the period to this many steps and skip the
            calibration (``sync_interval_ms`` is then ignored).
        recalibrate_rounds: measure the step time again after this many
            rounds (None: never; ignored with ``period_steps``).
        max_staleness_rounds: the lag of the worst rank's applied rounds
            behind the launched ones that forces a catch-up average (0: no
            bound; None: ``BAGUA_ASYNC_MAX_STALENESS``, 4 by default).
    """

    name = "async"
    replicated_params = False

    def __init__(
        self,
        peer_selection_mode: str = "all",
        sync_interval_ms: int = 500,
        warmup_steps: int = 0,
        calibration_steps: int = 4,
        period_steps: Optional[int] = None,
        recalibrate_rounds: Optional[int] = 64,
        max_staleness_rounds: Optional[int] = None,
    ):
        if peer_selection_mode != "all":
            raise ValueError(f"peer_selection_mode must be 'all', got {peer_selection_mode!r}")
        self.peer_selection_mode = peer_selection_mode
        self.sync_interval_ms = sync_interval_ms
        self.warmup_steps = warmup_steps
        self.calibration_steps = max(1, calibration_steps)
        self.period_steps = period_steps
        self.recalibrate_rounds = (None if recalibrate_rounds is None
                                   else max(1, recalibrate_rounds))
        if max_staleness_rounds is None:
            max_staleness_rounds = env.get_async_max_staleness()
        if max_staleness_rounds < 0:
            raise ValueError(f"max_staleness_rounds must be >= 0 (0 disables the bound), "
                             f"got {max_staleness_rounds}")
        self.max_staleness_rounds = int(max_staleness_rounds)
        #: the averaging group's and the control group's communicators
        #: (None at world 1)
        self._avg_comm: Optional[BaguaCommunicator] = None
        self._control: Optional[BaguaCommunicator] = None
        self._request = _REQ_NONE    # this rank's pending abort()/resume()
        self._status = _RUNNING      # negotiated, changes only at boundaries
        #: the round in flight: (works, buffers, snapshot), one flat a bucket
        self._pending = None
        self._period: Optional[int] = None   # agreed steps between rounds
        self._anchor: Optional[int] = None   # step the schedule starts from
        self._calib_t0: Optional[float] = None
        self._calib_start: Optional[int] = None  # step the window opened at
        self._calib_skip = 1         # steps to skip before opening a window
        self._agreed_dt: Optional[float] = None  # the slowest rank's step time
        self._rounds = 0             # rounds since the period was agreed
        # launches are global (negotiated), applies local: the counts may
        # differ between ranks
        self._rounds_launched = 0
        self._rounds_applied = 0
        self._rounds_dropped = 0
        self._drop_next = False      # async.partition: sit the next apply out
        self._rewinds_at_launch = 0  # the trainer's grad-guard rewinds at launch
        self._lock = threading.Lock()
        # abort()/resume() take their own lock, so that a caller on another
        # thread never waits behind the boundary's gather (under _lock)
        self._req_lock = threading.Lock()

    # ---- the trainer's stages ------------------------------------------------

    def init_state(self, ctx: AlgorithmContext, params):
        """Creates the averaging and control groups where the world has more
        than one rank; every rank builds its trainer, so every rank creates
        them, in the same order."""
        if ctx.comm.nranks() > 1:
            backend = dist.get_backend(ctx.comm.group)
            self._avg_comm = BaguaCommunicator(dist.new_group(backend=backend))
            self._control = BaguaCommunicator(dist.new_group(backend="gloo"))
        return super().init_state(ctx, params)

    def communicators(self):
        return [self._avg_comm] if self._avg_comm is not None else []

    def process_grads(self, ctx: AlgorithmContext, grads, params, algo_state, step):
        # the warmup: a synchronous allreduce of the gradients (reference
        # :125-131 registers a centralized op for it)
        if step < self.warmup_steps:
            flats = [ctx.comm.allreduce(f, ReduceOp.AVG) for f in ctx.bucket_flats(grads)]
            grads = ctx.from_bucket_flats(flats)
        return grads, algo_state

    # ---- the round -------------------------------------------------------------

    def _launch(self, trainer) -> None:
        """Start a round on the current weights (caller holds the lock)."""
        snapshot = trainer.plan.flatten(trainer._params)
        buffers = [f.clone() for f in snapshot]
        works = [self._avg_comm.allreduce_start(b) for b in buffers]
        self._pending = (works, buffers, snapshot)

    def _wait(self) -> list:
        """Wait for the round in flight; returns its summed buffers."""
        works, buffers, _ = self._pending
        t0 = time.monotonic()
        for work in works:
            work.wait()
        counters.incr("async/round_wait_s", time.monotonic() - t0)
        return buffers

    @torch.no_grad()
    def _apply_pending(self, trainer) -> None:
        """Apply the round in flight to the parameters, in place (caller
        holds the lock): ``(cur + avg) - snap``, JAX's order (the
        reference's ``x += reduced / n - copy`` under the weight lock,
        ``decentralized_full_precision_asynchronous.rs:121-126``).  Every
        rank launched it at the same step, so every rank applies it at the
        same step."""
        n = self._avg_comm.nranks()
        avg = trainer.plan.unflatten([b.div_(n) for b in self._wait()])
        snap = trainer.plan.unflatten(self._pending[2])
        for name, p in trainer._params.items():
            p.add_(avg[name]).sub_(snap[name])
        self._pending = None
        self._drop_next = False
        self._rounds_applied += 1
        counters.incr("async/rounds_applied")

    def _drop_pending(self, why: str, health_event: bool = True, wait: bool = True) -> None:
        """Discard the round in flight without applying it (caller holds the
        lock): this rank sits the round out and its applied count stalls,
        the staleness the catch-up bounds.  The rank still waits for the
        collective, which keeps the averaging group in step on every rank,
        except under the global abort flag (``wait=False``), whose process
        is about to exit.  ``health_event=False`` for drops on every rank at
        once (a catch-up supersedes the round, an abort): only a rank's own
        drops count in ``async/missed_boundaries``."""
        if wait:
            self._wait()
        self._pending = None
        self._drop_next = False
        self._rounds_dropped += 1
        counters.incr("async/rounds_dropped")
        if health_event:
            counters.incr("async/missed_boundaries")
        logger.warning("async model average: round %d NOT applied on this rank (%s); "
                       "applied %d/%d", self._rounds_launched, why, self._rounds_applied,
                       self._rounds_launched)

    def _pending_veto(self, trainer):
        """``(will_drop, reason)`` for the round in flight (caller holds the
        lock), the one veto the boundary and :meth:`_drain_pending` share: a
        grad-guard rewind since the launch (applying the round on a rewound
        state would bring the skipped step's progress back), or a fired
        ``async.partition``."""
        if self._pending is None:
            return False, None
        if getattr(trainer, "_guard_rewinds_total", 0) != self._rewinds_at_launch:
            return True, "grad-guard rewind during the round"
        if self._drop_next:
            return True, "partitioned out of the negotiation round"
        return False, None

    def _drain_pending(self, trainer) -> None:
        """Apply the round in flight under the boundary's veto, or drop it
        (caller holds the lock)."""
        if self._pending is None:
            return
        will_drop, reason = self._pending_veto(trainer)
        if will_drop:
            self._drop_pending(reason)
        else:
            self._apply_pending(trainer)

    @torch.no_grad()
    def _catchup_sync(self, trainer, step: int, reason: str) -> None:
        """A blocking average of the current weights, assigned on every rank
        (caller holds the lock): the weights are bitwise equal on every rank
        after it and the applied counts equal the launched count.  Every
        rank takes it at the same boundary: the decision comes from the
        negotiated gather."""
        if self._pending is not None:
            # every rank drops it: not this rank's fault
            self._drop_pending(f"superseded by catch-up sync ({reason})", health_event=False)
        flats = trainer.plan.flatten(trainer._params)
        for f in flats:
            self._avg_comm.allreduce(f, ReduceOp.AVG)
        for name, avg in trainer.plan.unflatten(flats).items():
            trainer._params[name].copy_(avg)
        self._rounds_applied = self._rounds_launched
        counters.incr("async/catchup_syncs")
        counters.set_gauge("async/staleness_max", 0)
        if reason == "staleness":
            _inject.record_recovery("async.partition")
        logger.warning("async model average: synchronous catch-up average at step %d (%s): "
                       "the ranks' weights are bitwise equal after %d round(s)", step, reason,
                       self._rounds_launched)

    def _calibrate(self, trainer, step: int) -> None:
        """Agree a period from the slowest rank's step time (in place of the
        reference's per-rank clock gate, :170-177).  Both ends of the window
        are fenced: without the fences the window measures the host's
        enqueue, and the period comes out wrong by up to 5x.  Restartable:
        a recalibration resets the window and comes back here."""
        if self._calib_skip > 0:
            # the step right after the warmup or a recalibration's trigger
            self._calib_skip -= 1
            return
        if self._calib_start is None:
            _fence(trainer)
            self._calib_t0 = time.monotonic()
            self._calib_start = step
        elif step >= self._calib_start + self.calibration_steps:
            _fence(trainer)
            window = step - self._calib_start
            local_dt = (time.monotonic() - self._calib_t0) / window
            self._agreed_dt = _agree_max(self._control, local_dt)
            self._period = max(1, int(round(self.sync_interval_ms / (self._agreed_dt * 1000.0))))
            self._anchor = step
            self._rounds = 0
            logger.info("async model average: agreed step time %.4fs (local %.4fs) -> "
                        "averaging every %d step(s)", self._agreed_dt, local_dt, self._period)

    def host_pre_step(self, trainer, state):
        """The step boundary, where the weights may change (the reference's
        weight lock)."""
        if is_aborted():
            # the global abort flag stops the rounds like a local abort():
            # nothing new is launched and the round in flight is dropped.
            # The process is about to exit, so the ranks need not agree
            with self._lock:
                if self._pending is not None:
                    self._drop_pending("comm abort flag raised", health_event=False,
                                       wait=False)
            return state
        step = trainer._step_counter
        if step <= self.warmup_steps or self._avg_comm is None:
            # at world 1 the average is the identity: no snapshot, no round
            return state
        with self._lock:
            if self._period is None:
                if self.period_steps is not None:
                    # pinned cadence: no dependence on the clock
                    self._period = max(1, int(self.period_steps))
                    self._anchor = step
                    self._rounds = 0
                else:
                    self._calibrate(trainer, step)
                return state
            if (step - self._anchor) % self._period != 0:
                return state
            # ---- a scheduled boundary: negotiate, drain, launch. Every rank
            # reaches it at the same step, so the gather and the collectives
            # below line up; a slow rank holds the others here, the steps
            # between boundaries ran free.  The veto is decided before the
            # gather, so that the negotiated applied count reflects a drop.
            will_drop, drop_reason = self._pending_veto(trainer)
            # read and clear under _req_lock: a request made on another
            # thread during the gather stays for the next boundary
            with self._req_lock:
                my_req, self._request = self._request, _REQ_NONE
            applied_after = self._rounds_applied + (
                1 if (self._pending is not None and not will_drop) else 0)
            gathered = _negotiate(self._control, [float(my_req), float(applied_after)])
            req = float(gathered[:, 0].max())
            min_applied = int(gathered[:, 1].min())
            if req >= _REQ_ABORT:
                new_status = _ABORTED
            elif req >= _REQ_RESUME:
                new_status = _RUNNING
            else:
                new_status = self._status
            if new_status != self._status:
                counters.incr("async/aborts_negotiated" if new_status == _ABORTED
                              else "async/resumes_negotiated")
                logger.info("async model average: negotiated %s at step %d",
                            "ABORT" if new_status == _ABORTED else "RESUME", step)
            self._status = new_status
            # bounded staleness: the rounds the worst rank will still miss
            # after this boundary's apply or drop, the same on every rank.
            # Catching up AT the cap (not past it) keeps "applied never lags
            # launched by more than max_staleness_rounds" true, since this
            # boundary may launch a round the lagging rank misses too
            lag = self._rounds_launched - min_applied
            if (self._status == _RUNNING and self.max_staleness_rounds
                    and lag >= self.max_staleness_rounds):
                self._catchup_sync(trainer, step, "staleness")
                return state
            counters.set_gauge("async/staleness_max", lag)
            if self._pending is not None:
                if will_drop:
                    self._drop_pending(drop_reason)
                else:
                    # every rank launched it: drain it whether the status
                    # stays RUNNING or has just turned ABORTED
                    self._apply_pending(trainer)
            if self._status != _RUNNING:
                return state
            # RUNNING only: count the round, maybe recalibrate, else launch
            self._rounds += 1
            if (self.period_steps is None and self.recalibrate_rounds is not None
                    and self._rounds >= self.recalibrate_rounds):
                # the step count decides it, so every rank recalibrates at once
                self._period = None
                self._calib_start = None
                self._calib_skip = 1
                logger.info("async model average: recalibrating the period at step %d after "
                            "%d rounds", step, self._rounds)
                return state
            # the fault is consumed at the launch: a boundary that launches
            # nothing (catch-up, abort, recalibration) cannot spend a
            # count-limited spec with no round to drop
            self._drop_next = _inject.maybe_drop_negotiation_round()
            self._launch(trainer)
            self._rounds_launched += 1
            self._rewinds_at_launch = getattr(trainer, "_guard_rewinds_total", 0)
            counters.incr("async/rounds_launched")
        return state

    # ---- control (reference :203-233) ----------------------------------------

    def abort(self):
        """Request that the rounds stop (for example before an evaluation).
        Takes effect at the next scheduled boundary on every rank at once;
        may be called on any one rank, and cleared by a :meth:`resume` from
        any rank."""
        with self._req_lock:
            self._request = _REQ_ABORT
        logger.info("async model average abort requested")

    def resume(self):
        """Request that the rounds resume (a negotiated RESUME)."""
        with self._req_lock:
            self._request = _REQ_RESUME
        logger.info("async model average resume requested")

    def barrier(self, trainer, state):
        """Wait for the round in flight and apply it, under the boundary's
        veto.  Call it on every rank."""
        with self._lock:
            self._drain_pending(trainer)
        return state

    def sync_for_checkpoint(self, trainer, state):
        """A blocking average that leaves the weights bitwise equal on every
        rank, after the round in flight is drained: run it right before a
        checkpoint that must restore on another world size.  Call it on
        every rank."""
        if self._avg_comm is None:
            return state
        with self._lock:
            self._drain_pending(trainer)
            self._catchup_sync(trainer, trainer._step_counter, "checkpoint")
        return state

    def reset_schedule(self) -> None:
        """Forget the negotiated schedule and any round in flight: the next
        step after the warmup opens a new calibration window (or pins
        ``period_steps`` again) and the round counts restart from zero.  Runs
        through :meth:`on_restore` after a checkpoint restore: the restored
        run must not apply a round launched on the weights from before it,
        nor keep a period a world that no longer exists agreed."""
        with self._lock:
            if self._pending is not None:
                self._wait()
                self._pending = None
                counters.incr("async/rounds_dropped")
            self._period = None
            self._anchor = None
            self._calib_t0 = None
            self._calib_start = None
            self._calib_skip = 1
            self._agreed_dt = None
            self._rounds = 0
            self._rounds_launched = 0
            self._rounds_applied = 0
            self._rounds_dropped = 0
            self._drop_next = False
            self._rewinds_at_launch = 0
            self._status = _RUNNING
            with self._req_lock:
                self._request = _REQ_NONE
        logger.info("async model average: schedule reset; the next step after the warmup "
                    "opens a new calibration window")

    def on_restore(self, trainer) -> None:
        self.reset_schedule()
