"""Hang watchdog: turn a silent stall into a crash a launcher can restart.

Port of ``bagua_tpu/watchdog.py``, the counterpart of the reference's comm
monitor thread, which panics the process when a scheduled comm op exceeds
300 s.  A wedged NCCL or gloo collective, or a wedged kernel, would otherwise
hold the whole gang forever; killing the process lets
``bagua_tpu_torch.distributed.run``'s gang restart resume from the
checkpoint.

On by default at the reference's 300 s (``BAGUA_COMM_TIMEOUT_S``; ``0``/``off``
disable it).  Watching costs the step loop nothing it waits for: the trainer
hands each step's result to :meth:`HangWatchdog.watch_result`, which keeps
only a fence, and a background *waiter* thread blocks on that fence inside a
watched section while the main thread keeps dispatching.  On the card the
fence is a CUDA event recorded on the current stream after the step
(``cudaEventBlockingSync``: the waiter sleeps in ``synchronize``, which
cannot return before the work before it finished); a CPU tensor's step has
finished when the call returns.  What blocks the calling thread itself, a
gloo collective waiting for its peers above all, runs inside a section of
its own: every blocking call of
:class:`bagua_tpu_torch.communication.BaguaCommunicator` is watched under
the process's watchdog (:func:`active`).  A wedged device or a peer that
hangs with its socket open leaves a section open past the timeout; a monitor
thread checks every second.

Every watched section is also a ``watchdog/<label>`` span.  On firing the
watchdog raises the cooperative abort flag
(:func:`bagua_tpu_torch.communication.abort`) so control loops stop, writes
a ``watchdog_abort`` flight record (``BAGUA_OBS_DUMP_DIR``), dumps every
thread's stack to stderr and, with ``action="exit"`` (the default),
publishes an elastic leave intent, flushes queued async checkpoint saves
(bounded to 10 s: the port's snapshot is in host memory when ``save``
returns, so the flush needs no device work queued behind the wedge) and exits
with code 3.  ``action="abort"`` stops at the flag (in-process recovery,
tests); ``action="log"`` only records.
"""

from __future__ import annotations

import atexit
import faulthandler
import logging
import os
import queue
import sys
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

from .faults import inject as _inject

logger = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 300.0  # the reference's comm monitor bound


def get_comm_timeout_s() -> Optional[float]:
    """Watchdog timeout in seconds, or None when disabled; the off values
    live in :func:`bagua_tpu_torch.env.env_seconds_or_off`."""
    from . import env

    return env.get_comm_timeout_s()


def _fence_of(result):
    """What the waiter blocks on for ``result``, keeping nothing else alive:
    for a CUDA tensor an event recorded now on its device's current stream
    (the step's work is before it), for a CPU tensor nothing (its step has
    finished, its blocking collectives inside the communicator's own watched
    sections), anything else as given (an event, or an object the waiter
    reads back with ``numpy.asarray``)."""
    import torch

    if isinstance(result, torch.Tensor):
        if not result.is_cuda:
            return None
        event = torch.cuda.Event(blocking=True)
        event.record(torch.cuda.current_stream(result.device))
        return event
    return result


def _wait_on(fence) -> None:
    if fence is None:
        return
    sync = getattr(fence, "synchronize", None)
    if callable(sync):
        sync()
        return
    import numpy as np

    np.asarray(fence)


class HangWatchdog:
    """Monitors watched sections; when one runs past ``timeout_s`` it raises
    the global comm abort flag, then ends the process (``action="exit"``),
    stops at the flag (``action="abort"``) or only records
    (``action="log"``).

    Two ways to watch:

    * :meth:`watch`: a context manager around blocking host work.
    * :meth:`watch_result`: non-blocking; the waiter thread blocks on the
      result's fence inside a watched section.
    """

    _CHECK_INTERVAL_S = 1.0
    _QUEUE_MAX = 64  # backlog cap; a hang pins the waiter on one item anyway

    def __init__(self, timeout_s: float = DEFAULT_TIMEOUT_S, action: str = "exit"):
        assert action in ("exit", "abort", "log")
        self.timeout_s = timeout_s
        self.action = action
        self.fired = threading.Event()  # informational latch (never cleared)
        self._armed = True  # re-arms once every overdue section has cleared
        self._active: Dict[object, tuple] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._queue: "queue.Queue" = queue.Queue(maxsize=self._QUEUE_MAX)
        self._waiter: Optional[threading.Thread] = None
        self._wait_warned = False
        self._thread = threading.Thread(target=self._monitor, name="bagua-watchdog",
                                        daemon=True)
        self._thread.start()

    @contextmanager
    def watch(self, label: str = "comm"):
        # a fresh token a section, not the thread id: an inner (nested) watch
        # keyed by the thread would overwrite the outer entry and its exit
        # would leave the outer section unwatched
        from .obs.spans import trace_span

        token = object()
        with self._lock:
            self._active[token] = (label, time.monotonic())
        try:
            # the watched section doubles as a span: a post-mortem's span
            # tail shows which section the waiter was pinned in
            with trace_span(f"watchdog/{label}"):
                yield
        finally:
            with self._lock:
                self._active.pop(token, None)

    def watch_result(self, result, label: str = "step") -> None:
        """Watch an asynchronous result without blocking the caller.  When
        the backlog is full the item is dropped: a wedged device pins the
        waiter on the item it is blocked on, and every later step queues
        behind the same hang."""
        fence = _fence_of(result)
        if self._waiter is None:
            with self._lock:
                if self._waiter is None:
                    self._waiter = threading.Thread(target=self._wait_loop,
                                                    name="bagua-watchdog-waiter", daemon=True)
                    self._waiter.start()
        try:
            self._queue.put_nowait((label, fence))
        except queue.Full:
            pass

    def _wait_loop(self):
        while not self._stop.is_set():
            try:
                label, fence = self._queue.get(timeout=0.5)
            except queue.Empty:
                continue
            with self.watch(label):
                # chaos hook: an armed ``collective.hang`` wedges the wait
                # inside the watched section, as a cross-rank deadlock would
                # (bounded by the spec's duration; the stop event cuts it)
                _inject.maybe_hang(stop_event=self._stop)
                try:
                    _wait_on(fence)
                except Exception as e:  # noqa: BLE001 - the step's own use raises it
                    # a wait that fails at once would disarm hang detection
                    # silently: say so once
                    if not self._wait_warned:
                        self._wait_warned = True
                        logger.warning("watchdog: waiting on %r failed (%s: %s); sections "
                                       "from watch_result() may no longer fence device work",
                                       label, type(e).__name__, e)

    def _monitor(self):
        while not self._stop.wait(self._CHECK_INTERVAL_S):
            now = time.monotonic()
            with self._lock:
                overdue = [(label, now - t0) for label, t0 in self._active.values()
                           if now - t0 > self.timeout_s]
            if overdue:
                label, dt = overdue[0]
                logger.error("watchdog: section %r stuck for %.0f s (timeout %.0f s); "
                             "dumping stacks", label, dt, self.timeout_s)
                self.fired.set()
                if self._armed:
                    if self.action != "log":
                        # the cooperative abort first: control loops (async
                        # model average) stop launching work in abort mode too
                        from .communication import abort

                        abort(f"watchdog: {label} stuck for {dt:.0f} s")
                        # flight recorder: the post-mortem of this hang
                        # episode, from host state only (span ring,
                        # counters), so a wedged device cannot block it
                        from .obs.recorder import dump_flight_record

                        dump_flight_record(
                            "watchdog_abort",
                            reason=f"section {label!r} stuck for {dt:.0f} s "
                                   f"(timeout {self.timeout_s:.0f} s)")
                    # the stacks once an episode, not every tick
                    faulthandler.dump_traceback(file=sys.stderr)
                    self._armed = False
                if self.action == "exit":
                    # elastic jobs: a deliberate departure, so the coordinator
                    # logs a leave rather than a crash (bounded, never raises)
                    try:
                        from .elastic.membership import publish_leave_intent

                        publish_leave_intent(f"watchdog: {label} stuck for {dt:.0f} s")
                    except Exception:  # noqa: BLE001 - dying anyway
                        pass
                    # os._exit skips atexit: make the queued async saves
                    # durable first, bounded so a wedged flush cannot hold
                    # the exit, and write the lockdep witness if one is on
                    try:
                        from .checkpoint import flush_all_checkpoints

                        flush_all_checkpoints(timeout_s=10.0)
                    except Exception:  # noqa: BLE001 - dying anyway
                        pass
                    try:
                        from .analysis import lockdep as _lockdep

                        _lockdep.dump_now()
                    except Exception:  # noqa: BLE001 - dying anyway
                        pass
                    sys.stderr.flush()
                    # the gang-restart contract: die loudly, the launcher
                    # respawns from the checkpoint
                    os._exit(3)
            elif not self._armed:
                # the episode is over (sections cleared after a reset_abort
                # recovery): re-arm, so the next hang raises the flag again
                self._armed = True

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)
        if self._waiter is not None:
            self._waiter.join(timeout=5)


_GLOBAL: Optional[HangWatchdog] = None
_GLOBAL_LOCK = threading.Lock()


def active() -> Optional[HangWatchdog]:
    """The process's watchdog, or None while nothing with the timeout on
    (a trainer, an eager collective) has built one."""
    return _GLOBAL


def get_global_watchdog(timeout_s: float) -> HangWatchdog:
    """The process's watchdog (one monitor thread however many trainers
    exist, as the reference runs one comm monitor a process).  A later caller
    asking for another timeout gets the stricter (smaller) one adopted,
    logged either way."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = HangWatchdog(timeout_s)
            # stop the waiter before the interpreter tears down: a daemon
            # thread killed inside a CUDA call can abort a finished run
            atexit.register(_GLOBAL.stop)
        elif float(timeout_s) != _GLOBAL.timeout_s:
            adopted = min(float(timeout_s), _GLOBAL.timeout_s)
            logger.warning("get_global_watchdog: requested timeout %.0f s differs from the "
                           "active %.0f s (one watchdog a process); adopting the stricter "
                           "%.0f s", timeout_s, _GLOBAL.timeout_s, adopted)
            _GLOBAL.timeout_s = adopted
        return _GLOBAL
