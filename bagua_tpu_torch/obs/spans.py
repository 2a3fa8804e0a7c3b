"""Step-span tracer: a host-side structured timeline of what this process
was doing.

Port of ``bagua_tpu/obs/spans.py``.  A span times a HOST section: the
step's build and dispatch, the per-bucket collective launches, the
optimizer apply, grad-guard verdict readbacks, async negotiation
boundaries, checkpoint save/restore, elastic rendezvous rounds and watchdog
sections.

* **Never touches the device.**  ``trace_span`` records two
  ``time.monotonic()`` reads and a deque append: no tensor op, no
  synchronization, so the step's parameters are bitwise equal with tracing
  on or off (``tests/test_torch_obs.py``).  The JAX package opens the
  ``trace/*`` spans while tracing its step, once a compile; the port's
  eager step runs them on every call, so they time each launch.
* **Bounded.**  Spans land in a ring buffer (``BAGUA_OBS_RING``, default
  512); the oldest drop and the drop count is kept.
* **Per-thread depth**, so spans opened on the overlap scheduler's comm
  worker and on the watchdog's waiter nest correctly beside the main
  thread's.

``BAGUA_OBS=off`` turns every hook into a cheap early return (one module
flag read).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .. import env as _env

__all__ = ["trace_span", "recorder", "span_ring", "SpanRecorder", "enabled",
           "set_enabled", "set_current_step", "set_ledger_sink"]

#: resolved master switch; None = not yet read from BAGUA_OBS
_ENABLED: Optional[bool] = None
_ENABLED_LOCK = threading.Lock()


def enabled() -> bool:
    """Whether the observability plane is on (``BAGUA_OBS``, default on).
    Cached after the first read — the check sits on the train-step hot
    path."""
    global _ENABLED
    if _ENABLED is None:
        with _ENABLED_LOCK:
            if _ENABLED is None:
                _ENABLED = _env.get_obs_mode() == "on"
    return _ENABLED


def set_enabled(value: Optional[bool]) -> None:
    """Override the cached switch (tests); ``None`` re-reads ``BAGUA_OBS``
    on the next :func:`enabled` call."""
    global _ENABLED
    with _ENABLED_LOCK:
        _ENABLED = value


def _cached_rank() -> int:
    global _RANK
    if _RANK is None:
        try:
            _RANK = int(_env.get_rank())
        except Exception:  # noqa: BLE001 - spans must never raise
            _RANK = 0
    return _RANK


_RANK: Optional[int] = None

#: the trainer's current step counter, stamped onto every span opened while
#: that step is being driven (threads like the watchdog waiter inherit it —
#: "which step was in flight" is exactly what a post-mortem wants to know)
_CURRENT_STEP: Optional[int] = None


def set_current_step(step: Optional[int]) -> None:
    global _CURRENT_STEP
    _CURRENT_STEP = step


#: goodput-ledger sink (``obs.ledger.install()`` sets it): spans
#: whose names map to a ledger class feed their wall seconds on close.
#: None (the default) keeps the enter/exit pair at its pre-ledger cost.
_LEDGER_SINK = None


def set_ledger_sink(sink) -> None:
    """Install (or clear, with None) the goodput-ledger span sink — an
    object with ``span_enter(name) -> cls|None`` and
    ``span_exit(cls, dur_s)``."""
    global _LEDGER_SINK
    _LEDGER_SINK = sink


class SpanRecorder:
    """Thread-safe bounded ring buffer of finished spans.

    One per process (:data:`recorder`), like the telemetry counters; the
    flight recorder snapshots it on failure, the exporter may sample it.
    Capacity comes from ``BAGUA_OBS_RING`` lazily (the module imports
    before test harnesses set their env)."""

    def __init__(self, capacity: Optional[int] = None):
        self._lock = threading.Lock()
        self._capacity = capacity
        self._spans: Optional[deque] = (
            deque(maxlen=capacity) if capacity else None
        )
        self._dropped = 0
        self._local = threading.local()
        #: spans currently OPEN (entered, not yet exited), keyed by the
        #: span object: the flight recorder reports these as "what was in
        #: flight when the defense tripped" — a wedged watched section
        #: never reaches the ring, but it IS the post-mortem's headline
        self._open: Dict[int, Dict[str, Any]] = {}

    def _buf(self) -> deque:
        if self._spans is None:
            self._capacity = max(1, _env.get_obs_ring_size())
            self._spans = deque(maxlen=self._capacity)
        return self._spans

    def set_capacity(self, capacity: int) -> None:
        """Re-size the ring (tests); drops existing spans."""
        with self._lock:
            self._capacity = int(capacity)
            self._spans = deque(maxlen=self._capacity)
            self._dropped = 0

    # -- depth bookkeeping (per thread, so nesting renders correctly even
    # with the watchdog waiter recording concurrently) ----------------------

    def _enter(self) -> int:
        d = getattr(self._local, "depth", 0)
        self._local.depth = d + 1
        return d

    def _exit(self) -> None:
        self._local.depth = max(0, getattr(self._local, "depth", 1) - 1)

    def open_span(self, key: int, stub: Dict[str, Any]) -> None:
        with self._lock:
            self._open[key] = stub

    def close_span(self, key: int, span: Dict[str, Any]) -> None:
        """Pop the open stub and append the finished span — one lock
        acquisition for both."""
        with self._lock:
            self._open.pop(key, None)
            buf = self._buf()
            if len(buf) == buf.maxlen:
                self._dropped += 1
            buf.append(span)

    def snapshot(self) -> List[Dict[str, Any]]:
        """Copies of every retained (finished) span, oldest first."""
        with self._lock:
            return [dict(s) for s in self._buf()]

    def active_snapshot(self) -> List[Dict[str, Any]]:
        """Copies of spans currently in flight (entered, not exited),
        oldest first — the sections a hang is pinning."""
        with self._lock:
            return sorted((dict(s) for s in self._open.values()),
                          key=lambda s: s["t0"])

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        with self._lock:
            if self._spans is not None:
                self._spans.clear()
            self._open.clear()
            self._dropped = 0


#: process-wide span ring (one per process, like ``telemetry.counters``);
#: ``span_ring`` is the collision-free alias the package re-exports
#: (``obs.recorder`` is the flight-recorder MODULE)
recorder = SpanRecorder()
span_ring = recorder


class _Span:
    """The context manager behind :func:`trace_span` — a plain class with
    ``__slots__`` instead of ``contextlib.contextmanager`` because the
    enter/exit pair sits on the train-step hot path."""

    __slots__ = ("name", "attrs", "t0", "step", "ledger_cls")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self.step = self.attrs.pop("step", _CURRENT_STEP)
        depth = recorder._enter()
        # ledger ownership resolves at open (outermost mapped span wins);
        # one global read when no sink is installed
        self.ledger_cls = (
            _LEDGER_SINK.span_enter(self.name) if _LEDGER_SINK else None
        )
        self.t0 = time.monotonic()
        recorder.open_span(id(self), {
            "name": self.name,
            "t0": self.t0,
            "rank": _cached_rank(),
            "step": self.step,
            "depth": depth,
            "thread": threading.current_thread().name,
        })
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.monotonic()
        depth = getattr(recorder._local, "depth", 1) - 1
        recorder._exit()
        if self.ledger_cls is not None and _LEDGER_SINK is not None:
            _LEDGER_SINK.span_exit(self.ledger_cls, t1 - self.t0)
        span = {
            "name": self.name,
            "t0": self.t0,
            "t1": t1,
            "dur_s": t1 - self.t0,
            "rank": _cached_rank(),
            "step": self.step,
            "depth": depth,
            "thread": threading.current_thread().name,
        }
        if exc_type is not None:
            span["error"] = exc_type.__name__
        if self.attrs:
            span["attrs"] = self.attrs
        recorder.close_span(id(self), span)
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL = _NullSpan()


def trace_span(name: str, **attrs):
    """Open a structured span::

        with trace_span("step/bucket_collective", bucket=i, bytes=n):
            ...

    Records monotonic start/end, duration, rank, the trainer's current step
    (override with ``step=``), nesting depth, thread name, and the given
    key=value attrs into the process ring buffer.  A no-op (returns a
    shared null context) while ``BAGUA_OBS=off``.  Attrs must be host
    values (ints/floats/strings), never tensors."""
    if not enabled():
        return _NULL
    return _Span(name, attrs)
