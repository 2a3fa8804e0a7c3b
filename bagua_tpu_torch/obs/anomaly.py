"""Step-time anomaly detection: notice when a step gets slow, and say why.

Port of ``bagua_tpu/obs/anomaly.py``.  The detector watches the raw host
step cadence plus the per-phase host durations the trainer samples, keeps
a rolling ROBUST baseline (median/MAD), and when a step lands far outside
it:

* counts the event (``obs/step_anomalies``),
* triggers a throttled flight-recorder dump (trigger ``step_anomaly``),
* publishes a ``straggler_suspect`` phase breakdown (dispatch /
  collective / optimizer / other) into the per-rank obs summary, which
  rides the health beacon to the coordinator's fleet snapshot, and
* feeds a bounded **perf hint** queue for the autotune service.

Phases (host side): ``dispatch`` is the step's host call — the port's eager
step launches its kernels and, at world > 1, runs gloo's collectives
there, so a slow rank shows a dispatch-dominant excess; ``collective`` is
a host-visible synchronization wait (async negotiate/catch-up boundaries,
gated straggler stalls); ``optimizer`` is the grad-guard verdict readback;
the residual is ``other``.  Coordinator side,
:func:`fleet_straggler_suspects` applies the same logic across ranks.

Import-light (no torch).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from statistics import median
from typing import Dict, List, Optional

from .. import env as _env
from ..telemetry import counters

logger = logging.getLogger(__name__)

__all__ = [
    "StepAnomalyDetector", "PHASES", "publish_perf_hint",
    "drain_perf_hints", "requeue_perf_hints", "peek_perf_hints",
    "fleet_straggler_suspects",
]

#: the attributed phases of one host step window; anything unattributed
#: lands in "other"
PHASES = ("dispatch", "collective", "optimizer")

#: 1.4826 * MAD estimates the standard deviation for Gaussian data — the
#: usual robust-z scaling
_MAD_SIGMA = 1.4826

#: minimum step-time ratio for an anomaly to become an autotune perf HINT:
#: hints postpone a sampling window (the service re-measures instead of
#: scoring), so 1.5-3x host blips — real anomalies, worth a suspect and a
#: counter — must not stall the Bayesian loop; a genuine straggler is an
#: order of magnitude out
HINT_MIN_RATIO = 3.0


class StepAnomalyDetector:
    """Rolling median/MAD anomaly detector over raw step time.

    ``observe(step, raw_dt, phases)`` once per step (host side, after the
    cadence sample).  Returns the ``straggler_suspect`` dict when the step
    is anomalous, else None.  A step is anomalous when, against the
    rolling window of PRIOR samples (after ``warmup`` of them exist)::

        raw_dt > median + threshold * 1.4826 * MAD
        raw_dt > min_ratio * median          # MAD→0 guard on quiet hosts

    Both conditions — a near-zero MAD (perfectly steady cadence) would
    otherwise flag microsecond jitter.  The offending sample still enters
    the window afterwards: median/MAD shrug off minority contamination, so
    one spike cannot mask the next.
    """

    def __init__(self, window: Optional[int] = None,
                 warmup: Optional[int] = None,
                 threshold: Optional[float] = None,
                 min_ratio: float = 1.3,
                 dump_min_interval_s: float = 30.0,
                 rank: Optional[int] = None):
        self.window = int(window if window is not None
                          else _env.get_obs_anomaly_window())
        self.warmup = int(warmup if warmup is not None
                          else _env.get_obs_anomaly_warmup())
        self.threshold = float(threshold if threshold is not None
                               else _env.get_obs_anomaly_threshold())
        if self.window < 4:
            raise ValueError(f"window must be >= 4, got {self.window}")
        if self.warmup < 2:
            raise ValueError(f"warmup must be >= 2, got {self.warmup}")
        self.min_ratio = float(min_ratio)
        self.dump_min_interval_s = float(dump_min_interval_s)
        self.rank = int(_env.get_rank()) if rank is None else int(rank)
        self._dts: deque = deque(maxlen=self.window)
        self._phase_dts: Dict[str, deque] = {}
        self._last_dump_mono: Optional[float] = None
        #: bounded history of flagged suspects (newest last) — drills and
        #: operators read it; the beacon carries only the latest
        self.suspects: deque = deque(maxlen=16)

    # -- core -------------------------------------------------------------

    def observe(self, step: int, raw_dt: Optional[float],
                phases: Optional[Dict[str, float]] = None
                ) -> Optional[dict]:
        if raw_dt is None or raw_dt <= 0:
            return None
        phases = {k: float(v) for k, v in (phases or {}).items() if v > 0}
        other = max(0.0, raw_dt - sum(phases.values()))
        suspect = None
        if len(self._dts) >= self.warmup:
            base = sorted(self._dts)
            med = median(base)
            mad = median(abs(x - med) for x in base)
            cut = med + self.threshold * _MAD_SIGMA * mad
            if raw_dt > cut and raw_dt > self.min_ratio * med and med > 0:
                suspect = self._flag(step, raw_dt, med, mad, phases, other)
        self._dts.append(raw_dt)
        # EVERY known phase gets a sample each step — a phase absent this
        # window contributed 0 s.  Without the zeros, a phase only seen
        # during anomalies (a straggler's collective wait) would have an
        # anomaly-sized baseline by its second occurrence and dominance
        # attribution would flip to whatever phase was still uncontaminated
        for name in set(PHASES) | set(phases):
            self._phase_dts.setdefault(
                name, deque(maxlen=self.window)).append(
                    phases.get(name, 0.0))
        self._phase_dts.setdefault(
            "_other", deque(maxlen=self.window)).append(other)
        return suspect

    def _phase_baseline(self, name: str) -> float:
        hist = self._phase_dts.get(name)
        return median(hist) if hist else 0.0

    def _flag(self, step: int, raw_dt: float, med: float, mad: float,
              phases: Dict[str, float], other: float) -> dict:
        # phase breakdown of the EXCESS: each attributed phase's duration
        # minus its own rolling median (of PRIOR windows — this window's
        # samples enter the history only after flagging); the residual
        # host time is "other"
        breakdown: Dict[str, float] = {}
        excess: Dict[str, float] = {}
        for name in sorted(set(PHASES) | set(phases)):
            dur = phases.get(name, 0.0)
            breakdown[name] = round(dur, 6)
            excess[name] = dur - self._phase_baseline(name)
        breakdown["other"] = round(other, 6)
        excess["other"] = other - self._phase_baseline("_other")
        dominant = max(excess, key=lambda k: excess[k])
        suspect = {
            "rank": self.rank,
            "step": int(step),
            "step_dt": round(raw_dt, 6),
            "baseline_p50": round(med, 6),
            "baseline_mad": round(mad, 6),
            "ratio": round(raw_dt / med, 3) if med else None,
            "dominant_phase": dominant,
            "phases": breakdown,
            "detected_at_unix": time.time(),
        }
        self.suspects.append(suspect)
        counters.incr("obs/step_anomalies")
        logger.warning(
            "step anomaly: rank %d step %d took %.4fs (baseline p50 "
            "%.4fs, x%.1f) — dominant phase %r",
            self.rank, step, raw_dt, med, suspect["ratio"] or 0.0, dominant,
        )
        # the fleet-view half: the latest suspect rides the obs summary
        # (beacon -> heartbeat -> coordinator snapshot)
        from . import export as _export

        _export.note_anomaly(suspect)
        if suspect["ratio"] is not None \
                and suspect["ratio"] >= HINT_MIN_RATIO:
            publish_perf_hint({
                "kind": "step_time_anomaly",
                "rank": self.rank,
                "step": int(step),
                "ratio": suspect["ratio"],
                "dominant_phase": dominant,
            })
        self._maybe_dump(suspect)
        return suspect

    def _maybe_dump(self, suspect: dict) -> None:
        """Throttled flight-recorder dump of the offending window: the ring
        around the slow step is the post-mortem; per-anomaly dumps on a
        chronically slow host would turn the recorder into the I/O
        straggler it is hunting."""
        now = time.monotonic()
        if self._last_dump_mono is not None \
                and now - self._last_dump_mono < self.dump_min_interval_s:
            return
        self._last_dump_mono = now
        from . import recorder as _recorder

        _recorder.dump_flight_record(
            "step_anomaly",
            reason=(f"step {suspect['step']} took {suspect['step_dt']}s "
                    f"(baseline p50 {suspect['baseline_p50']}s)"),
            extra={"straggler_suspect": suspect},
        )


# ---- perf hint channel (consumed by the autotune service) -----------------

_HINT_LOCK = threading.Lock()
_HINTS: deque = deque(maxlen=32)


def publish_perf_hint(hint: dict) -> None:
    """Queue a perf hint for the next autotune check-in.  Bounded (oldest
    drop): hints are advisory context, never a backlog to drain at any
    cost."""
    with _HINT_LOCK:
        _HINTS.append(dict(hint))
    counters.incr("obs/perf_hints")


def drain_perf_hints() -> List[dict]:
    """Pop every queued hint (oldest first) — the trainer's autotune
    check-in attaches them to ``report_metrics``."""
    with _HINT_LOCK:
        hints = list(_HINTS)
        _HINTS.clear()
    return hints


def requeue_perf_hints(hints: List[dict]) -> None:
    """Put drained hints BACK (front of the queue, original order) after a
    failed delivery — a transient sidecar hiccup must not silently discard
    the taint signal for the window it described.  No counter increment:
    these hints were already counted when published."""
    if not hints:
        return
    with _HINT_LOCK:
        for hint in reversed(hints):
            _HINTS.appendleft(dict(hint))


def peek_perf_hints() -> List[dict]:
    with _HINT_LOCK:
        return list(_HINTS)


# ---- coordinator-side fleet analysis --------------------------------------


def fleet_straggler_suspects(fleet_record: dict) -> dict:
    """Read a ``bagua-obs-fleet-v1`` snapshot and name the straggler(s).

    A rank whose anomaly is **dispatch**-dominant (or ``other``-dominant —
    locally slow host time) is itself slow: a straggler.  A rank whose
    anomaly is **collective**-dominant is *waiting* on someone else: a
    victim.  Returns ``{"stragglers": [...], "victims": [...]}`` where
    each entry is ``{"rank", "node", "suspect"}`` sorted by excess ratio —
    the consumable answer for the coordinator (and the autotune scorer,
    which must not re-tune knobs to chase an environmental straggler)."""
    stragglers: List[dict] = []
    victims: List[dict] = []
    for node_id, entry in (fleet_record.get("ranks") or {}).items():
        for rank_id, summary in (entry.get("obs") or {}).items():
            suspect = (summary or {}).get("straggler_suspect")
            if not suspect:
                continue
            item = {"rank": int(suspect.get("rank", rank_id)),
                    "node": int(node_id), "suspect": suspect}
            if suspect.get("dominant_phase") == "collective":
                victims.append(item)
            else:
                stragglers.append(item)
    key = lambda it: -(it["suspect"].get("ratio") or 0)  # noqa: E731
    return {"stragglers": sorted(stragglers, key=key),
            "victims": sorted(victims, key=key)}
