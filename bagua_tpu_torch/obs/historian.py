"""Fleet telemetry historian: bounded time-series memory over the
fleet-snapshot stream.

The rest of the obs plane is rich but memoryless: metrics land in
``metrics.jsonl``/``metrics.prom`` files and the coordinator's fleet
snapshot is a point-in-time record, so the autopilot's "sustained"
windows live only as in-memory streak counters and nothing can answer
"is HBM headroom shrinking?" or "what share of the step is DCN seconds,
trending over the last 10 minutes?".  The MegaScale goodput lens the
ledger adopted (arXiv 2402.15627) is explicitly a *fleet-historical*
diagnosis tool, and the reference Bagua (arXiv 2107.01499) runs its
autotuner off a live metrics service rather than files — this module is
that memory, coordinator-side:

* **Bounded rings.**  Every numeric field of every rank's obs summary in
  each ingested ``bagua-obs-fleet-v1`` record lands in a per-(rank,
  metric) ring of ``BAGUA_OBS_HISTORIAN_CAPACITY`` samples (plus the
  fleet-level efficiency aggregates under the pseudo-rank ``fleet``).
* **Windowed queries.**  :meth:`Historian.rate`,
  :meth:`Historian.percentile`, and :meth:`Historian.slope`
  (least-squares, per second) over a trailing window — the primitives
  behind the trend gauges and the ``/history`` HTTP endpoint
  (:mod:`bagua_tpu_torch.obs.http`).
* **Trend gauges back into the snapshot.**  :meth:`Historian.ingest`
  augments each rank summary with a ``trends`` sub-dict
  (``goodput_slope``, ``hbm_headroom_slope``, ``hbm_headroom_eta_s``,
  ``dcn_comm_share``) and publishes the fleet-worst values as the
  ``obs/goodput_slope`` / ``obs/hbm_headroom_slope`` /
  ``obs/dcn_comm_share`` gauges — the evidence the autopilot's trend
  rules (pre-OOM resize, DCN compression escalation;
  :mod:`bagua_tpu_torch.autopilot.policy`) consume.
* **Restart persistence.**  Rings serialize through the restart TCPStore
  (key ``obs/historian``, epoch-UNfenced like the autopilot's policy
  state) so a relaunched coordinator keeps its history instead of
  re-earning every trend window from scratch.

Deterministic by construction: samples are timestamped by the ingested
record's own ``time_unix`` (never the wall clock), so a recorded stream
replayed through ``python -m bagua_tpu_torch.autopilot --historian`` computes
the exact trends the live coordinator saw.  Port of
``bagua_tpu/obs/historian.py``; host-side only: the
launcher's monitor loop hosts it.
"""

from __future__ import annotations

import json
import logging
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from .. import env as _env
from ..telemetry import counters

logger = logging.getLogger(__name__)

__all__ = ["Historian", "maybe_build_historian", "STORE_KEY",
           "least_squares_slope"]

#: restart-store key the rings persist under — OUTSIDE the epoch-fenced
#: ``elastic/<e>/`` keyspace: trend windows must survive epoch bumps and
#: coordinator relaunches (the autopilot state-persistence pattern)
STORE_KEY = "obs/historian"

#: pseudo-rank carrying the fleet-level efficiency aggregates
FLEET_RANK = "fleet"

#: minimum samples before a windowed slope/share is emitted — one or two
#: points fit a line perfectly and would fire trend rules off noise
MIN_TREND_SAMPLES = 4

#: how many ingests between restart-store persists (each persist is one
#: store round-trip; trend windows tolerate losing a few trailing samples
#: on a coordinator crash — they merely re-earn them)
PERSIST_EVERY = 5


def least_squares_slope(samples: List[Tuple[float, float]]
                        ) -> Optional[float]:
    """Ordinary least-squares slope (value units per second) of
    ``(time_unix, value)`` samples; None when under
    :data:`MIN_TREND_SAMPLES` or the time spread is degenerate."""
    if len(samples) < MIN_TREND_SAMPLES:
        return None
    t0 = samples[0][0]
    xs = [t - t0 for t, _ in samples]
    ys = [v for _, v in samples]
    n = float(len(samples))
    mean_x = sum(xs) / n
    mean_y = sum(ys) / n
    sxx = sum((x - mean_x) ** 2 for x in xs)
    if sxx <= 0.0:
        return None  # all samples at one instant: slope undefined
    sxy = sum((x - mean_x) * (y - mean_y) for x, y in zip(xs, ys))
    return sxy / sxx


def _percentile(sorted_vals: List[float], q: float) -> float:
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def _first_to_last_rate(samples: List[Tuple[float, float]]
                        ) -> Optional[float]:
    """First-to-last delta per second — the honest rate for monotonic
    counters (shared by :meth:`Historian.rate` and ``/history``'s
    ``rate_per_s`` so the two can never diverge)."""
    if len(samples) < 2:
        return None
    (t0, v0), (t1, v1) = samples[0], samples[-1]
    if t1 <= t0:
        return None
    return (v1 - v0) / (t1 - t0)


def maybe_build_historian(store=None) -> Optional["Historian"]:
    """The launcher's tolerant factory: a :class:`Historian` when
    ``BAGUA_OBS_HISTORIAN=on``, else None — and None WITH a warning on a
    misconfigured knob (e.g. a non-positive capacity).  An observability
    setting must degrade to "historian off", never kill the coordinator
    at bring-up (the HTTP plane's contract, held here too)."""
    if not _env.is_obs_historian_on():
        return None
    try:
        return Historian(store=store)
    except (ValueError, TypeError) as e:
        logger.warning("telemetry historian disabled (bad configuration): "
                       "%s", e)
        return None


class Historian:
    """Coordinator-side time-series store over the fleet-snapshot stream.

    Thread-safe: the monitor loop ingests while the HTTP plane's
    ``/history`` handler queries.
    """

    def __init__(self, capacity: Optional[int] = None,
                 window_s: Optional[float] = None, store=None,
                 persist_every: int = PERSIST_EVERY):
        self.capacity = int(
            _env.get_obs_historian_capacity() if capacity is None
            else capacity
        )
        if self.capacity <= 0:
            raise ValueError(
                f"historian capacity must be positive, got {self.capacity}"
            )
        self.window_s = float(
            _env.get_obs_historian_window_s() if window_s is None
            else window_s
        )
        self._store = store
        self._persist_every = max(1, int(persist_every))
        self._lock = threading.Lock()
        #: (rank_id, metric) -> deque[(time_unix, value)]
        self._rings: Dict[Tuple[str, str], deque] = {}
        self._last_ingest_unix: Optional[float] = None
        self._ingests_since_persist = 0
        if store is not None:
            self._load(store)

    # ---- restart persistence -------------------------------------------

    def _load(self, store) -> None:
        try:
            raw = store.get(STORE_KEY)
        except Exception as e:  # noqa: BLE001 - store may be coming up
            logger.debug("historian state not loaded: %s", e)
            return
        if not raw:
            return
        try:
            self.load_json(raw)
            logger.info(
                "historian: resumed %d series (last sample %.0f)",
                len(self._rings), self._last_ingest_unix or 0.0,
            )
        except (ValueError, TypeError, KeyError) as e:
            logger.warning("historian: persisted state unreadable (%s); "
                           "starting fresh", e)

    def _maybe_persist(self) -> None:
        if self._store is None:
            return
        self._ingests_since_persist += 1
        if self._ingests_since_persist < self._persist_every:
            return
        self._ingests_since_persist = 0
        try:
            self._store.set(STORE_KEY, self.to_json())
        except Exception as e:  # noqa: BLE001 - monitoring must not die
            logger.debug("historian state not persisted: %s", e)

    def to_json(self) -> str:
        with self._lock:
            payload = {
                "capacity": self.capacity,
                "last_ingest_unix": self._last_ingest_unix,
                "series": {
                    f"{rank}\x00{metric}": [[t, v] for t, v in ring]
                    for (rank, metric), ring in self._rings.items()
                },
            }
        return json.dumps(payload)

    def load_json(self, raw) -> None:
        text = raw.decode() if isinstance(raw, bytes) else str(raw)
        payload = json.loads(text)
        series = payload["series"]
        with self._lock:
            self._rings.clear()
            for key, samples in series.items():
                rank, _, metric = key.partition("\x00")
                ring = deque(maxlen=self.capacity)
                ring.extend((float(t), float(v)) for t, v in samples)
                self._rings[(rank, metric)] = ring
            self._last_ingest_unix = payload.get("last_ingest_unix")

    # ---- ingest ---------------------------------------------------------

    def _append(self, rank: str, metric: str, t: float, value) -> None:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            return
        key = (str(rank), str(metric))
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = deque(maxlen=self.capacity)
        ring.append((float(t), float(value)))

    def ingest(self, record: dict) -> dict:
        """Consume one ``bagua-obs-fleet-v1`` record: append every numeric
        per-rank summary field (and the fleet efficiency aggregates) at
        the record's OWN ``time_unix``, then augment the record in place —
        each rank summary gains a ``trends`` sub-dict and the record a
        fleet-level ``trends`` rollup — and publish the fleet-worst trend
        gauges.  A duplicate/older ``time_unix`` is not new evidence and
        leaves the rings untouched (the autopilot's duplicate-snapshot
        guard, mirrored here so a re-read cannot bend a slope).  Returns
        the (augmented) record."""
        t = record.get("time_unix")
        if t is None:
            return record
        t = float(t)
        with self._lock:
            fresh = (self._last_ingest_unix is None
                     or t > self._last_ingest_unix)
            if fresh:
                self._last_ingest_unix = t
                for entry in (record.get("ranks") or {}).values():
                    if not isinstance(entry, dict):
                        continue
                    for rank_id, summary in (entry.get("obs") or {}).items():
                        if not isinstance(summary, dict):
                            continue
                        for metric, value in summary.items():
                            self._append(rank_id, metric, t, value)
                eff = record.get("efficiency") or {}
                for metric in ("goodput_fraction_mean",
                               "goodput_fraction_min"):
                    if eff.get(metric) is not None:
                        self._append(FLEET_RANK, metric, t, eff[metric])
        self._publish_trends(record)
        if fresh:
            self._maybe_persist()
        return record

    # ---- windowed queries ----------------------------------------------

    def metrics(self) -> List[Tuple[str, str]]:
        """Every (rank, metric) series held, sorted."""
        with self._lock:
            return sorted(self._rings)

    def ranks_for(self, metric: str) -> List[str]:
        with self._lock:
            return sorted({r for r, m in self._rings if m == metric})

    def window(self, rank, metric: str, window_s: Optional[float] = None,
               asof: Optional[float] = None) -> List[Tuple[float, float]]:
        """Samples of one series inside the trailing window.  The window
        anchors on ``asof`` when given (the trend path passes the last
        ingest time, so a series that STOPPED updating ages out of its
        window instead of republishing its final slope forever); without
        ``asof`` it anchors on the series' newest sample (the exploratory
        ``/history`` behavior).  Wall-clock-free either way — replays see
        identical windows."""
        window_s = self.window_s if window_s is None else float(window_s)
        with self._lock:
            ring = self._rings.get((str(rank), str(metric)))
            if not ring:
                return []
            anchor = ring[-1][0] if asof is None else float(asof)
            return [(t, v) for t, v in ring if 0 <= anchor - t <= window_s]

    def latest(self, rank, metric: str) -> Optional[float]:
        with self._lock:
            ring = self._rings.get((str(rank), str(metric)))
            return ring[-1][1] if ring else None

    def slope(self, rank, metric: str, window_s: Optional[float] = None,
              asof: Optional[float] = None) -> Optional[float]:
        """Least-squares slope (units/second) over the trailing window."""
        return least_squares_slope(self.window(rank, metric, window_s,
                                               asof=asof))

    def rate(self, rank, metric: str, window_s: Optional[float] = None,
             asof: Optional[float] = None) -> Optional[float]:
        """First-to-last delta per second over the window — the honest
        rate for monotonic counters (steps, tokens, event counts)."""
        return _first_to_last_rate(self.window(rank, metric, window_s,
                                               asof=asof))

    def percentile(self, rank, metric: str, q: float,
                   window_s: Optional[float] = None,
                   asof: Optional[float] = None) -> Optional[float]:
        samples = self.window(rank, metric, window_s, asof=asof)
        if not samples:
            return None
        return _percentile(sorted(v for _, v in samples), float(q))

    def mean(self, rank, metric: str, window_s: Optional[float] = None,
             asof: Optional[float] = None) -> Optional[float]:
        samples = self.window(rank, metric, window_s, asof=asof)
        if not samples:
            return None
        return sum(v for _, v in samples) / len(samples)

    def history_report(self, metric: str, rank=None,
                       window_s: Optional[float] = None) -> dict:
        """The ``/history?metric=&rank=&window=`` payload: per-rank
        samples + windowed stats for one metric."""
        window_s = self.window_s if window_s is None else float(window_s)
        ranks = [str(rank)] if rank is not None else self.ranks_for(metric)
        out: Dict[str, dict] = {}
        for rid in ranks:
            samples = self.window(rid, metric, window_s)
            if not samples:
                continue
            values = sorted(v for _, v in samples)
            out[rid] = {
                "samples": [[t, v] for t, v in samples],
                "latest": samples[-1][1],
                "p50": _percentile(values, 0.5),
                "p90": _percentile(values, 0.9),
                "slope_per_s": least_squares_slope(samples),
                "rate_per_s": _first_to_last_rate(samples),
            }
        return {"metric": str(metric), "window_s": window_s, "ranks": out}

    # ---- derived trends -------------------------------------------------

    def trend_summary(self, rank, asof: Optional[float] = None
                      ) -> Optional[dict]:
        """The derived trend gauges for one rank over the trailing window
        (None when nothing is computable yet):

        * ``goodput_slope`` — goodput_fraction per second.
        * ``hbm_headroom_slope`` — live HBM headroom bytes per second;
          ``hbm_headroom_eta_s`` projects exhaustion (latest headroom /
          -slope) when the slope is negative.
        * ``dcn_comm_share`` — windowed mean DCN device seconds over
          windowed mean step time (falls back to the DCN share of total
          comm when no step cadence rides the summary).

        Every window anchors on ``asof`` (default: the last ingest time):
        a series that stopped updating — a dead memory poll, a rank that
        no longer reports DCN seconds — ages out of its window instead of
        republishing its final slope into every later snapshot, so the
        autopilot can never act on evidence older than the window (the
        per-series analog of the suspect TTL).
        """
        asof = self._last_ingest_unix if asof is None else float(asof)
        out: dict = {}
        gp = self.slope(rank, "goodput_fraction", asof=asof)
        if gp is not None:
            out["goodput_slope"] = gp
        hbm_samples = self.window(rank, "hbm_headroom_bytes", asof=asof)
        hbm = least_squares_slope(hbm_samples)
        if hbm is not None:
            out["hbm_headroom_slope"] = hbm
            headroom = hbm_samples[-1][1]
            if hbm < 0 and headroom > 0:
                out["hbm_headroom_eta_s"] = headroom / -hbm
        dcn_samples = self.window(rank, "device_comm_dcn_s_per_step",
                                  asof=asof)
        if len(dcn_samples) >= MIN_TREND_SAMPLES:
            dcn = sum(v for _, v in dcn_samples) / len(dcn_samples)
            step_dt = self.mean(rank, "step_dt_p50", asof=asof)
            if step_dt and step_dt > 0:
                out["dcn_comm_share"] = min(1.0, dcn / step_dt)
            else:
                ici = self.mean(rank, "device_comm_ici_s_per_step",
                                asof=asof) or 0.0
                if dcn + ici > 0:
                    out["dcn_comm_share"] = dcn / (dcn + ici)
        if not out:
            return None
        out["window_s"] = self.window_s
        return out

    def _publish_trends(self, record: dict) -> None:
        """Augment the record's rank summaries with their ``trends`` and
        publish the fleet-worst values as gauges + a fleet rollup."""
        worst: Dict[str, float] = {}
        for entry in (record.get("ranks") or {}).values():
            if not isinstance(entry, dict):
                continue
            for rank_id, summary in (entry.get("obs") or {}).items():
                if not isinstance(summary, dict):
                    continue
                trends = self.trend_summary(rank_id)
                if not trends:
                    continue
                summary["trends"] = trends
                for key, keep_worse in (("goodput_slope", min),
                                        ("hbm_headroom_slope", min),
                                        ("dcn_comm_share", max)):
                    v = trends.get(key)
                    if v is None:
                        continue
                    worst[key] = (v if key not in worst
                                  else keep_worse(worst[key], v))
        if worst:
            record["trends"] = {f"{k}_worst": v for k, v in worst.items()}
            record["trends"]["window_s"] = self.window_s
        # gauges are refreshed EVERY publish, expired evidence included:
        # a key whose series aged out of the window reads 0 (flat / no
        # evidence), never the last alarming value — a resized-away
        # rank's steep headroom slope must not haunt dashboards for the
        # rest of the run
        for key, gauge in (("goodput_slope", "obs/goodput_slope"),
                           ("hbm_headroom_slope", "obs/hbm_headroom_slope"),
                           ("dcn_comm_share", "obs/dcn_comm_share")):
            counters.set_gauge(gauge, worst.get(key, 0.0))
