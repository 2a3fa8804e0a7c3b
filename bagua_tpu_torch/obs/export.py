"""Metrics exporter and fleet view: the file half of the obs plane.

Port of ``bagua_tpu/obs/export.py``:

* :data:`METRIC_REGISTRY` — every counter/gauge name with its kind and doc,
  the JAX package's names and kinds (``tests/test_torch_obs.py`` holds
  every name the port's sources emit against it), plus the port's own
  ``async/round_wait_s``.
* :class:`MetricsExporter` — a background thread that periodically merges
  ``telemetry.counters``, the trainer's latest step metrics and its
  ``measured_step_dt`` history into ``metrics.jsonl`` (one snapshot per
  line) and ``metrics.prom`` (a Prometheus textfile) under
  ``BAGUA_OBS_EXPORT_DIR``.
* **fleet view** — each worker's per-rank summary
  (:func:`local_obs_summary`) rides the worker's health beacon onto the
  launcher's lease heartbeat; the coordinator-side monitor merges every
  member's payload into one fleet snapshot (:func:`write_fleet_snapshot`,
  ``BAGUA_OBS_FLEET_OUT``).

Import-light (no torch): the launcher's monitor writes the fleet snapshot.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import re
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from .. import env as _env
from ..faults.inject import FAULT_POINTS
from ..telemetry import counters

logger = logging.getLogger(__name__)

#: goodput-ledger attribution classes (single source of truth for the
#: `obs/ledger/<cls>_s` gauge names; :mod:`.ledger` — a
#: ``python -m`` entry point this module must not import eagerly — reads
#: them from here)
LEDGER_CLASSES = (
    "productive_step", "compile", "state_migration", "checkpoint",
    "rendezvous", "catchup_sync", "rewind", "stall",
    # serving classes: prefill/decode are a serving
    # replica's goodput; batch-formation idle and weight loads are its
    # named badput
    "prefill", "decode", "batch_formation_idle", "weight_load",
    "idle_other",
)


def _ledger():
    # lazy: obs.ledger is a CLI entry point; importing it from package
    # import time would leave runpy executing a second module copy
    from .ledger import ledger

    return ledger

__all__ = [
    "METRIC_REGISTRY", "Metric", "LEDGER_CLASSES",
    "is_registered", "any_registered_matches",
    "MetricsExporter", "render_prometheus", "prepared_snapshot",
    "local_obs_summary",
    "note_step", "note_step_metrics", "note_anomaly",
    "note_device_attribution", "last_device_attribution",
    "note_mfu", "last_mfu", "note_hbm_footprint", "last_hbm_footprint",
    "note_hbm_live", "last_hbm_live", "note_ckpt_directory",
    "build_fleet_record", "write_fleet_snapshot", "validate_fleet_snapshot",
    "FLEET_SCHEMA",
]


# ---- metric registry ------------------------------------------------------


@dataclass(frozen=True)
class Metric:
    """One declared metric: the single source of truth for its kind and
    operator-facing documentation (the counter analog of ``env.EnvVar``)."""

    name: str
    kind: str  # "counter" (monotonic event count) | "gauge" (last value)
    doc: str


METRIC_REGISTRY: Dict[str, Metric] = {}


def _declare(name: str, kind: str, doc: str) -> None:
    assert kind in ("counter", "gauge"), kind
    METRIC_REGISTRY[name] = Metric(name, kind, doc)


# -- communication / watchdog --
_declare("comm/aborts", "counter",
         "Cooperative abort flag raises (watchdog fire, grad-guard abort, "
         "user abort()).")
_declare("comm/abort_resets", "counter",
         "reset_abort() recoveries after an abort.")
# -- gradient-health sentinel --
_declare("grad_guard/unhealthy_steps", "counter",
         "Steps whose gradients contained NaN/Inf (any policy).")
_declare("grad_guard/skipped_steps", "counter",
         "Unhealthy steps rewound by policy `skip`.")
_declare("grad_guard/aborts", "counter",
         "Guard escalations to the comm abort flag (policy `abort`, or the "
         "consecutive-skip budget).")
# -- checkpoint integrity chain --
_declare("ckpt/integrity_failures", "counter",
         "Checkpoints that failed verification at restore (unreadable step, "
         "torn sidecar, content-digest mismatch).")
_declare("ckpt/fallback_restores", "counter",
         "Restores that landed on an older step after newer checkpoint(s) "
         "failed verification.")
_declare("ckpt/verified_restores", "counter",
         "Restores whose content digest verified against the save-time "
         "record.")
_declare("ckpt/stacked_resize_restores", "counter",
         "Stacked (per-rank) checkpoints re-tiled onto a resized world.")
# -- async model averaging --
_declare("async/rounds_launched", "counter",
         "Averaging rounds launched at negotiated boundaries.")
_declare("async/rounds_applied", "counter",
         "Rounds whose delta was applied on this rank.")
_declare("async/rounds_dropped", "counter",
         "Rounds discarded without applying (rewind veto, partition, "
         "catch-up supersede, abort).")
_declare("async/missed_boundaries", "counter",
         "This-rank round drops that count as fenceable health events.")
_declare("async/catchup_syncs", "counter",
         "Forced synchronous catch-up averages (staleness cap, checkpoint "
         "sync).")
_declare("async/staleness_max", "gauge",
         "Worst rank's applied-round lag observed at the last negotiated "
         "boundary.")
_declare("async/aborts_negotiated", "counter",
         "Negotiated ABORT transitions of the averaging control loop.")
_declare("async/resumes_negotiated", "counter",
         "Negotiated RESUME transitions of the averaging control loop.")
_declare("async/round_wait_s", "counter",
         "Host seconds the applies of launched rounds spent waiting on "
         "their collectives (the port's own; the JAX package has no such "
         "wait to count).")
# -- elastic membership / launcher --
_declare("elastic/rounds", "counter", "Rendezvous rounds completed.")
_declare("elastic/world_nnodes", "gauge",
         "Node count of the most recently negotiated world.")
_declare("elastic/failures", "counter", "Worker-crash stop events.")
_declare("elastic/lease_expired", "counter", "Lease-expiry stop events.")
_declare("elastic/leaves", "counter",
         "Deliberate-departure stop events (watchdog exit, ^C).")
_declare("elastic/resizes", "counter",
         "Coordinated resize stop events (standby join).")
_declare("elastic/health_fenced", "counter",
         "Members expelled by the heartbeat health fence.")
_declare("elastic/restarts", "counter", "Elastic gang restarts consumed.")
_declare("elastic/excluded", "counter",
         "Rounds this node was excluded from (waited as standby).")
_declare("elastic/lease_rearms", "counter",
         "Member leases re-armed at coordinator takeover (the promotion "
         "grace that prevents a coordinator blip from mass-expiring "
         "healthy workers).")
# -- replicated restart store / coordinator failover --
_declare("store/failovers", "counter",
         "Restart-store client failovers to another endpoint (the previous "
         "endpoint died, wedged, or answered with a write fence).")
_declare("store/op_deadline_exceeded", "counter",
         "Restart-store ops abandoned because the per-op retry deadline "
         "budget (BAGUA_RESTART_STORE_OP_DEADLINE_S) was exhausted.")
_declare("store/fenced_writes", "counter",
         "Writes refused by a demoted/standby store server (generation "
         "fence) as observed by this client.")
_declare("store/promotions", "counter",
         "Store-generation promotions this client performed (bumping a "
         "standby endpoint to primary during failover).")
_declare("coord/takeovers", "counter",
         "Standby coordinator promotions to the active coordinator role "
         "after the leadership lease went stale.")
# -- fault injection (one armed/fired/recovered triple per point) --
for _point in FAULT_POINTS:
    _declare(f"faults/{_point}/armed", "counter",
             f"`{_point}` fault specs armed.")
    _declare(f"faults/{_point}/fired", "counter",
             f"`{_point}` faults fired.")
    _declare(f"faults/{_point}/recovered", "counter",
             f"`{_point}` faults the defense path recovered from.")
# -- observability plane self-accounting --
_declare("obs/flight_dumps", "counter",
         "Flight-recorder post-mortem dumps written.")
_declare("obs/flight_dumps_pruned", "counter",
         "Flight-recorder dumps removed by the BAGUA_OBS_DUMP_MAX_FILES "
         "retention cap (oldest-first; a long run with recurring "
         "throttled faults no longer grows the dump dir without limit).")
_declare("obs/http_requests", "counter",
         "Requests served by this process's HTTP status plane "
         "(obs/http.py: /metrics, /healthz, /ledger, and the "
         "coordinator's /fleet and /history).")
_declare("obs/http_port", "gauge",
         "Port the HTTP status plane actually bound (differs from "
         "BAGUA_OBS_HTTP_PORT when the configured port was taken and "
         "the server fell back to an ephemeral one).")
_declare("obs/export_snapshots", "counter",
         "Metrics-exporter snapshots written (jsonl line + prom file).")
_declare("obs/spans_dropped", "gauge",
         "Spans evicted from this process's bounded span ring "
         "(BAGUA_OBS_RING) — non-zero means a merged timeline's track is "
         "a tail, not the whole run.")
# -- step-time anomaly detection --
_declare("obs/step_anomalies", "counter",
         "Steps flagged by the rolling median/MAD step-time anomaly "
         "detector (raw host cadence far outside this rank's baseline).")
_declare("obs/perf_hints", "counter",
         "Perf hints published for the autotune service (anomaly "
         "detections and other environmental performance signals).")
# -- device-time attribution (profiler-derived) --
_declare("obs/device_comm_s_per_step", "gauge",
         "Measured device communication seconds per step from the last "
         "closed profiler window (null-with-rationale where the device did "
         "no communication work, e.g. gloo through host memory).")
_declare("obs/device_comm_ici_s_per_step", "gauge",
         "Slice-local (ICI-tier) share of the measured device comm seconds "
         "per step: the reduce-scatter + allgather stages of the "
         "hierarchical two-level decomposition; "
         "present only when the per-bucket positional match held on a "
         "two-level launch schedule.")
_declare("obs/device_comm_dcn_s_per_step", "gauge",
         "Cross-slice (DCN-tier) share of the measured device comm seconds "
         "per step: the inter-slice allreduce stage riding the slow link — "
         "the number the two-level decomposition exists to shrink.")
_declare("obs/device_overlap_fraction", "gauge",
         "Fraction of device comm time hidden under compute in the last "
         "closed profiler window (profiling.parse_trace_overlap).")
# -- efficiency plane: goodput ledger + MFU + HBM accounting --
for _cls in LEDGER_CLASSES:
    _declare(f"obs/ledger/{_cls}_s", "gauge",
             f"Cumulative wall-clock seconds the goodput ledger attributes "
             f"to the `{_cls}` class on this rank (docs/observability.md, "
             "efficiency plane).")
_declare("obs/ledger/wall_s", "gauge",
         "Total wall-clock seconds the goodput ledger has covered on this "
         "rank (the conservation denominator: classes sum to this within "
         "1%).")
_declare("obs/goodput_fraction", "gauge",
         "Fraction of this rank's ledger wall spent making forward "
         "progress — productive train steps, plus a serving replica's "
         "prefill/decode walls (the GOODPUT_CLASSES) — the fleet's "
         "headline efficiency number (everything else is badput with a "
         "named class).")
_declare("obs/mfu", "gauge",
         "Model FLOPS utilization of the current step: the step's analytic "
         "model flops / measured step cadence / the card's peak FLOP/s "
         "(absent on an unlisted device — the summary carries a rationale "
         "instead).")
_declare("obs/cost_analysis_unavailable", "counter",
         "step_cost_analysis calls that returned {} because the backend "
         "offered no cost model (one count per compiled program, not per "
         "call) — the formerly silent swallow-all, now visible fleet-wide.")
_declare("obs/hbm_static_footprint_bytes", "gauge",
         "Static per-device footprint: resident TrainState bytes + one "
         "set of per-bucket gradient flats (obs.memory.static_footprint; "
         "exact over the trainer's flats).")
_declare("obs/hbm_peak_bytes", "gauge",
         "Live torch.cuda.memory_stats() peak allocated bytes from the "
         "last beacon-cadence poll (CUDA only; absent on the CPU).")
_declare("obs/hbm_headroom_bytes", "gauge",
         "bytes_limit minus the live peak from the last memory poll — the "
         "capacity-planning margin (CUDA only).")
# -- telemetry historian trend gauges (coordinator-side): windowed
# -- derivatives over the fleet-snapshot stream, published back into each
# -- snapshot and consumed by the autopilot's trend rules (the historian
# -- comes with the fleet and control plane)
_declare("obs/goodput_slope", "gauge",
         "Fleet-worst least-squares slope of goodput_fraction per second "
         "over the historian's trend window (BAGUA_OBS_HISTORIAN_WINDOW_S)"
         " — negative and sustained means the fleet is losing efficiency, "
         "before any absolute SLO trips.")
_declare("obs/hbm_headroom_slope", "gauge",
         "Fleet-worst least-squares slope of the live HBM headroom in "
         "bytes per second over the historian's trend window — a negative "
         "slope projects exhaustion (headroom / -slope seconds out), the "
         "evidence behind the autopilot's pre-OOM resize rule.")
_declare("obs/dcn_comm_share", "gauge",
         "Fleet-worst share of the step wall spent in cross-slice DCN "
         "device seconds (windowed mean device_comm_dcn_s_per_step over "
         "windowed mean step_dt_p50) — the number the hierarchical "
         "two-level decomposition exists to shrink; sustained dominance "
         "triggers the autopilot's compression-escalation hint.")


# -- fleet autopilot (declared with the JAX package's kinds; the port's
# -- autopilot comes with the fleet and control plane) --
_declare("autopilot/snapshots", "counter",
         "Fleet snapshots the autopilot's policy engine evaluated.")
_declare("autopilot/stale_snapshots", "counter",
         "Fleet snapshots the policy engine REFUSED to decide on because "
         "they were older than BAGUA_AUTOPILOT_STALENESS_S — a wedged "
         "snapshot writer must not cause actions from stale evidence.")
_declare("autopilot/decisions", "counter",
         "Actions the pure decision core emitted (observe AND act mode — "
         "a decision is counted whether or not it actuates).")
_declare("autopilot/actions_actuated", "counter",
         "Decided actions actually actuated (act mode only).")
_declare("autopilot/observed_only", "counter",
         "Decided actions logged without actuation (observe mode — the "
         "dry-run rollout counter).")
_declare("autopilot/suppressed_cooldown", "counter",
         "Rule firings suppressed because their action kind was inside "
         "its cooldown window.")
_declare("autopilot/suppressed_budget", "counter",
         "Rule firings suppressed because the global action budget "
         "(BAGUA_AUTOPILOT_BUDGET) was exhausted.")
_declare("autopilot/fences", "counter",
         "Chronic-straggler fence decisions (rank health-fenced, world "
         "resized down through the elastic epoch machinery).")
_declare("autopilot/retunes", "counter",
         "Retune decisions (collective-dominant victims and the ladder's "
         "hint/retune rungs) delivered as autotune perf hints with "
         "service-side re-measure.")
_declare("autopilot/family_switches", "counter",
         "Escalation-ladder algorithm-family-switch decisions (commanded "
         "through the autotune recommendation path; the trainers' switch "
         "is a re-jit, not a restart).")
_declare("autopilot/resizes", "counter",
         "Escalation-ladder terminal resize decisions (worst-goodput "
         "node removed through the fence/epoch machinery).")
_declare("autopilot/compress_hints", "counter",
         "DCN-dominance trend-rule decisions: compression-family "
         "escalation hints (compress the slow cross-slice tier) delivered "
         "through the autotune perf-hint channel.  Fires only from "
         "historian trend windows (BAGUA_OBS_HISTORIAN=on).")
_declare("autopilot/quarantines", "counter",
         "Checkpoint storage paths quarantined after repeated integrity "
         "failures/fallback restores (saves redirect).")
_declare("autopilot/escalation_rung", "gauge",
         "Current SLO-escalation ladder rung (0 = healthy, 1 hint, "
         "2 retune, 3 family switch, 4 resize).")
_declare("autopilot/state_persists", "counter",
         "Policy-state snapshots persisted to the restart store (the "
         "coordinator-restart idempotence channel: cooldowns, rung, "
         "quarantined paths survive a relaunch).")
# -- serving plane --
_declare("serve/requests_admitted", "counter",
         "Requests admitted from the queue into an engine batch slot "
         "(continuous batching: admission happens mid-batch, every tick).")
_declare("serve/requests_completed", "counter",
         "Requests that produced their full output and were evicted.")
_declare("serve/requests_preempted", "counter",
         "Slots preempted on page-pool exhaustion (pages reclaimed, the "
         "request re-queued for recompute — the backpressure path).")
_declare("serve/requests_rejected", "counter",
         "Submissions refused at the admission-queue depth cap "
         "(ServeQueueFull).")
_declare("serve/ticks", "counter",
         "Scheduler ticks executed (one batched decode step each, when "
         "any slot is active).")
_declare("serve/prefill_tokens", "counter",
         "Prompt tokens written into the paged KV-cache (teacher-forced "
         "tick feeds + chunked prefill).")
_declare("serve/prefill_chunks", "counter",
         "Chunked-prefill program invocations (BAGUA_SERVE_PREFILL_CHUNK "
         "tokens of one slot per call).")
_declare("serve/decode_tokens", "counter",
         "Output tokens sampled — decode ticks plus the chunked-prefill "
         "call that produces a request's first token.  Counts WORK, not "
         "delivery: a preempted request's recomputed tokens count each "
         "time they are sampled (equals delivered output tokens only "
         "when serve/requests_preempted is 0).")
_declare("serve/pool_exhausted", "counter",
         "Page-allocation attempts that found the pool empty (each one "
         "queues or preempts — never crashes).")
_declare("serve/weight_loads", "counter",
         "Integrity-verified serving weight loads "
         "(serve.loader.load_serving_params).")
_declare("serve/queue_depth", "gauge",
         "Requests currently waiting in the admission queue.")
_declare("serve/active_slots", "gauge",
         "Batch slots currently running a request.")
_declare("serve/pages_in_use", "gauge",
         "KV-cache pages currently allocated (excludes the 2 reserved "
         "pages).")
_declare("serve/ttft_last_s", "gauge",
         "Time-to-first-token of the most recently started request "
         "(submit -> first sampled token); percentiles live in "
         "the engine's requests.")
_declare("serve/tpot_last_s", "gauge",
         "Time-per-output-token of the most recently completed request "
         "(after its first token).")


def is_registered(name: str) -> bool:
    return name in METRIC_REGISTRY


def render_metrics_md() -> str:
    """The ``docs/torch/metrics.md`` reference table, emitted straight from
    :data:`METRIC_REGISTRY` (``scripts/torch_gen_env_docs.py`` writes and
    checks it beside the env-var table; the JAX package's
    ``render_metrics_md``)."""
    lines = [
        "# Metrics (bagua_tpu_torch)",
        "",
        "Generated by `scripts/torch_gen_env_docs.py` from "
        "`bagua_tpu_torch.obs.export.METRIC_REGISTRY` — do not edit by hand.",
        "",
        "Every counter and gauge the port emits is declared in the registry;",
        "the port's lint rule `unregistered-counter` flags any",
        "`counters.incr`/`set_gauge` call site whose name is not declared",
        "here.  Names export to Prometheus as `bagua_<name>` with `/` and `.`",
        "mangled to `_` (see `prometheus_name`).",
        "",
        "| Metric | Kind | Description |",
        "| --- | --- | --- |",
    ]
    for name in sorted(METRIC_REGISTRY):
        m = METRIC_REGISTRY[name]
        doc = " ".join(m.doc.split())
        lines.append(f"| `{name}` | {m.kind} | {doc} |")
    return "\n".join(lines) + "\n"


def any_registered_matches(pattern: str) -> bool:
    """Whether some registered name fully matches ``pattern`` (a regex):
    how a test validates an f-string call site like
    ``f"faults/{point}/fired"``."""
    rx = re.compile(pattern)
    return any(rx.fullmatch(name) for name in METRIC_REGISTRY)


# ---- per-rank obs summary (the fleet view's worker half) ------------------

_SUMMARY_LOCK = threading.Lock()
_STEP_DTS: deque = deque(maxlen=64)
_LAST_STEP: Optional[int] = None
_LAST_STEP_METRICS: Dict[str, Any] = {}
_LAST_ANOMALY: Optional[Dict[str, Any]] = None
_LAST_DEVICE_ATTRIBUTION: Optional[Dict[str, Any]] = None
_LAST_MFU: Optional[Dict[str, Any]] = None
_LAST_HBM_FOOTPRINT: Optional[Dict[str, Any]] = None
_LAST_HBM_LIVE: Optional[Dict[str, Any]] = None
_LAST_CKPT_DIRECTORY: Optional[str] = None


def note_step(step: int, step_dt: Optional[float]) -> None:
    """Trainer hook (host side, once per step): the latest step number and
    measured host step cadence, feeding the percentile summary."""
    global _LAST_STEP
    with _SUMMARY_LOCK:
        _LAST_STEP = int(step)
        if step_dt is not None and step_dt > 0:
            _STEP_DTS.append(float(step_dt))


def note_step_metrics(metrics: Dict[str, Any]) -> None:
    """Host-safe (already-read-back) step metrics — e.g. the grad guard's
    one-step-behind verdict.  Values must be plain Python numbers: the
    flight recorder re-publishes them from paths where touching a device
    array could hang forever."""
    with _SUMMARY_LOCK:
        _LAST_STEP_METRICS.update(metrics)


def last_step_metrics() -> Dict[str, Any]:
    with _SUMMARY_LOCK:
        return dict(_LAST_STEP_METRICS)


def note_anomaly(suspect: Dict[str, Any]) -> None:
    """The anomaly detector's fleet-view hook: the latest
    ``straggler_suspect`` rides the per-rank obs summary (beacon →
    heartbeat → coordinator snapshot)."""
    global _LAST_ANOMALY
    with _SUMMARY_LOCK:
        _LAST_ANOMALY = dict(suspect)


def note_device_attribution(record: Dict[str, Any]) -> None:
    """Publish a device-time attribution record
    (:func:`.attribution.attribute_device_comm`): summary gauges for the
    exporter, the full record for the obs summary.  An unavailable record
    is kept too — null-with-rationale beats silence."""
    global _LAST_DEVICE_ATTRIBUTION
    with _SUMMARY_LOCK:
        _LAST_DEVICE_ATTRIBUTION = dict(record)
    if record.get("available"):
        if record.get("comm_s_per_step") is not None:
            counters.set_gauge("obs/device_comm_s_per_step",
                               float(record["comm_s_per_step"]))
        if record.get("overlap_fraction") is not None:
            counters.set_gauge("obs/device_overlap_fraction",
                               float(record["overlap_fraction"]))
        # per-tier breakdown (hierarchical two-level schedules only): the
        # DCN gauge is the slow-link cost the decomposition shrinks
        if record.get("comm_ici_s_per_step") is not None:
            counters.set_gauge("obs/device_comm_ici_s_per_step",
                               float(record["comm_ici_s_per_step"]))
        if record.get("comm_dcn_s_per_step") is not None:
            counters.set_gauge("obs/device_comm_dcn_s_per_step",
                               float(record["comm_dcn_s_per_step"]))


def last_device_attribution() -> Optional[Dict[str, Any]]:
    with _SUMMARY_LOCK:
        return (dict(_LAST_DEVICE_ATTRIBUTION)
                if _LAST_DEVICE_ATTRIBUTION is not None else None)


def note_mfu(record: Dict[str, Any]) -> None:
    """Publish the trainer's per-step MFU record: the ``obs/mfu`` gauge
    when available, the null-with-rationale record either way (the fleet
    view shows WHY a rank has no MFU column)."""
    global _LAST_MFU
    with _SUMMARY_LOCK:
        _LAST_MFU = dict(record)
    if record.get("available") and record.get("mfu") is not None:
        counters.set_gauge("obs/mfu", float(record["mfu"]))


def last_mfu() -> Optional[Dict[str, Any]]:
    with _SUMMARY_LOCK:
        return dict(_LAST_MFU) if _LAST_MFU is not None else None


def note_hbm_footprint(record: Dict[str, Any]) -> None:
    """Publish the one-shot static HBM footprint
    (:func:`.memory.static_footprint`): summary record + the
    ``obs/hbm_static_footprint_bytes`` gauge."""
    global _LAST_HBM_FOOTPRINT
    with _SUMMARY_LOCK:
        _LAST_HBM_FOOTPRINT = dict(record)
    if record.get("total_bytes") is not None:
        counters.set_gauge("obs/hbm_static_footprint_bytes",
                           int(record["total_bytes"]))


def last_hbm_footprint() -> Optional[Dict[str, Any]]:
    with _SUMMARY_LOCK:
        return (dict(_LAST_HBM_FOOTPRINT)
                if _LAST_HBM_FOOTPRINT is not None else None)


def note_hbm_live(record: Dict[str, Any]) -> None:
    """Publish a live ``torch.cuda.memory_stats()`` poll
    (:func:`.memory.live_memory_stats`): peak/headroom gauges
    when available, the rationale record either way."""
    global _LAST_HBM_LIVE
    with _SUMMARY_LOCK:
        _LAST_HBM_LIVE = dict(record)
    if record.get("available"):
        if record.get("peak_bytes_in_use") is not None:
            counters.set_gauge("obs/hbm_peak_bytes",
                               int(record["peak_bytes_in_use"]))
        if record.get("headroom_bytes") is not None:
            counters.set_gauge("obs/hbm_headroom_bytes",
                               int(record["headroom_bytes"]))


def last_hbm_live() -> Optional[Dict[str, Any]]:
    with _SUMMARY_LOCK:
        return dict(_LAST_HBM_LIVE) if _LAST_HBM_LIVE is not None else None


def note_ckpt_directory(directory: str) -> None:
    """Checkpoint-manager hook: the storage path this rank saves to rides
    the obs summary, so the coordinator-side autopilot can name WHICH path
    to quarantine when the rank's integrity counters climb."""
    global _LAST_CKPT_DIRECTORY
    with _SUMMARY_LOCK:
        _LAST_CKPT_DIRECTORY = str(directory)


def _percentile(sorted_vals: List[float], q: float) -> float:
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def local_obs_summary() -> Optional[dict]:
    """This process's per-rank fleet-view summary: step, step-dt
    percentiles, staleness gauge, skip counts.  None before the trainer
    noted any step (launcher processes, pure-eval jobs) — the beacon then
    carries no obs payload."""
    with _SUMMARY_LOCK:
        step = _LAST_STEP
        dts = sorted(_STEP_DTS)
        anomaly = dict(_LAST_ANOMALY) if _LAST_ANOMALY else None
        attribution = (dict(_LAST_DEVICE_ATTRIBUTION)
                       if _LAST_DEVICE_ATTRIBUTION else None)
        mfu = dict(_LAST_MFU) if _LAST_MFU else None
        footprint = dict(_LAST_HBM_FOOTPRINT) if _LAST_HBM_FOOTPRINT else None
        hbm_live = dict(_LAST_HBM_LIVE) if _LAST_HBM_LIVE else None
        ckpt_dir = _LAST_CKPT_DIRECTORY
    if step is None:
        return None
    summary = {
        "rank": int(_env.get_rank()),
        "step": step,
        "staleness": counters.get("async/staleness_max"),
        "skipped_steps": counters.get("grad_guard/skipped_steps"),
    }
    # checkpoint-integrity evidence for the autopilot's quarantine rule:
    # how often this rank's restores failed verification / fell back, and
    # which storage path its manager writes (None of it costs bytes while
    # the chain is clean and no manager exists)
    ckpt_failures = counters.get("ckpt/integrity_failures")
    ckpt_fallbacks = counters.get("ckpt/fallback_restores")
    if ckpt_failures:
        summary["ckpt_integrity_failures"] = ckpt_failures
    if ckpt_fallbacks:
        summary["ckpt_fallback_restores"] = ckpt_fallbacks
    if ckpt_dir and (ckpt_failures or ckpt_fallbacks):
        summary["ckpt_directory"] = ckpt_dir
    if dts:
        summary["step_dt_p50"] = round(_percentile(dts, 0.5), 6)
        summary["step_dt_p90"] = round(_percentile(dts, 0.9), 6)
    if anomaly:
        # the fleet's straggler question, answered per rank: latest flagged
        # step, how slow, and which phase dominated the excess
        summary["straggler_suspect"] = anomaly
    if attribution:
        if attribution.get("available"):
            summary["device_comm_s_per_step"] = attribution.get(
                "comm_s_per_step")
            summary["device_overlap_fraction"] = attribution.get(
                "overlap_fraction")
            if attribution.get("comm_dcn_s_per_step") is not None:
                # per-tier split of the comm seconds (two-level schedules):
                # the coordinator's fleet view can see DCN seconds move out
                # of the step when the hierarchical path lands
                summary["device_comm_ici_s_per_step"] = attribution.get(
                    "comm_ici_s_per_step")
                summary["device_comm_dcn_s_per_step"] = attribution.get(
                    "comm_dcn_s_per_step")
        else:
            # null-with-rationale, like trace_overlap's bench records
            summary["device_comm_s_per_step"] = None
            summary["device_attribution_rationale"] = attribution.get(
                "rationale")
    # efficiency plane: goodput fraction + badput breakdown (the fleet
    # rollup names each rank's worst badput class from these), MFU, and the
    # HBM footprint/headroom — all host-side accounting
    ledger_report = _ledger().report()
    if ledger_report is not None:
        from .ledger import BADPUT_CLASSES  # lazy: ledger imports from us

        summary["goodput_fraction"] = ledger_report["goodput_fraction"]
        summary["badput"] = {
            cls: round(s, 3)
            for cls, s in ledger_report["classes"].items()
            if cls in BADPUT_CLASSES and s > 0
        }
        summary["worst_badput_class"] = ledger_report["worst_badput_class"]
    if mfu:
        if mfu.get("available"):
            summary["mfu"] = mfu.get("mfu")
        else:
            summary["mfu"] = None
            summary["mfu_rationale"] = mfu.get("rationale")
    if footprint:
        summary["hbm_static_footprint_bytes"] = footprint.get("total_bytes")
    if hbm_live:
        if hbm_live.get("available"):
            summary["hbm_peak_bytes"] = hbm_live.get("peak_bytes_in_use")
            summary["hbm_headroom_bytes"] = hbm_live.get("headroom_bytes")
        else:
            summary["hbm_live_rationale"] = hbm_live.get("rationale")
    return summary


def reset_local_summary() -> None:
    """Forget the per-rank summary (test isolation)."""
    global _LAST_STEP, _LAST_ANOMALY, _LAST_DEVICE_ATTRIBUTION
    global _LAST_MFU, _LAST_HBM_FOOTPRINT, _LAST_HBM_LIVE
    global _LAST_CKPT_DIRECTORY
    with _SUMMARY_LOCK:
        _LAST_STEP = None
        _STEP_DTS.clear()
        _LAST_STEP_METRICS.clear()
        _LAST_ANOMALY = None
        _LAST_DEVICE_ATTRIBUTION = None
        _LAST_MFU = None
        _LAST_HBM_FOOTPRINT = None
        _LAST_HBM_LIVE = None
        _LAST_CKPT_DIRECTORY = None


# ---- Prometheus / JSONL rendering -----------------------------------------

_PROM_NAME = re.compile(r"[^a-zA-Z0-9_]")


def prometheus_name(name: str) -> str:
    """``faults/grad.poison/fired`` -> ``bagua_faults_grad_poison_fired``."""
    return "bagua_" + _PROM_NAME.sub("_", name)


def render_prometheus(snapshot: Dict[str, Any]) -> str:
    """Prometheus textfile exposition of a counters snapshot — HELP/TYPE
    from the registry; unregistered names (should not exist once the lint
    rule holds) export as untyped with a marker comment."""
    lines: List[str] = []
    for name in sorted(snapshot):
        value = snapshot[name]
        pname = prometheus_name(name)
        metric = METRIC_REGISTRY.get(name)
        if metric is not None:
            lines.append(f"# HELP {pname} {' '.join(metric.doc.split())}")
            lines.append(f"# TYPE {pname} {metric.kind}")
        else:
            lines.append(f"# HELP {pname} (unregistered metric name)")
            lines.append(f"# TYPE {pname} untyped")
        lines.append(f"{pname} {value}")
    return "\n".join(lines) + "\n"


def prepared_snapshot():
    """The ONE counters snapshot both Prometheus surfaces render: the
    exporter's ``metrics.prom`` file and the HTTP plane's ``/metrics``
    endpoint (the JAX package's ``obs/http.py``).  Refreshes the derived gauges
    first — ring drop pressure (a truncated timeline must read as
    truncated, not as a quiet run) and the goodput ledger's cumulative
    class/goodput gauges — so a live scrape and the on-disk file always
    expose the same series set."""
    from . import spans as _spans

    counters.set_gauge("obs/spans_dropped", _spans.recorder.dropped)
    _ledger().publish_gauges(counters)
    return counters.snapshot()


def _maybe_rotate(path: str) -> None:
    """Size-capped rotation for the append-only ``metrics.jsonl``: once the
    file reaches ``BAGUA_OBS_EXPORT_MAX_BYTES`` it moves to ``<path>.1``
    (replacing the previous rotation) and a fresh file starts — a long run
    can no longer grow the export unboundedly, and readers (the ledger CLI)
    still see up to two generations of history."""
    max_bytes = _env.get_obs_export_max_bytes()
    if max_bytes <= 0:
        return
    try:
        if os.path.getsize(path) >= max_bytes:
            os.replace(path, path + ".1")
    except OSError:
        pass  # no file yet, or a racing rotation — the append creates it


def _atomic_write(path: str, text: str) -> None:
    # pid AND thread in the temp name: the flight recorder writes from
    # whichever thread hit the defense path (watchdog monitor, SIGTERM
    # helper, main), and two threads sharing one temp file would truncate
    # each other's in-progress write before the replace
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


class MetricsExporter:
    """Background thread (the analog of the reference's Flask sidecar):
    every ``interval_s``, snapshot the telemetry counters + the per-rank
    obs summary + the latest host-safe step metrics, append one JSON line
    to ``<directory>/metrics.jsonl``, and atomically rewrite
    ``<directory>/metrics.prom``.

    One counter-lock acquisition per snapshot (``counters.snapshot()``) —
    never one per metric — and one batched self-increment
    (``counters.incr_many``)."""

    def __init__(self, directory: str, interval_s: Optional[float] = None,
                 trainer: Optional[Any] = None):
        self.directory = str(directory)
        self.interval_s = float(
            _env.get_obs_export_interval_s() if interval_s is None
            else interval_s
        )
        self._trainer = weakref.ref(trainer) if trainer is not None else None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="bagua-obs-exporter", daemon=True
        )

    def attach_trainer(self, trainer: Any) -> None:
        self._trainer = weakref.ref(trainer)

    def start(self) -> "MetricsExporter":
        os.makedirs(self.directory, exist_ok=True)
        self._thread.start()
        return self

    def export_once(self) -> dict:
        """One snapshot (also the thread's body): returns the JSONL record
        for tests/round-trips."""
        snap = prepared_snapshot()
        record: Dict[str, Any] = {
            "time_unix": time.time(),
            "collected_at": snap.collected_at,
            "rank": int(_env.get_rank()),
            "counters": dict(snap),
        }
        summary = local_obs_summary()
        if summary:
            record["obs"] = summary
        metrics = last_step_metrics()
        if metrics:
            record["step_metrics"] = metrics
        attribution = last_device_attribution()
        if attribution:
            record["device_attribution"] = attribution
        trainer = self._trainer() if self._trainer is not None else None
        if trainer is not None:
            dt = getattr(trainer, "measured_step_dt", None)
            if callable(dt):
                record["measured_step_dt"] = dt()
        jsonl = os.path.join(self.directory, "metrics.jsonl")
        _maybe_rotate(jsonl)
        with open(jsonl, "a") as f:
            f.write(json.dumps(record) + "\n")
        _atomic_write(os.path.join(self.directory, "metrics.prom"),
                      render_prometheus(snap))
        counters.incr_many({"obs/export_snapshots": 1})
        return record

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.export_once()
            except Exception as e:  # noqa: BLE001 - export must not kill
                logger.warning("metrics export failed: %s", e)

    def stop(self, final_export: bool = True) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        if final_export:
            try:
                self.export_once()
            except Exception as e:  # noqa: BLE001
                logger.debug("final metrics export failed: %s", e)


_GLOBAL_EXPORTER: Optional[MetricsExporter] = None
_GLOBAL_EXPORTER_LOCK = threading.Lock()


def maybe_start_global_exporter(trainer: Optional[Any] = None
                                ) -> Optional[MetricsExporter]:
    """Process-wide exporter, started once when ``BAGUA_OBS_EXPORT_DIR`` is
    set (one thread no matter how many trainers — the global-watchdog
    pattern); later trainers re-attach so the freshest one's step metrics
    export."""
    directory = _env.get_obs_export_dir()
    if not directory:
        return None
    global _GLOBAL_EXPORTER
    with _GLOBAL_EXPORTER_LOCK:
        if _GLOBAL_EXPORTER is None:
            _GLOBAL_EXPORTER = MetricsExporter(
                directory, trainer=trainer
            ).start()
            atexit.register(_GLOBAL_EXPORTER.stop)
        elif trainer is not None:
            _GLOBAL_EXPORTER.attach_trainer(trainer)
        return _GLOBAL_EXPORTER


# ---- fleet snapshot (coordinator side) ------------------------------------

FLEET_SCHEMA = "bagua-obs-fleet-v1"


def _fleet_efficiency(ranks: Dict[str, dict]) -> dict:
    """The fleet-level efficiency rollup from merged per-rank obs
    summaries: mean/min goodput fraction, and per rank the goodput plus its
    worst (dominant) badput class.  Empty ``ranks`` sub-dict when no member
    reported a ledger yet (launcher-only fleets, pre-first-step)."""
    per_rank: Dict[str, dict] = {}
    fractions: List[float] = []
    for entry in ranks.values():
        for rank_id, obs in (entry.get("obs") or {}).items():
            if not isinstance(obs, dict):
                continue
            gf = obs.get("goodput_fraction")
            if gf is None:
                continue
            fractions.append(float(gf))
            per_rank[str(rank_id)] = {
                "goodput_fraction": gf,
                "worst_badput_class": obs.get("worst_badput_class"),
            }
    out: dict = {"ranks": per_rank}
    if fractions:
        out["goodput_fraction_mean"] = round(
            sum(fractions) / len(fractions), 6)
        out["goodput_fraction_min"] = round(min(fractions), 6)
    return out


def build_fleet_record(epoch: int,
                       members: Dict[int, Optional[dict]]) -> dict:
    """Merge every member's latest heartbeat health payload
    (``LeaseTracker.health_of``) into one ``bagua-obs-fleet-v1`` record —
    per node: the fence-relevant health events plus the per-rank ``obs``
    summaries its launcher merged from the workers' beacons.  The ONE
    merge both the snapshot file and the autopilot's policy engine
    consume."""
    ranks: Dict[str, dict] = {}
    for node_id, payload in members.items():
        payload = payload or {}
        obs = payload.get("obs") or {}
        if "step" in obs:
            # a single-rank summary (the in-process heartbeat default
            # source) normalizes to the launcher's per-rank shape
            obs = {str(obs.get("rank", 0)): obs}
        ranks[str(int(node_id))] = {
            "health": {k: v for k, v in payload.items() if k != "obs"},
            "obs": obs,
        }
    return {
        "schema": FLEET_SCHEMA,
        "time_unix": time.time(),
        "epoch": int(epoch),
        "nnodes": len(members),
        "ranks": ranks,
        # efficiency rollup: aggregate goodput + each rank's worst
        # badput class, lifted from the per-rank summaries above — the
        # fleet-level answer to "where is the fleet's wall-clock going"
        "efficiency": _fleet_efficiency(ranks),
    }


def write_fleet_snapshot(path: str, epoch: int,
                         members: Optional[Dict[int, Optional[dict]]] = None,
                         record: Optional[dict] = None) -> bool:
    """Write the coordinator-side fleet snapshot atomically — from
    ``members`` (merged here) or a pre-built ``record``.  Exception-free
    (the caller is the launcher's monitor loop)."""
    try:
        if record is None:
            record = build_fleet_record(epoch, members or {})
        _atomic_write(str(path), json.dumps(record, indent=1, sort_keys=True))
        return True
    except OSError as e:
        logger.debug("fleet snapshot not written: %s", e)
        return False


def validate_fleet_snapshot(record: dict) -> List[str]:
    """Schema problems with a fleet snapshot ([] = valid) — the drill/test
    gate."""
    problems: List[str] = []
    if record.get("schema") != FLEET_SCHEMA:
        problems.append(f"schema != {FLEET_SCHEMA}")
    for key, typ in (("time_unix", (int, float)), ("epoch", int),
                     ("nnodes", int), ("ranks", dict)):
        if not isinstance(record.get(key), typ):
            problems.append(f"missing/mistyped {key}")
    for nid, entry in (record.get("ranks") or {}).items():
        if not isinstance(entry, dict) or "health" not in entry \
                or "obs" not in entry:
            problems.append(f"rank {nid}: missing health/obs")
    eff = record.get("efficiency")
    if not isinstance(eff, dict) or not isinstance(eff.get("ranks"), dict):
        problems.append("missing/mistyped efficiency rollup")
    else:
        for rid, entry in eff["ranks"].items():
            if "goodput_fraction" not in entry:
                problems.append(f"efficiency.ranks[{rid}] missing "
                                "goodput_fraction")
    return problems
