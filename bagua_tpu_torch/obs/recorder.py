"""Crash flight recorder: every failure mode leaves a post-mortem artifact.

Port of ``bagua_tpu/obs/recorder.py``.  When a defense path fires —
watchdog abort, grad-guard abort or skip-budget escalation, health-fence
stop, an armed fault firing, a fatal signal — this module atomically dumps
the last-N spans, a counters snapshot, and the latest host-safe step
metrics to a rank-tagged JSON under ``BAGUA_OBS_DUMP_DIR``.

Contracts:

* **Never raises, never blocks on the device.**  Callers are abort paths
  (the watchdog is about to ``os._exit``; the process may be wedged), so
  the dump reads only host state — the span ring, the counters, step
  metrics that were ALREADY read back (``export.note_step_metrics``).
* **Deterministic trigger-keyed filenames** (one file per trigger × rank ×
  pid, overwritten atomically).
* **Worker-counter flush**: abort-class dumps also flush this process's
  counters to ``<BAGUA_ELASTIC_TELEMETRY_OUT>.rank<r>.json``.
* **Import-light** (no torch): the watchdog waiter and the launcher call in.
"""

from __future__ import annotations

import json
import logging
import os
import re
import signal
import socket
import threading
import time
from typing import Any, Dict, List, Optional

from .. import env as _env
from ..telemetry import counters
from . import export as _export
from . import spans as _spans

logger = logging.getLogger(__name__)

__all__ = ["dump_flight_record", "note_fault_fire", "validate_flight_record",
           "maybe_install_signal_hook", "FLIGHT_SCHEMA"]

FLIGHT_SCHEMA = "bagua-obs-flight-v1"

#: triggers the recorder knows about (documentation + schema validation;
#: unknown triggers still dump — a new defense path must not lose its
#: artifact to an enum)
KNOWN_TRIGGERS = ("watchdog_abort", "grad_guard_abort", "health_fence",
                  "fault_fire", "signal", "step_anomaly",
                  "autopilot_action")

_SAFE = re.compile(r"[^A-Za-z0-9_.-]")
_DUMP_LOCK = threading.Lock()


def _armed_fault_summaries() -> List[dict]:
    from ..faults import inject as _inject

    plan = _inject.get_plan()
    if plan is None:
        return []
    return [
        {"point": s.point, "kind": s.kind, "step": s.step, "op": s.op,
         "count": s.count, "seed": s.seed}
        for s in plan.specs
    ]


def _ledger_report() -> Optional[dict]:
    try:
        from .ledger import ledger

        return ledger.report()
    except Exception:  # noqa: BLE001 - a dying process must still die
        return None


def _fired_fault_counts(snap: Dict[str, Any]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for name, value in snap.items():
        if name.startswith("faults/") and name.endswith("/fired") and value:
            out[name[len("faults/"):-len("/fired")]] = int(value)
    return out


def _flush_elastic_counters(snap, trigger: str) -> None:
    """On abort-class exits, this process's counters
    reach ``BAGUA_ELASTIC_TELEMETRY_OUT`` too — rank-suffixed, so a worker
    flush never clobbers the launcher's own ``{counters, transitions}``
    dump."""
    out = _env.get_elastic_telemetry_out()
    if not out:
        return
    path = f"{out}.rank{int(_env.get_rank())}.json"
    _export._atomic_write(path, json.dumps(
        {"trigger": trigger, "counters": dict(snap),
         "time_unix": time.time()}, indent=1))


def dump_flight_record(trigger: str, reason: str = "",
                       fault_point: Optional[str] = None,
                       extra: Optional[dict] = None) -> Optional[str]:
    """Write the post-mortem dump; returns its path (None when no dump dir
    is configured and no elastic-telemetry flush applies, or the plane is
    off).  Exception-free by contract."""
    try:
        if not _spans.enabled():
            return None
        dump_dir = _env.get_obs_dump_dir()
        snap = counters.snapshot()
        try:
            _flush_elastic_counters(snap, trigger)
        except OSError as e:
            logger.debug("elastic counter flush failed: %s", e)
        if not dump_dir:
            return None
        record: Dict[str, Any] = {
            "schema": FLIGHT_SCHEMA,
            "trigger": trigger,
            "reason": reason,
            "fault_point": fault_point,
            "rank": int(_env.get_rank()),
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "time_unix": time.time(),
            "spans": _spans.recorder.snapshot(),
            # sections still IN FLIGHT at dump time — a wedged collective's
            # watched section never exits, so this list is the headline of
            # a hang post-mortem
            "active_spans": _spans.recorder.active_snapshot(),
            "spans_dropped": _spans.recorder.dropped,
            "counters": dict(snap),
            "counters_collected_at": snap.collected_at,
            "step_metrics": _export.last_step_metrics(),
            "obs_summary": _export.local_obs_summary(),
            "armed_faults": _armed_fault_summaries(),
            "fired_faults": _fired_fault_counts(snap),
            # goodput ledger at the moment the defense tripped: "the run
            # died having spent N s in class X" is post-mortem headline
            # material (None before any step window was noted)
            "ledger": _ledger_report(),
        }
        if extra:
            record["extra"] = extra
        name = "flight_{}_rank{}_pid{}.json".format(
            _SAFE.sub("_", trigger)
            + (("_" + _SAFE.sub("_", fault_point)) if fault_point else ""),
            record["rank"], os.getpid(),
        )
        path = os.path.join(dump_dir, name)
        with _DUMP_LOCK:
            os.makedirs(dump_dir, exist_ok=True)
            _export._atomic_write(
                path, json.dumps(record, indent=1, sort_keys=True)
            )
            _prune_dumps(dump_dir, keep=path)
        counters.incr_many({"obs/flight_dumps": 1})
        logger.warning("flight recorder: %s dump written to %s", trigger,
                       path)
        return path
    except Exception as e:  # noqa: BLE001 - a dying process must still die
        logger.warning("flight recorder dump failed: %s", e)
        return None


def _prune_dumps(dump_dir: str, keep: str) -> None:
    """Retention cap for the dump directory (``BAGUA_OBS_DUMP_MAX_FILES``,
    0 = unbounded): dumps are overwritten per (trigger, fault point,
    rank, pid), so growth comes from restarts minting fresh pids — a long
    run with recurring throttled faults used to accumulate dumps without
    limit.  Oldest-first by mtime, never the file just written; pruned
    count lands in ``obs/flight_dumps_pruned``.  Caller holds
    ``_DUMP_LOCK``; only ``flight_*.json`` files are candidates (span-ring
    ``spans_*.json`` dumps live in the same directory and are not ours to
    reap)."""
    max_files = _env.get_obs_dump_max_files()
    if max_files <= 0:
        return
    try:
        entries = []
        with os.scandir(dump_dir) as it:
            for entry in it:
                if not entry.name.startswith("flight_") \
                        or not entry.name.endswith(".json"):
                    continue
                try:
                    entries.append((entry.stat().st_mtime, entry.path))
                except OSError:
                    continue  # vanished between scandir and stat
        excess = len(entries) - max_files
        if excess <= 0:
            return
        pruned = 0
        keep = os.path.abspath(keep)
        for _, victim in sorted(entries):
            if pruned >= excess:
                break
            if os.path.abspath(victim) == keep:
                continue
            try:
                os.unlink(victim)
                pruned += 1
            except OSError:
                continue
        if pruned:
            counters.incr_many({"obs/flight_dumps_pruned": pruned})
            logger.info("flight recorder: pruned %d dump(s) over the "
                        "%d-file retention cap", pruned, max_files)
    except OSError as e:  # pragma: no cover - directory-level races
        logger.debug("flight dump pruning skipped: %s", e)


_LAST_FIRE_DUMP: Dict[str, float] = {}
_FIRE_DUMP_MIN_INTERVAL_S = 2.0


def note_fault_fire(point: str, kind: str) -> None:
    """Hook for :mod:`..faults.inject`: an armed-fault fire leaves
    (or refreshes) a dump naming the firing point, so every chaos-drill
    failure mode has its artifact even when the defense path dies before
    its own dump.  Cheap no-op unless a dump dir or elastic telemetry out
    is configured.  A point's FIRST fire always dumps; repeat fires
    (``count=-1`` specs like ``step.straggle`` fire once per step, inside
    legs whose throughput the drills measure) refresh the file at most
    every ~2 s — the dump is overwritten per (trigger, point, rank, pid)
    anyway, so a repeat fire only buys a fresher snapshot."""
    if not (_env.get_obs_dump_dir() or _env.get_elastic_telemetry_out()):
        return
    now = time.monotonic()
    last = _LAST_FIRE_DUMP.get(point)
    if last is not None and now - last < _FIRE_DUMP_MIN_INTERVAL_S:
        return
    _LAST_FIRE_DUMP[point] = now
    dump_flight_record("fault_fire", reason=f"{point}:{kind} fired",
                       fault_point=point)


def validate_flight_record(record: dict) -> List[str]:
    """Schema problems with a flight dump ([] = valid) — shared by the
    chaos drills, the CI smoke trace, and the bench-sanity gate."""
    problems: List[str] = []
    if record.get("schema") != FLIGHT_SCHEMA:
        problems.append(f"schema != {FLIGHT_SCHEMA}")
    if not record.get("trigger"):
        problems.append("missing trigger")
    for key, typ in (("rank", int), ("pid", int), ("time_unix", (int, float)),
                     ("spans", list), ("active_spans", list),
                     ("spans_dropped", int),
                     ("counters", dict), ("step_metrics", dict),
                     ("armed_faults", list), ("fired_faults", dict)):
        if not isinstance(record.get(key), typ):
            problems.append(f"missing/mistyped {key}")
    for i, span in enumerate(record.get("spans") or []):
        for key in ("name", "t0", "t1", "dur_s", "rank", "depth"):
            if key not in span:
                problems.append(f"span[{i}] missing {key}")
                break
    if record.get("trigger") == "fault_fire" and not record.get("fault_point"):
        problems.append("fault_fire dump without fault_point")
    return problems


_SIGNAL_HOOKED = False


def maybe_install_signal_hook() -> bool:
    """Chain a SIGTERM handler that dumps a ``signal`` flight record before
    the previous disposition runs — the launcher's ``kill_gang`` SIGTERM is
    how fenced/stopped workers die, and their counters would otherwise
    vanish.  Main-thread only (signal module restriction); installed once
    per process, only while a dump dir is configured."""
    global _SIGNAL_HOOKED
    if _SIGNAL_HOOKED or not _env.get_obs_dump_dir():
        return False
    if threading.current_thread() is not threading.main_thread():
        return False
    try:
        prev = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            # The handler interrupts the main thread mid-bytecode — it may
            # already hold the counters lock, the span-ring lock, or
            # _DUMP_LOCK, all non-reentrant.  Dump from a helper thread and
            # give up after a bounded join: in that (rare) race we lose the
            # dump, never the exit — a dying process must still die.
            t = threading.Thread(
                target=dump_flight_record, args=("signal",),
                kwargs={"reason": "SIGTERM"},
                name="bagua-obs-sigterm-dump", daemon=True,
            )
            t.start()
            t.join(timeout=5)
            if prev is signal.SIG_IGN:
                return  # the process was configured to ignore SIGTERM
            if callable(prev):
                prev(signum, frame)
            else:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, _on_term)
        _SIGNAL_HOOKED = True
        return True
    except (ValueError, OSError) as e:  # pragma: no cover - env-dependent
        logger.debug("signal hook not installed: %s", e)
        return False
