"""Fleet timeline: merge per-rank span dumps into one Perfetto trace.

Port of ``bagua_tpu/obs/timeline.py``.  Rank-tagged span dumps
(flight-recorder JSONs, or live ring snapshots written by
:func:`dump_span_ring`) become a single Chrome-trace / Perfetto JSON —
rank → process, thread → track — that ``chrome://tracing`` or
https://ui.perfetto.dev renders directly.

Spans record ``time.monotonic()``, whose epoch is arbitrary *per process*.
Alignment anchors on the spans that end at a globally synchronized
instant: ``async/negotiate``, ``async/catchup`` and ``elastic/rendezvous``.
For each non-reference rank, every anchor span shared with the reference
rank (same name, same ``step``/``epoch``) yields one offset sample
``ref.t1 - other.t1``; the median is that rank's clock offset.  Ranks with
no shared anchor fall back to aligning their earliest span (flagged
``aligned: false`` in the metadata).

Schema ``bagua-obs-timeline-v1``, the JAX package's: either package's
:func:`validate_timeline` accepts the other's output
(``tests/test_torch_timeline.py``).

CLI::

    python -m bagua_tpu_torch.obs.timeline DUMP_DIR_OR_FILES... \
        [--out timeline.json] [--check] [--no-align]

Import-light (no torch): this is an offline/post-mortem tool.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import statistics
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

__all__ = [
    "TIMELINE_SCHEMA", "ANCHOR_SPAN_NAMES", "assemble_timeline",
    "validate_timeline", "load_rank_records", "dump_span_ring", "main",
]

TIMELINE_SCHEMA = "bagua-obs-timeline-v1"

#: span names whose EXIT is a globally synchronized instant (a blocking
#: cross-rank boundary): every rank leaves together, so matching spans on
#: two ranks pin their monotonic clocks to one another
ANCHOR_SPAN_NAMES = ("async/negotiate", "async/catchup",
                     "elastic/rendezvous")


# ---- input loading --------------------------------------------------------


def _is_rank_record(rec: Any) -> bool:
    return isinstance(rec, dict) and isinstance(rec.get("spans"), list) \
        and "rank" in rec


def load_rank_records(paths: Sequence[str]) -> List[dict]:
    """Read rank span dumps from files and/or directories.

    Accepts flight-recorder dumps (``flight_*.json``) and span-ring dumps
    (:func:`dump_span_ring`, ``spans_*.json``) — anything JSON with
    ``rank`` + ``spans``; directories are scanned for both filename
    patterns.  Unreadable or shape-less files are skipped with a warning
    (a post-mortem tool must salvage what it can)."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for pat in ("flight_*.json", "spans_*.json"):
                files.extend(sorted(glob.glob(os.path.join(p, pat))))
        else:
            files.append(p)
    records = []
    for path in files:
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, ValueError) as e:
            logger.warning("timeline: skipping unreadable %s (%s)", path, e)
            continue
        if not _is_rank_record(rec):
            logger.warning("timeline: %s has no rank/spans — skipped", path)
            continue
        rec.setdefault("_source", os.path.basename(path))
        records.append(rec)
    return records


def dump_span_ring(path: str, rank: Optional[int] = None) -> str:
    """Write this process's live span ring as a timeline-consumable rank
    record (``{"rank", "spans", "active_spans", "spans_dropped"}``) — the
    non-crash way to feed :func:`assemble_timeline`, e.g. at the end of a
    profiling window.  Returns the path written."""
    from .. import env as _env
    from . import export as _export
    from . import ledger as _ledger
    from . import spans as _spans

    record = {
        "rank": int(_env.get_rank()) if rank is None else int(rank),
        "pid": os.getpid(),
        "spans": _spans.recorder.snapshot(),
        "active_spans": _spans.recorder.active_snapshot(),
        "spans_dropped": _spans.recorder.dropped,
        # goodput ledger: the cumulative class history becomes a Perfetto
        # counter track alongside this rank's span track
        "ledger": _ledger.ledger.report(),
        "ledger_samples": _ledger.ledger.samples(),
    }
    _export._atomic_write(path, json.dumps(record, indent=1))
    return path


# ---- clock alignment ------------------------------------------------------


def _anchor_key(span: dict) -> Optional[Tuple]:
    """Identity of a boundary crossing, comparable across ranks: the span
    name plus the step (async boundaries) or epoch (rendezvous rounds)."""
    name = span.get("name")
    if name not in ANCHOR_SPAN_NAMES:
        return None
    attrs = span.get("attrs") or {}
    if name == "elastic/rendezvous":
        marker = attrs.get("epoch")
    else:
        marker = span.get("step")
    if marker is None:
        return None
    return (name, marker)


def _rank_anchors(spans: List[dict]) -> Dict[Tuple, float]:
    """anchor key -> t1 (latest occurrence wins: a re-run boundary — e.g. a
    resumed epoch — supersedes its earlier attempt)."""
    out: Dict[Tuple, float] = {}
    for span in spans:
        key = _anchor_key(span)
        if key is not None and "t1" in span:
            prev = out.get(key)
            if prev is None or span["t1"] > prev:
                out[key] = span["t1"]
    return out


def _clock_offsets(spans_by_rank: Dict[int, List[dict]],
                   align: bool = True) -> Dict[int, dict]:
    """Per-rank ``{"offset_s", "aligned", "anchors"}`` mapping every rank's
    monotonic clock onto the reference (lowest) rank's."""
    ranks = sorted(spans_by_rank)
    ref = ranks[0]
    ref_anchors = _rank_anchors(spans_by_rank[ref]) if align else {}
    out: Dict[int, dict] = {}
    for rank in ranks:
        if rank == ref:
            out[rank] = {"offset_s": 0.0, "aligned": True, "anchors": 0,
                         "reference": True}
            continue
        samples = []
        if align:
            anchors = _rank_anchors(spans_by_rank[rank])
            samples = [ref_anchors[k] - anchors[k]
                       for k in anchors.keys() & ref_anchors.keys()]
        if samples:
            out[rank] = {"offset_s": statistics.median(samples),
                         "aligned": True, "anchors": len(samples)}
        else:
            # no shared boundary span: best effort — line the earliest
            # spans up so the track is at least on screen, and say so
            ref_t0 = min((s["t0"] for s in spans_by_rank[ref]), default=0.0)
            t0 = min((s["t0"] for s in spans_by_rank[rank]), default=0.0)
            out[rank] = {"offset_s": ref_t0 - t0, "aligned": False,
                         "anchors": 0}
    return out


# ---- assembly -------------------------------------------------------------


def _span_identity(span: dict) -> Tuple:
    return (span.get("name"), span.get("t0"), span.get("t1"),
            span.get("thread"), span.get("depth"))


def assemble_timeline(rank_records: Sequence[dict],
                      align: bool = True) -> dict:
    """Merge rank span dumps into one Chrome-trace JSON (object form).

    ``rank_records``: dicts with ``rank`` + ``spans`` (finished spans as
    :mod:`.spans` records them), optionally ``active_spans``
    and ``spans_dropped`` — i.e. flight dumps or :func:`dump_span_ring`
    output.  Multiple records for one rank (several dumps from one run)
    merge; identical spans dedupe.  Raises ``ValueError`` on no spans at
    all — an empty timeline is an operator error, not a trace."""
    spans_by_rank: Dict[int, List[dict]] = {}
    active_by_rank: Dict[int, List[dict]] = {}
    dropped_by_rank: Dict[int, int] = {}
    sources_by_rank: Dict[int, List[str]] = {}
    ledger_by_rank: Dict[int, Dict[float, dict]] = {}
    for rec in rank_records:
        rank = int(rec["rank"])
        for sample in rec.get("ledger_samples") or []:
            if isinstance(sample, dict) and "t" in sample \
                    and isinstance(sample.get("classes"), dict):
                # keyed by t: multiple dumps of one rank dedupe naturally
                ledger_by_rank.setdefault(rank, {})[sample["t"]] = \
                    sample["classes"]
        seen = {_span_identity(s) for s in spans_by_rank.get(rank, [])}
        for span in rec.get("spans") or []:
            if not isinstance(span, dict) or "t0" not in span:
                continue
            if _span_identity(span) in seen:
                continue
            seen.add(_span_identity(span))
            spans_by_rank.setdefault(rank, []).append(span)
        for span in rec.get("active_spans") or []:
            if isinstance(span, dict) and "t0" in span:
                active_by_rank.setdefault(rank, []).append(span)
        dropped_by_rank[rank] = max(dropped_by_rank.get(rank, 0),
                                    int(rec.get("spans_dropped") or 0))
        if rec.get("_source"):
            sources_by_rank.setdefault(rank, []).append(rec["_source"])
        spans_by_rank.setdefault(rank, [])
    spans_by_rank = {r: s for r, s in spans_by_rank.items()
                     if s or active_by_rank.get(r)}
    if not spans_by_rank:
        raise ValueError("no spans in any rank record — nothing to merge "
                         "(were the dumps written with BAGUA_OBS=off?)")

    offsets = _clock_offsets(
        {r: s + active_by_rank.get(r, [])
         for r, s in spans_by_rank.items()}, align=align,
    )
    # one global origin so ts starts near zero (viewers dislike 1e9-second
    # offsets): the earliest ALIGNED t0 across the fleet
    origin = min(
        span["t0"] + offsets[rank]["offset_s"]
        for rank, spans in spans_by_rank.items()
        for span in spans + active_by_rank.get(rank, [])
    )

    def _us(rank: int, t: float) -> float:
        return round((t + offsets[rank]["offset_s"] - origin) * 1e6, 3)

    events: List[dict] = []
    tids: Dict[Tuple[int, str], int] = {}

    def _tid(rank: int, thread: str) -> int:
        key = (rank, thread or "MainThread")
        if key not in tids:
            tids[key] = len([k for k in tids if k[0] == rank]) + 1
            events.append({
                "ph": "M", "name": "thread_name", "pid": rank,
                "tid": tids[key], "args": {"name": key[1]},
            })
        return tids[key]

    for rank in sorted(spans_by_rank):
        events.append({
            "ph": "M", "name": "process_name", "pid": rank,
            "args": {"name": f"rank {rank}"},
        })
        events.append({
            "ph": "M", "name": "process_sort_index", "pid": rank,
            "args": {"sort_index": rank},
        })
        for span in sorted(spans_by_rank[rank], key=lambda s: s["t0"]):
            args: Dict[str, Any] = dict(span.get("attrs") or {})
            if span.get("step") is not None:
                args["step"] = span["step"]
            if span.get("error"):
                args["error"] = span["error"]
            events.append({
                "ph": "X", "name": span["name"], "pid": rank,
                "tid": _tid(rank, span.get("thread")),
                "ts": _us(rank, span["t0"]),
                "dur": round(max(0.0, span["t1"] - span["t0"]) * 1e6, 3),
                "cat": span["name"].split("/", 1)[0],
                "args": args,
            })
        # spans still OPEN at dump time: begin-without-end events — the
        # wedged sections a hang post-mortem cares about; Perfetto renders
        # them as unfinished slices
        for span in sorted(active_by_rank.get(rank, []),
                           key=lambda s: s["t0"]):
            args = dict(span.get("attrs") or {})
            args["unfinished"] = True
            if span.get("step") is not None:
                args["step"] = span["step"]
            events.append({
                "ph": "B", "name": span["name"], "pid": rank,
                "tid": _tid(rank, span.get("thread")),
                "ts": _us(rank, span["t0"]),
                "cat": span["name"].split("/", 1)[0],
                "args": args,
            })
        # goodput-ledger counter track: cumulative per-class seconds
        # sampled at each step-window close — Perfetto stacks the series,
        # so badput growth is visible at a glance next to the span track
        for t in sorted(ledger_by_rank.get(rank, {})):
            events.append({
                "ph": "C", "name": "ledger_s", "pid": rank,
                "ts": _us(rank, t),
                "cat": "ledger",
                "args": {cls: val for cls, val
                         in sorted(ledger_by_rank[rank][t].items())},
            })
    events.sort(key=lambda e: (e.get("ts", -1), e["pid"]))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "schema": TIMELINE_SCHEMA,
            "generated_by": "python -m bagua_tpu_torch.obs.timeline",
            "aligned": all(o["aligned"] for o in offsets.values()),
            "ranks": {
                str(rank): {
                    "clock_offset_s": round(offsets[rank]["offset_s"], 9),
                    "aligned": offsets[rank]["aligned"],
                    "anchor_spans": offsets[rank]["anchors"],
                    "spans": len(spans_by_rank[rank]),
                    "active_spans": len(active_by_rank.get(rank, [])),
                    # a non-zero drop count means the track is a TAIL, not
                    # the whole run — the satellite that makes truncation
                    # visible instead of silent
                    "spans_dropped": dropped_by_rank.get(rank, 0),
                    "ledger_samples": len(ledger_by_rank.get(rank, {})),
                    "sources": sorted(set(sources_by_rank.get(rank, []))),
                }
                for rank in sorted(spans_by_rank)
            },
        },
    }


# ---- validation (shared by tests, CI stage, and --check) ------------------


def validate_timeline(record: dict) -> List[str]:
    """Schema problems with an assembled timeline ([] = valid): the object
    trace form, event fields per the Chrome Trace Event spec (X needs
    ts+dur, B needs ts, M carries no timestamp), and the v1 metadata."""
    problems: List[str] = []
    if not isinstance(record, dict):
        return ["not a JSON object"]
    meta = record.get("metadata") or {}
    if meta.get("schema") != TIMELINE_SCHEMA:
        problems.append(f"metadata.schema != {TIMELINE_SCHEMA}")
    events = record.get("traceEvents")
    if not isinstance(events, list) or not events:
        problems.append("traceEvents missing or empty")
        return problems
    for i, ev in enumerate(events):
        if not isinstance(ev, dict) or "ph" not in ev or "name" not in ev \
                or "pid" not in ev:
            problems.append(f"event[{i}]: missing ph/name/pid")
            continue
        if ev["ph"] == "X":
            if not isinstance(ev.get("ts"), (int, float)) \
                    or not isinstance(ev.get("dur"), (int, float)) \
                    or ev["dur"] < 0 or "tid" not in ev:
                problems.append(f"event[{i}]: X needs ts, dur>=0, tid")
        elif ev["ph"] == "B":
            if not isinstance(ev.get("ts"), (int, float)) or "tid" not in ev:
                problems.append(f"event[{i}]: B needs ts, tid")
        elif ev["ph"] == "C":
            if not isinstance(ev.get("ts"), (int, float)) \
                    or not isinstance(ev.get("args"), dict) \
                    or not ev["args"]:
                problems.append(f"event[{i}]: C needs ts and series args")
        elif ev["ph"] != "M":
            problems.append(f"event[{i}]: unexpected phase {ev['ph']!r}")
        if len(problems) > 20:
            problems.append("... (truncated)")
            break
    ranks = meta.get("ranks")
    if not isinstance(ranks, dict) or not ranks:
        problems.append("metadata.ranks missing/empty")
    else:
        for rid, entry in ranks.items():
            for key in ("clock_offset_s", "aligned", "spans_dropped"):
                if key not in entry:
                    problems.append(f"metadata.ranks[{rid}] missing {key}")
    return problems


# ---- CLI ------------------------------------------------------------------


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bagua_tpu_torch.obs.timeline",
        description="Merge per-rank span dumps (flight_*.json / "
                    "spans_*.json) into one clock-aligned Perfetto trace.",
    )
    ap.add_argument("inputs", nargs="+",
                    help="dump files and/or directories to scan")
    ap.add_argument("--out", default="timeline.json",
                    help="output trace path (default: timeline.json)")
    ap.add_argument("--check", action="store_true",
                    help="schema-validate the assembled trace; non-zero "
                         "exit on problems")
    ap.add_argument("--no-align", action="store_true",
                    help="skip cross-rank clock alignment (raw monotonic "
                         "origins per rank)")
    args = ap.parse_args(argv)

    records = load_rank_records(args.inputs)
    if not records:
        print(f"no rank span dumps found under {args.inputs}",
              file=sys.stderr)
        return 2
    try:
        trace = assemble_timeline(records, align=not args.no_align)
    except ValueError as e:
        print(f"timeline assembly failed: {e}", file=sys.stderr)
        return 2
    with open(args.out, "w") as f:
        json.dump(trace, f, indent=1, sort_keys=True)
    meta = trace["metadata"]
    n_events = len(trace["traceEvents"])
    print(f"wrote {args.out}: {n_events} events from "
          f"{len(meta['ranks'])} rank(s) "
          f"({sum(len(r.get('spans') or []) for r in records)} spans read); "
          f"aligned={meta['aligned']}")
    for rid, entry in sorted(meta["ranks"].items(), key=lambda kv: int(kv[0])):
        print(f"  rank {rid}: offset {entry['clock_offset_s']:+.6f}s "
              f"({'aligned' if entry['aligned'] else 'UNALIGNED'}, "
              f"{entry['anchor_spans']} anchor(s), "
              f"{entry['spans_dropped']} span(s) dropped)")
    if args.check:
        problems = validate_timeline(trace)
        if problems:
            print("schema problems: " + "; ".join(problems),
                  file=sys.stderr)
            return 1
        print(f"schema {TIMELINE_SCHEMA} valid")
    return 0


if __name__ == "__main__":
    sys.exit(main())
