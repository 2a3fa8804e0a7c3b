"""Goodput ledger: where did the wall-clock go?

Port of ``bagua_tpu/obs/ledger.py``.  Every second of a process's
wall-clock lands in exactly one **ledger class**:

* ``productive_step`` — a dispatched train step making forward progress
* ``compile`` — the first step of each step key (a plan, phase or layout
  change): the port's eager step compiles no program, but its first call
  builds kernel extensions, imports ``torch._dynamo`` at the first
  optimizer and autotunes cuBLAS
* ``state_migration`` — queued layout migrations (rebucket, flat-resident
  relayout) converting live state before a step
* ``checkpoint`` — save/restore/verify walls
* ``rendezvous`` — elastic rendezvous rounds
* ``catchup_sync`` — async negotiation gathers and forced catch-up averages
* ``rewind`` — steps the grad guard rewound (their wall was spent, their
  update was discarded)
* ``stall`` — injected ``step.straggle`` stalls
* ``prefill`` / ``decode`` — a SERVING replica's forward progress: the
  engine's chunked-prefill and decode-tick walls
* ``batch_formation_idle`` — a serving replica waiting for arrivals with
  an empty batch
* ``weight_load`` — integrity-verified serving weight loads
* ``idle_other`` — everything else, computed as the remainder so the
  classes always sum to the wall

``goodput_fraction = sum(GOODPUT_CLASSES) / wall``.

Feeding rides machinery that already exists: mapped spans
(:data:`SPAN_CLASS_MAP`, installed as a close hook in :mod:`.spans`), the
trainer's step-cadence windows, its injected-stall reports and the grad
guard's skip verdicts.  All host-side.

MFU: :data:`PEAK_TFLOPS_BF16` (NVIDIA cards only, keyed by
``torch.cuda.get_device_name()``) turns the step's analytic model flops
and the measured step cadence into a per-step ``obs/mfu`` gauge —
null-with-rationale on an unlisted device.

CLI::

    python -m bagua_tpu_torch.obs.ledger EXPORT_DIR_OR_METRICS_JSONL... \
        [--flight DUMP_DIR] [--check] [--tolerance 0.01]

renders a per-run, per-rank efficiency report from ``metrics.jsonl``
(+ rotated ``.1`` siblings) and flight dumps; ``--check`` gates
conservation (classes sum to wall within tolerance).

Import-light (no torch).
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import sys
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)

__all__ = [
    "LEDGER_CLASSES", "GOODPUT_CLASSES", "BADPUT_CLASSES", "SPAN_CLASS_MAP",
    "GoodputLedger", "ledger", "install", "PEAK_TFLOPS_BF16",
    "PEAK_HBM_GBPS", "peak_flops_for_device_kind", "load_ledger_reports",
    "main",
]

#: every wall-clock second lands in exactly one of these (defined next to
#: the `obs/ledger/<cls>_s` gauge declarations in obs.export — the single
#: source of truth for the metric names)
from .export import LEDGER_CLASSES  # noqa: E402

#: the classes that ARE forward progress: a training rank's productive
#: steps, a serving replica's prefill/decode walls —
#: ``goodput_fraction`` sums these, so the headline number means the same
#: thing for both kinds of process (a class the process never feeds
#: contributes zero)
GOODPUT_CLASSES = ("productive_step", "prefill", "decode")

#: the classes that are NOT forward progress
BADPUT_CLASSES = tuple(c for c in LEDGER_CLASSES
                       if c not in GOODPUT_CLASSES)

#: span name -> ledger class: the spans that already bracket the
#: non-productive walls.  Outermost-mapped-span-wins (ckpt/verify nests
#: inside ckpt/restore; async/catchup can nest inside a negotiate path) —
#: the per-thread guard in :meth:`GoodputLedger.span_enter` dedupes.
SPAN_CLASS_MAP = {
    "step/build": "compile",
    "step/cost_analysis": "compile",
    "step/state_migration": "state_migration",
    "ckpt/save": "checkpoint",
    "ckpt/restore": "checkpoint",
    "ckpt/verify": "checkpoint",
    "elastic/rendezvous": "rendezvous",
    "async/negotiate": "catchup_sync",
    "async/catchup": "catchup_sync",
    # serving plane: the engine's prefill/decode walls
    # are serving goodput; weight loads are badput with a name.
    # batch_formation_idle is fed directly by the engine's run loop (the
    # wait-for-arrivals wall has no span to ride).
    "serve/prefill": "prefill",
    "serve/decode": "decode",
    "serve/weight_load": "weight_load",
}

# Peak rates of each card for MFU and roofline reporting, keyed by
# ``torch.cuda.get_device_name()``.  Dense (no sparsity) bf16 tensor-core
# rates and HBM rates from NVIDIA's H100 Tensor Core GPU datasheet: the SXM
# card is "NVIDIA H100 80GB HBM3" (989 TFLOP/s, 3.35 TB/s), the PCIe card
# "NVIDIA H100 PCIe" (756 TFLOP/s, 2.0 TB/s).  An unlisted card has no MFU.
PEAK_TFLOPS_BF16 = {
    "NVIDIA H100 80GB HBM3": 989.0,
    "NVIDIA H100 PCIe": 756.0,
}
PEAK_HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
    "NVIDIA H100 PCIe": 2000.0,
}


def peak_flops_for_device_kind(kind: str) -> Optional[float]:
    """Peak dense bf16 FLOP/s for a device name (None when unknown — the
    CPU, an unlisted card): the MFU denominator, ``None`` meaning the
    ``obs/mfu`` gauge stays null-with-rationale."""
    peak_tflops = PEAK_TFLOPS_BF16.get(kind)
    return peak_tflops * 1e12 if peak_tflops else None


class GoodputLedger:
    """Per-process wall-clock attribution state machine.

    Thread-safe; one per process (:data:`ledger`), like the telemetry
    counters.  The wall anchors at the FIRST noted window (start of that
    window, so the window itself is inside the wall); ``idle_other`` is the
    remainder at report time, which makes conservation hold by
    construction — the test gate then only has to prove the explicit
    classes never EXCEED the wall.
    """

    #: bounded history of (t_mono, cumulative class seconds) samples for
    #: the timeline's counter track — one sample per step window
    SAMPLE_CAP = 512
    #: recent per-step productive windows kept for rewind reclassification
    #: (the grad-guard verdict runs one step behind; 64 >> the verdict lag)
    RECENT_CAP = 64

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._t_start: Optional[float] = None
        self._totals: Dict[str, float] = {
            c: 0.0 for c in LEDGER_CLASSES if c != "idle_other"
        }
        #: class seconds noted since the last step window closed — the
        #: part of the next raw window that is NOT productive-step time
        self._deductions = 0.0
        self._recent: "OrderedDict[int, float]" = OrderedDict()
        self._rewind_windows = 0
        self._step_windows = 0
        self._samples: deque = deque(maxlen=self.SAMPLE_CAP)

    # -- feeding ----------------------------------------------------------

    def _anchor(self, now: float, seconds: float) -> None:
        if self._t_start is None:
            # anchor the wall at the START of the first noted window, so
            # that window's seconds are inside it
            self._t_start = now - max(0.0, seconds)

    def note_class_window(self, cls: str, seconds: float) -> None:
        """Attribute ``seconds`` of host wall to a non-step class.  Windows
        noted between two step-cadence marks are deducted from the next
        step window (they happened inside it)."""
        if seconds <= 0 or cls not in self._totals:
            return
        now = time.monotonic()
        with self._lock:
            self._anchor(now, seconds)
            self._totals[cls] += seconds
            self._deductions += seconds

    def note_step_window(self, step: int, raw_seconds: float,
                         cls: str = "productive_step") -> None:
        """Close one step's wall window (the trainer's cadence hook): the
        window minus the class windows noted inside it is productive-step
        time.  A window that contained a trace+compile or a state
        migration (the first step of a step key)
        passes ``cls="compile"``/``"state_migration"`` instead — its
        remainder is attributed there, not dropped and not mistaken for a
        step's worth of progress."""
        if raw_seconds <= 0 or cls not in self._totals:
            return
        now = time.monotonic()
        with self._lock:
            self._anchor(now, raw_seconds)
            remainder = max(0.0, raw_seconds - min(self._deductions,
                                                   raw_seconds))
            self._deductions = 0.0
            self._totals[cls] += remainder
            self._step_windows += 1
            if cls == "productive_step":
                # only productive windows are rewind-reclassifiable
                self._recent[int(step)] = remainder
                while len(self._recent) > self.RECENT_CAP:
                    self._recent.popitem(last=False)
            self._samples.append(
                (now, {c: round(v, 6) for c, v in self._totals.items()})
            )

    def reclassify_step_rewind(self, step: int) -> None:
        """The grad guard rewound ``step``: its wall was spent but its
        update discarded — move the recorded productive seconds to
        ``rewind``.  A window not recorded as productive (the final step
        of a run drained by ``flush_grad_health``, or a poison firing on a
        compile-classified window) moves the most recent window's size
        instead — always MOVED out of ``productive_step``, never invented,
        so conservation can't break (at worst the estimate is capped by
        the productive seconds actually on the books)."""
        with self._lock:
            seconds = self._recent.pop(int(step), None)
            if seconds is None:
                estimate = (next(reversed(self._recent.values()))
                            if self._recent else 0.0)
                seconds = min(estimate, self._totals["productive_step"])
            self._totals["productive_step"] = max(
                0.0, self._totals["productive_step"] - seconds
            )
            self._totals["rewind"] += seconds
            self._rewind_windows += 1

    # -- span hook (installed into obs.spans) ------------------------------

    def span_enter(self, name: str) -> Optional[str]:
        """Span-open hook: returns the ledger class this span OWNS, or
        None.  Only the outermost mapped span on a thread owns its window
        (``ckpt/verify`` inside ``ckpt/restore`` must not double-count)."""
        cls = SPAN_CLASS_MAP.get(name)
        if cls is None:
            return None
        if getattr(self._local, "owned", False):
            return None
        self._local.owned = True
        return cls

    def span_exit(self, cls: str, seconds: float) -> None:
        """Span-close hook for a span :meth:`span_enter` gave ownership."""
        self._local.owned = False
        self.note_class_window(cls, seconds)

    # -- reading ----------------------------------------------------------

    def report(self, now: Optional[float] = None) -> Optional[dict]:
        """The ledger's current verdict: per-class cumulative seconds
        (``idle_other`` = wall remainder), ``wall_s``, ``goodput_fraction``,
        the badput breakdown and its worst class.  None before any window
        was noted (launcher processes, pure-eval jobs)."""
        with self._lock:
            if self._t_start is None:
                return None
            now = time.monotonic() if now is None else now
            wall = max(1e-9, now - self._t_start)
            classes = {c: round(v, 6) for c, v in self._totals.items()}
            explicit = sum(self._totals.values())
            classes["idle_other"] = round(max(0.0, wall - explicit), 6)
            badput = {c: classes[c] for c in BADPUT_CLASSES if classes[c] > 0}
            worst = max(badput, key=badput.get) if badput else None
            goodput = sum(classes[c] for c in GOODPUT_CLASSES)
            return {
                "wall_s": round(wall, 6),
                "classes": classes,
                "goodput_fraction": round(goodput / wall, 6),
                "badput_s": round(sum(badput.values()), 6),
                "worst_badput_class": worst,
                "step_windows": self._step_windows,
                "rewind_windows": self._rewind_windows,
            }

    def samples(self) -> List[dict]:
        """Bounded (t_mono, cumulative class seconds) history — the
        timeline's per-rank counter track."""
        with self._lock:
            return [{"t": t, "classes": dict(c)} for t, c in self._samples]

    def publish_gauges(self, counters) -> None:
        """Export the cumulative classes + goodput fraction as registered
        gauges (one snapshot; the metrics exporter calls this before every
        export)."""
        rep = self.report()
        if rep is None:
            return
        for cls, seconds in rep["classes"].items():
            counters.set_gauge(f"obs/ledger/{cls}_s", round(seconds, 6))
        counters.set_gauge("obs/ledger/wall_s", rep["wall_s"])
        counters.set_gauge("obs/goodput_fraction", rep["goodput_fraction"])

    def reset(self) -> None:
        """Forget everything (tests, the efficiency bench's measured
        window)."""
        with self._lock:
            self._t_start = None
            for c in self._totals:
                self._totals[c] = 0.0
            self._deductions = 0.0
            self._recent.clear()
            self._rewind_windows = 0
            self._step_windows = 0
            self._samples.clear()


#: process-wide ledger (one per process, like ``telemetry.counters``)
ledger = GoodputLedger()

_INSTALLED = False
_INSTALL_LOCK = threading.Lock()


def install() -> GoodputLedger:
    """Idempotently hook :data:`ledger` into the span tracer so mapped
    spans (checkpoint, rendezvous, async boundaries, step builds) feed
    their classes automatically.  Called by the trainer when the obs plane
    is on; safe from any thread."""
    global _INSTALLED
    with _INSTALL_LOCK:
        if not _INSTALLED:
            from . import spans as _spans

            _spans.set_ledger_sink(ledger)
            _INSTALLED = True
    return ledger


# ---- CLI: per-run report from metrics.jsonl + flight dumps ----------------


def _metrics_files(paths: Sequence[str]) -> List[str]:
    """Expand export dirs / file paths into metrics.jsonl files, rotated
    ``.1`` siblings first so cumulative gauges read oldest-to-newest."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for name in ("metrics.jsonl.1", "metrics.jsonl"):
                f = os.path.join(p, name)
                if os.path.exists(f):
                    files.append(f)
        else:
            rotated = p + ".1"
            if os.path.exists(rotated):
                files.append(rotated)
            files.append(p)
    return files


def load_ledger_reports(paths: Sequence[str]) -> Dict[int, dict]:
    """Last-seen per-rank ledger state from metrics.jsonl snapshots: the
    ``obs/ledger/*`` + ``obs/goodput_fraction`` gauges of each rank's
    newest record (gauges are cumulative, so the last line wins), plus the
    record's obs summary if present."""
    out: Dict[int, dict] = {}
    for path in _metrics_files(paths):
        try:
            with open(path) as f:
                lines = f.read().splitlines()
        except OSError as e:
            logger.warning("ledger: skipping unreadable %s (%s)", path, e)
            continue
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn tail line of a live exporter
            counters = rec.get("counters") or {}
            classes = {
                c: counters[f"obs/ledger/{c}_s"]
                for c in LEDGER_CLASSES
                if f"obs/ledger/{c}_s" in counters
            }
            if not classes:
                continue
            rank = int(rec.get("rank", 0))
            out[rank] = {
                "rank": rank,
                "time_unix": rec.get("time_unix"),
                "classes": classes,
                "wall_s": counters.get("obs/ledger/wall_s"),
                "goodput_fraction": counters.get("obs/goodput_fraction"),
                "mfu": counters.get("obs/mfu"),
                "obs": rec.get("obs") or {},
            }
    return out


def _load_flight_context(dump_dir: str) -> List[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(dump_dir, "flight_*.json"))):
        try:
            rec = json.load(open(path))
        except (OSError, ValueError):
            continue
        out.append({
            "source": os.path.basename(path),
            "trigger": rec.get("trigger"),
            "fault_point": rec.get("fault_point"),
            "rank": rec.get("rank"),
            "ledger": rec.get("ledger"),
        })
    return out


def check_conservation(report: dict, tolerance: float = 0.01
                       ) -> List[str]:
    """Conservation problems with one rank's loaded ledger state ([] =
    holds): the explicit classes must not exceed the wall by more than
    ``tolerance`` (idle_other is a remainder, so the sum can only come up
    short when gauges and wall were snapshot at slightly different
    instants — allowed), and the goodput fraction must be a fraction."""
    problems: List[str] = []
    wall = report.get("wall_s")
    classes = report.get("classes") or {}
    if not isinstance(wall, (int, float)) or wall <= 0:
        return ["no obs/ledger/wall_s gauge in the newest snapshot"]
    missing = [c for c in LEDGER_CLASSES if c not in classes]
    if missing:
        problems.append(f"missing class gauges: {missing}")
    total = sum(v for v in classes.values() if isinstance(v, (int, float)))
    if total > wall * (1.0 + tolerance) + 1e-6:
        problems.append(
            f"classes sum {total:.3f}s exceeds wall {wall:.3f}s "
            f"(+{tolerance:.0%} tolerance)"
        )
    gf = report.get("goodput_fraction")
    if not isinstance(gf, (int, float)) or not (0.0 <= gf <= 1.0):
        problems.append(f"goodput_fraction {gf!r} not in [0, 1]")
    return problems


def render_report(reports: Dict[int, dict],
                  flights: Sequence[dict]) -> str:
    lines: List[str] = []
    for rank in sorted(reports):
        rep = reports[rank]
        wall = rep.get("wall_s") or 0.0
        lines.append(f"rank {rank}: wall {wall:.2f}s, goodput "
                     f"{(rep.get('goodput_fraction') or 0.0):.1%}"
                     + (f", mfu {rep['mfu']:.3f}"
                        if isinstance(rep.get("mfu"), (int, float)) else ""))
        classes = rep.get("classes") or {}
        for cls in LEDGER_CLASSES:
            v = classes.get(cls)
            if v is None:
                continue
            pct = (v / wall * 100.0) if wall else 0.0
            bar = "#" * int(round(pct / 2))
            lines.append(f"  {cls:>16} {v:>10.3f}s {pct:5.1f}% {bar}")
        badput = {c: classes.get(c, 0.0) for c in BADPUT_CLASSES
                  if classes.get(c, 0.0) > 0}
        if badput:
            worst = max(badput, key=badput.get)
            lines.append(f"  worst badput class: {worst} "
                         f"({badput[worst]:.3f}s)")
    if flights:
        lines.append("flight dumps:")
        for fl in flights:
            tag = fl["trigger"] or "?"
            if fl.get("fault_point"):
                tag += f" ({fl['fault_point']})"
            lines.append(f"  rank {fl.get('rank')}: {tag} — {fl['source']}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bagua_tpu_torch.obs.ledger",
        description="Render a per-run goodput/badput report from a "
                    "metrics-exporter directory (metrics.jsonl + rotated "
                    "siblings) and optional flight dumps.",
    )
    ap.add_argument("inputs", nargs="+",
                    help="export directories and/or metrics.jsonl files")
    ap.add_argument("--flight", default=None,
                    help="flight-dump directory for post-mortem context")
    ap.add_argument("--check", action="store_true",
                    help="gate conservation (classes sum to wall within "
                         "--tolerance); non-zero exit on problems")
    ap.add_argument("--tolerance", type=float, default=0.01,
                    help="conservation tolerance as a fraction of wall "
                         "(default 0.01)")
    args = ap.parse_args(argv)

    reports = load_ledger_reports(args.inputs)
    if not reports:
        print(f"no ledger gauges found under {args.inputs} — was the run "
              "exported with BAGUA_OBS_EXPORT_DIR set and the obs plane "
              "on?", file=sys.stderr)
        return 2
    flights = _load_flight_context(args.flight) if args.flight else []
    print(render_report(reports, flights))
    if args.check:
        problems = []
        for rank, rep in sorted(reports.items()):
            problems += [f"rank {rank}: {p}"
                         for p in check_conservation(rep, args.tolerance)]
        if problems:
            print("conservation problems: " + "; ".join(problems),
                  file=sys.stderr)
            return 1
        print(f"conservation holds for {len(reports)} rank(s) "
              f"(±{args.tolerance:.0%})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
