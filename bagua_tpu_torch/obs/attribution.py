"""Device-time attribution: which bucket's collective costs what ON DEVICE.

Port of ``bagua_tpu/obs/attribution.py``.  The host spans time only the
host.  The profiler's trace has the other half, and this module joins the
two:

* host side — the ``trace/bucket_collective`` spans carry each bucket's
  index, bytes and tier (:func:`bucket_launches_from_ring`);
* device side — :func:`bagua_tpu_torch.profiling.parse_trace_comm_events`
  yields the device's communication work, each event tied to its bucket by
  the ``bagua/bucket_collective#<i>`` range the trainer opens around the
  collective while a capture is open.

The JAX package matches device collectives to buckets by position (XLA's
in-order collective streams); the port ties them by the launching range,
so the match needs no equal counts.  What the device did differs by
transport, and the record says which:

* **NCCL** — ``nccl`` kernels: the device's wire time;
* **gloo** — no device kernel at all; the device's part is the staging
  copies through pinned host memory, which are attributed to their bucket
  (``device_comm_s``) beside any codec kernels run in the same range
  (``device_codec_s``).  The host's time inside gloo is never reported as
  device seconds.

Where the device did no communication work (world 1, where a collective is
the identity; CPU tensors), the record is ``{"available": False,
"rationale": ...}``, the JAX package's null-with-rationale form.

The trainer runs :func:`attribute_device_comm` once when a
``BAGUA_PROFILE_DIR`` capture window closes and hands the record to
:func:`.export.note_device_attribution`, so it rides the per-rank obs
summary to the fleet snapshot.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

__all__ = ["attribute_device_comm", "bucket_launches_from_ring",
           "UNAVAILABLE_RATIONALE"]

UNAVAILABLE_RATIONALE = (
    "the trace holds no device communication work (no NCCL kernel and no "
    "staging copy inside a bucket's collective): at world 1 a collective "
    "is the identity, and gloo on host tensors never touches the device; "
    "host spans still cover the host side")


def bucket_launches_from_ring(spans: Optional[List[dict]] = None
                              ) -> List[dict]:
    """The newest per-bucket launch schedule from the span ring: one entry
    per ``trace/bucket_collective`` span (deduped by bucket index, last
    launch wins — the port's eager step opens the spans on every call),
    sorted by launch order.  ``[{"bucket", "bytes", "tier", "ici_bytes",
    "dcn_bytes"}, ...]``; [] when no bucket collective ran."""
    if spans is None:
        from . import spans as _spans

        spans = _spans.recorder.snapshot()
    by_bucket: Dict[int, dict] = {}
    for span in spans:
        if span.get("name") != "trace/bucket_collective":
            continue
        attrs = span.get("attrs") or {}
        if "bucket" not in attrs:
            continue
        by_bucket[int(attrs["bucket"])] = {
            "bucket": int(attrs["bucket"]),
            "bytes": int(attrs.get("bytes") or 0),
            "tier": str(attrs.get("tier") or "flat"),
            "ici_bytes": int(attrs.get("ici_bytes")
                             or attrs.get("bytes") or 0),
            "dcn_bytes": int(attrs.get("dcn_bytes") or 0),
            "t0": span.get("t0", 0.0),
        }
    # the last step's launch order: the newest launch of each bucket
    out = sorted(by_bucket.values(), key=lambda e: e["t0"])
    for e in out:
        e.pop("t0", None)
    return out


def attribute_device_comm(log_dir: str,
                          bucket_launches: Optional[List[dict]] = None
                          ) -> dict:
    """Attribute device communication time from the newest trace under
    ``log_dir`` (or a trace file).  Returns (always a dict, never raises):

    * unavailable — ``{"available": False, "rationale": ...}``;
    * available — ``{"available": True, "transport", "step_s",
      "comm_s_per_step", "compute_s_per_step", "overlap_fraction",
      "per_bucket": [...] | None, "per_bucket_rationale": ... when
      per_bucket is None, "per_op": [...]}``.

    ``per_bucket`` rows are ``{"bucket", "bytes", "tier", "transport",
    "device_comm_s", "device_codec_s", "events"}``: mean device seconds a
    step of the bucket's communication work and of the kernels its range
    ran besides; ``device_comm_s`` is None for a bucket whose range held no
    device communication work."""
    import os

    from .. import profiling as _prof

    try:
        path = log_dir if os.path.isfile(log_dir) else _prof.newest_trace(log_dir)
        if path is None:
            return {"available": False, "rationale": "no trace under "
                    f"{log_dir!r}"}
        trace = _prof.load_trace(path)
        comm = _prof.parse_trace_comm_events(trace)
        overlap = _prof.parse_trace_overlap(trace)
    except Exception as e:  # noqa: BLE001 - a malformed trace
        return {"available": False, "rationale": f"trace parse failed: {e}"}
    if not comm or not comm.get("events"):
        return {"available": False, "rationale": UNAVAILABLE_RATIONALE}
    n_steps = int(comm.get("n_steps") or 0)
    if not n_steps:
        return {"available": False, "rationale": "the trace records no step "
                "count (not a StepProfiler window)"}
    events = comm["events"]
    record: dict = {"available": True, "transport": comm["transport"],
                    "n_steps": n_steps, "trace": path}
    if overlap:
        record.update(overlap)
    per_op: Dict[str, dict] = {}
    for ev in events:
        rec = per_op.setdefault(ev["name"], {"op": ev["name"], "kind": ev["kind"],
                                             "time_s": 0.0, "occurrences": 0})
        rec["time_s"] += ev["dur_s"]
        rec["occurrences"] += 1
    for rec in per_op.values():
        rec["time_s"] = round(rec["time_s"], 9)
    record["per_op"] = sorted(per_op.values(), key=lambda r: -r["time_s"])

    if bucket_launches is None:
        bucket_launches = bucket_launches_from_ring()
    record["per_bucket"] = None
    if not bucket_launches:
        record["per_bucket_rationale"] = (
            "no trace/bucket_collective spans in the ring — per-op totals "
            "above are the attribution")
        return record
    comm_s: Dict[int, float] = {}
    kinds: Dict[int, set] = {}
    count: Dict[int, int] = {}
    for ev in events:
        b = ev.get("bucket")
        if b is None:
            continue
        comm_s[b] = comm_s.get(b, 0.0) + ev["dur_s"]
        kinds.setdefault(b, set()).add(ev["kind"])
        count[b] = count.get(b, 0) + 1
    codec_s: Dict[int, float] = {}
    for ev in comm.get("bucket_compute") or []:
        codec_s[ev["bucket"]] = codec_s.get(ev["bucket"], 0.0) + ev["dur_s"]
    if not comm_s:
        record["per_bucket_rationale"] = (
            "no device communication work ran inside a bucket's collective "
            "range (the capture opened no bagua/bucket_collective ranges, "
            "or the collectives ran outside them) — per-op totals above are "
            "the attribution")
        return record
    rows = []
    for launch in bucket_launches:
        b = launch["bucket"]
        k = kinds.get(b, set())
        rows.append({
            "bucket": b, "bytes": launch["bytes"],
            "tier": launch.get("tier", "flat"),
            "transport": "nccl" if "nccl" in k else ("gloo" if k else None),
            "device_comm_s": round(comm_s[b] / n_steps, 9) if b in comm_s else None,
            "device_codec_s": round(codec_s.get(b, 0.0) / n_steps, 9),
            "events": count.get(b, 0),
        })
    record["per_bucket"] = rows
    return record
