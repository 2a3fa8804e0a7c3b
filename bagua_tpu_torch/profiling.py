"""Profiler integration: ``torch.profiler`` captures and their parsers.

Port of ``bagua_tpu/profiling.py``.  The JAX package traces with
``jax.profiler`` and parses the TPU's xplane; the port traces with
``torch.profiler`` (CPU and, on a card, CUDA activities, CUPTI underneath)
and parses the Chrome trace it exports.

Entry points:

- :func:`trace`: context manager around any region.
- trainer auto-capture: set ``BAGUA_PROFILE_DIR=/path`` (and optionally
  ``BAGUA_PROFILE_STEPS=start:stop``, default ``2:5`` — skip the first
  step, which builds the kernels).  ``BaguaTrainer.train_step`` starts and
  stops the capture at those step numbers and writes
  ``bagua_trace_rank<r>_pid<p>.pt.trace.json`` there.  Its top-level
  ``"bagua"`` object records how many steps the window held.
- :func:`annotate`: a ``record_function`` range while a capture is open
  (a null context otherwise).  The trainer wraps each bucket's collective
  in ``bagua/bucket_collective#<i>``, which is how
  :func:`parse_trace_comm_events` ties a device event to its bucket.
- :func:`classify_kernel`: the one kernel classifier of the package (flash,
  gmm, codec, NCCL, GEMM, optimizer, ...);
  ``scripts/torch_step_profile.py`` and ``chip_smoke.py`` call it.

The parsers read device events (Kineto's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` categories).  :func:`trace_memory_traffic` has no
counterpart: the TPU's xplane carries each op's HBM bytes, a CUPTI trace
carries no DRAM byte counts, so it returns null with that rationale.
"""

from __future__ import annotations

import contextlib
import glob
import json
import logging
import os
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

__all__ = [
    "profile_dir", "profile_steps", "trace", "StepProfiler", "annotate",
    "KERNEL_CLASSES", "classify_kernel", "is_comm_op", "load_trace",
    "newest_trace", "device_events", "parse_trace_op_profile",
    "parse_trace_comm_events", "parse_trace_overlap", "trace_memory_traffic",
    "MEMORY_TRAFFIC_RATIONALE", "BUCKET_ANNOTATION",
]

#: name fragments -> class, first match wins.  The port's kernels first
#: (K6 flash, K7 gmm, K1-K5 codec), then the library kernels a step runs
KERNEL_CLASSES = (
    ("flash_fwd", ("fwd_wgmma", "fwd_wide_kernel", "fwd_kernel")),
    ("flash_bwd_dkv", ("dkv_wgmma", "dkv_wide_kernel", "dkv_kernel")),
    ("flash_bwd_dq", ("dq_wgmma", "dq_wide_kernel", "dq_kernel")),
    ("gmm_drhs", ("gmm_drhs_",)),
    ("gmm", ("gmm_kernel", "gmm_wgmma_kernel", "gmm_f32_kernel")),
    ("codec", ("minmax_compress_kernel", "decompress_kernel", "absmax_kernel",
               "sign_compress_kernel", "sign_unpack_kernel")),
    ("nccl", ("nccl",)),
    ("gemm", ("nvjet", "gemm", "xmma", "cutlass")),
    ("optimizer", ("multi_tensor_apply",)),
    ("softmax_cross_entropy", ("SoftMax", "softmax", "nll_loss")),
    # MoE routing: top-k, the stable sort by expert, the row gather, the
    # group-size scatter-add and the output index_add
    ("sort_gather_scatter", ("Sort", "sort", "TopK", "radix", "scatter_gather",
                             "indexSelect", "indexFunc", "index_elementwise")),
    ("elementwise_and_copy", ("elementwise_kernel", "copy_kernel")),
    ("reduce", ("reduce_kernel",)),
)

#: the record_function range the trainer opens around each bucket's
#: collective while a capture is open (``#<bucket index>`` appended)
BUCKET_ANNOTATION = "bagua/bucket_collective#"

MEMORY_TRAFFIC_RATIONALE = (
    "a CUPTI trace carries no DRAM byte counts (the TPU's xplane records "
    "each op's HBM bytes); time a kernel against its bound instead")


def classify_kernel(name: str) -> str:
    """The class of a device kernel by its name (:data:`KERNEL_CLASSES`),
    ``"other"`` when nothing matches."""
    for cls, frags in KERNEL_CLASSES:
        if any(f in name for f in frags):
            return cls
    return "other"


def is_comm_op(name: str) -> bool:
    """Whether a device kernel puts data on the wire: NCCL's kernels.
    (Gloo runs no device kernel: its device work is the staging copies,
    which :func:`parse_trace_comm_events` finds by their bucket range.)"""
    return "nccl" in name.lower()


def profile_dir() -> Optional[str]:
    from . import env

    return env.get_profile_dir()


def profile_steps() -> Tuple[int, int]:
    """[start, stop) step window for trainer auto-capture."""
    from . import env

    raw = env.get_profile_steps_raw()
    try:
        start, stop = raw.split(":")
        return int(start), int(stop)
    except ValueError:
        logger.warning("BAGUA_PROFILE_STEPS=%r is not start:stop; using 2:5",
                       raw)
        return 2, 5


# one profiler session at a time: track the owner (a StepProfiler or the
# trace() context manager) so the other entry point skips its turn
_TRACE_OWNER: Optional[object] = None


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def annotate(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    capture of this module is open, else a shared null context (one global
    read)."""
    if _TRACE_OWNER is None:
        return _NULL
    import torch

    return torch.profiler.record_function(name)


def _activities():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _trace_path(log_dir: str, tag: str = "") -> str:
    from . import env

    os.makedirs(log_dir, exist_ok=True)
    return os.path.join(log_dir, "bagua_trace_rank{}_pid{}{}.pt.trace.json".format(
        int(env.get_rank()), os.getpid(), tag))


def _export(prof, path: str, meta: Dict[str, Any]) -> str:
    """Export the Chrome trace and add the ``"bagua"`` object (the steps the
    window held, the rank) at its top level."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    data["bagua"] = meta
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(data, f)
    os.replace(tmp, path)
    return path


@contextlib.contextmanager
def trace(log_dir: str, steps: Optional[int] = None):
    """Capture a ``torch.profiler`` trace of the enclosed region into
    ``log_dir``; yields a dict whose ``"path"`` is set on exit.  ``steps``
    is recorded as the number of steps the region holds.  If a capture is
    already open, the region runs untraced with a warning."""
    global _TRACE_OWNER
    import torch

    holder: Dict[str, Any] = {"path": None}
    if _TRACE_OWNER is not None:
        logger.warning("profiling.trace(%s): another trace is active; running "
                       "untraced", log_dir)
        yield holder
        return
    token = object()
    prof = torch.profiler.profile(activities=_activities())
    prof.__enter__()
    _TRACE_OWNER = token
    try:
        yield holder
    finally:
        try:
            prof.__exit__(None, None, None)
        finally:
            if _TRACE_OWNER is token:
                _TRACE_OWNER = None
        from . import env

        holder["path"] = _export(prof, _trace_path(log_dir, f"_{id(token):x}"),
                                 {"steps": steps, "rank": int(env.get_rank())})


class StepProfiler:
    """Start/stop a ``torch.profiler`` capture across a step-number window
    (the trainer's hook).  Registered with ``atexit`` so a run that ends
    before the stop step still writes its trace."""

    def __init__(self, log_dir: str, start: int, stop: int):
        self.log_dir = log_dir
        self.start = start
        self.stop = stop
        self._prof = None
        self._active = False
        self._done = False
        self._traced = 0
        self._closed_dir: Optional[str] = None
        #: the trace file the window wrote (None until it closes)
        self.path: Optional[str] = None

    @classmethod
    def from_env(cls) -> Optional["StepProfiler"]:
        d = profile_dir()
        if not d:
            return None
        start, stop = profile_steps()
        prof = cls(d, start, stop)
        import atexit

        atexit.register(prof.close)
        return prof

    def on_step(self, step: int) -> None:
        """Call once per train step BEFORE running it (``step`` counts the
        steps already run)."""
        global _TRACE_OWNER
        if self._done:
            return
        if self._active and step >= self.stop:
            self.close()
            return
        if not self._active and step >= self.start:
            if _TRACE_OWNER is not None:
                return   # another window is open: skip, do not crash
            import torch

            self._prof = torch.profiler.profile(activities=_activities())
            self._prof.__enter__()
            _TRACE_OWNER = self
            self._active = True
            logger.info("profiler: tracing steps [%d, %d) -> %s",
                        self.start, self.stop, self.log_dir)
        if self._active:
            self._traced += 1

    def close(self) -> None:
        global _TRACE_OWNER
        if not self._active:
            return
        from . import env

        try:
            self._prof.__exit__(None, None, None)
        finally:
            self._active = False
            self._done = True
            if _TRACE_OWNER is self:
                _TRACE_OWNER = None
        self.path = _export(self._prof, _trace_path(self.log_dir),
                            {"steps": self._traced, "start": self.start,
                             "stop": self.stop, "rank": int(env.get_rank())})
        self._prof = None
        self._closed_dir = self.log_dir
        logger.info("profiler: trace written to %s", self.path)

    def consume_closed_dir(self) -> Optional[str]:
        """The log dir of a JUST-closed window, once (None after the first
        read) — the trainer's hook for device-time attribution."""
        d, self._closed_dir = self._closed_dir, None
        return d


# ---- parsers of the exported Chrome trace ----------------------------------

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def newest_trace(log_dir: str) -> Optional[str]:
    """The most recently written ``*.pt.trace.json`` under ``log_dir`` (by
    mtime), or None."""
    files = glob.glob(os.path.join(log_dir, "**", "*.pt.trace.json"), recursive=True)
    if not files:
        return None
    return max(files, key=lambda p: (os.path.getmtime(p), p))


def load_trace(path: str) -> dict:
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, list):   # the bare-array form of the format
        data = {"traceEvents": data}
    return data


def _events(trace) -> List[dict]:
    if isinstance(trace, str):
        trace = load_trace(trace)
    return [e for e in trace.get("traceEvents", []) if isinstance(e, dict)]


def _steps(trace) -> Optional[int]:
    if isinstance(trace, str):
        trace = load_trace(trace)
    n = (trace.get("bagua") or {}).get("steps")
    return int(n) if n else None


def device_events(trace) -> List[dict]:
    """The device's complete events (kernels, copies, sets), start-ordered:
    ``[{"name", "cat", "t0_s", "dur_s", "correlation"}]``."""
    out = []
    for e in _events(trace):
        if e.get("ph") != "X" or e.get("cat") not in _DEVICE_CATS:
            continue
        out.append({"name": e.get("name", ""), "cat": e["cat"],
                    "t0_s": float(e.get("ts", 0.0)) / 1e6,
                    "dur_s": float(e.get("dur", 0.0)) / 1e6,
                    "correlation": (e.get("args") or {}).get("correlation")})
    out.sort(key=lambda e: e["t0_s"])
    return out


def _device_span_s(events: List[dict]) -> float:
    if not events:
        return 0.0
    return max(e["t0_s"] + e["dur_s"] for e in events) - min(e["t0_s"] for e in events)


def parse_trace_op_profile(trace) -> dict:
    """Per-kernel device time from a trace (path or loaded dict):
    ``{"ops": {name: {"time_s", "count", "class"}}, "classes": {class:
    time_s}, "total_time_s", "n_steps"}`` ({} when the trace holds no
    device event).  ``time_s`` sums the occurrences."""
    if isinstance(trace, str):
        trace = load_trace(trace)
    ops: Dict[str, dict] = {}
    classes: Dict[str, float] = {}
    for ev in device_events(trace):
        cls = classify_kernel(ev["name"]) if ev["cat"] == "kernel" else ev["cat"]
        rec = ops.setdefault(ev["name"], {"time_s": 0.0, "count": 0, "class": cls})
        rec["time_s"] += ev["dur_s"]
        rec["count"] += 1
        classes[cls] = classes.get(cls, 0.0) + ev["dur_s"]
    if not ops:
        return {}
    return {"ops": ops, "classes": classes,
            "total_time_s": sum(r["time_s"] for r in ops.values()),
            "n_steps": _steps(trace)}


def _bucket_of_launch(trace) -> Dict[Any, int]:
    """correlation id -> bucket index, for every device event launched from
    inside a ``bagua/bucket_collective#<i>`` range: the runtime call with
    the same correlation id lies in the range on the range's thread."""
    ranges: Dict[Tuple, List[Tuple[float, float, int]]] = {}
    runtime = []
    for e in _events(trace):
        if e.get("ph") != "X":
            continue
        name = e.get("name", "")
        if e.get("cat") == "user_annotation" and name.startswith(BUCKET_ANNOTATION):
            t0 = float(e.get("ts", 0.0))
            ranges.setdefault((e.get("pid"), e.get("tid")), []).append(
                (t0, t0 + float(e.get("dur", 0.0)), int(name[len(BUCKET_ANNOTATION):])))
        elif e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                runtime.append((corr, e.get("pid"), e.get("tid"), float(e.get("ts", 0.0))))
    out: Dict[Any, int] = {}
    for corr, pid, tid, ts in runtime:
        for t0, t1, bucket in ranges.get((pid, tid), ()):
            if t0 <= ts <= t1:
                out[corr] = bucket
                break
    return out


def parse_trace_comm_events(trace) -> dict:
    """The device's communication work, start-ordered — the device half of
    per-bucket comm attribution.  NCCL kernels anywhere, and copies made
    from inside a bucket's collective range (gloo's staging through pinned
    host memory); each event names its ``bucket`` (None outside a range)
    and ``kind`` (``nccl`` or ``staging_copy``).  Kernels run inside a
    bucket's range that are neither (the codec's) come back as
    ``bucket_compute``.

    Returns ``{}`` when the trace holds no device event; otherwise
    ``{"events": [...], "bucket_compute": [...], "n_steps", "step_s",
    "transport"}`` with ``transport`` ``"nccl"``, ``"gloo"`` (copies
    only), or None (no communication work on the device)."""
    if isinstance(trace, str):
        trace = load_trace(trace)
    devs = device_events(trace)
    if not devs:
        return {}
    bucket_of = _bucket_of_launch(trace)
    events, compute = [], []
    for ev in devs:
        bucket = bucket_of.get(ev["correlation"])
        row = {"name": ev["name"], "t0_s": ev["t0_s"], "dur_s": ev["dur_s"],
               "bucket": bucket}
        if ev["cat"] == "kernel" and is_comm_op(ev["name"]):
            events.append({**row, "kind": "nccl"})
        elif ev["cat"] == "gpu_memcpy" and bucket is not None:
            events.append({**row, "kind": "staging_copy"})
        elif bucket is not None:
            compute.append(row)
    kinds = {e["kind"] for e in events}
    out: Dict[str, Any] = {
        "events": events, "bucket_compute": compute,
        "transport": "nccl" if "nccl" in kinds else ("gloo" if kinds else None),
    }
    n = _steps(trace)
    if n:
        out["n_steps"] = n
        out["step_s"] = _device_span_s(devs) / n
    return out


def parse_trace_overlap(trace) -> dict:
    """Comm-hidden ratio from a trace: device time of communication work
    (:func:`parse_trace_comm_events`) against everything else on the
    device, over the device span of the window divided by its steps::

        overlap_fraction = clamp((comm + compute - step) / comm, 0, 1)

    ``{}`` when the trace records no step count or no communication work
    — callers record a null honestly instead of guessing."""
    if isinstance(trace, str):
        trace = load_trace(trace)
    comm = parse_trace_comm_events(trace)
    n = comm.get("n_steps") if comm else None
    if not comm or not comm["events"] or not n:
        return {}
    comm_s = sum(e["dur_s"] for e in comm["events"]) / n
    total = sum(e["dur_s"] for e in device_events(trace)) / n
    compute_s = total - comm_s
    step_s = comm["step_s"]
    hidden = max(0.0, min(1.0, (comm_s + compute_s - step_s) / comm_s))
    return {"step_s": round(step_s, 9), "comm_s_per_step": round(comm_s, 9),
            "compute_s_per_step": round(compute_s, 9),
            "overlap_fraction": round(hidden, 3)}


def trace_memory_traffic(run_step=None, steps: int = 5, log_dir=None,
                         finalize=None) -> dict:
    """No counterpart on the card: null with :data:`MEMORY_TRAFFIC_RATIONALE`
    (the steps are not run)."""
    return {"available": False, "rationale": MEMORY_TRAFFIC_RATIONALE}
