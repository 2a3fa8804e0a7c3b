"""The observability plane of the port.

Port of ``bagua_tpu/obs/``:

* :mod:`~bagua_tpu_torch.obs.spans` — host-side step-span tracer
  (``trace_span``) with a bounded ring buffer; the trainer, the overlap
  scheduler's comm worker, async boundaries, checkpoint paths, elastic
  rendezvous and watchdog sections all open spans.
* :mod:`~bagua_tpu_torch.obs.recorder` — crash flight recorder: on
  watchdog abort, grad-guard escalation, health-fence stop, armed-fault
  fire, or SIGTERM, dump spans + counters + step metrics to
  ``BAGUA_OBS_DUMP_DIR``.
* :mod:`~bagua_tpu_torch.obs.export` — ``METRIC_REGISTRY``, the background
  metrics exporter (JSONL + Prometheus textfile), and the coordinator-side
  fleet snapshot.
* :mod:`~bagua_tpu_torch.obs.timeline` — merge per-rank span dumps into one
  clock-aligned Perfetto/Chrome trace
  (``python -m bagua_tpu_torch.obs.timeline``).
* :mod:`~bagua_tpu_torch.obs.anomaly` — rolling median/MAD step-time
  anomaly detector.
* :mod:`~bagua_tpu_torch.obs.attribution` — per-bucket device comm seconds
  from a ``torch.profiler`` trace, by transport (null-with-rationale where
  the device did no communication work).
* :mod:`~bagua_tpu_torch.obs.ledger` — goodput/badput wall-clock ledger
  (``python -m bagua_tpu_torch.obs.ledger``) and the cards' peak tables
  behind ``obs/mfu``.
* :mod:`~bagua_tpu_torch.obs.memory` — the static footprint (exact over the
  trainer's flats) and live ``torch.cuda`` allocator peaks and headroom.

The JAX package's ``Historian`` and ``ObsHTTPServer`` (the fleet and
control plane) are not exported: they come with the port's autopilot.

Master switch: ``BAGUA_OBS`` (default on; ``off`` restores the exact
pre-obs host behavior).  Import-light: nothing here imports torch at
package import.
"""

from .export import (  # noqa: F401
    METRIC_REGISTRY,
    MetricsExporter,
    local_obs_summary,
    render_prometheus,
    validate_fleet_snapshot,
    write_fleet_snapshot,
)
from .export import LEDGER_CLASSES  # noqa: F401
from .memory import live_memory_stats, plan_flat_bytes, static_footprint  # noqa: F401
from .recorder import (  # noqa: F401
    dump_flight_record,
    validate_flight_record,
)
# NOTE: the span ring instance is ``spans.recorder`` — deliberately NOT
# re-exported here, where it would shadow the ``obs.recorder`` submodule
from .spans import SpanRecorder, span_ring, trace_span  # noqa: F401
from .anomaly import StepAnomalyDetector, fleet_straggler_suspects  # noqa: F401,E402
# NOTE: obs.timeline and obs.ledger are NOT imported here: both are
# `python -m` entry points, and a package-level import would leave a second
# copy of the module executing under runpy
