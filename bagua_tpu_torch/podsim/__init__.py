"""Pod-scale proof harness: many real processes, one simulated pod.

Port of ``bagua_tpu/podsim``.  The coordinator-side machinery the port's
hierarchical collectives, codecs and autopilot lean on (rendezvous, lease
tracking, historian ingest, autopilot decisions, the ``/fleet`` HTTP plane)
is only credible if it holds up at pod-scale world sizes.  This package
drives it with 32-256 *real OS processes* on one host:

* :mod:`~bagua_tpu_torch.podsim.util`: ``reserve_port()``, the one ephemeral
  port allocator every multi-process test and drill shares, plus the
  store-backed barrier.
* :mod:`~bagua_tpu_torch.podsim.shaping`: per-link traffic shaping (latency,
  bandwidth, deterministic jitter per intra- and inter-node link class)
  with drop and partition faults composed through
  :mod:`bagua_tpu_torch.faults.inject` (point ``podsim.link``).
* :mod:`~bagua_tpu_torch.podsim.transport`: a loopback-TCP ring transport
  with the shaper on every hop; addresses rendezvous through the restart
  TCPStore.
* :mod:`~bagua_tpu_torch.podsim.collectives`: the two-level hierarchical
  ring allreduce (intra reduce-scatter, inter ring over the 1/intra shard
  with a wire codec on the inter tier, intra allgather) as numpy over the
  shaped transport, frame for frame the JAX package's.
* :mod:`~bagua_tpu_torch.podsim.worker`: one simulated node: joins the REAL
  elastic-membership rendezvous, heartbeats a REAL lease, runs the shaped
  data plane, follows stop/resize/halt fences.
* :mod:`~bagua_tpu_torch.podsim.coordinator`: the coordinator stack as a
  *killable OS process*: one replica of the restart store, the leadership
  lease (held or watched), and on takeover the historian and autopilot
  state resumed from the surviving replica.
* :mod:`~bagua_tpu_torch.podsim.orchestrator`: plays every node's launcher
  at once: hosts the restart TCPStore and runs the port's
  :class:`~bagua_tpu_torch.elastic.coordinator.ElasticCoordinator`,
  :class:`~bagua_tpu_torch.elastic.membership.LeaseTracker`,
  :class:`~bagua_tpu_torch.obs.historian.Historian`,
  :class:`~bagua_tpu_torch.autopilot.engine.AutopilotEngine` and
  :class:`~bagua_tpu_torch.obs.http.ObsHTTPServer` over N worker processes;
  :func:`~bagua_tpu_torch.podsim.orchestrator.full_scenario` is the
  end-to-end drill with its 17 checks.

Import-light (no torch) by construction: a 128-rank drill cannot afford a
torch import per simulated rank (``import torch`` alone takes seconds), so
the worker and coordinator processes run as files whose bootstrap
(:func:`~bagua_tpu_torch.podsim.worker.torch_free_bootstrap`) installs
namespace packages for ``bagua_tpu_torch`` and its ``contrib`` and
``elastic`` subpackages, whose ``__init__`` modules import torch-bound code,
and then import only the store, elastic, autopilot and obs modules, which
import neither torch nor numpy.
"""

from .shaping import (  # noqa: F401
    LINK_DCN,
    LINK_ICI,
    LinkDropped,
    LinkSevered,
    LinkShaper,
    LinkSpec,
    ShapeSpec,
    SHAPE_PRESETS,
    classify_link,
    resolve_shape,
    transfer_time_s,
)
from .util import reserve_port, reserve_ports, store_barrier  # noqa: F401

__all__ = [
    "LINK_DCN",
    "LINK_ICI",
    "LinkDropped",
    "LinkSevered",
    "LinkShaper",
    "LinkSpec",
    "SHAPE_PRESETS",
    "ShapeSpec",
    "classify_link",
    "resolve_shape",
    "reserve_port",
    "reserve_ports",
    "store_barrier",
    "transfer_time_s",
]
