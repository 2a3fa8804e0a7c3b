"""Per-link traffic shaping for the pod simulator (no torch).

Port of ``bagua_tpu/podsim/shaping.py``.  The hierarchical collectives
classify every edge as ``ici`` (the fast intra-node tier) or ``dcn`` (the
slow inter-node network) and spend their complexity on the slow tier (see
``bagua_tpu_torch.communication``, ``LINK_ICI``/``LINK_DCN``).  The simulator
reproduces that asymmetry for *real processes over loopback TCP*: every ring
hop pays a deterministic traversal time

    ``latency_s  +  nbytes / bandwidth_Bps  +  u * jitter_s``

where ``u`` is a hash of ``(seed, src, dst, hop)``, identical across reruns,
so a drill's injected network time is the same run to run.

Faults ride the existing fault plane: the point ``podsim.link``
(``bagua_tpu_torch.faults.inject``) supports kind ``drop``, where the next
shaped hop raises :class:`LinkDropped`, a ``ConnectionError`` the transport
surfaces like a real peer reset, and kind ``partition``, where the slice
named by the spec's ``rank`` loses every link crossing slices for
``duration_s`` seconds (:class:`LinkSevered`) while its intra-slice links
keep working, as a real cut between nodes does.  Plans arm through
``FaultPlan`` / ``BAGUA_FAULT_PLAN``, so one plan composes link faults with
store errors, heartbeat drops and straggler dilation.
"""

from __future__ import annotations

import hashlib
import json
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from ..faults import inject as _inject

__all__ = [
    "LINK_ICI", "LINK_DCN", "LinkSpec", "ShapeSpec", "SHAPE_PRESETS",
    "LinkDropped", "LinkSevered", "LinkShaper", "classify_link",
    "resolve_shape", "transfer_time_s", "deterministic_jitter",
]

#: link classes: the values of ``bagua_tpu_torch.communication.LINK_ICI`` and
#: ``LINK_DCN`` (kept literal so the simulator imports no torch; equality is
#: pinned in tests/test_torch_podsim.py)
LINK_ICI = "ici"
LINK_DCN = "dcn"

#: fault point the shaper queries (declared in bagua_tpu_torch.faults.inject)
FAULT_POINT = "podsim.link"


class LinkDropped(_inject.InjectedFault, ConnectionError):
    """An armed ``podsim.link``/``drop`` fault ate this hop's payload."""


class LinkSevered(_inject.InjectedFault, ConnectionError):
    """A ``podsim.link``/``partition`` fault has this slice cut off from
    the DCN; every cross-slice hop touching it fails until the cut
    expires."""


@dataclass(frozen=True)
class LinkSpec:
    """One link class's physics: propagation latency, usable bandwidth in
    bytes/second (0 = infinite), and the jitter ceiling."""

    latency_s: float = 0.0
    bandwidth_Bps: float = 0.0
    jitter_s: float = 0.0

    def to_json(self) -> dict:
        return {"latency_s": self.latency_s,
                "bandwidth_Bps": self.bandwidth_Bps,
                "jitter_s": self.jitter_s}


@dataclass(frozen=True)
class ShapeSpec:
    """A whole pod's link model: slice width for ICI/DCN classification
    plus the two link classes' physics and the jitter seed."""

    name: str = "off"
    slice_size: int = 8
    ici: LinkSpec = field(default_factory=LinkSpec)
    dcn: LinkSpec = field(default_factory=LinkSpec)
    seed: int = 0

    def to_json(self) -> dict:
        return {"name": self.name, "slice_size": self.slice_size,
                "ici": self.ici.to_json(), "dcn": self.dcn.to_json(),
                "seed": self.seed}


#: named presets for ``BAGUA_SCALE_SHAPE`` / ``--shape``, the JAX package's
#: numbers: scaled-down stand-ins (a drill cannot afford real WAN waits);
#: what matters is the asymmetry of the two tiers, not the magnitudes.
SHAPE_PRESETS: Dict[str, ShapeSpec] = {
    # no injected time at all — pure-software ceiling
    "off": ShapeSpec(name="off"),
    # one pod: microsecond-class ICI, ~200us DCN RTT-half, mild jitter
    "pod": ShapeSpec(
        name="pod", slice_size=8,
        ici=LinkSpec(latency_s=2e-6, bandwidth_Bps=40e9, jitter_s=1e-6),
        dcn=LinkSpec(latency_s=200e-6, bandwidth_Bps=2.5e9, jitter_s=50e-6),
    ),
    # cross-region flavor: the DCN tier dominates everything
    "wan": ShapeSpec(
        name="wan", slice_size=8,
        ici=LinkSpec(latency_s=2e-6, bandwidth_Bps=40e9, jitter_s=1e-6),
        dcn=LinkSpec(latency_s=5e-3, bandwidth_Bps=100e6, jitter_s=1e-3),
    ),
}


def resolve_shape(raw, slice_size: Optional[int] = None,
                  seed: Optional[int] = None) -> ShapeSpec:
    """A :class:`ShapeSpec` from a preset name, a JSON object string, an
    already-parsed dict, or an existing spec; ``slice_size``/``seed``
    override whatever the source carried."""
    if isinstance(raw, ShapeSpec):
        spec = raw
    elif raw is None or raw == "":
        spec = SHAPE_PRESETS["off"]
    elif isinstance(raw, dict):
        spec = _shape_from_dict(raw)
    elif isinstance(raw, str) and raw.lstrip().startswith("{"):
        spec = _shape_from_dict(json.loads(raw))
    elif isinstance(raw, str) and raw in SHAPE_PRESETS:
        spec = SHAPE_PRESETS[raw]
    else:
        raise ValueError(
            f"unknown link shape {raw!r}; presets: "
            f"{sorted(SHAPE_PRESETS)} (or a JSON object)"
        )
    if slice_size is not None or seed is not None:
        spec = ShapeSpec(
            name=spec.name, ici=spec.ici, dcn=spec.dcn,
            slice_size=spec.slice_size if slice_size is None
            else int(slice_size),
            seed=spec.seed if seed is None else int(seed),
        )
    return spec


def _shape_from_dict(d: dict) -> ShapeSpec:
    def link(sub) -> LinkSpec:
        sub = sub or {}
        return LinkSpec(
            latency_s=float(sub.get("latency_s", 0.0)),
            bandwidth_Bps=float(sub.get("bandwidth_Bps", 0.0)),
            jitter_s=float(sub.get("jitter_s", 0.0)),
        )

    return ShapeSpec(
        name=str(d.get("name", "custom")),
        slice_size=int(d.get("slice_size", 8)),
        ici=link(d.get("ici")), dcn=link(d.get("dcn")),
        seed=int(d.get("seed", 0)),
    )


def classify_link(src: int, dst: int, slice_size: int) -> str:
    """``ici`` when both ranks sit in the same slice of ``slice_size``
    consecutive ranks, ``dcn`` otherwise — the same contiguous-slice
    convention the hierarchical communicator's mesh factory uses."""
    if slice_size <= 0:
        return LINK_ICI
    return (
        LINK_ICI if int(src) // int(slice_size) == int(dst) // int(slice_size)
        else LINK_DCN
    )


def deterministic_jitter(seed: int, src: int, dst: int, hop: int) -> float:
    """Uniform in ``[0, 1)`` as a pure function of the identifiers — the
    jitter term must replay identically, so no RNG state anywhere."""
    digest = hashlib.blake2b(
        struct.pack("<qqqq", int(seed), int(src), int(dst), int(hop)),
        digest_size=8,
    ).digest()
    return struct.unpack("<Q", digest)[0] / 2.0 ** 64


def transfer_time_s(nbytes: int, link: LinkSpec, u: float = 0.0) -> float:
    """Traversal time of one payload over one link: latency + serialization
    (``nbytes / bandwidth``) + ``u`` of the jitter ceiling."""
    t = float(link.latency_s)
    if link.bandwidth_Bps > 0:
        t += float(nbytes) / float(link.bandwidth_Bps)
    if link.jitter_s > 0:
        t += float(u) * float(link.jitter_s)
    return t


class LinkShaper:
    """Applies a :class:`ShapeSpec` to every hop of a world: classify the
    (src, dst) edge, compute the deterministic traversal time, consult the
    fault plan, sleep.  Thread-safe (a worker's intra and inter rings may
    hop concurrently); per-class byte/hop/sleep accounting for the drill
    verdicts."""

    def __init__(self, shape: ShapeSpec, world_size: int,
                 sleep=time.sleep, clock=time.monotonic):
        self.shape = shape
        self.world_size = int(world_size)
        self._sleep = sleep
        self._clock = clock
        self._lock = threading.Lock()
        #: slice index -> cut expiry (monotonic) for live partitions
        self._cuts: Dict[int, float] = {}
        self.stats: Dict[str, Dict[str, float]] = {
            LINK_ICI: {"hops": 0, "bytes": 0, "slept_s": 0.0},
            LINK_DCN: {"hops": 0, "bytes": 0, "slept_s": 0.0},
        }

    # ---- pure maths -----------------------------------------------------

    def classify(self, src: int, dst: int) -> str:
        return classify_link(src, dst, self.shape.slice_size)

    def link(self, src: int, dst: int) -> LinkSpec:
        return (self.shape.ici if self.classify(src, dst) == LINK_ICI
                else self.shape.dcn)

    def delay_s(self, src: int, dst: int, nbytes: int, hop: int = 0) -> float:
        """Deterministic traversal time for this hop (no side effects)."""
        u = deterministic_jitter(self.shape.seed, src, dst, hop)
        return transfer_time_s(nbytes, self.link(src, dst), u)

    # ---- fault composition ---------------------------------------------

    def _slice_of(self, rank: int) -> int:
        size = max(1, self.shape.slice_size)
        return int(rank) // size

    def check_faults(self, src: int, dst: int,
                     step: Optional[int] = None) -> None:
        """Raise if an armed ``podsim.link`` fault condemns this hop: a
        fresh ``drop`` fire eats it outright; a ``partition`` fire opens
        (or an earlier fire sustains) a timed cut of ``spec.rank``'s
        slice's DCN links."""
        plan = _inject.get_plan()
        now = self._clock()
        if plan is not None:
            spec = plan.should_fire(FAULT_POINT, step)
            if spec is not None:
                if spec.kind == "partition":
                    with self._lock:
                        self._cuts[int(spec.rank)] = max(
                            self._cuts.get(int(spec.rank), 0.0),
                            now + float(spec.duration_s),
                        )
                else:
                    raise LinkDropped(
                        f"podsim.link drop: hop {src}->{dst} payload lost "
                        f"(injected)"
                    )
        with self._lock:
            self._cuts = {s: e for s, e in self._cuts.items() if e > now}
            cuts = set(self._cuts)
        if cuts and self.classify(src, dst) == LINK_DCN and (
                self._slice_of(src) in cuts or self._slice_of(dst) in cuts):
            raise LinkSevered(
                f"podsim.link partition: DCN hop {src}->{dst} crosses a "
                f"severed slice ({sorted(cuts)})"
            )

    # ---- the hop --------------------------------------------------------

    def traverse(self, src: int, dst: int, nbytes: int, hop: int = 0,
                 step: Optional[int] = None) -> float:
        """One shaped hop: fault check, deterministic delay, accounting.
        Returns the injected delay in seconds."""
        self.check_faults(src, dst, step=step)
        d = self.delay_s(src, dst, nbytes, hop)
        if d > 0:
            self._sleep(d)
        cls = self.classify(src, dst)
        with self._lock:
            st = self.stats[cls]
            st["hops"] += 1
            st["bytes"] += int(nbytes)
            st["slept_s"] += d
        return d
