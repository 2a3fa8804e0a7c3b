"""Seeded fault-injection registry.

Port of the plan machinery of ``bagua_tpu/faults/inject.py`` (``:82-400``)
and of its ``async.partition`` (``:542-551``) and ``grad.poison`` hooks.  A
plan is a list of :class:`FaultSpec` armed from ``BAGUA_FAULT_PLAN`` (a JSON
list of specs, so a test can arm a fault in one rank's environment only) or in
code
(:func:`fault_scope`, :func:`set_plan`).  Triggers are step numbers or op
counts, so a run with faults repeats exactly.  Every armed, fired and
recovered event counts in :data:`bagua_tpu_torch.telemetry.counters` under
``faults/<point>/{armed,fired,recovered}``.  While no plan is armed a hook
costs one ``None`` check.

``FAULT_POINTS`` names every point of the JAX package, so that one plan reads
the same in both; the hooks of the other points come with the modules that
reach them.

``async.partition``: drops a rank from one async-model-average round.  The
rank still takes part in the negotiation and the averaging collective (every
rank must run the same collectives in the same order), but never applies the
round launched at the fired boundary, so its applied-round count stalls and
the bounded-staleness tracker must force a catch-up average.

``grad.poison``: the trainer writes NaN (or inf) into the first element of a
bucket's accumulated gradient before any communication.  It is keyed on
``TrainState.step``, not on a call counter, with the JAX package's window
semantics (its fault is traced into the compiled step): ``step=K`` fires
exactly at step K, ``step=None`` on the first ``count`` steps (every step
when ``count < 0``).  The trainer reads the armed specs with
:func:`armed_traced_specs` and counts each fire with
:func:`note_traced_fire`.
"""

from __future__ import annotations

import json
import logging
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from .. import env as _env
from ..telemetry import counters

logger = logging.getLogger(__name__)

FAULT_POINTS = (
    "store.op",
    "elastic.heartbeat",
    "ckpt.write",
    "ckpt.sidecar",
    "collective.hang",
    "grad.poison",
    "step.straggle",
    "async.partition",
    "podsim.link",
    "store.failover",
)

#: default fault kind per point (the only kind most points support)
_DEFAULT_KINDS = {
    "store.op": "error",
    "elastic.heartbeat": "drop",
    "ckpt.write": "corrupt",
    "ckpt.sidecar": "truncate",
    "collective.hang": "hang",
    "grad.poison": "nan",
    "step.straggle": "dilate",
    "async.partition": "drop",
    "podsim.link": "drop",
    "store.failover": "error",
}

_VALID_KINDS = {
    "store.op": ("error",),
    "elastic.heartbeat": ("drop",),
    "ckpt.write": ("corrupt", "torn"),
    "ckpt.sidecar": ("truncate", "corrupt"),
    "collective.hang": ("hang",),
    "grad.poison": ("nan", "inf"),
    "step.straggle": ("dilate",),
    "async.partition": ("drop",),
    "podsim.link": ("drop", "partition"),
    "store.failover": ("error",),
}


@dataclass(frozen=True)
class FaultSpec:
    """One armed fault.  ``step`` triggers step-keyed points (None: any
    step); ``op`` triggers op-count points from that query on (0: the
    first).  ``count`` bounds the fires (-1: unlimited); ``seed`` drives
    every random choice.  The other fields belong to points whose hooks are
    not ported yet; they are kept so that a plan reads as in the JAX
    package."""

    point: str
    kind: str = ""
    step: Optional[int] = None
    op: int = 0
    count: int = 1
    seed: int = 0
    bucket: int = 0          # grad.poison: target bucket index
    duration_s: float = 30.0  # collective.hang: how long to wedge
    rank: int = 0            # step.straggle: which process rank is slow
    factor: float = 10.0     # step.straggle: dilation multiple of base time
    base_ms: float = 0.0     # step.straggle: the straggler's base step time

    def __post_init__(self):
        if self.point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {self.point!r}; valid: {FAULT_POINTS}")
        kind = self.kind or _DEFAULT_KINDS[self.point]
        object.__setattr__(self, "kind", kind)
        if kind not in _VALID_KINDS[self.point]:
            raise ValueError(f"fault kind {kind!r} invalid for {self.point!r}; valid: "
                             f"{_VALID_KINDS[self.point]}")
        if self.point == "step.straggle" and self.factor < 1.0:
            raise ValueError(f"step.straggle factor must be >= 1.0, got {self.factor}")


class FaultPlan:
    """Armed :class:`FaultSpec` s with each spec's op and fire counts.
    Thread-safe."""

    def __init__(self, specs):
        self.specs: Tuple[FaultSpec, ...] = tuple(
            s if isinstance(s, FaultSpec) else FaultSpec(**s) for s in specs)
        self._lock = threading.Lock()
        self._ops: Dict[int, int] = {i: 0 for i in range(len(self.specs))}
        self._fires: Dict[int, int] = {i: 0 for i in range(len(self.specs))}

    @classmethod
    def from_json(cls, raw: str) -> "FaultPlan":
        data = json.loads(raw)
        if isinstance(data, dict):
            data = [data]
        if not isinstance(data, list):
            raise ValueError("BAGUA_FAULT_PLAN must be a JSON list of fault specs")
        return cls(data)

    def arm(self) -> None:
        armed: Dict[str, int] = {}
        for s in self.specs:
            key = f"faults/{s.point}/armed"
            armed[key] = armed.get(key, 0) + 1
        counters.incr_many(armed)
        if self.specs:
            logger.warning("fault injection ARMED (%d specs): %s (drills and tests only)",
                           len(self.specs),
                           ", ".join(f"{s.point}:{s.kind}" for s in self.specs))

    def should_fire(self, point: str, step: Optional[int] = None) -> Optional[FaultSpec]:
        """Query and advance: the spec that fires at this call (its fire
        recorded), else None.  A step-keyed spec fires when ``step``
        matches; an op-keyed one counts queries and fires from query
        ``spec.op`` on, for ``spec.count`` queries."""
        fired: Optional[FaultSpec] = None
        fire_no = 0
        with self._lock:
            for i, s in enumerate(self.specs):
                if s.point != point:
                    continue
                if s.count >= 0 and self._fires[i] >= s.count:
                    continue
                if s.step is not None:
                    if step is None or int(step) != int(s.step):
                        continue
                else:
                    idx = self._ops[i]
                    self._ops[i] = idx + 1
                    if idx < s.op:
                        continue
                self._fires[i] += 1
                fired, fire_no = s, self._fires[i]
                break
        if fired is None:
            return None
        counters.incr(f"faults/{point}/fired")
        logger.warning("fault injection: %s fired (kind=%s, fire %d/%s)", point, fired.kind,
                       fire_no, "inf" if fired.count < 0 else fired.count)
        return fired

    def note_traced_fire(self, spec: FaultSpec) -> None:
        """Count a fire of a step-keyed point the trainer applies itself
        (``grad.poison``), which :meth:`should_fire` does not see."""
        with self._lock:
            for i, s in enumerate(self.specs):
                if s is spec:
                    self._fires[i] += 1
        counters.incr(f"faults/{spec.point}/fired")
        logger.warning("fault injection: %s fired in-step (kind=%s)", spec.point, spec.kind)

    def fired(self, point: str) -> bool:
        with self._lock:
            return any(self._fires[i] > 0 for i, s in enumerate(self.specs) if s.point == point)

    def armed_specs(self, point: str) -> Tuple[FaultSpec, ...]:
        return tuple(s for s in self.specs if s.point == point)


# -- the process's plan ---------------------------------------------------------

_PLAN: Optional[FaultPlan] = None
_ENV_CHECKED = False
_GLOBAL_LOCK = threading.Lock()


def get_plan() -> Optional[FaultPlan]:
    """The active plan: the one installed in code, else the
    ``BAGUA_FAULT_PLAN`` plan (parsed and armed once), else None."""
    global _PLAN, _ENV_CHECKED
    if _PLAN is not None:
        return _PLAN
    if _ENV_CHECKED:
        return None
    with _GLOBAL_LOCK:
        if not _ENV_CHECKED:
            _ENV_CHECKED = True
            raw = _env.get_fault_plan_raw()
            if raw:
                try:
                    plan = FaultPlan.from_json(raw)
                except (ValueError, TypeError) as e:
                    raise ValueError(f"BAGUA_FAULT_PLAN is not a valid fault plan: {e}") from e
                plan.arm()
                _PLAN = plan
    return _PLAN


def set_plan(plan: Optional[FaultPlan]) -> None:
    """Install (and arm) a plan in code; None disarms.  The environment's
    plan is not read after this."""
    global _PLAN, _ENV_CHECKED
    with _GLOBAL_LOCK:
        _ENV_CHECKED = True
        _PLAN = plan
    if plan is not None:
        plan.arm()


def clear_plan() -> None:
    """Disarm everything and forget that the environment's plan was read
    (the next :func:`get_plan` reads ``BAGUA_FAULT_PLAN`` again)."""
    global _PLAN, _ENV_CHECKED
    with _GLOBAL_LOCK:
        _PLAN = None
        _ENV_CHECKED = False


@contextmanager
def fault_scope(*specs):
    """Arm the given specs (or one :class:`FaultPlan`) for the block and
    restore the previous plan after it::

        with fault_scope(FaultSpec("async.partition", count=-1)):
            ...   # every round launched here is dropped on this rank
    """
    plan = specs[0] if len(specs) == 1 and isinstance(specs[0], FaultPlan) else FaultPlan(specs)
    global _PLAN, _ENV_CHECKED
    with _GLOBAL_LOCK:
        prev, prev_checked = _PLAN, _ENV_CHECKED
        _PLAN = plan
        _ENV_CHECKED = True
    plan.arm()
    try:
        yield plan
    finally:
        with _GLOBAL_LOCK:
            _PLAN, _ENV_CHECKED = prev, prev_checked


# -- hooks called by the code paths (no-ops while nothing is armed) -------------


def should_fire(point: str, step: Optional[int] = None) -> Optional[FaultSpec]:
    plan = get_plan()
    return plan.should_fire(point, step=step) if plan is not None else None


def record_recovery(point: str) -> None:
    """A defense calls this after it recovered from a fault it knows may
    have been injected; counts only where the point has fired."""
    plan = _PLAN
    if plan is not None and plan.fired(point):
        counters.incr(f"faults/{point}/recovered")


def armed_traced_specs(point: str) -> Tuple[FaultSpec, ...]:
    """The armed specs of a point the trainer applies on its own step
    number (``grad.poison``), whatever their fire counts."""
    plan = get_plan()
    return plan.armed_specs(point) if plan is not None else ()


def note_traced_fire(spec: FaultSpec) -> None:
    plan = _PLAN
    if plan is not None:
        plan.note_traced_fire(spec)


def maybe_drop_negotiation_round() -> bool:
    """``async.partition`` hook (async model average's boundary): True when
    this rank is partitioned out of the round launched at this boundary."""
    return should_fire("async.partition") is not None
