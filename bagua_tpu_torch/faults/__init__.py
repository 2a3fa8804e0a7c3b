"""Deterministic fault injection: named points inside the real code paths.

Port of ``bagua_tpu/faults``: the seeded plan machinery
(:mod:`bagua_tpu_torch.faults.inject`) and the two points the port reaches so
far, ``async.partition`` (async model average's negotiated boundary) and
``grad.poison`` (the trainer's accumulated gradient).
"""

from .inject import (  # noqa: F401
    FAULT_POINTS,
    FaultPlan,
    FaultSpec,
    clear_plan,
    fault_scope,
    get_plan,
    set_plan,
)
