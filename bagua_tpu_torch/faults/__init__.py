"""Deterministic fault injection: named points inside the real code paths.

Port of ``bagua_tpu/faults``: the seeded plan machinery
(:mod:`bagua_tpu_torch.faults.inject`) and the hooks of every point: the pod
simulator's shaped links (``podsim.link``), the restart store's
(``store.op``, ``store.failover``), the
lease heartbeat's (``elastic.heartbeat``), the watchdog's waiter
(``collective.hang``), the step's and async model average's boundaries
(``step.straggle``, ``async.partition``), the trainer's accumulated gradient
(``grad.poison``) and the checkpoint's files (``ckpt.write``,
``ckpt.sidecar``).
"""

from .inject import (  # noqa: F401
    FAULT_POINTS,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    InjectedStoreError,
    clear_plan,
    fault_scope,
    get_plan,
    set_plan,
)
