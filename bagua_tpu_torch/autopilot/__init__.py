"""Closed-loop fleet autopilot: the coordinator-side policy engine that
makes the observability plane act (docs/autopilot.md).

* :mod:`bagua_tpu_torch.autopilot.policy` — the pure decision core
  ``(fleet_snapshot, policy_state) -> (actions, policy_state)``.
* :mod:`bagua_tpu_torch.autopilot.engine` — the monitor-loop host: staleness
  guard, telemetry, flight recording, restart-store state persistence,
  actuation.
* ``python -m bagua_tpu_torch.autopilot --replay`` — operator CLI replaying a
  recorded fleet snapshot stream against the current policy.
"""

from .engine import (  # noqa: F401
    AutopilotEngine,
    STATE_STORE_KEY,
    default_engine_actuators,
    deliver_hints_via_service,
    replay,
)
from .policy import (  # noqa: F401
    ACTION_KINDS,
    LADDER,
    Action,
    PolicyConfig,
    PolicyState,
    config_from_env,
    decide,
)
