"""The autopilot engine: hosts the pure decision core inside a monitor
loop, actuates through pre-existing machinery, and leaves evidence.

Division of labor:

* :func:`bagua_tpu_torch.autopilot.policy.decide` is the brain — pure, clock-
  and I/O-free, unit-testable without a fleet.
* :class:`AutopilotEngine` is the body: it feeds each coordinator-side
  fleet snapshot to the core, publishes the core's bookkeeping as
  ``autopilot/*`` telemetry, flight-records every decided action with its
  triggering evidence (trigger ``autopilot_action``), persists the policy
  state through the restart TCPStore (a relaunched coordinator resumes
  with cooldowns/rung/quarantines intact instead of re-firing a
  cooled-down action), and — in ``act`` mode only — invokes the actuators
  the HOST wired in.
* The host (``distributed/run.py``'s elastic monitor, the chaos drills,
  the replay CLI) supplies actuators.  Fence/resize are control-flow
  entangled with the monitor loop (they must raise the gang-stop the
  epoch machinery rides), so the host actuates those from the returned
  action list itself; the engine actuates the side-channel kinds it CAN
  own: retune hints (autotune service delivery) and storage quarantine
  (:func:`bagua_tpu_torch.checkpoint.quarantine_storage_path`).

``observe`` mode runs the identical decision path and identical evidence
trail without any actuation — the dry-run rollout contract
(docs/autopilot.md).  Port of ``bagua_tpu/autopilot/engine.py``; the
launcher hosts this.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional

from .. import env as _env
from ..telemetry import counters
from .policy import (
    Action,
    PolicyConfig,
    PolicyState,
    config_from_env,
    decide,
)

logger = logging.getLogger("bagua_tpu_torch.autopilot")

__all__ = ["AutopilotEngine", "deliver_hints_via_service",
           "default_engine_actuators", "STATE_STORE_KEY", "replay"]

#: restart-store key the policy state persists under — deliberately
#: OUTSIDE the epoch-fenced ``elastic/<e>/`` keyspace: cooldowns and the
#: escalation rung must survive epoch bumps and coordinator relaunches
STATE_STORE_KEY = "autopilot/state"

#: restart-store key carrying the ACTUATED storage-quarantine verdicts
#: (newline-separated paths; written only by an act-mode engine).  Kept
#: separate from STATE_STORE_KEY on purpose: the policy state records
#: every quarantine DECISION (observe mode included, for the dry-run
#: log), but only act-mode verdicts may reach workers' checkpoint
#: managers — and EVERY launcher (not just the coordinator's) reads this
#: key at spawn time, so the verdict reaches the nodes actually writing
#: to the rotting storage
QUARANTINE_STORE_KEY = "autopilot/quarantined"


def read_actuated_quarantines(store) -> List[str]:
    """The launcher-side half of :data:`QUARANTINE_STORE_KEY`: the
    storage paths an act-mode engine has quarantined, for injection into
    respawned workers' ``BAGUA_CKPT_QUARANTINED_PATHS``.  Exception-free
    ([] on any store trouble) — callers are spawn paths."""
    try:
        raw = store.get(QUARANTINE_STORE_KEY)
    except Exception:  # noqa: BLE001 - store may be down mid-teardown
        return []
    if not raw:
        return []
    text = raw.decode() if isinstance(raw, bytes) else str(raw)
    return [p.strip() for p in text.splitlines() if p.strip()]

#: decided-action kind -> its telemetry counter
_KIND_COUNTERS = {
    "fence": "autopilot/fences",
    "retune_hint": "autopilot/retunes",
    "retune": "autopilot/retunes",
    "switch_family": "autopilot/family_switches",
    "resize": "autopilot/resizes",
    "quarantine_storage": "autopilot/quarantines",
    "compress_dcn": "autopilot/compress_hints",
}

#: core-bookkeeping key -> telemetry counter (diff-published per snapshot)
_STATE_COUNTERS = {
    "snapshots": "autopilot/snapshots",
    "stale_snapshots": "autopilot/stale_snapshots",
    "decisions": "autopilot/decisions",
    "suppressed_cooldown": "autopilot/suppressed_cooldown",
    "suppressed_budget": "autopilot/suppressed_budget",
}


def deliver_hints_via_service(model_name: str, hints: List[dict],
                              addr: Optional[str] = None) -> bool:
    """Deliver autopilot perf hints to the autotune sidecar through the
    EXISTING channel — ``AutotuneClient.report_metrics(perf_hints=)`` with
    the controller rank (-1), which the service excludes from speed
    scoring.  The trainers then receive any resulting recommendation at
    their normal check-ins: no new control path into the step."""
    from ..service.autotune_service import AutotuneClient

    addr = addr or _env.get_autotune_server_addr()
    if not addr:
        logger.warning("autopilot: no autotune service address; hint "
                       "dropped: %s", hints)
        return False
    host, port = addr.rsplit(":", 1)
    try:
        AutotuneClient(host, int(port)).report_metrics(
            model_name=model_name, rank=-1, train_iter=-1,
            hyperparameters={}, speed=0.0, perf_hints=hints,
        )
        return True
    except (ConnectionError, OSError) as e:
        logger.warning("autopilot: hint delivery failed: %s", e)
        return False


class AutopilotEngine:
    """One engine per coordinator process.  ``actuators`` maps action
    kinds to callables ``(Action) -> bool`` (actuated?); kinds without an
    actuator are returned to the caller (the monitor loop actuates
    fence/resize itself because they raise its gang-stop)."""

    def __init__(self, config: Optional[PolicyConfig] = None,
                 actuators: Optional[Dict[str, Callable]] = None,
                 store=None):
        self.config = config or config_from_env()
        self.actuators = dict(actuators or {})
        self._store = store
        self.state = PolicyState()
        self._published: Dict[str, int] = {}
        if store is not None:
            self._load_state(store)

    # ---- restart-idempotence: policy state on the restart store ---------

    def _load_state(self, store) -> None:
        try:
            raw = store.get(STATE_STORE_KEY)
        except Exception as e:  # noqa: BLE001 - store may be coming up
            logger.debug("autopilot state not loaded: %s", e)
            return
        if raw is None:
            return
        try:
            self.state = PolicyState.from_json(raw)
            # published watermark syncs to the loaded cumulative counts so
            # a relaunch does not re-publish the previous life's events
            self._published = dict(self.state.counters)
            logger.info(
                "autopilot: resumed policy state (rung %d, %d action(s) "
                "taken, %d quarantined path(s))", self.state.rung,
                self.state.actions_taken, len(self.state.quarantined),
            )
        except (ValueError, TypeError, KeyError) as e:
            logger.warning("autopilot: persisted state unreadable (%s); "
                           "starting fresh", e)
            return
        if self.config.mode == "act" and self.state.quarantined:
            # re-actuate persisted quarantine verdicts into this process's
            # registry: the decision fired once and is deduped by the
            # policy state, so a relaunched coordinator — or one whose
            # operator flipped observe -> act — must apply it here instead
            # of never again
            try:
                from ..checkpoint import quarantine_storage_path

                for path in self.state.quarantined:
                    quarantine_storage_path(path)
            except Exception as e:  # noqa: BLE001 - keep monitoring
                logger.warning("autopilot: quarantine re-apply failed: %s",
                               e)

    def _persist_state(self) -> None:
        if self._store is None:
            return
        try:
            self._store.set(STATE_STORE_KEY, self.state.to_json())
            if self.config.mode == "act":
                # actuated verdicts only: observe-mode decisions must stay
                # a log, not reach workers' checkpoint managers
                self._store.set(QUARANTINE_STORE_KEY,
                                "\n".join(self.state.quarantined))
            counters.incr("autopilot/state_persists")
        except Exception as e:  # noqa: BLE001 - monitoring must not die
            logger.debug("autopilot state not persisted: %s", e)

    # ---- the loop body ---------------------------------------------------

    def observe_snapshot(self, snapshot: dict,
                         now: Optional[float] = None) -> List[Action]:
        """Evaluate one fleet snapshot; returns the decided actions (after
        engine-side actuation of the kinds it owns).  The caller actuates
        any remaining control-flow kinds (fence/resize) and may consult
        :attr:`state` afterwards."""
        now = time.time() if now is None else float(now)
        actions, self.state = decide(snapshot, self.state, self.config, now)
        self._publish_counters()
        for action in actions:
            counters.incr(_KIND_COUNTERS[action.kind])
            self._flight_record(action, snapshot)
            logger.warning("autopilot decision [%s]: %s (%s)",
                           self.config.mode, action.kind, action.reason)
        if self.config.mode == "act":
            for action in actions:
                fn = self.actuators.get(action.kind)
                if fn is None:
                    continue  # caller-actuated kind (fence/resize)
                try:
                    if fn(action):
                        counters.incr("autopilot/actions_actuated")
                except Exception as e:  # noqa: BLE001 - keep monitoring
                    logger.warning("autopilot: actuation of %s failed: %s",
                                   action.kind, e)
        elif actions:
            counters.incr_many({"autopilot/observed_only": len(actions)})
        counters.set_gauge("autopilot/escalation_rung", self.state.rung)
        if actions:
            # persist at action time: cooldowns/rung/quarantines are what a
            # relaunched coordinator must not forget (between actions, a
            # lost streak merely re-earns its hysteresis — conservative)
            self._persist_state()
        return actions

    def note_actuated(self, action: Action) -> None:
        """Caller hook for host-actuated kinds (fence/resize): count the
        actuation and persist — the gang is about to stop, and the next
        coordinator life must see this action's cooldown."""
        counters.incr("autopilot/actions_actuated")
        self._persist_state()

    def _publish_counters(self) -> None:
        """Diff the core's cumulative bookkeeping into telemetry (the core
        is pure and cannot touch counters itself)."""
        deltas = {}
        for key, metric in _STATE_COUNTERS.items():
            have = self.state.counters.get(key, 0)
            seen = self._published.get(key, 0)
            if have > seen:
                deltas[metric] = have - seen
            self._published[key] = have
        if deltas:
            counters.incr_many(deltas)

    def _flight_record(self, action: Action, snapshot: dict) -> None:
        """Every decision leaves its post-mortem artifact: the action, its
        evidence, and the snapshot epoch it judged."""
        from ..obs.recorder import dump_flight_record

        dump_flight_record(
            "autopilot_action",
            reason=f"{action.rule}: {action.reason}",
            extra={
                "action": action.to_json(),
                "mode": self.config.mode,
                "snapshot_epoch": snapshot.get("epoch"),
                "snapshot_time_unix": snapshot.get("time_unix"),
                "rung": self.state.rung,
                "actions_taken": self.state.actions_taken,
            },
        )


def default_engine_actuators(model_name: Optional[str] = None,
                             autotune_addr: Optional[str] = None
                             ) -> Dict[str, Callable]:
    """The engine-owned actuators for production wiring: retune kinds
    deliver perf hints to the autotune service; quarantine marks the path
    in this process's checkpoint registry (the launcher additionally
    injects it into respawned workers' env — see distributed/run.py).
    Fence/resize are deliberately absent: the monitor loop owns them."""
    model = model_name or _env.get_autopilot_model()

    def _hint(action: Action) -> bool:
        kind_map = {
            "retune_hint": "autopilot_retune_hint",
            "retune": "autopilot_retune",
            "switch_family": "autopilot_switch_family",
            "compress_dcn": "autopilot_compress_dcn",
        }
        hint = {
            "kind": kind_map[action.kind],
            "rule": action.rule,
            "reason": action.reason,
        }
        if action.kind in ("switch_family", "compress_dcn"):
            hint["family"] = action.target
        if action.kind == "compress_dcn":
            # the codec the service actuates onto recommended.compress_inter
            # (every rank's next check-in re-jits the compressed DCN hops)
            hint["codec"] = (action.evidence or {}).get(
                "codec") or "minmax_uint8"
            # v2 search tasks turn the observed dominance into coordinate
            # weighting instead of a pin (priors, not pins)
            share = (action.evidence or {}).get("dcn_share_max")
            if share is not None:
                hint["dcn_share"] = share
        return deliver_hints_via_service(model, [hint], addr=autotune_addr)

    def _quarantine(action: Action) -> bool:
        from ..checkpoint import quarantine_storage_path

        quarantine_storage_path(action.target)
        return True

    return {
        "retune_hint": _hint,
        "retune": _hint,
        "switch_family": _hint,
        "compress_dcn": _hint,
        "quarantine_storage": _quarantine,
    }


def replay(snapshots: List[dict], config: PolicyConfig,
           state: Optional[PolicyState] = None,
           historian=None) -> List[dict]:
    """Replay a recorded fleet snapshot stream against the policy matrix
    (operator CLI + the CI smoke stage).  Each snapshot is evaluated with
    ``now`` = its own ``time_unix`` (so a recorded stream replays
    identically regardless of when the operator runs it) and NOTHING
    actuates — replay is a pure rehearsal.  With ``historian`` (a fresh
    :class:`bagua_tpu_torch.obs.historian.Historian`), each snapshot is first
    ingested and trend-augmented exactly as the live coordinator would —
    the only way the trend rules (``hbm_exhaustion``/``dcn_dominance``)
    can fire in a replay, and deterministic because historian samples are
    timestamped by the records' own ``time_unix``.  Snapshots are
    deep-copied before augmentation; the caller's stream is never
    mutated.  Returns the decision log: one entry per snapshot with the
    decided actions."""
    import copy

    state = state or PolicyState()
    log: List[dict] = []
    for i, snap in enumerate(snapshots):
        if historian is not None:
            snap = historian.ingest(copy.deepcopy(snap))
        now = float(snap.get("time_unix") or 0.0)
        actions, state = decide(snap, state, config, now)
        log.append({
            "snapshot": i,
            "time_unix": snap.get("time_unix"),
            "epoch": snap.get("epoch"),
            "actions": [a.to_json() for a in actions],
            "rung": state.rung,
            "actions_taken": state.actions_taken,
        })
    return log
