"""The autopilot's pure decision core: (fleet_snapshot, policy_state) ->
(actions, policy_state).

PRs 6-12 built a complete sense layer — per-rank ``straggler_suspect`` with
phase blame, health beacons and fencing, the goodput/badput ledger and
fleet efficiency rollup, checkpoint-integrity fallback counters, a crash
flight recorder — but the only automated actuation was the unhealthy-rank
fence.  For unattended multi-day runs on preemptible capacity (the
MegaScale operations story, arXiv 2402.15627, whose goodput lens the
ledger already uses) the coordinator must close the loop itself: Bagua's
thesis of system relaxations (arXiv 2107.01499) only pays off at fleet
scale when degradation triggers a cheap adaptation instead of a human
page.

Policy matrix (evidence -> action, every actuation through machinery that
already exists — no new control paths into the step):

=====================  ==========================================  =======
rule                   evidence (``bagua-obs-fleet-v1`` snapshot)  action
=====================  ==========================================  =======
``chronic_straggler``  dispatch-dominant ``straggler_suspect``     fence
                       (ratio >= straggler_ratio, fresh within     (world
                       suspect_ttl_s) sustained ``sustain``        resizes
                       snapshots                                   down)
``collective_victim``  collective-dominant suspect sustained       retune
                       (a rank WAITING on someone — the knobs,     hint
                       not the host, may be wrong)
``slo_breach``         fleet min goodput fraction < slo_goodput    ladder:
                       sustained ``sustain`` snapshots; each rung  hint ->
                       requires a fresh sustained window           retune ->
                                                                   switch ->
                                                                   resize
``ckpt_integrity``     a rank's integrity_failures +               storage
                       fallback_restores >= ckpt_failures          quarantine
``hbm_exhaustion``     historian trend: negative HBM-headroom      pre-OOM
                       slope projecting exhaustion within          resize
                       hbm_horizon_s (trends.hbm_headroom_eta_s)   (node
                       sustained ``sustain`` snapshots             removed)
``dcn_dominance``      historian trend: DCN device seconds >=      compress
                       dcn_share of the step wall                  hint
                       (trends.dcn_comm_share) sustained           (slow
                       ``sustain`` snapshots                       tier)
=====================  ==========================================  =======

The two trend rules consume the ``trends`` sub-dicts the telemetry
historian (:mod:`bagua_tpu_torch.obs.historian`) publishes into each rank's
obs summary — windowed least-squares derivatives, not point-in-time
readings.  Without the historian (``BAGUA_OBS_HISTORIAN=off``, the
default) no snapshot carries trends and neither rule can fire: the
rules are provably inert until the operator turns the memory on.

Every rule carries hysteresis: ``sustain`` consecutive snapshots to
trigger, per-action-kind cooldowns, and a global action budget.
Precedence: a fence beats a retune for the same rank — a host being
removed must not also be "fixed" by a knob change.  The core is a pure
function of (snapshot, state, config, now): no I/O, no clocks, no
telemetry — the engine (:mod:`bagua_tpu_torch.autopilot.engine`) supplies the
wall clock, publishes the counter deltas recorded in ``state.counters``,
and actuates.  Port of ``bagua_tpu/autopilot/policy.py``; the
coordinator's launcher hosts it.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

from .. import env as _env
from ..obs.anomaly import fleet_straggler_suspects

__all__ = [
    "Action", "PolicyConfig", "PolicyState", "decide",
    "ACTION_KINDS", "LADDER", "config_from_env",
]

#: every action kind the matrix can emit (cooldowns are tracked per kind)
ACTION_KINDS = ("fence", "retune_hint", "retune", "switch_family",
                "resize", "quarantine_storage", "compress_dcn")

#: the SLO escalation ladder, cheapest adaptation first: rung N's action
#: fires only after rung N-1 fired AND the breach sustained through a
#: fresh hysteresis window
LADDER = ("retune_hint", "retune", "switch_family", "resize")


@dataclass(frozen=True)
class Action:
    """One decided adaptation: what to do, to whom, and the evidence that
    condemned them (flight-recorded verbatim)."""

    kind: str          # one of ACTION_KINDS
    rule: str          # which matrix row fired
    target: Any        # node id list / rank / storage path / family name
    reason: str
    evidence: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return asdict(self)


@dataclass(frozen=True)
class PolicyConfig:
    """The matrix's knobs — built from the env registry by
    :func:`config_from_env`, or passed explicitly (tests, replays)."""

    mode: str = "off"                 # off | observe | act
    sustain: int = 3                  # consecutive snapshots to trigger
    cooldown_s: float = 300.0         # per-action-kind cooldown
    budget: int = 8                   # global action budget per run
    staleness_s: float = 60.0         # snapshot freshness bound
    slo_goodput: float = 0.0          # 0 disables the SLO ladder
    straggler_ratio: float = 3.0      # min suspect ratio counted
    suspect_ttl_s: float = 120.0      # suspect evidence freshness
    ckpt_failures: int = 3            # integrity events before quarantine
    switch_family: str = "async"      # the ladder's switch rung target
    dcn_share: float = 0.5            # trend rule: DCN share of the step
    compress_family: str = "bytegrad"  # the compression hint's family
    compress_codec: str = "minmax_uint8"  # DCN wire codec the hint actuates
    hbm_horizon_s: float = 600.0      # trend rule: pre-OOM projection


def config_from_env() -> PolicyConfig:
    return PolicyConfig(
        mode=_env.get_autopilot_mode(),
        sustain=max(1, _env.get_autopilot_sustain()),
        cooldown_s=_env.get_autopilot_cooldown_s(),
        budget=_env.get_autopilot_budget(),
        staleness_s=_env.get_autopilot_staleness_s(),
        slo_goodput=_env.get_autopilot_slo_goodput(),
        straggler_ratio=_env.get_autopilot_straggler_ratio(),
        suspect_ttl_s=_env.get_autopilot_suspect_ttl_s(),
        ckpt_failures=_env.get_autopilot_ckpt_failures(),
        switch_family=_env.get_autopilot_family(),
        dcn_share=_env.get_autopilot_dcn_share(),
        compress_family=_env.get_autopilot_compress_family(),
        compress_codec=_env.get_autopilot_compress_codec(),
        hbm_horizon_s=_env.get_autopilot_hbm_horizon_s(),
    )


@dataclass
class PolicyState:
    """Everything the matrix remembers between snapshots — JSON-round-trip
    serializable so a relaunched coordinator resumes with its cooldowns,
    escalation rung, and quarantined paths intact (persisted through the
    restart TCPStore by the engine)."""

    #: rule/target -> consecutive qualifying snapshots
    streaks: Dict[str, int] = field(default_factory=dict)
    #: action kind -> wall time (unix) it last fired (cooldowns compare
    #: wall clock, never monotonic: the state crosses process restarts)
    last_action_unix: Dict[str, float] = field(default_factory=dict)
    actions_taken: int = 0
    #: SLO ladder rung reached (0 = healthy; index into LADDER is rung-1)
    rung: int = 0
    #: codec-ladder rung for the compress_dcn hint (0 = the configured
    #: start codec): each sustained RE-breach of DCN dominance after an
    #: actuated hint escalates one rung along
    #: ``bagua_tpu_torch.compression.codecs.CODEC_LADDER`` (uint8 -> fp8 ->
    #: onebit_ef -> topk) — more aggressive wire formats until the DCN
    #: share drops below the threshold; unwinds when dominance clears
    codec_rung: int = 0
    #: consecutive healthy (non-breaching) snapshots — de-escalation timer
    slo_clear_streak: int = 0
    #: storage paths already quarantined (idempotence)
    quarantined: List[str] = field(default_factory=list)
    #: time_unix of the last snapshot evaluated (duplicate-write guard:
    #: re-reading one snapshot must not advance any sustain streak)
    last_snapshot_unix: Optional[float] = None
    #: cumulative bookkeeping the engine diffs into telemetry counters
    counters: Dict[str, int] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, raw) -> "PolicyState":
        d = json.loads(raw)
        known = {f for f in cls.__dataclass_fields__}  # noqa: C401
        return cls(**{k: v for k, v in d.items() if k in known})

    def _count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n


def _fresh_suspects(snapshot: dict, config: PolicyConfig,
                    now: float) -> Tuple[List[dict], List[dict]]:
    """Straggler/victim suspects that are strong (ratio) and fresh (ttl)
    enough to count as live evidence.  Reuses the coordinator-side
    analysis the fleet snapshot was built for."""
    named = fleet_straggler_suspects(snapshot)

    def live(items):
        out = []
        for it in items:
            s = it.get("suspect") or {}
            ratio = s.get("ratio") or 0.0
            detected = s.get("detected_at_unix")
            if ratio < config.straggler_ratio:
                continue
            if detected is not None and now - float(detected) \
                    > config.suspect_ttl_s:
                continue
            out.append(it)
        return out

    return live(named["stragglers"]), live(named["victims"])


def _goodput_min(snapshot: dict) -> Optional[float]:
    eff = snapshot.get("efficiency") or {}
    v = eff.get("goodput_fraction_min")
    return float(v) if v is not None else None


def _ckpt_evidence(snapshot: dict, config: PolicyConfig) -> List[dict]:
    """Ranks whose checkpoint-integrity event count crossed the quarantine
    threshold, with the storage path their manager reported."""
    out = []
    for node_id, entry in (snapshot.get("ranks") or {}).items():
        for rank_id, summary in (entry.get("obs") or {}).items():
            if not isinstance(summary, dict):
                continue
            events = int(summary.get("ckpt_integrity_failures", 0) or 0) + \
                int(summary.get("ckpt_fallback_restores", 0) or 0)
            path = summary.get("ckpt_directory")
            if events >= config.ckpt_failures and path:
                out.append({"node": int(node_id), "rank": rank_id,
                            "path": str(path), "events": events})
    return out


def _trend_evidence(snapshot: dict) -> List[dict]:
    """Per-rank historian trends from the snapshot ((node, rank, trends)
    records).  Present only when the telemetry historian augmented the
    record — a point-in-time snapshot carries no trends and the trend
    rules stay inert."""
    out = []
    for node_id, entry in (snapshot.get("ranks") or {}).items():
        for rank_id, summary in (entry.get("obs") or {}).items():
            if not isinstance(summary, dict):
                continue
            trends = summary.get("trends")
            if isinstance(trends, dict) and trends:
                out.append({"node": int(node_id), "rank": str(rank_id),
                            "trends": trends})
    return out


def _bump_streak(state: PolicyState, key: str, active: bool) -> int:
    """Advance (or reset) one sustain streak; returns the new count."""
    if active:
        state.streaks[key] = state.streaks.get(key, 0) + 1
    else:
        state.streaks.pop(key, None)
    return state.streaks.get(key, 0)


def _gate(state: PolicyState, config: PolicyConfig, kind: str,
          now: float) -> Optional[str]:
    """Why an action of ``kind`` may NOT fire right now (None = clear):
    the cooldown/budget half of the hysteresis contract."""
    if config.budget <= 0 or state.actions_taken >= config.budget:
        state._count("suppressed_budget")
        return "budget_exhausted"
    last = state.last_action_unix.get(kind)
    if last is not None and now - last < config.cooldown_s:
        state._count("suppressed_cooldown")
        return "cooldown"
    return None


def _emit(state: PolicyState, actions: List[Action], action: Action,
          now: float) -> None:
    state.last_action_unix[action.kind] = now
    state.actions_taken += 1
    state._count("decisions")
    actions.append(action)


def _worst_goodput_node(snapshot: dict) -> Optional[Tuple[int, str, float]]:
    """(node_id, rank_id, goodput) of the fleet's worst-goodput rank — the
    ladder's resize rung removes its node."""
    worst = None
    for node_id, entry in (snapshot.get("ranks") or {}).items():
        for rank_id, summary in (entry.get("obs") or {}).items():
            if not isinstance(summary, dict):
                continue
            gf = summary.get("goodput_fraction")
            if gf is None:
                continue
            if worst is None or float(gf) < worst[2]:
                worst = (int(node_id), str(rank_id), float(gf))
    return worst


def decide(snapshot: dict, state: PolicyState, config: PolicyConfig,
           now: float) -> Tuple[List[Action], PolicyState]:
    """Run the policy matrix over one fleet snapshot.

    Pure: consumes the snapshot dict, the previous :class:`PolicyState`,
    the config, and the caller's wall clock; returns the decided actions
    and the NEW state (the input state is never mutated).  ``mode`` is not
    consulted here — observe vs act is the engine's actuation gate; the
    decision log must be identical in both so a dry-run rehearses the real
    policy.
    """
    state = replace(
        state,
        streaks=dict(state.streaks),
        last_action_unix=dict(state.last_action_unix),
        quarantined=list(state.quarantined),
        counters=dict(state.counters),
    )
    actions: List[Action] = []
    state._count("snapshots")

    # ---- staleness guard: refuse to act on old evidence -----------------
    snap_time = snapshot.get("time_unix")
    if snap_time is None or now - float(snap_time) > config.staleness_s:
        state._count("stale_snapshots")
        return [], state
    # duplicate-write guard: the monitor may re-read one snapshot faster
    # than the writer refreshes it; a re-read is not new evidence and must
    # not advance any sustain streak
    if state.last_snapshot_unix is not None \
            and float(snap_time) <= state.last_snapshot_unix:
        return [], state
    state.last_snapshot_unix = float(snap_time)

    stragglers, victims = _fresh_suspects(snapshot, config, now)

    # ---- rule 1: chronic dispatch-dominant straggler -> fence -----------
    straggler_nodes = {it["node"] for it in stragglers}
    fenced_nodes: set = set()
    for node in sorted(straggler_nodes):
        streak = _bump_streak(state, f"straggler/{node}", True)
        if streak < config.sustain:
            continue
        why = _gate(state, config, "fence", now)
        if why is not None:
            continue
        evidence = [it for it in stragglers if it["node"] == node]
        _emit(state, actions, Action(
            kind="fence", rule="chronic_straggler", target=[node],
            reason=(f"node {node}: dispatch-dominant straggler suspect "
                    f"sustained {streak} snapshots "
                    f"(ratio {evidence[0]['suspect'].get('ratio')})"),
            evidence={"suspects": evidence, "streak": streak},
        ), now)
        fenced_nodes.add(node)
        state.streaks.pop(f"straggler/{node}", None)
    # nodes no longer suspect: clear their streaks
    for key in [k for k in state.streaks
                if k.startswith("straggler/")
                and int(k.split("/", 1)[1]) not in straggler_nodes]:
        state.streaks.pop(key, None)

    trend_items = _trend_evidence(snapshot)

    # ---- rule 1b: shrinking HBM headroom -> pre-OOM resize-down ---------
    # historian evidence only: a rank whose windowed headroom slope is
    # negative and projects exhaustion within the horizon gets its node
    # removed at a restart boundary BEFORE the OOM kills the gang
    # mid-collective (an OOM is a crash-loop; a resize is one rendezvous)
    hbm_nodes: Dict[int, dict] = {}
    if config.hbm_horizon_s > 0:
        for item in trend_items:
            trends = item["trends"]
            eta = trends.get("hbm_headroom_eta_s")
            slope = trends.get("hbm_headroom_slope")
            if slope is None or slope >= 0 or eta is None:
                continue
            if eta <= config.hbm_horizon_s:
                prev = hbm_nodes.get(item["node"])
                if prev is None or eta < prev["trends"].get(
                        "hbm_headroom_eta_s", float("inf")):
                    hbm_nodes[item["node"]] = item
    for node in sorted(hbm_nodes):
        if node in fenced_nodes:
            # already being removed this round — and its pending streak
            # resets: "sustained" means CONSECUTIVE qualifying snapshots,
            # and a fence interruption breaks the run (a frozen streak
            # would let non-consecutive evidence satisfy the hysteresis)
            state.streaks.pop(f"hbm/{node}", None)
            continue
        streak = _bump_streak(state, f"hbm/{node}", True)
        if streak < config.sustain:
            continue
        why = _gate(state, config, "resize", now)
        if why is not None:
            continue
        item = hbm_nodes[node]
        eta = item["trends"].get("hbm_headroom_eta_s")
        _emit(state, actions, Action(
            kind="resize", rule="hbm_exhaustion", target=[node],
            reason=(f"node {node} (rank {item['rank']}): HBM headroom "
                    f"slope {item['trends'].get('hbm_headroom_slope'):.0f} "
                    f"B/s projects exhaustion in {eta:.0f}s <= horizon "
                    f"{config.hbm_horizon_s:.0f}s, sustained {streak} "
                    "snapshots; resizing down before the OOM"),
            evidence={"trend": item, "streak": streak},
        ), now)
        fenced_nodes.add(node)
        state.streaks.pop(f"hbm/{node}", None)
    # nodes whose headroom recovered: clear their streaks
    for key in [k for k in state.streaks
                if k.startswith("hbm/")
                and int(k.split("/", 1)[1]) not in hbm_nodes]:
        state.streaks.pop(key, None)

    # ---- rule 2: collective-dominant victim -> retune hint --------------
    # precedence: a fence beats a retune for the same rank — removing the
    # straggler already fixes its victims' waits, and any victim living on
    # a node being fenced this round is evidence, not a patient
    victim_ranks = {it["rank"] for it in victims
                    if it["node"] not in fenced_nodes
                    and it["node"] not in straggler_nodes}
    victim_active = bool(victim_ranks)
    streak = _bump_streak(state, "victim", victim_active)
    if victim_active and streak >= config.sustain:
        why = _gate(state, config, "retune_hint", now)
        if why is None:
            evidence = [it for it in victims if it["rank"] in victim_ranks]
            _emit(state, actions, Action(
                kind="retune_hint", rule="collective_victim",
                target=sorted(victim_ranks),
                reason=(f"rank(s) {sorted(victim_ranks)} collective-"
                        f"dominant (waiting on peers) sustained {streak} "
                        "snapshots; autotune should re-measure"),
                evidence={"suspects": evidence, "streak": streak},
            ), now)
            state.streaks.pop("victim", None)

    # ---- rule 2b: sustained DCN dominance -> compression-family hint -----
    # historian evidence only: when the windowed DCN share of the step
    # wall sits at/above the threshold fleet-wide-anywhere, hint the
    # autotune service toward the compression family whose hierarchical
    # path compresses ONLY the slow cross-slice tier
    # (docs/hierarchical.md) — the Bagua relaxation applied where bytes
    # are most expensive.  A hint, never a forced switch: the service
    # re-measures and the BO loop keeps the last word.
    dcn_items = [
        it for it in trend_items
        if config.dcn_share > 0
        and it["node"] not in fenced_nodes
        and (it["trends"].get("dcn_comm_share") or 0.0) >= config.dcn_share
    ]
    streak = _bump_streak(state, "dcn", bool(dcn_items))
    if not dcn_items and state.codec_rung:
        # dominance cleared: the current codec relieved the slow tier —
        # unwind the ladder so a later breach re-climbs from the start
        state.codec_rung = 0
    if dcn_items and streak >= config.sustain:
        why = _gate(state, config, "compress_dcn", now)
        if why is None:
            # codec ladder: the FIRST hint actuates the configured start
            # codec; every sustained re-breach afterwards (the actuated
            # codec did not relieve the DCN share) escalates one rung —
            # uint8 -> fp8 -> onebit_ef -> topk, ~4x to 16-32x wire
            # reduction.  A start codec outside the ladder stays fixed
            # (the operator chose a specific format).
            from ..compression.codecs import CODEC_LADDER
            if config.compress_codec in CODEC_LADDER:
                base = CODEC_LADDER.index(config.compress_codec)
                idx = min(base + state.codec_rung, len(CODEC_LADDER) - 1)
                codec = CODEC_LADDER[idx]
                state.codec_rung = min(state.codec_rung + 1,
                                       len(CODEC_LADDER) - 1 - base)
            else:
                codec = config.compress_codec
            shares = {it["rank"]: round(
                it["trends"]["dcn_comm_share"], 3) for it in dcn_items}
            _emit(state, actions, Action(
                kind="compress_dcn", rule="dcn_dominance",
                target=config.compress_family,
                reason=(f"rank(s) {sorted(shares)} spend "
                        f">= {config.dcn_share:.0%} of the step on the "
                        f"DCN tier (shares {shares}) sustained {streak} "
                        f"snapshots; hinting compression family "
                        f"{config.compress_family!r} and actuating DCN "
                        f"codec {codec!r} for the slow tier "
                        f"(ladder rung {state.codec_rung})"),
                evidence={"trends": dcn_items, "streak": streak,
                          "codec": codec,
                          "codec_rung": state.codec_rung,
                          # worst observed share: the autotune v2 loop
                          # turns it into coordinate weighting (how hard
                          # to bias the search toward the DCN-tier knobs)
                          "dcn_share_max": max(shares.values())},
            ), now)
            state.streaks.pop("dcn", None)

    # ---- rule 3: goodput SLO breach -> escalation ladder -----------------
    gf_min = _goodput_min(snapshot)
    breaching = (
        config.slo_goodput > 0
        and gf_min is not None
        and gf_min < config.slo_goodput
    )
    streak = _bump_streak(state, "slo", breaching)
    if breaching:
        state.slo_clear_streak = 0
        if streak >= config.sustain and state.rung < len(LADDER):
            kind = LADDER[state.rung]
            why = _gate(state, config, kind, now)
            if why is None:
                target: Any = None
                if kind == "switch_family":
                    target = config.switch_family
                elif kind == "resize":
                    worst = _worst_goodput_node(snapshot)
                    target = [worst[0]] if worst else None
                if kind == "resize" and target is None:
                    # nothing attributable to remove; stay on this rung
                    pass
                else:
                    state.rung += 1
                    _emit(state, actions, Action(
                        kind=kind, rule="slo_breach", target=target,
                        reason=(f"fleet min goodput {gf_min:.3f} < SLO "
                                f"{config.slo_goodput:.3f} sustained "
                                f"{streak} snapshots; ladder rung "
                                f"{state.rung}/{len(LADDER)} ({kind})"),
                        evidence={"goodput_fraction_min": gf_min,
                                  "rung": state.rung, "streak": streak},
                    ), now)
                    # each rung needs a FRESH sustained breach window
                    state.streaks.pop("slo", None)
    elif config.slo_goodput > 0 and gf_min is not None:
        # healthy snapshot: de-escalate after a full sustain window of
        # health (the ladder unwinds completely — a later breach restarts
        # from the cheapest adaptation)
        if state.rung > 0:
            state.slo_clear_streak += 1
            if state.slo_clear_streak >= config.sustain:
                state.rung = 0
                state.slo_clear_streak = 0

    # ---- rule 4: repeated checkpoint-integrity fallbacks -> quarantine ---
    for item in _ckpt_evidence(snapshot, config):
        path = item["path"]
        if path in state.quarantined:
            continue
        why = _gate(state, config, "quarantine_storage", now)
        if why is not None:
            continue
        state.quarantined.append(path)
        _emit(state, actions, Action(
            kind="quarantine_storage", rule="ckpt_integrity", target=path,
            reason=(f"rank {item['rank']} (node {item['node']}): "
                    f"{item['events']} checkpoint integrity events >= "
                    f"{config.ckpt_failures}; quarantining {path}"),
            evidence=item,
        ), now)

    return actions, state
