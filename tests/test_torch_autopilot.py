"""The port's fleet autopilot (``bagua_tpu_torch/autopilot/``).

Mirrors ``tests/test_autopilot.py``: table-driven unit tests over the pure
decision core's policy matrix — hysteresis boundaries, cooldown
suppression, action-budget exhaustion, observe-vs-act, escalation-ladder
ordering, fence-beats-retune precedence, the snapshot staleness guard —
plus the engine's telemetry/flight-recording/persistence contracts, the
replay CLI with ``--expect`` and ``--historian`` on the committed fixtures,
the checkpoint storage-quarantine redirect (the port's manager, torch
states), the autotune service's controller hints, and the allreduce<->async
family switch on the port's trainer.  Parity: each committed stream
(``tests/data/autopilot_fleet_stream.jsonl`` with the CI flags,
``autopilot_trend_stream.jsonl`` with the historian) replayed through both
packages' ``replay`` gives equal decision logs, and the port's CLI matches
the committed plans.
"""

import json
import os
import sys
import time

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bagua_tpu_torch.autopilot import (  # noqa: E402
    ACTION_KINDS,
    LADDER,
    AutopilotEngine,
    PolicyConfig,
    PolicyState,
    decide,
    replay,
)

NOW = 1_700_000_000.0


def _snapshot(t, gf=0.9, suspects=(), ckpt=None, epoch=0):
    """A minimal-but-valid ``bagua-obs-fleet-v1`` record.  ``suspects``:
    (node, dominant_phase, ratio) triples; ``ckpt``: extra summary fields
    merged into node 1's rank summary."""
    ranks = {"1": {"health": {}, "obs": {"1": {
        "rank": 1, "step": 10, "goodput_fraction": gf}}}}
    for node, phase, ratio in suspects:
        entry = ranks.setdefault(str(node), {"health": {}, "obs": {}})
        entry["obs"][str(node)] = {
            "rank": node, "step": 10, "goodput_fraction": gf,
            "straggler_suspect": {
                "rank": node, "step": 10, "ratio": ratio,
                "dominant_phase": phase, "detected_at_unix": t,
            },
        }
    if ckpt:
        ranks["1"]["obs"]["1"].update(ckpt)
    return {
        "schema": "bagua-obs-fleet-v1", "time_unix": t, "epoch": epoch,
        "nnodes": len(ranks), "ranks": ranks,
        "efficiency": {"ranks": {}, "goodput_fraction_min": gf,
                       "goodput_fraction_mean": gf},
    }


def _config(**kw):
    base = dict(mode="observe", sustain=3, cooldown_s=60.0, budget=8,
                staleness_s=60.0, slo_goodput=0.0, straggler_ratio=3.0,
                suspect_ttl_s=120.0, ckpt_failures=3,
                switch_family="async", dcn_share=0.5,
                compress_family="bytegrad", hbm_horizon_s=600.0)
    base.update(kw)
    return PolicyConfig(**base)


def _trend_snapshot(t, trends_by_node, epoch=0):
    """A fleet record whose rank summaries carry historian ``trends``
    sub-dicts (what :meth:`Historian.ingest` publishes)."""
    snap = _snapshot(t, epoch=epoch)
    for node, trends in trends_by_node.items():
        entry = snap["ranks"].setdefault(str(node), {"health": {}, "obs": {}})
        entry["obs"][str(node)] = {
            "rank": node, "step": 10, "goodput_fraction": 0.9,
            "trends": dict(trends),
        }
    return snap


def _run(snaps, config, state=None):
    """Feed snapshots in order (1 s apart); returns (per-snapshot action
    kind lists, final state)."""
    state = state or PolicyState()
    out = []
    for i, snap in enumerate(snaps):
        actions, state = decide(snap, state, config, NOW + i)
        out.append([a.kind for a in actions])
    return out, state


# ---- decision core: the policy matrix --------------------------------------


def test_straggler_hysteresis_boundary():
    """sustain=3: two qualifying snapshots decide NOTHING, the third
    fences — and the fence names the straggling node."""
    cfg = _config(sustain=3)
    snaps = [_snapshot(NOW + i, suspects=[(2, "dispatch", 10.0)])
             for i in range(3)]
    kinds, state = _run(snaps, cfg)
    assert kinds == [[], [], ["fence"]]
    actions, _ = decide(snaps[2], PolicyState(), cfg, NOW)
    assert actions == []  # a fresh state needs its own streak


def test_straggler_streak_resets_on_clean_snapshot():
    cfg = _config(sustain=3)
    snaps = [
        _snapshot(NOW + 0, suspects=[(2, "dispatch", 10.0)]),
        _snapshot(NOW + 1, suspects=[(2, "dispatch", 10.0)]),
        _snapshot(NOW + 2),  # clean — streak resets
        _snapshot(NOW + 3, suspects=[(2, "dispatch", 10.0)]),
        _snapshot(NOW + 4, suspects=[(2, "dispatch", 10.0)]),
    ]
    kinds, _ = _run(snaps, cfg)
    assert kinds == [[], [], [], [], []]


def test_straggler_below_ratio_or_stale_suspect_ignored():
    cfg = _config(sustain=1, straggler_ratio=3.0, suspect_ttl_s=50.0)
    # ratio below the floor: the anomaly detector's business, not ours
    a, _ = decide(_snapshot(NOW, suspects=[(2, "dispatch", 2.0)]),
                  PolicyState(), cfg, NOW)
    assert a == []
    # strong but STALE suspect (beacon keeps re-publishing the last one)
    snap = _snapshot(NOW, suspects=[(2, "dispatch", 10.0)])
    node2 = snap["ranks"]["2"]["obs"]["2"]["straggler_suspect"]
    node2["detected_at_unix"] = NOW - 300
    a, _ = decide(snap, PolicyState(), cfg, NOW)
    assert a == []


def test_victim_retune_hint_after_sustain():
    cfg = _config(sustain=2)
    snaps = [_snapshot(NOW + i, suspects=[(3, "collective", 8.0)])
             for i in range(2)]
    kinds, _ = _run(snaps, cfg)
    assert kinds == [[], ["retune_hint"]]


def test_fence_beats_retune_for_same_rank():
    """Conflicting-rule precedence: the straggler's node gets fenced; a
    victim living on that same node must NOT also trigger a retune — but
    a victim elsewhere still does."""
    cfg = _config(sustain=1)
    # victim rides the straggler's own node -> only the fence
    snap = _snapshot(NOW, suspects=[(2, "dispatch", 10.0)])
    snap["ranks"]["2"]["obs"]["9"] = {
        "rank": 9, "step": 10,
        "straggler_suspect": {"rank": 9, "step": 10, "ratio": 8.0,
                              "dominant_phase": "collective",
                              "detected_at_unix": NOW},
    }
    actions, _ = decide(snap, PolicyState(), cfg, NOW)
    assert [a.kind for a in actions] == ["fence"]
    # same victim on ANOTHER node -> fence and retune both fire
    snap2 = _snapshot(NOW, suspects=[(2, "dispatch", 10.0),
                                     (3, "collective", 8.0)])
    actions, _ = decide(snap2, PolicyState(), cfg, NOW)
    assert sorted(a.kind for a in actions) == ["fence", "retune_hint"]


def test_cooldown_suppression():
    cfg = _config(sustain=1, cooldown_s=60.0)
    state = PolicyState()
    a1, state = decide(_snapshot(NOW, suspects=[(2, "dispatch", 10.0)]),
                       state, cfg, NOW)
    assert [a.kind for a in a1] == ["fence"]
    # a DIFFERENT node inside the fence cooldown: suppressed + counted
    a2, state = decide(_snapshot(NOW + 1, suspects=[(4, "dispatch", 9.0)]),
                       state, cfg, NOW + 1)
    assert a2 == []
    assert state.counters["suppressed_cooldown"] == 1
    # after the cooldown the suppressed rule fires
    a3, state = decide(_snapshot(NOW + 61, suspects=[(4, "dispatch", 9.0)]),
                       state, cfg, NOW + 61)
    assert [a.kind for a in a3] == ["fence"] and a3[0].target == [4]


def test_budget_exhaustion():
    cfg = _config(sustain=1, cooldown_s=0.0, budget=1)
    state = PolicyState()
    a1, state = decide(_snapshot(NOW, suspects=[(2, "dispatch", 10.0)]),
                       state, cfg, NOW)
    assert [a.kind for a in a1] == ["fence"]
    a2, state = decide(_snapshot(NOW + 1, suspects=[(4, "dispatch", 9.0)]),
                       state, cfg, NOW + 1)
    assert a2 == [] and state.counters["suppressed_budget"] >= 1
    # budget=0 disables the autopilot's actions entirely
    a, s = decide(_snapshot(NOW, suspects=[(2, "dispatch", 10.0)]),
                  PolicyState(), _config(sustain=1, budget=0), NOW)
    assert a == [] and s.counters["suppressed_budget"] >= 1


def test_escalation_ladder_walks_in_order():
    """SLO breach: hint -> retune -> switch_family -> resize, each rung
    requiring a FRESH sustained breach window; the resize targets the
    worst-goodput node and the switch names the configured family."""
    cfg = _config(sustain=2, cooldown_s=0.0, slo_goodput=0.5)
    state = PolicyState()
    fired = []
    for i in range(8):
        actions, state = decide(_snapshot(NOW + i, gf=0.2), state, cfg,
                                NOW + i)
        fired.extend(actions)
    assert [a.kind for a in fired] == list(LADDER)
    assert all(a.rule == "slo_breach" for a in fired)
    assert fired[2].target == "async"
    assert fired[3].target == [1]  # the worst (only) goodput node
    assert state.rung == 4
    # rung 4 reached: further breaches decide nothing more
    actions, state = decide(_snapshot(NOW + 8, gf=0.2), state, cfg, NOW + 8)
    actions2, state = decide(_snapshot(NOW + 9, gf=0.2), state, cfg, NOW + 9)
    assert actions == [] and actions2 == []


def test_ladder_deescalates_after_sustained_health():
    cfg = _config(sustain=2, cooldown_s=0.0, slo_goodput=0.5)
    state = PolicyState()
    for i in range(2):
        _, state = decide(_snapshot(NOW + i, gf=0.2), state, cfg, NOW + i)
    assert state.rung == 1
    # two healthy snapshots unwind the ladder completely
    for i in range(2, 4):
        _, state = decide(_snapshot(NOW + i, gf=0.9), state, cfg, NOW + i)
    assert state.rung == 0
    # the next sustained breach restarts from the cheapest rung
    acts = []
    for i in range(4, 6):
        a, state = decide(_snapshot(NOW + i, gf=0.2), state, cfg, NOW + i)
        acts.extend(a)
    assert [a.kind for a in acts] == ["retune_hint"]


def test_slo_rule_disabled_by_default():
    kinds, state = _run([_snapshot(NOW + i, gf=0.01) for i in range(6)],
                        _config(sustain=1))
    assert kinds == [[]] * 6 and state.rung == 0


def test_ckpt_quarantine_threshold_and_idempotence():
    cfg = _config(ckpt_failures=3)
    below = _snapshot(NOW, ckpt={"ckpt_integrity_failures": 1,
                                 "ckpt_fallback_restores": 1,
                                 "ckpt_directory": "/data/ckpt"})
    a, state = decide(below, PolicyState(), cfg, NOW)
    assert a == []
    at = _snapshot(NOW + 1, ckpt={"ckpt_integrity_failures": 2,
                                  "ckpt_fallback_restores": 1,
                                  "ckpt_directory": "/data/ckpt"})
    a, state = decide(at, state, cfg, NOW + 1)
    assert [x.kind for x in a] == ["quarantine_storage"]
    assert a[0].target == "/data/ckpt"
    assert state.quarantined == ["/data/ckpt"]
    # already-quarantined path never re-fires
    again = _snapshot(NOW + 2, ckpt={"ckpt_integrity_failures": 9,
                                     "ckpt_directory": "/data/ckpt"})
    a, state = decide(again, state, cfg, NOW + 2)
    assert a == [] and state.quarantined == ["/data/ckpt"]


# ---- historian trend rules ------------------------------------------------

_SHRINKING = {"hbm_headroom_slope": -2e8, "hbm_headroom_eta_s": 15.0,
              "window_s": 600.0}
_DCN_HEAVY = {"dcn_comm_share": 0.7, "window_s": 600.0}


def test_hbm_exhaustion_resize_after_sustain():
    """Shrinking headroom projecting exhaustion inside the horizon,
    sustained -> pre-OOM resize naming the node; the streak must be
    earned like every other rule's."""
    cfg = _config(sustain=3, hbm_horizon_s=600.0)
    snaps = [_trend_snapshot(NOW + i, {2: _SHRINKING}) for i in range(3)]
    kinds, _ = _run(snaps, cfg)
    assert kinds == [[], [], ["resize"]]
    a, _ = decide(snaps[0], PolicyState(), cfg, NOW)
    assert a == []  # fresh state: one snapshot is never enough
    # the fired action names the node and the rule
    _, state = _run(snaps[:2], cfg)
    actions, _ = decide(snaps[2], state, cfg, NOW + 2)
    assert actions[0].kind == "resize"
    assert actions[0].rule == "hbm_exhaustion"
    assert actions[0].target == [2]
    assert "exhaustion" in actions[0].reason


def test_hbm_rule_requires_projection_inside_horizon():
    cfg = _config(sustain=1)
    # positive slope: headroom growing, nothing to do
    a, _ = decide(_trend_snapshot(NOW, {2: {"hbm_headroom_slope": 2e8}}),
                  PolicyState(), cfg, NOW)
    assert a == []
    # negative slope but projection beyond the horizon
    far = {"hbm_headroom_slope": -1e3, "hbm_headroom_eta_s": 90000.0}
    a, _ = decide(_trend_snapshot(NOW, {2: far}), PolicyState(), cfg, NOW)
    assert a == []
    # horizon 0 disables the rule outright
    a, _ = decide(_trend_snapshot(NOW, {2: _SHRINKING}), PolicyState(),
                  _config(sustain=1, hbm_horizon_s=0.0), NOW)
    assert a == []


def test_hbm_streak_resets_when_headroom_recovers():
    cfg = _config(sustain=3)
    snaps = [
        _trend_snapshot(NOW + 0, {2: _SHRINKING}),
        _trend_snapshot(NOW + 1, {2: _SHRINKING}),
        _trend_snapshot(NOW + 2, {2: {"hbm_headroom_slope": 1e8}}),
        _trend_snapshot(NOW + 3, {2: _SHRINKING}),
        _trend_snapshot(NOW + 4, {2: _SHRINKING}),
    ]
    kinds, _ = _run(snaps, cfg)
    assert kinds == [[], [], [], [], []]


def test_fence_beats_hbm_resize_for_same_node():
    """A node already being fenced this round must not also be resized
    by the HBM rule (one removal, one reason)."""
    cfg = _config(sustain=1)
    snap = _snapshot(NOW, suspects=[(2, "dispatch", 10.0)])
    snap["ranks"]["2"]["obs"]["2"]["trends"] = dict(_SHRINKING)
    actions, _ = decide(snap, PolicyState(), cfg, NOW)
    assert [a.kind for a in actions] == ["fence"]


def test_hbm_streak_resets_when_fence_interrupts():
    """A fence interruption breaks the hbm sustain run — the streak must
    reset, not freeze: 'sustained' means CONSECUTIVE snapshots, and a
    frozen streak would fire the resize from non-consecutive evidence."""
    cfg = _config(sustain=2, cooldown_s=0.0)

    def hbm_snap(t, suspect=False):
        snap = _snapshot(
            t, suspects=[(2, "dispatch", 10.0)] if suspect else ())
        entry = snap["ranks"].setdefault("2", {"health": {}, "obs": {}})
        obs = entry["obs"].setdefault("2", {
            "rank": 2, "step": 10, "goodput_fraction": 0.9})
        obs["trends"] = dict(_SHRINKING)
        return snap

    state = PolicyState()
    kinds = []
    # snap 0: hbm streak 1; snap 1: fence fires (straggler sustained 2
    # via its own streak? no — suspect present both snaps)
    for i, suspect in enumerate((True, True, False, False)):
        actions, state = decide(hbm_snap(NOW + i, suspect), state, cfg,
                                NOW + i)
        kinds.append([a.kind for a in actions])
    # snap 1 fences node 2 and RESETS the pending hbm streak; snaps 2-3
    # re-earn a full consecutive window before the resize fires
    assert kinds == [[], ["fence"], [], ["resize"]]


def test_dcn_dominance_compress_hint_after_sustain():
    cfg = _config(sustain=2, dcn_share=0.5, compress_family="bytegrad")
    snaps = [_trend_snapshot(NOW + i, {3: _DCN_HEAVY}) for i in range(2)]
    kinds, _ = _run(snaps, cfg)
    assert kinds == [[], ["compress_dcn"]]
    _, state = _run(snaps[:1], cfg)
    actions, _ = decide(snaps[1], state, cfg, NOW + 1)
    assert actions[0].rule == "dcn_dominance"
    assert actions[0].target == "bytegrad"  # the slow-tier codec family
    assert "DCN" in actions[0].reason


def test_dcn_rule_below_share_or_disabled_is_inert():
    mild = {"dcn_comm_share": 0.2, "window_s": 600.0}
    a, _ = decide(_trend_snapshot(NOW, {3: mild}), PolicyState(),
                  _config(sustain=1), NOW)
    assert a == []
    # dcn_share 0 disables the rule even under total dominance
    a, _ = decide(_trend_snapshot(NOW, {3: {"dcn_comm_share": 1.0}}),
                  PolicyState(), _config(sustain=1, dcn_share=0.0), NOW)
    assert a == []


def test_trend_rules_inert_without_historian_trends():
    """The acceptance boundary: raw point-in-time evidence (headroom and
    DCN gauges WITHOUT a trends sub-dict) never fires the trend rules —
    only historian windows do."""
    cfg = _config(sustain=1)
    snap = _snapshot(NOW)
    snap["ranks"]["2"] = {"health": {}, "obs": {"2": {
        "rank": 2, "step": 10, "goodput_fraction": 0.9,
        "hbm_headroom_bytes": 1e6,            # nearly exhausted...
        "device_comm_dcn_s_per_step": 0.09,   # ...and DCN-swamped
        "step_dt_p50": 0.1,
    }}}
    kinds, state = _run([snap] * 1, cfg)
    assert kinds == [[]]
    assert state.streaks == {}


def test_replay_with_historian_fires_trend_rules():
    """The acceptance scenario end-to-end: a synthetic shrinking-headroom
    stream decides the pre-OOM resize, a DCN-dominant stream decides the
    compression hint, flat streams decide nothing — all through the SAME
    replay entry point the CLI uses."""
    from bagua_tpu_torch.obs.historian import Historian

    def snap(i, headroom=None, dcn=None):
        obs = {"rank": 1, "step": 10 + i, "goodput_fraction": 0.9,
               "step_dt_p50": 0.1}
        if headroom is not None:
            obs["hbm_headroom_bytes"] = headroom
        if dcn is not None:
            obs["device_comm_dcn_s_per_step"] = dcn
            obs["device_comm_ici_s_per_step"] = 0.01
        return {"schema": "bagua-obs-fleet-v1", "time_unix": NOW + i,
                "epoch": 0, "nnodes": 1,
                "ranks": {"2": {"health": {}, "obs": {"1": obs}}},
                "efficiency": {"ranks": {}, "goodput_fraction_min": 0.9,
                               "goodput_fraction_mean": 0.9}}

    cfg = _config(mode="observe", sustain=2, cooldown_s=300.0)
    shrink = [snap(i, headroom=5e9 - i * 2e8) for i in range(8)]
    log = replay(shrink, cfg, historian=Historian(window_s=600.0))
    fired = [(e["snapshot"], a["kind"], a["rule"])
             for e in log for a in e["actions"]]
    assert fired == [(4, "resize", "hbm_exhaustion")]
    assert shrink[4]["ranks"]["2"]["obs"]["1"].get("trends") is None  # pure

    dcn = [snap(i, dcn=0.08) for i in range(8)]
    log = replay(dcn, cfg, historian=Historian(window_s=600.0))
    fired = [(e["snapshot"], a["kind"]) for e in log for a in e["actions"]]
    assert fired == [(4, "compress_dcn")]

    flat = [snap(i, headroom=5e9, dcn=0.01) for i in range(8)]
    log = replay(flat, cfg, historian=Historian(window_s=600.0))
    assert [a for e in log for a in e["actions"]] == []
    # and WITHOUT the historian the same shrinking stream decides nothing
    log = replay(shrink, cfg)
    assert [a for e in log for a in e["actions"]] == []


def test_committed_trend_fixture_matches_plan(tmp_path):
    """The committed CI fixture (scripts/ci.sh trend-replay stage) stays
    green through the pytest gate too."""
    from bagua_tpu_torch.autopilot.__main__ import main as cli_main

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    rc = cli_main(["--replay",
                   os.path.join(data, "autopilot_trend_stream.jsonl"),
                   "--expect",
                   os.path.join(data, "autopilot_trend_plan.json"),
                   "--historian", "--trend-window-s", "600",
                   "--sustain", "2", "--cooldown-s", "300",
                   "--budget", "8"])
    assert rc == 0


def test_engine_counts_compress_hints(tmp_path, monkeypatch):
    from bagua_tpu_torch.telemetry import counters

    eng, spy = _engine(tmp_path, monkeypatch, "act", sustain=1)
    before = counters.get("autopilot/compress_hints")
    actions = eng.observe_snapshot(_trend_snapshot(NOW, {3: _DCN_HEAVY}),
                                   now=NOW)
    assert [a.kind for a in actions] == ["compress_dcn"]
    assert [a.kind for a in spy.calls] == ["compress_dcn"]
    assert counters.get("autopilot/compress_hints") == before + 1


def test_service_compress_hint_regrants_remeasure():
    svc = _service()
    task = svc._task("m")
    task.sample_retried = True
    svc.report_metrics({"model_name": "m", "rank": -1, "train_iter": -1,
                        "hyperparameters": {}, "speed": 0.0,
                        "perf_hints": [{"kind": "autopilot_compress_dcn",
                                        "family": "bytegrad"}]})
    assert task.sample_retried is False  # the hint re-granted re-measure
    assert task.pinned_algorithm is None  # a hint, never a pin
    assert task.perf_hints[0]["family"] == "bytegrad"


def test_staleness_guard_refuses_old_snapshot():
    cfg = _config(sustain=1, staleness_s=60.0)
    snap = _snapshot(NOW - 120, suspects=[(2, "dispatch", 10.0)])
    actions, state = decide(snap, PolicyState(), cfg, NOW)
    assert actions == []
    assert state.counters["stale_snapshots"] == 1
    assert state.streaks == {}  # stale evidence advances nothing


def test_duplicate_snapshot_does_not_advance_streaks():
    """Re-reading one snapshot (same time_unix) is not new evidence."""
    cfg = _config(sustain=2)
    snap = _snapshot(NOW, suspects=[(2, "dispatch", 10.0)])
    state = PolicyState()
    for _ in range(5):
        actions, state = decide(snap, state, cfg, NOW + 1)
        assert actions == []
    assert state.streaks.get("straggler/2") == 1


def test_policy_state_json_round_trip():
    cfg = _config(sustain=1, cooldown_s=60.0, slo_goodput=0.5)
    state = PolicyState()
    _, state = decide(_snapshot(NOW, gf=0.2,
                                suspects=[(2, "dispatch", 10.0)],
                                ckpt={"ckpt_integrity_failures": 5,
                                      "ckpt_directory": "/d"}),
                      state, cfg, NOW)
    revived = PolicyState.from_json(state.to_json())
    assert revived == state
    # cooldowns survive the round trip: the revived state still suppresses
    a, revived = decide(_snapshot(NOW + 1, suspects=[(4, "dispatch", 9.0)]),
                        revived, cfg, NOW + 1)
    assert a == []


def test_decide_does_not_mutate_input_state():
    cfg = _config(sustain=1)
    state = PolicyState()
    before = state.to_json()
    decide(_snapshot(NOW, suspects=[(2, "dispatch", 10.0)]), state, cfg, NOW)
    assert state.to_json() == before


# ---- engine: telemetry, flight records, persistence, observe-vs-act -------


class _SpyActuator:
    def __init__(self):
        self.calls = []

    def __call__(self, action):
        self.calls.append(action)
        return True


def _engine(tmp_path, monkeypatch, mode, store=None, **cfg):
    monkeypatch.setenv("BAGUA_OBS_DUMP_DIR", str(tmp_path / "dumps"))
    spy = _SpyActuator()
    base = dict(mode=mode, sustain=1, cooldown_s=0.0)
    base.update(cfg)
    eng = AutopilotEngine(
        config=_config(**base),
        actuators={k: spy for k in ACTION_KINDS},
        store=store,
    )
    return eng, spy


def test_engine_observe_mode_never_actuates(tmp_path, monkeypatch):
    from bagua_tpu_torch.telemetry import counters

    eng, spy = _engine(tmp_path, monkeypatch, "observe")
    before = counters.snapshot()
    actions = eng.observe_snapshot(
        _snapshot(NOW, suspects=[(2, "dispatch", 10.0)]), now=NOW)
    assert [a.kind for a in actions] == ["fence"]
    assert spy.calls == []
    after = counters.snapshot()
    assert after.get("autopilot/decisions", 0) - before.get(
        "autopilot/decisions", 0) == 1
    assert after.get("autopilot/observed_only", 0) - before.get(
        "autopilot/observed_only", 0) == 1
    assert after.get("autopilot/actions_actuated", 0) == before.get(
        "autopilot/actions_actuated", 0)
    assert after.get("autopilot/fences", 0) - before.get(
        "autopilot/fences", 0) == 1


def test_engine_act_mode_actuates_engine_owned_kinds(tmp_path, monkeypatch):
    from bagua_tpu_torch.telemetry import counters

    eng, spy = _engine(tmp_path, monkeypatch, "act")
    before = counters.snapshot()
    actions = eng.observe_snapshot(
        _snapshot(NOW, suspects=[(3, "collective", 8.0)]), now=NOW)
    assert [a.kind for a in actions] == ["retune_hint"]
    assert [a.kind for a in spy.calls] == ["retune_hint"]
    after = counters.snapshot()
    assert after.get("autopilot/actions_actuated", 0) - before.get(
        "autopilot/actions_actuated", 0) == 1


def test_engine_flight_records_every_decision(tmp_path, monkeypatch):
    from bagua_tpu_torch.obs.recorder import validate_flight_record

    eng, _ = _engine(tmp_path, monkeypatch, "observe")
    eng.observe_snapshot(_snapshot(NOW, suspects=[(2, "dispatch", 10.0)]),
                         now=NOW)
    dumps = list((tmp_path / "dumps").glob("flight_autopilot_action_*.json"))
    assert dumps, "autopilot decision left no flight record"
    rec = json.load(open(dumps[0]))
    assert validate_flight_record(rec) == []
    assert rec["trigger"] == "autopilot_action"
    assert rec["extra"]["action"]["kind"] == "fence"
    assert rec["extra"]["action"]["rule"] == "chronic_straggler"
    assert rec["extra"]["mode"] == "observe"


def test_engine_stale_snapshot_counter(tmp_path, monkeypatch):
    from bagua_tpu_torch.telemetry import counters

    eng, _ = _engine(tmp_path, monkeypatch, "observe")
    before = counters.get("autopilot/stale_snapshots")
    actions = eng.observe_snapshot(_snapshot(NOW - 500), now=NOW)
    assert actions == []
    assert counters.get("autopilot/stale_snapshots") == before + 1


def test_engine_persists_and_resumes_policy_state(tmp_path, monkeypatch):
    """The coordinator-restart idempotence contract: a relaunched engine
    sharing the restart store resumes with the previous life's cooldowns
    and must NOT immediately re-fire a cooled-down action."""
    from bagua_tpu_torch.contrib.utils.store import InMemoryStore

    store = InMemoryStore()
    eng, _ = _engine(tmp_path, monkeypatch, "observe", store=store,
                     cooldown_s=600.0)
    actions = eng.observe_snapshot(
        _snapshot(NOW, suspects=[(2, "dispatch", 10.0)]), now=NOW)
    assert [a.kind for a in actions] == ["fence"]

    relaunched, _ = _engine(tmp_path, monkeypatch, "observe", store=store,
                            cooldown_s=600.0)
    assert relaunched.state.actions_taken == 1
    assert "fence" in relaunched.state.last_action_unix
    # inside the persisted cooldown: the same evidence decides nothing
    actions = relaunched.observe_snapshot(
        _snapshot(NOW + 10, suspects=[(4, "dispatch", 9.0)]), now=NOW + 10)
    assert actions == []
    assert relaunched.state.counters.get("suppressed_cooldown", 0) >= 1


def test_quarantine_store_channel_is_act_mode_only(tmp_path, monkeypatch):
    """Observe mode decides (and logs) quarantines but must NOT publish
    them to the launcher-readable store key — a dry run never redirects a
    worker's saves; an act-mode engine does, and every launcher can read
    the verdict back."""
    from bagua_tpu_torch import checkpoint as ck
    from bagua_tpu_torch.autopilot import default_engine_actuators
    from bagua_tpu_torch.autopilot.engine import read_actuated_quarantines
    from bagua_tpu_torch.contrib.utils.store import InMemoryStore

    ck.clear_quarantine()
    monkeypatch.setenv("BAGUA_OBS_DUMP_DIR", str(tmp_path / "dumps"))
    snap = _snapshot(NOW, ckpt={"ckpt_integrity_failures": 5,
                                "ckpt_directory": str(tmp_path / "q")})
    observe_store = InMemoryStore()
    eng = AutopilotEngine(config=_config(mode="observe", sustain=1,
                                         cooldown_s=0.0),
                          store=observe_store)
    assert [a.kind for a in eng.observe_snapshot(snap, now=NOW)] == \
        ["quarantine_storage"]
    assert read_actuated_quarantines(observe_store) == []
    assert not ck.is_quarantined(str(tmp_path / "q"))

    act_store = InMemoryStore()
    eng = AutopilotEngine(
        config=_config(mode="act", sustain=1, cooldown_s=0.0),
        actuators=default_engine_actuators(autotune_addr=None),
        store=act_store,
    )
    eng.observe_snapshot(snap, now=NOW)
    assert read_actuated_quarantines(act_store) == [
        ck._normalize_storage_path(str(tmp_path / "q"))]
    ck.clear_quarantine()
    # a RELAUNCHED act-mode engine re-applies the persisted verdict to
    # its own registry (observe->act flips included)
    relaunched = AutopilotEngine(config=_config(mode="act", sustain=1),
                                 store=act_store)
    assert relaunched.state.quarantined
    assert ck.is_quarantined(str(tmp_path / "q"))
    ck.clear_quarantine()


def test_engine_quarantine_actions_reach_checkpoint_registry(tmp_path,
                                                             monkeypatch):
    from bagua_tpu_torch import checkpoint as ck
    from bagua_tpu_torch.autopilot import default_engine_actuators

    ck.clear_quarantine()
    monkeypatch.setenv("BAGUA_OBS_DUMP_DIR", str(tmp_path / "dumps"))
    eng = AutopilotEngine(
        config=_config(mode="act", sustain=1, cooldown_s=0.0),
        actuators=default_engine_actuators(autotune_addr=None),
    )
    path = str(tmp_path / "ck")
    eng.observe_snapshot(
        _snapshot(NOW, ckpt={"ckpt_integrity_failures": 5,
                             "ckpt_directory": path}), now=NOW)
    assert ck.is_quarantined(path)
    ck.clear_quarantine()


# ---- replay + CLI ----------------------------------------------------------


def test_replay_is_deterministic_and_pure():
    snaps = [_snapshot(NOW + i, gf=0.2) for i in range(4)]
    cfg = _config(sustain=2, cooldown_s=0.0, slo_goodput=0.5)
    log1 = replay(snaps, cfg)
    log2 = replay(snaps, cfg)
    assert log1 == log2
    fired = [a["kind"] for e in log1 for a in e["actions"]]
    assert fired == ["retune_hint", "retune"]


def test_replay_cli_expect_gate(tmp_path, monkeypatch):
    from bagua_tpu_torch.autopilot.__main__ import main as cli_main

    stream = tmp_path / "fleet.jsonl"
    with open(stream, "w") as f:
        for i in range(4):
            f.write(json.dumps(_snapshot(NOW + i, gf=0.2)) + "\n")
    out = tmp_path / "decisions.json"
    rc = cli_main(["--replay", str(stream), "--out", str(out),
                   "--slo-goodput", "0.5", "--sustain", "2",
                   "--cooldown-s", "0"])
    assert rc == 0
    record = json.load(open(out))
    plan = record["plan"]
    assert [p["kind"] for p in plan] == ["retune_hint", "retune"]
    # matching expectation passes, diverging expectation fails
    expect = tmp_path / "plan.json"
    with open(expect, "w") as f:
        json.dump(plan, f)
    assert cli_main(["--replay", str(stream), "--expect", str(expect),
                     "--slo-goodput", "0.5", "--sustain", "2",
                     "--cooldown-s", "0"]) == 0
    with open(expect, "w") as f:
        json.dump(plan[:1], f)
    assert cli_main(["--replay", str(stream), "--expect", str(expect),
                     "--slo-goodput", "0.5", "--sustain", "2",
                     "--cooldown-s", "0"]) == 1


# ---- checkpoint storage quarantine ----------------------------------------


def test_ckpt_quarantine_redirects_saves_and_walks_history(tmp_path):
    import torch

    from bagua_tpu_torch import checkpoint as ck

    ck.clear_quarantine()
    d = str(tmp_path / "ckpt")

    def state(v):
        return {"w": torch.arange(64, dtype=torch.float32) * v}

    m = ck.BaguaCheckpointManager(d, async_save=False, max_to_keep=5)
    m.save(1, state(1.0))
    m.save(2, state(2.0))
    assert ck.quarantine_storage_path(d) is True
    assert ck.quarantine_storage_path(d) is False  # idempotent
    # the next save redirects; the manager swaps mid-life
    m.save(3, state(3.0))
    assert m.directory == ck.redirect_directory(d)
    assert os.path.isdir(ck.redirect_directory(d))
    # newest-first restore walks BOTH directories
    step, restored = m.try_restore(state(0.0))
    assert step == 3
    assert torch.equal(restored["w"], state(3.0)["w"])
    step, restored = m.restore(state(0.0), step=2)
    assert step == 2
    m.close()
    # a FRESH manager resolves the quarantine at construction
    m2 = ck.BaguaCheckpointManager(d, async_save=False)
    assert m2.directory == ck.redirect_directory(d)
    assert m2.latest_step() == 3
    m2.close()
    ck.clear_quarantine()


def test_ckpt_quarantine_env_seed(tmp_path, monkeypatch):
    """The launcher's restart-boundary channel: respawned workers seed the
    registry from BAGUA_CKPT_QUARANTINED_PATHS."""
    from bagua_tpu_torch import checkpoint as ck

    d = str(tmp_path / "envq")
    monkeypatch.setenv("BAGUA_CKPT_QUARANTINED_PATHS", d)
    ck.clear_quarantine()
    ck._QUARANTINE_SEEDED = False  # re-arm the one-time seed
    assert ck.is_quarantined(d)
    assert ck.active_directory(d) == ck.redirect_directory(d)
    ck.clear_quarantine()


def test_launcher_injects_quarantine_env(tmp_path, monkeypatch):
    """Newline-separated injection (os.pathsep is ':' and would split a
    gs:// URI apart), round-tripping through the env accessor."""
    from bagua_tpu_torch import env as _env
    from bagua_tpu_torch.distributed.run import build_env, parse_args

    args = parse_args(["--nnodes", "1", "script.py"])
    assert "BAGUA_CKPT_QUARANTINED_PATHS" not in build_env(args, 0)
    paths = ["/a", "gs://bucket/run42/ckpt"]
    env = build_env(args, 0, quarantined_ckpt_paths=paths)
    assert env["BAGUA_CKPT_QUARANTINED_PATHS"] == "\n".join(paths)
    monkeypatch.setenv("BAGUA_CKPT_QUARANTINED_PATHS",
                       env["BAGUA_CKPT_QUARANTINED_PATHS"])
    assert _env.get_ckpt_quarantined_paths() == paths


def test_ckpt_manager_on_quarantined_path_keeps_history(tmp_path):
    """A manager CONSTRUCTED on an already-quarantined path (the restart
    boundary's env-seeded case) must still restore the pre-quarantine
    verified history — not silently restart from nothing."""
    import torch

    from bagua_tpu_torch import checkpoint as ck

    ck.clear_quarantine()
    d = str(tmp_path / "ckpt")

    def state(v):
        return {"w": torch.arange(64, dtype=torch.float32) * v}

    m = ck.BaguaCheckpointManager(d, async_save=False)
    m.save(1, state(1.0))
    m.save(2, state(2.0))
    m.close()
    ck.quarantine_storage_path(d)
    m2 = ck.BaguaCheckpointManager(d, async_save=False)
    assert m2.directory == ck.redirect_directory(d)
    assert m2.latest_step() == 2
    step, restored = m2.try_restore(state(0.0))
    assert step == 2
    assert torch.equal(restored["w"], state(2.0)["w"])
    m2.save(3, state(3.0))
    assert m2.try_restore(state(0.0))[0] == 3
    m2.close()
    ck.clear_quarantine()


def test_ckpt_redirect_of_redirect_keeps_original_history(tmp_path):
    """A second quarantine (the redirect itself rots) must not drop the
    ORIGINAL directory from the restore walk."""
    import torch

    from bagua_tpu_torch import checkpoint as ck

    ck.clear_quarantine()
    d = str(tmp_path / "ckpt")

    def state(v):
        return {"w": torch.arange(64, dtype=torch.float32) * v}

    m = ck.BaguaCheckpointManager(d, async_save=False)
    m.save(1, state(1.0))
    ck.quarantine_storage_path(d)
    m.save(2, state(2.0))          # lands in d.redirect
    ck.quarantine_storage_path(ck.redirect_directory(d))
    m.save(3, state(3.0))          # lands in d.redirect.redirect
    assert m.directory == ck.redirect_directory(ck.redirect_directory(d))
    # all three generations restorable, newest first
    assert [s for s, _ in m._candidate_steps()] == [3, 2, 1]
    assert m.restore(state(0.0), step=1)[0] == 1
    m.close()
    ck.clear_quarantine()


# ---- autotune service: controller hints -----------------------------------


def _service(**kw):
    from bagua_tpu_torch.service.autotune_service import AutotuneService

    base = dict(world_size=1, autotune_level=1, max_samples=2,
                sampling_confidence_time_s=0.0, warmup_time_s=0.0)
    base.update(kw)
    return AutotuneService(**base)


def test_service_controller_rank_reports_hints_without_speed():
    svc = _service()
    svc.report_metrics({"model_name": "m", "rank": -1, "train_iter": -1,
                        "hyperparameters": {}, "speed": 0.0,
                        "perf_hints": [{"kind": "autopilot_retune_hint"}]})
    task = svc._task("m")
    assert task.speed_by_rank == {}  # the controller's 0.0 never scores
    assert task.perf_hints_total == 1
    assert task.perf_hints[0]["reported_by"] == -1


def test_service_switch_family_pins_recommendation():
    svc = _service()
    svc.report_metrics({
        "model_name": "m", "rank": -1, "train_iter": -1,
        "hyperparameters": {}, "speed": 0.0,
        "perf_hints": [{"kind": "autopilot_switch_family",
                        "family": "async"}],
    })
    rsp = svc.ask_hyperparameters({"model_name": "m", "rank": 0,
                                   "train_iter": 100})
    assert rsp["recommended_hyperparameters"]["algorithm"] == "async"
    # the pin survives later asks (the BO loop must not un-switch)
    rsp = svc.ask_hyperparameters({"model_name": "m", "rank": 0,
                                   "train_iter": 200})
    assert rsp["recommended_hyperparameters"]["algorithm"] == "async"


def test_service_autopilot_retune_reopens_completed_search():
    svc = _service(max_samples=0)  # completes instantly
    task = svc._task("m")
    task.completed = True
    svc.report_metrics({"model_name": "m", "rank": -1, "train_iter": -1,
                        "hyperparameters": {}, "speed": 0.0,
                        "perf_hints": [{"kind": "autopilot_retune"}]})
    assert task.completed is False
    assert task.extra_samples == 4
    assert task.sample_retried is False


# ---- trainer: the allreduce<->async switch rides the migration path ------
#
# The port's trainer at world 1 on the CPU (the two-rank switch is in
# tests/test_torch_autotune_integration.py).  The JAX package stacks the
# replicated state into one row a device on the way into async and
# collapses the rows on the way out; each rank of the port holds its own
# weights in both families, so the way in moves nothing and the way out is
# one catch-up average.


def _torch_trainer(flat_resident="off"):
    import functools

    import torch

    import bagua_tpu_torch as bt
    from bagua_tpu_torch.models.mlp import MLP

    bt.init_process_group(device="cpu")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(32, 4, generator=g)
    batch = {"x": x, "y": (x @ torch.randn(4, 8, generator=g)).argmax(-1)}

    def loss_fn(m, b):
        return torch.nn.functional.cross_entropy(m(b["x"]), b["y"])

    t = bt.BaguaTrainer(loss_fn, functools.partial(torch.optim.SGD, lr=0.1),
                        bt.GradientAllReduceAlgorithm(), device="cpu", autotune=False,
                        flat_resident=flat_resident)
    s = t.init(MLP(4, (16, 8), device="cpu"))
    return t, s, batch


@pytest.fixture()
def golden_trainer():
    return _torch_trainer()


def test_family_switch_allreduce_to_async_and_back(golden_trainer):
    import math

    from bagua_tpu_torch.define import BaguaHyperparameter

    t, s, b = golden_trainer
    for _ in range(3):
        s, loss = t.train_step(s, b)
    # -> async: the recommendation queues the family's entry (its groups,
    # its state) for the next step
    t._apply_recommendation(BaguaHyperparameter(algorithm="async"))
    assert t._pending_state_migration is not None
    for _ in range(4):
        s, loss = t.train_step(s, b)
    assert type(t.algorithm).__name__ == "AsyncModelAverageAlgorithm"
    assert math.isfinite(float(loss))
    # -> back: the catch-up average (one rank: the weights themselves)
    t._apply_recommendation(BaguaHyperparameter(algorithm="gradient_allreduce"))
    for _ in range(3):
        s, loss = t.train_step(s, b)
    assert type(t.algorithm).__name__ == "GradientAllReduceAlgorithm"
    assert math.isfinite(float(loss))


def test_family_switch_stacks_rows_bit_identically(golden_trainer):
    """The JAX package's rows all equal the replicated copy; the port's one
    replica a rank is that copy: the migration into async leaves every
    parameter and the optimizer's state bitwise as it was."""
    import torch

    from bagua_tpu_torch.define import BaguaHyperparameter

    t, s, b = golden_trainer
    s, _ = t.train_step(s, b)
    before = {n: p.detach().clone() for n, p in s.model.named_parameters()}
    opt_before = [{k: v.clone() for k, v in st.items() if torch.is_tensor(v)}
                  for st in s.optimizer.state.values()]
    t._apply_recommendation(BaguaHyperparameter(algorithm="async"))
    migrated = t._pending_state_migration(s)
    t._pending_state_migration = None
    for n, p in migrated.model.named_parameters():
        assert torch.equal(p, before[n])
    assert migrated.optimizer is s.optimizer
    for st, pre in zip(migrated.optimizer.state.values(), opt_before):
        assert all(torch.equal(st[k], v) for k, v in pre.items())


def test_family_switch_refused_for_flat_resident():
    from bagua_tpu_torch.define import BaguaHyperparameter

    t, s, b = _torch_trainer(flat_resident="on")
    s, _ = t.train_step(s, b)
    t._apply_recommendation(BaguaHyperparameter(algorithm="async"))
    # refused: the resident flats have no per-rank async form
    assert type(t.algorithm).__name__ == "GradientAllReduceAlgorithm"
    assert t._pending_state_migration is None
    s, loss = t.train_step(s, b)


# ---- the off pin: autopilot off leaves the step untouched ------------------


def test_autopilot_off_jaxpr_pin(monkeypatch):
    """BAGUA_AUTOPILOT never reaches the step: the parameters after three
    steps are bitwise equal across off/observe/act (the JAX package pins
    its traced program)."""
    import torch

    out = {}
    for mode in ("off", "observe", "act"):
        monkeypatch.setenv("BAGUA_AUTOPILOT", mode)
        t, s, b = _torch_trainer()
        for _ in range(3):
            s, _ = t.train_step(s, b)
        out[mode] = [p.detach().clone() for p in s.model.parameters()]
    for mode in ("observe", "act"):
        assert all(torch.equal(a, c) for a, c in zip(out["off"], out[mode]))


def test_autopilot_off_builds_no_engine(monkeypatch):
    """monitor-loop wiring: mode off means run_elastic never constructs an
    engine (the pre-autopilot coordinator path, bit for bit)."""
    monkeypatch.delenv("BAGUA_AUTOPILOT", raising=False)
    from bagua_tpu_torch import env as _env

    assert _env.get_autopilot_mode() == "off"


# ---- parity with the JAX package -------------------------------------------

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _load(name):
    with open(os.path.join(_DATA, name)) as f:
        return [json.loads(line) for line in f if line.strip()]


#: (stream, committed plan, the CI flags of that plan (``scripts/ci.sh``),
#: historian)
REPLAYS = {
    "fleet": ("autopilot_fleet_stream.jsonl", "autopilot_expected_plan.json",
              ["--sustain", "2", "--cooldown-s", "0", "--budget", "8", "--slo-goodput", "0.5",
               "--straggler-ratio", "3.0", "--ckpt-failures", "3", "--family", "async"],
              False),
    "trend": ("autopilot_trend_stream.jsonl", "autopilot_trend_plan.json",
              ["--historian", "--trend-window-s", "600", "--sustain", "2",
               "--cooldown-s", "300", "--budget", "8"], True),
}


@pytest.mark.parametrize("which", sorted(REPLAYS))
def test_committed_stream_replays_equal_the_jax_decision_log(which, tmp_path):
    from bagua_tpu.autopilot.__main__ import main as jcli

    from bagua_tpu_torch.autopilot.__main__ import main as tcli

    stream, plan, flags, _ = REPLAYS[which]
    logs = {}
    for name, cli in (("port", tcli), ("jax", jcli)):
        out = tmp_path / f"{name}.json"
        assert cli(["--replay", os.path.join(_DATA, stream), "--out", str(out)]
                   + flags) == 0
        logs[name] = json.load(open(out))
    assert logs["port"] == logs["jax"]
    # and the port's --expect gate passes the committed plan
    assert tcli(["--replay", os.path.join(_DATA, stream), "--expect",
                 os.path.join(_DATA, plan)] + flags) == 0


@pytest.mark.parametrize("historian", [False, True])
def test_replay_logs_equal_jax_through_the_api(historian):
    from bagua_tpu.autopilot import PolicyConfig as JConfig
    from bagua_tpu.autopilot import replay as jreplay
    from bagua_tpu.obs.historian import Historian as JHistorian

    from bagua_tpu_torch.obs.historian import Historian

    snaps = _load("autopilot_trend_stream.jsonl") + _load("autopilot_fleet_stream.jsonl")
    kw = dict(mode="observe", sustain=2, cooldown_s=300.0, budget=8, staleness_s=1e12,
              slo_goodput=0.5)
    got = replay(json.loads(json.dumps(snaps)), PolicyConfig(**kw),
                 historian=Historian(window_s=600.0) if historian else None)
    want = jreplay(json.loads(json.dumps(snaps)), JConfig(**kw),
                   historian=JHistorian(window_s=600.0) if historian else None)
    assert got == want
