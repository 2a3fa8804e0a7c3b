"""The port's observability plane against the JAX package's
(``tests/test_obs.py``): spans, the flight recorder, the metric registry
and its Prometheus text, the exporter, the fleet snapshot, and the plane
wired through the trainer, the checkpoint manager, the watchdog, the fault
hooks and the launcher.

- The span ring: the same sequence of spans into both packages' rings gives
  the same names, depths, steps, attributes, errors and drop counts.
- A flight record of either package passes both packages'
  ``validate_flight_record``.
- Prometheus text of the same counter snapshot: every TYPE and sample line
  equal, and every HELP line but those of the metrics whose doc the port
  words for its device (``PORT_WORDED``).
- Every counter and gauge name the port's sources emit is in the port's
  ``METRIC_REGISTRY``; the port's registry holds every JAX name with JAX's
  kind, plus the port's own ``async/round_wait_s``.
- Slice 1's model at a tiny width through the trainer: parameters bitwise
  equal with ``BAGUA_OBS`` on and off; with it on, the step's span names,
  the ledger's ``compile`` for the first step, the static footprint exactly
  ``plan_flat_bytes`` on the params component, the model flops of a step
  equal to the analytic count (flash attention's causal pairs included) and
  ``obs/mfu`` null-with-rationale on the CPU.
- The grad guard's abort, a fault fire, a watchdog abort and SIGTERM each
  leave a flight record.  No test here gates on wall-clock time.
"""

import ast
import functools
import glob
import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import bagua_tpu_torch as bt
from bagua_tpu.obs import export as jexport
from bagua_tpu.obs import recorder as jrecorder
from bagua_tpu.obs import spans as jspans
from bagua_tpu_torch.faults.inject import FaultSpec, fault_scope
from bagua_tpu_torch.models.transformer import lm_loss_fn
from bagua_tpu_torch.obs import export as obs_export
from bagua_tpu_torch.obs import ledger as obs_ledger
from bagua_tpu_torch.obs import recorder as obs_recorder
from bagua_tpu_torch.obs import spans as obs_spans
from bagua_tpu_torch.obs.memory import (live_memory_stats, plan_flat_bytes,
                                        static_footprint)
from bagua_tpu_torch.telemetry import counters

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=61, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=32)
BATCH, SEQ = 2, 16
#: metrics whose HELP text the port words for its device (the JAX text
#: names XLA's cost model, TPU HBM and cpu-sim)
PORT_WORDED = {"obs/mfu", "obs/hbm_static_footprint_bytes", "obs/hbm_peak_bytes",
               "obs/hbm_headroom_bytes", "obs/device_comm_s_per_step",
               "obs/device_comm_ici_s_per_step", "obs/device_overlap_fraction",
               "obs/http_requests", "serve/ttft_last_s"}
#: names only the port emits
PORT_ONLY = {"async/round_wait_s"}


@pytest.fixture(scope="module", autouse=True)
def process_group():
    bt.init_process_group(device="cpu")


@pytest.fixture()
def obs_on():
    for mod in (obs_spans, jspans):
        mod.set_enabled(True)
        mod.recorder.clear()
        mod.set_current_step(None)
    yield
    for mod in (obs_spans, jspans):
        mod.recorder.clear()
        mod.set_current_step(None)
        mod.set_enabled(None)


def _span_sequence(mod):
    mod.set_current_step(7)
    with mod.trace_span("outer", bucket=1):
        with mod.trace_span("inner", bytes=4096, step=9):
            pass
    with pytest.raises(ValueError):
        with mod.trace_span("boom"):
            raise ValueError("x")
    mod.recorder.set_capacity(8)
    try:
        for i in range(20):
            with mod.trace_span(f"s{i}", i=i):
                pass
        spans = mod.recorder.snapshot()
        dropped = mod.recorder.dropped
    finally:
        mod.recorder.set_capacity(512)
    keep = ("name", "depth", "step", "attrs", "error")
    return [{k: s.get(k) for k in keep} for s in spans], dropped


def test_span_ring_semantics_match_jax(obs_on):
    port = _span_sequence(obs_spans)
    jax_side = _span_sequence(jspans)
    assert port == jax_side
    spans, dropped = port
    assert [s["name"] for s in spans] == [f"s{i}" for i in range(12, 20)]
    assert dropped == 12


def test_span_nesting_depth_and_attrs(obs_on):
    obs_spans.set_current_step(7)
    with obs_spans.trace_span("outer", bucket=1):
        with obs_spans.trace_span("inner", bytes=4096, step=9):
            assert [s["name"] for s in obs_spans.recorder.active_snapshot()] == [
                "outer", "inner"]
    by_name = {s["name"]: s for s in obs_spans.recorder.snapshot()}
    outer, inner = by_name["outer"], by_name["inner"]
    assert (outer["depth"], inner["depth"]) == (0, 1)
    assert (outer["step"], inner["step"]) == (7, 9)
    assert outer["t0"] <= inner["t0"] and inner["t1"] <= outer["t1"]
    assert obs_spans.recorder.active_snapshot() == []


def test_spans_disabled_is_noop():
    obs_spans.set_enabled(False)
    try:
        obs_spans.recorder.clear()
        with obs_spans.trace_span("never", x=1) as s:
            assert s is None
        assert obs_spans.recorder.snapshot() == []
    finally:
        obs_spans.set_enabled(None)


def test_spans_on_another_thread_nest_on_their_own(obs_on):
    """The comm worker and the watchdog's waiter open spans beside the main
    thread: each thread keeps its own depth."""
    import threading

    def other():
        with obs_spans.trace_span("worker"):
            pass

    with obs_spans.trace_span("main"):
        t = threading.Thread(target=other, name="bagua-comm-worker")
        t.start()
        t.join()
    by_name = {s["name"]: s for s in obs_spans.recorder.snapshot()}
    assert by_name["worker"]["depth"] == 0 and by_name["main"]["depth"] == 0
    assert by_name["worker"]["thread"] == "bagua-comm-worker"


# ---- flight recorder -------------------------------------------------------


def _dumps(d, **match):
    out = []
    for p in sorted(glob.glob(os.path.join(str(d), "flight_*.json"))):
        rec = json.load(open(p))
        if all(rec.get(k) == v for k, v in match.items()):
            out.append(rec)
    return out


def test_flight_record_valid_in_both_packages(obs_on, tmp_path, monkeypatch):
    monkeypatch.setenv("BAGUA_OBS_DUMP_DIR", str(tmp_path / "port"))
    with obs_spans.trace_span("step/dispatch"):
        pass
    path = obs_recorder.dump_flight_record("watchdog_abort", reason="test",
                                           extra={"k": 1})
    rec = json.load(open(path))
    assert obs_recorder.validate_flight_record(rec) == []
    assert jrecorder.validate_flight_record(rec) == []
    assert [s["name"] for s in rec["spans"]] == ["step/dispatch"]
    monkeypatch.setenv("BAGUA_OBS_DUMP_DIR", str(tmp_path / "jax"))
    jpath = jrecorder.dump_flight_record("fault_fire", reason="x",
                                         fault_point="grad.poison")
    jrec = json.load(open(jpath))
    assert obs_recorder.validate_flight_record(jrec) == []
    broken = dict(rec, spans=[{"name": "x"}])
    assert obs_recorder.validate_flight_record(broken) == \
        jrecorder.validate_flight_record(broken) != []


def test_flight_dump_retention_cap_prunes_oldest(obs_on, tmp_path, monkeypatch):
    monkeypatch.setenv("BAGUA_OBS_DUMP_DIR", str(tmp_path))
    monkeypatch.setenv("BAGUA_OBS_DUMP_MAX_FILES", "3")
    for i in range(6):
        obs_recorder.dump_flight_record("fault_fire", fault_point=f"p{i}")
        os.utime(glob.glob(str(tmp_path / f"flight_fault_fire_p{i}_*.json"))[0],
                 (1000 + i, 1000 + i))
    left = sorted(os.path.basename(p) for p in glob.glob(str(tmp_path / "flight_*.json")))
    assert len(left) == 3 and all(f"_p{i}_" in n for i, n in zip((3, 4, 5), left))


def test_fault_fire_leaves_a_dump(obs_on, tmp_path, monkeypatch):
    from bagua_tpu_torch.faults import inject

    monkeypatch.setenv("BAGUA_OBS_DUMP_DIR", str(tmp_path))
    monkeypatch.setattr(obs_recorder, "_LAST_FIRE_DUMP", {})   # the per-point throttle
    with fault_scope(FaultSpec("store.op", count=1)):
        with pytest.raises(ConnectionError):
            inject.maybe_raise_store_error("get")
    (rec,) = _dumps(tmp_path, trigger="fault_fire")
    assert rec["fault_point"] == "store.op"
    # counters are process-global: other points may have fired before
    assert rec["fired_faults"]["store.op"] == rec["counters"]["faults/store.op/fired"] >= 1
    assert obs_recorder.validate_flight_record(rec) == []


def test_watchdog_abort_dump_and_section_span(obs_on, tmp_path, monkeypatch):
    from bagua_tpu_torch.communication import reset_abort
    from bagua_tpu_torch.watchdog import HangWatchdog

    monkeypatch.setenv("BAGUA_OBS_DUMP_DIR", str(tmp_path))
    wd = HangWatchdog(timeout_s=0.3, action="abort")
    try:
        with wd.watch("stuck_section"):
            assert wd.fired.wait(60)
            # the monitor dumps right after it sets ``fired``: keep the
            # section open until the record is on disk
            for _ in range(600):
                if _dumps(tmp_path, trigger="watchdog_abort"):
                    break
                time.sleep(0.1)
    finally:
        wd.stop()
        reset_abort()
    (rec,) = _dumps(tmp_path, trigger="watchdog_abort")
    assert "stuck_section" in rec["reason"]
    assert [s["name"] for s in rec["active_spans"]] == ["watchdog/stuck_section"]
    assert jrecorder.validate_flight_record(rec) == []
    assert "watchdog/stuck_section" in [s["name"] for s in obs_spans.recorder.snapshot()]


def test_sigterm_hook_dumps_and_still_dies(tmp_path):
    """The chained SIGTERM handler writes a ``signal`` dump and the process
    still dies of SIGTERM (the launcher's teardown and exit codes do not
    change)."""
    code = (
        "import os, signal, sys, time\n"
        "from bagua_tpu_torch.obs import recorder, spans\n"
        "assert recorder.maybe_install_signal_hook()\n"
        "with spans.trace_span('step/dispatch'):\n"
        "    pass\n"
        "print('ready', flush=True)\n"
        "time.sleep(60)\n"
    )
    env = dict(os.environ, BAGUA_OBS_DUMP_DIR=str(tmp_path), BAGUA_OBS="on")
    p = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                         stdout=subprocess.PIPE, text=True)
    try:
        assert p.stdout.readline().strip() == "ready"
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=60) == -signal.SIGTERM
    finally:
        if p.poll() is None:
            p.kill()
    (rec,) = _dumps(tmp_path, trigger="signal")
    assert rec["reason"] == "SIGTERM"
    assert [s["name"] for s in rec["spans"]] == ["step/dispatch"]


# ---- registry, Prometheus, exporter, fleet ----------------------------------


def _emitted_names():
    """(name or regex, is_regex) of every counter/gauge call site of the
    port's sources."""
    out = set()
    for path in sorted((REPO / "bagua_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                    and any(isinstance(t, ast.Name) and t.id == "stop_counter"
                            for t in node.targets):
                out.update((v.value, False) for v in node.value.values)
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("incr", "set_gauge", "incr_many")
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in ("counters", "_counters")):
                continue
            arg = node.args[0]
            args = arg.keys if isinstance(arg, ast.Dict) else [arg]
            for a in args:
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    out.add((a.value, False))
                elif isinstance(a, ast.JoinedStr):
                    rx = "".join(re.escape(v.value) if isinstance(v, ast.Constant) else ".+"
                                 for v in a.values)
                    out.add((rx, True))
                elif isinstance(a, ast.Call):   # stop_counter.get(kind, default)
                    out.update((c.value, False) for c in a.args
                               if isinstance(c, ast.Constant) and isinstance(c.value, str))
    return out


def test_registry_covers_every_emitted_name_with_jax_kinds():
    names = _emitted_names()
    assert len(names) >= 40, len(names)
    for name, is_rx in sorted(names):
        if is_rx:
            assert obs_export.any_registered_matches(name), name
        else:
            assert obs_export.is_registered(name), name
    reg, jreg = obs_export.METRIC_REGISTRY, jexport.METRIC_REGISTRY
    assert set(reg) - set(jreg) == PORT_ONLY
    for name, m in jreg.items():
        assert reg[name].kind == m.kind, name
    assert set(obs_export.LEDGER_CLASSES) == set(jexport.LEDGER_CLASSES)


def test_prometheus_text_equal_for_same_snapshot():
    snap = {name: i * 1.5 for i, name in enumerate(sorted(jexport.METRIC_REGISTRY))}
    snap["not/registered"] = 3
    port = obs_export.render_prometheus(snap).splitlines()
    jax_text = jexport.render_prometheus(snap).splitlines()
    assert len(port) == len(jax_text)
    worded = {obs_export.prometheus_name(n) for n in PORT_WORDED}
    for a, b in zip(port, jax_text):
        if a.startswith("# HELP ") and a.split()[2] in worded:
            assert b.split()[2] == a.split()[2]
            continue
        assert a == b
    assert "# TYPE bagua_not_registered untyped" in port


def test_exporter_jsonl_and_prometheus(obs_on, tmp_path):
    obs_export.reset_local_summary()
    obs_export.note_step(5, 0.01)
    counters.incr("comm/aborts")
    exp = obs_export.MetricsExporter(str(tmp_path), interval_s=3600)
    rec = exp.export_once()
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert json.loads(lines[-1])["obs"]["step"] == rec["obs"]["step"] == 5
    prom = (tmp_path / "metrics.prom").read_text()
    assert "# TYPE bagua_comm_aborts counter" in prom and "untyped" not in prom
    assert all(obs_export.is_registered(n) for n in rec["counters"])
    obs_export.reset_local_summary()


def test_fleet_snapshot_valid_in_both_packages(tmp_path):
    members = {0: {"grad_unhealthy": 1, "obs": {"rank": 0, "step": 3, "goodput_fraction": 0.5,
                                                "worst_badput_class": "compile"}},
               1: None}
    rec = obs_export.build_fleet_record(2, members)
    assert obs_export.validate_fleet_snapshot(rec) == []
    assert jexport.validate_fleet_snapshot(rec) == []
    assert rec["efficiency"]["ranks"]["0"]["goodput_fraction"] == 0.5
    path = tmp_path / "fleet.json"
    assert obs_export.write_fleet_snapshot(str(path), 2, record=rec)
    assert jexport.validate_fleet_snapshot(json.load(open(path))) == []


def test_launcher_writes_the_fleet_snapshot(tmp_path, monkeypatch):
    """``BAGUA_OBS_FLEET_OUT`` is the launcher's own now: the coordinator's
    monitor merges the members' health payloads into a record both
    packages' ``validate_fleet_snapshot`` accept."""
    from types import SimpleNamespace

    from bagua_tpu_torch.distributed import run as run_mod

    out = tmp_path / "fleet.json"
    monkeypatch.setenv("BAGUA_OBS_FLEET_OUT", str(out))
    run_mod.refuse_missing_modules()   # accepted
    health = {0: {"obs": {"rank": 0, "step": 4}}, 1: {"grad_unhealthy": 2}}
    tracker = SimpleNamespace(health_of=lambda n: health.get(n))
    rec = run_mod._maybe_write_fleet_snapshot(SimpleNamespace(epoch=3, ranks=[0, 1]), tracker)
    on_disk = json.load(open(out))
    assert on_disk["epoch"] == 3 and on_disk["nnodes"] == 2
    assert on_disk["ranks"]["1"]["health"] == {"grad_unhealthy": 2}
    assert obs_export.validate_fleet_snapshot(on_disk) == []
    assert jexport.validate_fleet_snapshot(on_disk) == []
    assert rec["ranks"] == on_disk["ranks"]
    monkeypatch.delenv("BAGUA_OBS_FLEET_OUT")
    assert run_mod._maybe_write_fleet_snapshot(SimpleNamespace(epoch=3, ranks=[0]),
                                               tracker) is None


def test_health_snapshot_carries_the_obs_summary(obs_on, tmp_path, monkeypatch):
    from bagua_tpu_torch.elastic import membership as mb

    obs_export.reset_local_summary()
    assert mb.local_health_snapshot() is None or "obs" not in mb.local_health_snapshot()
    obs_export.note_step(12, 0.02)
    snap = mb.local_health_snapshot()
    assert snap["obs"]["step"] == 12 and snap["obs"]["step_dt_p50"] == 0.02
    assert mb.health_event_count(snap) == mb.health_event_count(
        {k: v for k, v in snap.items() if k != "obs"})
    obs_export.reset_local_summary()


# ---- the plane through the trainer (slice 1's model, tiny) -----------------


def _slice1_run(obs: bool, steps: int = 4, grad_guard: str = "off", **kw):
    obs_spans.set_enabled(obs)
    obs_spans.recorder.clear()
    obs_ledger.ledger.reset()
    obs_export.reset_local_summary()
    cfg = bt.TransformerConfig(**CFG, dtype=torch.float32)
    model = bt.TransformerLM(cfg, device="cpu", seed=1)
    trainer = bt.BaguaTrainer(lm_loss_fn, functools.partial(torch.optim.AdamW, lr=1e-3),
                              bt.algorithms.GradientAllReduceAlgorithm(), device="cpu",
                              bucket_bytes=8192, grad_guard=grad_guard, **kw)
    state = trainer.init(model)
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, CFG["vocab_size"], (BATCH, SEQ + 1), generator=g)}
    per_step = []
    for _ in range(steps):
        before = len(obs_spans.recorder.snapshot())
        state, loss = trainer.train_step(state, batch)
        per_step.append([s["name"] for s in obs_spans.recorder.snapshot()[before:]])
    return trainer, state, per_step


def _analytic_step_flops():
    d, f, v, L = CFG["d_model"], CFG["d_ff"], CFG["vocab_size"], CFG["n_layers"]
    h = CFG["n_heads"]
    tokens = BATCH * SEQ
    dense = 2 * tokens * (L * (4 * d * d + 3 * d * f) + d * v)
    attention = 4 * BATCH * h * (d // h) * (SEQ * (SEQ + 1) // 2) * L
    return 3 * (dense + attention)


def test_trainer_obs_on_off_bitwise_and_spans(obs_on):
    on_trainer, on_state, per_step = _slice1_run(True)
    try:
        spans = obs_spans.recorder.snapshot()
        names = {s["name"] for s in spans}
        assert {"step/build", "step/dispatch", "trace/comm_stage", "trace/bucket_collective",
                "trace/optimizer_apply"} <= names
        # the first step is the build; every later one a plain dispatch with
        # one bucket collective per bucket
        n_buckets = len(on_trainer.plan.buckets)
        assert per_step[0].count("step/build") == 1
        for later in per_step[1:]:
            assert "step/build" not in later
            assert later.count("step/dispatch") == 1
            assert later.count("trace/bucket_collective") == n_buckets
        buckets = [s for s in spans if s["name"] == "trace/bucket_collective"]
        assert all(s["attrs"]["tier"] == "flat" and s["attrs"]["bytes"] > 0 for s in buckets)
        rep = obs_ledger.ledger.report()
        assert rep["classes"]["compile"] > 0 and rep["classes"]["productive_step"] > 0
        assert rep["step_windows"] == 3
        assert sum(rep["classes"].values()) <= rep["wall_s"] * 1.01 + 1e-6
        assert on_trainer._mfu_flops == _analytic_step_flops()
        mfu = obs_export.last_mfu()
        assert mfu["available"] is False and "peak" in mfu["rationale"]
        summary = obs_export.local_obs_summary()
        assert summary["step"] == 4 and summary["mfu"] is None
        assert obs_export.last_hbm_live()["available"] is False
    finally:
        obs_spans.set_enabled(True)
    off_trainer, off_state, _ = _slice1_run(False)
    try:
        assert obs_spans.recorder.snapshot() == []
        assert obs_ledger.ledger.report() is None
        assert off_trainer.anomaly_detector is None
        for (n, a), (_, b) in zip(on_state.model.named_parameters(),
                                  off_state.model.named_parameters()):
            assert torch.equal(a, b), n
    finally:
        obs_spans.set_enabled(True)


def test_static_footprint_is_exact_over_the_flats(obs_on):
    trainer, state, _ = _slice1_run(True, steps=1)
    fp = obs_export.last_hbm_footprint()
    assert fp == static_footprint(trainer, state)
    assert fp["params_bytes"] == plan_flat_bytes(trainer.plan) == fp["grad_flats_bytes"]
    assert fp["flat_resident"] and fp["compiled_memory_analysis"] is None
    # AdamW keeps two moments a parameter and a step count a flat
    n = sum(p.numel() for p in state.model.parameters())
    assert fp["opt_state_bytes"] >= 2 * 4 * n
    assert live_memory_stats("cpu")["available"] is False


def test_obs_adds_no_synchronization_to_the_step(monkeypatch, obs_on):
    """With the plane on, the step never calls torch.cuda.synchronize and
    reads no more tensors back (``item``, ``cpu``, ``tolist``) than the
    plane-off step does."""
    calls = {"n": 0}

    def counting(orig):
        def f(self, *a, **k):
            calls["n"] += 1
            return orig(self, *a, **k)
        return f

    for name in ("item", "cpu", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, counting(getattr(torch.Tensor, name)))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: pytest.fail("the step synchronized"))
    _slice1_run(True, steps=3)
    on = calls["n"]
    calls["n"] = 0
    _slice1_run(False, steps=3)
    assert on == calls["n"]


def test_grad_guard_abort_dump(obs_on, tmp_path, monkeypatch):
    from bagua_tpu_torch.communication import BaguaAborted, reset_abort

    monkeypatch.setenv("BAGUA_OBS_DUMP_DIR", str(tmp_path))
    monkeypatch.setattr(obs_recorder, "_LAST_FIRE_DUMP", {})   # the per-point throttle
    try:
        with fault_scope(FaultSpec("grad.poison", step=1)):
            with pytest.raises(BaguaAborted):
                _slice1_run(True, steps=4, grad_guard="abort")
    finally:
        reset_abort()
    (rec,) = _dumps(tmp_path, trigger="grad_guard_abort")
    assert rec["extra"]["step"] == 2 and rec["extra"]["policy"] == "abort"
    assert rec["extra"]["unhealthy_buckets"]
    assert rec["step_metrics"]["grad_healthy"] == 0.0
    assert obs_recorder.validate_flight_record(rec) == []
    assert jrecorder.validate_flight_record(rec) == []
    (fire,) = _dumps(tmp_path, trigger="fault_fire")
    assert fire["fault_point"] == "grad.poison"


def test_grad_guard_skip_reclassifies_the_rewound_window(obs_on):
    with fault_scope(FaultSpec("grad.poison", step=2)):
        trainer, _, _ = _slice1_run(True, steps=5, grad_guard="skip")
    trainer.flush_grad_health()
    rep = obs_ledger.ledger.report()
    assert rep["rewind_windows"] == 1 and rep["classes"]["rewind"] > 0


def test_checkpoint_spans_feed_the_ledger(obs_on, tmp_path):
    trainer, state, _ = _slice1_run(True, steps=1)
    mgr = bt.checkpoint.BaguaCheckpointManager(str(tmp_path / "ck"), async_save=False)
    trainer.save_checkpoint(mgr, 1, state)
    trainer.restore_checkpoint(mgr, state)
    mgr.close()
    names = [s["name"] for s in obs_spans.recorder.snapshot()]
    assert "ckpt/save" in names and "ckpt/restore" in names and "ckpt/verify" in names
    assert obs_ledger.ledger.report()["classes"]["checkpoint"] > 0
    assert obs_export._LAST_CKPT_DIRECTORY.endswith("ck")


def test_trainer_starts_the_exporter(obs_on, tmp_path, monkeypatch):
    monkeypatch.setattr(obs_export, "_GLOBAL_EXPORTER", None)
    monkeypatch.setenv("BAGUA_OBS_EXPORT_DIR", str(tmp_path))
    monkeypatch.setenv("BAGUA_OBS_EXPORT_INTERVAL_S", "3600")
    trainer, _, _ = _slice1_run(True, steps=2)
    exp = obs_export._GLOBAL_EXPORTER
    try:
        rec = exp.export_once()
        assert rec["obs"]["step"] == 2 and "obs/ledger/wall_s" in rec["counters"]
    finally:
        exp.stop(final_export=False)
        obs_export._GLOBAL_EXPORTER = None
