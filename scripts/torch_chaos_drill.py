#!/usr/bin/env python
"""Chaos drill of the port: the full fault matrix, each defense proven end
to end (injected -> detected -> recovered).

Port of ``scripts/chaos_drill.py``: the same 16 drills under the same names,
the same verdict shape (``injected``, ``detected``, ``recovered``,
``details``), the same flight-record expectations and the same goodput
ledger class check (``obs.ledger.DRILL_BADPUT_EXPECTATIONS``).  The JAX
drill runs every drill in one process on 8 virtual devices; here a drill
that needs peers runs in ranks of its own:

* in this process, at world 1 (:data:`IN_PROCESS`): store flake, heartbeat
  loss, checkpoint corruption, NaN-gradient skip, collective hang, health
  fence, and the autopilot's straggler fence, SLO ladder, checkpoint
  quarantine, trend rules and off-mode no-op;
* in two gloo ranks (:data:`RANKS_2`): the goldens under the guard, the
  straggler (sync against async; the detector flags the gated rank and the
  straggler itself), the async partition's bounded-staleness catch-up and
  the autopilot's victim retune hint (async model average negotiates
  nothing at world 1, so neither its boundaries nor its rounds exist there);
* in four gloo ranks on the ``{inter: 2, intra: 2}`` mesh
  (:data:`RANKS_4`): the autopilot's ``compress_dcn`` hint actuating the
  compressed inter-node ring, its wire bytes read from the collective log of
  ``analysis/collective_check.py``.

:func:`run_in_process` and :func:`run_rank_drills` are the two halves a
caller with its own process group and spawns (``chip_smoke.py``) runs;
:func:`main` runs both, spawning this script as the ranks.

Every drill's failure mode must leave a schema-valid flight-recorder dump
naming the firing fault point, and the drills of
``DRILL_BADPUT_EXPECTATIONS`` must feed their badput class.

Usage::

    python scripts/torch_chaos_drill.py [--only DRILL ...] [--out PATH]
        [--dump-dir DIR] [--device cuda|cpu] [--golden-npz PATH]

Writes ``chiprun_out/torch_chaos_drill.json`` for the full matrix (a
``--only`` subset writes only with ``--out``); exit code 0 iff every drill
passed.  ``--golden-npz`` takes the golden task's arrays (``x``, ``y`` and
``state/<parameter>``) from a file instead of the seed.
"""

import argparse
import contextlib
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _early_env():
    """Before the port is imported: no process-wide watchdog (the hang
    drill keeps its own; the global one's waiter runs the same
    ``collective.hang`` hook and would race it for the armed fire), and a
    FRESH flight-recorder directory (a stale dump satisfying an expectation
    would mask a broken recorder).  A rank worker inherits its parent's."""
    os.environ["BAGUA_COMM_TIMEOUT_S"] = "off"
    if "--rank-group" in sys.argv:
        return
    d = None
    for i, arg in enumerate(sys.argv):
        if arg == "--dump-dir" and i + 1 < len(sys.argv):
            d = sys.argv[i + 1]
        elif arg.startswith("--dump-dir="):
            d = arg.split("=", 1)[1]
    if d:
        os.makedirs(d, exist_ok=True)
        if os.listdir(d):
            sys.exit(f"--dump-dir {d} is not empty — flight expectations need a "
                     "fresh directory")
    else:
        d = tempfile.mkdtemp(prefix="chaos_obs_")
    os.environ["BAGUA_OBS_DUMP_DIR"] = d


if __name__ == "__main__":
    _early_env()
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

OUT = os.path.join(REPO, "chiprun_out", "torch_chaos_drill.json")

#: the JAX package's drill order (``scripts/chaos_drill.py:1583-1611``)
DRILL_NAMES = (
    "store_flake_retry",
    "heartbeat_loss_lease_expiry",
    "checkpoint_corruption_fallback_restore",
    "nan_grad_skip_loss_continuity",
    "grad_guard_on_goldens_unchanged",
    "collective_hang_watchdog_recovery",
    "straggler_throughput_degrades",
    "async_partition_staleness_catchup",
    "health_fence_flight_record",
    "autopilot_straggler_fence_resize",
    "autopilot_victim_retune_hint",
    "autopilot_slo_escalation_ladder",
    "autopilot_ckpt_quarantine",
    "autopilot_trend_rules",
    "autopilot_compress_actuates_codec",
    "autopilot_off_noop",
)
#: drills that need peers: two ranks, and the 2 x 2 mesh's four
RANKS_2 = ("grad_guard_on_goldens_unchanged", "straggler_throughput_degrades",
           "async_partition_staleness_catchup", "autopilot_victim_retune_hint")
RANKS_4 = ("autopilot_compress_actuates_codec",)
IN_PROCESS = tuple(n for n in DRILL_NAMES if n not in RANKS_2 + RANKS_4)
#: rank group -> (world, ranks a node)
GROUPS = {2: (2, None), 4: (4, 2)}

#: drill name -> the fault point (or non-fault trigger) whose
#: flight-recorder dump the drill must leave behind
FLIGHT_EXPECTATIONS = {
    "store_flake_retry": {"fault_point": "store.op"},
    "heartbeat_loss_lease_expiry": {"fault_point": "elastic.heartbeat"},
    "checkpoint_corruption_fallback_restore": {"fault_point": "ckpt.write"},
    "nan_grad_skip_loss_continuity": {"fault_point": "grad.poison"},
    "collective_hang_watchdog_recovery": {"fault_point": "collective.hang",
                                          "trigger": "watchdog_abort"},
    "straggler_throughput_degrades": {"fault_point": "step.straggle",
                                      "trigger": "step_anomaly"},
    "async_partition_staleness_catchup": {"fault_point": "async.partition"},
    "health_fence_flight_record": {"trigger": "health_fence"},
    # fleet autopilot: every decided action leaves an `autopilot_action`
    # flight dump with its triggering evidence
    "autopilot_straggler_fence_resize": {"fault_point": "step.straggle",
                                         "trigger": "autopilot_action"},
    "autopilot_victim_retune_hint": {"fault_point": "step.straggle",
                                     "trigger": "autopilot_action"},
    "autopilot_slo_escalation_ladder": {"trigger": "autopilot_action"},
    "autopilot_ckpt_quarantine": {"fault_point": "ckpt.write",
                                  "trigger": "autopilot_action"},
    "autopilot_trend_rules": {"trigger": "autopilot_action"},
}

#: the golden task's batch: the full global batch, the same mean under any
#: split of it
GOLDEN_BATCH = 64
#: checks-in of the autotuned drills' trainers (the trainer's default is
#: 100, the JAX drills' cadence): a smaller cadence, the same protocol
CHECKIN_STEPS = 10
#: the anomaly legs' detector: the JAX drill's warm-up and window
ANOMALY_ENV = {"BAGUA_OBS_ANOMALY_WARMUP": "4", "BAGUA_OBS_ANOMALY_WINDOW": "24"}


def log(*args):
    print(*args, flush=True)


@contextlib.contextmanager
def _env(**values):
    """Set environment variables for the block (None unsets), restoring
    what was there."""
    saved = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _counter_deltas(before):
    from bagua_tpu_torch.telemetry import counters

    after = counters.snapshot()
    keys = set(before) | set(after)
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in sorted(keys)
            if after.get(k, 0) != before.get(k, 0)}


def _snapshot():
    from bagua_tpu_torch.telemetry import counters

    return counters.snapshot()


def _ledger_class_check(cls, before, after):
    """The class-delta verdict: the drill's defense path must have added
    wall seconds to its badput class (and, for rewind, one reclassified
    window per grad-guard skip)."""
    before_classes = (before or {}).get("classes") or {}
    after_classes = (after or {}).get("classes") or {}
    delta = round(after_classes.get(cls, 0.0) - before_classes.get(cls, 0.0), 6)
    verdict = {"badput_class": cls, "delta_s": delta, "surfaced": delta > 0}
    if cls == "rewind":
        verdict["rewind_windows_delta"] = (
            (after or {}).get("rewind_windows", 0) - (before or {}).get("rewind_windows", 0))
    return verdict


def _flight_record_check(expect, dump_dir):
    """Scan ``dump_dir`` for a schema-valid flight record matching the
    expectation (fault point and/or trigger)."""
    from bagua_tpu_torch.obs import recorder as obs_recorder

    point = expect.get("fault_point")
    trigger = expect.get("trigger")
    found_point = found_trigger = False
    problems = []
    for path in sorted(glob.glob(os.path.join(dump_dir, "flight_*.json"))):
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, ValueError) as e:
            problems.append(f"{os.path.basename(path)}: unreadable ({e})")
            continue
        bad = obs_recorder.validate_flight_record(rec)
        if bad:
            problems.append(f"{os.path.basename(path)}: {bad}")
            continue
        if point and (rec.get("fault_point") == point
                      or point in rec.get("fired_faults", {})):
            found_point = True
        if trigger and rec.get("trigger") == trigger:
            found_trigger = True
    ok = (found_point or not point) and (found_trigger or not trigger)
    verdict = {"schema_valid": ok, "found": ok}
    if point:
        verdict["fault_point"] = point
    if trigger:
        verdict["trigger"] = trigger
    if problems:
        verdict["problems"] = problems[:5]
    return verdict


def drill_passed(result) -> bool:
    return bool(result["detected"] and result["recovered"]
                and result.get("flight_record", {}).get("schema_valid", True)
                and result.get("ledger", {}).get("surfaced", True))


# ---- the golden task ----------------------------------------------------------


def golden_task(device, npz=None):
    """``(loss_fn, model, batch)``: MLP (32, 8) on x ``[GOLDEN_BATCH, 4]``
    with labels ``argmax(x @ W)``, from a numpy seed, or the arrays of
    ``npz`` (``x``, ``y``, ``state/<parameter name>``)."""
    from bagua_tpu_torch.models.mlp import MLP

    model = MLP(4, features=(32, 8), device=device, seed=2)
    if npz:
        data = np.load(npz)
        x, y = data["x"], data["y"]
        model.load_state_dict({k[len("state/"):]: torch.from_numpy(data[k])
                               for k in data.files if k.startswith("state/")})
    else:
        rng = np.random.default_rng(0)
        x = rng.normal(size=(GOLDEN_BATCH, 4)).astype(np.float32)
        y = np.argmax(x @ rng.normal(size=(4, 8)).astype(np.float32), -1)

    def loss_fn(m, b):
        return torch.nn.functional.cross_entropy(m(b["x"]), b["y"])

    return loss_fn, model, {"x": x.astype(np.float32), "y": y.astype(np.int64)}


def _sgd(lr=0.1, momentum=0.0):
    import functools

    return functools.partial(torch.optim.SGD, lr=lr, momentum=momentum)


def _golden_trainer(algo, ctx, **kw):
    """A trainer of ``algo`` over the golden task of the drill's context
    (its device, and its ``golden`` npz or the seed)."""
    from bagua_tpu_torch.core.backend import BaguaTrainer

    device = ctx["device"]
    loss_fn, model, batch = golden_task(device, ctx.get("golden"))
    kw.setdefault("autotune", False)
    t = BaguaTrainer(loss_fn, None if getattr(algo, "owns_optimizer", False) else _sgd(),
                     algo, device=device, **kw)
    s = t.init(model)
    return t, s, t.shard_batch(batch, global_batch=True)


def _params(trainer, state):
    return {k: v.detach().cpu() for k, v in trainer.unstack_params(state).items()}


# ---- drills run in this process -------------------------------------------


def drill_store_flake(ctx):
    """store.op flake on a real TCPStore connection -> retry recovers."""
    from bagua_tpu_torch.contrib.utils.tcp_store import TCPStore, start_tcp_store
    from bagua_tpu_torch.distributed import run as run_mod
    from bagua_tpu_torch.faults import inject
    from bagua_tpu_torch.faults.inject import FaultSpec, fault_scope

    server = start_tcp_store("127.0.0.1", 0)
    try:
        host, port = server.address

        class _Args:
            master_addr = host
            restart_coordinator_port = port

        orig = run_mod._connect_restart_store
        run_mod._connect_restart_store = (
            lambda args, timeout_s=60.0: TCPStore(host, port, timeout_s=timeout_s))
        try:
            store = run_mod._RestartStore(args=_Args())
            store.set("drill/k", "v1")
            with fault_scope(FaultSpec("store.op")):
                got = store.get("drill/k")
                recovered = got == b"v1"
                fired = inject.get_plan().fired("store.op")
        finally:
            run_mod._connect_restart_store = orig
        return {"injected": True, "detected": bool(fired), "recovered": recovered,
                "details": f"get returned {got!r} after injected flake + "
                           "reconnect-and-retry"}
    finally:
        server.stop()


def drill_heartbeat_loss(ctx):
    """Dropped heartbeats starve the lease -> tracker expiry (the elastic
    shrink trigger), then beats resume and the next epoch re-admits."""
    from bagua_tpu_torch.contrib.utils.store import InMemoryStore
    from bagua_tpu_torch.elastic.membership import (
        LeaseHeartbeat,
        LeaseTracker,
        MembershipClient,
    )
    from bagua_tpu_torch.faults import inject
    from bagua_tpu_torch.faults.inject import FaultSpec, fault_scope

    store = InMemoryStore()
    client = MembershipClient(store, node_id=0, max_nnodes=1)
    hb = LeaseHeartbeat(lambda: store, node_id=0, epoch=0, interval_s=0.05).start()
    try:
        deadline = time.time() + 10
        while client.read_beats(0, [0])[0] is None and time.time() < deadline:
            time.sleep(0.05)
        tracker = LeaseTracker(client, epoch=0, member_ids=[0], ttl_s=0.4)
        healthy_before = tracker.poll() == []
        with fault_scope(FaultSpec("elastic.heartbeat", count=-1)):
            expired = []
            deadline = time.time() + 10
            while not expired and time.time() < deadline:
                time.sleep(0.1)
                expired = tracker.poll()
            detected = expired == [0]
            inject.record_recovery("elastic.heartbeat")
        # beats resume once the fault disarms: the rejoin half of
        # shrink -> regrow
        seq0 = client.read_beats(0, [0])[0]
        deadline = time.time() + 10
        recovered = False
        while time.time() < deadline:
            time.sleep(0.1)
            seq = client.read_beats(0, [0])[0]
            if seq is not None and seq0 is not None and seq > seq0:
                recovered = True
                break
        return {"injected": True, "detected": detected,
                "recovered": bool(healthy_before and recovered),
                "details": "lease expired under beat starvation; beats resumed after disarm"}
    finally:
        hb.stop()


def _ckpt_state(v, device):
    return {"w": torch.arange(4096, dtype=torch.float32, device=device) * v,
            "step": torch.tensor(0, dtype=torch.int32, device=device)}


def drill_checkpoint_corruption(ctx):
    """Corrupt the newest checkpoint post-publish -> restore falls back to
    the previous step and the content digest verifies it."""
    from bagua_tpu_torch.checkpoint import BaguaCheckpointManager
    from bagua_tpu_torch.faults.inject import FaultSpec, fault_scope

    device = ctx["device"]
    mgr = BaguaCheckpointManager(os.path.join(ctx["tmp"], "ckpt"), async_save=False,
                                 max_to_keep=5)
    mgr.save(1, _ckpt_state(1.0, device))
    mgr.save(2, _ckpt_state(2.0, device))
    with fault_scope(FaultSpec("ckpt.write", step=3)):
        mgr.save(3, _ckpt_state(3.0, device))
        before = _snapshot()
        step, restored = mgr.try_restore(_ckpt_state(0.0, device))
        deltas = _counter_deltas(before)
    mgr.close()
    ok = (step == 2
          and torch.equal(restored["w"].cpu(), _ckpt_state(2.0, "cpu")["w"])
          and deltas.get("ckpt/verified_restores", 0) >= 1)
    return {"injected": True,
            "detected": deltas.get("ckpt/integrity_failures", 0) >= 1,
            "recovered": bool(ok),
            "details": f"latest (3) corrupted; restore landed on step {step} with "
                       "verified checksum"}


def nan_grad_runs(ctx):
    """The NaN-gradient drill's two runs on the context's golden task: a
    clean 9-step run and a 10-step run poisoned at step 5 under the grad
    guard's ``skip``.  Returns
    ``{"clean": (loss, params), "skip": (loss, params), "fired", "deltas"}``."""
    from bagua_tpu_torch.algorithms import GradientAllReduceAlgorithm
    from bagua_tpu_torch.faults import inject
    from bagua_tpu_torch.faults.inject import FaultSpec, fault_scope

    def run(n, guard="off", poison=None):
        cm = (fault_scope(FaultSpec("grad.poison", step=poison))
              if poison is not None else contextlib.nullcontext())
        with cm:
            t, s, b = _golden_trainer(GradientAllReduceAlgorithm(), ctx, grad_guard=guard)
            loss = None
            for _ in range(n):
                s, loss = t.train_step(s, b)
            if guard != "off":
                t.flush_grad_health()
            fired = inject.get_plan().fired("grad.poison") if poison is not None else False
        return float(loss), _params(t, s), fired

    before = _snapshot()
    l_clean, p_clean, _ = run(9)
    l_skip, p_skip, fired = run(10, guard="skip", poison=5)
    return {"clean": (l_clean, p_clean), "skip": (l_skip, p_skip), "fired": fired,
            "deltas": _counter_deltas(before)}


def drill_nan_grad_skip(ctx):
    """grad.poison at step 5 under the guard's ``skip``: the rewound run of
    n steps must be bitwise a clean run of n-1 steps on the golden task
    (same batch every step, so skipping one update IS running one fewer)."""
    out = nan_grad_runs(ctx)
    (l_clean, p_clean), (l_skip, p_skip) = out["clean"], out["skip"]
    exact = all(torch.equal(p_clean[k], p_skip[k]) for k in p_clean)
    return {"injected": True,
            "detected": bool(out["fired"]
                             and out["deltas"].get("grad_guard/skipped_steps", 0) == 1),
            "recovered": bool(exact and np.isfinite(l_skip)),
            "final_loss": l_skip,
            "details": f"poisoned 10-step run final loss {l_skip:.6f} == clean 9-step run "
                       f"{l_clean:.6f}; params bit-identical: {exact}"}


def drill_collective_hang(ctx):
    """Wedged readback -> watchdog fires + aborts -> reset_abort resumes a
    live overlap+flat trainer; a second episode proves re-arming."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.algorithms import GradientAllReduceAlgorithm
    from bagua_tpu_torch.core.backend import BaguaTrainer
    from bagua_tpu_torch.faults.inject import FaultSpec, fault_scope
    from bagua_tpu_torch.models.mlp import MLP
    from bagua_tpu_torch.watchdog import HangWatchdog

    device = ctx["device"]
    model = MLP(4, features=(16, 8), device=device, seed=1)
    g = torch.Generator().manual_seed(0)
    batch = {"x": torch.randn((16, 4), generator=g), "y": torch.zeros((16,), dtype=torch.int64)}
    t = BaguaTrainer(lambda m, b: torch.nn.functional.cross_entropy(m(b["x"]), b["y"]),
                     _sgd(), GradientAllReduceAlgorithm(), device=device, autotune=False,
                     accum_steps=2, overlap="on", flat_resident="on")
    s = t.init(model)
    b = t.shard_batch(batch, global_batch=True)
    s, _ = t.train_step(s, b)

    before = _snapshot()
    wd = HangWatchdog(timeout_s=0.3, action="abort")
    episodes = []
    try:
        for episode in range(2):
            deadline = time.time() + 10
            while not wd._armed and time.time() < deadline:
                time.sleep(0.05)
            with fault_scope(FaultSpec("collective.hang", duration_s=1.5)):
                wd.fired.clear()
                wd.watch_result(np.zeros(()), f"wedged-step-{episode}")
                deadline = time.time() + 15
                while not bt.is_aborted() and time.time() < deadline:
                    time.sleep(0.05)
                fired = wd.fired.is_set() and bt.is_aborted()
                failed_fast = False
                try:
                    s, _ = t.train_step(s, b)
                except bt.BaguaAborted:
                    failed_fast = True
                deadline = time.time() + 15
                while wd._active and time.time() < deadline:
                    time.sleep(0.05)
                # reset INSIDE the armed scope so the recovery is
                # attributed to the injected hang in the counters
                bt.reset_abort()
            s, loss = t.train_step(s, b)
            episodes.append(fired and failed_fast and bool(np.isfinite(float(loss))))
    finally:
        wd.stop()
        bt.reset_abort()
        if t._worker is not None:
            t._worker.close()
    plan_fired = _counter_deltas(before).get("faults/collective.hang/fired", 0) >= 2
    return {"injected": True, "detected": bool(all(episodes) and plan_fired),
            "recovered": bool(all(episodes) and len(episodes) == 2),
            "details": f"2 hang episodes: abort+fail-fast+resume each time ({episodes})"}


def drill_health_fence(ctx):
    """Chronic bad worker health -> the coordinator's fence, end to end
    through the production pieces: per-rank beacon files -> the launcher's
    merged heartbeat payload -> LeaseTracker harvesting ->
    ``publish_health_fence``, which publishes the ``health_fenced`` stop
    AND dumps the flight record; the coordinator-side fleet snapshot is
    written and schema-validated alongside."""
    from bagua_tpu_torch.contrib.utils.store import InMemoryStore
    from bagua_tpu_torch.distributed.run import publish_health_fence
    from bagua_tpu_torch.elastic import membership as mb
    from bagua_tpu_torch.obs import export as obs_export

    tmp = ctx["tmp"]
    store = InMemoryStore()
    client = mb.MembershipClient(store, node_id=0, max_nnodes=2)
    beacons = [os.path.join(tmp, f"fence_beacon.r{i}") for i in range(2)]
    with open(beacons[0], "w") as f:
        json.dump({"grad_unhealthy": 2,
                   "obs": {"rank": 2, "step": 41, "step_dt_p50": 0.01,
                           "step_dt_p90": 0.02}}, f)
    with open(beacons[1], "w") as f:
        json.dump({"async_missed": 1,
                   "obs": {"rank": 3, "step": 40, "step_dt_p50": 0.01,
                           "step_dt_p90": 0.03}}, f)
    hb = mb.LeaseHeartbeat(lambda: store, node_id=1, epoch=0, interval_s=0.05, max_nnodes=2,
                           health_source=mb.merged_health_source(beacons)).start()
    try:
        client.beat(0, 1)  # the coordinator's own (healthy) heartbeat
        tracker = mb.LeaseTracker(client, epoch=0, member_ids=[1], ttl_s=30.0,
                                  fence_unhealthy_after=3, observe_only_ids=[0])
        unhealthy = []
        deadline = time.time() + 10
        while not unhealthy and time.time() < deadline:
            time.sleep(0.1)
            tracker.poll()
            unhealthy = tracker.unhealthy_members()
        detected = unhealthy == [1]
        if detected:
            publish_health_fence(client, 0, tracker, unhealthy)
        stop = client.read_stop(0)
        fenced = bool(stop and stop["kind"] == mb.STOP_HEALTH and stop["nodes"] == [1])
        fleet_path = os.path.join(tmp, "fleet_snapshot.json")
        obs_export.write_fleet_snapshot(
            fleet_path, 0, {nid: tracker.health_of(nid) for nid in (0, 1)})
        with open(fleet_path) as f:
            fleet = json.load(f)
        fleet_ok = (not obs_export.validate_fleet_snapshot(fleet)
                    and fleet["ranks"]["1"]["obs"].get("2", {}).get("step") == 41
                    and fleet["ranks"]["1"]["health"].get("grad_unhealthy") == 2)
    finally:
        hb.stop()
    return {"injected": True, "detected": bool(detected),
            "recovered": bool(fenced and fleet_ok),
            "fleet_snapshot_valid": bool(fleet_ok),
            "details": f"tracker named node(s) {unhealthy}; stop event "
                       f"{stop and stop['kind']}; fleet snapshot carries per-rank obs "
                       f"summaries (valid: {fleet_ok})"}


# ---- the fleet autopilot's drills --------------------------------------------


def _autopilot_engine(mode="act", actuators=None, **cfg):
    from bagua_tpu_torch.autopilot import AutopilotEngine, PolicyConfig

    base = dict(mode=mode, sustain=2, cooldown_s=0.0, budget=8, staleness_s=60.0,
                slo_goodput=0.0, straggler_ratio=3.0, suspect_ttl_s=600.0,
                ckpt_failures=3, switch_family="async")
    base.update(cfg)
    return AutopilotEngine(config=PolicyConfig(**base), actuators=actuators)


def _fleet_record_from_beacon(beacon_path, node_id=1):
    """The production coordinator merge over one worker beacon: node 0 is
    the (payload-less) coordinator, ``node_id`` the reporting worker."""
    from bagua_tpu_torch.elastic import membership as mb
    from bagua_tpu_torch.obs.export import build_fleet_record

    payload = mb.merged_health_source([beacon_path])()
    return build_fleet_record(0, {0: None, node_id: payload})


def _relabel_beacon_rank(beacon_path, rank):
    """The leg ran in this process (rank 0); relabeling the beacon's rank
    is the only hand-made part of the fleet path."""
    with open(beacon_path) as f:
        rec = json.load(f)
    rec["obs"]["rank"] = rank
    if "straggler_suspect" in rec["obs"]:
        rec["obs"]["straggler_suspect"]["rank"] = rank
    with open(beacon_path, "w") as f:
        json.dump(rec, f)


def _actuate_autopilot_stop(action):
    """The monitor loop's fence/resize half on a live membership client:
    ``publish_autopilot_stop`` converts the action into the
    ``health_fenced`` stop event the epoch/resize machinery rides; returns
    (stop_event, survivor_set) for a 2-node world."""
    from bagua_tpu_torch.contrib.utils.store import InMemoryStore
    from bagua_tpu_torch.distributed.run import publish_autopilot_stop
    from bagua_tpu_torch.elastic import membership as mb

    client = mb.MembershipClient(InMemoryStore(), node_id=0, max_nnodes=2)
    nodes = [int(n) for n in action.target]
    publish_autopilot_stop(client, 0, action, nodes)
    stop = client.read_stop(0)
    survivors = {0, 1} - set(stop["nodes"]) if stop else {0, 1}
    return stop, survivors


def _span_key(sp):
    return (sp.get("name"), sp.get("t0"), sp.get("t1"), sp.get("thread"))


def _anomaly_leg(straggle_rank, ctx, tmp, ring_dump=None, family="async"):
    """One real trainer run for the straggler anomaly detector: clean
    baseline steps, then an armed ``step.straggle`` window naming
    ``straggle_rank``, on the async family (its ``async/negotiate``
    boundaries are where a slow peer gates it and the anchors the fleet
    timeline aligns on) or ``family="gradient_allreduce"`` (every step
    gated).  Returns the suspects flagged during the window and the health
    beacon's path; with ``ring_dump`` writes the leg's span-ring slice
    there for the fleet timeline."""
    from bagua_tpu_torch.algorithms import (
        AsyncModelAverageAlgorithm,
        GradientAllReduceAlgorithm,
    )
    from bagua_tpu_torch.elastic.membership import write_health_beacon
    from bagua_tpu_torch.env import get_rank
    from bagua_tpu_torch.faults.inject import FaultSpec, fault_scope
    from bagua_tpu_torch.obs import export as obs_export
    from bagua_tpu_torch.obs import spans as obs_spans

    obs_export.reset_local_summary()
    ring_before = {_span_key(sp) for sp in obs_spans.recorder.snapshot()}
    dropped_before = obs_spans.recorder.dropped
    with _env(**ANOMALY_ENV):
        algo = (AsyncModelAverageAlgorithm(warmup_steps=0, period_steps=4)
                if family == "async" else GradientAllReduceAlgorithm())
        t, s, b = _golden_trainer(algo, ctx)
    for _ in range(10):
        s, _ = t.train_step(s, b)
    straggle_start = t._step_counter
    with fault_scope(FaultSpec("step.straggle", rank=straggle_rank, count=-1, base_ms=10.0,
                               factor=10.0)):
        for _ in range(6):
            s, _ = t.train_step(s, b)
    # one clean step so the LAST straggled window is observed too (the
    # detector inspects each window when the next step opens)
    s, _ = t.train_step(s, b)
    if hasattr(algo, "barrier"):
        s = algo.barrier(t, s)
    suspects = [sp for sp in (t.anomaly_detector.suspects if t.anomaly_detector else [])
                if sp["step"] >= straggle_start]
    rank = get_rank()
    os.makedirs(tmp, exist_ok=True)
    beacon = os.path.join(tmp, f"straggler_beacon.r{rank}")
    write_health_beacon(beacon)
    if ring_dump is not None:
        leg_spans = [dict(sp, rank=rank) for sp in obs_spans.recorder.snapshot()
                     if _span_key(sp) not in ring_before]
        with open(ring_dump, "w") as f:
            json.dump({"rank": rank, "spans": leg_spans,
                       "spans_dropped": obs_spans.recorder.dropped - dropped_before}, f)
    return suspects, beacon


def drill_autopilot_straggler_fence(ctx):
    """Chronic dispatch-dominant straggler -> autopilot fence + resize: a
    REAL self-straggled trainer run flags dispatch-dominant suspects, the
    beacon rides the production merge into a fleet snapshot, the policy
    engine sustains the evidence over two snapshots and decides the fence,
    and the action actuates through the ``health_fenced`` stop event lease
    expiry rides — the world resizes down to the survivors."""
    from bagua_tpu_torch.elastic import membership as mb
    from bagua_tpu_torch.env import get_rank
    from bagua_tpu_torch.faults import inject

    before = _snapshot()
    # self-straggle: local slowness files under `dispatch`
    suspects, beacon = _anomaly_leg(get_rank(), ctx, ctx["tmp"])
    deltas = _counter_deltas(before)
    detected = (bool(suspects) and suspects[-1]["dominant_phase"] == "dispatch"
                and deltas.get("faults/step.straggle/fired", 0) >= 1)
    _relabel_beacon_rank(beacon, 1)

    engine = _autopilot_engine(sustain=2)
    actions = []
    for _ in range(2):
        time.sleep(0.02)  # distinct snapshot time_unix per poll
        actions = engine.observe_snapshot(_fleet_record_from_beacon(beacon))
    decided = (len(actions) == 1 and actions[0].kind == "fence"
               and actions[0].rule == "chronic_straggler" and actions[0].target == [1])
    stop, survivors = (None, None)
    if decided:
        stop, survivors = _actuate_autopilot_stop(actions[0])
        engine.note_actuated(actions[0])
        if detected:
            inject.record_recovery("step.straggle")
    actuated = bool(stop and stop["kind"] == mb.STOP_HEALTH and stop["nodes"] == [1]
                    and stop["rejoin"] is False)
    return {"injected": True,
            "detected": bool(detected and decided),
            "recovered": bool(actuated and survivors == {0}),
            "decided_actions": [a.kind for a in actions],
            "details": f"dispatch-dominant suspect (ratio "
                       f"{suspects[-1]['ratio'] if suspects else None}) sustained 2 snapshots "
                       f"-> fence node 1; stop {stop and stop['kind']} "
                       f"rejoin={stop and stop['rejoin']}; world resizes to "
                       f"{sorted(survivors or [])}"}


def _start_service(world_size, **kw):
    import threading

    from bagua_tpu_torch.service.autotune_service import AutotuneService, make_server

    service = AutotuneService(world_size=world_size, sampling_confidence_time_s=0.0,
                              warmup_time_s=0.0, **kw)
    server = make_server(0, service)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return service, server, server.server_address[1]


@contextlib.contextmanager
def _autotune_env(port):
    from bagua_tpu_torch.communication import get_hyperparameters_service_client

    with _env(BAGUA_SERVICE_PORT=port, MASTER_ADDR="127.0.0.1", BAGUA_AUTOTUNE="1"):
        get_hyperparameters_service_client.cache_clear()
        try:
            yield
        finally:
            get_hyperparameters_service_client.cache_clear()


def drill_autopilot_slo_ladder(ctx):
    """Sustained goodput-SLO breach -> the escalation ladder walked IN
    ORDER (hint -> retune -> family switch -> resize), the switch actuated
    END TO END: the engine pins the family through the autotune service's
    recommendation path, and a LIVE autotuned trainer applies it at its
    next check-in — a queued state migration, never a restart.  The
    terminal resize actuates through the stop event the fence rides."""
    from bagua_tpu_torch.algorithms import GradientAllReduceAlgorithm
    from bagua_tpu_torch.autopilot import LADDER, default_engine_actuators
    from bagua_tpu_torch.obs import ledger as obs_ledger
    from bagua_tpu_torch.obs.export import build_fleet_record

    model = "autopilot_ladder_drill"
    service, server, port = _start_service(1, autotune_level=1, max_samples=50)
    try:
        with _autotune_env(port):
            trainer, state, b = _golden_trainer(
                GradientAllReduceAlgorithm(), ctx, autotune=None,
                model_name=model, flat_resident="off")
            trainer.autotune_checkin_steps = CHECKIN_STEPS
            loss = None
            for _ in range(CHECKIN_STEPS):  # through the first check-in
                state, loss = trainer.train_step(state, b)

            # the injected degradation: a fleet whose worst rank sits far
            # below the goodput SLO, sustained
            engine = _autopilot_engine(
                sustain=1, slo_goodput=0.5, switch_family="async",
                actuators=default_engine_actuators(model_name=model,
                                                   autotune_addr=f"127.0.0.1:{port}"))
            fired = []
            for _ in range(len(LADDER)):
                time.sleep(0.02)
                record = build_fleet_record(0, {0: None, 1: {"obs": {
                    "1": {"rank": 1, "step": 100, "goodput_fraction": 0.12}}}})
                fired.extend(engine.observe_snapshot(record))
            ladder_order = [a.kind for a in fired]
            decided = ladder_order == list(LADDER)
            task = service._task(model)
            with task.lock:
                pinned = task.pinned_algorithm == "async"

            # the switch lands at the trainer's next check-in; the queued
            # migration converts the live state before the next step
            migrations_before = obs_ledger.ledger.report()["classes"].get("state_migration", 0.0)
            for _ in range(CHECKIN_STEPS + 1):
                state, loss = trainer.train_step(state, b)
            switched = type(trainer.algorithm).__name__ == "AsyncModelAverageAlgorithm"
            migrated = (obs_ledger.ledger.report()["classes"].get("state_migration", 0.0)
                        > migrations_before)
            if switched and hasattr(trainer.algorithm, "barrier"):
                state = trainer.algorithm.barrier(trainer, state)
            finite = bool(np.isfinite(float(loss)))

            stop, survivors = (None, None)
            resize = [a for a in fired if a.kind == "resize"]
            if resize:
                stop, survivors = _actuate_autopilot_stop(resize[0])
                engine.note_actuated(resize[0])
            actuated_resize = bool(stop and stop["rejoin"] is False and stop["nodes"] == [1])
    finally:
        server.shutdown()
    return {"injected": True,
            "detected": bool(decided and pinned),
            "recovered": bool(switched and migrated and finite and actuated_resize),
            "ladder_order": ladder_order,
            "details": f"ladder walked {ladder_order} (in order: {decided}); service pinned "
                       f"family async: {pinned}; trainer switched at its check-in: "
                       f"{switched} (state migrated: {migrated}, finite loss: {finite}); "
                       f"terminal resize stop published: {actuated_resize}"}


def drill_autopilot_off_noop(ctx):
    """BAGUA_AUTOPILOT=off (the default) changes NOTHING: the launcher's
    engine-construction gate stays closed, no ``autopilot/*`` counter
    moves, and the train step issues the same collectives and lands on
    bitwise the same parameters across off/observe/act — the autopilot is
    coordinator-side by construction and never reaches the step."""
    from bagua_tpu_torch import env as _env_mod
    from bagua_tpu_torch.algorithms import GradientAllReduceAlgorithm
    from bagua_tpu_torch.analysis.collective_check import (
        CollectiveRecorder,
        communicator_axes,
    )

    before = _snapshot()
    steps = {}
    with _env(BAGUA_AUTOPILOT=None):
        default_off = _env_mod.get_autopilot_mode() == "off"
        # run_elastic's gate, verbatim: mode off -> no engine exists
        engine_gate_closed = not (_env_mod.get_autopilot_mode() != "off")
        for mode in ("off", "observe", "act"):
            with _env(BAGUA_AUTOPILOT=mode):
                t, s, b = _golden_trainer(GradientAllReduceAlgorithm(), ctx)
                with CollectiveRecorder(communicator_axes(t)) as rec:
                    for _ in range(3):
                        s, _ = t.train_step(s, b)
                steps[mode] = ([c.render() for c in rec.log], _params(t, s))
    deltas = _counter_deltas(before)
    no_autopilot_counters = not any(k.startswith("autopilot/") for k in deltas)
    logs_equal = steps["off"][0] == steps["observe"][0] == steps["act"][0]
    params_equal = all(torch.equal(steps["off"][1][k], steps[m][1][k])
                       for m in ("observe", "act") for k in steps["off"][1])
    pinned = logs_equal and params_equal
    return {"injected": True,  # the mode flip itself is the intervention
            "detected": bool(pinned),
            "recovered": bool(default_off and engine_gate_closed and no_autopilot_counters),
            "step_identical": bool(pinned),
            "details": f"default mode off: {default_off}; engine gate closed: "
                       f"{engine_gate_closed}; the step's collectives "
                       f"({len(steps['off'][0])} calls) and parameters identical across "
                       f"off/observe/act: {pinned}; no autopilot counters moved: "
                       f"{no_autopilot_counters}"}


def drill_autopilot_ckpt_quarantine(ctx):
    """Torn checkpoints xN -> storage quarantine: repeated armed
    ``ckpt.write`` corruption drives the REAL integrity counters up, the
    per-rank obs summary carries them (with the manager's storage path)
    through the production beacon merge, the engine decides
    ``quarantine_storage``, the actuator quarantines the path in the
    checkpoint registry — and the SAME live manager's next save redirects,
    after which restore lands on a verified step again."""
    from bagua_tpu_torch import checkpoint as ck
    from bagua_tpu_torch.autopilot import default_engine_actuators
    from bagua_tpu_torch.elastic import membership as mb
    from bagua_tpu_torch.faults import inject
    from bagua_tpu_torch.faults.inject import FaultSpec, fault_scope
    from bagua_tpu_torch.obs import export as obs_export
    from bagua_tpu_torch.obs.export import build_fleet_record

    device, tmp = ctx["device"], ctx["tmp"]
    ck.clear_quarantine()
    obs_export.reset_local_summary()
    d = os.path.join(tmp, "autopilot_ckpt")
    mgr = ck.BaguaCheckpointManager(d, async_save=False, max_to_keep=8)
    mgr.save(1, _ckpt_state(1.0, device))
    before = _snapshot()
    actions, recovered = [], False
    with fault_scope(FaultSpec("ckpt.write", count=3)):
        for i, v in ((2, 2.0), (3, 3.0), (4, 4.0)):
            mgr.save(i, _ckpt_state(v, device))
        step, restored = mgr.try_restore(_ckpt_state(0.0, device))
        deltas = _counter_deltas(before)
        detected = (step == 1 and deltas.get("ckpt/integrity_failures", 0) >= 3
                    and deltas.get("ckpt/fallback_restores", 0) >= 1)

        # the evidence reaches the fleet snapshot through the production
        # path: obs summary -> beacon -> merged heartbeat payload ->
        # coordinator merge
        obs_export.note_step(4, 0.01)
        beacon = os.path.join(tmp, "quarantine_beacon.r1")
        mb.write_health_beacon(beacon)
        record = build_fleet_record(0, {0: None, 1: mb.merged_health_source([beacon])()})

        engine = _autopilot_engine(sustain=1, ckpt_failures=3,
                                   actuators=default_engine_actuators(autotune_addr=None))
        actions = engine.observe_snapshot(record)
        decided = (len(actions) == 1 and actions[0].kind == "quarantine_storage"
                   and str(actions[0].target) == ck._normalize_storage_path(d))
        actuated = decided and ck.is_quarantined(d)

        # recovery: the live manager's next save redirects off the rotten
        # storage, and restore verifies again (no more fallback walking)
        if actuated:
            mgr.save(5, _ckpt_state(5.0, device))
            redirected = mgr.directory == ck.redirect_directory(d)
            before2 = _snapshot()
            step2, restored2 = mgr.try_restore(_ckpt_state(0.0, device))
            deltas2 = _counter_deltas(before2)
            recovered = (redirected and step2 == 5
                         and torch.equal(restored2["w"].cpu(), _ckpt_state(5.0, "cpu")["w"])
                         and deltas2.get("ckpt/integrity_failures", 0) == 0
                         and deltas2.get("ckpt/verified_restores", 0) >= 1)
            if detected and recovered:
                inject.record_recovery("ckpt.write")
    mgr.close()
    ck.clear_quarantine()
    return {"injected": True,
            "detected": bool(detected and decided),
            "recovered": bool(actuated and recovered),
            "decided_actions": [a.kind for a in actions],
            "details": f"3 torn saves -> restore fell back to step {step} with "
                       f"{deltas.get('ckpt/integrity_failures', 0)} integrity failures; "
                       f"engine quarantined {d}; next save redirected and restore verified "
                       f"step 5: {recovered}"}


def drill_autopilot_trend_rules(ctx):
    """Historian trend windows close the loop over DCN and HBM signals: a
    synthetic degradation stream — node 1's HBM headroom shrinking toward
    exhaustion, node 2's steps DCN-dominated, node 3 a flat control — flows
    through the LIVE historian (restart-store-persisted) into the act-mode
    engine.  The pre-OOM resize decides from the projected-exhaustion
    window and actuates through the production stop publisher; the
    compression hint is delivered to a live autotune service as the
    controller rank and re-grants the re-measure; the control never fires;
    and a relaunched historian resumes its rings from the store."""
    from bagua_tpu_torch.autopilot import default_engine_actuators
    from bagua_tpu_torch.contrib.utils.store import InMemoryStore
    from bagua_tpu_torch.elastic import membership as mb
    from bagua_tpu_torch.obs.export import build_fleet_record
    from bagua_tpu_torch.obs.historian import Historian

    service, server, port = _start_service(1, autotune_level=1, max_samples=10)
    model = "autopilot_trend_drill"
    store = InMemoryStore()
    historian = Historian(capacity=64, window_s=600.0, store=store, persist_every=1)
    engine = _autopilot_engine(
        sustain=2, cooldown_s=300.0,
        actuators=default_engine_actuators(model_name=model,
                                           autotune_addr=f"127.0.0.1:{port}"))

    def rank_obs(rank, step, headroom, dcn):
        return {"rank": rank, "step": step, "goodput_fraction": 0.9,
                "step_dt_p50": 0.1, "hbm_headroom_bytes": headroom,
                "device_comm_dcn_s_per_step": dcn,
                "device_comm_ici_s_per_step": 0.01}

    def fleet_record(i):
        record = build_fleet_record(0, {0: None})
        record["ranks"] = {
            # node 1: headroom collapsing — polls ~20 ms apart, so the
            # fitted slope is steep and exhaustion projects well inside
            # the 600 s horizon
            "1": {"health": {}, "obs": {"1": rank_obs(1, 100 + i, 4.0e9 - i * 3.0e8, 0.005)}},
            # node 2: 70% of the step wall is DCN device seconds
            "2": {"health": {}, "obs": {"2": rank_obs(2, 100 + i, 8.0e9, 0.07)}},
            # node 3: flat control — must never fire a rule
            "3": {"health": {}, "obs": {"3": rank_obs(3, 100 + i, 8.0e9, 0.005)}},
        }
        record["nnodes"] = 3
        return record

    all_actions = []
    try:
        task = service._task(model)
        task.sample_retried = True  # a spent re-measure the hint re-grants
        for i in range(8):
            time.sleep(0.02)  # distinct snapshot time_unix per poll
            record = historian.ingest(fleet_record(i))
            all_actions.extend(engine.observe_snapshot(record))
        kinds = [a.kind for a in all_actions]
        resize = [a for a in all_actions if a.kind == "resize"]
        compress = [a for a in all_actions if a.kind == "compress_dcn"]
        trends = record["ranks"]["1"]["obs"]["1"].get("trends") or {}
        detected = (trends.get("hbm_headroom_slope", 0) < 0
                    and trends.get("hbm_headroom_eta_s") is not None
                    and record["ranks"]["2"]["obs"]["2"]["trends"]["dcn_comm_share"] >= 0.5)
        decided = (kinds == ["resize", "compress_dcn"]
                   and resize[0].rule == "hbm_exhaustion" and resize[0].target == [1]
                   and compress[0].rule == "dcn_dominance"
                   and compress[0].target == "bytegrad"
                   and not any("3" == str(n) for a in all_actions
                               for n in (a.target if isinstance(a.target, list) else [])))
        stop, survivors = (None, None)
        delivered = regranted = False
        if decided:
            stop, survivors = _actuate_autopilot_stop(resize[0])
            engine.note_actuated(resize[0])
            with task.lock:
                delivered = any(h.get("kind") == "autopilot_compress_dcn"
                                and h.get("family") == "bytegrad"
                                and h.get("reported_by") == -1 for h in task.perf_hints)
            regranted = task.sample_retried is False
        actuated = bool(stop and stop["kind"] == mb.STOP_HEALTH and stop["nodes"] == [1]
                        and stop["rejoin"] is False)
        # a relaunched coordinator's historian resumes the trend windows
        resumed = Historian(capacity=64, window_s=600.0, store=store)
        slope = resumed.slope("1", "hbm_headroom_bytes")
        persisted = slope is not None and slope < 0
    finally:
        server.shutdown()
    recovered = bool(actuated and survivors == {0} and delivered and regranted and persisted)
    return {"injected": True,
            "detected": bool(detected and decided),
            "recovered": recovered,
            "decided_actions": kinds,
            "details": f"historian trends (headroom slope {trends.get('hbm_headroom_slope')} "
                       f"B/s, eta {trends.get('hbm_headroom_eta_s')}s) -> pre-OOM resize of "
                       f"node 1 (world -> {sorted(survivors or [])}); DCN share 0.7 -> "
                       f"bytegrad compression hint delivered={delivered} re-measure "
                       f"re-granted={regranted}; historian resumed from store={persisted}"}


IN_PROCESS_DRILLS = {
    "store_flake_retry": drill_store_flake,
    "heartbeat_loss_lease_expiry": drill_heartbeat_loss,
    "checkpoint_corruption_fallback_restore": drill_checkpoint_corruption,
    "nan_grad_skip_loss_continuity": drill_nan_grad_skip,
    "collective_hang_watchdog_recovery": drill_collective_hang,
    "health_fence_flight_record": drill_health_fence,
    "autopilot_straggler_fence_resize": drill_autopilot_straggler_fence,
    "autopilot_slo_escalation_ladder": drill_autopilot_slo_ladder,
    "autopilot_ckpt_quarantine": drill_autopilot_ckpt_quarantine,
    "autopilot_trend_rules": drill_autopilot_trend_rules,
    "autopilot_off_noop": drill_autopilot_off_noop,
}


# ---- drills run in ranks -------------------------------------------------------


def _gather(obj):
    """``obj`` of every rank (the default process group)."""
    out = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(out, obj)
    return out


def _barrier():
    _gather(None)


def drill_guard_on_goldens(ctx):
    """No faults + the grad guard's ``skip`` must reproduce the exact final
    losses of every deterministic family (flat and leaf layouts alike): the
    guard passes healthy state through bitwise.  ``async`` is excluded:
    its final loss depends on the host's timing even without the guard."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.parallel.mesh import hierarchical_mesh

    device = ctx["device"]
    sgd = _sgd()
    momentum = _sgd(momentum=0.9)
    families = {
        "gradient_allreduce": lambda: bt.GradientAllReduceAlgorithm(hierarchical=False),
        "bytegrad": lambda: bt.ByteGradAlgorithm(hierarchical=False),
        "qadam": lambda: bt.QAdamAlgorithm(warmup_steps=2, hierarchical=False),
        "decentralized": lambda: bt.DecentralizedAlgorithm(hierarchical=False,
                                                           peer_selection_mode="all"),
        "low_precision_decentralized": lambda: bt.LowPrecisionDecentralizedAlgorithm(
            hierarchical=False),
        "zero": lambda: bt.ZeroOptimizerAlgorithm(momentum),
        "zero_hierarchical": lambda: bt.ZeroOptimizerAlgorithm(momentum, hierarchical=True),
    }

    def goldens(guard, n_steps=30):
        out = {}
        with _env(BAGUA_GRAD_GUARD=guard):
            for family, factory in families.items():
                algo = factory()
                loss_fn, model, batch = golden_task(device, ctx.get("golden"))
                kw = {"mesh": hierarchical_mesh()} if family == "zero_hierarchical" else {}
                trainer = bt.BaguaTrainer(
                    loss_fn, None if family in ("qadam", "zero", "zero_hierarchical") else sgd,
                    algo, device=device, autotune=False, **kw)
                state = trainer.init(model)
                b = trainer.shard_batch(batch, global_batch=True)
                loss = None
                for _ in range(n_steps):
                    state, loss = trainer.train_step(state, b)
                out[family] = float(loss)
        return out

    off, on = goldens("off"), goldens("skip")
    diffs = {k: (off[k], on[k]) for k in off if off[k] != on[k]}
    ranks_ok = all(_gather(not diffs))
    return {"injected": True,  # the guard itself is the intervention
            "detected": True,
            "recovered": bool(ranks_ok),
            "goldens": off,
            "details": (f"guard-on final losses bitwise equal for {len(off)} deterministic "
                        f"families on every rank: {sorted(off)}" if ranks_ok
                        else f"final losses diverged under the guard: {diffs}")}


def drill_straggler_throughput(ctx):
    """A 10x straggler gates every synchronous step: throughput degrades
    by roughly the dilation yet every step completes — while the async
    family under the SAME armed fault pays only at its negotiated
    boundaries.  The straggler is a peer outside the drill's ranks (rank
    ``world``): every rank is gated by it, so the ranks stay in step.  The
    anomaly detector must additionally flag the slow window on BOTH sides
    of the fault — collective-dominant on a gated rank, dispatch-dominant
    on the straggler itself — the fleet snapshot merged from the ranks'
    beacons must name the straggling rank, and the ranks' span rings must
    assemble into one clock-aligned timeline."""
    from bagua_tpu_torch.algorithms import (
        AsyncModelAverageAlgorithm,
        GradientAllReduceAlgorithm,
    )
    from bagua_tpu_torch.elastic import membership as mb
    from bagua_tpu_torch.faults import inject
    from bagua_tpu_torch.faults.inject import FaultSpec, fault_scope
    from bagua_tpu_torch.obs import export as obs_export
    from bagua_tpu_torch.obs import timeline as obs_timeline
    from bagua_tpu_torch.obs.anomaly import fleet_straggler_suspects

    import shutil

    tmp, rank, world = ctx["tmp"], ctx["rank"], ctx["world"]
    base_ms, factor, steps = 10.0, 10.0, 12

    def timed_run(algo):
        t, s, b = _golden_trainer(algo, ctx)
        s, loss = t.train_step(s, b)  # the first step outside the timer
        float(loss)
        t0 = time.time()
        n_finite = 0
        for _ in range(steps):
            s, loss = t.train_step(s, b)
            n_finite += bool(np.isfinite(float(loss)))
        dt = time.time() - t0
        if hasattr(algo, "barrier"):
            s = algo.barrier(t, s)
        return dt, n_finite

    before = _snapshot()
    clean_dt, _ = timed_run(GradientAllReduceAlgorithm())
    with fault_scope(FaultSpec("step.straggle", rank=world, count=-1, base_ms=base_ms,
                               factor=factor)):
        sync_dt, sync_ok = timed_run(GradientAllReduceAlgorithm())
        async_dt, async_ok = timed_run(AsyncModelAverageAlgorithm(warmup_steps=0,
                                                                  period_steps=4))
        deltas = _counter_deltas(before)
        stall = (factor - 1.0) * base_ms / 1000.0
        detected = (deltas.get("faults/step.straggle/fired", 0) >= steps
                    and sync_dt >= clean_dt + steps * stall * 0.9)
        # alive-under-degradation IS the recovery: every step completed
        # with a finite loss, and the async family dodged the per-step
        # gating (recorded inside the scope: a disarmed plan records none)
        recovered = sync_ok == steps and async_ok == steps and async_dt < sync_dt
        if detected and recovered:
            inject.record_recovery("step.straggle")

    # the anomaly legs, as the JAX drill's two: (A) every rank gated by the
    # straggler outside the group, each step (gradient allreduce) —
    # collective-dominant windows; (B) every rank its own plan's straggler,
    # on the async family — dispatch-dominant windows, the ranks in step,
    # and their span rings for the timeline.  Rank 0 reports as the victim
    # (its leg-A beacon), rank 1 as the straggler (its leg-B beacon).  (At
    # two ranks the async family's round drain after a boundary waits on a
    # slower peer outside any phase, and a real straggler among the ranks
    # shows on the others inside their step's loss average, which the
    # detector files under dispatch.)
    ring = os.path.join(ctx["dump_dir"], f"spans_rank{rank}.json")
    victim, victim_beacon = _anomaly_leg(world, ctx, os.path.join(tmp, "victim"),
                                         family="gradient_allreduce")
    straggler, straggler_beacon = _anomaly_leg(rank, ctx, os.path.join(tmp, "straggler"),
                                               ring_dump=ring)
    phase_of = (lambda sus: sus[-1]["dominant_phase"] if sus else None)
    phases = _gather((phase_of(victim), phase_of(straggler)))
    victim_ok = all(v == "collective" for v, _ in phases)
    self_ok = all(s_ == "dispatch" for _, s_ in phases)
    reported = os.path.join(tmp, f"straggler_beacon.r{rank}")
    shutil.copyfile(victim_beacon if rank == 0 else straggler_beacon, reported)
    _barrier()

    fleet_ok, fleet_suspects = False, {}
    timeline_verdict = {"assembled": False}
    if rank == 0:
        payload = mb.merged_health_source(
            [os.path.join(tmp, f"straggler_beacon.r{r}") for r in range(world)])()
        fleet_path = os.path.join(tmp, "straggler_fleet.json")
        obs_export.write_fleet_snapshot(fleet_path, 0, {0: payload})
        with open(fleet_path) as f:
            fleet = json.load(f)
        fleet_suspects = fleet_straggler_suspects(fleet)
        fleet_ok = (not obs_export.validate_fleet_snapshot(fleet)
                    and [s["rank"] for s in fleet_suspects["stragglers"]] == [1]
                    and 0 in [s["rank"] for s in fleet_suspects["victims"]])
        # the fleet timeline over the ranks' ring slices: clock-aligned on
        # the shared async/negotiate boundary spans
        try:
            recs = obs_timeline.load_rank_records(
                [os.path.join(ctx["dump_dir"], f"spans_rank{r}.json") for r in range(world)])
            trace = obs_timeline.assemble_timeline(recs)
            problems = obs_timeline.validate_timeline(trace)
            with open(os.path.join(tmp, "straggler_timeline.json"), "w") as f:
                json.dump(trace, f)
            meta = trace["metadata"]
            timeline_verdict = {
                "assembled": True, "schema_valid": not problems, "problems": problems[:5],
                "ranks": sorted(meta["ranks"]), "aligned": meta["aligned"],
                "anchor_spans_rank1": meta["ranks"].get("1", {}).get("anchor_spans", 0),
                "events": len(trace["traceEvents"]),
            }
        except Exception as e:  # noqa: BLE001 - verdict, not crash
            timeline_verdict["error"] = f"{type(e).__name__}: {e}"
    timeline_ok = (timeline_verdict.get("schema_valid") is True
                   and timeline_verdict.get("aligned") is True
                   and timeline_verdict.get("ranks") == ["0", "1"]
                   and timeline_verdict.get("anchor_spans_rank1", 0) >= 2)
    legs = _gather((detected, recovered))
    ranks_detected = all(d for d, _ in legs)
    ranks_recovered = all(r for _, r in legs)
    fleet_ok, timeline_ok, fleet_names, timeline_verdict = _gather(
        (fleet_ok, timeline_ok, [s["rank"] for s in fleet_suspects.get("stragglers", [])],
         timeline_verdict))[0]
    return {"injected": True,
            "detected": bool(ranks_detected and victim_ok and self_ok),
            "recovered": bool(ranks_recovered and fleet_ok and timeline_ok),
            "timeline": timeline_verdict,
            "anomaly": {"victim_flagged": victim_ok,
                        "victim_dominant_phase": [v for v, _ in phases],
                        "straggler_flagged": self_ok,
                        "straggler_dominant_phase": [s_ for _, s_ in phases],
                        "fleet_names_straggler_rank": fleet_names, "fleet_ok": fleet_ok},
            "details": f"{steps} steps on rank {rank}: clean {clean_dt:.2f}s, sync+straggle "
                       f"{sync_dt:.2f}s (all finite: {sync_ok == steps}), async+straggle "
                       f"{async_dt:.2f}s — async retained {sync_dt / async_dt:.1f}x sync "
                       f"throughput; anomaly detector flagged every rank gated "
                       f"(collective)={victim_ok} and straggling (dispatch)={self_ok}, fleet "
                       f"named rank 1: {fleet_ok}"}


def drill_async_partition_catchup(ctx):
    """Persistent ``async.partition`` drops: the applied-round counter
    stalls, the negotiated gather sees the lag hit ``max_staleness_rounds``
    and forces a synchronous catch-up average — the ranks' parameters
    bitwise equal at every sync point, training continues, telemetry
    records the round trip."""
    import hashlib

    from bagua_tpu_torch.algorithms import AsyncModelAverageAlgorithm
    from bagua_tpu_torch.faults.inject import FaultSpec, fault_scope

    cap = 2
    algo = AsyncModelAverageAlgorithm(warmup_steps=2, period_steps=2,
                                      max_staleness_rounds=cap)
    t, s, b = _golden_trainer(algo, ctx)

    digests = []
    orig = algo._catchup_sync

    def spy(trainer, step, reason):
        out = orig(trainer, step, reason)
        h = hashlib.sha256()
        for name in sorted(trainer._params):
            h.update(trainer._params[name].detach().cpu().numpy().tobytes())
        digests.append(h.hexdigest())
        return out

    algo._catchup_sync = spy
    before = _snapshot()
    lags = []
    with fault_scope(FaultSpec("async.partition", count=-1)):
        loss = None
        for _ in range(20):
            s, loss = t.train_step(s, b)
            lags.append(algo._rounds_launched - algo._rounds_applied)
    s = algo.barrier(t, s)
    deltas = _counter_deltas(before)
    all_digests = _gather(digests)
    synced = bool(digests) and all(d == digests for d in all_digests)
    detected = (deltas.get("faults/async.partition/fired", 0) >= 1
                and deltas.get("async/missed_boundaries", 0) >= 1
                and deltas.get("async/catchup_syncs", 0) >= 1)
    recovered = (deltas.get("faults/async.partition/recovered", 0) >= 1
                 and max(lags) <= cap
                 and synced
                 and np.isfinite(float(loss))
                 and deltas.get("async/rounds_launched", 0)
                 >= deltas.get("async/catchup_syncs", 0))
    verdicts = _gather((bool(detected), bool(recovered)))
    return {"injected": True, "detected": all(d for d, _ in verdicts),
            "recovered": all(r for _, r in verdicts),
            "details": f"{deltas.get('async/rounds_dropped', 0)} rounds dropped, "
                       f"{deltas.get('async/catchup_syncs', 0)} catch-up sync(s), max lag "
                       f"{max(lags)} <= cap {cap}, parameters bitwise equal on the "
                       f"{len(all_digests)} ranks at every sync point: {synced}"}


def drill_autopilot_victim_retune(ctx):
    """Collective-dominant victim -> retune hint CONSUMED: a straggler
    outside the group gates the ranks, rank 0 flags a collective-dominant
    suspect,
    the engine decides a retune hint and delivers it through the autotune
    client as the controller rank, and the live autotune service provably
    consumes it — the hinted sampling window is RE-MEASURED instead of
    scored."""
    from bagua_tpu_torch.autopilot import default_engine_actuators
    from bagua_tpu_torch.faults import inject

    before = _snapshot()
    # every rank gated by the straggler outside the group, every step
    suspects, beacon = _anomaly_leg(ctx["world"], ctx, ctx["tmp"],
                                    family="gradient_allreduce")
    deltas = _counter_deltas(before)
    verdict = None
    if ctx["rank"] == 0:
        detected = (bool(suspects) and suspects[-1]["dominant_phase"] == "collective"
                    and deltas.get("faults/step.straggle/fired", 0) >= 1)
        service, server, port = _start_service(1, autotune_level=1, max_samples=10)
        try:
            model = "autopilot_victim_drill"
            # open a sampling window: one scored sample, window restarts
            service.report_metrics({"model_name": model, "rank": 0, "train_iter": 1,
                                    "hyperparameters": {}, "speed": 100.0})
            service.ask_hyperparameters({"model_name": model, "rank": 0, "train_iter": 1})
            task = service._task(model)
            samples_before = task.n_samples
            engine = _autopilot_engine(
                sustain=2, actuators=default_engine_actuators(
                    model_name=model, autotune_addr=f"127.0.0.1:{port}"))
            actions = []
            for _ in range(2):
                time.sleep(0.02)
                actions = engine.observe_snapshot(_fleet_record_from_beacon(beacon))
            decided = (len(actions) == 1 and actions[0].kind == "retune_hint"
                       and actions[0].rule == "collective_victim")
            with task.lock:
                delivered = task.perf_hints_total >= 1 and any(
                    h.get("kind") == "autopilot_retune_hint" and h.get("reported_by") == -1
                    for h in task.perf_hints)
            # the service CONSUMES the hint: the next confidence-gated
            # decision re-measures the window instead of scoring it
            service.report_metrics({"model_name": model, "rank": 0, "train_iter": 2,
                                    "hyperparameters": {}, "speed": 100.0})
            service.ask_hyperparameters({"model_name": model, "rank": 0, "train_iter": 2})
            consumed = task.n_samples == samples_before and task.sample_retried is True
            if detected and decided and consumed:
                inject.record_recovery("step.straggle")
        finally:
            server.shutdown()
        verdict = {"injected": True, "detected": bool(detected and decided),
                   "recovered": bool(delivered and consumed),
                   "decided_actions": [a.kind for a in actions],
                   "suspects": [(sp["step"], sp["dominant_phase"], sp["ratio"])
                                for sp in suspects],
                   "details": f"rank 0's collective-dominant suspect sustained 2 snapshots "
                              f"-> retune hint; delivered as controller rank -1: "
                              f"{delivered}; service re-measured the hinted window "
                              f"(n_samples {samples_before} unchanged, retry armed): "
                              f"{consumed}"}
    return _gather(verdict)[0]


def drill_autopilot_compress_codec(ctx):
    """The ``compress_dcn`` trend hint ACTUATES a real wire-byte reduction:
    delivered to a live autotune service as the controller rank, the hint
    sets the recommended ``compress_inter`` codec; LIVE autotuned trainers
    on the ``{inter: 2, intra: 2}`` mesh apply it at their next check-in —
    the inter-node tier then rides the COMPRESSED ring (u8 payloads, f32
    accumulation) — and the step's inter-node wire bytes, read from the
    recorded collective log, drop >= 3x while training stays finite."""
    from bagua_tpu_torch.algorithms import GradientAllReduceAlgorithm
    from bagua_tpu_torch.analysis.collective_check import (
        CollectiveRecorder,
        communicator_axes,
    )
    from bagua_tpu_torch.autopilot import default_engine_actuators
    from bagua_tpu_torch.autopilot.policy import Action
    from bagua_tpu_torch.parallel.mesh import hierarchical_mesh

    rank, world = ctx["rank"], ctx["world"]
    model = "autopilot_compress_drill"

    def dcn_wire_bytes(trainer, state, batch):
        with CollectiveRecorder(communicator_axes(trainer)) as rec:
            state, loss = trainer.train_step(state, batch)
        return state, loss, sum(c.nbytes for c in rec.log if "inter" in c.axes)

    # autotune_level=0: the recommendation is served verbatim (no sampling
    # that could flip is_hierarchical_reduce between the two measurements)
    # — controller hints still actuate whatever the level
    service = server = None
    if rank == 0:
        service, server, port = _start_service(world, autotune_level=0, max_samples=50)
    else:
        port = None
    port = _gather(port)[0]
    delivered = service_actuated = regranted = None
    try:
        # the legacy knob space: its service actuates the hint's codec
        # directly (a live v2 search takes it as a prior to sample, which a
        # level-0 service never does)
        with _autotune_env(port), _env(BAGUA_AUTOTUNE_SPACE="legacy"):
            trainer, state, b = _golden_trainer(
                GradientAllReduceAlgorithm(hierarchical=True), ctx,
                autotune=None, mesh=hierarchical_mesh(), model_name=model,
                flat_resident="off")
            trainer.autotune_checkin_steps = CHECKIN_STEPS
            # step 1: registration applied the service's default
            # recommendation; pin the hierarchical path so the next
            # check-in restores the two-level form this drill compresses
            state, loss = trainer.train_step(state, b)
            if rank == 0:
                task = service._task(model)
                with task.lock:
                    task.recommended.is_hierarchical_reduce = True
            _barrier()
            for _ in range(CHECKIN_STEPS):  # past the next check-in
                state, loss = trainer.train_step(state, b)
            hierarchical = bool(trainer.algorithm.hierarchical)
            codec_before = trainer.compress_inter
            state, loss, dcn_before = dcn_wire_bytes(trainer, state, b)
            _barrier()
            if rank == 0:
                # the hint, delivered exactly as the engine's actuator
                # delivers a decided compress_dcn action (controller rank -1)
                actuators = default_engine_actuators(model_name=model,
                                                     autotune_addr=f"127.0.0.1:{port}")
                with task.lock:
                    task.sample_retried = True  # a spent re-measure to re-grant
                delivered = bool(actuators["compress_dcn"](Action(
                    kind="compress_dcn", rule="dcn_dominance", target="bytegrad",
                    reason="drill: sustained DCN dominance",
                    evidence={"codec": "minmax_uint8"})))
                with task.lock:
                    service_actuated = task.recommended.compress_inter == "minmax_uint8"
                    regranted = task.sample_retried is False
            _barrier()
            # the codec lands at the trainers' next check-in
            for _ in range(CHECKIN_STEPS):
                state, loss = trainer.train_step(state, b)
            flipped = trainer.compress_inter == "minmax_uint8"
            state, loss, dcn_after = dcn_wire_bytes(trainer, state, b)
            finite = bool(np.isfinite(float(loss)))
    finally:
        if server is not None:
            server.shutdown()
    ratio = dcn_before / max(dcn_after, 1)
    ranks = _gather((hierarchical, flipped, ratio, finite))
    ranks_ok = all(h and f and r >= 3.0 and fin for h, f, r, fin in ranks)
    delivered, service_actuated, regranted = _gather(
        (delivered, service_actuated, regranted))[0]
    return {"injected": True,
            "detected": bool(delivered and service_actuated and regranted),
            "recovered": bool(ranks_ok),
            "dcn_wire_bytes_before": int(dcn_before),
            "dcn_wire_bytes_after": int(dcn_after),
            "dcn_reduction_ratio": round(ratio, 2),
            "details": f"hint delivered={delivered}, service set compress_inter=minmax_uint8: "
                       f"{service_actuated} (re-measure re-granted={regranted}); live "
                       f"trainers' codec {codec_before!r} -> {trainer.compress_inter!r} at "
                       f"their check-in; recorded inter-node wire bytes a step "
                       f"{dcn_before} -> {dcn_after} ({ratio:.2f}x, gate >= 3x) on rank "
                       f"{rank}; every rank hierarchical, flipped, >= 3x and finite: "
                       f"{ranks_ok}"}


RANK_DRILLS = {
    "grad_guard_on_goldens_unchanged": drill_guard_on_goldens,
    "straggler_throughput_degrades": drill_straggler_throughput,
    "async_partition_staleness_catchup": drill_async_partition_catchup,
    "autopilot_victim_retune_hint": drill_autopilot_victim_retune,
    "autopilot_compress_actuates_codec": drill_autopilot_compress_codec,
}


# ---- running the matrix ---------------------------------------------------------


def _run_drills(names, fns, ctx, on_rank0=True):
    """Run each drill with its flight-record and ledger checks; the fault
    plan and the abort flag are cleared after each."""
    import bagua_tpu_torch as bt
    from bagua_tpu_torch.faults import inject
    from bagua_tpu_torch.obs import ledger as obs_ledger

    # the ledger observes every drill's defense path (installed explicitly
    # so span-only drills — the checkpoint walk — feed it too)
    obs_ledger.install()
    results, seconds = {}, {}
    for name in names:
        if on_rank0:
            log(f"=== {name} ===")
        if ctx.get("world", 1) > 1:
            _barrier()   # the ranks start each drill together
        ledger_before = obs_ledger.ledger.report()
        t0 = time.perf_counter()
        try:
            results[name] = fns[name](ctx)
        except Exception as e:  # noqa: BLE001 - drill verdicts, not crashes
            import traceback

            traceback.print_exc()
            results[name] = {"injected": True, "detected": False, "recovered": False,
                             "details": f"drill crashed: {type(e).__name__}: {e}"}
        if ctx.get("world", 1) > 1:
            _barrier()   # every rank's dumps are written before the scan
        expect = FLIGHT_EXPECTATIONS.get(name)
        if expect is not None:
            results[name]["flight_record"] = _flight_record_check(expect, ctx["dump_dir"])
        ledger_cls = obs_ledger.DRILL_BADPUT_EXPECTATIONS.get(name)
        if ledger_cls is not None:
            results[name]["ledger"] = _ledger_class_check(ledger_cls, ledger_before,
                                                          obs_ledger.ledger.report())
        seconds[name] = round(time.perf_counter() - t0, 3)
        results[name]["seconds"] = seconds[name]
        results[name]["world"] = ctx.get("world", 1)
        if on_rank0:
            log(f"    {results[name]}")
        inject.clear_plan()
        bt.reset_abort()
    return results


def run_in_process(names=IN_PROCESS, device="cuda", dump_dir=None, tmp=None, golden=None):
    """The drills of :data:`IN_PROCESS` (or the subset ``names``) in this
    process, on ``device``, at world 1 (the process group is made when
    there is none), the golden task from the npz ``golden`` or the seed.
    Flight dumps go to ``dump_dir`` (a fresh directory when None).
    Returns ``{drill: verdict}``."""
    from bagua_tpu_torch import communication

    communication.init_process_group(device=device)
    dump_dir = dump_dir or tempfile.mkdtemp(prefix="chaos_obs_")
    os.makedirs(dump_dir, exist_ok=True)
    tmp = tmp or tempfile.mkdtemp(prefix="chaos_drill_")
    ctx = {"device": torch.device(device), "tmp": tmp, "dump_dir": dump_dir, "rank": 0,
           "world": 1, "golden": golden}
    with _env(BAGUA_COMM_TIMEOUT_S="off", BAGUA_OBS_DUMP_DIR=dump_dir):
        return _run_drills([n for n in IN_PROCESS if n in names], IN_PROCESS_DRILLS, ctx)


def run_rank_drills(names, rank, world, device, workdir, golden=None):
    """The rank-level drills of ``names`` that fit this world (two ranks:
    :data:`RANKS_2`; four on the 2 x 2 mesh: :data:`RANKS_4`), on this
    rank's process group (made by the caller).  ``workdir`` is a directory
    every rank of the group names alike (rank 0 makes it fresh); the flight
    dumps go under it.  Returns ``{drill: verdict}``, the same on every
    rank."""
    import shutil

    own = RANKS_2 if world == 2 else RANKS_4
    dump_dir = os.path.join(workdir, "dumps")
    tmp = os.path.join(workdir, "tmp")
    if rank == 0:
        shutil.rmtree(workdir, ignore_errors=True)
        os.makedirs(dump_dir)
        os.makedirs(tmp)
    _barrier()
    ctx = {"device": torch.device(device), "tmp": tmp, "dump_dir": dump_dir, "rank": rank,
           "world": world, "golden": golden}
    with _env(BAGUA_COMM_TIMEOUT_S="off", BAGUA_OBS_DUMP_DIR=dump_dir):
        return _run_drills([n for n in own if n in names], RANK_DRILLS, ctx,
                           on_rank0=rank == 0)


def _rank_worker(args):
    """One rank of a spawned group (this script with ``--rank-group``)."""
    import bagua_tpu_torch as bt

    world, intra = GROUPS[args.rank_group]
    device = torch.device(args.device)
    torch.set_num_threads(1)
    bt.init_process_group(args.init, world_size=world, rank=args.rank, device=device,
                          backend="gloo", intra_size=intra)
    results = run_rank_drills(args.only or DRILL_NAMES, args.rank, world, device,
                              args.workdir, golden=args.golden_npz)
    if args.rank == 0:
        with open(args.result, "w") as f:
            json.dump(results, f)
    torch.distributed.destroy_process_group()


def _spawn_group(group, names, device, workdir, golden_npz=None):
    """Start the ranks of ``group`` as processes of this script; returns
    the Popen objects and the path rank 0 writes its verdicts to."""
    world = GROUPS[group][0]
    os.makedirs(workdir, exist_ok=True)
    init = f"file://{os.path.join(workdir, 'store')}"
    result = os.path.join(workdir, "result.json")
    cmd = [sys.executable, os.path.abspath(__file__), "--rank-group", str(group),
           "--init", init, "--result", result, "--workdir", os.path.join(workdir, "run"),
           "--device", str(device), "--only", *names]
    if golden_npz:
        cmd += ["--golden-npz", golden_npz]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)]) for r in range(world)]
    return procs, result


def _wait_group(procs, result, timeout_s):
    deadline = time.monotonic() + timeout_s
    try:
        codes = [p.wait(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
    except subprocess.TimeoutExpired:
        codes = None
    finally:
        for p in procs:
            p.kill()
            p.wait()
    if codes != [0] * len(procs) or not os.path.exists(result):
        raise RuntimeError(f"rank group exited with {codes}")
    with open(result) as f:
        return json.load(f)


def build_record(results, platform, n_devices, elapsed_s, counters):
    """The drill matrix's record: the JAX drill's keys."""
    return {
        "drill": "chaos",
        "pass": bool(results) and all(drill_passed(r) for r in results.values()),
        "platform": platform,
        "n_devices": n_devices,
        "elapsed_s": round(elapsed_s, 1),
        "faults": results,
        "counters": counters,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", default=None, metavar="DRILL",
                    help="run only the named drill(s); the record is NOT written unless "
                         "--out is also given")
    ap.add_argument("--out", default=None,
                    help="output path (default: chiprun_out/torch_chaos_drill.json for the "
                         "full matrix, none for --only subsets)")
    ap.add_argument("--dump-dir", default=None,
                    help="flight-recorder dump directory (must be empty; default: a fresh "
                         "tempdir) — read before the port is imported")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--golden-npz", default=None,
                    help="the golden task's arrays (x, y, state/<parameter>)")
    ap.add_argument("--rank-group", type=int, choices=sorted(GROUPS), default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--result", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--workdir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_group is not None:
        _rank_worker(args)
        return 0
    dump_dir = os.environ.get("BAGUA_OBS_DUMP_DIR")
    if args.dump_dir and os.path.abspath(args.dump_dir) != os.path.abspath(dump_dir or ""):
        ap.error(f"--dump-dir must appear on the PROCESS command line (dumps already "
                 f"bound to {dump_dir} at import)")
    names = DRILL_NAMES
    if args.only:
        unknown = [n for n in args.only if n not in DRILL_NAMES]
        if unknown:
            ap.error(f"unknown drill(s) {unknown}; choose from {sorted(DRILL_NAMES)}")
        names = tuple(n for n in DRILL_NAMES if n in args.only)

    if args.device == "cpu":
        torch.set_num_threads(1)   # tiny models beside the rank groups' processes
    t0 = time.time()
    counters_before = _snapshot()
    tmp = tempfile.mkdtemp(prefix="chaos_drill_")
    # the rank groups run beside the in-process drills, each in its own
    # processes and dump directory
    groups = {}
    for group, own in ((2, RANKS_2), (4, RANKS_4)):
        picked = [n for n in own if n in names]
        if picked:
            groups[group] = _spawn_group(group, picked, args.device,
                                         os.path.join(tmp, f"ranks{group}"),
                                         golden_npz=args.golden_npz)
    results = {}
    try:
        results.update(run_in_process([n for n in IN_PROCESS if n in names], args.device,
                                      dump_dir=dump_dir, tmp=tmp, golden=args.golden_npz))
    finally:
        for group, (procs, result) in groups.items():
            try:
                results.update(_wait_group(procs, result, 600))
            except RuntimeError as e:
                for n in (RANKS_2 if group == 2 else RANKS_4):
                    if n in names:
                        results[n] = {"injected": True, "detected": False,
                                      "recovered": False, "world": GROUPS[group][0],
                                      "details": f"rank group failed: {e}"}
    results = {n: results[n] for n in DRILL_NAMES if n in results}
    worlds = [r.get("world", 1) for r in results.values()]
    record = build_record(results, torch.device(args.device).type, max(worlds or [1]),
                          time.time() - t0, _counter_deltas(counters_before))
    out = args.out or (None if args.only else OUT)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(record, f, indent=2, sort_keys=True)
            f.write("\n")
        log(f"wrote {out} (pass={record['pass']})")
    else:
        log(f"subset pass={record['pass']} (no record written; use --out)")
    for name, r in results.items():
        log(f"  {'PASS' if drill_passed(r) else 'FAIL'} {name} ({r['seconds']} s, world "
            f"{r['world']})")
    return 0 if record["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
