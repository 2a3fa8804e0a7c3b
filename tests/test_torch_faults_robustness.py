"""The port's robustness fault hooks and health beacons against the JAX
package.

Mirrors ``tests/test_faults.py`` (``:113-176`` and ``:573-780``): the
``store.op`` flake retried by the launcher's restart store; a dropped
heartbeat expiring a lease; ``step.straggle``'s validation, gating, caller
base time and the dilation of a synchronous family's steps (async model
average's steps are not gated); the heartbeat's wire format
(``parse_beat``), the beat's health payload, ``health_event_count``, the
beacon round trip, the fence of an unhealthy member, the grad guard's
beacon, ``merged_health_source`` and the coordinator's observed health.
Where both packages compute the same thing (the parsed beats, the event
counts, the merged payload, the fault points) the port's result equals the
JAX package's.  One interop case: the port's ``MembershipClient`` and
``LeaseHeartbeat`` and the JAX package's on one ``TCPStoreServer`` read each
other's keys, worlds and beats.  Plus the port's own hooks: async model
average's dropped round publishing the beacon, and ``maybe_hang``'s stop
event.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import bagua_tpu_torch as bt
from bagua_tpu.elastic import membership as jmb
from bagua_tpu.faults import inject as jinject
from bagua_tpu_torch.contrib.utils.store import InMemoryStore
from bagua_tpu_torch.elastic import membership as mb
from bagua_tpu_torch.faults import inject
from bagua_tpu_torch.faults.inject import FaultPlan, FaultSpec, fault_scope
from bagua_tpu_torch.models.mlp import MLP
from bagua_tpu_torch.telemetry import counters

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def process_group():
    bt.init_process_group(device="cpu")


@pytest.fixture(autouse=True)
def _clean_faults():
    inject.clear_plan()
    bt.reset_abort()
    yield
    inject.clear_plan()
    bt.reset_abort()


def _delta(before, name):
    return counters.get(name) - before.get(name, 0)


def _make_trainer(algo=None, steps=0, **kw):
    trainer = bt.BaguaTrainer(lambda m, b: torch.nn.functional.cross_entropy(m(b["x"]), b["y"]),
                              lambda p: torch.optim.SGD(p, lr=0.1),
                              algo or bt.GradientAllReduceAlgorithm(), device="cpu",
                              bucket_bytes=256, **kw)
    state = trainer.init(MLP(4, features=(16, 8), device="cpu"))
    rng = np.random.default_rng(0)
    batch = {"x": torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32)),
             "y": torch.from_numpy(rng.integers(0, 8, size=16))}
    loss = None
    for _ in range(steps):
        state, loss = trainer.train_step(state, batch)
    return trainer, state, batch, loss


def test_fault_points_and_injected_errors_match_jax():
    assert inject.FAULT_POINTS == jinject.FAULT_POINTS
    err = inject.InjectedStoreError("x")
    assert isinstance(err, ConnectionError) and isinstance(err, inject.InjectedFault)
    with fault_scope(FaultSpec("store.op")):
        with pytest.raises(inject.InjectedStoreError, match="store.op"):
            inject.maybe_raise_store_error("get('k')")
        inject.maybe_raise_store_error("get('k')")  # count=1 spent
    with fault_scope(FaultSpec("store.failover", count=2)):
        for _ in range(2):
            with pytest.raises(inject.InjectedStoreError, match="store.failover"):
                inject.maybe_raise_store_error("set", point="store.failover")


def test_should_drop_heartbeat_counts_fires():
    with fault_scope(FaultSpec("elastic.heartbeat", count=2)):
        assert [inject.should_drop_heartbeat() for _ in range(3)] == [True, True, False]
    assert inject.should_drop_heartbeat() is False


def test_maybe_hang_is_bounded_by_its_stop_event():
    stop = threading.Event()
    with fault_scope(FaultSpec("collective.hang", duration_s=30.0)):
        threading.Timer(0.2, stop.set).start()
        t0 = time.monotonic()
        assert inject.maybe_hang(stop_event=stop) == 30.0
        assert time.monotonic() - t0 < 5.0
        assert inject.maybe_hang(stop_event=stop) == 0.0  # count=1 spent


# ---- store.op: retry path -------------------------------------------------


def test_store_flake_recovers_via_retry(monkeypatch):
    from bagua_tpu_torch.distributed import run as run_mod

    backing = InMemoryStore()
    monkeypatch.setattr(run_mod, "_connect_restart_store",
                        lambda args, timeout_s=60.0: backing)
    monkeypatch.setattr(run_mod, "_store_endpoints", lambda args: None)
    store = run_mod._RestartStore(args=None)
    store.set("k", "v")
    before = counters.snapshot()
    with fault_scope(FaultSpec("store.op")):
        assert store.get("k") == "v"
    assert _delta(before, "faults/store.op/fired") == 1
    assert _delta(before, "faults/store.op/recovered") == 1


# ---- elastic.heartbeat: lease expiry -------------------------------------


def test_heartbeat_drop_expires_lease():
    store = InMemoryStore()
    client = mb.MembershipClient(store, node_id=0, max_nnodes=1)
    hb = mb.LeaseHeartbeat(lambda: store, node_id=0, epoch=0, interval_s=0.05).start()
    try:
        deadline = time.time() + 5
        while client.read_beats(0, [0])[0] is None and time.time() < deadline:
            time.sleep(0.05)
        assert client.read_beats(0, [0])[0] is not None, "no beats arrived"
        tracker = mb.LeaseTracker(client, epoch=0, member_ids=[0], ttl_s=0.4)
        assert tracker.poll() == []
        before = counters.snapshot()
        with fault_scope(FaultSpec("elastic.heartbeat", count=-1)):
            deadline = time.time() + 5
            expired = []
            while not expired and time.time() < deadline:
                time.sleep(0.1)
                expired = tracker.poll()
            assert expired == [0], "starved lease never expired"
            assert _delta(before, "faults/elastic.heartbeat/fired") >= 1
            inject.record_recovery("elastic.heartbeat")
        assert _delta(before, "faults/elastic.heartbeat/recovered") == 1
    finally:
        hb.stop()


# ---- step.straggle ----------------------------------------------------------


def test_straggle_spec_validation():
    with pytest.raises(ValueError, match="factor must be >= 1.0"):
        FaultSpec("step.straggle", factor=0.5)
    assert FaultSpec("step.straggle").kind == "dilate"
    assert FaultSpec("async.partition").kind == "drop"


def test_maybe_straggle_gating_and_delay():
    """The straggler's own process always pays; peers pay only at gated
    points, and an ungated query consumes no fire."""
    before = counters.snapshot()
    with fault_scope(FaultSpec("step.straggle", rank=1, count=-1, base_ms=20.0, factor=3.0)):
        assert inject.maybe_straggle("step", gated=False) == 0.0
        assert _delta(before, "faults/step.straggle/fired") == 0
        t0 = time.monotonic()
        delay = inject.maybe_straggle("collective", gated=True)
        assert abs(delay - 0.04) < 1e-9
        assert time.monotonic() - t0 >= 0.04
        assert _delta(before, "faults/step.straggle/fired") == 1
        assert inject.straggle_targets_self() is False
    with fault_scope(FaultSpec("step.straggle", rank=0, count=-1, base_ms=10.0, factor=2.0)):
        assert inject.maybe_straggle("step", gated=False) > 0.0
        assert inject.straggle_targets_self() is True


def test_maybe_straggle_uses_caller_base_dt():
    with fault_scope(FaultSpec("step.straggle", count=-1, factor=2.0)):
        assert abs(inject.maybe_straggle("step", base_dt=0.015) - 0.015) < 1e-9
        assert inject.maybe_straggle("step", base_dt=None) == 0.0


def test_straggle_dilates_sync_family_steps():
    """A 3x peer straggler dilates a synchronous family's steps (the
    per-step gradient collective gates on the slow peer)."""
    t, s, b, _ = _make_trainer(steps=3)
    t0 = time.monotonic()
    for _ in range(3):
        s, _ = t.train_step(s, b)
    clean = time.monotonic() - t0
    assert t.measured_step_dt() is not None
    before = counters.snapshot()
    with fault_scope(FaultSpec("step.straggle", rank=1, count=-1, base_ms=20.0, factor=3.0)):
        t0 = time.monotonic()
        for _ in range(3):
            s, loss = t.train_step(s, b)
        straggled = time.monotonic() - t0
    assert _delta(before, "faults/step.straggle/fired") == 3
    assert straggled >= clean + 3 * 0.04 * 0.9
    assert np.isfinite(float(loss))


def test_straggle_does_not_gate_async_steps():
    """Async model average's steps run on stale local weights: a peer's
    straggle does not gate them (its boundaries pay, at world > 1)."""
    algo = bt.AsyncModelAverageAlgorithm(sync_interval_ms=1, warmup_steps=0)
    assert algo.straggler_gates_step is False
    assert bt.GradientAllReduceAlgorithm().straggler_gates_step is True
    t, s, b, _ = _make_trainer(algo, steps=2)
    before = counters.snapshot()
    with fault_scope(FaultSpec("step.straggle", rank=1, count=-1, base_ms=20.0, factor=3.0)):
        for _ in range(3):
            s, _ = t.train_step(s, b)
    assert _delta(before, "faults/step.straggle/fired") == 0
    algo.abort()


def test_injected_stall_leaves_the_cadence_base():
    t, s, b, _ = _make_trainer(steps=2)
    t.note_injected_stall(5.0)
    s, _ = t.train_step(s, b)
    assert t.measured_step_dt() is None or t.measured_step_dt() < 5.0


# ---- the heartbeat's health payload and the fence ------------------------


@pytest.mark.parametrize("raw", [None, "7", b"7", '{"seq": 3, "health": {"grad_unhealthy": 2}}',
                                 "{torn json", '{"health": {}}'])
def test_parse_beat_wire_compat(raw):
    assert mb.MembershipClient._parse_beat(raw) == jmb.MembershipClient._parse_beat(raw)


def test_parse_beat_values():
    assert mb.MembershipClient._parse_beat(None) == (None, None)
    assert mb.MembershipClient._parse_beat("7") == (7, None)
    seq, health = mb.MembershipClient._parse_beat('{"seq": 3, "health": {"grad_unhealthy": 2}}')
    assert seq == 3 and health == {"grad_unhealthy": 2}
    assert mb.MembershipClient._parse_beat("{torn json") == (None, None)


def test_beat_carries_health_payload():
    client = mb.MembershipClient(InMemoryStore(), node_id=3, max_nnodes=4)
    client.beat(0, 1)
    assert client.read_beats_full(0, [3])[3] == (1, None)
    client.beat(0, 2, health={"async_missed": 5})
    assert client.read_beats_full(0, [3])[3] == (2, {"async_missed": 5})
    assert client.read_beats(0, [3]) == {3: 2}


@pytest.mark.parametrize("health", [None, {}, {"async_staleness": 9},
                                    {"grad_unhealthy": 2, "async_missed": 3,
                                     "async_staleness": 9},
                                    {"grad_skipped": 4}])
def test_health_event_count_semantics(health):
    assert mb.health_event_count(health) == jmb.health_event_count(health)


def test_health_event_count_values():
    assert mb.health_event_count({"async_staleness": 9}) == 0
    assert mb.health_event_count({"grad_unhealthy": 2, "async_missed": 3}) == 5


def test_health_beacon_roundtrip(tmp_path, monkeypatch):
    from bagua_tpu_torch.obs import export as obs_export

    monkeypatch.delenv("BAGUA_ELASTIC_HEALTH_FILE", raising=False)
    assert mb.write_health_beacon() is False
    path = str(tmp_path / "health.json")
    monkeypatch.setenv("BAGUA_ELASTIC_HEALTH_FILE", path)
    counters.incr("grad_guard/unhealthy_steps")
    # a process that noted no step carries no obs summary ...
    obs_export.reset_local_summary()
    assert mb.write_health_beacon() is True
    snap = mb.file_health_source(path)()
    assert snap and snap.get("grad_unhealthy", 0) >= 1
    assert "obs" not in snap
    # the JAX package's reader takes the port's beacon as it is
    assert jmb.file_health_source(path)() == snap
    # ... a training process carries its per-rank summary under "obs"
    obs_export.note_step(3, 0.01)
    assert mb.write_health_beacon() is True
    snap = mb.file_health_source(path)()
    assert snap["obs"]["step"] == 3
    assert jmb.file_health_source(path)() == snap
    obs_export.reset_local_summary()
    assert mb.file_health_source(str(tmp_path / "nope.json"))() is None
    with open(path, "w") as f:
        f.write("{torn")
    assert mb.file_health_source(path)() is None


def test_lease_tracker_fences_unhealthy_member():
    store = InMemoryStore()
    client = mb.MembershipClient(store, node_id=0, max_nnodes=2)
    tracker = mb.LeaseTracker(client, epoch=0, member_ids=[0, 1], ttl_s=30.0,
                              fence_unhealthy_after=3)
    client.beat(0, 1)
    mb.MembershipClient(store, node_id=1, max_nnodes=2).beat(
        0, 1, health={"grad_unhealthy": 2, "async_missed": 1})
    assert tracker.poll() == []
    assert tracker.health_of(0) is None
    assert tracker.health_of(1) == {"grad_unhealthy": 2, "async_missed": 1}
    assert tracker.unhealthy_members() == [1]
    relaxed = mb.LeaseTracker(client, epoch=0, member_ids=[0, 1], ttl_s=30.0)
    relaxed.poll()
    assert relaxed.unhealthy_members() == []


def test_grad_guard_publishes_health_beacon(tmp_path, monkeypatch):
    path = str(tmp_path / "beacon.json")
    monkeypatch.setenv("BAGUA_ELASTIC_HEALTH_FILE", path)
    with fault_scope(FaultSpec("grad.poison", step=1)):
        t, s, b, loss = _make_trainer(steps=3, grad_guard="skip")
        t.flush_grad_health()
    assert os.path.exists(path)
    snap = mb.file_health_source(path)()
    assert snap and snap.get("grad_skipped", 0) >= 1 and snap.get("grad_unhealthy", 0) >= 1


def test_async_dropped_round_publishes_health_beacon(tmp_path, monkeypatch):
    """A round this rank sits out is a fenceable event (JAX ``:327``): the
    drop counts ``async/missed_boundaries`` and refreshes the beacon."""
    path = str(tmp_path / "beacon.json")
    monkeypatch.setenv("BAGUA_ELASTIC_HEALTH_FILE", path)
    algo = bt.AsyncModelAverageAlgorithm(sync_interval_ms=1, warmup_steps=0)
    before = counters.snapshot()
    algo._pending = ([], [], None)   # a round in flight with no collectives
    algo._drop_pending("partitioned out of the negotiation round")
    assert _delta(before, "async/missed_boundaries") == 1
    snap = mb.file_health_source(path)()
    assert snap and snap["async_missed"] >= 1
    # a drop on every rank at once (a catch-up supersedes it) is no event
    algo._pending = ([], [], None)
    before = counters.snapshot()
    algo._drop_pending("superseded", health_event=False)
    assert _delta(before, "async/missed_boundaries") == 0


def test_merged_health_source_sums_events_max_gauges(tmp_path):
    paths = [str(tmp_path / f"beacon.r{i}") for i in range(3)]
    src, jsrc = mb.merged_health_source(paths), jmb.merged_health_source(paths)
    assert src() is None and jsrc() is None
    with open(paths[0], "w") as f:
        json.dump({"grad_unhealthy": 2, "async_staleness": 3}, f)
    with open(paths[1], "w") as f:
        json.dump({"grad_unhealthy": 1, "async_missed": 4, "async_staleness": 1}, f)
    want = {"grad_unhealthy": 3, "async_missed": 4, "async_staleness": 3}
    assert src() == want == jsrc()


def test_lease_tracker_observes_coordinator_health():
    store = InMemoryStore()
    client = mb.MembershipClient(store, node_id=0, max_nnodes=2)
    tracker = mb.LeaseTracker(client, epoch=0, member_ids=[1], ttl_s=0.1,
                              fence_unhealthy_after=3, observe_only_ids=[0])
    mb.MembershipClient(store, node_id=1, max_nnodes=2).beat(0, 1)
    client.beat(0, 1, health={"grad_unhealthy": 5})
    assert tracker.poll() == []
    assert tracker.health_of(0) == {"grad_unhealthy": 5}
    assert tracker.unhealthy_members() == [0]
    time.sleep(0.25)
    assert tracker.poll() == [1]


def test_partition_hook_consumes_one_round():
    inject.set_plan(FaultPlan([FaultSpec("async.partition")]))
    assert inject.maybe_drop_negotiation_round() is True
    assert inject.maybe_drop_negotiation_round() is False


# ---- interop with the JAX package on one store ----------------------------


@pytest.mark.parametrize("server_side", ["port", "jax"])
def test_membership_interop_with_jax(server_side):
    """The port's and the JAX package's membership clients and heartbeats on
    one store server read each other's joins, worlds, beats, stops and leave
    intents."""
    from bagua_tpu.contrib.utils.tcp_store import TCPStore as JStore
    from bagua_tpu.contrib.utils.tcp_store import TCPStoreServer as JServer
    from bagua_tpu_torch.contrib.utils.tcp_store import TCPStore, TCPStoreServer

    server = (TCPStoreServer if server_side == "port" else JServer)(backend="python")
    host, port = server.address
    try:
        mine = mb.MembershipClient(TCPStore(host, port), node_id=0, max_nnodes=3)
        theirs = jmb.MembershipClient(JStore(host, port), node_id=1, max_nnodes=3)
        mine.open_epoch(2)
        assert theirs.current_epoch() == 2
        mine.join(2)
        theirs.join(2)
        assert mine.joined_ids(2) == theirs.joined_ids(2) == [0, 1]
        spec = mb.WorldSpec(epoch=2, ranks={0: 0, 1: 1}, min_nnodes=1, max_nnodes=3,
                            master_addr=host, master_port=1234)
        mine.publish_world(spec)
        got = theirs.read_world(2)
        assert got.to_json() == spec.to_json() and got.rank_of(1) == 1
        theirs.publish_world(jmb.WorldSpec(**{**got.__dict__, "epoch": 3}))
        assert mine.read_world(3).ranks == spec.ranks
        mine.beat(2, 5, health={"grad_unhealthy": 1})
        theirs.beat(2, 6)
        assert theirs.read_beats_full(2, [0, 1]) == mine.read_beats_full(2, [0, 1]) == {
            0: (5, {"grad_unhealthy": 1}), 1: (6, None)}
        hb_port = mb.LeaseHeartbeat(lambda: TCPStore(host, port), node_id=2, epoch=2,
                                    interval_s=0.05, max_nnodes=3,
                                    health_source=lambda: {"async_missed": 2}).start()
        try:
            deadline = time.time() + 5
            while theirs.read_beats(2, [2])[2] is None and time.time() < deadline:
                time.sleep(0.02)
            seq, health = theirs.read_beats_full(2, [2])[2]
            assert seq >= 1 and health == {"async_missed": 2}
            tracker = jmb.LeaseTracker(theirs, 2, [2], ttl_s=5.0, fence_unhealthy_after=2)
            tracker.poll()
            assert tracker.unhealthy_members() == [2]
        finally:
            hb_port.stop()
        theirs.publish_stop(2, jmb.STOP_LEASE_EXPIRED, 1, "gone", rejoin=False)
        assert mine.read_stop(2) == {"kind": mb.STOP_LEASE_EXPIRED, "node": 1,
                                     "reason": "gone", "rejoin": False, "nodes": [1]}
        mine.publish_leave(2, "watchdog: stuck")
        assert theirs.read_leave(2, 0) == "watchdog: stuck"
    finally:
        server.stop()
