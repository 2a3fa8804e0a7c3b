"""The port's coordinator failover (``bagua_tpu_torch/elastic/failover.py``)
over its replicated restart store, and the launcher's coordinator stack.

Mirrors ``tests/test_failover.py``: the replicated store (op-log
replication, snapshot catch-up, generation fencing, a relaunched primary
recovering from its peers), the multi-endpoint ``FailoverStore``, the
leadership lease (keeper and standby watch), the lease re-arm at takeover.
``test_promoted_coordinator_resumes_autopilot_and_historian_state`` too,
and the launcher's takeover stack (``_build_coordinator_stack`` over the
replicated store) resumes the engine's policy state and the historian's
rings.  The failover counters are checked in the telemetry snapshot (the
JAX package checks its obs metric registry).  The settings the launcher
refused until the port had the autopilot, the historian and the HTTP plane
build their modules.
"""

import json
import time

import pytest

from bagua_tpu_torch.contrib.utils.store import InMemoryStore
from bagua_tpu_torch.contrib.utils.tcp_store import (
    StoreFencedError,
    TCPStore,
    TCPStoreServer,
)
from bagua_tpu_torch.elastic.failover import (
    CoordinatorLeaseKeeper,
    FailoverStore,
    StandbyCoordinatorWatch,
    StoreOpDeadlineError,
    parse_endpoint,
    parse_endpoints,
    read_coord_lease,
    write_coord_lease,
)
from bagua_tpu_torch.elastic.membership import LeaseTracker, MembershipClient
from bagua_tpu_torch.podsim.util import reserve_port
from bagua_tpu_torch.telemetry import counters


def _wait(pred, timeout_s=10.0, poll_s=0.02, what="condition"):
    deadline = time.monotonic() + timeout_s
    while True:
        value = pred()
        if value:
            return value
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(poll_s)


def _repair():
    """Primary + follower store servers wired as a replica pair.  The
    follower binds first so the primary can be constructed knowing its
    replication peer (the op-log push originates at the primary)."""
    follower = TCPStoreServer(role="standby")
    primary = TCPStoreServer(role="primary", peers=[follower.address])
    return primary, follower


# ---------------------------------------------------------------------------
# endpoints
# ---------------------------------------------------------------------------


def test_parse_endpoints():
    assert parse_endpoint("10.0.0.1:2000") == ("10.0.0.1", 2000)
    assert parse_endpoint(("h", 1)) == ("h", 1)
    assert parse_endpoints(["a:1", ("b", 2)]) == [("a", 1), ("b", 2)]
    with pytest.raises(ValueError):
        parse_endpoint("no-port")
    with pytest.raises(ValueError):
        parse_endpoint("h:notaport")


# ---------------------------------------------------------------------------
# replication + generation fence (the replicated restart store)
# ---------------------------------------------------------------------------


def test_replication_streams_writes_to_follower():
    primary, follower = _repair()
    try:
        c = TCPStore(*primary.address)
        c.set("k1", b"v1")
        c.mset({"k2": b"v2", "k3": b"v3"})
        f = TCPStore(*follower.address)
        _wait(lambda: f.mget(["k1", "k2", "k3"]) == [b"v1", b"v2", b"v3"],
              what="op-log replication to the follower")
        assert primary.is_primary and not follower.is_primary
    finally:
        follower.stop()
        primary.stop()


def test_snapshot_catches_up_rejoining_follower():
    primary, follower = _repair()
    addr = follower.address
    try:
        follower.stop()  # replication link down; writes pile up
        c = TCPStore(*primary.address)
        c.mset({f"pre{i}": str(i).encode() for i in range(32)})
        # the follower rejoins AFTER the writes: the link must bootstrap
        # it with a snapshot, not just the tail of the op log
        follower = TCPStoreServer(host=addr[0], port=addr[1],
                                  role="standby")
        f = TCPStore(*addr)
        _wait(lambda: f.num_keys() >= 32, what="snapshot catch-up")
        assert f.get("pre7") == b"7"
    finally:
        follower.stop()
        primary.stop()


def test_generation_fence_rejects_demoted_primarys_late_writes():
    primary, follower = _repair()
    try:
        c = TCPStore(*primary.address)
        c.set("before", b"1")
        f = TCPStore(*follower.address)
        _wait(lambda: f.get("before") == b"1", what="initial replication")

        # a standby takeover = promote the follower to a HIGHER generation
        ok, gen = f.promote(1)
        assert ok and gen == 1
        assert follower.is_primary and follower.generation == 1

        # the stale primary still thinks it leads; its next write's
        # replication bounces off the fence (ACK_FENCED) and demotes it
        c.set("late", b"stale")
        _wait(lambda: not primary.is_primary,
              what="stale primary demotion via replication bounce")
        # the group never saw the late write...
        assert f.get("late") is None
        # ...and once demoted, the ex-primary refuses writes outright
        with pytest.raises(StoreFencedError):
            TCPStore(*primary.address).set("later", b"still stale")
    finally:
        follower.stop()
        primary.stop()


def test_relaunched_primary_recovers_state_and_demotion_from_peers():
    primary, follower = _repair()
    addr = primary.address
    try:
        TCPStore(*addr).set("durable", b"yes")
        f = TCPStore(*follower.address)
        _wait(lambda: f.get("durable") == b"yes", what="replication")
        primary.stop()

        # relaunch on the same endpoint: peer recovery restores the data
        relaunched = TCPStoreServer(
            host=addr[0], port=addr[1], role="primary",
            peers=[follower.address])
        try:
            assert TCPStore(*addr).get("durable") == b"yes"
            assert relaunched.is_primary
        finally:
            relaunched.stop()

        # after a takeover, the SAME relaunch must come back demoted: a
        # peer claims the primary role at a higher generation
        assert f.promote(3) == (True, 3)
        relaunched = TCPStoreServer(
            host=addr[0], port=addr[1], role="primary",
            peers=[follower.address])
        try:
            assert not relaunched.is_primary
            assert relaunched.generation == 3
        finally:
            relaunched.stop()
    finally:
        follower.stop()
        primary.stop()


# ---------------------------------------------------------------------------
# FailoverStore client
# ---------------------------------------------------------------------------


def test_failover_store_single_endpoint_plain_path():
    server = TCPStoreServer()
    try:
        s = FailoverStore([server.address])
        s.set("a", b"1")
        assert s.get("a") == b"1"
        assert s.generation == 0
        assert s.status()
        s.close()
    finally:
        server.stop()


def test_failover_store_survives_primary_death_and_promotes():
    primary, follower = _repair()
    try:
        s = FailoverStore([primary.address, follower.address])
        s.set("a", b"1")
        f = TCPStore(*follower.address)
        _wait(lambda: f.get("a") == b"1", what="replication")

        before = counters.get("store/failovers")
        primary.stop()
        # reads fail over to the follower without a promotion
        assert s.get("a") == b"1"
        assert counters.get("store/failovers") > before
        # a takeover election makes writes flow again (new generation)
        assert s.promote_store()
        assert s.generation >= 1
        s.set("b", b"2")
        assert s.get("b") == b"2"
        s.close()
    finally:
        follower.stop()
        primary.stop()


def test_failover_store_op_deadline_exceeded_counter():
    primary, follower = _repair()
    s = FailoverStore([primary.address, follower.address],
                      op_deadline_s=1.0, client_timeout_s=1.0)
    before = counters.get("store/op_deadline_exceeded")
    primary.stop()
    follower.stop()
    with pytest.raises(StoreOpDeadlineError):
        s.get("anything")
    assert counters.get("store/op_deadline_exceeded") == before + 1
    s.close()


def test_failover_counters_land_in_the_telemetry_snapshot():
    primary, follower = _repair()
    try:
        s = FailoverStore([primary.address, follower.address])
        s.set("a", b"1")
        _wait(lambda: TCPStore(*follower.address).get("a") == b"1", what="replication")
        primary.stop()
        assert s.get("a") == b"1"
        assert s.promote_store()
        snap = counters.snapshot()
        for name in ("store/failovers", "store/promotions"):
            assert snap.get(name, 0) >= 1, name
        s.close()
    finally:
        follower.stop()
        primary.stop()


def test_failover_store_injected_failover_walks_endpoints():
    """``store.failover`` declares the current endpoint dead: the client
    rescans the endpoints (the live primary still wins over the follower),
    the op completes and the recovery is recorded."""
    from bagua_tpu_torch.faults.inject import FaultSpec, clear_plan, fault_scope

    primary, follower = _repair()
    try:
        s = FailoverStore([primary.address, follower.address])
        s.set("a", b"1")
        _wait(lambda: TCPStore(*follower.address).get("a") == b"1", what="replication")
        before = counters.snapshot()
        with fault_scope(FaultSpec("store.failover")):
            assert s.get("a") == b"1"
        assert s.endpoint == primary.address
        assert counters.get("faults/store.failover/recovered") == \
            before.get("faults/store.failover/recovered", 0) + 1
        s.close()
    finally:
        clear_plan()
        follower.stop()
        primary.stop()


# ---------------------------------------------------------------------------
# leadership lease: keeper + standby watch
# ---------------------------------------------------------------------------


def test_coord_lease_roundtrip():
    store = InMemoryStore()
    write_coord_lease(store, 3, 17, generation=2)
    lease = read_coord_lease(store)
    assert lease == {"node": 3, "seq": 17, "gen": 2}
    assert read_coord_lease(InMemoryStore()) is None


def test_standby_watch_promotes_on_stale_lease():
    primary, follower = _repair()
    try:
        keeper = CoordinatorLeaseKeeper(
            lambda: FailoverStore([primary.address, follower.address]),
            0, 0.4).start()
        watch_store = FailoverStore([primary.address, follower.address])
        watch = StandbyCoordinatorWatch(watch_store, 1, 1, 0.4).start()
        try:
            _wait(lambda: read_coord_lease(watch_store) is not None,
                  what="keeper's first lease write")
            time.sleep(0.9)  # > ttl with the keeper alive: no promotion
            assert not watch.promoted

            before = counters.get("coord/takeovers")
            # the coordinator process hosts the primary store: its death
            # kills both (a live primary store vetoes the election)
            keeper.stop()
            primary.stop()
            _wait(lambda: watch.promoted, what="standby promotion")
            lease = read_coord_lease(watch.store)
            assert lease["node"] == 1
            assert lease["gen"] >= 1
            # the watch's OWN store client holds the new generation
            assert watch.store.generation >= 1
            assert counters.get("coord/takeovers") == before + 1
        finally:
            watch.stop()
            keeper.stop()
    finally:
        follower.stop()
        primary.stop()


# ---------------------------------------------------------------------------
# takeover grace: no mass lease expiry on coordinator restart
# ---------------------------------------------------------------------------


def _beat(store, epoch, node_id, seq):
    MembershipClient(store, node_id, 8).beat(epoch, seq)


def test_lease_tracker_rearm_prevents_mass_expiry():
    store = InMemoryStore()
    client = MembershipClient(store, 0, 8)
    for nid in (1, 2, 3):
        _beat(store, 0, nid, 1)

    # a NEW tracker (a promoted coordinator) whose members' heartbeats
    # stalled through the failover window: without rearm they all expire
    stale = LeaseTracker(client, 0, [1, 2, 3], ttl_s=0.2)
    stale.poll()
    time.sleep(0.35)
    assert sorted(stale.poll()) == [1, 2, 3]

    promoted = LeaseTracker(client, 0, [1, 2, 3], ttl_s=0.2)
    before = counters.get("elastic/lease_rearms")
    promoted.rearm(grace_s=1.0)
    assert counters.get("elastic/lease_rearms") == before + 3
    time.sleep(0.35)
    # ttl has passed with zero fresh beats, but the grace window holds
    assert promoted.poll() == []
    # a member that beats during the grace survives past it...
    _beat(store, 0, 2, 2)
    time.sleep(0.8)
    expired = promoted.poll()
    # ...while truly-dead members expire once the grace ends
    assert 2 not in expired
    assert set(expired) == {1, 3}


# ---------------------------------------------------------------------------
# the launcher's control plane: the settings it refused until the port had
# the autopilot, the historian and the HTTP plane now build them
# ---------------------------------------------------------------------------

_STACK_ARGS = dict(min_nnodes=1, max_nnodes=2, master_addr="127.0.0.1", master_port=1,
                   join_window=3.0, restart_barrier_timeout=9.0, bagua_service_port=1)


@pytest.mark.parametrize("name,value,module", [
    ("BAGUA_AUTOPILOT", "act", "autopilot"),
    ("BAGUA_AUTOPILOT", "observe", "autopilot"),
    ("BAGUA_OBS_HISTORIAN", "on", "historian"),
    ("BAGUA_OBS_HTTP_PORT", "free", "http"),
])
def test_launcher_refuses_what_waits_for_the_obs_plane(monkeypatch, name, value, module):
    """The settings the launcher refused while the port lacked their
    modules are accepted now: the coordinator stack builds the module each
    asks for (and nothing is refused: ``refuse_missing_modules`` is gone)."""
    from types import SimpleNamespace

    from bagua_tpu_torch.distributed import run as run_mod

    assert not hasattr(run_mod, "refuse_missing_modules")
    for var in ("BAGUA_AUTOPILOT", "BAGUA_OBS_HISTORIAN", "BAGUA_OBS_HTTP_PORT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv(name, str(reserve_port()) if value == "free" else value)
    stack = run_mod._build_coordinator_stack(SimpleNamespace(**_STACK_ARGS), InMemoryStore(),
                                             MembershipClient(InMemoryStore(), 0, 2))
    coordinator, autopilot, historian, fleet_holder, http_server = stack
    try:
        built = {"autopilot": autopilot, "historian": historian, "http": http_server}
        assert built[module] is not None
        assert [k for k, v in built.items() if v is not None] == [module]
        if module == "autopilot":
            assert autopilot.config.mode == value
        if module == "http":
            assert fleet_holder == {"record": None}
    finally:
        if http_server is not None:
            http_server.stop()


def test_launcher_runs_with_those_settings_off(monkeypatch):
    from types import SimpleNamespace

    from bagua_tpu_torch.distributed import run as run_mod

    monkeypatch.setenv("BAGUA_AUTOPILOT", "off")
    monkeypatch.setenv("BAGUA_OBS_HISTORIAN", "off")
    monkeypatch.setenv("BAGUA_OBS_HTTP_PORT", "0")
    monkeypatch.setenv("BAGUA_OBS_FLEET_OUT", "/tmp/fleet.json")
    _, autopilot, historian, fleet_holder, http_server = run_mod._build_coordinator_stack(
        SimpleNamespace(**_STACK_ARGS), None, MembershipClient(InMemoryStore(), 0, 2))
    assert (autopilot, historian, fleet_holder, http_server) == (None, None, None, None)


def test_coordinator_stack_is_the_coordinator_alone(monkeypatch):
    from types import SimpleNamespace

    from bagua_tpu_torch.distributed.run import _build_coordinator_stack
    from bagua_tpu_torch.elastic.coordinator import ElasticCoordinator

    for var in ("BAGUA_AUTOPILOT", "BAGUA_OBS_HISTORIAN", "BAGUA_OBS_HTTP_PORT"):
        monkeypatch.delenv(var, raising=False)
    args = SimpleNamespace(min_nnodes=1, max_nnodes=2, master_addr="127.0.0.1",
                           master_port=1, join_window=3.0, restart_barrier_timeout=9.0,
                           bagua_service_port=1)
    coord, *rest = _build_coordinator_stack(args, None, MembershipClient(InMemoryStore(), 0, 2))
    assert isinstance(coord, ElasticCoordinator)
    assert rest == [None, None, None, None]
    assert (coord.join_window_s, coord.timeout_s) == (3.0, 9.0)


def _fleet_record(epoch, step):
    from bagua_tpu_torch.obs.export import build_fleet_record

    return build_fleet_record(epoch, {
        0: {"obs": {"rank": 0, "step": step, "goodput_fraction": 0.9,
                    "worst_badput_class": "collective_wait"}},
        1: {"obs": {"rank": 1, "step": step, "goodput_fraction": 0.8,
                    "worst_badput_class": "collective_wait"}},
    })


def test_promoted_coordinator_resumes_autopilot_and_historian_state():
    """Mirrors ``tests/test_failover.py``'s case: a fresh engine and
    historian over the same (replicated) store resume the policy state and
    the trend rings."""
    from bagua_tpu_torch.autopilot.engine import AutopilotEngine
    from bagua_tpu_torch.autopilot.policy import PolicyConfig
    from bagua_tpu_torch.obs.historian import Historian

    store = InMemoryStore()
    cfg = PolicyConfig(mode="observe", sustain=2, cooldown_s=0.0,
                       budget=8, staleness_s=60.0, suspect_ttl_s=30.0)
    engine = AutopilotEngine(config=cfg, store=store)
    historian = Historian(capacity=64, window_s=60.0, store=store, persist_every=1)
    for step in range(4):
        record = _fleet_record(0, step)
        historian.ingest(record)
        engine.observe_snapshot(record)
    engine._persist_state()
    rung, taken = engine.state.rung, engine.state.actions_taken
    series = len(historian.metrics())
    assert series > 0
    engine2 = AutopilotEngine(config=cfg, store=store)
    historian2 = Historian(capacity=64, window_s=60.0, store=store, persist_every=1)
    assert engine2.state.rung == rung
    assert engine2.state.actions_taken == taken
    assert len(historian2.metrics()) == series
    assert all(len(historian2.window(rank, metric)) > 0
               for rank, metric in historian2.metrics())


def test_takeover_stack_resumes_the_engine_and_the_historian(monkeypatch):
    """The launcher's takeover path: the promoted standby's
    ``_build_coordinator_stack`` over the replicated store resumes what the
    dead coordinator's stack persisted (the engine's policy state, the
    historian's rings)."""
    from types import SimpleNamespace

    from bagua_tpu_torch.distributed import run as run_mod
    from bagua_tpu_torch.obs.historian import STORE_KEY

    monkeypatch.setenv("BAGUA_AUTOPILOT", "observe")
    monkeypatch.setenv("BAGUA_OBS_HISTORIAN", "on")
    monkeypatch.delenv("BAGUA_OBS_HTTP_PORT", raising=False)
    store = InMemoryStore()
    args = SimpleNamespace(**_STACK_ARGS)
    _, engine, historian, _, _ = run_mod._build_coordinator_stack(
        args, store, MembershipClient(store, 0, 2))
    for step in range(4):
        engine.observe_snapshot(historian.ingest(_fleet_record(0, step)))
    engine._persist_state()
    store.set(STORE_KEY, historian.to_json())
    _, engine2, historian2, _, _ = run_mod._build_coordinator_stack(
        args, store, MembershipClient(store, 1, 2))
    assert engine2.state.to_json() == engine.state.to_json()
    assert engine.state.last_snapshot_unix is not None
    assert historian2.metrics() == historian.metrics()
    assert all(historian2.window(r, m) == historian.window(r, m)
               for r, m in historian.metrics())
