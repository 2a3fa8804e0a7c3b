"""The port's elastic membership stack (``bagua_tpu_torch/elastic``) and the
launcher's monitor paths, against the JAX package.

Mirrors ``tests/test_elastic.py``'s cases on the port's modules (pure CPU,
ephemeral ports, no subprocesses): the lease registry and epoch fencing,
rendezvous rounds (join window, exclusion, timeouts), the launcher's
monitor teardown paths, the restart store's retries and the worker-side
resize hooks.  ``WorldSpec``'s JSON, ``shard_bounds`` and
``ElasticContext.from_env`` equal the JAX package's on the same inputs.
``test_restart_store_retries_non_oserror_timeout`` tests what the JAX test
means (the restart store retries a timed-out op on a fresh connection, for
the builtin ``TimeoutError`` and ``concurrent.futures.TimeoutError`` alike)
without its assertion that the two differ, which fails on Python 3.11+,
where they are one class.  Plus the port's own: the coordinator naming a
lost node when a local worker fails first (a gloo survivor fails at once at
its next collective), and ``elastic_restore``.
"""

import concurrent.futures
import threading
import time
from types import SimpleNamespace

import pytest

from bagua_tpu_torch.contrib.utils.tcp_store import TCPStore, TCPStoreServer
from bagua_tpu_torch.elastic.coordinator import (
    ElasticCoordinator,
    ExcludedFromRound,
    RendezvousTimeout,
    join_round,
    wait_for_next_epoch,
)
from bagua_tpu_torch.elastic.membership import (
    STOP_FAIL,
    STOP_LEASE_EXPIRED,
    STOP_RESIZE,
    LeaseHeartbeat,
    LeaseTracker,
    MembershipClient,
    WorldSpec,
    publish_leave_intent,
)
from bagua_tpu_torch.elastic.resize import ElasticContext, shard_bounds
from bagua_tpu_torch.podsim.util import reserve_port


@pytest.fixture()
def store_server():
    # python backend: the unit tests must not depend on a g++ build
    server = TCPStoreServer(backend="python")
    yield server
    server.stop()


def _client(server, node_id, max_nnodes=4) -> MembershipClient:
    host, port = server.address
    return MembershipClient(TCPStore(host, port), node_id, max_nnodes)


def _spec(server, epoch=0, ids=(0,), min_nnodes=1, max_nnodes=4) -> WorldSpec:
    return WorldSpec(
        epoch=epoch, ranks={i: r for r, i in enumerate(sorted(ids))},
        min_nnodes=min_nnodes, max_nnodes=max_nnodes,
        master_addr=server.address[0], master_port=12345,
    )


# ---------------------------------------------------------------------------
# membership: registry, leases, fencing
# ---------------------------------------------------------------------------


def test_world_spec_roundtrip_and_ranks():
    spec = WorldSpec(epoch=7, ranks={0: 0, 3: 1}, min_nnodes=1, max_nnodes=4,
                     master_addr="10.0.0.1", master_port=29400)
    back = WorldSpec.from_json(spec.to_json())
    assert back == spec
    assert back.nnodes == 2
    assert back.rank_of(3) == 1 and back.rank_of(2) is None


def test_join_registry_enumerates_ids(store_server):
    c0, c2 = _client(store_server, 0), _client(store_server, 2)
    c0.join(0)
    c2.join(0, info={"note": "standby"})
    assert c0.joined_ids(0) == [0, 2]
    assert c0.joined_ids(1) == []  # other epochs are separate keyspaces


def test_lease_expires_when_heartbeat_stops(store_server):
    c0 = _client(store_server, 0)
    host, port = store_server.address
    hb = LeaseHeartbeat(lambda: TCPStore(host, port), node_id=1, epoch=0,
                        interval_s=0.05, max_nnodes=4).start()
    tracker = LeaseTracker(c0, epoch=0, member_ids=[1], ttl_s=0.5)
    deadline = time.time() + 3.0
    while c0.read_beats(0, [1])[1] is None and time.time() < deadline:
        time.sleep(0.02)
    assert c0.read_beats(0, [1])[1] is not None, "no heartbeat arrived"
    assert tracker.poll() == []  # alive while beating
    hb.stop()
    deadline = time.time() + 5.0
    while tracker.poll() == [] and time.time() < deadline:
        time.sleep(0.05)
    assert tracker.poll() == [1], "lease did not expire after beats stopped"


def test_zombie_heartbeat_fenced_out_by_epoch_bump(store_server):
    """A heartbeater from attempt N stops itself once the coordinator opens
    attempt N+1 — the zombie cannot keep a stale lease alive."""
    c0 = _client(store_server, 0)
    host, port = store_server.address
    hb = LeaseHeartbeat(lambda: TCPStore(host, port), node_id=1, epoch=0,
                        interval_s=0.05, max_nnodes=4).start()
    deadline = time.time() + 3.0
    while c0.read_beats(0, [1])[1] is None and time.time() < deadline:
        time.sleep(0.02)
    c0.open_epoch(1)  # fence: epoch moved on
    hb._thread.join(timeout=3.0)
    assert not hb._thread.is_alive(), "zombie kept beating past the fence"
    assert c0.read_beats(1, [1])[1] is None  # never wrote into the new epoch
    hb.stop()


def test_leave_intent_via_env(store_server, monkeypatch):
    host, port = store_server.address
    monkeypatch.setenv("BAGUA_ELASTIC_STORE_ADDR", f"{host}:{port}")
    monkeypatch.setenv("BAGUA_ELASTIC_EPOCH", "2")
    monkeypatch.setenv("BAGUA_ELASTIC_NODE_ID", "3")
    assert publish_leave_intent("watchdog: step stuck for 30 s")
    c0 = _client(store_server, 0)
    assert c0.read_leave(2, 3) == "watchdog: step stuck for 30 s"
    assert c0.read_leave(2, 1) is None


def test_leave_intent_noop_outside_elastic(monkeypatch):
    monkeypatch.delenv("BAGUA_ELASTIC_STORE_ADDR", raising=False)
    assert publish_leave_intent("whatever") is False


# ---------------------------------------------------------------------------
# coordinator: rendezvous rounds
# ---------------------------------------------------------------------------


def _coordinator(server, min_nnodes=1, max_nnodes=4, **kw) -> ElasticCoordinator:
    c0 = _client(server, 0, max_nnodes)
    kw.setdefault("join_window_s", 0.5)
    kw.setdefault("timeout_s", 10.0)
    kw.setdefault("poll_s", 0.02)
    return ElasticCoordinator(c0, min_nnodes, max_nnodes,
                              server.address[0], 12345, **kw)


def test_round_admits_members_within_window(store_server):
    coord = _coordinator(store_server, min_nnodes=1, max_nnodes=4)
    c1 = _client(store_server, 1)
    c1.join(0)
    spec = coord.run_round(0)
    assert spec.ranks == {0: 0, 1: 1}
    assert spec.nnodes == 2
    # members read the same spec back
    assert join_round(c1, 0, timeout_s=2.0) == spec


def test_round_closes_early_when_full(store_server):
    coord = _coordinator(store_server, min_nnodes=1, max_nnodes=2,
                         join_window_s=30.0)
    c1 = _client(store_server, 1, max_nnodes=2)
    c1.join(0)
    t0 = time.monotonic()
    spec = coord.run_round(0)
    assert spec.nnodes == 2
    assert time.monotonic() - t0 < 5.0, "full round should not wait the window"


def test_round_closes_early_on_expected_survivors(store_server):
    """Crash restarts don't pay the join window: once every expected
    survivor re-registered the round closes."""
    coord = _coordinator(store_server, min_nnodes=1, max_nnodes=4,
                         join_window_s=30.0)
    c1 = _client(store_server, 1)
    c1.join(3)
    t0 = time.monotonic()
    spec = coord.run_round(3, expect={0, 1})
    assert sorted(spec.ranks) == [0, 1]
    assert time.monotonic() - t0 < 5.0


def test_node_missing_join_window_is_excluded_not_hung(store_server):
    coord = _coordinator(store_server, min_nnodes=1, max_nnodes=4,
                         join_window_s=0.3)
    spec = coord.run_round(0)  # closes with just the coordinator
    assert sorted(spec.ranks) == [0]
    late = _client(store_server, 2)
    t0 = time.monotonic()
    with pytest.raises(ExcludedFromRound) as e:
        join_round(late, 0, timeout_s=5.0)
    assert time.monotonic() - t0 < 2.0, "excluded node must not hang"
    assert "missed the join window" in str(e.value)
    # ...and the coordinator sees it as a standby asking for a scale-up
    assert coord.standby_ids(spec) == [2]


def test_expect_early_close_respects_min_floor(store_server):
    """Survivor-based early close must not under-shrink the job: with
    MIN=2 and only the coordinator surviving, the round may NOT assemble a
    1-node world just because every expected survivor is present."""
    coord = _coordinator(store_server, min_nnodes=2, max_nnodes=4,
                         join_window_s=0.2, timeout_s=0.8)
    with pytest.raises(RendezvousTimeout):
        coord.run_round(1, expect={0})  # expect satisfied, but below MIN


def test_rendezvous_timeout_below_min_nnodes(store_server):
    coord = _coordinator(store_server, min_nnodes=2, max_nnodes=4,
                         join_window_s=0.1, timeout_s=0.5)
    with pytest.raises(RendezvousTimeout) as e:
        coord.run_round(0)
    msg = str(e.value)
    assert "min_nnodes=2" in msg and "timed out" in msg


def test_member_join_timeout_when_no_world_published(store_server):
    c1 = _client(store_server, 1)
    with pytest.raises(RendezvousTimeout) as e:
        join_round(c1, 0, timeout_s=0.4, poll_s=0.05)
    assert "coordinator gone" in str(e.value)


def test_join_round_follows_epoch_fence(store_server):
    """A member rejoining with a stale epoch lands in the live round."""
    c0 = _client(store_server, 0)
    c0.open_epoch(5)
    c0.publish_world(_spec(store_server, epoch=5, ids=(0, 1)))
    c1 = _client(store_server, 1)
    spec = join_round(c1, 0, timeout_s=2.0, poll_s=0.02)
    assert spec.epoch == 5 and spec.rank_of(1) == 1
    assert c0.joined_ids(5) == [1]  # the re-registration followed the fence


def test_wait_for_next_epoch(store_server):
    c1 = _client(store_server, 1)

    def bump():
        time.sleep(0.2)
        _client(store_server, 0).open_epoch(4)

    t = threading.Thread(target=bump)
    t.start()
    assert wait_for_next_epoch(c1, 3, timeout_s=3.0, poll_s=0.02) == 4
    t.join()
    with pytest.raises(RendezvousTimeout):
        wait_for_next_epoch(c1, 9, timeout_s=0.3, poll_s=0.05)


# ---------------------------------------------------------------------------
# launcher integration: monitor teardown paths
# ---------------------------------------------------------------------------


class _FakeProc:
    """Popen stand-in: runs forever until killed."""

    def __init__(self, code=None):
        self._code = code
        self.signals = []

    def poll(self):
        return self._code

    def send_signal(self, sig):
        self.signals.append(sig)
        self._code = -int(sig)

    def wait(self, timeout=None):
        return self._code

    def kill(self):
        self._code = -9


def _elastic_args(server, **overrides):
    from bagua_tpu_torch.distributed.run import parse_args

    host, port = server.address
    args = parse_args([
        "--nnodes", "1:4", "--master_addr", host,
        "--restart_coordinator_port", str(port),
        "--monitor_interval", "0.05",
        "--lease_ttl", str(overrides.pop("lease_ttl", 0.5)),
        "x.py",
    ])
    for k, v in overrides.items():
        setattr(args, k, v)
    return args


def test_monitor_elastic_remote_stop_tears_down(store_server):
    from bagua_tpu_torch.distributed.run import _GangStop, monitor_elastic

    args = _elastic_args(store_server, node_rank=1)
    c1 = _client(store_server, 1)
    spec = _spec(store_server, ids=(0, 1))
    procs = [_FakeProc()]
    _client(store_server, 0).publish_stop(0, STOP_FAIL, 0, "worker exit 1")
    with pytest.raises(_GangStop) as e:
        monitor_elastic(args, procs, c1, spec, None, None)
    assert e.value.kind == STOP_FAIL and e.value.node == 0
    assert procs[0].poll() is not None, "local gang must be killed"


def test_monitor_elastic_lease_expiry_triggers_gang_teardown(store_server):
    """A lease that expires mid-attempt kills the local gang, publishes a
    lease_expired stop event (rejoin=False), and surfaces as _GangStop."""
    from bagua_tpu_torch.distributed.run import _GangStop, monitor_elastic

    args = _elastic_args(store_server, node_rank=0, lease_ttl=0.3)
    c0 = _client(store_server, 0)
    spec = _spec(store_server, ids=(0, 1))
    coord = _coordinator(store_server)
    tracker = LeaseTracker(c0, 0, [1], ttl_s=0.3)  # node 1 never beats
    procs = [_FakeProc()]
    with pytest.raises(_GangStop) as e:
        monitor_elastic(args, procs, c0, spec, coord, tracker)
    assert e.value.kind == STOP_LEASE_EXPIRED
    assert e.value.node == 1 and e.value.rejoin is False
    assert procs[0].poll() is not None
    stop = c0.read_stop(0)
    assert stop["kind"] == STOP_LEASE_EXPIRED and stop["rejoin"] is False


def test_monitor_elastic_simultaneous_lease_expiries_exclude_all(store_server):
    """A rack loss expires several leases in one poll: EVERY dead node must
    be named non-rejoining, or the next round waits the full window for
    launchers that are permanently gone."""
    from bagua_tpu_torch.distributed.run import _GangStop, monitor_elastic

    args = _elastic_args(store_server, node_rank=0, lease_ttl=0.3)
    c0 = _client(store_server, 0)
    spec = _spec(store_server, ids=(0, 1, 2))
    coord = _coordinator(store_server)
    tracker = LeaseTracker(c0, 0, [1, 2], ttl_s=0.3)  # neither ever beats
    with pytest.raises(_GangStop) as e:
        monitor_elastic(args, [_FakeProc()], c0, spec, coord, tracker)
    assert e.value.kind == STOP_LEASE_EXPIRED
    assert sorted(e.value.nodes) == [1, 2]
    assert sorted(c0.read_stop(0)["nodes"]) == [1, 2]


def test_monitor_elastic_standby_forces_resize(store_server):
    from bagua_tpu_torch.distributed.run import _GangStop, monitor_elastic

    args = _elastic_args(store_server, node_rank=0, lease_ttl=30.0)
    c0 = _client(store_server, 0)
    spec = _spec(store_server, ids=(0,), max_nnodes=4)
    coord = _coordinator(store_server)
    tracker = LeaseTracker(c0, 0, [], ttl_s=30.0)
    _client(store_server, 3).join(0)  # standby registers mid-attempt
    procs = [_FakeProc()]
    with pytest.raises(_GangStop) as e:
        monitor_elastic(args, procs, c0, spec, coord, tracker)
    assert e.value.kind == STOP_RESIZE and e.value.standby == [3]
    assert c0.read_stop(0)["kind"] == STOP_RESIZE


def test_monitor_elastic_local_failure_publishes_stop(store_server):
    from bagua_tpu_torch.distributed.run import _GangStop, monitor_elastic

    args = _elastic_args(store_server, node_rank=1)
    c1 = _client(store_server, 1)
    spec = _spec(store_server, ids=(0, 1))
    with pytest.raises(_GangStop) as e:
        monitor_elastic(args, [_FakeProc(code=7)], c1, spec, None, None)
    assert e.value.kind == STOP_FAIL and e.value.code == 7
    stop = c1.read_stop(0)
    assert stop["node"] == 1 and "exit 7" in stop["reason"]


def test_monitor_elastic_leave_intent_reclassifies_failure(store_server):
    """A worker that published a leave intent before dying (watchdog exit)
    is reported as a LEAVE, not a crash."""
    from bagua_tpu_torch.distributed.run import _GangStop, monitor_elastic
    from bagua_tpu_torch.elastic.membership import STOP_LEAVE

    args = _elastic_args(store_server, node_rank=1)
    c1 = _client(store_server, 1)
    c1.publish_leave(0, "watchdog: step stuck for 31 s")
    spec = _spec(store_server, ids=(0, 1))
    with pytest.raises(_GangStop) as e:
        monitor_elastic(args, [_FakeProc(code=3)], c1, spec, None, None)
    assert e.value.kind == STOP_LEAVE
    assert "watchdog" in c1.read_stop(0)["reason"]


def test_store_barrier_timeout_raises_clear_message(store_server):
    """Fixed-size restart barrier (non-elastic multi-node path): expiry
    must raise with the prefix, the timeout, and the expected node count —
    not hang or raise something opaque."""
    from bagua_tpu_torch.distributed.run import _store_barrier

    host, port = store_server.address
    store = TCPStore(host, port)
    store.set("restart/ready/0/0", b"1")  # node 1 never arrives
    with pytest.raises(RuntimeError) as e:
        _store_barrier(store, 2, "restart/ready/0", timeout_s=0.3)
    msg = str(e.value)
    assert "restart/ready/0" in msg and "2 nodes" in msg and "timed out" in msg


@pytest.mark.parametrize("error", [TimeoutError, concurrent.futures.TimeoutError],
                         ids=["builtin", "futures"])
def test_restart_store_retries_non_oserror_timeout(store_server, error):
    """_RestartStore._retry refreshes the connection on a timed-out op,
    whichever ``TimeoutError`` class the client raises, and completes the
    SAME op on the fresh connection.  (Both are in ``_STORE_RETRY_ERRORS``:
    on Python 3.11+ they are one class, an ``OSError``; before, the futures
    one was not.)"""
    import bagua_tpu_torch.distributed.run as run_mod

    assert error in run_mod._STORE_RETRY_ERRORS
    args = _elastic_args(store_server)
    rs = run_mod._RestartStore(args, connect_timeout_s=5.0)

    class _FlakyClient:
        def __init__(self):
            self.calls = 0

        def get(self, key):
            self.calls += 1
            raise error("simulated client timeout")

    rs.set("elastic-retry-test", b"v")
    flaky = _FlakyClient()
    rs._client = flaky
    assert rs.get("elastic-retry-test") == b"v"
    assert flaky.calls == 1
    assert rs._client is not flaky, "connection must have been refreshed"


def test_connect_restart_store_failure_chains_cause_and_counts_attempts():
    """When the restart store never comes up, the raised error must carry
    the attempt count and chain the last socket error as __cause__ —
    'Connection refused' alone doesn't say the launcher retried at all."""
    from bagua_tpu_torch.distributed.run import _connect_restart_store
    # a bound-then-released port: connects fail fast with ECONNREFUSED
    dead_port = reserve_port()
    args = SimpleNamespace(master_addr="127.0.0.1",
                           restart_coordinator_port=dead_port)
    with pytest.raises(ConnectionError) as e:
        _connect_restart_store(args, timeout_s=0.5)
    msg = str(e.value)
    assert f"127.0.0.1:{dead_port}" in msg
    assert "attempt" in msg and "last error" in msg
    assert isinstance(e.value.__cause__, OSError)


# ---------------------------------------------------------------------------
# resize hooks
# ---------------------------------------------------------------------------


def test_shard_bounds_balanced_partition():
    for total, world in [(16, 1), (16, 2), (16, 8), (17, 4), (3, 4)]:
        bounds = [shard_bounds(total, r, world) for r in range(world)]
        assert bounds[0][0] == 0 and bounds[-1][1] == total
        sizes = [hi - lo for lo, hi in bounds]
        assert sum(sizes) == total
        assert max(sizes) - min(sizes) <= 1  # balanced
        for (_, a_hi), (b_lo, _) in zip(bounds, bounds[1:]):
            assert a_hi == b_lo  # contiguous, no overlap
    with pytest.raises(ValueError):
        shard_bounds(16, 4, 4)


def test_elastic_context_from_env(monkeypatch):
    for k in ("BAGUA_ELASTIC", "BAGUA_ELASTIC_EPOCH", "BAGUA_ELASTIC_NODE_ID",
              "BAGUA_ELASTIC_STORE_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    ctx = ElasticContext.from_env()
    assert not ctx.enabled and ctx.world_size == 1 and ctx.rank == 0
    monkeypatch.setenv("BAGUA_ELASTIC", "1")
    monkeypatch.setenv("BAGUA_ELASTIC_EPOCH", "4")
    monkeypatch.setenv("BAGUA_ELASTIC_NODE_ID", "2")
    monkeypatch.setenv("BAGUA_ELASTIC_MIN_NNODES", "1")
    monkeypatch.setenv("BAGUA_ELASTIC_MAX_NNODES", "4")
    monkeypatch.setenv("BAGUA_ELASTIC_STORE_ADDR", "10.0.0.1:2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    ctx = ElasticContext.from_env()
    assert ctx.enabled and ctx.epoch == 4 and ctx.node_id == 2
    assert ctx.rank == 1 and ctx.world_size == 2 and ctx.max_nnodes == 4


def test_parse_accepts_elastic_range():
    from bagua_tpu_torch.distributed.run import parse_args

    args = parse_args(["--nnodes", "1:4", "x.py"])
    assert args.elastic and (args.min_nnodes, args.max_nnodes) == (1, 4)
    assert args.max_restarts == 3  # elastic default
    for bad in ("4:2", "0:3", "a:b"):
        with pytest.raises(SystemExit):
            parse_args(["--nnodes", bad, "x.py"])
    with pytest.raises(SystemExit):  # node id outside the slot range
        parse_args(["--nnodes", "1:2", "--node_rank", "5", "x.py"])


def test_telemetry_counters():
    from bagua_tpu_torch.telemetry import TelemetryCounters

    c = TelemetryCounters()
    assert c.get("elastic/resizes") == 0
    c.incr("elastic/resizes")
    c.incr("elastic/resizes", 2)
    c.set_gauge("elastic/world_nnodes", 3)
    assert c.get("elastic/resizes") == 3
    snap = c.snapshot()
    assert snap == {"elastic/resizes": 3, "elastic/world_nnodes": 3}
    c.reset()
    assert c.snapshot() == {}


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ranks", [{0: 0}, {0: 0, 3: 1}, {0: 0, 1: 1, 2: 2, 5: 3}])
def test_world_spec_json_equals_jax(ranks):
    from bagua_tpu.elastic.membership import WorldSpec as JWorldSpec

    kw = dict(epoch=4, ranks=ranks, min_nnodes=1, max_nnodes=8,
              master_addr="10.0.0.1", master_port=29400)
    assert WorldSpec(**kw).to_json() == JWorldSpec(**kw).to_json()
    assert WorldSpec.from_json(JWorldSpec(**kw).to_json()) == WorldSpec(**kw)


@pytest.mark.parametrize("total,world", [(16, 1), (16, 2), (16, 8), (17, 4), (3, 4), (64, 3)])
def test_shard_bounds_equal_jax(total, world):
    from bagua_tpu.elastic.resize import shard_bounds as jshard_bounds

    assert [shard_bounds(total, r, world) for r in range(world)] == \
        [jshard_bounds(total, r, world) for r in range(world)]


@pytest.mark.parametrize("block", [
    {},
    {"BAGUA_ELASTIC": "1", "BAGUA_ELASTIC_EPOCH": "4", "BAGUA_ELASTIC_NODE_ID": "2",
     "BAGUA_ELASTIC_MIN_NNODES": "1", "BAGUA_ELASTIC_MAX_NNODES": "4",
     "BAGUA_ELASTIC_STORE_ADDR": "10.0.0.1:2", "RANK": "1", "WORLD_SIZE": "2"},
    {"NODE_RANK": "3", "RANK": "6", "WORLD_SIZE": "8",
     "BAGUA_RESTART_STORE_ENDPOINTS": "a:1,b:2"},
])
def test_elastic_context_from_env_equals_jax(monkeypatch, block):
    from bagua_tpu.elastic.resize import ElasticContext as JElasticContext

    for k in ("BAGUA_ELASTIC", "BAGUA_ELASTIC_EPOCH", "BAGUA_ELASTIC_NODE_ID",
              "BAGUA_ELASTIC_STORE_ADDR", "BAGUA_ELASTIC_MIN_NNODES",
              "BAGUA_ELASTIC_MAX_NNODES", "BAGUA_RESTART_STORE_ENDPOINTS", "NODE_RANK",
              "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in block.items():
        monkeypatch.setenv(k, v)
    assert ElasticContext.from_env().__dict__ == JElasticContext.from_env().__dict__


# ---------------------------------------------------------------------------
# the port's own: a lost node named when the survivor's worker fails first
# ---------------------------------------------------------------------------


def test_monitor_elastic_local_failure_names_lost_member(store_server):
    """A gloo survivor's worker fails at its next collective as soon as its
    peer dies, before the peer's lease expires: the coordinator waits for
    the leases and reports the lost node (``lease_expired``, not
    rejoining), not a crash of its own worker."""
    from bagua_tpu_torch.distributed.run import _GangStop, monitor_elastic

    args = _elastic_args(store_server, node_rank=0, lease_ttl=0.4)
    c0 = _client(store_server, 0)
    spec = _spec(store_server, ids=(0, 1))
    tracker = LeaseTracker(c0, 0, [1], ttl_s=0.4)   # node 1 never beats
    with pytest.raises(_GangStop) as e:
        monitor_elastic(args, [_FakeProc(code=1)], c0, spec, _coordinator(store_server),
                        tracker)
    assert e.value.kind == STOP_LEASE_EXPIRED and e.value.nodes == [1]
    assert e.value.rejoin is False and e.value.code == 1
    assert c0.read_stop(0)["kind"] == STOP_LEASE_EXPIRED


def test_monitor_elastic_local_failure_with_live_members_is_a_failure(store_server):
    from bagua_tpu_torch.distributed.run import _GangStop, monitor_elastic

    host, port = store_server.address
    args = _elastic_args(store_server, node_rank=0, lease_ttl=5.0)
    c0 = _client(store_server, 0)
    spec = _spec(store_server, ids=(0, 1))
    hb = LeaseHeartbeat(lambda: TCPStore(host, port), node_id=1, epoch=0,
                        interval_s=0.05, max_nnodes=4).start()
    try:
        tracker = LeaseTracker(c0, 0, [1], ttl_s=5.0)
        t0 = time.monotonic()
        with pytest.raises(_GangStop) as e:
            monitor_elastic(args, [_FakeProc(code=7)], c0, spec,
                            _coordinator(store_server), tracker)
        assert time.monotonic() - t0 < 3.0, "a live member must not cost the lease TTL"
    finally:
        hb.stop()
    assert e.value.kind == STOP_FAIL and e.value.code == 7 and e.value.rejoin is True


@pytest.mark.parametrize("case", ["silent", "beating", "deadline"])
def test_lease_tracker_wait_for_loss(store_server, case):
    """``LeaseTracker.wait_for_loss``: a silent member's lease expires
    within its TTL and is named; a beating member ends the wait at its next
    beat with ``[]``; a silent member whose TTL outlasts the wait's bound
    gives ``[]`` at the bound."""
    host, port = store_server.address
    c0 = _client(store_server, 0)
    hb = None
    if case == "beating":
        hb = LeaseHeartbeat(lambda: TCPStore(host, port), node_id=1, epoch=0,
                            interval_s=0.05, max_nnodes=4).start()
    try:
        tracker = LeaseTracker(c0, 0, [1], ttl_s=5.0 if case != "silent" else 0.3)
        t0 = time.monotonic()
        lost = tracker.wait_for_loss(timeout_s=0.6 if case == "deadline" else 10.0, poll_s=0.02)
        waited = time.monotonic() - t0
    finally:
        if hb is not None:
            hb.stop()
    assert lost == ([1] if case == "silent" else [])
    assert waited < {"silent": 3.0, "beating": 3.0, "deadline": 2.0}[case]
    if case == "deadline":
        assert waited >= 0.6


def test_elastic_restore_empty_dir_and_saved_step(tmp_path):
    import numpy as np
    import torch

    import bagua_tpu_torch as bt
    from bagua_tpu_torch.elastic import elastic_restore
    from bagua_tpu_torch.models.mlp import MLP

    bt.init_process_group(device="cpu")

    def make():
        tr = bt.BaguaTrainer(lambda m, b: torch.nn.functional.cross_entropy(m(b["x"]), b["y"]),
                             lambda p: torch.optim.SGD(p, lr=0.1),
                             bt.GradientAllReduceAlgorithm(), device="cpu", bucket_bytes=256)
        return tr, tr.init(MLP(4, features=(8, 4), device="cpu", seed=1))

    rng = np.random.default_rng(0)
    batch = {"x": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)),
             "y": torch.from_numpy(rng.integers(0, 4, size=8))}
    mgr = bt.BaguaCheckpointManager(str(tmp_path / "ck"), async_save=False)
    tr, state = make()
    assert elastic_restore(mgr, state, trainer=tr) == (None, state)
    for _ in range(3):
        state, _ = tr.train_step(state, batch)
    tr.save_checkpoint(mgr, 3, state)
    tr2, state2 = make()
    step, state2 = elastic_restore(mgr, state2, trainer=tr2)
    assert step == 3 and state2.step == 3
    for a, b in zip(state.model.parameters(), state2.model.parameters()):
        assert torch.equal(a, b)
    step, tree = elastic_restore(bt.BaguaCheckpointManager(str(tmp_path / "ck")), None)
    assert step == 3
