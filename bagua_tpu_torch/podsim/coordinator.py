"""Killable coordinator process for the pod simulator.

Port of ``bagua_tpu/podsim/coordinator.py``.
:class:`~bagua_tpu_torch.podsim.orchestrator.PodSim` runs the coordinator
stack *in-process*, which suits measuring the control plane but makes the
coordinator unkillable; the failover drill SIGKILLs the coordinator
mid-training and watches a standby take over, so this module is the same
stack as a real OS process.  Executed as a *file* (``python
.../podsim/coordinator.py``) with the torch-free bootstrap of
:mod:`~bagua_tpu_torch.podsim.worker`.

Roles (``--coord-id`` indexes ``--store-endpoints``):

* coord-id 0 — boots as the store **primary** and the acting coordinator:
  hosts its :class:`TCPStoreServer` endpoint (recovering replicated state
  from peers on relaunch, and starting demoted if a takeover already
  moved the primary role), runs rendezvous rounds, polls member leases,
  ingests fleet records into the historian, feeds the autopilot engine,
  and renews the ``coord/lease`` leadership lease.
* coord-id >= 1 — boots as a **standby**: hosts a replication-follower
  store server and a :class:`StandbyCoordinatorWatch`; when the lease
  goes stale it promotes its store (generation fence) and then runs the
  SAME coordinator loop — the historian rings and autopilot policy state
  load from the replicated store, so trend windows and cooldowns RESUME.

Drill observability rides the store itself:

* ``coord/lease`` — who is coordinator NOW (node, seq, generation);
* ``podsim/coord/status`` — JSON heartbeat of the ACTING coordinator:
  role, epoch, tick count, store generation, historian series (total and
  loaded-at-construction), autopilot rung / actions_taken / resumed flag.
  The generation fence keeps a demoted ex-primary's status writes from
  ever reaching the group.

Exit codes: 0 halt, 5 demoted (an ex-primary observed the generation
fence after a partition — the double-primary row of the failure matrix),
3 error.
"""

import sys

if __package__ in (None, ""):  # pragma: no cover - subprocess entry
    import os

    import _bootstrap

    _bootstrap.install(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import argparse  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import time  # noqa: E402

from bagua_tpu_torch.autopilot.engine import (  # noqa: E402
    STATE_STORE_KEY,
    AutopilotEngine,
)
from bagua_tpu_torch.autopilot.policy import PolicyConfig  # noqa: E402
from bagua_tpu_torch.contrib.utils.tcp_store import TCPStoreServer  # noqa: E402
from bagua_tpu_torch.elastic import membership as mb  # noqa: E402
from bagua_tpu_torch.elastic.coordinator import ElasticCoordinator  # noqa: E402
from bagua_tpu_torch.elastic.failover import (  # noqa: E402
    CoordinatorLeaseKeeper,
    FailoverStore,
    StandbyCoordinatorWatch,
    parse_endpoints,
    read_coord_lease,
)
from bagua_tpu_torch.obs.export import build_fleet_record  # noqa: E402
from bagua_tpu_torch.obs.historian import Historian  # noqa: E402

logger = logging.getLogger("podsim.coordinator")

STATUS_KEY = "podsim/coord/status"

#: exit code when an ex-primary observes the generation fence
EXIT_DEMOTED = 5


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--store-endpoints", required=True,
                    help="comma-separated host:port replica group "
                         "(priority order; index 0 is the boot primary)")
    ap.add_argument("--coord-id", type=int, required=True,
                    help="this process's index into --store-endpoints")
    ap.add_argument("--world", type=int, required=True,
                    help="max worker nodes (worker ids 0..world-1)")
    ap.add_argument("--min-nnodes", type=int, default=1)
    ap.add_argument("--join-window", type=float, default=30.0)
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--lease-ttl", type=float, default=4.0,
                    help="member lease TTL (the worker heartbeats)")
    ap.add_argument("--coord-lease-ttl", type=float, default=2.0,
                    help="coordinator leadership lease TTL")
    ap.add_argument("--takeover-grace", type=float, default=0.0,
                    help="member-lease grace after takeover "
                         "(0 = 2x --lease-ttl)")
    ap.add_argument("--tick", type=float, default=0.25)
    return ap.parse_args(argv)


def _endpoints(args):
    return parse_endpoints(
        [e.strip() for e in args.store_endpoints.split(",") if e.strip()])


def _write_status(store, payload: dict) -> None:
    try:
        store.set(STATUS_KEY, json.dumps(payload))
    except ConnectionError as e:
        # a fenced/unreachable status write is itself a signal the monitor
        # loop will act on (server demotion check) — never die over it
        logger.debug("status not written: %s", e)


def _still_leader(server, store, coord_id: int) -> bool:
    """Whether this coordinator may still act: its store server is primary
    and the leadership lease, read through the replica group, is its own."""
    if not server.is_primary:
        return False
    try:
        lease = read_coord_lease(store)
    except ConnectionError:
        return False
    return lease is None or lease.get("node") == coord_id


def run_coordinator(args, server, store, *, takeover: bool) -> int:
    """The acting-coordinator loop: rendezvous rounds + lease tracking +
    historian/autopilot ingestion, until halt (0) or demotion (5).  On a
    ``takeover`` the current epoch's published world is ADOPTED (the
    fleet keeps training; nobody restarts) and the member leases are
    re-armed with the takeover grace window."""
    client = mb.MembershipClient(store, 0, args.world)
    endpoints = _endpoints(args)
    coord = ElasticCoordinator(
        client, args.min_nnodes, args.world,
        master_addr=endpoints[0][0], master_port=endpoints[0][1],
        join_window_s=args.join_window, timeout_s=args.timeout,
    )
    # state-resume proof: capture what the replicated store carried BEFORE
    # this process's own engine/historian start writing
    autopilot_resumed = store.get(STATE_STORE_KEY) is not None
    engine = AutopilotEngine(
        config=PolicyConfig(mode="observe", sustain=2, cooldown_s=0.0,
                            budget=8, staleness_s=60.0, suspect_ttl_s=30.0),
        store=store,
    )
    historian = Historian(capacity=2048, window_s=120.0, store=store)
    loaded_series = len(historian.metrics())
    grace = args.takeover_grace or 2.0 * args.lease_ttl
    role = "promoted" if takeover else "primary"
    logger.info("acting coordinator (%s): autopilot_resumed=%s, "
                "historian loaded %d series", role, autopilot_resumed,
                loaded_series)

    epoch = 0
    expect = None
    spec = None
    ticks = 0
    if takeover:
        # mid-epoch takeover: adopt the published world instead of forcing
        # a rendezvous — the whole point is that healthy workers never
        # notice the coordinator changed
        cur = client.current_epoch()
        if cur is not None:
            epoch = cur
            spec = client.read_world(cur)
    while True:
        if spec is None:
            spec = coord.run_round(epoch, expect=expect)
        tracker = mb.LeaseTracker(
            client, spec.epoch, sorted(spec.ranks), ttl_s=args.lease_ttl)
        if takeover:
            tracker.rearm(grace)
            takeover = False
        logger.info("monitoring epoch %d (%d nodes)", spec.epoch,
                    spec.nnodes)
        while True:
            if not _still_leader(server, store, args.coord_id):
                # generation fence observed, or the lease moved on: a
                # standby promoted while we were partitioned/paused (our
                # client may already write to it, our server never hearing
                # of the fence) — stand down
                logger.warning(
                    "this coordinator was demoted (store generation moved "
                    "on); exiting as the fenced ex-primary")
                return EXIT_DEMOTED
            expired = tracker.poll()
            record = build_fleet_record(
                spec.epoch,
                {n: tracker.health_of(n) for n in sorted(spec.ranks)},
            )
            historian.ingest(record)
            engine.observe_snapshot(record)
            ticks += 1
            if ticks % 4 == 0:
                # keep the replicated policy/trend state fresh even when
                # no action fires — what a takeover must be able to resume
                engine._persist_state()
            _write_status(store, {
                "node": args.coord_id, "role": role,
                "generation": server.generation,
                "epoch": spec.epoch, "ticks": ticks,
                "historian_series": len(historian.metrics()),
                "historian_loaded_series": loaded_series,
                "autopilot_resumed": autopilot_resumed,
                "autopilot_rung": engine.state.rung,
                "autopilot_actions_taken": engine.state.actions_taken,
                "time_unix": time.time(),
            })
            if expired and not _still_leader(server, store, args.coord_id):
                # a thawed ex-primary sees every lease stale on its own
                # clock; the status write above met the generation fence
                # (or the lease moved on): stand down before publishing a
                # stop that its failed-over client would carry to the new
                # primary
                logger.warning(
                    "this coordinator was demoted before acting on %s's "
                    "expiry; exiting as the fenced ex-primary", expired)
                return EXIT_DEMOTED
            if expired:
                reason = (f"no heartbeat for {args.lease_ttl:.1f}s "
                          f"(node(s) {expired})")
                client.publish_stop(
                    spec.epoch, mb.STOP_LEASE_EXPIRED, expired[0],
                    reason, rejoin=False, nodes=expired,
                )
                expect = set(spec.ranks) - set(expired)
                epoch = spec.epoch + 1
                spec = None
                logger.warning("%s; regrouping as epoch %d", reason, epoch)
                break
            if client.read_halt() is not None:
                logger.info("halt verdict read; coordinator exiting")
                # the store's primary lives in this process: serve it one
                # lease TTL more, so that every member reads the verdict
                # before the store goes away
                time.sleep(args.lease_ttl)
                return 0
            time.sleep(args.tick)


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    args = parse_args(argv)
    endpoints = _endpoints(args)
    if not 0 <= args.coord_id < len(endpoints):
        print(f"--coord-id {args.coord_id} outside endpoint list",
              flush=True)
        return 2
    host, port = endpoints[args.coord_id]
    server = TCPStoreServer(
        host, port,
        peers=[e for i, e in enumerate(endpoints) if i != args.coord_id],
        role="primary" if args.coord_id == 0 else "standby",
    )
    store = FailoverStore(endpoints, connect_timeout_s=args.timeout)
    keeper = None
    watch = None
    try:
        # boot leadership: index 0 acts unless a takeover already moved
        # the primary role (peer recovery starts a relaunched 0 demoted)
        if args.coord_id == 0 and server.is_primary:
            keeper = CoordinatorLeaseKeeper(
                lambda: FailoverStore(endpoints, connect_timeout_s=10.0),
                args.coord_id, args.coord_lease_ttl,
                generation=server.generation,
            ).start()
            return run_coordinator(args, server, store, takeover=False)
        watch = StandbyCoordinatorWatch(
            FailoverStore(endpoints, connect_timeout_s=args.timeout),
            args.coord_id, args.coord_id, args.coord_lease_ttl,
        ).start()
        client = mb.MembershipClient(store, 0, args.world)
        logger.info("standby coordinator %d watching the leadership lease",
                    args.coord_id)
        while True:
            if watch.promoted:
                keeper = CoordinatorLeaseKeeper(
                    lambda: FailoverStore(endpoints, connect_timeout_s=10.0),
                    args.coord_id, args.coord_lease_ttl,
                    generation=watch.store.generation,
                ).start()
                return run_coordinator(args, server, store, takeover=True)
            try:
                if client.read_halt() is not None:
                    return 0
            except ConnectionError:
                pass  # group unreachable: the watch holds its clock too
            time.sleep(0.25)
    finally:
        if keeper is not None:
            keeper.stop()
        if watch is not None:
            watch.stop()
        store.close()
        server.stop()


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 - drill log must carry the cause
        import traceback

        traceback.print_exc()
        sys.exit(3)
