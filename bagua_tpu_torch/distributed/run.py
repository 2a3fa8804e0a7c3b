"""Process launcher with gang restart.

Port of ``bagua_tpu/distributed/run.py``, the counterpart of the reference's
``bagua.distributed.run`` (a torchelastic wrapper: Bagua flags and env
injection, ``elastic_launch`` with gang-restart semantics).  The command line
is the JAX launcher's (``python -m bagua_tpu_torch.distributed.run``, the
console script ``bagua-tpu-torch-run``).

Each worker gets the standard env protocol (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``NODE_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``, and ``BAGUA_COORDINATOR_ADDR`` above world 1), from which
:func:`bagua_tpu_torch.init_process_group` joins the rendezvous
(``tcp://MASTER_ADDR:MASTER_PORT``, hosted by rank 0).  The launcher picks no
device: the training script chooses its own through
``init_process_group(device=...)``, where an index-less ``cuda`` means
``cuda:<LOCAL_RANK>`` (so several local ranks on one card pass ``cuda:0``
and ``backend="gloo"``; NCCL refuses two ranks on one device).
``--simulate_cpu_devices``, which sets the JAX package's CPU simulation, is
accepted and ignored.

Gang semantics, as in the JAX package: ANY worker failure kills the whole
gang, which restarts up to ``--max_restarts`` times, and the workers resume
from the latest checkpoint.  Every attempt binds the same ``MASTER_PORT``:
the dead gang's rendezvous store died with its rank 0.  Multi-node fixed-size
jobs coordinate through a KV store that node 0 hosts on
``--restart_coordinator_port``: a node observing a local failure publishes a
per-attempt failure flag; every launcher polls it, kills its own gang, joins
a per-attempt ready barrier and respawns together.  Elastic jobs (``--nnodes
MIN:MAX``) replace the barrier with the membership subsystem
(:mod:`bagua_tpu_torch.elastic`): lease heartbeats detect silently lost
nodes, standby joins force coordinated resizes at the restart boundary, and
epoch-fenced keys keep zombies of an earlier attempt out of the current one.

The coordinator writes the fleet snapshot (``BAGUA_OBS_FLEET_OUT``, every
member's heartbeat health payload merged into one ``bagua-obs-fleet-v1``
record), the fence paths leave ``health_fence`` flight records, and every
rendezvous round is an ``elastic/rendezvous`` span.  What waits for the
port's fleet and control plane is refused by name rather than silently
skipped: ``BAGUA_AUTOPILOT`` other than ``off``, ``BAGUA_OBS_HTTP_PORT`` and
``BAGUA_OBS_HISTORIAN`` (:func:`refuse_missing_modules`).
"""

from __future__ import annotations

import argparse
import concurrent.futures as _futures
import logging
import os
import signal
import subprocess
import sys
import time
from typing import List, Optional

from .. import env as _env

logger = logging.getLogger("bagua_tpu_torch.launcher")

# Errors that mean "this store connection is dead, get a new one".
# TimeoutError needs BOTH spellings: the builtin (an OSError subclass
# since 3.10) and futures-style timeouts, which store clients can raise
# as a NON-OSError class on older interpreters — a timed-out socket is
# as dead as a reset one either way.
_STORE_RETRY_ERRORS = (
    ConnectionError, OSError, TimeoutError, _futures.TimeoutError,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        "python -m bagua_tpu_torch.distributed.run",
        description="bagua_tpu_torch launcher (reference: bagua.distributed.run)",
    )
    p.add_argument("--nnodes", type=str, default="1",
                   help="number of nodes: a fixed count, or MIN:MAX for "
                        "elastic mode — each restart attempt renegotiates "
                        "the world size to whoever rejoins within the join "
                        "window (resizing happens at restart boundaries)")
    p.add_argument("--node_rank", type=int, default=0)
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="worker processes per node (default 1)")
    p.add_argument("--master_addr", type=str, default="127.0.0.1")
    p.add_argument("--master_port", type=int, default=29400)
    p.add_argument("--max_restarts", type=int, default=None,
                   help="gang restarts after a worker failure (default 3 "
                        "single-node, 0 multi-node; multi-node restarts are "
                        "coordinated through the restart KV store)")
    p.add_argument("--monitor_interval", type=float, default=1.0)
    p.add_argument("--restart_coordinator_port", type=int, default=None,
                   help="KV-store port for coordinated multi-node restarts "
                        "(default master_port + 1; node 0 hosts it)")
    p.add_argument("--restart_barrier_timeout", type=float, default=300.0,
                   help="seconds to wait for every node at a restart barrier "
                        "(elastic mode: rendezvous-round timeout)")
    p.add_argument("--join_window", type=float, default=None,
                   help="elastic: seconds a rendezvous round stays open for "
                        "nodes to (re)register (default "
                        "$BAGUA_ELASTIC_JOIN_WINDOW_S or 30); rounds close "
                        "early when every expected survivor is back")
    p.add_argument("--lease_ttl", type=float, default=None,
                   help="elastic: seconds without a heartbeat before a "
                        "node's lease expires and the gang regroups without "
                        "it (default $BAGUA_ELASTIC_LEASE_TTL_S or 15)")
    # Bagua flags (reference run.py:360-398)
    p.add_argument("--bagua_service_port", type=int, default=29500)
    p.add_argument("--default_bucket_size", type=int, default=10 * 1024 ** 2)
    p.add_argument("--autotune_level", type=int, default=0)
    p.add_argument("--autotune_max_samples", type=int, default=60)
    p.add_argument("--autotune_sampling_confidence_time", type=float, default=5.0)
    p.add_argument("--autotune_warmup_time", type=float, default=30.0)
    p.add_argument("--is_output_autotune_log", action="store_true")
    p.add_argument("--autotune_algorithm", action="store_true",
                   help="let the autotuner search over algorithm families")
    p.add_argument("--simulate_cpu_devices", type=int, default=0,
                   help="the JAX launcher's CPU simulation: accepted and "
                        "ignored (the training script picks its device)")
    p.add_argument("--no_python", action="store_true",
                   help="run training_script directly instead of "
                        "`python training_script`")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    if args.simulate_cpu_devices:
        logger.info("--simulate_cpu_devices %d ignored: the training script picks its "
                    "device (init_process_group(device=...))", args.simulate_cpu_devices)
    if ":" in args.nnodes:
        lo, _, hi = args.nnodes.partition(":")
        try:
            args.min_nnodes, args.max_nnodes = int(lo), int(hi)
        except ValueError:
            p.error(f"--nnodes {args.nnodes!r}: expected N or MIN:MAX")
        if not 1 <= args.min_nnodes <= args.max_nnodes:
            p.error(f"--nnodes {args.nnodes!r}: need 1 <= MIN <= MAX")
        args.elastic = True
        args.nnodes_int = args.max_nnodes
        if not 0 <= args.node_rank < args.max_nnodes:
            p.error(f"--node_rank {args.node_rank} outside elastic id range "
                    f"[0, {args.max_nnodes}) — in elastic mode --node_rank "
                    "is the node's stable identity slot")
    else:
        args.elastic = False
        args.nnodes_int = int(args.nnodes)
        args.min_nnodes = args.max_nnodes = args.nnodes_int
    if args.join_window is None:
        args.join_window = _env.get_elastic_join_window_s()
    if args.lease_ttl is None:
        args.lease_ttl = _env.get_elastic_lease_ttl_s()
    if args.max_restarts is None:
        # multi-node fixed-size default stays 0: coordinated restart
        # requires every node's launcher to use the same max_restarts > 0.
        # Elastic mode IS the coordinated protocol, so it defaults on.
        args.max_restarts = 3 if (args.nnodes_int == 1 or args.elastic) else 0
    if args.restart_coordinator_port is None:
        args.restart_coordinator_port = args.master_port + 1
    return args


def _health_beacon_path(args, local_rank: Optional[int] = None) -> str:
    """Health beacon file: keyed by the restart-store port (one job) and
    the stable node id, so concurrent jobs on one host cannot cross-read
    each other's beacons.  One file PER local rank (``local_rank`` set):
    every worker writes only its own snapshot, so a shared file would be
    last-writer-wins and hide all but one worker's events from the fence;
    the heartbeat merges them via ``merged_health_source``."""
    import tempfile

    base = os.path.join(
        tempfile.gettempdir(),
        f"bagua_health_{args.restart_coordinator_port}_{args.node_rank}.json",
    )
    return base if local_rank is None else f"{base}.r{local_rank}"


def _health_beacon_paths(args) -> List[str]:
    """Every local worker's beacon file for this node."""
    return [
        _health_beacon_path(args, i) for i in range(args.nproc_per_node)
    ]


def build_env(args, local_rank: int, spec=None,
              quarantined_ckpt_paths=None) -> dict:
    """Reference ``set_bagua_env`` (run.py:578-600) + rendezvous env.

    ``spec`` (elastic mode): the round's renegotiated
    :class:`~bagua_tpu_torch.elastic.membership.WorldSpec` — world size and this
    node's DENSE rank come from it instead of the fixed ``--nnodes`` /
    ``--node_rank``, and the ``BAGUA_ELASTIC_*`` block is injected so
    workers (and the watchdog's leave-intent path) can reach the
    membership registry."""
    env = dict(os.environ)
    if spec is None:
        nnodes, node_rank = args.nnodes_int, args.node_rank
    else:
        nnodes, node_rank = spec.nnodes, spec.rank_of(args.node_rank)
    world_size = nnodes * args.nproc_per_node
    rank = node_rank * args.nproc_per_node + local_rank
    env.update(
        RANK=str(rank),
        WORLD_SIZE=str(world_size),
        LOCAL_RANK=str(local_rank),
        LOCAL_WORLD_SIZE=str(args.nproc_per_node),
        NODE_RANK=str(node_rank),
        MASTER_ADDR=args.master_addr,
        MASTER_PORT=str(args.master_port),
        BAGUA_SERVICE_PORT=str(args.bagua_service_port),
        BAGUA_DEFAULT_BUCKET_SIZE=str(args.default_bucket_size),
        BAGUA_AUTOTUNE=str(args.autotune_level),
        BAGUA_AUTOTUNE_MAX_SAMPLES=str(args.autotune_max_samples),
        BAGUA_AUTOTUNE_SAMPLING_CONFIDENCE_TIME_S=str(
            args.autotune_sampling_confidence_time),
        BAGUA_AUTOTUNE_WARMUP_TIME_S=str(args.autotune_warmup_time),
        BAGUA_IS_OUTPUT_AUTOTUNE_LOG=str(int(args.is_output_autotune_log)),
        BAGUA_AUTOTUNE_ALGORITHM=str(int(args.autotune_algorithm)),
        AUTO_TUNE_SERVER_ADDR=f"{args.master_addr}:{args.bagua_service_port}",
    )
    # Workers must inherit the launcher's import environment: the spawned
    # `python training_script` has the *script's* directory as sys.path[0],
    # so an un-installed bagua_tpu_torch (or the user's own modules in cwd)
    # would not be importable.  torchelastic effectively does the same.
    pkg_parent = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    extra_paths = [os.getcwd(), pkg_parent]
    prev = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = os.pathsep.join(
        dict.fromkeys(p for p in extra_paths + prev.split(os.pathsep) if p)
    )
    if world_size > 1:
        env["BAGUA_COORDINATOR_ADDR"] = f"{args.master_addr}:{args.master_port}"
    else:
        # an elastic world renegotiated down to ONE node must not inherit a
        # stale coordinator address and wait for peers that are not coming
        env.pop("BAGUA_COORDINATOR_ADDR", None)
    if spec is not None:
        env.update(
            BAGUA_ELASTIC="1",
            BAGUA_ELASTIC_EPOCH=str(spec.epoch),
            BAGUA_ELASTIC_NODE_ID=str(args.node_rank),
            BAGUA_ELASTIC_STORE_ADDR=(
                f"{args.master_addr}:{args.restart_coordinator_port}"),
            BAGUA_ELASTIC_MIN_NNODES=str(spec.min_nnodes),
            BAGUA_ELASTIC_MAX_NNODES=str(spec.max_nnodes),
            # worker->launcher health channel: the trainer's grad-guard /
            # async-staleness events land in this worker's own beacon
            # file, and the launcher's lease heartbeat merges all local
            # beacons and carries them to the coordinator
            BAGUA_ELASTIC_HEALTH_FILE=_health_beacon_path(args, local_rank),
        )
    if quarantined_ckpt_paths:
        # storage-quarantine verdicts reach respawned workers at the
        # restart boundary: their checkpoint managers seed the quarantine
        # registry from this variable and redirect saves (the JAX package's
        # autopilot is the caller that has verdicts).
        # Newline-separated — os.pathsep would split gs:// URIs apart
        env["BAGUA_CKPT_QUARANTINED_PATHS"] = "\n".join(
            str(p) for p in quarantined_ckpt_paths
        )
    # the JAX launcher's HTTP port offsets and CPU-simulation XLA flags have
    # no counterpart here: the HTTP plane is refused, and no launcher path
    # picks or remaps a device
    return env


def spawn_gang(args, spec=None,
               quarantined_ckpt_paths=None) -> List[subprocess.Popen]:
    cmd_prefix = [] if args.no_python else [sys.executable, "-u"]
    procs = []
    for local_rank in range(args.nproc_per_node):
        cmd = cmd_prefix + [args.training_script] + args.training_script_args
        procs.append(
            subprocess.Popen(cmd, env=build_env(
                args, local_rank, spec,
                quarantined_ckpt_paths=quarantined_ckpt_paths,
            ))
        )
    return procs


def kill_gang(procs: List[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.time() + 10
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def monitor(args, procs: List[subprocess.Popen]) -> int:
    """Return exit code when all succeed; raise ``_GangFailure`` on any
    worker failure (reference gang semantics run.py:116-129)."""
    while True:
        codes = [p.poll() for p in procs]
        failed = [c for c in codes if c not in (None, 0)]
        if failed:
            kill_gang(procs)
            raise _GangFailure(failed[0])
        if all(c == 0 for c in codes):
            return 0
        time.sleep(args.monitor_interval)


class _GangFailure(Exception):
    def __init__(self, code: int):
        super().__init__(f"worker failed with exit code {code}")
        self.code = code


def _store_endpoints(args):
    """Replicated restart-store endpoint list, or ``None`` (single-store
    mode).  ``BAGUA_RESTART_STORE_ENDPOINTS`` (comma-separated host:port,
    priority order — the boot primary first, standby replicas after) turns
    the restart KV store into a replicated group with client failover and
    standby-coordinator takeover.  Unset, every code
    path below is the unchanged single-store launcher."""
    endpoints = _env.get_restart_store_endpoints()
    if not endpoints:
        return None
    from ..elastic.failover import parse_endpoints

    return parse_endpoints(endpoints)


def _connect_restart_store(args, timeout_s: float = 60.0):
    """Client to node 0's restart KV store, with connect retries (peers may
    start before the server is up).  Retries use jittered exponential
    backoff: after a gang restart every node reconnects at the same
    instant, and a fixed-interval poll keeps them in lockstep hammering
    node 0's accept queue — the jitter de-synchronizes the herd and the
    exponential cap bounds the total load.

    With ``BAGUA_RESTART_STORE_ENDPOINTS`` set this returns a
    :class:`~bagua_tpu_torch.elastic.failover.FailoverStore` over the replica
    group instead — same op surface, but ops survive the primary dying."""
    import random

    from ..contrib.utils.tcp_store import TCPStore

    endpoints = _store_endpoints(args)
    if endpoints is not None:
        from ..elastic.failover import FailoverStore

        return FailoverStore(endpoints, connect_timeout_s=timeout_s)

    deadline = time.time() + timeout_s
    delay = 0.1
    attempts = 0
    while True:
        try:
            client = TCPStore(args.master_addr,
                              args.restart_coordinator_port,
                              timeout_s=timeout_s)
            if attempts:
                logger.info(
                    "restart store %s:%d reachable after %d retry(ies)",
                    args.master_addr, args.restart_coordinator_port,
                    attempts,
                )
            return client
        except OSError as e:
            attempts += 1
            remaining = deadline - time.time()
            if remaining <= 0:
                # surface the whole story, not just the LAST socket error:
                # how long we tried and how often, with the final failure
                # chained as __cause__ (ECONNREFUSED = server never came
                # up; EHOSTUNREACH = wrong --master-addr; ...)
                raise ConnectionError(
                    f"restart store {args.master_addr}:"
                    f"{args.restart_coordinator_port} unreachable after "
                    f"{attempts} attempt(s) over {timeout_s:.0f}s "
                    f"(last error: {type(e).__name__}: {e})"
                ) from e
            time.sleep(min(delay * (0.5 + random.random()), remaining))
            delay = min(delay * 2, 5.0)


def _store_connect_factory(args):
    """Connection factory for background store threads (lease keeper,
    heartbeats): each thread opens its OWN client — one connection per
    thread, never a socket shared across threads."""
    return lambda: _connect_restart_store(args, timeout_s=10.0)


class _RestartStore:
    """Reconnecting client: a transient socket error (timeout, reset) must
    not permanently blind a node to remote failures — each op retries once
    on a fresh connection before giving up, logging which op it retried.

    In replicated mode (``BAGUA_RESTART_STORE_ENDPOINTS``) the client is a
    :class:`~bagua_tpu_torch.elastic.failover.FailoverStore`, which already owns
    retry, endpoint failover, the per-op deadline budget and the chaos
    hooks — the retry-once wrapper would double-fire the ``store.op``
    fault point, so ops pass straight through."""

    def __init__(self, args, connect_timeout_s: float = 60.0):
        self._args = args
        self._failover = _store_endpoints(args) is not None
        self._client = _connect_restart_store(args, connect_timeout_s)

    @property
    def generation(self) -> int:
        """Store generation the client last observed (0 single-store)."""
        return getattr(self._client, "generation", 0)

    def _retry(self, opname, op):
        from ..faults import inject as _inject

        if self._failover:
            return op(self._client)
        try:
            _inject.maybe_raise_store_error(opname)  # chaos: store.op flake
            return op(self._client)
        except _STORE_RETRY_ERRORS as e:
            logger.warning(
                "restart store %s failed (%s: %s); retrying on a fresh "
                "connection", opname, type(e).__name__, e,
            )
            self._client = _connect_restart_store(self._args, timeout_s=5.0)
            result = op(self._client)
            if isinstance(e, _inject.InjectedFault):
                _inject.record_recovery("store.op")
            return result

    def set(self, key, value):
        return self._retry(f"set({key!r})", lambda c: c.set(key, value))

    def get(self, key):
        return self._retry(f"get({key!r})", lambda c: c.get(key))

    def mget(self, keys):
        return self._retry(f"mget[{len(keys)}]", lambda c: c.mget(keys))


def _store_barrier(store, nnodes: int, prefix: str, timeout_s: float,
                   poll_s: float = 0.2) -> None:
    deadline = time.time() + timeout_s
    keys = [f"{prefix}/{r}" for r in range(nnodes)]
    while True:
        if all(v is not None for v in store.mget(keys)):
            return
        if time.time() > deadline:
            raise RuntimeError(
                f"restart barrier {prefix!r} timed out after {timeout_s:.0f}s "
                f"waiting for {nnodes} nodes"
            )
        time.sleep(poll_s)


def monitor_multinode(args, procs, store, attempt: int) -> int:
    """Like :func:`monitor`, but a failure ANYWHERE in the job surfaces
    here: local failures are published to the per-attempt fail flag, and
    the flag is polled so remote failures kill this node's gang too."""
    fail_key = f"restart/fail/{attempt}"
    store_down_since = None
    while True:
        codes = [p.poll() for p in procs]
        failed = [c for c in codes if c not in (None, 0)]
        if failed:
            logger.warning("local worker failed (exit %d); publishing "
                           "fail flag for attempt %d", failed[0], attempt)
            try:
                store.set(fail_key, str(args.node_rank))
            except (ConnectionError, OSError):
                logger.warning("restart store unreachable while publishing")
            kill_gang(procs)
            raise _GangFailure(failed[0])
        remote = None
        # poll remote failures; after repeated store loss back off to one
        # probe per 30 s (the coordinator store is gone when node 0
        # finished or died — a wedge here still dies via the worker
        # watchdog -> local failure path)
        if (
            store_down_since is None
            or time.time() - store_down_since > 30.0
        ):
            try:
                remote = store.get(fail_key)
                if store_down_since is not None:
                    logger.info("restart store reachable again")
                store_down_since = None
            except (ConnectionError, OSError):
                if store_down_since is None:
                    logger.warning("restart store unreachable; monitoring "
                                   "locally (reprobe every 30 s)")
                store_down_since = time.time()
        if remote is not None:
            logger.warning("node %s reported failure; killing local gang",
                           remote.decode())
            kill_gang(procs)
            raise _GangFailure(1)
        if all(c == 0 for c in codes):
            return 0
        time.sleep(args.monitor_interval)


def run_multinode(args) -> int:
    """Coordinated multi-node gang restart (reference elastic_launch
    restarts the whole multi-node gang on any failure, run.py:116-129).
    Per attempt: ready barrier -> spawn -> monitor(+fail flag) -> on any
    failure everyone kills, re-barriers, respawns."""
    from ..contrib.utils.tcp_store import TCPStoreServer

    server = None
    if args.node_rank == 0:
        # bind on all interfaces so peer nodes can reach the store
        server = TCPStoreServer(host="0.0.0.0",
                                port=args.restart_coordinator_port)
    try:
        store = _RestartStore(args)
        attempt = 0
        while True:
            try:
                store.set(f"restart/ready/{attempt}/{args.node_rank}", b"1")
                _store_barrier(store, args.nnodes_int,
                               f"restart/ready/{attempt}",
                               args.restart_barrier_timeout)
            except (ConnectionError, OSError, RuntimeError) as e:
                # a peer exited the protocol (success or exhausted
                # restarts) and the store/barrier is gone: restarting
                # alone would wedge in collectives — give up cleanly
                logger.error(
                    "restart coordination lost at attempt %d (%s); "
                    "cannot restart without all nodes", attempt, e,
                )
                return 1
            procs = spawn_gang(args)
            try:
                rc = monitor_multinode(args, procs, store, attempt)
                # done barrier: node 0 must keep the store alive until
                # every node's monitor stopped polling it
                try:
                    store.set(f"restart/done/{args.node_rank}", b"1")
                    if server is not None:
                        _store_barrier(store, args.nnodes_int,
                                       "restart/done", timeout_s=30.0)
                except Exception:  # noqa: BLE001 - teardown is best-effort
                    pass
                return rc
            except _GangFailure as f:
                attempt += 1
                if attempt > args.max_restarts:
                    logger.error(
                        "gang failed (exit %d); max_restarts=%d exhausted",
                        f.code, args.max_restarts,
                    )
                    return f.code
                logger.warning(
                    "gang failed (exit %d); coordinated restart %d/%d",
                    f.code, attempt, args.max_restarts,
                )
            except KeyboardInterrupt:
                kill_gang(procs)
                return 130
    finally:
        if server is not None:
            server.stop()


class _GangStop(Exception):
    """An elastic attempt ended: somebody failed, left, lost its lease, or
    asked for a resize.  Carries enough to account for the event and to
    predict who rejoins at the next round."""

    def __init__(self, kind: str, node: int, reason: str, code: int = 1,
                 rejoin: bool = True, standby=(), nodes=None):
        super().__init__(f"{kind} (node {node}): {reason}")
        self.kind = kind
        self.node = int(node)
        self.reason = reason
        self.code = code
        self.rejoin = rejoin
        self.standby = list(standby)
        # every node the event covers (one lease poll can expire several)
        self.nodes = [int(n) for n in (nodes or [node])]


def publish_health_fence(client, epoch: int, tracker, unhealthy) -> str:
    """Convert chronically unhealthy members into the ``health_fenced``
    stop event (the same epoch/resize machinery lease expiry rides).
    Returns the stop reason, which names the fenced nodes and the health
    payloads that condemned them, and leaves a ``health_fence`` flight
    record naming them (``bagua_tpu/distributed/run.py:594-611``)."""
    from ..elastic import membership as mb
    from ..obs.recorder import dump_flight_record

    health = {int(n): tracker.health_of(n) for n in unhealthy}
    reason = (
        "heartbeat health payload over limit "
        f"(node(s) {unhealthy}: "
        + "; ".join(f"{n}={health[int(n)]}" for n in unhealthy) + ")"
    )
    client.publish_stop(
        epoch, mb.STOP_HEALTH, unhealthy[0], reason,
        rejoin=False, nodes=unhealthy,
    )
    dump_flight_record(
        "health_fence", reason=reason,
        extra={"nodes": [int(n) for n in unhealthy],
               "health": {str(n): h for n, h in health.items()}},
    )
    return reason


def _maybe_write_fleet_snapshot(spec, tracker) -> Optional[dict]:
    """Coordinator-side fleet view: merge every member's latest heartbeat
    health payload into one ``bagua-obs-fleet-v1`` record and write it to
    ``BAGUA_OBS_FLEET_OUT`` (``bagua_tpu/distributed/run.py:614-660``,
    without the historian).  Unset: nothing is merged.  Exception-free
    (None on failure): the caller is the monitor loop."""
    out = _env.get_obs_fleet_out()
    if not out:
        return None
    try:
        from ..obs.export import build_fleet_record, write_fleet_snapshot

        record = build_fleet_record(
            spec.epoch, {nid: tracker.health_of(nid) for nid in spec.ranks})
        write_fleet_snapshot(out, spec.epoch, record=record)
        return record
    except Exception as e:  # noqa: BLE001 - monitoring must not die on obs
        logger.debug("fleet snapshot not written: %s", e)
        return None


#: settings that need a module the port does not have yet, with the JAX
#: package's module that serves each
_MISSING_MODULES = (
    ("BAGUA_AUTOPILOT", lambda: _env.get_autopilot_mode() != "off",
     "the fleet autopilot (bagua_tpu/autopilot/)"),
    ("BAGUA_OBS_HISTORIAN", _env.is_obs_historian_on,
     "the telemetry historian (bagua_tpu/obs/historian.py)"),
    ("BAGUA_OBS_HTTP_PORT", lambda: _env.get_obs_http_port() != 0,
     "the HTTP status plane (bagua_tpu/obs/http.py)"),
)


def refuse_missing_modules() -> None:
    """Refuse, naming the missing module, every setting that asks for a
    part of the JAX launcher that waits for the port's fleet and control
    plane: running without it would silently drop what the user asked
    for."""
    asked = [(name, module) for name, on, module in _MISSING_MODULES if on()]
    if asked:
        raise SystemExit(
            "bagua_tpu_torch launcher: "
            + "; ".join(f"{name} asks for {module}, which bagua_tpu_torch does not have yet"
                        for name, module in asked)
            + ": unset it, or run the JAX package's launcher")


def _build_coordinator_stack(args, store, client):
    """The rendezvous coordinator of the coordinator role: ONE constructor
    shared by the boot-time coordinator and a promoted standby, so the
    takeover path constructs what the primary ran.  (The JAX package also
    builds its autopilot engine, historian and HTTP plane here; the port's
    launcher refuses those settings.)"""
    from ..elastic.coordinator import ElasticCoordinator

    return ElasticCoordinator(
        client, args.min_nnodes, args.max_nnodes,
        args.master_addr, args.master_port,
        join_window_s=args.join_window,
        timeout_s=args.restart_barrier_timeout,
    )


class _PromotionHandle:
    """Standby-launcher takeover state.

    Owns the :class:`~bagua_tpu_torch.elastic.failover.StandbyCoordinatorWatch`
    (which runs the store election in the background) and, once the watch
    wins, finishes the launcher-side half of the takeover:

    1. build the coordinator over the replicated store;
    2. start renewing the leadership lease under OUR node id;
    3. when promotion lands mid-epoch, hand back a
       :class:`~bagua_tpu_torch.elastic.membership.LeaseTracker` for the current
       spec, RE-ARMED with a takeover grace window — a coordinator blip
       must not mass-expire every healthy worker lease (their heartbeats
       never stopped; it was the OBSERVER that went away)."""

    def __init__(self, args, store, client, watch):
        self.args = args
        self.store = store
        self.client = client
        self.watch = watch
        self.coordinator = None
        self.keeper = None
        self.completed = False

    @property
    def pending(self) -> bool:
        """The watch won the store election; the launcher-side takeover
        has not happened yet."""
        return not self.completed and self.watch.promoted

    def complete(self, spec=None):
        """Finish the takeover.  Returns the re-armed lease tracker for
        ``spec`` (mid-epoch promotion), or None when promotion lands
        between epochs and the next ``run_round`` builds the world anew."""
        from ..elastic import membership as mb
        from ..elastic.failover import CoordinatorLeaseKeeper

        args = self.args
        self.coordinator = _build_coordinator_stack(args, self.store, self.client)
        self.keeper = CoordinatorLeaseKeeper(
            _store_connect_factory(args),
            args.node_rank, _env.get_restart_coord_lease_ttl_s(),
            generation=self.watch.store.generation,
        ).start()
        self.completed = True
        logger.warning(
            "coordinator takeover complete: node %d now runs the "
            "coordinator (store generation %d)", args.node_rank,
            self.watch.store.generation,
        )
        if spec is None:
            return None
        tracker = mb.LeaseTracker(
            self.client, spec.epoch,
            [i for i in spec.ranks if i != args.node_rank],
            ttl_s=args.lease_ttl,
            fence_unhealthy_after=(
                _env.get_elastic_fence_unhealthy() or None
            ),
            observe_only_ids=[args.node_rank],
        )
        grace = _env.get_restart_takeover_grace_s() or 2.0 * args.lease_ttl
        tracker.rearm(grace)
        return tracker

    def stop(self) -> None:
        self.watch.stop()
        if self.keeper is not None:
            self.keeper.stop()


def monitor_elastic(args, procs, client, spec, coordinator, tracker,
                    promotion=None) -> int:
    """Monitor one elastic attempt.  Every launcher: watch local workers +
    the per-epoch stop flag.  The coordinator additionally: expire silent
    members' leases, fence chronically unhealthy ones, and scan for standby
    joiners (scale-up requests) — each converted into a stop event the
    whole gang observes."""
    from ..elastic import membership as mb

    epoch = spec.epoch
    store_down_since = None
    while True:
        if promotion is not None and promotion.pending:
            # the standby watch won the store election mid-epoch: become
            # the coordinator IN PLACE — same spec, same workers, fresh
            # tracker re-armed with the takeover grace so nobody healthy
            # gets expired while heartbeats re-converge on us
            tracker = promotion.complete(spec)
            coordinator = promotion.coordinator
        codes = [p.poll() for p in procs]
        failed = [c for c in codes if c not in (None, 0)]
        if failed:
            # a worker whose gloo peer died fails at its next collective,
            # before that peer's lease can expire: the coordinator first
            # asks the leases whether a member is gone, so that a lost node
            # is named (and not waited for at the next round).  In the JAX
            # package the survivors' collectives wedge until the lease expires
            lost = []
            if tracker is not None:
                try:
                    lost = tracker.wait_for_loss(args.lease_ttl + 2 * args.monitor_interval,
                                                 min(args.monitor_interval, 0.2))
                except _STORE_RETRY_ERRORS:
                    pass
            if lost:
                reason = (f"worker exit {failed[0]}; no heartbeat for "
                          f"{args.lease_ttl:.0f}s (node(s) {lost})")
                try:
                    client.publish_stop(epoch, mb.STOP_LEASE_EXPIRED, lost[0], reason,
                                        rejoin=False, nodes=lost)
                except _STORE_RETRY_ERRORS:
                    logger.warning("restart store unreachable while publishing")
                kill_gang(procs)
                raise _GangStop(mb.STOP_LEASE_EXPIRED, lost[0], reason, code=failed[0],
                                rejoin=False, nodes=lost)
            # a deliberate departure (watchdog exit) left a leave intent
            # under OUR id — report it as leave, not crash, so membership
            # telemetry can tell purposeful exits from silent failures
            kind, reason = mb.STOP_FAIL, f"worker exit {failed[0]}"
            try:
                leave = client.read_leave(epoch, args.node_rank)
                if leave:
                    kind, reason = mb.STOP_LEAVE, leave
                client.publish_stop(epoch, kind, args.node_rank, reason)
            except _STORE_RETRY_ERRORS:
                logger.warning("restart store unreachable while publishing")
            kill_gang(procs)
            raise _GangStop(kind, args.node_rank, reason, code=failed[0])
        if (
            store_down_since is None
            or time.time() - store_down_since > 30.0
        ):
            try:
                stop = client.read_stop(epoch)
                if store_down_since is not None:
                    logger.info("restart store reachable again")
                store_down_since = None
                if stop is not None:
                    logger.warning(
                        "stop event from node %s (%s: %s); killing local "
                        "gang", stop["node"], stop["kind"], stop["reason"],
                    )
                    kill_gang(procs)
                    raise _GangStop(
                        stop["kind"], stop["node"], stop["reason"],
                        rejoin=stop.get("rejoin", True),
                        nodes=stop.get("nodes"),
                    )
                if tracker is not None:
                    expired = tracker.poll()
                    if expired:
                        reason = (
                            f"no heartbeat for {args.lease_ttl:.0f}s "
                            f"(node(s) {expired})"
                        )
                        client.publish_stop(
                            epoch, mb.STOP_LEASE_EXPIRED, expired[0],
                            reason, rejoin=False, nodes=expired,
                        )
                        kill_gang(procs)
                        raise _GangStop(
                            mb.STOP_LEASE_EXPIRED, expired[0], reason,
                            rejoin=False, nodes=expired,
                        )
                    _maybe_write_fleet_snapshot(spec, tracker)
                    unhealthy = tracker.unhealthy_members()
                    if unhealthy:
                        reason = publish_health_fence(
                            client, epoch, tracker, unhealthy
                        )
                        kill_gang(procs)
                        raise _GangStop(
                            mb.STOP_HEALTH, unhealthy[0], reason,
                            rejoin=False, nodes=unhealthy,
                        )
                    standby = coordinator.standby_ids(spec)
                    if standby and spec.nnodes < spec.max_nnodes:
                        grow = standby[: spec.max_nnodes - spec.nnodes]
                        reason = f"standby node(s) {grow} joined; scaling up"
                        client.publish_stop(
                            epoch, mb.STOP_RESIZE, grow[0], reason)
                        kill_gang(procs)
                        raise _GangStop(
                            mb.STOP_RESIZE, grow[0], reason, standby=grow)
            except _STORE_RETRY_ERRORS:
                if store_down_since is None:
                    logger.warning("restart store unreachable; monitoring "
                                   "locally (reprobe every 30 s)")
                store_down_since = time.time()
        if all(c == 0 for c in codes):
            return 0
        time.sleep(args.monitor_interval)


def _dump_elastic_telemetry(transitions) -> None:
    """Write membership counters + the transition log where the operator
    (or a drill script) asked for them: $BAGUA_ELASTIC_TELEMETRY_OUT."""
    from ..telemetry import counters

    logger.info("elastic membership counters: %s", counters.snapshot())
    out = _env.get_elastic_telemetry_out()
    if not out:
        return
    try:
        import json

        with open(out, "w") as f:
            json.dump(
                {"counters": counters.snapshot(), "transitions": transitions},
                f, indent=1,
            )
    except OSError as e:
        logger.warning("could not write elastic telemetry to %s: %s", out, e)


def run_elastic(args) -> int:
    """Elastic multi-node launch (``--nnodes MIN:MAX``): every restart
    attempt is a rendezvous round through the elastic coordinator instead
    of a fixed-size barrier.  The store-hosting launcher (node id 0) runs
    the coordinator and is the fixed point — it cannot be resized away;
    every other node can die (lease expiry / crash → regroup at n-1) or
    appear (standby join → coordinated resize at the attempt boundary)."""
    from ..contrib.utils.tcp_store import TCPStoreServer
    from ..elastic import membership as mb
    from ..elastic.coordinator import (
        ExcludedFromRound,
        Halted,
        RendezvousTimeout,
        join_round,
        wait_for_next_epoch,
    )
    from ..telemetry import counters

    endpoints = _store_endpoints(args)
    server = None
    keeper = None
    promotion = None
    if endpoints is None:
        is_coord = args.node_rank == 0
        if is_coord:
            server = TCPStoreServer(host="0.0.0.0",
                                    port=args.restart_coordinator_port)
    else:
        # replicated restart store: the first
        # len(endpoints) node ids each host one store server — id 0 boots
        # as the primary, the rest as replication followers.  A RELAUNCHED
        # id 0 probes its peers first (_recover_from_peers): it adopts the
        # surviving replicated state and, if a takeover already moved the
        # primary role, starts demoted — leadership is a lease in the
        # store, not a property of the node id.
        if args.node_rank < len(endpoints):
            server = TCPStoreServer(
                host="0.0.0.0", port=endpoints[args.node_rank][1],
                peers=[e for i, e in enumerate(endpoints)
                       if i != args.node_rank],
                role="primary" if args.node_rank == 0 else "standby",
            )
        is_coord = args.node_rank == 0 and (server is None
                                            or server.is_primary)
    transitions: List[dict] = []
    stop_counter = {
        mb.STOP_FAIL: "elastic/failures",
        mb.STOP_LEASE_EXPIRED: "elastic/lease_expired",
        mb.STOP_LEAVE: "elastic/leaves",
        mb.STOP_RESIZE: "elastic/resizes",
        mb.STOP_HEALTH: "elastic/health_fenced",
    }
    try:
        store = _RestartStore(args)
        client = mb.MembershipClient(store, args.node_rank, args.max_nnodes)
        coordinator = None
        if is_coord:
            coordinator = _build_coordinator_stack(args, store, client)
        if endpoints is not None:
            from ..elastic.failover import (
                CoordinatorLeaseKeeper,
                StandbyCoordinatorWatch,
            )

            coord_ttl = _env.get_restart_coord_lease_ttl_s()
            if is_coord:
                keeper = CoordinatorLeaseKeeper(
                    _store_connect_factory(args),
                    args.node_rank, coord_ttl,
                    generation=store.generation,
                ).start()
            elif server is not None:
                # standby coordinator: every follower-store host watches
                # the leadership lease from its own connection; the watch
                # wins the takeover in the STORE (generation fence), the
                # _PromotionHandle finishes the launcher side
                promotion = _PromotionHandle(
                    args, store, client,
                    StandbyCoordinatorWatch(
                        _connect_restart_store(args, timeout_s=60.0),
                        args.node_rank, args.node_rank, coord_ttl,
                    ).start(),
                )
        epoch = 0
        restarts_used = 0
        expect = None
        while True:
            if promotion is not None and promotion.completed \
                    and not is_coord:
                # takeover landed (mid-epoch in monitor_elastic, or while
                # waiting out a dead primary below): this launcher runs
                # every round from here on as the coordinator
                is_coord = True
                coordinator = promotion.coordinator
            try:
                from ..obs.spans import trace_span

                with trace_span("elastic/rendezvous", epoch=epoch,
                                role="coordinator" if is_coord else "member"):
                    if is_coord:
                        spec = coordinator.run_round(epoch, expect=expect)
                    elif promotion is None:
                        spec = join_round(
                            client, epoch,
                            timeout_s=args.restart_barrier_timeout,
                        )
                        epoch = spec.epoch
                    else:
                        # a standby-store host must not sit out the whole
                        # rendezvous timeout inside join_round: when the
                        # primary dies mid-rendezvous the watch promotes
                        # US, and only the promoted node can publish the
                        # epoch everyone (including us) is waiting for —
                        # so wait in short slices and surface promotion
                        deadline = time.monotonic() + \
                            args.restart_barrier_timeout
                        while True:
                            try:
                                spec = join_round(client, epoch,
                                                  timeout_s=5.0)
                                break
                            except RendezvousTimeout:
                                if promotion.pending or \
                                        time.monotonic() > deadline:
                                    raise
                        epoch = spec.epoch
            except ExcludedFromRound as e:
                logger.warning("%s", e)
                counters.incr("elastic/excluded")
                try:
                    epoch = wait_for_next_epoch(
                        client, e.epoch,
                        timeout_s=args.restart_barrier_timeout,
                    )
                except Halted as h:
                    return int(h.verdict.get("code", 1))
                except RendezvousTimeout as e2:
                    logger.error("standby wait ended: %s", e2)
                    return 1
                continue
            except Halted as h:
                logger.info("job already decided: %s", h)
                return int(h.verdict.get("code", 1))
            except (RendezvousTimeout, *_STORE_RETRY_ERRORS) as e:
                if promotion is not None and promotion.pending:
                    logger.warning(
                        "rendezvous interrupted at epoch %d (%s); this "
                        "standby was promoted — rerunning the round as "
                        "the coordinator", epoch, e,
                    )
                    promotion.complete()
                    continue
                logger.error("rendezvous failed at epoch %d: %s", epoch, e)
                if is_coord:
                    try:
                        client.publish_halt(1, f"rendezvous failed: {e}")
                    except Exception:  # noqa: BLE001 - teardown best-effort
                        pass
                return 1
            counters.incr("elastic/rounds")
            counters.set_gauge("elastic/world_nnodes", spec.nnodes)
            transitions.append({
                "epoch": spec.epoch, "nnodes": spec.nnodes,
                "members": sorted(spec.ranks),
            })
            logger.info(
                "elastic epoch %d: %d node(s), node id %d -> rank %d",
                spec.epoch, spec.nnodes, args.node_rank,
                spec.rank_of(args.node_rank),
            )
            # fresh attempt, fresh health: a stale beacon from the previous
            # epoch's workers would instantly re-report old events (and with
            # fencing armed, re-fence a node that just restarted clean)
            beacons = _health_beacon_paths(args)
            for beacon in beacons:
                try:
                    os.unlink(beacon)
                except OSError:
                    pass
            hb = mb.LeaseHeartbeat(
                _store_connect_factory(args),
                args.node_rank, spec.epoch,
                interval_s=max(0.5, args.lease_ttl / 5.0),
                max_nnodes=args.max_nnodes,
                # the launcher beats, the WORKERS train: their grad-guard /
                # async-staleness events ride per-rank beacon files, merged
                # into one node payload per beat
                health_source=mb.merged_health_source(beacons),
            ).start()
            tracker = None
            if is_coord:
                tracker = mb.LeaseTracker(
                    client, spec.epoch,
                    [i for i in spec.ranks if i != args.node_rank],
                    ttl_s=args.lease_ttl,
                    fence_unhealthy_after=(
                        _env.get_elastic_fence_unhealthy() or None
                    ),
                    # the coordinator can't lease-expire itself, but its
                    # own workers' health must still reach the fence
                    observe_only_ids=[args.node_rank],
                )
            # (the JAX launcher also hands its autopilot's storage
            # quarantine verdicts to the spawn here)
            procs = spawn_gang(args, spec)
            try:
                rc = monitor_elastic(
                    args, procs, client, spec, coordinator, tracker,
                    promotion=promotion)
                try:
                    client.publish_done(spec.epoch)
                    # a takeover during the FINAL epoch makes us the
                    # coordinator mid-monitor: the teardown duty moved too
                    if is_coord or (promotion is not None
                                    and promotion.completed):
                        # keep the store alive until every member's monitor
                        # stopped polling it, then post the verdict
                        deadline = time.time() + 30.0
                        members = list(spec.ranks)
                        while time.time() < deadline:
                            if len(client.done_ids(spec.epoch, members)) == \
                                    len(members):
                                break
                            time.sleep(0.2)
                        client.publish_halt(0, "success")
                except Exception:  # noqa: BLE001 - teardown is best-effort
                    pass
                return rc
            except _GangStop as s:
                counters.incr(stop_counter.get(s.kind, "elastic/failures"))
                transitions[-1]["stop"] = {
                    "kind": s.kind, "node": s.node, "reason": s.reason,
                }
                survivors = set(spec.ranks)
                if not s.rejoin:
                    survivors -= set(s.nodes)
                expect = survivors | set(s.standby)
                epoch = spec.epoch + 1
                if s.kind == mb.STOP_HEALTH and args.node_rank in s.nodes:
                    # this node was fenced for chronic bad health — exiting
                    # (instead of waiting as a standby) keeps it from
                    # bouncing back into the fleet it was just removed from;
                    # an operator restarts it deliberately after diagnosis
                    logger.error(
                        "this node was health-fenced at epoch %d (%s); "
                        "exiting", spec.epoch, s.reason,
                    )
                    # the fenced node's own post-mortem: its launcher
                    # counters flush through the flight recorder (the
                    # coordinator already dumped the fencing side)
                    from ..obs.recorder import dump_flight_record

                    dump_flight_record(
                        "health_fence",
                        reason=f"this node fenced: {s.reason}",
                        extra={"nodes": [int(n) for n in s.nodes]},
                    )
                    if is_coord:
                        # the membership store lives in this process, so
                        # fencing the coordinator halts the whole job:
                        # publish the verdict and give survivors a beat to
                        # read it before the store dies with us
                        try:
                            client.publish_halt(
                                4,
                                f"coordinator node health-fenced: {s.reason}",
                            )
                            time.sleep(3.0)
                        except Exception:  # noqa: BLE001 - teardown
                            pass
                    return 4
                if s.kind == mb.STOP_RESIZE:
                    logger.warning(
                        "coordinated resize at epoch %d (%s); regrouping "
                        "as epoch %d", spec.epoch, s.reason, epoch,
                    )
                    continue  # resizes are free: not a failure
                restarts_used += 1
                counters.incr("elastic/restarts")
                if restarts_used > args.max_restarts:
                    logger.error(
                        "gang stopped (%s); max_restarts=%d exhausted",
                        s.kind, args.max_restarts,
                    )
                    if is_coord:
                        try:
                            client.publish_halt(
                                s.code or 1, "max_restarts exhausted")
                        except Exception:  # noqa: BLE001
                            pass
                    return s.code or 1
                logger.warning(
                    "gang stopped at epoch %d (%s from node %d); elastic "
                    "restart %d/%d as epoch %d", spec.epoch, s.kind,
                    s.node, restarts_used, args.max_restarts, epoch,
                )
            except KeyboardInterrupt:
                try:
                    client.publish_leave(spec.epoch, "keyboard interrupt")
                    client.publish_stop(
                        spec.epoch, mb.STOP_LEAVE, args.node_rank,
                        "keyboard interrupt", rejoin=False,
                    )
                except Exception:  # noqa: BLE001 - dying anyway
                    pass
                kill_gang(procs)
                return 130
            finally:
                hb.stop()
    finally:
        _dump_elastic_telemetry(transitions)
        if keeper is not None:
            keeper.stop()
        if promotion is not None:
            promotion.stop()
        if server is not None:
            server.stop()


def run(args) -> int:
    refuse_missing_modules()
    if args.elastic:
        return run_elastic(args)
    if args.nnodes_int > 1 and args.max_restarts > 0:
        return run_multinode(args)
    attempt = 0
    while True:
        procs = spawn_gang(args)
        try:
            return monitor(args, procs)
        except _GangFailure as f:
            attempt += 1
            if attempt > args.max_restarts:
                logger.error(
                    "worker failed (exit %d); max_restarts=%d exhausted",
                    f.code, args.max_restarts,
                )
                return f.code
            logger.warning(
                "worker failed (exit %d); gang restart %d/%d",
                f.code, attempt, args.max_restarts,
            )
        except KeyboardInterrupt:
            kill_gang(procs)
            return 130


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    return run(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
