#!/usr/bin/env python
"""Coordinator-failover drill of the port: kill, pause or flake the real
control-plane processes of ``bagua_tpu_torch.podsim`` and prove the fleet
survives.

Counterpart of ``scripts/failover_drill.py``, over the port's replicated
restart store (``elastic.failover``: primary and follower store servers,
op-log replication, the generation fence), its killable coordinator
process (``podsim/coordinator.py``) renewing the ``coord/lease`` leadership
lease with a standby watching it, and its worker processes
(``podsim/worker.py``).  Every process, this one included, imports through
the simulator's torch-free bootstrap (``podsim/_bootstrap.py``): no torch,
no numpy, no card.  The fault matrix:

* **coordinator_failover**: SIGKILL the primary coordinator (which also
  hosts the primary store) mid-training at ``--world`` ranks.  The standby
  promotes within the member lease TTL, no healthy worker restarts, and
  the promoted coordinator resumes the autopilot state and the historian
  rings from the replicated store.
* **partition_fence**: SIGSTOP the primary (a partition, not a death);
  after the standby takes over, SIGCONT it.  The thawed ex-primary's late
  writes bounce off the generation fence, it demotes itself and exits
  ``EXIT_DEMOTED`` (5); the lease stays with the standby.
* **store_flake**: every worker runs with an armed ``store.failover``
  fault plan; injected endpoint failures walk the clients down the replica
  list mid-epoch and the fleet still reaches every verdict.
* **heartbeat_loss**: SIGSTOP one worker past the lease TTL: the
  coordinator expires it (``lease_expired`` naming it), the survivors
  regroup at n-1, the thawed worker exits in order (0 or 4).

Usage::

    python scripts/torch_failover_drill.py           # full matrix, 32 ranks
    python scripts/torch_failover_drill.py --smoke   # the kill at 4 ranks
    python scripts/torch_failover_drill.py --world 4 --only partition_fence

The verdict goes to ``chiprun_out/torch_failover_drill.json`` (``--out``).
"""

import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "bagua_tpu_torch", "podsim"))
import _bootstrap  # noqa: E402

_bootstrap.install(_REPO)

import argparse  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import signal  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

from bagua_tpu_torch.elastic.failover import (  # noqa: E402
    FailoverStore,
    read_coord_lease,
)
from bagua_tpu_torch.elastic.membership import MembershipClient  # noqa: E402
from bagua_tpu_torch.podsim.coordinator import EXIT_DEMOTED, STATUS_KEY  # noqa: E402
from bagua_tpu_torch.podsim.orchestrator import (  # noqa: E402
    COORDINATOR_PATH,
    worker_argv,
)

logger = logging.getLogger("torch_failover_drill")

SCHEMA = "bagua-failover-drill-v1"
#: where the verdict goes by default (never the JAX drill's FAILOVER_DRILL.json)
DEFAULT_OUT = os.path.join(_REPO, "chiprun_out", "torch_failover_drill.json")


def _free_ports(n):
    """Reserve n distinct loopback ports (bind-then-close; the drill
    respawns servers on them immediately, so collisions are unlikely on a
    CI host and a collision fails loudly at server bind)."""
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _wait(pred, timeout_s, poll_s=0.2, what="condition"):
    """Poll ``pred`` until truthy; returns its value.  Raises on timeout —
    a drill that can't observe its precondition must fail loudly."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            value = pred()
        except ConnectionError:
            value = None
        if value:
            return value
        if time.monotonic() > deadline:
            raise TimeoutError(f"timed out after {timeout_s:.0f}s "
                               f"waiting for {what}")
        time.sleep(poll_s)


class Fleet:
    """One drill fleet: coordinator processes (primary + standbys, each
    hosting a store replica), worker processes, and an observer client."""

    def __init__(self, base, name, world, *, standbys=1, steps=0,
                 vec_elems=2048, slice_size=2, lease_ttl=3.0,
                 coord_ttl=1.5, join_window=20.0, timeout=90.0,
                 worker_env=None):
        self.dir = os.path.join(base, name)
        os.makedirs(self.dir, exist_ok=True)
        self.world = world
        self.lease_ttl = lease_ttl
        self.coord_ttl = coord_ttl
        ports = _free_ports(1 + standbys)
        self.endpoints = [("127.0.0.1", p) for p in ports]
        self.ep_str = ",".join(f"{h}:{p}" for h, p in self.endpoints)
        self.coords = {}
        for cid in range(1 + standbys):
            self.coords[cid] = self._spawn(f"coord{cid}", [
                sys.executable, COORDINATOR_PATH,
                "--store-endpoints", self.ep_str,
                "--coord-id", str(cid), "--world", str(world),
                "--min-nnodes", "1", "--join-window", str(join_window),
                "--timeout", str(timeout),
                "--lease-ttl", str(lease_ttl),
                "--coord-lease-ttl", str(coord_ttl),
            ])
        self.workers = {}
        for nid in range(world):
            self.workers[nid] = self._spawn(f"node{nid}", worker_argv(
                "127.0.0.1", ports[0], nid, world, steps=steps,
                vec_elems=vec_elems, slice_size=slice_size,
                timeout_s=timeout, store_endpoints=self.ep_str,
            ), env=worker_env)
        self.store = FailoverStore(self.endpoints, connect_timeout_s=60.0)
        self.client = MembershipClient(self.store, 0, world)

    def _spawn(self, name, argv, env=None):
        full_env = dict(os.environ)
        full_env.update(env or {})
        log = open(os.path.join(self.dir, f"{name}.log"), "ab")
        try:
            return subprocess.Popen(
                argv, stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True, env=full_env,
            )
        finally:
            log.close()

    # ---- observation ---------------------------------------------------

    def lease(self):
        return read_coord_lease(self.store)

    def status(self):
        raw = self.store.get(STATUS_KEY)
        return json.loads(raw) if raw else None

    def world_spec(self, epoch):
        return self.client.read_world(epoch)

    def ok_count(self, epoch, members):
        vals = self.store.mget(
            [f"podsim/{epoch}/ok/{n}" for n in members])
        return sum(1 for v in vals if v is not None)

    def workers_alive(self):
        return sorted(n for n, p in self.workers.items()
                      if p.poll() is None)

    # ---- scenario primitives -------------------------------------------

    def kill_coord(self, cid):
        self.coords[cid].kill()
        self.coords[cid].wait(timeout=10)

    def pause(self, proc):
        os.kill(proc.pid, signal.SIGSTOP)

    def resume(self, proc):
        os.kill(proc.pid, signal.SIGCONT)

    # ---- teardown ------------------------------------------------------

    def halt_and_reap(self, timeout_s=30.0):
        """Publish the halt verdict and reap everything; returns
        ``{"workers": {nid: code}, "coords": {cid: code}}`` (None = had
        to be killed)."""
        try:
            self.client.publish_halt(0, "drill complete")
        except ConnectionError:
            pass
        codes = {"workers": {}, "coords": {}}
        deadline = time.monotonic() + timeout_s
        for group, procs in (("workers", self.workers),
                             ("coords", self.coords)):
            for pid, proc in sorted(procs.items()):
                try:
                    codes[group][pid] = proc.wait(
                        timeout=max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=10)
                    codes[group][pid] = None
        return codes

    def shutdown(self):
        for procs in (self.workers, self.coords):
            for proc in procs.values():
                if proc.poll() is None:
                    # a SIGSTOPped process ignores SIGKILL until resumed
                    try:
                        os.kill(proc.pid, signal.SIGCONT)
                    except OSError:
                        pass
                    proc.kill()
        for procs in (self.workers, self.coords):
            for proc in procs.values():
                try:
                    proc.wait(timeout=10)
                except Exception:  # noqa: BLE001 - teardown best-effort
                    pass
        self.store.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


def coordinator_failover(base, world, *, steps, vec_elems=1024,
                         slice_size=8):
    """SIGKILL the primary coordinator mid-training; the standby promotes,
    zero healthy workers restart, autopilot+historian state resumes."""
    t0 = time.monotonic()
    with Fleet(base, "coordinator_failover", world, standbys=1,
               steps=steps, vec_elems=vec_elems,
               slice_size=slice_size) as fleet:
        spec = _wait(lambda: fleet.world_spec(0), 60, what="epoch 0 world")
        members = sorted(spec.ranks)
        # let the primary's monitor run long enough to persist autopilot
        # policy state + historian rings into the replicated store — the
        # state the takeover must prove it resumed
        pre = _wait(
            lambda: (lambda s: s if s and s["ticks"] >= 8 else None)(
                fleet.status()),
            60, what="primary coordinator status (>=8 ticks)")
        pre_lease = fleet.lease()
        pre_alive = fleet.workers_alive()
        pre_pids = {n: p.pid for n, p in fleet.workers.items()}

        t_kill = time.monotonic()
        fleet.kill_coord(0)  # SIGKILL: primary store AND coordinator die
        lease = _wait(
            lambda: (lambda le: le if le and le.get("node") == 1
                     and le.get("gen", 0) >= 1 else None)(fleet.lease()),
            fleet.lease_ttl * 4 + 15, what="standby lease claim")
        takeover_s = time.monotonic() - t_kill
        post = _wait(
            lambda: (lambda s: s if s and s["role"] == "promoted"
                     else None)(fleet.status()),
            30, what="promoted coordinator status")

        # the training epoch must be undisturbed: same epoch, no stop
        # event, every pre-kill worker process still the SAME pid
        ok_all = _wait(
            lambda: fleet.ok_count(spec.epoch, members) == len(members),
            90, what="all epoch verdicts after takeover")
        stop = fleet.client.read_stop(spec.epoch)
        checks = {
            "boot_lease_was_primary": bool(pre_lease
                                           and pre_lease["node"] == 0),
            "promoted_within_member_ttl": takeover_s <= fleet.lease_ttl,
            "generation_advanced": post["generation"] >= 1,
            "epoch_unchanged": post["epoch"] == spec.epoch,
            "no_stop_event": stop is None,
            "zero_worker_restarts": (
                fleet.workers_alive() == pre_alive == members
                and {n: p.pid for n, p in fleet.workers.items()}
                == pre_pids),
            "autopilot_state_resumed": post["autopilot_resumed"] is True,
            "historian_rings_resumed": post["historian_loaded_series"] >= 1,
            "autopilot_not_reset": (post["autopilot_actions_taken"]
                                    >= pre["autopilot_actions_taken"]),
            "all_verdicts_after_takeover": bool(ok_all),
        }
        codes = fleet.halt_and_reap()
        checks["workers_exit_clean"] = all(
            c == 0 for c in codes["workers"].values())
        checks["standby_exit_clean"] = codes["coords"][1] == 0
    return {
        "world": world, "steps": steps, "takeover_s": round(takeover_s, 2),
        "member_lease_ttl_s": fleet.lease_ttl,
        "coord_lease_ttl_s": fleet.coord_ttl,
        "pre_status": pre, "post_status": post,
        "exit_codes": codes, "checks": checks,
        "wall_s": round(time.monotonic() - t0, 1),
        "ok": all(checks.values()),
    }


def partition_fence(base):
    """SIGSTOP the primary (partition), let the standby take over, then
    SIGCONT: the generation fence rejects the thawed ex-primary's late
    writes and it exits demoted — no double primary."""
    t0 = time.monotonic()
    with Fleet(base, "partition_fence", 4, standbys=1, steps=0) as fleet:
        spec = _wait(lambda: fleet.world_spec(0), 60, what="epoch 0 world")
        members = sorted(spec.ranks)
        _wait(lambda: fleet.ok_count(0, members) == len(members),
              60, what="epoch 0 verdicts")
        _wait(lambda: (s := fleet.status()) and s["ticks"] >= 4,
              30, what="primary status")
        fleet.pause(fleet.coords[0])
        lease = _wait(
            lambda: (lambda le: le if le and le.get("node") == 1
                     and le.get("gen", 0) >= 1 else None)(fleet.lease()),
            fleet.lease_ttl * 4 + 15, what="standby takeover")
        gen_after_takeover = lease["gen"]
        fleet.resume(fleet.coords[0])
        # the thawed ex-primary replicates its buffered writes, gets
        # ACK_FENCED, demotes its server and exits with the demoted code
        _wait(lambda: fleet.coords[0].poll() is not None, 30,
              what="ex-primary exit")
        ex_code = fleet.coords[0].poll()
        time.sleep(1.0)  # give a hypothetical double-primary time to act
        lease_now = fleet.lease()
        post = fleet.status()
        checks = {
            "standby_promoted": gen_after_takeover >= 1,
            "ex_primary_demoted_exit": ex_code == EXIT_DEMOTED,
            "lease_stays_with_standby": bool(lease_now
                                             and lease_now["node"] == 1),
            "promoted_still_acting": bool(post
                                          and post["role"] == "promoted"),
            "no_stop_event": fleet.client.read_stop(spec.epoch) is None,
            "workers_all_alive": fleet.workers_alive() == members,
        }
        codes = fleet.halt_and_reap()
        checks["workers_exit_clean"] = all(
            c == 0 for c in codes["workers"].values())
    return {
        "world": 4, "ex_primary_exit": ex_code,
        "exit_codes": codes, "checks": checks,
        "wall_s": round(time.monotonic() - t0, 1),
        "ok": all(checks.values()),
    }


def store_flake(base):
    """Armed ``store.failover`` faults in every worker: injected endpoint
    failures force their clients across the replica list mid-epoch; the
    control plane never notices."""
    t0 = time.monotonic()
    plan = json.dumps([{"point": "store.failover", "op": 6, "count": 2}])
    with Fleet(base, "store_flake", 4, standbys=1, steps=1,
               worker_env={"BAGUA_FAULT_PLAN": plan}) as fleet:
        spec = _wait(lambda: fleet.world_spec(0), 60, what="epoch 0 world")
        members = sorted(spec.ranks)
        _wait(lambda: fleet.ok_count(0, members) == len(members),
              90, what="verdicts under armed store faults")
        lease = fleet.lease()
        checks = {
            "all_verdicts_under_faults": True,
            "primary_kept_leadership": bool(lease and lease["node"] == 0),
            "no_stop_event": fleet.client.read_stop(0) is None,
        }
        codes = fleet.halt_and_reap()
        checks["workers_exit_clean"] = all(
            c == 0 for c in codes["workers"].values())
    return {
        "world": 4, "fault_plan": json.loads(plan),
        "exit_codes": codes, "checks": checks,
        "wall_s": round(time.monotonic() - t0, 1),
        "ok": all(checks.values()),
    }


def heartbeat_loss(base):
    """SIGSTOP one worker past the lease TTL: the coordinator (over the
    replicated store) expires its lease and the survivors regroup at
    n-1 — member-failure handling is intact under replication."""
    t0 = time.monotonic()
    with Fleet(base, "heartbeat_loss", 4, standbys=1, steps=0,
               join_window=4.0) as fleet:
        spec = _wait(lambda: fleet.world_spec(0), 60, what="epoch 0 world")
        members = sorted(spec.ranks)
        _wait(lambda: fleet.ok_count(0, members) == len(members),
              60, what="epoch 0 verdicts")
        fleet.pause(fleet.workers[3])
        stop = _wait(lambda: fleet.client.read_stop(0),
                     fleet.lease_ttl * 4 + 20, what="lease-expiry stop")
        spec1 = _wait(lambda: fleet.world_spec(1), 60,
                      what="regrouped epoch 1 world")
        fleet.resume(fleet.workers[3])
        checks = {
            "stop_is_lease_expired": stop.get("kind") == "lease_expired",
            "stopped_node_named": 3 in (stop.get("nodes") or []),
            "regrouped_at_n_minus_1": spec1.nnodes == 3
            and 3 not in spec1.ranks,
        }
        _wait(lambda: fleet.ok_count(1, sorted(spec1.ranks))
              == spec1.nnodes, 60, what="epoch 1 verdicts")
        checks["survivors_all_ok"] = True
        codes = fleet.halt_and_reap()
        # the thawed worker sees itself fenced (4) or halts cleanly (0),
        # depending on which it reads first — both are orderly exits
        checks["survivor_exits_clean"] = all(
            c == 0 for n, c in codes["workers"].items() if n != 3)
        checks["expired_worker_orderly_exit"] = (
            codes["workers"][3] in (0, 4))
    return {
        "world": 4, "stop": stop, "regrouped_nnodes": spec1.nnodes,
        "exit_codes": codes, "checks": checks,
        "wall_s": round(time.monotonic() - t0, 1),
        "ok": all(checks.values()),
    }


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


SCENARIOS = ("coordinator_failover", "partition_fence", "store_flake", "heartbeat_loss")


def _imports_clean() -> bool:
    """Whether this process has stayed free of torch and the JAX package."""
    return not any(m.split(".")[0] in ("torch", "jax", "bagua_tpu") for m in sys.modules)


def run_smoke(args):
    base = tempfile.mkdtemp(prefix="torch_failover_smoke_")
    result = coordinator_failover(base, 4, steps=1, vec_elems=4096,
                                  slice_size=2)
    verdict = {"drill": "failover-smoke", "world": 4,
               "takeover_s": result["takeover_s"],
               "checks": result["checks"], "log_dir": base,
               "torch_free": _imports_clean(),
               "ok": result["ok"] and _imports_clean()}
    print(json.dumps(verdict, indent=1, sort_keys=True))
    return 0 if verdict["ok"] else 1


def run_full(args):
    t0 = time.monotonic()
    base = tempfile.mkdtemp(prefix="torch_failover_drill_")
    scenarios = {}
    for name in args.only or SCENARIOS:
        logger.info("=== %s ===", name)
        if name == "coordinator_failover":
            scenarios[name] = coordinator_failover(base, args.world, steps=args.steps)
        else:
            scenarios[name] = globals()[name](base)
    all_checks = {
        f"{scen}/{name}": ok
        for scen, result in scenarios.items()
        for name, ok in result["checks"].items()
    }
    all_checks["process/torch_free"] = _imports_clean()
    record = {
        "schema": SCHEMA,
        "drill": "failover",
        "package": "bagua_tpu_torch",
        "platform": "cpu",
        "host_cores": os.cpu_count(),
        "world": args.world,
        "takeover_s": scenarios.get("coordinator_failover", {}).get("takeover_s"),
        "scenarios": scenarios,
        "checks": all_checks,
        "log_dir": base,
        "wall_s": round(time.monotonic() - t0, 1),
        "ok": all(all_checks.values()),
    }
    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({k: record[k] for k in
                      ("schema", "checks", "takeover_s", "wall_s", "ok")},
                     indent=1, sort_keys=True))
    print(f"wrote {out}")
    return 0 if record["ok"] else 1


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="4-rank SIGKILL scenario only (the CI gate)")
    ap.add_argument("--world", type=int, default=32,
                    help="ranks for the coordinator_failover scenario")
    ap.add_argument("--steps", type=int, default=1,
                    help="collective steps per epoch in the kill scenario "
                         "(training runs THROUGH the takeover)")
    ap.add_argument("--only", nargs="+", choices=SCENARIOS, default=None,
                    help="run these scenarios only (default: all four)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    if args.smoke:
        return run_smoke(args)
    return run_full(args)


if __name__ == "__main__":
    sys.exit(main())
