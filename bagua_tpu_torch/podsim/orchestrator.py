"""The pod simulator's coordinator side: spawn N real worker processes,
run the REAL control plane against them, measure everything.

Port of ``bagua_tpu/podsim/orchestrator.py``, with the drill's full scenario
of ``scripts/scale_drill.py:95-185`` as :func:`full_scenario`.
:class:`PodSim` is the launcher a drill scripts against.  It hosts the
restart TCPStore, runs :class:`~bagua_tpu_torch.elastic.coordinator.
ElasticCoordinator` rendezvous rounds, polls leases with
:class:`~bagua_tpu_torch.elastic.membership.LeaseTracker`, merges heartbeat
health into ``bagua-obs-fleet-v1`` records
(:func:`~bagua_tpu_torch.obs.export.build_fleet_record`), feeds the
telemetry historian and the autopilot engine, serves the coordinator
``/fleet`` HTTP plane, and actuates fence and resize decisions through
``publish_stop``: the object graph ``distributed/run.py`` assembles on node
0, without a trainer.  The workers are real OS processes
(:mod:`~bagua_tpu_torch.podsim.worker`) joined over loopback TCP, so connect
storms, listen backlogs, GIL-bound monitor loops and fan-in serialization
are REAL costs here, measured per tick in :attr:`PodSim.metrics`.

Scenario primitives: ``kill``/``relaunch`` a node (lease-expiry shrink,
standby regrow), ``set_profile`` (flip a node's heartbeat health to
``straggler``/``slow`` mid-run and let the autopilot escalate), ``halt``
(orderly teardown).  The chaos plane (``BAGUA_FAULT_PLAN`` in the workers'
environment) composes link faults on top.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import time
import urllib.request
from typing import Dict, List, Optional, Tuple

from ..autopilot.engine import AutopilotEngine
from ..autopilot.policy import Action, PolicyConfig
from ..contrib.utils.tcp_store import TCPStore, TCPStoreServer
from ..elastic.coordinator import ElasticCoordinator
from ..elastic.membership import LeaseTracker, MembershipClient, WorldSpec
from ..obs.export import build_fleet_record, validate_fleet_snapshot
from ..obs.historian import Historian
from ..obs.http import ObsHTTPServer

logger = logging.getLogger("podsim.orchestrator")

__all__ = ["PodSim", "worker_argv", "full_scenario", "live_metrics",
           "WORKER_PATH", "COORDINATOR_PATH"]

WORKER_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "worker.py")
_WORKER = WORKER_PATH
#: the killable coordinator process (failover drills); PodSim itself runs
#: the coordinator in-process — see :mod:`bagua_tpu_torch.podsim.coordinator`
COORDINATOR_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "coordinator.py")


def worker_argv(store_addr: str, store_port: int, node_id: int,
                max_nnodes: int, *, steps: int = 0, vec_elems: int = 16384,
                shape: str = "pod", slice_size: int = 8, seed: int = 0,
                dcn_codec: str = "minmax_uint8", hb_interval_s: float = 0.5,
                timeout_s: float = 120.0,
                store_endpoints: str = "") -> List[str]:
    """The ``worker.py`` command line — ONE builder for the in-process
    :class:`PodSim` launcher and the cross-process failover drill, so a
    drill worker is configured exactly like a scale-drill worker."""
    argv = [
        sys.executable, WORKER_PATH,
        "--store-addr", store_addr, "--store-port", str(store_port),
        "--node-id", str(node_id), "--max-nnodes", str(max_nnodes),
        "--steps", str(steps), "--vec-elems", str(vec_elems),
        "--shape", shape, "--slice-size", str(slice_size),
        "--seed", str(seed), "--dcn-codec", dcn_codec,
        "--hb-interval", str(hb_interval_s),
        "--timeout", str(timeout_s),
    ]
    if store_endpoints:
        argv += ["--store-endpoints", store_endpoints]
    return argv


class PodSim:
    """One simulated pod.  Context-manage it — ``__exit__`` tears down
    processes, HTTP plane, and the store server unconditionally."""

    def __init__(self, world: int, workdir: str,
                 min_nnodes: int = 1,
                 steps: int = 0, vec_elems: int = 16384,
                 shape: str = "pod", slice_size: int = 8, seed: int = 0,
                 dcn_codec: str = "minmax_uint8",
                 hb_interval_s: float = 0.5, lease_ttl_s: float = 4.0,
                 join_window_s: float = 30.0, timeout_s: float = 120.0,
                 policy: Optional[PolicyConfig] = None,
                 http: bool = True,
                 worker_env: Optional[Dict[str, str]] = None):
        self.world = int(world)
        self.workdir = str(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        self.min_nnodes = int(min_nnodes)
        self.steps = int(steps)
        self.vec_elems = int(vec_elems)
        self.shape = str(shape)
        self.slice_size = int(slice_size)
        self.seed = int(seed)
        self.dcn_codec = str(dcn_codec)
        self.hb_interval_s = float(hb_interval_s)
        self.lease_ttl_s = float(lease_ttl_s)
        self.timeout_s = float(timeout_s)
        self.worker_env = dict(worker_env or {})

        # the coordinator stack run.py builds on node 0
        self.server = TCPStoreServer("127.0.0.1", 0, backend="python")
        self.addr, self.port = self.server.address
        self.store = TCPStore(self.addr, self.port, timeout_s=60.0)
        self.client = MembershipClient(self.store, 0, self.world)
        self.coord = ElasticCoordinator(
            self.client, self.min_nnodes, self.world,
            master_addr=self.addr, master_port=self.port,
            join_window_s=float(join_window_s), timeout_s=self.timeout_s,
        )
        self.historian = Historian(capacity=4096, window_s=120.0)
        self.engine = AutopilotEngine(
            config=policy or PolicyConfig(
                mode="act", sustain=2, cooldown_s=0.0, budget=8,
                staleness_s=60.0, suspect_ttl_s=30.0,
            ),
            store=self.store,
        )
        self._fleet_record: Optional[dict] = None
        self.http: Optional[ObsHTTPServer] = None
        if http:
            self.http = ObsHTTPServer(
                port=0, addr="127.0.0.1",
                fleet_provider=lambda: self._fleet_record,
                historian=self.historian,
            ).start()

        self.procs: Dict[int, subprocess.Popen] = {}
        self.spec: Optional[WorldSpec] = None
        self.tracker: Optional[LeaseTracker] = None
        #: drill measurements: per-phase wall times and per-tick control
        #: loop latencies (seconds)
        self.metrics: Dict[str, List[float]] = {
            "rendezvous_s": [], "decide_s": [], "ingest_s": [],
            "tick_s": [],
        }

    # ---- process control -------------------------------------------------

    def log_path(self, node_id: int) -> str:
        return os.path.join(self.workdir, f"node{node_id}.log")

    def spawn(self, node_id: int) -> subprocess.Popen:
        env = dict(os.environ)
        env.update(self.worker_env)
        argv = worker_argv(
            self.addr, self.port, node_id, self.world,
            steps=self.steps, vec_elems=self.vec_elems, shape=self.shape,
            slice_size=self.slice_size, seed=self.seed,
            dcn_codec=self.dcn_codec, hb_interval_s=self.hb_interval_s,
            timeout_s=self.timeout_s,
        )
        log = open(self.log_path(node_id), "ab")
        try:
            proc = subprocess.Popen(
                argv, stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True, env=env,
            )
        finally:
            log.close()
        self.procs[node_id] = proc
        return proc

    def spawn_all(self) -> None:
        for nid in range(self.world):
            self.spawn(nid)

    def kill(self, node_id: int) -> None:
        """Hard-kill one node's process — the silent-death case lease
        expiry exists for."""
        proc = self.procs.get(node_id)
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)

    def alive(self) -> List[int]:
        return sorted(n for n, p in self.procs.items() if p.poll() is None)

    # ---- control plane ---------------------------------------------------

    def rendezvous(self, epoch: int,
                   expect: Optional[List[int]] = None) -> WorldSpec:
        """One coordinator round; wall time lands in
        ``metrics['rendezvous_s']``."""
        t0 = time.monotonic()
        spec = self.coord.run_round(epoch, expect=expect)
        self.metrics["rendezvous_s"].append(time.monotonic() - t0)
        self.spec = spec
        self.tracker = LeaseTracker(
            self.client, spec.epoch, sorted(spec.ranks),
            ttl_s=self.lease_ttl_s,
        )
        return spec

    def set_profile(self, node_id: int, profile: str) -> None:
        self.store.set(f"podsim/profile/{node_id}", profile)

    def ok_ids(self, spec: WorldSpec) -> List[int]:
        members = sorted(spec.ranks)
        vals = self.store.mget(
            [f"podsim/{spec.epoch}/ok/{n}" for n in members])
        return [n for n, v in zip(members, vals) if v is not None]

    def ok_verdicts(self, spec: WorldSpec) -> Dict[int, dict]:
        members = sorted(spec.ranks)
        vals = self.store.mget(
            [f"podsim/{spec.epoch}/ok/{n}" for n in members])
        return {n: json.loads(v) for n, v in zip(members, vals)
                if v is not None}

    def _observe_tick(self, spec: WorldSpec) -> List[Action]:
        """One monitor-loop body: poll leases, merge health, historian,
        autopilot — each stage timed."""
        t0 = time.monotonic()
        expired = self.tracker.poll()
        members = {n: self.tracker.health_of(n) for n in sorted(spec.ranks)}
        record = build_fleet_record(spec.epoch, members)
        problems = validate_fleet_snapshot(record)
        if problems:
            raise AssertionError(f"fleet record invalid: {problems}")
        t1 = time.monotonic()
        self.historian.ingest(record)
        t2 = time.monotonic()
        actions = self.engine.observe_snapshot(record)
        t3 = time.monotonic()
        self._fleet_record = record
        self.metrics["ingest_s"].append(t2 - t1)
        self.metrics["decide_s"].append(t3 - t2)
        self.metrics["tick_s"].append(t3 - t0)
        if expired:
            self.client.publish_stop(
                spec.epoch, "lease_expired", expired[0],
                f"lease(s) expired after {self.lease_ttl_s:.1f}s: {expired}",
                rejoin=False, nodes=expired,
            )
        return actions

    def monitor(self, spec: WorldSpec, until: str = "all_ok",
                max_s: float = 60.0,
                tick_s: float = 0.25) -> Tuple[str, List[int]]:
        """Run the coordinator monitor loop until a verdict:

        * ``("all_ok", members)`` — every member wrote its epoch verdict
          (``until="all_ok"``)
        * ``("fenced", nodes)`` — the autopilot decided fence/resize; the
          stop is published (``rejoin=False``) before returning
        * ``("expired", nodes)`` — a lease ran out; stop published
        * ``("timeout", [])`` — ``max_s`` elapsed without a verdict
        """
        deadline = time.monotonic() + max_s
        while time.monotonic() < deadline:
            actions = self._observe_tick(spec)
            stop = self.client.read_stop(spec.epoch)
            if stop is not None and stop.get("kind") == "lease_expired":
                return "expired", list(stop.get("nodes") or [])
            for action in actions:
                if action.kind not in ("fence", "resize"):
                    continue
                targets = [int(t) for t in (
                    action.target if isinstance(action.target, (list, tuple))
                    else [action.target])]
                self.client.publish_stop(
                    spec.epoch, f"autopilot_{action.kind}", targets[0],
                    action.reason, rejoin=False, nodes=targets,
                )
                self.engine.note_actuated(action)
                return "fenced", targets
            if until == "all_ok" and \
                    len(self.ok_ids(spec)) == spec.nnodes:
                return "all_ok", sorted(spec.ranks)
            time.sleep(tick_s)
        return "timeout", []

    def standby_ids(self) -> List[int]:
        return self.coord.standby_ids(self.spec) if self.spec else []

    # ---- teardown --------------------------------------------------------

    def halt(self, reason: str = "drill complete") -> None:
        self.client.publish_halt(0, reason)

    def wait_all(self, timeout_s: float = 30.0) -> Dict[int, Optional[int]]:
        """Reap every worker; returns node -> exit code (None = had to be
        killed)."""
        codes: Dict[int, Optional[int]] = {}
        deadline = time.monotonic() + timeout_s
        for nid, proc in sorted(self.procs.items()):
            try:
                codes[nid] = proc.wait(
                    timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
                codes[nid] = None
        return codes

    def shutdown(self) -> None:
        try:
            self.halt("shutdown")
        except Exception:  # noqa: BLE001 - teardown must not raise
            pass
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
        for proc in self.procs.values():
            try:
                proc.wait(timeout=10)
            except Exception:  # noqa: BLE001
                pass
        if self.http is not None:
            self.http.stop()
            self.http = None
        try:
            self.store._sock.close()  # TCPStore has no close(); be tidy
        except Exception:  # noqa: BLE001
            pass
        self.server.stop()

    def __enter__(self) -> "PodSim":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


# ---- the drill's full scenario ---------------------------------------------


def _percentile(values, q):
    if not values:
        return None
    vals = sorted(values)
    return vals[min(len(vals) - 1, int(round(q * (len(vals) - 1))))]


def _ms(seconds):
    return None if seconds is None else round(seconds * 1e3, 3)


def drill_policy() -> PolicyConfig:
    """The drill's autopilot policy (``scripts/scale_drill.py:89-91``)."""
    return PolicyConfig(mode="act", sustain=2, cooldown_s=0.0, budget=8,
                        staleness_s=60.0, suspect_ttl_s=30.0)


def live_metrics(sim: PodSim) -> dict:
    """The control loop's measurements of one run: every rendezvous, the
    cold start's, the monitor tick's p50/p99 and the decide and ingest
    p99s (milliseconds)."""
    m = sim.metrics
    return {
        "rendezvous_s": [round(v, 3) for v in m["rendezvous_s"]],
        "cold_start_rendezvous_s": round(m["rendezvous_s"][0], 3)
        if m["rendezvous_s"] else None,
        "monitor_tick_p50_ms": _ms(_percentile(m["tick_s"], 0.5)),
        "monitor_tick_p99_ms": _ms(_percentile(m["tick_s"], 0.99)),
        "decide_p99_ms": _ms(_percentile(m["decide_s"], 0.99)),
        "ingest_p99_ms": _ms(_percentile(m["ingest_s"], 0.99)),
    }


def full_scenario(world: int, workdir: str, shape: str = "pod",
                  seed: int = 0, steps: int = 1, vec_elems: int = 8192,
                  slice_size: int = 8, timeout_s: float = 180.0,
                  dcn_codec: str = "minmax_uint8",
                  lease_ttl_s: float = 4.0) -> Tuple[dict, dict]:
    """The end-to-end proof at one world size (``scale_drill.py:95-185``):
    cold start -> shaped hierarchical collectives -> lease-expiry shrink ->
    standby regrow -> autopilot straggler fence -> ``/fleet`` and
    ``/history`` -> teardown, each phase a named check (17).  Returns
    ``(checks, metrics)``; ``metrics`` adds to :func:`live_metrics` the
    wall seconds, the slowest node's import seconds and the largest of the
    nodes' resident-set readings (MiB)."""
    checks: Dict[str, bool] = {}
    nodes: Dict[int, dict] = {}
    t0 = time.monotonic()
    with PodSim(world, workdir, min_nnodes=2, steps=steps,
                vec_elems=vec_elems, shape=shape, slice_size=slice_size,
                seed=seed, dcn_codec=dcn_codec, lease_ttl_s=lease_ttl_s,
                join_window_s=60.0, timeout_s=timeout_s,
                policy=drill_policy()) as sim:
        sim.spawn_all()
        spec = sim.rendezvous(1)
        checks["cold_start_full_world"] = spec.nnodes == world
        verdict, _ = sim.monitor(spec, until="all_ok", max_s=timeout_s)
        checks["shaped_collectives_ok"] = verdict == "all_ok"
        verdicts = sim.ok_verdicts(spec)
        nodes.update(verdicts)
        checks["collectives_within_quant_tolerance"] = bool(verdicts) and all(
            v.get("max_err", 0.0) <= v.get("atol", 1.0)
            for v in verdicts.values() if not v.get("skipped"))
        dcn_hops = sum(v.get("shaping", {}).get("dcn", {}).get("hops", 0)
                       for v in verdicts.values())
        checks["dcn_tier_exercised"] = dcn_hops > 0

        # elastic shrink: hard-kill the highest node, its lease must expire
        victim = world - 1
        sim.kill(victim)
        verdict, who = sim.monitor(spec, until="stop", max_s=60.0)
        checks["lease_expiry_detected"] = (
            verdict == "expired" and who == [victim])
        survivors = [n for n in range(world) if n != victim]
        spec = sim.rendezvous(2, expect=survivors)
        checks["shrunk_world"] = spec.nnodes == world - 1
        verdict, _ = sim.monitor(spec, until="all_ok", max_s=timeout_s)
        checks["post_shrink_collectives_ok"] = verdict == "all_ok"

        # regrow: relaunch the victim, admit it at the next boundary
        sim.spawn(victim)
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and not sim.standby_ids():
            time.sleep(0.3)
        checks["standby_detected"] = victim in sim.standby_ids()
        spec = sim.rendezvous(3, expect=list(range(world)))
        checks["regrown_world"] = spec.nnodes == world
        verdict, _ = sim.monitor(spec, until="all_ok", max_s=timeout_s)
        checks["post_regrow_collectives_ok"] = verdict == "all_ok"

        # autopilot observe -> act: a chronic straggler profile must be
        # fenced through the policy matrix and the stop machinery
        straggler = world // 2
        sim.set_profile(straggler, "straggler")
        verdict, who = sim.monitor(spec, until="stop", max_s=60.0,
                                   tick_s=0.5)
        checks["autopilot_fenced_straggler"] = (
            verdict == "fenced" and who == [straggler])
        spec = sim.rendezvous(
            4, expect=[n for n in range(world) if n != straggler])
        checks["post_fence_world"] = spec.nnodes == world - 1
        verdict, _ = sim.monitor(spec, until="all_ok", max_s=timeout_s)
        checks["post_fence_collectives_ok"] = verdict == "all_ok"

        # the coordinator HTTP plane serves the live fleet and the trends
        try:
            with urllib.request.urlopen(sim.http.url + "/fleet",
                                        timeout=10) as r:
                fleet = json.load(r)
            with urllib.request.urlopen(
                    sim.http.url + "/history?metric=goodput_fraction",
                    timeout=10) as r:
                hist = json.load(r)
            checks["http_fleet_live"] = (
                fleet.get("schema") == "bagua-obs-fleet-v1"
                and fleet.get("nnodes") == spec.nnodes)
            checks["http_history_live"] = bool(hist.get("ranks"))
        except Exception as e:  # noqa: BLE001 - a failed check, not a crash
            logger.warning("http check failed: %s", e)
            checks["http_fleet_live"] = checks["http_history_live"] = False

        sim.halt()
        codes = sim.wait_all(timeout_s=60.0)
        checks["fenced_node_exit_code"] = codes.get(straggler) == 4
        checks["survivors_exit_clean"] = all(
            c == 0 for n, c in codes.items() if n != straggler)
        metrics = live_metrics(sim)
    metrics["wall_s"] = round(time.monotonic() - t0, 3)
    metrics["scenario"] = "full"
    metrics["world"] = world
    imports = [v["import_s"] for v in nodes.values() if "import_s" in v]
    rss = [v["peak_rss_mb"] for v in nodes.values() if "peak_rss_mb" in v]
    metrics["node_import_s_max"] = max(imports) if imports else None
    metrics["node_peak_rss_mb_max"] = max(rss) if rss else None
    return checks, metrics
