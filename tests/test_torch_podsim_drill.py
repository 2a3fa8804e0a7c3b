"""The port's pod simulator with real processes.

* The drill's full scenario (``scripts/scale_drill.py:383-395``, its
  ``--smoke``) at world 4 on ``bagua_tpu_torch.podsim``: every one of its 17
  checks true.
* The torch-free import path: a fresh interpreter that runs the simulator
  bootstrap and imports every module a node or coordinator process needs
  loads neither torch nor anything of the JAX package.
* The core of ``scripts/failover_drill.py``: the primary coordinator process
  SIGKILLed mid-training at world 4, the standby promoted, no worker
  restarted, the autopilot and historian state resumed.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

from bagua_tpu_torch.elastic.failover import FailoverStore, read_coord_lease
from bagua_tpu_torch.elastic.membership import MembershipClient
from bagua_tpu_torch.podsim.coordinator import STATUS_KEY
from bagua_tpu_torch.podsim.orchestrator import COORDINATOR_PATH, full_scenario, worker_argv
from bagua_tpu_torch.podsim.util import reserve_ports

REPO = Path(__file__).resolve().parents[1]

CHECKS = ("cold_start_full_world", "shaped_collectives_ok",
          "collectives_within_quant_tolerance", "dcn_tier_exercised",
          "lease_expiry_detected", "shrunk_world", "post_shrink_collectives_ok",
          "standby_detected", "regrown_world", "post_regrow_collectives_ok",
          "autopilot_fenced_straggler", "post_fence_world", "post_fence_collectives_ok",
          "http_fleet_live", "http_history_live", "fenced_node_exit_code",
          "survivors_exit_clean")


def test_smoke_scenario_world_4(tmp_path):
    checks, metrics = full_scenario(4, str(tmp_path), shape="pod", seed=0, steps=2,
                                    vec_elems=4096, slice_size=2, timeout_s=90.0)
    assert tuple(checks) == CHECKS
    assert all(checks.values()), {k: v for k, v in checks.items() if not v}
    assert metrics["cold_start_rendezvous_s"] > 0
    assert metrics["monitor_tick_p99_ms"] >= metrics["monitor_tick_p50_ms"]
    assert 0 < metrics["node_import_s_max"] and 0 < metrics["node_peak_rss_mb_max"]


def test_node_imports_load_no_torch():
    """The worker's and the coordinator's imports, after the bootstrap they
    run as files, in a fresh interpreter whose ``sys.path`` starts with the
    podsim directory (as a script's does)."""
    podsim = REPO / "bagua_tpu_torch" / "podsim"
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(podsim)!r})\n"
        "import _bootstrap\n"
        f"_bootstrap.install({str(REPO)!r})\n"
        "import bagua_tpu_torch.contrib.utils.tcp_store\n"
        "import bagua_tpu_torch.elastic.membership, bagua_tpu_torch.elastic.coordinator\n"
        "import bagua_tpu_torch.elastic.failover\n"
        "import bagua_tpu_torch.autopilot.engine, bagua_tpu_torch.autopilot.policy\n"
        "import bagua_tpu_torch.obs.export, bagua_tpu_torch.obs.historian\n"
        "import bagua_tpu_torch.obs.http, bagua_tpu_torch.faults.inject, bagua_tpu_torch.env\n"
        "import bagua_tpu_torch.podsim.shaping, bagua_tpu_torch.podsim.transport\n"
        "import bagua_tpu_torch.podsim.worker, bagua_tpu_torch.podsim.coordinator\n"
        "import bagua_tpu_torch.podsim.collectives\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'bagua_tpu'))\n"
        "print(repr(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd="/", capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _wait(pred, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            value = pred()
        except ConnectionError:
            value = None
        if value:
            return value
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.2)


def test_coordinator_sigkill_standby_takeover(tmp_path):
    world, lease_ttl = 4, 3.0
    ports = reserve_ports(2)
    endpoints = [("127.0.0.1", p) for p in ports]
    ep_str = ",".join(f"{h}:{p}" for h, p in endpoints)
    procs = {}

    def spawn(name, argv):
        with open(tmp_path / f"{name}.log", "ab") as log:
            procs[name] = subprocess.Popen(argv, stdout=log, stderr=subprocess.STDOUT,
                                           start_new_session=True)

    for cid in range(2):
        spawn(f"coord{cid}", [sys.executable, COORDINATOR_PATH, "--store-endpoints", ep_str,
                              "--coord-id", str(cid), "--world", str(world),
                              "--min-nnodes", "1", "--join-window", "20", "--timeout", "90",
                              "--lease-ttl", str(lease_ttl), "--coord-lease-ttl", "1.5"])
    for nid in range(world):
        spawn(f"node{nid}", worker_argv("127.0.0.1", ports[0], nid, world, steps=1,
                                        vec_elems=4096, slice_size=2, timeout_s=90,
                                        store_endpoints=ep_str))
    store = FailoverStore(endpoints, connect_timeout_s=60.0)
    client = MembershipClient(store, 0, world)

    def status():
        raw = store.get(STATUS_KEY)
        return json.loads(raw) if raw else None

    try:
        spec = _wait(lambda: client.read_world(0), 60, "epoch 0's world")
        members = sorted(spec.ranks)
        pre = _wait(lambda: (lambda s: s if s and s["ticks"] >= 8 else None)(status()), 60,
                    "eight ticks of the primary")
        pre_lease = read_coord_lease(store)
        pids = {n: procs[f"node{n}"].pid for n in members}

        t_kill = time.monotonic()
        procs["coord0"].kill()
        procs["coord0"].wait(timeout=10)
        _wait(lambda: (lambda le: le if le and le.get("node") == 1 and le.get("gen", 0) >= 1
                       else None)(read_coord_lease(store)), lease_ttl * 4 + 15, "the standby's lease")
        takeover_s = time.monotonic() - t_kill
        post = _wait(lambda: (lambda s: s if s and s["role"] == "promoted" else None)(status()),
                     30, "the promoted coordinator's status")
        _wait(lambda: sum(v is not None for v in store.mget(
            [f"podsim/{spec.epoch}/ok/{n}" for n in members])) == len(members), 90,
            "every verdict of the epoch")
        assert pre_lease and pre_lease["node"] == 0
        assert post["generation"] >= 1 and post["epoch"] == spec.epoch
        # the takeover came inside the members' lease: no lease expired, no
        # stop was published, no worker restarted
        assert client.read_stop(spec.epoch) is None, takeover_s
        assert all(procs[f"node{n}"].poll() is None for n in members)
        assert {n: procs[f"node{n}"].pid for n in members} == pids
        assert post["autopilot_resumed"] is True
        assert post["historian_loaded_series"] >= 1
        assert post["autopilot_actions_taken"] >= pre["autopilot_actions_taken"]

        client.publish_halt(0, "drill complete")
        codes = {name: p.wait(timeout=30) for name, p in procs.items() if name != "coord0"}
        assert all(codes[f"node{n}"] == 0 for n in members), codes
        assert codes["coord1"] == 0
    finally:
        for p in procs.values():
            if p.poll() is None:
                try:
                    os.kill(p.pid, signal.SIGCONT)
                except OSError:
                    pass
                p.kill()
                p.wait(timeout=10)
        store.close()
