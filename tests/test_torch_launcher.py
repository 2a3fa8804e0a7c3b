"""The port's launcher (``python -m bagua_tpu_torch.distributed.run``)
against the JAX package's.

Mirrors ``tests/test_launcher.py``: ``parse_args`` and ``build_env`` give
the JAX launcher's values for the same argv (apart from the JAX package's
CPU-simulation keys, ``JAX_XLA_KEYS``: no launcher path of the port picks or
remaps a device), and four end-to-end runs of real launchers on the CPU,
each worker ``tests/workers/torch_launch_worker.py`` on the golden task
(``bench.golden_task()``, SGD 0.1, one fixed batch split by the world):

- the gang restart that resumes from a checkpoint: a crash at step 7, one
  restart, a resume; its final loss within 5e-5 of the JAX trainer's
  uninterrupted run (``tests/test_torch_elastic_resume.py``'s gate), and a
  second run that crashes twice restarts twice on the same ``MASTER_PORT``;
- the multi-node coordinated restart (two launchers), and exhausted
  restarts exiting non-zero on both nodes;
- the elastic node loss: a ``1:2`` job at world 2 loses node 1's whole
  process group (SIGKILL), node 0 expires its lease and resumes at world
  1, node 1 comes back as a standby and a coordinated resize returns to
  world 2 (ByteGrad, as the card's drill runs it): worlds ``[2, 1, 2]``, the
  counters ``elastic/lease_expired`` and ``elastic/resizes``, steps run
  twice equal within 1e-5, the last parameters equal on both ranks;
- the watchdog: a host wedge through ``maybe_hang`` inside a watched
  section, ``BAGUA_COMM_TIMEOUT_S=2``: the watchdog dumps the stacks,
  flushes the async save handed to the writer just before the wedge and
  exits 3, the launcher restarts, and the worker resumes from that save.

The JAX originals are ``slow``; here the runs share one module fixture that
starts them all at once (each ``subprocess`` with its own time limit), so
the file costs about the longest run.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import optax
import pytest

import bench
from bagua_tpu.distributed import run as jrun
from bagua_tpu_torch.distributed.run import build_env, parse_args

REPO = Path(__file__).resolve().parents[1]
WORKER = str(REPO / "tests" / "workers" / "torch_launch_worker.py")
RUN_TIMEOUT = 150
#: what only the JAX launcher's ``--simulate_cpu_devices`` sets
JAX_XLA_KEYS = ("JAX_PLATFORMS", "JAX_PLATFORM_NAME", "XLA_FLAGS")
ATOL = 5e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# the command line and the environment, against the JAX launcher
# ---------------------------------------------------------------------------


ARGVS = [
    ["script.py"],
    ["--nnodes", "2", "--node_rank", "1", "--nproc_per_node", "2", "--master_addr", "10.0.0.1",
     "--master_port", "12345", "--bagua_service_port", "23456", "--autotune_level", "1",
     "script.py", "--foo"],
    ["--nnodes", "1:4", "--node_rank", "3", "--join_window", "7", "--lease_ttl", "2",
     "--max_restarts", "5", "--restart_coordinator_port", "999", "script.py"],
    ["--nnodes", "3", "--simulate_cpu_devices", "4", "--no_python", "--autotune_algorithm",
     "--is_output_autotune_log", "--default_bucket_size", "1024", "script.py", "a", "b"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "fixed", "elastic", "simulate"])
def test_parse_args_equals_jax(argv):
    assert vars(parse_args(argv)) == vars(jrun.parse_args(argv))


def test_parse_accepts_elastic_range():
    args = parse_args(["--nnodes", "1:4", "script.py"])
    assert args.elastic and (args.min_nnodes, args.max_nnodes) == (1, 4)
    assert args.nnodes_int == 4
    fixed = parse_args(["--nnodes", "2", "script.py"])
    assert not fixed.elastic and fixed.nnodes_int == 2


def _without_xla(env):
    return {k: v for k, v in env.items() if k not in JAX_XLA_KEYS}


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "fixed", "elastic", "simulate"])
@pytest.mark.parametrize("local_rank", [0, 1])
def test_build_env_equals_jax(monkeypatch, argv, local_rank):
    from bagua_tpu import env as jenv

    for var in jenv.ACCELERATOR_PLUGIN_ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    mine = build_env(parse_args(argv), local_rank=local_rank)
    theirs = jrun.build_env(jrun.parse_args(argv), local_rank=local_rank)
    assert _without_xla(mine) == _without_xla(theirs)
    assert all(mine.get(k) == os.environ.get(k) for k in JAX_XLA_KEYS), \
        "the port's launcher sets no device or platform"


def test_build_env_with_spec_equals_jax():
    from bagua_tpu.elastic.membership import WorldSpec as JWorldSpec
    from bagua_tpu_torch.elastic.membership import WorldSpec

    argv = ["--nnodes", "1:4", "--node_rank", "3", "--nproc_per_node", "2", "script.py"]
    kw = dict(epoch=5, ranks={0: 0, 3: 1}, min_nnodes=1, max_nnodes=4,
              master_addr="127.0.0.1", master_port=29400)
    mine = build_env(parse_args(argv), 1, WorldSpec(**kw))
    theirs = jrun.build_env(jrun.parse_args(argv), 1, JWorldSpec(**kw))
    assert mine == theirs
    assert (mine["RANK"], mine["WORLD_SIZE"], mine["BAGUA_ELASTIC_EPOCH"]) == ("3", "4", "5")


def test_env_injection():
    args = parse_args([
        "--nnodes", "2", "--node_rank", "1", "--nproc_per_node", "2",
        "--master_addr", "10.0.0.1", "--master_port", "12345",
        "--bagua_service_port", "23456", "--autotune_level", "1", "script.py", "--foo"])
    env = build_env(args, local_rank=1)
    assert env["RANK"] == "3" and env["WORLD_SIZE"] == "4" and env["LOCAL_RANK"] == "1"
    assert env["MASTER_ADDR"] == "10.0.0.1"
    assert env["BAGUA_COORDINATOR_ADDR"] == "10.0.0.1:12345"
    assert env["BAGUA_AUTOTUNE"] == "1"
    assert env["AUTO_TUNE_SERVER_ADDR"] == "10.0.0.1:23456"
    assert args.training_script_args == ["--foo"]


def test_init_process_group_joins_the_launchers_rendezvous(monkeypatch):
    """With no ``init_method`` a process of a larger world joins
    ``BAGUA_COORDINATOR_ADDR`` (else ``MASTER_ADDR:MASTER_PORT``); the device
    is the caller's: an explicit ``cuda:0`` stays ``cuda:0`` whatever
    ``LOCAL_RANK`` says (two local ranks on one card), an index-less ``cuda``
    maps to ``cuda:<LOCAL_RANK>``."""
    import torch

    import bagua_tpu_torch.communication as comm

    calls = []
    monkeypatch.setattr(comm.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(comm.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(comm, "_BACKEND", object())
    devices = []
    monkeypatch.setattr(torch.cuda, "set_device", devices.append)
    monkeypatch.setattr(comm, "resolve_device", lambda d: torch.device(d or "cuda"))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "4321")
    monkeypatch.delenv("BAGUA_COORDINATOR_ADDR", raising=False)
    comm.init_process_group(device="cuda:0", backend="gloo")
    assert calls[-1] == ("gloo", {"init_method": "tcp://127.0.0.1:4321", "world_size": 2,
                                  "rank": 1})
    monkeypatch.setenv("BAGUA_COORDINATOR_ADDR", "10.0.0.1:99")
    comm.init_process_group(device="cuda")
    assert calls[-1] == ("nccl", {"init_method": "tcp://10.0.0.1:99", "world_size": 2,
                                  "rank": 1})
    assert devices == [0, 1]
    for var in ("BAGUA_COORDINATOR_ADDR", "MASTER_ADDR"):
        monkeypatch.delenv(var)
    with pytest.raises(ValueError, match="needs an init_method"):
        comm.init_process_group(device="cpu")


# ---------------------------------------------------------------------------
# end-to-end launcher runs (all started at once by one fixture)
# ---------------------------------------------------------------------------


def _launcher(flags, worker_args, log, env=None):
    cmd = [sys.executable, "-m", "bagua_tpu_torch.distributed.run", "--monitor_interval", "0.2",
           *flags, WORKER, *worker_args]
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=open(log, "w"),
                            stderr=subprocess.STDOUT, start_new_session=True)


def _base_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BAGUA_TEST_", "BAGUA_ELASTIC", "BAGUA_FAULT"))}
    env.update(OMP_NUM_THREADS="1", BAGUA_COMM_TIMEOUT_S="60",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    env.update(extra)
    return env


def _wait_procs(procs, timeout):
    deadline = time.monotonic() + timeout
    try:
        return [p.wait(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()


def _worker_args(tmp, steps, save_every=2, algo="ga"):
    (tmp / "out").mkdir(exist_ok=True)
    return ["--data", str(tmp.parent / "data.npz"), "--params", str(tmp.parent / "params.npz"),
            "--ckpt-dir", str(tmp / "ck"), "--out", str(tmp / "out"), "--steps", str(steps),
            "--save-every", str(save_every), "--algo", algo]


def _gang(tmp, crash_at, max_restarts=2):
    log = tmp / "launcher.log"
    p = _launcher(["--max_restarts", str(max_restarts), "--master_port", str(_free_port())],
                  _worker_args(tmp, 12) + ["--crash-at-step", crash_at], log, _base_env())
    return {"rc": _wait_procs([p], RUN_TIMEOUT)[0], "log": log.read_text()}


def _multinode(tmp, node1_env, max_restarts):
    master, coord = _free_port(), _free_port()
    procs = []
    for node in (0, 1):
        flags = ["--nnodes", "2", "--node_rank", str(node), "--nproc_per_node", "1",
                 "--master_port", str(master), "--restart_coordinator_port", str(coord),
                 "--max_restarts", str(max_restarts), "--restart_barrier_timeout", "60"]
        env = _base_env(**(node1_env if node == 1 else {}))
        procs.append(_launcher(flags, _worker_args(tmp, 12), tmp / f"node{node}.log", env))
        if node == 0:
            time.sleep(0.5)
    rcs = _wait_procs(procs, RUN_TIMEOUT)
    return {"rcs": rcs, "logs": [(tmp / f"node{n}.log").read_text() for n in (0, 1)]}


def _records(out):
    recs = []
    for path in sorted(Path(out).glob("steps_rank*.jsonl")):
        for line in path.read_text().splitlines():
            try:
                recs.append(json.loads(line))
            except ValueError:   # a line still being written
                pass
    return recs


def _until(pred, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.1)
    raise AssertionError("timed out")


def _elastic(tmp):
    master, coord = _free_port(), _free_port()
    out = tmp / "out"
    wargs = _worker_args(tmp, 40, save_every=1, algo="bytegrad")

    def launch(node):
        env = _base_env(BAGUA_TEST_STEP_DELAY="0.2",
                        BAGUA_ELASTIC_TELEMETRY_OUT=str(tmp / f"telemetry{node}.json"))
        flags = ["--nnodes", "1:2", "--node_rank", str(node), "--nproc_per_node", "1",
                 "--master_port", str(master), "--restart_coordinator_port", str(coord),
                 "--max_restarts", "3", "--join_window", "6", "--lease_ttl", "4"]
        log = tmp / f"node{node}.log"
        with open(log, "a") as f:
            f.write(f"--- launch of node {node}\n")
        cmd = [sys.executable, "-m", "bagua_tpu_torch.distributed.run", "--monitor_interval",
               "0.2", *flags, WORKER, *wargs]
        return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=open(log, "a"),
                                stderr=subprocess.STDOUT, start_new_session=True)

    p0 = launch(0)
    time.sleep(0.5)
    p1 = launch(1)
    procs = [p0, p1]
    try:
        _until(lambda: sum(r["world"] == 2 and r["rank"] == 1 for r in _records(out)) >= 3, 90)
        os.killpg(p1.pid, signal.SIGKILL)   # node 1 lost: its launcher and its worker
        p1.wait()
        _until(lambda: any(r["world"] == 1 for r in _records(out)), 90)
        n2 = sum(r["world"] == 2 for r in _records(out))
        p1 = launch(1)   # back as a standby: a coordinated resize to world 2
        procs = [p0, p1]
        _until(lambda: sum(r["world"] == 2 for r in _records(out)) > n2, 90)
        rcs = _wait_procs(procs, RUN_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
    return {"rcs": rcs, "records": _records(out),
            "telemetry": json.loads((tmp / "telemetry0.json").read_text()),
            "finals": [json.loads((out / f"final_rank{r}.json").read_text()) for r in (0, 1)],
            "log0": (tmp / "node0.log").read_text()}


def _watchdog(tmp):
    log = tmp / "launcher.log"
    env = _base_env(BAGUA_COMM_TIMEOUT_S="2", BAGUA_TEST_WEDGE_AT_STEP="5")
    p = _launcher(["--max_restarts", "1", "--master_port", str(_free_port())],
                  _worker_args(tmp, 12), log, env)
    return {"rc": _wait_procs([p], RUN_TIMEOUT)[0], "log": log.read_text(),
            "final": json.loads((tmp / "out" / "final_rank0.json").read_text())
            if (tmp / "out" / "final_rank0.json").exists() else None}


def _jax_golden(steps):
    """The JAX trainer's uninterrupted losses on the golden task at world 1."""
    import jax
    from bagua_tpu.algorithms.gradient_allreduce import GradientAllReduceAlgorithm as JGA
    from bagua_tpu.core.backend import BaguaTrainer as JTrainer
    from bagua_tpu.parallel.mesh import build_mesh

    loss_fn, params, batch = bench.golden_task()
    trainer = JTrainer(loss_fn, optax.sgd(0.1), JGA(),
                       mesh=build_mesh({"dp": 1}, devices=jax.devices()[:1]), autotune=False)
    state = trainer.init(params)
    data = trainer.shard_batch(batch)
    losses = []
    for _ in range(steps):
        state, loss = trainer.train_step(state, data)
        losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("launcher")
    _, params, batch = bench.golden_task()
    np.savez(root / "data.npz", x=np.asarray(batch["x"]), y=np.asarray(batch["y"]))
    np.savez(root / "params.npz", **{f"{layer}.{k}": np.asarray(v)
                                     for layer, leaves in params.items()
                                     for k, v in leaves.items()})
    scenarios = {
        "gang": lambda t: _gang(t, "7"),
        "twice": lambda t: _gang(t, "5,9"),
        "multinode": lambda t: _multinode(t, {"BAGUA_TEST_CRASH_AT_STEP": "5"}, 2),
        "exhausted": lambda t: _multinode(t, {"BAGUA_TEST_CRASH_AT_STEP": "3",
                                              "BAGUA_TEST_CRASH_EVERY": "1"}, 1),
        "elastic": _elastic,
        "watchdog": _watchdog,
    }
    results = {}

    def one(name, fn):
        tmp = root / name
        tmp.mkdir()
        try:
            results[name] = fn(tmp)
        except BaseException as e:  # noqa: BLE001 - reported by the test that reads it
            results[name] = e

    threads = [threading.Thread(target=one, args=item) for item in scenarios.items()]
    for t in threads:
        t.start()
    golden = _jax_golden(12)
    for t in threads:
        t.join()
    results["golden"] = golden
    results["root"] = root
    return results


def _result(runs, name):
    r = runs[name]
    if isinstance(r, BaseException):
        raise r
    return r


def _final(runs, name):
    return json.loads((runs["root"] / name / "out" / "final_rank0.json").read_text())


def test_gang_restart_resumes_from_checkpoint(runs):
    r = _result(runs, "gang")
    assert r["rc"] == 0, r["log"][-2000:]
    assert "injected crash at step 7" in r["log"]
    assert "gang restart 1/2" in r["log"]
    assert "resumed from checkpoint step" in r["log"]
    final = _final(runs, "gang")
    np.testing.assert_allclose(final["final_loss"], runs["golden"][-1], rtol=0, atol=ATOL)


def test_gang_restarts_twice_on_the_same_port(runs):
    """Two crashes, two restarts: each respawned gang binds the same
    ``MASTER_PORT`` (the dead gang's rendezvous died with its rank 0) and
    resumes from the newest durable checkpoint; the final state equals the
    single-crash run's, bitwise."""
    r = _result(runs, "twice")
    assert r["rc"] == 0, r["log"][-2000:]
    assert "gang restart 1/2" in r["log"] and "gang restart 2/2" in r["log"]
    assert r["log"].count("resumed from checkpoint step") == 2
    assert _final(runs, "twice")["digest"] == _final(runs, "gang")["digest"]


def test_multinode_coordinated_gang_restart(runs):
    r = _result(runs, "multinode")
    out0, out1 = r["logs"]
    assert r["rcs"] == [0, 0], out0[-2000:] + out1[-2000:]
    assert "injected crash at step 5" in out1
    assert "coordinated restart" in out0 and "coordinated restart" in out1
    assert "resumed from checkpoint step" in out0
    out = runs["root"] / "multinode" / "out"
    finals = [json.loads((out / f"final_rank{r}.json").read_text()) for r in (0, 1)]
    assert finals[0]["digest"] == finals[1]["digest"]
    assert finals[0]["final_loss"] == finals[1]["final_loss"]


def test_multinode_exhausted_restarts_exit_nonzero(runs):
    r = _result(runs, "exhausted")
    out0, out1 = r["logs"]
    assert r["rcs"][0] not in (0, None) and r["rcs"][1] not in (0, None), r["rcs"]
    assert "max_restarts=1 exhausted" in out1


def test_elastic_node_loss_resize_down_then_rejoin_resize_up(runs):
    r = _result(runs, "elastic")
    assert r["rcs"] == [0, 0], r["log0"][-3000:]
    worlds = [t["nnodes"] for t in r["telemetry"]["transitions"]]
    assert worlds == [2, 1, 2], worlds
    counters = r["telemetry"]["counters"]
    assert counters.get("elastic/lease_expired", 0) == 1
    assert counters.get("elastic/resizes", 0) >= 1
    assert "lease_expired" in r["log0"] and "resumed from checkpoint step" in r["log0"]
    by_step, epochs = {}, {}
    for rec in r["records"]:
        by_step.setdefault(rec["step"], []).append(rec["loss"])
        epochs.setdefault(rec["step"], set()).add(rec["epoch"])
    # every step that ran twice (before a stop and again after the resume)
    # gives the same loss up to the reassociation of another world's sums
    assert any(len(e) > 1 for e in epochs.values()), "no step ran twice"
    for step, losses in by_step.items():
        np.testing.assert_allclose(losses, losses[0], rtol=1e-5, err_msg=f"step {step}")
    assert r["finals"][0]["digest"] == r["finals"][1]["digest"]
    assert r["finals"][0]["world"] == r["finals"][1]["world"] == 2


def test_watchdog_hang_restart_resume(runs):
    """The watchdog's whole chain: wedge, stacks, the flushed save, exit 3,
    the launcher's restart, the resume from the save handed to the writer
    just before the wedge (step 4, saved every 2 steps), not an earlier one."""
    r = _result(runs, "watchdog")
    log = r["log"]
    assert r["rc"] == 0, log[-3000:]
    assert "injecting host wedge at step 5" in log
    assert "watchdog: section 'train_step[5]' stuck" in log
    assert "most recent call first" in log
    assert "worker failed (exit 3); gang restart 1/1" in log
    assert "resumed from checkpoint step 4" in log
    assert r["final"]["resumed_from"] == 4
    assert r["final"]["digest"] == _final(runs, "gang")["digest"]


# ---- the coordinator's control plane (``run.py:673-737, 895-925``) ---------


class _DoneProc:
    """A worker that already exited 0."""

    def poll(self):
        return 0

    def wait(self, timeout=None):
        return 0

    def send_signal(self, sig):
        pass

    def kill(self):
        pass


def _control_plane(monkeypatch, tmp_path, mode):
    """One monitor tick of the coordinator over two nodes whose node 1
    carries a chronic dispatch straggler, with the autopilot in ``mode``,
    the historian on and the HTTP plane serving."""
    from types import SimpleNamespace

    from bagua_tpu_torch.contrib.utils.store import InMemoryStore
    from bagua_tpu_torch.distributed import run as run_mod
    from bagua_tpu_torch.elastic.membership import MembershipClient
    from bagua_tpu_torch.obs import http as obs_http

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setattr(obs_http, "_GLOBAL_SERVER", None)
    for k, v in {"BAGUA_AUTOPILOT": mode, "BAGUA_OBS_HISTORIAN": "on",
                 "BAGUA_OBS_HTTP_PORT": str(port), "BAGUA_AUTOPILOT_SUSTAIN": "1",
                 "BAGUA_OBS_DUMP_DIR": str(tmp_path / "dumps")}.items():
        monkeypatch.setenv(k, v)
    store = InMemoryStore()
    client = MembershipClient(store, 0, 2)
    args = SimpleNamespace(min_nnodes=1, max_nnodes=2, master_addr="127.0.0.1",
                           master_port=1, join_window=3.0, restart_barrier_timeout=9.0,
                           bagua_service_port=_free_port(), monitor_interval=0.01,
                           lease_ttl=5.0, node_rank=0)
    stack = run_mod._build_coordinator_stack(args, store, client)
    now = time.time()
    health = {0: {"obs": {"rank": 0, "step": 10, "goodput_fraction": 0.9}},
              1: {"obs": {"rank": 1, "step": 10, "goodput_fraction": 0.9,
                          "straggler_suspect": {"rank": 1, "step": 10, "ratio": 10.0,
                                                "dominant_phase": "dispatch",
                                                "detected_at_unix": now}}}}
    tracker = SimpleNamespace(poll=lambda: [], health_of=health.get,
                              unhealthy_members=lambda: [])
    spec = SimpleNamespace(epoch=0, ranks=[0, 1], nnodes=2, max_nnodes=2)
    return run_mod, args, client, spec, tracker, stack


def test_coordinator_serves_fleet_and_history_and_observe_actuates_nothing(monkeypatch,
                                                                           tmp_path):
    import urllib.request

    run_mod, args, client, spec, tracker, stack = _control_plane(monkeypatch, tmp_path,
                                                                 "observe")
    coordinator, autopilot, historian, holder, http_server = stack
    coordinator = type("C", (), {"standby_ids": lambda self, spec: []})()
    try:
        rc = run_mod.monitor_elastic(args, [_DoneProc()], client, spec, coordinator, tracker,
                                     autopilot=autopilot, historian=historian,
                                     fleet_holder=holder)
        assert rc == 0
        # observe: decided and flight-recorded, not actuated
        dumps = list((tmp_path / "dumps").glob("flight_autopilot_action_*.json"))
        assert dumps
        rec = json.load(open(dumps[0]))
        assert rec["extra"]["action"]["kind"] == "fence" and rec["extra"]["mode"] == "observe"
        assert client.read_stop(0) is None
        assert autopilot.state.actions_taken == 1
        with urllib.request.urlopen(http_server.url + "/fleet", timeout=10) as r:
            fleet = json.loads(r.read())
        assert fleet["ranks"]["1"]["obs"]["1"]["straggler_suspect"]["ratio"] == 10.0
        # the record went through the historian on its way to /fleet
        assert ("1", "goodput_fraction") in historian.metrics()
        with urllib.request.urlopen(http_server.url + "/history?metric=goodput_fraction",
                                    timeout=10) as r:
            report = json.loads(r.read())
        assert set(report["ranks"]) == {"0", "1"}
    finally:
        http_server.stop()


def test_coordinator_act_mode_fences_through_the_gang_stop(monkeypatch, tmp_path):
    run_mod, args, client, spec, tracker, stack = _control_plane(monkeypatch, tmp_path, "act")
    coordinator, autopilot, historian, holder, http_server = stack
    coordinator = type("C", (), {"standby_ids": lambda self, spec: []})()
    try:
        with pytest.raises(run_mod._GangStop) as e:
            run_mod.monitor_elastic(args, [_DoneProc()], client, spec, coordinator, tracker,
                                    autopilot=autopilot, historian=historian,
                                    fleet_holder=holder)
        assert e.value.nodes == [1] and not e.value.rejoin
        stop = client.read_stop(0)
        assert stop["kind"] == "health_fenced" and "autopilot fence" in stop["reason"]
        assert list((tmp_path / "dumps").glob("flight_health_fence_*.json"))
    finally:
        http_server.stop()


def test_launcher_hands_quarantines_to_the_respawn(monkeypatch):
    """Every launcher reads the act-mode engine's storage-quarantine
    verdicts off the restart store and injects them into the respawned
    workers' environment (``run.py:1187-1191``)."""
    from bagua_tpu_torch.autopilot.engine import QUARANTINE_STORE_KEY, read_actuated_quarantines
    from bagua_tpu_torch.contrib.utils.store import InMemoryStore
    from bagua_tpu_torch.distributed.run import build_env, parse_args

    store = InMemoryStore()
    assert read_actuated_quarantines(store) == []
    store.set(QUARANTINE_STORE_KEY, "/ckpt/a\ngs://bucket/b\n")
    paths = read_actuated_quarantines(store)
    env = build_env(parse_args(["--nnodes", "1", "script.py"]), 0,
                    quarantined_ckpt_paths=paths)
    assert env["BAGUA_CKPT_QUARANTINED_PATHS"] == "/ckpt/a\ngs://bucket/b"
