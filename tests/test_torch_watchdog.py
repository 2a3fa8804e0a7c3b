"""The port's hang watchdog (``bagua_tpu_torch/watchdog.py``) and the abort
flag it raises, against the JAX package.

Mirrors ``tests/test_abort.py`` and the watchdog cases of
``tests/test_faults.py`` (``:393-515``): on by default at 300 s and the
opt-out (the env accessor's values equal to the JAX package's); a wedged
step that aborts, stops async model average and recovers after
``reset_abort``; a user abort stopping async; the eager collectives fenced;
a clean interpreter exit with the default-on watchdog; nested watch
sections; the stricter timeout adopted; an injected ``collective.hang`` that
fires and recovers; the abort recovery of an overlapped flat-resident
trainer, twice (the watchdog re-arms).  Plus what is the port's own: a
gloo peer stalled inside its step, whose survivor's watchdog fires from the
communicator's watched section; the fence the waiter keeps (an event for a
CUDA result, nothing for a CPU one, so the waiter pins no tensor), and the
trainer's ``train_step`` and ``eval_step`` handing their results to the
global watchdog.
"""

import json
import logging
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import bagua_tpu_torch as bt
import bagua_tpu_torch.watchdog as wdmod
from bagua_tpu import env as jenv
from bagua_tpu import watchdog as jwatchdog
from bagua_tpu_torch import env
from bagua_tpu_torch.faults import inject
from bagua_tpu_torch.faults.inject import FaultSpec, fault_scope
from bagua_tpu_torch.models.mlp import MLP
from bagua_tpu_torch.telemetry import counters
from bagua_tpu_torch.watchdog import HangWatchdog, get_comm_timeout_s

REPO = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def process_group():
    bt.init_process_group(device="cpu")


@pytest.fixture(autouse=True)
def _clean():
    inject.clear_plan()
    bt.reset_abort()
    yield
    inject.clear_plan()
    bt.reset_abort()


def _delta(before, name):
    return counters.get(name) - before.get(name, 0)


def _wait(pred, timeout_s=10.0):
    deadline = time.time() + timeout_s
    while not pred() and time.time() < deadline:
        time.sleep(0.02)
    return pred()


def _make_trainer(algo=None, **kw):
    trainer = bt.BaguaTrainer(lambda m, b: torch.nn.functional.cross_entropy(m(b["x"]), b["y"]),
                              lambda p: torch.optim.SGD(p, lr=0.1),
                              algo or bt.GradientAllReduceAlgorithm(), device="cpu",
                              bucket_bytes=256, **kw)
    state = trainer.init(MLP(4, features=(16, 8), device="cpu"))
    rng = np.random.default_rng(0)
    batch = {"x": torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32)),
             "y": torch.from_numpy(rng.integers(0, 8, size=16))}
    return trainer, state, batch


class _NeverReady:
    """A result whose readback blocks for 2 s (the wedged collective)."""

    def __array__(self, dtype=None, copy=None):
        time.sleep(2.0)
        return np.zeros(())


def test_watchdog_on_by_default(monkeypatch):
    monkeypatch.delenv("BAGUA_COMM_TIMEOUT_S", raising=False)
    assert get_comm_timeout_s() == 300.0 == jwatchdog.get_comm_timeout_s()
    trainer, state, batch = _make_trainer()
    assert trainer._watchdog is wdmod._GLOBAL and trainer._watchdog.timeout_s <= 300.0
    state, loss = trainer.train_step(state, batch)
    assert float(loss) > 0


def test_watchdog_opt_out(monkeypatch):
    for value, want in (("0", None), ("off", None), ("120", 120.0)):
        monkeypatch.setenv("BAGUA_COMM_TIMEOUT_S", value)
        assert get_comm_timeout_s() == want == jwatchdog.get_comm_timeout_s()
    monkeypatch.setenv("BAGUA_COMM_TIMEOUT_S", "off")
    trainer, _, _ = _make_trainer()
    assert trainer._watchdog is None


def test_wedged_step_aborts_and_recovers():
    """A wedged result trips the watchdog; the abort flag stops new steps
    and async model average's rounds; ``reset_abort`` recovers."""
    algo = bt.AsyncModelAverageAlgorithm(sync_interval_ms=1, warmup_steps=0)
    trainer, state, batch = _make_trainer(algo)
    wd = HangWatchdog(timeout_s=0.3, action="abort")
    try:
        state, loss = trainer.train_step(state, batch)
        wd.watch_result(_NeverReady(), "wedged_allreduce")
        assert _wait(wd.fired.is_set), "the watchdog never fired on the wedge"
        assert bt.is_aborted()
        with pytest.raises(bt.BaguaAborted):
            trainer.train_step(state, batch)
        state2 = algo.host_pre_step(trainer, state)
        assert algo._pending is None
        bt.reset_abort()
        state, loss = trainer.train_step(state2, batch)
        assert float(loss) > 0
    finally:
        algo.abort()
        wd.stop()


def test_user_abort_stops_async_loop():
    algo = bt.AsyncModelAverageAlgorithm(sync_interval_ms=1, warmup_steps=0)
    trainer, state, batch = _make_trainer(algo)
    try:
        state, _ = trainer.train_step(state, batch)
        bt.abort("test abort")
        state = algo.host_pre_step(trainer, state)
        assert algo._pending is None
        bt.reset_abort()
    finally:
        algo.abort()


def test_eager_collectives_are_watchdog_fenced(monkeypatch):
    """Every eager call runs inside a watched section and hands its result
    to the waiter, and fails fast once the abort flag is up."""
    wd = HangWatchdog(timeout_s=300, action="log")
    results, sections = [], []
    orig_result, orig_watch = wd.watch_result, wd.watch
    monkeypatch.setattr(wd, "watch_result",
                        lambda r, label="": (results.append(label), orig_result(r, label)))
    monkeypatch.setattr(wd, "watch", lambda label="": (sections.append(label),
                                                       orig_watch(label))[1])
    monkeypatch.setattr(wdmod, "_GLOBAL", wd)
    monkeypatch.delenv("BAGUA_COMM_TIMEOUT_S", raising=False)
    try:
        out = bt.allreduce(torch.ones(4))
        assert torch.equal(out, torch.ones(4))
        bt.barrier()
        assert results == ["eager:allreduce"]
        # the call's own sections (the waiter opens one a result too)
        assert {"eager:allreduce", "eager:barrier"} <= set(sections)
        bt.abort("test")
        with pytest.raises(bt.BaguaAborted):
            bt.allreduce(torch.ones(4))
        bt.reset_abort()
    finally:
        wd.stop()


def test_eager_collectives_unwatched_when_off(monkeypatch):
    monkeypatch.setenv("BAGUA_COMM_TIMEOUT_S", "off")
    monkeypatch.setattr(wdmod, "get_global_watchdog",
                        lambda t: pytest.fail("watchdog built with the timeout off"))
    assert torch.equal(bt.allreduce(torch.ones(3)), torch.ones(3))


def test_trainer_hands_steps_and_evals_to_the_watchdog(monkeypatch):
    trainer, state, batch = _make_trainer()
    seen = []
    monkeypatch.setattr(trainer._watchdog, "watch_result",
                        lambda r, label="": seen.append((label, type(r).__name__)))
    state, _ = trainer.train_step(state, batch)
    state, _ = trainer.train_step(state, batch)
    trainer.eval_step(state, batch)
    assert seen == [("train_step[1]", "Tensor"), ("train_step[2]", "Tensor"),
                    ("eval_step", "Tensor")]


def test_waiter_keeps_only_the_fence():
    """A CPU result has finished when the call returns: the waiter keeps no
    tensor (a step's memory is never pinned by the watchdog); other objects
    are waited on as given."""
    big = torch.zeros(1 << 20)
    assert wdmod._fence_of(big) is None
    marker = object()
    assert wdmod._fence_of(marker) is marker
    wd = HangWatchdog(timeout_s=300, action="log")
    try:
        wd.watch_result(big, "step")
        assert _wait(lambda: wd._queue.empty())
    finally:
        wd.stop()


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_cuda_result_fenced_by_event():
    fence = wdmod._fence_of(torch.ones(2, device="cuda"))
    assert isinstance(fence, torch.cuda.Event)
    wdmod._wait_on(fence)
    assert fence.query()


def test_clean_interpreter_exit_with_watchdog(tmp_path):
    """A script with the default-on watchdog exits 0: the waiter is stopped
    through atexit before the interpreter tears down."""
    script = tmp_path / "drive.py"
    script.write_text(
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import numpy as np, torch\n"
        "import bagua_tpu_torch as bt\n"
        "from bagua_tpu_torch.models.mlp import MLP\n"
        "bt.init_process_group(device='cpu')\n"
        "tr = bt.BaguaTrainer(lambda m, b: torch.nn.functional.cross_entropy(m(b['x']), b['y']),\n"
        "                     lambda p: torch.optim.SGD(p, lr=0.1), bt.GradientAllReduceAlgorithm(),\n"
        "                     device='cpu')\n"
        "state = tr.init(MLP(4, features=(16, 8), device='cpu'))\n"
        "batch = {'x': torch.zeros(16, 4), 'y': torch.zeros(16, dtype=torch.int64)}\n"
        "assert tr._watchdog is not None\n"
        "for _ in range(10):\n"
        "    state, loss = tr.train_step(state, batch)\n"
        "print('done', float(loss))\n")
    env_ = {k: v for k, v in __import__("os").environ.items() if k != "BAGUA_COMM_TIMEOUT_S"}
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         timeout=120, env=env_)
    assert out.returncode == 0, out.stdout[-500:] + out.stderr[-500:]
    assert "done" in out.stdout


def test_nested_watch_keeps_outer_section():
    wd = HangWatchdog(timeout_s=300, action="log")
    try:
        with wd.watch("outer"):
            with wd.watch("inner"):
                assert len(wd._active) == 2
            assert [label for label, _ in wd._active.values()] == ["outer"]
    finally:
        wd.stop()
    assert not wd._active


def test_global_watchdog_adopts_stricter_timeout(monkeypatch, caplog):
    monkeypatch.setattr(wdmod, "_GLOBAL", None)
    wd = wdmod.get_global_watchdog(300.0)
    try:
        with caplog.at_level(logging.WARNING, logger="bagua_tpu_torch.watchdog"):
            wd2 = wdmod.get_global_watchdog(120.0)
            assert wd2 is wd and wd.timeout_s == 120.0
            assert wdmod.get_global_watchdog(600.0).timeout_s == 120.0
        assert sum("stricter" in r.message for r in caplog.records) == 2
    finally:
        wd.stop()


def test_injected_hang_fires_watchdog_and_recovers(monkeypatch):
    """``collective.hang`` wedges the waiter inside its watched section; the
    monitor fires and raises the abort flag; the bounded hang clears the
    section; ``reset_abort`` records the recovery."""
    monkeypatch.setenv("BAGUA_COMM_TIMEOUT_S", "off")
    wd = HangWatchdog(timeout_s=0.3, action="abort")
    before = counters.snapshot()
    try:
        with fault_scope(FaultSpec("collective.hang", duration_s=2.5)):
            wd.watch_result(np.zeros(()), "wedged-step")
            assert _wait(wd.fired.is_set), "the watchdog never fired on the hang"
            assert bt.is_aborted()
            assert _wait(lambda: not wd._active)
            bt.reset_abort()
            assert _delta(before, "faults/collective.hang/fired") == 1
            assert _delta(before, "faults/collective.hang/recovered") == 1
    finally:
        wd.stop()


def test_abort_recovery_resumes_overlap_flat_trainer(monkeypatch):
    """Abort, ``reset_abort``, resume on the overlapped flat-resident step,
    twice: the second episode proves the watchdog re-arms."""
    monkeypatch.setenv("BAGUA_COMM_TIMEOUT_S", "off")
    t, s, b = _make_trainer(accum_steps=2, overlap="on", flat_resident="on")
    s, _ = t.train_step(s, b)
    wd = HangWatchdog(timeout_s=0.3, action="abort")
    try:
        for episode in range(2):
            assert _wait(lambda: wd._armed), f"never re-armed before episode {episode}"
            with fault_scope(FaultSpec("collective.hang", duration_s=1.2)):
                wd.fired.clear()
                wd.watch_result(np.zeros(()), f"wedge-{episode}")
                assert _wait(bt.is_aborted), f"episode {episode} never raised the abort flag"
                assert wd.fired.is_set()
                with pytest.raises(bt.BaguaAborted):
                    t.train_step(s, b)
                assert _wait(lambda: not wd._active)
            bt.reset_abort()
            for _ in range(2):
                s, loss = t.train_step(s, b)
            assert np.isfinite(float(loss))
    finally:
        wd.stop()


_STALL_SCRIPT = """
import json, sys, time
sys.path.insert(0, {repo!r})
import numpy as np, torch
import bagua_tpu_torch as bt
from bagua_tpu_torch.models.mlp import MLP
rank, port, stall_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
bt.init_process_group(init_method=f"tcp://127.0.0.1:{{port}}", world_size=2, rank=rank,
                      device="cpu")
calls = []

def loss_fn(model, batch):
    calls.append(1)
    if rank == 1 and len(calls) == 2:
        # a hung peer that keeps its socket open: rank 0 blocks in the step's
        # gradient allreduce
        with open(stall_path, "w") as f:
            json.dump({{"t": time.time()}}, f)
        time.sleep(120)
    return torch.nn.functional.cross_entropy(model(batch["x"]), batch["y"])

tr = bt.BaguaTrainer(loss_fn, lambda p: torch.optim.SGD(p, lr=0.1),
                     bt.GradientAllReduceAlgorithm(), device="cpu", bucket_bytes=256)
state = tr.init(MLP(4, features=(16, 8), device="cpu"))
rng = np.random.default_rng(rank)
batch = {{"x": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)),
         "y": torch.from_numpy(rng.integers(0, 8, size=8))}}
for i in range(3):
    state, loss = tr.train_step(state, batch)
    print("step", i, float(loss), flush=True)
"""


def test_peer_stalled_in_its_step_fires_the_survivors_watchdog(tmp_path):
    """Two gloo ranks; rank 1 stalls inside its second step's loss with its
    socket open.  Rank 0 blocks in that step's gradient allreduce, inside
    the communicator's watched section, and its watchdog ends it with exit
    3 within the timeout (2 s, the monitor's 1 s tick, the exit), not after
    the peer's 120 s or gloo's own 30 min."""
    import os
    import socket

    script, stall = tmp_path / "stall.py", tmp_path / "stall.json"
    script.write_text(_STALL_SCRIPT.format(repo=str(REPO)))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env_ = dict(os.environ, BAGUA_COMM_TIMEOUT_S="2", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(port), str(stall)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env_) for r in (0, 1)]
    try:
        out, err = procs[0].communicate(timeout=90)
        ended = time.time()
    finally:
        for p in procs:
            p.kill()
            p.communicate()
    assert procs[0].returncode == 3, out[-500:] + err[-2000:]
    assert "step 0" in out and "step 1" not in out
    assert "watchdog: section 'comm.allreduce' stuck" in err, err[-2000:]
    assert "most recent call first" in err
    stalled = json.loads(stall.read_text())["t"]
    assert ended - stalled < 15.0, f"rank 0 exited {ended - stalled:.1f} s after the stall"


@pytest.mark.parametrize("value", [None, "0", "off", "FALSE", "none", "no", "", "42.5", "300"])
def test_env_seconds_or_off_accessor(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("BAGUA_COMM_TIMEOUT_S", raising=False)
    else:
        monkeypatch.setenv("BAGUA_COMM_TIMEOUT_S", value)
    want = jenv.env_seconds_or_off("BAGUA_COMM_TIMEOUT_S")
    assert env.env_seconds_or_off("BAGUA_COMM_TIMEOUT_S") == want
    assert get_comm_timeout_s() == want


def test_env_seconds_or_off_rejects_garbage(monkeypatch):
    monkeypatch.setenv("BAGUA_COMM_TIMEOUT_S", "soon")
    with pytest.raises(ValueError, match="BAGUA_COMM_TIMEOUT_S"):
        env.env_seconds_or_off("BAGUA_COMM_TIMEOUT_S")


def test_exit_action_flushes_and_exits_3(tmp_path):
    """``action="exit"``: the stacks on stderr, an async save handed to the
    writer just before the wedge made durable by the flush, exit code 3."""
    script = tmp_path / "wedge.py"
    ck = tmp_path / "ck"
    script.write_text(
        "import sys, time\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import torch\n"
        "import bagua_tpu_torch as bt\n"
        "from bagua_tpu_torch.watchdog import HangWatchdog\n"
        f"mgr = bt.BaguaCheckpointManager({str(ck)!r}, async_save=True)\n"
        "mgr.save(3, {'w': torch.arange(1 << 16, dtype=torch.float32)})\n"
        "wd = HangWatchdog(timeout_s=0.5)\n"
        "with wd.watch('wedged'):\n"
        "    time.sleep(60)\n")
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 3, out.stderr[-1000:]
    assert "most recent call first" in out.stderr and "stuck for" in out.stderr
    mgr = bt.BaguaCheckpointManager(str(ck))
    assert mgr.latest_step() == 3
    step, tree = mgr.restore({"w": torch.zeros(1 << 16)})
    assert step == 3 and torch.equal(tree["w"], torch.arange(1 << 16, dtype=torch.float32))
