"""The port's trainer with the autotune service (``BaguaTrainer(autotune=,
model_name=)``, ``_apply_recommendation`` and its migrations).

Mirrors ``tests/test_autotune_integration.py``:

- the round trip at world 1: the trainer registers its tensors at ``init``,
  checks in every 100 steps with a nonzero automatic speed, applies the
  recommended rebucketing, and the search completes;
- at world 2 over gloo (``tests/workers/torch_autotune_worker.py``): rank
  0's ``init_process_group`` starts the sidecar from ``BAGUA_SERVICE_PORT``;
  a rebucket by recommendation, where the plan signature is equal on both
  ranks at every step and the losses and parameters are bitwise those of
  an untuned trainer (gloo sums the same two values whatever the buckets);
- the QAdam switch and back (its momenta adopted from Adam's ``exp_avg``,
  its warmup re-anchored at the switch, Adam's state restored), on the
  resident and the leaf layout, the ranks bitwise equal;
- async model average there and back.  The JAX package stacks the
  replicated state into one row a device on the way in; each rank of the
  port holds its own weights in both families, so the way in moves
  nothing, and the way out is one catch-up average after which the ranks
  are bitwise equal again;
- ``_sync_ef_state``: ``compress_intra="onebit_ef"`` adds a zero-filled
  residual (one f32 a bucket element), ``"off"`` drops it;
- with autotune off the step is the same whatever the autotune settings
  (the JAX package pins its traced program; here the parameters are
  bitwise equal);
- a fixed sequence of recommendations (a rebucket, a switch to ByteGrad,
  back, the overlap scheduler on) applied to both packages' trainers on the
  golden task at world 2, their losses within 1e-5 relative until ByteGrad,
  1e-3 after (the tolerances of the port's trainer parity tests:
  ``tests/test_torch_flat_resident.py``).
"""

import functools
import json
import os
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import optax
import pytest
import torch

import bench
import bagua_tpu_torch as bt
from bagua_tpu.algorithms import GradientAllReduceAlgorithm as JGA
from bagua_tpu.core.backend import BaguaTrainer as JTrainer
from bagua_tpu.define import BaguaHyperparameter as JHyper
from bagua_tpu.parallel.mesh import build_mesh
from bagua_tpu_torch.define import BaguaHyperparameter
from bagua_tpu_torch.models.mlp import MLP
from bagua_tpu_torch.service.autotune_service import AutotuneService, make_server

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "workers",
                      "torch_autotune_worker.py")
RUNS = ("tuned", "qadam", "qadam:leaf", "async", "ef", "sequence")
_OUT = {}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_decls(bucket_bytes):
    """The golden task's tensor declarations as the JAX trainer's plan
    names them, split at ``bucket_bytes``."""
    from bagua_tpu.bucket import split_bucket_by_bucket_size as jsplit

    loss_fn, params, _ = bench.golden_task()
    t = JTrainer(loss_fn, optax.sgd(0.1), JGA(), mesh=build_mesh({"dp": 2}, jax.devices()[:2]),
                 autotune=False)
    t.init(params)
    decls = [d for b in t._plan.buckets for d in (x.declaration() for x in b.tensors)]
    return [[d.model_dump(mode="json") for d in b] for b in jsplit(decls, bucket_bytes)]


def _sequence():
    return [[1, {"buckets": _jax_decls(1024), "bucket_size": 1024}],
            [3, {"algorithm": "bytegrad"}],
            [6, {"algorithm": "gradient_allreduce"}],
            [8, {"overlap": "on"}]]


def _spawn(tmp):
    """Both ranks, every run, once for the module."""
    if "outs" in _OUT:
        return _OUT["outs"]
    _, params, batch = bench.golden_task()
    np.savez(tmp / "data.npz", x=np.asarray(batch["x"]), y=np.asarray(batch["y"]))
    np.savez(tmp / "params.npz", **{f"{layer}.{k}": np.asarray(v)
                                    for layer, leaves in params.items()
                                    for k, v in leaves.items()})
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")]),
           "BAGUA_SERVICE_PORT": str(_free_port()), "MASTER_ADDR": "127.0.0.1",
           "BAGUA_AUTOTUNE": "1", "BAGUA_AUTOTUNE_MAX_SAMPLES": "2",
           "BAGUA_AUTOTUNE_SAMPLING_CONFIDENCE_TIME_S": "0",
           "BAGUA_AUTOTUNE_WARMUP_TIME_S": "0", "BAGUA_AUTOTUNE_SPACE": "legacy",
           "BAGUA_DEFAULT_BUCKET_SIZE": "256", "SEQUENCE_JSON": json.dumps(_sequence())}
    outs = [tmp / f"out{r}.npz" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "2", f"file://{tmp / 'store'}", str(tmp / "data.npz"),
         str(tmp / "params.npz"), str(outs[r]), ",".join(RUNS)], env=env) for r in range(2)]
    try:
        codes = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert codes == [0, 0], codes
    _OUT["outs"] = [dict(np.load(o)) for o in outs]
    return _OUT["outs"]


@pytest.fixture()
def outs(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("autotune2"))


def _params(out, run, prefix="param"):
    return {k: v for k, v in out.items() if k.startswith(f"{run}/{prefix}/")}


def _ranks_equal(outs, run, prefix="param"):
    a, b = _params(outs[0], run, prefix), _params(outs[1], run, prefix)
    assert a and a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---- world 1: the round trip ------------------------------------------------


@pytest.fixture()
def autotune_env(monkeypatch):
    service = AutotuneService(world_size=1, autotune_level=1, max_samples=2,
                              sampling_confidence_time_s=0.0, warmup_time_s=0.0,
                              default_bucket_size=1024)
    server = make_server(0, service)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    monkeypatch.setenv("BAGUA_SERVICE_PORT", str(server.server_address[1]))
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("BAGUA_AUTOTUNE", "1")
    from bagua_tpu_torch import communication

    communication.get_hyperparameters_service_client.cache_clear()
    bt.init_process_group(device="cpu")
    yield service
    server.shutdown()
    communication.get_hyperparameters_service_client.cache_clear()


def _mlp_task(widths=(256, 64, 8)):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(16, 4, generator=g)
    batch = {"x": x, "y": (x @ torch.randn(4, 8, generator=g)).argmax(-1)}
    return MLP(4, widths, device="cpu"), batch


def _loss(m, b):
    return torch.nn.functional.cross_entropy(m(b["x"]), b["y"])


def test_trainer_autotune_round_trip(autotune_env):
    service = autotune_env
    # big enough that the recommended bucket sizes (2^10 ..) partition it
    # differently
    model, batch = _mlp_task()
    trainer = bt.BaguaTrainer(_loss, functools.partial(torch.optim.SGD, lr=0.1),
                              bt.GradientAllReduceAlgorithm(), device="cpu",
                              model_name="autotune_it", bucket_bytes=1024)
    assert trainer.autotune
    state = trainer.init(model)
    task = service._task("autotune_it")
    assert [d.name for d in task.tensor_list] == [p.name for p in trainer._named_params]
    signatures = set()
    for _ in range(801):
        state, loss = trainer.train_step(state, batch)
        # a step of a real model's length: the tracker's windows (its
        # 1-second buckets) read 0 over a history shorter than a second
        time.sleep(0.02)
        signatures.add(trainer.plan.signature())
        if trainer._autotune_completed:
            break
    assert task.n_samples >= 2
    assert sum(task.speed_by_rank.values()) > 0, "automatic speed tracking must score"
    assert trainer._autotune_completed
    assert float(loss) < 2.0
    assert len(signatures) > 1, "autotune never re-bucketed"
    assert [c["step"] for c in trainer.autotune_checkins][:2] == [100, 200]
    assert all(c["speed"] > 0 for c in trainer.autotune_checkins)


def test_failed_check_ins_turn_autotune_off_and_keep_the_hints(autotune_env, monkeypatch):
    from bagua_tpu_torch.obs import anomaly

    # no detector: the hint queue holds only the test's hint
    monkeypatch.setenv("BAGUA_OBS_ANOMALY", "off")
    model, batch = _mlp_task((16, 8))
    trainer = bt.BaguaTrainer(_loss, functools.partial(torch.optim.SGD, lr=0.1),
                              bt.GradientAllReduceAlgorithm(), device="cpu", model_name="dead")
    state = trainer.init(model)

    class Dead:
        def report_metrics(self, **kw):
            raise ConnectionError("sidecar gone")

    trainer._autotune_client = Dead()
    anomaly.drain_perf_hints()
    anomaly.publish_perf_hint({"kind": "step_time_anomaly"})
    for _ in range(300):
        state, _ = trainer.train_step(state, batch)
    assert trainer._autotune_failures == 3 and not trainer.autotune
    # the undelivered hint went back to the queue
    assert anomaly.drain_perf_hints() == [{"kind": "step_time_anomaly"}]


def test_registration_failure_turns_autotune_off(monkeypatch):
    """No sidecar listening: the registration fails with a warning and the
    trainer trains untuned (``backend.py:2555-2557``)."""
    from bagua_tpu_torch import communication

    monkeypatch.setenv("BAGUA_SERVICE_PORT", str(_free_port()))
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    communication.get_hyperparameters_service_client.cache_clear()
    bt.init_process_group(device="cpu")
    model, batch = _mlp_task((16, 8))
    try:
        trainer = bt.BaguaTrainer(_loss, functools.partial(torch.optim.SGD, lr=0.1),
                                  bt.GradientAllReduceAlgorithm(), device="cpu", autotune=True)
        state = trainer.init(model)
        assert not trainer.autotune
        state, loss = trainer.train_step(state, batch)
        assert np.isfinite(loss.item())
    finally:
        communication.get_hyperparameters_service_client.cache_clear()


def test_sharded_state_family_refuses_autotune():
    bt.init_process_group(device="cpu")
    t = bt.BaguaTrainer(_loss, None, bt.ZeroOptimizerAlgorithm(), device="cpu", autotune=True)
    assert not t.autotune


def test_qadam_in_service_search_space():
    from bagua_tpu_torch.service.autotune_task_manager import ALGORITHM_FAMILIES

    assert "qadam" in ALGORITHM_FAMILIES


def test_algorithm_switch_restores_user_instance():
    """A family switch away and back restores the USER's configured
    instance, not a default-constructed one."""
    bt.init_process_group(device="cpu")
    model, _ = _mlp_task((16, 8))
    user_algo = bt.GradientAllReduceAlgorithm(hierarchical=False)
    user_algo.marker = "mine"
    t = bt.BaguaTrainer(_loss, functools.partial(torch.optim.SGD, lr=0.1), user_algo,
                        device="cpu", autotune=False)
    t.init(model)
    t._maybe_switch_algorithm(BaguaHyperparameter(algorithm="bytegrad"))
    assert t.algorithm.name == "bytegrad"
    t._maybe_switch_algorithm(BaguaHyperparameter(algorithm="gradient_allreduce"))
    assert t.algorithm is user_algo and t.algorithm.marker == "mine"


def test_flat_resident_recommendation_flips_the_layout_live():
    """``flat_resident`` on a live trainer queues a leaf <-> flat migration
    of the parameters and the optimizer's state; the trajectory is bitwise
    the unflipped run's."""
    bt.init_process_group(device="cpu")

    def run(flips):
        model, batch = _mlp_task((32, 8))
        t = bt.BaguaTrainer(_loss, functools.partial(torch.optim.Adam, lr=1e-2),
                            bt.GradientAllReduceAlgorithm(), device="cpu", autotune=False,
                            flat_resident="off", bucket_bytes=512)
        s = t.init(model)
        losses, layouts = [], []
        for i in range(8):
            if i in flips:
                t._apply_recommendation(BaguaHyperparameter(flat_resident=flips[i]))
            s, loss = t.train_step(s, batch)
            losses.append(loss.item())
            layouts.append(t._flat_resident)
        return losses, layouts, [p.detach().clone() for p in s.model.parameters()]

    l0, lay0, p0 = run({})
    l1, lay1, p1 = run({2: "on", 5: "off"})
    assert lay0 == [False] * 8 and lay1 == [False, False, True, True, True, False, False, False]
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


@pytest.mark.parametrize("knobs", [{"BAGUA_AUTOTUNE_GOODPUT": "0"},
                                   {"BAGUA_AUTOTUNE_SPACE": "legacy"},
                                   {"BAGUA_AUTOTUNE": "2", "BAGUA_SERVICE_PORT": "1"}])
def test_step_program_identical_with_service_disabled(monkeypatch, knobs):
    """With autotune off the autotune settings never reach the step: the
    parameters after three steps are bitwise the defaults' (the JAX
    package pins its traced program)."""
    bt.init_process_group(device="cpu")

    def run():
        model, batch = _mlp_task((32, 8))
        t = bt.BaguaTrainer(_loss, functools.partial(torch.optim.SGD, lr=0.1),
                            bt.GradientAllReduceAlgorithm(), device="cpu", autotune=False)
        s = t.init(model)
        for _ in range(3):
            s, _ = t.train_step(s, batch)
        return [p.detach().clone() for p in s.model.parameters()]

    base = run()
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    assert all(torch.equal(a, b) for a, b in zip(base, run()))


# ---- world 2 over gloo ------------------------------------------------------


def test_rebucket_by_recommendation_is_bitwise_the_untuned_run(outs):
    for out in outs:
        np.testing.assert_array_equal(out["tuned/losses"], out["tuned/control_losses"])
        checkins = out["tuned/checkins"]
        assert len(checkins) >= 2 and (checkins[:, 1] > 0).all()
        sigs = out["tuned/signatures"]
        assert len(set(sigs.tolist())) > 1, "the recommendation never changed the plan"
        for k, v in _params(out, "tuned").items():
            np.testing.assert_array_equal(v, out[k.replace("/param/", "/control/")])
    np.testing.assert_array_equal(outs[0]["tuned/signatures"], outs[1]["tuned/signatures"])
    _ranks_equal(outs, "tuned")
    assert sorted(outs[0]["tuned/registered"].tolist()) == sorted(
        k.split("/")[-1] for k in _params(outs[0], "tuned"))


@pytest.mark.parametrize("run", ["qadam", "qadam:leaf"])
def test_qadam_switch_migrates_optimizer_ownership(outs, run):
    for out in outs:
        losses = out[f"{run}/losses"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        assert out[f"{run}/adopted"] > 0      # Adam's moments, not zeros
        assert out[f"{run}/anchor"] == 20     # warmup re-anchored at the switch
        assert out[f"{run}/back"]
    np.testing.assert_array_equal(outs[0][f"{run}/losses"], outs[1][f"{run}/losses"])
    _ranks_equal(outs, run)


def test_qadam_switch_layouts_agree(outs):
    for out in outs:
        np.testing.assert_array_equal(out["qadam/losses"], out["qadam:leaf/losses"])


def test_async_there_and_back(outs):
    for out in outs:
        assert str(out["async/family"]) == "GradientAllReduceAlgorithm"
        assert np.isfinite(out["async/losses"]).all()
    # the catch-up average on the way out: one replica again
    _ranks_equal(outs, "async")


def test_ef_residual_follows_the_codec_knob(outs):
    for out in outs:
        assert out["ef/ef_zero"]
        np.testing.assert_array_equal(out["ef/ef_sizes"], out["ef/padded"])
        assert not out["ef/ef_after"]
        assert np.isfinite(out["ef/losses"]).all()
    np.testing.assert_array_equal(outs[0]["ef/trace"], outs[1]["ef/trace"])


def test_recommendation_sequence_matches_jax(outs):
    loss_fn, params, batch = bench.golden_task()
    t = JTrainer(loss_fn, optax.sgd(0.1), JGA(), mesh=build_mesh({"dp": 2}, jax.devices()[:2]),
                 autotune=False, bucket_bytes=256)
    s = t.init(params)
    sequence = {k: v for k, v in _sequence()}
    want = []
    for i in range(max(sequence) + 3):
        if i in sequence:
            t._apply_recommendation(JHyper(**sequence[i]))
        s, loss = t.train_step(s, batch)
        want.append(float(loss))
    want = np.array(want)
    for out in outs:
        got = out["sequence/losses"]
        assert got.shape == want.shape
        gap = np.abs(got - want) / np.abs(want)
        assert gap[:3].max() <= 1e-5, gap
        assert gap.max() <= 1e-3, gap


def test_launcher_autotune_level_reaches_the_check_in(monkeypatch):
    """``--autotune_level 1`` on the port's launcher: the worker environment
    it builds turns a default trainer's autotune on, rank 0's
    ``init_process_group`` serves the sidecar on ``--bagua_service_port``,
    and the trainer registers and checks in at step 100."""
    from bagua_tpu_torch import communication
    from bagua_tpu_torch.distributed.run import build_env, parse_args

    port = _free_port()
    env = build_env(parse_args(["--autotune_level", "1", "--bagua_service_port", str(port),
                                "--autotune_warmup_time", "0",
                                "--autotune_sampling_confidence_time", "0",
                                "script.py"]), 0)
    for k in ("BAGUA_AUTOTUNE", "BAGUA_SERVICE_PORT", "BAGUA_AUTOTUNE_WARMUP_TIME_S",
              "BAGUA_AUTOTUNE_SAMPLING_CONFIDENCE_TIME_S", "BAGUA_AUTOTUNE_MAX_SAMPLES",
              "MASTER_ADDR"):
        monkeypatch.setenv(k, env[k])
    assert env["BAGUA_AUTOTUNE"] == "1" and env["BAGUA_SERVICE_PORT"] == str(port)
    communication.get_hyperparameters_service_client.cache_clear()
    bt.init_process_group(device="cpu")   # rank 0 of a fresh world starts the sidecar here
    server = communication.start_autotune_server(1)
    try:
        assert server is not None and server.server_address[1] == port
        model, batch = _mlp_task((16, 8))
        t = bt.BaguaTrainer(_loss, functools.partial(torch.optim.SGD, lr=0.1),
                            bt.GradientAllReduceAlgorithm(), device="cpu")
        assert t.autotune
        s = t.init(model)
        assert server.RequestHandlerClass.service._task("bagua_module").tensor_list
        for _ in range(100):
            s, _ = t.train_step(s, batch)
        assert [c["step"] for c in t.autotune_checkins] == [100]
    finally:
        communication.stop_autotune_server()
        communication.get_hyperparameters_service_client.cache_clear()


def test_level_two_reports_autograd_readiness_order(autotune_env, monkeypatch):
    """At ``BAGUA_AUTOTUNE=2`` the trainer sends the service the gradient
    readiness order of one backward (``telemetry.profile_tensor_execution_
    order``: autograd's order, the last layer first) before its first step,
    once; the extra backward leaves the training bitwise the level-1 run's."""
    from bagua_tpu_torch.telemetry import profile_tensor_execution_order

    def run(level, name):
        monkeypatch.setenv("BAGUA_AUTOTUNE", str(level))
        model, batch = _mlp_task((32, 16, 8))
        t = bt.BaguaTrainer(_loss, functools.partial(torch.optim.SGD, lr=0.1),
                            bt.GradientAllReduceAlgorithm(), device="cpu", model_name=name)
        s = t.init(model)
        for _ in range(3):
            s, _ = t.train_step(s, batch)
        return t, [p.detach().clone() for p in s.model.parameters()]

    t2, p2 = run(2, "level2")
    order = autotune_env._task("level2").manager.tensor_partial_order
    names = [n for n, _ in t2._params.items()]
    assert t2._telemetry_reported and sorted(order) == sorted(names)
    assert order["dense_2.bias"] < order["dense_0.weight"]
    _, p1 = run(1, "level1")
    assert not autotune_env._task("level1").manager.tensor_partial_order
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    model, batch = _mlp_task((32, 16, 8))
    spans = profile_tensor_execution_order(_loss, model, batch)
    assert [s["tensor_name"] for s in spans][:2] == ["dense_2.bias", "dense_2.weight"]
    assert all(p.grad is None for p in model.parameters())
