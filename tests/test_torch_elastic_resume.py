"""Cross-topology resume of the port against the JAX package's golden
trajectory.  Mirrors ``tests/test_elastic_resume.py``: the golden task
(``bench.golden_task()``, SGD 0.1, GradientAllReduce) is saved at world 2
after 15 steps (two gloo ranks of ``tests/workers/torch_checkpoint_worker.py``)
and resumed at world 1 (this process) and at world 4 (four gloo ranks) for
15 more; the final loss must land within atol 5e-5 of the JAX trainer's
uninterrupted 30 steps (reduction orders differ between worlds: continuity
means the same trajectory up to reassociation).  The port has no
``elastic_restore``: its resize restore is ``trainer.restore_checkpoint``,
and its pass-through on an empty directory ``manager.try_restore``.  A
plan-dependent layout (flat-resident ZeRO) saved at world 2 stays blocked at
worlds 1 and 4 with the actionable layout error.
"""

import jax
import numpy as np
import optax
import pytest
import torch

import bench
import bagua_tpu_torch as bt
from bagua_tpu.algorithms.gradient_allreduce import GradientAllReduceAlgorithm as JGA
from bagua_tpu.core.backend import BaguaTrainer as JTrainer
from bagua_tpu.parallel.mesh import build_mesh
from bagua_tpu_torch.checkpoint import BaguaCheckpointManager

from workers import torch_checkpoint_worker as worker
from test_torch_checkpoint import _golden

torch.set_num_threads(1)

ATOL = 5e-5
SAVE_AT, TOTAL = 15, 30
_RUNS = {}


@pytest.fixture(scope="module", autouse=True)
def process_group():
    bt.init_process_group(device="cpu")


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    """The JAX trainer's uninterrupted final loss, and the port's world-2
    saves and world-4 resumes."""
    loss_fn, params, batch = bench.golden_task()
    trainer = JTrainer(loss_fn, optax.sgd(0.1), JGA(),
                       mesh=build_mesh({"dp": 2}, devices=jax.devices()[:2]), autotune=False)
    state = trainer.init(params)
    data = trainer.shard_batch(batch)
    for _ in range(TOTAL):
        state, loss = trainer.train_step(state, data)
    tmp = tmp_path_factory.mktemp("elastic")
    root = tmp / "ck"
    two = worker.spawn(2, [f"save:ga:{SAVE_AT}", "save:zero:2"], tmp, root)
    four = worker.spawn(4, [f"load:ga:{TOTAL - SAVE_AT}", "load:zero:2"], tmp, root)
    return {"golden": float(loss), "root": root, "two": two, "four": four}


def test_cross_topology_resume_world4(task):
    saved = task["two"][0][f"save:ga:{SAVE_AT}"]
    for out in task["four"]:
        rec = out[f"load:ga:{TOTAL - SAVE_AT}"]
        assert rec["step"] == SAVE_AT
        assert rec["params_digest"] == saved["digest"]
        np.testing.assert_allclose(rec["losses"][-1], task["golden"], rtol=0, atol=ATOL)


def test_cross_topology_resume_world1(task, tmp_path):
    params_path, batch = _golden(tmp_path)
    rec = worker.run_load("ga", TOTAL - SAVE_AT, batch, params_path, str(task["root"]), "ga")
    assert rec["step"] == SAVE_AT
    assert rec["params_digest"] == task["two"][0][f"save:ga:{SAVE_AT}"]["digest"]
    np.testing.assert_allclose(rec["losses"][-1], task["golden"], rtol=0, atol=ATOL)


def test_elastic_restore_empty_dir_passes_through(tmp_path):
    params_path, _ = _golden(tmp_path)
    _, state = worker.make("ga", params_path)
    mgr = BaguaCheckpointManager(str(tmp_path / "none"))
    step, out = mgr.try_restore(state)
    assert step is None and out is state


def test_plan_dependent_layout_still_blocked_across_topologies(task, tmp_path):
    params_path, batch = _golden(tmp_path)
    rec = worker.run_load("zero", 1, batch, params_path, str(task["root"]), "zero")
    assert "layout mismatch" in rec["error"]
    for out in task["four"]:
        assert "layout mismatch" in out["load:zero:2"]["error"]
