"""Port's BaguaTrainer + GradientAllReduceAlgorithm against the JAX trainer.

Both trainers start from the same flax params (converted with
``params_from_jax``) and see the same numpy batches.  The JAX trainer runs on
the 8-device CPU mesh, where the per-shard gradient average equals the
full-batch gradient the port takes at world size 1.  Trajectories are held
within tolerance, not bitwise: summation orders differ between XLA and torch
(and the JAX package's own bitwise claims fail on this toolchain; ROADMAP
Queue 3).
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench
import bagua_tpu_torch as bt
from bagua_tpu.algorithms.gradient_allreduce import (
    GradientAllReduceAlgorithm as JGradientAllReduce,
)
from bagua_tpu.core.backend import BaguaTrainer as JTrainer
from bagua_tpu.models.transformer import TransformerConfig as JConfig
from bagua_tpu.models.transformer import TransformerLM as JLM
from bagua_tpu.models.transformer import lm_loss_fn as jlm_loss_fn
from bagua_tpu.parallel.mesh import build_mesh
from bagua_tpu_torch.models.convert import params_from_jax
from bagua_tpu_torch.models.mlp import MLP
from bagua_tpu_torch.models.transformer import TransformerConfig, TransformerLM

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "workers" / "torch_trainer_worker.py"


@pytest.fixture(scope="module", autouse=True)
def process_group():
    bt.init_process_group(device="cpu")


def _ce(model, batch):
    return torch.nn.functional.cross_entropy(model(batch["x"]), batch["y"])


def _jax_run(loss_fn, params, batch, optimizer, steps, **kw):
    trainer = JTrainer(loss_fn, optimizer, JGradientAllReduce(),
                       mesh=build_mesh({"dp": len(jax.devices())}),
                       autotune=False, **kw)
    state = trainer.init(params)
    losses = []
    for _ in range(steps):
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    return losses, trainer.unstack_params(state)


def _port_run(model, loss_fn, batch, optimizer_factory, steps):
    trainer = bt.BaguaTrainer(loss_fn, optimizer_factory,
                              bt.GradientAllReduceAlgorithm(), device="cpu")
    state = trainer.init(model)
    batch = trainer.shard_batch(batch)
    losses = []
    for _ in range(steps):
        state, loss = trainer.train_step(state, batch)
        losses.append(loss.item())
    assert state.step == steps
    return losses, trainer


def test_golden_task_trajectory_matches_jax():
    loss_fn, params, batch = bench.golden_task()
    want, _ = _jax_run(loss_fn, params, batch, optax.sgd(0.1), 30)
    x, y = np.asarray(batch["x"]), np.asarray(batch["y"]).astype(np.int64)
    model = MLP(x.shape[1], features=(32, 8), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), model))
    got, _ = _port_run(model, _ce, {"x": x, "y": y},
                       functools.partial(torch.optim.SGD, lr=0.1), 30)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert got[-1] < 0.5 * got[0]


def test_small_lm_adamw_matches_jax():
    small = dict(vocab_size=256, d_model=128, n_heads=2, n_layers=2, d_ff=256,
                 max_seq_len=64)
    jmodel = JLM(JConfig(**small, dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tokens = np.random.default_rng(0).integers(0, 256, (8, 65), dtype=np.int32)
    want, jparams = _jax_run(jlm_loss_fn(jmodel), params,
                             {"tokens": jnp.asarray(tokens)},
                             optax.adamw(1e-4, weight_decay=1e-4), 3,
                             flat_resident="off")
    model = TransformerLM(TransformerConfig(**small, dtype=torch.float32), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), model))
    # the slice's optimizer: AdamW at lr 1e-4 with optax's defaults written
    # out.  Adam moves an element whose gradient is rounding noise by up to
    # lr a step, so the params agree to about lr, not to the gradients'
    # precision.
    adamw = functools.partial(torch.optim.AdamW, lr=1e-4, betas=(0.9, 0.999),
                              eps=1e-8, weight_decay=1e-4)
    p0 = {n: p.detach().clone().numpy() for n, p in model.named_parameters()}
    got, _ = _port_run(model, bt.lm_loss_fn, {"tokens": tokens.astype(np.int64)},
                       adamw, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    jsd = params_from_jax(jax.tree.map(np.asarray, jparams), model)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jsd[name].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=name)
    # The three updates themselves, per leaf, relative to JAX's: the sound
    # run's worst leaf is 4.5e-4; a skipped or doubled last step gives 0.33,
    # lr off by 10% gives 0.099 and torch's default weight decay of 1e-2
    # gives 0.011, so 5e-3 separates them.
    for name, p in model.named_parameters():
        want_du = jsd[name].numpy() - p0[name]
        err = np.linalg.norm(p.detach().numpy() - p0[name] - want_du)
        assert err <= 5e-3 * np.linalg.norm(want_du), name


def test_two_gloo_ranks_equal_one_rank_on_the_whole_batch(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 4)).astype(np.float32)
    y = np.argmax(x @ rng.standard_normal((4, 8)), -1)
    np.savez(tmp_path / "data.npz", x=x, y=y)
    steps = 10
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")])}
    init = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), "2", init, str(tmp_path / "data.npz"),
         str(tmp_path / f"out{r}.npz"), str(steps)], env=env)
        for r in range(2)]
    try:
        assert [p.wait(timeout=120) for p in procs] == [0, 0]
    finally:
        for p in procs:
            p.kill()
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]

    model = MLP(4, features=(32, 8), device="cpu", seed=0)
    losses, trainer = _port_run(model, _ce, {"x": x, "y": y.astype(np.int64)},
                                functools.partial(torch.optim.SGD, lr=0.1), steps)
    assert int(outs[0]["n_buckets"]) > 1          # several allreduces per step
    np.testing.assert_array_equal(outs[0]["losses"], outs[1]["losses"])
    np.testing.assert_allclose(outs[0]["losses"], losses, atol=1e-6, rtol=1e-6)
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(outs[0][name], outs[1][name])
        np.testing.assert_allclose(outs[0][name], p.detach().numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=name)


def test_eval_step_and_comm_dtype():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((16, 4)).astype(np.float32)
    y = rng.integers(0, 8, 16)
    model = MLP(4, features=(32, 8), device="cpu", seed=3)
    trainer = bt.BaguaTrainer(_ce, functools.partial(torch.optim.SGD, lr=0.1),
                              bt.GradientAllReduceAlgorithm(comm_dtype=torch.bfloat16),
                              device="cpu")
    state = trainer.init(model)
    batch = trainer.shard_batch({"x": x, "y": torch.from_numpy(y)})  # numpy or torch
    before = trainer.eval_step(state, batch)
    assert before.item() == pytest.approx(_ce(model, batch).item())
    state, loss = trainer.train_step(state, batch)
    assert loss.item() == pytest.approx(before.item())
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    assert trainer.eval_step(state, batch).item() < before.item()


def test_hierarchical_not_ported_yet():
    """``hierarchical=True`` builds; at world size 1 there are no tiers, so
    it takes the flat path: the same losses and parameters, bit for bit."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, 4)).astype(np.float32)
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(rng.integers(0, 8, 16))}
    runs = []
    for hierarchical in (True, False):
        model = MLP(4, features=(32, 8), device="cpu", seed=3)
        trainer = bt.BaguaTrainer(_ce, functools.partial(torch.optim.SGD, lr=0.1),
                                  bt.GradientAllReduceAlgorithm(hierarchical=hierarchical),
                                  device="cpu")
        state = trainer.init(model)
        assert not trainer._ctx.two_tier() and state.algo_state is None
        losses = [trainer.train_step(state, batch)[1].item() for _ in range(5)]
        runs.append((losses, [p.detach().clone() for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_default_bucket_size_and_env(monkeypatch):
    from bagua_tpu_torch import env

    assert env.get_default_bucket_size() == 10 * 1024 ** 2
    monkeypatch.setenv("BAGUA_DEFAULT_BUCKET_SIZE", "4096")
    assert env.get_default_bucket_size() == 4096
    monkeypatch.setenv("BAGUA_DEFAULT_BUCKET_SIZE", "many")
    with pytest.raises(ValueError, match="integer"):
        env.get_default_bucket_size()
    with pytest.raises(KeyError):
        env.env_int("BAGUA_NOT_DECLARED")
    assert env.get_world_size() == 1 and env.get_rank() == 0


@pytest.mark.parametrize("default,value,want", [
    ("0", None, False), ("0", "1", True), ("0", "yes", False),
    ("1", None, True), ("1", "0", False), ("1", "", True),
])
def test_env_bool_reader(monkeypatch, default, value, want):
    from bagua_tpu_torch import env

    name = "BAGUA_TEST_FLAG"
    monkeypatch.setitem(env.ENV_REGISTRY, name, env.EnvVar(name, "bool", default, ""))
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)
    assert env.env_bool(name) is want
