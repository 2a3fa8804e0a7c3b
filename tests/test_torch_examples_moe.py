"""``examples/torch/moe_mnist.py`` against ``examples/moe_mnist.py``.

- ep 1, capacity routing (the JAX example's): 15 Adam steps of the port's
  ``run()`` from the JAX example's init, carried across by
  ``params_from_jax``, against the JAX example's trainer lines on the same
  numpy batches.  JAX runs on a one-device mesh: capacity is computed over
  the tokens a device routes, so a batch sharded over 8 devices would drop
  other tokens than the port's one rank.  The MoE computes in bf16 on both
  sides (the examples' default), and torch's and XLA's bf16 matmuls round a
  few elements an ulp apart: the losses agree within 1e-2 relative, and
  both fall.
- ep 2 at two gloo ranks against ep 1 at one, both ``--dropless`` (the
  grouped-matmul path, which has no capacity, so the split of the batch
  over the ranks leaves the routing unchanged), from the same weights: the
  losses agree within 1e-3 relative over 15 steps.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from workers.torch_example_worker import load, spawn

torch.set_num_threads(1)   # these tests share the CPU with the other workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, BATCH = 15, 32


def _jax_example():
    path = os.path.join(REPO, "examples", "moe_mnist.py")
    spec = importlib.util.spec_from_file_location("jax_moe_mnist", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_run():
    """The JAX example's lines at ep 1 on one device: the init and the
    logged losses."""
    import bagua_tpu
    from bagua_tpu.algorithms.gradient_allreduce import GradientAllReduceAlgorithm
    from bagua_tpu.parallel.mesh import build_mesh

    jex = _jax_example()
    args = type("Args", (), {"batch": BATCH, "mnist_dir": None})()
    images, labels = jex.load_batches(args, np.random.default_rng(0))
    model = jex.MoEMnistNet(n_experts=4, ep_size=1)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(images[:2]))["params"]

    def loss_fn(p, batch):
        logits = model.apply({"params": p}, batch["x"])
        return optax.softmax_cross_entropy_with_integer_labels(logits, batch["y"]).mean()

    trainer = bagua_tpu.BaguaTrainer(loss_fn, optax.adam(1e-3), GradientAllReduceAlgorithm(),
                                     mesh=build_mesh({"dp": 1}, jax.devices()[:1]),
                                     autotune=False)
    state = trainer.init(params)
    losses = []
    for step in range(STEPS):
        lo = (step * BATCH) % (len(images) - BATCH)
        batch = trainer.shard_batch({"x": images[lo:lo + BATCH], "y": labels[lo:lo + BATCH]})
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    return jax.tree.map(np.asarray, params), losses


@pytest.fixture(scope="module")
def jax_run():
    return _jax_run()


def _argv(*extra):
    return ["--steps", str(STEPS), "--batch", str(BATCH), *extra]


def test_ep1_matches_jax(jax_run):
    params, want = jax_run
    ex = load("moe_mnist")
    out = ex.run(ex.parser().parse_args([*_argv(), "--device", "cpu"]), params)
    assert out["ep"] == 1
    np.testing.assert_allclose(out["losses"], want, rtol=1e-2)
    assert out["losses"][-1] < out["losses"][0] and want[-1] < want[0]


def test_ep2_dropless_matches_ep1(jax_run, tmp_path):
    params, _ = jax_run
    ex = load("moe_mnist")
    one = ex.run(ex.parser().parse_args([*_argv("--dropless"), "--device", "cpu"]), params)
    ranks = spawn("moe_mnist", 2, _argv("--dropless"), tmp_path, params=params)
    assert [r["ep"] for r in ranks] == [2, 2]
    assert ranks[0]["losses"] == ranks[1]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=1e-3)
    assert "final_loss" in ranks[0]["stdout"]


def test_default_draw_trains_at_ep2(tmp_path):
    ranks = spawn("moe_mnist", 2, _argv("--dropless"), tmp_path)
    losses = ranks[0]["losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
