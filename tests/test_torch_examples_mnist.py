"""``examples/torch/mnist_mlp.py`` against ``examples/mnist_mlp.py``.

The JAX side runs the example's own trainer lines in this process on the 8
virtual CPU devices; the port's ``run()`` takes the same flax init (carried
across by ``params_from_jax``) and the same train rows (the digits cut to a
multiple of 8, as JAX's mesh cuts them).  The logged losses over 20 steps
agree within 1e-4 relative (f32; Adam's division amplifies summation-order
differences a little each step).  The port's default run (150 full-batch
Adam steps) reaches a test accuracy of at least 0.95, the JAX example's
gate.  Each family of ``make_algorithm`` trains at world 1: losses finite
and falling.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from workers.torch_example_worker import load

torch.set_num_threads(1)   # these tests share the CPU with the other workers

STEPS = 20


def _jax_losses():
    import bagua_tpu
    from bagua_tpu.algorithms import GradientAllReduceAlgorithm
    from bagua_tpu.contrib.digits_data import load_digits_dataset
    from bagua_tpu.models.mlp import MLP

    mesh = bagua_tpu.init_process_group()
    n_dev = len(jax.devices())
    assert n_dev == 8
    _, _, k3 = jax.random.split(jax.random.PRNGKey(42), 3)
    xt, yt, _, _ = load_digits_dataset(train_multiple_of=n_dev)
    model = MLP(features=(128, 64, 10))
    params = model.init(k3, jnp.zeros((2, 64)))["params"]

    def loss_fn(p, b):
        logits = model.apply({"params": p}, b["x"])
        return optax.softmax_cross_entropy_with_integer_labels(logits, b["y"]).mean()

    trainer = bagua_tpu.BaguaTrainer(loss_fn, optax.adam(2e-3), GradientAllReduceAlgorithm(),
                                     mesh=mesh, model_name="mnist_mlp")
    state = trainer.init(params)
    batch = trainer.shard_batch({"x": jnp.asarray(xt), "y": jnp.asarray(yt)})
    losses = []
    for _ in range(STEPS):
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    return jax.tree.map(np.asarray, params), losses


def test_losses_match_jax_from_carried_weights():
    params, want = _jax_losses()
    ex = load("mnist_mlp")
    args = ex.parser().parse_args(["--steps", str(STEPS), "--device", "cpu",
                                   "--train-multiple-of", "8"])
    out = ex.run(args, params)
    np.testing.assert_allclose(out["losses"], want, rtol=1e-4)
    assert out["losses"][-1] < out["losses"][0]


def test_default_run_reaches_the_accuracy_gate(capsys):
    ex = load("mnist_mlp")
    ex.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert "final_loss" in printed
    acc = float(printed.split("test_accuracy")[1].split()[0])
    assert acc >= 0.95, printed


@pytest.mark.parametrize("family", ["gradient_allreduce", "bytegrad", "decentralized",
                                    "low_precision_decentralized", "async", "qadam"])
def test_every_family_trains(family):
    ex = load("mnist_mlp")
    args = ex.parser().parse_args(["--algorithm", family, "--steps", "15", "--device", "cpu"])
    losses = ex.run(args)["losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_synthetic_data_trains():
    ex = load("mnist_mlp")
    args = ex.parser().parse_args(["--data", "synthetic", "--steps", "15", "--device", "cpu"])
    out = ex.run(args)
    assert "test_accuracy" not in out and out["losses"][-1] < out["losses"][0]
