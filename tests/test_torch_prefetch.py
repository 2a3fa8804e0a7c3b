"""The port's ``contrib.prefetch_to_device`` (``tests/test_prefetch.py``
mirrored): batches placed through the trainer train as the JAX package's
prefetched run does (losses within 1e-5 relative of its, from the same
converted weights), an explicit mesh and spec keep the order, and bad
arguments raise before the first batch."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bagua_tpu_torch as bt
from bagua_tpu import BaguaTrainer as JTrainer
from bagua_tpu.algorithms import GradientAllReduceAlgorithm as JGA
from bagua_tpu.contrib import prefetch_to_device as jprefetch
from bagua_tpu.models import MLP as JMLP
from bagua_tpu_torch.contrib import prefetch_to_device
from bagua_tpu_torch.models.convert import params_from_jax
from bagua_tpu_torch.models.mlp import MLP

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def process_group():
    bt.init_process_group(device="cpu")


def _batches(n, rows=16, dim=4):
    rng = np.random.default_rng(0)
    for _ in range(n):
        yield {"x": rng.normal(size=(rows, dim)).astype(np.float32),
               "y": rng.integers(0, 3, size=(rows,)).astype(np.int32)}


def test_prefetch_with_trainer_trains():
    jmodel = JMLP(features=(8, 3))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))["params"]
    jloss = lambda p, b: optax.softmax_cross_entropy_with_integer_labels(
        jmodel.apply({"params": p}, b["x"]), b["y"]).mean()
    jtrainer = JTrainer(jloss, optax.sgd(0.1), JGA())
    jstate = jtrainer.init(params)
    want = []
    for batch in jprefetch(_batches(5), trainer=jtrainer, size=2):
        jstate, loss = jtrainer.train_step(jstate, batch)
        want.append(float(loss))

    model = MLP(4, features=(8, 3), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), model))
    loss_fn = lambda m, b: torch.nn.functional.cross_entropy(m(b["x"]), b["y"].long())
    trainer = bt.BaguaTrainer(loss_fn, functools.partial(torch.optim.SGD, lr=0.1),
                              bt.GradientAllReduceAlgorithm(), device="cpu")
    state = trainer.init(model)
    got = []
    for batch in prefetch_to_device(_batches(5), trainer=trainer, size=2):
        # batches arrive on the trainer's device, as torch tensors
        assert all(isinstance(v, torch.Tensor) and v.device == trainer.device
                   for v in batch.values())
        state, loss = trainer.train_step(state, batch)
        got.append(loss.item())
    assert len(got) == 5 and np.isfinite(got[-1])
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_prefetch_explicit_mesh_and_order():
    mesh = bt.build_mesh({"dp": 1})
    out = list(prefetch_to_device(
        ({"x": np.full((8, 2), i, np.float32)} for i in range(4)),
        mesh=mesh, spec=("dp",), size=3, device="cpu"))
    assert len(out) == 4
    for i, b in enumerate(out):
        assert float(b["x"][0, 0]) == i  # order preserved
        assert b["x"].device.type == "cpu"


def test_prefetch_lookahead_depth():
    """``size`` batches are placed before the first is handed out."""
    pulled = []

    def source():
        for i in range(5):
            pulled.append(i)
            yield {"x": np.full((2,), i, np.float32)}

    it = prefetch_to_device(source(), mesh=bt.build_mesh({"dp": 1}), spec=(None,), size=3,
                            device="cpu")
    next(it)
    assert pulled == [0, 1, 2]


def test_prefetch_validation():
    with pytest.raises(ValueError, match="size"):
        list(prefetch_to_device([], trainer=object(), size=0))
    with pytest.raises(ValueError, match="trainer OR mesh"):
        list(prefetch_to_device([], trainer=object(), mesh=object(), spec=()))
    with pytest.raises(ValueError, match="both mesh and spec"):
        list(prefetch_to_device([]))
    with pytest.raises(ValueError, match="not a mesh axis"):
        prefetch_to_device([], mesh=bt.build_mesh({"dp": 1}), spec=("sp",), device="cpu")
    if not torch.cuda.is_available():
        # no device given: cuda, which raises where there is no card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            prefetch_to_device([], mesh=bt.build_mesh({"dp": 1}), spec=("dp",))
