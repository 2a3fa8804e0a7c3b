"""The port's gradient accumulation (``BaguaTrainer(accum_steps=k)``)
against the JAX package's.

Mirrors ``tests/test_grad_accum.py``: with a mean loss and equal
microbatches, accumulating k microbatches is the step of one pass over the
whole batch (the mean of the microbatch means is the batch mean), on top of
any algorithm, since accumulation runs before the algorithm stages.

- World 1, the JAX test's task (an MLP 12 -> 16 -> 10, 64 rows, 4 steps):
  accum 4 against the full batch for GradientAllReduce with SGD 0.1 and ZeRO
  with Adam 1e-2 within 2e-5, and QAdam (``warmup_steps=2, lr=1e-2``) within
  1e-3 (its compressed phase runs no codec at one rank, but its frozen second
  moment makes the update sensitive to the summation order); losses within
  rtol 1e-5.  The port's accumulated trainer against the JAX package's on a
  one-device mesh at every step, losses within 1e-5 relative and parameters
  within the same tolerances.
- Two gloo ranks (``tests/workers/torch_features_worker.py``, the golden
  task, 8 rows a microbatch): the same runs against the JAX trainer on two
  CPU devices, losses within 1e-3 relative at every step (QAdam's compressed
  phase quantizes the momentum, where a one-ulp difference can move a level,
  as in ``tests/test_torch_compressed.py``), and bitwise equal on both ranks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench
import bagua_tpu_torch as bt
from bagua_tpu.algorithms import GradientAllReduceAlgorithm as JGA
from bagua_tpu.algorithms import QAdamAlgorithm as JQAdam
from bagua_tpu.algorithms import ZeroOptimizerAlgorithm as JZero
from bagua_tpu.core.backend import BaguaTrainer as JTrainer
from bagua_tpu.models import MLP as JMLP
from bagua_tpu.parallel.mesh import build_mesh
from bagua_tpu_torch.models.convert import params_from_jax
from bagua_tpu_torch.models.mlp import MLP

from workers import torch_features_worker as features

torch.set_num_threads(1)

DIM, NCLASS, ROWS, STEPS, ACCUM = 12, 10, 64, 4, 4
JMODEL = JMLP(features=(16, NCLASS))
#: name -> (port algorithm, port optimizer, JAX algorithm, JAX optimizer, parameter tolerance)
ALGOS = {
    "gradient_allreduce": (bt.GradientAllReduceAlgorithm,
                           functools.partial(torch.optim.SGD, lr=0.1),
                           JGA, optax.sgd(0.1), 2e-5),
    "zero": (lambda: bt.ZeroOptimizerAlgorithm(functools.partial(torch.optim.Adam, lr=1e-2)),
             None, lambda: JZero(optax.adam(1e-2)), None, 2e-5),
    # QAdam crosses its warmup boundary mid-run
    "qadam": (lambda: bt.QAdamAlgorithm(warmup_steps=2, lr=1e-2), None,
              lambda: JQAdam(warmup_steps=2, lr=1e-2), None, 1e-3),
}
_RUNS = {}


@pytest.fixture(scope="module", autouse=True)
def process_group():
    bt.init_process_group(device="cpu")


def _data():
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(STEPS, ROWS, DIM)).astype(np.float32)
    ys = rng.integers(0, NCLASS, size=(STEPS, ROWS)).astype(np.int32)
    return xs, ys


def _jparams():
    return JMODEL.init(jax.random.PRNGKey(0), jnp.zeros((1, DIM)))["params"]


def _port(name, accum):
    algo, opt, *_ = ALGOS[name]
    model = MLP(DIM, features=(16, NCLASS), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, _jparams()), model))
    trainer = bt.BaguaTrainer(lambda m, b: torch.nn.functional.cross_entropy(m(b["x"]), b["y"]),
                              opt, algo(), device="cpu", bucket_bytes=256, accum_steps=accum)
    state = trainer.init(model)
    xs, ys = _data()
    losses = []
    for x, y in zip(xs, ys):
        state, loss = trainer.train_step(state, trainer.shard_batch(
            {"x": x, "y": y.astype(np.int64)}))
        losses.append(loss.item())
    return np.array(losses), trainer.unstack_params(state)


def _jax(name, accum):
    _, _, algo, opt, _ = ALGOS[name]

    def loss_fn(params, batch):
        logits = JMODEL.apply({"params": params}, batch["x"])
        return optax.softmax_cross_entropy_with_integer_labels(logits, batch["y"]).mean()

    trainer = JTrainer(loss_fn, opt, algo(), mesh=build_mesh({"dp": 1}, jax.devices()[:1]),
                       bucket_bytes=256, autotune=False, accum_steps=accum)
    state = trainer.init(_jparams())
    xs, ys = _data()
    losses = []
    for x, y in zip(xs, ys):
        state, loss = trainer.train_step(state, {"x": x, "y": y})
        losses.append(float(loss))
    return np.array(losses), jax.tree.map(np.asarray, trainer.unstack_params(state))


@pytest.mark.parametrize("name", list(ALGOS))
def test_accum_equals_full_batch(name):
    tol = ALGOS[name][-1]
    full, p_full = _port(name, 1)
    acc, p_acc = _port(name, ACCUM)
    np.testing.assert_allclose(acc, full, rtol=1e-5, atol=1e-6)
    for n in p_full:
        np.testing.assert_allclose(p_acc[n].numpy(), p_full[n].numpy(), rtol=tol, atol=tol,
                                   err_msg=n)


@pytest.mark.parametrize("name", list(ALGOS))
def test_accum_tracks_jax_at_every_step(name):
    tol = ALGOS[name][-1]
    got, params = _port(name, ACCUM)
    want, jparams = _jax(name, ACCUM)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    model = MLP(DIM, features=(16, NCLASS), device="cpu")
    for n, w in params_from_jax(jparams, model).items():
        np.testing.assert_allclose(params[n].numpy(), w.numpy(), rtol=tol, atol=tol, err_msg=n)


def _two_ranks(tmp_path_factory):
    if "runs" not in _RUNS:
        runs = [f"{b}{s}" for b in ("ga", "zero_adam", "qadam") for s in ("", f":accum={ACCUM}")]
        _RUNS["runs"] = features.spawn(2, runs, tmp_path_factory.mktemp("accum2"), 6)
    return _RUNS["runs"]


@pytest.mark.parametrize("base,name", [("ga", "gradient_allreduce"), ("zero_adam", "zero"),
                                       ("qadam", "qadam")])
def test_accum_on_two_ranks_tracks_jax(base, name, tmp_path_factory):
    outs = _two_ranks(tmp_path_factory)
    run = f"{base}:accum={ACCUM}"
    for o in outs[1:]:
        np.testing.assert_array_equal(o[f"{run}/losses"], outs[0][f"{run}/losses"])
        np.testing.assert_array_equal(o[f"{run}/dense_0.kernel"], outs[0][f"{run}/dense_0.kernel"])
    got, full = outs[0][f"{run}/losses"], outs[0][f"{base}/losses"]
    np.testing.assert_allclose(got, full, rtol=1e-3)
    loss_fn, params, batch = bench.golden_task()
    algo = {"gradient_allreduce": lambda: JGA(), "zero": lambda: JZero(optax.adam(1e-2)),
            "qadam": lambda: JQAdam(warmup_steps=2, lr=1e-2, hierarchical=False)}[name]()
    opt = optax.sgd(0.1) if name == "gradient_allreduce" else None
    trainer = JTrainer(loss_fn, opt, algo, mesh=build_mesh({"dp": 2}, jax.devices()[:2]),
                       autotune=False, accum_steps=ACCUM)
    state = trainer.init(params)
    want = []
    for _ in range(len(got)):
        state, loss = trainer.train_step(state, batch)
        want.append(float(loss))
    gap = np.abs(got - np.array(want)) / np.abs(want)
    assert gap.max() <= 1e-3, f"largest relative loss gap {gap.max():.3g} at step {gap.argmax()}"
    assert got[-1] < got[0]


def test_rejects_indivisible_batch():
    trainer = bt.BaguaTrainer(lambda m, b: m(b["x"]).sum(), functools.partial(
        torch.optim.SGD, lr=0.1), bt.GradientAllReduceAlgorithm(), device="cpu", accum_steps=3)
    state = trainer.init(MLP(DIM, features=(16, NCLASS), device="cpu"))
    xs, _ = _data()
    with pytest.raises(ValueError, match="not divisible"):
        trainer.train_step(state, {"x": torch.from_numpy(xs[0][:4])})


def test_rejects_bad_accum_steps():
    with pytest.raises(ValueError, match="accum_steps must be >= 1"):
        bt.BaguaTrainer(lambda m, b: m(b["x"]).sum(), None, bt.GradientAllReduceAlgorithm(),
                        device="cpu", accum_steps=0)
