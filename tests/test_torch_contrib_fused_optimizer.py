"""The port's ``fuse_optimizer`` against the JAX package's
(``tests/test_contrib_fused_optimizer.py`` and the fused cases of
``tests/test_flat_resident.py:262-311`` mirrored).

- The per-dtype flatten builds the JAX package's buffers, and unflattens
  back exactly.
- Fused Adam steps equal plain Adam's bitwise (the same elementwise kernels
  over a concatenation), and the JAX fused Adam's within 2e-5 relative
  (torch and optax apply Adam's bias corrections in another order).
- The trainer on the golden MLP task (``bench.golden_task``): the fused
  factory's run equals the plain one bitwise in each layout, and the JAX
  fused trainer's losses within 1e-5 relative.
- On the resident layout the trainer unwraps the factory: ``opt_factory``
  is ``fused_inner`` and the optimizer is the inner one over the bucket
  flats (no ``FusedOptimizer`` state anywhere); on the leaf layout the
  wrapper runs.  A shape-aware inner optimizer keeps ``auto`` on the leaf
  layout, the probe reading the inner factory."""

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
from bagua_tpu.contrib import fuse_optimizer as jfuse
from bagua_tpu.contrib.fused_optimizer import _flatten as jflatten
from bagua_tpu.core.backend import BaguaTrainer as JTrainer
from bagua_tpu.parallel.mesh import build_mesh
from bagua_tpu_torch.contrib import FusedOptimizer, fuse_optimizer
from bagua_tpu_torch.contrib.fused_optimizer import _flatten, _unflatten
from bagua_tpu_torch.models.convert import params_from_jax
from bagua_tpu_torch.models.mlp import MLP

torch.set_num_threads(1)

STEPS = 4
ADAM = functools.partial(torch.optim.Adam, lr=1e-2)
SGD_MOMENTUM = functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9)


@pytest.fixture(scope="module", autouse=True)
def process_group():
    bt.init_process_group(device="cpu")


def test_flatten_roundtrip():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.ones((4,), np.float32) * 2, "d": np.full((2, 2), 3.0, np.float32)}}
    leaves = [torch.from_numpy(tree["a"]), torch.ones(4, dtype=torch.bfloat16),
              torch.from_numpy(tree["b"]["d"])]
    flat = _flatten(leaves)
    assert set(flat) == {"float32", "bfloat16"}
    assert flat["float32"].shape == (10,)
    for got, want in zip(_unflatten(flat, leaves), leaves):
        assert torch.equal(got, want)
    # the JAX package's buffers for the same leaves, in its tree order
    want = jflatten(tree)["float32"]
    got = _flatten([torch.from_numpy(tree["a"]), torch.from_numpy(tree["b"]["c"]),
                    torch.from_numpy(tree["b"]["d"])])["float32"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fused_equals_plain_adam():
    params = {"w1": np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4),
              "b1": np.zeros((4,), np.float32),
              "w2": np.linspace(0.5, -0.5, 8, dtype=np.float32).reshape(4, 2)}
    names = sorted(params)   # the JAX tree's leaf order
    plain_ps = [torch.nn.Parameter(torch.from_numpy(params[n].copy())) for n in names]
    fused_ps = [torch.nn.Parameter(torch.from_numpy(params[n].copy())) for n in names]
    plain, fused = ADAM(plain_ps), fuse_optimizer(ADAM)(fused_ps)
    assert isinstance(fused, FusedOptimizer)
    jtx = jfuse(optax.adam(1e-2))
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    js = jtx.init(jp)
    for _ in range(5):
        for a, b in zip(plain_ps, fused_ps):
            g = torch.cos(a.detach()) * 0.1
            a.grad, b.grad = g.clone(), g.clone()
        plain.step()
        fused.step()
        u, js = jtx.update(jax.tree.map(lambda p: jnp.cos(p) * 0.1, jp), js, jp)
        jp = optax.apply_updates(jp, u)
    for n, a, b in zip(names, plain_ps, fused_ps):
        assert torch.equal(a, b), n
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(jp[n]), rtol=2e-5,
                                   atol=1e-7, err_msg=n)


def _ce(m, b):
    return torch.nn.functional.cross_entropy(m(b["x"]), b["y"])


def _train(opt, mode):
    _, params, batch = bench.golden_task()
    batch = {"x": torch.from_numpy(np.array(batch["x"])),
             "y": torch.from_numpy(np.array(batch["y"]).astype(np.int64))}
    model = MLP(4, features=(32, 8), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), model))
    trainer = bt.BaguaTrainer(_ce, opt, bt.GradientAllReduceAlgorithm(), device="cpu",
                              bucket_bytes=256, flat_resident=mode)
    state = trainer.init(model)
    losses = []
    for _ in range(STEPS):
        state, loss = trainer.train_step(state, batch)
        losses.append(loss.item())
    return np.array(losses), state, trainer


def _jax_losses(tx):
    loss_fn, params, batch = bench.golden_task()
    trainer = JTrainer(loss_fn, tx, JGA(), mesh=build_mesh({"dp": len(jax.devices())}),
                       autotune=False)
    state = trainer.init(params)
    losses = []
    for _ in range(STEPS):
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    return np.array(losses)


def _same_params(ta, sa, tb, sb):
    pa, pb = ta.unstack_params(sa), tb.unstack_params(sb)
    return set(pa) == set(pb) and all(torch.equal(pa[n], pb[n]) for n in pa)


@pytest.mark.parametrize("mode", ["off", "on"])
def test_fused_trainer_equals_plain_trainer(mode):
    l_fused, s_fused, t_fused = _train(fuse_optimizer(SGD_MOMENTUM), mode)
    l_plain, s_plain, t_plain = _train(SGD_MOMENTUM, mode)
    np.testing.assert_array_equal(l_fused, l_plain)
    assert _same_params(t_fused, s_fused, t_plain, s_plain)
    want = _jax_losses(jfuse(optax.sgd(0.1, momentum=0.9)))
    np.testing.assert_allclose(l_fused, want, rtol=1e-5)


def test_fused_on_flats_matches_unfused_adam():
    """Resident: the trainer unwraps the factory and runs ``fused_inner``
    on the bucket flats, bitwise the unfused optimizer's run; the fused
    wrapper's own state never appears."""
    fused = fuse_optimizer(ADAM)
    l_fused, s_fused, t_fused = _train(fused, "on")
    l_plain, s_plain, t_plain = _train(ADAM, "on")
    l_leaf, s_leaf, t_leaf = _train(ADAM, "off")
    assert t_fused.opt_factory is fused.fused_inner
    assert t_plain.opt_factory is ADAM
    assert not isinstance(s_fused.optimizer, FusedOptimizer)
    assert isinstance(s_fused.optimizer, torch.optim.Adam)
    assert all(p is f for p, f in zip(s_fused.optimizer.param_groups[0]["params"],
                                      t_fused._flats))
    np.testing.assert_array_equal(l_fused, l_plain)
    assert _same_params(t_fused, s_fused, t_plain, s_plain)
    np.testing.assert_allclose(l_fused, l_leaf, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(l_fused, _jax_losses(jfuse(optax.adam(1e-2))), rtol=1e-5)


def test_fused_leaf_layout_still_wraps():
    fused = fuse_optimizer(ADAM)
    l_fused, s_fused, t_fused = _train(fused, "off")
    assert t_fused.opt_factory is fused
    assert isinstance(s_fused.optimizer, FusedOptimizer)
    l_plain, s_plain, t_plain = _train(ADAM, "off")
    np.testing.assert_array_equal(l_fused, l_plain)
    assert _same_params(t_fused, s_fused, t_plain, s_plain)


def test_flat_safety_probes_the_inner_factory():
    """A shape-aware inner optimizer keeps ``auto`` on the leaf layout and
    makes ``on`` raise, as it does unwrapped."""
    adafactor = functools.partial(torch.optim.Adafactor, lr=1e-2)
    _, _, trainer = _train(fuse_optimizer(adafactor), "auto")
    assert not trainer._flat_resident
    assert isinstance(trainer.opt_factory, type(fuse_optimizer(ADAM)))
    with pytest.raises(ValueError, match="does not commute"):
        _train(fuse_optimizer(adafactor), "on")
    _, _, trainer = _train(fuse_optimizer(ADAM), "auto")
    assert trainer._flat_resident
