"""The port's ResNet and VGG against the JAX package's
(``tests/test_models.py:70-112`` mirrored, on the same seeded numpy inputs
and the JAX weights through ``models.convert``).

- A small f32 ResNet (``stage_sizes=(1, 1)``, 8 filters) in training mode:
  logits, the input gradient and every parameter gradient within 1e-5 of
  ``model.apply``/``jax.grad``, at 32 px (a stride-2 3x3 convolution on an
  even input: flax pads 0 before and 1 after) and at 33 px (odd: 1 and 1);
  the running statistics after the step within 1e-5 of flax's (biased
  variance, momentum 0.9).  The bf16 default within the slices' bf16
  tolerance (2e-2 of the largest logit).  ``remat`` bitwise equal to no
  remat.  A small VGG's logits and gradients within 1e-5 (its NHWC flatten).
- ResNet50(1000) and VGG16(1000) at full width (shapes only): parameter and
  ``batch_stats`` counts and shapes equal to ``jax.eval_shape``'s.
- ``params_from_jax``/``params_to_jax`` and the batch statistics round trip
  exactly, for ResNet and VGG.
- Trainer parity: 5 SGD steps of the small ResNet at 32 px, the JAX trainer
  on the 8-device mesh with ``SyncBatchNorm(axis_name="dp")`` against the
  port at world 1 with the local norm and with ``SyncBatchNorm``: losses
  and parameters within 1e-5.  With the LOCAL norm JAX's 8 shards would each
  normalize 2 images on their own, so the JAX run needs SyncBN to compute
  the whole batch's statistics, which the port at world 1 computes locally.
  The same for a small VGG (``cfg=(8, "M", 16, "M")``), which has no norm.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bagua_tpu_torch as bt
from bagua_tpu.algorithms import GradientAllReduceAlgorithm as JGA
from bagua_tpu.contrib import SyncBatchNorm as JSyncBN
from bagua_tpu.core.backend import BaguaTrainer as JTrainer
from bagua_tpu.models.resnet import ResNet as JResNet
from bagua_tpu.models.resnet import ResNet50 as JResNet50
from bagua_tpu.models.resnet import classification_loss_fn as jcls_loss
from bagua_tpu.models.vgg import VGG as JVGG
from bagua_tpu.models.vgg import VGG16 as JVGG16
from bagua_tpu.models.vgg import vgg_loss_fn as jvgg_loss
from bagua_tpu.parallel.mesh import build_mesh
from bagua_tpu_torch.contrib import SyncBatchNorm
from bagua_tpu_torch.models.convert import (
    batch_stats_from_jax,
    batch_stats_to_jax,
    params_from_jax,
    params_to_jax,
)
from bagua_tpu_torch.models.resnet import ResNet, ResNet50, classification_loss_fn
from bagua_tpu_torch.models.vgg import VGG, VGG16, vgg_loss_fn

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_TOL = 2e-2
STEPS = 5
SMALL = dict(stage_sizes=(1, 1), num_classes=4, num_filters=8)
SMALL_VGG = dict(cfg=(8, "M", 16, "M"), num_classes=4, hidden=32)


@pytest.fixture(scope="module", autouse=True)
def process_group():
    bt.init_process_group(device="cpu")


def images(n, size, seed=0):
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)


def labels(n, seed=1):
    return np.random.default_rng(seed).integers(0, 4, size=n).astype(np.int32)


def nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> an NCHW tensor in channels-last memory."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def rename(tree, old: str, new: str):
    """A flax tree with every key starting ``old`` renamed to start ``new``
    (``SyncBatchNorm_k`` <-> ``BatchNorm_k``)."""
    if not isinstance(tree, dict):
        return tree
    return {(new + k[len(old):] if k.startswith(old) else k): rename(v, old, new)
            for k, v in tree.items()}


def jax_resnet(sync=False, dtype=jnp.float32, **kw):
    norm_cls = functools.partial(JSyncBN, axis_name="dp") if sync else None
    return JResNet(**{**SMALL, **kw}, dtype=dtype, norm_dtype=dtype, norm_cls=norm_cls)


def port_resnet(sync=False, dtype=torch.float32, **kw):
    norm_cls = functools.partial(SyncBatchNorm, axis_name="dp") if sync else None
    return ResNet(**{**SMALL, **kw}, dtype=dtype, norm_dtype=dtype, norm_cls=norm_cls,
                  device="cpu")


def load(model, variables):
    model.load_state_dict(params_from_jax(to_np(variables["params"]), model), strict=False)
    if "batch_stats" in variables:
        batch_stats_from_jax(to_np(variables["batch_stats"]), model)
    return model


def max_gap(a, b) -> float:
    return max(jax.tree.leaves(jax.tree.map(
        lambda x, y: float(np.max(np.abs(np.asarray(x) - np.asarray(y)))), a, b)))


@pytest.mark.parametrize("size", [32, 33])
def test_resnet_forward_and_gradients_match_jax(size):
    jm = jax_resnet()
    x, y = images(4, size), labels(4)
    v = jm.init(jax.random.PRNGKey(2), x[:2], train=True)

    @jax.jit
    def jloss(p, xx):
        logits, upd = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, xx, train=True,
                               mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean(), (logits, upd)

    (_, (want, upd)), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        v["params"], x)
    m = load(port_resnet(), v)
    xt = nchw(x).requires_grad_()
    logits = m(xt)
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(y).long()).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx),
                               atol=F32_TOL, rtol=F32_TOL)
    got = params_to_jax({n: p.grad for n, p in m.named_parameters()}, to_np(gp))
    assert max_gap(got, to_np(gp)) <= F32_TOL
    # the running statistics: biased variance, momentum 0.9
    assert max_gap(batch_stats_to_jax(m), to_np(upd["batch_stats"])) <= F32_TOL


def test_same_padding_is_asymmetric_on_even_inputs():
    """The trap the 32 px case covers: with ``padding=1`` a stride-2 3x3
    convolution on an even input has the same output size but other values
    (flax pads 0 before and 1 after)."""
    from bagua_tpu_torch.models.resnet import Conv, same_pads

    assert same_pads(8, 3, 2) == (0, 1) and same_pads(9, 3, 2) == (1, 1)
    conv = Conv(2, 3, 3, 2, dtype=torch.float32, device="cpu")
    torch.nn.init.normal_(conv.weight)
    x = torch.randn(1, 2, 8, 8)
    sym = torch.nn.functional.conv2d(x, conv.weight, stride=2, padding=1)
    assert conv(x).shape == sym.shape and not torch.allclose(conv(x), sym)


def test_resnet_bf16_default_matches_jax():
    jm = JResNet(**SMALL)
    x = images(4, 32)
    v = jm.init(jax.random.PRNGKey(2), x[:2], train=True)
    want = np.asarray(jax.jit(lambda p, xx: jm.apply(
        {"params": p, "batch_stats": v["batch_stats"]}, xx, train=True,
        mutable=["batch_stats"])[0])(v["params"], x))
    m = load(ResNet(**SMALL, device="cpu"), v)
    got = m(nchw(x), update_stats=False).detach().numpy()
    np.testing.assert_allclose(got, want, atol=BF16_TOL * np.abs(want).max(), rtol=BF16_TOL)


def test_running_average_mode_matches_jax():
    """``train=False`` normalizes with the running statistics."""
    jm = jax_resnet()
    x = images(4, 32)
    v = jm.init(jax.random.PRNGKey(2), x[:2], train=True)
    stats = jax.tree.map(lambda a: a + 0.5, v["batch_stats"])
    want = np.asarray(jm.apply({"params": v["params"], "batch_stats": stats}, x, train=False))
    m = load(port_resnet(), {"params": v["params"], "batch_stats": stats})
    got = m(nchw(x), train=False).detach().numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("policy", [None, "dots"])
def test_remat_is_bitwise(policy):
    x, y = nchw(images(4, 32)), torch.from_numpy(labels(4)).long()
    runs = []
    for remat in (False, True):
        m = port_resnet(remat=remat, remat_policy=policy)
        loss = classification_loss_fn(m, {"images": x, "labels": y})
        loss.backward()
        runs.append((loss.detach(), {n: p.grad for n, p in m.named_parameters()}))
    assert torch.equal(runs[0][0], runs[1][0])
    for n, g in runs[0][1].items():
        assert torch.equal(g, runs[1][1][n]), n


def test_loss_leaves_running_stats():
    """The trainer's loss normalizes with batch statistics and never moves
    the running ones (the JAX package's ``classification_loss_fn``)."""
    m = port_resnet()
    before = {n: b.clone() for n, b in m.named_buffers()}
    classification_loss_fn(m, {"images": nchw(images(4, 32)),
                               "labels": torch.from_numpy(labels(4))}).backward()
    assert all(torch.equal(b, before[n]) for n, b in m.named_buffers())


def test_full_width_counts_match_jax():
    x = jnp.zeros((1, 224, 224, 3))
    jr = jax.eval_shape(lambda: JResNet50(num_classes=1000).init(jax.random.PRNGKey(0), x))
    jv = jax.eval_shape(lambda: JVGG16(num_classes=1000).init(jax.random.PRNGKey(0), x))
    for jtree, model, n_params, n_leaves in (
            (jr, ResNet50(num_classes=1000, device="meta"), 25_557_032, 161),
            (jv, VGG16(num_classes=1000, device="meta"), 138_357_544, 32)):
        params = list(model.named_parameters())
        jleaves = jax.tree.leaves(jtree["params"])
        assert sum(p.numel() for _, p in params) == sum(a.size for a in jleaves) == n_params
        assert len(params) == len(jleaves) == n_leaves
        # names and shapes through the converter's layouts
        named = {n: torch.zeros(p.shape) for n, p in params}
        back = params_to_jax(named, jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                                                 jtree["params"]))
        assert jax.tree.map(np.shape, back) == jax.tree.map(lambda a: a.shape, jtree["params"])
    stats = dict(ResNet50(num_classes=1000, device="meta").named_buffers())
    assert len(stats) == len(jax.tree.leaves(jr["batch_stats"])) == 106


@pytest.mark.parametrize("kind", ["resnet", "vgg"])
def test_params_roundtrip(kind):
    if kind == "resnet":
        jm, model = jax_resnet(), port_resnet()
        v = jm.init(jax.random.PRNGKey(3), images(2, 32), train=True)
    else:
        jm, model = JVGG(**SMALL_VGG), VGG(**SMALL_VGG, image_size=16, device="cpu")
        v = jm.init(jax.random.PRNGKey(3), images(2, 16))
    v = to_np(v)
    load(model, v)
    back = params_to_jax(dict(model.named_parameters()), v["params"])
    assert max_gap(back, v["params"]) == 0.0
    if "batch_stats" in v:
        stats = jax.tree.map(lambda a: a + np.arange(a.size, dtype=np.float32), v["batch_stats"])
        batch_stats_from_jax(stats, model)
        assert max_gap(batch_stats_to_jax(model), stats) == 0.0


def test_vgg_forward_and_gradients_match_jax():
    jm = JVGG(**SMALL_VGG, dtype=jnp.float32)
    x, y = images(4, 16), labels(4)
    v = jm.init(jax.random.PRNGKey(2), x[:2])

    @jax.jit
    def jloss(p, xx):
        logits = jm.apply({"params": p}, xx)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean(), logits

    (_, want), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(v["params"], x)
    m = load(VGG(**SMALL_VGG, dtype=torch.float32, image_size=16, device="cpu"), v)
    xt = nchw(x).requires_grad_()
    logits = m(xt)
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(y).long()).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx),
                               atol=F32_TOL, rtol=F32_TOL)
    got = params_to_jax({n: p.grad for n, p in m.named_parameters()}, to_np(gp))
    assert max_gap(got, to_np(gp)) <= F32_TOL


# ---- trainer parity ----------------------------------------------------------


def trainer_batch(size=32):
    return images(16, size), labels(16)


@functools.lru_cache(maxsize=None)
def jax_resnet_run():
    """The JAX trainer on the 8-device mesh, SyncBN over dp: 5 SGD steps of
    the small ResNet; its losses, final params and initial variables."""
    jm = jax_resnet(sync=True)
    x, y = trainer_batch()
    v = jm.init(jax.random.PRNGKey(2), x[:2], train=True)
    trainer = JTrainer(jcls_loss(jm, batch_stats=v["batch_stats"]), optax.sgd(0.05), JGA(),
                       mesh=build_mesh({"dp": len(jax.devices())}), autotune=False)
    state = trainer.init(v["params"])
    losses = []
    for _ in range(STEPS):
        state, loss = trainer.train_step(state, {"images": x, "labels": y})
        losses.append(float(loss))
    return np.array(losses), to_np(trainer.unstack_params(state)), to_np(v)


def port_run(model, loss_fn, x, y):
    trainer = bt.BaguaTrainer(loss_fn, functools.partial(torch.optim.SGD, lr=0.05),
                              bt.GradientAllReduceAlgorithm(), device="cpu")
    state = trainer.init(model)
    batch = trainer.shard_batch({"images": nchw(x), "labels": torch.from_numpy(y)})
    losses = []
    for _ in range(STEPS):
        state, loss = trainer.train_step(state, batch)
        losses.append(loss.item())
    return np.array(losses), trainer.unstack_params(state)


def test_resnet_trainer_matches_jax():
    want_losses, want_params, v = jax_resnet_run()
    x, y = trainer_batch()
    local = {"params": rename(v["params"], "SyncBatchNorm_", "BatchNorm_")}
    for sync, variables in ((True, v), (False, local)):
        losses, params = port_run(load(port_resnet(sync=sync), variables),
                                  classification_loss_fn, x, y)
        assert losses[-1] < losses[0]
        np.testing.assert_allclose(losses, want_losses, rtol=F32_TOL, atol=F32_TOL)
        got = params_to_jax(params, variables["params"])
        if not sync:
            got = rename(got, "BatchNorm_", "SyncBatchNorm_")
        assert max_gap(got, want_params) <= F32_TOL


def test_vgg_trainer_matches_jax():
    jm = JVGG(**SMALL_VGG, dtype=jnp.float32)
    x, y = images(16, 16), labels(16)
    v = to_np(jm.init(jax.random.PRNGKey(2), x[:2]))
    trainer = JTrainer(jvgg_loss(jm), optax.sgd(0.05), JGA(),
                       mesh=build_mesh({"dp": len(jax.devices())}), autotune=False)
    state = trainer.init(v["params"])
    want = []
    for _ in range(STEPS):
        state, loss = trainer.train_step(state, {"images": x, "labels": y})
        want.append(float(loss))
    m = load(VGG(**SMALL_VGG, dtype=torch.float32, image_size=16, device="cpu"), v)
    losses, params = port_run(m, vgg_loss_fn, x, y)
    np.testing.assert_allclose(losses, want, rtol=F32_TOL, atol=F32_TOL)
    assert max_gap(params_to_jax(params, v["params"]), to_np(trainer.unstack_params(state))) \
        <= F32_TOL
