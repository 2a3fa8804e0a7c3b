"""The port's SyncBatchNorm against the JAX package's
(``tests/test_contrib_sync_bn.py`` mirrored case for case).

One launch of ``tests/workers/torch_vision_worker.py`` on 4 gloo ranks runs
the collective cases at world 2 (the mesh ``{"rep": 2, "dp": 2}``: two dp
pairs) and at world 4 (``{"dp": 4}``):

- each rank's slice of the output and the running statistics equal to
  flax's ``nn.BatchNorm`` over the whole batch (within 2e-5; mean 1e-5,
  biased variance 1e-4 relative, the JAX test's tolerances), the batch
  statistics bitwise equal on every rank of a group;
- the gradient of the summed per-rank losses through the collective equal
  to the full-batch gradient (within 2e-4 relative, 2e-5 absolute);
- the small ResNet trained 5 SGD steps at world 2 with SyncBN equal to the
  JAX trainer's SyncBN run on the 8-device mesh
  (``test_torch_resnet.jax_resnet_run``), losses and parameters within
  1e-5; the local norm at world 2 (each rank normalizing its half) misses
  that gate.

In-process: the running-average mode, the unbound-axis fallback to the
local norm, and ``norm_cls`` in ResNet against the JAX model's logits.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bagua_tpu_torch as bt
from bagua_tpu.contrib import SyncBatchNorm as JSyncBN
from bagua_tpu.models.resnet import ResNet as JResNet
from bagua_tpu_torch.contrib import SyncBatchNorm
from bagua_tpu_torch.models.convert import params_from_jax, params_to_jax
from bagua_tpu_torch.models.resnet import BatchNorm, ResNet

import test_torch_resnet as tr
from workers import torch_vision_worker as worker

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def process_group():
    bt.init_process_group(device="cpu")


def _x():
    """The JAX test's inputs: ``[32, 6, 5]`` (features last) and ``[16, 4]``."""
    x = np.array(jax.random.normal(jax.random.PRNGKey(0), (32, 6, 5)) * 3.0 + 1.5)
    x2 = np.array(jax.random.normal(jax.random.PRNGKey(0), (16, 4)))
    return x, x2


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    x, x2 = _x()
    _, _, v = tr.jax_resnet_run()
    images, labels = tr.trainer_batch()
    data = {"x": np.ascontiguousarray(np.moveaxis(x, -1, 1)), "x2": x2,
            "images": images, "labels": labels}
    flat = {"sync": v["params"],
            "local": tr.rename(v["params"], "SyncBatchNorm_", "BatchNorm_")}
    for norm, params in flat.items():
        for name, arr in jax.tree_util.tree_flatten_with_path(params)[0]:
            key = ".".join(str(k.key) for k in name)
            data[f"params_{norm}/{key}"] = np.asarray(arr)
    return worker.spawn(data, tmp_path_factory.mktemp("vision"))


def _group_rows(outs, case, key, world):
    """The outputs of one group of ``world`` ranks in dp order (at world 2
    ranks 0 and 1 form the first pair), concatenated along dim 0."""
    return np.concatenate([outs[r][f"{case}/{key}"] for r in range(world)])


@pytest.mark.parametrize("world", [2, 4])
def test_sync_bn_matches_full_batch_bn(spawned, world):
    x, _ = _x()
    ref = nn.BatchNorm(use_running_average=False)
    v = ref.init(jax.random.PRNGKey(1), x[:2])
    y_ref, upd = ref.apply(v, x, mutable=["batch_stats"])
    case = f"bn_w{world}"
    y = np.moveaxis(_group_rows(spawned, case, "y", world), 1, -1)
    np.testing.assert_allclose(y, np.asarray(y_ref), rtol=2e-5, atol=2e-5)
    for r in range(4):
        out = spawned[r]
        np.testing.assert_allclose(out[f"{case}/ra_mean"], np.asarray(upd["batch_stats"]["mean"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out[f"{case}/ra_var"], np.asarray(upd["batch_stats"]["var"]),
                                   rtol=1e-4, atol=1e-5)
        for key in ("batch_mean", "batch_var"):
            np.testing.assert_array_equal(out[f"{case}/{key}"], spawned[0][f"{case}/{key}"])


@pytest.mark.parametrize("world", [2, 4])
def test_sync_bn_gradient_flows_through_pmean(spawned, world):
    _, x2 = _x()
    ref = nn.BatchNorm(use_running_average=False)
    v = JSyncBN(use_running_average=False, axis_name="dp").init(jax.random.PRNGKey(1), x2[:2])

    def loss_full(xs):
        y, _ = ref.apply(v, xs, mutable=["batch_stats"])
        return jnp.sum(y ** 2)

    want = np.asarray(jax.grad(loss_full)(x2))
    got = _group_rows(spawned, f"bn_w{world}", "grad", world)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_trainer_world2_sync_bn_matches_jax(spawned):
    want_losses, want_params, v = tr.jax_resnet_run()
    for r, out in enumerate(spawned):
        assert int(out["train_sync/world"]) == 2
        np.testing.assert_allclose(out["train_sync/losses"], want_losses, rtol=tr.F32_TOL,
                                   atol=tr.F32_TOL)
        named = {k[len("train_sync/param/"):]: torch.from_numpy(a) for k, a in out.items()
                 if k.startswith("train_sync/param/")}
        assert tr.max_gap(params_to_jax(named, v["params"]), want_params) <= tr.F32_TOL, r
    # the control: the local norm at world 2 normalizes each half alone
    gap = np.max(np.abs(spawned[0]["train_local/losses"] - want_losses))
    assert gap > 100 * tr.F32_TOL, gap


def test_running_average_mode_uses_stats():
    x = np.array(jax.random.normal(jax.random.PRNGKey(0), (8, 3)))
    bn = SyncBatchNorm(3, use_running_average=True, axis_name=None)
    with torch.no_grad():
        bn.mean.copy_(torch.tensor([1.0, 2.0, 3.0]))
        bn.var.copy_(torch.tensor([4.0, 4.0, 4.0]))
    y = bn(torch.from_numpy(x)).detach().numpy()
    jbn = JSyncBN(use_running_average=True, axis_name=None)
    jv = jbn.init(jax.random.PRNGKey(1), x)
    stats = {"mean": jnp.array([1.0, 2.0, 3.0]), "var": jnp.array([4.0, 4.0, 4.0])}
    want = np.asarray(jbn.apply({"params": jv["params"], "batch_stats": stats}, x))
    np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y, (x - [1.0, 2.0, 3.0]) / np.sqrt(4.0 + bn.epsilon), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mesh", [None, {"sp": 1}, {"dp": 1}])
def test_unbound_axis_falls_back_to_local(mesh):
    """No mesh, a mesh without the axis, or a group of one rank: the local
    norm (the reference's world-size-1 fallback), as flax's ``BatchNorm``."""
    x = np.array(jax.random.normal(jax.random.PRNGKey(0), (8, 3)))
    v = nn.BatchNorm(use_running_average=False).init(jax.random.PRNGKey(1), x)
    want, _ = nn.BatchNorm(use_running_average=False).apply(v, x, mutable=["batch_stats"])
    bt.set_global_mesh(None if mesh is None else bt.build_mesh(mesh))
    try:
        y = SyncBatchNorm(3, use_running_average=False, axis_name="dp")(torch.from_numpy(x))
        local = BatchNorm(3, use_running_average=False)(torch.from_numpy(x))
    finally:
        bt.set_global_mesh(None)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(local.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_plugs_into_resnet_norm_cls():
    jm = JResNet(stage_sizes=(1,), num_classes=4, num_filters=8,
                 norm_cls=functools.partial(JSyncBN, axis_name="dp"))
    x = np.ones((2, 32, 32, 3), np.float32)
    v = jm.init(jax.random.PRNGKey(0), x, train=True)
    want, _ = jm.apply(v, x, train=True, mutable=["batch_stats"])
    model = ResNet(stage_sizes=(1,), num_classes=4, num_filters=8, device="cpu",
                   norm_cls=functools.partial(SyncBatchNorm, axis_name="dp"))
    assert any(isinstance(m, SyncBatchNorm) for m in model.modules())
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, v["params"]), model),
                          strict=False)
    logits = model(tr.nchw(x)).detach().numpy()
    assert logits.shape == (2, 4)
    want = np.asarray(want)
    np.testing.assert_allclose(logits, want, atol=tr.BF16_TOL * np.abs(want).max(),
                               rtol=tr.BF16_TOL)
