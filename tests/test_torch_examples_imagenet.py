"""``examples/torch/imagenet_resnet.py --tiny`` against ``examples/imagenet_resnet.py``.

The port runs at two gloo ranks (4 images a rank, SyncBN over both,
``CachedDataset`` over the TCP store, the load-balancing sampler's shards,
fused SGD) from the JAX example's init carried across by
``params_from_jax``; it prints ``final_loss`` and ``cache_entries``.  The JAX
example's trainer lines take the same 8 images (rank 0's first batch, then
rank 1's, decoded by the JAX example's ``SyntheticImageNet``) on its 8 CPU
devices, SyncBN over all of them: the first loss agrees within 2e-2
relative (both ResNets compute in bf16, whose matmuls and convolutions
round differently in torch and XLA).  ``--algorithm bytegrad`` trains at two
ranks too (the codec's plain path on the CPU).
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from workers.torch_example_worker import spawn

torch.set_num_threads(1)   # these tests share the CPU with the other workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PER_RANK, SIZE, CLASSES = 4, 64, 16


def _jax_example():
    path = os.path.join(REPO, "examples", "imagenet_resnet.py")
    spec = importlib.util.spec_from_file_location("jax_imagenet_resnet", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_model():
    import bagua_tpu
    from bagua_tpu.contrib import SyncBatchNorm
    from bagua_tpu.models.resnet import ResNet

    mesh = bagua_tpu.init_process_group()
    model = ResNet(stage_sizes=(1, 1), num_classes=CLASSES, num_filters=16,
                   norm_cls=functools.partial(SyncBatchNorm, axis_name=mesh.axis_names))
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((2, SIZE, SIZE, 3), jnp.float32),
                           train=True)
    return mesh, model, variables


def _jax_first_loss(mesh, model, variables, sample_ids):
    import bagua_tpu
    from bagua_tpu.algorithms.gradient_allreduce import GradientAllReduceAlgorithm
    from bagua_tpu.contrib import fuse_optimizer
    from bagua_tpu.models.resnet import classification_loss_fn

    jex = _jax_example()
    data = jex.SyntheticImageNet(PER_RANK * 2 * 8, SIZE, CLASSES)
    samples = [data[i] for i in sample_ids]
    trainer = bagua_tpu.BaguaTrainer(
        classification_loss_fn(model, batch_stats=variables["batch_stats"]),
        fuse_optimizer(optax.sgd(0.05, momentum=0.9)), GradientAllReduceAlgorithm(), mesh=mesh)
    state = trainer.init(variables["params"])
    batch = trainer.shard_batch({"images": np.stack([s[0] for s in samples]),
                                 "labels": np.array([s[1] for s in samples], np.int32)})
    _, loss = trainer.train_step(state, batch)
    return float(loss)


def test_two_ranks_print_and_first_loss_matches_jax(jax_model, tmp_path):
    mesh, model, variables = jax_model
    params = jax.tree.map(np.asarray, variables["params"])
    ranks = spawn("imagenet_resnet", 2, ["--tiny", "--steps", "2", "--batch-per-device",
                                         str(PER_RANK)], tmp_path, params=params)
    for rec in ranks:
        assert "final_loss" in rec["stdout"] and "cache_entries" in rec["stdout"]
        assert rec["cache_entries"] > 0 and np.isfinite(rec["losses"]).all()
    assert ranks[0]["losses"] == ranks[1]["losses"]
    ids = ranks[0]["first_samples"] + ranks[1]["first_samples"]
    assert len(set(ids)) == 2 * PER_RANK      # the sampler's shards do not overlap
    want = _jax_first_loss(mesh, model, variables, ids)
    np.testing.assert_allclose(ranks[0]["losses"][0], want, rtol=2e-2)


def test_bytegrad_trains_at_two_ranks(tmp_path):
    ranks = spawn("imagenet_resnet", 2, ["--tiny", "--steps", "2", "--batch-per-device", "2",
                                         "--algorithm", "bytegrad"], tmp_path)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert np.isfinite(ranks[0]["losses"]).all()
