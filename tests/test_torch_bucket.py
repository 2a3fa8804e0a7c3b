"""Port's tensor registry and bucketing against the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bagua_tpu import bucket as jbucket
from bagua_tpu import define as jdefine
from bagua_tpu import tensor as jtensor
from bagua_tpu.model_parallel.moe import MoEMLP as JMoEMLP
from bagua_tpu.models.transformer import TransformerConfig as JConfig
from bagua_tpu.models.transformer import TransformerLM as JLM
from bagua_tpu_torch import bucket as tbucket
from bagua_tpu_torch import define as tdefine
from bagua_tpu_torch import tensor as ttensor
from bagua_tpu_torch.model_parallel.moe import MoEMLP
from bagua_tpu_torch.models.convert import torch_name
from bagua_tpu_torch.models.transformer import TransformerConfig, TransformerLM

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

SMALL = dict(vocab_size=256, d_model=128, n_heads=2, n_layers=2, d_ff=256,
             max_seq_len=128)


def _pair(jax_mlp_factory=None, mlp_factory=None):
    # names, shapes and dtypes are all the plans read, so no init runs
    jmodel = JLM(JConfig(**SMALL), mlp_factory=jax_mlp_factory)
    jparams = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                             jnp.zeros((1, 8), jnp.int32))["params"]
    return jparams, TransformerLM(TransformerConfig(**SMALL), device="cpu",
                                  mlp_factory=mlp_factory)


@pytest.fixture(scope="module")
def models():
    return _pair()


@pytest.fixture(scope="module")
def moe_models():
    """The MoE LM of the dropless slice at small widths: a MoE in every odd
    layer, which flax names ``MoEMLP_0`` and sorts first in its block."""
    return _pair(
        lambda i: (lambda: JMoEMLP(n_experts=8, d_ff=SMALL["d_ff"], k=2,
                                   dropless=True)) if i % 2 == 1 else None,
        lambda i: (lambda: MoEMLP(8, SMALL["d_ff"], d_model=SMALL["d_model"], k=2,
                                  dropless=True)) if i % 2 == 1 else None)


def _assert_same_order(jparams, model):
    want = [torch_name(p.name) for p in jtensor.build_params(jparams)]
    assert [p.name for p in ttensor.build_params(model)] == want
    assert want[0] == "pos_embed.weight"  # reversed registration order
    return want


def test_build_params_order_matches(models):
    _assert_same_order(*models)


def test_moe_build_params_order_matches(moe_models):
    names = _assert_same_order(*moe_models)
    assert names.index("block_1.mlp.router.weight") < names.index(
        "block_1.mlp.expert_wo") < names.index("block_1.mlp.expert_wi")
    assert "block_1.mlp.wo.weight" not in names


def _assert_same_partition(jparams, model, bucket_bytes):
    jplan = jbucket.BucketPlan.build(jtensor.build_params(jparams), bucket_bytes)
    tplan = tbucket.BucketPlan.build(ttensor.build_params(model), bucket_bytes)
    want = [[torch_name(t.name) for t in b.tensors] for b in jplan.buckets]
    assert [[t.name for t in b.tensors] for b in tplan.buckets] == want
    assert [b.numel for b in tplan.buckets] == [b.numel for b in jplan.buckets]
    if bucket_bytes < 10 * 1024 ** 2:
        assert len(want) > 1


@pytest.mark.parametrize("bucket_bytes", [64 * 1024, 300 * 1024, 10 * 1024 ** 2])
def test_bucket_partition_matches(models, bucket_bytes):
    _assert_same_partition(*models, bucket_bytes)


@pytest.mark.parametrize("bucket_bytes", [64 * 1024, 300 * 1024, 10 * 1024 ** 2])
def test_moe_bucket_partition_matches(moe_models, bucket_bytes):
    _assert_same_partition(*moe_models, bucket_bytes)


@pytest.mark.parametrize("bucket_bytes", [64 * 1024, 300 * 1024])
def test_flatten_unflatten_round_trip(models, bucket_bytes):
    _, model = models
    plan = tbucket.BucketPlan.build(ttensor.build_params(model), bucket_bytes)
    named = dict(model.named_parameters())
    flats = plan.flatten(named)
    assert [f.numel() for f in flats] == [b.numel for b in plan.buckets]
    assert all(f.is_contiguous() for f in flats)
    back = plan.unflatten(flats)
    assert set(back) == set(named)
    for name, t in named.items():
        assert torch.equal(back[name], t.detach())
    # unflatten hands out views: writing a flat changes the named tensors
    flats[0].fill_(3.0)
    first = plan.buckets[0].tensors[0].name
    assert torch.all(back[first] == 3.0)


def test_split_bucket_mixed_dtypes_matches():
    rng = np.random.default_rng(0)
    dtypes = ["f32", "bf16", "f16", "f32", "i32", "bf16", "u8", "f32", "i64"] * 3
    decl = [(f"t{i}", int(rng.integers(1, 5000)), d) for i, d in enumerate(dtypes)]
    jdecl = [jdefine.TensorDeclaration(name=n, num_elements=e, dtype=d)
             for n, e, d in decl]
    tdecl = [tdefine.TensorDeclaration(name=n, num_elements=e,
                                       dtype=tdefine.TensorDtype(d))
             for n, e, d in decl]
    for size in (1, 4096, 20000, 10 ** 9):
        want = jbucket.split_bucket_by_bucket_size(jdecl, size)
        got = tbucket.split_bucket_by_bucket_size(tdecl, size)
        assert [[t.name for t in b] for b in got] == [[t.name for t in b] for b in want]
        assert [[t.nbytes for t in b] for b in got] == [[t.nbytes for t in b] for b in want]


def test_declaration_dtypes():
    for dtype, name in [(torch.float32, "f32"), (torch.bfloat16, "bf16"),
                        (torch.uint8, "u8"), (torch.int64, "i64")]:
        assert tdefine.to_bagua_datatype(dtype) == name
        assert tdefine.to_bagua_datatype(dtype) == jdefine.TensorDtype(name).value
    with pytest.raises(ValueError):
        tdefine.to_bagua_datatype(torch.complex64)


def test_tied_weights_registered_once():
    class Tied(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a = torch.nn.Linear(2, 2)
            self.b = self.a

    params = ttensor.build_params(Tied())
    assert [p.name for p in params] == ["a.bias", "a.weight"]
    assert params[1].declaration().nbytes == 16
