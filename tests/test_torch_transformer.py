"""Port's TransformerLM against the JAX package's, from the same weights.

Flax params are made once and converted with ``params_from_jax``; the same
numpy tokens go through both.  f32 config: logits within 1e-5, loss and
gradients within 1e-4 (summation order only).  bf16 config: rtol 2e-2 and
atol 2e-2 of the largest logit.  The port rounds to bf16 where flax does,
and its attention matches the JAX reference bit for bit, but torch's and
XLA's bf16 matmuls and RMSNorm round about 1 element in 2000 one ulp apart;
attention spreads each flip over a whole row, so after two layers a logit's
error scales with the activations, not with the logit itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bagua_tpu.models.transformer import TransformerConfig as JConfig
from bagua_tpu.models.transformer import TransformerLM as JLM
from bagua_tpu.models.transformer import lm_loss_fn as jlm_loss_fn
from bagua_tpu_torch.models.convert import params_from_jax, torch_name
from bagua_tpu_torch.models.transformer import (
    TransformerConfig, TransformerLM, lm_loss_fn,
)

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

SMALL = dict(vocab_size=256, d_model=128, n_heads=2, n_layers=2, d_ff=256,
             max_seq_len=128)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(kind, seed=0):
    jdt, tdt = DTYPES[kind]
    jmodel = JLM(JConfig(**SMALL, dtype=jdt))
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    np_params = jax.tree.map(np.asarray, params)
    model = TransformerLM(TransformerConfig(**SMALL, dtype=tdt), device="cpu")
    model.load_state_dict(params_from_jax(np_params, model))
    return jmodel, params, model


def _tokens(seed, b=2, s=SMALL["max_seq_len"] + 1):
    return np.random.default_rng(seed).integers(0, SMALL["vocab_size"], (b, s),
                                                dtype=np.int32)


@pytest.mark.parametrize("kind,tol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_logits_match_jax(kind, tol):
    jmodel, params, model = _pair(kind)
    tokens = _tokens(1)[:, :-1]
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(tokens)))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32 and got.shape == want.shape
    atol = tol * np.abs(want).max() if kind == "bf16" else tol
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=tol)


def test_loss_and_grads_match_jax():
    jmodel, params, model = _pair("f32", seed=3)
    tokens = _tokens(2)
    jloss, jgrads = jax.value_and_grad(jlm_loss_fn(jmodel))(
        params, {"tokens": jnp.asarray(tokens)})
    loss = lm_loss_fn(model, {"tokens": torch.from_numpy(tokens).long()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-4, rtol=1e-4)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), model)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


# examples/squad_finetune.py's --tiny configuration: head_dim 32, which the
# flash kernels do not take (on the card the model takes the reference path)
SQUAD_TINY = dict(vocab_size=1024, d_model=128, n_heads=4, n_layers=4, d_ff=512,
                  max_seq_len=64)


def test_squad_tiny_head_dim_32_matches_jax():
    jmodel = JLM(JConfig(**SQUAD_TINY, dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(4), jnp.zeros((1, 8), jnp.int32))["params"]
    model = TransformerLM(TransformerConfig(**SQUAD_TINY, dtype=torch.float32), device="cpu")
    assert model.cfg.head_dim == 32
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), model))
    tokens = np.random.default_rng(5).integers(0, SQUAD_TINY["vocab_size"],
                                               (2, SQUAD_TINY["max_seq_len"] + 1),
                                               dtype=np.int32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(tokens[:, :-1])))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens[:, :-1]).long())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    jloss, jgrads = jax.value_and_grad(jlm_loss_fn(jmodel))(
        params, {"tokens": jnp.asarray(tokens)})
    loss = lm_loss_fn(model, {"tokens": torch.from_numpy(tokens).long()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-4, rtol=1e-4)
    want_grads = params_from_jax(jax.tree.map(np.asarray, jgrads), model)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_params_from_jax_layouts():
    _, params, model = _pair("f32")
    sd = model.state_dict()
    q = np.asarray(params["block_0"]["attn"]["q"]["kernel"])     # [d, h, hd]
    o = np.asarray(params["block_0"]["attn"]["o"]["kernel"])     # [h, hd, d]
    wo = np.asarray(params["block_1"]["mlp"]["wo"]["kernel"])    # [d_ff, d]
    np.testing.assert_array_equal(sd["block_0.attn.q.weight"].numpy(),
                                  q.reshape(q.shape[0], -1).T)
    np.testing.assert_array_equal(sd["block_0.attn.o.weight"].numpy(),
                                  o.reshape(-1, o.shape[-1]).T)
    np.testing.assert_array_equal(sd["block_1.mlp.wo.weight"].numpy(), wo.T)
    np.testing.assert_array_equal(sd["embed.weight"].numpy(),
                                  np.asarray(params["embed"]["embedding"]))
    np.testing.assert_array_equal(sd["pos_embed.weight"].numpy(),
                                  np.asarray(params["pos_embed"]))
    assert torch_name("final_norm.scale") == "final_norm.scale"


def test_params_from_jax_rejects_a_mismatch():
    _, params, _ = _pair("f32")
    other = TransformerLM(TransformerConfig(**{**SMALL, "d_ff": 128}), device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        params_from_jax(jax.tree.map(np.asarray, params), other)
    fewer = TransformerLM(TransformerConfig(**{**SMALL, "n_layers": 1}), device="cpu")
    with pytest.raises(ValueError, match="param names differ"):
        params_from_jax(jax.tree.map(np.asarray, params), fewer)
