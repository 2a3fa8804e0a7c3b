"""The port's encoder trunk, ``TransformerLM(head=False)``, against the JAX
package's, and ``examples/torch/squad_finetune.py``'s ``SquadModel`` (the
trunk under a ``qa_head``) against ``examples/squad_finetune.py``'s.

Weights are made once by flax and carried across with
``models.convert.params_from_jax``; the same numpy tokens go through both,
in f32 on the CPU.  Hidden states within 1e-5; the span loss within 1e-5;
its gradients within 1e-4 (summation order only).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bagua_tpu.models.transformer import TransformerConfig as JConfig
from bagua_tpu.models.transformer import TransformerLM as JLM
from bagua_tpu_torch.models.convert import params_from_jax, params_to_jax
from bagua_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from workers.torch_example_worker import load

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE = dict(vocab_size=256, d_model=128, n_heads=2, n_layers=2, d_ff=256, max_seq_len=128)
# examples/squad_finetune.py's --tiny configuration at --seq 64
SQUAD_TINY = dict(vocab_size=1024, d_model=128, n_heads=4, n_layers=4, d_ff=512, max_seq_len=64)


def _jax_squad_example():
    path = os.path.join(REPO, "examples", "squad_finetune.py")
    spec = importlib.util.spec_from_file_location("jax_squad_finetune", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("widths", [DENSE, SQUAD_TINY], ids=["dense", "squad_tiny"])
def test_trunk_matches_jax(widths):
    jmodel = JLM(JConfig(**widths, dtype=jnp.float32), head=False)
    params = jmodel.init(jax.random.PRNGKey(7), jnp.zeros((1, 8), jnp.int32))["params"]
    assert "lm_head" not in params
    model = TransformerLM(TransformerConfig(**widths, dtype=torch.float32), device="cpu",
                          head=False)
    assert not hasattr(model, "lm_head")
    np_params = jax.tree.map(np.asarray, params)
    model.load_state_dict(params_from_jax(np_params, model))
    tokens = np.random.default_rng(3).integers(0, widths["vocab_size"],
                                               (2, widths["max_seq_len"]), dtype=np.int32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(tokens)))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32 and got.shape == want.shape == (
        2, widths["max_seq_len"], widths["d_model"])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # and back: the head-less tree round-trips
    back = params_to_jax(dict(model.named_parameters()), np_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(a, b)


def test_head_default_keeps_the_lm_head():
    model = TransformerLM(TransformerConfig(**DENSE), device="cpu")
    assert model.head and hasattr(model, "lm_head")
    out = model(torch.zeros((1, 4), dtype=torch.long))
    assert out.shape == (1, 4, DENSE["vocab_size"])


def test_squad_model_loss_and_qa_head_gradient_match_jax():
    jex = _jax_squad_example()
    tex = load("squad_finetune")
    jmodel = jex.SquadModel(JConfig(**SQUAD_TINY, dtype=jnp.float32))
    rng = np.random.default_rng(11)
    ids = rng.integers(0, SQUAD_TINY["vocab_size"], (4, SQUAD_TINY["max_seq_len"]),
                       dtype=np.int32)
    start = rng.integers(0, SQUAD_TINY["max_seq_len"], 4).astype(np.int32)
    end = np.minimum(start + 3, SQUAD_TINY["max_seq_len"] - 1).astype(np.int32)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids[:2]))["params"]

    def jloss_fn(p):
        s, e = jmodel.apply({"params": p}, jnp.asarray(ids))
        return 0.5 * (optax.softmax_cross_entropy_with_integer_labels(s, start).mean()
                      + optax.softmax_cross_entropy_with_integer_labels(e, end).mean())

    jloss, jgrads = jax.value_and_grad(jloss_fn)(params)
    model = tex.SquadModel(TransformerConfig(**SQUAD_TINY, dtype=torch.float32), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), model))
    batch = {"ids": torch.from_numpy(ids), "start": torch.from_numpy(start),
             "end": torch.from_numpy(end)}
    loss = tex.squad_loss_fn(model, batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5, rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), model)
    for name in ("qa_head.weight", "qa_head.bias"):
        np.testing.assert_allclose(model.get_parameter(name).grad.numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=name)
