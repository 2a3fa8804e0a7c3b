"""The port's rematerialization (``TransformerConfig(remat=True,
remat_policy=...)``, ``bagua_tpu_torch.utils.remat_wrap``) against no remat
and against the JAX package's.

Mirrors ``tests/test_models.py::test_remat_policies_preserve_gradients``:
a policy changes what the backward keeps, never the math.

- bf16: each policy (None, ``"dots"``, ``"dots_no_batch"``) against no remat,
  loss within 1e-4 and gradients within rtol 3e-2 / atol 3e-3 (the JAX
  test's tolerances, for XLA's refusions).  The port recomputes with the same
  eager ops, so in f32 the loss and every gradient are bitwise equal to the
  run without remat, and the test holds them so.
- The port's remat model against the JAX package's remat model from the
  same weights, f32, loss and gradients within 1e-4 (summation order only,
  as ``tests/test_torch_transformer.py``); the dropless MoE LM of
  ``tests/test_torch_moe.py`` likewise, its blocks recomputed whole.
- The policy keeps only the matmuls it names: under a flash-like attention
  that writes into a ``torch.empty`` tensor outside the dispatcher (as the
  kernels do through ``ctypes``), every allocation is recomputed, and the
  gradients equal those without remat.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bagua_tpu_torch as bt
from bagua_tpu.model_parallel.moe.layer import MoEMLP as JMoEMLP
from bagua_tpu.model_parallel.moe.layer import moe_lm_loss_fn as jmoe_lm_loss_fn
from bagua_tpu.models.transformer import TransformerConfig as JConfig
from bagua_tpu.models.transformer import TransformerLM as JLM
from bagua_tpu.models.transformer import lm_loss_fn as jlm_loss_fn
from bagua_tpu_torch import utils
from bagua_tpu_torch.model_parallel.moe.layer import MoEMLP, moe_lm_loss_fn
from bagua_tpu_torch.models.convert import params_from_jax
from bagua_tpu_torch.models.transformer import TransformerConfig, TransformerLM, lm_loss_fn
from bagua_tpu_torch.ops.flash_attention import reference_attention

torch.set_num_threads(1)

SMALL = dict(vocab_size=97, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq_len=32)
POLICIES = [None, "dots", "dots_no_batch"]
E, K = 4, 2


def _tokens(seed=0, vocab=SMALL["vocab_size"], s=SMALL["max_seq_len"] + 1):
    return torch.randint(0, vocab, (2, s), generator=torch.Generator().manual_seed(seed))


def _loss_and_grads(cfg, tokens, loss_fn=lm_loss_fn, **kw):
    model = TransformerLM(cfg, device="cpu", seed=1, **kw)
    loss = loss_fn(model, {"tokens": tokens})
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_remat_policies_preserve_gradients(policy):
    cfg0 = TransformerConfig(**SMALL)
    tokens = _tokens()
    l0, g0 = _loss_and_grads(cfg0, tokens)
    l1, g1 = _loss_and_grads(dataclasses.replace(cfg0, remat=True, remat_policy=policy), tokens)
    assert abs(l0 - l1) < 1e-4, (policy, l0, l1)
    for n in g0:
        np.testing.assert_allclose(g1[n].float().numpy(), g0[n].float().numpy(), rtol=3e-2,
                                   atol=3e-3, err_msg=n)


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_remat_is_bitwise_in_f32(policy):
    cfg0 = TransformerConfig(**SMALL, dtype=torch.float32)
    tokens = _tokens(1)
    l0, g0 = _loss_and_grads(cfg0, tokens)
    l1, g1 = _loss_and_grads(dataclasses.replace(cfg0, remat=True, remat_policy=policy), tokens)
    assert l0 == l1
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_remat_matches_jax_remat(policy):
    jmodel = JLM(JConfig(**SMALL, dtype=jnp.float32, remat=True, remat_policy=policy))
    params = jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))["params"]
    model = TransformerLM(TransformerConfig(**SMALL, dtype=torch.float32, remat=True,
                                            remat_policy=policy), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), model))
    tokens = _tokens(2).numpy().astype(np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(jlm_loss_fn(jmodel)))(
        params, {"tokens": jnp.asarray(tokens)})
    loss = lm_loss_fn(model, {"tokens": torch.from_numpy(tokens).long()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-4, rtol=1e-4)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), model)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_moe_blocks_under_remat_match_jax_and_no_remat():
    small = dict(vocab_size=256, d_model=128, n_heads=2, n_layers=2, d_ff=256, max_seq_len=64)
    jmodel = JLM(JConfig(**small, dtype=jnp.float32, remat=True), mlp_factory=lambda i: (
        lambda: JMoEMLP(n_experts=E, d_ff=small["d_ff"], k=K, dropless=True,
                        dtype=jnp.float32)) if i % 2 == 1 else None)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]

    def port(remat):
        model = TransformerLM(TransformerConfig(**small, dtype=torch.float32, remat=remat),
                              device="cpu", mlp_factory=lambda i: (
            lambda: MoEMLP(E, small["d_ff"], d_model=small["d_model"], k=K, dropless=True,
                           dtype=torch.float32)) if i % 2 == 1 else None)
        model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), model))
        return model

    tokens = np.random.default_rng(3).integers(0, small["vocab_size"],
                                               (2, small["max_seq_len"] + 1), dtype=np.int32)
    batch = {"tokens": torch.from_numpy(tokens).long()}
    runs = {}
    for remat in (False, True):
        model = port(remat)
        loss = moe_lm_loss_fn()(model, batch)
        loss.backward()
        runs[remat] = loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}
    assert runs[True][0] == runs[False][0]
    for n, g in runs[False][1].items():
        assert torch.equal(runs[True][1][n], g), n
    assert runs[True][1]["block_1.mlp.expert_wi"].abs().sum() > 0
    jloss, jgrads = jax.jit(jax.value_and_grad(jmoe_lm_loss_fn(jmodel)))(
        params, {"tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(runs[True][0], float(jloss), atol=1e-4, rtol=1e-4)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), port(True))
    for n, g in runs[True][1].items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=1e-4, rtol=1e-4, err_msg=n)


class _OutOfDispatcher(torch.autograd.Function):
    """Attention whose output is allocated with ``torch.empty`` and written
    outside the dispatcher, as the kernel wrappers do through ``ctypes``."""

    @staticmethod
    def forward(ctx, q, k, v):
        out = torch.empty_like(q)
        out.numpy()[...] = reference_attention(q, k, v).numpy()
        ctx.save_for_backward(q, k, v)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            return torch.autograd.grad(reference_attention(q, k, v), (q, k, v), do)


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch"])
def test_remat_caches_no_allocation(policy, monkeypatch):
    decisions = []
    real = utils.save_policy

    def spy(name):
        fn = real(name)

        def policy_fn(ctx, op, *args, **kwargs):
            decision = fn(ctx, op, *args, **kwargs)
            decisions.append((op, decision))
            return decision

        return policy_fn

    monkeypatch.setattr(utils, "save_policy", spy)
    attn = lambda q, k, v, dtype: _OutOfDispatcher.apply(q, k, v)  # noqa: E731
    cfg0 = TransformerConfig(**SMALL, dtype=torch.float32)
    tokens = _tokens(4)
    l0, g0 = _loss_and_grads(cfg0, tokens, attn_fn=attn)
    l1, g1 = _loss_and_grads(dataclasses.replace(cfg0, remat=True, remat_policy=policy), tokens,
                             attn_fn=attn)
    saved = {op for op, d in decisions if d == utils.CheckpointPolicy.MUST_SAVE}
    allocs = [d for op, d in decisions if "empty" in str(op)]
    assert saved and saved <= utils.SAVED_OPS[policy], saved
    assert allocs and all(d == utils.CheckpointPolicy.PREFER_RECOMPUTE for d in allocs)
    assert l0 == l1
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def test_remat_wrap_rejects_unknown_policy():
    with pytest.raises(ValueError, match="remat_policy"):
        utils.remat_wrap(torch.nn.Identity(), "everything")


@pytest.mark.parametrize("layout", ["off", "on"])
def test_trainer_steps_under_remat_equal_no_remat(layout):
    """Three AdamW steps of ``BaguaTrainer`` with two microbatches a step, in
    f32, with and without remat (``dots_no_batch``): the same losses and
    parameters, bit for bit, in either layout."""
    bt.init_process_group(device="cpu")
    tokens = _tokens(5, s=SMALL["max_seq_len"] + 1).repeat(2, 1)
    runs = []
    for remat in (False, True):
        cfg = TransformerConfig(**SMALL, dtype=torch.float32, remat=remat,
                                remat_policy="dots_no_batch")
        trainer = bt.BaguaTrainer(lm_loss_fn, functools.partial(torch.optim.AdamW, lr=1e-3),
                                  bt.GradientAllReduceAlgorithm(), device="cpu",
                                  accum_steps=2, flat_resident=layout)
        state = trainer.init(TransformerLM(cfg, device="cpu", seed=1))
        losses = []
        for _ in range(3):
            state, loss = trainer.train_step(state, {"tokens": tokens})
            losses.append(loss.item())
        runs.append((losses, trainer.unstack_params(state)))
    assert runs[0][0] == runs[1][0]
    for n, p in runs[0][1].items():
        assert torch.equal(p, runs[1][1][n]), n
