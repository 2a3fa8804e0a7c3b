"""Port's MoE (gating, ``MoEMLP``, the MoE TransformerLM and its training
step) against the JAX package's, from the same weights and inputs.

Flax params are converted with ``params_from_jax``; inputs come from numpy
with a seed.  Tolerances, each with its reason:

- gating in f32: indices equal, gates and ``l_aux`` within 1e-6 (the same
  softmax, summed in another order);
- ``MoEMLP`` and the MoE LM in f32: 1e-5 of the largest magnitude for
  outputs and logits, 1e-4 for the loss and gradients (summation order);
- the MoE LM in bf16: one bf16 ulp in the router's input can flip a
  near-tied top-2 choice between XLA and torch, and that moves whole rows,
  not ulps.  So the test reports the share of tokens whose routing agrees
  (at least 95%), and holds the logits of those tokens to 2e-2 of the
  largest logit (the dense LM's bf16 tolerance, tests/test_torch_transformer.py);
- the 3-step Adam run: losses 1e-4, parameters 1e-4, and each leaf's update
  within 5e-3 of JAX's in norm (as ``test_small_lm_adamw_matches_jax``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bagua_tpu_torch as bt
from bagua_tpu.algorithms.gradient_allreduce import (
    GradientAllReduceAlgorithm as JGradientAllReduce,
)
from bagua_tpu.core.backend import BaguaTrainer as JTrainer
from bagua_tpu.model_parallel.moe import gating as jgating
from bagua_tpu.model_parallel.moe.layer import MoEMLP as JMoEMLP
from bagua_tpu.model_parallel.moe.layer import is_expert_param as jis_expert_param
from bagua_tpu.model_parallel.moe.layer import moe_lm_loss_fn as jmoe_lm_loss_fn
from bagua_tpu.models.transformer import TransformerConfig as JConfig
from bagua_tpu.models.transformer import TransformerLM as JLM
from bagua_tpu.parallel.mesh import build_mesh
from bagua_tpu_torch.model_parallel.moe import gating as tgating
from bagua_tpu_torch.model_parallel.moe.layer import (
    MoEMLP, globalize_expert_params, is_expert_param, moe_lm_loss_fn,
)
from bagua_tpu_torch.models.convert import params_from_jax
from bagua_tpu_torch.models.transformer import TransformerConfig, TransformerLM

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

SMALL = dict(vocab_size=256, d_model=128, n_heads=2, n_layers=2, d_ff=256,
             max_seq_len=64)
E, K = 4, 2
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


# ---------------------------------------------------------------------------
# gating
# ---------------------------------------------------------------------------


def _logits(seed, tokens=64, n=8):
    return np.random.default_rng(seed).standard_normal((tokens, n)).astype(np.float32)


@pytest.mark.parametrize("gate", ["top1_gating", "top2_gating"])
@pytest.mark.parametrize("capacity", [5, 64])
def test_capacity_gating_matches_jax(gate, capacity):
    logits = _logits(capacity)
    jd, jc, jaux = getattr(jgating, gate)(jnp.asarray(logits), capacity)
    td, tc, taux = getattr(tgating, gate)(torch.from_numpy(logits), capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=1e-6, rtol=0)
    if capacity == 5:
        assert td.sum() < logits.shape[0]   # some tokens were dropped


@pytest.mark.parametrize("k", [1, 2, 3])
def test_topk_routing_matches_jax(k):
    logits = _logits(10 + k)
    jidx, jgates, jaux = jgating.topk_routing(jnp.asarray(logits), k)
    tidx, tgates, taux = tgating.topk_routing(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tgates.numpy(), np.asarray(jgates), atol=1e-6, rtol=0)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# MoEMLP
# ---------------------------------------------------------------------------


def _layer_pair(dropless, k, seed, capacity_factor=1.25, d=16, d_ff=32):
    x = np.random.default_rng(seed).standard_normal((2, 8, d)).astype(np.float32)
    jl = JMoEMLP(n_experts=E, d_ff=d_ff, k=k, dropless=dropless,
                 capacity_factor=capacity_factor, dtype=jnp.float32)
    params = jl.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    tl = MoEMLP(E, d_ff, d_model=d, k=k, dropless=dropless,
                capacity_factor=capacity_factor, dtype=torch.float32)
    tl.load_state_dict(params_from_jax(_np(params), tl))
    return jl, params, tl, x


@pytest.mark.parametrize("dropless", [True, False], ids=["dropless", "capacity"])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_layer_forward_and_grads_match_jax(dropless, k):
    jl, params, tl, x = _layer_pair(dropless, k, seed=k + 2 * dropless)
    g = np.random.default_rng(99).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        out, mut = jl.apply({"params": p}, xx, mutable=["intermediates"])
        aux = sum(jnp.sum(a) for a in jax.tree.leaves(mut["intermediates"]))
        return (out * g).sum() + 0.5 * aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    tout = tl(tx)
    ((tout * torch.from_numpy(g)).sum() + 0.5 * tl.l_aux).backward()
    _close(tout, jout, 1e-5, "out")
    np.testing.assert_allclose(tl.l_aux.item(), float(jaux), atol=1e-6, rtol=0)
    _close(tx.grad, jgx, 1e-4, "d_x")
    want = params_from_jax(_np(jgp), tl)
    for name, p in tl.named_parameters():
        _close(p.grad, want[name].numpy(), 1e-4, name)


def _dense_reference(layer, x, k):
    """Every token through its top-k experts, one expert at a time."""
    xt = x.reshape(-1, x.shape[-1])
    eidx, gates, _ = tgating.topk_routing(layer.router(xt), k)
    out = torch.zeros_like(xt)
    for t in range(xt.shape[0]):
        for j in range(k):
            e = int(eidx[t, j])
            h = torch.nn.functional.silu(xt[t] @ layer.expert_wi[e])
            out[t] += gates[t, j] * (h @ layer.expert_wo[e])
    return out.reshape(x.shape)


@pytest.mark.parametrize("k", [1, 2])
def test_dropless_equals_capacity_at_infinite_capacity(k):
    # capacity >= tokens drops nothing, so both modes compute the same math
    _, _, drop, x = _layer_pair(True, k, seed=20 + k)
    cap = MoEMLP(E, 32, d_model=16, k=k, dropless=False, dtype=torch.float32,
                 capacity_factor=float(x.shape[0] * x.shape[1]))
    cap.load_state_dict(drop.state_dict())
    with torch.no_grad():
        tx = torch.from_numpy(x)
        np.testing.assert_allclose(drop(tx).numpy(), cap(tx).numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(drop(tx).numpy(), _dense_reference(drop, tx, k).numpy(),
                                   atol=1e-5, rtol=0)


def test_dropless_never_drops_under_skew():
    # every token routed to expert 2: the capacity path drops, dropless not
    _, _, drop, x = _layer_pair(True, 1, seed=30)
    with torch.no_grad():
        drop.router.weight.zero_()
        drop.router.weight[2] = 10.0
        tx = torch.from_numpy(np.abs(x))          # positive: expert 2 wins
        out = drop(tx)
        np.testing.assert_allclose(out.numpy(), _dense_reference(drop, tx, 1).numpy(),
                                   atol=1e-5, rtol=0)
        assert out.abs().sum() > 0
        cap = MoEMLP(E, 32, d_model=16, k=1, dropless=False, dtype=torch.float32)
        cap.load_state_dict(drop.state_dict())
        dropped = (cap(tx).abs().sum(-1) == 0).sum().item()
    assert dropped > 0


def test_expert_param_names_and_ep_not_ported():
    for name in ("block_1.mlp.expert_wi", "['block_1']['MoEMLP_0']['expert_wo']",
                 "expert_wi_extra", "block_1.mlp.router.weight", "a/expert_wo"):
        assert is_expert_param(name) == jis_expert_param(name), name
    with pytest.raises(NotImplementedError, match="expert parallelism"):
        MoEMLP(8, 32, d_model=16, ep_size=2)
    with pytest.raises(NotImplementedError, match="expert parallelism"):
        globalize_expert_params({}, None, ep_size=2)


# ---------------------------------------------------------------------------
# the MoE TransformerLM
# ---------------------------------------------------------------------------


def _lm_pair(kind, seed=0, small=SMALL):
    jdt, tdt = DTYPES[kind]
    jmodel = JLM(JConfig(**small, dtype=jdt), mlp_factory=lambda i: (
        lambda: JMoEMLP(n_experts=E, d_ff=small["d_ff"], k=K, dropless=True, dtype=jdt)
    ) if i % 2 == 1 else None)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    model = TransformerLM(TransformerConfig(**small, dtype=tdt), device="cpu",
                          mlp_factory=lambda i: (
        lambda: MoEMLP(E, small["d_ff"], d_model=small["d_model"], k=K, dropless=True,
                       dtype=tdt)
    ) if i % 2 == 1 else None)
    model.load_state_dict(params_from_jax(_np(params), model))
    return jmodel, params, model


def _tokens(seed, b=2, s=SMALL["max_seq_len"] + 1):
    return np.random.default_rng(seed).integers(0, SMALL["vocab_size"], (b, s),
                                                dtype=np.int32)


def test_moe_lm_logits_loss_and_grads_match_jax_f32():
    jmodel, params, model = _lm_pair("f32", seed=1)
    tokens = _tokens(3)
    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(tokens[:, :-1]))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens[:, :-1]).long())
    _close(got, want, 1e-5, "logits")

    jloss, jgrads = jax.jit(jax.value_and_grad(jmoe_lm_loss_fn(jmodel)))(
        params, {"tokens": jnp.asarray(tokens)})
    loss = moe_lm_loss_fn()(model, {"tokens": torch.from_numpy(tokens).long()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-4, rtol=1e-4)
    want_g = params_from_jax(_np(jgrads), model)
    for name, p in model.named_parameters():
        _close(p.grad, want_g[name].numpy(), 1e-4, name)
    assert model.block_1.mlp.expert_wi.grad.abs().sum() > 0


def test_moe_lm_bf16_matches_jax_where_routing_agrees():
    jmodel, params, model = _lm_pair("bf16", seed=2)
    tokens = _tokens(4)[:, :-1]
    want, mut = jmodel.apply({"params": params}, jnp.asarray(tokens),
                             capture_intermediates=True, mutable=["intermediates"])
    jrouter = np.asarray(mut["intermediates"]["block_1"]["MoEMLP_0"]["router"]
                         ["__call__"][0])
    seen = {}
    hook = model.block_1.mlp.router.register_forward_hook(
        lambda mod, inp, out: seen.setdefault("logits", out.detach()))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long())
    hook.remove()
    jtop = np.sort(np.argsort(-jrouter, axis=-1)[:, :K], axis=-1)
    ttop = np.sort(torch.topk(seen["logits"], K, dim=-1).indices.numpy(), axis=-1)
    agree = (jtop == ttop).all(-1)                          # [b * s]
    assert agree.mean() >= 0.95, agree.mean()
    want = np.asarray(want).reshape(-1, SMALL["vocab_size"])
    got = got.numpy().reshape(-1, SMALL["vocab_size"])
    np.testing.assert_allclose(got[agree], want[agree], rtol=0,
                               atol=2e-2 * np.abs(want).max())


def test_moe_lm_three_adam_steps_match_jax_trainer():
    small = {**SMALL, "max_seq_len": 32}
    jmodel, params, model = _lm_pair("f32", seed=5, small=small)
    tokens = np.random.default_rng(6).integers(0, 256, (8, 33), dtype=np.int32)
    # one device: the load-balancing loss is not linear in the batch, so a
    # sharded batch would legitimately change it
    jtrainer = JTrainer(jmoe_lm_loss_fn(jmodel), optax.adam(1e-4), JGradientAllReduce(),
                        mesh=build_mesh({"dp": 1}, jax.devices()[:1]), autotune=False,
                        flat_resident="off")
    jstate = jtrainer.init(params)
    jbatch = jtrainer.shard_batch({"tokens": jnp.asarray(tokens)})
    want = []
    for _ in range(3):
        jstate, jl = jtrainer.train_step(jstate, jbatch)
        want.append(float(jl))
    jsd = params_from_jax(_np(jtrainer.unstack_params(jstate)), model)

    bt.init_process_group(device="cpu")
    adam = functools.partial(torch.optim.Adam, lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
    trainer = bt.BaguaTrainer(bt.moe_lm_loss_fn(), adam, bt.GradientAllReduceAlgorithm(),
                              device="cpu")
    p0 = {n: p.detach().clone().numpy() for n, p in model.named_parameters()}
    state = trainer.init(model)
    batch = trainer.shard_batch({"tokens": tokens.astype(np.int64)})
    got = []
    for _ in range(3):
        state, loss = trainer.train_step(state, batch)
        got.append(loss.item())
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jsd[name].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=name)
        want_du = jsd[name].numpy() - p0[name]
        err = np.linalg.norm(p.detach().numpy() - p0[name] - want_du)
        assert err <= 5e-3 * np.linalg.norm(want_du), name
