"""Port's sequence parallelism against the JAX package's
(tests/test_sequence_parallel.py): ring attention (the plain online-softmax
loop and the flash form) and Ulysses at sp 2 and 4, forward and gradients;
``sp_lm_loss_fn``; one SGD step at sp 2 against the world-1 step, and a
control at position offset 0 that the comparison catches; the trainer at
dp 2 x sp 2 with the ring and with Ulysses; the layout under sequence
parallelism.

The JAX side runs on the virtual CPU devices (``shard_map`` over an ``sp``
mesh; the ring there takes its inline loop, ``flash_supported`` being false
on the CPU), the port's on gloo ranks of
``tests/workers/torch_model_parallel_worker.py`` (one spawn of 2 and one of
4 ranks), where the flash wrappers run their plain versions on CPU tensors.
Tolerances, f32: outputs 1e-5 absolute (the JAX test's own; inputs of unit
scale), gradients 1e-5 of the largest, the loss 1e-5 relative, the SGD
step's parameters 1e-5 of each tensor's largest, three Adam
steps as in tests/test_torch_expert_parallel.py (losses 1e-5 relative,
parameters 1e-5 absolute at the rate 1e-4, updates 1e-3 in norm).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import bagua_tpu_torch as bt
from bagua_tpu.algorithms.gradient_allreduce import (
    GradientAllReduceAlgorithm as JGradientAllReduce,
)
from bagua_tpu.compat import shard_map
from bagua_tpu.core.backend import BaguaTrainer as JTrainer
from bagua_tpu.models.transformer import TransformerConfig as JConfig
from bagua_tpu.models.transformer import TransformerLM as JLM
from bagua_tpu.models.transformer import causal_attention as jcausal_attention
from bagua_tpu.models.transformer import lm_loss_fn as jlm_loss_fn
from bagua_tpu.models.transformer import sp_lm_loss_fn as jsp_lm_loss_fn
from bagua_tpu.parallel.mesh import build_mesh as jbuild_mesh
from bagua_tpu.parallel.ring_attention import make_ring_attention as jring
from bagua_tpu.parallel.ulysses import make_ulysses_attention as julysses
from bagua_tpu_torch.models.convert import params_to_jax

sys.path.insert(0, str(Path(__file__).resolve().parent / "workers"))
import torch_model_parallel_worker as worker  # noqa: E402
from test_torch_expert_parallel import _assert_trees_close, _flat, _np, _port_params  # noqa: E402

torch.set_num_threads(1)

KINDS = ("ring", "ringplain", "ulysses")
ATTN_CHECKS = [f"attn:{k}" for k in KINDS]
SGD_CHECKS = ["spsgd:ring", "spsgd:ulysses", "spsgd:ring:offset0"]
SPAWNS = {
    2: ATTN_CHECKS + ["sploss"] + SGD_CHECKS,
    4: ATTN_CHECKS + ["sploss", "lm:ga:dp2sp2:ring", "lm:ga:dp2sp2:ulysses"],
}


@pytest.fixture(scope="module", autouse=True)
def process_group():
    bt.init_process_group(device="cpu")


def _attn_inputs(b=2, s=32, h=4, d=8):
    rng = np.random.default_rng(5)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(4)]


def _sp_model(attn, sp=2):
    cfg = JConfig(**worker.SMALL_SP, dtype=jnp.float32, sp_axis="sp")
    return JLM(cfg, attn_fn=jring(sp) if attn == "ring" else julysses(sp))


def _sp_inputs():
    cfg = worker.SMALL_SP
    tokens = np.random.default_rng(6).integers(0, cfg["vocab_size"],
                                               (4, cfg["max_seq_len"] + 1), dtype=np.int32)
    params = _sp_model("ring").init(jax.random.PRNGKey(7), jnp.asarray(
        tokens[:2, :cfg["max_seq_len"] // 2]))["params"]
    return _np(params), tokens


def _data():
    q, k, v, g = _attn_inputs()
    params, tokens = _sp_inputs()
    data = {"attn/q": q, "attn/k": k, "attn/v": v, "attn/g": g, "lmsp/tokens": tokens}
    data.update({f"lmsp/params/{n}": a for n, a in _flat(params).items()})
    return data


_RUNS = {}


def _runs(world, tmp_path_factory):
    if world not in _RUNS:
        _RUNS[world] = worker.spawn(world, SPAWNS[world], _data(),
                                    tmp_path_factory.mktemp(f"sp{world}"))
    return _RUNS[world]


def _jax_sharded(attn, q, k, v, sp):
    mesh = jbuild_mesh({"sp": sp}, jax.devices()[:sp])
    spec = P(None, "sp")
    return np.asarray(jax.jit(shard_map(
        lambda q, k, v: attn(q, k, v, jnp.float32), mesh=mesh, in_specs=(spec, spec, spec),
        out_specs=spec, check_vma=False))(q, k, v))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_attention_matches_full_and_jax_sharded(kind, world, tmp_path_factory):
    outs = _runs(world, tmp_path_factory)
    q, k, v, g = _attn_inputs()
    full = np.asarray(jcausal_attention(q, k, v, jnp.float32))
    jattn = julysses(world) if kind == "ulysses" else jring(world)
    sharded = _jax_sharded(jattn, q, k, v, world)
    check = f"attn:{kind}"
    got = np.concatenate([o[f"{check}/out"] for o in outs], axis=1)
    np.testing.assert_allclose(got, full, atol=1e-5)
    np.testing.assert_allclose(got, sharded, atol=1e-5)
    want = jax.grad(lambda q, k, v: (jcausal_attention(q, k, v, jnp.float32) * g).sum(),
                    argnums=(0, 1, 2))(q, k, v)
    for name, w in zip(("dq", "dk", "dv"), want):
        got = np.concatenate([o[f"{check}/{name}"] for o in outs], axis=1)
        w = np.asarray(w)
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_ulysses_rejects_indivisible_heads():
    q, k, v, _ = _attn_inputs(h=6)
    with pytest.raises(ValueError, match="divisible"):
        bt.make_ulysses_attention(4)(*(torch.tensor(x) for x in (q, k, v)), torch.float32)


def test_ring_needs_its_mesh_axis():
    q, k, v, _ = (torch.tensor(x) for x in _attn_inputs())
    bt.set_global_mesh(None)
    with pytest.raises(ValueError, match="set_global_mesh"):
        bt.make_ring_attention(2)(q, k, v, torch.float32)
    with pytest.raises(ValueError, match="use_flash"):
        bt.make_ring_attention(2, use_flash="sometimes")


@pytest.mark.parametrize("world", [2, 4])
def test_sp_loss_matches_single_device(world, tmp_path_factory):
    outs = _runs(world, tmp_path_factory)
    params, tokens = _sp_inputs()
    cfg = JConfig(**worker.SMALL_SP, dtype=jnp.float32)
    want = float(jlm_loss_fn(JLM(cfg))(params, {"tokens": jnp.asarray(tokens[:2])}))
    for o in outs:
        np.testing.assert_allclose(float(o["sploss/loss"]), want, rtol=1e-5)


def _sgd_step_errors(out, check):
    """Each parameter's largest difference from the JAX world-1 SGD step
    (lr 0.1, the whole batch and sequence), over that tensor's largest."""
    params, tokens = _sp_inputs()
    cfg = JConfig(**worker.SMALL_SP, dtype=jnp.float32)
    grads = jax.grad(jlm_loss_fn(JLM(cfg)))(params, {"tokens": jnp.asarray(tokens)})
    want = jax.tree.map(lambda p, g: np.asarray(p - 0.1 * g), params, grads)
    got = params_to_jax(_port_params(out, check), want)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    return {jax.tree_util.keystr(path): float(np.abs(a - w).max() / np.abs(w).max())
            for (path, a), (_, w) in zip(flat(got), flat(want))}


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_sp_sgd_step_matches_world_one(attn, tmp_path_factory):
    """One SGD step at sp 2 equals the world-1 step on the whole sequence:
    the position offset, the loss's chunks and the gradient average over sp
    all show in it, where a loss at random init hides them."""
    for o in _runs(2, tmp_path_factory):
        errs = _sgd_step_errors(o, f"spsgd:{attn}")
        assert max(errs.values()) <= 1e-5, errs


def test_sp_sgd_step_sees_a_wrong_position_offset(tmp_path_factory):
    """The control: the ring run with every shard at positions from 0 is
    off the world-1 step by far more than the tolerance, in the position
    table first."""
    for o in _runs(2, tmp_path_factory):
        errs = _sgd_step_errors(o, "spsgd:ring:offset0")
        assert errs["['pos_embed']"] > 1e-3, errs


def _jax_sp_run(attn):
    params, tokens = _sp_inputs()
    model = _sp_model(attn)
    trainer = JTrainer(jsp_lm_loss_fn(model, sp_size=2), optax.adam(worker.LR),
                       JGradientAllReduce(), mesh=jbuild_mesh({"dp": 2, "sp": 2},
                                                              jax.devices()[:4]),
                       seq_axis="sp", autotune=False)
    state = trainer.init(params)
    losses = []
    for _ in range(worker.STEPS):
        state, loss = trainer.train_step(state, {"tokens": jnp.asarray(tokens)})
        losses.append(float(loss))
    return np.array(losses), _np(trainer.unstack_params(state)), trainer._flat_resident


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_dp2_sp2_trainer_matches_jax(attn, tmp_path_factory):
    """Three Adam steps at dp 2 x sp 2: the sp peers feed the same batch,
    the dp ranks their halves; the resident layout is on, as in JAX."""
    outs = _runs(4, tmp_path_factory)
    want_losses, want, jax_resident = _jax_sp_run(attn)
    init, _ = _sp_inputs()
    check = f"lm:ga:dp2sp2:{attn}"
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o[f"{check}/losses"], want_losses, rtol=1e-5)
        _assert_trees_close(params_to_jax(_port_params(o, check), want), want, init)
        assert int(o[f"{check}/data_rank"]) == r // 2
        assert bool(o[f"{check}/resident"]) and jax_resident
