"""Hierarchical families on model-parallel meshes: the port's against the
JAX package's (``bagua_tpu/algorithms/base.py:174-187, 281-311``,
``core/backend.py:491-493, 1122-1127``).

``two_tier()`` holds only where the mesh's ``inter`` and ``intra`` axes tile
the comm world:

- on ``{inter 2, intra 2, ep 2}`` and ``{inter 2, intra 2, sp 2}`` the ep or
  sp axis is folded into the comm axes, so ``hierarchical=True`` takes the
  flat path: the port's run equals its ``hierarchical=False`` run bitwise
  and tracks JAX's;
- on ``{inter 2, intra 2, tp 2}`` tp is no comm axis: the buckets reduce over
  ``inter x intra`` within each tp coordinate, where the gradient-allreduce,
  ByteGrad and QAdam families run the two-level form (intra reduce-scatter,
  inter ring, intra allgather), with JAX's ``bucket_tier_bytes``;
- hierarchical ZeRO refuses that leaf layout in JAX's words.

QAdam's legacy form on an ep or sp mesh (``q_adam.py:133-160``) averages the
momentum over ``inter x intra`` alone, skipping the folded axis; it is not
copied (ROADMAP.md, Queue 3): the port's ``hierarchical=True`` equals its
flat path there too, and the test shows JAX's legacy run leaving JAX's flat
trajectory after the switch.

Tolerances: losses 1e-5 relative for the full-precision families (three
Adam steps at the suite's parity rate 1e-4), ``TRAJ_RTOL`` 1e-3 where a u8
codec rides a hop (ByteGrad, QAdam after its switch: a one-ulp difference
moves a u8 level).  The port's ranks run in one spawn of 8 gloo ranks of
``tests/workers/torch_tensor_pipeline_worker.py``.
"""

import functools
import json
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bagua_tpu_torch as bt
from bagua_tpu.algorithms.bytegrad import ByteGradAlgorithm as JByteGrad
from bagua_tpu.algorithms.gradient_allreduce import (
    GradientAllReduceAlgorithm as JGradientAllReduce,
)
from bagua_tpu.algorithms.q_adam import QAdamAlgorithm as JQAdam
from bagua_tpu.algorithms.zero import ZeroOptimizerAlgorithm as JZero
from bagua_tpu.core.backend import BaguaTrainer as JTrainer
from bagua_tpu.model_parallel.moe.layer import MoEMLP as JMoEMLP
from bagua_tpu.model_parallel.moe.layer import globalize_expert_params as jglobalize_ep
from bagua_tpu.model_parallel.moe.layer import moe_lm_loss_fn as jmoe_lm_loss_fn
from bagua_tpu.models.transformer import TransformerConfig as JConfig
from bagua_tpu.models.transformer import TransformerLM as JLM
from bagua_tpu.models.transformer import lm_loss_fn as jlm_loss_fn
from bagua_tpu.models.transformer import sp_lm_loss_fn as jsp_lm_loss_fn
from bagua_tpu.models.transformer import tp_param_dim as jtp_param_dim
from bagua_tpu.parallel.mesh import build_mesh as jbuild_mesh
from bagua_tpu.parallel.ring_attention import make_ring_attention as jring
from bagua_tpu.parallel.tensor_parallel import globalize_tp_params as jglobalize_tp
from bagua_tpu_torch.parallel.mesh import Mesh

sys.path.insert(0, str(Path(__file__).resolve().parent / "workers"))
import torch_tensor_pipeline_worker as worker  # noqa: E402

torch.set_num_threads(1)

LR, STEPS = 1e-4, 3
TRAJ_RTOL = 1e-3
EP_CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq_len=8)
SP_CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq_len=16)
TP_CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=8)
EP_MESH = {"inter": 2, "intra": 2, "ep": 2}
SP_MESH = {"inter": 2, "intra": 2, "sp": 2}
TP_MESH = {"inter": 2, "intra": 2, "tp": 2}
QADAM = {"warmup_steps": 2, "lr": 1e-3}
#: case -> (mesh, port algo, its kwargs, steps)
CASES = {
    "ep_h": (EP_MESH, "bytegrad", {"hierarchical": True}, STEPS),
    "ep_f": (EP_MESH, "bytegrad", {"hierarchical": False}, STEPS),
    "ep_qadam_h": (EP_MESH, "qadam", {**QADAM, "hierarchical": True}, 4),
    "ep_qadam_f": (EP_MESH, "qadam", {**QADAM, "hierarchical": False}, 4),
    "sp_h": (SP_MESH, "ga", {"hierarchical": True}, STEPS),
    "sp_f": (SP_MESH, "ga", {"hierarchical": False}, STEPS),
    "tp_ga": (TP_MESH, "ga", {"hierarchical": True}, STEPS),
    "tp_bytegrad": (TP_MESH, "bytegrad", {"hierarchical": True}, STEPS),
    "tp_qadam": (TP_MESH, "qadam", {**QADAM, "hierarchical": True}, 4),
}


@pytest.fixture(scope="module", autouse=True)
def process_group():
    bt.init_process_group(device="cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _kind(mesh):
    return "ep" if "ep" in mesh else "sp" if "sp" in mesh else "tp"


def _cfg(mesh):
    return {"ep": EP_CFG, "sp": SP_CFG, "tp": TP_CFG}[_kind(mesh)]


def _tokens(mesh):
    rows = 4 if _kind(mesh) == "sp" else 8
    return np.asarray(jax.random.randint(jax.random.PRNGKey(5), (rows, _cfg(mesh)[
        "max_seq_len"] + 1), 0, 64))


def _jmodel(mesh):
    kind = _kind(mesh)
    if kind == "ep":
        factory = lambda i: ((lambda: JMoEMLP(n_experts=worker.N_EXPERTS, d_ff=64, ep_size=2,
                                              k=2, dropless=True, dtype=jnp.float32))
                             if i % 2 == 1 else None)
        return JLM(JConfig(**EP_CFG, dtype=jnp.float32), mlp_factory=factory)
    if kind == "sp":
        return JLM(JConfig(**SP_CFG, dtype=jnp.float32, sp_axis="sp"), attn_fn=jring(2))
    return JLM(JConfig(**TP_CFG, dtype=jnp.float32, tp_axis="tp", tp_size=2))


@functools.lru_cache(maxsize=None)
def _params(kind):
    mesh = {"ep": EP_MESH, "sp": SP_MESH, "tp": TP_MESH}[kind]
    tokens = jnp.asarray(_tokens(mesh))
    local = _jmodel(mesh).init(jax.random.PRNGKey(6), tokens[:2, :8])["params"]
    if kind == "ep":
        return _np(jglobalize_ep(local, jax.random.PRNGKey(7), ep_size=2))
    if kind == "tp":
        return _np(jglobalize_tp(local, jax.random.PRNGKey(7), 2, jtp_param_dim))
    return _np(local)


def _jalgo(algo, kw):
    if algo == "qadam":
        return JQAdam(**kw)
    return {"ga": JGradientAllReduce, "bytegrad": JByteGrad}[algo](**kw)


def _jtrainer(mesh, algo):
    kind = _kind(mesh)
    model = _jmodel(mesh)
    loss_fn = {"ep": jmoe_lm_loss_fn(model), "tp": jlm_loss_fn(model),
               "sp": jsp_lm_loss_fn(model, sp_size=2)}[kind]
    axes = {"ep": {"expert_axis": "ep"}, "sp": {"seq_axis": "sp"}, "tp": {"tp_axis": "tp"}}[kind]
    opt = None if getattr(algo, "owns_optimizer", False) else optax.adam(LR)
    return JTrainer(loss_fn, opt, algo, mesh=jbuild_mesh(mesh, jax.devices()[:8]),
                    autotune=False, **axes)


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """JAX's losses of ``case`` and each bucket's ``bucket_tier_bytes``."""
    mesh, algo, kw, steps = CASES[case]
    jalgo = _jalgo(algo, kw)
    t = _jtrainer(mesh, jalgo)
    s = t.init(_params(_kind(mesh)))
    batch = t.shard_batch({"tokens": jnp.asarray(_tokens(mesh))})
    losses = []
    for _ in range(steps):
        s, loss = t.train_step(s, batch)
        losses.append(float(loss))
    ctx = t._ctx(t._plan)
    tiers = [ctx.bucket_tier_bytes(i, jalgo.hierarchical, dcn_codec=jalgo.wire_codec_dcn,
                                   flat_codec=jalgo.wire_codec_flat)
             for i in range(len(t._plan.buckets))]
    return np.array(losses), tiers, bool(ctx.two_tier())


_RUNS = {}


def _runs(tmp_path_factory):
    if not _RUNS:
        data = {}
        for case, (mesh, algo, kw, steps) in CASES.items():
            spec = {"kind": "train", "model": "lm", "cfg": _cfg(mesh), "mesh": mesh,
                    "algo": algo, "algo_kw": kw, "opt": "adam", "lr": LR, "steps": steps}
            data[f"{case}/spec"] = np.array(json.dumps(spec))
            data[f"{case}/tokens"] = _tokens(mesh)
            data.update({f"{case}/params/{k}": v
                         for k, v in _flat(_params(_kind(mesh))).items()})
        _RUNS["outs"] = worker.spawn(8, list(CASES), data, tmp_path_factory.mktemp("hmp"))
    return _RUNS["outs"]


@pytest.mark.parametrize("kind,rtol", [("ep", TRAJ_RTOL), ("sp", 1e-5)])
def test_hierarchical_on_folded_axis_is_the_flat_path(kind, rtol, tmp_path_factory):
    """ByteGrad on the ep mesh, gradient allreduce on the sp mesh:
    ``hierarchical=True`` is the flat path, bitwise, and JAX's trajectory."""
    outs = _runs(tmp_path_factory)
    want, _, jax_two_tier = _jax_run(f"{kind}_h")
    assert not jax_two_tier
    for o in outs:
        np.testing.assert_array_equal(o[f"{kind}_h/losses"], o[f"{kind}_f/losses"])
        assert not bool(o[f"{kind}_h/two_tier"])
        np.testing.assert_allclose(o[f"{kind}_h/losses"], want, rtol=rtol)
        assert all(t["tier"] == "flat" for t in json.loads(str(o[f"{kind}_h/tiers"])))


def test_qadam_legacy_form_is_not_copied(tmp_path_factory):
    """QAdam's ``hierarchical=True`` on the ep mesh is the port's flat form
    (bitwise through its switch); JAX's flat form is what it tracks.  JAX's
    own ``hierarchical=True`` there (the legacy form, which averages the
    momentum over inter x intra and skips the ep axis) leaves that
    trajectory after the switch."""
    outs = _runs(tmp_path_factory)
    want, _, _ = _jax_run("ep_qadam_f")
    legacy, _, _ = _jax_run("ep_qadam_h")
    np.testing.assert_array_equal(legacy[:QADAM["warmup_steps"] + 1],
                                  want[:QADAM["warmup_steps"] + 1])
    assert abs(legacy[-1] - want[-1]) > 10 * TRAJ_RTOL * abs(want[-1]), (legacy, want)
    for o in outs:
        np.testing.assert_array_equal(o["ep_qadam_h/losses"], o["ep_qadam_f/losses"])
        np.testing.assert_allclose(o["ep_qadam_f/losses"], want, rtol=TRAJ_RTOL)


@pytest.mark.parametrize("case,rtol", [("tp_ga", 1e-5), ("tp_bytegrad", TRAJ_RTOL),
                                       ("tp_qadam", TRAJ_RTOL)])
def test_two_level_form_under_tp(case, rtol, tmp_path_factory):
    """The comm axes are exactly inter and intra: two tiers within each tp
    coordinate, the two-level form, JAX's trajectory and tier bytes."""
    outs = _runs(tmp_path_factory)
    want, tiers, jax_two_tier = _jax_run(case)
    assert jax_two_tier
    for o in outs:
        assert bool(o[f"{case}/two_tier"]) and int(o[f"{case}/world"]) == 4
        got = json.loads(str(o[f"{case}/tiers"]))
        assert got == tiers, (got, tiers)
        assert all(t["tier"] == "two_level" for t in got)
        np.testing.assert_allclose(o[f"{case}/losses"], want, rtol=rtol)
        np.testing.assert_array_equal(o[f"{case}/losses"], outs[0][f"{case}/losses"])


def test_hierarchical_zero_refused_under_tp_as_jax():
    """Hierarchical ZeRO's staged form spans exactly inter x intra, where
    the tp leaves keep the leaf layout: both packages refuse it in the same
    words.  On the ep mesh the flag is inert and ZeRO is accepted."""
    words = re.escape("hierarchical ZeRO supports the flat-resident (pure-dp) layout only; "
                      "drop hierarchical=True when composing with tp/pp/expert axes")
    jt = _jtrainer(TP_MESH, JZero(optax.adam(LR), hierarchical=True))
    with pytest.raises(NotImplementedError, match=words):
        jt.init(_params("tp"))
    loss = lambda m, b: 0.0
    with pytest.raises(NotImplementedError, match=words):
        bt.BaguaTrainer(loss, None, bt.ZeroOptimizerAlgorithm(hierarchical=True), device="cpu",
                        mesh=Mesh(TP_MESH, 0), tp_axis="tp")
    with pytest.raises(ValueError, match="no group"):
        # accepted by the mesh checks; this world-1 process has no groups
        bt.BaguaTrainer(loss, None, bt.ZeroOptimizerAlgorithm(hierarchical=True), device="cpu",
                        mesh=Mesh(EP_MESH, 0), expert_axis="ep")
