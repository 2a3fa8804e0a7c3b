"""Port's expert parallelism against the JAX package's (tests/test_moe.py,
tests/test_moe_dropless.py): the ``MoEMLP`` exchanges, the 1/ep rescale, the
expert-parallel trainer, ``unstack_params``, the checkpoint and the errors.

The JAX side runs on the virtual CPU devices (``shard_map`` over an ``ep``
mesh; its dropless exchange is the dense-slot one, XLA:CPU having no ragged
all-to-all), the port's on gloo ranks of
``tests/workers/torch_model_parallel_worker.py`` (one spawn of 2 and one of 4
ranks, every check of the file in them).  Weights and inputs are seeded
numpy and flax params carried over with ``models.convert``.  Tolerances, f32
throughout: outputs 2e-5 absolute (the JAX test's own, summation order);
gradients 1e-5 of the largest; the SGD step 1e-5 relative; three Adam
steps at the benches' rate 1e-4: losses 1e-5 relative, parameters 1e-5
absolute (Adam turns a one-ulp difference of a near-zero gradient into up to
a whole step of the rate: at 1e-3 one element of 8192 moved 3.8e-5), and
each leaf's update within 1e-3 of JAX's in norm; ByteGrad's losses 1e-3
relative (a one-ulp difference moves a u8 level, as in
tests/test_torch_compressed.py).  ZeRO and QAdam with ``expert_axis`` keep
the expert tables as local leaves of their optimizer state: ZeRO's losses
1e-5 relative and parameters 5e-5 absolute of JAX's (tests/test_zero.py's),
QAdam's losses ``TRAJ_RTOL`` 1e-3 over its switch (the u8 codec of its
compressed phase, as in tests/test_torch_3d_parallel.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import bagua_tpu_torch as bt
from bagua_tpu.algorithms.bytegrad import ByteGradAlgorithm as JByteGrad
from bagua_tpu.algorithms.decentralized import DecentralizedAlgorithm as JDecentralized
from bagua_tpu.algorithms.gradient_allreduce import (
    GradientAllReduceAlgorithm as JGradientAllReduce,
)
from bagua_tpu.algorithms.q_adam import QAdamAlgorithm as JQAdam
from bagua_tpu.algorithms.zero import ZeroOptimizerAlgorithm as JZero
from bagua_tpu.compat import shard_map
from bagua_tpu.core.backend import BaguaTrainer as JTrainer
from bagua_tpu.model_parallel.moe.layer import MoEMLP as JMoEMLP
from bagua_tpu.model_parallel.moe.layer import globalize_expert_params as jglobalize
from bagua_tpu.model_parallel.moe.layer import moe_lm_loss_fn as jmoe_lm_loss_fn
from bagua_tpu.models.transformer import TransformerConfig as JConfig
from bagua_tpu.models.transformer import TransformerLM as JLM
from bagua_tpu.parallel.mesh import build_mesh as jbuild_mesh
from bagua_tpu_torch.model_parallel.moe import MoEMLP
from bagua_tpu_torch.models.convert import params_from_jax, params_to_jax

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "workers"))
import torch_model_parallel_worker as worker  # noqa: E402

torch.set_num_threads(1)

E, D, F, SEQ, B = 8, 16, 32, 4, 8
MODES = ("dropless", "capacity")
FORMS = {"dropless": ("dense", "ragged"), "capacity": ("dense",)}
MOE_CHECKS = [f"moe:{m}:{f}" for m in MODES for f in FORMS[m]]
SPAWNS = {
    2: MOE_CHECKS + ["lm:ga:ep2", "lm:bytegrad:ep2", "lm:zero:ep2", "lm:qadam:ep2"],
    4: MOE_CHECKS + ["sgd:capacity", "sgd:dropless", "lm:ga:dp2ep2", "ckpt",
                     "lm:zero:dp2ep2", "lm:qadam:dp2ep2", "ckpt:zero", "ckpt:qadam"],
}
#: QAdam's losses against JAX's over its switch (relative, every step)
TRAJ_RTOL = 1e-3


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


def _jmoe(ep, mode):
    return JMoEMLP(n_experts=E, d_ff=F, ep_size=ep, k=2, capacity_factor=float(E),
                   dtype=jnp.float32, dropless=mode == "dropless")


def _moe_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, SEQ, D)).astype(np.float32)
    g = rng.standard_normal((B, SEQ, D)).astype(np.float32)
    y = rng.standard_normal((B, SEQ, D)).astype(np.float32)
    params = _np(_jmoe(1, "dropless").init(jax.random.PRNGKey(1), jnp.asarray(x[:2]))["params"])
    return params, x, g, y


def _lm_model(ep):
    cfg = JConfig(**worker.SMALL_EP, dtype=jnp.float32)
    factory = lambda i: (
        (lambda: JMoEMLP(n_experts=worker.N_EXPERTS, d_ff=cfg.d_ff, ep_size=ep, k=2,
                         dropless=True, dtype=jnp.float32)) if i % 2 == 1 else None)
    return JLM(cfg, mlp_factory=factory)


def _lm_inputs():
    cfg = worker.SMALL_EP
    tokens = np.random.default_rng(2).integers(0, cfg["vocab_size"],
                                               (8, cfg["max_seq_len"] + 1), dtype=np.int32)
    model = _lm_model(2)
    params = model.init(jax.random.PRNGKey(3), jnp.asarray(tokens[:2, :-1]))["params"]
    params = _np(jglobalize(params, jax.random.PRNGKey(4), ep_size=2))
    return params, tokens


def _data():
    params, x, g, y = _moe_inputs()
    lm_params, tokens = _lm_inputs()
    data = {"moe/router": params["router"]["kernel"], "moe/wi": params["expert_wi"],
            "moe/wo": params["expert_wo"], "moe/x": x, "moe/g": g,
            "sgd/router": params["router"]["kernel"], "sgd/wi": params["expert_wi"],
            "sgd/wo": params["expert_wo"], "sgd/x": x, "sgd/y": y, "lmep/tokens": tokens}
    data.update({f"lmep/params/{k}": v for k, v in _flat(lm_params).items()})
    return data


_RUNS = {}


def _runs(world, tmp_path_factory):
    if world not in _RUNS:
        _RUNS[world] = worker.spawn(world, SPAWNS[world], _data(),
                                    tmp_path_factory.mktemp(f"ep{world}"))
    return _RUNS[world]


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


# ---------------------------------------------------------------------------
# the layer: forward and gradients at ep 2 and 4, both modes, both forms
# ---------------------------------------------------------------------------


def _jax_ep_forward(params, x, ep, mode):
    layer = _jmoe(ep, mode)
    mesh = jbuild_mesh({"ep": ep}, jax.devices()[:ep])
    pspec = jax.tree_util.tree_map_with_path(
        lambda path, leaf: P("ep") if "expert" in jax.tree_util.keystr(path) else P(), params)
    return np.asarray(jax.jit(shard_map(
        lambda p, xs: layer.apply({"params": p}, xs), mesh=mesh,
        in_specs=(pspec, P("ep")), out_specs=P("ep"), check_vma=False))(params, x))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("check", MOE_CHECKS)
def test_ep_forward_and_grads_match_jax(check, world, tmp_path_factory):
    outs = _runs(world, tmp_path_factory)
    mode = check.split(":")[1]
    params, x, g, _ = _moe_inputs()
    single = _jmoe(1, mode)
    want = np.asarray(single.apply({"params": params}, x))
    got = np.concatenate([o[f"{check}/y"] for o in outs])
    np.testing.assert_allclose(got, _jax_ep_forward(params, x, world, mode), atol=2e-5)
    np.testing.assert_allclose(got, want, atol=2e-5)
    grads = jax.grad(lambda p: (single.apply({"params": p}, x) * g).sum())(params)
    _close(np.concatenate([o[f"{check}/d_wi"] for o in outs]), grads["expert_wi"], 1e-5, "wi")
    _close(np.concatenate([o[f"{check}/d_wo"] for o in outs]), grads["expert_wo"], 1e-5, "wo")
    for o in outs:
        _close(o[f"{check}/d_router"], np.asarray(grads["router"]["kernel"]).T, 1e-5, "router")


def test_dropless_forms_agree(tmp_path_factory):
    """The dense-slot and the exact-count exchange give each expert the same
    rows in the same order: equal outputs and gradients."""
    for world in (2, 4):
        for o in _runs(world, tmp_path_factory):
            for key in ("y", "d_wi", "d_wo", "d_router"):
                np.testing.assert_array_equal(o[f"moe:dropless:ragged/{key}"],
                                              o[f"moe:dropless:dense/{key}"], err_msg=key)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_sgd_step_at_ep4_equals_world_one(mode, tmp_path_factory):
    """One SGD step at ep 4 gives the world-1 step's weights: the expert
    gradients are divided by ep_size (the all-to-all backward already sums
    every shard's contribution), which Adam would hide."""
    outs = _runs(4, tmp_path_factory)
    params, x, _, y = _moe_inputs()
    single = _jmoe(1, mode)
    grads = jax.grad(lambda p: jnp.mean((single.apply({"params": p}, x) - y) ** 2))(params)
    want = jax.tree.map(lambda p_, g_: np.asarray(p_ - 0.1 * g_), params, grads)
    # the port's own world-1 step, from the same weights
    layer = MoEMLP(E, F, d_model=D, k=2, capacity_factor=float(E), dtype=torch.float32,
                   dropless=mode == "dropless")
    layer.load_state_dict(params_from_jax({"router.kernel": params["router"]["kernel"],
                                           "expert_wi": params["expert_wi"],
                                           "expert_wo": params["expert_wo"]}, layer))
    ((layer(torch.tensor(x)) - torch.tensor(y)) ** 2).mean().backward()
    for o in outs:
        got = {n[len(f"sgd:{mode}/param/"):]: v for n, v in o.items()
               if n.startswith(f"sgd:{mode}/param/")}
        assert o[f"sgd:{mode}/plan"] == "router.weight"
        for name, ref, p in (("expert_wi", want["expert_wi"], layer.expert_wi),
                             ("expert_wo", want["expert_wo"], layer.expert_wo),
                             ("router.weight", want["router"]["kernel"].T, layer.router.weight)):
            np.testing.assert_allclose(got[name], ref, rtol=1e-5, atol=1e-7, err_msg=name)
            port_world1 = (p - 0.1 * p.grad).detach().numpy()
            np.testing.assert_allclose(got[name], port_world1, rtol=1e-5, atol=1e-7,
                                       err_msg=name)


def _jax_lm_run(mesh_axes, algo="ga"):
    params, tokens = _lm_inputs()
    model = _lm_model(2)
    n = int(np.prod(list(mesh_axes.values())))
    jalgo = {"bytegrad": lambda: JByteGrad(hierarchical=False), "ga": JGradientAllReduce,
             "zero": lambda: JZero(optax.adam(worker.LR)),
             "qadam": lambda: JQAdam(**worker.QADAM)}[algo]()
    opt = None if algo in ("zero", "qadam") else optax.adam(worker.LR)
    trainer = JTrainer(jmoe_lm_loss_fn(model), opt, jalgo,
                       mesh=jbuild_mesh(mesh_axes, jax.devices()[:n]), expert_axis="ep",
                       autotune=False)
    state = trainer.init(params)
    losses = []
    for _ in range(worker.STEPS):
        state, loss = trainer.train_step(state, {"tokens": jnp.asarray(tokens)})
        losses.append(float(loss))
    return np.array(losses), _np(trainer.unstack_params(state))


def _port_params(out, check):
    prefix = f"{check}/param/"
    return {k[len(prefix):]: torch.tensor(v) for k, v in out.items() if k.startswith(prefix)}


def _assert_trees_close(got, want, init):
    """Parameters within 1e-5, each leaf's update within 1e-3 of JAX's in
    norm (and nonzero where JAX's is)."""
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    for (path, a), (_, w), (_, i) in zip(flat(got), flat(want), flat(init)):
        name = jax.tree_util.keystr(path)
        np.testing.assert_allclose(a, w, rtol=0, atol=1e-5, err_msg=name)
        du, dw = a - np.asarray(i), w - np.asarray(i)
        assert np.linalg.norm(du - dw) <= 1e-3 * np.linalg.norm(dw) + 1e-12, name


def test_dp2_ep2_adam_matches_jax_trainer(tmp_path_factory):
    """Three Adam steps of the MoE LM at dp 2 x ep 2 against the JAX trainer
    on build_mesh({"dp": 2, "ep": 2}); ``unstack_params`` global on every rank."""
    outs = _runs(4, tmp_path_factory)
    want_losses, want = _jax_lm_run({"dp": 2, "ep": 2})
    init, _ = _lm_inputs()
    check = "lm:ga:dp2ep2"
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o[f"{check}/losses"], want_losses, rtol=1e-5)
        got = params_to_jax(_port_params(o, check), want)
        _assert_trees_close(got, want, init)
        assert int(o[f"{check}/data_rank"]) == r
        # expert parallelism keeps the leaf layout; the experts leave the plan
        assert not bool(o[f"{check}/resident"])
        assert "expert" not in str(o[f"{check}/plan"])


def test_bytegrad_at_ep2_tracks_jax(tmp_path_factory):
    outs = _runs(2, tmp_path_factory)
    want, _ = _jax_lm_run({"ep": 2}, "bytegrad")
    got = outs[0]["lm:bytegrad:ep2/losses"]
    np.testing.assert_array_equal(outs[1]["lm:bytegrad:ep2/losses"], got)
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-3, (got, want)
    ga, _ = _jax_lm_run({"ep": 2})
    np.testing.assert_allclose(outs[0]["lm:ga:ep2/losses"], ga, rtol=1e-5)


@pytest.mark.parametrize("axes,world", [("ep2", 2), ("dp2ep2", 4)])
def test_zero_with_experts_matches_jax(axes, world, tmp_path_factory):
    """ZeRO over Adam with the expert tables as local leaves (JAX's
    ``"local"`` state, ``zero.py:245-351``): the chunk optimizer holds
    ``1 / world`` of the plan's state, the local one the expert tables'."""
    outs = _runs(world, tmp_path_factory)
    mesh = {"ep": 2} if axes == "ep2" else {"dp": 2, "ep": 2}
    want_losses, want = _jax_lm_run(mesh, "zero")
    check = f"lm:zero:{axes}"
    for o in outs:
        np.testing.assert_allclose(o[f"{check}/losses"], want_losses, rtol=1e-5)
        got = params_to_jax(_port_params(o, check), want)
        flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
        for (path, a), (_, w) in zip(flat(got), flat(want)):
            np.testing.assert_allclose(a, w, rtol=0, atol=5e-5,
                                       err_msg=jax.tree_util.keystr(path))
        assert "expert" not in str(o[f"{check}/plan"])
        chunks, local = o[f"{check}/opt_bytes"]
        assert local > 0 and chunks > 0
    # ZeRO over Adam is Adam: the trajectory of the replicated run
    np.testing.assert_allclose(want_losses, _jax_lm_run(mesh)[0], rtol=1e-5)
    dense = [o[f"{check}/opt_bytes"][0] for o in outs]
    assert len(set(dense)) == 1


@pytest.mark.parametrize("axes,world", [("ep2", 2), ("dp2ep2", 4)])
def test_qadam_with_experts_matches_jax(axes, world, tmp_path_factory):
    """QAdam through its switch with the expert tables' moments kept local:
    the compressed phase averages the plan's momentum alone."""
    outs = _runs(world, tmp_path_factory)
    mesh = {"ep": 2} if axes == "ep2" else {"dp": 2, "ep": 2}
    want_losses, _ = _jax_lm_run(mesh, "qadam")
    check = f"lm:qadam:{axes}"
    for o in outs:
        got = o[f"{check}/losses"]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want_losses, rtol=TRAJ_RTOL)
        np.testing.assert_array_equal(got, outs[0][f"{check}/losses"])
        assert "expert" not in str(o[f"{check}/plan"])


@pytest.mark.parametrize("algo", ["zero", "qadam"])
def test_zero_and_qadam_checkpoint_at_ep2_resume_bitwise(algo, tmp_path_factory):
    """The expert tables' optimizer state is each rank's own part."""
    outs = _runs(4, tmp_path_factory)
    check = f"ckpt:{algo}"
    for o in outs:
        np.testing.assert_array_equal(o[f"{check}/resumed"], o[f"{check}/straight"])
        assert bool(o[f"{check}/same"]) and int(o[f"{check}/step"]) == 2
        assert [f for f in o[f"{check}/files"] if f.startswith("rank")] == [
            f"rank{r}.pt" for r in range(4)]


def test_checkpoint_resume_at_dp2_ep2_is_bitwise(tmp_path_factory):
    outs = _runs(4, tmp_path_factory)
    for o in outs:
        np.testing.assert_array_equal(o["ckpt/resumed"], o["ckpt/straight"])
        assert bool(o["ckpt/same"]) and int(o["ckpt/step"]) == 2
        assert str(o["ckpt/mesh"]) == "{'dp': 2, 'ep': 2}"
        # each rank's expert tables are its own part
        assert [f for f in o["ckpt/files"] if f.startswith("rank")] == [
            f"rank{r}.pt" for r in range(4)]
        # another ep size: refused, as the JAX package's restore fails
        # (tests/test_torch_checkpoint_meshes.py holds both outcomes)
        err = str(o["ckpt/error"])
        assert "expert-parallel size" in err and "{'dp': 2, 'ep': 2}" in err, err
        assert "{'ep': 4}" in err, err


# ---------------------------------------------------------------------------
# errors and expert marking (one process)
# ---------------------------------------------------------------------------


def _jtrainer(**kw):
    return JTrainer(lambda p, b: 0.0, optax.sgd(0.1), kw.pop("algo", JGradientAllReduce()),
                    autotune=False, **kw)


def _ttrainer(**kw):
    return bt.BaguaTrainer(lambda m, b: 0.0, functools.partial(torch.optim.SGD, lr=0.1),
                           kw.pop("algo", bt.GradientAllReduceAlgorithm()), device="cpu", **kw)


def test_errors_match_jax():
    jmesh = jbuild_mesh({"dp": 8})
    mesh = bt.build_mesh({"dp": 1})
    for axis, label in (("expert_axis", "not_an_axis"), ("seq_axis", "sq")):
        with pytest.raises(ValueError, match=axis):
            _jtrainer(mesh=jmesh, **{axis: label})
        with pytest.raises(ValueError, match=axis):
            _ttrainer(mesh=mesh, **{axis: label})
    jmesh = jbuild_mesh({"dp": 4, "ep": 2})
    mesh = bt.build_mesh({"dp": 1, "ep": 1})
    with pytest.raises(NotImplementedError, match="gossip"):
        _jtrainer(mesh=jmesh, expert_axis="ep", algo=JDecentralized())
    with pytest.raises(NotImplementedError, match="gossip"):
        _ttrainer(mesh=mesh, expert_axis="ep", algo=bt.DecentralizedAlgorithm())
    # once deferred, now trained: ZeRO with the experts, the hierarchical
    # flag on an expert or sequence mesh (the flat path)
    for algo in (bt.ZeroOptimizerAlgorithm(), bt.GradientAllReduceAlgorithm(hierarchical=True)):
        _train_one_step(_ttrainer(mesh=mesh, expert_axis="ep", algo=algo), moe=True)
    _train_one_step(_ttrainer(mesh=bt.build_mesh({"dp": 1, "sp": 1}), seq_axis="sp",
                              algo=bt.ByteGradAlgorithm()), moe=False)
    with pytest.raises(ValueError, match="set_global_mesh"):
        MoEMLP(8, 32, d_model=16, ep_size=2)
    with pytest.raises(ValueError, match="expert_params OR expert_keyword"):
        _ttrainer(mesh=mesh, expert_axis="ep", expert_params=["a"], expert_keyword="b")


def _train_one_step(trainer, moe):
    """One finite step of a small LM (MoE in layer 1 where ``moe``) at
    world 1."""
    cfg = bt.TransformerConfig(**worker.SMALL_EP, dtype=torch.float32)
    factory = (lambda i: (lambda: MoEMLP(worker.N_EXPERTS, cfg.d_ff, d_model=cfg.d_model,
                                         k=2, dtype=torch.float32)) if i == 1 else None)
    model = bt.TransformerLM(cfg, device="cpu", mlp_factory=factory if moe else None)
    trainer.loss_fn = bt.moe_lm_loss_fn() if moe else bt.lm_loss_fn
    state = trainer.init(model)
    tokens = torch.tensor(_lm_inputs()[1][:2].astype(np.int64))
    _, loss = trainer.train_step(state, {"tokens": tokens})
    assert np.isfinite(loss.item())


def test_expert_marking_and_explicit_collection():
    jmesh = jbuild_mesh({"dp": 4, "ep": 2})
    mesh = bt.build_mesh({"dp": 1, "ep": 1})
    names = ["blk.moe.expert_wi", "blk.moe.expert_wo"]
    jt = _jtrainer(mesh=jmesh, expert_axis="ep", expert_params=names)
    t = _ttrainer(mesh=mesh, expert_axis="ep", expert_params=names)
    for n in names + ["blk.attn.kernel", "blk.moe.expert_wi_extra"]:
        assert t._is_expert_name(n) == jt._is_expert_name(n), n
    jt = _jtrainer(mesh=jmesh, expert_axis="ep", expert_params=lambda n: n.endswith("_moe"))
    t = _ttrainer(mesh=mesh, expert_axis="ep", expert_params=lambda n: n.endswith("_moe"))
    assert t._is_expert_name("w_moe") and jt._is_expert_name("w_moe")
    # the default marking is by exact segment, never by substring
    t = _ttrainer(mesh=mesh, expert_axis="ep")
    for n in ("layers_1.mlp.expert_wi", "encoder.expertise_head.weight", "my_expert_wi_extra"):
        assert t._is_expert_name(n) == JTrainer._make_expert_filter(None, None)(n), n
    with pytest.warns(DeprecationWarning):
        t = _ttrainer(mesh=mesh, expert_axis="ep", expert_keyword="moe")
    assert t._is_expert_name("blk.moe.w")
    # without an expert axis nothing is an expert table
    assert not _ttrainer(mesh=mesh)._is_expert_name("blk.moe.expert_wi")


def test_globalize_expert_params_draws_one_global_table():
    """Every rank draws the same global table from the same generator and
    keeps its slice: the slices of ep ranks tile the one draw."""
    g = torch.Generator().manual_seed(7)
    full = torch.empty(E, D, F).normal_(0.0, 1.0 / np.sqrt(D), generator=g)

    class Shard(torch.nn.Module):
        def __init__(self, r):
            super().__init__()
            self.expert_wi = torch.nn.Parameter(torch.zeros(E // 2, D, F))
            self.ep_size, self.ep_rank = 2, r

    for r in range(2):
        shard = Shard(r)
        bt.globalize_expert_params(shard, torch.Generator().manual_seed(7))
        torch.testing.assert_close(shard.expert_wi.detach(), full[r * 4:(r + 1) * 4],
                                   rtol=0, atol=0)
