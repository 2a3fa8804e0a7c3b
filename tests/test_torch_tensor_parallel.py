"""Port's tensor parallelism against the JAX package's
(tests/test_tensor_parallel.py): the TP forward, one SGD step at dp 1 x tp
4 and on a tp-only mesh, QAdam's warmup step, the conjugates ``tp_reduce``
and ``tp_gather_grad`` (with the control an allreduce-backward reduce
fails), the global redraw's variance, and the trainer's refusals.  The
8-rank cases of the JAX file (dp 2 x tp 4: ``test_tp_dp_trains``,
``test_tp_qadam_trains_through_phase_switch``) run in the one 8-rank spawn
of tests/test_torch_3d_parallel.py.

The JAX side runs the JAX test's computation on the virtual CPU devices;
the port's ranks are gloo processes of
``tests/workers/torch_tensor_pipeline_worker.py`` (one spawn of 4 ranks,
with a timeout), fed the same seeded tokens and the JAX test's GLOBAL
params (``params_from_jax`` cuts each rank's slices) and compared through
``params_to_jax`` over ``unstack_params``.  Tolerances are the JAX test's
own, f32: the forward 2e-5, one step's loss 1e-5 and every parameter 5e-5.
"""

import functools
import json
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
from bagua_tpu.algorithms.q_adam import QAdamAlgorithm as JQAdam
from bagua_tpu.compat import shard_map
from bagua_tpu.core.backend import BaguaTrainer as JTrainer
from bagua_tpu.models.transformer import TransformerConfig as JConfig
from bagua_tpu.models.transformer import TransformerLM as JLM
from bagua_tpu.models.transformer import lm_loss_fn as jlm_loss_fn
from bagua_tpu.models.transformer import tp_param_dim as jtp_param_dim
from bagua_tpu.parallel.mesh import build_mesh as jbuild_mesh
from bagua_tpu_torch.models.convert import params_to_jax

sys.path.insert(0, str(Path(__file__).resolve().parent / "workers"))
import torch_tensor_pipeline_worker as worker  # noqa: E402

torch.set_num_threads(1)

TP = 4
SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=8)


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


def case_data(case, spec, params, tokens):
    """The worker's inputs of one case."""
    data = {f"{case}/spec": np.array(json.dumps(spec)),
            f"{case}/tokens": np.asarray(tokens, np.int32)}
    data.update({f"{case}/params/{n}": a for n, a in _flat(params).items()})
    return data


def port_params(out, case):
    prefix = f"{case}/param/"
    return {k[len(prefix):]: torch.tensor(v) for k, v in out.items() if k.startswith(prefix)}


def assert_step_matches(out, case, loss, want, atol=5e-5):
    """One step's loss within 1e-5 and every parameter within ``atol`` of
    the JAX run's (``want``: its ``unstack_params``)."""
    np.testing.assert_allclose(out[f"{case}/losses"][-1], loss, atol=1e-5)
    got = params_to_jax(port_params(out, case), want)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    for (path, a), (_, w) in zip(flat(got), flat(want)):
        np.testing.assert_allclose(a, np.asarray(w), atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def _jcfgs():
    plain = JConfig(**SMALL, dtype=jnp.float32)
    return plain, JConfig(tp_axis="tp", tp_size=TP, **SMALL, dtype=jnp.float32)


def _spec(kind, mesh, **kw):
    return {"kind": kind, "model": "lm", "cfg": SMALL, "mesh": mesh, **kw}


def _tokens(key, shape=(4, 9)):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(key), shape, 0, 64))


def _plain_params(key, tokens):
    return _np(JLM(_jcfgs()[0]).init(jax.random.PRNGKey(key), jnp.asarray(tokens[:, :-1]))[
        "params"])


@functools.lru_cache(maxsize=None)
def _inputs():
    """Each case's spec, JAX params and tokens, from the JAX test's keys."""
    fwd_tokens = _tokens(0, (4, 8))
    fwd_tokens = np.concatenate([fwd_tokens, np.zeros((4, 1), fwd_tokens.dtype)], axis=1)
    rng = np.random.default_rng(3)
    return {
        "fwd": (_spec("fwd", {"tp": TP}), _plain_params(1, fwd_tokens), fwd_tokens),
        "sgd": (_spec("train", {"dp": 1, "tp": TP}, opt="sgd", lr=0.1, steps=1),
                _plain_params(3, _tokens(2)), _tokens(2)),
        "sgdov": (_spec("train", {"dp": 1, "tp": TP}, opt="sgd", lr=0.1, steps=1,
                        trainer_kw={"overlap": "on", "grad_guard": "skip"}),
                  _plain_params(3, _tokens(2)), _tokens(2)),
        "tponly": (_spec("train", {"tp": TP}, opt="sgd", lr=0.1, steps=1),
                   _plain_params(10, _tokens(9)), _tokens(9)),
        "qadam": (_spec("train", {"dp": 1, "tp": TP}, algo="qadam",
                        algo_kw={"warmup_steps": 100, "lr": 1e-2}, steps=1),
                  _plain_params(15, _tokens(14)), _tokens(14)),
        "conj": (_spec("conjugates", {"tp": TP}), {}, _tokens(0)),
        "_conj": {"conj/x": rng.standard_normal((4, 8)).astype(np.float32),
                  "conj/g": rng.standard_normal((4, 8)).astype(np.float32)},
    }


_RUNS = {}


def _runs(tmp_path_factory):
    if "tp" not in _RUNS:
        data, cases = {}, []
        for case, val in _inputs().items():
            if case.startswith("_"):
                data.update(val)
                continue
            data.update(case_data(case, *val))
            cases.append(case)
        _RUNS["tp"] = worker.spawn(TP, cases, data, tmp_path_factory.mktemp("tp4"))
    return _RUNS["tp"]


def _jax_step(cfg_tp, mesh_axes, params, tokens, algo, opt):
    """The JAX test's two trainers: the dense world-1 step and the TP one;
    their losses and ``unstack_params``."""
    plain = _jcfgs()[0]
    t1 = JTrainer(jlm_loss_fn(JLM(plain)), opt, algo(), mesh=jbuild_mesh({"dp": 1},
                                                                         jax.devices()[:1]),
                  autotune=False)
    s1 = t1.init(params)
    s1, loss1 = t1.train_step(s1, t1.shard_batch({"tokens": jnp.asarray(tokens)}))
    n = int(np.prod(list(mesh_axes.values())))
    ttp = JTrainer(jlm_loss_fn(JLM(cfg_tp)), opt, algo(),
                   mesh=jbuild_mesh(mesh_axes, jax.devices()[:n]), tp_axis="tp", autotune=False)
    stp = ttp.init(params)
    stp, losstp = ttp.train_step(stp, ttp.shard_batch({"tokens": jnp.asarray(tokens)}))
    return (float(loss1), _np(t1.unstack_params(s1))), (float(losstp),
                                                       _np(ttp.unstack_params(stp)), ttp)


def test_tp_forward_matches_single_device(tmp_path_factory):
    outs = _runs(tmp_path_factory)
    plain_cfg, tp_cfg = _jcfgs()
    _, params, tokens = _inputs()["fwd"]
    tokens = jnp.asarray(tokens[:, :-1])
    ref = np.asarray(JLM(plain_cfg).apply({"params": params}, tokens))
    spec_tree = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (P() if jtp_param_dim(_jname(path)) is None
                            else P(*([None] * jtp_param_dim(_jname(path)) + ["tp"]))), params)
    sharded = np.asarray(jax.jit(shard_map(
        lambda p, t: JLM(tp_cfg).apply({"params": p}, t),
        mesh=jbuild_mesh({"tp": TP}, jax.devices()[:TP]), in_specs=(spec_tree, P()),
        out_specs=P(), check_vma=False))(params, tokens))
    for o in outs:
        np.testing.assert_allclose(o["fwd/logits"], ref, atol=2e-5)
        np.testing.assert_allclose(o["fwd/logits"], sharded, atol=2e-5)


def _jname(path):
    return ".".join(str(getattr(k, "key", k)) for k in path)


def test_tp_one_step_matches_single_device(tmp_path_factory):
    """One SGD step at dp 1 x tp 4 equals the dense world-1 step: the
    conjugates, the tp leaves outside the plan and the slices."""
    outs = _runs(tmp_path_factory)
    _, params, tokens = _inputs()["sgd"]
    (loss1, want), (losstp, want_tp, _) = _jax_step(
        _jcfgs()[1], {"dp": 1, "tp": TP}, params, tokens, JGradientAllReduce, optax.sgd(0.1))
    for o in outs:
        assert_step_matches(o, "sgd", loss1, want)
        assert_step_matches(o, "sgd", losstp, want_tp)
        # the tp slices stay out of the bucket plan
        plan = str(o["sgd/plan"]).split(",")
        assert plan and all(bt.tp_param_dim(n) is None for n in plan), plan
        assert not bool(o["sgd/resident"])


def test_tp_step_under_overlap_and_guard_matches_single_device(tmp_path_factory):
    """The same step with the overlap scheduler on (its hooks on the plan's
    leaves only; the tp slices' average follows the backward) and the grad
    guard's skip policy (its verdict on the updated parameters, MIN over
    every rank): the dense world-1 step, and a healthy verdict."""
    outs = _runs(tmp_path_factory)
    _, params, tokens = _inputs()["sgd"]
    (loss1, want), _ = _jax_step(_jcfgs()[1], {"dp": 1, "tp": TP}, params, tokens,
                                 JGradientAllReduce, optax.sgd(0.1))
    for o in outs:
        assert_step_matches(o, "sgdov", loss1, want)
        assert float(o["sgdov/healthy"][0]) == 1.0


def test_tp_only_mesh_matches_single_device(tmp_path_factory):
    """A mesh of only a tp axis has no data axis: the batch is not split
    over tp, and the buckets reduce over a world of one."""
    outs = _runs(tmp_path_factory)
    _, params, tokens = _inputs()["tponly"]
    (loss1, want), (losstp, _, ttp) = _jax_step(
        _jcfgs()[1], {"tp": TP}, params, tokens, JGradientAllReduce, optax.sgd(0.1))
    assert ttp.dp_axes == ()
    for o in outs:
        np.testing.assert_allclose(o["tponly/losses"][-1], loss1, atol=1e-5)
        np.testing.assert_allclose(o["tponly/losses"][-1], losstp, atol=1e-5)
        assert_step_matches(o, "tponly", loss1, want)
        assert str(o["tponly/dp_axes"]) == "" and int(o["tponly/world"]) == 1
        assert int(o["tponly/data_rank"]) == 0


def test_tp_qadam_warmup_step_matches_single_device(tmp_path_factory):
    outs = _runs(tmp_path_factory)
    _, params, tokens = _inputs()["qadam"]
    algo = functools.partial(JQAdam, warmup_steps=100, lr=1e-2)
    (loss1, want), (losstp, want_tp, _) = _jax_step(_jcfgs()[1], {"dp": 1, "tp": TP}, params,
                                                    tokens, algo, None)
    for o in outs:
        assert_step_matches(o, "qadam", loss1, want)
        assert_step_matches(o, "qadam", losstp, want_tp)


def test_tp_reduce_backward_is_the_identity(tmp_path_factory):
    """``tp_reduce`` sums forward and passes the cotangent through;
    ``tp_gather_grad`` passes forward and sums the cotangent.  The control,
    an allreduce whose backward is an allreduce too, is off by the factor tp
    in its gradient, the error that would compound block after block."""
    outs = _runs(tmp_path_factory)
    x, g = _inputs()["_conj"]["conj/x"], _inputs()["_conj"]["conj/g"]
    total = sum(x + r for r in range(TP))
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["conj/reduce/y"], total, rtol=1e-6)
        np.testing.assert_array_equal(o["conj/reduce/dx"], g)
        np.testing.assert_array_equal(o["conj/gather/y"], x + r)
        np.testing.assert_allclose(o["conj/gather/dx"], TP * g, rtol=1e-6)
        np.testing.assert_allclose(o["conj/control/y"], total, rtol=1e-6)
        np.testing.assert_allclose(o["conj/control/dx"], TP * g, rtol=1e-6)
        assert np.abs(o["conj/control/dx"] - g).max() > 0.5 * np.abs(g).max()


def test_globalize_tp_params_variance():
    """The port's own redraw: each rank's slice of one global draw, at the
    dense model's init scale (within 15%, the JAX test's gate, against the
    flax dense init), and the slices of the ranks tile the draw."""
    plain_cfg = JConfig(**SMALL, dtype=jnp.float32)
    golden = JLM(plain_cfg).init(jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32))["params"]
    cfg = bt.TransformerConfig(**SMALL, dtype=torch.float32, tp_axis="tp", tp_size=TP)
    slices = []
    for r in range(TP):
        model = bt.TransformerLM(cfg, device="cpu", seed=1)
        bt.globalize_tp_params(model, torch.Generator().manual_seed(2), TP, tp_rank=r)
        slices.append(dict(model.named_parameters()))
    for name, dim, jkey in (("block_0.attn.q.weight", 0, "q"), ("block_0.attn.o.weight", 1, "o")):
        full = torch.cat([s[name].detach() for s in slices], dim=dim)
        want_shape = np.asarray(golden["block_0"]["attn"][jkey]["kernel"]).size
        assert full.numel() == want_shape
        want = float(jnp.std(golden["block_0"]["attn"][jkey]["kernel"]))
        got = float(full.std())
        assert abs(got - want) / want < 0.15, (name, want, got)
    # the dense leaves are untouched and equal on every rank
    torch.testing.assert_close(slices[0]["embed.weight"], slices[3]["embed.weight"])


def test_tp_param_tables_match_jax():
    """The port's tp table marks JAX's leaves, and a tp rank's weight is one
    block of ``tp`` along its tp dim of the global weight in torch's
    layout."""
    from bagua_tpu_torch.models.convert import _to_torch_layout, torch_name

    cfg = bt.TransformerConfig(**SMALL, dtype=torch.float32, tp_axis="tp", tp_size=TP)
    local = dict(bt.TransformerLM(cfg, device="cpu").named_parameters())
    jparams = _plain_params(0, _tokens(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        jname = _jname(path)
        tname = torch_name(jname)
        jdim, tdim = jtp_param_dim(jname), bt.tp_param_dim(tname)
        assert (jdim is None) == (tdim is None), jname
        full = _to_torch_layout(np.asarray(leaf), jname).shape
        want = list(full)
        if tdim is not None:
            want[tdim] //= TP
        assert tuple(local[tname].shape) == tuple(want), jname


def _ttrainer(mesh, algo=None, **kw):
    return bt.BaguaTrainer(bt.lm_loss_fn, functools.partial(torch.optim.SGD, lr=0.1),
                           algo or bt.GradientAllReduceAlgorithm(), device="cpu", mesh=mesh,
                           **kw)


def _jtrainer(mesh, algo=None, **kw):
    return JTrainer(lambda p, b: 0.0, optax.sgd(0.1), algo or JGradientAllReduce(), mesh=mesh,
                    autotune=False, **kw)


def test_refusals_match_jax():
    """Each refusal JAX makes, made by the port too: a typo'd axis, TP or
    PP with experts or a gossip family, ``flat_resident="on"``
    (tests/test_flat_resident.py:174) and hierarchical ZeRO on a two-tier
    mesh with a tp axis (tests/test_zero.py:454).  The meshes are layouts
    of one rank, or a layout without groups where the JAX refusal needs a
    two-tier mesh: every refusal comes before a collective."""
    from bagua_tpu.algorithms.decentralized import DecentralizedAlgorithm as JDecentralized
    from bagua_tpu.algorithms.zero import ZeroOptimizerAlgorithm as JZero

    jmesh = jbuild_mesh({"dp": 4, "tp": 2})
    mesh = bt.build_mesh({"dp": 1, "tp": 1})
    for kw in ({"tp_axis": "tpp"}, {"pp_axis": "pp"}):
        with pytest.raises(ValueError, match=next(iter(kw))):
            _jtrainer(jmesh, **kw)
        with pytest.raises(ValueError, match=next(iter(kw))):
            _ttrainer(mesh, **kw)
    with pytest.raises(NotImplementedError, match="gossip"):
        _jtrainer(jmesh, algo=JDecentralized(), tp_axis="tp")
    with pytest.raises(NotImplementedError, match="gossip"):
        _ttrainer(mesh, algo=bt.DecentralizedAlgorithm(), tp_axis="tp")
    jmesh_ep = jbuild_mesh({"ep": 4, "tp": 2})
    mesh_ep = bt.build_mesh({"ep": 1, "tp": 1})
    with pytest.raises(NotImplementedError, match="expert_axis"):
        _jtrainer(jmesh_ep, tp_axis="tp", expert_axis="ep")
    with pytest.raises(NotImplementedError, match="expert_axis"):
        _ttrainer(mesh_ep, tp_axis="tp", expert_axis="ep")
    with pytest.raises(ValueError, match="flat_resident='on'"):
        _jtrainer(jmesh, tp_axis="tp", dp_axes=("dp",), flat_resident="on")
    with pytest.raises(ValueError, match="flat_resident='on'"):
        _ttrainer(mesh, tp_axis="tp", dp_axes=("dp",), flat_resident="on")
    two_tier = bt.parallel.Mesh({"inter": 2, "intra": 2, "tp": 2}, 0)
    with pytest.raises(NotImplementedError, match="flat-resident"):
        _ttrainer(two_tier, algo=bt.ZeroOptimizerAlgorithm(hierarchical=True), tp_axis="tp")
    jtwo_tier = jbuild_mesh({"inter": 2, "intra": 2, "tp": 2})
    jcfg = JConfig(vocab_size=32, d_model=16, n_heads=2, n_layers=1, d_ff=32, max_seq_len=8,
                   dtype=jnp.float32, tp_axis="tp", tp_size=2)
    with pytest.raises(NotImplementedError, match="flat-resident"):
        jt = JTrainer(jlm_loss_fn(JLM(jcfg)), None, JZero(optax.adam(1e-2), hierarchical=True),
                      mesh=jtwo_tier, tp_axis="tp")
        jt.init(JLM(jcfg).init(jax.random.PRNGKey(1), jnp.zeros((2, 8), jnp.int32))["params"])
    # the auto layout under tp is the leaf one, the residual off, a
    # hierarchical family on the flat path
    t = _ttrainer(mesh, tp_axis="tp", algo=bt.GradientAllReduceAlgorithm(hierarchical=True))
    assert not t._flat_supported() and not t._ef_enabled
    assert t.dp_axes == ("dp",) and t.comm_axes == ("dp",)


def test_default_tables_and_placements():
    """The trainer's default tables are the transformer's and the
    pipeline's; a stacked tp leaf's tp dim shifts past the stage dim."""
    mesh = bt.build_mesh({"dp": 1, "pp": 1, "tp": 1})
    t = _ttrainer(mesh, tp_axis="tp", pp_axis="pp")
    assert t._shard_entries("blocks.attn.q.weight") == ((0, "pp"), (1, "tp"))
    assert t._shard_entries("blocks.attn.o.weight") == ((0, "pp"), (2, "tp"))
    assert t._shard_entries("blocks.attn_norm.scale") == ((0, "pp"),)
    assert t._shard_entries("embed.weight") == ()
    assert t.comm_axes == ("dp", "pp")
    jt = _jtrainer(jbuild_mesh({"dp": 2, "pp": 2, "tp": 2}), tp_axis="tp", pp_axis="pp")
    assert jt._shard_entries("blocks.block.attn.q.kernel") == ((0, "pp"), (2, "tp"))
    assert jt.comm_axes == t.comm_axes
