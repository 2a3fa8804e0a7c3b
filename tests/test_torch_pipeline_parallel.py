"""Port's pipeline parallelism against the JAX package's
(tests/test_pipeline_parallel.py): one SGD step at dp 1 x pp 4 with 2
microbatches against the sequential run (every stage's blocks, stage 0's
included, and the partial dense leaves), the control without the
``pp_size`` prescale, the degenerate ``pp_size == 1`` path, the stacked
layout and the global redraw.  The 8-rank cases of the JAX file (dp 2 x pp
4: ``test_pp_dp_trains``, ``test_pp_qadam_trains_through_phase_switch``) run
in the one 8-rank spawn of tests/test_torch_3d_parallel.py.

The port's 4 ranks are one spawn of
``tests/workers/torch_tensor_pipeline_worker.py`` with a timeout: a schedule
whose transfers did not pair up on every stage would hang there and fail
the test instead of the suite's clock.  Tolerances are the JAX test's own,
f32: the loss 1e-5, every parameter 5e-5.
"""

import functools
import sys
from pathlib import Path

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
from bagua_tpu.models.transformer import TransformerConfig as JConfig
from bagua_tpu.parallel.mesh import build_mesh as jbuild_mesh
from bagua_tpu.parallel.pipeline import PipelinedTransformerLM as JPipelined
from bagua_tpu.parallel.pipeline import globalize_pp_params as jglobalize_pp
from bagua_tpu.parallel.pipeline import pp_lm_loss_fn as jpp_lm_loss_fn
from bagua_tpu.parallel.pipeline import pp_param_dim as jpp_param_dim
from bagua_tpu_torch.models.convert import params_from_jax, params_to_jax, torch_name

sys.path.insert(0, str(Path(__file__).resolve().parent / "workers"))
import torch_tensor_pipeline_worker as worker  # noqa: E402
from test_torch_tensor_parallel import _np, assert_step_matches, case_data, port_params  # noqa: E402

torch.set_num_threads(1)

PP = 4
SMALL = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=4, d_ff=64, max_seq_len=8)


@pytest.fixture(scope="module", autouse=True)
def process_group():
    bt.init_process_group(device="cpu")


def _jcfg():
    return JConfig(**SMALL, dtype=jnp.float32)


def global_pp_params(cfg, key, pp, tp=1):
    """The JAX test's global params: a stage's local init, redrawn."""
    local = JPipelined(cfg, pp_size=pp).init(
        jax.random.PRNGKey(key), jnp.zeros((2, cfg.max_seq_len + 1), jnp.int32))["params"]
    return _np(jglobalize_pp(local, jax.random.PRNGKey(key + 1), pp, tp_size=tp))


@functools.lru_cache(maxsize=None)
def _inputs():
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (4, 9), 0, 64))
    params = global_pp_params(_jcfg(), 0, PP)
    spec = {"kind": "train", "model": "pp", "cfg": SMALL, "mesh": {"dp": 1, "pp": PP},
            "n_micro": 2, "opt": "sgd", "lr": 0.1, "steps": 1}
    return {"sgd": (spec, params, tokens),
            "noprescale": ({**spec, "control": "noprescale"}, params, tokens)}


_RUNS = {}


def _runs(tmp_path_factory):
    if "pp" not in _RUNS:
        data = {}
        for case, val in _inputs().items():
            data.update(case_data(case, *val))
        _RUNS["pp"] = worker.spawn(PP, list(_inputs()), data, tmp_path_factory.mktemp("pp4"),
                                   timeout=240)
    return _RUNS["pp"]


@functools.lru_cache(maxsize=None)
def _jax_runs():
    """The JAX test's two runs: sequential (pp 1) at world 1, and dp 1 x pp
    4 with 2 microbatches; their losses and ``unstack_params``."""
    _, params, tokens = _inputs()["sgd"]
    out = []
    for pp, mesh, n_micro in ((1, {"dp": 1}, 1), (PP, {"dp": 1, "pp": PP}, 2)):
        n = int(np.prod(list(mesh.values())))
        model = JPipelined(_jcfg(), pp_size=pp, n_microbatches=n_micro)
        t = JTrainer(jpp_lm_loss_fn(model), optax.sgd(0.1), JGradientAllReduce(),
                     mesh=jbuild_mesh(mesh, jax.devices()[:n]),
                     pp_axis="pp" if pp > 1 else None, autotune=False)
        s = t.init(params)
        s, loss = t.train_step(s, t.shard_batch({"tokens": jnp.asarray(tokens)}))
        out.append((float(loss), _np(t.unstack_params(s))))
    return out


def test_pp_one_step_matches_sequential(tmp_path_factory):
    """One SGD step at dp 1 x pp 4 (2 microbatches) equals the sequential
    run: the tick schedule, the transfers' backward (stage 0's blocks get
    their gradient only through it), the stage-leaf placements and the
    ``pp_size`` prescale of the partial dense gradients."""
    outs = _runs(tmp_path_factory)
    (loss1, want), (losspp, want_pp) = _jax_runs()
    for o in outs:
        assert_step_matches(o, "sgd", loss1, want)
        assert_step_matches(o, "sgd", losspp, want_pp)
        plan = str(o["sgd/plan"]).split(",")
        assert sorted(plan) == ["embed.weight", "final_norm.scale", "lm_head.weight",
                                "pos_embed.weight"]
    # stage 0's blocks moved, as the sequential run's did
    _, params, _ = _inputs()["sgd"]
    got = params_to_jax(port_params(outs[0], "sgd"), want)
    layer0 = lambda t: np.asarray(t["blocks"]["block"]["attn"]["q"]["kernel"][0])
    moved = layer0(got) - layer0(params)
    np.testing.assert_allclose(moved, layer0(want) - layer0(params), atol=5e-5)
    assert np.abs(moved).max() > 1e-4


def test_pp_step_without_the_prescale_is_caught(tmp_path_factory):
    """The control: without the ``pp_size`` prescale the replicated leaves
    (embedding, head) move 1/pp as far as the sequential run's, and the
    step's gate fails; the stage leaves are unaffected."""
    outs = _runs(tmp_path_factory)
    (loss1, want), _ = _jax_runs()
    _, params, _ = _inputs()["sgd"]
    for o in outs:
        with pytest.raises(AssertionError):
            assert_step_matches(o, "noprescale", loss1, want)
        got = params_to_jax(port_params(o, "noprescale"), want)
        for key in ("embed", "lm_head"):
            leaf = next(iter(want[key]))
            moved = np.asarray(got[key][leaf]) - np.asarray(params[key][leaf])
            full = np.asarray(want[key][leaf]) - np.asarray(params[key][leaf])
            np.testing.assert_allclose(moved, full / PP, atol=1e-6)
        np.testing.assert_allclose(got["blocks"]["block"]["mlp"]["wo"]["kernel"],
                                   want["blocks"]["block"]["mlp"]["wo"]["kernel"], atol=5e-5)


def test_pp_size_one_is_the_sequential_model():
    """``pp_size == 1``: the port's loss and gradients on JAX's params equal
    JAX's sequential model's, and the port's ``TransformerLM`` with the same
    weights (stacked) gives the same loss."""
    from bagua_tpu_torch.models.convert import stack_blocks

    _, params, tokens = _inputs()["sgd"]
    jmodel = JPipelined(_jcfg(), pp_size=1)
    want, grads = jax.value_and_grad(jpp_lm_loss_fn(jmodel))(params, {"tokens": jnp.asarray(
        tokens)})
    model = bt.PipelinedTransformerLM(bt.TransformerConfig(**SMALL, dtype=torch.float32), 1,
                                      device="cpu")
    model.load_state_dict(params_from_jax(params, model))
    loss = bt.pp_lm_loss_fn(model, {"tokens": torch.tensor(tokens, dtype=torch.int64)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6)
    got = params_to_jax({n: p.grad for n, p in model.named_parameters()}, _np(grads))
    for (path, a), (_, w) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                 jax.tree_util.tree_flatten_with_path(_np(grads))[0]):
        np.testing.assert_allclose(a, w, atol=1e-6, err_msg=jax.tree_util.keystr(path))
    lm = bt.TransformerLM(bt.TransformerConfig(**SMALL, dtype=torch.float32), device="cpu")
    blocks = {n: t for n, t in model.state_dict().items()}
    unstacked = {}
    for n, t in blocks.items():
        if n.startswith("blocks."):
            for i in range(SMALL["n_layers"]):
                unstacked[f"block_{i}.{n[len('blocks.'):]}"] = t[i]
        else:
            unstacked[n] = t
    lm.load_state_dict(unstacked)
    assert set(stack_blocks(lm.state_dict(), SMALL["n_layers"])) == set(blocks)
    np.testing.assert_allclose(
        bt.lm_loss_fn(lm, {"tokens": torch.tensor(tokens, dtype=torch.int64)}).item(),
        loss.item(), rtol=1e-6)


def test_stacked_layout_and_pp_param_dim_match_jax():
    """The stacked leaves' names and shapes are JAX's ``blocks.block`` ones
    in torch's layout, in JAX's flatten order, and ``pp_param_dim`` marks
    the same leaves."""
    local = JPipelined(_jcfg(), pp_size=PP).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 9), jnp.int32))["params"]
    model = bt.PipelinedTransformerLM(bt.TransformerConfig(**SMALL, dtype=torch.float32), PP,
                                      device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(local)[0]
    names = [".".join(str(k.key) for k in path) for path, _ in flat]
    assert [torch_name(n) for n in names] == [n for n, _ in model.named_parameters()]
    own = dict(model.named_parameters())
    for (path, leaf), name in zip(flat, names):
        assert (jpp_param_dim(name) is None) == (bt.parallel.pp_param_dim(torch_name(name))
                                                 is None)
        assert own[torch_name(name)].numel() == np.asarray(leaf).size, name
        if jpp_param_dim(name) == 0:
            assert own[torch_name(name)].shape[0] == SMALL["n_layers"] // PP


def test_globalize_pp_params_tiles_one_draw():
    """Every stage keeps its layers of one global draw; norm scales ones;
    the redraw's scale is the per-layer fan-in's (within 15%)."""
    cfg = bt.TransformerConfig(**SMALL, dtype=torch.float32)
    stages = []
    for r in range(PP):
        model = bt.PipelinedTransformerLM(cfg, PP, device="cpu", seed=5)
        bt.globalize_pp_params(model, torch.Generator().manual_seed(6), PP, pp_rank=r)
        stages.append(dict(model.named_parameters()))
    q = torch.cat([s["blocks.attn.q.weight"].detach() for s in stages])
    assert q.shape == (SMALL["n_layers"], SMALL["d_model"], SMALL["d_model"])
    assert not torch.equal(q[0], q[1])
    want = 1.0 / np.sqrt(SMALL["d_model"])
    assert abs(float(q.std()) - want) / want < 0.15
    assert all(bool((s["blocks.mlp_norm.scale"] == 1).all()) for s in stages)
    torch.testing.assert_close(stages[0]["lm_head.weight"], stages[2]["lm_head.weight"])
