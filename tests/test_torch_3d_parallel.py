"""Port's 3-D parallelism (dp x pp x tp) against the JAX package's
(tests/test_3d_parallel.py), and every 8-rank case of the tensor- and
pipeline-parallel mirrors in one spawn: dp 2 x tp 4 (tests/test_tensor_
parallel.py's trains tests with Adam and with QAdam through its phase
switch, tests/test_checkpoint.py:97's sharded checkpoint), dp 2 x pp 4
(tests/test_pipeline_parallel.py's trains tests, tests/test_checkpoint.py:206),
dp 2 x pp 2 x tp 2 (this file's trains test and checkpoint round trip,
tests/test_zero.py:181's ZeRO), dp 4 x tp 2 (tests/test_zero.py:132 and
:233) and dp 2 x sp 2 x tp 2 (tests/test_sequence_parallel.py:190).  The
one 4-rank case, the 3-D SGD step at dp 1 x pp 2 x tp 2, is a spawn of its
own.

Each case runs the JAX test's computation on the virtual CPU devices and
the port's on gloo ranks of ``tests/workers/torch_tensor_pipeline_worker.py``
(with a timeout), from the same seeded tokens and GLOBAL params.
Tolerances, f32: one SGD step's loss 1e-5 and every parameter 5e-5 (the JAX
tests'); ZeRO against the plain run the JAX tests' (losses rtol 1e-5, atol
1e-6; parameters rtol 2e-5, atol 2e-5); a resumed checkpoint bitwise (the
JAX test's rtol 1e-6 is met exactly); the trains tests' losses fall, as
JAX's do, and track JAX's trajectory within ``TRAJ_RTOL``: Adam at 1e-2
turns a one-ulp gradient difference into up to a whole step of a parameter
near a zero gradient, so the trajectories are held on the loss, not on each
parameter.
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

import bagua_tpu_torch as bt
from bagua_tpu.algorithms.gradient_allreduce import (
    GradientAllReduceAlgorithm as JGradientAllReduce,
)
from bagua_tpu.algorithms.q_adam import QAdamAlgorithm as JQAdam
from bagua_tpu.algorithms.zero import ZeroOptimizerAlgorithm as JZero
from bagua_tpu.core.backend import BaguaTrainer as JTrainer
from bagua_tpu.models.transformer import TransformerConfig as JConfig
from bagua_tpu.models.transformer import TransformerLM as JLM
from bagua_tpu.models.transformer import lm_loss_fn as jlm_loss_fn
from bagua_tpu.models.transformer import sp_lm_loss_fn as jsp_lm_loss_fn
from bagua_tpu.models.transformer import tp_param_dim as jtp_param_dim
from bagua_tpu.parallel.mesh import build_mesh as jbuild_mesh
from bagua_tpu.parallel.pipeline import PipelinedTransformerLM as JPipelined
from bagua_tpu.parallel.pipeline import pp_lm_loss_fn as jpp_lm_loss_fn
from bagua_tpu.parallel.ring_attention import make_ring_attention as jring
from bagua_tpu.parallel.tensor_parallel import globalize_tp_params as jglobalize_tp

sys.path.insert(0, str(Path(__file__).resolve().parent / "workers"))
import torch_tensor_pipeline_worker as worker  # noqa: E402
from test_torch_pipeline_parallel import global_pp_params  # noqa: E402
from test_torch_tensor_parallel import _np, assert_step_matches, case_data, port_params  # noqa: E402

torch.set_num_threads(1)

#: a trains test's losses against the JAX run's, relative, every step
TRAJ_RTOL = 1e-3
PP, TP = 2, 2
LAYERS4 = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=4, d_ff=64, max_seq_len=8)
TP4 = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=8)
LAYERS2 = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq_len=8)
SPTP = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq_len=16)


@pytest.fixture(scope="module", autouse=True)
def process_group():
    bt.init_process_group(device="cpu")


def _jcfg(dims, tp=1, **kw):
    return JConfig(**dims, dtype=jnp.float32, tp_axis="tp" if tp > 1 else None, tp_size=tp,
                   **kw)


def _tokens(key, shape=(8, 9)):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(key), shape, 0, 64))


def _tp_params(dims, tp, key, tokens):
    """The JAX tests' TP params: a local init, redrawn at global width."""
    model = JLM(_jcfg(dims, tp))
    local = model.init(jax.random.PRNGKey(key), jnp.asarray(tokens[:2, :-1]))["params"]
    return _np(jglobalize_tp(local, jax.random.PRNGKey(key + 1), tp, jtp_param_dim))


def _spec(kind, model, dims, mesh, **kw):
    return {"kind": kind, "model": model, "cfg": dims, "mesh": mesh, **kw}


ADAM = {"opt": "adam", "lr": 1e-2}
QADAM = {"algo": "qadam", "algo_kw": {"warmup_steps": 3, "lr": 3e-3}, "steps": 8}


@functools.lru_cache(maxsize=None)
def _inputs():
    """Every case: its spec, the JAX test's global params and tokens (the
    JAX tests' keys)."""
    d2t4, d2p4 = {"dp": 2, "tp": 4}, {"dp": 2, "pp": 4}
    d3 = {"dp": 2, "pp": PP, "tp": TP}
    zero_tp = _spec("train", "lm", LAYERS2, {"dp": 4, "tp": 2}, **ADAM, steps=4)
    zero_3d = _spec("train", "pp", LAYERS4, d3, n_micro=2, **ADAM, steps=6)
    return {
        "tptrain": (_spec("train", "lm", TP4, d2t4, **ADAM, steps=10),
                    _tp_params(TP4, 4, 7, _tokens(4)), _tokens(4)),
        "tpqadam": (_spec("train", "lm", TP4, d2t4, **QADAM),
                    _tp_params(TP4, 4, 12, _tokens(11)), _tokens(11)),
        "pptrain": (_spec("train", "pp", LAYERS4, d2p4, n_micro=2, **ADAM, steps=15),
                    global_pp_params(_jcfg(LAYERS4), 5, 4), _tokens(4)),
        "ppqadam": (_spec("train", "pp", LAYERS4, d2p4, n_micro=2, **QADAM),
                    global_pp_params(_jcfg(LAYERS4), 7, 4), _tokens(6)),
        "train3d": (_spec("train", "pp", LAYERS4, d3, n_micro=2, **ADAM, steps=15),
                    global_pp_params(_jcfg(LAYERS4, TP), 5, PP, TP), _tokens(4)),
        "ckpt3d": (_spec("ckpt", "pp", LAYERS4, d3, n_micro=2, **ADAM,
                         other_mesh={"dp": 4, "pp": 2}),
                   global_pp_params(_jcfg(LAYERS4, TP), 7, PP, TP), _tokens(6)),
        "tpckpt": (_spec("ckpt", "lm", TP4, d2t4, **ADAM, other_mesh={"dp": 4, "tp": 2}),
                   _tp_params(TP4, 4, 1, _tokens(0)), _tokens(0)),
        "ppckpt": (_spec("ckpt", "pp", LAYERS4, d2p4, n_micro=2, **ADAM),
                   _np(_pp_ckpt_params()), _tokens(0, (4, 9))),
        "zerotp": ({**zero_tp, "algo": "zero"}, _tp_params(LAYERS2, 2, 1, _tokens(0)),
                   _tokens(0)),
        "zerotp_plain": (zero_tp, _tp_params(LAYERS2, 2, 1, _tokens(0)), _tokens(0)),
        "zero3d": ({**zero_3d, "algo": "zero"}, global_pp_params(_jcfg(LAYERS4, 2), 5, 2, 2),
                   _tokens(4)),
        "zero3d_plain": (zero_3d, global_pp_params(_jcfg(LAYERS4, 2), 5, 2, 2), _tokens(4)),
        "zeroclip": (_spec("error", "lm", {**LAYERS2, "n_layers": 1}, {"dp": 4, "tp": 2},
                           algo="zero", algo_kw={"clip_global_norm": 1.0}, **ADAM),
                     _tp_params({**LAYERS2, "n_layers": 1}, 2, 1, _tokens(0)), _tokens(0)),
        "sptp": (_spec("train", "lm", SPTP, {"dp": 2, "sp": 2, "tp": 2}, opt="sgd", lr=0.1,
                       steps=1), _sptp_params(), _tokens(7, (4, 17))),
    }


def _pp_ckpt_params():
    """tests/test_checkpoint.py:206's: the stage init with the tokens' two
    rows (``model.init(key, tokens[:2])``), redrawn."""
    from bagua_tpu.parallel.pipeline import globalize_pp_params as jglobalize_pp

    local = JPipelined(_jcfg(LAYERS4), pp_size=4, n_microbatches=2).init(
        jax.random.PRNGKey(1), jnp.asarray(_tokens(0, (4, 9))[:2]))["params"]
    return jglobalize_pp(local, jax.random.PRNGKey(2), 4)


def _sptp_params():
    model = JLM(_jcfg(SPTP, 2, sp_axis="sp"), attn_fn=jring(2))
    tokens = _tokens(7, (4, 17))
    local = model.init(jax.random.PRNGKey(8), jnp.asarray(tokens[:2, :8]))["params"]
    return _np(jglobalize_tp(local, jax.random.PRNGKey(9), 2, jtp_param_dim))


@functools.lru_cache(maxsize=None)
def _inputs4():
    spec = _spec("train", "pp", LAYERS4, {"dp": 1, "pp": PP, "tp": TP}, n_micro=2, opt="sgd",
                 lr=0.1, steps=1)
    return {"sgd3d": (spec, global_pp_params(_jcfg(LAYERS4, TP), 0, PP, TP), _tokens(2, (4, 9)))}


_RUNS = {}


def _runs(world, tmp_path_factory):
    if world not in _RUNS:
        inputs = _inputs() if world == 8 else _inputs4()
        data = {}
        for case, val in inputs.items():
            data.update(case_data(case, *val))
        _RUNS[world] = worker.spawn(world, list(inputs), data,
                                    tmp_path_factory.mktemp(f"mp{world}"), timeout=600)
    return _RUNS[world]


def _jax_train(case, algo=None, opt="from_spec", steps=None):
    """The JAX test's trainer on the case's mesh (``steps`` steps, default
    the case's): its losses and ``unstack_params``."""
    spec, params, tokens = _inputs().get(case) or _inputs4()[case]
    mesh = spec["mesh"]
    n = int(np.prod(list(mesh.values())))
    tp, pp, sp = (mesh.get(a, 1) for a in ("tp", "pp", "sp"))
    if spec["model"] == "pp":
        loss_fn = jpp_lm_loss_fn(JPipelined(_jcfg(spec["cfg"], tp), pp_size=pp,
                                            n_microbatches=spec["n_micro"]))
    elif sp > 1:
        loss_fn = jsp_lm_loss_fn(JLM(_jcfg(spec["cfg"], tp, sp_axis="sp"), attn_fn=jring(sp)),
                                 sp_size=sp)
    else:
        loss_fn = jlm_loss_fn(JLM(_jcfg(spec["cfg"], tp)))
    if opt == "from_spec":
        opt = optax.sgd(spec["lr"]) if spec.get("opt") == "sgd" else optax.adam(spec.get("lr"))
    kw = {f"{k}_axis": a for k, a in (("tp", "tp"), ("pp", "pp"), ("seq", "sp"))
          if mesh.get(a, 1) > 1}
    t = JTrainer(loss_fn, opt, algo or JGradientAllReduce(),
                 mesh=jbuild_mesh(mesh, jax.devices()[:n]), autotune=False, **kw)
    s = t.init(params)
    batch = t.shard_batch({"tokens": jnp.asarray(tokens)})
    losses = []
    for _ in range(steps or spec.get("steps", 1)):
        s, loss = t.train_step(s, batch)
        losses.append(float(loss))
    return np.array(losses), _np(t.unstack_params(s))


def _jax_world1(case, dims):
    """The dense golden of a one-step case: the sequential (pp 1, tp 1)
    model at world 1 on the same params; loss and ``unstack_params``."""
    spec, params, tokens = _inputs().get(case) or _inputs4()[case]
    if spec["model"] == "pp":
        loss_fn = jpp_lm_loss_fn(JPipelined(_jcfg(dims), pp_size=1))
    else:
        loss_fn = jlm_loss_fn(JLM(_jcfg(dims)))
    t = JTrainer(loss_fn, optax.sgd(0.1), JGradientAllReduce(),
                 mesh=jbuild_mesh({"dp": 1}, jax.devices()[:1]), autotune=False)
    s = t.init(params)
    s, loss = t.train_step(s, t.shard_batch({"tokens": jnp.asarray(tokens)}))
    return float(loss), _np(t.unstack_params(s))


def _assert_trains_like_jax(outs, case, want):
    got = outs[0][f"{case}/losses"]
    for o in outs:
        np.testing.assert_array_equal(o[f"{case}/losses"], got)
    assert got[-1] < got[0] and want[-1] < want[0], (got, want)
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)


# ---------------------------------------------------------------------------
# 3-D: tests/test_3d_parallel.py
# ---------------------------------------------------------------------------


def test_3d_one_step_matches_sequential(tmp_path_factory):
    """dp 1 x pp 2 x tp 2: the stacked-and-sliced placements, the prescale
    and tp outside the plan, against the sequential world-1 run."""
    outs = _runs(4, tmp_path_factory)
    loss1, want = _jax_world1("sgd3d", LAYERS4)
    losses3d, want3d = _jax_train("sgd3d")
    for o in outs:
        assert_step_matches(o, "sgd3d", loss1, want)
        assert_step_matches(o, "sgd3d", losses3d[-1], want3d)


def test_3d_dp_trains(tmp_path_factory):
    outs = _runs(8, tmp_path_factory)
    want, _ = _jax_train("train3d")
    _assert_trains_like_jax(outs, "train3d", want)
    # data ranks: the dp index; pp and tp peers share a slice
    assert [int(o["train3d/data_rank"]) for o in outs] == [r // 4 for r in range(8)]


def test_3d_checkpoint_roundtrip(tmp_path_factory):
    """Doubly sharded (stage-stacked and tp-sliced) leaves save one file a
    rank and resume bitwise; a restore onto another pipeline mesh raises an
    actionable error."""
    outs = _runs(8, tmp_path_factory)
    straight, _ = _jax_train("ckpt3d", steps=4)
    _assert_resumed(outs, "ckpt3d", straight, {"dp": 2, "pp": 2, "tp": 2}, remeshed=True)


def _assert_resumed(outs, case, want_straight, mesh, remeshed=False):
    """Resumed bitwise, one file a rank, the sidecar's mesh and axes, and
    (``remeshed``) the restore onto another mesh re-sliced: its two steps
    continue the straight run (tests/test_torch_checkpoint_meshes.py holds
    such restores against the JAX package's)."""
    for o in outs:
        np.testing.assert_array_equal(o[f"{case}/resumed"], o[f"{case}/straight"])
        np.testing.assert_allclose(o[f"{case}/resumed"][2:], o[f"{case}/straight"][2:],
                                   rtol=1e-6)
        np.testing.assert_allclose(o[f"{case}/straight"], want_straight, rtol=TRAJ_RTOL)
        assert bool(o[f"{case}/same"]) and int(o[f"{case}/step"]) == 2
        assert [f for f in o[f"{case}/files"] if f.startswith("rank")] == [
            f"rank{r}.pt" for r in range(8)]
        meta = json.loads(str(o[f"{case}/meta"]))
        assert meta["mesh"] == mesh and meta["layout"] == "leaf"
        assert meta["world_size"] == mesh["dp"] * mesh.get("pp", 1)
        for axis in ("tp", "pp"):
            assert meta.get(f"{axis}_axis") == (axis if axis in mesh else None)
        if remeshed:
            assert str(o[f"{case}/error"]) == "", str(o[f"{case}/error"])
            np.testing.assert_allclose(o[f"{case}/other_losses"], o[f"{case}/straight"][2:],
                                       rtol=TRAJ_RTOL)


# ---------------------------------------------------------------------------
# dp 2 x tp 4: tests/test_tensor_parallel.py, tests/test_checkpoint.py:97
# ---------------------------------------------------------------------------


def test_tp_dp_trains(tmp_path_factory):
    outs = _runs(8, tmp_path_factory)
    want, _ = _jax_train("tptrain")
    _assert_trains_like_jax(outs, "tptrain", want)
    assert [int(o["tptrain/data_rank"]) for o in outs] == [r // 4 for r in range(8)]


def test_tp_qadam_trains_through_phase_switch(tmp_path_factory):
    """QAdam crosses its warmup boundary at step 3: the moments of the tp
    slices stay local while the plan's momentum goes through the codec."""
    outs = _runs(8, tmp_path_factory)
    want, _ = _jax_train("tpqadam", algo=JQAdam(warmup_steps=3, lr=3e-3), opt=None)
    _assert_trains_like_jax(outs, "tpqadam", want)


def test_save_restore_tp_sharded_state(tmp_path_factory):
    outs = _runs(8, tmp_path_factory)
    straight, _ = _jax_train("tpckpt", steps=4)
    _assert_resumed(outs, "tpckpt", straight, {"dp": 2, "tp": 4}, remeshed=True)


# ---------------------------------------------------------------------------
# dp 2 x pp 4: tests/test_pipeline_parallel.py, tests/test_checkpoint.py:206
# ---------------------------------------------------------------------------


def test_pp_dp_trains(tmp_path_factory):
    outs = _runs(8, tmp_path_factory)
    want, _ = _jax_train("pptrain")
    _assert_trains_like_jax(outs, "pptrain", want)


def test_pp_qadam_trains_through_phase_switch(tmp_path_factory):
    """The prescale makes the warmup allreduce and the compressed momentum
    average (both spanning pp) sum the stages' partial dense gradients."""
    outs = _runs(8, tmp_path_factory)
    want, _ = _jax_train("ppqadam", algo=JQAdam(warmup_steps=3, lr=3e-3), opt=None)
    _assert_trains_like_jax(outs, "ppqadam", want)


def test_save_restore_pp_sharded_state(tmp_path_factory):
    outs = _runs(8, tmp_path_factory)
    straight, _ = _jax_train("ppckpt", steps=4)
    _assert_resumed(outs, "ppckpt", straight, {"dp": 2, "pp": 4})


# ---------------------------------------------------------------------------
# ZeRO: tests/test_zero.py:132, 181, 233
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["zerotp", "zero3d"])
def test_zero_with_model_parallel_matches_replicated_adam(case, tmp_path_factory):
    """ZeRO's dense buckets reduce-scatter over dp (+ pp, after the
    prescale) while the model-parallel leaves take the replicated path:
    equal to the plain trainer's Adam at the JAX tests' tolerances, and
    tracking JAX's ZeRO run."""
    outs = _runs(8, tmp_path_factory)
    want, _ = _jax_train(case, algo=JZero(optax.adam(1e-2)), opt=None)
    for o in outs:
        np.testing.assert_allclose(o[f"{case}/losses"], o[f"{case}_plain/losses"], rtol=1e-5,
                                   atol=1e-6)
        for name, zp in port_params(o, case).items():
            np.testing.assert_allclose(zp, port_params(o, f"{case}_plain")[name], rtol=2e-5,
                                       atol=2e-5, err_msg=name)
    assert outs[0][f"{case}/losses"][-1] < outs[0][f"{case}/losses"][0]
    np.testing.assert_allclose(outs[0][f"{case}/losses"], want, rtol=TRAJ_RTOL)


def test_zero_clip_rejects_model_parallel(tmp_path_factory):
    outs = _runs(8, tmp_path_factory)
    for o in outs:
        assert "clip_global_norm" in str(o["zeroclip/error"])


# ---------------------------------------------------------------------------
# SP x TP: tests/test_sequence_parallel.py:190
# ---------------------------------------------------------------------------


def test_sp_tp_composition_one_step_matches_dense(tmp_path_factory):
    """dp 2 x sp 2 x tp 2: the tp leaves average over dp x sp, the dense
    buckets reduce over dp x sp, ring attention equals full attention."""
    outs = _runs(8, tmp_path_factory)
    loss1, want = _jax_world1("sptp", SPTP)
    losses, want_sp = _jax_train("sptp")
    for o in outs:
        assert_step_matches(o, "sptp", loss1, want)
        assert_step_matches(o, "sptp", losses[-1], want_sp)
