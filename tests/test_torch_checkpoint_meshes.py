"""Restores across model-parallel meshes: the port's against the JAX
package's (tests/test_checkpoint.py:95-135 and :205-250, their meshes
changed between the save and the restore).

The JAX package restores its GLOBAL arrays onto the live mesh's shardings
(``checkpoint.py:702-760``), so a restore completes where the global shapes
agree.  Each case saves after 2 Adam steps (lr 1e-4) through the trainer's
``save_checkpoint``, restores into a trainer on another mesh through
``restore_checkpoint`` and takes 2 steps there:

- (a) the tensor-parallel LM of :95, ``{dp 2, tp 4}`` -> ``{dp 4, tp 2}`` and
  -> ``{dp 8}`` (no tp axis: every leaf in the bucket plan), and the reverse
  ``{dp 8}`` -> ``{dp 4, tp 2}`` (a checkpoint of whole leaves, cut to the
  live slices);
- (b) the pipeline of :205, ``{dp 2, pp 4}`` -> ``{dp 4, pp 2}`` (8 token rows,
  so that each of the 4 data ranks has its 2 microbatches);
- (c) the MoE LM of tests/test_torch_expert_parallel.py,
  ``{dp 4, ep 2}`` -> ``{dp 2, ep 4}``: the JAX package's expert tables are
  stacked by ep rank, so its restore fails on their shapes, and the port
  raises a ``ValueError`` naming both meshes;
- (a) again under the families with optimizer state of their own: QAdam's
  moments are laid out like the parameters, and both packages complete the
  restore; ZeRO's chunks follow the comm world, and both refuse it.

Where JAX completes the restore, the port's resumed losses equal JAX's
within the JAX test's ``rtol=1e-6``.  The rate is the port suite's Adam
parity rate, not the JAX test's 1e-2: at 1e-2 Adam turns the packages'
one-ulp gradient differences into a loss gap of 1.3e-6 after the two steps
before the save (a_tp2), which is the trajectories' gap and not the
restore's.  Each case's two outcomes are printed
and recorded (``record_property``).  The port's ranks run in one spawn of
``tests/workers/torch_tensor_pipeline_worker.py`` (8 gloo ranks).
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
from bagua_tpu.checkpoint import BaguaCheckpointManager as JCheckpointManager
from bagua_tpu.core.backend import BaguaTrainer as JTrainer
from bagua_tpu.model_parallel.moe.layer import MoEMLP as JMoEMLP
from bagua_tpu.model_parallel.moe.layer import globalize_expert_params as jglobalize_ep
from bagua_tpu.model_parallel.moe.layer import moe_lm_loss_fn as jmoe_lm_loss_fn
from bagua_tpu.models.transformer import TransformerConfig as JConfig
from bagua_tpu.models.transformer import TransformerLM as JLM
from bagua_tpu.models.transformer import lm_loss_fn as jlm_loss_fn
from bagua_tpu.models.transformer import tp_param_dim as jtp_param_dim
from bagua_tpu.parallel.mesh import build_mesh as jbuild_mesh
from bagua_tpu.parallel.pipeline import PipelinedTransformerLM as JPipelined
from bagua_tpu.parallel.pipeline import globalize_pp_params as jglobalize_pp
from bagua_tpu.parallel.pipeline import pp_lm_loss_fn as jpp_lm_loss_fn
from bagua_tpu.parallel.tensor_parallel import globalize_tp_params as jglobalize_tp

sys.path.insert(0, str(Path(__file__).resolve().parent / "workers"))
import torch_tensor_pipeline_worker as worker  # noqa: E402

torch.set_num_threads(1)

LR = 1e-4
#: the JAX test's tolerance on resumed losses
RESUME_RTOL = 1e-6
TP_CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=8)
PP_CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=4, d_ff=64, max_seq_len=8)
EP_CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq_len=8)
#: case -> (model, saved mesh, live mesh, does the JAX package complete it,
#: the family: ``ga`` (gradient allreduce over Adam), QAdam in its warmup
#: phase at the same rate, ZeRO over Adam)
CASES = {
    "a_tp2": ("lm", {"dp": 2, "tp": 4}, {"dp": 4, "tp": 2}, True, "ga"),
    "a_dp8": ("lm", {"dp": 2, "tp": 4}, {"dp": 8}, True, "ga"),
    "a_from_dp8": ("lm", {"dp": 8}, {"dp": 4, "tp": 2}, True, "ga"),
    "b_pp2": ("pp", {"dp": 2, "pp": 4}, {"dp": 4, "pp": 2}, True, "ga"),
    "c_ep4": ("moe", {"dp": 4, "ep": 2}, {"dp": 2, "ep": 4}, False, "ga"),
    "a_qadam": ("lm", {"dp": 2, "tp": 4}, {"dp": 4, "tp": 2}, True, "qadam"),
    "a_zero": ("lm", {"dp": 2, "tp": 4}, {"dp": 4, "tp": 2}, False, "zero"),
}
QADAM = {"warmup_steps": 100, "lr": LR}


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


def _tokens(case):
    if case.startswith("c"):
        return np.random.default_rng(2).integers(0, 64, (8, 9), dtype=np.int32)
    return np.asarray(jax.random.randint(jax.random.PRNGKey(0), (8, 9), 0, 64))


def _jmodel(case, mesh):
    """The JAX model of ``case`` at the widths of ``mesh``."""
    kind = CASES[case][0]
    if kind == "lm":
        tp = mesh.get("tp", 1)
        return JLM(JConfig(**TP_CFG, dtype=jnp.float32, tp_axis="tp" if tp > 1 else None,
                           tp_size=tp))
    if kind == "pp":
        return JPipelined(JConfig(**PP_CFG, dtype=jnp.float32), pp_size=mesh["pp"],
                          n_microbatches=2)
    ep = mesh["ep"]
    factory = lambda i: ((lambda: JMoEMLP(n_experts=worker.N_EXPERTS, d_ff=64, ep_size=ep,
                                          k=2, dropless=True, dtype=jnp.float32))
                         if i % 2 == 1 else None)
    return JLM(JConfig(**EP_CFG, dtype=jnp.float32), mlp_factory=factory)


@functools.lru_cache(maxsize=None)
def _global_params(case):
    """The GLOBAL params of the saved mesh's model, drawn as the JAX tests
    draw them."""
    kind, saved = CASES[case][:2]
    model, tokens = _jmodel(case, saved), jnp.asarray(_tokens(case))
    if kind == "lm":
        local = model.init(jax.random.PRNGKey(1), tokens[:2, :-1])["params"]
        if "tp" not in saved:
            return _np(local)
        return _np(jglobalize_tp(local, jax.random.PRNGKey(2), saved["tp"], jtp_param_dim))
    if kind == "pp":
        local = model.init(jax.random.PRNGKey(1), tokens[:2])["params"]
        return _np(jglobalize_pp(local, jax.random.PRNGKey(2), saved["pp"]))
    local = model.init(jax.random.PRNGKey(3), tokens[:2, :-1])["params"]
    return _np(jglobalize_ep(local, jax.random.PRNGKey(4), ep_size=saved["ep"]))


def _jtrainer(case, mesh):
    kind = CASES[case][0]
    model = _jmodel(case, mesh)
    loss_fn = {"lm": jlm_loss_fn, "pp": jpp_lm_loss_fn, "moe": jmoe_lm_loss_fn}[kind](model)
    axes = {f"{name}_axis": a for name, a in (("tp", "tp"), ("pp", "pp"), ("expert", "ep"))
            if mesh.get(a, 1) > 1}
    n = int(np.prod(list(mesh.values())))
    algo = CASES[case][4]
    algorithm = {"ga": JGradientAllReduce, "qadam": lambda: JQAdam(**QADAM),
                 "zero": lambda: JZero(optax.adam(LR))}[algo]()
    return JTrainer(loss_fn, optax.adam(LR) if algo == "ga" else None, algorithm,
                    mesh=jbuild_mesh(mesh, jax.devices()[:n]), autotune=False, **axes)


def _jax_outcome(case, directory):
    """JAX's restore of ``case``: ``{"ok": True, "losses": [...]}`` after
    its 2 steps on the live mesh, or ``{"ok": False, "error": ...}``."""
    saved, live = CASES[case][1:3]
    params, tokens = _global_params(case), jnp.asarray(_tokens(case))
    t1 = _jtrainer(case, saved)
    s1 = t1.init(params)
    batch = t1.shard_batch({"tokens": tokens})
    for _ in range(2):
        s1, _ = t1.train_step(s1, batch)
    mgr = JCheckpointManager(str(directory), async_save=False)
    t1.save_checkpoint(mgr, 2, s1)
    mgr.wait()
    t2 = _jtrainer(case, live)
    try:
        _, s2 = t2.restore_checkpoint(mgr, t2.init(params))
        batch = t2.shard_batch({"tokens": tokens})
        losses = []
        for _ in range(2):
            s2, loss = t2.train_step(s2, batch)
            losses.append(float(loss))
        return {"ok": True, "losses": losses}
    except Exception as e:  # noqa: BLE001 - the outcome is what is recorded
        return {"ok": False, "error": f"{type(e).__name__}: {e}"}
    finally:
        mgr.close()


@functools.lru_cache(maxsize=None)
def _port_runs(tmp):
    data = {}
    for case, (kind, saved, live, _, algo) in CASES.items():
        spec = {"kind": "remesh", "model": "pp" if kind == "pp" else "lm",
                "cfg": {"lm": TP_CFG, "pp": PP_CFG, "moe": EP_CFG}[kind], "mesh": saved,
                "other_mesh": live, "opt": "adam", "lr": LR, "n_micro": 2, "algo": algo,
                "algo_kw": QADAM if algo == "qadam" else {}}
        data[f"{case}/spec"] = np.array(json.dumps(spec))
        data[f"{case}/tokens"] = _tokens(case)
        data.update({f"{case}/params/{k}": v for k, v in _flat(_global_params(case)).items()})
    return worker.spawn(8, list(CASES), data, Path(tmp))


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    return _port_runs(str(tmp_path_factory.mktemp("remesh")))


@pytest.mark.parametrize("case", list(CASES))
def test_restore_across_meshes_as_jax(case, port_runs, tmp_path, record_property):
    saved, live, completes = CASES[case][1:4]
    want = _jax_outcome(case, tmp_path / "jax")
    outs = port_runs
    port = ({"ok": True, "losses": outs[0][f"{case}/other_losses"].tolist()}
            if str(outs[0][f"{case}/error"]) == ""
            else {"ok": False, "error": str(outs[0][f"{case}/error"])})
    line = f"{case}: {saved} -> {live}: JAX {want}; port {port}"
    print(line)
    record_property(case, line)
    assert want["ok"] == completes, want
    assert port["ok"] == want["ok"], line
    for o in outs:
        if completes:
            assert str(o[f"{case}/error"]) == ""
            np.testing.assert_allclose(o[f"{case}/other_losses"], want["losses"],
                                       rtol=RESUME_RTOL)
        else:
            err = str(o[f"{case}/error"])
            assert str(saved) in err and str(live) in err, err
            assert "Restore on the saved mesh" in err, err
