"""The port's chaos drill (``scripts/torch_chaos_drill.py``) against the JAX
package's (``scripts/chaos_drill.py``).

- The drill names, ``FLIGHT_EXPECTATIONS`` and the record's keys equal the
  JAX drill's, read from its source with ``ast`` (importing it would set
  ``JAX_PLATFORMS``, ``XLA_FLAGS`` and ``BAGUA_COMM_TIMEOUT_S``).
- The NaN-gradient drill on the JAX package's golden arrays
  (``bench.golden_task()``, carried across): the port's poisoned 10-step run
  is bitwise its clean 9-step run, and its final loss and parameters are
  within 1e-6 of the JAX trainer's run of the same drill at dp 8 (the golden
  batch is the whole global batch, so world 1 and dp 8 take the same mean).
- The drills that run in one process, on the CPU: every one injected,
  detected and recovered, with its flight record and its badput class.
  (The drills of two and four ranks: ``test_torch_chaos_drill_ranks.py``.)
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

import bagua_tpu_torch as bt
from bagua_tpu_torch.models.convert import params_from_jax
from bagua_tpu_torch.models.mlp import MLP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "torch_chaos_drill.py")
JAX_SCRIPT = os.path.join(REPO, "scripts", "chaos_drill.py")
sys.path.insert(0, REPO)

torch.set_num_threads(1)


def _load_drill():
    spec = importlib.util.spec_from_file_location("torch_chaos_drill", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_drill_literals():
    """The JAX drill's drill names (``main``'s ``drills`` keys, in order),
    ``FLIGHT_EXPECTATIONS`` and the record's keys."""
    tree = ast.parse(open(JAX_SCRIPT).read())
    names = record = flight = None
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Dict):
            target = node.targets[0].id
            keys = [ast.literal_eval(k) for k in node.value.keys]
            if target == "drills":
                names = keys
            elif target == "record":
                record = keys
            elif target == "FLIGHT_EXPECTATIONS":
                flight = ast.literal_eval(node.value)
    return names, flight, record


def run_drill(tmp_path, names, timeout=300):
    out, dumps = tmp_path / "record.json", tmp_path / "dumps"
    env = dict(os.environ)
    env.pop("BAGUA_OBS_DUMP_DIR", None)
    proc = subprocess.run([sys.executable, SCRIPT, "--device", "cpu", "--out", str(out),
                           "--dump-dir", str(dumps), "--only", *names],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    assert out.exists(), proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(out) as f:
        return proc, json.load(f)


def check_record(proc, record, names, world):
    from bagua_tpu_torch.obs.ledger import DRILL_BADPUT_EXPECTATIONS

    drill = _load_drill()
    faults = record["faults"]
    assert sorted(faults) == sorted(names)
    failed = {n: r for n, r in faults.items() if not drill.drill_passed(r)}
    assert not failed and proc.returncode == 0 and record["pass"] is True, (
        json.dumps(failed, indent=1) + proc.stdout[-2000:] + proc.stderr[-2000:])
    for name, r in faults.items():
        assert r["injected"] and r["detected"] and r["recovered"], name
        if name in drill.FLIGHT_EXPECTATIONS:
            assert r["flight_record"]["schema_valid"] and r["flight_record"]["found"], name
        if name in DRILL_BADPUT_EXPECTATIONS:
            assert r["ledger"]["badput_class"] == DRILL_BADPUT_EXPECTATIONS[name]
            assert r["ledger"]["surfaced"] and r["ledger"]["delta_s"] > 0, name
    assert record["platform"] == "cpu" and record["n_devices"] == world


def test_names_expectations_and_record_keys_equal_jax():
    drill = _load_drill()
    names, flight, record = _jax_drill_literals()
    assert list(drill.DRILL_NAMES) == names and len(names) == 16
    assert drill.FLIGHT_EXPECTATIONS == flight
    assert sorted(drill.IN_PROCESS + drill.RANKS_2 + drill.RANKS_4) == sorted(names)
    rec = drill.build_record({}, "cpu", 1, 0.0, {})
    assert sorted(rec) == sorted(record)
    assert rec["pass"] is False   # no drill ran: nothing proven


def _golden_npz(path):
    """``bench.golden_task()``'s arrays, the parameters in the port's names."""
    import bench

    _, params, batch = bench.golden_task()
    model = MLP(4, features=(32, 8), device="cpu")
    state = params_from_jax(jax.tree.map(np.asarray, params), model)
    np.savez(path, x=np.asarray(batch["x"]), y=np.asarray(batch["y"]).astype(np.int64),
             **{f"state/{k}": v.numpy() for k, v in state.items()})
    return model


def _jax_nan_grad_runs():
    """``scripts/chaos_drill.py:341-368``: the clean 9-step and the
    poisoned 10-step runs at dp 8."""
    import bench
    from bagua_tpu.algorithms import GradientAllReduceAlgorithm
    from bagua_tpu.core.backend import BaguaTrainer
    from bagua_tpu.faults import inject
    from bagua_tpu.faults.inject import FaultSpec, fault_scope
    from bagua_tpu.parallel.mesh import build_mesh

    loss_fn, params, batch = bench.golden_task()
    mesh = build_mesh({"dp": 8})

    def run(n, guard="off", poison=None):
        import contextlib

        cm = (fault_scope(FaultSpec("grad.poison", step=poison))
              if poison is not None else contextlib.nullcontext())
        with cm:
            t = BaguaTrainer(loss_fn, optax.sgd(0.1), GradientAllReduceAlgorithm(), mesh=mesh,
                             autotune=False, grad_guard=guard)
            s = t.init(params)
            b = t.shard_batch(batch)
            loss = None
            for _ in range(n):
                s, loss = t.train_step(s, b)
            if guard != "off":
                t.flush_grad_health()
        inject.clear_plan()
        return float(loss), jax.tree.map(np.asarray, t.unstack_params(s))

    return run(9), run(10, guard="skip", poison=5)


def test_nan_grad_drill_bitwise_and_against_the_jax_trainer(tmp_path):
    from bagua_tpu_torch.faults import inject

    bt.init_process_group(device="cpu")
    drill = _load_drill()
    model = _golden_npz(tmp_path / "golden.npz")
    try:
        out = drill.nan_grad_runs({"device": torch.device("cpu"),
                                   "golden": str(tmp_path / "golden.npz")})
    finally:
        inject.clear_plan()
    (l_clean, p_clean), (l_skip, p_skip) = out["clean"], out["skip"]
    assert out["fired"] and out["deltas"].get("grad_guard/skipped_steps") == 1
    assert l_skip == l_clean
    assert all(torch.equal(p_clean[k], p_skip[k]) for k in p_clean)
    (j_clean, _), (j_skip, jp_skip) = _jax_nan_grad_runs()
    assert j_skip == j_clean
    want = params_from_jax(jp_skip, model)
    assert abs(l_skip - j_skip) <= 1e-6
    for k, v in want.items():
        np.testing.assert_allclose(p_skip[k].numpy(), v.numpy(), rtol=0, atol=1e-6)


def test_in_process_drills_on_the_cpu(tmp_path):
    drill = _load_drill()
    proc, record = run_drill(tmp_path, drill.IN_PROCESS)
    check_record(proc, record, drill.IN_PROCESS, world=1)
    assert record["counters"].get("faults/collective.hang/fired", 0) >= 2
    assert any(n.startswith("flight_") for n in os.listdir(tmp_path / "dumps"))


@pytest.mark.parametrize("rel", ["scripts/torch_chaos_drill.py", "bagua_tpu_torch/obs/regress.py",
                                 "bagua_tpu_torch/obs/ab.py",
                                 "bagua_tpu_torch/serve/schema.py"])
def test_new_sources_import_no_jax(rel):
    from test_torch_isolation import FORBIDDEN, _imported_roots
    from pathlib import Path

    assert not set(_imported_roots(Path(REPO) / rel)) & set(FORBIDDEN)
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'pydantic', 'bagua_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import importlib.util\n"
            f"spec = importlib.util.spec_from_file_location('m', {rel!r})\n"
            "importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
