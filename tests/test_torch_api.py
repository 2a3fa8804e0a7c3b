"""The port's top-level API against the JAX package's.

Every public name of ``bagua_tpu``'s top level exists on ``bagua_tpu_torch``,
except ``compat`` (jax ``shard_map`` shims, not ported).  ``get_local_size`` reads
``LOCAL_WORLD_SIZE`` with the JAX package's default of 1; the three in-place
names are the same functions as their plain ones, as in the JAX package.
The control plane's settings, the pod simulator's (``BAGUA_SCALE_*``) and the
lockdep witness's (``BAGUA_LOCKDEP*``) are declared with the JAX package's
types, defaults and choices, and their getters read the same values.
"""

import ast
import subprocess
import sys
from pathlib import Path

import bagua_tpu
import pytest

import bagua_tpu_torch as bt
from bagua_tpu import env as jenv
from bagua_tpu_torch import env as tenv

NOT_PORTED = {"compat"}
REPO = Path(__file__).resolve().parents[1]


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def test_every_top_level_name_of_the_jax_package_exists():
    # in a fresh interpreter: a test process's imports of submodules (podsim,
    # analysis, ...) add attributes to the package
    code = ("import bagua_tpu, bagua_tpu_torch\n"
            "pub = lambda m: {n for n in dir(m) if not n.startswith('_')}\n"
            "print(sorted(pub(bagua_tpu) - pub(bagua_tpu_torch)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    missing = sorted(set(ast.literal_eval(out.stdout.strip().splitlines()[-1])) - NOT_PORTED)
    assert not missing, missing


@pytest.mark.parametrize("name", ["allgather", "reduce_scatter", "alltoall"])
def test_inplace_names_alias_their_plain_function(name):
    assert getattr(bt, f"{name}_inplace") is getattr(bt, name)
    assert getattr(bagua_tpu, f"{name}_inplace") is getattr(bagua_tpu, name)


@pytest.mark.parametrize("value", [None, "1", "4"])
def test_get_local_size_matches_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", value)
    assert tenv.get_local_size() == jenv.get_local_size()
    assert bt.get_local_size() == (1 if value is None else int(value))


@pytest.mark.parametrize("name", [
    "BAGUA_SERVICE_PORT", "BAGUA_AUTOTUNE", "BAGUA_AUTOTUNE_MAX_SAMPLES",
    "BAGUA_AUTOTUNE_SAMPLING_CONFIDENCE_TIME_S", "BAGUA_AUTOTUNE_WARMUP_TIME_S",
    "BAGUA_AUTOTUNE_ALGORITHM", "BAGUA_AUTOTUNE_GOODPUT", "BAGUA_AUTOTUNE_SPACE",
    "BAGUA_OBS_HTTP_PORT", "BAGUA_OBS_HTTP_ADDR", "BAGUA_OBS_HISTORIAN",
    "BAGUA_OBS_HISTORIAN_CAPACITY", "BAGUA_OBS_HISTORIAN_WINDOW_S", "BAGUA_AUTOPILOT",
    "BAGUA_AUTOPILOT_SLO_GOODPUT", "BAGUA_AUTOPILOT_SUSTAIN", "BAGUA_AUTOPILOT_COOLDOWN_S",
    "BAGUA_AUTOPILOT_BUDGET", "BAGUA_AUTOPILOT_STALENESS_S",
    "BAGUA_AUTOPILOT_STRAGGLER_RATIO", "BAGUA_AUTOPILOT_SUSPECT_TTL_S",
    "BAGUA_AUTOPILOT_CKPT_FAILURES", "BAGUA_AUTOPILOT_FAMILY", "BAGUA_AUTOPILOT_MODEL",
    "BAGUA_AUTOPILOT_DCN_SHARE", "BAGUA_AUTOPILOT_COMPRESS_FAMILY",
    "BAGUA_AUTOPILOT_COMPRESS_CODEC", "BAGUA_AUTOPILOT_HBM_HORIZON_S",
    "BAGUA_SCALE_RANKS", "BAGUA_SCALE_SHAPE", "BAGUA_SCALE_SEED", "BAGUA_SCALE_DCN_CODEC",
    "BAGUA_LOCKDEP", "BAGUA_LOCKDEP_OUT"])
def test_control_plane_settings_declared_as_in_jax(name):
    t, j = tenv.ENV_REGISTRY[name], jenv.ENV_REGISTRY[name]
    assert (t.type, t.default, t.choices) == (j.type, j.default, j.choices)


GETTERS = [
    "get_bagua_service_port", "get_autotune_level", "get_autotune_max_samples",
    "get_autotune_sampling_confidence_time_s", "get_autotune_warmup_time_s",
    "is_autotune_algorithm_on", "get_autotune_goodput", "get_autotune_space",
    "get_obs_http_port", "get_obs_http_addr", "is_obs_historian_on",
    "get_obs_historian_capacity", "get_obs_historian_window_s", "get_autopilot_mode",
    "get_autopilot_slo_goodput", "get_autopilot_sustain", "get_autopilot_cooldown_s",
    "get_autopilot_budget", "get_autopilot_staleness_s", "get_autopilot_straggler_ratio",
    "get_autopilot_suspect_ttl_s", "get_autopilot_ckpt_failures", "get_autopilot_family",
    "get_autopilot_model", "get_autopilot_dcn_share", "get_autopilot_compress_family",
    "get_autopilot_compress_codec", "get_autopilot_hbm_horizon_s",
    "get_scale_ranks", "get_scale_shape", "get_scale_seed", "get_scale_dcn_codec",
    "get_lockdep_mode", "get_lockdep_out",
]


@pytest.mark.parametrize("getter", GETTERS)
def test_control_plane_getters_agree_with_jax(monkeypatch, getter):
    assert getattr(tenv, getter)() == getattr(jenv, getter)()
    monkeypatch.setenv("BAGUA_AUTOTUNE_SPACE", "LEGACY")
    monkeypatch.setenv("BAGUA_AUTOPILOT", "observe")
    monkeypatch.setenv("BAGUA_AUTOPILOT_SUSTAIN", "7")
    monkeypatch.setenv("BAGUA_OBS_HISTORIAN_WINDOW_S", "12.5")
    monkeypatch.setenv("BAGUA_AUTOTUNE_GOODPUT", "0")
    monkeypatch.setenv("BAGUA_SCALE_RANKS", "8,16")
    monkeypatch.setenv("BAGUA_SCALE_SHAPE", "wan")
    monkeypatch.setenv("BAGUA_SCALE_SEED", "3")
    monkeypatch.setenv("BAGUA_SCALE_DCN_CODEC", "topk")
    monkeypatch.setenv("BAGUA_LOCKDEP_OUT", "/tmp/w.json")
    assert getattr(tenv, getter)() == getattr(jenv, getter)()
