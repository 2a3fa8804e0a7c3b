"""The port's docs generators: ``scripts/torch_gen_api_docs.py`` and
``scripts/torch_gen_env_docs.py``.  Both ``--check`` pass on the committed
``docs/torch/`` files; every env var of the port's registry and every metric
of its registry has its row; the API reference covers the JAX generator's
module list, module for module, but for the modules it names as left out."""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")


@pytest.mark.parametrize("script", ["torch_gen_api_docs.py", "torch_gen_env_docs.py"])
def test_check_passes_on_the_committed_docs(script):
    out = subprocess.run([sys.executable, os.path.join(SCRIPTS, script), "--check"],
                         capture_output=True, text=True, cwd="/", timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "up to date" in out.stdout


def _table_names(path):
    with open(path) as f:
        return set(re.findall(r"^\| `([^`]+)` \|", f.read(), re.M))


def test_every_env_var_has_a_row():
    from bagua_tpu_torch.env import ENV_REGISTRY

    rows = _table_names(os.path.join(REPO, "docs", "torch", "env_vars.md"))
    assert rows == set(ENV_REGISTRY)


def test_every_metric_has_a_row():
    from bagua_tpu_torch.obs.export import METRIC_REGISTRY

    rows = _table_names(os.path.join(REPO, "docs", "torch", "metrics.md"))
    assert rows == set(METRIC_REGISTRY)


def _load(path, name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_api_modules_mirror_the_jax_list():
    import ast

    with open(os.path.join(SCRIPTS, "gen_api_docs.py")) as f:
        tree = ast.parse(f.read())
    jax_modules = next(ast.literal_eval(n.value) for n in tree.body if isinstance(n, ast.Assign)
                       and getattr(n.targets[0], "id", "") == "MODULES")
    gen = _load(os.path.join(SCRIPTS, "torch_gen_api_docs.py"), "torch_gen_api_docs")
    renamed = {"bagua_tpu.compression.pallas_codec": "bagua_tpu_torch.ops.codec",
               "bagua_tpu.analysis.jaxpr_check": "bagua_tpu_torch.analysis.collective_check"}
    want = [renamed.get(m, "bagua_tpu_torch" + m[len("bagua_tpu"):]) for m in jax_modules
            if m not in gen.LEFT_OUT]
    assert gen.MODULES == want
    assert set(gen.LEFT_OUT) <= set(jax_modules)
    for name in gen.MODULES:
        assert os.path.exists(os.path.join(REPO, "docs", "torch", "api",
                                           name.replace(".", "_") + ".md")), name


def test_generators_import_neither_jax_nor_the_jax_package():
    code = ("import runpy, sys\n"
            f"sys.argv = ['x', '--check']\n"
            "for s in ('torch_gen_api_docs.py', 'torch_gen_env_docs.py'):\n"
            f"    try:\n        runpy.run_path({SCRIPTS!r} + '/' + s, run_name='__main__')\n"
            "    except SystemExit as e:\n        assert e.code == 0, s\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'bagua_tpu'))\n"
            "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd="/",
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
