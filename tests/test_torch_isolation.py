"""The port stands alone: it imports no JAX, flax, optax, pydantic or
bagua_tpu module, so it runs on a machine that has only torch and numpy."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pydantic", "bagua_tpu")
SOURCES = sorted((REPO / "bagua_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_found():
    names = {p.relative_to(REPO).as_posix() for p in SOURCES}
    assert {"chip_smoke.py", "bagua_tpu_torch/core/backend.py",
            "bagua_tpu_torch/ops/flash_attention.py", "bagua_tpu_torch/ops/gmm.py",
            "bagua_tpu_torch/model_parallel/moe/layer.py"} <= names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_forbidden_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_import_without_jax_loads_no_bagua_tpu():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'pydantic', 'bagua_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import bagua_tpu_torch, bagua_tpu_torch.models.convert, "
        "bagua_tpu_torch.ops._build\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'pydantic', 'bagua_tpu') and sys.modules[m]]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
