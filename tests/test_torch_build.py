"""The port's kernel build: the library's name follows every source it is
built from.

``_build._lib_path`` names a library by a hash of its ``.cu`` source and of
every ``csrc/*.cuh`` header, so that an edit of either builds anew instead of
loading a stale library.  Pure Python: runs on a copy of ``csrc`` without
``nvcc``.
"""

import shutil

import pytest

from bagua_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


@pytest.mark.parametrize("name", ["flash_attention", "gmm", "codec"])
def test_library_name_follows_source_and_headers(csrc, name):
    assert sorted(p.name for p in csrc.glob("*.cuh")) == ["hopper.cuh"]
    first = _build._lib_path(name)
    assert first == _build._lib_path(name)          # stable
    assert first.parent == _build.BUILD_DIR and first.name.startswith(name + "-")
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    second = _build._lib_path(name)
    assert second != first                         # a header edit rebuilds
    source = csrc / f"{name}.cu"
    source.write_text(source.read_text() + "\n// edited\n")
    assert _build._lib_path(name) not in (first, second)   # and a source edit
    (csrc / "extra.cuh").write_text("// a new header\n")
    assert _build._lib_path(name) not in (first, second)   # a new header too


def test_variant_builds_find_the_headers(csrc, tmp_path, monkeypatch):
    # a copy of a source outside csrc (a variant to time) compiles with
    # csrc on the include path
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    cmd = _build.nvcc_command(tmp_path / "variant.cu", tmp_path / "variant.so")
    assert cmd[0] == "nvcc" and cmd[-1] == str(tmp_path / "variant.cu")
    assert cmd[cmd.index("-I") + 1] == str(csrc)
    assert cmd[cmd.index("-o") + 1] == str(tmp_path / "variant.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
