"""``bagua_tpu_torch.version`` (port of ``bagua_tpu/version.py``, mirrored by
no JAX test file): ``show_version`` prints the package, torch, CUDA and the
device in place of jax and its backend, and the version is the JAX
package's."""

import bagua_tpu

import bagua_tpu_torch as bt


def test_show_version_names_torch_and_the_device(capsys):
    import torch

    out = bt.version.show_version()
    assert out == capsys.readouterr().out.strip()
    lines = out.splitlines()
    assert lines[0] == f"bagua_tpu_torch {bt.__version__}"
    assert lines[1] == f"torch {torch.__version__}"
    assert lines[2] == f"cuda {torch.version.cuda or 'none'}"
    assert lines[-1].startswith("device ")
    assert "jax" not in out
    assert bt.__version__ == bagua_tpu.__version__
