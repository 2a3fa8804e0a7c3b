"""Version and runtime diagnostics (port of ``bagua_tpu/version.py``)."""

__version__ = "0.1.0"


def show_version() -> str:
    """Build/runtime diagnostics (reference ``show_version``,
    bagua-core-internal/src/lib.rs:103-123: build info and the NCCL
    version): the package, torch, the CUDA it was built for, the NCCL it
    carries, and the cards this process sees."""
    import torch

    cuda = torch.version.cuda or "none"
    lines = [f"bagua_tpu_torch {__version__}", f"torch {torch.__version__}",
             f"cuda {cuda}"]
    if torch.cuda.is_available() and torch.distributed.is_nccl_available():
        lines.append("nccl " + ".".join(str(v) for v in torch.cuda.nccl.version()))
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n:
        lines.append(f"device {torch.cuda.get_device_name(0)} ({n} devices)")
    else:
        lines.append("device cpu (no CUDA device)")
    out = "\n".join(lines)
    print(out)
    return out
