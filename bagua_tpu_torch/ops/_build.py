"""Build the port's CUDA sources with ``nvcc`` at first use and load them.

Each ``ops/csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own into ``build/kernels/<name>-<hash>.so`` beside the package (a directory
``.gitignore`` lists); the hash in the file name covers the source and every
``csrc/*.cuh`` header, so that an edit of either never loads a stale library.  :func:`build_all` starts one ``nvcc``
per source, all at once; :func:`kernels_of_calls` names the device kernels
that calls of a wrapper run.  Nothing here runs at import time: the CPU tests
import every module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# -split-compile=0: the compiler's optimizations run on all of the host's
# cores (the flash library alone has 45 kernels)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-split-compile=0",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from source at first use")


def _lib_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` goes: named by a hash of that
    source and of every header in ``csrc`` (which any source may include)."""
    digest = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def nvcc_command(src, out) -> List[str]:
    """The ``nvcc`` command that compiles ``src`` into the library ``out``;
    ``csrc`` is on the include path, so a copy of a source elsewhere (a
    variant to time) still finds the headers."""
    return [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(src)]


def _start(name: str):
    """Start ``nvcc`` for one source; returns (proc, tmp_path, out_path) or
    None when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(nvcc_command(CSRC / f"{name}.cu", tmp), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    """Wait for one build and move the library into place; returns the
    compiler's output (register and shared-memory use per kernel)."""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return log


def build_all(names: List[str] = None) -> Dict[str, str]:
    """Compile every named source (default: all of ``csrc/*.cu``) with one
    ``nvcc`` each, all started together.  Returns each fresh build's compiler
    output by name; sources already built are skipped."""
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    with _LOCK:
        started = {n: _start(n) for n in names}
        return {n: _finish(n, s) for n, s in started.items() if s is not None}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib


def bind(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """:func:`load`, with each function of ``signatures`` given its
    ``argtypes`` (``c_void_p`` for a pointer or the stream, ``c_int`` for an
    int, so that ctypes cuts nothing) and an ``int`` return, the CUDA error
    code."""
    lib = load(name)
    for fn_name, argtypes in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(fn, *args) -> None:
    """Call a bound kernel launcher on PyTorch's current stream; raise if
    it returns a CUDA error (a refused launch never runs, and a later
    synchronize would not report it)."""
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {rc}")


def kernels_of_calls(fn, calls=3, tries=5) -> List[str]:
    """The device kernels that ``calls`` calls of ``fn`` run, one name a
    launch, from one profiler window after a warm-up step.  The profiler now
    and then loses device events of short kernels; a window that recorded
    fewer launches than calls (every call launches one kernel at least) has
    lost some and is taken again, up to ``tries`` windows."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    names = []
    for _ in range(tries):
        sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=acts, schedule=sched) as prof:
            for _ in range(2):   # the warm-up step, then the recorded one
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(names) >= calls:
            break
    return names
