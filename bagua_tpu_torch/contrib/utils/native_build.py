"""On-demand build of the native store server.

The port's counterpart of ``bagua_tpu/contrib/utils/native_build.py``: the
one host-native runtime piece, ``csrc/bagua_store_server.cpp`` at the root
of the repository (shared with the JAX package, unchanged), compiled at
first use with the host's C++ compiler.  The binary goes to
``build/store/`` beside the package (a directory ``.gitignore`` lists, as
the kernels' ``build/kernels/`` is), named by a hash of the source, so a
rebuild happens only when the source changes.
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

_ROOT = Path(__file__).resolve().parents[3]
_SRC = _ROOT / "csrc" / "bagua_store_server.cpp"
BUILD_DIR = _ROOT / "build" / "store"


def ensure_store_server(required: bool = False) -> Optional[str]:
    """Path to the compiled server binary, building it if needed.

    Returns None (the caller falls back to the Python server) when the
    source or a C++ compiler is missing or the build fails, unless
    ``required``, which raises instead."""
    if not _SRC.exists():
        if required:
            raise FileNotFoundError(str(_SRC))
        return None
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        if required:
            raise RuntimeError("no C++ compiler found for the native store")
        return None

    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    binary = BUILD_DIR / f"bagua_store_server-{digest}"
    if binary.exists():
        return str(binary)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix="bagua_store_server-", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, "-O2", "-std=c++17", "-pthread", str(_SRC), "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        stderr = getattr(e, "stderr", b"") or b""
        logger.warning("native store build failed: %s", stderr.decode()[-500:])
        if required:
            raise
        return None
    os.replace(tmp, binary)  # atomic against a concurrent build
    logger.info("built native store server -> %s", binary)
    return str(binary)
