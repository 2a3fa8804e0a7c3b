"""The torch-free import path of the simulator's node and coordinator
processes (stdlib only).

``bagua_tpu_torch/__init__`` imports the trainer and so torch, and the
``__init__`` of ``contrib`` and ``elastic`` import modules that reach torch
(``contrib.sync_batchnorm``, ``elastic.resize``).  A process that runs
``worker.py`` or ``coordinator.py`` as a file installs those three packages
as namespace packages first (:func:`install`): their submodules then import
without running the ``__init__`` files, so the store, elastic, autopilot
and obs modules a node needs load with neither torch nor numpy.
"""

import importlib.util
import os
import sys

#: the packages whose ``__init__`` would import torch, relative to the root
SHIMMED = ("", "contrib", "elastic")


def install(repo: str) -> None:
    """Put ``repo`` first on ``sys.path`` and install the namespace packages
    of :data:`SHIMMED` (a package already imported is left as it is)."""
    if repo not in sys.path:
        sys.path.insert(0, repo)
    for sub in SHIMMED:
        name = "bagua_tpu_torch" + (f".{sub}" if sub else "")
        if name in sys.modules:
            continue
        spec = importlib.util.spec_from_loader(name, loader=None, is_package=True)
        pkg = importlib.util.module_from_spec(spec)
        pkg.__path__ = [os.path.join(repo, "bagua_tpu_torch", *([sub] if sub else []))]
        sys.modules[name] = pkg
