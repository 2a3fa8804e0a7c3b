#!/usr/bin/env python
"""Generate the port's markdown API reference from its docstrings.

Counterpart of ``scripts/gen_api_docs.py``: stdlib ``inspect`` emits one
markdown file a module of ``bagua_tpu_torch`` into ``docs/torch/api/``, in
the order of :data:`MODULES`, the JAX generator's list with the port's
module names.  The output is deterministic (memory addresses stripped), so
``--check`` regenerates in memory and diffs against the committed pages.

Usage: python scripts/torch_gen_api_docs.py [--check]
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "docs", "torch", "api")

#: the documented module surface (this order is the index's), module for
#: module the JAX generator's (``scripts/gen_api_docs.py:24-113``), but:
#: ``compression.pallas_codec`` (the Pallas kernels) is documented by its
#: replacement ``ops.codec`` (the wrappers of ``ops/csrc/codec.cu``), and
#: ``analysis.jaxpr_check`` by its counterpart ``analysis.collective_check``
#: (the collective log in place of a jaxpr).
MODULES = [
    "bagua_tpu_torch",
    "bagua_tpu_torch.core.backend",
    "bagua_tpu_torch.communication",
    "bagua_tpu_torch.algorithms.base",
    "bagua_tpu_torch.algorithms.gradient_allreduce",
    "bagua_tpu_torch.algorithms.bytegrad",
    "bagua_tpu_torch.algorithms.q_adam",
    "bagua_tpu_torch.algorithms.decentralized",
    "bagua_tpu_torch.algorithms.async_model_average",
    "bagua_tpu_torch.algorithms.zero",
    "bagua_tpu_torch.bucket",
    "bagua_tpu_torch.tensor",
    "bagua_tpu_torch.checkpoint",
    "bagua_tpu_torch.watchdog",
    "bagua_tpu_torch.faults.inject",
    "bagua_tpu_torch.env",
    "bagua_tpu_torch.telemetry",
    "bagua_tpu_torch.obs.spans",
    "bagua_tpu_torch.obs.recorder",
    "bagua_tpu_torch.obs.export",
    "bagua_tpu_torch.obs.timeline",
    "bagua_tpu_torch.obs.anomaly",
    "bagua_tpu_torch.obs.attribution",
    "bagua_tpu_torch.obs.regress",
    "bagua_tpu_torch.obs.ledger",
    "bagua_tpu_torch.obs.memory",
    "bagua_tpu_torch.obs.historian",
    "bagua_tpu_torch.obs.http",
    "bagua_tpu_torch.autopilot.policy",
    "bagua_tpu_torch.autopilot.engine",
    "bagua_tpu_torch.podsim.util",
    "bagua_tpu_torch.podsim.shaping",
    "bagua_tpu_torch.podsim.collectives",
    "bagua_tpu_torch.podsim.transport",
    "bagua_tpu_torch.podsim.orchestrator",
    "bagua_tpu_torch.profiling",
    "bagua_tpu_torch.parallel.mesh",
    "bagua_tpu_torch.parallel.tensor_parallel",
    "bagua_tpu_torch.parallel.pipeline",
    "bagua_tpu_torch.parallel.ring_attention",
    "bagua_tpu_torch.parallel.ulysses",
    "bagua_tpu_torch.model_parallel.moe.layer",
    "bagua_tpu_torch.model_parallel.moe.gating",
    "bagua_tpu_torch.models.mlp",
    "bagua_tpu_torch.models.resnet",
    "bagua_tpu_torch.models.vgg",
    "bagua_tpu_torch.models.transformer",
    "bagua_tpu_torch.models.generate",
    "bagua_tpu_torch.serve",
    "bagua_tpu_torch.serve.cache",
    "bagua_tpu_torch.serve.engine",
    "bagua_tpu_torch.serve.loader",
    "bagua_tpu_torch.serve.schema",
    "bagua_tpu_torch.ops.flash_attention",
    "bagua_tpu_torch.ops.gmm",
    "bagua_tpu_torch.compression.codecs",
    "bagua_tpu_torch.compression.minmax_uint8",
    "bagua_tpu_torch.ops.codec",
    "bagua_tpu_torch.contrib.fused_optimizer",
    "bagua_tpu_torch.contrib.load_balancing_data_loader",
    "bagua_tpu_torch.contrib.cache_loader",
    "bagua_tpu_torch.contrib.cached_dataset",
    "bagua_tpu_torch.contrib.sync_batchnorm",
    "bagua_tpu_torch.contrib.digits_data",
    "bagua_tpu_torch.contrib.utils.store",
    "bagua_tpu_torch.contrib.utils.tcp_store",
    "bagua_tpu_torch.contrib.utils.redis_store",
    "bagua_tpu_torch.service.autotune_service",
    "bagua_tpu_torch.service.autotune_task_manager",
    "bagua_tpu_torch.service.bayesian_optimizer",
    "bagua_tpu_torch.distributed.run",
    "bagua_tpu_torch.elastic.membership",
    "bagua_tpu_torch.elastic.coordinator",
    "bagua_tpu_torch.elastic.failover",
    "bagua_tpu_torch.elastic.resize",
    "bagua_tpu_torch.script.baguarun",
    "bagua_tpu_torch.analysis",
    "bagua_tpu_torch.analysis.ast_rules",
    "bagua_tpu_torch.analysis.collective_check",
    "bagua_tpu_torch.analysis.findings",
    "bagua_tpu_torch.analysis.suppressions",
    "bagua_tpu_torch.analysis.concurrency",
    "bagua_tpu_torch.analysis.trace_coherence",
    "bagua_tpu_torch.analysis.lockdep",
    "bagua_tpu_torch.define",
    "bagua_tpu_torch.utils",
]

#: JAX modules without a counterpart in the port, with the reason
LEFT_OUT = {
    "bagua_tpu.ops.tiles": "the Pallas TPU tile picker; the Hopper kernels pick their tiles in "
                           "ops/csrc and their wrappers (ROADMAP Queue 1, 'Not to port')",
}

_ADDR = re.compile(r" at 0x[0-9a-fA-F]+")


def _sig(obj) -> str:
    try:
        return _ADDR.sub("", str(inspect.signature(obj)))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj) -> str:
    return _ADDR.sub("", (inspect.getdoc(obj) or "").strip())


def _public_members(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None or inspect.ismodule(obj):
            continue
        # only objects defined in (or re-exported by) this package
        owner = getattr(obj, "__module__", "") or ""
        if not owner.startswith("bagua_tpu_torch") and mod.__name__ != "bagua_tpu_torch":
            continue
        if inspect.isclass(obj) or inspect.isfunction(obj):
            out.append((n, obj))
    return out


def render_module(name: str) -> str:
    mod = importlib.import_module(name)
    lines = [f"# `{name}`", ""]
    if _doc(mod):
        lines += [_doc(mod), ""]
    for n, obj in _public_members(mod):
        if inspect.isclass(obj):
            lines += [f"## class `{n}{_sig(obj)}`", ""]
            if _doc(obj):
                lines += [_doc(obj), ""]
            for mn, meth in sorted(vars(obj).items()):
                if mn.startswith("_") or not callable(meth):
                    continue
                fn = meth.__func__ if isinstance(meth, (staticmethod, classmethod)) else meth
                if not (inspect.isfunction(fn) or inspect.ismethod(fn)):
                    continue
                lines += [f"### `{n}.{mn}{_sig(fn)}`", ""]
                if _doc(fn):
                    lines += [_doc(fn), ""]
        else:
            lines += [f"## `{n}{_sig(obj)}`", ""]
            if _doc(obj):
                lines += [_doc(obj), ""]
    return "\n".join(lines).rstrip() + "\n"


def pages() -> dict:
    """File name -> text of every page, the index included."""
    out = {}
    index = ["# API reference (bagua_tpu_torch)", "",
             "Generated by `scripts/torch_gen_api_docs.py` — do not edit by hand.", ""]
    for name in MODULES:
        fname = name.replace(".", "_") + ".md"
        out[fname] = render_module(name)
        index.append(f"- [`{name}`]({fname})")
    index += ["", "Not documented here (no counterpart in the port):", ""]
    index += [f"- `{name}`: {why}" for name, why in LEFT_OUT.items()]
    out["index.md"] = "\n".join(index) + "\n"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true",
                    help="verify the committed pages match (exit 1 on drift)")
    args = ap.parse_args(argv)
    want = pages()
    if args.check:
        drift = []
        for fname, text in want.items():
            path = os.path.join(OUT, fname)
            old = open(path).read() if os.path.exists(path) else None
            if old != text:
                drift.append(fname)
        extra = sorted(set(os.listdir(OUT)) - set(want)) if os.path.isdir(OUT) else []
        if drift or extra:
            print("API docs out of date for:", ", ".join(drift + extra))
            print("regenerate with: python scripts/torch_gen_api_docs.py")
            return 1
        print(f"API docs up to date ({len(MODULES)} modules)")
        return 0
    os.makedirs(OUT, exist_ok=True)
    for fname, text in want.items():
        with open(os.path.join(OUT, fname), "w") as f:
            f.write(text)
    print(f"wrote {len(MODULES)} module pages to {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
