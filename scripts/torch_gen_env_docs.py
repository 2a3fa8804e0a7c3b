#!/usr/bin/env python
"""Generate docs/torch/env_vars.md and docs/torch/metrics.md from the port's
registries.

Counterpart of ``scripts/gen_env_docs.py``: both tables are emitted straight
from the declarations the port reads, ``bagua_tpu_torch.env.ENV_REGISTRY``
(``env.render_env_vars_md``) and
``bagua_tpu_torch.obs.export.METRIC_REGISTRY`` (``render_metrics_md``), so
the references cannot drift from the code.  The port's lint closes each
loop (``raw-env-read``, ``unregistered-counter``).

Usage: python scripts/torch_gen_env_docs.py [--check]
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "docs", "torch")


def targets():
    from bagua_tpu_torch.env import render_env_vars_md
    from bagua_tpu_torch.obs.export import render_metrics_md

    return [(os.path.join(OUT, "env_vars.md"), render_env_vars_md()),
            (os.path.join(OUT, "metrics.md"), render_metrics_md())]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true",
                    help="verify the committed tables match (exit 1 on drift)")
    args = ap.parse_args(argv)
    if args.check:
        stale = [os.path.relpath(out, REPO) for out, text in targets()
                 if not os.path.exists(out) or open(out).read() != text]
        if stale:
            print(f"{', '.join(stale)} out of date; regenerate with: "
                  "python scripts/torch_gen_env_docs.py")
            return 1
        print("docs/torch/env_vars.md + docs/torch/metrics.md up to date")
        return 0
    os.makedirs(OUT, exist_ok=True)
    for out, text in targets():
        with open(out, "w") as f:
            f.write(text)
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
