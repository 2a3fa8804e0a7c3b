"""``bagua-lint`` over the port: ``python -m bagua_tpu_torch.analysis [paths]``.

Port of ``bagua_tpu/analysis/cli.py``.  Runs the selected engines
(``--engine ast,collectives,concurrency,trace``, default all) over the given
paths (default: the port's package), compares against the shrink-only
baseline (default the package's ``lint_baseline.json``), and exits non-zero
on any unsuppressed, unbaselined finding or any stale baseline entry:

* ``ast``: per-module hot-path hygiene rules;
* ``collectives``: the collective-sequence sweep over the algorithm
  families, on four CPU gloo ranks in one spawn;
* ``concurrency``: the whole-program host-concurrency race detector;
* ``trace``: the step-key coherence prover.

``--witness FILE`` also cross-checks a runtime lockdep witness (from a
``BAGUA_LOCKDEP=on`` run) against the static acquisition graph.  Finding
paths are relative to the directory holding the linted package, so the
baseline matches from any working directory.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import Counter
from typing import List, Optional

from .ast_rules import RULES, run_ast_rules
from .findings import (
    BASELINE_DEFAULT,
    Finding,
    baseline_reasons,
    load_baseline,
    save_baseline,
    split_by_baseline,
)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)

_ENGINES = ("ast", "collectives", "concurrency", "trace")


def _parse_engines(spec: str) -> List[str]:
    names = [e.strip() for e in spec.split(",") if e.strip()]
    if "all" in names:
        return list(_ENGINES)
    bad = [e for e in names if e not in _ENGINES]
    if bad:
        raise SystemExit(
            f"bagua-lint: unknown engine(s) {', '.join(bad)} "
            f"(choose from {', '.join(_ENGINES)}, or 'all')")
    return names


def _rel_to(paths: List[str]) -> str:
    """The package's parent when every path lies under it (the baseline's
    frame), else the working directory."""
    root = os.path.abspath(_ROOT)
    inside = all(os.path.abspath(p) == root or
                 os.path.abspath(p).startswith(root + os.sep) for p in paths)
    return root if inside else os.getcwd()


def _list_rules() -> None:
    from .concurrency import CONCURRENCY_RULES
    from .lockdep import LOCKDEP_RULES
    from .suppressions import JAX_RULE_COUNTERPARTS, NO_COUNTERPART
    from .trace_coherence import TRACE_RULES

    for title, rules in (("ast", RULES), ("concurrency", CONCURRENCY_RULES),
                         ("trace", TRACE_RULES), ("lockdep witness", LOCKDEP_RULES)):
        print(f"-- {title} --")
        for r in rules:
            print(f"{r.id}: {r.summary}")
            print(f"    why:  {r.rationale}")
            print(f"    hint: {r.hint}")
    print("-- collectives --")
    print("rank-collective-divergence: ranks issue different collective sequences "
          "over one group of axes (collective log)")
    print("unbound-mesh-axis: a collective runs over axes not bound on the trainer's "
          "mesh (collective log)")
    print("overlap-serialized-divergence: the overlap and serialized steps issue "
          "different collective multisets (collective log)")
    print("-- the JAX package's rules --")
    for jax_id, port_id in JAX_RULE_COUNTERPARTS.items():
        print(f"{jax_id} -> {port_id or 'no counterpart: ' + NO_COUNTERPART[jax_id]}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        "python -m bagua_tpu_torch.analysis",
        description="bagua-lint over the port: collective-log checker, AST "
                    "hot-path analyzer, concurrency and step-key engines")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to lint (default: bagua_tpu_torch/)")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: the package's lint_baseline.json)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline with the current findings, keeping "
                         "the reasons of entries that stay")
    ap.add_argument("--engine", default="all",
                    help=f"comma-separated engines: {','.join(_ENGINES)} or 'all'")
    ap.add_argument("--witness", default=None, metavar="FILE",
                    help="runtime lockdep witness JSON (from a BAGUA_LOCKDEP=on run) "
                         "to cross-check against the static lock graph")
    ap.add_argument("--families", default=None,
                    help="comma-separated families for the collective sweep; "
                         "':hier' runs the two-level form, ':hier-<codec>' forces the "
                         "inter-node codec (default: the JAX checker's eleven)")
    ap.add_argument("--accum-steps", default=None,
                    help="comma-separated accum_steps for the sweep (default: 1,4)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and the JAX rules' counterparts")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="findings only, no per-configuration or per-engine lines")
    args = ap.parse_args(argv)

    if args.list_rules:
        _list_rules()
        return 0

    engines = _parse_engines(args.engine)
    paths = args.paths or [_PKG]
    rel_to = _rel_to(paths)
    findings: List[Finding] = []
    t_start = time.monotonic()

    def note(engine: str, t0: float, n: int) -> None:
        if not args.quiet:
            print(f"bagua-lint[{engine}]: {n} finding(s) in {time.monotonic() - t0:.2f} s")

    if "ast" in engines:
        t0 = time.monotonic()
        got = run_ast_rules(paths, rel_to=rel_to)
        findings.extend(got)
        note("ast", t0, len(got))

    program = None
    if "concurrency" in engines or "trace" in engines or args.witness:
        from .concurrency import build_program

        program = build_program(paths, rel_to=rel_to)

    if "concurrency" in engines:
        from .concurrency import run_concurrency_rules

        t0 = time.monotonic()
        got = run_concurrency_rules(program=program)
        findings.extend(got)
        note("concurrency", t0, len(got))

    if "trace" in engines:
        from .trace_coherence import run_trace_coherence

        t0 = time.monotonic()
        got = run_trace_coherence(program=program)
        findings.extend(got)
        note("trace", t0, len(got))

    if args.witness:
        from .concurrency import static_lock_graph
        from .lockdep import cross_check, load_witness

        findings.extend(cross_check(load_witness(args.witness), static_lock_graph(program)))

    if "collectives" in engines:
        from .collective_check import (
            DEFAULT_ACCUM_STEPS,
            DEFAULT_FAMILIES,
            run_collective_checks,
        )

        families = (tuple(f for f in args.families.split(",") if f)
                    if args.families else DEFAULT_FAMILIES)
        accum = (tuple(int(a) for a in args.accum_steps.split(",") if a)
                 if args.accum_steps else DEFAULT_ACCUM_STEPS)
        t0 = time.monotonic()
        got, reports = run_collective_checks(families, accum)
        findings.extend(got)
        if not args.quiet:
            for rep in reports:
                status = "OK " if rep.get("equal") else "FAIL"
                ser, ovl = rep["serialized"], rep["overlap"]
                plan = len(ovl["plan_collectives"]) + len(ser["plan_collectives"])
                print(f"collectives[{status}] {rep['family']} accum={rep['accum_steps']}: "
                      f"{len(ser['collectives'])} collectives, wire bytes serialized="
                      f"{ser['total_wire_bytes']} overlap={ovl['total_wire_bytes']}"
                      + (f", {plan} plan upkeep" if plan else ""))
                for row in ser["buckets"]:
                    print(f"    bucket {row['bucket']}: flat {row['flat_bytes']} B -> "
                          f"{row['wire_bytes']} B on the wire across "
                          f"{len(row['collectives'])} collectives")
        note("collectives", t0, len(got))

    baseline_path = args.baseline
    if baseline_path is None and os.path.exists(BASELINE_DEFAULT):
        baseline_path = BASELINE_DEFAULT

    if args.write_baseline:
        out = baseline_path or BASELINE_DEFAULT
        reasons = baseline_reasons(out) if os.path.exists(out) else {}
        save_baseline(out, findings, reasons)
        print(f"wrote {len(findings)} baseline entries to {out}")
        return 0

    stale: List = []
    baselined: List[Finding] = []
    if baseline_path:
        new, baselined, stale = split_by_baseline(findings, load_baseline(baseline_path))
    else:
        new = findings

    for f in new:
        print(f.render())
    by_rule = Counter(f.rule for f in findings)
    print(f"bagua-lint: {len(new)} finding(s)"
          + (f", {len(baselined)} baselined" if baselined else "")
          + (f", {len(stale)} STALE baseline entr(y/ies)" if stale else "")
          + f"; by rule {dict(sorted(by_rule.items()))}"
          + f"; {time.monotonic() - t_start:.2f} s")
    if stale:
        for k in stale:
            print(f"  stale baseline entry (violation fixed: prune it): {k}")
        print(f"  shrink the baseline: python -m bagua_tpu_torch.analysis "
              f"--write-baseline --baseline {baseline_path}")
    return 1 if (new or stale) else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
