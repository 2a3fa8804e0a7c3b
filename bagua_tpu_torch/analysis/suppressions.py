"""``# bagua: lint-ignore[rule-id] -- reason`` suppression comments.

Port of ``bagua_tpu/analysis/suppressions.py``, with the same syntax, over
the port's rule ids; :data:`JAX_RULE_COUNTERPARTS` maps every rule id of the
JAX package's engines to its port counterpart, or to ``None`` with the
reason it has none (:data:`NO_COUNTERPART`).

A trailing suppression covers its own line; a standalone suppression comment
covers the next non-blank, non-comment source line (so long flagged lines can
keep the suppression above them).  Multiple rule ids are comma-separated;
``*`` suppresses every rule.  The ``-- reason`` is required: an unexplained
suppression is itself reported (rule ``bad-suppression``) so "shut it up"
can't happen silently.
"""

from __future__ import annotations

import io
import re
import tokenize
from typing import Dict, FrozenSet, List, Optional, Tuple

from .findings import Finding

_SUPPRESS_RE = re.compile(
    r"#\s*bagua:\s*lint-ignore\[([^\]]*)\]\s*(?:--\s*(\S.*))?"
)

#: every rule id any engine can emit (AST, collective log, concurrency,
#: trace coherence, lockdep witness) plus the ``*`` wildcard.  A suppression
#: naming anything else is dead weight (usually a typo'd or renamed rule
#: silently suppressing nothing) and is reported as ``bad-suppression``.
#: Kept as a literal so this module stays dependency-free;
#: ``tests/test_torch_analysis.py`` asserts it equals the union of the
#: engine catalogs.
KNOWN_RULE_IDS: FrozenSet[str] = frozenset({
    "*",
    # ast_rules
    "host-sync-in-step", "raw-env-read", "py-rng-in-step",
    "dup-lambda", "per-step-reflatten", "unregistered-counter",
    "jax-import",
    # collective_check
    "rank-collective-divergence", "unbound-mesh-axis",
    "overlap-serialized-divergence",
    # concurrency
    "lock-order-inversion", "unguarded-shared-write", "lock-held-io",
    "signal-unsafe-lock", "non-reentrant-reacquire",
    # trace_coherence
    "trace-knob-not-keyed", "bad-trace-invariant",
    # lockdep
    "lockdep-runtime-inversion", "lockdep-unmodeled-edge",
    # the suppression machinery's own rule
    "bad-suppression",
})

#: every rule id of the JAX package's engines -> the port's counterpart, or
#: None where eager torch has nothing for the rule to look at
JAX_RULE_COUNTERPARTS: Dict[str, Optional[str]] = {
    "host-sync-in-trace": "host-sync-in-step",
    "raw-env-read": "raw-env-read",
    "tracer-leak": None,
    "py-rng-in-trace": "py-rng-in-step",
    "dup-lambda": "dup-lambda",
    "per-step-reflatten": "per-step-reflatten",
    "unregistered-counter": "unregistered-counter",
    "torch-import": "jax-import",
    "cond-collective-divergence": "rank-collective-divergence",
    "unbound-mesh-axis": "unbound-mesh-axis",
    "overlap-serialized-divergence": "overlap-serialized-divergence",
    "lock-order-inversion": "lock-order-inversion",
    "unguarded-shared-write": "unguarded-shared-write",
    "lock-held-io": "lock-held-io",
    "signal-unsafe-lock": "signal-unsafe-lock",
    "non-reentrant-reacquire": "non-reentrant-reacquire",
    "trace-knob-not-keyed": "trace-knob-not-keyed",
    "bad-trace-invariant": "bad-trace-invariant",
    "lockdep-runtime-inversion": "lockdep-runtime-inversion",
    "lockdep-unmodeled-edge": "lockdep-unmodeled-edge",
    "bad-suppression": "bad-suppression",
}

#: why a JAX rule has no port counterpart
NO_COUNTERPART: Dict[str, str] = {
    "tracer-leak": (
        "eager torch has no tracers: a value stored on `self` during a step "
        "is a real tensor that outlives the step as any attribute does, so "
        "there is no trace for it to leak out of"),
}


def parse_suppressions(
    path: str, source: str
) -> Tuple[Dict[int, FrozenSet[str]], List[Finding]]:
    """-> ({line: suppressed rule ids}, malformed-suppression findings)."""
    by_line: Dict[int, set] = {}
    problems: List[Finding] = []
    pending: List[Tuple[int, set]] = []  # standalone comments awaiting code

    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        return {}, []

    for tok in tokens:
        if tok.type in (tokenize.NL, tokenize.NEWLINE, tokenize.INDENT,
                        tokenize.DEDENT, tokenize.ENCODING,
                        tokenize.ENDMARKER):
            continue
        row = tok.start[0]
        if tok.type == tokenize.COMMENT:
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            reason = (m.group(2) or "").strip()
            if not rules or not reason:
                problems.append(Finding(
                    rule="bad-suppression",
                    path=path,
                    line=row,
                    message=(
                        "malformed lint-ignore: need at least one rule id "
                        "and a `-- reason`"
                    ),
                    hint="write `# bagua: lint-ignore[rule-id] -- why`",
                    text=tok.line.strip(),
                ))
                continue
            unknown = rules - KNOWN_RULE_IDS
            if unknown:
                problems.append(Finding(
                    rule="bad-suppression",
                    path=path,
                    line=row,
                    message=(
                        "lint-ignore names unknown rule id(s) "
                        f"{', '.join(sorted(unknown))}: the suppression "
                        "suppresses nothing"
                    ),
                    hint="use ids from `python -m bagua_tpu_torch.analysis "
                         "--list-rules` (or `*`)",
                    text=tok.line.strip(),
                ))
                rules -= unknown
                if not rules:
                    continue
            if tok.line[: tok.start[1]].strip():
                # trailing comment: covers its own line
                by_line.setdefault(row, set()).update(rules)
            else:
                # standalone: covers the next source line
                pending.append((row, rules))
        else:
            # first real token on a line consumes pending suppressions
            for _, rules in pending:
                by_line.setdefault(row, set()).update(rules)
            pending = []

    return {k: frozenset(v) for k, v in by_line.items()}, problems


def is_suppressed(
    finding: Finding, suppressions: Dict[int, FrozenSet[str]]
) -> bool:
    rules = suppressions.get(finding.line)
    return bool(rules) and (finding.rule in rules or "*" in rules)
