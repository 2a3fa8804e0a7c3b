"""Finding record and the shrink-only baseline.

Port of ``bagua_tpu/analysis/findings.py``.  The port's baseline lives inside
the package (:data:`BASELINE_DEFAULT`, ``lint_baseline.json`` beside this
module), and every entry carries a ``reason``.

A finding is fingerprinted by ``(rule, path, text)`` where ``text`` is the
stripped source line — stable under unrelated edits that shift line numbers,
unlike a ``(path, line)`` key, so the committed baseline doesn't churn.
Matching is multiset-style: two identical copy-pasted violations need two
baseline entries, and fixing one shrinks the baseline by one.

The baseline is SHRINK-ONLY by construction: the CLI fails both on findings
missing from the baseline (new violations) and on baseline entries that no
longer fire (stale entries must be pruned — run ``--write-baseline``), so the
only way to grow it is to hand-edit the committed file, which review sees.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

#: the port's committed baseline (shrink-only; paths in it are relative to
#: the directory holding ``bagua_tpu_torch/``)
BASELINE_DEFAULT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "lint_baseline.json")


@dataclass(frozen=True)
class Finding:
    """One diagnostic: ``path:line: [rule] message`` plus a fix hint."""

    rule: str
    path: str       # repo-relative posix path ("<collectives>" for the log)
    line: int       # 1-based; 0 when the finding has no source anchor
    message: str
    hint: str = ""
    text: str = ""  # stripped source line at ``line`` (baseline fingerprint)

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.text)

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        out = f"{loc}: [{self.rule}] {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


def save_baseline(path: str, findings: Sequence[Finding],
                  reasons: Optional[Dict[Tuple[str, str, str], str]] = None) -> None:
    """Write ``findings`` as the baseline; each entry keeps the reason
    ``reasons`` gives its fingerprint (an entry without one says so, for
    review to fill in)."""
    reasons = reasons or {}
    entries = [
        {"rule": f.rule, "path": f.path, "text": f.text,
         "reason": reasons.get(f.key(), "TODO: why this is deferred")}
        for f in sorted(findings, key=lambda f: (f.path, f.rule, f.text))
    ]
    with open(path, "w") as fh:
        json.dump(
            {
                "comment": (
                    "bagua-lint baseline: deliberately deferred pre-existing "
                    "violations.  SHRINK-ONLY — CI fails when an entry goes "
                    "stale (fix merged: prune it with --write-baseline) and "
                    "any new finding must be fixed or suppressed inline, "
                    "never added here without review."
                ),
                "version": 1,
                "findings": entries,
            },
            fh,
            indent=2,
        )
        fh.write("\n")


def load_baseline(path: str) -> Counter:
    """Baseline as a multiset of fingerprints."""
    with open(path) as fh:
        data = json.load(fh)
    return Counter(
        (e["rule"], e["path"], e["text"]) for e in data.get("findings", [])
    )


def baseline_reasons(path: str) -> Dict[Tuple[str, str, str], str]:
    """Fingerprint -> the reason its baseline entry gives."""
    with open(path) as fh:
        data = json.load(fh)
    return {(e["rule"], e["path"], e["text"]): e.get("reason", "")
            for e in data.get("findings", [])}


def split_by_baseline(
    findings: Sequence[Finding], baseline: Counter
) -> Tuple[List[Finding], List[Finding], List[Tuple[str, str, str]]]:
    """-> (new_findings, baselined_findings, stale_baseline_keys)."""
    budget = Counter(baseline)
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        if budget[f.key()] > 0:
            budget[f.key()] -= 1
            old.append(f)
        else:
            new.append(f)
    stale = [k for k, n in budget.items() if n > 0 for _ in range(n)]
    return new, old, stale
