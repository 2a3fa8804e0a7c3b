"""Interleaved A/B best-of-trials timing protocol.

Port of ``benchmarks/_ab.py`` (the port imports nothing of ``benchmarks/``,
which imports the JAX package): the protocol the paired measurements and
the bench-trend sentinel (:mod:`.regress`) share.  It exists because single
short windows of a small model on a shared host absorb enough one-off
interference to flip a comparison:

* trials are INTERLEAVED (a, b, a, b, ...) so each pair runs under the
  same background load — back-to-back blocks drift apart;
* the reported speedup is the MEDIAN per-trial ratio (robust to the 2-5x
  one-off stalls shared hosts produce), with the full per-trial spread
  recorded so a noise-bound comparison reads as one instead of as a
  result;
* each side's best trial is kept as the honest "what the machine does"
  throughput figure.

Import-light (numpy only).
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np

__all__ = ["interleaved_ab", "speedup_record"]


def interleaved_ab(
    measure_a: Callable[[], dict],
    measure_b: Callable[[], dict],
    trials: int = 5,
) -> Tuple[dict, dict, List[float]]:
    """Run two measurement callables interleaved ``trials`` times.

    Each callable returns a record with a ``"value"`` throughput field.
    Returns ``(best_a, best_b, ratios)`` where ``ratios[i]`` is trial i's
    ``b/a`` and ``best_*`` is each side's highest-throughput record with
    its ``timing`` field relabeled to name this protocol.
    """
    ratios: List[float] = []
    best_a = best_b = None
    for _ in range(max(1, trials)):
        a = measure_a()
        b = measure_b()
        ratios.append(round(b["value"] / a["value"], 3))
        best_a = a if best_a is None or a["value"] > best_a["value"] else best_a
        best_b = b if best_b is None or b["value"] > best_b["value"] else best_b
    for rec in (best_a, best_b):
        if "timing" in rec and "interleaved_ab" not in rec["timing"]:
            rec["timing"] = (
                f"best_of_{trials}_interleaved_ab_trials_"
                + rec["timing"].split("best_of_", 1)[-1].split("trials_")[-1]
            )
    return best_a, best_b, ratios


def speedup_record(metric: str, ratios: List[float], unit_label: str,
                   **extra) -> dict:
    """The paired summary record: median ratio + spread + noise flag."""
    median = float(np.median(ratios))
    return {
        "metric": metric,
        "value": round(median, 3),
        "unit": f"x ({unit_label}, median of interleaved trials)",
        "per_trial_ratios": ratios,
        "noise_bound": bool(max(ratios) >= 1.0 >= min(ratios)),
        **extra,
    }
