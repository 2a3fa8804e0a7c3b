"""Sequential model-based optimizer for the autotune search.

Counterpart of the reference's thin skopt wrapper
(the reference's bagua/service/bayesian_optimizer.py:7-79: IntParam/BoolParam/
FloatParam over a skopt ``Optimizer`` with Halton init, maximizing by telling
negated scores).  scikit-optimize is not a dependency, so the same interface
is backed by a self-contained strategy: low-discrepancy (Halton) exploration
for the first ``n_initial_points`` asks, then surrogate-guided
exploit/explore — perturb the best known point along one coordinate, with an
ε-greedy random restart.  The search spaces here are small (tens to a few
thousand discrete points), so this converges at least as fast as a GP would.

Autotune-v2 extensions (docs/autotune.md):

* ``CatParam`` — categorical coordinates (codec names, algorithm families,
  ``overlap`` on/off) alongside the int/float/bool axes.
* **Conditional (hierarchical) sampling** — ``conditions`` maps a param name
  to a predicate over the earlier coordinates; when the predicate is false
  the coordinate is INACTIVE and canonicalized to a fixed value (its
  ``low`` / ``False`` / first choice).  Two points differing only on
  inactive coordinates are therefore the SAME point: samples are never
  burned exploring chunk sizes while overlap is off, and :meth:`_perturb`
  only moves coordinates that are active at the base point.
* **Running-mean ``tell``** — repeated observations of the same
  (canonical) point fold into a running mean instead of piling up
  last-writer-wins duplicates, so one lucky sample of a noisy window
  cannot dominate :meth:`best`.
* **Warm-start priors** — :meth:`prime` queues suggested points (autopilot
  hints, historian trends) that :meth:`ask` serves before resuming its own
  schedule: a hint biases WHERE the search looks next without pinning the
  outcome.
* **Coordinate weighting** — :meth:`weight` biases which coordinate the
  exploit step perturbs (e.g. weight ``compress_inter`` up while the DCN
  share of the step is high).
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union


@dataclass(frozen=True)
class IntParam:
    name: str
    low: int
    high: int  # inclusive


@dataclass(frozen=True)
class FloatParam:
    name: str
    low: float
    high: float


@dataclass(frozen=True)
class BoolParam:
    name: str


@dataclass(frozen=True)
class CatParam:
    """Categorical coordinate: an unordered finite choice set (codec names,
    algorithm families).  ``choices`` must be hashable and non-empty; the
    first choice is the canonical value while the coordinate is inactive."""

    name: str
    choices: Tuple


Param = Union[IntParam, FloatParam, BoolParam, CatParam]

#: predicate over the (canonicalized) earlier coordinates deciding whether a
#: param is active; params are canonicalized in declaration order, so a
#: condition may only read coordinates declared BEFORE its param
Condition = Callable[[Dict], bool]


def _halton(index: int, base: int) -> float:
    f, r = 1.0, 0.0
    i = index + 1
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29]


def _inactive_value(p: Param):
    """Canonical value an inactive coordinate collapses to."""
    if isinstance(p, IntParam):
        return p.low
    if isinstance(p, FloatParam):
        return p.low
    if isinstance(p, CatParam):
        return p.choices[0]
    return False


class BayesianOptimizer:
    """tell/ask loop maximizing a noisy score over a small mixed space."""

    def __init__(
        self,
        params: List[Param],
        n_initial_points: int = 10,
        explore_prob: float = 0.25,
        seed: int = 0,
        conditions: Optional[Dict[str, Condition]] = None,
    ):
        self.params = list(params)
        self.n_initial_points = n_initial_points
        self.explore_prob = explore_prob
        self.conditions = dict(conditions or {})
        self._rng = random.Random(seed)
        # canonical point key -> [point, running mean score, n observations]
        self._observations: Dict[Tuple, List] = {}
        self._ask_count = 0
        # warm-start priors (FIFO) and exploit coordinate weights
        self._primed: List[Dict] = []
        self._coord_weights: Dict[str, float] = {}

    # -- space helpers ----------------------------------------------------

    def active(self, point: Dict) -> Dict[str, bool]:
        """Which coordinates are active at ``point`` (declaration order;
        conditions read the canonicalized prefix)."""
        out: Dict[str, bool] = {}
        prefix: Dict = {}
        for p in self.params:
            cond = self.conditions.get(p.name)
            is_active = True if cond is None else bool(cond(prefix))
            out[p.name] = is_active
            prefix[p.name] = (
                point.get(p.name, _inactive_value(p))
                if is_active else _inactive_value(p)
            )
        return out

    def _canonicalize(self, point: Dict) -> Dict:
        """Collapse inactive coordinates to their canonical values (and fill
        missing ones), in declaration order — the identity under which
        observations fold and perturbations never vary dead knobs."""
        out: Dict = {}
        for p in self.params:
            cond = self.conditions.get(p.name)
            is_active = True if cond is None else bool(cond(out))
            if not is_active:
                out[p.name] = _inactive_value(p)
            else:
                out[p.name] = point.get(p.name, _inactive_value(p))
        return out

    def _from_unit(self, u: List[float]) -> Dict:
        point = {}
        for p, x in zip(self.params, u):
            if isinstance(p, IntParam):
                point[p.name] = min(p.high, p.low + int(x * (p.high - p.low + 1)))
            elif isinstance(p, FloatParam):
                point[p.name] = p.low + x * (p.high - p.low)
            elif isinstance(p, CatParam):
                point[p.name] = p.choices[
                    min(len(p.choices) - 1, int(x * len(p.choices)))
                ]
            else:
                point[p.name] = x >= 0.5
        return self._canonicalize(point)

    def _random_point(self) -> Dict:
        return self._from_unit([self._rng.random() for _ in self.params])

    def _perturb(self, point: Dict) -> Dict:
        """Move one ACTIVE coordinate a small step — local search around the
        best.  Coordinate choice is weighted (:meth:`weight`), and inactive
        coordinates are never varied (their canonical values are restored by
        canonicalization anyway — moving them would re-sample the same
        point)."""
        out = dict(point)
        act = self.active(point)
        candidates = [p for p in self.params if act[p.name]]
        if not candidates:
            candidates = list(self.params)
        weights = [max(1e-9, self._coord_weights.get(p.name, 1.0))
                   for p in candidates]
        p = self._rng.choices(candidates, weights=weights, k=1)[0]
        if isinstance(p, IntParam):
            span = max(1, (p.high - p.low) // 8)
            out[p.name] = min(
                p.high, max(p.low, point[p.name] + self._rng.choice([-span, span]))
            )
        elif isinstance(p, FloatParam):
            span = (p.high - p.low) / 8
            v = point[p.name] + self._rng.uniform(-span, span)
            out[p.name] = min(p.high, max(p.low, v))
        elif isinstance(p, CatParam):
            others = [c for c in p.choices if c != point[p.name]]
            if others:
                out[p.name] = self._rng.choice(others)
        else:
            out[p.name] = not point[p.name]
        return self._canonicalize(out)

    def _key(self, canonical: Dict) -> Tuple:
        return tuple(canonical[p.name] for p in self.params)

    # -- priors / weighting ----------------------------------------------

    def prime(self, updates: Dict) -> None:
        """Queue a warm-start point for the next :meth:`ask`.  ``updates``
        may be partial — missing coordinates come from the best known point
        (or the canonical defaults before any observation).  A prior is a
        suggestion, not a pin: it is scored like any other sample and only
        survives if it wins."""
        base = self.best()
        point = dict(base[0]) if base is not None else {}
        point.update(updates)
        self._primed.append(self._canonicalize(point))

    def weight(self, name: str, w: float) -> None:
        """Bias the exploit step toward perturbing coordinate ``name`` by
        multiplicative weight ``w`` (1.0 = neutral)."""
        if any(p.name == name for p in self.params):
            self._coord_weights[name] = float(w)

    # -- tell/ask ---------------------------------------------------------

    def tell(self, point: Dict, score: float) -> None:
        if not (isinstance(score, (int, float)) and math.isfinite(score)):
            return
        canonical = self._canonicalize(point)
        key = self._key(canonical)
        obs = self._observations.get(key)
        if obs is None:
            self._observations[key] = [canonical, float(score), 1]
        else:
            # fold into a running mean: noisy windows of the same config
            # average out instead of the single luckiest one winning best()
            obs[2] += 1
            obs[1] += (float(score) - obs[1]) / obs[2]

    def best(self) -> Optional[Tuple[Dict, float]]:
        if not self._observations:
            return None
        point, mean, _ = max(self._observations.values(), key=lambda o: o[1])
        return dict(point), mean

    def ask(self) -> Dict:
        if self._primed:
            return self._primed.pop(0)
        self._ask_count += 1
        if self._ask_count <= self.n_initial_points or not self._observations:
            u = [
                _halton(self._ask_count - 1, _PRIMES[i % len(_PRIMES)])
                for i in range(len(self.params))
            ]
            return self._from_unit(u)
        if self._rng.random() < self.explore_prob:
            return self._random_point()
        best_point, _ = self.best()
        return self._perturb(best_point)
