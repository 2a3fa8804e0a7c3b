"""Declarative, capability-gated knob space for autotune v2.

The legacy search optimized ``bucket_size × is_hierarchical_reduce``
on raw step time.  This module widens the space to every runtime knob the
trainer can actually flip at a check-in — overlap + per-tier chunk bytes,
the per-link codec ladder (incl. the stateful 1-bit/top-k rungs), the
flat-resident layout, and algorithm-family switching — and gates each knob
on the TASK's capabilities, which the trainer reports once at tensor
registration (mesh shape, error-feedback availability, flat-layout safety,
legal switch targets).  A knob the trainer would refuse is simply never in
the space, so no sample is burned discovering a refusal.

Point-dependent legality rides the optimizer's conditional sampling
(:mod:`.bayesian_optimizer`): chunk-byte knobs are inactive while
``overlap == "off"``, the DCN-tier knobs while the mesh has one tier, the
flat-resident knob while the sampled family cannot hold flat state.
Inactive coordinates collapse to canonical values, so the optimizer never
emits two points that differ only on a dead knob.

See docs/autotune.md for the full knob table and gating rules.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .bayesian_optimizer import (
    BoolParam,
    CatParam,
    Condition,
    IntParam,
    Param,
)

# bucket_size = 2**p; mirrors the reference's 10..31 exponent range
MIN_BUCKET_SIZE_EXP = 10
MAX_BUCKET_SIZE_EXP = 31

# per-tier ring chunk target = 2**p bytes; 64 KiB .. 64 MiB covers the
# useful range on both link classes (docs/hierarchical.md)
MIN_CHUNK_BYTES_EXP = 16
MAX_CHUNK_BYTES_EXP = 26

#: codec rungs per tier knob.  "auto" defers to the algorithm family's own
#: wire codec (the constructor default), "off" forces full precision; the
#: stateful error-feedback rungs are appended only when the task's mesh can
#: carry the per-bucket residual (``ef_ok``).
BASE_CODEC_CHOICES = ("auto", "off", "minmax_uint8", "fp8_e4m3")
EF_CODEC_CHOICES = ("onebit_ef", "topk")


def evaluate_active(
    params: List[Param], conditions: Dict[str, Condition], point: Dict
) -> Dict[str, bool]:
    """Which coordinates of ``point`` are active (mirror of
    ``BayesianOptimizer.active`` for callers that hold only the space)."""
    from .bayesian_optimizer import _inactive_value

    out: Dict[str, bool] = {}
    prefix: Dict = {}
    for p in params:
        cond = conditions.get(p.name)
        is_active = True if cond is None else bool(cond(prefix))
        out[p.name] = is_active
        prefix[p.name] = (
            point.get(p.name, _inactive_value(p))
            if is_active else _inactive_value(p)
        )
    return out


@dataclass
class KnobSpace:
    """A built search space plus the point<->hyperparameter translation.

    ``params``/``conditions`` feed the optimizer; :meth:`point_to_updates`
    renders an asked point as ``BaguaHyperparameter`` field updates (the
    wire schema the trainer already consumes), and :meth:`point_from_hp`
    inverts a reported hyperparameter set back into a point so the
    optimizer can be told the score of what actually ran.
    """

    params: List[Param]
    conditions: Dict[str, Condition]
    capabilities: Dict = field(default_factory=dict)

    def names(self) -> List[str]:
        return [p.name for p in self.params]

    def has(self, name: str) -> bool:
        return any(p.name == name for p in self.params)

    def active(self, point: Dict) -> Dict[str, bool]:
        return evaluate_active(self.params, self.conditions, point)

    # -- point -> BaguaHyperparameter field updates -----------------------

    def point_to_updates(self, point: Dict) -> Dict:
        """Field updates for ``BaguaHyperparameter.update()``.  Inactive
        knobs emit their keep-current sentinel (0 / "") — the trainer
        leaves the live value untouched, and the step-cache key zeroes
        them anyway (chunk bytes while overlap is off)."""
        act = self.active(point)
        updates: Dict = {}
        if "bucket_size_2p" in point:
            updates["bucket_size"] = 2 ** int(point["bucket_size_2p"])
        if self.has("is_hierarchical_reduce"):
            updates["is_hierarchical_reduce"] = bool(
                point.get("is_hierarchical_reduce", False)
            )
        if self.has("algorithm"):
            updates["algorithm"] = str(point.get("algorithm", ""))
        if self.has("overlap"):
            updates["overlap"] = str(point.get("overlap", "off"))
        for knob, fld in (
            ("overlap_chunk_bytes_intra_2p", "overlap_chunk_bytes_intra"),
            ("overlap_chunk_bytes_inter_2p", "overlap_chunk_bytes_inter"),
        ):
            if self.has(knob):
                updates[fld] = (
                    2 ** int(point[knob]) if act.get(knob) else 0
                )
        for knob in ("compress_intra", "compress_inter"):
            if self.has(knob):
                updates[knob] = (
                    str(point.get(knob, "auto")) if act.get(knob) else ""
                )
        if self.has("flat_resident"):
            updates["flat_resident"] = (
                str(point.get("flat_resident", "off"))
                if act.get("flat_resident") else ""
            )
        return updates

    # -- BaguaHyperparameter -> point -------------------------------------

    def point_from_hp(self, hp) -> Dict:
        """Reconstruct the search point that produced ``hp`` (the reported
        hyperparameters of the window being scored).  Unknown / keep-current
        values fall back to canonical defaults; the optimizer canonicalizes
        the result, so inactive coordinates collapse regardless."""
        point: Dict = {}
        for p in self.params:
            name = p.name
            if name == "bucket_size_2p":
                exp = max(1, int(getattr(hp, "bucket_size", 0) or 1)).bit_length() - 1
                point[name] = max(MIN_BUCKET_SIZE_EXP,
                                  min(MAX_BUCKET_SIZE_EXP, exp))
            elif name == "is_hierarchical_reduce":
                point[name] = bool(getattr(hp, "is_hierarchical_reduce", False))
            elif name == "algorithm":
                v = getattr(hp, "algorithm", "") or \
                    self.capabilities.get("current_algorithm", "")
                point[name] = v if v in p.choices else p.choices[0]
            elif name == "overlap":
                v = getattr(hp, "overlap", "")
                point[name] = v if v in p.choices else "off"
            elif name in ("overlap_chunk_bytes_intra_2p",
                          "overlap_chunk_bytes_inter_2p"):
                fld = name[: -len("_2p")]
                b = int(getattr(hp, fld, 0) or 0)
                exp = b.bit_length() - 1 if b > 0 else MIN_CHUNK_BYTES_EXP
                point[name] = max(MIN_CHUNK_BYTES_EXP,
                                  min(MAX_CHUNK_BYTES_EXP, exp))
            elif name in ("compress_intra", "compress_inter"):
                v = getattr(hp, name, "")
                point[name] = v if v in p.choices else "auto"
            elif name == "flat_resident":
                v = getattr(hp, name, "")
                point[name] = v if v in p.choices else "off"
        return point


def build_knob_space(
    capabilities: Optional[Dict],
    tune_algorithm: bool = False,
) -> Optional[KnobSpace]:
    """Build the v2 space from a task's check-in capabilities, or return
    ``None`` for the legacy two-knob space (no capabilities reported —
    an old trainer, or ``BAGUA_AUTOTUNE_SPACE=legacy``).

    Capability keys (all optional, conservative defaults):

    * ``two_tier`` — both tier communicators exist; unlocks
      ``is_hierarchical_reduce``, the DCN chunk knob, ``compress_inter``.
    * ``ef_ok`` — the mesh/trainer can hold the per-bucket error-feedback
      residual; unlocks the ``onebit_ef``/``topk`` codec rungs.
    * ``flat_ok`` — live flat<->leaf relayout is safe for the current
      optimizer/algorithm; unlocks the ``flat_resident`` knob.
    * ``families`` — legal algorithm switch targets (incl. the current
      family); with ``tune_algorithm`` and >1 entries, unlocks the
      ``algorithm`` categorical.
    * ``flat_families`` — the subset of ``families`` that can hold flat
      state; the flat knob is conditionally inactive outside it.
    * ``current_algorithm`` — fallback for hyperparameter inversion.
    """
    if not capabilities or capabilities.get("space") != "v2":
        return None

    two_tier = bool(capabilities.get("two_tier", False))
    ef_ok = bool(capabilities.get("ef_ok", False))
    flat_ok = bool(capabilities.get("flat_ok", False))
    families = [str(f) for f in capabilities.get("families") or []]
    flat_families = [str(f) for f in capabilities.get("flat_families") or []]
    current = str(capabilities.get("current_algorithm", "") or "")
    if current and current not in families:
        families = [current] + families

    codec_choices = BASE_CODEC_CHOICES + (EF_CODEC_CHOICES if ef_ok else ())

    params: List[Param] = []
    conditions: Dict[str, Condition] = {}

    # declaration order matters: conditions read earlier coordinates only
    if tune_algorithm and len(families) > 1:
        params.append(CatParam("algorithm", tuple(families)))
    params.append(IntParam("bucket_size_2p",
                           MIN_BUCKET_SIZE_EXP, MAX_BUCKET_SIZE_EXP))
    if two_tier:
        params.append(BoolParam("is_hierarchical_reduce"))
    params.append(CatParam("overlap", ("off", "on")))
    params.append(IntParam("overlap_chunk_bytes_intra_2p",
                           MIN_CHUNK_BYTES_EXP, MAX_CHUNK_BYTES_EXP))
    conditions["overlap_chunk_bytes_intra_2p"] = (
        lambda pt: pt.get("overlap") == "on"
    )
    if two_tier:
        params.append(IntParam("overlap_chunk_bytes_inter_2p",
                               MIN_CHUNK_BYTES_EXP, MAX_CHUNK_BYTES_EXP))
        conditions["overlap_chunk_bytes_inter_2p"] = (
            lambda pt: pt.get("overlap") == "on"
            and pt.get("is_hierarchical_reduce", False)
        )
    params.append(CatParam("compress_intra", codec_choices))
    if two_tier:
        # with the two-level decomposition off, the flat comm world spans
        # both mesh axes and the compressed ring disengages (LOUDLY — see
        # AlgorithmContext.flat_ring_codec), so BOTH tier codecs are dead
        # knobs; the DCN tier itself only exists under hierarchical reduce
        conditions["compress_intra"] = (
            lambda pt: pt.get("is_hierarchical_reduce", False)
        )
        params.append(CatParam("compress_inter", codec_choices))
        conditions["compress_inter"] = (
            lambda pt: pt.get("is_hierarchical_reduce", False)
        )
    if flat_ok:
        params.append(CatParam("flat_resident", ("off", "on")))
        if tune_algorithm and len(families) > 1 and flat_families:
            conditions["flat_resident"] = (
                lambda pt: pt.get("algorithm") in flat_families
            )
    return KnobSpace(params=params, conditions=conditions,
                     capabilities=dict(capabilities))
