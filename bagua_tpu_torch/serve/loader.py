"""Integrity-verified model loads for the serving plane.

Port of ``bagua_tpu/serve/loader.py``.  A serving replica must never decode
with silently corrupted weights, so every load rides the checkpoint
integrity chain (:class:`bagua_tpu_torch.checkpoint.BaguaCheckpointManager`):
the sha256 digest recorded at save time is verified on restore, a torn
sidecar or a digest mismatch disqualifies that step with a loud warning,
and (when no explicit step was requested) the load falls back newest-first
to the last step that verifies, counted in ``ckpt/fallback_restores``.

An artifact is bucket-flat: :func:`save_serving_artifact` flattens the
parameters under a :class:`~bagua_tpu_torch.bucket.BucketPlan` and records
the plan's descriptor in the layout sidecar, so that
:func:`load_serving_params` rebuilds the plan from the sidecar alone (no
trainer), restores the flats digest-verified, and hands back the
parameters by name.  On disk a step is the manager's ``<dir>/<step>/
rank0.pt`` and ``manifest.json`` with ``<dir>/<step>.layout.json``.  A
leaf-layout checkpoint of the same names restores directly.

The load is spanned as ``serve/weight_load``, which the goodput ledger
books under the serving ``weight_load`` class.
"""

from __future__ import annotations

import logging
from typing import Dict, Mapping, Optional, Tuple, Union

import torch

from ..bucket import BucketPlan
from ..checkpoint import BaguaCheckpointManager
from ..obs.spans import trace_span
from ..telemetry import counters
from ..tensor import NamedParam

logger = logging.getLogger(__name__)

__all__ = ["save_serving_artifact", "load_serving_params"]

Params = Union[torch.nn.Module, Mapping[str, torch.Tensor]]


def _named(params: Params) -> Dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def save_serving_artifact(directory: str, params: Params, step: int = 0,
                          bucket_bytes: Optional[int] = None) -> None:
    """Publish ``params`` (a module, or tensors by name such as
    ``trainer.unstack_params(state)``) as a serving artifact: bucket-flat
    buffers plus the layout sidecar (bucket descriptor, content digest)
    under ``directory``, at ``step``."""
    from .. import env as _env

    named = {n: t.detach() for n, t in _named(params).items()}
    decls = [NamedParam(n, tuple(t.shape), t.dtype) for n, t in named.items()]
    decls.reverse()   # the backward's order, as build_params lists them
    plan = BucketPlan.build(decls, bucket_bytes or _env.get_default_bucket_size(),
                            alignment=1)
    flats = plan.flatten(named)
    mgr = BaguaCheckpointManager(directory, async_save=False)
    try:
        meta = {
            "layout": "flat",
            "plan_dependent": True,
            "serving_artifact": True,
            "flat_layout": plan.layout_descriptor(),
        }
        mgr.save(int(step), {"flats": tuple(flats)}, metadata=meta)
    finally:
        mgr.close()


def _restore_one(mgr: BaguaCheckpointManager, step: int,
                 like: Dict[str, torch.Tensor]):
    """``(step, finish)`` of one step in the serving (by-name) layout,
    converting through the sidecar when the step is bucket-flat.  Raises
    ``CheckpointIntegrityError`` for corruption (the newest-first walk then
    falls back) and ``ValueError`` for an artifact of another model."""
    sidecar = mgr.read_layout(step)   # a torn sidecar: integrity error
    if not (sidecar and "flat_layout" in sidecar):
        return mgr._restore_step(step, like, None)
    plan = BucketPlan.from_layout_descriptor(sidecar["flat_layout"])
    shapes = {t.name: tuple(t.shape) for b in plan.buckets for t in b.tensors}
    missing = sorted(set(like) - set(shapes))
    if missing:
        raise ValueError(
            "serving artifact does not cover the model's params "
            f"(missing {missing[:3]}{'…' if len(missing) > 3 else ''}) — wrong "
            "checkpoint for this model config?")
    mismatched = sorted(n for n in like if tuple(like[n].shape) != shapes[n])
    if mismatched:
        raise ValueError(
            "serving artifact param shapes do not match the model "
            f"({mismatched[:3]}{'…' if len(mismatched) > 3 else ''})")
    device = next(iter(like.values())).device
    flats_like = {"flats": tuple(torch.empty(b.padded_numel, dtype=b.dtype, device=device)
                                 for b in plan.buckets)}
    # the expectation IS the sidecar's own constraint set (the flat shapes
    # come from its descriptor); a genuine mismatch still raises
    expect = {k: v for k, v in sidecar.items() if k not in ("flat_layout", "integrity")}
    got, finish = mgr._restore_step(step, flats_like, expect)

    def done():
        named = plan.unflatten(finish()["flats"])
        return {n: named[n] for n in like}

    return got, done


def load_serving_params(directory: str, params_like: Params,
                        step: Optional[int] = None) -> Tuple[int, Dict[str, torch.Tensor]]:
    """Load serving params from ``directory`` with digest verification and
    newest-first integrity fallback: ``(step, tensors by name)``.

    ``params_like`` (a module or tensors by name) gives the names, shapes
    and the device of the result.  An explicit ``step`` never falls back: a
    failed verification raises ``CheckpointIntegrityError``.
    """
    from ..obs import ledger as obs_ledger
    from ..obs import spans as obs_spans

    if obs_spans.enabled():
        # the load may be the process's FIRST serving act: hook the ledger
        # sink up before the span opens so weight_load is booked
        obs_ledger.install()
    like = {n: t.detach() for n, t in _named(params_like).items()}
    with trace_span("serve/weight_load", directory=str(directory)):
        mgr = BaguaCheckpointManager(directory, async_save=False)
        try:
            def one(s):
                return _restore_one(mgr, s, like)

            if step is not None:
                got, finish = mgr._restore_explicit(int(step), one)
            else:
                got, finish = mgr._restore_newest_verified(one)
            result = (got, finish())
        finally:
            mgr.close()
    counters.incr("serve/weight_loads")
    logger.info("serving params loaded from %s at step %d", directory, result[0])
    return result
