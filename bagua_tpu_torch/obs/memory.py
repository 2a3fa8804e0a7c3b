"""Device memory accounting: does the bucket-flat layout fit the card?

Port of ``bagua_tpu/obs/memory.py``.  Two views, cheapest first:

* **static footprint** (:func:`static_footprint`) — the resident training
  state's bytes from host metadata alone: the live ``TrainState`` tensors
  (the module's parameters, the optimizer's state, the algorithm's state;
  each storage counted once, so the parameter views of the resident flats
  count as their flats) plus the transient per-bucket gradient flats the
  step materializes (:func:`plan_flat_bytes` over the ``BucketPlan``).
  Exact over the trainer's flats.
* **live peaks** (:func:`live_memory_stats`) — ``torch.cuda.memory_stats()``
  and ``torch.cuda.mem_get_info()`` polled off the hot path (the trainer's
  ~2 s beacon cadence): bytes in use, the allocator's peak, the card's
  memory and the headroom.  On the CPU the record is null-with-rationale.

The JAX package's third view, XLA's ``compile().memory_analysis()`` of
each compiled step, has no counterpart: eager torch compiles no executable
(the footprint record's ``compiled_memory_analysis`` is null, with
:data:`COMPILED_MEMORY_RATIONALE`).

Host-side only: nothing here touches the step or synchronizes the device.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Set

logger = logging.getLogger(__name__)

__all__ = [
    "plan_flat_bytes", "tree_device_bytes", "static_footprint",
    "live_memory_stats", "COMPILED_MEMORY_RATIONALE",
]

COMPILED_MEMORY_RATIONALE = (
    "eager torch compiles no executable: there is no compiled step whose "
    "memory analysis could be read (the JAX package reads XLA's "
    "memory_analysis()); live_memory_stats gives the allocator's peak")


def plan_flat_bytes(plan) -> int:
    """Bytes of one full set of flat bucket buffers for a
    :class:`~bagua_tpu_torch.bucket.BucketPlan` — padding included (the
    padded numel IS what the step allocates per bucket)."""
    return int(sum(b.padded_numel * b.dtype.itemsize for b in plan.buckets))


def _walk(obj, seen: Set[int], out: list) -> None:
    import torch

    if isinstance(obj, torch.Tensor):
        if obj.device.type == "meta":
            return
        storage = obj.untyped_storage()
        key = storage.data_ptr()
        if key in seen:
            return
        seen.add(key)
        out.append(int(storage.nbytes()))
    elif isinstance(obj, torch.nn.Module):
        for t in obj.parameters():
            _walk(t, seen, out)
    elif isinstance(obj, torch.optim.Optimizer):
        for st in obj.state.values():
            _walk(st, seen, out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _walk(v, seen, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _walk(v, seen, out)
    elif hasattr(obj, "__dataclass_fields__"):
        for name in obj.__dataclass_fields__:
            _walk(getattr(obj, name), seen, out)


def tree_device_bytes(tree, seen: Optional[Set[int]] = None) -> int:
    """Bytes of the tensors reachable from ``tree`` (a module's parameters,
    an optimizer's state, dicts, lists, tuples and dataclasses of them),
    each storage counted once — a view of a flat counts as the flat.  Host
    metadata only, no readbacks.  ``seen`` carries storages already
    counted by another component."""
    out: list = []
    _walk(tree, set() if seen is None else seen, out)
    return int(sum(out))


def static_footprint(trainer, state) -> Dict[str, Any]:
    """Bytes on the device of a trainer's resident training state plus the
    step's transient gradient flats — the static fit estimate (the trainer
    notes it after its first step, once a torch optimizer made its state).

    * ``params_bytes`` — the module's parameters; under the flat-resident
      layout they are views of the bucket flats, so this equals
      :func:`plan_flat_bytes` of the plan (``tests/test_torch_obs.py``).
    * ``opt_state_bytes`` — the optimizer's state (or the algorithm's
      optimizer state where it owns one); ``algo_state_bytes`` — the
      algorithm's state (error-feedback residuals, gossip replicas).
    * ``grad_flats_bytes`` — one set of per-bucket gradient flats
      (:func:`plan_flat_bytes`), the step's dominant transient.
    """
    ctx = getattr(trainer, "_ctx", None)
    plan = ctx.plan if ctx is not None else None
    seen: Set[int] = set()
    record: Dict[str, Any] = {
        "params_bytes": tree_device_bytes(state.model, seen),
        "opt_state_bytes": tree_device_bytes(
            (state.optimizer, state.opt_state), seen),
        "algo_state_bytes": tree_device_bytes(state.algo_state, seen),
        "grad_flats_bytes": plan_flat_bytes(plan) if plan is not None else 0,
        "bucket_count": len(plan.buckets) if plan is not None else 0,
        "flat_resident": bool(getattr(trainer, "_flat_resident", False)),
        "per_device": True,
        "compiled_memory_analysis": None,
        "compiled_memory_rationale": COMPILED_MEMORY_RATIONALE,
    }
    record["total_bytes"] = (
        record["params_bytes"] + record["opt_state_bytes"]
        + record["algo_state_bytes"] + record["grad_flats_bytes"]
    )
    return record


def live_memory_stats(device=None) -> Dict[str, Any]:
    """One poll of the CUDA caching allocator and the card: ``{"available":
    True, bytes_in_use, peak_bytes_in_use, reserved_bytes, bytes_limit,
    free_bytes, headroom_bytes}`` (``peak_bytes_in_use`` is
    ``torch.cuda.max_memory_allocated()``, ``bytes_limit`` the card's
    memory, ``headroom_bytes`` the limit less the peak), else
    ``{"available": False, "rationale": ...}`` — null-with-rationale, so a
    fleet view can show *why* a rank has no live-memory column."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return {"available": False,
                "rationale": f"device {str(dev)!r} has no CUDA allocator "
                             "statistics (the CPU's memory is the host's)"}
    try:
        stats = torch.cuda.memory_stats(dev)
        free, total = torch.cuda.mem_get_info(dev)
        name = torch.cuda.get_device_name(dev)
    except Exception as e:  # noqa: BLE001 - a runtime hiccup, keep polling
        return {"available": False, "transient": True,
                "rationale": f"memory_stats raised {type(e).__name__}: {e}"}
    record: Dict[str, Any] = {
        "available": True,
        "device_kind": name,
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "reserved_bytes": int(stats.get("reserved_bytes.all.current", 0)),
        "bytes_limit": int(total),
        "free_bytes": int(free),
    }
    record["headroom_bytes"] = record["bytes_limit"] - record["peak_bytes_in_use"]
    return record
