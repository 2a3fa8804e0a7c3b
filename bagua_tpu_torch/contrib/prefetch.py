"""Device prefetching: overlap the host-to-device copy with compute.

Port of ``bagua_tpu/contrib/prefetch.py``.  ``prefetch_to_device`` wraps any
host batch iterator and keeps ``size`` batches on the device ahead of the
step that takes them.  Each tensor is copied into pinned host memory and
then to the device with ``non_blocking=True``: the copy is queued on the
current stream, behind the step already queued there, so the host goes on
to the next batch while the card computes, and the step that reads the
batch runs after its copy on the same stream.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator, Mapping, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["prefetch_to_device"]


def _pinned(x) -> torch.Tensor:
    """``x`` (a tensor or array) as a host tensor in pinned memory where a
    card is there to copy it (pinning needs one)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if x.device.type == "cpu" and torch.cuda.is_available() and not x.is_pinned():
        x = x.pin_memory()
    return x


def prefetch_to_device(
    iterable: Iterable,
    trainer=None,
    size: int = 2,
    mesh=None,
    spec: Optional[Sequence] = None,
    device=None,
) -> Iterator:
    """Yield batches (mappings of tensors or arrays) from ``iterable`` with
    ``size`` batches already on the device.

    Args:
        iterable: host-side batch iterator.
        trainer: a :class:`~bagua_tpu_torch.core.backend.BaguaTrainer`:
            batches are placed with ``trainer.shard_batch`` (its device).
            Mutually exclusive with ``mesh``/``spec``.
        size: lookahead depth (>= 1).
        mesh / spec: placement without a trainer: every tensor is this
            rank's local slice along the axes ``spec`` names for its
            leading dims (one entry a dim: None, an axis name of ``mesh`` or
            a tuple of them, as a ``PartitionSpec``), put on ``device``
            (``cuda`` unless the caller passes another).
    """
    # validate eagerly (a generator body would defer errors to first next())
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    if trainer is not None and (mesh is not None or spec is not None):
        raise ValueError("pass trainer OR mesh/spec, not both")

    if trainer is not None:
        def place(batch: Mapping):
            return trainer.shard_batch({k: _pinned(v) for k, v in batch.items()})
    elif mesh is not None and spec is not None:
        for entry in spec:
            if entry is not None:
                mesh.size_of(entry)   # unknown axis names raise here
        target = resolve_device(device)

        def place(batch: Mapping):
            out = {}
            for k, v in batch.items():
                v = _pinned(v)
                if v.dim() < len(spec):
                    raise ValueError(f"{k}: spec {tuple(spec)} names {len(spec)} dims of a "
                                     f"{v.dim()}-dim tensor")
                out[k] = v.to(target, non_blocking=True)
            return out
    else:
        raise ValueError("pass a trainer, or both mesh and spec")

    def gen():
        queue: collections.deque = collections.deque()
        it = iter(iterable)

        def fill():
            while len(queue) < size:
                try:
                    queue.append(place(next(it)))
                except StopIteration:
                    return

        fill()
        while queue:
            yield queue.popleft()
            fill()

    return gen()
