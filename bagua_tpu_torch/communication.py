"""Process group and the bucket allreduce over ``torch.distributed``.

Port of the slice of ``bagua_tpu/communication.py`` the trainer needs:
``ReduceOp``, :func:`init_process_group`, a :class:`BaguaCommunicator` whose
``allreduce`` sums or averages one tensor over every rank, and
:func:`get_backend`.  NCCL carries the collectives on the card, gloo on the
CPU.  Even at world size 1 every bucket goes through a real
``all_reduce``.
"""

from __future__ import annotations

from enum import IntEnum
from typing import Optional

import torch
import torch.distributed as dist

from . import env
from .device import resolve_device


# Numbering matches the reference (and hence Aluminum's ReductionOperator).
class ReduceOp(IntEnum):
    SUM = 0
    PRODUCT = 1
    MIN = 2
    MAX = 3
    BOR = 7
    BAND = 8
    BXOR = 9
    AVG = 10


def init_process_group(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device=None,
) -> "BaguaBackend":
    """Initialize distributed state; call before the other APIs.

    ``device`` picks the collective backend: NCCL for ``cuda`` (the default),
    gloo for ``cpu``.  Without ``init_method`` a single process forms a
    world of 1 from an in-process store (no network); several processes pass
    ``init_method`` (``tcp://host:port``, ``file://path`` or ``env://``) with
    ``world_size`` and ``rank``, which default to ``WORLD_SIZE``/``RANK``.
    Calling it again returns the existing backend.
    """
    device = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        world_size = env.get_world_size() if world_size is None else world_size
        rank = env.get_rank() if rank is None else rank
        if device.type == "cuda":
            torch.cuda.set_device(env.get_local_rank() if device.index is None
                                  else device.index)
        if init_method is None:
            if world_size != 1:
                raise ValueError(f"world_size {world_size} needs an init_method")
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
        else:
            dist.init_process_group(backend, init_method=init_method,
                                    world_size=world_size, rank=rank)
    return get_backend()


class BaguaCommunicator:
    """All ranks of the default process group."""

    def nranks(self) -> int:
        return dist.get_world_size()

    def allreduce(self, x: torch.Tensor, op: ReduceOp = ReduceOp.AVG) -> torch.Tensor:
        """Sum (SUM) or mean (AVG) of ``x`` over the ranks, reduced in place
        in ``x``'s storage and returned.  AVG is a sum then a division,
        since gloo has no AVG."""
        if op not in (ReduceOp.SUM, ReduceOp.AVG):
            raise NotImplementedError(f"allreduce supports SUM and AVG, not {op!r}")
        dist.all_reduce(x, dist.ReduceOp.SUM)
        if op == ReduceOp.AVG:
            x.div_(self.nranks())
        return x


class BaguaBackend:
    """Per-process comm backend: the global communicator.  Intra/inter-node
    communicators come with the hierarchical slice."""

    def __init__(self):
        if not dist.is_initialized():
            raise RuntimeError("call init_process_group() first")
        self.global_communicator = BaguaCommunicator()


_BACKEND: Optional[BaguaBackend] = None


def get_backend() -> BaguaBackend:
    """The process's backend, made on first use."""
    global _BACKEND
    if _BACKEND is None:
        _BACKEND = BaguaBackend()
    return _BACKEND
