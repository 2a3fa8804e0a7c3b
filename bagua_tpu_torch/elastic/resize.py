"""Worker-side resize hooks: consume the renegotiated ``BAGUA_*`` env,
rebuild the process group, restore the checkpoint onto the new world, and
re-split the data shard.

Port of ``bagua_tpu/elastic/resize.py`` (``:23-133``).  A worker spawned
after a rendezvous round sees the standard env protocol (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``, ``BAGUA_COORDINATOR_ADDR``)
already rewritten for the renegotiated world, plus the ``BAGUA_ELASTIC_*``
block describing the round itself.  Nothing here resizes a live process
group: the hooks run at (re)start, the only resize point.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Any, Optional, Tuple

logger = logging.getLogger("bagua_tpu_torch.elastic")


@dataclass(frozen=True)
class ElasticContext:
    """The ``BAGUA_ELASTIC_*`` env block, parsed.  ``enabled`` is False for
    non-elastic launches (every field then holds its fixed-world value), so
    workers can call :meth:`from_env` unconditionally."""

    enabled: bool
    epoch: int
    node_id: int
    rank: int
    world_size: int
    min_nnodes: int
    max_nnodes: int
    store_addr: Optional[str]
    # replicated restart store, comma-separated host:port (empty in
    # single-store mode): worker-side store writers (leave intent) should
    # prefer this over ``store_addr`` so they survive a coordinator takeover
    store_endpoints: str = ""

    @classmethod
    def from_env(cls) -> "ElasticContext":
        e = os.environ
        rank = int(e.get("RANK", "0"))
        world = int(e.get("WORLD_SIZE", "1"))
        return cls(
            enabled=e.get("BAGUA_ELASTIC") == "1",
            epoch=int(e.get("BAGUA_ELASTIC_EPOCH", "0")),
            node_id=int(e.get("BAGUA_ELASTIC_NODE_ID", e.get("NODE_RANK", "0"))),
            rank=rank,
            world_size=world,
            min_nnodes=int(e.get("BAGUA_ELASTIC_MIN_NNODES", "1")),
            max_nnodes=int(e.get("BAGUA_ELASTIC_MAX_NNODES", str(world))),
            store_addr=e.get("BAGUA_ELASTIC_STORE_ADDR"),
            store_endpoints=e.get("BAGUA_RESTART_STORE_ENDPOINTS", ""),
        )

    def init_process_group(self, **kwargs):
        """Join the renegotiated world: a plain
        :func:`bagua_tpu_torch.init_process_group` call (the launcher's env
        is already in place; this hook only names the intent)."""
        from ..communication import init_process_group

        backend = init_process_group(**kwargs)
        if self.enabled:
            logger.info("elastic worker up: epoch %d, rank %d/%d (node id %d, min:max %d:%d)",
                        self.epoch, self.rank, self.world_size, self.node_id,
                        self.min_nnodes, self.max_nnodes)
        return backend


def shard_bounds(total: int, rank: int, world_size: int) -> Tuple[int, int]:
    """Contiguous, balanced re-split of ``total`` samples for this rank
    after a world-size change: every rank gets ``total // world_size``,
    the first ``total % world_size`` ranks one extra.  Deterministic in
    ``(total, rank, world_size)`` only, so every member of a renegotiated
    world derives the identical partition with no extra coordination."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside world of {world_size}")
    base, rem = divmod(total, world_size)
    lo = rank * base + min(rank, rem)
    return lo, lo + base + (1 if rank < rem else 0)


def elastic_restore(manager, state_like: Any, trainer=None,
                    step: Optional[int] = None) -> Tuple[Optional[int], Any]:
    """Restore the newest verified checkpoint (or ``step``) onto the live,
    possibly resized, world and log the transition ``saved world -> live
    world``.

    With ``trainer`` (a :class:`~bagua_tpu_torch.BaguaTrainer` whose
    ``init`` has run) this is ``trainer.restore_checkpoint``, which converts
    across worlds, plans and layouts through the saved sidecar and keeps the
    manager's actionable error for a plan-dependent layout (flat-resident
    ZeRO) that cannot cross worlds.  Without one it is
    ``manager.try_restore`` (``manager.restore`` at ``step``).  An empty
    directory returns ``(None, state_like)``.  Call it on every rank."""
    latest = manager.latest_step() if step is None else int(step)
    if latest is None:
        return None, state_like
    try:
        saved = manager.read_layout(latest)
    except Exception:  # noqa: BLE001 - a torn sidecar: the restore falls back
        saved = None
    if saved is not None:
        from ..env import get_world_size

        was, now = saved.get("world_size"), get_world_size()
        if was is not None and was != now:
            logger.info("elastic restore: checkpoint step %d saved at world_size=%s, restoring "
                        "onto world_size=%s", latest, was, now)
    if trainer is not None:
        return trainer.restore_checkpoint(manager, state_like, step=step)
    if step is not None:
        return manager.restore(state_like, step=step)
    return manager.try_restore(state_like)
