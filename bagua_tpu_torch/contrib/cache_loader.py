"""Sample cache over a KV store with write batching.

Port of ``bagua_tpu/contrib/cache_loader.py``, the counterpart of the
reference's ``bagua/torch_api/contrib/cache_loader.py:17-139``:
same key scheme (``"{dataset_name}_{key}"``), same ``BatchFetcher`` write
batching (flush every ``writer_buffer_size`` writes, plus a flush every 1000
reads so stragglers land), same pickle serialization.  Backends: ``"memory"``
(in-process: one process a rank, each with its own cache),
``"tcp"`` (cross-process stdlib server cluster), ``"redis"`` (optional).
"""

from __future__ import annotations

import pickle
from typing import Callable, Dict

from .utils.store import InMemoryStore, Store

__all__ = ["CacheLoader", "BatchFetcher", "serialize", "deserialize"]


def serialize(obj) -> bytes:
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def deserialize(data: bytes):
    return pickle.loads(data)


def _make_store(backend: str, **kwargs) -> Store:
    if backend == "memory":
        return InMemoryStore()
    if backend == "tcp":
        from .utils.tcp_store import TCPClusterStore

        return TCPClusterStore(**kwargs)
    if backend == "redis":
        from .utils.redis_store import RedisStore

        return RedisStore(**kwargs)
    raise ValueError(
        f'invalid backend {backend!r}: expected "memory", "tcp" or "redis"'
    )


class CacheLoader:
    """Caches values produced by an expensive ``load_fn``, keyed by sample key.

    >>> loader = CacheLoader(backend="memory", dataset_name="ds")
    >>> value = loader.get(index, lambda k: expensive_produce(k))
    """

    def __init__(
        self,
        backend: str = "memory",
        dataset_name: str = "",
        writer_buffer_size: int = 1,
        **kwargs,
    ):
        self.backend = backend
        self.dataset_name = dataset_name
        self.store = _make_store(backend, **kwargs)
        self.fetcher = BatchFetcher(self.store, 1, writer_buffer_size)

    def get(self, key, load_fn: Callable):
        """Value for ``key``; on miss, computes ``load_fn(key)`` and caches it."""
        cache_key = "{}_{}".format(self.dataset_name, key)
        ret = self.fetcher.read(cache_key)
        if ret is None:
            ret = load_fn(key)
            self.fetcher.write(cache_key, ret)
        return ret

    def num_keys(self) -> int:
        """Number of cached entries."""
        return self.store.num_keys()


class BatchFetcher:
    """Write-batching shim between the loader and the store
    (reference cache_loader.py:96-139)."""

    def __init__(self, store: Store, read_buffer_size: int, writer_buffer_size: int):
        self.store = store
        self.read_buffer_size = max(1, read_buffer_size)
        self.writer_buffer_size = max(1, writer_buffer_size)
        self.write_map: Dict[str, bytes] = {}
        self.write_cnt = 0
        self.read_cnt = 0

    def read(self, key: str):
        self.read_cnt += 1
        # pending (unflushed) writes must be consulted BEFORE the periodic
        # flush below clears them, or the 1000th read of a buffered key
        # becomes a spurious miss
        pending = self.write_map.get(key)
        if pending is not None:
            self.write_post_read()
            return deserialize(pending)
        try:
            ret = self.store.get(key)
        except Exception:
            return None
        self.write_post_read()
        return deserialize(ret) if ret is not None else None

    def write(self, key: str, value) -> None:
        self.write_cnt += 1
        self.write_map[key] = serialize(value)
        if self.write_cnt % self.writer_buffer_size == 0:
            self.flush_write_map()

    def write_post_read(self) -> None:
        if self.read_cnt % 1000 == 0 and self.write_map:
            self.flush_write_map()

    def flush_write_map(self) -> None:
        try:
            self.store.mset(self.write_map)
        except Exception:
            # cache is best-effort; entries retry on the next flush — but a
            # persistently-dead store must not grow the buffer without bound
            limit = max(1000, 10 * self.writer_buffer_size)
            if len(self.write_map) > limit:
                self.write_map.clear()
        else:
            self.write_map.clear()
