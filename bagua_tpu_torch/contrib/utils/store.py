"""Key-value store abstraction: ``Store`` + hash-sharded ``ClusterStore``.

The port's own copy of ``bagua_tpu/contrib/utils/store.py`` (jax-free; the
port imports nothing of the JAX package), the counterpart of the reference's
``bagua/torch_api/contrib/utils/store.py:8-145``:
the same API surface (set/get/num_keys/clear/mset/mget/status/shutdown) and
the same sharding rule (stable 64-bit key hash modulo the number of store
instances) so entries written through one worker's cluster view are found by
every other worker's view.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List, Optional, Union

__all__ = ["Store", "ClusterStore", "InMemoryStore"]

Value = Union[str, bytes]


def _default_hash():
    """Stable (process- and install-independent) 64-bit key hash.

    Python's builtin ``hash`` is salted per process, which would route the
    same key to different shards in different workers.  The reference uses
    xxh64 (store.py:72-77); here it's stdlib blake2b *unconditionally* — an
    optional xxhash fast path would silently route the same key to different
    shards on workers with different installed packages, breaking the shared
    cache.  Hashing cost is noise next to the store round-trip.
    """
    import hashlib

    return lambda data: int.from_bytes(
        hashlib.blake2b(data, digest_size=8).digest(), "big"
    )


class Store:
    """Base class for key-value store implementations.

    Entries are added with :meth:`set`/:meth:`mset` and retrieved with
    :meth:`get`/:meth:`mget` (reference store.py:8-53).
    """

    def set(self, key: str, value: Value) -> None:
        raise NotImplementedError

    def get(self, key: str) -> Optional[Value]:
        raise NotImplementedError

    def num_keys(self) -> int:
        raise NotImplementedError

    def clear(self) -> None:
        raise NotImplementedError

    def mset(self, dictionary: Dict[str, Value]) -> None:
        for k, v in dictionary.items():
            self.set(k, v)

    def mget(self, keys: List[str]) -> List[Optional[Value]]:
        return [self.get(k) for k in keys]

    def status(self) -> bool:
        """True when the store is alive."""
        return True

    def shutdown(self) -> None:
        """Shut down managed store instances (unmanaged ones are left alone)."""


class InMemoryStore(Store):
    """Process-local dict-backed store (thread-safe).

    The single-process backend for :class:`~bagua_tpu_torch.contrib.CacheLoader`
    (one process a rank, each with its own cache).  Cross-process sharing
    uses :class:`bagua_tpu_torch.contrib.utils.tcp_store.TCPStore`.
    """

    def __init__(self):
        self._data: Dict[str, Value] = {}
        self._lock = threading.Lock()

    def set(self, key: str, value: Value) -> None:
        with self._lock:
            self._data[key] = value

    def get(self, key: str) -> Optional[Value]:
        with self._lock:
            return self._data.get(key)

    def num_keys(self) -> int:
        with self._lock:
            return len(self._data)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def mset(self, dictionary: Dict[str, Value]) -> None:
        with self._lock:
            self._data.update(dictionary)

    def mget(self, keys: List[str]) -> List[Optional[Value]]:
        with self._lock:
            return [self._data.get(k) for k in keys]


class ClusterStore(Store):
    """Shards entries over multiple stores by a stable key hash.

    Same routing semantics as the reference (store.py:56-145): ``shard =
    hash64(key) % num_stores``, batch operations are routed per shard.
    """

    def __init__(self, stores: List[Store]):
        if not stores:
            raise ValueError("ClusterStore needs at least one store")
        self.stores = stores
        self.num_stores = len(stores)
        self.hash_fn = _default_hash()

    def _hash_key(self, key: str) -> int:
        return self.hash_fn(key.encode()) % self.num_stores

    def route(self, key: str) -> Store:
        if self.num_stores == 1:
            return self.stores[0]
        return self.stores[self._hash_key(key)]

    def set(self, key: str, value: Value) -> None:
        self.route(key).set(key, value)

    def get(self, key: str) -> Optional[Value]:
        return self.route(key).get(key)

    def num_keys(self) -> int:
        return sum(s.num_keys() for s in self.stores)

    def clear(self) -> None:
        for s in self.stores:
            s.clear()

    def mset(self, dictionary: Dict[str, Value]) -> None:
        if self.num_stores == 1:
            return self.stores[0].mset(dictionary)
        route_table: Dict[int, Dict[str, Value]] = defaultdict(dict)
        for k, v in dictionary.items():
            route_table[self._hash_key(k)][k] = v
        for sid, m in route_table.items():
            self.stores[sid].mset(m)

    def mget(self, keys: List[str]) -> List[Optional[Value]]:
        if self.num_stores == 1:
            return self.stores[0].mget(keys)
        route_table: Dict[int, List[int]] = defaultdict(list)
        for i, k in enumerate(keys):
            route_table[self._hash_key(k)].append(i)
        out: List[Optional[Value]] = [None] * len(keys)
        for sid, positions in route_table.items():
            values = self.stores[sid].mget([keys[i] for i in positions])
            for i, v in zip(positions, values):
                out[i] = v
        return out

    def status(self) -> bool:
        return all(s.status() for s in self.stores)

    def shutdown(self) -> None:
        for s in self.stores:
            s.shutdown()
