"""Redis-backed cluster store (optional backend).

The port's own copy of ``bagua_tpu/contrib/utils/redis_store.py``, the
counterpart of the reference's ``bagua/torch_api/contrib/utils/redis_store.py:38+``
(spawn-or-connect redis servers, hash-sharded cluster view).  Redis is not
a dependency of the package, so this backend is import-gated: it works when
``redis-py`` (and, for spawning, a ``redis-server`` binary) is present and
raises a clear error otherwise.  The stdlib-native equivalent with the same
semantics is :class:`bagua_tpu_torch.contrib.utils.tcp_store.TCPClusterStore`.
"""

from __future__ import annotations

import logging
import shutil
import subprocess
import time
from typing import Dict, List, Optional, Union

from .store import ClusterStore, Store

__all__ = ["RedisStore"]

logger = logging.getLogger(__name__)

Value = Union[str, bytes]

_DEFAULT_CAPACITY = 100 * 1024**2


def _require_redis():
    try:
        import redis  # noqa: F401

        return redis
    except ImportError as e:
        raise ImportError(
            "RedisStore needs the `redis` python package (and a local "
            "`redis-server` binary to spawn instances). Use "
            "bagua_tpu_torch.contrib.utils.tcp_store.TCPClusterStore for a "
            "dependency-free equivalent."
        ) from e


class _RedisShard(Store):
    """One redis connection with the Store API (reference redis_store.py)."""

    def __init__(self, host: str, port: int, managed_proc=None):
        redis = _require_redis()
        self._client = redis.Redis(host=host, port=int(port), db=0)
        self._proc = managed_proc

    def set(self, key: str, value: Value) -> None:
        self._client.set(key, value)

    def get(self, key: str) -> Optional[Value]:
        return self._client.get(key)

    def mset(self, dictionary: Dict[str, Value]) -> None:
        self._client.mset(dictionary)

    def mget(self, keys: List[str]) -> List[Optional[Value]]:
        return self._client.mget(keys)

    def num_keys(self) -> int:
        return int(self._client.dbsize())

    def clear(self) -> None:
        self._client.flushdb()

    def status(self) -> bool:
        try:
            return bool(self._client.ping())
        except Exception:
            return False

    def shutdown(self) -> None:
        if self._proc is not None:  # only managed instances are killed
            try:
                self._client.shutdown(nosave=True)
            except Exception:
                pass
            self._proc.terminate()
            self._proc = None


def _spawn_redis_server(port: int, capacity_bytes: int) -> subprocess.Popen:
    binary = shutil.which("redis-server")
    if binary is None:
        raise RuntimeError(
            "redis-server binary not found; pass `hosts=` to connect to "
            "existing servers, or use TCPClusterStore"
        )
    proc = subprocess.Popen(
        [
            binary,
            "--port", str(port),
            "--maxmemory", str(capacity_bytes),
            "--maxmemory-policy", "allkeys-random",
            "--appendonly", "no",
            "--save", "",
            "--protected-mode", "yes",
        ],
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
    )
    return proc


class RedisStore(ClusterStore):
    """Cluster store over redis instances (spawned or existing).

    Args:
        hosts: list of ``{"host": ..., "port": ...}`` dicts of *existing*
            redis servers.  When None, spawns one local server.
        cluster_mode: shard keys over all hosts (else only this node's).
        capacity_per_node: ``maxmemory`` for spawned servers.
    """

    def __init__(
        self,
        hosts: Optional[List[Dict[str, str]]] = None,
        cluster_mode: bool = True,
        capacity_per_node: int = _DEFAULT_CAPACITY,
    ):
        _require_redis()
        shards: List[Store] = []
        if hosts is None:
            port = 7000
            proc = _spawn_redis_server(port, capacity_per_node)
            shard = _RedisShard("127.0.0.1", port, managed_proc=proc)
            deadline = time.time() + 10
            while not shard.status():
                if time.time() > deadline:
                    raise RuntimeError("spawned redis-server did not come up")
                time.sleep(0.1)
            shards.append(shard)
        else:
            use = hosts if cluster_mode else hosts[:1]
            for h in use:
                shards.append(_RedisShard(h["host"], int(h["port"])))
        super().__init__(shards)
