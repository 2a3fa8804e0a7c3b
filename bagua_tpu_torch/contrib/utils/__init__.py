"""Contrib utilities: KV stores (in-memory, TCP cluster, optional redis)."""

from .store import ClusterStore, InMemoryStore, Store  # noqa: F401
from .tcp_store import TCPClusterStore, TCPStore, TCPStoreServer  # noqa: F401

__all__ = [
    "Store",
    "ClusterStore",
    "InMemoryStore",
    "TCPStore",
    "TCPStoreServer",
    "TCPClusterStore",
]
