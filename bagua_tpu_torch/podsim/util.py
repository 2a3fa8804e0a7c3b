"""Loopback plumbing shared by every multi-process harness (no torch).

Port of ``bagua_tpu/podsim/util.py``.  ``reserve_port`` is the one "bind
port 0, read the port, close the socket" of the port's tests and drills:
private copies collide, since two fixtures that each bind and release can be
handed the SAME ephemeral port by the kernel before either rebinds it, which
is exactly the flake that launching processes in parallel provokes.  The
allocator keeps a process-wide ledger of every port it has handed out, so
within one orchestrating process no two callers ever receive the same
number: the kernel guarantees the port was free at reservation time, the
ledger that it is never booked twice here.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import List, Optional

__all__ = ["reserve_port", "reserve_ports", "store_barrier"]

#: every port this process has handed out (never reissued, even after the
#: consumer closed it — ephemeral ports are plentiful and a stale entry is
#: cheaper than a collision)
_HANDED_OUT: set = set()
_LOCK = threading.Lock()


def reserve_port(host: str = "127.0.0.1") -> int:
    """One free ephemeral port, never previously returned by this process.

    The port is *probed* (bound with ``SO_REUSEADDR``, then released), not
    held: the caller is expected to bind it promptly.  Cross-process races
    remain possible in principle — that is why servers built on this
    helper keep their ephemeral-fallback paths — but the common flake
    (one orchestrator handing the same port to two of its own children)
    is structurally gone."""
    for _ in range(128):
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((host, 0))
            port = s.getsockname()[1]
        with _LOCK:
            if port not in _HANDED_OUT:
                _HANDED_OUT.add(port)
                return port
    raise OSError(
        f"reserve_port: could not find an unissued ephemeral port on "
        f"{host} after 128 probes ({len(_HANDED_OUT)} already handed out)"
    )


def reserve_ports(n: int, host: str = "127.0.0.1") -> List[int]:
    """``n`` distinct ports in one call (one per simulated node)."""
    return [reserve_port(host) for _ in range(int(n))]


def store_barrier(store, name: str, rank: int, world: int,
                  timeout_s: float = 60.0, poll_s: float = 0.05) -> None:
    """KV-store barrier for the pod simulator's data plane: every rank
    sets ``<name>/<rank>`` then polls until all ``world`` slots exist.
    Same single-mget-scan shape the elastic membership layer uses; the
    barrier key must be unique per (epoch, purpose) — the store has no
    deletes, so reuse would satisfy the barrier instantly."""
    store.set(f"{name}/{int(rank)}", b"1")
    keys = [f"{name}/{i}" for i in range(int(world))]
    deadline = time.monotonic() + float(timeout_s)
    while True:
        if all(v is not None for v in store.mget(keys)):
            return
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"store_barrier {name!r}: rank {rank} waited "
                f"{timeout_s:.0f}s for {world} arrivals"
            )
        time.sleep(poll_s)


def wait_store_keys(store, keys: List[str], timeout_s: float = 60.0,
                    poll_s: float = 0.05) -> List[bytes]:
    """Poll one mget until every key exists; returns the values.  The
    address-exchange primitive ring transports rendezvous through."""
    deadline = time.monotonic() + float(timeout_s)
    while True:
        vals = store.mget(list(keys))
        if all(v is not None for v in vals):
            return vals
        if time.monotonic() > deadline:
            missing = [k for k, v in zip(keys, vals) if v is None]
            raise TimeoutError(
                f"wait_store_keys: {len(missing)} of {len(keys)} keys "
                f"missing after {timeout_s:.0f}s (first: {missing[:3]})"
            )
        time.sleep(poll_s)


def free_port_compat(low: int = 0, high: int = 0,
                     host: str = "127.0.0.1") -> Optional[int]:
    """Drop-in for the legacy ``utils.find_free_port`` signature (the
    range arguments were already ignored there); returns a reserved
    port."""
    del low, high
    return reserve_port(host)
