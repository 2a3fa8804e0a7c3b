"""Loopback-TCP ring transport with the link shaper on every hop.

Port of ``bagua_tpu/podsim/transport.py``.  Each ring member owns one listening socket; addresses rendezvous through
the restart TCPStore under an epoch-fenced namespace (the same epoch
discipline the membership layer uses — a ring from attempt N cannot
cross-talk with attempt N+1's).  Ring position ``p`` sends to ``p+1`` and
receives from ``p-1``; frames are length-prefixed.  The shaper charges
the hop's wire bytes against the (src, dst) *global* rank pair, so an
intra-slice ring pays ICI physics and a cross-slice ring pays DCN physics
— and armed ``podsim.link`` faults surface here as ``ConnectionError``s,
exactly the failure class a real peer reset produces.
"""

from __future__ import annotations

import socket
import struct
import time
from typing import List, Optional

from .shaping import LinkShaper
from .util import wait_store_keys

__all__ = ["RingTransport"]

_LEN = struct.Struct("<I")
_MAX_FRAME = 64 * 1024 * 1024


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise ConnectionError(
                f"ring peer closed mid-frame ({len(buf)}/{n} bytes)"
            )
        buf += part
    return bytes(buf)


class RingTransport:
    """One ring over loopback TCP.

    ``rank_map`` lists the *global* rank at each ring position (the
    shaper classifies links by global rank); ``pos`` is this member's
    position.  ``namespace`` must be unique per (epoch, ring) — e.g.
    ``podsim/<epoch>/ring/intra3``."""

    def __init__(self, store, namespace: str, rank_map: List[int], pos: int,
                 shaper: Optional[LinkShaper] = None,
                 host: str = "127.0.0.1", timeout_s: float = 60.0):
        self.size = len(rank_map)
        self.pos = int(pos)
        self.rank = int(rank_map[self.pos])
        self.next_rank = int(rank_map[(self.pos + 1) % self.size])
        self.shaper = shaper
        self._send: Optional[socket.socket] = None
        self._recv: Optional[socket.socket] = None
        self._listener: Optional[socket.socket] = None
        if self.size == 1:
            return
        # listen (kernel-assigned port — the bind itself holds it), then
        # publish, then connect to next, then accept prev.  Everyone
        # connects "rightward" concurrently, so accept cannot deadlock.
        lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lst.bind((host, 0))
        lst.listen(2)
        lst.settimeout(timeout_s)
        self._listener = lst
        store.set(f"{namespace}/addr/{self.pos}",
                  f"{host}:{lst.getsockname()[1]}")
        (next_addr,) = wait_store_keys(
            store, [f"{namespace}/addr/{(self.pos + 1) % self.size}"],
            timeout_s=timeout_s,
        )
        next_host, next_port = next_addr.decode().rsplit(":", 1)
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                self._send = socket.create_connection(
                    (next_host, int(next_port)),
                    timeout=max(1.0, deadline - time.monotonic()),
                )
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
        self._send.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._recv, _ = lst.accept()
        self._recv.settimeout(timeout_s)

    def hop(self, payload: bytes, hop_index: int = 0,
            step: Optional[int] = None) -> bytes:
        """One ppermute-shaped exchange: shaped send to next, receive from
        prev.  Identity at ring size 1."""
        if self.size == 1:
            return payload
        if len(payload) > _MAX_FRAME:
            raise ValueError(f"frame {len(payload)} exceeds {_MAX_FRAME}")
        if self.shaper is not None:
            self.shaper.traverse(self.rank, self.next_rank, len(payload),
                                 hop=hop_index, step=step)
        self._send.sendall(_LEN.pack(len(payload)) + payload)
        n = _LEN.unpack(_recv_exact(self._recv, _LEN.size))[0]
        return _recv_exact(self._recv, n)

    def close(self) -> None:
        for s in (self._send, self._recv, self._listener):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self._send = self._recv = self._listener = None

    def __enter__(self) -> "RingTransport":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
