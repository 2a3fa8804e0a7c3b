"""Spawnable cross-process KV store over TCP — Python client + two servers.

The port's own copy of ``bagua_tpu/contrib/utils/tcp_store.py``, with the
same wire protocol.  Role counterpart of the reference's ``RedisStore``
(``bagua/torch_api/contrib/utils/redis_store.py:38+``), which
spawns ``redis-server`` (a native C server) per node and shards a cluster
view over them.  Here the native server is our own:
``csrc/bagua_store_server.cpp`` (thread-per-connection C++; built on demand
with g++ — see :mod:`.native_build`), with a stdlib-Python threaded server as
the always-available fallback.  Both speak the same language-neutral binary
protocol, so the client doesn't care which it reached.

Wire protocol (little-endian):
    request:  u8 op | op-specific payload;  bytes fields are u32 len + raw
    ops:      1=SET k v   2=GET k     3=MSET n (k v)*   4=MGET n k*
              5=NUM_KEYS  6=CLEAR     7=PING            8=SHUTDOWN
              9=GENERATION            10=PROMOTE new_gen(u64)
              11=REPL gen(u64) n (frame)*
              12=REPL_SNAPSHOT gen(u64) n (k v)*
              13=DUMP
    frames:   u8 0 (SET) k v | u8 1 (CLEAR)
    response: GET   -> u8 present + [val]
              MGET  -> u32 n + n * (u8 present + [val])
              NUM_KEYS -> u64
              GENERATION -> u8 primary + u64 generation
              PROMOTE / REPL / REPL_SNAPSHOT -> u8 status + u64 generation
              DUMP  -> u8 primary + u64 generation + u32 n + n * (k v)
              others  -> u8 status (0 = ok, 2 = write fenced)
Values are opaque bytes (the cache layer pickles sample payloads itself,
reference cache_loader.py serialize/deserialize).

Replication + generation fence (Python backend only): a server started
with ``peers`` streams every applied write (op log, in apply order) to each
peer over a per-peer link thread, resynchronizing with a full snapshot on
(re)connect or queue overflow.  Every server carries a monotonic **store
generation**; a ``PROMOTE`` with a higher generation turns a standby into
the primary, and any replication frame carrying a *lower* generation is
refused with a fence status — which the stale sender obeys by demoting
itself, after which its clients' writes get the fence ack (status 2) and
a failover client moves on to the
promoted endpoint.  A plain server (no peers, default role) keeps
generation 0 / primary and is byte-for-byte the pre-replication protocol.
"""

from __future__ import annotations

import logging
import random
import socket
import socketserver
import struct
import subprocess
import threading
from typing import Dict, List, Optional, Tuple, Union

from .store import ClusterStore, Store

__all__ = [
    "TCPStoreServer", "TCPStore", "TCPClusterStore", "start_tcp_store",
    "StoreFencedError",
]

log = logging.getLogger(__name__)

Value = Union[str, bytes]

OP_SET, OP_GET, OP_MSET, OP_MGET, OP_NUM_KEYS, OP_CLEAR, OP_PING, OP_SHUTDOWN = (
    range(1, 9)
)
OP_GENERATION, OP_PROMOTE, OP_REPL, OP_REPL_SNAPSHOT, OP_DUMP = range(9, 14)

ACK_OK = 0
ACK_FENCED = 2

_FRAME_SET = 0
_FRAME_CLEAR = 1

_U8 = struct.Struct("<B")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

# sanity caps: a desynced or malicious client must not make the shared
# server allocate gigabytes from one malformed length field
_MAX_FRAME = 1 << 30   # 1 GiB per value
_MAX_BATCH = 1 << 20   # keys per mset/mget


class _ProtocolError(ConnectionError):
    pass


class StoreFencedError(ConnectionError):
    """A write was refused by a demoted / standby server (generation fence).

    A ``ConnectionError`` subclass on purpose: every production retry path
    (`_STORE_RETRY_ERRORS`) already treats it as "this endpoint is not
    usable, reconnect" — which for the failover client means *try the next
    endpoint*, exactly the right response to a fenced write."""


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("tcp store connection closed")
        buf += chunk
    return bytes(buf)


def _recv_bytes(sock: socket.socket) -> bytes:
    (n,) = _U32.unpack(_recv_exact(sock, 4))
    if n > _MAX_FRAME:
        raise _ProtocolError(f"frame of {n} bytes exceeds cap {_MAX_FRAME}")
    return _recv_exact(sock, n)


def _recv_count(sock: socket.socket) -> int:
    (n,) = _U32.unpack(_recv_exact(sock, 4))
    if n > _MAX_BATCH:
        raise _ProtocolError(f"batch of {n} items exceeds cap {_MAX_BATCH}")
    return n


def _pack_bytes(data: bytes) -> bytes:
    return _U32.pack(len(data)) + data


def _to_bytes(v: Value) -> bytes:
    return v.encode() if isinstance(v, str) else bytes(v)


# ---------------------------------------------------------------------------
# Python fallback server
# ---------------------------------------------------------------------------


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        data: Dict[bytes, bytes] = self.server.data  # type: ignore[attr-defined]
        lock: threading.Lock = self.server.data_lock  # type: ignore[attr-defined]
        srv = self.server
        sock = self.request
        # registered so stop() can sever established connections too — a
        # stopped server must not keep serving a stale world to clients
        # that dialed in before it died (failover correctness: their next
        # op must fail over, not read a zombie's dict)
        with lock:
            srv.live_socks.add(sock)
        try:
            while True:
                (op,) = _U8.unpack(_recv_exact(sock, 1))
                if op == OP_SET:
                    k, v = _recv_bytes(sock), _recv_bytes(sock)
                    with lock:
                        fenced = not srv.primary
                        if not fenced:
                            data[k] = v
                            if srv.replicator is not None:
                                srv.replicator.log_set([(k, v)])
                    sock.sendall(_U8.pack(ACK_FENCED if fenced else ACK_OK))
                elif op == OP_GET:
                    k = _recv_bytes(sock)
                    with lock:
                        v = data.get(k)
                    sock.sendall(
                        _U8.pack(0) if v is None
                        else _U8.pack(1) + _pack_bytes(v)
                    )
                elif op == OP_MSET:
                    n = _recv_count(sock)
                    items = [
                        (_recv_bytes(sock), _recv_bytes(sock)) for _ in range(n)
                    ]
                    with lock:
                        fenced = not srv.primary
                        if not fenced:
                            data.update(items)
                            if srv.replicator is not None:
                                srv.replicator.log_set(items)
                    sock.sendall(_U8.pack(ACK_FENCED if fenced else ACK_OK))
                elif op == OP_MGET:
                    n = _recv_count(sock)
                    keys = [_recv_bytes(sock) for _ in range(n)]
                    with lock:
                        vals = [data.get(k) for k in keys]
                    out = [_U32.pack(n)]
                    for v in vals:
                        out.append(
                            _U8.pack(0) if v is None
                            else _U8.pack(1) + _pack_bytes(v)
                        )
                    sock.sendall(b"".join(out))
                elif op == OP_NUM_KEYS:
                    with lock:
                        sock.sendall(_U64.pack(len(data)))
                elif op == OP_CLEAR:
                    with lock:
                        fenced = not srv.primary
                        if not fenced:
                            data.clear()
                            if srv.replicator is not None:
                                srv.replicator.log_clear()
                    sock.sendall(_U8.pack(ACK_FENCED if fenced else ACK_OK))
                elif op == OP_PING:
                    sock.sendall(_U8.pack(0))
                elif op == OP_GENERATION:
                    with lock:
                        primary, gen = srv.primary, srv.generation
                    sock.sendall(_U8.pack(1 if primary else 0) + _U64.pack(gen))
                elif op == OP_PROMOTE:
                    (new_gen,) = _U64.unpack(_recv_exact(sock, 8))
                    with lock:
                        if new_gen > srv.generation:
                            srv.generation = new_gen
                            was_primary, srv.primary = srv.primary, True
                            status, gen = ACK_OK, new_gen
                        else:
                            status, gen = ACK_FENCED, srv.generation
                    if status == ACK_OK and not was_primary:
                        log.info("tcp store: promoted to primary "
                                 "(generation %d)", gen)
                        if srv.replicator is not None:
                            srv.replicator.resync()
                    sock.sendall(_U8.pack(status) + _U64.pack(gen))
                elif op == OP_REPL:
                    (sender_gen,) = _U64.unpack(_recv_exact(sock, 8))
                    n = _recv_count(sock)
                    frames = []
                    for _ in range(n):
                        (kind,) = _U8.unpack(_recv_exact(sock, 1))
                        if kind == _FRAME_SET:
                            frames.append(
                                (kind, _recv_bytes(sock), _recv_bytes(sock))
                            )
                        elif kind == _FRAME_CLEAR:
                            frames.append((kind, b"", b""))
                        else:
                            raise _ProtocolError(f"bad repl frame kind {kind}")
                    with lock:
                        if sender_gen < srv.generation:
                            status, gen = ACK_FENCED, srv.generation
                        else:
                            srv.generation = sender_gen
                            srv.primary = False  # replica of a live primary
                            for kind, k, v in frames:
                                if kind == _FRAME_SET:
                                    data[k] = v
                                else:
                                    data.clear()
                            status, gen = ACK_OK, sender_gen
                    sock.sendall(_U8.pack(status) + _U64.pack(gen))
                elif op == OP_REPL_SNAPSHOT:
                    (sender_gen,) = _U64.unpack(_recv_exact(sock, 8))
                    n = _recv_count(sock)
                    items = [
                        (_recv_bytes(sock), _recv_bytes(sock)) for _ in range(n)
                    ]
                    with lock:
                        if sender_gen < srv.generation:
                            status, gen = ACK_FENCED, srv.generation
                        else:
                            srv.generation = sender_gen
                            srv.primary = False
                            data.clear()
                            data.update(items)
                            status, gen = ACK_OK, sender_gen
                    sock.sendall(_U8.pack(status) + _U64.pack(gen))
                elif op == OP_DUMP:
                    with lock:
                        primary, gen = srv.primary, srv.generation
                        items = list(data.items())
                    out = [_U8.pack(1 if primary else 0), _U64.pack(gen),
                           _U32.pack(len(items))]
                    for k, v in items:
                        out.append(_pack_bytes(k))
                        out.append(_pack_bytes(v))
                    sock.sendall(b"".join(out))
                elif op == OP_SHUTDOWN:
                    sock.sendall(_U8.pack(0))
                    threading.Thread(
                        target=self.server.shutdown, daemon=True
                    ).start()
                    return
                else:
                    return  # unknown op: drop the connection
        except (ConnectionError, OSError):
            return
        finally:
            with lock:
                srv.live_socks.discard(sock)


class _Server(socketserver.ThreadingTCPServer):
    # class attrs take effect before bind (instance assignment after
    # bind_and_activate=True would be a no-op)
    allow_reuse_address = True
    daemon_threads = True
    # socketserver's default listen backlog is 5.  A pod-scale cold start
    # is a connect STORM — every launcher plus every heartbeat thread
    # dials the one restart store within the same join window — and with
    # a 5-deep accept queue the kernel drops the overflow SYNs, which
    # clients only recover from after a ≥1 s retransmit.  That turns an
    # O(ms) rendezvous into O(seconds) at 128+ connections (measured by
    # scripts/scale_drill.py, before/after in BENCH_SCALE.json).
    request_queue_size = 256
    # replication defaults for a plain server; instance attrs (all guarded
    # by data_lock) override them when the server participates in a
    # replicated group
    primary = True
    generation = 0
    replicator: Optional["_Replicator"] = None


class _ReplLink:
    """One replication link: primary -> one peer endpoint.

    Owns a bounded op-log queue and a sender thread.  The handler appends
    frames *while holding data_lock* so the log order is exactly the apply
    order; the sender drains and ships them outside every lock.  A
    (re)connect or a queue overflow falls back to a full snapshot, so a
    follower that missed frames always converges.  A fence response (the
    peer runs a higher generation) demotes the local server: its clients'
    writes start failing with the fence ack, which is what makes "a stale
    primary can never keep accepting writes after takeover" true."""

    _BATCH = 256          # frames per OP_REPL message
    _MAX_QUEUE = 8192     # frames buffered before snapshot fallback

    def __init__(self, server: "_Server", host: str, port: int):
        self._server = server
        self.host, self.port = host, int(port)
        self._cond = threading.Condition()
        self._queue: List[Tuple[int, bytes, bytes]] = []
        self._need_snapshot = True
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"store-repl-{host}:{port}",
        )

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()

    # -- producer side (called by _Handler, data_lock held) --

    def append(self, frames: List[Tuple[int, bytes, bytes]]) -> None:
        with self._cond:
            if len(self._queue) + len(frames) > self._MAX_QUEUE:
                # overflow: drop the log, resync with a snapshot instead
                self._queue.clear()
                self._need_snapshot = True
            else:
                self._queue.extend(frames)
            self._cond.notify_all()

    def mark_resync(self) -> None:
        with self._cond:
            self._queue.clear()
            self._need_snapshot = True
            self._cond.notify_all()

    # -- sender thread --

    def _run(self) -> None:
        sock: Optional[socket.socket] = None
        backoff = 0.05
        while not self._stop.is_set():
            with self._server.data_lock:
                is_primary = self._server.primary
            if not is_primary:
                # demoted/standby: replication is the primary's job; park
                # (a later PROMOTE calls mark_resync() and we pick up here)
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    sock = None
                self._stop.wait(0.1)
                continue
            with self._cond:
                need_snapshot = self._need_snapshot
                if not need_snapshot and not self._queue:
                    self._cond.wait(timeout=0.2)
                    continue
                batch = [] if need_snapshot else self._queue[:self._BATCH]
                if not need_snapshot:
                    del self._queue[:len(batch)]
            try:
                if sock is None:
                    sock = socket.create_connection(
                        (self.host, self.port), timeout=5.0
                    )
                    sock.setsockopt(
                        socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                    )
                    with self._cond:
                        self._need_snapshot = True
                        need_snapshot = True
                        self._queue.clear()
                if need_snapshot:
                    status, peer_gen = self._send_snapshot(sock)
                    if status == ACK_OK:
                        with self._cond:
                            self._need_snapshot = False
                else:
                    status, peer_gen = self._send_frames(sock, batch)
                backoff = 0.05
            except (ConnectionError, OSError, struct.error):
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    sock = None
                with self._cond:
                    self._need_snapshot = True
                # jittered backoff so N links don't re-dial in lockstep
                self._stop.wait(backoff * (1.0 + random.random()))
                backoff = min(2.0, backoff * 2)
                continue
            if status == ACK_FENCED:
                self._demote(peer_gen)

    def _snapshot(self) -> Tuple[int, List[Tuple[bytes, bytes]]]:
        with self._server.data_lock:
            return self._server.generation, list(self._server.data.items())

    def _send_snapshot(self, sock: socket.socket) -> Tuple[int, int]:
        gen, items = self._snapshot()
        parts = [_U8.pack(OP_REPL_SNAPSHOT), _U64.pack(gen),
                 _U32.pack(len(items))]
        for k, v in items:
            parts.append(_pack_bytes(k))
            parts.append(_pack_bytes(v))
        sock.sendall(b"".join(parts))
        (status,) = _U8.unpack(_recv_exact(sock, 1))
        (peer_gen,) = _U64.unpack(_recv_exact(sock, 8))
        return status, peer_gen

    def _send_frames(self, sock: socket.socket,
                     frames: List[Tuple[int, bytes, bytes]]) -> Tuple[int, int]:
        with self._server.data_lock:
            gen = self._server.generation
        parts = [_U8.pack(OP_REPL), _U64.pack(gen), _U32.pack(len(frames))]
        for kind, k, v in frames:
            if kind == _FRAME_SET:
                parts.append(_U8.pack(_FRAME_SET))
                parts.append(_pack_bytes(k))
                parts.append(_pack_bytes(v))
            else:
                parts.append(_U8.pack(_FRAME_CLEAR))
        sock.sendall(b"".join(parts))
        (status,) = _U8.unpack(_recv_exact(sock, 1))
        (peer_gen,) = _U64.unpack(_recv_exact(sock, 8))
        return status, peer_gen

    def _demote(self, peer_gen: int) -> None:
        with self._server.data_lock:
            if not self._server.primary:
                return
            self._server.primary = False
        log.warning(
            "tcp store: peer %s:%d runs generation %d > ours — demoting "
            "(late writes on this server are now fenced)",
            self.host, self.port, peer_gen,
        )


class _Replicator:
    """Fan-out of the primary's op log to every peer endpoint."""

    def __init__(self, server: "_Server",
                 peers: List[Tuple[str, int]]):
        self._links = [_ReplLink(server, h, p) for h, p in peers]

    def start(self) -> None:
        for link in self._links:
            link.start()

    def stop(self) -> None:
        for link in self._links:
            link.stop()

    def log_set(self, items: List[Tuple[bytes, bytes]]) -> None:
        frames = [(_FRAME_SET, k, v) for k, v in items]
        for link in self._links:
            link.append(frames)

    def log_clear(self) -> None:
        for link in self._links:
            link.append([(_FRAME_CLEAR, b"", b"")])

    def resync(self) -> None:
        """Freshly promoted: push a full snapshot at the new generation to
        every peer (their logs were cut against the dead primary)."""
        for link in self._links:
            link.mark_resync()


class TCPStoreServer:
    """A KV server on (host, port); port 0 = auto-pick.

    ``backend="auto"`` prefers the compiled C++ server (building it on first
    use) and falls back to the in-process Python server; ``"python"`` /
    ``"cpp"`` force one.

    ``peers`` (list of ``(host, port)``) enrolls this server in a
    replicated group: while primary, it streams its op log (snapshot
    fallback) to every peer.  ``role="standby"`` starts it fenced (writes
    refused) until a ``PROMOTE`` lands.  Replication forces the Python
    backend — the native C++ server speaks only the base protocol.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 backend: str = "auto",
                 peers: Optional[List[Tuple[str, int]]] = None,
                 role: str = "primary"):
        if role not in ("primary", "standby"):
            raise ValueError(f"bad store role {role!r}")
        self._proc: Optional[subprocess.Popen] = None
        self._server = None
        self._addr: Tuple[str, int] = (host, port)
        self._peers = [(h, int(p)) for h, p in (peers or [])]
        self._role = role
        if self._peers or role != "primary":
            backend = "python"  # replication lives in the Python server
        if backend in ("auto", "cpp"):
            from .native_build import ensure_store_server

            binary = ensure_store_server(required=(backend == "cpp"))
            if binary is not None:
                self._spawn_native(binary, host, port)
                return
        self._start_python(host, port)

    def _start_python(self, host: str, port: int) -> None:
        self._server = _Server((host, port), _Handler, bind_and_activate=True)
        self._server.data = {}  # type: ignore[attr-defined]
        self._server.data_lock = threading.Lock()  # type: ignore[attr-defined]
        self._server.live_socks = set()  # type: ignore[attr-defined]
        self._server.primary = self._role == "primary"
        self._server.generation = 0
        if self._peers and self._role == "primary":
            self._recover_from_peers()
        if self._peers:
            self._server.replicator = _Replicator(self._server, self._peers)
            self._server.replicator.start()
        self._addr = self._server.server_address[:2]
        threading.Thread(
            target=self._server.serve_forever, daemon=True
        ).start()

    def _recover_from_peers(self) -> None:
        """Boot-time recovery for a (re)starting primary: adopt the best
        surviving peer's state instead of replicating an empty dict over
        it.  Without this, a relaunched primary (fresh process, generation
        0, zero keys) would snapshot-WIPE followers still holding the
        autopilot/historian state that replication exists to preserve.
        If any reachable peer claims the primary role, this server starts
        demoted — a takeover already happened, and the leadership layer
        (elastic.failover) must not see two willing primaries."""
        best: Optional[Tuple[int, int, Dict[bytes, bytes]]] = None
        peer_is_primary = False
        for host, port in self._peers:
            try:
                client = TCPStore(host, port, timeout_s=1.0)
            except OSError:
                continue  # peer still booting (fleet cold start)
            try:
                primary, gen, items = client.dump()
            except (ConnectionError, OSError):
                continue  # pre-replication peer: nothing to recover
            finally:
                try:
                    client._sock.close()
                except OSError:
                    pass
            peer_is_primary = peer_is_primary or primary
            if items or gen:
                rank = (gen, len(items))
                if best is None or rank > best[:2]:
                    best = (gen, len(items), items)
        if best is not None:
            gen, _n, items = best
            with self._server.data_lock:
                if not self._server.data:  # never clobber local state
                    self._server.data.update(items)
                    self._server.generation = max(
                        self._server.generation, gen)
            log.info(
                "tcp store: recovered %d key(s) at generation %d from a "
                "surviving peer", len(items), gen,
            )
        if peer_is_primary:
            with self._server.data_lock:
                self._server.primary = False
            log.warning(
                "tcp store: a peer already holds the primary role — "
                "starting demoted (leadership belongs to the takeover)"
            )

    def _spawn_native(self, binary: str, host: str, port: int) -> None:
        # the server prints "LISTENING <port>\n" once bound
        self._proc = subprocess.Popen(
            [binary, host, str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        )
        line = self._proc.stdout.readline()
        if not line.startswith("LISTENING"):
            raise RuntimeError(f"native store server failed to start: {line!r}")
        self._addr = (host, int(line.split()[1]))

    @property
    def address(self) -> Tuple[str, int]:
        return self._addr

    @property
    def is_native(self) -> bool:
        return self._proc is not None

    @property
    def is_primary(self) -> bool:
        """False once this server has been fenced out of the write path
        (started standby, or demoted by a higher-generation peer)."""
        if self._server is None:
            return True  # native backend: always the base protocol
        with self._server.data_lock:
            return bool(self._server.primary)

    @property
    def generation(self) -> int:
        if self._server is None:
            return 0
        with self._server.data_lock:
            return int(self._server.generation)

    def stop(self) -> None:
        if self._server is not None:
            if self._server.replicator is not None:
                self._server.replicator.stop()
            self._server.shutdown()
            self._server.server_close()
            with self._server.data_lock:
                socks = list(self._server.live_socks)
                self._server.live_socks.clear()
            for sock in socks:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    sock.close()
                except OSError:
                    pass
            self._server = None
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
            self._proc = None


class TCPStore(Store):
    """Client for one store server (one connection, lock-guarded)."""

    def __init__(self, host: str, port: int, timeout_s: float = 30.0):
        self.host, self.port = host, int(port)
        self._sock = socket.create_connection((host, int(port)), timeout=timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()

    def _check_ack(self, ack: bytes) -> None:
        if ack == _U8.pack(ACK_FENCED):
            raise StoreFencedError(
                f"write fenced by {self.host}:{self.port} (demoted/standby "
                f"server — a newer store generation holds the write path)"
            )

    def set(self, key: str, value: Value) -> None:
        msg = _U8.pack(OP_SET) + _pack_bytes(key.encode()) + _pack_bytes(
            _to_bytes(value)
        )
        with self._lock:
            self._sock.sendall(msg)
            self._check_ack(_recv_exact(self._sock, 1))

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            self._sock.sendall(_U8.pack(OP_GET) + _pack_bytes(key.encode()))
            (present,) = _U8.unpack(_recv_exact(self._sock, 1))
            return _recv_bytes(self._sock) if present else None

    def mset(self, dictionary: Dict[str, Value]) -> None:
        parts = [_U8.pack(OP_MSET), _U32.pack(len(dictionary))]
        for k, v in dictionary.items():
            parts.append(_pack_bytes(k.encode()))
            parts.append(_pack_bytes(_to_bytes(v)))
        with self._lock:
            self._sock.sendall(b"".join(parts))
            self._check_ack(_recv_exact(self._sock, 1))

    def mget(self, keys: List[str]) -> List[Optional[bytes]]:
        parts = [_U8.pack(OP_MGET), _U32.pack(len(keys))]
        parts += [_pack_bytes(k.encode()) for k in keys]
        with self._lock:
            self._sock.sendall(b"".join(parts))
            (n,) = _U32.unpack(_recv_exact(self._sock, 4))
            out: List[Optional[bytes]] = []
            for _ in range(n):
                (present,) = _U8.unpack(_recv_exact(self._sock, 1))
                out.append(_recv_bytes(self._sock) if present else None)
            return out

    def num_keys(self) -> int:
        with self._lock:
            self._sock.sendall(_U8.pack(OP_NUM_KEYS))
            return _U64.unpack(_recv_exact(self._sock, 8))[0]

    def clear(self) -> None:
        with self._lock:
            self._sock.sendall(_U8.pack(OP_CLEAR))
            self._check_ack(_recv_exact(self._sock, 1))

    def generation(self) -> Tuple[bool, int]:
        """(is_primary, store generation) of the connected server.

        A pre-replication server drops the connection on the unknown op —
        surfaced as ``ConnectionError``, which callers treat as
        "generation 0, primary" when they want compatibility."""
        with self._lock:
            self._sock.sendall(_U8.pack(OP_GENERATION))
            (primary,) = _U8.unpack(_recv_exact(self._sock, 1))
            (gen,) = _U64.unpack(_recv_exact(self._sock, 8))
            return bool(primary), gen

    def dump(self) -> Tuple[bool, int, Dict[bytes, bytes]]:
        """(is_primary, generation, full KV copy) of the connected server
        — boot-time peer recovery and drill verification."""
        with self._lock:
            self._sock.sendall(_U8.pack(OP_DUMP))
            (primary,) = _U8.unpack(_recv_exact(self._sock, 1))
            (gen,) = _U64.unpack(_recv_exact(self._sock, 8))
            (n,) = _U32.unpack(_recv_exact(self._sock, 4))
            items = {}
            for _ in range(n):
                k = _recv_bytes(self._sock)
                items[k] = _recv_bytes(self._sock)
            return bool(primary), gen, items

    def promote(self, new_generation: int) -> Tuple[bool, int]:
        """Ask the server to take the write path at ``new_generation``.

        Returns ``(promoted, server_generation)``; ``promoted`` is False
        when the server already runs a generation >= ``new_generation``
        (the caller lost a promotion race — adopt the returned one)."""
        with self._lock:
            self._sock.sendall(
                _U8.pack(OP_PROMOTE) + _U64.pack(int(new_generation))
            )
            (status,) = _U8.unpack(_recv_exact(self._sock, 1))
            (gen,) = _U64.unpack(_recv_exact(self._sock, 8))
            return status == ACK_OK, gen

    def status(self) -> bool:
        try:
            with self._lock:
                self._sock.sendall(_U8.pack(OP_PING))
                _recv_exact(self._sock, 1)
            return True
        except (ConnectionError, OSError):
            return False

    def shutdown(self) -> None:
        """Ask the server to exit (for servers this client manages)."""
        try:
            with self._lock:
                self._sock.sendall(_U8.pack(OP_SHUTDOWN))
                _recv_exact(self._sock, 1)
        except (ConnectionError, OSError):
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class TCPClusterStore(ClusterStore):
    """Hash-sharded view over several TCP stores.

    ``hosts``: list of ``{"host": ..., "port": ...}`` dicts (same bootstrap
    shape the reference's RedisStore takes).  When ``hosts`` is None, spawns
    ``num_shards`` local servers (the single-host convenience path).
    """

    def __init__(self, hosts=None, num_shards: int = 1, backend: str = "auto"):
        self._servers: List[TCPStoreServer] = []
        if hosts is None:
            for _ in range(max(1, num_shards)):
                self._servers.append(TCPStoreServer(backend=backend))
            hosts = [
                {"host": s.address[0], "port": s.address[1]}
                for s in self._servers
            ]
        clients = [TCPStore(h["host"], int(h["port"])) for h in hosts]
        super().__init__(clients)

    def shutdown(self) -> None:
        if self._servers:  # only kill servers we spawned
            super().shutdown()
            for s in self._servers:
                s.stop()
            self._servers = []


def start_tcp_store(host: str = "127.0.0.1", port: int = 0,
                    backend: str = "auto") -> TCPStoreServer:
    """Spawn a store server and return it (its ``.address`` is connectable)."""
    return TCPStoreServer(host, port, backend=backend)
