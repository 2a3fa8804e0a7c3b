"""Coordinator failover: multi-endpoint restart-store client + leadership.

Port of ``bagua_tpu/elastic/failover.py`` (``:70-609``) over the port's own
store client and replicated server
(:mod:`bagua_tpu_torch.contrib.utils.tcp_store`), unchanged in behavior.

The restart TCPStore is the substrate under every recovery path (leases,
stop events and, in the JAX package, autopilot state and historian rings) — and
until this module it lived in exactly one launcher process.  Failover has
three cooperating parts:

* **Replicated store** (:mod:`bagua_tpu_torch.contrib.utils.tcp_store`): the
  primary server streams its op log (snapshot fallback) to follower
  servers on standby nodes, with a monotonic *store generation* fencing
  any stale primary out of the write path after a takeover.

* **:class:`FailoverStore`** (here): a priority-ordered multi-endpoint
  client (``BAGUA_RESTART_STORE_ENDPOINTS``).  Every op runs under a
  per-op deadline budget (``BAGUA_RESTART_STORE_OP_DEADLINE_S``) and
  retries across reconnects and endpoint failovers with jittered backoff,
  never adopting a server whose generation is below the highest this
  client has seen.  With a single endpoint it degrades to exactly the old
  reconnect-and-retry client (plus the deadline budget).

* **Coordinator leadership** (here): leadership is a lease *in the store
  itself* (``coord/lease``, deliberately outside the epoch-fenced
  keyspace).  The active coordinator renews it from a
  :class:`CoordinatorLeaseKeeper` thread; each standby runs a
  :class:`StandbyCoordinatorWatch` that tracks renewals on its OWN
  monotonic clock and, after a full TTL of silence (staggered by standby
  index so takeovers don't race), promotes the store generation and
  claims the lease.  The store promotion doubles as the election lock:
  only one standby's ``PROMOTE`` can win a given generation.

This module imports no torch: launchers and heartbeat threads consume it.
"""

from __future__ import annotations

import json
import logging
import random
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple, Union

from .. import env as _env
from ..contrib.utils.tcp_store import StoreFencedError, TCPStore
from ..faults import inject as _inject
from ..telemetry import counters

logger = logging.getLogger(__name__)

__all__ = [
    "COORD_LEASE_KEY", "Endpoint", "FailoverStore", "StoreOpDeadlineError",
    "CoordinatorLeaseKeeper", "StandbyCoordinatorWatch",
    "parse_endpoint", "parse_endpoints", "read_coord_lease",
    "write_coord_lease",
]

Endpoint = Tuple[str, int]

#: leadership lease key — OUTSIDE the epoch-fenced ``elastic/<e>/`` keyspace
#: so it survives takeover and rendezvous epochs alike
COORD_LEASE_KEY = "coord/lease"

#: errors one store op retries through (mirrors run.py's
#: ``_STORE_RETRY_ERRORS`` minus the futures timeout nobody raises here)
_RETRYABLE = (ConnectionError, OSError, TimeoutError)


def parse_endpoint(spec: Union[str, Endpoint]) -> Endpoint:
    if isinstance(spec, tuple):
        return spec[0], int(spec[1])
    host, port = spec.rsplit(":", 1)
    return host.strip(), int(port)


def parse_endpoints(specs: Sequence[Union[str, Endpoint]]) -> List[Endpoint]:
    eps = [parse_endpoint(s) for s in specs]
    if not eps:
        raise ValueError("empty restart-store endpoint list")
    return eps


class StoreOpDeadlineError(ConnectionError):
    """One store op exhausted its total retry budget
    (``BAGUA_RESTART_STORE_OP_DEADLINE_S``) across reconnects and endpoint
    failovers.  A ``ConnectionError`` subclass: the callers' store-down
    backoff paths already handle it — the budget just guarantees they get
    the chance to, instead of the op retrying forever inside a watchdog
    section."""


class FailoverStore:
    """Priority-ordered multi-endpoint restart-store client.

    Acquisition prefers, in order: a reachable *primary* endpoint, else
    any reachable endpoint (a follower serves reads; its write fence ack
    turns into a retry here until a standby coordinator promotes it).
    Servers running a generation below the highest this client has seen
    are refused outright — the client-side half of the generation fence:
    after a takeover this client can never fall back onto the stale
    primary, reachable or not.

    Thread-safe the same way :class:`TCPStore` is: one op at a time under
    an internal lock.  Heartbeat threads construct their own instance
    (one connection per thread), exactly as they did with the raw client.
    """

    def __init__(self, endpoints: Sequence[Union[str, Endpoint]],
                 connect_timeout_s: float = 60.0,
                 op_deadline_s: Optional[float] = None,
                 client_timeout_s: float = 30.0):
        self._endpoints = parse_endpoints(endpoints)
        self._multi = len(self._endpoints) > 1
        self._client_timeout_s = float(client_timeout_s)
        if op_deadline_s is None:
            op_deadline_s = _env.get_restart_store_op_deadline_s()
        self._op_deadline_s = float(op_deadline_s)
        self._lock = threading.Lock()
        self._idx = 0
        self._gen = 0
        self._client: Optional[TCPStore] = None
        self._suspect = False  # current endpoint known-bad: fail over first
        self._acquire(time.monotonic() + float(connect_timeout_s))

    # -- properties / introspection --

    @property
    def endpoint(self) -> Endpoint:
        with self._lock:
            return self._endpoints[self._idx]

    @property
    def generation(self) -> int:
        """Highest store generation this client has observed."""
        with self._lock:
            return self._gen

    def status(self) -> bool:
        try:
            self._run_op("ping", lambda c: c.status())
            return True
        except _RETRYABLE:
            return False

    def close(self) -> None:
        with self._lock:
            client, self._client = self._client, None
        self._close_client(client)

    @staticmethod
    def _close_client(client: Optional[TCPStore]) -> None:
        if client is not None:
            try:
                client._sock.close()
            except OSError:
                pass

    # -- connection management --
    #
    # Lock discipline: ``self._lock`` guards only the shared fields
    # (_client, _idx, _gen, _suspect) and is never held across socket IO
    # or backoff sleeps.  (Re)connection runs snapshot -> probe outside
    # the lock -> commit: a concurrent op's brief critical section never
    # wedges behind a multi-second endpoint scan.

    def _probe(self, idx: int, gen: int,
               timeout_s: float) -> Tuple[TCPStore, bool, int]:
        """Connect endpoint ``idx``; returns (client, is_primary,
        highest generation seen).  Pure IO — no shared state is touched.
        Raises ``_RETRYABLE`` on unreachable and ``StoreFencedError`` on a
        server whose generation is below ``gen`` (the client-side half of
        the generation fence)."""
        host, port = self._endpoints[idx]
        client = TCPStore(host, port, timeout_s=timeout_s)
        if not self._multi:
            # single-store mode: no generation probe — byte-identical to
            # the pre-replication client (and compatible with the native
            # C++ server, which drops unknown ops)
            return client, True, gen
        primary, sgen = client.generation()
        if sgen < gen:
            try:
                client._sock.close()
            except OSError:
                pass
            raise StoreFencedError(
                f"store {host}:{port} runs stale generation {sgen} < "
                f"{gen} (refusing a demoted primary)"
            )
        return client, primary, max(gen, sgen)

    def _acquire(self, deadline: float) -> None:
        """(Re)connect to the best endpoint.  Connect attempts and
        backoff sleeps run outside the lock."""
        with self._lock:
            prev_idx = self._idx
            gen = self._gen
            suspect = self._suspect
            old, self._client = self._client, None
        self._close_client(old)
        delay = 0.1
        attempts = 0
        last_err: Optional[BaseException] = None
        while True:
            order = list(range(len(self._endpoints)))
            # a suspect endpoint (injected failover, repeated errors) goes
            # LAST so the scan lands elsewhere first
            start = (prev_idx + 1) % len(order) if suspect else prev_idx
            order = order[start:] + order[:start]
            fallback: Optional[Tuple[int, TCPStore]] = None
            for idx in order:
                budget = deadline - time.monotonic()
                if budget <= 0:
                    break
                try:
                    client, primary, gen = self._probe(
                        idx, gen, timeout_s=max(0.5, min(5.0, budget))
                    )
                except (*_RETRYABLE, StoreFencedError) as e:
                    last_err = e
                    attempts += 1
                    continue
                if primary:
                    if fallback is not None:
                        try:
                            fallback[1]._sock.close()
                        except OSError:
                            pass
                    self._adopt(idx, client, gen, prev_idx)
                    return
                if fallback is None:
                    fallback = (idx, client)
                else:
                    try:
                        client._sock.close()
                    except OSError:
                        pass
            if fallback is not None:
                # no primary anywhere (takeover in flight): a follower
                # serves reads; writes fence -> the op loop retries
                self._adopt(fallback[0], fallback[1], gen, prev_idx)
                return
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                eps = ",".join(f"{h}:{p}" for h, p in self._endpoints)
                raise ConnectionError(
                    f"restart store [{eps}] unreachable after "
                    f"{attempts} attempt(s) "
                    f"(last error: {type(last_err).__name__}: {last_err})"
                ) from last_err
            # jittered exponential backoff: after a gang restart every
            # node re-dials at the same instant — de-synchronize the herd
            time.sleep(min(delay * (0.5 + random.random()), remaining))
            delay = min(delay * 2, 5.0)

    def _adopt(self, idx: int, client: TCPStore, gen: int,
               prev_idx: int) -> None:
        """Commit a probed connection; racing committers are safe — the
        later commit closes the earlier one's client, whose in-flight op
        (if any) surfaces a socket error and retries."""
        with self._lock:
            old, self._client = self._client, client
            self._gen = max(self._gen, gen)
            self._suspect = False
            if idx != prev_idx:
                self._idx = idx
        self._close_client(old)
        if idx != prev_idx:
            counters.incr("store/failovers")
            host, port = self._endpoints[idx]
            logger.warning(
                "restart store failed over to endpoint %d (%s:%d, "
                "generation %d)", idx, host, port, gen,
            )

    # -- promotion (the takeover path's half of the generation fence) --

    def promote_store(self) -> bool:
        """Bump the first reachable endpoint (priority order) to primary at
        ``generation + 1``.  The promotion is the election lock: exactly
        one caller's PROMOTE wins a given generation — a False return
        means a peer (or the old primary, alive after all) already runs an
        equal/higher generation, and the caller must NOT take leadership.
        Only coordinator takeover calls this; ordinary clients never
        promote (a worker with a flaky NIC must not fence out a healthy
        primary)."""
        with self._lock:
            prev_idx = self._idx
            gen = self._gen
        try:
            for idx in range(len(self._endpoints)):
                try:
                    client, primary, gen = self._probe(idx, gen,
                                                       timeout_s=5.0)
                except (*_RETRYABLE, StoreFencedError):
                    continue
                if primary and self._multi:
                    # a live primary at (at least) our generation: nothing
                    # to promote — the caller lost the race / was wrong
                    try:
                        client._sock.close()
                    except OSError:
                        pass
                    return False
                try:
                    promoted, sgen = client.promote(gen + 1)
                except _RETRYABLE:
                    try:
                        client._sock.close()
                    except OSError:
                        pass
                    continue
                gen = max(gen, sgen)
                if promoted:
                    counters.incr("store/promotions")
                    with self._lock:
                        old, self._client = self._client, client
                        self._gen = max(self._gen, gen)
                        self._suspect = False
                        self._idx = idx
                    self._close_client(old)
                    host, port = self._endpoints[idx]
                    logger.warning(
                        "restart store: promoted %s:%d to primary "
                        "(generation %d)", host, port, sgen,
                    )
                    if idx != prev_idx:
                        counters.incr("store/failovers")
                    return True
                try:
                    client._sock.close()
                except OSError:
                    pass
                return False  # lost the promotion race
            return False
        finally:
            # record the highest generation observed even on a lost
            # election — the fence must never move backwards
            with self._lock:
                self._gen = max(self._gen, gen)

    # -- the op loop: fault hooks, deadline budget, failover retries --

    def _run_op(self, opname: str, fn: Callable[[TCPStore], object]):
        deadline = (
            time.monotonic() + self._op_deadline_s
            if self._op_deadline_s > 0 else float("inf")
        )
        retried = False
        injected = False
        while True:
            try:
                _inject.maybe_raise_store_error(opname)  # chaos: store.op
                try:
                    # chaos: store.failover declares the CURRENT endpoint
                    # dead — the retry must land on a different one
                    _inject.maybe_raise_store_error(
                        opname, point="store.failover")
                except _inject.InjectedFault:
                    with self._lock:
                        self._suspect = True
                    raise
                with self._lock:
                    client = self._client
                    if client is None:
                        raise ConnectionError("restart store disconnected")
                result = fn(client)
                if retried:
                    logger.info("restart store %s succeeded after retry",
                                opname)
                if injected:
                    _inject.record_recovery("store.op")
                    _inject.record_recovery("store.failover")
                return result
            except StoreFencedError as e:
                counters.incr("store/fenced_writes")
                self._handle_error(opname, e, deadline)
                # a fence means a takeover is IN FLIGHT (every reachable
                # endpoint is a follower, or a stale primary just got
                # demoted under us): reacquisition lands straight back on
                # a follower, so without a pause this loop spins at socket
                # speed until the standby promotes — wait a poll interval
                time.sleep(min(0.25 * (0.5 + random.random()),
                               max(0.0, deadline - time.monotonic())))
                retried = True
            except _RETRYABLE as e:
                injected = injected or isinstance(e, _inject.InjectedFault)
                self._handle_error(opname, e, deadline)
                retried = True

    def _handle_error(self, opname: str, err: BaseException,
                      deadline: float) -> None:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            counters.incr("store/op_deadline_exceeded")
            raise StoreOpDeadlineError(
                f"restart store {opname} exhausted its "
                f"{self._op_deadline_s:.0f}s retry budget "
                f"(last error: {type(err).__name__}: {err})"
            ) from err
        logger.warning(
            "restart store %s failed (%s: %s); retrying "
            "(%.0fs of budget left)",
            opname, type(err).__name__, err, remaining,
        )
        try:
            self._acquire(deadline)
        except _RETRYABLE as e:
            # reacquisition ran the budget out: surface it as the deadline,
            # not as one more anonymous connect failure
            counters.incr("store/op_deadline_exceeded")
            raise StoreOpDeadlineError(
                f"restart store {opname} exhausted its "
                f"{self._op_deadline_s:.0f}s retry budget reconnecting "
                f"(last error: {type(e).__name__}: {e})"
            ) from e

    # -- Store surface --

    def set(self, key, value):
        return self._run_op(f"set({key!r})", lambda c: c.set(key, value))

    def get(self, key):
        return self._run_op(f"get({key!r})", lambda c: c.get(key))

    def mset(self, dictionary):
        return self._run_op(
            f"mset[{len(dictionary)}]", lambda c: c.mset(dictionary))

    def mget(self, keys):
        return self._run_op(f"mget[{len(keys)}]", lambda c: c.mget(keys))

    def num_keys(self):
        return self._run_op("num_keys", lambda c: c.num_keys())


# ---------------------------------------------------------------------------
# Coordinator leadership lease
# ---------------------------------------------------------------------------


def write_coord_lease(store, node_id: int, seq: int,
                      generation: int = 0) -> None:
    store.set(COORD_LEASE_KEY, json.dumps(
        {"node": int(node_id), "seq": int(seq), "gen": int(generation)}
    ))


def read_coord_lease(store) -> Optional[dict]:
    """Parsed leadership lease, or None (never held / unparseable)."""
    raw = store.get(COORD_LEASE_KEY)
    if raw is None:
        return None
    try:
        if isinstance(raw, bytes):
            raw = raw.decode()
        lease = json.loads(raw)
        return lease if isinstance(lease, dict) else None
    except (ValueError, UnicodeDecodeError):
        return None


class CoordinatorLeaseKeeper:
    """Renews the leadership lease from its own thread + connection at
    ``ttl_s / 3`` (same cadence logic as the member heartbeats).  Renewal
    errors are logged and retried next tick — a transient store blip must
    not make the ACTIVE coordinator look dead longer than it was."""

    def __init__(self, connect: Callable[[], object], node_id: int,
                 ttl_s: float, generation: int = 0, start_seq: int = 0):
        self._connect = connect
        self._node_id = int(node_id)
        self._ttl_s = float(ttl_s)
        self._generation = int(generation)
        self._seq = int(start_seq)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="coord-lease-keeper")

    def start(self) -> "CoordinatorLeaseKeeper":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def _run(self) -> None:
        store = None
        while not self._stop.is_set():
            try:
                if store is None:
                    store = self._connect()
                self._seq += 1
                write_coord_lease(
                    store, self._node_id, self._seq, self._generation)
            except _RETRYABLE as e:
                logger.warning("coordinator lease renewal failed: %s", e)
                store = None  # reconnect on the next tick
            self._stop.wait(max(0.2, self._ttl_s / 3.0))


class StandbyCoordinatorWatch:
    """Standby-side leadership watch + takeover trigger.

    Tracks ``(node, seq)`` changes of the leadership lease on this
    process's OWN monotonic clock (no cross-host time comparison — the
    exact discipline :class:`LeaseTracker` uses for member leases).  After
    ``ttl_s`` of silence plus a per-standby stagger (standby 1 moves
    first; ties between standbys are broken by index, not by racing), it
    attempts takeover:

    1. :meth:`FailoverStore.promote_store` — the election lock.  Losing it
       (False) means another standby promoted first or the primary is
       alive after all: reset the staleness clock and keep watching.
    2. Claim the lease under our node id and fire ``on_promoted``.

    An unreadable lease (every endpoint down) does NOT advance staleness:
    takeover requires positive evidence the group is reachable — if this
    standby can't reach any store endpoint, the partition is on OUR side
    and promoting would mint exactly the double-primary the generation
    fence exists to stop."""

    def __init__(self, store: FailoverStore, node_id: int,
                 standby_index: int, ttl_s: float,
                 on_promoted: Optional[Callable[[], None]] = None,
                 poll_s: Optional[float] = None):
        self._store = store
        self._node_id = int(node_id)
        self._ttl_s = float(ttl_s)
        self._stagger_s = max(0, int(standby_index) - 1) * \
            max(0.5, float(ttl_s) / 4.0)
        self._poll_s = float(poll_s) if poll_s is not None \
            else max(0.2, float(ttl_s) / 4.0)
        self._on_promoted = on_promoted
        self._promoted = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="coord-standby-watch")

    def start(self) -> "StandbyCoordinatorWatch":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    @property
    def promoted(self) -> bool:
        """True once THIS standby took the coordinator role over."""
        return self._promoted.is_set()

    @property
    def store(self) -> FailoverStore:
        """The watch's own store client — after promotion it holds the
        new generation (the main client may not have failed over yet)."""
        return self._store

    def _run(self) -> None:
        last: Optional[Tuple[int, int]] = None
        changed_at = time.monotonic()
        while not self._stop.is_set():
            self._stop.wait(self._poll_s)
            if self._stop.is_set():
                return
            try:
                lease = read_coord_lease(self._store)
            except _RETRYABLE as e:
                logger.debug("coordinator lease unreadable: %s", e)
                continue  # no positive evidence: staleness clock holds
            now = time.monotonic()
            seen = None if lease is None \
                else (int(lease.get("node", -1)), int(lease.get("seq", -1)))
            if seen != last:
                last = seen
                changed_at = now
                continue
            if now - changed_at <= self._ttl_s + self._stagger_s:
                continue
            if last is not None and last[0] == self._node_id:
                continue  # our own stale claim: nothing to take over
            logger.warning(
                "coordinator lease stale for %.1fs (holder %s); standby %d "
                "attempting takeover", now - changed_at,
                "nobody" if last is None else f"node {last[0]}",
                self._node_id,
            )
            if not self._store.promote_store():
                # lost the election (peer promoted, or the primary is
                # alive at a fresh generation): restart the clock
                last = None
                changed_at = time.monotonic()
                continue
            try:
                write_coord_lease(
                    self._store, self._node_id, 0,
                    self._store.generation)
            except _RETRYABLE as e:
                logger.warning("lease claim after promotion failed: %s", e)
            counters.incr("coord/takeovers")
            self._promoted.set()
            if self._on_promoted is not None:
                try:
                    self._on_promoted()
                except Exception:  # noqa: BLE001 - promotion must stand
                    logger.exception("on_promoted callback failed")
            return
