"""Lease-based node registry on the restart KV store.

Port of ``bagua_tpu/elastic/membership.py`` (``:66-616``): the same key
schema, the same ``WorldSpec`` JSON and the same heartbeat wire format, so a
node of either package reads the other's keys.  The health snapshot carries
the health counters and, in a training process, the per-rank obs summary
under ``obs``.

The store (``contrib.utils.tcp_store``) is a plain KV service: no TTLs, no
deletes, no key scans, no compare-and-swap.  The registry builds leases and
fencing out of what it does have:

* **Epoch fencing** — every key is namespaced by the rendezvous epoch
  (= restart attempt number): ``elastic/<epoch>/...``.  A zombie launcher
  or worker from attempt N keeps writing into N's keyspace, which nobody
  reads once the coordinator has bumped ``elastic/epoch`` to N+1 — stale
  writers cannot corrupt the next attempt, they only talk to themselves.
* **Enumerable node ids** — a node's stable identity is its launcher's
  ``--node_rank`` in ``[0, max_nnodes)``.  The store cannot list keys, but
  the coordinator can ``mget`` all ``max_nnodes`` possible slots, which
  makes membership scans one round-trip.
* **Leases without synchronized clocks** — members write a monotonically
  increasing heartbeat *sequence number*; the coordinator timestamps each
  observed change with ITS OWN clock and expires a lease when the sequence
  has not advanced for ``ttl_s``.  No cross-host clock comparison ever
  happens, so clock skew cannot produce false expiries.

Key layout (all under the restart store)::

    elastic/epoch                current epoch, coordinator-owned (fence)
    elastic/halt                 terminal verdict {code, reason} — job over
    elastic/<e>/join/<id>        join request {node_id, host, pid}
    elastic/<e>/world            published WorldSpec (see class below)
    elastic/<e>/hb/<id>          heartbeat sequence number — either the bare
                                 integer or ``{"seq": n, "health": {...}}``
                                 when the node publishes a health payload
                                 (grad-guard / async-staleness event counts)
    elastic/<e>/stop             first stop event of the attempt
                                 {kind, node, reason}; kinds: fail,
                                 lease_expired, leave, resize, health_fenced
    elastic/<e>/leave/<id>       leave intent (deliberate departure —
                                 watchdog exit, SIGINT — vs a silent hang)
    elastic/<e>/done/<id>        clean completion marker
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .. import env as _env
from ..faults import inject as _inject
from ..telemetry import counters as _counters

logger = logging.getLogger("bagua_tpu_torch.elastic")

# stop-event kinds (the first event of an attempt wins; every launcher
# tears its gang down on whichever it observes)
STOP_FAIL = "fail"                    # a worker crashed
STOP_LEASE_EXPIRED = "lease_expired"  # a node's launcher went silent
STOP_LEAVE = "leave"                  # deliberate departure (watchdog, ^C)
STOP_RESIZE = "resize"                # standby joined; regroup at n+standby
STOP_HEALTH = "health_fenced"         # heartbeat health payload over limit


def _k_epoch() -> str:
    return "elastic/epoch"


def _k_halt() -> str:
    return "elastic/halt"


def _k_join(epoch: int, node_id: int) -> str:
    return f"elastic/{epoch}/join/{node_id}"


def _k_world(epoch: int) -> str:
    return f"elastic/{epoch}/world"


def _k_hb(epoch: int, node_id: int) -> str:
    return f"elastic/{epoch}/hb/{node_id}"


def _k_stop(epoch: int) -> str:
    return f"elastic/{epoch}/stop"


def _k_leave(epoch: int, node_id: int) -> str:
    return f"elastic/{epoch}/leave/{node_id}"


def _k_done(epoch: int, node_id: int) -> str:
    return f"elastic/{epoch}/done/{node_id}"


@dataclass
class WorldSpec:
    """The renegotiated world published by the coordinator for one epoch:
    which node ids are in, and the dense rank each one got."""

    epoch: int
    ranks: Dict[int, int]  # stable node id -> dense node rank
    min_nnodes: int
    max_nnodes: int
    master_addr: str
    master_port: int

    @property
    def nnodes(self) -> int:
        return len(self.ranks)

    def rank_of(self, node_id: int) -> Optional[int]:
        return self.ranks.get(node_id)

    def to_json(self) -> str:
        d = dict(self.__dict__)
        d["ranks"] = {str(k): v for k, v in self.ranks.items()}
        return json.dumps(d)

    @classmethod
    def from_json(cls, raw: bytes) -> "WorldSpec":
        d = json.loads(raw)
        d["ranks"] = {int(k): int(v) for k, v in d["ranks"].items()}
        return cls(**d)


class MembershipClient:
    """Typed view of the elastic keyspace over any store exposing
    ``set``/``get``/``mget`` (the launcher's reconnecting ``_RestartStore``
    or a raw :class:`~bagua_tpu_torch.contrib.utils.tcp_store.TCPStore`)."""

    def __init__(self, store, node_id: int, max_nnodes: int):
        self.store = store
        self.node_id = int(node_id)
        self.max_nnodes = int(max_nnodes)

    # -- epoch fence --------------------------------------------------------

    def current_epoch(self) -> Optional[int]:
        v = self.store.get(_k_epoch())
        return int(v) if v is not None else None

    def open_epoch(self, epoch: int) -> None:
        """Coordinator-only: advance the fence.  Readers of any older
        epoch's keyspace are now talking to the void."""
        self.store.set(_k_epoch(), str(int(epoch)))

    # -- join / world -------------------------------------------------------

    def join(self, epoch: int, info: Optional[dict] = None) -> None:
        payload = {
            "node_id": self.node_id,
            "host": socket.gethostname(),
            "pid": os.getpid(),
        }
        if info:
            payload.update(info)
        self.store.set(_k_join(epoch, self.node_id), json.dumps(payload))

    def joined_ids(self, epoch: int) -> List[int]:
        keys = [_k_join(epoch, i) for i in range(self.max_nnodes)]
        vals = self.store.mget(keys)
        return [i for i, v in enumerate(vals) if v is not None]

    def publish_world(self, spec: WorldSpec) -> None:
        self.store.set(_k_world(spec.epoch), spec.to_json())

    def read_world(self, epoch: int) -> Optional[WorldSpec]:
        v = self.store.get(_k_world(epoch))
        return WorldSpec.from_json(v) if v is not None else None

    # -- heartbeats ---------------------------------------------------------

    def beat(self, epoch: int, seq: int,
             health: Optional[dict] = None) -> None:
        """Publish this node's heartbeat.  ``health`` (optional) rides the
        same key as a JSON payload — the cheapest channel to the
        coordinator that already exists and already has freshness
        semantics: a stale health report expires with its lease."""
        if health is None:
            payload = str(int(seq))
        else:
            payload = json.dumps({"seq": int(seq), "health": health})
        self.store.set(_k_hb(epoch, self.node_id), payload)

    @staticmethod
    def _parse_beat(v) -> Tuple[Optional[int], Optional[dict]]:
        """One heartbeat value -> (seq, health): accepts both the bare
        integer wire format (pre-health nodes keep working) and the JSON
        payload; unparseable values read as no-beat rather than crashing
        the monitor."""
        if v is None:
            return None, None
        try:
            return int(v), None
        except (TypeError, ValueError):
            pass
        try:
            d = json.loads(v)
            return int(d["seq"]), d.get("health")
        except (TypeError, ValueError, KeyError):
            logger.warning("unparseable heartbeat value %r ignored", v)
            return None, None

    def read_beats(self, epoch: int, node_ids: List[int]) -> Dict[int, Optional[int]]:
        return {
            i: seq
            for i, (seq, _) in self.read_beats_full(epoch, node_ids).items()
        }

    def read_beats_full(
        self, epoch: int, node_ids: List[int]
    ) -> Dict[int, Tuple[Optional[int], Optional[dict]]]:
        """Heartbeat sequence AND health payload per node (None, None for a
        node that never beat)."""
        vals = self.store.mget([_k_hb(epoch, i) for i in node_ids])
        return {i: self._parse_beat(v) for i, v in zip(node_ids, vals)}

    # -- stop / leave / done / halt ----------------------------------------

    def publish_stop(self, epoch: int, kind: str, node: int, reason: str,
                     rejoin: bool = True,
                     nodes: Optional[List[int]] = None) -> None:
        """``rejoin=False`` marks the named node(s) as NOT coming back
        (their launchers are gone — lease expiry, operator ^C), so the next
        round's early-close set excludes them instead of waiting the full
        window.  ``nodes`` names EVERY affected node when one event covers
        several (a rack loss expiring multiple leases in one poll);
        ``node`` stays the representative for logs."""
        self.store.set(
            _k_stop(epoch),
            json.dumps({"kind": kind, "node": int(node), "reason": reason,
                        "rejoin": bool(rejoin),
                        "nodes": [int(n) for n in (nodes or [node])]}),
        )

    def read_stop(self, epoch: int) -> Optional[dict]:
        v = self.store.get(_k_stop(epoch))
        return json.loads(v) if v is not None else None

    def publish_leave(self, epoch: int, reason: str) -> None:
        self.store.set(_k_leave(epoch, self.node_id), reason)

    def read_leave(self, epoch: int, node_id: int) -> Optional[str]:
        v = self.store.get(_k_leave(epoch, node_id))
        return v.decode() if v is not None else None

    def publish_done(self, epoch: int) -> None:
        self.store.set(_k_done(epoch, self.node_id), b"1")

    def done_ids(self, epoch: int, node_ids: List[int]) -> List[int]:
        vals = self.store.mget([_k_done(epoch, i) for i in node_ids])
        return [i for i, v in zip(node_ids, vals) if v is not None]

    def publish_halt(self, code: int, reason: str) -> None:
        self.store.set(
            _k_halt(), json.dumps({"code": int(code), "reason": reason})
        )

    def read_halt(self) -> Optional[dict]:
        v = self.store.get(_k_halt())
        return json.loads(v) if v is not None else None


# ---- health payload -------------------------------------------------------

#: telemetry counters that ride the heartbeat as the health payload: events
#: that mark a rank as a liability to the fleet (non-finite gradient steps
#: from the grad-guard sentinel, async model-average rounds the rank failed
#: to apply, its current staleness gauge)
_HEALTH_COUNTERS = {
    "grad_unhealthy": "grad_guard/unhealthy_steps",
    "grad_skipped": "grad_guard/skipped_steps",
    "async_missed": "async/missed_boundaries",
    "async_staleness": "async/staleness_max",
}


def local_health_snapshot() -> Optional[dict]:
    """This process's health payload from the telemetry counters — None
    when every counter is zero AND no obs summary exists, so idle or
    healthy non-training processes pay no payload bytes.  A training
    process also carries its per-rank fleet-view summary (``obs``: step,
    step-dt percentiles, staleness, skip counts;
    :func:`bagua_tpu_torch.obs.export.local_obs_summary`); the fence scalar
    (:func:`health_event_count`) ignores it."""
    snap = {k: _counters.get(name) for k, name in _HEALTH_COUNTERS.items()}
    snap = {k: v for k, v in snap.items() if v}
    try:
        from ..obs.export import local_obs_summary

        obs = local_obs_summary()
    except Exception:  # noqa: BLE001 - health snapshots must never die
        obs = None
    if obs:
        snap["obs"] = obs
    return snap or None


def health_event_count(health: Optional[dict]) -> int:
    """The scalar the coordinator fences on: how many times this rank hurt
    the fleet — non-finite-gradient steps plus missed async negotiation
    rounds (staleness gauges are a symptom, not an event count)."""
    if not health:
        return 0
    return int(health.get("grad_unhealthy", 0)) + int(
        health.get("async_missed", 0)
    )


def write_health_beacon(path: Optional[str] = None) -> bool:
    """Publish this process's health snapshot to the beacon file named by
    ``BAGUA_ELASTIC_HEALTH_FILE`` (launcher-injected) so the LAUNCHER's
    lease heartbeat — a different process — can carry it to the
    coordinator.  Atomic (tmp + ``os.replace``) and exception-free: the
    callers are the trainer's health paths, which must never die on a full
    disk.  No-op (False) when no beacon path is configured."""
    p = path or _env.get_elastic_health_file()
    if not p:
        return False
    try:
        snap = local_health_snapshot() or {}
        tmp = f"{p}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(snap, f)
        os.replace(tmp, p)
        return True
    except OSError as e:
        logger.debug("health beacon not written: %s", e)
        return False


def file_health_source(path: str) -> Callable[[], Optional[dict]]:
    """Health source reading a worker's beacon file — the launcher side of
    :func:`write_health_beacon`.  Missing/torn files read as healthy (the
    beacon only exists once something went wrong)."""

    def read() -> Optional[dict]:
        try:
            with open(path) as f:
                data = json.load(f)
            return data or None
        except (OSError, ValueError):
            return None

    return read


def merged_health_source(
    paths: List[str],
) -> Callable[[], Optional[dict]]:
    """Health source merging every local worker's beacon into one node
    payload (the launcher injects one beacon file PER local rank — a file
    shared across workers would be last-writer-wins, hiding all but one
    worker's events from the fence).  Event counts sum across workers;
    staleness gauges take the max; per-rank ``obs`` fleet-view summaries
    are kept side by side, keyed by each worker's global rank (the
    coordinator's fleet snapshot wants per-rank step/dt, not a sum)."""
    readers = [file_health_source(p) for p in paths]

    def read() -> Optional[dict]:
        merged: dict = {}
        for i, reader in enumerate(readers):
            snap = reader()
            if not snap:
                continue
            for key, val in snap.items():
                if key == "obs":
                    if isinstance(val, dict):
                        merged.setdefault("obs", {})[
                            str(val.get("rank", i))
                        ] = val
                elif key == "async_staleness":
                    merged[key] = max(int(merged.get(key, 0)), int(val))
                else:
                    merged[key] = int(merged.get(key, 0)) + int(val)
        return merged or None

    return read


class LeaseHeartbeat:
    """Per-node heartbeat thread: bumps this node's sequence number every
    ``interval_s`` on its OWN store connection (the monitor loop shares the
    launcher's main connection; a slow mget there must not delay beats).

    Epoch-fenced: each beat re-reads ``elastic/epoch`` and the thread stops
    itself the moment the coordinator has moved past the epoch it was
    started for — a zombie cannot keep a stale lease looking alive.

    Each beat also carries a **health payload** from ``health_source`` —
    default: this process's :func:`local_health_snapshot` (grad-guard and
    async-staleness event counters).  The launcher passes a
    :func:`file_health_source` reading the worker's beacon file instead.
    The coordinator's :class:`LeaseTracker` surfaces the payload and can
    fence chronically unhealthy members through the same stop/resize
    machinery that handles lease expiry."""

    def __init__(self, connect, node_id: int, epoch: int,
                 interval_s: float = 2.0, max_nnodes: int = 1,
                 health_source: Optional[Callable[[], Optional[dict]]] = None):
        self._connect = connect  # () -> store client
        self._node_id = int(node_id)
        self._epoch = int(epoch)
        self._interval_s = float(interval_s)
        self._max_nnodes = int(max_nnodes)
        self._health_source = (
            health_source if health_source is not None
            else local_health_snapshot
        )
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"bagua-elastic-hb-{node_id}", daemon=True
        )

    def start(self) -> "LeaseHeartbeat":
        self._thread.start()
        return self

    def _run(self) -> None:
        client = None
        seq = 0
        while not self._stop.wait(self._interval_s):
            try:
                if client is None:
                    client = MembershipClient(
                        self._connect(), self._node_id, self._max_nnodes
                    )
                fence = client.current_epoch()
                if fence is not None and fence != self._epoch:
                    logger.info(
                        "heartbeat: epoch moved %d -> %d; node %d stops "
                        "beating into the old keyspace",
                        self._epoch, fence, self._node_id,
                    )
                    return
                if _inject.should_drop_heartbeat():
                    # chaos: an armed ``elastic.heartbeat`` fault starves
                    # this node's lease (the sequence number stops
                    # advancing) without killing any process — the
                    # coordinator must expire it and shrink the world
                    continue
                try:
                    health = self._health_source()
                except Exception as e:  # noqa: BLE001 - beats must survive
                    logger.debug("health source failed: %s", e)
                    health = None
                seq += 1
                client.beat(self._epoch, seq, health=health)
            except (ConnectionError, OSError, TimeoutError):
                client = None  # reconnect on the next tick

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


@dataclass
class _LeaseState:
    seq: Optional[int] = None
    changed_at: float = field(default_factory=time.monotonic)


class LeaseTracker:
    """Coordinator-side lease bookkeeping: a member's lease expires when its
    heartbeat sequence stops advancing for ``ttl_s`` (measured on the
    coordinator's monotonic clock — no cross-host time comparison).  The
    first ``ttl_s`` after construction is a grace period: a member whose
    first beat is still in flight is not declared dead.

    Each poll also harvests the members' heartbeat **health payloads**
    (:meth:`health_of`); with ``fence_unhealthy_after`` set,
    :meth:`unhealthy_members` names members whose reported event count
    (:func:`health_event_count`) reached the limit — the monitor converts
    them into a ``health_fenced`` stop, reusing the exact epoch/resize
    machinery lease expiry rides.

    ``observe_only_ids`` are polled for health but never lease-expired:
    the coordinator cannot meaningfully expire its own lease (a dead
    launcher cannot run the monitor at all), but it CAN read its own
    heartbeat's health payload — without this the fence has a silent
    coverage hole on exactly the coordinator node."""

    def __init__(self, client: MembershipClient, epoch: int,
                 member_ids: List[int], ttl_s: float = 10.0,
                 fence_unhealthy_after: Optional[int] = None,
                 observe_only_ids: Optional[List[int]] = None):
        self._client = client
        self._epoch = int(epoch)
        self._ttl_s = float(ttl_s)
        self._leases = {int(i): _LeaseState() for i in member_ids}
        self._observe_only = [
            int(i) for i in (observe_only_ids or ())
            if int(i) not in self._leases
        ]
        self._health: Dict[int, dict] = {}
        self._grace_until = 0.0
        if fence_unhealthy_after is not None and fence_unhealthy_after < 1:
            fence_unhealthy_after = None
        self._fence_unhealthy_after = fence_unhealthy_after

    def rearm(self, grace_s: Optional[float] = None) -> None:
        """Re-arm every member lease against THIS tracker's clock.

        A promoted standby coordinator calls this at takeover: the dead
        primary's lease timestamps died with its process, and the members'
        heartbeats spent the failover window retrying against a fenced
        store — judging their last-seen sequence numbers as ``ttl_s`` old
        would mass-expire a perfectly healthy fleet.  Re-arming stamps
        every lease ``now`` and (with ``grace_s > ttl_s``) additionally
        suspends expiry until the takeover grace window has passed, giving
        queued heartbeats time to drain to the promoted store."""
        now = time.monotonic()
        for lease in self._leases.values():
            lease.changed_at = now
        if grace_s is not None and grace_s > self._ttl_s:
            self._grace_until = now + float(grace_s)
        _counters.incr("elastic/lease_rearms", len(self._leases))

    def poll(self) -> List[int]:
        """One scan; returns member ids whose lease has expired."""
        beats = self._client.read_beats_full(
            self._epoch, list(self._leases) + self._observe_only
        )
        now = time.monotonic()
        for node_id in self._observe_only:
            _seq, health = beats.get(node_id, (None, None))
            if health is not None:
                self._health[node_id] = health
        expired = []
        in_grace = now < self._grace_until
        for node_id, lease in self._leases.items():
            seq, health = beats.get(node_id, (None, None))
            if health is not None:
                self._health[node_id] = health
            if seq is not None and seq != lease.seq:
                lease.seq = seq
                lease.changed_at = now
            elif not in_grace and now - lease.changed_at > self._ttl_s:
                expired.append(node_id)
        return expired

    def wait_for_loss(self, timeout_s: float, poll_s: float) -> List[int]:
        """Poll until a member's lease expires (their ids returned), every
        member's heartbeat has advanced since the call (``[]``: nobody is
        lost) or ``timeout_s`` has passed (``[]``).  A launcher asks this
        after a local worker failed: a gloo survivor fails at its next
        collective the moment a peer dies, before that peer's lease can
        expire, and without the wait every lost node would read as a crash
        of the survivor's worker.  Store errors propagate."""
        if not self._leases:
            return []
        seen = {nid: lease.seq for nid, lease in self._leases.items()}
        deadline = time.monotonic() + timeout_s
        while True:
            expired = self.poll()
            if expired:
                return expired
            if (all(lease.seq != seen[nid] for nid, lease in self._leases.items())
                    or time.monotonic() > deadline):
                return []
            time.sleep(poll_s)

    def health_of(self, node_id: int) -> Optional[dict]:
        """Latest health payload observed for ``node_id`` (None = the node
        never reported one — healthy nodes publish nothing)."""
        return self._health.get(int(node_id))

    def unhealthy_members(self) -> List[int]:
        """Member ids whose reported health event count reached
        ``fence_unhealthy_after`` (empty when fencing is disabled)."""
        if self._fence_unhealthy_after is None:
            return []
        return [
            nid for nid in list(self._leases) + self._observe_only
            if health_event_count(self._health.get(nid))
            >= self._fence_unhealthy_after
        ]

    def expire_now(self, node_id: int) -> None:
        """Force-expire (test hook / explicit eviction); overrides any
        takeover grace window."""
        self._grace_until = 0.0
        self._leases[node_id].changed_at = -float("inf")


def publish_leave_intent(reason: str, timeout_s: float = 2.0) -> bool:
    """Best-effort leave intent from INSIDE a departing process, driven
    entirely by the ``BAGUA_ELASTIC_*`` env the launcher injected.  Called
    by the watchdog's abort path (and any other deliberate-exit path) so
    the coordinator can tell a purposeful departure from a silent hang.
    Bounded and exception-free: the caller is about to die and must not be
    delayed by a gone store."""
    addr = _env.get_elastic_store_addr()
    endpoints = _env.get_restart_store_endpoints()
    if not addr and not endpoints:
        return False
    try:
        from ..contrib.utils.tcp_store import TCPStore

        epoch = _env.get_elastic_epoch()
        node_id = _env.get_elastic_node_id()
        if endpoints:
            # replicated restart store: the primary may be mid-takeover
            # exactly when we are departing — the failover client walks
            # the endpoint list (and follows a fenced write to the new
            # primary) within the same bounded budget
            from .failover import FailoverStore

            store = FailoverStore(endpoints, connect_timeout_s=timeout_s,
                                  op_deadline_s=timeout_s,
                                  client_timeout_s=timeout_s)
            try:
                store.set(_k_leave(epoch, node_id), reason)
            finally:
                store.close()
        else:
            host, port = addr.rsplit(":", 1)
            store = TCPStore(host, int(port), timeout_s=timeout_s)
            try:
                store.set(_k_leave(epoch, node_id), reason)
            finally:
                try:
                    store._sock.close()
                except OSError:
                    pass
        logger.info("published leave intent (node %d, epoch %d): %s",
                    node_id, epoch, reason)
        return True
    except Exception as e:  # noqa: BLE001 - deliberately unconditional
        logger.debug("leave intent not published: %s", e)
        return False
