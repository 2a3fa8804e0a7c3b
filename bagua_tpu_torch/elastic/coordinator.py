"""Rendezvous rounds: admit within a join window, decide the world size,
assign dense ranks, publish the spec.

Port of ``bagua_tpu/elastic/coordinator.py`` (``:38-220``), unchanged in
behavior.

One round per restart attempt.  The coordinator is the launcher that hosts
the restart store (``--node_rank 0``); it is a fixed point — the store and
the workers' rendezvous (``MASTER_ADDR:MASTER_PORT``) live on its host, so
elasticity covers every OTHER node.  Round shape:

1. :meth:`ElasticCoordinator.run_round` bumps ``elastic/epoch`` (fencing
   out all attempt-N zombies), joins itself, then collects join requests.
2. The window closes early when all ``max_nnodes`` slots joined, or when
   every *expected* survivor of the previous attempt has re-registered
   (crash restarts don't pay the full window), otherwise at
   ``join_window_s``.  Below ``min_nnodes`` the coordinator keeps waiting —
   up to ``timeout_s``, then :class:`RendezvousTimeout`.
3. Admitted ids get dense node ranks in id order (the coordinator, id 0,
   is always rank 0, so the rendezvous address stays valid), and
   the :class:`~bagua_tpu_torch.elastic.membership.WorldSpec` is published.

Members call :func:`join_round`: register, poll for the spec, and either
get their rank or learn they were excluded (:class:`ExcludedFromRound` —
a node that missed the window is NOT hung on; it waits for the next epoch
and rejoins, which the coordinator notices mid-attempt and answers with a
coordinated resize at the next attempt boundary).
"""

from __future__ import annotations

import logging
import time
from typing import Iterable, List, Optional, Set

from .membership import MembershipClient, WorldSpec

logger = logging.getLogger("bagua_tpu_torch.elastic")


class RendezvousTimeout(RuntimeError):
    """The round could not assemble ``min_nnodes`` nodes in time."""


class ExcludedFromRound(RuntimeError):
    """This node joined after the window closed; the published world does
    not include it.  Wait for the next epoch and rejoin — do not hang."""

    def __init__(self, epoch: int, node_id: int, spec: WorldSpec):
        super().__init__(
            f"node {node_id} missed the join window of epoch {epoch}: the "
            f"round closed with {spec.nnodes} node(s) {sorted(spec.ranks)}; "
            "standing by for the next round"
        )
        self.epoch = epoch
        self.spec = spec


class Halted(RuntimeError):
    """The coordinator published a terminal verdict; stop rendezvousing."""

    def __init__(self, verdict: dict):
        super().__init__(f"job halted: {verdict.get('reason', '')}")
        self.verdict = verdict


class ElasticCoordinator:
    """Runs on the store-hosting launcher; owns epoch advancement and the
    per-round admit/decide/publish sequence."""

    def __init__(
        self,
        client: MembershipClient,
        min_nnodes: int,
        max_nnodes: int,
        master_addr: str,
        master_port: int,
        join_window_s: float = 30.0,
        timeout_s: float = 300.0,
        poll_s: float = 0.2,
    ):
        if not (1 <= min_nnodes <= max_nnodes):
            raise ValueError(
                f"need 1 <= min_nnodes <= max_nnodes, got "
                f"{min_nnodes}:{max_nnodes}"
            )
        self.client = client
        self.min_nnodes = int(min_nnodes)
        self.max_nnodes = int(max_nnodes)
        self.master_addr = master_addr
        self.master_port = int(master_port)
        self.join_window_s = float(join_window_s)
        self.timeout_s = float(timeout_s)
        self.poll_s = float(poll_s)

    def run_round(
        self, epoch: int, expect: Optional[Iterable[int]] = None
    ) -> WorldSpec:
        """Open epoch ``epoch``, admit joiners, publish and return the
        world spec.  ``expect``: node ids known to be coming back (the
        previous attempt's survivors) — once they have all joined the
        window closes early."""
        self.client.open_epoch(epoch)
        self.client.join(epoch)
        admitted = self._admit(epoch, set(expect) if expect else None)
        ranks = {nid: rank for rank, nid in enumerate(sorted(admitted))}
        spec = WorldSpec(
            epoch=int(epoch),
            ranks=ranks,
            min_nnodes=self.min_nnodes,
            max_nnodes=self.max_nnodes,
            master_addr=self.master_addr,
            master_port=self.master_port,
        )
        self.client.publish_world(spec)
        logger.info(
            "rendezvous epoch %d: admitted %d node(s) %s (window %.1fs, "
            "min:max %d:%d)", epoch, spec.nnodes, sorted(admitted),
            self.join_window_s, self.min_nnodes, self.max_nnodes,
        )
        return spec

    def _admit(self, epoch: int, expect: Optional[Set[int]]) -> List[int]:
        t0 = time.monotonic()
        window_end = t0 + self.join_window_s
        deadline = t0 + self.timeout_s
        while True:
            joined = self.client.joined_ids(epoch)
            now = time.monotonic()
            if len(joined) >= self.max_nnodes:
                return joined[: self.max_nnodes]
            # early close on expected survivors must still respect the MIN
            # floor: after a lease expiry the survivor set can be smaller
            # than min_nnodes, and assembling it would under-shrink the job
            if (
                expect is not None
                and expect.issubset(joined)
                and len(joined) >= self.min_nnodes
            ):
                return joined
            if now >= window_end and len(joined) >= self.min_nnodes:
                return joined
            if now >= deadline:
                raise RendezvousTimeout(
                    f"rendezvous epoch {epoch} timed out after "
                    f"{self.timeout_s:.0f}s with {len(joined)} node(s) "
                    f"{joined} joined; min_nnodes={self.min_nnodes} — "
                    "start more nodes or lower --nnodes MIN"
                )
            time.sleep(self.poll_s)

    def standby_ids(self, spec: WorldSpec) -> List[int]:
        """Mid-attempt scan: node ids that registered for the CURRENT epoch
        but are not members — standbys asking for a scale-up.  The caller
        forces a coordinated resize at the next attempt boundary."""
        return [
            i for i in self.client.joined_ids(spec.epoch)
            if i not in spec.ranks
        ]


def join_round(
    client: MembershipClient,
    epoch: int,
    timeout_s: float = 300.0,
    poll_s: float = 0.2,
) -> WorldSpec:
    """Member-side rendezvous: register for ``epoch`` (following the fence
    if the coordinator has already moved on) and poll for the published
    world.  Returns the spec this node is part of; raises
    :class:`ExcludedFromRound` when the round closed without it,
    :class:`RendezvousTimeout` when nothing is published in time, and
    :class:`Halted` when the job has a terminal verdict."""
    deadline = time.monotonic() + timeout_s
    client.join(epoch)
    while True:
        halt = client.read_halt()
        if halt is not None:
            raise Halted(halt)
        fence = client.current_epoch()
        if fence is not None and fence > epoch:
            # the round moved on while we were tearing down: re-register
            # under the live epoch (our old join key is fenced garbage)
            epoch = fence
            client.join(epoch)
            continue
        spec = client.read_world(epoch)
        if spec is not None:
            if client.node_id in spec.ranks:
                return spec
            raise ExcludedFromRound(epoch, client.node_id, spec)
        if time.monotonic() > deadline:
            raise RendezvousTimeout(
                f"node {client.node_id} waited {timeout_s:.0f}s for the "
                f"world spec of epoch {epoch} — coordinator gone or "
                "rendezvous wedged"
            )
        time.sleep(poll_s)


def wait_for_next_epoch(
    client: MembershipClient,
    after_epoch: int,
    timeout_s: float = 300.0,
    poll_s: float = 0.2,
) -> int:
    """Block until the coordinator opens an epoch newer than
    ``after_epoch`` (or the job halts).  Used by excluded/standby nodes and
    by survivors waiting out a teardown."""
    deadline = time.monotonic() + timeout_s
    while True:
        halt = client.read_halt()
        if halt is not None:
            raise Halted(halt)
        fence = client.current_epoch()
        if fence is not None and fence > after_epoch:
            return fence
        if time.monotonic() > deadline:
            raise RendezvousTimeout(
                f"no epoch after {after_epoch} opened within "
                f"{timeout_s:.0f}s — coordinator gone"
            )
        time.sleep(poll_s)
