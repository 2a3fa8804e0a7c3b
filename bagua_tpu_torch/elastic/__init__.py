"""Elastic membership: lease-based rendezvous over the restart KV store,
world-size renegotiation between MIN and MAX nodes, and resize at restart
for the multi-node launcher.

Port of ``bagua_tpu/elastic`` with the same public names.  The reference gets
elasticity from torchelastic; here, as in the JAX package, each gang restart
is a *rendezvous round*: every surviving launcher re-registers with the
coordinator, whoever shows up within the join window is admitted
(``min_nnodes <= n <= max_nnodes``), dense node ranks are assigned, and the
gang respawns at the renegotiated world size, resuming from the checkpoint
(:meth:`~bagua_tpu_torch.BaguaTrainer.restore_checkpoint` converts across
worlds).

Modules:

* :mod:`.membership`: the node registry on the TCPStore: per-node heartbeat
  thread, TTL leases tracked coordinator-side, epoch-fenced keys, and the
  health payload (grad-guard and async-staleness event counters through the
  worker's beacon file) the coordinator can fence on
  (``BAGUA_ELASTIC_FENCE_UNHEALTHY``).
* :mod:`.coordinator`: rendezvous rounds.
* :mod:`.resize`: worker-side hooks (the renegotiated env, the restore onto
  the new world, the data shard's re-split).
* :mod:`.failover`: the multi-endpoint store client with generation-fenced
  failover (``BAGUA_RESTART_STORE_ENDPOINTS``), the coordinator's leadership
  lease and the standby watch that promotes a follower store.
"""

from .membership import (  # noqa: F401
    LeaseHeartbeat,
    LeaseTracker,
    MembershipClient,
    WorldSpec,
    file_health_source,
    health_event_count,
    local_health_snapshot,
    merged_health_source,
    publish_leave_intent,
    write_health_beacon,
)
from .coordinator import (  # noqa: F401
    ElasticCoordinator,
    ExcludedFromRound,
    Halted,
    RendezvousTimeout,
    join_round,
    wait_for_next_epoch,
)
from .resize import ElasticContext, elastic_restore, shard_bounds  # noqa: F401
from .failover import (  # noqa: F401
    CoordinatorLeaseKeeper,
    FailoverStore,
    StandbyCoordinatorWatch,
    StoreOpDeadlineError,
    parse_endpoints,
    read_coord_lease,
    write_coord_lease,
)
