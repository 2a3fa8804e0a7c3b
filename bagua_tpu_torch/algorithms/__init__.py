from .async_model_average import AsyncModelAverageAlgorithm  # noqa: F401
from .base import Algorithm, AlgorithmContext  # noqa: F401
from .bytegrad import ByteGradAlgorithm  # noqa: F401
from .decentralized import (  # noqa: F401
    DecentralizedAlgorithm,
    LowPrecisionDecentralizedAlgorithm,
    shift_one_peer,
)
from .gradient_allreduce import GradientAllReduceAlgorithm  # noqa: F401
from .q_adam import QAdamAlgorithm, QAdamOptState  # noqa: F401
from .zero import ZeroOptimizerAlgorithm, ZeroOptState  # noqa: F401

#: Families the autotuner (and the fleet autopilot's escalation ladder,
#: through the same recommendation path) may switch between at a check-in.
#: Stateless replicated trainer-owned-optimizer families
#: (gradient_allreduce, bytegrad) swap freely; QAdam is switchable through
#: the trainer's state-migration adapter (its momenta are param-shaped, so
#: they are adopted from a torch Adam-family optimizer's ``exp_avg`` and
#: ``exp_avg_sq`` — or start from zeros — and its warmup contract is
#: re-anchored at the switch step; see
#: ``BaguaTrainer._prepare_state_migration``).  Async model averaging
#: keeps one replica a rank, as the port's every family does, so entering
#: it needs no re-layout; leaving it takes one synchronous catch-up average
#: of the weights and the optimizer state
#: (``BaguaTrainer._prepare_replication_migration``) — but only from
#: families that neither own the optimizer nor keep flat-resident state,
#: on pure-dp meshes.  Sharded-opt-state families (ZeRO) change the state
#: layout irreversibly and must be chosen up front.
SWITCHABLE_ALGORITHMS = {
    "gradient_allreduce": lambda hierarchical: GradientAllReduceAlgorithm(
        hierarchical=hierarchical
    ),
    "bytegrad": lambda hierarchical: ByteGradAlgorithm(hierarchical=hierarchical),
    # short warmup: the tuner samples this config for ~100 steps, so the
    # compressed phase must begin well inside the scoring window
    "qadam": lambda hierarchical: QAdamAlgorithm(
        warmup_steps=20, hierarchical=hierarchical
    ),
    # mid-run entry needs no warmup (the run is already warmed up) and no
    # hierarchical flag (averaging rounds are whole-model allreduces);
    # period calibration starts fresh at the switch step
    "async": lambda hierarchical: AsyncModelAverageAlgorithm(
        warmup_steps=0
    ),
}
