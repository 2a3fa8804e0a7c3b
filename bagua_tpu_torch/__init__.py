"""bagua_tpu_torch: the PyTorch/CUDA port of bagua_tpu.

The same layout and public names as the JAX package, built on torch and
numpy alone: collectives over ``torch.distributed`` (NCCL on the card, gloo
on the CPU, or gloo through host memory for several ranks on one card) and
the JAX package's Pallas kernels rewritten by hand in CUDA for Hopper
(``ops/csrc``).  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""

from .version import __version__  # noqa: F401

from . import env  # noqa: F401
from .algorithms import (  # noqa: F401
    Algorithm,
    AlgorithmContext,
    AsyncModelAverageAlgorithm,
    ByteGradAlgorithm,
    DecentralizedAlgorithm,
    GradientAllReduceAlgorithm,
    LowPrecisionDecentralizedAlgorithm,
    QAdamAlgorithm,
    ZeroOptimizerAlgorithm,
    shift_one_peer,
)
from .bucket import BucketPlan, BucketSpec, split_bucket_by_bucket_size  # noqa: F401
from .checkpoint import (  # noqa: F401
    BaguaCheckpointManager,
    CheckpointIntegrityError,
    compute_state_digest,
    flush_all_checkpoints,
)
from .communication import (  # noqa: F401
    BaguaAborted,
    BaguaBackend,
    BaguaCommunicator,
    ReduceOp,
    abort,
    allgather,
    allgather_inplace,
    allreduce,
    allreduce_inplace,
    alltoall,
    alltoall_inplace,
    alltoall_v,
    barrier,
    broadcast,
    check_abort,
    gather,
    get_backend,
    init_process_group,
    is_aborted,
    reduce,
    reduce_scatter,
    reduce_scatter_inplace,
    reset_abort,
    scatter,
    send_recv,
)
from .core.backend import BaguaTrainer, TrainState  # noqa: F401
from .define import BaguaHyperparameter, TensorDeclaration, TensorDtype  # noqa: F401
from .env import get_local_rank, get_local_size, get_rank, get_world_size  # noqa: F401
from .models.generate import decode_model, generate, generate_tp  # noqa: F401
from .models.transformer import (  # noqa: F401
    KVCache,
    PagedKVCache,
    TransformerConfig,
    TransformerLM,
    bert_large_config,
    lm_loss_fn,
    sp_lm_loss_fn,
    tp_param_dim,
)
from .model_parallel.moe import (  # noqa: F401
    MoEMLP,
    globalize_expert_params,
    moe_lm_loss_fn,
)
from .ops.flash_attention import flash_attention, reference_attention  # noqa: F401
from .ops.gmm import gmm  # noqa: F401
from .parallel import (  # noqa: F401
    PipelinedTransformerLM,
    build_mesh,
    get_global_mesh,
    globalize_pp_params,
    globalize_tp_params,
    hierarchical_mesh,
    make_ring_attention,
    make_ulysses_attention,
    mesh_axis_size,
    pp_lm_loss_fn,
    set_global_mesh,
)
from .tensor import NamedParam, build_params  # noqa: F401
