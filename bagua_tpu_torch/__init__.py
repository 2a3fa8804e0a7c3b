"""bagua_tpu_torch: the PyTorch/CUDA port of bagua_tpu.

The same layout and public names as the JAX package, built on torch and
numpy alone: collectives over ``torch.distributed`` (NCCL on the card, gloo
on the CPU, or gloo through host memory for several ranks on one card) and
the JAX package's Pallas kernels rewritten by hand in CUDA for Hopper
(``ops/csrc``).  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"

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
from .communication import (  # noqa: F401
    BaguaAborted,
    BaguaBackend,
    BaguaCommunicator,
    ReduceOp,
    abort,
    allgather,
    allreduce,
    allreduce_inplace,
    alltoall,
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
    reset_abort,
    scatter,
    send_recv,
)
from .core.backend import BaguaTrainer, TrainState  # noqa: F401
from .define import TensorDeclaration, TensorDtype  # noqa: F401
from .env import get_local_rank, get_rank, get_world_size  # noqa: F401
from .models.transformer import (  # noqa: F401
    TransformerConfig,
    TransformerLM,
    bert_large_config,
    lm_loss_fn,
)
from .model_parallel.moe import MoEMLP, moe_lm_loss_fn  # noqa: F401
from .ops.flash_attention import flash_attention, reference_attention  # noqa: F401
from .ops.gmm import gmm  # noqa: F401
from .tensor import NamedParam, build_params  # noqa: F401
