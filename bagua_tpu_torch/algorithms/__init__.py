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
