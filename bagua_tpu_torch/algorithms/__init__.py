from .base import Algorithm, AlgorithmContext  # noqa: F401
from .gradient_allreduce import GradientAllReduceAlgorithm  # noqa: F401
