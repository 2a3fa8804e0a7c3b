"""Autotune sidecar service (port of ``bagua_tpu/service/``; reference
``bagua/service/``)."""

from .autotune_service import AutotuneClient, AutotuneService, run_autotune_server  # noqa: F401
from .bayesian_optimizer import BayesianOptimizer, BoolParam, FloatParam, IntParam  # noqa: F401
