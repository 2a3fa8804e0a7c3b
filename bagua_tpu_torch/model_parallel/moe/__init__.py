"""Mixture-of-Experts (port of ``bagua_tpu/model_parallel/moe``)."""

from .gating import top1_gating, top2_gating, topk_routing  # noqa: F401
from .layer import (  # noqa: F401
    EXPERT_PARAM_NAMES,
    MoEMLP,
    is_expert_param,
    moe_lm_loss_fn,
)
