"""Meshes of named rank axes and the model-side collectives over them (port
of ``bagua_tpu/parallel``): expert, sequence, tensor and pipeline
parallelism."""

from .mesh import (  # noqa: F401
    Mesh,
    build_mesh,
    get_global_mesh,
    get_global_mesh_if_set,
    hierarchical_mesh,
    mesh_axis_size,
    set_global_mesh,
)
from .ring_attention import make_ring_attention  # noqa: F401
from .ulysses import make_ulysses_attention  # noqa: F401
from .tensor_parallel import globalize_tp_params, tp_gather_grad, tp_reduce  # noqa: F401
from .pipeline import (  # noqa: F401
    PipelinedTransformerLM,
    globalize_pp_params,
    pp_lm_loss_fn,
    pp_param_dim,
)
