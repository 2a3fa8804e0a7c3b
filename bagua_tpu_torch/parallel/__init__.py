"""Meshes of named rank axes and the model-side collectives over them (port
of ``bagua_tpu/parallel``): expert and sequence parallelism."""

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
