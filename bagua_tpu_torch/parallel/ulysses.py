"""Ulysses sequence parallelism: an all-to-all head <-> sequence reshard.

Port of ``bagua_tpu/parallel/ulysses.py`` (DeepSpeed-Ulysses, arXiv
2309.14509).  With the sequence split over the ``sp`` axis of the global
mesh, one tiled :func:`~bagua_tpu_torch.parallel.functional.all_to_all`
scatters the heads and gathers the sequence, so that each rank attends over
the WHOLE sequence for ``heads / sp`` of the heads with an unchanged local
attention (by default the flash kernels' causal attention), and a second one
reshards the output back.  Ulysses keeps the attention local, the ring
(:mod:`~bagua_tpu_torch.parallel.ring_attention`) streams K/V instead.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..ops.flash_attention import flash_attention
from . import functional as pf
from .mesh import require_axis


def _causal_attention(q, k, v, dtype):
    return flash_attention(q, k, v, dtype, causal=True)


def make_ulysses_attention(sp_size: int, axis_name: str = "sp",
                           inner_attn: Optional[Callable] = None):
    """An ``attn_fn(q, k, v, dtype)`` for ``TransformerLM``.  Per-rank inputs
    ``[batch, seq_local, heads, head_dim]``; ``heads`` must be divisible by
    ``sp_size``.  ``inner_attn`` is the local full-sequence attention
    (default: causal flash attention)."""
    inner = inner_attn or _causal_attention

    def attn_fn(q, k, v, dtype):
        if sp_size == 1:
            return inner(q, k, v, dtype)
        if q.shape[2] % sp_size:
            raise ValueError(f"heads {q.shape[2]} not divisible by sp_size {sp_size}")
        comm = require_axis(axis_name, sp_size, "Ulysses attention").comm(axis_name)

        def to_seq(x):     # [b, s_loc, h, d] -> [b, s_global, h / sp, d]
            return pf.all_to_all(x, comm, 2, 1, tiled=True)

        o = inner(to_seq(q), to_seq(k), to_seq(v), dtype)
        # [b, s_global, h / sp, d] -> [b, s_loc, h, d]
        return pf.all_to_all(o, comm, 1, 2, tiled=True)

    return attn_fn
