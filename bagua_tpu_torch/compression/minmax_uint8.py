"""MinMaxUInt8 chunked codec and the compressed scatter-gather allreduce.

Port of ``bagua_tpu/compression/minmax_uint8.py``.  The codec math
(the reference's ``tests/internal/compressor.py`` golden)::

    scale = 255 / (max - min + eps)
    upper = round(max * scale);  lower = upper - 255
    level = clamp(round(x * scale), lower, upper)
    payload = uint8(level - lower);   x' = (payload + lower) / scale

:func:`compress_chunked` and :func:`decompress_chunked` are the kernels K1
and K2 of :mod:`bagua_tpu_torch.ops.codec`: for a CUDA tensor they launch the
kernel at every chunk size (the JAX package's v5e crossover, which sends
small chunks and every decompress to jnp, does not carry over), for a CPU
tensor they take the plain version.
"""

from __future__ import annotations

import torch

from ..communication import BaguaCommunicator
from ..ops.codec import EPS, LEVELS, compress_chunked, decompress_chunked  # noqa: F401
# the quantize half against given bounds is tensor ops here as in the JAX
# package (``minmax_uint8.py:102-116``), shared with K1's plain version
from ..ops.codec import quantize_plain as quantize_with_bounds


def compressed_scatter_gather_allreduce(
    comm: BaguaCommunicator, x: torch.Tensor, average: bool = True
) -> torch.Tensor:
    """8-bit compressed allreduce of flat ``x`` (``numel % nranks == 0``;
    the bucket layer pads to the world size) over ``comm``: compress all
    ``nranks`` chunks, all-to-all, decompress, reduce the own chunk,
    quantize it, all-gather, decompress (``minmax_uint8.py:119-160``).

    The all-gather leg reuses the scatter leg's bounds: the reduced chunk
    lies within the mean (sum) of its sources' ``[mn, mx]``, so it is
    quantized against those, with no second min/max pass.  Every rank
    decodes the same gathered payload, so all ranks agree bitwise.  The
    per-chunk ``mn`` and ``mx`` travel as one ``[n, 2]`` tensor (one
    collective where the JAX package issues two)."""
    n = comm.nranks()
    mn, mx, payload = compress_chunked(x, n)
    # each rank ends up with every rank's chunk r (r = own rank)
    payload_t = comm.alltoall(payload)
    stats_t = comm.alltoall(torch.stack([mn, mx], dim=1))
    mn_t, mx_t = stats_t[:, 0].contiguous(), stats_t[:, 1].contiguous()
    vals = decompress_chunked(mn_t, mx_t, payload_t).reshape(n, -1)
    red = vals.mean(dim=0) if average else vals.sum(dim=0)
    # quantize the own reduced chunk against the sources' combined bounds
    stats2 = stats_t.mean(dim=0) if average else stats_t.sum(dim=0)
    payload2 = quantize_with_bounds(red.reshape(1, -1), stats2[:1], stats2[1:])
    payload_all = comm.allgather(payload2)                    # [n, chunk]
    stats_all = comm.allgather(stats2.reshape(1, 2))          # [n, 2]
    out = decompress_chunked(stats_all[:, 0].contiguous(), stats_all[:, 1].contiguous(),
                             payload_all)
    return out.to(x.dtype)
