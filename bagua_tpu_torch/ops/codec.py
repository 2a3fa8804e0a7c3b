"""Chunked gradient codecs: hand-written Hopper kernels for the MinMaxUInt8
codec, the absmax reduction of the int8/fp8 codecs and the 1-bit sign codec.

Port of the codec kernels of ``bagua_tpu/compression/pallas_codec.py``.  A
flat tensor of ``n * m`` elements is ``n`` chunks of ``m``; each chunk gets
its own quantization grid.  The five Pallas TPU kernels become the CUDA
kernels of ``csrc/codec.cu``, built with ``nvcc`` at first use and called
through ``ctypes``:

- :func:`compress_chunked` (K1): per-chunk ``mn``/``mx`` and the uint8
  payload ``clip(round(x * scale), lower, upper) - lower`` with ``scale =
  255 / (mx - mn + 1e-7)``, ``upper = round(mx * scale)``, ``lower = upper -
  255`` (``minmax_uint8.py:39-56``);
- :func:`decompress_chunked` (K2): ``(payload + lower) / scale`` in f32
  (``minmax_uint8.py:59-66``);
- :func:`absmax_chunked` (K3): per-chunk ``max |x|``, a NaN kept;
- :func:`sign_compress_chunked` (K4): per-chunk mean-abs ``scale`` and the
  sign bits packed bit-planar into ``ceil(m / 1024) * 128`` bytes
  (``pallas_codec.py:329-468``);
- :func:`sign_decompress_chunked` (K5): the planar bits as ``±scale``, the
  padded ``[n, 8 * B]`` block (``pallas_codec.py:471-511``).

K1, K3 and K4 are one launch a call: K1 one cooperative grid (one block an
SM, the input read once from device memory where it fits in the grid's
shared memory), K3 and K4 one grid each whose last block of a chunk to
finish writes the chunk's absmax (K3) or scale (K4).

Each wrapper has a plain PyTorch version beside it and counts its launches in
``<wrapper>.launches``.  A wrapper takes the plain version only for tensors on
the CPU; for a CUDA tensor it launches the kernel at every chunk size or
raises.  K1-K3 and K5 agree with their plain versions byte for byte, and
both equal the JAX package's jnp codec, including its saturating uint8
convert; K4's payload does too, its scale is a sum whose order differs
(within 1e-6 relative).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from . import _build

EPS = 1e-7
LEVELS = 255.0

#: elements per block of K2's (tile, chunk) grid, at least; a chunk is cut
#: into at most ``MAX_TILES`` tiles (K4 and K5 cut their payload bytes so too)
MIN_TILE = 4096
MAX_TILES = 1024


# ---------------------------------------------------------------------------
# plain versions of the three kernels
# ---------------------------------------------------------------------------


def _grid(mn, mx):
    """``(scale, lower, upper)`` per chunk, ``[n, 1]`` each.  Every quotient
    is a tensor by a tensor: PyTorch divides by a Python number as a product
    with its reciprocal, which rounds twice."""
    d = mx - mn + EPS
    scale = torch.full_like(d, LEVELS) / d
    upper = torch.round(mx * scale)
    return scale[:, None], (upper - LEVELS)[:, None], upper[:, None]


def _saturate_u8(d):
    """f32 -> uint8 as XLA converts it: NaN -> 0, clamped to [0, 255]."""
    return torch.nan_to_num(d, nan=0.0).clamp_(0.0, LEVELS).to(torch.uint8)


def quantize_plain(x2d, mn, mx):
    """Quantize ``[n, m]`` chunks against given per-chunk bounds: the
    quantize half of the codec (``minmax_uint8.py:102-116``).  A value
    outside the bounds clamps to the grid's edge, so sound bounds cost at
    most one extra grid step of error."""
    scale, lower, upper = _grid(mn, mx)
    level = torch.minimum(torch.maximum(torch.round(x2d.float() * scale), lower), upper)
    return _saturate_u8(level - lower)


def compress_chunked_plain(x, n_chunks: int):
    """Plain version of :func:`compress_chunked`."""
    chunks = x.reshape(n_chunks, -1).float()
    mn, mx = chunks.amin(dim=1), chunks.amax(dim=1)
    return mn, mx, quantize_plain(chunks, mn, mx)


def decompress_chunked_plain(mn, mx, payload):
    """Plain version of :func:`decompress_chunked`."""
    scale, lower, _ = _grid(mn, mx)
    return ((payload.float() + lower) / scale).reshape(-1)


def absmax_chunked_plain(x, n_chunks: int):
    """Plain version of :func:`absmax_chunked`."""
    return x.reshape(n_chunks, -1).float().abs().amax(dim=1)


def sign_payload_bytes(m: int) -> int:
    """Packed bytes of one ``m``-element chunk: ``ceil(m / 1024) * 128``
    (the TPU's planar layout pads to whole (8, 128) bit-plane groups;
    ``codecs.py:234-238``)."""
    return -(-int(m) // 1024) * 128


def sign_compress_chunked_plain(x, n_chunks: int):
    """Plain version of :func:`sign_compress_chunked`: the mean-abs scale
    (a tensor-by-tensor quotient, as in :func:`_grid`) and the planar pack
    of ``_jnp_sign_pack`` (``pallas_codec.py:394-405``)."""
    chunks = x.reshape(n_chunks, -1).float()
    m = chunks.shape[1]
    sums = chunks.abs().sum(dim=1)
    scale = sums / torch.full_like(sums, float(m))
    nbytes = sign_payload_bytes(m)
    padded = torch.nn.functional.pad(chunks, (0, 8 * nbytes - m))
    bits = (padded >= 0).to(torch.uint8).reshape(n_chunks, 8, nbytes)
    payload = bits[:, 0].clone()
    for b in range(1, 8):
        payload |= bits[:, b] << b
    return scale, payload


def sign_decompress_chunked_plain(scale, payload):
    """Plain version of :func:`sign_decompress_chunked`."""
    n, nbytes = payload.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=payload.device).reshape(1, 8, 1)
    bits = ((payload[:, None, :] >> shifts) & 1).reshape(n, 8 * nbytes)
    return (bits.float() * 2.0 - 1.0) * scale[:, None]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "bagua_minmax_compress": [_P, _I, _I, _L, _P, _L, _P, _P, _P, _P],
    "bagua_minmax_decompress": [_P, _P, _P, _I, _L, _L, _I, _P, _P],
    "bagua_absmax": [_P, _I, _I, _L, _P, _P],
    "bagua_sign_compress": [_P, _I, _I, _L, _L, _L, _I, _P, _P, _P, _P],
    "bagua_sign_decompress": [_P, _P, _I, _L, _L, _I, _P, _P],
}
_lib_cache = []


def _lib():
    if not _lib_cache:
        _lib_cache.append(_build.bind("codec", _SIGNATURES))
    return _lib_cache[0]


def _tiling(m: int):
    """``(tile, tiles)``: elements per block and blocks per chunk."""
    tile = max(MIN_TILE, -(-m // MAX_TILES))
    return tile, -(-m // tile)


def _check_input(x, n_chunks: int) -> int:
    """Raise on what the kernels do not take; returns the chunk length."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"codec kernels take float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("codec kernels take contiguous tensors")
    if not 1 <= n_chunks <= 65535 or x.numel() == 0 or x.numel() % n_chunks:
        raise ValueError(f"{x.numel()} elements do not split into {n_chunks} chunks")
    return x.numel() // n_chunks


# Threads and streams.  The overlap scheduler launches codecs from three
# threads at once: the main thread, autograd's backward thread (the
# error-feedback compensation of a finalized bucket, on the backward's
# stream) and the trainer's comm worker (the rings and ByteGrad's pipeline,
# on its comm stream).  Every launch counter is bumped under ``_COUNT_LOCK``,
# so that none is lost.  K3 and K4 keep per-chunk tickets (and K3 a max word
# a chunk) in the library's device memory, so two of their launches must not
# run at once: ``_launch_ordered`` makes each K3 or K4 launch wait for the
# last one made on another stream of the device, and holds ``_ORDER_LOCK``
# from that wait to the end of the launch's enqueue, so that the event it
# waits for is recorded after the launch before it.
_COUNT_LOCK = threading.Lock()
_ORDER_LOCK = threading.Lock()
#: device -> the stream of the last K3 or K4 launch (under ``_ORDER_LOCK``)
_last_stream = {}


def _count(wrapper) -> None:
    with _COUNT_LOCK:
        wrapper.launches += 1


def _order_streams(device) -> None:
    """Make the current stream wait for the last K3 or K4 launch when that
    was made on another stream of ``device``; call under ``_ORDER_LOCK``."""
    stream = torch.cuda.current_stream(device)
    last = _last_stream.get(device)
    if last is not None and last != stream:
        done = torch.cuda.Event()
        done.record(last)
        stream.wait_event(done)
    _last_stream[device] = stream


def _launch_ordered(wrapper, fn, *args) -> None:
    """Launch K3 or K4 (``fn``, the bound launcher of ``wrapper``) on the
    current stream, after the last launch of either on another stream."""
    with _ORDER_LOCK:
        _order_streams(torch.cuda.current_stream().device)
        _build.launch(fn, *args)
    _count(wrapper)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def compress_chunked(x, n_chunks: int):
    """K1: ``(mn, mx, payload)`` for flat ``x`` (f32 or bf16, ``numel %
    n_chunks == 0``): ``mn``/``mx`` f32 ``[n_chunks]``, payload uint8
    ``[n_chunks, chunk]``."""
    if x.device.type == "cpu":
        return compress_chunked_plain(x, n_chunks)
    m = _check_input(x, n_chunks)
    dev = x.device
    # one partial (min, max) pair a chunk and block of the one-SM-a-block grid
    partials = torch.empty((n_chunks + _sm_count(dev.index), 2), dtype=torch.float32,
                           device=dev)
    mn = torch.empty(n_chunks, dtype=torch.float32, device=dev)
    mx = torch.empty(n_chunks, dtype=torch.float32, device=dev)
    payload = torch.empty((n_chunks, m), dtype=torch.uint8, device=dev)
    _build.launch(_lib().bagua_minmax_compress, x.data_ptr(), int(x.dtype == torch.bfloat16),
                  n_chunks, m, partials.data_ptr(), partials.shape[0], mn.data_ptr(),
                  mx.data_ptr(), payload.data_ptr())
    _count(compress_chunked)
    return mn, mx, payload


def decompress_chunked(mn, mx, payload):
    """K2: the inverse of :func:`compress_chunked`, flat f32 of
    ``payload.numel()`` elements; ``mn``/``mx`` f32 ``[n]``, payload uint8
    ``[n, chunk]``."""
    if payload.device.type == "cpu":
        return decompress_chunked_plain(mn, mx, payload)
    if payload.dim() != 2 or payload.dtype != torch.uint8 or not payload.is_contiguous():
        raise ValueError(f"payload must be a contiguous uint8 [n, chunk], got "
                         f"{tuple(payload.shape)} {payload.dtype}")
    n, m = payload.shape
    for t in (mn, mx):
        if t.shape != (n,) or t.dtype != torch.float32 or t.device != payload.device \
                or not t.is_contiguous():
            raise ValueError(f"mn and mx must be contiguous float32 [{n}] on "
                             f"{payload.device}, got {tuple(t.shape)} {t.dtype} {t.device}")
    if not 1 <= n <= 65535 or m == 0:
        raise ValueError(f"cannot decompress {n} chunks of {m}")
    tile, tiles = _tiling(m)
    out = torch.empty(n * m, dtype=torch.float32, device=payload.device)
    _build.launch(_lib().bagua_minmax_decompress, mn.data_ptr(), mx.data_ptr(),
                  payload.data_ptr(), n, m, tile, tiles, out.data_ptr())
    _count(decompress_chunked)
    return out


def absmax_chunked(x, n_chunks: int):
    """K3: per-chunk ``max |x|`` of flat ``x`` (f32 or bf16), f32
    ``[n_chunks]``; a chunk holding a NaN gives NaN."""
    if x.device.type == "cpu":
        return absmax_chunked_plain(x, n_chunks)
    m = _check_input(x, n_chunks)
    out = torch.empty(n_chunks, dtype=torch.float32, device=x.device)
    _launch_ordered(absmax_chunked, _lib().bagua_absmax, x.data_ptr(),
                    int(x.dtype == torch.bfloat16), n_chunks, m, out.data_ptr())
    return out


#: bytes of the sign payload per block of K4/K5's grid, at least (4096
#: elements, as K2's ``MIN_TILE``)
MIN_SIGN_TILE = 512
#: K4's threads a block (``kSignThreads`` in ``csrc/codec.cu``); a thread
#: makes 16 / itemsize neighbouring payload bytes a pass, and a tile is one
#: pass at least
SIGN_THREADS = 256


def _sign_tiling(nbytes: int, vector: int = 1):
    """``(tile, tiles)``: payload bytes per block and blocks per chunk, the
    tile a multiple of ``vector`` bytes."""
    tile = max(MIN_SIGN_TILE, -(-nbytes // MAX_TILES))
    tile = -(-tile // vector) * vector
    return tile, -(-nbytes // tile)


def _sign_compress_tiling(nbytes: int, itemsize: int):
    """K4's ``(tile, tiles)``: tiles of one pass of a block at least."""
    return _sign_tiling(nbytes, SIGN_THREADS * 16 // itemsize)


def sign_compress_chunked(x, n_chunks: int):
    """K4: ``(scale, payload)`` for flat ``x`` (f32 or bf16, ``numel %
    n_chunks == 0``): ``scale`` f32 ``[n_chunks]``, the mean of ``|x|`` over
    each chunk's ``m`` elements; payload uint8 ``[n_chunks, B]``, ``B =
    ceil(m / 1024) * 128``, bit ``b`` of byte ``j`` the sign bit ``x[b * B +
    j] >= 0`` of the chunk zero-padded to ``8 * B`` (a pad element's bit is
    1, a NaN's 0)."""
    if x.device.type == "cpu":
        return sign_compress_chunked_plain(x, n_chunks)
    m = _check_input(x, n_chunks)
    nbytes = sign_payload_bytes(m)
    tile, tiles = _sign_compress_tiling(nbytes, x.element_size())
    dev = x.device
    partials = torch.empty((n_chunks, tiles), dtype=torch.float32, device=dev)
    scale = torch.empty(n_chunks, dtype=torch.float32, device=dev)
    payload = torch.empty((n_chunks, nbytes), dtype=torch.uint8, device=dev)
    _launch_ordered(sign_compress_chunked, _lib().bagua_sign_compress, x.data_ptr(),
                    int(x.dtype == torch.bfloat16), n_chunks, m, nbytes, tile, tiles,
                    partials.data_ptr(), scale.data_ptr(), payload.data_ptr())
    return scale, payload


def sign_decompress_chunked(scale, payload):
    """K5: the inverse of :func:`sign_compress_chunked`, the padded f32
    block ``[n, 8 * B]`` of ``±scale`` (the codec slices it to ``m``); a NaN
    or Inf scale makes its whole chunk non-finite."""
    if payload.device.type == "cpu":
        return sign_decompress_chunked_plain(scale, payload)
    if payload.dim() != 2 or payload.dtype != torch.uint8 or not payload.is_contiguous() \
            or payload.shape[1] % 128:
        raise ValueError(f"payload must be a contiguous uint8 [n, 128 k], got "
                         f"{tuple(payload.shape)} {payload.dtype}")
    n, nbytes = payload.shape
    if scale.shape != (n,) or scale.dtype != torch.float32 or scale.device != payload.device \
            or not scale.is_contiguous():
        raise ValueError(f"scale must be a contiguous float32 [{n}] on {payload.device}, "
                         f"got {tuple(scale.shape)} {scale.dtype} {scale.device}")
    if not 1 <= n <= 65535 or nbytes == 0:
        raise ValueError(f"cannot decompress {n} chunks of {nbytes} bytes")
    tile, tiles = _sign_tiling(nbytes)
    out = torch.empty((n, 8 * nbytes), dtype=torch.float32, device=payload.device)
    _build.launch(_lib().bagua_sign_decompress, scale.data_ptr(), payload.data_ptr(), n,
                  nbytes, tile, tiles, out.data_ptr())
    _count(sign_decompress_chunked)
    return out


KERNELS = (compress_chunked, decompress_chunked, absmax_chunked, sign_compress_chunked,
           sign_decompress_chunked)
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in KERNELS:
            k.launches = 0
