"""Hierarchical and compressed ring collectives over a byte transport.

Port of ``bagua_tpu/podsim/collectives.py``, frame for frame: the same
header, codec ids and payloads, so a JAX simulated node and a port one can
share a ring.  The port's communicator builds its two-level allreduce out of
ring hops (intra-node reduce-scatter, an inter-node ring on the ``1/intra``
shard, intra-node allgather) with the wire codec on the inter-node hops.
The pod simulator runs the SAME construction as numpy arithmetic over real
sockets: one ``hop(payload) -> payload`` callback per ring, every frame
carrying its chunk index, reduction in f32 whatever the wire precision.
The inter tier rides a codec's wire model (``minmax_uint8``: a u8 payload
and an f32 lo/hi sidecar per chunk, the 4x byte reduction of the card's
codec), the intra tier stays f32.

It is deliberately *not* a path to the card's codec kernels: it is the
byte- and topology-accurate stand-in that lets 32-256 real processes drive
the coordinator stack without 32-256 torch runtimes.  Numerics are still
asserted: the caller compares against the exact mean with a tolerance
derived from the quantization step.
"""

from __future__ import annotations

import struct
from typing import Callable, List, Tuple

import numpy as np

__all__ = [
    "encode_chunk", "decode_chunk", "wire_bytes",
    "ring_reduce_scatter", "ring_allgather", "ring_allreduce",
    "hierarchical_allreduce", "quantization_atol",
]

#: chunk frame: u32 chunk index, u8 codec id, then the codec payload
_HDR = struct.Struct("<IB")
_CODEC_F32 = 0
_CODEC_MINMAX_U8 = 1
_CODEC_ONEBIT = 2
_CODEC_TOPK = 3
_CODEC_IDS = {"f32": _CODEC_F32, "minmax_uint8": _CODEC_MINMAX_U8,
              "onebit_ef": _CODEC_ONEBIT, "topk": _CODEC_TOPK}
_SIDECAR = struct.Struct("<ff")  # lo, hi
#: onebit sidecar: u32 element count (packbits pads to a byte multiple,
#: so the frame must carry the true length), f32 mean-abs scale
_ONEBIT_SIDECAR = struct.Struct("<If")
#: topk header: u32 element count, u32 selected count
_TOPK_HDR = struct.Struct("<II")


def _topk_ratio() -> float:
    """The codec knob ``BAGUA_TOPK_RATIO``, through the registry (the port's
    ``env`` imports neither torch nor numpy, so the worker can import it)."""
    from .. import env

    return env.get_topk_ratio()


def encode_chunk(idx: int, x: "np.ndarray", codec: str) -> bytes:
    """One wire frame: header + payload.  ``minmax_uint8`` quantizes to
    u8 against a per-chunk [lo, hi] f32 sidecar — the fused DCN codec's
    wire model."""
    x = np.asarray(x, dtype=np.float32)
    cid = _CODEC_IDS[codec]
    if cid == _CODEC_F32:
        return _HDR.pack(int(idx), cid) + x.astype("<f4").tobytes()
    if cid == _CODEC_ONEBIT:
        # sign wire model: 1 bit/element + a mean-abs scale — the 1-bit
        # ring's ~32x byte reduction (a non-finite input poisons the
        # scale, so the decoded chunk is all-NaN: the grad-guard
        # propagation contract holds on the wire mirror too)
        scale = float(np.mean(np.abs(x))) if x.size else 0.0
        bits = np.packbits(x >= 0.0)
        return (_HDR.pack(int(idx), cid)
                + _ONEBIT_SIDECAR.pack(x.size, scale) + bits.tobytes())
    if cid == _CODEC_TOPK:
        n = int(x.size)
        kk = max(1, min(n, int(np.ceil(n * _topk_ratio())))) if n else 0
        mag = np.where(np.isfinite(x), np.abs(x), np.inf)
        sel = np.argpartition(mag, n - kk)[n - kk:] if n else \
            np.zeros(0, np.int64)
        return (_HDR.pack(int(idx), cid) + _TOPK_HDR.pack(n, kk)
                + sel.astype("<i4").tobytes()
                + x[sel].astype("<f4").tobytes())
    lo = float(x.min()) if x.size else 0.0
    hi = float(x.max()) if x.size else 0.0
    scale = (hi - lo) / 255.0 if hi > lo else 1.0
    q = np.clip(np.rint((x - lo) / scale), 0, 255).astype(np.uint8)
    return _HDR.pack(int(idx), cid) + _SIDECAR.pack(lo, hi) + q.tobytes()


def decode_chunk(frame: bytes) -> Tuple[int, "np.ndarray"]:
    idx, cid = _HDR.unpack_from(frame)
    body = frame[_HDR.size:]
    if cid == _CODEC_F32:
        return idx, np.frombuffer(body, dtype="<f4").astype(np.float32)
    if cid == _CODEC_ONEBIT:
        n, scale = _ONEBIT_SIDECAR.unpack_from(body)
        bits = np.frombuffer(body[_ONEBIT_SIDECAR.size:], dtype=np.uint8)
        signs = np.unpackbits(bits)[:n].astype(np.float32) * 2.0 - 1.0
        return idx, signs * np.float32(scale)
    if cid == _CODEC_TOPK:
        n, kk = _TOPK_HDR.unpack_from(body)
        off = _TOPK_HDR.size
        sel = np.frombuffer(body[off:off + 4 * kk], dtype="<i4")
        vals = np.frombuffer(body[off + 4 * kk:off + 8 * kk], dtype="<f4")
        out = np.zeros(n, dtype=np.float32)
        out[sel] = vals
        return idx, out
    lo, hi = _SIDECAR.unpack_from(body)
    q = np.frombuffer(body[_SIDECAR.size:], dtype=np.uint8)
    scale = (hi - lo) / 255.0 if hi > lo else 1.0
    return idx, (q.astype(np.float32) * scale + lo)


def wire_bytes(nelems: int, codec: str) -> int:
    """Frame size for ``nelems`` f32 elements under ``codec`` — the
    shaper charges these bytes, so the DCN tier's byte reduction (4x u8,
    ~32x onebit, ~50x topk at the default 1% ratio) shows up in injected
    serialization time exactly like the fused path."""
    cid = _CODEC_IDS[codec]
    n = int(nelems)
    if cid == _CODEC_F32:
        return _HDR.size + 4 * n
    if cid == _CODEC_ONEBIT:
        return _HDR.size + _ONEBIT_SIDECAR.size + -(-n // 8)
    if cid == _CODEC_TOPK:
        kk = max(1, min(n, int(np.ceil(n * _topk_ratio())))) if n else 0
        return _HDR.size + _TOPK_HDR.size + 8 * kk
    return _HDR.size + _SIDECAR.size + n


def quantization_atol(x_span: float, reduce_hops: int,
                      codec: str = "minmax_uint8") -> float:
    """Worst-case absolute error of a mean computed through ``reduce_hops``
    codec-quantized additions of values spanning ``x_span``.  u8: half a
    quantization step per encode, accumulated.  onebit/topk are LOSSY by
    construction (the production path pairs them with an error-feedback
    residual the stateless mirror does not carry), so their bound is
    span-scale: it proves transport integrity — frames reassemble, the
    reduction stays finite and magnitude-bounded — not fidelity."""
    if _CODEC_IDS.get(codec) in (_CODEC_ONEBIT, _CODEC_TOPK):
        return x_span * float(max(1, reduce_hops)) + 1e-5
    return (x_span / 255.0) * 0.5 * max(1, reduce_hops) + 1e-5


Hop = Callable[[bytes, int], bytes]  # (payload, hop_index) -> payload


def _split(x: "np.ndarray", n: int) -> List["np.ndarray"]:
    """n near-equal chunks (padded to equal length so frames are uniform —
    mirrors the communicator's padded ring chunking)."""
    per = -(-x.size // n)
    padded = np.zeros(per * n, dtype=np.float32)
    padded[: x.size] = x
    return [padded[i * per: (i + 1) * per].copy() for i in range(n)]


def ring_reduce_scatter(x: "np.ndarray", pos: int, size: int, hop: Hop,
                        codec: str = "f32",
                        hop_base: int = 0) -> Tuple["np.ndarray", int, int]:
    """Standard ring reduce-scatter: ``size - 1`` hops, each sending the
    running partial of one chunk to the next ring position.  Returns
    (owned fully-reduced chunk, its chunk index, hops consumed)."""
    if size == 1:
        return np.asarray(x, dtype=np.float32).copy(), 0, 0
    chunks = _split(np.asarray(x, dtype=np.float32), size)
    for step in range(size - 1):
        send_idx = (pos - step) % size
        frame = hop(encode_chunk(send_idx, chunks[send_idx], codec),
                    hop_base + step)
        idx, partial = decode_chunk(frame)
        chunks[idx] = chunks[idx] + partial
    own = (pos + 1) % size
    return chunks[own], own, size - 1


def ring_allgather(own: "np.ndarray", own_idx: int, size: int, hop: Hop,
                   codec: str = "f32",
                   hop_base: int = 0) -> Tuple[List["np.ndarray"], int]:
    """Standard ring allgather: circulate each fully-reduced chunk
    ``size - 1`` hops; frames carry their chunk index, so the assembly
    is self-describing.  Returns (all chunks in index order, hops)."""
    chunks: List = [None] * size
    chunks[own_idx] = np.asarray(own, dtype=np.float32)
    cur_idx, cur = own_idx, chunks[own_idx]
    for step in range(size - 1):
        frame = hop(encode_chunk(cur_idx, cur, codec), hop_base + step)
        cur_idx, cur = decode_chunk(frame)
        chunks[cur_idx] = cur
    return chunks, size - 1


def ring_allreduce(x: "np.ndarray", pos: int, size: int, hop: Hop,
                   codec: str = "f32") -> Tuple["np.ndarray", int]:
    """reduce-scatter + allgather; returns (summed vector, hops)."""
    x = np.asarray(x, dtype=np.float32)
    own, own_idx, h1 = ring_reduce_scatter(x, pos, size, hop, codec)
    chunks, h2 = ring_allgather(own, own_idx, size, hop, codec, hop_base=h1)
    return np.concatenate(chunks)[: x.size], h1 + h2


def hierarchical_allreduce(
    x: "np.ndarray",
    intra_hop: Hop, intra_pos: int, intra_size: int,
    inter_hop: Hop, inter_pos: int, inter_size: int,
    dcn_codec: str = "minmax_uint8",
) -> Tuple["np.ndarray", dict]:
    """The two-level construction over two rings: intra reduce-scatter
    (f32, ICI), inter ring allreduce on the owned ``1/intra`` shard
    (``dcn_codec`` wire, DCN), intra allgather (f32, ICI).  Returns the
    *mean* over all ``intra_size * inter_size`` ranks plus hop
    accounting."""
    x = np.asarray(x, dtype=np.float32)
    world = intra_size * inter_size
    own, own_idx, intra_hops = ring_reduce_scatter(
        x, intra_pos, intra_size, intra_hop, codec="f32")
    inter_hops = 0
    if inter_size > 1:
        own, inter_hops = ring_allreduce(
            own, inter_pos, inter_size, inter_hop, codec=dcn_codec)
    chunks, ag_hops = ring_allgather(
        own, own_idx, intra_size, intra_hop, codec="f32",
        hop_base=intra_hops)
    out = np.concatenate(chunks)[: x.size] / float(world)
    return out, {
        "intra_hops": intra_hops + ag_hops,
        "inter_hops": inter_hops,
        "world": world,
    }
