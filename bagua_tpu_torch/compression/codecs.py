"""Ring-hop codec registry: the wire formats of the compressed collectives.

Port of ``bagua_tpu/compression/codecs.py``: ``minmax_uint8`` (K1/K2),
``int8``, ``fp8_e4m3`` and ``fp8_e5m2`` (K3 for the absmax, the rest
elementwise tensor ops, as the JAX package leaves them to XLA), and the
stateful ``onebit_ef`` (K4/K5) and ``topk`` (``torch.topk``, as the JAX
package leaves ``lax.top_k`` to XLA).

Codec contract (``codecs.py:12-30``):

* ``encode(x2d)``: ``[k, m]`` float input -> a tuple of tensors, the small f32
  sidecars first and the payload last, each with leading dim ``k``.
* ``decode(parts, m=None)``: the inverse, ``[k, m]`` float32 (ring hops
  accumulate in f32).  The bit-packed and sparse codecs, whose payload is
  not ``[k, m]``, cannot tell ``m`` from it and need it.
* ``wire_bytes(numel)``: bytes one encoded chunk of ``numel`` elements puts
  on the wire.

Stateful codecs (``error_feedback``) are biased: they converge only with the
per-bucket error-feedback residual, which the algorithm keeps
(:meth:`bagua_tpu_torch.algorithms.base.Algorithm.compensate_flats`); the
codec sees the compensated flats.

Non-finite contract (``codecs.py:40-43``): a NaN or Inf element poisons at
least its own decoded element and, for these scale-based codecs, its whole
chunk, so a poisoned gradient stays visible after a compressed collective.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import math

import torch

from .. import env
from ..ops.codec import absmax_chunked, sign_compress_chunked, sign_decompress_chunked
from ..ops.codec import sign_payload_bytes
from .minmax_uint8 import compress_chunked, decompress_chunked


def _absmax_sidecar(x, fmax: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scaled-quantize front half of the int8/fp8 codecs: per-chunk
    absmax (K3) mapped onto a grid of ``fmax``.  Returns ``(sidecar,
    safe)``: ``safe`` is the division-ready scale (1.0 for an all-zero
    chunk), ``sidecar`` the wire copy, which keeps a NaN absmax (a NaN fails
    ``scale > 0``, so ``safe`` would become 1 and the cast would flush the
    poison to a finite value; the NaN sidecar makes decode propagate it)."""
    k = x.shape[0]
    absmax = absmax_chunked(x.reshape(-1), k)
    scale = absmax / torch.full_like(absmax, fmax)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.where(torch.isnan(scale), scale, safe), safe


class RingCodec:
    """One wire format for the compressed ring hops."""

    #: registry key (the user-facing knob value)
    name: str = ""
    #: bytes of one payload element
    payload_itemsize: int = 1
    #: f32 sidecar scalars per encoded chunk
    sidecar_floats: int = 0
    #: True for the codecs that converge only with the per-bucket
    #: error-feedback residual (the algorithm engages it)
    error_feedback: bool = False
    #: True when the payload is not one element a chunk element (bit-packed
    #: or sparse): decode needs ``m``, and bytes go through ``wire_bytes``
    variable_payload: bool = False
    #: True for codecs whose wire format follows an env knob:
    #: :func:`get_codec` builds them afresh on every lookup
    env_tuned: bool = False

    def encode(self, x2d: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        raise NotImplementedError

    def decode(self, parts: Tuple[torch.Tensor, ...], m: Optional[int] = None) -> torch.Tensor:
        raise NotImplementedError

    def wire_bytes(self, numel: int) -> int:
        """Wire bytes of ONE encoded chunk of ``numel`` elements."""
        return int(numel) * self.payload_itemsize + 4 * self.sidecar_floats

    def payload_numel(self, numel: int) -> int:
        """Elements of the payload tensor of an ``numel``-element chunk: one
        a chunk element for the uniform codecs; the bit-packed and sparse
        ones override."""
        return int(numel)

    def __repr__(self) -> str:
        return f"<RingCodec {self.name}>"


class MinMaxUInt8Codec(RingCodec):
    """The reference MinMaxUInt8 format: per-chunk ``[mn, mx]`` f32 sidecar
    and u8 levels, through K1 and K2."""

    name = "minmax_uint8"
    sidecar_floats = 2

    def encode(self, x2d):
        return compress_chunked(x2d.reshape(-1), x2d.shape[0])

    def decode(self, parts, m=None):
        mn, mx, payload = parts
        return decompress_chunked(mn, mx, payload).reshape(payload.shape)


class Int8Codec(RingCodec):
    """Symmetric absmax int8: per-chunk f32 ``scale`` sidecar, payload
    ``round(x / scale)`` clipped to [-127, 127]; a zero stays exactly zero."""

    name = "int8"
    sidecar_floats = 1

    def encode(self, x2d):
        x = x2d.float()
        sidecar, safe = _absmax_sidecar(x, 127.0)
        q = torch.clamp(torch.round(x / safe[:, None]), -127.0, 127.0)
        # XLA's convert sends a NaN to 0; torch's leaves it undefined
        return sidecar, torch.nan_to_num(q, nan=0.0).to(torch.int8)

    def decode(self, parts, m=None):
        scale, payload = parts
        return payload.float() * scale[:, None]


class Fp8Codec(RingCodec):
    """Scaled fp8: per-chunk f32 ``scale`` sidecar mapping the chunk's absmax
    onto the format's largest finite value, payload ``x / scale`` cast to
    the fp8 type (``e4m3``: more mantissa, ``e5m2``: more range).  A
    non-finite input propagates: ``inf / inf`` is a NaN in the payload."""

    sidecar_floats = 1

    def __init__(self, name: str, dtype: torch.dtype):
        self.name = name
        self.dtype = dtype
        self.fmax = float(torch.finfo(dtype).max)

    def encode(self, x2d):
        x = x2d.float()
        sidecar, safe = _absmax_sidecar(x, self.fmax)
        return sidecar, (x / safe[:, None]).to(self.dtype)

    def decode(self, parts, m=None):
        scale, payload = parts
        return payload.float() * scale[:, None]


class OneBitEfCodec(RingCodec):
    """Sign codec: per-chunk f32 mean-abs ``scale`` sidecar and the sign
    bits packed planar (K4), decoded as ``scale * sign`` (K5).  An all-zero
    chunk round-trips exactly (scale 0); a NaN or Inf element makes the
    scale, so the whole decoded chunk, non-finite.  Without the
    error-feedback residual it is biased sign-SGD."""

    name = "onebit_ef"
    sidecar_floats = 1
    error_feedback = True
    variable_payload = True

    def encode(self, x2d):
        return sign_compress_chunked(x2d.reshape(-1), x2d.shape[0])

    def decode(self, parts, m=None):
        scale, payload = parts
        out = sign_decompress_chunked(scale, payload)
        # the padded block sliced to the chunk, so no pad lane reaches a sum
        return out if m is None else out[:, :m]

    def wire_bytes(self, numel: int) -> int:
        return sign_payload_bytes(numel) + 4 * self.sidecar_floats

    def payload_numel(self, numel: int) -> int:
        # the planar-packed u8 bytes of one chunk
        return sign_payload_bytes(int(numel))


class TopKCodec(RingCodec):
    """Top-k sparsification: parts ``(int32 indices, f32 values)`` of the
    ``kk = clamp(ceil(m * ratio), 1, m)`` largest-magnitude elements of each
    chunk (``ratio`` from ``BAGUA_TOPK_RATIO``, default 0.01); decode
    scatters them into zeros.  A non-finite element sorts as ``+inf``, so it
    is always kept.  The values travel exact; the dropped tail is what the
    error-feedback residual carries into the next step."""

    name = "topk"
    payload_itemsize = 4
    error_feedback = True
    variable_payload = True
    env_tuned = True

    def __init__(self):
        self.ratio = env.get_topk_ratio()
        if not 0.0 < self.ratio <= 1.0:
            raise ValueError(f"topk ratio must be in (0, 1], got {self.ratio}")

    def k_for(self, numel: int) -> int:
        """Elements kept of an ``numel``-element chunk."""
        n = int(numel)
        return max(1, min(n, int(math.ceil(n * self.ratio))))

    def encode(self, x2d):
        x = x2d.float()
        mag = torch.where(torch.isfinite(x), x.abs(), torch.full_like(x, float("inf")))
        idx = torch.topk(mag, self.k_for(x.shape[1]), dim=1).indices
        return idx.to(torch.int32), torch.gather(x, 1, idx)

    def decode(self, parts, m=None):
        idx, vals = parts
        if m is None:
            raise ValueError("topk's payload is sparse: decode(parts, m) needs the chunk "
                             "element count")
        out = torch.zeros((idx.shape[0], int(m)), dtype=torch.float32, device=vals.device)
        return out.scatter_(1, idx.long(), vals.float())

    def wire_bytes(self, numel: int) -> int:
        return 8 * self.k_for(numel)   # an int32 index and an f32 value each

    def payload_numel(self, numel: int) -> int:
        # each of the two parts carries k_for(m) elements a row
        return self.k_for(numel)


CODECS: Dict[str, RingCodec] = {
    c.name: c
    for c in (
        MinMaxUInt8Codec(),
        Int8Codec(),
        Fp8Codec("fp8_e4m3", torch.float8_e4m3fn),
        Fp8Codec("fp8_e5m2", torch.float8_e5m2),
        OneBitEfCodec(),
        TopKCodec(),
    )
}

#: the autopilot's compress_dcn escalation ladder: each sustained
#: DCN-dominance verdict climbs one rung — 8-bit first (cheap, stateless),
#: fp8 next, then the stateful 1-bit and sparse codecs
CODEC_LADDER = ("minmax_uint8", "fp8_e4m3", "onebit_ef", "topk")

#: codec-policy knob values beyond the codec names: ``off`` forces full
#: precision on the tier, ``auto`` defers to the algorithm family
POLICY_OFF = "off"
POLICY_AUTO = "auto"
POLICY_VALUES = (POLICY_OFF, POLICY_AUTO) + tuple(sorted(CODECS))


def get_codec(name: str) -> RingCodec:
    """The codec of ``name``; an ``env_tuned`` one is built afresh, so a
    knob set after import (``BAGUA_TOPK_RATIO``) takes effect."""
    codec = CODECS.get(name)
    if codec is None:
        raise ValueError(f"unknown ring codec {name!r} (available: {sorted(CODECS)})")
    return type(codec)() if codec.env_tuned else codec


def resolve_codec(codec: Union[None, str, RingCodec]) -> Optional[RingCodec]:
    """None passes through (full precision); names resolve via the registry;
    codec instances pass through."""
    if codec is None or isinstance(codec, RingCodec):
        return codec
    return get_codec(codec)


def validate_codec_policy(value: Optional[str], knob: str) -> str:
    """Normalize and validate one per-tier codec-policy knob value
    (``BAGUA_COMPRESS_{INTRA,INTER}`` or the trainer's keyword)."""
    v = (value or POLICY_AUTO).strip().lower()
    if v not in POLICY_VALUES:
        raise ValueError(f"{knob} must be one of {'|'.join(POLICY_VALUES)}, got {value!r}")
    return v
