"""Flash attention: hand-written Hopper kernels behind a torch autograd Function.

Port of ``bagua_tpu/ops/flash_attention.py``.  The three Pallas TPU kernels
(forward, dK/dV, dQ) become the CUDA kernels of ``csrc/flash_attention.cu``,
built with ``nvcc`` at first use and called through ``ctypes``.  Each kernel
has a wrapper here (:func:`flash_fwd`, :func:`flash_bwd_dkv`,
:func:`flash_bwd_dq`) and a plain PyTorch version of the same function beside
it.  A wrapper takes the plain version only for tensors on the CPU (that is
what the CPU tests run); for a CUDA tensor it launches the kernel or raises.
Each wrapper counts its kernel launches in ``<wrapper>.launches``.

The public functions take ``[batch, seq, heads, head_dim]`` like the JAX
ones and fold to ``[batch * heads, seq, head_dim]`` for the kernels.  Any
sequence length is taken (the kernels mask the ragged tail).

What the entry points take is :func:`kernels_take`, on shape and dtype
alone: float16, bfloat16 or float32, with any head_dim.  Up to 256 the
kernels compute at width 64, 128 or 256 and widen a narrower head with zeros
in shared memory, so a head_dim of 32 costs the time of 64; a wider head runs
FMA kernels that give each block a 128-column slice of the output and
recompute the scores for every slice (right, not fast: no configuration of
the repo has such a head).  Their loads need rows of a multiple of
``WIDTH_MULTIPLE`` elements, so on the kernel path :func:`flash_attention`
pads q, k and v with zero columns up to one (zero columns add nothing to a
score) and slices the output back; the softmax scale stays ``1/sqrt(head_dim)`` of the
real head, passed to the kernels beside the padded width.  The wrappers
take only what their kernels take.  A CUDA tensor outside the rule raises,
in :func:`flash_attention` as in the wrappers: there is no fallback to the
materializing path on the card, and none of the JAX package's TPU speed
gates (a sequence floor, block alignment, the VMEM budget) is carried over.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

NEG_INF = -1e30
#: the kernels' stored width is a multiple of this (a 16-bit row then starts
#: on a 16-byte boundary, as TMA requires); the entry points pad to it
WIDTH_MULTIPLE = 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def reference_attention(q, k, v, dtype=None, causal: bool = True):
    """Plain (materializing) attention, the golden: ``q/k/v`` are
    ``[batch, seq, heads, head_dim]``; logits and softmax in f32, the
    products in the input dtype, as in the JAX reference."""
    s, d = q.shape[1], q.shape[3]
    dtype = dtype or q.dtype
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(d)
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(dtype))


# ---------------------------------------------------------------------------
# plain versions of the three kernels, on folded [bh, s, d] tensors
# ---------------------------------------------------------------------------


def _scaled_logits(q, k, causal, head_dim=None):
    """Masked ``q.k / sqrt(head_dim)`` in f32 (``head_dim`` defaults to the
    width of ``q``); the product is accumulated in f32 and rounded to the
    input dtype, as XLA computes :func:`reference_attention`'s einsum."""
    s = q.shape[1]
    qk = torch.einsum("bqd,bkd->bqk", q.float(), k.float()).to(q.dtype)
    logits = qk.float() / math.sqrt(head_dim or q.shape[2])
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, NEG_INF)
    return logits


def _probs(q, k, lse, causal, head_dim=None):
    return torch.exp(_scaled_logits(q, k, causal, head_dim) - lse[..., None])


def fwd_plain(q, k, v, causal: bool, head_dim=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel, :func:`reference_attention`'s
    math on folded inputs plus the logsumexp: ``(o, lse)`` with ``o`` in the
    input dtype and ``lse`` ``[bh, s]`` f32.  The softmax is jax.nn.softmax's
    ``exp(x - max) / sum``.  (The kernel keeps q.k in f32 and rounds P before
    normalizing, so in bf16 and f16 the two differ by rounding.)  The scale
    is that of ``head_dim``, by default the width of ``q``; so are the
    backward versions'."""
    logits = _scaled_logits(q, k, causal, head_dim)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    l = e.sum(dim=-1, keepdim=True)
    p = (e / l).to(q.dtype)
    o = torch.einsum("bqk,bkd->bqd", p.float(), v.float()).to(q.dtype)
    return o, (m + torch.log(l)).squeeze(-1)


def dkv_plain(q, k, v, do, lse, delta, causal: bool, head_dim=None):
    """Plain version of the dK/dV kernel: P rounded to the input dtype, dS
    rounded before dS^T Q."""
    scale = 1.0 / math.sqrt(head_dim or q.shape[2])
    p = _probs(q, k, lse, causal, head_dim).to(q.dtype).float()
    dv = torch.einsum("bqk,bqd->bkd", p, do.float())
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dk = scale * torch.einsum("bqk,bqd->bkd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def dq_plain(q, k, v, do, lse, delta, causal: bool, head_dim=None):
    """Plain version of the dQ kernel: P in f32, dS rounded before dS K."""
    scale = 1.0 / math.sqrt(head_dim or q.shape[2])
    p = _probs(q, k, lse, causal, head_dim)
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    return (scale * torch.einsum("bqk,bkd->bqd", ds, k.float())).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {   # ..., bh, s, d, head_dim, dtype, causal, stream
    "bagua_flash_fwd": [_P] * 5 + [_I] * 6 + [_P],
    "bagua_flash_bwd_dkv": [_P] * 8 + [_I] * 6 + [_P],
    "bagua_flash_bwd_dq": [_P] * 7 + [_I] * 6 + [_P],
}
_lib_cache = []


def _lib():
    if not _lib_cache:
        _lib_cache.append(_build.bind("flash_attention", _SIGNATURES))
    return _lib_cache[0]


def kernels_take(head_dim: int, dtype: torch.dtype) -> bool:
    """Whether :func:`flash_attention` runs the kernels for a CUDA tensor of
    this head_dim and dtype (padding the head to a multiple of
    ``WIDTH_MULTIPLE`` first)."""
    return dtype in _DTYPE_CODE and head_dim > 0


def _require_taken(head_dim: int, dtype: torch.dtype) -> None:
    """Raise unless :func:`kernels_take` accepts the head."""
    if not kernels_take(head_dim, dtype):
        raise ValueError(f"flash kernels take float16, bfloat16 or float32 with a "
                         f"positive head_dim, got {dtype} and {head_dim}")


def _check(mats, rows, head_dim):
    """Raise on anything the kernels do not take: every tensor on one CUDA
    device and contiguous; ``mats`` ``[bh, s, d]`` of one dtype and width
    that :func:`kernels_take` accepts, d a multiple of ``WIDTH_MULTIPLE``
    and ``head_dim`` (the scale's) at most d, each starting on a 16-byte
    boundary (the 16-bit kernels load them by TMA); ``rows`` ``[bh, s]``
    f32.  Returns ``(bh, s, d, head_dim, dtype code)``."""
    ref = mats[0]
    if ref.device.type != "cuda":
        raise ValueError(f"flash kernels take CUDA tensors, got {ref.device}")
    if ref.dim() != 3:
        raise ValueError(f"expected [bh, s, d], got {tuple(ref.shape)}")
    bh, s, d = ref.shape
    _require_taken(d, ref.dtype)
    if d % WIDTH_MULTIPLE:
        raise ValueError(f"flash kernels take a stored head_dim that is a multiple "
                         f"of {WIDTH_MULTIPLE} (flash_attention pads others), got {d}")
    head_dim = head_dim or d
    if not 0 < head_dim <= d:
        raise ValueError(f"head_dim {head_dim} of the scale must be within the stored {d}")
    for t in mats:
        if t.shape != ref.shape or t.dtype != ref.dtype:
            raise ValueError(f"operand {tuple(t.shape)} {t.dtype} does not "
                             f"match {tuple(ref.shape)} {ref.dtype}")
    for t in rows:
        if t.shape != (bh, s) or t.dtype != torch.float32:
            raise ValueError(f"row statistic must be [bh, s] float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for t in (*mats, *rows):
        if t.device != ref.device:
            raise ValueError(f"operands on {t.device} and {ref.device}")
        if not t.is_contiguous():
            raise ValueError("flash kernels take contiguous tensors")
    if any(t.data_ptr() % 16 for t in mats):
        raise ValueError("flash kernels take tensors starting on a 16-byte boundary")
    return bh, s, d, head_dim, _DTYPE_CODE[ref.dtype]


def flash_fwd(q, k, v, causal: bool, head_dim=None):
    """Forward kernel: ``(o [bh, s, d], lse [bh, s] f32)``; the scale is
    ``1/sqrt(head_dim)``, by default of the width d."""
    if q.device.type == "cpu":
        return fwd_plain(q, k, v, causal, head_dim)
    bh, s, d, hd, code = _check((q, k, v), (), head_dim)
    o = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    _build.launch(_lib().bagua_flash_fwd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  o.data_ptr(), lse.data_ptr(), bh, s, d, hd, code, int(causal))
    flash_fwd.launches += 1
    return o, lse


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, head_dim=None):
    """dK/dV kernel: ``(dk, dv)``, each ``[bh, s, d]``."""
    if q.device.type == "cpu":
        return dkv_plain(q, k, v, do, lse, delta, causal, head_dim)
    bh, s, d, hd, code = _check((q, k, v, do), (lse, delta), head_dim)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.launch(_lib().bagua_flash_bwd_dkv, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), bh, s, d, hd, code, int(causal))
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, head_dim=None):
    """dQ kernel: ``dq [bh, s, d]``."""
    if q.device.type == "cpu":
        return dq_plain(q, k, v, do, lse, delta, causal, head_dim)
    bh, s, d, hd, code = _check((q, k, v, do), (lse, delta), head_dim)
    dq = torch.empty_like(q)
    _build.launch(_lib().bagua_flash_bwd_dq, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  dq.data_ptr(), bh, s, d, hd, code, int(causal))
    flash_bwd_dq.launches += 1
    return dq


KERNELS = (flash_fwd, flash_bwd_dkv, flash_bwd_dq)


def reset_launch_counts() -> None:
    """Zero every kernel's launch count."""
    for k in KERNELS:
        k.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class _FlashLse(torch.autograd.Function):
    """``(o, lse)`` of folded ``[bh, s, d]`` inputs, the scale that of
    ``head_dim``; the backward is the two backward kernels.  ``dlse`` (the
    logsumexp's cotangent, nonzero only when a caller consumes lse) enters as
    ``delta - dlse``, as in JAX."""

    @staticmethod
    def forward(ctx, q, k, v, causal, head_dim=None):
        o, lse = flash_fwd(q, k, v, causal, head_dim)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.head_dim = causal, head_dim
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1) - dlse.float()
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal, ctx.head_dim)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal, ctx.head_dim)
        return dq, dk, dv, None, None


def _kernel_path(x) -> bool:
    """Whether the entry points send ``x`` to the kernel wrappers as the
    kernels take it (padded), rather than to the plain versions as it is."""
    return x.device.type != "cpu"


def _fold(x):  # [b, s, h, d] -> [b*h, s, d], contiguous
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()


def _flash_lse(q, k, v, causal):
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    width = d
    if _kernel_path(q) and d % WIDTH_MULTIPLE:
        _require_taken(d, q.dtype)   # before padding, so that the message has the real head
        # the kernels' rows must be a multiple of WIDTH_MULTIPLE elements:
        # zero columns add nothing to a score or an output column, and the
        # scale stays that of d; autograd slices the gradients back
        width = -(-d // WIDTH_MULTIPLE) * WIDTH_MULTIPLE
        q, k, v = (F.pad(x, (0, width - d)) for x in (q, k, v))
    o, lse = _FlashLse.apply(_fold(q), _fold(k), _fold(v), causal, d)
    return o.view(b, h, s, width).permute(0, 2, 1, 3)[..., :d], lse.view(b, h, s)


def flash_attention(q, k, v, dtype: Optional[torch.dtype] = None, *,
                    causal: bool = True):
    """Drop-in for :func:`reference_attention`: ``q/k/v`` are
    ``[batch, seq, heads, head_dim]``; returns the same shape in ``dtype``
    (default ``q.dtype``)."""
    o, _ = _flash_lse(q, k, v, causal)
    return o.to(dtype or q.dtype)


def flash_attention_with_lse(q, k, v, *, causal: bool):
    """Like :func:`flash_attention` but also returns the per-row logsumexp
    ``[batch, heads, seq]`` f32, the merge statistic of ring attention.
    ``o`` is f32 (merging precision)."""
    o, lse = _flash_lse(q, k, v, causal)
    return o.float(), lse


reset_launch_counts()   # every count starts at zero
