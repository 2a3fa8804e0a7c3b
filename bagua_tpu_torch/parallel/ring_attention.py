"""Ring attention: causal attention over a sequence sharded on a mesh axis.

Port of ``bagua_tpu/parallel/ring_attention.py`` (Liu et al., arXiv
2310.01889).  The sequence is split over the ``sp`` axis of the global mesh
(rank at coordinate i holds positions ``[i s, (i + 1) s)``).  Each of the
``sp`` steps attends the local queries to one K/V block while
:func:`~bagua_tpu_torch.parallel.functional.ppermute` passes K/V one hop
around the ring, so that after t hops a rank holds the block of shard
``(i - t) mod sp``; the backward sends the K/V cotangents back the same way.

Two forms of the per-block attention, chosen by ``use_flash``:

- ``"never"``: the inline online-softmax loop in f32 (``:66-102``), the
  plain version, which materializes each block's ``[s, s]`` scores;
- ``"always"`` and ``"auto"``: ``_ring_flash`` (``:118-144``): the flash
  kernels with the row logsumexp (:func:`flash_attention_with_lse`), causal
  on the diagonal block and non-causal against earlier shards, merged with
  the ``(o, lse)`` statistics (:func:`merge_partials`).  A block from a later
  shard is computed all the same (every rank runs the same kernels, and the
  ring's hops are collective) and gets ``lse = NEG_INF``: a zero merge weight
  and a zero cotangent, so the kernels' backward sees ``do = 0`` and
  ``dlse = 0`` there.

The JAX package's TPU gate ``flash_supported`` is not carried over: on the
card ``"auto"`` takes the kernels, as every other attention of the port
does.
"""

from __future__ import annotations

import math

import torch

from ..ops.flash_attention import NEG_INF, flash_attention, flash_attention_with_lse
from . import functional as pf
from .mesh import require_axis


def make_ring_attention(sp_size: int, axis_name: str = "sp", use_flash: str = "auto"):
    """An ``attn_fn(q, k, v, dtype)`` for ``TransformerLM`` that runs causal
    attention over a sequence sharded on ``axis_name`` of the global mesh
    (of size ``sp_size``).  Inputs per rank: ``[batch, seq_local, heads,
    head_dim]``.  With ``sp_size == 1`` and no such axis it is the local
    causal attention."""
    if use_flash not in ("auto", "always", "never"):
        raise ValueError(f"use_flash={use_flash!r}: expected 'auto', 'always', or 'never'")

    def attn_fn(q, k, v, dtype):
        if sp_size == 1:
            return flash_attention(q, k, v, dtype, causal=True)
        mesh = require_axis(axis_name, sp_size, "ring attention")
        comm, my = mesh.comm(axis_name), mesh.coords[axis_name]
        if use_flash != "never":
            return _ring_flash(q, k, v, dtype, sp_size, comm, my)
        return _ring_plain(q, k, v, dtype, sp_size, comm, my)

    return attn_fn


def _ring_perm(sp_size: int):
    # receive from the previous rank
    return [(i, (i + 1) % sp_size) for i in range(sp_size)]


def _ring_plain(q, k, v, dtype, sp_size, comm, my):
    """The inline online-softmax loop in f32."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    q32 = q.float()
    q_pos = my * s + torch.arange(s, device=q.device)
    perm = _ring_perm(sp_size)
    o = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for t in range(sp_size):
        if t:
            k_blk, v_blk = pf.ppermute(k_blk, comm, perm), pf.ppermute(v_blk, comm, perm)
        src = (my - t) % sp_size
        k_pos = src * s + torch.arange(s, device=q.device)
        logits = torch.einsum("bqhd,bkhd->bhqk", q32, k_blk.float()) * scale
        mask = q_pos[:, None] >= k_pos[None, :]
        logits = logits.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        # fully masked blocks contribute nothing (exp(NEG_INF - m) == 0)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_blk.float())
        m = m_new
    out = o / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(dtype)     # [b, s, h, d]


def merge_partials(o1, lse1, o2, lse2):
    """Combine two normalized partial attentions over disjoint K/V sets
    (``:107-115``): ``o`` ``[b, s, h, d]`` f32, ``lse`` ``[b, h, s]`` f32."""
    m = torch.maximum(lse1, lse2)
    w1, w2 = torch.exp(lse1 - m), torch.exp(lse2 - m)
    wsum = w1 + w2

    def wt(w):
        return (w / wsum).transpose(1, 2)[..., None]     # [b, s, h, 1]

    return wt(w1) * o1 + wt(w2) * o2, m + torch.log(wsum)


def _ring_flash(q, k, v, dtype, sp_size, comm, my):
    """Ring attention with the flash kernels per resident block."""
    perm = _ring_perm(sp_size)
    o, lse = flash_attention_with_lse(q, k, v, causal=True)
    k_blk, v_blk = k, v
    for t in range(1, sp_size):
        k_blk, v_blk = pf.ppermute(k_blk, comm, perm), pf.ppermute(v_blk, comm, perm)
        src = (my - t) % sp_size
        o_t, lse_t = flash_attention_with_lse(q, k_blk, v_blk, causal=False)
        if src > my:   # a later shard's block: zero weight, zero cotangent
            lse_t = torch.full_like(lse_t, NEG_INF)
        o, lse = merge_partials(o, lse, o_t, lse_t)
    return o.to(dtype)
