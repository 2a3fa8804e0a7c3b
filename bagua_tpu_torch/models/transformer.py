"""Decoder-only Transformer LM.

Port of the training path of ``bagua_tpu/models/transformer.py``: params in
f32, every matmul in ``cfg.dtype`` (bf16 by default) with explicit casts
where flax casts (``Dense`` casts input and kernel per matmul, ``RMSNorm``
computes in f32 and returns ``cfg.dtype``, the position embedding is cast
before the add, the logits are computed in ``cfg.dtype`` and returned as
f32).  Attention goes through :func:`~bagua_tpu_torch.ops.flash_attention`
at every sequence length.

Submodules and parameters are registered in the order the JAX package's
sorted pytree flatten visits them (``block_0, ..., embed, final_norm,
lm_head, pos_embed``; within a block ``attn, attn_norm, mlp, mlp_norm``, or
with an ``mlp_factory`` module such as ``MoEMLP``, which flax names
``MoEMLP_0``, that module first), so ``build_params`` lists them, and
``BucketPlan.build`` buckets them, exactly as the JAX trainer does.  Weights
follow torch's layouts (``Linear`` is ``[out, in]``); ``models.convert`` maps
flax params onto them.

``remat`` recomputes each block in the backward (``utils.remat_wrap`` with
``remat_policy``), as the JAX model does (``transformer.py:395-398``); the
blocks stay the same modules, so the parameter names and their order do not
change.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.flash_attention import flash_attention
from ..utils import remat_wrap


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 2048
    max_seq_len: int = 1024
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False
    #: rematerialization policy when ``remat`` is on: None = recompute the
    #: whole block (lowest memory), "dots" = save every matmul output,
    #: "dots_no_batch" = save matmul outputs without batch dims
    remat_policy: Optional[str] = None

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads


def bert_large_config(**kw) -> TransformerConfig:
    """BERT-Large-scale shapes (the reference's SQuAD workload scale).
    Keyword overrides (e.g. ``max_seq_len=384`` for SQuAD) replace defaults."""
    defaults = dict(vocab_size=30528, d_model=1024, n_heads=16, n_layers=24, d_ff=4096,
                    max_seq_len=512)
    defaults.update(kw)
    return TransformerConfig(**defaults)


class Dense(nn.Linear):
    """Bias-free ``Linear`` whose input and weight are cast to ``dtype`` for
    the product, like flax ``Dense(dtype=...)``."""

    def __init__(self, d_in: int, d_out: int, cfg: TransformerConfig):
        super().__init__(d_in, d_out, bias=False, dtype=cfg.param_dtype)
        self.compute_dtype = cfg.dtype

    def forward(self, x):
        return F.linear(x.to(self.compute_dtype), self.weight.to(self.compute_dtype))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, cfg: TransformerConfig):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=cfg.param_dtype))
        self.dtype = cfg.dtype

    def forward(self, x):
        x32 = x.float()
        y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + 1e-6)
        return (y * self.scale).to(self.dtype)


class PosEmbed(nn.Module):
    """The learned position table, in a module of its own so that it
    registers after ``lm_head`` (see the module docstring)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(cfg.max_seq_len, cfg.d_model, dtype=cfg.param_dtype))


def causal_attention(q, k, v, dtype):
    """Causal attention; ``q/k/v`` ``[batch, seq, heads, head_dim]``."""
    return flash_attention(q, k, v, dtype, causal=True)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, attn_fn: Optional[Callable] = None):
        super().__init__()
        self.cfg = cfg
        self.attn_fn = attn_fn or causal_attention
        hd = cfg.n_heads * cfg.head_dim
        # registration order k, o, q, v: the JAX flatten order
        self.k = Dense(cfg.d_model, hd, cfg)
        self.o = Dense(hd, cfg.d_model, cfg)
        self.q = Dense(cfg.d_model, hd, cfg)
        self.v = Dense(cfg.d_model, hd, cfg)

    def forward(self, x):
        b, s, _ = x.shape
        h, d = self.cfg.n_heads, self.cfg.head_dim
        q, k, v = (proj(x).view(b, s, h, d) for proj in (self.q, self.k, self.v))
        o = self.attn_fn(q, k, v, self.cfg.dtype)
        return self.o(o.reshape(b, s, h * d))


class MLPBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.wi_gate = Dense(cfg.d_model, cfg.d_ff, cfg)
        self.wi_up = Dense(cfg.d_model, cfg.d_ff, cfg)
        self.wo = Dense(cfg.d_ff, cfg.d_model, cfg)

    def forward(self, x):
        return self.wo(F.silu(self.wi_gate(x)) * self.wi_up(x))


class Block(nn.Module):
    """Pre-norm attention and MLP.  ``mlp()``, when given, builds the MLP
    (a MoE drops in here); it registers first, where flax's sorted flatten
    puts its auto-named module."""

    def __init__(self, cfg: TransformerConfig, attn_fn: Optional[Callable] = None,
                 mlp: Optional[Callable[[], nn.Module]] = None):
        super().__init__()
        if mlp is not None:
            self.mlp = mlp()
        self.attn = Attention(cfg, attn_fn)
        self.attn_norm = RMSNorm(cfg.d_model, cfg)
        if mlp is None:
            self.mlp = MLPBlock(cfg)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg)

    def forward(self, x):
        x = x + self.attn(self.attn_norm(x))
        return x + self.mlp(self.mlp_norm(x))


class TransformerLM(nn.Module):
    """Causal LM: token ids ``[batch, seq]`` -> logits ``[batch, seq, vocab]``
    f32.  Weights are drawn from ``seed`` on ``device`` (``cuda`` unless the
    caller passes another).  ``attn_fn(q, k, v, dtype)`` replaces
    :func:`causal_attention` (for example with the plain reference).
    ``mlp_factory(i)`` returns, for layer ``i``, a zero-argument function
    that makes that block's MLP (e.g. a ``MoEMLP``), or None for the dense
    one, as in the JAX package."""

    def __init__(self, cfg: TransformerConfig, device=None, seed: int = 0,
                 attn_fn: Optional[Callable] = None,
                 mlp_factory: Optional[Callable[[int], Optional[Callable]]] = None):
        super().__init__()
        self.cfg = cfg
        for i in sorted(range(cfg.n_layers), key=str):
            mlp = mlp_factory(i) if mlp_factory is not None else None
            self.add_module(f"block_{i}", Block(cfg, attn_fn, mlp))
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model, dtype=cfg.param_dtype)
        self.final_norm = RMSNorm(cfg.d_model, cfg)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, cfg)
        self.pos_embed = PosEmbed(cfg)
        device = resolve_device(device)
        self.to(device)
        self.reset_parameters(torch.Generator(device=device).manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Flax-like initialization: ``Dense`` normal with std
        ``1/sqrt(fan_in)``, embedding std ``1/sqrt(d_model)``, position table
        std 0.02, norm scales 1.  An MLP built by ``mlp_factory`` initializes
        itself through its own ``reset_parameters(generator)``."""
        for m in self.modules():
            if isinstance(m, Dense):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features),
                                 generator=generator)
            elif isinstance(m, RMSNorm):
                m.scale.fill_(1.0)
            elif isinstance(m, Block) and not isinstance(m.mlp, MLPBlock):
                m.mlp.reset_parameters(generator)
        self.embed.weight.normal_(0.0, 1.0 / math.sqrt(self.cfg.d_model),
                                  generator=generator)
        self.pos_embed.weight.normal_(0.0, 0.02, generator=generator)

    def forward(self, tokens):
        cfg = self.cfg
        s = tokens.shape[1]
        x = self.embed(tokens).to(cfg.dtype)
        x = x + self.pos_embed.weight[:s].to(cfg.dtype)
        for i in range(cfg.n_layers):
            block = getattr(self, f"block_{i}")
            x = (remat_wrap(block, cfg.remat_policy) if cfg.remat else block)(x)
        return self.lm_head(self.final_norm(x)).float()


def lm_loss_fn(model: TransformerLM, batch) -> torch.Tensor:
    """Next-token cross-entropy; ``batch = dict(tokens=[b, s+1])``."""
    tokens = batch["tokens"]
    logits = model(tokens[:, :-1])
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1).long())
