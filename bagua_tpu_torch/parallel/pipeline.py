"""Pipeline parallelism (GPipe) over a mesh axis.

Port of ``bagua_tpu/parallel/pipeline.py``.  The transformer's blocks are
held STACKED: one :class:`~bagua_tpu_torch.models.transformer.Block`'s
parameters, each with a leading dim of the stage's ``n_layers / pp_size``
layers (``blocks.attn.q.weight`` ``[L / pp, h * d, d_model]``, as JAX's
``nn.scan`` stacks ``blocks.block``), so that the stage dim is dim 0 of every
block leaf (:func:`pp_param_dim`).  Layer ``i`` runs through the module's one
``Block`` with ``torch.func.functional_call`` on the ``i``-th slices (under
``remat_wrap`` when ``cfg.remat`` is set).  Stage ``s`` holds layers
``[s L / pp, (s + 1) L / pp)``.

One step runs JAX's schedule (``pipeline.py:100-139``) as ``n_micro + pp -
1`` ticks: every tick every stage embeds its feed microbatch, takes the
embedding on stage 0 and what it received elsewhere, applies its blocks,
computes the loss of the microbatch leaving the pipeline, and hands its
output one hop down (``ppermute`` ``(i, i + 1)``, no wraparound: the last
stage's goes nowhere, stage 0 receives zeros); the last stage adds the
losses of the ticks that carry a real microbatch.  ``tp_reduce`` over the
axis, divided by ``n_micro``, gives every stage the mean loss.  The bubble
ticks compute what JAX computes (zeros in, a masked loss).

The stage and tick selections are tensor masks (``torch.where``), as JAX's
``jnp.where``, never Python branches on the stage: every rank builds the
same graph, with the same transfers in the same order.  The ``ppermute``
backward is the inverse transfer, and autograd runs a node only where its
output reached the loss; stage 0's blocks get their gradient through the
backward of the transfer that sent their output, which runs because stage
0's ``where`` takes (and zeroes) what it received.  The last tick's receive
has no consumer on any rank, so its backward runs nowhere.

The embedding, position table, final norm and head are replicated over the
stages, and each stage's gradient of them is partial: the trainer's
``pp_axis`` multiplies them by ``pp_size`` and reduces them over a comm
world that spans pp, which turns the average into the sum.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..models.transformer import (Block, Dense, PosEmbed, RMSNorm, TransformerConfig,
                                  tp_param_dim as _tp_param_dim, tp_param_fan_in_dims)
from ..utils import remat_wrap
from . import functional as pf
from .mesh import require_axis
from .tensor_parallel import axis_rank, redraw_lecun, tp_reduce, tp_slice


class PipelinedTransformerLM(nn.Module):
    """Causal LM whose forward returns its LOSS, computed inside the
    pipeline schedule: ``forward(tokens [batch, seq + 1]) -> scalar`` (the
    mean next-token cross-entropy, the same on every stage).
    ``cfg.n_layers`` must divide by ``pp_size``; the module holds the
    stage's ``n_layers / pp_size`` blocks (stacked), so every stage built
    from one seed holds the same blocks: :func:`globalize_pp_params` redraws
    them.  With ``pp_size == 1`` the forward is the plain sequential run of
    the whole batch.  Parameters register in the JAX package's flatten
    order: ``blocks``, ``embed``, ``final_norm``, ``lm_head``,
    ``pos_embed``.  Weights are drawn from ``seed`` on ``device`` (``cuda``
    unless the caller passes another)."""

    def __init__(self, cfg: TransformerConfig, pp_size: int, n_microbatches: int = 1,
                 pp_axis: str = "pp", device=None, seed: int = 0):
        super().__init__()
        if cfg.n_layers % pp_size:
            raise ValueError(f"n_layers {cfg.n_layers} does not split over pp_size {pp_size}")
        self.cfg, self.pp_size, self.n_microbatches, self.pp_axis = (
            cfg, pp_size, n_microbatches, pp_axis)
        self.n_local = cfg.n_layers // pp_size
        self.blocks = Block(cfg)
        for mod in self.blocks.modules():
            for pname, p in list(mod._parameters.items()):
                if p is not None:
                    mod._parameters[pname] = nn.Parameter(
                        p.detach().new_empty((self.n_local,) + tuple(p.shape)))
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model, dtype=cfg.param_dtype)
        self.final_norm = RMSNorm(cfg.d_model, cfg)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, cfg)
        self.pos_embed = PosEmbed(cfg)
        device = resolve_device(device)
        self.to(device)
        self.reset_parameters(torch.Generator(device=device).manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """As ``TransformerLM``'s: ``Dense`` normal with std ``1 /
        sqrt(fan_in)`` (per layer for the stacked ones), embedding std ``1 /
        sqrt(d_model)``, position table std 0.02, norm scales 1."""
        for m in self.modules():
            if isinstance(m, Dense):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features), generator=generator)
            elif isinstance(m, RMSNorm):
                m.scale.fill_(1.0)
        self.embed.weight.normal_(0.0, 1.0 / math.sqrt(self.cfg.d_model), generator=generator)
        self.pos_embed.weight.normal_(0.0, 0.02, generator=generator)

    def _embed(self, tokens):
        s, dtype = tokens.shape[1], self.cfg.dtype
        return self.embed(tokens).to(dtype) + self.pos_embed.weight[:s].to(dtype)

    def _apply_blocks(self, x):
        """The stage's layers in order, each through the one ``Block`` on
        its slices of the stacked parameters."""
        stacked = dict(self.blocks.named_parameters())
        for i in range(self.n_local):
            layer = {n: p[i] for n, p in stacked.items()}

            def one(h, layer=layer):
                return torch.func.functional_call(self.blocks, layer, (h,))

            x = (remat_wrap(one, self.cfg.remat_policy) if self.cfg.remat else one)(x)
        return x

    def _loss(self, y, targets):
        logits = self.lm_head(self.final_norm(y)).float()
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets.reshape(-1).long())

    def forward(self, tokens):
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        pp, n_micro = self.pp_size, self.n_microbatches
        if pp == 1:
            # the degenerate path: the sequential run of the whole batch
            return self._loss(self._apply_blocks(self._embed(inputs)), targets)
        mesh = require_axis(self.pp_axis, pp, "pipeline parallelism")
        comm, stage = mesh.comm(self.pp_axis), mesh.coords[self.pp_axis]
        b = inputs.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
        mb_in = inputs.reshape(n_micro, b // n_micro, -1)
        mb_tgt = targets.reshape(n_micro, b // n_micro, -1)
        ticks = n_micro + pp - 1
        perm = [(i, i + 1) for i in range(pp - 1)]
        dev = tokens.device
        first = torch.tensor(stage == 0, device=dev)
        # the last stage takes the loss of the ticks whose microbatch leaves
        take = torch.tensor([stage == pp - 1 and 0 <= t - (pp - 1) < n_micro
                             for t in range(ticks)], device=dev)
        recv = torch.zeros(b // n_micro, inputs.shape[1], self.cfg.d_model,
                           dtype=self.cfg.dtype, device=dev)
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for t in range(ticks):
            x0 = self._embed(mb_in[min(t, n_micro - 1)])
            y = self._apply_blocks(torch.where(first, x0, recv))
            ls = self._loss(y, mb_tgt[min(max(t - (pp - 1), 0), n_micro - 1)])
            acc = acc + torch.where(take[t], ls, torch.zeros_like(ls))
            recv = pf.ppermute(y, comm, perm)
        # only the last stage accumulated: the sum over the axis replicates
        # it, and its backward is the identity (an allreduce backward would
        # scale every gradient by pp)
        return tp_reduce(acc, comm) / n_micro


def pp_param_dim(name: str) -> Optional[int]:
    """The stage dim of a :class:`PipelinedTransformerLM` parameter: 0 for
    every leaf under ``blocks`` (an exact path segment, never a substring),
    None for the replicated ones."""
    return 0 if "blocks" in name.split(".") else None


def pp_lm_loss_fn(model: PipelinedTransformerLM, batch) -> torch.Tensor:
    """The trainer's loss function of a :class:`PipelinedTransformerLM`:
    its forward on ``batch["tokens"]`` (``[batch, seq + 1]``)."""
    return model(batch["tokens"])


def globalize_pp_params(model: PipelinedTransformerLM, generator: torch.Generator,
                        pp_size: int, tp_size: int = 1, tp_param_dim=None,
                        pp_rank: Optional[int] = None) -> PipelinedTransformerLM:
    """Re-draw every stage-stacked leaf at its GLOBAL shape ``[L, ...]``, in
    place (``pipeline.py:172-198``): norm scales ones, weights lecun-normal
    over their per-layer contracting dims (the tensor-parallel table's,
    shifted past the layer dim), from ``generator``, seeded alike on every
    rank; each rank keeps its stage's layers (``pp_rank``, default its
    coordinate on ``model.pp_axis``).  With ``tp_size > 1`` (3-D
    parallelism) a tensor-parallel leaf's dim (``tp_param_dim``, per-layer
    coordinates) is drawn at its global width too, and the rank keeps its
    slice (its coordinate on ``model.cfg.tp_axis``).  Returns ``model``."""
    if pp_size == 1 and tp_size == 1:
        return model
    tp_param_dim = tp_param_dim or _tp_param_dim
    if pp_rank is None:
        pp_rank = axis_rank(model.pp_axis, pp_size, "globalize_pp_params")
    tp_rank = axis_rank(model.cfg.tp_axis, tp_size, "globalize_pp_params")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if pp_param_dim(name) is None:
                continue
            n_local = p.shape[0]
            shape = [n_local * pp_size, *p.shape[1:]]
            if name.endswith(".scale"):
                p.fill_(1.0)
                continue
            tpd = tp_param_dim(name) if tp_size > 1 else None
            if tpd is not None:
                shape[tpd + 1] *= tp_size
            inner = tp_param_fan_in_dims(name)
            contracting = (tuple(a + 1 for a in inner) if inner is not None
                           else (len(shape) - 1,))
            full = redraw_lecun(shape, contracting, generator, p.dtype)
            full = full[pp_rank * n_local:(pp_rank + 1) * n_local]
            if tpd is not None:
                full = tp_slice(full, tpd + 1, tp_size, tp_rank)
            p.copy_(full)
    return model
