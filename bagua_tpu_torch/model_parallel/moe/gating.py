"""GShard top-1 / top-2 gating and dropless top-k routing.

Port of ``bagua_tpu/model_parallel/moe/gating.py``: the same dense one-hot
math.  One-hots are built by comparison with ``arange`` rather than
``F.one_hot``, which reads its input's range back to the host on a card.

Shapes: ``logits`` is ``[tokens, n_experts]``; the capacity gates return
``dispatch`` ``[tokens, n_experts, capacity]`` (0/1), ``combine`` of the
same shape weighted by the gate probability, and ``l_aux`` a scalar.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _one_hot(index, n: int):
    """f32 one-hot of ``index`` over ``n`` classes; an index outside
    ``[0, n)`` gives a zero row, as ``jax.nn.one_hot`` does."""
    return (index[..., None] == torch.arange(n, device=index.device)).float()


def _positions_in_expert(mask):
    """For each (token, expert) with mask 1: how many earlier tokens chose
    this expert (its slot in the expert's capacity buffer)."""
    return (torch.cumsum(mask, dim=0) - 1) * mask


def _load_balancing_loss(probs, mask):
    """GShard aux loss: ``n_experts * sum_e mean_t(probs) * mean_t(mask)``."""
    n_experts = probs.shape[-1]
    density = mask.float().mean(dim=0)
    density_proxy = probs.mean(dim=0)
    return torch.sum(density * density_proxy) * n_experts


def top1_gating(logits, capacity: int):
    """Switch-style top-1 routing with capacity dropping."""
    probs = torch.softmax(logits.float(), dim=-1)
    n_experts = probs.shape[-1]
    mask = _one_hot(torch.argmax(probs, dim=-1), n_experts)
    l_aux = _load_balancing_loss(probs, mask)

    pos = _positions_in_expert(mask)
    keep = mask * (pos < capacity)
    gate = (probs * keep).sum(dim=-1)  # chosen prob; 0 for dropped tokens
    dispatch = keep[:, :, None] * _one_hot(pos.long(), capacity)
    combine = gate[:, None, None] * dispatch
    return dispatch, combine, l_aux


def topk_routing(logits, k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dropless top-k routing: ``(expert_idx [tokens, k] int64, gate_weights
    [tokens, k], l_aux)``.  Top-1 keeps the raw chosen probability, top-k > 1
    renormalizes over the winners; the aux loss is over the top-1
    assignment (GShard eq. 4)."""
    probs = torch.softmax(logits.float(), dim=-1)
    n_experts = probs.shape[-1]
    gates, eidx = torch.topk(probs, k, dim=-1)
    l_aux = _load_balancing_loss(probs, _one_hot(eidx[:, 0], n_experts))
    if k > 1:
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return eidx, gates, l_aux


def top2_gating(logits, capacity: int):
    """GShard top-2 routing: the second expert is chosen from the masked
    distribution, gates renormalized over the two winners."""
    probs = torch.softmax(logits.float(), dim=-1)
    n_experts = probs.shape[-1]

    mask1 = _one_hot(torch.argmax(probs, dim=-1), n_experts)
    mask2 = _one_hot(torch.argmax(probs * (1.0 - mask1), dim=-1), n_experts)

    # aux loss over the top-1 assignment only (GShard eq. 4)
    l_aux = _load_balancing_loss(probs, mask1)

    # capacity: first-choice tokens fill slots before second-choice tokens
    pos1 = _positions_in_expert(mask1)
    count1 = mask1.sum(dim=0, keepdim=True)
    pos2 = _positions_in_expert(mask2) + count1 * mask2
    keep1 = mask1 * (pos1 < capacity)
    keep2 = mask2 * (pos2 < capacity)

    g1 = (probs * keep1).sum(dim=-1)
    g2 = (probs * keep2).sum(dim=-1)
    denom = (g1 + g2).clamp_min(1e-9)
    g1, g2 = g1 / denom, g2 / denom

    dispatch1 = keep1[:, :, None] * _one_hot(pos1.long(), capacity)
    dispatch2 = keep2[:, :, None] * _one_hot(pos2.long(), capacity)
    dispatch = torch.maximum(dispatch1, dispatch2)
    combine = g1[:, None, None] * dispatch1 + g2[:, None, None] * dispatch2
    return dispatch, combine, l_aux
