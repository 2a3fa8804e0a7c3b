"""Mixture-of-Experts MLP on one expert shard.

Port of ``bagua_tpu/model_parallel/moe/layer.py`` at ``ep_size == 1``:
``MoEMLP`` in both its routing modes (dropless: sort by expert + the
grouped-matmul kernels of :mod:`bagua_tpu_torch.ops.gmm`; capacity: GShard
dense dispatch einsums), the expert-parameter names, and the LM loss with the
load-balancing term.  Expert parallelism (``ep_size > 1``: the dropless
ragged exchange, the capacity path's all-to-all, ``globalize_expert_params``)
needs several cards and is not ported yet.

Parameters register in the JAX flatten order of the flax module
(``expert_wi``, ``expert_wo``, ``router``), so the trainer's bucket plan
lists them as the JAX trainer's does.  The expert tables keep the JAX layout
``[n_experts, d_in, d_out]``; the router is a ``Linear`` (``[E, d_model]``).
"""

from __future__ import annotations

import math
import re
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.gmm import gmm
from .gating import top1_gating, top2_gating, topk_routing

_EP_NOT_PORTED = ("expert parallelism (ep_size > 1) needs several cards and is "
                  "not ported yet")


class MoEMLP(nn.Module):
    """Drop-in MLP replacement: tokens ``[batch, seq, d_model]`` -> same.

    Plugs into ``TransformerLM`` through ``mlp_factory``.  ``dropless=True``
    routes capacity-free: every (token, expert) pair of the top-k routing is
    computed by :func:`~bagua_tpu_torch.ops.gmm.gmm` over the tokens sorted
    by expert, so no token is dropped however skewed the routing.  The
    default capacity path drops a token past ``capacity_factor`` (GShard).
    ``gmm_fn`` replaces :func:`gmm` (for example with the plain reference).
    After each forward, ``l_aux`` holds that forward's load-balancing loss.
    """

    def __init__(self, n_experts: int, d_ff: int, *, d_model: int, ep_size: int = 1,
                 k: int = 2, capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32, dropless: bool = False,
                 gmm_fn: Optional[Callable] = None):
        super().__init__()
        if ep_size != 1:
            raise NotImplementedError(_EP_NOT_PORTED)
        self.n_experts, self.k = n_experts, k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.dropless = dropless
        self.gmm_fn = gmm_fn or gmm
        # registration order = the flax flatten order: expert_wi, expert_wo, router
        self.expert_wi = nn.Parameter(torch.empty(n_experts, d_model, d_ff, dtype=param_dtype))
        self.expert_wo = nn.Parameter(torch.empty(n_experts, d_ff, d_model, dtype=param_dtype))
        # the router is f32 whatever param_dtype is, as in the JAX package
        self.router = nn.Linear(d_model, n_experts, bias=False, dtype=torch.float32)
        self.l_aux: Optional[torch.Tensor] = None
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Normal with std ``1/sqrt(fan_in)``, as the port's ``Dense``."""
        for w, fan_in in ((self.expert_wi, self.expert_wi.shape[1]),
                          (self.expert_wo, self.expert_wo.shape[1]),
                          (self.router.weight, self.router.in_features)):
            w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)

    def forward(self, x):
        b, s, d = x.shape
        xt = x.reshape(b * s, d)
        logits = self.router(xt.float())   # f32: small, precision-sensitive
        route = self._dropless if self.dropless else self._capacity
        return route(xt, logits).reshape(b, s, d)

    def _dropless(self, xt, logits):
        """Sort by expert + grouped matmul.  Nothing here reads a device
        value back to the host: the group sizes are a scatter-add on the
        card and the kernels read them there."""
        eidx, gates, self.l_aux = topk_routing(logits, self.k)
        flat_e = eidx.reshape(-1)                             # [T*k]
        order = torch.argsort(flat_e, stable=True)            # ties by token
        token_of_row = order // self.k
        x_rows = xt.index_select(0, token_of_row).to(self.dtype)   # grouped
        sizes = torch.zeros(self.n_experts, dtype=torch.int32, device=xt.device)
        sizes.scatter_add_(0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))
        h = F.silu(self.gmm_fn(x_rows, self.expert_wi.to(self.dtype), sizes))
        y_rows = self.gmm_fn(h, self.expert_wo.to(self.dtype), sizes)
        w = gates.reshape(-1).index_select(0, order).to(self.dtype)
        # the scatter adds in the compute dtype, as the JAX .at[].add does
        out = torch.zeros(xt.shape, dtype=self.dtype, device=xt.device)
        return out.index_add(0, token_of_row, y_rows * w[:, None])

    def _capacity(self, xt, logits):
        """GShard dispatch / combine einsums with capacity dropping."""
        dt = self.dtype
        capacity = max(1, math.ceil(self.k * xt.shape[0] * self.capacity_factor
                                    / self.n_experts))
        gate = top1_gating if self.k == 1 else top2_gating
        dispatch, combine, self.l_aux = gate(logits, capacity)
        expert_in = torch.einsum("tec,td->ecd", dispatch.to(dt), xt.to(dt))
        h = F.silu(torch.einsum("ecd,edf->ecf", expert_in, self.expert_wi.to(dt)))
        out = torch.einsum("ecf,efd->ecd", h, self.expert_wo.to(dt))
        return torch.einsum("tec,ecd->td", combine.to(dt), out)


# The exact parameter names MoEMLP creates.  Marking is by path *segment*
# equality, never by substring, as in the JAX package.
EXPERT_PARAM_NAMES = frozenset({"expert_wi", "expert_wo"})


def is_expert_param(name: str) -> bool:
    """True for params created by :class:`MoEMLP` (exact segment match of a
    dotted, slashed or bracketed path)."""
    return not EXPERT_PARAM_NAMES.isdisjoint(re.split(r"[\[\]'\"./]+", name))


def globalize_expert_params(*args, **kwargs):
    """Re-draw expert tables at global shape for expert parallelism."""
    raise NotImplementedError(_EP_NOT_PORTED)


def moe_lm_loss_fn(aux_loss_weight: float = 0.01) -> Callable:
    """``loss_fn(model, batch)``: next-token cross-entropy plus
    ``aux_loss_weight`` times the sum of every :class:`MoEMLP`'s
    load-balancing loss from this forward; ``batch = dict(tokens=[b, s+1])``."""

    def loss_fn(model, batch):
        moes = [m for m in model.modules() if isinstance(m, MoEMLP)]
        for m in moes:
            m.l_aux = None   # nothing carries over from an earlier forward
        tokens = batch["tokens"]
        logits = model(tokens[:, :-1])
        nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                              tokens[:, 1:].reshape(-1).long())
        aux = sum((m.l_aux for m in moes if m.l_aux is not None),
                  torch.zeros((), device=logits.device))
        return nll + aux_loss_weight * aux

    return loss_fn
