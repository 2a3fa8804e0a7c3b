"""Mixture-of-Experts MLP, expert-parallel over a mesh axis.

Port of ``bagua_tpu/model_parallel/moe/layer.py``: ``MoEMLP`` in both its
routing modes (dropless: sort by expert + the grouped-matmul kernels of
:mod:`bagua_tpu_torch.ops.gmm`; capacity: GShard dense dispatch einsums),
the expert-parameter names, :func:`globalize_expert_params` and the LM loss
with the load-balancing term.

Expert parallelism (``ep_size > 1``) runs over the axis ``axis_name`` of the
global mesh (:mod:`bagua_tpu_torch.parallel.mesh`), whose size must be
``ep_size``: each rank holds the tables of ``n_experts // ep_size`` experts,
those of global ids ``[r * n_local, (r + 1) * n_local)`` at ep coordinate r.
The capacity path sends each expert's slots to its owner and back with two
tiled all-to-alls; the dropless path exchanges the rows routed to each
owner (:meth:`MoEMLP._dropless_exchange`) in one of two forms:

- ``use_ragged=False`` (the default, the JAX package's dense-slot layout):
  rows for peer p fill the fixed slots ``[p * T k, p * T k + count_p)`` of a
  worst-case buffer of ``ep * T k`` rows, which crosses as one all-to-all.
  Nothing is read back to the host, but ``ep`` times the routed rows cross;
  the empty slots' rows are zero, sort after every group and stay zero
  through the kernels (rows past the last group).
- ``use_ragged=True``: exactly the routed rows cross, packed, through the
  communicator's ``alltoall_v``, whose transfer sizes are host integers: the
  per-peer counts are read back once a layer in the forward (the backward
  reuses them).

Both give the same rows to each expert in the same order.  The gates are
applied at the source, after the reverse transfer.

Parameters register in the JAX flatten order of the flax module
(``expert_wi``, ``expert_wo``, ``router``), so the trainer's bucket plan
lists them as the JAX trainer's does.  The expert tables keep the JAX layout
``[n_local, d_in, d_out]``; the router is a ``Linear`` (``[E, d_model]``).
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.gmm import gmm
from ...parallel import functional as pf
from ...parallel.mesh import require_axis
from .gating import top1_gating, top2_gating, topk_routing


class MoEMLP(nn.Module):
    """Drop-in MLP replacement: tokens ``[batch, seq, d_model]`` -> same.

    Plugs into ``TransformerLM`` through ``mlp_factory``.  ``dropless=True``
    routes capacity-free: every (token, expert) pair of the top-k routing is
    computed by :func:`~bagua_tpu_torch.ops.gmm.gmm` over the tokens sorted
    by expert, so no token is dropped however skewed the routing.  The
    default capacity path drops a token past ``capacity_factor`` (GShard).
    ``ep_size > 1`` shards the experts over the mesh axis ``axis_name``
    of the global mesh (the module docstring), which must be set before the
    layer is built.  ``gmm_fn`` replaces :func:`gmm` (for
    example with the plain reference).  After each forward, ``l_aux`` holds
    that forward's load-balancing loss.
    """

    def __init__(self, n_experts: int, d_ff: int, *, d_model: int, ep_size: int = 1,
                 k: int = 2, capacity_factor: float = 1.25, axis_name: str = "ep",
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32, dropless: bool = False,
                 use_ragged: bool = False, gmm_fn: Optional[Callable] = None):
        super().__init__()
        if ep_size < 1 or n_experts % ep_size:
            raise ValueError(f"n_experts {n_experts} must split over ep_size {ep_size}")
        self.n_experts, self.k, self.ep_size = n_experts, k, ep_size
        self.n_local = n_experts // ep_size
        self.capacity_factor = capacity_factor
        self.axis_name = axis_name
        self.dtype = dtype
        self.dropless, self.use_ragged = dropless, use_ragged
        self.gmm_fn = gmm_fn or gmm
        self.ep_rank, self.comm = 0, None
        if ep_size > 1:
            mesh = require_axis(axis_name, ep_size, f"MoEMLP(ep_size={ep_size})")
            self.ep_rank, self.comm = mesh.coords[axis_name], mesh.comm(axis_name)
        # registration order = the flax flatten order: expert_wi, expert_wo, router
        self.expert_wi = nn.Parameter(torch.empty(self.n_local, d_model, d_ff, dtype=param_dtype))
        self.expert_wo = nn.Parameter(torch.empty(self.n_local, d_ff, d_model, dtype=param_dtype))
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
        """Sort by expert + grouped matmul.  On one shard nothing here reads
        a device value back to the host: the group sizes are a scatter-add on
        the card and the kernels read them there."""
        eidx, gates, self.l_aux = topk_routing(logits, self.k)
        flat_e = eidx.reshape(-1)                             # [T*k]
        order = torch.argsort(flat_e, stable=True)            # ties by token
        token_of_row = order // self.k
        x_rows = xt.index_select(0, token_of_row).to(self.dtype)   # grouped
        wi, wo = self.expert_wi.to(self.dtype), self.expert_wo.to(self.dtype)
        if self.comm is not None:
            y_rows = self._dropless_exchange(x_rows, flat_e.index_select(0, order), wi, wo)
        else:
            sizes = _bincount(flat_e, self.n_experts)
            h = F.silu(self.gmm_fn(x_rows, wi, sizes))
            y_rows = self.gmm_fn(h, wo, sizes)
        w = gates.reshape(-1).index_select(0, order).to(self.dtype)
        # the scatter adds in the compute dtype, as the JAX .at[].add does
        out = torch.zeros(xt.shape, dtype=self.dtype, device=xt.device)
        return out.index_add(0, token_of_row, y_rows * w[:, None])

    def _dropless_exchange(self, x_rows, e_rows, wi, wo):
        """EP dispatch for dropless routing (``layer.py:185-271``): ``[T k,
        d]`` rows sorted by global expert, hence grouped by owning shard, go
        to their owners, through the local grouped matmul, and back to their
        source rows.  The ``[ep, n_local]`` counts cross first, so that each
        receiver knows every row's local expert from the layout alone."""
        ep, n_local, comm = self.ep_size, self.n_local, self.comm
        tk, d = x_rows.shape
        counts = _bincount(e_rows, self.n_experts).long().view(ep, n_local)
        # counts_recv[p, e]: the rows peer p routed to my local expert e
        counts_recv = comm.alltoall(counts, 0, 0)
        sizes = counts_recv.sum(0)                      # rows per local expert
        if self.use_ragged:
            # the host sync of this form: the ragged exchange's exact counts
            # bagua: lint-ignore[host-sync-in-step] -- the MoE exact-count read: alltoall_v sizes its buffers on the host
            send = counts.sum(1).tolist()
            # bagua: lint-ignore[host-sync-in-step] -- the MoE exact-count read: alltoall_v sizes its buffers on the host
            recv_counts = counts_recv.tolist()
            recv = [sum(c) for c in recv_counts]
            x_recv = pf.alltoall_v(x_rows, comm, send, recv)
            # received rows: peer-major, within a peer by local expert
            lid_recv = torch.repeat_interleave(
                torch.arange(n_local, device=x_rows.device).repeat(ep),
                counts_recv.reshape(-1), output_size=sum(recv))
        else:
            cap = ep * tk                               # worst-case slots
            send_sizes = counts.sum(1)
            ends = torch.cumsum(send_sizes, 0)
            r = torch.arange(tk, device=x_rows.device)
            peer_of_row = torch.searchsorted(ends, r, right=True)
            slot = peer_of_row * tk + (r - (ends - send_sizes)[peer_of_row])
            x_send = x_rows.new_zeros((cap, d)).index_copy(0, slot, x_rows)
            x_recv = pf.all_to_all(x_send.view(ep, tk, d), comm, 0, 0).reshape(cap, d)
            # the slots of peer p hold its rows by local expert, then empty
            # slots (sentinel id n_local, zero rows)
            cums = torch.cumsum(counts_recv, 1)
            within = torch.arange(tk, device=x_rows.device)
            lid_recv = (within[None, :, None] >= cums[:, None, :]).sum(-1).reshape(cap)
        # group the received rows by local expert: sentinel rows sort last,
        # past the last group, where the kernels leave them zero
        local_order = torch.argsort(lid_recv, stable=True)
        rows = x_recv.index_select(0, local_order)
        h = F.silu(self.gmm_fn(rows, wi, sizes))
        y_sorted = self.gmm_fn(h, wo, sizes)
        y_local = torch.zeros_like(y_sorted).index_copy(0, local_order, y_sorted)
        if self.use_ragged:
            return pf.alltoall_v(y_local, comm, recv, send)
        y_back = pf.all_to_all(y_local.view(ep, tk, d), comm, 0, 0).reshape(cap, d)
        return y_back.index_select(0, slot)

    def _capacity(self, xt, logits):
        """GShard dispatch / combine einsums with capacity dropping; under
        expert parallelism each expert's ``[C, d]`` slots go to its owner
        (``[E, C, d]`` -> ``[E / ep, ep C, d]``) and back."""
        dt = self.dtype
        capacity = max(1, math.ceil(self.k * xt.shape[0] * self.capacity_factor
                                    / self.n_experts))
        gate = top1_gating if self.k == 1 else top2_gating
        dispatch, combine, self.l_aux = gate(logits, capacity)
        expert_in = torch.einsum("tec,td->ecd", dispatch.to(dt), xt.to(dt))
        expert_in = pf.all_to_all(expert_in, self.comm, 0, 1, tiled=True)
        h = F.silu(torch.einsum("ecd,edf->ecf", expert_in, self.expert_wi.to(dt)))
        out = torch.einsum("ecf,efd->ecd", h, self.expert_wo.to(dt))
        out = pf.all_to_all(out, self.comm, 1, 0, tiled=True)
        return torch.einsum("tec,ecd->td", combine.to(dt), out)


def _bincount(ids, n: int):
    """int32 counts of ``ids`` in ``[0, n)`` by a scatter-add on their
    device (``torch.bincount`` reads its input's range back to the host)."""
    sizes = torch.zeros(n, dtype=torch.int32, device=ids.device)
    return sizes.scatter_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))


# The exact parameter names MoEMLP creates.  Marking is by path *segment*
# equality, never by substring, as in the JAX package.
EXPERT_PARAM_NAMES = frozenset({"expert_wi", "expert_wo"})


def is_expert_param(name: str) -> bool:
    """True for params created by :class:`MoEMLP` (exact segment match of a
    dotted, slashed or bracketed path)."""
    return not EXPERT_PARAM_NAMES.isdisjoint(re.split(r"[\[\]'\"./]+", name))


def sharded_expert_tables(model: nn.Module, is_expert: Optional[Callable[[str], bool]] = None
                          ) -> Dict[str, nn.Module]:
    """Parameter name -> its layer, for every expert table of ``model`` held
    by a layer sharded over ep (``ep_size > 1``, with its ``ep_rank``)."""
    is_expert = is_expert or is_expert_param
    return {f"{n}.{p}" if n else p: m for n, m in model.named_modules()
            if getattr(m, "ep_size", 1) > 1
            for p, _ in m.named_parameters(recurse=False) if is_expert(f"{n}.{p}" if n else p)}


def ep_local_slice(layer: nn.Module, table):
    """``layer``'s ep slice of a global expert table (a tensor or an array
    of ``n_local * ep_size`` rows): rows ``[ep_rank * n_local, (ep_rank + 1)
    * n_local)``."""
    n_local = table.shape[0] // layer.ep_size
    return table[layer.ep_rank * n_local:(layer.ep_rank + 1) * n_local]


def globalize_expert_params(model: nn.Module, generator: torch.Generator,
                            is_expert: Optional[Callable[[str], bool]] = None) -> nn.Module:
    """Re-draw every expert table of ``model`` from one global draw, in
    place (``layer.py:304-328``).  A model built on every rank from one seed
    holds the same local tables on every ep shard (a bad symmetric init);
    here each table is drawn at its global shape ``[n_local * ep_size,
    ...]`` (normal with std ``1/sqrt(fan_in)``, as the layer's own init),
    from ``generator``, which must be seeded alike on every rank, and each
    rank keeps its ep slice.  Returns ``model``."""
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, layer in sharded_expert_tables(model, is_expert).items():
            param = params[name]
            full = torch.empty((param.shape[0] * layer.ep_size,) + tuple(param.shape[1:]),
                               dtype=param.dtype, device=generator.device)
            full.normal_(0.0, 1.0 / math.sqrt(param.shape[1]), generator=generator)
            param.copy_(ep_local_slice(layer, full))
    return model


def shard_expert_state(global_state: dict, model: nn.Module,
                       is_expert: Optional[Callable[[str], bool]] = None) -> dict:
    """A ``state_dict`` of a model with ``ep_size == 1`` experts carried onto
    ``model``, whose experts are sharded: each expert table becomes this
    rank's ep slice, everything else is kept.  ``model.load_state_dict`` of
    the result gives the expert-parallel model the single-shard model's
    weights."""
    sharded = sharded_expert_tables(model, is_expert)
    return {name: ep_local_slice(sharded[name], t) if name in sharded else t
            for name, t in global_state.items()}


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
