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

``sp_axis`` makes the model sequence-parallel (``transformer.py:380-383``):
each rank holds the chunk at its coordinate on that axis of the global mesh
(:mod:`bagua_tpu_torch.parallel.mesh`), adds the position rows of that
chunk, and attends over the whole sequence through an ``attn_fn`` of
:mod:`bagua_tpu_torch.parallel` (ring or Ulysses); :func:`sp_lm_loss_fn`
cuts each rank's chunk and targets out of the whole batch.

``tp_axis`` and ``tp_size`` make it tensor-parallel (``transformer.py:
137-176, 295-317``, :mod:`bagua_tpu_torch.parallel.tensor_parallel`): each
rank's attention holds ``n_heads / tp_size`` heads and its MLP ``d_ff /
tp_size`` rows, ``tp_gather_grad`` goes before the column-parallel products
and ``tp_reduce`` after the row-parallel ones, over that axis of the global
mesh.  The parameter names and their order do not change; only the widths
do.  Where the JAX package runs the local widths without a collective
outside ``shard_map``, the port's forward needs the mesh axis.

``decode`` is the KV-cache decode mode (``transformer.py:179-293``, run by
:mod:`~bagua_tpu_torch.models.generate`).  Where flax keeps the cache in a
mutable ``"cache"`` collection, the port passes a cache object to
``forward`` and updates it in place: :meth:`TransformerLM.init_cache` makes a
:class:`KVCache` (one dense ``[b, max_seq_len, h, d]`` key and value table a
layer, and the position counter) or, with ``page_size > 0``, a
:class:`PagedKVCache` (one ``[num_pages, page_size, h, d]`` pool a layer,
addressed through the ``slots`` argument).  Both attend with two plain
products against the whole ``max_seq_len`` under a mask, scores in f32, as
the JAX package does outside any Pallas kernel; a paged step computes the
same expression on the same values as the dense one, so the two are bitwise
equal.  Under ``tp_size > 1`` each rank caches its own heads and the
conjugates reduce the partial outputs as in training.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Mapping, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.flash_attention import flash_attention
from ..parallel.mesh import get_global_mesh_if_set, require_axis
from ..parallel.tensor_parallel import tp_gather_grad, tp_reduce
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
    #: sequence-parallel mesh axis: when set and in the global mesh, each
    #: rank holds a contiguous chunk of the sequence and its position rows
    #: start at its coordinate on the axis times the local length
    sp_axis: Optional[str] = None
    #: tensor-parallel mesh axis (Megatron): attention heads and MLP width
    #: are sharded ``tp_size`` ways, each rank holding its LOCAL slices;
    #: ``n_heads`` and ``d_ff`` must divide by ``tp_size``
    tp_axis: Optional[str] = None
    tp_size: int = 1
    #: autoregressive decode mode: ``forward`` takes one token a call with
    #: the cache of :meth:`TransformerLM.init_cache` (a decode config does
    #: not train)
    decode: bool = False
    #: paged decode: each layer keeps a pool ``[num_pages, page_size, h, d]``
    #: shared by the slots of the ``slots`` argument; ``page_size`` divides
    #: ``max_seq_len``; 0 keeps the dense cache
    page_size: int = 0
    #: pool capacity in pages a layer; pages ``ZERO_PAGE`` and ``TRASH_PAGE``
    #: are reserved
    num_pages: int = 0

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


def tp_comm(cfg: TransformerConfig):
    """The communicator of the tensor-parallel axis, or None without one
    (``_tp_active``, ``transformer.py:137``)."""
    if cfg.tp_axis is None or cfg.tp_size == 1:
        return None
    return require_axis(cfg.tp_axis, cfg.tp_size, "tensor parallelism").comm(cfg.tp_axis)


def _local(total: int, cfg: TransformerConfig, what: str) -> int:
    if total % cfg.tp_size:
        raise ValueError(f"{what} {total} does not split over tp_size {cfg.tp_size}")
    return total // cfg.tp_size


def causal_attention(q, k, v, dtype):
    """Causal attention; ``q/k/v`` ``[batch, seq, heads, head_dim]``."""
    return flash_attention(q, k, v, dtype, causal=True)


#: reserved page ids of the paged decode pool (``transformer.py:132-134``):
#: ZERO_PAGE is never written (an unallocated block-table entry gathers
#: zeros), TRASH_PAGE takes the writes of inactive slots
ZERO_PAGE = 0
TRASH_PAGE = 1
RESERVED_PAGES = 2


@dataclass
class KVCache:
    """The dense decode cache: ``keys[i]``/``values[i]`` the
    ``[b, max_seq_len, h, d]`` tables of layer ``i`` in ``cfg.dtype`` (this
    rank's heads), ``index`` the positions cached so far (JAX's
    ``cache_index``/``pos_index``)."""

    keys: List[torch.Tensor]
    values: List[torch.Tensor]
    index: int = 0


@dataclass
class PagedKVCache:
    """The paged decode cache: ``keys[i]``/``values[i]`` the
    ``[num_pages, page_size, h, d]`` pools of layer ``i`` (JAX's
    ``pool_key``/``pool_value``).  The positions live in the ``slots``
    argument of each call."""

    keys: List[torch.Tensor]
    values: List[torch.Tensor]
    page_size: int = 0


Cache = Union[KVCache, PagedKVCache]


def _cached_attend(q, keys, values, positions, dtype):
    """``q`` ``[b, s, h, d]`` against the cached ``keys``/``values``
    ``[b, S, h, d]``: f32 scores, a query at position ``positions[b, i]``
    sees the keys at or before it, softmax in f32, weights cast to
    ``dtype`` (``transformer.py:209-218, 281-293``)."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), keys.float()) / math.sqrt(d)
    mask = torch.arange(keys.shape[1], device=q.device)[None, None, :] <= positions[:, :, None]
    scores = scores.masked_fill(~mask[:, None], -1e30)
    weights = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, values.to(dtype))


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, attn_fn: Optional[Callable] = None):
        super().__init__()
        self.cfg = cfg
        self.attn_fn = attn_fn or causal_attention
        #: this rank's heads
        self.n_heads = _local(cfg.n_heads, cfg, "n_heads")
        hd = self.n_heads * cfg.head_dim
        # registration order k, o, q, v: the JAX flatten order
        self.k = Dense(cfg.d_model, hd, cfg)
        self.o = Dense(hd, cfg.d_model, cfg)
        self.q = Dense(cfg.d_model, hd, cfg)
        self.v = Dense(cfg.d_model, hd, cfg)

    def forward(self, x, cache: Optional[Cache] = None, layer: int = 0,
                slots: Optional[Mapping[str, torch.Tensor]] = None):
        b, s, _ = x.shape
        h, d = self.n_heads, self.cfg.head_dim
        comm = tp_comm(self.cfg)
        x = tp_gather_grad(x, comm)
        q, k, v = (proj(x).view(b, s, h, d) for proj in (self.q, self.k, self.v))
        if isinstance(cache, PagedKVCache):
            o = self._paged_decode_attend(q, k, v, cache, layer, slots)
        elif cache is not None:
            o = self._decode_attend(q, k, v, cache, layer)
        else:
            o = self.attn_fn(q, k, v, self.cfg.dtype)
        # the row-parallel product's partial sums
        return tp_reduce(self.o(o.reshape(b, s, h * d)), comm)

    def _decode_attend(self, q, k, v, cache: KVCache, layer: int):
        """One token against layer ``layer``'s dense cache
        (``transformer.py:179-218``): its key and value land at
        ``cache.index`` and it attends to the positions up to it."""
        dtype = self.cfg.dtype
        if q.shape[1] != 1:
            raise ValueError(f"decode consumes one token per call, got {q.shape[1]}")
        idx = cache.index
        keys, values = cache.keys[layer], cache.values[layer]
        if idx >= keys.shape[1]:
            raise ValueError(f"the decode cache is full: position {idx} of max_seq_len "
                             f"{keys.shape[1]}")
        keys[:, idx] = k[:, 0].to(dtype)
        values[:, idx] = v[:, 0].to(dtype)
        positions = torch.full((q.shape[0], 1), idx, device=q.device, dtype=torch.long)
        return _cached_attend(q, keys, values, positions, dtype)

    def _paged_decode_attend(self, q, k, v, cache: PagedKVCache, layer: int, slots):
        """``s`` tokens of each slot against layer ``layer``'s page pool
        (``transformer.py:220-293``).  ``slots`` holds ``block_table``
        ``[b, max_seq_len // page_size]`` (the page of each logical page of
        each slot; unallocated entries are ``ZERO_PAGE``), ``lengths``
        ``[b]`` (the positions cached per slot: this call writes
        ``lengths .. lengths + s - 1``) and ``active`` ``[b]`` (an inactive
        slot writes ``TRASH_PAGE``).  Each slot's pages are gathered back
        into position order, the dense cache's values."""
        dtype, page = self.cfg.dtype, cache.page_size
        b, s, h, d = q.shape
        lengths, table, active = slots["lengths"], slots["block_table"].long(), slots["active"]
        positions = lengths.long()[:, None] + torch.arange(s, device=q.device)[None, :]
        dest = torch.gather(table, 1, positions // page)
        dest = torch.where(active.bool()[:, None], dest, torch.full_like(dest, TRASH_PAGE))
        offsets = positions % page
        pool_k, pool_v = cache.keys[layer], cache.values[layer]
        pool_k[dest, offsets] = k.to(dtype)
        pool_v[dest, offsets] = v.to(dtype)

        def view(pool):
            return pool[table].reshape(b, table.shape[1] * page, h, d)

        return _cached_attend(q, view(pool_k), view(pool_v), positions, dtype)


class MLPBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        d_ff = _local(cfg.d_ff, cfg, "d_ff")
        self.wi_gate = Dense(cfg.d_model, d_ff, cfg)
        self.wi_up = Dense(cfg.d_model, d_ff, cfg)
        self.wo = Dense(d_ff, cfg.d_model, cfg)

    def forward(self, x):
        comm = tp_comm(self.cfg)
        x = tp_gather_grad(x, comm)
        return tp_reduce(self.wo(F.silu(self.wi_gate(x)) * self.wi_up(x)), comm)


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

    def forward(self, x, cache: Optional[Cache] = None, layer: int = 0, slots=None):
        x = x + self.attn(self.attn_norm(x), cache, layer, slots)
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

    def init_cache(self, batch_size: int) -> Cache:
        """A zero decode cache for ``batch_size`` rows (a paged config's pool
        has no rows: its slots come with each call), on the model's device,
        in ``cfg.dtype``, with this rank's heads."""
        cfg = self.cfg
        if not cfg.decode:
            raise ValueError("init_cache needs a decode-mode model: call decode_model(model) "
                             "(bagua_tpu_torch.models.generate) first")
        h, d = _local(cfg.n_heads, cfg, "n_heads"), cfg.head_dim
        device = self.embed.weight.device
        if cfg.page_size > 0:
            if cfg.max_seq_len % cfg.page_size:
                raise ValueError(f"page_size {cfg.page_size} does not divide max_seq_len "
                                 f"{cfg.max_seq_len}")
            if cfg.num_pages <= RESERVED_PAGES:
                raise ValueError(f"num_pages {cfg.num_pages} leaves no page beside the "
                                 f"{RESERVED_PAGES} reserved ones")
            shape = (cfg.num_pages, cfg.page_size, h, d)
        else:
            shape = (batch_size, cfg.max_seq_len, h, d)
        tables = [[torch.zeros(shape, dtype=cfg.dtype, device=device)
                   for _ in range(cfg.n_layers)] for _ in range(2)]
        if cfg.page_size > 0:
            return PagedKVCache(*tables, page_size=cfg.page_size)
        return KVCache(*tables)

    def forward(self, tokens, cache: Optional[Cache] = None,
                slots: Optional[Mapping[str, torch.Tensor]] = None):
        cfg = self.cfg
        paged = cfg.decode and cfg.page_size > 0
        if slots is not None and not paged:
            raise ValueError("`slots` is only meaningful for paged decode configs "
                             "(decode=True, page_size > 0)")
        if (cache is not None) != cfg.decode:
            raise ValueError("a decode-mode model (cfg.decode) takes the cache of init_cache, "
                             "a training-mode one takes none")
        s = tokens.shape[1]
        x = self.embed(tokens).to(cfg.dtype)
        if paged:
            if slots is None:
                raise ValueError("paged decode (page_size > 0) needs the `slots` call "
                                 "argument (block_table / lengths / active)")
            # every slot at its own position (``transformer.py:337-351``)
            pos_ids = (slots["lengths"].long()[:, None]
                       + torch.arange(s, device=tokens.device)[None, :])
            x = x + self.pos_embed.weight[pos_ids].to(cfg.dtype)
        else:
            start = cache.index if cfg.decode else sp_rank(cfg.sp_axis) * s
            x = x + self.pos_embed.weight[start:start + s].to(cfg.dtype)
        for i in range(cfg.n_layers):
            block = getattr(self, f"block_{i}")
            if cache is not None:
                x = block(x, cache, i, slots)
            else:
                x = (remat_wrap(block, cfg.remat_policy) if cfg.remat else block)(x)
        if cfg.decode and not paged:
            cache.index += s
        return self.lm_head(self.final_norm(x)).float()


#: port parameter-name suffix -> (the dim of the GLOBAL weight sharded over
#: tp, its contracting dims) for the trainer's placements and the global
#: redraw (``transformer.py:419-447`` in torch's ``[out, in]`` layouts): the
#: column-parallel weights shard their output rows (``h * d`` or ``d_ff``),
#: the row-parallel ones their input columns; every product contracts dim 1.
#: A head's rows or columns are one contiguous block, as JAX splits its
#: heads dim.
_TP_DIMS = {
    "attn.q.weight": (0, (1,)),
    "attn.k.weight": (0, (1,)),
    "attn.v.weight": (0, (1,)),
    "attn.o.weight": (1, (1,)),
    "mlp.wi_gate.weight": (0, (1,)),
    "mlp.wi_up.weight": (0, (1,)),
    "mlp.wo.weight": (1, (1,)),
}


def _tp_entry(name: str):
    for suffix, entry in _TP_DIMS.items():
        if name == suffix or name.endswith("." + suffix):
            return entry
    return None


def tp_param_dim(name: str) -> Optional[int]:
    """The tensor-parallel dim of a :class:`TransformerLM` parameter (None:
    replicated)."""
    entry = _tp_entry(name)
    return None if entry is None else entry[0]


def tp_param_fan_in_dims(name: str):
    """The contracting dims of a tensor-parallel weight (for the redraw)."""
    entry = _tp_entry(name)
    return None if entry is None else entry[1]


def sp_rank(sp_axis: Optional[str]) -> int:
    """This rank's coordinate on the sequence-parallel axis of the global
    mesh; 0 without the axis (or without a mesh), as JAX's unbound axis."""
    mesh = get_global_mesh_if_set()
    if sp_axis is None or mesh is None or sp_axis not in mesh.shape:
        return 0
    return mesh.coords[sp_axis]


def lm_loss_fn(model: TransformerLM, batch) -> torch.Tensor:
    """Next-token cross-entropy; ``batch = dict(tokens=[b, s+1])``."""
    tokens = batch["tokens"]
    logits = model(tokens[:, :-1])
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1).long())


def sp_lm_loss_fn(sp_size: int, sp_axis: str = "sp") -> Callable:
    """Sequence-parallel next-token loss (``transformer.py:465-486``):
    ``batch["tokens"]`` is the WHOLE ``[batch, seq + 1]`` array, the same on
    every rank of the ``sp_axis``; each rank cuts its contiguous chunk of
    ``seq / sp_size`` inputs and their targets, runs the model on them and
    returns the mean loss of its targets.  The trainer's loss average over
    the ranks is the mean of the whole sequence, the chunks being equal."""

    def loss_fn(model, batch):
        tokens = batch["tokens"]
        seq = tokens.shape[1] - 1
        if seq % sp_size:
            raise ValueError(f"sequence {seq} does not split over sp_size {sp_size}")
        s_local = seq // sp_size
        start = sp_rank(sp_axis) * s_local
        logits = model(tokens[:, start:start + s_local])
        targets = tokens[:, start + 1:start + 1 + s_local]
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets.reshape(-1).long())

    return loss_fn
