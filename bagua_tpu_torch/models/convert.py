"""Flax params (as numpy arrays) -> the port's ``state_dict``, and back.

Layouts differ in five ways: flax ``Dense`` kernels are ``[in, out]`` and
torch ``Linear`` weights ``[out, in]``; flax ``Conv`` kernels are ``[kh, kw,
in, out]`` and the port's ``[out, in, kh, kw]``; the attention q/k/v kernels are
``DenseGeneral`` ``[d_model, heads, head_dim]`` and the ``o`` kernel
``[heads, head_dim, d_model]``; a pipeline's stacked block leaves carry a
leading layer dim (``blocks.block.*`` in flax, ``blocks.*`` in the port,
each layer laid out as above); and a few leaves are renamed
(``embed.embedding`` -> ``embed.weight``, ``pos_embed`` ->
``pos_embed.weight``, ``*.kernel`` -> ``*.weight``, a block's ``MoEMLP_0``
-> ``mlp``, a batch norm's ``scale`` -> ``weight``).  The MoE expert tables
``[E, d_in, d_out]`` keep their layout.  The vision models keep the flax
tree's names otherwise (``stem_conv``, ``stage{i}_block{j}.Conv_{k}``,
``BatchNorm_{k}`` or ``SyncBatchNorm_{k}``, ``proj_conv``, ``proj_norm``,
``conv{i}``, ``fc1``, ``fc2``, ``head``); VGG's ``fc1`` rows stay in flax's
NHWC order, the model flattening NHWC.  :func:`batch_stats_from_jax` and
:func:`batch_stats_to_jax` carry the ``batch_stats`` collection (each
norm's ``mean`` and ``var``) to the norms' buffers and back.

The JAX package's trainer takes GLOBAL params; a rank's module holds its
slices.  :func:`shard_state_dict` cuts a rank's slices out of a global port
``state_dict``: an expert-parallel ``MoEMLP``'s expert rows, a
tensor-parallel leaf's block along its tp dim, a pipeline stage's layers (a
``TransformerLM``'s ``block_{i}`` leaves are stacked into the pipeline's
``blocks`` first).  :func:`params_from_jax` converts and then cuts;
:func:`params_to_jax` carries the port's GLOBAL tensors (the trainer's
``unstack_params``) back into a flax tree.

A decode-mode model has the training model's parameters, so both functions
take its params unchanged.  :func:`cache_from_jax` turns the JAX package's
``"cache"`` collection (the dense tables and counters, or the page pools)
into the port's cache object, whose tables have the same
``[b, max_seq_len, h, d]`` and ``[num_pages, page_size, h, d]`` layouts.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..model_parallel.moe.layer import ep_local_slice, sharded_expert_tables
from ..parallel.pipeline import PipelinedTransformerLM, pp_param_dim
from ..parallel.tensor_parallel import axis_rank, tp_slice
from .transformer import KVCache, PagedKVCache, tp_param_dim


#: the batch norms of the vision models, whose ``scale`` is the port's ``weight``
_NORM_SCALE = re.compile(r"(?:^|.*\.)(?:(?:Sync)?BatchNorm_\d+|stem_norm|proj_norm)\.scale")


def torch_name(jax_name: str) -> str:
    """Dotted flax param name -> the port's parameter name."""
    if _NORM_SCALE.fullmatch(jax_name):
        return jax_name[: -len("scale")] + "weight"
    jax_name = jax_name.replace(".MoEMLP_0.", ".mlp.")
    if jax_name.startswith("blocks.block."):
        jax_name = "blocks." + jax_name[len("blocks.block."):]
    if jax_name == "pos_embed":
        return "pos_embed.weight"
    if jax_name == "embed.embedding":
        return "embed.weight"
    if jax_name.endswith(".kernel"):
        return jax_name[: -len("kernel")] + "weight"
    return jax_name


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = np.asarray(val)
    return out


def _to_torch_layout(arr: np.ndarray, jax_name: str) -> np.ndarray:
    if not jax_name.endswith(".kernel"):
        return arr
    lead = arr.shape[:1] if pp_param_dim(jax_name) == 0 else ()
    inner = arr.shape[len(lead):]
    if not lead and len(inner) == 4:
        return np.transpose(arr, (3, 2, 0, 1))            # conv [out, in, kh, kw]
    if len(inner) == 3 and jax_name.endswith("attn.o.kernel"):
        arr = arr.reshape(lead + (-1, inner[-1]))        # [h*d, d_model]
    elif len(inner) == 3:
        arr = arr.reshape(lead + (inner[0], -1))         # [d_model, h*d]
    return np.swapaxes(arr, -1, -2)


def stack_blocks(state: Mapping[str, torch.Tensor], n_layers: int) -> Dict[str, torch.Tensor]:
    """A ``TransformerLM`` state dict with its ``block_{i}.*`` leaves
    stacked into a pipeline's ``blocks.*`` ``[n_layers, ...]``."""
    blocks = re.compile(r"block_(\d+)\.(.*)")
    out = {n: t for n, t in state.items() if not blocks.fullmatch(n)}
    leaves = sorted({blocks.fullmatch(n).group(2) for n in state if blocks.fullmatch(n)})
    for leaf in leaves:
        out[f"blocks.{leaf}"] = torch.stack([state[f"block_{i}.{leaf}"] for i in range(n_layers)])
    return out


def shard_state_dict(state: Mapping[str, torch.Tensor], model: nn.Module) -> Dict[str, torch.Tensor]:
    """This rank's slices of a GLOBAL port ``state_dict`` for ``model``
    (a ``TransformerLM``, with or without ``tp_size``, or a
    :class:`PipelinedTransformerLM`): tensor-parallel leaves cut to this
    rank's block along their tp dim (shifted past a stacked layer dim),
    stacked block leaves to this rank's stage's layers, expert tables to
    the rank's experts; a ``TransformerLM``'s ``block_{i}`` leaves are
    stacked first where ``model`` is a pipeline.  The rank's coordinates
    are those on the model's axes of the global mesh.  Raises where a shape
    does not come out as the model's."""
    own = model.state_dict()
    cfg = getattr(model, "cfg", None)
    tp_size = getattr(cfg, "tp_size", 1)
    pp_size = getattr(model, "pp_size", 1)
    if isinstance(model, PipelinedTransformerLM) and any(n.startswith("block_") for n in state):
        state = stack_blocks(state, cfg.n_layers)
    tp_rank = axis_rank(getattr(cfg, "tp_axis", None), tp_size, "shard_state_dict")
    pp_rank = axis_rank(getattr(model, "pp_axis", None), pp_size, "shard_state_dict")
    experts = sharded_expert_tables(model)
    out = {}
    for name, t in state.items():
        if name not in own:
            raise ValueError(f"{name} is not a parameter of the model")
        ref = own[name]
        stacked = pp_param_dim(name) == 0
        if stacked and pp_size > 1 and t.shape[0] == pp_size * ref.shape[0]:
            t = t[pp_rank * ref.shape[0]:(pp_rank + 1) * ref.shape[0]]
        dim = tp_param_dim(name)
        if dim is not None and tp_size > 1:
            dim += int(stacked)
            if t.shape[dim] == tp_size * ref.shape[dim]:
                t = tp_slice(t, dim, tp_size, tp_rank)
        if name in experts and t.shape[0] == experts[name].ep_size * ref.shape[0]:
            t = ep_local_slice(experts[name], t)
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: the global {tuple(state[name].shape)}, cut to this "
                             f"rank's {tuple(t.shape)}, does not match the model's "
                             f"{tuple(ref.shape)}")
        out[name] = t
    return out


def params_from_jax(np_params: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for ``model`` from the flax param tree ``np_params``
    (nested dicts of arrays, the JAX trainer's GLOBAL params), on the model's
    device and dtypes: converted, then cut to this rank's slices
    (:func:`shard_state_dict`).  Raises if a name or shape does not
    match."""
    own = dict(model.named_parameters())
    flat = {torch_name(n): (n, a) for n, a in _flatten(np_params).items()}
    if set(flat) != set(own):
        raise ValueError(
            f"param names differ: only in flax {sorted(set(flat) - set(own))}, "
            f"only in the model {sorted(set(own) - set(flat))}")
    state = {name: torch.tensor(np.ascontiguousarray(_to_torch_layout(arr, jax_name)))
             for name, (jax_name, arr) in flat.items()}
    return {name: t.to(device=own[name].device, dtype=own[name].dtype)
            for name, t in shard_state_dict(state, model).items()}


def params_to_jax(named: Mapping[str, torch.Tensor], template: Mapping) -> dict:
    """The port's GLOBAL tensors by name (e.g. ``BaguaTrainer.unstack_params``)
    as a flax param tree shaped like ``template`` (nested dicts of arrays,
    whose shapes give the flax layouts, stacked pipeline leaves included),
    numpy f32-or-own dtype on the host."""

    def walk(tree, prefix):
        out = {}
        for key, val in tree.items():
            jax_name = f"{prefix}{key}"
            if isinstance(val, Mapping):
                out[key] = walk(val, jax_name + ".")
                continue
            arr = named[torch_name(jax_name)].detach().cpu().float().numpy()
            if jax_name.endswith(".kernel") and arr.ndim == 4:   # a conv's [out, in, kh, kw]
                arr = np.transpose(arr, (2, 3, 1, 0))
            elif jax_name.endswith(".kernel"):
                arr = np.swapaxes(arr, -1, -2).reshape(np.shape(val))
            out[key] = arr
        return out

    return walk(template, "")


def batch_stats_from_jax(np_stats: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """Copy the flax ``batch_stats`` collection (nested dicts of arrays:
    each norm's ``mean`` and ``var``) into ``model``'s norm buffers of the
    same names, in place; returns the buffers by name.  Raises if the names
    differ."""
    own = dict(model.named_buffers())
    flat = _flatten(np_stats)
    if set(flat) != set(own):
        raise ValueError(
            f"batch_stats names differ: only in flax {sorted(set(flat) - set(own))}, "
            f"only in the model {sorted(set(own) - set(flat))}")
    with torch.no_grad():
        for name, arr in flat.items():
            own[name].copy_(torch.from_numpy(np.array(arr, np.float32)))
    return own


def batch_stats_to_jax(model: nn.Module) -> dict:
    """The norms' ``mean`` and ``var`` buffers of ``model`` as a flax
    ``batch_stats`` tree (nested dicts of f32 numpy arrays)."""
    out: dict = {}
    for name, t in model.named_buffers():
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.detach().cpu().float().numpy()
    return out


def cache_from_jax(np_cache: Mapping, model: nn.Module):
    """The port's decode cache from the JAX package's ``"cache"`` collection
    of a decode-mode ``TransformerLM`` (nested dicts of arrays): a
    :class:`KVCache` from each layer's ``cached_key``/``cached_value`` and
    the position counter ``pos_index``, or, for a paged config, a
    :class:`PagedKVCache` from each layer's ``pool_key``/``pool_value``; on
    the model's device, in ``cfg.dtype``."""
    cfg = model.cfg
    device = model.embed.weight.device
    attn = [np_cache[f"block_{i}"]["attn"] for i in range(cfg.n_layers)]
    put = lambda a: torch.tensor(np.asarray(a, np.float32)).to(device=device, dtype=cfg.dtype)
    if cfg.page_size > 0:
        return PagedKVCache([put(a["pool_key"]) for a in attn],
                            [put(a["pool_value"]) for a in attn], page_size=cfg.page_size)
    return KVCache([put(a["cached_key"]) for a in attn], [put(a["cached_value"]) for a in attn],
                   index=int(np.asarray(np_cache["pos_index"])))
