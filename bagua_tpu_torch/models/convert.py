"""Flax params (as numpy arrays) -> the port's ``state_dict``.

Layouts differ in three ways: flax ``Dense`` kernels are ``[in, out]`` and
torch ``Linear`` weights ``[out, in]``; the attention q/k/v kernels are
``DenseGeneral`` ``[d_model, heads, head_dim]`` and the ``o`` kernel
``[heads, head_dim, d_model]``; and a few leaves are renamed
(``embed.embedding`` -> ``embed.weight``, ``pos_embed`` ->
``pos_embed.weight``, ``*.kernel`` -> ``*.weight``, and a block's
``MoEMLP_0`` -> ``mlp``).  The MoE expert tables ``[E, d_in, d_out]`` keep
their layout.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def torch_name(jax_name: str) -> str:
    """Dotted flax param name -> the port's parameter name."""
    jax_name = jax_name.replace(".MoEMLP_0.", ".mlp.")
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
    if arr.ndim == 3 and jax_name.endswith("attn.o.kernel"):
        arr = arr.reshape(-1, arr.shape[-1])       # [h*d, d_model]
    elif arr.ndim == 3:
        arr = arr.reshape(arr.shape[0], -1)         # [d_model, h*d]
    return arr.T


def params_from_jax(np_params: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for ``model`` from the flax param tree ``np_params``
    (nested dicts of arrays), on the model's device and dtypes.  Raises if a
    name or shape does not match."""
    own = model.state_dict()
    flat = {torch_name(n): (n, a) for n, a in _flatten(np_params).items()}
    if set(flat) != set(own):
        raise ValueError(
            f"param names differ: only in flax {sorted(set(flat) - set(own))}, "
            f"only in the model {sorted(set(own) - set(flat))}")
    out = {}
    for name, (jax_name, arr) in flat.items():
        arr = _to_torch_layout(arr, jax_name)
        ref = own[name]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{jax_name}: converted shape {tuple(arr.shape)} "
                             f"does not match {name} {tuple(ref.shape)}")
        out[name] = torch.tensor(arr).to(
            device=ref.device, dtype=ref.dtype)
    return out
