"""Autoregressive generation with a KV cache.

Port of ``bagua_tpu/models/generate.py``.  The JAX package runs the loop as
one jitted ``lax.scan`` over the decode steps; here it is an eager loop over
the same steps, each feeding one token through the decode-mode twin of the
model (:func:`decode_model`) against the cache of
:meth:`~bagua_tpu_torch.models.transformer.TransformerLM.init_cache`:

- step ``i`` feeds token ``i``; while ``i < prompt_len - 1`` the next token
  is forced to ``prompt[:, i + 1]`` (the prompt is fed one token a step, as
  JAX does);
- afterwards it is the argmax of the logits at ``temperature == 0``, else a
  categorical draw from ``softmax(logits / temperature)`` with the caller's
  ``torch.Generator``.

A paged config (``page_size > 0``) runs the same loop through its page pool:
every row is an active slot owning consecutive pages after
``RESERVED_PAGES``, at position ``i`` in step ``i``.  Its tokens and logits
are bitwise those of the dense cache.

The JAX package memoizes its compiled programs per signature (``_GEN_CACHE``,
``_TP_GEN_CACHE``); eager torch compiles nothing, and the cache is made anew
for each call (its size is the call's), so the port keeps no such table.  A
temperature draw cannot reproduce ``jax.random``'s: the same generator state
gives the same tokens.

:func:`generate_tp` runs the same loop on every rank of a tensor-parallel
axis, each with its own heads and MLP rows (its slices of the GLOBAL
params), the model's conjugate collectives summing the partial outputs, so
that every rank computes the same logits and the same tokens.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Mapping, Optional

import numpy as np
import torch

__all__ = ["decode_model", "generate", "generate_tp"]


def decode_model(model, **pool):
    """The decode-mode twin of a ``TransformerLM``: the same modules and
    parameters (shared, not copied), ``cfg.decode`` set.  ``attn_fn`` is not
    used in decode.  ``pool`` may set the twin's ``page_size`` and
    ``num_pages`` (a paged twin of a dense model)."""
    if set(pool) - {"page_size", "num_pages"}:
        raise TypeError(f"decode_model sets only page_size and num_pages, got {sorted(pool)}")
    twin = copy.copy(model)
    twin.cfg = dataclasses.replace(model.cfg, decode=True, **pool)
    return twin


def _check_budget(model, prompt_len: int, max_new_tokens: int, temperature: float,
                  generator) -> None:
    if prompt_len < 1:
        raise ValueError("the prompt needs at least one token")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if prompt_len + max_new_tokens > model.cfg.max_seq_len:
        raise ValueError(f"prompt_len {prompt_len} + max_new_tokens {max_new_tokens} exceeds "
                         f"max_seq_len {model.cfg.max_seq_len}")
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs an rng: pass generator=torch.Generator")


def _pool_slots(model, b: int, steps: int, device) -> Optional[dict]:
    """The block table and activity of a paged config's ``b`` rows for
    ``steps`` positions (row ``j`` owns pages ``RESERVED_PAGES + j * need``
    onwards, the rest of its table the zero page); None for a dense one."""
    from .transformer import RESERVED_PAGES, ZERO_PAGE

    cfg = model.cfg
    if cfg.page_size <= 0:
        return None
    need = -(-steps // cfg.page_size)
    if RESERVED_PAGES + b * need > cfg.num_pages:
        raise ValueError(f"{b} rows of {steps} positions need {RESERVED_PAGES + b * need} "
                         f"pages of {cfg.page_size}, the pool has num_pages {cfg.num_pages}")
    table = torch.full((b, cfg.max_seq_len // cfg.page_size), ZERO_PAGE, dtype=torch.int32,
                       device=device)
    table[:, :need] = (RESERVED_PAGES + torch.arange(b, device=device)[:, None] * need
                       + torch.arange(need, device=device)).to(torch.int32)
    return {"block_table": table, "active": torch.ones(b, dtype=torch.bool, device=device)}


def _generate_core(model, prompt: torch.Tensor, max_new_tokens: int, temperature: float,
                   generator: Optional[torch.Generator], call: Callable, return_logits: bool):
    """The token loop (``generate.py:37-79``) of a decode-mode ``model``
    whose forward is ``call(tokens, cache, slots)``."""
    b, prompt_len = prompt.shape
    steps = prompt_len + max_new_tokens - 1
    cache = model.init_cache(b)
    pool = _pool_slots(model, b, steps, prompt.device)
    feed = prompt[:, 0]
    toks, trail = [], []
    for i in range(steps):
        slots = None if pool is None else {
            **pool, "lengths": torch.full((b,), i, dtype=torch.int32, device=prompt.device)}
        logits = call(feed[:, None], cache, slots)[:, 0]
        if return_logits:
            trail.append(logits)
        if i < prompt_len - 1:
            nxt = prompt[:, i + 1]
        elif temperature > 0.0:
            probs = torch.softmax(logits / max(temperature, 1e-6), dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0].to(prompt.dtype)
        else:
            nxt = logits.argmax(dim=-1).to(prompt.dtype)
        toks.append(nxt)
        feed = nxt
    out = torch.stack(toks[prompt_len - 1:], dim=1)
    return (out, torch.stack(trail, dim=1)) if return_logits else out


def _prompt_on(model, prompt) -> torch.Tensor:
    device = model.embed.weight.device
    if not isinstance(prompt, torch.Tensor):
        prompt = torch.tensor(np.asarray(prompt))
    return prompt.to(device=device, dtype=torch.long)


@torch.no_grad()
def generate(model, prompt, max_new_tokens: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None, return_logits: bool = False):
    """``max_new_tokens`` continuations of ``prompt`` (``generate.py:103``).

    Args:
        model: a ``TransformerLM``, in decode mode or not (a training-mode
            model is turned into its twin; they share the weights); a paged
            twin decodes through its pool.
        prompt: integer ``[batch, prompt_len]``, ``prompt_len >= 1``;
            ``prompt_len + max_new_tokens`` must fit ``cfg.max_seq_len``.
        temperature: 0 = greedy, else categorical at that temperature.
        generator: the ``torch.Generator`` of the draws (needed only for
            ``temperature > 0``), on the model's device.
        return_logits: also return the f32 logits of every step
            ``[batch, prompt_len + max_new_tokens - 1, vocab]`` (step ``i``
            predicts position ``i + 1``).

    Returns:
        int64 ``[batch, max_new_tokens]`` (and the logits).
    """
    if not model.cfg.decode:
        model = decode_model(model)
    prompt = _prompt_on(model, prompt)
    _check_budget(model, prompt.shape[1], int(max_new_tokens), temperature, generator)
    return _generate_core(model, prompt, int(max_new_tokens), temperature, generator,
                          lambda tokens, cache, slots: model(tokens, cache=cache, slots=slots),
                          return_logits)


@torch.no_grad()
def generate_tp(model, params: Mapping[str, torch.Tensor], prompt,
                max_new_tokens: int, mesh, tp_axis: str = "tp", temperature: float = 0.0,
                generator: Optional[torch.Generator] = None,
                tp_param_dim: Optional[Callable[[str], Optional[int]]] = None,
                return_logits: bool = False):
    """Tensor-parallel generation (``generate.py:158``): the token loop on
    every rank of ``tp_axis`` of ``mesh`` (call it on every rank of the
    mesh), attention heads and MLP width sharded as in training.

    ``params`` are the GLOBAL tensors by name (a ``BaguaTrainer(tp_axis=)``'s
    ``unstack_params``), each rank taking its block along ``tp_param_dim``
    (default the transformer's table).  ``model`` carries ``tp_axis`` and ``tp_size`` equal to the mesh
    axis's size.  The prompt (and a generator's state) must be the same on
    every rank; the logits and tokens then are.  ``mesh`` is the global
    mesh for the call and the previous one is put back after it."""
    from ..parallel import mesh as mesh_mod
    from ..parallel.tensor_parallel import tp_slice
    from .transformer import tp_param_dim as default_dim

    if not model.cfg.decode:
        model = decode_model(model)
    cfg = model.cfg
    if cfg.tp_axis != tp_axis or cfg.tp_size <= 1:
        raise ValueError(f"model config must carry tp_axis={tp_axis!r} with tp_size > 1 (got "
                         f"tp_axis={cfg.tp_axis!r}, tp_size={cfg.tp_size})")
    prompt = _prompt_on(model, prompt)
    _check_budget(model, prompt.shape[1], int(max_new_tokens), temperature, generator)
    if mesh.shape.get(tp_axis) != cfg.tp_size:
        raise ValueError(f"mesh axis {tp_axis!r} has size {mesh.shape.get(tp_axis)} but the "
                         f"model config says tp_size={cfg.tp_size}")
    dim_of = tp_param_dim or default_dim
    rank = mesh.coords[tp_axis]
    own = dict(model.named_parameters())
    local = {}
    for name, t in params.items():
        d = dim_of(name)
        t = tp_slice(t, d, cfg.tp_size, rank) if d is not None else t
        local[name] = t.to(device=own[name].device, dtype=own[name].dtype)
    call = lambda tokens, cache, slots: torch.func.functional_call(
        model, local, (tokens,), {"cache": cache, "slots": slots})
    previous = mesh_mod.get_global_mesh_if_set()
    mesh_mod.set_global_mesh(mesh)
    try:
        return _generate_core(model, prompt, int(max_new_tokens), temperature, generator,
                              call, return_logits)
    finally:
        mesh_mod.set_global_mesh(previous)
