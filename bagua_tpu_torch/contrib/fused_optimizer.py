"""Fused optimizer: run the inner optimizer over one flat buffer per dtype.

Port of ``bagua_tpu/contrib/fused_optimizer.py``, the counterpart of the
reference's ``bagua/torch_api/contrib/fused_optimizer.py:8-134``: one
optimizer step over a few large flat tensors in place of one launch a
parameter.

The trainer builds its optimizer from a factory (``optimizer_factory(params)
-> Optimizer``), so ``fuse_optimizer`` wraps a factory::

    opt = fuse_optimizer(functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9))
    trainer = BaguaTrainer(loss_fn, opt, GradientAllReduceAlgorithm())

Under the trainer's flat-resident layout (``flat_resident``) the parameters
already live in bucket flats, which IS the fused layout: the trainer unwraps
the factory (:attr:`FusedOptimizerFactory.fused_inner`) and runs the inner
factory on the bucket flats, so the per-dtype flatten below never runs.  It
runs in the leaf layout: each step copies the parameters and their
gradients into the flats, steps the inner optimizer there and copies the
parameters back.

Step equality with the unfused optimizer holds for elementwise optimizers
(SGD, momentum, Adam, AdamW with one weight decay, ...), the same caveat as
the reference's storage flattening and the flat-resident layout's.  An
optimizer that reads a parameter's shape (factored second moments) changes
meaning when fused; do not wrap one.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List

import torch
from torch import nn

__all__ = ["fuse_optimizer", "FusedOptimizer", "FusedOptimizerFactory"]


def _group_leaves(tensors: List[torch.Tensor]) -> Dict[str, List[int]]:
    """Positions of ``tensors`` grouped by dtype name, in order; the groups
    in sorted dtype-name order, as the JAX package's ``_group_leaves``."""
    groups: Dict[str, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(str(t.dtype).replace("torch.", ""), []).append(i)
    return {k: groups[k] for k in sorted(groups)}


def _flatten(tensors: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Tensors -> ``{dtype_name: 1-D buffer}`` (their ravels concatenated)."""
    # bagua: lint-ignore[per-step-reflatten] -- a standalone FusedOptimizer's step (the JAX update_fn's form); the trainer unwraps fuse_optimizer onto its resident flats and never runs it
    return {k: torch.cat([tensors[i].reshape(-1) for i in idx])
            for k, idx in _group_leaves(tensors).items()}


def _unflatten(flat: Dict[str, torch.Tensor], like: List[torch.Tensor]) -> List[torch.Tensor]:
    """``{dtype_name: buffer}`` -> views shaped as ``like``'s tensors."""
    out: List[torch.Tensor] = [None] * len(like)   # type: ignore[list-item]
    for k, idx in _group_leaves(like).items():
        parts = torch.split(flat[k], [like[i].numel() for i in idx])
        for i, seg in zip(idx, parts):
            out[i] = seg.view(like[i].shape)
    return out


class FusedOptimizer(torch.optim.Optimizer):
    """The inner optimizer of ``inner_factory`` stepping one flat parameter
    a dtype (:func:`fuse_optimizer` makes it).  ``param_groups`` are the
    wrapped parameters'; ``inner`` is the optimizer over the flats, whose
    state is this optimizer's state (``state_dict``)."""

    def __init__(self, params: Iterable[torch.Tensor], inner_factory: Callable):
        params = list(params)
        super().__init__(params, {})
        self._params: List[nn.Parameter] = [p for g in self.param_groups for p in g["params"]]
        with torch.no_grad():
            self._flats = {k: nn.Parameter(f.detach().clone())
                           for k, f in _flatten(self._params).items()}
        self.inner = inner_factory(list(self._flats.values()))

    @torch.no_grad()
    def step(self, closure=None):
        loss = closure() if closure is not None else None
        grads = _flatten([p.grad if p.grad is not None else torch.zeros_like(p)
                          for p in self._params])
        for k, v in _flatten(self._params).items():
            self._flats[k].copy_(v)
            self._flats[k].grad = grads[k]
        self.inner.step()
        views = _unflatten({k: f.detach() for k, f in self._flats.items()}, self._params)
        for p, v in zip(self._params, views):
            p.copy_(v)
        for f in self._flats.values():
            f.grad = None
        return loss

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, state_dict) -> None:
        self.inner.load_state_dict(state_dict)


class FusedOptimizerFactory:
    """``factory(params) -> FusedOptimizer`` over ``fused_inner``, the
    unfused optimizer factory that :func:`fuse_optimizer` wrapped (the
    trainer's flat-resident layout runs it on the bucket flats)."""

    def __init__(self, inner_factory: Callable):
        self.fused_inner = inner_factory

    def __call__(self, params: Iterable[torch.Tensor]) -> FusedOptimizer:
        return FusedOptimizer(params, self.fused_inner)

    def __repr__(self) -> str:
        return f"fuse_optimizer({self.fused_inner!r})"


def fuse_optimizer(inner_factory: Callable) -> FusedOptimizerFactory:
    """Wrap an optimizer factory (``params -> torch.optim.Optimizer``) to
    step one flat buffer per dtype."""
    return FusedOptimizerFactory(inner_factory)
