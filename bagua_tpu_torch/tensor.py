"""Named-parameter registry: a module's parameters under stable names.

Port of ``bagua_tpu/tensor.py``.  Names come from ``named_parameters()``;
the port's modules register their parameters in the order the JAX package's
sorted pytree flatten visits them, so the two packages list (and bucket) the
same tensors in the same order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import torch

from .define import TensorDeclaration, to_bagua_datatype


@dataclass(frozen=True)
class NamedParam:
    """One registered tensor: name, shape and dtype of a module parameter."""

    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    def declaration(self) -> TensorDeclaration:
        return TensorDeclaration(name=self.name, num_elements=self.numel,
                                 dtype=to_bagua_datatype(self.dtype))


def build_params(model: torch.nn.Module) -> List[NamedParam]:
    """Collect named params in reversed registration order, roughly the
    order the backward produces their gradients.  A parameter shared by
    several modules (tied weights) is listed once, under its first name;
    ``named_parameters`` names are unique, so the JAX package's
    duplicate-name check has nothing to catch here."""
    out = [NamedParam(name, tuple(p.shape), p.dtype)
           for name, p in model.named_parameters()]
    out.reverse()
    return out
