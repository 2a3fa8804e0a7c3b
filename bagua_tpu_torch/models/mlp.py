"""Small MLP used by tests and the quick start (port of
``bagua_tpu/models/mlp.py``).  Unlike flax, torch needs the input width up
front."""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..device import resolve_device


class MLP(nn.Module):
    """``Linear`` layers with ReLU between them; weights drawn from ``seed``
    on ``device`` (``cuda`` unless the caller passes another) with torch's
    default ``Linear`` distribution."""

    def __init__(self, in_features: int, features: Sequence[int] = (64, 64, 10),
                 device=None, seed: int = 0):
        super().__init__()
        self.n = len(features)
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        widths = [in_features, *features]
        for i in range(self.n):
            layer = nn.Linear(widths[i], widths[i + 1], device=device)
            bound = 1.0 / math.sqrt(widths[i])
            with torch.no_grad():
                layer.weight.uniform_(-bound, bound, generator=gen)
                layer.bias.uniform_(-bound, bound, generator=gen)
            self.add_module(f"dense_{i}", layer)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.n - 1:
                x = torch.relu(x)
        return x
