"""VGG family: the reference's headline end-to-end benchmark model.

Port of ``bagua_tpu/models/vgg.py`` (Bagua's flagship published number is
VGG16 synthetic-ImageNet throughput).  3x3 convolutions at stride 1 with
``"SAME"`` (symmetric) padding and a bias, ReLU, 2x2 max pools, then two
``hidden``-wide dense layers and an f32 head; convolutions and the first
two dense layers in ``dtype`` (bf16 by default) on f32 parameters, as flax
casts.  No classifier dropout, as in the JAX package.

Tensors are NCHW in ``torch.channels_last`` memory.  The JAX package
flattens NHWC before ``fc1``; the forward permutes to NHWC first (free in
channels-last memory), so ``fc1``'s rows are in flax's order and
``models.convert`` only transposes it.  torch needs the image size up
front for ``fc1``'s width (flax infers it at ``init``).  Parameters
register in flax's sorted flatten order (``conv{i}`` by name, ``fc1``,
``fc2``, ``head``; ``bias`` before ``weight``).
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .resnet import Conv, Dense, _register_sorted

# filters per conv, "M" = 2x2 max-pool (the standard configuration tables)
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")
VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M")


class VGG(nn.Module):
    """Logits ``[N, num_classes]`` f32 of images ``[N, in_channels,
    image_size, image_size]``; weights drawn from ``seed`` on ``device``
    (``cuda`` unless the caller passes another; ``meta`` builds the shapes
    alone)."""

    def __init__(self, cfg: Sequence = VGG16_CFG, num_classes: int = 1000,
                 dtype=torch.bfloat16, hidden: int = 4096, image_size: int = 224,
                 in_channels: int = 3, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.dtype = tuple(cfg), dtype
        children, c, size, i = {}, in_channels, image_size, 0
        for v in self.cfg:
            if v == "M":
                size //= 2
            else:
                children[f"conv{i}"] = Conv(c, v, 3, 1, "SAME", use_bias=True, dtype=dtype,
                                            device=device)
                c, i = v, i + 1
        self.n_convs = i
        children["fc1"] = Dense(c * size * size, hidden, dtype, device=device)
        children["fc2"] = Dense(hidden, hidden, dtype, device=device)
        children["head"] = Dense(hidden, num_classes, torch.float32, device=device)
        _register_sorted(self, children)
        if device.type != "meta":
            self.reset_parameters(torch.Generator(device=device).manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax-like: weights normal with std ``1/sqrt(fan_in)``, biases
        zero."""
        for m in self.modules():
            if isinstance(m, (Conv, Dense)):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight[0].numel()), generator=generator)

    def forward(self, x):
        x = x.contiguous(memory_format=torch.channels_last).to(self.dtype)
        i = 0
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2, stride=2)
            else:
                x = torch.relu(getattr(self, f"conv{i}")(x))
                i += 1
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # flax's NHWC order
        x = torch.relu(self.fc1(x))
        x = torch.relu(self.fc2(x))
        return self.head(x)


VGG16 = functools.partial(VGG, cfg=VGG16_CFG)
VGG19 = functools.partial(VGG, cfg=VGG19_CFG)


def vgg_loss_fn(model: nn.Module, batch) -> torch.Tensor:
    """Softmax cross-entropy over integer labels (no batch-norm state)."""
    return F.cross_entropy(model(batch["images"]), batch["labels"].long())
