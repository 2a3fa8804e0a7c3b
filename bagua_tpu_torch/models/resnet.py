"""ResNet family (ResNet50 is the JAX package's headline throughput model).

Port of ``bagua_tpu/models/resnet.py``: convolutions in ``dtype`` (bf16 by
default) on f32 parameters, batch norms whose statistics are f32 and whose
output is ``norm_dtype``, the head an f32 ``Dense``.  Tensors are NCHW in
``torch.channels_last`` memory (the forward converts its input), where the
JAX package is NHWC; the arithmetic follows flax's, including where it
rounds:

- convolutions pad as flax's ``"SAME"`` does, the TF way: a stride-2 3x3
  convolution on an even input pads 0 before and 1 after (``F.pad``), not
  1 and 1; the stem's 7x7 ``[(3, 3), (3, 3)]`` and the max pool's ``(1, 1)``
  (with -inf, as ``F.max_pool2d`` pads) are symmetric;
- the batch norm is flax 0.12.3's ``BatchNorm`` (:class:`BatchNorm`): the
  mean and ``E[x^2] - E[x]^2`` (clipped at 0) in f32, ``(x - mean) *
  (rsqrt(var + eps) * scale) + bias`` in f32, cast to ``norm_dtype``; the
  running statistics track the BIASED variance, ``ra = m * ra + (1 - m) *
  batch`` at ``momentum=0.9`` (``torch.nn.BatchNorm2d`` tracks the unbiased
  one with the opposite momentum convention);
- the mean over H and W is taken in f32 and rounded to ``dtype``, then the
  head computes in f32.

A block registers a projection where its input's channels or stride differ
from its output's (flax decides by shape at trace time; the two agree but
on a 1x1 input).  Submodules and parameters register in the order the JAX
package's sorted pytree flatten visits them (``head``, ``stage{i}_block{j}``
by name, ``stem_conv``, ``stem_norm``; in a block ``BatchNorm_k``,
``Conv_k``, ``proj_conv``, ``proj_norm``, a norm's ``bias`` before its
``weight``), so ``build_params`` lists and buckets them as the JAX trainer
does; the names follow the flax tree (``models.convert`` maps the layouts).

:func:`classification_loss_fn` normalizes with the batch statistics and
leaves the running statistics as they are, as the JAX package's loss throws
their update away (``resnet.py:112-136``): the trainer's steps never change
them.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..utils import remat_wrap


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax's (TF's) ``"SAME"`` padding of one spatial dim: the output has
    ``ceil(size / stride)`` positions and the extra pad goes after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` (NCHW here): an f32 ``[out, in, kh, kw]`` weight,
    the input and weight cast to ``dtype``, ``padding`` ``"SAME"`` or
    ``((top, bottom), (left, right))``; a bias, where there is one, added
    after the convolution in ``dtype``."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1,
                 padding="SAME", use_bias: bool = False, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.kernel, self.stride, self.padding, self.dtype = kernel, stride, padding, dtype
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(c_out, device=device))
        else:
            self.register_parameter("bias", None)
        self.weight = nn.Parameter(torch.empty(c_out, c_in, kernel, kernel, device=device))

    def forward(self, x):
        if self.padding == "SAME":
            pads = [same_pads(n, self.kernel, self.stride) for n in x.shape[2:]]
        else:
            pads = [tuple(p) for p in self.padding]
        x = x.to(self.dtype)
        if all(a == b for a, b in pads):
            y = F.conv2d(x, self.weight.to(self.dtype), stride=self.stride,
                         padding=tuple(a for a, _ in pads))
        else:
            (t, b), (l, r) = pads
            y = F.conv2d(F.pad(x, (l, r, t, b)), self.weight.to(self.dtype), stride=self.stride)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype).view(1, -1, 1, 1)
        return y


class Dense(nn.Module):
    """flax ``nn.Dense``: an f32 ``[out, in]`` weight and bias, the product
    and the bias add in ``dtype``."""

    def __init__(self, d_in: int, d_out: int, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.bias = nn.Parameter(torch.zeros(d_out, device=device))
        self.weight = nn.Parameter(torch.empty(d_out, d_in, device=device))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype)) + self.bias.to(self.dtype)


class BatchNorm(nn.Module):
    """flax 0.12.3's ``nn.BatchNorm`` over dim 1 (NCHW, or ``[N, C]``).

    Training mode (``use_running_average`` False) normalizes with the batch
    statistics (:meth:`moments`) and, unless ``update_stats`` is False,
    moves the running ``mean`` and ``var`` buffers toward them by
    ``momentum``; :attr:`batch_stats` holds the last batch's ``(mean,
    var)`` (what flax returns through ``mutable=["batch_stats"]`` before the
    momentum step).  ``scale_init`` and ``bias_init`` are
    ``torch.nn.init`` functions; ``dtype`` is the output's (None: the
    input's)."""

    def __init__(self, num_features: int, use_running_average: Optional[bool] = None,
                 momentum: float = 0.99, epsilon: float = 1e-5, dtype=None,
                 param_dtype=torch.float32, use_bias: bool = True, use_scale: bool = True,
                 bias_init: Callable = nn.init.zeros_, scale_init: Callable = nn.init.ones_,
                 device=None):
        super().__init__()
        self.num_features = num_features
        self.use_running_average = use_running_average
        self.momentum, self.epsilon, self.dtype = momentum, epsilon, dtype
        # registration order: flax's sorted flatten visits bias before scale
        self.bias = (nn.Parameter(bias_init(torch.empty(num_features, dtype=param_dtype,
                                                        device=device)))
                     if use_bias else None)
        self.weight = (nn.Parameter(scale_init(torch.empty(num_features, dtype=param_dtype,
                                                           device=device)))
                       if use_scale else None)
        self.register_buffer("mean", torch.zeros(num_features, device=device))
        self.register_buffer("var", torch.ones(num_features, device=device))
        self.batch_stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def _shape(self, x) -> List[int]:
        return [1, x.shape[1]] + [1] * (x.dim() - 2)

    def moments(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """The batch's f32 mean and biased variance per feature (flax's
        ``use_fast_variance``: ``E[x^2] - E[x]^2``, clipped at 0)."""
        xf = x.float()
        dims = [0] + list(range(2, x.dim()))
        mean, mean_sq = self._average(xf.mean(dims), xf.square().mean(dims))
        return mean, torch.clamp(mean_sq - mean.square(), min=0.0)

    def _average(self, mean, mean_sq):
        """The moments over the batch norm's ranks: this rank's alone."""
        return mean, mean_sq

    def _normalize(self, x, mean, var):
        shape = self._shape(x)
        y = x.float() - mean.view(shape)
        mul = torch.rsqrt(var + self.epsilon)
        if self.weight is not None:
            mul = mul * self.weight
        y = y * mul.view(shape)
        if self.bias is not None:
            y = y + self.bias.view(shape)
        return y

    def forward(self, x, use_running_average: Optional[bool] = None, update_stats: bool = True):
        use_ra = self.use_running_average if use_running_average is None else use_running_average
        if use_ra is None:
            raise ValueError("use_running_average is given neither at construction nor at call")
        if use_ra:
            mean, var = self.mean, self.var
        else:
            mean, var = self.moments(x)
            self.batch_stats = (mean.detach(), var.detach())
            if update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.mean.copy_(m * self.mean + (1 - m) * mean)
                    self.var.copy_(m * self.var + (1 - m) * var)
        return self._normalize(x, mean, var).to(self.dtype or x.dtype)


def _class_name(cls) -> str:
    """The name flax gives an unnamed module of ``cls`` (a class, or a
    ``functools.partial`` of one)."""
    return getattr(cls, "func", cls).__name__


def _register_sorted(module: nn.Module, children: dict) -> None:
    for name in sorted(children):
        module.add_module(name, children[name])


class BottleneckBlock(nn.Module):
    """1x1, 3x3 (the stride here), 1x1 x4, each followed by a norm; the
    last norm's scale starts at zero; a projection where the shape
    changes."""

    def __init__(self, c_in: int, filters: int, strides: int, conv: Callable, norm: Callable,
                 norm_name: str):
        super().__init__()
        out = filters * 4
        children = {
            "Conv_0": conv(c_in, filters, 1), f"{norm_name}_0": norm(filters),
            "Conv_1": conv(filters, filters, 3, strides), f"{norm_name}_1": norm(filters),
            "Conv_2": conv(filters, out, 1),
            f"{norm_name}_2": norm(out, scale_init=nn.init.zeros_),
        }
        self.has_proj = c_in != out or strides != 1
        if self.has_proj:
            children["proj_conv"] = conv(c_in, out, 1, strides)
            children["proj_norm"] = norm(out)
        _register_sorted(self, children)
        self.norm_name = norm_name

    def forward(self, x, use_ra: bool, update_stats: bool):
        def norm(name, y):
            return getattr(self, name)(y, use_running_average=use_ra, update_stats=update_stats)

        y = torch.relu(norm(f"{self.norm_name}_0", self.Conv_0(x)))
        y = torch.relu(norm(f"{self.norm_name}_1", self.Conv_1(y)))
        y = norm(f"{self.norm_name}_2", self.Conv_2(y))
        residual = x
        if self.has_proj:
            residual = norm("proj_norm", self.proj_conv(x))
        return torch.relu(residual + y)


class ResNet(nn.Module):
    """``stage_sizes`` bottleneck blocks a stage over a 7x7 stem; logits
    ``[N, num_classes]`` f32 of images ``[N, in_channels, H, W]``.  Weights
    drawn from ``seed`` on ``device`` (``cuda`` unless the caller passes
    another; ``meta`` builds the shapes alone).  ``norm_cls`` replaces the
    batch norm (e.g. ``functools.partial(SyncBatchNorm, axis_name="dp")``):
    it is called as ``norm_cls(num_features, momentum=, epsilon=, dtype=,
    param_dtype=[, scale_init=], device=)`` and its forward as ``norm(x,
    use_running_average=, update_stats=)``.  ``remat`` recomputes each block
    in the backward (``utils.remat_wrap`` with ``remat_policy``; the
    matmul-keeping policies keep nothing here, convolutions not being
    matmuls, as in the JAX package)."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype=torch.bfloat16, norm_dtype=torch.bfloat16,
                 norm_cls=None, remat: bool = False, remat_policy: Optional[str] = None,
                 in_channels: int = 3, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.stage_sizes = tuple(stage_sizes)
        self.dtype = dtype
        self.remat, self.remat_policy = remat, remat_policy
        conv = functools.partial(Conv, dtype=dtype, device=device)
        norm_base = norm_cls or BatchNorm
        norm = functools.partial(norm_base, momentum=0.9, epsilon=1e-5, dtype=norm_dtype,
                                 param_dtype=torch.float32, device=device)
        name = _class_name(norm_base)
        children = {"stem_conv": conv(in_channels, num_filters, 7, 2, padding=((3, 3), (3, 3))),
                    "stem_norm": norm(num_filters)}
        c = num_filters
        self.block_names = []
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                strides = 2 if i > 0 and j == 0 else 1
                block = BottleneckBlock(c, num_filters * 2 ** i, strides, conv, norm, name)
                children[f"stage{i}_block{j}"] = block
                self.block_names.append(f"stage{i}_block{j}")
                c = num_filters * 2 ** i * 4
        children["head"] = Dense(c, num_classes, torch.float32, device=device)
        _register_sorted(self, children)
        if device.type != "meta":
            self.reset_parameters(torch.Generator(device=device).manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax-like: convolution and head weights normal with std
        ``1/sqrt(fan_in)``, biases zero (the norms keep their inits)."""
        for m in self.modules():
            if isinstance(m, (Conv, Dense)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)

    def forward(self, x, train: bool = True, update_stats: bool = True):
        x = x.contiguous(memory_format=torch.channels_last)
        use_ra = not train
        x = self.stem_conv(x.to(self.dtype))
        x = torch.relu(self.stem_norm(x, use_running_average=use_ra, update_stats=update_stats))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.block_names:
            block = getattr(self, name)
            run = remat_wrap(block, self.remat_policy) if self.remat else block
            x = run(x, use_ra, update_stats)
        x = x.float().mean((2, 3)).to(self.dtype)
        return self.head(x)


ResNet50 = functools.partial(ResNet, stage_sizes=(3, 4, 6, 3))
ResNet101 = functools.partial(ResNet, stage_sizes=(3, 4, 23, 3))


def classification_loss_fn(model: nn.Module, batch) -> torch.Tensor:
    """Softmax cross-entropy over integer labels, ``batch = dict(images=[N,
    C, H, W], labels=[N])``: batch statistics in the norms, the running ones
    left as they are (the JAX package's ``classification_loss_fn``)."""
    logits = model(batch["images"], train=True, update_stats=False)
    return F.cross_entropy(logits, batch["labels"].long())
