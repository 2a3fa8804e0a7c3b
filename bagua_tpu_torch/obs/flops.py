"""Model flops of a training step, counted from the shapes its forward runs.

The numerator of ``obs/mfu``.  The JAX package takes it from XLA's cost
analysis of the compiled step (``bagua_tpu/core/backend.py:1983-2000``);
eager torch has no compiled step, and ``torch.utils.flop_counter`` does not
see the port's hand-written kernels.  So the trainer counts the model flops
of the first step of each step key while its loss forward runs:

* every ``nn.Linear`` and ``nn.Conv*``: ``2 * out.numel() * fan_in`` a
  forward, by a forward hook that reads the output's shape (host metadata,
  no synchronization);
* flash attention (K6) and the grouped matmul (K7), whose entry points call
  :func:`note` while a counter is open: ``4 * b * h * d`` per (query, key)
  pair a causal query sees (``s (s + 1) / 2`` pairs a head) and
  ``2 * rows * d * f``.

A training step is the forward, the weight gradients (as many flops) and
the input gradients (as many again) where the input needs one: three
forwards for a layer whose input and weight both take gradients.  These are
MODEL flops: flash's recomputation in its backward, norms, softmax and
elementwise work are not counted (the usual MFU convention).  The count
runs during the loss forward only, so a rematerialized forward in the
backward is not counted twice.
"""

from __future__ import annotations

import threading
from typing import List

__all__ = ["StepFlopCounter", "note", "note_attention", "counting"]

#: open counters; the kernels' entry points check it (one global read)
_ACTIVE: List["StepFlopCounter"] = []
_LOCK = threading.Lock()


def counting() -> bool:
    return bool(_ACTIVE)


def note(forward_flops: float, input_grad: bool, weight_grad: bool = True) -> None:
    """Add one op's forward flops to every open counter, times the passes a
    step runs of it."""
    passes = 1 + int(bool(input_grad)) + int(bool(weight_grad))
    for c in list(_ACTIVE):
        if c.enabled:
            c.forward += forward_flops
            c.step += forward_flops * passes


def note_attention(b: int, h: int, s: int, d: int, causal: bool, requires_grad: bool) -> None:
    """Attention of ``b * h`` heads of ``s`` queries against as many keys,
    head width ``d``: Q K^T and P V, each ``2 d`` flops a (query, key)
    pair; the backward's dQ, dK and dV products (dP and dS count as the
    forward's two again) make a step three forwards where q takes a
    gradient."""
    pairs = s * (s + 1) // 2 if causal else s * s
    fwd = 4 * b * h * d * pairs
    # the weight-gradient slot stands for dK/dV, the input one for dQ
    note(fwd, input_grad=requires_grad, weight_grad=requires_grad)


class StepFlopCounter:
    """Counts the model flops of the ops run while it is open and
    :attr:`enabled`: ``forward`` and ``step`` (forward plus the backward's
    gradients)."""

    def __init__(self, model):
        self.model = model
        self.forward = 0.0
        self.step = 0.0
        self.enabled = False
        self._handles: list = []

    def _hook(self, module, inputs, output):
        import torch

        if not self.enabled or not isinstance(output, torch.Tensor):
            return
        w = module.weight
        fan_in = w[0].numel()
        x = inputs[0] if inputs else None
        note(2.0 * output.numel() * fan_in,
             input_grad=isinstance(x, torch.Tensor) and x.requires_grad,
             weight_grad=w.requires_grad)

    def __enter__(self) -> "StepFlopCounter":
        import torch.nn as nn

        kinds = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)
        self._handles = [m.register_forward_hook(self._hook)
                         for m in self.model.modules() if isinstance(m, kinds)]
        with _LOCK:
            _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        for h in self._handles:
            h.remove()
        self._handles = []
        with _LOCK:
            if self in _ACTIVE:
                _ACTIVE.remove(self)
        return False
