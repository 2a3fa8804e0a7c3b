"""QAdam: quantized-momentum Adam (the 1-bit-Adam family).

Port of ``bagua_tpu/algorithms/q_adam.py``.  Two phases, switched by
``need_reset`` at the warmup boundary:

- warmup (``step < warmup_steps``): gradients are averaged in full
  precision, both Adam moments update from the averaged gradient, and the
  parameters step by the Adam rule;
- compressed: the momentum (``exp_avg``) updates locally from the raw
  gradient and is then averaged, and the second moment is frozen.  The
  average takes the two-level form where ``hierarchical`` and the tiers
  allow it (a full-precision intra-node reduce-scatter, the compressed ring
  across nodes, K1 and K2 unless ``compress_inter`` names another codec, an
  intra-node allgather), else the 8-bit compressed scatter-gather over the
  whole world.  The JAX package's third form, the "legacy Leader"
  (``q_adam.py:133-160``), runs where an ep or sp axis folded into the comm
  axes makes the tiers refuse: it averages over ``inter x intra`` alone, so
  the ranks of that axis keep different momenta.  The port takes the flat
  form there, as the other families do (ROADMAP.md, Queue 3).

The algorithm owns its optimizer, so the trainer builds no torch optimizer
for it.  The moments are laid out as the parameters the trainer hands over:
dicts of tensors by parameter name, or, under the flat-resident layout, one
flat a bucket; the update runs in place on the parameters.  Under expert,
tensor or pipeline parallelism the moments cover every leaf, the expert
tables and sharded ("local") leaves outside the bucket plan included: their gradients come from the
trainer already averaged over dp, and the compressed phase communicates the
plan's momentum alone, keeping theirs.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from ..communication import LINK_ICI, ReduceOp
from ..compression import compressed_scatter_gather_allreduce
from .base import Algorithm, AlgorithmContext


class QAdamOptState(NamedTuple):
    exp_avg: Any
    exp_avg_sq: Any


def _keys(tensors):
    """The keys of tensors by name (a dict) or of one flat a bucket (a
    tuple or list)."""
    return tensors.keys() if isinstance(tensors, dict) else range(len(tensors))


def _like(tensors, fn):
    """``fn`` of each tensor, laid out as ``tensors`` (a dict or a tuple)."""
    if isinstance(tensors, dict):
        return {n: fn(t) for n, t in tensors.items()}
    return tuple(fn(t) for t in tensors)


class QAdamAlgorithm(Algorithm):
    name = "qadam"
    owns_optimizer = True
    #: every rank owns an equal chunk of the compressed scatter-gather
    align_to_world = True
    #: the compressed phase's wire formats: the inter-node ring hops and the
    #: flat scatter-gather
    wire_codec_dcn = "minmax_uint8"
    wire_codec_flat = "minmax_uint8"
    supports_flat_resident = True

    def __init__(
        self,
        warmup_steps: int = 100,
        lr: float = 1e-3,
        betas: Tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        hierarchical: bool = True,
    ):
        """
        Args:
            warmup_steps: steps of full-precision gradient allreduce before
                the switch to compressed momentum communication.
            lr / betas / eps / weight_decay: the Adam hyperparameters.
            hierarchical: the two-level form in the compressed phase where
                the tiers allow it.
        """
        self.warmup_steps = warmup_steps
        self.lr = lr
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.hierarchical = hierarchical
        self._compressed = False

    def need_reset(self, step: int) -> bool:
        if step == self.warmup_steps and not self._compressed:
            self._compressed = True
            return True
        return False

    # ---- phase 1: warmup gradient allreduce --------------------------------

    def process_grads(self, ctx: AlgorithmContext, grads, params, algo_state, step):
        if self._compressed:
            return grads, algo_state
        flats = [ctx.comm.allreduce(f, ReduceOp.AVG) for f in ctx.bucket_flats(grads)]
        return ctx.from_bucket_flats(flats), algo_state

    # ---- optimizer -----------------------------------------------------------

    def init_optimizer_state(self, params):
        return QAdamOptState(exp_avg=_like(params, torch.zeros_like),
                             exp_avg_sq=_like(params, torch.zeros_like))

    def _communicate_momentum(self, ctx: AlgorithmContext, exp_avg):
        two_level = self.hierarchical and ctx.two_tier()
        if not two_level and ctx.comm.nranks() <= 1:
            return exp_avg
        out = []
        for f in ctx.bucket_flats(exp_avg):
            if two_level:
                # buckets are world-aligned, so both tiers divide them
                f = ctx.tier_reduce_scatter(f, ReduceOp.AVG)
                f = ctx.tier_allreduce(f, ReduceOp.AVG, codec=self.wire_codec_dcn)
                f = ctx.tier_allgather(f)
            elif ctx.codec_for(LINK_ICI, self.wire_codec_flat) is None:
                # compress_intra="off": the full-precision escape hatch
                f = ctx.bucket_allreduce(f, ReduceOp.AVG)
            else:
                f = compressed_scatter_gather_allreduce(ctx.comm, f, average=True)
            out.append(f)
        out = ctx.from_bucket_flats(out)
        # the leaves outside the plan keep their own momentum
        return {**exp_avg, **out} if isinstance(exp_avg, dict) else out

    @torch.no_grad()
    def optimizer_update(self, ctx, params, grads, opt_state: QAdamOptState, algo_state, step):
        beta1, beta2 = self.betas
        # the reference's QAdamOptimizer.step counts from 1
        step_id = step + 1
        keys = _keys(params)
        for n in keys:
            opt_state.exp_avg[n].mul_(beta1).add_(grads[n] * (1.0 - beta1))
        exp_avg = opt_state.exp_avg
        if self._compressed:
            # second moment frozen; momentum averaged through the codec
            exp_avg = self._communicate_momentum(ctx, exp_avg)
        else:
            for n in keys:
                opt_state.exp_avg_sq[n].mul_(beta2).add_(grads[n] * grads[n] * (1.0 - beta2))
        exp_avg_sq = opt_state.exp_avg_sq
        bias1 = 1.0 - beta1 ** step_id
        bias2 = 1.0 - beta2 ** step_id
        for n in keys:
            p = params[n]
            denom = exp_avg_sq[n].sqrt().div_(bias2 ** 0.5).add_(self.eps)
            decay = p * (self.lr * self.weight_decay) if self.weight_decay else None
            p.sub_(exp_avg[n] / denom * (self.lr / bias1))
            if decay is not None:
                p.sub_(decay)
        return params, QAdamOptState(exp_avg, exp_avg_sq), algo_state
