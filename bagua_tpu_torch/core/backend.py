"""BaguaTrainer: the data-parallel training step.

Port of the main path of ``bagua_tpu/core/backend.py``.  One step is: the
abort check, the algorithm's ``host_pre_step`` (async model average's
boundary, where a round is launched or applied), its ``need_reset`` (QAdam's
phase switch), the per-rank mean loss, its backward, the gradients flattened into the bucket
plan's flat buffers, the algorithm's ``process_grads`` (for
``GradientAllReduceAlgorithm``, one allreduce per bucket), its
``process_pre_step`` (the full-precision gossip exchange of the weights), the
optimizer step on the reduced gradients, its ``process_post_step`` (the
low-precision gossip ring), and the loss averaged over the ranks.  The weight
hooks' results, and whatever ``host_pre_step`` changes, go into the module's
parameters in place.  An
algorithm that owns its optimizer (QAdam, ZeRO) gets no torch optimizer: its
``optimizer_update`` runs after ``process_grads`` (ZeRO's holds its
collectives, and its state is this rank's shard).  Where a stateful codec
(``onebit_ef``, ``topk``) rides the wire, ``state.algo_state["ef"]["buckets"]``
carries the error-feedback residual, one f32 flat per bucket.

PyTorch runs eagerly, so there is no compiled-step cache; the state is the
module and the optimizer, updated in place, rather than an immutable pytree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .. import env
from ..algorithms.base import Algorithm, AlgorithmContext
from ..bucket import split_bucket_by_bucket_size
from ..communication import ReduceOp, check_abort, get_backend
from ..compression.codecs import validate_codec_policy
from ..device import resolve_device
from ..tensor import build_params


@dataclass
class TrainState:
    """The module (params), its optimizer (and thus the optimizer state),
    the algorithm's state and the step count.  ``train_step`` updates the
    module and optimizer in place and returns a new ``TrainState``.  For an
    algorithm that owns its optimizer, ``optimizer`` is None and
    ``opt_state`` holds the algorithm's optimizer state."""

    step: int
    model: nn.Module
    optimizer: Optional[torch.optim.Optimizer]
    algo_state: Any = None
    opt_state: Any = None


class BaguaTrainer:
    """Owns the bucket plan and drives the algorithm around each step.

    Args:
        loss_fn: ``loss_fn(model, batch) -> scalar tensor`` (per-rank mean).
        optimizer_factory: ``optimizer_factory(params) -> Optimizer``, e.g.
            ``functools.partial(torch.optim.AdamW, lr=1e-4)``; unused (and
            may be None) for an algorithm that owns its optimizer.
        algorithm: a :class:`bagua_tpu_torch.algorithms.base.Algorithm`.
        device: where the model and batches live; ``cuda`` by default.
        bucket_bytes: bucket size in bytes (default env
            ``BAGUA_DEFAULT_BUCKET_SIZE``, 10 MiB).
        compress_intra: codec policy of the intra-node tier and the flat
            ring (default env ``BAGUA_COMPRESS_INTRA``, ``auto``): ``auto``
            keeps the family's own wire format, ``off`` forces full
            precision, a codec name (``minmax_uint8``, ``int8``,
            ``fp8_e4m3``, ``fp8_e5m2``, ``onebit_ef``, ``topk``) makes every
            bucket allreduce ride the compressed ring at world size > 1.
        compress_inter: codec policy of the inter-node tier of the
            hierarchical forms (default env ``BAGUA_COMPRESS_INTER``, same
            values).
    """

    def __init__(
        self,
        loss_fn: Callable,
        optimizer_factory: Callable,
        algorithm: Algorithm,
        device=None,
        bucket_bytes: Optional[int] = None,
        compress_intra: Optional[str] = None,
        compress_inter: Optional[str] = None,
    ):
        self.loss_fn = loss_fn
        self.optimizer_factory = optimizer_factory
        self.algorithm = algorithm
        self.device = resolve_device(device)
        self.bucket_bytes = (env.get_default_bucket_size()
                             if bucket_bytes is None else bucket_bytes)
        self.backend = get_backend()
        self.comm = self.backend.global_communicator
        self.world_size = self.comm.nranks()
        self.compress_intra = validate_codec_policy(
            env.get_compress_intra() if compress_intra is None else compress_intra,
            "compress_intra")
        self.compress_inter = validate_codec_policy(
            env.get_compress_inter() if compress_inter is None else compress_inter,
            "compress_inter")
        #: whether the error-feedback residual may be carried; whether it is
        #: is the algorithm's call (``Algorithm.ef_codec``)
        self._ef_enabled = not env.is_ef_residual_disabled()
        self._ctx: Optional[AlgorithmContext] = None
        self._params = None
        #: train_step calls on this trainer, the counter ``need_reset`` reads
        self._step_counter = 0

    @property
    def plan(self):
        return self._ctx.plan

    @property
    def host_staged_bytes(self) -> int:
        """Bytes staged through the host for gloo so far, summed over the
        global and the two tier communicators and the algorithm's own
        (async model average's averaging group)."""
        comms = self.backend.communicators() + self.algorithm.communicators()
        return sum(c.host_staged_bytes for c in comms)

    def _ef_active(self) -> bool:
        """Whether this configuration carries the error-feedback residual in
        ``algo_state``."""
        return self._ctx is not None and self.algorithm.ef_codec(self._ctx) is not None

    def init(self, model: nn.Module) -> TrainState:
        """Move ``model`` to the trainer's device, give every rank rank 0's
        weights, build the bucket plan and the optimizer (or the algorithm's
        optimizer state)."""
        model.to(self.device)
        with torch.no_grad():
            for p in model.parameters():
                dist.broadcast(p.data, src=0)
        algo = self.algorithm
        named = algo.init_tensors(build_params(model))
        decls = [p.declaration() for p in named]
        plan = algo.tensors_to_buckets(
            split_bucket_by_bucket_size(decls, self.bucket_bytes), named, self.world_size)
        self._ctx = AlgorithmContext(
            comm=self.comm, plan=plan, world_size=self.world_size,
            intra_codec=self.compress_intra, inter_codec=self.compress_inter,
            intranode=self.backend.intranode_communicator,
            internode=self.backend.internode_communicator,
            ef_enabled=self._ef_enabled, device=self.device)
        self._params = dict(model.named_parameters())
        with torch.no_grad():
            algo_state = algo.init_state(self._ctx, self._params)
        if algo.owns_optimizer:
            opt_state = (algo.init_optimizer_state_sharded(self._ctx, self._params)
                         if algo.sharded_opt_state else algo.init_optimizer_state(self._params))
            return TrainState(0, model, None, algo_state, opt_state)
        optimizer = self.optimizer_factory(model.parameters())
        return TrainState(0, model, optimizer, algo_state)

    def shard_batch(self, local_batch: Mapping) -> dict:
        """This rank's batch on the trainer's device.  Each rank feeds its
        own slice of the global batch, as each reference rank feeds its own
        DataLoader split."""
        def put(x):
            if not isinstance(x, torch.Tensor):
                x = torch.tensor(np.asarray(x))
            return x.to(self.device, non_blocking=True)

        return {k: put(v) for k, v in local_batch.items()}

    def train_step(self, state: TrainState, batch) -> Tuple[TrainState, torch.Tensor]:
        """One step; returns the new state and the loss averaged over ranks."""
        check_abort()   # no new step once a rank flagged an abort
        algo = self.algorithm
        self._step_counter += 1
        # the boundary between steps, before the phase switch, as in the
        # JAX trainer
        with torch.no_grad():
            state = algo.host_pre_step(self, state)
        model, optimizer = state.model, state.optimizer
        # the phase switch (QAdam's warmup boundary) on the trainer's own
        # step count, at the top of the step, as the JAX trainer does
        algo.need_reset(self._step_counter - 1)
        model.train()
        for p in self._params.values():
            p.grad = None
        loss = self.loss_fn(model, batch)
        loss.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in self._params.items()}
        grads, algo_state = algo.process_grads(
            self._ctx, grads, self._params, state.algo_state, state.step)
        # the gossip exchange: the gradient was taken at the weights from
        # before it and is applied to the exchanged weights
        algo_state = self._weight_hook(algo.process_pre_step, algo_state, state.step)
        opt_state = state.opt_state
        if algo.owns_optimizer:
            _, opt_state, algo_state = algo.optimizer_update(
                self._ctx, self._params, grads, opt_state, algo_state, state.step)
        else:
            for n, g in grads.items():
                self._params[n].grad = g
            optimizer.step()
        algo_state = self._weight_hook(algo.process_post_step, algo_state, state.step)
        loss = self.comm.allreduce(loss.detach().clone(), ReduceOp.AVG)
        return TrainState(state.step + 1, model, optimizer, algo_state, opt_state), loss

    @torch.no_grad()
    def _weight_hook(self, hook, algo_state, step):
        """Run a weight hook (``process_pre_step``, ``process_post_step``)
        outside autograd, copy the weights it returns into the module's
        parameters in place (the optimizer keys its state by those objects)
        and return the algorithm state."""
        params, algo_state = hook(self._ctx, self._params, algo_state, step)
        for n, t in params.items():
            p = self._params[n]
            if t is not p:
                p.copy_(t)
        return algo_state

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch) -> torch.Tensor:
        """Forward-only loss of this rank's weights (the gossip families'
        differ between ranks) averaged over the ranks; the state is
        untouched."""
        state.model.eval()
        loss = self.loss_fn(state.model, batch)
        return self.comm.allreduce(loss.detach().clone(), ReduceOp.AVG)
