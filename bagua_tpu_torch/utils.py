"""Small helpers shared by the models.

Port of ``remat_wrap`` of ``bagua_tpu/utils.py`` (``:231-245``): the one map
from a rematerialization policy name to what the backward keeps, shared by
the models' ``remat``/``remat_policy`` knobs.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

_aten = torch.ops.aten

#: policy name -> the ops whose outputs the backward keeps (None: keep
#: nothing, recompute the whole block).  JAX's ``dots_saveable`` keeps every
#: ``dot_general``; its ``dots_with_no_batch_dims_saveable`` only those
#: without batch dimensions, which is what ``F.linear`` lowers to
#: (``mm``/``addmm``); ``bmm``/``baddbmm`` are the batched ones.  Nothing
#: else is kept, in particular no allocation (``empty``): the flash and gmm
#: kernels write into tensors from ``torch.empty`` outside the dispatcher,
#: so the recompute must make them anew.
SAVED_OPS = {
    None: frozenset(),
    "dots": frozenset({_aten.mm.default, _aten.addmm.default,
                       _aten.bmm.default, _aten.baddbmm.default}),
    "dots_no_batch": frozenset({_aten.mm.default, _aten.addmm.default}),
}


def save_policy(remat_policy: Optional[str]) -> Callable:
    """The selective-checkpoint policy function of ``remat_policy``: keep
    the outputs of :data:`SAVED_OPS`, recompute everything else."""
    saved = SAVED_OPS[remat_policy]

    def policy_fn(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return policy_fn


def remat_wrap(block: Callable, remat_policy: Optional[str] = None) -> Callable:
    """``block`` (a module or function) under activation checkpointing with
    a NAMED policy: None recomputes the whole block in the backward,
    ``"dots"`` keeps every matmul output, ``"dots_no_batch"`` keeps the
    matmul outputs without batch dimensions.  Returns a function with
    ``block``'s signature; ``block``'s parameters keep their names (no
    wrapper module is made)."""
    if remat_policy not in SAVED_OPS:
        raise ValueError(f"remat_policy must be one of {sorted(SAVED_OPS, key=str)}, "
                         f"got {remat_policy!r}")
    kw = {}
    if remat_policy is not None:
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             save_policy(remat_policy))

    def run(*args, **kwargs):
        return checkpoint(block, *args, use_reentrant=False, **kw, **kwargs)

    return run
