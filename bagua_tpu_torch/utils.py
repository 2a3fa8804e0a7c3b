"""Small helpers shared by the models and the autotune loop.

Port of part of ``bagua_tpu/utils.py``: ``remat_wrap`` (``:231-245``), the
one map from a rematerialization policy name to what the backward keeps,
shared by the models' ``remat``/``remat_policy`` knobs; and the speed
statistics of the autotune check-in, ``average_by_removing_extreme_values``
and ``StatisticalAverage`` (``:102-198``).
"""

from __future__ import annotations

import math
import time
from typing import List, Tuple

import numpy as np

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


def average_by_removing_extreme_values(raw_score_list):
    """Robust mean: drop values > 3 sigma from the median-ish mean, like the
    reference's speed averaging (utils.py:219-248)."""
    score_list = np.asarray(raw_score_list, dtype=np.float64)
    while len(score_list) > 2:
        mean = score_list.mean()
        std = score_list.std()
        keep = np.abs(score_list - mean) <= 3 * std
        if keep.all():
            break
        score_list = score_list[keep]
    return float(score_list.mean()), float(score_list.std()), score_list.tolist()


class StatisticalAverage:
    """Exponentially time-bucketed rate tracker (reference utils.py:251-368).

    Records a cumulative value (e.g. samples processed) at wall-clock times and
    answers "average rate over the last T seconds" with power-of-two bucketing.
    """

    def __init__(self, last_update_time: float = None, records: List[float] = None,
                 record_tail: Tuple[float, float] = (0.0, 0.0)):
        self.last_update_time = time.time() if last_update_time is None else last_update_time
        self.records: List[float] = list(records) if records else []
        self.record_tail = record_tail

    def record_seconds(self) -> float:
        # buckets of 1, 2, 4, ... 2^(L-1) seconds cover 2^L - 1 seconds.
        # Claiming 2^L here would self-inflate: record()'s regrow loop runs
        # while 2^i <= total + elapsed, so an overcount of exactly one
        # second makes EVERY call grow the list by one bucket regardless of
        # elapsed time — unbounded, and 2.0 ** i overflows after ~1000
        # steps of training
        return 2.0 ** len(self.records) - 1.0 if self.records else 0.0

    def total_recording_time(self) -> float:
        tail_sec, _ = self.record_tail
        return self.record_seconds() + tail_sec

    def get_records_mean(self, last_n_seconds: float) -> float:
        if last_n_seconds <= 0:
            return 0.0
        records_seconds = self.record_seconds()
        tail_seconds, tail_mean = self.record_tail
        if len(self.records) == 0:
            return tail_mean
        if last_n_seconds < 1.0:
            return self.records[0]
        if last_n_seconds <= records_seconds:
            mean = 0.0
            cnt = int(math.floor(math.log2(last_n_seconds)))
            for i in range(cnt):
                mean += (2.0 ** i / last_n_seconds) * self.records[i]
            last_sec = last_n_seconds - 2.0 ** cnt + (2.0 ** cnt - sum(2.0 ** i for i in range(cnt)))
            mean += max(last_sec, 0.0) / last_n_seconds * self.records[min(cnt, len(self.records) - 1)]
            return mean
        mean = (records_seconds / max(last_n_seconds, 1e-9)) * (
            sum(2.0 ** i * r for i, r in enumerate(self.records)) / max(records_seconds, 1e-9)
        )
        remain = min(last_n_seconds - records_seconds, tail_seconds)
        mean += (remain / max(last_n_seconds, 1e-9)) * tail_mean
        return mean

    def record(self, val: float):
        if not math.isfinite(val):
            return  # a zero-dt window's inf rate would poison every mean
        now = time.time()
        elapsed = now - self.last_update_time
        new_records: List[float] = []
        total = self.total_recording_time()
        i = 0
        while 2.0 ** i <= total + elapsed:
            seconds = 2.0 ** i
            if seconds <= elapsed:
                new_records.append(val)
            else:
                mean = (elapsed / seconds) * val + ((seconds - elapsed) / seconds) * self.get_records_mean(seconds - elapsed)
                new_records.append(mean)
            i += 1
        tail_total = min(total + elapsed, 2.0 ** 10)
        tail_sec = max(tail_total - (2.0 ** (len(new_records)) - 1 if new_records else 0), 0.0)
        tail_mean = self.get_records_mean(tail_total) if tail_sec > 0 else 0.0
        self.records = new_records
        self.record_tail = (tail_sec, tail_mean)
        self.last_update_time = now

    def get(self, last_n_seconds: float) -> float:
        elapsed = time.time() - self.last_update_time
        if elapsed >= last_n_seconds:
            return 0.0
        return self.get_records_mean(last_n_seconds - elapsed) * (
            (last_n_seconds - elapsed) / last_n_seconds
        )

    def total(self) -> float:
        total_sec = self.total_recording_time()
        return self.get_records_mean(total_sec) * total_sec
