"""Process-wide named counters and gauges.

Port of the counters of ``bagua_tpu/telemetry.py`` (``:36-101``): the
``comm/*`` abort counters, the ``async/*`` counters of async model average
and the ``faults/<point>/{armed,fired,recovered}`` counters of fault
injection are read by tests and by ``chip_smoke.py``.  Counters are
process-global: read deltas between two snapshots, never absolute values.

And :func:`profile_tensor_execution_order` (``bagua_tpu/telemetry.py:166``),
the gradient-readiness order the autotune service reorders buckets by.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Union


class CounterSnapshot(dict):
    """A ``name -> value`` dict stamped with the monotonic time it was
    taken (``collected_at``)."""

    def __init__(self, values: Dict[str, Union[int, float]], collected_at: float):
        super().__init__(values)
        self.collected_at = collected_at


class TelemetryCounters:
    """Named counters and gauges under one lock.  ``incr`` counts events
    (``async/rounds_launched``), ``set_gauge`` keeps the last reading
    (``async/staleness_max``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._values: Dict[str, Union[int, float]] = {}

    def incr(self, name: str, n: Union[int, float] = 1) -> Union[int, float]:
        with self._lock:
            self._values[name] = self._values.get(name, 0) + n
            return self._values[name]

    def incr_many(self, updates: Dict[str, Union[int, float]]) -> None:
        """Several increments under one acquisition of the lock."""
        with self._lock:
            for name, n in updates.items():
                self._values[name] = self._values.get(name, 0) + n

    def set_gauge(self, name: str, value: Union[int, float]) -> None:
        with self._lock:
            self._values[name] = value

    def get(self, name: str) -> Union[int, float]:
        with self._lock:
            return self._values.get(name, 0)

    def snapshot(self) -> CounterSnapshot:
        """A point-in-time copy, stamped with ``time.monotonic()``."""
        with self._lock:
            return CounterSnapshot(self._values, time.monotonic())

    def reset(self) -> None:
        with self._lock:
            self._values.clear()


#: the process's counters
counters = TelemetryCounters()


def profile_tensor_execution_order(loss_fn: Callable, model: Any, batch: Any) -> List[Dict]:
    """Each parameter's gradient-readiness time in one backward of
    ``loss_fn(model, batch)``, as spans shaped like
    :class:`~bagua_tpu_torch.define.BaguaCoreTelemetrySpan` (``trace_id``,
    ``action`` ``"tensor_ready"``, ``tensor_name``, ``start_time`` and
    ``end_time``: nanoseconds from the backward's start, on the host clock
    of autograd's engine) sorted by readiness.

    The JAX package derives the order from a trace of the program (the
    first use of each parameter in the forward); here it is autograd's own:
    a hook on each parameter records when its gradient is computed.  The
    backward is ``torch.autograd.grad``, so no ``.grad`` is written, and
    the random-number state is restored afterwards, so the training that
    follows is unchanged.  A parameter that gets no gradient sorts last."""
    import torch

    params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    ready: Dict[str, int] = {}

    def hook(name):
        def record(grad):
            ready.setdefault(name, time.monotonic_ns() - t0)

        return record

    handles = [p.register_hook(hook(n)) for n, p in params]
    cuda = sorted({p.device.index or 0 for _, p in params if p.device.type == "cuda"})
    try:
        with torch.random.fork_rng(devices=cuda):
            t0 = time.monotonic_ns()
            loss = loss_fn(model, batch)
            torch.autograd.grad(loss, [p for _, p in params], allow_unused=True)
    finally:
        for h in handles:
            h.remove()
    last = max(ready.values(), default=0) + 1
    spans = [{"trace_id": 0, "action": "tensor_ready", "tensor_name": n,
              "start_time": int(ready.get(n, last)), "end_time": int(ready.get(n, last))}
             for n, _ in params]
    spans.sort(key=lambda s: s["start_time"])
    return spans
