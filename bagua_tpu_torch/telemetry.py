"""Process-wide named counters and gauges.

Port of the counters of ``bagua_tpu/telemetry.py`` (``:36-101``): the
``comm/*`` abort counters, the ``async/*`` counters of async model average
and the ``faults/<point>/{armed,fired,recovered}`` counters of fault
injection are read by tests and by ``chip_smoke.py``.  Counters are
process-global: read deltas between two snapshots, never absolute values.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Union


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
