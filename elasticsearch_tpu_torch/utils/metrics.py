"""Metric primitives.

Counterpart of `elasticsearch_tpu/utils/metrics.py`, trimmed to the two
the resident query loop counts with (`search/resident.py`). Ref:
common/metrics/CounterMetric.java.
"""

from __future__ import annotations

import threading


class CounterMetric:
    """Monotonic (inc/dec) counter. Ref: common/metrics/CounterMetric.java."""

    __slots__ = ("_count", "_lock")

    def __init__(self):
        # writes are locked (+= is read-modify-write); the bare read in
        # .count is a single int load, atomic under the GIL
        self._count = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._count += n

    def dec(self, n: int = 1) -> None:
        with self._lock:
            self._count -= n

    @property
    def count(self) -> int:
        return self._count


class HighWaterMetric:
    """High-water-mark gauge: record() keeps the max ever seen, ints or
    floats (the resident loop's staged-feed overlap in ms)."""

    __slots__ = ("_max", "_last", "_lock")

    def __init__(self):
        self._max = 0
        self._last = 0
        self._lock = threading.Lock()

    def record(self, value: int | float) -> None:
        with self._lock:
            self._last = value
            if value > self._max:
                self._max = value

    @property
    def max(self) -> int | float:
        return self._max

    @property
    def last(self) -> int | float:
        return self._last
