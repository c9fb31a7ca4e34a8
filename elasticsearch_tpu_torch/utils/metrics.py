"""Metric primitives.

Counterpart of `elasticsearch_tpu/utils/metrics.py`, trimmed to what the
resident query loop, the dispatch scheduler and the traffic controller
count with. Ref: common/metrics/CounterMetric.java, EWMA.java.
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


class EWMA:
    """Exponentially-weighted moving average (ref: common/metrics/
    EWMA.java), internally locked: concurrent request threads feed it."""

    __slots__ = ("alpha", "_value", "_initialized", "_lock")

    def __init__(self, alpha: float = 0.3, initial: float = 0.0,
                 seeded: bool = False):
        """`seeded=True` starts the series AT `initial` (the first sample
        decays toward it) instead of replacing it."""
        self.alpha = alpha
        self._value = initial
        self._initialized = seeded
        self._lock = threading.Lock()

    def update(self, sample: float) -> None:
        with self._lock:
            if not self._initialized:
                self._value = sample
                self._initialized = True
            else:
                self._value += self.alpha * (sample - self._value)

    def reset(self) -> None:
        """Forget the series: the next sample re-seeds the average."""
        with self._lock:
            self._value = 0.0
            self._initialized = False

    @property
    def initialized(self) -> bool:
        with self._lock:
            return self._initialized

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class MetricsRegistry:
    """Named counters for the stats APIs (the reference's registry,
    trimmed to counters)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, CounterMetric] = {}

    def counter(self, name: str) -> CounterMetric:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = CounterMetric()
            return c

    def snapshot(self) -> dict:
        with self._lock:
            items = sorted(self._counters.items())
        return {name: c.count for name, c in items}
