"""Hierarchical memory circuit breakers.

Counterpart of `elasticsearch_tpu/utils/breaker.py` (ref:
common/breaker/MemoryCircuitBreaker.java +
indices/breaker/HierarchyCircuitBreakerService.java:43-61):
estimate-based accounting that trips *before* an allocation runs out of
memory, with per-breaker limits (fielddata 60%, request 40%) under a
parent total (70%).

The scarce resource is the card's memory. The "fielddata" breaker
accounts device-resident columns (`search/executor.device_arrays`) and
pinned resident entries (`search/resident.py`); the "request" breaker
per-search transient buffers. Limits default to fractions of the card's
memory (`torch.cuda.mem_get_info`), overridable by settings.
"""

from __future__ import annotations

import threading

import torch

from .errors import CircuitBreakingError
from .settings import Settings

_DEFAULT_TOTAL = 16 * 1024 ** 3  # where no card is present


def _device_memory_bytes(device=None) -> int:
    """Total memory of the CUDA device `device` (the current one by
    default); the fallback constant where the device is the CPU or no
    card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return _DEFAULT_TOTAL
    return int(torch.cuda.mem_get_info(dev)[1])


class Hold:
    """One releasable breaker reservation: released at most once, from
    any exit path (`with breaker.hold(n):` for scoped transients, or kept
    and `release()`d for reservations that outlive the acquiring
    frame)."""

    __slots__ = ("_breaker", "_bytes", "_released")

    def __init__(self, breaker: "CircuitBreaker", nbytes: int):
        self._breaker = breaker
        self._bytes = nbytes
        self._released = False

    @property
    def bytes(self) -> int:
        return 0 if self._released else self._bytes

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._breaker.release(self._bytes)

    def __enter__(self) -> "Hold":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class CircuitBreaker:
    """One named breaker: add estimates, trip past the limit (ref:
    MemoryCircuitBreaker.addEstimateBytesAndMaybeBreak)."""

    def __init__(self, name: str, limit: int, overhead: float = 1.0,
                 parent: "HierarchyCircuitBreakerService | None" = None):
        self.name = name
        self.limit = limit
        self.overhead = overhead
        self._used = 0
        self._trips = 0
        self._lock = threading.Lock()
        self._parent = parent

    def add_estimate(self, bytes_wanted: int) -> int:
        with self._lock:
            new_used = self._used + bytes_wanted
            if self.limit > 0 and new_used * self.overhead > self.limit:
                self._trips += 1
                raise CircuitBreakingError(
                    self.name, int(new_used * self.overhead), self.limit)
            self._used = new_used
        if self._parent is not None:
            try:
                self._parent.check_parent()
            except CircuitBreakingError:
                with self._lock:
                    # a concurrent release() may already have clamped
                    # _used to 0: clamp again rather than go negative
                    self._used = max(0, self._used - bytes_wanted)
                raise
        return self._used

    def hold(self, bytes_wanted: int) -> Hold:
        """add_estimate + a Hold owning the release (raises
        CircuitBreakingError like add_estimate, holding nothing)."""
        self.add_estimate(bytes_wanted)
        return Hold(self, bytes_wanted)

    def release(self, bytes_freed: int) -> None:
        with self._lock:
            self._used = max(0, self._used - bytes_freed)

    @property
    def used(self) -> int:
        return self._used

    @property
    def trips(self) -> int:
        return self._trips

    def stats(self) -> dict:
        return {
            "limit_size_in_bytes": self.limit,
            "estimated_size_in_bytes": self._used,
            "overhead": self.overhead,
            "tripped": self._trips,
        }


class HierarchyCircuitBreakerService:
    """Child breakers (fielddata / request) under a parent total limit.
    Settings, fractions of the card's memory:
      indices.breaker.total.limit     default 70%
      indices.breaker.fielddata.limit default 60%
      indices.breaker.request.limit   default 40%
    `indices.breaker.total.memory` overrides the probed total."""

    def __init__(self, settings: Settings = Settings.EMPTY,
                 total_memory: int | None = None, device=None):
        total_memory = total_memory or settings.get_bytes(
            "indices.breaker.total.memory", None) or _device_memory_bytes(
                device)
        self.total_memory = total_memory
        self.parent_limit = int(total_memory * settings.get_ratio(
            "indices.breaker.total.limit", 0.70))
        self._breakers: dict[str, CircuitBreaker] = {}
        self._parent_trips = 0
        self.register("fielddata", int(total_memory * settings.get_ratio(
            "indices.breaker.fielddata.limit", 0.60)), overhead=1.03)
        self.register("request", int(total_memory * settings.get_ratio(
            "indices.breaker.request.limit", 0.40)), overhead=1.0)

    def register(self, name: str, limit: int,
                 overhead: float = 1.0) -> CircuitBreaker:
        b = CircuitBreaker(name, limit, overhead, parent=self)
        self._breakers[name] = b
        return b

    def breaker(self, name: str) -> CircuitBreaker:
        return self._breakers[name]

    def check_parent(self) -> None:
        total = sum(b.used for b in self._breakers.values())
        if total > self.parent_limit:
            self._parent_trips += 1
            raise CircuitBreakingError("parent", total, self.parent_limit)

    def stats(self) -> dict:
        """Per-breaker limit / estimate / trips plus the parent budget."""
        out = {name: b.stats() for name, b in self._breakers.items()}
        out["parent"] = {
            "limit_size_in_bytes": self.parent_limit,
            "estimated_size_in_bytes": sum(
                b.used for b in self._breakers.values()),
            "overhead": 1.0,
            "tripped": self._parent_trips,
        }
        return out


_default_service: HierarchyCircuitBreakerService | None = None
_default_lock = threading.Lock()


def breaker_service(settings: Settings | None = None, device=None
                    ) -> HierarchyCircuitBreakerService:
    """Process-wide breaker service guarding the card's memory: ONE
    service per process, since in-process nodes share the card. The first
    caller's settings and device configure the limits (Node passes its
    own at construction); later callers get the existing service."""
    global _default_service
    with _default_lock:
        if _default_service is None:
            _default_service = HierarchyCircuitBreakerService(
                settings or Settings.EMPTY, device=device)
        return _default_service
