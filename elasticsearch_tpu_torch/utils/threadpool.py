"""Named thread pools with stats.

Counterpart of `elasticsearch_tpu/utils/threadpool.py` (host code).
Reference analog: threadpool/ThreadPool.java:65-127 — 15 named pools
isolating task classes (search, index, bulk, get, refresh, flush,
management, snapshot, ...) with fixed/scaling policies and bounded
queues.

Device proportions: the card executes search/aggregation work as
single batched programs, so the huge search/bulk pools of the reference
collapse; what remains host-side is IO-ish work (refresh builds, merges,
snapshot uploads, management requests). Pools keep the reference's names
and bounded-queue semantics so the _nodes/stats/thread_pool and
_cat/thread_pool surfaces stay meaningful.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor

from .errors import ElasticsearchTpuError


class EsRejectedExecutionError(ElasticsearchTpuError):
    status = 429


class NamedPool:
    def __init__(self, name: str, size: int, queue_size: int = -1):
        self.name = name
        self.size = size
        self.queue_size = queue_size
        self._exec = ThreadPoolExecutor(max_workers=size,
                                        thread_name_prefix=f"pool-{name}")
        self._lock = threading.Lock()
        self.active = 0
        self.completed = 0
        self.rejected = 0
        self.largest = 0

    def submit(self, fn, *args, **kwargs) -> Future:
        with self._lock:
            queued = self.active - self.size
            if 0 <= self.queue_size <= queued:
                self.rejected += 1
                raise EsRejectedExecutionError(
                    f"rejected execution on thread pool [{self.name}] "
                    f"(queue capacity {self.queue_size})")
            self.active += 1
            self.largest = max(self.largest, self.active)

        def run():
            try:
                return fn(*args, **kwargs)
            finally:
                with self._lock:
                    self.active -= 1
                    self.completed += 1

        return self._exec.submit(run)

    def stats(self) -> dict:
        with self._lock:
            return {"threads": self.size, "queue": max(
                        self.active - self.size, 0),
                    "active": min(self.active, self.size),
                    "rejected": self.rejected,
                    "largest": self.largest,
                    "completed": self.completed}

    def shutdown(self) -> None:
        self._exec.shutdown(wait=False, cancel_futures=True)


class ThreadPoolService:
    """Ref: ThreadPool.java defaults (:112-127), adapted to the device
    execution model (see module docstring)."""

    DEFAULTS = (
        # name, size(threads), bounded queue (-1 = unbounded)
        ("generic", 4, -1),
        ("management", 2, -1),
        ("search", 4, 1000),     # host-side fan-out/merge only
        ("index", 2, 200),
        ("bulk", 2, 50),
        ("get", 2, 1000),
        ("refresh", 1, -1),
        ("flush", 1, -1),
        ("merge", 1, -1),        # ref: optimize pool
        ("snapshot", 1, -1),
        ("warmer", 1, -1),
        ("listener", 1, -1),
    )

    def __init__(self, overrides: dict | None = None):
        self.pools: dict[str, NamedPool] = {}
        for name, size, q in self.DEFAULTS:
            conf = (overrides or {}).get(name, {})
            self.pools[name] = NamedPool(
                name, int(conf.get("size", size)),
                int(conf.get("queue_size", q)))

    def executor(self, name: str) -> NamedPool:
        pool = self.pools.get(name)
        if pool is None:
            raise KeyError(f"no thread pool named [{name}]")
        return pool

    def stats(self) -> dict:
        return {name: p.stats() for name, p in sorted(self.pools.items())}

    def shutdown(self) -> None:
        for p in self.pools.values():
            p.shutdown()
