"""Resident query loop: pinned per-plan dispatch state + staged feeds.

Counterpart of `elasticsearch_tpu/search/resident.py`. Per `(pack
fingerprint, plan signature, pow2 k-bucket, batch bucket)` the executor
resolves a fused plan once and pins here what eager PyTorch can pin:
the bundle layout, the chunk plan of the stepped walk, the output
layout, a pinned host buffer for the query-parameter feed and one for
the result fetch. Every later call is served with

  * the feed copied into the pinned buffer and uploaded with a
    non-blocking copy, which lands while earlier enqueued work runs
    (the feed stage);
  * the stepped K3 walk of the pinned chunk plan, with a host deadline
    check between chunk launches (the execute stage);
  * the result's device-to-host copy into the pinned fetch buffer,
    started at enqueue, with an event the collect waits on (the fetch
    stage).

The stepped walk checks the deadline per chunk (`executor._step_poll`),
which makes the collect-boundary timeout preemptive: a laggard walk
skips its remaining chunks and reports `timed_out`, which the collect
raises as SearchTimeoutError.

Residency is opt-in via ``ES_TPU_RESIDENT_LOOP`` (unset => every response
is the cold path's and all counters here read zero).
``ES_TPU_RESIDENT_MAX_ENTRIES`` caps the pinned-entry LRU. An entry's
pinned buffers are accounted against the fielddata breaker for the life
of the entry (`ResidentEntry.account`), as the reference does; `bytes`
reports them.
"""

from __future__ import annotations

import os
import threading
import weakref

from ..utils.metrics import CounterMetric, HighWaterMetric

_TRUE = ("1", "true", "on", "yes")

DEFAULT_MAX_ENTRIES = 32


def enabled() -> bool:
    """Residency is an explicit opt-in: with the env unset the read
    path never touches this module's caches or counters."""
    return os.environ.get("ES_TPU_RESIDENT_LOOP", "").lower() in _TRUE


def default_max_entries() -> int:
    try:
        return int(os.environ.get("ES_TPU_RESIDENT_MAX_ENTRIES",
                                  str(DEFAULT_MAX_ENTRIES)))
    except ValueError:
        return DEFAULT_MAX_ENTRIES


class ResidentStats:
    """Process-wide resident-loop counters."""

    def __init__(self):
        self.resident_hits = CounterMetric()
        self.cold_dispatches = CounterMetric()
        self.evictions = CounterMetric()
        self.preempted_by_deadline = CounterMetric()
        # streaming write path: entries a refresh REUSED across a
        # delta-epoch bump, and entries evicted because a compaction
        # re-keyed their generation
        self.refresh_reuses = CounterMetric()
        self.compaction_evictions = CounterMetric()
        # how long a staged param feed had to land on the device before
        # its walk was enqueued (ms, high-water)
        self.staged_feed_overlap_ms = HighWaterMetric()

    def snapshot(self, cache: "ResidentCache") -> dict:
        return {
            "resident_hits": self.resident_hits.count,
            "cold_dispatches": self.cold_dispatches.count,
            "evictions": self.evictions.count,
            "preempted_by_deadline": self.preempted_by_deadline.count,
            "refresh_reuses": self.refresh_reuses.count,
            "compaction_evictions": self.compaction_evictions.count,
            "staged_feed_overlap_ms": {
                "high_water": round(
                    float(self.staged_feed_overlap_ms.max), 3),
                "last": round(float(self.staged_feed_overlap_ms.last), 3),
            },
            **cache.snapshot(),
        }


class ResidentEntry:
    """One pinned plan: `plan` holds the executor's resolved dispatch
    state (chunk plan, output layout, pinned feed / fetch buffers);
    `nbytes` the pinned buffers' size, held against the fielddata
    breaker while the entry is cached."""

    __slots__ = ("key", "label", "plan", "seg_id", "fingerprint",
                 "seg_ref", "backend", "generation", "delta_epoch",
                 "nbytes", "hits", "_hold", "__weakref__")

    def __init__(self, key, label: str, plan, seg_id, fingerprint,
                 seg_ref, backend: str = "cuda",
                 generation: str | None = None, delta_epoch: int = 0):
        self.key = key
        self.label = label
        self.plan = plan
        self.seg_id = seg_id
        self.fingerprint = fingerprint
        self.seg_ref = seg_ref
        self.backend = backend
        # streaming write path: `generation` is the Segment.cache_key the
        # entry is pinned under ("delta(<base>):c<cap>" for delta entries,
        # no seg_ref, survives epoch bumps, evicted only by compaction);
        # `delta_epoch` is the LAST epoch served, advanced by
        # ResidentCache.get so refresh reuse is countable
        self.generation = generation if generation is not None \
            else fingerprint
        self.delta_epoch = delta_epoch
        self.nbytes = 0
        self.hits = 0
        self._hold = 0

    def account(self, nbytes: int) -> None:
        """Record the entry's residency bytes (known after its first
        dispatch) against the fielddata breaker; raises
        CircuitBreakingError when they do not fit."""
        if nbytes <= self._hold:
            return
        from ..utils.breaker import breaker_service
        breaker_service().breaker("fielddata").add_estimate(
            nbytes - self._hold)
        self._hold = nbytes
        self.nbytes = nbytes

    def release(self) -> None:
        if self._hold:
            from ..utils.breaker import breaker_service
            breaker_service().breaker("fielddata").release(self._hold)
            self._hold = 0


class ResidentCache:
    """LRU of pinned entries. Keys embed the pack FINGERPRINT, so a
    refresh/merge (which mints a new fingerprint) can never serve a stale
    plan; the stale entry itself is evicted by the dead-segment sweep
    (entries hold only a weakref to their segment) or by the LRU cap."""

    def __init__(self, max_entries: int | None = None):
        self._mx = threading.Lock()
        self._entries: dict = {}             # key -> entry, LRU order
        self.max_entries = max_entries or default_max_entries()

    def configure(self, max_entries: int) -> None:
        with self._mx:
            self.max_entries = max(1, int(max_entries))
            self._trim_locked()

    def get(self, key, delta_epoch: int | None = None
            ) -> ResidentEntry | None:
        with self._mx:
            e = self._entries.pop(key, None)
            if e is None:
                return None
            self._entries[key] = e            # LRU touch
            e.hits += 1
            stats.resident_hits.inc()
            if delta_epoch is not None and delta_epoch != e.delta_epoch:
                # the pinned plan survived a refresh's epoch bump and now
                # serves the NEW delta contents: the zero-eviction
                # refresh, made countable
                stats.refresh_reuses.inc()
                e.delta_epoch = delta_epoch
            return e

    def put(self, entry: ResidentEntry) -> None:
        with self._mx:
            self._sweep_locked()
            # a displaced duplicate (two threads resolving the same plan)
            # drops its breaker hold; the plan stays under the winner
            old = self._entries.pop(entry.key, None)
            if old is not None and old is not entry:
                old.release()
            self._entries[entry.key] = entry
            self._trim_locked()

    def evict(self, key) -> None:
        with self._mx:
            self._evict_locked(key)

    def _evict_locked(self, key) -> None:
        # drop the cache's reference only: a dispatch that looked the
        # entry up just before may still be using its buffers
        e = self._entries.pop(key, None)
        if e is not None:
            e.release()
            stats.evictions.inc()

    def _trim_locked(self) -> None:
        while len(self._entries) > self.max_entries:
            self._evict_locked(next(iter(self._entries)))

    def _sweep_locked(self) -> None:
        """Drop entries whose segment died (a refresh/merge replaced it):
        their fingerprint can never be keyed again."""
        dead = [k for k, e in self._entries.items()
                if e.seg_ref is not None and e.seg_ref() is None]
        for k in dead:
            self._evict_locked(k)

    def evict_segment(self, seg_id) -> None:
        """Explicit invalidation (the segment's device columns dropped)."""
        with self._mx:
            for k in [k for k, e in self._entries.items()
                      if e.seg_id == seg_id]:
                self._evict_locked(k)

    def evict_generation(self, gen_prefix: str) -> int:
        """Compaction re-key: drop every entry pinned under a generation
        key starting with `gen_prefix` (every capacity bucket of the
        folded delta: match on the "delta(<base>)" prefix). Returns how
        many entries were evicted; they also count in
        compaction_evictions."""
        with self._mx:
            dead = [k for k, e in self._entries.items()
                    if isinstance(e.generation, str)
                    and e.generation.startswith(gen_prefix)]
            for k in dead:
                self._evict_locked(k)
        if dead:
            stats.compaction_evictions.inc(len(dead))
        return len(dead)

    def clear(self) -> None:
        with self._mx:
            for k in list(self._entries):
                self._evict_locked(k)

    def snapshot(self) -> dict:
        with self._mx:
            entries = [{"plan": e.label, "fingerprint": e.fingerprint,
                        "backend": e.backend, "bytes": e.nbytes,
                        "hits": e.hits, "generation": e.generation,
                        "delta_epoch": e.delta_epoch}
                       for e in self._entries.values()]
            max_entries = self.max_entries
        return {"entries": entries,
                "entry_count": len(entries),
                "max_entries": max_entries,
                "residency_bytes": sum(e["bytes"] for e in entries)}


stats = ResidentStats()
cache = ResidentCache()


def configure(max_entries: int | None = None) -> None:
    """Startup hook (`search.resident.max_entries`). The cache is
    process-global: the last configuration wins."""
    if max_entries is not None:
        cache.configure(max_entries)


def evict_segment(seg_id) -> None:
    cache.evict_segment(seg_id)


def evict_generation(gen_prefix: str) -> int:
    """Compaction hook: retire every pinned entry of a folded delta
    generation. The only write-path event that evicts."""
    return cache.evict_generation(gen_prefix)


def evict_segments(seg_ids) -> None:
    """Batch invalidation for a retired pack's segments."""
    for sid in seg_ids:
        cache.evict_segment(sid)


def reset() -> None:
    """Test hook: drop every pinned entry, zero the counters, restore
    the default entry cap."""
    global stats
    cache.clear()
    cache.configure(default_max_entries())
    stats = ResidentStats()


def resident_stats() -> dict:
    """Snapshot of the counters and the pinned entries."""
    return stats.snapshot(cache)


def make_ref(segment) -> weakref.ref | None:
    try:
        return weakref.ref(segment)
    except TypeError:
        return None
