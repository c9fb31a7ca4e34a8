"""Per-index operation counters backing the `_stats` API.

Counterpart of `elasticsearch_tpu/index/stats.py` (host code), trimmed
to the counters the engine and the node bump: indexing, get, search,
pack builds, refresh and merge (ref: CommonStats.java, with per-type
indexing and per-group search counters). Counters live at the
index-service level, not per shard, as in the reference.
"""

from __future__ import annotations

import threading
import time


class _Counter:
    __slots__ = ("total", "time_ms")

    def __init__(self) -> None:
        self.total = 0
        self.time_ms = 0

    def inc(self, took_ms: float = 0.0) -> None:
        self.total += 1
        self.time_ms += int(took_ms)


class IndexOpStats:
    """Operation counters for one index."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # indexing (ref: ShardIndexingService.StatsHolder)
        self.index_total = 0
        self.index_time_ms = 0
        self.delete_total = 0
        self.delete_time_ms = 0
        self.noop_update_total = 0
        self.types: dict[str, _Counter] = {}       # per-type index counters
        # get (ref: index/get/ShardGetService stats)
        self.get_total = 0
        self.get_time_ms = 0
        self.get_exists = 0
        self.get_missing = 0
        # search (ref: index/search/stats/ShardSearchService)
        self.query_total = 0
        self.query_time_ms = 0
        self.fetch_total = 0
        self.fetch_time_ms = 0
        self.groups: dict[str, _Counter] = {}      # per-stats-group counters
        # pack build (refresh rebuilds + compaction folds): wall-time
        # and docs, where indexing time goes
        self.build_total = 0
        self.build_time_ms = 0
        self.build_docs = 0
        # maintenance
        self.refresh_total = 0
        self.refresh_time_ms = 0
        self.merge_total = 0
        self.merge_time_ms = 0

    # -- record sites ------------------------------------------------------
    def on_index(self, doc_type: str | None, took_ms: float = 0.0) -> None:
        with self._lock:
            self.index_total += 1
            self.index_time_ms += int(took_ms)
            t = self.types.setdefault(doc_type or "_doc", _Counter())
            t.inc(took_ms)

    def on_delete(self, took_ms: float = 0.0) -> None:
        with self._lock:
            self.delete_total += 1
            self.delete_time_ms += int(took_ms)

    def on_noop_update(self) -> None:
        with self._lock:
            self.noop_update_total += 1

    def on_get(self, found: bool, took_ms: float = 0.0) -> None:
        with self._lock:
            self.get_total += 1
            self.get_time_ms += int(took_ms)
            if found:
                self.get_exists += 1
            else:
                self.get_missing += 1

    def on_search(self, groups: list[str] | None = None,
                  took_ms: float = 0.0) -> None:
        with self._lock:
            self.query_total += 1
            self.query_time_ms += int(took_ms)
            for g in groups or ():
                self.groups.setdefault(str(g), _Counter()).inc(took_ms)

    def on_fetch(self, took_ms: float = 0.0) -> None:
        with self._lock:
            self.fetch_total += 1
            self.fetch_time_ms += int(took_ms)

    def on_build(self, took_ms: float = 0.0, docs: int = 0) -> None:
        with self._lock:
            self.build_total += 1
            self.build_time_ms += int(took_ms)
            self.build_docs += int(docs)

    def on_refresh(self, took_ms: float = 0.0) -> None:
        with self._lock:
            self.refresh_total += 1
            self.refresh_time_ms += int(took_ms)

    def on_merge(self, took_ms: float = 0.0) -> None:
        with self._lock:
            self.merge_total += 1
            self.merge_time_ms += int(took_ms)


class timed:
    """`with timed() as t: ...; stats.on_x(t.ms)` helper."""

    def __enter__(self) -> "timed":
        self._t0 = time.monotonic()
        self.ms = 0.0
        return self

    def __exit__(self, *exc) -> None:
        self.ms = (time.monotonic() - self._t0) * 1000.0
