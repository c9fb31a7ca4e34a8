"""Shard request (query-result) cache — generation-exact, device-skip.

Counterpart of `elasticsearch_tpu/index/cache.py` (host code). Reference
analog: indices/cache/query/IndicesQueryCache.java (the 1.x
ShardQueryCache): caches whole shard-level results keyed on the request
bytes, invalidated when the shard refreshes. Enabled per index via
`index.cache.query.enable` or per request via the `query_cache`
parameter; results containing date-math "now" are never cached.

Adaptation (the traffic control plane): entries
key on the reader's **generation key** — per segment,
`Segment.cache_key()` (content fingerprint for bases; `(base
generation, pow2 delta extent)` for streaming deltas) + the delta
epoch + a live-mask digest — plus the canonical request body. That
key is exact by construction:

  * a warm repeat of an identical query is a pure host-side dict copy:
    ZERO device dispatches, transfers, or compiles (the scheduler
    never sees a job);
  * a delta refresh (`ES_TPU_DELTA_PACK`) bumps the delta epoch — the
    new generation misses and re-executes (correct fresh results)
    while the cache itself is NOT flushed: other shards'/generations'
    entries and all stats survive, stale generations age out via LRU;
  * a compaction / force-merge re-keys the base fingerprint — exactly
    the invalidation signal, nothing else evicts;
  * deletes flip live masks, which changes the digest — a masked-out
    doc can never be served from cache.

Device-skip: with `index.cache.query.include_hits` (or request
`query_cache=true` on a sized request) the cache stores FULL top-k
responses, not just size=0 agg results — a hot dashboard query repays
its one device dispatch across every repeat. The cached value is the
shard response INCLUDING agg partials (numpy arrays); copies guard
both store and load against downstream mutation.

Caveat shared with every fingerprint-keyed cache (resident entries):
`Segment.fingerprint()` hashes the pack's shape-and-statistics
signature, not raw bytes.
"""

from __future__ import annotations

import copy
import json
import threading
import weakref
from collections import OrderedDict

import numpy as np


def canonical_key(body: dict) -> str:
    """Stable request identity (the reference hashes request bytes)."""
    return json.dumps(body, sort_keys=True, separators=(",", ":"),
                      default=str)


def _estimate_bytes(obj) -> int:
    if isinstance(obj, np.ndarray):
        return int(obj.nbytes) + 64
    if isinstance(obj, dict):
        return 64 + sum(_estimate_bytes(k) + _estimate_bytes(v)
                        for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return 32 + sum(_estimate_bytes(v) for v in obj)
    if isinstance(obj, (bytes, str)):
        return len(obj) + 40
    return 24


def _anchor(reader):
    """Generation anchor for a reader: the content-exact generation key
    when the reader provides one (ShardReader.generation_key), else a
    weakref to the object (unit-test stand-ins) — identity keying like
    the pre-generation cache, but reuse-proof: a dead reader's ref can
    never equal a new reader's, even at the same recycled address
    (a raw id() key could serve another reader's stale entries)."""
    gk = getattr(reader, "generation_key", None)
    if callable(gk):
        return gk()
    try:
        return weakref.ref(reader)
    except TypeError:
        return ("__obj__", id(reader))


class ShardRequestCache:
    """One index's request cache + its lifetime stats.

    Flat LRU over (generation anchor, request key): touching any entry
    refreshes it; stale generations stop being touched and fall off
    the cold end. Stats survive refreshes AND re-keys (ref:
    ShardRequestCache stats in CommonStats); nothing short of
    clear()/_cache API wipes entries wholesale."""

    def __init__(self, max_entries: int = 1024,
                 max_bytes: int = 64 * 1024 * 1024):
        self._lock = threading.Lock()
        # (anchor, key) -> (stored_response, nbytes)
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.max_entries = max_entries
        # byte cap (ref: indices.requests.cache.size): include_hits
        # entries carry full top-k payloads, so a count-only bound
        # could pin unbounded memory across stale generations
        self.max_bytes = max_bytes
        self._bytes = 0
        self.hit_count = 0
        self.miss_count = 0
        self.evictions = 0

    def get(self, reader, key: str):
        full_key = (_anchor(reader), key)
        with self._lock:
            hit = self._entries.get(full_key)
            if hit is None:
                self.miss_count += 1
                return None
            self._entries.move_to_end(full_key)
            self.hit_count += 1
            stored = hit[0]
        # deepcopy OUTSIDE the lock: agg partials can be large numpy
        # arrays and concurrent hits must not serialize on each other
        return copy.deepcopy(stored)

    def put(self, reader, key: str, response: dict) -> None:
        stored = copy.deepcopy(response)
        nbytes = len(key) + _estimate_bytes(stored)
        full_key = (_anchor(reader), key)
        with self._lock:
            old = self._entries.get(full_key)
            if old is not None:
                self._bytes -= old[1]
            self._entries[full_key] = (stored, nbytes)
            self._entries.move_to_end(full_key)
            self._bytes += nbytes
            while self._entries and (
                    len(self._entries) > self.max_entries
                    or self._bytes > self.max_bytes):
                _, (_v, nb) = self._entries.popitem(last=False)
                self._bytes -= nb
                self.evictions += 1

    def stats(self) -> dict:
        # one lock for the whole snapshot: counters move together under
        # _lock, so reading them piecemeal could tear (hits + misses
        # from different get() generations)
        with self._lock:
            return {"memory_size_in_bytes": self._bytes,
                    "evictions": self.evictions,
                    "hit_count": self.hit_count,
                    "miss_count": self.miss_count}


def cacheable(shard_body: dict, index_enabled: bool,
              include_hits: bool = False) -> bool:
    """Ref: IndicesQueryCache.canCache — request override wins, then
    the index enable flag. size=0 (agg/count) results always qualify
    once enabled; sized (top-k hits) results qualify only when the
    index opted into device-skip hit caching (`include_hits`) or the
    request itself said `query_cache=true` — the generation key makes
    them exactly as safe, but hit payloads are bigger, so the wider
    mode is opt-in. The body-serializing "now" scan runs only after
    the cheap gates, so cache-disabled indexes never pay it."""
    override = shard_body.get("query_cache",
                              shard_body.get("request_cache"))
    if override is False or str(override).lower() == "false":
        return False
    forced = override in (True, "true")
    if not forced and not index_enabled:
        return False
    if int(shard_body.get("size", 10)) != 0 \
            and not (include_hits or forced):
        return False
    if "_dfs_stats" in shard_body:
        return False  # global stats vary with the shard set
    key = canonical_key(shard_body)
    # per-request randomness: an unseeded random_score re-draws per
    # execution; conservatively refuse any random_score body
    if '"random_score"' in key:
        return False
    # date-math "now" resolves per execution: only VALUE strings that
    # are exactly "now" or start a date-math expression ("now-1d",
    # "now+1h", "now/d") block caching — not words like "nowhere"
    import re
    return not re.search(r':"now(["+\-/|]|\\)', key)
