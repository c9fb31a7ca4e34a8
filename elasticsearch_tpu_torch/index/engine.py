"""Per-shard engine: indexing buffer, versioning, refresh, delta packs,
compaction, merging and searcher publication.

Counterpart of `elasticsearch_tpu/index/engine.py` (ref:
index/engine/InternalEngine.java), trimmed to its in-memory search and
delta half:

  * `index` / `delete` / `get` with the live version map and tombstone
    GC (LiveVersionMap);
  * `refresh`, in the legacy segment-per-refresh mode or the streaming
    delta mode (`index.streaming.delta`, `ES_TPU_DELTA_PACK`): one
    immutable base generation plus one delta segment rebuilt per refresh
    from the docs written since the last compaction;
  * compaction of the delta into a new base once it outgrows
    max(`index.delta.min_compact_docs`, `index.delta.compact_ratio` x
    base docs), build-aside while the old generation serves
    (`parallel/repack.run_build_aside`), through the impact-preserving
    `segment.concat_segments`, so responses before and after the swap
    are identical;
  * merging (sync and async scheduler) and `force_merge`;
  * `acquire_searcher`: the port's `ShardReader` over the last refresh,
    on the engine's device.

  * the store half (`path`): translog appends in `index` / `delete`
    (`index.translog.durability`, `request` by default), `flush` (the
    commit of changed live masks only, the translog generation it
    covers, cleanup, then sync and rotate), recovery from the newest
    lossless commit plus translog replay (`_salvage_commit` /
    `_recover`; a recovered delta stays the delta),
    `index.shard.check_on_startup`, and containment: a corruption that
    salvage cannot prove lossless fails the shard (`ShardFailedError`,
    503) and drops its segments and their fielddata holds, while the
    node serves its other shards.

The device build (`index.build.device`) raises NotImplementedError;
replication (`apply_replicated`, `snapshot_docs`) and peer recovery are
cluster code and are not ported.
"""

from __future__ import annotations

import hashlib
import itertools
import os
import threading
import time

import numpy as np
import torch

from .. import resolve_device
from ..parallel.repack import run_build_aside
from ..search import resident
from ..search.executor import release_device_arrays
from ..search.shard_searcher import ShardReader
from ..utils.errors import (DocumentMissingError, IllegalArgumentError,
                            ShardFailedError, ShardNotFoundError,
                            VersionConflictError)
from ..utils.settings import Settings
from . import durability
from .mapping import MapperService
from .segment import (Segment, SegmentBuilder, concat_segments,
                      merge_segments, pad_delta_shapes)
from .store import CorruptIndexError, Store
from .translog import (OP_DELETE, OP_INDEX, Translog,
                       TranslogCorruptedError, TranslogOp)

_TRUE = ("1", "true", "on", "yes")


def delta_pack_default() -> bool:
    """Streaming delta-pack mode default (`ES_TPU_DELTA_PACK`); the
    per-index setting `index.streaming.delta` overrides. Opt-in: unset
    keeps the legacy append-a-segment-per-refresh engine."""
    return os.environ.get("ES_TPU_DELTA_PACK", "").lower() in _TRUE


_seg_counter = itertools.count(1)
_seg_counter_mx = threading.Lock()


def _ensure_seg_counter_above(n: int) -> None:
    """Advance the process-wide segment-id counter past `n`. Recovery
    calls this with the highest recovered sid ordinal: a restarted
    process would otherwise count from 1 again, and a new segment would
    collide with a committed one's seg_id (the live-mask dict and the
    commit's file map are sid-keyed)."""
    global _seg_counter
    with _seg_counter_mx:
        cur = next(_seg_counter)
        _seg_counter = itertools.count(max(cur, n + 1))

_MERGE_POOL = None
_MERGE_POOL_LOCK = threading.Lock()


def _merge_pool(settings: Settings):
    """Process-wide merge executor; the first engine's
    index.merge.scheduler.max_thread_count wins."""
    global _MERGE_POOL
    with _MERGE_POOL_LOCK:
        if _MERGE_POOL is None:
            from concurrent.futures import ThreadPoolExecutor
            _MERGE_POOL = ThreadPoolExecutor(
                max_workers=settings.get_int(
                    "index.merge.scheduler.max_thread_count", 2),
                thread_name_prefix="merge")
        return _MERGE_POOL


_VERSION_TYPES = ("internal", "external", "external_gte", "external_gt",
                  "force")


def _validate_version_type(version: int | None, version_type: str) -> None:
    """Reject malformed version args up front (HTTP 400) whether or not
    the target doc exists."""
    if version_type not in _VERSION_TYPES:
        raise IllegalArgumentError(
            f"version type [{version_type}] is not supported")
    if version is None and version_type != "internal":
        raise IllegalArgumentError(
            f"version type [{version_type}] requires an explicit version")


class Engine:
    """One shard's write path + searcher publication. `device=None`
    means CUDA and raises without it; tests pass `device="cpu"`."""

    def __init__(self, index_name: str, shard_id: int, mapper: MapperService,
                 path: str | None = None, settings: Settings = Settings.EMPTY,
                 device=None):
        if settings.get_bool("index.build.device", False) \
                or os.environ.get("ES_TPU_DEVICE_BUILD", "").strip().lower() \
                in _TRUE:
            raise NotImplementedError(
                "index.build.device (devbuild) is not ported")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.index_name = index_name
        self.shard_id = shard_id
        self.mappers = mapper
        self.settings = settings
        self._lock = threading.RLock()
        self.max_segments = settings.get_int("index.merge.max_segment_count",
                                             8)
        # IndexService points this at its IndexOpStats
        self.op_stats = None
        self._sim_for = mapper.similarity_for
        self.segments: list[Segment] = []
        self.live: dict[str, np.ndarray] = {}
        self.buffer = SegmentBuilder(similarity=self._sim_for)
        self._buffer_docs: dict[str, tuple[int, bytes]] = {}
        # live version map: ids written since the last refresh plus
        # recent tombstones; refreshed docs' versions load from segments
        self.versions: dict[str, tuple[int, bool]] = {}
        self._tombstone_ts: dict[str, float] = {}
        self._gc_deletes_s = settings.get_time("index.gc_deletes", 60.0)
        # streaming write path: one base generation + one delta segment
        self._delta_enabled = settings.get_bool("index.streaming.delta",
                                                delta_pack_default())
        self._delta_docs: dict[str, tuple] = {}   # id -> (parsed, version)
        self._delta_seg: Segment | None = None
        self._delta_epoch = 0
        self._base_gen: str | None = None
        self._compactions = 0
        self._compact_inflight = False
        self._compact_min = settings.get_int(
            "index.delta.min_compact_docs", 4096)
        self._compact_ratio = settings.get_float(
            "index.delta.compact_ratio", 0.5)
        self._reader: ShardReader | None = None
        # point-in-time view frozen at the last refresh: searches and
        # non-realtime gets read this, not the live bitmaps
        self._view_segments: list[Segment] = []
        self._view_live: dict[str, np.ndarray] = {}
        self._dirty = True
        self._engine_closed = False
        self._merge_inflight = False
        self._commit_gen = 0
        # contained-shard state: `failed` carries the structured reason;
        # every write / search then answers ShardFailedError (503)
        self.failed: dict | None = None
        self._durability = settings.get_str("index.translog.durability",
                                            "request")
        self._check_on_startup = settings.get_bool(
            "index.shard.check_on_startup", False)
        self.store = Store(path, index=index_name, shard=shard_id) \
            if path else None
        self.translog = None
        # seg_ids of the last durable commit: their files outlive
        # refresh / compaction until the next commit's cleanup
        self._committed_seg_ids: set[str] = set()
        # sid -> (write-once stem, live-mask hash) as of the last commit:
        # a flush re-saves a segment only when its live mask changed
        self._committed_files: dict[str, tuple[str, str]] = {}
        # what the last recovery did, by part (seconds, ops replayed)
        self.recovery_stats: dict = {}
        if self.store is not None:
            # recovery errors never escape __init__: what salvage cannot
            # prove lossless becomes a contained shard failure.
            # PowerLossError (an injected crash) is not caught: a crashed
            # process runs no handlers
            try:
                marker = self.store.corruption_marker()
                if marker is not None:
                    raise CorruptIndexError(
                        f"corruption marker present: {marker}")
                if self._check_on_startup:
                    t0 = time.monotonic()
                    report = self.store.verify_integrity()
                    self.recovery_stats["check_s"] = time.monotonic() - t0
                    if not report["clean"]:
                        raise CorruptIndexError(
                            "check_on_startup failed: "
                            f"{report['failures']}")
                self.translog = Translog(
                    f"{path}/translog", durability=self._durability,
                    index=index_name, shard=shard_id)
                self._recover()
            except (CorruptIndexError, TranslogCorruptedError,
                    OSError) as e:
                self._contain(e, during="recovery")

    # -- version map helpers ----------------------------------------------
    def _segment_version(self, doc_id: str) -> int | None:
        for seg in reversed(self.segments):
            d = seg.id_map.get(doc_id)
            if d is not None and self.live[seg.seg_id][d]:
                return int(seg.versions[d])
        return None

    def _current_version(self, doc_id: str) -> int | None:
        v = self.versions.get(doc_id)
        if v is not None:
            return None if v[1] else v[0]
        return self._segment_version(doc_id)

    def _check_open(self) -> None:
        """Writes racing close surface as shard-not-found; a contained
        shard answers 503."""
        if self._engine_closed:
            raise ShardNotFoundError(self.index_name, self.shard_id)
        self._check_failed()

    # -- write path (ref: InternalEngine.index :340) -----------------------
    def index(self, doc_id: str, source: dict | bytes | str,
              version: int | None = None, _replay: bool = False,
              version_type: str = "internal") -> dict:
        with self._lock:
            self._check_open()
            current = self._current_version(doc_id)
            new_version = self._resolve_write_version(
                doc_id, current, version, version_type)
            parsed = self.mappers.parse(doc_id, source)
            self._delete_everywhere(doc_id)
            self.buffer.add(parsed, version=new_version)
            self._buffer_docs[doc_id] = (new_version, parsed.source)
            if self._delta_enabled:
                # re-inserts land at the END (dict order), where a fresh
                # segment would have put the updated doc
                self._delta_docs[doc_id] = (parsed, new_version)
            self.versions[doc_id] = (new_version, False)
            self._tombstone_ts.pop(doc_id, None)
            if self.translog is not None and not _replay:
                self.translog.add(TranslogOp(OP_INDEX, doc_id, new_version,
                                             parsed.source))
            self._dirty = True
            return {"_id": doc_id, "_version": new_version,
                    "created": current is None}

    def _resolve_write_version(self, doc_id: str, current: int | None,
                               version: int | None,
                               version_type: str) -> int:
        """Version check + next version (ref: VersionType)."""
        _validate_version_type(version, version_type)
        if version is None or version_type == "internal":
            if version is not None and current is not None \
                    and current != version:
                raise VersionConflictError(self.index_name, doc_id,
                                           current, version)
            return (current or 0) + 1
        if version_type in ("external", "external_gt"):
            if current is not None and version <= current:
                raise VersionConflictError(self.index_name, doc_id,
                                           current, version)
        elif version_type == "external_gte":
            if current is not None and version < current:
                raise VersionConflictError(self.index_name, doc_id,
                                           current, version)
        return version

    def delete(self, doc_id: str, version: int | None = None,
               _replay: bool = False,
               version_type: str = "internal") -> dict:
        with self._lock:
            self._check_open()
            _validate_version_type(version, version_type)
            current = self._current_version(doc_id)
            if current is None:
                if version is not None and version_type == "internal":
                    raise VersionConflictError(self.index_name, doc_id, -1,
                                               version)
                return {"_id": doc_id, "found": False}
            new_version = self._resolve_write_version(
                doc_id, current, version, version_type)
            self._delete_everywhere(doc_id)
            self.versions[doc_id] = (new_version, True)
            self._tombstone_ts[doc_id] = time.monotonic()
            if self.translog is not None and not _replay:
                self.translog.add(TranslogOp(OP_DELETE, doc_id, new_version))
            self._dirty = True
            return {"_id": doc_id, "found": True, "_version": new_version}

    def _delete_everywhere(self, doc_id: str) -> None:
        """Mark any prior copy of doc_id dead (buffer or any segment)."""
        self._delta_docs.pop(doc_id, None)
        if doc_id in self._buffer_docs:
            old = self.buffer
            self.buffer = SegmentBuilder(similarity=self._sim_for)
            for doc, ver in zip(old.docs, old.versions):
                if doc.doc_id != doc_id:
                    self.buffer.add(doc, ver)
            del self._buffer_docs[doc_id]
        for seg in self.segments:
            d = seg.id_map.get(doc_id)
            if d is not None:
                self.live[seg.seg_id][d] = False

    # -- realtime get (ref: index/get/ShardGetService.java) ----------------
    def get(self, doc_id: str, realtime: bool = True) -> dict:
        with self._lock:
            self._check_failed()
            if realtime:
                v = self.versions.get(doc_id)
                if v is not None and v[1]:
                    raise DocumentMissingError(self.index_name, doc_id)
                buffered = self._buffer_docs.get(doc_id)
                if buffered is not None:
                    return {"_id": doc_id, "_version": buffered[0],
                            "found": True, "_source": buffered[1]}
            segs = self.segments if realtime else self._view_segments
            live = self.live if realtime else self._view_live
            for seg in segs:
                d = seg.id_map.get(doc_id)
                if d is not None and live[seg.seg_id][d]:
                    return {"_id": doc_id, "_version": int(seg.versions[d]),
                            "found": True, "_source": seg.sources[d]}
            raise DocumentMissingError(self.index_name, doc_id)

    # -- refresh (ref: InternalEngine.refresh :549) ------------------------
    def refresh(self) -> None:
        with self._lock:
            if self.failed is not None:
                return  # a contained shard has nothing to publish
            if not self._dirty:
                return
            if self._delta_enabled:
                self._refresh_delta()
            elif len(self.buffer):
                seg = self._build_segment(self.buffer)
                self.segments.append(seg)
                live = np.zeros(seg.capacity, dtype=bool)
                live[: seg.num_docs] = True
                self.live[seg.seg_id] = live
                self.buffer = SegmentBuilder(similarity=self._sim_for)
                self._buffer_docs = {}
                self._maybe_merge()
            self._prune_version_map()
            self._capture_view()
            self._reader = None
            self._dirty = False

    def _build_segment(self, builder: SegmentBuilder) -> Segment:
        seg_id = f"{self.shard_id}_{next(_seg_counter)}"
        t0 = time.monotonic()
        seg = builder.build(seg_id)
        if self.op_stats is not None:
            self.op_stats.on_build((time.monotonic() - t0) * 1000.0,
                                   seg.num_docs)
        return seg

    # -- streaming delta pack ----------------------------------------------
    def base_generation(self) -> str:
        """Generation key of the immutable base segment set, which delta
        cache keys ride on. Changes only at compaction / force-merge,
        never at refresh."""
        if self._base_gen is None:
            h = hashlib.blake2b(digest_size=8)
            for s in self.segments:
                if s is not self._delta_seg:
                    h.update(s.fingerprint().encode())
            self._base_gen = h.hexdigest()
        return self._base_gen

    def _refresh_delta(self) -> None:
        """Delta-mode refresh: rebuild the ONE delta segment from every
        doc written since the last compaction (caller holds the lock).
        An epoch bump, not an eviction; deletions of base docs stay
        live-mask flips on the untouched base."""
        if len(self.buffer):
            builder = SegmentBuilder(similarity=self._sim_for)
            for doc, ver in self._delta_docs.values():
                builder.add(doc, ver)
            seg = self._build_segment(builder)
            seg.delta_parent = self.base_generation()
            seg.delta_epoch = self._delta_epoch + 1
            pad_delta_shapes(seg)
            self._drop_delta_segment()
            if seg.num_docs:
                live = np.zeros(seg.capacity, dtype=bool)
                live[: seg.num_docs] = True
                self.segments.append(seg)
                self.live[seg.seg_id] = live
                self._delta_seg = seg
            self._delta_epoch += 1
            self.buffer = SegmentBuilder(similarity=self._sim_for)
            self._buffer_docs = {}
            self._maybe_compact()

    def _drop_delta_segment(self) -> None:
        old = self._delta_seg
        if old is None:
            return
        if old in self.segments:
            self.segments.remove(old)
        self.live.pop(old.seg_id, None)
        self._drop_uncommitted_files(old.seg_id)
        self._delta_seg = None

    def _drop_uncommitted_files(self, seg_id: str) -> None:
        """Delete a retired segment's store files unless the last commit
        lists it: a committed file outlives the segment until the next
        commit's cleanup, since the translog rotated at that commit."""
        if self.store is not None and seg_id not in self._committed_seg_ids:
            self.store.delete_segment(seg_id)

    def _maybe_compact(self) -> None:
        """Schedule (or, with the sync merge scheduler, run) compaction
        once the delta outgrows max(index.delta.min_compact_docs,
        index.delta.compact_ratio * base docs)."""
        d = self._delta_seg
        if d is None or self._compact_inflight:
            return
        base_docs = sum(s.num_docs for s in self.segments if s is not d)
        threshold = max(self._compact_min,
                        int(base_docs * self._compact_ratio))
        if d.num_docs <= threshold:
            return
        if self.settings.get_bool("index.merge.scheduler.async", False):
            self._compact_inflight = True
            _merge_pool(self.settings).submit(self._compact_guarded)
        else:
            self._compact_now()

    def _compact_guarded(self) -> None:
        try:
            self._compact_now()
        except Exception:
            import logging
            logging.getLogger(__name__).exception(
                "[%s][%d] background compaction failed",
                self.index_name, self.shard_id)
        finally:
            self._compact_inflight = False

    def compact(self) -> bool:
        """Explicit synchronous compaction."""
        with self._lock:
            if self._delta_seg is None:
                return False
        return self._compact_now()

    def _compact_now(self) -> bool:
        """Build-aside / keep-serving / atomic-swap compaction: the
        impact-preserving concat runs off the engine lock while the old
        generation serves; the swap re-validates under the lock (a
        refresh that replaced the delta mid-build aborts the fold),
        replays deletes that landed mid-build and publishes the new
        base. Responses before and after the swap are identical; only
        the generation-keyed caches re-key, and the replaced segments'
        fielddata holds are released when they are collected."""
        with self._lock:
            snapshot = list(self.segments)
            snap_live = {s.seg_id: self.live[s.seg_id].copy()
                         for s in snapshot}
            # exactly the delta entries this build folds (by identity): a
            # doc written during the off-lock build keeps its entry
            d = self._delta_seg
            folded = {did: e for did, e in self._delta_docs.items()
                      if d is not None and did in d.id_map}
        if not snapshot:
            return False
        seg_id = f"{self.shard_id}_{next(_seg_counter)}"

        def build():
            t0 = time.monotonic()
            merged = concat_segments(snapshot, seg_id, snap_live)
            if self.op_stats is not None:
                self.op_stats.on_build((time.monotonic() - t0) * 1000.0,
                                       merged.num_docs)
            return merged

        def swap(merged: Segment) -> bool:
            with self._lock:
                if self._engine_closed:
                    return False
                if len(self.segments) != len(snapshot) or any(
                        a is not b for a, b in zip(self.segments,
                                                   snapshot)):
                    return False  # a refresh won the race; retry later
                m_live = np.zeros(merged.capacity, dtype=bool)
                m_live[: merged.num_docs] = True
                for s in snapshot:
                    flipped = snap_live[s.seg_id] & ~self.live[s.seg_id]
                    for d in np.nonzero(flipped)[0]:
                        row = merged.id_map.get(s.ids[int(d)])
                        if row is not None:
                            m_live[row] = False
                old_gen = self.base_generation()
                for old in snapshot:
                    self.live.pop(old.seg_id, None)
                    self._drop_uncommitted_files(old.seg_id)
                self.segments = [merged]
                self.live[merged.seg_id] = m_live
                self._delta_seg = None
                for did, entry in folded.items():
                    if self._delta_docs.get(did) is entry:
                        del self._delta_docs[did]
                self._delta_epoch = 0
                self._base_gen = None
                self._compactions += 1
                self._capture_view()
                self._reader = None
            # the retired generation's residue: the only re-key event
            resident.evict_generation(f"delta({old_gen})")
            resident.evict_segments(s.seg_id for s in snapshot)
            return True

        return run_build_aside(f"compact-{self.index_name}", build, swap)

    def _prune_version_map(self) -> None:
        """Refresh-time map pruning: live entries are covered by a
        segment now; tombstones survive one index.gc_deletes window
        (monotonic clock)."""
        now = time.monotonic()
        keep: dict[str, tuple[int, bool]] = {}
        for did, v in self.versions.items():
            if not v[1]:
                continue
            ts = self._tombstone_ts.get(did, now)
            if now - ts <= self._gc_deletes_s:
                keep[did] = v
            else:
                self._tombstone_ts.pop(did, None)
        self.versions = keep

    def _capture_view(self) -> None:
        """Freeze the refresh-point snapshot searches and gets read."""
        self._view_segments = list(self.segments)
        self._view_live = {s.seg_id: self.live[s.seg_id].copy()
                           for s in self.segments}

    def invalidate_reader(self) -> None:
        """Drop the cached point-in-time reader without changing
        visibility (the next acquire rebuilds over the same view)."""
        with self._lock:
            self._reader = None

    def acquire_searcher(self) -> ShardReader:
        """NRT searcher over the last refresh (ref: acquireSearcher), on
        the engine's device. A refresh with an unchanged base publishes a
        new reader over the same base segment object, whose uploaded
        columns (cached on the segment) are reused."""
        with self._lock:
            self._check_failed()
            if self._reader is None:
                self._reader = ShardReader(
                    self.index_name, list(self._view_segments),
                    dict(self._view_live), self.mappers,
                    shard_id=self.shard_id, device=self.device)
            return self._reader

    # -- merge (ref: TieredMergePolicy + ConcurrentMergeScheduler) ---------
    def _maybe_merge(self) -> None:
        if self.settings.get_bool("index.merge.scheduler.async", False):
            self._schedule_background_merge()
            return
        while len(self.segments) > self.max_segments:
            i = self._pick_merge_pair()
            self._apply_merge(self.segments[i: i + 2],
                              self._merge_pair(self.segments[i: i + 2]))

    def _pick_merge_pair(self) -> int:
        """Index of the smallest adjacent pair (keeps doc order stable)."""
        sizes = [s.num_docs for s in self.segments]
        return int(np.argmin([sizes[j] + sizes[j + 1]
                              for j in range(len(sizes) - 1)]))

    def _merge_pair(self, pair: list[Segment]) -> Segment:
        return merge_segments(
            pair, seg_id=f"{self.shard_id}_{next(_seg_counter)}",
            live_masks=self.live, similarity=self._sim_for)

    def _apply_merge(self, pair: list[Segment], merged: Segment) -> None:
        """Swap `pair` -> `merged` in the segment list (caller holds the
        lock on the sync path; the async path re-validates)."""
        i = self.segments.index(pair[0])
        for old in pair:
            self.live.pop(old.seg_id, None)
            self._drop_uncommitted_files(old.seg_id)
        live = np.zeros(merged.capacity, dtype=bool)
        live[: merged.num_docs] = True
        self.segments[i: i + 2] = [merged]
        self.live[merged.seg_id] = live

    def _schedule_background_merge(self) -> None:
        """The merge runs off the engine lock on the shared merge pool;
        the swap re-validates under the lock and replays deletes that
        landed mid-merge. One merge in flight per engine."""
        if len(self.segments) <= self.max_segments or self._merge_inflight:
            return
        i = self._pick_merge_pair()
        pair = self.segments[i: i + 2]
        snapshot_live = {s.seg_id: self.live[s.seg_id].copy()
                         for s in pair}
        self._merge_inflight = True

        def run():
            ok = False
            try:
                merged = merge_segments(
                    pair, seg_id=f"{self.shard_id}_{next(_seg_counter)}",
                    live_masks=snapshot_live, similarity=self._sim_for)
                with self._lock:
                    if self._engine_closed:
                        return
                    if not all(s in self.segments for s in pair):
                        return  # sources vanished (force_merge / close)
                    m_live = np.zeros(merged.capacity, dtype=bool)
                    m_live[: merged.num_docs] = True
                    for s in pair:
                        flipped = snapshot_live[s.seg_id] \
                            & ~self.live[s.seg_id]
                        for d in np.nonzero(flipped)[0]:
                            row = merged.id_map.get(s.ids[int(d)])
                            if row is not None:
                                m_live[row] = False
                    self._apply_merge(pair, merged)
                    self.live[merged.seg_id] = m_live
                    self._dirty = True
                    ok = True
            except Exception:
                import logging
                logging.getLogger(__name__).exception(
                    "[%s][%d] background merge failed",
                    self.index_name, self.shard_id)
            finally:
                self._merge_inflight = False
                if ok:
                    with self._lock:
                        if not self._engine_closed \
                                and len(self.segments) > self.max_segments:
                            self._schedule_background_merge()

        _merge_pool(self.settings).submit(run)

    def force_merge(self, max_num_segments: int = 1) -> None:
        """Ref: InternalEngine.forceMerge :715 / _optimize API."""
        with self._lock:
            self.refresh()
            if len(self.segments) > max_num_segments:
                merged = merge_segments(
                    self.segments,
                    seg_id=f"{self.shard_id}_{next(_seg_counter)}",
                    live_masks=self.live, similarity=self._sim_for)
                old_gen = self.base_generation()
                old_segs = list(self.segments)
                for old in old_segs:
                    self._drop_uncommitted_files(old.seg_id)
                live = np.zeros(merged.capacity, dtype=bool)
                live[: merged.num_docs] = True
                self.segments = [merged]
                self.live = {merged.seg_id: live}
                # the merged segment IS the new base generation
                self._delta_seg = None
                self._delta_docs = {}
                self._delta_epoch = 0
                self._base_gen = None
                self._capture_view()
                self._reader = None
                resident.evict_generation(f"delta({old_gen})")
                resident.evict_segments(s.seg_id for s in old_segs)

    # -- flush = commit + translog rotation (ref: :574+) -------------------
    def flush(self) -> None:
        with self._lock:
            if self.failed is not None:
                return  # a contained shard has nothing durable to add
            self.refresh()
            if self.store is None:
                return
            try:
                stems: dict[str, str] = {}
                hashes: dict[str, str] = {}
                for seg in self.segments:
                    live = self.live[seg.seg_id]
                    h = hashlib.blake2b(live.tobytes(),
                                        digest_size=8).hexdigest()
                    hashes[seg.seg_id] = h
                    prev = self._committed_files.get(seg.seg_id)
                    if prev is not None and prev[1] == h:
                        # unchanged since the last commit: the
                        # write-once pair on disk stays authoritative
                        stems[seg.seg_id] = prev[0]
                    else:
                        stems[seg.seg_id] = self.store.save_segment(
                            seg, live, suffix=self._commit_gen + 1)
                self._commit_gen += 1
                # the commit records the exact stems plus the translog
                # generation active at commit time: every op acked after
                # it lands in generations >= it, so recovery can prove
                # whether a fallback to this commit is lossless
                self.store.write_commit(
                    self._commit_gen, [s.seg_id for s in self.segments],
                    extra={"files": stems,
                           "translog_gen": (self.translog.generation
                                            if self.translog is not None
                                            else 0)})
                self._committed_seg_ids = {s.seg_id for s in self.segments}
                self._committed_files = {
                    sid: (stems[sid], hashes[sid]) for sid in stems}
                self.store.cleanup_uncommitted(set(stems.values()))
                if self.translog is not None:
                    self.translog.sync()
                    self.translog.rotate()
            except OSError as e:
                # a flush that cannot make writes durable fails the shard;
                # PowerLossError is not an OSError and propagates
                self._contain(e, during="flush")
                raise ShardFailedError(self.index_name, self.shard_id,
                                       self.failed["reason"]) from e

    # -- recovery (ref: IndexShardGateway translog replay) -----------------
    def _salvage_commit(self) -> tuple[dict | None, list[tuple]]:
        """Pick the commit point recovery serves: walk generations newest
        to oldest, skipping torn / corrupt commit files and commits whose
        segments fail their checksums (each skip counted under
        `commits_fell_back`). A fallback is accepted only when the
        translog still covers every op acked since it (oldest on-disk
        translog generation <= recorded generation + 1); otherwise
        CorruptIndexError, and the shard is contained. Returns (commit,
        [(sid, segment, live), ...])."""
        gens = self.store.commit_generations()
        fell_back = False
        last_err: Exception | None = None
        for gen in gens:
            try:
                commit = self.store.read_commit(gen)
            except CorruptIndexError as e:
                durability.on_commit_fell_back()
                fell_back = True
                last_err = e
                continue
            if fell_back:
                tl_gen = commit.get("translog_gen")
                min_gen = (self.translog.min_generation()
                           if self.translog is not None else None)
                if tl_gen is None or min_gen is None \
                        or min_gen > int(tl_gen) + 1:
                    raise CorruptIndexError(
                        f"newest commit unusable ({last_err}) and the "
                        f"translog no longer covers commit [{gen}] "
                        "(rotated since) — refusing a fallback that "
                        "would silently lose acked writes")
            files = commit.get("files") or {}
            try:
                loaded = [(sid, *self.store.load_segment(
                              sid, stem=files.get(sid)))
                          for sid in commit["segments"]]
            except CorruptIndexError as e:
                durability.on_commit_fell_back()
                fell_back = True
                last_err = e
                continue
            # segment files no readable commit references are crash
            # residue; their docs re-enter through translog replay
            orphans = (self.store.seg_stems_on_disk()
                       - self.store.referenced_stems())
            durability.on_segments_salvaged(len(orphans))
            for stem in orphans:
                for path in self.store._stem_paths(stem):
                    try:
                        os.remove(path)
                    except OSError:
                        pass
            return commit, loaded
        if gens:
            raise CorruptIndexError(
                f"no usable commit point among generations {gens}: "
                f"{last_err}")
        return None, []

    def _recover(self) -> None:
        st = self.recovery_stats
        t0 = time.monotonic()
        layout0 = self.store.layout_seconds
        commit, loaded = self._salvage_commit()
        if commit:
            self._commit_gen = int(commit["generation"])
            self._committed_seg_ids = set(commit["segments"])
            tails = [sid.rsplit("_", 1)[-1] for sid in commit["segments"]]
            ordinals = [int(t) for t in tails if t.isdigit()]
            if ordinals:
                _ensure_seg_counter_above(max(ordinals))
            files = commit.get("files") or {}
            self._committed_files = {
                sid: (files.get(sid, f"seg_{sid}"),
                      hashlib.blake2b(live.tobytes(),
                                      digest_size=8).hexdigest())
                for sid, seg, live in loaded}
            for sid, seg, live in loaded:
                self.segments.append(seg)
                self.live[sid] = live
                for d in range(seg.num_docs):
                    if live[d]:
                        self.versions[seg.ids[d]] = (int(seg.versions[d]),
                                                     False)
                if self._delta_enabled and seg.delta_parent is not None:
                    # a recovered delta stays THE delta: its docs
                    # re-enter the rebuild set (re-parsed from source)
                    self._delta_seg = seg
                    self._delta_epoch = int(seg.delta_epoch)
                    for d in range(seg.num_docs):
                        # nested rows come back with their parent's parse
                        if live[d] and (seg.parent_of is None
                                        or seg.parent_of[d] < 0):
                            self._delta_docs[seg.ids[d]] = (
                                self.mappers.parse(seg.ids[d],
                                                   seg.sources[d]),
                                int(seg.versions[d]))
        t1 = time.monotonic()
        st["layout_s"] = self.store.layout_seconds - layout0
        st["load_s"] = (t1 - t0) - st["layout_s"]
        st["segments"] = len(loaded)
        n_ops = 0
        if self.translog is not None:
            for op in self.translog.snapshot():
                n_ops += 1
                if op.op == OP_INDEX:
                    self.index(op.doc_id, op.source, _replay=True)
                    self.versions[op.doc_id] = (op.version, False)
                    self._buffer_docs[op.doc_id] = (op.version, op.source)
                    self.buffer.versions[-1] = op.version
                    if op.doc_id in self._delta_docs:
                        # replays carry the persisted version, which must
                        # survive the next delta rebuild too
                        self._delta_docs[op.doc_id] = (
                            self._delta_docs[op.doc_id][0], op.version)
                elif op.op == OP_DELETE:
                    if self._current_version(op.doc_id) is not None:
                        self.delete(op.doc_id, _replay=True)
                    self.versions[op.doc_id] = (op.version, True)
        t2 = time.monotonic()
        st["replay_s"] = t2 - t1
        st["ops_replayed"] = n_ops
        # replayed ops become searchable
        self.refresh()
        st["refresh_s"] = time.monotonic() - t2

    # -- shard-level containment (ref: Store.markStoreCorrupted +
    # IndexShard.failShard: corruption fails the shard, never the node) ----
    def _contain(self, exc: BaseException, during: str) -> None:
        """Fail this shard: drop every in-memory structure (the data on
        disk stays) and its segments' device columns and fielddata
        holds, and answer ShardFailedError (503) from here on. The
        corruption marker is written only for verified corruption
        (checksum / crc); a transient OSError (EIO) fails the shard for
        this process without branding an intact store."""
        reason = f"{type(exc).__name__}: {exc}"
        marker = None
        if self.store is not None and isinstance(
                exc, (CorruptIndexError, TranslogCorruptedError)):
            try:
                marker = self.store.write_corruption_marker(reason)
            except OSError:
                pass
        self.failed = {"reason": reason, "during": during,
                       "marker": marker}
        self._release_segments()
        self.buffer = SegmentBuilder(similarity=self._sim_for)
        self._buffer_docs = {}
        self.versions = {}
        self._tombstone_ts = {}
        self._delta_docs = {}
        if self.translog is not None:
            self.translog.close()
            self.translog = None
        durability.on_shard_failed_corrupt()

    def _release_segments(self) -> None:
        """Forget every segment and view, and give back the device
        columns of those no older reader still serves."""
        segs = {id(s): s for s in self.segments + self._view_segments}
        self.segments = []
        self.live = {}
        self._delta_seg = None
        self._view_segments = []
        self._view_live = {}
        self._reader = None
        for seg in segs.values():
            release_device_arrays(seg)

    def fail_shard(self, reason: str, exc: BaseException | None = None,
                   during: str = "runtime") -> None:
        """Public containment entry (corruption detected outside
        recovery). Idempotent."""
        with self._lock:
            if self.failed is not None:
                return
            self._contain(exc or CorruptIndexError(reason), during)

    def _check_failed(self) -> None:
        if self.failed is not None:
            raise ShardFailedError(self.index_name, self.shard_id,
                                   self.failed["reason"])

    # -- stats / lifecycle -------------------------------------------------
    def doc_count(self) -> int:
        with self._lock:
            n = len(self.buffer)
            for seg in self.segments:
                n += int(self.live[seg.seg_id][: seg.num_docs].sum())
            return n

    def segment_stats(self) -> dict:
        with self._lock:
            out = {
                "count": len(self.segments),
                "docs": self.doc_count(),
                "memory_in_bytes": sum(s.nbytes() for s in self.segments),
                "buffered_docs": len(self.buffer),
            }
            if self.failed is not None:
                out["failed"] = dict(self.failed)
            if self._delta_enabled:
                d = self._delta_seg
                out["streaming"] = {
                    "base_generation": self.base_generation(),
                    "delta_epoch": self._delta_epoch,
                    "delta_docs": (d.num_docs if d is not None else 0),
                    "compactions": self._compactions,
                }
            return out

    def close(self) -> None:
        """Close without flushing (the translog holds what the last
        commit does not): the translog is closed and the segments, with
        their device columns and fielddata holds, are let go."""
        with self._lock:
            self._engine_closed = True
            if self.translog is not None:
                self.translog.close()
            gen = self.base_generation() if self.segments else None
            seg_ids = [s.seg_id for s in self.segments]
            self._release_segments()
        if self._delta_enabled and gen is not None:
            # delta entries carry no segment weakref: only an explicit
            # generation eviction reclaims them
            resident.evict_generation(f"delta({gen})")
            resident.evict_segments(seg_ids)
