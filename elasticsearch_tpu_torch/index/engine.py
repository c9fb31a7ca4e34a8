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

A store (`path`: translog, recovery, `flush`'s commit) and the device
build (`index.build.device`) raise NotImplementedError.
"""

from __future__ import annotations

import itertools
import os
import threading
import time

import numpy as np
import torch

from .. import resolve_device
from ..parallel.repack import run_build_aside
from ..search import resident
from ..search.shard_searcher import ShardReader
from ..utils.errors import (DocumentMissingError, IllegalArgumentError,
                            ShardNotFoundError, VersionConflictError)
from ..utils.settings import Settings
from .mapping import MapperService
from .segment import (Segment, SegmentBuilder, concat_segments,
                      merge_segments, pad_delta_shapes)

_TRUE = ("1", "true", "on", "yes")


def delta_pack_default() -> bool:
    """Streaming delta-pack mode default (`ES_TPU_DELTA_PACK`); the
    per-index setting `index.streaming.delta` overrides. Opt-in: unset
    keeps the legacy append-a-segment-per-refresh engine."""
    return os.environ.get("ES_TPU_DELTA_PACK", "").lower() in _TRUE


_seg_counter = itertools.count(1)

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
        if path is not None:
            raise NotImplementedError(
                "Engine store (translog, recovery, flush commit) is not "
                "ported: path must be None")
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
        """Writes racing close surface as shard-not-found."""
        if self._engine_closed:
            raise ShardNotFoundError(self.index_name, self.shard_id)

    # -- write path (ref: InternalEngine.index :340) -----------------------
    def index(self, doc_id: str, source: dict | bytes | str,
              version: int | None = None,
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
            import hashlib
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
        self._delta_seg = None

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

    def flush(self) -> None:
        raise NotImplementedError(
            "Engine.flush (store commit + translog rotation) is not ported")

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
        with self._lock:
            self._engine_closed = True
            gen = self.base_generation() if self.segments else None
            seg_ids = [s.seg_id for s in self.segments]
        if self._delta_enabled and gen is not None:
            # delta entries carry no segment weakref: only an explicit
            # generation eviction reclaims them
            resident.evict_generation(f"delta({gen})")
            resident.evict_segments(seg_ids)
