"""Per-index service: settings + mapper + shard engines.

Counterpart of `elasticsearch_tpu/index/index_service.py` (ref: the
per-index injector of indices/IndicesService.java): MapperService, the
index's shard engines (documents routed by `cluster/routing.shard_id`,
so each lands on the same shard as in the reference), the operation
counters and the generation-keyed request cache. In-memory only: a data
path (store, `_types.json`) and percolation are not ported.
"""

from __future__ import annotations

import threading

from ..cluster.routing import shard_id as route_shard
from ..utils.errors import DocumentMissingError, ShardNotFoundError
from ..utils.settings import Settings
from .cache import ShardRequestCache
from .engine import Engine
from .mapping import MapperService
from .stats import IndexOpStats, timed


class IndexService:
    """`device` is passed to every shard engine (None means CUDA)."""

    def __init__(self, name: str, settings: Settings = Settings.EMPTY,
                 mapping: dict | None = None, data_path: str | None = None,
                 device=None):
        if data_path is not None:
            raise NotImplementedError(
                "IndexService data_path (store) is not ported")
        self.name = name
        self.settings = settings
        self.num_shards = settings.get_int("index.number_of_shards", 1)
        self.num_replicas = settings.get_int("index.number_of_replicas", 0)
        self.mappers = MapperService(settings, mapping)
        self.data_path = None
        self.shards: dict[int, Engine] = {
            s: Engine(name, s, self.mappers, settings=settings,
                      device=device)
            for s in range(self.num_shards)}
        # per-doc mapping type / routing / index timestamp (ref: the
        # _uid, _routing and _timestamp field mappers)
        self.doc_types: dict[str, str] = {}
        self.doc_routing: dict[str, str] = {}
        self.doc_ts: dict[str, int] = {}
        self.mapping_types: set[str] = set()
        self.op_stats = IndexOpStats()
        for eng in self.shards.values():
            eng.op_stats = self.op_stats
        # shard request cache, generation-keyed (index/cache.py)
        self.request_cache = ShardRequestCache(
            max_entries=self.settings.get_int(
                "index.cache.query.max_entries", 1024),
            max_bytes=self.settings.get_int(
                "index.cache.query.max_bytes", 64 * 1024 * 1024))
        # engine write + metadata update of ONE id are atomic; writes to
        # different ids stay parallel across shards
        self._id_locks = [threading.Lock() for _ in range(16)]

    def _id_lock(self, doc_id: str) -> threading.Lock:
        return self._id_locks[hash(doc_id) % len(self._id_locks)]

    def shard(self, sid: int) -> Engine:
        eng = self.shards.get(sid)
        if eng is None:
            raise ShardNotFoundError(self.name, sid)
        return eng

    def shard_for(self, doc_id: str, routing: str | None = None) -> Engine:
        return self.shard(route_shard(doc_id, self.num_shards, routing))

    # -- write path --------------------------------------------------------
    def index_doc(self, doc_id: str, source, version: int | None = None,
                  routing: str | None = None,
                  doc_type: str | None = None,
                  version_type: str = "internal",
                  timestamp_ms: int | None = None) -> dict:
        with self._id_lock(doc_id):
            r = self.shard_for(doc_id, routing).index(
                doc_id, source, version, version_type=version_type)
            if timestamp_ms is not None:
                self.doc_ts[doc_id] = timestamp_ms
            if doc_type and doc_type != "_doc":
                self.doc_types[doc_id] = doc_type
            else:
                self.doc_types.pop(doc_id, None)
            if routing is not None:
                self.doc_routing[doc_id] = str(routing)
            else:
                self.doc_routing.pop(doc_id, None)
            resp_type = self.doc_types.get(doc_id, "_doc")
        r.update({"_index": self.name,
                  "_type": resp_type,
                  "_shards": {"total": 1 + self.num_replicas,
                              "successful": 1, "failed": 0}})
        self.op_stats.on_index(doc_type)
        return r

    def _check_type(self, doc_id: str, doc_type: str | None) -> str:
        stored = self.doc_types.get(doc_id, "_doc")
        if doc_type not in (None, "_all", stored):
            raise DocumentMissingError(self.name, doc_id)
        return stored

    def delete_doc(self, doc_id: str, version: int | None = None,
                   routing: str | None = None,
                   doc_type: str | None = None,
                   version_type: str = "internal") -> dict:
        with self._id_lock(doc_id):
            stored = self._check_type(doc_id, doc_type)
            r = self.shard_for(doc_id, routing).delete(
                doc_id, version, version_type=version_type)
            # a routed doc deleted without routing hits the wrong shard
            # (found: false): its metadata survives
            if r.get("found"):
                self.doc_types.pop(doc_id, None)
                self.doc_routing.pop(doc_id, None)
                self.doc_ts.pop(doc_id, None)
        r["_index"] = self.name
        r["_type"] = stored
        r["_shards"] = {"total": 1 + self.num_replicas,
                        "successful": 1, "failed": 0}
        self.op_stats.on_delete()
        return r

    def get_doc(self, doc_id: str, routing: str | None = None,
                doc_type: str | None = None, realtime: bool = True) -> dict:
        try:
            stored = self._check_type(doc_id, doc_type)
            r = self.shard_for(doc_id, routing).get(doc_id,
                                                    realtime=realtime)
        except DocumentMissingError:
            self.op_stats.on_get(found=False)
            raise
        self.op_stats.on_get(found=bool(r.get("found", True)))
        r["_index"] = self.name
        r["_type"] = stored
        if doc_id in self.doc_routing:
            r["_routing"] = self.doc_routing[doc_id]
        return r

    def doc_type_of(self, doc_id: str) -> str:
        return self.doc_types.get(doc_id, "_doc")

    # -- maintenance -------------------------------------------------------
    def refresh(self) -> None:
        with timed() as t:
            for eng in self.shards.values():
                eng.refresh()
        self.op_stats.on_refresh(t.ms)

    def force_merge(self, max_num_segments: int = 1) -> None:
        with timed() as t:
            for eng in self.shards.values():
                eng.force_merge(max_num_segments)
        self.op_stats.on_merge(t.ms)

    def doc_count(self) -> int:
        return sum(e.doc_count() for e in self.shards.values())

    def stats(self) -> dict:
        seg = [e.segment_stats() for e in self.shards.values()]
        return {
            "docs": {"count": self.doc_count()},
            "segments": {"count": sum(s["count"] for s in seg),
                         "memory_in_bytes": sum(s["memory_in_bytes"]
                                                for s in seg)},
            "shards": {str(i): s for i, s in enumerate(seg)},
        }

    def close(self) -> None:
        for eng in self.shards.values():
            eng.close()
