"""Per-index service: settings + mapper + shard engines.

Counterpart of `elasticsearch_tpu/index/index_service.py` (ref: the
per-index injector of indices/IndicesService.java): MapperService, the
index's shard engines (documents routed by `cluster/routing.shard_id`,
so each lands on the same shard as in the reference), the operation
counters and the generation-keyed request cache. With a `data_path`,
shard s of index `name` keeps its store and translog under
`<data_path>/<name>/<s>/`, and the per-doc type / routing / timestamp
metadata is durable under `<data_path>/<name>/`: each change is appended
to `_types.log` as it is acked (one JSON line `[id, type, routing,
timestamp]`, null where unset; a torn last line is ignored on open), and flush and close write the whole map to
`_types.json` (the reference's file) and empty the log. The reference
rewrites `_types.json` on every write, which makes an ingest quadratic
in the index's docs (ROADMAP Queue 3). Percolation is not ported.
"""

from __future__ import annotations

import json
import os
import threading

from ..cluster.routing import shard_id as route_shard
from ..utils.errors import DocumentMissingError, ShardNotFoundError
from ..utils.settings import Settings
from .cache import ShardRequestCache
from .engine import Engine
from .mapping import MapperService
from .stats import IndexOpStats, timed
from .durability import write_before_ack


class IndexService:
    """`device` is passed to every shard engine (None means CUDA)."""

    def __init__(self, name: str, settings: Settings = Settings.EMPTY,
                 mapping: dict | None = None, data_path: str | None = None,
                 device=None):
        self.name = name
        self.settings = settings
        self.num_shards = settings.get_int("index.number_of_shards", 1)
        self.num_replicas = settings.get_int("index.number_of_replicas", 0)
        self.mappers = MapperService(settings, mapping)
        self.data_path = data_path
        self.shards: dict[int, Engine] = {}
        for s in range(self.num_shards):
            path = None
            if data_path:
                path = os.path.join(data_path, name, str(s))
                os.makedirs(path, exist_ok=True)
            self.shards[s] = Engine(name, s, self.mappers, path=path,
                                    settings=settings, device=device)
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
        self._meta_lock = threading.Lock()
        self._types_path = (os.path.join(data_path, name, "_types.json")
                            if data_path else None)
        self._types_log_path = (os.path.join(data_path, name, "_types.log")
                                if data_path else None)
        self._types_log = None
        # lines not yet written (a bulk's, until it ends)
        self._meta_pending: list[str] = []
        if self._types_path:
            self._load_types()
            self._types_log = open(self._types_log_path, "a")

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
            meta_dirty = False
            if timestamp_ms is not None:
                meta_dirty |= self.doc_ts.get(doc_id) != timestamp_ms
                self.doc_ts[doc_id] = timestamp_ms
            if doc_type and doc_type != "_doc":
                meta_dirty |= self.doc_types.get(doc_id) != doc_type
                self.doc_types[doc_id] = doc_type
            else:
                meta_dirty |= self.doc_types.pop(doc_id, None) is not None
            if routing is not None:
                meta_dirty |= self.doc_routing.get(doc_id) != str(routing)
                self.doc_routing[doc_id] = str(routing)
            else:
                meta_dirty |= self.doc_routing.pop(doc_id, None) is not None
            resp_type = self.doc_types.get(doc_id, "_doc")
            if meta_dirty:
                self._log_meta(doc_id)
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
                dirty = self.doc_types.pop(doc_id, None) is not None
                dirty |= self.doc_routing.pop(doc_id, None) is not None
                dirty |= self.doc_ts.pop(doc_id, None) is not None
                if dirty:
                    self._log_meta(doc_id)
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

    # -- per-doc metadata persistence -------------------------------------
    def _load_types(self) -> None:
        """`_types.json`, then the changes `_types.log` holds since."""
        if os.path.exists(self._types_path):
            with open(self._types_path) as f:
                meta = json.load(f)
            if "types" in meta or "routing" in meta or "parent" in meta:
                if meta.get("parent"):
                    raise NotImplementedError(
                        "_parent metadata is not ported")
                self.doc_types = meta.get("types", {})
                self.doc_routing = meta.get("routing", {})
                self.doc_ts = meta.get("ts", {})
            else:   # legacy flat {id: type} layout
                self.doc_types = meta
        if not os.path.exists(self._types_log_path):
            return
        with open(self._types_log_path) as f:
            for line in f:
                try:
                    did, typ, routing, ts = json.loads(line)
                except ValueError:
                    break   # a torn last line: the write never finished
                for field, value in ((self.doc_types, typ),
                                     (self.doc_routing, routing),
                                     (self.doc_ts, ts)):
                    if value is None:
                        field.pop(did, None)
                    else:
                        field[did] = value

    def _log_meta(self, doc_id: str) -> None:
        """Append one doc's metadata as it stands (all None: deleted);
        the translog made the doc durable, so its metadata is too."""
        if self._types_log is None:
            return
        line = json.dumps([doc_id, self.doc_types.get(doc_id),
                           self.doc_routing.get(doc_id),
                           self.doc_ts.get(doc_id)])
        with self._meta_lock:
            self._meta_pending.append(line + "\n")
        write_before_ack(self, self._write_types_log, first=True)

    def _write_types_log(self) -> None:
        with self._meta_lock:
            if self._types_log is not None and self._meta_pending:
                self._types_log.write("".join(self._meta_pending))
                self._meta_pending.clear()
                self._types_log.flush()

    def _save_types(self) -> None:
        """Write the whole map to `_types.json`, then empty the log (a
        crash between the two replays absolute states: idempotent)."""
        if self._types_path is None:
            return
        with self._meta_lock:
            snap = {"types": dict(self.doc_types),
                    "routing": dict(self.doc_routing),
                    "parent": {},
                    "ts": dict(self.doc_ts)}
            tmp = self._types_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(snap, f)
            os.replace(tmp, self._types_path)
            # the map holds the pending lines' changes
            self._meta_pending.clear()
            if self._types_log is not None:
                self._types_log.close()
                self._types_log = open(self._types_log_path, "w")

    # -- maintenance -------------------------------------------------------
    def refresh(self) -> None:
        with timed() as t:
            for eng in self.shards.values():
                eng.refresh()
        self.op_stats.on_refresh(t.ms)

    def flush(self) -> None:
        with timed() as t:
            for eng in self.shards.values():
                eng.flush()
            self._save_types()
        self.op_stats.on_flush(t.ms)

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
        self._save_types()
        if self._types_log is not None:
            self._types_log.close()
            self._types_log = None
