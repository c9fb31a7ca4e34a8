"""Node: the composition root tying indices, search fan-out and APIs.

Counterpart of `elasticsearch_tpu/node.py` (ref: node/Node.java), trimmed
to the write and search path: one Node owns the index registry, the
bounded host thread pools, the traffic controller and the dispatch
scheduler, and exposes index / get / delete / update / bulk, refresh,
force_merge, search / msearch / count, and the breakers and device blocks
of the node stats. The fan-out across the shards of one process is the
reference's QUERY_THEN_FETCH flow with the SearchPhaseController merge
(`search/controller.py`).

Device rule: `Node(settings, device=None)` serves on CUDA and raises
without it; `device="cpu"` serves on the CPU (the tests). The device
reaches every IndexService -> Engine -> ShardReader.

Durability: with `path.data` the node takes the exclusive `node.lock`,
persists each index's metadata (`<path.data>/<index>/_meta.json`), loads
every index found there at boot (each shard recovering from its store
and translog), and `flush` commits; `close` persists the metadata and
closes the engines without flushing. A contained shard (corruption that
recovery could not salvage) answers writes with 503 and enters searches
as a structured `_shards.failures` entry (or fails the request when
`allow_partial_search_results` is false); `recovery_status`,
`verify_integrity` and the `durability` block of `nodes_stats` report
it.

Vectors: `dense_vector` fields take vector docs through `_bulk`; a
body's `knn` section and `rescore` reach every shard (`ShardReader`);
`index.ann.min_docs` / `nprobe` / `recall` configure the IVF probe
(`index/ann.configure`), and `nodes_stats` carries the fused engine's
counters (`fused_scoring`: top-level knn admission, IVF clusters).

Search types: `dfs_query_then_fetch` / `dfs_query_and_fetch` (global
term statistics summed over the shards, `_aggregate_dfs`), `scan`
(the query wrapped in `constant_score`, pages in doc order) and scroll
contexts over point-in-time readers (`scroll`, `clear_scroll`, reaped
at their keepalive).

Scripts: stored scripts (`put_stored_script`, the versioned lang-scoped
forms) persist to `<path.data>/scripts.json` in the reference's format,
so either package reads the other's; file scripts under `path.scripts`
(default `<path.data>/scripts`) load and hot-reload through the resource
watcher (`utils/watcher.py`); `update_doc` runs update scripts on
ctx._source (`_run_update_script`).

Joins: `parent` routes a write (index / get / update / delete) unless a
routing is given, and is kept as the doc's `_parent` metadata; an index
with a `_parent` (or `_routing: {required: true}`) mapping refuses doc
ops without routing or parent (RoutingMissingError); update `?fields=`
echoes `_parent`, `_routing`, `_timestamp` and source fields.

Not ported (NotImplementedError): suggest, significant-terms sub-aggs,
aliases, index templates, warmers, snapshots, percolation, TTL, the
autotuner store, hunspell dictionaries under `path.data`, and the rest
of the admin and stats APIs.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid

import torch

from . import resolve_device
from .index import ann as _ann
from .index import durability as _durability
from .index.index_service import IndexService
from .search.aggregations import parse_aggs
from .search.controller import (merge_shard_results, shard_failure,
                                shards_header)
from .search.dispatch import DispatchScheduler
from .search.executor import fused_scoring_stats
from .search.shard_searcher import ShardReader
from .search.traffic import controller_from_settings
from .utils import faults, monitor
from .utils.breaker import breaker_service
from .utils.errors import (ElasticsearchTpuError, IllegalArgumentError,
                           IndexAlreadyExistsError, IndexNotFoundError,
                           RoutingMissingError, SearchTimeoutError,
                           ShardFailedError,
                           TrafficRejectedError, VersionConflictError)
from .utils.metrics import MetricsRegistry
from .utils.settings import Settings, parse_time_value as _parse_time_value
from .utils.threadpool import ThreadPoolService


def parse_time_value(v, default_ms: int = 60_000) -> int:
    """'5m' / '30s' -> millis, with the API's error type."""
    try:
        return _parse_time_value(v, default_ms)
    except ValueError as e:
        raise IllegalArgumentError(str(e))


class Node:
    def __init__(self, settings: Settings | dict | None = None, device=None):
        self.settings = (settings if isinstance(settings, Settings)
                         else Settings(settings or {}))
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        # seed the process-wide breakers with this node's limits and its
        # device's memory (first constructor wins)
        breaker_service(self.settings, device=self.device)
        self.name = self.settings.get_str("node.name", "node-0")
        self.cluster_name = self.settings.get_str("cluster.name",
                                                  "elasticsearch-tpu")
        self.data_path = self.settings.get_str("path.data")
        self._node_lock_fh = None
        if self.data_path:
            os.makedirs(self.data_path, exist_ok=True)
            # exclusive node lock: two nodes never share a data dir
            # (ref: env/NodeEnvironment.java's node.lock)
            import fcntl
            fh = open(os.path.join(self.data_path, "node.lock"), "a+")
            try:
                fcntl.flock(fh, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                fh.close()
                raise IllegalArgumentError(
                    f"failed to obtain node lock on [{self.data_path}]: "
                    f"is another node using the same data path?")
            self._node_lock_fh = fh
        self.indices: dict[str, IndexService] = {}
        # scroll contexts: id -> {"readers", "body", "pos", "expires_at"}
        # (ref: SearchService.activeContexts + the keepalive reaper)
        self._scrolls: dict[str, dict] = {}
        self._scrolls_mx = threading.Lock()
        self.metrics = MetricsRegistry()
        self._started_at = time.time()
        # named host pools (ref: threadpool/ThreadPool.java)
        self.thread_pool = ThreadPoolService()
        # traffic control plane: per-tenant admission before any pool
        # slot or breaker hold, priority lanes, the adaptive window
        self.traffic = controller_from_settings(self.settings)
        # search dispatch scheduler: cross-request coalescing +
        # pipelined fan-out
        self._dispatch = DispatchScheduler(
            window_ms=float(self.settings.get_str(
                "search.dispatch.coalesce_window_ms", "0") or 0),
            traffic=self.traffic)
        from .search import resident as _resident
        max_entries = self.settings.get_int("search.resident.max_entries")
        if max_entries is not None:
            _resident.configure(max_entries=max_entries)
        # IVF vector search (index/ann.py): the exact-scan -> IVF
        # crossover, nprobe and declared recall. Process-global, like the
        # reference's; close() resets it only while it is this node's
        self._ann_cfg = None
        a_min = self.settings.get_int("index.ann.min_docs")
        a_nprobe = self.settings.get_int("index.ann.nprobe")
        a_recall = self.settings.get_float("index.ann.recall")
        if a_min is not None or a_nprobe is not None \
                or a_recall is not None:
            self._ann_cfg = _ann.configure(
                min_docs=a_min, nprobe=a_nprobe, recall=a_recall)
        # durability counters, installed before the indices load so
        # recovery-time salvage / containment events land in this node's
        # block; close() resets them only while they are still its own
        self._durability_stats = _durability.install_process_stats()
        # the storage fault registry this node installs (cleared on close
        # only while it is still the installed one)
        self._fault_registry = None
        fault_spec = self.settings.get_str("search.fault_injection")
        if fault_spec is not None:
            self._fault_registry = faults.configure(fault_spec)
        # resource watcher + file scripts (ref: ResourceWatcherService
        # watching config/scripts for ScriptService file reload)
        from .utils.watcher import ResourceWatcherService
        self.resource_watcher = ResourceWatcherService(self.settings)
        self._watch_file_scripts()
        if self.data_path:
            self._load_existing_indices()
            self._load_stored_scripts()

    def _watch_file_scripts(self) -> None:
        """File scripts: `<path.scripts>` (default <path.data>/scripts)
        loaded by name-minus-extension and hot-reloaded through the
        resource watcher (ref: ScriptService.java ScriptChangesListener
        on config/scripts)."""
        path = self.settings.get_str("path.scripts") or (
            os.path.join(self.data_path, "scripts")
            if self.data_path else None)
        if not path:
            return
        # register even when the dir does not exist yet: FileWatcher
        # tolerates a missing path, so a later-created dir starts
        # loading at the next poll instead of requiring a restart
        from .script import ScriptService
        from .utils.watcher import FileChangesListener, FileWatcher, HIGH

        svc = ScriptService.instance()

        # only extensions a script engine owns load (ref: ScriptService
        # registers per-engine extensions; editor backups etc. are
        # ignored rather than shadowing the real script)
        _EXTS = (".expression", ".painless", ".mustache", ".txt")

        class _Listener(FileChangesListener):
            def on_file_created(self, p):
                self._load(p)

            def on_file_changed(self, p):
                self._load(p)

            @staticmethod
            def on_file_deleted(p):
                # scripts key on the file STEM; another script extension
                # with the same stem may still provide the script —
                # reload from a survivor instead of dropping blindly
                if not p.endswith(_EXTS):
                    return
                name = os.path.splitext(os.path.basename(p))[0]
                d = os.path.dirname(p)
                try:
                    survivor = next(
                        (os.path.join(d, f) for f in sorted(os.listdir(d))
                         if os.path.splitext(f)[0] == name
                         and f.endswith(_EXTS)
                         and os.path.isfile(os.path.join(d, f))), None)
                except OSError:
                    survivor = None
                if survivor is not None:
                    _Listener._load(survivor)
                else:
                    svc.file_scripts.pop(name, None)

            @staticmethod
            def _load(p):
                if not p.endswith(_EXTS):
                    return
                name = os.path.splitext(os.path.basename(p))[0]
                try:
                    with open(p) as f:
                        svc.file_scripts[name] = f.read().strip()
                except OSError:
                    pass

        w = FileWatcher(path)
        w.add_listener(_Listener())
        self.resource_watcher.add(w, HIGH)
        self._script_watcher = w

    # -- stored scripts (ref: ScriptService indexed scripts in .scripts;
    # persisted here like gateway metadata) ----------------------------
    def _scripts_file(self) -> str:
        return os.path.join(self.data_path, "scripts.json")

    def _load_stored_scripts(self) -> None:
        from .script import ScriptService
        path = self._scripts_file()
        if os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
            svc = ScriptService.instance()
            if "sources" in data and isinstance(data["sources"], dict):
                svc.stored.update(data["sources"])
                svc.meta.update(data.get("meta", {}))
            else:  # pre-versioning flat format
                for sid, src in data.items():
                    svc.stored[sid] = src

    def put_stored_script(self, script_id: str, source: str) -> None:
        from .script import ScriptService
        ScriptService.instance().put_stored(script_id, source)
        self._persist_stored_scripts()

    def delete_stored_script(self, script_id: str) -> bool:
        from .script import ScriptService
        found = ScriptService.instance().delete_stored(script_id)
        self._persist_stored_scripts()
        return found

    def put_stored_script_versioned(self, script_id: str, source: str,
                                    lang: str, version: int | None = None,
                                    version_type: str = "internal"
                                    ) -> tuple[int, bool]:
        from .script import ScriptService
        v, created = ScriptService.instance().put_versioned(
            script_id, source, lang, version=version,
            version_type=version_type)
        self._persist_stored_scripts()
        return v, created

    def delete_stored_script_versioned(self, script_id: str,
                                       version: int | None = None,
                                       version_type: str = "internal"
                                       ) -> int | None:
        from .script import ScriptService
        v = ScriptService.instance().delete_versioned(
            script_id, version=version, version_type=version_type)
        self._persist_stored_scripts()
        return v

    def _persist_stored_scripts(self) -> None:
        if not self.data_path:
            return
        from .script import ScriptService
        svc = ScriptService.instance()
        tmp = self._scripts_file() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"sources": svc.stored, "meta": svc.meta}, f)
        os.replace(tmp, self._scripts_file())

    # -- index admin -------------------------------------------------------
    def create_index(self, name: str, settings: dict | None = None,
                     mappings: dict | None = None,
                     aliases: dict | None = None,
                     warmers: dict | None = None) -> dict:
        if aliases or warmers:
            raise NotImplementedError("aliases and warmers are not ported")
        if name in self.indices:
            raise IndexAlreadyExistsError(name)
        if not name or name != name.lower() or name.startswith(
                ("_", "-", "+")):
            raise IllegalArgumentError(f"invalid index name [{name}]")
        # bare index-level keys ("number_of_shards") normalize to the
        # canonical "index."-prefixed form
        flat = Settings(settings or {}).as_dict()
        settings = {k if k.startswith("index.") else f"index.{k}": v
                    for k, v in flat.items()}
        idx_settings = self.settings.merged_with(settings)
        mapping = None
        if mappings:
            if "properties" not in mappings:
                raise NotImplementedError(
                    "typed mappings ({type: {properties}}) are not ported")
            mapping = mappings
        svc = IndexService(name, idx_settings, mapping,
                           data_path=self.data_path, device=self.device)
        svc.meta_settings = settings
        self.indices[name] = svc
        if self.data_path:
            self._persist_index_meta(svc)
        return {"acknowledged": True, "index": name}

    def delete_index(self, name: str) -> dict:
        svc = self._index(name)
        svc.close()
        del self.indices[name]
        if self.data_path:
            shutil.rmtree(os.path.join(self.data_path, name),
                          ignore_errors=True)
        return {"acknowledged": True}

    # -- persistence of index metadata (gateway analog) --------------------
    def _persist_index_meta(self, svc: IndexService) -> None:
        """`<path.data>/<index>/_meta.json`: the index settings it was
        created with, its shard count and its mapping (dynamic fields
        included)."""
        meta = {"settings": {**getattr(svc, "meta_settings", {}),
                             "index.number_of_shards": svc.num_shards},
                "mappings": svc.mappers.mapping_dict(),
                "types": {}, "warmers": {}}
        path = os.path.join(self.data_path, svc.name, "_meta.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, path)

    def _load_existing_indices(self) -> None:
        """Boot: open every index whose metadata is under path.data; each
        shard recovers from its store and translog (a shard that cannot
        is contained, and the node boots all the same)."""
        for name in sorted(os.listdir(self.data_path)):
            meta_path = os.path.join(self.data_path, name, "_meta.json")
            if not os.path.exists(meta_path):
                continue
            with open(meta_path) as f:
                meta = json.load(f)
            if meta.get("types") or meta.get("warmers"):
                raise NotImplementedError(
                    f"index [{name}] has typed mappings or warmers, "
                    "which are not ported")
            settings = meta.get("settings") or {}
            svc = IndexService(name, self.settings.merged_with(settings),
                               meta.get("mappings"),
                               data_path=self.data_path, device=self.device)
            svc.meta_settings = settings
            self.indices[name] = svc

    def _index(self, name: str) -> IndexService:
        svc = self.indices.get(name)
        if svc is None:
            raise IndexNotFoundError(name)
        return svc

    def _resolve(self, names: str | None) -> list[IndexService]:
        """Index name resolution: _all, comma lists and wildcards (ref:
        IndexNameExpressionResolver; aliases are not ported)."""
        if names in (None, "_all", "*", ""):
            return list(self.indices.values())
        out, seen = [], set()
        for n in str(names).split(","):
            n = n.strip()
            if "*" in n:
                import fnmatch
                matched = [self.indices[k] for k in sorted(self.indices)
                           if fnmatch.fnmatch(k, n)]
            else:
                matched = [self._index(n)]
            for svc in matched:
                if svc.name not in seen:
                    seen.add(svc.name)
                    out.append(svc)
        return out

    def _ensure_index(self, name: str) -> IndexService:
        """Auto-create on first write (ref: TransportBulkAction)."""
        if name not in self.indices:
            if not self.settings.get_bool("action.auto_create_index", True):
                raise IndexNotFoundError(name)
            self.create_index(name)
        return self.indices[name]

    # -- document APIs -----------------------------------------------------
    def index_doc(self, index: str, doc_id: str | None, body,
                  version: int | None = None, routing: str | None = None,
                  refresh: bool = False, ttl: str | None = None,
                  doc_type: str | None = None,
                  version_type: str = "internal",
                  parent: str | None = None,
                  timestamp: str | None = None) -> dict:
        if ttl is not None:
            raise NotImplementedError("_ttl is not ported")
        svc = self._ensure_index(index)
        if doc_id is None:
            import uuid
            doc_id = uuid.uuid4().hex[:20]
        self._check_routing_required(svc, doc_id, routing, parent)
        # index timestamp: explicit millis / date, else the write time
        if timestamp is not None:
            from .index.mapping import parse_date_millis
            try:
                ts = int(timestamp)
            except (TypeError, ValueError):
                ts = parse_date_millis(timestamp)
        else:
            ts = int(time.time() * 1000)
        r = svc.index_doc(doc_id, body, version, routing, doc_type=doc_type,
                          version_type=version_type, parent=parent,
                          timestamp_ms=ts)
        if refresh:
            # a doc-level refresh publishes the written shard only; the
            # parent routes it as the write did
            svc.shard_for(doc_id, routing if routing is not None
                          else parent).refresh()
        self.metrics.counter("indexing.index_total").inc()
        return r

    @staticmethod
    def _check_routing_required(svc, doc_id: str, routing, parent) -> None:
        """A `_parent`-mapped (or routing-required) index rejects doc ops
        without routing or parent (ref: RoutingMissingException usage in
        TransportIndexAction / TransportGetAction)."""
        if routing is None and parent is None and (
                svc.mappers.parent_type is not None
                or svc.mappers.routing_required):
            raise RoutingMissingError(svc.name, doc_id)

    def get_doc(self, index: str, doc_id: str, routing: str | None = None,
                doc_type: str | None = None, realtime: bool = True,
                parent: str | None = None) -> dict:
        svc = self._index(index)
        self._check_routing_required(svc, doc_id, routing, parent)
        return svc.get_doc(doc_id, routing if routing is not None
                           else parent, doc_type=doc_type,
                           realtime=realtime)

    def delete_doc(self, index: str, doc_id: str, version: int | None = None,
                   routing: str | None = None, refresh: bool = False,
                   doc_type: str | None = None,
                   version_type: str = "internal",
                   parent: str | None = None) -> dict:
        svc = self._index(index)
        self._check_routing_required(svc, doc_id, routing, parent)
        routing = routing if routing is not None else parent
        r = svc.delete_doc(doc_id, version, routing, doc_type=doc_type,
                           version_type=version_type)
        if refresh:
            svc.shard_for(doc_id, routing).refresh()
        return r

    def update_doc(self, index: str, doc_id: str, body: dict,
                   refresh: bool = False,
                   doc_type: str | None = None,
                   routing: str | None = None,
                   parent: str | None = None,
                   version: int | None = None,
                   fields: list[str] | None = None,
                   ttl: str | None = None,
                   timestamp: str | None = None) -> dict:
        """Partial update with a `doc` (ref: TransportUpdateAction +
        UpdateHelper: get, merge, re-index with the read version), with
        `upsert` / `doc_as_upsert`, or with a `script` mutating
        ctx._source (ctx.op `none` / `delete`, `scripted_upsert`; the 1.x
        shape with `params` / `lang` beside a string script)."""
        if index not in self.indices and (body.get("upsert") is not None
                                          or body.get("doc_as_upsert")
                                          or body.get("scripted_upsert")):
            svc = self._ensure_index(index)
        else:
            svc = self._index(index)
        self._check_routing_required(svc, doc_id, routing, parent)
        routing = routing if routing is not None else parent
        script_spec = body.get("script")
        if isinstance(script_spec, str) and (
                body.get("params") is not None
                or body.get("lang") is not None):
            # 1.x UpdateRequest shape: script/params/lang are request
            # TOP-LEVEL keys (ref: UpdateRequest.source parsing)
            script_spec = {"inline": script_spec,
                           "params": body.get("params") or {},
                           "lang": body.get("lang", "groovy")}
        if script_spec is not None and body.get("doc") is not None:
            # ref: UpdateRequest.validate
            raise IllegalArgumentError("can't provide both script and doc")

        def _with_get(r: dict, new_src: dict) -> dict:
            # ?fields= echoes the updated doc in a `get` section (ref:
            # UpdateHelper.extractGetResult)
            if fields:
                g: dict = {"found": True}
                if "_source" in fields:
                    g["_source"] = new_src
                flds = {}
                for f in fields:
                    if f == "_parent":
                        if doc_id in svc.doc_parent:
                            flds[f] = svc.doc_parent[doc_id]
                    elif f == "_routing":
                        if doc_id in svc.doc_routing:
                            flds[f] = svc.doc_routing[doc_id]
                    elif f == "_timestamp":
                        if doc_id in svc.doc_ts:
                            flds[f] = svc.doc_ts[doc_id]
                    elif f != "_source" and f in new_src:
                        v = new_src[f]
                        flds[f] = v if isinstance(v, list) else [v]
                if flds:
                    g["fields"] = flds
                r["get"] = g
            return r
        try:
            current = svc.get_doc(doc_id, routing, doc_type=doc_type)
        except ElasticsearchTpuError:
            if version is not None:
                raise VersionConflictError(index, doc_id, -1, version)
            upsert = body.get("upsert")
            if upsert is None and script_spec is not None and \
                    body.get("scripted_upsert"):
                upsert = {}
            elif upsert is None and body.get("doc_as_upsert"):
                upsert = body.get("doc")
            if upsert is None:
                raise
            if script_spec is not None and body.get("scripted_upsert"):
                upsert = self._run_update_script(script_spec, dict(upsert),
                                                 is_upsert=True)
                if upsert is None:  # ctx.op == none/delete on upsert
                    return {"_index": index, "_id": doc_id,
                            "result": "noop"}
            r = self.index_doc(index, doc_id, upsert, routing=routing,
                               doc_type=doc_type, refresh=refresh,
                               ttl=ttl, timestamp=timestamp, parent=parent)
            return _with_get(r, dict(upsert))
        if version is not None and current["_version"] != version:
            raise VersionConflictError(index, doc_id,
                                       current["_version"], version)
        src = json.loads(current["_source"])
        if script_spec is not None:
            new_src = self._run_update_script(script_spec, src)
            if new_src is None:  # ctx.op = "none"
                return {"_index": index, "_id": doc_id,
                        "_version": current["_version"], "result": "noop"}
            if new_src == "__delete__":
                r = svc.delete_doc(doc_id, current["_version"], routing)
                if refresh:
                    svc.shard_for(doc_id, routing).refresh()
                return r
            return _with_get(self.index_doc(
                index, doc_id, new_src, version=current["_version"],
                routing=routing, doc_type=doc_type, ttl=ttl,
                timestamp=timestamp, parent=parent, refresh=refresh),
                new_src)
        doc_part = body.get("doc")
        if doc_part is None:
            raise IllegalArgumentError("update requires [doc] or [script]")
        if body.get("detect_noop", False):
            merged = json.loads(json.dumps(src))
            _deep_merge(merged, doc_part)
            if merged == src:
                svc.op_stats.on_noop_update()
                return {"_index": index, "_id": doc_id,
                        "_version": current["_version"], "result": "noop"}
            src = merged
        else:
            _deep_merge(src, doc_part)
        return _with_get(self.index_doc(index, doc_id, src,
                                        version=current["_version"],
                                        routing=routing, doc_type=doc_type,
                                        ttl=ttl, timestamp=timestamp,
                                        parent=parent, refresh=refresh), src)

    @staticmethod
    def _run_update_script(script_spec, src: dict, is_upsert: bool = False):
        """Run an update script against ctx._source; returns the new
        source, "__delete__", or None for a noop. Ref: UpdateHelper
        ctx.op handling (index/delete/none)."""
        from .script import parse_script_spec, compile_script
        source, params = parse_script_spec(script_spec)
        cs = compile_script(source)
        ctx = {"_source": src, "op": "index",
               "_now": int(time.time() * 1000)}
        cs.run(params=params, bindings={"ctx": ctx})
        op = ctx.get("op", "index")
        if op in ("none", "noop"):
            return None
        if op == "delete":
            return None if is_upsert else "__delete__"
        return ctx["_source"]

    def bulk(self, operations: list[tuple[str, dict]],
             refresh: bool = False) -> dict:
        """operations: [(action, payload)] with action in index / create
        / delete / update; payload carries _index / _id / doc (ref:
        TransportBulkAction). Per-item errors, not a failed batch."""
        started = time.monotonic()
        items = []
        touched: set[str] = set()
        # the request's ops are acked together when it returns: their
        # `async` translog records reach the page cache once, at its end
        with _durability.acked_together():
            errors = self._bulk_items(operations, items, touched)
        if refresh:
            for idx in touched:
                self.indices[idx].refresh()
        return {"took": int((time.monotonic() - started) * 1000),
                "errors": errors, "items": items}

    def _bulk_items(self, operations, items: list, touched: set) -> bool:
        """Apply each op, appending its item; True if any failed."""
        errors = False
        for action, payload in operations:
            try:
                idx = payload["_index"]
                typ = payload.get("_type")
                if action in ("index", "create"):
                    r = self.index_doc(idx, payload.get("_id"),
                                       payload["doc"],
                                       routing=payload.get("_routing"),
                                       doc_type=typ)
                    touched.add(idx)
                    items.append({action: {**r, "status":
                                           201 if r.get("created")
                                           else 200}})
                elif action == "delete":
                    r = self.delete_doc(idx, payload["_id"], doc_type=typ,
                                        routing=payload.get("_routing"))
                    touched.add(idx)
                    items.append({"delete": {**r, "status":
                                             200 if r.get("found")
                                             else 404}})
                elif action == "update":
                    r = self.update_doc(idx, payload["_id"], payload["doc"],
                                        doc_type=typ,
                                        routing=payload.get("_routing"))
                    touched.add(idx)
                    items.append({"update": {**r, "status": 200}})
                else:
                    raise IllegalArgumentError(
                        f"unknown bulk action [{action}]")
            except ElasticsearchTpuError as e:
                errors = True
                items.append({action: {"error": e.to_dict(),
                                       "status": e.status}})
        return errors

    # -- search (ref: TransportSearchAction QUERY_THEN_FETCH) --------------
    def _on_device(self, fn, *args):
        """Run `fn` with the node's CUDA device current on this thread
        (the pool's threads serve every request on the same card and
        its default stream)."""
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                return fn(*args)
        return fn(*args)

    def search(self, index: str | None, body: dict | None = None,
               scroll: str | None = None,
               search_type: str | None = None,
               tenant: str | None = None) -> dict:
        """Admission first (search/traffic.py: a shed request takes no
        pool slot), then the bounded `search` pool (a full queue answers
        429). Pool threads re-entering search run inline."""
        if threading.current_thread().name.startswith("pool-search"):
            return self._search_inner(index, body, scroll, search_type)
        ticket = self.traffic.admit(tenant, "search")
        try:
            pool = self.thread_pool.executor("search")
            return pool.submit(self._on_device, self._search_inner, index,
                               body, scroll, search_type,
                               ticket.lane).result()
        finally:
            ticket.release()

    def _search_inner(self, index: str | None, body: dict | None = None,
                      scroll: str | None = None,
                      search_type: str | None = None,
                      lane: str = "interactive") -> dict:
        batch = self._dispatch.batch(lane=lane)
        st = self._search_submit(index, body, scroll, search_type, batch)
        batch.dispatch()
        return self._search_finish(st)

    def _search_submit(self, index: str | None, body: dict | None,
                       scroll: str | None, search_type: str | None,
                       batch) -> dict:
        """Resolve + bind + enqueue the fan-out of one search onto a
        dispatch batch without collecting, so msearch and concurrent
        callers coalesce identical plans and pipeline the rest."""
        body = body or {}
        if body.get("suggest") is not None:
            raise NotImplementedError("suggest is not ported")
        services = self._resolve(index)
        shard_readers: list[tuple[str, ShardReader]] = []
        # a contained shard becomes a structured `_shards.failures` entry
        # and the search reduces over the survivors
        prefailed: list[tuple[str, int, Exception]] = []
        for svc in services:
            for sid, eng in svc.shards.items():
                try:
                    shard_readers.append((svc.name, eng.acquire_searcher()))
                except ShardFailedError as e:
                    prefailed.append((svc.name, sid, e))
        if search_type in ("dfs_query_then_fetch", "dfs_query_and_fetch"):
            # DFS pre-phase: every shard scores with the global term
            # statistics (ref: DfsPhase + SearchPhaseController.
            # aggregateDfs)
            stats = self._aggregate_dfs(shard_readers, services, body)
            if stats:
                body = dict(body)
                body["_dfs_stats"] = stats
        scan_mode = search_type == "scan"
        if scan_mode:
            # scan: doc-order export without scoring (ref: ScanContext);
            # the first response carries only the cursor and the total
            body = dict(body)
            body["query"] = {"constant_score": {
                "filter": body.get("query") or {"match_all": {}}}}
        started = time.monotonic()
        # per-request deadline: body timeout, else the node's
        # search.default_search_timeout; -1 disables
        timeout = body.get("timeout")
        if timeout is None:
            timeout = self.settings.get_str("search.default_search_timeout")
        deadline = None
        if timeout not in (None, "", -1, "-1"):
            deadline = started + parse_time_value(timeout, 0) / 1000.0
        exec_st = self._submit_on_readers(shard_readers, body, batch,
                                          deadline=deadline)
        if prefailed:
            exec_st["prefailed"] = prefailed
        return {"services": services, "shard_readers": shard_readers,
                "body": body, "scan_mode": scan_mode, "scroll": scroll,
                "started": started, "exec": exec_st}

    def _search_finish(self, st: dict) -> dict:
        services = st["services"]
        body = st["body"]
        scroll = st["scroll"]
        result = self._finish_on_readers(st["exec"])
        took_ms = (time.monotonic() - st["started"]) * 1000.0
        for svc in services:
            svc.op_stats.on_search(body.get("stats"), took_ms)
            svc.op_stats.on_fetch(0.0)
        # stored per-doc mapping types on hits
        if any(svc.doc_types for svc in services):
            by_name = {svc.name: svc for svc in services}
            for hit in result.get("hits", {}).get("hits", []):
                svc = by_name.get(hit.get("_index"))
                if svc is not None and svc.doc_types:
                    hit["_type"] = svc.doc_type_of(hit["_id"])
        if scroll is not None:
            # the context keeps its point-in-time readers (and with them
            # their segments' device columns and fielddata holds) until
            # it is cleared or reaped
            scroll_id = uuid.uuid4().hex
            keepalive_ms = parse_time_value(scroll, 60_000)
            self._reap_scrolls()
            with self._scrolls_mx:
                self._scrolls[scroll_id] = {
                    "readers": st["shard_readers"], "body": dict(body),
                    # scan: the first response returns no hits and the
                    # cursor starts at 0; a scroll continues after page 1
                    "pos": 0 if st["scan_mode"] else
                           int(body.get("from", 0))
                           + int(body.get("size", 10)),
                    "keepalive_ms": keepalive_ms,
                    "expires_at": time.time() + keepalive_ms / 1000.0,
                }
            result["_scroll_id"] = scroll_id
            if st["scan_mode"]:
                result["hits"]["hits"] = []
        return result

    def _aggregate_dfs(self, shard_readers, services, body: dict) -> dict:
        """Collect the query's (field, term) pairs and sum df and
        doc_count over every shard (the aggregateDfs merge)."""
        from .search.highlight import collect_terms
        from .search.query_dsl import QueryParser
        if not services or body.get("query") is None:
            return {}
        try:
            ast = QueryParser(services[0].mappers).parse(body["query"])
        except ElasticsearchTpuError:
            return {}
        pairs = [(f, t) for f, terms in collect_terms(ast).items()
                 for t in terms]
        stats: dict[str, list] = {}
        for _, reader in shard_readers:
            for key, (df, n) in reader.term_stats(pairs).items():
                cur = stats.setdefault(key, [0, 0])
                cur[0] += df
                cur[1] += n
        return {k: v for k, v in stats.items() if v[1] > 0}

    def scroll(self, scroll_id: str, scroll: str | None = None,
               tenant: str | None = None) -> dict:
        """Next page over the stored point-in-time readers (ref:
        TransportSearchScrollAction + the keepalive). Pages ride the
        `scroll` lane and pay admission like any other search."""
        ticket = self.traffic.admit(tenant, "scroll")
        try:
            self._reap_scrolls()
            with self._scrolls_mx:
                ctx = self._scrolls.get(scroll_id)
                if ctx is None:
                    err = ElasticsearchTpuError(
                        f"No search context found for id [{scroll_id}]")
                    err.status = 404
                    raise err
                body = dict(ctx["body"])
                size = int(body.get("size", 10))
                body["from"] = ctx["pos"]
                ctx["pos"] += size
                if scroll is not None:
                    ctx["keepalive_ms"] = parse_time_value(scroll, 60_000)
                ctx["expires_at"] = (time.time()
                                     + ctx["keepalive_ms"] / 1000.0)
                readers = ctx["readers"]
            if threading.current_thread().name.startswith("pool-search"):
                result = self._execute_on_readers(readers, body,
                                                  ticket.lane)
            else:
                pool = self.thread_pool.executor("search")
                result = pool.submit(self._on_device,
                                     self._execute_on_readers, readers,
                                     body, ticket.lane).result()
            result["_scroll_id"] = scroll_id
            return result
        finally:
            ticket.release()

    def clear_scroll(self, scroll_ids: list[str] | None = None) -> dict:
        """Free scroll contexts (all with None or ["_all"]); their
        readers, and the holds they keep, go with them."""
        with self._scrolls_mx:
            if scroll_ids is None or scroll_ids == ["_all"]:
                n = len(self._scrolls)
                self._scrolls.clear()
            else:
                n = 0
                for sid in scroll_ids:
                    if self._scrolls.pop(sid, None) is not None:
                        n += 1
                if n == 0:
                    # ref: RestClearScrollAction, nothing freed is a 404
                    return {"succeeded": True, "num_freed": 0,
                            "_missing": True}
        return {"succeeded": True, "num_freed": n}

    def _reap_scrolls(self) -> None:
        now = time.time()
        with self._scrolls_mx:
            for sid in [s for s, c in self._scrolls.items()
                        if c["expires_at"] < now]:
                del self._scrolls[sid]

    def _execute_on_readers(self, shard_readers: list[tuple[str, ShardReader]],
                            body: dict, lane: str = "interactive") -> dict:
        batch = self._dispatch.batch(lane=lane)
        st = self._submit_on_readers(shard_readers, body, batch)
        batch.dispatch()
        return self._finish_on_readers(st)

    def _submit_on_readers(self, shard_readers: list[tuple[str, ShardReader]],
                           body: dict, batch,
                           deadline: float | None = None) -> dict:
        """Enqueue the per-shard fan-out of one request onto a dispatch
        batch; a request-cache hit (generation-exact) never reaches the
        scheduler."""
        ap = body.get("allow_partial_search_results")
        if ap is None:
            ap = self.settings.get_bool(
                "search.default_allow_partial_results", True)
        st: dict = {"shard_readers": shard_readers, "body": body,
                    "allow_partial": bool(ap)}
        if not shard_readers:
            st["empty"] = True
            return st
        frm = int(body.get("from", 0))
        size = int(body.get("size", 10))
        # each shard computes the full from+size window (ref: sortDocs)
        shard_body = dict(body)
        shard_body["from"] = 0
        shard_body["size"] = frm + size
        # coordinator-level controls: stripped so plan signatures and
        # cache keys are the same with and without them
        shard_body.pop("timeout", None)
        shard_body.pop("allow_partial_search_results", None)
        from .index.cache import cacheable, canonical_key
        cache_key = None
        cache_by_index: dict[str, bool] = {}
        entries: list[tuple] = []
        for name, reader in shard_readers:
            svc = self.indices.get(name)
            use_cache = cache_by_index.get(name)
            if use_cache is None:
                use_cache = svc is not None and cacheable(
                    shard_body, svc.settings.get_bool(
                        "index.cache.query.enable", False),
                    include_hits=svc.settings.get_bool(
                        "index.cache.query.include_hits", False))
                cache_by_index[name] = use_cache
            r = None
            if use_cache:
                if cache_key is None:
                    cache_key = canonical_key(shard_body)
                r = svc.request_cache.get(reader, cache_key)
                self.traffic.note_cache(hit=r is not None)
            if r is None:
                job = batch.submit(reader, shard_body, with_partials=True,
                                   deadline=deadline)
                entries.append(("job", svc if use_cache else None,
                                reader, cache_key, job))
            else:
                entries.append(("hit", None, None, None, r))
        st["entries"] = entries
        return st

    def _finish_on_readers(self, st: dict) -> dict:
        body = st["body"]
        prefailed = st.get("prefailed") or []
        if st.get("empty") and not prefailed:
            return merge_shard_results([], [], [], 0,
                                       int(body.get("size", 10)))
        agg_specs = parse_aggs(body.get("aggs") or body.get("aggregations"))
        frm = int(body.get("from", 0))
        size = int(body.get("size", 10))
        allow_partial = st.get("allow_partial", True)
        responses = []
        partials = []
        failures = []
        hard_errors = []
        timed_out = False
        # contained shards never produced a reader: they enter the reduce
        # as structured failures, and fail-fast requests re-raise
        for name, sid, exc in prefailed:
            if not allow_partial:
                raise exc
            hard_errors.append(exc)
            failures.append(shard_failure(sid, name, exc, node=self.name))
        for kind, svc, reader, cache_key, payload in st.get("entries", ()):
            if kind == "job":
                # per-shard failure isolation: a failing shard becomes a
                # structured `_shards.failures` entry, unless the request
                # asked for fail-fast
                try:
                    r = payload.result()
                except Exception as e:  # noqa: BLE001 — any shard error
                    if isinstance(e, SearchTimeoutError):
                        timed_out = True
                    else:
                        hard_errors.append(e)
                    if not allow_partial:
                        raise
                    failures.append(shard_failure(
                        reader.shard_id, reader.index_name, e,
                        node=self.name))
                    continue
                if svc is not None:
                    svc.request_cache.put(reader, cache_key, r)
            else:
                r = payload
            partials.append(r.pop("_agg_partials", {}))
            responses.append(r)
        if not responses and hard_errors:
            # all shards failed hard: an error, not a partial response
            raise hard_errors[0]
        sort = body.get("sort")
        score_sort = sort in (None, [], "_score") or (
            isinstance(sort, list) and sort and sort[0] == "_score")
        descending = True
        multi_orders = None
        if isinstance(sort, list) and len(sort) > 1:
            multi_orders = []
            for e in sort:
                if isinstance(e, str):
                    multi_orders.append(False)
                else:
                    spec = next(iter(e.values()))
                    order = (spec.get("order", "asc")
                             if isinstance(spec, dict) else str(spec))
                    multi_orders.append(str(order).lower() == "desc")
            score_sort = False
        elif not score_sort:
            entry = sort[0] if isinstance(sort, list) else sort
            if isinstance(entry, dict):
                spec = next(iter(entry.values()))
                order = (spec.get("order", "asc") if isinstance(spec, dict)
                         else str(spec))
                descending = order.lower() == "desc"
            else:
                descending = False
        self.metrics.counter("search.query_total").inc()
        if timed_out:
            self.metrics.counter("search.timed_out_total").inc()
        if failures:
            self.metrics.counter("search.shard_failures_total").inc(
                len(failures))
        out = merge_shard_results(responses, agg_specs, partials,
                                  frm=frm, size=size, descending=descending,
                                  score_sort=score_sort,
                                  multi_orders=multi_orders,
                                  total_shards=(len(st.get("entries", ()))
                                                + len(prefailed)),
                                  failures=failures, timed_out=timed_out)
        self._apply_sig_subs(out, agg_specs, body, st["shard_readers"])
        return out

    def _apply_sig_subs(self, out: dict, agg_specs, body: dict,
                        shard_readers) -> None:
        """significant_terms nested under a terms agg, over the same
        shard set and scored at the coordinator (see
        aggregations.apply_sig_subs); the enclosing query's foreground is
        a capped (10k) matching-id set."""
        if not any(spec.sig_subs for spec in agg_specs):
            return
        from .search.aggregations import apply_sig_subs

        def search_ids(query: dict) -> set:
            r = self._execute_on_readers(
                shard_readers, {"query": query, "size": 10_000,
                                "_source": False})
            return {h["_id"] for h in r["hits"]["hits"]}

        apply_sig_subs(agg_specs, out.get("aggregations", {}),
                       [reader for _, reader in shard_readers],
                       raw_query=body.get("query"),
                       search_ids=search_ids)

    def msearch(self, requests: list[tuple],
                tenant: str | None = None) -> dict:
        """Multi-search through the dispatch scheduler: every item's
        fan-out is submitted before anything is collected, so items
        whose plans bind alike coalesce into one batched device
        evaluation and the rest pipeline. Items are (index, body) or
        (index, body, search_type). Admission is per item (the admitted
        prefix runs; the shed tail answers 429 with `retry_after`); one
        bad item is an error entry, not a failed batch."""
        if threading.current_thread().name.startswith("pool-search"):
            return self._msearch_inner(requests)
        items = self.traffic.admit_items(tenant, "msearch", len(requests))
        try:
            admitted = requests[:items.granted]
            responses: list[dict] = []
            if admitted:
                pool = self.thread_pool.executor("search")
                try:
                    responses = pool.submit(
                        self._on_device, self._msearch_inner, admitted,
                        items.lane).result()["responses"]
                except ElasticsearchTpuError as e:
                    if e.status != 429:
                        raise
                    responses = [{"error": _legacy_error_string(e),
                                  "status": e.status} for _ in admitted]
            if items.granted < len(requests):
                shed = TrafficRejectedError(
                    items.tenant, "rate limit exceeded",
                    retry_after_s=items.retry_after_s)
                responses.extend(
                    {"error": _legacy_error_string(shed),
                     "status": shed.status,
                     "retry_after": shed.info["retry_after"]}
                    for _ in range(len(requests) - items.granted))
            return {"responses": responses}
        finally:
            items.release()

    def _msearch_inner(self, requests: list[tuple],
                       lane: str = "msearch") -> dict:
        batch = self._dispatch.batch(lane=lane)
        prepared: list[tuple] = []
        for item in requests:
            i, b = item[0], item[1]
            search_type = item[2] if len(item) > 2 else None
            t0 = time.monotonic()
            try:
                st = self._search_submit(i, b, None, search_type, batch)
                prepared.append((t0, None, st))
            except ElasticsearchTpuError as e:
                prepared.append((t0, e, None))
        batch.dispatch()
        out = []
        for t0, err, st in prepared:
            if err is None:
                try:
                    r = self._search_finish(st)
                    r["took"] = int((time.monotonic() - t0) * 1000)
                    r["status"] = 200
                    out.append(r)
                    continue
                except ElasticsearchTpuError as e:
                    err = e
            out.append({"error": _legacy_error_string(err),
                        "status": err.status})
        return {"responses": out}

    def count(self, index: str | None, body: dict | None = None) -> dict:
        r = self.search(index, {"query": (body or {}).get("query"),
                                "size": 0})
        return {"count": r["hits"]["total"], "_shards": r["_shards"]}

    # -- admin -------------------------------------------------------------
    def _broadcast_per_index(self, svcs, op) -> dict:
        """A per-index maintenance op with real shard accounting: an
        index whose op raises contributes structured failures."""
        total = successful = 0
        failures: list[dict] = []
        for svc in svcs:
            n = len(svc.shards)
            total += n
            try:
                op(svc)
                successful += n
            except Exception as e:  # noqa: BLE001 — per-index isolation
                failures.extend(
                    shard_failure(sid, svc.name, e, node=self.name)
                    for sid in svc.shards)
        return {"_shards": shards_header(total, successful, failures)}

    def refresh(self, index: str | None = None) -> dict:
        return self._broadcast_per_index(self._resolve(index),
                                         lambda svc: svc.refresh())

    def flush(self, index: str | None = None) -> dict:
        return self._broadcast_per_index(self._resolve(index),
                                         lambda svc: svc.flush())

    def force_merge(self, index: str | None = None,
                    max_num_segments: int = 1) -> dict:
        for svc in self._resolve(index):
            svc.force_merge(max_num_segments)
        return {"acknowledged": True}

    def recovery_status(self, index: str | None = None) -> dict:
        """Per-shard recovery info (ref: the indices recovery API): every
        shard of a single node recovered from its local store and
        translog, or stands FAILED with its containment reason."""
        out = {}
        for svc in self._resolve(index):
            shards = []
            for sid, eng in svc.shards.items():
                if eng.failed is not None:
                    shards.append({
                        "id": sid,
                        "type": "GATEWAY", "stage": "FAILED",
                        "primary": True,
                        "failure": {
                            "reason": eng.failed["reason"],
                            "during": eng.failed["during"],
                            "corruption_marker": eng.failed["marker"],
                        },
                    })
                    continue
                size = eng.segment_stats()["memory_in_bytes"]
                shards.append({
                    "id": sid,
                    "type": "GATEWAY", "stage": "DONE",
                    "primary": True,
                    "source": {"name": self.name, "ip": "127.0.0.1",
                               "host": "127.0.0.1"},
                    "target": {"name": self.name, "ip": "127.0.0.1",
                               "host": "127.0.0.1"},
                    "index": {
                        "size": {"total_in_bytes": size,
                                 "reused_in_bytes": size,
                                 "recovered_in_bytes": 0,
                                 "percent": "100.0%"},
                        "files": {"total": len(eng.segments),
                                  "reused": len(eng.segments),
                                  "recovered": 0,
                                  "percent": "100.0%"},
                        "source_throttle_time_in_millis": 0,
                        "target_throttle_time_in_millis": 0,
                        "total_time_in_millis": 0},
                    "translog": {"recovered": 0, "total": -1,
                                 "total_on_start": 0,
                                 "total_time_in_millis": 0},
                    "start": {"check_index_time_in_millis": 0,
                              "total_time_in_millis": 0},
                })
            out[svc.name] = {"shards": shards}
        return out

    def verify_integrity(self, index: str | None = None) -> dict:
        """Per-shard store audit (the `index.shard.check_on_startup`
        pass, on demand): commit readability, segment checksums and
        corruption markers. Pure reads."""
        out: dict = {"clean": True, "indices": {}}
        for svc in self._resolve(index):
            shards = {}
            for sid, eng in svc.shards.items():
                if eng.store is None:
                    continue
                rep = eng.store.verify_integrity()
                if eng.failed is not None:
                    rep["failed"] = dict(eng.failed)
                    rep["clean"] = False
                shards[str(sid)] = rep
                out["clean"] &= rep["clean"]
            if shards:
                out["indices"][svc.name] = {"shards": shards}
        return out

    def nodes_stats(self) -> dict:
        """The node stats (ref: NodesStatsResponse) trimmed to the
        indices (with the process-wide `durability` counter block), the
        breakers, the device (`accelerator`), the thread pools, the
        dispatch scheduler, the fused engine's admission and prune
        counters (top-level knn admission and the IVF cluster counters
        included), the storage fault rules and the node's counters."""
        return {"cluster_name": self.cluster_name, "nodes": {self.name: {
            "name": self.name,
            "timestamp": int(time.time() * 1000),
            "indices": {**{name: svc.stats()
                           for name, svc in self.indices.items()},
                        "durability": _durability.snapshot()},
            "accelerator": monitor.device_stats(),
            "thread_pool": self.thread_pool.stats(),
            "breakers": breaker_service().stats(),
            "dispatch": self._dispatch.stats.snapshot(),
            "fused_scoring": fused_scoring_stats(),
            "fault_injection": faults.snapshot(),
            "metrics": self.metrics.snapshot(),
        }}}

    def close(self) -> None:
        """Persist each index's metadata and close the engines without
        flushing (the translog holds what the last commit does not); the
        scroll contexts go, and the node lock is released."""
        if self._durability_stats is not None:
            _durability.reset_process_stats(if_owner=self._durability_stats)
            self._durability_stats = None
        if self._fault_registry is not None:
            if faults.active() is self._fault_registry:
                faults.clear()
            self._fault_registry = None
        if self._ann_cfg is not None:
            _ann.reset(if_current=self._ann_cfg)
            self._ann_cfg = None
        self.clear_scroll()
        self.resource_watcher.close()
        w = getattr(self, "_script_watcher", None)
        if w is not None:
            self.resource_watcher.remove(w)
            self._script_watcher = None
        for svc in self.indices.values():
            if self.data_path:
                self._persist_index_meta(svc)
            svc.close()
        self.thread_pool.shutdown()
        if self._node_lock_fh is not None:
            import fcntl
            try:
                fcntl.flock(self._node_lock_fh, fcntl.LOCK_UN)
            finally:
                self._node_lock_fh.close()
                self._node_lock_fh = None


def _legacy_error_string(e: ElasticsearchTpuError) -> str:
    """ES 2.0 wire format for embedded error strings:
    `IndexMissingException[[idx] missing]`."""
    if isinstance(e, IndexNotFoundError):
        return f"IndexMissingException[[{e.index}] missing]"
    return f"{type(e).__name__}[{e}]"


def _deep_merge(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v
