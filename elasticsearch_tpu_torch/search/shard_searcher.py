"""Shard-level search: segments -> merged hits + reduced aggs + fetch.

Counterpart of `elasticsearch_tpu/search/shard_searcher.py`. A
ShardReader is a point-in-time view over a shard's segments and live
masks, bound to one torch device. `msearch` keeps the reference's
structure: parse every request, bind it per segment, group requests by
(plan signature per segment, agg/sort/k signature), enqueue one batched
evaluation per (group, segment) on the device, then collect in
submission order and build the same response dicts.

`msearch` is the reference's submit/finish split: `msearch_submit`
enqueues every group's evaluation without collecting and returns a
`_PendingMsearch`, whose `finish()` collects in submission order. A
reader over a (base, delta) pair of the streaming write path (the second
segment has `delta_parent` set) serves each fused-admitted group in one
pack dispatch (`executor.execute_pack_async`), unless
`ES_TPU_PACK_DISPATCH=0`. `deadline` (absolute monotonic seconds) is the
cooperative search deadline, checked before each group's collect, and
arms the per-chunk check of resident dispatches (`ES_TPU_RESIDENT_LOOP`).

`term_stats` is the shard half of the DFS phase; a body's `_dfs_stats`
(the node's global statistics) reaches the binder.

Vectors. A top-level `knn` section beside a `query` is rewritten into a
bool should of the query and a `knn` clause (`rewrite_knn_body`), which
joins the grouped path: a hybrid plan runs on K3 with its `knn_vec`
clause. A pure `knn` section dispatches its per-segment candidates at
submit (`_knn_candidates_submit`: the IVF probe where the segment has or
builds an index, the exact scan otherwise) and combines them at finish
in Python floats, as the reference does. `rescore` rescores the response
window with a second query (`_apply_rescore`, five score modes).

Scripts: a `_script` sort computes its keys on the device from the
doc-value columns (`executor._eval_agg_script`, params baked into the
plan key); `script_fields` run on the host per returned hit
(`script.run_field_script`, `_score` bound to the hit's score).

Joins. Nested rows are hidden: `live` keeps primary rows only, while
`live_all` (the engine's deletions, a deleted parent's liveness carried
onto its nested rows) serves nested-scope requests, the auxiliary
requests of a `nested` agg (`_nested_scope`). `has_child`, `has_parent`
and `parent_id` nodes are resolved on the host before parsing
(`_resolve_joins_all`): an auxiliary search collects one side of the
join (two passes at most, `JOIN_RESOLVE_WINDOW`), and its ids become an
`ids` or term filter for the other, as the reference's per-shard
parent-id collectors do; the auxiliary searches of a batch's requests go
as one msearch a round. Children must be routed to their parent's
shard.

Trimmed to this slice: request keys outside `query`, `knn`, `rescore`,
`aggs` / `aggregations`, `size`, `from`, `sort` (one key: `_score`, a
keyword or a numeric field, or `_script`), `_source`, `fields` (stored
fields, read from `_source`, dotted paths into objects), `version`,
`script_fields`, `_dfs_stats` and the internal `_nested_scope` /
`_reverse_ctx` raise NotImplementedError, as do multi-key sorts,
highlight and suggest.

Derived bucket aggs (filter, filters, range, date_range, missing,
global, top_hits, significant_terms, and the scope shifts nested,
reverse_nested, children: `_scope_shift_body`) run after the main
groups: each bucket is an auxiliary filtered request (size 0, top_hits
size n) sent back through `msearch`, so a batch's derived requests are
batched and dispatched like any other (`_apply_derived`); with
`with_partials` their
results travel as `{"derived": ...}` partials that the node merges by
bucket key. significant_terms under a terms agg counts a field's terms
on the host per bucket (`sig_term_counts`, `_apply_sig_subs`).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..index.mapping import MapperService
from ..index.segment import Segment
from ..utils.errors import SearchParseError, SearchTimeoutError
from .aggregations import (DERIVED_KINDS, SCOPE_KINDS, AggSpec,
                           ShardAggContext, apply_sig_subs, finalize_partials,
                           merge_shard_partials, parse_aggs, shard_partials,
                           significant_buckets)
from ..ops.knn import SIMILARITIES
from .executor import (QueryBinder, _device_live, _fused_stats,
                       collect_pack_result, collect_segment_result,
                       device_arrays, ensure_agg_views, execute_pack_async,
                       execute_segment_async)
from .query_dsl import QueryParser

_REQUEST_KEYS = frozenset(("query", "aggs", "aggregations", "size", "from",
                           "sort", "_source", "fields", "version",
                           "_dfs_stats", "rescore", "script_fields",
                           "_nested_scope", "_reverse_ctx"))


def rewrite_knn_body(body: dict) -> dict:
    """Top-level hybrid `knn` section -> plain query DSL: the knn spec
    becomes a `knn` scoring clause in a bool should beside the query
    section (minimum_should_match 1: a hit matches either side), summed
    by ES's hybrid rule. As a plain query it rides the fused bundle
    engine (K3's knn_vec clause) and the pack dispatch."""
    spec = body["knn"]
    knn_node = {"knn": {"field": spec["field"],
                        "query_vector": spec["query_vector"],
                        "boost": float(spec.get("boost", 1.0))}}
    q = body.get("query")
    if q:
        new_q = {"bool": {"should": [q, knn_node],
                          "minimum_should_match": 1}}
    else:
        new_q = knn_node
    out = {k: v for k, v in body.items() if k not in ("knn", "query")}
    out["query"] = new_q
    return out


def knn_body_mode(body: dict, mappers: MapperService) -> tuple[str, str]:
    """(mode, admission reason) of a top-level `knn` section:
    "rewrite" (a `query` rides along: rewrite_knn_body), "candidates"
    (pure knn: per-segment candidates at submit, counted as "ivf" or
    "exact" by what served them) or "host" (an unmapped field, an
    unsupported similarity, a nonpositive boost: the synchronous host
    combine, counted as host_fallback:<why>)."""
    spec = body.get("knn") or {}
    field = spec.get("field")
    fm = mappers.field(field) if field else None
    if fm is None or fm.type != "dense_vector":
        return "host", "host_fallback:unmapped_field"
    sim = fm.similarity if fm.similarity else "cosine"
    if sim not in SIMILARITIES:
        return "host", f"host_fallback:similarity:{sim}"
    try:
        if float(spec.get("boost", 1.0)) <= 0.0:
            return "host", "host_fallback:nonpositive_boost"
    except (TypeError, ValueError):
        return "host", "host_fallback:bad_boost"
    if body.get("query"):
        return "rewrite", "query_rewrite"
    return "candidates", "candidates"


def _pack_dispatch_enabled() -> bool:
    """Base+delta one-dispatch kill switch (`ES_TPU_PACK_DISPATCH=0`):
    with it off, delta-mode readers fall back to per-segment dispatches,
    an A/B and bisection tool; responses are identical either way."""
    return os.environ.get("ES_TPU_PACK_DISPATCH", "1").lower() not in (
        "0", "false", "off")


class _PendingMsearch:
    """In-flight half of a split msearch (see ShardReader.msearch_submit):
    the evaluations are enqueued; finish() collects in submission order
    and builds the responses. `group_sizes` (queries per signature group)
    and `dispatch_count` (dispatches enqueued) describe the submit."""

    __slots__ = ("reader", "bodies", "with_partials", "started", "knn_idx",
                 "knn_sub", "parsed", "main", "groups", "no_segments",
                 "group_sizes", "dispatch_count", "deadline")

    def __init__(self, reader: "ShardReader", bodies: list[dict],
                 with_partials: bool, started: float, knn_idx: list[int],
                 parsed: dict[int, dict]):
        self.reader = reader
        self.bodies = bodies
        self.with_partials = with_partials
        self.started = started
        self.knn_idx = knn_idx
        # per-knn-item candidate dispatches (enqueued at submit; None =
        # the synchronous host path)
        self.knn_sub: dict[int, dict | None] = {}
        self.parsed = parsed
        self.main: list[int] = []
        self.groups: list[dict] = []
        self.no_segments = False
        self.group_sizes: list[int] = []
        self.dispatch_count = 0
        self.deadline: float | None = None

    def finish(self) -> list[dict]:
        return self.reader._msearch_finish(self)


class ShardReader:
    """Point-in-time searcher over a shard's segments (+ deletions).

    `device=None` means CUDA and raises when no CUDA device is present;
    pass `device="cpu"` to search on the CPU."""

    def __init__(self, index_name: str, segments: list[Segment],
                 live_masks: dict[str, np.ndarray], mapper: MapperService,
                 shard_id: int = 0, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.index_name = index_name
        self.segments = [s for s in segments if s.num_docs > 0]
        # live_all: the engine's deletions, a parent's liveness carried
        # onto its nested rows; live: primary rows only (hidden
        # block-join rows never surface as hits, ref: Lucene
        # NonNestedDocsFilter)
        self.live_all = {}
        self.live = {}
        for s in self.segments:
            la = np.array(live_masks.get(s.seg_id, _default_live(s)),
                          dtype=bool, copy=True)
            if s.parent_of is not None:
                ch = s.parent_of >= 0
                la[ch] &= la[s.parent_of[ch]]
            self.live_all[s.seg_id] = la
            self.live[s.seg_id] = la & s.primary_mask()
        self.mappers = mapper
        self.shard_id = shard_id
        self._global_ords: dict[str, tuple[list[str], list[np.ndarray]]] = {}
        self._generation_key: tuple | None = None

    def generation_key(self) -> tuple:
        """Content-exact generation of this point-in-time view, the
        request cache's invalidation signal (`index/cache.py`). Per
        segment: `Segment.cache_key()`, the delta epoch (a refresh that
        added docs re-keys though the delta's cache_key is epoch-stable)
        and a digest of the live mask (deletes flip bits without
        touching the segment). Memoized: the reader is immutable."""
        if self._generation_key is None:
            import hashlib
            parts = []
            for seg in self.segments:
                h = hashlib.blake2b(digest_size=8)
                h.update(self.live_all[seg.seg_id].tobytes())
                parts.append((seg.cache_key(), int(seg.delta_epoch or 0),
                              h.hexdigest()))
            self._generation_key = (self.index_name, self.shard_id,
                                    tuple(parts))
        return self._generation_key

    # -- global ordinals ---------------------------------------------------
    def global_ords(self, field: str) -> tuple[list[str], list[np.ndarray]]:
        cached = self._global_ords.get(field)
        if cached is not None:
            return cached
        all_terms: set[str] = set()
        for seg in self.segments:
            kc = seg.keywords.get(field)
            if kc is not None:
                all_terms.update(kc.terms)
        terms = sorted(all_terms)
        lookup = {t: i for i, t in enumerate(terms)}
        seg_maps = []
        for seg in self.segments:
            kc = seg.keywords.get(field)
            if kc is None:
                seg_maps.append(np.zeros(1, dtype=np.int32))
            else:
                seg_maps.append(np.asarray([lookup[t] for t in kc.terms],
                                           dtype=np.int32))
        result = (terms, seg_maps)
        self._global_ords[field] = result
        return result

    def term_stats(self, pairs: list[tuple[str, str]]
                   ) -> dict[str, tuple[int, int]]:
        """(field, term) -> (df, doc_count) summed over this shard's
        segments: the per-shard half of the DFS phase (ref:
        search/dfs/DfsPhase.java termStatistics)."""
        out: dict[str, tuple[int, int]] = {}
        for f, t in pairs:
            df = 0
            n = 0
            for seg in self.segments:
                pf = seg.text.get(f)
                if pf is not None:
                    tid = pf.lookup(str(t))
                    if tid >= 0:
                        df += int(pf.df[tid])
                    n += pf.doc_count
                    continue
                kc = seg.keywords.get(f)
                if kc is not None:
                    o = kc.lookup(str(t))
                    if o >= 0:
                        df += int(kc.df[o])
                    n += seg.num_docs
            out[f"{f}\x00{t}"] = (df, n)
        return out

    # -- parent/child joins (host-side two-pass resolution) ----------------
    # The reference resolves has_child / has_parent with per-shard
    # parent-id collectors (index/search/child/ChildrenQuery.java: collect
    # the matching children's parent ids, then filter the parents). Same
    # shape here: an auxiliary query collects one side, and its ids become
    # a host-computed filter for the other. Children must be routed to
    # their parent's shard (routing = the parent id), as in ES.

    JOIN_RESOLVE_WINDOW = 10_000

    def _collect_all_hits(self, queries: list[dict]) -> list[list[dict]]:
        """All hits of each auxiliary join query, the queries of a batch
        in one msearch a pass: the first pass learns each total, a second
        (only for those past the window) fetches every hit in one top-k.
        A query's hits do not depend on its batch: the reference's one
        msearch a query gives them alike."""
        first = self.msearch([{"query": q, "size": self.JOIN_RESOLVE_WINDOW,
                               "_source": False} for q in queries])
        out = [r["hits"]["hits"] for r in first]
        again = [i for i, r in enumerate(first)
                 if r["hits"]["total"] > self.JOIN_RESOLVE_WINDOW]
        if again:
            full = self.msearch([{"query": queries[i],
                                  "size": first[i]["hits"]["total"],
                                  "_source": False} for i in again])
            for i, r in zip(again, full):
                out[i] = r["hits"]["hits"]
        return out

    def _resolve_joins_all(self, queries: list) -> list:
        """Each query with its has_child / has_parent / parent_id nodes
        replaced (`_join_resolver`), the auxiliary searches of the batch
        taken together: a round collects the next one each query is
        waiting on."""
        out = list(queries)
        gens, pending = {}, {}
        for i, q in enumerate(queries):
            if q is not None and _has_join_nodes(q):
                gens[i] = self._join_resolver(q)
                pending[i] = None
        while pending:
            asks = {}
            for i, hits in pending.items():
                try:
                    asks[i] = gens[i].send(hits)
                except StopIteration as done:
                    out[i] = done.value
            idx = list(asks)
            pending = dict(zip(idx, self._collect_all_hits(
                [asks[i] for i in idx]))) if idx else {}
        return out

    def _join_field(self, ctx: str):
        fm = self.mappers.join_field()
        if fm is None:
            raise SearchParseError(
                f"[{ctx}] no join field is mapped on [{self.index_name}]")
        return fm

    # compound query shapes whose bodies hold query nodes: the join
    # resolution recurses only there, so a field named like "parent_id"
    # inside a term / match leaf is never read as a join query
    _QUERY_LIST_KEYS = ("must", "should", "must_not", "filter", "queries",
                        "filters")
    _QUERY_CHILD_KEYS = ("query", "filter", "positive", "negative",
                         "no_match_query", "include", "exclude")
    _COMPOUND_NODES = ("bool", "constant_score", "filtered", "not", "and",
                       "or", "nested", "function_score", "boosting",
                       "dis_max", "indices", "_parents_match",
                       "span_multi")

    def _join_resolver(self, q):
        """Generator: `q` with the has_child / has_parent / parent_id
        query nodes (by their place in the query tree, not by key name)
        replaced with resolved id filters. It yields each auxiliary query
        it needs and is sent back that query's hits
        (`_resolve_joins_all` drives it)."""
        if not isinstance(q, dict):
            return q
        out = {}
        for name, body in q.items():
            if name == "has_child":
                out.update((yield from self._resolve_has_child(body)))
            elif name == "has_parent":
                out.update((yield from self._resolve_has_parent(body)))
            elif name == "parent_id":
                out.update(self._resolve_parent_id(body))
            elif name in self._COMPOUND_NODES and isinstance(body, dict):
                nb = dict(body)
                for k, v in body.items():
                    if k in self._QUERY_LIST_KEYS and isinstance(v, list):
                        items = []
                        for x in v:
                            items.append((yield from self._join_resolver(x)))
                        nb[k] = items
                    elif k in self._QUERY_LIST_KEYS + self._QUERY_CHILD_KEYS \
                            and isinstance(v, dict):
                        nb[k] = yield from self._join_resolver(v)
                    elif k == "functions" and isinstance(v, list):
                        # function_score's functions carry a filter each
                        fns = []
                        for fn in v:
                            if isinstance(fn, dict) and \
                                    isinstance(fn.get("filter"), dict):
                                fn = {**fn, "filter": (yield from
                                      self._join_resolver(fn["filter"]))}
                            fns.append(fn)
                        nb[k] = fns
                out[name] = nb
            elif name in ("and", "or", "dis_max") and isinstance(body, list):
                items = []
                for x in body:
                    items.append((yield from self._join_resolver(x)))
                out[name] = items
            else:
                out[name] = body  # a leaf: its values are never queries
        return out

    def _join_parent_of_hit(self, doc_id: str, pcol: str) -> str | None:
        seg, local = self._locate(doc_id)
        if seg is None:
            return None
        kc = seg.keywords.get(pcol)
        if kc is None or kc.ords[local] < 0:
            return None
        return kc.terms[kc.ords[local]]

    def _resolve_has_child(self, spec: dict):
        """Generator (see `_join_resolver`): the parents with min_children
        .. max_children matching children."""
        fm = self._join_field("has_child")
        ctype = spec.get("type") or spec.get("child_type")
        inner = yield from self._join_resolver(spec.get("query")
                                               or {"match_all": {}})
        hits = yield {"bool": {"must": [inner],
                               "filter": [{"term": {fm.name: ctype}}]}}
        pcol = f"{fm.name}#parent"
        counts: dict[str, int] = {}
        for h in hits:
            pid = self._join_parent_of_hit(h["_id"], pcol)
            if pid is not None:
                counts[pid] = counts.get(pid, 0) + 1
        mn = int(spec.get("min_children", 1) or 1)
        mx = spec.get("max_children")
        ids = [p for p, c in counts.items()
               if c >= mn and (mx is None or c <= int(mx))]
        if not ids:
            return {"match_none": {}}
        return {"ids": {"values": sorted(ids)}}

    def _resolve_has_parent(self, spec: dict):
        """Generator (see `_join_resolver`): the children of the matching
        parents."""
        fm = self._join_field("has_parent")
        ptype = spec.get("parent_type") or spec.get("type")
        inner = yield from self._join_resolver(spec.get("query")
                                               or {"match_all": {}})
        hits = yield {"bool": {"must": [inner],
                               "filter": [{"term": {fm.name: ptype}}]}}
        pids = {h["_id"] for h in hits}
        if not pids:
            return {"match_none": {}}
        # the matched parents' children: membership of the parent-id
        # ordinal column
        pcol = f"{fm.name}#parent"
        child_ids: list[str] = []
        for seg in self.segments:
            kc = seg.keywords.get(pcol)
            if kc is None:
                continue
            # the matched parents' ordinals (the reference walks every
            # term of the column; a lookup a parent gives the same set)
            want = np.asarray(sorted(kc.term_index[p] for p in pids
                                     if p in kc.term_index), dtype=np.int32)
            if want.size == 0:
                continue
            n = seg.num_docs
            mask = (self.live[seg.seg_id][:n]
                    & np.isin(kc.ords[:n], want))
            child_ids.extend(seg.ids[d] for d in np.nonzero(mask)[0])
        if not child_ids:
            return {"match_none": {}}
        return {"ids": {"values": sorted(child_ids)}}

    def _resolve_parent_id(self, spec: dict) -> dict:
        fm = self._join_field("parent_id")
        ctype = spec.get("type")
        clauses = [{"term": {f"{fm.name}#parent": str(spec.get("id"))}}]
        if ctype:
            clauses.append({"term": {fm.name: ctype}})
        return {"bool": {"filter": clauses}}

    # -- search ------------------------------------------------------------
    def search(self, body: dict) -> dict:
        return self.msearch([body])[0]

    def count(self, body: dict | None = None) -> int:
        res = self.search({"query": (body or {}).get("query"), "size": 0})
        return res["hits"]["total"]

    def msearch(self, bodies: list[dict], with_partials: bool = False,
                deadline: float | None = None) -> list[dict]:
        """Execute a batch of requests; structurally-identical requests are
        batched into one device evaluation (leading dim B).

        with_partials=True attaches "_agg_partials" (keyed shard partials
        for the cross-shard reduce) instead of finalized "aggregations".
        `deadline` (absolute monotonic seconds): past it, the shard
        fails whole with SearchTimeoutError."""
        pend = self.msearch_submit(bodies, with_partials, deadline=deadline)
        out = pend.finish()
        # stamped after finish(): the dispatch scheduler's sync path
        # reads the stats of the call it made
        from .dispatch import note_submit_stats
        note_submit_stats(pend.group_sizes, pend.dispatch_count)
        return out

    def msearch_submit(self, bodies: list[dict],
                       with_partials: bool = False,
                       deadline: float | None = None) -> _PendingMsearch:
        """Dispatch half of msearch: parse, group structurally-identical
        requests, and enqueue every group's evaluations without
        collecting. `.finish()` collects in submission order and builds
        the responses."""
        started = time.monotonic()
        n = len(bodies)
        bodies = list(bodies)
        knn_idx = []
        knn_modes: dict[int, str] = {}
        for i, b in enumerate(bodies):
            if not (b or {}).get("knn"):
                continue
            mode, reason = knn_body_mode(b, self.mappers)
            if mode != "candidates":
                # candidates items record "ivf" / "exact" at their submit
                _fused_stats.record_knn(reason)
            if mode == "rewrite" and self.segments:
                # hybrid BM25+knn joins the grouped path as a plain query
                bodies[i] = rewrite_knn_body(b)
            else:
                knn_idx.append(i)
                knn_modes[i] = mode
        knn_set = set(knn_idx)
        main_idx = [i for i in range(n) if i not in knn_set]
        # the join nodes of every request resolved together
        queries = self._resolve_joins_all([(bodies[i] or {}).get("query")
                                           for i in main_idx])
        parsed = {i: self._parse_request(bodies[i], q)
                  for i, q in zip(main_idx, queries)}
        pend = _PendingMsearch(self, bodies, with_partials, started,
                               knn_idx, parsed)
        pend.deadline = deadline
        if not self.segments:
            pend.no_segments = True
            return pend
        # pure-knn items enqueue their per-segment candidates here, so
        # they pipeline with every other dispatch; items of one (field,
        # k) go as the rows of one dispatch a segment (each row's result
        # is its own)
        knn_groups: dict[tuple, list[int]] = {}
        for i in knn_idx:
            if knn_modes[i] != "candidates":
                pend.knn_sub[i] = None
                continue
            field, _qv, k, _boost, sim = self._knn_spec(bodies[i])
            knn_groups.setdefault((field, k, sim), []).append(i)
        for idxs in knn_groups.values():
            group = self._knn_candidates_submit([bodies[i] for i in idxs])
            kind = "ivf" if any(kd == "ivf" for _o, kd, _p
                                in group["pending"]) else "exact"
            for row, i in enumerate(idxs):
                _fused_stats.record_knn(kind)
                pend.knn_sub[i] = {"group": group, "row": row}
        pend.main = [i for i in range(n) if i not in knn_set]
        # group request indices by (plan signature per segment, agg/sort/k sig)
        groups: dict[tuple, list[int]] = {}
        bound_per_req: dict[int, list] = {}
        for i in pend.main:
            p = parsed[i]
            per_seg_bounds = [
                QueryBinder(seg, self.mappers, live=self.live[seg.seg_id],
                            dfs=p["dfs_stats"],
                            device=self.device).bind(p["query"])
                for seg in self.segments]
            bound_per_req[i] = per_seg_bounds
            sig = (tuple(b.signature() for b in per_seg_bounds),
                   p["static_sig"])
            groups.setdefault(sig, []).append(i)

        shard_key = (self.index_name, self.shard_id)
        for idxs in groups.values():
            p0 = parsed[idxs[0]]
            agg_ctx = ShardAggContext(self.segments,
                                      self._ords_for(p0["agg_specs"]),
                                      self.device)
            agg_desc, agg_params = agg_ctx.build(p0["agg_specs"])
            k = p0["from"] + p0["size"]
            if k == 0 and (p0["sort_spec"][0] != "_score"
                           or p0["rescore"] is not None):
                k = 1  # sorted and rescored requests keep k >= 1
            sort_spec = p0["sort_spec"]
            if p0["agg_specs"]:
                for si, seg in enumerate(self.segments):
                    ensure_agg_views(seg, bound_per_req[idxs[0]][si],
                                     agg_desc, self.device)
            sort_terms = None
            sort_maps = [() for _ in self.segments]
            if sort_spec[0] == "field" and sort_spec[3] == "kw":
                sort_terms, seg_maps = self.global_ords(sort_spec[1])
                sort_maps = [(m,) for m in seg_maps]
            elif sort_spec[0] == "field" and sort_spec[3] == "script":
                from ..script import compile_script
                from .executor import ensure_script_vals
                cs = compile_script(sort_spec[1].split("\x00", 1)[0])
                for seg in self.segments:
                    ensure_script_vals(seg, cs.fields, self.device)
            pending = []
            # nested-scope requests (aggs over the hidden nested rows)
            # lift the primary-row restriction
            live_sel = self.live_all if p0["nested_scope"] else self.live
            # streaming write path: a (base, delta) pair serves a
            # fused-admitted plan in ONE dispatch (the delta walk chains
            # onto the base's running top-k); inadmissible plans fall
            # back to the per-segment dispatches below
            if len(self.segments) == 2 \
                    and self.segments[1].delta_parent is not None \
                    and _pack_dispatch_enabled():
                b_seg, d_seg = self.segments
                pack = execute_pack_async(
                    b_seg, d_seg, live_sel[b_seg.seg_id],
                    live_sel[d_seg.seg_id],
                    [bound_per_req[i][0] for i in idxs],
                    [bound_per_req[i][1] for i in idxs], k,
                    agg_desc=agg_desc,
                    agg_params_b=agg_params[0] if agg_params else (),
                    agg_params_d=agg_params[1] if agg_params else (),
                    sort_spec=sort_spec, device=self.device,
                    deadline=deadline, shard_key=shard_key)
                if pack is not None:
                    pending.append(pack)
            if not pending:
                for si, seg in enumerate(self.segments):
                    bounds = [bound_per_req[i][si] for i in idxs]
                    pending.append(execute_segment_async(
                        seg, live_sel[seg.seg_id], bounds, k,
                        agg_desc=agg_desc, agg_params=agg_params[si],
                        sort_spec=sort_spec, sort_params=sort_maps[si],
                        device=self.device, deadline=deadline,
                        shard_key=shard_key))
            pend.groups.append({"idxs": idxs, "p0": p0, "agg_ctx": agg_ctx,
                                "pending": pending,
                                "sort_terms": sort_terms})
        pend.group_sizes = [len(g["idxs"]) for g in pend.groups]
        pend.dispatch_count = sum(len(g["pending"]) for g in pend.groups)
        return pend

    def _deadline_check(self, pend: _PendingMsearch) -> None:
        if pend.deadline is not None \
                and time.monotonic() > pend.deadline:
            raise SearchTimeoutError(self.index_name, self.shard_id)

    def _msearch_finish(self, pend: _PendingMsearch) -> list[dict]:
        parsed = pend.parsed
        responses: list[dict | None] = [None] * len(pend.bodies)
        for i in pend.knn_idx:
            self._deadline_check(pend)
            sub = pend.knn_sub.get(i)
            if sub is None:
                responses[i] = self._knn_search(pend.bodies[i], pend.started,
                                                pend.with_partials)
            else:
                responses[i] = self._knn_collect(pend.bodies[i], sub,
                                                 pend.started,
                                                 pend.with_partials)
        if pend.no_segments:
            for i, p in parsed.items():
                responses[i] = self._empty_response(p, pend.started,
                                                    pend.with_partials)
            return responses  # type: ignore[return-value]
        for g in pend.groups:
            # deadline passed before this group's collect: the shard
            # fails whole by timeout. Fully-resident groups skip this
            # cooperative check: every dispatch of theirs carries the
            # stepped walk's own verdict (a final check after the last
            # chunk included), which the collect raises as the same
            # SearchTimeoutError; a group with any cold dispatch keeps
            # the check, that dispatch having no verdict of its own
            if not all(layout.get("resident")
                       for _o, layout, _n in g["pending"]):
                self._deadline_check(pend)
            idxs = g["idxs"]
            p0 = g["p0"]
            agg_ctx = g["agg_ctx"]
            partials = []
            seg_tops = []
            for out, layout, n_real in g["pending"]:
                if layout.get("pack"):
                    # one pack dispatch covered (base, delta): the
                    # collect splits back into per-segment candidate
                    # lists + agg partials
                    tops2, aggs2 = collect_pack_result(out, layout, n_real)
                    seg_tops.extend(tops2)
                    partials.extend(aggs2)
                    continue
                top, aggs = collect_segment_result(out, layout, n_real)
                seg_tops.append(top)
                partials.append(aggs)
            if p0["agg_specs"] and pend.with_partials:
                part_json = shard_partials(p0["agg_specs"], agg_ctx,
                                           partials, len(idxs))
                agg_json = [{} for _ in idxs]
            elif p0["agg_specs"]:
                # the group's partials, finalized with each request's
                # own specs (its percents / values)
                part_json = None
                agg_json = [finalize_partials(
                    parsed[i]["agg_specs"],
                    merge_shard_partials(parsed[i]["agg_specs"], [part]))
                    for i, part in zip(idxs, shard_partials(
                        p0["agg_specs"], agg_ctx, partials, len(idxs)))]
            else:
                part_json = None
                agg_json = [{} for _ in idxs]
            for bi, i in enumerate(idxs):
                responses[i] = self._build_response(
                    parsed[i], seg_tops, bi, agg_json[bi], pend.started,
                    sort_terms=g["sort_terms"])
                if part_json is not None:
                    responses[i]["_agg_partials"] = part_json[bi]
        # rescoring runs one more search a request, all of them as one
        # msearch (a request's response does not depend on its batch); a
        # shard that finishes it past the deadline is a laggard too
        rescored = [i for i in pend.main if parsed[i]["rescore"] is not None]
        if rescored:
            self._deadline_check(pend)
            subs = self.msearch([self._rescore_body(parsed[i])
                                 for i in rescored])
            for i, sub in zip(rescored, subs):
                self._apply_rescore(responses[i], parsed[i], sub)
        # derived aggs and significant_terms subs fan back into msearch
        derived = [i for i in pend.main if parsed[i]["derived_specs"]]
        if derived:
            self._deadline_check(pend)
            self._apply_derived([responses[i] for i in derived],
                                [parsed[i] for i in derived],
                                pend.with_partials)
        for i in pend.main:
            self._apply_sig_subs(responses[i], parsed[i], pend.with_partials)
        return responses  # type: ignore[return-value]

    # -- derived aggs ------------------------------------------------------
    def sig_term_counts(self, field: str, flt_field: str | None = None,
                        flt_value=None,
                        allowed_ids=None) -> tuple[int, dict]:
        """(n_docs, {token: doc_count}) over live docs, optionally
        restricted to docs whose `flt_field` equals `flt_value` (and to
        `allowed_ids`). Counts tokens of analyzed text through the
        postings CSR; keyword fields count whole values."""
        total = 0
        counts: dict[str, int] = {}
        for seg in self.segments:
            mask = self.live[seg.seg_id].copy()
            if allowed_ids is not None:
                # enclosing-query scope: only docs the query matched
                in_q = np.zeros(seg.capacity, dtype=bool)
                for d, did in enumerate(seg.ids):
                    if did in allowed_ids:
                        in_q[d] = True
                mask &= in_q
            if flt_field is not None:
                kc = (seg.keywords.get(flt_field)
                      or seg.keywords.get(f"{flt_field}.keyword"))
                if kc is None:
                    continue
                t = kc.term_index.get(str(flt_value), -1)
                if t < 0:
                    continue
                m = kc.ords == t
                if kc.mv_ords is not None:
                    m |= (kc.mv_ords == t).any(axis=1)
                mask &= m
            total += int(mask.sum())
            pf = seg.text.get(field)
            if pf is not None:
                tids = np.repeat(
                    np.arange(len(pf.terms), dtype=np.int64),
                    np.diff(pf.indptr))
                sel = mask[pf.doc_ids]
                bc = np.bincount(tids[sel], minlength=len(pf.terms))
                for t_idx in np.nonzero(bc)[0]:
                    term = pf.terms[int(t_idx)]
                    counts[term] = counts.get(term, 0) + int(bc[t_idx])
            else:
                kc = (seg.keywords.get(field)
                      or seg.keywords.get(f"{field}.keyword"))
                if kc is None:
                    continue
                live_ords = kc.ords[mask]
                bc = np.bincount(live_ords[live_ords >= 0],
                                 minlength=len(kc.terms))
                for t_idx in np.nonzero(bc)[0]:
                    term = kc.terms[int(t_idx)]
                    counts[term] = counts.get(term, 0) + int(bc[t_idx])
        return total, counts

    def _apply_sig_subs(self, resp: dict, p: dict,
                        with_partials: bool) -> None:
        """significant_terms nested under a terms agg (see
        aggregations.apply_sig_subs). The node applies them itself over
        its shards, so the partials form carries none."""
        if with_partials:
            return
        if not any(spec.sig_subs for spec in p["agg_specs"]):
            return

        def search_ids(query: dict) -> set:
            r = self.search({"query": query, "size": 10_000,
                             "_source": False})
            return {h["_id"] for h in r["hits"]["hits"]}

        apply_sig_subs(p["agg_specs"], resp.get("aggregations", {}),
                       [self], raw_query=p["raw_query"],
                       search_ids=search_ids)

    def _derived_bodies(self, spec: AggSpec, p: dict) -> list[dict]:
        """A derived agg's auxiliary requests, one a bucket (filter,
        filters, range, date_range, missing, global, top_hits), the
        foreground and background of significant_terms, or the one
        request of a scope shift. Inside a nested scope they stay in it."""
        if spec.kind in SCOPE_KINDS:
            return [self._scope_shift_body(spec, p)]
        if spec.kind == "significant_terms":
            base = {"size": 0, "aggs": spec.sub_raw}
            bodies = [{"query": p["raw_query"] or {"match_all": {}}, **base},
                      {"query": {"match_all": {}}, **base}]
            if p["nested_scope"]:
                for b in bodies:
                    b["_nested_scope"] = p["nested_scope"]
            return bodies
        bodies = []
        for _key, flt, _extra in spec.buckets:
            if spec.mode == "ignore_query":
                q = flt or {"match_all": {}}
            else:
                clauses = {"filter": [flt] if flt else []}
                if p["raw_query"] is not None:
                    clauses["must"] = [p["raw_query"]]
                q = {"bool": clauses}
            size = spec.top_hits_size if spec.kind == "top_hits" else 0
            body = {"query": q, "size": size,
                    "_source": spec.top_hits_source}
            if spec.sub_raw:
                body["aggs"] = spec.sub_raw
            if p["nested_scope"]:
                body["_nested_scope"] = p["nested_scope"]
            if p["reverse_ctx"]:
                body["_reverse_ctx"] = p["reverse_ctx"]
            bodies.append(body)
        return bodies

    def _scope_shift_body(self, spec: AggSpec, p: dict) -> dict:
        """The auxiliary request of a scope-shifting agg: nested (the
        nested rows of `path` whose parent matches the request's query),
        reverse_nested (back to the parents of the enclosing nested
        scope), children (a relation's children of the matching
        parents). Its own derived and sub aggs recurse."""
        outer = p["raw_query"]
        if spec.kind == "nested":
            path = spec.mode.split(":", 1)[1]
            q = {"bool": {"filter": [
                {"term": {"_nested_path": path}},
                {"_parents_match": {"query": outer or {"match_all": {}}}}]}}
            body = {"query": q, "size": 0, "_nested_scope": path,
                    "_reverse_ctx": {"path": path, "outer": outer}}
        elif spec.kind == "reverse_nested":
            ctx = p.get("reverse_ctx")
            if not ctx:
                raise SearchParseError(
                    "[reverse_nested] must be nested inside a [nested] "
                    "aggregation")
            clauses: dict = {"filter": [{"nested": {
                "path": ctx["path"], "query": {"match_all": {}}}}]}
            if ctx.get("outer"):
                clauses["must"] = [ctx["outer"]]
            body = {"query": {"bool": clauses}, "size": 0}
        else:  # children
            ctype = spec.mode.split(":", 1)[1]
            fm = self._join_field("children")
            parent_rel = None
            for parent, kids in (fm.relations or {}).items():
                kids = kids if isinstance(kids, list) else [kids]
                if ctype in kids:
                    parent_rel = parent
            if parent_rel is None:
                raise SearchParseError(
                    f"[children] no relation to type [{ctype}]")
            q = {"bool": {
                "must": [{"has_parent": {"parent_type": parent_rel,
                                         "query": outer or
                                         {"match_all": {}}}}],
                "filter": [{"term": {fm.name: ctype}}]}}
            body = {"query": q, "size": 0}
        if spec.sub_raw:
            body["aggs"] = spec.sub_raw
        return body

    def _apply_derived(self, resps: list[dict], ps: list[dict],
                       with_partials: bool) -> None:
        """Derived bucket aggs of a batch's requests: every bucket's
        auxiliary request goes into ONE msearch (a request's response
        does not depend on its batch, so this equals the reference's
        msearch per derived agg), then each agg is stitched from its
        slice of the responses."""
        bodies: list[dict] = []
        slots: list[tuple[dict, AggSpec, int, int]] = []
        for resp, p in zip(resps, ps):
            for spec in p["derived_specs"]:
                aux = self._derived_bodies(spec, p)
                slots.append((resp, spec, len(bodies), len(aux)))
                bodies.extend(aux)
        auxs = self.msearch(bodies, with_partials)
        for resp, spec, lo, n in slots:
            aux = auxs[lo: lo + n]
            if with_partials:
                derived = {}
                for (key, _f, _x), ar in zip(spec.buckets, aux):
                    bucket = {"count": ar["hits"]["total"],
                              "sub": ar.get("_agg_partials", {})}
                    if spec.kind == "top_hits":
                        bucket["hits"] = ar["hits"]["hits"]
                    derived[key] = bucket
                resp.setdefault("_agg_partials", {})[spec.name] = \
                    {"derived": derived}
            else:
                resp.setdefault("aggregations", {})[spec.name] = \
                    self._stitch_derived(spec, aux)

    @staticmethod
    def _stitch_derived(spec: AggSpec, aux: list[dict]) -> dict:
        def bucket_json(ar: dict) -> dict:
            out = {"doc_count": ar["hits"]["total"]}
            out.update(ar.get("aggregations", {}))
            return out

        if spec.kind == "top_hits":
            ar = aux[0]
            return {"hits": {"total": ar["hits"]["total"],
                             "max_score": ar["hits"]["max_score"],
                             "hits": ar["hits"]["hits"]}}
        if spec.kind == "significant_terms":
            fg, bg = aux[0], aux[1]
            return significant_buckets(
                spec, fg["hits"]["total"],
                fg["aggregations"]["__sig_terms"]["buckets"],
                bg["hits"]["total"],
                bg["aggregations"]["__sig_terms"]["buckets"])
        if spec.kind in ("filter", "missing", "global", *SCOPE_KINDS):
            return bucket_json(aux[0])
        if spec.kind == "filters":
            return {"buckets": {key: bucket_json(ar)
                                for (key, _f, _x), ar in
                                zip(spec.buckets, aux)}}
        buckets = []
        for (key, _f, extra), ar in zip(spec.buckets, aux):
            buckets.append({"key": key,
                            **{k: v for k, v in extra.items()
                               if v is not None},
                            **bucket_json(ar)})
        return {"buckets": buckets}

    # -- knn ---------------------------------------------------------------
    def _knn_spec(self, body: dict) -> tuple:
        spec = body["knn"]
        field = spec["field"]
        qv = np.asarray(spec["query_vector"], dtype=np.float32)
        k = int(spec.get("k", spec.get("num_candidates", 10)))
        boost = float(spec.get("boost", 1.0))
        fm = self.mappers.field(field)
        similarity = (fm.similarity if fm is not None and fm.similarity
                      else "cosine")
        return field, qv, k, boost, similarity

    def _knn_exact_dispatch(self, seg: Segment, field: str, qv: np.ndarray,
                            k: int, similarity: str):
        """Exact-scan candidates of one segment for the query rows qv
        [r, D], enqueued. Segments of 2^18 docs and more take a window of
        max(4k, 100) candidates, as the reference's (whose TPU path
        selects that window with approx_max_k); the selection here is
        exact, so the combine's top k is the exact top k."""
        from ..ops.knn import knn_topk
        dev = device_arrays(seg, self.device)["vec"][field]
        live = _device_live(seg, self.live[seg.seg_id], self.device)
        window = (min(max(4 * k, 100), seg.capacity)
                  if seg.capacity >= (1 << 18) else min(k, seg.capacity))
        q = torch.from_numpy(np.ascontiguousarray(qv)).to(self.device)
        return knn_topk(dev["values"], dev["norms"], dev["exists"], live, q,
                        similarity=similarity, k=window)

    def _knn_candidates_submit(self, bodies: list[dict]) -> dict:
        """Dispatch half of pure-knn searches of one (field, k): the
        per-segment candidate top-k of every body, one row each,
        enqueued here and collected in finish. Segments that carry (or
        build, index/ann.ensure_ann) an IVF index serve the probe
        (ops/ann.ivf_topk); the rest the exact scan."""
        from ..index import ann as ann_idx
        from ..ops import ann as ann_ops
        field, _qv, k, _boost, similarity = self._knn_spec(bodies[0])
        qv = np.stack([self._knn_spec(b)[1] for b in bodies])
        pending = []
        for seg_ord, seg in enumerate(self.segments):
            if seg.vectors.get(field) is None:
                continue
            ann = ann_idx.ensure_ann_device(seg, field, similarity,
                                            self.device)
            if ann is None:
                pending.append((seg_ord, "exact", self._knn_exact_dispatch(
                    seg, field, qv, k, similarity)))
                continue
            ai, adev = ann
            dev = device_arrays(seg, self.device)["vec"][field]
            live = _device_live(seg, self.live[seg.seg_id], self.device)
            out = ann_ops.ivf_topk(
                dev["values"], dev["norms"], dev["exists"], live,
                adev["members"], adev["centroids"], adev["radii"],
                torch.from_numpy(qv).to(self.device),
                similarity=similarity, k=min(k, seg.capacity),
                nprobe=ann_idx.default_nprobe(ai.n_clusters))
            pending.append((seg_ord, "ivf", out))
        return {"pending": pending, "k": k, "host": None}

    def _knn_collect(self, body: dict, sub: dict, started: float,
                     with_partials: bool) -> dict:
        """Collect half: read the group's candidates (once, with its IVF
        counters), merge this row's across segments (score desc, then
        (segment, doc)), build the response."""
        group = sub["group"]
        if group["host"] is None:
            host = []
            for seg_ord, kind, out in group["pending"]:
                if kind == "ivf":
                    st = out[2].cpu().numpy()
                    _fused_stats.record_ann_prune(int(st[0]), int(st[1]),
                                                  int(st[2]))
                host.append((seg_ord, out[0].cpu().numpy(),
                             out[1].cpu().numpy()))
            group["host"] = host
        row = sub["row"]
        cands: list[tuple[float, int, int]] = []
        for seg_ord, scores, idx in group["host"]:
            s, ix = scores[row], idx[row]
            for j in range(s.shape[0]):
                if np.isfinite(s[j]):
                    cands.append((float(s[j]), seg_ord, int(ix[j])))
        cands.sort(key=lambda c: (-c[0], c[1], c[2]))
        return self._knn_build_response(body, cands[: group["k"]], started,
                                        with_partials)

    def _knn_search(self, body: dict, started: float,
                    with_partials: bool = False) -> dict:
        """The synchronous host path, for the shapes the device paths
        decline (knn_body_mode "host") and for readers with no
        segments: the exact scan per segment, combined here."""
        field, qv, k, _boost, similarity = self._knn_spec(body)
        cands: list[tuple[float, int, int]] = []
        for seg_ord, seg in enumerate(self.segments):
            if seg.vectors.get(field) is None:
                continue
            scores, idx = self._knn_exact_dispatch(seg, field, qv[None, :],
                                                   k, similarity)
            s = scores[0].cpu().numpy()
            ix = idx[0].cpu().numpy()
            for j in range(s.shape[0]):
                if np.isfinite(s[j]):
                    cands.append((float(s[j]), seg_ord, int(ix[j])))
        cands.sort(key=lambda c: (-c[0], c[1], c[2]))
        return self._knn_build_response(body, cands[:k], started,
                                        with_partials)

    def _knn_build_response(self, body: dict,
                            cands: list[tuple[float, int, int]],
                            started: float, with_partials: bool) -> dict:
        spec = body["knn"]
        k = int(spec.get("k", spec.get("num_candidates", 10)))
        knn_boost = float(spec.get("boost", 1.0))
        p = self._parse_request({kk: vv for kk, vv in body.items()
                                 if kk != "knn"})
        combined: dict[str, float] = {}
        locate: dict[str, tuple[int, int]] = {}
        for score, seg_ord, local in cands:
            did = self.segments[seg_ord].ids[local]
            combined[did] = score * knn_boost
            locate[did] = (seg_ord, local)
        if body.get("query"):
            qboost = 1.0
            sub = self.msearch([{"query": body["query"],
                                 "size": max(k, p["from"] + p["size"]),
                                 "_source": False}])[0]
            for h in sub["hits"]["hits"]:
                did = h["_id"]
                combined[did] = combined.get(did, 0.0) + \
                    (h["_score"] or 0.0) * qboost
                if did not in locate:
                    seg, local = self._locate(did)
                    if seg is not None:
                        locate[did] = (self.segments.index(seg), local)
        ranked = sorted(combined.items(), key=lambda kv: (-kv[1], kv[0]))
        window = ranked[p["from"]: p["from"] + p["size"]]
        hits = []
        for did, score in window:
            seg_ord, local = locate[did]
            seg = self.segments[seg_ord]
            hit = {"_index": self.index_name, "_type": "_doc",
                   "_id": did, "_score": float(score)}
            if p["want_version"]:
                hit["_version"] = int(seg.versions[local])
            if p["source_filter"] is not False:
                src = filter_source(_load_source(seg.sources[local]),
                                    p["source_filter"])
                if src is not None:
                    hit["_source"] = src
            hits.append(hit)
        resp = {
            "took": int((time.monotonic() - started) * 1000),
            "timed_out": False,
            "_shards": {"total": 1, "successful": 1, "failed": 0},
            "hits": {"total": len(ranked),
                     "max_score": ranked[0][1] if ranked else None,
                     "hits": hits},
        }
        if p["agg_specs"] and with_partials:
            resp["_agg_partials"] = {}
        return resp

    def _locate(self, doc_id: str) -> tuple[Segment | None, int]:
        for seg in self.segments:
            d = seg.id_map.get(doc_id)
            if d is not None and self.live[seg.seg_id][d]:
                return seg, d
        return None, -1

    # -- rescore -----------------------------------------------------------
    @staticmethod
    def _rescore_body(p: dict) -> dict:
        """The rescore query's search over the window."""
        spec = p["rescore"]
        return {"query": spec["query"],
                "size": max(spec["window_size"], p["from"] + p["size"]),
                "_source": False}

    def _apply_rescore(self, resp: dict, p: dict, sub: dict) -> None:
        """Query rescorer over the response window (ref:
        search/rescore/QueryRescorer.java): combine the original and the
        rescore query's scores (`sub`, the response of `_rescore_body`)
        of the window's docs, re-sort."""
        spec = p["rescore"]
        re_scores = {h["_id"]: h["_score"] for h in sub["hits"]["hits"]}
        w1, w2, mode = (spec["query_weight"], spec["rescore_query_weight"],
                        spec["score_mode"])
        for h in resp["hits"]["hits"]:
            orig = h.get("_score") or 0.0
            rs = re_scores.get(h["_id"])
            if rs is None:
                h["_score"] = orig * w1
            elif mode == "multiply":
                h["_score"] = (orig * w1) * (rs * w2)
            elif mode == "avg":
                h["_score"] = (orig * w1 + rs * w2) / 2.0
            elif mode == "max":
                h["_score"] = max(orig * w1, rs * w2)
            elif mode == "min":
                h["_score"] = min(orig * w1, rs * w2)
            else:  # total
                h["_score"] = orig * w1 + rs * w2
        resp["hits"]["hits"].sort(key=lambda h: -(h["_score"] or 0.0))
        if resp["hits"]["hits"]:
            resp["hits"]["max_score"] = resp["hits"]["hits"][0]["_score"]

    # -- internals ---------------------------------------------------------
    def _ords_for(self, specs: list[AggSpec]) -> dict:
        return {s.field: self.global_ords(s.field)
                for s in specs if s.kind in ("terms", "cardinality")}

    def _parse_request(self, body: dict, raw_query=None) -> dict:
        """`raw_query`: the body's query with its join nodes resolved
        (`_resolve_joins_all`)."""
        body = body or {}
        extra = sorted(set(body) - _REQUEST_KEYS)
        if extra:
            raise NotImplementedError(
                f"search request keys {extra} are not yet ported to "
                f"elasticsearch_tpu_torch")
        def doc_lookup(doc_id: str):
            seg, local = self._locate(doc_id)
            return (_load_source(seg.sources[local]) if seg is not None
                    else None)

        if raw_query is None:
            raw_query = body.get("query")
            if raw_query is not None and _has_join_nodes(raw_query):
                raw_query = self._resolve_joins_all([raw_query])[0]
        query = QueryParser(self.mappers, index_name=self.index_name,
                            doc_lookup=doc_lookup).parse(raw_query)
        all_specs = parse_aggs(body.get("aggs") or body.get("aggregations"))
        derived_specs = [s for s in all_specs if s.kind in DERIVED_KINDS]
        agg_specs = [s for s in all_specs if s.kind not in DERIVED_KINDS]
        for spec in agg_specs:
            if spec.kind in ("terms", "value_count"):
                spec.field = self._keyword_fallback(spec.field)
        size = int(body.get("size", 10))
        frm = int(body.get("from", 0))
        if size < 0 or frm < 0:
            raise SearchParseError("[from] and [size] must be >= 0")
        sort_spec = self._parse_sort(body.get("sort"))
        src = body.get("_source", True)
        stored_fields = body.get("fields")
        if isinstance(stored_fields, str):
            stored_fields = [stored_fields]
        if stored_fields is not None:
            # a fields list suppresses _source unless "_source" is listed
            # (ref: search/fetch/FieldsParseElement)
            if "_source" in stored_fields:
                stored_fields = [f for f in stored_fields if f != "_source"]
            elif "_source" not in body:
                src = False
        rescore = body.get("rescore")
        if isinstance(rescore, list):
            rescore = rescore[0] if rescore else None
        if rescore is not None:
            q = rescore.get("query") or {}
            rescore = {
                "window_size": int(rescore.get("window_size", 10)),
                "query": q.get("rescore_query"),
                "query_weight": float(q.get("query_weight", 1.0)),
                "rescore_query_weight": float(
                    q.get("rescore_query_weight", 1.0)),
                "score_mode": str(q.get("score_mode", "total")),
            }
            if rescore["query"] is None:
                raise SearchParseError("[rescore] requires [rescore_query]")
        nested_scope = body.get("_nested_scope")
        static_sig = (
            # precision_threshold keys the plan too (exact counts or the
            # HLL sketch); the percents / values of percentiles apply
            # per request at the reduce. The reference's key leaves out
            # both, and its batch-mates take the first request's
            # (ROADMAP Queue 3)
            tuple((s.name, s.kind, s.field, s.interval, s.size,
                   s.min_doc_count, s.order, s.precision_threshold,
                   tuple((m.name, m.kind, m.field) for m in s.sub_metrics))
                  for s in agg_specs),
            sort_spec, frm + size, bool(nested_scope),
        )
        return {"query": query, "agg_specs": agg_specs, "size": size,
                "from": frm, "sort_spec": sort_spec,
                "source_filter": src,
                "stored_fields": stored_fields,
                "static_sig": static_sig,
                "want_version": bool(body.get("version", False)),
                "rescore": rescore,
                "script_fields": self._parse_script_fields(
                    body.get("script_fields")),
                "derived_specs": derived_specs,
                "raw_query": raw_query,
                "nested_scope": nested_scope,
                "reverse_ctx": body.get("_reverse_ctx"),
                "dfs_stats": body.get("_dfs_stats")}

    def _parse_script_fields(self, spec) -> list:
        """script_fields -> [(name, CompiledScript, params)], evaluated
        on the host per hit (ref: search/fetch/script/
        ScriptFieldsParseElement)."""
        if not spec:
            return []
        from ..script import parse_script_spec, compile_script
        out = []
        for name, conf in spec.items():
            src, params = parse_script_spec(conf)
            out.append((name, compile_script(src), params))
        return out

    def _keyword_fallback(self, field: str) -> str:
        """Aggregating/sorting on a text field falls back to its .keyword
        multi-field twin when one exists."""
        fm = self.mappers.field(field)
        if fm is not None and fm.type == "text":
            twin = self.mappers.field(f"{field}.keyword")
            if twin is not None and twin.type == "keyword":
                return f"{field}.keyword"
        return field

    def _parse_sort(self, sort) -> tuple:
        """-> ("_score",) | ("field", name, descending, kindtag)."""
        if sort is None:
            return ("_score",)
        entries = sort if isinstance(sort, list) else [sort]
        if not entries:
            return ("_score",)
        if len(entries) > 1:
            raise NotImplementedError("multi-key sort is not yet ported")
        entry = entries[0]
        if isinstance(entry, str):
            fld, order = entry, "asc"
            if fld == "_score":
                return ("_score",)
        else:
            fld, spec = next(iter(entry.items()))
            if fld == "_score":
                return ("_score",)
            if fld in ("_geo_distance", "_geoDistance"):
                raise NotImplementedError(f"[{fld}] sort is not yet ported")
            if fld == "_script":
                # script sort (ref: search/sort/ScriptSortParser.java):
                # keys computed on the device from doc-value columns;
                # params baked into the tag, which keys the plan
                from ..script import parse_script_spec, compile_script
                from ..script.service import numeric_param
                src, sparams = parse_script_spec(spec)
                compile_script(src)
                ptag = ",".join(f"{k}={numeric_param(k, v)}"
                                for k, v in sorted(sparams.items()))
                order = str(spec.get("order", "asc")).lower() \
                    if isinstance(spec, dict) else "asc"
                return ("field", f"{src}\x00{ptag}", order == "desc",
                        "script")
            order = (spec.get("order", "asc") if isinstance(spec, dict)
                     else str(spec)).lower()
        fld = self._keyword_fallback(fld)
        kindtag = None
        for seg in self.segments:
            k = seg.field_kind(fld)
            if k == "keyword":
                kindtag = "kw"
            elif k == "numeric":
                kindtag = kindtag or "num"
            elif k == "text":
                raise NotImplementedError(
                    "sorting on an analyzed text field is not yet ported")
        if kindtag is None:
            fm = self.mappers.field(fld)
            if fm is None:
                raise SearchParseError(
                    f"No mapping found for [{fld}] in order to sort on")
            kindtag = "kw" if fm.type == "keyword" else "num"
        return ("field", fld, order == "desc", kindtag)

    def _build_response(self, p: dict, seg_tops: list, b: int, aggs: dict,
                        started: float,
                        sort_terms: list[str] | None = None) -> dict:
        is_score_sort = p["sort_spec"][0] == "_score"
        descending = True if is_score_sort else p["sort_spec"][2]
        cands = []
        total = 0
        for seg_ord, entry in enumerate(seg_tops):
            top_score, top_key, top_idx, tot, top_miss = entry[:5]
            total += int(tot[b])
            # pack-split entries (streaming delta path) carry a 6th
            # element: the per-row count of candidates that landed in
            # this segment's split of the merged top-k (its total alone
            # would over-read into the pad)
            n_valid = (int(entry[5][b]) if len(entry) > 5
                       else min(int(tot[b]), top_score.shape[1]))
            for j in range(n_valid):
                missing = bool(top_miss[b, j])
                cands.append((missing, float(top_key[b, j]), seg_ord,
                              int(top_idx[b, j]), float(top_score[b, j])))
        sign = -1.0 if descending else 1.0
        # missing-field docs sort last regardless of direction (ES _last)
        cands.sort(key=lambda c: (c[0], sign * c[1], c[2], c[3]))
        window = cands[p["from"]: p["from"] + p["size"]]

        hits = []
        max_score = None
        if is_score_sort and cands:
            max_score = cands[0][4] if cands[0][4] > -np.inf else None
        for missing, key, seg_ord, local_doc, score in window:
            seg = self.segments[seg_ord]
            hit = {
                "_index": self.index_name,
                "_type": "_doc",
                "_id": seg.ids[local_doc],
                "_score": score if is_score_sort else (score or None),
            }
            if not is_score_sort:
                if missing:
                    hit["sort"] = [None]
                elif sort_terms is not None:
                    hit["sort"] = [sort_terms[int(key)]]  # global ord -> term
                else:
                    hit["sort"] = [int(key) if float(key).is_integer()
                                   else key]
            if p["want_version"]:
                hit["_version"] = int(seg.versions[local_doc])
            src = p["source_filter"]
            if src is not False:
                filtered = filter_source(_load_source(seg.sources[local_doc]),
                                         src)
                if filtered is not None:
                    hit["_source"] = filtered
            if p["stored_fields"]:
                # stored fields load from _source (every field is
                # source-backed; ref: FetchPhase fieldsVisitor)
                source = _load_source(seg.sources[local_doc])
                flds = {}
                for f in p["stored_fields"]:
                    v = source.get(f)
                    if v is None and "." in f:
                        # a dotted path into (nested) objects
                        cur = source
                        for part in f.split("."):
                            cur = (cur.get(part)
                                   if isinstance(cur, dict) else None)
                            if cur is None:
                                break
                        v = cur
                    if v is not None:
                        flds[f] = v if isinstance(v, list) else [v]
                if flds:
                    hit["fields"] = flds
            if p["script_fields"]:
                from ..script import run_field_script
                sf = hit.setdefault("fields", {})
                for name, cs, sparams in p["script_fields"]:
                    sf[name] = [run_field_script(cs, seg, local_doc, sparams,
                                                 score=score)]
            hits.append(hit)

        resp = {
            "took": int((time.monotonic() - started) * 1000),
            "timed_out": False,
            "_shards": {"total": 1, "successful": 1, "failed": 0},
            "hits": {"total": total, "max_score": max_score, "hits": hits},
        }
        if aggs:
            resp["aggregations"] = aggs
        return resp

    def _empty_response(self, p: dict, started: float,
                        with_partials: bool = False) -> dict:
        resp = {
            "took": int((time.monotonic() - started) * 1000),
            "timed_out": False,
            "_shards": {"total": 1, "successful": 1, "failed": 0},
            "hits": {"total": 0, "max_score": None, "hits": []},
        }
        if p["agg_specs"]:
            if with_partials:
                resp["_agg_partials"] = {}
            else:
                resp["aggregations"] = finalize_partials(p["agg_specs"], {})
        return resp


def filter_source(source: dict, spec) -> dict | None:
    """_source filtering: True/False, "field", [fields], or
    {"includes": [...], "excludes": [...]} with * wildcards."""
    if isinstance(source, dict) and "_ttl_expiry" in source:
        source = {k: v for k, v in source.items() if k != "_ttl_expiry"}
    if spec is True:
        return source
    if spec is False:
        return None
    if isinstance(spec, (str, list)):
        includes = [spec] if isinstance(spec, str) else list(spec)
        excludes = []
    else:
        includes = spec.get("includes") or spec.get("include") or []
        excludes = spec.get("excludes") or spec.get("exclude") or []
        if isinstance(includes, str):
            includes = [includes]
        if isinstance(excludes, str):
            excludes = [excludes]

    import fnmatch

    def keep(path: str) -> bool:
        if includes and not any(fnmatch.fnmatch(path, p)
                                or p.startswith(path + ".")
                                or path.startswith(p + ".")
                                for p in includes):
            return False
        if any(fnmatch.fnmatch(path, p)
               or path.startswith(p + ".") for p in excludes):
            return False
        return True

    def walk(obj: dict, prefix: str) -> dict:
        out = {}
        for k, v in obj.items():
            path = f"{prefix}{k}"
            if isinstance(v, dict):
                sub = walk(v, f"{path}.")
                if sub or keep(path):
                    out[k] = sub
            elif keep(path):
                out[k] = v
        return out

    return walk(source, "")


_JOIN_NODE_KEYS = ("has_child", "has_parent", "parent_id")


def _has_join_nodes(q) -> bool:
    if isinstance(q, dict):
        return any(k in _JOIN_NODE_KEYS or _has_join_nodes(v)
                   for k, v in q.items())
    if isinstance(q, list):
        return any(_has_join_nodes(x) for x in q)
    return False


def _load_source(raw: bytes) -> dict:
    if not raw:
        return {}
    return json.loads(raw)


def _default_live(seg: Segment) -> np.ndarray:
    live = np.zeros(seg.capacity, dtype=bool)
    live[: seg.num_docs] = True
    return live
