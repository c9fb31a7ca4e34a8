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

Trimmed to this slice: request keys outside `query`, `knn`, `rescore`,
`aggs` / `aggregations`, `size`, `from`, `sort` (one key: `_score`, a
keyword or a numeric field), `_source`, `version` and `_dfs_stats` raise
NotImplementedError, as do multi-key sorts, highlight, suggest and
derived aggs.
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
from .aggregations import (AggSpec, ShardAggContext, finalize_partials,
                           parse_aggs, reduce_aggs, shard_partials)
from ..ops.knn import SIMILARITIES
from .executor import (QueryBinder, _device_live, _fused_stats,
                       collect_pack_result, collect_segment_result,
                       device_arrays, ensure_agg_views, execute_pack_async,
                       execute_segment_async)
from .query_dsl import QueryParser

_REQUEST_KEYS = frozenset(("query", "aggs", "aggregations", "size", "from",
                           "sort", "_source", "version", "_dfs_stats",
                           "rescore"))


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
        self.live = {}
        for s in self.segments:
            la = np.array(live_masks.get(s.seg_id, _default_live(s)),
                          dtype=bool, copy=True)
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
                h.update(self.live[seg.seg_id].tobytes())
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
        parsed = {i: self._parse_request(bodies[i])
                  for i in range(n) if i not in knn_set}
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
                            dfs=p["dfs_stats"]).bind(p["query"])
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
            pending = []
            # streaming write path: a (base, delta) pair serves a
            # fused-admitted plan in ONE dispatch (the delta walk chains
            # onto the base's running top-k); inadmissible plans fall
            # back to the per-segment dispatches below
            if len(self.segments) == 2 \
                    and self.segments[1].delta_parent is not None \
                    and _pack_dispatch_enabled():
                b_seg, d_seg = self.segments
                pack = execute_pack_async(
                    b_seg, d_seg, self.live[b_seg.seg_id],
                    self.live[d_seg.seg_id],
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
                        seg, self.live[seg.seg_id], bounds, k,
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
                part_json = None
                agg_json = reduce_aggs(p0["agg_specs"], agg_ctx, partials,
                                       len(idxs))
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
        return responses  # type: ignore[return-value]

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
                for s in specs if s.kind == "terms"}

    def _parse_request(self, body: dict) -> dict:
        body = body or {}
        extra = sorted(set(body) - _REQUEST_KEYS)
        if extra:
            raise NotImplementedError(
                f"search request keys {extra} are not yet ported to "
                f"elasticsearch_tpu_torch")
        query = QueryParser(self.mappers).parse(body.get("query"))
        agg_specs = parse_aggs(body.get("aggs") or body.get("aggregations"))
        for spec in agg_specs:
            if spec.kind in ("terms", "value_count"):
                spec.field = self._keyword_fallback(spec.field)
        size = int(body.get("size", 10))
        frm = int(body.get("from", 0))
        if size < 0 or frm < 0:
            raise SearchParseError("[from] and [size] must be >= 0")
        sort_spec = self._parse_sort(body.get("sort"))
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
        static_sig = (
            tuple((s.name, s.kind, s.field, s.interval, s.size,
                   s.min_doc_count, s.order,
                   tuple((m.name, m.kind, m.field) for m in s.sub_metrics))
                  for s in agg_specs),
            sort_spec, frm + size,
        )
        return {"query": query, "agg_specs": agg_specs, "size": size,
                "from": frm, "sort_spec": sort_spec,
                "source_filter": body.get("_source", True),
                "static_sig": static_sig,
                "want_version": bool(body.get("version", False)),
                "rescore": rescore,
                "dfs_stats": body.get("_dfs_stats")}

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
            if fld in ("_geo_distance", "_geoDistance", "_script"):
                raise NotImplementedError(f"[{fld}] sort is not yet ported")
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


def _load_source(raw: bytes) -> dict:
    if not raw:
        return {}
    return json.loads(raw)


def _default_live(seg: Segment) -> np.ndarray:
    live = np.zeros(seg.capacity, dtype=bool)
    live[: seg.num_docs] = True
    return live
