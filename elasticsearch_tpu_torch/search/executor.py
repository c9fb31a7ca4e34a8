"""Per-segment query execution: bind -> device evaluation -> top-k + aggs.

Counterpart of `elasticsearch_tpu/search/executor.py`, its unfused path
and the fused block-max bundle engine. Execution has the reference's two
steps:

  * bind (host): resolve terms against the segment dictionary to block
    ranges / ordinals / bounds, producing a hashable static `desc` tree
    plus numpy param arrays; structurally identical queries batch into
    one evaluation (leading dim B). `QueryBinder`, `finalize` and
    `_finalize_node` are the reference's code, trimmed to this slice's
    queries.
  * evaluate (device): a score-sorted plan that `_fused_plan_bundle`
    admits (a bare match/term/phrase/span/cross_fields leaf, or a bool
    over dense text and positional clauses with range filter/must_not
    clauses, with or without aggs, size 0 included) runs on the fused
    bundle engine: `eval_fused_topk` /
    `eval_fused_match` call `ops/cuda_scoring.fused_topk_bundle` /
    `match_mask_bundle`, the hand-written kernel K3, which never builds
    the [B, cap] score matrix. Every other plan runs the `desc`
    interpreter `eval_node` into dense [B, cap] scores and match masks,
    then top-k (`ops/topk`); aggregations go through `eval_aggs`
    (`ops/aggs`) on either path. `ES_TPU_FUSED=0` (the reference's
    switch, read the same way) sends every plan down the unfused path.
    PyTorch runs eagerly, so the reference's jit, packed wire format and
    compile caches have no counterpart: dispatch enqueues work on the
    current CUDA stream and `collect_segment_result` synchronises with
    one device-to-host copy per dtype.

Text clauses of the unfused path run on the hand-written kernels of
`ops/cuda_scoring`: `term_text` / `terms_dense` on `dense_score`,
`term_text_sc` / `terms_fused` / `docs_w` on `scatter_add`, and the
positional kinds (phrase / span / BM25F) on `positional_leaf`, the
unfused entry of K3's positional leaf. Positional queries the fused
kinds do not cover (phrase prefix, span_or / span_first / span_not,
nested span trees, fields without a positions pack, other similarities,
`ES_TPU_POSITIONAL=0`) bind on the host oracle `search/phrase.py` to a
`docs_w` posting list, counted by reason.

Two more dispatch forms serve fused plans. A reader over a (base, delta)
pair of the streaming write path searches both in one dispatch
(`execute_pack_async`: the delta walk chained onto the base's top-k,
collected back into per-segment lists). With `ES_TPU_RESIDENT_LOOP` set,
fused plans go through pinned resident entries (`search/resident.py`)
that run the stepped K3 walk with a per-chunk deadline check.

Vectors. A `knn` query node binds to the `knn_vec` kind: the similarity
column of `ops/knn.knn_score_column` (bf16 values resident on the
device, f32 norms) times the clause boost, matching every doc with a
vector. Unfused it is an eval_node leaf; in a bool beside a text clause
it is a bundle clause of K3 (`knn_vec`), whose per-tile bound is the
column's exact tile max (`_vec_clause_inputs`). The reference serves
such hybrid bundles on its XLA engine only (its Pallas kernel rejects
them as `knn_clause`); the port has one engine, K3, so they run there,
and a plan that K3 cannot take raises rather than falling back. The
fused engine's backend autotuner and tiering are not ported yet.
Uploaded columns and resident entries hold their bytes against the
fielddata breaker (`utils/breaker.py`).
"""

from __future__ import annotations

import math
import os
import threading
import time
import weakref
from dataclasses import dataclass, field as dc_field
from typing import Any, Sequence

import numpy as np
import torch

from ..index.mapping import (MapperService, parse_date_millis, parse_ip,
                             MapperParsingError, DATE, BOOLEAN, IP)
from ..index.segment import (Segment, next_pow2, bm25_idf,
                             build_tile_minmax, BM25_B, BM25_K1,
                             POS_MAX_ENC)
from ..ops import aggs as agg_ops
from ..ops import cuda_scoring, ordered
from ..ops.knn import SIMILARITIES as _KNN_SIMILARITIES, knn_score_column
# fused positional clause caps: n rides in the clause kind string
# (phrase_pos:{n}:..., bm25f:{nf}:{nt}); wider shapes take the host path
from ..ops.cuda_scoring import (POS_MAX_FIELDS as _POS_FIELDS_MAX,
                                POS_MAX_TERMS as _POS_CLAUSE_TERMS_MAX)
from ..ops.scoring import (DENSE_CLAUSE_KINDS, RANGE_CLAUSE_KINDS,
                           VEC_CLAUSE_KINDS, bm25f_kind, bundle_num_fields,
                           bundle_primary_field, bundle_text_fields,
                           clause_fields, parse_positional_kind,
                           phrase_kind, positional_prefix, score_term,
                           score_terms_fused, slack_bound, span_kind)
from ..ops.topk import (running_topk_init, top_k_hits, top_k_by_field,
                        top_k_values)
from ..utils.breaker import breaker_service
from ..utils.errors import (CircuitBreakingError, QueryParsingError,
                            SearchParseError, SearchTimeoutError)
from . import resident as _resident
from .query_dsl import (Query, MatchAllQuery, MatchNoneQuery, TermQuery,
                        RangeQuery, PrefixQuery, BoolQuery,
                        ConstantScoreQuery, KnnQuery)

_F32_MIN_WEIGHT = 1e-30  # keeps score>0 as the match signal even at boost~0
_DENSE_GROUP_MAX = 8     # should-groups up to this many terms take the
                         # forward-index gather path instead of scatter
_I32_MAX = 2 ** 31 - 1


# ---------------------------------------------------------------------------
# Device view of a segment
# ---------------------------------------------------------------------------


def _up(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def device_arrays(segment: Segment, device: torch.device) -> dict:
    """Upload (once per device) and return the segment's device columns:
    int32 / float32 / bool tensors exactly as the numpy columns hold
    them: the columns the unfused path reads, plus each forward-indexed
    field's block-max summary `tile_max` for the fused engine and the
    positional pack (`fwd_pos` int16, `k1ln` / `lnorm` f32) where the
    field has one, and per vector field its values in bf16 (the
    reference's residency: the product reads bf16 anyway), f32 norms and
    the exists mask.

    Numeric `values` / `mv_values` are the values as XLA's arithmetic
    and compares see them, subnormals flushed to zeros of their sign
    (`ops/ordered.ftz`); a float column that holds a subnormal also gets
    `sort_values`, the values as stored, which field sorts read (a sort
    moves values and keeps them).

    The upload is accounted against the fielddata breaker and released
    when the segment is garbage collected, as the reference does."""
    cached = getattr(segment, "_device", None)
    if cached is not None and cached[0] == device:
        return cached[1]
    old_hold = getattr(segment, "_breaker_hold", None)
    hold = breaker_service().breaker("fielddata").hold(segment.nbytes())
    if old_hold is not None:        # a re-upload to another device
        old_hold.release()
    weakref.finalize(segment, hold.release)
    segment._breaker_hold = hold  # type: ignore[attr-defined]
    dev = {
        "_device": device,
        "text": {
            name: {
                "block_docs": _up(pf.block_docs, device),
                "block_imps": _up(pf.block_imps, device),
                **({"fwd_tids": _up(pf.fwd_tids, device),
                    "fwd_imps": _up(pf.fwd_imps, device)}
                   if pf.fwd_tids is not None else {}),
                **({"tile_max": _up(pf.tile_max, device)}
                   if pf.tile_max is not None else {}),
                **({"fwd_pos": _up(pf.fwd_pos, device),
                    "k1ln": _up(pf.k1ln, device),
                    "lnorm": _up(pf.lnorm, device)}
                   if pf.fwd_pos is not None else {}),
            }
            for name, pf in segment.text.items()
        },
        "kw": {name: _up(kc.ords, device)
               for name, kc in segment.keywords.items()},
        "kw_mv": {name: _up(kc.mv_ords, device)
                  for name, kc in segment.keywords.items()
                  if kc.mv_ords is not None},
        "num": {name: _num_column(nc, device)
                for name, nc in segment.numerics.items()},
        "vec": {name: {"values": _up(ordered.ftz_np(vc.values), device)
                       .to(torch.bfloat16),
                       "exists": _up(vc.exists, device),
                       "norms": _up(ordered.ftz_np(vc.norms), device)}
                for name, vc in segment.vectors.items()},
    }
    segment._device = (device, dev)  # type: ignore[attr-defined]
    return dev


def release_device_arrays(segment: Segment) -> None:
    """Drop a segment's device columns and give back their fielddata
    hold now, not at garbage collection: a closed engine or a contained
    shard serves the segment no more. A reader that still holds the
    segment (a scroll context) uploads it again at its next search."""
    hold = getattr(segment, "_breaker_hold", None)
    if hold is not None:
        hold.release()
    for entry in (getattr(segment, "_ann_device", None) or {}).values():
        entry["_breaker_hold"].release()
    for attr in ("_device", "_live_dev", "_live_view_cache", "_ann_device"):
        segment.__dict__.pop(attr, None)


def _num_column(nc, device: torch.device) -> dict:
    vals = ordered.ftz_np(nc.values)
    col = {"values": _up(vals, device), "exists": _up(nc.exists, device)}
    if vals is not nc.values:
        col["sort_values"] = _up(nc.values, device)
    if nc.mv_values is not None:
        col["mv_values"] = _up(ordered.ftz_np(nc.mv_values), device)
        col["mv_exists"] = _up(nc.mv_exists, device)
    return col


def _f32_flushed(v: float) -> float:
    """A float bound as XLA's compares see it: a value that is subnormal
    in f32 becomes a zero of its sign; others are kept as given."""
    f = np.float32(v)
    if f != 0 and abs(f) < np.float32(ordered.F32_TINY):
        return math.copysign(0.0, float(v))
    return v


def _host_perms(segment: Segment) -> dict:
    hp = getattr(segment, "_host_perms", None)
    if hp is None:
        hp = {}
        segment._host_perms = hp  # type: ignore[attr-defined]
    return hp


def _host_extrema(segment: Segment, field: str):
    """Per-segment host cache of build_tile_minmax; None when the column
    cannot carry extrema (absent, multi-valued, degenerate tile grid)."""
    cache = getattr(segment, "_host_tile_minmax", None)
    if cache is None:
        cache = {}
        segment._host_tile_minmax = cache  # type: ignore[attr-defined]
    if field not in cache:
        nc = segment.numerics.get(field)
        cache[field] = (None if nc is None or nc.mv_values is not None
                        else build_tile_minmax(ordered.ftz_np(nc.values),
                                               nc.exists,
                                               segment.capacity))
    return cache[field]


def ensure_num_tiles(segment: Segment, field: str,
                     device: torch.device) -> bool:
    """Lazily build + upload the per-tile [lo, hi] extrema of a
    single-valued numeric column, the prune input of fused range filter
    clauses. Returns False when the column cannot carry extrema."""
    nc = segment.numerics.get(field)
    if nc is None or nc.mv_values is not None:
        return False
    entry = device_arrays(segment, device)["num"].get(field)
    if entry is None:
        return False
    if "tile_lo" in entry:
        return True
    mm = _host_extrema(segment, field)
    if mm is None:
        return False
    entry["tile_lo"] = _up(mm[0], device)
    entry["tile_hi"] = _up(mm[1], device)
    return True


def ensure_kw_sorted(segment: Segment, field: str,
                     device: torch.device) -> None:
    """Lazily upload the ordinal-sort permutation + group boundaries for
    a keyword column (scatter-free terms aggregation)."""
    dev = device_arrays(segment, device)
    if field in dev.get("kw_sorted", {}):
        return
    kc = segment.keywords.get(field)
    if kc is None:
        return
    perm = np.argsort(kc.ords, kind="stable").astype(np.int32)
    sorted_ords = kc.ords[perm]
    starts = np.searchsorted(
        sorted_ords, np.arange(kc.cardinality + 1)).astype(np.int32)
    _host_perms(segment)[("kw", field)] = perm
    dev.setdefault("kw_sorted", {})[field] = {
        "perm": _up(perm, device), "starts": _up(starts, device)}


def ensure_num_sorted(segment: Segment, field: str,
                      device: torch.device) -> None:
    """Lazily upload the value-sort permutation for a single-valued
    numeric column (missing docs sort last via the dtype max sentinel)."""
    dev = device_arrays(segment, device)
    if field in dev.get("num_sorted", {}):
        return
    nc = segment.numerics.get(field)
    if nc is None or nc.mv_values is not None:
        return
    vals = nc.values.copy()
    sentinel = (np.iinfo(np.int32).max if vals.dtype == np.int32
                else np.float32(np.inf))
    vals[~nc.exists] = sentinel
    perm = np.argsort(vals, kind="stable").astype(np.int32)
    _host_perms(segment)[("num", field)] = perm
    dev.setdefault("num_sorted", {})[field] = {
        "perm": _up(perm, device),
        "vals": _up(ordered.ftz_np(vals[perm]), device),
        "sexists": _up(nc.exists[perm], device)}


# ---------------------------------------------------------------------------
# Sorted-space query views: for view-compatible queries (elementwise
# column predicates), the filter columns are projected into each agg
# layout's sort order and the query desc is re-evaluated there, so the
# agg mask never rides a per-query permutation gather.
# ---------------------------------------------------------------------------

_VIEW_KW_KINDS = ("term_kw", "ord_set", "range_kw")
_VIEW_NUM_KINDS = ("term_num", "range_int", "range_f32")


def _bound_view_fields(bound: "Bound", kw: set, num: set) -> bool:
    """True if every node of `bound` is view-compatible, collecting the
    kw/num fields its mask evaluation reads."""
    k = bound.kind
    if k in ("none", "match_all"):
        return True
    if k in _VIEW_KW_KINDS:
        kw.add(bound.field)
        return True
    if k in _VIEW_NUM_KINDS:
        num.add(bound.field)
        return True
    if k == "bool":
        return all(_bound_view_fields(c, kw, num)
                   for grp in ("must", "should", "must_not", "filter")
                   for c in bound.children[grp])
    if k == "const":
        return _bound_view_fields(bound.children["q"][0], kw, num)
    return False


def ensure_agg_views(segment: Segment, bound: "Bound", agg_desc: tuple,
                     device: torch.device) -> None:
    """Project the filter columns `bound` references into the sort order
    of every agg layout `agg_desc` uses on this segment (plus the
    sub-metric source columns); no-op for non-view-compatible queries."""
    kw_f: set = set()
    num_f: set = set()
    if not _bound_view_fields(bound, kw_f, num_f):
        return
    dev = device_arrays(segment, device)
    perms = _host_perms(segment)
    for _name, node in agg_desc:
        kind = node[0]
        if kind == "terms_kw":
            lkind, lfield, subs = "kw", node[1], node[3]
        elif kind in ("hist_fixed", "hist_edges"):
            lkind, lfield, subs = "num", node[1], node[3]
        else:
            continue
        store_name = "kw_sorted" if lkind == "kw" else "num_sorted"
        store = dev.get(store_name, {}).get(lfield)
        perm = perms.get((lkind, lfield))
        if store is None or perm is None:
            continue
        need_num = num_f | {f for _n, f, mk in subs
                            if mk in ("avg", "sum", "value_count")}
        vw_num = store.setdefault("vw_num", {})
        for f in need_num:
            nc = segment.numerics.get(f)
            if nc is None or f in vw_num:
                continue
            col = {"values": _up(ordered.ftz_np(nc.values[perm]), device),
                   "exists": _up(nc.exists[perm], device)}
            if nc.mv_values is not None:
                col["mv_values"] = _up(ordered.ftz_np(nc.mv_values[perm]),
                                       device)
                col["mv_exists"] = _up(nc.mv_exists[perm], device)
            vw_num[f] = col
        vw_kw = store.setdefault("vw_kw", {})
        vw_kw_mv = store.setdefault("vw_kw_mv", {})
        for f in kw_f:
            kc = segment.keywords.get(f)
            if kc is None or f in vw_kw:
                continue
            vw_kw[f] = _up(kc.ords[perm], device)
            if kc.mv_ords is not None:
                vw_kw_mv[f] = _up(kc.mv_ords[perm], device)


def _desc_view_ok(desc: tuple, store: dict, seg: dict) -> bool:
    """Can `desc`'s match mask be evaluated against the projections in
    `store`? (Multi-valued sidecar presence must mirror the doc-space
    column so eval_node takes the same branch.)"""
    kind = desc[0]
    if kind in ("none", "match_all"):
        return True
    if kind in _VIEW_KW_KINDS:
        f = desc[1]
        return (f in store.get("vw_kw", {})
                and ((f in seg.get("kw_mv", {}))
                     == (f in store.get("vw_kw_mv", {}))))
    if kind in _VIEW_NUM_KINDS:
        f = desc[1]
        col = store.get("vw_num", {}).get(f)
        if col is None:
            return False
        return ("mv_values" in seg["num"].get(f, {})) == ("mv_values" in col)
    if kind == "bool":
        _, must, should, must_not, filt = desc
        return all(_desc_view_ok(d, store, seg)
                   for grp in (must, should, must_not, filt) for d in grp)
    if kind == "const":
        return _desc_view_ok(desc[1], store, seg)
    return False


def _sub_view_ok(store: dict, seg: dict, mfield: str, mkind: str) -> bool:
    if mfield not in seg["num"]:
        return True  # column absent from segment: empty metric either way
    if mkind not in ("avg", "sum", "value_count"):
        return False  # min/max/stats keep the doc-space path
    col = store.get("vw_num", {}).get(mfield)
    return col is not None and "mv_values" not in col \
        and "mv_values" not in seg["num"][mfield]


def _agg_view_plan(desc: tuple, agg_desc: tuple, agg_params: tuple,
                   seg: dict, live_views: dict) -> tuple:
    """Per-agg-node decision: evaluate in sorted view space?"""
    plan = []
    for (_name, node), params in zip(agg_desc, agg_params):
        kind = node[0]
        ok = False
        if kind == "terms_kw":
            _, field, _n_global, subs, _top_s = node
            store = seg.get("kw_sorted", {}).get(field)
            if (store is not None and ("kw", field) in live_views
                    and field in seg["kw"]
                    and field not in seg.get("kw_mv", {})
                    and store["starts"].shape[0] - 1 == params[0].shape[0]
                    and _desc_view_ok(desc, store, seg)):
                ok = all(_sub_view_ok(store, seg, f, mk)
                         for _n, f, mk in subs)
        elif kind in ("hist_fixed", "hist_edges"):
            field, subs = node[1], node[3]
            store = seg.get("num_sorted", {}).get(field)
            col = seg["num"].get(field)
            if (store is not None and ("num", field) in live_views
                    and col is not None and "mv_values" not in col
                    and "sexists" in store
                    and _desc_view_ok(desc, store, seg)):
                ok = all(_sub_view_ok(store, seg, f, mk)
                         for _n, f, mk in subs)
        plan.append(ok)
    return tuple(plan)


class _ViewMasks:
    """Lazily evaluates (and caches) the query's valid mask in each agg
    layout's sorted space: eval_node against projected columns, ANDed
    with the layout-permuted live mask."""

    def __init__(self, desc, params, seg, live_views, cap, B):
        self.desc = desc
        self.params = params
        self.seg = seg
        self.live_views = live_views
        self.cap = cap
        self.B = B
        self._cache: dict = {}

    def mask(self, key: tuple) -> torch.Tensor:
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        lkind, lfield = key
        store_name = "kw_sorted" if lkind == "kw" else "num_sorted"
        store = self.seg[store_name][lfield]
        view_seg = {**self.seg,
                    "kw": store.get("vw_kw", {}),
                    "kw_mv": store.get("vw_kw_mv", {}),
                    "num": store.get("vw_num", {}),
                    "text": {}}
        _, match = eval_node(self.desc, self.params, view_seg,
                             self.cap, self.B)
        vm = match & self.live_views[key][None, :]
        self._cache[key] = vm
        return vm


# ---------------------------------------------------------------------------
# Bound query tree (host-side intermediate; finalize() -> desc + params)
# ---------------------------------------------------------------------------


@dataclass
class Bound:
    kind: str
    field: str | None = None
    scalars: dict[str, float | int] = dc_field(default_factory=dict)
    arrays: dict[str, np.ndarray] = dc_field(default_factory=dict)
    children: dict[str, list["Bound"]] = dc_field(default_factory=dict)

    def signature(self) -> tuple:
        return (
            self.kind, self.field,
            tuple(sorted(self.arrays)),
            tuple((g, tuple(c.signature() for c in cs))
                  for g, cs in sorted(self.children.items())),
        )


class QueryBinder:
    """Resolves a query AST against ONE segment (Lucene query rewrite +
    Weight creation per IndexReader)."""

    def __init__(self, segment: Segment, mapper: MapperService,
                 live: np.ndarray | None = None,
                 dfs: dict | None = None):
        self.seg = segment
        self.mappers = mapper
        self.live = live
        # {"field\x00term": [global_df, global_N]} from the DFS pre-phase
        self.dfs = dfs

    def _dfs_ratio(self, field: str, term: str, df_local: float,
                   n_local: float) -> float:
        """Scale turning a locally idf'd eager impact into the globally
        idf'd score, from the field's Similarity (idf_global / idf_local
        for BM25)."""
        if not self.dfs:
            return 1.0
        entry = self.dfs.get(f"{field}\x00{term}")
        if not entry or entry[1] <= 0:
            return 1.0
        sim = self.mappers.similarity_for(field)
        return sim.df_scale(df_local, n_local,
                            float(entry[0]), float(entry[1]))

    def bind(self, q: Query) -> Bound:
        m = getattr(self, f"_bind_{type(q).__name__}", None)
        if m is None:
            raise QueryParsingError(
                f"unsupported query node [{type(q).__name__}]")
        return m(q)

    # -- leaves ------------------------------------------------------------

    def _no_match(self) -> Bound:
        return Bound("none")

    def _bind_MatchAllQuery(self, q: MatchAllQuery) -> Bound:
        return Bound("match_all", scalars={"boost": q.boost})

    def _bind_MatchNoneQuery(self, q: MatchNoneQuery) -> Bound:
        return self._no_match()

    def _term_text(self, field: str, term: str, boost: float) -> Bound:
        pf = self.seg.text.get(field)
        if pf is None:
            return self._no_match()
        t = pf.lookup(term)
        if t < 0:
            lo, nb = 0, 0
        else:
            lo = int(pf.block_start[t])
            nb = int(pf.block_start[t + 1]) - lo
            if self.dfs:
                # the global-df ratio goes on the clause boost, in the
                # reference's op order (one f32 weight per clause)
                boost = boost * self._dfs_ratio(
                    field, term, float(pf.df[t]), float(pf.doc_count))
        kind = "term_text" if pf.fwd_tids is not None else "term_text_sc"
        return Bound(kind, field,
                     scalars={"block_lo": lo, "nb": nb, "tid": t,
                              "weight": max(boost, _F32_MIN_WEIGHT)})

    def _terms_text_expanded(self, field: str, term_ids: Sequence[int],
                             boost: float) -> Bound:
        """Multi-term expansion as one fused gather: absolute block
        indices of all expanded terms."""
        pf = self.seg.text[field]
        blocks: list[int] = []
        for t in term_ids:
            blocks.extend(range(int(pf.block_start[t]),
                                int(pf.block_start[t + 1])))
        return Bound("terms_fused", field,
                     scalars={"weight": max(boost, _F32_MIN_WEIGHT)},
                     arrays={"blocks": np.asarray(blocks, dtype=np.int32)})

    def _bind_TermQuery(self, q: TermQuery) -> Bound:
        kind = self.seg.field_kind(q.field)
        if kind == "text":
            # term queries are NOT analyzed: exact term lookup
            return self._term_text(q.field, str(q.value), q.boost)
        if kind == "keyword":
            kc = self.seg.keywords[q.field]
            o = kc.lookup(str(q.value))
            score = 0.0
            if o >= 0:
                # keyword fields carry no norms: BM25 degenerates to idf
                score = float(bm25_idf(float(kc.df[o]), self.seg.num_docs))
                if self.dfs:
                    entry = self.dfs.get(f"{q.field}\x00{q.value}")
                    if entry and entry[1] > 0:
                        score = float(bm25_idf(float(entry[0]),
                                               float(entry[1])))
            return Bound("term_kw", q.field,
                         scalars={"ord": o, "score": max(score * q.boost,
                                                         _F32_MIN_WEIGHT)})
        if kind == "numeric":
            nc = self.seg.numerics[q.field]
            try:
                if nc.kind == DATE:
                    v = parse_date_millis(q.value) // 1000
                elif nc.kind == BOOLEAN:
                    v = 1 if (q.value in (True, "true", "1", 1)) else 0
                elif nc.kind == IP:
                    v = parse_ip(q.value) - nc.bias
                else:
                    v = (_f32_flushed(float(q.value))
                         if nc.values.dtype == np.float32
                         else int(q.value))
            except (ValueError, TypeError, MapperParsingError):
                return self._no_match()
            return Bound("term_num", q.field,
                         scalars={"value": v,
                                  "score": max(q.boost, _F32_MIN_WEIGHT)})
        return self._no_match()

    def _bind_RangeQuery(self, q: RangeQuery) -> Bound:
        kind = self.seg.field_kind(q.field)
        if kind == "numeric":
            nc = self.seg.numerics[q.field]
            is_int = nc.values.dtype == np.int32

            def conv(v):
                if v is None:
                    return None
                try:
                    if nc.kind == DATE:
                        return (parse_date_millis(v) // 1000
                                if not isinstance(v, bool) else None)
                    if nc.kind == IP:
                        return parse_ip(v) - nc.bias
                    return float(v)
                except Exception:
                    raise QueryParsingError(
                        f"failed to parse range bound [{v}] on [{q.field}]")

            i32 = np.iinfo(np.int32)
            lo, hi = conv(q.gte), conv(q.lte)
            lo_x, hi_x = conv(q.gt), conv(q.lt)
            if is_int:
                lo_i = i32.min if lo is None and lo_x is None else int(
                    math.ceil(lo) if lo is not None else math.floor(lo_x) + 1)
                hi_i = i32.max if hi is None and hi_x is None else int(
                    math.floor(hi) if hi is not None else math.ceil(hi_x) - 1)
                lo_i = max(min(lo_i, i32.max), i32.min)
                hi_i = max(min(hi_i, i32.max), i32.min)
                return Bound("range_int", q.field,
                             scalars={"lo": lo_i, "hi": hi_i,
                                      "boost": q.boost})
            lo_f = -np.inf if lo is None and lo_x is None else (
                lo if lo is not None
                else np.nextafter(np.float32(lo_x), np.float32(np.inf)))
            hi_f = np.inf if hi is None and hi_x is None else (
                hi if hi is not None
                else np.nextafter(np.float32(hi_x), np.float32(-np.inf)))
            return Bound("range_f32", q.field,
                         scalars={"lo": float(_f32_flushed(lo_f)),
                                  "hi": float(_f32_flushed(hi_f)),
                                  "boost": q.boost})
        if kind == "keyword":
            kc = self.seg.keywords[q.field]
            terms = kc.terms
            lo_o = 0
            hi_o = len(terms) - 1
            if q.gte is not None:
                lo_o = int(np.searchsorted(terms, str(q.gte), side="left"))
            elif q.gt is not None:
                lo_o = int(np.searchsorted(terms, str(q.gt), side="right"))
            if q.lte is not None:
                hi_o = int(np.searchsorted(terms, str(q.lte),
                                           side="right")) - 1
            elif q.lt is not None:
                hi_o = int(np.searchsorted(terms, str(q.lt), side="left")) - 1
            return Bound("range_kw", q.field,
                         scalars={"lo": lo_o, "hi": hi_o, "boost": q.boost})
        return self._no_match()

    def _expand_terms(self, field: str, pred, boost: float,
                      max_expansions: int) -> Bound:
        kind = self.seg.field_kind(field)
        if kind == "text":
            pf = self.seg.text[field]
            tids = [i for i, t in enumerate(pf.terms)
                    if pred(t)][:max_expansions]
            if not tids:
                return self._no_match()
            return self._terms_text_expanded(field, tids, boost)
        if kind == "keyword":
            kc = self.seg.keywords[field]
            ords = np.asarray([i for i, t in enumerate(kc.terms)
                               if pred(t)][:max_expansions], dtype=np.int32)
            if ords.size == 0:
                return self._no_match()
            return Bound("ord_set", field,
                         scalars={"boost": max(boost, _F32_MIN_WEIGHT),
                                  "card_total": kc.cardinality},
                         arrays={"ords": ords})
        return self._no_match()

    def _bind_PrefixQuery(self, q: PrefixQuery) -> Bound:
        # sorted dictionary: prefix = contiguous term range
        return self._expand_terms(q.field, lambda t: t.startswith(q.value),
                                  q.boost, q.max_expansions)

    # -- positional: fused clause kinds, else host match -> docs_w --------

    def _docs_w(self, docs: np.ndarray, imps: np.ndarray) -> Bound:
        if docs.size == 0:
            return self._no_match()
        return Bound("docs_w",
                     arrays={"docs": docs.astype(np.int32),
                             "imps": imps.astype(np.float32)})

    def _positional_fallback(self, why: str) -> None:
        """Count one positional query taking the host path, by reason
        (fused_scoring_stats()["admission"]["positional_fallbacks"])."""
        _fused_stats.record_positional(why)

    def _default_bm25(self, field: str) -> bool:
        """The packed k1ln / lnorm columns bake the default BM25
        parameters; any other similarity keeps the host path."""
        from ..index.similarity import BM25Similarity
        sim = self.mappers.similarity_for(field)
        return sim is None or (isinstance(sim, BM25Similarity)
                               and sim.k1 == BM25_K1 and sim.b == BM25_B)

    def _positional_field_ok(self, pf) -> bool:
        return (pf.fwd_pos is not None and pf.tile_max is not None
                and pf.fwd_tids is not None)

    def _phrase_fused(self, q, pf, tid_groups) -> Bound | None:
        """The fused-kind Bound of an eligible match_phrase, or None for
        the host phrase_match -> docs_w path (reason counted)."""
        from .phrase import terms_idf_sum
        if not _positional_enabled():
            return None
        if q.prefix_last:
            self._positional_fallback("phrase_prefix")
            return None
        if not self._positional_field_ok(pf):
            self._positional_fallback("missing_positions_pack")
            return None
        if not self._default_bm25(q.field):
            self._positional_fallback("similarity")
            return None
        n = len(tid_groups)
        if n > _POS_CLAUSE_TERMS_MAX:
            self._positional_fallback("too_many_terms")
            return None
        if q.slop > POS_MAX_ENC:
            self._positional_fallback("slop_cap")
            return None
        if not q.boost > 0.0:
            # host docs_w at boost <= 0 scores 0, i.e. no match, while
            # the fused leaf matches on freq > 0; and the tile bound needs
            # a positive boost
            self._positional_fallback("nonpositive_boost")
            return None
        tids = [g[0] for g in tid_groups]
        idf_sum = terms_idf_sum(pf, tid_groups)
        wb = [idf_sum / float(bm25_idf(float(pf.df[t]), pf.doc_count))
              for t in tids]
        return Bound(phrase_kind(n, q.slop > 0), q.field,
                     scalars={"idf_sum": float(idf_sum),
                              "slop": int(q.slop),
                              "boost": float(q.boost)},
                     arrays={"qt": np.asarray(tids, np.int32),
                             "wb": np.asarray(wb, np.float32)})

    def _span_fused(self, q) -> Bound | None:
        """The fused-kind Bound of an eligible span tree (a bare
        span_term or a depth-1 span_near of same-field span_terms), or
        None for the host Spans path. span_or / span_first / span_not
        and nested trees stay on the host, counted; child boosts are
        ignored as the host's span algebra ignores them."""
        from .query_dsl import SpanTermQuery, SpanNearQuery
        if not _positional_enabled():
            return None
        if isinstance(q, SpanTermQuery):
            field, terms = q.field, [str(q.value)]
            in_order, slop = False, 0
        elif isinstance(q, SpanNearQuery) and q.clauses and all(
                isinstance(c, SpanTermQuery) for c in q.clauses):
            if len({c.field for c in q.clauses}) > 1:
                return None          # the host raises the same-field error
            field = q.clauses[0].field
            terms = [str(c.value) for c in q.clauses]
            in_order, slop = q.in_order, q.slop
        else:
            self._positional_fallback(f"span_{type(q).__name__}")
            return None
        pf = self.seg.text.get(field)
        if pf is None or pf.pos_data is None:
            return None              # host: no match / positions error
        if not self._positional_field_ok(pf):
            self._positional_fallback("missing_positions_pack")
            return None
        if not self._default_bm25(field):
            self._positional_fallback("similarity")
            return None
        n = len(terms)
        if n > _POS_CLAUSE_TERMS_MAX:
            self._positional_fallback("too_many_terms")
            return None
        if slop > POS_MAX_ENC:
            self._positional_fallback("slop_cap")
            return None
        if not q.boost > 0.0:
            self._positional_fallback("nonpositive_boost")
            return None
        tids = [pf.lookup(t) for t in terms]
        if any(t < 0 for t in tids):
            return self._no_match()  # host: empty spans -> no match
        idf = [float(bm25_idf(float(pf.df[t]), pf.doc_count))
               for t in tids]
        idf_sum = sum(idf)
        # n == 1 counts occurrences either way; unordered keeps the
        # tighter per-term bound
        kind = span_kind(n, in_order if n > 1 else False)
        return Bound(kind, field,
                     scalars={"idf_sum": float(idf_sum), "slop": int(slop),
                              "boost": float(q.boost)},
                     arrays={"qt": np.asarray(tids, np.int32),
                             "wb": np.asarray([idf_sum / v for v in idf],
                                              np.float32)})

    def _bind_BM25FQuery(self, q) -> Bound:
        """multi_match type=cross_fields as BM25F: shared max-df IDF per
        term, per-field weighted tf and length norm, one saturation. The
        same statistics feed the fused bm25f kind or the host oracle
        (search/phrase.bm25f_scores) through docs_w."""
        from .phrase import bm25f_scores
        pairs = [(f, w) for f, w in q.fields
                 if self.seg.text.get(f) is not None]
        if not pairs or not q.terms:
            return self._no_match()
        pfs = [self.seg.text[f] for f, _w in pairs]
        nf, nt = len(pairs), len(q.terms)
        tids = np.full((nf, nt), -1, np.int32)
        for fi, pf in enumerate(pfs):
            for ti, term in enumerate(q.terms):
                tids[fi, ti] = pf.lookup(term)
        if (tids < 0).all():
            return self._no_match()
        # one virtual document: per term the max df across the fields,
        # N the widest field's doc count
        n_docs = max(pf.doc_count for pf in pfs)
        idf = [float(bm25_idf(float(max(
                   (pf.df[t] for pf, t in zip(pfs, tids[:, ti]) if t >= 0),
                   default=0.0)), n_docs)) for ti in range(nt)]
        weights = np.asarray([max(w, _F32_MIN_WEIGHT) for _f, w in pairs],
                             np.float32)
        fused_ok = (_positional_enabled() and q.boost > 0.0
                    and nf <= _POS_FIELDS_MAX
                    and nt <= _POS_CLAUSE_TERMS_MAX
                    and all(self._positional_field_ok(pf)
                            and self._default_bm25(f)
                            for (f, _w), pf in zip(pairs, pfs)))
        if fused_ok:
            return Bound(bm25f_kind(nf, nt), tuple(f for f, _w in pairs),
                         scalars={"boost": float(q.boost)},
                         arrays={"qt": tids,
                                 "idf": np.asarray(idf, np.float32),
                                 "wf": weights})
        if _positional_enabled():
            self._positional_fallback(
                "bm25f_boost" if not q.boost > 0.0 else
                "bm25f_shape" if (nf > _POS_FIELDS_MAX
                                  or nt > _POS_CLAUSE_TERMS_MAX) else
                "missing_positions_pack")
        col = bm25f_scores(pfs, tids, idf, weights, self.seg.capacity)
        docs = np.nonzero(col > 0.0)[0].astype(np.int32)
        return self._docs_w(docs, col[docs] * np.float32(q.boost))

    def _bind_PhraseQuery(self, q) -> Bound:
        from .phrase import phrase_match, phrase_impacts, terms_idf_sum
        pf = self.seg.text.get(q.field)
        if pf is None:
            return self._no_match()
        if pf.pos_data is None:
            # a segment without the positions sidecar: the conjunctive
            # approximation (all terms must match)
            from .query_dsl import BoolQuery, TermQuery
            return self.bind(BoolQuery(
                must=tuple(TermQuery(q.field, t) for t in q.terms),
                boost=q.boost))
        tid_groups: list[list[int]] = []
        for i, term in enumerate(q.terms):
            if q.prefix_last and i == len(q.terms) - 1:
                tids = [j for j, t in enumerate(pf.terms)
                        if t.startswith(term)][: q.max_expansions]
                tid_groups.append(tids)
            else:
                t = pf.lookup(term)
                if t < 0:
                    return self._no_match()
                tid_groups.append([t])
        fused = self._phrase_fused(q, pf, tid_groups)
        if fused is not None:
            return fused
        docs, freqs = phrase_match(pf, tid_groups, q.slop)
        imps = phrase_impacts(
            pf, docs, freqs, terms_idf_sum(pf, tid_groups),
            sim=self.mappers.similarity_for(q.field),
            tids=[t for g in tid_groups for t in g]) * q.boost
        return self._docs_w(docs, imps)

    def _span_tree(self, q):
        """Query AST -> (phrase.Spans, field, [tids]) on the host."""
        from . import phrase as ph
        from .query_dsl import (SpanTermQuery, SpanNearQuery, SpanOrQuery,
                                SpanFirstQuery, SpanNotQuery)
        if isinstance(q, SpanTermQuery):
            pf = self.seg.text.get(q.field)
            if pf is not None and pf.pos_data is None:
                raise QueryParsingError(
                    f"field [{q.field}] was indexed without position data; "
                    f"cannot run span queries")
            if pf is None:
                return ph.Spans.empty(), q.field, []
            tid = pf.lookup(str(q.value))
            return ph.span_term(pf, tid), q.field, [tid] if tid >= 0 else []
        if isinstance(q, SpanNearQuery):
            parts = [self._span_tree(c) for c in q.clauses]
            field = self._span_same_field(parts, "span_near")
            tids = [t for _, _, ts in parts for t in ts]
            return (ph.span_near([p for p, _, _ in parts], q.slop,
                                 q.in_order), field, tids)
        if isinstance(q, SpanOrQuery):
            parts = [self._span_tree(c) for c in q.clauses]
            field = self._span_same_field(parts, "span_or")
            tids = [t for _, _, ts in parts for t in ts]
            return ph.span_or([p for p, _, _ in parts]), field, tids
        if isinstance(q, SpanFirstQuery):
            spans, field, tids = self._span_tree(q.match)
            return ph.span_first(spans, q.end), field, tids
        if isinstance(q, SpanNotQuery):
            inc, field, tids = self._span_tree(q.include)
            exc, _, _ = self._span_tree(q.exclude)
            return ph.span_not(inc, exc, q.pre, q.post), field, tids
        raise QueryParsingError(
            f"unsupported span clause [{type(q).__name__}]")

    @staticmethod
    def _span_same_field(parts, ctx: str) -> str:
        # span_near / span_or clauses must all be on one field
        fields = {f for _, f, _ in parts}
        if len(fields) > 1:
            raise QueryParsingError(
                f"[{ctx}] clauses must have same field, got {sorted(fields)}")
        return parts[0][1]

    def _bind_span(self, q) -> Bound:
        from .phrase import phrase_impacts
        fused = self._span_fused(q)
        if fused is not None:
            return fused
        spans, field, tids = self._span_tree(q)
        pf = self.seg.text.get(field)
        if pf is None or spans.size == 0:
            return self._no_match()
        docs, freqs = spans.doc_freqs()
        idf_sum = sum(float(bm25_idf(float(pf.df[t]), pf.doc_count))
                      for t in tids)
        imps = phrase_impacts(
            pf, docs, freqs, idf_sum,
            sim=self.mappers.similarity_for(field), tids=tids) * q.boost
        return self._docs_w(docs, imps)

    _bind_SpanTermQuery = _bind_span
    _bind_SpanNearQuery = _bind_span
    _bind_SpanOrQuery = _bind_span
    _bind_SpanFirstQuery = _bind_span
    _bind_SpanNotQuery = _bind_span

    # -- compound ----------------------------------------------------------

    def _bind_BoolQuery(self, q: BoolQuery) -> Bound:
        children = {
            "must": [self.bind(c) for c in q.must],
            "should": [self.bind(c) for c in q.should],
            "must_not": [self.bind(c) for c in q.must_not],
            "filter": [self.bind(c) for c in q.filter],
        }
        # Lucene-style BooleanQuery simplification: splice a nested pure
        # disjunction into the parent's should list (and a pure
        # conjunction into must)
        parent_msm = q.minimum_should_match
        if parent_msm is None:
            parent_msm = 1 if (q.should and not q.must and not q.filter) else 0
        if parent_msm <= 1:
            spliced = []
            for c in children["should"]:
                if (c.kind == "bool" and c.scalars.get("boost") == 1.0
                        and c.scalars.get("msm", 0) == 1
                        and not c.children.get("must")
                        and not c.children.get("must_not")
                        and not c.children.get("filter")):
                    spliced.extend(c.children.get("should", []))
                else:
                    spliced.append(c)
            children["should"] = spliced
        spliced_m = []
        for c in children["must"]:
            if (c.kind == "bool" and c.scalars.get("boost") == 1.0
                    and not c.children.get("should")
                    and not c.children.get("must_not")):
                spliced_m.extend(c.children.get("must", []))
                # child FILTER clauses stay non-scoring
                children["filter"] = (children["filter"]
                                      + c.children.get("filter", []))
            else:
                spliced_m.append(c)
        children["must"] = spliced_m
        # fuse same-field text-term should clauses into one plan
        # (the match-query fast path; only valid when msm <= 1)
        msm = q.minimum_should_match
        if msm is None:
            msm = 1 if (q.should and not q.must and not q.filter) else 0
        if msm <= 1:
            fused: dict[tuple, list[Bound]] = {}
            rest: list[Bound] = []
            for c in children["should"]:
                if c.kind in ("term_text", "term_text_sc"):
                    fused.setdefault((c.field, c.kind), []).append(c)
                else:
                    rest.append(c)
            for (fld, ckind), group in fused.items():
                # few-term groups take the forward-index gather path;
                # many-term groups and fields without a forward index
                # stay on posting-scatter
                if ckind == "term_text" and len(group) <= _DENSE_GROUP_MAX:
                    tids = [c.scalars.get("tid", -1) for c in group]
                    weights = [c.scalars["weight"] for c in group]
                    rest.append(Bound(
                        "terms_dense", fld,
                        arrays={"tids": np.asarray(tids, dtype=np.int32),
                                "weights": np.asarray(weights,
                                                      dtype=np.float32)}))
                else:
                    blocks: list[int] = []
                    weights = []
                    for c in group:
                        for b in range(c.scalars["nb"]):
                            blocks.append(c.scalars["block_lo"] + b)
                            weights.append(c.scalars["weight"])
                    rest.append(Bound(
                        "terms_fused_w", fld,
                        arrays={"blocks": np.asarray(blocks, dtype=np.int32),
                                "weights": np.asarray(weights,
                                                      dtype=np.float32)}))
            children["should"] = rest
        return Bound("bool", scalars={"msm": msm, "boost": q.boost},
                     children=children)

    def _bind_ConstantScoreQuery(self, q: ConstantScoreQuery) -> Bound:
        return Bound("const", scalars={"boost": q.boost},
                     children={"q": [self.bind(q.query)]})

    def _bind_KnnQuery(self, q: KnnQuery) -> Bound:
        """Vector similarity as a scoring clause: every live doc with a
        vector matches, scored by the field similarity's transform times
        boost. The similarity rides the desc; the query vector and boost
        are params."""
        vc = self.seg.vectors.get(q.field)
        if vc is None:
            return self._no_match()
        fm = self.mappers.field(q.field)
        sim = fm.similarity if fm is not None and fm.similarity else "cosine"
        if sim not in _KNN_SIMILARITIES:
            raise QueryParsingError(
                f"[knn] unsupported similarity [{sim}] on [{q.field}]")
        qv = np.asarray(q.vector, dtype=np.float32)
        if qv.shape[0] != vc.dims:
            raise QueryParsingError(
                f"[knn] query_vector has {qv.shape[0]} dims, field "
                f"[{q.field}] has {vc.dims}")
        return Bound("knn_vec", q.field,
                     scalars={"boost": max(float(q.boost),
                                           _F32_MIN_WEIGHT),
                              "sim": sim},
                     arrays={"qv": qv})


# ---------------------------------------------------------------------------
# finalize: Bound trees (a batch with identical structure) -> (desc, params)
# ---------------------------------------------------------------------------


def finalize(bounds: Sequence[Bound]) -> tuple[tuple, tuple]:
    """Stack a batch of structurally-identical bound queries into (desc,
    params): desc is the hashable static structure; params a tree of
    stacked numpy arrays with leading dim B."""
    sig = bounds[0].signature()
    for b in bounds[1:]:
        if b.signature() != sig:
            raise ValueError("cannot batch queries with different plans")
    return _finalize_node(bounds)


def _finalize_node(bounds: Sequence[Bound]) -> tuple[tuple, tuple]:
    b0 = bounds[0]
    kind = b0.kind
    B = len(bounds)

    def stack_scalar(name, dtype):
        return np.asarray([b.scalars[name] for b in bounds], dtype=dtype)

    if kind == "none":
        return ("none",), ()
    if kind == "match_all":
        return ("match_all",), (stack_scalar("boost", np.float32),)
    if kind == "term_text":
        return (("term_text", b0.field),
                (stack_scalar("tid", np.int32),
                 stack_scalar("weight", np.float32)))
    if kind == "term_text_sc":
        nb_pad = next_pow2(max(b.scalars["nb"] for b in bounds), floor=1)
        return (("term_text_sc", b0.field, nb_pad),
                (stack_scalar("block_lo", np.int32),
                 stack_scalar("nb", np.int32),
                 stack_scalar("weight", np.float32)))
    if kind == "terms_dense":
        q_pad = next_pow2(max(b.arrays["tids"].size for b in bounds), floor=1)
        qt = np.full((B, q_pad), -1, dtype=np.int32)
        wq = np.zeros((B, q_pad), dtype=np.float32)
        for i, b in enumerate(bounds):
            t = b.arrays["tids"]
            qt[i, : t.size] = t
            wq[i, : t.size] = b.arrays["weights"]
        return ("terms_dense", b0.field, q_pad), (qt, wq)
    if kind in ("terms_fused", "terms_fused_w"):
        m_pad = next_pow2(max(b.arrays["blocks"].size for b in bounds),
                          floor=1)
        gather = np.full((B, m_pad), -1, dtype=np.int32)
        weights = np.zeros((B, m_pad), dtype=np.float32)
        for i, b in enumerate(bounds):
            blocks = b.arrays["blocks"]
            gather[i, :blocks.size] = blocks
            if kind == "terms_fused_w":
                weights[i, :blocks.size] = b.arrays["weights"]
            else:
                weights[i, :blocks.size] = b.scalars["weight"]
        return ("terms_fused", b0.field, m_pad), (gather, weights)
    if kind == "term_kw":
        return (("term_kw", b0.field),
                (stack_scalar("ord", np.int32),
                 stack_scalar("score", np.float32)))
    if kind == "ord_set":
        card = next_pow2(max(b.arrays["ords"].size for b in bounds), floor=1)
        card_total = int(b0.scalars["card_total"])
        ords = np.full((B, card), card_total, dtype=np.int32)
        for i, b in enumerate(bounds):
            o = b.arrays["ords"]
            ords[i, :o.size] = o
        return (("ord_set", b0.field, card, card_total),
                (ords, stack_scalar("boost", np.float32)))
    if kind == "term_num":
        return (("term_num", b0.field),
                (np.asarray([b.scalars["value"] for b in bounds]),
                 stack_scalar("score", np.float32)))
    if kind == "range_int":
        return (("range_int", b0.field),
                (stack_scalar("lo", np.int32), stack_scalar("hi", np.int32),
                 stack_scalar("boost", np.float32)))
    if kind == "range_f32":
        return (("range_f32", b0.field),
                (stack_scalar("lo", np.float32),
                 stack_scalar("hi", np.float32),
                 stack_scalar("boost", np.float32)))
    if kind == "range_kw":
        return (("range_kw", b0.field),
                (stack_scalar("lo", np.int32), stack_scalar("hi", np.int32),
                 stack_scalar("boost", np.float32)))
    if kind == "knn_vec":
        # the similarity is static (in the desc); the query vector and
        # boost are params, so searches with other vectors batch together
        return (("knn_vec", b0.field, b0.scalars["sim"]),
                (np.stack([b.arrays["qv"] for b in bounds]),
                 stack_scalar("boost", np.float32)))
    if kind == "docs_w":
        n_pad = next_pow2(max(b.arrays["docs"].size for b in bounds), floor=1)
        docs = np.zeros((B, n_pad), dtype=np.int32)
        imps = np.zeros((B, n_pad), dtype=np.float32)
        for i, b in enumerate(bounds):
            d = b.arrays["docs"]
            docs[i, : d.size] = d
            imps[i, : d.size] = b.arrays["imps"]
        return ("docs_w", n_pad), (docs, imps)
    head = positional_prefix(kind)
    if head in ("phrase_pos", "span_pos"):
        # n rides in the kind string, so the batch shares qt / wb width;
        # the slop value is a param (only sloppiness is in the kind)
        return ((kind, b0.field),
                (np.stack([b.arrays["qt"] for b in bounds]),
                 np.stack([b.arrays["wb"] for b in bounds]),
                 stack_scalar("idf_sum", np.float32),
                 stack_scalar("slop", np.int32),
                 stack_scalar("boost", np.float32)))
    if head == "bm25f":
        return ((kind, b0.field),
                (np.stack([b.arrays["qt"] for b in bounds]),
                 np.stack([b.arrays["idf"] for b in bounds]),
                 np.stack([b.arrays["wf"] for b in bounds]),
                 stack_scalar("boost", np.float32)))
    if kind == "bool":
        descs = {}
        params = {}
        for group in ("must", "should", "must_not", "filter"):
            pairs = [_finalize_node([b.children[group][i] for b in bounds])
                     for i in range(len(b0.children[group]))]
            descs[group] = tuple(d for d, _ in pairs)
            params[group] = tuple(p for _, p in pairs)
        return (("bool", descs["must"], descs["should"], descs["must_not"],
                 descs["filter"]),
                (params["must"], params["should"], params["must_not"],
                 params["filter"],
                 stack_scalar("msm", np.int32),
                 stack_scalar("boost", np.float32)))
    if kind == "const":
        d, p = _finalize_node([b.children["q"][0] for b in bounds])
        return ("const", d), (p, stack_scalar("boost", np.float32))
    raise QueryParsingError(f"unknown bound node [{kind}]")


# ---------------------------------------------------------------------------
# Packed upload: a dispatch's dynamic data (query params, agg params, sort
# params) travels as ONE int32 buffer [i32 | f32 bits | bool as i32], as
# in the reference's wire format. One non-blocking host-to-device copy per
# dispatch: a copy of each small array would, unpinned, wait for the work
# already queued on the stream and serialize the pipelined dispatches.
# ---------------------------------------------------------------------------


def _leaves(tree, acc: list) -> list:
    """Leaves of a tuple/dict tree, in order."""
    if isinstance(tree, tuple):
        for t in tree:
            _leaves(t, acc)
    elif isinstance(tree, dict):
        for t in tree.values():
            _leaves(t, acc)
    else:
        acc.append(tree)
    return acc


def _rebuild(tree, it):
    """`tree`'s structure with its leaves replaced, in order, from `it`."""
    if isinstance(tree, tuple):
        return tuple(_rebuild(t, it) for t in tree)
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    return next(it)


def _pack_trees(*trees) -> tuple[np.ndarray, tuple]:
    """Numpy param trees -> (wire int32 buffer, static spec). Integers
    travel as int32 and floats as float32, the reference's device dtypes
    (no int64 reaches the device)."""
    bufs: dict[str, list] = {"i": [], "f": [], "b": []}
    sizes = {"i": 0, "f": 0, "b": 0}
    spec = []
    for leaf in _leaves(trees, []):
        a = np.asarray(leaf)
        if a.dtype == np.bool_:
            tag = "b"
        elif np.issubdtype(a.dtype, np.floating):
            tag, a = "f", a.astype(np.float32, copy=False)
        else:
            tag, a = "i", a.astype(np.int32, copy=False)
        spec.append((tag, a.shape, sizes[tag], a.size))
        bufs[tag].append(a.ravel())
        sizes[tag] += a.size
    wire = np.concatenate([np.zeros(0, np.int32)]
                          + bufs["i"]
                          + [b.view(np.int32) for b in bufs["f"]]
                          + [b.astype(np.int32) for b in bufs["b"]])
    return wire, (trees, tuple(spec), (sizes["i"], sizes["f"], sizes["b"]))


def _unpack_trees(wire: torch.Tensor, static) -> tuple:
    """Device wire buffer -> the param trees, as views where possible."""
    trees, spec, (ni, nf, _nb) = static
    parts = {"i": wire[:ni], "f": wire[ni: ni + nf].view(torch.float32),
             "b": wire[ni + nf:] != 0}
    return _rebuild(trees, (parts[tag][off: off + size].reshape(shp)
                            for tag, shp, off, size in spec))


# ---------------------------------------------------------------------------
# Device evaluation (desc interpreter)
# ---------------------------------------------------------------------------


def eval_node(desc: tuple, params: tuple, seg: dict, cap: int, B: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (score [B, cap] f32, match [B, cap] bool)."""
    kind = desc[0]
    device = seg["_device"]
    if kind == "none":
        return (torch.zeros((B, cap), dtype=torch.float32, device=device),
                torch.zeros((B, cap), dtype=torch.bool, device=device))
    if kind == "match_all":
        (boost,) = params
        return (boost[:, None].expand(B, cap).contiguous(),
                torch.ones((B, cap), dtype=torch.bool, device=device))
    if kind == "term_text":
        # forward-index gather; tid -1 = absent term, which only matches
        # zero-impact padding slots -> no match
        _, field = desc
        tid, weight = params
        t = seg["text"][field]
        score = cuda_scoring.dense_score(t["fwd_tids"], t["fwd_imps"],
                                         tid[:, None], weight[:, None])
        return score, score > 0
    if kind == "term_text_sc":
        # posting-scatter path (fields without a forward index)
        _, field, nb_pad = desc
        block_lo, nb, weight = params
        t = seg["text"][field]
        score = score_term(t["block_docs"], t["block_imps"], block_lo, nb,
                           weight, nb_pad, cap)
        return score, score > 0
    if kind == "terms_fused":
        _, field, _m = desc
        gather, weights = params
        t = seg["text"][field]
        score = score_terms_fused(t["block_docs"], t["block_imps"], gather,
                                  weights, cap)
        return score, score > 0
    if kind == "terms_dense":
        _, field, _q_pad = desc
        qt, wq = params                            # [B, Qp]
        t = seg["text"][field]
        score = cuda_scoring.dense_score(t["fwd_tids"], t["fwd_imps"], qt, wq)
        return score, score > 0
    if kind == "docs_w":
        docs, imps = params                         # [B, n] each
        score = cuda_scoring.scatter_add(docs, imps, cap)
        return score, score > 0
    if positional_prefix(kind):
        # the fused walk's leaf over the whole capacity (per doc, so it
        # equals the walk tile by tile): the positional_leaf kernel
        _, field = desc
        ones_i = torch.ones((B,), dtype=torch.int32, device=device)
        ones_f = torch.ones((B,), dtype=torch.float32, device=device)
        s_leaf, m_leaf = cuda_scoring.positional_leaf(
            kind, field, tuple(params) + (ones_i, ones_f),
            {f: seg["text"][f] for f in clause_fields(field)})
        return torch.where(m_leaf, s_leaf, 0.0), m_leaf
    if kind == "knn_vec":
        # one whole-capacity similarity column: the same one the fused
        # bundle walk reads (_vec_clause_inputs), so fused and unfused
        # hybrid scores are equal
        _, field, sim = desc
        qv, boost = params                          # [B, D], [B]
        v = seg["vec"][field]
        col = knn_score_column(v["values"], v["norms"], v["exists"], qv,
                               similarity=sim)
        match = v["exists"][None, :].expand(B, cap)
        return col * boost[:, None], match
    if kind == "term_kw":
        _, field = desc
        ordv, scorev = params
        if field in seg.get("kw_mv", {}):
            mv = seg["kw_mv"][field]                # [cap, M]
            match = (mv[None] == ordv[:, None, None]).any(dim=-1) \
                & (ordv[:, None] >= 0)
        else:
            ords = seg["kw"][field]
            match = (ords[None, :] == ordv[:, None]) & (ordv[:, None] >= 0)
        return torch.where(match, scorev[:, None], 0.0), match
    if kind == "ord_set":
        # membership via a [B, card_total+1] table
        _, field, _card, card_total = desc
        ord_sets, boost = params
        idx = ord_sets.to(torch.int64)
        tbl = torch.zeros((B, card_total + 1), dtype=torch.bool,
                          device=device)
        tbl.scatter_(1, idx, torch.ones_like(idx, dtype=torch.bool))
        if field in seg.get("kw_mv", {}):
            mv = seg["kw_mv"][field]                # [cap, M]
            safe = mv.clamp(min=0).to(torch.int64).reshape(1, -1)
            hit = tbl.gather(1, safe.expand(B, -1)).reshape(B, *mv.shape)
            match = (hit & (mv >= 0)[None]).any(dim=-1)
        else:
            ords = seg["kw"][field]
            safe = ords.clamp(min=0).to(torch.int64)[None, :].expand(B, -1)
            match = tbl.gather(1, safe) & (ords >= 0)[None, :]
        return torch.where(match, boost[:, None], 0.0), match
    if kind == "term_num":
        _, field = desc
        value, scorev = params
        col = seg["num"][field]
        if "mv_values" in col:
            match = ((col["mv_values"][None] == value[:, None, None])
                     & col["mv_exists"][None]).any(dim=-1)
        else:
            match = (col["values"][None, :] == value[:, None]) \
                & col["exists"][None, :]
        return torch.where(match, scorev[:, None], 0.0), match
    if kind in ("range_int", "range_f32"):
        _, field = desc
        lo, hi, boost = params
        col = seg["num"][field]
        if "mv_values" in col:
            v = col["mv_values"][None]              # [1, cap, M]
            match = ((v >= lo[:, None, None]) & (v <= hi[:, None, None])
                     & col["mv_exists"][None]).any(dim=-1)
        else:
            v = col["values"][None, :]
            match = (v >= lo[:, None]) & (v <= hi[:, None]) \
                & col["exists"][None, :]
        return torch.where(match, boost[:, None], 0.0), match
    if kind == "range_kw":
        _, field = desc
        lo, hi, boost = params
        if field in seg.get("kw_mv", {}):
            mv = seg["kw_mv"][field][None]          # [1, cap, M]
            match = ((mv >= lo[:, None, None])
                     & (mv <= hi[:, None, None])).any(dim=-1)
        else:
            ords = seg["kw"][field][None, :]
            match = (ords >= lo[:, None]) & (ords <= hi[:, None]) \
                & (ords >= 0)
        return torch.where(match, boost[:, None], 0.0), match
    if kind == "bool":
        _, d_must, d_should, d_not, d_filter = desc
        p_must, p_should, p_not, p_filter, msm, boost = params
        score = torch.zeros((B, cap), dtype=torch.float32, device=device)
        must_ok = torch.ones((B, cap), dtype=torch.bool, device=device)
        for d, p in zip(d_must, p_must):
            s, m = eval_node(d, p, seg, cap, B)
            score = score + torch.where(m, s, 0.0)
            must_ok = must_ok & m
        for d, p in zip(d_filter, p_filter):
            _, m = eval_node(d, p, seg, cap, B)
            must_ok = must_ok & m
        not_any = torch.zeros((B, cap), dtype=torch.bool, device=device)
        for d, p in zip(d_not, p_not):
            _, m = eval_node(d, p, seg, cap, B)
            not_any = not_any | m
        should_cnt = torch.zeros((B, cap), dtype=torch.int32, device=device)
        for d, p in zip(d_should, p_should):
            s, m = eval_node(d, p, seg, cap, B)
            score = score + torch.where(m, s, 0.0)
            should_cnt = should_cnt + m.to(torch.int32)
        match = must_ok & (~not_any) & (should_cnt >= msm[:, None])
        return score * boost[:, None], match
    if kind == "const":
        _, d_child = desc
        p_child, boost = params
        _, m = eval_node(d_child, p_child, seg, cap, B)
        return torch.where(m, boost[:, None], 0.0), m
    raise QueryParsingError(f"unknown desc node [{kind}]")


# ---------------------------------------------------------------------------
# Aggregations: desc interpreter (device part)
#   ("terms_kw", field, n_global, sub_metrics, top_s)  params: (seg2global, g2seg)
#   ("hist_fixed", field, n_buckets, sub_metrics)      params: (origin, interval)
#   ("hist_edges", field, n_buckets, sub_metrics)      params: (edges,)
#   ("stats", field) / ("value_count_kw"|"value_count_num", field)  params: ()
# ---------------------------------------------------------------------------


def _zeros(B: int, n: int, device) -> torch.Tensor:
    return torch.zeros((B, n), dtype=torch.float32, device=device)


def _merge_metric_dicts(acc: dict, st: dict) -> dict:
    """Merge per-value-slot metric partials: min/max fold, others sum."""
    for k, v in st.items():
        if k == "min":
            acc[k] = torch.minimum(acc[k], v)
        elif k == "max":
            acc[k] = torch.maximum(acc[k], v)
        else:
            acc[k] = ordered.ftz(acc[k] + v)
    return acc


def _empty_bucket_metric(mkind: str, B: int, n_buckets: int, device) -> dict:
    entry = {}
    if mkind in ("avg", "sum", "stats", "extended_stats"):
        entry["sum"] = _zeros(B, n_buckets, device)
    if mkind in ("avg", "stats", "extended_stats", "value_count"):
        entry["count"] = _zeros(B, n_buckets, device)
    if mkind in ("min", "stats", "extended_stats"):
        entry["min"] = torch.full((B, n_buckets), math.inf,
                                  dtype=torch.float32, device=device)
    if mkind in ("max", "stats", "extended_stats"):
        entry["max"] = torch.full((B, n_buckets), -math.inf,
                                  dtype=torch.float32, device=device)
    if mkind == "extended_stats":
        entry["sum_sq"] = _zeros(B, n_buckets, device)
    return entry


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound (XLA int32 math)."""
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def _hist_edges_for(kind, params, n_buckets, dtype, device):
    if kind == "hist_fixed":
        origin, interval = params
        if dtype == torch.int32:
            # int32 columns (epoch seconds) need EXACT edges; the
            # pow2-padded tail may overflow int32, so every edge whose
            # true value could pass INT32_MAX clamps to it, as in the
            # reference (monotonicity is all searchsorted needs there)
            rng = torch.arange(n_buckets + 1, dtype=torch.int64,
                               device=device)
            o = origin.to(torch.int32)
            off = _wrap_i32(interval.to(torch.int32).to(torch.int64) * rng)
            s = _wrap_i32(o.to(torch.int64) + off.to(torch.int64))
            approx = o.to(torch.float32) \
                + interval.to(torch.float32) * rng.to(torch.float32)
            bad = (off < 0) | (s < o) \
                | (approx >= torch.tensor(2.0 ** 31 - 256,
                                          dtype=torch.float32))
            return torch.where(bad, _I32_MAX, s)
        rng = torch.arange(n_buckets + 1, dtype=torch.float32, device=device)
        edges = origin.to(torch.float32) + interval.to(torch.float32) * rng
    else:
        (edges,) = params
    return edges.to(dtype)


def _sorted_hist_counts(srtn, exists, valid, edges) -> torch.Tensor:
    w = torch.where(exists[None, :], valid.to(torch.float32), 0.0)
    return agg_ops.sorted_hist_reduce(srtn["vals"].to(edges.dtype),
                                      srtn["perm"], w, edges)


def _hist_sorted(seg, col, srtn, valid, subs, kind, params, n_buckets):
    """Scatter-free histogram over the value-sorted layout: bucket sums
    are cumsum differences at searchsorted edge positions."""
    device = seg["_device"]
    perm, sorted_vals = srtn["perm"], srtn["vals"]
    edges = _hist_edges_for(kind, params, n_buckets, sorted_vals.dtype,
                            device)
    exists = col["exists"]
    w = torch.where(exists[None, :], valid.to(torch.float32), 0.0)
    entry = {"counts": _sorted_hist_counts(srtn, exists, valid, edges)}
    B = valid.shape[0]
    bids = None
    for mname, mfield, mkind in subs:
        mcol = seg["num"].get(mfield)
        if mcol is None:
            entry[mname] = _empty_bucket_metric(mkind, B, n_buckets, device)
            continue
        if "mv_values" in mcol or mkind not in ("avg", "sum", "value_count"):
            # multi-valued sources and min/max-bearing metrics keep the
            # per-doc path (one bucket-id tensor: one bucket layout)
            if bids is None and kind == "hist_fixed":
                origin, interval = params
                bids = agg_ops.fixed_histogram_bucket_ids(
                    col["values"], exists, origin, interval, n_buckets)
            elif bids is None:
                bids = agg_ops.edges_bucket_ids(col["values"], exists,
                                                params[0], n_buckets)
            entry[mname] = _bucket_metrics(
                bids, valid, [(mname, mfield, mkind)], seg, n_buckets)[mname]
            continue
        mvals, mex = mcol["values"], mcol["exists"]
        wm = torch.where(mex[None, :], w, 0.0)
        st: dict = {}
        if mkind in ("sum", "avg"):
            st["sum"] = agg_ops.sorted_hist_reduce(
                sorted_vals, perm, wm * mvals.to(torch.float32)[None, :],
                edges)
        if mkind in ("avg", "value_count"):
            st["count"] = agg_ops.sorted_hist_reduce(sorted_vals, perm, wm,
                                                     edges)
        entry[mname] = st
    return entry


def _to_global(seg_arr: torch.Tensor, g2seg: torch.Tensor) -> torch.Tensor:
    """Per-segment-group array [B, G] -> shard-global bucket space via the
    inverse ordinal map (a gather)."""
    safe = g2seg.clamp(min=0).to(torch.int64)
    out = seg_arr[:, safe]
    return torch.where((g2seg >= 0)[None, :], out, 0.0)


def _terms_sorted(seg, field, srt, valid, subs, seg2global, g2seg, n_global):
    """Scatter-free terms aggregation over the static ordinal-sort layout."""
    device = seg["_device"]
    perm, starts = srt["perm"], srt["starts"]
    w = valid.to(torch.float32)
    entry = {"counts": _to_global(
        agg_ops.sorted_group_reduce(perm, starts, w), g2seg)}
    B = valid.shape[0]
    bids = None
    for mname, mfield, mkind in subs:
        col = seg["num"].get(mfield)
        if col is None:
            entry[mname] = _empty_bucket_metric(mkind, B, n_global, device)
            continue
        if "mv_values" in col or mkind not in ("avg", "sum", "value_count"):
            if bids is None:       # one tensor: one bucket layout
                bids = agg_ops.keyword_bucket_ids(seg["kw"][field],
                                                  seg2global, n_global)
            entry[mname] = _bucket_metrics(
                bids, valid, [(mname, mfield, mkind)], seg, n_global)[mname]
            continue
        vals, exists = col["values"], col["exists"]
        wm = torch.where(exists[None, :], w, 0.0)
        st: dict = {}
        if mkind in ("avg", "sum"):
            st["sum"] = _to_global(
                agg_ops.sorted_group_reduce(
                    perm, starts, wm * vals.to(torch.float32)[None, :]),
                g2seg)
        if mkind in ("avg", "value_count"):
            st["count"] = _to_global(
                agg_ops.sorted_group_reduce(perm, starts, wm), g2seg)
        entry[mname] = st
    return entry


def _view_bucket_entry(store: dict, vm: torch.Tensor, subs, bounds,
                       n_out: int, device, post=None) -> dict:
    """Shared view-space bucket reduce: counts + avg/sum/value_count
    sub-metrics as block reduces of sorted-space weights at `bounds`;
    counts accumulate in int32."""
    if post is None:
        post = lambda a: a  # noqa: E731
    B = vm.shape[0]
    memo: dict = {}

    def counts_of(mask, key):
        if key not in memo:
            memo[key] = agg_ops.view_group_reduce(
                mask, bounds, int_weights=True).to(torch.float32)
        return memo[key]

    entry = {"counts": post(counts_of(vm, ("count", None)))}
    for mname, mfield, mkind in subs:
        pcol = store.get("vw_num", {}).get(mfield)
        if pcol is None:
            entry[mname] = _empty_bucket_metric(mkind, B, n_out, device)
            continue
        st: dict = {}
        if mkind in ("avg", "sum"):
            key = ("sum", mfield)
            if key not in memo:
                wv = torch.where(vm & pcol["exists"][None, :],
                                 pcol["values"].to(torch.float32)[None, :],
                                 0.0)
                memo[key] = agg_ops.view_group_reduce(wv, bounds)
            st["sum"] = post(memo[key])
        if mkind in ("avg", "value_count"):
            st["count"] = post(counts_of(vm & pcol["exists"][None, :],
                                         ("count", mfield)))
        entry[mname] = st
    return entry


def _terms_view(store, vm, subs, g2seg, n_global, device) -> dict:
    return _view_bucket_entry(store, vm, subs, store["starts"], n_global,
                              device, post=lambda a: _to_global(a, g2seg))


def _hist_view(store, vm, subs, kind, params, n_buckets, device) -> dict:
    sv = store["vals"]
    edges = _hist_edges_for(kind, params, n_buckets, sv.dtype, device)
    pos = torch.searchsorted(sv, edges, side="left").to(torch.int32)
    return _view_bucket_entry(store, vm & store["sexists"][None, :], subs,
                              pos, n_buckets, device)


def _compress_topk(entry: dict, top_s: int) -> dict:
    """Shrink a terms partial to its per-segment top buckets by count
    (device-side shard_size); indices ride as f32 (exact below 2^24)."""
    counts = entry["counts"]
    tv, ti = top_k_values(counts, top_s)
    out = {"top_counts": tv, "top_idx": ti.to(torch.float32),
           "total": counts.sum(dim=-1, keepdim=True)}
    idx = ti.to(torch.int64)
    for mname, st in entry.items():
        if mname == "counts" or not isinstance(st, dict):
            continue
        for key, arr in st.items():
            out[f"sub\x00{mname}\x00{key}"] = arr.gather(-1, idx)
    return out


def _bucket_metrics(bucket_ids, mask, sub_metrics, seg, n_buckets):
    device = seg["_device"]
    B = mask.shape[0]
    out = {}
    for mname, mfield, mkind in sub_metrics:
        col = seg["num"].get(mfield)
        if col is None:
            out[mname] = _empty_bucket_metric(mkind, B, n_buckets, device)
            continue
        val_cols = ([(col["mv_values"][:, m], col["mv_exists"][:, m])
                     for m in range(col["mv_values"].shape[1])]
                    if "mv_values" in col
                    else [(col["values"], col["exists"])])
        entry = _empty_bucket_metric(mkind, B, n_buckets, device)
        # every stat of a value column in one call: the bucket layout is
        # built once per bucket-id tensor (kept on it)
        for vals, exists in val_cols:
            st = agg_ops.bucket_stats(bucket_ids, mask & exists[None, :],
                                      vals, n_buckets, tuple(entry))
            for key, arr in st.items():
                if key == "min":
                    entry[key] = torch.minimum(entry[key], arr)
                elif key == "max":
                    entry[key] = torch.maximum(entry[key], arr)
                else:
                    entry[key] = ordered.ftz(entry[key] + arr)
        out[mname] = entry
    return out


def _empty_buckets(subs, B: int, n_buckets: int, device) -> dict:
    entry = {"counts": _zeros(B, n_buckets, device)}
    for mname, _f, mkind in subs:
        entry[mname] = _empty_bucket_metric(mkind, B, n_buckets, device)
    return entry


def eval_aggs(agg_desc: tuple, agg_params: tuple, seg: dict,
              valid: torch.Tensor | None, views: "_ViewMasks | None" = None,
              plan: tuple = ()) -> dict:
    """Per-segment device aggregation. A segment lacking the aggregated
    column contributes zero partials. `plan[i]` routes node i through
    its sorted-view path; `valid` may be None when every node does."""
    out: dict[str, Any] = {}
    device = seg["_device"]
    B = views.B if views is not None else valid.shape[0]
    for ni, ((name, node), params) in enumerate(zip(agg_desc, agg_params)):
        kind = node[0]
        use_view = bool(plan) and plan[ni]
        if kind == "terms_kw":
            _, field, n_global, subs, top_s = node
            if use_view:
                _seg2global, g2seg = params
                vm = views.mask(("kw", field))
                entry = _terms_view(seg["kw_sorted"][field], vm, subs,
                                    g2seg, n_global, device)
                out[name] = _compress_topk(entry, top_s) if top_s else entry
                continue
            if field not in seg["kw"]:
                entry = _empty_buckets(subs, B, n_global, device)
                out[name] = _compress_topk(entry, top_s) if top_s else entry
                continue
            seg2global, g2seg = params
            if field in seg.get("kw_mv", {}):
                # multi-valued: one collect per ordinal SLOT
                mv = seg["kw_mv"][field]
                entry = _empty_buckets(subs, B, n_global, device)
                counts = entry["counts"]
                for m in range(mv.shape[1]):
                    bids = agg_ops.keyword_bucket_ids(mv[:, m], seg2global,
                                                      n_global)
                    counts = counts + agg_ops.bucket_counts(bids, valid,
                                                            n_global)
                    sub = _bucket_metrics(bids, valid, subs, seg, n_global)
                    for mname, st in sub.items():
                        _merge_metric_dicts(entry[mname], st)
                entry["counts"] = counts
                out[name] = _compress_topk(entry, top_s) if top_s else entry
                continue
            srt = seg.get("kw_sorted", {}).get(field)
            if srt is not None and srt["starts"].shape[0] - 1 \
                    == seg2global.shape[0]:
                entry = _terms_sorted(seg, field, srt, valid, subs,
                                      seg2global, g2seg, n_global)
            else:
                bids = agg_ops.keyword_bucket_ids(seg["kw"][field],
                                                  seg2global, n_global)
                entry = {"counts": agg_ops.bucket_counts(bids, valid,
                                                         n_global)}
                entry.update(_bucket_metrics(bids, valid, subs, seg,
                                             n_global))
            out[name] = _compress_topk(entry, top_s) if top_s else entry
        elif kind in ("hist_fixed", "hist_edges"):
            _, field, n_buckets, subs = node
            if use_view:
                vm = views.mask(("num", field))
                out[name] = _hist_view(seg["num_sorted"][field], vm, subs,
                                       kind, params, n_buckets, device)
                continue
            if field not in seg["num"]:
                out[name] = _empty_buckets(subs, B, n_buckets, device)
                continue
            col = seg["num"][field]
            srtn = seg.get("num_sorted", {}).get(field)
            if srtn is not None and "mv_values" not in col:
                out[name] = _hist_sorted(seg, col, srtn, valid, subs, kind,
                                         params, n_buckets)
                continue
            val_cols = ([(col["mv_values"][:, m], col["mv_exists"][:, m])
                         for m in range(col["mv_values"].shape[1])]
                        if "mv_values" in col
                        else [(col["values"], col["exists"])])
            entry = _empty_buckets(subs, B, n_buckets, device)
            counts = entry["counts"]
            prev_bids: list = []
            for vcol, ecol in val_cols:
                if kind == "hist_fixed":
                    origin, interval = params
                    bids = agg_ops.fixed_histogram_bucket_ids(
                        vcol, ecol, origin, interval, n_buckets)
                else:
                    (edges,) = params
                    bids = agg_ops.edges_bucket_ids(vcol, ecol, edges,
                                                    n_buckets)
                # a doc lands in each DISTINCT bucket once
                v_ok = valid
                for pb in prev_bids:
                    v_ok = v_ok & (bids != pb)[None, :]
                prev_bids.append(bids)
                counts = counts + agg_ops.bucket_counts(bids, v_ok,
                                                        n_buckets)
                sub = _bucket_metrics(bids, v_ok, subs, seg, n_buckets)
                for mname, st in sub.items():
                    _merge_metric_dicts(entry[mname], st)
            entry["counts"] = counts
            out[name] = entry
        elif kind == "stats":
            _, field = node
            col = seg["num"].get(field)
            if col is not None and "mv_values" in col:
                mv, me = col["mv_values"], col["mv_exists"]
                acc = None
                for m in range(mv.shape[1]):
                    st = agg_ops.masked_stats(mv[:, m], me[:, m], valid)
                    acc = dict(st) if acc is None \
                        else _merge_metric_dicts(acc, st)
                out[name] = acc
                continue
            if col is None:
                z = torch.zeros((B,), dtype=torch.float32, device=device)
                out[name] = {"count": z, "sum": z, "sum_sq": z,
                             "min": torch.full_like(z, math.inf),
                             "max": torch.full_like(z, -math.inf)}
                continue
            out[name] = agg_ops.masked_stats(col["values"], col["exists"],
                                             valid)
        elif kind == "value_count_num":
            _, field = node
            col = seg["num"].get(field)
            if col is None:
                out[name] = {"count": torch.zeros((B,), dtype=torch.float32,
                                                  device=device)}
                continue
            if "mv_values" in col:
                m = valid[:, :, None] & col["mv_exists"][None]
                out[name] = {"count": m.sum(dim=(-1, -2),
                                            dtype=torch.float32)}
            else:
                m = valid & col["exists"][None, :]
                out[name] = {"count": m.sum(dim=-1, dtype=torch.float32)}
        elif kind == "value_count_kw":
            _, field = node
            if field not in seg["kw"]:
                out[name] = {"count": torch.zeros((B,), dtype=torch.float32,
                                                  device=device)}
                continue
            if field in seg.get("kw_mv", {}):
                m = valid[:, :, None] & (seg["kw_mv"][field] >= 0)[None]
                out[name] = {"count": m.sum(dim=(-1, -2),
                                            dtype=torch.float32)}
            else:
                m = valid & (seg["kw"][field] >= 0)[None, :]
                out[name] = {"count": m.sum(dim=-1, dtype=torch.float32)}
        else:
            raise SearchParseError(f"unknown agg node [{kind}]")
    return out


# ---------------------------------------------------------------------------
# Fused block-max bundle engine: admission, inputs, evaluation
# ---------------------------------------------------------------------------

# the bundle kernel's clause table holds at most this many clauses; plans
# beyond it take the unfused path
_FUSED_MAX_CLAUSES = 8


def fused_enabled() -> bool:
    """The reference's switch: `ES_TPU_FUSED` set to 0/false/off sends
    every plan down the unfused path."""
    return os.environ.get("ES_TPU_FUSED", "auto").lower() not in (
        "0", "false", "off")


def _positional_enabled() -> bool:
    """The reference's lever for the fused positional kinds:
    `ES_TPU_POSITIONAL` set to 0/false/off binds every phrase / span /
    cross_fields query on the host oracle (responses are identical)."""
    return os.environ.get("ES_TPU_POSITIONAL", "1").lower() not in (
        "0", "false", "off")


def _leaf_scoring_kind(kind: str) -> bool:
    """A clause kind the bundle engine scores per tile."""
    return kind in DENSE_CLAUSE_KINDS or positional_prefix(kind) is not None


def _fused_leaf_inputs(desc: tuple, params: tuple):
    if desc[0] == "terms_dense":
        qt, wq = params
        return qt, wq
    tid, weight = params                     # term_text: single-term Q=1
    return tid[:, None], weight[:, None]


def _classify_fused_leaf(desc: tuple):
    """(kind, field, wrapped) of a scoring clause the bundle engine
    evaluates per tile: a bare terms_dense / term_text or positional
    leaf, or one wrapped in a single-should bool that carries its own
    (msm, boost). None for anything else."""
    if _leaf_scoring_kind(desc[0]):
        return (desc[0], desc[1], False)
    if desc[0] == "bool":
        _, must, should, must_not, filt = desc
        if not must and not must_not and not filt and len(should) == 1 \
                and _leaf_scoring_kind(should[0][0]):
            return (should[0][0], should[0][1], True)
    return None


def _fused_plan_bundle(desc: tuple, k: int, agg_desc, sort_spec: tuple,
                       allow_aggs: bool = True, allow_k0: bool = False):
    """Plan-level admission -> (bundle, None) with the static clause
    bundle in eval_node order (must, filter, must_not, should), or
    (None, reject reason). Needs a pure score sort; k == 0 plans only
    where the caller runs the mask-only grid (allow_k0). Clause kinds
    the bundle has no form for (keyword sets, posting-scatter terms)
    are rejected by reason, never half-run. A knn clause rides as a
    must or should `knn_vec` clause beside a text clause (a hybrid
    BM25+vector plan)."""
    if not fused_enabled():
        return None, "disabled"
    if k <= 0 and not allow_k0:
        return None, "k_zero"
    if tuple(sort_spec) != ("_score",):
        return None, "sort"
    if agg_desc and not allow_aggs:
        return None, "aggs_unsupported"
    if _leaf_scoring_kind(desc[0]):
        return (("should", desc[0], desc[1], False),), None
    if desc[0] != "bool":
        return None, f"clause:{desc[0]}"
    _, d_must, d_should, d_not, d_filter = desc
    clauses = []
    for role, group in (("must", d_must), ("filter", d_filter),
                        ("must_not", d_not), ("should", d_should)):
        for c in group:
            leaf = _classify_fused_leaf(c)
            if leaf is not None:
                clauses.append((role,) + leaf)
            elif role in ("filter", "must_not") \
                    and c[0] in RANGE_CLAUSE_KINDS:
                clauses.append((role, c[0], c[1], False))
            elif role in ("must", "should") \
                    and c[0] in VEC_CLAUSE_KINDS:
                # hybrid BM25+knn: scored per tile from the similarity
                # column
                clauses.append((role, c[0], c[1], False))
            else:
                return None, f"clause:{c[0]}"
    if not any(_leaf_scoring_kind(kd) for _r, kd, _f, _w in clauses):
        return None, "no_scoring_clause"
    if len(clauses) > _FUSED_MAX_CLAUSES:
        return None, "too_many_clauses"
    return tuple(clauses), None


def _bundle_inputs(desc: tuple, params: tuple, bundle: tuple, B: int,
                   device: torch.device):
    """Per-clause inputs of an admitted plan -> (cl_inputs, msm [B] i32,
    boost [B] f32 | None), walking desc/params in the group order the
    classifier emitted the bundle in."""
    ones_i = torch.ones((B,), dtype=torch.int32, device=device)
    ones_f = torch.ones((B,), dtype=torch.float32, device=device)
    if desc[0] != "bool":
        if positional_prefix(desc[0]):
            return (tuple(params) + (ones_i, ones_f),), ones_i, None
        qt, wq = _fused_leaf_inputs(desc, params)
        return ((qt, wq, ones_i, ones_f),), ones_i, None
    _, d_must, d_should, d_not, d_filter = desc
    p_must, p_should, p_not, p_filter, msm, boost = params
    groups = {"must": (d_must, p_must), "should": (d_should, p_should),
              "must_not": (d_not, p_not), "filter": (d_filter, p_filter)}
    nxt = {r: 0 for r in groups}
    out = []
    for role, kind, _field, wrapped in bundle:
        dg, pg = groups[role]
        d, p = dg[nxt[role]], pg[nxt[role]]
        nxt[role] += 1
        if kind in RANGE_CLAUSE_KINDS:
            lo, hi, _boost_r = p
            out.append((lo, hi))
        elif kind in VEC_CLAUSE_KINDS:
            # (qv [B, D], boost [B], similarity): the raw clause inputs,
            # which eval_fused_topk / match turn into (col, exists, ub)
            qv, boost_c = p
            out.append((qv, boost_c, d[2]))
        elif wrapped:
            _, _cm, c_should, _cn, _cf = d
            _pm, pc_should, _pn, _pf, msm_c, boost_c = p
            if positional_prefix(kind):
                # positional params ride whole, the wrapper's (msm,
                # boost) last
                out.append(tuple(pc_should[0]) + (msm_c, boost_c))
            else:
                qt, wq = _fused_leaf_inputs(c_should[0], pc_should[0])
                out.append((qt, wq, msm_c, boost_c))
        elif positional_prefix(kind):
            out.append(tuple(p) + (ones_i, ones_f))
        else:
            qt, wq = _fused_leaf_inputs(d, p)
            out.append((qt, wq, ones_i, ones_f))
    return tuple(out), msm, boost


def _fused_pack_ok(segment: Segment, bundle: tuple,
                   device: torch.device) -> str | None:
    """Pack-level admission: every dense clause field needs a forward
    index + tile_max summary, every positional clause field also the
    positions pack, every range clause field per-tile extrema. Returns a
    reject reason or None."""
    for _role, kind, field, _w in bundle:
        if kind in DENSE_CLAUSE_KINDS:
            pf = segment.text.get(field)
            if pf is None or pf.fwd_tids is None or pf.tile_max is None:
                return "missing_tile_max"
        elif positional_prefix(kind):
            for f in clause_fields(field):
                pf = segment.text.get(f)
                if pf is None or pf.fwd_tids is None \
                        or pf.fwd_pos is None or pf.tile_max is None:
                    return "missing_positions_pack"
        elif kind in VEC_CLAUSE_KINDS:
            if segment.vectors.get(field) is None:
                return "missing_vector_column"
        elif not ensure_num_tiles(segment, field, device):
            return "missing_tile_minmax"
    return None


def _fused_params_ok(desc: tuple, params: tuple, bundle: tuple) -> bool:
    """The outer bool boost and every wrapped clause's boost must be > 0:
    boost <= 0 breaks the monotone bound the pruning rests on."""
    if desc[0] != "bool":
        return True
    if not bool((np.asarray(params[5]) > 0).all()):
        return False
    p_groups = {"must": params[0], "should": params[1],
                "must_not": params[2], "filter": params[3]}
    nxt = {r: 0 for r in p_groups}
    for role, kind, _field, wrapped in bundle:
        p = p_groups[role][nxt[role]]
        nxt[role] += 1
        if wrapped and not bool((np.asarray(p[5]) > 0).all()):
            return False
        # a knn clause's tile bound is the max of its boost-folded
        # column: monotone only for a positive boost
        if kind in VEC_CLAUSE_KINDS \
                and not bool((np.asarray(p[1]) > 0).all()):
            return False
    return True


def _fused_row_elems(cap: int, n_tiles: int, k: int,
                     emit_match: bool = False, vec_clauses: int = 0,
                     pos_width: int = 0) -> int:
    """Per-row transient of a fused dispatch in elements: one [*, tile]
    scoring slab, the [*, n_tiles*ck] candidate strip, the [*, cap]
    match mask in emit-match mode, one [*, cap] similarity column per
    knn clause, and the decoded [*, tile, n*P] position slab of the
    widest positional clause (pos_width = n * P) that the plain walk
    builds. The batch chunking sizes from it, as the reference's does."""
    tile = cap // n_tiles
    return tile + n_tiles * min(k, tile) + (cap if emit_match else 0) \
        + vec_clauses * cap + pos_width * tile


def _vec_clauses(bundle: tuple) -> int:
    return sum(kd in VEC_CLAUSE_KINDS for _r, kd, _f, _w in bundle)


def _bundle_pos_width(bundle: tuple, text_cols: dict) -> int:
    """Widest positional clause's decoded position slab in elements per
    doc: n * P for phrase / span, P for bm25f (its per-(field, term)
    decodes are sequential). text_cols is a device seg["text"] dict."""
    w = 0
    for _r, kd, fld, _w2 in bundle:
        if not positional_prefix(kd):
            continue
        head, n, _v = parse_positional_kind(kd)
        for f in clause_fields(fld):
            c = text_cols[f]
            if c.get("fwd_pos") is None or c.get("fwd_tids") is None:
                continue
            p = c["fwd_pos"].shape[-1] // c["fwd_tids"].shape[-1]
            w = max(w, (1 if head == "bm25f" else n) * p)
    return w


def _bundle_positional(bundle: tuple) -> bool:
    return any(positional_prefix(kd) for _r, kd, _f, _w in bundle)


class _FusedScoringStats:
    """Admission (admitted, rejected by reason), positional admission
    (plans carrying positional clauses, queries bound on the host path
    by reason), top-level `knn` admission by reason, and the block-prune
    (doc-tile units) and IVF cluster-prune counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._hard = self._thresholded = self._examined = 0.0
            self._dispatches = 0
            self._admitted = 0
            self._rejected: dict[str, int] = {}
            self._positional: dict[str, int] = {}
            self._positional_admitted = 0
            self._knn: dict[str, int] = {}
            self._ann_probed = self._ann_pruned = self._ann_scored = 0

    def record_admit(self, positional: bool = False) -> None:
        with self._lock:
            self._admitted += 1
            if positional:
                self._positional_admitted += 1

    def record_reject(self, reason: str) -> None:
        with self._lock:
            self._rejected[reason] = self._rejected.get(reason, 0) + 1

    def record_positional(self, reason: str) -> None:
        """One positional query bound to the host phrase / span / BM25F
        path, by reason."""
        with self._lock:
            self._positional[reason] = self._positional.get(reason, 0) + 1

    def record_knn(self, reason: str) -> None:
        """How one top-level `knn` search section was served:
        "query_rewrite" (a bundle clause beside the query), "ivf" (the
        IVF probe), "exact" (the exact scan) or "host_fallback:<why>"."""
        with self._lock:
            self._knn[reason] = self._knn.get(reason, 0) + 1

    def record_ann_prune(self, probed: int, pruned: int,
                         scored: int) -> None:
        """IVF probe counters (ops/ann.ivf_topk stats, per (query,
        cluster)): `pruned` counts probed clusters whose bound could not
        beat the running k-th best, skipped without scoring."""
        with self._lock:
            self._ann_probed += int(probed)
            self._ann_pruned += int(pruned)
            self._ann_scored += int(scored)

    def record_prune(self, hard: float, thresholded: float,
                     examined: float) -> None:
        with self._lock:
            self._hard += float(hard)
            self._thresholded += float(thresholded)
            self._examined += float(examined)
            self._dispatches += 1

    def snapshot(self) -> dict:
        with self._lock:
            pruned = self._hard + self._thresholded
            considered = self._admitted + sum(self._rejected.values())
            return {
                "dispatches": self._dispatches,
                "tiles": {"examined": round(self._examined, 3),
                          "hard_skipped": round(self._hard, 3),
                          "thresholded": round(self._thresholded, 3)},
                "prune_rate": (pruned / self._examined
                               if self._examined else 0.0),
                "ann": {"clusters_probed": self._ann_probed,
                        "clusters_pruned": self._ann_pruned,
                        "clusters_scored": self._ann_scored},
                "admission": {
                    "admitted": self._admitted,
                    "rejected": dict(self._rejected),
                    "knn": dict(self._knn),
                    "positional_fallbacks": dict(self._positional),
                    "positional_admitted": self._positional_admitted,
                    "rate": (self._admitted / considered
                             if considered else 0.0)},
            }


_fused_stats = _FusedScoringStats()


def fused_scoring_stats() -> dict:
    """Snapshot of the fused engine's admission and prune counters."""
    return _fused_stats.snapshot()


def _bundle_cols(seg: dict, bundle: tuple) -> tuple[dict, dict]:
    return ({f: seg["text"][f] for f in bundle_text_fields(bundle)},
            {f: seg["num"][f] for f in bundle_num_fields(bundle)})


def _vec_clause_inputs(seg: dict, bundle: tuple, cl_inputs: tuple) -> tuple:
    """Each knn clause's raw (qv, boost, similarity) input -> the (col,
    exists, ub) triple the bundle walk reads:

      col -- the whole-capacity similarity column with the boost folded
             in, the very ops of eval_node's knn_vec leaf in its order,
             so fused and unfused hybrid scores are equal;
      ub  -- the per-tile max of col, BOUND_SLACK-inflated with the sign
             guard (dot_product can give negative scores, whose bound
             must shrink toward zero): an exact query-time tile bound."""
    if not any(kd in VEC_CLAUSE_KINDS for _r, kd, _f, _w in bundle):
        return cl_inputs
    n_tiles = seg["text"][bundle_primary_field(bundle)]["tile_max"].shape[1]
    out = []
    for (_role, kind, field, _w), inp in zip(bundle, cl_inputs):
        if kind not in VEC_CLAUSE_KINDS:
            out.append(inp)
            continue
        qv, boost_c, sim = inp
        v = seg["vec"][field]
        col = knn_score_column(v["values"], v["norms"], v["exists"], qv,
                               similarity=sim) * boost_c[:, None]
        b, cap = col.shape
        ub = col.reshape(b, n_tiles, cap // n_tiles).amax(dim=2)
        out.append((col, v["exists"], slack_bound(ub)))
    return tuple(out)


def eval_fused_topk(seg: dict, desc: tuple, params: tuple,
                    live: torch.Tensor, k: int, bundle: tuple, B: int,
                    emit_match: bool = False, step=None,
                    init_topk: tuple | None = None, idx_offset: int = 0):
    """Fused score + top-k on K3 -> (top_s [B, k], top_i [B, k], total
    [B], prune_stats f32 [3]) plus the match mask [B, cap] when
    emit_match (the fused + aggs mode), plus timed_out when a `step` is
    given (the stepped walk). `init_topk` / `idx_offset` chain the walk
    onto an earlier segment's selection (the base of a base + delta
    pack)."""
    cl_inputs, msm, boost = _bundle_inputs(desc, params, bundle, B,
                                           seg["_device"])
    cl_inputs = _vec_clause_inputs(seg, bundle, cl_inputs)
    if boost is None:
        boost = torch.ones_like(msm, dtype=torch.float32)
    text_cols, num_cols = _bundle_cols(seg, bundle)
    return cuda_scoring.fused_topk_bundle(
        text_cols, num_cols, bundle, cl_inputs, msm, boost, live, k,
        emit_match=emit_match, step=step, init_topk=init_topk,
        idx_offset=idx_offset)


def eval_fused_match(seg: dict, desc: tuple, params: tuple,
                     live: torch.Tensor, bundle: tuple, B: int,
                     emit_match: bool = True, step=None):
    """Mask-only grid of K3 for k == 0 plans -> (total [B], prune_stats
    f32 [3]) plus the match mask [B, cap] when emit_match, plus
    timed_out when stepped."""
    cl_inputs, msm, boost = _bundle_inputs(desc, params, bundle, B,
                                           seg["_device"])
    cl_inputs = _vec_clause_inputs(seg, bundle, cl_inputs)
    text_cols, num_cols = _bundle_cols(seg, bundle)
    return cuda_scoring.match_mask_bundle(
        text_cols, num_cols, bundle, cl_inputs, msm, boost, live,
        emit_match=emit_match, step=step)


# ---------------------------------------------------------------------------
# Segment body: eval -> top-k -> aggs, chunked over the batch
# ---------------------------------------------------------------------------

# per-chunk transient budget in elements: a batch whose [B, cap] dense
# accumulators would exceed this runs as sequential batch chunks
_CHUNK_ELEMS = 1 << 27


def _chunk_b(B: int, cap: int) -> int:
    bc = B
    while bc > 1 and bc * cap > _CHUNK_ELEMS:
        bc //= 2
    return bc


def _slice_rows(tree, lo: int, hi: int):
    if isinstance(tree, tuple):
        return tuple(_slice_rows(t, lo, hi) for t in tree)
    return tree[lo:hi]


def _cat_rows(trees: list):
    t0 = trees[0]
    if isinstance(t0, tuple):
        return tuple(_cat_rows([t[i] for t in trees]) for i in range(len(t0)))
    if isinstance(t0, dict):
        return {k: _cat_rows([t[k] for t in trees]) for k in t0}
    return torch.cat(trees, dim=0)


def _segment_body(seg: dict, params: tuple, live: torch.Tensor,
                  live_views: dict, agg_params: tuple, sort_params: tuple,
                  *, B: int, desc: tuple, agg_desc: tuple, cap: int, k: int,
                  sort_spec: tuple, fused: tuple | None = None, step=None):
    """The segment evaluation; a `step` (the resident loop's stepped
    walk, fused plans only) appends the walk's timed_out verdict."""
    if fused is not None:
        # the fused transient per row, not the dense [*, cap]
        n_tiles = seg["text"][bundle_primary_field(fused)][
            "tile_max"].shape[1]
        row_elems = _fused_row_elems(
            cap, n_tiles, k, emit_match=bool(agg_desc),
            vec_clauses=_vec_clauses(fused),
            pos_width=_bundle_pos_width(fused, seg["text"]))
    else:
        row_elems = cap
    # a stepped body never B-chunks: its deadline verdict covers one walk
    bc = B if step is not None else _chunk_b(B, row_elems)
    kw = dict(desc=desc, agg_desc=agg_desc, cap=cap, k=k,
              sort_spec=sort_spec, fused=fused)
    if bc >= B:
        return _segment_body_one(seg, params, live, live_views, agg_params,
                                 sort_params, B=B, step=step, **kw)
    parts = [_segment_body_one(seg, _slice_rows(params, lo, lo + bc), live,
                               live_views, agg_params, sort_params, B=bc,
                               **kw)
             for lo in range(0, B, bc)]
    return _cat_rows(parts)


def _segment_body_fused(seg: dict, params: tuple, live: torch.Tensor,
                        live_views: dict, agg_params: tuple, *, B: int,
                        desc: tuple, agg_desc: tuple, cap: int, k: int,
                        bundle: tuple, step=None):
    """The fused branch: K3 never materialises the [B, cap] score
    matrix; with aggs it emits the exact match mask for the agg pass.
    A `step` appends the stepped walk's timed_out verdict."""
    device = seg["_device"]
    emit = bool(agg_desc)
    step_tail = ()
    if k == 0:
        out = eval_fused_match(seg, desc, params, live, bundle, B,
                               emit_match=emit, step=step)
        total, pruned = out[:2]
        top_score = torch.zeros((B, 0), dtype=torch.float32, device=device)
        top_idx = torch.zeros((B, 0), dtype=torch.int32, device=device)
    else:
        out = eval_fused_topk(seg, desc, params, live, k, bundle, B,
                              emit_match=emit, step=step)
        top_score, top_idx, total, pruned = out[:4]
    if step is not None:
        step_tail, out = (out[-1],), out[:-1]
    agg_out = {}
    if emit:
        plan = _agg_view_plan(desc, agg_desc, agg_params, seg, live_views)
        views = _ViewMasks(desc, params, seg, live_views, cap, B)
        agg_out = eval_aggs(agg_desc, agg_params, seg, out[-1], views=views,
                            plan=plan)
    # each row carries its share of the dispatch's prune stats, so a
    # row sum at collect time gives the totals of a chunked batch too
    prune_rows = (pruned / B)[None, :].expand(B, 3)
    top_missing = torch.zeros_like(top_idx, dtype=torch.bool)
    return ((top_score, top_score, top_idx, total, top_missing), agg_out,
            prune_rows) + step_tail


def _segment_body_one(seg: dict, params: tuple, live: torch.Tensor,
                      live_views: dict, agg_params: tuple,
                      sort_params: tuple, *, B: int, desc: tuple,
                      agg_desc: tuple, cap: int, k: int, sort_spec: tuple,
                      fused: tuple | None = None, step=None):
    if fused is not None:
        return _segment_body_fused(seg, params, live, live_views,
                                   agg_params, B=B, desc=desc,
                                   agg_desc=agg_desc, cap=cap, k=k,
                                   bundle=fused, step=step)
    device = seg["_device"]
    plan = _agg_view_plan(desc, agg_desc, agg_params, seg, live_views)
    views = _ViewMasks(desc, params, seg, live_views, cap, B)
    # aggs-only requests whose every agg node rides a sorted view skip
    # the doc-space query eval entirely (total comes from a view mask)
    skip_doc = bool(k == 0 and sort_spec == ("_score",) and agg_desc
                    and plan and all(plan))
    if skip_doc:
        valid = None
        node0 = agg_desc[0][1]
        key0 = (("kw", node0[1]) if node0[0] == "terms_kw"
                else ("num", node0[1]))
        total = views.mask(key0).sum(dim=-1, dtype=torch.int32)
    else:
        score, match = eval_node(desc, params, seg, cap, B)
        valid = match & live[None, :]
        score = torch.where(valid, score, 0.0)

    if k == 0:
        top_score = torch.zeros((B, 0), dtype=torch.float32, device=device)
        top_idx = torch.zeros((B, 0), dtype=torch.int32, device=device)
        top_missing = torch.zeros((B, 0), dtype=torch.bool, device=device)
        if not skip_doc:
            total = valid.sum(dim=-1, dtype=torch.int32)
        agg_out = eval_aggs(agg_desc, agg_params, seg, valid, views=views,
                            plan=plan)
        return ((top_score, top_score, top_idx, total, top_missing), agg_out,
                _zeros(B, 3, device))

    if sort_spec[0] == "_score":
        top_key, top_idx, total = top_k_hits(score, valid, k)
        top_score = top_key
        top_missing = torch.zeros_like(top_idx, dtype=torch.bool)
    else:
        _, field, descending, kindtag = sort_spec
        if kindtag == "kw" and field in seg["kw"]:
            # segment-local ordinals -> shard-global ords so the key is
            # comparable across segments
            (s2g,) = sort_params
            local = seg["kw"][field]
            keys = s2g[local.clamp(min=0).to(torch.int64)]
            missing = local < 0
        elif kindtag == "num" and field in seg["num"]:
            col = seg["num"][field]
            keys = col.get("sort_values", col["values"])
            missing = ~seg["num"][field]["exists"]
        else:  # field absent from this whole segment
            keys = torch.zeros((cap,), dtype=torch.int32, device=device)
            missing = torch.ones((cap,), dtype=torch.bool, device=device)
        top_key, top_idx, total, top_missing = top_k_by_field(
            keys, valid, missing, k, descending)
        top_score = score.gather(1, top_idx.to(torch.int64))
    agg_out = eval_aggs(agg_desc, agg_params, seg, valid, views=views,
                        plan=plan)
    return ((top_score, top_key, top_idx, total, top_missing), agg_out,
            _zeros(B, 3, device))


# ---------------------------------------------------------------------------
# Public per-segment entry: async dispatch + synchronising collect
# ---------------------------------------------------------------------------


def _device_live(segment: Segment, live: np.ndarray,
                 device: torch.device) -> torch.Tensor:
    """Cache the live-mask upload per (segment, mask identity, device)."""
    cached = getattr(segment, "_live_dev", None)
    if cached is not None and cached[0] is live and cached[1] == device:
        return cached[2]
    dev = _up(np.asarray(live, dtype=bool), device)
    segment._live_dev = (live, device, dev)  # type: ignore[attr-defined]
    return dev


def _live_views_for(segment: Segment, live_dev: torch.Tensor,
                    agg_desc: tuple, device: torch.device) -> dict:
    """Layout-permuted live masks for every agg layout that carries
    sorted-view projections, cached per live-mask upload."""
    if not agg_desc:
        return {}
    dev = device_arrays(segment, device)
    cache = getattr(segment, "_live_view_cache", None)
    if cache is None or cache[0] is not live_dev:
        cache = (live_dev, {})
        segment._live_view_cache = cache  # type: ignore[attr-defined]
    out = {}
    for lkind, store_name in (("kw", "kw_sorted"), ("num", "num_sorted")):
        for f, store in dev.get(store_name, {}).items():
            if "vw_num" not in store and "vw_kw" not in store:
                continue
            key = (lkind, f)
            if key not in cache[1]:
                cache[1][key] = live_dev[store["perm"].to(torch.int64)]
            out[key] = cache[1][key]
    return out


def _sort_key_is_float(segment: Segment, sort_spec: tuple) -> bool:
    if sort_spec[0] == "_score":
        return True
    _, field, _desc, kindtag = sort_spec[:4]
    if kindtag == "num" and field in segment.numerics:
        return segment.numerics[field].values.dtype == np.float32
    return False  # kw ords / absent field path


def execute_segment_async(segment: Segment, live: np.ndarray,
                          bounds: Sequence[Bound], k: int,
                          agg_desc: tuple = (), agg_params: tuple = (),
                          sort_spec: tuple = ("_score",),
                          sort_params: tuple = (),
                          device: torch.device | None = None,
                          deadline: float | None = None,
                          shard_key: tuple | None = None):
    """Enqueue one batched query against one segment WITHOUT syncing.

    Returns (device outputs, layout, n_real) for collect_segment_result.
    The batch is padded to a power of two (repeating the last bound), as
    in the reference. With ES_TPU_RESIDENT_LOOP set, fused-admitted
    plans go through a pinned resident entry (`_execute_resident`):
    `deadline` (absolute monotonic seconds) then arms the per-chunk
    deadline check of the stepped walk, and collect raises
    SearchTimeoutError (labelled with `shard_key` = (index, shard)) when
    the walk reports timed_out. The cold path ignores both; its deadline
    stays cooperative at the caller's collect boundary."""
    if device is None:
        raise ValueError("execute_segment_async needs the reader's device")
    n_real = len(bounds)
    if n_real == 0:
        raise ValueError("execute_segment requires at least one bound query")
    b_pad = next_pow2(n_real, floor=1)
    if b_pad != n_real:
        bounds = list(bounds) + [bounds[-1]] * (b_pad - n_real)
    desc, params = finalize(bounds)
    k_eff = min(k, segment.capacity)
    # fused admission: the plan classifier accepts the bundle, the pack
    # carries the tile summaries, and every bool boost is positive
    bundle, reject = _fused_plan_bundle(desc, k_eff, agg_desc, sort_spec,
                                        allow_k0=True)
    if bundle is not None:
        reject = _fused_pack_ok(segment, bundle, device)
        if reject is None and not _fused_params_ok(desc, params, bundle):
            reject = "nonpositive_boost"
        if reject is not None:
            bundle = None
    if bundle is not None:
        _fused_stats.record_admit(positional=_bundle_positional(bundle))
    else:
        _fused_stats.record_reject(reject)
    if _resident.enabled():
        if bundle is not None and _resident_admit(segment, bundle):
            return _execute_resident(
                segment, live, desc, params, agg_desc, agg_params,
                sort_spec, sort_params, bundle, _resident_backend(),
                k_eff, b_pad, deadline, shard_key, n_real, device)
        # resident mode on, but the plan fell outside residency
        # admission (unfused): cold dispatch
        _resident.stats.cold_dispatches.inc()
    dev = device_arrays(segment, device)
    live_dev = _device_live(segment, live, device)
    live_views = _live_views_for(segment, live_dev, agg_desc, device)
    wire, pack_static = _pack_trees(params, tuple(agg_params),
                                    tuple(sort_params))
    wire_dev = torch.from_numpy(wire).to(device, non_blocking=True)
    params_d, agg_params_d, sort_params_d = _unpack_trees(wire_dev,
                                                          pack_static)
    out = _segment_body(
        dev, params_d, live_dev, live_views, agg_params_d, sort_params_d,
        B=b_pad, desc=desc, agg_desc=agg_desc, cap=segment.capacity, k=k_eff,
        sort_spec=sort_spec, fused=bundle)
    # the host wire stays referenced until collect: the upload may still
    # be reading it
    layout = {"k": k_eff, "wire": wire, "fused": bundle is not None,
              "key_is_float": _sort_key_is_float(segment, sort_spec)}
    return out, layout, n_real


def _agg_host_leaves(f: np.ndarray, f_off: int, shapes: list,
                     n_real: int) -> list:
    """The agg leaves' columns of a host f32 buffer, reshaped."""
    out = []
    for shape in shapes:
        size = int(np.prod(shape)) if shape else 1
        out.append(f[:, f_off: f_off + size].reshape(n_real, *shape))
        f_off += size
    return out


def collect_segment_result(out, layout, n_real: int):
    """Sync + copy to host + slice back to the true B. Returns the
    reference's shape: ((top_score, top_key, top_idx, total,
    top_missing), agg partial tree of float32 numpy arrays). A fused
    dispatch's prune stats (summed over the real rows) go to
    fused_scoring_stats(). A resident dispatch's wire carries the
    stepped walk's timed_out verdict as a trailing i32 column: set, it
    raises SearchTimeoutError and counts preempted_by_deadline."""
    if layout.get("resident"):
        return _collect_resident(out, layout, n_real)
    (top_score, top_key, top_idx, total, top_missing), agg_out, prune = out
    B = top_score.shape[0]
    k = layout["k"]
    f_parts = [top_score]
    i_parts = [top_idx, total[:, None], top_missing.to(torch.int32)]
    (f_parts if layout["key_is_float"] else i_parts).append(
        top_key.to(torch.float32 if layout["key_is_float"] else torch.int32))
    f_parts.append(prune.to(torch.float32))
    agg_leaves = _leaves(agg_out, [])
    f_parts += [leaf.reshape(B, -1).to(torch.float32) for leaf in agg_leaves]
    fbuf = torch.cat(f_parts, dim=1).cpu().numpy()[:n_real]
    ibuf = torch.cat(i_parts, dim=1).cpu().numpy()[:n_real]
    top_score_h = fbuf[:, 0:k]
    top_idx_h = ibuf[:, 0:k]
    total_h = ibuf[:, k]
    top_missing_h = ibuf[:, k + 1: 2 * k + 1].astype(bool)
    if layout["key_is_float"]:
        top_key_h = fbuf[:, k: 2 * k]
        f_off = 2 * k
    else:
        top_key_h = ibuf[:, 2 * k + 1: 3 * k + 1]
        f_off = k
    if layout.get("fused"):
        hard, thr, examined = fbuf[:, f_off: f_off + 3].sum(axis=0)
        _fused_stats.record_prune(hard, thr, examined)
    f_off += 3
    host_leaves = _agg_host_leaves(
        fbuf, f_off, [tuple(leaf.shape[1:]) for leaf in agg_leaves], n_real)
    agg_host = _rebuild(agg_out, iter(host_leaves))
    return (top_score_h, top_key_h, top_idx_h, total_h, top_missing_h), \
        agg_host


# ---------------------------------------------------------------------------
# Base+delta pack dispatch (streaming write path)
#
# In delta mode the reader holds ONE immutable base segment and ONE small
# delta segment. A fused-admitted plan searches both in one dispatch: the
# base walk runs first, its running top-k (threshold included) carries
# into the delta walk through the init_topk / idx_offset chaining of
# `fused_topk_bundle`, and the aggregation passes run per sub-segment
# (ordinal spaces stay segment-local, so the partials meet in the same
# host reduce two dispatches would feed). The collect splits the merged
# top-k back into per-segment candidate lists, so responses are
# identical to the per-segment path's.
# ---------------------------------------------------------------------------


def _wire_out(i_parts: list, f_parts: list) -> torch.Tensor:
    """One int32 [B, W] result buffer: the i32 columns, then the f32
    columns as their bits (the reference's packed output wire)."""
    ibuf = torch.cat([p.to(torch.int32) for p in i_parts], dim=1)
    fbuf = torch.cat([p.to(torch.float32) for p in f_parts], dim=1)
    return torch.cat([ibuf, fbuf.contiguous().view(torch.int32)], dim=1)


def _pack_body(seg_b: dict, seg_d: dict, params_b: tuple, params_d: tuple,
               live_b: torch.Tensor, live_d: torch.Tensor,
               live_views_b: dict, live_views_d: dict, agg_params_b: tuple,
               agg_params_d: tuple, *, B: int, desc: tuple, agg_desc: tuple,
               cap_b: int, cap_d: int, k: int, bundle: tuple, step=None):
    """Fused base+delta evaluation: ONE selection over both packs plus
    per-sub-segment aggregation passes. Returns the _segment_body shape
    with `totals` widened to [B, 2] (per-sub-segment exact hit counts,
    which the host split needs) and the agg tree replaced by the (base,
    delta) PAIR of trees. With a `step`, the per-chunk deadline check
    rides the BASE walk (the dominant cost; the delta walk is bounded by
    the compaction threshold) and its verdict is appended."""
    device = seg_b["_device"]
    emit = bool(agg_desc)
    step_tail = ()

    def aggs_for(seg, params, live_views, agg_params, match, cap):
        plan = _agg_view_plan(desc, agg_desc, agg_params, seg, live_views)
        views = _ViewMasks(desc, params, seg, live_views, cap, B)
        return eval_aggs(agg_desc, agg_params, seg, match, views=views,
                         plan=plan)

    if k == 0:
        out_b = eval_fused_match(seg_b, desc, params_b, live_b, bundle, B,
                                 emit_match=emit, step=step)
        if step is not None:
            step_tail, out_b = (out_b[-1],), out_b[:-1]
        out_d = eval_fused_match(seg_d, desc, params_d, live_d, bundle, B,
                                 emit_match=emit)
        top_s = torch.zeros((B, 0), dtype=torch.float32, device=device)
        top_i = torch.zeros((B, 0), dtype=torch.int32, device=device)
    else:
        # the base walk opens at the PACK's k width (not min'd against
        # the base capacity alone) and the delta walk chains onto its
        # state with ids offset past the base capacity
        k_pack = min(k, cap_b + cap_d)
        out_b = eval_fused_topk(seg_b, desc, params_b, live_b, k_pack,
                                bundle, B, emit_match=emit, step=step,
                                init_topk=running_topk_init(B, k_pack,
                                                            device))
        if step is not None:
            step_tail, out_b = (out_b[-1],), out_b[:-1]
        top_s, top_i = out_b[0], out_b[1]
        out_d = eval_fused_topk(seg_d, desc, params_d, live_d, k_pack,
                                bundle, B, emit_match=emit,
                                init_topk=(top_s, top_i), idx_offset=cap_b)
        top_s, top_i = out_d[0], out_d[1]
        out_b, out_d = out_b[2:], out_d[2:]
    agg_pair = ({}, {})
    if emit:
        agg_pair = (aggs_for(seg_b, params_b, live_views_b, agg_params_b,
                             out_b[2], cap_b),
                    aggs_for(seg_d, params_d, live_views_d, agg_params_d,
                             out_d[2], cap_d))
    totals = torch.stack([out_b[0], out_d[0]], dim=1)
    prune = (out_b[1] + out_d[1]).to(torch.float32)
    top_missing = torch.zeros_like(top_i, dtype=torch.bool)
    return ((top_s, top_s, top_i, totals, top_missing), agg_pair,
            (prune / B)[None, :].expand(B, 3)) + step_tail


def _pack_wire(body_out, timed=None) -> torch.Tensor:
    """A pack body's outputs as the reference's pack wire: [top_idx |
    totals (2) | top_missing | (timed_out) | top_score | prune | agg
    leaves of the (base, delta) pair]."""
    (top_s, _tk, top_i, totals, top_missing), agg_pair, prune = body_out
    B = top_s.shape[0]
    i_parts = [top_i, totals, top_missing.to(torch.int32)]
    if timed is not None:
        i_parts.append(torch.full((B, 1), int(timed), dtype=torch.int32,
                                  device=top_s.device))
    f_parts = [top_s, prune] + [leaf.reshape(B, -1)
                                for leaf in _leaves(agg_pair, [])]
    return _wire_out(i_parts, f_parts)


def _agg_skeleton(tree):
    """`tree`'s structure with None leaves (a layout holds no tensors)."""
    return _rebuild(tree, iter([None] * len(_leaves(tree, []))))


def _pack_output_layout(body_out, cap_b: int) -> dict:
    """Host-side layout of a pack dispatch's wire: k, the agg pair's
    structure and leaf shapes."""
    (top_s, *_rest), agg_pair, _prune = body_out
    return {
        "k": int(top_s.shape[1]),
        "key_is_float": True,
        "agg_skel": _agg_skeleton(agg_pair),
        "agg_shapes": [tuple(leaf.shape[1:])
                       for leaf in _leaves(agg_pair, [])],
        "fused": True,
        "pack": True,
        "cap_b": cap_b,
    }


def _pack_admit(base: Segment, delta: Segment, bounds_b, bounds_d, k: int,
                agg_desc: tuple, sort_spec: tuple, device: torch.device):
    """Pack admission (the reference's tests, in its order) -> (desc,
    params_b, params_d, bundle, k_eff, b_pad, n_real), or None when the
    pair takes the per-segment path."""
    n_real = len(bounds_b)
    if n_real == 0 or len(bounds_d) != n_real:
        return None
    if tuple(sort_spec) != ("_score",):
        return None
    b_pad = next_pow2(n_real, floor=1)
    if b_pad != n_real:
        bounds_b = list(bounds_b) + [bounds_b[-1]] * (b_pad - n_real)
        bounds_d = list(bounds_d) + [bounds_d[-1]] * (b_pad - n_real)
    desc, params_b = finalize(bounds_b)
    desc_d, params_d = finalize(bounds_d)
    if desc != desc_d:
        return None  # segment-local binds diverged structurally
    cap_b, cap_d = base.capacity, delta.capacity
    k_eff = min(k, cap_b + cap_d)
    bundle, _reject = _fused_plan_bundle(desc, k_eff, agg_desc, sort_spec,
                                         allow_k0=True)
    if bundle is None:
        return None
    if _fused_pack_ok(base, bundle, device) is not None \
            or _fused_pack_ok(delta, bundle, device) is not None:
        return None
    if not _fused_params_ok(desc, params_b, bundle) \
            or not _fused_params_ok(desc, params_d, bundle):
        return None
    f0 = bundle_primary_field(bundle)
    row_elems = 0
    for seg in (base, delta):
        text = device_arrays(seg, device)["text"]
        row_elems += _fused_row_elems(
            seg.capacity, seg.text[f0].tile_max.shape[1], k_eff,
            emit_match=bool(agg_desc), vec_clauses=_vec_clauses(bundle),
            pos_width=_bundle_pos_width(bundle, text))
    if _chunk_b(b_pad, row_elems) < b_pad:
        # a batch this wide needs the per-segment path's B-chunked body
        # (the pack body runs one un-chunked walk so its carried top-k
        # spans the whole batch)
        return None
    return desc, params_b, params_d, bundle, k_eff, b_pad, n_real


def execute_pack_async(base: Segment, delta: Segment, live_b: np.ndarray,
                       live_d: np.ndarray, bounds_b: Sequence[Bound],
                       bounds_d: Sequence[Bound], k: int,
                       agg_desc: tuple = (), agg_params_b: tuple = (),
                       agg_params_d: tuple = (),
                       sort_spec: tuple = ("_score",),
                       device: torch.device | None = None,
                       deadline: float | None = None,
                       shard_key: tuple | None = None):
    """Dispatch one batched query against a (base, delta) generation pair
    as ONE dispatch (see _pack_body), without syncing. Returns (out,
    layout, n_real) for collect_pack_result, or None when the plan/pack
    pair is not pack-admissible (the caller falls back to per-segment
    dispatches; responses are identical either way). With
    ES_TPU_RESIDENT_LOOP set the pair goes through a pinned resident
    entry (`_execute_pack_resident`), whose stepped base walk checks
    `deadline` per chunk."""
    if device is None:
        raise ValueError("execute_pack_async needs the reader's device")
    adm = _pack_admit(base, delta, bounds_b, bounds_d, k, agg_desc,
                      sort_spec, device)
    if adm is None:
        return None
    desc, params_b, params_d, bundle, k_eff, b_pad, n_real = adm
    _fused_stats.record_admit(positional=_bundle_positional(bundle))
    if _resident.enabled():
        return _execute_pack_resident(
            base, delta, live_b, live_d, desc, params_b, params_d,
            agg_desc, agg_params_b, agg_params_d, bundle,
            _resident_backend(), k_eff, b_pad, deadline, shard_key, n_real,
            device)
    dev_b, dev_d = device_arrays(base, device), device_arrays(delta, device)
    live_dev_b = _device_live(base, live_b, device)
    live_dev_d = _device_live(delta, live_d, device)
    views_b = _live_views_for(base, live_dev_b, agg_desc, device)
    views_d = _live_views_for(delta, live_dev_d, agg_desc, device)
    wire, pack_static = _pack_trees(params_b, params_d, tuple(agg_params_b),
                                    tuple(agg_params_d))
    wire_dev = torch.from_numpy(wire).to(device, non_blocking=True)
    p_b, p_d, a_b, a_d = _unpack_trees(wire_dev, pack_static)
    body = _pack_body(dev_b, dev_d, p_b, p_d, live_dev_b, live_dev_d,
                      views_b, views_d, a_b, a_d, B=b_pad, desc=desc,
                      agg_desc=agg_desc, cap_b=base.capacity,
                      cap_d=delta.capacity, k=k_eff, bundle=bundle)
    layout = {**_pack_output_layout(body, base.capacity),
              "wire": wire}
    return _pack_wire(body), layout, n_real


def _collect_wire(out, layout: dict) -> np.ndarray:
    """A dispatch's int32 result wire on the host: a resident one from
    its pinned fetch buffer (the copy started at enqueue), a cold one
    copied now."""
    if layout.get("resident"):
        return _finish_fetch(out)
    return out.cpu().numpy()


def _raise_if_timed(wire: np.ndarray, col: int, layout: dict) -> None:
    """The stepped walk's timed_out column: set, the dispatch raises
    SearchTimeoutError and counts as preempted."""
    if bool(wire[:, col].any()):
        _resident.stats.preempted_by_deadline.inc()
        sk = layout.get("shard_key") or (None, None)
        raise SearchTimeoutError(sk[0], sk[1])


def collect_pack_result(out, layout, n_real: int):
    """Collect a pack dispatch and split the merged selection back into
    PER-SEGMENT candidate lists (scores stay sorted; ids below cap_b are
    base rows, the rest delta rows offset by cap_b), so the ordinary
    cross-segment response merge consumes them unchanged. Returns
    ([base_top, delta_top], [base_aggs, delta_aggs]); the top tuples
    carry a 6th element, the per-row VALID count (a split list can hold
    fewer than min(total, k) entries when the other side won the
    window)."""
    wire = _collect_wire(out, layout)[:n_real]
    k = layout["k"]
    n_i = 2 * k + 2
    n_i_total = n_i
    if layout.get("resident"):
        n_i_total += 1
        _raise_if_timed(wire, n_i, layout)
    ibuf = wire[:, :n_i_total]
    fbuf = np.ascontiguousarray(wire[:, n_i_total:]).view(np.float32)
    top_idx = ibuf[:, :k]
    totals = ibuf[:, k: k + 2]
    top_score = fbuf[:, :k]
    hard, thr, examined = fbuf[:, k: k + 3].sum(axis=0)
    _fused_stats.record_prune(hard, thr, examined)
    agg_b, agg_d = _rebuild(layout["agg_skel"], iter(_agg_host_leaves(
        fbuf, k + 3, layout["agg_shapes"], n_real)))
    cap_b = layout["cap_b"]
    B = n_real
    sb = np.full((B, k), -np.inf, np.float32)
    sd = np.full((B, k), -np.inf, np.float32)
    ib = np.zeros((B, k), np.int32)
    idd = np.zeros((B, k), np.int32)
    vb = np.zeros(B, np.int32)
    vd = np.zeros(B, np.int32)
    for r in range(B):
        valid = top_score[r] > -np.inf
        idxs = top_idx[r][valid]
        scs = top_score[r][valid]
        mb = idxs < cap_b
        nb = int(mb.sum())
        nd = int(valid.sum()) - nb
        sb[r, :nb] = scs[mb]
        ib[r, :nb] = idxs[mb]
        vb[r] = nb
        sd[r, :nd] = scs[~mb]
        idd[r, :nd] = idxs[~mb] - cap_b
        vd[r] = nd
    miss = np.zeros((B, k), bool)
    top_b = (sb, sb, ib, totals[:, 0], miss, vb)
    top_d = (sd, sd, idd, totals[:, 1], miss, vd)
    return [top_b, top_d], [agg_b, agg_d]


# ---------------------------------------------------------------------------
# Resident query loop (search/resident.py): pinned stepped dispatches
# ---------------------------------------------------------------------------

# tile-walk chunks of a resident dispatch: the host checks the deadline
# before each chunk launch (and once after the last), so a laggard walk
# exits within one chunk of the cutoff instead of finishing
_RESIDENT_CHUNKS = max(1, int(os.environ.get("ES_TPU_RESIDENT_CHUNKS",
                                             "8")))


def _step_poll(hi: float, lo: float, timed: bool) -> bool:
    """Host half of the per-chunk deadline check: `hi + lo` is the
    absolute monotonic deadline (`_split_deadline`); once a chunk
    reports late the verdict sticks."""
    if timed:
        return True
    deadline = float(hi) + float(lo)
    return math.isfinite(deadline) and time.monotonic() > deadline


def _resident_step(deadline: float | None, chunk_tiles: int) -> tuple:
    """The ops-layer step tuple (chunk_tiles, init_state, check) of a
    resident dispatch. The check chains the timed verdict through the
    walk's state and polls `_step_poll`; without a finite deadline it
    can never report late, so it polls nothing and tells the walk not
    to wait on the device between chunks (`sync` False)."""
    hi, lo = _split_deadline(deadline)
    if not math.isfinite(hi):
        def check(_c, timed):
            return timed, timed
        check.sync = False
    else:
        def check(_c, timed):
            timed = _step_poll(hi, lo, timed)
            return timed, timed
    return (chunk_tiles, False, check)


def _split_deadline(deadline: float | None) -> tuple[float, float]:
    """f64 monotonic deadline -> (f32-representable hi, remainder lo),
    the reference's two-half form (hi + lo reconstructs it); +inf
    disables."""
    if deadline is None:
        return float("inf"), 0.0
    hi = float(np.float32(deadline))
    return hi, deadline - hi


def _resident_backend() -> str:
    """The engine a resident entry pins. The reference resolves XLA or
    Pallas without timing (forced env, the tuner's cached choice); the
    port has one engine, K3, so every admitted bundle pins it."""
    return "cuda"


def _resident_admit(segment: Segment, bundle: tuple) -> bool:
    """Residency admission on top of fused admission: with one engine
    and no tuning wait, every fused-admitted plan is resident-able."""
    return bundle is not None


def _dev_leaves(tree, path: tuple = ()):
    """(key path, tensor) of every column of an uploaded tree, in key
    order (lazy uploads add keys in the order queries need them)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            if k != "_device":
                yield from _dev_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _dev_struct(dev) -> tuple:
    """The key structure of an uploaded column tree: lazy uploads
    (sorted agg views, tile extrema) change it, and with it an entry's
    key, as the reference's tree structure does."""
    return tuple(p for p, _t in _dev_leaves(dev))


def _dev_shape_sig(dev) -> tuple:
    """Shape/dtype signature of an uploaded pack tree. Part of the
    resident entry key of a delta segment, which keys by generation
    (not content): within a pow2 bucket it is constant across epoch
    bumps (what pad_delta_shapes buys)."""
    return tuple((tuple(t.shape), str(t.dtype)) for _p, t in _dev_leaves(dev))


def _resident_entry_key(segment: Segment, desc, agg_desc, sort_spec,
                        k_res: int, b_pad: int, pack_sig, dev_struct,
                        view_keys, bundle, backend: str,
                        shape_sig: tuple = ()):
    return (seg_cache_key(segment), segment.capacity, desc, agg_desc,
            sort_spec, k_res, b_pad, pack_sig, dev_struct, view_keys,
            bundle, backend, shape_sig)


def seg_cache_key(segment: Segment) -> str:
    """The key every fingerprint-keyed cache (resident entries) indexes a
    pack under: base segments key on content, DELTA segments on their
    (base generation, pow2 capacity bucket), so a refresh's delta
    rebuild lands on the same key (Segment.cache_key)."""
    return segment.cache_key()


def _new_plan(wire: np.ndarray, device: torch.device, chunk_tiles: int,
              n_chunks: int) -> dict:
    """A resident entry's pinned dispatch state: the chunk plan, the
    staged feed (a pinned host buffer and its device twin), the fetch
    buffer (pinned at the first fetch, when its width is known) and the
    output layout (set by the first dispatch)."""
    cuda = device.type == "cuda"
    return {"chunk_tiles": chunk_tiles, "n_chunks": n_chunks,
            "feed_host": (torch.empty(wire.shape, dtype=torch.int32,
                                      pin_memory=True) if cuda else None),
            "feed_dev": torch.empty(wire.shape, dtype=torch.int32,
                                    device=device),
            "feed_done": None, "fetch_host": None, "fetch_busy": False,
            "layout": None}


def _plan_bytes(plan: dict) -> int:
    return sum(t.numel() * t.element_size()
               for t in (plan["feed_host"], plan["feed_dev"],
                         plan["fetch_host"]) if t is not None)


def _stage_feed(plan: dict, wire: np.ndarray,
                device: torch.device) -> torch.Tensor:
    """The feed stage: the param wire into the pinned host buffer (once
    the previous feed's upload has finished reading it), then a
    non-blocking upload into the entry's device buffer, ordered on the
    stream after every earlier dispatch that reads it."""
    feed_dev = plan["feed_dev"]
    if device.type != "cuda":
        feed_dev.copy_(torch.from_numpy(wire))
        return feed_dev
    if plan["feed_done"] is not None:
        plan["feed_done"].synchronize()
    plan["feed_host"].numpy()[:] = wire
    feed_dev.copy_(plan["feed_host"], non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    plan["feed_done"] = done
    return feed_dev


def _start_fetch(plan: dict, buf: torch.Tensor) -> dict:
    """The fetch stage: the result wire's device-to-host copy into the
    entry's pinned buffer, started now, with an event collect waits on.
    A dispatch whose entry buffer still holds an uncollected result gets
    a pinned buffer of its own."""
    if buf.device.type != "cuda":
        return {"host": buf, "event": None, "plan": None}
    host, owner = None, None
    if not plan["fetch_busy"]:
        if plan["fetch_host"] is None \
                or tuple(plan["fetch_host"].shape) != tuple(buf.shape):
            plan["fetch_host"] = torch.empty(buf.shape, dtype=buf.dtype,
                                             pin_memory=True)
        host, owner = plan["fetch_host"], plan
        plan["fetch_busy"] = True
    else:
        host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
    host.copy_(buf, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(buf.device))
    return {"host": host, "event": event, "plan": owner}


def _finish_fetch(handle: dict) -> np.ndarray:
    """Wait for a fetch and take its bytes off the pinned buffer."""
    if handle["event"] is not None:
        handle["event"].synchronize()
    out = handle["host"].numpy().copy()
    if handle["plan"] is not None:
        handle["plan"]["fetch_busy"] = False
    return out


def _resident_entry(key, segment: Segment, label: str, wire: np.ndarray,
                    device: torch.device, n_tiles: int, generation: str,
                    delta: Segment | None = None):
    """The pinned entry of `key` (a hit, counted), or a new one (a cold
    dispatch, counted) pinned under `generation`. A delta segment (or a
    pack, keyed by its delta) passes its epoch, so a hit after a refresh
    counts as a refresh reuse; its entry holds no segment weakref (the
    epoch's segment dies at every refresh, the entry must not)."""
    d = delta if delta is not None else segment
    is_delta = d.delta_parent is not None
    entry = _resident.cache.get(
        key, delta_epoch=d.delta_epoch if is_delta else None)
    if entry is not None:
        return entry
    _resident.stats.cold_dispatches.inc()
    chunk_tiles = max(1, -(-n_tiles // _RESIDENT_CHUNKS))
    entry = _resident.ResidentEntry(
        key, label=label,
        plan=_new_plan(wire, device, chunk_tiles, -(-n_tiles // chunk_tiles)),
        seg_id=segment.seg_id, fingerprint=segment.fingerprint(),
        seg_ref=None if is_delta else _resident.make_ref(segment),
        backend=_resident_backend(), generation=generation,
        delta_epoch=d.delta_epoch)
    _resident.cache.put(entry)
    return entry


def _execute_resident(segment: Segment, live, desc: tuple, params: tuple,
                      agg_desc: tuple, agg_params: tuple, sort_spec: tuple,
                      sort_params: tuple, bundle: tuple, backend: str,
                      k_eff: int, b_pad: int, deadline: float | None,
                      shard_key: tuple | None, n_real: int,
                      device: torch.device):
    """Serve one dispatch through a pinned resident entry: stage the
    param feed through its pinned buffer, run the stepped K3 walk of its
    chunk plan (the deadline checked before each chunk), start the
    result's fetch into its pinned buffer. k is bucketed to its next
    power of two so nearby request sizes share one entry; the response
    window is a prefix of the larger top-k, so responses are
    unchanged."""
    cap = segment.capacity
    k_res = min(next_pow2(max(k_eff, 1), floor=1), cap) if k_eff > 0 else 0
    n_tiles = segment.text[bundle_primary_field(bundle)].tile_max.shape[1]
    dev = device_arrays(segment, device)
    live_dev = _device_live(segment, live, device)
    live_views = _live_views_for(segment, live_dev, agg_desc, device)
    wire, pack_static = _pack_trees(params, tuple(agg_params),
                                    tuple(sort_params))
    is_delta = segment.delta_parent is not None
    key = _resident_entry_key(
        segment, desc, agg_desc, sort_spec, k_res, b_pad, pack_static[1],
        _dev_struct(dev), tuple(sorted(live_views)), bundle, backend,
        shape_sig=_dev_shape_sig(dev) if is_delta else ())
    entry = _resident_entry(key, segment, repr((desc, k_res, b_pad,
                                                bool(agg_desc), backend)),
                            wire, device, n_tiles, seg_cache_key(segment))
    plan = entry.plan
    t_stage = time.perf_counter()
    wire_dev = _stage_feed(plan, wire, device)
    params_d, agg_params_d, sort_params_d = _unpack_trees(wire_dev,
                                                          pack_static)
    (top_score, top_key, top_idx, total, top_missing), agg_out, prune, \
        timed = _segment_body(
            dev, params_d, live_dev, live_views, agg_params_d,
            sort_params_d, B=b_pad, desc=desc, agg_desc=agg_desc, cap=cap,
            k=k_res, sort_spec=sort_spec, fused=bundle,
            step=_resident_step(deadline, plan["chunk_tiles"]))
    _resident.stats.staged_feed_overlap_ms.record(
        (time.perf_counter() - t_stage) * 1000.0)
    # the reference's stepped wire: timed_out rides LAST in the i32
    # section (fused plans sort by score, so the key is the f32 score)
    agg_leaves = _leaves(agg_out, [])
    buf = _wire_out(
        [top_idx, total[:, None], top_missing,
         torch.full((b_pad, 1), int(timed), dtype=torch.int32,
                    device=device)],
        [top_score, top_key, prune]
        + [leaf.reshape(b_pad, -1) for leaf in agg_leaves])
    if plan["layout"] is None:
        plan["layout"] = {
            "k": k_res, "key_is_float": True, "fused": True,
            "agg_skel": _agg_skeleton(agg_out),
            "agg_shapes": [tuple(leaf.shape[1:]) for leaf in agg_leaves]}
    handle = _start_fetch(plan, buf)
    try:
        entry.account(_plan_bytes(plan))
    except CircuitBreakingError:
        # the entry cannot afford residency: serve this result, evict it
        _resident.cache.evict(entry.key)
    return handle, {**plan["layout"], "resident": True,
                    "shard_key": shard_key}, n_real


def _collect_resident(out, layout: dict, n_real: int):
    """collect_segment_result's resident branch: the wire of
    `_execute_resident`, its timed_out column checked first."""
    wire = _collect_wire(out, layout)[:n_real]
    k = layout["k"]
    n_i = 2 * k + 1
    _raise_if_timed(wire, n_i, layout)
    ibuf = wire[:, :n_i]
    fbuf = np.ascontiguousarray(wire[:, n_i + 1:]).view(np.float32)
    top_score = fbuf[:, 0:k]
    top_key = fbuf[:, k: 2 * k]
    hard, thr, examined = fbuf[:, 2 * k: 2 * k + 3].sum(axis=0)
    _fused_stats.record_prune(hard, thr, examined)
    agg_host = _rebuild(layout["agg_skel"], iter(_agg_host_leaves(
        fbuf, 2 * k + 3, layout["agg_shapes"], n_real)))
    return (top_score, top_key, ibuf[:, 0:k], ibuf[:, k],
            ibuf[:, k + 1: 2 * k + 1].astype(bool)), agg_host


def _execute_pack_resident(base: Segment, delta: Segment, live_b, live_d,
                           desc: tuple, params_b: tuple, params_d: tuple,
                           agg_desc: tuple, agg_params_b: tuple,
                           agg_params_d: tuple, bundle: tuple,
                           backend: str, k_eff: int, b_pad: int,
                           deadline: float | None,
                           shard_key: tuple | None, n_real: int,
                           device: torch.device):
    """Serve a base+delta dispatch through a pinned resident entry. The
    key embeds BOTH generations' cache keys and the pack's shape
    signatures: a refresh's delta rebuild within its pow2 buckets lands
    on the SAME entry and feeds it the new epoch's columns (counted as
    refresh_reuses). The stepped walk's deadline check rides the base
    walk."""
    cap_b, cap_d = base.capacity, delta.capacity
    k_res = (min(next_pow2(max(k_eff, 1), floor=1), cap_b + cap_d)
             if k_eff > 0 else 0)
    n_tiles_b = base.text[bundle_primary_field(bundle)].tile_max.shape[1]
    dev_b, dev_d = device_arrays(base, device), device_arrays(delta, device)
    live_dev_b = _device_live(base, live_b, device)
    live_dev_d = _device_live(delta, live_d, device)
    views_b = _live_views_for(base, live_dev_b, agg_desc, device)
    views_d = _live_views_for(delta, live_dev_d, agg_desc, device)
    wire, pack_static = _pack_trees(params_b, params_d, tuple(agg_params_b),
                                    tuple(agg_params_d))
    key = ("pack", seg_cache_key(base), seg_cache_key(delta), cap_b, cap_d,
           desc, agg_desc, k_res, b_pad, pack_static[1], _dev_struct(dev_b),
           _dev_struct(dev_d), tuple(sorted(views_b)),
           tuple(sorted(views_d)), bundle, backend, _dev_shape_sig(dev_b),
           _dev_shape_sig(dev_d))
    entry = _resident_entry(key, base, repr((desc, k_res, b_pad,
                                             bool(agg_desc), backend,
                                             "pack")),
                            wire, device, n_tiles_b, seg_cache_key(delta),
                            delta=delta)
    plan = entry.plan
    t_stage = time.perf_counter()
    wire_dev = _stage_feed(plan, wire, device)
    p_b, p_d, a_b, a_d = _unpack_trees(wire_dev, pack_static)
    *body, timed = _pack_body(
        dev_b, dev_d, p_b, p_d, live_dev_b, live_dev_d, views_b, views_d,
        a_b, a_d, B=b_pad, desc=desc, agg_desc=agg_desc, cap_b=cap_b,
        cap_d=cap_d, k=k_res, bundle=bundle,
        step=_resident_step(deadline, plan["chunk_tiles"]))
    _resident.stats.staged_feed_overlap_ms.record(
        (time.perf_counter() - t_stage) * 1000.0)
    if plan["layout"] is None:
        plan["layout"] = _pack_output_layout(body, cap_b)
    handle = _start_fetch(plan, _pack_wire(body, timed))
    try:
        entry.account(_plan_bytes(plan))
    except CircuitBreakingError:
        # the entry cannot afford residency: serve this result, evict it
        _resident.cache.evict(entry.key)
    return handle, {**plan["layout"], "resident": True,
                    "shard_key": shard_key}, n_real
