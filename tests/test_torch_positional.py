"""Positional scoring of the PyTorch port (phrase, span_near, BM25F) vs
the JAX reference, on the CPU.

(a) The positional leaf functions (`positional_tile_freqs`,
    `positional_tile_scores`, `bm25f_tile_scores`) and the positional
    arms of `bundle_tile_bounds` / `bundle_tile_eval` /
    `bundle_tile_match` against the reference's `ops/scoring`, on
    positions packs built from seeded token streams with repeated terms,
    hits at position 0 and slops 0-3.
(b) The plain K3 walk (`bundle_walk_ref`) against the Pallas kernel in
    interpret mode on positional, mixed dense + positional + range and
    BM25F bundles: at the reference's schedule (one chunk, its batch tile
    8) every output equals, prune flags included; at the kernel's
    chunking the hits and totals equal. The unfused leaf entry
    (`positional_leaf`) equals the reference's leaf over the whole
    capacity.
(c) `_msearch` through `merge_shard_results` on one and two shards, with
    the fused engine and the positional kinds on, with `ES_TPU_POSITIONAL=0`
    (the host oracle through docs_w) and with `ES_TPU_FUSED=0`; the
    admission counters, positional fallbacks by reason included.

Tolerance: exact everywhere. Frequencies are integers; every f32 score
is compared bit for bit (the leaf's impact chain has no mul-add pair an
FMA could contract). Agg `sum`/`avg` values would compare exactly too
(XLA's order, ops/ordered.py), but these requests carry terms aggs only.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.mapping import MapperService as RefMapper
from elasticsearch_tpu.index.segment import SegmentBuilder as RefBuilder
from elasticsearch_tpu.ops import scoring as ref_sc
from elasticsearch_tpu.ops.pallas_scoring import (_bundle_pallas_walk,
                                                  fused_topk_bundle_pallas)
from elasticsearch_tpu.search import executor as ref_ex
from elasticsearch_tpu.search.shard_searcher import ShardReader as RefReader

from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import (SegmentBuilder, bm25_idf,
                                                   build_tile_max)
from elasticsearch_tpu_torch.ops import cuda_scoring as cs
from elasticsearch_tpu_torch.ops import scoring as sc
from elasticsearch_tpu_torch.search import executor as ex
from elasticsearch_tpu_torch.search.shard_searcher import ShardReader

torch.set_num_threads(1)

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
         "theta", "iota", "kappa"]
_W = 1.0 / np.arange(1, len(WORDS) + 1)
MAPPING = {"properties": {"f": {"type": "text"}, "g": {"type": "text"},
                          "tag": {"type": "keyword"},
                          "n": {"type": "long"}}}
N_DOCS, TILE = 1900, 128          # capacity 2048: 16 tiles of 128


def _words(rng, lo, hi):
    k = int(rng.integers(lo, hi + 1))
    return " ".join(rng.choice(WORDS, size=k, p=_W / _W.sum()))


def _docs(n, seed, start=0):
    """Token streams with many repeats (so slots carry several
    positions and phrases repeat terms) and hits at position 0; `g`
    holds two values, concatenated with no position gap."""
    rng = np.random.default_rng(seed)
    return [(f"d{start + i}", {"f": _words(rng, 2, 9),
                               "g": [_words(rng, 1, 3), _words(rng, 1, 3)],
                               "tag": f"k{i % 3}", "n": int(i % 997)})
            for i in range(n)]


@pytest.fixture(scope="module")
def seg():
    svc = MapperService(mapping=MAPPING)
    b = SegmentBuilder()
    for did, d in _docs(N_DOCS, 5):
        b.add(svc.parse(did, d))
    s = b.build("p")
    assert s.capacity == 2048
    for f in ("f", "g"):
        assert s.text[f].fwd_pos is not None
    return s


def _cols(seg, conv, bm25=False):
    """The segment's columns, with dyadic impacts in place of its BM25
    ones unless `bm25` (the positional leaves read only the slot ids and
    the pack), so no FMA the Pallas interpreter contracts in a dense
    clause can move a score."""
    out = {}
    for f, pf in seg.text.items():
        imps = pf.fwd_imps if bm25 else np.where(
            pf.fwd_tids >= 0, (pf.fwd_tids % 7 + 1) / 8,
            0.0).astype(np.float32)
        out[f] = {"fwd_tids": conv(pf.fwd_tids), "fwd_imps": conv(imps),
                  "tile_max": conv(build_tile_max(
                      pf.fwd_tids, imps, len(pf.terms), seg.capacity,
                      tile=TILE)),
                  "fwd_pos": conv(pf.fwd_pos), "k1ln": conv(pf.k1ln),
                  "lnorm": conv(pf.lnorm)}
    nc = seg.numerics["n"]
    lo = nc.values.reshape(-1, TILE).min(axis=1)
    hi = nc.values.reshape(-1, TILE).max(axis=1)
    num = {"n": {"values": conv(nc.values), "exists": conv(nc.exists),
                 "tile_lo": conv(lo), "tile_hi": conv(hi)}}
    return out, num


KINDS = ["phrase_pos:1:e", "phrase_pos:2:e", "phrase_pos:3:e",
         "phrase_pos:2:s", "phrase_pos:3:s", "span_pos:1:u", "span_pos:2:o",
         "span_pos:3:o", "span_pos:2:u", "span_pos:3:u", "bm25f:2:3",
         "bm25f:1:2"]


def _clause_inputs(rng, kind, field, seg, B, wrapped=False, stats=False):
    """Per-row inputs of one positional clause: terms drawn with repeats
    (a phrase like "a a b"), an absent term (-1) now and then. With
    `stats` the idf values are the segment's, as the binder computes
    them, so the tile bounds hold over BM25 impacts."""
    head, a, _v = sc.parse_positional_kind(kind)
    tail = ((rng.integers(1, 9, size=B) / 4).astype(np.float32),
            (rng.integers(0, 3, size=B) if wrapped
             else np.ones(B)).astype(np.int32),
            ((rng.integers(1, 5, size=B) / 2) if wrapped
             else np.ones(B)).astype(np.float32))
    if head == "bm25f":
        nt = int(kind.split(":")[2])
        qt = np.stack([rng.integers(0, len(seg.text[f].terms), size=(B, nt))
                       for f in field], axis=1).astype(np.int32)
        qt[rng.random(qt.shape) < 0.1] = -1
        idf = (rng.integers(1, 40, size=(B, nt)) / 8).astype(np.float32)
        wf = (rng.integers(1, 9, size=(B, len(field))) / 4).astype(
            np.float32)
        return (qt, idf, wf) + tail
    n_t = len(seg.text[field].terms)
    qt = rng.integers(0, min(n_t, 5), size=(B, a)).astype(np.int32)
    if a > 1:
        qt[::3, 1] = qt[::3, 0]                      # a repeated term
    qt[rng.random(qt.shape) < 0.05] = -1
    wb = (rng.integers(1, 9, size=(B, a)) / 4).astype(np.float32)
    idf_sum = (rng.integers(1, 40, size=B) / 8).astype(np.float32)
    if stats:
        pf = seg.text[field]
        idf = np.where(qt >= 0, bm25_idf(pf.df[np.maximum(qt, 0)],
                                         pf.doc_count), 1.0)
        idf_sum = idf.sum(axis=1).astype(np.float32)
        wb = (idf.sum(axis=1, keepdims=True) / idf).astype(np.float32)
    slop = rng.integers(0, 4, size=B).astype(np.int32)
    return (qt, wb, idf_sum, slop) + tail


def _field_of(kind):
    return ("f", "g") if kind == "bm25f:2:3" else \
        ("g",) if kind == "bm25f:1:2" else "f"


def _bits(x) -> np.ndarray:
    a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(port, ref, what=""):
    p, r = _bits(port), _bits(ref)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    assert np.array_equal(p, r), (what, np.argwhere(p != r)[:5])


# ---------------------------------------------------------------------------
# (a) leaf functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_leaf_matches_reference(seg, kind):
    rng = np.random.default_rng(len(kind) * 7 + int(kind[-3].isdigit()))
    B = 9
    field = _field_of(kind)
    inp = _clause_inputs(rng, kind, field, seg, B)
    p_text, _ = _cols(seg, torch.from_numpy)
    r_text, _ = _cols(seg, jnp.asarray)
    sl = slice(TILE, 5 * TILE)         # several tiles side by side
    for docs in (sl, slice(None)):
        pt = {f: (v["fwd_tids"][docs], v["fwd_imps"][docs])
              for f, v in p_text.items()}
        rt = {f: (v["fwd_tids"][docs], v["fwd_imps"][docs])
              for f, v in r_text.items()}
        pp = {f: (v["fwd_pos"][docs], v["k1ln"][docs], v["lnorm"][docs])
              for f, v in p_text.items()}
        rp = {f: (v["fwd_pos"][docs], v["k1ln"][docs], v["lnorm"][docs])
              for f, v in r_text.items()}
        p_inp = tuple(torch.from_numpy(a) for a in inp)
        r_inp = tuple(jnp.asarray(a) for a in inp)
        p_s, p_m = sc.positional_tile_scores(kind, field, p_inp, pt, pp)
        r_s, r_m = ref_sc.positional_tile_scores(kind, field, r_inp, rt, rp)
        _same(p_s, r_s, "s_leaf")
        _same(p_m, r_m, "m_leaf")
        if not kind.startswith("bm25f"):
            _same(sc.positional_tile_freqs(kind, p_inp[0], p_inp[3],
                                           pt[field][0], pp[field][0]),
                  ref_sc.positional_tile_freqs(kind, r_inp[0], r_inp[3],
                                               rt[field][0], rp[field][0]),
                  "freq")
    assert int(p_m.sum()) > 0


def test_leaf_counts_repeats_and_position_zero():
    """Hand-checked frequencies on one doc "a a b a b" (a at 0, 1, 3; b
    at 2, 4), both packages."""
    svc = MapperService(mapping=MAPPING)
    b = SegmentBuilder()
    b.add(svc.parse("x", {"f": "a a b a b"}))
    s = b.build("x")
    pf = s.text["f"]
    a_id, b_id = pf.lookup("a"), pf.lookup("b")
    cases = {("phrase_pos:2:e", (a_id, b_id), 0): 2,     # a b at 1-2, 3-4
             ("phrase_pos:2:e", (a_id, a_id), 0): 1,     # a a at 0-1
             ("phrase_pos:3:e", (a_id, a_id, b_id), 0): 1,
             ("phrase_pos:2:s", (b_id, a_id), 2): 3,
             ("span_pos:2:o", (a_id, b_id), 0): 2,
             ("span_pos:2:o", (a_id, b_id), 3): 5,
             ("span_pos:2:u", (b_id, a_id), 0): 3,
             ("span_pos:1:u", (a_id,), 0): 3}
    for (kind, terms, slop), want in cases.items():
        for mod, conv in ((sc, torch.from_numpy), (ref_sc, jnp.asarray)):
            got = mod.positional_tile_freqs(
                kind, conv(np.asarray([terms], np.int32)),
                conv(np.asarray([slop], np.int32)), conv(pf.fwd_tids),
                conv(pf.fwd_pos))
            assert int(np.asarray(got)[0, 0]) == want, (kind, terms, slop)


_BUNDLES = {
    "phrase": (("should", "phrase_pos:3:s", "f", False),),
    "span": (("should", "span_pos:2:o", "f", False),),
    "bm25f": (("should", "bm25f:2:3", ("f", "g"), False),),
    # dense must + range filter + positional must_not / wrapped should
    "mixed": (("must", "terms_dense", "g", True),
              ("filter", "range_int", "n", False),
              ("must_not", "span_pos:2:u", "g", False),
              ("should", "phrase_pos:2:e", "f", True),
              ("should", "bm25f:1:2", ("g",), False)),
}


def _bundle_case(seg, bundle, B, seed, stats=False):
    rng = np.random.default_rng(seed)
    cl = []
    for role, kind, field, wrapped in _BUNDLES[bundle]:
        if kind == "range_int":
            lo = rng.integers(0, 500, size=B).astype(np.int32)
            cl.append((lo, (lo + 400).astype(np.int32)))
        elif kind == "terms_dense":
            qt = rng.integers(-1, len(seg.text[field].terms),
                              size=(B, 2)).astype(np.int32)
            wq = (rng.integers(1, 8, size=(B, 2)) / 4).astype(np.float32)
            wq[qt < 0] = 0.0
            cl.append((qt, wq, rng.integers(0, 3, size=B).astype(np.int32),
                       (rng.integers(1, 5, size=B) / 2).astype(np.float32)))
        else:
            cl.append(_clause_inputs(rng, kind, field, seg, B, wrapped,
                                     stats))
    n_should = sum(r == "should" for r, *_ in _BUNDLES[bundle])
    msm = rng.integers(0, n_should + 1, size=B).astype(np.int32)
    if len(_BUNDLES[bundle]) == 1:
        msm[:] = 1
    boost = (rng.integers(1, 5, size=B) / 2).astype(np.float32)
    live = rng.random(seg.capacity) > 0.05
    return cl, msm, boost, live


def _args(seg, case, bundle, port, bm25=False):
    conv = torch.from_numpy if port else jnp.asarray
    text, num = _cols(seg, conv, bm25)
    cl, msm, boost, live = case
    return (text, num, _BUNDLES[bundle],
            tuple(tuple(conv(np.ascontiguousarray(a)) for a in inp)
                  for inp in cl), conv(msm), conv(boost), conv(live))


@pytest.mark.parametrize("bundle", sorted(_BUNDLES))
def test_bounds_eval_and_match_match_reference(seg, bundle):
    case = _bundle_case(seg, bundle, 11, seed=3)
    p_text, p_num, clauses, p_cl, p_msm, p_boost, p_live = \
        _args(seg, case, bundle, True)
    r_text, r_num, _, r_cl, r_msm, r_boost, r_live = \
        _args(seg, case, bundle, False)
    p_can, p_ub = sc.bundle_tile_bounds(clauses, p_cl, p_text, p_num,
                                        p_msm, p_boost)
    r_can, r_ub = ref_sc.bundle_tile_bounds(clauses, r_cl, r_text, r_num,
                                            r_msm, r_boost)
    _same(p_can, r_can, "can_match")
    _same(p_ub, r_ub, "ub")
    sl = slice(3 * TILE, 4 * TILE)

    def tiles(text, num):
        return ({f: (v["fwd_tids"][sl], v["fwd_imps"][sl])
                 for f, v in text.items()},
                {f: (v["values"][sl], v["exists"][sl])
                 for f, v in num.items()},
                {f: (v["fwd_pos"][sl], v["k1ln"][sl], v["lnorm"][sl])
                 for f, v in text.items()})

    pt, pn, pp = tiles(p_text, p_num)
    rt, rn, rp = tiles(r_text, r_num)
    p_s, p_m = sc.bundle_tile_eval(clauses, p_cl, pt, pn, p_msm, p_boost,
                                   p_live[sl], pos_tiles=pp)
    r_s, r_m = ref_sc.bundle_tile_eval(clauses, r_cl, rt, rn, r_msm,
                                       r_boost, r_live[sl], pos_tiles=rp)
    _same(p_s, r_s, "score")
    _same(p_m, r_m, "match")
    p_mo = sc.bundle_tile_match(clauses, p_cl, pt, pn, p_msm, p_live[sl],
                                pos_tiles=pp)
    _same(p_mo, ref_sc.bundle_tile_match(clauses, r_cl, rt, rn, r_msm,
                                         r_live[sl], pos_tiles=rp),
          "match-only")
    _same(p_mo, r_m, "match-only vs eval")
    assert int(p_m.sum()) > 0


# ---------------------------------------------------------------------------
# (b) the plain walk vs the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------


_WALKS = [("phrase", 10, False), ("span", 1, True), ("bm25f", 10, True),
          ("mixed", 10, True), ("mixed", 0, False)]


@pytest.mark.parametrize("bundle,k,emit", _WALKS)
def test_walk_at_reference_schedule_equals_pallas(seg, bundle, k, emit):
    B = 11
    case = _bundle_case(seg, bundle, B, seed=20 + k)
    p_args = _args(seg, case, bundle, True)
    r_args = _args(seg, case, bundle, False)
    ck = min(k, TILE)
    got = _bundle_pallas_walk(*r_args, ck=ck, update_thr=True,
                              emit_match=emit, step=None, interpret=True)
    r_cs, r_ci, r_cnt, r_flags, r_match, _t, b, btile, _bp = got
    assert btile == 8                  # the reference's positional tile
    text, num, clauses, cl, msm, boost, live = p_args
    can, ub = sc.bundle_tile_bounds(clauses, cl, text, num, msm, boost)
    out = cs.bundle_walk_ref(*p_args, can, ub, ck=ck, update_thr=True,
                             emit_match=emit, bt=btile,
                             chunk_tiles=seg.capacity // TILE)
    p_cs, p_ci, p_cnt, p_flags, p_match, _thr = out
    if ck:
        _same(p_cs, np.asarray(r_cs)[:b], "cs")
        _same(p_ci, np.asarray(r_ci)[:b], "ci")
    _same(p_cnt, np.asarray(r_cnt)[:b], "cnt")
    _same(p_flags, np.asarray(r_flags)[:b], "flags")
    if emit:
        _same(p_match, np.asarray(r_match)[:b] != 0, "match")
    assert int(p_cnt.sum()) > 0
    assert int((p_flags == 2).sum()) > 0 or bundle == "bm25f"


@pytest.mark.parametrize("bundle", ["phrase", "span", "bm25f"])
def test_fused_topk_at_kernel_chunking_equals_pallas(seg, bundle):
    """The kernel's batch tile and chunks against the reference's one
    walk, on BM25 impacts and the segment's idf (the statistics the tile
    bounds rest on): the hits, totals and masks equal."""
    B = 16
    case = _bundle_case(seg, bundle, B, seed=41, stats=True)
    got = cs.fused_topk_bundle_ref(*_args(seg, case, bundle, True, True),
                                   10, emit_match=True)
    want = fused_topk_bundle_pallas(*_args(seg, case, bundle, False, True),
                                    10, emit_match=True, interpret=True)
    _same(got[2], want[2], "total")
    _same(got[4], np.asarray(want[4]), "match")
    total = np.asarray(want[2])
    for row in range(B):
        n = min(int(total[row]), 10)
        _same(got[0][row, :n], np.asarray(want[0])[row, :n], "top_s")
        _same(got[1][row, :n], np.asarray(want[1])[row, :n], "top_i")


@pytest.mark.parametrize("kind", ["phrase_pos:3:s", "span_pos:3:o",
                                  "bm25f:2:3"])
def test_unfused_leaf_entry_matches_reference(seg, kind):
    """positional_leaf (its plain version here) over the whole capacity
    equals the reference's leaf applied to the whole capacity."""
    rng = np.random.default_rng(9)
    field = _field_of(kind)
    inp = _clause_inputs(rng, kind, field, seg, 6)
    p_text, _ = _cols(seg, torch.from_numpy)
    r_text, _ = _cols(seg, jnp.asarray)
    before = dict(cs.LAUNCHES)
    s, m = cs.positional_leaf(kind, field,
                              tuple(torch.from_numpy(a) for a in inp),
                              p_text)
    assert cs.LAUNCHES == before            # the CPU takes the plain version
    fields = sc.clause_fields(field)
    r_s, r_m = ref_sc.positional_tile_scores(
        kind, field, tuple(jnp.asarray(a) for a in inp),
        {f: (r_text[f]["fwd_tids"], r_text[f]["fwd_imps"]) for f in fields},
        {f: (r_text[f]["fwd_pos"], r_text[f]["k1ln"], r_text[f]["lnorm"])
         for f in fields})
    _same(s, r_s, "s_leaf")
    _same(m, r_m, "m_leaf")


# ---------------------------------------------------------------------------
# (c) the whole path
# ---------------------------------------------------------------------------


def _reader_pair(docs, shard_id=0):
    out = []
    for mapper_cls, builder_cls, reader_cls, kw in (
            (MapperService, SegmentBuilder, ShardReader, {"device": "cpu"}),
            (RefMapper, RefBuilder, RefReader, {})):
        svc = mapper_cls(mapping=MAPPING)
        b = builder_cls()
        for did, d in docs:
            b.add(svc.parse(did, d))
        seg = b.build(f"s{shard_id}")
        out.append(reader_cls("idx", [seg], {}, svc, shard_id=shard_id, **kw))
    return out


def _long_docs(n, seed, start=0):
    """As _docs, plus a field `h` where one doc repeats a word 70 times:
    past POS_CAP, so `h` gets no positions pack."""
    docs = _docs(n, seed, start)
    for i, (_did, d) in enumerate(docs):
        d["h"] = ("alpha " * 70 if i == 3 else d["f"])
    return docs


@pytest.fixture(scope="module")
def one_shard():
    return _reader_pair(_long_docs(1300, 7))


@pytest.fixture(scope="module")
def two_shards():
    return [_reader_pair(_long_docs(700, 8 + s, start=700 * s), shard_id=s)
            for s in range(2)]


def _sn(clauses, slop, in_order):
    return {"span_near": {"clauses": [{"span_term": {"f": w}}
                                      for w in clauses],
                          "slop": slop, "in_order": in_order}}


QUERIES = [
    {"query": {"match_phrase": {"f": "alpha beta"}}, "size": 10},
    {"query": {"match_phrase": {"f": "alpha alpha beta"}}, "size": 10},
    {"query": {"match_phrase": {"f": {"query": "alpha gamma",
                                      "slop": 2}}}, "size": 10},
    {"query": {"match_phrase": {"f": {"query": "beta beta alpha",
                                      "slop": 3}}}, "size": 10},
    {"query": {"match": {"f": {"query": "gamma alpha", "type": "phrase",
                               "slop": 1}}}, "size": 10},
    {"query": {"match_phrase_prefix": {"f": "alpha be"}}, "size": 10},
    {"query": {"match_phrase": {"h": "alpha beta"}}, "size": 10},
    {"query": {"span_term": {"f": "delta"}}, "size": 5},
    {"query": _sn(["alpha", "delta"], 3, True), "size": 8},
    {"query": _sn(["delta", "alpha", "beta"], 1, False), "size": 8},
    {"query": _sn(["alpha", "beta", "alpha"], 2, True), "size": 8},
    {"query": {"span_or": {"clauses": [{"span_term": {"f": "zeta"}},
                                       {"span_term": {"f": "eta"}}]}},
     "size": 5},
    {"query": {"span_first": {"match": {"span_term": {"f": "beta"}},
                              "end": 2}}, "size": 5},
    {"query": {"span_not": {"include": {"span_term": {"f": "beta"}},
                            "exclude": {"span_term": {"f": "alpha"}},
                            "pre": 1}}, "size": 5},
    {"query": {"multi_match": {"query": "alpha epsilon",
                               "type": "cross_fields",
                               "fields": ["f^2", "g"]}}, "size": 10},
    {"query": {"multi_match": {"query": "beta gamma theta",
                               "type": "cross_fields",
                               "fields": ["f"]}}, "size": 10},
    {"query": {"bool": {"must": [{"match": {"g": "gamma"}}],
                        "should": [{"match_phrase": {"f": "alpha beta"}}],
                        "filter": [{"range": {"n": {"gte": 3,
                                                    "lte": 900}}}]}},
     "size": 12},
    {"query": {"bool": {"should": [
        {"bool": {"should": [{"match_phrase": {"f": "beta gamma"}}],
                  "boost": 2.5}},
        {"match": {"g": "zeta"}}]}}, "size": 7},
    {"query": {"match_phrase": {"f": "alpha beta"}}, "size": 5,
     "aggs": {"t": {"terms": {"field": "tag"}}}},
    {"query": {"match_phrase": {"f": {"query": "gamma beta", "slop": 2}}},
     "size": 0, "aggs": {"t": {"terms": {"field": "tag"}}}},
    {"query": {"bool": {"must": [{"match_phrase": {"f": "alpha beta"}}],
                        "filter": [{"terms": {"tag": ["k1", "k2"]}}]}},
     "size": 10},
]

ENVS = [{}, {"ES_TPU_POSITIONAL": "0"}, {"ES_TPU_FUSED": "0"}]


def _strip(resps):
    out = copy.deepcopy(resps)
    for r in out:
        r.pop("took", None)
    return out


def _admission(mod):
    adm = mod.fused_scoring_stats()["admission"]
    return {k: adm[k] for k in ("admitted", "rejected",
                                "positional_fallbacks",
                                "positional_admitted")}


@pytest.mark.parametrize("env", ENVS, ids=["fused", "host", "unfused"])
def test_msearch_matches_reference(one_shard, monkeypatch, env):
    for k in ("ES_TPU_POSITIONAL", "ES_TPU_FUSED"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port, ref = one_shard
    ex._fused_stats.reset()
    ref_ex._fused_stats.reset()
    got = port.msearch(QUERIES)
    want = ref.msearch(QUERIES)
    assert _strip(got) == _strip(want)
    assert sum(r["hits"]["total"] > 0 for r in want) >= len(QUERIES) - 2
    p_adm = _admission(ex)
    assert p_adm == _admission(ref_ex)
    if not env:
        assert p_adm["positional_admitted"] > 0
        assert p_adm["positional_fallbacks"] == {
            "phrase_prefix": 1, "missing_positions_pack": 1,
            "span_SpanOrQuery": 1, "span_SpanFirstQuery": 1,
            "span_SpanNotQuery": 1}
    else:
        assert p_adm["positional_admitted"] == 0


@pytest.mark.parametrize("env", ENVS, ids=["fused", "host", "unfused"])
def test_two_shard_reduce_matches_reference(two_shards, monkeypatch, env):
    from elasticsearch_tpu.search.aggregations import \
        parse_aggs as ref_parse_aggs
    from elasticsearch_tpu.search.controller import \
        merge_shard_results as ref_merge
    from elasticsearch_tpu_torch.search.aggregations import parse_aggs
    from elasticsearch_tpu_torch.search.controller import \
        merge_shard_results
    for k in ("ES_TPU_POSITIONAL", "ES_TPU_FUSED"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    bodies = QUERIES[::2] + QUERIES[-2:]
    merged = {}
    for side, (idx, parse, merge) in {
            "port": (0, parse_aggs, merge_shard_results),
            "ref": (1, ref_parse_aggs, ref_merge)}.items():
        per_shard = [pair[idx].msearch(bodies, with_partials=True)
                     for pair in two_shards]
        merged[side] = [merge(
            [shard[i] for shard in per_shard],
            agg_specs=parse(body.get("aggs")),
            shard_partials=[shard[i].get("_agg_partials", {})
                            for shard in per_shard],
            frm=body.get("from", 0), size=body.get("size", 10))
            for i, body in enumerate(bodies)]
    assert _strip(merged["port"]) == _strip(merged["ref"])
    assert any(r["hits"]["total"] > 0 for r in merged["ref"])
