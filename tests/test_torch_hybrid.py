"""Hybrid BM25+kNN bundles, pure kNN and rescore through the PyTorch
port vs the JAX reference, on the CPU.

(a) The bundle leaf functions with a `knn_vec` clause against the
    reference's (as its compiled programs run them), bit-exact.
(b) The plain K3 walk with a knn_vec clause against the reference's XLA
    engine `score_topk_bundle_fused` on the same similarity column
    (the reference's Pallas kernel has no knn clause): at the XLA
    engine's schedule (one batch tile, one chunk) scores, ids, totals
    and prune flags equal bit for bit, dot_product's negative scores
    included; at the kernel's own chunking the hits and totals equal.
(c) `_msearch` of the hybrid `knn` section, pure `knn` (the exact scan
    and the IVF probe), a `knn` query node with `rescore` (all five
    score modes) and `knn` inside a bool, against the reference's
    `ShardReader`: on dyadic vectors (doc components small integers,
    query norms powers of two: every dot exact) the responses are
    equal; on Gaussian vectors (D 48, where the query norm is XLA's)
    hit ids equal except at near-ties, whose scores lie within 1e-5 of
    each other (the product's f32 sums run in another order).
(d) The port's fused engine against its unfused path, and its base +
    delta pack dispatch against per-segment dispatch: equal responses.
(e) The top-level knn admission counters equal the reference's by
    reason.
"""

import copy
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index import ann as ref_ann
from elasticsearch_tpu.index.mapping import MapperService as RefMapper
from elasticsearch_tpu.index.segment import SegmentBuilder as RefBuilder
from elasticsearch_tpu.index.segment import \
    pad_delta_shapes as ref_pad_delta
from elasticsearch_tpu.ops import scoring as ref_sc
from elasticsearch_tpu.search import executor as ref_ex
from elasticsearch_tpu.search.shard_searcher import ShardReader as RefReader

from elasticsearch_tpu_torch import corpus
from elasticsearch_tpu_torch.index import ann
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import (SegmentBuilder,
                                                   build_tile_max,
                                                   pad_delta_shapes)
from elasticsearch_tpu_torch.ops import cuda_scoring as cs
from elasticsearch_tpu_torch.ops import knn
from elasticsearch_tpu_torch.ops import scoring as sc
from elasticsearch_tpu_torch.search import executor as ex
from elasticsearch_tpu_torch.search.shard_searcher import ShardReader

torch.set_num_threads(1)

CAP, TILE, N_TERMS = 4096, 256, 300
BUNDLES = {
    "should": (("should", "terms_dense", "f", False),
               ("should", "knn_vec", "e", False)),
    "must": (("must", "terms_dense", "f", True),
             ("filter", "range_int", "n", False),
             ("must", "knn_vec", "e", False)),
}


@pytest.fixture(autouse=True)
def _fused_on(monkeypatch):
    monkeypatch.delenv("ES_TPU_FUSED", raising=False)
    monkeypatch.delenv("ES_TPU_PACK_DISPATCH", raising=False)


def _case(seed, bundle, B, sim):
    """Numpy inputs of a hybrid bundle: a forward index, a range column,
    and the knn clause's (col, exists, ub) from the port's similarity
    column of dyadic vectors (the same numbers on both sides)."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, N_TERMS + 1)
    keys = rng.random((CAP, N_TERMS)) ** (1.0 / w)
    tids = np.argsort(-keys, axis=1)[:, :8].astype(np.int32)
    tids[rng.random((CAP, 8)) < 0.2] = -1
    imps = (rng.integers(1, 64, size=(CAP, 8)) / 16).astype(np.float32)
    imps[tids < 0] = 0.0
    n_vals = rng.integers(0, 5000, size=CAP).astype(np.int32)
    n_ex = rng.random(CAP) > 0.1
    v = rng.integers(-4, 5, size=(CAP, 16)).astype(np.float32)
    v_ex = rng.random(CAP) > 0.3
    q = corpus._dyadic_queries(rng, B, 16)
    if sim == "dot_product":
        # every doc against every query below -1: negative scores, and
        # tiles whose docs all have a vector bound below zero
        v = -(np.abs(v) + 1)
        q = np.abs(q)
        v_ex[:] = True
    v_ex[TILE: 3 * TILE] = False             # tiles without a vector
    v[~v_ex] = 0.0
    boost_v = (rng.integers(1, 5, size=B) / 2).astype(np.float32)
    col = (knn.knn_score_column(
        torch.from_numpy(v).to(torch.bfloat16),
        torch.from_numpy(np.linalg.norm(v, axis=1).astype(np.float32)),
        torch.from_numpy(v_ex), torch.from_numpy(q), similarity=sim)
        * torch.from_numpy(boost_v)[:, None])
    ub = sc.slack_bound(col.reshape(B, CAP // TILE, TILE).amax(dim=2))
    cl = []
    for role, kind, _f, wrapped in BUNDLES[bundle]:
        if kind == "knn_vec":
            cl.append((col.numpy(), v_ex, ub.numpy()))
        elif kind == "range_int":
            lo = rng.integers(0, 2500, size=B).astype(np.int32)
            cl.append((lo, (lo + 2500).astype(np.int32)))
        else:
            qt = rng.integers(-1, N_TERMS, size=(B, 3)).astype(np.int32)
            wq = (rng.integers(1, 8, size=(B, 3)) / 4).astype(np.float32)
            wq[qt < 0] = 0.0
            msm_c = (rng.integers(0, 3, size=B) if wrapped
                     else np.ones(B)).astype(np.int32)
            boost_c = ((rng.integers(1, 5, size=B) / 2) if wrapped
                       else np.ones(B)).astype(np.float32)
            cl.append((qt, wq, msm_c, boost_c))
    msm = np.ones(B, np.int32) if bundle == "should" \
        else np.zeros(B, np.int32)
    boost = (rng.integers(1, 5, size=B) / 2).astype(np.float32)
    live = rng.random(CAP) > 0.05
    tm = build_tile_max(tids, imps, N_TERMS, CAP, tile=TILE)
    from elasticsearch_tpu_torch.index.segment import build_tile_minmax
    lo, hi = build_tile_minmax(n_vals, n_ex, CAP, tile=TILE)
    return {"text": {"f": {"fwd_tids": tids, "fwd_imps": imps,
                           "tile_max": tm}},
            "num": {"n": {"values": n_vals, "exists": n_ex,
                          "tile_lo": lo, "tile_hi": hi}},
            "clauses": BUNDLES[bundle], "cl": tuple(cl), "msm": msm,
            "boost": boost, "live": live}


def _args(c, port):
    conv = torch.from_numpy if port else jnp.asarray

    def cols(d):
        return {f: {k: conv(np.ascontiguousarray(a)) for k, a in v.items()}
                for f, v in d.items()}
    cl = tuple(tuple(conv(np.ascontiguousarray(a)) for a in inp)
               for inp in c["cl"])
    return (cols(c["text"]), cols(c["num"]), c["clauses"], cl,
            conv(c["msm"]), conv(c["boost"]), conv(c["live"]))


def _bits(x):
    a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(p, r, what=""):
    p, r = _bits(p), _bits(r)
    assert p.shape == r.shape and np.array_equal(p, r), what


# the reference's bounds and engine as the port's other bundle tests hold
# them: called op by op (its compiled programs would contract the dense
# bound's multiply-adds into FMAs); the scores, whose every product and
# sum is exact here, are the same either way
_ref_bounds = ref_sc.bundle_tile_bounds
_ref_engine = ref_sc.score_topk_bundle_fused


@pytest.mark.parametrize("sim", ["cosine", "dot_product"])
@pytest.mark.parametrize("bundle", ["should", "must"])
def test_leaf_functions_with_knn_clause_equal_reference(bundle, sim):
    c = _case(3, bundle, 12, sim)
    p_text, p_num, clauses, p_cl, p_msm, p_boost, p_live = _args(c, True)
    r_text, r_num, _, r_cl, r_msm, r_boost, r_live = _args(c, False)
    p_can, p_ub = sc.bundle_tile_bounds(clauses, p_cl, p_text, p_num,
                                        p_msm, p_boost)
    r_can, r_ub = _ref_bounds(clauses, r_cl, r_text, r_num, r_msm, r_boost)
    _same(p_can, r_can, "can_match")
    _same(p_ub, r_ub, "ub")
    vi = len(clauses) - 1
    for j in (0, 1, 7, CAP // TILE - 1):
        sl = slice(j * TILE, (j + 1) * TILE)
        tt = {"f": (p_text["f"]["fwd_tids"][sl], p_text["f"]["fwd_imps"][sl])}
        rt = {"f": (r_text["f"]["fwd_tids"][sl], r_text["f"]["fwd_imps"][sl])}
        nt = {"n": (p_num["n"]["values"][sl], p_num["n"]["exists"][sl])}
        rn = {"n": (r_num["n"]["values"][sl], r_num["n"]["exists"][sl])}
        pv = {vi: (p_cl[vi][0][:, sl], p_cl[vi][1][sl])}
        rv = {vi: (r_cl[vi][0][:, sl], r_cl[vi][1][sl])}
        p_s, p_m = sc.bundle_tile_eval(clauses, p_cl, tt, nt, p_msm, p_boost,
                                       p_live[sl], vec_tiles=pv)
        r_s, r_m = ref_sc.bundle_tile_eval(clauses, r_cl, rt, rn, r_msm,
                                           r_boost, r_live[sl],
                                           vec_tiles=rv)
        _same(p_s, r_s, "score")
        _same(p_m, r_m, "match")
        _same(sc.bundle_tile_match(clauses, p_cl, tt, nt, p_msm, p_live[sl],
                                   vec_tiles=pv),
              ref_sc.bundle_tile_match(clauses, r_cl, rt, rn, r_msm,
                                       r_live[sl], vec_tiles=rv), "mask")
    if sim == "dot_product":
        assert bool((p_ub < 0).any())


@pytest.mark.parametrize("sim,k,emit", [("cosine", 10, False),
                                        ("dot_product", 10, True),
                                        ("dot_product", 1, False),
                                        ("cosine", 300, True),
                                        ("dot_product", 300, False)])
@pytest.mark.parametrize("bundle", ["should", "must"])
def test_plain_walk_with_knn_clause_equals_xla_engine(bundle, sim, k, emit):
    B = 12
    c = _case(20 + k, bundle, B, sim)
    p_args = _args(c, True)
    want = _ref_engine(*_args(c, False), k=k, emit_match=emit)
    text, num, clauses, cl, msm, boost, live = p_args
    can, ub = sc.bundle_tile_bounds(clauses, cl, text, num, msm, boost)
    n_tiles = CAP // TILE
    ck = min(k, TILE)
    # the XLA engine's schedule: one batch tile, one chunk
    walk = cs.bundle_walk_ref(*p_args, can, ub, ck=ck, update_thr=True,
                              emit_match=emit, bt=B, chunk_tiles=n_tiles)
    flags = walk[3][0]
    stats = np.asarray(want[3])
    assert int((flags == 2).sum()) == int(stats[0])
    assert int((flags == 1).sum()) == int(stats[1])
    assert n_tiles == int(stats[2])
    # the kernel's own chunking
    got = cs.fused_topk_bundle_ref(*p_args, k, emit_match=emit)
    _same(got[2], want[2], "total")
    total = np.asarray(want[2])
    for row in range(B):
        n = min(int(total[row]), k)
        _same(got[0][row, :n], np.asarray(want[0])[row, :n], "top_s")
        _same(got[1][row, :n], np.asarray(want[1])[row, :n], "top_i")
    if emit:
        _same(got[4], np.asarray(want[4]), "match")
    if sim == "dot_product" and k > 1:
        fin = torch.isfinite(got[0])
        assert bool((got[0][fin] < 0.0).any())     # negative scores
    assert total.sum() > 0


def _pair(docs, mapping, seg_id="s0"):
    out = []
    for mapper_cls, builder_cls in ((MapperService, SegmentBuilder),
                                    (RefMapper, RefBuilder)):
        svc = mapper_cls(mapping=mapping)
        b = builder_cls()
        for did, d in docs:
            b.add(svc.parse(did, d))
        out.append((svc, b.build(seg_id)))
    return out


D_DY, D_GA = 16, 48


@pytest.fixture(scope="module")
def dyadic_shard():
    docs = corpus.make_passages(2500, D_DY, seed=5, dyadic=True,
                                missing_every=37)
    (svc, seg), (rsvc, rseg) = _pair(docs, corpus.passage_mapping(D_DY))
    return ((svc, seg), (rsvc, rseg))


def _readers(shard):
    (svc, seg), (rsvc, rseg) = shard
    return (ShardReader("p", [seg], {}, svc, device="cpu"),
            RefReader("p", [rseg], {}, rsvc))


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k != "took"}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _equal(got, want):
    assert json.dumps(_strip(got), sort_keys=True) \
        == json.dumps(_strip(want), sort_keys=True)


def _dyadic_bodies(n=6):
    q = corpus.passage_queries(n, D_DY, dyadic=True)
    mixes = corpus.knn_mixes(q, n)
    qv = [float(x) for x in q[0]]
    extra = [
        # knn inside a bool, beside a match (hybrid through the query DSL)
        {"query": {"bool": {"must": [{"match": {"passage": "images"}}],
                            "should": [{"knn": {"field": "embedding",
                                                "query_vector": qv,
                                                "boost": 2.0}}]}},
         "size": 7},
        # knn beside another query with from / size
        {"knn": {"field": "embedding", "query_vector": qv, "k": 5,
                 "boost": 0.5},
         "query": {"match": {"passage": "french news"}}, "from": 2,
         "size": 6},
        # host fallback: knn on a field that is not a vector
        {"knn": {"field": "passage", "query_vector": qv, "k": 5},
         "size": 5},
    ]
    for mode in ("total", "multiply", "avg", "max", "min"):
        extra.append({"query": {"knn": {"field": "embedding",
                                        "query_vector": qv}},
                      "size": 8,
                      "rescore": {"window_size": 50, "query": {
                          "rescore_query": {"match": {"passage": "images"}},
                          "query_weight": 0.5, "rescore_query_weight": 2.0,
                          "score_mode": mode}}})
    return [b for m in mixes.values() for b in m] + extra


@pytest.mark.parametrize("ivf", [False, True], ids=["exact", "ivf"])
def test_msearch_dyadic_equals_reference(dyadic_shard, ivf):
    port, ref = _readers(dyadic_shard)
    bodies = _dyadic_bodies()
    tokens = None
    if ivf:
        tokens = (ann.configure(min_docs=256), ref_ann.configure(min_docs=256))
        for _svc, seg in dyadic_shard:   # a below-threshold search was sticky
            seg.__dict__.pop("_ann_skip", None)
    ex._fused_stats.reset()
    for s in (ref_ex._fused_stats,):
        s._knn.clear()
    try:
        got = port.msearch(copy.deepcopy(bodies))
        want = [ref.msearch([b])[0] for b in copy.deepcopy(bodies)]
    finally:
        if tokens:
            ann.reset(if_current=tokens[0])
            ref_ann.reset(if_current=tokens[1])
    _equal(got, want)
    assert all(r["hits"]["hits"] for r in want[:-6])
    knn_p = ex.fused_scoring_stats()["admission"]["knn"]
    assert knn_p == ref_ex.fused_scoring_stats()["admission"]["knn"]
    assert knn_p["ivf" if ivf else "exact"] == 6
    assert knn_p["host_fallback:unmapped_field"] == 1
    if ivf:
        # the port built its own index: the reference's, bit for bit
        (_s, seg), (_r, rseg) = dyadic_shard
        for name, arr in rseg.ann["embedding"].arrays().items():
            assert np.array_equal(seg.ann["embedding"].arrays()[name], arr)


def test_fused_equals_unfused_and_k3_serves_hybrids(dyadic_shard,
                                                    monkeypatch):
    port, _ref = _readers(dyadic_shard)
    bodies = _dyadic_bodies()
    ex._fused_stats.reset()
    before = cs.BUNDLE_VEC_FORMS["single"]
    fused = port.msearch(copy.deepcopy(bodies))
    adm = ex.fused_scoring_stats()["admission"]
    # the hybrid mix's groups, the knn in a bool, the rescore searches
    assert adm["admitted"] >= 3
    assert "clause:knn_vec" in adm["rejected"]        # a bare knn node
    # on the CPU the wrapper runs its plain version, no launch
    assert cs.BUNDLE_VEC_FORMS["single"] == before
    monkeypatch.setenv("ES_TPU_FUSED", "0")
    _equal(fused, port.msearch(copy.deepcopy(bodies)))


@pytest.fixture(scope="module")
def gaussian_shards():
    docs = corpus.make_passages(2500, D_GA, seed=7, n_centers=32)
    return _pair(docs, corpus.passage_mapping(D_GA))


def test_msearch_gaussian_ids_equal_but_near_ties(gaussian_shards):
    port, ref = _readers(gaussian_shards)
    _t, emb, _c = corpus.passage_columns(2500, D_GA, seed=7, n_centers=32)
    q = corpus.passage_queries(6, D_GA, near=emb)
    bodies = [b for m in corpus.knn_mixes(q, 6).values() for b in m]
    got = port.msearch(copy.deepcopy(bodies))
    want = [ref.msearch([b])[0] for b in copy.deepcopy(bodies)]
    near_ties = 0
    for g, w in zip(got, want):
        assert g["hits"]["total"] == w["hits"]["total"]
        gh, wh = g["hits"]["hits"], w["hits"]["hits"]
        assert len(gh) == len(wh) == 10
        for a, b in zip(gh, wh):
            assert abs(a["_score"] - b["_score"]) <= 1e-5
            if a["_id"] != b["_id"]:
                near_ties += 1
    assert near_ties <= 3


def test_pack_dispatch_equals_per_segment(monkeypatch):
    """A (base, delta) reader serves hybrid plans as one pack dispatch;
    per-segment dispatch gives the same responses, and both equal the
    reference's."""
    mapping = corpus.passage_mapping(D_DY)
    base_docs = corpus.make_passages(1500, D_DY, seed=11, dyadic=True)
    delta_docs = corpus.make_passages(300, D_DY, seed=12, start=1500,
                                      dyadic=True)
    (svc, base), (rsvc, rbase) = _pair(base_docs, mapping, "b")
    (_s2, delta), (_r2, rdelta) = _pair(delta_docs, mapping, "d")
    delta.delta_parent = base.cache_key()
    rdelta.delta_parent = rbase.cache_key()
    pad_delta_shapes(delta)
    ref_pad_delta(rdelta)
    port = ShardReader("p", [base, delta], {}, svc, device="cpu")
    ref = RefReader("p", [rbase, rdelta], {}, rsvc)
    q = corpus.passage_queries(4, D_DY, dyadic=True, seed=3)
    bodies = corpus.knn_mixes(q, 4)["hybrid"]
    pend = port.msearch_submit(copy.deepcopy(bodies))
    assert any(layout.get("pack") for g in pend.groups
               for _o, layout, _n in g["pending"])
    packed = pend.finish()
    monkeypatch.setenv("ES_TPU_PACK_DISPATCH", "0")
    _equal(packed, port.msearch(copy.deepcopy(bodies)))
    _equal(packed, ref.msearch(copy.deepcopy(bodies)))
