"""The fused block-max bundle engine of the PyTorch port vs the JAX
reference, on the CPU.

(a) The per-tile leaf functions (`bundle_tile_bounds`,
    `bundle_tile_eval`, `bundle_tile_match`) against the reference's,
    bit-exact, on the same numpy inputs.
(b) The plain walk of K3 (`bundle_walk_ref`, `fused_topk_bundle_ref`,
    `match_mask_bundle_ref`) against the Pallas kernel run in interpret
    mode: at the reference's schedule (one chunk, its batch tile) every
    output equals, prune flags included; at the kernel's chunking the
    hits, totals and masks equal.
(c) `_msearch` with the fused engine on (`ES_TPU_FUSED` unset) in both
    packages: the seven request mixes on one shard and a 2-shard reduce.

Tolerance: exact everywhere, and bit-exact for scores. Impacts, weights
and boosts are small dyadic rationals, so every f32 product and sum is
exact and no FMA contraction (which the Pallas interpreter may apply)
can move a score or a tie. The whole-path check (c) compares floats
exactly too, agg `sum`/`avg` values included (the port adds f32 agg
sums in XLA's order, ops/ordered.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.segment import build_tile_max as ref_tile_max
from elasticsearch_tpu.index.segment import \
    build_tile_minmax as ref_tile_minmax
from elasticsearch_tpu.ops import scoring as ref_sc
from elasticsearch_tpu.ops.pallas_scoring import (
    _BATCH_TILE, _bundle_pallas_walk, fused_topk_bundle_pallas,
    match_mask_bundle_pallas)
from elasticsearch_tpu.search import executor as ref_ex

from elasticsearch_tpu_torch import corpus
from elasticsearch_tpu_torch.index.segment import (build_tile_max,
                                                   build_tile_minmax)
from elasticsearch_tpu_torch.ops import cuda_scoring as cs
from elasticsearch_tpu_torch.ops import scoring as sc
from elasticsearch_tpu_torch.search import executor as ex

torch.set_num_threads(1)

CAP = 4096
N_TERMS = 300
# Zipf-like term frequencies: head terms sit in every tile, tail terms in
# few, so tiles without a query's terms get pruned
_TERM_W = 1.0 / np.arange(1, N_TERMS + 1)
BUNDLES = {
    "single": (("should", "terms_dense", "f", False),),
    # must-match + range filter: the main path's match_range_aggs shape
    "main": (("must", "terms_dense", "f", True),
             ("filter", "range_int", "n", False)),
    # two text fields, every role, both range kinds, wrapped clauses
    "bundle": (("must", "terms_dense", "f", True),
               ("filter", "range_int", "n", False),
               ("filter", "range_f32", "x", False),
               ("must_not", "terms_dense", "g", False),
               ("must_not", "range_int", "n", False),
               ("should", "term_text", "g", False),
               ("should", "terms_dense", "f", True)),
}


@pytest.fixture(autouse=True)
def _fused_on(monkeypatch):
    # the fused engine is on unless ES_TPU_FUSED turns it off
    monkeypatch.delenv("ES_TPU_FUSED", raising=False)


def _field(rng, L):
    # distinct term ids per doc (the forward-index invariant), drawn by
    # weight without replacement (largest u ** (1 / w) keys), 20% padding
    keys = rng.random((CAP, N_TERMS)) ** (1.0 / _TERM_W)
    tids = np.argsort(-keys, axis=1)[:, :L].astype(np.int32)
    tids[rng.random((CAP, L)) < 0.2] = -1
    imps = (rng.integers(1, 64, size=(CAP, L)) / 16).astype(np.float32)
    imps[tids < 0] = 0.0
    return tids, imps


def _case(seed, bundle, B, tile):
    """Numpy inputs of one bundle: columns, per-clause inputs, msm,
    boost, live, tile summaries (each package's own builders)."""
    rng = np.random.default_rng(seed)
    text = {"f": _field(rng, 8), "g": _field(rng, 6)}
    n_vals = rng.integers(0, 5000, size=CAP).astype(np.int32)
    n_ex = rng.random(CAP) > 0.1
    x_vals = (rng.integers(-400, 400, size=CAP) / 8).astype(np.float32)
    x_ex = rng.random(CAP) > 0.1
    num = {"n": (n_vals, n_ex), "x": (x_vals, x_ex)}
    cl_inputs = []
    for role, kind, field, wrapped in BUNDLES[bundle]:
        if kind == "range_int":
            lo = rng.integers(0, 2500, size=B).astype(np.int32)
            if role == "must_not":
                lo = lo + 2000
            cl_inputs.append((lo, (lo + rng.integers(800, 2500, size=B))
                              .astype(np.int32)))
        elif kind == "range_f32":
            lo = (rng.integers(-400, 100, size=B) / 8).astype(np.float32)
            cl_inputs.append((lo, (lo + 40).astype(np.float32)))
        else:
            q = 1 if kind == "term_text" else 3
            qt = rng.integers(-1, N_TERMS, size=(B, q)).astype(np.int32)
            wq = (rng.integers(1, 8, size=(B, q)) / 4).astype(np.float32)
            wq[qt < 0] = 0.0
            msm_c = (rng.integers(0, 3, size=B) if wrapped
                     else np.ones(B)).astype(np.int32)
            boost_c = ((rng.integers(1, 5, size=B) / 2) if wrapped
                       else np.ones(B)).astype(np.float32)
            cl_inputs.append((qt, wq, msm_c, boost_c))
    n_should = sum(r == "should" for r, *_ in BUNDLES[bundle])
    msm = rng.integers(0, n_should + 1, size=B).astype(np.int32)
    if bundle == "single":
        msm[:] = 1
    boost = (rng.integers(1, 5, size=B) / 2).astype(np.float32)
    live = rng.random(CAP) > 0.05
    return {"text": text, "num": num, "cl": tuple(cl_inputs), "msm": msm,
            "boost": boost, "live": live, "tile": tile,
            "clauses": BUNDLES[bundle]}


def _port_cols(c):
    text = {f: {"fwd_tids": torch.from_numpy(t),
                "fwd_imps": torch.from_numpy(i),
                "tile_max": torch.from_numpy(
                    build_tile_max(t, i, N_TERMS, CAP, tile=c["tile"]))}
            for f, (t, i) in c["text"].items()}
    num = {}
    for f, (v, e) in c["num"].items():
        lo, hi = build_tile_minmax(v, e, CAP, tile=c["tile"])
        num[f] = {"values": torch.from_numpy(v), "exists": torch.from_numpy(e),
                  "tile_lo": torch.from_numpy(lo),
                  "tile_hi": torch.from_numpy(hi)}
    return text, num


def _ref_cols(c):
    text = {f: {"fwd_tids": jnp.asarray(t), "fwd_imps": jnp.asarray(i),
                "tile_max": jnp.asarray(
                    ref_tile_max(t, i, N_TERMS, CAP, tile=c["tile"]))}
            for f, (t, i) in c["text"].items()}
    num = {}
    for f, (v, e) in c["num"].items():
        lo, hi = ref_tile_minmax(v, e, CAP, tile=c["tile"])
        num[f] = {"values": jnp.asarray(v), "exists": jnp.asarray(e),
                  "tile_lo": jnp.asarray(lo), "tile_hi": jnp.asarray(hi)}
    return text, num


def _args(c, port: bool):
    conv = torch.from_numpy if port else jnp.asarray
    text, num = _port_cols(c) if port else _ref_cols(c)
    cl = tuple(tuple(conv(a) for a in inp) for inp in c["cl"])
    return (text, num, c["clauses"], cl, conv(c["msm"]), conv(c["boost"]),
            conv(c["live"]))


def _bits(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(port, ref, what=""):
    p = _bits(port.numpy() if isinstance(port, torch.Tensor) else port)
    r = _bits(ref)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    assert np.array_equal(p, r), (what, np.argwhere(p != r)[:5])


# ---------------------------------------------------------------------------
# (a) leaf functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bundle,tile", [("single", 1024), ("main", 256),
                                         ("bundle", 256), ("bundle", 1024)])
def test_tile_summaries_and_bounds_match_reference(bundle, tile):
    c = _case(11, bundle, 12, tile)
    p_text, p_num, clauses, p_cl, p_msm, p_boost, _ = _args(c, True)
    r_text, r_num, _, r_cl, r_msm, r_boost, _ = _args(c, False)
    for f in p_text:
        _same(p_text[f]["tile_max"], r_text[f]["tile_max"], f)
    for f in p_num:
        _same(p_num[f]["tile_lo"], r_num[f]["tile_lo"], f)
        _same(p_num[f]["tile_hi"], r_num[f]["tile_hi"], f)
    p_can, p_ub = sc.bundle_tile_bounds(clauses, p_cl, p_text, p_num,
                                        p_msm, p_boost)
    r_can, r_ub = ref_sc.bundle_tile_bounds(clauses, r_cl, r_text, r_num,
                                            r_msm, r_boost)
    _same(p_can, r_can, "can_match")
    _same(p_ub, r_ub, "ub")
    assert int(p_can.sum()) > 0
    if tile == 256:
        assert int(p_can.sum()) < p_can.numel()


@pytest.mark.parametrize("bundle", ["single", "main", "bundle"])
def test_tile_eval_and_match_match_reference(bundle):
    tile = 256
    c = _case(12, bundle, 16, tile)
    p_text, p_num, clauses, p_cl, p_msm, p_boost, p_live = _args(c, True)
    r_text, r_num, _, r_cl, r_msm, r_boost, r_live = _args(c, False)
    any_match = 0
    for j in (0, 5, CAP // tile - 1):
        sl = slice(j * tile, (j + 1) * tile)
        p_tt = {f: (v["fwd_tids"][sl], v["fwd_imps"][sl])
                for f, v in p_text.items()}
        r_tt = {f: (v["fwd_tids"][sl], v["fwd_imps"][sl])
                for f, v in r_text.items()}
        p_nt = {f: (v["values"][sl], v["exists"][sl])
                for f, v in p_num.items()}
        r_nt = {f: (v["values"][sl], v["exists"][sl])
                for f, v in r_num.items()}
        p_s, p_m = sc.bundle_tile_eval(clauses, p_cl, p_tt, p_nt, p_msm,
                                       p_boost, p_live[sl])
        r_s, r_m = ref_sc.bundle_tile_eval(clauses, r_cl, r_tt, r_nt, r_msm,
                                           r_boost, r_live[sl])
        _same(p_s, r_s, "score")
        _same(p_m, r_m, "match")
        _same(sc.bundle_tile_match(clauses, p_cl, p_tt, p_nt, p_msm,
                                   p_live[sl]),
              ref_sc.bundle_tile_match(clauses, r_cl, r_tt, r_nt, r_msm,
                                       r_live[sl]), "match-only")
        _same(sc.bundle_tile_match(clauses, p_cl, p_tt, p_nt, p_msm,
                                   p_live[sl]), r_m, "match-only vs eval")
        any_match += int(p_m.sum())
        # deleted docs never match
        assert not bool(p_m[:, ~p_live[sl]].any())
    assert any_match > 0


# ---------------------------------------------------------------------------
# (b) the plain walk vs the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------


_WALKS = [("single", 1024, 10, False), ("main", 1024, 10, True),
          ("bundle", 256, 1, True), ("bundle", 256, 10, False),
          ("bundle", 256, 300, False), ("single", 256, 1, False)]


@pytest.mark.parametrize("bundle,tile,k,emit", _WALKS)
def test_walk_at_reference_schedule_equals_pallas(bundle, tile, k, emit):
    """One chunk over all tiles and the reference's batch tile: every
    output of the walk equals the Pallas kernel's, prune flags and
    thresholded tiles included."""
    B = 12
    c = _case(20 + k, bundle, B, tile)
    p_args = _args(c, True)
    r_args = _args(c, False)
    k_sel = min(k, CAP)
    ck = min(k_sel, tile)
    got_r = _bundle_pallas_walk(*r_args, ck=ck, update_thr=(ck == k_sel),
                                emit_match=emit, step=None, interpret=True)
    r_cs, r_ci, r_cnt, r_flags, r_match, _t, b, btile, _bp = got_r
    assert btile == min(_BATCH_TILE, B)
    text, num, clauses, cl, msm, boost, live = p_args
    can, ub = sc.bundle_tile_bounds(clauses, cl, text, num, msm, boost)
    out = cs.bundle_walk_ref(*p_args, can, ub, ck=ck,
                             update_thr=(ck == k_sel), emit_match=emit,
                             bt=btile, chunk_tiles=CAP // tile)
    p_cs, p_ci, p_cnt, p_flags, p_match, _thr = out
    _same(p_cs, np.asarray(r_cs)[:b], "cs")
    _same(p_ci, np.asarray(r_ci)[:b], "ci")
    _same(p_cnt, np.asarray(r_cnt)[:b], "cnt")
    _same(p_flags, np.asarray(r_flags)[:b], "flags")
    if emit:
        _same(p_match, np.asarray(r_match)[:b] != 0, "match")
    else:
        assert p_match is None
    assert int(p_cnt.sum()) > 0


@pytest.mark.parametrize("bundle,tile,k,emit", _WALKS)
def test_fused_topk_at_kernel_chunking_equals_pallas(bundle, tile, k, emit):
    """The kernel's own batch tile and chunks: hits, totals and masks
    equal the Pallas kernel's; only the prune flags may differ."""
    B = 16
    c = _case(40 + k, bundle, B, tile)
    got = cs.fused_topk_bundle_ref(*_args(c, True), k, emit_match=emit)
    want = fused_topk_bundle_pallas(*_args(c, False), k, emit_match=emit,
                                    interpret=True)
    _same(got[2], want[2], "total")
    total = np.asarray(want[2])
    top_s, top_i = np.asarray(want[0]), np.asarray(want[1])
    assert got[0].shape == top_s.shape
    for row in range(B):
        n = min(int(total[row]), top_s.shape[1])
        _same(got[0][row, :n], top_s[row, :n], f"top_s[{row}]")
        _same(got[1][row, :n], top_i[row, :n], f"top_i[{row}]")
        assert torch.isneginf(got[0][row, n:]).all()
    assert float(got[3][2]) == CAP // tile     # examined == n_tiles
    if emit:
        _same(got[4], np.asarray(want[4]), "match")
    assert total.sum() > 0


@pytest.mark.parametrize("bundle,tile,emit", [("bundle", 256, True),
                                              ("bundle", 1024, False),
                                              ("main", 256, True)])
def test_mask_only_grid_equals_pallas(bundle, tile, emit):
    c = _case(60, bundle, 10, tile)
    got = cs.match_mask_bundle_ref(*_args(c, True), emit_match=emit)
    want = match_mask_bundle_pallas(*_args(c, False), emit_match=emit,
                                    interpret=True)
    _same(got[0], want[0], "total")
    if emit:
        _same(got[2], np.asarray(want[2]), "match")
    # at one chunk the prune flags equal too
    p_args = _args(c, True)
    text, num, clauses, cl, msm, boost, live = p_args
    can, ub = sc.bundle_tile_bounds(clauses, cl, text, num, msm, boost)
    _cs, _ci, cnt, flags, _m, _thr = cs.bundle_walk_ref(
        *p_args, can, ub, ck=0, update_thr=False, emit_match=False,
        bt=10, chunk_tiles=CAP // tile)
    r = _bundle_pallas_walk(*_args(c, False), ck=0, update_thr=False,
                            emit_match=False, step=None, interpret=True)
    _same(cnt, np.asarray(r[2])[:10], "cnt")
    _same(flags, np.asarray(r[3])[:10], "flags")


def test_fused_topk_dense_single_clause():
    c = _case(70, "single", 8, 1024)
    text, num, clauses, cl, msm, boost, live = _args(c, True)
    f = text["f"]
    got = cs.fused_topk_dense(f["fwd_tids"], f["fwd_imps"], f["tile_max"],
                              cl[0][0], cl[0][1], live, 10)
    want = cs.fused_topk_bundle(text, num, clauses, cl, msm, None, live, 10)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_threshold_prunes_and_chunking_changes_only_flags():
    """k = 1 raises the threshold within a chunk: once tile 0 holds the
    best doc, every later tile's bound falls below it. One long chunk
    thresholds those tiles, single-tile chunks threshold none, and the
    hits are the same."""
    tile, B = 256, 8
    tids = np.full((CAP, 2), -1, np.int32)
    tids[:, 0] = 0
    imps = np.zeros((CAP, 2), np.float32)
    imps[:, 0] = 1.0
    imps[17, 0] = 4.0
    text = {"f": {"fwd_tids": torch.from_numpy(tids),
                  "fwd_imps": torch.from_numpy(imps),
                  "tile_max": torch.from_numpy(
                      build_tile_max(tids, imps, 1, CAP, tile=tile))}}
    clauses = BUNDLES["single"]
    cl = ((torch.zeros((B, 1), dtype=torch.int32),
           torch.ones((B, 1)), torch.ones(B, dtype=torch.int32),
           torch.ones(B)),)
    msm, boost = torch.ones(B, dtype=torch.int32), torch.ones(B)
    live = torch.ones(CAP, dtype=torch.bool)
    can, ub = sc.bundle_tile_bounds(clauses, cl, text, {}, msm, boost)
    outs = [cs.bundle_walk_ref(text, {}, clauses, cl, msm, boost, live,
                               can, ub, ck=1, update_thr=True,
                               emit_match=False, bt=B, chunk_tiles=ct)
            for ct in (CAP // tile, 1)]
    (cs_a, ci_a, cnt_a, fl_a, _, _), (cs_b, ci_b, cnt_b, fl_b, _, _) = outs
    assert torch.equal(cnt_a, cnt_b)
    assert int((fl_a == 1).sum()) == B * (CAP // tile - 1)
    assert int((fl_b == 1).sum()) == 0
    for strip, ids in ((cs_a, ci_a), (cs_b, ci_b)):
        top_s, top_i = strip.max(dim=1)
        assert (top_s == 4.0).all() and (ids[:, 0] == 17).all()
    got = cs.fused_topk_bundle_ref(text, {}, clauses, cl, msm, boost, live,
                                   1)
    assert (got[1][:, 0] == 17).all() and (got[2] == CAP).all()


# ---------------------------------------------------------------------------
# (c) the whole path: _msearch with the fused engine on
# ---------------------------------------------------------------------------


def _shard(docs, shard_id=0):
    from elasticsearch_tpu.index.mapping import MapperService as RefMapper
    from elasticsearch_tpu.index.segment import SegmentBuilder as RefBuilder
    from elasticsearch_tpu.search.shard_searcher import \
        ShardReader as RefReader
    from elasticsearch_tpu_torch.index.mapping import MapperService
    from elasticsearch_tpu_torch.index.segment import SegmentBuilder
    from elasticsearch_tpu_torch.search.shard_searcher import ShardReader
    out = []
    for mapper_cls, builder_cls, reader_cls, kw in (
            (MapperService, SegmentBuilder, ShardReader, {"device": "cpu"}),
            (RefMapper, RefBuilder, RefReader, {})):
        svc = mapper_cls(mapping=corpus.MAPPING)
        b = builder_cls()
        for did, d in docs:
            b.add(svc.parse(did, d))
        seg = b.build(f"s{shard_id}")
        out.append(reader_cls("logs", [seg], {}, svc, shard_id=shard_id, **kw))
    return out


@pytest.fixture(scope="module")
def one_shard():
    return _shard(corpus.make_docs(1500, seed=42, long_every=300))


@pytest.fixture(scope="module")
def two_shards():
    return [_shard(corpus.make_docs(700, seed=s, start=700 * s,
                                    long_every=200), shard_id=s)
            for s in range(2)]


def _assert_same(port, ref, path="resp"):
    """Exact equality, float agg `value`s (sum/avg) included."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and sorted(port) == sorted(ref), path
        for k in ref:
            if k == "took":
                continue
            if (k == "value" and isinstance(ref[k], float)
                    and "aggregations" in path):
                assert port[k] == ref[k], (path, port[k], ref[k])
                continue
            _assert_same(port[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert isinstance(port, list) and len(port) == len(ref), path
        for i, (p, r) in enumerate(zip(port, ref)):
            _assert_same(p, r, f"{path}[{i}]")
    else:
        assert type(port) is type(ref) and port == ref, (path, port, ref)


_MIXES = ["match", "bool_aggs", "prefix", "term_body", "aggs_only",
          "match_range_aggs", "count_match"]
_FUSED_MIXES = ("match", "match_range_aggs", "count_match")


def _bodies(mix, reader, n=12, seed=7, bodies=None):
    if bodies is None:
        bodies = corpus.request_mixes(n, seed=seed)[mix]
    if mix == "prefix":
        # the reference trips on a group of prefixes that all expand to
        # nothing (ROADMAP Queue 3); keep prefixes that expand
        terms = reader.segments[0].text["message"].terms
        bodies = [b for b in bodies
                  if any(t.startswith(b["query"]["prefix"]["message"])
                         for t in terms)]
    return bodies


@pytest.mark.parametrize("mix", _MIXES)
def test_request_mix_fused_matches_reference(one_shard, mix):
    port, ref = one_shard
    bodies = _bodies(mix, port)
    ex._fused_stats.reset()
    ref_ex._fused_stats.reset()
    got = port.msearch(bodies)
    want = ref.msearch(bodies)
    _assert_same(got, want)
    assert any(r["hits"]["total"] > 0 for r in want)
    p_adm = ex.fused_scoring_stats()["admission"]
    r_adm = ref_ex.fused_scoring_stats()["admission"]
    # both packages admit and reject the same plans, for the same reasons
    assert p_adm["admitted"] == r_adm["admitted"]
    assert p_adm["rejected"] == r_adm["rejected"]
    if mix in _FUSED_MIXES:
        assert p_adm["admitted"] > 0 and not p_adm["rejected"]
        tiles = ex.fused_scoring_stats()["tiles"]
        assert tiles["examined"] > 0
    else:
        assert p_adm["admitted"] == 0 and p_adm["rejected"]


@pytest.mark.parametrize("mix", _MIXES)
def test_two_shard_reduce_fused_matches_reference(two_shards, mix):
    from elasticsearch_tpu.search.aggregations import \
        parse_aggs as ref_parse_aggs
    from elasticsearch_tpu.search.controller import \
        merge_shard_results as ref_merge
    from elasticsearch_tpu_torch.search.aggregations import parse_aggs
    from elasticsearch_tpu_torch.search.controller import \
        merge_shard_results
    bodies = corpus.request_mixes(6, seed=11)[mix]
    for pair in two_shards:
        bodies = _bodies(mix, pair[0], bodies=bodies)
    merged = {}
    for side, (reader_idx, parse, merge) in {
            "port": (0, parse_aggs, merge_shard_results),
            "ref": (1, ref_parse_aggs, ref_merge)}.items():
        per_shard = [pair[reader_idx].msearch(bodies, with_partials=True)
                     for pair in two_shards]
        out = []
        for i, body in enumerate(bodies):
            resps = [shard[i] for shard in per_shard]
            out.append(merge(
                resps, agg_specs=parse(body.get("aggs")),
                shard_partials=[r.get("_agg_partials", {}) for r in resps],
                frm=body.get("from", 0), size=body.get("size", 10)))
        merged[side] = out
    _assert_same(merged["port"], merged["ref"])
    assert bodies and any(r["hits"]["total"] > 0 for r in merged["ref"])
