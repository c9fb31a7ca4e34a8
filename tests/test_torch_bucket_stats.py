"""Per-bucket stats and K1's signature filter of the PyTorch port, on the
CPU, against the JAX package bit for bit.

`ops/aggs.bucket_stats` gives any of a doc-space bucket's sum, sum of
squares, count, min and max at once; on the card it is one kernel
(`cuda_scoring.ordered_bucket_stats`, csrc/bucket_stats.cu), on the CPU
the plain reduces of `ops/ordered.py`, which are held here against the
reference's `bucket_sums`, `bucket_sum_sq`, `bucket_counts`,
`bucket_min` and `bucket_max` (XLA's scatters), NaN payloads, infinities
and signed zeros included. A host emulation of the kernel's two passes
(tiles, chunks, compacted ranks, pieces) checks its index arithmetic on
the layout `cuda_scoring.bucket_layout` builds. The responses of
`_msearch` with stats / extended_stats / min / max sub-aggs equal the
reference's byte for byte.

K1 (`dense_score`) writes +0.0 without the compares for a pair whose
term signatures share no bit; `cuda_scoring.dense_candidates_ref`
mirrors that filter, and here it drops no pair the reference scores
other than +0.0.

Tolerance: none (bit equality). XLA's CPU runtime flushes subnormals
(its min / max compare them as zero); no input here carries one.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.index.mapping import MapperService as RefMapper
from elasticsearch_tpu.index.segment import SegmentBuilder as RefBuilder
from elasticsearch_tpu.ops import aggs as ref_aggs
from elasticsearch_tpu.search import executor as ref_ex
from elasticsearch_tpu.search.aggregations import parse_aggs as ref_parse_aggs
from elasticsearch_tpu.search.controller import \
    merge_shard_results as ref_merge
from elasticsearch_tpu.search.shard_searcher import ShardReader as RefReader

from elasticsearch_tpu_torch import corpus
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.ops import aggs as port_aggs
from elasticsearch_tpu_torch.ops import cuda_scoring as cs
from elasticsearch_tpu_torch.ops import ordered
from elasticsearch_tpu_torch.search.aggregations import parse_aggs
from elasticsearch_tpu_torch.search.controller import merge_shard_results
from elasticsearch_tpu_torch.search.shard_searcher import ShardReader

torch.set_num_threads(1)

_REF = {"sum": ref_aggs.bucket_sums, "sum_sq": ref_aggs.bucket_sum_sq,
        "min": ref_aggs.bucket_min, "max": ref_aggs.bucket_max}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


def _f32(bits):
    return np.array([bits], np.uint32).view(np.float32)[0]


# NaNs of both signs and several payloads (one signalling), infinities,
# signed zeros and ordinary values
_SPECIAL = np.array([_f32(0x7FC00001), _f32(0x7FC00005), _f32(0xFFC00002),
                     _f32(0xFFC00009), _f32(0x7F800001), _f32(0xFF800003),
                     np.inf, -np.inf, 0.0, -0.0, 1.5, -2.5, 3e38, -3e38,
                     7e-30, -7e-30], np.float32)


def _reference(ids, mask, values, n_buckets):
    out = {k: fn(jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(values),
                 n_buckets) for k, fn in _REF.items()}
    out["count"] = ref_aggs.bucket_counts(jnp.asarray(ids),
                                          jnp.asarray(mask), n_buckets)
    return out


def _stats_case(seed, B, cap, n_buckets, hot=None, special=0):
    """Ids with some in [-n, 0) (wrapped) and some past either end
    (dropped), non-integer values over many magnitudes, `special` docs of
    bucket 0 drawn from _SPECIAL, a mask with an empty first row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-n_buckets - 3, n_buckets + 3, size=cap)
    if hot is not None:                      # one bucket holds most docs
        ids[rng.random(cap) < 0.8] = hot
    values = (rng.standard_normal(cap)
              * np.exp(rng.uniform(-12, 12, cap))).astype(np.float32)
    values[rng.random(cap) < 0.03] = -0.0
    values[rng.random(cap) < 0.03] = 0.0
    if special:
        at = rng.choice(cap, size=special, replace=False)
        ids[at] = 0
        values[at] = rng.choice(_SPECIAL, size=special)
    mask = rng.random((B, cap)) < 0.6
    mask[0] = False
    return ids.astype(np.int32), mask, values


_CASES = {
    "hot bucket": (1, 4, 4096, 3, 1, 0),
    "wrapped and dropped ids": (2, 3, 3000, 7, None, 0),
    "one bucket": (3, 5, 2000, 1, 0, 0),
    "specials in one bucket": (4, 4, 1500, 3, None, 60),
    "specials, hot": (5, 3, 3000, 3, 0, 200),
    "40,000 buckets": (6, 2, 50_000, 40_000, None, 0),
    "40,000 buckets, specials": (7, 2, 50_000, 40_000, None, 40),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_bucket_stats_is_the_reference(case):
    """Every stat of `bucket_stats` against the reference's five bucket
    functions, bit for bit; the empty row gives 0 / +inf / -inf."""
    seed, B, cap, n, hot, special = _CASES[case]
    ids, mask, values = _stats_case(seed, B, cap, n, hot, special)
    want = _reference(ids, mask, values, n)
    got = port_aggs.bucket_stats(_t(ids), _t(mask), _t(values), n,
                                 cs.BUCKET_STATS)
    assert set(got) == set(cs.BUCKET_STATS)
    for st in cs.BUCKET_STATS:
        np.testing.assert_array_equal(_bits(got[st]), _bits(want[st]),
                                      err_msg=st)
    assert not got["count"][0].any() and not got["sum"][0].any()
    assert torch.isinf(got["min"][0]).all() and (got["min"][0] > 0).all()
    if special:
        mn = _bits(want["min"])[:, 0]
        assert (mn != _bits(np.float32(np.inf))).any()


@pytest.mark.parametrize("stats", [("min",), ("max", "count"),
                                   ("sum_sq", "sum"), ("count",)])
def test_bucket_stats_gives_the_stats_asked(stats):
    ids, mask, values = _stats_case(8, 3, 2000, 5, special=30)
    got = port_aggs.bucket_stats(_t(ids), _t(mask), _t(values), 5, stats)
    assert tuple(got) == stats
    full = port_aggs.bucket_stats(_t(ids), _t(mask), _t(values), 5,
                                  cs.BUCKET_STATS)
    for st in stats:
        np.testing.assert_array_equal(_bits(got[st]), _bits(full[st]))
    with pytest.raises(ValueError):
        port_aggs.bucket_stats(_t(ids), _t(mask), _t(values), 5, ("avg",))


@pytest.mark.parametrize("fn", ["bucket_sums", "bucket_sum_sq",
                                "bucket_min", "bucket_max", "bucket_counts"])
def test_bucket_functions_are_the_reference(fn):
    """The port's five counterparts of the reference's functions (the
    plain forms of the kernel) on the special values."""
    ids, mask, values = _stats_case(9, 4, 2500, 4, hot=2, special=120)
    args = (ids, mask) if fn == "bucket_counts" else (ids, mask, values)
    want = getattr(ref_aggs, fn)(*map(jnp.asarray, args), 4)
    got = getattr(port_aggs, fn)(*map(_t, args), 4)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("seed", range(24))
def test_bucket_extreme_is_xla_min_max(seed):
    """XLA's scatter min / max of where(mask, v, +-inf) on short buckets
    drawn from NaNs of both signs, infinities and signed zeros: the NaN
    kept depends on the order, the rank keys reproduce it."""
    rng = np.random.default_rng(seed)
    cap, n, B = int(rng.integers(1, 60)), int(rng.integers(1, 6)), 3
    ids = rng.integers(-n - 2, n + 2, size=cap).astype(np.int32)
    pool = _SPECIAL if seed % 3 else _SPECIAL[6:]
    values = rng.choice(pool, size=cap).astype(np.float32)
    mask = rng.random((B, cap)) < 0.7
    for largest, fn in ((False, ref_aggs.bucket_min),
                        (True, ref_aggs.bucket_max)):
        want = fn(jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(values), n)
        got = ordered.bucket_extreme(_t(ids), _t(mask), _t(values), n,
                                     largest)
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_extreme_keys_round_trip():
    """Decoding a value's own rank key gives its bits back."""
    v = _t(np.concatenate([_SPECIAL, np.float32([1e-3, -1e3, 65504.0])]))
    for largest in (False, True):
        keys = ordered.extreme_keys(v, largest)
        back = ordered.extreme_value(keys, v, largest)
        np.testing.assert_array_equal(_bits(back), _bits(v))


# -- the kernel's passes, emulated on the host over its layout ------------

def _emulate_kernel(ids, mask, values, n_buckets):
    """csrc/bucket_stats.cu's two passes in numpy: compact_kernel's
    per-tile compaction (ranks in position order, each chunk's first
    rank, the tile's total) and fold_kernel's walk of a bucket's chunks
    (the end of a chunk: the tile's total where it reaches the tile's end
    or the kept docs' end, else the next chunk's first rank)."""
    T = cs.BUCKET_TILE
    order, sorted_b, starts, cf = (x.numpy() for x in cs.bucket_layout(
        _t(ids), n_buckets))
    B, cap = mask.shape
    kept = int(starts[n_buckets])
    n_tiles = -(-cap // T)
    vals = np.zeros((B, n_tiles * T), np.float32)
    crank = np.full((B, n_tiles + n_buckets), -1, np.int64)
    ttot = np.zeros((B, n_tiles), np.int64)
    for b in range(B):
        for t in range(n_tiles):
            p0, p1 = t * T, min((t + 1) * T, kept)
            if p0 >= kept:
                continue
            m = mask[b, order[p0:p1]]
            rank = np.concatenate([[0], np.cumsum(m)])
            vals[b, p0:p0 + int(m.sum())] = values[order[p0:p1]][m]
            ttot[b, t] = rank[-1]
            for p in range(p0, p1):
                if p == p0 or sorted_b[p] != sorted_b[p - 1]:
                    j = sorted_b[p]
                    crank[b, cf[j] + t - starts[j] // T] = rank[p - p0]
    sums = np.zeros((B, n_buckets), np.float32)
    counts = np.zeros((B, n_buckets), np.int64)
    for b in range(B):
        for j in range(n_buckets):
            s = np.float32(0.0)
            for c in range(cf[j], cf[j + 1]):
                t = starts[j] // T + (c - cf[j])
                end = min((t + 1) * T, starts[j + 1], kept)
                r0 = crank[b, c]
                r1 = (ttot[b, t] if end == min((t + 1) * T, kept)
                      else crank[b, c + 1])
                assert 0 <= r0 <= r1
                for x in vals[b, t * T + r0:t * T + r1]:
                    s = np.float32(s + x)
                counts[b, j] += r1 - r0
            sums[b, j] = s
    return sums, counts


@pytest.mark.parametrize("B,cap,n,hot", [(3, 5000, 7, None),
                                         (2, 9000, 3, 1), (2, 4096, 1, 0),
                                         (2, 3000, 900, None),
                                         (1, 2049, 2, None)])
def test_kernel_passes_on_the_layout(B, cap, n, hot):
    """The kernel's chunk and rank arithmetic, emulated, gives the plain
    fold and count: buckets across tiles, many buckets a tile, ids
    dropped past the kept docs' end, a tile ending one past a bucket."""
    ids, mask, values = _stats_case(B * cap + n, B, cap, n, hot)
    with np.errstate(over="ignore", invalid="ignore"):
        sums, counts = _emulate_kernel(ids, mask, values, n)
    want = cs.ordered_bucket_stats_ref(_t(ids), _t(mask), _t(values), n,
                                       ("sum", "count"))
    np.testing.assert_array_equal(_bits(sums), _bits(want["sum"]))
    np.testing.assert_array_equal(counts.astype(np.float32),
                                  want["count"].numpy())


def test_bucket_layout_is_kept_on_the_ids():
    ids, _m, _v = _stats_case(10, 1, 5000, 9)
    t = _t(ids)
    a = cs.bucket_layout(t, 9)
    assert cs.bucket_layout(t, 9) is a
    b = cs.bucket_layout(t, 10)
    assert b is not a and cs.bucket_layout(t, 10) is b
    order, sorted_b, starts, cf = a
    kept = ordered.bucket_ids_kept(t, 9).numpy()
    np.testing.assert_array_equal(sorted_b.numpy(), kept[order.numpy()])
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(kept, kind="stable"))
    np.testing.assert_array_equal(starts.numpy(),
                                  np.searchsorted(kept[order.numpy()],
                                                  np.arange(10)))
    T = cs.BUCKET_TILE
    s, e = starts.numpy()[:-1], starts.numpy()[1:]
    n_ch = np.where(e > s, (e - 1) // T - s // T + 1, 0)
    np.testing.assert_array_equal(cf.numpy(),
                                  np.concatenate([[0], np.cumsum(n_ch)]))


# -- K1's signature filter ------------------------------------------------

def _sig_bit(t):
    t = np.asarray(t, np.int64)
    h = ((t & 0xFFFFFFFF) * 0x9E3779B1) & 0xFFFFFFFF
    return np.where(t < 0, 127, (h * 127) >> 32)


def _colliding(n_terms):
    """Pairs of distinct term ids below n_terms on the same signature
    bit."""
    bits = _sig_bit(np.arange(n_terms))
    out = []
    for b in range(127):
        ids = np.flatnonzero(bits == b)
        if len(ids) >= 2:
            out.append((int(ids[0]), int(ids[1])))
    return out


def _dense_case(kind, rng):
    cap, L, B, Q, n_terms = 777, 8, 9, 4, 300
    tids = np.full((cap, L), -1, np.int32)
    imps = np.zeros((cap, L), np.float32)
    lens = rng.integers(0, L + 1, size=cap)
    for d in range(cap):
        tids[d, :lens[d]] = rng.choice(n_terms, size=lens[d], replace=False)
        imps[d, :lens[d]] = rng.random(lens[d], dtype=np.float32) * 4 + 0.1
    qt = rng.integers(-1, n_terms, size=(B, Q)).astype(np.int32)
    qt[:, 0] = tids[rng.integers(0, cap, size=B), 0]
    wq = (rng.random((B, Q), dtype=np.float32) * 3).astype(np.float32)
    wq[qt < 0] = 0.0
    if kind == "collisions":
        # the query's terms collide with terms the docs hold, and the
        # docs hold none of the query's own terms
        pairs = _colliding(n_terms)
        for b in range(B):
            a, c = pairs[b % len(pairs)]
            tids[tids == c] = a
            qt[b] = [c, -1, -1, -1]
            wq[b] = [2.0, 0.0, 0.0, 0.0]
    elif kind == "duplicate ids":
        tids[:, 1] = np.where(tids[:, 1] >= 0, tids[:, 0], -1)
    elif kind == "negative weights":
        wq = -wq
        wq[2, 1] = -0.0
    elif kind == "zero impacts":
        imps[rng.random((cap, L)) < 0.4] = 0.0
        imps[rng.random((cap, L)) < 0.2] = -0.0
    elif kind == "inf weight":
        wq[3, 2] = np.inf
        wq[5, 0] = -np.inf
    elif kind == "nan weight":
        wq[4, 1] = np.nan
    elif kind == "huge impacts":
        # a doc's hit can overflow to inf, and inf * 0.0 is NaN: a term of
        # weight 0.0 still counts there
        tids[::9, 1] = np.where(tids[::9, 0] >= 0, tids[::9, 0], 5)
        imps[::9, :2] = 3e38
        qt[:, 3] = tids[0, 0]
        wq[:, 3] = 0.0
    elif kind == "negative ids with impact":
        # not the segment builder's layout (its padding has impact 0),
        # but the kernel must still equal its plain version
        tids[::7, -1] = -1
        imps[::7, -1] = 1.25
        qt[1, 3] = -1
        wq[1, 3] = 0.5
    return tids, imps, qt, wq


_DENSE_KINDS = ["builder layout", "collisions", "duplicate ids",
                "negative weights", "zero impacts", "inf weight",
                "nan weight", "huge impacts", "negative ids with impact"]


@pytest.mark.parametrize("kind", _DENSE_KINDS)
def test_dense_filter_drops_no_match(kind):
    """Every pair the filter drops scores +0.0 in the plain version (the
    Pallas body's order), so writing +0.0 there gives its bits; the plain
    version is the reference's jnp `terms_dense` path."""
    rng = np.random.default_rng(_DENSE_KINDS.index(kind))
    tids, imps, qt, wq = _dense_case(kind, rng)
    args = tuple(map(_t, (tids, imps, qt, wq)))
    want = cs.dense_score_ref(*args)
    cand = cs.dense_candidates_ref(*args)
    zero = torch.zeros((), dtype=torch.float32)
    np.testing.assert_array_equal(_bits(want[~cand]), 0)
    np.testing.assert_array_equal(_bits(torch.where(cand, want, zero)),
                                  _bits(want))
    assert cand.any() and not cand.all()
    cap, B, Q = tids.shape[0], qt.shape[0], qt.shape[1]
    seg = {"text": {"f": {"fwd_tids": jnp.asarray(tids),
                          "fwd_imps": jnp.asarray(imps)}}}
    ref_s, _ = ref_ex.eval_node(("terms_dense", "f", Q),
                                (jnp.asarray(qt), jnp.asarray(wq)), seg, cap,
                                B)
    np.testing.assert_array_equal(_bits(want), _bits(ref_s))
    if kind in ("inf weight", "nan weight"):
        wild = ~np.isfinite(wq).all(axis=1)
        assert cand[_t(wild)].all()
    if kind == "collisions":
        # signatures meet on a term the doc does not hold: a candidate
        # that scores +0.0
        assert (cand & (want.view(torch.int32) == 0)).any()
    if kind == "huge impacts":
        assert torch.isnan(want).any() and cand[torch.isnan(want)].all()


def test_dense_candidates_chunk_rows():
    rng = np.random.default_rng(11)
    args = tuple(map(_t, _dense_case("builder layout", rng)))
    full = cs.dense_candidates_ref(*args, rows=1000)
    assert torch.equal(cs.dense_candidates_ref(*args, rows=2), full)


# -- the slice: _msearch with stats sub-aggs, byte for byte ---------------

_MAPPING = {"properties": {**corpus.MAPPING["properties"],
                           "latency": {"type": "float"},
                           "delta": {"type": "float"}}}


def _docs(n, seed, start):
    rng = np.random.default_rng(seed + 2000)
    lat = (rng.lognormal(3.0, 1.5, size=n) * 1.37).astype(np.float32)
    delta = (rng.standard_normal(n) * 50).astype(np.float32)
    delta[rng.random(n) < 0.05] = 0.0
    delta[rng.random(n) < 0.05] = -0.0
    return [(did, {**d, "latency": float(lat[i]), "delta": float(delta[i])})
            for i, (did, d) in enumerate(corpus.make_docs(
                n, seed=seed, start=start, long_every=0))]


@pytest.fixture(scope="module")
def stats_shards():
    out = []
    for s in range(2):
        docs = _docs(2000, 60 + s, 2000 * s)
        pair = []
        for mapper_cls, builder_cls, reader_cls, kw in (
                (MapperService, SegmentBuilder, ShardReader,
                 {"device": "cpu"}),
                (RefMapper, RefBuilder, RefReader, {})):
            svc = mapper_cls(mapping=_MAPPING)
            b = builder_cls()
            for did, d in docs:
                b.add(svc.parse(did, d))
            pair.append(reader_cls("logs", [b.build(f"s{s}")], {}, svc,
                                   shard_id=s, **kw))
        out.append(pair)
    return out


_STATS_AGGS = {
    "by_status": {"terms": {"field": "status"},
                  "aggs": {"ext": {"extended_stats": {"field": "latency"}},
                           "mn": {"min": {"field": "delta"}},
                           "mx": {"max": {"field": "delta"}},
                           "st": {"stats": {"field": "size"}}}},
    "per_day": {"date_histogram": {"field": "@timestamp",
                                   "interval": "day"},
                "aggs": {"st": {"stats": {"field": "latency"}},
                         "ext": {"extended_stats": {"field": "delta"}}}},
    "by_size": {"histogram": {"field": "size", "interval": 20_000},
                "aggs": {"mn": {"min": {"field": "latency"}},
                         "mx": {"max": {"field": "delta"}}}},
}


def _strip_took(x):
    if isinstance(x, dict):
        return {k: _strip_took(v) for k, v in x.items() if k != "took"}
    if isinstance(x, list):
        return [_strip_took(v) for v in x]
    return x


@pytest.mark.parametrize("fused", ["0", "1"])
def test_msearch_stats_sub_aggs_byte_equal(stats_shards, monkeypatch, fused):
    """terms -> extended_stats / min / max / stats, date_histogram ->
    stats / extended_stats and histogram -> min / max (the doc-space
    bucket stats), on match and range-only queries, merged and per
    shard."""
    monkeypatch.setenv("ES_TPU_FUSED", fused)
    rng = np.random.default_rng(12)
    words = corpus.head_terms(rng, 6)
    bodies = []
    for i in range(6):
        lo = int(rng.integers(100, 60_000))
        q = ({"match": {"message": words[i]}} if i % 2 == 0
             else {"range": {"size": {"gte": lo}}})
        bodies.append({"query": q, "aggs": _STATS_AGGS, "size": 0})
    merged = {}
    for side, (idx, parse, merge) in {
            "port": (0, parse_aggs, merge_shard_results),
            "ref": (1, ref_parse_aggs, ref_merge)}.items():
        per_shard = [pair[idx].msearch(bodies, with_partials=True)
                     for pair in stats_shards]
        out = []
        for i, body in enumerate(bodies):
            resps = [shard[i] for shard in per_shard]
            out.append(merge(
                resps, agg_specs=parse(body.get("aggs")),
                shard_partials=[r.get("_agg_partials", {}) for r in resps],
                frm=0, size=0, descending=True, score_sort=True))
        merged[side] = _strip_took(out)
        merged[side + "_shards"] = _strip_took(
            [pair[idx].msearch(bodies) for pair in stats_shards])
    assert json.dumps(merged["port"], sort_keys=True) \
        == json.dumps(merged["ref"], sort_keys=True)
    assert json.dumps(merged["port_shards"], sort_keys=True) \
        == json.dumps(merged["ref_shards"], sort_keys=True)
    ext = [b["ext"] for r in merged["ref"]
           for b in r["aggregations"]["by_status"]["buckets"]]
    assert ext and all(e["count"] > 0 and e["sum_of_squares"] > 0
                       for e in ext)
    mins = [b["mn"]["value"] for r in merged["ref"]
            for b in r["aggregations"]["by_status"]["buckets"]]
    assert mins and all(m < 0 for m in mins)
