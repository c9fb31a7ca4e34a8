"""Agg sums of the PyTorch port in the reference's exact f32 order, on the
CPU, against the JAX package bit for bit.

The reference takes its agg sums with XLA's `cumsum`, `.sum(-1)` and
`.at[ids].add(mode="drop")`; `elasticsearch_tpu_torch/ops/ordered.py`
reproduces the three orders (a base-16 blocked scan; a tree of centred
windows of 32; a left fold per bucket in doc order), and ops/aggs routes
every float agg sum through them. The orders are pinned here against
JAX itself, on non-integer weights whose sums round differently in any
other order. Tolerance: none (bit equality).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from elasticsearch_tpu.index.mapping import MapperService as RefMapper
from elasticsearch_tpu.index.segment import SegmentBuilder as RefBuilder
from elasticsearch_tpu.ops import aggs as ref_aggs
from elasticsearch_tpu.search.aggregations import parse_aggs as ref_parse_aggs
from elasticsearch_tpu.search.controller import \
    merge_shard_results as ref_merge
from elasticsearch_tpu.search.shard_searcher import ShardReader as RefReader

from elasticsearch_tpu_torch import corpus
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.ops import aggs as port_aggs
from elasticsearch_tpu_torch.ops import ordered
from elasticsearch_tpu_torch.search.aggregations import parse_aggs
from elasticsearch_tpu_torch.search.controller import merge_shard_results
from elasticsearch_tpu_torch.search.shard_searcher import ShardReader

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


def _assert_bits(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _wild(rng, shape):
    """f32 values over many magnitudes and both signs, with signed zeros."""
    x = (rng.standard_normal(shape)
         * np.exp(rng.uniform(-12, 12, shape))).astype(np.float32)
    x.reshape(-1)[rng.random(x.size) < 0.05] = -0.0
    x.reshape(-1)[rng.random(x.size) < 0.02] = 0.0
    return x


@pytest.mark.parametrize("n", [1, 15, 16, 17, 255, 257, 4097, 1 << 16])
def test_xla_cumsum_is_jnp_cumsum(n):
    rng = np.random.default_rng(n)
    x = _wild(rng, (3, n))
    x[0, :4] = -0.0                    # fl(0 + -0.0) is +0.0 ...
    x[1, 0] = 3e38                     # ... and magnitudes near the top
    _assert_bits(ordered.xla_cumsum(_t(x)), jnp.cumsum(jnp.asarray(x),
                                                        axis=-1))
    # one row of one element is returned as it is (-0.0 stays)
    _assert_bits(ordered.xla_cumsum(_t(np.full((1, 1), -0.0, np.float32))),
                 np.full((1, 1), -0.0, np.float32))


@pytest.mark.parametrize("shape", [(3, 64, 512), (2, 16, 128), (1, 5, 128),
                                   (4, 2048, 512)])
def test_xla_block_sum_is_sum_over_blocks(shape):
    rng = np.random.default_rng(shape[1])
    x = _wild(rng, shape)
    _assert_bits(ordered.xla_block_sum(_t(x)), jnp.asarray(x).sum(-1))
    _assert_bits(ordered.xla_block_sum(_t(x)),
                 jax.jit(lambda a: a.sum(-1))(jnp.asarray(x)))


@pytest.mark.parametrize("n", [128, 1024, 1 << 14, 1 << 16, 1 << 20])
def test_xla_block_sum_is_row_sum_at_power_of_two_lengths(n):
    rng = np.random.default_rng(n)
    x = _wild(rng, (2, n))
    _assert_bits(ordered.xla_block_sum(_t(x)),
                 jax.jit(lambda a: a.sum(-1))(jnp.asarray(x)))


def _sizes_case(rng, B=4, cap=65_536, G=12):
    """The case that failed before the order was pinned: 12 keyword
    groups over 65,536 docs, `size`-like integer weights 1..200,000 under
    a match mask (sums past 2^24 round in any order but XLA's)."""
    ords = rng.integers(-1, G, size=cap).astype(np.int32)
    perm = np.argsort(ords, kind="stable").astype(np.int32)
    starts = np.searchsorted(ords[perm], np.arange(G + 1)).astype(np.int32)
    size = rng.integers(1, 200_001, size=cap).astype(np.float32)
    mask = rng.random((B, cap)) < 0.6
    return perm, starts, np.where(mask, size[None, :], 0).astype(np.float32)


def test_sorted_group_reduce_sizes_case():
    rng = np.random.default_rng(0)
    perm, starts, w = _sizes_case(rng)
    _assert_bits(port_aggs.sorted_group_reduce(_t(perm), _t(starts), _t(w)),
                 ref_aggs.sorted_group_reduce(jnp.asarray(perm),
                                              jnp.asarray(starts),
                                              jnp.asarray(w)))
    # non-integer weights, signed zeros, a one-doc and an empty group
    wf = _wild(rng, w.shape)
    st = starts.copy()
    st[3] = st[2] + 1
    st[5] = st[4] = st[3] + 7
    _assert_bits(port_aggs.sorted_group_reduce(_t(perm), _t(st), _t(wf)),
                 ref_aggs.sorted_group_reduce(jnp.asarray(perm),
                                              jnp.asarray(st),
                                              jnp.asarray(wf)))


@pytest.mark.parametrize("cap", [65_536, 1000])
def test_sorted_hist_reduce_sizes_case(cap):
    rng = np.random.default_rng(1)
    vals = rng.integers(0, 86_400 * 30, size=cap).astype(np.int32)
    perm = np.argsort(vals, kind="stable").astype(np.int32)
    size = rng.integers(1, 200_001, size=cap).astype(np.float32)
    w = np.where(rng.random((4, cap)) < 0.6, size[None, :], 0
                 ).astype(np.float32)
    edges = (np.arange(31) * 86_400).astype(np.int32)
    edges[-1] = np.iinfo(np.int32).max
    for weights in (w, _wild(rng, w.shape)):
        _assert_bits(
            port_aggs.sorted_hist_reduce(_t(vals[perm]), _t(perm),
                                         _t(weights), _t(edges)),
            ref_aggs.sorted_hist_reduce(jnp.asarray(vals[perm]),
                                        jnp.asarray(perm),
                                        jnp.asarray(weights),
                                        jnp.asarray(edges)))


@pytest.mark.parametrize("Np", [65_536, 2048, 384, 1000, 100])
@pytest.mark.parametrize("per_row", [False, True])
def test_view_group_reduce_float_sums_exact(Np, per_row):
    """Block sums, the short cumsum and the intra-block prefix (and the
    flat cumsum where neither 512 nor 128 divides) in XLA's order."""
    rng = np.random.default_rng(Np + per_row)
    B, G = 4, 12
    size = rng.integers(1, 200_001, size=Np).astype(np.float32)
    w = np.where(rng.random((B, Np)) < 0.6, size[None, :], 0
                 ).astype(np.float32)
    if per_row:
        bounds = np.sort(rng.integers(0, Np + 1, size=(B, G + 1)),
                         axis=1).astype(np.int32)
        bounds[:, -1] = Np
    else:
        bounds = np.sort(rng.integers(0, Np + 1, size=G + 1)
                         ).astype(np.int32)
        bounds[0], bounds[-1] = 0, Np
    for weights in (w, _wild(rng, w.shape)):
        _assert_bits(port_aggs.view_group_reduce(_t(weights), _t(bounds)),
                     ref_aggs.view_group_reduce(jnp.asarray(weights),
                                                jnp.asarray(bounds)))


def _stats_case(n, seed):
    rng = np.random.default_rng(seed)
    values = rng.integers(1, 200_001, size=n).astype(np.int32)
    exists = rng.random(n) < 0.95
    mask = rng.random((3, n)) < 0.6
    return values, exists, mask


@pytest.mark.parametrize("n", [128, 4096, 1 << 14, 1 << 16])
def test_masked_stats_exact_at_power_of_two_capacity(n):
    values, exists, mask = _stats_case(n, n)
    got = port_aggs.masked_stats(_t(values), _t(exists), _t(mask))
    want = ref_aggs.masked_stats(jnp.asarray(values), jnp.asarray(exists),
                                 jnp.asarray(mask))
    for k in ("count", "sum", "sum_sq", "min", "max"):
        _assert_bits(got[k], want[k])


# lengths off a power of two: XLA pads each level to windows of 32 with
# p // 2 zeros before the row and the rest after it
_ODD_LENGTHS = [*range(1, 41), 65, 100, 1000, 1500, 3000, 20_000, 100_000]


@pytest.mark.parametrize("n", _ODD_LENGTHS)
def test_xla_block_sum_is_row_sum_at_every_length(n):
    rng = np.random.default_rng(n + 7)
    x = _wild(rng, (4, n))
    want = jax.jit(lambda a: a.sum(-1))(jnp.asarray(x))
    _assert_bits(ordered.xla_block_sum(_t(x)), want)
    _assert_bits(ordered.xla_block_sum(_t(x)), jnp.asarray(x).sum(-1))


@pytest.mark.parametrize("n", [1000, 20_000, 100_000, 33, 100, 1500, 3000])
def test_masked_stats_within_bound_elsewhere(n):
    """Rows whose length is no power of two: sum and sum_sq take XLA's
    centred windows, so every stat is the reference's bits (the name is
    kept from when a bound held these)."""
    values, exists, mask = _stats_case(n, n)
    got = port_aggs.masked_stats(_t(values), _t(exists), _t(mask))
    want = ref_aggs.masked_stats(jnp.asarray(values), jnp.asarray(exists),
                                 jnp.asarray(mask))
    for k in ("count", "sum", "sum_sq", "min", "max"):
        _assert_bits(got[k], want[k])


def _bucket_case(seed, B, cap, n_buckets, hot=None, p_match=0.6):
    """Bucket ids with some past n_buckets and some negative (wrapped or
    dropped), non-integer values, a match mask with one empty row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-n_buckets - 3, n_buckets + 3, size=cap)
    if hot is not None:                 # one bucket holds most docs
        ids[rng.random(cap) < 0.8] = hot
    values = _wild(rng, cap)
    mask = rng.random((B, cap)) < p_match
    mask[0] = False
    return ids.astype(np.int32), mask, values


@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("B,cap,n_buckets,hot", [
    (3, 1000, 7, None), (4, 4096, 3, 1), (2, 3000, 500, None),
    (5, 777, 1, 0), (1, 64, 40, -2)])
def test_bucket_fold_is_at_add(square, B, cap, n_buckets, hot):
    """bucket_sums / bucket_sum_sq's plain version (the CPU path) against
    the reference's `.at[ids].add(mode="drop")`: ids out of range and
    negative, a hot bucket holding most docs, rows with no match."""
    ids, mask, values = _bucket_case(B * cap + n_buckets, B, cap,
                                     n_buckets, hot)
    fn = "bucket_sum_sq" if square else "bucket_sums"
    want = getattr(ref_aggs, fn)(jnp.asarray(ids), jnp.asarray(mask),
                                 jnp.asarray(values), n_buckets)
    got = getattr(port_aggs, fn)(_t(ids), _t(mask), _t(values), n_buckets)
    _assert_bits(got, want)
    _assert_bits(ordered.bucket_fold(_t(ids), _t(mask), _t(values),
                                     n_buckets, square), want)
    assert not got[0].any()


def test_bucket_fold_order_matters():
    """The case shows the order: a different order of the same adds (a
    reversed doc order) gives other bits, the fold the reference's."""
    ids, mask, values = _bucket_case(3, 4, 5000, 2, hot=0)
    want = ref_aggs.bucket_sums(jnp.asarray(ids), jnp.asarray(mask),
                                jnp.asarray(values), 2)
    rev = ordered.bucket_fold(_t(ids[::-1]), _t(mask[:, ::-1]),
                              _t(values[::-1]), 2)
    assert (_bits(rev) != _bits(want)).any()
    _assert_bits(ordered.bucket_fold(_t(ids), _t(mask), _t(values), 2), want)


# -- the slice: _msearch with float sum / avg sub-aggs, byte for byte ------

_MAPPING = {"properties": {**corpus.MAPPING["properties"],
                           "latency": {"type": "float"}}}


def _docs(n, seed, start):
    rng = np.random.default_rng(seed + 1000)
    lat = (rng.lognormal(3.0, 1.5, size=n) * 1.37).astype(np.float32)
    return [(did, {**d, "latency": float(lat[i])})
            for i, (did, d) in enumerate(corpus.make_docs(
                n, seed=seed, start=start, long_every=0))]


@pytest.fixture(scope="module")
def float_shards():
    out = []
    for s in range(2):
        docs = _docs(2500, 50 + s, 2500 * s)
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


_FLOAT_AGGS = {
    "by_status": {"terms": {"field": "status"},
                  "aggs": {"lat": {"sum": {"field": "latency"}},
                           "avg_lat": {"avg": {"field": "latency"}},
                           "bytes": {"sum": {"field": "size"}}}},
    "per_day": {"date_histogram": {"field": "@timestamp",
                                   "interval": "day"},
                "aggs": {"lat": {"sum": {"field": "latency"}}}},
    "lat_stats": {"stats": {"field": "latency"}},
}


def _float_bodies():
    rng = np.random.default_rng(9)
    words = corpus.head_terms(rng, 6)
    bodies = []
    for i in range(6):
        lo = int(rng.integers(100, 60_000))
        # a match query takes the doc-space sorted layout, a range-only
        # query the agg views (sorted-space masks)
        q = ({"match": {"message": words[i]}} if i % 2 == 0
             else {"range": {"size": {"gte": lo}}})
        bodies.append({"query": q, "aggs": _FLOAT_AGGS, "size": 0})
    return bodies


def _strip_took(x):
    if isinstance(x, dict):
        return {k: _strip_took(v) for k, v in x.items() if k != "took"}
    if isinstance(x, list):
        return [_strip_took(v) for v in x]
    return x


def test_msearch_float_sums_byte_equal(float_shards, monkeypatch):
    monkeypatch.setenv("ES_TPU_FUSED", "0")
    bodies = _float_bodies()
    merged = {}
    for side, (idx, parse, merge) in {
            "port": (0, parse_aggs, merge_shard_results),
            "ref": (1, ref_parse_aggs, ref_merge)}.items():
        per_shard = [pair[idx].msearch(bodies, with_partials=True)
                     for pair in float_shards]
        out = []
        for i, body in enumerate(bodies):
            resps = [shard[i] for shard in per_shard]
            out.append(merge(
                resps, agg_specs=parse(body.get("aggs")),
                shard_partials=[r.get("_agg_partials", {}) for r in resps],
                frm=0, size=0, descending=True, score_sort=True))
        merged[side] = _strip_took(out)
        # each shard's own response too (the per-segment partials)
        merged[side + "_shards"] = _strip_took(
            [pair[idx].msearch(bodies) for pair in float_shards])
    assert json.dumps(merged["port"], sort_keys=True) \
        == json.dumps(merged["ref"], sort_keys=True)
    assert json.dumps(merged["port_shards"], sort_keys=True) \
        == json.dumps(merged["ref_shards"], sort_keys=True)
    sums = [b["lat"]["value"] for r in merged["ref"]
            for b in r["aggregations"]["by_status"]["buckets"]]
    assert sums and all(s > 0 and s != round(s) for s in sums)
