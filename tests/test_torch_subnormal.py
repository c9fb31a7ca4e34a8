"""Subnormal f32 values in the PyTorch port, on the CPU, against the JAX
package bit for bit.

XLA's CPU runtime (the reference's) computes with subnormals flushed: an
f32 add, multiply or compare reads a subnormal as a zero of its sign and
a subnormal result becomes a zero of its sign, while a pure move
(`where`, a gather, `lax.top_k`'s values, a one-element cumsum) keeps
it. The port flushes where XLA does (`ops/ordered.ftz`; the value
columns of `search/executor.device_arrays`, range and term bounds at
bind) and keeps the stored values for field sorts.

The plain functions of `ops/ordered` and `ops/aggs.masked_stats` are
held against the JAX expressions themselves on seeded rows of
subnormals, signed zeros and normal values whose sums pass through the
subnormal range. `_msearch` over a two-shard index with a `double` and a
`float` field holding such values (range filters with subnormal bounds,
stats / extended_stats / min / max / sum / avg, terms -> stats,
histogram -> sum, field sorts whose hits carry subnormal sort values)
gives the reference's responses, JSON dumps equal.

Tolerance: none (bit equality).
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.index.mapping import MapperService as RefMapper
from elasticsearch_tpu.index.segment import SegmentBuilder as RefBuilder
from elasticsearch_tpu.ops import aggs as ref_aggs
from elasticsearch_tpu.search.shard_searcher import ShardReader as RefReader

from elasticsearch_tpu_torch import corpus
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.ops import aggs as port_aggs
from elasticsearch_tpu_torch.ops import ordered
from elasticsearch_tpu_torch.search.shard_searcher import ShardReader

torch.set_num_threads(1)

# subnormals of both signs (1e-38 and 9.9e-39 are subnormal in f32, their
# difference too), signed zeros, normal values just above 2^-126 whose
# sums cancel into the subnormal range, and ordinary values
SPECIAL = np.array([1e-40, -1e-40, 1e-45, -1e-45, 1e-38, 9.9e-39, -1e-38,
                    -9.9e-39, 3e-39, -2e-39, 0.0, -0.0, 1.5e-38, -1.4e-38,
                    1.2e-38, -1.19e-38, 1e-20, -1e-20, 1.5, -2.25],
                   np.float32)


def _bits(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


def _row(rng, shape):
    return rng.choice(SPECIAL, size=shape).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n", [1, 2, 16, 17, 40, 300])
def test_xla_cumsum_and_block_sum_flush(seed, n):
    rng = np.random.default_rng(seed * 100 + n)
    x = _row(rng, (3, n))
    assert np.array_equal(_bits(ordered.xla_cumsum(torch.from_numpy(x))),
                          _bits(jnp.cumsum(jnp.asarray(x), axis=-1)))
    assert np.array_equal(_bits(ordered.xla_block_sum(torch.from_numpy(x))),
                          _bits(jnp.asarray(x).sum(-1)))


def test_subnormal_intermediate_sums_flush():
    """Normal inputs whose running sums are subnormal: each add's result
    flushes (1.5e-38 - 1.4e-38 = 1e-39 -> +0.0)."""
    x = np.array([[1.5e-38, -1.4e-38, 1.2e-38, -1.19e-38] * 8],
                 np.float32)
    ref_cs = jnp.cumsum(jnp.asarray(x), axis=-1)
    assert np.array_equal(_bits(ordered.xla_cumsum(torch.from_numpy(x))),
                          _bits(ref_cs))
    assert np.array_equal(_bits(ordered.xla_block_sum(torch.from_numpy(x))),
                          _bits(jnp.asarray(x).sum(-1)))
    assert not np.any((np.abs(np.asarray(ref_cs)) > 0)
                      & (np.abs(np.asarray(ref_cs)) < 2.0 ** -126))


@pytest.mark.parametrize("seed", range(6))
def test_bucket_functions_flush(seed):
    rng = np.random.default_rng(seed)
    cap, nb, B = 700, 5, 3
    ids = rng.integers(-1, nb + 1, size=cap).astype(np.int32)
    vals = _row(rng, cap)
    mask = rng.random((B, cap)) < 0.7
    t = {k: torch.from_numpy(np.ascontiguousarray(a))
         for k, a in (("ids", ids), ("vals", vals), ("mask", mask))}
    j = {k: jnp.asarray(a) for k, a in (("ids", ids), ("vals", vals),
                                         ("mask", mask))}
    pairs = [
        (ordered.bucket_fold(t["ids"], t["mask"], t["vals"], nb),
         ref_aggs.bucket_sums(j["ids"], j["mask"], j["vals"], nb)),
        (ordered.bucket_fold(t["ids"], t["mask"], t["vals"], nb, True),
         ref_aggs.bucket_sum_sq(j["ids"], j["mask"], j["vals"], nb)),
        (ordered.bucket_extreme(t["ids"], t["mask"], t["vals"], nb),
         ref_aggs.bucket_min(j["ids"], j["mask"], j["vals"], nb)),
        (ordered.bucket_extreme(t["ids"], t["mask"], t["vals"], nb, True),
         ref_aggs.bucket_max(j["ids"], j["mask"], j["vals"], nb)),
    ]
    for port, ref in pairs:
        assert np.array_equal(_bits(port), _bits(ref))


@pytest.mark.parametrize("seed", range(6))
def test_masked_stats_flush(seed):
    rng = np.random.default_rng(50 + seed)
    cap, B = 500, 4
    vals = _row(rng, cap)
    exists = rng.random(cap) < 0.9
    mask = rng.random((B, cap)) < 0.5
    mask[0] = False
    # a row of subnormals and zeros only: its min / max are signed zeros
    only = np.isin(vals, SPECIAL[:12])
    mask[1] = only & (rng.random(cap) < 0.5)
    port = port_aggs.masked_stats(torch.from_numpy(vals),
                                  torch.from_numpy(exists),
                                  torch.from_numpy(mask))
    ref = ref_aggs.masked_stats(jnp.asarray(vals), jnp.asarray(exists),
                                jnp.asarray(mask))
    for k in ("count", "sum", "sum_sq", "min", "max"):
        assert np.array_equal(_bits(port[k]), _bits(ref[k])), k


def test_ftz_keeps_sign_nan_and_infinities():
    x = torch.tensor([1e-45, -1e-45, 1e-38, -0.0, float("nan"),
                      float("inf"), -float("inf"), 1.2e-38],
                     dtype=torch.float32)
    y = ordered.ftz(x)
    assert _bits(y)[:4].tolist() == [0, 0x80000000, 0, 0x80000000]
    assert torch.isnan(y[4]) and torch.equal(y[5:], x[5:])
    assert np.array_equal(ordered.ftz_np(x.numpy())[:3].view(np.uint32),
                          np.array([0, 0x80000000, 0], np.uint32))


# -- the slice: _msearch byte for byte -----------------------------------

_MAPPING = {"properties": {**corpus.MAPPING["properties"],
                           "dval": {"type": "double"},
                           "fval": {"type": "float"}}}


def _docs(n, seed, start):
    rng = np.random.default_rng(seed)
    out = []
    for did, d in corpus.make_docs(n, seed=seed, start=start, long_every=0):
        d = dict(d)
        if rng.random() < 0.85:
            d["dval"] = float(rng.choice(SPECIAL))
        if rng.random() < 0.85:
            d["fval"] = float(rng.choice(SPECIAL))
        out.append((did, d))
    return out


@pytest.fixture(scope="module")
def shards():
    out = []
    for s in range(2):
        docs = _docs(600, 70 + s, 600 * s)
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


def _aggs(f):
    return {
        "st": {"stats": {"field": f}},
        "ex": {"extended_stats": {"field": f}},
        "mn": {"min": {"field": f}}, "mx": {"max": {"field": f}},
        "sm": {"sum": {"field": f}}, "av": {"avg": {"field": f}},
        "by_status": {"terms": {"field": "status"},
                      "aggs": {"st": {"stats": {"field": f}},
                               "ex": {"extended_stats": {"field": f}}}},
        "by_size": {"histogram": {"field": "size", "interval": 20_000},
                    "aggs": {"s": {"sum": {"field": f}},
                             "mn": {"min": {"field": f}}}},
    }


def bodies():
    out = []
    for f in ("dval", "fval"):
        aggs = _aggs(f)
        out += [
            {"query": {"range": {f: {"gte": 1e-45}}}, "size": 0,
             "aggs": aggs},
            {"query": {"range": {f: {"lt": 1e-39}}}, "size": 0},
            {"query": {"range": {f: {"gte": 1e-45, "lt": 1e-39}}},
             "size": 30, "sort": [{f: "asc"}]},
            {"query": {"range": {f: {"gt": -1e-45}}}, "size": 0},
            {"query": {"match_all": {}}, "size": 0, "aggs": aggs},
            {"query": {"match": {"message": "images"}}, "size": 0,
             "aggs": aggs},
            {"query": {"match_all": {}}, "size": 300, "sort": [{f: "asc"}]},
            {"query": {"match_all": {}}, "size": 300,
             "sort": [{f: "desc"}]},
            {"query": {"bool": {"must": [{"match": {"message": "images"}}],
                                "filter": [{"range": {f: {"gte": 1e-45}}}]}},
             "size": 10},
            {"query": {"bool": {"must": [{"match": {"message": "images"}}],
                                "filter": [{"range": {f: {"lt": 1e-39}}}]}},
             "size": 10, "aggs": aggs},
        ]
    return out


def _strip_took(x):
    if isinstance(x, dict):
        return {k: _strip_took(v) for k, v in x.items() if k != "took"}
    if isinstance(x, list):
        return [_strip_took(v) for v in x]
    return x


@pytest.mark.parametrize("fused", ["0", "1"])
def test_msearch_with_subnormals_byte_equal(shards, monkeypatch, fused):
    monkeypatch.setenv("ES_TPU_FUSED", fused)
    bs = bodies()
    got = {side: [_strip_took(pair[idx].msearch(bs)) for pair in shards]
           for side, idx in (("port", 0), ("ref", 1))}
    for s in range(len(shards)):
        for i, body in enumerate(bs):
            assert json.dumps(got["port"][s][i], sort_keys=True) \
                == json.dumps(got["ref"][s][i], sort_keys=True), (s, body)
    # the inputs reach what they are meant to: subnormal sort values on
    # hits, and a range over them that flushing changes
    sort_vals = [h["sort"][0] for shard in got["ref"] for r in shard
                 for h in r["hits"]["hits"] if h.get("sort")]
    assert any(v is not None and 0 < abs(v) < 2.0 ** -126
               for v in sort_vals)
    stored = np.array([d["fval"] for _did, d in _docs(600, 70, 0)
                       if "fval" in d], np.float32)
    flushed = int(np.sum(ordered.ftz_np(stored) >= 0))
    assert got["ref"][0][13]["hits"]["total"] == flushed \
        != int(np.sum(stored > np.float32(-1e-45)))
