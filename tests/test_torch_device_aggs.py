"""percentiles, percentile_ranks and cardinality: the port vs the reference.

On a base plus a delta segment (2 segments, a few delta docs deleted),
through both packages' `ShardReader.msearch`:
* percentiles / percentile_ranks on the sorted view (a range query), the
  value-sorted column (a match query) and a multi-valued column, top
  level and under derived bucket aggs: the per-shard bins (`points` of
  the partials) and the responses equal the reference's;
* cardinality exact (a keyword column, single- and multi-valued) and the
  HLL++ sketch (`precision_threshold` below the term count): the
  registers of the partials, the estimates and the responses equal;
* under `terms` both packages refuse these kinds with the same error;
* a batch whose requests ask for different percents: each of the port's
  responses equals the reference's for that request alone (the
  reference's batch-mates take the first request's percents; ROADMAP
  Queue 3).
"""

import copy
import json

import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.mapping import MapperService as RefMapper
from elasticsearch_tpu.index.segment import SegmentBuilder as RefBuilder
from elasticsearch_tpu.index.segment import (
    pad_delta_shapes as ref_pad_delta_shapes)
from elasticsearch_tpu.search.shard_searcher import ShardReader as RefReader
from elasticsearch_tpu.utils.errors import SearchParseError as RefParseError

from elasticsearch_tpu_torch import corpus
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import (SegmentBuilder,
                                                   pad_delta_shapes)
from elasticsearch_tpu_torch.ops import hll
from elasticsearch_tpu_torch.search.shard_searcher import ShardReader
from elasticsearch_tpu_torch.utils.errors import SearchParseError

torch.set_num_threads(1)

N_BASE, N_DELTA = 3000, 300
DELETED = (5, 50, 250)
MAPPING = {"properties": {**corpus.MAPPING["properties"],
                          "client": {"type": "keyword"},
                          "tags": {"type": "keyword"},
                          "sizes": {"type": "long"}}}


def _docs():
    rng = np.random.default_rng(21)
    out = []
    for i, (did, d) in enumerate(corpus.make_docs(N_BASE + N_DELTA,
                                                  seed=42, long_every=300)):
        d = dict(d)
        d["client"] = f"c{int(rng.integers(0, 900))}"
        if i % 3:
            d["tags"] = [f"t{int(x)}" for x in rng.integers(0, 40, size=2)]
        if i % 4:
            d["sizes"] = [int(x) for x in rng.integers(0, 50_000, size=1 + i % 3)]
        out.append((did, d))
    return out


def _pair(port: bool):
    svc = (MapperService if port else RefMapper)(mapping=MAPPING)
    builder = SegmentBuilder if port else RefBuilder
    docs = _docs()
    segs = []
    for seg_id, part in (("base", docs[:N_BASE]),
                         ("delta0", docs[N_BASE:])):
        b = builder()
        for did, d in part:
            b.add(svc.parse(did, d))
        segs.append(b.build(seg_id))
    base, delta = segs
    delta.delta_parent = base.cache_key()
    delta.delta_epoch = 0
    (pad_delta_shapes if port else ref_pad_delta_shapes)(delta)
    live = delta.primary_mask().copy()
    live[list(DELETED)] = False
    if port:
        return ShardReader("logs", [base, delta], {delta.seg_id: live}, svc,
                           device="cpu")
    return RefReader("logs", [base, delta], {delta.seg_id: live}, svc)


@pytest.fixture(scope="module")
def readers():
    return _pair(True), _pair(False)


def _strip(r):
    return {k: v for k, v in r.items() if k != "took"}


def _parts(resps):
    """The partials as JSON-able values (registers as lists)."""
    def norm(v):
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, dict):
            return {str(k): norm(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [norm(x) for x in v]
        return v
    return [norm(r.get("_agg_partials", {})) for r in resps]


def _equal(readers, bodies, partials=True):
    port, ref = readers
    got = [_strip(r) for r in port.msearch(copy.deepcopy(bodies))]
    want = [_strip(r) for r in ref.msearch(copy.deepcopy(bodies))]
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    if partials:
        gp = _parts(port.msearch(copy.deepcopy(bodies), with_partials=True))
        wp = _parts(ref.msearch(copy.deepcopy(bodies), with_partials=True))
        assert json.dumps(gp, sort_keys=True) == json.dumps(wp,
                                                            sort_keys=True)
    return got


PCTL = {"p": {"percentiles": {"field": "size"}},
        "p3": {"percentiles": {"field": "size", "percents": [1, 50, 99.9]}},
        "r": {"percentile_ranks": {"field": "size",
                                   "values": [1000, 50_000, 99_000]}}}
QUERIES = {
    "view_range": {"range": {"size": {"gte": 20_000, "lte": 80_000}}},
    "view_term": {"term": {"status": "404"}},
    "sorted_match": {"match": {"message": "images"}},
    "all": {"match_all": {}},
}


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_percentiles_paths_equal_reference(readers, query):
    got = _equal(readers, [{"query": QUERIES[query], "size": 0,
                            "aggs": PCTL}])
    assert got[0]["aggregations"]["p"]["values"]["50.0"] is not None


def test_percentiles_multi_valued_equal_reference(readers):
    _equal(readers, [{"query": q, "size": 0, "aggs": {
        "p": {"percentiles": {"field": "sizes"}},
        "r": {"percentile_ranks": {"field": "sizes",
                                   "values": [100, 25_000]}}}}
        for q in QUERIES.values()])


def test_percentiles_under_derived_aggs_equal_reference(readers):
    _equal(readers, [{"query": {"match": {"message": "french"}}, "size": 0,
                      "aggs": {"st": {"filters": {"filters": {
                          s: {"term": {"status": s}}
                          for s in ("200", "404", "500")}}, "aggs": PCTL},
                          "sz": {"range": {"field": "size", "ranges": [
                              {"to": 30_000}, {"from": 30_000}]},
                              "aggs": {"pm": {"percentiles": {
                                  "field": "sizes"}}}}}}])


def test_percentiles_of_missing_and_empty(readers):
    _equal(readers, [
        {"size": 0, "aggs": {"p": {"percentiles": {"field": "nosuch"}},
                             "r": {"percentile_ranks": {
                                 "field": "nosuch", "values": [1]}}}},
        {"query": {"term": {"status": "nosuch"}}, "size": 0,
         "aggs": PCTL}])


CARD = {"status_n": {"cardinality": {"field": "status"}},
        "client_n": {"cardinality": {"field": "client"}},
        "tags_n": {"cardinality": {"field": "tags"}},
        "client_hll": {"cardinality": {"field": "client",
                                       "precision_threshold": 100}},
        "tags_hll": {"cardinality": {"field": "tags",
                                     "precision_threshold": 10}},
        "status_hll": {"cardinality": {"field": "status",
                                       "precision_threshold": 1}}}


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_cardinality_exact_and_hll_equal_reference(readers, query):
    got = _equal(readers, [{"query": QUERIES[query], "size": 0,
                            "aggs": CARD}])
    port, _ref = readers
    parts = port.msearch([{"query": QUERIES[query], "size": 0,
                           "aggs": CARD}], with_partials=True)[0]
    regs = np.asarray(parts["_agg_partials"]["client_hll"]["hll"])
    assert regs.shape == (hll.M,) and regs.max() >= 1
    aggs = got[0]["aggregations"]
    assert aggs["status_n"]["value"] <= 3
    # the sketch estimates the exact count within a few percent
    exact, est = aggs["client_n"]["value"], aggs["client_hll"]["value"]
    assert abs(est - exact) <= 0.05 * exact + 2


def test_cardinality_under_derived_aggs_equal_reference(readers):
    _equal(readers, [{"size": 0, "aggs": {"days": {"date_range": {
        "field": "@timestamp", "ranges": [
            {"from": "2015-01-03", "to": "2015-01-04"},
            {"from": "2015-01-04", "to": "2015-01-05"}]},
        "aggs": {**CARD, **PCTL}}}}])


def test_hll_registers_and_estimate_equal_reference():
    """The blake2b term hash, the register / rank split and the estimate
    of ops/hll against the reference's module."""
    from elasticsearch_tpu.ops import hll as ref_hll
    terms = [f"term-{i}" for i in range(5000)] + ["", "é", "\U0001f600"]
    reg, rank = hll.term_registers(terms, memo=False)
    r_reg, r_rank = ref_hll.term_registers(terms, memo=False)
    assert np.array_equal(reg, r_reg) and np.array_equal(rank, r_rank)
    regs = np.zeros(hll.M)
    np.maximum.at(regs, reg, rank)
    assert hll.estimate(regs) == ref_hll.estimate(regs)
    assert hll.estimate(np.zeros(hll.M)) == ref_hll.estimate(
        np.zeros(ref_hll.M))


@pytest.mark.parametrize("kind", ["percentiles", "cardinality"])
def test_under_terms_refused_like_reference(readers, kind):
    body = {"size": 0, "aggs": {"t": {"terms": {"field": "status"},
                                      "aggs": {"x": {kind: {
                                          "field": "size"}}}}}}
    port, ref = readers
    msgs = []
    for r, exc in ((port, SearchParseError), (ref, RefParseError)):
        with pytest.raises(exc) as e:
            r.msearch([copy.deepcopy(body)])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_batch_with_different_percents(readers):
    """Each request of a batch gets its own percents, values and
    precision_threshold: the port's batched responses equal the
    reference's one request at a time. The reference's own batch hands
    every request the first one's (its plan key leaves them out)."""
    bodies = [{"query": {"range": {"size": {"gte": lo}}}, "size": 0,
               "aggs": {"r": {"percentile_ranks": {
                   "field": "size", "values": [lo, lo + 1000]}},
                   "c": {"cardinality": {"field": "client",
                                         "precision_threshold": th}}}}
              for lo, th in ((1000, 10), (40_000, 5000), (70_000, 10))]
    port, ref = readers
    got = [_strip(r) for r in port.msearch(copy.deepcopy(bodies))]
    alone = [_strip(ref.msearch([copy.deepcopy(b)])[0]) for b in bodies]
    assert json.dumps(got, sort_keys=True) == json.dumps(alone,
                                                         sort_keys=True)
    batched = [_strip(r) for r in ref.msearch(copy.deepcopy(bodies))]
    assert list(batched[1]["aggregations"]["r"]["values"]) == \
        list(alone[0]["aggregations"]["r"]["values"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pctl_edges_equal_xla(seed):
    """The bins' inner edges lo + width * [1 .. n-1] as XLA compiles the
    reference's expression (`_pctl_view`, the sorted-column path): the
    product contracted into the add, one FMA an edge."""
    import jax
    import jax.numpy as jnp
    from elasticsearch_tpu_torch.search import executor as ex
    rng = np.random.default_rng(seed)
    for lo, width in zip(rng.uniform(-1e6, 1e6, 16).astype(np.float32),
                         rng.uniform(1e-3, 1e3, 16).astype(np.float32)):
        want = np.asarray(jax.jit(lambda a, w: a.astype(jnp.float32)
                                  + w.astype(jnp.float32)
                                  * jnp.arange(1, 2048, dtype=jnp.float32))(
            lo, width))
        got = ex._pctl_edges(torch.tensor(lo), torch.tensor(width),
                             2048).numpy()
        assert got[0] == -np.inf and got[-1] == np.inf
        assert np.array_equal(got[1:-1].view(np.int32), want.view(np.int32))
