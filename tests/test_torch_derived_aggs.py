"""Derived bucket aggs and the query DSL's mixes: the PyTorch port vs the
JAX reference, on the CPU.

The same seeded corpus (some docs without `body` / `size`) is searched
through both packages' ShardReaders:

* each derived kind (filter, filters keyed and anonymous, range,
  date_range, missing, global, top_hits, significant_terms), top-level
  and with sub-aggs (metric, terms, a derived agg inside a derived agg),
  on one shard, and over two shards through `with_partials` and
  `merge_shard_results` (the node's cross-shard reduce);
* significant_terms as a sub of terms, on one shard and over two shards
  (`apply_sig_subs` over both readers, as the node applies it);
* `_msearch` of a mixed batch of every query-DSL mix
  (`corpus.dsl_mixes`), with the fused engine on and off
  (`ES_TPU_FUSED=1/0`).

Tolerances: exact. Bucket keys, doc counts, sub-agg values (f32 sums in
XLA's order, ops/ordered.py), top_hits hits and JLH scores equal the
reference's, as do hits, totals and scores; the mixed batch's
function_score requests carry one unfiltered bare product per add
(exact, tests/test_torch_function_score.py).

The reference's msearch raises IndexError on a group of two or more
requests whose plan has no params (`exists` alone: its `_batch_size`
returns 1; ROADMAP Queue 3), so the reference answers the mixed batch
one request at a time (a request's response does not depend on its
batch).
"""

import copy
import json

import pytest
import torch

from elasticsearch_tpu.index.mapping import MapperService as RefMapper
from elasticsearch_tpu.index.segment import SegmentBuilder as RefBuilder
from elasticsearch_tpu.search import aggregations as ref_aggs
from elasticsearch_tpu.search.controller import \
    merge_shard_results as ref_merge
from elasticsearch_tpu.search.shard_searcher import ShardReader as RefReader

from elasticsearch_tpu_torch import corpus
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.search import aggregations as port_aggs
from elasticsearch_tpu_torch.search.controller import merge_shard_results
from elasticsearch_tpu_torch.search.shard_searcher import ShardReader

torch.set_num_threads(1)


def _docs(n, seed, start):
    docs = corpus.make_docs(n, seed=seed, start=start, long_every=200)
    return [(d, {k: v for k, v in doc.items()
                 if not ((k == "body" and int(d) % 7 == 0)
                         or (k == "size" and int(d) % 11 == 0))})
            for d, doc in docs]


def _shard(docs, shard_id):
    out = []
    for mapper_cls, builder_cls, reader_cls, kw in (
            (MapperService, SegmentBuilder, ShardReader, {"device": "cpu"}),
            (RefMapper, RefBuilder, RefReader, {})):
        svc = mapper_cls(mapping=corpus.MAPPING)
        b = builder_cls()
        for did, d in docs:
            b.add(svc.parse(did, d))
        out.append(reader_cls("logs", [b.build(f"s{shard_id}")], {}, svc,
                              shard_id=shard_id, **kw))
    return out


@pytest.fixture(scope="module")
def one_shard():
    return _shard(_docs(1000, 42, 0), 0)


@pytest.fixture(scope="module")
def two_shards():
    return [_shard(_docs(500, 42 + s, 500 * s), s) for s in range(2)]


def _same(a, b):
    assert json.dumps(_strip(a), sort_keys=True) \
        == json.dumps(_strip(b), sort_keys=True)


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k != "took"}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


Q = {"match": {"message": "get html"}}
AGGS = {
    "filter": {"f": {"filter": {"range": {"size": {"gte": 30000}}},
                     "aggs": {"s": {"sum": {"field": "size"}},
                              "a": {"avg": {"field": "size"}}}}},
    "filters_keyed": {"f": {"filters": {"filters": {
        "ok": {"term": {"status": "200"}},
        "nf": {"term": {"status": "404"}}}},
        "aggs": {"t": {"terms": {"field": "status"}}}}},
    "filters_list": {"f": {"filters": {"filters": [
        {"match": {"message": "post"}}, {"exists": {"field": "body"}}]},
        "aggs": {"st": {"stats": {"field": "size"}}}}},
    "range": {"r": {"range": {"field": "size", "ranges": [
        {"to": 1000}, {"from": 1000, "to": 50000}, {"from": 50000},
        {"key": "mid", "from": 20000, "to": 30000}]},
        "aggs": {"t": {"terms": {"field": "status"}},
                 "h": {"histogram": {"field": "size", "interval": 25000}}}}},
    "date_range": {"d": {"date_range": {"field": "@timestamp", "ranges": [
        {"to": "2015-01-10"}, {"from": "2015-01-10", "to": "2015-01-20"},
        {"from": "2015-01-20"}]},
        "aggs": {"a": {"avg": {"field": "size"}}}}},
    "missing": {"m": {"missing": {"field": "body"},
                      "aggs": {"a": {"avg": {"field": "size"}}}},
                "m2": {"missing": {"field": "size"}}},
    "global": {"g": {"global": {},
                     "aggs": {"t": {"terms": {"field": "status"}},
                              "dh": {"date_histogram": {
                                  "field": "@timestamp",
                                  "interval": "week"}}}}},
    "top_hits": {"th": {"top_hits": {"size": 3}},
                 "th_src": {"top_hits": {"size": 2, "_source": ["status"]}}},
    "significant_terms": {"sig": {"significant_terms": {
        "field": "status", "min_doc_count": 1}},
        "sig_msg": {"significant_terms": {"field": "message", "size": 5}}},
    "nested_derived": {"f": {"filter": {"exists": {"field": "size"}},
                             "aggs": {"r": {"range": {
                                 "field": "size", "ranges": [
                                     {"to": 40000}, {"from": 40000}]},
                                 "aggs": {"a": {"avg": {"field": "size"}}}},
                                 "th": {"top_hits": {"size": 1}}}}},
    "sig_under_terms": {"t": {"terms": {"field": "status"}, "aggs": {
        "sig": {"significant_terms": {"field": "message",
                                      "min_doc_count": 2}},
        "a": {"avg": {"field": "size"}}}}},
}


@pytest.mark.parametrize("name", sorted(AGGS))
@pytest.mark.parametrize("query", ["match", "match_all"])
def test_derived_one_shard(one_shard, name, query):
    port, ref = one_shard
    body = {"query": Q if query == "match" else {"match_all": {}},
            "size": 5, "aggs": AGGS[name]}
    want = ref.msearch([copy.deepcopy(body)])
    got = port.msearch([copy.deepcopy(body)])
    _same(got, want)
    assert want[0]["aggregations"]


def _merged(readers, body, aggs_mod, merge, which):
    resps = [r[which].msearch([copy.deepcopy(body)], with_partials=True)[0]
             for r in readers]
    specs = aggs_mod.parse_aggs(body.get("aggs"))
    out = merge(resps, agg_specs=specs,
                shard_partials=[r.pop("_agg_partials", {}) for r in resps],
                frm=0, size=body.get("size", 10))
    search_ids = (lambda q: {h["_id"] for h in merge(
        [r[which].msearch([{"query": q, "size": 10_000,
                            "_source": False}])[0] for r in readers],
        frm=0, size=10_000)["hits"]["hits"]})
    aggs_mod.apply_sig_subs(specs, out.get("aggregations", {}),
                            [r[which] for r in readers],
                            raw_query=body.get("query"),
                            search_ids=search_ids)
    return out


@pytest.mark.parametrize("name", sorted(AGGS))
def test_derived_two_shards_merged(two_shards, name):
    body = {"query": Q, "size": 5, "aggs": AGGS[name]}
    got = _merged(two_shards, body, port_aggs, merge_shard_results, 0)
    want = _merged(two_shards, body, ref_aggs, ref_merge, 1)
    _same(got, want)
    assert want["aggregations"]


@pytest.mark.parametrize("fused", ["0", "1"])
def test_mixed_dsl_batch(one_shard, monkeypatch, fused):
    monkeypatch.setenv("ES_TPU_FUSED", fused)
    port, ref = one_shard
    mixes = corpus.dsl_mixes(4, seed=21, n_ids=1000)
    bodies = [b for i in range(4) for name in corpus.DSL_MIXES
              for b in mixes[name][i:i + 1]]
    got = port.msearch(copy.deepcopy(bodies))
    want = [ref.msearch([copy.deepcopy(b)])[0] for b in bodies]
    _same(got, want)
    assert sum(r["hits"]["total"] for r in want) > 0


def test_derived_kinds_parse_and_unported_raise():
    specs = port_aggs.parse_aggs({f"{n}_{k}": v for n, a in AGGS.items()
                                  for k, v in a.items()})
    # the scope shifts (nested, reverse_nested, children) need a nested
    # or join mapping: tests/test_torch_join.py serves them
    assert {s.kind for s in specs} >= (set(port_aggs.DERIVED_KINDS)
                                       - set(port_aggs.SCOPE_KINDS))
    for kind in ("geo_centroid", "geo_bounds", "geohash_grid"):
        with pytest.raises(NotImplementedError):
            port_aggs.parse_aggs({"x": {kind: {"field": "size"}}})
    # ported since: the device metric aggs and scripted_metric, and the
    # scope shifts
    for kind, conf in (("percentiles", {"field": "size"}),
                       ("cardinality", {"field": "status"}),
                       ("scripted_metric", {"map_script": "1"}),
                       ("nested", {"path": "comments"}),
                       ("reverse_nested", {}),
                       ("children", {"type": "answer"})):
        assert port_aggs.parse_aggs({"x": {kind: conf}})[0].kind == kind
