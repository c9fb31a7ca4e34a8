"""The whole slice: `_msearch` through the PyTorch port vs the JAX
reference, on the CPU.

Both packages build the same seeded http_logs-like corpus, and the same
requests go through the reference `ShardReader.msearch` in its unfused
configuration (`ES_TPU_FUSED=0`) and through the port's
`ShardReader(device="cpu")`: the five request mixes of chip_smoke.py,
field sorts and paging on one shard, and a 2-shard `merge_shard_results`
reduce. On the CPU the port's kernel wrappers run their plain versions.

Tolerances: hit ids, order, totals, scores, agg keys and counts exact
(the reference's CPU programs contract no mul+add into an FMA on this
path, so scores are bit-identical); `sum`/`avg` agg values exact too
(the port adds f32 agg sums in XLA's order, ops/ordered.py).
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.mapping import MapperService as RefMapper
from elasticsearch_tpu.index.segment import SegmentBuilder as RefBuilder
from elasticsearch_tpu.search.aggregations import parse_aggs as ref_parse_aggs
from elasticsearch_tpu.search.controller import \
    merge_shard_results as ref_merge
from elasticsearch_tpu.search.shard_searcher import ShardReader as RefReader

from elasticsearch_tpu_torch import corpus
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.search.aggregations import parse_aggs
from elasticsearch_tpu_torch.search.controller import merge_shard_results
from elasticsearch_tpu_torch.search.shard_searcher import ShardReader

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _unfused(monkeypatch):
    monkeypatch.setenv("ES_TPU_FUSED", "0")


def _shard(docs, shard_id=0):
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


def _with_matching_prefixes(bodies, reader):
    # a batch of several requests that all bind to "match nothing" trips
    # the reference (see ROADMAP Queue 3), so keep prefixes that expand
    terms = reader.segments[0].text["message"].terms
    return [b for b in bodies
            if any(t.startswith(b["query"]["prefix"]["message"])
                   for t in terms)]


@pytest.mark.parametrize("mix", ["match", "bool_aggs", "prefix",
                                 "term_body", "aggs_only"])
def test_request_mix_matches_reference(one_shard, mix):
    port, ref = one_shard
    bodies = corpus.request_mixes(12, seed=7)[mix]
    if mix == "prefix":
        bodies = _with_matching_prefixes(bodies, port)
        assert len(bodies) >= 4
    got = port.msearch(bodies)
    want = ref.msearch(bodies)
    _assert_same(got, want)
    assert any(r["hits"]["total"] > 0 for r in want)
    if mix in ("match", "bool_aggs", "prefix", "term_body"):
        assert any(r["hits"]["hits"] for r in want)


def test_sorts_paging_and_mixed_groups(one_shard):
    port, ref = one_shard
    bodies = [
        {"query": {"match": {"message": "images french"}}, "from": 3,
         "size": 7},
        {"query": {"match_all": {}}, "sort": [{"size": "desc"}], "size": 5},
        {"query": {"match": {"message": "news"}},
         "sort": [{"status": {"order": "asc"}}], "size": 6},
        {"query": {"constant_score": {"filter": {"term": {"status": "404"}},
                                      "boost": 2.0}}, "size": 4},
        {"query": {"bool": {"should": [{"term": {"message": "images"}},
                                       {"term": {"message": "sport"}}],
                            "must_not": [{"range": {"size": {"lt": 5000}}}],
                            "minimum_should_match": 1}},
         "aggs": {"sizes": {"histogram": {"field": "size",
                                          "interval": 25000},
                            "aggs": {"mx": {"max": {"field": "size"}}}},
                  "st": {"stats": {"field": "size"}}}},
        {"query": {"match": {"message": {"query": "images french sport",
                                         "operator": "and"}}}},
        {"query": {"range": {"@timestamp": {"gte": "2015-01-10",
                                            "lt": "2015-01-12"}}},
         "size": 0, "aggs": {"n": {"value_count": {"field": "status"}}}},
    ]
    _assert_same(port.msearch(bodies), ref.msearch(bodies))


_SORTED = [
    {"query": {"match": {"message": "images"}},
     "sort": [{"status": {"order": "desc"}}], "size": 8},
    {"query": {"match_all": {}}, "sort": [{"size": {"order": "asc"}}],
     "size": 6},
]


@pytest.mark.parametrize("mix", ["match", "bool_aggs", "aggs_only",
                                 "sorted"])
def test_two_shard_reduce_matches_reference(two_shards, mix):
    bodies = (_SORTED if mix == "sorted"
              else corpus.request_mixes(6, seed=11)[mix])
    merged = {}
    for side, (reader_idx, parse, merge) in {
            "port": (0, parse_aggs, merge_shard_results),
            "ref": (1, ref_parse_aggs, ref_merge)}.items():
        per_shard = [pair[reader_idx].msearch(bodies, with_partials=True)
                     for pair in two_shards]
        out = []
        for i, body in enumerate(bodies):
            resps = [shard[i] for shard in per_shard]
            specs = parse(body.get("aggs"))
            sort = body.get("sort")
            out.append(merge(
                resps, agg_specs=specs,
                shard_partials=[r.get("_agg_partials", {}) for r in resps],
                frm=body.get("from", 0), size=body.get("size", 10),
                descending=(sort is None or next(iter(
                    sort[0].values()))["order"] == "desc"),
                score_sort=sort is None))
        merged[side] = out
    _assert_same(merged["port"], merged["ref"])
    totals = [r["hits"]["total"] for r in merged["ref"]]
    assert sum(t > 0 for t in totals) >= len(totals) // 2
    # hits from both shards interleave in the merged top-k
    if mix == "match":
        ids = {int(h["_id"]) for r in merged["ref"] for h in r["hits"]["hits"]}
        assert min(ids) < 700 <= max(ids)
    assert np.isfinite([h["_score"] for r in merged["port"]
                        for h in r["hits"]["hits"]]).all()
