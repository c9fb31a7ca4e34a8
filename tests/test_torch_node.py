"""The port's Node against the reference's Node, on the CPU.

Both nodes take the same seeded documents through `create_index` (2
shards), `bulk`, `refresh`, updates and deletes, and force-merge, in the
legacy and the streaming delta mode; `search`, `msearch` (an item naming
a missing index included: a per-item error) and `count` give the
reference's responses after every step, JSON dumps equal with `took`
stripped.

Then the port alone: request-cache hits with `index.cache.query.enable`
and their invalidation by a delta epoch and by compaction (responses
unchanged), the dispatch scheduler's counters (coalesced queries,
pipeline depth), a tripped fielddata breaker (a shard failure, not a
crash), the fielddata holds of segments that compaction replaced being
released, and `Node(device=None)` raising without CUDA.
"""

import copy
import gc
import json

import pytest
import torch

from elasticsearch_tpu.node import Node as RefNode

from elasticsearch_tpu_torch import corpus
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.utils.breaker import breaker_service

torch.set_num_threads(1)

N_DOCS = 600
MIXES = ("match", "bool_aggs", "prefix", "aggs_only", "match_range_aggs",
         "count_match", "stats_aggs")


def _docs():
    return list(corpus.make_docs(N_DOCS, seed=21, start=0, long_every=100))


def _bodies():
    mixes = corpus.request_mixes(3, seed=9, n_docs=N_DOCS, doc_seed=21)
    return [b for m in MIXES for b in copy.deepcopy(mixes[m])]


def _strip_took(x):
    if isinstance(x, dict):
        return {k: _strip_took(v) for k, v in x.items() if k != "took"}
    if isinstance(x, list):
        return [_strip_took(v) for v in x]
    return x


def _same(a, b):
    assert json.dumps(_strip_took(a), sort_keys=True) \
        == json.dumps(_strip_took(b), sort_keys=True)


def _index_settings(delta: bool) -> dict:
    return {"number_of_shards": 2, "number_of_replicas": 0,
            "index.streaming.delta": delta,
            "index.delta.min_compact_docs": 32}


def _bulk_ops(docs):
    return [("index", {"_index": "logs", "_id": did, "doc": d})
            for did, d in docs]


@pytest.mark.parametrize("delta", [False, True], ids=["legacy", "delta"])
def test_node_steps_equal_reference(delta):
    docs = _docs()
    bodies = _bodies()
    nodes = [Node({"node.name": "n0"}, device="cpu"),
             RefNode({"node.name": "n0"})]
    try:
        for n in nodes:
            n.create_index("logs", _index_settings(delta), corpus.MAPPING)

        def check():
            # the reference one item at a time in msearch: two requests
            # of one group binding to nothing on every segment trip it
            # (ROADMAP Queue 3, faults of the reference)
            port = nodes[0].msearch([("logs", b) for b in bodies]
                                    + [("missing", bodies[0])])
            ref = {"responses": [
                nodes[1].msearch([("logs", b)])["responses"][0]
                for b in bodies] + nodes[1].msearch(
                    [("missing", bodies[0])])["responses"]}
            _same(port, ref)
            assert port["responses"][-1]["status"] == 404
            for b in bodies[:: len(bodies) // 4]:
                _same(nodes[0].search("logs", b), nodes[1].search("logs", b))
            _same(nodes[0].count("logs", {"query": {"match_all": {}}}),
                  nodes[1].count("logs", {"query": {"match_all": {}}}))

        steps = [
            lambda n: n.bulk(_bulk_ops(docs[:350])),
            lambda n: n.bulk(_bulk_ops(docs[350:450])
                             + [("delete", {"_index": "logs",
                                            "_id": docs[3][0]}),
                                ("update", {"_index": "logs",
                                            "_id": docs[4][0],
                                            "doc": {"doc": {"size": 5}}}),
                                ("delete", {"_index": "logs",
                                            "_id": "absent"})]),
            lambda n: n.bulk(_bulk_ops(docs[450:])),
        ]
        for step in steps:
            outs = [step(n) for n in nodes]
            _same(outs[0], outs[1])
            refreshed = [n.refresh("logs") for n in nodes]
            _same(refreshed[0], refreshed[1])
            check()
        for n in nodes:
            r = n.update_doc("logs", docs[7][0], {"doc": {"status": "500"}})
            assert r["_version"] == 2
            n.delete_doc("logs", docs[8][0])
            n.force_merge("logs")
        check()
        got = [n.get_doc("logs", docs[7][0]) for n in nodes]
        _same(*({**g, "_source": json.loads(g["_source"])} for g in got))
    finally:
        for n in nodes:
            n.close()


@pytest.fixture
def node():
    n = Node({"node.name": "p0"}, device="cpu")
    yield n
    n.close()


def _fill(n, docs, settings):
    n.create_index("logs", settings, corpus.MAPPING)
    n.bulk(_bulk_ops(docs), refresh=True)


def test_request_cache_hits_and_invalidation(node):
    docs = _docs()
    _fill(node, docs[:400], {**_index_settings(True),
                             "index.cache.query.enable": True})
    svc = node.indices["logs"]
    body = {"size": 0, "query": {"range": {"size": {"gte": 1000}}},
            "aggs": {"st": {"terms": {"field": "status"}}}}
    first = node.search("logs", body)
    assert svc.request_cache.stats()["miss_count"] == 2      # per shard
    again = node.search("logs", body)
    assert svc.request_cache.stats()["hit_count"] == 2
    _same(first, again)
    # a delta epoch re-keys: the next search misses and sees the write
    node.bulk(_bulk_ops(docs[400:420]), refresh=True)
    third = node.search("logs", body)
    st = svc.request_cache.stats()
    assert st["hit_count"] == 2 and st["miss_count"] >= 3
    assert third["aggregations"] != first["aggregations"] \
        or third["hits"]["total"] != first["hits"]["total"]
    # a compaction re-keys the base: a miss, the same response
    gens = [e.base_generation() for e in svc.shards.values()]
    for e in svc.shards.values():
        e.compact()
    assert gens != [e.base_generation() for e in svc.shards.values()]
    misses = svc.request_cache.stats()["miss_count"]
    _same(node.search("logs", body), third)
    assert svc.request_cache.stats()["miss_count"] > misses
    q = node.nodes_stats()["nodes"]["p0"]["dispatch"]["traffic"]
    assert q["query_cache"]["hits"] == 2


def test_dispatch_counters(node):
    docs = _docs()
    _fill(node, docs[:300], _index_settings(False))
    bodies = [{"query": {"match": {"message": w}}, "size": 5}
              for w in ("images", "french", "english", "venues")]
    r = node.msearch([("logs", b) for b in bodies])
    assert all(x["status"] == 200 for x in r["responses"])
    d = node.nodes_stats()["nodes"]["p0"]["dispatch"]
    assert d["queries"] == 2 * len(bodies)          # per-shard jobs
    assert d["coalesced_queries"] >= len(bodies)
    assert d["pipeline_depth"] >= 1
    assert d["batches_dispatched"] >= 2


def test_tripped_fielddata_breaker_fails_the_shards(node, monkeypatch):
    docs = _docs()
    _fill(node, docs[:200], _index_settings(False))
    fd = breaker_service().breaker("fielddata")
    trips = fd.trips
    monkeypatch.setattr(fd, "limit", 1)          # nothing more fits
    r = node.msearch([("logs", {"query": {"match": {"message": "images"}}})])
    item = r["responses"][0]
    assert item["status"] == 429 and "CircuitBreakingError" in item["error"]
    assert fd.trips > trips
    monkeypatch.undo()
    ok = node.search("logs", {"query": {"match": {"message": "images"}}})
    assert ok["_shards"]["failed"] == 0
    s = node.nodes_stats()["nodes"]["p0"]["breakers"]["fielddata"]
    assert s["tripped"] == fd.trips and s["estimated_size_in_bytes"] > 0


def test_compaction_releases_replaced_fielddata_holds(node):
    docs = _docs()
    _fill(node, docs[:300], _index_settings(True))
    node.bulk(_bulk_ops(docs[300:340]), refresh=True)
    node.search("logs", {"query": {"match": {"message": "images"}}})
    fd = breaker_service().breaker("fielddata")
    svc = node.indices["logs"]
    old = [s for e in svc.shards.values() for s in e.segments]
    held = sum(s._breaker_hold.bytes for s in old)
    assert held > 0 and len(old) == 4                # base + delta x 2
    before = fd.used
    for e in svc.shards.values():
        e.compact()
    for e in svc.shards.values():
        e.invalidate_reader()
    del old
    gc.collect()
    assert fd.used <= before - held
    node.search("logs", {"query": {"match": {"message": "images"}}})
    new = [s for e in svc.shards.values() for s in e.segments]
    assert len(new) == 2 and all(s._breaker_hold.bytes > 0 for s in new)


def test_node_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Node()
