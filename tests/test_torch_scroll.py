"""Scroll, scan and dfs search types: the port's Node against the
reference's, on the CPU.

The same seeded documents and requests go through both packages' nodes
(2 shards, in memory), on the fused and the unfused engine
(`ES_TPU_FUSED=0/1`):

  * scroll pages of `match` and `bool` + range requests, and their
    concatenation equals one request of the whole window;
  * `search_type=scan` pages (the query wrapped in `constant_score`: a
    first response with the total and no hits, then pages in doc order);
  * `dfs_query_then_fetch` and `dfs_query_and_fetch` (global term
    statistics), and `_msearch` items with a `search_type` header, REST
    included (`_search?scroll=`, `GET|POST /_search/scroll`,
    `DELETE /_search/scroll`);
  * `clear_scroll` and reaping at the keepalive;
  * a scroll across a compaction keeps serving its point-in-time
    generation, and clearing it lets the retired segments and their
    fielddata holds go;
  * pages deep enough that K3's per-tile candidate count reaches the
    tile (k = from + size past 1,024 on a one-tile-per-1,024-docs
    index) over thousands of equal scores: the lower-doc-id tie rule.

Tolerance: none (JSON equal with `took` and `_scroll_id` stripped).
"""

import copy
import gc
import json
import time
import weakref

import pytest
import torch

from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.rest.server import RestDispatcher as RefDispatcher

from elasticsearch_tpu_torch import corpus
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.server import RestDispatcher, RestStatus
from elasticsearch_tpu_torch.utils.breaker import breaker_service

torch.set_num_threads(1)

N_DOCS = 900
SETTINGS = {"index.number_of_shards": 2, "index.streaming.delta": True,
            "index.delta.min_compact_docs": 64}


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items()
                if k not in ("took", "_scroll_id")}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _same(a, b):
    assert json.dumps(_strip(a), sort_keys=True) \
        == json.dumps(_strip(b), sort_keys=True)


def _docs(n=N_DOCS, seed=41):
    return list(corpus.make_docs(n, seed=seed, start=0, long_every=90))


def _mixes():
    return corpus.request_mixes(4, seed=13, n_docs=N_DOCS, doc_seed=41)


def _bulk(docs):
    return [("index", {"_index": "logs", "_id": did, "doc": d})
            for did, d in docs]


@pytest.fixture(params=["1", "0"], ids=["fused", "unfused"])
def nodes(request, monkeypatch):
    monkeypatch.setenv("ES_TPU_FUSED", request.param)
    out = [Node({"node.name": "s0", **SETTINGS}, device="cpu"),
           RefNode({"node.name": "s0", **SETTINGS})]
    docs = _docs()
    for n in out:
        n.create_index("logs", mappings=corpus.MAPPING)
        n.bulk(_bulk(docs[:700]), refresh=True)
        n.bulk(_bulk(docs[700:]), refresh=True)    # a delta on the base
    yield out
    for n in out:
        n.close()


def _scroll_all(node, first, max_pages=50):
    pages = [first]
    sid = first["_scroll_id"]
    for _ in range(max_pages):
        r = node.scroll(sid, "1m")
        pages.append(r)
        if not r["hits"]["hits"]:
            break
    node.clear_scroll([sid])
    return pages


def _ids(pages):
    return [h["_id"] for p in pages for h in p["hits"]["hits"]]


def test_scroll_pages_equal_reference(nodes):
    mixes = _mixes()
    for body in (mixes["match"][0], mixes["match_range_aggs"][1]):
        body = {**copy.deepcopy(body), "size": 90}
        pages = [_scroll_all(n, n.search("logs", copy.deepcopy(body),
                                         scroll="1m"))
                 for n in nodes]
        assert len(pages[0]) == len(pages[1])
        for a, b in zip(*pages):
            _same(a, b)
        total = pages[0][0]["hits"]["total"]
        whole = nodes[0].search("logs", {**body, "size": total})
        assert _ids(pages[0]) == [h["_id"] for h in whole["hits"]["hits"]]


def test_scan_pages_equal_reference(nodes):
    body = {"query": {"range": {"size": {"gte": 2000}}}, "size": 64}
    pages = [_scroll_all(n, n.search("logs", copy.deepcopy(body),
                                     scroll="1m", search_type="scan"))
             for n in nodes]
    assert pages[0][0]["hits"]["hits"] == []
    assert len(pages[0]) == len(pages[1]) > 2
    for a, b in zip(*pages):
        _same(a, b)
    ids = _ids(pages[0])
    assert len(ids) == len(set(ids)) == pages[0][0]["hits"]["total"]
    assert {h["_score"] for p in pages[0] for h in p["hits"]["hits"]} \
        == {1.0}


@pytest.mark.parametrize("search_type", ["dfs_query_then_fetch",
                                         "dfs_query_and_fetch"])
def test_dfs_equals_reference(nodes, search_type):
    mixes = _mixes()
    for mix in ("match", "bool_aggs", "phrase", "prefix", "term_body"):
        for body in mixes[mix][:1]:
            got = [n.search("logs", copy.deepcopy(body),
                            search_type=search_type) for n in nodes]
            _same(*got)
    # the global idf changes the scores of a shard-skewed term
    body = mixes["match"][0]
    plain = nodes[0].search("logs", copy.deepcopy(body))
    dfs = nodes[0].search("logs", copy.deepcopy(body),
                          search_type=search_type)
    assert plain["hits"]["total"] == dfs["hits"]["total"]
    assert [h["_score"] for h in plain["hits"]["hits"]] != \
        [h["_score"] for h in dfs["hits"]["hits"]]


def test_msearch_search_type_header(nodes):
    mixes = _mixes()
    items = [("logs", copy.deepcopy(mixes["match"][1]),
              "dfs_query_then_fetch"),
             ("logs", copy.deepcopy(mixes["match"][1])),
             ("logs", copy.deepcopy(mixes["count_match"][0]),
              "query_then_fetch")]
    port = nodes[0].msearch(items)
    ref = {"responses": [nodes[1].msearch([it])["responses"][0]
                         for it in items]}
    _same(port, ref)
    lines = []
    for it in items:
        lines += [{"index": it[0], **({"search_type": it[2]}
                                      if len(it) > 2 else {})}, it[1]]
    got = [RestDispatcher(nodes[0]).dispatch("POST", "/_msearch", {},
                                             copy.deepcopy(lines)),
           RefDispatcher(nodes[1]).dispatch("POST", "/_msearch", {},
                                            copy.deepcopy(lines))]
    _same(got[0], ref)
    _same(got[1], ref)


def test_rest_scroll_routes(nodes):
    ds = [RestDispatcher(nodes[0]), RefDispatcher(nodes[1])]
    body = {"query": {"match": {"message": "get"}}, "size": 25}
    firsts = [d.dispatch("POST", "/logs/_search", {"scroll": "1m"},
                         copy.deepcopy(body)) for d in ds]
    _same(*firsts)
    seconds = [d.dispatch("POST", "/_search/scroll", {},
                          {"scroll_id": f["_scroll_id"], "scroll": "1m"})
               for d, f in zip(ds, firsts)]
    _same(*seconds)
    thirds = [d.dispatch("GET", "/_search/scroll",
                         {"scroll_id": f["_scroll_id"]}, None)
              for d, f in zip(ds, firsts)]
    _same(*thirds)
    cleared = [d.dispatch("DELETE", "/_search/scroll", {},
                          {"scroll_id": f["_scroll_id"]})
               for d, f in zip(ds, firsts)]
    _same(*cleared)
    missing = [d.dispatch("DELETE", "/_search/scroll", {},
                          {"scroll_id": f["_scroll_id"]})
               for d, f in zip(ds, firsts)]
    assert isinstance(missing[0], RestStatus) and missing[0].status == 404
    assert missing[1].status == 404
    _same(missing[0].payload, missing[1].payload)


def test_clear_scroll_and_reaping(nodes):
    body = {"query": {"match_all": {}}, "size": 5}
    for n in nodes:
        a = n.search("logs", dict(body), scroll="1m")
        b = n.search("logs", dict(body), scroll="1m")
        assert n.clear_scroll([a["_scroll_id"], "nope"]) == \
            {"succeeded": True, "num_freed": 1}
        assert n.clear_scroll() == {"succeeded": True, "num_freed": 1}
        with pytest.raises(Exception) as ei:
            n.scroll(b["_scroll_id"])
        assert ei.value.status == 404
        c = n.search("logs", dict(body), scroll="1ms")
        time.sleep(0.01)
        with pytest.raises(Exception) as ei:
            n.scroll(c["_scroll_id"])
        assert ei.value.status == 404
        assert len(n._scrolls) == 0


def test_scroll_across_compaction_keeps_its_generation(monkeypatch):
    monkeypatch.delenv("ES_TPU_FUSED", raising=False)
    fd = breaker_service().breaker("fielddata")
    n = Node({"node.name": "c0", **SETTINGS}, device="cpu")
    try:
        docs = _docs(1400, seed=43)
        n.create_index("logs", mappings=corpus.MAPPING)
        n.bulk(_bulk(docs[:600]), refresh=True)
        n.bulk(_bulk(docs[600:640]), refresh=True)
        body = {"query": {"match": {"message": "get index"}}, "size": 30}
        total = n.search("logs", dict(body))["hits"]["total"]
        want = n.search("logs", {**body, "size": total})
        first = n.search("logs", dict(body), scroll="5m")
        old = [weakref.ref(s) for svc in n.indices.values()
               for eng in svc.shards.values() for s in eng.segments]
        gens = [eng.base_generation()
                for eng in n.indices["logs"].shards.values()]
        n.bulk(_bulk(docs[640:]), refresh=True)       # compacts
        assert [eng.base_generation()
                for eng in n.indices["logs"].shards.values()] != gens
        pages = _scroll_all_keep(n, first)
        assert _ids(pages) == [h["_id"] for h in want["hits"]["hits"]]
        assert sum(p["hits"]["total"] == total for p in pages) == len(pages)
        gc.collect()
        assert all(r() is not None for r in old)   # the context holds them
        held = fd.used
        n.clear_scroll([first["_scroll_id"]])
        gc.collect()
        assert all(r() is None for r in old)
        assert fd.used < held
    finally:
        n.close()


def _scroll_all_keep(node, first):
    """Every page of a scroll, the context left open."""
    pages = [first]
    while True:
        r = node.scroll(first["_scroll_id"])
        if not r["hits"]["hits"]:
            return pages
        pages.append(r)


def test_deep_pages_reach_the_tile(monkeypatch):
    """One shard of 3,000 docs (cap 4,096, four 1,024-doc tiles). Scroll
    pages of 500 of a two-term `match` run k = from + size up to 2,500 on
    the fused engine, so K3's per-tile candidate count reaches the tile
    over a score distribution with long runs of equal scores (equal
    lengths, equal tf); scan pages run the same depths over 3,000 equal
    scores on the unfused path (`constant_score` stays off K3). Pages
    equal the reference's, their concatenation equals one request of the
    whole window, and scan follows the doc order."""
    from elasticsearch_tpu_torch.search import executor
    docs = _docs(3000, seed=47)
    settings = {"index.number_of_shards": 1}
    match = {"query": {"match": {"message": "get post"}}, "size": 500}
    for fused in ("1", "0"):
        monkeypatch.setenv("ES_TPU_FUSED", fused)
        nodes = [Node({"node.name": "t", **settings}, device="cpu"),
                 RefNode({"node.name": "t", **settings})]
        try:
            for n in nodes:
                n.create_index("logs", mappings=corpus.MAPPING)
                n.bulk(_bulk(docs), refresh=True)
            admitted = executor.fused_scoring_stats()["admission"]["admitted"]
            pages = [_scroll_all(n, n.search("logs", copy.deepcopy(match),
                                             scroll="1m")) for n in nodes]
            if fused == "1":
                assert executor.fused_scoring_stats()["admission"][
                    "admitted"] > admitted
            for a, b in zip(*pages):
                _same(a, b)
            total = pages[0][0]["hits"]["total"]
            assert total > 1500     # pages at k 1,500 and 2,000
            scores = [h["_score"] for p in pages[0] for h in p["hits"]["hits"]]
            assert len(scores) - len(set(scores)) > 1000     # ties
            whole = nodes[0].search("logs", {**match, "size": total})
            assert _ids(pages[0]) == [h["_id"] for h in whole["hits"]["hits"]]
            scans = [_scroll_all(n, n.search(
                "logs", {"query": {"match_all": {}}, "size": 700},
                scroll="1m", search_type="scan")) for n in nodes]
            for a, b in zip(*scans):
                _same(a, b)
            ids = _ids(scans[0])
            order = {did: i for i, (did, _) in enumerate(docs)}
            assert [order[i] for i in ids] == list(range(3000))
        finally:
            for n in nodes:
                n.close()
