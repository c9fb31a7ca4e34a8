"""The query DSL and derived aggs through the node and its REST layer:
the PyTorch port vs the JAX reference, on the CPU.

Both packages' nodes take the same index (2 shards, some docs without
`body` / `size`) through their `RestDispatcher`s, then answer:

* the URI search `GET /logs/_search?q=...`, which the REST layer
  rewrites into a `query_string` (field terms with AND / OR / NOT, bare
  terms over every text field, `-` / `+`);
* `POST /logs/_search` and an NDJSON `_msearch` of derived bucket aggs
  (merged across the shards from their `derived` partials), of
  significant_terms under terms (applied at the node over both shards)
  and of every query-DSL mix;

every response the reference's, JSON dumps equal with `took` stripped.
One real HTTP round trip on a loopback port gives the dispatcher's
response for `_search?q=`.
"""

import copy
import json
import urllib.parse
import urllib.request

import pytest
import torch

from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.rest.server import RestDispatcher as RefDispatcher

from elasticsearch_tpu_torch import corpus
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.server import (RestDispatcher, RestServer,
                                                 RestStatus,
                                                 parse_request_body)

torch.set_num_threads(1)

N_DOCS = 500
QUERIES = ["message:images AND message:french", "message:get OR post",
           "get -html", "+message:news sport", "message:torch NOT images",
           "b00002", "nosuchword"]


def _strip_took(x):
    if isinstance(x, dict):
        return {k: _strip_took(v) for k, v in x.items() if k != "took"}
    if isinstance(x, (list, tuple)):
        return [_strip_took(v) for v in x]
    return x


def _payload(r):
    return (r.status, r.payload) if isinstance(r, RestStatus) \
        or type(r).__name__ == "RestStatus" else (200, r)


def _ndjson(lines):
    return ("\n".join(json.dumps(x) for x in lines) + "\n").encode()


@pytest.fixture(scope="module")
def dispatchers():
    port_node = Node({"node.name": "d0"}, device="cpu")
    ref_node = RefNode({"node.name": "d0"})
    ds = (RestDispatcher(port_node), RefDispatcher(ref_node))
    docs = [(d, {k: v for k, v in doc.items()
                 if not ((k == "body" and int(d) % 7 == 0)
                         or (k == "size" and int(d) % 11 == 0))})
            for d, doc in corpus.make_docs(N_DOCS, seed=37, long_every=100)]
    lines = []
    for did, d in docs:
        lines += [{"index": {"_index": "logs", "_id": did}}, d]
    _both(ds, "PUT", "/logs", body={"settings": {"number_of_shards": 2,
                                                 "number_of_replicas": 0},
                                    "mappings": corpus.MAPPING})
    _both(ds, "POST", "/_bulk", raw=_ndjson(lines))
    _both(ds, "POST", "/logs/_refresh")
    yield ds
    port_node.close()
    ref_node.close()


def _both(dispatchers, method, path, params=None, body=None, raw=None):
    if raw is not None:
        body = parse_request_body(path, raw)
    out = [_payload(d.dispatch(method, path, params or {},
                               copy.deepcopy(body)))
           for d in dispatchers]
    assert json.dumps(_strip_took(out[0]), sort_keys=True) \
        == json.dumps(_strip_took(out[1]), sort_keys=True), (method, path)
    return out[0]


@pytest.mark.parametrize("q", QUERIES)
def test_uri_query_string(dispatchers, q):
    status, r = _both(dispatchers, "GET", "/logs/_search", {"q": q})
    assert status == 200 and "hits" in r


DERIVED = {
    "buckets": {"query": {"match": {"message": "get"}}, "size": 0, "aggs": {
        "by_status": {"filters": {"filters": {
            s: {"term": {"status": s}} for s in ("200", "404", "500")}},
            "aggs": {"a": {"avg": {"field": "size"}}}},
        "sizes": {"range": {"field": "size", "ranges": [
            {"to": 20000}, {"from": 20000, "to": 60000}, {"from": 60000}]},
            "aggs": {"t": {"terms": {"field": "status"}}}},
        "days": {"date_range": {"field": "@timestamp", "ranges": [
            {"to": "2015-01-15"}, {"from": "2015-01-15"}]}},
        "no_body": {"missing": {"field": "body"}},
        "all": {"global": {}, "aggs": {"t": {"terms": {"field": "status"}}}},
        "f": {"filter": {"range": {"size": {"gte": 50000}}},
              "aggs": {"s": {"sum": {"field": "size"}}}}}},
    "top_sig": {"query": {"match": {"message": "get html"}}, "size": 3,
                "aggs": {"top": {"top_hits": {"size": 3}},
                         "sig": {"significant_terms": {
                             "field": "status", "min_doc_count": 1}}}},
    "sig_under_terms": {"query": {"match": {"message": "images"}},
                        "size": 0, "aggs": {"t": {
                            "terms": {"field": "status"},
                            "aggs": {"sig": {"significant_terms": {
                                "field": "message",
                                "min_doc_count": 1}}}}}},
}


@pytest.mark.parametrize("name", sorted(DERIVED))
def test_derived_aggs_over_the_node(dispatchers, name):
    status, r = _both(dispatchers, "POST", "/logs/_search",
                      body=DERIVED[name])
    assert status == 200 and r["aggregations"]


def test_dsl_mixes_msearch(dispatchers):
    mixes = corpus.dsl_mixes(2, seed=23, n_ids=N_DOCS)
    bodies = [b for name in corpus.DSL_MIXES for b in mixes[name]]
    lines = [x for b in bodies for x in ({"index": "logs"}, b)]
    status, r = _both(dispatchers, "POST", "/_msearch", raw=_ndjson(lines))
    assert all(x.get("status") == 200 for x in r["responses"])


def test_uri_query_string_over_http(dispatchers):
    """A real loopback HTTP server gives the dispatcher's response."""
    node = dispatchers[0].node
    srv = RestServer(node, host="127.0.0.1", port=0).start()
    try:
        q = QUERIES[1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/logs/_search?q="
                + urllib.parse.quote(q), timeout=60) as f:
            over_http = json.loads(f.read())
    finally:
        srv.stop()
    direct = _payload(dispatchers[0].dispatch("GET", "/logs/_search",
                                              {"q": q}, None))[1]
    assert _strip_took(over_http) == _strip_took(direct)
    assert over_http["hits"]["total"] > 0
