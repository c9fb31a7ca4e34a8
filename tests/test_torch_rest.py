"""The port's REST handlers against the reference's, on the CPU.

The same requests go through the reference's `RestDispatcher.dispatch`
and the port's: index creation, an NDJSON `_bulk` (parsed into its lines
as the HTTP handler parses it), `_refresh`, document get / update /
delete, `_search`, an NDJSON `_msearch` (one item naming a missing
index), `_count` and `_forcemerge`; every response is the reference's,
JSON dumps equal with `took` stripped. One real HTTP round trip on a
loopback port (`RestServer`) gives what the dispatcher gives.
"""

import copy
import json
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

N_DOCS = 400


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


def _bulk_lines(docs):
    out = []
    for did, d in docs:
        out += [{"index": {"_index": "logs", "_id": did}}, d]
    return out


def _msearch_lines(bodies):
    out = []
    for b in bodies:
        out += [{"index": "logs"}, b]
    return out + [{"index": "missing"}, {"query": {"match_all": {}}}]


@pytest.fixture(scope="module")
def dispatchers():
    port_node = Node({"node.name": "r0"}, device="cpu")
    ref_node = RefNode({"node.name": "r0"})
    yield RestDispatcher(port_node), RefDispatcher(ref_node)
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


def test_rest_handlers_equal_reference(dispatchers):
    docs = list(corpus.make_docs(N_DOCS, seed=31, start=0, long_every=50))
    mixes = corpus.request_mixes(2, seed=5, n_docs=N_DOCS, doc_seed=31)
    _both(dispatchers, "PUT", "/logs",
          body={"settings": {"number_of_shards": 2,
                             "number_of_replicas": 0,
                             "index.streaming.delta": True},
                "mappings": corpus.MAPPING})
    status, bulk = _both(dispatchers, "POST", "/_bulk",
                         raw=_ndjson(_bulk_lines(docs[:300])))
    assert not bulk["errors"] and len(bulk["items"]) == 300
    _both(dispatchers, "POST", "/logs/_refresh")
    _both(dispatchers, "POST", "/logs/_bulk", {"refresh": "true"},
          raw=_ndjson(_bulk_lines(docs[300:])))
    did = docs[10][0]
    _both(dispatchers, "POST", f"/logs/_update/{did}",
          body={"doc": {"size": 77}})
    _both(dispatchers, "DELETE", f"/logs/_doc/{docs[11][0]}")
    assert _both(dispatchers, "DELETE", "/logs/_doc/absent")[0] == 404
    _both(dispatchers, "POST", "/_refresh")
    _both(dispatchers, "GET", f"/logs/_doc/{did}")
    _both(dispatchers, "GET", f"/logs/_doc/{did}", {"_source": "false"})
    for mix in ("match", "bool_aggs", "match_range_aggs", "stats_aggs"):
        for b in mixes[mix]:
            _both(dispatchers, "POST", "/logs/_search", body=b)
    _both(dispatchers, "GET", "/logs/_search",
          {"size": "3", "sort": "size:desc"},
          body={"query": {"match_all": {}}})
    bodies = [b for m in ("match", "count_match", "aggs_only")
              for b in mixes[m]]
    status, ms = _both(dispatchers, "POST", "/_msearch",
                       raw=_ndjson(_msearch_lines(bodies)))
    assert ms["responses"][-1]["status"] == 404
    _both(dispatchers, "GET", "/logs/_count",
          body={"query": {"match": {"message": "images"}}})
    _both(dispatchers, "POST", "/logs/_forcemerge")
    _both(dispatchers, "POST", "/logs/_search",
          body=mixes["match_range_aggs"][0])


def test_http_round_trip():
    """A real loopback HTTP server: _bulk and _msearch over the wire give
    the dispatcher's responses."""
    node = Node({"node.name": "h0"}, device="cpu")
    srv = RestServer(node, host="127.0.0.1", port=0).start()
    try:
        def call(method, path, data=None):
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}{path}", data=data,
                method=method,
                headers={"Content-Type": "application/x-ndjson"})
            with urllib.request.urlopen(req, timeout=60) as f:
                return f.status, json.loads(f.read())

        docs = list(corpus.make_docs(200, seed=41, start=0, long_every=0))
        status, r = call("PUT", "/logs", json.dumps(
            {"settings": {"number_of_shards": 2},
             "mappings": corpus.MAPPING}).encode())
        assert status == 200 and r["acknowledged"]
        status, r = call("POST", "/_bulk?refresh=true",
                         _ndjson(_bulk_lines(docs)))
        assert status == 200 and not r["errors"]
        bodies = corpus.request_mixes(3, seed=3, n_docs=200,
                                      doc_seed=41)["match"]
        status, over_http = call("POST", "/_msearch",
                                 _ndjson(_msearch_lines(bodies)))
        assert status == 200
        direct = srv.dispatcher.dispatch(
            "POST", "/_msearch", {}, _msearch_lines(bodies))
        assert _strip_took(over_http) == _strip_took(direct)
        assert any(r.get("hits", {}).get("total", 0) > 0
                   for r in over_http["responses"])
        status, root = call("GET", "/")
        assert root["version"]["number"]
    finally:
        srv.stop()
        node.close()
