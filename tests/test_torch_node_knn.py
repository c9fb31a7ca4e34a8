"""Vector search through the port's Node (and HTTP) vs the reference's
Node, on the CPU.

Both nodes take the same seeded passages (dyadic embeddings, so every
dot product is exact: responses equal bit for bit) into a 2-shard index
with a `dense_vector` mapping through `_bulk` and `refresh`, in the
legacy and the streaming delta mode, with `index.ann.min_docs` low so
the shards' bases build IVF indexes; the vector mixes (pure `knn`,
hybrid `knn` + `match`, `knn` query node with `rescore`) through
`msearch` equal the reference's after each step and after a force
merge. With `path.data`: flush, close and boot bring the vectors and the
IVF indexes back and the responses stay equal; the port boots on the
reference's data directory and answers as the reference does. One real
HTTP round trip (`RestServer`) gives what `node.msearch` gives.
"""

import copy
import json
import urllib.request

import pytest
import torch

from elasticsearch_tpu.node import Node as RefNode

from elasticsearch_tpu_torch import corpus
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.server import RestServer

torch.set_num_threads(1)

D = 8
N_DOCS = 900


def _docs():
    return corpus.make_passages(N_DOCS, D, seed=3, dyadic=True,
                                missing_every=50)


def _bodies():
    q = corpus.passage_queries(3, D, dyadic=True, seed=5)
    return [b for m in corpus.knn_mixes(q, 3).values() for b in m]


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k != "took"}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _same(a, b):
    assert json.dumps(_strip(a), sort_keys=True) \
        == json.dumps(_strip(b), sort_keys=True)


def _settings(path=None):
    s = {"node.name": "v0", "index.ann.min_docs": 100}
    if path is not None:
        s["path.data"] = path
    return s


def _index_settings(delta):
    return {"number_of_shards": 2, "index.streaming.delta": delta,
            "index.delta.min_compact_docs": 64}


def _bulk(docs):
    return [("index", {"_index": "p", "_id": did, "doc": d})
            for did, d in docs]


def _msearch(nodes, bodies):
    return ([r for r in nodes[0].msearch([("p", b) for b in
                                          copy.deepcopy(bodies)])
             ["responses"]],
            [nodes[1].msearch([("p", b)])["responses"][0]
             for b in copy.deepcopy(bodies)])


@pytest.mark.parametrize("delta", [False, True], ids=["legacy", "delta"])
def test_node_knn_equals_reference(delta):
    docs, bodies = _docs(), _bodies()
    nodes = [Node(_settings(), device="cpu"), RefNode(_settings())]
    try:
        for n in nodes:
            n.create_index("p", _index_settings(delta),
                           corpus.passage_mapping(D))
        for lo, hi in ((0, 600), (600, N_DOCS)):
            for n in nodes:
                n.bulk(_bulk(docs[lo:hi]))
                n.refresh("p")
            _same(*_msearch(nodes, bodies))
        for n in nodes:
            n.delete_doc("p", docs[4][0])
            n.force_merge("p")
        got, want = _msearch(nodes, bodies)
        _same(got, want)
        assert all(r["hits"]["hits"] for r in want)
        stats = nodes[0].nodes_stats()["nodes"]["v0"]["fused_scoring"]
        assert stats["admission"]["knn"]["ivf"] > 0
        assert stats["ann"]["clusters_probed"] > 0
    finally:
        for n in nodes:
            n.close()


def test_restart_brings_vectors_and_ivf_back(tmp_path):
    docs, bodies = _docs(), _bodies()
    paths = [str(tmp_path / "port"), str(tmp_path / "ref")]
    nodes = [Node(_settings(paths[0]), device="cpu"),
             RefNode(_settings(paths[1]))]
    for n in nodes:
        n.create_index("p", {"number_of_shards": 2},
                       corpus.passage_mapping(D))
        n.bulk(_bulk(docs), refresh=True)
    before = _msearch(nodes, bodies)
    _same(*before)
    for n in nodes:
        n.flush("p")
        n.close()
    nodes = [Node(_settings(paths[0]), device="cpu"),
             RefNode(_settings(paths[1]))]
    try:
        # the IVF indexes came back with the segments, not rebuilt
        for svc in (nodes[0].indices["p"], nodes[1].indices["p"]):
            for eng in svc.shards.values():
                segs = eng.acquire_searcher().segments
                assert any("embedding" in s.ann for s in segs)
        after = _msearch(nodes, bodies)
        _same(*after)
        _same(before[0], after[0])
    finally:
        for n in nodes:
            n.close()
    # the port boots on the reference's data directory
    port = Node(_settings(paths[1]), device="cpu")
    try:
        got = port.msearch([("p", b) for b in copy.deepcopy(bodies)])
        _same(got["responses"], before[1])
    finally:
        port.close()


def test_http_msearch_with_vectors():
    node = Node({"node.name": "h0"}, device="cpu")
    srv = RestServer(node, host="127.0.0.1", port=0).start()
    try:
        def call(method, path, lines=None, body=None):
            data = (("\n".join(json.dumps(x) for x in lines) + "\n").encode()
                    if lines is not None else
                    None if body is None else json.dumps(body).encode())
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}{path}", data=data,
                method=method,
                headers={"Content-Type": "application/x-ndjson"})
            with urllib.request.urlopen(req, timeout=60) as f:
                return f.status, json.loads(f.read())

        status, r = call("PUT", "/p", body={
            "settings": {"number_of_shards": 2},
            "mappings": corpus.passage_mapping(D)})
        assert status == 200 and r["acknowledged"]
        lines = []
        for did, d in _docs()[:300]:
            lines += [{"index": {"_index": "p", "_id": did}}, d]
        status, r = call("POST", "/_bulk?refresh=true", lines=lines)
        assert status == 200 and not r["errors"]
        bodies = _bodies()
        lines = []
        for b in bodies:
            lines += [{"index": "p"}, b]
        status, r = call("POST", "/_msearch", lines=lines)
        assert status == 200
        _same(r["responses"],
              node.msearch([("p", b) for b in copy.deepcopy(bodies)])
              ["responses"])
        assert all(x["hits"]["hits"] for x in r["responses"])
    finally:
        srv.stop()
        node.close()
