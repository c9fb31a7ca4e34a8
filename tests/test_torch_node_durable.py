"""The port's durable Node against the reference's, on the CPU.

  * A node with `path.data`: the exclusive `node.lock`, the index
    metadata it persists, a restart that answers as before the close (the
    same requests through both packages, before and after, JSON equal
    with `took` stripped), `_types.json`, and `delete_index` removing
    the index's directory.
  * A contained shard (a flipped byte in shard 0's committed segment),
    against the reference: partial results with structured
    `_shards.failures`, fail-fast raising, writes answering 503,
    `recovery_status`, `verify_integrity` and the `durability` block of
    `nodes_stats`; the contained shard holds no fielddata.
  * REST `POST /_flush`, `POST /{index}/_flush`, `GET /_recovery` and
    `GET /{index}/_recovery` through both dispatchers.
  * One short kill -9 round: this file spawns itself as a `__main__`
    worker (`sys.executable`), a `request`-mode port node on the CPU
    that prints `ACK <i>` after each acked write and flushes every 25;
    one SIGKILL at a seeded instant, then one
    `crash_point:site=store:phase=commit:kill=1`. After each, every acked
    doc comes back and the store verifies clean.
  * `async` bulks under kill -9: the same worker, as an `async` node of
    either package writing through `node.bulk` (index ops with routing
    and types, updates, deletes; `ACK <bulk>` after each bulk returned).
    A port node SIGKILLed at a seeded instant comes back with every doc
    of every acked bulk as a port node without a data path holds them
    (`get_doc` JSON equal: version, source, type, routing). Under
    `crash_point:site=translog:phase=append:rate=0.05:seed=11:kill=1`
    both packages die at the same append of the same bulk; each
    recovers the acked bulks' docs alike, and the reference also the
    cut bulk's ops ahead of the crash, which were never acked and which
    the port, holding a bulk's records until it returns, never wrote.

Tolerance: none (exact responses; segment ids in failure reasons are
blanked, the two packages count them separately).
"""

import copy
import glob
import json
import os
import random
import re
import signal
import subprocess
import sys
import time

if __name__ == "__main__":   # the kill -9 worker: the port alone
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import pytest
import torch

torch.set_num_threads(1)

MAPPING = {"properties": {"msg": {"type": "text"}, "n": {"type": "long"},
                          "tag": {"type": "keyword"}}}
WORKER_SETTINGS = {
    "node.name": "soak",
    "index.number_of_shards": 1,
    "index.translog.durability": "request",
    "index.shard.check_on_startup": True,
}


BULK_DOCS = 8
BULK_WORDS = ("alpha", "beta", "gamma", "delta")


def bulk_ops(b: int) -> list:
    """Bulk b: BULK_DOCS new docs (routed, every fourth typed), an update
    of bulk b-1's third doc and a delete of its second."""
    ops = []
    for j in range(b * BULK_DOCS, (b + 1) * BULK_DOCS):
        payload = {"_index": "bulk", "_id": f"d{j}", "_routing": f"r{j % 3}",
                   "doc": {"msg": f"doc {j} {BULK_WORDS[j % 4]}", "n": j}}
        if j % 4 == 0:
            payload["_type"] = "kind_a"
        ops.append(("index", payload))
    if b:
        k = (b - 1) * BULK_DOCS
        ops.append(("update", {"_index": "bulk", "_id": f"d{k + 2}",
                               "_routing": f"r{(k + 2) % 3}",
                               "doc": {"doc": {"n": -k}}}))
        ops.append(("delete", {"_index": "bulk", "_id": f"d{k + 1}",
                               "_routing": f"r{(k + 1) % 3}"}))
    return ops


def bulk_ids(b: int) -> set:
    return {p["_id"] for _, p in bulk_ops(b)}


def bulk_settings(path=None) -> dict:
    out = {"node.name": "bulk", "index.number_of_shards": 2,
           "index.translog.durability": "async"}
    if path is not None:
        out["path.data"] = path
    return out


def bulk_worker_main(argv) -> None:
    """bulk <port|ref> <data_path>: an `async` node writing bulk_ops(0),
    bulk_ops(1), ... until killed, printing `ACK <b>` after each bulk
    returned, flushing every 10 bulks."""
    pkg, data_path = argv
    if pkg == "port":
        from elasticsearch_tpu_torch.node import Node
        node = Node(bulk_settings(data_path), device="cpu")
    else:
        from elasticsearch_tpu.node import Node
        node = Node(bulk_settings(data_path))
    node.create_index("bulk", mappings=MAPPING)
    b = 0
    while True:
        r = node.bulk(bulk_ops(b))
        if r["errors"]:
            raise AssertionError(json.dumps(r)[:400])
        print(f"ACK {b}", flush=True)
        if b % 10 == 9:
            node.flush("bulk")
        b += 1


def worker_main(argv) -> None:
    """write <data_path> <seed> <start_i>: index seeded docs until
    killed, printing `ACK <i>` after each write returned."""
    from elasticsearch_tpu_torch.node import Node
    data_path, seed, start_i = argv[0], int(argv[1]), int(argv[2])
    node = Node({**WORKER_SETTINGS, "path.data": data_path}, device="cpu")
    rng = random.Random(seed)
    if "soak" not in node.indices:
        node.create_index("soak", mappings=MAPPING)
    i = start_i
    while True:
        node.index_doc("soak", f"d{i}", {
            "msg": f"doc {i} " + " ".join(
                rng.choice(["alpha", "beta", "gamma", "delta"])
                for _ in range(4)),
            "n": i})
        print(f"ACK {i}", flush=True)
        if i % 25 == 24:
            node.flush("soak")
        i += 1


if __name__ == "__main__":
    if sys.argv[1] == "bulk":
        bulk_worker_main(sys.argv[2:])
    else:
        worker_main(sys.argv[1:])
    sys.exit(0)


from elasticsearch_tpu.node import Node as RefNode  # noqa: E402
from elasticsearch_tpu.rest.server import RestDispatcher as RefDispatcher  # noqa: E402
from elasticsearch_tpu.utils.errors import ShardFailedError as RefShardFailed  # noqa: E402

from elasticsearch_tpu_torch import corpus  # noqa: E402
from elasticsearch_tpu_torch.cluster.routing import shard_id  # noqa: E402
from elasticsearch_tpu_torch.node import Node  # noqa: E402
from elasticsearch_tpu_torch.rest.server import RestDispatcher  # noqa: E402
from elasticsearch_tpu_torch.utils.breaker import breaker_service  # noqa: E402
from elasticsearch_tpu_torch.utils.errors import (  # noqa: E402
    IllegalArgumentError, ShardFailedError)

N_DOCS = 400
MIXES = ("match", "bool_aggs", "match_range_aggs", "phrase", "count_match")


def _strip_took(x):
    if isinstance(x, dict):
        return {k: _strip_took(v) for k, v in x.items() if k != "took"}
    if isinstance(x, list):
        return [_strip_took(v) for v in x]
    return x


def _dump(x):
    """JSON of a response, `took` stripped and segment ids blanked."""
    return re.sub(r"(?<![0-9])\d+_\d+(?![0-9])", "<sid>",
                  json.dumps(_strip_took(x), sort_keys=True))


def _same(a, b):
    assert _dump(a) == _dump(b)


def _same_recovery(a, b):
    """recovery_status / verify_integrity, with the corruption marker's
    uuid blanked and the byte sizes (`Segment.nbytes`, which counts the
    columns each package keeps) dropped."""
    def norm(x):
        if isinstance(x, dict):
            return {k: norm(v) for k, v in x.items() if k != "size"}
        if isinstance(x, list):
            return [norm(v) for v in x]
        if isinstance(x, str):
            return re.sub(r"corrupted_[0-9a-f]+", "corrupted_M", x)
        return x
    _same(norm(a), norm(b))


def _docs():
    return list(corpus.make_docs(N_DOCS, seed=23, start=0, long_every=80))


def _bodies():
    mixes = corpus.request_mixes(1, seed=5, n_docs=N_DOCS, doc_seed=23)
    return [b for m in MIXES for b in copy.deepcopy(mixes[m])]


def _node_settings(path):
    # index settings at node level: the reference keeps only the shard
    # count of index-level settings across a restart (ROADMAP Queue 3)
    return {"node.name": "d0", "path.data": path,
            "index.number_of_shards": 2, "index.streaming.delta": True,
            "index.delta.min_compact_docs": 32}


def _nodes(tmp_path, name):
    return [Node(_node_settings(str(tmp_path / f"{name}-port")),
                 device="cpu"),
            RefNode(_node_settings(str(tmp_path / f"{name}-ref")))]


def _msearch_all(nodes, bodies):
    """The reference one item at a time (ROADMAP Queue 3: two requests of
    one group binding to nothing on every segment trip it)."""
    port = nodes[0].msearch([("logs", b) for b in bodies])
    ref = {"responses": [nodes[1].msearch([("logs", b)])["responses"][0]
                         for b in bodies]}
    return port, ref


def _bulk(docs):
    return [("index", {"_index": "logs", "_id": did, "doc": d})
            for did, d in docs]


def test_restart_answers_as_before(tmp_path):
    docs = _docs()
    bodies = _bodies()
    nodes = _nodes(tmp_path, "rs")
    for n in nodes:
        n.create_index("logs", mappings=corpus.MAPPING)
        n.bulk(_bulk(docs[:300]), refresh=True)
        n.index_doc("logs", "typed", {"message": "a typed doc"},
                    doc_type="event", routing="r1")
    _same(*[n.flush("logs") for n in nodes])
    for n in nodes:
        n.bulk(_bulk(docs[300:]) + [
            ("delete", {"_index": "logs", "_id": docs[3][0]}),
            ("update", {"_index": "logs", "_id": docs[4][0],
                        "doc": {"doc": {"size": 5}}})])
        n.refresh("logs")
    before = _msearch_all(nodes, bodies)
    _same(*before)
    for n in nodes:
        n.close()
    # the metadata both packages persisted
    metas = [json.load(open(tmp_path / f"rs-{p}" / "logs" / "_meta.json"))
             for p in ("port", "ref")]
    assert metas[0]["mappings"] == metas[1]["mappings"]
    assert metas[0]["settings"]["index.number_of_shards"] == 2
    types = [json.load(open(tmp_path / f"rs-{p}" / "logs" / "_types.json"))
             for p in ("port", "ref")]
    for t in types:     # write times: the keys only
        t["ts"] = sorted(t["ts"])
    assert types[0] == types[1]
    nodes = _nodes(tmp_path, "rs")
    try:
        after = _msearch_all(nodes, bodies)
        _same(*after)
        _same(before[0], after[0])
        got = [n.get_doc("logs", "typed", routing="r1") for n in nodes]
        assert got[0]["_type"] == got[1]["_type"] == "event"
        assert got[0]["_routing"] == "r1"
        _same_recovery(*[n.recovery_status() for n in nodes])
        _same_recovery(*[n.verify_integrity() for n in nodes])
        dur = [n.nodes_stats()["nodes"]["d0"]["indices"]["durability"]
               for n in nodes]
        assert dur[0] == dur[1]
        assert dur[0]["shards_failed_corrupt"] == 0
    finally:
        for n in nodes:
            n.close()


def test_node_lock_is_exclusive(tmp_path):
    path = str(tmp_path / "lock")
    n = Node({"path.data": path}, device="cpu")
    try:
        with pytest.raises(IllegalArgumentError, match="node lock"):
            Node({"path.data": path}, device="cpu")
    finally:
        n.close()
    Node({"path.data": path}, device="cpu").close()   # released on close


def test_delete_index_removes_its_directory(tmp_path):
    path = str(tmp_path / "del")
    n = Node({"path.data": path}, device="cpu")
    n.create_index("logs", mappings=MAPPING)
    n.index_doc("logs", "1", {"msg": "x", "n": 1})
    n.flush("logs")
    assert os.path.isdir(os.path.join(path, "logs", "0", "store"))
    n.delete_index("logs")
    assert not os.path.exists(os.path.join(path, "logs"))
    n.close()
    n = Node({"path.data": path}, device="cpu")
    assert "logs" not in n.indices
    n.close()


def test_doc_metadata_survives_a_crash(tmp_path):
    """Types, routing and index timestamps of acked writes come back
    after a death without close (the `_types.log` journal), and after a
    flush from `_types.json` alone."""
    path = str(tmp_path / "meta")
    n = Node({"path.data": path, "index.number_of_shards": 2}, device="cpu")
    n.create_index("logs", mappings=MAPPING)
    n.index_doc("logs", "a", {"msg": "x", "n": 1}, doc_type="event",
                routing="r1", timestamp="1000")
    n.index_doc("logs", "b", {"msg": "y", "n": 2}, routing="r2")
    n.flush("logs")
    assert os.path.getsize(os.path.join(path, "logs", "_types.log")) == 0
    n.index_doc("logs", "c", {"msg": "z", "n": 3}, doc_type="alert",
                routing="r3")
    n.delete_doc("logs", "b", routing="r2")
    # the process dies: no close, the lock goes with it
    n._node_lock_fh.close()
    n._node_lock_fh = None
    n2 = Node({"path.data": path}, device="cpu")
    try:
        svc = n2.indices["logs"]
        assert svc.doc_types == {"a": "event", "c": "alert"}
        assert svc.doc_routing == {"a": "r1", "c": "r3"}
        assert svc.doc_ts["a"] == 1000 and "b" not in svc.doc_ts
        got = n2.get_doc("logs", "c", routing="r3")
        assert (got["_type"], got["_routing"]) == ("alert", "r3")
    finally:
        n2.close()
    meta = json.load(open(os.path.join(path, "logs", "_types.json")))
    assert meta["types"] == {"a": "event", "c": "alert"}


def test_index_settings_survive_restart(tmp_path):
    """The port keeps an index's own settings across a restart; the
    reference's close rewrites them to the shard count alone, so its
    restarted engine leaves the streaming delta mode (ROADMAP Queue 3)."""
    settings = {"number_of_shards": 2, "index.streaming.delta": True,
                "index.translog.durability": "async"}
    modes = []
    for cls, kw, name in ((Node, {"device": "cpu"}, "port"),
                          (RefNode, {}, "ref")):
        path = str(tmp_path / f"st-{name}")
        n = cls({"path.data": path}, **kw)
        n.create_index("logs", settings, MAPPING)
        n.index_doc("logs", "1", {"msg": "x", "n": 1})
        n.close()
        n = cls({"path.data": path}, **kw)
        eng = n.indices["logs"].shard(0)
        modes.append((len(n.indices["logs"].shards), eng._delta_enabled,
                      eng.translog.durability))
        assert n.get_doc("logs", "1")["_version"] == 1
        n.close()
    assert modes[0] == (2, True, "async")
    assert modes[1] == (2, False, "request")


# ---------------------------------------------------------------------------
# a contained shard
# ---------------------------------------------------------------------------

@pytest.fixture()
def corrupt_nodes(tmp_path):
    out = []
    for cls, kw, name in ((Node, {"device": "cpu"}, "port"),
                          (RefNode, {}, "ref")):
        d = str(tmp_path / f"cn-{name}")
        n = cls({"path.data": d, "node.name": "dn",
                 "index.number_of_shards": 2}, **kw)
        n.create_index("logs", mappings=MAPPING)
        for i in range(8):
            n.index_doc("logs", str(i), {"msg": f"doc {i}", "n": i})
        n.flush("logs")
        n.close()
        npz = glob.glob(os.path.join(d, "logs", "0", "store",
                                     "seg_*.npz"))[0]
        data = bytearray(open(npz, "rb").read())
        data[len(data) // 2] ^= 0xFF
        open(npz, "wb").write(bytes(data))
        out.append(cls({"path.data": d, "node.name": "dn"}, **kw))
    yield out
    for n in out:
        n.close()


def test_contained_shard_partial_search(corrupt_nodes):
    body = {"query": {"match_all": {}}, "size": 20}
    got = [n.search("logs", dict(body)) for n in corrupt_nodes]
    fd = breaker_service().breaker("fielddata")
    baseline = fd.used
    got = [n.search("logs", dict(body)) for n in corrupt_nodes]
    assert fd.used == baseline
    _same(*got)
    sh = got[0]["_shards"]
    assert (sh["total"], sh["successful"], sh["failed"]) == (2, 1, 1)
    f = sh["failures"][0]
    assert f["status"] == 503 and f["index"] == "logs" and f["shard"] == 0
    assert f["reason"]["type"] == "ShardFailedError"
    assert len(got[0]["hits"]["hits"]) == got[0]["hits"]["total"] > 0
    msearch = [n.msearch([("logs", dict(body)), ("logs", {"size": 0})])
               for n in corrupt_nodes]
    _same(*msearch)
    _same(*[n.count("logs") for n in corrupt_nodes])


def test_contained_shard_fail_fast_and_503(corrupt_nodes):
    body = {"query": {"match_all": {}}, "allow_partial_search_results": False}
    for n, err in zip(corrupt_nodes, (ShardFailedError, RefShardFailed)):
        with pytest.raises(err):
            n.search("logs", dict(body))
        did = next(str(i) for i in range(100)
                   if shard_id(str(i), 2, None) == 0)
        with pytest.raises(err) as ei:
            n.index_doc("logs", did, {"msg": "x", "n": 1})
        assert ei.value.status == 503
    flushed = [n.flush("logs") for n in corrupt_nodes]
    _same(*flushed)


def test_contained_shard_reports(corrupt_nodes):
    recs = [n.recovery_status("logs") for n in corrupt_nodes]
    _same_recovery(*recs)
    by_id = {s["id"]: s for s in recs[0]["logs"]["shards"]}
    assert by_id[0]["stage"] == "FAILED"
    assert by_id[0]["failure"]["corruption_marker"].startswith("corrupted_")
    assert by_id[1]["stage"] == "DONE"
    dur = [n.nodes_stats()["nodes"]["dn"]["indices"]["durability"]
           for n in corrupt_nodes]
    assert dur[0] == dur[1]
    assert dur[0]["shards_failed_corrupt"] == 1
    assert dur[0]["corruptions_detected"] >= 1
    v = [n.verify_integrity() for n in corrupt_nodes]
    assert v[0]["clean"] is False
    assert not v[0]["indices"]["logs"]["shards"]["0"]["clean"]
    assert v[0]["indices"]["logs"]["shards"]["1"]["clean"]
    _same_recovery(*v)


def test_node_boot_never_raises_on_corruption(tmp_path):
    d = str(tmp_path / "shred")
    n = Node({"path.data": d, "index.number_of_shards": 1}, device="cpu")
    n.create_index("logs", mappings=MAPPING)
    n.index_doc("logs", "1", {"msg": "x", "n": 1})
    n.flush("logs")
    n.close()
    for f in glob.glob(os.path.join(d, "logs", "0", "store", "*")):
        data = bytearray(open(f, "rb").read())
        data[len(data) // 10] ^= 0xFF
        open(f, "wb").write(bytes(data))
    node = Node({"path.data": d}, device="cpu")
    assert node.indices["logs"].shard(0).failed is not None
    node.close()


# ---------------------------------------------------------------------------
# REST _flush and _recovery
# ---------------------------------------------------------------------------

def test_rest_flush_and_recovery(tmp_path):
    nodes = [Node({"path.data": str(tmp_path / "rest-port"),
                   "node.name": "r"}, device="cpu"),
             RefNode({"path.data": str(tmp_path / "rest-ref"),
                      "node.name": "r"})]
    ds = [RestDispatcher(nodes[0]), RefDispatcher(nodes[1])]
    try:
        for d in ds:
            d.dispatch("PUT", "/logs", {}, {"settings": {
                "number_of_shards": 2}, "mappings": MAPPING})
            for i in range(6):
                d.dispatch("PUT", f"/logs/_doc/{i}", {},
                           {"msg": f"doc {i}", "n": i})
        for method, path in (("POST", "/logs/_flush"), ("POST", "/_flush"),
                             ("GET", "/_recovery"),
                             ("GET", "/logs/_recovery")):
            got = [d.dispatch(method, path, {}, None) for d in ds]
            _same_recovery(*got)
        stores = glob.glob(str(tmp_path / "rest-port" / "logs" / "*" /
                               "store" / "commit_*.json"))
        # two flushes: each shard keeps its newest commit and the one
        # before it
        assert len(stores) == 4
    finally:
        for n in nodes:
            n.close()


# ---------------------------------------------------------------------------
# kill -9
# ---------------------------------------------------------------------------

def _run_round(data_path, seed, start_i, kill_after_s=None, fault=None,
               timeout_s=25.0):
    env = dict(os.environ)
    env.pop("ES_TPU_FAULT_INJECT", None)
    if fault:
        env["ES_TPU_FAULT_INJECT"] = fault
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), data_path, str(seed),
         str(start_i)], stdout=subprocess.PIPE, text=True, env=env)
    acked = []
    deadline = time.time() + timeout_s
    killed_at = None
    try:
        while time.time() < deadline:
            if killed_at is not None and time.time() >= killed_at:
                os.kill(proc.pid, signal.SIGKILL)
                break
            line = proc.stdout.readline()
            if not line:
                break   # the injected kill=1 crash point fired
            if line.startswith("ACK "):
                acked.append(int(line.split()[1]))
                if killed_at is None and kill_after_s is not None:
                    killed_at = time.time() + kill_after_s
    finally:
        try:
            os.kill(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        rest, _ = proc.communicate(timeout=30)
    for line in (rest or "").splitlines():
        if line.startswith("ACK "):
            acked.append(int(line.split()[1]))
    assert proc.returncode == -signal.SIGKILL
    assert acked, "the writer made no progress"
    return acked


def _verify(data_path):
    node = Node({**WORKER_SETTINGS, "path.data": data_path}, device="cpu")
    try:
        report = node.verify_integrity()
        node.refresh()
        r = node.search("soak", {"query": {"match_all": {}},
                                 "size": 10_000, "_source": False})
        ids = {int(h["_id"][1:]) for h in r["hits"]["hits"]}
        dur = node.nodes_stats()["nodes"]["soak"]["indices"]["durability"]
        return report, ids, dur
    finally:
        node.close()


def test_kill_nine_recovers_every_acked_doc(tmp_path):
    data_path = str(tmp_path / "soak")
    rounds = [(None, random.Random(7).uniform(0.3, 1.0)),
              ("crash_point:site=store:phase=commit:kill=1", None)]
    acked_all: set[int] = set()
    start_i = 0
    for rnd, (fault, kill_after) in enumerate(rounds):
        acked = _run_round(data_path, seed=1000 + rnd, start_i=start_i,
                           kill_after_s=kill_after, fault=fault)
        acked_all.update(acked)
        start_i = max(acked) + 1
        report, ids, dur = _verify(data_path)
        assert report["clean"], report
        missing = acked_all - ids
        assert not missing, (rnd, sorted(missing)[:20])
        assert dur["shards_failed_corrupt"] == 0
    # the commit crash fired at the round's first flush
    assert len(acked) <= 25


# ---------------------------------------------------------------------------
# kill -9 of `async` bulks
# ---------------------------------------------------------------------------

def _run_bulk_worker(pkg, data_path, kill_after_s=None, fault=None,
                     timeout_s=60.0):
    """The acked bulks of one worker run, killed `kill_after_s` after its
    first ack, or by the injected crash point."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("ES_TPU_FAULT_INJECT", None)
    if fault:
        env["ES_TPU_FAULT_INJECT"] = fault
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "bulk", pkg, data_path],
        stdout=subprocess.PIPE, text=True, env=env)
    acked = []
    deadline = time.time() + timeout_s
    killed_at = None
    try:
        while time.time() < deadline:
            if killed_at is not None and time.time() >= killed_at:
                os.kill(proc.pid, signal.SIGKILL)
                break
            line = proc.stdout.readline()
            if not line:
                break   # the injected kill=1 crash point fired
            if line.startswith("ACK "):
                acked.append(int(line.split()[1]))
                if killed_at is None and kill_after_s is not None:
                    killed_at = time.time() + kill_after_s
    finally:
        try:
            os.kill(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        rest, _ = proc.communicate(timeout=30)
    acked += [int(x.split()[1]) for x in (rest or "").splitlines()
              if x.startswith("ACK ")]
    assert proc.returncode == -signal.SIGKILL
    assert acked == list(range(len(acked))), "a bulk acked out of order"
    return len(acked)


def _bulk_docs(node, ids):
    """get_doc of each id (routed), `_index` aside."""
    out = {}
    for did in sorted(ids):
        j = int(did[1:])
        try:
            got = node.get_doc("bulk", did, routing=f"r{j % 3}")
        except Exception as e:  # noqa: BLE001 — missing: the error's class
            got = {"error": type(e).__name__}
        out[did] = _strip_took(got)
    # a `_source` may come as the stored bytes
    return json.loads(json.dumps(out, sort_keys=True, default=json.loads))


def _acked_state(n_acked, ids):
    """The docs a port node without a data path holds after bulks
    0..n_acked-1."""
    node = Node(bulk_settings(), device="cpu")
    try:
        node.create_index("bulk", mappings=MAPPING)
        for b in range(n_acked):
            assert not node.bulk(bulk_ops(b))["errors"]
        return _bulk_docs(node, ids)
    finally:
        node.close()


def test_async_bulk_acked_survives_kill_nine(tmp_path):
    data_path = str(tmp_path / "bulk")
    n_acked = _run_bulk_worker("port", data_path,
                               kill_after_s=random.Random(5).uniform(0.5, 1.2))
    assert n_acked >= 2
    # the bulk in flight when the kill came may have touched these
    ids = set().union(*(bulk_ids(b) for b in range(n_acked)))
    ids -= bulk_ids(n_acked)
    node = Node(bulk_settings(data_path), device="cpu")
    try:
        assert node.verify_integrity()["clean"]
        assert node.indices["bulk"].shards[0].translog.durability == "async"
        got = _bulk_docs(node, ids)
    finally:
        node.close()
    assert got == _acked_state(n_acked, ids)


def test_crash_mid_bulk_recovers_as_the_reference(tmp_path):
    fault = "crash_point:site=translog:phase=append:rate=0.05:seed=11:kill=1"
    acked = {pkg: _run_bulk_worker(pkg, str(tmp_path / pkg), fault=fault)
             for pkg in ("port", "ref")}
    # both die at the same append, inside the same bulk
    assert acked["port"] == acked["ref"]
    n_acked = acked["port"]
    cut = bulk_ids(n_acked)
    ids = set().union(*(bulk_ids(b) for b in range(n_acked + 1)))
    port = Node(bulk_settings(str(tmp_path / "port")), device="cpu")
    ref = RefNode(bulk_settings(str(tmp_path / "ref")))
    try:
        got = {"port": _bulk_docs(port, ids), "ref": _bulk_docs(ref, ids)}
        assert port.verify_integrity()["clean"]
        dur = port.nodes_stats()["nodes"]["bulk"]["indices"]["durability"]
        assert dur["translog_truncated_bytes"] > 0
    finally:
        port.close()
        ref.close()
    # the port: every acked bulk's docs, nothing of the cut bulk
    assert got["port"] == _acked_state(n_acked, ids)
    # the reference: the same outside the cut bulk's ids; inside them,
    # the ops it wrote ahead of the crash as well
    assert ({d: v for d, v in got["port"].items() if d not in cut}
            == {d: v for d, v in got["ref"].items() if d not in cut})
    ahead = [d for d in sorted(cut) if got["ref"][d] != got["port"][d]]
    assert ahead, "the crash did not fall inside a bulk"
