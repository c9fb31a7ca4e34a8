"""Joins: the PyTorch port vs the JAX reference, on the CPU.

Nested documents (the block join: the `nested` type, the `nested` query
in every score mode, `_parents_match`, the nested / reverse_nested aggs,
deletes, compaction and the store) and parent / child (the `join` type,
`_parent` routing, has_child / has_parent / parent_id, the children
agg). The same seeded inputs go through both packages:

* every case of tests/test_nested_join.py (TestNestedQuery,
  TestNestedAggs, TestParentChild, TestNestedDeletion), through both
  packages' ShardReaders, with the reference test's own expectations;
* the five score modes on non-dyadic child scores whose sums cancel
  (function_score over the answers' votes), a boosted nested clause
  inside a bool, `_parents_match`, reverse_nested outside nested (the
  reference's error), has_child past JOIN_RESOLVE_WINDOW;
* the segment layout (hidden rows before their parent, `parent_of`),
  compaction (`concat_segments`, `merge_segments`) with a deleted
  parent, a store written by each package and read by the other, and
  durable nodes through deletes, a force merge and a restart;
* a `Node` over HTTP with `_parent` routing, against the reference's
  REST handlers;
* the order of XLA's compiled 2-D scatter (`.at[:, target].add / .max /
  .min`), which the to-parent fold repeats (`ops/ordered.parent_fold`),
  the nested mask the port builds on the device and the parents' live
  mask it binds once, against the reference's uploaded ones.

Tolerances: exact. Hits, totals, tie order, scores (f32, compared
through their JSON), bucket keys, counts and metric values equal the
reference's.
"""

import copy
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.mapping import MapperService as RefMapper
from elasticsearch_tpu.index.segment import (SegmentBuilder as RefBuilder,
                                             concat_segments as ref_concat,
                                             merge_segments as ref_merge)
from elasticsearch_tpu.index.store import Store as RefStore
from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.rest.server import RestDispatcher as RefDispatcher
from elasticsearch_tpu.search import executor as ref_executor
from elasticsearch_tpu.search.shard_searcher import ShardReader as RefReader
from elasticsearch_tpu.utils.errors import SearchParseError as RefParseError

from elasticsearch_tpu_torch import corpus
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import (SegmentBuilder,
                                                   concat_segments,
                                                   merge_segments)
from elasticsearch_tpu_torch.index.store import Store
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import cuda_scoring
from elasticsearch_tpu_torch.rest.server import RestDispatcher, RestServer
from elasticsearch_tpu_torch.search import executor
from elasticsearch_tpu_torch.search.shard_searcher import ShardReader
from elasticsearch_tpu_torch.utils.errors import SearchParseError

from tests.test_torch_segment import _assert_same_segment

torch.set_num_threads(1)

NESTED_MAPPING = {"properties": {
    "title": {"type": "text"},
    "comments": {"type": "nested", "properties": {
        "author": {"type": "keyword"},
        "stars": {"type": "integer"},
        "text": {"type": "text"}}}}}

POSTS = [
    ("1", {"title": "jax on tpu",
           "comments": [{"author": "alice", "stars": 5, "text": "great read"},
                        {"author": "bob", "stars": 2, "text": "too long"}]}),
    ("2", {"title": "xla fusion",
           "comments": [{"author": "alice", "stars": 1, "text": "meh"},
                        {"author": "carol", "stars": 4, "text": "nice"}]}),
    ("3", {"title": "pallas kernels", "comments": []}),
]

JOIN_MAPPING = {"properties": {
    "my_join": {"type": "join", "relations": {"question": "answer"}},
    "title": {"type": "text"},
    "body": {"type": "text"},
    "votes": {"type": "integer"}}}

QA_DOCS = [
    ("q1", {"my_join": "question", "title": "how to shard on tpu"}),
    ("q2", {"my_join": "question", "title": "what is pallas"}),
    ("a1", {"my_join": {"name": "answer", "parent": "q1"},
            "body": "use jax sharding", "votes": 10}),
    ("a2", {"my_join": {"name": "answer", "parent": "q1"},
            "body": "use shard_map", "votes": 3}),
    ("a3", {"my_join": {"name": "answer", "parent": "q2"},
            "body": "a kernel language for tpu", "votes": 7}),
]


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k != "took"}
    if isinstance(x, (list, tuple)):
        return [_strip(v) for v in x]
    return x


def _dump(x):
    return json.dumps(_strip(x), sort_keys=True)


def _segments(docs, mapping, seg_id="s0"):
    """(port segment, reference segment, port mapper, reference mapper)
    of the same docs."""
    out = []
    for mapper_cls, builder_cls in ((MapperService, SegmentBuilder),
                                    (RefMapper, RefBuilder)):
        svc = mapper_cls(mapping=mapping)
        b = builder_cls()
        for did, src in docs:
            b.add(svc.parse(did, json.dumps(src)))
        out.append((b.build(seg_id), svc))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def _readers(docs, mapping, live=None):
    pseg, rseg, psvc, rsvc = _segments(docs, mapping)
    lm = {} if live is None else {"s0": live(pseg)}
    return (ShardReader("idx", [pseg], dict(lm), psvc, device="cpu"),
            RefReader("idx", [rseg], dict(lm), rsvc))


def _both(readers, body):
    """One request through both readers: the same response."""
    port, ref = (r.search(copy.deepcopy(body)) for r in readers)
    assert _dump(port) == _dump(ref), body
    return port


def ids(resp):
    return [h["_id"] for h in resp["hits"]["hits"]]


@pytest.fixture(scope="module")
def posts():
    return _readers(POSTS, NESTED_MAPPING)


@pytest.fixture(scope="module")
def qa():
    return _readers(QA_DOCS, JOIN_MAPPING)


# -- tests/test_nested_join.py, through both packages ---------------------

ALICE_4 = {"nested": {"path": "comments", "query": {"bool": {"must": [
    {"term": {"comments.author": "alice"}},
    {"range": {"comments.stars": {"gte": 4}}}]}}}}
ALICE = {"path": "comments", "query": {"term": {"comments.author": "alice"}}}

NESTED_QUERIES = {
    # alice AND stars >= 4 within ONE comment: post 1 only
    "same_object": ({"query": ALICE_4}, ["1"]),
    # the same conjunction without nested scoping matches no parent
    "flattened": ({"query": {"bool": {"must": [
        {"term": {"comments.author": "alice"}},
        {"range": {"comments.stars": {"gte": 4}}}]}}}, []),
    "hidden_children": ({"query": {"match_all": {}}, "size": 20},
                        ["1", "2", "3"]),
    "score_mode_none": ({"query": {"nested": {**ALICE,
                                              "score_mode": "none"}}},
                        ["1", "2"]),
    "score_mode_sum": ({"query": {"nested": {**ALICE,
                                             "score_mode": "sum"}}},
                       ["1", "2"]),
}


@pytest.mark.parametrize("case", sorted(NESTED_QUERIES))
def test_nested_query_equals_reference(posts, case):
    body, want = NESTED_QUERIES[case]
    r = _both(posts, body)
    assert sorted(ids(r)) == sorted(want)
    if case == "hidden_children":
        assert r["hits"]["total"] == 3
    if case == "score_mode_none":
        assert all(h["_score"] == 1.0 for h in r["hits"]["hits"])
    if case == "score_mode_sum":
        assert all(h["_score"] > 0 for h in r["hits"]["hits"])


def test_nested_survives_merge():
    segs = []
    for mapper_cls, builder_cls, merge in (
            (MapperService, SegmentBuilder, merge_segments),
            (RefMapper, RefBuilder, ref_merge)):
        svc = mapper_cls(mapping=NESTED_MAPPING)
        b1, b2 = builder_cls(), builder_cls()
        b1.add(svc.parse("1", json.dumps(POSTS[0][1])))
        b2.add(svc.parse("2", json.dumps(POSTS[1][1])))
        b2.add(svc.parse("3", json.dumps(POSTS[2][1])))
        segs.append((merge([b1.build("a"), b2.build("b")], "m"), svc))
    _assert_same_segment(segs[0][0], segs[1][0])
    np.testing.assert_array_equal(segs[0][0].parent_of, segs[1][0].parent_of)
    readers = (ShardReader("idx", [segs[0][0]], {}, segs[0][1],
                           device="cpu"),
               RefReader("idx", [segs[1][0]], {}, segs[1][1]))
    assert ids(_both(readers, {"query": ALICE_4})) == ["1"]
    assert _both(readers, {"query": {"match_all": {}}})["hits"]["total"] == 3


NESTED_AGGS = {
    "counts_children": {"c": {"nested": {"path": "comments"}, "aggs": {
        "by_author": {"terms": {"field": "comments.author"}},
        "avg_stars": {"avg": {"field": "comments.stars"}}}}},
    "top_hits": {"c": {"nested": {"path": "comments"},
                       "aggs": {"th": {"top_hits": {"size": 2}}}}},
    "filter_keeps_scope": {"c": {"nested": {"path": "comments"}, "aggs": {
        "alice": {"filter": {"term": {"comments.author": "alice"}},
                  "aggs": {"avg": {"avg": {"field": "comments.stars"}}}}}}},
    "reverse_nested": {"c": {"nested": {"path": "comments"},
                             "aggs": {"back": {"reverse_nested": {}}}}},
}


@pytest.mark.parametrize("case", sorted(NESTED_AGGS) + ["respects_query"])
def test_nested_aggs_equal_reference(posts, case):
    if case == "respects_query":
        body = {"size": 0, "query": {"term": {"title": "jax"}},
                "aggs": {"c": {"nested": {"path": "comments"}, "aggs": {
                    "mx": {"max": {"field": "comments.stars"}}}}}}
    else:
        body = {"size": 0, "aggs": NESTED_AGGS[case]}
    agg = _both(posts, body)["aggregations"]["c"]
    if case == "counts_children":
        assert agg["doc_count"] == 4
        assert {b["key"]: b["doc_count"]
                for b in agg["by_author"]["buckets"]} == {
            "alice": 2, "bob": 1, "carol": 1}
        assert agg["avg_stars"]["value"] == pytest.approx(3.0)
    elif case == "respects_query":
        assert agg["doc_count"] == 2 and agg["mx"]["value"] == 5.0
    elif case == "top_hits":
        hits = agg["th"]["hits"]["hits"]
        assert len(hits) == 2 and all("author" in h["_source"] for h in hits)
    elif case == "filter_keeps_scope":
        assert agg["alice"]["doc_count"] == 2
        assert agg["alice"]["avg"]["value"] == pytest.approx(3.0)
    else:
        assert agg["back"]["doc_count"] == 2


PARENT_CHILD = {
    "has_child": ({"query": {"has_child": {
        "type": "answer", "query": {"match": {"body": "sharding"}}}}},
        ["q1"]),
    "has_child_min_children": ({"query": {"has_child": {
        "type": "answer", "query": {"match_all": {}},
        "min_children": 2}}}, ["q1"]),
    "has_child_max_children": ({"query": {"has_child": {
        "type": "answer", "query": {"match_all": {}},
        "max_children": 1}}}, ["q2"]),
    "has_parent": ({"query": {"has_parent": {
        "parent_type": "question",
        "query": {"match": {"title": "pallas"}}}}}, ["a3"]),
    "parent_id": ({"query": {"parent_id": {"type": "answer", "id": "q1"}}},
                  ["a1", "a2"]),
    "has_child_inside_bool": ({"query": {"bool": {"must": [
        {"has_child": {"type": "answer",
                       "query": {"range": {"votes": {"gte": 5}}}}},
        {"match": {"title": "tpu"}}]}}}, ["q1"]),
}


@pytest.mark.parametrize("case", sorted(PARENT_CHILD))
def test_parent_child_equals_reference(qa, case):
    body, want = PARENT_CHILD[case]
    assert sorted(ids(_both(qa, body))) == want


def test_children_agg_equals_reference(qa):
    r = _both(qa, {"size": 0, "query": {"match": {"title": "shard"}},
                   "aggs": {"answers": {"children": {"type": "answer"},
                                        "aggs": {"top_votes": {
                                            "max": {"field": "votes"}}}}}})
    agg = r["aggregations"]["answers"]
    assert agg["doc_count"] == 2 and agg["top_votes"]["value"] == 10.0


def test_deleted_parent_hides_children():
    def live(seg):
        m = np.zeros(seg.capacity, dtype=bool)
        m[: seg.num_docs] = True
        m[seg.id_map["1"]] = False       # delete post 1
        return m
    readers = _readers(POSTS, NESTED_MAPPING, live)
    # bob only commented on post 1
    assert ids(_both(readers, {"query": {"nested": {
        "path": "comments",
        "query": {"term": {"comments.author": "bob"}}}}})) == []
    r = _both(readers, {"size": 0, "aggs": {"c": {
        "nested": {"path": "comments"}}}})
    assert r["aggregations"]["c"]["doc_count"] == 2


# -- non-dyadic, cancelling child scores: every score mode bit for bit -----

def _qa_nested(n=300, seed=5, hot=((0, 400), (7, 60))):
    return corpus.qa_nested_docs(n, seed=seed, hot=hot)


@pytest.fixture(scope="module")
def qa_nested():
    return _readers(_qa_nested(), corpus.QA_NESTED_MAPPING)


def _votes(mode, factor=1.37, boost=1.0):
    """A nested query whose child scores are the answers' votes (of both
    signs) times a non-dyadic factor: sums that cancel, none of them a
    short binary fraction."""
    return {"nested": {"path": "answers", "score_mode": mode,
                       "boost": boost, "query": {"function_score": {
                           "query": {"match_all": {}},
                           "functions": [{"field_value_factor": {
                               "field": "answers.score",
                               "factor": factor}}],
                           "boost_mode": "replace"}}}}


@pytest.mark.parametrize("mode", corpus.NESTED_SCORE_MODES)
def test_score_modes_bit_for_bit(qa_nested, mode):
    """Each score mode over the votes (cancelling sums) and over a BM25
    match of the answers' body: hits, ties and scores equal the
    reference's compiled segment program."""
    r = _both(qa_nested, {"query": _votes(mode), "size": 50})
    scores = [h["_score"] for h in r["hits"]["hits"]]
    assert len(scores) == 50
    assert len(set(scores)) == 1 if mode == "none" else len(set(scores)) > 5
    words = corpus.vocab()
    _both(qa_nested, {"query": {"nested": {
        "path": "answers", "score_mode": mode,
        "query": {"match": {"answers.body": f"{words[3]} {words[40]}"}}}},
        "size": 30})


def test_boosted_nested_clause_in_bool(qa_nested):
    """A nested clause with a non-unit boost inside a bool meets the
    clause sum as in the reference's compiled program."""
    words = corpus.vocab()
    for mode in ("sum", "avg", "max"):
        r = _both(qa_nested, {"query": {"bool": {
            "should": [{"match": {"title": f"{words[0]} {words[9]}"}},
                       _votes(mode, factor=0.731, boost=2.7)],
            "minimum_should_match": 1}}, "size": 40})
        assert r["hits"]["total"] > 40


def test_score_modes_in_one_msearch(qa_nested):
    """The five modes and the boosted bool batched in one msearch give
    each request's response alone."""
    bodies = [{"query": _votes(m), "size": 20}
              for m in corpus.NESTED_SCORE_MODES]
    bodies += corpus.qa_nested_mixes(10, seed=9)["nested_match"]
    port = qa_nested[0].msearch(copy.deepcopy(bodies))
    ref = [qa_nested[1].search(copy.deepcopy(b)) for b in bodies]
    assert _dump(port) == _dump(ref)


def test_nested_agg_mix_equals_reference(qa_nested):
    for body in corpus.qa_nested_mixes(6, seed=10)["nested_aggs"]:
        _both(qa_nested, body)


def test_parents_match_equals_reference(qa_nested):
    """The nested agg's scope filter on its own: nested rows whose parent
    matches, searched in the nested scope."""
    words = corpus.vocab()
    for q in ({"match": {"title": words[2]}}, {"match_all": {}},
              {"term": {"user": "u1"}}):
        r = _both(qa_nested, {"query": {"_parents_match": {"query": q}},
                              "_nested_scope": "answers", "size": 50})
        assert r["hits"]["total"] > 0


@pytest.mark.parametrize("rows", [1, 2])
def test_parents_match_in_row_chunks(qa_nested, monkeypatch, rows):
    """A batch evaluated in chunks of `rows` rows (the transient budget
    cut down to that): `_parents_match`'s shared live mask serves every
    chunk, and the nested aggs (their scope shifts) and the nested query
    give the reference's responses."""
    port, ref = qa_nested
    cap = max(s.capacity for s in port.segments)
    monkeypatch.setattr(executor, "_CHUNK_ELEMS", rows * cap)
    words = corpus.vocab()
    bodies = [{"query": {"_parents_match": {"query": {
        "match": {"title": words[2 + i]}}}}, "_nested_scope": "answers",
        "size": 20} for i in range(4)]
    bodies += corpus.qa_nested_mixes(4, seed=12)["nested_aggs"]
    bodies += [{"query": _votes(m), "size": 20}
               for m in corpus.NESTED_SCORE_MODES]
    got = port.msearch([copy.deepcopy(b) for b in bodies])
    want = [ref.search(copy.deepcopy(b)) for b in bodies]
    assert _dump(got) == _dump(want)
    assert sum(r["hits"]["total"] for r in got[:4]) > 0


def test_reverse_nested_outside_nested_raises(posts):
    body = {"size": 0, "aggs": {"back": {"reverse_nested": {}}}}
    with pytest.raises(SearchParseError) as port:
        posts[0].search(copy.deepcopy(body))
    with pytest.raises(RefParseError) as ref:
        posts[1].search(copy.deepcopy(body))
    assert str(port.value) == str(ref.value)


QA_JOIN_QUESTIONS = 1500


@pytest.fixture(scope="module")
def qa_join():
    # a hot question with 800 answers: has_child's rare body words match
    # two of them
    docs = corpus.qa_join_docs(QA_JOIN_QUESTIONS, seed=6,
                               hot=((0, 800), (3, 60)))
    return _readers([(d, s) for d, s, _r in docs], corpus.QA_JOIN_MAPPING)


def test_has_child_past_resolve_window(qa_join, monkeypatch):
    """Past JOIN_RESOLVE_WINDOW hits the join query is collected again in
    one top-k of all of them (the second pass)."""
    for cls in (ShardReader, RefReader):
        monkeypatch.setattr(cls, "JOIN_RESOLVE_WINDOW", 7)
    r = _both(qa_join, {"query": {"has_child": {
        "type": "answer", "query": {"match_all": {}}, "min_children": 3}},
        "size": 100})
    assert r["hits"]["total"] > 7
    _both(qa_join, {"query": {"has_parent": {
        "parent_type": "question", "query": {"match_all": {}}}},
        "size": 20})


@pytest.mark.parametrize("mix", corpus.QA_JOIN_MIXES)
def test_join_mixes_equal_reference(qa_join, mix):
    bodies = corpus.qa_join_mixes(8, seed=12,
                                  n_questions=QA_JOIN_QUESTIONS)[mix]
    hits = [_both(qa_join, body)["hits"]["total"] for body in bodies]
    if mix != "children_agg":
        assert sum(hits) > 0


def test_join_mixes_in_one_msearch(qa_join, monkeypatch):
    """The port resolves the join nodes of a batch's requests with one
    auxiliary msearch a round (two rounds for a has_child inside a
    has_parent, a second pass past the window): every response equals
    the reference's request alone."""
    monkeypatch.setattr(ShardReader, "JOIN_RESOLVE_WINDOW", 40)
    monkeypatch.setattr(RefReader, "JOIN_RESOLVE_WINDOW", 40)
    mixes = corpus.qa_join_mixes(6, seed=13, n_questions=QA_JOIN_QUESTIONS)
    bodies = [b for m in corpus.QA_JOIN_MIXES for b in mixes[m]]
    bodies.append({"query": {"has_parent": {
        "parent_type": "question", "query": {"bool": {"must": [
            {"has_child": {"type": "answer", "min_children": 3,
                           "query": {"match_all": {}}}}]}}}},
        "size": 30})
    bodies.append({"query": {"match_all": {}}, "size": 3})
    port = qa_join[0].msearch(copy.deepcopy(bodies))
    ref = [qa_join[1].search(copy.deepcopy(b)) for b in bodies]
    assert _dump(port) == _dump(ref)
    assert port[-2]["hits"]["total"] > 0


# -- mappings and the segment layout -----------------------------------------

@pytest.mark.parametrize("mapping", [NESTED_MAPPING, JOIN_MAPPING,
                                     corpus.QA_NESTED_MAPPING,
                                     corpus.QA_JOIN_MAPPING])
def test_mapping_renders_as_reference(mapping):
    port, ref = MapperService(mapping=mapping), RefMapper(mapping=mapping)
    assert port.mapping_dict() == ref.mapping_dict()
    assert port.nested_paths == ref.nested_paths
    pj, rj = port.join_field(), ref.join_field()
    assert (pj is None) == (rj is None)
    if pj is not None:
        assert (pj.name, pj.relations) == (rj.name, rj.relations)


def test_parent_mapping_and_join_errors_as_reference():
    legacy = {"_parent": {"type": "question"}, "_routing": {"required": True},
              "properties": {"body": {"type": "text"}}}
    port, ref = MapperService(mapping=legacy), RefMapper(mapping=legacy)
    assert (port.parent_type, port.routing_required) \
        == (ref.parent_type, ref.routing_required) == ("question", True)
    from elasticsearch_tpu.utils.errors import \
        MapperParsingError as RefMapperError
    from elasticsearch_tpu_torch.utils.errors import MapperParsingError
    bad_docs = ({"my_join": {"name": "comment", "parent": "q1"}},
                {"my_join": "nope"})
    for src in bad_docs:
        with pytest.raises(MapperParsingError) as p:
            MapperService(mapping=JOIN_MAPPING).parse("x", src)
        with pytest.raises(RefMapperError) as r:
            RefMapper(mapping=JOIN_MAPPING).parse("x", src)
        assert str(p.value) == str(r.value)
    bad_maps = ({"properties": {"j": {"type": "join"}}},
                {"properties": {"n": {"type": "nested", "properties": {}}},
                 "n": 1})
    with pytest.raises(MapperParsingError):
        MapperService(mapping=bad_maps[0])
    with pytest.raises(RefMapperError):
        RefMapper(mapping=bad_maps[0])
    with pytest.raises(MapperParsingError):
        MapperService(mapping=NESTED_MAPPING).parse(
            "x", {"comments": [1, 2]})


@pytest.mark.parametrize("which", ["posts", "qa_nested", "qa", "qa_join"])
def test_segment_layout_equals_reference(which):
    docs, mapping = {
        "posts": (POSTS, NESTED_MAPPING),
        "qa_nested": (_qa_nested(80), corpus.QA_NESTED_MAPPING),
        "qa": (QA_DOCS, JOIN_MAPPING),
        "qa_join": ([(d, s) for d, s, _r in corpus.qa_join_docs(40, seed=6)],
                    corpus.QA_JOIN_MAPPING)}[which]
    pseg, rseg, _p, _r = _segments(docs, mapping)
    _assert_same_segment(pseg, rseg)
    assert (pseg.parent_of is None) == (rseg.parent_of is None)
    if rseg.parent_of is not None:
        assert pseg.parent_of.dtype == rseg.parent_of.dtype
        np.testing.assert_array_equal(pseg.parent_of, rseg.parent_of)
        np.testing.assert_array_equal(pseg.primary_mask(),
                                      rseg.primary_mask())
    assert pseg.has_nested == rseg.has_nested == (which in ("posts",
                                                            "qa_nested"))


@pytest.mark.parametrize("how", ["concat", "merge"])
def test_compaction_with_a_deleted_parent(how):
    """A base and a delta folded into one segment, a parent of each
    deleted: its nested rows go with it; the result and its responses
    equal the reference's."""
    docs = _qa_nested(120, seed=8, hot=((1, 30),))
    out = []
    for mapper_cls, builder_cls, concat, merge, reader_cls, kw in (
            (MapperService, SegmentBuilder, concat_segments, merge_segments,
             ShardReader, {"device": "cpu"}),
            (RefMapper, RefBuilder, ref_concat, ref_merge, RefReader, {})):
        svc = mapper_cls(mapping=corpus.QA_NESTED_MAPPING)
        segs = []
        for seg_id, part in (("base", docs[:80]), ("delta", docs[80:])):
            b = builder_cls()
            for did, src in part:
                b.add(svc.parse(did, json.dumps(src)))
            segs.append(b.build(seg_id))
        live = {}
        for seg, dead in zip(segs, ("1", "85")):
            m = np.zeros(seg.capacity, dtype=bool)
            m[: seg.num_docs] = True
            m[seg.id_map[dead]] = False
            live[seg.seg_id] = m
        if how == "concat":
            folded = concat(segs, "folded", live_masks=live)
        else:
            folded = merge(segs, "folded", live_masks=live)
        out.append((folded, reader_cls("qa", [folded], {}, svc, **kw)))
    _assert_same_segment(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][0].parent_of, out[1][0].parent_of)
    readers = (out[0][1], out[1][1])
    for mode in corpus.NESTED_SCORE_MODES:
        _both(readers, {"query": _votes(mode), "size": 20})
    for body in corpus.qa_nested_mixes(4, seed=14)["nested_aggs"]:
        _both(readers, body)
    assert "1" not in readers[0].segments[0].id_map


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_store_round_trip_across_packages(tmp_path, writer):
    """A nested segment saved by either package's store loads in both as
    the same segment, `parent_of` included, and answers alike."""
    pseg, rseg, psvc, rsvc = _segments(_qa_nested(60, seed=9),
                                       corpus.QA_NESTED_MAPPING)
    live = np.zeros(pseg.capacity, dtype=bool)
    live[: pseg.num_docs] = True
    live[pseg.id_map["4"]] = False
    path = str(tmp_path / writer)
    store = Store(path) if writer == "port" else RefStore(path)
    stem = store.save_segment(pseg if writer == "port" else rseg, live)
    sid = pseg.seg_id
    a, la = Store(path).load_segment(sid, stem=stem)
    b, lb = RefStore(path).load_segment(sid, stem=stem)
    _assert_same_segment(a, b)
    np.testing.assert_array_equal(a.parent_of, b.parent_of)
    np.testing.assert_array_equal(a.parent_of, pseg.parent_of)
    np.testing.assert_array_equal(la, lb)
    readers = (ShardReader("qa", [a], {sid: la}, psvc, device="cpu"),
               RefReader("qa", [b], {sid: lb}, rsvc))
    for mode in ("sum", "max"):
        _both(readers, {"query": _votes(mode), "size": 20})
    _both(readers, corpus.qa_nested_mixes(2, seed=15)["nested_aggs"][0])


# -- durable nodes: deletes, a force merge and a restart ---------------------

def _node_settings(path):
    return {"node.name": "j0", "path.data": path,
            "index.number_of_shards": 2}


def _nodes(tmp_path, name):
    return [Node(_node_settings(str(tmp_path / f"{name}-port")),
                 device="cpu"),
            RefNode(_node_settings(str(tmp_path / f"{name}-ref")))]


def _search_all(nodes, bodies):
    out = []
    for n in nodes:
        out.append([n.search(idx, copy.deepcopy(b)) for idx, b in bodies])
    assert _dump(out[0]) == _dump(out[1])
    return out[0]


def _join_bodies():
    words = corpus.vocab()
    bodies = [("nested", {"query": _votes(m), "size": 15})
              for m in corpus.NESTED_SCORE_MODES]
    bodies += [("nested", b)
               for b in corpus.qa_nested_mixes(3, seed=16)["nested_aggs"]]
    bodies += [("join", b) for m in corpus.QA_JOIN_MIXES
               for b in corpus.qa_join_mixes(2, seed=17, n_questions=60)[m]]
    bodies.append(("join", {"query": {"has_child": {
        "type": "answer", "query": {"match": {"body": words[1]}}}}}))
    return bodies


def test_nodes_through_deletes_merge_and_restart(tmp_path):
    nested_docs = _qa_nested(60, seed=18, hot=((2, 40),))
    join_docs = corpus.qa_join_docs(60, seed=19, hot=((1, 25),))
    bodies = _join_bodies()
    nodes = _nodes(tmp_path, "jn")
    try:
        for n in nodes:
            n.create_index("nested", mappings=corpus.QA_NESTED_MAPPING)
            n.create_index("join", mappings=corpus.QA_JOIN_MAPPING)
            n.bulk([("index", {"_index": "nested", "_id": d, "doc": s})
                    for d, s in nested_docs], refresh=True)
            n.bulk([("index", {"_index": "join", "_id": d, "doc": s,
                               "_routing": r}) for d, s, r in join_docs],
                   refresh=True)
        _search_all(nodes, bodies)
        for n in nodes:
            # a question with nested answers, and a parent question
            n.delete_doc("nested", "2")
            n.delete_doc("join", "q1", routing="q1")
            n.index_doc("nested", "5", dict(nested_docs[7][1], title="new"))
            n.refresh(None)
        after_delete = _search_all(nodes, bodies)
        for n in nodes:
            n.force_merge(None)
        _search_all(nodes, bodies)
        for n in nodes:
            n.flush(None)
            n.close()
        nodes = _nodes(tmp_path, "jn")
        restarted = _search_all(nodes, bodies)
        assert _dump(restarted) == _dump(after_delete)
    finally:
        for n in nodes:
            n.close()


# -- a Node over HTTP with _parent routing -----------------------------------

PARENT_MAPPING = {"_parent": {"type": "question"},
                  "properties": {**JOIN_MAPPING["properties"]}}


def _as_http(method, dispatch):
    """A dispatcher's answer as the HTTP server sends it: a RestStatus's
    status, 201 for a created doc, an error's status and body."""
    from elasticsearch_tpu.utils.errors import ElasticsearchTpuError
    try:
        r = dispatch()
    except ElasticsearchTpuError as e:
        return e.status, {"error": e.to_dict(), "status": e.status}
    if type(r).__name__ == "RestStatus":
        return r.status, r.payload
    if method in ("POST", "PUT") and isinstance(r, dict) and r.get("created"):
        return 201, r
    return 200, r


def test_node_over_http_with_parent_routing():
    """Writes with `parent` (the legacy `_parent` mapping: routing
    required) over the port's HTTP server give the reference's REST
    responses: routed by the parent, `_parent` on a get, a get without
    it refused, has_child / has_parent / parent_id / children served."""
    port_node = Node({"node.name": "p0"}, device="cpu")
    ref_node = RefNode({"node.name": "p0"})
    srv = RestServer(port_node, host="127.0.0.1", port=0).start()
    ref = RefDispatcher(ref_node)

    def call(method, path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                     data=data, method=method,
                                     headers={"Content-Type":
                                              "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as f:
                return f.status, json.loads(f.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def both(method, path, params=None, body=None):
        q = "&".join(f"{k}={v}" for k, v in (params or {}).items())
        got = call(method, path + (f"?{q}" if q else ""), body)
        want = _as_http(method, lambda: ref.dispatch(
            method, path, params or {}, copy.deepcopy(body)))
        assert _dump(got) == _dump(want), (method, path, params)
        return got

    try:
        both("PUT", "/qa", body={"settings": {"number_of_shards": 2},
                                 "mappings": PARENT_MAPPING})
        for did, src in QA_DOCS:
            parent = src["my_join"].get("parent") \
                if isinstance(src["my_join"], dict) else None
            params = {"parent": parent} if parent else {"routing": did}
            both("PUT", f"/qa/_doc/{did}", params, src)
        status, _r = both("GET", "/qa/_doc/a1")          # no parent
        assert status == 400
        status, r = both("GET", "/qa/_doc/a1", {"parent": "q1"})
        assert status == 200 and r["_parent"] == "q1"
        status, r = both("GET", "/qa/_doc/a2",
                         {"parent": "q1", "fields": "_parent,_routing,votes"})
        assert r["fields"]["_parent"] == "q1" and "_source" not in r
        both("POST", "/qa/_refresh")
        for case in sorted(PARENT_CHILD):
            both("POST", "/qa/_search", body=PARENT_CHILD[case][0])
        both("POST", "/qa/_search", body={
            "size": 0, "aggs": {"answers": {"children": {"type": "answer"},
                                            "aggs": {"v": {"sum": {
                                                "field": "votes"}}}}}})
        status, r = both("POST", "/qa/_update/a2",
                         {"parent": "q1", "fields": "_parent,votes,_source"},
                         {"doc": {"votes": 11}})
        assert r["get"]["fields"] == {"_parent": "q1", "votes": [11]}
        both("DELETE", "/qa/_doc/a1", {"parent": "q1"})
        both("POST", "/qa/_refresh")
        both("POST", "/qa/_search", body=PARENT_CHILD["parent_id"][0])
        both("POST", "/qa/_search", body=PARENT_CHILD["has_child"][0])
    finally:
        srv.stop()
        port_node.close()
        ref_node.close()


def test_bulk_ignores_parent_metadata_as_reference():
    """The reference's `_bulk` reads `_routing` / `routing` from an
    action's metadata and no `parent` / `_parent` (ROADMAP Queue 3): a
    child sent with `parent` alone is routed by its own id and keeps no
    `_parent`. The port answers the same; `_routing` places it."""
    port = RestDispatcher(Node({"node.name": "b0"}, device="cpu"))
    ref = RefDispatcher(RefNode({"node.name": "b0"}))
    lines = [{"index": {"_index": "qa", "_id": "q1"}},
             {"my_join": "question", "title": "tpu"},
             {"index": {"_index": "qa", "_id": "a1", "parent": "q1"}},
             {"my_join": {"name": "answer", "parent": "q1"}, "body": "x"},
             {"index": {"_index": "qa", "_id": "a2", "_parent": "q1"}},
             {"my_join": {"name": "answer", "parent": "q1"}, "body": "y"},
             {"index": {"_index": "qa", "_id": "a3", "_routing": "q1"}},
             {"my_join": {"name": "answer", "parent": "q1"}, "body": "z"}]
    try:
        for method, path, params, body in (
                ("PUT", "/qa", {}, {"settings": {"number_of_shards": 4},
                                    "mappings": JOIN_MAPPING}),
                ("POST", "/_bulk", {"refresh": "true"}, lines),
                ("GET", "/qa/_doc/a1", {}, None),
                ("GET", "/qa/_doc/a3", {"routing": "q1"}, None),
                ("POST", "/qa/_search", {}, {"query": {"has_child": {
                    "type": "answer", "query": {"match_all": {}},
                    "min_children": 1}}})):
            got = _as_http(method, lambda: port.dispatch(
                method, path, params, copy.deepcopy(body)))
            want = _as_http(method, lambda: ref.dispatch(
                method, path, params, copy.deepcopy(body)))
            assert _dump(got) == _dump(want), (method, path)
            if path == "/qa/_doc/a1":
                assert "_parent" not in got[1]
    finally:
        port.node.close()
        ref.node.close()


# -- XLA's scatter order and the masks built on the device -------------------

def _fold_inputs(rng, B=4, cap=4096):
    parent_of = np.full(cap, -1, np.int32)
    i = 0
    while i < cap - 1:
        k = min(int(rng.integers(0, 300)), cap - 1 - i)
        parent_of[i:i + k] = i + k
        i += k + 1
    target = np.where(parent_of >= 0, parent_of,
                      np.arange(cap, dtype=np.int32))
    vals = (rng.standard_normal((B, cap))
            * 10.0 ** rng.integers(-3, 4, (B, cap))).astype(np.float32)
    ok = (rng.random((B, cap)) < 0.7) & (parent_of >= 0)[None]
    return target, vals, ok


@pytest.mark.parametrize("mode", ["none", "sum", "max", "min"])
def test_parent_fold_is_xla_scatter(mode):
    """The reference's compiled 2-D scatters over [B, cap] child scores
    fold each parent's indices in ascending order: the plain to-parent
    fold gives their bits (non-dyadic, cancelling sums; NaNs of both
    signs with payloads and signed zeros for max / min), and folding in
    descending order would not."""
    rng = np.random.default_rng(21)
    target, vals, ok = _fold_inputs(rng)
    B, cap = vals.shape
    if mode in ("max", "min"):
        m = rng.random((B, cap))
        vals[m < 0.02] = np.float32("nan")
        vals[(m >= 0.02) & (m < 0.04)] = -np.float32("nan")
        vals[(m >= 0.04) & (m < 0.06)] = 0.0
        vals[(m >= 0.06) & (m < 0.08)] = -0.0
        bits = vals.view(np.uint32)
        nan = np.isnan(vals)
        bits[nan] |= rng.integers(1, 1 << 22, int(nan.sum())).astype(
            np.uint32)
    fn = {"none": lambda cs, o: jnp.zeros((B, cap)).at[:, target].add(
              o.astype(jnp.float32)),
          "sum": lambda cs, o: jnp.zeros((B, cap)).at[:, target].add(
              jnp.where(o, cs, 0.0)),
          "max": lambda cs, o: jnp.full((B, cap), -jnp.inf).at[
              :, target].max(jnp.where(o, cs, -jnp.inf)),
          "min": lambda cs, o: jnp.full((B, cap), jnp.inf).at[
              :, target].min(jnp.where(o, cs, jnp.inf))}[mode]
    want = np.asarray(jax.jit(fn)(vals, ok))
    layout = cuda_scoring.block_join_layout(torch.from_numpy(target))
    cnt, val = cuda_scoring.to_parent_fold(torch.from_numpy(vals),
                                           torch.from_numpy(ok), layout,
                                           mode)
    got = cnt if mode == "none" else val
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    if mode == "sum":
        desc = np.zeros((B, cap), np.float32)
        for j in reversed(range(cap)):
            desc[:, target[j]] = (desc[:, target[j]]
                                  + np.where(ok[:, j], vals[:, j],
                                             np.float32(0)))
        assert (desc.view(np.int32) != want.view(np.int32)).any()


def test_nested_masks_equal_reference_masks(qa_nested):
    """The port binds a path ordinal per row and builds the nested scope
    on the device, and binds `_parents_match`'s parent liveness once for
    the batch; the masks equal the [B, cap] ones the reference uploads."""
    from elasticsearch_tpu.search.query_dsl import QueryParser as RefParser
    from elasticsearch_tpu_torch.search.query_dsl import QueryParser
    port, ref = qa_nested
    pseg, rseg = port.segments[0], ref.segments[0]
    bodies = [_votes("sum"), _votes("max", boost=2.0),
              {"_parents_match": {"query": {"match_all": {}}}}]
    for body in bodies:
        pq = QueryParser(port.mappers).parse(body)
        rq = RefParser(ref.mappers).parse(body)
        pb = [executor.QueryBinder(pseg, port.mappers,
                                   live=port.live[pseg.seg_id]).bind(pq)] * 3
        rb = [ref_executor.QueryBinder(rseg, ref.mappers,
                                       live=ref.live[rseg.seg_id]).bind(rq)
              ] * 3
        pd, pp = executor.finalize(pb)
        rd, rp = ref_executor.finalize(rb)
        dev = executor.device_arrays(pseg, torch.device("cpu"))
        if pd[0] == "nested":
            mask = (dev["kw"]["_nested_path"][None, :]
                    == torch.from_numpy(pp[1])[:, None])
            np.testing.assert_array_equal(mask.numpy(), rp[1])
        else:
            # the port binds the parents' liveness once, [1, cap], where
            # every request's binder saw the same mask; the reference's
            # [B, cap] stack of it
            assert pp[1].shape == (1, pseg.capacity)
            np.testing.assert_array_equal(
                np.broadcast_to(pp[1], rp[1].shape), rp[1])
