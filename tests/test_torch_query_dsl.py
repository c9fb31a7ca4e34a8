"""The query DSL's remaining queries: the PyTorch port vs the JAX
reference, on the CPU.

Both packages parse the same request bodies (exists / missing, ids,
term / terms on `_id`, wildcard, fuzzy, regexp, span_multi,
more_like_this, common, wrapper, indices, type, limit, template,
filtered, boosting, dis_max, and / or / not, query_string /
simple_query_string, function_score) against one seeded corpus, bind
them to one segment and evaluate them:

* the AST is the reference's, node for node and field for field;
* `finalize` gives the reference's desc and params (dtypes included),
  except `ids`, which the port binds to doc indices and turns into the
  reference's [B, cap] mask on the device (held equal here);
* each new `eval_node` kind (exists_*, ids, boosting, fnscore with every
  score function kind) gives the reference's score and match tensors,
  the reference run as a compiled program (jax.jit), as it runs in its
  searcher;
* `_edit_distance_le` and the wildcard / regexp / fuzzy expansions pick
  the same terms.

Tolerances: all exact (bit for bit), except function_score over two or
more unfiltered functions summed (tests/test_torch_function_score.py).
"""

import base64
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.mapping import MapperService as RefMapper
from elasticsearch_tpu.index.segment import SegmentBuilder as RefBuilder
from elasticsearch_tpu.search import executor as ref_ex
from elasticsearch_tpu.search.query_dsl import QueryParser as RefParser

from elasticsearch_tpu_torch import corpus
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.search import executor as ex
from elasticsearch_tpu_torch.search.query_dsl import QueryParser

torch.set_num_threads(1)

N_DOCS = 900


def _docs():
    docs = corpus.make_docs(N_DOCS, seed=42, long_every=300)
    # some docs without body / size, so exists and missing split the index
    return [(d, {k: v for k, v in doc.items()
                 if not ((k == "body" and int(d) % 7 == 0)
                         or (k == "size" and int(d) % 11 == 0))})
            for d, doc in docs]


@pytest.fixture(scope="module")
def built():
    out = {}
    docs = _docs()
    sources = {d: doc for d, doc in docs}
    for tag, mapper_cls, builder_cls in (("port", MapperService,
                                          SegmentBuilder),
                                         ("ref", RefMapper, RefBuilder)):
        svc = mapper_cls(mapping=corpus.MAPPING)
        b = builder_cls()
        for did, d in docs:
            b.add(svc.parse(did, d))
        out[tag] = (svc, b.build("s0"))
    out["lookup"] = sources.get
    return out


BODIES = {
    "exists": {"exists": {"field": "body"}},
    "exists_num": {"exists": {"field": "size"}},
    "exists_kw": {"exists": {"field": "status"}},
    "exists_absent": {"exists": {"field": "nosuch"}},
    "missing": {"missing": {"field": "size"}},
    "ids": {"ids": {"values": ["3", "17", "99", "nope", "3"]}},
    "term_id": {"term": {"_id": "5"}},
    "terms_uid": {"terms": {"_uid": ["_doc#8", "12"]}},
    "wildcard": {"wildcard": {"message": "p00*"}},
    "wildcard_obj": {"wildcard": {"message": {"wildcard": "p0?1*",
                                              "boost": 2.0}}},
    "wildcard_kw": {"wildcard": {"status": "4*"}},
    "fuzzy": {"fuzzy": {"message": "htm"}},
    "fuzzy_int": {"fuzzy": {"message": {"value": "p00120", "fuzziness": 1,
                                        "boost": 1.5}}},
    "regexp": {"regexp": {"message": "p0[0-1][0-9]+"}},
    "regexp_kw": {"regexp": {"status": {"value": "[24]0.", "boost": 3.0}}},
    "span_multi": {"span_multi": {"match": {"prefix": {"message": "p01"}}}},
    "mlt": {"more_like_this": {"fields": ["message"],
                               "like": "get post html images p00268 news",
                               "min_term_freq": 1, "min_doc_freq": 1}},
    "mlt_ids": {"mlt": {"fields": ["message"], "ids": ["4", "9"],
                        "min_term_freq": 1, "min_doc_freq": 1,
                        "max_query_terms": 6}},
    "mlt_unlike": {"more_like_this": {
        "like": ["get html images", {"_id": "2"}],
        "unlike": "html", "min_term_freq": 1, "min_doc_freq": 2,
        "minimum_should_match": "50%", "include": True}},
    "common": {"common": {"message": {"query": "get html images",
                                      "low_freq_operator": "and"}}},
    "wrapper": {"wrapper": {"query": base64.b64encode(json.dumps(
        {"match": {"message": "post"}}).encode()).decode()}},
    "indices_hit": {"indices": {"indices": ["logs"],
                                "query": {"match": {"message": "get"}}}},
    "indices_miss": {"indices": {"indices": ["other"],
                                 "query": {"match": {"message": "get"}},
                                 "no_match_query": "none"}},
    "indices_miss_q": {"indices": {"index": "other",
                                   "query": {"match": {"message": "get"}},
                                   "no_match_query": {"term": {
                                       "status": "404"}}}},
    "type": {"type": {"value": "_doc"}},
    "type_other": {"type": {"value": "tweet"}},
    "limit": {"limit": {"value": 5}},
    "template": {"template": {"inline": {"match": {"message": "{{w}}"}},
                              "params": {"w": "post"}}},
    "template_str": {"template": {"query": '{"term": {"status": "{{s}}"}}',
                                  "params": {"s": "404"}}},
    "filtered": {"filtered": {"query": {"match": {"message": "get html"}},
                              "filter": {"range": {"size": {"gte": 5000}}}}},
    "filtered_noq": {"filtered": {"filter": {"term": {"status": "200"}}}},
    "boosting": {"boosting": {"positive": {"match": {"message": "get"}},
                              "negative": {"term": {"status": "404"}},
                              "negative_boost": 0.3}},
    "dis_max": {"dis_max": {"queries": [{"match": {"message": "get"}},
                                        {"match": {"message": "html"}}],
                            "boost": 1.2}},
    "and": {"and": [{"match": {"message": "get"}},
                    {"range": {"size": {"lte": 50000}}}]},
    "and_filters": {"and": {"filters": [{"exists": {"field": "body"}},
                                        {"term": {"status": "200"}}]}},
    "or": {"or": [{"match": {"message": "post"}},
                  {"range": {"size": {"lte": 500}}}]},
    "not": {"not": {"match": {"message": "get"}}},
    "not_filter": {"not": {"filter": {"term": {"status": "200"}}}},
    "qs_and_not": {"query_string": {
        "query": "message:get AND message:html NOT message:404"}},
    "qs_or": {"query_string": {"query": "get OR post"}},
    "qs_default": {"query_string": {"query": "get html -images +post",
                                    "default_field": "message",
                                    "default_operator": "and"}},
    "qs_bare": {"query_string": "message:news"},
    "qs_empty": {"query_string": {"query": ""}},
    "simple_qs": {"simple_query_string": {"query": "images || french"}},
    "fn_single": {"function_score": {
        "query": {"match": {"message": "get"}},
        "field_value_factor": {"field": "size", "modifier": "sqrt"}}},
    "fn_many": {"function_score": {
        "query": {"match": {"message": "get"}},
        "functions": [
            {"field_value_factor": {"field": "size", "modifier": "log1p",
                                    "factor": 0.5}},
            {"gauss": {"@timestamp": {"origin": "2015-01-27T00:00:00",
                                      "scale": "2d"}}},
            {"exp": {"size": {"origin": 50000, "scale": 20000,
                              "offset": 100, "decay": 0.3}}},
            {"lin": {"size": {"origin": 50000, "scale": 20000}}},
            {"filter": {"term": {"status": "200"}}, "weight": 3},
            {"random_score": {"seed": 7}}],
        "score_mode": "max", "boost_mode": "sum", "max_boost": 5,
        "min_score": 0.5, "boost": 2}},
}


def _ast(q):
    """A query AST as nested (class name, fields) tuples, so the two
    packages' dataclasses compare."""
    if dataclasses.is_dataclass(q):
        return (type(q).__name__,
                tuple((f.name, _ast(getattr(q, f.name)))
                      for f in dataclasses.fields(q)))
    if isinstance(q, (tuple, list)):
        return tuple(_ast(x) for x in q)
    return q


def _parsers(built):
    lookup = built["lookup"]
    return (QueryParser(built["port"][0], index_name="logs",
                        doc_lookup=lookup),
            RefParser(built["ref"][0], index_name="logs", doc_lookup=lookup))


@pytest.mark.parametrize("name", sorted(BODIES))
def test_parse_equals_reference(built, name):
    port, ref = _parsers(built)
    assert _ast(port.parse(BODIES[name])) == _ast(ref.parse(BODIES[name]))


def _same_tree(a, b, path="params"):
    if isinstance(b, (tuple, list)):
        assert isinstance(a, (tuple, list)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, (path, x.dtype,
                                                           y.dtype)
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), path


def _bind(built, body):
    port, ref = _parsers(built)
    pb = ex.QueryBinder(built["port"][1], built["port"][0]).bind(
        port.parse(body))
    rb = ref_ex.QueryBinder(built["ref"][1], built["ref"][0]).bind(
        ref.parse(body))
    return pb, rb


@pytest.mark.parametrize("name", sorted(
    n for n in BODIES if not n.startswith(("ids", "term_id", "terms_uid",
                                           "mlt_unlike", "mlt_ids"))))
def test_bind_equals_reference(built, name):
    """desc and params of the bound query equal the reference's (decay
    origins parse to the same epoch seconds; `now` is not used)."""
    pb, rb = _bind(built, BODIES[name])
    pd, pp = ex.finalize([pb, pb])
    rd, rp = ref_ex.finalize([rb, rb])
    assert pd == rd
    _same_tree(pp, rp)


def _to_torch(tree):
    if isinstance(tree, (tuple, list)):
        return tuple(_to_torch(x) for x in tree)
    a = np.asarray(tree)
    if a.dtype == np.uint32:          # the packed upload carries int32 bits
        a = a.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _eval_both(built, pbs, rbs):
    """eval_node of a batch of bound queries in both packages: the port
    on its CPU device columns, the reference compiled (jax.jit)."""
    seg_p, seg_r = built["port"][1], built["ref"][1]
    pd, pp = ex.finalize(pbs)
    rd, rp = ref_ex.finalize(rbs)
    dev_p = ex.device_arrays(seg_p, torch.device("cpu"))
    cap = seg_p.capacity
    s_p, m_p = ex.eval_node(pd, _to_torch(pp), dev_p, cap, len(pbs))
    # the segment's columns are arguments, as in the reference's segment
    # program (captured, XLA would fold them as constants)
    dev_r = ref_ex.device_arrays(seg_r)
    s_r, m_r = jax.jit(lambda p, d: ref_ex.eval_node(rd, p, d, cap,
                                                     len(rbs)))(
        jax.tree_util.tree_map(jnp.asarray, rp), dev_r)
    return (s_p.numpy(), m_p.numpy()), (np.asarray(s_r), np.asarray(m_r))


EVAL_KINDS = {
    "exists_text": ["exists"], "exists_num": ["exists_num"],
    "exists_kw": ["exists_kw"], "missing": ["missing"],
    "boosting": ["boosting"], "ids": ["ids", "term_id"],
    "wildcard": ["wildcard", "fuzzy_int"], "regexp_kw": ["regexp_kw"],
    "mlt": ["mlt", "mlt_ids"], "filtered": ["filtered"],
    "dis_max": ["dis_max"], "qs": ["qs_and_not", "qs_default"],
}


@pytest.mark.parametrize("kind", sorted(EVAL_KINDS))
def test_eval_node_equals_reference(built, kind):
    """Score and match tensors of each new kind equal the reference's,
    bit for bit, batched with a second request of the same plan."""
    names = EVAL_KINDS[kind]
    pairs = [_bind(built, BODIES[n]) for n in names]
    # a batch needs one plan: keep the requests whose plans agree
    sig = pairs[0][0].signature()
    pairs = [p for p in pairs if p[0].signature() == sig] * 2
    (s_p, m_p), (s_r, m_r) = _eval_both(built, [p for p, _ in pairs],
                                        [r for _, r in pairs])
    assert np.array_equal(m_p, m_r)
    assert np.array_equal(s_p.view(np.int32), s_r.view(np.int32))
    assert m_r.any()


@pytest.mark.parametrize("name", ["fn_single", "fn_many", "boosting",
                                  "missing"])
def test_all_hits_equal_reference(built, name):
    """Every matching doc's score through the searchers (size = every
    doc), bit for bit: function_score's combination as the reference's
    segment program compiles it (an ad hoc jit of eval_node alone may
    fuse otherwise)."""
    from elasticsearch_tpu.search.shard_searcher import ShardReader as RR
    from elasticsearch_tpu_torch.search.shard_searcher import ShardReader
    body = {"query": BODIES[name], "size": N_DOCS, "_source": False}
    port = ShardReader("logs", [built["port"][1]], {}, built["port"][0],
                       device="cpu").msearch([body])[0]
    ref = RR("logs", [built["ref"][1]], {}, built["ref"][0]).msearch(
        [body])[0]
    assert port["hits"] == ref["hits"]
    assert ref["hits"]["total"] > 0


def test_ids_mask_equals_reference_mask(built):
    """The port's ids binding (doc indices, the mask built on the device)
    gives the reference's [B, cap] mask, duplicates, unknown ids and an
    empty list included."""
    bodies = [BODIES["ids"], BODIES["term_id"], BODIES["terms_uid"],
              {"ids": {"values": []}},
              {"ids": {"values": [str(i) for i in range(0, N_DOCS, 7)]}}]
    pairs = [_bind(built, b) for b in bodies]
    (s_p, m_p), (s_r, m_r) = _eval_both(built, [p for p, _ in pairs],
                                        [r for _, r in pairs])
    assert np.array_equal(m_p, m_r)
    assert np.array_equal(s_p, s_r)
    assert m_p[4].sum() == len(range(0, N_DOCS, 7))
    assert pairs[0][0].arrays["docs"].dtype == np.int32


def test_mlt_like_docs_bind_as_reference(built):
    """like docs by id, unlike text and include: the same selected terms
    (the bool should's order, msm) and no must_not where include; without
    include the like docs are excluded by an ids must_not (the port's
    ids node carries its padded width)."""
    pb, rb = _bind(built, BODIES["mlt_unlike"])
    assert pb.signature() == rb.signature()
    pd, pp = ex.finalize([pb])
    rd, rp = ref_ex.finalize([rb])
    assert pd == rd
    _same_tree(pp, rp)
    pb, rb = _bind(built, BODIES["mlt_ids"])
    pd, pp = ex.finalize([pb])
    rd, rp = ref_ex.finalize([rb])
    assert pd[:3] == rd[:3] and pd[4] == rd[4]
    assert pd[3] == (("ids", 2),) and rd[3] == (("ids",),)
    _same_tree(pp[:2] + pp[3:], rp[:2] + rp[3:])


def test_edit_distance_matches_reference():
    rng = np.random.default_rng(3)
    letters = "abcp01"
    for _ in range(3000):
        a = "".join(rng.choice(list(letters), size=rng.integers(0, 8)))
        b = "".join(rng.choice(list(letters), size=rng.integers(0, 8)))
        k = int(rng.integers(0, 3))
        assert ex._edit_distance_le(a, b, k) \
            == ref_ex._edit_distance_le(a, b, k), (a, b, k)


@pytest.mark.parametrize("body", [
    {"wildcard": {"message": "p0*1"}}, {"wildcard": {"message": "*ml"}},
    {"regexp": {"message": "p00[0-4].*"}}, {"regexp": {"status": "[25]00"}},
    {"fuzzy": {"message": {"value": "p00100", "fuzziness": 2}}},
    {"fuzzy": {"message": "gett"}}])
def test_expansions_pick_the_reference_terms(built, body):
    pb, rb = _bind(built, body)
    assert pb.kind == rb.kind
    for k in rb.arrays:
        assert np.array_equal(pb.arrays[k], rb.arrays[k])
    assert pb.scalars == rb.scalars


def test_not_ported_queries_still_raise(built):
    port, ref = _parsers(built)
    for body in ({"geo_distance": {"distance": "1km", "loc": [0, 0]}},
                 {"geo_bounding_box": {"loc": {"top_left": [0, 1],
                                               "bottom_right": [1, 0]}}},
                 {"geo_shape": {"loc": {"shape": {"type": "point",
                                                  "coordinates": [0, 0]}}}}):
        with pytest.raises(NotImplementedError):
            port.parse(body)
    # ported since: the script query and script_score, nested and
    # _parents_match parse as the reference's
    for body in ({"script": {"script": "1"}},
                 {"function_score": {"script_score": {"script": "1"}}},
                 {"nested": {"path": "x", "score_mode": "max",
                             "query": {"match_all": {}}}},
                 {"_parents_match": {"query": {"match_all": {}}}}):
        assert _ast(port.parse(body)) == _ast(ref.parse(body))
    # the parent / child queries are resolved by the shard searcher
    # before parsing; a parser alone refuses them as the reference's does
    body = {"has_child": {"type": "c", "query": {"match_all": {}}}}
    with pytest.raises(Exception) as p_err:
        port.parse(body)
    with pytest.raises(Exception) as r_err:
        ref.parse(body)
    assert str(p_err.value) == str(r_err.value)
