"""Host index layer of the PyTorch port vs the JAX reference.

The port keeps its own copies of mapping, analysis, similarity and the
segment builder; on the same documents they must produce byte-identical
columns (`np.array_equal`), the positions sidecar and the positional pack
included, and `segment_from_arrays` must rebuild a reference segment that
the port then searches exactly like one it built itself.
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.mapping import MapperService as RefMapper
from elasticsearch_tpu.index.segment import SegmentBuilder as RefBuilder

from elasticsearch_tpu_torch import corpus
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import (SegmentBuilder,
                                                   segment_from_arrays)
from elasticsearch_tpu_torch.search.shard_searcher import ShardReader

torch.set_num_threads(1)

MIXED_MAPPING = {"properties": {
    "title": {"type": "text"},
    "tags": {"type": "keyword"},
    "price": {"type": "double"},
    "count": {"type": "integer"},
    "when": {"type": "date"},
    "flag": {"type": "boolean"},
    "addr": {"type": "ip"},
    "notes": {"type": "text"},
}}

_TEXT_COLS = ("df", "indptr", "doc_ids", "tfs", "doc_len", "block_docs",
              "block_imps", "block_start", "fwd_tids", "fwd_imps", "tile_max",
              "pos_data", "pos_indptr", "fwd_pos", "lnorm", "k1ln")
_KW_COLS = ("ords", "df", "mv_ords")
_NUM_COLS = ("values", "exists", "raw", "mv_values", "mv_raw", "mv_exists")


def _mixed_docs(n, seed=0):
    rng = np.random.default_rng(seed)
    words = ["Alpha", "beta", "GAMMA", "delta-epsilon", "zeta's", "éta",
             "theta_1", "iota", "Kappa!", "lambda", "mu", "nu", "xi"]
    docs = []
    for i in range(n):
        k = int(rng.integers(1, 9))
        doc = {"title": " ".join(rng.choice(words, size=k)),
               "tags": list(rng.choice(["red", "green", "blue", "x y"],
                                       size=int(rng.integers(1, 4)))),
               "price": float(rng.random() * 100),
               "count": [int(v) for v in rng.integers(-5, 500,
                                                      size=int(rng.integers(1, 3)))],
               "when": f"2015-0{int(rng.integers(1, 9))}-1{int(rng.integers(0, 9))}"
                       f"T0{int(rng.integers(0, 9))}:00:00",
               "flag": bool(rng.random() < 0.5),
               "addr": f"10.0.{int(rng.integers(0, 4))}.{int(rng.integers(0, 255))}"}
        if i % 50 == 7:
            # a doc with > 256 distinct terms: `notes` gets no forward index
            doc["notes"] = " ".join(f"w{j}" for j in range(300))
        elif i % 3 == 0:
            doc["notes"] = "short note " + str(i % 11)
        if i % 13 == 5:
            del doc["price"]
        docs.append((f"d{i}", doc))
    return docs


def _build(docs, mapping, mapper_cls, builder_cls):
    svc = mapper_cls(mapping=mapping)
    b = builder_cls()
    for did, d in docs:
        b.add(svc.parse(did, d))
    return svc, b.build("s0")


def _assert_same_segment(port, ref):
    assert port.num_docs == ref.num_docs
    assert port.capacity == ref.capacity
    # index by position: the reference's columnar segments hold virtual
    # id/source lists that do not end iteration by themselves
    n = ref.num_docs
    assert [port.ids[i] for i in range(n)] == [ref.ids[i] for i in range(n)]
    assert [port.sources[i] for i in range(n)] \
        == [ref.sources[i] for i in range(n)]
    np.testing.assert_array_equal(port.versions, ref.versions)
    assert sorted(port.text) == sorted(ref.text)
    for f, pf in port.text.items():
        rf = ref.text[f]
        assert pf.terms == rf.terms
        assert pf.doc_count == rf.doc_count and pf.avg_len == rf.avg_len
        assert pf.pos_width == rf.pos_width, f
        for c in _TEXT_COLS:
            a, b = getattr(pf, c), getattr(rf, c)
            assert (a is None) == (b is None), (f, c)
            if a is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b), (f, c)
    assert sorted(port.keywords) == sorted(ref.keywords)
    for f, kc in port.keywords.items():
        rk = ref.keywords[f]
        assert kc.terms == rk.terms
        for c in _KW_COLS:
            a, b = getattr(kc, c), getattr(rk, c)
            assert (a is None) == (b is None), (f, c)
            if a is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b), (f, c)
    assert sorted(port.numerics) == sorted(ref.numerics)
    for f, nc in port.numerics.items():
        rn = ref.numerics[f]
        assert nc.kind == rn.kind and nc.bias == rn.bias
        for c in _NUM_COLS:
            a, b = getattr(nc, c), getattr(rn, c)
            assert (a is None) == (b is None), (f, c)
            if a is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b), (f, c)


def _arrays_of(seg):
    arrays = {"versions": seg.versions}
    meta = {"seg_id": seg.seg_id, "num_docs": seg.num_docs,
            "capacity": seg.capacity, "ids": list(seg.ids),
            "sources": list(seg.sources), "text": {}, "keywords": {},
            "numerics": {}}
    for f, pf in seg.text.items():
        meta["text"][f] = {"terms": pf.terms, "doc_count": pf.doc_count,
                           "avg_len": pf.avg_len}
        for c in _TEXT_COLS:
            if getattr(pf, c) is not None:
                arrays[f"text.{f}.{c}"] = getattr(pf, c)
    for f, kc in seg.keywords.items():
        meta["keywords"][f] = {"terms": kc.terms}
        for c in _KW_COLS:
            if getattr(kc, c) is not None:
                arrays[f"kw.{f}.{c}"] = getattr(kc, c)
    for f, nc in seg.numerics.items():
        meta["numerics"][f] = {"kind": nc.kind, "bias": nc.bias}
        for c in _NUM_COLS:
            if getattr(nc, c) is not None:
                arrays[f"num.{f}.{c}"] = getattr(nc, c)
    return arrays, meta


@pytest.mark.parametrize("which", ["mixed", "http_logs", "delta"])
def test_builder_matches_reference(which):
    if which == "mixed":
        docs, mapping = _mixed_docs(400), MIXED_MAPPING
    else:
        docs, mapping = corpus.make_docs(700, long_every=300), corpus.MAPPING
    _, port = _build(docs, mapping, MapperService, SegmentBuilder)
    _, ref = _build(docs, mapping, RefMapper, RefBuilder)
    if which == "delta":
        # a delta segment of the streaming write path: its term dimension
        # bucketed to a power of two, keyed on its base generation
        from elasticsearch_tpu.index.segment import \
            pad_delta_shapes as ref_pad
        from elasticsearch_tpu_torch.index.segment import pad_delta_shapes
        t_before = len(port.text["message"].terms)
        for seg, pad in ((port, pad_delta_shapes), (ref, ref_pad)):
            seg.delta_parent, seg.delta_epoch = "base-gen", 3
            assert pad(seg) is seg
        rows = port.text["message"].tile_max.shape[0]
        assert rows >= t_before and rows & (rows - 1) == 0
        assert port.cache_key() == ref.cache_key() \
            == f"delta(base-gen):c{port.capacity}"
    _assert_same_segment(port, ref)
    assert port.fingerprint() == ref.fingerprint()
    if which == "http_logs":
        assert port.text["body"].fwd_tids is None        # scatter-only field
        assert port.text["message"].fwd_tids is not None
        assert port.text["message"].fwd_pos is not None
        assert port.text["body"].fwd_pos is None         # no forward index
        assert port.text["body"].pos_data is not None    # host positions


def test_positions_pack_matches_reference():
    """Positions of concatenated multi-values (no position gap), repeated
    terms, a field past POS_CAP (a term 70 times: no pack, positions kept
    for the host path), and the pack in nbytes."""
    from elasticsearch_tpu.index.segment import POS_CAP as REF_POS_CAP
    from elasticsearch_tpu_torch.index.segment import POS_CAP
    assert POS_CAP == REF_POS_CAP == 64
    mapping = {"properties": {"t": {"type": "text"},
                              "many": {"type": "text"}}}
    rng = np.random.default_rng(4)
    words = ["a", "b", "c", "d"]
    docs = []
    for i in range(300):
        doc = {"t": [" ".join(rng.choice(words, size=int(rng.integers(1, 6))))
                     for _ in range(int(rng.integers(1, 3)))]}
        if i % 7 == 0:
            doc["many"] = "x " * (70 if i == 14 else 3) + "y"
        docs.append((f"d{i}", doc))
    _, port = _build(docs, mapping, MapperService, SegmentBuilder)
    _, ref = _build(docs, mapping, RefMapper, RefBuilder)
    _assert_same_segment(port, ref)
    t, many = port.text["t"], port.text["many"]
    assert t.fwd_pos is not None and t.pos_width == ref.text["t"].pos_width
    assert many.fwd_pos is None and many.pos_width == 0
    assert many.pos_data is not None and many.fwd_tids is not None
    # both count the pack; the port also counts its forward index
    for pf, rf in ((t, ref.text["t"]), (many, ref.text["many"])):
        assert pf.nbytes() - rf.nbytes() \
            == pf.fwd_tids.nbytes + pf.fwd_imps.nbytes
    # the positions of a posting, through enc_positions, as the reference
    stride = 40
    for tid in range(len(t.terms)):
        np.testing.assert_array_equal(t.enc_positions(tid, stride),
                                      ref.text["t"].enc_positions(tid,
                                                                  stride))


def test_analyzer_matches_reference():
    from elasticsearch_tpu.index import analysis as ref_analysis
    texts = ["GET /images/Foo-Bar.html HTTP/1.0 200",
             "café naïve résumé", "e-mail: a.b@example.com, 3.14",
             "The quick brown fox's 42 jumps!", "  ", "x_y z--w ..."]
    port, ref = MapperService(), RefMapper()
    for name in ("standard", "simple", "whitespace", "keyword"):
        pa, ra = port.analysis.analyzer(name), ref.analysis.analyzer(name)
        for t in texts:
            assert pa.analyze(t) == ra.analyze(t), (name, t)
    # the port's standard analyzer is the reference's Python chain (the
    # reference's native tokenizer hook is not ported), which also
    # lowercases non-ASCII capitals
    chain = ref_analysis.Analyzer("standard",
                                  ref_analysis.standard_tokenizer,
                                  [ref_analysis.lowercase_filter])
    for t in texts + ["Ünïcödé ÉTÉ Straße"]:
        assert port.analysis.analyzer("standard").analyze(t) \
            == chain.analyze(t), t


def test_segment_from_arrays_round_trip():
    docs = corpus.make_docs(600, seed=3, long_every=200)
    rsvc, ref = _build(docs, corpus.MAPPING, RefMapper, RefBuilder)
    arrays, meta = _arrays_of(ref)
    seg = segment_from_arrays(arrays, meta)
    _assert_same_segment(seg, ref)
    # the copies are the port's own: mutating them leaves the source alone
    seg.text["message"].block_imps[0, 0] += 1.0
    assert not np.array_equal(seg.text["message"].block_imps,
                              ref.text["message"].block_imps)
    seg.text["message"].block_imps[0, 0] -= 1.0

    psvc, built = _build(docs, corpus.MAPPING, MapperService, SegmentBuilder)
    bodies = [m[0] for m in corpus.request_mixes(4, seed=5).values()]
    a = ShardReader("logs", [seg], {}, psvc, device="cpu").msearch(bodies)
    b = ShardReader("logs", [built], {}, psvc, device="cpu").msearch(bodies)
    for x, y in zip(a, b):
        x.pop("took"), y.pop("took")
        assert x == y


def test_build_columnar_matches_reference():
    from elasticsearch_tpu.index.segment import build_columnar as ref_bc
    from elasticsearch_tpu_torch.index.segment import build_columnar
    rng = np.random.default_rng(12)
    n = 1000
    kw = {"zone": rng.choice(["a", "bb", "c", "dd"], size=n)}
    num = {"fare": ("double", rng.random(n) * 50),
           "ts": ("date", 1_420_070_400_000
                  + rng.integers(0, 10 ** 9, size=n)),
           "n": ("long", rng.integers(-5, 10, size=n))}
    port = build_columnar("c", n, keywords=kw, numerics=num)
    ref = ref_bc("c", n, keywords=kw, numerics=num)
    _assert_same_segment(port, ref)
    assert port.capacity == 1024
