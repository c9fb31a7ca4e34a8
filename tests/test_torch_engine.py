"""The port's shard engine against the reference's, on the CPU.

The same seeded documents go through `elasticsearch_tpu.index.engine.
Engine` and `elasticsearch_tpu_torch.index.engine.Engine` (in memory), in
the legacy segment-per-refresh mode and in the streaming delta mode
(`index.streaming.delta`, `index.delta.min_compact_docs` small so that a
refresh compacts): index, update, delete, get, refresh, grow the delta,
compact (by threshold and explicitly) and force-merge. After every step:

  * `acquire_searcher().msearch(...)` gives the reference's responses for
    the seven corpus mixes (match, bool_aggs, prefix, term_body,
    aggs_only, match_range_aggs, count_match), JSON dumps equal with
    `took` stripped;
  * the engines hold the same segments, every array equal, with equal
    `fingerprint()` / `cache_key()`, and equal `base_generation()`.

`concat_segments` / `merge_segments` are held against the reference's
alone, and a refresh that leaves the base unchanged uploads none of its
columns again.

Tolerance: none (bit equality, exact responses).
"""

import copy
import json

import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.engine import Engine as RefEngine
from elasticsearch_tpu.index.mapping import MapperService as RefMapper
from elasticsearch_tpu.index.segment import (
    SegmentBuilder as RefBuilder, concat_segments as ref_concat,
    merge_segments as ref_merge)
from elasticsearch_tpu.utils.settings import Settings as RefSettings

from elasticsearch_tpu_torch import corpus
from elasticsearch_tpu_torch.index.engine import Engine
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import (
    SegmentBuilder, concat_segments, merge_segments)
from elasticsearch_tpu_torch.search import executor
from elasticsearch_tpu_torch.utils.settings import Settings

from tests.test_torch_segment import _assert_same_segment

torch.set_num_threads(1)

MIXES = ("match", "bool_aggs", "prefix", "term_body", "aggs_only",
         "match_range_aggs", "count_match")
N_DOCS = 700


def _docs():
    return list(corpus.make_docs(N_DOCS, seed=11, start=0, long_every=100))


def _bodies():
    mixes = corpus.request_mixes(4, seed=7, n_docs=N_DOCS, doc_seed=11)
    return [b for m in MIXES for b in copy.deepcopy(mixes[m])]


def _strip_took(x):
    if isinstance(x, dict):
        return {k: _strip_took(v) for k, v in x.items() if k != "took"}
    if isinstance(x, list):
        return [_strip_took(v) for v in x]
    return x


def _settings(delta: bool) -> dict:
    return {"index.streaming.delta": delta,
            "index.delta.min_compact_docs": 32,
            "index.delta.compact_ratio": 0.5,
            "index.merge.max_segment_count": 3}


def _engines(delta: bool):
    s = _settings(delta)
    port = Engine("logs", 0, MapperService(mapping=corpus.MAPPING),
                  settings=Settings(s), device="cpu")
    ref = RefEngine("logs", 0, RefMapper(mapping=corpus.MAPPING),
                    settings=RefSettings(s))
    return port, ref


def _assert_same_engines(port, ref, bodies, delta):
    assert len(port.segments) == len(ref.segments)
    for a, b in zip(port.segments, ref.segments):
        _assert_same_segment(a, b)
        assert a.fingerprint() == b.fingerprint()
        assert a.cache_key() == b.cache_key()
        assert a.delta_epoch == b.delta_epoch
        np.testing.assert_array_equal(port.live[a.seg_id],
                                      ref.live[b.seg_id])
    if delta:
        assert port.base_generation() == ref.base_generation()
    assert port.doc_count() == ref.doc_count()
    # the reference one request at a time: it raises IndexError when two
    # requests of one group bind to nothing on every segment (ROADMAP
    # Queue 3, faults of the reference); the port batches them
    got = [_strip_took(port.acquire_searcher().msearch(bodies)),
           _strip_took([ref.acquire_searcher().msearch([b])[0]
                        for b in bodies])]
    for i, body in enumerate(bodies):
        assert json.dumps(got[0][i], sort_keys=True) \
            == json.dumps(got[1][i], sort_keys=True), body


def _write(engines, ops):
    """Apply the same writes to both engines; their results must match."""
    for op, did, src in ops:
        out = []
        for e in engines:
            if op == "index":
                out.append(e.index(did, src))
            else:
                out.append(e.delete(did))
        assert out[0] == out[1], (op, did)


@pytest.mark.parametrize("delta", [False, True], ids=["legacy", "delta"])
def test_engine_steps_equal_reference(delta):
    docs = _docs()
    bodies = _bodies()
    port, ref = _engines(delta)
    engines = (port, ref)
    rng = np.random.default_rng(3)
    steps = []
    # 1. index and refresh (delta mode: the first refresh compacts)
    steps.append([("index", did, d) for did, d in docs[:400]])
    # 2. update 20, delete 15, refresh: a small delta beside the base
    upd = rng.choice(400, size=20, replace=False)
    dels = rng.choice(np.setdiff1d(np.arange(400), upd), size=15,
                      replace=False)
    steps.append([("index", docs[i][0], {**docs[i][1], "size": 7})
                  for i in upd]
                 + [("delete", docs[i][0], None) for i in dels])
    # 3. grow the delta under the compaction threshold
    steps.append([("index", did, d) for did, d in docs[400:550]])
    # 4. grow it past the threshold: this refresh compacts
    steps.append([("index", did, d) for did, d in docs[550:]])
    for ops in steps:
        _write(engines, ops)
        for e in engines:
            e.refresh()
        _assert_same_engines(port, ref, bodies, delta)
        for did in (docs[0][0], docs[int(dels[0])][0], docs[-1][0]):
            got = []
            for e in engines:
                try:
                    got.append(e.get(did))
                except Exception as exc:  # noqa: BLE001 — compared below
                    got.append(type(exc).__name__)
            assert got[0] == got[1]
    if delta:
        assert port.segment_stats()["streaming"]["compactions"] >= 2
    # 5. a write and an explicit compaction
    _write(engines, [("index", docs[5][0], {**docs[5][1], "size": 9})])
    for e in engines:
        e.refresh()
        e.compact()
    _assert_same_engines(port, ref, bodies, delta)
    # 6. force-merge into one segment
    _write(engines, [("delete", docs[6][0], None)])
    for e in engines:
        e.force_merge()
    assert len(port.segments) == 1
    _assert_same_engines(port, ref, bodies, delta)
    for e in engines:
        e.close()


def _segments(both_docs_sets):
    out = {"port": [], "ref": []}
    for i, docs in enumerate(both_docs_sets):
        for side, (mapper_cls, builder_cls) in {
                "port": (MapperService, SegmentBuilder),
                "ref": (RefMapper, RefBuilder)}.items():
            svc = mapper_cls(mapping=corpus.MAPPING)
            b = builder_cls()
            for did, d in docs:
                b.add(svc.parse(did, d))
            out[side].append(b.build(f"s{i}"))
    return out


@pytest.mark.parametrize("fn", ["concat", "merge"])
def test_concat_and_merge_segments_equal_reference(fn):
    docs = _docs()
    segs = _segments([docs[:300], docs[300:450], docs[450:520]])
    rng = np.random.default_rng(5)
    live = {}
    for s in segs["ref"]:
        m = np.zeros(s.capacity, dtype=bool)
        m[: s.num_docs] = rng.random(s.num_docs) < 0.9
        live[s.seg_id] = m
    if fn == "concat":
        a = concat_segments(segs["port"], "m", live)
        b = ref_concat(segs["ref"], "m", live)
        assert a.impacts_preserved and b.impacts_preserved
    else:
        a = merge_segments(segs["port"], "m", live)
        b = ref_merge(segs["ref"], "m", live)
    _assert_same_segment(a, b)
    assert a.fingerprint() == b.fingerprint()


def test_refresh_with_unchanged_base_uploads_no_base_column(monkeypatch):
    """A delta refresh publishes a new reader over the same base segment
    object, whose uploaded columns (and fielddata hold) are reused: the
    second search uploads only the new delta's columns."""
    docs = _docs()
    port = Engine("logs", 0, MapperService(mapping=corpus.MAPPING),
                  settings=Settings(_settings(True)), device="cpu")
    for did, d in docs[:400]:
        port.index(did, d)
    port.refresh()                 # compacts: one base
    for did, d in docs[400:420]:
        port.index(did, d)
    port.refresh()                 # base + a 20-doc delta
    bodies = _bodies()
    port.acquire_searcher().msearch(bodies)
    base = port.segments[0]
    base_dev = base._device
    uploads = []
    real_up = executor._up

    def counting_up(a, device):
        uploads.append(a)
        return real_up(a, device)

    monkeypatch.setattr(executor, "_up", counting_up)
    for did, d in docs[420:440]:
        port.index(did, d)
    port.refresh()                 # a new delta, the same base
    assert port.segments[0] is base and len(port.segments) == 2
    port.acquire_searcher().msearch(bodies)
    assert base._device is base_dev
    assert uploads, "the new delta's columns are uploaded"
    base_cols = [a for group in (base.text, base.keywords, base.numerics)
                 for col in group.values() for a in vars(col).values()
                 if isinstance(a, np.ndarray)]
    assert not any(u is a for u in uploads for a in base_cols)
    port.close()


def test_compacted_single_delta_is_the_builders_segment():
    """The first refresh of a delta-mode engine compacts its one delta
    into a base that is the SegmentBuilder's segment of the same docs,
    every array equal: the main-path index a node ingests is the one the
    builder makes."""
    docs = _docs()[:500]
    port = Engine("logs", 0, MapperService(mapping=corpus.MAPPING),
                  settings=Settings(_settings(True)), device="cpu")
    for did, d in docs:
        port.index(did, d)
    port.refresh()
    assert len(port.segments) == 1 and port.segments[0].impacts_preserved
    svc = MapperService(mapping=corpus.MAPPING)
    b = SegmentBuilder()
    for did, d in docs:
        b.add(svc.parse(did, d))
    built = b.build("b")
    _assert_same_segment(port.segments[0], built)
    assert port.segments[0].fingerprint() == built.fingerprint()
    port.close()
