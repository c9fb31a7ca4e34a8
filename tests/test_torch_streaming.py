"""The streaming write path's read side in the PyTorch port vs the JAX
reference, on the CPU: a reader over one base segment and one small
delta segment (`delta_parent` set, shapes bucketed by `pad_delta_shapes`,
a few delta docs deleted through the live mask).

(a) `_msearch` responses equal the reference's on the fused mixes
    (`match`, `match_range_aggs`, `count_match`, `phrase`), which take
    the base+delta pack dispatch, and on `bool_aggs` (unfused, the
    per-segment fallback), with equal fused-admission counters.
(b) A fused group is ONE dispatch with `layout["pack"]`; an unfused group
    is two (one per segment), in both packages.
(c) `ES_TPU_PACK_DISPATCH=0` gives identical responses through the
    per-segment path.

Tolerance: exact, float agg `value`s (sum/avg) included (the port adds
f32 agg sums in XLA's order, ops/ordered.py).
"""

import copy

import pytest
import torch

from elasticsearch_tpu.index.mapping import MapperService as RefMapper
from elasticsearch_tpu.index.segment import SegmentBuilder as RefBuilder
from elasticsearch_tpu.index.segment import \
    pad_delta_shapes as ref_pad_delta_shapes
from elasticsearch_tpu.search import executor as ref_ex
from elasticsearch_tpu.search.shard_searcher import ShardReader as RefReader

from elasticsearch_tpu_torch import corpus
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import (SegmentBuilder,
                                                   pad_delta_shapes)
from elasticsearch_tpu_torch.search import executor as ex
from elasticsearch_tpu_torch.search.shard_searcher import ShardReader

import tests.test_torch_fused as tf

torch.set_num_threads(1)

N_BASE, N_DELTA = 3000, 300           # capacities 4096 (4 tiles) and 512
DELETED = (3, 77, 150, 299)           # delta rows deleted after the build
STREAM_TAIL = 512                     # docs of the stream past the base
MIXES = ["match", "match_range_aggs", "count_match", "phrase", "bool_aggs"]
FUSED = ("match", "match_range_aggs", "count_match", "phrase")


def build_pair(pkg: str, n_base: int = N_BASE, n_delta: int = N_DELTA,
               epoch: int = 0, deleted=DELETED):
    """(base, delta, delta live mask, mapper) built with one package's
    builder from one seeded stream of docs: the base holds docs
    0..n_base (the compacted generation), the delta the next n_delta
    (appended since)."""
    port = pkg == "port"
    svc = (MapperService if port else RefMapper)(mapping=corpus.MAPPING)
    builder = SegmentBuilder if port else RefBuilder
    docs = corpus.make_docs(n_base + STREAM_TAIL, seed=42, long_every=300)
    segs = []
    for seg_id, part in (("base", docs[:n_base]),
                         (f"delta{epoch}", docs[n_base:n_base + n_delta])):
        b = builder()
        for did, d in part:
            b.add(svc.parse(did, d))
        segs.append(b.build(seg_id))
    base, delta = segs
    delta.delta_parent = base.cache_key()
    delta.delta_epoch = epoch
    (pad_delta_shapes if port else ref_pad_delta_shapes)(delta)
    live = delta.primary_mask().copy()
    live[list(deleted)] = False
    return base, delta, live, svc


def make_reader(pkg: str, pair) -> object:
    base, delta, live, svc = pair
    if pkg == "port":
        return ShardReader("logs", [base, delta], {delta.seg_id: live}, svc,
                           device="cpu")
    return RefReader("logs", [base, delta], {delta.seg_id: live}, svc)


@pytest.fixture(scope="module")
def readers():
    return (make_reader("port", build_pair("port")),
            make_reader("ref", build_pair("ref")))


def bodies_for(mix: str, readers=None) -> list[dict]:
    bodies = copy.deepcopy(corpus.request_mixes(
        48 if mix == "phrase" else 12, seed=7,
        n_docs=N_BASE + STREAM_TAIL)[mix])
    if mix == "phrase":
        # phrases whose words both segments hold: a phrase with a word
        # one segment lacks binds to match-nothing there, the pair takes
        # the per-segment path, and the reference trips on a group of
        # such binds (ROADMAP Queue 3)
        seg_terms = [set(s.text["message"].terms)
                     for s in readers[0].segments]
        bodies = [b for b in bodies if all(
            set(b["query"]["match_phrase"]["message"].split()) <= t
            for t in seg_terms)][:12]
        assert len(bodies) >= 4
    if mix == "match":
        # a window that reaches past the first page, so both segments'
        # splits of the merged top-k feed it
        bodies[0]["from"], bodies[0]["size"] = 5, 30
    return bodies


def _strip(resps):
    return [{k: v for k, v in r.items() if k != "took"} for r in resps]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ("ES_TPU_FUSED", "ES_TPU_PACK_DISPATCH",
              "ES_TPU_RESIDENT_LOOP"):
        monkeypatch.delenv(k, raising=False)


def test_pair_shapes(readers):
    port, ref = readers
    base, delta = port.segments
    r_base, r_delta = ref.segments
    assert (base.capacity, delta.capacity) == (4096, 512)
    assert delta.delta_parent is not None and base.delta_parent is None
    assert delta.cache_key() == f"delta({base.cache_key()}):c512"
    # padded term dimension: a power of two, as the reference pads it
    pf, r_pf = delta.text["message"], r_delta.text["message"]
    assert pf.tile_max.shape == r_pf.tile_max.shape
    assert pf.tile_max.shape[0] & (pf.tile_max.shape[0] - 1) == 0
    assert not port.live[delta.seg_id][list(DELETED)].any()


@pytest.mark.parametrize("mix", MIXES)
def test_pack_responses_match_reference(readers, mix):
    port, ref = readers
    bodies = bodies_for(mix, readers)
    ex._fused_stats.reset()
    ref_ex._fused_stats.reset()
    got = port.msearch(bodies)
    want = ref.msearch(bodies)
    tf._assert_same(_strip(got), _strip(want))
    assert any(r["hits"]["total"] > 0 for r in want)
    p_adm = ex.fused_scoring_stats()["admission"]
    r_adm = ref_ex.fused_scoring_stats()["admission"]
    assert p_adm["admitted"] == r_adm["admitted"]
    assert p_adm["rejected"] == r_adm["rejected"]
    if mix in FUSED:
        assert p_adm["admitted"] > 0 and not p_adm["rejected"]


@pytest.mark.parametrize("mix", MIXES)
def test_fused_group_is_one_pack_dispatch(readers, mix):
    port, ref = readers
    bodies = bodies_for(mix, readers)
    counts = []
    for reader in (port, ref):
        pend = reader.msearch_submit(bodies)
        try:
            n_groups = len(pend.groups)
            counts.append(pend.dispatch_count)
            packs = [layout.get("pack") is True
                     for g in pend.groups for _o, layout, _n in g["pending"]]
            if mix in FUSED:
                assert pend.dispatch_count == n_groups and all(packs)
            else:
                assert pend.dispatch_count == 2 * n_groups
                assert not any(packs)
        finally:
            pend.finish()
    assert counts[0] == counts[1]


@pytest.mark.parametrize("mix", MIXES)
def test_pack_dispatch_off_gives_identical_responses(readers, mix,
                                                     monkeypatch):
    port, _ref = readers
    bodies = bodies_for(mix, readers)
    packed = port.msearch(bodies)
    monkeypatch.setenv("ES_TPU_PACK_DISPATCH", "0")
    pend = port.msearch_submit(bodies)
    assert pend.dispatch_count == 2 * len(pend.groups)
    plain = pend.finish()
    assert _strip(packed) == _strip(plain)


def test_delta_docs_reach_the_window(readers):
    """Delta hits (ids past the base) appear in the responses, and no
    deleted delta doc does."""
    port, _ref = readers
    resps = port.msearch(bodies_for("match", readers))
    ids = {int(h["_id"]) for r in resps for h in r["hits"]["hits"]}
    assert any(i >= N_BASE for i in ids)
    assert not ids & {N_BASE + d for d in DELETED}
