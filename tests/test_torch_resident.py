"""The resident query loop of the PyTorch port (`search/resident.py` and
the executor's stepped dispatches) vs the JAX reference, on the CPU.

Contracts (after tests/test_resident_loop.py):
  * OFF (ES_TPU_RESIDENT_LOOP unset): the module is inert, its counters
    read zero.
  * ON: responses equal the cold path's and the reference's resident
    responses; the first dispatch of a plan is cold, later ones are hits,
    with the same counts as the reference's; the LRU cap
    (ES_TPU_RESIDENT_MAX_ENTRIES) is honoured.
  * A second delta epoch within the same pow2 bucket reuses the pinned
    entry: refresh_reuses +1, in both packages.
  * A deadline already past raises SearchTimeoutError from the stepped
    walk's own verdict, preempted_by_deadline +1, for a single segment
    and for a base+delta pack, in both packages.
  * A poll that reports late from chunk 3: the base walk runs exactly 3
    chunk launches, then the timeout.

Tolerance: exact, float agg `value`s (sum/avg) included.
"""

import copy
import time

import pytest
import torch

from elasticsearch_tpu.index.mapping import MapperService as RefMapper
from elasticsearch_tpu.index.segment import SegmentBuilder as RefBuilder
from elasticsearch_tpu.search import resident as ref_resident
from elasticsearch_tpu.search.shard_searcher import ShardReader as RefReader
from elasticsearch_tpu.utils.errors import \
    SearchTimeoutError as RefTimeoutError

from elasticsearch_tpu_torch import corpus
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.ops import cuda_scoring as cs
from elasticsearch_tpu_torch.search import executor as ex
from elasticsearch_tpu_torch.search import resident
from elasticsearch_tpu_torch.search.shard_searcher import ShardReader
from elasticsearch_tpu_torch.utils.errors import SearchTimeoutError

import tests.test_torch_fused as tf
import tests.test_torch_streaming as ts

torch.set_num_threads(1)

N_DOCS = 5000                 # capacity 8192: 8 tiles, 8 resident chunks
_MIXES = ("match", "match_range_aggs", "count_match")
MATCH = {"query": {"match": {"message": "get"}}, "size": 5}


@pytest.fixture(scope="module")
def bodies(readers):
    """Three requests of each fused mix; the phrases are ones whose words
    the segment holds (one with a missing word binds to match-nothing,
    and the reference trips on a group of such binds, ROADMAP Queue 3),
    plus one that matches nothing, alone in its group."""
    mixes = corpus.request_mixes(48, seed=5, n_docs=N_DOCS)
    terms = set(readers[0].segments[0].text["message"].terms)
    phrases = [b for b in mixes["phrase"]
               if set(b["query"]["match_phrase"]["message"].split())
               <= terms][:3]
    assert len(phrases) == 3
    return ([b for m in _MIXES for b in mixes[m][:3]] + phrases
            + [{"query": {"match_phrase": {"message": "no such words"}},
                "size": 10}])


def _reader(pkg: str):
    port = pkg == "port"
    svc = (MapperService if port else RefMapper)(mapping=corpus.MAPPING)
    b = (SegmentBuilder if port else RefBuilder)()
    for did, d in corpus.make_docs(N_DOCS, seed=9, long_every=1000):
        b.add(svc.parse(did, d))
    seg = b.build("r")
    if port:
        return ShardReader("logs", [seg], {}, svc, device="cpu")
    return RefReader("logs", [seg], {}, svc)


@pytest.fixture(scope="module")
def readers():
    return _reader("port"), _reader("ref")


@pytest.fixture(scope="module")
def pack_readers():
    return (ts.make_reader("port", ts.build_pair("port")),
            ts.make_reader("ref", ts.build_pair("ref")))


@pytest.fixture()
def resident_on(monkeypatch):
    monkeypatch.delenv("ES_TPU_RESIDENT_MAX_ENTRIES", raising=False)
    monkeypatch.delenv("ES_TPU_PACK_DISPATCH", raising=False)
    monkeypatch.setenv("ES_TPU_RESIDENT_LOOP", "1")
    resident.reset()
    ref_resident.reset()
    yield
    monkeypatch.delenv("ES_TPU_RESIDENT_LOOP", raising=False)
    resident.reset()
    ref_resident.reset()


def _strip(resps):
    return [{k: v for k, v in r.items() if k != "took"} for r in resps]


def _counters(mod) -> dict:
    st = mod.resident_stats()
    return {k: st[k] for k in ("resident_hits", "cold_dispatches",
                               "evictions", "preempted_by_deadline",
                               "refresh_reuses", "entry_count")}


def test_disabled_is_inert(readers, bodies, monkeypatch):
    monkeypatch.delenv("ES_TPU_RESIDENT_LOOP", raising=False)
    resident.reset()
    port, _ref = readers
    port.msearch(copy.deepcopy(bodies))
    st = resident.resident_stats()
    assert st["resident_hits"] == st["cold_dispatches"] == 0
    assert st["preempted_by_deadline"] == st["refresh_reuses"] == 0
    assert st["entry_count"] == st["residency_bytes"] == 0


def test_resident_equals_cold_and_reference(readers, bodies, resident_on,
                                            monkeypatch):
    port, ref = readers
    monkeypatch.delenv("ES_TPU_RESIDENT_LOOP")
    # cold passes first: both readers upload their lazy columns (sorted
    # agg views, tile extrema), which are part of an entry's key
    cold = port.msearch(copy.deepcopy(bodies))
    tf._assert_same(_strip(cold), _strip(ref.msearch(copy.deepcopy(bodies))))
    monkeypatch.setenv("ES_TPU_RESIDENT_LOOP", "1")
    resident.reset()
    ref_resident.reset()
    first = port.msearch(copy.deepcopy(bodies))
    after_first = _counters(resident)
    warm = port.msearch(copy.deepcopy(bodies))
    assert _strip(first) == _strip(cold) == _strip(warm)
    # every fused group's first dispatch is cold (pinning its entry), its
    # second a hit; a group the fused engine does not admit (the phrase
    # that binds to match-nothing) is cold both times
    assert after_first["resident_hits"] == 0
    assert after_first["entry_count"] > 0
    got = _counters(resident)
    assert got["resident_hits"] == got["entry_count"] \
        == after_first["entry_count"]
    assert got["cold_dispatches"] == 2 * after_first["cold_dispatches"] \
        - after_first["entry_count"]
    assert resident.resident_stats()["residency_bytes"] > 0
    want = [ref.msearch(copy.deepcopy(bodies)) for _ in range(2)][-1]
    tf._assert_same(_strip(warm), _strip(want))
    assert got == _counters(ref_resident)


def test_lru_cap(readers, resident_on, monkeypatch):
    monkeypatch.setenv("ES_TPU_RESIDENT_MAX_ENTRIES", "2")
    resident.reset()
    ref_resident.reset()
    port, ref = readers
    # four k buckets (4, 4, 8, 16): three entries against a cap of 2
    for size in (3, 3, 5, 9):
        body = dict(MATCH, size=size)
        assert _strip(port.msearch([body])) == _strip(ref.msearch([body]))
    got = _counters(resident)
    assert got["entry_count"] <= 2 and got["evictions"] >= 1
    assert got == _counters(ref_resident)


def test_second_delta_epoch_reuses_the_entry(resident_on):
    got = {}
    for pkg, mod in (("port", resident), ("ref", ref_resident)):
        readers = [ts.make_reader(pkg, ts.build_pair(pkg, n_delta=n,
                                                     epoch=e))
                   for e, n in ((0, 300), (1, 320))]
        if pkg == "port":
            sigs = [ex._dev_shape_sig(ex.device_arrays(r.segments[1],
                                                       r.device))
                    for r in readers]
            assert sigs[0] == sigs[1]       # one pow2 bucket of shapes
        out = [r.msearch([dict(MATCH)]) for r in readers]
        assert out[0][0]["hits"]["total"] < out[1][0]["hits"]["total"]
        got[pkg] = _counters(mod)
        assert got[pkg]["refresh_reuses"] == 1
        assert got[pkg]["cold_dispatches"] == 1
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("which", ["single", "pack"])
def test_deadline_already_past_raises(readers, pack_readers, resident_on,
                                      which):
    pair = readers if which == "single" else pack_readers
    for reader, mod, err in ((pair[0], resident, SearchTimeoutError),
                             (pair[1], ref_resident, RefTimeoutError)):
        reader.msearch([dict(MATCH)])                   # pin the entry
        with pytest.raises(err):
            reader.msearch([dict(MATCH)], deadline=time.monotonic() - 1.0)
        assert mod.resident_stats()["preempted_by_deadline"] == 1
    # a far deadline is met
    assert pair[0].msearch([dict(MATCH)],
                           deadline=time.monotonic() + 3600)[0]["hits"]


def test_cold_path_deadline_is_cooperative(readers, monkeypatch):
    monkeypatch.delenv("ES_TPU_RESIDENT_LOOP", raising=False)
    resident.reset()
    port, _ref = readers
    with pytest.raises(SearchTimeoutError):
        port.msearch([dict(MATCH)], deadline=time.monotonic() - 1.0)
    assert resident.resident_stats()["preempted_by_deadline"] == 0


@pytest.mark.parametrize("which,walks", [("single", 3), ("pack", 4)])
def test_poll_late_from_chunk_3_stops_the_walk(readers, pack_readers,
                                               resident_on, monkeypatch,
                                               which, walks):
    """The base walk has 8 (single) or 4 (pack) chunks; the poll reports
    late from its 4th call (before chunk 3), so 3 chunk launches run
    (the pack's delta walk, unstepped, adds one)."""
    reader = (readers if which == "single" else pack_readers)[0]
    reader.msearch([dict(MATCH)])                       # pin the entry
    polls, calls = [], []

    def poll(hi, lo, timed):
        polls.append(timed)
        return timed or len(polls) >= 4

    plain = cs.bundle_walk_ref

    def walk(*a, **kw):
        calls.append(kw.get("t0"))
        return plain(*a, **kw)

    monkeypatch.setattr(ex, "_step_poll", poll)
    monkeypatch.setattr(cs, "bundle_walk_ref", walk)
    with pytest.raises(SearchTimeoutError):
        reader.msearch([dict(MATCH)], deadline=time.monotonic() + 3600)
    assert len(calls) == walks and calls[:3] == [0, 1, 2]
    n_chunks = 8 if which == "single" else 4
    assert len(polls) == n_chunks + 1          # every chunk + the final
    assert resident.resident_stats()["preempted_by_deadline"] == 1
