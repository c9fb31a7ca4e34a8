"""The port's store, translog, flush and recovery against the reference's,
on the CPU.

Both packages take the same seeded writes and the same storage fault
rules (each package's own `utils/faults.configure`, cleared in a
`finally`), and are compared:

  * cross-package stores: a store built by one package's `Engine` (a
    flushed compacted base, a flushed delta and a translog tail of index,
    update and delete ops) is recovered by the other; the loaded arrays
    and meta equal the reference's (sha256 and zip bytes aside) and a
    request set over match / bool + range + aggs / phrase answers the
    same, both ways;
  * translog records: the bytes each package writes for the same ops;
  * the crash-point matrix (the reference's `tests/test_durability.py`
    MATRIX): both raise PowerLossError at the same op and recover the
    same doc set, versions and responses;
  * the reference's own test classes, both packages side by side:
    durability modes, commit fallback and lossy-fallback containment,
    corruption markers (none for `io_error`), `check_on_startup`, marker
    clearing, torn-tail truncation and mid-log corruption;
  * a recovered pack is the same pack: fingerprints, cache keys and
    every `device_arrays` tensor equal the ones before the restart.

Tolerance: none (ids, versions, counts and keys exact; responses JSON
equal with `took` stripped, f32 scores and agg values bit for bit).
"""

import contextlib
import copy
import glob
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from elasticsearch_tpu.index import durability as ref_durability
from elasticsearch_tpu.index.engine import Engine as RefEngine
from elasticsearch_tpu.index.mapping import MapperService as RefMapper
from elasticsearch_tpu.index.store import Store as RefStore
from elasticsearch_tpu.index.translog import (Translog as RefTranslog,
                                              TranslogOp as RefOp)
from elasticsearch_tpu.utils import faults as ref_faults
from elasticsearch_tpu.utils.errors import PowerLossError as RefPowerLoss
from elasticsearch_tpu.utils.errors import ShardFailedError as RefShardFailed
from elasticsearch_tpu.utils.settings import Settings as RefSettings

from elasticsearch_tpu_torch import corpus
from elasticsearch_tpu_torch.index import durability
from elasticsearch_tpu_torch.index.engine import Engine
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.store import Store
from elasticsearch_tpu_torch.index.translog import (OP_DELETE, OP_INDEX,
                                                    Translog, TranslogOp)
from elasticsearch_tpu_torch.search import executor
from elasticsearch_tpu_torch.utils import faults
from elasticsearch_tpu_torch.utils.errors import (PowerLossError,
                                                  ShardFailedError)
from elasticsearch_tpu_torch.utils.settings import Settings

from tests.test_torch_segment import _assert_same_segment

torch.set_num_threads(1)

MAPPING = {"properties": {"msg": {"type": "text"}, "n": {"type": "long"}}}
SORTED_BODY = {"query": {"match_all": {}}, "sort": [{"n": "asc"}],
               "size": 100}
DELTA = {"index.streaming.delta": True, "index.delta.min_compact_docs": 32,
         "index.delta.compact_ratio": 0.5}
PACKAGES = ("port", "ref")


def new_engine(pkg, path=None, settings=None, mapping=MAPPING):
    if pkg == "port":
        return Engine("idx", 0, MapperService(mapping=mapping), path=path,
                      settings=Settings(settings or {}), device="cpu")
    return RefEngine("idx", 0, RefMapper(mapping=mapping), path=path,
                     settings=RefSettings(settings or {}))


def both(tmp_path, name, settings=None, mapping=MAPPING):
    """One engine per package, each on its own directory."""
    return {pkg: new_engine(pkg, str(tmp_path / f"{name}-{pkg}"), settings,
                            mapping)
            for pkg in PACKAGES}


def path_of(tmp_path, name, pkg):
    return str(tmp_path / f"{name}-{pkg}")


@contextlib.contextmanager
def rules(spec):
    """The same storage fault spec installed in both packages."""
    faults.configure(spec)
    ref_faults.configure(spec)
    try:
        yield
    finally:
        faults.clear()
        ref_faults.clear()


def doc_set(e):
    """id -> (version, source) over the live segments and the buffer."""
    out = {}
    for seg in e.segments:
        live = e.live[seg.seg_id]
        for d in range(seg.num_docs):
            if live[d]:
                out[seg.ids[d]] = (int(seg.versions[d]), bytes(seg.sources[d]))
    for did, (v, src) in e._buffer_docs.items():
        out[did] = (int(v), bytes(src))
    return out


def _strip_took(x):
    if isinstance(x, dict):
        return {k: _strip_took(v) for k, v in x.items() if k != "took"}
    if isinstance(x, list):
        return [_strip_took(v) for v in x]
    return x


def _dump(x):
    return json.dumps(_strip_took(x), sort_keys=True, default=str)


def sorted_hits(e):
    e.refresh()
    return e.acquire_searcher().search(copy.deepcopy(SORTED_BODY))["hits"]


def assert_same_state(port, ref):
    assert doc_set(port) == doc_set(ref)
    assert _dump(sorted_hits(port)) == _dump(sorted_hits(ref))


def flip_byte(path, frac=0.5):
    data = bytearray(open(path, "rb").read())
    data[int(len(data) * frac)] ^= 0xFF
    open(path, "wb").write(bytes(data))


def _sid_free(reason):
    """A containment reason with segment ids (process-wide counters, so
    they differ between packages) blanked out."""
    return re.sub(r"\d+_\d+", "<sid>", reason)


def counters():
    return {"port": durability.snapshot(), "ref": ref_durability.snapshot()}


@pytest.fixture(autouse=True)
def _clean_faults_and_counters():
    faults.clear()
    ref_faults.clear()
    durability.install_process_stats()
    ref_durability.install_process_stats()
    yield
    faults.clear()
    ref_faults.clear()
    durability.reset_process_stats()
    ref_durability.reset_process_stats()


def close_all(*engines):
    for e in engines:
        e.close()


# ---------------------------------------------------------------------------
# storage fault grammar
# ---------------------------------------------------------------------------

SPEC = ("crash_point:site=store:phase=commit,"
        "disk_corrupt:site=store:phase=load_npz:mode=truncate,"
        "io_error:site=translog:phase=read:index=logs:shard=0,"
        "crash_point:site=translog:phase=append:unsynced=drop:kill=1:"
        "rate=0.5:seed=4")


def test_storage_spec_parses_as_the_reference():
    got = faults.FaultRegistry.parse(SPEC).snapshot()
    want = ref_faults.FaultRegistry.parse(SPEC).snapshot()
    assert got == want


@pytest.mark.parametrize("bad", [
    "crash_point:site=store:phase=load_npz",
    "crash_point:phase=bogus",
    "disk_corrupt:site=translog:phase=append",
    "crash_point:site=mesh",
    "io_error:unsynced=drop",
    "crash_point:replica=1",
    "disk_corrupt:mode=shred",
    "io_error:kill=1",
    "crash_point:host=h1",
    "nonsense_kind",
])
def test_storage_spec_rejects_as_the_reference(bad):
    with pytest.raises(ValueError):
        ref_faults.FaultRegistry.parse(bad)
    with pytest.raises(ValueError):
        faults.FaultRegistry.parse(bad)


@pytest.mark.parametrize("spec", [
    "shard_error:shard=1", "shard_delay:ms=5", "breaker_trip",
    "device_dead:site=mesh", "host_dead:host=h", "ctrl_drop:action=ping",
    "ctrl_delay:ms=5", "net_partition:hosts=a+b", "shard_error:kill=1"])
def test_dispatch_and_control_kinds_are_not_ported(spec):
    ref_faults.FaultRegistry.parse(spec.replace(":kill=1", ""))
    kind = spec.split(":")[0]
    with pytest.raises(NotImplementedError, match=kind):
        faults.FaultRegistry.parse(spec)


def test_crash_point_is_one_shot():
    for mod, err in ((faults, PowerLossError), (ref_faults, RefPowerLoss)):
        reg = mod.FaultRegistry.parse("crash_point:site=translog:phase=append")
        with pytest.raises(err):
            reg.on_storage_write("translog", "append")
        reg.on_storage_write("translog", "append")   # no second crash
        assert reg.rules[0].fired == 1


@pytest.mark.parametrize("mode", ["flip", "truncate"])
def test_disk_corrupt_mutates_files_alike(tmp_path, mode):
    out = []
    for mod in (faults, ref_faults):
        p = str(tmp_path / f"f-{mod.__name__}.bin")
        open(p, "wb").write(bytes(range(64)))
        reg = mod.FaultRegistry.parse(
            f"disk_corrupt:site=store:phase=load_npz:mode={mode}:seed=3")
        reg.on_storage_read("store", "load_npz", p)
        out.append(open(p, "rb").read())
    assert out[0] == out[1] != bytes(range(64))


def test_rates_draw_the_same_sequence():
    spec = "crash_point:site=translog:phase=append:rate=0.2:seed=11"
    fired = []
    for mod in (faults, ref_faults):
        reg = mod.FaultRegistry.parse(spec)
        for i in range(100):
            try:
                reg.on_storage_write("translog", "append")
            except Exception:  # noqa: BLE001 — either package's error
                fired.append(i)
                break
    assert fired[0] == fired[1]


# ---------------------------------------------------------------------------
# translog records
# ---------------------------------------------------------------------------

def _ops():
    docs = list(corpus.make_docs(20, seed=5))
    ops = [("index", did, json.dumps(d, separators=(",", ":")).encode(), 1)
           for did, d in docs]
    ops += [("delete", docs[3][0], None, 2),
            ("index", docs[4][0], "{\"message\":\"café ü\"}".encode(),
             2)]
    return ops


def test_translog_records_are_byte_identical(tmp_path):
    out = []
    for tl_cls, op_cls, name in ((Translog, TranslogOp, "port"),
                                 (RefTranslog, RefOp, "ref")):
        t = tl_cls(str(tmp_path / name), durability="async")
        for op, did, src, v in _ops():
            t.add(op_cls(op, did, v, src))
        t.sync()
        t.close()
        out.append(open(str(tmp_path / name / "translog-1.log"), "rb").read())
    assert out[0] == out[1]
    # and each package reads the other's records
    a = [vars(o) for o in Translog(str(tmp_path / "ref")).snapshot()]
    b = [vars(o) for o in RefTranslog(str(tmp_path / "port")).snapshot()]
    assert a == b and len(a) == len(_ops())


@pytest.mark.parametrize("text", [
    "plain", 'quo"te \\ back', "line\nbreak\ttab\x00nul\x1f",
    "caf\u00e9 \u00fc \u4e2d\u6587", "emoji \U0001F600 \u2028 \ud7ff",
    ""])
def test_translog_payload_is_the_reference_encoding(text):
    for op, did, src, v in (("index", text, json.dumps(
            {"message": text}).encode("utf-8"), 3),
                            ("delete", text, None, 12345678901)):
        assert TranslogOp(op, did, v, src).to_payload() == \
            RefOp(op, did, v, src).to_payload()


def test_engine_translogs_are_byte_identical(tmp_path):
    es = both(tmp_path, "tl")
    docs = list(corpus.make_docs(30, seed=6))
    for e in es.values():
        for did, d in docs:
            e.index(did, d)
        e.delete(docs[2][0])
        e.index(docs[5][0], {"message": "again"})
    logs = {pkg: open(os.path.join(path_of(tmp_path, "tl", pkg), "translog",
                                   "translog-1.log"), "rb").read()
            for pkg in PACKAGES}
    assert logs["port"] == logs["ref"]
    close_all(*es.values())


# ---------------------------------------------------------------------------
# cross-package stores
# ---------------------------------------------------------------------------

N_DOCS = 300
MIXES = ("match", "match_range_aggs", "bool_aggs", "phrase",
         "phrase_slop_aggs")


def _corpus_docs():
    return list(corpus.make_docs(N_DOCS, seed=31, start=0, long_every=60))


def _bodies():
    mixes = corpus.request_mixes(4, seed=3, n_docs=N_DOCS, doc_seed=31)
    return [b for m in MIXES for b in copy.deepcopy(mixes[m])]


def build_store(pkg, path):
    """A flushed compacted base, a flushed delta, and a translog tail of
    index, update and delete ops (base and delta docs both)."""
    docs = _corpus_docs()
    e = new_engine(pkg, path, DELTA, corpus.MAPPING)
    for did, d in docs[:200]:
        e.index(did, d)
    e.refresh()                      # the delta outgrows 32: compaction
    for did, d in docs[200:240]:
        e.index(did, d)
    e.refresh()                      # a delta below max(32, 100)
    e.flush()
    for did, d in docs[240:260]:
        e.index(did, d)
    for did, d in docs[5:9] + docs[205:208]:
        e.index(did, {**d, "size": d["size"] + 1})
    for did, _ in docs[10:14] + docs[210:212]:
        e.delete(did)
    e.close()


def _responses(e, bodies, one_at_a_time):
    r = e.acquire_searcher()
    if one_at_a_time:
        # the reference raises IndexError when two requests of a group
        # bind to nothing on every segment (ROADMAP Queue 3)
        return [_strip_took(r.msearch([b])[0]) for b in bodies]
    return _strip_took(r.msearch(bodies))


def assert_same_recovered(port, ref):
    assert port.failed is None and ref.failed is None
    assert len(port.segments) == len(ref.segments) == 2
    for a, b in zip(port.segments, ref.segments):
        _assert_same_segment(a, b)
        assert a.fingerprint() == b.fingerprint()
        assert a.cache_key() == b.cache_key()
        assert (a.delta_parent, a.delta_epoch, a.impacts_preserved) == \
            (b.delta_parent, b.delta_epoch, b.impacts_preserved)
        np.testing.assert_array_equal(port.live[a.seg_id], ref.live[b.seg_id])
    assert port.base_generation() == ref.base_generation()
    assert doc_set(port) == doc_set(ref)
    bodies = _bodies()
    got = _responses(port, bodies, False)
    want = _responses(ref, bodies, True)
    for i, body in enumerate(bodies):
        assert json.dumps(got[i], sort_keys=True) \
            == json.dumps(want[i], sort_keys=True), body


@pytest.mark.parametrize("builder", PACKAGES)
def test_cross_package_store_recovers_alike(tmp_path, builder):
    src = str(tmp_path / "built")
    build_store(builder, src)
    for pkg in PACKAGES:
        shutil.copytree(src, path_of(tmp_path, "open", pkg))
    port = new_engine("port", path_of(tmp_path, "open", "port"), DELTA,
                      corpus.MAPPING)
    ref = new_engine("ref", path_of(tmp_path, "open", "ref"), DELTA,
                     corpus.MAPPING)
    assert port.recovery_stats["ops_replayed"] == 33
    assert_same_recovered(port, ref)
    # the loaded arrays and meta of every committed file pair
    pstore, rstore = Store(src), RefStore(src)
    commit = rstore.read_commit(rstore.commit_generations()[0])
    for sid in commit["segments"]:
        stem = commit["files"][sid]
        a, la = pstore.load_segment(sid, stem=stem)
        b, lb = rstore.load_segment(sid, stem=stem)
        _assert_same_segment(a, b)
        np.testing.assert_array_equal(la, lb)
        assert a.fingerprint() == b.fingerprint()
        assert a.cache_key() == b.cache_key()
    close_all(port, ref)


def test_both_packages_write_the_same_store(tmp_path):
    for pkg in PACKAGES:
        build_store(pkg, path_of(tmp_path, "w", pkg))
    stores = {pkg: Store(path_of(tmp_path, "w", pkg)) for pkg in PACKAGES}
    commits = {pkg: s.read_commit(s.commit_generations()[0])
               for pkg, s in stores.items()}
    for a, b in zip(commits["port"]["segments"], commits["ref"]["segments"]):
        sp = commits["port"]["files"][a]
        sr = commits["ref"]["files"][b]
        mp = json.load(open(os.path.join(stores["port"].dir,
                                         sp + ".meta.json")))
        mr = json.load(open(os.path.join(stores["ref"].dir,
                                         sr + ".meta.json")))
        for m in (mp, mr):
            m.pop("sha256")
            m.pop("seg_id")
        assert mp == mr
        zp = np.load(os.path.join(stores["port"].dir, sp + ".npz"))
        zr = np.load(os.path.join(stores["ref"].dir, sr + ".npz"))
        assert sorted(zp.files) == sorted(zr.files)
        for k in zp.files:
            assert zp[k].dtype == zr[k].dtype and np.array_equal(zp[k], zr[k]), k
    logs = [open(glob.glob(os.path.join(path_of(tmp_path, "w", pkg),
                                        "translog", "translog-*.log"))[0],
                 "rb").read() for pkg in PACKAGES]
    assert logs[0] == logs[1]


def test_recovered_pack_is_the_same_pack(tmp_path):
    """A restart serves the pack it closed: every segment's fingerprint,
    cache key, live mask and uploaded device column equals the one
    before the close, and so do the responses. Recovery replays the
    translog and refreshes once, so the delta's epoch matches where one
    refresh followed the last commit, as here."""
    path = str(tmp_path / "same")
    build_store("port", path)
    e = new_engine("port", path, DELTA, corpus.MAPPING)
    e.flush()       # the commit holds the base and a delta of epoch 2
    for did, d in _corpus_docs()[260:270]:
        e.index(did, d)
    e.delete(_corpus_docs()[0][0])
    e.refresh()
    bodies = _bodies()
    want = _responses(e, bodies, False)
    before = [(s.fingerprint(), s.cache_key(), s.delta_epoch,
               e.live[s.seg_id].copy(),
               executor.device_arrays(s, torch.device("cpu")))
              for s in e.segments]
    gen = e.base_generation()
    e.close()
    r = new_engine("port", path, DELTA, corpus.MAPPING)
    assert r.base_generation() == gen
    assert len(r.segments) == len(before)
    # the same requests build the same lazily uploaded agg views
    assert _responses(r, bodies, False) == want
    for seg, (fp, ck, ep, live, dev) in zip(r.segments, before):
        assert (seg.fingerprint(), seg.cache_key(), seg.delta_epoch) == \
            (fp, ck, ep)
        np.testing.assert_array_equal(r.live[seg.seg_id], live)
        got = executor.device_arrays(seg, torch.device("cpu"))
        _assert_same_tree(got, dev)
    r.close()


def _assert_same_tree(a, b, path="dev"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
        return
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}.{k}")
        return
    assert a == b, path


def test_unported_columns_raise_on_load(tmp_path):
    """A reference store holding a column the port lacks (geo points)
    raises on load; vector columns, ported since, load."""
    path = str(tmp_path / "geo")
    mapping = {"properties": {"msg": {"type": "text"},
                              "g": {"type": "geo_point"},
                              "v": {"type": "dense_vector", "dims": 4}}}
    e = new_engine("ref", path, None, mapping)
    e.index("1", {"msg": "a", "g": {"lat": 1.0, "lon": 2.0},
                  "v": [1.0, 0.0, 0.0, 0.0]})
    e.flush()
    e.close()
    store = Store(path)
    stem = sorted(store.seg_stems_on_disk())[0]
    with pytest.raises(NotImplementedError, match="geos"):
        store.load_segment(stem[len("seg_"):].split("@")[0], stem=stem)
    assert durability.snapshot()["corruptions_detected"] == 0
    path = str(tmp_path / "vec")
    del mapping["properties"]["g"]
    e = new_engine("ref", path, None, mapping)
    e.index("1", {"msg": "a", "v": [1.0, 0.0, 0.0, 0.0]})
    e.flush()
    e.close()
    store = Store(path)
    stem = sorted(store.seg_stems_on_disk())[0]
    seg, _live = store.load_segment(stem[len("seg_"):].split("@")[0],
                                    stem=stem)
    assert seg.vectors["v"].values[0].tolist() == [1.0, 0.0, 0.0, 0.0]


# ---------------------------------------------------------------------------
# the crash-point matrix (the reference's MATRIX)
# ---------------------------------------------------------------------------

MATRIX = [
    ("store", "seg_npz", "flush"),
    ("store", "seg_meta", "flush"),
    ("store", "commit", "flush"),
    ("store", "cleanup", "flush"),
    ("translog", "append", "op"),
    ("translog", "fsync", "op"),
    ("translog", "rotate", "flush"),
]


def _acked_writes(e):
    for i in range(4):
        e.index(f"a{i}", {"msg": f"alpha doc {i}", "n": i})
    e.flush()
    for i in range(3):
        e.index(f"b{i}", {"msg": f"beta doc {i}", "n": 10 + i})
    e.delete("a1")
    e.index("a2", {"msg": "alpha doc 2 again", "n": 2})


@pytest.mark.parametrize("site,phase,trigger", MATRIX,
                         ids=[f"{s}-{p}" for s, p, _ in MATRIX])
def test_crash_point_matrix(tmp_path, site, phase, trigger):
    es = both(tmp_path, "crash")
    for e in es.values():
        _acked_writes(e)
    raised = {}
    with rules(f"crash_point:site={site}:phase={phase}"):
        for pkg, e in es.items():
            try:
                if trigger == "op":
                    e.index("never-acked", {"msg": "lost", "n": 99})
                else:
                    e.flush()
                raised[pkg] = None
            except (PowerLossError, RefPowerLoss) as exc:
                raised[pkg] = str(exc)
    assert raised["port"] is not None
    assert raised["port"] == raised["ref"]
    rec = {pkg: new_engine(pkg, path_of(tmp_path, "crash", pkg))
           for pkg in PACKAGES}
    assert rec["port"].failed is None and rec["ref"].failed is None
    assert_same_state(rec["port"], rec["ref"])
    acked = {"a0", "a2", "a3", "b0", "b1", "b2"}
    assert acked <= set(doc_set(rec["port"])) <= acked | {"never-acked"}
    for e in rec.values():
        e.flush()
        assert e.store.verify_integrity()["clean"]
    assert_same_state(rec["port"], rec["ref"])
    close_all(*rec.values())


def test_double_crash_then_recover(tmp_path):
    es = both(tmp_path, "c2")
    for e in es.values():
        for i in range(3):
            e.index(str(i), {"msg": f"doc {i}", "n": i})
    with rules("crash_point:site=store:phase=commit"):
        for e in es.values():
            with pytest.raises((PowerLossError, RefPowerLoss)):
                e.flush()
    es = {pkg: new_engine(pkg, path_of(tmp_path, "c2", pkg))
          for pkg in PACKAGES}
    for e in es.values():
        assert e.failed is None and e.doc_count() == 3
        e.index("3", {"msg": "doc 3", "n": 3})
    with rules("crash_point:site=translog:phase=append"):
        for e in es.values():
            with pytest.raises((PowerLossError, RefPowerLoss)):
                e.index("4", {"msg": "doc 4", "n": 4})
    es = {pkg: new_engine(pkg, path_of(tmp_path, "c2", pkg))
          for pkg in PACKAGES}
    assert es["port"].doc_count() == es["ref"].doc_count() == 4
    assert_same_state(es["port"], es["ref"])
    close_all(*es.values())


# ---------------------------------------------------------------------------
# durability modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,sync_first,spec,want", [
    ("request", False,
     "crash_point:site=translog:phase=append:unsynced=drop",
     [str(i) for i in range(10)]),
    ("async", True,
     "crash_point:site=translog:phase=append:unsynced=drop",
     [f"s{i}" for i in range(5)]),
    ("async", False, "crash_point:site=translog:phase=append",
     [str(i) for i in range(10)]),
], ids=["request-power-loss", "async-power-loss", "async-process-crash"])
def test_durability_modes(tmp_path, mode, sync_first, spec, want):
    es = both(tmp_path, "mode", {"index.translog.durability": mode})
    for e in es.values():
        assert e.translog.durability == mode
        if sync_first:
            for i in range(5):
                e.index(f"s{i}", {"msg": f"synced {i}", "n": i})
            e.translog.sync()
            for i in range(5):
                e.index(f"u{i}", {"msg": f"unsynced {i}", "n": 10 + i})
        else:
            for i in range(10):
                e.index(str(i), {"msg": f"doc {i}", "n": i})
    with rules(spec):
        for e in es.values():
            with pytest.raises((PowerLossError, RefPowerLoss)):
                e.index("never-acked", {"msg": "x", "n": 99})
    rec = {pkg: new_engine(pkg, path_of(tmp_path, "mode", pkg))
           for pkg in PACKAGES}
    assert sorted(doc_set(rec["port"])) == sorted(want)
    assert_same_state(rec["port"], rec["ref"])
    close_all(*rec.values())


def test_unknown_durability_mode_raises_like_the_reference(tmp_path):
    from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError
    with pytest.raises(IllegalArgumentError):
        Translog(str(tmp_path / "x"), durability="sometimes")


# ---------------------------------------------------------------------------
# commit fallback and the no-silent-loss fence
# ---------------------------------------------------------------------------

def _newest_commit(tmp_path, name, pkg):
    gens = sorted(glob.glob(os.path.join(path_of(tmp_path, name, pkg),
                                         "store", "commit_*.json")),
                  key=lambda p: int(p.rsplit("_", 1)[1][:-5]))
    return gens


def test_torn_newest_commit_falls_back_with_replay(tmp_path):
    es = both(tmp_path, "fb")
    for e in es.values():
        for i in range(3):
            e.index(f"a{i}", {"msg": f"doc {i}", "n": i})
        e.flush()
        for i in range(3):
            e.index(f"b{i}", {"msg": f"late doc {i}", "n": 10 + i})
    with rules("crash_point:site=store:phase=cleanup"):
        for e in es.values():
            with pytest.raises((PowerLossError, RefPowerLoss)):
                e.flush()
    for pkg in PACKAGES:
        open(_newest_commit(tmp_path, "fb", pkg)[-1], "wb").write(b'{"torn')
    base = counters()
    rec = {pkg: new_engine(pkg, path_of(tmp_path, "fb", pkg))
           for pkg in PACKAGES}
    assert rec["port"].failed is None
    assert sorted(doc_set(rec["port"])) == sorted(
        [f"a{i}" for i in range(3)] + [f"b{i}" for i in range(3)])
    assert_same_state(rec["port"], rec["ref"])
    after = counters()
    for pkg in PACKAGES:
        for k in ("commits_fell_back", "segments_salvaged"):
            assert after[pkg][k] > base[pkg][k]
    assert {k: after["port"][k] - base["port"][k] for k in after["port"]} \
        == {k: after["ref"][k] - base["ref"][k] for k in after["ref"]}
    close_all(*rec.values())


def test_fallback_survives_cleanup_of_changed_segments(tmp_path):
    es = both(tmp_path, "keep")
    for e in es.values():
        for i in range(4):
            e.index(f"a{i}", {"msg": f"doc {i}", "n": i})
        e.flush()
        e.delete("a1")
        for i in range(2):
            e.index(f"b{i}", {"msg": f"late {i}", "n": 10 + i})
    with rules("crash_point:site=translog:phase=fsync"):
        for e in es.values():
            with pytest.raises((PowerLossError, RefPowerLoss)):
                e.flush()
    for pkg in PACKAGES:
        gens = _newest_commit(tmp_path, "keep", pkg)
        assert len(gens) == 2
        flip_byte(gens[-1])
    rec = {pkg: new_engine(pkg, path_of(tmp_path, "keep", pkg))
           for pkg in PACKAGES}
    assert rec["port"].failed is None
    assert sorted(doc_set(rec["port"])) == ["a0", "a2", "a3", "b0", "b1"]
    assert_same_state(rec["port"], rec["ref"])
    close_all(*rec.values())


def test_lossy_fallback_is_refused_and_contained(tmp_path):
    es = both(tmp_path, "lossy")
    for e in es.values():
        e.index("1", {"msg": "a", "n": 1})
        e.flush()
        e.index("2", {"msg": "b", "n": 2})
        e.flush()
        e.close()
    for pkg in PACKAGES:
        gens = _newest_commit(tmp_path, "lossy", pkg)
        assert len(gens) == 2
        open(gens[-1], "wb").write(b'{"torn')
    rec = {pkg: new_engine(pkg, path_of(tmp_path, "lossy", pkg))
           for pkg in PACKAGES}
    for e in rec.values():
        assert e.failed is not None
        assert "fallback" in e.failed["reason"]
        assert e.store.corruption_marker() is not None
    assert rec["port"].failed["during"] == rec["ref"].failed["during"]
    close_all(*rec.values())


# ---------------------------------------------------------------------------
# corruption containment: the shard fails, the process does not
# ---------------------------------------------------------------------------

def _flushed(tmp_path, name, n=4, settings=None):
    for pkg in PACKAGES:
        e = new_engine(pkg, path_of(tmp_path, name, pkg), settings)
        for i in range(n):
            e.index(str(i), {"msg": f"doc {i}", "n": i})
        e.flush()
        e.close()


def _seg_npz(tmp_path, name, pkg):
    return glob.glob(os.path.join(path_of(tmp_path, name, pkg), "store",
                                  "seg_*.npz"))[0]


def test_corrupt_committed_segment_contains(tmp_path):
    _flushed(tmp_path, "seg")
    for pkg in PACKAGES:
        flip_byte(_seg_npz(tmp_path, "seg", pkg))
    base = counters()
    rec = {pkg: new_engine(pkg, path_of(tmp_path, "seg", pkg))
           for pkg in PACKAGES}
    for pkg, e in rec.items():
        assert e.failed is not None and e.failed["marker"] is not None
        err = ShardFailedError if pkg == "port" else RefShardFailed
        with pytest.raises(err):
            e.index("9", {"msg": "x", "n": 9})
        with pytest.raises(err):
            e.acquire_searcher()
        with pytest.raises(err):
            e.get("0")
        e.refresh()
        e.flush()
        e.close()
    assert _sid_free(rec["port"].failed["reason"]) == \
        _sid_free(rec["ref"].failed["reason"])
    after = counters()
    assert {k: after["port"][k] - base["port"][k] for k in after["port"]} \
        == {k: after["ref"][k] - base["ref"][k] for k in after["ref"]}
    assert after["port"]["shards_failed_corrupt"] == \
        base["port"]["shards_failed_corrupt"] + 1
    # the marker persists: a second restart is still contained
    for pkg in PACKAGES:
        e = new_engine(pkg, path_of(tmp_path, "seg", pkg))
        assert e.failed is not None and "marker" in e.failed["reason"]
        e.close()


def test_io_error_contains_without_branding_the_store(tmp_path):
    _flushed(tmp_path, "eio")
    with rules("io_error:site=store:phase=load_npz"):
        rec = {pkg: new_engine(pkg, path_of(tmp_path, "eio", pkg))
               for pkg in PACKAGES}
    for pkg, e in rec.items():
        assert e.failed is not None and e.failed["marker"] is None
        assert Store(path_of(tmp_path, "eio", pkg)).corruption_marker() \
            is None
        e.close()
    rec = {pkg: new_engine(pkg, path_of(tmp_path, "eio", pkg))
           for pkg in PACKAGES}
    assert sorted(doc_set(rec["port"])) == [str(i) for i in range(4)]
    assert_same_state(rec["port"], rec["ref"])
    close_all(*rec.values())


def test_marker_clear_is_the_operator_recovery_act(tmp_path):
    _flushed(tmp_path, "mk")
    good = {}
    for pkg in PACKAGES:
        npz = _seg_npz(tmp_path, "mk", pkg)
        good[pkg] = (npz, open(npz, "rb").read())
        flip_byte(npz)
    for pkg in PACKAGES:
        e = new_engine(pkg, path_of(tmp_path, "mk", pkg))
        assert e.failed is not None and e.failed["marker"] is not None
        e.close()
        npz, data = good[pkg]
        open(npz, "wb").write(data)
    Store(path_of(tmp_path, "mk", "port")).clear_corruption_markers()
    RefStore(path_of(tmp_path, "mk", "ref")).clear_corruption_markers()
    rec = {pkg: new_engine(pkg, path_of(tmp_path, "mk", pkg))
           for pkg in PACKAGES}
    assert rec["port"].failed is None
    assert_same_state(rec["port"], rec["ref"])
    close_all(*rec.values())


@pytest.mark.parametrize("spec,settings,marker_text", [
    ("disk_corrupt:site=store:phase=load_npz:seed=5", None,
     "CorruptIndexError"),
    ("disk_corrupt:site=store:phase=load_meta:mode=truncate", None,
     "CorruptIndexError"),
    ("disk_corrupt:site=store:phase=read_commit:seed=2", None,
     "CorruptIndexError"),
    (None, {"index.shard.check_on_startup": True}, "check_on_startup"),
], ids=["npz-flip", "meta-truncate", "commit-flip", "check_on_startup"])
def test_corruption_is_detected_by_the_production_path(tmp_path, spec,
                                                       settings, marker_text):
    _flushed(tmp_path, "dc")
    if spec is None:
        for pkg in PACKAGES:
            flip_byte(_seg_npz(tmp_path, "dc", pkg))
    with rules(spec or ""):
        rec = {pkg: new_engine(pkg, path_of(tmp_path, "dc", pkg), settings)
               for pkg in PACKAGES}
    for e in rec.values():
        assert e.failed is not None
        assert marker_text in e.failed["reason"]
    assert rec["port"].failed["reason"].split(":")[0] == \
        rec["ref"].failed["reason"].split(":")[0]
    close_all(*rec.values())


# ---------------------------------------------------------------------------
# translog corruption semantics
# ---------------------------------------------------------------------------

def test_midlog_corruption_contains(tmp_path):
    es = both(tmp_path, "mid")
    for e in es.values():
        for i in range(5):
            e.index(str(i), {"msg": f"doc {i}", "n": i})
        e.close()
    for pkg in PACKAGES:
        log = glob.glob(os.path.join(path_of(tmp_path, "mid", pkg),
                                     "translog", "translog-*.log"))[0]
        data = bytearray(open(log, "rb").read())
        data[12] ^= 0xFF
        open(log, "wb").write(bytes(data))
    rec = {pkg: new_engine(pkg, path_of(tmp_path, "mid", pkg))
           for pkg in PACKAGES}
    for e in rec.values():
        assert e.failed is not None
        assert "TranslogCorrupted" in e.failed["reason"]
    assert rec["port"].failed["reason"] == rec["ref"].failed["reason"]
    close_all(*rec.values())


def test_torn_tail_truncated_and_counted(tmp_path):
    out = {}
    for tl_cls, op_cls, pkg in ((Translog, TranslogOp, "port"),
                                (RefTranslog, RefOp, "ref")):
        path = str(tmp_path / f"torn-{pkg}")
        t = tl_cls(path)
        t.add(op_cls(OP_INDEX, "1", 1, b'{"a":1}'))
        t.add(op_cls(OP_DELETE, "2", 3))
        t.sync()
        t.close()
        with open(os.path.join(path, "translog-1.log"), "ab") as f:
            f.write(b"\xff\x00\x00\x00partial")
        t2 = tl_cls(path)
        out[pkg] = ([o.doc_id for o in t2.snapshot()], t2.truncated_bytes,
                    t2.stats())
        t2.close()
    assert out["port"] == out["ref"]
    assert out["port"][1] == 11
    assert durability.snapshot()["translog_truncated_bytes"] == 11


def test_injected_torn_append_is_recovered(tmp_path):
    es = both(tmp_path, "ta")
    for e in es.values():
        e.index("1", {"msg": "a", "n": 1})
    with rules("crash_point:site=translog:phase=append"):
        for e in es.values():
            with pytest.raises((PowerLossError, RefPowerLoss)):
                e.index("2", {"msg": "b", "n": 2})
    base = counters()
    rec = {pkg: new_engine(pkg, path_of(tmp_path, "ta", pkg))
           for pkg in PACKAGES}
    assert sorted(doc_set(rec["port"])) == ["1"]
    assert_same_state(rec["port"], rec["ref"])
    after = counters()
    got = after["port"]["translog_truncated_bytes"] \
        - base["port"]["translog_truncated_bytes"]
    assert got > 0 and got == (after["ref"]["translog_truncated_bytes"]
                               - base["ref"]["translog_truncated_bytes"])
    close_all(*rec.values())


def test_flush_io_error_fails_the_shard(tmp_path, monkeypatch):
    e = new_engine("port", str(tmp_path / "fio"))
    e.index("1", {"msg": "a", "n": 1})

    def broken(*a, **k):
        raise OSError(28, "No space left on device")
    monkeypatch.setattr(e.store, "write_commit", broken)
    with pytest.raises(ShardFailedError):
        e.flush()
    assert e.failed["during"] == "flush" and e.failed["marker"] is None
    e.close()


def test_containment_releases_fielddata_holds(tmp_path):
    from elasticsearch_tpu_torch.utils.breaker import breaker_service
    fd = breaker_service().breaker("fielddata")
    e = new_engine("port", str(tmp_path / "hold"))
    for i in range(5):
        e.index(str(i), {"msg": f"doc {i}", "n": i})
    before = fd.used
    e.refresh()
    e.acquire_searcher().search({"query": {"match": {"msg": "doc"}}})
    assert fd.used > before
    e.fail_shard("test")
    assert fd.used == before
    e.close()
