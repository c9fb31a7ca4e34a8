"""function_score: the PyTorch port vs the JAX reference, on the CPU.

* XLA's f32 `exp`, `log`, `log10`, `log1p` (what the reference's
  compiled programs run) against the port's op-by-op copies
  (`ops/xla_math`): bit for bit on seeded inputs across each function's
  range, subnormal results flushed; torch's own functions are measured
  beside them (the gap the copies close).
* random_score's hash: the reference's bits for seeds with and without
  the top bit set.
* Every field_value_factor modifier, decay shape (gauss / exp / linear
  on a date and a numeric field), score_mode and boost_mode, min_score,
  max_boost, a missing column and filtered functions, through the
  searchers with every matching doc returned: scores bit for bit.
* score_mode sum / avg over two or more unfiltered functions: XLA
  contracts one of each add's bare products into an FMA, picked by an
  operand rank of LLVM's that the port does not model
  (`executor._fma_sum`): hits and totals exact, scores within 4 ulps
  (measured here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.mapping import MapperService as RefMapper
from elasticsearch_tpu.index.segment import SegmentBuilder as RefBuilder
from elasticsearch_tpu.search import executor as ref_ex
from elasticsearch_tpu.search.shard_searcher import ShardReader as RefReader

from elasticsearch_tpu_torch import corpus
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.ops import xla_math
from elasticsearch_tpu_torch.ops.knn import sqrt_rn
from elasticsearch_tpu_torch.search import executor as ex
from elasticsearch_tpu_torch.search.shard_searcher import ShardReader

torch.set_num_threads(1)

N_DOCS = 1200
SUM_ULP_BOUND = 4


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.astype(np.float32).view(np.int32).astype(np.int64)
                  - b.astype(np.float32).view(np.int32).astype(np.int64))


def _inputs(name: str) -> np.ndarray:
    rng = np.random.default_rng(17)
    n = 200_000
    if name == "exp":
        x = [rng.uniform(-100, 100, n), rng.uniform(-1, 1, n),
             [0.0, -0.0, -87.8, 88.8, 89.0, -88.0, -103.0, np.inf, -np.inf,
              1e-40]]
    elif name == "log1p":
        x = [np.exp(rng.uniform(-30, 30, n)), rng.uniform(-0.5, 0.5, n),
             [0.0, -0.0, 0.41421, 0.4142137, np.inf, 1e-40, -0.999]]
    else:
        x = [np.exp(rng.uniform(-87, 88, n)), rng.uniform(0.5, 2, n),
             rng.uniform(0, 1e5, n), [0.0, 1.0, 2.0, np.inf, 1e-40, 1e-38]]
    return np.concatenate(x).astype(np.float32)


FUNCS = {"exp": (jnp.exp, xla_math.exp, torch.exp),
         "log": (jnp.log, xla_math.log, torch.log),
         "log10": (jnp.log10, xla_math.log10, torch.log10),
         "log1p": (jnp.log1p, xla_math.log1p, torch.log1p)}


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_transcendentals_are_xla_bits(name):
    jf, port_f, torch_f = FUNCS[name]
    x = _inputs(name)
    want = np.asarray(jax.jit(jf)(x))
    got = port_f(torch.from_numpy(x)).numpy()
    same = (got.view(np.int32) == want.view(np.int32)) \
        | (np.isnan(got) & np.isnan(want))
    assert same.all(), (x[~same][:4], got[~same][:4], want[~same][:4])
    # torch's own function: the gap the copy closes (normal results)
    native = torch_f(torch.from_numpy(x)).numpy()
    ok = np.isfinite(want) & (np.abs(want) >= np.finfo(np.float32).tiny)
    gap = _ulps(native[ok], want[ok])
    assert (gap > 0).mean() > 0.01


def test_sqrt_is_correctly_rounded():
    x = np.concatenate([np.arange(0, 200_000, dtype=np.float32),
                        np.exp(np.random.default_rng(2).uniform(
                            -80, 80, 100_000)).astype(np.float32)])
    want = np.asarray(jax.jit(jnp.sqrt)(x))
    got = sqrt_rn(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", [0, 7, 12345, 2 ** 31 - 1, 2 ** 31,
                                  3_000_000_000, 2 ** 32 - 1])
def test_random_score_bits(seed):
    """The reference's uint32-stacked seed travels as int32 bits; the
    hash then runs in int32 (see executor._random_bits)."""
    cap = 1 << 16
    s32 = np.asarray([seed], np.uint32).astype(np.int32)
    want = np.asarray(jax.jit(lambda a: ref_ex._eval_score_fn(
        ("fn_random", None, None), ((a, jnp.ones(1, jnp.float32)), ()),
        {}, cap, 1)[0])(jnp.asarray(s32)))
    got = ex._random_bits(torch.from_numpy(s32), cap, "cpu").numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert 0.0 <= got.min() and got.max() < 0.5


@pytest.fixture(scope="module")
def readers():
    docs = corpus.make_docs(N_DOCS, seed=42, long_every=300)
    docs = [(d, {k: v for k, v in doc.items()
                 if not (k == "size" and int(d) % 11 == 0)})
            for d, doc in docs]
    out = []
    for mapper_cls, builder_cls, reader_cls, kw in (
            (MapperService, SegmentBuilder, ShardReader, {"device": "cpu"}),
            (RefMapper, RefBuilder, RefReader, {})):
        svc = mapper_cls(mapping=corpus.MAPPING)
        b = builder_cls()
        for did, d in docs:
            b.add(svc.parse(did, d))
        out.append(reader_cls("logs", [b.build("s0")], {}, svc, **kw))
    return out


F = {"term": {"status": "200"}}
FNS = {
    **{f"fvf_{m}": {"field_value_factor": {
        "field": "size", "modifier": m, "factor": 0.37, "missing": 3.3},
        "weight": 1.7}
       for m in ("none", "log", "log1p", "log2p", "ln", "ln1p", "ln2p",
                 "square", "sqrt", "reciprocal")},
    "fvf_no_column": {"field_value_factor": {
        "field": "nosuch", "modifier": "log1p", "missing": 3.3},
        "weight": 1.3},
    "gauss_date": {"gauss": {"@timestamp": {
        "origin": "2015-01-27T00:00:00", "scale": "2d", "decay": 0.4}},
        "weight": 2.3},
    "gauss_num": {"gauss": {"size": {"origin": 50000, "scale": 20000}}},
    "exp_num": {"exp": {"size": {"origin": 50000, "scale": 20000,
                                 "offset": 100, "decay": 0.3}},
                "weight": 0.7},
    "exp_date": {"exp": {"@timestamp": {
        "origin": "2015-01-10T00:00:00", "scale": "5d", "offset": "1d"}}},
    "linear_num": {"linear": {"size": {"origin": 50000, "scale": 20000}},
                   "weight": 1.9},
    "decay_no_column": {"gauss": {"nosuch": {"origin": 1, "scale": 2}}},
    "random": {"random_score": {"seed": 7}, "weight": 1.3},
    "weight": {"weight": 2.9},
    "weight_filtered": {"filter": F, "weight": 2.9},
    "fvf_filtered": {"filter": F, "field_value_factor": {
        "field": "size", "modifier": "log1p"}, "weight": 1.7},
    "gauss_filtered": {"filter": F, "gauss": {
        "size": {"origin": 50000, "scale": 20000}}, "weight": 1.1},
}


def _all_hits(readers, fs_body):
    body = {"query": {"function_score": fs_body}, "size": N_DOCS,
            "_source": False}
    port, ref = readers
    return port.msearch([body])[0], ref.msearch([body])[0]


@pytest.mark.parametrize("fn", sorted(FNS))
@pytest.mark.parametrize("boost_mode", ["multiply", "sum"])
def test_each_function_exact(readers, fn, boost_mode):
    got, want = _all_hits(readers, {
        "query": {"match": {"message": "get html"}}, "functions": [FNS[fn]],
        "boost_mode": boost_mode, "boost": 1.3})
    assert got["hits"] == want["hits"]
    assert want["hits"]["total"] > 0


@pytest.mark.parametrize("boost_mode", ["multiply", "replace", "sum", "avg",
                                        "max", "min"])
def test_boost_modes_exact(readers, boost_mode):
    got, want = _all_hits(readers, {
        "query": {"match": {"message": "post images"}},
        "functions": [FNS["fvf_log1p"]], "boost_mode": boost_mode,
        "max_boost": 3.5})
    assert got["hits"] == want["hits"]


@pytest.mark.parametrize("score_mode", ["multiply", "max", "min", "first",
                                        "sum", "avg"])
def test_score_modes_exact(readers, score_mode):
    """Every mode over one unfiltered function and filtered ones (no add
    of two bare products: exact), with min_score."""
    got, want = _all_hits(readers, {
        "query": {"match": {"message": "get"}},
        "functions": [FNS["gauss_date"], FNS["weight_filtered"],
                      FNS["fvf_filtered"], FNS["gauss_filtered"]],
        "score_mode": score_mode, "boost_mode": "replace",
        "min_score": 0.3})
    assert got["hits"] == want["hits"]
    assert want["hits"]["total"] > 0


@pytest.mark.parametrize("score_mode", ["multiply", "max", "min", "first"])
def test_unfiltered_many_exact(readers, score_mode):
    got, want = _all_hits(readers, {
        "query": {"match": {"message": "get"}},
        "functions": [FNS["fvf_log1p"], FNS["gauss_date"], FNS["random"],
                      FNS["fvf_none"], FNS["exp_num"]],
        "score_mode": score_mode, "boost_mode": "sum"})
    assert got["hits"] == want["hits"]


def test_no_functions_and_defaults(readers):
    got, want = _all_hits(readers, {"query": {"match": {"message": "html"}},
                                    "functions": []})
    assert got["hits"] == want["hits"]
    got, want = _all_hits(readers, {"functions": [FNS["random"]]})
    assert got["hits"] == want["hits"]


SUMS = [("fvf_log1p", "gauss_date", "weight_filtered", "random"),
        ("fvf_log1p", "fvf_none"), ("gauss_date", "random"),
        ("fvf_none", "random", "exp_num"), ("fvf_log1p", "gauss_num",
                                             "linear_num", "weight")]


@pytest.mark.parametrize("score_mode", ["sum", "avg"])
@pytest.mark.parametrize("fns", SUMS, ids=["+".join(f) for f in SUMS])
def test_unfiltered_sums_within_bound(readers, score_mode, fns):
    got, want = _all_hits(readers, {
        "query": {"match": {"message": "get post"}},
        "functions": [FNS[f] for f in fns], "score_mode": score_mode,
        "boost_mode": "sum", "boost": 1.1})
    assert got["hits"]["total"] == want["hits"]["total"] > 0
    g = {h["_id"]: h["_score"] for h in got["hits"]["hits"]}
    w = {h["_id"]: h["_score"] for h in want["hits"]["hits"]}
    assert sorted(g) == sorted(w)
    ids = sorted(w)
    d = _ulps(np.asarray([g[i] for i in ids], np.float32),
              np.asarray([w[i] for i in ids], np.float32))
    assert d.max() <= SUM_ULP_BOUND, d.max()
