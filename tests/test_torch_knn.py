"""Dense vectors in the PyTorch port vs the JAX reference, on the CPU:
the similarity column, exact kNN selection, the dense_vector mapping,
the vector column and its compaction.

Tolerances.
* Dyadic vectors (doc components small integers in [-4, 4], query
  components +-1 on 4^m coordinates, so every f32 partial sum of a dot
  product is exact and the query's norm is a power of two): the column
  equals the reference's bit for bit (`torch.equal` of the f32 bits).
* Gaussian vectors: the product's f32 sums over D run in another order
  than XLA's (no simple order reproduces XLA's CPU dot), so each dot
  lies within gamma_D * sum_d |q_d v_d| of the other, gamma_D = D *
  2^-24 (the two bf16-rounded operands are the same and their products
  exact in f32). Through the transform that is: cosine, the dot bound
  over 2 max(|v|, 1e-12); dot_product, over 2; l2_norm, 2 (2 dot bound)
  / (1 + d2)^2 to first order; plus 2 ulps of the score for the
  transform's own roundings on the two sides.
* Selection, ids, ties, mapping JSON, parsed values, norms and
  concatenated columns: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.mapping import MapperService as RefMapper
from elasticsearch_tpu.index.segment import SegmentBuilder as RefBuilder
from elasticsearch_tpu.index.segment import \
    concat_segments as ref_concat
from elasticsearch_tpu.ops import knn as ref_knn
from elasticsearch_tpu.utils.errors import \
    MapperParsingError as RefMapperParsingError

from elasticsearch_tpu_torch import corpus
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import (SegmentBuilder,
                                                   concat_segments)
from elasticsearch_tpu_torch.ops import knn
from elasticsearch_tpu_torch.utils.errors import MapperParsingError

torch.set_num_threads(1)

SIMS = ("cosine", "dot_product", "l2_norm")


def _dyadic(rng, n, d, b):
    v = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
    return v, corpus._dyadic_queries(rng, b, d)


# the reference's column as its search programs compute it: compiled
# (eagerly, op by op, XLA contracts no multiply-add into an FMA; inside a
# program it fuses the l2 transform's |x|^2 - 2 q.x into one)
_ref_column = jax.jit(ref_knn.knn_score_column, static_argnames="similarity")


def _columns(v, ex, q, sim):
    norms = np.linalg.norm(v, axis=1).astype(np.float32)
    ref = np.asarray(_ref_column(
        jnp.asarray(v), jnp.asarray(norms), jnp.asarray(ex), jnp.asarray(q),
        similarity=sim))
    port = knn.knn_score_column(
        torch.from_numpy(v).to(torch.bfloat16), torch.from_numpy(norms),
        torch.from_numpy(ex), torch.from_numpy(q), similarity=sim).numpy()
    return port, ref, norms


@pytest.mark.parametrize("sim", SIMS)
@pytest.mark.parametrize("d", [256, 8, 40])
def test_score_column_dyadic_equals_reference(sim, d):
    rng = np.random.default_rng(d)
    v, q = _dyadic(rng, 2048, d, 8)
    ex = rng.random(2048) > 0.1
    v[~ex] = 0.0
    port, ref, _ = _columns(v, ex, q, sim)
    assert np.array_equal(port.view(np.int32), ref.view(np.int32))
    if sim == "dot_product":
        assert (ref < 0).any()        # negative transformed scores


@pytest.mark.parametrize("sim", SIMS)
@pytest.mark.parametrize("d", [256, 40])
def test_score_column_gaussian_within_bound(sim, d):
    rng = np.random.default_rng(100 + d)
    n, b = 4096, 8
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    ex = rng.random(n) > 0.1
    port, ref, norms = _columns(v, ex, q, sim)
    # the bf16-rounded operands both sides multiply
    vb = torch.from_numpy(v).to(torch.bfloat16).float().numpy()
    qf = q
    if sim == "cosine":
        qn = np.sqrt((q.astype(np.float64) ** 2).sum(1, keepdims=True))
        qf = (q / qn).astype(np.float32)
    qb = torch.from_numpy(qf).to(torch.bfloat16).float().numpy()
    s_abs = np.abs(qb.astype(np.float64)) @ np.abs(vb.astype(np.float64)).T
    dot_bound = d * 2.0 ** -24 * s_abs
    if sim == "cosine":
        bound = dot_bound / (2 * np.maximum(norms, 1e-12))[None, :]
    elif sim == "dot_product":
        bound = dot_bound / 2
    else:
        r64 = np.asarray(ref, np.float64)
        d2 = 1.0 / np.where(r64 > 0, r64, 1.0) - 1.0
        bound = 2 * (2 * dot_bound) / (1 + d2) ** 2
    bound = bound + 2 * np.spacing(np.abs(ref).astype(np.float32))
    diff = np.abs(port.astype(np.float64) - ref.astype(np.float64))
    assert (diff <= bound).all(), float((diff - bound).max())
    assert (port[:, ~ex] == 0).all() and (ref[:, ~ex] == 0).all()


@pytest.mark.parametrize("d", [256, 128, 64, 40, 33, 8, 5, 1])
def test_query_norm_in_xla_order(d):
    q = np.random.default_rng(d).standard_normal((16, d)).astype(np.float32)
    want = np.asarray(jnp.linalg.norm(jnp.asarray(q), axis=1))
    got = knn.query_norm(torch.from_numpy(q))[:, 0].numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("sim", SIMS)
def test_knn_topk_ties_equal_reference(sim):
    """Duplicated rows score alike; the lower doc wins, as lax.top_k."""
    rng = np.random.default_rng(7)
    base, q = _dyadic(rng, 256, 16, 6)
    v = np.concatenate([base] * 8)                       # 2048 rows
    ex = rng.random(2048) > 0.05
    live = rng.random(2048) > 0.05
    v[~ex] = 0.0
    norms = np.linalg.norm(v, axis=1).astype(np.float32)
    rs, ri = ref_knn.knn_topk(jnp.asarray(v), jnp.asarray(norms),
                              jnp.asarray(ex), jnp.asarray(live),
                              jnp.asarray(q), similarity=sim, k=50)
    ps, pi = knn.knn_topk(torch.from_numpy(v).to(torch.bfloat16),
                          torch.from_numpy(norms), torch.from_numpy(ex),
                          torch.from_numpy(live), torch.from_numpy(q),
                          similarity=sim, k=50)
    assert np.array_equal(ps.numpy().view(np.int32),
                          np.asarray(rs).view(np.int32))
    assert np.array_equal(pi.numpy(), np.asarray(ri))
    scores = ps.numpy()
    assert (scores[:, :-1] == scores[:, 1:]).any()      # ties present


def test_knn_topk_exact_selection_at_2_18():
    """At 2^18 docs the reference's TPU path selects with approx_max_k
    (on the CPU: lax.top_k's result); the port selects exactly."""
    rng = np.random.default_rng(11)
    n = 1 << 18
    v, q = _dyadic(rng, n, 8, 4)
    ex = np.ones(n, bool)
    norms = np.linalg.norm(v, axis=1).astype(np.float32)
    rs, ri = ref_knn.knn_topk(jnp.asarray(v), jnp.asarray(norms),
                              jnp.asarray(ex), jnp.asarray(ex),
                              jnp.asarray(q), similarity="cosine", k=100,
                              approx_recall=0.99)
    ps, pi = knn.knn_topk(torch.from_numpy(v).to(torch.bfloat16),
                          torch.from_numpy(norms), torch.from_numpy(ex),
                          torch.from_numpy(ex), torch.from_numpy(q),
                          similarity="cosine", k=100)
    assert np.array_equal(ps.numpy().view(np.int32),
                          np.asarray(rs).view(np.int32))
    assert np.array_equal(pi.numpy(), np.asarray(ri))


_MAPPINGS = [
    {"properties": {"e": {"type": "dense_vector", "dims": 3}}},
    {"properties": {"e": {"type": "dense_vector", "dims": 3,
                          "similarity": "dot_product"},
                    "t": {"type": "text"}}},
    {"properties": {"e": {"type": "dense_vector", "similarity": "l2_norm"}}},
    {"properties": {"e": {"type": "dense_vector", "dims": 2,
                          "similarity": "cosine"}}},
]


@pytest.mark.parametrize("mapping", _MAPPINGS)
def test_mapping_and_parse_equal_reference(mapping):
    port, ref = MapperService(mapping=mapping), RefMapper(mapping=mapping)
    assert port.mapping_dict() == ref.mapping_dict()
    fm = port.field("e")
    assert (fm.similarity or "cosine") == ref.field("e").similarity
    dims = ref.field("e").dims or 4
    src = {"e": [float(i) / 3 for i in range(dims)], "t": "a b"}
    p, r = port.parse("1", src), ref.parse("1", src)
    assert [(f.name, f.type, f.value) for f in p.fields] \
        == [(f.name, f.type, f.value) for f in r.fields]


@pytest.mark.parametrize("src", [{"e": 1.5}, {"e": [1.0, 2.0]},
                                 {"e": "abc"}])
def test_mapping_errors_equal_reference(src):
    mapping = _MAPPINGS[0]
    port, ref = MapperService(mapping=mapping), RefMapper(mapping=mapping)
    with pytest.raises(MapperParsingError) as pe:
        port.parse("1", src)
    with pytest.raises(RefMapperParsingError) as re_:
        ref.parse("1", src)
    assert str(pe.value) == str(re_.value)


def _both_segments(docs, mapping, seg_id="s"):
    out = []
    for mapper_cls, builder_cls in ((MapperService, SegmentBuilder),
                                    (RefMapper, RefBuilder)):
        svc = mapper_cls(mapping=mapping)
        b = builder_cls()
        for did, d in docs:
            b.add(svc.parse(did, d))
        out.append(b.build(seg_id))
    return out


def _same_vectors(p, r):
    assert sorted(p.vectors) == sorted(r.vectors)
    for f in r.vectors:
        pv, rv = p.vectors[f], r.vectors[f]
        for a, b in ((pv.values, rv.values), (pv.exists, rv.exists),
                     (pv.norms, rv.norms)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_vector_column_build_equals_reference():
    docs = corpus.make_passages(700, 24, seed=3, n_centers=8,
                                missing_every=9)
    p, r = _both_segments(docs, corpus.passage_mapping(24))
    _same_vectors(p, r)
    assert p.field_kind("embedding") == r.field_kind("embedding") \
        == "vector"
    assert p.vectors["embedding"].nbytes() == r.vectors["embedding"].nbytes()
    assert not p.vectors["embedding"].exists[8]


def test_compaction_concatenates_vectors():
    mapping = corpus.passage_mapping(16)
    a = _both_segments(corpus.make_passages(300, 16, seed=1, n_centers=4,
                                            missing_every=7), mapping, "a")
    b = _both_segments(corpus.make_passages(200, 16, seed=2, start=300,
                                            n_centers=4), mapping, "b")
    text_only = _both_segments([(f"t{i}", {"passage": "images french"})
                                for i in range(40)], mapping, "c")
    rng = np.random.default_rng(5)
    live = {"a": rng.random(a[0].capacity) > 0.2,
            "b": rng.random(b[0].capacity) > 0.2}
    got = concat_segments([a[0], text_only[0], b[0]], "m", live)
    want = ref_concat([a[1], text_only[1], b[1]], "m", live)
    assert got.ids == want.ids and got.capacity == want.capacity
    _same_vectors(got, want)
    # a deletes-free fold of one vector segment keeps its IVF index
    a[0].ann = {"embedding": object()}
    kept = concat_segments([a[0], text_only[0]], "k")
    assert kept.ann["embedding"] is a[0].ann["embedding"]
    assert not concat_segments([a[0], b[0]], "k2").ann
