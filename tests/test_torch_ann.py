"""The IVF coarse index and probe of the PyTorch port vs the JAX
reference, on the CPU.

* Build: the host k-means (`_kmeans_host`, its cluster sums in
  np.add.at's order) equals the reference's bit for bit; the full
  assignment (`_assign_full`, torch) equals the reference's except on
  rows whose two nearest centroids lie within the product's rounding
  bound, where either choice is a nearest centroid.
* Probe: `cluster_bounds` (against the reference's compiled program, as
  it serves) and `cluster_bounds_np` equal the reference's bit for bit;
  `ivf_topk` over a reference-built index gives the reference's scores,
  ids and (probed, pruned, scored) stats exactly on dyadic vectors (the
  index's centroids rounded to multiples of 1/64 so that every dot is
  exact on both sides).
* Recall@10 of the port's own build against the exact scan is at least
  the reference's declared 0.95 (`index/ann.DEFAULT_RECALL`), deletes
  are respected, segments below `min_docs` and delta segments never
  build, a failed build degrades to the exact scan, and each package's
  store reads the other's vectors and IVF arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index import ann as ref_ann
from elasticsearch_tpu.index.mapping import MapperService as RefMapper
from elasticsearch_tpu.index.segment import SegmentBuilder as RefBuilder
from elasticsearch_tpu.index.store import Store as RefStore
from elasticsearch_tpu.ops import ann as ref_ops
from elasticsearch_tpu.search.shard_searcher import ShardReader as RefReader

from elasticsearch_tpu_torch import corpus
from elasticsearch_tpu_torch.index import ann
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.index.store import Store
from elasticsearch_tpu_torch.ops import ann as ops_ann
from elasticsearch_tpu_torch.ops import knn
from elasticsearch_tpu_torch.search import executor as ex
from elasticsearch_tpu_torch.search.shard_searcher import ShardReader

torch.set_num_threads(1)

SIMS = ("cosine", "dot_product", "l2_norm")


@pytest.fixture
def low_min_docs():
    tokens = (ann.configure(min_docs=256), ref_ann.configure(min_docs=256))
    yield
    ann.reset(if_current=tokens[0])
    ref_ann.reset(if_current=tokens[1])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n,d,c", [(3000, 16, 64), (2000, 40, 256),
                                   (6000, 8, 32)])
def test_kmeans_host_equals_reference(n, d, c):
    """Ties (duplicated rows), signed zeros and empty clusters (256
    centroids over few distinct rows) included."""
    rng = np.random.default_rng(n + d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[: n // 4] = x[n // 4: n // 2]
    x[:20] = -0.0
    if c == 256:
        x = x[rng.integers(0, 300, n)]
    got = ann._kmeans_host(x, c, seed=3)
    want = ref_ann._kmeans_host(x, c, seed=3)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_cluster_sums_equal_add_at():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5000, 16)).astype(np.float32)
    x[::7] = -0.0
    assign = rng.integers(0, 70, 5000)
    assign[assign == 3] = 4                      # an empty cluster
    counts = np.bincount(assign, minlength=70)
    want = np.zeros((70, 16), np.float32)
    np.add.at(want, assign, x)
    got = ann._cluster_sums(x, assign, counts, 70)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_assign_full_equals_reference_but_near_ties():
    rng = np.random.default_rng(2)
    d = 32
    x = rng.standard_normal((20000, d)).astype(np.float32)
    cent = ann._kmeans_host(x[:4000], 128, seed=1)
    a_p, r_p = ann._assign_full(x, cent, torch.device("cpu"), chunk=4096)
    a_r, r_r = ref_ann._assign_full(x, cent, chunk=4096)
    diff = np.nonzero(a_p != a_r)[0]
    assert diff.size < 20
    x64, c64 = x.astype(np.float64), cent.astype(np.float64)
    c2 = (c64 ** 2).sum(1)
    for i in diff:
        # both choices lie within the f32 product's rounding of each other
        dp = c2[a_p[i]] - 2 * x64[i] @ c64[a_p[i]]
        dr = c2[a_r[i]] - 2 * x64[i] @ c64[a_r[i]]
        tol = 4 * d * 2.0 ** -24 * (np.abs(x64[i]) @ np.abs(c64[a_p[i]])
                                    + np.abs(x64[i]) @ np.abs(c64[a_r[i]])
                                    + c2[a_p[i]] + c2[a_r[i]])
        assert abs(dp - dr) <= tol
    # every row lies within its cluster's radius
    d_true = np.sqrt(((x64 - c64[a_p]) ** 2).sum(1))
    assert (d_true <= r_p[a_p] * (1 + 1e-5) + 1e-6).all()
    assert np.allclose(r_p, r_r, rtol=1e-5, atol=1e-6)


_ref_bounds = jax.jit(ref_ops.cluster_bounds, static_argnames="similarity")


@pytest.mark.parametrize("sim", SIMS)
@pytest.mark.parametrize("dyadic", [True, False])
def test_cluster_bounds_equal_reference(sim, dyadic):
    rng = np.random.default_rng(5)
    c, d, b = 256, 64, 16
    cent = rng.standard_normal((c, d)).astype(np.float32)
    radii = np.abs(rng.standard_normal(c)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    if dyadic:
        cent = (np.round(cent * 64) / 64).astype(np.float32)
        q = corpus._dyadic_queries(rng, b, d)
    want = np.asarray(_ref_bounds(jnp.asarray(cent), jnp.asarray(radii),
                                  jnp.asarray(q), similarity=sim))
    got = ops_ann.cluster_bounds(_t(cent), _t(radii), _t(q),
                                 similarity=sim).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    np_got = ops_ann.cluster_bounds_np(cent, radii, q, similarity=sim)
    np_want = ref_ops.cluster_bounds_np(cent, radii, q, similarity=sim)
    assert np.array_equal(np_got.view(np.int32), np_want.view(np.int32))


def _dyadic_index(sim, n=6000, d=16, seed=9):
    """A reference-built IVF index over dyadic vectors, its centroids
    rounded to multiples of 1/64 (an index of the same shape whose every
    bound and score is exact on both sides), radii recomputed."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
    ex = rng.random(n) > 0.05
    v[~ex] = 0.0
    prior = ref_ann.configure(min_docs=1)
    try:
        ai = ref_ann.build_ann(v, ex, sim, seed=2)
    finally:
        ref_ann.reset(if_current=prior)
    cent = (np.round(ai.centroids * 64) / 64).astype(np.float32)
    x = ref_ann._working_space(v, sim).astype(np.float64)
    radii = np.zeros(ai.n_clusters, np.float32)
    for ci in range(ai.n_clusters):
        m = ai.members[ci][ai.members[ci] >= 0]
        if m.size:
            radii[ci] = np.sqrt(((x[m] - cent[ci]) ** 2).sum(1)).max()
    arrays = {**ai.arrays(), "centroids": cent, "radii": radii}
    return v, ex, rng.random(n) > 0.1, arrays


@pytest.mark.parametrize("sim", SIMS)
def test_ivf_topk_over_reference_index_equals_reference(sim):
    v, ex, live, arrays = _dyadic_index(sim)
    ai = ann.AnnIndex.from_arrays(sim, arrays)
    rai = ref_ann.AnnIndex.from_arrays(sim, arrays)
    q = corpus._dyadic_queries(np.random.default_rng(4), 6, v.shape[1])
    norms = np.linalg.norm(v, axis=1).astype(np.float32)
    nprobe = ann.default_nprobe(ai.n_clusters)
    rs, ri, rst = ref_ops.ivf_topk(
        jnp.asarray(v, dtype=jnp.bfloat16), jnp.asarray(norms),
        jnp.asarray(ex), jnp.asarray(live), jnp.asarray(rai.members),
        jnp.asarray(rai.centroids), jnp.asarray(rai.radii), jnp.asarray(q),
        similarity=sim, k=10, nprobe=nprobe)
    before = ops_ann.HOST_SYNCS["ivf_slot"]
    ps, pi, pst = ops_ann.ivf_topk(
        _t(v).to(torch.bfloat16), _t(norms), _t(ex), _t(live),
        _t(ai.members), _t(ai.centroids), _t(ai.radii), _t(q),
        similarity=sim, k=10, nprobe=nprobe)
    assert ops_ann.HOST_SYNCS["ivf_slot"] == before + nprobe
    rs, ri = np.asarray(rs), np.asarray(ri)
    assert np.array_equal(ps.numpy().view(np.int32), rs.view(np.int32))
    fin = np.isfinite(rs)
    assert np.array_equal(pi.numpy()[fin], ri[fin])
    assert np.array_equal(pst.numpy(), np.asarray(rst))
    assert live[pi.numpy()[fin]].all()


def _clustered(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((64, d)).astype(np.float32)
    v = (centers[rng.integers(0, 64, n)]
         + rng.standard_normal((n, d)).astype(np.float32) * 0.2)
    q = (v[rng.integers(0, n, 32)]
         + rng.standard_normal((32, d)).astype(np.float32) * 0.1)
    return v.astype(np.float32), q.astype(np.float32)


@pytest.mark.parametrize("sim", ["cosine", "dot_product"])
def test_own_build_recall_and_deletes(low_min_docs, sim):
    n, d = 16384, 32
    v, q = _clustered(n, d, 8)
    ex = np.ones(n, bool)
    live = np.random.default_rng(3).random(n) > 0.1
    ai = ann.build_ann(v, ex, sim)
    assert ai is not None and ai.n_clusters == 128
    norms = np.linalg.norm(v, axis=1).astype(np.float32)
    vb = _t(v).to(torch.bfloat16)
    s_ivf, i_ivf, stats = ops_ann.ivf_topk(
        vb, _t(norms), _t(ex), _t(live), _t(ai.members), _t(ai.centroids),
        _t(ai.radii), _t(q), similarity=sim, k=10,
        nprobe=ann.default_nprobe(ai.n_clusters))
    s_ex, _i = knn.knn_topk(vb, _t(norms), _t(ex), _t(live), _t(q),
                            similarity=sim, k=10)
    s_ivf, s_ex = s_ivf.numpy(), s_ex.numpy()
    # score-based recall@10: a hit reaches the exact k-th best
    hits = sum(int((s_ivf[r] >= s_ex[r, -1]).sum()) for r in range(32))
    assert hits / (32 * 10) >= ann.DEFAULT_RECALL
    assert live[i_ivf.numpy()].all()                 # deletes respected
    assert int(stats[1]) > 0                         # the prune fired


def _pair(docs, mapping):
    out = []
    for mapper_cls, builder_cls in ((MapperService, SegmentBuilder),
                                    (RefMapper, RefBuilder)):
        svc = mapper_cls(mapping=mapping)
        b = builder_cls()
        for did, d in docs:
            b.add(svc.parse(did, d))
        out.append((svc, b.build("s0")))
    return out


def test_small_and_delta_segments_never_build():
    docs = corpus.make_passages(300, 8, seed=1, dyadic=True)
    mapping = corpus.passage_mapping(8)
    (_svc, small), _ = _pair(docs, mapping)
    (_svc, delta), _ = _pair(docs, mapping)
    (_svc, base), _ = _pair(docs, mapping)
    assert ann.min_docs() == ann.DEFAULT_MIN_DOCS
    assert ann.ensure_ann(small, "embedding", "cosine") is None
    prior = ann.configure(min_docs=1)
    try:
        # as the reference's: a segment that did not build stays on the
        # exact scan until it is rebuilt
        assert ann.ensure_ann(small, "embedding", "cosine") is None
        delta.delta_parent = "base"
        assert ann.ensure_ann(delta, "embedding", "cosine") is None
        assert ann.ensure_ann(base, "embedding", "cosine") is not None
    finally:
        ann.reset(if_current=prior)


def test_failed_build_degrades_to_the_exact_scan(low_min_docs, monkeypatch):
    docs = corpus.make_passages(1200, 8, seed=2, dyadic=True)
    (svc, seg), (rsvc, rseg) = _pair(docs, corpus.passage_mapping(8))
    calls = []

    def broken(*a, **k):
        calls.append(1)
        raise RuntimeError("injected build failure")

    monkeypatch.setattr(ann, "build_ann", broken)
    ex._fused_stats.reset()
    port = ShardReader("p", [seg], {}, svc, device="cpu")
    q = corpus._dyadic_queries(np.random.default_rng(0), 4, 8)
    bodies = corpus.knn_mixes(q, 4)["knn"]
    got = port.msearch(bodies)
    assert len(calls) == 1 and seg._ann_skip == {"embedding"}   # sticky
    assert ex.fused_scoring_stats()["admission"]["knn"] == {"exact": 4}
    prior = ref_ann.configure(min_docs=1 << 30)      # the exact scan
    try:
        want = RefReader("p", [rseg], {}, rsvc).msearch(bodies)
    finally:
        ref_ann.reset(if_current=prior)
    for g, w in zip(got, want):
        g.pop("took"), w.pop("took")
    assert got == want


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_store_round_trip_both_ways(tmp_path, writer, low_min_docs):
    docs = corpus.make_passages(900, 8, seed=3, missing_every=11,
                                n_centers=8)
    (svc, seg), (rsvc, rseg) = _pair(docs, corpus.passage_mapping(8))
    built = ann.ensure_ann(seg, "embedding", "cosine")
    rseg.ann = {"embedding": ref_ann.AnnIndex.from_arrays(
        "cosine", built.arrays())}
    src = seg if writer == "port" else rseg
    w_store = (Store if writer == "port" else RefStore)(str(tmp_path))
    stem = w_store.save_segment(src)
    r_store = (RefStore if writer == "port" else Store)(str(tmp_path))
    loaded, _live = r_store.load_segment(src.seg_id, stem=stem)
    for f in ("values", "exists", "norms"):
        assert np.array_equal(getattr(loaded.vectors["embedding"], f),
                              getattr(src.vectors["embedding"], f))
    got, want = loaded.ann["embedding"], src.ann["embedding"]
    assert got.similarity == want.similarity
    for name, arr in want.arrays().items():
        assert np.array_equal(got.arrays()[name], arr)
