"""The hand-written CUDA kernels vs their plain versions, on the card.

Needs an NVIDIA GPU with nvcc; skips with a reason elsewhere. The file
imports no jax, so on the GPU machine it runs without the reference:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every comparison is bit-exact (`torch.equal`): the kernels use explicit
round-to-nearest adds, multiplies and divides in the plain versions' op
order, and the positional frequencies are integers. `-s` prints each
kernel's register / spill report (ptxas).
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.ops import cuda_scoring as cs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    cs.build()
    return torch.device("cuda")


def _dense_inputs(rng, B, Q, cap, L, n_terms=5000):
    tids = rng.integers(-1, n_terms, size=(cap, L)).astype(np.int32)
    imps = rng.random((cap, L), dtype=np.float32) * 5
    imps[tids < 0] = 0
    qt = rng.integers(-1, n_terms, size=(B, Q)).astype(np.int32)
    qt[:, 0] = tids[rng.integers(0, cap, size=B), 0]   # guarantee hits
    wq = rng.random((B, Q), dtype=np.float32) * 3
    wq[qt < 0] = 0
    return tids, imps, qt, wq


def _sig_bit(t):
    t = np.asarray(t, np.int64)
    h = ((t & 0xFFFFFFFF) * 0x9E3779B1) & 0xFFFFFFFF
    return np.where(t < 0, 127, (h * 127) >> 32)


@pytest.mark.parametrize("kind", ["dense", "collisions", "wild rows",
                                  "zero impacts", "negative ids",
                                  "duplicate ids", "no terms",
                                  "huge impacts"])
@pytest.mark.parametrize("cap", [4096 + 80, 70_003])
def test_dense_score_filter_equals_plain(cuda, kind, cap):
    """K1's signature filter on the card: pairs dealt to lanes, warps that
    score every pair, rows with a non-finite weight, signatures that meet
    on colliding terms, slots of impact +-0.0, negative ids with impact,
    duplicate ids in a doc, rows without terms, impacts whose hits
    overflow (a zero weight then counts), a ragged last block and a
    capacity off a multiple of 4 (scalar stores)."""
    rng = np.random.default_rng(cap + len(kind))
    B, Q, L = 45, 4, 8
    n_terms = 24 if kind == "dense" else 3000
    tids, imps, qt, wq = _dense_inputs(rng, B, Q, cap, L, n_terms)
    if kind == "collisions":
        bits = _sig_bit(np.arange(n_terms))
        for b in range(B):
            t = int(qt[b, 0])
            same = np.flatnonzero((bits == bits[t]) & (np.arange(n_terms)
                                                       != t))
            if len(same):
                tids[tids == t] = same[0]
    elif kind == "wild rows":
        wq[3, 1], wq[17, 0], wq[40, 3] = np.inf, -np.inf, np.nan
    elif kind == "zero impacts":
        imps[rng.random(imps.shape) < 0.5] = -0.0
    elif kind == "negative ids":
        tids[::5, 0], imps[::5, 0] = -3, 2.0
        qt[::3, 1], wq[::3, 1] = -3, 1.5
    elif kind == "duplicate ids":
        tids[:, 1] = tids[:, 0]
    elif kind == "no terms":
        qt[:20], wq[:20] = -1, 0.0
    elif kind == "huge impacts":
        tids[::9, 1] = np.where(tids[::9, 0] >= 0, tids[::9, 0], 5)
        imps[::9, :2] = 3e38
        qt[:, 3], wq[:, 3] = tids[0, 0], 0.0
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in (tids, imps, qt, wq)]
    got = cs.dense_score(*args)
    torch.cuda.synchronize()
    want = cs.dense_score_ref(*args)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    share = float(cs.dense_candidates_ref(*args).float().mean())
    assert (share > 0.5) if kind == "dense" else (share < 0.5)


@pytest.mark.parametrize("B,Q,L", [(1, 1, 8), (33, 3, 8), (70, 8, 32),
                                   (5, 11, 256)])
def test_dense_score_equals_plain(cuda, B, Q, L):
    rng = np.random.default_rng(B * Q * L)
    cap = 4096 + 80            # not a multiple of the 32-doc strip
    args = [torch.from_numpy(a).to(cuda)
            for a in _dense_inputs(rng, B, Q, cap, L)]
    before = cs.LAUNCHES["dense_score"]
    got = cs.dense_score(*args)
    torch.cuda.synchronize()
    assert cs.LAUNCHES["dense_score"] == before + 1
    assert torch.equal(got, cs.dense_score_ref(*args))


@pytest.mark.parametrize("B,N,sorted_rows", [(3, 640, True), (17, 300, False),
                                             (256, 128 * 8, True)])
def test_scatter_add_equals_plain(cuda, B, N, sorted_rows):
    rng = np.random.default_rng(B + N)
    cap = 50_000
    docs = rng.integers(0, cap + 500, size=(B, N)).astype(np.int32)
    if sorted_rows:
        docs = np.sort(docs.reshape(B, -1, 128), axis=-1).reshape(B, N)
        docs[:, 128:256] = docs[:, :128]          # duplicates across chunks
    docs[:, 5:9] = docs[:, 4:5]                   # duplicates inside a chunk
    vals = rng.standard_normal((B, N)).astype(np.float32)
    d = torch.from_numpy(docs).to(cuda)
    v = torch.from_numpy(vals).to(cuda)
    before = cs.LAUNCHES["scatter_add"]
    got = cs.scatter_add(d, v, cap)
    torch.cuda.synchronize()
    assert cs.LAUNCHES["scatter_add"] == before + 1
    assert torch.equal(got, cs.scatter_add_ref(d, v, cap))
    assert torch.equal(got.cpu(), cs.scatter_add_ref(d.cpu(), v.cpu(), cap))


# B, postings blocks, cap: caps that no warp's or CTA's span divides,
# one smaller than a CTA's span, and B x spans over many waves
@pytest.mark.parametrize("B,n_blocks,cap", [(5, 6, 300), (9, 20, 8192 + 5),
                                            (2, 9, 40_961),
                                            (300, 16, 1 << 20),
                                            (128, 64, (1 << 20) - 3)])
def test_scatter_add_owners_and_edges(cuda, B, n_blocks, cap):
    """K2 partitions the postings by doc bucket and sums each bucket in
    shared memory: sorted blocks repeated whole (one doc, several terms'
    postings: terms_fused), unsorted blocks with repeats within 32
    postings, ids past cap and negative ids (dropped), docs on every
    bucket edge, a ragged last block."""
    rng = np.random.default_rng(B * n_blocks)
    N = n_blocks * 128
    docs = np.sort(rng.integers(-40, cap + 40, size=(B, n_blocks, 128)),
                   axis=-1).astype(np.int32)
    docs[:, 1] = docs[:, 0]                      # a block repeated whole
    docs[:, 2] = rng.integers(-5, cap + 5, size=(B, 128))
    docs[:, 2, 7:20] = docs[:, 2, 3:4]           # repeats, unsorted
    edges = np.array([0, cap - 1, 2047, 2048, 8191, 8192, 16_383, 16_384])
    docs[:, 3, :len(edges)] = np.minimum(edges, cap - 1)
    docs = docs.reshape(B, N)[:, :N - 37]        # a ragged last chunk
    vals = rng.standard_normal(docs.shape).astype(np.float32)
    d = torch.from_numpy(np.ascontiguousarray(docs)).to(cuda)
    v = torch.from_numpy(np.ascontiguousarray(vals)).to(cuda)
    got = cs.scatter_add(d, v, cap)
    torch.cuda.synchronize()
    assert torch.equal(got, cs.scatter_add_ref(d, v, cap))


# ---------------------------------------------------------------------------
# agg sums in XLA's order: the scan (ordered_prefix) and the tree
# (ordered_sum) of csrc/ordered_scan.cu
# ---------------------------------------------------------------------------


def _wild(rng, shape):
    x = (rng.standard_normal(shape)
         * np.exp(rng.uniform(-12, 12, shape))).astype(np.float32)
    x.reshape(-1)[rng.random(x.size) < 0.05] = -0.0
    return x


@pytest.mark.parametrize("B,n,use_perm,per_row", [
    (1, 1, True, False), (3, 15, False, False), (2, 16, True, True),
    (4, 17, True, False), (70, 1000, False, True), (5, 4097, True, False),
    (3, 65_539, True, True), (64, 1 << 20, True, False),
    (4, 1 << 20, False, True), (2, 4096, "key", False),
    (128, 1 << 16, "key", True), (16, 1 << 20, "key", False),
    (3, 4098, False, False), (2, 16 ** 4 + 3, "key", True),
    (2, 1 << 21, True, True)])
def test_ordered_prefix_equals_plain(cuda, B, n, use_perm, per_row):
    """Ragged lengths, bounds at 0 and at n, one-doc and empty groups,
    shared and per-row bounds; no perm, a key sort (ascending runs) and a
    random permutation; equal to the plain scan on the card and on the
    CPU."""
    from elasticsearch_tpu_torch.ops import ordered
    rng = np.random.default_rng(B + n)
    w = _wild(rng, (B, n))
    perm = None
    if use_perm == "key":
        perm = np.argsort(rng.integers(0, 5, size=n),
                          kind="stable").astype(np.int32)
    elif use_perm:
        perm = rng.permutation(n).astype(np.int32)
    G = 9
    shape = (B, G + 1) if per_row else (G + 1,)
    pos = np.sort(rng.integers(0, n + 1, size=shape), axis=-1)
    pos[..., 0], pos[..., -1] = 0, n
    if n > 1:
        pos[..., 2] = pos[..., 1]                 # an empty group
        pos[..., 4] = np.minimum(pos[..., 3] + 1, n)   # a one-doc group
        pos = np.sort(pos, axis=-1)
    pos = pos.astype(np.int32)
    t = lambda a: None if a is None else torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(cuda)
    before = cs.LAUNCHES["ordered_prefix"]
    routes = dict(cs.SCAN_ROUTES)
    got = cs.ordered_prefix(t(w), t(perm), t(pos))
    torch.cuda.synchronize()
    assert cs.LAUNCHES["ordered_prefix"] == before + 1
    # the route follows the perm: none, a key sort's runs read from the
    # rows, a random permutation (n > 1) through the doc-major copy
    route = ("none" if perm is None else "rows" if use_perm == "key"
             or n == 1 else "doc_major")
    assert cs.SCAN_ROUTES[route] == routes[route] + 1
    assert torch.equal(got, ordered.prefix_at(t(w), t(perm), t(pos)))
    cpu = ordered.prefix_at(torch.from_numpy(w),
                            None if perm is None else torch.from_numpy(perm),
                            torch.from_numpy(pos))
    assert torch.equal(got.cpu(), cpu)
    if perm is not None:
        # the weights copied doc-major (eight rows a sector) first: rows
        # past B in the last group, B not a multiple of eight
        dm = cs.ordered_prefix(t(w), t(perm), t(pos), doc_major=True)
        torch.cuda.synchronize()
        assert torch.equal(dm, got)


@pytest.mark.parametrize("shape", [(4, 1), (5, 33), (3, 48), (2, 1000),
                                   (7, 64, 512), (3, 300, 128),
                                   (3, 1 << 20), (64, 2048, 512),
                                   (5, 31), (3, 65), (2, 100), (4, 1500),
                                   (2, 3000), (3, 20_000), (2, 100_000),
                                   (9, 32), (5, 77, 64), (128, 33, 512),
                                   (128, 40, 128), (6, 1024),
                                   (3, 1026)])
def test_ordered_sum_equals_plain(cuda, shape):
    """Rows off a power of two (XLA's centred windows: the padding split
    before and after each level), the agg views' [B, NB, 512] / [B, NB,
    128] blocks, rows packed several to a warp, rows of 2^20."""
    from elasticsearch_tpu_torch.ops import ordered
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(_wild(rng, shape)).to(cuda)
    before = cs.LAUNCHES["ordered_sum"]
    got = cs.ordered_sum(x)
    torch.cuda.synchronize()
    assert cs.LAUNCHES["ordered_sum"] == before + 1
    assert got.shape == shape[:-1]
    assert torch.equal(got, ordered.xla_block_sum(x))
    assert torch.equal(got.cpu(), ordered.xla_block_sum(x.cpu()))


@pytest.mark.parametrize("shape", [(3, 1000), (4, 64, 512)])
def test_ordered_sum_unaligned_rows(cuda, shape):
    """A view that starts one float into its storage takes the kernel's
    4-byte loads."""
    from elasticsearch_tpu_torch.ops import ordered
    rng = np.random.default_rng(5)
    n = int(np.prod(shape))
    flat = torch.from_numpy(_wild(rng, (n + 1,))).to(cuda)
    x = flat[1:].view(shape)
    got = cs.ordered_sum(x)
    torch.cuda.synchronize()
    assert torch.equal(got, ordered.xla_block_sum(x))


def _bucket_inputs(rng, B, cap, n_buckets, hot=None, p_match=0.6):
    ids = rng.integers(-n_buckets - 3, n_buckets + 3, size=cap)
    if hot is not None:
        ids[rng.random(cap) < 0.8] = hot
    values = _wild(rng, (cap,))
    mask = rng.random((B, cap)) < p_match
    mask[0] = False
    return ids.astype(np.int32), mask, values


_BUCKET_SHAPES = [
    (1, 5000, 7, None), (128, 4096, 3, 1), (3, 30_000, 1, 0),
    (4, 40_000, 100_000, None), (128, 65_536, 40_000, None),
    (2, 40_000, 3, 2), (5, 33, 4, None)]


@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("B,cap,n_buckets,hot", _BUCKET_SHAPES)
def test_ordered_bucket_sum_equals_plain(cuda, square, B, cap, n_buckets,
                                         hot):
    """The bucket sums (the bucket-stats kernel asked for one sum)
    against their plain version (XLA's scatter: a left fold per bucket
    in doc order): many buckets, one bucket, more buckets than shared
    memory would hold, a hot bucket holding most docs (its fold crosses
    tiles and ring pieces), ids out of range and negative, a row with no
    match, B 1 and 128."""
    from elasticsearch_tpu_torch.ops import ordered
    rng = np.random.default_rng(B + cap + n_buckets)
    ids, mask, values = _bucket_inputs(rng, B, cap, n_buckets, hot)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa
    st = "sum_sq" if square else "sum"
    before = cs.LAUNCHES["ordered_bucket_stats"]
    got = cs.ordered_bucket_stats(t(ids), t(mask), t(values), n_buckets,
                                  (st,))[st]
    torch.cuda.synchronize()
    assert cs.LAUNCHES["ordered_bucket_stats"] == before + 1
    want = ordered.bucket_fold(t(ids), t(mask), t(values), n_buckets, square)
    assert torch.equal(got, want)
    assert not got[0].any()


_SPECIAL = np.array([0x7FC00001, 0x7FC00005, 0xFFC00002, 0xFFC00009,
                     0x7F800001, 0xFF800003, 0x7F800000, 0xFF800000, 0,
                     0x80000000], np.uint32).view(np.float32)


@pytest.mark.parametrize("special", [0, 300])
@pytest.mark.parametrize("B,cap,n_buckets,hot", _BUCKET_SHAPES)
def test_ordered_bucket_stats_equals_plain(cuda, special, B, cap, n_buckets,
                                           hot):
    """All five stats of the bucket-stats kernel against their plain
    versions, bit for bit, on the bucket sums' shapes; with `special`,
    NaNs of both signs and payloads, infinities and signed zeros in
    bucket 0 (min / max keep the reference's NaN, -0.0 below +0.0)."""
    rng = np.random.default_rng(B * 7 + cap + n_buckets + special)
    ids, mask, values = _bucket_inputs(rng, B, cap, n_buckets, hot)
    if special:
        at = rng.choice(cap, size=min(special, cap), replace=False)
        ids[at] = 0
        values[at] = rng.choice(_SPECIAL, size=len(at))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa
    before = cs.LAUNCHES["ordered_bucket_stats"]
    got = cs.ordered_bucket_stats(t(ids), t(mask), t(values), n_buckets)
    torch.cuda.synchronize()
    assert cs.LAUNCHES["ordered_bucket_stats"] == before + 1
    want = cs.ordered_bucket_stats_ref(t(ids), t(mask), t(values), n_buckets)
    for st in cs.BUCKET_STATS:
        assert torch.equal(got[st].view(torch.int32),
                           want[st].view(torch.int32)), st
    # the count, min and max alone skip the compaction and the folds
    part = cs.ordered_bucket_stats(t(ids), t(mask), t(values), n_buckets,
                                   ("max", "count"))
    for st in ("max", "count"):
        assert torch.equal(part[st].view(torch.int32),
                           want[st].view(torch.int32)), st


# ---------------------------------------------------------------------------
# K3: the fused bundle walk
# ---------------------------------------------------------------------------

_BUNDLES = {
    "single": (("should", "terms_dense", "f", False),),
    # field g has L 6 (not a multiple of 4: scalar slot loads)
    "single_g": (("should", "terms_dense", "g", False),),
    # every impact and weight 1: all matches of a tile tie
    "ties": (("should", "terms_dense", "f", False),),
    "main": (("must", "terms_dense", "f", True),
             ("filter", "range_int", "n", False)),
    "bundle": (("must", "terms_dense", "f", True),
               ("filter", "range_int", "n", False),
               ("filter", "range_f32", "x", False),
               ("must_not", "terms_dense", "g", False),
               ("must_not", "range_int", "n", False),
               ("should", "term_text", "g", False),
               ("should", "terms_dense", "f", True)),
    # field f wider than the 8 slots the kernel holds in registers (its
    # rows are reloaded 8 slots at a time per query term): L 16 and 32,
    # L 12 (not a multiple of 8), L 10 (not a multiple of 4 either)
    "wide16": (("should", "terms_dense", "f", False),),
    "wide32": (("should", "terms_dense", "f", False),),
    "wide12": (("must", "terms_dense", "f", True),
               ("filter", "range_int", "n", False)),
    "wide10": (("should", "terms_dense", "f", False),
               ("should", "terms_dense", "g", False)),
}
# slots of field f per bundle (8 where not given)
_F_SLOTS = {"wide16": 16, "wide32": 32, "wide12": 12, "wide10": 10}


def _fwd(rng, cap, L, n_terms, tile):
    """Skewed forward index with distinct ids per doc (slot l holds ids
    = l mod L), 20% padding, dyadic impacts with many ties."""
    from elasticsearch_tpu_torch.index.segment import build_tile_max
    per = n_terms // L
    base = (per * rng.random((cap, L)) ** 3).astype(np.int32)
    tids = (base * L + np.arange(L, dtype=np.int32)[None, :])
    tids[rng.random((cap, L)) < 0.2] = -1
    imps = (rng.integers(1, 64, size=(cap, L)) / 16).astype(np.float32)
    imps[tids < 0] = 0.0
    return tids, imps, build_tile_max(tids, imps, per * L, cap, tile=tile)


def _bundle_case(bundle, cap, tile, B, dev, seed=0):
    """Seeded K3 inputs; the "ties" bundle holds every impact and query
    weight at 1, so a tile's matches all score alike and the lower doc
    must win."""
    from elasticsearch_tpu_torch.index.segment import (build_tile_max,
                                                       build_tile_minmax)
    rng = np.random.default_rng(seed)
    n_terms = 320
    text = {}
    for f, L in (("f", _F_SLOTS.get(bundle, 8)), ("g", 6)):
        tids, imps, tm = _fwd(rng, cap, L, n_terms, tile)
        if bundle == "ties":
            imps = np.where(tids < 0, 0.0, 1.0).astype(np.float32)
            tm = build_tile_max(tids, imps, (n_terms // L) * L, cap,
                                tile=tile)
        text[f] = {"fwd_tids": torch.from_numpy(tids).to(dev),
                   "fwd_imps": torch.from_numpy(imps).to(dev),
                   "tile_max": torch.from_numpy(tm).to(dev)}
    num = {}
    for f, vals in (("n", rng.integers(0, 5000, size=cap).astype(np.int32)),
                    ("x", (rng.integers(-400, 400, size=cap) / 8)
                     .astype(np.float32))):
        ex = rng.random(cap) > 0.1
        lo, hi = build_tile_minmax(vals, ex, cap, tile=tile)
        num[f] = {k: torch.from_numpy(v).to(dev) for k, v in (
            ("values", vals), ("exists", ex), ("tile_lo", lo),
            ("tile_hi", hi))}
    cl = []
    for role, kind, _f, wrapped in _BUNDLES[bundle]:
        if kind == "range_int":
            lo = rng.integers(0, 2500, size=B).astype(np.int32)
            lo = lo + (2000 if role == "must_not" else 0)
            hi = (lo + rng.integers(800, 2500, size=B)).astype(np.int32)
            cl.append((lo.astype(np.int32), hi))
        elif kind == "range_f32":
            lo = (rng.integers(-400, 100, size=B) / 8).astype(np.float32)
            cl.append((lo, (lo + 40).astype(np.float32)))
        else:
            q = 1 if kind == "term_text" else 3
            qt = rng.integers(-1, n_terms // 4, size=(B, q)).astype(np.int32)
            wq = (rng.integers(1, 8, size=(B, q)) / 4).astype(np.float32)
            if bundle == "ties":
                wq[:] = 1.0
            wq[qt < 0] = 0.0
            msm_c = (rng.integers(0, 3, size=B) if wrapped else np.ones(B))
            boost_c = ((rng.integers(1, 5, size=B) / 2) if wrapped
                       else np.ones(B))
            cl.append((qt, wq, msm_c.astype(np.int32),
                       boost_c.astype(np.float32)))
    n_should = sum(r == "should" for r, *_ in _BUNDLES[bundle])
    msm = rng.integers(0, n_should + 1, size=B).astype(np.int32)
    if len(_BUNDLES[bundle]) == 1:
        msm[:] = 1
    boost = (rng.integers(1, 5, size=B) / 2).astype(np.float32)
    live = rng.random(cap) > 0.05
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return (text, num, _BUNDLES[bundle],
            tuple(tuple(t(a) for a in inp) for inp in cl), t(msm), t(boost),
            t(live))


_K3_CASES = [("single", 4096, 1024, 16, 10, False),
             ("main", 4096, 256, 12, 10, True),
             ("bundle", 4096, 256, 9, 1, True),
             ("bundle", 4096, 256, 16, 300, False),
             ("bundle", 4096, 1024, 33, 0, True),
             ("single", 1 << 20, 1024, 64, 10, False),
             ("main", 1 << 20, 1024, 64, 100, True),
             ("main", 1 << 20, 1024, 64, 0, False),
             # the selection's branches: ck 1, one and two warps' worth,
             # far more than a tile's matches, the whole tile; L 6; ties
             # to the lower doc; B short of a batch tile
             ("single", 4096, 1024, 16, 1, False),
             ("single_g", 4096, 256, 12, 16, True),
             ("main", 4096, 1024, 20, 32, False),
             ("main", 4096, 1024, 20, 33, True),
             ("bundle", 4096, 1024, 9, 256, False),
             ("single", 4096, 1024, 5, 1024, True),
             ("ties", 4096, 1024, 11, 33, False),
             ("ties", 4096, 256, 16, 10, True),
             ("ties", 1 << 18, 1024, 40, 100, False),
             # forward rows wider than the slots held in registers
             ("wide16", 4096, 1024, 16, 10, True),
             ("wide32", 1 << 18, 1024, 24, 100, False),
             ("wide12", 4096, 256, 12, 33, True),
             ("wide10", 4096, 256, 9, 1, False)]


@pytest.mark.parametrize("bundle,cap,tile,B,k,emit", _K3_CASES)
def test_bundle_walk_equals_plain(cuda, bundle, cap, tile, B, k, emit):
    from elasticsearch_tpu_torch.ops.scoring import bundle_tile_bounds
    args = _bundle_case(bundle, cap, tile, B, cuda, seed=B + k)
    text, num, clauses, cl, msm, boost, live = args
    can, ub = bundle_tile_bounds(clauses, cl, text, num, msm, boost)
    ck = min(k, tile)
    before = cs.LAUNCHES["bundle_topk"]
    got = cs.bundle_walk(*args, can, ub, ck=ck, update_thr=True,
                         emit_match=emit)
    torch.cuda.synchronize()
    assert cs.LAUNCHES["bundle_topk"] == before + 1
    want = cs.bundle_walk_ref(*args, can, ub, ck=ck, update_thr=True,
                              emit_match=emit)
    for name, g, w in zip(("cs", "ci", "cnt", "flags", "match", "thr"), got,
                          want):
        assert (g is None and w is None) or torch.equal(g, w), name
    assert int(got[2].sum()) > 0


@pytest.mark.parametrize("bundle,cap,tile,B,k,emit", _K3_CASES)
def test_fused_entries_equal_plain(cuda, bundle, cap, tile, B, k, emit):
    args = _bundle_case(bundle, cap, tile, B, cuda, seed=3 * B + k)
    if k == 0:
        got = cs.match_mask_bundle(*args, emit_match=emit)
        want = cs.match_mask_bundle_ref(*args, emit_match=emit)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        return
    got = cs.fused_topk_bundle(*args, k, emit_match=emit)
    want = cs.fused_topk_bundle_ref(*args, k, emit_match=emit)
    torch.cuda.synchronize()
    assert torch.equal(got[2], want[2])                      # total
    assert torch.equal(got[3], want[3])                      # prune stats
    if emit:
        assert torch.equal(got[4], want[4])
    for row in range(B):
        n = min(int(want[2][row]), want[0].shape[1])
        assert torch.equal(got[0][row, :n], want[0][row, :n])
        assert torch.equal(got[1][row, :n], want[1][row, :n])


def test_bundle_walk_prunes_like_plain(cuda):
    """Hard skips (tiles without the term) and thresholded tiles (k = 1,
    a later tile's bound below the best already found in its chunk)
    show in both walks' flags, equal."""
    from elasticsearch_tpu_torch.index.segment import build_tile_max
    from elasticsearch_tpu_torch.ops.scoring import bundle_tile_bounds
    cap, tile, B = 1 << 20, 1024, 256
    tids = np.full((cap, 4), -1, np.int32)
    imps = np.zeros((cap, 4), np.float32)
    tids[: 64 * tile: 3, 0] = 0            # term 0 in the first 64 tiles
    imps[: 64 * tile: 3, 0] = 1.0
    imps[3 * 5, 0] = 4.0                   # the best doc, in tile 0
    text = {"f": {"fwd_tids": torch.from_numpy(tids).to(cuda),
                  "fwd_imps": torch.from_numpy(imps).to(cuda),
                  "tile_max": torch.from_numpy(
                      build_tile_max(tids, imps, 1, cap)).to(cuda)}}
    clauses = (("should", "terms_dense", "f", False),)
    cl = ((torch.zeros((B, 1), dtype=torch.int32, device=cuda),
           torch.ones((B, 1), device=cuda),
           torch.ones(B, dtype=torch.int32, device=cuda),
           torch.ones(B, device=cuda)),)
    msm = torch.ones(B, dtype=torch.int32, device=cuda)
    boost = torch.ones(B, device=cuda)
    live = torch.ones(cap, dtype=torch.bool, device=cuda)
    can, ub = bundle_tile_bounds(clauses, cl, text, {}, msm, boost)
    args = (text, {}, clauses, cl, msm, boost, live, can, ub)
    got = cs.bundle_walk(*args, ck=1, update_thr=True, emit_match=True)
    want = cs.bundle_walk_ref(*args, ck=1, update_thr=True, emit_match=True)
    for name, g, w in zip(("cs", "ci", "cnt", "flags", "match"), got, want):
        assert torch.equal(g, w), name
    flags = got[3]
    assert int((flags == 2).sum()) == B * (1024 - 64)
    assert int((flags == 1).sum()) > 0
    top = cs.fused_topk_bundle(text, {}, clauses, cl, msm, boost, live, 1)
    assert (top[1][:, 0] == 15).all() and (top[0][:, 0] == 4.0).all()


# ---------------------------------------------------------------------------
# K3's positional leaf (phrase / span / BM25F) and its unfused entry
# ---------------------------------------------------------------------------

_POS_BUNDLES = {
    "phrase_e2": (("should", "phrase_pos:2:e", "f", False),),
    "phrase_e3": (("should", "phrase_pos:3:e", "f", False),),
    "phrase_s3": (("should", "phrase_pos:3:s", "f", False),),
    "span_o3": (("should", "span_pos:3:o", "f", False),),
    "span_u2": (("should", "span_pos:2:u", "f", False),),
    "bm25f": (("should", "bm25f:2:3", ("f", "g"), False),),
    "mixed": (("must", "terms_dense", "f", True),
              ("filter", "range_int", "n", False),
              ("must_not", "span_pos:2:u", "g", False),
              ("should", "phrase_pos:2:s", "f", True),
              ("should", "bm25f:1:2", ("g",), False)),
}


def _pos_inputs(rng, kind, field, text, B, wrapped):
    """Positional clause inputs whose terms co-occur in some doc: the
    terms of a row are slots of one random doc, repeats and -1 mixed in."""
    from elasticsearch_tpu_torch.ops.scoring import parse_positional_kind
    head, a, _v = parse_positional_kind(kind)
    msm_c = (rng.integers(0, 3, size=B) if wrapped else np.ones(B))
    boost_c = (rng.integers(1, 5, size=B) / 2) if wrapped else np.ones(B)
    tail = ((rng.integers(1, 5, size=B) / 4).astype(np.float32),
            msm_c.astype(np.int32), boost_c.astype(np.float32))
    if head == "bm25f":
        nt = int(kind.split(":")[2])
        qt = np.stack([text[f]["tids_np"][rng.integers(
            0, text[f]["tids_np"].shape[0], size=B)][:, :nt]
            for f in field], axis=1).astype(np.int32)
        qt[rng.random(qt.shape) < 0.15] = -1
        idf = (rng.integers(1, 40, size=(B, nt)) / 8).astype(np.float32)
        wf = (rng.integers(1, 9, size=(B, len(field))) / 4).astype(
            np.float32)
        return (qt, idf, wf) + tail
    tids = text[field]["tids_np"]
    docs = tids[rng.integers(0, tids.shape[0], size=B)]
    cols = np.stack([rng.permutation(tids.shape[1])[:a] for _ in range(B)])
    if tids.shape[1] >= 255:
        cols[::2, 0] = tids.shape[1] - 1          # slot + 1 past a byte
    qt = np.take_along_axis(docs, cols, axis=1).astype(np.int32)
    if a > 2:
        qt[::4, -1] = qt[::4, 0]                 # a repeated term
    qt[rng.random(qt.shape) < 0.05] = -1
    wb = (rng.integers(1, 9, size=(B, a)) / 4).astype(np.float32)
    idf_sum = (rng.integers(1, 40, size=B) / 8).astype(np.float32)
    slop = rng.integers(0, 4, size=B).astype(np.int32)
    return (qt, wb, idf_sum, slop) + tail


def _pos_case(bundle, cap, tile, B, dev, seed=0, P=4, L_f=8):
    from elasticsearch_tpu_torch import corpus
    from elasticsearch_tpu_torch.index.segment import build_tile_minmax
    rng = np.random.default_rng(seed)
    text = {}
    for f, L in (("f", L_f), ("g", 6)):
        tids, imps, tm = _fwd(rng, cap, L, 12 * max(L, 8), tile)
        pos, k1ln, lnorm = corpus.synthetic_positions(rng, tids, P)
        text[f] = {"fwd_tids": torch.from_numpy(tids).to(dev),
                   "fwd_imps": torch.from_numpy(imps).to(dev),
                   "tile_max": torch.from_numpy(tm).to(dev),
                   "fwd_pos": torch.from_numpy(pos).to(dev),
                   "k1ln": torch.from_numpy(k1ln).to(dev),
                   "lnorm": torch.from_numpy(lnorm).to(dev), "tids_np": tids}
    vals = rng.integers(0, 5000, size=cap).astype(np.int32)
    ex = rng.random(cap) > 0.1
    lo, hi = build_tile_minmax(vals, ex, cap, tile=tile)
    num = {"n": {k: torch.from_numpy(v).to(dev) for k, v in (
        ("values", vals), ("exists", ex), ("tile_lo", lo), ("tile_hi", hi))}}
    cl = []
    for role, kind, f, wrapped in _POS_BUNDLES[bundle]:
        if kind == "range_int":
            lo_r = rng.integers(0, 2500, size=B).astype(np.int32)
            cl.append((lo_r, (lo_r + 2000).astype(np.int32)))
        elif kind == "terms_dense":
            qt = rng.integers(-1, 24, size=(B, 3)).astype(np.int32)
            wq = (rng.integers(1, 8, size=(B, 3)) / 4).astype(np.float32)
            wq[qt < 0] = 0.0
            cl.append((qt, wq, np.ones(B, np.int32),
                       (rng.integers(1, 5, size=B) / 2).astype(np.float32)))
        else:
            cl.append(_pos_inputs(rng, kind, f, text, B, wrapped))
    n_should = sum(r == "should" for r, *_ in _POS_BUNDLES[bundle])
    msm = rng.integers(0, n_should + 1, size=B).astype(np.int32)
    if n_should == 1 and len(_POS_BUNDLES[bundle]) == 1:
        msm[:] = 1
    boost = (rng.integers(1, 5, size=B) / 2).astype(np.float32)
    live = rng.random(cap) > 0.05
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    for col in text.values():
        del col["tids_np"]
    return (text, num, _POS_BUNDLES[bundle],
            tuple(tuple(t(a) for a in inp) for inp in cl), t(msm), t(boost),
            t(live))


# bundle, cap, tile, B, k, emit, and the L of field f: "mixed" at L 16
# and 64 holds a positional clause beside a dense clause on a wide field
# (K3's build with both the positional leaf and step 7's tables)
_POS_CASES = [("phrase_e2", 4096, 256, 12, 10, False, 8),
              ("phrase_e3", 4096, 1024, 9, 1, True, 8),
              ("phrase_s3", 4096, 256, 16, 10, True, 8),
              ("span_o3", 4096, 256, 12, 5, False, 8),
              ("span_u2", 4096, 256, 12, 0, True, 8),
              ("bm25f", 4096, 256, 10, 10, False, 8),
              ("mixed", 4096, 256, 17, 10, True, 8),
              ("mixed", 4096, 256, 17, 0, False, 8),
              ("mixed", 4096, 256, 17, 10, True, 16),
              ("mixed", 4096, 256, 17, 0, False, 64),
              ("mixed", 1 << 16, 1024, 40, 10, True, 64),
              ("phrase_s3", 1 << 20, 1024, 64, 10, False, 8),
              ("span_o3", 1 << 20, 1024, 64, 10, True, 8),
              ("bm25f", 1 << 20, 1024, 64, 100, False, 8)]


@pytest.mark.parametrize("bundle,cap,tile,B,k,emit,L_f", _POS_CASES)
def test_positional_walk_equals_plain(cuda, bundle, cap, tile, B, k, emit,
                                      L_f):
    from elasticsearch_tpu_torch.ops.scoring import bundle_tile_bounds
    args = _pos_case(bundle, cap, tile, B, cuda, seed=B + k, L_f=L_f)
    text, num, clauses, cl, msm, boost, live = args
    assert (cs.bundle_wide_tables(text, clauses, cl) > 0) == (L_f > 8)
    can, ub = bundle_tile_bounds(clauses, cl, text, num, msm, boost)
    ck = min(k, tile)
    before = cs.LAUNCHES["bundle_topk"]
    got = cs.bundle_walk(*args, can, ub, ck=ck, update_thr=True,
                         emit_match=emit)
    torch.cuda.synchronize()
    assert cs.LAUNCHES["bundle_topk"] == before + 1
    want = cs.bundle_walk_ref(*args, can, ub, ck=ck, update_thr=True,
                              emit_match=emit)
    for name, g, w in zip(("cs", "ci", "cnt", "flags", "match"), got, want):
        assert (g is None and w is None) or torch.equal(g, w), name
    assert int(got[2].sum()) > 0


@pytest.mark.parametrize("L_f", [16, 64])
def test_positional_wide_stepped_and_seeded_equal_plain(cuda, L_f):
    """The "mixed" bundle (a positional clause beside a dense clause on a
    field of L_f slots: K3's build with the positional leaf and step 7's
    tables) in the stepped form (chunks of 3 tiles, the threshold
    carried) and the seeded form (a delta opened at its base's k-th
    best, and the chained top-k): each equal to its plain version."""
    from elasticsearch_tpu_torch.ops.scoring import bundle_tile_bounds
    base = _pos_case("mixed", 1 << 14, 1024, 24, cuda, seed=L_f, L_f=L_f)
    text, num, clauses, cl, msm, boost, live = base
    assert cs.bundle_wide_tables(text, clauses, cl) > 0
    can, ub = bundle_tile_bounds(clauses, cl, text, num, msm, boost)
    step = (3, None, _never)
    before = cs.LAUNCHES["bundle_topk"]
    got = cs.bundle_walk_steps(cs.bundle_walk, *base, can, ub, ck=10,
                               update_thr=True, emit_match=True, step=step)
    torch.cuda.synchronize()
    assert cs.LAUNCHES["bundle_topk"] == before + 6
    want = cs.bundle_walk_steps(cs.bundle_walk_ref, *base, can, ub, ck=10,
                                update_thr=True, emit_match=True, step=step)
    for what, g, w in zip(("cs", "ci", "cnt", "flags", "match", "thr"), got,
                          want):
        assert (g is None and w is None) or torch.equal(g, w), what
    assert int(got[2].sum()) > 0
    delta = _pos_case("mixed", 1 << 12, 1024, 24, cuda, seed=L_f + 1,
                      L_f=L_f)
    # the delta's rows are the base's queries
    delta = delta[:3] + (base[3], base[4], base[5], delta[6])
    init = cs.fused_topk_bundle(*base, 10)[:2]
    text, num, clauses, cl_d, msm, boost, live = delta
    can, ub = bundle_tile_bounds(clauses, cl_d, text, num, msm, boost)
    got = cs.bundle_walk(*delta, can, ub, ck=10, update_thr=True,
                         emit_match=True, thr_init=init[0][:, -1])
    want = cs.bundle_walk_ref(*delta, can, ub, ck=10, update_thr=True,
                              emit_match=True, thr_init=init[0][:, -1])
    for what, g, w in zip(("cs", "ci", "cnt", "flags", "match", "thr"), got,
                          want):
        assert torch.equal(g, w), what
    chained = cs.fused_topk_bundle(*delta, 10, init_topk=init,
                                   idx_offset=1 << 14)
    want_c = cs.fused_topk_bundle_ref(*delta, 10, init_topk=init,
                                      idx_offset=1 << 14)
    for i in range(4):
        assert torch.equal(chained[i], want_c[i]), i


# bundle, cap, B, and the L and P of field f's pack: the widest packs the
# index admits (L 256: slot + 1 past a byte; L 64 x P 64: slot ids and
# pack too wide to stage, read from device memory)
@pytest.mark.parametrize("bundle,cap,B,L,P", [
    ("phrase_e2", 5000, 7, 8, 4), ("phrase_s3", 5000, 9, 8, 4),
    ("span_o3", 5000, 5, 8, 4), ("span_u2", 5000, 3, 8, 4),
    ("bm25f", 5000, 4, 8, 4), ("phrase_s3", 1 << 20, 64, 8, 4),
    ("bm25f", 4161, 1, 8, 4), ("phrase_e3", 4161, 300, 8, 4),
    ("phrase_s3", 4161, 130, 8, 4), ("span_o3", 4161, 257, 8, 4),
    ("span_u2", 4161, 33, 8, 4), ("bm25f", 4161, 300, 8, 4),
    ("phrase_e3", 1 << 20, 128, 8, 4),
    ("phrase_e3", 1 << 14, 40, 256, 2), ("span_u2", 1 << 14, 40, 256, 2),
    ("bm25f", (1 << 14) - 3, 33, 256, 2),
    ("phrase_s3", 1 << 15, 6, 64, 64), ("span_o3", (1 << 15) - 7, 5, 64, 64),
    ("bm25f", 1 << 15, 4, 64, 64)])
def test_positional_leaf_equals_plain(cuda, bundle, cap, B, L, P):
    """The unfused entry over the whole capacity (cap need not be a
    multiple of the staged slab), s_leaf and m_leaf, all five kinds, B
    from 1 to 300 (bm25f at 300 stages its parameter rows twice), packs
    from L 8 x P 4 to the widest the index admits."""
    args = _pos_case(bundle, cap, cap, B, cuda, seed=cap + B, P=P, L_f=L)
    text, _num, clauses, cl, *_ = args
    (_role, kind, field, _w), inp = clauses[0], cl[0]
    before = cs.LAUNCHES["positional_leaf"]
    got = cs.positional_leaf(kind, field, inp, text)
    torch.cuda.synchronize()
    assert cs.LAUNCHES["positional_leaf"] == before + 1
    want = cs.positional_leaf_ref(kind, field, inp, text)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].sum()) > 0


def test_register_and_spill_report(cuda, tmp_path):
    """ptxas' report of every kernel of the CUDA sources (printed with
    -s): each kernel builds and reports its registers, and K1, K3's walk
    (bundle_topk_kernel, all four builds: with or without a positional
    clause, with or without wide tables), the unfused leaf, K2, the scan
    and tree kernels, the bucket stats' two kernels and the fold's two
    spill nothing."""
    no_spill = {"bundle_topk": ("bundle_topk_kernel",
                                "positional_leaf_kernel"),
                "scatter_add": ("bucket_counts_kernel", "bucket_scan_kernel",
                                "bucket_scatter_kernel",
                                "bucket_accumulate_kernel"),
                "ordered_scan": ("scan_levels_kernel",
                                 "scan_levels_doc_major_kernel",
                                 "doc_major_kernel", "scan_points_kernel",
                                 "tree_pair_kernel"),
                "bucket_stats": ("compact_kernel", "fold_kernel"),
                "dense_score": ("dense_score_kernel",),
                "block_join": ("to_parent_fold_kernel",)}
    import subprocess
    for name, src in cs._SOURCES.items():
        out = subprocess.run(
            [cs._nvcc(), *cs._NVCC_FLAGS, *cs._SOURCE_FLAGS.get(name, ()),
             "-Xptxas", "-v", "-I",
             str(cs._CSRC), "-o", str(tmp_path / f"{name}.so"),
             str(cs._CSRC / src)], capture_output=True, text=True,
            check=True)
        lines = (out.stdout + out.stderr).splitlines()
        report = [ln.strip() for ln in lines
                  if "registers" in ln or "spill" in ln or "Compiling" in ln]
        print("\n".join([f"{name}:"] + report))
        assert any("registers" in ln for ln in report), name
        for kernel in no_spill.get(name, ()):
            props = [lines[i + 1] for i, ln in enumerate(lines[:-1])
                     if "Function properties for" in ln and kernel in ln]
            assert props, f"no ptxas properties for {kernel}"
            for ln in props:
                assert "0 bytes spill stores" in ln, (kernel, ln)
                assert "0 bytes spill loads" in ln, (kernel, ln)


@pytest.mark.parametrize("kind,n,nt", [("phrase_pos:8:s", 8, 0),
                                       ("bm25f:4:8", 4, 8)])
def test_leaf_plan_fits_every_admitted_pack(cuda, kind, n, nt):
    """The unfused leaf's entry plans its launch for every pack width the
    index admits (segment.pos_pack_width: L from 8 to MAX_FWD_SLOTS, P
    from 2 to POS_CAP, pow2 each) at the widest parameter rows and at 1
    and 300 rows: it fits a CTA, staging the slot ids and pack where they
    fit (always at the main path's L 8 x P 2) and reading them from
    device memory otherwise."""
    from elasticsearch_tpu_torch.index.segment import MAX_FWD_SLOTS, POS_CAP
    props = torch.cuda.get_device_properties(0)
    optin = getattr(props, "shared_memory_per_block_optin", 232_448)
    nf = n if nt else 1
    for L in (1 << k for k in range(3, MAX_FWD_SLOTS.bit_length())):
        for P in (1 << k for k in range(1, POS_CAP.bit_length())):
            for B in (1, 300):
                for pw in (2 * n + 5 if not nt else n * nt + nt + n + 3,
                           cs.POS_MAX_PARAMS):
                    cols, slab, smem = cs.leaf_plan(kind, [(L, P)] * nf, n,
                                                    nt, pw, B)
                    assert slab in (32, 64, 128) and 0 < smem <= optin, \
                        (L, P, B, pw)
                    if (L, P) == (8, 2):
                        assert cols, (B, pw)


@pytest.mark.parametrize("n_pos", range(cs.BUNDLE_MAX_CLAUSES + 1))
def test_shared_memory_fits_every_admitted_bundle(cuda, n_pos):
    """K3's entry sizes the walk's shared memory (its only definition) and
    opts the kernel in; at the widest tile (1,024 docs), the longest
    sub-chunk and the widest positional parameter rows, every bundle of 0
    to 8 positional clauses fits in a CTA, one or more an SM."""
    pw = cs.POS_MAX_PARAMS if n_pos else 0
    smem, per_sm = cs.bundle_occupancy(1024, pw, cs._BUNDLE_CHUNK_TILES,
                                       n_pos)
    props = torch.cuda.get_device_properties(0)
    assert 0 < smem <= getattr(props, "shared_memory_per_block_optin",
                               232_448)
    assert per_sm >= 1


@pytest.mark.parametrize("n_pos", range(cs.BUNDLE_MAX_CLAUSES))
def test_shared_memory_fits_wide_bundles(cuda, n_pos):
    """With its other clauses dense on wide fields at the widest qm (two
    term tables each), every bundle still fits in a CTA; the hybrid
    bundle (one wide clause of up to 4 terms, no positional clause) keeps
    two CTAs an SM."""
    pw = cs.POS_MAX_PARAMS if n_pos else 0
    n_wide = 2 * (cs.BUNDLE_MAX_CLAUSES - n_pos)
    smem, per_sm = cs.bundle_occupancy(1024, pw, cs._BUNDLE_CHUNK_TILES,
                                       n_pos, n_wide)
    props = torch.cuda.get_device_properties(0)
    assert 0 < smem <= getattr(props, "shared_memory_per_block_optin",
                               232_448)
    assert per_sm >= 1
    if n_pos == 0:
        assert cs.bundle_occupancy(1024, 0, cs._BUNDLE_CHUNK_TILES, 0,
                                   1)[1] >= 2


_DIV_SRC = r"""
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include "positional_leaf.cuh"

__global__ void div_pair(const float* a, const float* b, float* q,
                         float* want, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  q[i] = posleaf::div_rn(a[i], b[i]);
  want[i] = __fdiv_rn(a[i], b[i]);
}

extern "C" int div_pairs(const float* a, const float* b, float* q,
                         float* want, int n) {
  div_pair<<<(n + 255) / 256, 256>>>(a, b, q, want, n);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def test_leaf_division_equals_fdiv_rn(cuda, tmp_path):
    """The positional leaf's division (posleaf::div_rn, an f64 path with
    no slow-path call) gives __fdiv_rn's bits for every finite dividend
    and positive normal divisor whose reciprocal is normal: random
    operands over the whole exponent range, quotients near and below
    the smallest normal, exact quotients, and exact midpoints between
    two subnormals (ties to even)."""
    import ctypes
    import subprocess
    src = tmp_path / "div.cu"
    src.write_text(_DIV_SRC)
    lib_path = tmp_path / "div.so"
    subprocess.run([cs._nvcc(), *cs._NVCC_FLAGS, "-I", str(cs._CSRC), "-o",
                    str(lib_path), str(src)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    rng = np.random.default_rng(7)
    n = 1 << 20

    def f32(m, e):
        return np.ldexp(m, e).astype(np.float32)

    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    a = [f32(sign * rng.uniform(1, 2, n), rng.integers(-149, 128, n)),
         # quotients around 2^-126 and down into the subnormals
         f32(sign * rng.uniform(1, 2, n), rng.integers(-135, -100, n)),
         # exact quotients, and midpoints (2j + 1) 2^-150
         f32(sign * rng.integers(1, 1 << 12, n), -100),
         f32(sign * (2 * rng.integers(0, 1 << 10, n) + 1), -100)]
    b = [f32(rng.uniform(1, 2, n), rng.integers(-125, 126, n)),
         f32(rng.uniform(1, 2, n), rng.integers(-2, 20, n)),
         f32(1.0, rng.integers(-20, 40, n)),
         f32(1.0, np.full(n, 50))]
    a, b = np.concatenate(a), np.concatenate(b)
    ok = np.isfinite(a) & (b > 0) & (b >= np.float32(2.0 ** -126))
    a, b = a[ok], b[ok]
    ta = torch.from_numpy(a).to(cuda)
    tb = torch.from_numpy(b).to(cuda)
    q, want = torch.empty_like(ta), torch.empty_like(ta)
    torch.cuda.synchronize()
    assert lib.div_pairs(ctypes.c_void_p(ta.data_ptr()),
                         ctypes.c_void_p(tb.data_ptr()),
                         ctypes.c_void_p(q.data_ptr()),
                         ctypes.c_void_p(want.data_ptr()),
                         ctypes.c_int(a.size)) == 0
    got, ref = q.cpu().numpy(), want.cpu().numpy()
    # __fdiv_rn is IEEE division: the host's f64 quotient rounded once
    # more to f32 agrees (53 >= 2 * 24 + 2 bits)
    host = (a.astype(np.float64) / b.astype(np.float64)).astype(np.float32)
    assert np.array_equal(ref.view(np.uint32), host.view(np.uint32))
    bad = np.flatnonzero(got.view(np.uint32) != ref.view(np.uint32))
    assert bad.size == 0, [(float(a[i]), float(b[i]), float(got[i]),
                            float(ref[i])) for i in bad[:5]]
    tiny = np.abs(ref) < np.float32(2.0 ** -126)
    assert int((tiny & (ref != 0)).sum()) > 1000     # subnormals reached


# ---------------------------------------------------------------------------
# K3's stepped and seeded launch forms
# ---------------------------------------------------------------------------


def _never(c, st):
    return False, st


_STEP_CASES = [("main", 4096, 256, 12, 10, True, 5),
               ("bundle", 4096, 256, 16, 300, False, 3),
               ("bundle", 4096, 1024, 33, 0, True, 1),
               ("main", 1 << 20, 1024, 64, 10, True, 128),
               # spans that no sub-chunk length divides
               ("main", 4096, 256, 12, 33, True, 3),
               ("ties", 1 << 18, 1024, 24, 16, False, 100),
               ("wide16", 1 << 18, 1024, 24, 10, True, 100),
               ("wide12", 4096, 256, 12, 16, False, 3)]


@pytest.mark.parametrize("bundle,cap,tile,B,k,emit,chunk", _STEP_CASES)
def test_stepped_walk_equals_single_launch_and_plain(cuda, bundle, cap,
                                                     tile, B, k, emit,
                                                     chunk):
    """K3 stepped (one launch per chunk, threshold carried) against the
    plain stepped walk on every output, and against K3 single-launch on
    the hits, totals and mask."""
    from elasticsearch_tpu_torch.ops.scoring import bundle_tile_bounds
    args = _bundle_case(bundle, cap, tile, B, cuda, seed=5 * B + k)
    text, num, clauses, cl, msm, boost, live = args
    can, ub = bundle_tile_bounds(clauses, cl, text, num, msm, boost)
    ck = min(k, tile)
    step = (chunk, None, _never)
    n_chunks = -(-(cap // tile) // chunk)
    before = cs.LAUNCHES["bundle_topk"]
    got = cs.bundle_walk_steps(cs.bundle_walk, *args, can, ub, ck=ck,
                               update_thr=True, emit_match=emit, step=step)
    torch.cuda.synchronize()
    assert cs.LAUNCHES["bundle_topk"] == before + n_chunks
    want = cs.bundle_walk_steps(cs.bundle_walk_ref, *args, can, ub, ck=ck,
                                update_thr=True, emit_match=emit, step=step)
    for name, g, w in zip(("cs", "ci", "cnt", "flags", "match", "thr"), got,
                          want):
        assert (g is None and w is None) or torch.equal(g, w), name
    assert got[6] is False and want[6] is False
    if k:
        one = cs.fused_topk_bundle(*args, k, emit_match=emit)
        st = cs.fused_topk_bundle(*args, k, emit_match=emit, step=step)
        for i in (0, 1, 2):
            assert torch.equal(st[i], one[i]), i
    else:
        one = cs.match_mask_bundle(*args, emit_match=emit)
        st = cs.match_mask_bundle(*args, emit_match=emit, step=step)
        assert torch.equal(st[0], one[0])
    if emit:
        assert torch.equal(st[-2], one[-1])
    assert st[-1] is False


@pytest.mark.parametrize("bundle,k", [("main", 10), ("single", 100),
                                      ("single_g", 16), ("ties", 33),
                                      ("wide12", 10)])
def test_seeded_walk_equals_plain(cuda, bundle, k):
    """A delta walk seeded with a base walk's top-k (init_topk,
    idx_offset) against its plain version: every output of the seeded
    launch, and the chained top-k."""
    from elasticsearch_tpu_torch.ops.scoring import bundle_tile_bounds
    base = _bundle_case(bundle, 1 << 18, 1024, 32, cuda, seed=k)
    delta = _bundle_case(bundle, 1 << 17, 1024, 32, cuda, seed=k + 1)
    # the delta's rows are the base's queries
    delta = delta[:3] + (base[3], base[4], base[5], delta[6])
    init = cs.fused_topk_bundle(*base, k)[:2]
    text, num, clauses, cl, msm, boost, live = delta
    can, ub = bundle_tile_bounds(clauses, cl, text, num, msm, boost)
    ck = min(k, 1024)
    before = cs.LAUNCHES["bundle_topk"]
    got = cs.bundle_walk(*delta, can, ub, ck=ck, update_thr=True,
                         emit_match=True, thr_init=init[0][:, -1])
    torch.cuda.synchronize()
    assert cs.LAUNCHES["bundle_topk"] == before + 1
    want = cs.bundle_walk_ref(*delta, can, ub, ck=ck, update_thr=True,
                              emit_match=True, thr_init=init[0][:, -1])
    for name, g, w in zip(("cs", "ci", "cnt", "flags", "match", "thr"), got,
                          want):
        assert torch.equal(g, w), name
    # the chained entry on K3 against the same entry on the plain walk
    chained = cs.fused_topk_bundle(*delta, k, init_topk=init,
                                   idx_offset=1 << 18)
    want_c = cs.fused_topk_bundle_ref(*delta, k, init_topk=init,
                                      idx_offset=1 << 18)
    for i in range(4):
        assert torch.equal(chained[i], want_c[i]), i


def test_timed_out_walk_launches_only_its_chunks(cuda):
    """A check that flips at chunk 4 of 8: K3 launches 4 times, the walk
    reports timed, the skipped tiles report as thresholded."""
    from elasticsearch_tpu_torch.ops.scoring import bundle_tile_bounds
    args = _bundle_case("main", 1 << 20, 1024, 64, cuda, seed=9)
    text, num, clauses, cl, msm, boost, live = args
    can, ub = bundle_tile_bounds(clauses, cl, text, num, msm, boost)
    before = cs.LAUNCHES["bundle_topk"]
    out = cs.bundle_walk_steps(cs.bundle_walk, *args, can, ub, ck=10,
                               update_thr=True, emit_match=False,
                               step=(128, None, lambda c, st: (c >= 4, st)))
    torch.cuda.synchronize()
    assert cs.LAUNCHES["bundle_topk"] == before + 4
    assert out[6] is True
    assert (out[3][:, 512:] == 1).all() and (out[2][:, 512:] == 0).all()


# -- K3's knn_vec clause (hybrid BM25 + vector bundles) -------------------

# base bundle of _bundle_case, role of the knn clause appended to it
_KNN_CASES = {"knn_should": ("single", "should"),
              "knn_must": ("main", "must"),
              "knn_bundle": ("bundle", "should")}


def _knn_case(name, cap, tile, B, dev, seed=0, sim="cosine", D=64):
    """_bundle_case's inputs with a knn_vec clause appended: the
    similarity column of Gaussian vectors (boost folded in, 0 without a
    vector) and its slack-inflated tile max. dot_product vectors are
    scaled so that many scores and tile bounds are negative."""
    from elasticsearch_tpu_torch.ops.knn import knn_score_column
    from elasticsearch_tpu_torch.ops.scoring import slack_bound
    base, role = _KNN_CASES[name]
    text, num, clauses, cl, msm, boost, live = _bundle_case(
        base, cap, tile, B, dev, seed)
    rng = np.random.default_rng(seed + 7)
    v = rng.standard_normal((cap, D)).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    if sim == "dot_product":
        v, q = -np.abs(v) * 0.5, np.abs(q)
    ex = rng.random(cap) > 0.1
    ex[tile: 2 * tile] = False                 # a tile without vectors
    v[~ex] = 0.0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    boost_c = t((rng.integers(1, 5, size=B) / 2).astype(np.float32))
    col = (knn_score_column(t(v).to(torch.bfloat16),
                            t(np.linalg.norm(v, axis=1).astype(np.float32)),
                            t(ex), t(q), similarity=sim)
           * boost_c[:, None]).contiguous()
    ub = slack_bound(col.reshape(B, cap // tile, tile).amax(dim=2))
    return (text, num, clauses + ((role, "knn_vec", "e", False),),
            cl + ((col, t(ex), ub),), msm, boost, live)


_KNN_K3 = [("knn_should", 4096, 1024, 16, 10, False, "cosine"),
           ("knn_must", 4096, 256, 12, 10, True, "dot_product"),
           ("knn_bundle", 4096, 256, 9, 1, True, "cosine"),
           ("knn_should", 1 << 19, 1024, 64, 100, False, "cosine"),
           ("knn_must", 1 << 18, 1024, 20, 33, True, "dot_product"),
           ("knn_should", 4096, 1024, 33, 0, True, "cosine")]


@pytest.mark.parametrize("name,cap,tile,B,k,emit,sim", _KNN_K3)
def test_knn_vec_walk_equals_plain(cuda, name, cap, tile, B, k, emit, sim):
    """The single launch form with a knn_vec clause: every output of K3
    equal to the plain walk's, and the fused entries' hits."""
    from elasticsearch_tpu_torch.ops.scoring import bundle_tile_bounds
    args = _knn_case(name, cap, tile, B, cuda, seed=B + k, sim=sim)
    text, num, clauses, cl, msm, boost, live = args
    can, ub = bundle_tile_bounds(clauses, cl, text, num, msm, boost)
    ck = min(k, tile)
    before = dict(cs.BUNDLE_VEC_FORMS)
    got = cs.bundle_walk(*args, can, ub, ck=ck, update_thr=True,
                         emit_match=emit)
    torch.cuda.synchronize()
    assert cs.BUNDLE_VEC_FORMS["single"] == before["single"] + 1
    want = cs.bundle_walk_ref(*args, can, ub, ck=ck, update_thr=True,
                              emit_match=emit)
    for what, g, w in zip(("cs", "ci", "cnt", "flags", "match", "thr"), got,
                          want):
        assert (g is None and w is None) or torch.equal(g, w), what
    assert int(got[2].sum()) > 0
    if k == 0:
        g, w = (cs.match_mask_bundle(*args, emit_match=emit),
                cs.match_mask_bundle_ref(*args, emit_match=emit))
        for a, b in zip(g, w):
            assert torch.equal(a, b)
        return
    g = cs.fused_topk_bundle(*args, k, emit_match=emit)
    w = cs.fused_topk_bundle_ref(*args, k, emit_match=emit)
    for i in range(4):
        assert torch.equal(g[i], w[i]), i
    if sim == "dot_product":
        assert bool((g[0][torch.isfinite(g[0])] < 0).any())


@pytest.mark.parametrize("name,cap,tile,B,k,emit,sim,chunk", [
    ("knn_should", 4096, 256, 12, 10, True, "cosine", 5),
    ("knn_must", 1 << 18, 1024, 24, 16, False, "dot_product", 100)])
def test_knn_vec_stepped_equals_plain(cuda, name, cap, tile, B, k, emit,
                                      sim, chunk):
    from elasticsearch_tpu_torch.ops.scoring import bundle_tile_bounds
    args = _knn_case(name, cap, tile, B, cuda, seed=5 * B + k, sim=sim)
    text, num, clauses, cl, msm, boost, live = args
    can, ub = bundle_tile_bounds(clauses, cl, text, num, msm, boost)
    step = (chunk, None, _never)
    before = dict(cs.BUNDLE_VEC_FORMS)
    got = cs.bundle_walk_steps(cs.bundle_walk, *args, can, ub, ck=min(k, tile),
                               update_thr=True, emit_match=emit, step=step)
    torch.cuda.synchronize()
    assert cs.BUNDLE_VEC_FORMS["stepped"] \
        == before["stepped"] + -(-(cap // tile) // chunk)
    want = cs.bundle_walk_steps(cs.bundle_walk_ref, *args, can, ub,
                                ck=min(k, tile), update_thr=True,
                                emit_match=emit, step=step)
    for what, g, w in zip(("cs", "ci", "cnt", "flags", "match", "thr"), got,
                          want):
        assert (g is None and w is None) or torch.equal(g, w), what
    one = cs.fused_topk_bundle(*args, k, emit_match=emit)
    st = cs.fused_topk_bundle(*args, k, emit_match=emit, step=step)
    for i in (0, 1, 2):
        assert torch.equal(st[i], one[i]), i


@pytest.mark.parametrize("sim,k", [("cosine", 10), ("dot_product", 33)])
def test_knn_vec_seeded_equals_plain(cuda, sim, k):
    """A delta walk with a knn_vec clause seeded with its base walk's
    top-k: the seeded launch and the chained top-k equal their plain
    versions."""
    from elasticsearch_tpu_torch.ops.scoring import bundle_tile_bounds
    base = _knn_case("knn_must", 1 << 18, 1024, 32, cuda, seed=k, sim=sim)
    delta = _knn_case("knn_must", 1 << 17, 1024, 32, cuda, seed=k + 1,
                      sim=sim)
    delta = delta[:4] + (base[4], base[5], delta[6])
    init = cs.fused_topk_bundle(*base, k)[:2]
    text, num, clauses, cl, msm, boost, live = delta
    can, ub = bundle_tile_bounds(clauses, cl, text, num, msm, boost)
    before = dict(cs.BUNDLE_VEC_FORMS)
    got = cs.bundle_walk(*delta, can, ub, ck=k, update_thr=True,
                         emit_match=True, thr_init=init[0][:, -1])
    torch.cuda.synchronize()
    assert cs.BUNDLE_VEC_FORMS["seeded"] == before["seeded"] + 1
    want = cs.bundle_walk_ref(*delta, can, ub, ck=k, update_thr=True,
                              emit_match=True, thr_init=init[0][:, -1])
    for what, g, w in zip(("cs", "ci", "cnt", "flags", "match", "thr"), got,
                          want):
        assert torch.equal(g, w), what
    chained = cs.fused_topk_bundle(*delta, k, init_topk=init,
                                   idx_offset=1 << 18)
    want_c = cs.fused_topk_bundle_ref(*delta, k, init_topk=init,
                                      idx_offset=1 << 18)
    for i in range(4):
        assert torch.equal(chained[i], want_c[i]), i


# -- K3 on a wide text field (passages, L 64) beside a knn_vec clause ------

def _passage_case(cap, tile, B, dev, seed=0, sim="cosine", qm=4,
                  wild=False, D=32):
    """A hybrid bundle, should[dense on a passage field of 64 slots,
    knn_vec]: each doc 20-60 Zipf tokens of 600 terms, its distinct terms
    ascending then -1 (every 16th doc holds one term in two slots, every
    32nd a padded slot of nonzero impact); each row 1-3 terms of ranks
    20-80 (which most docs lack; qm 8: 5-8 terms), -1 / 0 past them; with
    `wild`, row 0 weighs a term +inf and row 1 one NaN. The column is a
    similarity of Gaussian vectors (dot_product: scores of both signs)."""
    from elasticsearch_tpu_torch.index.segment import build_tile_max
    from elasticsearch_tpu_torch.ops.knn import knn_score_column
    from elasticsearch_tpu_torch.ops.scoring import slack_bound
    rng = np.random.default_rng(seed)
    n_terms, L = 600, 64
    w = 1.0 / (np.arange(n_terms) + 3.0) ** 0.9
    tids = np.full((cap, L), -1, np.int32)
    for d in range(cap):
        row = np.unique(rng.choice(n_terms, size=int(rng.integers(20, 61)),
                                   p=w / w.sum()))
        tids[d, :row.size] = row
        if d % 16 == 5:
            tids[d, row.size] = row[0]
    imps = (rng.integers(1, 64, size=(cap, L)) / 16).astype(np.float32)
    imps[tids < 0] = 0.0
    imps[::32, -1] = 0.75
    n = rng.integers(5 if qm > 4 else 1, (qm if qm > 4 else min(3, qm)) + 1,
                     size=B)
    qt = np.full((B, qm), -1, np.int32)
    for b in range(B):
        qt[b, :n[b]] = rng.choice(np.arange(20, 80), size=n[b],
                                  replace=False)
    wq = (rng.integers(1, 16, size=(B, qm)) / 4).astype(np.float32)
    wq[qt < 0] = 0.0
    if wild:
        wq[0, 0], wq[1, 0] = np.inf, np.nan
    v = rng.standard_normal((cap, D)).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    ex = rng.random(cap) > 0.05
    v[~ex] = 0.0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    col = knn_score_column(t(v).to(torch.bfloat16),
                           t(np.linalg.norm(v, axis=1).astype(np.float32)),
                           t(ex), t(q), similarity=sim).contiguous()
    ub = slack_bound(col.reshape(B, cap // tile, tile).amax(dim=2))
    text = {"p": {"fwd_tids": t(tids), "fwd_imps": t(imps),
                  "tile_max": t(build_tile_max(tids, imps, n_terms, cap,
                                               tile=tile))}}
    clauses = (("should", "terms_dense", "p", False),
               ("should", "knn_vec", "e", False))
    cl = ((t(qt), t(wq), t(np.ones(B, np.int32)),
           t(np.ones(B, np.float32))), (col, t(ex), ub))
    boost = t((rng.integers(1, 5, size=B) / 2).astype(np.float32))
    live = t(rng.random(cap) > 0.05)
    return text, {}, clauses, cl, t(np.ones(B, np.int32)), boost, live


@pytest.mark.parametrize("sim,qm,wild,B,k", [
    ("cosine", 4, False, 20, 10), ("dot_product", 4, False, 16, 10),
    ("dot_product", 8, True, 13, 33), ("cosine", 1, True, 8, 1),
    ("dot_product", 4, False, 9, 0)])
def test_wide_knn_walk_equals_plain(cuda, sim, qm, wild, B, k):
    """K3's wide-field term tables in the hybrid bundle, the single form:
    every output equal to the plain walk's, with rows whose terms most
    docs lack, duplicate and padded slots, 1 or 2 tables (qm 8), a row
    weighing a term +inf and one NaN (each pair scored all the same),
    and dot_product scores of both signs."""
    from elasticsearch_tpu_torch.ops.scoring import bundle_tile_bounds
    args = _passage_case(1 << 14, 1024, B, cuda, seed=B + qm, sim=sim,
                         qm=qm, wild=wild)
    text, num, clauses, cl, msm, boost, live = args
    assert cs.bundle_wide_tables(text, clauses, cl) == -(-qm // 4)
    can, ub = bundle_tile_bounds(clauses, cl, text, num, msm, boost)
    before = dict(cs.BUNDLE_VEC_FORMS)
    got = cs.bundle_walk(*args, can, ub, ck=k, update_thr=True,
                         emit_match=True)
    torch.cuda.synchronize()
    assert cs.BUNDLE_VEC_FORMS["single"] == before["single"] + 1
    want = cs.bundle_walk_ref(*args, can, ub, ck=k, update_thr=True,
                              emit_match=True)
    for what, g, w in zip(("cs", "ci", "cnt", "flags", "match", "thr"), got,
                          want):
        assert (g is None and w is None) or torch.equal(g, w), what
    if sim == "dot_product":
        col = cl[1][0]
        assert bool((col < 0).any()) and bool((col > 0).any())


@pytest.mark.parametrize("sim,qm", [("cosine", 4), ("dot_product", 8)])
def test_wide_knn_stepped_and_seeded_equal_plain(cuda, sim, qm):
    """The hybrid bundle on a wide field in the stepped form (chunks of
    5 tiles, the threshold carried) and the seeded form (a delta opened
    at its base's k-th best, and the chained top-k): each equal to its
    plain version."""
    from elasticsearch_tpu_torch.ops.scoring import bundle_tile_bounds
    base = _passage_case(1 << 14, 1024, 16, cuda, seed=qm, sim=sim, qm=qm,
                         wild=True)
    text, num, clauses, cl, msm, boost, live = base
    can, ub = bundle_tile_bounds(clauses, cl, text, num, msm, boost)
    step = (5, None, _never)
    got = cs.bundle_walk_steps(cs.bundle_walk, *base, can, ub, ck=10,
                               update_thr=True, emit_match=True, step=step)
    want = cs.bundle_walk_steps(cs.bundle_walk_ref, *base, can, ub, ck=10,
                                update_thr=True, emit_match=True, step=step)
    for what, g, w in zip(("cs", "ci", "cnt", "flags", "match", "thr"), got,
                          want):
        assert (g is None and w is None) or torch.equal(g, w), what
    delta = _passage_case(1 << 12, 1024, 16, cuda, seed=qm + 1, sim=sim,
                          qm=qm)
    delta = delta[:3] + (((cl[0]),) + delta[3][1:],) + delta[4:]
    init = cs.fused_topk_bundle(*base, 10)[:2]
    text, num, clauses, cl_d, msm, boost, live = delta
    can, ub = bundle_tile_bounds(clauses, cl_d, text, num, msm, boost)
    before = dict(cs.BUNDLE_VEC_FORMS)
    got = cs.bundle_walk(*delta, can, ub, ck=10, update_thr=True,
                         emit_match=True, thr_init=init[0][:, -1])
    torch.cuda.synchronize()
    assert cs.BUNDLE_VEC_FORMS["seeded"] == before["seeded"] + 1
    want = cs.bundle_walk_ref(*delta, can, ub, ck=10, update_thr=True,
                              emit_match=True, thr_init=init[0][:, -1])
    for what, g, w in zip(("cs", "ci", "cnt", "flags", "match", "thr"), got,
                          want):
        assert torch.equal(g, w), what
    chained = cs.fused_topk_bundle(*delta, 10, init_topk=init,
                                   idx_offset=1 << 14)
    want_c = cs.fused_topk_bundle_ref(*delta, 10, init_topk=init,
                                      idx_offset=1 << 14)
    for i in range(4):
        assert torch.equal(chained[i], want_c[i]), i


def test_similarity_column_f32_accumulation(cuda):
    """The card's bf16 product returns f32 sums of exact bf16 products:
    on vectors whose every partial sum is exact it equals the CPU's
    column bit for bit, and it is not the bf16-rounded product."""
    from elasticsearch_tpu_torch.ops import knn
    rng = np.random.default_rng(3)
    v = rng.integers(-4, 5, size=(70_001, 256)).astype(np.float32)
    q = np.zeros((9, 256), np.float32)
    for b in range(9):
        q[b, rng.choice(256, 16, replace=False)] = rng.choice([-1, 1], 16)
    ex = rng.random(70_001) > 0.1
    norms = np.linalg.norm(v, axis=1).astype(np.float32)
    for sim in ("cosine", "dot_product", "l2_norm"):
        args = [torch.from_numpy(a) for a in (v, norms, ex, q)]
        args[0] = args[0].to(torch.bfloat16)
        want = knn.knn_score_column(*args, similarity=sim)
        got = knn.knn_score_column(*(a.to(cuda) for a in args),
                                   similarity=sim)
        assert got.dtype == torch.float32
        assert torch.equal(got.cpu(), want), sim
    # components up to 64 (exact in bf16): dots up to 1,024, odd ones past
    # 256 not representable in bf16, exact in f32
    w = rng.integers(-64, 65, size=(4096, 256)).astype(np.float32)
    dots = knn.bf16_dots(torch.from_numpy(q).to(cuda),
                         torch.from_numpy(w).to(cuda).to(torch.bfloat16))
    assert dots.dtype == torch.float32
    assert torch.equal(dots.cpu(), torch.from_numpy(q @ w.T))
    assert bool(((dots.abs() > 256) & (dots % 2 == 1)).any())


# -- subnormals: the agg kernels flush as XLA's CPU runtime does ----------

_SUBNORMALS = np.array([1e-40, -1e-40, 1e-45, -1e-45, 1e-38, 9.9e-39,
                        -1e-38, -9.9e-39, 3e-39, -2e-39, 0.0, -0.0,
                        1.5e-38, -1.4e-38, 1.2e-38, -1.19e-38, 1e-20,
                        -1e-20, 1.5, -2.25], np.float32)


def _bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.parametrize("seed", range(3))
def test_agg_kernels_flush_subnormals(cuda, seed):
    """The scan, tree and bucket-stats kernels on rows of subnormals,
    signed zeros and normal values whose sums cancel into the subnormal
    range give their plain versions' bits (ops/ordered.ftz)."""
    from elasticsearch_tpu_torch.ops import ordered
    rng = np.random.default_rng(seed)
    B, cap = 33, 5000
    x = torch.from_numpy(rng.choice(_SUBNORMALS, size=(B, cap))).to(cuda)
    perm = torch.from_numpy(rng.permutation(cap).astype(np.int32)).to(cuda)
    pos = torch.from_numpy(np.sort(rng.integers(0, cap + 1, 200))
                           .astype(np.int32)).to(cuda)
    for p in (None, perm):
        assert _bits_equal(cs.ordered_prefix(x, p, pos),
                           ordered.prefix_at(x, p, pos))
    for n in (1, 2, 33, 1000, cap):
        xs = x[:, :n].contiguous()
        assert _bits_equal(cs.ordered_sum(xs), ordered.xla_block_sum(xs)), n
    ids = torch.from_numpy(rng.integers(-1, 5, cap).astype(np.int32)).to(
        cuda)
    mask = torch.from_numpy(rng.random((B, cap)) < 0.6).to(cuda)
    got = cs.ordered_bucket_stats(ids, mask, x[0].contiguous(), 4)
    want = cs.ordered_bucket_stats_ref(ids, mask, x[0].contiguous(), 4)
    for st in cs.BUCKET_STATS:
        assert _bits_equal(got[st], want[st]), st


def test_agg_kernels_sass_flush(cuda, tmp_path):
    """The agg reduces and the to-parent fold are built with -ftz=true:
    every f32 add, multiply, min / max and compare in their SASS carries
    .FTZ."""
    import re
    import shutil
    import subprocess
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    f32_op = re.compile(r"\b(FADD|FMUL|FFMA|FMNMX|FSETP)\b[^;]*;")
    for name in ("ordered_scan", "bucket_stats", "block_join"):
        lib = tmp_path / f"{name}.so"
        subprocess.run([cs._nvcc(), *cs._NVCC_FLAGS, *cs._SOURCE_FLAGS[name],
                        "-I", str(cs._CSRC), "-o", str(lib),
                        str(cs._CSRC / cs._SOURCES[name])], check=True,
                       capture_output=True, text=True)
        sass = subprocess.run([tool, "-sass", str(lib)], check=True,
                              capture_output=True, text=True).stdout
        ops = [m.group(0) for m in f32_op.finditer(sass)]
        assert any(op.startswith("FADD") for op in ops), name
        plain = [op for op in ops if ".FTZ" not in op]
        print(f"{name}: {len(ops)} f32 ops, {len(plain)} without .FTZ")
        assert not plain, (name, plain[:5])


# -- the block join's to-parent fold --------------------------------------

def _block_join_inputs(rng, B, cap, hot, special):
    """Parents with 0-8 nested rows each, one with `hot` of them; scores
    of mixed signs and magnitudes (non-dyadic, cancelling sums), with
    `special` NaNs of both signs and payloads, infinities, signed zeros
    and subnormals."""
    parent_of = np.full(cap, -1, np.int32)
    i = 0
    while i < cap - 1:
        k = hot if hot and i == 0 else int(rng.integers(0, 9))
        k = min(k, cap - 1 - i)
        parent_of[i:i + k] = i + k
        i += k + 1
    target = np.where(parent_of >= 0, parent_of,
                      np.arange(cap, dtype=np.int32))
    score = (rng.standard_normal((B, cap))
             * 10.0 ** rng.integers(-3, 4, (B, cap))).astype(np.float32)
    if special:
        at = rng.random((B, cap)) < special
        score[at] = rng.choice(np.concatenate([_SPECIAL, _SUBNORMALS]),
                               size=int(at.sum()))
    ok = (rng.random((B, cap)) < 0.7) & (parent_of >= 0)[None]
    return target, score, ok


@pytest.mark.parametrize("mode", ["none", "sum", "max", "min"])
@pytest.mark.parametrize("B,cap,hot,special", [
    (3, 4096, 0, 0.0), (5, 70_003, 4096, 0.0), (4, 65_536, 300, 0.05),
    (256, 1 << 16, 0, 0.01)])
def test_to_parent_fold_equals_plain(cuda, mode, B, cap, hot, special):
    """The to-parent fold kernel against its plain version
    (ordered.parent_fold), bit for bit: the count and the mode's sum in
    ascending index order / max / min, on parents with 0-8 nested rows,
    a hot parent with thousands, a capacity off a multiple of the block,
    and NaN / +-inf / +-0 / subnormal scores (max / min keep XLA's NaN,
    -0.0 below +0.0; subnormals flushed)."""
    rng = np.random.default_rng(B * 31 + cap + hot)
    target, score, ok = _block_join_inputs(rng, B, cap, hot, special)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa
    layout = cs.block_join_layout(t(target))
    before = cs.LAUNCHES["to_parent_fold"]
    cnt, val = cs.to_parent_fold(t(score), t(ok), layout, mode)
    torch.cuda.synchronize()
    assert cs.LAUNCHES["to_parent_fold"] == before + 1
    want_cnt, want_val = cs.to_parent_fold_ref(t(score), t(ok), layout, mode)
    assert _bits_equal(cnt, want_cnt)
    if mode == "none":
        assert val is None and want_val is None
    else:
        assert _bits_equal(val, want_val), mode
    # the same fold on the CPU: the plain version's bits there too, but
    # for the payload of a NaN that an add produced (the card's adds
    # return the canonical NaN, the CPU's keep the operand's)
    cpu_cnt, cpu_val = cs.to_parent_fold(torch.from_numpy(score),
                                         torch.from_numpy(ok),
                                         cs.block_join_layout(
                                             torch.from_numpy(target)), mode)
    assert torch.equal(cnt.cpu(), cpu_cnt)
    if mode != "none":
        a, b = val.cpu(), cpu_val
        both_nan = torch.isnan(a) & torch.isnan(b)
        if mode == "sum":
            a, b = torch.where(both_nan, 0.0, a), torch.where(both_nan, 0.0, b)
        assert _bits_equal(a, b), mode


def _span_layout(cap, lists):
    """(target, parent_of) for runs of nested rows [p - k, p) before
    each parent p (lists: disjoint (p, k)), the other rows primary."""
    parent_of = np.full(cap, -1, np.int32)
    for p, k in lists:
        assert (parent_of[p - k:p + 1] == -1).all()
        parent_of[p - k:p] = p
    return np.where(parent_of >= 0, parent_of,
                    np.arange(cap, dtype=np.int32)), parent_of


# (cap, lists): a list longer than the kernel's span of 2,048 positions
# (its first spans hold nested rows only), runs that cross span
# boundaries, lists at and just past the long-list cut (32 rows), a
# long list crossing the capacity's end, a capacity off a multiple of 16
_SPAN_CASES = {
    "long_and_crossing": (8192, [(1030, 10), (2050, 3), (5000, 2900),
                                 (5100, 31), (5200, 32), (6150, 40),
                                 (7200, 20), (8191, 40)]),
    "all_child_spans": (1 << 14, [(5000, 4999), (9000, 3990), (16383, 7300)]),
    "odd_cap": (70_003, [(1030, 8), (20_000, 5000), (70_002, 33),
                         (30_000, 31)]),
}


@pytest.mark.parametrize("mode", ["none", "sum", "max", "min"])
@pytest.mark.parametrize("case", sorted(_SPAN_CASES))
@pytest.mark.parametrize("special", [0.0, 0.05])
def test_to_parent_fold_ranges_spans(cuda, mode, case, special):
    """The fold on lists longer than a span, crossing span boundaries
    and around the long-list cut, every mode, with NaN payloads,
    infinities, signed zeros and subnormals: bit for bit the plain
    version's."""
    cap, lists = _SPAN_CASES[case]
    rng = np.random.default_rng(cap + len(lists) + int(special * 100))
    target, parent_of = _span_layout(cap, lists)
    B = 6
    score = (rng.standard_normal((B, cap))
             * 10.0 ** rng.integers(-3, 4, (B, cap))).astype(np.float32)
    if special:
        at = rng.random((B, cap)) < special
        score[at] = rng.choice(np.concatenate([_SPECIAL, _SUBNORMALS]),
                               size=int(at.sum()))
    ok = (rng.random((B, cap)) < 0.7) & (parent_of >= 0)[None]
    ok[1] = (parent_of >= 0)                  # every nested row matched
    ok[2] = False                             # none
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa
    layout = cs.block_join_layout(t(target))
    assert layout["long"].numel() == sum(k + 1 > cs.FOLD_LONG_LIST
                                         for _p, k in lists)
    before = cs.LAUNCHES["to_parent_fold"]
    cnt, val = cs.to_parent_fold(t(score), t(ok), layout, mode)
    torch.cuda.synchronize()
    assert cs.LAUNCHES["to_parent_fold"] == before + 1
    want_cnt, want_val = cs.to_parent_fold_ref(t(score), t(ok), layout, mode)
    assert _bits_equal(cnt, want_cnt)
    if mode != "none":
        assert _bits_equal(val, want_val), mode


@pytest.mark.parametrize("mode", ["sum", "max"])
def test_to_parent_fold_unaligned_and_general_lists(cuda, mode):
    """Scores and flags off a 16-byte boundary (the kernel stages them a
    value at a time) bit for bit the plain version's; a target that is
    not in block order is refused before any launch."""
    rng = np.random.default_rng(11)
    B, cap = 5, 4096
    target, parent_of = _span_layout(cap, [(100, 8), (3000, 900),
                                           (1025, 3)])
    score = rng.standard_normal((B, cap)).astype(np.float32)
    ok = (rng.random((B, cap)) < 0.6) & (parent_of >= 0)[None]
    flat = torch.empty(B * cap + 1, dtype=torch.float32, device=cuda)
    s_off = flat[1:].view(B, cap)
    s_off.copy_(torch.from_numpy(score))
    flags = torch.empty(B * cap + 3, dtype=torch.bool, device=cuda)
    o_off = flags[3:].view(B, cap)
    o_off.copy_(torch.from_numpy(ok))
    layout = cs.block_join_layout(torch.from_numpy(target).to(cuda))
    got = cs.to_parent_fold(s_off, o_off, layout, mode)
    want = cs.to_parent_fold_ref(s_off, o_off, layout, mode)
    assert _bits_equal(got[0], want[0]) and _bits_equal(got[1], want[1])
    # rows after their parent: a broken block order
    general = np.array(target)
    general[3001:3101] = 3000
    with pytest.raises(ValueError, match="block order"):
        cs.block_join_layout(torch.from_numpy(general).to(cuda))


def test_nested_query_on_the_card_equals_cpu(cuda):
    """A nested index (corpus.qa_nested_docs): every score mode of a
    nested match, boosted inside a bool, and the nested / reverse_nested
    aggs answer on the card exactly as on the CPU, through the
    to_parent_fold kernel."""
    import copy
    import json
    from elasticsearch_tpu_torch import corpus
    from elasticsearch_tpu_torch.index.mapping import MapperService
    from elasticsearch_tpu_torch.index.segment import SegmentBuilder
    from elasticsearch_tpu_torch.search.shard_searcher import ShardReader
    svc = MapperService(mapping=corpus.QA_NESTED_MAPPING)
    b = SegmentBuilder()
    for did, d in corpus.qa_nested_docs(400, seed=3, hot=((0, 700),)):
        b.add(svc.parse(did, d))
    seg = b.build("nested")
    bodies = [body for mix in corpus.qa_nested_mixes(12, seed=4).values()
              for body in mix]
    before = cs.LAUNCHES["to_parent_fold"]
    outs = []
    for device in ("cpu", cuda):
        reader = ShardReader("qa", [copy.copy(seg)], {}, svc, device=device)
        resps = [reader.search(copy.deepcopy(body)) for body in bodies]
        outs.append(json.dumps([{k: v for k, v in r.items() if k != "took"}
                                for r in resps], sort_keys=True))
    assert cs.LAUNCHES["to_parent_fold"] > before
    assert outs[0] == outs[1]


# -- the breaker's device probe and a node on the card ---------------------

def test_breaker_probe_reads_mem_get_info(cuda):
    from elasticsearch_tpu_torch.utils import breaker
    from elasticsearch_tpu_torch.utils.settings import Settings
    total = torch.cuda.mem_get_info(cuda)[1]
    assert breaker._device_memory_bytes(cuda) == total
    svc = breaker.HierarchyCircuitBreakerService(Settings.EMPTY, device=cuda)
    assert svc.total_memory == total
    assert svc.breaker("fielddata").limit == int(total * 0.60)
    assert breaker._device_memory_bytes("cpu") == breaker._DEFAULT_TOTAL


def test_node_serves_on_the_card(cuda):
    """A Node on the card (device=None) and one on the CPU take the same
    writes (a base, a delta, deletes, compaction); every response of the
    corpus mixes is the CPU's, agg sums included, and the card's node
    reports its device and holds its columns against the breaker."""
    import json
    from elasticsearch_tpu_torch import corpus
    from elasticsearch_tpu_torch.node import Node
    nodes = [Node({"node.name": "gpu"}), Node({"node.name": "cpu"},
                                               device="cpu")]
    try:
        assert nodes[0].device.type == "cuda"
        docs = corpus.make_docs(3000, seed=5, long_every=100)
        mixes = corpus.request_mixes(6, seed=7, n_docs=3000, doc_seed=5)
        bodies = [b for m in ("match", "bool_aggs", "prefix", "aggs_only",
                              "match_range_aggs", "count_match",
                              "stats_aggs")
                  for b in mixes[m]]

        def same():
            got = [n.msearch([("logs", b) for b in bodies])["responses"]
                   for n in nodes]
            for r in got:
                for x in r:
                    x.pop("took", None)
            assert json.dumps(got[0], sort_keys=True) \
                == json.dumps(got[1], sort_keys=True)

        for n in nodes:
            n.create_index("logs", {"number_of_shards": 2,
                                    "index.streaming.delta": True,
                                    "index.delta.min_compact_docs": 64},
                           corpus.MAPPING)
            n.bulk([("index", {"_index": "logs", "_id": d, "doc": s})
                    for d, s in docs[:2500]], refresh=True)
        same()
        for n in nodes:
            n.bulk([("index", {"_index": "logs", "_id": d, "doc": s})
                    for d, s in docs[2500:]]
                   + [("delete", {"_index": "logs", "_id": docs[i][0]})
                      for i in range(0, 200, 7)], refresh=True)
        same()
        for n in nodes:
            for eng in n.indices["logs"].shards.values():
                eng.compact()
        same()
        stats = nodes[0].nodes_stats()["nodes"]["gpu"]
        assert stats["accelerator"]["count"] >= 1
        assert stats["breakers"]["fielddata"]["estimated_size_in_bytes"] > 0
    finally:
        for n in nodes:
            n.close()


@pytest.mark.parametrize("name", ["exp", "log", "log10", "log1p"])
def test_xla_math_on_the_card_equals_cpu(cuda, name):
    """XLA's transcendentals copied op by op (ops/xla_math) give the CPU's
    bits on the card (the CPU's are XLA's: tests/test_torch_function_score
    .py), subnormal results flushed."""
    from elasticsearch_tpu_torch.ops import xla_math
    rng = np.random.default_rng(19)
    x = np.concatenate([rng.uniform(-100, 100, 1 << 18),
                        np.exp(rng.uniform(-87, 88, 1 << 18)),
                        rng.uniform(-0.5, 0.5, 1 << 16),
                        [0.0, -0.0, 1e-40, np.inf, -np.inf, 88.8, -87.8]]
                       ).astype(np.float32)
    if name != "exp":
        x = np.abs(x) if name != "log1p" else np.maximum(x, -0.9)
    f = getattr(xla_math, name)
    want = f(torch.from_numpy(x)).numpy()
    got = f(torch.from_numpy(x).to(cuda)).cpu().numpy()
    same = (got.view(np.int32) == want.view(np.int32)) \
        | (np.isnan(got) & np.isnan(want))
    assert same.all(), (x[~same][:4], got[~same][:4], want[~same][:4])


def test_random_bits_on_the_card_equal_cpu(cuda):
    from elasticsearch_tpu_torch.search.executor import _random_bits
    seeds = torch.tensor(np.asarray([0, 7, 2 ** 31, 3_000_000_000],
                                    np.uint32).astype(np.int32))
    want = _random_bits(seeds, 1 << 18, "cpu")
    got = _random_bits(seeds.to(cuda), 1 << 18, cuda).cpu()
    assert torch.equal(got, want)


def test_dsl_mixes_on_the_card_equal_cpu(cuda):
    """Every query-DSL mix (function_score, the derived aggs, ids, exists,
    multi-term expansions) on 2 small shards: the card's responses are the
    CPU's exactly."""
    import copy
    import json
    from elasticsearch_tpu_torch import corpus
    from elasticsearch_tpu_torch.index.mapping import MapperService
    from elasticsearch_tpu_torch.index.segment import SegmentBuilder
    from elasticsearch_tpu_torch.search.shard_searcher import ShardReader
    svc = MapperService(mapping=corpus.MAPPING)
    segs = []
    for s in range(2):
        b = SegmentBuilder()
        for did, d in corpus.make_docs(3000, seed=60 + s, start=3000 * s,
                                       long_every=300):
            b.add(svc.parse(did, d))
        segs.append(b.build(f"s{s}"))
    mixes = corpus.dsl_mixes(8, seed=5, n_ids=6000)
    for device in ("cpu", cuda):
        readers = [ShardReader("logs", [copy.copy(seg)], {}, svc,
                               shard_id=i, device=device)
                   for i, seg in enumerate(segs)]
        out = {name: [[{k: v for k, v in x.items() if k != "took"}
                       for x in r.msearch(copy.deepcopy(bodies))]
                      for r in readers]
               for name, bodies in mixes.items()}
        if device == "cpu":
            want = json.dumps(out, sort_keys=True)
    assert json.dumps(out, sort_keys=True) == want


@pytest.mark.parametrize("name", ["tanh", "expm1", "sinh", "cosh", "log2",
                                  "hypot", "sin", "cos", "tan", "atan",
                                  "atan2", "asin", "acos", "pow"])
def test_script_math_on_the_card_equals_cpu(cuda, name):
    """The script math of ops/xla_math on the card: XLA's own code (tanh,
    expm1, sinh, cosh, log2, hypot) gives the CPU's bits; the C library's
    functions, taken in f64 and rounded once, agree with the CPU's within
    1 ulp (CUDA's f64 functions are not Sleef's), almost always exactly."""
    from elasticsearch_tpu_torch.ops import xla_math
    rng = np.random.default_rng(23)
    x = np.concatenate([rng.standard_normal(1 << 18) * 10,
                        rng.uniform(-1, 1, 1 << 16),
                        [0.0, -0.0, 1e-40, -1e-40, np.inf, -np.inf, np.nan,
                         20.0, -20.0, 88.0, 1.0, -1.0]]).astype(np.float32)
    y = np.roll(x, 7) * np.float32(0.3)
    if name in ("asin", "acos"):
        x = np.clip(x, -1, 1)
    if name in ("log2", "pow"):
        x = np.abs(x)
    f = getattr(xla_math, name)
    args = (x, y) if name in ("hypot", "atan2", "pow") else (x,)
    want = f(*(torch.from_numpy(a) for a in args)).numpy()
    got = f(*(torch.from_numpy(a).to(cuda) for a in args)).cpu().numpy()
    gi = got.view(np.int32).astype(np.int64)
    wi = want.view(np.int32).astype(np.int64)
    gi = np.where(gi < 0, -(gi & 0x7FFFFFFF), gi)
    wi = np.where(wi < 0, -(wi & 0x7FFFFFFF), wi)
    d = np.where(np.isnan(got) & np.isnan(want), 0, np.abs(gi - wi))
    bound = 0 if name in ("tanh", "expm1", "sinh", "cosh", "log2",
                          "hypot") else 1
    assert d.max() <= bound, (name, x[d > bound][:4], got[d > bound][:4],
                              want[d > bound][:4])
    assert (d > 0).mean() < 1e-3


def test_script_and_device_agg_mixes_on_the_card_equal_cpu(cuda):
    """The script mixes (script filter, script_score, script sort, script
    metric aggs and scripted_metric) and the percentile / cardinality mix,
    HLL registers included, on a small base + delta: the card's
    responses and partials are the CPU's exactly."""
    import copy
    import json
    from elasticsearch_tpu_torch import corpus
    from elasticsearch_tpu_torch.index.mapping import MapperService
    from elasticsearch_tpu_torch.index.segment import (SegmentBuilder,
                                                       pad_delta_shapes)
    from elasticsearch_tpu_torch.search.shard_searcher import ShardReader
    svc = MapperService(mapping=corpus.MAPPING)
    docs = corpus.make_docs(3300, seed=61, long_every=300)
    segs = []
    for seg_id, part in (("base", docs[:3000]), ("delta0", docs[3000:])):
        b = SegmentBuilder()
        for did, d in part:
            b.add(svc.parse(did, d))
        segs.append(b.build(seg_id))
    segs[1].delta_parent = segs[0].cache_key()
    pad_delta_shapes(segs[1])
    mixes = corpus.script_mixes(8, seed=5)

    def norm(v):
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, dict):
            return {str(k): norm(x) for k, x in v.items() if k != "took"}
        if isinstance(v, list):
            return [norm(x) for x in v]
        return v

    outs = []
    for device in ("cpu", cuda):
        reader = ShardReader("logs", [copy.copy(s) for s in segs], {}, svc,
                             device=device)
        outs.append(json.dumps({name: [norm(r) for r in reader.msearch(
            copy.deepcopy(bodies), with_partials=(name == "pctl_card"))]
            for name, bodies in mixes.items()}, sort_keys=True))
    assert outs[0] == outs[1]
