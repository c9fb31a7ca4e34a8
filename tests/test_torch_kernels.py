"""Kernel modules of the PyTorch port vs the JAX reference, on the CPU.

`ops/cuda_scoring` holds two hand-written CUDA kernels, each beside a
plain PyTorch version that repeats its arithmetic op for op. Here the
plain versions are held against the reference's Pallas kernels (run in
interpret mode, as tests/test_pallas_scoring.py runs them) and against
the jnp paths the reference executor takes on the CPU. The CUDA kernels
themselves run only on the card (tests/test_torch_cuda.py and
chip_smoke.py); what can be checked here about them is their
preprocessing and, through a host emulation, the order in which the
scatter kernel adds each doc's postings.

Tolerances: bit-exact, except one case. The reference executor's jnp
programs keep mul and add as separate ops on the CPU (no FMA
contraction), which the exact equalities against `eval_node` below
demonstrate. The Pallas dense kernel in interpret mode does contract some
of its `acc + hit * wq` steps: with Q > 1 query terms its scores sit
up to Q - 1 ULP from the plain version's (measured: 1 ULP at Q = 3,
2 ULP at Q = 8; neither a separate-op nor an all-FMA replay reproduces
it), so that comparison is held within the reference's own FMA slack
`BOUND_SLACK` (ops/scoring.py:147) and Q - 1 ULP, with identical match
masks. Where the reference sums within a
chunk on its MXU (Pallas scatter with duplicate docs inside one
128-posting chunk), inputs are chosen exactly representable so any order
agrees.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.ops.pallas_scoring import (scatter_add_pallas,
                                                  score_terms_dense_pallas)
from elasticsearch_tpu.ops.scoring import (BOUND_SLACK,
                                           batched_scatter_add as ref_bsa,
                                           score_term as ref_score_term,
                                           score_terms_fused as ref_fused)
from elasticsearch_tpu.search import executor as ref_ex

from elasticsearch_tpu_torch.ops import cuda_scoring as cs
from elasticsearch_tpu_torch.ops import scoring as port_scoring

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _fwd_index(rng, cap, L, n_terms, unique=True):
    """Doc-major forward index as the segment builder lays it out:
    each doc's slots hold distinct term ids from slot 0, padded -1 / 0."""
    tids = np.full((cap, L), -1, np.int32)
    imps = np.zeros((cap, L), np.float32)
    lens = rng.integers(0, L + 1, size=cap)
    for d in range(cap):
        n = lens[d]
        if unique:
            tids[d, :n] = rng.choice(n_terms, size=n, replace=False)
        else:
            tids[d, :n] = rng.integers(0, n_terms, size=n)
        imps[d, :n] = rng.random(n, dtype=np.float32) * 4
    return tids, imps


def _queries(rng, B, Q, n_terms):
    qt = rng.integers(-1, n_terms, size=(B, Q)).astype(np.int32)
    wq = rng.random((B, Q), dtype=np.float32) * 3
    wq[qt < 0] = 0.0
    return qt, wq


class TestDenseScore:
    @pytest.mark.parametrize("B,Q,L", [(5, 1, 8), (67, 3, 8), (9, 8, 32)])
    def test_plain_matches_pallas_interpret(self, B, Q, L):
        rng = np.random.default_rng(B * 100 + Q * 10 + L)
        cap = 1024
        # duplicate term ids inside a doc row too: the Pallas body and
        # the plain version both add slots in ascending l
        tids, imps = _fwd_index(rng, cap, L, 40, unique=False)
        qt, wq = _queries(rng, B, Q, 40)
        got = cs.dense_score(_t(tids), _t(imps), _t(qt), _t(wq)).numpy()
        ref = np.asarray(score_terms_dense_pallas(
            jnp.asarray(tids), jnp.asarray(imps), jnp.asarray(qt),
            jnp.asarray(wq), interpret=True))
        assert got.dtype == np.float32 and got.shape == (B, cap)
        np.testing.assert_array_equal(got > 0, ref > 0)
        ulps = np.abs(got.view(np.int32).astype(np.int64)
                      - ref.view(np.int32).astype(np.int64))
        assert ulps.max() <= Q - 1
        np.testing.assert_allclose(got, ref, rtol=BOUND_SLACK - 1.0, atol=0)

    @pytest.mark.parametrize("Q", [2, 4, 8])
    def test_plain_matches_jnp_terms_dense(self, Q):
        rng = np.random.default_rng(Q)
        cap, L, B = 512, 16, 7
        tids, imps = _fwd_index(rng, cap, L, 60)
        qt, wq = _queries(rng, B, Q, 60)
        seg = {"text": {"f": {"fwd_tids": jnp.asarray(tids),
                              "fwd_imps": jnp.asarray(imps)}}}
        ref_s, ref_m = ref_ex.eval_node(("terms_dense", "f", Q),
                                        (jnp.asarray(qt), jnp.asarray(wq)),
                                        seg, cap, B)
        got = cs.dense_score(_t(tids), _t(imps), _t(qt), _t(wq)).numpy()
        np.testing.assert_array_equal(got, np.asarray(ref_s))
        np.testing.assert_array_equal(got > 0, np.asarray(ref_m))

    def test_plain_matches_jnp_term_text(self):
        rng = np.random.default_rng(3)
        cap, L, B = 256, 8, 6
        tids, imps = _fwd_index(rng, cap, L, 30)
        tid = rng.integers(-1, 30, size=B).astype(np.int32)
        w = (rng.random(B, dtype=np.float32) + 0.5).astype(np.float32)
        seg = {"text": {"f": {"fwd_tids": jnp.asarray(tids),
                              "fwd_imps": jnp.asarray(imps)}}}
        ref_s, _ = ref_ex.eval_node(("term_text", "f"),
                                    (jnp.asarray(tid), jnp.asarray(w)),
                                    seg, cap, B)
        got = cs.dense_score(_t(tids), _t(imps), _t(tid[:, None]),
                             _t(w[:, None])).numpy()
        np.testing.assert_array_equal(got, np.asarray(ref_s))

    def test_wrapper_counts_no_launch_on_cpu(self):
        before = dict(cs.LAUNCHES)
        rng = np.random.default_rng(0)
        tids, imps = _fwd_index(rng, 128, 8, 10)
        qt, wq = _queries(rng, 2, 2, 10)
        cs.dense_score(_t(tids), _t(imps), _t(qt), _t(wq))
        assert cs.LAUNCHES == before


def _postings(rng, B, n_blocks, cap, dup_blocks=True):
    """Rows of doc-sorted 128-lane posting blocks, as the gathers hand
    them to the scatter: sorted distinct docs per block, tails padded
    with `cap`, blocks repeated across the row (one doc, several terms)."""
    docs = np.full((B, n_blocks, 128), cap, np.int32)
    vals = np.zeros((B, n_blocks, 128), np.float32)
    for b in range(B):
        for j in range(n_blocks):
            if dup_blocks and j > 0 and rng.random() < 0.3:
                src = rng.integers(0, j)
                docs[b, j] = docs[b, src]
            else:
                n = int(rng.integers(1, 129))
                docs[b, j, :n] = np.sort(rng.choice(cap, size=n,
                                                    replace=False))
            vals[b, j] = rng.random(128, dtype=np.float32)
    return docs.reshape(B, -1), vals.reshape(B, -1)


def _partition(docs, cap, span, block=2048, warp=256):
    """Host model of csrc/scatter_add.cu's passes 1-3: each in-range
    posting's slot in the row partitioned by bucket (doc // span), from
    the exclusive prefix of the bucket-major (bucket, block) counts, the
    bucket's postings in the block's earlier warps of 256 and its rank
    in its own warp. Returns part [B, N] of posting indices (-1 unused)
    and the bucket ranges [B, n_bkt + 1]."""
    B, N = docs.shape
    n_bkt = -(-cap // span)
    n_blk = -(-N // block)
    part = np.full((B, N), -1, np.int64)
    ranges = np.zeros((B, n_bkt + 1), np.int64)
    for b in range(B):
        bkt = np.where((docs[b] >= 0) & (docs[b] < cap), docs[b] // span, -1)
        cnt = np.zeros((n_bkt, n_blk), np.int64)
        for n in range(N):
            if bkt[n] >= 0:
                cnt[bkt[n], n // block] += 1
        off = np.concatenate([[0], np.cumsum(cnt.reshape(-1))])
        ranges[b] = off[::n_blk] if n_blk else 0
        for blk in range(n_blk):
            n0, n1 = blk * block, min(N, (blk + 1) * block)
            for n in range(n0, n1):
                j = bkt[n]
                if j < 0:
                    continue
                w0 = n0 + (n - n0) // warp * warp   # first posting of n's warp
                earlier = int((bkt[n0:w0] == j).sum())
                rank = int((bkt[w0:n] == j).sum())
                part[b, off[j * n_blk + blk] + earlier + rank] = n
    return part, ranges


def _emulate_scatter_kernel(docs, vals, cap, span):
    """Host model of csrc/scatter_add.cu's schedule: the postings
    partitioned by bucket of `span` docs (n order kept), then per bucket
    one owner (a warp) accumulating from zero, the bucket's postings 32
    at a time in n order, a doc's postings among the 32 added by its
    first lane in lane order."""
    B, N = docs.shape
    part, ranges = _partition(docs, cap, span)
    out = np.full((B, cap), np.nan, np.float32)
    for b in range(B):
        for j in range(-(-cap // span)):
            lst = part[b, ranges[b, j]:ranges[b, j + 1]]
            assert (np.diff(lst) > 0).all()       # n order kept
            assert (docs[b, lst] // span == j).all()
            out[b, j * span:(j + 1) * span] = 0.0
            for i0 in range(0, len(lst), 32):
                grp = [(int(docs[b, n]), vals[b, n]) for n in lst[i0:i0 + 32]]
                for t, (d, _v) in enumerate(grp):
                    if d in [g[0] for g in grp[:t]]:
                        continue
                    a = out[b, d]
                    for d2, v2 in grp[t:]:
                        if d2 == d:
                            a = np.float32(a + v2)
                    out[b, d] = a
    return out


class TestScatterAdd:
    @pytest.mark.parametrize("B,n_blocks", [(3, 5), (9, 2)])
    def test_plain_matches_pallas_interpret(self, B, n_blocks):
        rng = np.random.default_rng(B + n_blocks)
        cap = 1024
        docs, vals = _postings(rng, B, n_blocks, cap)
        got = cs.scatter_add(_t(docs), _t(vals), cap).numpy()
        ref = np.asarray(scatter_add_pallas(jnp.asarray(docs),
                                            jnp.asarray(vals), cap,
                                            interpret=True))
        np.testing.assert_array_equal(got, ref)

    def test_duplicates_within_chunk_and_ragged_n(self):
        # N not a multiple of 128, B not a multiple of 8, repeated docs
        # inside one chunk and ids past cap; exactly representable values
        # make the Pallas MXU's in-chunk sums order-free
        rng = np.random.default_rng(11)
        cap, B, N = 512, 5, 300
        docs = rng.integers(0, cap + 40, size=(B, N)).astype(np.int32)
        docs[:, 7:20] = 13
        vals = (rng.integers(1, 64, size=(B, N)) / 8).astype(np.float32)
        got = cs.scatter_add(_t(docs), _t(vals), cap).numpy()
        pallas = np.asarray(scatter_add_pallas(jnp.asarray(docs),
                                               jnp.asarray(vals), cap,
                                               interpret=True))
        np.testing.assert_array_equal(got, pallas)

    def test_plain_matches_jnp_sequential_scatter(self):
        # arbitrary float values, unsorted rows with heavy multiplicity:
        # the reference's `.at[].add` sums each doc in ascending n
        rng = np.random.default_rng(5)
        cap, B, N = 200, 6, 900
        docs = rng.integers(0, cap + 10, size=(B, N)).astype(np.int32)
        vals = rng.standard_normal((B, N)).astype(np.float32)
        got = cs.scatter_add(_t(docs), _t(vals), cap).numpy()
        ref = np.asarray(ref_bsa(jnp.asarray(docs), jnp.asarray(vals), cap))
        np.testing.assert_array_equal(got, ref)

    def test_score_term_and_fused_match_reference(self):
        rng = np.random.default_rng(8)
        cap, nb, B = 512, 12, 3
        bdocs, bimps = _postings(rng, 1, nb, cap, dup_blocks=False)
        bdocs, bimps = bdocs.reshape(nb, 128), bimps.reshape(nb, 128)
        lo = rng.integers(0, nb - 4, size=B).astype(np.int32)
        nbv = rng.integers(1, 5, size=B).astype(np.int32)
        w = rng.random(B, dtype=np.float32)
        got = port_scoring.score_term(_t(bdocs), _t(bimps), _t(lo), _t(nbv),
                                      _t(w), 4, cap).numpy()
        ref = ref_score_term(jnp.asarray(bdocs), jnp.asarray(bimps),
                             jnp.asarray(lo), jnp.asarray(nbv),
                             jnp.asarray(w), 4, cap)
        np.testing.assert_array_equal(got, np.asarray(ref))
        gather = rng.integers(-1, nb, size=(B, 7)).astype(np.int32)
        gw = rng.random((B, 7), dtype=np.float32)
        got = port_scoring.score_terms_fused(_t(bdocs), _t(bimps),
                                             _t(gather), _t(gw), cap).numpy()
        ref = ref_fused(jnp.asarray(bdocs), jnp.asarray(bimps),
                        jnp.asarray(gather), jnp.asarray(gw), cap)
        np.testing.assert_array_equal(got, np.asarray(ref))

    def test_partition_keeps_n_order_per_bucket(self):
        # the slots of passes 1-3: every in-range posting once, grouped by
        # bucket, ascending n within a bucket, across blocks and warps
        rng = np.random.default_rng(5)
        cap, span = 5000, 1024
        docs = rng.integers(-30, cap + 30, size=(2, 2500)).astype(np.int32)
        docs[1, 1000:1300] = 17                      # one doc, many blocks
        part, ranges = _partition(docs, cap, span)
        for b in range(2):
            ok = np.flatnonzero((docs[b] >= 0) & (docs[b] < cap))
            used = part[b][part[b] >= 0]
            assert sorted(used) == list(ok) and ranges[b, -1] == len(ok)
            for j in range(ranges.shape[1] - 1):
                lst = part[b, ranges[b, j]:ranges[b, j + 1]]
                assert (np.diff(lst) > 0).all()
                assert (docs[b, lst] // span == j).all()

    @pytest.mark.parametrize("span", [128, 384, 1024])
    def test_kernel_schedule_matches_reference(self, span):
        # span: docs of a bucket (the kernel's is 2048; smaller here)
        rng = np.random.default_rng(span)
        cap, B = 1024, 3
        docs, vals = _postings(rng, B, 4, cap)
        # one unsorted chunk with repeats takes the kernel's serial path
        docs[1, 128:256] = rng.integers(0, cap + 5, size=128)
        docs[1, 140:150] = docs[1, 130]
        got = _emulate_scatter_kernel(docs, vals, cap, span)
        ref = np.asarray(ref_bsa(jnp.asarray(docs), jnp.asarray(vals), cap))
        np.testing.assert_array_equal(got, ref)

    @pytest.mark.parametrize("B,cap", [(1, 2 ** 20), (256, 2 ** 20),
                                       (3, 300)])
    def test_scatter_span_covers_cap(self, B, cap):
        # a bucket's docs fit its warp's shared-memory accumulator (float4
        # stores); the buckets of a row cover the capacity, at least 4
        # where the capacity is smaller than 4 full buckets
        span = cs.scatter_span(cap)
        assert span % 4 == 0 and 4 <= span <= cs.SCATTER_BUCKET
        per_row = -(-cap // span)
        assert per_row * span >= cap
        assert span == cs.SCATTER_BUCKET or per_row <= 4
