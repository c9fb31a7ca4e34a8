"""K3's stepped and seeded launch forms in the PyTorch port vs the JAX
reference, on the CPU.

(a) The stepped walk (`cuda_scoring.bundle_walk_steps` over the plain
    walk) against `_bundle_pallas_walk(step=...)` in interpret mode, at
    the reference's schedule (its batch tile, one sub-chunk per step
    chunk): dense, range-masked, emit-match, k == 0 and positional
    bundles; candidates, counts, prune flags, the final threshold, totals
    and masks equal.
(b) Stepped equals the single launch on the port's own default schedule
    (top-k, totals, masks, bit for bit).
(c) A check that flips at chunk 3 of 8: timed in both packages, the
    skipped chunks reporting alike.
(d) Chained walks (a delta walk seeded from a base walk's top-k,
    `init_topk` / `idx_offset`) against the Pallas kernel and the
    reference's XLA engine, and against the union of per-segment top-k's.
(e) `running_topk_merge` against the reference's, ties included.

Tolerance: exact everywhere, scores bit for bit. Dense clauses of (a)-(c)
carry dyadic impacts (the interpret-mode kernel contracts the dense
leaf's mul-add into an FMA, ROADMAP Queue 3); the chained walks of (d)
carry BM25 impacts with unit query weights, where that FMA is exact.
"""

import collections
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.segment import build_tile_max as ref_tile_max
from elasticsearch_tpu.ops import pallas_scoring as ps
from elasticsearch_tpu.ops import topk as ref_topk
from elasticsearch_tpu.ops.scoring import score_topk_bundle_fused

from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import (SegmentBuilder,
                                                   build_tile_max)
from elasticsearch_tpu_torch.ops import cuda_scoring as cs
from elasticsearch_tpu_torch.ops import scoring as sc
from elasticsearch_tpu_torch.ops import topk as topk

import tests.test_torch_fused as tf
import tests.test_torch_positional as tp

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pos_seg():
    svc = MapperService(mapping=tp.MAPPING)
    b = SegmentBuilder()
    for did, d in tp._docs(tp.N_DOCS, 5):
        b.add(svc.parse(did, d))
    return b.build("p")


def _never(c, st):
    return False, st


@contextlib.contextmanager
def _eager_steps(monkeypatch):
    """Run the reference's stepped walk eagerly and record each chunk
    call's outputs: `lax.cond` on a concrete verdict takes its branch
    directly (the kernel's own traced conds keep the real one), so the
    chunks' threshold outputs are concrete."""
    calls = []
    cond = jax.lax.cond

    def eager_cond(pred, if_true, if_false, *ops):
        if isinstance(pred, jax.core.Tracer):
            return cond(pred, if_true, if_false, *ops)
        return if_true(*ops) if bool(pred) else if_false(*ops)

    chunk_call = ps._bundle_chunk_call

    def recorded(*a, **kw):
        out = chunk_call(*a, **kw)
        calls.append(out)
        return out

    monkeypatch.setattr(jax.lax, "cond", eager_cond)
    monkeypatch.setattr(ps, "_bundle_chunk_call", recorded)
    yield calls


def _dense_case(bundle, B, tile, seed):
    c = tf._case(seed, bundle, B, tile)
    return tf._args(c, True), tf._args(c, False), tf.CAP // tile


def _pos_case(seg, bundle, B, seed):
    case = tp._bundle_case(seg, bundle, B, seed)
    return (tp._args(seg, case, bundle, True),
            tp._args(seg, case, bundle, False), seg.capacity // tp.TILE)


# ---------------------------------------------------------------------------
# (a) the stepped walk at the reference's schedule
# ---------------------------------------------------------------------------


_STEPPED = [("single", 256, 10, False, 4), ("main", 256, 10, True, 4),
            ("bundle", 256, 1, True, 5), ("bundle", 256, 0, True, 4),
            ("main", 1024, 0, False, 1), ("phrase", None, 10, True, 4)]


@pytest.mark.parametrize("bundle,tile,k,emit,chunk", _STEPPED)
def test_stepped_walk_equals_pallas(monkeypatch, pos_seg, bundle, tile, k,
                                    emit, chunk):
    B = 12
    if tile is None:
        p_args, r_args, n_tiles = _pos_case(pos_seg, bundle, B, 31)
        tile = tp.TILE
    else:
        p_args, r_args, n_tiles = _dense_case(bundle, B, tile, 30 + k)
    cap = p_args[6].shape[0]
    k_sel = min(k, cap)
    ck = min(k_sel, tile)
    step = (chunk, False, _never)
    with _eager_steps(monkeypatch) as calls:
        got = ps._bundle_pallas_walk(*r_args, ck=ck,
                                     update_thr=(ck == k_sel),
                                     emit_match=emit, step=step,
                                     interpret=True)
    r_cs, r_ci, r_cnt, r_flags, r_match, timed, b, btile, _bp = got
    assert len(calls) == -(-n_tiles // chunk) and not bool(timed)
    text, num, clauses, cl, msm, boost, live = p_args
    can, ub = sc.bundle_tile_bounds(clauses, cl, text, num, msm, boost)
    p_cs, p_ci, p_cnt, p_flags, p_match, p_thr, p_timed = \
        cs.bundle_walk_steps(cs.bundle_walk_ref, *p_args, can, ub, ck=ck,
                             update_thr=(ck == k_sel), emit_match=emit,
                             step=step, bt=btile, chunk_tiles=chunk)
    assert p_timed is False
    if ck:
        tf._same(p_cs, np.asarray(r_cs)[:b], "cs")
        tf._same(p_ci, np.asarray(r_ci)[:b], "ci")
        # the last chunk's threshold output: [B, 1] after cs, ci, cnt, flags
        tf._same(p_thr, np.asarray(calls[-1][4])[:b, 0], "thr")
    else:
        assert p_cs is None and p_thr is None
    tf._same(p_cnt, np.asarray(r_cnt)[:b], "cnt")
    tf._same(p_flags, np.asarray(r_flags)[:b], "flags")
    if emit:
        tf._same(p_match, np.asarray(r_match)[:b] != 0, "match")
    assert int(p_cnt.sum()) > 0
    # the public entries, stepped, against the Pallas ones: totals, masks
    # and (k > 0) the top-k
    if k:
        want = ps.fused_topk_bundle_pallas(*r_args, k, emit_match=emit,
                                           step=step, interpret=True)
        got = cs.fused_topk_bundle_ref(*p_args, k, emit_match=emit,
                                       step=step)
        total = np.asarray(want[2])
        for row in range(B):
            n = min(int(total[row]), k)
            tf._same(got[0][row, :n], np.asarray(want[0])[row, :n], "top_s")
            tf._same(got[1][row, :n], np.asarray(want[1])[row, :n], "top_i")
    else:
        want = ps.match_mask_bundle_pallas(*r_args, emit_match=emit,
                                           step=step, interpret=True)
        got = cs.match_mask_bundle_ref(*p_args, emit_match=emit, step=step)
    ti = 2 if k else 0
    tf._same(got[ti], np.asarray(want[ti]), "total")
    if emit:
        tf._same(got[-2], np.asarray(want[-2]), "match")
    assert got[-1] is False and not bool(want[-1])


# ---------------------------------------------------------------------------
# (b) stepped == single launch on the port's default schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bundle,k,emit", [("main", 10, True),
                                           ("bundle", 300, False),
                                           ("bundle", 0, True)])
def test_stepped_equals_single_launch(bundle, k, emit):
    c = tf._case(50 + k, bundle, 16, 256)
    args = tf._args(c, True)
    for chunk in (1, 3, 16):
        step = (chunk, None, _never)
        if k:
            one = cs.fused_topk_bundle(*args, k, emit_match=emit)
            got = cs.fused_topk_bundle(*args, k, emit_match=emit, step=step)
            head = (0, 1, 2)
        else:
            one = cs.match_mask_bundle(*args, emit_match=emit)
            got = cs.match_mask_bundle(*args, emit_match=emit, step=step)
            head = (0,)
        assert got[-1] is False
        for i in head:
            assert torch.equal(got[i], one[i]), (chunk, i)
        if emit:
            assert torch.equal(got[-2], one[-1]), chunk
        # examined tiles are every tile, whatever the schedule
        assert float(got[len(head) if k == 0 else 3][2]) == tf.CAP // 256


# ---------------------------------------------------------------------------
# (c) a check that flips at chunk 3 of 8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,emit", [(10, True), (0, False)])
def test_check_flip_skips_the_rest_alike(monkeypatch, k, emit):
    B, tile, chunk = 10, 256, 2                  # 16 tiles: 8 chunks of 2
    p_args, r_args, n_tiles = _dense_case("main", B, tile, 60 + k)
    assert -(-n_tiles // chunk) == 8
    seen = collections.defaultdict(list)

    def check_for(side):
        def check(c, st):
            seen[side].append(int(c))
            return c >= 3, st
        return check

    ck = min(k, tile)
    with _eager_steps(monkeypatch) as calls:
        r = ps._bundle_pallas_walk(*r_args, ck=ck, update_thr=True,
                                   emit_match=emit,
                                   step=(chunk, None, check_for("ref")),
                                   interpret=True)
    assert len(calls) == 3 and bool(r[5])
    text, num, clauses, cl, msm, boost, live = p_args
    can, ub = sc.bundle_tile_bounds(clauses, cl, text, num, msm, boost)
    launches = []

    def walk(*a, **kw):
        launches.append((kw["t0"], kw["nt"]))
        return cs.bundle_walk_ref(*a, **kw)

    p = cs.bundle_walk_steps(walk, *p_args, can, ub, ck=ck, update_thr=True,
                             emit_match=emit,
                             step=(chunk, None, check_for("port")),
                             bt=r[7], chunk_tiles=chunk)
    assert p[6] is True
    assert launches == [(0, 2), (2, 2), (4, 2)]
    # both ask before every chunk and once after the last
    assert seen["port"] == seen["ref"] == list(range(9))
    b = r[6]
    if ck:
        tf._same(p[0], np.asarray(r[0])[:b], "cs")
        tf._same(p[1], np.asarray(r[1])[:b], "ci")
    tf._same(p[2], np.asarray(r[2])[:b], "cnt")
    tf._same(p[3], np.asarray(r[3])[:b], "flags")
    assert (p[3][:, 6:] == 1).all() and (p[2][:, 6:] == 0).all()
    if emit:
        tf._same(p[4], np.asarray(r[4])[:b] != 0, "match")
        assert not p[4][:, 6 * tile:].any()
    if k:
        got = cs.fused_topk_bundle_ref(*p_args, k, emit_match=emit,
                                       step=(chunk, None, check_for("x")))
        want = ps.fused_topk_bundle_pallas(
            *r_args, k, emit_match=emit, step=(chunk, None, check_for("y")),
            interpret=True)
        assert got[-1] is True and bool(want[-1])
        tf._same(got[2], np.asarray(want[2]), "total")


# ---------------------------------------------------------------------------
# (d) chained walks: base -> delta
# ---------------------------------------------------------------------------


def _bm25_cols(rng, cap, T, L):
    """Random forward rows with BM25 impacts (tf 1-4, random lengths):
    values no dyadic grid holds, as the builder's impacts."""
    tids = np.stack([rng.permutation(T)[:L] for _ in range(cap)]).astype(
        np.int32)
    tids[rng.random((cap, L)) < 0.3] = -1
    tf_ = rng.integers(1, 5, size=(cap, L)).astype(np.float64)
    dl = rng.integers(3, 40, size=(cap, 1)).astype(np.float64)
    norm = 1.2 * (0.25 + 0.75 * dl / dl.mean())
    imps = np.where(tids >= 0, (tf_ * 2.2 / (tf_ + norm)) * np.log(
        1 + T / (tids + 1.5)), 0.0).astype(np.float32)
    return tids, imps


@pytest.mark.parametrize("k", [10, 300])
def test_chained_walk_equals_references_and_union(k):
    rng = np.random.default_rng(7)
    B, T, L = 5, 16, 8
    cap_b, cap_d = 4096, 256
    cols = {"base": (_bm25_cols(rng, cap_b, T, L), 1024),
            "delta": (_bm25_cols(rng, cap_d, T, L), 256)}
    live_np = {"base": rng.random(cap_b) > 0.02,
               "delta": rng.random(cap_d) > 0.1}
    qt = rng.integers(0, T, size=(B, 4)).astype(np.int32)
    clauses = (("should", "terms_dense", "f", False),)

    def side(port):
        conv = torch.from_numpy if port else jnp.asarray
        tm = build_tile_max if port else ref_tile_max
        text = {s: {"f": {"fwd_tids": conv(t), "fwd_imps": conv(i),
                          "tile_max": conv(tm(t, i, T, t.shape[0],
                                              tile=tile))}}
                for s, ((t, i), tile) in cols.items()}
        cl = ((conv(qt), conv(np.ones((B, 4), np.float32)),
               conv(np.ones(B, np.int32)), conv(np.ones(B, np.float32))),)
        live = {s: conv(v) for s, v in live_np.items()}
        return text, cl, conv(np.ones(B, np.int32)), live

    p_text, p_cl, p_msm, p_live = side(True)
    r_text, r_cl, r_msm, r_live = side(False)
    # port: base walk opening at the pack width, delta chained onto it
    p0 = topk.running_topk_init(B, k)
    pb = cs.fused_topk_bundle(p_text["base"], {}, clauses, p_cl, p_msm,
                              None, p_live["base"], k, init_topk=p0)
    pd = cs.fused_topk_bundle(p_text["delta"], {}, clauses, p_cl, p_msm,
                              None, p_live["delta"], k,
                              init_topk=(pb[0], pb[1]), idx_offset=cap_b)
    # reference, both engines
    r0 = ref_topk.running_topk_init(B, k)
    for engine in ("xla", "pallas"):
        if engine == "xla":
            rb = score_topk_bundle_fused(r_text["base"], {}, clauses, r_cl,
                                         r_msm, None, r_live["base"], k,
                                         init_topk=r0)
            rd = score_topk_bundle_fused(r_text["delta"], {}, clauses, r_cl,
                                         r_msm, None, r_live["delta"], k,
                                         init_topk=(rb[0], rb[1]),
                                         idx_offset=cap_b)
        else:
            rb = ps.fused_topk_bundle_pallas(
                r_text["base"], {}, clauses, r_cl, r_msm, None,
                r_live["base"], k, interpret=True, init_topk=r0)
            rd = ps.fused_topk_bundle_pallas(
                r_text["delta"], {}, clauses, r_cl, r_msm, None,
                r_live["delta"], k, interpret=True,
                init_topk=(rb[0], rb[1]), idx_offset=cap_b)
        for got, want in ((pb, rb), (pd, rd)):
            tf._same(got[2], np.asarray(want[2]), f"{engine} total")
            s_w = np.asarray(want[0])
            for row in range(B):
                fin = np.isfinite(s_w[row])
                tf._same(got[0][row][torch.from_numpy(fin)], s_w[row][fin],
                         f"{engine} top_s")
                tf._same(got[1][row][torch.from_numpy(fin)],
                         np.asarray(want[1])[row][fin], f"{engine} top_i")
    # the chain equals the union of the per-segment top-k's
    ab = cs.fused_topk_bundle(p_text["base"], {}, clauses, p_cl, p_msm,
                              None, p_live["base"], k)
    ad = cs.fused_topk_bundle(p_text["delta"], {}, clauses, p_cl, p_msm,
                              None, p_live["delta"], k)
    for row in range(B):
        union = sorted(
            [(-float(s), int(i)) for s, i in zip(ab[0][row], ab[1][row])
             if np.isfinite(float(s))]
            + [(-float(s), int(i) + cap_b)
               for s, i in zip(ad[0][row], ad[1][row])
               if np.isfinite(float(s))])[:k]
        got = [(-float(s), int(i)) for s, i in zip(pd[0][row], pd[1][row])
               if np.isfinite(float(s))]
        assert got == union
    assert int(pd[2].sum()) > 0


def test_seeded_threshold_prunes_delta_tiles():
    """A delta walk seeded with a base k-th best above every delta tile's
    bound thresholds all of them and adds no hit; unseeded, it selects."""
    c = tf._case(80, "single", 8, 256)
    text, num, clauses, cl, msm, boost, live = tf._args(c, True)
    high = (torch.full((8, 10), 1e6), torch.arange(80, dtype=torch.int32)
            .reshape(8, 10))
    got = cs.fused_topk_bundle(text, num, clauses, cl, msm, boost, live, 10,
                               init_topk=high, idx_offset=tf.CAP)
    assert torch.equal(got[0], high[0]) and torch.equal(got[1], high[1])
    hard, thresholded, examined = got[3].tolist()
    assert thresholded > 0 and hard + thresholded == examined
    plain = cs.fused_topk_bundle(text, num, clauses, cl, msm, boost, live,
                                 10)
    assert float(plain[3][1]) < thresholded


# ---------------------------------------------------------------------------
# (e) running_topk_merge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_running_topk_merge_matches_reference(seed):
    rng = np.random.default_rng(seed)
    B, k, ck = 6, 7, 9
    # few distinct values: ties across and within the two sides
    top_s = -np.sort(-(rng.integers(0, 4, size=(B, k)) / 2), axis=1)
    top_s = top_s.astype(np.float32)
    top_s[:, -2:] = -np.inf
    top_i = rng.integers(0, 100, size=(B, k)).astype(np.int32)
    cand_s = (rng.integers(0, 4, size=(B, ck)) / 2).astype(np.float32)
    cand_s[rng.random((B, ck)) < 0.2] = -np.inf
    cand_i = rng.integers(100, 200, size=(B, ck)).astype(np.int32)
    got = topk.running_topk_merge(*(torch.from_numpy(a) for a in
                                    (top_s, top_i, cand_s, cand_i)))
    want = ref_topk.running_topk_merge(*(jnp.asarray(a) for a in
                                         (top_s, top_i, cand_s, cand_i)))
    tf._same(got[0], np.asarray(want[0]), "scores")
    tf._same(got[1], np.asarray(want[1]), "ids")
    init = topk.running_topk_init(B, k)
    r_init = ref_topk.running_topk_init(B, k)
    tf._same(init[0], np.asarray(r_init[0]), "init scores")
    tf._same(init[1], np.asarray(r_init[1]), "init ids")
