"""Scoring primitives: the unfused posting scatter and the per-tile leaf
functions of the fused block-max bundle engine.

Counterpart of `elasticsearch_tpu/ops/scoring.py`:

* the unfused half (:29-105): gather posting blocks -> weight ->
  scatter-add into dense per-doc scores, batched over queries ([B, ...])
  and vectorized over the 128-lane posting blocks. The gathers stay in
  torch; the scatter is the hand-written kernel
  `ops/cuda_scoring.scatter_add` (its plain version on the CPU).
* the bundle leaf functions (:147-312, :573-697, :832-983), trimmed to
  the dense-text and numeric-range clause kinds: per-tile bounds
  (`bundle_tile_bounds`, computed outside the kernel and shared by the
  plain walk and the kernel, so both prune identically) and the per-tile
  bundle evaluation (`bundle_tile_eval` / `bundle_tile_match`). The walk
  itself (K3) lives in `ops/cuda_scoring`.

A clause bundle is a static tuple of (role, kind, field, wrapped) in
eval_node order (must, filter, must_not, should); its per-clause inputs
are (qt [B, Q] i32, wq [B, Q] f32, msm_c [B] i32, boost_c [B] f32) for a
dense clause and (lo [B], hi [B]) in the column's dtype for a range.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.segment import BLOCK
from . import cuda_scoring


def batched_scatter_add(ids: torch.Tensor, vals: torch.Tensor,
                        cap: int) -> torch.Tensor:
    """scores[b, ids[b, n]] += vals[b, n] in ascending n; ids outside
    [0, cap) are dropped. ids int32 [B, N], vals f32 [B, N] -> [B, cap]."""
    return cuda_scoring.scatter_add(ids, vals, cap)


def gather_term_blocks(block_docs: torch.Tensor, block_imps: torch.Tensor,
                       block_lo: torch.Tensor, nb_valid: torch.Tensor,
                       nb_pad: int, cap: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather a term's posting blocks per batched query -> (docs
    [B, nb_pad*128] padded with `cap`, imps [B, nb_pad*128])."""
    iota = torch.arange(nb_pad, dtype=torch.int32, device=block_lo.device)
    idx = block_lo[:, None] + iota[None, :]                   # [B, nb_pad]
    ok = iota[None, :] < nb_valid[:, None]
    safe = torch.where(ok, idx, 0).to(torch.int64)
    docs = torch.where(ok[..., None], block_docs[safe], cap)  # [B, nb_pad, 128]
    imps = block_imps[safe]
    b = block_lo.shape[0]
    return (docs.reshape(b, nb_pad * BLOCK).contiguous(),
            imps.reshape(b, nb_pad * BLOCK).contiguous())


def score_term(block_docs, block_imps, block_lo, nb_valid, weight,
               nb_pad: int, cap: int) -> torch.Tensor:
    """Score one text-term clause for a batch of queries -> [B, cap]."""
    docs, imps = gather_term_blocks(block_docs, block_imps, block_lo,
                                    nb_valid, nb_pad, cap)
    return batched_scatter_add(docs, imps * weight[:, None], cap)


def gather_fused_blocks(block_docs: torch.Tensor, block_imps: torch.Tensor,
                        gather_idx: torch.Tensor, weights: torch.Tensor,
                        cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather + weight the blocks of a fused disjunction group.
    gather_idx [B, M] absolute block indices (-1 = padding), weights
    [B, M] -> (docs [B, M*128] padded with cap, vals [B, M*128])."""
    ok = gather_idx >= 0
    safe = torch.where(ok, gather_idx, 0).to(torch.int64)
    docs = torch.where(ok[..., None], block_docs[safe], cap)  # [B, M, 128]
    vals = block_imps[safe] * weights[..., None]
    b, m = gather_idx.shape
    return (docs.reshape(b, m * BLOCK).contiguous(),
            vals.reshape(b, m * BLOCK).contiguous())


def score_terms_fused(block_docs, block_imps, gather_idx, weights,
                      cap: int) -> torch.Tensor:
    """Score many term clauses of one disjunction group in one scatter."""
    docs, vals = gather_fused_blocks(block_docs, block_imps, gather_idx,
                                     weights, cap)
    return batched_scatter_add(docs, vals, cap)


# ---------------------------------------------------------------------------
# Fused block-max bundle engine: per-tile leaf functions
# ---------------------------------------------------------------------------

# relative slack on the tile bounds before threshold compares: bound and
# score loops may round differently (an FMA on one side only), so a
# tile's best doc could land a few ULPs above its bound; scores are
# nonnegative, so inflating the bound only makes pruning more cautious
BOUND_SLACK = 1.0 + 32 * float(np.finfo(np.float32).eps)

DENSE_CLAUSE_KINDS = ("terms_dense", "term_text")
RANGE_CLAUSE_KINDS = ("range_int", "range_f32")


def clause_fields(field) -> tuple:
    """A clause's fields as a tuple."""
    return field if isinstance(field, tuple) else (field,)


def bundle_primary_field(clauses: tuple) -> str:
    """Field of the first dense scoring clause: it pins the tile grid
    (every field of a segment shares cap and tile size)."""
    for _role, kind, field, _w in clauses:
        if kind in DENSE_CLAUSE_KINDS:
            return field
    raise ValueError("bundle has no dense scoring clause")


def bundle_text_fields(clauses: tuple) -> tuple:
    """Fields whose forward index (fwd_tids / fwd_imps) the walk reads,
    in first-occurrence order."""
    return tuple(dict.fromkeys(
        f for _r, kd, fld, _w in clauses if kd in DENSE_CLAUSE_KINDS
        for f in clause_fields(fld)))


def bundle_num_fields(clauses: tuple) -> tuple:
    """Numeric fields of the bundle's range clauses, in first-occurrence
    order."""
    return tuple(dict.fromkeys(
        f for _r, kd, f, _w in clauses if kd in RANGE_CLAUSE_KINDS))


def dense_tile_bounds(tile_max: torch.Tensor, qt: torch.Tensor,
                      wq: torch.Tensor) -> torch.Tensor:
    """[T, J] block-max summary x [B, Q] query -> [B, J] score bounds
    (BOUND_SLACK-inflated). Padded terms (qt < 0) contribute 0."""
    b, q_n = qt.shape
    n_tiles = tile_max.shape[1]
    safe = qt.clamp(0, max(tile_max.shape[0] - 1, 0)).to(torch.int64)
    ub = torch.zeros((b, n_tiles), dtype=torch.float32, device=qt.device)
    for q in range(q_n):
        tm = tile_max[safe[:, q]]                       # [B, J]
        w = torch.where(qt[:, q] >= 0, wq[:, q], 0.0)
        ub = ub + tm * w[:, None]
    return ub * np.float32(BOUND_SLACK)


def _dense_tile_scores(t_tids: torch.Tensor, t_imps: torch.Tensor,
                       qt: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """[n, L] forward rows x [B, Q] query -> [B, n] scores, in the
    kernels' op order: per term, hit += select over slots l ascending,
    then score = score + hit * wq (mul and add kept apart)."""
    b = qt.shape[0]
    n, L = t_tids.shape
    score = torch.zeros((b, n), dtype=torch.float32, device=t_imps.device)
    for q in range(qt.shape[1]):
        tq = qt[:, q:q + 1]
        hit = torch.zeros((b, n), dtype=torch.float32, device=t_imps.device)
        for l in range(L):
            hit = hit + torch.where(t_tids[:, l][None, :] == tq,
                                    t_imps[:, l][None, :], 0.0)
        score = score + hit * wq[:, q:q + 1]
    return score


def bundle_tile_bounds(clauses: tuple, cl_inputs: tuple, text_cols: dict,
                       num_cols: dict, msm: torch.Tensor,
                       boost: torch.Tensor | None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tile (can_match [B, J] bool, score bound [B, J] f32).

    can_match is msm-aware: every must/filter clause can match in the
    tile (dense: positive bound; range: the tile's [lo, hi] extrema
    overlap the query's range) AND at least msm should clauses can. The
    bound sums the boost-weighted per-clause block-max bounds of the
    scoring clauses, times the outer boost, BOUND_SLACK-inflated once
    more for the multi-clause combine."""
    b = msm.shape[0]
    dev = msm.device
    n_tiles = text_cols[bundle_primary_field(clauses)]["tile_max"].shape[1]
    bound = torch.zeros((b, n_tiles), dtype=torch.float32, device=dev)
    possible = torch.ones((b, n_tiles), dtype=torch.bool, device=dev)
    pos_cnt = torch.zeros((b, n_tiles), dtype=torch.int32, device=dev)
    for (role, kind, field, _w), inp in zip(clauses, cl_inputs):
        if kind in DENSE_CLAUSE_KINDS:
            qt, wq, msm_c, boost_c = inp
            ub = dense_tile_bounds(text_cols[field]["tile_max"], qt, wq)
            p = (((ub > 0.0) | (msm_c <= 0)[:, None])
                 & (msm_c <= 1)[:, None])
            if role in ("must", "should"):
                bound = bound + ub * boost_c[:, None]
            if role in ("must", "filter"):
                possible = possible & p
            elif role == "should":
                pos_cnt = pos_cnt + p.to(torch.int32)
        elif role != "must_not":            # range mask: no bound to
            lo, hi = inp                    # prune on for exclusions
            tl = num_cols[field]["tile_lo"]
            th = num_cols[field]["tile_hi"]
            possible = possible & ((tl[None, :] <= hi[:, None])
                                   & (th[None, :] >= lo[:, None]))
    can_match = possible & (pos_cnt >= msm[:, None])
    if boost is not None:
        bound = bound * boost[:, None]
    slack = np.float32(BOUND_SLACK)
    return can_match, torch.where(bound >= 0.0, bound * slack,
                                  bound / slack)


def bundle_tile_eval(clauses: tuple, cl_inputs: tuple, text_tiles: dict,
                     num_tiles: dict, msm: torch.Tensor,
                     boost: torch.Tensor | None, t_live: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Evaluate a clause bundle over a set of docs -> (score [B, n]
    post-boost, match [B, n] incl. live). `text_tiles[f]` = (tids
    [n, L], imps [n, L]), `num_tiles[f]` = (values [n], exists [n]).
    Every op is per doc, so any doc set (one tile, or several tiles side
    by side) gives the same numbers. The op order is eval_node's bool
    branch: clause scores where-masked and added in clause order, a
    wrapped clause's boost before the add, the outer boost last."""
    b = msm.shape[0]
    n = t_live.shape[0]
    dev = t_live.device
    score = torch.zeros((b, n), dtype=torch.float32, device=dev)
    must_ok = torch.ones((b, n), dtype=torch.bool, device=dev)
    not_any = torch.zeros((b, n), dtype=torch.bool, device=dev)
    cnt = torch.zeros((b, n), dtype=torch.int32, device=dev)
    for (role, kind, field, _w), inp in zip(clauses, cl_inputs):
        if kind in DENSE_CLAUSE_KINDS:
            qt, wq, msm_c, boost_c = inp
            t_tids, t_imps = text_tiles[field]
            s_leaf = _dense_tile_scores(t_tids, t_imps, qt, wq)
            m_leaf = s_leaf > 0.0
            # single-should wrapper semantics (unwrapped clauses carry
            # msm_c = 1 / boost_c = 1, exact no-ops)
            m = (m_leaf | (msm_c <= 0)[:, None]) & (msm_c <= 1)[:, None]
            s = torch.where(m_leaf, s_leaf, 0.0) * boost_c[:, None]
        else:
            lo, hi = inp
            t_vals, t_exists = num_tiles[field]
            m = ((t_vals[None, :] >= lo[:, None])
                 & (t_vals[None, :] <= hi[:, None]) & t_exists[None, :])
            s = None                         # mask-only roles
        if role == "must":
            score = score + torch.where(m, s, 0.0)
            must_ok = must_ok & m
        elif role == "filter":
            must_ok = must_ok & m
        elif role == "must_not":
            not_any = not_any | m
        else:
            score = score + torch.where(m, s, 0.0)
            cnt = cnt + m.to(torch.int32)
    match = must_ok & (~not_any) & (cnt >= msm[:, None]) & t_live[None, :]
    if boost is not None:
        score = score * boost[:, None]
    return score, match


def bundle_tile_match(clauses: tuple, cl_inputs: tuple, text_tiles: dict,
                      num_tiles: dict, msm: torch.Tensor,
                      t_live: torch.Tensor) -> torch.Tensor:
    """Mask-only bundle_tile_eval -> match [B, n]. A dense clause's match
    is `score > 0`; impacts of real postings are positive and clause
    weights are clamped positive at bind time, so that equals "some
    query term (qt >= 0) sits in a slot with positive impact", which is
    what this membership test computes without the multiply-adds."""
    b = msm.shape[0]
    n = t_live.shape[0]
    dev = t_live.device
    must_ok = torch.ones((b, n), dtype=torch.bool, device=dev)
    not_any = torch.zeros((b, n), dtype=torch.bool, device=dev)
    cnt = torch.zeros((b, n), dtype=torch.int32, device=dev)
    for (role, kind, field, _w), inp in zip(clauses, cl_inputs):
        if kind in DENSE_CLAUSE_KINDS:
            qt, _wq, msm_c, _boost_c = inp
            t_tids, t_imps = text_tiles[field]
            present = t_imps > 0.0                   # [n, L]
            m_leaf = torch.zeros((b, n), dtype=torch.bool, device=dev)
            for q in range(qt.shape[1]):
                tq = qt[:, q][:, None, None]         # [B, 1, 1]
                hit = ((t_tids[None] == tq) & present[None]).any(dim=-1)
                m_leaf = m_leaf | (hit & (qt[:, q] >= 0)[:, None])
            m = (m_leaf | (msm_c <= 0)[:, None]) & (msm_c <= 1)[:, None]
        else:
            lo, hi = inp
            t_vals, t_exists = num_tiles[field]
            m = ((t_vals[None, :] >= lo[:, None])
                 & (t_vals[None, :] <= hi[:, None]) & t_exists[None, :])
        if role in ("must", "filter"):
            must_ok = must_ok & m
        elif role == "must_not":
            not_any = not_any | m
        else:
            cnt = cnt + m.to(torch.int32)
    return must_ok & (~not_any) & (cnt >= msm[:, None]) & t_live[None, :]
