"""Scoring primitives: the unfused posting scatter and the per-tile leaf
functions of the fused block-max bundle engine.

Counterpart of `elasticsearch_tpu/ops/scoring.py`:

* the unfused half (:29-105): gather posting blocks -> weight ->
  scatter-add into dense per-doc scores, batched over queries ([B, ...])
  and vectorized over the 128-lane posting blocks. The gathers stay in
  torch; the scatter is the hand-written kernel
  `ops/cuda_scoring.scatter_add` (its plain version on the CPU).
* the bundle leaf functions (:147-983) for the dense-text, numeric-range
  and positional (phrase / span / BM25F) clause kinds: per-tile bounds
  (`bundle_tile_bounds`, computed outside the kernel and shared by the
  plain walk and the kernel, so both prune identically) and the per-tile
  bundle evaluation (`bundle_tile_eval` / `bundle_tile_match`). The walk
  itself (K3) lives in `ops/cuda_scoring`.
* the positional leaf (:337-570): position decode, exact / sloppy
  phrase, ordered / unordered span_near frequencies, BM25F and the
  shared `positional_tile_scores`, as plain torch. They are the plain
  version of K3's positional leaf and of the unfused leaf kernel
  (`ops/cuda_scoring.positional_leaf`), bit for bit.

A clause bundle is a static tuple of (role, kind, field, wrapped) in
eval_node order (must, filter, must_not, should); its per-clause inputs
are (qt [B, Q] i32, wq [B, Q] f32, msm_c [B] i32, boost_c [B] f32) for a
dense clause, (lo [B], hi [B]) in the column's dtype for a range, and
for the positional kinds

  phrase_pos:{n}:{e|s} / span_pos:{n}:{o|u}: (qt [B, n] i32, wb [B, n]
      f32 bound weights idf_sum / idf_i, idf_sum [B] f32, slop [B] i32,
      pboost [B] f32, msm_c [B] i32, boost_c [B] f32);
  bm25f:{nf}:{nt}: (qt [B, nf, nt] i32, idf [B, nt] f32, wf [B, nf] f32,
      pboost [B] f32, msm_c [B] i32, boost_c [B] f32), the clause's
      field slot holding the tuple of its fields.

The kind string carries the clause's statics (term count, exact or
sloppy, ordered or not, field and term counts), so clauses of other
shapes never share a plan.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.segment import BLOCK, BM25_K1
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
POSITIONAL_PREFIXES = ("phrase_pos", "span_pos", "bm25f")

# decoded-position pad: far above any real position (POS_MAX_ENC 32767
# per delta, at most POS_CAP deltas) and small enough that pad +/- a
# small int stays inside int32
_POS_BIG = 1 << 30


def positional_prefix(kind: str) -> str | None:
    """The positional family of a clause kind, or None for the rest."""
    head = kind.split(":", 1)[0]
    return head if head in POSITIONAL_PREFIXES else None


def phrase_kind(n: int, sloppy: bool) -> str:
    return f"phrase_pos:{n}:{'s' if sloppy else 'e'}"


def span_kind(n: int, in_order: bool) -> str:
    return f"span_pos:{n}:{'o' if in_order else 'u'}"


def bm25f_kind(nf: int, nt: int) -> str:
    return f"bm25f:{nf}:{nt}"


def parse_positional_kind(kind: str) -> tuple[str, int, str]:
    """"head:a:b" -> (head, int(a), b)."""
    head, a, bv = kind.split(":")
    return head, int(a), bv


def clause_fields(field) -> tuple:
    """A clause's fields as a tuple (a bm25f clause holds a tuple)."""
    return field if isinstance(field, tuple) else (field,)


def bundle_primary_field(clauses: tuple) -> str:
    """Field of the first dense or positional scoring clause: it pins
    the tile grid (every field of a segment shares cap and tile size)."""
    for _role, kind, field, _w in clauses:
        if kind in DENSE_CLAUSE_KINDS:
            return field
        if positional_prefix(kind):
            return clause_fields(field)[0]
    raise ValueError("bundle has no dense scoring clause")


def bundle_text_fields(clauses: tuple) -> tuple:
    """Fields whose forward index (fwd_tids / fwd_imps) the walk reads,
    in first-occurrence order: dense clause fields and every field of a
    positional clause (its slot compare reads fwd_tids)."""
    return tuple(dict.fromkeys(
        f for _r, kd, fld, _w in clauses
        if kd in DENSE_CLAUSE_KINDS or positional_prefix(kd)
        for f in clause_fields(fld)))


def bundle_pos_fields(clauses: tuple) -> tuple:
    """Fields whose positions columns (fwd_pos / k1ln / lnorm) the walk
    reads, in first-occurrence order."""
    return tuple(dict.fromkeys(
        f for _r, kd, fld, _w in clauses if positional_prefix(kd)
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


# ---------------------------------------------------------------------------
# Positional leaf: per-doc programs over a doc set, exact integer
# frequencies and one f32 impact chain shared with search/phrase.py.
# Every op is per doc, so a tile, several tiles side by side or the whole
# capacity give the same numbers.
# ---------------------------------------------------------------------------


def _term_positions(t_tids: torch.Tensor, t_pos: torch.Tensor,
                    tq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One query term's positions in every doc of the set. t_tids [n, L],
    t_pos [n, L*P] int16 (slot l owns columns [l*P, (l+1)*P)), tq [B].
    Returns (pos [B, n, P] int32 ascending, pads _POS_BIG; tf [B, n]
    int32 valid count). A doc's slots hold distinct term ids, so a
    masked max over the slot axis selects the term's slot; tq < 0 (and
    the -1 slot pads) match nothing."""
    n_docs, n_slots = t_tids.shape
    p_width = t_pos.shape[1] // n_slots
    pos3 = t_pos.reshape(n_docs, n_slots, p_width)
    hit = (t_tids[None] == tq[:, None, None]) \
        & (tq >= 0)[:, None, None]                       # [B, n, L]
    enc = torch.where(hit[..., None], pos3[None],
                      torch.tensor(-1, dtype=torch.int16,
                                   device=t_pos.device)).amax(dim=2)
    valid = enc >= 0                                     # [B, n, P]
    pos = torch.cumsum(torch.where(valid, enc.to(torch.int32), 0), dim=-1,
                       dtype=torch.int32)
    pos = torch.where(valid, pos, _POS_BIG)
    return pos, valid.sum(dim=-1, dtype=torch.int32)


def _phrase_freq_exact(pos: torch.Tensor, tf: torch.Tensor) -> torch.Tensor:
    """Exact-adjacency phrase frequency: a start p of term 0 counts iff
    term i occurs at p + i. pos [B, n, m, P], tf [B, n, m] -> [B, n]."""
    m = pos.shape[2]
    if m == 1:
        return tf[..., 0]
    starts = pos[:, :, 0, :]                             # [B, n, P]
    alive = starts < _POS_BIG
    for i in range(1, m):
        member = (pos[:, :, i, None, :]
                  == (starts + i)[..., :, None]).any(dim=-1)
        alive = alive & member
    return alive.sum(dim=-1, dtype=torch.int32)


def _sweep_values(pos: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """pos[..., ptr] with the pointers clamped to the list (a pointer
    past its tf only occurs on an inactive doc)."""
    p_width = pos.shape[-1]
    safe = ptr.clamp(0, p_width - 1).to(torch.int64)
    return torch.gather(pos, -1, safe[..., None])[..., 0]


def _advance_first_min(ptr: torch.Tensor, vals: torch.Tensor,
                       lo: torch.Tensor, active: torch.Tensor
                       ) -> torch.Tensor:
    """Advance, on active docs, the first pointer whose value is the
    minimum lo (the host's `vals.index(lo)`)."""
    m = vals.shape[-1]
    ar = torch.arange(m, dtype=torch.int32, device=vals.device)
    first = torch.where(vals == lo[..., None], ar, m).amin(dim=-1)
    adv = ar == first[..., None]
    return ptr + (active[..., None] & adv).to(torch.int32)


def _phrase_freq_sloppy(pos: torch.Tensor, tf: torch.Tensor,
                        slop: torch.Tensor) -> torch.Tensor:
    """Sloppy phrase frequency, search/phrase._sloppy_match's pointer
    sweep for every doc in lockstep: m*P fixed iterations, each testing
    the window of the m adjusted head positions (repeats must sit on
    distinct raw tokens) and advancing the first pointer holding the
    minimum. A doc goes inactive once some pointer reaches its tf."""
    b, n, m, p_width = pos.shape
    dev = pos.device
    ar = torch.arange(m, dtype=torch.int32, device=dev)
    adj = pos - ar[None, None, :, None]
    ptr = torch.zeros((b, n, m), dtype=torch.int32, device=dev)
    freq = torch.zeros((b, n), dtype=torch.int32, device=dev)
    for _it in range(m * p_width):
        vals = _sweep_values(adj, ptr)                   # [B, n, m]
        active = (ptr < tf).all(dim=-1)
        lo = vals.amin(dim=-1)
        hi = vals.amax(dim=-1)
        raw = vals + ar[None, None, :]
        distinct = torch.ones((b, n), dtype=torch.bool, device=dev)
        for i in range(m):
            for j in range(i + 1, m):
                distinct = distinct & (raw[..., i] != raw[..., j])
        hit = active & ((hi - lo) <= slop[:, None]) & distinct
        freq = freq + hit.to(torch.int32)
        ptr = _advance_first_min(ptr, vals, lo, active)
    return freq


def _span_freq_ordered(pos: torch.Tensor, tf: torch.Tensor,
                       slop: torch.Tensor) -> torch.Tensor:
    """Ordered span_near frequency over m width-1 children: the distinct
    (p0, pl) envelopes with p0 in A_0, pl in A_{m-1} and the greedy
    minimal chain x through A_1..A_{m-2} below pl, with the window test
    (pl + 1 - p0) - m <= slop (search/phrase._near_ordered + its set
    dedupe)."""
    m = pos.shape[2]
    if m == 1:
        return tf[..., 0]
    p0 = pos[:, :, 0, :]                                 # [B, n, P]
    x = p0
    for i in range(1, m - 1):
        ai = pos[:, :, i, :]
        cand = torch.where(ai[:, :, None, :] >= x[..., :, None] + 1,
                           ai[:, :, None, :], _POS_BIG)  # [B, n, P0, P]
        x = cand.amin(dim=-1)
    pl = pos[:, :, m - 1, :]
    ok = (pl[:, :, None, :] > x[..., :, None]) \
        & (((pl[:, :, None, :] + 1 - p0[..., :, None]) - m)
           <= slop[:, None, None, None])
    return ok.sum(dim=(-1, -2), dtype=torch.int32)


def _span_freq_unordered(pos: torch.Tensor, tf: torch.Tensor,
                         slop: torch.Tensor) -> torch.Tensor:
    """Unordered span_near frequency over m width-1 children
    (search/phrase._near_unordered + its set dedupe): the window (min
    start, max start + 1) is tested against (hi - lo) - m <= slop, then
    the first pointer holding the earliest start advances. Repeats of an
    emitted window are adjacent among emissions, so comparing with the
    last emitted pair counts the distinct windows."""
    b, n, m, p_width = pos.shape
    if m == 1:
        return tf[..., 0]
    dev = pos.device
    ptr = torch.zeros((b, n, m), dtype=torch.int32, device=dev)
    freq = torch.zeros((b, n), dtype=torch.int32, device=dev)
    last_lo = torch.full((b, n), -1, dtype=torch.int32, device=dev)
    last_hi = torch.full((b, n), -1, dtype=torch.int32, device=dev)
    for _it in range(m * p_width):
        starts = _sweep_values(pos, ptr)
        active = (ptr < tf).all(dim=-1)
        lo = starts.amin(dim=-1)
        hi = starts.amax(dim=-1) + 1
        win = active & (((hi - lo) - m) <= slop[:, None])
        new = win & ((lo != last_lo) | (hi != last_hi))
        freq = freq + new.to(torch.int32)
        last_lo = torch.where(win, lo, last_lo)
        last_hi = torch.where(win, hi, last_hi)
        ptr = _advance_first_min(ptr, starts, lo, active)
    return freq


def positional_tile_freqs(kind: str, qt: torch.Tensor, slop: torch.Tensor,
                          t_tids: torch.Tensor, t_pos: torch.Tensor
                          ) -> torch.Tensor:
    """Phrase / span occurrence counts over a doc set -> [B, n] i32."""
    head, m, variant = parse_positional_kind(kind)
    per = [_term_positions(t_tids, t_pos, qt[:, i]) for i in range(m)]
    pos = torch.stack([p for p, _t in per], dim=2)      # [B, n, m, P]
    tf = torch.stack([t for _p, t in per], dim=2)       # [B, n, m]
    if head == "phrase_pos":
        if variant == "e":
            return _phrase_freq_exact(pos, tf)
        return _phrase_freq_sloppy(pos, tf, slop)
    if variant == "o":
        return _span_freq_ordered(pos, tf, slop)
    return _span_freq_unordered(pos, tf, slop)


def positional_impacts(freq: torch.Tensor, idf_sum: torch.Tensor,
                       k1ln: torch.Tensor) -> torch.Tensor:
    """Phrase frequency -> BM25 impact, op for op the f32 chain of
    search/phrase.phrase_impacts: (idf_sum * tf) * f32(k1 + 1), then
    / (tf + k1ln). freq 0 gives 0 / k1ln = 0 (k1ln > 0). k1ln is its own
    packed column, so no mul-add of k1 * lnorm can be contracted."""
    tf32 = freq.to(torch.float32)
    num = (idf_sum[:, None] * tf32) * np.float32(BM25_K1 + 1.0)
    return num / (tf32 + k1ln[None, :])


def bm25f_tile_scores(fields: tuple, qt: torch.Tensor, idf: torch.Tensor,
                      wf: torch.Tensor, text_tiles: dict, pos_tiles: dict
                      ) -> torch.Tensor:
    """BM25F over a doc set -> [B, n] f32, op for op the host oracle
    search/phrase.bm25f_scores (field-then-term f32 accumulation). The
    per-field tf is the positions column's valid count, the host's
    posting tf (the pack stores every occurrence)."""
    b = qt.shape[0]
    nf, nt = qt.shape[1], qt.shape[2]
    n_docs = pos_tiles[fields[0]][2].shape[0]
    k1_32 = np.float32(BM25_K1)
    total = torch.zeros((b, n_docs), dtype=torch.float32, device=qt.device)
    for ti in range(nt):
        acc = torch.zeros((b, n_docs), dtype=torch.float32, device=qt.device)
        for fi in range(nf):
            f = fields[fi]
            t_tids, _t_imps = text_tiles[f]
            t_pos, _k1ln, lnorm = pos_tiles[f]
            _pos, tf = _term_positions(t_tids, t_pos, qt[:, fi, ti])
            acc = acc + (wf[:, fi, None] * tf.to(torch.float32)) \
                / lnorm[None, :]
        total = total + (idf[:, ti, None] * acc) / (k1_32 + acc)
    return total


def positional_tile_scores(kind: str, field, inp: tuple, text_tiles: dict,
                           pos_tiles: dict
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(s_leaf [B, n] f32 with the clause boost applied, m_leaf [B, n]
    bool) of one positional clause over a doc set: the shared leaf of
    bundle_tile_eval, the plain K3 walk and eval_node's unfused path.
    `text_tiles[f]` = (tids [n, L], imps), `pos_tiles[f]` = (pos
    [n, L*P] i16, k1ln [n], lnorm [n])."""
    if positional_prefix(kind) == "bm25f":
        qt, idf, wf, pboost, _msm_c, _boost_c = inp
        raw = bm25f_tile_scores(field, qt, idf, wf, text_tiles, pos_tiles)
        return raw * pboost[:, None], raw > 0.0
    qt, _wb, idf_sum, slop, pboost, _msm_c, _boost_c = inp
    t_tids, _t_imps = text_tiles[field]
    t_pos, k1ln, _lnorm = pos_tiles[field]
    freq = positional_tile_freqs(kind, qt, slop, t_tids, t_pos)
    raw = positional_impacts(freq, idf_sum, k1ln)
    return raw * pboost[:, None], freq > 0


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
        head = positional_prefix(kind)
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
        elif head in ("phrase_pos", "span_pos"):
            # position-blind bound: a tile missing any required term
            # cannot match (tile_max > 0 iff the term occurs there); a
            # present tile's impact is below sum_i (idf_sum / idf_i) *
            # tile_max_i, since freq <= sum_i tf_i and the saturation is
            # concave-subadditive. Ordered span freq counts (start, end)
            # pairs, which can exceed sum tf_i, so it takes the flat
            # idf_sum * (k1 + 1) instead.
            qt, wb, idf_sum, _slop, pboost, msm_c, boost_c = inp
            tm = text_cols[field]["tile_max"]
            safe = qt.clamp(0, max(tm.shape[0] - 1, 0)).to(torch.int64)
            pres = torch.ones((b, n_tiles), dtype=torch.bool, device=dev)
            for i in range(qt.shape[1]):
                pres = pres & (tm[safe[:, i]] > 0.0) \
                    & (qt[:, i] >= 0)[:, None]
            if kind.endswith(":o"):
                ub = ((idf_sum * np.float32(BM25_K1 + 1.0)
                       * np.float32(BOUND_SLACK))[:, None]
                      .expand(b, n_tiles))
            else:
                ub = dense_tile_bounds(tm, qt, wb)
            ub = torch.where(pres, ub, 0.0) * pboost[:, None]
            p = (pres | (msm_c <= 0)[:, None]) & (msm_c <= 1)[:, None]
            if role in ("must", "should"):
                bound = bound + ub * boost_c[:, None]
            if role in ("must", "filter"):
                possible = possible & p
            elif role == "should":
                pos_cnt = pos_cnt + p.to(torch.int32)
        elif head == "bm25f":
            # per-term any-field presence; a present term's saturated
            # contribution idf_t * acc / (k1 + acc) is below idf_t
            qt, idf, _wf, pboost, msm_c, boost_c = inp
            nf, nt = qt.shape[1], qt.shape[2]
            ub = torch.zeros((b, n_tiles), dtype=torch.float32, device=dev)
            p_any = torch.zeros((b, n_tiles), dtype=torch.bool, device=dev)
            for t in range(nt):
                pres_t = torch.zeros((b, n_tiles), dtype=torch.bool,
                                     device=dev)
                for fi in range(nf):
                    tm = text_cols[field[fi]]["tile_max"]
                    safe = qt[:, fi, t].clamp(
                        0, max(tm.shape[0] - 1, 0)).to(torch.int64)
                    pres_t = pres_t | ((tm[safe] > 0.0)
                                       & (qt[:, fi, t] >= 0)[:, None])
                ub = ub + torch.where(pres_t, idf[:, t][:, None], 0.0)
                p_any = p_any | pres_t
            ub = ub * np.float32(BOUND_SLACK) * pboost[:, None]
            p = (p_any | (msm_c <= 0)[:, None]) & (msm_c <= 1)[:, None]
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
                     boost: torch.Tensor | None, t_live: torch.Tensor,
                     pos_tiles: dict | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Evaluate a clause bundle over a set of docs -> (score [B, n]
    post-boost, match [B, n] incl. live). `text_tiles[f]` = (tids
    [n, L], imps [n, L]), `num_tiles[f]` = (values [n], exists [n]),
    `pos_tiles[f]` = (pos [n, L*P] i16, k1ln [n], lnorm [n]).
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
        elif positional_prefix(kind):
            s_leaf, m_leaf = positional_tile_scores(
                kind, field, inp, text_tiles, pos_tiles)
            msm_c, boost_c = inp[-2], inp[-1]
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
                      t_live: torch.Tensor,
                      pos_tiles: dict | None = None) -> torch.Tensor:
    """Mask-only bundle_tile_eval -> match [B, n]. A dense clause's match
    is `score > 0`; impacts of real postings are positive and clause
    weights are clamped positive at bind time, so that equals "some
    query term (qt >= 0) sits in a slot with positive impact", which is
    what this membership test computes without the multiply-adds. A
    bm25f clause's match is the same test over its (field, term) pairs;
    a phrase / span clause's needs its frequency."""
    b = msm.shape[0]
    n = t_live.shape[0]
    dev = t_live.device
    must_ok = torch.ones((b, n), dtype=torch.bool, device=dev)
    not_any = torch.zeros((b, n), dtype=torch.bool, device=dev)
    cnt = torch.zeros((b, n), dtype=torch.int32, device=dev)
    for (role, kind, field, _w), inp in zip(clauses, cl_inputs):
        head = positional_prefix(kind)
        if head == "bm25f":
            qt, _idf, _wf, _pboost, msm_c, _boost_c = inp
            nf, nt = qt.shape[1], qt.shape[2]
            m_leaf = torch.zeros((b, n), dtype=torch.bool, device=dev)
            for fi in range(nf):
                t_tids, t_imps = text_tiles[field[fi]]
                present = t_imps > 0.0
                for t in range(nt):
                    tq = qt[:, fi, t][:, None, None]
                    hit = ((t_tids[None] == tq) & present[None]).any(dim=-1)
                    m_leaf = m_leaf | (hit & (qt[:, fi, t] >= 0)[:, None])
            m = (m_leaf | (msm_c <= 0)[:, None]) & (msm_c <= 1)[:, None]
        elif head:
            qt, _wb, _idf_sum, slop, _pb, msm_c, _boost_c = inp
            t_tids, _t_imps = text_tiles[field]
            t_pos, _k1ln, _lnorm = pos_tiles[field]
            m_leaf = positional_tile_freqs(kind, qt, slop, t_tids, t_pos) > 0
            m = (m_leaf | (msm_c <= 0)[:, None]) & (msm_c <= 1)[:, None]
        elif kind in DENSE_CLAUSE_KINDS:
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
