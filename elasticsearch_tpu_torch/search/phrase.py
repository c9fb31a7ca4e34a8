"""Positional matching: phrases and spans over the postings positions
sidecar, on the host.

Counterpart of `elasticsearch_tpu/search/phrase.py` (the reference's host
oracle), whole: Lucene PhraseQuery / SloppyPhraseScorer and the span
queries (span_term, span_near, span_or, span_first, span_not), plus the
BM25F scorer of `multi_match` type=cross_fields.

Exact phrases intersect encoded (doc * stride + pos) sorted sets with
numpy; sloppy phrases and span_near sweep pointers per candidate doc.
The result is a (docs, freqs) pair that the executor scores as a
precomputed posting list (a `docs_w` bound, scattered by the kernel
`ops/cuda_scoring.scatter_add`). The f32 impact formulas are op for op
those of the fused positional clauses (ops/scoring), so the host path
and the fused engine give bit-identical scores; the executor takes this
path for every positional query the fused engine does not admit, and
for all of them with `ES_TPU_POSITIONAL=0`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..index.segment import (PostingsField, BM25_K1, BM25_B, bm25_idf,
                             bm25_norms)


def _stride(pf: PostingsField) -> int:
    max_len = int(pf.doc_len.max(initial=0.0))
    return max(max_len + 2, 2)


def _enc_union(pf: PostingsField, tids: list[int], stride: int) -> np.ndarray:
    """Encoded positions of any of `tids` (union), sorted."""
    parts = [pf.enc_positions(t, stride) for t in tids]
    parts = [p for p in parts if p.size]
    if not parts:
        return np.empty(0, dtype=np.int64)
    if len(parts) == 1:
        return parts[0]
    return np.unique(np.concatenate(parts))


def phrase_match(pf: PostingsField, tid_groups: list[list[int]],
                 slop: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Match a phrase; element i of `tid_groups` is the set of acceptable
    term ids at phrase position i (len>1 for the match_phrase_prefix
    expansion of the trailing term).

    Returns (docs int64[], freqs int64[]) of matching docs. freq = number
    of phrase occurrences (Lucene phraseFreq with slop=0; window count for
    sloppy matches).
    """
    if any(not g for g in tid_groups):
        return np.empty(0, np.int64), np.empty(0, np.int64)
    stride = _stride(pf)
    if slop <= 0:
        s = _enc_union(pf, tid_groups[0], stride)
        for i in range(1, len(tid_groups)):
            if s.size == 0:
                break
            nxt = _enc_union(pf, tid_groups[i], stride)
            # a start p survives iff term i occurs at p+i
            s = s[np.isin(s + i, nxt, assume_unique=False)]
        if s.size == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        docs = s // stride
        uniq, counts = np.unique(docs, return_counts=True)
        return uniq, counts
    return _sloppy_match(pf, tid_groups, slop, stride)


def _sloppy_match(pf: PostingsField, tid_groups: list[list[int]], slop: int,
                  stride: int) -> tuple[np.ndarray, np.ndarray]:
    """Sloppy phrase: per candidate doc, count minimal windows whose width
    (max(p_i - i) - min(p_i - i)) is <= slop, via a pointer sweep over the
    per-term position lists (the SloppyPhraseScorer recurrence, counting
    windows instead of accumulating 1/(1+distance))."""
    n = len(tid_groups)
    encs = [_enc_union(pf, g, stride) for g in tid_groups]
    if any(e.size == 0 for e in encs):
        return np.empty(0, np.int64), np.empty(0, np.int64)
    doc_sets = [np.unique(e // stride) for e in encs]
    cands = doc_sets[0]
    for ds in doc_sets[1:]:
        cands = cands[np.isin(cands, ds)]
    out_docs: list[int] = []
    out_freqs: list[int] = []
    for d in cands:
        # adjusted positions: p - i must coincide within slop
        plists = []
        for i, e in enumerate(encs):
            mask = (e // stride) == d
            plists.append(np.sort(e[mask] % stride) - i)
        ptr = [0] * n
        freq = 0
        while all(ptr[i] < plists[i].size for i in range(n)):
            vals = [plists[i][ptr[i]] for i in range(n)]
            lo, hi = min(vals), max(vals)
            # repeated phrase terms must land on distinct token
            # occurrences (SloppyPhraseScorer's repeat handling): the raw
            # positions vals[i] + i must not collide
            distinct = len({int(vals[i]) + i for i in range(n)}) == n
            if hi - lo <= slop and distinct:
                freq += 1
                # advance the minimum pointer to look for the next window
            ptr[vals.index(lo)] += 1
        if freq:
            out_docs.append(int(d))
            out_freqs.append(freq)
    return (np.asarray(out_docs, dtype=np.int64),
            np.asarray(out_freqs, dtype=np.int64))


def phrase_impacts(pf: PostingsField, docs: np.ndarray, freqs: np.ndarray,
                   idf_sum: float, sim=None,
                   tids: list[int] | None = None) -> np.ndarray:
    """Eager impacts for phrase hits: idf is the sum over the phrase
    terms (Lucene PhraseWeight passes all TermStatistics to the
    similarity), tf is the phrase frequency.

    With a non-BM25 field similarity the phrase scores as a pseudo-term
    through that similarity, taking the rarest clause term's (df, ttf)
    as the pseudo-term statistics — the eager-impact analog of Lucene
    handing the phrase freq to the configured Similarity."""
    if docs.size == 0:
        return np.empty(0, dtype=np.float32)
    tf = freqs.astype(np.float64)
    from ..index.similarity import BM25Similarity, FieldStats
    if sim is None or isinstance(sim, BM25Similarity):
        # ONE f32 op order shared with the fused positional clause
        # kinds (ops/scoring.positional impact formula): k_d comes from
        # the packed k1ln column when the field carries the positional
        # pack with default parameters, recomputed through the same
        # bm25_norms rounding otherwise — this function is the
        # byte-identity oracle the device engines are gated against.
        k1 = sim.k1 if sim is not None else BM25_K1
        b = sim.b if sim is not None else BM25_B
        if (getattr(pf, "k1ln", None) is not None
                and k1 == BM25_K1 and b == BM25_B):
            k1ln = pf.k1ln
        else:
            k1ln = bm25_norms(pf.doc_len, pf.avg_len, k1, b)[1]
        tf32 = freqs.astype(np.float32)
        num = (np.float32(idf_sum) * tf32) * np.float32(k1 + 1.0)
        return num / (tf32 + k1ln[docs])
    tlist = [t for t in (tids or []) if t >= 0]
    if tlist:
        t_min = min(tlist, key=lambda t: pf.df[t])
        df = float(pf.df[t_min])
        s, e = int(pf.indptr[t_min]), int(pf.indptr[t_min + 1])
        ttf = float(pf.tfs[s:e].sum())
    else:
        df = ttf = max(float(docs.size), 1.0)
    st = FieldStats(df=df, ttf=max(ttf, df),
                    doc_count=float(pf.doc_count),
                    avg_len=float(pf.avg_len),
                    total_len=float(pf.doc_len.sum()))
    return sim.impacts(tf, pf.doc_len[docs].astype(np.float64),
                       st).astype(np.float32)


def terms_idf_sum(pf: PostingsField, tid_groups: list[list[int]]) -> float:
    total = 0.0
    for g in tid_groups:
        for t in g:
            if t >= 0:
                total += float(bm25_idf(float(pf.df[t]), pf.doc_count))
    return total


# ---------------------------------------------------------------------------
# Spans (ref: Lucene span package via index/query/Span*QueryParser.java)
# ---------------------------------------------------------------------------


@dataclass
class Spans:
    """Flat span set: (doc, start, end) triplets sorted by (doc, start, end).
    `end` is exclusive, Lucene-style."""

    docs: np.ndarray    # int64 [n]
    starts: np.ndarray  # int64 [n]
    ends: np.ndarray    # int64 [n]

    @staticmethod
    def empty() -> "Spans":
        z = np.empty(0, dtype=np.int64)
        return Spans(z, z.copy(), z.copy())

    @property
    def size(self) -> int:
        return int(self.docs.size)

    def sorted(self) -> "Spans":
        order = np.lexsort((self.ends, self.starts, self.docs))
        return Spans(self.docs[order], self.starts[order], self.ends[order])

    def doc_freqs(self) -> tuple[np.ndarray, np.ndarray]:
        if self.size == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        uniq, counts = np.unique(self.docs, return_counts=True)
        return uniq, counts


def span_term(pf: PostingsField, tid: int) -> Spans:
    if tid < 0 or pf.pos_data is None:
        return Spans.empty()
    stride = _stride(pf)
    enc = pf.enc_positions(tid, stride)
    if enc.size == 0:
        return Spans.empty()
    docs = enc // stride
    starts = enc % stride
    return Spans(docs, starts, starts + 1)


def span_or(children: list[Spans]) -> Spans:
    children = [c for c in children if c.size]
    if not children:
        return Spans.empty()
    docs = np.concatenate([c.docs for c in children])
    starts = np.concatenate([c.starts for c in children])
    ends = np.concatenate([c.ends for c in children])
    trip = np.unique(np.stack([docs, starts, ends], axis=1), axis=0)
    return Spans(trip[:, 0], trip[:, 1], trip[:, 2])


def span_near(children: list[Spans], slop: int, in_order: bool) -> Spans:
    """Combine child spans per doc: a match is one span from each child,
    all within a window of (total span length + slop); ordered variants
    additionally require child i's span to start at/after child i-1's end.
    Ref: Lucene NearSpansOrdered/NearSpansUnordered."""
    if not children:
        return Spans.empty()
    if len(children) == 1:
        return children[0].sorted()
    if any(c.size == 0 for c in children):
        return Spans.empty()
    cands = children[0].docs
    for c in children[1:]:
        cands = cands[np.isin(cands, c.docs)]
    cands = np.unique(cands)
    out_d: list[int] = []
    out_s: list[int] = []
    out_e: list[int] = []
    for d in cands:
        per = []
        for c in children:
            m = c.docs == d
            per.append(list(zip(c.starts[m].tolist(), c.ends[m].tolist())))
        if in_order:
            matches = _near_ordered(per, slop)
        else:
            matches = _near_unordered(per, slop)
        for s, e in matches:
            out_d.append(int(d))
            out_s.append(s)
            out_e.append(e)
    return Spans(np.asarray(out_d, np.int64), np.asarray(out_s, np.int64),
                 np.asarray(out_e, np.int64)).sorted()


def _near_ordered(per: list[list[tuple[int, int]]], slop: int
                  ) -> list[tuple[int, int]]:
    """Ordered near: recursively choose one span per child with
    start_i >= end_{i-1}; width = (last end - first start) minus the sum
    of matched span lengths must be <= slop."""
    out: list[tuple[int, int]] = []

    def rec(i: int, first_start: int, prev_end: int, len_sum: int) -> None:
        if i == len(per):
            gap = (prev_end - first_start) - len_sum
            if gap <= slop:
                out.append((first_start, prev_end))
            return
        for s, e in per[i]:
            if s >= prev_end:
                rec(i + 1, first_start, e, len_sum + (e - s))

    for s, e in per[0]:
        rec(1, s, e, e - s)
    # dedupe (different inner choices can produce the same envelope)
    return sorted(set(out))


def _near_unordered(per: list[list[tuple[int, int]]], slop: int
                    ) -> list[tuple[int, int]]:
    """Linear pointer sweep (Lucene NearSpansUnordered): keep one
    candidate span per child, test the enclosing window, then advance the
    child whose span starts earliest — O(total spans · n) instead of the
    Cartesian product."""
    n = len(per)
    lists = [sorted(p) for p in per]
    ptr = [0] * n
    out: set[tuple[int, int]] = set()
    while all(ptr[i] < len(lists[i]) for i in range(n)):
        chosen = [lists[i][ptr[i]] for i in range(n)]
        lo = min(s for s, _ in chosen)
        hi = max(e for _, e in chosen)
        len_sum = sum(e - s for s, e in chosen)
        if (hi - lo) - len_sum <= slop:
            out.add((lo, hi))
        # advance the child contributing the earliest start
        starts = [lists[i][ptr[i]][0] for i in range(n)]
        ptr[starts.index(min(starts))] += 1
    return sorted(out)


def bm25f_scores(pfs: list[PostingsField], tids: np.ndarray,
                 idf: np.ndarray, weights: np.ndarray, cap: int
                 ) -> np.ndarray:
    """BM25F over [cap] docs — the host oracle (and fallback) of the
    fused `bm25f` clause kind ("Integrating the Probabilistic Models
    BM25/BM25F into Lucene", PAPERS.md): per term, the per-field tfs
    blend into one length-normalized pseudo-frequency, saturated ONCE
    under a shared idf —

      acc_t(d) = sum_f  (w_f * tf_{f,t}(d)) / lnorm_f(d)
      score(d) = sum_t  idf_t * acc_t(d) / (k1 + acc_t(d))

    All f32, field-then-term accumulation order — op-for-op the fused
    engines' bm25f clause, so both paths are byte-identical. BM25F
    here is defined with the default k1/b (per-field similarity
    overrides stay with the per-field query forms).

    tids: int32 [nf, nt] per-(field, term) term ids (-1 = absent);
    idf: f32 [nt] shared idf; weights: f32 [nf] per-field weights.
    Returns the dense f32 [cap] score column (0 = no match).
    """
    nf, nt = tids.shape
    k1_32 = np.float32(BM25_K1)
    lnorms = []
    for pf in pfs:
        if getattr(pf, "lnorm", None) is not None:
            lnorms.append(pf.lnorm)
        else:
            lnorms.append(bm25_norms(pf.doc_len, pf.avg_len)[0])
    total = np.zeros(cap, np.float32)
    for ti in range(nt):
        acc = np.zeros(cap, np.float32)
        for fi in range(nf):
            pf = pfs[fi]
            t = int(tids[fi, ti])
            tfd = np.zeros(cap, np.float32)
            if t >= 0:
                s, e = int(pf.indptr[t]), int(pf.indptr[t + 1])
                tfd[pf.doc_ids[s:e]] = pf.tfs[s:e].astype(np.float32)
            acc = acc + (np.float32(weights[fi]) * tfd) / lnorms[fi]
        total = total + (np.float32(idf[ti]) * acc) / (k1_32 + acc)
    return total


def span_first(child: Spans, end_limit: int) -> Spans:
    if child.size == 0:
        return child
    m = child.ends <= end_limit
    return Spans(child.docs[m], child.starts[m], child.ends[m])


def span_not(include: Spans, exclude: Spans,
             pre: int = 0, post: int = 0) -> Spans:
    """Keep include spans that do not overlap any (pre/post-expanded)
    exclude span in the same doc. Ref: Lucene SpanNotQuery."""
    if include.size == 0 or exclude.size == 0:
        return include
    keep = np.ones(include.size, dtype=bool)
    for i in range(include.size):
        d = include.docs[i]
        s, e = include.starts[i], include.ends[i]
        m = exclude.docs == d
        if not m.any():
            continue
        xs = exclude.starts[m] - pre
        xe = exclude.ends[m] + post
        if np.any((xs < e) & (xe > s)):
            keep[i] = False
    return Spans(include.docs[keep], include.starts[keep], include.ends[keep])
