"""Immutable columnar segments (host numpy; uploaded by search/executor.py).

Counterpart of `elasticsearch_tpu/index/segment.py`, trimmed to the
columns this slice of the port searches:

  * text fields   -> block-CSR postings: 128-lane blocks of
                     (doc_id, bm25_impact) pairs, term -> block range,
                     plus the doc-major forward index [cap, L] and its
                     per-(term, doc-tile) block-max summary, and the
                     positions sidecar (`pos_data` / `pos_indptr`) with
                     its forward-aligned pack (`fwd_pos`, `lnorm`,
                     `k1ln`) for phrase, span and BM25F scoring;
  * keyword field -> int32 ordinal column + sorted term dictionary;
  * numeric/date  -> int32/float32 doc-value columns + exists mask;
  * dense_vector  -> float32 [cap, dims] values, exists mask and L2
                     norms (`VectorColumn`), plus the segment's IVF
                     coarse indexes (`ann`, built lazily by
                     `index/ann.ensure_ann` or restored by the store);
  * _id/_source   -> host-side.

The layout pass is the host one (`_pack_layout_host`); geo, nested rows
and the device-side build are not ported yet. The engine's
two repacks are: `merge_segments` (a rebuild from the rows, impacts
recomputed) and `concat_segments` (the streaming compaction: impacts
preserved, so a search of the result equals one of its sources). A delta
segment of the streaming write path (`delta_parent` set, shapes bucketed
by `pad_delta_shapes`) keys its caches on its base generation
(`cache_key`).
`segment_from_arrays` rebuilds a Segment from another builder's columns,
so two implementations can search the very same index.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field as dc_field
from typing import Iterable

import numpy as np

from .mapping import (ParsedDocument, TEXT, KEYWORD, DATE, BOOLEAN, IP,
                      LONG, INTEGER, SHORT, BYTE, DENSE_VECTOR)

BLOCK = 128           # posting block width (doc, impact) lanes
MAX_FWD_SLOTS = 256   # forward-index width limit (beyond: scatter path)
SCORE_TILE = 1024     # docs per block-max tile
TILE_SUMMARY_BUDGET = 1 << 24  # max T * n_tiles summary elements

BM25_K1 = 1.2
BM25_B = 0.75

# positional pack: per-(doc, slot) position lists, delta-encoded int16,
# P positions per slot (pow2). A field whose max per-posting tf exceeds
# POS_CAP, whose positions overflow int16, or whose pack would exceed
# POS_PACK_BUDGET elements gets no pack; its phrase/span/BM25F queries
# take the host path.
POS_CAP = 64                   # max positions kept per (doc, term)
POS_MAX_ENC = 32767            # int16 ceiling for absolute positions
POS_PACK_BUDGET = 1 << 27      # max cap * L * P int16 elements

_INT_KINDS = (LONG, INTEGER, SHORT, BYTE, DATE, BOOLEAN, IP)


def bm25_norms(doc_len: np.ndarray, avg_len: float,
               k1: float = BM25_K1, b: float = BM25_B
               ) -> tuple[np.ndarray, np.ndarray]:
    """The positional pack's two per-doc BM25 length-norm columns:

      lnorm[d] = (1 - b) + b * doc_len[d] / avg_len   (BM25F field norm)
      k1ln[d]  = k1 * lnorm[d]                        (phrase/span k_d)

    computed in f64 and rounded once to f32. The kernels, the unfused
    leaf and the host oracles (search/phrase.py) all read these values,
    which keeps their scores bit-identical."""
    ln = (1.0 - b) + b * (doc_len.astype(np.float64) / float(avg_len))
    return ln.astype(np.float32), (k1 * ln).astype(np.float32)


def next_pow2(n: int, floor: int = 1) -> int:
    n = max(n, floor)
    return 1 << (n - 1).bit_length()


def bm25_idf(df: np.ndarray | float, doc_count: int) -> np.ndarray | float:
    """idf = ln(1 + (N - df + 0.5) / (df + 0.5)) (Lucene BM25Similarity)."""
    return np.log(1.0 + (doc_count - df + 0.5) / (df + 0.5))


def score_tile_size(cap: int) -> int:
    return math.gcd(cap, SCORE_TILE)


def build_tile_max(fwd_tids: np.ndarray, fwd_imps: np.ndarray,
                   n_terms: int, cap: int,
                   tile: int | None = None) -> np.ndarray | None:
    """[cap, L] forward index -> [T, n_tiles] per-(term, doc-tile) max
    impact; None when there are no terms, the tile grid is degenerate,
    or the summary would exceed TILE_SUMMARY_BUDGET elements."""
    if tile is None:
        tile = score_tile_size(cap)
    if cap % tile != 0 or (tile < BLOCK and tile < cap):
        return None
    n_tiles = cap // tile
    if n_terms <= 0 or n_terms * n_tiles > TILE_SUMMARY_BUDGET:
        return None
    out = np.zeros((n_terms, n_tiles), dtype=np.float32)
    tids = fwd_tids[:cap].reshape(n_tiles, -1)
    imps = fwd_imps[:cap].reshape(n_tiles, -1)
    ok = tids >= 0
    tile_of = np.broadcast_to(np.arange(n_tiles)[:, None], tids.shape)
    np.maximum.at(out, (tids[ok], tile_of[ok]), imps[ok])
    return out


def build_tile_minmax(values: np.ndarray, exists: np.ndarray, cap: int,
                      tile: int | None = None
                      ) -> tuple[np.ndarray, np.ndarray] | None:
    """Per-tile [lo, hi] extrema of a single-valued numeric column over
    the SCORE_TILE grid, the summary that lets the fused bool engine
    prune tiles a range filter cannot match in. Tiles with no existing
    value get an empty interval (lo > hi), so they always prune; NaN
    values (which match no range) stay out of the extrema. None when the
    tile grid would be degenerate for this cap."""
    if tile is None:
        tile = score_tile_size(cap)
    if cap % tile != 0 or (tile < BLOCK and tile < cap):
        return None
    n_tiles = cap // tile
    v = values[:cap].reshape(n_tiles, tile)
    e = exists[:cap].reshape(n_tiles, tile)
    if values.dtype == np.float32:
        lo_pad, hi_pad = np.float32(np.inf), np.float32(-np.inf)
        e = e & ~np.isnan(v)
    else:
        lo_pad = np.iinfo(values.dtype).max
        hi_pad = np.iinfo(values.dtype).min
    lo = np.where(e, v, lo_pad).min(axis=1)
    hi = np.where(e, v, hi_pad).max(axis=1)
    return lo, hi


@dataclass
class PostingsField:
    """Inverted index for one analyzed text field, in block-CSR layout.

    Postings of term t live in blocks block_start[t] : block_start[t+1]
    of (block_docs, block_imps), padded with doc_id == capacity (dropped
    by scatter) and impact 0."""

    name: str
    terms: list[str]                       # sorted
    term_index: dict[str, int]
    df: np.ndarray                         # int32 [T]
    indptr: np.ndarray                     # int64 [T+1] into doc_ids/tfs
    doc_ids: np.ndarray                    # int32 [nnz]
    tfs: np.ndarray                        # float32 [nnz]
    doc_len: np.ndarray                    # float32 [cap]
    doc_count: int
    avg_len: float
    # positions of posting j (CSR order): pos_data[pos_indptr[j]:
    # pos_indptr[j+1]], token indices in the field's concatenated token
    # stream (multi-values join with no position gap)
    pos_data: np.ndarray = dc_field(default=None, repr=False)    # int32 [sum tf]
    pos_indptr: np.ndarray = dc_field(default=None, repr=False)  # int64 [nnz+1]
    block_docs: np.ndarray = dc_field(default=None, repr=False)  # int32 [NB,128]
    block_imps: np.ndarray = dc_field(default=None, repr=False)  # f32 [NB,128]
    block_start: np.ndarray = dc_field(default=None, repr=False)  # int32 [T+1]
    fwd_tids: np.ndarray = dc_field(default=None, repr=False)    # int32 [cap, L]
    fwd_imps: np.ndarray = dc_field(default=None, repr=False)    # f32 [cap, L]
    tile_max: np.ndarray = dc_field(default=None, repr=False)    # f32 [T, J]
    # positional pack, forward-aligned with fwd_tids: the positions of
    # the term in slot l of doc d are fwd_pos[d, l*P:(l+1)*P], the first
    # absolute and the rest gaps, pad -1; P = pos_width. None when the
    # field has no forward index or exceeds a positional cap.
    fwd_pos: np.ndarray = dc_field(default=None, repr=False)     # i16 [cap, L*P]
    pos_width: int = 0
    lnorm: np.ndarray = dc_field(default=None, repr=False)       # f32 [cap]
    k1ln: np.ndarray = dc_field(default=None, repr=False)        # f32 [cap]

    def lookup(self, term: str) -> int:
        return self.term_index.get(term, -1)

    def enc_positions(self, tid: int, stride: int) -> np.ndarray:
        """All (doc, position) pairs of a term encoded as
        doc * stride + pos, ascending (search/phrase.py's working set)."""
        if self.pos_data is None or tid < 0:
            return np.empty(0, dtype=np.int64)
        s, e = int(self.indptr[tid]), int(self.indptr[tid + 1])
        if s == e:
            return np.empty(0, dtype=np.int64)
        ps, pe = int(self.pos_indptr[s]), int(self.pos_indptr[e])
        docs = np.repeat(self.doc_ids[s:e].astype(np.int64),
                         np.diff(self.pos_indptr[s:e + 1]).astype(np.int64))
        return docs * stride + self.pos_data[ps:pe]

    def nbytes(self) -> int:
        n = (self.block_docs.nbytes + self.block_imps.nbytes
             + self.block_start.nbytes + self.doc_len.nbytes)
        for a in (self.fwd_tids, self.fwd_imps, self.tile_max):
            if a is not None:
                n += a.nbytes
        if self.fwd_pos is not None:
            n += self.fwd_pos.nbytes + self.lnorm.nbytes + self.k1ln.nbytes
        return n


@dataclass
class KeywordColumn:
    """Ordinal doc-value column: ords[d] indexes `terms` (sorted), -1 = missing;
    multi-valued docs carry their MIN ord plus the [cap, M] `mv_ords` sidecar."""

    name: str
    terms: list[str]
    term_index: dict[str, int]
    ords: np.ndarray                       # int32 [cap]
    df: np.ndarray                         # int32 [card]
    mv_ords: np.ndarray = dc_field(default=None, repr=False)

    @property
    def cardinality(self) -> int:
        return len(self.terms)

    def lookup(self, term: str) -> int:
        return self.term_index.get(term, -1)

    def nbytes(self) -> int:
        n = self.ords.nbytes + self.df.nbytes
        if self.mv_ords is not None:
            n += self.mv_ords.nbytes
        return n


@dataclass
class NumericColumn:
    """Numeric/date/boolean/ip doc-value column. Device dtype int32 when
    every value fits, float32 otherwise; dates are epoch SECONDS on the
    device, with the host-exact originals in `raw`."""

    name: str
    kind: str
    values: np.ndarray                     # int32 or float32 [cap]
    exists: np.ndarray                     # bool [cap]
    raw: np.ndarray                        # int64 or float64 [cap]
    bias: int = 0
    mv_values: np.ndarray = dc_field(default=None, repr=False)
    mv_raw: np.ndarray = dc_field(default=None, repr=False)
    mv_exists: np.ndarray = dc_field(default=None, repr=False)

    def nbytes(self) -> int:
        n = self.values.nbytes + self.exists.nbytes
        if self.mv_values is not None:
            n += self.mv_values.nbytes + self.mv_exists.nbytes
        return n


@dataclass
class VectorColumn:
    """Dense embedding column: [capacity, dims] float32 (the device holds
    it in bf16, search/executor.device_arrays)."""

    name: str
    values: np.ndarray                     # float32 [cap, dims]
    exists: np.ndarray                     # bool [cap]
    norms: np.ndarray                      # float32 [cap] L2 norms (0 if absent)

    @property
    def dims(self) -> int:
        return self.values.shape[1]

    def nbytes(self) -> int:
        return self.values.nbytes + self.exists.nbytes + self.norms.nbytes


@dataclass
class Segment:
    """One immutable columnar segment."""

    seg_id: str
    num_docs: int
    capacity: int
    ids: list[str]
    id_map: dict[str, int]
    sources: list[bytes]
    versions: np.ndarray                   # int64 [num_docs]
    text: dict[str, PostingsField]
    keywords: dict[str, KeywordColumn]
    numerics: dict[str, NumericColumn]
    vectors: dict[str, VectorColumn] = dc_field(default_factory=dict)
    # IVF coarse indexes per dense_vector field (index/ann.AnnIndex),
    # built lazily at the first eligible search (index/ann.ensure_ann) or
    # restored by the store; delta segments never carry one
    ann: dict[str, object] = dc_field(default_factory=dict)
    # streaming write path: a DELTA segment is the small append-only pack
    # rebuilt at every refresh on top of an immutable base generation.
    # `delta_parent` is the base generation key it rides on;
    # `delta_epoch` counts rebuilds since the last compaction. Base
    # segments leave both at their defaults.
    delta_parent: str | None = None
    delta_epoch: int = 0
    # True for concat_segments products: their eager impacts were
    # preserved from the source segments' field stats and cannot be
    # recomputed from this segment's own doc_count / avg_len
    impacts_preserved: bool = False

    def primary_mask(self) -> np.ndarray:
        m = np.zeros(self.capacity, dtype=bool)
        m[: self.num_docs] = True
        return m

    def fingerprint(self) -> str:
        """Content fingerprint for restart-stable caches: the pack's
        shape-and-statistics signature, different whenever a refresh or
        merge rebuilds the segment with other contents, never seg_id."""
        cached = getattr(self, "_fingerprint", None)
        if cached is not None:
            return cached
        import hashlib
        h = hashlib.blake2b(digest_size=12)
        h.update(f"{self.capacity}|{self.num_docs}".encode())
        for f in sorted(self.text):
            pf = self.text[f]
            h.update(f"|t:{f}:{len(pf.terms)}:{int(pf.df.sum())}:"
                     f"{float(pf.doc_len.sum()):.3f}".encode())
        for f in sorted(self.keywords):
            kc = self.keywords[f]
            h.update(f"|k:{f}:{kc.cardinality}:{int(kc.df.sum())}".encode())
        for f in sorted(self.numerics):
            nc = self.numerics[f]
            # value-sensitive, not just count-sensitive: a refresh that
            # rewrites values but not doc counts must still re-key
            vsum = float(np.where(nc.exists,
                                  np.nan_to_num(
                                      nc.values.astype(np.float64)),
                                  0.0).sum())
            h.update(f"|n:{f}:{nc.kind}:{int(nc.exists.sum())}:"
                     f"{vsum:.6g}".encode())
        fp = h.hexdigest()
        self._fingerprint = fp  # type: ignore[attr-defined]
        return fp

    def cache_key(self) -> str:
        """Key of fingerprint-keyed caches (resident entries). Base
        segments key on content (`fingerprint()`), so a compaction
        re-keys; DELTA segments key on the base generation plus the pow2
        capacity bucket, so a refresh that rebuilds the delta within its
        bucket keeps every cache keyed here: an epoch bump, not an
        eviction."""
        if self.delta_parent is None:
            return self.fingerprint()
        return (f"delta({self.delta_parent}):"
                f"c{next_pow2(self.capacity, floor=BLOCK)}")

    def nbytes(self) -> int:
        # the lazily built IVF indexes (self.ann) are left out: their
        # upload is held against the breaker on its own
        # (index/ann.ensure_ann_device)
        return sum(f.nbytes() for group in (self.text, self.keywords,
                                            self.numerics, self.vectors)
                   for f in group.values())

    def field_kind(self, name: str) -> str | None:
        if name in self.text:
            return "text"
        if name in self.keywords:
            return "keyword"
        if name in self.numerics:
            return "numeric"
        if name in self.vectors:
            return "vector"
        return None


class SegmentBuilder:
    """Accumulates parsed documents, emits an immutable Segment with BM25
    impacts baked into the posting blocks. `similarity` maps a text field
    name to its Similarity (None = BM25 everywhere)."""

    _counter = 0

    def __init__(self, similarity=None):
        self.docs: list[ParsedDocument] = []
        self.versions: list[int] = []
        self.similarity = similarity

    def add(self, doc: ParsedDocument, version: int = 1) -> None:
        self.docs.append(doc)
        self.versions.append(version)

    def __len__(self) -> int:
        return len(self.docs)

    @property
    def num_docs(self) -> int:
        return len(self.docs)

    def build(self, seg_id: str | None = None) -> Segment:
        if seg_id is None:
            SegmentBuilder._counter += 1
            seg_id = f"seg_{SegmentBuilder._counter}"
        n = len(self.docs)
        cap = next_pow2(n, floor=BLOCK)
        ids: list[str] = []
        id_map: dict[str, int] = {}
        sources: list[bytes] = []
        # text field -> term -> ([docs], [tfs], [positions, flat]) in
        # doc order
        text_postings: dict[str, dict[str, tuple[list, list, list]]] = {}
        text_doclen: dict[str, np.ndarray] = {}
        kw_values: dict[str, dict[int, list[str]]] = {}
        num_values: dict[str, tuple[str, dict[int, list]]] = {}
        vec_values: dict[str, dict[int, list[float]]] = {}
        for d, doc in enumerate(self.docs):
            ids.append(doc.doc_id)
            id_map[doc.doc_id] = d
            sources.append(doc.source)
            doc_tokens: dict[str, list[str]] = {}
            for pf in doc.fields:
                if pf.type == TEXT:
                    doc_tokens.setdefault(pf.name, []).extend(pf.tokens or [])
                elif pf.type == KEYWORD:
                    kw_values.setdefault(pf.name, {}).setdefault(d, []).append(
                        str(pf.value))
                elif pf.type == DENSE_VECTOR:
                    vcol = vec_values.setdefault(pf.name, {})
                    if d not in vcol:
                        vcol[d] = pf.value
                else:
                    _kind, col = num_values.setdefault(pf.name, (pf.type, {}))
                    col.setdefault(d, []).append(pf.value)
            for fname, toks in doc_tokens.items():
                postings = text_postings.setdefault(fname, {})
                if fname not in text_doclen:
                    text_doclen[fname] = np.zeros(cap, dtype=np.float32)
                text_doclen[fname][d] += float(len(toks))
                pos_local: dict[str, list[int]] = {}
                for i, tok in enumerate(toks):
                    pos_local.setdefault(tok, []).append(i)
                for term, positions in pos_local.items():
                    entry = postings.get(term)
                    if entry is None:
                        entry = postings[term] = ([], [], [])
                    entry[0].append(d)
                    entry[1].append(len(positions))
                    entry[2].extend(positions)
        text = {name: _build_postings(name, postings, text_doclen[name], n,
                                      cap, self._sim_for(name))
                for name, postings in text_postings.items()}
        keywords = {name: _build_keyword(name, col, cap)
                    for name, col in kw_values.items()}
        numerics = {name: _build_numeric(name, kind, col, cap)
                    for name, (kind, col) in num_values.items()}
        vectors = {name: _build_vector(name, col, cap)
                   for name, col in vec_values.items()}
        return Segment(seg_id=seg_id, num_docs=n, capacity=cap, ids=ids,
                       id_map=id_map, sources=sources,
                       versions=np.asarray(self.versions, dtype=np.int64),
                       text=text, keywords=keywords, numerics=numerics,
                       vectors=vectors)

    def _sim_for(self, field: str):
        if self.similarity is None:
            return None
        return self.similarity(field)


def _build_postings(name: str, postings: dict, doc_len: np.ndarray,
                    n_docs: int, cap: int, sim=None) -> PostingsField:
    terms = sorted(postings)
    df = np.array([len(postings[t][0]) for t in terms], dtype=np.int32)
    indptr = np.zeros(len(terms) + 1, dtype=np.int64)
    np.cumsum(df, out=indptr[1:])
    doc_ids = np.concatenate([np.asarray(postings[t][0], dtype=np.int32)
                              for t in terms]) if terms \
        else np.empty(0, dtype=np.int32)
    tfs = np.concatenate([np.asarray(postings[t][1], dtype=np.float32)
                          for t in terms]) if terms \
        else np.empty(0, dtype=np.float32)
    pos_indptr = np.zeros(len(doc_ids) + 1, dtype=np.int64)
    np.cumsum(tfs.astype(np.int64), out=pos_indptr[1:])
    pos_data = np.fromiter(
        itertools.chain.from_iterable(postings[t][2] for t in terms),
        dtype=np.int32, count=int(pos_indptr[-1]))
    doc_count = int(np.count_nonzero(doc_len[:n_docs])) or n_docs
    total_len = float(doc_len.sum())
    avg_len = (total_len / doc_count) if doc_count else 1.0
    pf = PostingsField(
        name=name, terms=terms, term_index={t: i for i, t in enumerate(terms)},
        df=df, indptr=indptr, doc_ids=doc_ids, tfs=tfs, doc_len=doc_len,
        doc_count=doc_count, avg_len=max(avg_len, 1e-9), pos_data=pos_data,
        pos_indptr=pos_indptr)
    _pack_layout_host(pf, cap, _flat_impacts(pf, sim))
    return pf


def _build_keyword(name: str, col: dict[int, list[str]], cap: int
                   ) -> KeywordColumn:
    terms = sorted({v for vs in col.values() for v in vs})
    term_index = {t: i for i, t in enumerate(terms)}
    per_doc = {d: sorted({term_index[v] for v in vs}) for d, vs in col.items()}
    ords = np.full(cap, -1, dtype=np.int32)
    for d, os_ in per_doc.items():
        ords[d] = os_[0]
    df = np.zeros(len(terms), dtype=np.int32)
    for os_ in per_doc.values():
        df[os_] += 1
    mv = None
    max_len = max((len(o) for o in per_doc.values()), default=1)
    if max_len > 1:
        M = next_pow2(max_len, floor=2)
        mv = np.full((cap, M), -1, dtype=np.int32)
        for d, os_ in per_doc.items():
            mv[d, : len(os_)] = os_
    return KeywordColumn(name=name, terms=terms, term_index=term_index,
                         ords=ords, df=df, mv_ords=mv)


def _build_numeric(name: str, kind: str, col: dict[int, list],
                   cap: int) -> NumericColumn:
    exists = np.zeros(cap, dtype=bool)
    is_int = kind in _INT_KINDS
    dt = np.int64 if is_int else np.float64
    raw = np.zeros(cap, dtype=dt)

    def norm(v):
        if kind == BOOLEAN:
            return 1 if v else 0
        return v

    for d, vs in col.items():
        exists[d] = True
        raw[d] = min(norm(v) for v in vs)
    bias = 1 << 31 if kind == IP else 0
    vals = _device_vals(raw, kind, bias, is_int)
    mv_raw = mv_vals = mv_exists = None
    max_len = max((len(v) for v in col.values()), default=1)
    if max_len > 1:
        M = next_pow2(max_len, floor=2)
        mv_raw = np.zeros((cap, M), dtype=dt)
        mv_exists = np.zeros((cap, M), dtype=bool)
        for d, vs in col.items():
            for j, v in enumerate(vs[:M]):
                mv_raw[d, j] = norm(v)
                mv_exists[d, j] = True
        mv_vals = _device_vals(mv_raw, kind, bias, is_int)
    return NumericColumn(name=name, kind=kind, values=vals, exists=exists,
                         raw=raw, bias=bias, mv_values=mv_vals,
                         mv_raw=mv_raw, mv_exists=mv_exists)


def _build_vector(name: str, col: dict[int, list[float]], cap: int
                  ) -> VectorColumn:
    dims = len(next(iter(col.values())))
    values = np.zeros((cap, dims), dtype=np.float32)
    exists = np.zeros(cap, dtype=bool)
    for d, vec in col.items():
        values[d, : len(vec)] = np.asarray(vec, dtype=np.float32)
        exists[d] = True
    return vector_column(name, values, exists)


def vector_column(name: str, values: np.ndarray,
                  exists: np.ndarray) -> VectorColumn:
    """A VectorColumn over f32 [cap, dims] values, norms as the
    reference's builder computes them (np.linalg.norm per row)."""
    values = np.asarray(values, dtype=np.float32)
    return VectorColumn(name=name, values=values,
                        exists=np.asarray(exists, dtype=bool),
                        norms=np.linalg.norm(values, axis=1)
                        .astype(np.float32))


def _flat_impacts(pf: PostingsField, sim=None) -> np.ndarray:
    """Per-posting eager impacts in CSR order ([nnz] f32)."""
    if sim is None:
        from .similarity import DEFAULT_SIMILARITY
        sim = DEFAULT_SIMILARITY
    from .similarity import FieldStats
    T = len(pf.terms)
    total_len = float(pf.doc_len.sum())
    ttf_all = np.zeros(T, dtype=np.float64)
    np.add.at(ttf_all, np.repeat(np.arange(T), np.diff(pf.indptr)),
              pf.tfs.astype(np.float64))
    out = np.zeros(len(pf.doc_ids), dtype=np.float32)
    for t in range(T):
        s, e = int(pf.indptr[t]), int(pf.indptr[t + 1])
        if s == e:
            continue
        docs = pf.doc_ids[s:e]
        tf = pf.tfs[s:e].astype(np.float64)
        st = FieldStats(df=float(pf.df[t]), ttf=float(ttf_all[t]),
                        doc_count=float(pf.doc_count),
                        avg_len=float(pf.avg_len), total_len=total_len)
        out[s:e] = sim.impacts(tf, pf.doc_len[docs].astype(np.float64), st)
    return out


def extract_flat_impacts(pf: PostingsField) -> np.ndarray:
    """The [nnz] CSR-order impacts read back from the posting blocks:
    the inverse of the layout's block fill, exact by construction
    (blocks are contiguous BLOCK-lane slices of each term's run). The
    streaming compaction reads impacts this way, so a compacted base
    scores byte-identically to the packs it folded."""
    nnz = len(pf.doc_ids)
    out = np.empty(nnz, dtype=np.float32)
    for t in range(len(pf.terms)):
        s, e = int(pf.indptr[t]), int(pf.indptr[t + 1])
        b0 = int(pf.block_start[t])
        for off in range(0, e - s, BLOCK):
            blk = b0 + off // BLOCK
            ln = min(BLOCK, e - s - off)
            out[s + off: s + off + ln] = pf.block_imps[blk, :ln]
    return out


def _pack_layout_host(pf: PostingsField, cap: int, imps: np.ndarray) -> None:
    """Block-CSR posting blocks, forward index, block-max summary and
    positional pack from CSR postings + per-posting impacts (host
    loops)."""
    T = len(pf.terms)
    n_blocks_per_term = (np.diff(pf.indptr) + BLOCK - 1) // BLOCK
    block_start = np.zeros(T + 1, dtype=np.int32)
    np.cumsum(n_blocks_per_term, out=block_start[1:])
    nb = int(block_start[-1])
    nb_pad = next_pow2(nb, floor=1)
    block_docs = np.full((nb_pad, BLOCK), cap, dtype=np.int32)
    block_imps = np.zeros((nb_pad, BLOCK), dtype=np.float32)
    for t in range(T):
        s, e = int(pf.indptr[t]), int(pf.indptr[t + 1])
        docs = pf.doc_ids[s:e]
        imp = imps[s:e]
        b0 = int(block_start[t])
        for off in range(0, e - s, BLOCK):
            blk = b0 + off // BLOCK
            ln = min(BLOCK, e - s - off)
            block_docs[blk, :ln] = docs[off:off + ln]
            block_imps[blk, :ln] = imp[off:off + ln]
    pf.block_docs = block_docs
    pf.block_imps = block_imps
    pf.block_start = block_start

    # forward (doc-major) layout; past MAX_FWD_SLOTS the field keeps only
    # the posting blocks and its queries take the scatter path
    lengths = np.zeros(cap, dtype=np.int64)
    np.add.at(lengths, pf.doc_ids, 1)
    L = next_pow2(int(lengths.max(initial=1)), floor=8)
    if L > MAX_FWD_SLOTS:
        pf.fwd_tids = None
        pf.fwd_imps = None
        return
    fwd_tids = np.full((cap, L), -1, dtype=np.int32)
    fwd_imps = np.zeros((cap, L), dtype=np.float32)
    slot = np.zeros(cap, dtype=np.int64)
    for t in range(T):
        s, e = int(pf.indptr[t]), int(pf.indptr[t + 1])
        docs = pf.doc_ids[s:e]
        b0 = int(block_start[t])
        for off in range(0, e - s, BLOCK):
            blk = b0 + off // BLOCK
            ln = min(BLOCK, e - s - off)
            d_slice = docs[off:off + ln]
            j = slot[d_slice]
            fwd_tids[d_slice, j] = t
            fwd_imps[d_slice, j] = block_imps[blk, :ln]
            slot[d_slice] = j + 1
    pf.fwd_tids = fwd_tids
    pf.fwd_imps = fwd_imps
    pf.tile_max = build_tile_max(fwd_tids, fwd_imps, T, cap)
    pack_positions(pf, cap)


def forward_slot_ranks(doc_ids: np.ndarray) -> np.ndarray:
    """Per-posting forward-index slot, CSR order: the rank of each
    posting among its doc's postings in term-major order, which is the
    slot _pack_layout_host's forward fill assigns."""
    nnz = len(doc_ids)
    order = np.argsort(doc_ids, kind="stable")
    sorted_docs = doc_ids[order]
    first = np.searchsorted(sorted_docs, sorted_docs, side="left")
    out = np.empty(nnz, dtype=np.int64)
    out[order] = np.arange(nnz, dtype=np.int64) - first
    return out


def position_deltas(pf: PostingsField) -> np.ndarray:
    """[sum tf] int16 delta stream of the positions sidecar: per posting
    the first entry is the absolute position, the rest are gaps."""
    pd = pf.pos_data.astype(np.int64)
    d = pd.copy()
    d[1:] -= pd[:-1]
    counts = np.diff(pf.pos_indptr)
    starts = pf.pos_indptr[:-1][counts > 0]
    d[starts] = pd[starts]
    return d.astype(np.int16)


def pos_pack_width(pf: PostingsField, cap: int, L: int) -> int | None:
    """P (pow2 positions per slot) of a field's pack, or None when the
    field stays host-served: no sidecar, tf over POS_CAP, positions past
    the int16 ceiling, or a pack over POS_PACK_BUDGET elements."""
    if pf.pos_data is None or pf.pos_indptr is None:
        return None
    max_tf = int(np.diff(pf.pos_indptr).max(initial=0))
    if max_tf <= 0 or max_tf > POS_CAP:
        return None
    if pf.pos_data.size and int(pf.pos_data.max(initial=0)) > POS_MAX_ENC:
        return None
    P = next_pow2(max_tf, floor=2)
    if cap * L * P > POS_PACK_BUDGET:
        return None
    return P


def pack_positions(pf: PostingsField, cap: int) -> None:
    """The positional column family (fwd_pos + the BM25 length-norm
    columns) from the positions sidecar, forward-aligned with fwd_tids."""
    pf.fwd_pos = None
    pf.pos_width = 0
    pf.lnorm = None
    pf.k1ln = None
    if pf.fwd_tids is None:
        return
    L = pf.fwd_tids.shape[1]
    P = pos_pack_width(pf, cap, L)
    if P is None:
        return
    deltas = position_deltas(pf)
    doc_pp, flat_pp = _position_targets(pf, P)
    fwd_pos = np.full((cap, L * P), -1, dtype=np.int16)
    fwd_pos[doc_pp, flat_pp] = deltas
    pf.fwd_pos = fwd_pos
    pf.pos_width = P
    pf.lnorm, pf.k1ln = bm25_norms(pf.doc_len, pf.avg_len)


def _position_targets(pf: PostingsField, P: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Per-position (doc row, slot * P + k) scatter targets."""
    counts = np.diff(pf.pos_indptr).astype(np.int64)
    slots = forward_slot_ranks(pf.doc_ids)
    doc_pp = np.repeat(pf.doc_ids.astype(np.int64), counts)
    slot_pp = np.repeat(slots, counts)
    k_pp = (np.arange(int(counts.sum()), dtype=np.int64)
            - np.repeat(pf.pos_indptr[:-1].astype(np.int64), counts))
    return doc_pp, slot_pp * P + k_pp


def pad_delta_shapes(seg: Segment) -> Segment:
    """Bucket every term-count-derived array of a delta segment to the
    next power of two, so the pack's shape signature (and with it every
    resident entry keyed on it) stays constant while the delta grows
    within a bucket. Capacity, forward width L and block counts are
    already pow2; the term count T was the one content-proportional
    shape left. Padded tile_max rows carry zero impact (an absent term
    bounds to 0 and never un-prunes a tile); padded block_start entries
    repeat the final block (zero postings). Mutates and returns `seg`."""
    for pf in seg.text.values():
        T = len(pf.terms)
        t_pad = next_pow2(max(T, 1), floor=8)
        if pf.tile_max is not None and pf.tile_max.shape[0] < t_pad:
            pad = np.zeros((t_pad - pf.tile_max.shape[0],
                            pf.tile_max.shape[1]), np.float32)
            pf.tile_max = np.concatenate([pf.tile_max, pad], axis=0)
        if pf.block_start is not None and len(pf.block_start) < t_pad + 1:
            pf.block_start = np.concatenate(
                [pf.block_start,
                 np.full(t_pad + 1 - len(pf.block_start),
                         pf.block_start[-1], dtype=pf.block_start.dtype)])
    return seg


def _device_vals(raw: np.ndarray, kind: str, bias: int,
                 is_int: bool) -> np.ndarray:
    """Host-exact raw values -> device column dtype (see NumericColumn)."""
    if kind == DATE:
        return (raw // 1000).astype(np.int32)
    if kind == IP:
        return (raw - bias).astype(np.int32)
    if is_int:
        lo, hi = raw.min(initial=0), raw.max(initial=0)
        if np.iinfo(np.int32).min <= lo and hi <= np.iinfo(np.int32).max:
            return raw.astype(np.int32)
        return raw.astype(np.float32)
    return raw.astype(np.float32)


def build_columnar(seg_id: str, n: int, *,
                   keywords: dict[str, np.ndarray] | None = None,
                   numerics: dict[str, tuple[str, np.ndarray]] | None = None,
                   ids: list[str] | None = None,
                   sources: list[bytes] | None = None,
                   pad_multiple: int = 512) -> Segment:
    """Bulk columnar ingestion of single-valued keyword/numeric columns
    straight from numpy arrays (numerics in host units: dates in epoch
    millis). Capacity pads to `pad_multiple`."""
    cap = max(-(-n // pad_multiple) * pad_multiple, BLOCK)
    kw_cols = {}
    for name, vals in (keywords or {}).items():
        terms_arr, inv = np.unique(np.asarray(vals), return_inverse=True)
        terms = [str(t) for t in terms_arr]
        ords = np.full(cap, -1, dtype=np.int32)
        ords[:n] = inv.astype(np.int32)
        kw_cols[name] = KeywordColumn(
            name=name, terms=terms,
            term_index={t: i for i, t in enumerate(terms)}, ords=ords,
            df=np.bincount(inv, minlength=len(terms)).astype(np.int32))
    num_cols = {}
    for name, (kind, vals) in (numerics or {}).items():
        is_int = kind in _INT_KINDS
        raw = np.zeros(cap, dtype=np.int64 if is_int else np.float64)
        raw[:n] = vals
        exists = np.zeros(cap, dtype=bool)
        exists[:n] = True
        bias = 1 << 31 if kind == IP else 0
        num_cols[name] = NumericColumn(
            name=name, kind=kind, values=_device_vals(raw, kind, bias, is_int),
            exists=exists, raw=raw, bias=bias)
    ids = ids if ids is not None else [str(i) for i in range(n)]
    return Segment(
        seg_id=seg_id, num_docs=n, capacity=cap, ids=ids,
        id_map={i: j for j, i in enumerate(ids)},
        sources=sources if sources is not None else [b"{}"] * n,
        versions=np.ones(n, dtype=np.int64),
        text={}, keywords=kw_cols, numerics=num_cols)


_TEXT_COLS = ("df", "indptr", "doc_ids", "tfs", "doc_len", "block_docs",
              "block_imps", "block_start", "fwd_tids", "fwd_imps", "tile_max",
              "pos_data", "pos_indptr", "fwd_pos", "lnorm", "k1ln")
_KW_COLS = ("ords", "df", "mv_ords")
_NUM_COLS = ("values", "exists", "raw", "mv_values", "mv_raw", "mv_exists")
_VEC_COLS = ("values", "exists", "norms")


def segment_from_arrays(arrays: dict[str, np.ndarray], meta: dict) -> Segment:
    """Build a Segment from another builder's columns.

    `arrays` holds numpy columns keyed `text.<field>.<col>` (df, indptr,
    doc_ids, tfs, doc_len, block_docs, block_imps, block_start, and the
    optional fwd_tids, fwd_imps, tile_max, pos_data, pos_indptr, fwd_pos,
    lnorm, k1ln), `kw.<field>.<col>` (ords, df,
    optional mv_ords), `num.<field>.<col>` (values, exists, raw, optional
    mv_values, mv_raw, mv_exists), `vec.<field>.<col>` (values, exists,
    norms) and `versions`. `meta` holds seg_id, num_docs, capacity, ids,
    optional sources, and per field: text -> {terms, doc_count,
    avg_len}, keywords -> {terms}, numerics -> {kind, bias}, vectors ->
    {}."""
    def cols(prefix: str, names: tuple) -> dict:
        return {c: (np.array(arrays[f"{prefix}.{c}"], copy=True)
                    if f"{prefix}.{c}" in arrays else None) for c in names}

    text = {}
    for f, m in meta.get("text", {}).items():
        c = cols(f"text.{f}", _TEXT_COLS)
        terms = list(m["terms"])
        p_width = (c["fwd_pos"].shape[1] // c["fwd_tids"].shape[1]
                   if c["fwd_pos"] is not None else 0)
        text[f] = PostingsField(
            name=f, terms=terms, term_index={t: i for i, t in enumerate(terms)},
            doc_count=int(m["doc_count"]), avg_len=float(m["avg_len"]),
            pos_width=p_width, **c)
    keywords = {}
    for f, m in meta.get("keywords", {}).items():
        terms = list(m["terms"])
        keywords[f] = KeywordColumn(
            name=f, terms=terms, term_index={t: i for i, t in enumerate(terms)},
            **cols(f"kw.{f}", _KW_COLS))
    numerics = {f: NumericColumn(name=f, kind=m["kind"], bias=int(m.get("bias", 0)),
                                 **cols(f"num.{f}", _NUM_COLS))
                for f, m in meta.get("numerics", {}).items()}
    vectors = {f: VectorColumn(name=f, **cols(f"vec.{f}", _VEC_COLS))
               for f in meta.get("vectors", {})}
    n = int(meta["num_docs"])
    ids = list(meta["ids"])
    return Segment(
        seg_id=meta["seg_id"], num_docs=n, capacity=int(meta["capacity"]),
        ids=ids, id_map={i: j for j, i in enumerate(ids)},
        sources=list(meta.get("sources") or [b"{}"] * n),
        versions=np.asarray(arrays.get("versions", np.ones(n)), dtype=np.int64),
        text=text, keywords=keywords, numerics=numerics, vectors=vectors)


def concat_segments(segments: Iterable[Segment], seg_id: str | None = None,
                    live_masks: dict[str, np.ndarray] | None = None
                    ) -> Segment:
    """Impact-PRESERVING columnar concatenation: the streaming write
    path's compaction (delta folded into a new base while the old
    generation keeps serving).

    Unlike merge_segments (which re-derives the tokens and recomputes
    impacts under the merged field stats), every surviving posting keeps
    the impact its source pack scored it with: term dictionaries union,
    doc rows renumber (dead rows drop), and the layouts rebuild from the
    preserved impacts, so a search of the compacted base equals the same
    search of the base + delta pair it folded."""
    segs = [s for s in segments if s.num_docs > 0]
    if seg_id is None:
        SegmentBuilder._counter += 1
        seg_id = f"seg_{SegmentBuilder._counter}"

    # -- row survival + renumbering ---------------------------------------
    keeps: list[np.ndarray] = []          # bool [num_docs] per seg
    row_maps: list[np.ndarray] = []       # old row -> new row (-1 dead)
    n = 0
    for s in segs:
        live = None if live_masks is None else live_masks.get(s.seg_id)
        keep = (np.ones(s.num_docs, dtype=bool) if live is None
                else np.array(live[: s.num_docs], dtype=bool, copy=True))
        rm = np.full(s.num_docs, -1, dtype=np.int64)
        rm[keep] = n + np.arange(int(keep.sum()))
        keeps.append(keep)
        row_maps.append(rm)
        n += int(keep.sum())
    cap = next_pow2(n, floor=BLOCK)

    ids: list[str] = []
    sources: list[bytes] = []
    versions = np.ones(n, dtype=np.int64)
    for s, keep, rm in zip(segs, keeps, row_maps):
        for d in np.nonzero(keep)[0]:
            d = int(d)
            ids.append(s.ids[d])
            sources.append(s.sources[d])
            versions[rm[d]] = int(s.versions[d])

    # -- text fields: CSR merge with preserved impacts --------------------
    text: dict[str, PostingsField] = {}
    for name in sorted({f for s in segs for f in s.text}):
        all_terms = sorted({t for s in segs for t in
                            (s.text[name].terms if name in s.text else ())})
        t_index = {t: i for i, t in enumerate(all_terms)}
        tid_parts, doc_parts, tf_parts, imp_parts = [], [], [], []
        pos_parts, plen_parts = [], []
        doc_len = np.zeros(cap, dtype=np.float32)
        have_positions = all(s.text[name].pos_data is not None
                             for s in segs if name in s.text)
        for s, keep, rm in zip(segs, keeps, row_maps):
            pf = s.text.get(name)
            if pf is None:
                continue
            kept_rows = np.nonzero(keep)[0]
            doc_len[rm[kept_rows]] += pf.doc_len[kept_rows]
            if len(pf.doc_ids) == 0:
                continue
            sel = keep[pf.doc_ids]
            if not sel.any():
                continue
            tids = np.repeat(np.arange(len(pf.terms), dtype=np.int64),
                             np.diff(pf.indptr))
            remap = np.asarray([t_index[t] for t in pf.terms],
                               dtype=np.int64)
            flat = extract_flat_impacts(pf)
            tid_parts.append(remap[tids[sel]])
            doc_parts.append(rm[pf.doc_ids[sel]])
            tf_parts.append(pf.tfs[sel])
            imp_parts.append(flat[sel])
            if pf.pos_data is not None:
                plen_parts.append(np.diff(pf.pos_indptr)[sel])
                pos_sel = np.repeat(sel, np.diff(pf.pos_indptr))
                pos_parts.append(pf.pos_data[pos_sel])
            else:
                plen_parts.append(np.zeros(int(sel.sum()), dtype=np.int64))
                pos_parts.append(np.empty(0, dtype=np.int32))
        if tid_parts:
            tid_all = np.concatenate(tid_parts)
            doc_all = np.concatenate(doc_parts)
            tf_all = np.concatenate(tf_parts)
            imp_all = np.concatenate(imp_parts)
            plen_all = np.concatenate(plen_parts)
            pos_all = (np.concatenate(pos_parts) if pos_parts
                       else np.empty(0, dtype=np.int32))
        else:
            tid_all = doc_all = np.empty(0, dtype=np.int64)
            tf_all = imp_all = np.empty(0, dtype=np.float32)
            plen_all = np.empty(0, dtype=np.int64)
            pos_all = np.empty(0, dtype=np.int32)
        # stable (term, new-doc) order: per-seg runs are doc-ascending and
        # the renumbering keeps order, so this is a fresh build's order
        order = np.lexsort((doc_all, tid_all))
        tid_all, doc_all = tid_all[order], doc_all[order]
        tf_all, imp_all = tf_all[order], imp_all[order]
        plen_all = plen_all[order]
        # positions follow their posting through the permutation
        pos_off = np.zeros(len(plen_all) + 1, dtype=np.int64)
        if len(plen_all):
            pre = np.concatenate(plen_parts)  # pre-permutation lengths
            starts = np.zeros(len(pre) + 1, dtype=np.int64)
            np.cumsum(pre, out=starts[1:])
            chunks = [pos_all[starts[j]: starts[j + 1]] for j in order]
            pos_all = (np.concatenate(chunks) if chunks
                       else np.empty(0, dtype=np.int32))
            np.cumsum(plen_all, out=pos_off[1:])
        T = len(all_terms)
        df = np.bincount(tid_all, minlength=T).astype(np.int32)
        indptr = np.zeros(T + 1, dtype=np.int64)
        np.cumsum(df, out=indptr[1:])
        doc_count = int(np.count_nonzero(doc_len[:n])) or n
        total_len = float(doc_len.sum())
        avg_len = (total_len / doc_count) if doc_count else 1.0
        pf_new = PostingsField(
            name=name, terms=all_terms, term_index=t_index, df=df,
            indptr=indptr, doc_ids=doc_all.astype(np.int32),
            tfs=tf_all.astype(np.float32), doc_len=doc_len,
            doc_count=doc_count, avg_len=max(avg_len, 1e-9),
            pos_data=(pos_all.astype(np.int32) if have_positions
                      else None),
            pos_indptr=(pos_off if have_positions else None))
        _pack_layout_host(pf_new, cap, imp_all.astype(np.float32))
        text[name] = pf_new

    # -- keyword columns ---------------------------------------------------
    keywords: dict[str, KeywordColumn] = {}
    for name in sorted({f for s in segs for f in s.keywords
                        if f not in s.text}):
        all_terms = sorted({t for s in segs
                            for t in (s.keywords[name].terms
                                      if name in s.keywords else ())})
        t_index = {t: i for i, t in enumerate(all_terms)}
        ords = np.full(cap, -1, dtype=np.int32)
        mv_width = 0
        per_seg_remap = []
        for s in segs:
            kc = s.keywords.get(name)
            per_seg_remap.append(
                None if kc is None else
                np.asarray([t_index[t] for t in kc.terms], dtype=np.int32))
            if kc is not None and kc.mv_ords is not None:
                mv_width = max(mv_width, kc.mv_ords.shape[1])
        mv = (np.full((cap, next_pow2(mv_width, floor=2)), -1,
                      dtype=np.int32) if mv_width else None)
        df = np.zeros(len(all_terms), dtype=np.int32)
        for s, keep, rm, remap in zip(segs, keeps, row_maps,
                                      per_seg_remap):
            kc = s.keywords.get(name)
            if kc is None or remap is None:
                continue
            rows = np.nonzero(keep)[0]
            loc = kc.ords[rows]
            has = loc >= 0
            ords[rm[rows[has]]] = remap[loc[has]]
            if kc.mv_ords is not None and mv is not None:
                lmv = kc.mv_ords[rows]
                hmv = lmv >= 0
                vals = np.where(hmv, remap[np.clip(lmv, 0, None)], -1)
                mv[rm[rows], : lmv.shape[1]] = vals
                for row_vals in vals:
                    df[np.unique(row_vals[row_vals >= 0])] += 1
            else:
                if mv is not None:
                    mv[rm[rows[has]], 0] = remap[loc[has]]
                u, c = np.unique(remap[loc[has]], return_counts=True)
                df[u] += c.astype(np.int32)
        keywords[name] = KeywordColumn(
            name=name, terms=all_terms, term_index=t_index, ords=ords,
            df=df, mv_ords=mv)

    # -- numeric columns ---------------------------------------------------
    numerics: dict[str, NumericColumn] = {}
    for name in sorted({f for s in segs for f in s.numerics}):
        kind = next(s.numerics[name].kind for s in segs
                    if name in s.numerics)
        is_int = all(s.numerics[name].raw.dtype == np.int64
                     for s in segs if name in s.numerics)
        dt = np.int64 if is_int else np.float64
        raw = np.zeros(cap, dtype=dt)
        exists = np.zeros(cap, dtype=bool)
        mv_width = max((s.numerics[name].mv_raw.shape[1]
                        for s in segs if name in s.numerics
                        and s.numerics[name].mv_raw is not None),
                       default=0)
        mv_raw = (np.zeros((cap, mv_width), dtype=dt) if mv_width else None)
        mv_exists = (np.zeros((cap, mv_width), dtype=bool)
                     if mv_width else None)
        bias = 1 << 31 if kind == IP else 0
        for s, keep, rm in zip(segs, keeps, row_maps):
            nc = s.numerics.get(name)
            if nc is None:
                continue
            rows = np.nonzero(keep)[0]
            raw[rm[rows]] = nc.raw[rows].astype(dt)
            exists[rm[rows]] = nc.exists[rows]
            if mv_raw is not None:
                if nc.mv_raw is not None:
                    w = nc.mv_raw.shape[1]
                    mv_raw[rm[rows], :w] = nc.mv_raw[rows].astype(dt)
                    mv_exists[rm[rows], :w] = nc.mv_exists[rows]
                else:
                    has = nc.exists[rows]
                    mv_raw[rm[rows[has]], 0] = nc.raw[rows[has]].astype(dt)
                    mv_exists[rm[rows[has]], 0] = True
        numerics[name] = NumericColumn(
            name=name, kind=kind,
            values=_device_vals(raw, kind, bias, is_int),
            exists=exists, raw=raw, bias=bias,
            mv_values=(None if mv_raw is None
                       else _device_vals(mv_raw, kind, bias, is_int)),
            mv_raw=mv_raw, mv_exists=mv_exists)

    # -- vector columns ----------------------------------------------------
    vectors: dict[str, VectorColumn] = {}
    for name in sorted({f for s in segs for f in s.vectors}):
        dims = next(s.vectors[name].dims for s in segs if name in s.vectors)
        vals = np.zeros((cap, dims), dtype=np.float32)
        exists = np.zeros(cap, dtype=bool)
        for s, keep, rm in zip(segs, keeps, row_maps):
            vc = s.vectors.get(name)
            if vc is None:
                continue
            rows = np.nonzero(keep)[0]
            vals[rm[rows]] = vc.values[rows]
            exists[rm[rows]] = vc.exists[rows]
        vectors[name] = vector_column(name, vals, exists)

    # the IVF index carries over where the merged column equals its one
    # source column row for row (a deletes-free fold of a single vector
    # segment); else the new base builds its own at its first search
    ann_carry: dict[str, object] = {}
    for name in vectors:
        srcs = [(s, keep, rm) for s, keep, rm
                in zip(segs, keeps, row_maps) if name in s.vectors]
        if len(srcs) != 1:
            continue
        s0, keep0, rm0 = srcs[0]
        src_ai = s0.ann.get(name)
        if src_ai is None or not bool(keep0.all()):
            continue
        if not np.array_equal(rm0, np.arange(s0.num_docs)):
            continue
        ann_carry[name] = src_ai

    return Segment(
        seg_id=seg_id, num_docs=n, capacity=cap,
        ids=ids, id_map={i: j for j, i in enumerate(ids)},
        sources=sources, versions=versions,
        text=text, keywords=keywords, numerics=numerics, vectors=vectors,
        ann=ann_carry, impacts_preserved=True)


def merge_segments(segments: Iterable[Segment], seg_id: str | None = None,
                   live_masks: dict[str, np.ndarray] | None = None,
                   similarity=None) -> Segment:
    """Merge segments into one, dropping deleted docs: a rebuild from
    the rows (each doc's tokens recovered from the positions sidecar),
    impacts recomputed under the merged field stats (ref: Lucene segment
    merging driven by TieredMergePolicy)."""
    from .mapping import ParsedField

    builder = SegmentBuilder(similarity=similarity)
    for seg in segments:
        live = None if live_masks is None else live_masks.get(seg.seg_id)
        # invert CSR once per text field: doc -> ordered token list
        doc_terms: dict[str, list[list[str]]] = {}
        for name, pf in seg.text.items():
            per_doc: list[list[str]] = [
                [None] * int(pf.doc_len[d]) for d in range(seg.num_docs)]
            for t_idx, term in enumerate(pf.terms):
                s, e = int(pf.indptr[t_idx]), int(pf.indptr[t_idx + 1])
                for j in range(s, e):
                    d = int(pf.doc_ids[j])
                    if pf.pos_data is not None:
                        ps, pe = (int(pf.pos_indptr[j]),
                                  int(pf.pos_indptr[j + 1]))
                        for p in pf.pos_data[ps:pe]:
                            per_doc[d][int(p)] = term
                    else:  # no positions: order unknown
                        slots = per_doc[d]
                        tf = int(pf.tfs[j])
                        placed = 0
                        for i, v in enumerate(slots):
                            if v is None and placed < tf:
                                slots[i] = term
                                placed += 1
            doc_terms[name] = per_doc

        def row_fields(d: int) -> list[ParsedField]:
            fields: list[ParsedField] = []
            for name in seg.text:
                toks = [t for t in doc_terms[name][d] if t is not None]
                if toks:
                    fields.append(ParsedField(name=name, type=TEXT,
                                              tokens=toks))
            for name, kc in seg.keywords.items():
                if name in seg.text:
                    continue
                if kc.mv_ords is not None:
                    for o in kc.mv_ords[d]:
                        if o >= 0:
                            fields.append(ParsedField(
                                name=name, type=KEYWORD,
                                value=kc.terms[int(o)]))
                elif kc.ords[d] >= 0:
                    fields.append(ParsedField(name=name, type=KEYWORD,
                                              value=kc.terms[kc.ords[d]]))
            for name, nc in seg.numerics.items():
                if not nc.exists[d]:
                    continue
                vals = (nc.mv_raw[d][nc.mv_exists[d]]
                        if nc.mv_raw is not None else [nc.raw[d]])
                for v in vals:
                    value = int(v) if nc.raw.dtype == np.int64 else float(v)
                    if nc.kind == BOOLEAN:
                        value = bool(v)
                    fields.append(ParsedField(name=name, type=nc.kind,
                                              value=value))
            for name, vc in seg.vectors.items():
                if vc.exists[d]:
                    fields.append(ParsedField(
                        name=name, type=DENSE_VECTOR,
                        value=[float(x) for x in vc.values[d]]))
            return fields

        for d in range(seg.num_docs):
            if live is not None and not live[d]:
                continue
            doc = ParsedDocument(doc_id=seg.ids[d], source=seg.sources[d],
                                 fields=row_fields(d))
            builder.add(doc, version=int(seg.versions[d]))
    return builder.build(seg_id)
