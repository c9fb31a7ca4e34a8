// Positional leaf of the fused bundle walk (phrase, span_near, BM25F),
// shared by K3's bundle kernel (bundle_topk.cu) and its unfused entry
// `positional_leaf`, which evaluates one clause over the whole capacity.
//
// Replaces: the positional branch of
//           elasticsearch_tpu/ops/pallas_scoring.py:_make_bundle_kernel
//           (:458-482), which calls ops/scoring.positional_tile_scores on
//           doc-major [tile, L] tids / [tile, L*P] position blocks. Its
//           plain version is elasticsearch_tpu_torch/ops/scoring
//           .positional_tile_scores, which these functions equal integer
//           for integer (frequencies) and bit for bit (f32 impacts).
//
// Design. The TPU leaf decodes [bt, tile, n, P] int32 position cubes and
// runs every algorithm as fixed-shape array programs. Here one thread owns
// one (query row, doc) and streams the doc's positions: the pack stores
// per slot a delta list (first entry absolute, then gaps, -1 pads), and
// each algorithm only ever moves a pointer forward by one entry, so a
// running sum of the deltas gives the next position with O(1) state per
// term (a `Cur`), all in registers (loops over the <= 8 terms unroll).
//   * exact phrase: for each start of term 0, term i's cursor advances to
//     the first position >= start + i (starts ascend, so cursors only
//     move forward);
//   * sloppy phrase / unordered span: the reference's pointer sweep, one
//     pointer advanced per iteration (the first one holding the minimum),
//     until some pointer reaches its term's tf;
//   * ordered span: the greedy minimal chain of each start through the
//     middle terms (monotone cursors) and the count of last-term positions
//     in (chain end, start + slop + n - 1] from two monotone counters;
//   * BM25F: the per-(field, term) tf is the slot's valid-entry count.
// The decode reproduces the reference's exactly, pads included: a pad
// entry decodes to kBig and leaves the running sum alone.
//
// What bounds it: per (row, doc) a scan of the doc's L slot ids per term
// and a pass over each found slot's P int16 entries; the pack (cap * L * P
// * 2 bytes) and the tids are read once per row of a block, mostly from
// L1/L2. Integer compares and adds, not bytes, set the time.
//
// f32: every add, multiply and divide is an explicit round-to-nearest
// intrinsic in positional_impacts' / bm25f_tile_scores' op order, so nvcc
// contracts nothing into an FMA (the build never passes --use_fast_math).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace posleaf {

constexpr int kMaxTerms = 8;    // cuda_scoring.POS_MAX_TERMS
constexpr int kMaxFields = 4;   // cuda_scoring.POS_MAX_FIELDS
constexpr int kBig = 1 << 30;   // ops/scoring._POS_BIG
// clause kinds of the descriptor table (0-2 are bundle_topk.cu's dense
// and range kinds)
constexpr int kPhraseExact = 3, kPhraseSloppy = 4, kSpanOrdered = 5,
              kSpanUnordered = 6, kBm25f = 7;

struct PosField {
  const int* tids;     // [cap, L] slot term ids, -1 pads
  const short* pos;    // [cap, L * P] per-slot delta lists, -1 pads
  const float* k1ln;   // [cap]
  const float* lnorm;  // [cap]
  int L, P;
};

// slot of term t in a doc's row, -1 when absent (t < 0 never matches)
__device__ __forceinline__ int find_slot(const int* trow, int L, int t) {
  if (t < 0) return -1;
  for (int l = 0; l < L; ++l)
    if (__ldg(trow + l) == t) return l;
  return -1;
}

__device__ __forceinline__ int count_valid(const short* p, int P) {
  int c = 0;
  for (int k = 0; k < P; ++k) c += __ldg(p + k) >= 0 ? 1 : 0;
  return c;
}

// Raw-index cursor: entry k of a slot's list, the running sum of its
// valid deltas, and the decoded value at k (kBig on a pad).
struct Cur {
  const short* p;
  int k, run, val;
};

__device__ __forceinline__ void cur_init(Cur& c, const short* p) {
  c.p = p;
  c.k = 0;
  c.run = 0;
  c.val = kBig;
  if (p) {
    const int d = __ldg(p);
    if (d >= 0) c.run = c.val = d;
  }
}

__device__ __forceinline__ void cur_next(Cur& c, int P) {
  ++c.k;
  c.val = kBig;
  if (c.p && c.k < P) {
    const int d = __ldg(c.p + c.k);
    if (d >= 0) {
      c.run += d;
      c.val = c.run;
    }
  }
}

// Valid-entry cursor: the next valid position, kBig once exhausted.
__device__ __forceinline__ void vcur_next(Cur& c, int P) {
  c.val = kBig;
  if (!c.p) return;
  while (++c.k < P) {
    const int d = __ldg(c.p + c.k);
    if (d >= 0) {
      c.run += d;
      c.val = c.run;
      return;
    }
  }
}

__device__ __forceinline__ void vcur_init(Cur& c, const short* p, int P) {
  c.p = p;
  c.k = -1;
  c.run = 0;
  vcur_next(c, P);
}

// ops/scoring._phrase_freq_exact
__device__ __forceinline__ int phrase_exact(const short* prow,
                                            const int (&off)[kMaxTerms],
                                            const int (&tf)[kMaxTerms],
                                            int n, int P) {
  if (n == 1) return tf[0];
  Cur c[kMaxTerms];
#pragma unroll
  for (int i = 0; i < kMaxTerms; ++i)
    if (i < n) vcur_init(c[i], off[i] >= 0 ? prow + off[i] : nullptr, P);
  int freq = 0;
  while (c[0].val != kBig) {
    const int v0 = c[0].val;
    bool alive = true;
#pragma unroll
    for (int i = 1; i < kMaxTerms; ++i) {
      if (i < n) {
        const int t = v0 + i;
        while (c[i].val < t) vcur_next(c[i], P);
        alive = alive && c[i].val == t;
      }
    }
    freq += alive ? 1 : 0;
    vcur_next(c[0], P);
  }
  return freq;
}

// ops/scoring._phrase_freq_sloppy (adjusted positions p_i - i; repeats
// must sit on distinct raw tokens) and _span_freq_unordered (window
// (min, max + 1), distinct windows), one pointer sweep
template <bool kSpan>
__device__ __forceinline__ int sweep(const short* prow,
                                     const int (&off)[kMaxTerms],
                                     const int (&tf)[kMaxTerms], int n, int P,
                                     int slop) {
  if (kSpan && n == 1) return tf[0];
  Cur c[kMaxTerms];
#pragma unroll
  for (int i = 0; i < kMaxTerms; ++i)
    if (i < n) cur_init(c[i], off[i] >= 0 ? prow + off[i] : nullptr);
  int freq = 0, last_lo = -1, last_hi = -1;
  for (;;) {
    bool active = true;
#pragma unroll
    for (int i = 0; i < kMaxTerms; ++i)
      if (i < n) active = active && c[i].k < tf[i];
    if (!active) break;
    int lo = c[0].val, hi = c[0].val, amin = 0;
#pragma unroll
    for (int i = 1; i < kMaxTerms; ++i) {
      if (i < n) {
        const int v = kSpan ? c[i].val : c[i].val - i;
        if (v < lo) {
          lo = v;
          amin = i;
        }
        hi = max(hi, v);
      }
    }
    if (kSpan) {
      hi += 1;
      if ((hi - lo) - n <= slop) {
        if (lo != last_lo || hi != last_hi) ++freq;
        last_lo = lo;
        last_hi = hi;
      }
    } else {
      bool distinct = true;
#pragma unroll
      for (int i = 0; i < kMaxTerms; ++i)
#pragma unroll
        for (int j = i + 1; j < kMaxTerms; ++j)
          if (j < n) distinct = distinct && c[i].val != c[j].val;
      if (hi - lo <= slop && distinct) ++freq;
    }
#pragma unroll
    for (int i = 0; i < kMaxTerms; ++i)
      if (i == amin) cur_next(c[i], P);
  }
  return freq;
}

// ops/scoring._span_freq_ordered: distinct (p0, pl) envelopes whose
// greedy minimal chain through the middle terms stays below pl
__device__ __forceinline__ int span_ordered(const short* prow,
                                            const int (&off)[kMaxTerms],
                                            const int (&tf)[kMaxTerms],
                                            int n, int P, int slop) {
  if (n == 1) return tf[0];
  Cur c[kMaxTerms];
#pragma unroll
  for (int i = 0; i < kMaxTerms; ++i)
    if (i < n) vcur_init(c[i], off[i] >= 0 ? prow + off[i] : nullptr, P);
  // two counters over the last term: entries <= the chain end x, and
  // entries <= start + slop + n - 1 (both bounds ascend with the start)
  const short* last = off[n - 1] >= 0 ? prow + off[n - 1] : nullptr;
  Cur below_x, below_u;
  vcur_init(below_x, last, P);
  vcur_init(below_u, last, P);
  int n_x = 0, n_u = 0, freq = 0;
  while (c[0].val != kBig) {
    const int p0 = c[0].val;
    int x = p0;
#pragma unroll
    for (int i = 1; i < kMaxTerms - 1; ++i) {
      if (i < n - 1) {
        const int t = x + 1;
        while (c[i].val < t && c[i].val != kBig) vcur_next(c[i], P);
        x = c[i].val;
      }
    }
    const int u = p0 + slop + n - 1;
    while (below_x.val <= x && below_x.val != kBig) {
      vcur_next(below_x, P);
      ++n_x;
    }
    while (below_u.val <= u && below_u.val != kBig) {
      vcur_next(below_u, P);
      ++n_u;
    }
    freq += max(0, n_u - n_x);
    vcur_next(c[0], P);
  }
  return freq;
}

// ops/scoring.positional_impacts: (idf_sum * tf) * f32(k1 + 1), then
// / (tf + k1ln)
__device__ __forceinline__ float phrase_impact(int freq, float idf_sum,
                                               float k1ln) {
  const float tf = static_cast<float>(freq);
  const float num = __fmul_rn(__fmul_rn(idf_sum, tf), 2.2f);
  return __fdiv_rn(num, __fadd_rn(tf, k1ln));
}

// ops/scoring.bm25f_tile_scores: field then term, acc + (wf * tf) / lnorm,
// then total + (idf * acc) / (f32(k1) + acc)
__device__ __forceinline__ float bm25f(const PosField* pfs, const int* fidx,
                                       int nf, int nt, const int* prm,
                                       size_t doc) {
  const int* qt = prm;
  const int* idf = prm + nf * nt;
  const int* wf = idf + nt;
  float total = 0.0f;
  for (int ti = 0; ti < nt; ++ti) {
    float acc = 0.0f;
    for (int fi = 0; fi < nf; ++fi) {
      const PosField& f = pfs[fidx[fi]];
      const int slot = find_slot(f.tids + doc * f.L, f.L, qt[fi * nt + ti]);
      const int tf =
          slot < 0 ? 0
                   : count_valid(f.pos + doc * static_cast<size_t>(f.L * f.P) +
                                     slot * f.P,
                                 f.P);
      acc = __fadd_rn(acc,
                      __fdiv_rn(__fmul_rn(__int_as_float(wf[fi]),
                                          static_cast<float>(tf)),
                                __ldg(f.lnorm + doc)));
    }
    total = __fadd_rn(total, __fdiv_rn(__fmul_rn(__int_as_float(idf[ti]), acc),
                                       __fadd_rn(1.2f, acc)));
  }
  return total;
}

// Offset of a clause's (pboost, msm_c, boost_c) triple in its parameter
// row: phrase / span (qt [n], wb [n], idf_sum, slop, pboost, msm_c,
// boost_c); bm25f (qt [nf * nt], idf [nt], wf [nf], pboost, msm_c,
// boost_c). f32 values travel as their bits.
__device__ __forceinline__ int param_tail(int kind, int n, int nt) {
  return kind == kBm25f ? n * nt + nt + n : 2 * n + 2;
}

// ops/scoring.positional_tile_scores for one (row, doc): s_leaf with the
// clause boost applied, m_leaf (freq > 0, or raw > 0 for bm25f). n is
// the term count (the field count for bm25f), fidx the clause's field
// indices into pfs, prm the row's parameters.
__device__ __forceinline__ void leaf(int kind, int n, int nt, const int* fidx,
                                     const int* prm, const PosField* pfs,
                                     size_t doc, float& s_leaf, bool& m_leaf) {
  const float pboost = __int_as_float(prm[param_tail(kind, n, nt)]);
  if (kind == kBm25f) {
    const float raw = bm25f(pfs, fidx, n, nt, prm, doc);
    s_leaf = __fmul_rn(raw, pboost);
    m_leaf = raw > 0.0f;
    return;
  }
  const PosField& f = pfs[fidx[0]];
  const int L = f.L, P = f.P;
  const int* trow = f.tids + doc * L;
  const short* prow = f.pos + doc * static_cast<size_t>(L * P);
  int off[kMaxTerms], tf[kMaxTerms];
#pragma unroll
  for (int i = 0; i < kMaxTerms; ++i) {
    off[i] = -1;
    tf[i] = 0;
    if (i < n) {
      const int slot = find_slot(trow, L, prm[i]);
      if (slot >= 0) {
        off[i] = slot * P;
        tf[i] = count_valid(prow + off[i], P);
      }
    }
  }
  const int slop = prm[2 * n + 1];
  int freq;
  if (kind == kPhraseExact)
    freq = phrase_exact(prow, off, tf, n, P);
  else if (kind == kPhraseSloppy)
    freq = sweep<false>(prow, off, tf, n, P, slop);
  else if (kind == kSpanOrdered)
    freq = span_ordered(prow, off, tf, n, P, slop);
  else
    freq = sweep<true>(prow, off, tf, n, P, slop);
  const float raw =
      phrase_impact(freq, __int_as_float(prm[2 * n]), __ldg(f.k1ln + doc));
  s_leaf = __fmul_rn(raw, pboost);
  m_leaf = freq > 0;
}

}  // namespace posleaf
