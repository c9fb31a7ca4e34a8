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
// one (query row, doc) and streams the doc's positions, from device
// memory (the walk: M = Gmem) or from a slab of docs staged in shared
// memory (the unfused entry: M = Smem, which also finds a term's slot
// and count through per-doc tables); the pack stores
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
// and a pass over each found slot's P int16 entries (in the walk the pack,
// cap * L * P * 2 bytes, and the tids are read once per row of a block,
// mostly from L1/L2; the unfused entry reads them once per launch).
// Integer compares and adds, not bytes, set the time.
//
// f32: every add and multiply is an explicit round-to-nearest intrinsic
// and every divide the correctly rounded div_rn, in positional_impacts' /
// bm25f_tile_scores' op order, so nvcc contracts nothing into an FMA (the
// build never passes --use_fast_math).

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

// Where the leaf reads a doc's columns: device memory through the
// read-only path (the bundle walk), or shared memory (the unfused entry,
// which stages a slab of docs with two tables per doc, built once for
// all rows: its slots by term hash, and each slot's valid-entry count).
// Every function below takes it as M.
struct Gmem {
  static constexpr bool kTables = false;
  template <class T>
  static __device__ __forceinline__ T ld(const T* p) {
    return __ldg(p);
  }
};
struct Smem {
  static constexpr bool kTables = true;
  template <class T>
  static __device__ __forceinline__ T ld(const T* p) {
    return *p;
  }
};

constexpr int kHashSlots = 32;  // a doc's slot table: by term & 31
constexpr unsigned short kHashMany = 0xffff;  // two slots share the hash

// one doc's columns in one field: its slot ids, its pack row, its norms;
// where M::kTables, its slot table (slot + 1 per hash, 0 none,
// kHashMany several) and its slots' valid-entry counts
struct DocRows {
  const int* trow;     // [L]
  const short* prow;   // [L * P]
  const float* k1ln;
  const float* lnorm;
  int L, P;
  const unsigned short* hrow;  // [kHashSlots]
  const unsigned char* tfrow;  // [L]
};

// A doc's rows in field fidx[fi] of pfs, in device memory.
struct GlobalDoc {
  const PosField* pfs;
  const int* fidx;
  size_t doc;
  __device__ __forceinline__ DocRows field(int fi) const {
    const PosField& f = pfs[fidx[fi]];
    return {f.tids + doc * f.L, f.pos + doc * static_cast<size_t>(f.L * f.P),
            f.k1ln + doc, f.lnorm + doc, f.L, f.P, nullptr, nullptr};
  }
};

// slot of term t in a doc's row, -1 when absent (t < 0 never matches)
template <class M>
__device__ __forceinline__ int find_slot(const int* trow, int L, int t) {
  if (t < 0) return -1;
  for (int l = 0; l < L; ++l)
    if (M::ld(trow + l) == t) return l;
  return -1;
}

template <class M>
__device__ __forceinline__ int count_valid(const short* p, int P) {
  int c = 0;
  for (int k = 0; k < P; ++k) c += M::ld(p + k) >= 0 ? 1 : 0;
  return c;
}

// find_slot of the doc's field rows, by its slot table where it has one
template <class M>
__device__ __forceinline__ int slot_of(const DocRows& f, int t) {
  if constexpr (M::kTables) {
    if (t < 0) return -1;
    const int e = f.hrow[t & (kHashSlots - 1)];
    if (e == 0) return -1;
    if (e != kHashMany) return f.trow[e - 1] == t ? e - 1 : -1;
  }
  return find_slot<M>(f.trow, f.L, t);
}

// count_valid of a slot's list, by the doc's table where it has one
template <class M>
__device__ __forceinline__ int tf_of(const DocRows& f, int slot) {
  if constexpr (M::kTables) return f.tfrow[slot];
  return count_valid<M>(f.prow + slot * f.P, f.P);
}

// Raw-index cursor over one slot's list in the doc's pack row prow: the
// list's offset o in prow (-1: the term is absent), entry k, and rv, the
// running sum of the list's valid deltas while entry k is a valid one,
// its complement (< 0) on a pad or past the list. The decoded value at k
// is rv, or kBig on a pad (val); three registers a cursor, which keeps
// the bundle walk's positional leaf inside its register budget.
struct Cur {
  int o, k, rv;
};

// (rv < 0 is above kBig as unsigned; positions stay below it)
__device__ __forceinline__ int val(const Cur& c) {
  return static_cast<int>(min(static_cast<unsigned>(c.rv),
                              static_cast<unsigned>(kBig)));
}

__device__ __forceinline__ int run(const Cur& c) {
  return c.rv ^ (c.rv >> 31);
}

template <class M>
__device__ __forceinline__ void cur_init(Cur& c, const short* prow, int o) {
  c.o = o;
  c.k = 0;
  c.rv = ~0;
  if (o >= 0) {
    const int d = M::ld(prow + o);
    if (d >= 0) c.rv = d;
  }
}

template <class M>
__device__ __forceinline__ void cur_next(Cur& c, const short* prow, int P) {
  ++c.k;
  const int r = run(c);
  c.rv = ~r;
  if (c.o >= 0 && c.k < P) {
    const int d = M::ld(prow + c.o + c.k);
    if (d >= 0) c.rv = r + d;
  }
}

// Valid-entry cursor: the next valid position, kBig once exhausted.
template <class M>
__device__ __forceinline__ void vcur_next(Cur& c, const short* prow, int P) {
  const int r = run(c);
  c.rv = ~r;
  if (c.o < 0) return;
  while (++c.k < P) {
    const int d = M::ld(prow + c.o + c.k);
    if (d >= 0) {
      c.rv = r + d;
      return;
    }
  }
}

template <class M>
__device__ __forceinline__ void vcur_init(Cur& c, const short* prow, int o,
                                          int P) {
  c.o = o;
  c.k = -1;
  c.rv = ~0;
  vcur_next<M>(c, prow, P);
}

// ops/scoring._phrase_freq_exact
template <class M>
__device__ __forceinline__ int phrase_exact(const short* prow,
                                            const int (&off)[kMaxTerms],
                                            const int (&tf)[kMaxTerms],
                                            int n, int P) {
  if (n == 1) return tf[0];
  Cur c[kMaxTerms];
#pragma unroll
  for (int i = 0; i < kMaxTerms; ++i)
    if (i < n) vcur_init<M>(c[i], prow, off[i], P);
  int freq = 0;
  while (val(c[0]) != kBig) {
    const int v0 = val(c[0]);
    bool alive = true;
#pragma unroll
    for (int i = 1; i < kMaxTerms; ++i) {
      if (i < n) {
        const int t = v0 + i;
        while (val(c[i]) < t) vcur_next<M>(c[i], prow, P);
        alive = alive && val(c[i]) == t;
      }
    }
    freq += alive ? 1 : 0;
    vcur_next<M>(c[0], prow, P);
  }
  return freq;
}

// ops/scoring._phrase_freq_sloppy (adjusted positions p_i - i; repeats
// must sit on distinct raw tokens) and _span_freq_unordered (window
// (min, max + 1), distinct windows), one pointer sweep
template <class M, bool kSpan>
__device__ __forceinline__ int sweep(const short* prow,
                                     const int (&off)[kMaxTerms],
                                     const int (&tf)[kMaxTerms], int n, int P,
                                     int slop) {
  if (kSpan && n == 1) return tf[0];
  Cur c[kMaxTerms];
#pragma unroll
  for (int i = 0; i < kMaxTerms; ++i)
    if (i < n) cur_init<M>(c[i], prow, off[i]);
  int freq = 0, last_lo = -1, last_hi = -1;
  for (;;) {
    bool active = true;
#pragma unroll
    for (int i = 0; i < kMaxTerms; ++i)
      if (i < n) active = active && c[i].k < tf[i];
    if (!active) break;
    int lo = val(c[0]), hi = val(c[0]), amin = 0;
#pragma unroll
    for (int i = 1; i < kMaxTerms; ++i) {
      if (i < n) {
        const int v = kSpan ? val(c[i]) : val(c[i]) - i;
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
          if (j < n) distinct = distinct && val(c[i]) != val(c[j]);
      if (hi - lo <= slop && distinct) ++freq;
    }
#pragma unroll
    for (int i = 0; i < kMaxTerms; ++i)
      if (i == amin) cur_next<M>(c[i], prow, P);
  }
  return freq;
}

// ops/scoring._span_freq_ordered: distinct (p0, pl) envelopes whose
// greedy minimal chain through the middle terms stays below pl
template <class M>
__device__ __forceinline__ int span_ordered(const short* prow,
                                            const int (&off)[kMaxTerms],
                                            const int (&tf)[kMaxTerms],
                                            int n, int P, int slop) {
  if (n == 1) return tf[0];
  Cur c[kMaxTerms];
#pragma unroll
  for (int i = 0; i < kMaxTerms; ++i)
    if (i < n) vcur_init<M>(c[i], prow, off[i], P);
  // two counters over the last term: entries <= the chain end x, and
  // entries <= start + slop + n - 1 (both bounds ascend with the start)
  int off_last = -1;  // off[n - 1], without indexing off at run time
#pragma unroll
  for (int i = 0; i < kMaxTerms; ++i)
    if (i == n - 1) off_last = off[i];
  Cur below_x, below_u;
  vcur_init<M>(below_x, prow, off_last, P);
  vcur_init<M>(below_u, prow, off_last, P);
  int n_x = 0, n_u = 0, freq = 0;
  while (val(c[0]) != kBig) {
    const int p0 = val(c[0]);
    int x = p0;
#pragma unroll
    for (int i = 1; i < kMaxTerms - 1; ++i) {
      if (i < n - 1) {
        const int t = x + 1;
        while (val(c[i]) < t && val(c[i]) != kBig)
          vcur_next<M>(c[i], prow, P);
        x = val(c[i]);
      }
    }
    const int u = p0 + slop + n - 1;
    while (val(below_x) <= x && val(below_x) != kBig) {
      vcur_next<M>(below_x, prow, P);
      ++n_x;
    }
    while (val(below_u) <= u && val(below_u) != kBig) {
      vcur_next<M>(below_u, prow, P);
      ++n_u;
    }
    freq += max(0, n_u - n_x);
    vcur_next<M>(c[0], prow, P);
  }
  return freq;
}

// a / b rounded to nearest f32, as __fdiv_rn gives it, for a finite and
// b positive, normal and finite (every divisor of the leaf: tf + k1ln,
// lnorm, k1 + acc), with no call: IEEE f32 division keeps its rare-case
// path in a subroutine, and the registers live across that call are
// spilled. The quotient is taken in f64 from the f32 reciprocal estimate
// (2^-22), two Newton steps (2^-44, then the f64 rounding) and one
// correction from the exact FMA remainder, within about 2^-52 of a / b;
// an f32 quotient of f32 operands is never within 2^-49 (relative) of a
// rounding midpoint without being exact, so the final f64 -> f32
// rounding is the correctly rounded quotient.
__device__ __forceinline__ float div_rn(float a, float b) {
  float r0;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r0) : "f"(b));
  const double ad = a, bd = b;
  double r = r0;
  r = __fma_rn(r, __fma_rn(-bd, r, 1.0), r);
  r = __fma_rn(r, __fma_rn(-bd, r, 1.0), r);
  double q = __dmul_rn(ad, r);
  q = __fma_rn(__fma_rn(-bd, q, ad), r, q);
  return __double2float_rn(q);
}

// ops/scoring.positional_impacts: (idf_sum * tf) * f32(k1 + 1), then
// / (tf + k1ln). At tf 0 the numerator is +-0, and +-0 over the positive
// divisor is that numerator: no division for the (many) docs without the
// phrase.
__device__ __forceinline__ float phrase_impact(int freq, float idf_sum,
                                               float k1ln) {
  const float tf = static_cast<float>(freq);
  const float num = __fmul_rn(__fmul_rn(idf_sum, tf), 2.2f);
  return freq == 0 ? num : div_rn(num, __fadd_rn(tf, k1ln));
}

// ops/scoring.bm25f_tile_scores: field then term, acc + (wf * tf) / lnorm,
// then total + (idf * acc) / (f32(k1) + acc); doc.field(fi) gives the
// doc's rows in the clause's field fi
template <class M, class Doc>
__device__ __forceinline__ float bm25f(const Doc& doc, int nf, int nt,
                                       const int* prm) {
  const int* qt = prm;
  const int* idf = prm + nf * nt;
  const int* wf = idf + nt;
  float total = 0.0f;
  for (int ti = 0; ti < nt; ++ti) {
    float acc = 0.0f;
    for (int fi = 0; fi < nf; ++fi) {
      const DocRows f = doc.field(fi);
      const int slot = slot_of<M>(f, qt[fi * nt + ti]);
      const int tf = slot < 0 ? 0 : tf_of<M>(f, slot);
      // a zero tf adds (wf * 0) / lnorm = +-0, which leaves acc as it is
      // (a sum from +0.0 is never -0.0): the term is skipped
      if (tf > 0)
        acc = __fadd_rn(acc, div_rn(__fmul_rn(__int_as_float(wf[fi]),
                                              static_cast<float>(tf)),
                                    M::ld(f.lnorm)));
    }
    // likewise a zero acc adds +-0 to total
    if (acc != 0.0f)
      total = __fadd_rn(total,
                        div_rn(__fmul_rn(__int_as_float(idf[ti]), acc),
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
// the term count (the field count for bm25f), prm the row's parameters,
// doc.field(fi) the doc's rows in the clause's field fi.
template <class M, class Doc>
__device__ __forceinline__ void leaf_doc(int kind, int n, int nt,
                                         const int* prm, const Doc& doc,
                                         float& s_leaf, bool& m_leaf) {
  const float pboost = __int_as_float(prm[param_tail(kind, n, nt)]);
  if (kind == kBm25f) {
    const float raw = bm25f<M>(doc, n, nt, prm);
    s_leaf = __fmul_rn(raw, pboost);
    m_leaf = raw > 0.0f;
    return;
  }
  const DocRows f = doc.field(0);
  const int L = f.L, P = f.P;
  const short* prow = f.prow;
  int off[kMaxTerms], tf[kMaxTerms];
#pragma unroll
  for (int i = 0; i < kMaxTerms; ++i) {
    off[i] = -1;
    tf[i] = 0;
    if (i < n) {
      const int slot = slot_of<M>(f, prm[i]);
      if (slot >= 0) {
        off[i] = slot * P;
        tf[i] = tf_of<M>(f, slot);
      }
    }
  }
  const int slop = prm[2 * n + 1];
  int freq;
  if (kind == kPhraseExact)
    freq = phrase_exact<M>(prow, off, tf, n, P);
  else if (kind == kPhraseSloppy)
    freq = sweep<M, false>(prow, off, tf, n, P, slop);
  else if (kind == kSpanOrdered)
    freq = span_ordered<M>(prow, off, tf, n, P, slop);
  else
    freq = sweep<M, true>(prow, off, tf, n, P, slop);
  const float raw =
      phrase_impact(freq, __int_as_float(prm[2 * n]), M::ld(f.k1ln));
  s_leaf = __fmul_rn(raw, pboost);
  m_leaf = freq > 0;
}

// leaf_doc for doc `doc` of the fields pfs[fidx[...]] in device memory
// (the bundle walk's leaf)
__device__ __forceinline__ void leaf(int kind, int n, int nt, const int* fidx,
                                     const int* prm, const PosField* pfs,
                                     size_t doc, float& s_leaf, bool& m_leaf) {
  leaf_doc<Gmem>(kind, n, nt, prm, GlobalDoc{pfs, fidx, doc}, s_leaf, m_leaf);
}

}  // namespace posleaf
