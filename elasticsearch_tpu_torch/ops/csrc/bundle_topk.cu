// Fused block-max bundle walk for Hopper (sm_90a).
//
// Replaces: elasticsearch_tpu/ops/pallas_scoring.py:_make_bundle_kernel
//           (launched by _bundle_chunk_call from fused_topk_bundle_pallas,
//           match_mask_bundle_pallas and fused_topk_dense_pallas), for
//           dense text clauses, numeric range masks and the positional
//           clauses (phrase, span_near, BM25F; the leaf is in
//           positional_leaf.cuh). A second entry, `positional_leaf`,
//           evaluates one positional clause over the whole capacity for
//           the unfused path (executor.eval_node).
//
// Per (batch tile of kBT query rows, doc tile of `tile` docs) it
// evaluates a bool clause bundle exactly as ops/scoring.bundle_tile_eval
// does and emits: the exact match count, a prune flag (2 = hard skip, no
// row of the batch tile can match; 1 = thresholded; 0 = selected), with
// ck > 0 the ck best (score, global doc id) with ties to the lower doc id
// (-inf / 0 past the matches), and with emit_match the tile's match mask.
// The per-tile can_match / bound inputs come from outside (the same
// ops/scoring.bundle_tile_bounds the plain walk reads), and the merge of
// the candidate strip is one top-k in torch, as in the reference.
//
// Grid. The TPU runs the doc-tile axis in order on one core and carries
// each row's running top-k threshold across it in scratch. Hopper runs
// blocks in parallel, so a block owns (kBT rows) x (a sub-chunk of
// consecutive doc tiles) and walks its sub-chunk in order, the threshold
// in shared memory. The chunk length comes from the wrapper
// (cuda_scoring.bundle_chunk_tiles): about 2048 blocks, i.e. at B = 256
// (32 batch tiles) and 1024 tiles, sub-chunks of 16 tiles. The
// threshold is raised only when ck == k (update_thr).
//
// Launch forms. One launch walks the tile span [t0, t0 + nt) (the whole
// grid, or one chunk of the stepped walk, pallas_scoring.py:848-890);
// its outputs land at their global tile columns (row stride n_tiles),
// so the chunks of a stepped walk fill one set of full-width buffers.
// Each block seeds its threshold from thr_in[row] (null: -inf, the
// single launch) and writes its final threshold to thr_out[row, sub];
// the wrapper folds thr_out with a row max into the thr_in of the next
// launch. A delta walk (streaming write path, pallas_scoring.py:825-832)
// seeds thr_in with the base walk's k-th best.
//
// Exactness (pallas_scoring.py:257-266). A tile is skipped only when
// every row's bound is <= its threshold, and every threshold a block
// holds is a k-th best witnessed by k candidates with LOWER doc ids than
// any tile it has yet to walk: its own earlier tiles, the sub-chunks of
// earlier launches (the row max over one launch's sub-chunks is still
// such a value: each sub-chunk precedes every tile of a later launch),
// or the base segment, whose ids sit below the delta's (offset cap_b)
// and whose candidates go first in the merge. A doc of a skipped tile
// scores <= the threshold and loses to those k candidates, ties
// included, so the hits equal one walk over all tiles bit for bit; only
// the prune flags (diagnostics) depend on the schedule.

// Clause bundle at run time. One compiled kernel serves every bundle: the
// wrapper passes a descriptor table (role, kind, field index, slot of the
// clause's per-row parameters, term / field counts and the positional
// fields), at most 8 clauses, and the kernel interprets it in a loop.
// Per-row parameters of the block's rows (qt/wq, msm_c/boost_c, range
// lo/hi, the positional clauses' parameter rows, msm, boost) are staged in
// shared memory. A positional clause reads, per field, the doc-major
// fwd_tids [cap, L], fwd_pos [cap, L*P] int16 and k1ln / lnorm [cap]; the
// rows of a block evaluate it one after another (a thread owns a doc),
// each row's leaf score parked in a per-thread shared slot. Rows past B
// read the wrapper's inert parameter rows (qt -1: zero frequency).
//
// Bit-exactness. Every add and multiply is an explicit round-to-nearest
// intrinsic in the plain walk's op order (hit += select per slot,
// s_leaf = s_leaf + hit * wq per term, s = where(m_leaf, s_leaf, 0) *
// boost_c, acc = acc + where(m, s, 0) per clause, acc * boost last), so
// nvcc contracts nothing into an FMA. Padded query terms (-1, weight 0)
// that equal padded slot ids add an exact +0.0.
//
// What bounds it on this card. It reads the forward rows of every tile
// that is not hard-skipped once per batch tile (cap * L * 8 bytes per
// batch tile, mostly from L2) and writes small candidate strips (plus the
// B * cap mask bytes in emit-match mode); the work is the compare/select/
// add per (row, doc, term, slot), as for K1, plus ck warp-argmax passes
// per selected (row, tile). At the main path's shapes the operations
// bound it, as for K1. The design keeps that work lean:
//   * a thread owns docs of the tile, a block owns kBT = 8 rows, and each
//     slot pair is loaded once per (doc, term) (16-byte loads when L is a
//     multiple of 4) and compared against all 8 rows' terms in registers;
//   * candidates (-inf where not matching) sit in shared memory; warp w
//     selects row w: each lane keeps its best (value, lowest index), and
//     each of the ck passes is one 5-step shuffle argmax plus a rescan by
//     the one lane whose element was taken, so no block barrier per pass.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "positional_leaf.cuh"

struct BundleArgs {
  const int* tids[8];
  const float* imps[8];
  int L[8];
  const void* vals[8];
  const unsigned char* exists[8];
  posleaf::PosField pfields[8];
  const unsigned char* live;
  // role, kind, field index, parameter slot (positional: offset in the
  // parameter row), n (terms; bm25f fields), nt (bm25f terms), and the
  // positional field indices (pfields) of the clause's fields
  int clause[8][10];
  int n_clauses;
  const int* qt;        // [B, n_dense * qm]
  const float* wq;      // [B, n_dense * qm]
  const int* msmc;      // [B, n_dense]
  const float* boostc;  // [B, n_dense]
  const int* msm;       // [B]
  const float* boost;   // [B]
  const int* lo;        // [B, n_range], int32 or float32 bits
  const int* hi;
  const int* pp;        // [ceil(B / 8) * 8, pw] positional parameter rows
  int pw;
  const unsigned char* can;  // [B, n_tiles]
  const float* ub;           // [B, n_tiles]
  float* cs;                 // [B, n_tiles * ck]
  int* ci;
  int* cnt;                  // [B, n_tiles]
  int* flags;
  unsigned char* match;      // [B, cap]
  int B, cap, tile, n_tiles, qm, n_dense, n_range, ck, update_thr,
      chunk_tiles, emit_match;
  const float* thr_in;  // [B] seed threshold; null = -inf
  float* thr_out;       // [B, n_sub] final threshold per sub-chunk, or null
  int t0, nt;           // the launch walks tiles [t0, t0 + nt)
};

// The unfused path's positional clause over the whole capacity (entry
// `positional_leaf`): one thread per (row, doc), the same leaf as the
// walk. Writes s_leaf (clause boost applied) and m_leaf; eval_node masks
// the score with m_leaf.
struct PosLeafArgs {
  posleaf::PosField pfields[posleaf::kMaxFields];
  int fidx[posleaf::kMaxFields];
  int kind, n, nt;
  const int* pp;  // [B, pw] parameter rows
  int pw;
  float* s_out;            // [B, cap]
  unsigned char* m_out;    // [B, cap]
  int B, cap;
};

namespace {

constexpr int kBT = 8;            // query rows per block
constexpr int kThreads = 256;     // 8 warps: one per row in selection
constexpr int kMaxClauses = 8;
constexpr int kMaxQ = 8;
constexpr int kMaxPW = 512;       // positional parameter ints per row
constexpr int kMust = 0, kFilter = 1, kMustNot = 2;  // else should (3)
constexpr int kDense = 0, kRangeInt = 1;

__device__ __forceinline__ float sel(bool m, float v) { return m ? v : 0.0f; }

__device__ __forceinline__ void lane_best(const float* row, int tile, int lane,
                                          float& best, int& bidx) {
  best = -INFINITY;
  bidx = 0x7fffffff;
  for (int d = lane; d < tile; d += 32) {
    const float v = row[d];
    if (v > best) {
      best = v;
      bidx = d;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bundle_topk_kernel(const __grid_constant__ BundleArgs a) {
  extern __shared__ float s_cand[];  // [kBT][tile]
  __shared__ int s_pp[kBT][kMaxPW];
  __shared__ float s_ps[kBT][kThreads];  // a thread's positional leaf scores
  __shared__ int s_qt[kBT][kMaxClauses * kMaxQ];
  __shared__ float s_wq[kBT][kMaxClauses * kMaxQ];
  __shared__ int s_msmc[kBT][kMaxClauses];
  __shared__ float s_boostc[kBT][kMaxClauses];
  __shared__ int s_lo[kBT][kMaxClauses];
  __shared__ int s_hi[kBT][kMaxClauses];
  __shared__ int s_msm[kBT];
  __shared__ float s_boost[kBT];
  __shared__ float s_thr[kBT];
  __shared__ int s_cnt[kBT];
  __shared__ int s_can[kBT];
  __shared__ int s_top[kBT];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.y * kBT;
  const int n_rows = min(kBT, a.B - row0);
  const int t_begin = a.t0 + blockIdx.x * a.chunk_tiles;
  const int t_end = min(a.t0 + a.nt, t_begin + a.chunk_tiles);
  const int tile = a.tile;
  const int qm = a.qm;
  const int qw = a.n_dense * qm;
  const size_t cap = static_cast<size_t>(a.cap);
  const size_t nt = static_cast<size_t>(a.n_tiles);
  const size_t strip = nt * static_cast<size_t>(a.ck);

  // rows past B compute as copies of the last row; they never vote or
  // write
  for (int i = tid; i < kBT * qw; i += kThreads) {
    const int r = i / qw, c = i - r * qw;
    const size_t b = row0 + min(r, n_rows - 1);
    s_qt[r][c] = a.qt[b * qw + c];
    s_wq[r][c] = a.wq[b * qw + c];
  }
  for (int i = tid; i < kBT * a.n_dense; i += kThreads) {
    const int r = i / a.n_dense, c = i - r * a.n_dense;
    const size_t b = row0 + min(r, n_rows - 1);
    s_msmc[r][c] = a.msmc[b * a.n_dense + c];
    s_boostc[r][c] = a.boostc[b * a.n_dense + c];
  }
  for (int i = tid; i < kBT * a.n_range; i += kThreads) {
    const int r = i / a.n_range, c = i - r * a.n_range;
    const size_t b = row0 + min(r, n_rows - 1);
    s_lo[r][c] = a.lo[b * a.n_range + c];
    s_hi[r][c] = a.hi[b * a.n_range + c];
  }
  for (int i = tid; i < kBT * a.pw; i += kThreads) {
    const int r = i / a.pw, c = i - r * a.pw;
    s_pp[r][c] = a.pp[static_cast<size_t>(row0 + r) * a.pw + c];
  }
  if (tid < kBT) {
    const int b = row0 + min(tid, n_rows - 1);
    s_msm[tid] = a.msm[b];
    s_boost[tid] = a.boost[b];
    s_thr[tid] = a.thr_in != nullptr ? a.thr_in[b] : -INFINITY;
  }

  for (int j = t_begin; j < t_end; ++j) {
    const size_t doc0 = static_cast<size_t>(j) * tile;
    if (tid < kBT) {
      s_can[tid] = (tid < n_rows) ? (a.can[(row0 + tid) * nt + j] != 0) : 0;
      s_cnt[tid] = 0;
    }
    __syncthreads();
    int any_hit = 0;
#pragma unroll
    for (int r = 0; r < kBT; ++r) any_hit |= s_can[r];

    if (!any_hit) {
      // no row can match here: nothing to score or count, mask rows 0
      for (int i = tid; i < n_rows * a.ck; i += kThreads) {
        const int r = i / a.ck, s = i - r * a.ck;
        const size_t o = (row0 + r) * strip + static_cast<size_t>(j) * a.ck + s;
        a.cs[o] = -INFINITY;
        a.ci[o] = 0;
      }
      if (tid < n_rows) {
        a.cnt[(row0 + tid) * nt + j] = 0;
        a.flags[(row0 + tid) * nt + j] = 2;
      }
      if (a.emit_match) {
        for (int i = tid; i < n_rows * tile; i += kThreads) {
          const int r = i / tile, d = i - r * tile;
          a.match[(row0 + r) * cap + doc0 + d] = 0;
        }
      }
      __syncthreads();
      continue;
    }

    int lcnt[kBT];
#pragma unroll
    for (int r = 0; r < kBT; ++r) lcnt[r] = 0;
    for (int d = tid; d < tile; d += kThreads) {
      const size_t doc = doc0 + d;
      float acc[kBT];
      int scnt[kBT];
      unsigned must_ok = (1u << kBT) - 1u, not_any = 0u;
#pragma unroll
      for (int r = 0; r < kBT; ++r) {
        acc[r] = 0.0f;
        scnt[r] = 0;
      }
      for (int c = 0; c < a.n_clauses; ++c) {
        const int role = a.clause[c][0];
        const int kind = a.clause[c][1];
        const int f = a.clause[c][2];
        const int slot = a.clause[c][3];
        unsigned m = 0u;
        float s[kBT];
        if (kind == kDense) {
          const int L = a.L[f];
          const int* tp = a.tids[f] + doc * L;
          const float* vp = a.imps[f] + doc * L;
          const bool vec4 =
              (L & 3) == 0 &&
              ((reinterpret_cast<uintptr_t>(a.tids[f]) |
                reinterpret_cast<uintptr_t>(a.imps[f])) & 15u) == 0;
          float s_leaf[kBT];
#pragma unroll
          for (int r = 0; r < kBT; ++r) s_leaf[r] = 0.0f;
          for (int q = 0; q < qm; ++q) {
            int tq[kBT];
            float hit[kBT];
#pragma unroll
            for (int r = 0; r < kBT; ++r) {
              tq[r] = s_qt[r][slot * qm + q];
              hit[r] = 0.0f;
            }
            if (vec4) {
              for (int l = 0; l < L; l += 4) {
                const int4 t4 = __ldg(reinterpret_cast<const int4*>(tp + l));
                const float4 v4 = __ldg(reinterpret_cast<const float4*>(vp + l));
#pragma unroll
                for (int r = 0; r < kBT; ++r) {
                  hit[r] = __fadd_rn(hit[r], sel(t4.x == tq[r], v4.x));
                  hit[r] = __fadd_rn(hit[r], sel(t4.y == tq[r], v4.y));
                  hit[r] = __fadd_rn(hit[r], sel(t4.z == tq[r], v4.z));
                  hit[r] = __fadd_rn(hit[r], sel(t4.w == tq[r], v4.w));
                }
              }
            } else {
              for (int l = 0; l < L; ++l) {
                const int t = __ldg(tp + l);
                const float v = __ldg(vp + l);
#pragma unroll
                for (int r = 0; r < kBT; ++r)
                  hit[r] = __fadd_rn(hit[r], sel(t == tq[r], v));
              }
            }
#pragma unroll
            for (int r = 0; r < kBT; ++r)
              s_leaf[r] = __fadd_rn(s_leaf[r],
                                    __fmul_rn(hit[r], s_wq[r][slot * qm + q]));
          }
#pragma unroll
          for (int r = 0; r < kBT; ++r) {
            const bool m_leaf = s_leaf[r] > 0.0f;
            const int mc = s_msmc[r][slot];
            if ((m_leaf || mc <= 0) && mc <= 1) m |= 1u << r;
            s[r] = __fmul_rn(sel(m_leaf, s_leaf[r]), s_boostc[r][slot]);
          }
        } else if (kind >= posleaf::kPhraseExact) {
          const int n = a.clause[c][4], nt = a.clause[c][5];
          const int tail = slot + posleaf::param_tail(kind, n, nt);
#pragma unroll 1
          for (int r = 0; r < kBT; ++r) {
            // a row that cannot match in this tile matches no doc of it
            // (its can_match is exact), so its leaf is never read
            if (!s_can[r]) {
              s_ps[r][tid] = 0.0f;
              continue;
            }
            float sl;
            bool ml;
            posleaf::leaf(kind, n, nt, &a.clause[c][6], &s_pp[r][slot],
                          a.pfields, doc, sl, ml);
            // single-should wrapper semantics, as for dense clauses
            const int mc = s_pp[r][tail + 1];
            if ((ml || mc <= 0) && mc <= 1) m |= 1u << r;
            s_ps[r][tid] = __fmul_rn(sel(ml, sl),
                                     __int_as_float(s_pp[r][tail + 2]));
          }
#pragma unroll
          for (int r = 0; r < kBT; ++r) s[r] = s_ps[r][tid];
        } else {
          const bool ex = a.exists[f][doc] != 0;
          if (kind == kRangeInt) {
            const int v = static_cast<const int*>(a.vals[f])[doc];
#pragma unroll
            for (int r = 0; r < kBT; ++r)
              if (ex && v >= s_lo[r][slot] && v <= s_hi[r][slot]) m |= 1u << r;
          } else {
            const float v = static_cast<const float*>(a.vals[f])[doc];
#pragma unroll
            for (int r = 0; r < kBT; ++r)
              if (ex && v >= __int_as_float(s_lo[r][slot]) &&
                  v <= __int_as_float(s_hi[r][slot]))
                m |= 1u << r;
          }
        }
        const bool scoring = kind == kDense || kind >= posleaf::kPhraseExact;
        if (role == kMust) {
          if (scoring) {
#pragma unroll
            for (int r = 0; r < kBT; ++r)
              acc[r] = __fadd_rn(acc[r], sel((m >> r) & 1u, s[r]));
          }
          must_ok &= m;
        } else if (role == kFilter) {
          must_ok &= m;
        } else if (role == kMustNot) {
          not_any |= m;
        } else {  // should
#pragma unroll
          for (int r = 0; r < kBT; ++r) {
            if (scoring)
              acc[r] = __fadd_rn(acc[r], sel((m >> r) & 1u, s[r]));
            scnt[r] += (m >> r) & 1u;
          }
        }
      }
      const bool live = a.live[doc] != 0;
#pragma unroll
      for (int r = 0; r < kBT; ++r) {
        const bool mt = ((must_ok >> r) & 1u) && !((not_any >> r) & 1u) &&
                        scnt[r] >= s_msm[r] && live;
        s_cand[r * tile + d] = mt ? __fmul_rn(acc[r], s_boost[r]) : -INFINITY;
        lcnt[r] += mt ? 1 : 0;
        if (a.emit_match && r < n_rows)
          a.match[(row0 + r) * cap + doc] = mt ? 1 : 0;
      }
    }
#pragma unroll
    for (int r = 0; r < kBT; ++r) {
      const int v = __reduce_add_sync(0xffffffffu, lcnt[r]);
      if (lane == 0 && v) atomicAdd(&s_cnt[r], v);
    }
    __syncthreads();
    if (tid < n_rows) a.cnt[(row0 + tid) * nt + j] = s_cnt[tid];

    if (a.ck == 0) {
      // mask-only grid: the count and the mask are the result
      if (tid < n_rows) a.flags[(row0 + tid) * nt + j] = 0;
      __syncthreads();
      continue;
    }
    if (tid < kBT)
      s_top[tid] = s_can[tid] && a.ub[(row0 + tid) * nt + j] > s_thr[tid];
    __syncthreads();
    int any_top = 0;
#pragma unroll
    for (int r = 0; r < kBT; ++r) any_top |= s_top[r];

    if (!any_top) {
      // counted exactly above; no candidate can improve any row's top-k
      for (int i = tid; i < n_rows * a.ck; i += kThreads) {
        const int r = i / a.ck, s = i - r * a.ck;
        const size_t o = (row0 + r) * strip + static_cast<size_t>(j) * a.ck + s;
        a.cs[o] = -INFINITY;
        a.ci[o] = 0;
      }
      if (tid < n_rows) a.flags[(row0 + tid) * nt + j] = 1;
    } else if (warp < n_rows) {
      // ck passes of (max, lowest index among the maxima, take it)
      const int r = warp;
      float* row = s_cand + r * tile;
      float* cs = a.cs + (row0 + r) * strip + static_cast<size_t>(j) * a.ck;
      int* ci = a.ci + (row0 + r) * strip + static_cast<size_t>(j) * a.ck;
      float best;
      int bidx;
      lane_best(row, tile, lane, best, bidx);
      float last = -INFINITY;
      int s = 0;
      for (; s < a.ck; ++s) {
        float v = best;
        int ix = bidx;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, v, off);
          const int oi = __shfl_xor_sync(0xffffffffu, ix, off);
          if (ov > v || (ov == v && oi < ix)) {
            v = ov;
            ix = oi;
          }
        }
        if (v == -INFINITY) break;
        if (lane == 0) {
          cs[s] = v;
          ci[s] = ix + static_cast<int>(doc0);
        }
        last = v;
        if ((ix & 31) == lane) {
          row[ix] = -INFINITY;
          lane_best(row, tile, lane, best, bidx);
        }
        __syncwarp();
      }
      if (s < a.ck) last = -INFINITY;
      for (int t = s + lane; t < a.ck; t += 32) {
        cs[t] = -INFINITY;
        ci[t] = 0;
      }
      if (lane == 0) {
        if (a.update_thr) s_thr[r] = fmaxf(s_thr[r], last);
        a.flags[(row0 + r) * nt + j] = 0;
      }
    }
    __syncthreads();
  }
  __syncthreads();
  if (a.thr_out != nullptr && tid < n_rows)
    a.thr_out[static_cast<size_t>(row0 + tid) * gridDim.x + blockIdx.x] =
        s_thr[tid];
}

// one thread per (row, doc) of the unfused leaf (struct PosLeafArgs)
__global__ void __launch_bounds__(kThreads)
positional_leaf_kernel(const __grid_constant__ PosLeafArgs a) {
  const int b = blockIdx.y;
  const size_t doc = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (doc >= static_cast<size_t>(a.cap)) return;
  float s;
  bool m;
  posleaf::leaf(a.kind, a.n, a.nt, a.fidx, a.pp + static_cast<size_t>(b) * a.pw,
                a.pfields, doc, s, m);
  const size_t o = static_cast<size_t>(b) * a.cap + doc;
  a.s_out[o] = s;
  a.m_out[o] = m ? 1 : 0;
}

}  // namespace

extern "C" int positional_leaf(const PosLeafArgs* args, void* stream) {
  const PosLeafArgs a = *args;
  if (a.B <= 0 || a.cap <= 0) return 0;
  if (a.B > 65535 || a.kind < posleaf::kPhraseExact ||
      a.kind > posleaf::kBm25f || a.n < 1 || a.n > posleaf::kMaxTerms ||
      (a.kind == posleaf::kBm25f &&
       (a.n > posleaf::kMaxFields || a.nt < 1 || a.nt > posleaf::kMaxTerms)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.cap + kThreads - 1) / kThreads, a.B);
  positional_leaf_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bundle_topk(const BundleArgs* args, void* stream) {
  const BundleArgs a = *args;
  if (a.B <= 0 || a.n_tiles <= 0 || a.nt <= 0) return 0;
  if (a.n_clauses > kMaxClauses || a.qm > kMaxQ || a.n_dense > kMaxClauses ||
      a.n_range > kMaxClauses || a.tile > 1024 || a.chunk_tiles <= 0 ||
      a.pw < 0 || a.pw > kMaxPW || a.t0 < 0 || a.t0 + a.nt > a.n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kBT) * a.tile * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bundle_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.nt + a.chunk_tiles - 1) / a.chunk_tiles,
                  (a.B + kBT - 1) / kBT);
  bundle_topk_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
