// Fused block-max bundle walk for Hopper (sm_90a).
//
// Replaces: elasticsearch_tpu/ops/pallas_scoring.py:_make_bundle_kernel
//           (launched by _bundle_chunk_call from fused_topk_bundle_pallas,
//           match_mask_bundle_pallas and fused_topk_dense_pallas), for
//           dense text clauses, numeric range masks, the positional
//           clauses (phrase, span_near, BM25F; the leaf is in
//           positional_leaf.cuh) and vector similarity clauses
//           (`knn_vec`, below). A second entry, `positional_leaf`,
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
// Work items. The TPU runs the doc-tile axis in order on one core and
// carries each row's running top-k threshold across it in scratch. Here a
// work item is (kBT rows) x (a sub-chunk of `chunk_tiles` consecutive doc
// tiles, cuda_scoring.bundle_chunk_tiles) and walks its tiles in order,
// the threshold in shared memory; items run in any order, one CTA each,
// sub-chunk-major, so the CTAs in flight share doc tiles in L2. The
// threshold is raised only when ck == k (update_thr).
//
// Launch forms. One launch walks the tile span [t0, t0 + nt) (the whole
// grid, or one chunk of the stepped walk, pallas_scoring.py:848-890);
// its outputs land at their global tile columns (row stride n_tiles),
// so the chunks of a stepped walk fill one set of full-width buffers.
// Each item seeds its threshold from thr_in[row] (null: -inf, the single
// launch) and writes its final threshold to thr_out[row, sub]; the
// wrapper folds thr_out with a row max into the thr_in of the next
// launch. A delta walk (streaming write path, pallas_scoring.py:825-832)
// seeds thr_in with the base walk's k-th best.
//
// Exactness (pallas_scoring.py:257-266). A tile is skipped only when
// every row's bound is <= its threshold, and every threshold an item
// holds is a k-th best witnessed by k candidates with LOWER doc ids than
// any tile it has yet to walk: its own earlier tiles, the sub-chunks of
// earlier launches (the row max over one launch's sub-chunks is still
// such a value: each sub-chunk precedes every tile of a later launch),
// or the base segment, whose ids sit below the delta's (offset cap_b)
// and whose candidates go first in the merge. A doc of a skipped tile
// scores <= the threshold and loses to those k candidates, ties
// included, so the hits equal one walk over all tiles bit for bit; only
// the prune flags (diagnostics) depend on the schedule.
//
// Clause bundle at run time. One compiled kernel serves every bundle: the
// wrapper passes a descriptor table (role, kind, field index, slot of the
// clause's per-row parameters, term / field counts and the positional
// fields), at most 8 clauses, and the kernel interprets it in a loop.
// Per-row parameters of the item's rows (qt/wq, msm_c/boost_c, range
// lo/hi, the positional clauses' parameter rows, msm, boost) are staged in
// shared memory. A positional clause reads, per field, the doc-major
// fwd_tids [cap, L], fwd_pos [cap, L*P] int16 and k1ln / lnorm [cap]; the
// rows of an item evaluate it one after another (a thread owns a doc),
// each row's leaf score parked in a per-thread shared slot. Rows past B
// read the wrapper's inert parameter rows (qt -1: zero frequency).
//
// Bit-exactness. Every add and multiply is an explicit round-to-nearest
// intrinsic in the plain walk's op order (hit += select per slot, as a
// predicated add: the select's +0.0 leaves hit as it is,
// s_leaf = s_leaf + hit * wq per term, s = where(m_leaf, s_leaf, 0) *
// boost_c, acc = acc + where(m, s, 0) per clause, acc * boost last), so
// nvcc contracts nothing into an FMA. Padded query terms (-1, weight 0)
// that equal padded slot ids add an exact +0.0. Selection orders by the
// composite key of ops/topk (the order-preserving image of the score,
// then the lower doc), so -0.0 sorts below +0.0 as in the plain walk.
//
// What bounds it on this card. The work is compares, selects and f32
// adds in a fixed order per (row, doc, term, slot), plus the selection of
// ck candidates per selected (row, tile); there is no product of dense
// matrices, so tensor cores do not apply, and at the main path's shapes
// the operations, not the bytes, bound it (chip_smoke.bundle_bound). It
// reads each forward row once per batch tile, mostly from L2, and is
// bound in practice by latency and the instruction rate at 16 warps an
// SM. The design, step by step (each measured by `chip_smoke.py
// --ab-parent` against the kernel it replaced, in turns; numbers in
// PERF.md, Findings):
//   1. Selection without rescans. Scoring stores only the matching docs'
//      scores and, per (row, 32-doc chunk), one word of match bits (a
//      ballot), so a tile's count is a popcount and a row's selection
//      reads its matches alone (lane l takes chunk l). Each lane keeps its
//      kHeads best (order key, doc) sorted in registers; a pass of the ck
//      is one warp-wide max (__reduce_max_sync; a min over the docs only
//      on equal scores) and a register shift in the winning lane, which
//      re-reads its own matches only when its heads run dry. A row with
//      no match writes its -inf strip at once. (The kernel before: ck
//      passes, each a 5-step shuffle argmax plus a 32-element rescan.)
//   2. Scoring overlapped with selection, without warp roles: candidates
//      of consecutive active tiles alternate between two shared buffers,
//      and one barrier per active tile separates "tile i scored" from
//      "tile i selected"; warp r then selects row r of tile i and goes on
//      to score tile i + 1. With ck > 32, whose long selections would
//      leave warps idle, and in a positional bundle, whose docs cost
//      unevenly, the warps take 32-doc chunks from a shared counter, so
//      the ones done first score more. Thresholds are
//      double buffered per row, so the batch tile's vote reads settled
//      values. Tiles no row can match are listed out at the item's start
//      and written there in bulk (count 0, flag 2, -inf strip, zero mask).
//   3. Dense rows in registers, predicated adds: a dense clause loads a
//      doc's (at most kSlots) slot ids and impacts once, as 16-byte loads
//      when L is a multiple of 4, and compares every query term against
//      them one row at a time; hit += select(...) is a compare and a
//      predicated add (add_hit), and the rows' parameters come in 8-byte
//      pairs. Staging doc slabs through TMA into a shared ring (with
//      cluster multicast) is not built: with its forward rows drawn from
//      one 1,024-doc window, which stays on chip, the dense walk runs no
//      faster, so those loads are not what it waits on; served so, the
//      positional leaf gains some (tools/k3_variants.py; PERF.md,
//      Findings).
//   4. Registers and shared memory. The kernel is built twice: without a
//      positional clause (the leaf compiled out) and with one; both fit
//      __launch_bounds__(256, 2), at most 128 registers, with no spill
//      (the leaf runs first for the doc with little else live, its
//      cursors take three registers, its divisions are a correctly
//      rounded f64 path with no slow-path call). Shared memory is sized
//      per launch (bundle_smem): a positional bundle has one candidate
//      buffer, not two, leaving L1 to the leaf's rereads.
//   5. Sub-chunks of 8 tiles (shorter where a launch would have too few
//      items; cuda_scoring.bundle_chunk_tiles), chosen by measurement.
//      A persistent grid (one or two CTAs an SM taking items from an
//      atomic counter) was built and measured 0-2% slower than one CTA
//      per item, whose scheduling the hardware does for free: not kept.
//   6. Vector clauses (kVec, the hybrid BM25+kNN bundle). The
//      reference's Pallas kernel has no such clause: its XLA engine slices
//      a precomputed similarity column per tile (ops/scoring.py:872-875).
//      Here the clause reads that column, f32 [B, cap] with the clause
//      boost folded in (a cuBLAS product plus elementwise transforms,
//      search/executor._vec_clause_inputs), at (row, doc), and the
//      field's exists mask at doc: its match is exists, and a must /
//      should clause adds sel(exists, col) in clause order, the plain
//      walk's score + where(m, s, 0). A warp's 32 lanes read 32
//      consecutive docs of one row: one 128-byte line per (row, chunk).
//      The column is read once per (row, tile) the walk does not skip;
//      its bytes, B * cap * 4, add to the walk's bound. Scores and
//      bounds may be negative (dot_product): thresholds start at -inf
//      and candidates are ordered by the order-preserving key, so
//      nothing here assumes a sign.
// tools/k3_variants.py times steps 2, 3 and 5 undone, each in a patched
// copy of the port's ops.

#include <algorithm>

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
  // set by the entry on its copy of the arguments: positional clauses,
  // sub-chunks of the span
  int n_pos, n_sub;
  // vector clauses, by the clause's slot: the similarity column [B, cap]
  // (boost folded in) and the field's exists mask [cap]
  const float* vcol[8];
  const unsigned char* vexists[8];
};

// The unfused path's positional clause over the whole capacity (entry
// `positional_leaf`): a CTA per slab of docs walks every row, the same
// leaf as the walk. Writes s_leaf (clause boost applied) and m_leaf; eval_node masks
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

constexpr int kBT = 8;            // query rows per item
constexpr int kThreads = 256;     // 8 warps: warp r selects row r
constexpr int kWarps = kThreads / 32;
constexpr int kMaxClauses = 8;
constexpr int kMaxQ = 8;
constexpr int kMaxPW = 512;       // positional parameter ints per row
constexpr int kSlots = 8;         // forward slots held in registers
constexpr int kHeads = 4;         // sorted best keys per lane in selection
constexpr int kMust = 0, kFilter = 1, kMustNot = 2;  // else should (3)
constexpr int kDense = 0, kRangeInt = 1;
constexpr int kVec = 8;           // cuda_scoring._VEC_KIND
constexpr int kStealCk = 32;      // ck above which warps steal doc chunks
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sel(bool m, float v) { return m ? v : 0.0f; }

// a positional clause kind (the leaf's kinds, posleaf::kPhraseExact ..
// kBm25f)
__host__ __device__ __forceinline__ bool is_pos(int kind) {
  return kind >= posleaf::kPhraseExact && kind <= posleaf::kBm25f;
}

// hit + select(t == tq, v): the add only where the ids match, as one
// predicated instruction (a compare and an add, no select). Exact: the
// skipped add is of +0.0, and hit, a round-to-nearest sum started at
// +0.0, is never -0.0 (only two -0.0 terms sum to -0.0).
__device__ __forceinline__ float add_hit(float hit, int t, int tq, float v) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.eq.s32 p, %1, %2;\n\t"
      "@p add.rn.f32 %0, %0, %3;\n\t}"
      : "+f"(hit)
      : "r"(t), "r"(tq), "f"(v));
  return hit;
}

// A shared value read where it is used, not kept in a register across the
// positional leaf (volatile: no earlier read is reused).
template <typename T>
__device__ __forceinline__ T reread(const T& x) {
  return *const_cast<const volatile T*>(&x);
}

// Order-preserving u32 image of an f32 (ops/topk.f32_order_key + 2^31)
// and its inverse. -inf maps to kNegInfKey; every finite score above it.
__device__ __forceinline__ unsigned ord_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float ord_val(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

constexpr unsigned kNegInfKey = 0x007fffffu;  // ord_key(-inf)

// A lane's heads: its kHeads best candidates (order key, doc), best
// first: the higher key, then the lower doc; key 0 marks an empty head.
struct Heads {
  unsigned k[kHeads];
  int d[kHeads];

  __device__ __forceinline__ static bool above(unsigned ka, int da,
                                               unsigned kb, int db) {
    return ka > kb || (ka == kb && da < db);
  }

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < kHeads; ++i) {
      k[i] = 0u;
      d[i] = 0;
    }
  }

  __device__ __forceinline__ void push(unsigned key, int doc) {
    if (!above(key, doc, k[kHeads - 1], d[kHeads - 1])) return;
#pragma unroll
    for (int i = kHeads - 1; i > 0; --i) {
      if (above(key, doc, k[i - 1], d[i - 1])) {
        k[i] = k[i - 1];
        d[i] = d[i - 1];
      } else if (above(key, doc, k[i], d[i])) {
        k[i] = key;
        d[i] = doc;
      }
    }
    if (above(key, doc, k[0], d[0])) {
      k[0] = key;
      d[0] = doc;
    }
  }

  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int i = 0; i < kHeads - 1; ++i) {
      k[i] = k[i + 1];
      d[i] = d[i + 1];
    }
    k[kHeads - 1] = 0u;
  }

};

// The ck best of one row's candidates, score descending and ties to the
// lower doc, into cs / ci (global doc ids), -inf / 0 past the matches:
// one warp, one warp-wide max per candidate. scan(f) calls f(score, doc)
// for this lane's candidates (a -inf score is no candidate). Returns the
// ck-th value (-inf when fewer match).
template <typename Scan>
__device__ __forceinline__ float select_row(Scan&& scan, int ck, int lane,
                                            float* cs, int* ci, int doc0) {
  Heads h;
  h.clear();
  int mine = 0;
  scan([&](float v, int d) {
    const unsigned key = ord_key(v);
    mine += key > kNegInfKey ? 1 : 0;
    if (key > kNegInfKey) h.push(key, d);
  });
  const int n_out = min(ck, static_cast<int>(__reduce_add_sync(kFull, mine)));
  unsigned last = 0u;
  int popped = 0;
  for (int s = 0; s < n_out; ++s) {
    // the best head: the highest score, then the lowest doc among equals
    last = __reduce_max_sync(kFull, h.k[0]);
    const bool top = h.k[0] == last;
    unsigned win = __ballot_sync(kFull, top);
    if (win & (win - 1u)) {
      const unsigned d_min = __reduce_min_sync(
          kFull, top ? static_cast<unsigned>(h.d[0]) : 0xffffffffu);
      win = __ballot_sync(kFull,
                          top && static_cast<unsigned>(h.d[0]) == d_min);
    }
    if (lane == __ffs(win) - 1) {
      cs[s] = ord_val(last);
      ci[s] = doc0 + h.d[0];
      const int pd = h.d[0];
      h.pop();
      if (h.k[0] == 0u && ++popped < mine) {
        // the heads ran dry: this lane's next best below the popped one
        scan([&](float v, int d) {
          const unsigned key = ord_key(v);
          if (key > kNegInfKey && (key < last || (key == last && d > pd)))
            h.push(key, d);
        });
      } else if (h.k[0] != 0u) {
        ++popped;
      }
    }
  }
  for (int s = n_out + lane; s < ck; s += 32) {
    cs[s] = -INFINITY;
    ci[s] = 0;
  }
  return n_out == ck ? ord_val(last) : -INFINITY;
}

// up to kSlots forward slots of a doc into registers
__device__ __forceinline__ void load_slots(const int* tp, const float* vp,
                                           int n, bool vec4,
                                           int (&t)[kSlots],
                                           float (&v)[kSlots]) {
  if (vec4) {
#pragma unroll
    for (int u = 0; u < kSlots; u += 4) {
      if (u < n) {
        const int4 t4 = __ldg(reinterpret_cast<const int4*>(tp + u));
        const float4 v4 = __ldg(reinterpret_cast<const float4*>(vp + u));
        t[u] = t4.x;
        t[u + 1] = t4.y;
        t[u + 2] = t4.z;
        t[u + 3] = t4.w;
        v[u] = v4.x;
        v[u + 1] = v4.y;
        v[u + 2] = v4.z;
        v[u + 3] = v4.w;
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      if (u < n) {
        t[u] = __ldg(tp + u);
        v[u] = __ldg(vp + u);
      }
    }
  }
}

// kPos: the bundle has positional clauses (pw > 0). Without them the
// leaf is compiled out and the dense walk keeps its registers.
template <bool kPos>
__global__ void __launch_bounds__(kThreads, 2)
bundle_topk_kernel(const __grid_constant__ BundleArgs a) {
  // dynamic (bundle_smem): cand [kBufs][kBT][tile] f32, pp [kBT][pw] i32,
  // per positional clause its leaf scores [kBT][kThreads] f32 and match
  // bits [kThreads] i32, then per tile of the sub-chunk the active list
  // i32, the rows' bounds [kBT] f32 and the rows that can match u8
  extern __shared__ __align__(16) unsigned char s_dyn[];
  // per-row parameters in pairs (f32 as bits), one 8-byte load a pair:
  // (query term, its weight), (msm_c, boost_c), (lo, hi), (msm, boost)
  __shared__ int2 s_qw[kBT][kMaxClauses * kMaxQ];
  __shared__ int2 s_mbc[kBT][kMaxClauses];
  __shared__ int2 s_lh[kBT][kMaxClauses];
  __shared__ int2 s_mb[kBT];
  __shared__ float s_thr[2][kBT];  // after the even / odd active tile
  __shared__ int s_next[2];        // per candidate buffer: next doc chunk
  // the item's sub-chunk, first row, rows, first tile, active tiles
  // (read back after each barrier rather than held across the walk)
  __shared__ int s_sub, s_row0, s_nrows, s_tbegin, s_nact;

  const int tile = a.tile;
  const int n_pos = kPos ? a.n_pos : 0;
  // candidate buffers: two, so that tile i + 1 is scored while tile i is
  // selected; one for a positional bundle, whose leaf reads the doc's
  // columns through L1 row after row and wants the shared memory back
  constexpr int kBufs = kPos ? 1 : 2;
  // a buffer: the matching docs' scores [kBT][tile] (only those are
  // written) and which docs match, one bit a doc, a word per (row, 32-doc
  // chunk) [kBT][32]
  float* s_cand = reinterpret_cast<float*>(s_dyn);
  unsigned* s_mask =
      reinterpret_cast<unsigned*>(s_cand + kBufs * kBT * tile);
  int* s_pp = reinterpret_cast<int*>(s_mask + kBufs * kBT * 32);
  float* s_ps = reinterpret_cast<float*>(s_pp + kBT * a.pw);
  int* s_pm = reinterpret_cast<int*>(s_ps + n_pos * kBT * kThreads);
  int* s_act = s_pm + n_pos * kThreads;
  float* s_ub = reinterpret_cast<float*>(s_act + a.chunk_tiles);
  unsigned char* s_bits =
      reinterpret_cast<unsigned char*>(s_ub + kBT * a.chunk_tiles);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qm = a.qm;
  const int qw = a.n_dense * qm;
  const int ck = a.ck;
  // 64-bit offsets are formed where they are used, from the launch's
  // dimensions: [B, n_tiles] per-tile outputs, [B, n_tiles * ck] strips,
  // [B, cap] mask
  auto at_tile = [&](int row, int j) {
    return static_cast<size_t>(row) * a.n_tiles + j;
  };
  auto at_strip = [&](int row, int j) {
    return (static_cast<size_t>(row) * a.n_tiles + j) * ck;
  };
  auto at_doc = [&](int row, size_t doc) {
    return static_cast<size_t>(row) * a.cap + doc;
  };
  const int n_bt = (a.B + kBT - 1) >> 3;
  const int n_chunks = (tile + 31) >> 5;
  // warps take doc chunks from a counter when the selections are long
  // enough (ck > 32) to leave warps idle that other warps could cover, and
  // for a positional bundle, whose docs cost as much as their positions;
  // otherwise the counter costs more than it balances
  const bool steal = kPos || ck > kStealCk;

  // one CTA per item, sub-chunk-major: the items in flight share their
  // doc tiles in L2
  const int item = blockIdx.x;
  const int sub = item / n_bt;
  const int row0 = (item - sub * n_bt) * kBT;
  const int n_rows = min(kBT, a.B - row0);
  const int t_begin = a.t0 + sub * a.chunk_tiles;
  const int len = min(a.t0 + a.nt, t_begin + a.chunk_tiles) - t_begin;
  if (tid == 0) {
    s_sub = sub;
    s_row0 = row0;
    s_nrows = n_rows;
    s_tbegin = t_begin;
  }

  // rows past B compute as copies of the last row; they never vote or
  // write
  for (int i = tid; i < kBT * qw; i += kThreads) {
    const int r = i / qw, c = i - r * qw;
    const size_t b = row0 + min(r, n_rows - 1);
    s_qw[r][c] = make_int2(a.qt[b * qw + c],
                           __float_as_int(a.wq[b * qw + c]));
  }
  for (int i = tid; i < kBT * a.n_dense; i += kThreads) {
    const int r = i / a.n_dense, c = i - r * a.n_dense;
    const size_t b = row0 + min(r, n_rows - 1);
    s_mbc[r][c] = make_int2(a.msmc[b * a.n_dense + c],
                            __float_as_int(a.boostc[b * a.n_dense + c]));
  }
  for (int i = tid; i < kBT * a.n_range; i += kThreads) {
    const int r = i / a.n_range, c = i - r * a.n_range;
    const size_t b = row0 + min(r, n_rows - 1);
    s_lh[r][c] = make_int2(a.lo[b * a.n_range + c],
                           a.hi[b * a.n_range + c]);
  }
  for (int i = tid; i < kBT * a.pw; i += kThreads) {
    const int r = i / a.pw;
    s_pp[i] = a.pp[static_cast<size_t>(row0 + r) * a.pw + (i - r * a.pw)];
  }
  if (tid < kBT) {
    const int b = row0 + min(tid, n_rows - 1);
    s_mb[tid] = make_int2(a.msm[b], __float_as_int(a.boost[b]));
    s_thr[1][tid] = a.thr_in != nullptr ? a.thr_in[b] : -INFINITY;
  }
  if (tid < 2) s_next[tid] = 0;
  // per tile of the sub-chunk: the rows that can match, their bounds
  for (int i = tid; i < len; i += kThreads) {
    unsigned bits = 0u;
    for (int r = 0; r < n_rows; ++r)
      bits |= (a.can[at_tile(row0 + r, t_begin + i)] != 0 ? 1u : 0u) << r;
    s_bits[i] = static_cast<unsigned char>(bits);
  }
  if (ck > 0) {
    for (int x = tid; x < n_rows * len; x += kThreads) {
      const int r = x / len, i = x - r * len;
      s_ub[i * kBT + r] = a.ub[at_tile(row0 + r, t_begin + i)];
    }
  }
  __syncthreads();
  // warp 0 lists the active tiles (some row can match) in order, as
  // (index in the sub-chunk << 8) | the rows that can match
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < len; base += 32) {
      const int i = base + lane;
      const unsigned bits = i < len ? s_bits[i] : 0u;
      const unsigned act = __ballot_sync(kFull, bits != 0u);
      if (bits)
        s_act[n + __popc(act & ((1u << lane) - 1u))] =
            (i << 8) | static_cast<int>(bits);
      n += __popc(act);
    }
    if (lane == 0) s_nact = n;
  }
  // every thread: the hard skips (no row can match: nothing to score
  // or count, mask rows 0)
  for (int i = 0; i < len; ++i) {
    if (s_bits[i]) continue;
    const int j = t_begin + i;
    for (int x = tid; x < n_rows * ck; x += kThreads) {
      const int r = x / ck, s = x - r * ck;
      const size_t o = at_strip(row0 + r, j) + s;
      a.cs[o] = -INFINITY;
      a.ci[o] = 0;
    }
    if (tid < n_rows) {
      a.cnt[at_tile(row0 + tid, j)] = 0;
      a.flags[at_tile(row0 + tid, j)] = 2;
    }
    if (a.emit_match) {
      const size_t doc0 = static_cast<size_t>(j) * tile;
      for (int x = tid; x < n_rows * tile; x += kThreads) {
        const int r = x / tile, d = x - r * tile;
        a.match[at_doc(row0 + r, doc0 + d)] = 0;
      }
    }
  }
  __syncthreads();

  // score active tile i into candidate buffer i % kBufs: candidates,
  // counts, mask; warps take 32-doc chunks
  auto score_tile = [&](int i) {
    const int b = i & 1;
    float* cand = s_cand + (i % kBufs) * kBT * tile;
    unsigned* mask = s_mask + (i % kBufs) * kBT * 32;
    for (int c_fixed = warp;; c_fixed += kWarps) {
      int c = c_fixed;
      if (steal) {
        if (lane == 0) c = atomicAdd(&s_next[b], 1);
        c = __shfl_sync(kFull, c, 0);
      }
      if (c >= n_chunks) break;
      const int d = c * 32 + lane;
      unsigned mt_rows = 0u;  // the rows the lane's doc matches
      if (d < tile) {
        // the tile and its rows, read back per doc (registers are
        // scarce across the positional leaf)
        const int act = reread(s_act[i]);
        const unsigned canbits = static_cast<unsigned>(act) & 0xffu;
        const size_t doc =
            static_cast<size_t>(reread(s_tbegin) + (act >> 8)) * tile + d;
        if constexpr (kPos) {
          // the positional leaves first, each row's score and match bit
          // parked in this thread's slots, while little else is live
          int pc = 0;
          for (int c2 = 0; c2 < a.n_clauses; ++c2) {
            const int kind = a.clause[c2][1];
            if (!is_pos(kind)) continue;
            const int slot = a.clause[c2][3];
            const int n = a.clause[c2][4], ntm = a.clause[c2][5];
            const int tail = slot + posleaf::param_tail(kind, n, ntm);
            float* ps = s_ps + pc * kBT * kThreads + tid;
            unsigned m = 0u;
#pragma unroll 1
            for (int r = 0; r < kBT; ++r) {
              // a row that cannot match in this tile matches no doc of it
              // (its can_match is exact), so its leaf is never read
              if (!((canbits >> r) & 1u)) {
                ps[r * kThreads] = 0.0f;
                continue;
              }
              const int* prm = s_pp + r * a.pw;
              float sl;
              bool ml;
              posleaf::leaf(kind, n, ntm, &a.clause[c2][6], prm + slot,
                            a.pfields, doc, sl, ml);
              // single-should wrapper semantics, as for dense clauses
              const int mc = prm[tail + 1];
              if ((ml || mc <= 0) && mc <= 1) m |= 1u << r;
              ps[r * kThreads] =
                  __fmul_rn(sel(ml, sl), __int_as_float(prm[tail + 2]));
            }
            s_pm[pc * kThreads + tid] = static_cast<int>(m);
            ++pc;
          }
        }
        float acc[kBT];
        unsigned scnt = 0u;  // should matches per row, 4 bits each
        unsigned must_ok = (1u << kBT) - 1u, not_any = 0u;
#pragma unroll
        for (int r = 0; r < kBT; ++r) acc[r] = 0.0f;
        int pc = 0;
        for (int c2 = 0; c2 < a.n_clauses; ++c2) {
          const int role = a.clause[c2][0];
          const int kind = a.clause[c2][1];
          const int f = a.clause[c2][2];
          const int slot = a.clause[c2][3];
          // must and should clauses add their score where they match
          const bool adds = role == kMust || role > kMustNot;
          unsigned m = 0u;
          if (kind == kDense) {
            const int L = a.L[f];
            const int* tp = a.tids[f] + doc * L;
            const float* vp = a.imps[f] + doc * L;
            const bool vec4 =
                (L & 3) == 0 &&
                ((reinterpret_cast<uintptr_t>(a.tids[f]) |
                  reinterpret_cast<uintptr_t>(a.imps[f])) & 15u) == 0;
            const bool held = L <= kSlots;
            // slots past L: id -1, impact 0 (a padded slot)
            int t[kSlots];
            float v[kSlots];
#pragma unroll
            for (int u = 0; u < kSlots; ++u) {
              t[u] = -1;
              v[u] = 0.0f;
            }
            if (held) load_slots(tp, vp, L, vec4, t, v);
            float s_leaf[kBT];
#pragma unroll
            for (int r = 0; r < kBT; ++r) s_leaf[r] = 0.0f;
            for (int q = 0; q < qm; ++q) {
              if (held) {
                // a row at a time: one query term and its sum live. The
                // slots past L hold id -1 and impact 0: at most they add
                // +0.0 for a padded query term, as a padded slot does
#pragma unroll
                for (int r = 0; r < kBT; ++r) {
                  const int2 qw = s_qw[r][slot * qm + q];
                  float hit = 0.0f;
#pragma unroll
                  for (int u = 0; u < kSlots; ++u)
                    hit = add_hit(hit, t[u], qw.x, v[u]);
                  s_leaf[r] = __fadd_rn(
                      s_leaf[r], __fmul_rn(hit, __int_as_float(qw.y)));
                }
                continue;
              }
              int tq[kBT];
              float hit[kBT];
#pragma unroll
              for (int r = 0; r < kBT; ++r) {
                tq[r] = s_qw[r][slot * qm + q].x;
                hit[r] = 0.0f;
              }
              for (int l0 = 0; l0 < L; l0 += kSlots) {
                const int n = min(kSlots, L - l0);
                load_slots(tp + l0, vp + l0, n, vec4, t, v);
#pragma unroll
                for (int u = 0; u < kSlots; ++u) {
                  if (u < n) {
#pragma unroll
                    for (int r = 0; r < kBT; ++r)
                      hit[r] = add_hit(hit[r], t[u], tq[r], v[u]);
                  }
                }
              }
#pragma unroll
              for (int r = 0; r < kBT; ++r) {
                const float wq = __int_as_float(s_qw[r][slot * qm + q].y);
                s_leaf[r] = __fadd_rn(s_leaf[r], __fmul_rn(hit[r], wq));
              }
            }
#pragma unroll
            for (int r = 0; r < kBT; ++r) {
              const bool m_leaf = s_leaf[r] > 0.0f;
              const int2 mbc = s_mbc[r][slot];
              const int mc = mbc.x;
              const bool mr = (m_leaf || mc <= 0) && mc <= 1;
              m |= (mr ? 1u : 0u) << r;
              if (adds)
                acc[r] = __fadd_rn(
                    acc[r], sel(mr, __fmul_rn(sel(m_leaf, s_leaf[r]),
                                              __int_as_float(mbc.y))));
            }
          } else if (kind == kVec) {
            // the clause's match is the exists mask, for every row; its
            // score the column at (row, doc), rows past B reading the
            // last row as the parameters do
            const bool ex = a.vexists[slot][doc] != 0;
            m = ex ? (1u << kBT) - 1u : 0u;
            if (adds) {
              const float* col = a.vcol[slot];
              const int row0 = s_row0, n_rows = s_nrows;
#pragma unroll
              for (int r = 0; r < kBT; ++r) {
                const size_t b = row0 + min(r, n_rows - 1);
                acc[r] = __fadd_rn(acc[r],
                                   sel(ex, __ldg(col + b * a.cap + doc)));
              }
            }
          } else if (kPos && is_pos(kind)) {
            m = static_cast<unsigned>(s_pm[pc * kThreads + tid]);
            const float* ps = s_ps + pc * kBT * kThreads + tid;
            if (adds) {
#pragma unroll
              for (int r = 0; r < kBT; ++r)
                acc[r] =
                    __fadd_rn(acc[r], sel((m >> r) & 1u, ps[r * kThreads]));
            }
            ++pc;
          } else {
            const bool ex = a.exists[f][doc] != 0;
            if (kind == kRangeInt) {
              const int v = static_cast<const int*>(a.vals[f])[doc];
#pragma unroll
              for (int r = 0; r < kBT; ++r)
                if (ex && v >= s_lh[r][slot].x && v <= s_lh[r][slot].y)
                  m |= 1u << r;
            } else {
              const float v = static_cast<const float*>(a.vals[f])[doc];
#pragma unroll
              for (int r = 0; r < kBT; ++r)
                if (ex && v >= __int_as_float(s_lh[r][slot].x) &&
                    v <= __int_as_float(s_lh[r][slot].y))
                  m |= 1u << r;
            }
          }
          if (role == kMust || role == kFilter) {
            must_ok &= m;
          } else if (role == kMustNot) {
            not_any |= m;
          } else {  // should
#pragma unroll
            for (int r = 0; r < kBT; ++r) scnt += ((m >> r) & 1u) << (4 * r);
          }
        }
        const bool live = a.live[doc] != 0;
        const int row0 = s_row0, n_rows = s_nrows;
#pragma unroll
        for (int r = 0; r < kBT; ++r) {
          const bool mt = ((must_ok >> r) & 1u) && !((not_any >> r) & 1u) &&
                          static_cast<int>((scnt >> (4 * r)) & 15u) >=
                              s_mb[r].x &&
                          live;
          if (mt)
            cand[r * tile + d] = __fmul_rn(acc[r], __int_as_float(s_mb[r].y));
          mt_rows |= (mt ? 1u : 0u) << r;
          if (a.emit_match && r < n_rows)
            a.match[at_doc(row0 + r, doc)] = mt ? 1 : 0;
        }
      }
      // the chunk's match bits, row r's word stored by lane r
      unsigned row_bits = 0u;
#pragma unroll
      for (int r = 0; r < kBT; ++r) {
        const unsigned bits = __ballot_sync(kFull, (mt_rows >> r) & 1u);
        if (lane == r) row_bits = bits;
      }
      if (lane < kBT) mask[lane * 32 + c] = row_bits;
    }
  };

  // warp r: count, flag, candidates and threshold of row r for active
  // tile i (buffer i & 1); frees the buffer's counters for tile i + 2
  auto select_tile = [&](int i) {
    const int b = i & 1;
    const int r = warp;
    const int row0 = s_row0, n_rows = s_nrows;
    const int il = s_act[i] >> 8;
    const int j = s_tbegin + il;
    const unsigned canbits = static_cast<unsigned>(s_act[i]) & 0xffu;
    const size_t o = at_tile(row0 + r, j);
    // lane l holds the match bits of docs 32 l .. 32 l + 31 of row r
    const unsigned bits =
        lane < n_chunks
            ? s_mask[((i % kBufs) * kBT + r) * 32 + lane] : 0u;
    const int count = __reduce_add_sync(kFull, __popc(bits));
    const float thr_old = s_thr[(i + 1) & 1][r];
    if (lane == 0) {
      if (r == 0) s_next[b] = 0;
      if (r < n_rows) a.cnt[o] = count;
    }
    if (ck == 0) {
      // mask-only grid: the count and the mask are the result
      if (lane == 0 && r < n_rows) a.flags[o] = 0;
      return;
    }
    // the batch tile's vote: some row's bound beats its threshold
    const bool top = lane < kBT && ((canbits >> lane) & 1u) &&
                     s_ub[il * kBT + lane] > s_thr[(i + 1) & 1][lane];
    const bool any_top = __ballot_sync(kFull, top) != 0u;
    float thr_new = thr_old;
    if (r < n_rows) {
      float* cs = a.cs + at_strip(row0 + r, j);
      int* ci = a.ci + at_strip(row0 + r, j);
      if (any_top && count > 0) {
        const float* row = s_cand + ((i % kBufs) * kBT + r) * tile;
        const float last = select_row(
            [&](auto&& f) {
              // this lane's matches, doc ascending
              for (unsigned m = bits; m != 0u; m &= m - 1u) {
                const int d = lane * 32 + __ffs(m) - 1;
                f(row[d], d);
              }
            },
            ck, lane, cs, ci, j * tile);
        if (a.update_thr) thr_new = fmaxf(thr_old, last);
      } else {
        // thresholded (counted exactly, no candidate can improve any
        // row's top-k) or a row without matches
        for (int s = lane; s < ck; s += 32) {
          cs[s] = -INFINITY;
          ci[s] = 0;
        }
      }
      if (lane == 0) a.flags[o] = any_top ? 0 : 1;
    }
    if (lane == 0) s_thr[i & 1][r] = thr_new;
  };

  // step i selects active tile i - 1 and scores tile i; one call site
  // each keeps one copy of the (large) scoring code. With one buffer,
  // the selection of tile i - 1 ends before tile i overwrites it.
  for (int i = 0; i <= reread(s_nact); ++i) {
    if (i > 0) select_tile(i - 1);
    if (kBufs == 1) __syncthreads();
    if (i < reread(s_nact)) score_tile(i);
    __syncthreads();
  }
  if (a.thr_out != nullptr && tid < s_nrows)
    a.thr_out[static_cast<size_t>(s_row0 + tid) * a.n_sub + s_sub] =
        s_thr[(s_nact + 1) & 1][tid];
}

// The unfused leaf (struct PosLeafArgs): one CTA owns a slab of `slab`
// docs and walks every row against it, so the positional columns are
// read from device memory once per launch, not once per row. It stages
// the slab's norms of each of the clause's fields in shared memory, and
// (kCols) its slot ids and position pack (doc strides odd in words: a
// warp's 32 docs hit 32 banks); where a field is too wide for that (the
// slot ids and pack of 32 docs past the staging budget: L up to 256, P
// up to 64), the leaf reads them from device memory. Per (field, doc),
// built once for all rows: a 32-bit signature (bit tid & 31 of every
// slot's term), a slot table by term hash (16-bit: slot + 1) and each
// slot's valid-entry count (the leaf then finds a term's slot and its
// frequency in two or three reads); then the rows' parameter rows, `rg`
// rows at a time. Per pass over 16 rows, a warp takes a (row, 32 docs)
// item, a lane one (row, doc): a doc whose signatures lack one of the
// row's terms (phrase / span) or all of them (BM25F) has frequency 0,
// and the leaf's own arithmetic at 0 gives its outputs, written
// row-major (8 warps: 8 x 32 consecutive docs of a row); the other
// pairs go to a queue in shared memory, and a second pass runs the leaf
// on the slab for them, a thread each, so a warp's lanes all decode.
// Launch bounds (256, 1): ptxas then takes the registers the leaf needs
// and spills nothing; under (256) alone it stops at 64 and spills.
constexpr int kLeafThreads = 256;
constexpr int kLeafMaxSlab = 128;      // docs a CTA stages, at most
constexpr int kLeafMinSlab = 32;       // ... at least: a warp's docs
constexpr int kLeafParamInts = 4096;   // parameter ints staged at a time
constexpr int kLeafLay = 12;           // ints of a field's slab layout
constexpr int kLeafHashWords = 17;     // a doc's slot table row (32 u16)
constexpr int kLeafPassRows = 16;      // rows whose pairs are queued at once
constexpr size_t kLeafSmem = 96 * 1024;  // bytes of staging, at most

// a field's slab layout in ints of the dynamic shared memory: offsets of
// the slot ids [0], pack [1], k1ln [2] and lnorm [3], the slot ids'
// stride in ints [4] and the pack's in int16 [5], L [6], P [7], offsets
// of the slot tables [8] (kLeafHashWords a doc) and the slots' counts
// [9] (stride in bytes [10]), the end [11]; strides odd in words. Without
// cols the slot ids and pack take no room, and [4] / [5] are their
// strides in device memory.
__host__ __device__ inline void leaf_layout(int L, int P, int slab, int at,
                                            bool cols, int* lay) {
  const int ts = cols ? L | 1 : 0;
  const int pwords = cols ? ((L * P + 1) / 2) | 1 : 0;
  const int tfw = ((L + 3) / 4) | 1;
  lay[0] = at;
  lay[2] = at + slab * ts;
  lay[3] = lay[2] + slab;
  lay[1] = lay[3] + slab;
  lay[8] = lay[1] + slab * pwords;
  lay[9] = lay[8] + slab * kLeafHashWords;
  lay[11] = lay[9] + slab * tfw;
  lay[4] = cols ? ts : L;
  lay[5] = cols ? 2 * pwords : L * P;
  lay[6] = L;
  lay[7] = P;
  lay[10] = 4 * tfw;
}

// ints of the dynamic shared memory: parameter rows, signatures, then
// each field's slab
__host__ __device__ inline int leaf_smem_ints(const PosLeafArgs& a, int slab,
                                              int rg, bool cols) {
  const int nf = a.kind == posleaf::kBm25f ? a.n : 1;
  int at = rg * a.pw + nf * slab;
  for (int fi = 0; fi < nf; ++fi) {
    const posleaf::PosField& f = a.pfields[a.fidx[fi]];
    int lay[kLeafLay];
    leaf_layout(f.L, f.P, slab, at, cols, lay);
    at = lay[11];
  }
  return at;
}

// a slab doc's rows in the clause's field fi: norms and tables in the
// slab, slot ids and pack there too (kCols) or in device memory
template <bool kCols>
struct SlabDoc {
  const int* base;
  const int* lay;         // [nf][kLeafLay]
  const PosLeafArgs* a;   // the columns in device memory (not kCols)
  int d0, d;
  __device__ __forceinline__ posleaf::DocRows field(int fi) const {
    const int* l = lay + fi * kLeafLay;
    const unsigned char* bytes = reinterpret_cast<const unsigned char*>(base);
    const int* trow;
    const short* prow;
    if constexpr (kCols) {
      trow = base + l[0] + d * l[4];
      prow = reinterpret_cast<const short*>(base + l[1]) + d * l[5];
    } else {
      const posleaf::PosField& f = a->pfields[a->fidx[fi]];
      const size_t g = static_cast<size_t>(d0 + d);
      trow = f.tids + g * l[4];
      prow = f.pos + g * l[5];
    }
    return {trow, prow, reinterpret_cast<const float*>(base + l[2]) + d,
            reinterpret_cast<const float*>(base + l[3]) + d, l[6], l[7],
            reinterpret_cast<const unsigned short*>(base + l[8]) +
                d * (2 * kLeafHashWords),
            bytes + 4 * l[9] + d * l[10]};
  }
};

template <bool kCols>
__global__ void __launch_bounds__(kLeafThreads, 1)
positional_leaf_kernel(const __grid_constant__ PosLeafArgs a, int slab,
                       int rg) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  int* s_ints = reinterpret_cast<int*>(s_dyn);
  __shared__ int s_lay[posleaf::kMaxFields * kLeafLay];
  __shared__ int s_q[kLeafPassRows * kLeafMaxSlab];  // queued (row, doc)
  __shared__ int s_qn;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nf = a.kind == posleaf::kBm25f ? a.n : 1;
  const int d0 = blockIdx.x * slab;
  int* s_pp = s_ints;
  unsigned* s_sig = reinterpret_cast<unsigned*>(s_ints + rg * a.pw);
  if (tid < nf) {
    int at = rg * a.pw + nf * slab;
    for (int fi = 0; fi <= tid; ++fi) {
      const posleaf::PosField& f = a.pfields[a.fidx[fi]];
      leaf_layout(f.L, f.P, slab, at, kCols, s_lay + tid * kLeafLay);
      at = s_lay[tid * kLeafLay + 11];
    }
  }
  __syncthreads();
  // stage the slab; docs past cap hold no term (-1 ids and pads)
  for (int fi = 0; fi < nf; ++fi) {
    const posleaf::PosField& f = a.pfields[a.fidx[fi]];
    const int* l = s_lay + fi * kLeafLay;
    if constexpr (kCols) {
      const int L = f.L, LP = f.L * f.P;
      for (int e = tid; e < slab * L; e += kLeafThreads) {
        const int d = e / L, g = d0 + d;
        s_ints[l[0] + d * l[4] + e - d * L] =
            g < a.cap ? __ldg(f.tids + static_cast<size_t>(d0) * L + e) : -1;
      }
      short* pos = reinterpret_cast<short*>(s_ints + l[1]);
      for (int e = tid; e < slab * LP; e += kLeafThreads) {
        const int d = e / LP, g = d0 + d;
        pos[d * l[5] + e - d * LP] =
            g < a.cap ? __ldg(f.pos + static_cast<size_t>(d0) * LP + e)
                      : static_cast<short>(-1);
      }
    }
    float* k1ln = reinterpret_cast<float*>(s_ints + l[2]);
    float* lnorm = reinterpret_cast<float*>(s_ints + l[3]);
    for (int d = tid; d < slab; d += kLeafThreads) {
      const bool in = d0 + d < a.cap;
      k1ln[d] = in ? __ldg(f.k1ln + d0 + d) : 1.0f;
      lnorm[d] = in ? __ldg(f.lnorm + d0 + d) : 1.0f;
    }
  }
  __syncthreads();
  // per (field, doc), for all rows: the term signature, the slot table
  // and the slots' valid-entry counts (a doc past cap: none)
  for (int e = tid; e < nf * slab; e += kLeafThreads) {
    const int fi = e / slab, d = e - fi * slab;
    const int* l = s_lay + fi * kLeafLay;
    const int L = l[6], P = l[7];
    const bool in = d0 + d < a.cap;
    const int* trow;
    const short* pr;
    if constexpr (kCols) {
      trow = s_ints + l[0] + d * l[4];
      pr = reinterpret_cast<const short*>(s_ints + l[1]) + d * l[5];
    } else {
      const posleaf::PosField& f = a.pfields[a.fidx[fi]];
      const size_t g = in ? static_cast<size_t>(d0 + d) : 0;
      trow = f.tids + g * l[4];
      pr = f.pos + g * l[5];
    }
    int* hw = s_ints + l[8] + d * kLeafHashWords;
    for (int k = 0; k < kLeafHashWords; ++k) hw[k] = 0;
    unsigned short* h = reinterpret_cast<unsigned short*>(hw);
    unsigned char* tfr = reinterpret_cast<unsigned char*>(s_ints + l[9]) +
                         d * l[10];
    unsigned sig = 0u;
    for (int k = 0; k < L; ++k) {
      int c = 0;
      for (int q = 0; in && q < P; ++q) c += pr[k * P + q] >= 0 ? 1 : 0;
      tfr[k] = static_cast<unsigned char>(c);
      const int t = in ? trow[k] : -1;
      if (t >= 0) {
        sig |= 1u << (t & 31);
        unsigned short& slot = h[t & (posleaf::kHashSlots - 1)];
        slot = slot == 0 ? static_cast<unsigned short>(k + 1)
                         : posleaf::kHashMany;
      }
    }
    s_sig[e] = sig;
  }
  const int groups = slab / 32;
  const int tail = posleaf::param_tail(a.kind, a.n, a.nt);
  const bool bm25f = a.kind == posleaf::kBm25f;
  for (int r0 = 0; r0 < a.B; r0 += rg) {
    const int nr = min(rg, a.B - r0);
    __syncthreads();  // signatures written; the last rows' params read
    for (int e = tid; e < nr * a.pw; e += kLeafThreads)
      s_pp[e] = __ldg(a.pp + static_cast<size_t>(r0) * a.pw + e);
    for (int p0 = 0; p0 < nr; p0 += kLeafPassRows) {
      const int np = min(kLeafPassRows, nr - p0);
      if (tid == 0) s_qn = 0;
      __syncthreads();  // params staged, the queue empty
      // pass 1, a warp per (row, 32 docs): a pair whose doc lacks one
      // of the row's terms (by the signatures) has frequency 0 (bm25f:
      // no (field, term) present, raw 0), and the leaf's own arithmetic
      // at 0 gives its outputs; the others go to the queue
      for (int item = warp; item < np * groups;
           item += kLeafThreads / 32) {
        const int r = p0 + item / groups;
        const int d = (item % groups) * 32 + lane;
        const int* prm = s_pp + r * a.pw;
        bool zero = bm25f;
        if (bm25f) {
          for (int e = 0; e < a.n * a.nt; ++e) {
            const int t = prm[e];
            if (t >= 0 && ((s_sig[(e / a.nt) * slab + d] >> (t & 31)) & 1u))
              zero = false;
          }
        } else {
          for (int i = 0; i < a.n; ++i) {
            const int t = prm[i];
            if (t < 0 || !((s_sig[d] >> (t & 31)) & 1u)) zero = true;
          }
        }
        if (zero && d0 + d < a.cap) {
          const float raw =
              bm25f ? 0.0f
                    : posleaf::phrase_impact(0, __int_as_float(prm[2 * a.n]),
                                             0.0f);
          const size_t o = static_cast<size_t>(r0 + r) * a.cap + d0 + d;
          a.s_out[o] = __fmul_rn(raw, __int_as_float(prm[tail]));
          a.m_out[o] = 0;
        }
        const unsigned slow = __ballot_sync(kFull, !zero && d0 + d < a.cap);
        if (slow != 0u) {
          const int leader = __ffs(slow) - 1;
          int at = 0;
          if (lane == leader) at = atomicAdd(&s_qn, __popc(slow));
          at = __shfl_sync(kFull, at, leader);
          if ((slow >> lane) & 1u)
            s_q[at + __popc(slow & ((1u << lane) - 1u))] = r * slab + d;
        }
      }
      __syncthreads();
      // pass 2: the queued pairs, a thread each, run the leaf on the slab
      const int qn = s_qn;
      for (int i = tid; i < qn; i += kLeafThreads) {
        const int r = s_q[i] / slab, d = s_q[i] - r * slab;
        float sv;
        bool mv;
        posleaf::leaf_doc<posleaf::Smem>(
            a.kind, a.n, a.nt, s_pp + r * a.pw,
            SlabDoc<kCols>{s_ints, s_lay, &a, d0, d}, sv, mv);
        const size_t o = static_cast<size_t>(r0 + r) * a.cap + d0 + d;
        a.s_out[o] = sv;
        a.m_out[o] = mv ? 1 : 0;
      }
      __syncthreads();  // the queue is drained before the next pass fills it
    }
  }
}

// The unfused leaf's launch: the widest slab (128 docs, down to 32) whose
// staging, with its parameter rows, fits kLeafSmem with the slot ids and
// pack staged; else the widest with them left in device memory. Checks
// the arguments and opts the kernel in (rg: parameter rows a stage).
cudaError_t leaf_launch_plan(const PosLeafArgs& a, int* rg, bool* cols,
                             int* slab, size_t* smem) {
  if (a.B > 65535 || a.kind < posleaf::kPhraseExact ||
      a.kind > posleaf::kBm25f || a.n < 1 || a.n > posleaf::kMaxTerms ||
      a.pw < 1 || a.pw > kMaxPW ||
      (a.kind == posleaf::kBm25f &&
       (a.n > posleaf::kMaxFields || a.nt < 1 || a.nt > posleaf::kMaxTerms)))
    return cudaErrorInvalidValue;
  // the slab's tables hold a slot + 1 in 16 bits and a count in a byte
  for (int fi = 0; fi < (a.kind == posleaf::kBm25f ? a.n : 1); ++fi) {
    const posleaf::PosField& f = a.pfields[a.fidx[fi]];
    if (f.L < 1 || f.L >= posleaf::kHashMany || f.P < 1 || f.P > 255)
      return cudaErrorInvalidValue;
  }
  *rg = std::min(std::max(a.B, 1), std::max(1, kLeafParamInts / a.pw));
  for (int c = 1; c >= 0; --c) {
    for (int s = kLeafMaxSlab; s >= kLeafMinSlab; s /= 2) {
      const size_t bytes =
          sizeof(int) * static_cast<size_t>(leaf_smem_ints(a, s, *rg, c));
      if (bytes <= kLeafSmem) {
        *cols = c == 1;
        *slab = s;
        *smem = bytes;
        return cudaFuncSetAttribute(
            c ? positional_leaf_kernel<true> : positional_leaf_kernel<false>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(bytes));
      }
    }
  }
  return cudaErrorInvalidValue;
}

// bytes of the walk's dynamic shared memory
size_t bundle_smem(int tile, int pw, int chunk_tiles, int n_pos) {
  // candidate scores and match bits
  const size_t bufs = n_pos > 0 ? 1 : 2;
  return bufs * kBT * (sizeof(float) * static_cast<size_t>(tile) +
                       sizeof(unsigned) * 32) +
         sizeof(int) * kBT * static_cast<size_t>(pw) +
         static_cast<size_t>(n_pos) * (sizeof(float) * kBT + sizeof(int)) *
             kThreads +
         (sizeof(int) + sizeof(float) * kBT + 1) *
             static_cast<size_t>(chunk_tiles);
}

// The walk's kernel for a bundle with or without positional clauses, its
// dynamic shared memory opted in (an oversize request fails here).
cudaError_t bundle_kernel(int tile, int pw, int chunk_tiles, int n_pos,
                          void (**kernel)(BundleArgs), size_t* smem) {
  *kernel = n_pos > 0 ? bundle_topk_kernel<true> : bundle_topk_kernel<false>;
  *smem = bundle_smem(tile, pw, chunk_tiles, n_pos);
  return cudaFuncSetAttribute(*kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace

extern "C" int positional_leaf(const PosLeafArgs* args, void* stream) {
  const PosLeafArgs a = *args;
  if (a.B <= 0 || a.cap <= 0) return 0;
  int rg, slab;
  bool cols;
  size_t smem;
  const cudaError_t err = leaf_launch_plan(a, &rg, &cols, &slab, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((a.cap + slab - 1) / slab);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cols)
    positional_leaf_kernel<true><<<grid, kLeafThreads, smem, st>>>(a, slab,
                                                                   rg);
  else
    positional_leaf_kernel<false><<<grid, kLeafThreads, smem, st>>>(a, slab,
                                                                    rg);
  return static_cast<int>(cudaGetLastError());
}

// The unfused leaf's launch for args (pointers unused): whether it stages
// the slot ids and pack, its slab and its dynamic shared memory in bytes,
// the kernel opted in. For tests and reports.
extern "C" int positional_leaf_plan(const PosLeafArgs* args, int* cols,
                                    int* slab, int* smem) {
  int rg;
  bool c;
  size_t bytes;
  const cudaError_t err = leaf_launch_plan(*args, &rg, &c, slab, &bytes);
  *cols = c ? 1 : 0;
  *smem = static_cast<int>(bytes);
  return static_cast<int>(err);
}

extern "C" int bundle_topk(const BundleArgs* args, void* stream) {
  BundleArgs a = *args;
  if (a.B <= 0 || a.n_tiles <= 0 || a.nt <= 0) return 0;
  if (a.n_clauses > kMaxClauses || a.qm > kMaxQ || a.n_dense > kMaxClauses ||
      a.n_range > kMaxClauses || a.tile > 1024 || a.tile <= 0 ||
      a.ck < 0 || a.ck > a.tile || a.chunk_tiles <= 0 || a.pw < 0 ||
      a.pw > kMaxPW || a.t0 < 0 || a.t0 + a.nt > a.n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  // a positional clause always brings parameter rows (pw > 0)
  a.n_pos = 0;
  for (int c = 0; c < a.n_clauses; ++c)
    a.n_pos += is_pos(a.clause[c][1]) ? 1 : 0;
  if ((a.n_pos > 0) != (a.pw > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  a.n_sub = (a.nt + a.chunk_tiles - 1) / a.chunk_tiles;
  const long long n_items =
      static_cast<long long>(a.n_sub) * ((a.B + kBT - 1) / kBT);
  if (n_items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(BundleArgs);
  size_t smem;
  const cudaError_t err =
      bundle_kernel(a.tile, a.pw, a.chunk_tiles, a.n_pos, &kernel, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<static_cast<unsigned>(n_items), kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// A launch's dynamic shared memory and the CTAs an SM holds at that size,
// for reports (the walk itself does not ask).
extern "C" int bundle_topk_occupancy(int tile, int pw, int chunk_tiles,
                                     int n_pos, int* smem, int* ctas_per_sm) {
  void (*kernel)(BundleArgs);
  size_t bytes;
  cudaError_t err = bundle_kernel(tile, pw, chunk_tiles, n_pos, &kernel,
                                  &bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem = static_cast<int>(bytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, kernel, kThreads, bytes));
}
