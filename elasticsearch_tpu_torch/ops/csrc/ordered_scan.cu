// f32 agg sums in the reference's exact order, for Hopper (sm_90a).
//
// Not a TPU kernel: the reference computes these sums outside any Pallas
// kernel, with XLA's `cumsum` (elasticsearch_tpu/ops/aggs.py:123, :138,
// :84, :75) and `.sum(-1)` (:83, :101; masked_stats :235-236). The port
// must round them exactly as XLA does, on the CPU and on the card; the
// plain versions, which fix the two orders, are
// elasticsearch_tpu_torch/ops/ordered.py (`prefix_at`, `xla_block_sum`).
// The third agg sum, XLA's scatter `.at[ids].add` (a left fold from
// +0.0 per bucket over its docs in ascending doc order), is
// csrc/bucket_stats.cu.
//
// Entry `ordered_prefix`: cs0[b, pos[g]] of cs0 = [0, cumsum(w[b, perm])]
// in XLA's order, a recursive blocked scan of base 16: blocks of 16
// (the last zero-padded) take their prefix sequentially from +0.0, the
// block totals are scanned the same way until 16 or fewer remain, and an
// output is fl(exclusive prefix of its block + intra-block prefix). The
// blocks nest exactly (the level-l block j covers positions
// [16^(l+1) j, 16^(l+1) (j + 1)), padding only at the end), so:
//   * levels: a CTA of 256 threads takes 4,096 positions of a row; each
//     thread adds its own 16-position block in order (without perm its
//     weights as four 16-byte loads; through perm a warp reads its 512
//     positions lane by lane, near coalesced for a key sort, and
//     transposes them in shared memory), a half-warp's 16 totals
//     fold by shuffles into a level-2 total, the CTA's 16 of those into
//     a level-3 total: three levels a launch, each written once. At
//     2^20 positions: one launch for levels 1-3 (2^16, 2^12, 2^8
//     totals), one small launch for level 4 (16).
//   * a scattered perm (a timestamp sort; the caller passes `wt`): a
//     gather straight from a row pulls a 32-byte sector for one 4-byte
//     weight. The weights are first copied doc-major, eight rows a
//     group (one coalesced pass), and level 1 then reads one sector per
//     position for all eight rows.
//   * points: one thread per (row, position) evaluates the prefix there
//     alone: from the topmost level its chain reaches down, the partial
//     prefix of each level's block (at most 16 adds each), added in.
// The prefix is never materialised over the whole row.
//
// Entry `ordered_sum`: x[r, :].sum() in XLA's reduction tree: while more
// than 32 values remain, k = ceil(n / 32) windows of exactly 32, padded
// with p = 32 k - n zeros, p / 2 (rounded down) before the row and the
// rest after it, each summed in order from +0.0; then the last ones in
// order. A warp takes 1,024 consecutive positions (two levels): it
// stages them in shared memory with 16-byte loads where the row and its
// padding allow (rows of 33 words: no bank conflicts), each lane adds
// one window of 32 in order, and the 32 window sums fold by shuffles.
// Rows of 512 / 128 (the agg views' blocks) are two / eight a warp and
// take one launch; a row of 2^20 takes two (levels 1-2, then 3 and the
// last).
//
// Zero padding is added where XLA adds it and nowhere else: with
// subnormals flushed a sum can be -0.0 (a negative result flushed), and
// -0.0 + 0.0 is +0.0; otherwise s + 0.0 == s.
// Every add is __fadd_rn (no FMA contraction; built without
// --use_fast_math), no atomics: each output is the reference's bits,
// deterministic. Built with -ftz=true: an add reads a subnormal as a
// zero of its sign and flushes a subnormal result, as XLA's CPU runtime
// does (ops/ordered.ftz; FADD.FTZ in the SASS); a row of one value is
// returned as it is, a move, as XLA's cumsum returns it.
//
// What bounds it: bytes. ordered_prefix reads each weight once (the
// level totals are 1/16 of that and smaller) plus perm: about 1 GiB at
// B 256 x 2^20 docs; through a scattered perm each 4-byte weight costs a
// 32-byte sector, or, copied doc-major, the copy's pass and a sector per
// eight weights. ordered_sum reads its input once.

#include <cuda_runtime.h>
#include <stdint.h>

// entry `ordered_prefix`'s arguments (cuda_scoring._ScanArgs)
struct ScanArgs {
  const float* w;     // [B, n]
  const int* perm;    // [n], or null: the rows as they are
  const int* pos;     // [P] shared by every row, or [B, P]
  float* lev;         // scratch: level totals, [B, lev_len]
  float* out;         // [B, P]
  int B, n, P, pos_per_row, lev_len;
  float* wt;          // scratch, or null: the weights doc-major (below)
  long long wt_len;   // its floats: ordered_prefix_doc_major_scratch(B, n)
};

namespace {

constexpr int kBase = 16;     // ops/ordered.SCAN_BASE
constexpr int kWindow = 32;   // ops/ordered.SUM_WINDOW
constexpr int kThreads = 256;
constexpr int kScanSpan = kThreads * kBase;      // positions a level CTA
constexpr int kWarps = kThreads / 32;
constexpr int kTask = kWindow * kWindow;         // positions a tree warp
constexpr int kGroup = 8;     // rows a doc-major sector holds

// the length of scan level l >= 1: ceil(len(l - 1) / 16), len(0) = n
__device__ __host__ __forceinline__ int level_len(int n, int l) {
  for (int k = 0; k < l; ++k) n = (n + kBase - 1) / kBase;
  return n;
}

__device__ __host__ __forceinline__ long long level_off(int n, int l) {
  long long off = 0;
  for (int k = 1; k < l; ++k) off += level_len(n, k);
  return off;
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// where a level launch writes: level l's totals at lev + off (len 0: the
// level does not exist)
struct LevelOut {
  long long off1, off2, off3;
  int len1, len2, len3;
};

// Levels l, l + 1, l + 2 from level l - 1 (`src`, n_src a row; the
// weights through perm for l 1). Thread t of CTA c adds level-(l-1)
// block 256 c + t in order; a half-warp folds its 16 totals, the CTA its
// 16 half-warp totals.
template <bool kPerm, bool kVec>
__global__ void __launch_bounds__(kThreads)
scan_levels_kernel(const float* __restrict__ src, long long src_stride,
                   const int* __restrict__ perm, int n_src,
                   float* __restrict__ lev, long long lev_stride,
                   const LevelOut o) {
  __shared__ float s_t2[kThreads / kBase];
  __shared__ float s_tile[kPerm ? kWarps : 1][32][kBase + 1];
  const int t = threadIdx.x, lane = t & 31;
  const int j = blockIdx.x * kThreads + t;
  const float* row = src + blockIdx.y * src_stride;
  float* lrow = lev + blockIdx.y * lev_stride;
  const int i0 = j * kBase;
  float t1 = 0.0f;
  if (kPerm) {
    // a warp's 32 blocks: its lanes read consecutive positions (perm,
    // and for a key sort the weights, near coalesced) into shared
    // memory, then each lane adds its own block (rows of 17 words)
    const int w = t >> 5, e0 = (j - lane) * kBase;
#pragma unroll
    for (int k = 0; k < kBase; ++k) {
      const int e = 32 * k + lane, i = e0 + e;
      s_tile[kPerm ? w : 0][e / kBase][e % kBase] =
          i < n_src ? __ldg(row + __ldg(perm + i)) : 0.0f;
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kBase; ++k)
      t1 = __fadd_rn(t1, s_tile[kPerm ? w : 0][lane][k]);
  } else {
    float v[kBase];
    if (kVec && i0 + kBase <= n_src) {
      const float4* r4 = reinterpret_cast<const float4*>(row + i0);
#pragma unroll
      for (int q = 0; q < kBase / 4; ++q) {
        const float4 x = __ldg(r4 + q);
        v[4 * q] = x.x;
        v[4 * q + 1] = x.y;
        v[4 * q + 2] = x.z;
        v[4 * q + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kBase; ++k)
        v[k] = i0 + k < n_src ? __ldg(row + i0 + k) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kBase; ++k) t1 = __fadd_rn(t1, v[k]);
  }
  if (j < o.len1) lrow[o.off1 + j] = t1;
  else t1 = 0.0f;
  if (o.len2 == 0) return;
  const int h = lane & kBase;   // the half-warp's first lane
  float t2 = 0.0f;
#pragma unroll
  for (int k = 0; k < kBase; ++k)
    t2 = __fadd_rn(t2, __shfl_sync(~0u, t1, h + k));
  const int j2 = blockIdx.x * (kThreads / kBase) + t / kBase;
  if ((lane & (kBase - 1)) == 0) {
    if (j2 < o.len2) lrow[o.off2 + j2] = t2;
    s_t2[t / kBase] = j2 < o.len2 ? t2 : 0.0f;
  }
  if (o.len3 == 0) return;
  __syncthreads();
  if (t == 0 && blockIdx.x < o.len3) {
    float t3 = 0.0f;
#pragma unroll
    for (int k = 0; k < kThreads / kBase; ++k) t3 = __fadd_rn(t3, s_t2[k]);
    lrow[o.off3 + blockIdx.x] = t3;
  }
}

// The weights doc-major, eight rows a group: wt[g, d, r] = w[8 g + r, d]
// (rows past B zero). A thread reads one doc of eight rows (eight
// coalesced 4-byte loads) and writes them as one 32-byte run.
__global__ void __launch_bounds__(kThreads)
doc_major_kernel(const float* __restrict__ w, int B, int n,
                 float* __restrict__ wt) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= n) return;
  const int g = blockIdx.y;
  float v[kGroup];
#pragma unroll
  for (int r = 0; r < kGroup; ++r) {
    const int b = g * kGroup + r;
    v[r] = b < B ? __ldg(w + static_cast<long long>(b) * n + d) : 0.0f;
  }
  float4* o = reinterpret_cast<float4*>(
      wt + (static_cast<long long>(g) * n + d) * kGroup);
  o[0] = make_float4(v[0], v[1], v[2], v[3]);
  o[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Levels 1-3 from the weights through perm, read doc-major: thread t of
// CTA c adds block 256 c + t of eight rows at once, each position one
// 32-byte sector (the eight rows' weights of its doc) in place of eight;
// then the half-warp and CTA folds of each row, as scan_levels_kernel.
__global__ void __launch_bounds__(kThreads)
scan_levels_doc_major_kernel(const float* __restrict__ wt,
                             const int* __restrict__ perm, int n, int B,
                             float* __restrict__ lev, long long lev_stride,
                             const LevelOut o) {
  __shared__ float s_t2[kGroup][kThreads / kBase];
  const int t = threadIdx.x, lane = t & 31, g = blockIdx.y;
  const int j = blockIdx.x * kThreads + t, i0 = j * kBase;
  const float4* rows = reinterpret_cast<const float4*>(
      wt + static_cast<long long>(g) * n * kGroup);
  float t1[kGroup];
#pragma unroll
  for (int r = 0; r < kGroup; ++r) t1[r] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < kBase; ++k) {
    const int i = i0 + k;
    if (i >= n) break;
    const int d = __ldg(perm + i);
    const float4 lo = __ldg(rows + 2 * d), hi = __ldg(rows + 2 * d + 1);
    t1[0] = __fadd_rn(t1[0], lo.x);
    t1[1] = __fadd_rn(t1[1], lo.y);
    t1[2] = __fadd_rn(t1[2], lo.z);
    t1[3] = __fadd_rn(t1[3], lo.w);
    t1[4] = __fadd_rn(t1[4], hi.x);
    t1[5] = __fadd_rn(t1[5], hi.y);
    t1[6] = __fadd_rn(t1[6], hi.z);
    t1[7] = __fadd_rn(t1[7], hi.w);
  }
  const int j2 = blockIdx.x * (kThreads / kBase) + t / kBase;
  const int h = lane & kBase;
#pragma unroll
  for (int r = 0; r < kGroup; ++r) {
    const int b = g * kGroup + r;
    float* lrow = lev + static_cast<long long>(min(b, B - 1)) * lev_stride;
    if (j < o.len1 && b < B) lrow[o.off1 + j] = t1[r];
    if (o.len2 == 0) continue;
    float t2 = 0.0f;
#pragma unroll
    for (int k = 0; k < kBase; ++k)
      t2 = __fadd_rn(t2, __shfl_sync(~0u, j < o.len1 ? t1[r] : 0.0f, h + k));
    if ((lane & (kBase - 1)) == 0) {
      if (j2 < o.len2 && b < B) lrow[o.off2 + j2] = t2;
      s_t2[r][t / kBase] = j2 < o.len2 ? t2 : 0.0f;
    }
  }
  if (o.len3 == 0) return;
  __syncthreads();
  if (t < kGroup && g * kGroup + t < B && blockIdx.x < o.len3) {
    float t3 = 0.0f;
#pragma unroll
    for (int k = 0; k < kThreads / kBase; ++k) t3 = __fadd_rn(t3, s_t2[t][k]);
    lev[static_cast<long long>(g * kGroup + t) * lev_stride + o.off3 +
        blockIdx.x] = t3;
  }
}

// one thread per (row, position): cs0 at p, from the level totals
__global__ void __launch_bounds__(kThreads)
scan_points_kernel(const __grid_constant__ ScanArgs a) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= a.P) return;
  const int b = blockIdx.y;
  int p = __ldg(a.pos + (a.pos_per_row ? static_cast<long long>(b) * a.P : 0)
                + g);
  p = min(max(p, 0), a.n);
  float r = 0.0f;
  if (p > 0 && a.n == 1) {
    r = __ldg(a.w + b * static_cast<long long>(a.n) +
              (a.perm != nullptr ? __ldg(a.perm) : 0));
  } else if (p > 0) {
    // the chain of block indices: i(0) = p - 1, i(l + 1) = i(l) / 16 - 1
    // while i(l) lies past its level's first block
    int top = 0;
    for (int i = p - 1; i >= kBase; i = i / kBase - 1) ++top;
    const float* wrow = a.w + b * static_cast<long long>(a.n);
    const float* lrow = a.lev + b * static_cast<long long>(a.lev_len);
    for (int l = top; l >= 0; --l) {
      int i = p - 1;
      for (int k = 0; k < l; ++k) i = i / kBase - 1;
      const int i0 = i - i % kBase;
      float s = 0.0f;
      if (l == 0) {
        for (int t = i0; t <= i; ++t)
          s = __fadd_rn(s, __ldg(wrow + (a.perm != nullptr ? __ldg(a.perm + t)
                                                           : t)));
      } else {
        const float* v = lrow + level_off(a.n, l);
        for (int t = i0; t <= i; ++t) s = __fadd_rn(s, v[t]);
      }
      // XLA adds each block's exclusive prefix, +0.0 for a level's first
      // block, below the last level (one of 16 or fewer): at the top of
      // the chain that add turns a flushed -0.0 into +0.0
      r = l < top ? __fadd_rn(r, s)
                  : level_len(a.n, l) > kBase ? __fadd_rn(0.0f, s) : s;
    }
  }
  a.out[static_cast<long long>(b) * a.P + g] = r;
}

// one level pair of the tree (see the entry): window w of level 1 sums
// positions [32 w - lo1, 32 w - lo1 + 32) of a row of n (k1 windows);
// level-2 window J sums level-1 windows [32 J - lo2, 32 J - lo2 + 32)
// (k2 windows; k2 1: the last level, lo2 0). A warp takes one level-2
// window, or with rp > 1 (rows of n = 1024 / rp, k2 1, lo1 0) rp whole
// rows.
struct TreeLevel {
  long long R;          // rows
  long long tasks;      // warps: R * k2, or ceil(R / rp)
  int n, lo1, k1, lo2, k2, rp;
};

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
tree_pair_kernel(const float* __restrict__ src, float* __restrict__ dst,
                 const TreeLevel L) {
  __shared__ float s_x[kWarps][kWindow][kWindow + 1];
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const long long task = static_cast<long long>(blockIdx.x) * kWarps + wp;
  if (task >= L.tasks) return;
  float (*x)[kWindow + 1] = s_x[wp];
  // position e of the task's 1,024 is element first + e of src, valid
  // where lo <= e < hi
  long long first;
  int lo, hi;
  if (L.rp > 1) {
    first = task * kTask;
    lo = 0;
    hi = static_cast<int>(
        min(static_cast<long long>(kTask), L.R * L.n - first));
  } else {
    const long long r = task / L.k2;
    const int J = static_cast<int>(task - r * L.k2);
    const int p0 = kWindow * (kWindow * J - L.lo2) - L.lo1;  // row position
    first = r * L.n + p0;
    lo = max(0, -p0);
    hi = min(kTask, L.n - p0);
  }
  if (kVec) {
    // first, lo and hi are multiples of 4: whole float4s in or out
#pragma unroll
    for (int it = 0; it < kTask / 4 / 32; ++it) {
      const int f = it * 32 + lane, e = 4 * f;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (e >= lo && e < hi)
        v = __ldg(reinterpret_cast<const float4*>(src + first + e));
      float* d = &x[f >> 3][(f & 7) * 4];
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }
  } else {
#pragma unroll 8
    for (int it = 0; it < kWindow; ++it) {
      const int e = it * 32 + lane;
      x[it][lane] = e >= lo && e < hi ? __ldg(src + first + e) : 0.0f;
    }
  }
  __syncwarp();
  // XLA pads a level of more than 32 values (its zeros are added) but not
  // the last level, whose n values it adds alone: a zero added past them
  // would turn a flushed -0.0 into +0.0. Level 1 is the last where a row
  // holds 32 or fewer (a row of one value is moved, as XLA moves it);
  // level 2 where k2 is 1, over the k1 real windows (one: the window's
  // sum itself)
  const int n1 = L.rp == 1 && L.k1 == 1 ? L.n : kWindow;
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < kWindow; ++k)
    if (k < n1) s = n1 == 1 ? x[lane][k] : __fadd_rn(s, x[lane][k]);
  // level 2: lane groups of g windows (one row each with rp > 1)
  const int g = L.rp > 1 ? L.k1 : kWindow;
  const int n2 = L.rp > 1 || L.k2 == 1 ? L.k1 : kWindow;
  const int head = lane & ~(g - 1);
  float tot = 0.0f;
#pragma unroll
  for (int k = 0; k < kWindow; ++k) {
    const float y = __shfl_sync(~0u, s, head + (k & (g - 1)));
    if (k < n2) tot = n2 == 1 ? y : __fadd_rn(tot, y);
  }
  if (lane != head) return;
  if (L.rp > 1) {
    const long long r = task * L.rp + lane / g;
    if (r < L.R) dst[r] = tot;
  } else {
    dst[task] = tot;
  }
}

// the launch of one level pair over rows of n; returns the values a row
// it leaves (1: the sums)
__host__ TreeLevel tree_level(long long R, int n) {
  TreeLevel L{};
  L.R = R;
  L.n = n;
  L.k1 = n > kWindow ? (n + kWindow - 1) / kWindow : 1;
  L.lo1 = (kWindow * L.k1 - n) / 2;
  if (n <= kWindow) L.lo1 = 0;
  if (L.k1 > kWindow) {
    L.k2 = (L.k1 + kWindow - 1) / kWindow;
    L.lo2 = (kWindow * L.k2 - L.k1) / 2;
  } else {
    L.k2 = 1;
    L.lo2 = 0;
  }
  L.rp = (L.k2 == 1 && n % kWindow == 0 && n < kTask && kTask % n == 0)
             ? kTask / n
             : 1;
  L.tasks = L.rp > 1 ? (R + L.rp - 1) / L.rp : R * L.k2;
  return L;
}

}  // namespace

// floats of scratch a row of n needs for its scan levels
extern "C" int ordered_prefix_scratch(int n) {
  int total = 0;
  for (int l = 1; level_len(n, l - 1) > kBase; ++l) total += level_len(n, l);
  return total;
}

// floats of scratch a row of n needs for the tree's level pairs but the
// last
extern "C" int ordered_sum_scratch(int n) {
  int total = 0;
  for (;;) {
    const TreeLevel L = tree_level(1, n);
    if (L.k2 == 1) return total;
    total += L.k2;
    n = L.k2;
  }
}

// floats of scratch the doc-major copy of B rows of n takes: eight rows
// a group, the last group padded
extern "C" long long ordered_prefix_doc_major_scratch(int B, int n) {
  return static_cast<long long>((B + kGroup - 1) / kGroup) * n * kGroup;
}

extern "C" int ordered_prefix(const ScanArgs* args, void* stream) {
  const ScanArgs a = *args;
  if (a.B <= 0 || a.P <= 0) return 0;
  if (a.B > 65535 || a.n < 0 || a.lev_len != ordered_prefix_scratch(a.n) ||
      (a.wt != nullptr &&
       a.wt_len != ordered_prefix_doc_major_scratch(a.B, a.n)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // levels l, l + 1, l + 2 from level l - 1 (the weights through perm
  // for l 1), each where it exists (its level below holds more than 16)
  for (int l = 1; level_len(a.n, l - 1) > kBase; l += 3) {
    const int n_src = level_len(a.n, l - 1);
    LevelOut o{};
    o.off1 = level_off(a.n, l);
    o.len1 = level_len(a.n, l);
    o.off2 = level_off(a.n, l + 1);
    o.len2 = o.len1 > kBase ? level_len(a.n, l + 1) : 0;
    o.off3 = level_off(a.n, l + 2);
    o.len3 = o.len2 > kBase ? level_len(a.n, l + 2) : 0;
    const dim3 grid((n_src + kScanSpan - 1) / kScanSpan, a.B);
    if (l == 1 && a.perm != nullptr && a.wt != nullptr) {
      const int groups = (a.B + kGroup - 1) / kGroup;
      doc_major_kernel<<<dim3((a.n + kThreads - 1) / kThreads, groups),
                         kThreads, 0, st>>>(a.w, a.B, a.n, a.wt);
      scan_levels_doc_major_kernel<<<dim3(grid.x, groups), kThreads, 0,
                                     st>>>(a.wt, a.perm, a.n, a.B, a.lev,
                                           a.lev_len, o);
    } else if (l == 1) {
      const bool vec = a.n % 4 == 0 && aligned16(a.w);
      if (a.perm != nullptr)
        scan_levels_kernel<true, false><<<grid, kThreads, 0, st>>>(
            a.w, a.n, a.perm, n_src, a.lev, a.lev_len, o);
      else if (vec)
        scan_levels_kernel<false, true><<<grid, kThreads, 0, st>>>(
            a.w, a.n, nullptr, n_src, a.lev, a.lev_len, o);
      else
        scan_levels_kernel<false, false><<<grid, kThreads, 0, st>>>(
            a.w, a.n, nullptr, n_src, a.lev, a.lev_len, o);
    } else {
      scan_levels_kernel<false, false><<<grid, kThreads, 0, st>>>(
          a.lev + level_off(a.n, l - 1), a.lev_len, nullptr, n_src, a.lev,
          a.lev_len, o);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((a.P + kThreads - 1) / kThreads, a.B);
  scan_points_kernel<<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// out[r] = x[r, :n].sum() in XLA's tree order; scratch holds every level
// pair's sums but the last (scratch_len = ordered_sum_scratch(n) floats a
// row).
extern "C" int ordered_sum(const float* x, float* scratch, int scratch_len,
                           float* out, int R, int n, void* stream) {
  if (R <= 0) return 0;
  if (n < 1 || scratch_len != ordered_sum_scratch(n))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* src = x;
  float* dst = scratch;
  for (;;) {
    const TreeLevel L = tree_level(R, n);
    if (L.k2 == 1) dst = out;
    const bool vec = aligned16(src) && (L.rp > 1 ||
                                        (n % 4 == 0 && L.lo1 % 4 == 0));
    const unsigned blocks =
        static_cast<unsigned>((L.tasks + kWarps - 1) / kWarps);
    if (vec)
      tree_pair_kernel<true><<<blocks, kThreads, 0, st>>>(src, dst, L);
    else
      tree_pair_kernel<false><<<blocks, kThreads, 0, st>>>(src, dst, L);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || L.k2 == 1) return static_cast<int>(err);
    src = dst;
    dst += static_cast<long long>(R) * L.k2;
    n = L.k2;
  }
}
