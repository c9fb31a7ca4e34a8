// f32 agg sums in the reference's exact order, for Hopper (sm_90a).
//
// Not a TPU kernel: the reference computes these sums outside any Pallas
// kernel, with XLA's `cumsum` (elasticsearch_tpu/ops/aggs.py:123, :138,
// :84, :75) and `.sum(-1)` (:83, :101; masked_stats :235-236). The port
// must round them exactly as XLA does, on the CPU and on the card; the
// plain versions, which fix the two orders, are
// elasticsearch_tpu_torch/ops/ordered.py (`prefix_at`, `xla_block_sum`).
//
// Entry `ordered_prefix`: cs0[b, pos[g]] of cs0 = [0, cumsum(w[b, perm])]
// in XLA's order, a recursive blocked scan of base 16: blocks of 16
// (the last zero-padded) take their prefix sequentially from +0.0, the
// block totals are scanned the same way until 16 or fewer remain, and an
// output is fl(exclusive prefix of its block + intra-block prefix). Every
// level is independent across its blocks, so:
//   * level 0: one lane per 16-doc block of a row adds its block in
//     order, reading w[b, perm[i]] through perm (no gather pass; a warp
//     reads its 32 blocks' positions consecutively, through shared
//     memory), and writes the block total;
//   * levels above (2^16 -> 2^12 -> 2^8 -> 2^4 totals at cap 2^20): the
//     same kernel over the level below, without perm;
//   * points: one thread per (row, position) evaluates the prefix there
//     alone: from the topmost level its chain reaches down, the partial
//     prefix of each level's block (at most 16 adds each), added in.
// The prefix is never materialised over the whole row.
//
// Entry `ordered_sum`: x[r, :].sum() in XLA's reduction tree: while more
// than 32 values remain, k = ceil(n / 32) windows of ceil(n / k) values
// (the last zero-padded) each summed in order from +0.0; then the last
// ones in order. One thread per window, one launch per level; windows of
// 32 that tile their rows load through shared memory, coalesced.
//
// Zero padding, skipped or added, changes no sum: a sum started at
// +0.0 is never -0.0 under round-to-nearest, and s + 0.0 == s otherwise.
// Every add is __fadd_rn (no FMA contraction; built without
// --use_fast_math), no atomics: each output is the reference's bits,
// deterministic.
//
// What bounds it: bytes. ordered_prefix reads each weight once (the
// level totals are 1/16 of that and smaller) plus perm: about 1 GiB at
// B 256 x 2^20 docs. ordered_sum reads its input once.

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
};

namespace {

constexpr int kBase = 16;     // ops/ordered.SCAN_BASE
constexpr int kWindow = 32;   // ops/ordered.SUM_WINDOW
constexpr int kThreads = 256;

// the length of scan level l >= 1: ceil(len(l - 1) / 16), len(0) = n
__device__ __host__ __forceinline__ int level_len(int n, int l) {
  for (int k = 0; k < l; ++k) n = (n + kBase - 1) / kBase;
  return n;
}

__device__ __forceinline__ long long level_off(int n, int l) {
  long long off = 0;
  for (int k = 1; k < l; ++k) off += level_len(n, k);
  return off;
}

// dst[b, j] = the in-order sum of src[b, 16j .. 16j + 15] (through perm).
// A warp takes 32 consecutive blocks: its lanes read consecutive
// positions (perm and, for a key-sorted perm, the weights too, near
// coalesced) into shared memory, then each lane adds its own block in
// order (rows of 17 words).
__global__ void __launch_bounds__(kThreads)
level_totals_kernel(const float* __restrict__ src, long long src_stride,
                    const int* __restrict__ perm, int n_src,
                    float* __restrict__ dst, long long dst_stride, int n_dst) {
  __shared__ float s_tile[kThreads / 32][32][kBase + 1];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int j0 = (blockIdx.x * (kThreads / 32) + w) * 32;  // first block
  if (j0 >= n_dst) return;
  const float* row = src + blockIdx.y * src_stride;
  const int i0 = j0 * kBase;
#pragma unroll 4
  for (int k = 0; k < kBase; ++k) {
    const int e = 32 * k + lane, i = i0 + e;
    float v = 0.0f;
    if (i < n_src) v = __ldg(row + (perm != nullptr ? __ldg(perm + i) : i));
    s_tile[w][e / kBase][e % kBase] = v;
  }
  __syncwarp();
  const int j = j0 + lane;
  if (j >= n_dst) return;
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < kBase; ++k) s = __fadd_rn(s, s_tile[w][lane][k]);
  dst[blockIdx.y * dst_stride + j] = s;
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
      r = l == top ? s : __fadd_rn(r, s);
    }
  }
  a.out[static_cast<long long>(b) * a.P + g] = r;
}

// dst[r, j] = the in-order sum of src[r, j * w .. min(n, (j + 1) * w))
__global__ void __launch_bounds__(kThreads)
window_sums_kernel(const float* __restrict__ src, int n, int w, int k,
                   float* __restrict__ dst, long long total) {
  const long long o = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (o >= total) return;
  const long long r = o / k;
  const int j = static_cast<int>(o - r * k);
  const float* row = src + r * n;
  const int i1 = min(n, (j + 1) * w);
  float s = 0.0f;
  for (int i = j * w; i < i1; ++i) s = __fadd_rn(s, __ldg(row + i));
  dst[o] = s;
}

// The same for windows of 32 that tile their rows (n == 32 k): the windows
// of consecutive outputs are consecutive in memory, so a warp loads 32
// windows through shared memory, coalesced, and each lane adds its own
// window in order (rows of 33 words: no bank conflicts).
__global__ void __launch_bounds__(kThreads)
window32_sums_kernel(const float* __restrict__ src, float* __restrict__ dst,
                     long long total) {
  __shared__ float s_tile[kThreads / 32][32][33];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long o0 =
      (static_cast<long long>(blockIdx.x) * (kThreads / 32) + w) * 32;
#pragma unroll 4
  for (int i = 0; i < 32; ++i)
    s_tile[w][i][lane] =
        o0 + i < total ? __ldg(src + (o0 + i) * kWindow + lane) : 0.0f;
  __syncwarp();
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < kWindow; ++k) s = __fadd_rn(s, s_tile[w][lane][k]);
  if (o0 + lane < total) dst[o0 + lane] = s;
}

}  // namespace

// floats of scratch a row of n needs for its scan levels
extern "C" int ordered_prefix_scratch(int n) {
  int total = 0;
  for (int l = 1; level_len(n, l - 1) > kBase; ++l) total += level_len(n, l);
  return total;
}

// floats of scratch a row of n needs for the tree's levels but the last
extern "C" int ordered_sum_scratch(int n) {
  int total = 0;
  while (n > kWindow) {
    n = (n + kWindow - 1) / kWindow;
    total += n;
  }
  return total;
}

extern "C" int ordered_prefix(const ScanArgs* args, void* stream) {
  const ScanArgs a = *args;
  if (a.B <= 0 || a.P <= 0) return 0;
  if (a.B > 65535 || a.n < 0 || a.lev_len != ordered_prefix_scratch(a.n))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // level l's totals from level l - 1 (the weights through perm for l 1)
  for (int l = 1; level_len(a.n, l - 1) > kBase; ++l) {
    const int n_src = level_len(a.n, l - 1), n_dst = level_len(a.n, l);
    long long off_src = 0;
    for (int k = 1; k < l - 1; ++k) off_src += level_len(a.n, k);
    const long long off_dst = off_src + (l > 1 ? level_len(a.n, l - 1) : 0);
    const dim3 grid((n_dst + kThreads - 1) / kThreads, a.B);
    if (l == 1)
      level_totals_kernel<<<grid, kThreads, 0, st>>>(
          a.w, a.n, a.perm, n_src, a.lev, a.lev_len, n_dst);
    else
      level_totals_kernel<<<grid, kThreads, 0, st>>>(
          a.lev + off_src, a.lev_len, nullptr, n_src, a.lev + off_dst,
          a.lev_len, n_dst);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((a.P + kThreads - 1) / kThreads, a.B);
  scan_points_kernel<<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// out[r] = x[r, :n].sum() in XLA's tree order; scratch holds every level
// but the last (scratch_len = ordered_sum_scratch(n) floats a row).
extern "C" int ordered_sum(const float* x, float* scratch, int scratch_len,
                           float* out, int R, int n, void* stream) {
  if (R <= 0) return 0;
  if (n < 1 || scratch_len != ordered_sum_scratch(n))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* src = x;
  float* dst = scratch;
  for (;;) {
    const int k = n > kWindow ? (n + kWindow - 1) / kWindow : 1;
    const int w = (n + k - 1) / k;
    if (k == 1) dst = out;
    const long long total = static_cast<long long>(R) * k;
    const unsigned blocks =
        static_cast<unsigned>((total + kThreads - 1) / kThreads);
    if (w == kWindow && n == kWindow * k)
      window32_sums_kernel<<<static_cast<unsigned>((total + kThreads - 1) /
                                                   kThreads),
                             kThreads, 0, st>>>(src, dst, total);
    else
      window_sums_kernel<<<blocks, kThreads, 0, st>>>(src, n, w, k, dst,
                                                      total);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || k == 1) return static_cast<int>(err);
    src = dst;
    dst += static_cast<long long>(R) * k;
    n = k;
  }
}
