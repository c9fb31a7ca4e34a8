// Bucket sums in the reference's exact f32 order, for Hopper (sm_90a).
//
// Not a TPU kernel: the reference sums a metric per bucket with XLA's
// scatter, `jnp.zeros(n).at[ids].add(where(mask, v, 0), mode="drop")`
// (elasticsearch_tpu/ops/aggs.py:25-32: bucket_sums, bucket_sum_sq),
// outside any Pallas kernel. For each row and bucket that is a left fold
// from +0.0 over the bucket's docs in ascending doc order; the plain
// version, which states that order, is
// elasticsearch_tpu_torch/ops/ordered.py `bucket_fold`.
//
// Entry `ordered_bucket_sum`: out[b, j] = that fold of v[d] (v*v with
// `square`) over the docs d of bucket j matched in row b. The caller
// hands the docs in bucket order (a stable sort of the wrapped ids:
// `order`, the bucket of each sorted position `sorted_b`, and each
// bucket's first position `starts`; dropped ids sort last, past
// starts[n_buckets]), and zeroes `out`.
//
//   * A CTA owns, for one row, the buckets that start in a span of
//     kSpan sorted positions, and walks them in tiles of kTile
//     positions: seven loader warps read the docs' mask bytes and
//     values, compact the matched ones in order (ballot + popc) into a
//     shared-memory tile, while warp 0 folds the tile before it (double
//     buffered, one barrier a tile).
//   * Warp 0 folds 32 compacted docs a round: every lane sums, from its
//     bucket's carried sum (or +0.0), the round's docs of its bucket in
//     lane order, adding +0.0 for the others (selected before the adds;
//     a round of one bucket, the hot bucket's usual, selects nothing);
//     the last lane of each bucket run writes it, the round's last
//     bucket carries over. No atomics, no reassociation: one dependent
//     add per matched doc.
//   * Unmatched docs are skipped and the +0.0 adds change nothing: a sum
//     started at +0.0 is never -0.0 under round-to-nearest, and
//     s + 0.0 == s otherwise.
//
// What bounds it: the dependent adds of the hottest (row, bucket), one
// per matched doc at the add's latency; the bytes (the [B, cap] mask
// once, the values and bucket order once a row from L2) come second,
// but the mask is gathered through `order`: with many small buckets each
// byte costs a 32-byte sector.
// Rows and buckets run in parallel across CTAs. Every add is __fadd_rn
// and every square __fmul_rn (no FMA contraction).

#include <cuda_runtime.h>
#include <stdint.h>

// entry `ordered_bucket_sum`'s arguments (cuda_scoring._BucketArgs)
struct BucketArgs {
  const int* order;           // [cap] docs in bucket order
  const int* sorted_b;        // [cap] bucket of each sorted position
  const int* starts;          // [n_buckets + 1]; starts[n_buckets] = kept
  const unsigned char* mask;  // [B, cap] bool
  const float* values;        // [cap] in bucket order: values[order]
  float* out;                 // [B, n_buckets], zeroed
  int B, cap, n_buckets, square;
};

namespace {

constexpr int kThreads = 256;
constexpr int kLoaders = kThreads / 32 - 1;   // warps 1..7
constexpr int kTile = 1024;                   // sorted positions a tile
constexpr int kSteps = kTile / 32;            // 32 loader steps a tile
constexpr int kPer = (kSteps + kLoaders - 1) / kLoaders;
constexpr int kSpan = 16384;                  // positions a CTA starts in

// the first sorted position >= p at which a bucket starts
__device__ __forceinline__ int bucket_start_at(const BucketArgs& a, int p,
                                               int total) {
  if (p <= 0) return 0;
  if (p >= total) return total;
  const int bp = __ldg(a.sorted_b + p);
  if (__ldg(a.sorted_b + p - 1) != bp) return p;
  return __ldg(a.starts + bp + 1);
}

// loader warps 1..7: the matched docs of sorted positions [q, q + kTile)
// (not past p1), compacted in order into s_v / s_b; returns their count
__device__ __forceinline__ void load_tile(const BucketArgs& a,
                                          const unsigned char* mrow, int q,
                                          int p1, int lw, int lane,
                                          float* s_v, int* s_b, int* s_cnt,
                                          int* s_n) {
  // two rounds of independent loads: the docs with their buckets and
  // values (in bucket order, coalesced), then their mask bytes
  float x[kPer];
  int b[kPer], d[kPer];
  unsigned bal[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int s = lw + u * kLoaders, i = q + s * 32 + lane;
    const bool ok = s < kSteps && i < p1;
    d[u] = ok ? __ldg(a.order + i) : -1;
    b[u] = ok ? __ldg(a.sorted_b + i) : -1;
    x[u] = ok ? __ldg(a.values + i) : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const bool m = d[u] >= 0 && __ldg(mrow + d[u]) != 0;
    if (a.square) x[u] = __fmul_rn(x[u], x[u]);
    bal[u] = __ballot_sync(~0u, m);
    const int s = lw + u * kLoaders;
    if (lane == 0 && s < kSteps) s_cnt[s] = __popc(bal[u]);
  }
  asm volatile("bar.sync 1, %0;" ::"r"(kLoaders * 32));
  // each step's place: an exclusive scan of the 32 steps' counts
  const int c = s_cnt[lane];
  int inc = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(~0u, inc, o);
    if (lane >= o) inc += y;
  }
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int s = lw + u * kLoaders;
    if (s < kSteps) {
      const int off = __shfl_sync(~0u, inc, s) - __shfl_sync(~0u, c, s);
      if ((bal[u] >> lane) & 1u) {
        const int slot = off + __popc(bal[u] & lt);
        s_v[slot] = x[u];
        s_b[slot] = b[u];
      }
    }
  }
  // the tile's count, and bucket -1 past it up to a whole round
  const int n = __shfl_sync(~0u, inc, 31);
  if (lw == 0) {
    if (lane == 0) *s_n = n;
    if (n % 32 != 0 && lane < 32 - n % 32) s_b[n + lane] = -1;
  }
}

// warp 0: fold a tile's n compacted docs onto the carried bucket sum, a
// round of 32 at a time, in two halves of 16: their values and buckets
// in registers first (16-byte loads), then one dependent add per entry
__device__ __forceinline__ void fold_tile(const float* s_v, const int* s_b,
                                          int n, int lane, float* orow,
                                          float& carry, int& carry_b) {
  for (int base = 0; base < n; base += 32) {
    const int cnt = min(32, n - base);
    const int bl = s_b[base + lane];          // -1 past the tile's count
    const int b0 = s_b[base];
    // one bucket over the whole round (the hot bucket's usual): every
    // value is the lane's own
    const bool one = b0 == s_b[base + 31];
    if (lane == 0 && carry_b >= 0 && carry_b != b0) orow[carry_b] = carry;
    float s = bl == carry_b ? carry : 0.0f;
#pragma unroll
    for (int h = 0; h < 32; h += 16) {
      float v[16];
      int bk[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 x4 =
            *reinterpret_cast<const float4*>(s_v + base + h + 4 * q);
        const int4 b4 = *reinterpret_cast<const int4*>(s_b + base + h + 4 * q);
        v[4 * q] = x4.x;
        v[4 * q + 1] = x4.y;
        v[4 * q + 2] = x4.z;
        v[4 * q + 3] = x4.w;
        bk[4 * q] = b4.x;
        bk[4 * q + 1] = b4.y;
        bk[4 * q + 2] = b4.z;
        bk[4 * q + 3] = b4.w;
      }
      if (!one) {
        // the other buckets' values become +0.0 first, off the chain
#pragma unroll
        for (int k = 0; k < 16; ++k) v[k] = bk[k] == bl ? v[k] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) s = __fadd_rn(s, v[k]);
    }
    const int next = __shfl_down_sync(~0u, bl, 1);
    if (lane + 1 < cnt && next != bl) orow[bl] = s;
    carry = __shfl_sync(~0u, s, cnt - 1);
    carry_b = __shfl_sync(~0u, bl, cnt - 1);
  }
}

__global__ void __launch_bounds__(kThreads)
bucket_fold_kernel(const __grid_constant__ BucketArgs a) {
  __shared__ __align__(16) float s_v[2][kTile];
  __shared__ __align__(16) int s_b[2][kTile];
  __shared__ int s_cnt[kSteps];
  __shared__ int s_n[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int total = __ldg(a.starts + a.n_buckets);
  const long long q0 = static_cast<long long>(blockIdx.x) * kSpan;
  if (q0 >= total) return;
  const int p0 = bucket_start_at(a, static_cast<int>(q0), total);
  const int p1 = bucket_start_at(
      a, static_cast<int>(min(q0 + kSpan, static_cast<long long>(total))),
      total);
  if (p0 >= p1) return;
  const int n_tiles = (p1 - p0 + kTile - 1) / kTile;
  const unsigned char* mrow =
      a.mask + static_cast<long long>(blockIdx.y) * a.cap;
  float* orow = a.out + static_cast<long long>(blockIdx.y) * a.n_buckets;
  float carry = 0.0f;
  int carry_b = -1;
  // warps 1..7 load tile t + 1 into buffer (t + 1) & 1 while warp 0
  // folds tile t: one barrier a tile
  if (warp != 0)
    load_tile(a, mrow, p0, p1, warp - 1, lane, s_v[0], s_b[0], s_cnt,
              &s_n[0]);
  __syncthreads();
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (warp != 0) {
      if (t + 1 < n_tiles)
        load_tile(a, mrow, p0 + (t + 1) * kTile, p1, warp - 1, lane,
                  s_v[buf ^ 1], s_b[buf ^ 1], s_cnt, &s_n[buf ^ 1]);
    } else {
      fold_tile(s_v[buf], s_b[buf], s_n[buf], lane, orow, carry, carry_b);
    }
    __syncthreads();
  }
  if (warp == 0 && lane == 0 && carry_b >= 0) orow[carry_b] = carry;
}

}  // namespace

extern "C" int ordered_bucket_sum(const BucketArgs* args, void* stream) {
  const BucketArgs a = *args;
  if (a.B <= 0 || a.cap <= 0 || a.n_buckets <= 0) return 0;
  if (a.B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.cap + kSpan - 1) / kSpan, a.B);
  bucket_fold_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}
