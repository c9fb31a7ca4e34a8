// The block join's to-parent fold, for Hopper (sm_90a): per (row,
// parent), the count, the sum, the max or the min of the child scores
// that target the parent, each the reference's exact f32 result.
//
// Not a TPU kernel: the reference's `nested` query projects its child
// scores onto their parents with XLA scatters outside any Pallas kernel
// (elasticsearch_tpu/search/executor.py:1759-1779: `.at[:, target].add`
// of the matched flags and of where(ok, score, 0), `.at[:, target].max`
// of where(ok, score, -inf), `.at[:, target].min` of where(ok, score,
// +inf)). XLA's CPU scatter walks the indices in ascending order, so
// each parent's sum is a left fold from +0.0 over every index i with
// target[i] == parent, in ascending i: its nested rows (laid out before
// it) and the parent itself, matched or not (an unmatched index adds
// +0.0, which changes no sum started at +0.0). The plain version, which
// states the results, is elasticsearch_tpu_torch/ops/ordered.py
// `parent_fold`; max and min keep XLA's NaN-propagating compares with
// -0.0 below +0.0 through the integer rank keys of `ordered.extreme_keys`
// (smaller preferred; the surviving NaN fixed by the index order), as
// csrc/bucket_stats.cu does. Modes: 0 the count alone, 1 the sum, 2 the
// max, 3 the min; count and value are f32 [B, cap]. No atomics and no
// reassociation: every add is __fadd_rn, in list order.
//
// Subnormals as XLA's CPU runtime treats them: a score is flushed to a
// zero of its sign as it is read (`flush`), and the source is built
// with -ftz=true, so a subnormal sum flushes too (ops/ordered.ftz).
//
// What bounds it: the bytes, the [B, cap] scores and flags read once and
// the [B, cap] outputs written once (13 bytes a cell for a value mode);
// then the longest list, whose sum is one chain of dependent adds (5,001
// rows for the nested shard's hottest question: ~10 us at an add's
// latency, against 0.13 ms of bytes at [32, 2^20]). The first version, a
// thread per (row, position) walking an index list, reached neither:
// four threads in five held a nested row and exited, each parent's
// thread followed a chain of dependent loads (index, flag, score) of its
// own, and the warp waited on its longest list (7x the bytes bound at
// [32, 2^20], PERF.md).
//
// The layout the port builds makes that list a range. Nested rows sit
// just before their parent and a primary row targets itself
// (search/executor.device_arrays), so each position's list is the run
// of rows that ends at the position itself: the index order is the
// identity and `starts` alone gives every list (cuda_scoring
// `block_join_layout` checks this and refuses a layout without it). The
// kernel reads ranges:
//   * a CTA takes one row and a span of kSpan consecutive positions,
//     at least kCtasPerSm CTAs an SM, so that enough loads are in
//     flight: it stages the span's starts, scores (flushed) and flags in
//     shared memory with 16-byte loads. Lists are disjoint runs in
//     position order, so only the span's first list can begin before
//     the span: a short one reads those few rows from device memory;
//   * each thread folds the lists of its kSpan / kThreads positions
//     (consecutive across the warp, so the writes coalesce) out of
//     shared memory: the sum one left fold from +0.0 in ascending row
//     order, as the reference's, at an add's latency per row;
//   * a list longer than `long_len` (a hot question's answers) goes to a
//     warp of its own, in CTAs that come first in the grid so that they
//     start first: the warp reads 32 rows at a time coalesced, the next
//     32 issued before the current ones are folded, and every lane folds
//     them in order from a shuffle (the sum the same left fold); count,
//     max and min, which need no order, are a ballot and a warp
//     reduction of the rank keys.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSpan = 2048;               // positions of a span CTA
constexpr int kCtasPerSm = 4;             // ... resident on an SM, at least
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNone = 3ull << 32;   // no matched index

// a subnormal -> a zero of its sign; any other value unchanged
__device__ __forceinline__ float flush(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x7f800000u) ? x : __uint_as_float(u & 0x80000000u);
}

// f32 bits -> monotone in value, -0.0 below +0.0 (ordered.float_order_bits)
__device__ __forceinline__ unsigned order_bits(unsigned u) {
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// rank keys (ordered.extreme_keys) of the value at index g: a NaN ranks
// by its place in the fold, a number by its order bits
__device__ __forceinline__ unsigned long long rank_key(float v, unsigned g,
                                                       bool largest) {
  const unsigned u = __float_as_uint(v);
  if (v != v) {
    // the NaN kind kept first (minimum: sign clear; maximum: sign set),
    // the other kind's last
    const bool first = largest ? (u >> 31) != 0 : (u >> 31) == 0;
    return first ? static_cast<unsigned long long>(g)
                 : ((1ull << 32) | static_cast<unsigned>(~g));
  }
  const unsigned ord = order_bits(u);
  return (2ull << 32) | (largest ? ~ord : ord);
}

// a reduced key back to its value: a NaN's own bits, a number's from its
// order bits, no matched index: the scatter's initial +-inf
__device__ __forceinline__ float decode(unsigned long long key, float v,
                                        bool largest) {
  if (key >= kNone) return largest ? -__int_as_float(0x7f800000)
                                   : __int_as_float(0x7f800000);
  if ((key >> 32) < 2) return v;
  const unsigned lo = static_cast<unsigned>(key);
  const unsigned ord = largest ? ~lo : lo;
  return __uint_as_float((ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord);
}

// one list's running result: count, the sum, the best key and its value
struct Fold {
  int cnt = 0;
  float acc = 0.0f;
  unsigned long long best = kNone;
  float best_v = 0.0f;

  // index g, matched m, its flushed score v
  __device__ __forceinline__ void add(bool m, float v, int g, int mode) {
    cnt += m;
    if (mode == 1) {
      acc = __fadd_rn(acc, m ? v : 0.0f);
    } else if (mode >= 2 && m) {
      const unsigned long long k =
          rank_key(v, static_cast<unsigned>(g), mode == 2);
      if (k < best) {
        best = k;
        best_v = v;
      }
    }
  }

  __device__ __forceinline__ void store(float* count, float* value,
                                        size_t o, int mode) const {
    count[o] = static_cast<float>(cnt);
    if (mode == 1) value[o] = acc;
    else if (mode >= 2) value[o] = decode(best, best_v, mode == 2);
  }
};

// A long list [s, e) of position p in row b, by one warp: 32 rows a
// step, read coalesced, the next step's issued before this one's fold.
__device__ __forceinline__ void fold_long(int p, int s, int e, size_t row,
                                          const float* __restrict__ score,
                                          const unsigned char* __restrict__ ok,
                                          float* count, float* value,
                                          int mode, int lane) {
  Fold f;
  const int j = s + lane;
  bool m = j < e && __ldg(ok + row + j) != 0;
  float v = mode != 0 && j < e ? flush(__ldg(score + row + j)) : 0.0f;
  for (int j0 = s; j0 < e; j0 += 32) {
    const int jn = j0 + 32 + lane;
    const bool mn = jn < e && __ldg(ok + row + jn) != 0;
    const float vn =
        mode != 0 && jn < e ? flush(__ldg(score + row + jn)) : 0.0f;
    f.cnt += __popc(__ballot_sync(kFull, m));
    if (mode == 1) {
      // every lane folds the step's rows in order, the same chain
      const float x = m ? v : 0.0f;
      const int n = min(32, e - j0);
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        const float y = __shfl_sync(kFull, x, q);
        if (q < n) f.acc = __fadd_rn(f.acc, y);
      }
    } else if (mode >= 2 && m) {
      const unsigned long long k =
          rank_key(v, static_cast<unsigned>(j0 + lane), mode == 2);
      if (k < f.best) {
        f.best = k;
        f.best_v = v;
      }
    }
    m = mn;
    v = vn;
  }
  if (mode >= 2) {
    // equal keys are equal numbers (a NaN's key holds its index)
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const unsigned long long k = __shfl_xor_sync(kFull, f.best, d);
      const float kv = __shfl_xor_sync(kFull, f.best_v, d);
      if (k < f.best) {
        f.best = k;
        f.best_v = kv;
      }
    }
  }
  if (lane == 0) f.store(count, value, row + p, mode);
}

// CTAs [0, long_ctas): a warp per (long list, row); the rest: a CTA per
// (row, span of kSpan positions), several an SM.
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
to_parent_fold_kernel(const int* __restrict__ starts,
                      const int* __restrict__ longs,
                      const float* __restrict__ score,
                      const unsigned char* __restrict__ ok,
                      float* __restrict__ count, float* __restrict__ value,
                      int B, int cap, int mode, int long_len, int n_long,
                      int long_ctas, int n_spans, int vec) {
  __shared__ __align__(16) float s_v[kSpan];
  __shared__ __align__(16) int s_st[kSpan + 4];
  __shared__ __align__(16) unsigned char s_ok[kSpan];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (static_cast<int>(blockIdx.x) < long_ctas) {
    const long long job =
        static_cast<long long>(blockIdx.x) * kWarps + warp;
    if (job >= static_cast<long long>(n_long) * B) return;
    const int li = static_cast<int>(job / B);
    const int b = static_cast<int>(job - static_cast<long long>(li) * B);
    const int p = __ldg(longs + li);
    fold_long(p, __ldg(starts + p), __ldg(starts + p + 1),
              static_cast<size_t>(b) * cap, score, ok, count, value, mode,
              lane);
    return;
  }
  const int item = static_cast<int>(blockIdx.x) - long_ctas;
  const int b = item / n_spans;
  const int t0 = (item - b * n_spans) * kSpan;
  const int t1 = min(cap, t0 + kSpan);
  const size_t row = static_cast<size_t>(b) * cap;
  // the span's starts, scores (flushed; the count alone, mode 0, reads
  // none) and flags, with 16-byte loads where whole and aligned (the
  // entry checked the alignment)
  if (vec && t1 - t0 == kSpan) {
    for (int i = tid; i < kSpan / 4; i += kThreads) {
      reinterpret_cast<int4*>(s_st)[i] =
          __ldg(reinterpret_cast<const int4*>(starts + t0) + i);
      if (mode != 0) {
        const float4 x =
            __ldg(reinterpret_cast<const float4*>(score + row + t0) + i);
        reinterpret_cast<float4*>(s_v)[i] =
            make_float4(flush(x.x), flush(x.y), flush(x.z), flush(x.w));
      }
      if (i < kSpan / 16)
        reinterpret_cast<uint4*>(s_ok)[i] =
            __ldg(reinterpret_cast<const uint4*>(ok + row + t0) + i);
    }
  } else {
    for (int j = t0 + tid; j < t1; j += kThreads) {
      s_st[j - t0] = __ldg(starts + j);
      if (mode != 0) s_v[j - t0] = flush(__ldg(score + row + j));
      s_ok[j - t0] = __ldg(ok + row + j);
    }
  }
  if (tid == 0) s_st[t1 - t0] = __ldg(starts + t1);
  __syncthreads();
  // each position's list [s, e): runs in position order, so only the
  // span's first list can begin before the span
#pragma unroll 2
  for (int p = t0 + tid; p < t1; p += kThreads) {
    const int s = s_st[p - t0], e = s_st[p - t0 + 1];
    if (e - s > long_len) continue;
    Fold f;
    for (int j = s; j < min(e, t0); ++j) {
      const bool m = __ldg(ok + row + j) != 0;
      f.add(m, m ? flush(__ldg(score + row + j)) : 0.0f, j, mode);
    }
    for (int j = max(s, t0); j < e; ++j) {
      const bool m = s_ok[j - t0] != 0;
      f.add(m, m ? s_v[j - t0] : 0.0f, j, mode);
    }
    f.store(count, value, row + p, mode);
  }
}

}  // namespace

// starts int32 [cap + 1]: position p's list is the rows [starts[p],
// starts[p + 1]), each a run ending at p or empty; longs int32 [n_long]:
// the positions whose list is longer than long_len, in any order (a warp
// each; the span CTAs skip them); score f32 [B, cap], ok bool [B, cap]
// -> count f32 [B, cap], value f32 [B, cap] (mode 0: unused)
extern "C" int to_parent_fold(const int* starts, const int* longs,
                              int n_long, int long_len,
                              const float* score, const unsigned char* ok,
                              float* count, float* value, int B, int cap,
                              int mode, void* stream) {
  if (B <= 0 || cap <= 0) return 0;
  if (mode < 0 || mode > 3 || (mode > 0 && value == nullptr) ||
      n_long < 0 || long_len < 0 || (n_long > 0 && longs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long long_ctas =
      (static_cast<long long>(n_long) * B + kWarps - 1) / kWarps;
  const long long n_spans = (cap + kSpan - 1) / kSpan;
  const long long n_ctas = long_ctas + n_spans * B;
  if (n_ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (cap % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(score) |
                     reinterpret_cast<uintptr_t>(ok) |
                     reinterpret_cast<uintptr_t>(starts)) & 15u) == 0)
                      ? 1 : 0;
  to_parent_fold_kernel<<<static_cast<unsigned>(n_ctas), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      starts, longs, score, ok, count, value, B, cap, mode, long_len,
      n_long, static_cast<int>(long_ctas), static_cast<int>(n_spans), vec);
  return static_cast<int>(cudaGetLastError());
}
