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
// csrc/bucket_stats.cu does.
//
// Entry `to_parent_fold`. The caller hands each position's index list
// as a CSR in ascending order (`order`, the indices stably sorted by
// target; `starts`, each position's first slot, [cap + 1]); a position
// that is nobody's target (a nested row) has an empty list. One thread
// per (row, position) folds its list: it reads the list's indices, the
// matched flag and the score of each in the row (both [B, cap]), and
// writes the count and the mode's value, [B, cap] each. Modes: 0 the
// count alone, 1 the sum, 2 the max, 3 the min. No atomics and no
// reassociation: every add is __fadd_rn, in list order.
//
// Subnormals as XLA's CPU runtime treats them: a score is flushed to a
// zero of its sign as it is read (`flush`), and the source is built
// with -ftz=true, so a subnormal sum flushes too (ops/ordered.ftz).
//
// What bounds it: the bytes, the [B, cap] scores and flags read once and
// the [B, cap] outputs written once; then the longest list (a parent
// with thousands of nested rows), one thread's chain of dependent adds.
// This first version makes no attempt at either: the reads follow each
// thread's list, not the warp's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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

__global__ void __launch_bounds__(kThreads)
to_parent_fold_kernel(const int* __restrict__ order,
                      const int* __restrict__ starts,
                      const float* __restrict__ score,
                      const unsigned char* __restrict__ ok,
                      float* __restrict__ count, float* __restrict__ value,
                      int cap, int mode) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= cap) return;
  const long long row = static_cast<long long>(blockIdx.y) * cap;
  const int s = __ldg(starts + p), e = __ldg(starts + p + 1);
  const bool largest = mode == 2;
  int cnt = 0;
  float acc = 0.0f;
  unsigned long long best = kNone;
  float best_v = 0.0f;
  for (int j = s; j < e; ++j) {
    const int i = __ldg(order + j);
    const bool m = __ldg(ok + row + i) != 0;
    cnt += m;
    if (mode == 1) {
      acc = __fadd_rn(acc, m ? flush(__ldg(score + row + i)) : 0.0f);
    } else if (mode >= 2 && m) {
      const float v = flush(__ldg(score + row + i));
      const unsigned long long k =
          rank_key(v, static_cast<unsigned>(i), largest);
      if (k < best) {
        best = k;
        best_v = v;
      }
    }
  }
  count[row + p] = static_cast<float>(cnt);
  if (mode == 1) value[row + p] = acc;
  else if (mode >= 2) value[row + p] = decode(best, best_v, largest);
}

}  // namespace

// order int32 [cap], starts int32 [cap + 1], score f32 [B, cap], ok bool
// [B, cap] -> count f32 [B, cap], value f32 [B, cap] (mode 0: unused)
extern "C" int to_parent_fold(const int* order, const int* starts,
                              const float* score, const unsigned char* ok,
                              float* count, float* value, int B, int cap,
                              int mode, void* stream) {
  if (B <= 0 || cap <= 0) return 0;
  if (B > 65535 || mode < 0 || mode > 3 || (mode > 0 && value == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((cap + kThreads - 1) / kThreads, B);
  to_parent_fold_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      order, starts, score, ok, count, value, cap, mode);
  return static_cast<int>(cudaGetLastError());
}
