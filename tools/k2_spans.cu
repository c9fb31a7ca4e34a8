// A third design of K2 (posting scatter-add), kept beside the port's for
// timing in turns (tools/unfused_variants.py); the port builds only
// elasticsearch_tpu_torch/ops/csrc/scatter_add.cu. Same contract and C
// interface as that file (the bucket size `sub` is checked, not used):
//
//   out[b, docs[b, n]] += vals[b, n]   for n ascending; docs outside
//                                      [0, cap) are dropped.
//
// Design, without the partition, with wide owners. A CTA of 4 warps owns
// a span of 16,384 docs of a row in shared memory (64 KiB) and writes it
// once, coalesced.
//   1. ranges: per (row, chunk of 128 postings), the lowest and highest
//      in-range doc of the chunk and whether its in-range docs strictly
//      ascend in n (then no doc repeats within the chunk);
//   2. accumulate: the CTA reads its row's chunk ranges 32 at a time and
//      keeps by ballot the chunks that meet its span, then takes them in
//      n order, a barrier each: an ascending chunk with one warp per 32
//      postings (no doc twice), any other with one warp, 32 postings at a
//      time, the lanes holding one doc matched and the first adding their
//      values in lane (= n) order. No float atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kChunk = 128;
constexpr int kSpan = 16384;
constexpr int kRangeWarps = 8;
constexpr int kAccWarps = kChunk / 32;
constexpr unsigned kFull = 0xffffffffu;

// 1. rng[b, c] = (lowest, highest, ascending) of chunk c's in-range docs
// (INT_MAX, INT_MIN where none)
__global__ void __launch_bounds__(32 * kRangeWarps)
span_ranges_kernel(const int* __restrict__ docs, int N, int cap, int nchunk,
                   int4* __restrict__ rng) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kRangeWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (c >= nchunk) return;
  const int* row = docs + static_cast<size_t>(b) * N;
  int lo = INT_MAX, hi = INT_MIN, carry = INT_MIN;
  bool asc = true;
#pragma unroll
  for (int k = 0; k < kChunk / 32; ++k) {
    const int n = c * kChunk + 32 * k + lane;
    const int d = n < N ? __ldg(row + n) : -1;
    const bool ok = d >= 0 && d < cap;
    // the highest in-range doc before this posting (inclusive scan of
    // max over the lanes, then shifted by one)
    int m = ok ? d : INT_MIN;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int y = __shfl_up_sync(kFull, m, s);
      if (lane >= s) m = max(m, y);
    }
    int before = __shfl_up_sync(kFull, m, 1);
    before = lane == 0 ? carry : max(before, carry);
    if (ok && d <= before) asc = false;
    carry = max(carry, __shfl_sync(kFull, m, 31));
    if (ok) {
      lo = min(lo, d);
      hi = max(hi, d);
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    lo = min(lo, __shfl_xor_sync(kFull, lo, s));
    hi = max(hi, __shfl_xor_sync(kFull, hi, s));
  }
  asc = __all_sync(kFull, asc);
  if (lane == 0)
    rng[static_cast<size_t>(b) * nchunk + c] = make_int4(lo, hi, asc, 0);
}

// 2. per (row, span): the chunks that meet the span, in n order
__global__ void __launch_bounds__(32 * kAccWarps)
span_accumulate_kernel(const int* __restrict__ docs,
                       const float* __restrict__ vals, int N, int cap,
                       int span, int nchunk, const int4* __restrict__ rng,
                       float* __restrict__ out) {
  extern __shared__ __align__(16) float s_acc[];  // [span]
  __shared__ float s_v[32];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int lo = blockIdx.x * span;
  const int hi = min(cap, lo + span);
  for (int i = threadIdx.x; i < span; i += 32 * kAccWarps) s_acc[i] = 0.0f;
  __syncthreads();
  const int* drow = docs + static_cast<size_t>(b) * N;
  const float* vrow = vals + static_cast<size_t>(b) * N;
  const int4* rrow = rng + static_cast<size_t>(b) * nchunk;
  for (int c0 = 0; c0 < nchunk; c0 += 32) {
    const int c = c0 + lane;
    const int4 r =
        c < nchunk ? __ldg(rrow + c) : make_int4(INT_MAX, INT_MIN, 0, 0);
    unsigned meet = __ballot_sync(kFull, r.x < hi && r.y >= lo);
    const unsigned asc = __ballot_sync(kFull, r.z != 0);
    while (meet != 0u) {
      const int bit = __ffs(meet) - 1;
      meet &= meet - 1u;
      const int cc = c0 + bit;
      if ((asc >> bit) & 1u) {
        const int n = cc * kChunk + 32 * w + lane;
        const int d = n < N ? __ldg(drow + n) : -1;
        if (d >= lo && d < hi)
          s_acc[d - lo] = __fadd_rn(s_acc[d - lo], __ldg(vrow + n));
      } else if (w == 0) {
        for (int k = 0; k < kChunk / 32; ++k) {
          const int n = cc * kChunk + 32 * k + lane;
          const int d = n < N ? __ldg(drow + n) : -1;
          const float v = n < N ? __ldg(vrow + n) : 0.0f;
          const bool mine = d >= lo && d < hi;
          const unsigned peers =
              __match_any_sync(kFull, mine ? d : -1 - lane);
          s_v[lane] = v;
          __syncwarp();
          if (mine && (peers & ((1u << lane) - 1u)) == 0u) {
            float a = s_acc[d - lo];
            for (unsigned m = peers; m != 0u; m &= m - 1u)
              a = __fadd_rn(a, s_v[__ffs(m) - 1]);
            s_acc[d - lo] = a;
          }
          __syncwarp();
        }
      }
      __syncthreads();
    }
  }
  float* orow = out + static_cast<size_t>(b) * cap;
  for (int i = threadIdx.x; i < hi - lo; i += 32 * kAccWarps)
    orow[lo + i] = s_acc[i];
}

bool scratch_bytes_of(int B, int N, int cap, int sub, size_t* bytes) {
  if (B > 65535 || N < 0 || sub <= 0 || sub % 4 != 0) return false;
  const size_t rows = B > 0 && cap > 0 ? static_cast<size_t>(B) : 0;
  const size_t nchunk = (static_cast<size_t>(N) + kChunk - 1) / kChunk;
  *bytes = sizeof(int4) * rows * nchunk;
  return true;
}

}  // namespace

extern "C" long long scatter_add_scratch(int B, int N, int cap, int sub) {
  size_t bytes;
  return scratch_bytes_of(B, N, cap, sub, &bytes)
             ? static_cast<long long>(bytes)
             : -1;
}

extern "C" int scatter_add(const int* docs, const float* vals, void* scratch,
                           long long scratch_bytes, float* out, int B, int N,
                           int cap, int sub, void* stream) {
  size_t bytes;
  if (!scratch_bytes_of(B, N, cap, sub, &bytes) ||
      scratch_bytes != static_cast<long long>(bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || cap <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int span = cap < kSpan ? cap : kSpan;
  const int nspan = (cap + span - 1) / span;
  const int nchunk = (N + kChunk - 1) / kChunk;
  int4* rng = static_cast<int4*>(scratch);
  const size_t smem = sizeof(float) * static_cast<size_t>(span);
  cudaError_t err = cudaFuncSetAttribute(
      span_accumulate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nchunk > 0)
    span_ranges_kernel<<<dim3((nchunk + kRangeWarps - 1) / kRangeWarps, B),
                         32 * kRangeWarps, 0, st>>>(docs, N, cap, nchunk,
                                                    rng);
  span_accumulate_kernel<<<dim3(nspan, B), 32 * kAccWarps, smem, st>>>(
      docs, vals, N, cap, span, nchunk, rng, out);
  return static_cast<int>(cudaGetLastError());
}
