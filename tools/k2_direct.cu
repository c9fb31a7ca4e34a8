// A second design of K2 (posting scatter-add), kept beside the port's for
// timing in turns (tools/unfused_variants.py); the port builds only
// elasticsearch_tpu_torch/ops/csrc/scatter_add.cu. Same contract and C
// interface as that file:
//
//   out[b, docs[b, n]] += vals[b, n]   for n ascending; docs outside
//                                      [0, cap) are dropped.
//
// Design, without the partition. A row's docs split into buckets of `sub`
// docs, each owned by one warp that accumulates it in shared memory and
// writes it once, coalesced; a CTA holds 4 consecutive buckets.
//   1. ranges: per (row, chunk of 128 postings), the lowest and highest
//      in-range doc of the chunk (a warp a chunk);
//   2. accumulate: each warp reads its row's chunk ranges 32 at a time,
//      keeps by ballot the chunks whose range meets its bucket, and walks
//      those in n order, 32 postings at a time; within 32, the lanes
//      holding one doc are matched and the first adds their values in
//      lane (= n) order. No float atomics.
// A chunk whose docs spread over many buckets is read by every owner it
// meets (rare terms: each 128-posting block spans the capacity).

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kChunk = 128;
constexpr int kRangeWarps = 8;
constexpr int kAccWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

// 1. rng[b, c] = (lowest, highest) in-range doc of chunk c (INT_MAX,
// INT_MIN where none)
__global__ void __launch_bounds__(32 * kRangeWarps)
chunk_ranges_kernel(const int* __restrict__ docs, int N, int cap,
                    int nchunk, int2* __restrict__ rng) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kRangeWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (c >= nchunk) return;
  const int* row = docs + static_cast<size_t>(b) * N;
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int k = 0; k < kChunk / 32; ++k) {
    const int n = c * kChunk + 32 * k + lane;
    const int d = n < N ? __ldg(row + n) : -1;
    if (d >= 0 && d < cap) {
      lo = min(lo, d);
      hi = max(hi, d);
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    lo = min(lo, __shfl_xor_sync(kFull, lo, s));
    hi = max(hi, __shfl_xor_sync(kFull, hi, s));
  }
  if (lane == 0) rng[static_cast<size_t>(b) * nchunk + c] = make_int2(lo, hi);
}

// 2. per (row, 4 buckets): each warp its bucket's docs in shared memory,
// the chunks that meet it in n order, 32 postings at a time
__global__ void __launch_bounds__(32 * kAccWarps)
direct_accumulate_kernel(const int* __restrict__ docs,
                         const float* __restrict__ vals, int N, int cap,
                         int sub, int nbkt, int nchunk,
                         const int2* __restrict__ rng,
                         float* __restrict__ out) {
  extern __shared__ __align__(16) float s_acc[];  // [4][sub]
  __shared__ float s_v[kAccWarps][32];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int q = blockIdx.x * kAccWarps + w;
  if (q >= nbkt) return;
  const int wlo = q * sub;
  const int whi = min(cap, wlo + sub);
  float* acc = s_acc + w * sub;
  for (int i = lane; i < sub; i += 32) acc[i] = 0.0f;
  __syncwarp();
  const int* drow = docs + static_cast<size_t>(b) * N;
  const float* vrow = vals + static_cast<size_t>(b) * N;
  const int2* rrow = rng + static_cast<size_t>(b) * nchunk;
  for (int c0 = 0; c0 < nchunk; c0 += 32) {
    const int c = c0 + lane;
    const int2 r = c < nchunk ? __ldg(rrow + c) : make_int2(INT_MAX, INT_MIN);
    unsigned meet = __ballot_sync(kFull, r.x < whi && r.y >= wlo);
    while (meet != 0u) {
      const int cc = c0 + __ffs(meet) - 1;
      meet &= meet - 1u;
      for (int k = 0; k < kChunk / 32; ++k) {
        const int n = cc * kChunk + 32 * k + lane;
        const int d = n < N ? __ldg(drow + n) : -1;
        const float v = n < N ? __ldg(vrow + n) : 0.0f;
        const bool mine = d >= wlo && d < whi;
        const unsigned peers = __match_any_sync(kFull, mine ? d : -1 - lane);
        s_v[w][lane] = v;
        __syncwarp();
        if (mine && (peers & ((1u << lane) - 1u)) == 0u) {
          float a = acc[d - wlo];
          for (unsigned m = peers; m != 0u; m &= m - 1u)
            a = __fadd_rn(a, s_v[w][__ffs(m) - 1]);
          acc[d - wlo] = a;
        }
        __syncwarp();
      }
    }
  }
  float* orow_out = out + static_cast<size_t>(b) * cap;
  const int len = whi - wlo;
  if ((cap & 3) == 0 && (sub & 3) == 0) {
    for (int i = 4 * lane; i < len; i += 128)
      *reinterpret_cast<float4*>(orow_out + wlo + i) =
          *reinterpret_cast<const float4*>(acc + i);
  } else {
    for (int i = lane; i < len; i += 32) orow_out[wlo + i] = acc[i];
  }
}

bool scratch_bytes_of(int B, int N, int cap, int sub, size_t* bytes) {
  if (B > 65535 || N < 0 || sub <= 0 || sub % 4 != 0) return false;
  const size_t rows = B > 0 && cap > 0 ? static_cast<size_t>(B) : 0;
  const size_t nchunk = (static_cast<size_t>(N) + kChunk - 1) / kChunk;
  *bytes = sizeof(int2) * rows * nchunk;
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
  const int nbkt = (cap + sub - 1) / sub;
  const int nchunk = (N + kChunk - 1) / kChunk;
  int2* rng = static_cast<int2*>(scratch);
  const size_t acc_smem =
      sizeof(float) * kAccWarps * static_cast<size_t>(sub);
  cudaError_t err = cudaFuncSetAttribute(
      direct_accumulate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(acc_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nchunk > 0)
    chunk_ranges_kernel<<<dim3((nchunk + kRangeWarps - 1) / kRangeWarps, B),
                          32 * kRangeWarps, 0, st>>>(docs, N, cap, nchunk,
                                                     rng);
  direct_accumulate_kernel<<<dim3((nbkt + kAccWarps - 1) / kAccWarps, B),
                             32 * kAccWarps, acc_smem, st>>>(
      docs, vals, N, cap, sub, nbkt, nchunk, rng, out);
  return static_cast<int>(cudaGetLastError());
}
