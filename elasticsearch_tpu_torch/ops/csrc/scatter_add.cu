// Posting scatter-add for Hopper (sm_90a).
//
// Replaces: elasticsearch_tpu/ops/pallas_scoring.py:_scatter_kernel
//           (launched by scatter_add_pallas, behind score_term_pallas and
//           score_terms_fused_pallas).
//
//   out[b, docs[b, n]] += vals[b, n]   for n ascending; docs outside
//                                      [0, cap) are dropped.
//
// The TPU kernel turns each 128-posting chunk into a one-hot MXU product
// because the TPU has no scatter. Hopper scatters natively, so this kernel
// ports the semantics instead, with doc-range ownership and no float
// atomics: each doc has one owner, a warp, which adds the doc's postings
// in ascending n. Each doc's sum is therefore taken in exactly the
// reference's order (jnp `.at[].add`, sequential in n), deterministic and
// bit-identical to the plain version whatever the multiplicity -
// `terms_fused` sends one doc several terms' postings.
//
// Design. A row's docs split into buckets of `span / 4` docs, each owned
// by one warp that accumulates it in shared memory and writes it once,
// coalesced (no zero fill, no read-modify-write in device memory); a CTA
// holds 4 consecutive buckets. An owner must see only its own postings,
// whatever the spread of a posting block (a rare term's 128 postings span
// the whole capacity, and every owner would otherwise scan every block),
// so the postings are first partitioned by bucket, stably (n order kept
// within a bucket):
//   1. counts: per (row, block of 2048 postings) the postings of each
//      bucket (shared-memory integer atomics: counts have no order),
//      written block-major (coalesced);
//   2. scan: per row, the exclusive prefix of the counts taken
//      bucket-major, which gives each (bucket, block) its first slot and
//      each bucket its range;
//   3. scatter: per (row, block), each posting's slot: its block's base
//      for its bucket, plus the postings of its bucket in earlier warps
//      of the block, plus those earlier in its own warp (`__match_any`
//      rank, warp by warp in n order);
//   4. accumulate: per (row, 4 buckets), each warp walks its bucket's
//      postings 32 at a time in n order; within 32, the lanes holding
//      one doc are matched and the first adds their values in lane (= n)
//      order.
//
// What bounds it on this card: it must read B * N * 8 bytes and write
// B * cap * 4 bytes; the output write dominates at the main path's shapes
// (B = 128, N = 2^18, cap = 2^20: 512 MiB). The partition adds about two
// more passes over the postings (read in 1 and 3, written in 3, read in
// 4), traffic independent of how the postings spread over the docs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 2048;      // postings per block of passes 1 and 3
constexpr int kThreads = 256;     // passes 1 and 3: 8 warps of 256
constexpr int kRounds = kBlock / kThreads;
constexpr int kScanThreads = 1024;
constexpr int kAccWarps = 4;      // pass 4: warps per bucket
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int bucket_of(int d, int cap, int sub) {
  return d >= 0 && d < cap ? d / sub : -1;
}

// 1. cnt[b, blk * nbkt + j] = postings of row b's block blk in bucket j
__global__ void __launch_bounds__(kThreads)
bucket_counts_kernel(const int* __restrict__ docs, int N, int cap, int sub,
                     int nbkt, int* __restrict__ cnt) {
  extern __shared__ int s_cnt[];
  const int blk = blockIdx.x, b = blockIdx.y;
  for (int j = threadIdx.x; j < nbkt; j += kThreads) s_cnt[j] = 0;
  __syncthreads();
  const int* row = docs + static_cast<size_t>(b) * N;
  for (int n = blk * kBlock + threadIdx.x; n < min(N, (blk + 1) * kBlock);
       n += kThreads) {
    const int j = bucket_of(__ldg(row + n), cap, sub);
    if (j >= 0) atomicAdd(&s_cnt[j], 1);
  }
  __syncthreads();
  int* crow = cnt + (static_cast<size_t>(b) * gridDim.x + blk) * nbkt;
  for (int j = threadIdx.x; j < nbkt; j += kThreads) crow[j] = s_cnt[j];
}

// 2. off[b, j * nblk + blk]: the exclusive prefix of row b's counts taken
// bucket-major; off[b, nbkt * nblk] is the row's total. One CTA a row,
// 1024 counts at a time, a carry between them.
__global__ void __launch_bounds__(kScanThreads)
bucket_scan_kernel(const int* __restrict__ cnt, int nbkt, int nblk,
                   int* __restrict__ off) {
  __shared__ int s_warp[kScanThreads / 32];
  __shared__ int s_carry;
  const int len = nbkt * nblk + 1;
  const int* crow = cnt + static_cast<size_t>(blockIdx.x) * nbkt * nblk;
  int* row = off + static_cast<size_t>(blockIdx.x) * len;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  if (t == 0) s_carry = 0;
  __syncthreads();
  for (int i0 = 0; i0 < len; i0 += kScanThreads) {
    const int i = i0 + t;
    const int j = i / max(nblk, 1), blk = i - j * nblk;
    const int v = i < len - 1 ? crow[static_cast<size_t>(blk) * nbkt + j]
                              : 0;
    int x = v;  // inclusive prefix within the warp
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int y = __shfl_up_sync(kFull, x, s);
      if (lane >= s) x += y;
    }
    if (lane == 31) s_warp[w] = x;
    __syncthreads();
    if (w == 0) {
      int z = s_warp[lane];
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int y = __shfl_up_sync(kFull, z, s);
        if (lane >= s) z += y;
      }
      s_warp[lane] = z;  // inclusive prefix of the warp totals
    }
    __syncthreads();
    const int carry = s_carry;
    const int before = carry + (w > 0 ? s_warp[w - 1] : 0) + x - v;
    if (i < len) row[i] = before;
    __syncthreads();
    if (t == 0) s_carry = carry + s_warp[kScanThreads / 32 - 1];
    __syncthreads();
  }
}

// 3. each in-range posting to its slot of the partitioned row
__global__ void __launch_bounds__(kThreads)
bucket_scatter_kernel(const int* __restrict__ docs,
                      const float* __restrict__ vals, int N, int cap,
                      int sub, int nbkt, int nblk,
                      const int* __restrict__ off,
                      int* __restrict__ part_d, float* __restrict__ part_v) {
  extern __shared__ int s_wc[];  // [8 warps][nbkt]: counts, then bases
  const int blk = blockIdx.x, b = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  for (int e = t; e < (kThreads / 32) * nbkt; e += kThreads) s_wc[e] = 0;
  __syncthreads();
  const int* drow = docs + static_cast<size_t>(b) * N;
  const float* vrow = vals + static_cast<size_t>(b) * N;
  int* wc = s_wc + w * nbkt;
  int d[kRounds], j[kRounds], rank[kRounds];
  float v[kRounds];
  const unsigned lt = (1u << lane) - 1u;
  // warp w holds postings blk * 2048 + w * 256 + 32 k + lane, k = 0..7:
  // in n order warp by warp, then k, then lane
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int n = blk * kBlock + w * (32 * kRounds) + 32 * k + lane;
    d[k] = n < N ? __ldg(drow + n) : -1;
    v[k] = n < N ? __ldg(vrow + n) : 0.0f;
    j[k] = bucket_of(d[k], cap, sub);
    const unsigned peers = __match_any_sync(kFull, j[k]);
    rank[k] = j[k] >= 0 ? wc[j[k]] + __popc(peers & lt) : 0;
    __syncwarp();
    if (j[k] >= 0 && (peers & lt) == 0u) wc[j[k]] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // per bucket, the postings of earlier warps of the block
  for (int jj = t; jj < nbkt; jj += kThreads) {
    int run = 0;
    for (int ww = 0; ww < kThreads / 32; ++ww) {
      const int c = s_wc[ww * nbkt + jj];
      s_wc[ww * nbkt + jj] = run;
      run += c;
    }
  }
  __syncthreads();
  const int* orow = off + static_cast<size_t>(b) * (nbkt * nblk + 1);
  const size_t base = static_cast<size_t>(b) * N;
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    if (j[k] < 0) continue;
    const size_t at = base +
                      orow[static_cast<size_t>(j[k]) * nblk + blk] +
                      wc[j[k]] + rank[k];
    part_d[at] = d[k];
    part_v[at] = v[k];
  }
}

// 4. per (row, 4 buckets): each warp its bucket's docs in shared memory,
// its postings in n order, 32 at a time
__global__ void __launch_bounds__(32 * kAccWarps)
bucket_accumulate_kernel(const int* __restrict__ part_d,
                         const float* __restrict__ part_v, int N, int cap,
                         int sub, int nbkt, int nblk,
                         const int* __restrict__ off,
                         float* __restrict__ out) {
  extern __shared__ __align__(16) float s_acc[];  // [4][sub]
  __shared__ float s_v[kAccWarps][32];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int q = blockIdx.x * kAccWarps + w;  // this warp's bucket
  const int wlo = q * sub;
  const int whi = min(cap, wlo + sub);
  if (q >= nbkt) return;
  float* acc = s_acc + w * sub;
  for (int i = lane; i < sub; i += 32) acc[i] = 0.0f;
  __syncwarp();
  const int* orow = off + static_cast<size_t>(b) * (nbkt * nblk + 1);
  const int beg = orow[static_cast<size_t>(q) * nblk];
  const int end = orow[static_cast<size_t>(q + 1) * nblk];
  const int* drow = part_d + static_cast<size_t>(b) * N;
  const float* vrow = part_v + static_cast<size_t>(b) * N;
  int dn = beg + lane < end ? __ldg(drow + beg + lane) : -1;
  float vn = beg + lane < end ? __ldg(vrow + beg + lane) : 0.0f;
  for (int i0 = beg; i0 < end; i0 += 32) {
    const int d = dn;
    const float v = vn;
    // the next 32 postings load while these are added
    const int i1 = i0 + 32 + lane;
    dn = i1 < end ? __ldg(drow + i1) : -1;
    vn = i1 < end ? __ldg(vrow + i1) : 0.0f;
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
  // each warp writes its docs once, coalesced
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

// the scratch of a launch in bytes, parts 16-byte aligned: at[0..3] the
// offsets of the counts (B * nblk * nbkt ints), the slots (B * (nbkt *
// nblk + 1) ints), the partitioned doc ids (B * N ints) and values (B * N
// floats), at[4] the total; false for arguments the kernel does not take
bool scratch_layout(int B, int N, int cap, int sub, size_t* at) {
  if (B > 65535 || N < 0 || sub <= 0 || sub % 4 != 0) return false;
  const long long nbkt = B > 0 && cap > 0 ? (cap + sub - 1) / sub : 0;
  const long long nblk = (static_cast<long long>(N) + kBlock - 1) / kBlock;
  if (nbkt * nblk >= 0x7fffffffLL) return false;
  const size_t rows = B > 0 && cap > 0 ? static_cast<size_t>(B) : 0;
  const size_t part[4] = {
      sizeof(int) * rows * static_cast<size_t>(nblk * nbkt),
      sizeof(int) * rows * static_cast<size_t>(nbkt * nblk + 1),
      sizeof(int) * rows * static_cast<size_t>(N),
      sizeof(float) * rows * static_cast<size_t>(N)};
  at[0] = 0;
  for (int i = 0; i < 4; ++i) at[i + 1] = at[i] + (part[i] + 15) / 16 * 16;
  return true;
}

}  // namespace

// bytes of scratch scatter_add takes for these arguments, -1 where it
// takes none of them; sub: docs of a bucket (a multiple of 4)
extern "C" long long scatter_add_scratch(int B, int N, int cap, int sub) {
  size_t at[5];
  return scratch_layout(B, N, cap, sub, at) ? static_cast<long long>(at[4])
                                            : -1;
}

// scratch: scatter_add_scratch(B, N, cap, sub) bytes
extern "C" int scatter_add(const int* docs, const float* vals, void* scratch,
                           long long scratch_bytes, float* out, int B, int N,
                           int cap, int sub, void* stream) {
  size_t at[5];
  if (!scratch_layout(B, N, cap, sub, at) ||
      scratch_bytes != static_cast<long long>(at[4]))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || cap <= 0) return 0;
  unsigned char* base = static_cast<unsigned char*>(scratch);
  int* cnt = reinterpret_cast<int*>(base + at[0]);
  int* off = reinterpret_cast<int*>(base + at[1]);
  int* part_d = reinterpret_cast<int*>(base + at[2]);
  float* part_v = reinterpret_cast<float*>(base + at[3]);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nbkt = (cap + sub - 1) / sub;
  const int nblk = (N + kBlock - 1) / kBlock;
  const size_t acc_smem =
      sizeof(float) * kAccWarps * static_cast<size_t>(sub);
  const size_t wc_smem = sizeof(int) * (kThreads / 32) *
                         static_cast<size_t>(nbkt);
  cudaError_t err = cudaFuncSetAttribute(
      bucket_accumulate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(acc_smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bucket_scatter_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(wc_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nblk, B);
  if (nblk > 0)
    bucket_counts_kernel<<<grid, kThreads, sizeof(int) * nbkt, st>>>(
        docs, N, cap, sub, nbkt, cnt);
  bucket_scan_kernel<<<B, kScanThreads, 0, st>>>(cnt, nbkt, nblk, off);
  if (nblk > 0)
    bucket_scatter_kernel<<<grid, kThreads, wc_smem, st>>>(
        docs, vals, N, cap, sub, nbkt, nblk, off, part_d, part_v);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 acc_grid((nbkt + kAccWarps - 1) / kAccWarps, B);
  bucket_accumulate_kernel<<<acc_grid, 32 * kAccWarps, acc_smem, st>>>(
      part_d, part_v, N, cap, sub, nbkt, nblk, off, out);
  return static_cast<int>(cudaGetLastError());
}
