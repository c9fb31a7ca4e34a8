// Forward-index BM25 scorer for Hopper (sm_90a).
//
// Replaces: elasticsearch_tpu/ops/pallas_scoring.py:_dense_kernel
//           (launched by score_terms_dense_pallas).
//
//   out[b, d] = sum_q wq[b, q] * sum_l [tids[d, l] == qt[b, q]] * imps[d, l]
//
// accumulated exactly as the Pallas body does: acc = 0; for each q:
// hit = 0, hit += select(...) for l ascending, acc = acc + hit * wq. Every
// add and multiply is an explicit round-to-nearest intrinsic, so nvcc
// cannot contract them into an FMA and the result is bit-identical to the
// plain PyTorch version (ops/cuda_scoring.dense_score_ref).
//
// What bounds it on this card: it reads the forward index once
// (cap * L * 8 bytes) and writes B * cap * 4 bytes; done for every pair,
// the compare/select/add work (B * cap * Q * L on the integer and select
// pipes) costs several times the bytes. Most pairs share no term, so only
// the pairs that can match pay for the compares:
//   * a 128-bit term signature per doc (one bit per slot whose impact is
//     not +-0.0, hashed from its term id; every negative id on bit 127)
//     and per row (one bit per query term), built in the kernel: the
//     block's docs' once, from their staged rows; the rows' a chunk at a
//     time (up to 256 rows, their terms and weights staged in shared
//     memory too, so the walk over the rows reads no device memory). A
//     pair whose signatures share no bit can only hit slots of impact
//     +-0.0: hit stays +0.0, +0.0 * wq is +-0.0 and acc stays +0.0, so the
//     pair writes +0.0 without the compares. That holds where every weight
//     of the row is finite; a row with a non-finite weight scores every
//     pair (ops/cuda_scoring.dense_candidates_ref mirrors the filter);
//   * a block owns 128 docs (4 consecutive per lane, written as one
//     16-byte store a row), staged in shared memory slot-major where L <=
//     kMaxStagedL (a lane's k-th doc in column 32 k + lane, rows padded
//     to 129: conflict-free for the staging stores and the lanes' reads),
//     and walks every row in groups of 32, 4 rows a warp. A warp's 512 pairs of a group are tested against the
//     signatures; the candidates are listed in shared memory (a scan of
//     the lanes' counts) and dealt one a lane, each scored in the Pallas
//     order into a shared-memory tile of the warp's rows, zero elsewhere. A warp with more than half
//     of its pairs candidates scores all 512 in place instead, each lane
//     its 4 docs x 4 rows, every slot read once for two rows at a time.
// The TPU kernel's slot-major transpose is not needed: the doc-major
// [cap, L] layout is read as contiguous rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                  // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kPerLane = 4;                // docs per lane
constexpr int kDocs = 32 * kPerLane;       // docs per block
constexpr int kRows = 4;                   // rows per warp per group
constexpr int kGroupRows = kWarps * kRows;
constexpr int kPairs = kRows * kPerLane;   // pairs per lane per group
constexpr int kDenseCut = 32 * kPairs / 2; // candidates above: score all
constexpr int kPitch = kDocs + 1;          // staged slot row, padded
constexpr int kMaxStagedL = 64;            // staged strip <= 66 KB

// the block's forward rows: staged slot-major in shared memory, or read
// from device memory where L is too wide to stage
template <bool STAGED>
struct Strip {
  const int* tid;       // STAGED: [L][kPitch]; else the [cap, L] index
  const float* imp;
  int L;
  // the slot column of block doc dl (0 <= dl < kDocs)
  __device__ __forceinline__ static int col(int dl) {
    return (dl % kPerLane) * 32 + dl / kPerLane;
  }
  __device__ __forceinline__ int t(int d, int dl, int l) const {
    return STAGED ? tid[l * kPitch + col(dl)]
                  : __ldg(tid + static_cast<size_t>(d) * L + l);
  }
  __device__ __forceinline__ float v(int d, int dl, int l) const {
    return STAGED ? imp[l * kPitch + col(dl)]
                  : __ldg(imp + static_cast<size_t>(d) * L + l);
  }
};

// the signature bit of a term id: negative ids share bit 127, the others
// spread over bits 0..126 by a multiplicative hash
__device__ __forceinline__ int sig_bit(int t) {
  return t < 0 ? 127
               : static_cast<int>(__umulhi(static_cast<unsigned>(t) *
                                               0x9E3779B1u, 127u));
}

__device__ __forceinline__ void set_bit(uint4& s, int bit) {
  const unsigned m = 1u << (bit & 31);
  const int w = bit >> 5;
  s.x |= w == 0 ? m : 0u;
  s.y |= w == 1 ? m : 0u;
  s.z |= w == 2 ? m : 0u;
  s.w |= w == 3 ? m : 0u;
}

__device__ __forceinline__ bool shares(const uint4& a, const uint4& b) {
  return ((a.x & b.x) | (a.y & b.y) | (a.z & b.z) | (a.w & b.w)) != 0u;
}

// one (row, doc) pair in the Pallas body's order; the row's terms and
// weights from shared memory
template <int QG, bool STAGED>
__device__ __forceinline__ float pair_score(const Strip<STAGED>& st, int d,
                                            int dl, const int* qrow,
                                            const float* wrow, int Q) {
  float acc = 0.0f;
  for (int q0 = 0; q0 < Q; q0 += QG) {
    const int nq = min(QG, Q - q0);
    int tq[QG];
    float hit[QG];
#pragma unroll
    for (int j = 0; j < QG; ++j) {
      tq[j] = j < nq ? qrow[q0 + j] : 0;
      hit[j] = 0.0f;
    }
#pragma unroll 8
    for (int l = 0; l < st.L; ++l) {
      const int t = st.t(d, dl, l);
      const float v = st.v(d, dl, l);
#pragma unroll
      for (int j = 0; j < QG; ++j)
        if (j < nq) hit[j] = __fadd_rn(hit[j], t == tq[j] ? v : 0.0f);
    }
#pragma unroll
    for (int j = 0; j < QG; ++j)
      if (j < nq) acc = __fadd_rn(acc, __fmul_rn(hit[j], wrow[q0 + j]));
  }
  return acc;
}

// rows staged a chunk at a time: their terms and weights, signatures and
// non-finite flags (dense_score_smem sizes the chunk)
struct RowChunk {
  int* qt;        // [rc][Q]
  float* wq;      // [rc][Q]
  uint4* sig;     // [rc]
  int* every;     // [rc]
};

template <int QG, bool STAGED>
__global__ void __launch_bounds__(kThreads, 2)
dense_score_kernel(const int* __restrict__ tids, const float* __restrict__ imps,
                   const int* __restrict__ qt, const float* __restrict__ wq,
                   float* __restrict__ out, int B, int Q, int cap, int L,
                   int rc) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ uint4 s_sig[kDocs];
  __shared__ __align__(16) float s_out[kWarps][kRows][kDocs];
  __shared__ unsigned short s_list[kWarps][32 * kPairs];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d0 = blockIdx.x * kDocs;
  // dynamic shared memory: the row chunk, then the staged strip
  RowChunk rows;
  rows.sig = reinterpret_cast<uint4*>(s_dyn);
  rows.every = reinterpret_cast<int*>(rows.sig + rc);
  rows.qt = rows.every + rc;
  rows.wq = reinterpret_cast<float*>(rows.qt + rc * Q);
  Strip<STAGED> st{tids, imps, L};
  if (STAGED) {
    // the strip's [kDocs, L] rows are contiguous: coalesced loads
    int* s_t = reinterpret_cast<int*>(rows.wq + rc * Q);
    float* s_v = reinterpret_cast<float*>(s_t + L * kPitch);
    const size_t g0 = static_cast<size_t>(d0) * L;
    for (int i = threadIdx.x; i < kDocs * L; i += kThreads) {
      const int dl = i / L, l = i - dl * L;
      const bool ok = d0 + dl < cap;
      s_t[l * kPitch + Strip<STAGED>::col(dl)] = ok ? __ldg(tids + g0 + i) : -1;
      s_v[l * kPitch + Strip<STAGED>::col(dl)] =
          ok ? __ldg(imps + g0 + i) : 0.0f;
    }
    st.tid = s_t;
    st.imp = s_v;
    __syncthreads();
  }

  // the block's doc signatures, one doc a thread
  if (threadIdx.x < kDocs) {
    const int dl = threadIdx.x, d = d0 + dl;
    uint4 s = make_uint4(0u, 0u, 0u, 0u);
    if (d < cap)
      for (int l = 0; l < L; ++l)
        if (st.v(d, dl, l) != 0.0f) set_bit(s, sig_bit(st.t(d, dl, l)));
    s_sig[dl] = s;
  }
  uint4 ds[kPerLane];
  const int dl = d0 + kPerLane * lane;       // this lane's first doc
  const bool vec = (cap & 3) == 0;           // 16-byte row stores

  for (int c0 = 0; c0 < B; c0 += rc) {
    const int nr = min(rc, B - c0);
    __syncthreads();                         // the last chunk is done
    // the chunk's terms and weights (contiguous: coalesced), then each
    // row's signature and non-finite flag, a thread a row
    const size_t q0 = static_cast<size_t>(c0) * Q;
    for (int i = threadIdx.x; i < nr * Q; i += kThreads) {
      rows.qt[i] = __ldg(qt + q0 + i);
      rows.wq[i] = __ldg(wq + q0 + i);
    }
    __syncthreads();
    for (int r = threadIdx.x; r < nr; r += kThreads) {
      uint4 s = make_uint4(0u, 0u, 0u, 0u);
      int every = 0;
      for (int q = 0; q < Q; ++q) {
        set_bit(s, sig_bit(rows.qt[r * Q + q]));
        every |= !isfinite(rows.wq[r * Q + q]);
      }
      rows.sig[r] = s;
      rows.every[r] = every;
    }
    __syncthreads();
    if (c0 == 0) {
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) ds[k] = s_sig[kPerLane * lane + k];
    }

    for (int g = 0; g < nr; g += kGroupRows) {
      const int rl = g + warp * kRows;       // this warp's first chunk row
      const int rw = c0 + rl;                // and its row
      unsigned cand = 0;                     // bit j * kPerLane + k
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (rl + j >= nr) continue;
        const uint4 rs = rows.sig[rl + j];
        const bool every = rows.every[rl + j] != 0;
#pragma unroll
        for (int k = 0; k < kPerLane; ++k)
          if (dl + k < cap && (every || shares(ds[k], rs)))
            cand |= 1u << (j * kPerLane + k);
      }
      const int n = __reduce_add_sync(~0u, __popc(cand));

      float acc[kRows][kPerLane];
#pragma unroll
      for (int j = 0; j < kRows; ++j)
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) acc[j][k] = 0.0f;
      if (n > kDenseCut) {
        // most pairs can match: every pair in place, each slot read once
        // for two of the warp's rows (two halves: registers)
#pragma unroll
        for (int jh = 0; jh < kRows; jh += 2) {
          for (int q0 = 0; q0 < Q; q0 += QG) {
            const int nq = min(QG, Q - q0);
            int tq[2][QG];
            float w[2][QG];
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const int base = min(rl + jh + jj, nr - 1) * Q + q0;
#pragma unroll
              for (int q = 0; q < QG; ++q) {
                tq[jj][q] = q < nq ? rows.qt[base + q] : 0;
                w[jj][q] = q < nq ? rows.wq[base + q] : 0.0f;
              }
            }
#pragma unroll
            for (int k = 0; k < kPerLane; ++k) {
              if (dl + k >= cap) continue;
              const int bk = kPerLane * lane + k;
              float hit[2][QG];
#pragma unroll
              for (int jj = 0; jj < 2; ++jj)
#pragma unroll
                for (int q = 0; q < QG; ++q) hit[jj][q] = 0.0f;
              for (int l = 0; l < L; ++l) {
                const int t = st.t(dl + k, bk, l);
                const float v = st.v(dl + k, bk, l);
#pragma unroll
                for (int jj = 0; jj < 2; ++jj)
#pragma unroll
                  for (int q = 0; q < QG; ++q)
                    if (q < nq)
                      hit[jj][q] =
                          __fadd_rn(hit[jj][q], t == tq[jj][q] ? v : 0.0f);
              }
#pragma unroll
              for (int jj = 0; jj < 2; ++jj)
#pragma unroll
                for (int q = 0; q < QG; ++q)
                  if (q < nq)
                    acc[jh + jj][k] = __fadd_rn(
                        acc[jh + jj][k], __fmul_rn(hit[jj][q], w[jj][q]));
            }
          }
        }
      } else if (n > 0) {
        // few candidates: listed in the warp's shared memory (each lane's
        // at its exclusive prefix of the counts), dealt one a lane, and
        // scored into the warp's tile (zero for every other pair)
        float(*tile)[kDocs] = s_out[warp];
        unsigned short* list = s_list[warp];
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          *reinterpret_cast<float4*>(&tile[j][kPerLane * lane]) =
              make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const int mine = __popc(cand);
        int at = mine;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(~0u, at, o);
          if (lane >= o) at += y;
        }
        at -= mine;
        for (unsigned c = cand; c != 0u; c &= c - 1u) {
          const int i = __ffs(c) - 1;        // pair j * kPerLane + k
          list[at++] = static_cast<unsigned short>(
              (i / kPerLane) << 8 | (kPerLane * lane + i % kPerLane));
        }
        __syncwarp();
        for (int g0 = 0; g0 < n; g0 += 32) {
          const int gi = g0 + lane;
          if (gi < n) {
            const int e = list[gi];
            const int j = e >> 8, bk = e & 0xff;
            const int rq = (rl + j) * Q;
            tile[j][bk] = pair_score<QG, STAGED>(st, d0 + bk, bk,
                                                 rows.qt + rq, rows.wq + rq,
                                                 Q);
          }
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const float4 x =
              *reinterpret_cast<const float4*>(&tile[j][kPerLane * lane]);
          acc[j][0] = x.x;
          acc[j][1] = x.y;
          acc[j][2] = x.z;
          acc[j][3] = x.w;
        }
        __syncwarp();
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (rl + j >= nr) continue;
        float* orow = out + static_cast<size_t>(rw + j) * cap;
        if (vec && dl < cap) {
          *reinterpret_cast<float4*>(orow + dl) =
              make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        } else {
#pragma unroll
          for (int k = 0; k < kPerLane; ++k)
            if (dl + k < cap) orow[dl + k] = acc[j][k];
        }
      }
    }
  }
}

// rows a chunk: as many as 16 KB of terms and weights hold, a multiple of
// the 32-row group, 32 to 256
int rows_per_chunk(int Q) {
  const int r = Q > 0 ? 16384 / (8 * Q) / kGroupRows * kGroupRows : 256;
  return r < kGroupRows ? kGroupRows : (r > 256 ? 256 : r);
}

size_t dense_score_smem(int Q, int L, bool staged) {
  const size_t rc = rows_per_chunk(Q);
  return rc * (sizeof(uint4) + sizeof(int)) + rc * Q * 8 +
         (staged ? static_cast<size_t>(L) * kPitch * 8 : 0);
}

template <int QG, bool STAGED>
cudaError_t launch_one(const int* tids, const float* imps, const int* qt,
                       const float* wq, float* out, int B, int Q, int cap,
                       int L, cudaStream_t stream) {
  const size_t smem = dense_score_smem(Q, L, STAGED);
  cudaError_t err = cudaFuncSetAttribute(
      dense_score_kernel<QG, STAGED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((cap + kDocs - 1) / kDocs);
  dense_score_kernel<QG, STAGED><<<grid, kThreads, smem, stream>>>(
      tids, imps, qt, wq, out, B, Q, cap, L, rows_per_chunk(Q));
  return cudaGetLastError();
}

template <int QG>
cudaError_t launch(const int* tids, const float* imps, const int* qt,
                   const float* wq, float* out, int B, int Q, int cap, int L,
                   cudaStream_t stream) {
  return L <= kMaxStagedL
             ? launch_one<QG, true>(tids, imps, qt, wq, out, B, Q, cap, L,
                                    stream)
             : launch_one<QG, false>(tids, imps, qt, wq, out, B, Q, cap, L,
                                     stream);
}

}  // namespace

extern "C" int dense_score(const int* tids, const float* imps, const int* qt,
                           const float* wq, float* out, int B, int Q, int cap,
                           int L, void* stream) {
  if (B <= 0 || cap <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (Q <= 1) {
    err = launch<1>(tids, imps, qt, wq, out, B, Q, cap, L, s);
  } else if (Q <= 2) {
    err = launch<2>(tids, imps, qt, wq, out, B, Q, cap, L, s);
  } else if (Q <= 4) {
    err = launch<4>(tids, imps, qt, wq, out, B, Q, cap, L, s);
  } else {
    err = launch<8>(tids, imps, qt, wq, out, B, Q, cap, L, s);
  }
  return static_cast<int>(err);
}
