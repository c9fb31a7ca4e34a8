// Per-bucket metric stats of a doc-space agg, for Hopper (sm_90a): sum,
// sum of squares, count, min and max of each (row, bucket), every one the
// reference's exact f32 result.
//
// Not a TPU kernel: the reference takes these with XLA scatters outside
// any Pallas kernel (elasticsearch_tpu/ops/aggs.py:25-32 `.at[ids].add`:
// bucket_sums, bucket_sum_sq, bucket_counts; :152-167 `.at[ids].min /
// .max`: bucket_min, bucket_max). Their plain versions, which state the
// results, are elasticsearch_tpu_torch/ops/ordered.py: `bucket_fold` (a
// left fold from +0.0 per bucket in ascending doc order), and
// `bucket_extreme` (XLA's NaN-propagating minimum / maximum, -0.0 below
// +0.0, the surviving NaN fixed by the doc order: an integer rank key per
// value, smaller preferred, whose minimum is the fold's result in any
// order); counts are integers.
//
// Entry `ordered_bucket_stats`. The caller hands the docs in bucket order
// (a stable sort of the wrapped ids: `order`, the bucket of each sorted
// position `sorted_b`, each bucket's first position `starts`, dropped ids
// last, past starts[n_buckets]) and `chunk_first`: sorted positions are
// cut into tiles of kTile, a chunk is a tile's part of one bucket, and
// bucket j's chunks are numbered [chunk_first[j], chunk_first[j + 1]) in
// position order. Two launches, no atomics:
//   * `compact_kernel`, a CTA per (tile, group of kRows rows): the tile's
//     docs and values are loaded once; then per row the mask bytes are
//     gathered (the next row's while this one is done), the matched
//     values compacted in position order (ballots and one CTA scan) into
//     the row's scratch slots of the tile, each chunk's first rank and
//     the tile's count written. Order does not matter here: it is spread
//     over every tile of the hot bucket.
//   * `fold_kernel`, a CTA per (row, bucket), a warp per role: the sum's
//     left fold and the squares' left fold, each one chain of dependent
//     adds in its own warp (its own scheduler), fed from the compacted
//     values in pieces of kPiece, loaded coalesced into registers kAhead
//     pieces ahead (over 2 us of adds in flight) and stored into one of
//     two shared-memory slots a piece before their fold, then folded 16
//     at a time from registers loaded a batch ahead, 64 values between
//     branches (the squares' multiplies a batch ahead too, in the adds'
//     shadow: a warp issues in order); the only sequential work. A third
//     warp takes the count (the chunks' lengths) and the min / max: their
//     rank keys over the same values, 32 lanes at a time (any order).
// Every add is __fadd_rn and every square __fmul_rn.
//
// Subnormals as XLA's CPU runtime treats them: each value is flushed to
// a zero of its sign as it is read (`flush`), so the sums, squares and
// the min / max rank keys see the flushed value, and the source is built
// with -ftz=true, so a subnormal add or square result flushes too
// (ops/ordered.ftz; FADD.FTZ / FMUL.FTZ in the SASS).
//
// What bounds it: the hottest (row, bucket)'s chain, its matched docs
// times the add's dependent latency; then the bytes (the [B, cap] mask
// read through `order`, the compacted values written once and read once
// a role). Scratch: B x kTile x n_tiles floats of compacted values (512
// MiB at [128, 2^20]), the chunks' first ranks and the tiles' counts
// (`ordered_bucket_stats_scratch`).

#include <cuda_runtime.h>
#include <stdint.h>

// a subnormal -> a zero of its sign; any other value unchanged
__device__ __forceinline__ float flush(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x7f800000u) ? x : __uint_as_float(u & 0x80000000u);
}

// entry `ordered_bucket_stats`'s arguments (cuda_scoring._BucketStatsArgs)
struct BucketStatsArgs {
  const int* order;           // [cap] docs in bucket order
  const int* sorted_b;        // [cap] bucket of each sorted position
  const int* starts;          // [n_buckets + 1]; starts[n_buckets] = kept
  const int* chunk_first;     // [n_buckets + 1] first chunk of each bucket
  const unsigned char* mask;  // [B, cap] bool
  const float* values;        // [cap] by doc
  float* sum;                 // [B, n_buckets] or null, likewise below
  float* sum_sq;
  float* count;
  float* min;
  float* max;
  void* scratch;              // ordered_bucket_stats_scratch bytes
  long long scratch_len;
  int B, cap, n_buckets;
};

namespace {

constexpr int kTile = 2048;                   // sorted positions a tile
constexpr int kThreads = 256;                 // compact_kernel
constexpr int kWarps = kThreads / 32;
constexpr int kPer = kTile / kThreads;        // positions a thread
constexpr int kRows = 16;                     // rows a compact CTA
constexpr int kPiece = 512;                   // values a piece
constexpr int kAhead = 2;                     // pieces in registers a warp
constexpr int kBatch = 16;                    // values folded from registers
constexpr int kGroup = 4 * kBatch;            // values a branch-free step
constexpr int kMetaLoads = 8;                 // 16-byte loads a meta lane in flight
constexpr unsigned long long kNone = ~0ull;   // no matched doc

struct Scratch {
  float* vals;                 // [B, n_tiles * kTile]
  int* chunk_rank;             // [B, chunk_bound]: a chunk's first rank
  int* tile_total;             // [B, n_tiles]: matched docs of a tile
  long long bytes;
};

__host__ __device__ inline long long align256(long long x) {
  return (x + 255) & ~255ll;
}

__host__ __device__ inline Scratch carve(void* base, int B, int cap,
                                         int n_buckets) {
  const long long n_tiles = (cap + kTile - 1) / kTile;
  const long long chunk_bound = n_tiles + n_buckets;
  Scratch s;
  char* p = static_cast<char*>(base);
  long long off = 0;
  s.vals = reinterpret_cast<float*>(p + off);
  off = align256(off + 4ll * B * n_tiles * kTile);
  s.chunk_rank = reinterpret_cast<int*>(p + off);
  off = align256(off + 4ll * B * chunk_bound);
  s.tile_total = reinterpret_cast<int*>(p + off);
  off = align256(off + 4ll * B * n_tiles);
  s.bytes = off;
  return s;
}

__global__ void __launch_bounds__(kThreads, 2)
compact_kernel(const __grid_constant__ BucketStatsArgs a, Scratch s,
               int want_vals) {
  __shared__ int s_cnt[2][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kept = __ldg(a.starts + a.n_buckets);
  const int t = blockIdx.x;
  const int tile0 = t * kTile;
  if (tile0 >= kept) return;
  const int n_tiles = (a.cap + kTile - 1) / kTile;
  const long long chunk_bound = n_tiles + a.n_buckets;
  const long long stride = static_cast<long long>(n_tiles) * kTile;
  // this warp's 256 positions: kPer rounds of 32, in position order
  const int w0 = tile0 + warp * (kTile / kWarps);
  int doc[kPer];
  float v[kPer];
  unsigned begins = 0;       // rounds whose position begins a chunk
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int p = w0 + i * 32 + lane;
    const bool ok = p < kept;
    doc[i] = ok ? __ldg(a.order + p) : -1;
    v[i] = ok && want_vals ? flush(__ldg(a.values + doc[i])) : 0.0f;
    if (ok && (p == tile0 ||
               __ldg(a.sorted_b + p) != __ldg(a.sorted_b + p - 1)))
      begins |= 1u << i;
  }
  const unsigned lt = (1u << lane) - 1u;
  const int r0 = blockIdx.y * kRows, r1 = min(a.B, r0 + kRows);
  // the mask bytes of a row, gathered through `order`; the next row's
  // are loaded while this one is compacted
  unsigned char mb[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    mb[i] = doc[i] >= 0 ? __ldg(a.mask + static_cast<long long>(r0) * a.cap +
                                doc[i])
                        : 0;
  for (int b = r0; b < r1; ++b) {
    unsigned bal[kPer];
    int before[kPer];          // the warp's matched docs before round i
    int n = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      bal[i] = __ballot_sync(~0u, mb[i] != 0);
      before[i] = n;
      n += __popc(bal[i]);
    }
    if (b + 1 < r1) {
      const unsigned char* nrow =
          a.mask + static_cast<long long>(b + 1) * a.cap;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        mb[i] = doc[i] >= 0 ? __ldg(nrow + doc[i]) : 0;
    }
    const int buf = b & 1;
    if (lane == 0) s_cnt[buf][warp] = n;
    __syncthreads();
    int off = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_cnt[buf][w];
      off += w < warp ? c : 0;
      total += c;
    }
    float* vrow = s.vals + static_cast<long long>(b) * stride + tile0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int rank = off + before[i] + __popc(bal[i] & lt);
      if (want_vals && ((bal[i] >> lane) & 1u)) vrow[rank] = v[i];
      if ((begins >> i) & 1u) {
        const int p = w0 + i * 32 + lane;
        const int j = __ldg(a.sorted_b + p);
        const int c = __ldg(a.chunk_first + j) + t -
                      __ldg(a.starts + j) / kTile;
        s.chunk_rank[static_cast<long long>(b) * chunk_bound + c] = rank;
      }
    }
    if (threadIdx.x == 0)
      s.tile_total[static_cast<long long>(b) * n_tiles + t] = total;
  }
}

// a batch of 16 ring values into registers: volatile, so that the loads
// stay where they are written, a batch ahead of the adds that use them
__device__ __forceinline__ void load_batch(float4 (&r)[kBatch / 4],
                                           const float* x) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(x));
#pragma unroll
  for (int k = 0; k < kBatch / 4; ++k)
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(r[k].x), "=f"(r[k].y), "=f"(r[k].z), "=f"(r[k].w)
                 : "r"(a + 16 * k));
}

__device__ __forceinline__ void fold_batch(const float4 (&r)[kBatch / 4],
                                           float& s) {
#pragma unroll
  for (int k = 0; k < kBatch / 4; ++k) {
    s = __fadd_rn(s, r[k].x);
    s = __fadd_rn(s, r[k].y);
    s = __fadd_rn(s, r[k].z);
    s = __fadd_rn(s, r[k].w);
  }
}

// the left fold of one piece of n compacted values (-0.0 past n up to the
// piece's end: adding -0.0 changes no sum) in groups
// of 64 without a branch inside, each batch of 16's loads issued before
// the adds of the one before it (two register buffers in turn)
__device__ __forceinline__ void fold_piece(const float* x, int n, float& s) {
  const int ng = (n + kGroup - 1) / kGroup;
  float4 ra[kBatch / 4], rb[kBatch / 4];
  load_batch(ra, x);
  for (int g = 0; g < ng; ++g) {
    const float* y = x + kGroup * g;
    load_batch(rb, y + kBatch);
    fold_batch(ra, s);
    load_batch(ra, y + 2 * kBatch);
    fold_batch(rb, s);
    load_batch(rb, y + 3 * kBatch);
    fold_batch(ra, s);
    if (g + 1 < ng) load_batch(ra, y + kGroup);
    fold_batch(rb, s);
  }
}

// the squares' chain over a batch: the adds of this batch's squares, and
// in each add's shadow the square of the next batch's value (a warp
// issues in order: the multiplies must not wait in front of the adds)
__device__ __forceinline__ void fold_squares(float (&sq)[kBatch],
                                             const float4 (&next)[kBatch / 4],
                                             float& q) {
#pragma unroll
  for (int k = 0; k < kBatch / 4; ++k) {
    q = __fadd_rn(q, sq[4 * k]);
    sq[4 * k] = __fmul_rn(next[k].x, next[k].x);
    q = __fadd_rn(q, sq[4 * k + 1]);
    sq[4 * k + 1] = __fmul_rn(next[k].y, next[k].y);
    q = __fadd_rn(q, sq[4 * k + 2]);
    sq[4 * k + 2] = __fmul_rn(next[k].z, next[k].z);
    q = __fadd_rn(q, sq[4 * k + 3]);
    sq[4 * k + 3] = __fmul_rn(next[k].w, next[k].w);
  }
}

// fold_piece's sum of squares: values loaded two batches ahead, squared
// one batch ahead
__device__ __forceinline__ void fold_piece_sq(const float* x, int n,
                                              float& q) {
  const int ng = (n + kGroup - 1) / kGroup;
  float4 ra[kBatch / 4], rb[kBatch / 4];
  float sq[kBatch];
  load_batch(ra, x);
  load_batch(rb, x + kBatch);
#pragma unroll
  for (int k = 0; k < kBatch / 4; ++k) {
    sq[4 * k] = __fmul_rn(ra[k].x, ra[k].x);
    sq[4 * k + 1] = __fmul_rn(ra[k].y, ra[k].y);
    sq[4 * k + 2] = __fmul_rn(ra[k].z, ra[k].z);
    sq[4 * k + 3] = __fmul_rn(ra[k].w, ra[k].w);
  }
  for (int g = 0; g < ng; ++g) {
    // sq: the group's first batch squared; rb: its second batch
    const float* y = x + kGroup * g;
    const bool more = g + 1 < ng;
    load_batch(ra, y + 2 * kBatch);
    fold_squares(sq, rb, q);
    load_batch(rb, y + 3 * kBatch);
    fold_squares(sq, ra, q);
    if (more) load_batch(ra, y + kGroup);
    fold_squares(sq, rb, q);
    if (more) load_batch(rb, y + kGroup + kBatch);
    fold_squares(sq, ra, q);
  }
}

// f32 bits -> monotone in value, -0.0 below +0.0 (ordered.float_order_bits)
__device__ __forceinline__ unsigned order_bits(unsigned u) {
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// rank keys (ordered.extreme_keys) by the value's place g in the fold's
// order (ascending doc within the bucket)
__device__ __forceinline__ unsigned long long min_key(float v, unsigned g) {
  const unsigned u = __float_as_uint(v);
  if (v != v)
    return (u >> 31) ? ((1ull << 32) | ~g) : static_cast<unsigned long long>(g);
  return (2ull << 32) | order_bits(u);
}

__device__ __forceinline__ unsigned long long max_key(float v, unsigned g) {
  const unsigned u = __float_as_uint(v);
  if (v != v)
    return (u >> 31) ? static_cast<unsigned long long>(g) : ((1ull << 32) | ~g);
  return (2ull << 32) | ~order_bits(u);
}

// the smaller key and its value, over the warp
__device__ __forceinline__ void warp_min_key(unsigned long long& k,
                                             float& v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long ko = __shfl_xor_sync(~0u, k, o);
    const float vo = __shfl_xor_sync(~0u, v, o);
    if (ko < k) {
      k = ko;
      v = vo;
    }
  }
}

// a reduced key back to its value: a NaN's own bits, a number's from its
// order bits, no doc: the reduction's +-inf
__device__ __forceinline__ float decode(unsigned long long key, float v,
                                        bool largest) {
  if (key >= (3ull << 32)) return largest ? -__int_as_float(0x7f800000)
                                          : __int_as_float(0x7f800000);
  if ((key >> 32) < 2) return v;
  const unsigned lo = static_cast<unsigned>(key);
  const unsigned ord = largest ? ~lo : lo;
  return __uint_as_float((ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord);
}

// the warps of a (row, bucket): its sum's fold, its squares' fold, its
// count / min / max
enum Role { kSum = 0, kSq = 1, kMeta = 2 };

__global__ void __launch_bounds__(96, 5)
fold_kernel(const __grid_constant__ BucketStatsArgs a, Scratch s) {
  __shared__ __align__(16) float ring[2][2][kPiece];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the roles asked, in order: warp 0 the first one
  int role = warp;
  if (a.sum == nullptr) ++role;
  if (role >= kSq && a.sum_sq == nullptr) ++role;
  const long long chain = blockIdx.x;
  const int b = static_cast<int>(chain / a.n_buckets);
  const int j = static_cast<int>(chain - static_cast<long long>(b) * a.n_buckets);
  const int n_tiles = (a.cap + kTile - 1) / kTile;
  const long long chunk_bound = n_tiles + a.n_buckets;
  const long long stride = static_cast<long long>(n_tiles) * kTile;
  const int kept = __ldg(a.starts + a.n_buckets);
  const int sj = __ldg(a.starts + j), ej = __ldg(a.starts + j + 1);
  const int c0 = __ldg(a.chunk_first + j), c1 = __ldg(a.chunk_first + j + 1);
  const int* crank = s.chunk_rank + static_cast<long long>(b) * chunk_bound;
  const int* ttot = s.tile_total + static_cast<long long>(b) * n_tiles;
  const float* vrow = s.vals + static_cast<long long>(b) * stride;

  // lane k: chunk cb + k's compacted values, [src, src + len) in vrow
  auto chunk_of = [&](int cb, long long& src, int& len) {
    const int c = cb + lane;
    src = 0;
    len = 0;
    if (c < c1) {
      const int t = sj / kTile + (c - c0);
      const int end_pos = min(min((t + 1) * kTile, ej), kept);
      const int r0 = crank[c];
      const int r1 = end_pos == min((t + 1) * kTile, kept) ? ttot[t]
                                                           : crank[c + 1];
      src = static_cast<long long>(t) * kTile + r0;
      len = r1 - r0;
    }
  };

  if (role == kMeta) {
    // count, and the min / max rank keys of every value, 32 at a time
    const bool keys = a.min != nullptr || a.max != nullptr;
    unsigned long long kmn = kNone, kmx = kNone;
    float vmn = 0.0f, vmx = 0.0f;
    int count = 0;
    for (int cb = c0; cb < c1; cb += 32) {
      long long src;
      int len;
      chunk_of(cb, src, len);
      int at = len;            // the chunk's first place in the fold
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(~0u, at, o);
        if (lane >= o) at += y;
      }
      at += count - len;
      const int batch = __shfl_sync(~0u, at + len, 31) - count;
      if (keys) {
        for (int k = 0; k < 32 && cb + k < c1; ++k) {
          const long long from = __shfl_sync(~0u, src, k);
          const int n = __shfl_sync(~0u, len, k);
          const int g0 = __shfl_sync(~0u, at, k);
          // 16-byte aligned loads over the chunk's values, kMetaLoads a
          // lane in flight, then their keys (vrow is 16-byte aligned)
          const long long f0 = from >> 2, f1 = (from + n + 3) >> 2;
          for (long long fb = f0; fb < f1; fb += 32 * kMetaLoads) {
            float4 q[kMetaLoads];
#pragma unroll
            for (int u = 0; u < kMetaLoads; ++u) {
              const long long f = fb + 32 * u + lane;
              q[u] = f < f1 ? __ldg(reinterpret_cast<const float4*>(vrow) + f)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            }
#pragma unroll
            for (int u = 0; u < kMetaLoads; ++u) {
              const long long f = fb + 32 * u + lane;
              const float vs[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const long long i = 4 * f + c - from;   // place in the chunk
                if (i < 0 || i >= n) continue;
                const float v = vs[c];
                const unsigned long long x = min_key(v, g0 + i);
                const unsigned long long y = max_key(v, g0 + i);
                if (x < kmn) {
                  kmn = x;
                  vmn = v;
                }
                if (y < kmx) {
                  kmx = y;
                  vmx = v;
                }
              }
            }
          }
        }
      }
      count += batch;
    }
    warp_min_key(kmn, vmn);
    warp_min_key(kmx, vmx);
    if (lane == 0) {
      // the reference's f32 sum of 1.0s stops at 2^24
      if (a.count) a.count[chain] = static_cast<float>(min(count, 1 << 24));
      if (a.min) a.min[chain] = decode(kmn, vmn, false);
      if (a.max) a.max[chain] = decode(kmx, vmx, true);
    }
    return;
  }

  // a fold warp: pieces of kPiece values loaded into registers kAhead
  // pieces ahead (coalesced, a lane kPiece / 32 values), each stored into
  // one of two ring slots a piece before its fold
  float (*my_ring)[kPiece] = ring[warp];
  long long src;
  int len;
  int cb = c0, ci = 0, off = 0;  // the cursor: chunk cb + ci, at off
  chunk_of(cb, src, len);
  // the next piece's values (-0.0 past its count: s + -0.0 == s for
  // every s, -0.0 included, which a fold of flushed values can reach;
  // squared it is +0.0, and a sum of squares is never -0.0) and its count
  auto load = [&](float (&st)[kPiece / 32], int& sn) {
    int n = 0;
    long long from = 0;
    // skip empty or spent chunks, loading the next batch as needed
    while (cb + ci < c1) {
      const int l = __shfl_sync(~0u, len, ci);
      if (off < l) {
        n = min(kPiece, l - off);
        from = __shfl_sync(~0u, src, ci) + off;
        off += n;
        break;
      }
      off = 0;
      if (++ci == 32) {
        cb += 32;
        ci = 0;
        chunk_of(cb, src, len);
      }
    }
#pragma unroll
    for (int r = 0; r < kPiece / 32; ++r) {
      const int k = r * 32 + lane;
      st[r] = k < n ? __ldg(vrow + from + k) : -0.0f;
    }
    sn = n;
  };
  auto store = [&](const float (&st)[kPiece / 32], int slot) {
#pragma unroll
    for (int r = 0; r < kPiece / 32; ++r) my_ring[slot][r * 32 + lane] = st[r];
  };
  float stage[kAhead][kPiece / 32];
  int stage_n[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) load(stage[u], stage_n[u]);
  // piece i sits in slot i & 1; stage[(i + 1) % kAhead] holds piece i + 1
  store(stage[0], 0);
  int n_cur = stage_n[0];
  load(stage[0], stage_n[0]);
  __syncwarp();
  float sum = 0.0f;
  bool done = false;
  while (!done) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (done) continue;
      if (n_cur == 0) {       // pieces come in order: none is left
        done = true;
        continue;
      }
      const int nu = (u + 1) % kAhead;
      store(stage[nu], nu & 1);
      const int n_next = stage_n[nu];
      load(stage[nu], stage_n[nu]);
      if (role == kSq)
        fold_piece_sq(my_ring[u & 1], n_cur, sum);
      else
        fold_piece(my_ring[u & 1], n_cur, sum);
      __syncwarp();
      n_cur = n_next;
    }
  }
  if (lane == 0) (role == kSq ? a.sum_sq : a.sum)[chain] = sum;
}

// the probe of the fold's bound: one thread, n dependent __fadd_rn of
// two values it cannot know at compile time (their sum lands in out[0]),
// its clock64 cycles in cycles[0]
__global__ void add_chain_kernel(const float* x, float* out,
                                 long long* cycles, int n) {
  const float v = x[0], w = x[1];
  float s = 0.0f;
  const long long t0 = clock64();
  for (int i = 0; i < n; i += 8) {
#pragma unroll
    for (int k = 0; k < 8; k += 2) {
      s = __fadd_rn(s, v);
      s = __fadd_rn(s, w);
    }
  }
  const long long t1 = clock64();
  out[0] = s;
  cycles[0] = t1 - t0;
}

}  // namespace

extern "C" int bucket_add_chain(const float* x, float* out, long long* cycles,
                                int n, void* stream) {
  add_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, cycles, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" long long ordered_bucket_stats_scratch(int B, int cap,
                                                  int n_buckets) {
  if (B <= 0 || cap <= 0 || n_buckets <= 0) return 0;
  return carve(nullptr, B, cap, n_buckets).bytes;
}

extern "C" int ordered_bucket_stats(const BucketStatsArgs* args,
                                    void* stream) {
  const BucketStatsArgs a = *args;
  if (a.B <= 0 || a.cap <= 0 || a.n_buckets <= 0) return 0;
  const Scratch s = carve(a.scratch, a.B, a.cap, a.n_buckets);
  if (a.scratch_len < s.bytes) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int want_vals = a.sum != nullptr || a.sum_sq != nullptr ||
                        a.min != nullptr || a.max != nullptr;
  const int n_tiles = (a.cap + kTile - 1) / kTile;
  const int groups = (a.B + kRows - 1) / kRows;
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  compact_kernel<<<dim3(n_tiles, groups), kThreads, 0, st>>>(a, s, want_vals);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long chains = static_cast<long long>(a.B) * a.n_buckets;
  if (chains > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  // a warp per role asked: the sum's fold, the squares' fold, the rest
  const int meta = a.count != nullptr || a.min != nullptr || a.max != nullptr;
  const int warps = (a.sum != nullptr) + (a.sum_sq != nullptr) + meta;
  fold_kernel<<<static_cast<unsigned>(chains), 32 * warps, 0, st>>>(a, s);
  return static_cast<int>(cudaGetLastError());
}
