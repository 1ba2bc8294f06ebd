// Fused dense sufficient statistics for the VB E-step (sm_90a).
//
// Replaces pylda_tpu/ops/pallas_sstats.py::pallas_dense_sstats (kernel
// body _sstats_tile_kernel).  Computes, for counts C [D, Vc] (bf16 or
// f32, Vc >= V, zero-padded), expEtheta [D, K] and expElogbeta [K, V]:
//
//   phinorm[d, v] = sum_k expEtheta[d, k] * expElogbeta[k, v] + eps
//   raw[k, v]     = sum_d expEtheta[d, k] * C[d, v] / phinorm[d, v]
//   sstats[k, v]  = expElogbeta[k, v] * raw[k, v]            (v < V)
//   score         = sum_{d, v} C[d, v] * log(phinorm[d, v])
//
// Only nonzero counts need work: a zero count adds nothing to raw or to
// the score, so phinorm and the ratio are needed where C != 0 only, and
// the work is 4*K FLOP a nonzero.  Bound on an H100 SXM at the ragged
// flagship chunk (D=4096, Vc=10240 bf16, K=100, ~483k nonzeros, 1.2%):
// ~0.19 GFLOP (~3 us at the 67 TFLOP/s f32 rate) against ~25 us to read
// the 84 MB of counts once at 3.35 TB/s: bytes.  The kernel reads each
// count once, coalesced, and does arithmetic only at the nonzeros.
//
// Design.  Grid: (vocab tiles of 64 columns) x (row splits); the host's
// plan (ops/sstats.py::plan) sets the splits so the card holds >= 2 CTAs
// an SM.  A CTA of 256 threads stages its expElogbeta tile, [64 columns]
// [KP topics], once, and walks its rows in chunks of 32, in a pipeline:
//   1. the chunk's counts [32, 64] arrive by 16-byte cp.async two chunks
//      ahead of their use (three buffers);
//   2. compaction, once a chunk ahead: warp w reads columns 8w..8w+7 of
//      every row as 16-byte vectors, and a ballot a column gives that
//      column's 32-bit row mask (plus the chunk's touched-row mask);
//   3. expEtheta is staged, one chunk ahead, for the touched rows only
//      (about half the rows of a chunk at the flagships), from L2;
//   4. column c has a fixed owner, lanes 4c..4c+3, each holding KP/4 of
//      its topics' sums in registers (interleaved float4s).  The four
//      walk the column's mask in row order; for each nonzero: phinorm
//      (partial dots, then a 2-step butterfly inside the four), ratio =
//      C / phinorm, the score term, and acc += expEtheta[d] * ratio.
// No thread tests zeros in the arithmetic loop; a warp's eight columns
// take as many steps as the busiest of them.  What bounds it on an H100
// (PERF.md): not the counts' bytes, but a chunk's latency chain (barriers,
// L2 gathers of expEtheta, and the column walk, whose steps use 4 of 32
// lanes a column at the flagships' densities) and the grid's fixed cost
// (each split stages the expElogbeta tile and writes a partial).
//
// Wide K (K > 256).  A column's sums no longer fit 4 lanes' registers
// (builds of 8 to 32 lanes a column, each CTA walking its near-empty row
// chunks in turn, took 3.62 ms at the chunk below), so above K = 256 the
// cluster kernel below runs, its cluster the smallest power of two whose
// slices hold at most 512 topics (1 CTA at K <= 512, 2 at <= 1024, 4 at
// <= 2048, 8 at <= 4096, 16 above).  At SVI config 5's first minibatch
// chunk ([1216, 100352] bf16 counts, K = 1000, 182,065 nonzeros, 0.15%;
// 2 CTAs of 512 topics, 66 clusters in flight, ~48 tiles each) the bound
// is bytes: the 244 MB of counts, expElogbeta read and sstats written
// once, 0.313 ms at 3.35 TB/s, against 0.73 GFLOP.
// Measured there on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md,
// scripts/torch_sstats_wide_ab.py): 0.69 ms float32, 0.73 ms bf16, ~14 us
// a tile, each tile's steps in turn as above K = 4096 (other clusters, two
// CTAs an SM and a deeper counts ring were no faster).  The dense E-step's
// final pass at K = 1000 ([4096, 4096], 2.8% nonzero: 128 tiles, each
// CTA's share of a tile past the push cap, so every CTA walks every tile
// from device memory) 1.00 ms against the one pass's 2.33 and its plain
// version's 1.69.
//
// Determinism.  Each sum has one owner that adds in row order.  With more
// than one row split, each CTA writes its partial sums to scratch and the
// last CTA of the tile to arrive (a counter behind __threadfence) adds the
// splits' partials in split order 0, 1, .., multiplies by expElogbeta and
// writes sstats.  Each CTA's score is an f64 sum in a fixed order, and the
// last CTA of the grid sums those in a fixed order.  No atomic adds a
// floating-point value, so every call returns the same bits.  Plain f32
// FMAs and IEEE division, no TF32: the CPU reference is plain f32.
//
// Above K = 256 the entry pylda_dense_sstats_wide launches a cluster
// kernel instead: the topics split over a thread-block cluster, one
// launch, nothing read back (its note is at the kernel, below).
//
// A topic range (pylda_dense_sstats_range, lambda split over topics: the
// rank of a model group holding topics [k0, k1)).  phinorm, the ratio and
// the score still need all K topics of the word, so everything up to the
// ratio is the full kernel's, in the same build (keyed on the whole K), the
// same grid and the same order; only the sums of topics k0..k1-1 are
// accumulated, stored as split partials ([k1 - k0] rounded out to whole
// float4s a column) and written, as rows 0..k1-k0-1 of a [k1 - k0, V]
// output.  Each kept sum is the full kernel's chain of FMAs in row order,
// its splits met in split order, so the range's rows are the full
// kernel's rows bit for bit.  The grid stays the full K's: a build keyed
// on k1 - k0 would place a column's phinorm dot on other lanes (another
// summation order), and another split count would change the order the
// splits meet in.  The full-range entry is the range [0, K).
//
// bf16 operands (built with -DPYLDA_BF16=1, ops/_build.py): the function
// of estep_dense_sstats(compute_dtype="bfloat16") and of the Pallas
// kernel's bf16 mode.  expEtheta (in phinorm and in the sums), expElogbeta
// as phinorm reads it, and the ratio are rounded to bf16 (nearest even);
// the sums stay f32; the score and the epilogue's multiply by expElogbeta
// use f32 values.  At K <= 256 the bf16 build runs the tensor-core kernel
// of dense_sstats_mma.cuh (both products on mma.sync over the dense
// tile) in place of the walk, which only the float32 build keeps; above
// 256 the cluster kernel rounds its operands where it reads them.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "cluster_ptx.cuh"

// The build's operand mode: 0 float32, 1 bf16 operands (-DPYLDA_BF16=1).
#ifndef PYLDA_BF16
#define PYLDA_BF16 0
#endif

namespace {

namespace cg = cooperative_groups;

constexpr bool kBf16 = PYLDA_BF16 != 0;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileV = 64;    // vocab columns a CTA owns at 4 lanes a column
constexpr int kRows = 32;     // rows a chunk: a column's row mask is a word

constexpr int kLanes = 4;     // lanes that own a column's sums (LPC)

// KP = 4 * kLanes * N4 topics (kLanes lanes x N4 float4s).  LD, the row
// stride of the staged expEtheta rows and expElogbeta columns, puts the
// float4s that a quarter warp's two adjacent 4-lane groups read into 8
// distinct bank quads.  Counts chunks are issued AHEAD = 2 chunks ahead of
// their use into CNT_BUFS = 3 buffers (the expEtheta loads take their own
// pipeline groups).
template <int N4>
struct Layout {
  static constexpr int KP = 4 * kLanes * N4;
  static constexpr int LD = KP + ((KP / 4) % 8 == 4 ? 0 : 16);
  static constexpr int AHEAD = 2;
  static constexpr int CNT_BUFS = AHEAD + 1;
};

// Row stride (elements) of a staged counts chunk: the columns and 16
// bytes, so the 8 lanes of a quarter warp reading 8 rows hit 8 bank quads.
template <typename CT>
__host__ __device__ constexpr int cnt_ld() {
  return kTileV + 16 / (int)sizeof(CT);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Bit e set where element e of the 8 counts at p is nonzero (+-0 is zero).
__device__ __forceinline__ unsigned nonzero8(const __nv_bfloat16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
  unsigned bits = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    bits |= (((w[e / 2] >> (16 * (e % 2))) & 0x7fffu) != 0u) << e;
  return bits;
}
__device__ __forceinline__ unsigned nonzero8(const float* p) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint4 b = *reinterpret_cast<const uint4*>(p + 4);
  const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  unsigned bits = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) bits |= ((w[e] & 0x7fffffffu) != 0u) << e;
  return bits;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// An operand as the build's mode reads it: as is, or rounded to bf16
// (nearest even) and widened back.
__device__ __forceinline__ float operand(float x) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// Issues the copies of counts rows [d0, d0 + kRows) x columns
// [v0, v0 + kTileV) into dst ([kRows][cnt_ld]) and commits them as one
// group; rows past d_hi and columns past Vc read as zero.  vec: 16-byte
// copies (rows 16-byte aligned); else element loads.
template <typename CT>
__device__ __forceinline__ void load_chunk(CT* dst, const CT* counts, int d0,
                                           int d_hi, int v0, int Vc,
                                           bool vec) {
  constexpr int E = 16 / sizeof(CT);  // elements a 16-byte copy
  constexpr int SEGS = kRows * kTileV / E;
  for (int i = threadIdx.x; i < SEGS; i += kThreads) {
    const int r = i / (kTileV / E), c = (i % (kTileV / E)) * E;
    const int d = d0 + r, v = v0 + c;
    CT* s = dst + r * cnt_ld<CT>() + c;
    if (vec) {
      // Vc * sizeof(CT) is a multiple of 16: a copy is all in or all out.
      if (d < d_hi && v < Vc)
        __pipeline_memcpy_async(s, counts + (size_t)d * Vc + v, 16);
      else
        *reinterpret_cast<uint4*>(s) = make_uint4(0u, 0u, 0u, 0u);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        s[e] = (d < d_hi && v + e < Vc) ? counts[(size_t)d * Vc + v + e]
                                        : CT(0.f);
    }
  }
  __pipeline_commit();
}

// Compaction of a staged chunk, once: warp w reads columns 8w..8w+7 of row
// `lane` as 16-byte vectors, and one ballot a column gives that column's
// row mask (cmask[c]); rmask[w] gets the rows with a nonzero in the warp's
// 8 columns (the chunk's touched rows are the OR of the 8 words).  Plain
// stores of whole words: nothing to zero first, nothing timing-dependent.
template <typename CT>
__device__ __forceinline__ void compact(const CT* cnt, unsigned* cmask,
                                        unsigned* rmask) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned bits = nonzero8(cnt + lane * cnt_ld<CT>() + 8 * warp);
  unsigned mine = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const unsigned m = __ballot_sync(kFull, (bits >> e) & 1u);
    if (lane == e) mine = m;
  }
  if (lane < 8) cmask[8 * warp + lane] = mine;
  const unsigned any = __ballot_sync(kFull, bits != 0u);
  if (lane == 0) rmask[warp] = any;
}

// Issues the copies of expEtheta rows d0 + r, r a touched row, into
// dst ([kRows][ld]) and commits them as one group.
__device__ __forceinline__ void load_et(float* dst, int ld, const float* et,
                                        int d0, unsigned touched, int K,
                                        bool et_vec) {
  if (et_vec) {
    const int kq = K / 4;
    for (int i = threadIdx.x; i < kRows * kq; i += kThreads) {
      const int r = i / kq, q = i - r * kq;
      if ((touched >> r) & 1u)
        __pipeline_memcpy_async(dst + r * ld + 4 * q,
                                et + (size_t)(d0 + r) * K + 4 * q, 16);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * K; i += kThreads) {
      const int r = i / K, k = i - r * K;
      if ((touched >> r) & 1u)
        __pipeline_memcpy_async(dst + r * ld + k,
                                et + (size_t)(d0 + r) * K + k, 4);
    }
  }
  __pipeline_commit();
}

__device__ __forceinline__ unsigned touched_rows(const unsigned* rmask) {
  unsigned t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t |= rmask[w];
  return t;
}

// One CTA's tile and row split.
template <typename CT, int N4>
__global__ void __launch_bounds__(kThreads) dense_sstats_kernel(
    const CT* __restrict__ counts, const float* __restrict__ et,
    const float* __restrict__ eeb, float* __restrict__ sstats,
    double* __restrict__ score_part, float* __restrict__ score_out,
    float* __restrict__ partial, int* __restrict__ counters, int D, int Vc,
    int V, int K, int k0, int k1, float eps, int rows_per_split) {
  using L = Layout<N4>;
  constexpr int LPC = kLanes;
  extern __shared__ __align__(16) float smem[];
  float* eeb_s = smem;                        // [kTileV][LD] expElogbeta^T
  float* et_s = eeb_s + kTileV * L::LD;       // [2][kRows][LD] touched rows
  // [CNT_BUFS][kRows][cnt_ld]
  CT* cnt_s = reinterpret_cast<CT*>(et_s + 2 * kRows * L::LD);
  unsigned* cmask_s = reinterpret_cast<unsigned*>(
      cnt_s + L::CNT_BUFS * kRows * cnt_ld<CT>());  // [2][kTileV] masks
  unsigned* rmask_s = cmask_s + 2 * kTileV;         // [2][8] row masks
  __shared__ double score_s[kWarps];
  __shared__ int last_s, last_grid_s;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // Owner of column c: lanes LPC c .. LPC c + LPC - 1; lane j holds the
  // float4s j, j + LPC, .. of its topics.
  const int c = tid / LPC, j = tid % LPC;
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int v0 = tile * kTileV;
  const int d_lo = split * rows_per_split;
  const int d_hi = min(D, d_lo + rows_per_split);
  const int chunks = d_hi > d_lo ? (d_hi - d_lo + kRows - 1) / kRows : 0;
  const bool vec = (Vc * (int)sizeof(CT)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(counts) % 16 == 0;
  const bool et_vec =
      K % 4 == 0 && reinterpret_cast<uintptr_t>(et) % 16 == 0;
  auto cbuf = [cnt_s](int i) {
    return cnt_s + (i % L::CNT_BUFS) * kRows * cnt_ld<CT>();
  };
  // The float4s [q0, q1) of a column's sums hold the topic range; lane j's
  // float4 i is q = j + LPC i.  QR float4s a column of split partials.
  const int q0 = k0 / 4, q1 = (k1 + 3) / 4, QR = q1 - q0;
  auto kept = [q0, q1, j](int i) {
    const int q = j + LPC * i;
    return q >= q0 && q < q1;
  };

  // The pipeline.  Chunk i uses counts buffer i % CNT_BUFS and et / mask
  // buffer i % 2.  In iteration i (after its first barrier every thread is
  // done with chunk i-1): issue chunk i+AHEAD's counts, compact chunk i+1,
  // issue chunk i+1's expEtheta rows, then compute chunk i.
  for (int i = 0; i < L::AHEAD && i < chunks; ++i)
    load_chunk<CT>(cbuf(i), counts, d_lo + i * kRows, d_hi, v0, Vc, vec);
  // The expElogbeta tile, transposed: a warp copies 16 topics of 2 columns
  // (LD = 16 mod 32: its 32 stores hit 32 banks).
  for (int i = tid; i < kTileV * L::LD; i += kThreads) {
    const int rest = i / 16;
    const int cc = rest % kTileV, k = (rest / kTileV) * 16 + i % 16;
    float* dst = eeb_s + cc * L::LD + k;
    if (k < K && v0 + cc < V)
      __pipeline_memcpy_async(dst, eeb + (size_t)k * V + v0 + cc, 4);
    else
      *dst = 0.f;
  }
  __pipeline_commit();
  for (int i = tid; i < 2 * kRows * L::LD; i += kThreads) et_s[i] = 0.f;
  __pipeline_wait_prior(0);
  __syncthreads();
  if (chunks > 0) {
    compact(cbuf(0), cmask_s, rmask_s);
    __syncthreads();
    load_et(et_s, L::LD, et, d_lo, touched_rows(rmask_s), K, et_vec);
  }

  float4 acc[N4];
#pragma unroll
  for (int i = 0; i < N4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  double score = 0.0;

  const float* bcol = eeb_s + c * L::LD + 4 * j;
  for (int ci = 0; ci < chunks; ++ci) {
    const int d0 = d_lo + ci * kRows;
    const int cur = ci & 1, nxt = cur ^ 1;
    // Chunk ci's expEtheta and chunk ci+1's counts are in.
    __pipeline_wait_prior(0);
    __syncthreads();
    if (ci + L::AHEAD < chunks)
      load_chunk<CT>(cbuf(ci + L::AHEAD), counts, d0 + L::AHEAD * kRows,
                     d_hi, v0, Vc, vec);
    if (ci + 1 < chunks)
      compact(cbuf(ci + 1), cmask_s + nxt * kTileV, rmask_s + nxt * kWarps);
    __syncthreads();  // chunk ci+1's masks
    if (ci + 1 < chunks)
      load_et(et_s + nxt * kRows * L::LD, L::LD, et, d0 + kRows,
              touched_rows(rmask_s + nxt * kWarps), K, et_vec);

    // Column c's nonzeros in row order, by its LPC lanes.
    const CT* cnt = cbuf(ci);
    const float* erow = et_s + cur * kRows * L::LD + 4 * j;
    unsigned m = cmask_s[cur * kTileV + c];
    const int n = __popc(m);
    const int steps = __reduce_max_sync(kFull, n);
    for (int t = 0; t < steps; ++t) {
      const bool on = t < n;
      const int r = on ? __ffs(m) - 1 : 0;
      m &= m - 1;
      const float* e_r = erow + r * L::LD;
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (on) {  // lanes without a nonzero read nothing
#pragma unroll
        for (int i = 0; i < N4; ++i) {
          const float4 e = lds4(e_r + 4 * LPC * i);
          const float4 b = lds4(bcol + 4 * LPC * i);
          q.x = fmaf(e.x, b.x, q.x);
          q.y = fmaf(e.y, b.y, q.y);
          q.z = fmaf(e.z, b.z, q.z);
          q.w = fmaf(e.w, b.w, q.w);
        }
      }
      float p = (q.x + q.y) + (q.z + q.w);
      // a + b == b + a: all LPC lanes get the same bits.
#pragma unroll
      for (int off = 1; off < LPC; off <<= 1)
        p += __shfl_xor_sync(kFull, p, off);
      if (on) {
        const float cv = to_float(cnt[r * cnt_ld<CT>() + c]);
        const float pn = p + eps;
        const float ratio = cv / pn;
        if (j == 0) score += (double)(cv * logf(pn));
#pragma unroll
        for (int i = 0; i < N4; ++i) {
          if (!kept(i)) continue;
          const float4 e = lds4(e_r + 4 * LPC * i);
          acc[i].x = fmaf(e.x, ratio, acc[i].x);
          acc[i].y = fmaf(e.y, ratio, acc[i].y);
          acc[i].z = fmaf(e.z, ratio, acc[i].z);
          acc[i].w = fmaf(e.w, ratio, acc[i].w);
        }
      }
    }
  }

  // The CTA's score, in a fixed order.
  for (int off = 16; off > 0; off >>= 1)
    score += __shfl_down_sync(kFull, score, off);
  if (lane == 0) score_s[warp] = score;
  __syncthreads();
  const int blocks = gridDim.x * splits;
  if (tid == 0) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += score_s[w];
    score_part[split * gridDim.x + tile] = s;
  }
  // Partial sums: [tile][split][kTileV columns][4 QR]; lane j's float4 i at
  // 4 (j + LPC i - q0) of its column's.
  float* mine =
      partial + ((size_t)(tile * splits + split) * kTileV + c) * 4 * QR;
  auto at = [q0, j](int i) { return 4 * (j + LPC * i - q0); };
  if (splits > 1) {
#pragma unroll
    for (int i = 0; i < N4; ++i)
      if (kept(i)) __stcg(reinterpret_cast<float4*>(mine + at(i)), acc[i]);
  }
  // The last CTA of a tile to arrive sums its splits; the last CTA of the
  // grid sums the score parts.  Each resets its counter for the next call.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int last = 1;
    if (splits > 1) {
      last = atomicAdd(&counters[tile], 1) == splits - 1;
      if (last) counters[tile] = 0;
    }
    last_s = last;
    last_grid_s = atomicAdd(&counters[gridDim.x], 1) == blocks - 1;
    if (last_grid_s) counters[gridDim.x] = 0;
  }
  __syncthreads();
  if (last_grid_s) {
    __threadfence();
    double t = 0.0;  // thread i: parts i, i + 256, ..; then a fixed tree
    for (int b = tid; b < blocks; b += kThreads) t += __ldcg(score_part + b);
    for (int off = 16; off > 0; off >>= 1)
      t += __shfl_down_sync(kFull, t, off);
    if (lane == 0) score_s[warp] = t;
    __syncthreads();
    if (tid == 0) {
      double s = 0.0;
      for (int w = 0; w < kWarps; ++w) s += score_s[w];
      *score_out = (float)s;
    }
  }
  if (!last_s) return;
  if (splits > 1) {  // split order 0, 1, ..: the same sum on every call
    __threadfence();
    const float* base = mine - (size_t)split * kTileV * 4 * QR;
#pragma unroll
    for (int i = 0; i < N4; ++i)
      if (kept(i))
        acc[i] = __ldcg(reinterpret_cast<const float4*>(base + at(i)));
#pragma unroll 4
    for (int s = 1; s < splits; ++s) {
      const float* ps = base + (size_t)s * kTileV * 4 * QR;
#pragma unroll
      for (int i = 0; i < N4; ++i) {
        if (!kept(i)) continue;
        const float4 q =
            __ldcg(reinterpret_cast<const float4*>(ps + at(i)));
        acc[i].x += q.x;
        acc[i].y += q.y;
        acc[i].z += q.z;
        acc[i].w += q.w;
      }
    }
  }
  const int v = v0 + c;
  if (v < V) {
#pragma unroll
    for (int i = 0; i < N4; ++i) {
      const float a[4] = {acc[i].x, acc[i].y, acc[i].z, acc[i].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * (j + LPC * i) + e;
        if (k >= k0 && k < k1)
          sstats[(size_t)(k - k0) * V + v] = bcol[4 * LPC * i + e] * a[e];
      }
    }
  }
}

// Sets the kernel's shared memory and launches it.
template <typename CT, int N4>
cudaError_t launch(const void* counts, const void* et, const void* eeb,
                   void* sstats, void* score_part, void* score_out,
                   void* partial, void* counters, int D, int Vc, int V, int K,
                   int k0, int k1, float eps, int splits, int rows_per_split,
                   cudaStream_t stream) {
  using L = Layout<N4>;
  const size_t smem =
      sizeof(float) * (size_t)(kTileV + 2 * kRows) * L::LD +
      L::CNT_BUFS * sizeof(CT) * kRows * cnt_ld<CT>() +
      sizeof(unsigned) * 2 * (kTileV + kWarps);
  const auto kern = dense_sstats_kernel<CT, N4>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Vc + kTileV - 1) / kTileV, splits);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const CT*>(counts), static_cast<const float*>(et),
      static_cast<const float*>(eeb), static_cast<float*>(sstats),
      static_cast<double*>(score_part), static_cast<float*>(score_out),
      static_cast<float*>(partial), static_cast<int*>(counters), D, Vc, V, K,
      k0, k1, eps, rows_per_split);
  return cudaGetLastError();
}

// The kernel build whose columns have 4 lanes of 4 * N4 topics each: the
// first with K <= 16 * N4 (ops/sstats.py::BUILDS mirrors it).
template <typename CT>
cudaError_t dispatch(int K, const void* counts, const void* et,
                     const void* eeb, void* sstats, void* score_part,
                     void* score_out, void* partial, void* counters, int D,
                     int Vc, int V, int k0, int k1, float eps, int splits,
                     int rows_per_split, cudaStream_t s) {
#define PYLDA_BUILD(N, LANES)                                              \
  if (K <= 4 * LANES * N)                                                  \
    return launch<CT, N>(counts, et, eeb, sstats, score_part, score_out,   \
                         partial, counters, D, Vc, V, K, k0, k1, eps,      \
                         splits, rows_per_split, s);
  PYLDA_BUILD(1, 4)
  PYLDA_BUILD(2, 4)
  PYLDA_BUILD(4, 4)
  PYLDA_BUILD(7, 4)
  PYLDA_BUILD(8, 4)
  PYLDA_BUILD(16, 4)
#undef PYLDA_BUILD
  return cudaErrorInvalidValue;
}

// -- Above K = 256: the cluster kernel ---------------------------------------
//
// Above the one-pass builds a column's sums fit no 4 lanes' registers, and
// above K = 4096 an expElogbeta tile of all K topics fits no CTA: at
// K = 8192 a column is 32 KB.  So the topics split over a thread-block
// cluster (at K <= 512 a cluster of one CTA, whose exchange is a store to
// itself).
//
// What bounds it.  At SVI config 5's chunk ([1216, 100352] bf16 counts,
// K = 8192, 182,065 nonzeros, 0.15%) the call must read the 0.244 GB of
// counts and the 3.28 GB of expElogbeta once and write the 3.28 GB of
// sstats once: 6.80 GB, 2.041 ms at 3.35 TB/s, against 4 K FLOP a
// nonzero (~6 GFLOP, 0.09 ms at 67 TFLOP/s): bytes.  The two passes this
// kernel replaced read the counts three times and expElogbeta twice, and
// read the nonzero count back to the host between them.  Rows of
// expElogbeta and sstats are read and written in pieces of a tile's
// width: on an H100 64-byte pieces held the stream to about half the
// rate of 128-byte ones (PERF.md), so a tile is 32 columns, 128 bytes,
// wherever a lane's registers hold the slice.
//
// Design: one launch, persistent clusters walking column tiles.
//   - A cluster of C CTAs (p.cluster, 16 above K = 4096 and the smallest
//     power of two with slices of at most 512 topics below it;
//     ops/sstats.py::plan, fixed by the sweep in PERF.md) takes the
//     column tiles q, q + Q, .. (q its index, Q the clusters in flight:
//     cudaOccupancyMaxActiveClusters, one CTA an SM) of the counts' Vc,
//     COLS = 32 columns a tile (16 past slices of 512 topics).  CTA r
//     owns the topic slice [r S, (r + 1) S), S = p.slice whole boxes of
//     kWideBox rows.  Warp w owns the tile's columns [w CPW, (w + 1) CPW)
//     (CPW = COLS / 8) and lane l the slice rows l, l + 32, ..: RPL =
//     64 / CPW rows, so a lane holds kWideLaneFloats values of each.
//   - expElogbeta.  Each CTA copies its [S x COLS] slice of the tile by
//     TMA (a 2-D tensor map over [K, V], boxes of the tile's width and of
//     the most rows of 256, 128, 64 and 32 that divide S, the swizzle of
//     that width, rows past K and columns past V
//     zero-filled, an L2 evict-first hint: it is streamed once) into one
//     buffer on an mbarrier; each lane takes its values into registers
//     (conflict-free under the swizzle), the batches then use the buffer
//     for expEtheta rows, and the next tile's copy starts into it as the
//     last batch ends, in flight through the next tile's walk and this
//     tile's epilogue.  The registers serve phinorm and the epilogue:
//     expElogbeta is read from device memory once a call.  (V not a
//     multiple of 4: plain loads into the same layout, the same bits.)
//   - The counts.  CTA r walks its share of every tile's rows (D / C
//     rows: 76 at config 5's chunk), [128 x COLS] chunks by 16-byte
//     cp.async, two chunks ahead across tiles, two threads a row: their
//     nonzero masks, a block scan, and the nonzeros compacted in
//     row-major order (row and column, count).  It pushes its count and
//     up to kWidePushCap nonzeros into every rank's push area for it
//     (st.async on that rank's mbarriers), so the counts are read from
//     device memory once.  One area serves every tile: a rank pushes the
//     next tile after the last exchange of this one, which waits for
//     every rank's partials, each sent after that rank read its list.
//     The list is the ranks' pushes in rank order: row-major, each
//     column's nonzeros in row order, the same in every CTA.  The cap
//     holds a share of the ragged flagship's chunk (~94 nonzeros, at
//     most 151 of 256 rows x 32 columns at 1.2%); a tile where a rank has
//     more (denser counts) is walked whole by every CTA from device
//     memory instead (16-byte loads), in the same order.  The next tile's
//     walk and push run before this tile's epilogue, whose stores hide
//     the push.  No list, no count and no sync leaves the card.
//   - Batches of up to p.batch nonzeros (the plan fills the shared
//     memory: 76 at config 5's chunk, whose tiles hold ~58, 1% more than
//     76).  A tile of more runs batches of half as many, alternating
//     between the two halves of the slots: the next batch's list and
//     expEtheta copies are issued before this one runs (the ragged
//     flagship's tiles: ~1,500 nonzeros, 40 batches of 38).
//       1. as a nonzero joins the batch, its expEtheta row's slice (S x 4
//          bytes, one cp.async.bulk) is copied into shared memory;
//       2. the warp owning the nonzero's column forms the CTA's partial
//          phinorm: each lane its rows in order in two f32 chains (even
//          and odd rows), their sum, then the xor butterfly in f64 (two
//          nonzeros at a time: the first step splits them between the
//          half-warps); lane r sends it to rank r by st.async on that
//          rank's mbarrier (row_fixed_point_entries.cuh's exchange; two
//          exchange arrays alternating a batch, so no cluster barrier is
//          needed: a rank stores into an array again only after every
//          rank sent it the next batch's partials, which each sends after
//          reading the array);
//       3. every rank sums the C partials in rank order 0..C-1 and adds
//          eps, in f64, and rounds phinorm to f32 once, so every rank
//          holds the same phinorm bits and forms the same ratio (bf16:
//          rounded where formed); rank 0 adds the score terms, in nonzero
//          order, in f64;
//       4. raw: (topic, column) has one owner, the lane holding the
//          topic's row in the column's warp, which adds the column's
//          nonzeros in row order in a register (expEtheta from the staged
//          rows: L2 read once).
//     The bf16 build rounds the staged expEtheta and the slice values as
//     it reads them, two at a time (one packed conversion a pair).
//   - The epilogue: sstats = expElogbeta x raw from the registers, staged
//     through shared memory (the batch area past the tile, the same
//     swizzle) and written in whole rows of the tile, coalesced, rows of
//     the topic range only.
//   - The score: rank 0 writes each tile's f64 sum; the last cluster to
//     finish (a counter behind __threadfence, left zero for the next
//     call) sums the tiles' parts in a fixed tree, as the one-pass kernel
//     does.
// Determinism: every sum has one owner and a fixed order (a lane's rows,
// the butterfly, the ranks; raw in row order; the score in nonzero order,
// then a fixed tree over tiles), no float atomics: two calls give the
// same bits.  The batches change no order (a sum runs over its terms in
// order whichever batch holds them), nor does the tile assignment, nor
// how the list was gathered.
//
// A topic range (k0, k1) runs the whole K's plan: every rank still forms
// its phinorm partials, and only the rows in [k0, k1) are summed and
// written (rows 0..k1-k0-1 of the output), so its rows are the full
// call's bit for bit.
//
// No cap on K.  Past slices of 1024 topics (K = 16 x 1024) a slice no
// longer fits a lane's registers, and the plan is direct (p.direct, a
// kernel instance of its own, 32 columns): expElogbeta and expEtheta are
// read from device memory at phinorm and raw is summed in the output
// itself (the same owner, row order), which the epilogue multiplies by
// expElogbeta read again.  The sums and their orders are the default
// plan's, so at the default plan's C, slice and columns it gives the
// same bits (chip_smoke.py's check at K = 8192).
//
// What holds it back (PERF.md): each tile's steps run one after another
// at 8 warps an SM, about 2.5 times the stream alone at config 5's chunk:
// the batch's partials the largest (with the wait for its expEtheta
// copies), then the exchange's wait and the sums; a warp's work is its
// columns' nonzeros, so the busiest warp sets the pace.  Each nonzero's
// expEtheta slice comes from L2 (182k x 32 KB, ~6 GB of L2 reads beside
// the 6.8 GB from device memory; 483k x 32 KB, ~16 GB, at the ragged
// flagship's chunk, where the batches set the time).  At 16 columns
// (K > 8192) rows move in 64-byte pieces: the slice's copy, the counts'
// walk and the epilogue each take about twice their 32-column time for
// the same bytes, and the kernel is slower than the two passes it
// replaced there.  A wider tile needs a slice's values and sums beyond a
// CTA's registers, and at 4 KB an expEtheta slice the batch then left in
// shared memory would be too small for a tile's nonzeros.

constexpr int kWideCols = 32;        // columns a tile: 128 bytes of a row
constexpr int kWideNarrowCols = 16;  // past slices of 512 topics: 64 bytes
constexpr int kWideLaneFloats = 64;  // slice values a lane holds (and sums)
constexpr int kWideBox = 32;         // a slice is whole boxes of these rows
constexpr int kWideCountRows = 128;  // counts rows a chunk: two threads a row
constexpr int kWideCountBufs = 3;    // the chunk ring: two chunks in flight
constexpr int kWidePushCap = 160;    // nonzeros a CTA pushes a tile, at most
constexpr int kWideMaxCluster = 16;
constexpr int kWideMaxBatch = 256;   // a thread a nonzero where they meet

// A CTA's dynamic shared memory (bytes, each offset a multiple of 16 from a
// 1024-aligned base): the expElogbeta slice tile [S rows x cols x 4 bytes] and
// after it the rest of the batch's expEtheta rows [batch][S] f32, the first
// cols of them in the tile (free between taking the slice into registers and
// the next slice's copy), the others where the epilogue also stages the tile's
// sstats (none in the direct plan), the counts ring (kWideCountBufs chunks of
// [128 x cols]), this CTA's compacted nonzeros (kWidePushCap of (row and
// column, count)), the push area [C][1 + kWidePushCap] (a header with the
// sender's count, then its nonzeros), the batch list (rows, columns, counts:
// a slot a nonzero, as the expEtheta rows), ratios, score terms, the two f64
// exchange arrays [2][C][batch], the block scan and eight mbarriers.
// ops/sstats.py::wide_smem_bytes mirrors it.
struct WideLayout {
  int tile, et, cnt, out, push, rows, cols, vals, ratio, term, recv, scan,
      bars, total;
  __host__ __device__ WideLayout(int slice, int batch, int cluster, int celem,
                                 int ncols, bool direct) {
    int o = 0;
    tile = o;
    o += direct ? 0 : slice * ncols * 4;
    et = o;
    o += direct ? 0 : (batch - ncols) * slice * 4;
    cnt = o;
    o += kWideCountBufs * kWideCountRows * ncols * celem;
    out = o;
    o += 8 * kWidePushCap;
    push = o;
    o += 8 * cluster * (1 + kWidePushCap);
    rows = o;
    o += 4 * batch;
    cols = o;
    o += 4 * batch;
    vals = o;
    o += 4 * batch;
    ratio = o;
    o += 4 * batch;
    term = o;
    o += 8 * batch;
    recv = o;
    o += 8 * 2 * cluster * batch;
    scan = o;
    o += 8 * kWarps + 16;
    bars = o;
    o += 64;
    total = o;
  }
};

struct WideParams {
  const void* counts;
  const float* et;
  const float* eeb;
  float* sstats;
  double* score_part;
  float* score_out;
  int* counter;
  int D, Vc, V, K, k0, k1;
  float eps;
  int cluster, slice, batch, tiles;
  int eeb_tma, et_bulk, counts_vec, out_vec;
};

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(pol));
  return pol;
}

// One box of the 2-D tensor map at (column x, row y) into this CTA's
// shared memory, completing on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int x, int y, uint64_t* bar,
                                            uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

// Byte offset of (row r, 16-byte chunk j) in a tile of COLS-float rows
// under the TMA swizzle of the row's width (128 or 64 bytes: chunk bits
// 4.. ^= address bits 7..).
template <int COLS>
__device__ __forceinline__ int swz(int r, int j) {
  constexpr int RB = COLS * 4;
  return r * RB + ((j ^ (((r * RB) >> 7) & (RB / 16 - 1))) << 4);
}

// Rows of a TMA box of the slice: the largest of 256, 128, 64 and 32 that
// divides it.
__host__ __device__ __forceinline__ int wide_box_rows(int slice) {
  return slice % 256 == 0 ? 256 : slice % 128 == 0 ? 128
         : slice % 64 == 0 ? 64 : kWideBox;
}

// Issues the copy of the expElogbeta slice of the tile at column v0 into
// tile: TMA boxes on bar (thread 0), or plain loads by every thread.
template <int COLS>
__device__ __forceinline__ void wide_load_slice(const WideParams& p,
                                                const CUtensorMap* map,
                                                unsigned char* tile, int kb,
                                                int v0, uint64_t* bar,
                                                uint64_t policy) {
  if (p.eeb_tma) {
    if (threadIdx.x == 0) {
      fence_proxy_async();
      mbar_expect_tx(bar, (uint32_t)(p.slice * COLS * 4));
      const int bh = wide_box_rows(p.slice);
      for (int b = 0; b < p.slice / bh; ++b)
        tma_load_2d(tile + b * bh * COLS * 4, map, v0, kb + b * bh, bar,
                    policy);
    }
  } else {
    for (int i = threadIdx.x; i < p.slice * COLS; i += kThreads) {
      const int r = i / COLS, c = i % COLS;
      const int k = kb + r, v = v0 + c;
      *reinterpret_cast<float*>(tile + swz<COLS>(r, c / 4) + 4 * (c % 4)) =
          k < p.K && v < p.V ? __ldg(p.eeb + (size_t)k * p.V + v) : 0.f;
    }
  }
}

// Issues the copies of counts rows [d0, min(d0 + 128, d1)) x columns
// [v0, v0 + COLS) into dst and commits them as one group; rows past d1 and
// columns past Vc read as zero.
template <typename CT, int COLS>
__device__ __forceinline__ void wide_load_counts(const WideParams& p,
                                                 unsigned char* dst, int d0,
                                                 int d1, int v0) {
  constexpr int E = 16 / sizeof(CT);
  constexpr int SEGS = COLS / E;
  const CT* counts = static_cast<const CT*>(p.counts);
  for (int i = threadIdx.x; i < kWideCountRows * SEGS; i += kThreads) {
    const int r = i / SEGS, c = (i % SEGS) * E;
    const int d = d0 + r, v = v0 + c;
    CT* s = reinterpret_cast<CT*>(dst) + r * COLS + c;
    if (p.counts_vec) {
      if (d < d1 && v < p.Vc)
        __pipeline_memcpy_async(s, counts + (size_t)d * p.Vc + v, 16);
      else
        *reinterpret_cast<uint4*>(s) = make_uint4(0u, 0u, 0u, 0u);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        s[e] = (d < d1 && v + e < p.Vc) ? counts[(size_t)d * p.Vc + v + e]
                                        : CT(0.f);
    }
  }
  __pipeline_commit();
}

// The nonzero mask of the N (8 or 16) counts of row d at columns
// [v, v + N), read from device memory by 16-byte loads where the row is
// aligned (v a multiple of 8) and whole, else one count at a time
// (columns past Vc and rows past D are zero).
template <typename CT, int N>
__device__ __forceinline__ unsigned wide_row_mask(const WideParams& p, int d,
                                                  int v) {
  if (d >= p.D) return 0u;
  const CT* row = static_cast<const CT*>(p.counts) + (size_t)d * p.Vc;
  if (p.counts_vec && v + N <= p.Vc) {
    unsigned mask = 0u;
#pragma unroll
    for (int g = 0; g < N / 8; ++g) mask |= nonzero8(row + v + 8 * g) << (8 * g);
    return mask;
  }
  unsigned mask = 0u;
#pragma unroll
  for (int e = 0; e < N; ++e)
    mask |= (unsigned)(v + e < p.Vc && to_float(row[v + e]) != 0.f) << e;
  return mask;
}

// The block's exclusive prefix of x in thread order; *total the sum.
__device__ __forceinline__ int wide_scan(int x, int* scan_s, int* total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) scan_s[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = scan_s[w];
    before += w < warp ? s : 0;
    all += s;
  }
  *total = all;
  return before + inc - x;
}

// raw[.][cc] += x * r over the lane's kept rows (bit j of kept).
template <int RPL, int CPW>
__device__ __forceinline__ void wide_add(float (&raw)[RPL][CPW], int cc,
                                         const float (&x)[RPL], float r,
                                         unsigned kept) {
#define PYLDA_WIDE_ADD(cc_)                                           \
  _Pragma("unroll") for (int j = 0; j < RPL; ++j) if ((kept >> j) & 1u) \
      raw[j][cc_] = fmaf(x[j], r, raw[j][cc_]);
  switch (cc) {
    case 0:
      PYLDA_WIDE_ADD(0)
      break;
    case 1:
      PYLDA_WIDE_ADD(CPW > 1 ? 1 : 0)
      break;
    case 2:
      PYLDA_WIDE_ADD(CPW > 2 ? 2 : 0)
      break;
    default:
      PYLDA_WIDE_ADD(CPW > 3 ? 3 : 0)
      break;
  }
#undef PYLDA_WIDE_ADD
}

// operand() of the RPL values of x, two at a time (one packed
// conversion a pair: the same bits).
template <int RPL>
__device__ __forceinline__ void wide_operands(float (&x)[RPL]) {
  if constexpr (kBf16) {
#pragma unroll
    for (int j = 0; j + 1 < RPL; j += 2) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[j], x[j + 1]);
      x[j] = __low2float(h);
      x[j + 1] = __high2float(h);
    }
    if (RPL % 2) x[RPL - 1] = operand(x[RPL - 1]);
  }
}

// Column cc (< CPW) of a lane's slice values v[RPL][CPW] into b[RPL], by
// selects (no branch, so two nonzeros' work can interleave).
template <int RPL, int CPW>
__device__ __forceinline__ void wide_pick(const float (&v)[RPL][CPW], int cc,
                                          float (&b)[RPL]) {
#pragma unroll
  for (int j = 0; j < RPL; ++j) {
    if constexpr (CPW == 4)
      b[j] = cc & 2 ? (cc & 1 ? v[j][3 % CPW] : v[j][2 % CPW])
                    : (cc & 1 ? v[j][1] : v[j][0]);
    else
      b[j] = cc & 1 ? v[j][1 % CPW] : v[j][0];
  }
}

// x's bits as a float2 (an 8-byte st.async).
__device__ __forceinline__ float2 as_float2(double x) {
  return make_float2(__int_as_float(__double2loint(x)),
                     __int_as_float(__double2hiint(x)));
}

// The cluster kernel (see above): COLS columns a tile; kDirect the direct
// plan.
template <typename CT, int COLS, bool kDirect>
__global__ void __launch_bounds__(kThreads, 1)
dense_sstats_wide_kernel(const WideParams p,
                         const __grid_constant__ CUtensorMap eeb_map) {
  constexpr int CPW = COLS / kWarps;          // columns a warp owns
  constexpr int RPL = kWideLaneFloats / CPW;  // slice rows a lane holds
  constexpr int CAP = kWidePushCap;
  extern __shared__ __align__(16) unsigned char wide_smem_raw[];
  // A 1024-byte aligned base (the swizzled tile); the same in every CTA.
  unsigned char* smem =
      wide_smem_raw + ((1024 - (smem_u32(wide_smem_raw) & 1023)) & 1023);
  const WideLayout L(p.slice, p.batch, p.cluster, (int)sizeof(CT), COLS,
                     kDirect);
  unsigned char* tile_s = smem + L.tile;
  // A batch's expEtheta rows: from the tile on.
  float* et_s = reinterpret_cast<float*>(smem + L.tile);
  float2* out_s = reinterpret_cast<float2*>(smem + L.out);
  float2* push_s = reinterpret_cast<float2*>(smem + L.push);
  int* rows_s = reinterpret_cast<int*>(smem + L.rows);
  int* cols_s = reinterpret_cast<int*>(smem + L.cols);
  float* vals_s = reinterpret_cast<float*>(smem + L.vals);
  float* ratio_s = reinterpret_cast<float*>(smem + L.ratio);
  double* term_s = reinterpret_cast<double*>(smem + L.term);
  double* recv_s = reinterpret_cast<double*>(smem + L.recv);
  int* scan_s = reinterpret_cast<int*>(smem + L.scan);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  // bars: 0 the slice tile; 1 the push headers; 2 the pushed nonzeros; 3,
  // 4 the partials (a buffer a batch, alternating); 5, 6 the batches'
  // expEtheta rows (the two halves of the slots, where a tile's batches
  // alternate between them).

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int C = p.cluster, rank = (int)cluster.block_rank();
  const int kb = rank * p.slice;  // the slice's first topic
  const int own = max(0, min(p.K, kb + p.slice) - kb);
  const int q = blockIdx.x / C, nq = gridDim.x / C;
  const int nt = q < p.tiles ? (p.tiles - q + nq - 1) / nq : 0;
  // This CTA's share of every tile's rows: [d0, d1), in chunks of 128.
  const int share = (p.D + C - 1) / C;
  const int d0 = min(p.D, rank * share), d1 = min(p.D, d0 + share);
  const int nch = max(1, (d1 - d0 + kWideCountRows - 1) / kWideCountRows);
  const uint64_t policy = evict_first_policy();
  // Lane l's rows of the slice: l + 32 j; bit j set where the row is a
  // topic (below own), and where it is in the topic range.
  unsigned valid = 0u, kept = 0u;
#pragma unroll
  for (int j = 0; j < RPL; ++j) {
    const int r = lane + 32 * j;
    valid |= (unsigned)(r < own) << j;
    kept |= (unsigned)(r < own && kb + r >= p.k0 && kb + r < p.k1) << j;
  }
  const int drows = (own + 31) / 32;  // the direct plan's rows a lane

  if (tid == 0) {
    for (int b = 0; b < 8; ++b) mbar_init(&bars[b], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();  // every rank's mbarriers exist before any st.async

  auto cbuf = [&](int s) {
    return smem + L.cnt +
           (s % kWideCountBufs) * kWideCountRows * COLS * (int)sizeof(CT);
  };
  auto stream_load = [&](int s) {  // chunk s of this CTA's share stream
    if (s < nt * nch)
      wide_load_counts<CT, COLS>(p, cbuf(s), d0 + (s % nch) * kWideCountRows,
                                 d1, (q + (s / nch) * nq) * COLS);
    else
      __pipeline_commit();
  };
  if (nt > 0) {
    if constexpr (!kDirect)
      wide_load_slice<COLS>(p, &eeb_map, tile_s, kb, q * COLS, &bars[0],
                            policy);
    for (int s = 0; s + 1 < kWideCountBufs; ++s) stream_load(s);
  }

  float E[RPL][CPW], raw[RPL][CPW];
  uint32_t tile_par = 0, push_par = 0, xch_par = 0, et_par = 0;
  int buf = 0;
  double tile_score = 0.0;

  // 1. This CTA's share of tile ti's rows: each row's nonzeros (two
  // threads a row, a half of the columns each) compacted in row-major
  // order into out_s, the first kWidePushCap of them; 2. the push: this
  // CTA's count, and its nonzeros if they fit, into every rank's push area
  // of this rank, by st.async on that rank's header and nonzero mbarriers.
  // A rank pushes tile ti after its batches of tile ti - 1, whose last
  // exchange waits for every rank's partials, which each rank sends after
  // reading that tile's list from its push area: no area is rewritten
  // before it is read.
  auto walk_push = [&](int ti) {
    int n_mine = 0;
    for (int j = 0; j < nch; ++j) {
      const int s = ti * nch + j;
      __pipeline_wait_prior(kWideCountBufs - 2);  // chunk s is in
      __syncthreads();  // and every thread is done with chunk s - 1
      stream_load(s + kWideCountBufs - 1);
      const int half = tid % 2, r = tid / 2;
      const CT* row = reinterpret_cast<const CT*>(cbuf(s)) + r * COLS +
                      half * (COLS / 2);
      unsigned mask = 0u;
#pragma unroll
      for (int g = 0; g < COLS / 16; ++g)
        mask |= nonzero8(row + 8 * g) << (8 * g);
      int total;
      int at = n_mine + wide_scan(__popc(mask), scan_s, &total);
      for (unsigned mm = mask; mm && at < CAP; mm &= mm - 1, ++at) {
        const int c = __ffs(mm) - 1;
        out_s[at] = make_float2(
            __int_as_float((d0 + j * kWideCountRows + r) * 32 +
                           half * (COLS / 2) + c),
            to_float(row[c]));
      }
      n_mine += total;
    }
    __syncthreads();  // out_s is written
    const int sent = n_mine <= CAP ? n_mine : 0;
    float2* area = push_s + rank * (1 + CAP);
    for (int i = tid; i < C * (1 + sent); i += kThreads) {
      const int to = i % C, e = i / C;
      const float2 v =
          e == 0 ? make_float2(__int_as_float(n_mine), 0.f) : out_s[e - 1];
      st_async(mapa(smem_u32(area + e), to), v,
               mapa(smem_u32(&bars[e == 0 ? 1 : 2]), to));
    }
  };
  if (nt > 0) walk_push(0);

  for (int ti = 0; ti < nt; ++ti) {
    const int tile = q + ti * nq, v0 = tile * COLS;
    if constexpr (!kDirect) {
      if (p.eeb_tma) {
        mbar_wait(&bars[0], tile_par);
        tile_par ^= 1;
      }
      __syncthreads();  // the slice tile is in
      // Lane l: rows l + 32 j, the warp's CPW columns (one 16-byte chunk,
      // or half of one at 16 columns).
#pragma unroll
      for (int j = 0; j < RPL; ++j) {
        const int r = lane + 32 * j;
        if constexpr (CPW == 4) {
          const float4 b =
              r < p.slice
                  ? *reinterpret_cast<const float4*>(tile_s +
                                                     swz<COLS>(r, warp))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
          E[j][0] = b.x;
          E[j][1] = b.y;
          E[j][2 % CPW] = b.z;
          E[j][3 % CPW] = b.w;
        } else {
          const float2 b =
              r < p.slice ? *reinterpret_cast<const float2*>(
                                tile_s + swz<COLS>(r, warp / 2) +
                                8 * (warp % 2))
                          : make_float2(0.f, 0.f);
          E[j][0] = b.x;
          E[j][1 % CPW] = b.y;
        }
#pragma unroll
        for (int c = 0; c < CPW; ++c) raw[j][c] = 0.f;
      }
      __syncthreads();  // the tile is read: the batches' rows may land there
    } else {  // raw is summed in the output: zero the lane's kept rows
      for (int c = warp * CPW; c < warp * CPW + CPW && v0 + c < p.V; ++c)
        for (int j = 0; j < drows; ++j) {
          const int k = kb + lane + 32 * j;
          if (lane + 32 * j < own && k >= p.k0 && k < p.k1)
            p.sstats[(size_t)(k - p.k0) * p.V + v0 + c] = 0.f;
        }
    }

    // The ranks' pushes of this tile (the next tile's are made before this
    // tile's epilogue, so their stores hide the wait).
    if (tid == 0) mbar_expect_tx(&bars[1], (uint32_t)(C * 8));
    mbar_wait(&bars[1], push_par);
    // Every rank's count: the nonzeros to wait for, and whether all fit.
    int total_n = 0, pushed = 0;
    bool all_fit = true;
    for (int r = 0; r < C; ++r) {
      const int n = __float_as_int(push_s[r * (1 + CAP)].x);
      total_n += n;
      pushed += n <= CAP ? n : 0;
      all_fit = all_fit && n <= CAP;
    }
    if (tid == 0) mbar_expect_tx(&bars[2], (uint32_t)(pushed * 8));
    mbar_wait(&bars[2], push_par);
    push_par ^= 1u;

    // Calls f(n, cc) for each nonzero n < m of a batch (its columns cols)
    // whose column belongs to this warp (cc its column among the warp's),
    // in list order, two at a time where a lane's rows leave the registers
    // for it (f2(na, cca, nb, ccb)).
    auto for_mine = [&](const int* cols, int m, auto f, auto f2) {
      for (int n0 = 0; n0 < m; n0 += 32) {
        const int n = n0 + lane;
        unsigned bits =
            __ballot_sync(kFull, n < m && cols[min(n, m - 1)] / CPW == warp);
        while (bits) {
          const int na = n0 + __ffs(bits) - 1;
          bits &= bits - 1;
          if (RPL <= 16 && bits) {
            const int nb = n0 + __ffs(bits) - 1;
            bits &= bits - 1;
            f2(na, cols[na] % CPW, nb, cols[nb] % CPW);
          } else {
            f(na, cols[na] % CPW);
          }
        }
      }
    };

    // One batch of m nonzeros of the list, in slots [base, base + m) (their
    // expEtheta rows on bars[5 + half]): phinorm, the exchange, the ratios,
    // the score terms, the sums.  m = 0 exchanges one zero (every tile
    // exchanges at least once: a rank pushes the next tile after every
    // rank has sent it the partials of this tile's last batch, so after
    // every rank has read its push area).
    auto run_batch = [&](int m, int base, int half) {
      __syncthreads();  // the list is written
      const int* rows = rows_s + base;
      const int* cols = cols_s + base;
      const float* ets = et_s + (size_t)base * p.slice;
      double* recv = recv_s + buf * C * p.batch;
      uint64_t* xbar = &bars[3 + buf];
      if (tid == 0) mbar_expect_tx(xbar, (uint32_t)(C * max(m, 1) * 8));
      if constexpr (!kDirect) {
        if (p.et_bulk) {  // the copies were issued as the list filled
          if (tid == 0)
            mbar_expect_tx(&bars[5 + half], (uint32_t)(m * own * 4));
          mbar_wait(&bars[5 + half], (et_par >> half) & 1u);
          et_par ^= 1u << half;
        } else {
          for (int i = tid; i < m * own; i += kThreads) {
            const int n = i / own, r = i - n * own;
            et_s[(size_t)(base + n) * p.slice + r] =
                __ldg(p.et + (size_t)rows[n] * p.K + kb + r);
          }
          __syncthreads();
        }
      }
      // The CTA's partial phinorm of each nonzero, by the warp owning its
      // column: a lane's rows in order in two f32 chains (even and odd
      // rows) and their sum, then in f64 the xor butterfly (two nonzeros:
      // the first step splits them between the half-warps, each half then
      // ends with the same sums the whole warp's butterfly gives); lane r
      // of a half sends its nonzero's partial to rank r.
      // A lane's share of nonzero n's partial (default plan): its rows'
      // products in two chains (even and odd rows), in f64.
      auto lane_dot = [&](int n, int cc) {
        float b[RPL], x[RPL];
        wide_pick<RPL, CPW>(E, cc, b);
        const float* e = ets + (size_t)n * p.slice + lane;
#pragma unroll
        for (int j = 0; j < RPL; ++j) x[j] = e[32 * j];
        wide_operands<RPL>(b);
        wide_operands<RPL>(x);
        float a[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < RPL; ++j)
          if ((valid >> j) & 1u) a[j % 2] = fmaf(x[j], b[j], a[j % 2]);
        return (double)(a[0] + a[1]);
      };
      auto dot = [&](int n, int cc) {
        if constexpr (!kDirect) {
          return lane_dot(n, cc);
        } else {
          float a[2] = {0.f, 0.f};
          const float* e = p.et + (size_t)rows[n] * p.K + kb + lane;
          const int v = v0 + warp * CPW + cc;
          for (int j = 0; j < drows; ++j)
            if (lane + 32 * j < own) {
              const float bv =
                  v < p.V ? __ldg(p.eeb + (size_t)(kb + lane + 32 * j) * p.V +
                                  v)
                          : 0.f;
              a[j % 2] = fmaf(operand(__ldg(e + 32 * j)), operand(bv),
                              a[j % 2]);
            }
          return (double)(a[0] + a[1]);
        }
      };
      auto send = [&](int n, double a, int to) {
        if (to < C)
          st_async(mapa(smem_u32(recv + rank * p.batch + n), to),
                   as_float2(a), mapa(smem_u32(xbar), to));
      };
      if (m == 0) {
        if (warp == 0) send(0, 0.0, lane);
      } else {
        for_mine(
            cols, m,
            [&](int n, int cc) {
              double a = dot(n, cc);
#pragma unroll
              for (int off = 16; off > 0; off >>= 1)
                a += __shfl_xor_sync(kFull, a, off);
              send(n, a, lane);
            },
            [&](int na, int cca, int nb, int ccb) {
              const double a = dot(na, cca), b = dot(nb, ccb);
              const bool lo = lane < 16;
              double x = lo ? a : b;
              x += __shfl_xor_sync(kFull, lo ? b : a, 16);
#pragma unroll
              for (int off = 8; off > 0; off >>= 1)
                x += __shfl_xor_sync(kFull, x, off);
              send(lo ? na : nb, x, lane % 16);
            });
      }
      mbar_wait(xbar, (xch_par >> buf) & 1u);
      xch_par ^= 1u << buf;
      buf ^= 1;
      if (m == 0) return;
      // The ranks' partials in rank order, in f64, + eps, rounded to f32
      // once: every rank the same bits.
      if (tid < m) {
        double ph = 0.0;
        for (int r = 0; r < C; ++r) ph += recv[r * p.batch + tid];
        const float cv = vals_s[base + tid];
        const float pn = (float)(ph + (double)p.eps);
        ratio_s[base + tid] = operand(cv / pn);
        term_s[base + tid] = (double)(cv * logf(pn));
      }
      __syncthreads();
      if (rank == 0 && tid == 0)
        for (int n = 0; n < m; ++n) tile_score += term_s[base + n];
      // raw: each (topic, column) by the lane holding it, the column's
      // nonzeros in list (row) order.
      auto sum = [&](int n, int cc) {
        const float rt = ratio_s[base + n];
        if constexpr (!kDirect) {
          const float* e = ets + (size_t)n * p.slice + lane;
          float x[RPL];
#pragma unroll
          for (int j = 0; j < RPL; ++j) x[j] = e[32 * j];
          wide_operands<RPL>(x);
          wide_add<RPL, CPW>(raw, cc, x, rt, kept);
        } else {
          const float* e = p.et + (size_t)rows[n] * p.K + kb + lane;
          const int v = v0 + warp * CPW + cc;
          if (v < p.V)
            for (int j = 0; j < drows; ++j) {
              const int k = kb + lane + 32 * j;
              if (lane + 32 * j < own && k >= p.k0 && k < p.k1) {
                float* o = p.sstats + (size_t)(k - p.k0) * p.V + v;
                *o = fmaf(operand(__ldg(e + 32 * j)), rt, *o);
              }
            }
        }
      };
      for_mine(cols, m, sum, [&](int na, int cca, int nb, int ccb) {
        sum(na, cca);
        sum(nb, ccb);
      });
      fence_proxy_async();  // these reads before the slots' next copies
      __syncthreads();      // the slots may be rewritten
    };

    // The copy of row d's expEtheta slice into slot `slot` (issued as the
    // list fills, so a batch's copies are in flight together), on
    // bars[5 + half].
    auto stage_et = [&](int slot, int d, int half) {
      if (!kDirect && p.et_bulk && own > 0)
        bulk_load(et_s + (size_t)slot * p.slice, p.et + (size_t)d * p.K + kb,
                  (uint32_t)(own * 4), &bars[5 + half]);
    };

    // 3. The batches.  Where every rank's nonzeros fit its push, the list
    // is the ranks' pushes in rank order (row-major: the ranks' shares are
    // consecutive rows).  A tile of more than p.batch nonzeros runs
    // batches of half as many, the next one's list written and its
    // expEtheta rows copied into the other half of the slots while this
    // one runs.  Else (a rank's share past its push) every CTA walks the
    // whole tile's counts from device memory, in the same order.
    if (all_fit) {
      const int H = total_n > p.batch ? p.batch / 2 : p.batch;
      const int nb = max(1, (total_n + H - 1) / H);
      auto fill_list = [&](int b) {  // batch b's list into its slots
        const int b0 = b * H, m = min(H, total_n - b0);
        const int base = (b & 1) * H;
        if (tid < m) {
          int g = b0 + tid, r = 0;
          for (;; ++r) {
            const int n = __float_as_int(push_s[r * (1 + CAP)].x);
            if (g < n) break;
            g -= n;
          }
          const float2 v = push_s[r * (1 + CAP) + 1 + g];
          const int key = __float_as_int(v.x);
          rows_s[base + tid] = key >> 5;
          cols_s[base + tid] = key & 31;
          vals_s[base + tid] = v.y;
          stage_et(base + tid, key >> 5, b & 1);
        }
      };
      fill_list(0);
      for (int b = 0; b < nb; ++b) {
        if (b + 1 < nb) fill_list(b + 1);
        run_batch(min(H, total_n - b * H), (b & 1) * H, b & 1);
      }
    } else {
      int fill = 0, runs = 0;
      const int nrows = max(1, (p.D + kWideCountRows - 1) / kWideCountRows);
      for (int j = 0; j < nrows; ++j) {
        const int half = tid % 2, d = j * kWideCountRows + tid / 2;
        const int v = v0 + half * (COLS / 2);
        const unsigned mask = wide_row_mask<CT, COLS / 2>(p, d, v);
        int total;
        const int pos = wide_scan(__popc(mask), scan_s, &total);
        for (int done = 0; done < total;) {
          const int take = min(p.batch - fill, total - done);
          unsigned mm = mask;
          for (int at = pos; mm && at < done + take; ++at) {
            const int c = __ffs(mm) - 1;
            mm &= mm - 1;
            if (at >= done) {
              const int slot = fill + at - done;
              rows_s[slot] = d;
              cols_s[slot] = half * (COLS / 2) + c;
              vals_s[slot] = to_float(static_cast<const CT*>(
                  p.counts)[(size_t)d * p.Vc + v + c]);
              stage_et(slot, d, 0);
            }
          }
          fill += take;
          done += take;
          if (fill == p.batch) {
            run_batch(fill, 0, 0);
            fill = 0;
            ++runs;
          }
        }
        __syncthreads();  // the scan's words are read
      }
      if (fill > 0 || runs == 0) run_batch(fill, 0, 0);
    }
    if (rank == 0 && tid == 0) {
      p.score_part[tile] = tile_score;
      tile_score = 0.0;
    }
    // The batches are done with the tile's buffer: the next slice's copy.
    if (!kDirect && ti + 1 < nt)
      wide_load_slice<COLS>(p, &eeb_map, tile_s, kb, v0 + nq * COLS,
                            &bars[0], policy);
    if (ti + 1 < nt) walk_push(ti + 1);

    // The epilogue: sstats = expElogbeta x raw, staged through the batch
    // area (the tile's swizzle) and written in whole rows of the tile,
    // rows of the range only.
    if constexpr (!kDirect) {
      unsigned char* stage = smem + L.et;
#pragma unroll
      for (int j = 0; j < RPL; ++j) {
        const int r = lane + 32 * j;
        if (r < p.slice) {
          if constexpr (CPW == 4)
            *reinterpret_cast<float4*>(stage + swz<COLS>(r, warp)) =
                make_float4(E[j][0] * raw[j][0], E[j][1] * raw[j][1],
                            E[j][2 % CPW] * raw[j][2 % CPW],
                            E[j][3 % CPW] * raw[j][3 % CPW]);
          else
            *reinterpret_cast<float2*>(stage + swz<COLS>(r, warp / 2) +
                                       8 * (warp % 2)) =
                make_float2(E[j][0] * raw[j][0],
                            E[j][1 % CPW] * raw[j][1 % CPW]);
        }
      }
      __syncthreads();
      constexpr int CH = COLS / 4;  // 16-byte chunks a row
      for (int i = tid; i < own * CH; i += kThreads) {
        const int r = i / CH, j = i % CH, k = kb + r, v = v0 + 4 * j;
        if (k < p.k0 || k >= p.k1 || v >= p.V) continue;
        const float4 o =
            *reinterpret_cast<const float4*>(stage + swz<COLS>(r, j));
        float* dst = p.sstats + (size_t)(k - p.k0) * p.V + v;
        if (p.out_vec) {
          __stcs(reinterpret_cast<float4*>(dst), o);
        } else {
          const float a[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (v + e < p.V) __stcs(dst + e, a[e]);
        }
      }
      // The stage is the batch area, where the next tile's expEtheta
      // copies land: order these accesses before them.
      fence_proxy_async();
    } else {
      for (int c = warp * CPW; c < warp * CPW + CPW && v0 + c < p.V; ++c)
        for (int j = 0; j < drows; ++j) {
          const int k = kb + lane + 32 * j;
          if (lane + 32 * j < own && k >= p.k0 && k < p.k1) {
            float* o = p.sstats + (size_t)(k - p.k0) * p.V + v0 + c;
            *o = __ldg(p.eeb + (size_t)k * p.V + v0 + c) * *o;
          }
        }
    }
  }

  // The last cluster to finish sums the tiles' score parts in a fixed
  // tree, and leaves the counter zero for the next call.
  if (rank == 0) {
    int* last_s = scan_s;
    double* red_s = reinterpret_cast<double*>(scan_s + 4);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int last = atomicAdd(p.counter, 1) == nq - 1;
      if (last) *p.counter = 0;
      *last_s = last;
    }
    __syncthreads();
    if (*last_s) {
      __threadfence();
      double t = 0.0;  // thread i: parts i, i + 256, ..; then a fixed tree
      for (int b = tid; b < p.tiles; b += kThreads)
        t += __ldcg(p.score_part + b);
      for (int off = 16; off > 0; off >>= 1)
        t += __shfl_down_sync(kFull, t, off);
      if (lane == 0) red_s[warp] = t;
      __syncthreads();
      if (tid == 0) {
        double s = 0.0;
        for (int w = 0; w < kWarps; ++w) s += red_s[w];
        *p.score_out = (float)s;
      }
    }
  }
  cluster.sync();  // no CTA leaves while another may store into it
}

// Sets the kernel's attributes and launches it in clusters of p.cluster
// CTAs: as many clusters as fit on the card at once, at most one a tile.
// Writes back the clusters, the shared memory a CTA and the grid.
template <typename Kernel>
cudaError_t launch_wide(Kernel kern, const WideParams& p,
                        const CUtensorMap& map, size_t smem, int* geometry,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kern, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  if (clusters > p.tiles) clusters = p.tiles;
  geometry[0] = clusters;
  geometry[1] = (int)smem;
  geometry[2] = clusters * p.cluster;
  cfg.gridDim = dim3(clusters * p.cluster);
  err = cudaLaunchKernelEx(&cfg, kern, p, map);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The kernel instance of (counts type, columns a tile, direct plan).
template <typename CT>
cudaError_t dispatch_wide(const WideParams& p, const CUtensorMap& map,
                          int cols, bool direct, size_t smem, int* geometry,
                          cudaStream_t s) {
  if (direct)
    return launch_wide(dense_sstats_wide_kernel<CT, kWideCols, true>, p, map,
                       smem, geometry, s);
  if (cols == kWideCols)
    return launch_wide(dense_sstats_wide_kernel<CT, kWideCols, false>, p,
                       map, smem, geometry, s);
  return launch_wide(dense_sstats_wide_kernel<CT, kWideNarrowCols, false>, p,
                     map, smem, geometry, s);
}

// cuTensorMapEncodeTiled from the driver, through the runtime (nothing is
// linked against the driver library); null if the driver has none.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

#if PYLDA_BF16
#include "dense_sstats_mma.cuh"
#endif

}  // namespace

extern "C" {

// counts: [D, Vc] bf16 (counts_bf16 != 0) or f32; et: [D, K] f32; eeb:
// [K, V] f32, 1 <= K <= 256; 0 <= k0 < k1 <= K, the topic range; sstats:
// out [k1 - k0, V] f32 (every entry written: rows k0..k1-1 of the full
// result); score_out: out [1] f32; score_part: scratch [splits * tiles]
// f64, tiles = ceil(Vc / COLS); partial: scratch [tiles * splits * COLS *
// 4 QR] f32, QR = ceil(k1 / 4) - floor(k0 / 4) (unused when splits == 1);
// counters: [tiles + 1] int32, zero before the first call and left zero by
// each call (so one buffer serves a stream's calls in turn).  COLS =
// kTileV (64); the plan (ops/sstats.py::plan) gives it, the build (keyed
// on K), QR, splits and rows_per_split (a multiple of 32, splits *
// rows_per_split >= D).  All row-major and contiguous.  Returns the
// cudaError_t of the launch.  The bf16 build runs the tensor-core kernel
// of dense_sstats_mma.cuh instead, at every K here and for both count
// types (ops/sstats.py::mma_plan): COLS = kMmaTileV (64), rows_per_split a
// multiple of kMmaRows (64), and partial holds expEtheta rounded to bf16
// ([D, Kp] bf16, Kp = K rounded up to 16: D Kp / 2 floats), then, when
// splits > 1, the split partials [tiles * splits * 2048 * MT2] f32 (MT2 =
// mma_tiles_a_warp(Kp / 16)); two launches (the rounding, then the
// kernel).
int pylda_dense_sstats_range(const void* counts, int counts_bf16,
                             const void* et, const void* eeb, void* sstats,
                             void* score_part, void* score_out, void* partial,
                             void* counters, int D, int Vc, int V, int K,
                             int k0, int k1, float eps, int splits,
                             int rows_per_split, void* stream) {
  if (K < 1 || K > 256 || k0 < 0 || k1 <= k0 || k1 > K || splits < 1 ||
      rows_per_split < kRows || rows_per_split % kRows != 0 ||
      (long long)splits * rows_per_split < D)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#if PYLDA_BF16
  if (counts_bf16)
    return (int)dispatch_mma<__nv_bfloat16>(K, counts, et, eeb, sstats,
                                            score_part, score_out, partial,
                                            counters, D, Vc, V, k0, k1, eps,
                                            splits, rows_per_split, s);
  return (int)dispatch_mma<float>(K, counts, et, eeb, sstats, score_part,
                                  score_out, partial, counters, D, Vc, V, k0,
                                  k1, eps, splits, rows_per_split, s);
#else
  if (counts_bf16)
    return (int)dispatch<__nv_bfloat16>(K, counts, et, eeb, sstats,
                                        score_part, score_out, partial,
                                        counters, D, Vc, V, k0, k1, eps,
                                        splits, rows_per_split, s);
  return (int)dispatch<float>(K, counts, et, eeb, sstats, score_part,
                              score_out, partial, counters, D, Vc, V, k0, k1,
                              eps, splits, rows_per_split, s);
#endif
}

// Above K = 256, the cluster kernel (one launch).  counts: [D, Vc] bf16
// (counts_bf16 != 0) or f32, Vc >= V; et: [D, K] f32; eeb: [K, V] f32,
// K > 256; 0 <= k0 < k1 <= K, the topic range; sstats: out [k1 - k0, V]
// f32 (every entry written: rows k0..k1-1 of the full result);
// score_out: out [1] f32; score_part: scratch [tiles] f64, tiles =
// ceil(Vc / cols); counter: [1] int32, zero before the first call and left
// zero by each call.  The plan (ops/sstats.py::plan): cluster (a power of
// two <= 16), slice (cluster * slice >= K), cols (32, or 16 in the default
// plan past slices of 512 topics), batch (the nonzeros a batch, a multiple
// of 4 up to 256), direct.  The default plan's slice is a multiple of 32
// of at most 64 * 256 / cols topics, its batch at least 2 cols (the
// first cols expEtheta rows in the tile, then the epilogue's stage), and
// its shared memory within the card's; the direct plan takes 32 columns.
// geometry: out [3] int32 on the host (clusters, shared memory a CTA,
// grid).  All row-major and contiguous.  Returns the cudaError_t of the
// launch.
int pylda_dense_sstats_wide(const void* counts, int counts_bf16,
                            const void* et, const void* eeb, void* sstats,
                            void* score_part, void* score_out, void* counter,
                            int D, int Vc, int V, int K, int k0, int k1,
                            float eps, int cluster, int slice, int cols,
                            int batch, int direct, int* geometry,
                            void* stream) {
  if (K <= 256 || D < 0 || V < 1 || Vc < V || k0 < 0 || k1 <= k0 ||
      k1 > K || cluster < 1 || cluster > kWideMaxCluster ||
      (cluster & (cluster - 1)) || slice < 1 ||
      (long long)slice * cluster < K || batch < 1 || batch > kWideMaxBatch ||
      batch % 4 || !geometry ||
      (cols != kWideCols && (direct || cols != kWideNarrowCols)))
    return (int)cudaErrorInvalidValue;
  if (!direct && (slice % kWideBox || slice * cols > 32 * 8 * kWideLaneFloats ||
                  batch < 2 * cols))
    return (int)cudaErrorInvalidValue;
  WideParams p;
  p.counts = counts;
  p.et = static_cast<const float*>(et);
  p.eeb = static_cast<const float*>(eeb);
  p.sstats = static_cast<float*>(sstats);
  p.score_part = static_cast<double*>(score_part);
  p.score_out = static_cast<float*>(score_out);
  p.counter = static_cast<int*>(counter);
  p.D = D;
  p.Vc = Vc;
  p.V = V;
  p.K = K;
  p.k0 = k0;
  p.k1 = k1;
  p.eps = eps;
  p.cluster = cluster;
  p.slice = slice;
  p.batch = batch;
  p.tiles = (Vc + cols - 1) / cols;
  const int celem = counts_bf16 ? 2 : 4;
  auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  p.eeb_tma = !direct && V % 4 == 0 && aligned(eeb);
  p.et_bulk = K % 4 == 0 && aligned(et);
  p.counts_vec = ((long long)Vc * celem) % 16 == 0 && aligned(counts);
  p.out_vec = V % 4 == 0 && aligned(sstats);
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (p.eeb_tma) {
    const EncodeTiled encode = encode_tiled();
    if (!encode) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)V, (cuuint64_t)K};
    const cuuint64_t strides[1] = {(cuuint64_t)V * 4};
    const cuuint32_t box[2] = {(cuuint32_t)cols,
                               (cuuint32_t)wide_box_rows(slice)};
    const cuuint32_t steps[2] = {1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(eeb),
               dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
               cols == kWideCols ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CU_TENSOR_MAP_SWIZZLE_64B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  const size_t smem =
      (size_t)WideLayout(slice, batch, cluster, celem, cols, direct != 0)
          .total +
      1024;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (counts_bf16)
    return (int)dispatch_wide<__nv_bfloat16>(p, map, cols, direct != 0, smem,
                                             geometry, s);
  return (int)dispatch_wide<float>(p, map, cols, direct != 0, smem, geometry,
                                   s);
}

// The full range [0, K): the same arguments without k0 and k1.
int pylda_dense_sstats(const void* counts, int counts_bf16, const void* et,
                       const void* eeb, void* sstats, void* score_part,
                       void* score_out, void* partial, void* counters,
                       int D, int Vc, int V, int K, float eps, int splits,
                       int rows_per_split, void* stream) {
  return pylda_dense_sstats_range(counts, counts_bf16, et, eeb, sstats,
                                  score_part, score_out, partial, counters, D,
                                  Vc, V, K, 0, K, eps, splits, rows_per_split,
                                  stream);
}

}  // extern "C"
