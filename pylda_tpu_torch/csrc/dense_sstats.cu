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
// Wide K (K > 256, up to 4096).  A column's sums no longer fit 4 lanes'
// registers, so the lanes a column (LPC) grow with K: 8 at KP = 512, 16
// at 1024, 32 (a warp) at 2048 and 4096, each lane holding 16 float4s of
// sums (32 at 4096), and a CTA owns 256 / LPC columns (32, 16 or 8).  The
// expElogbeta tile stays <= 66 KB (131 KB at 4096), phinorm is a butterfly
// over the column's lanes, and the counts are still read once, chunk by
// chunk, with a ballot-built row mask a column.  expEtheta is not staged
// (32 rows of KP floats would not fit twice): a nonzero's lanes read its
// expEtheta row from global memory (L2: [1216, 1000] f32 is 4.9 MB at SVI
// config 5) for phinorm and again for the sums.  Counts chunks are issued
// 4 ahead and the 16-float4 builds run 2 CTAs an SM.  Bound at SVI config
// 5's first minibatch chunk ([1216, 100352] bf16, K=1000, 182,065
// nonzeros, 0.15%): the 244 MB of counts plus expElogbeta read and sstats
// written once, 0.313 ms at 3.35 TB/s, against 0.73 GFLOP of arithmetic:
// bytes.  Measured 3.62 ms there on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md): each CTA walks its 38 chunks one after another, almost
// empty at this density, so each chunk's latency (barrier, counts,
// expEtheta loads of its few nonzeros) sets the time, not the bytes.
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
// Above K = 4096 the entries pylda_dense_sstats_two_pass_count and
// pylda_dense_sstats_two_pass run two passes over a column list of the
// nonzeros instead (their note is at the kernels, below).
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
// as phinorm reads it, and the ratio are rounded to bf16 (nearest even)
// where the walk reads or forms them; the sums stay f32.  phinorm, hence
// the score, and the epilogue's multiply by expElogbeta use the staged
// f32 values: the tile is staged in f32 and rounded only when phinorm
// reads it.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

// The build's operand mode: 0 float32, 1 bf16 operands (-DPYLDA_BF16=1).
#ifndef PYLDA_BF16
#define PYLDA_BF16 0
#endif

namespace {

constexpr bool kBf16 = PYLDA_BF16 != 0;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileV = 64;    // vocab columns a CTA owns at 4 lanes a column
constexpr int kRows = 32;     // rows a chunk: a column's row mask is a word

// KP = 4 * LPC * N4 topics (LPC lanes x N4 float4s) and COLS columns a
// CTA.  With 4 lanes a column (K <= 256) LD, the row stride of the staged
// expEtheta rows and expElogbeta columns, puts the float4s that a quarter
// warp's two adjacent 4-lane groups read into 8 distinct bank quads; with
// more, a quarter warp reads 128 contiguous bytes of one column.
//
// Counts chunks are issued AHEAD chunks ahead of their use into CNT_BUFS
// buffers: 2 (3 buffers) with 4 lanes a column, whose expEtheta loads
// take their own pipeline groups; 4 (5 buffers) with more, whose chunks
// are 32 x COLS <= 1 KB of bf16 and whose walks are short at low density,
// so a chunk's latency is spread over 3 iterations.
template <int N4, int LPC>
struct Layout {
  static constexpr int KP = 4 * LPC * N4;
  static constexpr int COLS = kThreads / LPC;
  static constexpr bool STAGE_ET = LPC == 4;
  static constexpr int LD =
      STAGE_ET ? KP + ((KP / 4) % 8 == 4 ? 0 : 16) : KP + 4;
  static constexpr int AHEAD = STAGE_ET ? 2 : 4;
  static constexpr int CNT_BUFS = AHEAD + 1;
  // The wide builds of 16 float4s a lane ask for 2 blocks an SM (at most
  // 128 registers); the others leave registers to the compiler.
  static constexpr bool TWO_BLOCKS = !STAGE_ET && N4 <= 16;
};

// Row stride (elements) of a staged counts chunk: the columns and 16
// bytes, so the 8 lanes of a quarter warp reading 8 rows hit 8 bank quads.
template <typename CT, int COLS = kTileV>
__host__ __device__ constexpr int cnt_ld() {
  return COLS + 16 / (int)sizeof(CT);
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
__device__ __forceinline__ float4 operand4(float4 v) {
  return make_float4(operand(v.x), operand(v.y), operand(v.z), operand(v.w));
}

// Issues the copies of counts rows [d0, d0 + kRows) x columns
// [v0, v0 + COLS) into dst ([kRows][cnt_ld]) and commits them as one
// group; rows past d_hi and columns past Vc read as zero.  vec: 16-byte
// copies (rows 16-byte aligned); else element loads.
template <typename CT, int COLS>
__device__ __forceinline__ void load_chunk(CT* dst, const CT* counts, int d0,
                                           int d_hi, int v0, int Vc,
                                           bool vec) {
  constexpr int E = 16 / sizeof(CT);  // elements a 16-byte copy
  constexpr int SEGS = kRows * COLS / E;
  for (int i = threadIdx.x; i < SEGS; i += kThreads) {
    const int r = i / (COLS / E), c = (i % (COLS / E)) * E;
    const int d = d0 + r, v = v0 + c;
    CT* s = dst + r * cnt_ld<CT, COLS>() + c;
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

// Compaction of a staged chunk of COLS < 64 columns: warp w takes columns
// w, w + 8, .., lane r reads row r, and one ballot a column gives its row
// mask (cmask[c]).
template <typename CT, int COLS>
__device__ __forceinline__ void compact_cols(const CT* cnt, unsigned* cmask) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int c = warp; c < COLS; c += kWarps) {
    const unsigned m = __ballot_sync(
        kFull, to_float(cnt[lane * cnt_ld<CT, COLS>() + c]) != 0.f);
    if (lane == 0) cmask[c] = m;
  }
}

// The float4 of topics k..k+3 of an expEtheta row in global memory, zero
// past K (vec: K % 4 == 0 and 16-byte aligned rows).
__device__ __forceinline__ float4 et4(const float* row, int k, int K,
                                      bool vec) {
  if (vec)
    return k < K ? __ldg(reinterpret_cast<const float4*>(row + k))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(k < K ? __ldg(row + k) : 0.f,
                     k + 1 < K ? __ldg(row + k + 1) : 0.f,
                     k + 2 < K ? __ldg(row + k + 2) : 0.f,
                     k + 3 < K ? __ldg(row + k + 3) : 0.f);
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

// One CTA's tile and row split (the kernels below are its two entries).
template <typename CT, int N4, int LPC>
__device__ __forceinline__ void sstats_tile(
    const CT* __restrict__ counts, const float* __restrict__ et,
    const float* __restrict__ eeb, float* __restrict__ sstats,
    double* __restrict__ score_part, float* __restrict__ score_out,
    float* __restrict__ partial, int* __restrict__ counters, int D, int Vc,
    int V, int K, int k0, int k1, float eps, int rows_per_split) {
  using L = Layout<N4, LPC>;
  constexpr int COLS = L::COLS;
  extern __shared__ __align__(16) float smem[];
  float* eeb_s = smem;                        // [COLS][LD] expElogbeta^T tile
  float* et_s = eeb_s + COLS * L::LD;         // [2][kRows][LD] touched rows
  // [CNT_BUFS][kRows][cnt_ld]
  CT* cnt_s = reinterpret_cast<CT*>(et_s + (L::STAGE_ET ? 2 * kRows * L::LD : 0));
  unsigned* cmask_s = reinterpret_cast<unsigned*>(
      cnt_s + L::CNT_BUFS * kRows * cnt_ld<CT, COLS>());  // [2][COLS] masks
  unsigned* rmask_s = cmask_s + 2 * COLS;              // [2][8] row masks
  __shared__ double score_s[kWarps];
  __shared__ int last_s, last_grid_s;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // Owner of column c: lanes LPC c .. LPC c + LPC - 1; lane j holds the
  // float4s j, j + LPC, .. of its topics.
  const int c = tid / LPC, j = tid % LPC;
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int v0 = tile * COLS;
  const int d_lo = split * rows_per_split;
  const int d_hi = min(D, d_lo + rows_per_split);
  const int chunks = d_hi > d_lo ? (d_hi - d_lo + kRows - 1) / kRows : 0;
  const bool vec = (Vc * (int)sizeof(CT)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(counts) % 16 == 0;
  const bool et_vec =
      K % 4 == 0 && reinterpret_cast<uintptr_t>(et) % 16 == 0;
  auto cbuf = [cnt_s](int i) {
    return cnt_s + (i % L::CNT_BUFS) * kRows * cnt_ld<CT, COLS>();
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
  // issue chunk i+1's expEtheta rows (4 lanes a column only), then compute
  // chunk i.
  for (int i = 0; i < L::AHEAD && i < chunks; ++i)
    load_chunk<CT, COLS>(cbuf(i), counts, d_lo + i * kRows, d_hi, v0, Vc,
                         vec);
  // The expElogbeta tile, transposed.  4 lanes a column: a warp copies 16
  // topics of 2 columns (LD = 16 mod 32: its 32 stores hit 32 banks);
  // more: a warp copies whole rows of the tile's columns (coalesced reads).
  for (int i = tid; i < COLS * L::LD; i += kThreads) {
    int cc = i % COLS, k = i / COLS;
    if (L::STAGE_ET) {
      const int rest = i / 16;
      cc = rest % kTileV;
      k = (rest / kTileV) * 16 + i % 16;
    }
    float* dst = eeb_s + cc * L::LD + k;
    if (k < K && v0 + cc < V)
      __pipeline_memcpy_async(dst, eeb + (size_t)k * V + v0 + cc, 4);
    else
      *dst = 0.f;
  }
  __pipeline_commit();
  if constexpr (L::STAGE_ET)
    for (int i = tid; i < 2 * kRows * L::LD; i += kThreads) et_s[i] = 0.f;
  __pipeline_wait_prior(0);
  __syncthreads();
  if (chunks > 0) {
    if constexpr (L::STAGE_ET) {
      compact(cbuf(0), cmask_s, rmask_s);
      __syncthreads();
      load_et(et_s, L::LD, et, d_lo, touched_rows(rmask_s), K, et_vec);
    } else {
      compact_cols<CT, COLS>(cbuf(0), cmask_s);
    }
  }

  float4 acc[N4];
#pragma unroll
  for (int i = 0; i < N4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  double score = 0.0;

  const float* bcol = eeb_s + c * L::LD + 4 * j;
  for (int ci = 0; ci < chunks; ++ci) {
    const int d0 = d_lo + ci * kRows;
    const int cur = ci & 1, nxt = cur ^ 1;
    // Chunk ci's expEtheta and chunk ci+1's counts are in: with 4 lanes a
    // column every group, else all but the AHEAD - 2 latest (each
    // iteration commits one group, empty past the last chunk).
    __pipeline_wait_prior(L::STAGE_ET ? 0 : L::AHEAD - 2);
    __syncthreads();
    if (ci + L::AHEAD < chunks)
      load_chunk<CT, COLS>(cbuf(ci + L::AHEAD), counts,
                           d0 + L::AHEAD * kRows, d_hi, v0, Vc, vec);
    else if (!L::STAGE_ET)
      __pipeline_commit();
    if constexpr (L::STAGE_ET) {
      if (ci + 1 < chunks)
        compact(cbuf(ci + 1), cmask_s + nxt * kTileV, rmask_s + nxt * kWarps);
      __syncthreads();  // chunk ci+1's masks
      if (ci + 1 < chunks)
        load_et(et_s + nxt * kRows * L::LD, L::LD, et, d0 + kRows,
                touched_rows(rmask_s + nxt * kWarps), K, et_vec);
    } else if (ci + 1 < chunks) {
      compact_cols<CT, COLS>(cbuf(ci + 1), cmask_s + nxt * COLS);
    }

    // Column c's nonzeros in row order, by its LPC lanes.
    const CT* cnt = cbuf(ci);
    const float* ets = et_s + cur * kRows * L::LD;
    unsigned m = cmask_s[cur * COLS + c];
    const int n = __popc(m);
    const int steps = __reduce_max_sync(kFull, n);
    for (int t = 0; t < steps; ++t) {
      const bool on = t < n;
      const int r = on ? __ffs(m) - 1 : 0;
      m &= m - 1;
      // The row's expEtheta: staged (4 lanes a column), else in global.
      const float* erow = L::STAGE_ET ? ets + r * L::LD + 4 * j
                                      : et + (size_t)(d0 + r) * K;
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (on) {  // lanes without a nonzero read nothing
#pragma unroll
        for (int i = 0; i < N4; ++i) {
          const float4 e = operand4(
              L::STAGE_ET ? lds4(erow + 4 * LPC * i)
                          : et4(erow, 4 * (j + LPC * i), K, et_vec));
          const float4 b = operand4(lds4(bcol + 4 * LPC * i));
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
        const float cv = to_float(cnt[r * cnt_ld<CT, COLS>() + c]);
        const float pn = p + eps;
        const float ratio = operand(cv / pn);
        if (j == 0) score += (double)(cv * logf(pn));
#pragma unroll
        for (int i = 0; i < N4; ++i) {
          if (!kept(i)) continue;
          const float4 e = operand4(
              L::STAGE_ET ? lds4(erow + 4 * LPC * i)
                          : et4(erow, 4 * (j + LPC * i), K, et_vec));
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
  // Partial sums: [tile][split][COLS columns][4 QR]; lane j's float4 i at
  // 4 (j + LPC i - q0) of its column's.
  float* mine =
      partial + ((size_t)(tile * splits + split) * COLS + c) * 4 * QR;
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
    const float* base = mine - (size_t)split * COLS * 4 * QR;
#pragma unroll
    for (int i = 0; i < N4; ++i)
      if (kept(i))
        acc[i] = __ldcg(reinterpret_cast<const float4*>(base + at(i)));
#pragma unroll 4
    for (int s = 1; s < splits; ++s) {
      const float* ps = base + (size_t)s * COLS * 4 * QR;
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

#define PYLDA_SSTATS_PARAMS                                                 \
  const CT *__restrict__ counts, const float *__restrict__ et,             \
      const float *__restrict__ eeb, float *__restrict__ sstats,           \
      double *__restrict__ score_part, float *__restrict__ score_out,      \
      float *__restrict__ partial, int *__restrict__ counters, int D,      \
      int Vc, int V, int K, int k0, int k1, float eps, int rows_per_split
#define PYLDA_SSTATS_ARGS                                                   \
  counts, et, eeb, sstats, score_part, score_out, partial, counters, D, Vc, \
      V, K, k0, k1, eps, rows_per_split

template <typename CT, int N4, int LPC>
__global__ void __launch_bounds__(kThreads)
dense_sstats_kernel(PYLDA_SSTATS_PARAMS) {
  sstats_tile<CT, N4, LPC>(PYLDA_SSTATS_ARGS);
}

template <typename CT, int N4, int LPC>
__global__ void __launch_bounds__(kThreads, 2)
dense_sstats_kernel_two_blocks(PYLDA_SSTATS_PARAMS) {
  sstats_tile<CT, N4, LPC>(PYLDA_SSTATS_ARGS);
}

#undef PYLDA_SSTATS_PARAMS
#undef PYLDA_SSTATS_ARGS

// Sets the kernel's shared memory and launches it.
template <typename CT, typename Kernel>
cudaError_t launch_kernel(Kernel kern, size_t smem, dim3 grid,
                          cudaStream_t stream, const void* counts,
                          const void* et, const void* eeb, void* sstats,
                          void* score_part, void* score_out, void* partial,
                          void* counters, int D, int Vc, int V, int K,
                          int k0, int k1, float eps, int rows_per_split) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const CT*>(counts), static_cast<const float*>(et),
      static_cast<const float*>(eeb), static_cast<float*>(sstats),
      static_cast<double*>(score_part), static_cast<float*>(score_out),
      static_cast<float*>(partial), static_cast<int*>(counters), D, Vc, V, K,
      k0, k1, eps, rows_per_split);
  return cudaGetLastError();
}

template <typename CT, int N4, int LPC>
cudaError_t launch(const void* counts, const void* et, const void* eeb,
                   void* sstats, void* score_part, void* score_out,
                   void* partial, void* counters, int D, int Vc, int V, int K,
                   int k0, int k1, float eps, int splits, int rows_per_split,
                   cudaStream_t stream) {
  using L = Layout<N4, LPC>;
  const size_t smem =
      sizeof(float) * (size_t)(L::COLS + (L::STAGE_ET ? 2 * kRows : 0)) *
          L::LD +
      L::CNT_BUFS * sizeof(CT) * kRows * cnt_ld<CT, L::COLS>() +
      sizeof(unsigned) * 2 * (L::COLS + kWarps);
  const dim3 grid((Vc + L::COLS - 1) / L::COLS, splits);
  if constexpr (L::TWO_BLOCKS)
    return launch_kernel<CT>(dense_sstats_kernel_two_blocks<CT, N4, LPC>,
                             smem, grid, stream, counts, et, eeb, sstats,
                             score_part, score_out, partial, counters, D, Vc,
                             V, K, k0, k1, eps, rows_per_split);
  else
    return launch_kernel<CT>(dense_sstats_kernel<CT, N4, LPC>, smem, grid,
                             stream, counts, et, eeb, sstats, score_part,
                             score_out, partial, counters, D, Vc, V, K, k0,
                             k1, eps, rows_per_split);
}

// The kernel build whose columns have LANES lanes of 4 * N4 topics each:
// the first with K <= 4 * LANES * N4 (ops/sstats.py::BUILDS mirrors it).
template <typename CT>
cudaError_t dispatch(int K, const void* counts, const void* et,
                     const void* eeb, void* sstats, void* score_part,
                     void* score_out, void* partial, void* counters, int D,
                     int Vc, int V, int k0, int k1, float eps, int splits,
                     int rows_per_split, cudaStream_t s) {
#define PYLDA_BUILD(N, LANES)                                              \
  if (K <= 4 * LANES * N)                                                  \
    return launch<CT, N, LANES>(counts, et, eeb, sstats, score_part,       \
                                score_out, partial, counters, D, Vc, V, K, \
                                k0, k1, eps, splits, rows_per_split, s);
  PYLDA_BUILD(1, 4)
  PYLDA_BUILD(2, 4)
  PYLDA_BUILD(4, 4)
  PYLDA_BUILD(7, 4)
  PYLDA_BUILD(8, 4)
  PYLDA_BUILD(16, 4)
  PYLDA_BUILD(16, 8)
  PYLDA_BUILD(16, 16)
  PYLDA_BUILD(16, 32)
  PYLDA_BUILD(32, 32)
#undef PYLDA_BUILD
  return cudaErrorInvalidValue;
}

// -- Two passes above K = 4096 ----------------------------------------------
//
// Above the largest build a column's sums fit no warp's registers.  The
// nonzeros are listed by column first (CSC, a count pass, a scan and a fill;
// each column's nonzeros in row order), and the work splits in two:
//   pass 1  a CTA a tile of kTpCols columns over ALL K: phinorm of each of
//           its nonzeros, by topic tiles of kTpTopics staged from
//           expElogbeta's rows as a [kTpTopics][kTpCols] slice (coalesced
//           128-byte reads), a warp a nonzero summing its lanes' dots in
//           tile order; then ratio = C / (phinorm + eps) and the score term
//           (f64, a fixed order) for each nonzero, the ratio written over
//           the list's phinorm;
//   pass 2  a CTA a (column tile, topic tile of [k0, k1)): thread k adds
//           expEtheta[d, k] * ratio over each column's nonzeros in row
//           order, the sums go through shared memory, and the tile is
//           written as expElogbeta * raw, coalesced;
//   a last one-CTA kernel sums the CTAs' score parts in order.
// Each sum has one owner and one order, so two calls give the same bits,
// and a topic range's rows are the full call's rows bit for bit (pass 1
// and the CSC never depend on the range).  bf16 builds round where the
// one-pass builds do.  The host reads the nonzero count between the count
// pass and the rest (ops/sstats.py), to size the list: 12 bytes a nonzero.
// What bounds it at SVI config 5's chunk ([1216, 100352] bf16, K = 8192,
// 182k nonzeros): the bytes, 0.244 GB of counts, 3.28 GB of expElogbeta
// read and 3.28 GB of sstats written (~2.0 ms at 3.35 TB/s), against ~6
// GFLOP; this simple version reads expElogbeta twice and the counts three
// times, and reads a nonzero's expEtheta row from L2 in both passes.

constexpr int kTpCols = 32;     // columns a pass-1 / pass-2 CTA
constexpr int kTpTopics = 256;  // topics a staged slice / a pass-2 CTA
constexpr int kTpLd = kTpCols + 1;  // slice row stride: no bank conflicts
constexpr int kScanThreads = 1024;

// colptr[v + 1] = nonzeros of column v (thread a column, rows in order).
template <typename CT>
__global__ void __launch_bounds__(kThreads)
tp_count(const CT* __restrict__ counts, int D, int Vc,
         long long* __restrict__ colptr) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= Vc) return;
  int n = 0;
#pragma unroll 8
  for (int d = 0; d < D; ++d) n += to_float(counts[(size_t)d * Vc + v]) != 0.f;
  colptr[v + 1] = n;
}

// colptr[v + 1] = the nonzeros of columns 0..v (the inclusive prefix sum
// of the column counts), colptr[0] = 0: the CSC's column starts, and
// colptr[Vc] the nonzero count.  One CTA; thread i a contiguous run.
__global__ void __launch_bounds__(kScanThreads)
tp_scan(long long* __restrict__ colptr, int Vc) {
  __shared__ long long part[kScanThreads];
  const int per = (Vc + kScanThreads - 1) / kScanThreads;
  const int j0 = min((int)threadIdx.x * per, Vc);
  const int j1 = min(j0 + per, Vc);
  long long mine = 0;
  for (int j = j0; j < j1; ++j) mine += colptr[j + 1];
  part[threadIdx.x] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long run = 0;
    for (int i = 0; i < kScanThreads; ++i) {
      const long long x = part[i];
      part[i] = run;
      run += x;
    }
  }
  __syncthreads();
  long long run = part[threadIdx.x];
  for (int j = j0; j < j1; ++j) {
    run += colptr[j + 1];
    colptr[j + 1] = run;
  }
  if (threadIdx.x == 0) colptr[0] = 0;
}

// The list: each column's nonzeros in row order from colptr[v] (rows, and
// counts as f32).
template <typename CT>
__global__ void __launch_bounds__(kThreads)
tp_fill(const CT* __restrict__ counts, int D, int Vc,
        const long long* __restrict__ colptr, int* __restrict__ rows,
        float* __restrict__ vals) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= Vc) return;
  long long pos = colptr[v];
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float c = to_float(counts[(size_t)d * Vc + v]);
    if (c != 0.f) {
      rows[pos] = d;
      vals[pos] = c;
      ++pos;
    }
  }
}

// Pass 1 (see above): ratio[i] for every nonzero i of the CTA's columns,
// and the CTA's score part.  phin, the running phinorm of a nonzero, is
// kept in ratio[i] until its last tile.
__global__ void __launch_bounds__(kThreads)
tp_ratio(const long long* __restrict__ colptr, const int* __restrict__ rows,
         const float* __restrict__ vals, const float* __restrict__ et,
         const float* __restrict__ eeb, float* __restrict__ ratio,
         double* __restrict__ score_part, int Vc, int V, int K, float eps) {
  __shared__ float slice[kTpTopics * kTpLd];
  __shared__ long long cs[kTpCols + 1];  // the columns' starts, and the end
  __shared__ double score_s[kWarps];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int v0 = blockIdx.x * kTpCols;
  for (int c = tid; c <= kTpCols; c += kThreads) cs[c] = colptr[min(v0 + c, Vc)];
  __syncthreads();
  const long long lo = cs[0], hi = cs[kTpCols];
  double score = 0.0;
  if (hi > lo) {
    for (int k0 = 0; k0 < K; k0 += kTpTopics) {
      __syncthreads();  // the slice before is read
      for (int i = tid; i < kTpTopics * kTpCols; i += kThreads) {
        const int kk = i / kTpCols, c = i % kTpCols;
        const int k = k0 + kk, v = v0 + c;
        slice[kk * kTpLd + c] =
            k < K && v < V ? __ldg(eeb + (size_t)k * V + v) : 0.f;
      }
      __syncthreads();
      // A warp a nonzero (i = lo + warp, lo + warp + 8, ..); lane l the
      // topics l, l + 32, .. of the slice.  c follows i: the column of i.
      int c = 0;
      for (long long i = lo + warp; i < hi; i += kWarps) {
        while (cs[c + 1] <= i) ++c;
        const float* erow = et + (size_t)rows[i] * K;
        float a = 0.f;
#pragma unroll
        for (int m = 0; m < kTpTopics / 32; ++m) {
          const int kk = lane + 32 * m;
          const int k = k0 + kk;
          const float e = k < K ? operand(__ldg(erow + k)) : 0.f;
          a = fmaf(e, operand(slice[kk * kTpLd + c]), a);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          a += __shfl_xor_sync(kFull, a, off);
        if (lane == 0) {
          const float ph = k0 == 0 ? a : ratio[i] + a;
          if (k0 + kTpTopics < K) {
            ratio[i] = ph;
          } else {
            const float cv = vals[i];
            const float pn = ph + eps;
            ratio[i] = operand(cv / pn);
            score += (double)(cv * logf(pn));
          }
        }
      }
    }
  }
  // The CTA's score: each warp's lane 0 summed its nonzeros in order.
  if (lane == 0) score_s[warp] = score;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += score_s[w];
    score_part[blockIdx.x] = s;
  }
}

// Pass 2 (see above): rows [k0 + blockIdx.y * kTpTopics, ..) of the topic
// range, columns [blockIdx.x * kTpCols, ..) of sstats [k1 - k0, V].
__global__ void __launch_bounds__(kThreads)
tp_sums(const long long* __restrict__ colptr, const int* __restrict__ rows,
        const float* __restrict__ ratio, const float* __restrict__ et,
        const float* __restrict__ eeb, float* __restrict__ sstats, int V,
        int K, int k0, int k1) {
  __shared__ float raw[kTpTopics * kTpLd];
  const int tid = threadIdx.x;
  const int v0 = blockIdx.x * kTpCols;
  const int kt = k0 + blockIdx.y * kTpTopics;
  const int k = kt + tid;
  if (k < k1) {
    for (int c = 0; c < kTpCols && v0 + c < V; ++c) {
      const long long lo = colptr[v0 + c], hi = colptr[v0 + c + 1];
      float acc = 0.f;
      long long i = lo;
      // Four nonzeros' loads in flight, their products added in order.
      for (; i + 4 <= hi; i += 4) {
        float e[4], r[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          e[u] = __ldg(et + (size_t)rows[i + u] * K + k);
          r[u] = ratio[i + u];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) acc = fmaf(operand(e[u]), r[u], acc);
      }
      for (; i < hi; ++i)
        acc = fmaf(operand(__ldg(et + (size_t)rows[i] * K + k)), ratio[i],
                   acc);
      raw[tid * kTpLd + c] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < kTpTopics * kTpCols; i += kThreads) {
    const int kk = i / kTpCols, c = i % kTpCols;
    const int kr = kt + kk, v = v0 + c;
    if (kr < k1 && v < V)
      sstats[(size_t)(kr - k0) * V + v] =
          __ldg(eeb + (size_t)kr * V + v) * raw[kk * kTpLd + c];
  }
}

// score_out = the sum of the n score parts in order (one CTA).
__global__ void __launch_bounds__(kThreads)
tp_score(const double* __restrict__ score_part, int n,
         float* __restrict__ score_out) {
  __shared__ double score_s[kWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  double t = 0.0;  // thread i: parts i, i + 256, ..; then a fixed tree
  for (int b = threadIdx.x; b < n; b += kThreads) t += score_part[b];
  for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(kFull, t, off);
  if (lane == 0) score_s[warp] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += score_s[w];
    *score_out = (float)s;
  }
}

}  // namespace

extern "C" {

// counts: [D, Vc] bf16 (counts_bf16 != 0) or f32; et: [D, K] f32; eeb:
// [K, V] f32, 1 <= K <= 4096; 0 <= k0 < k1 <= K, the topic range; sstats:
// out [k1 - k0, V] f32 (every entry written: rows k0..k1-1 of the full
// result); score_out: out [1] f32; score_part: scratch [splits * tiles]
// f64, tiles = ceil(Vc / COLS); partial: scratch [tiles * splits * COLS *
// 4 QR] f32, QR = ceil(k1 / 4) - floor(k0 / 4) (unused when splits == 1);
// counters: [tiles + 1] int32, zero before the first call and left zero by
// each call (so one buffer serves a stream's calls in turn).  COLS is the
// build's (dispatch, keyed on K); the plan (ops/sstats.py::plan) gives it,
// QR, splits and rows_per_split (a multiple of 32, splits *
// rows_per_split >= D).  All row-major and contiguous.  Returns the
// cudaError_t of the launch.
int pylda_dense_sstats_range(const void* counts, int counts_bf16,
                             const void* et, const void* eeb, void* sstats,
                             void* score_part, void* score_out, void* partial,
                             void* counters, int D, int Vc, int V, int K,
                             int k0, int k1, float eps, int splits,
                             int rows_per_split, void* stream) {
  if (K < 1 || K > 4096 || k0 < 0 || k1 <= k0 || k1 > K || splits < 1 ||
      rows_per_split < kRows || rows_per_split % kRows != 0 ||
      (long long)splits * rows_per_split < D)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (counts_bf16)
    return (int)dispatch<__nv_bfloat16>(K, counts, et, eeb, sstats,
                                        score_part, score_out, partial,
                                        counters, D, Vc, V, k0, k1, eps,
                                        splits, rows_per_split, s);
  return (int)dispatch<float>(K, counts, et, eeb, sstats, score_part,
                              score_out, partial, counters, D, Vc, V, k0, k1,
                              eps, splits, rows_per_split, s);
}

// Two passes above K = 4096: the column counts and their prefix.  counts:
// [D, Vc] bf16 (counts_bf16 != 0) or f32; colptr: out [Vc + 1] int64, the
// CSC's column starts, colptr[Vc] the nonzero count.  Returns the
// cudaError_t of the launches.
int pylda_dense_sstats_two_pass_count(const void* counts, int counts_bf16,
                                      int D, int Vc, void* colptr,
                                      void* stream) {
  if (D < 0 || Vc < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* cp = static_cast<long long*>(colptr);
  const int blocks = (Vc + kThreads - 1) / kThreads;
  if (counts_bf16)
    tp_count<<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(counts), D, Vc, cp);
  else
    tp_count<<<blocks, kThreads, 0, s>>>(static_cast<const float*>(counts),
                                         D, Vc, cp);
  tp_scan<<<1, kScanThreads, 0, s>>>(cp, Vc);
  return (int)cudaGetLastError();
}

// The rest of the two passes, after pylda_dense_sstats_two_pass_count on
// the same counts: et [D, K] f32, eeb [K, V] f32, K > 4096, 0 <= k0 < k1
// <= K; sstats: out [k1 - k0, V] f32 (rows k0..k1-1 of the full result);
// score_out: out [1] f32; colptr: [Vc + 1] int64 as the count left it;
// rows, vals, ratio: scratch [nnz] int32, f32, f32 (nnz = colptr[Vc]);
// score_part: scratch [ceil(Vc / 32)] f64.  Returns the cudaError_t of the
// launches.
int pylda_dense_sstats_two_pass(const void* counts, int counts_bf16,
                                const void* et, const void* eeb,
                                void* sstats, void* score_out, void* colptr,
                                void* rows, void* vals, void* ratio,
                                void* score_part, int D, int Vc, int V, int K,
                                int k0, int k1, float eps, void* stream) {
  if (K <= 4096 || D < 0 || Vc < V || V < 1 || k0 < 0 || k1 <= k0 || k1 > K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* cp = static_cast<long long*>(colptr);
  int* rw = static_cast<int*>(rows);
  float* vl = static_cast<float*>(vals);
  float* rt = static_cast<float*>(ratio);
  const float* e = static_cast<const float*>(et);
  const float* b = static_cast<const float*>(eeb);
  double* sp = static_cast<double*>(score_part);
  const int blocks = (Vc + kThreads - 1) / kThreads;
  if (counts_bf16)
    tp_fill<<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(counts), D, Vc, cp, rw, vl);
  else
    tp_fill<<<blocks, kThreads, 0, s>>>(static_cast<const float*>(counts), D,
                                        Vc, cp, rw, vl);
  const int tiles = (Vc + kTpCols - 1) / kTpCols;
  tp_ratio<<<tiles, kThreads, 0, s>>>(cp, rw, vl, e, b, rt, sp, Vc, V, K, eps);
  const dim3 grid((V + kTpCols - 1) / kTpCols,
                  (k1 - k0 + kTpTopics - 1) / kTpTopics);
  tp_sums<<<grid, kThreads, 0, s>>>(cp, rw, rt, e, b,
                                    static_cast<float*>(sstats), V, K, k0, k1);
  tp_score<<<1, kThreads, 0, s>>>(sp, tiles, static_cast<float*>(score_out));
  return (int)cudaGetLastError();
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
