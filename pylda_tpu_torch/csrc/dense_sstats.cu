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
// phinorm and the ratio never leave shared memory.
//
// Bound on an H100 SXM at the flagship chunk (D=4096, Vc=10240, K=100):
// the two products are 4*D*K*V = 16.4 GFLOP, ~245 us at the 67 TFLOP/s
// f32 rate outside the tensor cores, against ~25 us to read the 84 MB bf16
// counts once at 3.35 TB/s: the kernel is bound by operations.
//
// Design: a CTA (256 threads) owns a 64-column vocab tile and one half of
// the rows (gridDim.y = 2: 320 CTAs at the flagship, 2-3 on every SM,
// where 160 left 28 SMs with double work).  It walks its rows in chunks of
// 32 and keeps its [KP, 64] block of raw in registers, so no reduction
// over the row axis is needed beyond the two halves: each output gets
// exactly two atomic adds onto zero, and a + b == b + a, so the result is
// deterministic.  Per chunk: stage expEtheta [32, KP] in shared memory
// (the expElogbeta tile [KP, 64] is staged once), then
//   phinorm: each thread a 2-row x 4-column register tile, operands read
//            as 16-byte vectors (6 loads per 32 FMAs);
//   ratio = C / phinorm (and the score) into shared memory;
//   raw += expEtheta^T . ratio: each thread a KPT-topic x 4-column tile
//            (KPT/4 + 1 loads per 4*KPT FMAs).
// The tiles keep shared-memory loads well below the FMA rate (one operand
// a FMA from shared memory leaves the shared-memory pipe, not the FMA
// units, setting the pace).  Plain f32 FMAs, no TF32: the CPU reference
// is plain f32.  Each CTA writes its partial score
// (f64 accumulation) to score_part; the wrapper sums that buffer in order.
// Tensor cores, TMA and bf16 operands are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileV = 64;  // vocab columns a CTA owns
constexpr int kTileD = 32;  // rows a chunk
constexpr int kSplit = 2;   // row halves (gridDim.y)

__device__ __forceinline__ float load_count(const float* p) { return *p; }
__device__ __forceinline__ float load_count(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int KPT>
struct Layout {
  static constexpr int KP = 16 * KPT;     // padded topics (16 thread rows)
  static constexpr int ET_LD = KP + 4;    // et_s row stride (bank shift)
  static constexpr int floats =
      kTileD * ET_LD + KP * kTileV + kTileD * kTileV;
};

template <typename CT, int KPT>
__global__ void __launch_bounds__(kThreads, KPT <= 8 ? 3 : 2)
dense_sstats_kernel(const CT* __restrict__ counts,
                    const float* __restrict__ et,
                    const float* __restrict__ eeb,
                    float* __restrict__ sstats,
                    double* __restrict__ score_part,
                    int D, int Vc, int V, int K, float eps) {
  using L = Layout<KPT>;
  extern __shared__ __align__(16) float smem[];
  float* et_s = smem;                          // [kTileD][ET_LD]
  float* eeb_s = et_s + kTileD * L::ET_LD;     // [KP][kTileV]
  float* ratio_s = eeb_s + L::KP * kTileV;     // [kTileD][kTileV]
  __shared__ double score_s[kThreads / 32];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns 4tx .. 4tx+3 of the tile
  const int ty = tid / 16;  // phinorm rows 2ty, 2ty+1; topics ty*KPT + j
  const int v0 = blockIdx.x * kTileV;
  const int rows = (D + kSplit - 1) / kSplit;
  const int d_lo = blockIdx.y * rows;
  const int d_hi = min(D, d_lo + rows);
  const int k4 = (K + 3) & ~3;  // phinorm loop bound (zero-padded)

  for (int i = tid; i < L::KP * kTileV; i += kThreads) {
    const int k = i / kTileV, c = i % kTileV;
    eeb_s[i] = (k < K && v0 + c < V) ? eeb[(size_t)k * V + v0 + c] : 0.f;
  }
  __syncthreads();  // the epilogue reads eeb_s even when no chunk runs

  float acc[KPT][4];
#pragma unroll
  for (int j = 0; j < KPT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
  double score = 0.0;

  for (int d0 = d_lo; d0 < d_hi; d0 += kTileD) {
    __syncthreads();  // the previous chunk is done with et_s / ratio_s
    for (int i = tid; i < kTileD * L::KP; i += kThreads) {
      const int r = i / L::KP, k = i % L::KP;
      et_s[r * L::ET_LD + k] =
          (k < K && d0 + r < d_hi) ? et[(size_t)(d0 + r) * K + k] : 0.f;
    }
    __syncthreads();

    // phinorm for rows 2ty, 2ty+1 and columns 4tx .. 4tx+3.
    float ph[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) ph[i][c] = 0.f;
    const float* a_row = et_s + (2 * ty) * L::ET_LD;
    for (int k = 0; k < k4; k += 4) {
      const float4 a0 = lds4(a_row + k);
      const float4 a1 = lds4(a_row + L::ET_LD + k);
      const float4 b0 = lds4(eeb_s + (k + 0) * kTileV + 4 * tx);
      const float4 b1 = lds4(eeb_s + (k + 1) * kTileV + 4 * tx);
      const float4 b2 = lds4(eeb_s + (k + 2) * kTileV + 4 * tx);
      const float4 b3 = lds4(eeb_s + (k + 3) * kTileV + 4 * tx);
      const float av[2][4] = {{a0.x, a0.y, a0.z, a0.w},
                              {a1.x, a1.y, a1.z, a1.w}};
      const float bv[4][4] = {{b0.x, b0.y, b0.z, b0.w},
                              {b1.x, b1.y, b1.z, b1.w},
                              {b2.x, b2.y, b2.z, b2.w},
                              {b3.x, b3.y, b3.z, b3.w}};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float p = ph[i][c];
#pragma unroll
          for (int q = 0; q < 4; ++q) p = fmaf(av[i][q], bv[q][c], p);
          ph[i][c] = p;
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 2 * ty + i;
      const int d = d0 + r;
      float rt[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int v = v0 + 4 * tx + c;
        float cv = 0.f;
        if (d < d_hi && v < Vc) cv = load_count(&counts[(size_t)d * Vc + v]);
        const float pn = ph[i][c] + eps;
        if (cv != 0.f) score += (double)(cv * logf(pn));
        rt[c] = cv / pn;
      }
      *reinterpret_cast<float4*>(ratio_s + r * kTileV + 4 * tx) =
          make_float4(rt[0], rt[1], rt[2], rt[3]);
    }
    __syncthreads();

    // raw[ty*KPT + j, 4tx + c] += sum_r et[r, ty*KPT + j] * ratio[r, 4tx + c]
    const float* e_col = et_s + ty * KPT;
    for (int r = 0; r < kTileD; ++r) {
      const float4 q4 = lds4(ratio_s + r * kTileV + 4 * tx);
      const float rv[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
      for (int jq = 0; jq < KPT / 4; ++jq) {
        const float4 e4 = lds4(e_col + r * L::ET_LD + 4 * jq);
        const float ev[4] = {e4.x, e4.y, e4.z, e4.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[4 * jq + jj][c] = fmaf(ev[jj], rv[c], acc[4 * jq + jj][c]);
      }
    }
  }

  // Two CTAs (the row halves) add into each zeroed output: deterministic.
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int k = ty * KPT + j;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int v = v0 + 4 * tx + c;
      if (k < K && v < V)
        atomicAdd(&sstats[(size_t)k * V + v],
                  eeb_s[k * kTileV + 4 * tx + c] * acc[j][c]);
    }
  }

  // Block reduction of the partial score, in a fixed order.
  for (int off = 16; off > 0; off >>= 1)
    score += __shfl_down_sync(0xffffffffu, score, off);
  if (tid % 32 == 0) score_s[tid / 32] = score;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) s += score_s[w];
    score_part[blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

template <typename CT, int KPT>
cudaError_t launch(const void* counts, const void* et, const void* eeb,
                   void* sstats, void* score_part, int D, int Vc, int V,
                   int K, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)Layout<KPT>::floats;
  cudaError_t err = cudaFuncSetAttribute(
      dense_sstats_kernel<CT, KPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Vc + kTileV - 1) / kTileV, kSplit);
  dense_sstats_kernel<CT, KPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const CT*>(counts), static_cast<const float*>(et),
      static_cast<const float*>(eeb), static_cast<float*>(sstats),
      static_cast<double*>(score_part), D, Vc, V, K, eps);
  return cudaGetLastError();
}

template <typename CT>
cudaError_t dispatch_k(const void* counts, const void* et, const void* eeb,
                       void* sstats, void* score_part, int D, int Vc, int V,
                       int K, float eps, cudaStream_t stream) {
  if (K <= 64)
    return launch<CT, 4>(counts, et, eeb, sstats, score_part, D, Vc, V, K,
                         eps, stream);
  if (K <= 128)
    return launch<CT, 8>(counts, et, eeb, sstats, score_part, D, Vc, V, K,
                         eps, stream);
  if (K <= 256)
    return launch<CT, 16>(counts, et, eeb, sstats, score_part, D, Vc, V, K,
                          eps, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Number of CTAs (= entries of score_part) for a counts width Vc.
int pylda_dense_sstats_blocks(int Vc) {
  return kSplit * ((Vc + kTileV - 1) / kTileV);
}

// counts: [D, Vc] bf16 (counts_bf16 != 0) or f32; et: [D, K] f32;
// eeb: [K, V] f32; sstats: out [K, V] f32, ZEROED by the caller (the two
// row halves add into it); score_part: out [pylda_dense_sstats_blocks(Vc)]
// f64.  All row-major and contiguous.  Returns the cudaError_t of the
// launch.
int pylda_dense_sstats(const void* counts, int counts_bf16, const void* et,
                       const void* eeb, void* sstats, void* score_part, int D,
                       int Vc, int V, int K, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (counts_bf16)
    return (int)dispatch_k<__nv_bfloat16>(counts, et, eeb, sstats,
                                          score_part, D, Vc, V, K, eps, s);
  return (int)dispatch_k<float>(counts, et, eeb, sstats, score_part, D, Vc,
                                V, K, eps, s);
}

}  // extern "C"
