// Dense-layout gamma fixed point of the VB E-step (sm_90a).
//
// Replaces pylda_tpu/ops/pallas_estep.py::pallas_estep_dense (kernel body
// _estep_tile_kernel) up to its final pass, with the semantics of the JAX
// main path's default, pylda_tpu/ops/estep.py::estep_dense: for counts
// C [D, Vc] (bf16 or f32; Vc a multiple of 64, zero columns past V) and
// expElogbeta E [K, Vc] (zero columns past V)
//
//   phinorm[d, v] = sum_k expEtheta[d, k] * E[k, v] + eps
//   gamma'[d, k]  = alpha[k] + expEtheta[d, k] * sum_v C[d, v] / phinorm[d, v] * E[k, v]
//   expEtheta     = exp(psi(gamma') - psi(sum gamma'))   (2-shift fast series)
//
// with the per-row exit rule of _exit_update, as in ragged_gamma.cu:
// change = mean_k |dgamma|, improved = change < 0.99 * best, a sticky
// `done` (best <= threshold) that freezes the row, a non-sticky stall
// (age >= patience), and a loop that ends only when EVERY row is done or
// stalled, or at inner_iterations; threshold == 0 runs exactly
// inner_iterations sweeps with no freezing.  The initial expEtheta uses the
// exact digamma (the wrapper computes it with torch.special.digamma and
// passes it in as et, updated in place).  The final pass of the Pallas
// kernel — sstats and the token score at the exact expectation of the
// converged gamma — is dense_sstats.cu, launched by the wrapper
// (pylda_tpu_torch/ops/dense_estep.py).
//
// Bound on an H100 SXM at the dense flagship (D=4096, V=4096, K=100, ~120
// tokens a document): the function needs phinorm and the ratio only where
// a count is nonzero (~3% of the columns), so its two products are
// 4*K*nnz FLOP a row a sweep, ~0.18 GFLOP a sweep over all rows, ~2.7 us
// at the 67 TFLOP/s f32 rate outside the tensor cores, against ~10 us to
// read the 32 MiB of bf16 counts once at 3.35 TB/s: bound by operations
// over a whole fixed point of S sweeps.  This kernel walks all Vc columns
// (4*K*Vc FLOP a row a sweep, ~30x that work): the dense form of the
// Pallas kernel, kept for a first port.
//
// Design.  The exit is global to the batch, so the whole loop runs in ONE
// cooperative launch, with the machinery of ragged_gamma.cu: the grid is
// what fits on the card at once, each tile of 32 rows belongs to one block
// for the whole launch (its gamma, expEtheta, best, age and done stay that
// block's), the blocks add their rows that are not exitable to a
// triple-buffered device counter, and the grid meets at this_grid().sync()
// once a sweep.  No host sync inside the loop; the sweep count stays on the
// device.  A tile whose rows are all done is skipped.
//
// Per tile and sweep (256 threads, thread (tx, ty) = (tid % 16, tid / 16)):
// the tile's expEtheta [32, KP] sits in shared memory, and the vocabulary
// is walked in 64-column chunks.  A chunk's slice of E [K, 64] and of the
// counts [32, 64] are staged into shared memory by 16-byte cp.async copies,
// double-buffered (chunk c+1 is in flight while chunk c is computed); E
// (1.6 MB at the flagship) is read from L2 by every tile once a sweep.
// For each chunk:
//   phinorm: each thread a 2-row x 4-column register tile (rows 2ty,
//            2ty+1; columns 4tx..4tx+3), operands as 16-byte shared loads;
//   ratio = C / phinorm into shared memory (0 where C is 0);
//   acc  += ratio . E^T: each thread a 2-row x KPT-topic register tile
//           (topics tx + 16 j), kept in registers across all chunks.
// phinorm and the ratio never leave shared memory.  Then the 16 threads of
// a row (a half warp) meet by shuffles for sum_k |dgamma| and sum_k gamma',
// and write gamma' and the new expEtheta.  Plain f32 FMAs, no TF32: the
// CPU reference is plain f32.  Tensor cores, TMA and skipping zero-count
// columns are later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "exp_psi.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kTileD = 32;  // rows a tile (16 thread rows x 2)
constexpr int kTileV = 64;  // vocab columns a chunk (16 thread columns x 4)

struct Params {
  const void* counts;    // [D, Vc] bf16 or f32
  const float* eeb;      // [K, Vc], zero columns past V
  const float* alpha;    // [K]
  float* gamma;          // [D, K] in: gamma0, out: gamma
  float* et;             // [D, K] in: exact expEtheta(gamma0); scratch
  float* best;           // [D] in: +inf
  int* age;              // [D] in: 0
  int* done;             // [D] in: 0
  int* counters;         // [3] in: 0
  int* sweeps_out;       // [1]
  int* row_sweeps;       // [D] or null: sweeps each row was computed in
  int D, Vc, K;
  int inner_iterations;
  float threshold;
  float eps;
  int patience;
  int use_stall;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int KPT>
struct Layout {
  static constexpr int KP = 16 * KPT;        // padded topics
  static constexpr int ET_LD = KP + 4;       // et_s row stride
  static constexpr int E_LD = kTileV + 4;    // eeb_s row stride (bank shift)
  static constexpr int R_LD = kTileV + 4;    // ratio_s row stride
  template <typename CT>
  static constexpr size_t bytes() {
    return sizeof(float) * (kTileD * ET_LD + 2 * KP * E_LD + kTileD * R_LD) +
           sizeof(CT) * 2 * kTileD * kTileV;
  }
};

// Stage chunk c of E (rows < K) and of the tile's counts into buffer buf.
template <typename CT, int KPT>
__device__ void stage(const Params& p, float* eeb_s, CT* cnt_s, int buf,
                      int row0, int c) {
  using L = Layout<KPT>;
  const int v0 = c * kTileV;
  float* de = eeb_s + buf * L::KP * L::E_LD;
  for (int i = threadIdx.x; i < p.K * (kTileV / 4); i += kThreads) {
    const int k = i / (kTileV / 4), q = i % (kTileV / 4);
    __pipeline_memcpy_async(de + k * L::E_LD + 4 * q,
                            p.eeb + (size_t)k * p.Vc + v0 + 4 * q, 16);
  }
  constexpr int kPer = 16 / sizeof(CT);     // counts a 16-byte copy
  constexpr int kCopies = kTileV / kPer;    // copies a row
  CT* dc = cnt_s + buf * kTileD * kTileV;
  const CT* counts = static_cast<const CT*>(p.counts);
  for (int i = threadIdx.x; i < kTileD * kCopies; i += kThreads) {
    const int r = i / kCopies, q = i % kCopies;
    // Rows past D copy row D-1; the tile never uses them.
    const int d = min(row0 + r, p.D - 1);
    __pipeline_memcpy_async(dc + r * kTileV + kPer * q,
                            counts + (size_t)d * p.Vc + v0 + kPer * q, 16);
  }
  __pipeline_commit();
}

template <typename CT, int KPT>
__global__ void __launch_bounds__(kThreads, 1)
dense_gamma_kernel(Params p) {
  using L = Layout<KPT>;
  extern __shared__ __align__(16) float smem[];
  float* et_s = smem;                               // [kTileD][ET_LD]
  float* eeb_s = et_s + kTileD * L::ET_LD;          // [2][KP][E_LD]
  float* ratio_s = eeb_s + 2 * L::KP * L::E_LD;     // [kTileD][R_LD]
  CT* cnt_s = reinterpret_cast<CT*>(ratio_s + kTileD * L::R_LD);  // [2][kTileD][kTileV]
  __shared__ int live_s[kTileD];

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int K = p.K, k4 = (K + 3) & ~3;
  const int n_tiles = (p.D + kTileD - 1) / kTileD;
  const int n_chunks = p.Vc / kTileV;
  const bool freeze = p.threshold > 0.f;

  // Topic rows K..KP-1 of both E buffers stay zero for the whole launch.
  for (int i = tid; i < 2 * L::KP * L::E_LD; i += kThreads) eeb_s[i] = 0.f;

  for (int s = 0;; ++s) {
    int not_exitable = 0;  // kept by the tx == 0 threads
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int row0 = tile * kTileD;
      int live = 0;
      if (tid < kTileD) {
        const int d = row0 + tid;
        live = d < p.D && !(freeze && p.done[d]);
        live_s[tid] = live;
      }
      // Also the barrier after the previous tile's use of the buffers.
      if (!__syncthreads_or(live)) continue;

      stage<CT, KPT>(p, eeb_s, cnt_s, 0, row0, 0);
      for (int i = tid; i < kTileD * L::KP; i += kThreads) {
        const int r = i / L::KP, k = i % L::KP;
        const int d = row0 + r;
        et_s[r * L::ET_LD + k] =
            (k < K && d < p.D) ? p.et[(size_t)d * K + k] : 0.f;
      }
      float acc[2][KPT];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) acc[i][j] = 0.f;

      for (int c = 0; c < n_chunks; ++c) {
        const int buf = c & 1;
        if (c + 1 < n_chunks) {
          stage<CT, KPT>(p, eeb_s, cnt_s, buf ^ 1, row0, c + 1);
          __pipeline_wait_prior(1);
        } else {
          __pipeline_wait_prior(0);
        }
        __syncthreads();  // chunk c and et_s are visible to every thread
        const float* eb = eeb_s + buf * L::KP * L::E_LD;
        const CT* cb = cnt_s + buf * kTileD * kTileV;

        // phinorm for rows 2ty, 2ty+1 and columns 4tx .. 4tx+3.
        float ph[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) ph[i][q] = 0.f;
        const float* a_row = et_s + (2 * ty) * L::ET_LD;
        for (int k = 0; k < k4; k += 4) {
          const float4 a0 = lds4(a_row + k);
          const float4 a1 = lds4(a_row + L::ET_LD + k);
          const float4 b0 = lds4(eb + (k + 0) * L::E_LD + 4 * tx);
          const float4 b1 = lds4(eb + (k + 1) * L::E_LD + 4 * tx);
          const float4 b2 = lds4(eb + (k + 2) * L::E_LD + 4 * tx);
          const float4 b3 = lds4(eb + (k + 3) * L::E_LD + 4 * tx);
          const float av[2][4] = {{a0.x, a0.y, a0.z, a0.w},
                                  {a1.x, a1.y, a1.z, a1.w}};
          const float bv[4][4] = {{b0.x, b0.y, b0.z, b0.w},
                                  {b1.x, b1.y, b1.z, b1.w},
                                  {b2.x, b2.y, b2.z, b2.w},
                                  {b3.x, b3.y, b3.z, b3.w}};
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              float v = ph[i][q];
#pragma unroll
              for (int m = 0; m < 4; ++m) v = fmaf(av[i][m], bv[m][q], v);
              ph[i][q] = v;
            }
        }
        // ratio = C / phinorm (0 where C is 0: padding columns stay inert
        // even at eps = 0).
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 2 * ty + i;
          float rt[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float cv = to_float(cb[r * kTileV + 4 * tx + q]);
            rt[q] = cv != 0.f ? cv / (ph[i][q] + p.eps) : 0.f;
          }
          *reinterpret_cast<float4*>(ratio_s + r * L::R_LD + 4 * tx) =
              make_float4(rt[0], rt[1], rt[2], rt[3]);
        }
        __syncthreads();

        // acc[i][j] += sum_v ratio[2ty + i, v] * E[tx + 16 j, v]
        const float* r_row = ratio_s + (2 * ty) * L::R_LD;
#pragma unroll 2
        for (int v = 0; v < kTileV; v += 4) {
          const float4 r0 = lds4(r_row + v);
          const float4 r1 = lds4(r_row + L::R_LD + v);
#pragma unroll
          for (int j = 0; j < KPT; ++j) {
            const float4 b = lds4(eb + (tx + 16 * j) * L::E_LD + v);
            acc[0][j] = fmaf(r0.w, b.w, fmaf(r0.z, b.z,
                        fmaf(r0.y, b.y, fmaf(r0.x, b.x, acc[0][j]))));
            acc[1][j] = fmaf(r1.w, b.w, fmaf(r1.z, b.z,
                        fmaf(r1.y, b.y, fmaf(r1.x, b.x, acc[1][j]))));
          }
        }
        __syncthreads();  // ratio_s and buffer buf are rewritten next
      }

      // gamma' = alpha + expEtheta * acc for rows 2ty + i, topics tx + 16 j.
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 2 * ty + i, d = row0 + r;
        const bool row_live = live_s[r] != 0;
        float x[KPT];
        float dabs = 0.f, sum = 0.f;
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          const int k = tx + 16 * j;
          x[j] = 0.f;
          if (row_live && k < K) {
            x[j] = p.alpha[k] + et_s[r * L::ET_LD + k] * acc[i][j];
            dabs += fabsf(x[j] - p.gamma[(size_t)d * K + k]);
            sum += x[j];
          }
        }
        // The 16 threads of a row are one half warp.
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          dabs += __shfl_xor_sync(kFull, dabs, off);
          sum += __shfl_xor_sync(kFull, sum, off);
        }
        if (!row_live) continue;
        const float row_term = psi_row_term(sum);
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          const int k = tx + 16 * j;
          if (k < K) {
            p.gamma[(size_t)d * K + k] = x[j];
            p.et[(size_t)d * K + k] =
                (x[j] + 2.0f) * expf(psi_tail(x[j]) - row_term);
          }
        }
        if (tx == 0) {
          const float change = dabs / (float)K;
          const float best = p.best[d];
          const bool improved = change < 0.99f * best;
          const int age = improved ? 0 : p.age[d] + 1;
          const float best_new = fminf(best, change);
          const bool done = freeze && best_new <= p.threshold;
          const bool exitable = done || (p.use_stall && age >= p.patience);
          p.best[d] = best_new;
          p.age[d] = age;
          p.done[d] = done ? 1 : 0;
          not_exitable += exitable ? 0 : 1;
          if (p.row_sweeps) ++p.row_sweeps[d];
        }
      }
      __syncthreads();  // the next tile rewrites live_s and et_s
    }
    if (not_exitable) atomicAdd(&p.counters[s % 3], not_exitable);
    grid.sync();
    const int remaining = *((volatile int*)&p.counters[s % 3]);
    if (remaining == 0 || s + 1 >= p.inner_iterations) {
      if (blockIdx.x == 0 && tid == 0) *p.sweeps_out = s + 1;
      break;
    }
    // c[(s+2)%3] was last read after the previous sync; it is next added
    // to after the following one.
    if (blockIdx.x == 0 && tid == 0) p.counters[(s + 2) % 3] = 0;
  }
}

template <typename CT, int KPT>
cudaError_t launch(Params& p, cudaStream_t stream) {
  auto kern = dense_gamma_kernel<CT, KPT>;
  const size_t smem = Layout<KPT>::template bytes<CT>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int tiles = (p.D + kTileD - 1) / kTileD;
  int grid = per_sm * sms;
  if (tiles < grid) grid = tiles;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename CT>
cudaError_t dispatch_k(Params& p, cudaStream_t s) {
  if (p.K <= 16) return launch<CT, 1>(p, s);
  if (p.K <= 32) return launch<CT, 2>(p, s);
  if (p.K <= 64) return launch<CT, 4>(p, s);
  if (p.K <= 128) return launch<CT, 8>(p, s);
  if (p.K <= 256) return launch<CT, 16>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// counts: [D, Vc] bf16 (counts_bf16 != 0) or f32, Vc a multiple of 64,
// 16-byte aligned; eeb: [K, Vc] f32, 16-byte aligned, zero columns past V;
// row_sweeps: [D] int32 or null, added to; the rest as in Params.  All
// row-major and contiguous, D >= 1, K <= 256.
// Returns the cudaError_t of the launch.
int pylda_dense_gamma(const void* counts, int counts_bf16, const void* eeb,
                      const void* alpha, void* gamma, void* et, void* best,
                      void* age, void* done, void* counters, void* sweeps_out,
                      void* row_sweeps, int D, int Vc, int K,
                      int inner_iterations, float threshold, float eps,
                      int patience, int use_stall, void* stream) {
  Params p;
  p.counts = counts;
  p.eeb = static_cast<const float*>(eeb);
  p.alpha = static_cast<const float*>(alpha);
  p.gamma = static_cast<float*>(gamma);
  p.et = static_cast<float*>(et);
  p.best = static_cast<float*>(best);
  p.age = static_cast<int*>(age);
  p.done = static_cast<int*>(done);
  p.counters = static_cast<int*>(counters);
  p.sweeps_out = static_cast<int*>(sweeps_out);
  p.row_sweeps = static_cast<int*>(row_sweeps);
  p.D = D;
  p.Vc = Vc;
  p.K = K;
  p.inner_iterations = inner_iterations;
  p.threshold = threshold;
  p.eps = eps;
  p.patience = patience;
  p.use_stall = use_stall;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || K < 1 || inner_iterations < 1 || Vc < kTileV ||
      Vc % kTileV)
    return (int)cudaErrorInvalidValue;
  if (counts_bf16) return (int)dispatch_k<__nv_bfloat16>(p, s);
  return (int)dispatch_k<float>(p, s);
}

}  // extern "C"
