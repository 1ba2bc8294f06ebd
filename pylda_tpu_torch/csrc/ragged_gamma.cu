// Ragged-layout gamma fixed point of the VB E-step (sm_90a).
//
// Replaces pylda_tpu/ops/pallas_ragged.py::pallas_estep_ragged_gamma
// (kernel body _ragged_tile_kernel), with the semantics of the JAX main
// path's default, pylda_tpu/ops/estep.py::estep_ragged_gamma: for one
// bucket of rows (ids, cnts [D, T]) and B[d, t, :] = expElogbeta^T[ids[d, t]]
//
//   phinorm[d, t] = sum_k B[d, t, k] * expEtheta[d, k] + eps
//   gamma'[d, k]  = alpha[k] + expEtheta[d, k] * sum_t B[d, t, k] * cnt[d, t] / phinorm[d, t]
//   expEtheta     = exp(psi(gamma') - psi(sum gamma'))   (2-shift fast series)
//
// with the per-row exit rule of _exit_update: change = mean_k |dgamma|,
// improved = change < 0.99 * best, a sticky `done` (best <= threshold) that
// freezes the row, a non-sticky stall (age >= patience), and a loop that
// ends only when EVERY row of the bucket, padding rows included, is done
// or stalled — or at inner_iterations.  threshold == 0 runs exactly
// inner_iterations sweeps with no freezing.  The initial expEtheta uses
// the exact digamma, which CUDA's math library lacks: the wrapper computes
// it with torch.special.digamma and passes it in (et, updated in place).
//
// Bound on an H100 SXM at the flagship (4 buckets, 531,456 token slots,
// K=100): 4*K FLOP a slot a sweep = 212.6 MFLOP a sweep, ~3.2 us at the
// 67 TFLOP/s f32 rate; the inputs read once are ~11.5 MB (~3.4 us at
// 3.35 TB/s).  So the bound is ~S x 3.2 us for S sweeps.  What the kernel
// meets instead is the gather: each live slot pulls a 400-byte B row from
// L2 every sweep (212 MB a sweep at the flagship), so large buckets run at
// the L2's gather throughput and small ones at a row's latency.
//
// Design.  The exit is global to the bucket: rows cannot leave the loop
// on their own without changing the results (a sticky-stall variant cost
// 2% ELBO in the JAX package).  So the whole loop runs in ONE cooperative
// launch: the grid is sized to what fits on the card at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), blocks loop over
// rows, each row belongs to one block for the whole launch (its gamma,
// expEtheta, best, age and done stay that block's), and after each sweep
// the blocks add their count of rows that are not exitable to a device
// counter and the grid meets at this_grid().sync().  Every thread then
// reads the same counter and takes the same exit decision.  The counters
// are triple-buffered (sweep s adds to c[s%3], block 0 clears c[(s+2)%3]
// after the sync), so no host sync happens inside the loop and the sweep
// count stays on the device.
//
// Mapping: one row per block of 8 warps.  The row's token slots are cut
// into chunks of 16 and chunk c goes to warp c % 8, so a row costs about
// ceil(chunks / 8) chunk-times: a chunk is a few dependent trips to L2
// (~2.4 us on an H100), and with one warp a row, a 160-wide row cost
// ~25 us a sweep whatever the bucket's size.  Per chunk, inside a warp
// (padded slots with cnt == 0 are inert, as in the JAX form, and a chunk
// with none live is skipped):
//   0. the B rows of the chunk's slots (up to the last live one) are
//      staged into the warp's shared-memory buffer by 16-byte cp.async
//      copies, lanes along each row (coalesced; all of a chunk's copies in
//      flight at once), from eebT = expElogbeta^T ([V, ldb], ldb = K
//      rounded up to 4, zero columns; 4 MB at the flagship, shared by all
//      buckets and resident in the 50 MB L2);
//   1. lanes over SLOTS: phinorm of each slot against the row's expEtheta
//      (shared memory), four independent FMA chains, ratio = cnt/phinorm;
//   2. lanes over TOPICS (KPL = 4 topics a lane for K <= 128, 8 for
//      K <= 256): acc[k] += B[t, k] * ratio[t], reading B and the ratios
//      from shared memory.
// The 8 warps' partial sums meet in shared memory and are added in a
// fixed order; then a thread per topic forms gamma', the row's change and
// the new expEtheta.  B is read from L2 once a sweep and the [D, T, K]
// block is never materialised.  Frozen (done) rows are skipped: their
// gamma and expEtheta no longer change.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "exp_psi.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps a block; one row a block at a time
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 16;  // token slots a warp stages at a time

// Floats a warp owns for its chunk: B rows [kChunk, ldb], ratios, ids.
__host__ __device__ inline int chunk_floats(int ldb) {
  return kChunk * ldb + 2 * kChunk;
}

// Floats of dynamic shared memory a block needs: the row's expEtheta
// [ldb], the warps' partial sums [kWarps, ldb], each warp's chunk buffer,
// and 2 * kWarps for block reductions.
__host__ __device__ inline int block_smem_floats(int ldb) {
  return ldb + kWarps * ldb + kWarps * chunk_floats(ldb) + 2 * kWarps;
}

struct Params {
  const int* ids;        // [D, T]
  const float* cnts;     // [D, T]
  const float* alpha;    // [K]
  const float* eebT;     // [V, ldb], zero columns past K
  float* gamma;          // [D, K] in: gamma0, out: gamma
  float* et;             // [D, K] in: exact expEtheta(gamma0); scratch
  float* best;           // [D] in: +inf
  int* age;              // [D] in: 0
  int* done;             // [D] in: 0
  int* counters;         // [3] in: 0
  int* sweeps_out;       // [1]
  unsigned long long* slots_out;  // [1] in: 0; real slots processed
  int D, T, K, ldb;
  int inner_iterations;
  float threshold;
  float eps;
  int patience;
  int use_stall;
};

// One warp's share of a row's sweep: chunks warp, warp + 8, ...;
// accumulates sum_t B[t, k] * ratio[t] into acc (lanes over k).
template <int KPL>
__device__ void warp_chunks(const Params& p, int row, int warp, int lane,
                            const float* et_s, float* ws, float (&acc)[KPL],
                            unsigned long long* slots) {
  const int T = p.T, ldb = p.ldb, q_row = ldb / 4, K = p.K;
  float* bs = ws;                        // [kChunk, ldb]
  float* ratio_s = bs + kChunk * ldb;    // [kChunk]
  int* ids_s = reinterpret_cast<int*>(ratio_s + kChunk);  // [kChunk]
  const int* ids = p.ids + (size_t)row * T;
  const float* cnts = p.cnts + (size_t)row * T;
  const float4* e4 = reinterpret_cast<const float4*>(et_s);
  for (int t0 = warp * kChunk; t0 < T; t0 += kWarps * kChunk) {
    const int t = t0 + lane;
    const bool mine = lane < kChunk && t < T;
    const int id = mine ? __ldg(&ids[t]) : 0;
    const float c = mine ? __ldg(&cnts[t]) : 0.f;
    const unsigned live = __ballot_sync(kFull, c != 0.f);
    if (!live) continue;
    *slots += __popc(live);
    const int n = 32 - __clz(live);  // slots [0, n) hold every live one
    if (lane < kChunk) ids_s[lane] = id;
    __syncwarp();
    // 0. stage the chunk's B rows: lanes along each row, 16 bytes each.
    for (int i = lane; i < n * q_row; i += 32) {
      const int s = i / q_row, q = i - s * q_row;
      __pipeline_memcpy_async(bs + s * ldb + 4 * q,
                              p.eebT + (size_t)ids_s[s] * ldb + 4 * q, 16);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
    // 1. lanes over slots: ratio = cnt / phinorm (0 for dead slots).
    if (lane < n) {
      const float4* b4 = reinterpret_cast<const float4*>(bs + lane * ldb);
      float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
#pragma unroll 5
      for (int q = 0; q < q_row; ++q) {
        const float4 b = b4[q];
        const float4 e = e4[q];
        p0 = fmaf(b.x, e.x, p0);
        p1 = fmaf(b.y, e.y, p1);
        p2 = fmaf(b.z, e.z, p2);
        p3 = fmaf(b.w, e.w, p3);
      }
      ratio_s[lane] = c / (((p0 + p1) + (p2 + p3)) + p.eps);
    }
    __syncwarp();
    // 2. lanes over topics: acc += B[t, :] * ratio[t].
#pragma unroll 4
    for (int s = 0; s < n; ++s) {
      const float r = ratio_s[s];
      const float* b = bs + s * ldb;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int k = lane + 32 * j;
        if (k < K) acc[j] = fmaf(b[k], r, acc[j]);
      }
    }
    __syncwarp();  // the next chunk overwrites bs, ratio_s and ids_s
  }
}

// Sum of a and b over the block (fixed order; every thread gets both).
__device__ float2 block_sum2(float a, float b, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(kFull, a, off);
    b += __shfl_xor_sync(kFull, b, off);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    scratch[warp] = a;
    scratch[kWarps + warp] = b;
  }
  __syncthreads();
  float2 out = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    out.x += scratch[w];
    out.y += scratch[kWarps + w];
  }
  return out;
}

// K <= 128 fits 4 blocks an SM in shared memory: ask for registers to match.
template <int KPL>
__global__ void __launch_bounds__(kThreads, KPL == 4 ? 4 : 1)
ragged_gamma_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int K = p.K, ldb = p.ldb, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  float* et_s = smem;                       // [ldb]
  float* red_s = et_s + ldb;                // [kWarps, ldb]
  float* ws = red_s + kWarps * ldb + warp * chunk_floats(ldb);
  float* scratch = red_s + kWarps * ldb + kWarps * chunk_floats(ldb);
  const bool freeze = p.threshold > 0.f;
  unsigned long long slots = 0;

  for (int s = 0;; ++s) {
    int not_exitable = 0;  // kept by thread 0
    for (int row = blockIdx.x; row < p.D; row += gridDim.x) {
      if (freeze && p.done[row]) continue;  // frozen: nothing changes
      const size_t base = (size_t)row * K;
      for (int k = tid; k < ldb; k += kThreads)
        et_s[k] = k < K ? p.et[base + k] : 0.f;
      __syncthreads();
      float acc[KPL];
#pragma unroll
      for (int j = 0; j < KPL; ++j) acc[j] = 0.f;
      warp_chunks<KPL>(p, row, warp, lane, et_s, ws, acc, &slots);
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int k = lane + 32 * j;
        if (k < ldb) red_s[warp * ldb + k] = acc[j];
      }
      __syncthreads();
      // gamma' = alpha + et * acc, one thread a topic (K <= kThreads).
      float x = 0.f, dabs = 0.f;
      if (tid < K) {
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) a += red_s[w * ldb + tid];
        x = p.alpha[tid] + et_s[tid] * a;
        dabs = fabsf(x - p.gamma[base + tid]);
      }
      const float2 sums = block_sum2(dabs, x, scratch);
      // expEtheta of the new gamma (fast series; the per-row log is O(1)).
      if (tid < K) {
        const float row_term = psi_row_term(sums.y);
        p.gamma[base + tid] = x;
        p.et[base + tid] = (x + 2.0f) * expf(psi_tail(x) - row_term);
      }
      if (tid == 0) {
        const float change = sums.x / (float)K;
        const float best = p.best[row];
        const bool improved = change < 0.99f * best;
        const int age = improved ? 0 : p.age[row] + 1;
        const float best_new = fminf(best, change);
        const bool done = freeze && best_new <= p.threshold;
        const bool exitable = done || (p.use_stall && age >= p.patience);
        p.best[row] = best_new;
        p.age[row] = age;
        p.done[row] = done ? 1 : 0;
        not_exitable += exitable ? 0 : 1;
      }
      __syncthreads();  // the next row reuses et_s, red_s and scratch
    }
    if (tid == 0 && not_exitable) atomicAdd(&p.counters[s % 3], not_exitable);
    grid.sync();
    const int remaining = *((volatile int*)&p.counters[s % 3]);
    if (remaining == 0 || s + 1 >= p.inner_iterations) {
      if (blockIdx.x == 0 && tid == 0) *p.sweeps_out = s + 1;
      break;
    }
    // c[(s+2)%3] was last read after the previous sync; it is next
    // added to after the following one.
    if (blockIdx.x == 0 && tid == 0) p.counters[(s + 2) % 3] = 0;
  }
  if (lane == 0 && slots) atomicAdd(p.slots_out, slots);
}

template <int KPL>
cudaError_t launch(Params& p, cudaStream_t stream) {
  auto kern = ragged_gamma_kernel<KPL>;
  const size_t smem = sizeof(float) * (size_t)block_smem_floats(p.ldb);
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
  int grid = per_sm * sms;
  if (p.D < grid) grid = p.D;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous row-major tensors (see
// Params); eebT is [V, ldb] with ldb = K rounded up to a multiple of 4 and
// 16-byte aligned rows.  D >= 1.  Returns the cudaError_t of the launch.
int pylda_ragged_gamma(const void* ids, const void* cnts, const void* alpha,
                       const void* eebT, void* gamma, void* et, void* best,
                       void* age, void* done, void* counters,
                       void* sweeps_out, void* slots_out, int D, int T, int K,
                       int ldb, int inner_iterations, float threshold,
                       float eps, int patience, int use_stall, void* stream) {
  Params p;
  p.ids = static_cast<const int*>(ids);
  p.cnts = static_cast<const float*>(cnts);
  p.alpha = static_cast<const float*>(alpha);
  p.eebT = static_cast<const float*>(eebT);
  p.gamma = static_cast<float*>(gamma);
  p.et = static_cast<float*>(et);
  p.best = static_cast<float*>(best);
  p.age = static_cast<int*>(age);
  p.done = static_cast<int*>(done);
  p.counters = static_cast<int*>(counters);
  p.sweeps_out = static_cast<int*>(sweeps_out);
  p.slots_out = static_cast<unsigned long long*>(slots_out);
  p.D = D;
  p.T = T;
  p.K = K;
  p.ldb = ldb;
  p.inner_iterations = inner_iterations;
  p.threshold = threshold;
  p.eps = eps;
  p.patience = patience;
  p.use_stall = use_stall;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || inner_iterations < 1 || ldb < K || ldb % 4)
    return (int)cudaErrorInvalidValue;
  // A block needs 56 KB of shared memory at K = 100 (4 blocks an SM) and
  // 141 KB at K = 256.
  if (K <= 128) return (int)launch<4>(p, s);
  if (K <= 256) return (int)launch<8>(p, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
