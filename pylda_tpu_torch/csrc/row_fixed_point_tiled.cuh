// The gamma fixed point above kMaxTopics = 4096 topics (sm_90a): the tiled
// kernel of both entries, ragged_gamma.cu and dense_gamma.cu, which take it
// when K > kMaxTopics.  The function, the exit rule, the row-major order
// (phase 1, S*, the phase-2 re-run of rows past S*) and the outputs are
// row_fixed_point.cuh's; only where a row's state lives and how a sweep
// walks the topics differ.
//
// State.  At K = 8192 a row's expEtheta, gamma' and step B's sums would
// take 96 KB of shared memory before the first slot, at 16384 twice that,
// so no topic-sized array is kept there.  A block keeps its row's expEtheta
// (et), its bf16-rounded copy (etr, bf16 builds), gamma (gam) and the
// ratios of its live entries in its own scratch in device memory (state:
// 3 kp + L floats a block, kp = K rounded up to 8; from L1 and L2), and its
// live entries' (id, count) list in its scratch list (lists), written once
// a row by the compaction.  Nothing caps K but the scratch's bytes.
//
// A sweep, for the row's n live entries t with B[t] = table[id_t]:
//   A. warp w takes the entries t = w, w + 8, ..: its lanes read B[t] as
//      16-byte units (4 f32 or 8 bf16 topics) at units lane, lane + 32, ..
//      and expEtheta beside them, each lane sums its units in order, a
//      butterfly sums the lanes (every lane gets the same bits), and lane 0
//      forms ratio[t] = cnt[t] / (phinorm + eps) (bf16: B and expEtheta
//      read rounded, the ratio rounded where it is stored);
//   B. the topics in tiles of kTileTopics = 4096: thread tid owns the
//      float4s q = q0 + tid + 256 j (j < 4) of the tile and adds
//      ratio[t] * B[t, 4q..4q+3] over t = 0, 1, .. (entries staged in
//      shared memory in windows of kTiledWindow);
//   C. after each tile: gamma'[k] = alpha[k] + expEtheta[k] * acc, |dgamma|
//      and gamma' summed by the thread in tile, j, topic order;
//   after the last tile the block sums them (block_sum2: a fixed order)
//   and the new expEtheta is formed from gam.  So two calls give the same
//   bits.
// B[t] is read from the table twice a sweep (A and B).  What bounds it: at
// V = 100k the [V, K] table does not fit the L2 (3.28 GB at K = 8192), so
// those reads come from device memory, 8 K bytes an entry a sweep (f32),
// against 4 K FLOP: bytes, about 8x the arithmetic's time at 67 TFLOP/s.
// A cluster that splits K over CTAs (ROADMAP Queue 2 item 5) is the
// redesign that keeps B on chip.

#pragma once

#include "row_fixed_point.cuh"

namespace {

// Topics a step-B tile: kTileQ float4 sums a thread.
constexpr int kTileTopics = 4096;
constexpr int kTileQ = kTileTopics / 4 / kThreads;
// Live entries a step-B window stages in shared memory.
constexpr int kTiledWindow = 512;

// K rounded up to 8: the length of et, etr and gam in a block's state.
__host__ __device__ __forceinline__ int tiled_kp(int K) {
  return (K + 7) & ~7;
}

// Floats of a block's state: et, etr, gam, then L ratios (rounded up to 4).
__host__ __device__ __forceinline__ size_t tiled_state_floats(int K, int L) {
  return 3 * (size_t)tiled_kp(K) + (size_t)((L + 3) & ~3);
}

// The tiled kernel's shared memory, in 4-byte words: the scan, the block
// sums, the flags, the not-exitable histogram and a window of entries.
struct TiledLayout {
  int scan, red, flags, win_ids, win_ratio, hist, total;
  __host__ __device__ explicit TiledLayout(int nhist) {
    scan = 0;
    red = scan + kWarps;
    flags = red + 2 * kWarps;
    win_ids = flags + 4;
    win_ratio = win_ids + kTiledWindow;
    hist = win_ratio + kTiledWindow;
    total = hist + ((nhist + 3) & ~3);
  }
};

// Compacts the live entries of `row`, in order, into the block's list
// (lists: L ids, then L counts); returns how many there are.
template <typename CT>
__device__ __forceinline__ int compact_to_list(const Params& p, int* scan_s,
                                               int row) {
  const int per = (p.L + kThreads - 1) / kThreads;
  const int j0 = min((int)threadIdx.x * per, p.L);
  const int j1 = min(j0 + per, p.L);
  const CT* c = static_cast<const CT*>(p.cnts) + (size_t)row * p.ld;
  int mine = 0;
  for (int j = j0; j < j1; ++j) mine += to_float(c[j]) != 0.f;
  int total;
  int pos = block_excl_scan(mine, scan_s, &total);
  int* ids_out = block_list(p);
  float* cnt_out = reinterpret_cast<float*>(ids_out + p.L);
  if (mine) {
    for (int j = j0; j < j1; ++j) {
      const float v = to_float(c[j]);
      if (v != 0.f) {
        cnt_out[pos] = v;
        ids_out[pos] = p.ids ? p.ids[(size_t)row * p.ld + j] : j;
        ++pos;
      }
    }
  }
  __syncthreads();  // the list's writes are visible to the block
  return total;
}

// Step A: ratio[t] for the n entries of the block's list (module note).
// e: expEtheta as phinorm reads it (etr in the bf16 builds), zero past K.
template <bool kBf16>
__device__ __forceinline__ void tiled_ratios(const Params& p, const float* e,
                                             float* ratio, int n) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int* ids_g = block_list(p);
  const float* cnt_g = reinterpret_cast<const float*>(ids_g + p.L);
  const float4* e4 = reinterpret_cast<const float4*>(e);
  for (int t = warp; t < n; t += kWarps) {
    const size_t id = (size_t)ids_g[t];
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    if constexpr (kBf16) {
      const uint4* b8 = reinterpret_cast<const uint4*>(
          static_cast<const __nv_bfloat16*>(p.table) + id * p.ldb);
      const int units = p.ldb / 8;
#pragma unroll 4
      for (int q = lane; q < units; q += 32) {
        const uint4 b = __ldg(b8 + q);
        const float4 x = e4[2 * q], y = e4[2 * q + 1];
        a0 = fmaf(bf16_lo(b.x), x.x, a0);
        a1 = fmaf(bf16_hi(b.x), x.y, a1);
        a2 = fmaf(bf16_lo(b.y), x.z, a2);
        a3 = fmaf(bf16_hi(b.y), x.w, a3);
        a0 = fmaf(bf16_lo(b.z), y.x, a0);
        a1 = fmaf(bf16_hi(b.z), y.y, a1);
        a2 = fmaf(bf16_lo(b.w), y.z, a2);
        a3 = fmaf(bf16_hi(b.w), y.w, a3);
      }
    } else {
      const float4* b4 = reinterpret_cast<const float4*>(
          static_cast<const float*>(p.table) + id * p.ldb);
      const int units = p.ldb / 4;
#pragma unroll 4
      for (int q = lane; q < units; q += 32) {
        const float4 b = __ldg(b4 + q), x = e4[q];
        a0 = fmaf(b.x, x.x, a0);
        a1 = fmaf(b.y, x.y, a1);
        a2 = fmaf(b.z, x.z, a2);
        a3 = fmaf(b.w, x.w, a3);
      }
    }
    float ph = (a0 + a1) + (a2 + a3);
    // a + b == b + a: every lane gets the same bits.
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ph += __shfl_xor_sync(kFull, ph, off);
    if (lane == 0) {
      const float r = cnt_g[t] / (ph + p.eps);
      ratio[t] = kBf16 ? bf16_round(r) : r;
    }
  }
  __syncthreads();  // the ratios are visible to the block
}

// Topics 4q..4q+3 of the table's row id, as f32.
template <bool kBf16>
__device__ __forceinline__ float4 table4(const Params& p, size_t id, int q) {
  if constexpr (kBf16) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(p.table) + id * p.ldb) + q);
    return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y),
                       bf16_hi(u.y));
  } else {
    return __ldg(reinterpret_cast<const float4*>(
        static_cast<const float*>(p.table) + id * p.ldb) + q);
  }
}

// Runs `row` from gamma0 for at most max_sweeps sweeps, stopping when it
// is done; writes its gamma.  The exit state is run_row's: every thread
// keeps it, from block sums that are the same in every thread.
template <typename CT, bool kBf16>
__device__ __forceinline__ RowRun run_row_tiled(const Params& p,
                                                const TiledLayout& TL,
                                                float* smem, int row,
                                                int max_sweeps, bool count) {
  const int tid = threadIdx.x, K = p.K, kp = tiled_kp(K);
  float* et = p.state + (size_t)blockIdx.x * tiled_state_floats(K, p.L);
  float* etr = et + kp;
  float* gam = etr + kp;
  float* ratio = gam + kp;
  int* hist_s = reinterpret_cast<int*>(smem + TL.hist);
  int* win_ids = reinterpret_cast<int*>(smem + TL.win_ids);
  float* win_ratio = smem + TL.win_ratio;
  const size_t base = (size_t)row * K;
  for (int k = tid; k < kp; k += kThreads) {
    const float e0 = k < K ? p.et0[base + k] : 0.f;
    et[k] = e0;
    if constexpr (kBf16) etr[k] = bf16_round(e0);
    gam[k] = k < K ? p.gamma0[base + k] : 0.f;
  }
  // Also the barrier after the state's first writes.
  const int n = compact_to_list<CT>(p, reinterpret_cast<int*>(smem + TL.scan),
                                    row);
  const int* ids_g = block_list(p);
  const bool freeze = p.threshold > 0.f;
  const int k4 = (K + 3) / 4;
  float best = __int_as_float(0x7f800000);
  int age = 0, first = 0;
  int s = 0;
  while (s < max_sweeps) {
    tiled_ratios<kBf16>(p, kBf16 ? etr : et, ratio, n);
    float dabs = 0.f, sum = 0.f;
    for (int q0 = 0; q0 < k4; q0 += kThreads * kTileQ) {
      float4 acc[kTileQ];
#pragma unroll
      for (int j = 0; j < kTileQ; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int w0 = 0; w0 < n; w0 += kTiledWindow) {
        const int m = min(kTiledWindow, n - w0);
        __syncthreads();  // the window before is read
        for (int i = tid; i < m; i += kThreads) {
          win_ids[i] = ids_g[w0 + i];
          win_ratio[i] = ratio[w0 + i];
        }
        __syncthreads();
#pragma unroll 2
        for (int t = 0; t < m; ++t) {
          const size_t id = (size_t)win_ids[t];
          const float r = win_ratio[t];
#pragma unroll
          for (int j = 0; j < kTileQ; ++j) {
            const int q = q0 + tid + kThreads * j;
            if (q < k4) {
              const float4 b = table4<kBf16>(p, id, q);
              acc[j].x = fmaf(b.x, r, acc[j].x);
              acc[j].y = fmaf(b.y, r, acc[j].y);
              acc[j].z = fmaf(b.z, r, acc[j].z);
              acc[j].w = fmaf(b.w, r, acc[j].w);
            }
          }
        }
      }
      // C over this tile's topics: gamma' and the thread's partial sums.
#pragma unroll
      for (int j = 0; j < kTileQ; ++j) {
        const int q = q0 + tid + kThreads * j;
        const float a[4] = {acc[j].x, acc[j].y, acc[j].z, acc[j].w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = 4 * q + c;
          if (q < k4 && k < K) {
            const float x = __ldg(p.alpha + k) + et[k] * a[c];
            dabs += fabsf(x - gam[k]);
            sum += x;
            gam[k] = x;
          }
        }
      }
    }
    const float2 sums = block_sum2(dabs, sum, smem + TL.red);
    // The new expEtheta (a thread's topics are those it wrote in C).
    const float rterm = psi_row_term(sums.y);
    for (int q = tid; q < k4; q += kThreads) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k = 4 * q + c;
        if (k < K) {
          const float x = gam[k];
          const float e1 = (x + 2.0f) * expf(psi_tail(x) - rterm);
          et[k] = e1;
          if constexpr (kBf16) etr[k] = bf16_round(e1);
        }
      }
    }
    const float change = sums.x / (float)K;
    const bool improved = change < 0.99f * best;
    age = improved ? 0 : age + 1;
    best = fminf(best, change);
    const bool done = freeze && best <= p.threshold;
    const bool exitable = done || (p.use_stall && age >= p.patience);
    if (count && !exitable && tid == 0) {
      if (s < p.nhist) ++hist_s[s];
      else atomicAdd(&p.not_exitable[s], 1);
    }
    if (exitable && !first) first = s + 1;
    ++s;
    __syncthreads();  // et is visible to every thread
    if (done) break;
  }
  for (int k = tid; k < K; k += kThreads) p.gamma[base + k] = gam[k];
  __syncthreads();  // the next row rewrites the state
  return {s, first, n};
}

template <typename CT, bool kBf16>
__global__ void __launch_bounds__(kThreads)
row_fixed_point_tiled_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const TiledLayout TL(p.nhist);
  row_phases(p, reinterpret_cast<int*>(smem + TL.hist),
             reinterpret_cast<int*>(smem + TL.flags),
             [&](int row, int sweeps, bool count) {
               return run_row_tiled<CT, kBf16>(p, TL, smem, row, sweeps,
                                               count);
             });
}

// Launches the tiled kernel cooperatively for K > kMaxTopics: as many
// blocks as fit on the card at once, at most one a row and at most
// list_blocks (each has its scratch list and state).  Every row's entries
// go through the list (nmax 0).
template <typename CT, bool kBf16>
cudaError_t launch_row_fixed_point_tiled(Params& p, cudaStream_t stream) {
  const int unit = kBf16 ? 8 : 4;  // topics a 16-byte copy of a table row
  if (p.D < 1 || p.K <= kMaxTopics || p.inner_iterations < 1 || p.L < 0 ||
      p.L > p.ld || p.table_bf16 != (int)kBf16 ||
      p.ldb != unit * ((p.K + unit - 1) / unit) || !p.lists || !p.state ||
      p.list_blocks < 1)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  p.nhist = min(p.inner_iterations, kMaxHist);
  p.nmax = 0;
  const size_t smem = sizeof(float) * (size_t)TiledLayout(p.nhist).total;
  auto kern = row_fixed_point_tiled_kernel<CT, kBf16>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  int grid = per_sm * sms;
  if (p.D < grid) grid = p.D;
  if (p.list_blocks < grid) grid = p.list_blocks;
  p.smem_bytes = (int)smem;
  p.blocks_per_sm = per_sm;
  p.grid = grid;
  p.tile = kTileTopics;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The launch for any K: the row-resident kernels up to kMaxTopics, the
// tiled kernel above.
template <typename CT, bool kBf16>
cudaError_t launch_gamma(Params& p, bool registers, cudaStream_t stream) {
  if (p.K > kMaxTopics)
    return launch_row_fixed_point_tiled<CT, kBf16>(p, stream);
  return launch_row_fixed_point<CT, kBf16>(p, registers, stream);
}

}  // namespace
