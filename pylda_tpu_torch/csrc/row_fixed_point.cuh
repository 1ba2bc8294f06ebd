// Row-resident gamma fixed point of the VB E-step, shared by
// dense_gamma.cu and ragged_gamma.cu (sm_90a).
//
// A row is a list of entries (id, count): a ragged row's token slots
// (ids, cnts [D, ld]) or a dense row's columns (id = column, counts
// [D, ld] bf16 or f32, the first L columns used).  With the row's live
// entries (count != 0) t and B[t, :] = expElogbeta^T[id_t] gathered from
// the table [V, ldb] (ldb = K rounded up to 4, zero columns past K):
//
//   phinorm[t] = sum_k B[t, k] * expEtheta[k] + eps
//   gamma'[k]  = alpha[k] + expEtheta[k] * sum_t B[t, k] * cnt[t] / phinorm[t]
//   expEtheta  = exp(psi(gamma') - psi(sum gamma'))   (2-shift fast series)
//
// with the per-row exit rule of ops/estep.py::_exit_update: change =
// mean_k |dgamma|, improved = change < 0.99 * best, a sticky `done`
// (best <= threshold, threshold > 0) that freezes the row, a non-sticky
// stall (age >= patience).  The batch loop ends at S*, the first sweep at
// which every row is exitable, or at inner_iterations.
//
// Segments.  A launch may hold several batches of the reference back to
// back: its rows fall into segments (seg[row], nondecreasing; null: one
// segment), each a batch that the JAX engine's layout would run on its
// own (models/layouts.ragged_chunks: the chunks estep_memory_budget_mb
// cuts a bucket into).  Each segment ends at its own S*.
//
// Row-major order.  Until S* a row's trajectory depends on its own data
// only, so the kernel runs ROW AFTER ROW, all of a row's sweeps at once,
// instead of sweep after sweep over the batch:
//
//   phase 1  each row runs until it is done or at inner_iterations; each
//            sweep s at which it is not exitable adds 1 to its segment's
//            not_exitable[seg, s] (summed in shared memory a block, one
//            atomic a sweep a block when the block's rows move on to the
//            next segment and at the end of the phase: rows leave the
//            queue in order, so a block meets each segment once);
//   grid.sync(); a segment's S* = the first s + 1 with
//            not_exitable[seg, s] == 0, else inner_iterations (every
//            block reads the same counts);
//   phase 2  a row that ran past its segment's S* (it was not done by S*)
//            is run again from its initial gamma for exactly S* sweeps.
//
// So each row's output is its gamma after min(S*, its done sweep) sweeps,
// the same arithmetic as the sweep-major loop of its segment, in one
// cooperative launch with no host sync.  The row-sweeps this order
// computes beyond the sweep-major loop's (a re-run row's phase-1 sweeps)
// are reported in extra_out; they are at most (rows not done at S*) x
// inner_iterations, and zero when S* = inner_iterations.
//
// Residency.  A block of 256 threads owns one row at a time (rows are
// taken from a device queue, so rows of unequal run length balance).  It
// compacts the row's live entries in one pass over the row (a block-wide
// prefix sum keeps them in column/slot order), gathers their B rows ONCE
// into shared memory by 16-byte cp.async copies, and runs every sweep from
// there: B is read from L2 once a row instead of once a sweep.  The host
// sizes the slot buffer (nmax) to ~72 KB of shared memory a block (3-4
// blocks an SM, 2 with the register tile below).  A row with more live
// entries than nmax streams instead: its compaction writes the (id, count)
// list to the block's own scratch in global memory (lists), once a row, and
// each sweep loads that list in windows of nmax live entries and gathers
// each window's B rows from L2.  So a streamed row costs ceil(n / nmax)
// windows a sweep, never a pass over its zero counts.
//
// Per sweep (plain f32 FMAs, no TF32: the reference is plain f32):
//   A. two threads a slot, each over alternate 4-float4 runs of topics:
//      phinorm, then ratio = cnt / (phinorm + eps) into shared memory;
//   B. thread (q, g): topics 4q..4q+3, slots g, g + G, ...: acc += ratio *
//      B as a float4 in registers (across windows for a streamed row);
//   C. the G partial sums meet in shared memory in a fixed order; a thread
//      a topic forms gamma' (kept in its registers), the block sums
//      sum_k |dgamma| and sum_k gamma', the new expEtheta goes to shared
//      memory, and every thread keeps the row's best, age and done (the
//      block sums are the same in every thread).
//
// Wide rows (K > 256, up to kMaxTopics = 4096: the kWide kernels; above
// it, row_fixed_point_tiled.cuh splits a row's topics over a cluster).  A
// thread no longer owns one topic.  In step B, G = max(1, 256 / k4) slot
// groups, and thread tid owns the float4s q = tid + 256 j (j < 4) of group
// 0 when k4 > 256, so each thread keeps up to 4 float4 sums in registers.
// In step C thread tid owns topics tid, tid + 256, ..: gamma' goes to
// shared memory (gam), alpha is read from global memory, and the thread
// sums its own topics in topic order before the block sums (a fixed order:
// two calls give the same bits).  A slot holds K floats (4 KB at K=1000),
// so the buffer is sized from the shared memory of an SM: two blocks an SM
// (~113 KB each on an H100) where a slot fits, else one block with what it
// may opt into; at K=1000 that is 25 slots, and rows of more live entries
// stream (every row of an SVI config-5 minibatch), gathering each window's
// B rows from device memory every sweep, since the [V, K] table does not
// fit the L2 at V=100k.  K <= 256 keeps the narrow kernels and their bits.
// The slot buffer's row stride is an odd number of float4, so the float4
// loads of A and B meet no bank conflicts beyond the 4 wavefronts a warp's
// 512 bytes need.  What bounds a resident row: shared-memory bandwidth,
// 2 float4 reads (~5 wavefronts a warp with the broadcast operand) for
// every 8 FMAs of a slot and topic.
//
// bf16 operands (kBf16 builds: nvcc -DPYLDA_BF16=1, ops/_build.py).  The
// JAX function's bf16 mode rounds three operands to bf16 and sums in f32:
// the gathered B, expEtheta as it enters phinorm, and the ratio.  Here the
// table is bf16 [V, ldb] (ldb = K rounded up to 8) and a slot holds its B
// row as bf16 in 16-byte units of 8 topics (odd unit stride s8, the same
// conflict-free layout as the f32 float4 rows): step A reads 8 topics a
// 16-byte load, step B and the register tile 4 topics as 8 bytes, each
// widened to f32 (exact), and the FMAs stay f32 (a product of two bf16
// values is exact in f32).  Step A reads a rounded copy of expEtheta (etr,
// written wherever et is), and the ratio is rounded where it is formed;
// step C keeps the f32 expEtheta for gamma' = alpha + expEtheta * acc.  A
// slot is half the bytes (2 KB at K=1000), so the buffer holds about twice
// the entries.  The float32 builds (kBf16 false) are the code above.  At
// K <= 256 the host sends a bf16 launch whose rows fit a warp group's
// slots to the warp-group kernel of row_fixed_point_groups.cuh instead
// (both products on mma.sync); these bf16 kernels keep wider rows.
//
// Register tile.  At K <= 128 a row of up to 128 live entries moves its B
// from shared memory into registers once (warp w holds slots w, w + 8, ..,
// lane l topics 4l..4l+3: 16 float4 a thread), and A and B run from there:
// each lane's 16 partial dots are summed over the warp by a halving
// butterfly and the ratios return by shuffles, so a sweep reads B from
// shared memory not at all.  The kernels that carry the tile (ragged
// buckets of width <= 128 and the dense route at K <= 128) take up to 128
// registers a thread, 2 blocks an SM; longer rows in them take the
// shared-memory sweep above.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "exp_psi.cuh"

// The build's operand mode: 0 float32, 1 bf16 operands (-DPYLDA_BF16=1).
#ifndef PYLDA_BF16
#define PYLDA_BF16 0
#endif

namespace {

namespace cg = cooperative_groups;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Largest K of the row-resident kernels (above it the cluster kernel of
// row_fixed_point_tiled.cuh runs); the wide kernels' step-B float4 sums a
// thread (k4 <= kThreads * kWideQ).
constexpr int kMaxTopics = 4096;
constexpr int kWideQ = kMaxTopics / 4 / kThreads;
// Per-sweep not-exitable counts kept in shared memory; later sweeps go to
// the device array directly.
constexpr int kMaxHist = 256;
// Shared memory a block aims at: 3 blocks an SM (227 KB).  The wide
// kernels aim at two blocks an SM, less the 1 KB the card reserves a block.
constexpr int kBlockSmemTarget = 72 * 1024;
constexpr int kBlockSmemReserved = 1024;

// The kernel's arguments, and the whole C interface of both entries: each
// takes a pointer to a Params and a stream (ops/row_fixed_point.py mirrors
// the struct field for field).  The launcher sets nmax, nhist and the
// launch geometry after it, and the entries write them back.
struct Params {
  const int* ids;        // [D, ld] (ragged) or null (dense: id = column)
  const void* cnts;      // [D, ld] f32 or bf16 (cnts_bf16)
  const void* table;     // [V, ldb] expElogbeta^T, zero columns past K:
                         // f32 (ldb = K rounded up to 4), or bf16 in the
                         // bf16 builds (table_bf16; K rounded up to 8)
  const float* alpha;    // [K]
  const float* gamma0;   // [D, K]
  const float* et0;      // [D, K] exact expEtheta(gamma0)
  float* gamma;          // [D, K] out
  int* not_exitable;     // [nseg, inner_iterations] in: 0
  int* queues;           // [2] in: 0 (row queues of the two phases)
  int* row_run;          // [D] scratch: phase-1 sweeps of each row
  int* row_nnz;          // [D] scratch: live entries of each row
  int* sweeps_out;       // [nseg] each segment's S*
  int* row_sweeps;       // [D] or null: += min(run, S*)
  int* row_exit;         // [D] or null: first exitable sweep (1-based) or 0
  unsigned long long* slots_out;  // [1] or null: += nnz x min(run, S*)
  unsigned long long* extra_out;  // [1] or null: += row-sweeps past S*
  int* lists;            // [list_blocks, 2, L] scratch: a block's (or a
                         // cluster's) row as L ids, then L counts (f32 bits)
  const int* seg;        // [D] each row's segment, nondecreasing, or null:
                         // one segment
  float* state;          // the cluster kernel's direct plan (K past what a
                         // CTA's shared memory holds): [state_ctas] CTAs'
                         // slice state scratch; else null
  int D, ld, L, K, ldb;
  int cnts_bf16;
  int table_bf16;
  int list_blocks;
  int nmax, nhist;
  int inner_iterations;
  float threshold;
  float eps;
  int patience;
  int use_stall;
  int nseg;              // segments (1 without seg)
  // The cluster kernel's plan (K > kMaxTopics; ops/row_fixed_point.py
  // ::cluster_plan): CTAs a cluster, topics a CTA's slice, entries of a
  // row kept resident, entries a streamed window; CTAs the direct plan's
  // state holds.
  int cluster, slice, resident, window, state_ctas;
  // The bf16 warp-group kernel (row_fixed_point_groups.cuh; K <= 256):
  // live entries a group holds, a multiple of 16; 0: not that kernel.
  int group_slots;
  int smem_bytes, blocks_per_sm, grid;  // out: the launch's geometry
  int tile;              // out: topics a CTA's sweep covers (K, or the slice)
  int windows, clusters;  // out (cluster kernel): windows a sweep of the
                          // widest row, clusters in flight
};

// Offsets (in floats, each a multiple of 4) into the dynamic shared memory.
// gam (gamma of the row) is there in the wide kernels only, etr (the
// rounded expEtheta, 8 * k8 floats) in the bf16 builds only.  A slot is
// `slot` floats: s4 float4 of f32 topics, or s8 16-byte units of 8 bf16
// topics.
struct Layout {
  int k4, s4, k8, s8, slot, groups;
  int b, et, etr, gam, part, ratio, cnt, ids, hist, scan, red, flags, total;
  __host__ __device__ Layout(int K, int nmax, int nhist, bool wide,
                             bool bf16) {
    k4 = (K + 3) / 4;
    s4 = k4 | 1;  // odd float4 stride: conflict-free float4 rows
    k8 = (K + 7) / 8;
    s8 = k8 | 1;  // odd 16-byte stride: the same for bf16 rows
    slot = bf16 ? s8 * 4 : s4 * 4;
    groups = k4 < kThreads ? kThreads / k4 : 1;
    const int n4 = (nmax + 3) & ~3;
    b = 0;
    et = b + nmax * slot;
    etr = et + s4 * 4;
    gam = etr + (bf16 ? k8 * 8 : 0);
    part = gam + (wide ? s4 * 4 : 0);
    ratio = part + groups * k4 * 4;
    cnt = ratio + n4;
    ids = cnt + n4;
    hist = ids + n4;
    scan = hist + ((nhist + 3) & ~3);
    red = scan + kWarps;
    flags = red + 2 * kWarps;
    total = flags + 4;
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to bf16 (nearest even) and widened back.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The two bf16 values of a 32-bit word (lower address first) as f32.
__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Topics 4q..4q+3 of slot t of the slot buffer, as f32.
template <bool kBf16>
__device__ __forceinline__ float4 slot4(const float* b_s, const Layout& L,
                                        int t, int q) {
  if constexpr (kBf16) {
    const uint2 u = reinterpret_cast<const uint2*>(b_s)[t * (L.slot / 2) + q];
    return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y),
                       bf16_hi(u.y));
  } else {
    return reinterpret_cast<const float4*>(b_s)[t * L.s4 + q];
  }
}

// Exclusive prefix sum of v over the block; *total gets the block's sum.
__device__ __forceinline__ int block_excl_scan(int v, int* scan_s,
                                               int* total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) scan_s[warp] = x;
  __syncthreads();
  int pre = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = scan_s[w];
    pre += w < warp ? t : 0;
    tot += t;
  }
  __syncthreads();  // scan_s is rewritten by the next call
  *total = tot;
  return pre + x - v;
}

// Sum of a and b over the block (fixed order; every thread gets both).
__device__ __forceinline__ float2 block_sum2(float a, float b,
                                             float* red_s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(kFull, a, off);
    b += __shfl_xor_sync(kFull, b, off);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red_s[warp] = a;
    red_s[kWarps + warp] = b;
  }
  __syncthreads();
  float2 out = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    out.x += red_s[w];
    out.y += red_s[kWarps + w];
  }
  return out;
}

// The block's scratch list in global memory: L ids, then L counts.
__device__ __forceinline__ int* block_list(const Params& p) {
  return p.lists + (size_t)blockIdx.x * 2 * p.L;
}

// Compacts the live entries of `row`, in order: into cnt_s / ids_s when
// there are at most nmax of them, else into the block's list (a streamed
// row).  Returns how many there are.  Each thread reads one contiguous run
// of entries.
template <typename CT>
__device__ __forceinline__ int compact(const Params& p, const Layout& L,
                                       float* smem, int row) {
  const int per = (p.L + kThreads - 1) / kThreads;
  const int j0 = min((int)threadIdx.x * per, p.L);
  const int j1 = min(j0 + per, p.L);
  const CT* c = static_cast<const CT*>(p.cnts) + (size_t)row * p.ld;
  int mine = 0;
  for (int j = j0; j < j1; ++j) mine += to_float(c[j]) != 0.f;
  int total;
  int pos = block_excl_scan(mine, reinterpret_cast<int*>(smem + L.scan),
                            &total);
  float* cnt_out = smem + L.cnt;
  int* ids_out = reinterpret_cast<int*>(smem + L.ids);
  if (total > p.nmax) {
    ids_out = block_list(p);
    cnt_out = reinterpret_cast<float*>(ids_out + p.L);
  }
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
  __syncthreads();  // also makes the list's global writes visible
  return total;
}

// Loads live entries [w0, w0 + m) of a streamed row from the block's list
// into cnt_s / ids_s.  (No thread still reads them: step A of the window
// before ended at a barrier.)
__device__ __forceinline__ void load_window(const Params& p, const Layout& L,
                                            float* smem, int w0, int m) {
  const int* ids_g = block_list(p);
  const float* cnt_g = reinterpret_cast<const float*>(ids_g + p.L);
  int* ids_s = reinterpret_cast<int*>(smem + L.ids);
  for (int i = threadIdx.x; i < m; i += kThreads) {
    smem[L.cnt + i] = cnt_g[w0 + i];
    ids_s[i] = ids_g[w0 + i];
  }
  __syncthreads();
}

// Gathers the B rows of the n compacted entries into the slot buffer, 16
// bytes a copy (4 f32 or 8 bf16 topics).
template <bool kBf16>
__device__ __forceinline__ void gather(const Params& p, const Layout& L,
                                       float* smem, int n) {
  const int* ids_s = reinterpret_cast<const int*>(smem + L.ids);
  float* b_s = smem + L.b;
  const int units = kBf16 ? L.k8 : L.k4;
  for (int i = threadIdx.x; i < n * units; i += kThreads) {
    const int t = i / units, q = i - t * units;
    if constexpr (kBf16)
      __pipeline_memcpy_async(
          b_s + t * L.slot + 4 * q,
          static_cast<const __nv_bfloat16*>(p.table) +
              (size_t)ids_s[t] * p.ldb + 8 * q,
          16);
    else
      __pipeline_memcpy_async(
          b_s + (t * L.s4 + q) * 4,
          static_cast<const float*>(p.table) + (size_t)ids_s[t] * p.ldb +
              4 * q,
          16);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// Half h's share of slot t's phinorm dot: over the float4 runs 4h..4h+3,
// 4h+8.. (f32), so a quarter warp's 8 float4 loads hit 8 bank quads; bf16:
// the same runs of 16-byte units of 8 topics, against the rounded
// expEtheta (etr).
template <bool kBf16>
__device__ __forceinline__ float slot_dot(const Layout& L, const float* smem,
                                          int t, int h) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  if constexpr (kBf16) {
    const uint4* bt = reinterpret_cast<const uint4*>(smem + L.b) + t * L.s8;
    const float4* r4 = reinterpret_cast<const float4*>(smem + L.etr);
#pragma unroll 1
    for (int q0 = 4 * h; q0 < L.k8; q0 += 8) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = q0 + j;
        if (q < L.k8) {
          const uint4 b = bt[q];
          const float4 e = r4[2 * q], f = r4[2 * q + 1];
          a0 = fmaf(bf16_lo(b.x), e.x, a0);
          a1 = fmaf(bf16_hi(b.x), e.y, a1);
          a2 = fmaf(bf16_lo(b.y), e.z, a2);
          a3 = fmaf(bf16_hi(b.y), e.w, a3);
          a0 = fmaf(bf16_lo(b.z), f.x, a0);
          a1 = fmaf(bf16_hi(b.z), f.y, a1);
          a2 = fmaf(bf16_lo(b.w), f.z, a2);
          a3 = fmaf(bf16_hi(b.w), f.w, a3);
        }
      }
    }
  } else {
    const float4* bt = reinterpret_cast<const float4*>(smem + L.b) + t * L.s4;
    const float4* e4 = reinterpret_cast<const float4*>(smem + L.et);
#pragma unroll 1
    for (int q0 = 4 * h; q0 < L.k4; q0 += 8) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = q0 + j;
        if (q < L.k4) {
          const float4 b = bt[q], e = e4[q];
          a0 = fmaf(b.x, e.x, a0);
          a1 = fmaf(b.y, e.y, a1);
          a2 = fmaf(b.z, e.z, a2);
          a3 = fmaf(b.w, e.w, a3);
        }
      }
    }
  }
  return (a0 + a1) + (a2 + a3);
}

// Step B of a sweep over the n slots in the buffer: adds to acc[j] this
// thread's share of sum_t ratio[t] * B[t, 4q..4q+3] for its float4s q
// (kQ = 1: q = tid % k4 in group tid / k4).  The loops are kept rolled
// (kUnroll slots at a time): the kernel's code must stay small for the
// instruction cache.
template <int kQ, bool kBf16, int kUnroll = 2>
__device__ __forceinline__ void slot_sums(const Layout& L, const float* smem,
                                          int n, float4 (&acc)[kQ]) {
  const float* ratio_s = smem + L.ratio;
  const int tid = threadIdx.x, k4 = L.k4;
  // acc += ratio[t] * B[t, 4q..4q+3] for slots t = g, g + G, ...
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const int idx = tid + kThreads * j;
    const int q = idx % k4, g = idx / k4;
    if (g < L.groups) {
#pragma unroll (kUnroll)
      for (int t = g; t < n; t += L.groups) {
        const float r = ratio_s[t];
        const float4 b = slot4<kBf16>(smem + L.b, L, t, q);
        acc[j].x = fmaf(b.x, r, acc[j].x);
        acc[j].y = fmaf(b.y, r, acc[j].y);
        acc[j].z = fmaf(b.z, r, acc[j].z);
        acc[j].w = fmaf(b.w, r, acc[j].w);
      }
    }
  }
}

// Steps A and B of a sweep over the n slots in the buffer.
template <int kQ, bool kBf16>
__device__ __forceinline__ void sweep_slots(const Params& p, const Layout& L,
                                            float* smem, int n,
                                            float4 (&acc)[kQ]) {
  float* ratio_s = smem + L.ratio;
  const float* cnt_s = smem + L.cnt;
  const int tid = threadIdx.x;
  // A. phinorm and ratio: slot t0 + tid / 2, half h (slot_dot).  bf16:
  // the ratio is rounded where it is stored.
  const int h = tid & 1;
  for (int t0 = 0; t0 < n; t0 += kThreads / 2) {
    const int t = t0 + (tid >> 1);
    float ph = t < n ? slot_dot<kBf16>(L, smem, t, h) : 0.f;
    ph += __shfl_xor_sync(kFull, ph, 1);
    if (t < n && h == 0) {
      const float r = cnt_s[t] / (ph + p.eps);
      ratio_s[t] = kBf16 ? bf16_round(r) : r;
    }
  }
  __syncthreads();
  // B.
  slot_sums<kQ, kBf16>(L, smem, n, acc);
}

// Slots a warp keeps in registers: rows of up to kWarps * kRegSlots = 128
// live entries at K <= 128 (lane l holds topics 4l..4l+3).
constexpr int kRegSlots = 16;

// One step of the halving butterfly: lanes that differ in bit 2 * kHalf
// swap halves of v[0, 2 kHalf) and add, leaving kHalf values a lane.
template <int kHalf>
__device__ __forceinline__ void fold(float (&v)[kRegSlots], int lane) {
  const bool upper = (lane & (2 * kHalf)) != 0;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const float send = upper ? v[j] : v[j + kHalf];
    const float keep = upper ? v[j + kHalf] : v[j];
    v[j] = keep + __shfl_xor_sync(kFull, send, 2 * kHalf);
  }
}

// Steps A and B of a sweep from the register tile: warp w holds
// B[w + 8j, 4l..4l+3] in b[j] (lane l), c the count of its slot
// w + 8 ((l >> 1) & 15).  Phinorm's 16 partial dots a lane are summed over
// the warp by a halving butterfly (8 + 4 + 2 + 1 + 1 shuffles), after
// which lane l holds slot (l >> 1) & 15's; the ratios go back to every
// lane by 16 shuffles.  Returns the warp's share of sum_t ratio[t] * B[t].
// bf16: phinorm against the rounded expEtheta, and each ratio rounded in
// the lane that forms it, before the shuffles.
template <bool kBf16>
__device__ __forceinline__ float4 sweep_registers(const Params& p,
                                                  const Layout& L,
                                                  const float* smem,
                                                  const float4 (&b)[kRegSlots],
                                                  float c, int n) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float4 e = lane < L.k4
      ? reinterpret_cast<const float4*>(smem + (kBf16 ? L.etr : L.et))[lane]
      : make_float4(0.f, 0.f, 0.f, 0.f);
  float v[kRegSlots];
#pragma unroll
  for (int j = 0; j < kRegSlots; ++j)
    v[j] = fmaf(b[j].w, e.w, fmaf(b[j].z, e.z, fmaf(b[j].y, e.y,
                                                     b[j].x * e.x)));
  fold<8>(v, lane);
  fold<4>(v, lane);
  fold<2>(v, lane);
  fold<1>(v, lane);
  const float ph = v[0] + __shfl_xor_sync(kFull, v[0], 1);
  const int t = warp + kWarps * ((lane >> 1) & (kRegSlots - 1));
  float r = t < n ? c / (ph + p.eps) : 0.f;
  if constexpr (kBf16) r = bf16_round(r);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < kRegSlots; ++j) {
    const float rj = __shfl_sync(kFull, r, 2 * j);
    acc.x = fmaf(b[j].x, rj, acc.x);
    acc.y = fmaf(b[j].y, rj, acc.y);
    acc.z = fmaf(b[j].z, rj, acc.z);
    acc.w = fmaf(b[j].w, rj, acc.w);
  }
  return acc;
}

// Step C of the wide kernels: thread tid owns topics tid, tid + kThreads,
// ..; it forms their gamma' into gam_s and returns (sum |dgamma|,
// sum gamma') over them, in topic order.
__device__ __forceinline__ float2 wide_gamma(const Params& p, const Layout& L,
                                             float* smem, int groups) {
  const float* et_s = smem + L.et;
  float* gam_s = smem + L.gam;
  float dabs = 0.f, sum = 0.f;
  for (int k = threadIdx.x; k < p.K; k += kThreads) {
    const float* part = smem + L.part + k;
    float a = 0.f;
#pragma unroll 4
    for (int gg = 0; gg < groups; ++gg) a += part[gg * L.k4 * 4];
    const float x = __ldg(p.alpha + k) + et_s[k] * a;
    dabs += fabsf(x - gam_s[k]);
    sum += x;
    gam_s[k] = x;
  }
  return make_float2(dabs, sum);
}

// The new expEtheta of the wide kernels' topics from gam_s and the row's
// sum of gamma' (bf16: and its rounded copy).
template <bool kBf16>
__device__ __forceinline__ void wide_expectation(const Params& p,
                                                 const Layout& L, float* smem,
                                                 float row_sum) {
  const float* gam_s = smem + L.gam;
  float* et_s = smem + L.et;
  const float r = psi_row_term(row_sum);
  for (int k = threadIdx.x; k < p.K; k += kThreads) {
    const float x = gam_s[k];
    et_s[k] = (x + 2.0f) * expf(psi_tail(x) - r);
    if constexpr (kBf16) smem[L.etr + k] = bf16_round(et_s[k]);
  }
}

// The segment of `row` (0 without segments).
__device__ __forceinline__ int segment_of(const Params& p, int row) {
  return p.seg ? __ldg(p.seg + row) : 0;
}

// Phase 1's count of a sweep s at which `row` was not exitable: into the
// block's histogram (its rows' segment), past nhist into the device array.
__device__ __forceinline__ void count_not_exitable(const Params& p,
                                                   int* hist_s, int row,
                                                   int s) {
  if (s < p.nhist) ++hist_s[s];
  else atomicAdd(&p.not_exitable[segment_of(p, row) * p.inner_iterations + s],
                 1);
}

struct RowRun {
  int sweeps;      // sweeps run
  int first_exit;  // first exitable sweep (1-based), 0 if none
  int nnz;         // live entries
};

// Runs `row` from gamma0 for at most max_sweeps sweeps, stopping when it
// is done; writes its gamma.  In phase 1 (count) it adds its not-exitable
// sweeps to the block's histogram.  Thread k < K keeps gamma[k] and
// alpha[k] in registers (kWide: thread tid keeps the gamma of its topics
// in gam_s); every thread keeps the row's exit state (the block sums are
// the same in every thread, so every thread takes the same decisions).
// kBf16: the table and slots hold bf16, and etr follows et rounded.
template <typename CT, bool kBf16, bool kReg, bool kWide>
__device__ __forceinline__ RowRun run_row(const Params& p, const Layout& L,
                                          float* smem, int row,
                                          int max_sweeps, bool count) {
  constexpr int kQ = kWide ? kWideQ : 1;
  const int tid = threadIdx.x, K = p.K;
  float* et_s = smem + L.et;
  int* hist_s = reinterpret_cast<int*>(smem + L.hist);
  const size_t base = (size_t)row * K;
  for (int k = tid; k < L.s4 * 4; k += kThreads)
    et_s[k] = k < K ? p.et0[base + k] : 0.f;
  if constexpr (kBf16)
    for (int k = tid; k < L.k8 * 8; k += kThreads)
      smem[L.etr + k] = k < K ? bf16_round(p.et0[base + k]) : 0.f;
  if constexpr (kWide)
    for (int k = tid; k < K; k += kThreads) smem[L.gam + k] = p.gamma0[base + k];
  const bool mine = !kWide && tid < K;
  float gam = mine ? p.gamma0[base + tid] : 0.f;
  const float alpha = mine ? p.alpha[tid] : 0.f;
  // Compaction of the whole row, once; with more live entries than the
  // buffer holds, each sweep loads and gathers them window by window.
  const int n = compact<CT>(p, L, smem, row);
  const bool resident = n <= p.nmax;
  if (resident) gather<kBf16>(p, L, smem, n);
  const int windows = resident ? 1 : (n + p.nmax - 1) / p.nmax;
  const bool freeze = p.threshold > 0.f;
  const int lane = tid % 32, warp = tid / 32;
  // Rows of up to 128 live entries keep B in registers (kReg kernels).
  const bool in_regs = kReg && resident && n <= kWarps * kRegSlots;
  float4 breg[kReg ? kRegSlots : 1];
  float creg = 0.f;
  if (in_regs) {
#pragma unroll
    for (int j = 0; j < (kReg ? kRegSlots : 1); ++j) {
      const int t = warp + kWarps * j;
      breg[j] = t < n && lane < L.k4 ? slot4<kBf16>(smem + L.b, L, t, lane)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const int t = warp + kWarps * ((lane >> 1) & (kRegSlots - 1));
    creg = t < n ? smem[L.cnt + t] : 0.f;
  }
  const int groups = in_regs ? kWarps : L.groups;
  float4* part4 = reinterpret_cast<float4*>(smem + L.part);
  float best = __int_as_float(0x7f800000);
  int age = 0, first = 0;
  int s = 0;
  while (s < max_sweeps) {
    float4 acc[kQ];
#pragma unroll
    for (int j = 0; j < kQ; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (in_regs) {
      if constexpr (kReg)
        acc[0] = sweep_registers<kBf16>(p, L, smem, breg, creg, n);
      if (lane < L.k4) part4[warp * L.k4 + lane] = acc[0];
    } else {
      for (int w = 0; w < windows; ++w) {
        int m = n;
        if (!resident) {
          const int w0 = w * p.nmax;
          m = min(p.nmax, n - w0);
          load_window(p, L, smem, w0, m);
          gather<kBf16>(p, L, smem, m);
        }
        if (m) sweep_slots<kQ, kBf16>(p, L, smem, m, acc);
      }
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const int idx = tid + kThreads * j;
        const int q = idx % L.k4, g = idx / L.k4;
        if (g < L.groups) part4[g * L.k4 + q] = acc[j];
      }
    }
    __syncthreads();
    // C. gamma' = alpha + expEtheta * acc, one thread a topic (K <= 256).
    float x = 0.f, dabs = 0.f;
    if (mine) {
      const float* part = smem + L.part + tid;
      float a = 0.f;
#pragma unroll 4
      for (int gg = 0; gg < groups; ++gg) a += part[gg * L.k4 * 4];
      x = alpha + et_s[tid] * a;
      dabs = fabsf(x - gam);
    }
    if constexpr (kWide) {
      const float2 mine_sums = wide_gamma(p, L, smem, groups);
      dabs = mine_sums.x;
      x = mine_sums.y;
    }
    const float2 sums = block_sum2(dabs, x, smem + L.red);
    if (mine) {
      gam = x;
      et_s[tid] = (x + 2.0f) * expf(psi_tail(x) - psi_row_term(sums.y));
      if constexpr (kBf16) smem[L.etr + tid] = bf16_round(et_s[tid]);
    }
    if constexpr (kWide) wide_expectation<kBf16>(p, L, smem, sums.y);
    const float change = sums.x / (float)K;
    const bool improved = change < 0.99f * best;
    age = improved ? 0 : age + 1;
    best = fminf(best, change);
    const bool done = freeze && best <= p.threshold;
    const bool exitable = done || (p.use_stall && age >= p.patience);
    if (count && !exitable && tid == 0) count_not_exitable(p, hist_s, row, s);
    if (exitable && !first) first = s + 1;
    ++s;
    __syncthreads();  // et_s is visible to every thread
    if (done) break;
  }
  if (mine) p.gamma[base + tid] = gam;
  if constexpr (kWide)
    for (int k = tid; k < K; k += kThreads) p.gamma[base + k] = smem[L.gam + k];
  return {s, first, n};
}

// Adds the block's histogram to segment seg's counts and zeroes it (no-op
// for seg < 0).  Called by the whole block.
__device__ __forceinline__ void flush_hist(const Params& p, int* hist_s,
                                           int seg) {
  if (seg >= 0)
    for (int s = threadIdx.x; s < p.nhist; s += kThreads)
      if (const int h = hist_s[s]) {
        atomicAdd(&p.not_exitable[seg * p.inner_iterations + s], h);
        hist_s[s] = 0;
      }
  __syncthreads();
}

// Segment seg's S*: the first sweep at which none of its rows was left
// not exitable (after the grid-wide sync of phase 1's counts).
__device__ __forceinline__ int s_star(const Params& p, int seg) {
  const int* ne = p.not_exitable + (size_t)seg * p.inner_iterations;
  for (int s = 0; s < p.inner_iterations; ++s)
    if (__ldcg(ne + s) == 0) return s + 1;
  return p.inner_iterations;
}

// Next row of a device queue, broadcast to the block.
__device__ __forceinline__ int next_row(int* queue, int* flags) {
  if (threadIdx.x == 0) flags[1] = atomicAdd(queue, 1);
  __syncthreads();
  const int row = flags[1];
  __syncthreads();
  return row;
}

// The two phases of a cooperative launch (row_fixed_point_kernel): phase 0
// runs every row until done or inner_iterations; phase 1 runs the rows
// that ran past their segment's S* again, for exactly S* sweeps.
// run(row, max_sweeps, count) runs one row and returns its RowRun; one
// call site keeps the code small.  hist_s (nhist ints) and flags (4 ints)
// are the block's shared memory.
template <typename RunRow>
__device__ __forceinline__ void row_phases(const Params& p, int* hist_s,
                                           int* flags, RunRow run) {
  const int tid = threadIdx.x;
  for (int s = tid; s < p.nhist; s += kThreads) hist_s[s] = 0;
  __syncthreads();
  int S = p.inner_iterations, cur = -1;  // the block's segment and its S*
  unsigned long long slots = 0, extra = 0;
  for (int phase = 0; phase < 2; ++phase) {
    if (phase == 1) {
      flush_hist(p, hist_s, cur);
      cg::this_grid().sync();
      if (blockIdx.x == 0)
        for (int g = tid; g < p.nseg; g += kThreads)
          p.sweeps_out[g] = s_star(p, g);
      cur = -1;
    }
    for (int row; (row = next_row(&p.queues[phase], flags)) < p.D;) {
      const int seg = segment_of(p, row);
      if (seg != cur) {
        if (phase == 0) {
          flush_hist(p, hist_s, cur);
        } else {
          if (tid == 0) flags[2] = s_star(p, seg);
          __syncthreads();
          S = flags[2];
        }
        cur = seg;
      }
      int sweeps = p.inner_iterations;
      if (phase == 1) {
        const int run_len = __ldcg(&p.row_run[row]);
        if (tid == 0) {
          const int needed = min(run_len, S);
          slots += (unsigned long long)__ldcg(&p.row_nnz[row]) * needed;
          if (run_len > S) extra += run_len;
          if (p.row_sweeps) p.row_sweeps[row] += needed;
        }
        if (run_len <= S) continue;
        sweeps = S;
      }
      const RowRun r = run(row, sweeps, phase == 0);
      if (phase == 0 && tid == 0) {
        p.row_run[row] = r.sweeps;
        p.row_nnz[row] = r.nnz;
        if (p.row_exit) p.row_exit[row] = r.first_exit;
      }
    }
  }
  if (tid == 0) {
    if (p.slots_out && slots) atomicAdd(p.slots_out, slots);
    if (p.extra_out && extra) atomicAdd(p.extra_out, extra);
  }
}

// kReg kernels keep rows of up to 128 live entries in registers (K <= 128)
// and fit 2 blocks an SM; the kWide kernels (K > 256) 2; the others 3.
template <typename CT, bool kBf16, bool kReg, bool kWide>
__global__ void __launch_bounds__(kThreads, kReg || kWide ? 2 : 3)
row_fixed_point_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(p.K, p.nmax, p.nhist, kWide, kBf16);
  row_phases(p, reinterpret_cast<int*>(smem + L.hist),
             reinterpret_cast<int*>(smem + L.flags),
             [&](int row, int sweeps, bool count) {
               return run_row<CT, kBf16, kReg, kWide>(p, L, smem, row, sweeps,
                                                      count);
             });
}

// Sizes the slot buffer and launches the kernel cooperatively: as many
// blocks as fit on the card at once, at most one a row, and, where a row
// can stream (L > nmax), at most list_blocks (never binding: the buffer
// then takes ~72 KB a block, 3 blocks an SM, or at K > 256 half an SM's
// shared memory or more, 2 or 1).  A slot's bytes follow the table's
// element: half at bf16 (kBf16), so the buffer holds about twice the
// entries.
template <typename CT, bool kBf16>
cudaError_t launch_row_fixed_point(Params& p, bool registers,
                                   cudaStream_t stream) {
  const int unit = kBf16 ? 8 : 4;  // topics a 16-byte copy of a table row
  if (p.D < 1 || p.K < 1 || p.K > kMaxTopics || p.inner_iterations < 1 ||
      p.L < 0 || p.L > p.ld || p.table_bf16 != (int)kBf16 ||
      p.ldb != unit * ((p.K + unit - 1) / unit) || p.nseg < 1 ||
      (!p.seg && p.nseg != 1))
    return cudaErrorInvalidValue;
  const bool wide = p.K > kThreads;
  int dev = 0, sms = 0, per_sm = 0, sm_bytes = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(
      &sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  p.nhist = min(p.inner_iterations, kMaxHist);
  const Layout fixed(p.K, 0, p.nhist, wide, kBf16);
  const int per_slot = (int)sizeof(float) * (fixed.slot + 3);
  const int fixed_bytes = (int)sizeof(float) * (fixed.total + 12);
  int nmax;
  if (!wide) {
    nmax = (kBlockSmemTarget - fixed_bytes) / per_slot;
    if (nmax < 16) nmax = 16;
  } else {
    // Two blocks an SM where a slot fits, else one with all it may have.
    nmax = (sm_bytes / 2 - kBlockSmemReserved - fixed_bytes) / per_slot;
    if (nmax < 1) nmax = (optin - fixed_bytes) / per_slot;
    if (nmax < 1) return cudaErrorInvalidValue;
  }
  p.nmax = max(min(nmax, p.L), 1);
  const bool streams = p.L > p.nmax;
  if (streams && (!p.lists || p.list_blocks < 1))
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) *
                      (size_t)Layout(p.K, p.nmax, p.nhist, wide, kBf16).total;
  auto kern = wide ? row_fixed_point_kernel<CT, kBf16, false, true>
              : registers && p.K <= 4 * 32
                  ? row_fixed_point_kernel<CT, kBf16, true, false>
                  : row_fixed_point_kernel<CT, kBf16, false, false>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  int grid = per_sm * sms;
  if (p.D < grid) grid = p.D;
  if (streams && p.list_blocks < grid) grid = p.list_blocks;
  p.smem_bytes = (int)smem;
  p.blocks_per_sm = per_sm;
  p.grid = grid;
  p.tile = p.K;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
