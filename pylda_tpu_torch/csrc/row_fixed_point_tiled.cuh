// The gamma fixed point above kMaxTopics = 4096 topics (sm_90a): the
// cluster kernel of both entries, ragged_gamma.cu and dense_gamma.cu, which
// take it when K > kMaxTopics.  The function, the exit rule, the segments,
// the row-major order (phase 1, each segment's S*, the phase-2 re-run of
// rows past it) and the outputs are row_fixed_point.cuh's; what differs is
// that one row is swept by a thread-block cluster of C CTAs that split its
// topics, and where the row's B rows live.
//
// What bounds it.  At K = 8192 a live entry's B row is 32 KB in f32 (16 KB
// bf16), and a row of ~150 entries holds 4.8 MB of B: no SM keeps it, and
// at V = 100k the [V, K] table (3.28 GB) does not fit the L2, so B comes
// from device memory.  Against 4 K FLOP an entry a sweep, one read of B a
// sweep is ~8x the arithmetic's time at 67 TFLOP/s: bytes.  The tiled
// kernel this one replaced read each B row twice a sweep (phinorm, then
// step B) and kept a row's expEtheta, gamma and ratios in device scratch.
//
// Design: one cluster a row, B read once a call where it fits the
// cluster's shared memory and once a sweep where it does not.
//   - The cluster (C = p.cluster CTAs, 8 or 16: ops/row_fixed_point.py
//     ::cluster_plan; a 16-wide cluster needs the non-portable size
//     attribute) owns one row at a time.  CTA r owns the topic slice
//     [r Ks, (r + 1) Ks), Ks = p.slice a multiple of the 16-byte unit (4
//     f32 or 8 bf16 topics); the last slice may be short or empty.  Each
//     CTA keeps its slice of expEtheta, the bf16-rounded copy, gamma and
//     step B's group sums in shared memory: no row state in device memory.
//   - The rank-0 CTA takes the next row from the queue, compacts its live
//     entries into the cluster's (id, count) list in device memory (the
//     row's input, written once a row) and hands the row, its live entries
//     and its sweeps to the others through distributed shared memory (a
//     slot of two, so one cluster barrier a row suffices).
//   - B staged by TMA.  An entry's slice of B is one contiguous run of
//     Ks x 4 (bf16: Ks x 2) bytes at table + id x ldb + r Ks; each CTA copies
//     it with cp.async.bulk global -> shared, completing on an mbarrier.
//     The first R = p.resident entries of a row stay resident for all its
//     sweeps (one copy a call); the entries past R stream through a ring of
//     two windows of W = p.window entries, one read a sweep, the next
//     window's copy in flight while the current one is summed (the copies
//     run ahead across sweeps; a row that ends early drains them).
//   - One pass over B a sweep, window by window (the resident entries are
//     one window): (1) each CTA forms its slice's partial phinorm of the
//     window's entries (a warp an entry, lanes over 16-byte units, the
//     butterfly) and stores it into every rank's exchange array
//     (st.async to the address mapa gives, completing as transaction
//     bytes on that rank's mbarrier); (2) each CTA waits on its own
//     mbarrier for the C ranks' partials; (3) it sums the C partials of
//     each entry in rank order 0..C-1, adds eps and forms the ratio (bf16:
//     rounded where it is stored), so every CTA holds the same bits; (4)
//     it adds ratio x B into its slice's step-B sums from the same staged
//     tile (thread (q, g): float4 q of the slice, entries g, g + G, ..).
//     After the last window gamma' is formed on the slice (the groups
//     summed in order), and the CTA's partial sum |dgamma| and sum gamma'
//     go to every rank the same way and are summed in rank order, so
//     every CTA takes the same exit decision; then the new expEtheta
//     slice.  Sums run in a fixed order throughout, with no float
//     atomics: two calls give the same bits.  The exchange arrays and
//     their mbarriers alternate (a window, a sweep), so no cluster
//     barrier is needed within a row: a rank stores into an array again
//     only after it holds this CTA's values of the next exchange, which
//     this CTA sends after reading the array.  (cluster.sync() compiles to
//     a device-wide memory barrier and an L1 invalidation; a window's
//     barrier cost more than its arithmetic, PERF.md.)  A cluster barrier
//     a row hands the row over; a final cluster.sync() keeps every CTA
//     alive while another may still store into its shared memory.
//   - The launch: cooperative, with the cluster dimension
//     (cudaLaunchKernelEx with cudaLaunchAttributeCooperative and
//     cudaLaunchAttributeClusterDimension; on an H100 with the CUDA 12.9
//     runtime the two go together and grid.sync() works at C <= 16,
//     measured once; decided so, one launch like the K <= 4096 kernels).
//     The grid is the clusters that fit at once
//     (cudaOccupancyMaxActiveClusters: 7 of 16 CTAs or 15 of 8 at ~200 KB a
//     CTA on an H100), at most one a row; a refused launch raises.
//   - Past K = 16 x 4096 a slice no longer fits a CTA (its step-B sums
//     are kClusterQ float4 a thread, its state and two entries' B slices
//     ~20 bytes a topic of shared memory), and the plan is direct
//     (p.state set): each CTA keeps its slice state in its part of the
//     device scratch p.state, and reads its entries' B slices from the
//     table itself, in windows of W entries none resident, once for the
//     partials and once for step B, whose sums stay in the state (a
//     float4 a thread, the entries in order: the same bits as one group
//     of the staged step B).  The exchange, the order of every sum and
//     the exit rule are the same; so it takes any K the card's memory
//     holds.
// The geometry (C, Ks, R, W, windows a sweep of the widest row, clusters in
// flight) is written back into Params (GEOMETRY).

#pragma once

#include <cstdint>

#include "cluster_ptx.cuh"
#include "row_fixed_point.cuh"

namespace {

// Largest cluster the kernel takes (non-portable above 8 on an H100).
constexpr int kMaxCluster = 16;
// Float4 step-B sums a thread: slices of up to kThreads * 4 * 4 topics.
constexpr int kClusterQ = 4;

// Lanes that sum one entry's partial phinorm, for a slice of units16
// 16-byte units: the power of two that gives each lane about eight units
// (at most 32).  ops/row_fixed_point.py::entry_lanes mirrors it.
__host__ __device__ __forceinline__ int entry_lanes(int units16) {
  int lanes = 1;
  while (lanes < 32 && lanes * 8 < units16) lanes <<= 1;
  return lanes;
}

// A CTA's memory, in bytes (each offset a multiple of 16).  Its slice
// state: et, etr (bf16 builds), gam and the step-B group sums (`state`
// bytes, offsets from the state's base: the start of the shared memory,
// or in the direct plan the CTA's part of the device scratch p.state, with
// one group).  Then in shared memory: the window's ratios, the two
// exchange arrays of the ranks' partial phinorms ([C] rows of wmax), the
// two exchange arrays of the ranks' (|dgamma|, gamma') pairs, the
// histogram, scan, block sums, flags, the two row slots, seven mbarriers
// (the resident copies, ring 0 and 1, the two partial exchanges, the two
// pair exchanges), then the resident tile (R entries) and the ring (2 W
// entries), an entry's slice at `stride` bytes (neither in the direct
// plan, which reads B from the table).
// ops/row_fixed_point.py::cluster_smem_bytes mirrors it.
struct ClusterLayout {
  int ks, stride, groups, wmax, lanes;
  int et, etr, gam, part, state, ratio, recv, rsum, hist, scan, red, flags,
      slots, bars, res, ring, total;
  __host__ __device__ ClusterLayout(int slice, int R, int W, int nhist,
                                    bool bf16, int cluster, bool direct) {
    ks = slice;
    stride = slice * (bf16 ? 2 : 4);
    const int nq = slice / 4;
    groups = nq < kThreads && !direct ? kThreads / nq : 1;
    wmax = ((R > W ? R : W) + 3) & ~3;
    lanes = entry_lanes(stride / 16);
    int o = 0;
    et = o;
    o += 4 * ks;
    etr = o;
    o += bf16 ? 4 * ks : 0;
    gam = o;
    o += 4 * ks;
    part = o;
    o += 4 * groups * ks;
    state = o;
    o = direct ? 0 : state;
    ratio = o;
    o += 4 * wmax;
    recv = o;
    o += 8 * cluster * wmax;
    rsum = o;
    o += 16 * cluster;
    hist = o;
    o += 4 * ((nhist + 3) & ~3);
    scan = o;
    o += 4 * kWarps;
    red = o;
    o += 8 * kWarps;
    flags = o;
    o += 16;
    slots = o;
    o += 32;
    bars = o;
    o += 64;
    res = o;
    o += direct ? 0 : R * stride;
    ring = o;
    o += direct ? 0 : 2 * W * stride;
    total = o;
  }
};

// Compacts the live entries of `row`, in order, into a list (L ids, then L
// counts); returns how many there are.  Called by the whole block.
template <typename CT>
__device__ __forceinline__ int compact_to_list(const Params& p, int* scan_s,
                                               int row, int* ids_out) {
  const int per = (p.L + kThreads - 1) / kThreads;
  const int j0 = min((int)threadIdx.x * per, p.L);
  const int j1 = min(j0 + per, p.L);
  const CT* c = static_cast<const CT*>(p.cnts) + (size_t)row * p.ld;
  int mine = 0;
  for (int j = j0; j < j1; ++j) mine += to_float(c[j]) != 0.f;
  int total;
  int pos = block_excl_scan(mine, scan_s, &total);
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
  __syncthreads();  // the list's writes are done
  return total;
}

// What a CTA of the cluster owns: its rank, the cluster's width, its slice
// [k0, k0 + ks) of which `own` topics are real (< K), and the bytes of an
// entry's slice it copies (topics k0 .. min(ldb, k0 + ks)).
struct Slice {
  int rank, C, k0, own, units16, nq, elem;
  uint32_t bytes;
  __device__ Slice(const Params& p, int r, bool bf16) {
    rank = r;
    C = p.cluster;
    k0 = r * p.slice;
    own = max(0, min(p.K, k0 + p.slice) - k0);
    const int loaded = max(0, min(p.ldb, k0 + p.slice) - k0);
    elem = bf16 ? 2 : 4;
    bytes = (uint32_t)(loaded * elem);
    units16 = (int)bytes / 16;
    nq = loaded / 4;
  }
};

// Warp 0 copies entries [t0, t0 + m) of the cluster's list, this CTA's
// slice of each, into tile (an entry a `stride`), completing on bar.
__device__ __forceinline__ void stage_window(const Params& p, const Slice& S,
                                             const int* ids_g, int t0, int m,
                                             unsigned char* tile, int stride,
                                             uint64_t* bar) {
  const int lane = threadIdx.x % 32;
  if (lane == 0) mbar_expect_tx(bar, (uint32_t)m * S.bytes);
  __syncwarp();
  for (int i = lane; i < m; i += 32) {
    const size_t id = (size_t)__ldcg(ids_g + t0 + i);
    bulk_load(tile + (size_t)i * stride,
              static_cast<const unsigned char*>(p.table) +
                  (id * p.ldb + S.k0) * S.elem,
              S.bytes, bar);
  }
}

// A lane's share of one entry's partial phinorm over the slice: its
// 16-byte units g, g + G, .. (g its place in its group of G lanes) in four
// running sums (a bf16 unit of 8 topics feeds them twice), (a0 + a1) +
// (a2 + a3).  e4: expEtheta as phinorm reads it (etr in the bf16 builds).
template <bool kBf16>
__device__ __forceinline__ float lane_dot(const Slice& S,
                                          const unsigned char* row,
                                          const float4* e4, int g, int G) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  if constexpr (kBf16) {
    const uint4* b8 = reinterpret_cast<const uint4*>(row);
#pragma unroll 4
    for (int q = g; q < S.units16; q += G) {
      const uint4 b = b8[q];
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
    const float4* b4 = reinterpret_cast<const float4*>(row);
#pragma unroll 4
    for (int q = g; q < S.units16; q += G) {
      const float4 b = b4[q], x = e4[q];
      a0 = fmaf(b.x, x.x, a0);
      a1 = fmaf(b.y, x.y, a1);
      a2 = fmaf(b.z, x.z, a2);
      a3 = fmaf(b.w, x.w, a3);
    }
  }
  return (a0 + a1) + (a2 + a3);
}

// Where this CTA's slice of B of a window's entry t lies: staged in
// shared memory, an entry a `stride` bytes from tile ...
struct TileRows {
  const unsigned char* tile;
  int stride;
  __device__ __forceinline__ const unsigned char* operator()(int t) const {
    return tile + (size_t)t * stride;
  }
};

// ... or, in the direct plan, in the table itself: `slice` is the table
// at this CTA's first topic, ids the window's ids in the cluster's list.
struct TableRows {
  const unsigned char* slice;
  const int* ids;
  size_t ldb_bytes;
  __device__ __forceinline__ const unsigned char* operator()(int t) const {
    return slice + (size_t)__ldcg(ids + t) * ldb_bytes;
  }
};

// (1) of a window: this CTA's partial phinorm of each of its m entries
// (their B slices at rows(t)) over the slice, a group of G = entry_lanes
// lanes an entry (``lane_dot``, then the butterfly over the group, so its
// lanes hold the same bits), sent to every rank: lane g of the group
// stores it into ranks g, g + G, .. < C, into their exchange row of this
// CTA's rank (``row``, a local address; the same offset in every CTA),
// completing on their mbarrier ``bar``.  A warp takes 32 / G entries at a
// time, and two such sets (t and t + kWarps * 32 / G) with their loads
// and shuffles interleaved.
template <bool kBf16, typename Rows>
__device__ __forceinline__ void window_partials(const Slice& S,
                                                const Rows& rows,
                                                const float* e, int m, int G,
                                                uint32_t row, uint32_t bar) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane & (G - 1), per_warp = 32 / G;
  const int step = kWarps * per_warp;
  const float4* e4 = reinterpret_cast<const float4*>(e);
  for (int t = warp * per_warp + lane / G; t - lane / G < m; t += 2 * step) {
    const int u = t + step;
    float x = t < m ? lane_dot<kBf16>(S, rows(t), e4, g, G) : 0.f;
    float y = u < m ? lane_dot<kBf16>(S, rows(u), e4, g, G) : 0.f;
    for (int off = G >> 1; off > 0; off >>= 1) {
      x += __shfl_xor_sync(kFull, x, off);
      y += __shfl_xor_sync(kFull, y, off);
    }
    for (int r = g; r < S.C; r += G) {
      const uint32_t to = mapa(row, r), to_bar = mapa(bar, r);
      if (t < m) st_async(to + 4 * t, x, to_bar);
      if (u < m) st_async(to + 4 * u, y, to_bar);
    }
  }
}

// Topics 4q..4q+3 of an entry's B slice `row`, as f32.
template <bool kBf16>
__device__ __forceinline__ float4 row4(const unsigned char* row, int q) {
  if constexpr (kBf16) {
    const uint2 u = reinterpret_cast<const uint2*>(row)[q];
    return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y),
                       bf16_hi(u.y));
  } else {
    return reinterpret_cast<const float4*>(row)[q];
  }
}

// The pipeline state a CTA keeps across rows: the parity of each
// mbarrier's next phase (the partial and pair exchanges a bit a buffer).
struct Pipe {
  uint32_t res, ring[2], xch, pair;
};

// The sweep of one window: (1) partials, sent to every rank; (2) the wait
// for every rank's; (3) the rank-ordered sums and ratios; (4) ratio x B
// into acc (in the direct plan into the state's step-B sums, a float4 a
// thread at a time).  buf selects the exchange array and its mbarrier
// (alternating a window in every CTA alike): a rank stores into it again
// only after it has this CTA's partials of the next window, sent after
// this CTA read it.  B comes from tile (staged) or, in the direct plan
// (kDirect), from the table at the window's ids (ids_g + t0).
template <bool kBf16, bool kDirect>
__device__ __forceinline__ void sweep_window(
    const Params& p, const Slice& S, const ClusterLayout& CL,
    unsigned char* smem, unsigned char* st, const unsigned char* tile,
    const int* ids_g, int t0, int m, int buf, Pipe& pipe,
    float4 (&acc)[kClusterQ]) {
  const int tid = threadIdx.x;
  float* recv = reinterpret_cast<float*>(smem + CL.recv) + buf * S.C * CL.wmax;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + CL.bars) + 3 + buf;
  float* ratio = reinterpret_cast<float*>(smem + CL.ratio);
  const float* cnt_g = reinterpret_cast<const float*>(ids_g + p.L);
  const float* e = reinterpret_cast<const float*>(st + (kBf16 ? CL.etr : CL.et));
  if (tid == 0) mbar_expect_tx(bar, (uint32_t)(S.C * m * 4));
  // The counts of the ratios below, loaded before the partials (m <=
  // kThreads for every window the plan makes; more loop below).
  const float cnt = tid < m ? __ldcg(cnt_g + t0 + tid) : 0.f;
  const uint32_t to_row = smem_u32(recv + S.rank * CL.wmax);
  const TableRows table_rows{
      static_cast<const unsigned char*>(p.table) + (size_t)S.k0 * S.elem,
      ids_g + t0, (size_t)p.ldb * S.elem};
  if constexpr (kDirect)
    window_partials<kBf16>(S, table_rows, e, m, CL.lanes, to_row,
                           smem_u32(bar));
  else
    window_partials<kBf16>(S, TileRows{tile, CL.stride}, e, m, CL.lanes,
                           to_row, smem_u32(bar));
  mbar_wait(bar, (pipe.xch >> buf) & 1u);
  pipe.xch ^= 1u << buf;
  for (int t = tid; t < m; t += kThreads) {
    float v[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      v[r] = r < S.C ? recv[r * CL.wmax + t] : 0.f;
    float ph = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < S.C) ph += v[r];
    const float rt = (t == tid ? cnt : __ldcg(cnt_g + t0 + t)) / (ph + p.eps);
    ratio[t] = kBf16 ? bf16_round(rt) : rt;
  }
  __syncthreads();  // the ratios are visible to the CTA
  if constexpr (kDirect) {  // one group: the entries in order, as below
    float4* part4 = reinterpret_cast<float4*>(st + CL.part);
    for (int q = tid; q < S.nq; q += kThreads) {
      float4 a = part4[q];
      for (int t = 0; t < m; ++t) {
        const float r = ratio[t];
        const float4 b = row4<kBf16>(table_rows(t), q);
        a.x = fmaf(b.x, r, a.x);
        a.y = fmaf(b.y, r, a.y);
        a.z = fmaf(b.z, r, a.z);
        a.w = fmaf(b.w, r, a.w);
      }
      part4[q] = a;
    }
    return;
  }
  const int nq = CL.ks / 4;
#pragma unroll
  for (int j = 0; j < kClusterQ; ++j) {
    const int idx = tid + kThreads * j;
    const int q = idx % nq, g = idx / nq;
    if (g < CL.groups && q < S.nq) {
#pragma unroll 4
      for (int t = g; t < m; t += CL.groups) {
        const float r = ratio[t];
        const float4 b = row4<kBf16>(tile + (size_t)t * CL.stride, q);
        acc[j].x = fmaf(b.x, r, acc[j].x);
        acc[j].y = fmaf(b.y, r, acc[j].y);
        acc[j].z = fmaf(b.z, r, acc[j].z);
        acc[j].w = fmaf(b.w, r, acc[j].w);
      }
    }
  }
}

// Runs `row` (n live entries in the cluster's list) from gamma0 for at
// most max_sweeps sweeps, stopping when it is done; writes this CTA's slice
// of its gamma.  Every CTA of the cluster runs it with the same arguments
// and takes the same decisions (the cluster sums are the same bits in every
// CTA).  In phase 1 (count) the rank-0 CTA adds the row's not-exitable
// sweeps to its histogram.  st: the base of the CTA's slice state.
template <bool kBf16, bool kDirect>
__device__ __forceinline__ RowRun run_row_cluster(
    const Params& p, const Slice& S, const ClusterLayout& CL,
    unsigned char* smem, unsigned char* st, Pipe& pipe, int& buf,
    const int* ids_g, int row, int n, int max_sweeps, bool count) {
  const int tid = threadIdx.x, warp = tid / 32, K = p.K;
  float* et = reinterpret_cast<float*>(st + CL.et);
  float* etr = reinterpret_cast<float*>(st + CL.etr);
  float* gam = reinterpret_cast<float*>(st + CL.gam);
  float* part = reinterpret_cast<float*>(st + CL.part);
  float* rsum = reinterpret_cast<float*>(smem + CL.rsum);
  int* hist_s = reinterpret_cast<int*>(smem + CL.hist);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + CL.bars);
  unsigned char* res = smem + CL.res;
  unsigned char* ring = smem + CL.ring;
  const size_t base = (size_t)row * K;
  for (int kl = tid; kl < CL.ks; kl += kThreads) {
    const int k = S.k0 + kl;
    const float e0 = kl < S.own ? p.et0[base + k] : 0.f;
    et[kl] = e0;
    if constexpr (kBf16) etr[kl] = bf16_round(e0);
    gam[kl] = kl < S.own ? p.gamma0[base + k] : 0.f;
  }
  // Resident entries [0, nr); streamed [nr, n) in nsw windows of W a sweep.
  const int W = p.window;
  const int nr = min(n, p.resident);
  const int ns = n - nr;
  const int nsw = ns > 0 ? (ns + W - 1) / W : 0;
  const int seq_end = max_sweeps * nsw;  // streamed windows of the row
  const bool copies = S.bytes > 0 && !kDirect;
  int staged = 0, consumed = 0;
  const size_t ring_stride = (size_t)W * CL.stride;
  if (copies && warp == 0) {
    if (nr) stage_window(p, S, ids_g, 0, nr, res, CL.stride, &bars[0]);
    for (int q = 0; q < 2 && q < seq_end; ++q)
      stage_window(p, S, ids_g, nr + (q % nsw) * W,
                   min(W, ns - (q % nsw) * W), ring + q * ring_stride,
                   CL.stride, &bars[1 + q]);
  }
  staged = min(2, seq_end);
  if (nr && copies) {  // the resident entries land (once a call)
    mbar_wait(&bars[0], pipe.res);
    pipe.res ^= 1;
  }
  __syncthreads();  // the slice's state is written
  const bool freeze = p.threshold > 0.f;
  float best = __int_as_float(0x7f800000);
  int age = 0, first = 0;
  int s = 0;
  while (s < max_sweeps) {
    float4 acc[kClusterQ];
#pragma unroll
    for (int j = 0; j < kClusterQ; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (kDirect)  // the step-B sums, by the thread adding to each
      for (int q = tid; q < S.nq; q += kThreads)
        reinterpret_cast<float4*>(part)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    // The resident window (if any), then the streamed ones: one call site
    // of sweep_window keeps the kernel's code small.
    for (int w = nr ? -1 : 0; w < nsw; ++w) {
      const unsigned char* tile = res;
      int t0 = 0, m = nr;
      const int slot = consumed & 1;
      if (w >= 0) {
        if (copies) {
          mbar_wait(&bars[1 + slot], pipe.ring[slot]);
          pipe.ring[slot] ^= 1;
        }
        tile = ring + slot * ring_stride;
        t0 = nr + w * W;
        m = min(W, ns - w * W);
      }
      sweep_window<kBf16, kDirect>(p, S, CL, smem, st, tile, ids_g, t0, m,
                                   buf, pipe, acc);
      buf ^= 1;
      if (w < 0) continue;
      ++consumed;
      __syncthreads();  // the slot is read: its next window may land
      if (staged < seq_end) {  // into the slot just read
        const int q = staged % nsw;
        if (copies && warp == 0)
          stage_window(p, S, ids_g, nr + q * W, min(W, ns - q * W),
                       ring + (staged & 1) * ring_stride, CL.stride,
                       &bars[1 + (staged & 1)]);
        ++staged;
      }
    }
    // gamma' on the slice: step B's groups summed in order.
    const int nq = CL.ks / 4;
#pragma unroll
    for (int j = 0; j < kClusterQ; ++j) {
      const int idx = tid + kThreads * j;
      const int q = idx % nq, g = idx / nq;
      if (!kDirect && g < CL.groups && q < S.nq)
        reinterpret_cast<float4*>(part + g * CL.ks)[q] = acc[j];
    }
    __syncthreads();
    float dabs = 0.f, sum = 0.f;
    for (int kl = tid; kl < S.own; kl += kThreads) {
      float a = 0.f;
      for (int g = 0; g < CL.groups; ++g) a += part[g * CL.ks + kl];
      const float x = __ldg(p.alpha + S.k0 + kl) + et[kl] * a;
      dabs += fabsf(x - gam[kl]);
      sum += x;
      gam[kl] = x;
    }
    // The CTA's (|dgamma|, gamma') pair to every rank, the same way as
    // the partials (two exchange arrays, alternating a sweep).
    const int pb = s & 1;
    float2* pairs = reinterpret_cast<float2*>(rsum) + pb * S.C;
    uint64_t* pbar = bars + 5 + pb;
    if (tid == 0) mbar_expect_tx(pbar, (uint32_t)(S.C * 8));
    const float2 mine = block_sum2(dabs, sum,
                                   reinterpret_cast<float*>(smem + CL.red));
    if (tid < S.C)
      st_async(mapa(smem_u32(pairs + S.rank), tid), mine,
               mapa(smem_u32(pbar), tid));
    mbar_wait(pbar, (pipe.pair >> pb) & 1u);
    pipe.pair ^= 1u << pb;
    float2 v[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      v[r] = r < S.C ? pairs[r] : make_float2(0.f, 0.f);
    float tot_abs = 0.f, tot = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < S.C) {
        tot_abs += v[r].x;
        tot += v[r].y;
      }
    const float rterm = psi_row_term(tot);
    for (int kl = tid; kl < S.own; kl += kThreads) {
      const float x = gam[kl];
      const float e1 = (x + 2.0f) * expf(psi_tail(x) - rterm);
      et[kl] = e1;
      if constexpr (kBf16) etr[kl] = bf16_round(e1);
    }
    const float change = tot_abs / (float)K;
    const bool improved = change < 0.99f * best;
    age = improved ? 0 : age + 1;
    best = fminf(best, change);
    const bool done = freeze && best <= p.threshold;
    const bool exitable = done || (p.use_stall && age >= p.patience);
    if (count && !exitable && S.rank == 0 && tid == 0)
      count_not_exitable(p, hist_s, row, s);
    if (exitable && !first) first = s + 1;
    ++s;
    __syncthreads();  // et is visible to every thread
    if (done) break;
  }
  // Copies staged ahead for sweeps the row does not run land before the
  // slots are used again.
  for (; consumed < staged; ++consumed) {
    const int slot = consumed & 1;
    if (copies) {
      mbar_wait(&bars[1 + slot], pipe.ring[slot]);
      pipe.ring[slot] ^= 1;
    }
  }
  for (int kl = tid; kl < S.own; kl += kThreads)
    p.gamma[base + S.k0 + kl] = gam[kl];
  __syncthreads();  // the next row rewrites the slice
  return {s, first, n};
}

// The two phases, a cluster a row (both cluster kernels: this one, and
// the entry kernel of row_fixed_point_entries.cuh).  The rank-0 CTA walks
// the queues: in phase 0 every row (flushing its histogram when the rows
// move on to the next segment); in phase 1 the rows that ran past their
// segment's S* (doing the bookkeeping of the others itself).  It compacts
// the row into the cluster's list (ids_g) and writes (row, live entries,
// sweeps) into a slot of its shared memory (two slots, so one cluster
// barrier a row suffices); after a cluster barrier every CTA reads the
// slot.  run(row, n, sweeps, count) runs one row in every CTA of the
// cluster and returns its RowRun.  hist_s (nhist ints), flags (4 ints),
// slots (8 ints) and scan_s (kWarps ints) are the CTA's shared memory.
template <typename CT, typename RunRow>
__device__ __forceinline__ void cluster_phases(const Params& p, int rank,
                                               int* ids_g, int* hist_s,
                                               int* flags, int* slots,
                                               int* scan_s, RunRow run) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  for (int s = tid; s < p.nhist; s += kThreads) hist_s[s] = 0;
  __syncthreads();
  int takes = 0;
  int cur = -1, S_cur = p.inner_iterations;  // rank 0: segment, its S*
  unsigned long long slots_n = 0, extra = 0;
  for (int phase = 0; phase < 2; ++phase) {
    if (phase == 1) {
      flush_hist(p, hist_s, cur);
      cg::this_grid().sync();
      if (blockIdx.x == 0)
        for (int g = tid; g < p.nseg; g += kThreads)
          p.sweeps_out[g] = s_star(p, g);
      cur = -1;
    }
    for (;;) {
      int* slot = slots + 4 * (takes & 1);
      if (rank == 0) {
        if (tid == 0) {
          int row, sweeps = p.inner_iterations;
          if (phase == 0) {
            row = atomicAdd(&p.queues[0], 1);
          } else {
            for (;;) {
              row = atomicAdd(&p.queues[1], 1);
              if (row >= p.D) break;
              const int seg = segment_of(p, row);
              if (seg != cur) {
                cur = seg;
                S_cur = s_star(p, seg);
              }
              const int run_len = __ldcg(&p.row_run[row]);
              const int needed = min(run_len, S_cur);
              slots_n += (unsigned long long)__ldcg(&p.row_nnz[row]) * needed;
              if (p.row_sweeps) p.row_sweeps[row] += needed;
              if (run_len > S_cur) {
                extra += run_len;
                break;
              }
            }
            sweeps = S_cur;
          }
          flags[1] = row;
          flags[2] = sweeps;
        }
        __syncthreads();
        const int row = flags[1];
        int n = 0;
        if (row < p.D) {
          if (phase == 0) {
            const int seg = segment_of(p, row);
            if (seg != cur) {
              flush_hist(p, hist_s, cur);
              cur = seg;
            }
          }
          n = compact_to_list<CT>(p, scan_s, row, ids_g);
        }
        if (tid == 0) {
          slot[0] = row;
          slot[1] = n;
          slot[2] = flags[2];
        }
      }
      cluster.sync();  // the slot and the list are written
      const int* s0 = cluster.map_shared_rank(slot, 0);
      const int row = s0[0], n = s0[1], sweeps = s0[2];
      ++takes;
      if (row >= p.D) break;
      const RowRun r = run(row, n, sweeps, phase == 0);
      if (phase == 0 && rank == 0 && tid == 0) {
        p.row_run[row] = r.sweeps;
        p.row_nnz[row] = r.nnz;
        if (p.row_exit) p.row_exit[row] = r.first_exit;
      }
    }
  }
  if (rank == 0 && tid == 0) {
    if (p.slots_out && slots_n) atomicAdd(p.slots_out, slots_n);
    if (p.extra_out && extra) atomicAdd(p.extra_out, extra);
  }
  cluster.sync();  // no CTA leaves while another may read its memory
}

// The cluster kernel above kMaxTopics: cluster_phases with a row run by
// run_row_cluster.  kDirect: the direct plan (p.state), an instance of its
// own, so that the staged plan's code is the same as without it.
template <typename CT, bool kBf16, bool kDirect>
__global__ void __launch_bounds__(kThreads, 1)
row_fixed_point_cluster_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char cluster_smem[];
  unsigned char* smem = cluster_smem;
  const ClusterLayout CL(p.slice, p.resident, p.window, p.nhist, kBf16,
                         p.cluster, kDirect);
  unsigned char* st = kDirect ? reinterpret_cast<unsigned char*>(p.state) +
                                    (size_t)blockIdx.x * CL.state
                              : smem;
  const int rank = (int)cg::this_cluster().block_rank();
  const Slice S(p, rank, kBf16);
  int* ids_g = p.lists + (size_t)(blockIdx.x / p.cluster) * 2 * p.L;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + CL.bars);
  if (threadIdx.x == 0) {
    for (int b = 0; b < 7; ++b) mbar_init(&bars[b], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  Pipe pipe = {0u, {0u, 0u}, 0u, 0u};
  int buf = 0;
  cluster_phases<CT>(
      p, rank, ids_g, reinterpret_cast<int*>(smem + CL.hist),
      reinterpret_cast<int*>(smem + CL.flags),
      reinterpret_cast<int*>(smem + CL.slots),
      reinterpret_cast<int*>(smem + CL.scan),
      [&](int row, int n, int sweeps, bool count) {
        return run_row_cluster<kBf16, kDirect>(p, S, CL, smem, st, pipe, buf,
                                               ids_g, row, n, sweeps, count);
      });
}

// Launches kern cooperatively in clusters of p.cluster CTAs with smem
// bytes of dynamic shared memory a CTA (cudaLaunchKernelEx with the
// cooperative and cluster-dimension attributes): as many clusters as fit
// on the card at once, at most one a row and at most cap.  Writes back
// clusters, smem_bytes, blocks_per_sm and grid.
template <typename Kernel>
cudaError_t launch_clusters(Kernel kern, Params& p, size_t smem, int cap,
                            cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = p.cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  int clusters = 0, per_sm = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kern, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (p.D < clusters) clusters = p.D;
  if (cap < clusters) clusters = cap;
  p.clusters = clusters;
  p.smem_bytes = (int)smem;
  p.blocks_per_sm = per_sm;
  p.grid = clusters * p.cluster;
  cfg.gridDim = dim3(p.grid);
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, kern, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Launches the cluster kernel cooperatively for K > kMaxTopics with the
// plan in p (cluster, slice, resident, window; the direct plan with the
// state scratch): as many clusters as fit on the card at once, at most one
// a row, at most list_blocks (each has its list) and, in the direct plan,
// at most the CTAs its state holds.  Writes back the geometry.
template <typename CT, bool kBf16>
cudaError_t launch_row_fixed_point_cluster(Params& p, cudaStream_t stream) {
  const int unit = kBf16 ? 8 : 4;  // topics a 16-byte copy of a table row
  const bool direct = p.state != nullptr;
  if (p.D < 1 || p.K <= kMaxTopics || p.inner_iterations < 1 || p.L < 0 ||
      p.L > p.ld || p.table_bf16 != (int)kBf16 ||
      p.ldb != unit * ((p.K + unit - 1) / unit) || !p.lists ||
      p.list_blocks < 1 || p.nseg < 1 || (!p.seg && p.nseg != 1) ||
      p.cluster < 1 || p.cluster > kMaxCluster || p.slice < unit ||
      p.slice % unit || (long long)p.slice * p.cluster < p.K ||
      p.resident < 0 || p.window < 0 || (p.resident < p.L && p.window < 1))
    return cudaErrorInvalidValue;
  if (direct ? p.resident != 0 || p.window < 1 || p.state_ctas < p.cluster
             : p.slice > kThreads * 4 * kClusterQ)
    return cudaErrorInvalidValue;
  p.nhist = min(p.inner_iterations, kMaxHist);
  p.nmax = 0;
  const size_t smem =
      (size_t)ClusterLayout(p.slice, p.resident, p.window, p.nhist, kBf16,
                            p.cluster, direct)
          .total;
  auto kern = direct ? row_fixed_point_cluster_kernel<CT, kBf16, true>
                     : row_fixed_point_cluster_kernel<CT, kBf16, false>;
  const int R = p.resident, W = p.window;
  const int nr = min(p.L, R);
  p.windows = (nr > 0) + (p.L > nr ? (p.L - nr + W - 1) / W : 0);
  p.tile = p.slice;
  return launch_clusters(
      kern, p, smem,
      direct ? min(p.list_blocks, p.state_ctas / p.cluster) : p.list_blocks,
      stream);
}

}  // namespace
