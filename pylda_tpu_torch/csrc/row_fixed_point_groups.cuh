// The bf16 gamma fixed point at K <= 256 for rows of up to kGroupMaxSlots
// live entries (sm_90a): the warp-group kernel of both entries,
// ragged_gamma.cu and dense_gamma.cu, in their bf16 builds
// (-DPYLDA_BF16=1).  It replaces, in bf16, the TPU kernels
// pylda_tpu/ops/pallas_estep.py:272 (pallas_estep_dense, whose tile kernel
// keeps bf16 in VMEM and does both products of a sweep on the MXU) and
// pylda_tpu/ops/pallas_ragged.py:212 (pallas_estep_ragged_gamma), as the
// row-resident kernels of row_fixed_point.cuh did before it.  The
// function, the exit rule, the segments, the row-major order (phase 1,
// each segment's S*, the phase-2 re-run of rows past it) and the outputs
// are row_fixed_point.cuh's; ops/row_fixed_point.py::gamma_plan sends a
// launch here (Params.group_slots > 0) when its widest row fits a group's
// slots.  Wider rows, K > 256, and the float32 builds keep their kernels.
//
// What bounded the bf16 build of the row-resident kernels.  A block of
// 256 threads owned a row: at K = 100 and ~120 live entries each sweep
// paid four block barriers and a block-wide sum with 100 of 256 threads
// busy in step C (~1,900 cycles a block-sweep, 2-3 blocks an SM); and the
// bf16 operands were widened to f32 in registers before every FMA, so B
// in bf16 saved nothing but bytes of the gather.
//
// Design.  The bf16 mode's arithmetic is a tensor core's: bf16 operands
// (B, the rounded expEtheta, the rounded ratio), exact products, f32 sums.
//   - A CTA holds kGroups warp groups of kGroupWarps warps; each group
//     takes its rows from the device queue itself and synchronises on its
//     own named barrier (bar.sync 1 + group, 128 threads), never on the
//     block's.  Two CTAs an SM at the flagships: 4 rows in flight an SM
//     (2-3 before).
//   - A group compacts its row's live entries (in column/slot order) and
//     copies their bf16 B rows once a row into its slots by 16-byte
//     cp.async: a slot is K rounded up to 16 topics plus one 16-byte pad,
//     an odd number of 16-byte units, so the 8 rows of an ldmatrix phase
//     fall on 8 distinct bank quads.  Units past ldb and the slots up to a
//     whole 16-entry tile are zeroed.  B stays bf16 there.
//   - Warp w owns the 16-entry tiles w, w + 4, w + 8 of the row (at most
//     kGroupTiles; whether it has each is a warp vote, so the compiler
//     knows the branches around the warp-wide ldmatrix and mma are
//     uniform and adds no reconvergence around them).
//     Step A: phinorm of 16 entries is mma.sync m16n8k16 (bf16 operands,
//     f32 sums) of the tile's B rows (ldmatrix.x4) times a column holding
//     the rounded expEtheta, accumulated over the 16-topic tiles in topic
//     order.  The ratio cnt / (phinorm + eps) is rounded to bf16 in the
//     lane that holds phinorm and handed to the lanes of the next
//     product's operand by two shuffles.  Step B: the warp's share of
//     sum_t ratio[t] B[t, k] is mma.sync of the tile's B rows transposed
//     (ldmatrix.x4.trans: 16 topics x 16 entries) times a column holding
//     the ratios, accumulated over the warp's tiles in order, two topic
//     tiles at a time with their fragments loaded first; one output
//     column of 8 is used in both steps.
//   - Step C: thread k of the group owns topics k and k + 128; it sums the
//     four warps' partials in warp order, forms gamma' = alpha +
//     expEtheta * acc (and its digamma tail while the sums are pending),
//     and the group sums |dgamma| and gamma' by warp shuffles and one
//     exchange through shared memory; the new expEtheta
//     (row_fixed_point.cuh's expression, so the same bits from the same
//     gamma') goes to the owner's registers and, rounded, to the group's
//     shared copy.  Three named barriers a sweep, no block barrier.  (A
//     copy of step C in every warp, one barrier a sweep, was slower: 4x
//     its digamma series.)
//   - Phase 1's not-exitable counts go to the device array directly (one
//     atomic a row-sweep that is not exitable, from one thread), so groups
//     on different segments need no shared histogram; the grid sync that
//     follows orders them before every S* is read.  (Taking the atomics
//     out did not move the time.)
//   - Every sum runs in one fixed order (the mma's, then warp order), so
//     two calls give the same bits.
// What bounds it (PERF.md, scripts/torch_gamma_group_clocks.py): neither
// the tensor cores nor the 4 K FLOP a live entry a sweep; a row-sweep is
// ~5,000 cycles of one group at 4 rows an SM, the steps in turn: the B
// tiles' ldmatrix and mma chains of steps A and B (each B tile read from
// shared memory twice a sweep), the ratios, and step C's digamma series
// and group sums between three barriers.  Only 1 column in 8 of each mma
// is used: a sweep is a matrix-vector product per row.

#pragma once

#include "cluster_ptx.cuh"
#include "row_fixed_point.cuh"

namespace {

// A warp group (a row), groups a CTA, and the CTA's threads.
constexpr int kGroupWarps = 4;
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kGroups = 2;
constexpr int kGroupCtaThreads = kGroups * kGroupThreads;
// Largest K (thread k owns topics k and k + kGroupThreads) and most live
// entries a group holds (16-entry tiles a warp: kGroupTiles).
constexpr int kGroupMaxTopics = 256;
constexpr int kGroupMaxSlots = 192;
constexpr int kGroupTiles = kGroupMaxSlots / 16 / kGroupWarps;

// A group's shared memory (byte offsets, each a multiple of 16) for K
// topics and `slots` entries (a multiple of 16): the slots (row16 16-byte
// units each), the rounded expEtheta (16 kt bf16), step B's partials of
// each warp ([kGroupWarps][16 kt] f32), the compacted counts and ids, the
// scan, the sums and the row slot.
struct GroupLayout {
  int kt, row16, b, etr, part, cnt, ids, scan, red, flags, total;
  __host__ __device__ GroupLayout(int K, int slots) {
    kt = (K + 15) / 16;
    row16 = 2 * kt + 1;
    b = 0;
    etr = b + slots * row16 * 16;
    part = etr + kt * 32;
    cnt = part + kGroupWarps * kt * 64;
    ids = cnt + slots * 4;
    scan = ids + slots * 4;
    red = scan + kGroupWarps * 4;
    flags = red + kGroupWarps * 8;
    total = flags + 16;
  }
};

__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "n"(kGroupThreads)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 16, row major) * b (16 x 8, column major), bf16 operands,
// f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lo and hi rounded to bf16 (nearest even), lo in the lower half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Exclusive prefix sum of v over the group; *total gets the group's sum.
__device__ __forceinline__ int group_excl_scan(int v, int* scan_s, int* total,
                                               int group) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32 % kGroupWarps;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) scan_s[warp] = x;
  group_sync(group);
  int pre = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < kGroupWarps; ++w) {
    const int t = scan_s[w];
    pre += w < warp ? t : 0;
    tot += t;
  }
  group_sync(group);  // scan_s is rewritten by the next call
  *total = tot;
  return pre + x - v;
}

// Sum of a and b over the group (fixed order; every thread gets both).
__device__ __forceinline__ float2 group_sum2(float a, float b, float* red_s,
                                             int group) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(kFull, a, off);
    b += __shfl_xor_sync(kFull, b, off);
  }
  const int warp = threadIdx.x / 32 % kGroupWarps;
  if (threadIdx.x % 32 == 0) {
    red_s[warp] = a;
    red_s[kGroupWarps + warp] = b;
  }
  group_sync(group);
  float2 out = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kGroupWarps; ++w) {
    out.x += red_s[w];
    out.y += red_s[kGroupWarps + w];
  }
  return out;
}

// Next row of a device queue, broadcast to the group.
__device__ __forceinline__ int group_next_row(int* queue, int* flags,
                                              int group) {
  if (threadIdx.x % kGroupThreads == 0) flags[0] = atomicAdd(queue, 1);
  group_sync(group);
  const int row = flags[0];
  group_sync(group);
  return row;
}

// Compacts the live entries of `row`, in order, into the group's counts
// and ids; traps on a row of more than `slots` (the host's bound on the
// launch's rows was wrong).  Each thread reads one contiguous run of the
// row's first L entries.  Returns how many there are.
template <typename CT>
__device__ __forceinline__ int group_compact(const Params& p,
                                             const GroupLayout& L,
                                             unsigned char* smem, int group,
                                             int row, int slots) {
  const int gtid = threadIdx.x % kGroupThreads;
  const int per = (p.L + kGroupThreads - 1) / kGroupThreads;
  const int j0 = min(gtid * per, p.L);
  const int j1 = min(j0 + per, p.L);
  const CT* c = static_cast<const CT*>(p.cnts) + (size_t)row * p.ld;
  int mine = 0;
  for (int j = j0; j < j1; ++j) mine += to_float(c[j]) != 0.f;
  int total;
  int pos = group_excl_scan(mine, reinterpret_cast<int*>(smem + L.scan),
                            &total, group);
  if (total > slots) __trap();
  float* cnt_s = reinterpret_cast<float*>(smem + L.cnt);
  int* ids_s = reinterpret_cast<int*>(smem + L.ids);
  if (mine) {
    for (int j = j0; j < j1; ++j) {
      const float v = to_float(c[j]);
      if (v != 0.f) {
        cnt_s[pos] = v;
        ids_s[pos] = p.ids ? p.ids[(size_t)row * p.ld + j] : j;
        ++pos;
      }
    }
  }
  group_sync(group);
  return total;
}

// Copies the bf16 B rows of the n compacted entries into the slots, 16
// bytes a cp.async, and zeroes the units past ldb and the slots up to a
// whole tile of 16 (their ratios are 0, and 0 times a stale value must
// not be NaN).
__device__ __forceinline__ void group_gather(const Params& p,
                                             const GroupLayout& L,
                                             unsigned char* smem, int group,
                                             int n) {
  const int gtid = threadIdx.x % kGroupThreads;
  const int* ids_s = reinterpret_cast<const int*>(smem + L.ids);
  unsigned char* b_s = smem + L.b;
  const __nv_bfloat16* table = static_cast<const __nv_bfloat16*>(p.table);
  const int k8 = p.ldb / 8, units = 2 * L.kt, rs = 16 * L.row16;
  for (int i = gtid; i < n * k8; i += kGroupThreads) {
    const int e = i / k8, q = i - e * k8;
    __pipeline_memcpy_async(b_s + e * rs + 16 * q,
                            table + (size_t)ids_s[e] * p.ldb + 8 * q, 16);
  }
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if (units > k8)
    for (int e = gtid; e < n; e += kGroupThreads)
      *reinterpret_cast<uint4*>(b_s + e * rs + 16 * k8) = zero;
  const int pad = ((n + 15) & ~15) - n;
  for (int i = gtid; i < pad * units; i += kGroupThreads) {
    const int e = n + i / units, q = i % units;
    *reinterpret_cast<uint4*>(b_s + e * rs + 16 * q) = zero;
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  group_sync(group);
}

// Runs `row` from gamma0 for at most max_sweeps sweeps, stopping when it
// is done; writes its gamma.  In phase 1 (count) each sweep at which it is
// not exitable adds 1 to its segment's count.  Every thread of the group
// keeps the row's exit state (the group sums are the same in every
// thread, so all take the same decisions).
template <typename CT>
__device__ __forceinline__ RowRun group_run_row(const Params& p,
                                                const GroupLayout& L,
                                                unsigned char* smem, int group,
                                                int row, int max_sweeps,
                                                bool count) {
  const int gtid = threadIdx.x % kGroupThreads;
  const int warp = gtid / 32, lane = gtid % 32, g = lane >> 2, t = lane & 3;
  const int K = p.K, KT = L.kt;
  __nv_bfloat16* etr = reinterpret_cast<__nv_bfloat16*>(smem + L.etr);
  const unsigned* etr32 = reinterpret_cast<const unsigned*>(smem + L.etr);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* red = reinterpret_cast<float*>(smem + L.red);
  const size_t base = (size_t)row * K;
  // Thread gtid owns topics gtid and gtid + kGroupThreads: gamma, alpha
  // and the f32 expEtheta in registers; the rounded copy (zero past K, up
  // to 16 kt) in shared memory.
  float gam[2], alp[2], et[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int k = gtid + kGroupThreads * j;
    const bool mine = k < K;
    gam[j] = mine ? p.gamma0[base + k] : 0.f;
    alp[j] = mine ? p.alpha[k] : 0.f;
    et[j] = mine ? p.et0[base + k] : 0.f;
    if (k < 16 * KT) etr[k] = __float2bfloat16_rn(et[j]);
  }
  const int n = group_compact<CT>(p, L, smem, group, row, p.nmax);
  group_gather(p, L, smem, group, n);
  // The warp's tiles of 16 entries: warp + kGroupWarps i, i < nm.
  const int tiles = (n + 15) / 16;
  const int nm = warp < tiles ? (tiles - warp + kGroupWarps - 1) / kGroupWarps
                              : 0;
  const float* cnt_s = reinterpret_cast<const float*>(smem + L.cnt);
  // Whether the warp has its i-th tile, as a vote: the compiler then knows
  // the branches around the warp-wide ldmatrix and mma are uniform.
  bool on[kGroupTiles];
#pragma unroll
  for (int i = 0; i < kGroupTiles; ++i) on[i] = __all_sync(kFull, i < nm);
  // ldmatrix row addresses: step A reads a tile as 16 entries x 16 topics
  // (matrices: entries 0-7 / 8-15, then topics 8-15), step B transposed
  // (matrices: topics 0-7 / 8-15 of entries 0-7, then of entries 8-15).
  const int rs = 16 * L.row16;
  const uint32_t b_s = smem_u32(smem + L.b);
  const uint32_t a_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * rs +
                          (lane >> 4) * 16;
  const uint32_t t_lane = ((lane & 7) + (lane >> 4) * 8) * rs +
                          ((lane >> 3) & 1) * 16;
  const int seg = count ? segment_of(p, row) : 0;
  const bool freeze = p.threshold > 0.f;
  float best = __int_as_float(0x7f800000);
  int age = 0, first = 0;
  int s = 0;
  while (s < max_sweeps) {
    // A. phinorm of the warp's tiles, over the topic tiles in order.
    float ph[kGroupTiles][4];
#pragma unroll
    for (int i = 0; i < kGroupTiles; ++i)
      ph[i][0] = ph[i][1] = ph[i][2] = ph[i][3] = 0.f;
#pragma unroll 2
    for (int kt = 0; kt < KT; ++kt) {
      const unsigned e0 = etr32[8 * kt + t], e1 = etr32[8 * kt + 4 + t];
      unsigned a[kGroupTiles][4];
#pragma unroll
      for (int i = 0; i < kGroupTiles; ++i)
        if (on[i])
          ldmatrix_x4(a[i], b_s + 16 * (warp + kGroupWarps * i) * rs +
                                32 * kt + a_lane);
#pragma unroll
      for (int i = 0; i < kGroupTiles; ++i)
        if (on[i]) mma_bf16(ph[i], a[i], e0, e1);
    }
    // The rounded ratios of entries g and g + 8 (phinorm in columns 0 and
    // 2 of the lane's fragment), handed to the lanes of step B's operand:
    // lane (g, t) needs entries 2t, 2t + 1, 2t + 8 and 2t + 9.
    unsigned rb[kGroupTiles][2];
#pragma unroll
    for (int i = 0; i < kGroupTiles; ++i) {
      rb[i][0] = rb[i][1] = 0u;
      if (on[i]) {
        const int e = 16 * (warp + kGroupWarps * i) + g;
        const float c0 = e < n ? cnt_s[e] : 0.f;
        const float c1 = e + 8 < n ? cnt_s[e + 8] : 0.f;
        const float r0 = c0 != 0.f ? c0 / (ph[i][0] + p.eps) : 0.f;
        const float r1 = c1 != 0.f ? c1 / (ph[i][2] + p.eps) : 0.f;
        const unsigned pk = pack_bf16(r0, r1);
        const unsigned x = __shfl_sync(kFull, pk, 8 * t);
        const unsigned y = __shfl_sync(kFull, pk, 8 * t + 4);
        rb[i][0] = __byte_perm(x, y, 0x5410);
        rb[i][1] = __byte_perm(x, y, 0x7632);
      }
    }
    // B. The warp's partial sum_t ratio[t] B[t, k] of each topic tile,
    // two topic tiles at a time (their fragments loaded first).
    float* mine = part + 16 * KT * warp;
    for (int j = 0; j < KT; j += 2) {
      const bool two = j + 1 < KT;
      unsigned b0[kGroupTiles][4], b1[kGroupTiles][4];
#pragma unroll
      for (int i = 0; i < kGroupTiles; ++i)
        if (on[i]) {
          const uint32_t at = b_s + 16 * (warp + kGroupWarps * i) * rs +
                              32 * j + t_lane;
          ldmatrix_x4_trans(b0[i], at);
          if (two) ldmatrix_x4_trans(b1[i], at + 32);
        }
      float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kGroupTiles; ++i)
        if (on[i]) {
          mma_bf16(d0, b0[i], rb[i][0], rb[i][1]);
          if (two) mma_bf16(d1, b1[i], rb[i][0], rb[i][1]);
        }
      if (t == 0) mine[16 * j + g] = d0[0];
      if (t == 1) mine[16 * j + g + 8] = d0[2];
      if (two && t == 0) mine[16 * j + 16 + g] = d1[0];
      if (two && t == 1) mine[16 * j + 24 + g] = d1[2];
    }
    group_sync(group);
    // C. gamma' = alpha + expEtheta * acc for the thread's topics (and
    // its digamma tail, before the group's sums are in).
    float x[2], tail[2], dabs = 0.f, sum = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = gtid + kGroupThreads * j;
      x[j] = tail[j] = 0.f;
      if (k < K) {
        float a = part[k];
#pragma unroll
        for (int w = 1; w < kGroupWarps; ++w) a += part[16 * KT * w + k];
        x[j] = alp[j] + et[j] * a;
        dabs += fabsf(x[j] - gam[j]);
        sum += x[j];
        tail[j] = psi_tail(x[j]);
      }
    }
    const float2 sums = group_sum2(dabs, sum, red, group);
    const float rt = psi_row_term(sums.y);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = gtid + kGroupThreads * j;
      if (k < K) {
        gam[j] = x[j];
        et[j] = (x[j] + 2.0f) * expf(tail[j] - rt);
        etr[k] = __float2bfloat16_rn(et[j]);
      }
    }
    const float change = sums.x / (float)K;
    const bool improved = change < 0.99f * best;
    age = improved ? 0 : age + 1;
    best = fminf(best, change);
    const bool done = freeze && best <= p.threshold;
    const bool exitable = done || (p.use_stall && age >= p.patience);
    if (count && !exitable && gtid == 0)
      atomicAdd(&p.not_exitable[seg * p.inner_iterations + s], 1);
    if (exitable && !first) first = s + 1;
    ++s;
    group_sync(group);  // the rounded expEtheta is visible to every warp
    if (done) break;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int k = gtid + kGroupThreads * j;
    if (k < K) p.gamma[base + k] = gam[j];
  }
  return {s, first, n};
}

// The cooperative launch's two phases, as row_phases (row_fixed_point.cuh)
// runs them, with each group taking its own rows.
template <typename CT>
__global__ void __launch_bounds__(kGroupCtaThreads, 2)
row_fixed_point_groups_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const GroupLayout L(p.K, p.nmax);
  const int group = threadIdx.x / kGroupThreads;
  const int gtid = threadIdx.x % kGroupThreads;
  unsigned char* mine = reinterpret_cast<unsigned char*>(smem) +
                        (size_t)group * L.total;
  int* flags = reinterpret_cast<int*>(mine + L.flags);
  int S = p.inner_iterations, cur = -1;  // the group's segment and its S*
  unsigned long long slots = 0, extra = 0;
  for (int phase = 0; phase < 2; ++phase) {
    if (phase == 1) {
      cg::this_grid().sync();
      if (blockIdx.x == 0)
        for (int sg = threadIdx.x; sg < p.nseg; sg += kGroupCtaThreads)
          p.sweeps_out[sg] = s_star(p, sg);
    }
    for (int row; (row = group_next_row(&p.queues[phase], flags, group)) <
                  p.D;) {
      int sweeps = p.inner_iterations;
      if (phase == 1) {
        const int seg = segment_of(p, row);
        if (seg != cur) {
          S = s_star(p, seg);
          cur = seg;
        }
        const int run_len = __ldcg(&p.row_run[row]);
        if (gtid == 0) {
          const int needed = min(run_len, S);
          slots += (unsigned long long)__ldcg(&p.row_nnz[row]) * needed;
          if (run_len > S) extra += run_len;
          if (p.row_sweeps) p.row_sweeps[row] += needed;
        }
        if (run_len <= S) continue;
        sweeps = S;
      }
      const RowRun r = group_run_row<CT>(p, L, mine, group, row, sweeps,
                                         phase == 0);
      if (phase == 0 && gtid == 0) {
        p.row_run[row] = r.sweeps;
        p.row_nnz[row] = r.nnz;
        if (p.row_exit) p.row_exit[row] = r.first_exit;
      }
    }
  }
  if (gtid == 0) {
    if (p.slots_out && slots) atomicAdd(p.slots_out, slots);
    if (p.extra_out && extra) atomicAdd(p.extra_out, extra);
  }
}

// Launches the warp-group kernel cooperatively with p.group_slots slots a
// group (a multiple of 16, at most kGroupMaxSlots; the host's plan sizes
// it from the launch's widest row): as many CTAs as fit on the card at
// once, at most one a kGroups rows.  Writes back nmax and resident (the
// slots a group) and the geometry.
template <typename CT>
cudaError_t launch_row_fixed_point_groups(Params& p, cudaStream_t stream) {
  const int slots = p.group_slots;
  if (p.D < 1 || p.K < 1 || p.K > kGroupMaxTopics || p.inner_iterations < 1 ||
      p.L < 0 || p.L > p.ld || p.table_bf16 != 1 ||
      p.ldb != 8 * ((p.K + 7) / 8) || slots < 16 || slots > kGroupMaxSlots ||
      slots % 16 != 0 || p.nseg < 1 || (!p.seg && p.nseg != 1))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)kGroups * GroupLayout(p.K, slots).total;
  auto kern = row_fixed_point_groups_kernel<CT>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, kGroupCtaThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  int grid = per_sm * sms;
  const int needed = (p.D + kGroups - 1) / kGroups;
  if (needed < grid) grid = needed;
  p.nmax = slots;
  p.nhist = 0;
  p.resident = slots;
  p.smem_bytes = (int)smem;
  p.blocks_per_sm = per_sm;
  p.grid = grid;
  p.tile = p.K;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid),
                                    dim3(kGroupCtaThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
