// The gamma fixed point at K <= kMaxTopics for rows past one block's slot
// buffer (sm_90a): the entry kernel of both entries, ragged_gamma.cu and
// dense_gamma.cu, and the dispatch of a launch to it, to the row-resident
// kernels of row_fixed_point.cuh or to the cluster kernel above kMaxTopics
// (launch_gamma).  The function, the exit rule, the segments, the
// row-major order (phase 1, each segment's S*, the phase-2 re-run of rows
// past it) and the outputs are row_fixed_point.cuh's.
//
// What bounds it.  The wide kernels' slot buffer is half an SM's shared
// memory: 25 entries at K = 1000 (bf16: 49), 4 at K = 4096.  A row with
// more live entries streams: each sweep re-gathers every live entry's
// expElogbeta^T row from device memory (at SVI config 5, K = 1000, V =
// 100k, the 400 MB table does not fit the L2), ~1.23 GB a sweep over a
// minibatch at ~2.2 TB/s.  No SM holds such a row (150-208 entries x 4 KB
// = 0.6-0.83 MB), but a few SMs together do.
//
// Design: one thread-block cluster a row, its live entries split across
// the CTAs and resident for all of the row's sweeps.
//   - C = p.cluster CTAs (1..16; ops/row_fixed_point.py::gamma_plan takes
//     the smallest power of two whose CTAs hold the launch's widest row in
//     ~200 KB of shared memory each, one CTA an SM) sweep one row.  CTA r
//     holds the live entries [r E, (r + 1) E) of the row, E = p.resident,
//     in entry order, in its slot buffer (row_fixed_point.cuh's wide
//     Layout with nmax = E), and the row's whole K-topic state: expEtheta,
//     its rounded copy (bf16), gamma.
//   - The entries' B rows are copied once a row (once a call for the rows
//     of phase 1), one cp.async.bulk of ldb elements an entry, completing
//     on an mbarrier; rank 0 compacts the row into the cluster's list in
//     device memory and hands it over (cluster_phases of
//     row_fixed_point_tiled.cuh, shared with the cluster kernel).
//   - Phinorm needs no exchange: each CTA forms phinorm and the ratio of
//     its own entries against its full expEtheta (entry_ratios: a warp a
//     chunk of the topics, a lane an entry, no butterfly), and step B over
//     its entries into K partial sums (slot_sums, the wide kernels' code;
//     bf16: entry_sums).  In the bf16 builds, where rounding the ratio and
//     expEtheta to bf16 turns f32 rounding into flips, both sums are kept
//     short (a unit's 8 products as a tree, then four running sums in
//     turn; four chains of slots) and expEtheta is formed in double and
//     rounded once (expectation): one pinned sweep then matches the plain
//     version on every row (PERF.md).
//   - One reduce-scatter, one exchange of two sums and one all-gather a
//     sweep, through distributed shared memory: rank r owns the topics
//     [r Ks, (r + 1) Ks), Ks = p.slice (a multiple of 4).  Each CTA sends
//     each float4 of its partial sums to its owner (st.async onto the
//     owner's mbarrier); the owner sums the C partials of its slice in
//     rank order 0..C-1, forms gamma' on it (which only it keeps), and
//     sends its (|dgamma|, gamma') sums to every rank; every rank sums the
//     C pairs in rank order, so all take the same exit decision; the
//     owner forms expEtheta on its slice, as the row-resident kernels form
//     it, and sends it to every rank (the all-gather), and each rounds its
//     copy (bf16).  The receive buffers are C Ks ~ K floats of partials,
//     C pairs and expEtheta itself, whatever C is; no float atomics, so
//     two calls give the same bits.  (expEtheta needs the row's sum of
//     gamma', so the pairs come first.  Forming expEtheta over all K in
//     every CTA would spare that exchange but cost each CTA the digamma
//     series of every topic; sending u = (gamma' + 2) exp(psi_tail) with
//     the pairs and scaling by exp(-row term) after would spare it too,
//     but rounds expEtheta otherwise than the plain version, and at
//     K = 4096 that drift passed the 1e-4 bar of 12 pinned sweeps:
//     PERF.md.)
//   - No cluster barrier within a row.  A rank sends the partials of
//     sweep s + 1 only after it has all of expEtheta of sweep s, which
//     each owner sends after it has every pair of sweep s, which each rank
//     sends after reading its partials of sweep s; so a buffer is written
//     again only after it was read, and each mbarrier completes one phase
//     a sweep.
// The launch: cooperative, with the cluster dimension (launch_clusters),
// as many clusters as fit on the card at once.  The launcher writes back
// the cluster width, the entries a CTA (resident), the clusters in flight
// and the shared memory a CTA.

#pragma once

#include "row_fixed_point_groups.cuh"
#include "row_fixed_point_tiled.cuh"

namespace {

// Slots a batch of step A sums at once: its chunk sums are [kWarps]
// [kDotSlots] floats of shared memory (EntryLayout.dots).
constexpr int kDotSlots = 128;

// A CTA's shared memory, in floats: the wide Layout of row_fixed_point.cuh
// with nmax = the entries a CTA holds (its slot buffer, et, etr, gam,
// part, ratio, cnt, ids, hist, scan, red, flags), then the partials of
// this rank's slice from each rank ([C][slice]), the C (|dgamma|, gamma')
// pairs, step A's chunk sums ([kWarps][kDotSlots]), the two row slots of
// cluster_phases (8 ints) and four mbarriers (the entries' copies, the
// partials, the pairs, the gathered expEtheta).
// ops/row_fixed_point.py::entry_smem_bytes mirrors it.
struct EntryLayout {
  Layout base;
  int recv, pairs, dots, slots, bars, total;
  __host__ __device__ EntryLayout(int K, int share, int slice, int C,
                                  int nhist, bool bf16)
      : base(K, share, nhist, true, bf16) {
    recv = base.total;
    pairs = recv + C * slice;
    dots = pairs + ((2 * C + 3) & ~3);
    slots = dots + kWarps * kDotSlots;
    bars = slots + 8;
    total = bars + 8;
  }
};

// The expEtheta operand of 16-byte unit u in step A: one float4 (f32) or
// two (bf16: the rounded copy etr, 8 topics).
struct UnitE {
  float4 lo, hi;
};

template <bool kBf16>
__device__ __forceinline__ UnitE unit_e(const Layout& L, const float* smem,
                                        int u) {
  if constexpr (kBf16) {
    const float4* e4 = reinterpret_cast<const float4*>(smem + L.etr);
    return {e4[2 * u], e4[2 * u + 1]};
  } else {
    return {reinterpret_cast<const float4*>(smem + L.et)[u],
            make_float4(0.f, 0.f, 0.f, 0.f)};
  }
}

// Adds unit u of slot row `row` times e into the four running sums a:
// f32, a topic into each; bf16, the unit's 8 products (each exact in f32:
// bf16 times bf16) summed as a tree into a[i] (the caller turns i over
// the units), so that phinorm's sum, whose rounding the ratio's bf16
// rounding turns into flips, stays short.
template <bool kBf16>
__device__ __forceinline__ void unit_dot(const float* row, int u,
                                         const UnitE& e, float (&a)[4],
                                         int i = 0) {
  if constexpr (kBf16) {
    const uint4 b = reinterpret_cast<const uint4*>(row)[u];
    a[i] += ((bf16_lo(b.x) * e.lo.x + bf16_hi(b.x) * e.lo.y) +
             (bf16_lo(b.y) * e.lo.z + bf16_hi(b.y) * e.lo.w)) +
            ((bf16_lo(b.z) * e.hi.x + bf16_hi(b.z) * e.hi.y) +
             (bf16_lo(b.w) * e.hi.z + bf16_hi(b.w) * e.hi.w));
  } else {
    const float4 b = reinterpret_cast<const float4*>(row)[u];
    a[0] = fmaf(b.x, e.lo.x, a[0]);
    a[1] = fmaf(b.y, e.lo.y, a[1]);
    a[2] = fmaf(b.z, e.lo.z, a[2]);
    a[3] = fmaf(b.w, e.lo.w, a[3]);
  }
}

// Step A of the entry kernel: phinorm and the ratio of each of the CTA's
// m slots.  The row's 16-byte units (4 f32 or 8 bf16 topics) are split
// into kWarps chunks; warp w sums its chunk for the slots of a batch, a
// lane a slot (two at a time), so the lanes of a quarter warp read one
// unit of 8 consecutive slot rows, an odd number of units apart (no bank
// conflict), against expEtheta read once a unit for the warp (a
// broadcast).  Each lane keeps four running sums, (a0 + a1) + (a2 + a3);
// the kWarps chunk sums of a slot meet in dots, in chunk order, and
// thread t forms its ratio (bf16: rounded where it is stored).
template <bool kBf16>
__device__ __forceinline__ void entry_ratios(const Params& p, const Layout& L,
                                             float* smem, float* dots,
                                             int m) {
  float* ratio_s = smem + L.ratio;
  const float* cnt_s = smem + L.cnt;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int units = kBf16 ? L.k8 : L.k4;
  const int per = (units + kWarps - 1) / kWarps;
  const int u0 = min(units, warp * per), u1 = min(units, u0 + per);
  const int stride = kBf16 ? L.s8 * 4 : L.s4 * 4;  // floats a slot row
  const float* b = smem + L.b;
  for (int t0 = 0; t0 < m; t0 += kDotSlots) {
    for (int j = lane; j < kDotSlots && t0 + j - lane < m; j += 64) {
      // Slots t0 + j and t0 + j + 32 (rows past m read the last slot's;
      // their sums are not used).
      const float* ra = b + (size_t)min(t0 + j, m - 1) * stride;
      const float* rb = b + (size_t)min(t0 + j + 32, m - 1) * stride;
      float a[4] = {0.f, 0.f, 0.f, 0.f}, c[4] = {0.f, 0.f, 0.f, 0.f};
      int u = u0;
      for (; u + 3 < u1; u += 4) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const UnitE e = unit_e<kBf16>(L, smem, u + i);
          unit_dot<kBf16>(ra, u + i, e, a, i);
          unit_dot<kBf16>(rb, u + i, e, c, i);
        }
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (u + i < u1) {
          const UnitE e = unit_e<kBf16>(L, smem, u + i);
          unit_dot<kBf16>(ra, u + i, e, a, i);
          unit_dot<kBf16>(rb, u + i, e, c, i);
        }
      }
      dots[warp * kDotSlots + j] = (a[0] + a[1]) + (a[2] + a[3]);
      dots[warp * kDotSlots + j + 32] = (c[0] + c[1]) + (c[2] + c[3]);
    }
    __syncthreads();
    for (int j = tid; j < kDotSlots && t0 + j < m; j += kThreads) {
      float ph = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) ph += dots[w * kDotSlots + j];
      const float r = cnt_s[t0 + j] / (ph + p.eps);
      ratio_s[t0 + j] = kBf16 ? bf16_round(r) : r;
    }
    __syncthreads();
  }
}

// psi_tail (exp_psi.cuh) in double: the bf16 builds form expEtheta from
// the series in double and round once to f32, where the f32 series
// rounds several times, so its bf16 copy that step A reads crosses a
// rounding midpoint less often.
__device__ __forceinline__ double psi_tail_d(double v) {
  const double y = v + 2.0;
  const double inv = 1.0 / y;
  const double inv2 = inv * inv;
  const double t = -0.5 * inv -
      inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 * (1.0 / 252.0)));
  return t - 1.0 / v - 1.0 / (v + 1.0);
}

// expEtheta of a topic of gamma' x in a row whose sum of gamma' is tot:
// f32, the row-resident kernels' arithmetic (rterm = psi_row_term(tot));
// bf16, the same series in double (rterm_d = log(tot + 2) +
// psi_tail_d(tot)), rounded once.
template <bool kBf16>
__device__ __forceinline__ float expectation(float x, float rterm,
                                             double rterm_d) {
  if constexpr (kBf16) {
    const double y = x;
    return (float)((y + 2.0) * exp(psi_tail_d(y) - rterm_d));
  } else {
    return (x + 2.0f) * expf(psi_tail(x) - rterm);
  }
}

// Step B of the bf16 entry kernel: slot_sums over the CTA's n slots with
// each thread's sums in four chains (slots g + G i, i mod 4, summed as
// (c0 + c1) + (c2 + c3)): the products of the rounded ratio and B are
// exact, so the sum's length sets gamma's rounding, which the next
// sweep's rounded expEtheta turns into flips.
__device__ __forceinline__ void entry_sums(const Layout& L, const float* smem,
                                           int n, float4 (&acc)[kWideQ]) {
  const float* ratio_s = smem + L.ratio;
  const int tid = threadIdx.x, k4 = L.k4, G = L.groups;
#pragma unroll
  for (int j = 0; j < kWideQ; ++j) {
    const int idx = tid + kThreads * j;
    const int q = idx % k4, g = idx / k4;
    if (g >= G) continue;
    float4 c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    int t = g;
    for (; t + 3 * G < n; t += 4 * G) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float r = ratio_s[t + i * G];
        const float4 b = slot4<true>(smem + L.b, L, t + i * G, q);
        c[i].x = fmaf(b.x, r, c[i].x);
        c[i].y = fmaf(b.y, r, c[i].y);
        c[i].z = fmaf(b.z, r, c[i].z);
        c[i].w = fmaf(b.w, r, c[i].w);
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (t + i * G < n) {
        const float r = ratio_s[t + i * G];
        const float4 b = slot4<true>(smem + L.b, L, t + i * G, q);
        c[i].x = fmaf(b.x, r, c[i].x);
        c[i].y = fmaf(b.y, r, c[i].y);
        c[i].z = fmaf(b.z, r, c[i].z);
        c[i].w = fmaf(b.w, r, c[i].w);
      }
    }
    acc[j] = make_float4((c[0].x + c[1].x) + (c[2].x + c[3].x),
                         (c[0].y + c[1].y) + (c[2].y + c[3].y),
                         (c[0].z + c[1].z) + (c[2].z + c[3].z),
                         (c[0].w + c[1].w) + (c[2].w + c[3].w));
  }
}

// Runs `row` (n live entries in the cluster's list ids_g) from gamma0 for
// at most max_sweeps sweeps, stopping when it is done; writes this CTA's
// slice of its gamma.  Every CTA of the cluster runs it with the same
// arguments and takes the same decisions.  In phase 1 (count) the rank-0
// CTA adds the row's not-exitable sweeps to its histogram.  parity: the
// parity bits of the four mbarriers' next phases, kept across rows.
template <bool kBf16>
__device__ __forceinline__ RowRun run_row_entries(
    const Params& p, const EntryLayout& E, float* smem, int rank,
    uint32_t& parity, const int* ids_g, int row, int n, int max_sweeps,
    bool count) {
  const Layout& L = E.base;
  const int tid = threadIdx.x, K = p.K, C = p.cluster;
  float* et_s = smem + L.et;
  float* gam_s = smem + L.gam;
  const float* recv = smem + E.recv;
  const float2* pairs = reinterpret_cast<const float2*>(smem + E.pairs);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + E.bars);
  int* hist_s = reinterpret_cast<int*>(smem + L.hist);
  // The host bounds every row by the cluster's entries (gamma_plan).
  if (n > C * p.resident) __trap();
  // This CTA's entries [t0, t0 + m), their B rows one bulk copy each.
  const int t0 = min(n, rank * p.resident);
  const int m = min(n, t0 + p.resident) - t0;
  const int elem = kBf16 ? 2 : 4;
  const uint32_t bytes = (uint32_t)(p.ldb * elem);
  if (tid < 32 && m > 0) {
    if (tid == 0) mbar_expect_tx(&bars[0], (uint32_t)m * bytes);
    __syncwarp();
    for (int i = tid; i < m; i += 32)
      bulk_load(smem + L.b + (size_t)i * L.slot,
                static_cast<const unsigned char*>(p.table) +
                    (size_t)__ldcg(ids_g + t0 + i) * bytes,
                bytes, &bars[0]);
  }
  const float* cnt_g = reinterpret_cast<const float*>(ids_g + p.L);
  for (int i = tid; i < m; i += kThreads)
    smem[L.cnt + i] = __ldcg(cnt_g + t0 + i);
  const size_t base = (size_t)row * K;
  for (int k = tid; k < L.s4 * 4; k += kThreads) {
    et_s[k] = k < K ? p.et0[base + k] : 0.f;
    gam_s[k] = k < K ? p.gamma0[base + k] : 0.f;
  }
  if constexpr (kBf16)
    for (int k = tid; k < L.k8 * 8; k += kThreads)
      smem[L.etr + k] = k < K ? bf16_round(p.et0[base + k]) : 0.f;
  if (m > 0) {
    mbar_wait(&bars[0], parity & 1u);
    parity ^= 1u;
  }
  __syncthreads();  // the row's state and entries are in place
  // The topics this rank owns: [k0, k1), a whole number of float4s.
  const int k0 = rank * p.slice, k1 = min(K, k0 + p.slice);
  const int sq = p.slice / 4;
  const int own4 = max(0, min(L.k4, rank * sq + sq) - rank * sq);
  float4* part4 = reinterpret_cast<float4*>(smem + L.part);
  const bool freeze = p.threshold > 0.f;
  float best = __int_as_float(0x7f800000);
  int age = 0, first = 0;
  int s = 0;
  while (s < max_sweeps) {
    // A and B over this CTA's entries.
    float4 acc[kWideQ];
#pragma unroll
    for (int j = 0; j < kWideQ; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m) {
      entry_ratios<kBf16>(p, L, smem, smem + E.dots, m);
      if constexpr (kBf16)
        entry_sums(L, smem, m, acc);  // B
      else
        slot_sums<kWideQ, false, 4>(L, smem, m, acc);  // B
    }
#pragma unroll
    for (int j = 0; j < kWideQ; ++j) {
      const int idx = tid + kThreads * j;
      const int q = idx % L.k4, g = idx / L.k4;
      if (g < L.groups) part4[g * L.k4 + q] = acc[j];
    }
    __syncthreads();
    float tot_abs = 0.f, tot = 0.f;
    if (C == 1) {
      // One CTA a row: step C in place, the sums and the order of the
      // exchange below without it (the same bits).
      float dabs = 0.f, sum = 0.f;
      const float* part = smem + L.part;
      for (int k = tid; k < K; k += kThreads) {
        float a = part[k];
        for (int g = 1; g < L.groups; ++g) a += part[g * L.k4 * 4 + k];
        const float x = __ldg(p.alpha + k) + et_s[k] * a;
        dabs += fabsf(x - gam_s[k]);
        sum += x;
        gam_s[k] = x;
      }
      const float2 mine = block_sum2(dabs, sum, smem + L.red);
      tot_abs = mine.x;
      tot = mine.y;
      const float rterm = psi_row_term(tot);
      const double rterm_d = kBf16 ? log((double)tot + 2.0) + psi_tail_d(tot)
                                   : 0.0;
      for (int k = tid; k < K; k += kThreads) {
        et_s[k] = expectation<kBf16>(gam_s[k], rterm, rterm_d);
        if constexpr (kBf16) smem[L.etr + k] = bf16_round(et_s[k]);
      }
    } else {
      // The reduce-scatter: each float4 of the partial sums (its groups
      // summed in order) to its owner's row of this rank.
      if (tid == 0) mbar_expect_tx(&bars[1], (uint32_t)(C * own4 * 16));
      for (int q = tid; q < L.k4; q += kThreads) {
        float4 a = part4[q];
        for (int g = 1; g < L.groups; ++g) {
          const float4 b = part4[g * L.k4 + q];
          a.x += b.x;
          a.y += b.y;
          a.z += b.z;
          a.w += b.w;
        }
        const int r = q / sq;
        const int to = E.recv + 4 * (rank * sq + q - r * sq);
        st_async(mapa(smem_u32(smem + to), r), a,
                 mapa(smem_u32(&bars[1]), r));
      }
      mbar_wait(&bars[1], (parity >> 1) & 1u);
      parity ^= 2u;
      // gamma' on the slice, a topic a thread: the ranks' partials summed
      // in rank order; its (|dgamma|, gamma') sums (topic order a thread,
      // then the block) to every rank's pairs.
      if (tid == 0) mbar_expect_tx(&bars[2], (uint32_t)(C * 8));
      float dabs = 0.f, sum = 0.f;
      for (int k = k0 + tid; k < k1; k += kThreads) {
        float a = 0.f;
        for (int r = 0; r < C; ++r) a += recv[r * p.slice + k - k0];
        const float x = __ldg(p.alpha + k) + et_s[k] * a;
        dabs += fabsf(x - gam_s[k]);
        sum += x;
        gam_s[k] = x;
      }
      const float2 mine = block_sum2(dabs, sum, smem + L.red);
      if (tid < C)
        st_async(mapa(smem_u32(pairs + rank), tid), mine,
                 mapa(smem_u32(&bars[2]), tid));
      mbar_wait(&bars[2], (parity >> 2) & 1u);
      parity ^= 4u;
      for (int r = 0; r < C; ++r) {
        tot_abs += pairs[r].x;
        tot += pairs[r].y;
      }
      // expEtheta on the slice, a topic a thread, as the row-resident
      // kernels form it; its float4s to every rank's et (the all-gather),
      // and every rank rounds its copy (bf16).
      if (tid == 0) mbar_expect_tx(&bars[3], (uint32_t)(L.k4 * 16));
      const float rterm = psi_row_term(tot);
      const double rterm_d = kBf16 ? log((double)tot + 2.0) + psi_tail_d(tot)
                                   : 0.0;
      for (int k = k0 + tid; k < k1; k += kThreads)
        et_s[k] = expectation<kBf16>(gam_s[k], rterm, rterm_d);
      __syncthreads();
      for (int q = tid; q < own4; q += kThreads) {
        const uint32_t from = smem_u32(et_s + k0 + 4 * q);
        const float4 e = reinterpret_cast<const float4*>(et_s + k0)[q];
        for (int r = 0; r < C; ++r)
          st_async(mapa(from, r), e, mapa(smem_u32(&bars[3]), r));
      }
      mbar_wait(&bars[3], (parity >> 3) & 1u);
      parity ^= 8u;
      if constexpr (kBf16)
        for (int k = tid; k < K; k += kThreads)
          smem[L.etr + k] = bf16_round(et_s[k]);
    }
    const float change = tot_abs / (float)K;
    const bool improved = change < 0.99f * best;
    age = improved ? 0 : age + 1;
    best = fminf(best, change);
    const bool done = freeze && best <= p.threshold;
    const bool exitable = done || (p.use_stall && age >= p.patience);
    if (count && !exitable && rank == 0 && tid == 0)
      count_not_exitable(p, hist_s, row, s);
    if (exitable && !first) first = s + 1;
    ++s;
    __syncthreads();  // et (and etr) are visible to every thread
    if (done) break;
  }
  for (int k = k0 + tid; k < k1; k += kThreads) p.gamma[base + k] = gam_s[k];
  __syncthreads();  // the next row rewrites the state
  return {s, first, n};
}

// The entry kernel: cluster_phases with a row run by run_row_entries.
template <typename CT, bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
row_fixed_point_entry_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const EntryLayout E(p.K, p.resident, p.slice, p.cluster, p.nhist, kBf16);
  const int rank = (int)cg::this_cluster().block_rank();
  int* ids_g = p.lists + (size_t)(blockIdx.x / p.cluster) * 2 * p.L;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + E.bars);
  if (threadIdx.x == 0) {
    for (int b = 0; b < 4; ++b) mbar_init(&bars[b], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  uint32_t parity = 0u;
  cluster_phases<CT>(
      p, rank, ids_g, reinterpret_cast<int*>(smem + E.base.hist),
      reinterpret_cast<int*>(smem + E.base.flags),
      reinterpret_cast<int*>(smem + E.slots),
      reinterpret_cast<int*>(smem + E.base.scan),
      [&](int row, int n, int sweeps, bool count) {
        return run_row_entries<kBf16>(p, E, smem, rank, parity, ids_g, row, n,
                                      sweeps, count);
      });
}

// Launches the entry kernel with the plan in p (cluster; resident: the
// entries a CTA holds; slice: the topics a rank owns), as many clusters as
// fit on the card at once, at most one a row and at most list_blocks.
template <typename CT, bool kBf16>
cudaError_t launch_row_fixed_point_entries(Params& p, cudaStream_t stream) {
  const int unit = kBf16 ? 8 : 4;  // topics a 16-byte copy of a table row
  const int k4 = (p.K + 3) / 4;
  if (p.D < 1 || p.K < 1 || p.K > kMaxTopics || p.inner_iterations < 1 ||
      p.L < 0 || p.L > p.ld || p.table_bf16 != (int)kBf16 ||
      p.ldb != unit * ((p.K + unit - 1) / unit) || !p.lists ||
      p.list_blocks < 1 || p.nseg < 1 || (!p.seg && p.nseg != 1) ||
      p.cluster < 1 || p.cluster > kMaxCluster || p.resident < 1 ||
      p.slice < 4 || p.slice % 4 || p.slice * p.cluster < 4 * k4 ||
      p.window != 0 || p.state)
    return cudaErrorInvalidValue;
  p.nhist = min(p.inner_iterations, kMaxHist);
  p.nmax = 0;
  const size_t smem =
      sizeof(float) * (size_t)EntryLayout(p.K, p.resident, p.slice,
                                          p.cluster, p.nhist, kBf16)
                          .total;
  p.windows = 1;
  p.tile = p.K;
  return launch_clusters(row_fixed_point_entry_kernel<CT, kBf16>, p, smem,
                         p.list_blocks, stream);
}

// The launch for any K: in the bf16 builds the warp-group kernel where the
// host's plan set a group's slots (K <= 256, the launch's widest row fits
// them); above kMaxTopics the cluster kernel; up to it the entry kernel
// where the host's plan set a cluster width (the launch's widest row is
// past one block's slot buffer), else the row-resident kernels (a row past
// the slot buffer streams).
template <typename CT, bool kBf16>
cudaError_t launch_gamma(Params& p, bool registers, cudaStream_t stream) {
  if (p.group_slots > 0) {
    if constexpr (kBf16) return launch_row_fixed_point_groups<CT>(p, stream);
    return cudaErrorInvalidValue;
  }
  if (p.K > kMaxTopics)
    return launch_row_fixed_point_cluster<CT, kBf16>(p, stream);
  if (p.cluster > 0)
    return launch_row_fixed_point_entries<CT, kBf16>(p, stream);
  return launch_row_fixed_point<CT, kBf16>(p, registers, stream);
}

}  // namespace
