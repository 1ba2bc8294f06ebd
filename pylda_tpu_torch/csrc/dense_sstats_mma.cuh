// The bf16 dense sufficient statistics at K <= 256 on tensor cores
// (sm_90a): the kernel of dense_sstats.cu's bf16 build (-DPYLDA_BF16=1) for
// every launch at K <= 256, full range or topic range, bf16 or f32 counts.
// It replaces, in bf16, pylda_tpu/ops/pallas_sstats.py:114
// (pallas_dense_sstats, whose tile kernel, :43-76, does both products on
// the MXU with preferred_element_type=f32), as the one-pass column walk of
// dense_sstats.cu did before it.  The float32 build keeps the walk.
//
// The function is estep_dense_sstats(compute_dtype="bfloat16"):
//   phinorm = rnd(Etheta) rnd(Ebeta) + eps          [D, Vc]
//   raw     = rnd(Etheta)^T rnd(C / phinorm)         [K, Vc]
//   sstats  = Ebeta (f32) * raw                      (v < V)
//   score   = sum C log(phinorm)
// with rnd the rounding to bf16 (nearest even): bf16 products summed in
// f32, which is what mma.sync m16n8k16 computes.
//
// What bounded the walk.  At K <= 256 the counts chunk is dense storage,
// so any kernel reads all of it; the walk did 4 K FLOP a nonzero on 4
// lanes a column, rounding every operand it read, in a latency-bound chain
// of barriers and L2 gathers (0.329 ms at the ragged flagship's
// [4096 x 10240] chunk, K = 100, against 0.028 ms to read it).  Both
// products done densely cost 4 D Vc Kp FLOP: 2 Kp FLOP a count byte, 224
// at K = 100 (Kp 112) and 512 at K = 256, about the card's bf16 ridge (989
// TFLOP/s over 3.35 TB/s, ~295).  At the flagship chunk that is 18.8
// GFLOP, 0.019 ms at the tensor-core peak, below the read's 0.028: with
// both products on tensor cores the dense form costs about the read, and
// needs no sparsity bookkeeping.
//
// Design.  Grid: (vocab tiles of kMmaTileV = 64 columns) x (row splits,
// ops/sstats.py::mma_plan).  A CTA of 8 warps:
//   0. Before it, one small launch a call rounds expEtheta to bf16 once,
//      [D, Kp] (Kp = K rounded up to 16, zero topics past K), into the
//      head of the split-partials scratch: D Kp 2 bytes written, read
//      again by every column tile from L2 (half the bytes of f32 rows).
//   1. The tile's expElogbeta [Kp x 64], rounded to bf16 and zero-padded,
//      is staged once in shared memory (each thread's float4 loads all
//      issued before its stores).  The f32 values are read again only in
//      the epilogue.
//   2. The split's rows go in chunks of kMmaRows = 64: the counts [64 x
//      64] and the bf16 expEtheta rows [64 x Kp] come by 16-byte cp.async,
//      two chunks ahead of their use, into kMmaBufs = 3 buffers.  Rows of
//      bf16 tiles are an odd number of 16-byte units long, so the 8 rows an
//      ldmatrix phase reads fall on 8 bank quads.
//   3. A chunk whose counts are all zero (pad rows, empty regions) skips
//      both steps: each thread tests the 16-byte pieces it copied itself,
//      and __syncthreads_or is the chunk's first barrier.
//   4. Step A: warp w computes phinorm of rows 16 (w % 4) .. +15 and
//      columns 32 (w / 4) .. +31: 4 m16n8k16 mma a 16-topic step
//      (expEtheta by ldmatrix.x4, expElogbeta by ldmatrix.x4.trans), over
//      the Kp / 16 steps in topic order (unrolled, so the loads run ahead).
//      Only where C != 0: ratio = C / (phinorm + eps) by IEEE division,
//      rounded to bf16, and score += C log(phinorm + eps) in f64 in a
//      fixed order; each thread visits only its own nonzero counts, so a
//      warp takes as many turns as its busiest lane.  The ratio tile
//      [64 x 64] (0 at zero counts) is the chunk's bf16 counts buffer
//      itself (each thread overwrites only counts it has read; a zero
//      count is a zero ratio), for f32 counts a tile of its own.  Second
//      barrier.
//   5. Step B: warp w holds raw[16 mt .. +15, 16 (w % 4) .. +15] for the
//      topic tiles mt = w / 4, w / 4 + 2, .. (< Kp / 16) in registers
//      across the split's chunks: a 16-row step is one ldmatrix.x4.trans
//      of the ratios and one of expEtheta (transposed) a topic tile, and
//      two mma.  Whether a warp has a topic tile is a warp vote, so the
//      compiler adds no reconvergence around the warp-wide ops.
//   6. Epilogue: the splits' partials meet in split order through the
//      last CTA of the tile (dense_sstats.cu's scheme: scratch in the
//      accumulators' own layout, a counter behind __threadfence), which
//      multiplies by the f32 expElogbeta and writes the columns below V;
//      the CTAs' f64 scores meet in a fixed order in the last CTA of the
//      grid.  No floating-point atomics: two calls give the same bits.
//      No TF32 anywhere.
// Topic range [k0, k1): step A runs over all K (phinorm, the ratio and
// the score are the full launch's); step B computes only the topic tiles
// that meet the range, aligned from topic 0, so each kept row is made by
// the same mma instructions on the same operands as in the full launch,
// and only rows k0..k1-1 are written: bitwise the full launch's rows.
//
// Resources (the layout below; ptxas -v in chip_smoke.py's bf16 sstats
// lines): shared memory 89,856 bytes a CTA at K = 100 (bf16 counts),
// 98,304 at K = 128, 165,888 at K = 256; about 100 registers a thread at
// 4 topic tiles a warp (K <= 128) and 165 at 8 (K > 128): 2 CTAs an SM up
// to K = 128, one above.
//
// What bounds it (PERF.md, scripts/torch_sstats_bf16_ab.py with parts
// taken out): at the flagship chunk each 64 x 64 chunk moves ~200 KB
// through shared memory (the cp.async copies, each warp's ldmatrix
// fragments of steps A and B), ~70 us of the SMs' shared-memory
// bandwidth over the call, and the copies alone from L2 take ~55 us; the
// two overlap little.  A CTA of 16 warps and 128 columns (half the
// expEtheta bytes from L2) and a fourth chunk buffer were both slower.

constexpr int kMmaTileV = 64;  // vocab columns a CTA owns
constexpr int kMmaRows = 64;   // rows a chunk
constexpr int kMmaBufs = 3;    // chunk buffers: two chunks ahead
constexpr int kMmaLdV = kMmaTileV + 8;  // bf16 row stride of the tiles

// Byte offsets into the dynamic shared memory, each a multiple of 16.
// Rows of bf16 are an odd number of 16-byte units long, so the 8 rows an
// ldmatrix phase reads fall on 8 bank quads.  The
// ratio tile of bf16 counts is the chunk's counts buffer itself (each
// thread overwrites only the nonzero counts it has read; a zero count is
// a zero ratio), of f32 counts a tile of its own.
struct MmaLayout {
  int kp, ld_et, cnt_ld, eeb, et, cnt, ratio, total;
  __host__ __device__ MmaLayout(int K, int count_bytes) {
    kp = (K + 15) / 16 * 16;
    ld_et = kp + 8;
    cnt_ld = kMmaTileV + 16 / count_bytes;
    eeb = 0;  // [kp][kMmaLdV] bf16
    et = eeb + kp * kMmaLdV * 2;  // [kMmaBufs][kMmaRows][ld_et] bf16
    cnt = et + kMmaBufs * kMmaRows * ld_et * 2;  // [..][kMmaRows][cnt_ld]
    ratio = cnt + kMmaBufs * kMmaRows * cnt_ld * count_bytes;  // [64][72]
    total = ratio + (count_bytes == 2 ? 0 : kMmaRows * kMmaLdV * 2);
  }
};

// Topic tiles a warp holds at Kp / 16 = mt topic tiles (two warps share
// each column block): ceil(mt / 2) rounded up to a power of two.
__host__ __device__ constexpr int mma_tiles_a_warp(int mt) {
  return mt <= 2 ? 1 : mt <= 4 ? 2 : mt <= 8 ? 4 : 8;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// The two counts of a pair of adjacent columns, as f32.
__device__ __forceinline__ float2 count_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 count_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Nonzero bits of a 16-byte piece of counts (+-0 is zero).
__device__ __forceinline__ unsigned nonzero16(const __nv_bfloat16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  return (u.x | u.y | u.z | u.w) & 0x7fff7fffu;
}
__device__ __forceinline__ unsigned nonzero16(const float* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  return (u.x | u.y | u.z | u.w) & 0x7fffffffu;
}

// expEtheta [D, K] f32 rounded to bf16, as [D, kp] with zero topics past
// K: thread i writes the 16-byte unit i (8 topics).
__global__ void __launch_bounds__(kThreads) round_et_kernel(
    const float* __restrict__ et, __nv_bfloat16* __restrict__ out, int D,
    int K, int kp) {
  const int units = kp / 8;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)D * units) return;
  const int d = (int)(i / units), k0 = 8 * (int)(i % units);
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = k0 + e < K ? __ldg(et + (size_t)d * K + k0 + e) : 0.f;
  uint4 u;
  u.x = pack_bf16(v[0], v[1]);
  u.y = pack_bf16(v[2], v[3]);
  u.z = pack_bf16(v[4], v[5]);
  u.w = pack_bf16(v[6], v[7]);
  *reinterpret_cast<uint4*>(out + (size_t)d * kp + k0) = u;
}

// One CTA's tile and row split.  MT2: topic tiles a warp holds in step B
// (at least Kp / 32, a power of two).
template <typename CT, int MT2>
__global__ void __launch_bounds__(kThreads, MT2 >= 8 ? 1 : 2)
    dense_sstats_mma_kernel(const CT* __restrict__ counts,
                            const __nv_bfloat16* __restrict__ etb,
                            const float* __restrict__ eeb,
                            float* __restrict__ sstats,
                            double* __restrict__ score_part,
                            float* __restrict__ score_out,
                            float* __restrict__ partial,
                            int* __restrict__ counters, int D, int Vc, int V,
                            int K, int k0, int k1, float eps,
                            int rows_per_split) {
  constexpr bool kInPlace = sizeof(CT) == 2;  // the ratios over the counts
  const MmaLayout L(K, (int)sizeof(CT));
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* eeb_s = reinterpret_cast<__nv_bfloat16*>(mma_smem + L.eeb);
  __nv_bfloat16* et_s = reinterpret_cast<__nv_bfloat16*>(mma_smem + L.et);
  CT* cnt_s = reinterpret_cast<CT*>(mma_smem + L.cnt);
  __nv_bfloat16* ratio_sep =
      reinterpret_cast<__nv_bfloat16*>(mma_smem + L.ratio);
  __shared__ double score_s[kWarps];
  __shared__ int last_s, last_grid_s;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int v0 = tile * kMmaTileV;
  const int d_lo = split * rows_per_split;
  const int d_hi = min(D, d_lo + rows_per_split);
  const int chunks =
      d_hi > d_lo ? (d_hi - d_lo + kMmaRows - 1) / kMmaRows : 0;
  const int mt_all = L.kp / 16;
  constexpr int E = 16 / (int)sizeof(CT);  // counts a 16-byte piece
  constexpr int kCntPieces = kMmaRows * kMmaTileV / E;
  const int et_units = L.kp / 8;
  const bool vec = ((long long)Vc * (int)sizeof(CT)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(counts) % 16 == 0;
  auto et_buf = [&](int i) {
    return et_s + (i % kMmaBufs) * kMmaRows * L.ld_et;
  };
  auto cnt_buf = [&](int i) {
    return cnt_s + (i % kMmaBufs) * kMmaRows * L.cnt_ld;
  };

  // Issues chunk i's counts and expEtheta rows into buffer i % kMmaBufs
  // and commits them as one group (an empty group past the last chunk);
  // rows past d_hi and columns past Vc read as zero.
  auto load = [&](int i) {
    if (i < chunks) {
      const int d0 = d_lo + i * kMmaRows;
      CT* cb = cnt_buf(i);
      for (int x = tid; x < kCntPieces; x += kThreads) {
        const int r = x / (kMmaTileV / E), c = (x % (kMmaTileV / E)) * E;
        const int d = d0 + r, v = v0 + c;
        CT* s = cb + r * L.cnt_ld + c;
        if (vec) {
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
      __nv_bfloat16* eb = et_buf(i);
      for (int x = tid; x < kMmaRows * et_units; x += kThreads) {
        const int r = x / et_units, q = x - r * et_units;
        const int d = d0 + r;
        __nv_bfloat16* s = eb + r * L.ld_et + 8 * q;
        if (d < d_hi)
          __pipeline_memcpy_async(s, etb + (size_t)d * L.kp + 8 * q, 16);
        else
          *reinterpret_cast<uint4*>(s) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    __pipeline_commit();
  };

  for (int i = 0; i < kMmaBufs - 1; ++i) load(i);
  // The tile's expElogbeta, rounded: row k holds topic k's 64 columns
  // (the 8 past them are never read).  A thread's float4s (topics 16 i +
  // tid / 16, columns 4 (tid % 16) ..) are all loaded before any is
  // stored, so their reads overlap.
  {
    const bool eeb_vec =
        V % 4 == 0 && reinterpret_cast<uintptr_t>(eeb) % 16 == 0;
    const int c = 4 * (tid % 16), v = v0 + c;
    float4 b[2 * MT2];
#pragma unroll
    for (int i = 0; i < 2 * MT2; ++i) {
      const int k = 16 * i + tid / 16;
      b[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < mt_all && k < K) {
        const float* src = eeb + (size_t)k * V + v;
        if (eeb_vec && v < V) {
          b[i] = __ldg(reinterpret_cast<const float4*>(src));
        } else {
          if (v < V) b[i].x = __ldg(src);
          if (v + 1 < V) b[i].y = __ldg(src + 1);
          if (v + 2 < V) b[i].z = __ldg(src + 2);
          if (v + 3 < V) b[i].w = __ldg(src + 3);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2 * MT2; ++i) {
      if (i < mt_all) {
        const int k = 16 * i + tid / 16;
        *reinterpret_cast<uint2*>(eeb_s + k * kMmaLdV + c) =
            make_uint2(pack_bf16(b[i].x, b[i].y), pack_bf16(b[i].z, b[i].w));
      }
    }
  }

  // Step B's tiles: warp w holds columns 16 (w % 4) .. +15 of the topic
  // tiles mt = w / 4 + 2 i (i < MT2) that exist and meet [k0, k1); each a
  // warp vote.
  const int ng = warp % 4, mg = warp / 4;
  const int mt_lo = k0 / 16, mt_hi = min(mt_all, (k1 + 15) / 16);
  bool has[MT2];
#pragma unroll
  for (int i = 0; i < MT2; ++i) {
    const int mt = mg + 2 * i;
    has[i] = __any_sync(kFull, mt >= mt_lo && mt < mt_hi);
  }
  float acc[MT2][2][4];
#pragma unroll
  for (int i = 0; i < MT2; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  double score = 0.0;

  // Step A's tile of the warp: rows 16 ma .. +15, columns 32 na .. +31.
  const int ma = warp % 4, na = warp / 4;
  for (int ci = 0; ci < chunks; ++ci) {
    __pipeline_wait_prior(kMmaBufs - 2);  // chunk ci's group is in
    unsigned mine = 0;
    {
      const CT* cb = cnt_buf(ci);
      for (int x = tid; x < kCntPieces; x += kThreads) {
        const int r = x / (kMmaTileV / E), c = (x % (kMmaTileV / E)) * E;
        mine |= nonzero16(cb + r * L.cnt_ld + c);
      }
    }
    // Every thread is done with chunk ci - 1, and chunk ci is in.
    const bool any = __syncthreads_or(mine != 0u) != 0;
    load(ci + kMmaBufs - 1);
    if (!any) continue;
    const __nv_bfloat16* eb = et_buf(ci);
    const CT* cb = cnt_buf(ci);
    __nv_bfloat16* ratio_s =
        kInPlace ? reinterpret_cast<__nv_bfloat16*>(cnt_buf(ci)) : ratio_sep;

    // Step A: phinorm of the warp's 16 x 32 tile.
    float ph[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ph[j][e] = 0.f;
    const uint32_t a_addr =
        smem_addr(eb + (16 * ma + (lane % 16)) * L.ld_et + (lane / 16) * 8);
    const uint32_t b_addr = smem_addr(eeb_s + (lane % 16) * kMmaLdV +
                                      32 * na + (lane / 16) * 8);
    // Unrolled to the instance's most steps (mt_all <= 2 MT2; the test is
    // on a launch argument, uniform), so the loads run ahead of the mma.
#pragma unroll
    for (int ks = 0; ks < 2 * MT2; ++ks) {
      if (ks < mt_all) {
        unsigned a[4], b[4], bb[4];
        ldmatrix_x4(a, a_addr + 32 * ks);
        ldmatrix_x4_trans(b, b_addr + ks * 16 * kMmaLdV * 2);
        ldmatrix_x4_trans(bb, b_addr + ks * 16 * kMmaLdV * 2 + 32);
        mma_bf16(ph[0], a, b[0], b[1]);
        mma_bf16(ph[1], a, b[2], b[3]);
        mma_bf16(ph[2], a, bb[0], bb[1]);
        mma_bf16(ph[3], a, bb[2], bb[3]);
      }
    }
    // The ratios and the score where the counts are nonzero: zeros first
    // (bf16 counts: their zeros are the tile's), then the thread's nonzero
    // counts in slot order (slot s = 4 j + 2 h + e of ph[j][2 h + e]: row
    // 16 ma + g + 8 h, column 32 na + 8 j + 2 t4 + e), each read before
    // its ratio is stored, so a warp takes as many turns as its busiest
    // lane, not one a slot that any lane needs.
    unsigned nz = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * ma + g + 8 * h, c = 32 * na + 8 * j + 2 * t4;
        const float2 cv = count_pair(cb + r * L.cnt_ld + c);
        nz |= (unsigned)(cv.x != 0.f) << (4 * j + 2 * h);
        nz |= (unsigned)(cv.y != 0.f) << (4 * j + 2 * h + 1);
        if (!kInPlace)
          *reinterpret_cast<unsigned*>(ratio_s + r * kMmaLdV + c) = 0u;
      }
    }
    while (nz) {
      const int q = __ffs(nz) - 1;
      nz &= nz - 1;
      float p = 0.f;
#pragma unroll
      for (int x = 0; x < 16; ++x)
        if (x == q) p = ph[x / 4][x % 4];
      const int r = 16 * ma + g + 8 * ((q / 2) % 2);
      const int c = 32 * na + 8 * (q / 4) + 2 * t4 + q % 2;
      const float cv = to_float(cb[r * L.cnt_ld + c]);
      const float pn = p + eps;
      score += (double)(cv * logf(pn));
      ratio_s[r * kMmaLdV + c] = __float2bfloat16_rn(cv / pn);
    }
    __syncthreads();  // the ratio tile is in

    // Step B: raw += expEtheta^T ratio over the chunk's 4 row steps.
    const uint32_t r_addr = smem_addr(ratio_s + (lane % 16) * kMmaLdV +
                                      16 * ng + (lane / 16) * 8);
    const uint32_t e_addr =
        smem_addr(eb + ((lane % 8) + (lane / 16) * 8) * L.ld_et +
                  ((lane / 8) % 2) * 8);
#pragma unroll
    for (int ks = 0; ks < kMmaRows / 16; ++ks) {
      unsigned b[4];
      ldmatrix_x4_trans(b, r_addr + ks * 16 * kMmaLdV * 2);
#pragma unroll
      for (int i = 0; i < MT2; ++i) {
        if (has[i]) {
          unsigned a[4];
          ldmatrix_x4_trans(
              a, e_addr + (ks * 16 * L.ld_et + 16 * (mg + 2 * i)) * 2);
          mma_bf16(acc[i][0], a, b[0], b[1]);
          mma_bf16(acc[i][1], a, b[2], b[3]);
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
  // Split partials in the accumulators' layout: [tile][split][MT2][2][4]
  // [kThreads] floats, thread tid's at tid.
  constexpr int kPart = MT2 * 2 * 4 * kThreads;
  float* mine = partial + (size_t)(tile * splits + split) * kPart + tid;
  auto at = [](int i, int n, int e) {
    return ((i * 2 + n) * 4 + e) * kThreads;
  };
  if (splits > 1) {
#pragma unroll
    for (int i = 0; i < MT2; ++i) {
      if (!has[i]) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) __stcg(mine + at(i, n, e), acc[i][n][e]);
    }
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
    const float* base = mine - (size_t)split * kPart;
#pragma unroll
    for (int i = 0; i < MT2; ++i) {
      if (!has[i]) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] = __ldcg(base + at(i, n, e));
    }
    for (int s = 1; s < splits; ++s) {
      const float* ps = base + (size_t)s * kPart;
#pragma unroll
      for (int i = 0; i < MT2; ++i) {
        if (!has[i]) continue;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][n][e] += __ldcg(ps + at(i, n, e));
      }
    }
  }
  // sstats = expElogbeta * raw for the range's topics and columns below V:
  // acc[i][n][e] is topic 16 mt + g (+ 8 for e >= 2), column
  // 16 ng + 8 n + 2 t4 (+ 1 for odd e).
#pragma unroll
  for (int i = 0; i < MT2; ++i) {
    if (!has[i]) continue;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 16 * (mg + 2 * i) + g + 8 * (e / 2);
        const int v = v0 + 16 * ng + 8 * n + 2 * t4 + e % 2;
        if (k >= k0 && k < k1 && v < V)
          sstats[(size_t)(k - k0) * V + v] =
              __ldg(eeb + (size_t)k * V + v) * acc[i][n][e];
      }
  }
}

// Rounds expEtheta into the head of `partial` and launches the kernel of
// MT2 topic tiles a warp: grid (tiles, splits).
template <typename CT, int MT2>
cudaError_t launch_mma(const void* counts, const void* et, const void* eeb,
                       void* sstats, void* score_part, void* score_out,
                       void* partial, void* counters, int D, int Vc, int V,
                       int K, int k0, int k1, float eps, int splits,
                       int rows_per_split, cudaStream_t stream) {
  const MmaLayout L(K, (int)sizeof(CT));
  auto* etb = static_cast<__nv_bfloat16*>(partial);
  float* parts = static_cast<float*>(partial) + (size_t)D * L.kp / 2;
  const long long units = (long long)D * (L.kp / 8);
  if (units > 0) {
    round_et_kernel<<<(unsigned)((units + kThreads - 1) / kThreads), kThreads,
                      0, stream>>>(static_cast<const float*>(et), etb, D, K,
                                   L.kp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const auto kern = dense_sstats_mma_kernel<CT, MT2>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return err;
  const dim3 grid((Vc + kMmaTileV - 1) / kMmaTileV, splits);
  kern<<<grid, kThreads, L.total, stream>>>(
      static_cast<const CT*>(counts), etb, static_cast<const float*>(eeb),
      static_cast<float*>(sstats), static_cast<double*>(score_part),
      static_cast<float*>(score_out), parts, static_cast<int*>(counters), D,
      Vc, V, K, k0, k1, eps, rows_per_split);
  return cudaGetLastError();
}

// The instance of K's topic tiles a warp (ops/sstats.py::mma_plan mirrors
// its columns, row chunks and split partials).
template <typename CT>
cudaError_t dispatch_mma(int K, const void* counts, const void* et,
                         const void* eeb, void* sstats, void* score_part,
                         void* score_out, void* partial, void* counters,
                         int D, int Vc, int V, int k0, int k1, float eps,
                         int splits, int rows_per_split, cudaStream_t s) {
  if (rows_per_split % kMmaRows) return cudaErrorInvalidValue;
  switch (mma_tiles_a_warp((K + 15) / 16)) {
    case 1:
      return launch_mma<CT, 1>(counts, et, eeb, sstats, score_part, score_out,
                               partial, counters, D, Vc, V, K, k0, k1, eps,
                               splits, rows_per_split, s);
    case 2:
      return launch_mma<CT, 2>(counts, et, eeb, sstats, score_part, score_out,
                               partial, counters, D, Vc, V, K, k0, k1, eps,
                               splits, rows_per_split, s);
    case 4:
      return launch_mma<CT, 4>(counts, et, eeb, sstats, score_part, score_out,
                               partial, counters, D, Vc, V, K, k0, k1, eps,
                               splits, rows_per_split, s);
    default:
      return launch_mma<CT, 8>(counts, et, eeb, sstats, score_part, score_out,
                               partial, counters, D, Vc, V, K, k0, k1, eps,
                               splits, rows_per_split, s);
  }
}
