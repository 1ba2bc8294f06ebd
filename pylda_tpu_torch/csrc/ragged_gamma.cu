// Ragged-layout gamma fixed point of the VB E-step (sm_90a).
//
// Replaces pylda_tpu/ops/pallas_ragged.py::pallas_estep_ragged_gamma
// (kernel body _ragged_tile_kernel), with the semantics of the JAX main
// path's default, pylda_tpu/ops/estep.py::estep_ragged_gamma: for one
// bucket of rows (ids, cnts [D, T]) and B[d, t, :] = expElogbeta^T[ids[d, t]]
//
//   phinorm[d, t] = sum_k B[d, t, k] * expEtheta[d, k] + eps
//   gamma'[d, k]  = alpha[k] + expEtheta[d, k] * sum_t B[d, t, k] * cnt[d, t] / phinorm[d, t]
//
// with the per-row exit rule of _exit_update and a loop that ends only
// when EVERY row of the bucket, padding rows included, is done or stalled,
// or at inner_iterations.  The initial expEtheta uses the exact digamma,
// which CUDA's math library lacks: the wrapper computes it with
// torch.special.digamma and passes it in.
//
// Bound on an H100 SXM at the flagship (4 buckets, 531,456 token slots,
// 483,285 of them live, K=100): 4*K FLOP a live slot a computed sweep,
// ~0.19 GFLOP a sweep, ~2.9 us at the 67 TFLOP/s f32 rate; the inputs read
// once are ~11.5 MB (~3.4 us at 3.35 TB/s).  So the bound is ~S x 2.9 us
// for S sweeps: operations.
//
// Design: row_fixed_point.cuh, the row-resident core shared with
// dense_gamma.cu.  A block takes one row at a time, compacts its live
// slots (cnt != 0), gathers their B rows from the L2-resident table
// [V, ldb] once into shared memory (a 160-slot row at K=100 is 64 KB), and
// runs all of the row's sweeps from there; the bucket's exit is settled
// after the rows have run (S* from per-sweep not-exitable counts, then a
// re-run of rows that ran past S*).  So each live slot's 400-byte B row
// crosses from L2 once a call (~200 MB at the flagship), not once a sweep.
// Buckets of width <= 128 at K <= 128 keep each row's B in registers
// (the core's register tile).  What bounds it: the latency of a sweep's
// block reductions and fast digamma, which 2-4 blocks an SM only partly
// hide, and in wider buckets shared-memory bandwidth (the row's B read
// twice a sweep, 8 FMAs for every two float4 loads); for a small bucket,
// one row's sweeps in sequence.  A row with more live slots than the slot
// buffer (nmax slots, ~72 KB of shared memory: 166 at K=100, 63 at K=256)
// writes its compacted (id, count) list once to the block's scratch in
// global memory and streams it in windows of nmax live slots each sweep,
// gathering each window's B rows from L2.
//
// At K > 256 (the core's wide kernels; SVI config 5: K=1000, V=100k,
// minibatches of 2048 documents in buckets of width 160 / 176 / 208, ~307k
// live slots) a slot is 4 KB, the buffer holds 25 of them, and every row
// streams: each sweep gathers every live slot's B row again, and the
// 400 MB table is read from device memory, not L2 (~1.23 GB a sweep over
// a minibatch, ~0.37 ms at 3.35 TB/s), against a bound of 4*K FLOP a live
// slot a sweep (0.54 ms for the 30 sweeps of a minibatch at 67 TFLOP/s).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): 16.2 ms for a
// minibatch's 12 launches at a trained lambda, ~2.2 TB/s of 4 KB gathers:
// the re-gathering, not the arithmetic, sets the time.  So a launch whose
// bucket width (its widest row) is past one block's slot buffer takes the
// entry kernel (row_fixed_point_entries.cuh): a cluster of C CTAs a row,
// each holding a share of the row's entries for all its sweeps (config 5:
// C = 4 or 8, bf16 2 or 4), the partial sums meeting in a reduce-scatter
// and an all-gather through distributed shared memory a sweep.  Only rows past
// 16 CTAs' buffers (K = 4096) still stream.
//
// Built twice (ops/_build.py): as is, and with -DPYLDA_BF16=1, the bf16
// operand mode of estep_ragged_gamma(compute_dtype="bfloat16"): a bf16
// table (2 KB rows at K=1000, so half the bytes a re-gather and about
// twice the slots a buffer), expEtheta and the ratio rounded to bf16 where
// the reference rounds them, sums in f32 (row_fixed_point.cuh).  At
// K <= 256 a bucket whose width fits a warp group's slots (192 entries at
// K <= 128) runs the warp-group kernel of row_fixed_point_groups.cuh: a
// row a group of 4 warps, 2 groups a CTA, the bucket's bf16 B rows in
// shared memory read by ldmatrix, both products of a sweep on mma.sync
// (bf16 operands, f32 sums); its times are in PERF.md.
//
// Above K = 4096 (row_fixed_point_tiled.cuh) a cluster of CTAs sweeps a
// row, each CTA a slice of its topics in shared memory: a live slot's B
// row is read once a call where the row fits the cluster's shared memory
// and once a sweep where it does not (the tiled kernel it replaced read it
// twice a sweep): at SVI config 5's corpus and K = 8192 a minibatch's ~307k live
// slots are 4*K FLOP a slot a sweep against 32 KB of B each (f32), bound
// by bytes wherever they stream.  Past K = 65,536 a slice no longer fits a
// CTA, and the direct plan keeps it in device memory and reads B from the
// table twice a sweep.
//
// A bucket's rows may fall into segments (Params.seg: the chunks the JAX
// engine's layout would run apart), each ending at its own S*.

#include "row_fixed_point_entries.cuh"

extern "C" {

// params: a Params (row_fixed_point.cuh) with ids and cnts [D, T] int32 and
// f32 (cnts_bf16 0, ld = L = T), table [V, ldb] = expElogbeta^T (f32, or
// bf16 with table_bf16 set in a build with -DPYLDA_BF16=1) and
// K >= 1 (above 4096 the cluster kernel, with lists and the plan set), and
// optionally seg / nseg; the launch's nmax, nhist and geometry are written
// back into it.  stream: a cudaStream_t.  Returns the cudaError_t of the
// launch.
int pylda_ragged_gamma(void* params, void* stream) {
  Params& p = *static_cast<Params*>(params);
  if (!p.ids || p.cnts_bf16) return (int)cudaErrorInvalidValue;
  // Buckets whose rows all fit the register tile take it.
  return (int)launch_gamma<float, PYLDA_BF16 != 0>(
      p, p.L <= kWarps * kRegSlots, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
