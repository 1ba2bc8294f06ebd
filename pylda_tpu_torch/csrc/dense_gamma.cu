// Dense-layout gamma fixed point of the VB E-step (sm_90a).
//
// Replaces pylda_tpu/ops/pallas_estep.py::pallas_estep_dense (kernel body
// _estep_tile_kernel) up to its final pass, with the semantics of the JAX
// main path's default, pylda_tpu/ops/estep.py::estep_dense: for counts
// C [D, ld] (bf16 or f32; the first V columns used) and expElogbeta E [K, V]
//
//   phinorm[d, v] = sum_k expEtheta[d, k] * E[k, v] + eps
//   gamma'[d, k]  = alpha[k] + expEtheta[d, k] * sum_v C[d, v] / phinorm[d, v] * E[k, v]
//
// with the per-row exit rule of _exit_update and a loop that ends only
// when EVERY row is done or stalled, or at inner_iterations.  The initial
// expEtheta uses the exact digamma (computed by the wrapper).  The final
// pass of the Pallas kernel — sstats and the token score at the exact
// expectation of the converged gamma — is dense_sstats.cu, launched by the
// wrapper (pylda_tpu_torch/ops/dense_estep.py).
//
// Bound on an H100 SXM at the dense flagship (D=4096, V=4096, K=100, ~120
// tokens a document): the function needs phinorm and the ratio only where
// a count is nonzero (471,713 of 16.8M entries, 2.8%), so its two products
// are 4*K FLOP a nonzero a computed sweep, ~0.19 GFLOP a sweep, ~2.8 us at
// the 67 TFLOP/s f32 rate, against ~10 us to read the 32 MiB of bf16
// counts once at 3.35 TB/s: bound by operations over a fixed point of S
// sweeps.
//
// Design: row_fixed_point.cuh, the row-resident core shared with
// ragged_gamma.cu.  A dense row is a list of (column, count) entries: a
// block takes one row at a time, compacts its nonzero columns in one pass
// over the row's counts (in column order), gathers their expElogbeta
// columns (rows of the table E^T [V, ldb]) once into shared memory (at
// most 153 x 400 B at the flagship), and sweeps over the nonzero entries
// only; the batch's exit is settled after the rows have run (S* from
// per-sweep not-exitable counts, then a re-run of rows that ran past S*).
// Rows of up to 128 nonzeros at K <= 128 keep their B in registers (the
// core's register tile).  What bounds it: the latency of a sweep's block
// reductions and fast digamma, which 2 blocks an SM only partly hide, and
// for longer rows shared-memory bandwidth (8 FMAs for every two float4
// loads).  A row with more nonzeros than the slot buffer (nmax: 166 at
// K=100, 63 at K=256) writes its compacted (column, count) list once to the
// block's scratch in global memory and streams it in windows of nmax
// nonzeros each sweep, gathering each window's B rows from L2: the L2
// reads of such a row are its nonzeros x 4 ldb bytes a sweep.  At K > 256
// the core's wide kernels run (a thread owns several topics; 25 slots of
// 4 KB at K=1000).  A batch whose largest row (Params.L bounds it; the
// wrapper's plan takes the batch's largest row nnz, counted when the batch
// is built) is past the slot buffer takes the entry kernel
// (row_fixed_point_entries.cuh: a cluster a row, the row's nonzeros split
// across its CTAs and resident for all sweeps), unless 16 CTAs cannot hold
// it, and then its long rows stream; above K = 4096 the
// cluster kernel of row_fixed_point_tiled.cuh (a cluster of CTAs a row,
// each a slice of the topics and of the row's B rows in shared memory;
// past K = 65,536 the direct plan, each slice's state in device memory and
// B read from the table).
// A dense batch is one segment.
//
// Built twice (ops/_build.py): as is, and with -DPYLDA_BF16=1, the sweeps
// of estep_dense(compute_dtype="bfloat16"): a bf16 table, expEtheta and
// the ratio rounded to bf16 where the reference rounds them, sums in f32
// (row_fixed_point.cuh); its final pass is dense_sstats.cu's bf16 build.
// At K <= 256 a batch whose largest row nnz fits a warp group's slots (192
// at K <= 128) runs the warp-group kernel of row_fixed_point_groups.cuh
// (a row a group of 4 warps, both products on mma.sync).

#include "row_fixed_point_entries.cuh"

extern "C" {

// params: a Params (row_fixed_point.cuh) with ids null, cnts the counts
// [D, ld] (bf16 if cnts_bf16, else f32; the first L = V columns used) and
// table [V, ldb] = expElogbeta^T (f32, or bf16 with table_bf16 set in a
// build with -DPYLDA_BF16=1), K >= 1 (above 4096 the cluster kernel, with
// lists and the plan set); the launch's nmax, nhist and geometry are
// written back into it.  stream: a cudaStream_t.
// Returns the cudaError_t of the launch.
int pylda_dense_gamma(void* params, void* stream) {
  Params& p = *static_cast<Params*>(params);
  if (p.ids) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Rows of up to 128 nonzeros take the register tile, longer ones the
  // shared-memory sweep of the same kernel.
  constexpr bool kBf16 = PYLDA_BF16 != 0;
  if (p.cnts_bf16)
    return (int)launch_gamma<__nv_bfloat16, kBf16>(p, true, s);
  return (int)launch_gamma<float, kBf16>(p, true, s);
}

}  // extern "C"
