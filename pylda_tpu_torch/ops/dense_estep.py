"""Dense-layout E-step: the wrapper of ``csrc/dense_gamma.cu``.

Replaces ``pylda_tpu/ops/pallas_estep.py::pallas_estep_dense``, with the
semantics of the JAX main path's default
``pylda_tpu/ops/estep.py::estep_dense`` (per-row freeze, soft stall exit,
loop exit only when every row is exitable).  For CUDA tensors
``dense_estep`` launches the hand-written cooperative kernel for the gamma
fixed point (source note in ``csrc/dense_gamma.cu``, design in
``csrc/row_fixed_point.cuh``: it sweeps each row's nonzero counts only,
against expElogbeta^T rows gathered once a row), takes the exact
expectation at the converged gamma, and launches the ``dense_sstats``
kernel for the sufficient statistics and token score — the Pallas
kernel's final pass, the same function.  That kernel (source note in
``csrc/dense_sstats.cu``) also works at the nonzero counts only: its bound
is 4*K FLOP a nonzero or the counts read once, whichever is longer (the
bytes, at the dense flagship's 2.8% nonzeros); it is held back by each
32-row chunk's latency and the grid's fixed cost, not by those bytes; and
it returns the same bits on every call (each sum has one owner, row
splits meet in a fixed order).  For CPU tensors it runs the plain
version, ``pylda_tpu_torch.ops.estep.estep_dense``.  A CUDA tensor the
kernel does not take raises.  ``compute_dtype="bfloat16"`` launches both
kernels' bf16 builds (a bf16 gather table; expEtheta, expElogbeta in
phinorm and the ratio rounded as the reference rounds them), never the
float32 builds.  Under lambda sharding the final pass takes the rank's
``topic_range`` (the sstats kernel's topic-range launch) or
``vocab_range`` (its own columns of counts and expElogbeta), while the
fixed point reads the whole expElogbeta.  Above K = 4096 the fixed point
is the cluster kernel (``csrc/row_fixed_point_tiled.cuh``, counted in
``WIDE_LAUNCHES`` / ``BF16_WIDE_LAUNCHES`` too) and the final pass the
sstats cluster kernel.  Up to K = 4096 a batch whose largest row nnz
(``max_nnz``, counted when the batch is built; by default the column
count) is past one block's slot buffer runs the entry kernel
(``csrc/row_fixed_point_entries.cuh``, ``row_fixed_point.gamma_plan``),
counted in ``CLUSTER_LAUNCHES`` / ``BF16_CLUSTER_LAUNCHES`` too.  In the bf16
mode at K <= 256 a launch whose widest row fits a warp group's slots runs
the warp-group kernel (``csrc/row_fixed_point_groups.cuh``, the plan's
route "groups"), counted in ``BF16_GROUP_LAUNCHES`` too.  A dense
batch is one segment: the dense route already makes the JAX engine's
batches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pylda_tpu_torch.ops import row_fixed_point
from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation
from pylda_tpu_torch.ops.estep import (
    check_compute_dtype,
    estep_dense,
    vocab_block,
)
from pylda_tpu_torch.ops.sstats import dense_sstats

# Launches of the gamma kernel made by dense_estep (one per call on CUDA
# tensors; its final pass counts in ops.sstats): of the float32 build, and
# of the bf16 build.
LAUNCHES = 0
BF16_LAUNCHES = 0
# Of those, the launches of the cluster kernel (K > RESIDENT_TOPICS).
WIDE_LAUNCHES = 0
BF16_WIDE_LAUNCHES = 0
# ... and of the entry kernel (K <= RESIDENT_TOPICS, rows past one block's
# slot buffer: the plan's route "entries").
CLUSTER_LAUNCHES = 0
BF16_CLUSTER_LAUNCHES = 0
# ... and of the bf16 warp-group kernel (K <= 256, the plan's route
# "groups"; the bf16 build only).
BF16_GROUP_LAUNCHES = 0


def _kernel(compute_dtype: str):
    return row_fixed_point.entry("dense_gamma", compute_dtype)


def dense_estep(
    counts: torch.Tensor,  # [D, Vc] bf16 or f32, Vc >= V (zero pads)
    gamma_init: torch.Tensor,  # [D, K] f32
    exp_elog_beta: torch.Tensor,  # [K, V] f32
    alpha: torch.Tensor,  # [K] f32
    inner_iterations: int = 50,
    convergence_threshold: float = 1e-5,
    eps: float = 1e-30,
    stall_patience: int = 0,
    row_sweeps_out: Optional[torch.Tensor] = None,
    extra_sweeps_out: Optional[torch.Tensor] = None,
    row_exit_out: Optional[torch.Tensor] = None,
    geometry_out: Optional[dict] = None,
    compute_dtype: str = "float32",
    topic_range: Optional[Tuple[int, int]] = None,
    vocab_range: Optional[Tuple[int, int]] = None,
    max_nnz: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gamma [D, K], sstats [K, V], token score 0-d, sweeps_used 0-d
    int32) — see ``estep_dense``.  Optional outputs, filled on CUDA
    tensors only:

    - ``row_sweeps_out`` ([D] int32) has added to each row the number of
      sweeps the batch loop updates it in, frozen sweeps excluded — the
      work this input needed, for bounds;
    - ``extra_sweeps_out`` (1-element int64) has added to it the
      row-sweeps the kernel's row-major order computed beyond those;
    - ``row_exit_out`` ([D] int32) gets each row's first exitable sweep
      (1-based; 0 if it never was);
    - ``geometry_out`` (a dict) gets the gamma launch's
      ``row_fixed_point.GEOMETRY`` and the plan's ``route``.

    ``max_nnz``: the largest number of nonzero counts in a row, which
    sizes the gamma launch's plan (``row_fixed_point.gamma_plan``); it
    must bound every row (the entry kernel traps on a longer one).
    Default: the column count V."""
    global LAUNCHES, BF16_LAUNCHES, WIDE_LAUNCHES, BF16_WIDE_LAUNCHES
    global CLUSTER_LAUNCHES, BF16_CLUSTER_LAUNCHES, BF16_GROUP_LAUNCHES
    check_compute_dtype(compute_dtype)
    if not counts.is_cuda:
        return estep_dense(
            counts, gamma_init, exp_elog_beta, alpha,
            inner_iterations=inner_iterations,
            convergence_threshold=convergence_threshold,
            eps=eps, stall_patience=stall_patience,
            compute_dtype=compute_dtype, topic_range=topic_range,
            vocab_range=vocab_range,
        )
    D, Vc = counts.shape
    K, V = exp_elog_beta.shape
    if counts.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"counts must be bf16 or f32, got {counts.dtype}")
    for name, t in (("gamma_init", gamma_init),
                    ("exp_elog_beta", exp_elog_beta), ("alpha", alpha)):
        if t.dtype != torch.float32:
            raise TypeError(f"the dense gamma kernel takes float32 {name}")
    if gamma_init.shape != (D, K) or alpha.shape != (K,) or Vc < V:
        raise ValueError(
            f"shape mismatch: counts {tuple(counts.shape)}, gamma_init "
            f"{tuple(gamma_init.shape)}, expElogbeta "
            f"{tuple(exp_elog_beta.shape)}, alpha {tuple(alpha.shape)}"
        )
    if inner_iterations < 1:
        raise ValueError("inner_iterations must be positive")
    dev = counts.device
    for t in (gamma_init, exp_elog_beta, alpha):
        if t.device != dev:
            raise ValueError("all inputs must be on one device")
    if D == 0:
        k0, k1 = topic_range or (0, K)
        v0, v1 = vocab_range or (0, V)
        return (gamma_init.clone(), exp_elog_beta.new_zeros((k1 - k0,
                                                             v1 - v0)),
                exp_elog_beta.new_zeros(()),
                torch.zeros((), dtype=torch.int32, device=dev))
    counts = counts.contiguous()
    geo = {} if geometry_out is None else geometry_out
    gamma, sweeps = row_fixed_point.launch(
        _kernel(compute_dtype), None, counts, V,
        row_fixed_point.gather_table(exp_elog_beta, compute_dtype),
        alpha, gamma_init, inner_iterations, convergence_threshold, eps,
        stall_patience, row_sweeps_out=row_sweeps_out,
        row_exit_out=row_exit_out, extra_sweeps_out=extra_sweeps_out,
        geometry_out=geo, widest=max_nnz)
    wide, cluster = geo["route"] == "cluster", geo["route"] == "entries"
    if compute_dtype == "bfloat16":
        BF16_LAUNCHES += 1
        BF16_WIDE_LAUNCHES += wide
        BF16_CLUSTER_LAUNCHES += cluster
        BF16_GROUP_LAUNCHES += geo["route"] == "groups"
    else:
        LAUNCHES += 1
        WIDE_LAUNCHES += wide
        CLUSTER_LAUNCHES += cluster
    # The final pass at the EXACT expectation of the converged gamma.
    c_own, eeb_own = vocab_block(counts, exp_elog_beta, vocab_range)
    sstats, token_score = dense_sstats(
        c_own, exp_dirichlet_expectation(gamma), eeb_own, eps=eps,
        compute_dtype=compute_dtype, topic_range=topic_range,
    )
    return gamma, sstats, token_score, sweeps
