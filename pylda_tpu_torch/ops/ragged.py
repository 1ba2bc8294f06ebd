"""Ragged-layout gamma fixed point: the wrapper of ``csrc/ragged_gamma.cu``.

Replaces ``pylda_tpu/ops/pallas_ragged.py::pallas_estep_ragged_gamma``,
with the semantics of the JAX main path's default
``pylda_tpu/ops/estep.py::estep_ragged_gamma`` (per-row freeze, soft
stall exit, loop exit only when every row is exitable).  For CUDA tensors
``ragged_gamma`` launches the hand-written cooperative kernel (source
note in ``csrc/ragged_gamma.cu``, design in ``csrc/row_fixed_point.cuh``);
for CPU tensors it runs the plain version,
``pylda_tpu_torch.ops.estep.estep_ragged_gamma``.  A CUDA tensor the
kernel does not take raises.  The launch itself, shared with the dense
kernel's wrapper, is ``ops/row_fixed_point.py``; above K = 4096 it runs
the cluster kernel (``csrc/row_fixed_point_tiled.cuh``), counted in
``WIDE_LAUNCHES`` / ``BF16_WIDE_LAUNCHES`` too.  Up to K = 4096 a bucket
whose width is past one block's slot buffer runs the entry kernel
(``csrc/row_fixed_point_entries.cuh``, ``row_fixed_point.gamma_plan``),
counted in ``CLUSTER_LAUNCHES`` / ``BF16_CLUSTER_LAUNCHES`` too.  In the bf16
mode at K <= 256 a launch whose widest row fits a warp group's slots runs
the warp-group kernel (``csrc/row_fixed_point_groups.cuh``, the plan's
route "groups"), counted in ``BF16_GROUP_LAUNCHES`` too.  A
bucket's rows may fall
into ``segments``, the chunks the JAX engine's layout would run apart:
one launch, each segment ending at its own exit sweep.  ``compute_dtype=
"bfloat16"`` launches the kernel's bf16 build on a bf16 gather table (or
runs the plain version in that mode on the CPU); never the float32 build.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from pylda_tpu_torch.ops import row_fixed_point
from pylda_tpu_torch.ops.estep import check_compute_dtype, estep_ragged_gamma
from pylda_tpu_torch.ops.row_fixed_point import gather_table, table_width

# Kernel launches made by ragged_gamma (one per call on CUDA tensors): of
# the float32 build, and of the bf16 build.
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
    return row_fixed_point.entry("ragged_gamma", compute_dtype)


def ragged_gamma(
    ids: torch.Tensor,  # [D, T] int32 (0 on padded slots)
    cnts: torch.Tensor,  # [D, T] f32 (0 on padded slots)
    gamma_init: torch.Tensor,  # [D, K] f32
    exp_elog_beta: torch.Tensor,  # [K, V] f32
    alpha: torch.Tensor,  # [K] f32
    inner_iterations: int = 50,
    convergence_threshold: float = 1e-5,
    eps: float = 1e-30,
    stall_patience: int = 0,
    eeb_t: Optional[torch.Tensor] = None,
    slots_out: Optional[torch.Tensor] = None,
    extra_sweeps_out: Optional[torch.Tensor] = None,
    row_exit_out: Optional[torch.Tensor] = None,
    row_sweeps_out: Optional[torch.Tensor] = None,
    geometry_out: Optional[dict] = None,
    compute_dtype: str = "float32",
    segments: Optional[Sequence[int]] = None,
    seg_rows: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gamma [D, K], sweeps_used 0-d int32) — see ``estep_ragged_gamma``.
    With ``segments`` (row counts summing to D) the rows are consecutive
    batches, each ending at its own exit sweep, and sweeps_used is
    [len(segments)] int32; ``seg_rows`` optionally passes their
    ``row_fixed_point.segment_rows`` on the device.

    ``eeb_t`` optionally passes ``gather_table(exp_elog_beta,
    compute_dtype)``.  Optional outputs, filled on CUDA tensors only:

    - ``slots_out`` (1-element int64) has added to it the live token slots
      of each row times the sweeps the batch loop computes it in (frozen
      sweeps excluded) — the work this input needed, for bounds;
    - ``extra_sweeps_out`` (1-element int64) has added to it the
      row-sweeps the kernel's row-major order computed beyond those: the
      first run of each row that ran past the loop's sweep count;
    - ``row_exit_out`` ([D] int32) gets each row's first exitable sweep
      (1-based; 0 if it never was);
    - ``row_sweeps_out`` ([D] int32) has added to each row the number of
      sweeps the batch loop updates it in (fewer than the sweeps used
      only for a row that was done and froze);
    - ``geometry_out`` (a dict) gets the launch's
      ``row_fixed_point.GEOMETRY``: the slot buffer's live entries (a row
      with more streams), shared memory a block, blocks an SM, grid, the
      cluster kernels' fields, and the plan's ``route``."""
    global LAUNCHES, BF16_LAUNCHES, WIDE_LAUNCHES, BF16_WIDE_LAUNCHES
    global CLUSTER_LAUNCHES, BF16_CLUSTER_LAUNCHES, BF16_GROUP_LAUNCHES
    bf16 = check_compute_dtype(compute_dtype)
    if not ids.is_cuda:
        return estep_ragged_gamma(
            ids, cnts, gamma_init, exp_elog_beta, alpha,
            inner_iterations=inner_iterations,
            convergence_threshold=convergence_threshold,
            eps=eps, stall_patience=stall_patience,
            compute_dtype=compute_dtype, segments=segments,
        )
    D, T = ids.shape
    K, V = exp_elog_beta.shape
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    for name, t in (("cnts", cnts), ("gamma_init", gamma_init),
                    ("exp_elog_beta", exp_elog_beta), ("alpha", alpha)):
        if t.dtype != torch.float32:
            raise TypeError(f"the ragged kernel takes float32 {name}")
    if cnts.shape != (D, T) or gamma_init.shape != (D, K) or alpha.shape != (K,):
        raise ValueError("shape mismatch between ids, cnts, gamma_init, alpha")
    if inner_iterations < 1:
        raise ValueError("inner_iterations must be positive")
    dev = ids.device
    if eeb_t is None:
        eeb_t = gather_table(exp_elog_beta, compute_dtype)
    if (eeb_t.shape != (V, table_width(K, compute_dtype))
            or eeb_t.dtype != (torch.bfloat16 if bf16 else torch.float32)
            or not eeb_t.is_contiguous()):
        raise ValueError("eeb_t must be gather_table(exp_elog_beta, "
                         f"{compute_dtype!r})")
    for t in (cnts, gamma_init, alpha, eeb_t):
        if t.device != dev:
            raise ValueError("all inputs must be on one device")
    if D == 0:
        return gamma_init.clone(), torch.zeros(
            () if segments is None else (len(segments),), dtype=torch.int32,
            device=dev)
    geo = {} if geometry_out is None else geometry_out
    gamma, sweeps = row_fixed_point.launch(
        _kernel(compute_dtype), ids, cnts, T,
        eeb_t, alpha, gamma_init, inner_iterations,
        convergence_threshold, eps, stall_patience, row_exit_out=row_exit_out,
        row_sweeps_out=row_sweeps_out, slots_out=slots_out,
        extra_sweeps_out=extra_sweeps_out, geometry_out=geo,
        segments=segments, seg_rows=seg_rows)
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
    return gamma, sweeps
