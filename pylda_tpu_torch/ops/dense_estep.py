"""Dense-layout E-step: the wrapper of ``csrc/dense_gamma.cu``.

Replaces ``pylda_tpu/ops/pallas_estep.py::pallas_estep_dense``, with the
semantics of the JAX main path's default
``pylda_tpu/ops/estep.py::estep_dense`` (per-row freeze, soft stall exit,
loop exit only when every row is exitable).  For CUDA tensors
``dense_estep`` launches the hand-written cooperative kernel for the gamma
fixed point (source note in ``csrc/dense_gamma.cu``), takes the exact
expectation at the converged gamma, and launches the ``dense_sstats``
kernel for the sufficient statistics and token score — the Pallas
kernel's final pass, the same function.  For CPU tensors it runs the plain
version, ``pylda_tpu_torch.ops.estep.estep_dense``.  A CUDA tensor the
kernel does not take raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from pylda_tpu_torch.ops import _build
from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation
from pylda_tpu_torch.ops.estep import estep_dense
from pylda_tpu_torch.ops.sstats import dense_sstats
from pylda_tpu_torch.utils import round_up

# Launches of the gamma kernel made by dense_estep (one per call on CUDA
# tensors; its final pass counts in ops.sstats.LAUNCHES).
LAUNCHES = 0
# Largest topic count the kernel takes (16 topics a thread).
MAX_TOPICS = 256
# The kernel's vocab chunk: the wrapper pads columns to a multiple of it.
_VOCAB_TILE = 64

_BOUND = False


def _aligned(t: torch.Tensor, cols: int) -> torch.Tensor:
    """``t`` contiguous with ``cols`` columns (zero pads) and 16-byte
    aligned: ``t`` itself when it already is."""
    t = t.contiguous()
    if t.shape[1] != cols or t.data_ptr() % 16:
        t = torch.nn.functional.pad(t, (0, cols - t.shape[1]))
    return t


def _lib() -> ctypes.CDLL:
    global _BOUND
    lib = _build.library("dense_gamma")
    if not _BOUND:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.pylda_dense_gamma.argtypes = [
            p, i, p, p, p, p, p, p, p, p, p, p,
            i, i, i, i, f, f, i, i, p,
        ]
        lib.pylda_dense_gamma.restype = i
        _BOUND = True
    return lib


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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gamma [D, K], sstats [K, V], token score 0-d, sweeps_used 0-d
    int32) — see ``estep_dense``.

    ``row_sweeps_out`` (a [D] int32 CUDA tensor) has added to each row
    the number of sweeps in which the kernel updated it, frozen sweeps
    excluded — the work this input needed, for bounds."""
    global LAUNCHES
    if not counts.is_cuda:
        return estep_dense(
            counts, gamma_init, exp_elog_beta, alpha,
            inner_iterations=inner_iterations,
            convergence_threshold=convergence_threshold,
            eps=eps, stall_patience=stall_patience,
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
    if K > MAX_TOPICS:
        raise NotImplementedError(
            f"the dense gamma kernel takes K <= {MAX_TOPICS} (got {K}); "
            "see ROADMAP.md Queue 2"
        )
    if inner_iterations < 1:
        raise ValueError("inner_iterations must be positive")
    dev = counts.device
    for t in (gamma_init, exp_elog_beta, alpha):
        if t.device != dev:
            raise ValueError("all inputs must be on one device")
    if row_sweeps_out is not None and (
            row_sweeps_out.dtype != torch.int32
            or row_sweeps_out.shape != (D,) or row_sweeps_out.device != dev
            or not row_sweeps_out.is_contiguous()):
        raise ValueError("row_sweeps_out must be a [D] int32 tensor on the "
                         "device")
    gamma = gamma_init.contiguous().clone()
    if D == 0:
        return (gamma, exp_elog_beta.new_zeros((K, V)),
                exp_elog_beta.new_zeros(()),
                torch.zeros((), dtype=torch.int32, device=dev))
    # The kernel stages 64-column chunks with 16-byte copies: both
    # operands need a multiple of 64 columns and 16-byte alignment.
    vp = round_up(Vc, _VOCAB_TILE)
    counts_k = _aligned(counts, vp)
    eeb_k = _aligned(exp_elog_beta, vp)
    alpha = alpha.contiguous()
    # The first expEtheta uses the exact digamma, as the JAX loop does.
    et = exp_dirichlet_expectation(gamma).contiguous()
    best = torch.full((D,), float("inf"), dtype=torch.float32, device=dev)
    age = torch.zeros((D,), dtype=torch.int32, device=dev)
    done = torch.zeros((D,), dtype=torch.int32, device=dev)
    counters = torch.zeros((3,), dtype=torch.int32, device=dev)
    sweeps = torch.empty((), dtype=torch.int32, device=dev)
    use_stall = stall_patience > 0 and convergence_threshold > 0.0
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.pylda_dense_gamma(
            counts_k.data_ptr(), int(counts_k.dtype == torch.bfloat16),
            eeb_k.data_ptr(), alpha.data_ptr(), gamma.data_ptr(),
            et.data_ptr(), best.data_ptr(), age.data_ptr(), done.data_ptr(),
            counters.data_ptr(), sweeps.data_ptr(),
            None if row_sweeps_out is None else row_sweeps_out.data_ptr(),
            D, vp, K, int(inner_iterations), float(convergence_threshold),
            float(eps), int(stall_patience), int(use_stall),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"dense_gamma kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    # The final pass at the EXACT expectation of the converged gamma.
    sstats, token_score = dense_sstats(
        counts, exp_dirichlet_expectation(gamma), exp_elog_beta, eps=eps
    )
    return gamma, sstats, token_score, sweeps
