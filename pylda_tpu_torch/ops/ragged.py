"""Ragged-layout gamma fixed point: the wrapper of ``csrc/ragged_gamma.cu``.

Replaces ``pylda_tpu/ops/pallas_ragged.py::pallas_estep_ragged_gamma``,
with the semantics of the JAX main path's default
``pylda_tpu/ops/estep.py::estep_ragged_gamma`` (per-row freeze, soft
stall exit, loop exit only when every row is exitable).  For CUDA tensors
``ragged_gamma`` launches the hand-written cooperative kernel (source
note in ``csrc/ragged_gamma.cu``); for CPU tensors it runs the plain
version, ``pylda_tpu_torch.ops.estep.estep_ragged_gamma``.  A CUDA tensor
the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from pylda_tpu_torch.ops import _build
from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation
from pylda_tpu_torch.ops.estep import estep_ragged_gamma

# Kernel launches made by ragged_gamma (one per call on CUDA tensors).
LAUNCHES = 0
# Largest topic count the kernel takes (8 topics a lane).
MAX_TOPICS = 256

_BOUND = False


def _lib() -> ctypes.CDLL:
    global _BOUND
    lib = _build.library("ragged_gamma")
    if not _BOUND:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.pylda_ragged_gamma.argtypes = [
            p, p, p, p, p, p, p, p, p, p, p, p,
            i, i, i, i, i, f, f, i, i, p,
        ]
        lib.pylda_ragged_gamma.restype = i
        _BOUND = True
    return lib


def gather_table(exp_elog_beta: torch.Tensor) -> torch.Tensor:
    """expElogbeta^T as the kernel gathers it: [V, ldb] with ldb = K
    rounded up to a multiple of 4 (zero columns), so each row is whole
    16-byte loads.  Callers running several buckets against one
    expElogbeta build it once and pass it as ``eeb_t``."""
    K, V = exp_elog_beta.shape
    ldb = -(-K // 4) * 4
    if ldb == K:
        return exp_elog_beta.T.contiguous()
    table = exp_elog_beta.new_zeros((V, ldb))
    table[:, :K] = exp_elog_beta.T
    return table


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gamma [D, K], sweeps_used 0-d int32) — see ``estep_ragged_gamma``.

    ``eeb_t`` optionally passes ``gather_table(exp_elog_beta)``.
    ``slots_out`` (a 1-element int64 CUDA tensor) has the number of real
    token slots the kernel processed over all its sweeps added to it,
    frozen rows excluded — the work this input needed, for bounds."""
    global LAUNCHES
    if not ids.is_cuda:
        return estep_ragged_gamma(
            ids, cnts, gamma_init, exp_elog_beta, alpha,
            inner_iterations=inner_iterations,
            convergence_threshold=convergence_threshold,
            eps=eps, stall_patience=stall_patience,
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
    if K > MAX_TOPICS:
        raise NotImplementedError(
            f"the ragged gamma kernel takes K <= {MAX_TOPICS} (got {K}); "
            "see ROADMAP.md Queue 2"
        )
    if inner_iterations < 1:
        raise ValueError("inner_iterations must be positive")
    dev = ids.device
    if eeb_t is None:
        eeb_t = gather_table(exp_elog_beta)
    ldb = -(-K // 4) * 4
    if eeb_t.shape != (V, ldb) or not eeb_t.is_contiguous():
        raise ValueError("eeb_t must be gather_table(exp_elog_beta)")
    for t in (cnts, gamma_init, alpha, eeb_t):
        if t.device != dev:
            raise ValueError("all inputs must be on one device")
    gamma = gamma_init.contiguous().clone()
    if D == 0:
        return gamma, torch.zeros((), dtype=torch.int32, device=dev)
    # The first expEtheta uses the exact digamma, as the JAX loop does.
    et = exp_dirichlet_expectation(gamma).contiguous()
    best = torch.full((D,), float("inf"), dtype=torch.float32, device=dev)
    age = torch.zeros((D,), dtype=torch.int32, device=dev)
    done = torch.zeros((D,), dtype=torch.int32, device=dev)
    counters = torch.zeros((3,), dtype=torch.int32, device=dev)
    sweeps = torch.empty((), dtype=torch.int32, device=dev)
    if slots_out is None:
        slots_out = torch.zeros((1,), dtype=torch.int64, device=dev)
    elif slots_out.dtype != torch.int64 or slots_out.device != dev:
        raise ValueError("slots_out must be an int64 tensor on the device")
    ids = ids.contiguous()
    cnts = cnts.contiguous()
    alpha = alpha.contiguous()
    use_stall = stall_patience > 0 and convergence_threshold > 0.0
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.pylda_ragged_gamma(
            ids.data_ptr(), cnts.data_ptr(), alpha.data_ptr(),
            eeb_t.data_ptr(), gamma.data_ptr(), et.data_ptr(),
            best.data_ptr(), age.data_ptr(), done.data_ptr(),
            counters.data_ptr(), sweeps.data_ptr(), slots_out.data_ptr(),
            D, T, K, ldb, int(inner_iterations), float(convergence_threshold),
            float(eps), int(stall_patience), int(use_stall),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"ragged_gamma kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return gamma, sweeps
