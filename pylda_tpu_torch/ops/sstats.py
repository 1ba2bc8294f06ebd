"""Fused dense sufficient statistics: the wrapper of ``csrc/dense_sstats.cu``.

Replaces ``pylda_tpu/ops/pallas_sstats.py::pallas_dense_sstats``.  For
CUDA tensors ``dense_sstats`` launches the hand-written kernel (source
note in ``csrc/dense_sstats.cu``: its bound on an H100 and its design);
for CPU tensors it runs the plain version,
``pylda_tpu_torch.ops.estep.estep_dense_sstats``.  There is no other
route: a CUDA tensor the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pylda_tpu_torch.ops import _build
from pylda_tpu_torch.ops.estep import estep_dense_sstats

# Kernel launches made by dense_sstats (one per call on CUDA tensors).
LAUNCHES = 0
# Largest topic count the kernel takes (its register accumulator).
MAX_TOPICS = 256

_BOUND = False


def _lib() -> ctypes.CDLL:
    global _BOUND
    lib = _build.library("dense_sstats")
    if not _BOUND:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pylda_dense_sstats.argtypes = [
            p, i, p, p, p, p, i, i, i, i, ctypes.c_float, p,
        ]
        lib.pylda_dense_sstats.restype = i
        lib.pylda_dense_sstats_blocks.argtypes = [i]
        lib.pylda_dense_sstats_blocks.restype = i
        _BOUND = True
    return lib


def dense_sstats(
    counts: torch.Tensor,  # [D, Vc] bf16 or f32, Vc >= V (zero pads)
    exp_etheta: torch.Tensor,  # [D, K] f32
    exp_elog_beta: torch.Tensor,  # [K, V] f32
    eps: float = 1e-30,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sstats [K, V], token score 0-d) — see ``estep_dense_sstats``."""
    global LAUNCHES
    if not counts.is_cuda:
        return estep_dense_sstats(counts, exp_etheta, exp_elog_beta, eps)
    D, Vc = counts.shape
    K, V = exp_elog_beta.shape
    if counts.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"counts must be bf16 or f32, got {counts.dtype}")
    if exp_etheta.dtype != torch.float32 or exp_elog_beta.dtype != torch.float32:
        raise TypeError("the sstats kernel takes float32 expEtheta/expElogbeta")
    if exp_etheta.shape != (D, K) or Vc < V:
        raise ValueError(
            f"shape mismatch: counts {tuple(counts.shape)}, expEtheta "
            f"{tuple(exp_etheta.shape)}, expElogbeta {tuple(exp_elog_beta.shape)}"
        )
    if K > MAX_TOPICS:
        raise NotImplementedError(
            f"the dense sstats kernel takes K <= {MAX_TOPICS} (got {K}); "
            "see ROADMAP.md Queue 2"
        )
    dev = counts.device
    if exp_etheta.device != dev or exp_elog_beta.device != dev:
        raise ValueError("all inputs must be on one device")
    counts = counts.contiguous()
    exp_etheta = exp_etheta.contiguous()
    exp_elog_beta = exp_elog_beta.contiguous()
    lib = _lib()
    # Zeroed: the kernel's two row halves each add into every output.
    sstats = torch.zeros((K, V), dtype=torch.float32, device=dev)
    parts = torch.empty(
        (lib.pylda_dense_sstats_blocks(Vc),), dtype=torch.float64, device=dev
    )
    with torch.cuda.device(dev):
        rc = lib.pylda_dense_sstats(
            counts.data_ptr(), int(counts.dtype == torch.bfloat16),
            exp_etheta.data_ptr(), exp_elog_beta.data_ptr(),
            sstats.data_ptr(), parts.data_ptr(), D, Vc, V, K, float(eps),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"dense_sstats kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return sstats, parts.sum().to(torch.float32)
