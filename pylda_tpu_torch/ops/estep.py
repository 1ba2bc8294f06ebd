"""Batched variational E-step: the plain PyTorch versions.

Counterparts of ``pylda_tpu.ops.estep``.  These are the in-package
references of the three CUDA kernels (``ops/ragged.py``,
``ops/sstats.py``, ``ops/dense_estep.py``): the kernel wrappers call them
for CPU tensors, the tests hold them against the JAX functions, and
``chip_smoke.py`` holds each kernel against them on the card.

Only the "dtk" layout ([D, T, K], topics last) is ported: the JAX
package's "kdt" layout, bf16 factor storage and token-axis blocking
(``_factor_layout``, ``_b_storage_dtype``, ``_pick_t_block``) are
lowering choices for XLA on a TPU.  All contractions run in the input
dtype (float32, or float64 in the tests).
"""

from __future__ import annotations

from typing import Tuple

import torch

from pylda_tpu_torch.ops.dirichlet import (
    exp_dirichlet_expectation,
    exp_dirichlet_expectation_fast,
)


def _exit_update(change, best, age, done, threshold, use_stall, patience):
    """Per-row exit bookkeeping of the gamma fixed point.

    Returns (best, age, done, exitable):

    - ``done`` (sticky) marks rows whose best mean|dgamma| has fallen to
      the threshold — the reference's per-document break.  Done rows
      FREEZE their gamma in the caller, so each row's output does not
      depend on when the other rows exit.
    - ``exitable`` additionally includes rows that are currently stalled:
      no 1% improvement of their best change for ``patience`` consecutive
      sweeps.  Stalling is NOT sticky and does NOT freeze: a stalled row
      keeps updating while other rows hold the loop open.  The loop exits
      when every row is exitable.

    ``threshold == 0`` disables freezing (run to the cap)."""
    improved = change < 0.99 * best
    age_new = torch.where(improved, torch.zeros_like(age), age + 1)
    best_new = torch.minimum(best, change)
    done_new = done
    if threshold > 0.0:
        done_new = done_new | (best_new <= threshold)
    exitable = done_new
    if use_stall:
        exitable = exitable | (age_new >= patience)
    return best_new, age_new, done_new, exitable


def _fixed_point(sweep, gamma_init, inner_iterations, convergence_threshold,
                 stall_patience):
    """The batched gamma fixed point shared by both layouts; returns
    (sweeps_used, gamma).  ``sweep(exp_etheta)`` is one sweep's proposal
    alpha + expEtheta * (...).  The loop tests the exit on the host once
    per sweep — this is the reference version; the CUDA kernels keep the
    whole loop on the card."""
    use_stall = stall_patience > 0 and convergence_threshold > 0.0
    freeze = convergence_threshold > 0.0
    rows = gamma_init.shape[0]
    gamma = gamma_init
    # Exact expectation at the init; the loop uses the fast form.
    exp_etheta = exp_dirichlet_expectation(gamma_init)
    best = torch.full((rows,), float("inf"), dtype=gamma_init.dtype,
                      device=gamma_init.device)
    age = torch.zeros((rows,), dtype=torch.int32, device=gamma_init.device)
    done = torch.zeros((rows,), dtype=torch.bool, device=gamma_init.device)
    i = 0
    while i < inner_iterations:
        gamma_prop = sweep(exp_etheta)
        gamma_new = (
            torch.where(done[:, None], gamma, gamma_prop)
            if freeze else gamma_prop
        )
        change = (gamma_new - gamma).abs().mean(dim=-1)
        best, age, done, exitable = _exit_update(
            change, best, age, done, convergence_threshold, use_stall,
            stall_patience,
        )
        i += 1
        gamma = gamma_new
        exp_etheta = exp_dirichlet_expectation_fast(gamma_new)
        if bool(exitable.all()):
            break
    return i, gamma


def _ragged_sweep_loop(
    ids, cnts, gamma_init, exp_elog_beta, alpha,
    inner_iterations, convergence_threshold, eps, stall_patience=0,
):
    """Ragged fixed point over one (ids, cnts) block: the block
    B = expElogbeta.T[ids] ([D, T, K]) is gathered once; each sweep is two
    batched contractions against it."""
    B = exp_elog_beta.T[ids]  # [D, T, K]

    def sweep(exp_etheta):
        phinorm = torch.einsum("dk,dtk->dt", exp_etheta, B) + eps
        return alpha[None, :] + exp_etheta * torch.einsum(
            "dt,dtk->dk", cnts / phinorm, B
        )

    return _fixed_point(sweep, gamma_init, inner_iterations,
                        convergence_threshold, stall_patience)


def estep_dense(
    counts: torch.Tensor,  # [D, Vc] float or bf16 (0 pads), Vc >= V
    gamma_init: torch.Tensor,  # [D, K]
    exp_elog_beta: torch.Tensor,  # [K, V]
    alpha: torch.Tensor,  # [K]
    inner_iterations: int = 50,
    convergence_threshold: float = 1e-5,
    eps: float = 1e-30,
    stall_patience: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense doc-term E-step — ``pylda_tpu``'s ``estep_dense`` in the input
    dtype.  Each sweep is two products against expElogbeta:

        phinorm = expEtheta @ expElogbeta + eps            # [D, Vc]
        gamma'  = alpha + expEtheta * ((counts / phinorm) @ expElogbeta^T)

    with the exit rule of ``_exit_update``; then sufficient statistics
    and the token score at the EXACT expectation of the converged gamma
    (``estep_dense_sstats``).  ``counts`` may arrive vocab-prepadded and
    in bf16, as for ``estep_dense_sstats``.  Returns (gamma, sstats,
    token_score, sweeps_used) with sweeps_used a 0-d int32 tensor."""
    # Padding columns are all-zero counts: leave them out of the sweeps.
    c = counts[:, : exp_elog_beta.shape[1]].to(gamma_init.dtype)

    def sweep(exp_etheta):
        phinorm = exp_etheta @ exp_elog_beta + eps
        return alpha[None, :] + exp_etheta * (
            (c / phinorm) @ exp_elog_beta.T
        )

    i, gamma = _fixed_point(sweep, gamma_init, inner_iterations,
                            convergence_threshold, stall_patience)
    sstats, token_score = estep_dense_sstats(
        counts, exp_dirichlet_expectation(gamma), exp_elog_beta, eps
    )
    return (gamma, sstats, token_score,
            torch.tensor(i, dtype=torch.int32, device=gamma.device))


def estep_ragged_gamma(
    ids: torch.Tensor,  # [D, T] int32 (0 on padded slots)
    cnts: torch.Tensor,  # [D, T] float (0 on padded slots)
    gamma_init: torch.Tensor,  # [D, K]
    exp_elog_beta: torch.Tensor,  # [K, V]
    alpha: torch.Tensor,  # [K]
    inner_iterations: int = 50,
    convergence_threshold: float = 1e-5,
    eps: float = 1e-30,
    stall_patience: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ragged fixed point only — returns (gamma, sweeps_used) with
    sweeps_used a 0-d int32 tensor, as ``pylda_tpu``'s
    ``estep_ragged_gamma``.  Sufficient statistics come separately from
    ``estep_dense_sstats``.  Exit rule: ``_exit_update``."""
    i, gamma = _ragged_sweep_loop(
        ids, cnts, gamma_init, exp_elog_beta, alpha,
        inner_iterations, convergence_threshold, eps,
        stall_patience=stall_patience,
    )
    return gamma, torch.tensor(i, dtype=torch.int32, device=gamma.device)


def estep_dense_sstats(
    counts: torch.Tensor,  # [D, Vc] float or bf16 (0 pads), Vc >= V
    exp_etheta: torch.Tensor,  # [D, K] exp E[log theta] at converged gamma
    exp_elog_beta: torch.Tensor,  # [K, V]
    eps: float = 1e-30,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter-free sufficient statistics + token score from dense counts:

        phinorm = expEtheta @ expElogbeta + eps          # [D, Vc]
        sstats  = expElogbeta * (expEtheta^T @ (counts / phinorm))[:, :V]
        score   = sum(counts * log(phinorm))

    ``counts`` may arrive vocab-prepadded (Vc > V, zero columns) and in
    bf16 (exact for integer counts <= 256): it is upcast to the compute
    dtype.  Padding columns see expElogbeta = 0 and are sliced away;
    all-zero rows contribute nothing."""
    dt = exp_etheta.dtype
    V = exp_elog_beta.shape[1]
    Vc = counts.shape[1]
    c = counts.to(dt)
    eeb_w = (
        torch.nn.functional.pad(exp_elog_beta, (0, Vc - V)) if Vc > V
        else exp_elog_beta
    )
    phinorm = exp_etheta @ eeb_w + eps  # [D, Vc]
    ratio = c / phinorm
    sstats = exp_elog_beta * (exp_etheta.T @ ratio)[:, :V]
    token_score = (c * torch.log(phinorm)).sum()
    return sstats, token_score
