"""Dirichlet expectation and ELBO building blocks (PyTorch).

Counterparts of ``pylda_tpu.ops.dirichlet``: the exact forms use
``torch.special.digamma``/``gammaln``; the fast forms are the same shifted
asymptotic series, term for term, and fall back to the exact forms for
float64 inputs as the JAX functions do.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.special import digamma, gammaln

_HALF_LOG_2PI = 0.9189385332046727


def dirichlet_expectation(x: torch.Tensor,
                          row_sum: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """E[log p] for p ~ Dir(x) along the last axis: psi(x) - psi(sum x).
    ``row_sum`` ([..., 1]) passes sum x when x is a block of columns
    (``parallel/lam_shard.py``)."""
    if row_sum is None:
        row_sum = x.sum(dim=-1, keepdim=True)
    return digamma(x) - digamma(row_sum)


def exp_dirichlet_expectation(x: torch.Tensor) -> torch.Tensor:
    """exp(E[log p]) — the quantity the exp-domain E-step multiplies."""
    return torch.exp(dirichlet_expectation(x))


def _psi_parts(v: torch.Tensor):
    """psi(v) = ln(v + 2) + t(v): the 2-shift recurrence
    psi(x) = psi(x+2) - 1/x - 1/(x+1) with the asymptotic series
    psi(y) = ln y - 1/(2y) - 1/(12y^2) + 1/(120y^4) - 1/(252y^6)."""
    y = v + 2.0
    inv = 1.0 / y
    inv2 = inv * inv
    t = -0.5 * inv - inv2 * (
        1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 * (1.0 / 252.0))
    )
    return y, t - 1.0 / v - 1.0 / (v + 1.0)


def exp_dirichlet_expectation_fast(x: torch.Tensor,
                                   row_sum: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """exp(E[log p]) via the shifted asymptotic digamma (no reflection
    branch; x > 0 always holds in the E-step).  The ln(x+2) term cancels
    into the exp, so each element costs 3 divides, ~8 FMAs and one exp.
    Max |psi error| 1.2e-5 at x = 1e-3, smaller above; float64 inputs
    take the exact form.  ``row_sum`` as for ``dirichlet_expectation``."""
    if row_sum is None:
        row_sum = x.sum(dim=-1, keepdim=True)
    if x.dtype == torch.float64:
        return torch.exp(dirichlet_expectation(x, row_sum))
    y, t = _psi_parts(x)
    ys, ts = _psi_parts(row_sum)
    # exp(psi(x) - psi(s)) = (x+2) * exp(t - ln(s+2) - ts).
    return y * torch.exp(t - (torch.log(ys) + ts))


def digamma_fast(x: torch.Tensor) -> torch.Tensor:
    """psi(x) for x > 0 via the same 2-shift series; float64 exact."""
    if x.dtype == torch.float64:
        return digamma(x)
    y = x + 2.0
    inv = 1.0 / y
    inv2 = inv * inv
    t = -0.5 * inv - inv2 * (
        1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 * (1.0 / 252.0))
    )
    return torch.log(y) + t - 1.0 / x - 1.0 / (x + 1.0)


def gammaln_fast(x: torch.Tensor) -> torch.Tensor:
    """log Gamma(x) for x > 0 via a 3-shift Stirling series:
    lnG(x) = lnG(x+3) - ln(x (x+1) (x+2)) with
    lnG(y) = (y-1/2) ln y - y + ln(2 pi)/2 + 1/(12y) - 1/(360y^3)
    + 1/(1260y^5) at y >= 3.  float64 exact."""
    if x.dtype == torch.float64:
        return gammaln(x)
    y = x + 3.0
    inv = 1.0 / y
    inv2 = inv * inv
    series = inv * (
        1.0 / 12.0 - inv2 * (1.0 / 360.0 - inv2 * (1.0 / 1260.0))
    )
    stirling = (y - 0.5) * torch.log(y) - y + _HALF_LOG_2PI + series
    return stirling - torch.log(x * (x + 1.0) * (x + 2.0))


def theta_elbo_per_doc(gamma: torch.Tensor, alpha: torch.Tensor
                       ) -> torch.Tensor:
    """The theta terms of the bound of each document, [D]:
    sum_k (alpha_k - gamma_dk) Elogtheta_dk + log B(gamma_d) - log B(alpha)
    with log B(x) = sum gammaln(x) - gammaln(sum x)."""
    elog = digamma_fast(gamma) - digamma_fast(
        gamma.sum(dim=-1, keepdim=True)
    )
    per_doc = (
        ((alpha[None, :] - gamma) * elog).sum(-1)
        + gammaln_fast(gamma).sum(-1)
        - gammaln_fast(gamma.sum(-1))
    )
    prior = gammaln(alpha.sum()) - gammaln(alpha).sum()
    return per_doc + prior


def theta_elbo(
    gamma: torch.Tensor, alpha: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Per-document theta terms of the bound, masked and summed."""
    return (mask * theta_elbo_per_doc(gamma, alpha)).sum()


def beta_elbo(lam: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """Topic-side terms of the bound, with the fast [K, V] digamma and
    lgamma surfaces (float64 exact)."""
    elog = digamma_fast(lam) - digamma_fast(lam.sum(dim=-1, keepdim=True))
    s = ((eta[None, :] - lam) * elog).sum()
    s = s + gammaln_fast(lam).sum() - gammaln_fast(lam.sum(-1)).sum()
    s = s + lam.shape[0] * (gammaln(eta.sum()) - gammaln(eta).sum())
    return s
