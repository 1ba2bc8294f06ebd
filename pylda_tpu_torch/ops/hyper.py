"""Hyperparameter updates.

Newton–Raphson maximum-likelihood update for a Dirichlet concentration
vector given expected sufficient statistics — the Blei lda-c linear-time
shared-Hessian (Sherman–Morrison) form with halving backtracking, as
``pylda_tpu.ops.hyper.newton_dirichlet_mle``.  Used for both alpha (given
sum_d E[log theta_d]) and eta (given sum_k E[log beta_k]).  And the
Wallach slice sampler of the Gibbs engine (``slice_sample``).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
from torch.special import digamma, polygamma

# Backtracking halves the step from 1.0 while any component would leave
# (0, inf) and the factor is above 1e-10: 0.5**34 is the first factor at
# or below it, so at most 35 candidates are ever tried.
_DECAYS = tuple(0.5 ** j for j in range(35))


def newton_dirichlet_mle(
    concentration: torch.Tensor,  # [N] current alpha (or eta)
    elog_sum: torch.Tensor,  # [N] sum over observations of E[log p]
    num_observations: float,  # D for alpha, K for eta
    iterations: int = 100,
    tol: float = 1e-8,
) -> torch.Tensor:
    """Maximise sum_obs E[log Dir(p_obs | a)] over a > 0.

    gradient  g_k = N (psi(sum a) - psi(a_k)) + elog_sum_k
    Hessian   H = diag(-N psi'(a_k)) + 11^T N psi'(sum a)
    Newton step solved in O(K) via Sherman–Morrison; the step is halved
    until all components stay positive.  The backtracking picks the first
    admissible factor of all candidates at once on the device; the outer
    loop reads one scalar per Newton iteration to test convergence.
    """
    a = concentration
    n = torch.as_tensor(num_observations, dtype=a.dtype, device=a.device)
    decays = torch.tensor(_DECAYS, dtype=a.dtype, device=a.device)
    for _ in range(iterations):
        g = n * (digamma(a.sum()) - digamma(a)) + elog_sum
        h = -n * polygamma(1, a)  # trigamma
        z = n * polygamma(1, a.sum())
        c = (g / h).sum() / (1.0 / z + (1.0 / h).sum())
        step = (g - c) / h
        # ok[j]: no component of a - decays[j] * step is <= 0.
        trial = a[None, :] - decays[:, None] * step[None, :]
        ok = ~(trial <= 0).any(dim=1)
        ok[-1] = True  # the loop stops at the last factor regardless
        # argmax returns the first maximal index: the first admissible j.
        decay = decays[torch.argmax(ok.to(a.dtype))]
        a_new = a - decay * step
        # If backtracking bottomed out, keep the old value.
        a_new = torch.where((a_new > 0).all(), a_new, a)
        delta = (a_new - a).abs().max()
        a = a_new
        if not bool(delta > tol):
            break
    return a


def slice_sample(
    log_lik: Callable[[np.ndarray], float],
    x0: np.ndarray,
    rng: np.random.Generator,
    samples: int = 5,
    step: float = 3.0,
) -> np.ndarray:
    """Wallach's slice sampler on a point ``x0`` (Gibbs's (log alpha,
    log beta)): ``samples`` draws, each from a bracket of width ``step``
    placed at random around the current point and shrunk toward it on
    every rejection.  ``log_lik`` evaluates the point; the uniforms come
    from ``rng`` in the JAX engine's order, so the same seed and
    likelihood give the same path."""
    x0 = np.asarray(x0, dtype=np.float64)
    for _ in range(samples):
        log_u = log_lik(x0) + math.log(rng.random())
        lo = x0 - step * rng.random(x0.size)
        hi = lo + step
        while True:
            x1 = lo + rng.random(x0.size) * (hi - lo)
            if log_lik(x1) > log_u:
                x0 = x1
                break
            lo = np.where(x1 < x0, x1, lo)
            hi = np.where(x1 >= x0, x1, hi)
    return x0
