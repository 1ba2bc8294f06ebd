"""The invariant the row-resident gamma kernels rest on, on the CPU.

The batched fixed point (``estep_ragged_gamma``, ``estep_dense``) runs
sweep after sweep over the batch and exits at S*, the first sweep at
which every row is exitable.  The CUDA kernels (``csrc/row_fixed_point.cuh``)
run row after row instead: each row alone until it is done or at the cap,
counting per sweep the rows not exitable; S* is the first sweep at which
that count is 0, and a row that ran past S* is run again for exactly S*
sweeps.  Here that row-major schedule is emulated with the plain sweep of
one row, and must give the batch result and sweep count: exactly in
float64, to rtol 1e-6 in float32.  One row's sweep is computed at the
batch's shape with every other row's expEtheta set to 1 and only its own
row kept, so that its products block their sums as the batch's do.
"""

import numpy as np
import pytest
import torch

from pylda_tpu_torch.ops.dirichlet import (
    exp_dirichlet_expectation,
    exp_dirichlet_expectation_fast,
)
from pylda_tpu_torch.ops.estep import (
    _exit_update,
    estep_dense,
    estep_ragged_gamma,
)

D, T, K, V = 24, 16, 6, 40
INNER = 50


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (D, T)).astype(np.int32)
    cnts = rng.integers(1, 4, (D, T)).astype(np.float64)
    fill = rng.integers(1, T + 1, D)
    pad = np.arange(T)[None, :] >= fill[:, None]
    ids[pad], cnts[pad] = 0, 0.0
    ids[-2:], cnts[-2:] = 0, 0.0  # all-padding rows
    dense = np.zeros((D, V + 3))  # 3 zero padding columns past V
    np.add.at(dense, (np.repeat(np.arange(D), T), ids.ravel()), cnts.ravel())
    lam = rng.gamma(0.3, 1.0, (K, V))  # peaked topics: S* < INNER at 1e-3
    eeb = exp_dirichlet_expectation(torch.tensor(lam, dtype=dtype))
    alpha = torch.full((K,), 0.1, dtype=dtype)
    g0 = torch.ones((D, K), dtype=dtype)
    return (torch.tensor(ids), torch.tensor(cnts, dtype=dtype),
            torch.tensor(dense, dtype=dtype), eeb, alpha, g0)


def _row_major(sweep_row, g0, threshold, patience):
    """The kernels' schedule with the plain sweep of one row:
    (gamma [D, K], S*, phase-1 sweeps of each row)."""
    use_stall = patience > 0 and threshold > 0.0

    def run(d, max_sweeps, count):
        g = g0[d:d + 1]
        et = exp_dirichlet_expectation(g)
        best = torch.full((1,), float("inf"), dtype=g.dtype)
        age = torch.zeros((1,), dtype=torch.int32)
        done = torch.zeros((1,), dtype=torch.bool)
        s = 0
        while s < max_sweeps:
            g_new = sweep_row(d, et)
            change = (g_new - g).abs().mean(dim=-1)
            best, age, done, exitable = _exit_update(
                change, best, age, done, threshold, use_stall, patience)
            if count is not None and not bool(exitable):
                count[s] += 1
            g, et = g_new, exp_dirichlet_expectation_fast(g_new)
            s += 1
            if bool(done):
                break
        return g[0], s

    not_exitable = [0] * INNER
    first = [run(d, INNER, not_exitable) for d in range(g0.shape[0])]
    s_star = next((s + 1 for s, n in enumerate(not_exitable) if n == 0),
                  INNER)
    gamma = torch.stack([
        g if s <= s_star else run(d, s_star, None)[0]
        for d, (g, s) in enumerate(first)
    ])
    return gamma, s_star, [s for _, s in first]


def _alone(sweep):
    """sweep(exp_etheta [D, K]) -> [D, K], as a function of one row d and
    its expEtheta [1, K] that reads nothing of the other rows."""

    def sweep_row(d, et):
        full = torch.ones((D, et.shape[1]), dtype=et.dtype)
        full[d] = et[0]
        return sweep(full)[d:d + 1]

    return sweep_row


def _ragged_sweep_row(ids, cnts, eeb, alpha, eps):
    B = eeb.T[ids]  # [D, T, K]

    def sweep(et):
        phinorm = torch.einsum("dk,dtk->dt", et, B) + eps
        return alpha[None, :] + et * torch.einsum("dt,dtk->dk",
                                                  cnts / phinorm, B)

    return _alone(sweep)


def _dense_sweep_row(counts, eeb, alpha, eps):
    c = counts[:, : eeb.shape[1]]

    def sweep(et):
        phinorm = et @ eeb + eps
        return alpha[None, :] + et * ((c / phinorm) @ eeb.T)

    return _alone(sweep)


def _compare(got, want, dtype):
    if dtype == torch.float64:
        torch.testing.assert_close(got, want, rtol=0.0, atol=0.0)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("patience", [0, 6], ids=["no_stall", "stall6"])
@pytest.mark.parametrize("threshold", [1e-5, 1e-3])
@pytest.mark.parametrize("layout", ["ragged", "dense"])
def test_row_major_schedule_matches_batch(layout, threshold, patience, dtype):
    ids, cnts, dense, eeb, alpha, g0 = _inputs(dtype)
    eps = 1e-30
    kw = dict(inner_iterations=INNER, convergence_threshold=threshold,
              eps=eps, stall_patience=patience)
    if layout == "ragged":
        want, sweeps = estep_ragged_gamma(ids, cnts, g0, eeb, alpha, **kw)
        sweep_row = _ragged_sweep_row(ids, cnts, eeb, alpha, eps)
    else:
        want, _, _, sweeps = estep_dense(dense, g0, eeb, alpha, **kw)
        sweep_row = _dense_sweep_row(dense, eeb, alpha, eps)
    got, s_star, runs = _row_major(sweep_row, g0, threshold, patience)
    assert s_star == int(sweeps)
    _compare(got, want, dtype)
    if threshold == 1e-3:
        assert s_star < INNER
    if patience:
        # A stalled row that is not done ran past S*: the re-run path of
        # the schedule is exercised.
        assert max(runs) > s_star


def test_row_major_schedule_pinned_sweeps():
    """threshold 0: no row freezes or exits; every row runs the cap."""
    ids, cnts, _, eeb, alpha, g0 = _inputs(torch.float64, seed=3)
    kw = dict(inner_iterations=7, convergence_threshold=0.0, eps=1e-30)
    want, sweeps = estep_ragged_gamma(ids, cnts, g0, eeb, alpha, **kw)
    sweep_row = _ragged_sweep_row(ids, cnts, eeb, alpha, 1e-30)
    gamma = []
    for d in range(D):
        g = g0[d:d + 1]
        et = exp_dirichlet_expectation(g)
        for _ in range(7):
            g = sweep_row(d, et)
            et = exp_dirichlet_expectation_fast(g)
        gamma.append(g[0])
    assert int(sweeps) == 7
    _compare(torch.stack(gamma), want, torch.float64)
