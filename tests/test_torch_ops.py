"""The port's ops against pylda_tpu's on the same inputs (CPU).

Inputs are made with numpy from a seed and handed to both packages.  The
port's kernel wrappers take their plain PyTorch versions for CPU tensors,
so these tests hold the plain versions (and the wrappers' CPU route)
against the JAX functions; the CUDA kernels themselves are held against
the plain versions on the card (tests/test_torch_kernels_gpu.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sp
import torch

from pylda_tpu.ops import dirichlet as jd
from pylda_tpu.ops.estep import estep_dense_sstats as jax_dense_sstats
from pylda_tpu.ops.estep import estep_ragged_gamma as jax_ragged_gamma
from pylda_tpu.ops.hyper import newton_dirichlet_mle as jax_newton
from pylda_tpu_torch.ops import dirichlet as td
from pylda_tpu_torch.ops import ragged as ragged_mod
from pylda_tpu_torch.ops import sstats as sstats_mod
from pylda_tpu_torch.ops.estep import estep_dense_sstats, estep_ragged_gamma
from pylda_tpu_torch.ops.hyper import newton_dirichlet_mle


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(x)


# -- dirichlet ----------------------------------------------------------------


@pytest.mark.parametrize(
    "name", ["dirichlet_expectation", "exp_dirichlet_expectation",
             "exp_dirichlet_expectation_fast", "digamma_fast", "gammaln_fast"]
)
def test_dirichlet_forms_f32_match_jax(name):
    """f32 rtol 1e-6 (atol 1e-6 for values crossing zero)."""
    rng = np.random.default_rng(0)
    x = rng.gamma(2.0, 3.0, size=(64, 37)).astype(np.float32) + 1e-3
    got = getattr(td, name)(_t(x)).numpy()
    want = np.asarray(getattr(jd, name)(_j(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_elbo_terms_f32_match_jax():
    """Summed bound terms: the summands cancel (|terms| ~10x the result)
    and f32 sums run in another order in each package, so the tolerance
    is 1e-6 of the summed magnitude of the terms."""
    rng = np.random.default_rng(1)
    gamma = rng.gamma(5.0, 2.0, size=(48, 12)).astype(np.float32)
    alpha = np.full(12, 0.1, np.float32)
    mask = (rng.random(48) > 0.2).astype(np.float32)
    lam = rng.gamma(100.0, 0.01, size=(12, 300)).astype(np.float32) * 7.0
    eta = np.full(300, 0.01, np.float32)

    def magnitude(x, prior):
        x = x.astype(np.float64)
        elog = sp.psi(x) - sp.psi(x.sum(-1, keepdims=True))
        return (np.abs((prior - x) * elog).sum() + np.abs(sp.gammaln(x)).sum()
                + np.abs(sp.gammaln(x.sum(-1))).sum())

    got = float(td.theta_elbo(_t(gamma), _t(alpha), _t(mask)))
    want = float(jd.theta_elbo(_j(gamma), _j(alpha), _j(mask)))
    assert abs(got - want) <= 1e-6 * magnitude(gamma, alpha)
    got = float(td.beta_elbo(_t(lam), _t(eta)))
    want = float(jd.beta_elbo(_j(lam), _j(eta)))
    assert abs(got - want) <= 1e-6 * magnitude(lam, eta)


def test_dirichlet_exact_forms_f64():
    """f64 inputs take the exact forms: 1e-12 against scipy."""
    rng = np.random.default_rng(2)
    x = rng.gamma(2.0, 3.0, size=(16, 9)) + 1e-3
    want = sp.psi(x) - sp.psi(x.sum(-1, keepdims=True))
    np.testing.assert_allclose(td.dirichlet_expectation(_t(x)).numpy(), want,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        td.exp_dirichlet_expectation_fast(_t(x)).numpy(), np.exp(want),
        rtol=1e-12,
    )
    np.testing.assert_allclose(td.digamma_fast(_t(x)).numpy(), sp.psi(x),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(td.gammaln_fast(_t(x)).numpy(), sp.gammaln(x),
                               rtol=1e-12, atol=1e-12)


# -- hyper --------------------------------------------------------------------


@pytest.mark.parametrize("n_obs,scale", [(200.0, 0.1), (8.0, 0.01)])
def test_newton_matches_jax(n_obs, scale):
    """The same statistics through both Newton solvers: rtol 1e-5."""
    rng = np.random.default_rng(3)
    N = 10
    p = rng.dirichlet(np.full(N, 0.5), size=int(n_obs))
    elog_sum = np.log(p + 1e-6).sum(0).astype(np.float32)
    a0 = np.full(N, scale, np.float32)
    got = newton_dirichlet_mle(_t(a0), _t(elog_sum), n_obs).numpy()
    want = np.asarray(jax_newton(_j(a0), _j(elog_sum), jnp.asarray(n_obs)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# -- dense sufficient statistics ------------------------------------------


def _sstats_case(D, V, K, seed, v_pad=0, pad_rows=0):
    """Counts [D + pad_rows, V + v_pad] with zero padding on both axes
    (padding rows carry doc 0's expEtheta, as the engine gathers them)."""
    rng = np.random.default_rng(seed)
    counts = rng.poisson(0.02, size=(D, V)).astype(np.float32)
    counts[rng.integers(0, D, 3)] = 0.0
    counts = np.pad(counts, ((0, pad_rows), (0, v_pad)))
    gamma = rng.gamma(100.0, 0.01, size=(D, K)).astype(np.float32)
    lam = rng.gamma(100.0, 0.01, size=(K, V)).astype(np.float32)
    et = np.asarray(jd.exp_dirichlet_expectation(_j(gamma)))
    et = np.concatenate([et, np.repeat(et[:1], pad_rows, axis=0)])
    eeb = np.asarray(jd.exp_dirichlet_expectation(_j(lam)))
    return counts, et, eeb


@pytest.mark.parametrize(
    "D,V,K,v_pad,pad_rows",
    [
        (96, 640, 7, 384, 32),    # padding on every axis
        (256, 1024, 32, 0, 0),
        (64, 384, 100, 640, 0),   # K=100, vocab prepad to 1024
        (40, 1000, 100, 24, 24),
    ],
)
@pytest.mark.parametrize("bf16", [False, True])
def test_dense_sstats_matches_jax(D, V, K, v_pad, pad_rows, bf16):
    """rtol 2e-5 (atol 1e-6) on sstats, rel 2e-5 on the score; bf16
    counts are exact integers, so both sides see the same values."""
    counts, et, eeb = _sstats_case(D, V, K, D + V + K, v_pad, pad_rows)
    ct = _t(counts).to(torch.bfloat16) if bf16 else _t(counts)
    cj = _j(counts).astype(jnp.bfloat16) if bf16 else _j(counts)
    ss, tok = estep_dense_sstats(ct, _t(et), _t(eeb))
    ss_j, tok_j = jax_dense_sstats(cj, _j(et), _j(eeb))
    assert ss.shape == (K, V)
    np.testing.assert_allclose(ss.numpy(), np.asarray(ss_j), rtol=2e-5,
                               atol=1e-6)
    assert float(tok) == pytest.approx(float(tok_j), rel=2e-5)


def test_dense_sstats_wrapper_cpu_route_matches_pallas_interpret():
    """The wrapper on CPU tensors is the plain version (no launch); one
    tiny case also against the Pallas kernel in interpret mode."""
    from pylda_tpu.ops.pallas_sstats import pallas_dense_sstats

    counts, et, eeb = _sstats_case(5, 70, 3, seed=1, v_pad=58, pad_rows=3)
    before = sstats_mod.LAUNCHES
    ss, tok = sstats_mod.dense_sstats(_t(counts), _t(et), _t(eeb))
    assert sstats_mod.LAUNCHES == before
    ref_ss, ref_tok = estep_dense_sstats(_t(counts), _t(et), _t(eeb))
    np.testing.assert_array_equal(ss.numpy(), ref_ss.numpy())
    ss_p, tok_p = pallas_dense_sstats(_j(counts), _j(et), _j(eeb),
                                      interpret=True)
    np.testing.assert_allclose(ss.numpy(), np.asarray(ss_p), rtol=2e-5,
                               atol=1e-6)
    assert float(tok) == pytest.approx(float(tok_p), rel=2e-5, abs=1e-6)


# -- ragged gamma fixed point ---------------------------------------------


def _ragged_case(D=37, T=21, K=13, V=500, seed=7):
    """Unaligned shapes with padded token slots and padded doc rows."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (D, T)).astype(np.int32)
    cnts = rng.integers(1, 5, (D, T)).astype(np.float32)
    cnts[:, 17:] = 0
    ids[:, 17:] = 0
    cnts[-3:] = 0
    ids[-3:] = 0
    lam = rng.gamma(1.0, 1.0, (K, V)).astype(np.float32)
    eeb = np.asarray(jd.exp_dirichlet_expectation(_j(lam)))
    alpha = np.full(K, 0.1, np.float32)
    g0 = rng.gamma(100.0, 0.01, (D, K)).astype(np.float32)
    return ids, cnts, g0, eeb, alpha


def _both_ragged(case, **kw):
    ids, cnts, g0, eeb, alpha = case
    g, s = estep_ragged_gamma(_t(ids), _t(cnts), _t(g0), _t(eeb), _t(alpha),
                              **kw)
    g_j, s_j = jax_ragged_gamma(_j(ids), _j(cnts), _j(g0), _j(eeb),
                                _j(alpha), **kw)
    return g.numpy(), int(s), np.asarray(g_j), int(s_j)


@pytest.mark.parametrize("inner", [1, 12])
def test_ragged_gamma_pinned_sweeps_match_jax(inner):
    """threshold 0 runs exactly `inner` sweeps in both: rtol 1e-5."""
    g, s, g_j, s_j = _both_ragged(_ragged_case(), inner_iterations=inner,
                                  convergence_threshold=0.0)
    assert s == s_j == inner
    np.testing.assert_allclose(g, g_j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed,thresh", [(7, 1e-5), (11, 1e-3)])
def test_ragged_gamma_default_exit_matches_jax(seed, thresh):
    """Default exit rule (freeze + stall, patience 6): per row rtol 5e-4,
    the sweep count within +-1."""
    g, s, g_j, s_j = _both_ragged(
        _ragged_case(D=64, T=40, K=10, seed=seed), inner_iterations=50,
        convergence_threshold=thresh, stall_patience=6,
    )
    assert abs(s - s_j) <= 1
    np.testing.assert_allclose(g, g_j, rtol=5e-4, atol=5e-4)
    # gamma row sums = sum(alpha) + doc length (exact invariant).
    ids, cnts, *_ = _ragged_case(D=64, T=40, K=10, seed=seed)
    np.testing.assert_allclose(g.sum(1), 0.1 * 10 + cnts.sum(1), rtol=1e-4)


def test_ragged_wrapper_cpu_route_matches_pallas_interpret():
    """The wrapper on CPU tensors is the plain version (no launch); at
    threshold 0 it matches the Pallas kernel in interpret mode to 5e-4
    (its in-kernel digamma series differs)."""
    from pylda_tpu.ops.pallas_ragged import pallas_estep_ragged_gamma

    ids, cnts, g0, eeb, alpha = _ragged_case()
    before = ragged_mod.LAUNCHES
    g, s = ragged_mod.ragged_gamma(_t(ids), _t(cnts), _t(g0), _t(eeb),
                                   _t(alpha), inner_iterations=30,
                                   convergence_threshold=0.0)
    assert ragged_mod.LAUNCHES == before and int(s) == 30
    g_p, _ = pallas_estep_ragged_gamma(
        _j(ids), _j(cnts), _j(g0), _j(eeb), _j(alpha), inner_iterations=30,
        convergence_threshold=0.0, interpret=True,
    )
    np.testing.assert_allclose(g.numpy(), np.asarray(g_p), rtol=5e-4,
                               atol=5e-4)


@pytest.mark.parametrize("K", [13, 100])
def test_gather_table_pads_topics_to_four(K):
    """The ragged kernel's gather table: expElogbeta^T with the topic axis
    zero-padded to a multiple of 4 (exact copy, no arithmetic)."""
    eeb = torch.rand(K, 57)
    table = ragged_mod.gather_table(eeb)
    ldb = -(-K // 4) * 4
    assert table.shape == (57, ldb) and table.is_contiguous()
    assert torch.equal(table[:, :K], eeb.T)
    assert not table[:, K:].any()


# -- K above 256 (the CUDA kernels' wide builds) -------------------------------


@pytest.mark.parametrize("bf16", [False, True])
def test_dense_sstats_k300_matches_pallas_interpret(bf16):
    """K = 300 (the Pallas kernel pads it to 384, the CUDA kernel to 512):
    the plain version against the Pallas kernel in interpret mode, rtol
    2e-5 (atol 1e-6) on sstats and rel 2e-5 on the score."""
    from pylda_tpu.ops.pallas_sstats import pallas_dense_sstats

    counts, et, eeb = _sstats_case(24, 300, 300, seed=5, v_pad=84, pad_rows=8)
    counts[3, :40] += 1.0  # a long row
    ct = _t(counts).to(torch.bfloat16) if bf16 else _t(counts)
    cj = _j(counts).astype(jnp.bfloat16) if bf16 else _j(counts)
    ss, tok = sstats_mod.dense_sstats(ct, _t(et), _t(eeb))
    ss_p, tok_p = pallas_dense_sstats(cj, _j(et), _j(eeb), interpret=True)
    assert ss.shape == (300, 300)
    np.testing.assert_allclose(ss.numpy(), np.asarray(ss_p), rtol=2e-5,
                               atol=1e-6)
    assert float(tok) == pytest.approx(float(tok_p), rel=2e-5)


@pytest.mark.parametrize("inner", [1, 12])
def test_ragged_gamma_k300_pinned_sweeps_match_jax(inner):
    """K = 300 at threshold 0: the XLA function, rtol 1e-4 (atol 1e-5):
    phinorm sums 300 products in another order in each package, and 12
    sweeps of the fixed point carry that noise (up to 5.7e-5 relative
    here), ten times K = 13's."""
    g, s, g_j, s_j = _both_ragged(_ragged_case(D=30, T=21, K=300, V=400),
                                  inner_iterations=inner,
                                  convergence_threshold=0.0)
    assert s == s_j == inner
    np.testing.assert_allclose(g, g_j, rtol=1e-4, atol=1e-5)


def test_ragged_gamma_k300_matches_pallas_interpret():
    """K = 300 at threshold 0: the wrapper's CPU route against the Pallas
    kernel in interpret mode to 5e-4 (its in-kernel digamma series
    differs), as at K = 13."""
    from pylda_tpu.ops.pallas_ragged import pallas_estep_ragged_gamma

    ids, cnts, g0, eeb, alpha = _ragged_case(D=20, T=21, K=300, V=400)
    g, s = ragged_mod.ragged_gamma(_t(ids), _t(cnts), _t(g0), _t(eeb),
                                   _t(alpha), inner_iterations=30,
                                   convergence_threshold=0.0)
    assert int(s) == 30
    g_p, _ = pallas_estep_ragged_gamma(
        _j(ids), _j(cnts), _j(g0), _j(eeb), _j(alpha), inner_iterations=30,
        convergence_threshold=0.0, interpret=True,
    )
    np.testing.assert_allclose(g.numpy(), np.asarray(g_p), rtol=5e-4,
                               atol=5e-4)


def test_ragged_gamma_k300_default_exit_matches_jax():
    """K = 300, default exit rule (freeze + stall, patience 6): per row
    rtol 5e-4 (atol 5e-4 + K * threshold), the sweep count within +-1."""
    case = _ragged_case(D=40, T=30, K=300, V=600, seed=3)
    g, s, g_j, s_j = _both_ragged(case, inner_iterations=50,
                                  convergence_threshold=1e-5,
                                  stall_patience=6)
    assert abs(s - s_j) <= 1
    np.testing.assert_allclose(g, g_j, rtol=5e-4, atol=5e-4 + 300 * 1e-5)


def test_ragged_doc_bound_sums_to_the_bound_terms():
    """Each row's share of the bound, summed over the rows, is the token
    score of the dense counts at the exact expectation plus the theta
    terms (float64, rel 1e-12)."""
    from pylda_tpu_torch.ops.dirichlet import (
        exp_dirichlet_expectation,
        theta_elbo,
    )
    from pylda_tpu_torch.ops.estep import ragged_doc_bound

    ids, cnts, g0, eeb, alpha = _ragged_case(D=30, T=21, K=300, V=400)
    ids, cnts, g, eeb, alpha = (_t(x).double() if x.dtype != np.int32
                                else _t(x) for x in (ids, cnts, g0, eeb,
                                                     alpha))
    per_row = ragged_doc_bound(ids, cnts, g, eeb, alpha)
    dense = torch.zeros((30, 400), dtype=torch.float64)
    dense.index_put_((torch.arange(30)[:, None].expand(-1, 21), ids.long()),
                     cnts, accumulate=True)
    _, tok = estep_dense_sstats(dense, exp_dirichlet_expectation(g), eeb)
    want = float(tok) + float(theta_elbo(g, alpha, torch.ones(30,
                                                              dtype=torch.float64)))
    assert per_row.shape == (30,)
    assert float(per_row.sum()) == pytest.approx(want, rel=1e-12)
