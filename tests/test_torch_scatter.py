"""The port's scatter E-step (``ops/estep.estep_ragged``) and the engines'
scatter route against pylda_tpu's (CPU).

Inputs are made with numpy from a seed and handed to both packages.  The
scatter route runs where the JAX engines run it: ``sstats_mode="scatter"``
and a corpus over ``sstats_dense_total_budget_mb``.

Tolerances (measured on these inputs):

- ``estep_ragged`` at pinned sweeps (threshold 0): gamma as the ragged
  fixed point's own pinned test (tests/test_torch_ops.py), rtol 1e-5
  (atol 1e-6), and at K = 300 rtol 1e-4 (atol 1e-5) (seen 5.3e-6 /
  9.0e-5); sstats rel 1e-5 of the largest entry (seen <= 1.6e-6), the
  score rel 1e-5 (seen <= 6.9e-7), the sweeps equal.  bf16 mode after
  one pinned sweep (past one the bf16 map limit-cycles,
  tests/test_torch_bf16.py), the same bars;
- the scatter alone at JAX's gamma (no fixed point between them): every
  sstats entry rtol 2e-5 (atol 1e-6 of the largest; seen <= 5.2e-6), the
  score rel 1e-6;
- float64 against ``OracleVB``: the bars of tests/test_estep_f64.py
  (gamma and sstats < 1e-8, score < 1e-6);
- the engines as in tests/test_torch_vb.py and tests/test_torch_svi.py:
  bounds rel 1e-4, lambda rtol 1e-4 (atol 1e-4), alpha and eta rtol
  1e-4, gamma rtol 5e-4 (atol 5e-4);
- the scatter route against the port's own dense-sstats route from one
  lambda at pinned sweeps with no document split over rows (summation
  order only): sstats rel 1e-5 of the largest entry, the ELBO rel 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylda_tpu.corpus.synthetic import synthetic_corpus as jax_synthetic
from pylda_tpu.models import StochasticVariationalBayes as JaxSVI
from pylda_tpu.models import VariationalBayes as JaxVB
from pylda_tpu.oracle import OracleVB
from pylda_tpu.ops.estep import estep_ragged as jax_estep_ragged
from pylda_tpu.utils.config import LDAConfig as JaxConfig
from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.models import StochasticVariationalBayes, VariationalBayes
from pylda_tpu_torch.ops import ragged as ragged_mod
from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation
from pylda_tpu_torch.ops.estep import estep_ragged, scatter_sstats
from pylda_tpu_torch.ops.ragged import gather_table
from pylda_tpu_torch.utils.config import LDAConfig

GAMMA_RTOL = {5: 1e-5, 16: 1e-5, 300: 1e-4}
GAMMA_ATOL = {5: 1e-6, 16: 1e-6, 300: 1e-5}
SSTATS_REL, SCORE_REL = 1e-5, 1e-5
SCATTER_RTOL = 2e-5
RTOL, LAM_ATOL, GAMMA_TOL = 1e-4, 1e-4, 5e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(K, D=48, T=32, live=24, V=400, seed=0):
    """A ragged block with padding slots (id 0, count 0) and three
    padding rows, a sharp expElogbeta (float32), alpha 1/K."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (D, T)).astype(np.int32)
    cnts = rng.integers(1, 4, (D, T)).astype(np.float32)
    ids[:, live:] = 0
    cnts[:, live:] = 0.0
    ids[-3:] = 0
    cnts[-3:] = 0.0
    lam = rng.gamma(0.1, 1.0, (K, V)) * 100.0 + 0.01
    eeb = exp_dirichlet_expectation(torch.tensor(lam)).float().numpy()
    return ids, cnts, eeb, np.full((K,), 1.0 / K, np.float32)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- the op ------------------------------------------------------------------------


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [5, 16, 300])
def test_estep_ragged_matches_jax(K, cd):
    ids, cnts, eeb, alpha = _inputs(K)
    D, V = ids.shape[0], eeb.shape[1]
    kw = dict(inner_iterations=8 if cd == "float32" else 1,
              convergence_threshold=0.0, compute_dtype=cd)
    want = [np.asarray(x) for x in jax_estep_ragged(
        jnp.asarray(ids), jnp.asarray(cnts), jnp.ones((D, K)),
        jnp.asarray(eeb), jnp.asarray(alpha), num_types=V, **kw)]
    before = ragged_mod.LAUNCHES + ragged_mod.BF16_LAUNCHES
    got = [x.numpy() for x in estep_ragged(
        torch.tensor(ids), torch.tensor(cnts), torch.ones((D, K)),
        torch.tensor(eeb), torch.tensor(alpha), **kw)]
    assert ragged_mod.LAUNCHES + ragged_mod.BF16_LAUNCHES == before
    (g, ss, tok, s), (g_j, ss_j, tok_j, s_j) = got, want
    np.testing.assert_allclose(g, g_j, rtol=GAMMA_RTOL[K], atol=GAMMA_ATOL[K])
    assert ss.shape == (K, V) and _rel(ss, ss_j) <= SSTATS_REL
    assert abs(float(tok) - float(tok_j)) <= SCORE_REL * abs(float(tok_j))
    assert int(s) == int(s_j) == kw["inner_iterations"]
    # The scatter alone, at JAX's own gamma.
    ss2, tok2 = scatter_sstats(
        torch.tensor(ids), torch.tensor(cnts),
        exp_dirichlet_expectation(torch.tensor(g_j)), torch.tensor(eeb),
        gather_table(torch.tensor(eeb), cd), compute_dtype=cd)
    np.testing.assert_allclose(ss2.numpy(), ss_j, rtol=SCATTER_RTOL,
                               atol=1e-6 * np.abs(ss_j).max())
    assert float(tok2) == pytest.approx(float(tok_j), rel=1e-6)


def test_scatter_padding_adds_nothing():
    """Padding slots (id 0, count 0) and padding rows add exactly 0: word
    0, which no real slot holds, gets sstats of exactly 0 (padding
    stays 0 / phinorm with phinorm >= eps, never 0 / 0), and the block
    without them gives the same statistics up to summation order (rtol
    1e-6, atol 1e-7 of the largest entry)."""
    ids, cnts, eeb, _ = _inputs(16)
    assert not (ids[:-3, :24] == 0).any()
    rng = np.random.default_rng(5)
    et = torch.tensor(rng.gamma(1.0, 1.0, (ids.shape[0], 16))
                      .astype(np.float32))
    eeb_t = gather_table(torch.tensor(eeb))
    ss, tok = scatter_sstats(torch.tensor(ids), torch.tensor(cnts), et,
                             torch.tensor(eeb), eeb_t)
    ss_t, tok_t = scatter_sstats(torch.tensor(ids[:-3, :24]),
                                 torch.tensor(cnts[:-3, :24]), et[:-3],
                                 torch.tensor(eeb), eeb_t)
    assert bool((ss[:, 0] == 0).all()) and bool(torch.isfinite(ss).all())
    np.testing.assert_allclose(ss.numpy(), ss_t.numpy(), rtol=1e-6,
                               atol=1e-7 * float(ss_t.abs().max()))
    assert float(tok) == pytest.approx(float(tok_t), rel=1e-6)


def test_scatter_profiler_range_holds_the_scatter():
    """Under torch.profiler, estep_ragged's scatter runs inside one
    SCATTER_RANGE a call (its sort and segmented sums among the range's
    ops) and the fixed point outside it, so a profile can split the
    scatter's device time from the gamma kernel's."""
    from pylda_tpu_torch.ops.estep import SCATTER_RANGE
    from scripts.torch_engine_profile import is_range

    ids, cnts, eeb, alpha = (torch.tensor(x) for x in _inputs(16))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            estep_ragged(ids, cnts, torch.ones((ids.shape[0], 16)), eeb,
                         alpha, inner_iterations=3, convergence_threshold=0.0)
    ranges = [e for e in prof.events() if e.name == SCATTER_RANGE]
    assert len(ranges) == 2 and all(is_range(e) for e in ranges)
    inside = {c.name for e in ranges for c in e.cpu_children}
    assert {"aten::sort", "aten::segment_reduce"} <= inside
    assert not any(is_range(e) for e in prof.events() if e.name == "aten::sort")


def test_busy_time_leaves_ranges_out():
    """The busy time is the union of the device's kernel intervals: a
    range's device span (which covers the gaps between its kernels) and
    host events add nothing, and overlapping kernels count once."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from scripts.torch_engine_profile import busy_us

    def event(a, b, device=DeviceType.CUDA, annotation=False):
        return SimpleNamespace(time_range=SimpleNamespace(start=a, end=b),
                               device_type=device,
                               is_user_annotation=annotation)

    kernels = [event(0, 10), event(5, 12), event(20, 30)]
    assert busy_us(kernels) == 22
    assert busy_us(kernels + [event(0, 30, annotation=True),
                              event(0, 100, device=DeviceType.CPU)]) == 22


def test_estep_ragged_matches_oracle_in_f64():
    """tests/test_estep_f64.py's ragged half: one 128-wide bucket in
    float64 against the float64 per-document oracle."""
    kw = dict(num_docs=64, num_topics=5, num_types=120, mean_doc_length=40,
              seed=7)
    corpus = synthetic_corpus(**kw)[0]
    lam_init = np.random.default_rng(42).gamma(100.0, 0.01, size=(5, 120))
    ora = OracleVB(jax_synthetic(**kw)[0], num_topics=5, alpha=0.2,
                   eta=0.01, seed=0, inner_iterations=100,
                   convergence_threshold=1e-12, gamma_init="ones")
    ora.lam = lam_init.copy()
    g_o, ss_o, tok_o = ora.e_step()
    (b,) = corpus.to_ragged_buckets(bucket_sizes=(128,), doc_pad_multiple=64)
    g, ss, tok, _ = estep_ragged(
        torch.tensor(b.ids), torch.tensor(b.cnts, dtype=torch.float64),
        torch.ones((b.ids.shape[0], 5), dtype=torch.float64),
        exp_dirichlet_expectation(torch.tensor(lam_init)),
        torch.full((5,), 0.2, dtype=torch.float64),
        inner_iterations=100, convergence_threshold=1e-12, eps=1e-100)
    order = {int(d): r for r, d in enumerate(b.doc_ids) if d >= 0}
    g = g.numpy()[[order[d] for d in range(64)]]
    assert np.abs(g - g_o).max() < 1e-8
    assert np.abs(ss.numpy() - ss_o).max() < 1e-8
    assert abs(float(tok) - tok_o) < 1e-6


# -- batch VB ----------------------------------------------------------------------

VB_CFG = dict(number_of_topics=8, dense_vocab_threshold=256,
              doc_pad_multiple=8, hyper_parameter_optimize_interval=2,
              seed=0, bucket_sizes=(16, 32), bucket_policy="fixed")


@pytest.fixture(scope="module")
def vb_data():
    kw = dict(num_docs=96, num_topics=8, num_types=600, mean_doc_length=40.0,
              seed=3)
    corpus, beta, _ = synthetic_corpus(**kw)
    held = dict(num_docs=16, num_topics=8, num_types=600,
                mean_doc_length=40.0, seed=4, beta=beta)
    return dict(corpus=corpus, corpus_j=jax_synthetic(**kw)[0],
                test=synthetic_corpus(**held)[0],
                test_j=jax_synthetic(**held)[0],
                lam0=np.random.default_rng(11).gamma(100.0, 0.01, (8, 600)))


def _assert_state_close(ours, theirs):
    for f in ("lam", "alpha", "eta"):
        np.testing.assert_allclose(
            getattr(ours.state, f).numpy(),
            np.asarray(getattr(theirs.state, f)), rtol=RTOL,
            atol=LAM_ATOL if f == "lam" else 0.0, err_msg=f)


@pytest.mark.parametrize(
    "extra", [dict(sstats_mode="scatter"), dict(sstats_dense_total_budget_mb=0)],
    ids=["sstats_mode_scatter", "over_budget"])
def test_vb_scatter_route_matches_jax(vb_data, extra):
    """Fixed 16/32-slot buckets split documents with more unique types
    over several rows: the scatter route's bound takes one theta term a
    row, as the JAX engine's does."""
    cfg = {**VB_CFG, **extra}
    ours = VariationalBayes(LDAConfig(**cfg), device="cpu")
    ours.initialize(vb_data["corpus"], lam_init=vb_data["lam0"])
    theirs = JaxVB(JaxConfig(**cfg))
    theirs.initialize(vb_data["corpus_j"], lam_init=vb_data["lam0"])
    assert ours._sstats_plan is None and theirs._sstats_plan is None
    real = np.concatenate([b.doc_ids for b in ours._batches])
    real = real[real >= 0]
    assert np.unique(real).size < real.size, "no document split over rows"
    e_ours = [ours.learning() for _ in range(2)] + ours.learning_many(2)
    e_theirs = ([theirs.learning() for _ in range(2)]
                + theirs.learning_many(2))
    np.testing.assert_allclose(e_ours, e_theirs, rtol=RTOL)
    _assert_state_close(ours, theirs)
    np.testing.assert_allclose(ours.gamma, np.asarray(theirs.gamma),
                               rtol=GAMMA_TOL, atol=GAMMA_TOL)
    ll, g = ours.inference(vb_data["test"])
    ll_j, g_j = theirs.inference(vb_data["test_j"])
    assert ll == pytest.approx(ll_j, rel=RTOL)
    np.testing.assert_allclose(g, np.asarray(g_j), rtol=GAMMA_TOL,
                               atol=GAMMA_TOL)


def test_vb_scatter_route_against_dense_sstats_route(vb_data):
    """One E-step from one lambda at pinned sweeps, no document split
    over rows: the two routes differ in summation order only."""
    cfg = dict(VB_CFG, bucket_sizes=(64, 128), inner_iterations=12,
               convergence_threshold=0.0)
    out = {}
    for mode in ("auto", "scatter"):
        eng = VariationalBayes(LDAConfig(**cfg, sstats_mode=mode),
                               device="cpu")
        eng.initialize(vb_data["corpus"], lam_init=vb_data["lam0"])
        assert (eng._sstats_plan is None) == (mode == "scatter")
        elbo = eng.learning()
        out[mode] = (elbo, (eng.state.lam - eng.state.eta[None, :]).numpy())
    assert _rel(out["scatter"][1], out["auto"][1]) <= 1e-5
    assert out["scatter"][0] == pytest.approx(out["auto"][0], rel=1e-6)


# -- SVI ---------------------------------------------------------------------------

SVI_CFG = dict(number_of_topics=5, inference_mode="svi", alpha_alpha=0.2,
               alpha_beta=0.02, inner_iterations=30, doc_pad_multiple=8,
               batch_size=64, tau0=16.0, kappa=0.7, seed=0,
               hyper_parameter_optimize_interval=2, dense_vocab_threshold=0,
               bucket_sizes=(32, 64, 128), sstats_mode="scatter")


@pytest.fixture(scope="module")
def svi_data():
    kw = dict(num_docs=200, num_topics=5, num_types=150, mean_doc_length=40.0,
              seed=4)
    return dict(corpus=synthetic_corpus(**kw)[0],
                corpus_j=jax_synthetic(**kw)[0],
                lam0=np.random.default_rng(1).gamma(100.0, 0.01, (5, 150)))


@pytest.mark.parametrize("rows", ["device_rows", "host_repack"])
def test_svi_scatter_route_matches_jax(svi_data, rows):
    """200 documents in minibatches of 64 (the last one pads), each
    minibatch's buckets through the scatter E-step: gathered from the
    device-resident rows, or packed on the host
    (``svi_device_rows_budget_mb=0``)."""
    extra = {} if rows == "device_rows" else dict(svi_device_rows_budget_mb=0)
    cfg = {**SVI_CFG, **extra}
    ours = StochasticVariationalBayes(LDAConfig(**cfg), device="cpu")
    ours.initialize(svi_data["corpus"], lam_init=svi_data["lam0"])
    theirs = JaxSVI(JaxConfig(**cfg))
    theirs.initialize(svi_data["corpus_j"], lam_init=svi_data["lam0"])
    assert ours._mb_sstats is None and theirs._mb_sstats is None
    assert (ours._device_rows is None) == (rows == "host_repack")
    e_ours = [ours.learning() for _ in range(2)]
    e_theirs = [theirs.learning() for _ in range(2)]
    np.testing.assert_allclose(ours.gamma, np.asarray(theirs.gamma),
                               rtol=GAMMA_TOL, atol=GAMMA_TOL)
    e_ours += ours.learning_many(2)
    e_theirs += theirs.learning_many(2)
    np.testing.assert_allclose(e_ours, e_theirs, rtol=RTOL)
    _assert_state_close(ours, theirs)
    np.testing.assert_allclose(ours.gamma, np.asarray(theirs.gamma),
                               rtol=GAMMA_TOL, atol=GAMMA_TOL)


def test_svi_scatter_device_rows_equal_host_repack(svi_data):
    """The device-resident rows and the host repack in the same geometry
    give the same bits on the scatter route."""
    runs = []
    for extra in ({}, dict(svi_device_rows_budget_mb=0)):
        eng = StochasticVariationalBayes(LDAConfig(**SVI_CFG, **extra),
                                         device="cpu")
        eng.initialize(svi_data["corpus"], lam_init=svi_data["lam0"])
        runs.append(([eng.learning() for _ in range(3)], eng.state.lam,
                     eng.gamma))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])
    np.testing.assert_array_equal(runs[0][2], runs[1][2])
