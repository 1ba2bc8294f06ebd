"""The port's dense route against pylda_tpu's on the same inputs (CPU).

Inputs are made with numpy from a seed and handed to both packages.  On
CPU tensors ``dense_estep`` runs its plain version ``estep_dense``, held
here against ``pylda_tpu.ops.estep.estep_dense`` and the Pallas kernel
``pallas_estep_dense`` (interpret mode); the CUDA kernel is held against
the plain version on the card (tests/test_torch_kernels_gpu.py).

Tolerances, each with its reason:
- exit rule (threshold 1e-5, stall 6): per row rtol 5e-4 with an atol of
  5e-4 + K * threshold (a row at the threshold may freeze a sweep apart,
  which moves it by at most K * threshold in sum_k |dgamma|), sweeps +-1;
- pinned sweeps (threshold 0, 10 sweeps): gamma rtol 1e-5 — f32
  reassociation grows through the fixed point (~5e-6 at 10 sweeps, ~1e-4
  at 50), so the pin is short;
- sstats rtol 1e-4 (+1e-6 of the largest entry) and the token score rel
  1e-4;
- against the Pallas kernel at threshold 0: 1e-4 — it takes every
  expectation with its series digamma (the first and final ones too) and
  pads K to 128;
- the engines: ELBOs and held-out ll rel 1e-4; alpha/eta rtol 1e-4;
  lambda rtol 1e-4 with atol 1e-4; gamma rtol 5e-4 with atol 5e-4 (as in
  tests/test_torch_vb.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import psi

from pylda_tpu.corpus.synthetic import synthetic_corpus as jax_synthetic
from pylda_tpu.models import VariationalBayes as JaxVB
from pylda_tpu.ops.estep import estep_dense as jax_estep_dense
from pylda_tpu.ops.pallas_estep import pallas_estep_dense
from pylda_tpu.oracle import OracleVB
from pylda_tpu.utils.config import LDAConfig as JaxConfig
from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.models import VariationalBayes, state_from_numpy
from pylda_tpu_torch.ops import dense_estep as dense_mod
from pylda_tpu_torch.utils.config import LDAConfig

RTOL = 1e-4
LAM_ATOL = 1e-4
GAMMA_TOL = 5e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(D=70, V=300, K=13, pad_rows=5, seed=0):
    """Dense counts with padded (all-zero) doc rows, expElogbeta in f64
    then f32, alpha 0.1, the "ones" gamma init."""
    rng = np.random.default_rng(seed)
    counts = rng.poisson(0.2, (D, V)).astype(np.float32)
    counts[D - pad_rows:] = 0.0
    lam = rng.gamma(1.0, 1.0, (K, V))
    eeb = np.exp(psi(lam) - psi(lam.sum(axis=1, keepdims=True)))
    return (counts, np.ones((D, K), np.float32), eeb.astype(np.float32),
            np.full(K, 0.1, np.float32))


def _port(counts, g0, eeb, alpha, bf16=False, v_pad=0, **kw):
    """The wrapper's CPU route, counts optionally bf16 and vocab-padded."""
    c = torch.tensor(np.pad(counts, ((0, 0), (0, v_pad))))
    if bf16:
        c = c.to(torch.bfloat16)
    before = dense_mod.LAUNCHES
    out = dense_mod.dense_estep(c, torch.tensor(g0), torch.tensor(eeb),
                                torch.tensor(alpha), **kw)
    assert dense_mod.LAUNCHES == before  # CPU tensors launch nothing
    return [x.numpy() for x in out]


def _jax(counts, g0, eeb, alpha, **kw):
    out = jax_estep_dense(jnp.asarray(counts), jnp.asarray(g0),
                          jnp.asarray(eeb), jnp.asarray(alpha), **kw)
    return [np.asarray(x) for x in out]


def _assert_sstats_close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("bf16,v_pad", [(False, 0), (True, 36)],
                         ids=["f32", "bf16_vocab_padded"])
def test_estep_dense_exit_rule_matches_jax(bf16, v_pad):
    counts, g0, eeb, alpha = _inputs()
    K = eeb.shape[0]
    kw = dict(inner_iterations=50, convergence_threshold=1e-5,
              stall_patience=6)
    g, ss, tok, s = _port(counts, g0, eeb, alpha, bf16, v_pad, **kw)
    g_j, ss_j, tok_j, s_j = _jax(counts, g0, eeb, alpha, **kw)
    assert abs(int(s) - int(s_j)) <= 1
    assert g.shape == g_j.shape and ss.shape == ss_j.shape
    assert (np.abs(g - g_j) <= GAMMA_TOL * np.abs(g_j) + GAMMA_TOL
            + K * 1e-5).all()
    _assert_sstats_close(ss, ss_j)
    assert float(tok) == pytest.approx(float(tok_j), rel=RTOL)


def test_estep_dense_pinned_sweeps_match_jax():
    counts, g0, eeb, alpha = _inputs(seed=1)
    kw = dict(inner_iterations=10, convergence_threshold=0.0)
    g, ss, tok, s = _port(counts, g0, eeb, alpha, **kw)
    g_j, ss_j, tok_j, s_j = _jax(counts, g0, eeb, alpha, **kw)
    assert int(s) == int(s_j) == 10
    np.testing.assert_allclose(g, g_j, rtol=1e-5)
    _assert_sstats_close(ss, ss_j)
    assert float(tok) == pytest.approx(float(tok_j), rel=RTOL)
    # Exact invariant: gamma row sums = sum(alpha) + document length.
    np.testing.assert_allclose(g.sum(axis=1),
                               alpha.sum() + counts.sum(axis=1), rtol=1e-4)


def test_estep_dense_matches_pallas_kernel():
    """Threshold 0: the Pallas kernel's per-tile exit and the JAX
    default's per-row exit coincide (both run the cap)."""
    counts, g0, eeb, alpha = _inputs(D=96, V=256, K=10, seed=2)
    kw = dict(inner_iterations=20, convergence_threshold=0.0, eps=1e-30)
    g, ss, tok, _ = _port(counts, g0, eeb, alpha, **kw)
    g_p, ss_p, tok_p = (np.asarray(x) for x in pallas_estep_dense(
        jnp.asarray(counts), jnp.asarray(g0), jnp.asarray(eeb),
        jnp.asarray(alpha), tile_d=32, interpret=True, **kw))
    np.testing.assert_allclose(g, g_p, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ss, ss_p, rtol=1e-4,
                               atol=1e-4 * np.abs(ss_p).max())
    assert float(tok) == pytest.approx(float(tok_p), rel=1e-4)


# -- the engine's dense route -----------------------------------------------

K, V, D = 8, 200, 96
CFG = dict(number_of_topics=K, doc_pad_multiple=8,
           hyper_parameter_optimize_interval=2, seed=0)


@pytest.fixture(scope="module")
def data():
    kw = dict(num_docs=D, num_topics=K, num_types=V, mean_doc_length=40.0,
              seed=3)
    corpus, beta, _ = synthetic_corpus(**kw)
    held = dict(num_docs=16, num_topics=K, num_types=V, mean_doc_length=40.0,
                seed=4, beta=beta)
    return dict(corpus=corpus, corpus_j=jax_synthetic(**kw)[0],
                test=synthetic_corpus(**held)[0],
                test_j=jax_synthetic(**held)[0],
                lam0=np.random.default_rng(11).gamma(100.0, 0.01, (K, V)))


def _engines(data, **extra):
    cfg = {**CFG, **extra}
    ours = VariationalBayes(LDAConfig(**cfg), device="cpu")
    ours.initialize(data["corpus"], lam_init=data["lam0"])
    theirs = JaxVB(JaxConfig(**cfg))
    theirs.initialize(data["corpus_j"], lam_init=data["lam0"])
    return ours, theirs


def _assert_state_close(ours, theirs):
    for f in ("lam", "alpha", "eta"):
        np.testing.assert_allclose(
            getattr(ours.state, f).numpy(),
            np.asarray(getattr(theirs.state, f)), rtol=RTOL,
            atol=LAM_ATOL if f == "lam" else 0.0, err_msg=f,
        )


@pytest.fixture(scope="module")
def learned(data):
    """4 learning() calls in each package (hyper updates at 2 and 4)."""
    ours, theirs = _engines(data)
    assert ours._sstats_plan is None  # the dense route
    e_ours = [ours.learning() for _ in range(4)]
    e_theirs = [theirs.learning() for _ in range(4)]
    return ours, theirs, e_ours, e_theirs


def test_dense_route_learning_matches_jax(learned):
    ours, theirs, e_ours, e_theirs = learned
    np.testing.assert_allclose(e_ours, e_theirs, rtol=RTOL)
    assert e_ours[-1] > e_ours[0]
    _assert_state_close(ours, theirs)
    assert len(ours.last_sweeps) == len(ours._batches) == 1
    np.testing.assert_allclose(ours.gamma, np.asarray(theirs.gamma),
                               rtol=GAMMA_TOL, atol=GAMMA_TOL)


def test_dense_route_inference_matches_jax(learned, data):
    ours, theirs, _, _ = learned
    ll, gamma = ours.inference(data["test"])
    ll_j, gamma_j = theirs.inference(data["test_j"])
    assert ll == pytest.approx(ll_j, rel=RTOL)
    assert gamma.shape == (16, K)
    np.testing.assert_allclose(gamma, np.asarray(gamma_j), rtol=GAMMA_TOL,
                               atol=GAMMA_TOL)
    assert ours.perplexity(data["test"]) == pytest.approx(
        theirs.perplexity(data["test_j"]), rel=RTOL
    )
    assert ours.point_estimate_perplexity(data["test"]) == pytest.approx(
        theirs.point_estimate_perplexity(data["test_j"]), rel=RTOL
    )


@pytest.mark.parametrize(
    "extra", [{}, dict(estep_memory_budget_mb=0, doc_pad_multiple=40)],
    ids=["one_batch", "several_batches"],
)
def test_dense_route_learning_many_matches_jax(data, extra):
    ours, theirs = _engines(data, **extra)
    if extra:
        assert len(ours._batches) == 3  # 40-row batches, the last padded
    np.testing.assert_allclose(ours.learning_many(4), theirs.learning_many(4),
                               rtol=RTOL)
    _assert_state_close(ours, theirs)
    assert ours._counter == theirs._counter == 4
    # The lazy gamma re-runs the E-step at the final lambda.
    np.testing.assert_allclose(ours.gamma, np.asarray(theirs.gamma),
                               rtol=GAMMA_TOL, atol=GAMMA_TOL)


def test_dense_route_continues_from_jax_state(data):
    """The JAX engine trains 2 iterations and hands its state across;
    both then run 2 more and agree."""
    ours, theirs = _engines(data)
    theirs.learning_many(2)
    st = theirs.state
    ours.state = state_from_numpy(
        {"lam": np.asarray(st.lam), "alpha": np.asarray(st.alpha),
         "eta": np.asarray(st.eta), "step": np.asarray(st.step)},
        device="cpu",
    )
    assert ours._counter == 2
    np.testing.assert_allclose(
        [ours.learning(), ours.learning()],
        [theirs.learning(), theirs.learning()], rtol=RTOL,
    )
    _assert_state_close(ours, theirs)


def test_dense_route_matches_oracle():
    """Same-init parity with the float64 oracle for 3 iterations (the
    protocol of tests/test_vb_engine.py): ELBO rel 5e-4."""
    kw = dict(num_docs=64, num_topics=5, num_types=120, mean_doc_length=40,
              seed=7)
    lam0 = np.random.default_rng(42).gamma(100.0, 0.01, size=(5, 120))
    eng = VariationalBayes(LDAConfig(
        number_of_topics=5, alpha_alpha=0.2, alpha_beta=0.01,
        inner_iterations=100, convergence_threshold=1e-7, doc_pad_multiple=8,
        seed=0,
    ), device="cpu")
    eng.initialize(synthetic_corpus(**kw)[0], lam_init=lam0)
    ora = OracleVB(jax_synthetic(**kw)[0], num_topics=5, alpha=0.2, eta=0.01,
                   seed=0, inner_iterations=100, convergence_threshold=1e-9,
                   gamma_init="ones")
    ora.lam = lam0.copy()
    for _ in range(3):
        e, o = eng.learning(), ora.learning()
        assert abs(e - o) / abs(o) < 5e-4, (e, o)


@pytest.mark.slow
def test_config1_parity_gate_vs_oracle():
    """The config-1 gate of the JAX package (bench_suite.config1, protocol
    in BENCH_SUITE.md): on the bundled corpus, K=10, best-of-5 independent
    restarts of 60 iterations on both the engine and the float64 oracle;
    the engine's best held-out perplexity is at most 1.01x the oracle's."""
    from pylda_tpu.corpus.datasets import load_input_directory as jax_load
    from pylda_tpu_torch.corpus.datasets import (
        bundled_corpus_dir,
        load_input_directory,
    )

    train, test, vocab = load_input_directory(bundled_corpus_dir())
    train_j, _, vocab_j = jax_load(bundled_corpus_dir())
    engine_pps, oracle_pps = [], []
    for s in range(5):
        eng = VariationalBayes(
            LDAConfig(number_of_topics=10, inference_mode="vb", seed=s),
            device="cpu",
        )
        eng.initialize(train, vocab)
        eng.learning_many(60)
        engine_pps.append(eng.perplexity(test))
        ora = OracleVB(train_j, num_topics=10, alpha=0.1,
                       eta=1.0 / len(vocab_j), seed=s)
        for _ in range(60):
            ora.learning()
        oracle_pps.append(ora.perplexity(jax_load(bundled_corpus_dir())[1]))
    print(f"engine {engine_pps} oracle {oracle_pps}")
    assert min(engine_pps) <= 1.01 * min(oracle_pps)
