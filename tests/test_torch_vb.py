"""The port's VariationalBayes against pylda_tpu's on the same corpus (CPU).

A synthetic corpus (D=96, V=600, K=8) with dense_vocab_threshold=256
takes the ragged + dense-sstats route in both packages.  Both engines
start from the same lambda (numpy, seeded) with gamma_init="ones", so
the only differences are f32 summation order and exit timing.
Tolerances: ELBOs and held-out ll rel 1e-4; alpha/eta rtol 1e-4; lambda
rtol 1e-4 with atol 1e-4 (lambda spans 1.7e-3..74 here, and the few
rare-word entries built from one document's phi carry up to ~7e-5 of f32
reassociation noise after 4 iterations of 20-50 fixed-point sweeps, even
at pinned sweeps); gamma at the ragged fixed point's own per-row
tolerance, rtol 5e-4 with atol 5e-4.
"""

import numpy as np
import pytest
import torch

from pylda_tpu.corpus.synthetic import synthetic_corpus as jax_synthetic
from pylda_tpu.models import VariationalBayes as JaxVB
from pylda_tpu.utils.config import LDAConfig as JaxConfig
from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.models import VariationalBayes, state_from_numpy
from pylda_tpu_torch.models import base as base_mod
from pylda_tpu_torch.utils.config import LDAConfig

K, V, D = 8, 600, 96
CFG = dict(number_of_topics=K, dense_vocab_threshold=256, doc_pad_multiple=8,
           hyper_parameter_optimize_interval=2, seed=0)
RTOL = 1e-4
LAM_ATOL = 1e-4
GAMMA_TOL = 5e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def data():
    kw = dict(num_docs=D, num_topics=K, num_types=V, mean_doc_length=40.0,
              seed=3)
    corpus, beta, _ = synthetic_corpus(**kw)
    corpus_j, _, _ = jax_synthetic(**kw)
    held = dict(num_docs=16, num_topics=K, num_types=V, mean_doc_length=40.0,
                seed=4, beta=beta)
    lam0 = np.random.default_rng(11).gamma(100.0, 0.01, (K, V))
    return dict(corpus=corpus, corpus_j=corpus_j,
                test=synthetic_corpus(**held)[0],
                test_j=jax_synthetic(**held)[0], lam0=lam0)


def _engines(data):
    ours = VariationalBayes(LDAConfig(**CFG), device="cpu")
    ours.initialize(data["corpus"], lam_init=data["lam0"])
    theirs = JaxVB(JaxConfig(**CFG))
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
    e_ours = [ours.learning() for _ in range(4)]
    e_theirs = [theirs.learning() for _ in range(4)]
    return ours, theirs, e_ours, e_theirs


def test_learning_matches_jax(learned):
    ours, theirs, e_ours, e_theirs = learned
    np.testing.assert_allclose(e_ours, e_theirs, rtol=RTOL)
    assert e_ours[-1] > e_ours[0]
    _assert_state_close(ours, theirs)
    np.testing.assert_allclose(ours.gamma, np.asarray(theirs.gamma),
                               rtol=GAMMA_TOL, atol=GAMMA_TOL)


def test_learning_many_matches_jax(data):
    ours, theirs = _engines(data)
    np.testing.assert_allclose(ours.learning_many(4), theirs.learning_many(4),
                               rtol=RTOL)
    _assert_state_close(ours, theirs)
    assert ours._counter == theirs._counter == 4


def test_inference_matches_jax(learned, data):
    ours, theirs, _, _ = learned
    ll, gamma = ours.inference(data["test"])
    ll_j, gamma_j = theirs.inference(data["test_j"])
    assert ll == pytest.approx(ll_j, rel=RTOL)
    np.testing.assert_allclose(gamma, np.asarray(gamma_j), rtol=GAMMA_TOL,
                               atol=GAMMA_TOL)
    assert ours.perplexity(data["test"]) == pytest.approx(
        theirs.perplexity(data["test_j"]), rel=RTOL
    )


def test_state_from_numpy_carries_jax_training(data):
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


def test_unported_routes_raise(data, monkeypatch):
    """A process-local corpus in one process trains like a whole one (as
    in the JAX engine, which checks the process count first); across two
    processes without a mesh it raises the JAX engine's ValueError.
    sstats_mode="scatter" and a corpus over the dense sstats budget (item
    4, ported) take the scatter route: no dense counts plan; the random
    gamma inits (item 7, ported) train."""
    for kw in (dict(sstats_mode="scatter"),
               dict(sstats_dense_total_budget_mb=0)):
        eng = VariationalBayes(LDAConfig(**{**CFG, **kw}), device="cpu")
        eng.initialize(data["corpus"], lam_init=data["lam0"])
        assert eng._sstats_plan is None
        assert np.isfinite(eng.learning())
    local = synthetic_corpus(num_docs=8, num_topics=K, num_types=V,
                             mean_doc_length=10.0, seed=1)[0]
    whole = VariationalBayes(LDAConfig(**CFG), device="cpu")
    whole.initialize(local, lam_init=data["lam0"])
    local.process_local = True
    one = VariationalBayes(LDAConfig(**CFG), device="cpu")
    one.initialize(local, lam_init=data["lam0"])
    assert one.learning() == whole.learning()
    monkeypatch.setattr(base_mod, "world", lambda: (0, 2))
    with pytest.raises(ValueError, match="requires a mesh"):
        VariationalBayes(LDAConfig(**CFG), device="cpu").initialize(local)
    eng = VariationalBayes(LDAConfig(**{**CFG, "gamma_init": "normal"}),
                           device="cpu")
    eng.initialize(data["corpus"], lam_init=data["lam0"])
    assert np.isfinite(eng.learning())


@pytest.mark.parametrize(
    "extra",
    [
        # Fixed 16/32-slot buckets: documents with more unique types are
        # split into several rows that share a doc id and recombine in the
        # gamma assembly (index_add_ with repeated indices).
        dict(bucket_sizes=(16, 32), bucket_policy="fixed"),
        # A zero chunk budget floors at doc_pad_multiple rows a chunk: the
        # dense sstats run over 40-row doc-chunks, the last one padded.
        dict(sstats_dense_budget_mb=0, doc_pad_multiple=40),
    ],
    ids=["chunked_long_docs", "several_sstats_chunks"],
)
def test_layout_variants_match_jax(data, extra):
    cfg = {**CFG, **extra}
    ours = VariationalBayes(LDAConfig(**cfg), device="cpu")
    ours.initialize(data["corpus"], lam_init=data["lam0"])
    theirs = JaxVB(JaxConfig(**cfg))
    theirs.initialize(data["corpus_j"], lam_init=data["lam0"])
    if "bucket_sizes" in extra:
        rows = np.concatenate([b.row_index.numpy() for b in ours._batches])
        real = rows[rows < D]
        assert np.unique(real).size < real.size, "no doc split into rows"
    else:
        sizes = [c.shape[0] for c, _ in ours._sstats_plan.chunks]
        assert len(sizes) == 3 and sum(sizes) > D
    np.testing.assert_allclose([ours.learning() for _ in range(2)],
                               [theirs.learning() for _ in range(2)],
                               rtol=RTOL)
    _assert_state_close(ours, theirs)


def test_make_engine_routes():
    from pylda_tpu_torch.models import StochasticVariationalBayes, make_engine

    assert isinstance(make_engine(LDAConfig(**CFG), device="cpu"),
                      VariationalBayes)
    assert isinstance(
        make_engine(LDAConfig(**{**CFG, "inference_mode": "svi"}),
                    device="cpu"),
        StochasticVariationalBayes)
    from pylda_tpu_torch.models import Hybrid, MonteCarlo

    for mode, cls in (("gibbs", MonteCarlo), ("hybrid", Hybrid)):
        eng = make_engine(LDAConfig(**{**CFG, "inference_mode": mode}),
                          device="cpu")
        assert type(eng) is cls
