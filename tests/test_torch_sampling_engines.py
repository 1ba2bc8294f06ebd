"""The port's sampling engines (``MonteCarlo``, ``Hybrid``) against the JAX
package's on the CPU.

The two packages draw different random streams, so whole chains agree
statistically and identical tables agree numerically:

- on identical count tables (a JAX engine's chains placed in the port's
  with ``set_chains``) the joint log likelihood agrees with the JAX
  engine's to rel 1e-6 (another summation order; both use the fast
  lgamma) and with the float64 ``OracleGibbs`` to rel 1e-5, as
  ``tests/test_sampling_engines.py`` holds the JAX engine;
  ``topic_word_distribution`` to 1e-7 and ``gamma`` exactly;
- the Wallach slice sampler, seeded with the integer the JAX engine
  derives, gives alpha and eta within rel 1e-6;
- the engine mirrors keep ``tests/test_sampling_engines.py``'s bars:
  exact conservation, long documents blocked, the LL rising, held-out
  within 1% of ``OracleGibbs`` with mean |dtheta| < 0.05, hybrid beating
  random by 2x and landing within 25% of VB, and R > 1 conserving the
  tables; and the BASELINE config-3 gate at small size, hybrid
  point-estimate perplexity <= 1.1x Gibbs's;
- ``effective_sequence_bucket_sizes`` is bit-identical to the JAX one;
- one hybrid iteration, fed the JAX engine's own draws from the same
  lambda, alpha and chains, gives the same sstats, lambda and chains bit
  for bit, its ELBO, elog_sum and held-out bound agree to rel 1e-6, and
  the Newton alpha/eta after it to VB's rel 1e-4;
- model files load both ways, and a run resumed from one draws the
  unbroken run's chain bit for bit.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylda_tpu.corpus.corpus import Corpus as JaxCorpus
from pylda_tpu.corpus.synthetic import synthetic_corpus as jax_synthetic
from pylda_tpu.corpus.vocabulary import Vocabulary as JaxVocabulary
from pylda_tpu.models import Hybrid as JaxHybrid
from pylda_tpu.models import Inferencer as JaxInferencer
from pylda_tpu.models import MonteCarlo as JaxMonteCarlo
from pylda_tpu.models import layouts as jax_layouts
from pylda_tpu.ops import sampling as jax_sampling
from pylda_tpu.oracle import OracleGibbs
from pylda_tpu.utils.config import LDAConfig as JaxConfig
from pylda_tpu_torch.corpus.corpus import Corpus
from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.corpus.vocabulary import Vocabulary
from pylda_tpu_torch.models import (
    Hybrid,
    Inferencer,
    MonteCarlo,
    VariationalBayes,
    layouts,
    state_from_numpy,
)
from pylda_tpu_torch.models import base as base_mod
from pylda_tpu_torch.models import hybrid as hybrid_mod
from pylda_tpu_torch.ops.hyper import slice_sample
from pylda_tpu_torch.ops.sampling import (
    count_table,
    noise_shape,
    sweep_doc_topics,
)
from pylda_tpu_torch.utils.config import LDAConfig

K, V = 5, 150
CORPUS = dict(num_docs=80, num_topics=K, num_types=V, mean_doc_length=50,
              seed=3)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def corpus():
    return synthetic_corpus(**CORPUS)[0]


@pytest.fixture(scope="module")
def corpus_j():
    return jax_synthetic(**CORPUS)[0]


def _kw(mode, **kw):
    return dict(dict(number_of_topics=K, inference_mode=mode, alpha_alpha=0.2,
                     alpha_beta=0.05, doc_pad_multiple=8,
                     bucket_sizes=(64, 128, 256), seed=0), **kw)


def _ours(mode, corpus, **kw):
    eng = {"gibbs": MonteCarlo, "hybrid": Hybrid, "vb": VariationalBayes}[
        mode](LDAConfig(**_kw(mode, **kw)), device="cpu")
    eng.initialize(corpus)
    return eng


def _theirs(mode, corpus_j, **kw):
    eng = {"gibbs": JaxMonteCarlo, "hybrid": JaxHybrid}[mode](
        JaxConfig(**_kw(mode, **kw)))
    eng.initialize(corpus_j)
    return eng


def _jax_chains(eng):
    return (np.asarray(eng._n_kv), [np.asarray(z) for z in eng._z],
            [np.asarray(n) for n in eng._ndk])


def _oracle_with(eng, corpus_j):
    """OracleGibbs holding the port engine's tables, n_dk in corpus order."""
    ora = OracleGibbs(corpus_j, num_topics=K, alpha=0.2, beta=0.05, seed=0)
    ora.n_kv = eng._n_kv.numpy().astype(np.int64)
    ora.n_k = ora.n_kv.sum(axis=1)
    ora.n_dk = np.rint(eng.gamma - eng.state.alpha.numpy()).astype(np.int64)
    return ora


# -- layouts ----------------------------------------------------------------------


@pytest.mark.parametrize("extra", [
    {}, {"doc_pad_multiple": 8}, {"bucket_policy": "fixed"},
    {"bucket_sizes": (32, 64)}, {"bucket_sizes": (16, 32, 48)},
])
def test_effective_sequence_bucket_sizes_match_jax(corpus, corpus_j, extra):
    for lengths in (None, (1000, 40, 25, 90, 3000, 7)):
        c, cj = corpus, corpus_j
        if lengths is not None:
            rng = np.random.default_rng(1)
            docs = [rng.integers(0, 60, size=n) for n in lengths]
            c = Corpus(docs, Vocabulary(f"w{i}" for i in range(60)))
            cj = JaxCorpus(docs, JaxVocabulary(f"w{i}" for i in range(60)))
        ours = layouts.effective_sequence_bucket_sizes(c, LDAConfig(**extra))
        theirs = jax_layouts.effective_sequence_bucket_sizes(
            cj, JaxConfig(**extra))
        assert ours == theirs


# -- Gibbs: invariants and convergence -------------------------------------------


def test_gibbs_count_conservation(corpus):
    eng = _ours("gibbs", corpus)
    for _ in range(2):
        eng.learning()
    n_kv = eng._n_kv.numpy()
    assert n_kv.sum() == corpus.num_tokens and (n_kv >= 0).all()
    for b, ndk in zip(eng._buckets, eng._ndk):
        np.testing.assert_array_equal(ndk.numpy().sum(axis=1),
                                      b.token_mask.numpy().sum(axis=1))


def test_gibbs_blocks_long_documents():
    rng = np.random.default_rng(1)
    docs = [rng.integers(0, 60, size=n) for n in (1000, 40, 25, 90)]
    corpus = Corpus(docs, Vocabulary(f"w{i}" for i in range(60)))
    eng = _ours("gibbs", corpus, bucket_sizes=(64, 128), doc_pad_multiple=1)
    eng.learning()
    assert eng._n_kv.numpy().sum() == corpus.num_tokens
    _ll, gamma = eng.inference(corpus)
    assert gamma.shape == (4, K)
    np.testing.assert_allclose(
        gamma.sum(axis=1) - eng.state.alpha.numpy().sum(),
        [len(d) for d in docs], rtol=1e-5)
    np.testing.assert_allclose(eng.gamma.sum(axis=1)
                               - eng.state.alpha.numpy().sum(),
                               [len(d) for d in docs], rtol=1e-6)


def test_gibbs_likelihood_improves(corpus):
    eng = _ours("gibbs", corpus)
    lls = [eng.learning() for _ in range(6)]
    assert lls[-1] > lls[0] + 100


def test_gibbs_learning_many_is_learning_repeated(corpus):
    """Seeds depend on the sweep index only: one chain either way."""
    a = _ours("gibbs", corpus, hyper_parameter_optimize_interval=2)
    b = _ours("gibbs", corpus, hyper_parameter_optimize_interval=2)
    lls_a = [a.learning() for _ in range(5)]
    assert b.learning_many(5) == lls_a
    np.testing.assert_array_equal(a._n_kv.numpy(), b._n_kv.numpy())
    assert float(a.state.alpha[0]) == float(b.state.alpha[0])


def test_gibbs_rebuild_interval_conserves_tables(corpus):
    """R = 3 keeps the tables exact and reaches the exact chain's plateau.
    The plateaus are compared at seed 1, where neither chain is trapped.
    At 60 sweeps some chains of both packages sit in a local mode (LL
    below -14,200 against a median near -13,830): over seeds 0-47 the
    port's at R = 1 in 7 runs (seed 0 among them) and at R = 3 in 10, the
    JAX engine's in 6 and 8 (``scripts/sampling_seed_spread.py
    rebuild``); the JAX mirror's seed 0 is one where neither JAX chain
    is."""
    eng = _ours("gibbs", corpus, gibbs_rebuild_interval=3, seed=1)
    lls = eng.learning_many(60)
    assert all(np.isfinite(v) for v in lls)
    expect = sum(count_table(b.tokens, b.token_mask, z, K, V)
                 for b, z in zip(eng._buckets, eng._z))
    np.testing.assert_array_equal(eng._n_kv.numpy(), expect.numpy())
    assert float(eng._n_kv.sum()) == corpus.num_tokens
    exact = _ours("gibbs", corpus, seed=1).learning_many(60)
    assert lls[-1] > lls[0]
    assert abs(lls[-1] - exact[-1]) / abs(exact[-1]) < 0.005


# -- Gibbs: identical tables ------------------------------------------------------


def test_joint_ll_on_jax_tables(corpus, corpus_j):
    theirs = _theirs("gibbs", corpus_j)
    theirs.learning_many(2)
    ours = _ours("gibbs", corpus)
    ours.set_chains(*_jax_chains(theirs))
    assert ours.compute_likelihood() == pytest.approx(
        theirs.compute_likelihood(), rel=1e-6)
    assert ours.compute_likelihood(0.3, 0.02) == pytest.approx(
        theirs.compute_likelihood(0.3, 0.02), rel=1e-6)
    ora = _oracle_with(ours, corpus_j)
    expect = ora.log_likelihood(ora.alpha, ora.beta)
    assert abs(ours.compute_likelihood() - expect) / abs(expect) < 1e-5
    np.testing.assert_allclose(ours.topic_word_distribution(),
                               theirs.topic_word_distribution(), rtol=0,
                               atol=1e-7)
    np.testing.assert_array_equal(ours.gamma, theirs.gamma)


def test_set_chains_checks_shapes(corpus, corpus_j):
    theirs = _theirs("gibbs", corpus_j)
    ours = _ours("gibbs", corpus)
    n_kv, zs, ndks = _jax_chains(theirs)
    with pytest.raises(ValueError, match="buckets"):
        ours.set_chains(n_kv, zs[:-1], ndks[:-1])
    with pytest.raises(ValueError, match="z_0"):
        ours.set_chains(n_kv, [z[:, :-1] for z in zs], ndks)
    with pytest.raises(ValueError, match="ndk_0"):
        ours.set_chains(n_kv, zs, [n[:, :-1] for n in ndks])
    with pytest.raises(ValueError, match="n_kv"):
        ours.set_chains(n_kv[:, :-1], zs, ndks)
    hyb = _ours("hybrid", corpus, hybrid_persistent_z=True)
    with pytest.raises(ValueError, match="zh_0"):
        hyb.set_chains([z[:, :-1] for z in zs])
    hyb.set_chains(zs)
    for z, zj in zip(hyb._z_hyb, zs):
        assert z.dtype == torch.int32
        np.testing.assert_array_equal(z.numpy(), zj)


def test_slice_sampler_seeded_like_jax(corpus, corpus_j):
    theirs = _theirs("gibbs", corpus_j)
    theirs.learning_many(3)
    ours = _ours("gibbs", corpus)
    ours.set_chains(*_jax_chains(theirs))
    seed = int(jax.random.randint(
        jax.random.fold_in(theirs.state.key, 0x511CE), (), 0, 2**31 - 1))
    x0 = np.array([math.log(float(ours.state.alpha.mean())),
                   math.log(float(ours.state.eta.mean()))])
    x = slice_sample(
        lambda x: ours.compute_likelihood(math.exp(x[0]), math.exp(x[1])),
        x0, np.random.default_rng(seed), samples=3, step=2.0)
    theirs.optimize_hyperparameters(samples=3, step=2.0)
    assert math.exp(x[0]) == pytest.approx(float(theirs.state.alpha[0]),
                                           rel=1e-6)
    assert math.exp(x[1]) == pytest.approx(float(theirs.state.eta[0]),
                                           rel=1e-6)
    ours.optimize_hyperparameters(samples=3, step=2.0)
    a1 = float(ours.state.alpha.mean())
    assert a1 > 0 and a1 != 0.2 and np.isfinite(ours.compute_likelihood())


def test_gibbs_heldout_inference_matches_oracle(corpus, corpus_j):
    kw = dict(num_docs=24, num_topics=K, num_types=V, mean_doc_length=40,
              seed=21)
    test, test_j = synthetic_corpus(**kw)[0], jax_synthetic(**kw)[0]
    eng = _ours("gibbs", corpus, burn_in_sweeps=10, number_of_samples=30)
    eng.learning_many(5)
    ll, gamma = eng.inference(test)
    ora = _oracle_with(eng, corpus_j)
    ll_o, gamma_o = ora.inference(test_j, burn_in=10, num_samples=30, seed=1)
    assert abs(ll - ll_o) / abs(ll_o) < 0.01
    th = gamma / gamma.sum(axis=1, keepdims=True)
    th_o = gamma_o / gamma_o.sum(axis=1, keepdims=True)
    assert np.abs(th - th_o).mean() < 0.05


def test_gibbs_unported_surfaces(corpus, monkeypatch):
    """phase_timings' keys; a process-local corpus in one process samples
    like a whole one (the same chains); across two processes without a
    mesh it raises the JAX engine's ValueError."""
    eng = _ours("gibbs", corpus)
    assert set(eng.phase_timings()) == {"gibbs_sweep_ms",
                                        "joint_likelihood_ms"}
    local = synthetic_corpus(**CORPUS)[0]
    local.process_local = True
    for mode in ("gibbs", "hybrid"):
        assert _ours(mode, local).learning() == _ours(mode, corpus).learning()
    monkeypatch.setattr(base_mod, "world", lambda: (0, 2))
    for mode in ("gibbs", "hybrid"):
        with pytest.raises(ValueError, match="requires a mesh"):
            _ours(mode, local)


# -- hybrid -------------------------------------------------------------------------


def test_hybrid_converges_and_beats_random(corpus):
    eng = _ours("hybrid", corpus, number_of_samples=8, burn_in_sweeps=3)
    test = corpus.subset(range(10))
    p0 = eng.perplexity(test)
    elbos = [eng.learning() for _ in range(6)]
    assert elbos[-1] > elbos[0]
    assert eng.perplexity(test) < p0 / 2
    assert eng.gamma.shape == (corpus.num_docs, K)


def test_hybrid_perplexity_close_to_vb(corpus):
    test = corpus.subset(range(16))
    vb = _ours("vb", corpus)
    hy = _ours("hybrid", corpus, number_of_samples=10, burn_in_sweeps=5)
    vb.learning_many(8)
    hy.learning_many(8)
    pv, ph = vb.perplexity(test), hy.perplexity(test)
    assert abs(pv - ph) / pv < 0.25, (pv, ph)


def test_hybrid_point_estimate_within_1p1x_gibbs():
    """BASELINE config 3's gate at a small size: both engines trained on
    one corpus, scored on held-out documents of the same beta.  At K=10
    (ratios 0.878-0.970 at seeds 0-4): at K=5 every engine of both
    packages lands in a merged-topic mode at some seeds (point-estimate
    perplexity ~20-21 against ~17.1; the port in 4 of 16 runs, the JAX
    package in 5 of 16), which the gate would read as a quality gap
    (``scripts/sampling_seed_spread.py gate``)."""
    kw = dict(num_topics=10, num_types=500, mean_doc_length=80)
    train, beta, _ = synthetic_corpus(num_docs=300, seed=5, **kw)
    test, _, _ = synthetic_corpus(num_docs=60, seed=105, beta=beta, **kw)
    pts = {}
    for mode in ("gibbs", "hybrid"):
        eng = {"gibbs": MonteCarlo, "hybrid": Hybrid}[mode](
            LDAConfig(number_of_topics=10, inference_mode=mode, seed=0,
                      number_of_samples=5, burn_in_sweeps=3), device="cpu")
        eng.initialize(train)
        eng.learning_many(25)
        pts[mode] = eng.point_estimate_perplexity(test)
    assert pts["hybrid"] <= 1.1 * pts["gibbs"], pts


class _JaxDraws:
    """Stands in for the port's hybrid module's ``random_assignments`` and
    ``sample_doc_topics`` with the draws the JAX engine makes from ``key``
    (its step key): bucket i's key is ``fold_in(key, i)``, cold chains
    start from ``random_assignments(fold_in(sub, 1))`` and the sweeps draw
    along ``fold_in(sub, 2)``, ``fold_in(.., s)`` a sweep."""

    def __init__(self, key):
        self.key, self.bucket = key, 0

    def _sub(self):
        return jax.random.fold_in(self.key, self.bucket)

    def random_assignments(self, shape, num_topics, generator):
        z = jax_sampling.random_assignments(
            jax.random.fold_in(self._sub(), 1), jnp.zeros(shape, jnp.int32),
            num_topics)
        return torch.as_tensor(np.array(z), device=generator.device)

    def sample_doc_topics(self, tokens, token_mask, log_topic_word, alpha,
                          z_init, generator, num_types, burn_in, num_samples,
                          sampler, block_positions):
        sub = jax.random.fold_in(self._sub(), 2)
        self.bucket += 1
        D, L = tokens.shape
        shape = noise_shape(sampler, D, L, log_topic_word.shape[0],
                            block_positions)

        def noise(s):
            k = jax.random.fold_in(sub, s)
            if sampler == "gumbel":
                return torch.as_tensor(np.stack([
                    np.asarray(jax.random.gumbel(kk, shape[1:], jnp.float32))
                    for kk in jax.random.split(k, shape[0])]))
            return torch.as_tensor(np.array(jax.random.uniform(
                k, shape, jnp.float32, minval=jnp.finfo(jnp.float32).tiny,
                maxval=1.0)))

        return sweep_doc_topics(
            tokens, token_mask, log_topic_word, alpha, z_init, noise,
            num_types=num_types, burn_in=burn_in, num_samples=num_samples,
            sampler=sampler, block_positions=block_positions)


def _take_state(ours, theirs):
    st = theirs.state
    ours._state = state_from_numpy(
        {k: np.asarray(getattr(st, k)) for k in ("lam", "alpha", "eta",
                                                 "step")}, device="cpu")


def test_hybrid_step_matches_jax_on_its_draws(corpus, corpus_j, monkeypatch):
    """The hybrid engine's own step (ELBO from token score + theta_elbo
    over the bucket masks + beta_elbo, elog_sum for Newton, lambda = eta
    + sstats) and its held-out bound, against the JAX engine's from the
    same lambda, alpha and chains, with the JAX engine's draws."""
    kw = dict(hybrid_persistent_z=True, number_of_samples=2,
              burn_in_sweeps=1, hyper_parameter_optimize_interval=1)
    theirs = _theirs("hybrid", corpus_j, **kw)
    ours = _ours("hybrid", corpus, **kw)
    _take_state(ours, theirs)
    ours.set_chains([np.asarray(z) for z in theirs._z_hyb])
    st = theirs.state
    _, sub = jax.random.split(st.key)  # the key of the JAX engine's step
    draws = _JaxDraws(sub)
    monkeypatch.setattr(hybrid_mod, "sample_doc_topics",
                        draws.sample_doc_topics)
    monkeypatch.setattr(hybrid_mod, "random_assignments",
                        draws.random_assignments)

    want = theirs._run_estep_z(theirs._batches, st.lam, st.alpha, sub,
                               theirs._z_hyb)
    got = ours._sampled_estep(ours._batches, ours.state.lam,
                              ours.state.alpha, (hybrid_mod.TAG_TRAIN, 0),
                              ours._z_hyb)
    gammas, sstats, token_score, theta_score, elog_sum, zs = got
    np.testing.assert_array_equal(sstats.numpy(), np.asarray(want[1]))
    for a, b in zip(gammas, want[0]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(zs, want[5]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in ((token_score, want[2]), (theta_score, want[3])):
        assert float(a) == pytest.approx(float(b), rel=1e-6)
    np.testing.assert_allclose(elog_sum.numpy(), np.asarray(want[4]),
                               rtol=1e-6)

    draws.bucket = 0
    elbo_t, elbo_o = theirs.learning(), ours.learning()
    assert draws.bucket == len(ours._batches)
    assert elbo_o == pytest.approx(elbo_t, rel=1e-6)
    np.testing.assert_array_equal(ours.state.lam.numpy(),
                                  np.asarray(theirs.state.lam))
    for f in ("alpha", "eta"):  # Newton: VB's bar (tests/test_torch_vb.py)
        np.testing.assert_allclose(getattr(ours.state, f).numpy(),
                                   np.asarray(getattr(theirs.state, f)),
                                   rtol=1e-4)
    for a, b in zip(ours._z_hyb, theirs._z_hyb):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    # Held-out: cold chains from the JAX engine's test key, same state.
    _take_state(ours, theirs)
    test, test_j = corpus.subset(range(16)), corpus_j.subset(range(16))
    draws.key = jax.random.fold_in(theirs.state.key, 0x7E57)
    draws.bucket = 0
    ll_o, gamma_o = ours.inference(test)
    ll_t, gamma_t = theirs.inference(test_j)
    assert ll_o == pytest.approx(ll_t, rel=1e-6)
    np.testing.assert_array_equal(gamma_o, gamma_t)
    draws.bucket = 0
    assert ours.perplexity(test) == pytest.approx(theirs.perplexity(test_j),
                                                  rel=1e-6)


# -- model files and resume ---------------------------------------------------------


@pytest.mark.parametrize("mode", ["gibbs", "hybrid"])
def test_model_files_load_both_ways(mode, corpus, corpus_j, tmp_path):
    kw = dict(hybrid_persistent_z=True, number_of_samples=2,
              burn_in_sweeps=1) if mode == "hybrid" else {}
    theirs = _theirs(mode, corpus_j, **kw)
    theirs.learning_many(3)
    theirs.save(str(tmp_path / "model-jax"))
    ours = Inferencer.load(str(tmp_path / "model-jax"), corpus=corpus,
                           device="cpu")
    assert type(ours).__name__ == type(theirs).__name__
    assert ours._counter == 3
    _hold(ours, theirs, mode)
    ours.learning()
    ours.save(str(tmp_path / "model-port"))
    back = JaxInferencer.load(str(tmp_path / "model-port"), corpus=corpus_j)
    assert back._counter == 4
    _hold(ours, back, mode)
    # Without a corpus the port's file serves held-out inference.
    alone = Inferencer.load(str(tmp_path / "model-port"), device="cpu")
    assert np.isfinite(alone.perplexity(corpus.subset(range(8))))


def _hold(ours, theirs, mode):
    np.testing.assert_allclose(ours.topic_word_distribution(),
                               theirs.topic_word_distribution(), rtol=0,
                               atol=1e-7)
    np.testing.assert_array_equal(ours.state.alpha.numpy(),
                                  np.asarray(theirs.state.alpha))
    if mode == "gibbs":
        assert ours.compute_likelihood() == pytest.approx(
            theirs.compute_likelihood(), rel=1e-6)
        np.testing.assert_array_equal(ours.gamma, theirs.gamma)
        for z, zj in zip(ours._z, theirs._z):
            np.testing.assert_array_equal(z.numpy(), np.asarray(zj))
    else:
        np.testing.assert_array_equal(ours.state.lam.numpy(),
                                      np.asarray(theirs.state.lam))
        assert len(ours._z_hyb) == len(theirs._z_hyb)
        for z, zj in zip(ours._z_hyb, theirs._z_hyb):
            np.testing.assert_array_equal(z.numpy(), np.asarray(zj))


@pytest.mark.parametrize("mode", ["gibbs", "hybrid"])
def test_resume_draws_the_unbroken_chain(mode, corpus, tmp_path):
    kw = dict(hybrid_persistent_z=True, number_of_samples=2,
              burn_in_sweeps=1) if mode == "hybrid" else dict(
        hyper_parameter_optimize_interval=3)
    whole = _ours(mode, corpus, **kw)
    objs = [whole.learning() for _ in range(4)]
    half = _ours(mode, corpus, **kw)
    first = [half.learning() for _ in range(2)]
    half.save(str(tmp_path / "model-2"))
    resumed = Inferencer.load(str(tmp_path / "model-2"), corpus=corpus,
                              device="cpu")
    assert first + [resumed.learning() for _ in range(2)] == objs
    np.testing.assert_array_equal(resumed.state.lam.numpy(),
                                  whole.state.lam.numpy())
    np.testing.assert_array_equal(resumed.state.alpha.numpy(),
                                  whole.state.alpha.numpy())
    if mode == "gibbs":
        np.testing.assert_array_equal(resumed._n_kv.numpy(),
                                      whole._n_kv.numpy())
    else:
        for a, b in zip(resumed._z_hyb, whole._z_hyb):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
