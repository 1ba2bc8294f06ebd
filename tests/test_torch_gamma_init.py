"""The random gamma inits of the port's VB family (CPU).

``gamma_init`` "normal" (clip(1 + 0.1 N(0, 1), 0.2)) and "gamma"
(Gamma(100) * 0.01) draw from ``torch.Generator`` streams seeded by
(config seed, tag, step, batch).  The CPU and CUDA generators, and JAX's,
give different bits for one seed, so the draws are held by their
statistics (mean 1 within 0.005, std 0.1 within 0.005 at 200,000 draws:
over 7 standard errors; a KS test against scipy's Gamma(100, 0.01) at
p > 1e-3) and by their schedule, and the engines are held against the
JAX engines with the same gamma inits handed to both (a numpy function
of the batch's shape), at pinned sweeps (threshold 0): ELBOs, estimates
and held-out likelihoods rel 1e-4, lambda rtol 1e-4 with atol 1e-4, the
tolerances of tests/test_torch_vb.py and tests/test_torch_svi.py.

A JAX model file written with a random gamma init loads in the port,
through ``Inferencer.load`` and the test CLI, and scores held-out text
within rel 1e-4 of the JAX engine (the cross-load tolerance of
tests/test_torch_cli.py): the fault ROADMAP.md's Queue 3 recorded.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import pylda_tpu.models.vb as jax_vb
from pylda_tpu.corpus.synthetic import synthetic_corpus as jax_synthetic
from pylda_tpu.models import make_engine as jax_make_engine
from pylda_tpu.utils.config import LDAConfig as JaxConfig
from pylda_tpu_torch.cli.test import main as run_test_cli
from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.models import (
    Inferencer,
    StochasticVariationalBayes,
    VariationalBayes,
)
from pylda_tpu_torch.models.vb import (
    TAG_GAMMA_FUSED,
    TAG_GAMMA_ITER,
    gamma_init,
    standard_gamma,
)
from pylda_tpu_torch.ops.sampling import stream
from pylda_tpu_torch.utils.config import LDAConfig

N_DRAWS = 200_000
MEAN_TOL, STD_TOL, KS_P = 0.005, 0.005, 1e-3
RTOL, LAM_ATOL = 1e-4, 1e-4
K, V, D = 6, 300, 96
PINNED = dict(number_of_topics=K, dense_vocab_threshold=0,
              bucket_sizes=(32, 64), inner_iterations=12,
              convergence_threshold=0.0, doc_pad_multiple=8, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("mode", ["normal", "gamma"])
def test_draw_statistics(mode):
    g = gamma_init((N_DRAWS // 100, 100), mode, stream("cpu", 5, 1, 2))
    assert g.dtype == torch.float32 and g.shape == (N_DRAWS // 100, 100)
    assert abs(float(g.mean()) - 1.0) < MEAN_TOL
    assert abs(float(g.std()) - 0.1) < STD_TOL
    if mode == "normal":
        assert float(g.min()) >= 0.2
    else:
        assert float(g.min()) > 0.0


def test_gamma_draws_follow_gamma_100():
    x = (standard_gamma(100.0, (N_DRAWS,), stream("cpu", 0, 3)) * 0.01)
    res = scipy.stats.kstest(x.double().numpy(), scipy.stats.gamma(
        100.0, scale=0.01).cdf)
    assert res.pvalue > KS_P, res


@pytest.mark.parametrize("mode", ["normal", "gamma"])
def test_same_seed_same_bits(mode):
    a = gamma_init((500, 7), mode, stream("cpu", 9, 0x60A4, 3, 1))
    b = gamma_init((500, 7), mode, stream("cpu", 9, 0x60A4, 3, 1))
    c = gamma_init((500, 7), mode, stream("cpu", 9, 0x60A4, 4, 1))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_standard_gamma_rejects_small_shapes():
    with pytest.raises(ValueError, match="shape >= 1"):
        standard_gamma(0.5, (3,), stream("cpu", 0))


@pytest.fixture(scope="module")
def data():
    kw = dict(num_docs=D, num_topics=K, num_types=V, mean_doc_length=40.0,
              seed=3)
    return dict(corpus=synthetic_corpus(**kw)[0], corpus_j=jax_synthetic(**kw)[0],
                lam0=np.random.default_rng(11).gamma(100.0, 0.01, (K, V)))


def _spy_iterations(eng):
    """Record the gamma inits each ``_iteration`` runs from."""
    seen = []
    inner = eng._iteration

    def spy(update, gamma0s):
        seen.append([g.clone() for g in gamma0s])
        return inner(update, gamma0s)

    eng._iteration = spy
    return seen


@pytest.mark.parametrize("mode", ["normal", "gamma"])
def test_learning_many_reuses_one_set_learning_redraws(data, mode):
    def engine():
        eng = VariationalBayes(LDAConfig(**{**PINNED, "gamma_init": mode}),
                               device="cpu")
        eng.initialize(data["corpus"], lam_init=data["lam0"])
        return eng

    many = engine()
    seen_many = _spy_iterations(many)
    many.learning_many(3)
    assert len(seen_many) == 3
    for later in seen_many[1:]:
        assert all(torch.equal(a, b) for a, b in zip(seen_many[0], later))
    # The one set is the fused tag's draw at the call's first step.
    want = many._gamma0s(many._batches, TAG_GAMMA_FUSED, 0)
    assert all(torch.equal(a, b) for a, b in zip(seen_many[0], want))

    single = engine()
    seen_single = _spy_iterations(single)
    single.learning()
    single.learning()
    assert not any(torch.equal(a, b)
                   for a, b in zip(seen_single[0], seen_single[1]))
    for step, got in enumerate(seen_single):
        want = single._gamma0s(single._batches, TAG_GAMMA_ITER, step)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    # Different schedules: the fused set is no iteration's draw.
    assert not any(torch.equal(a, b)
                   for a, b in zip(seen_many[0], seen_single[0]))


def test_svi_learning_many_draws_what_learning_draws(data):
    cfg = LDAConfig(**{**PINNED, "inference_mode": "svi", "batch_size": 32,
                       "gamma_init": "gamma"})
    engs = []
    for _ in range(2):
        eng = StochasticVariationalBayes(cfg, device="cpu")
        eng.initialize(data["corpus"], lam_init=data["lam0"])
        engs.append(eng)
    e_one = [engs[0].learning() for _ in range(2)]
    e_many = engs[1].learning_many(2)
    np.testing.assert_array_equal(engs[0].state.lam.numpy(),
                                  engs[1].state.lam.numpy())
    np.testing.assert_allclose(e_one, e_many, rtol=1e-12)


def _shape_gamma0(shape):
    """The gamma init both packages are handed: a numpy draw seeded by
    the batch's shape."""
    rng = np.random.default_rng(1000 * shape[0] + shape[1])
    return rng.gamma(100.0, 0.01, shape).astype(np.float32)


def _hand_gamma0s(ours, monkeypatch):
    monkeypatch.setattr(jax_vb, "_gamma_init",
                        lambda key, shape, dtype, mode:
                        jnp.asarray(_shape_gamma0(shape), dtype))
    monkeypatch.setattr(ours, "_gamma0s", lambda batches, *tag: [
        torch.as_tensor(_shape_gamma0((b.rows, K))) for b in batches])


@pytest.mark.parametrize("mode", ["vb", "svi"])
def test_engines_match_jax_from_the_same_gamma0(data, monkeypatch, mode):
    cfg = {**PINNED, "gamma_init": "gamma", "inference_mode": mode,
           "batch_size": 32}
    ours = (VariationalBayes if mode == "vb" else StochasticVariationalBayes)(
        LDAConfig(**cfg), device="cpu")
    ours.initialize(data["corpus"], lam_init=data["lam0"])
    theirs = jax_make_engine(JaxConfig(**cfg))
    theirs.initialize(data["corpus_j"], lam_init=data["lam0"])
    _hand_gamma0s(ours, monkeypatch)
    np.testing.assert_allclose(ours.learning_many(2), theirs.learning_many(2),
                               rtol=RTOL)
    np.testing.assert_allclose(ours.state.lam.numpy(),
                               np.asarray(theirs.state.lam), rtol=RTOL,
                               atol=LAM_ATOL)
    ll, _ = ours.inference(data["corpus"])
    ll_j, _ = theirs.inference(data["corpus_j"])
    assert ll == pytest.approx(ll_j, rel=RTOL)


# -- the Queue 3 fault: JAX model files with a random gamma init -----------------------


def _write_corpus_dir(path, corpus, test, vocab):
    os.makedirs(path, exist_ok=True)
    for name, c in (("doc.dat", corpus), ("test.dat", test)):
        with open(os.path.join(path, name), "w", encoding="utf-8") as f:
            for d in c.docs:
                f.write(" ".join(vocab.types[int(i)] for i in d) + "\n")
    with open(os.path.join(path, "voc.dat"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab.types) + "\n")


@pytest.mark.parametrize("mode", ["vb", "svi"])
@pytest.mark.parametrize("init", ["gamma", "normal"])
def test_jax_model_with_random_gamma_init_loads(tmp_path, capsys, mode, init):
    corpus_j, beta, _ = jax_synthetic(60, 4, 200, mean_doc_length=30, seed=0)
    test_j = jax_synthetic(20, 4, 200, mean_doc_length=30, seed=1,
                           beta=beta)[0]
    eng = jax_make_engine(JaxConfig(number_of_topics=4, inference_mode=mode,
                                    gamma_init=init, batch_size=20, seed=0))
    eng.initialize(corpus_j)
    eng.learning_many(2)
    path = str(tmp_path / "model-2")
    eng.save(path)
    want = eng.perplexity(test_j)

    ours = Inferencer.load(path, device="cpu")
    assert ours.config.gamma_init == init
    test = synthetic_corpus(20, 4, 200, mean_doc_length=30, seed=1,
                            beta=np.asarray(beta))[0]
    assert ours.perplexity(test) == pytest.approx(want, rel=RTOL)

    corpus_dir = str(tmp_path / "corpus")
    _write_corpus_dir(corpus_dir, corpus_j, test_j, eng._vocab)
    capsys.readouterr()
    assert run_test_cli([f"--model={path}", f"--input_directory={corpus_dir}",
                      "--device=cpu"]) == 0
    got = float(re.search(r"per_word_perplexity=([0-9.e+-]+)",
                          capsys.readouterr().out).group(1))
    assert got == pytest.approx(want, rel=RTOL)
