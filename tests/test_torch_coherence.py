"""UMass topic coherence of the port (``pylda_tpu_torch.utils.coherence``).

A mirror of tests/test_coherence.py on the port's corpora and engines,
plus equality with the JAX package's ``engine_coherence`` for the same
lambda (float64 on the host from the same topics: equal to rel 1e-12).
"""

import numpy as np
import pytest
import torch

from pylda_tpu.corpus.synthetic import synthetic_corpus as jax_synthetic
from pylda_tpu.models import VariationalBayes as JaxVB
from pylda_tpu.utils.coherence import engine_coherence as jax_engine_coherence
from pylda_tpu.utils.config import LDAConfig as JaxConfig
from pylda_tpu_torch.corpus.corpus import Corpus
from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.corpus.vocabulary import Vocabulary
from pylda_tpu_torch.models import VariationalBayes
from pylda_tpu_torch.utils.coherence import (
    doc_frequency_table,
    engine_coherence,
    umass_coherence,
)
from pylda_tpu_torch.utils.config import LDAConfig

PLANTED = dict(num_docs=400, num_topics=5, num_types=200,
               mean_doc_length=60.0, seed=5)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _toy_corpus():
    vocab = Vocabulary(["a", "b", "c", "d", "e", "f"])
    lines = ["a b c", "a b", "a c", "d e f", "d e", "f d"]
    return Corpus.from_lines(lines, vocab), vocab


def test_doc_frequency_table():
    corpus, _ = _toy_corpus()
    t = doc_frequency_table(corpus, [0, 3])  # a, d
    assert t.shape == (6, 2)
    assert t[:, 0].sum() == 3 and t[:, 1].sum() == 3


def test_coherent_topic_beats_incoherent():
    corpus, _ = _toy_corpus()
    assert (umass_coherence([[0, 1, 2]], corpus)[0]
            > umass_coherence([[0, 3, 5]], corpus)[0])


def test_hand_computed_pair():
    corpus, _ = _toy_corpus()
    # D(a) = 3, D(b) = 2, D(a, b) = 2.
    assert np.isclose(umass_coherence([[1, 0]], corpus)[0], np.log(1.5))
    assert umass_coherence([[0, 1]], corpus)[0] == 0.0


@pytest.fixture(scope="module")
def trained():
    corpus = synthetic_corpus(**PLANTED)[0]
    eng = VariationalBayes(LDAConfig(number_of_topics=5, seed=0),
                           device="cpu")
    eng.initialize(corpus)
    eng.learning_many(25)
    return eng, corpus


def test_engine_coherence_on_recovered_topics(trained):
    eng, corpus = trained
    coh = engine_coherence(eng, corpus, top_n=8)
    assert len(coh["per_topic"]) == 5 and coh["top_n"] == 8
    rng = np.random.default_rng(0)
    top = np.argsort(-eng.topic_word_distribution(), axis=1)[:, :8]
    shuffled = top.copy().reshape(-1)
    rng.shuffle(shuffled)
    rand = umass_coherence([list(r) for r in shuffled.reshape(top.shape)],
                           corpus)
    assert coh["mean"] > np.mean(rand)


def test_engine_coherence_equals_jax(trained):
    """The JAX engine carrying the port's lambda scores the same
    coherence on the same corpus."""
    eng, corpus = trained
    theirs = JaxVB(JaxConfig(number_of_topics=5, seed=0))
    theirs.initialize(jax_synthetic(**PLANTED)[0],
                      lam_init=eng.state.lam.numpy())
    np.testing.assert_array_equal(np.asarray(theirs.state.lam),
                                  eng.state.lam.numpy())
    for top_n in (5, 10):
        got = engine_coherence(eng, corpus, top_n=top_n)
        want = jax_engine_coherence(theirs, theirs._corpus, top_n=top_n)
        np.testing.assert_allclose(got["per_topic"], want["per_topic"],
                                   rtol=1e-12)
        assert got["mean"] == pytest.approx(want["mean"], rel=1e-12)
