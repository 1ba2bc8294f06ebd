"""The port's corpus and layout code is bit-identical to pylda_tpu's.

Same seeds, same corpora, same batches: the vocabulary, synthetic corpora,
dense and ragged layouts, the bucket planner, ``build_vb_batches`` and
``assemble_gamma`` of ``pylda_tpu_torch`` must equal their JAX-package
counterparts exactly (they are host numpy in both).
"""

import numpy as np
import pytest
import torch

from pylda_tpu.corpus.synthetic import synthetic_corpus as jax_synthetic
from pylda_tpu.corpus.vocabulary import Vocabulary as JaxVocabulary
from pylda_tpu.models import layouts as jax_layouts
from pylda_tpu.utils.config import LDAConfig as JaxConfig
from pylda_tpu_torch.corpus.corpus import Corpus
from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.corpus.vocabulary import Vocabulary
from pylda_tpu_torch.models import layouts
from pylda_tpu_torch.utils.config import LDAConfig


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _corpora(seed, D=120, K=6, V=700, mean_len=40.0):
    kw = dict(num_docs=D, num_topics=K, num_types=V,
              mean_doc_length=mean_len, seed=seed)
    return synthetic_corpus(**kw), jax_synthetic(**kw)


def _assert_batches_equal(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert type(a).__name__ == type(b).__name__
        for f in ("ids", "cnts", "counts", "mask", "doc_ids"):
            if hasattr(b, f):
                x, y = getattr(a, f), np.asarray(getattr(b, f))
                assert x.dtype == y.dtype and x.shape == y.shape, f
                np.testing.assert_array_equal(x, y)


def test_vocabulary_matches():
    types = ["b", "a", "", "b", "c", "a", "d"]
    ours, theirs = Vocabulary(types), JaxVocabulary(types)
    assert ours.types == theirs.types
    assert [ours.get(t) for t in "abcdz"] == [theirs.get(t) for t in "abcdz"]
    lines = ["The cat sat", "a DOG sat", ""]
    assert (Vocabulary.from_corpus_lines(lines).types
            == JaxVocabulary.from_corpus_lines(lines).types)


def test_from_lines_matches_reference_parser():
    from pylda_tpu.corpus.corpus import Corpus as JaxCorpus

    vocab = Vocabulary(["cat", "dog", "sat", "mat"])
    lines = ["The Cat sat on the mat", "", "dog DOG dog", "zzz"]
    ours = Corpus.from_lines(lines, vocab)
    theirs = JaxCorpus.from_lines(lines, JaxVocabulary(vocab.types))
    assert len(ours.docs) == len(theirs.docs)
    for a, b in zip(ours.docs, theirs.docs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_corpus_bit_identical(seed):
    (c, beta, theta), (cj, beta_j, theta_j) = _corpora(seed)
    np.testing.assert_array_equal(beta, beta_j)
    np.testing.assert_array_equal(theta, theta_j)
    assert c.vocab.types == cj.vocab.types
    for a, b in zip(c.docs, cj.docs):
        np.testing.assert_array_equal(a, b)
    for d in range(c.num_docs):
        for x, y in zip(c.doc_unique(d), cj.doc_unique(d)):
            np.testing.assert_array_equal(x, y)


def test_dense_and_ragged_layouts_bit_identical():
    (c, _, _), (cj, _, _) = _corpora(1)
    _assert_batches_equal(
        [c.to_dense(doc_indices=range(5, 40), pad_docs_to=48)],
        [cj.to_dense(doc_indices=range(5, 40), pad_docs_to=48)],
    )
    for kw in (dict(bucket_sizes=(16, 32, 64), doc_pad_multiple=8),
               dict(bucket_sizes=(8, 16), doc_pad_multiple=4,
                    doc_indices=range(0, 120, 3))):
        _assert_batches_equal(c.to_ragged_buckets(**kw),
                              cj.to_ragged_buckets(**kw))
    caps = {16: 32, 32: 64, 64: 96}  # overflow promotes upward
    _assert_batches_equal(
        c.to_ragged_buckets(bucket_capacities=caps),
        cj.to_ragged_buckets(bucket_capacities=caps),
    )
    from pylda_tpu.corpus.corpus import GeometryOverflow as JaxOverflow
    from pylda_tpu_torch.corpus.corpus import GeometryOverflow

    with pytest.raises(GeometryOverflow):
        c.to_ragged_buckets(bucket_capacities={16: 8, 64: 8})
    with pytest.raises(JaxOverflow):
        cj.to_ragged_buckets(bucket_capacities={16: 8, 64: 8})


def test_plan_bucket_sizes_matches():
    rng = np.random.default_rng(0)
    u = np.concatenate([rng.poisson(90, 500), rng.integers(1, 3000, 40)])
    for kw in ({}, dict(max_buckets=3, align=32),
               dict(minibatch_fraction=0.1), dict(cap=512, row_pad=16)):
        assert (layouts.plan_bucket_sizes(u, **kw)
                == jax_layouts.plan_bucket_sizes(u, **kw))
    (c, _, _), (cj, _, _) = _corpora(2)
    np.testing.assert_array_equal(layouts.unique_counts_of(c),
                                  jax_layouts.unique_counts_of(cj))


@pytest.mark.parametrize(
    "cfg_kw",
    [
        dict(dense_vocab_threshold=256, doc_pad_multiple=8),  # ragged, auto
        dict(dense_vocab_threshold=256, doc_pad_multiple=8,
             bucket_sizes=(16, 32, 48), estep_memory_budget_mb=1),  # chunked
        dict(dense_vocab_threshold=4096, doc_pad_multiple=16,
             estep_memory_budget_mb=1),  # dense layout
    ],
)
def test_build_vb_batches_bit_identical(cfg_kw):
    (c, _, _), (cj, _, _) = _corpora(4, K=8)
    ours = layouts.build_vb_batches(c, LDAConfig(number_of_topics=8, **cfg_kw))
    theirs = jax_layouts.build_vb_batches(
        cj, JaxConfig(number_of_topics=8, **cfg_kw)
    )
    _assert_batches_equal(ours, theirs)
    assert (layouts.effective_bucket_sizes(c, LDAConfig(**cfg_kw))
            == jax_layouts.effective_bucket_sizes(cj, JaxConfig(**cfg_kw)))


def test_small_corpus_bucket_shapes_match():
    (c, _, _), (cj, _, _) = _corpora(5, D=96, K=8, V=600)
    kw = dict(number_of_topics=8, dense_vocab_threshold=256,
              doc_pad_multiple=8)
    shapes = [b.ids.shape for b in layouts.build_vb_batches(c, LDAConfig(**kw))]
    shapes_j = [tuple(b.ids.shape)
                for b in jax_layouts.build_vb_batches(cj, JaxConfig(**kw))]
    assert shapes == shapes_j and len(shapes) >= 1


def test_assemble_gamma_bit_identical():
    rng = np.random.default_rng(9)
    alpha = rng.random(5).astype(np.float32)
    ids = [np.array([0, 3, -1, 3], np.int32), np.array([1, 2, 0], np.int32)]
    gammas = [rng.random((4, 5)).astype(np.float32),
              rng.random((3, 5)).astype(np.float32)]
    np.testing.assert_array_equal(
        layouts.assemble_gamma(ids, gammas, 5, alpha),
        jax_layouts.assemble_gamma(ids, gammas, 5, alpha),
    )
