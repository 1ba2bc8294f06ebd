"""Synthetic LDA corpora.

Draws a corpus from the LDA generative model with numpy, step for step as
``pylda_tpu.corpus.synthetic`` does, so one seed gives bit-identical
corpora in both packages.  Used for topic-recovery tests and as the
benchmark stand-in for corpora that cannot be downloaded.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from pylda_tpu_torch.corpus.corpus import Corpus
from pylda_tpu_torch.corpus.vocabulary import Vocabulary


def synthetic_model(
    rng: np.random.Generator,
    num_topics: int,
    num_types: int,
    beta_concentration: float = 0.05,
) -> np.ndarray:
    """Draw topic-word distributions beta [K, V] from Dir(concentration)."""
    beta = rng.gamma(beta_concentration, 1.0, size=(num_topics, num_types))
    beta += 1e-12
    return beta / beta.sum(axis=1, keepdims=True)


def synthetic_corpus(
    num_docs: int,
    num_topics: int,
    num_types: int,
    mean_doc_length: float = 100.0,
    alpha: float = 0.1,
    beta_concentration: float = 0.05,
    seed: int = 0,
    beta: Optional[np.ndarray] = None,
    vocab: Optional[Vocabulary] = None,
) -> Tuple[Corpus, np.ndarray, np.ndarray]:
    """Sample a corpus from the LDA generative model.

    Returns (corpus, true_beta [K, V], true_theta [D, K]).
    """
    rng = np.random.default_rng(seed)
    if beta is None:
        beta = synthetic_model(rng, num_topics, num_types, beta_concentration)
    if vocab is None:
        width = len(str(num_types - 1))
        vocab = Vocabulary(f"w{v:0{width}d}" for v in range(num_types))
    theta = rng.dirichlet(np.full(num_topics, alpha), size=num_docs)
    # Inverse-CDF sampling with the CDFs built once (rng.choice(p=...)
    # would rebuild a V-length CDF per call).
    lens = np.maximum(1, rng.poisson(mean_doc_length, size=num_docs))
    total = int(lens.sum())
    cum_theta = np.cumsum(theta, axis=1)
    z_all = np.empty(total, dtype=np.int32)
    offs = np.concatenate([[0], np.cumsum(lens)])
    for d in range(num_docs):
        z_all[offs[d] : offs[d + 1]] = np.searchsorted(
            cum_theta[d], rng.random(lens[d]), side="right"
        )
    np.clip(z_all, 0, num_topics - 1, out=z_all)
    cum_beta = np.cumsum(beta, axis=1)
    w_all = np.empty(total, dtype=np.int32)
    for k in np.unique(z_all):
        sel = np.nonzero(z_all == k)[0]
        w_all[sel] = np.searchsorted(
            cum_beta[k], rng.random(sel.size), side="right"
        )
    np.clip(w_all, 0, num_types - 1, out=w_all)
    docs = [w_all[offs[d] : offs[d + 1]] for d in range(num_docs)]
    return Corpus(docs, vocab), beta, theta
