"""Topic-quality evaluation: UMass coherence (Mimno et al. 2011).

Counterpart of ``pylda_tpu.utils.coherence``, the same functions on the
port's corpora and engines.  For topic k with top words
w_1..w_M ordered by p(w|k):

    C_UMass(k) = sum_{m=2..M} sum_{l<m} log (D(w_m, w_l) + 1) / D(w_l)

where D(w) is the number of documents containing w and D(w, w') the
number containing both (document co-occurrence on a scoring corpus —
typically the training set).  Higher (less negative) is better; random
word sets score far below topical ones.

Pure NumPy on the host: the co-occurrence table only covers the K x top_n
candidate words, built in one pass over the corpus's unique-id lists
(``Corpus._uniques``); the topics come from the engine's
``topic_word_distribution`` (float64 on the host).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def doc_frequency_table(
    corpus, word_ids: Sequence[int]
) -> np.ndarray:
    """Boolean presence matrix [num_docs, len(word_ids)] from the
    corpus's per-document unique type ids."""
    word_ids = np.asarray(word_ids, dtype=np.int64)
    col = {int(w): i for i, w in enumerate(word_ids)}
    out = np.zeros((corpus.num_docs, len(word_ids)), dtype=bool)
    for d, (ids, _cnts) in enumerate(corpus._uniques):
        for w in ids:
            i = col.get(int(w))
            if i is not None:
                out[d, i] = True
    return out


def umass_coherence(
    topics_top_ids: Sequence[Sequence[int]], corpus
) -> List[float]:
    """Per-topic UMass coherence given each topic's top word ids
    (descending p(w|k)) and a scoring corpus."""
    vocabulary = sorted({int(w) for ws in topics_top_ids for w in ws})
    presence = doc_frequency_table(corpus, vocabulary)
    col = {w: i for i, w in enumerate(vocabulary)}
    dfreq = presence.sum(axis=0).astype(np.float64)  # D(w)
    co = (presence.T.astype(np.float64) @ presence)  # D(w, w')
    scores = []
    for ws in topics_top_ids:
        idx = [col[int(w)] for w in ws]
        s = 0.0
        for m in range(1, len(idx)):
            for l in range(m):
                d_l = dfreq[idx[l]]
                if d_l == 0:
                    continue  # word absent from the scoring corpus
                s += np.log((co[idx[m], idx[l]] + 1.0) / d_l)
        scores.append(float(s))
    return scores


def engine_coherence(
    engine, corpus, top_n: int = 10
) -> Dict[str, object]:
    """UMass coherence of an engine's current topics on ``corpus``.

    Returns {"per_topic": [...], "mean": float, "top_n": int}.
    """
    beta = np.asarray(engine.topic_word_distribution())  # [K, V]
    top = np.argsort(-beta, axis=1)[:, :top_n]
    per = umass_coherence([list(row) for row in top], corpus)
    return {
        "per_topic": per,
        "mean": float(np.mean(per)) if per else 0.0,
        "top_n": top_n,
    }
