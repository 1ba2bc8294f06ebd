from pylda_tpu_torch.corpus.vocabulary import Vocabulary
from pylda_tpu_torch.corpus.corpus import (
    Corpus,
    DenseBatch,
    RaggedBucket,
    SequenceBucket,
)
from pylda_tpu_torch.corpus.synthetic import synthetic_corpus

__all__ = [
    "Vocabulary",
    "Corpus",
    "DenseBatch",
    "RaggedBucket",
    "SequenceBucket",
    "synthetic_corpus",
]
