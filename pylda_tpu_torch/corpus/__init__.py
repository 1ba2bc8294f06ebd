from pylda_tpu_torch.corpus.vocabulary import Vocabulary
from pylda_tpu_torch.corpus.corpus import (
    Corpus,
    DenseBatch,
    RaggedBucket,
    SequenceBucket,
)
from pylda_tpu_torch.corpus.streaming import StreamingCorpus
from pylda_tpu_torch.corpus.synthetic import synthetic_corpus

__all__ = [
    "Vocabulary",
    "Corpus",
    "DenseBatch",
    "RaggedBucket",
    "SequenceBucket",
    "StreamingCorpus",
    "synthetic_corpus",
]
