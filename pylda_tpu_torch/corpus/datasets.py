"""The bundled example corpus and input-directory loading.

Counterpart of ``pylda_tpu.corpus.datasets``: the reference's on-disk
contract — ``doc.dat`` (training documents, one per line; ``train.dat`` is
accepted too), ``voc.dat`` (one type per line) and an optional
``test.dat`` (held-out documents) — and the bundled corpus
``data/de-news-tiny``, generated deterministically from themed English
word lists (``make_denews_tiny``; the committed files are never
regenerated inside the repository).
"""

from __future__ import annotations

import itertools
import os
from typing import Optional, Tuple, Union

import numpy as np

from pylda_tpu_torch.corpus.corpus import Corpus
from pylda_tpu_torch.corpus.streaming import StreamingCorpus
from pylda_tpu_torch.corpus.vocabulary import Vocabulary
from pylda_tpu_torch.parallel.mesh import block_bounds

# Ten human-readable themes imitating the de-news newswire register.
_THEMES = {
    "politics": """government minister parliament election party coalition
        chancellor vote opposition policy debate reform cabinet president
        democracy campaign ballot legislation senate treaty""",
    "economy": """market economy growth inflation bank interest trade export
        import currency stocks investment profit budget deficit tax
        unemployment industry recession earnings""",
    "sport": """team match goal league season player coach championship
        tournament victory defeat score stadium football tennis olympic
        medal race final training""",
    "weather": """weather rain snow temperature storm wind sunshine forecast
        cloud flood drought degrees celsius cold warm frost thunder climate
        humidity pressure""",
    "crime": """police arrest crime court judge trial sentence prison
        investigation suspect murder theft evidence lawyer verdict charges
        detective robbery fraud witness""",
    "technology": """computer software internet technology research network
        digital system data engineer science laboratory innovation satellite
        telescope processor robot energy nuclear physics chemistry""",
    "health": """hospital doctor patient health medicine disease treatment
        vaccine surgery virus infection nurse therapy diagnosis epidemic
        clinic pharmacy cancer symptom recovery""",
    "culture": """music concert theater film festival artist museum exhibition
        opera orchestra painting novel author literature gallery premiere
        symphony ballet sculpture poetry""",
    "transport": """train railway airport flight traffic highway airline
        station passenger vehicle driver accident route bridge tunnel
        shipping harbor cargo bus bicycle""",
    "education": """school university student teacher education exam lecture
        professor degree classroom curriculum tuition scholarship graduate
        faculty semester research thesis library kindergarten""",
}

_FILLERS = """the a of in on and for with from after before during under
    over between about against new old first last next major minor local
    national international official report announced said week month year
    today yesterday""".split()


def make_denews_tiny(
    out_dir: str,
    num_train: int = 400,
    num_test: int = 100,
    mean_doc_length: float = 60.0,
    seed: int = 20260816,
) -> None:
    """Generate a de-news-shaped corpus into out_dir/{doc,voc,test}.dat
    (the same files as the JAX package's generator for the same
    arguments)."""
    rng = np.random.default_rng(seed)
    themes = {k: v.split() for k, v in _THEMES.items()}
    names = sorted(themes)
    os.makedirs(out_dir, exist_ok=True)

    def sample_doc() -> str:
        # 1-2 dominant themes + filler noise, newswire-style.
        n_themes = rng.integers(1, 3)
        chosen = rng.choice(len(names), size=n_themes, replace=False)
        weights = rng.dirichlet(np.full(n_themes, 0.6))
        n = max(8, rng.poisson(mean_doc_length))
        words = []
        for _ in range(n):
            if rng.random() < 0.25:
                words.append(_FILLERS[rng.integers(len(_FILLERS))])
            else:
                t = themes[names[chosen[rng.choice(n_themes, p=weights)]]]
                words.append(t[rng.integers(len(t))])
        return " ".join(words)

    with open(os.path.join(out_dir, "doc.dat"), "w", encoding="utf-8") as f:
        for _ in range(num_train):
            f.write(sample_doc() + "\n")
    with open(os.path.join(out_dir, "test.dat"), "w", encoding="utf-8") as f:
        for _ in range(num_test):
            f.write(sample_doc() + "\n")
    vocab = sorted(set(w for t in themes.values() for w in t) | set(_FILLERS))
    with open(os.path.join(out_dir, "voc.dat"), "w", encoding="utf-8") as f:
        for w in vocab:
            f.write(w + "\n")


def bundled_corpus_dir() -> str:
    """Path of the committed bundled corpus, ``data/de-news-tiny``."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    d = os.path.join(here, "data", "de-news-tiny")
    if not os.path.exists(os.path.join(d, "doc.dat")):
        raise FileNotFoundError(
            f"the bundled corpus is missing from {d}; it is committed with "
            "the repository (make_denews_tiny writes a copy elsewhere)"
        )
    return d


def load_input_directory(
    input_directory: str,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    streaming: bool = False,
) -> Tuple[Union[Corpus, StreamingCorpus], Optional[Corpus], Vocabulary]:
    """Load the reference's input contract: doc.dat + voc.dat [+ test.dat].

    Without voc.dat the vocabulary is built from the training documents
    (sorted).  ``streaming`` returns the training documents as a
    disk-backed ``StreamingCorpus`` (line offsets in RAM, documents
    parsed on demand or read from its row sidecar); the held-out
    documents stay in RAM.

    Process-local input: with ``process_index`` and ``process_count`` > 1
    each process parses only its own contiguous block of ``doc.dat`` (the
    ceil block size, the last blocks short or empty): the returned corpus
    has ``process_local`` True, ``global_num_docs`` and
    ``global_doc_offset``.  The vocabulary and the held-out ``test.dat``
    load whole on every process."""
    doc_path = os.path.join(input_directory, "doc.dat")
    if not os.path.exists(doc_path):
        alt = os.path.join(input_directory, "train.dat")
        if os.path.exists(alt):
            doc_path = alt
        else:
            raise FileNotFoundError(f"no doc.dat/train.dat in {input_directory}")
    voc_path = os.path.join(input_directory, "voc.dat")
    if os.path.exists(voc_path):
        vocab = Vocabulary.from_file(voc_path)
    else:
        with open(doc_path, "r", encoding="utf-8") as f:
            vocab = Vocabulary.from_corpus_lines(f)
    if streaming:
        train = StreamingCorpus(doc_path, vocab, process_index=process_index,
                                process_count=process_count)
    elif process_index is None or process_count in (None, 1):
        train = Corpus.from_file(doc_path, vocab)
    else:
        # A cheap pass counts the lines; then only this block is read.
        with open(doc_path, "r", encoding="utf-8") as f:
            total = sum(1 for _ in f)
        lo, hi = block_bounds(total, process_index, process_count)
        with open(doc_path, "r", encoding="utf-8") as f:
            window = list(itertools.islice(f, lo, hi))
        train = Corpus.from_lines(window, vocab)
        train.process_local = True
        train.global_num_docs = total
        train.global_doc_offset = lo
    test = None
    test_path = os.path.join(input_directory, "test.dat")
    if os.path.exists(test_path):
        test = Corpus.from_file(test_path, vocab)
    return train, test, vocab
