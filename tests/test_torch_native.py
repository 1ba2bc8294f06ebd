"""The port's C tokenizer (``pylda_tpu_torch.native``, CPU).

A mirror of tests/test_native.py: the port builds its own copy of
``_fastcorpus.c`` at first use and must parse bit for bit as the JAX
package's ``pylda_tpu.native.parse_lines`` and ``parse_stats`` (and its
Python parser), on the non-ASCII route, trailing blank lines, very long
tokens and reused tables; and a ``StreamingCorpus`` indexed through it
equals one indexed in Python, sidecar included.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import pylda_tpu_torch.native as native
from pylda_tpu.native import parse_lines as jax_parse_lines
from pylda_tpu.native import parse_stats as jax_parse_stats
from pylda_tpu_torch.corpus.corpus import Corpus
from pylda_tpu_torch.corpus.streaming import StreamingCorpus
from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.corpus.vocabulary import Vocabulary
from pylda_tpu_torch.native import (
    NativeVocabTable,
    _python_parse,
    _stats_of_docs,
    parse_lines,
    parse_stats,
)

LINES = [
    "Apple banana APPLE unknown cherry",
    "",
    "date date\tbanana  cherry",
    "zzz qqq",
    "egg Egg EGG",  # an uppercase vocabulary entry never matches (reference)
    "apple apple apple",
    "",
]


@pytest.fixture
def vocab():
    return Vocabulary(["apple", "banana", "cherry", "date", "Egg"])


@pytest.fixture
def built():
    """The C tokenizer must build here (a C compiler is present)."""
    assert native.have_native(), native.BUILD_ERROR
    assert native.HAVE_NATIVE is True


def _same_docs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(w))


def test_parity_with_jax_and_python(vocab, built):
    _same_docs(parse_lines(LINES, vocab), jax_parse_lines(LINES, vocab))
    _same_docs(parse_lines(LINES, vocab), _python_parse(LINES, vocab))


def test_native_table_reuse(vocab, built):
    table = NativeVocabTable(vocab.types)
    d1 = parse_lines(["apple cherry"], vocab, table=table)
    d2 = parse_lines(["banana"], vocab, table=table)
    np.testing.assert_array_equal(d1[0], [0, 2])
    np.testing.assert_array_equal(d2[0], [1])


def test_non_ascii_goes_to_python(vocab, built):
    lines = ["apple Straße banana", "ÄPFEL apple"]
    got = parse_lines(lines, vocab)
    _same_docs(got, jax_parse_lines(lines, vocab))
    np.testing.assert_array_equal(got[0], [0, 1])


def test_corpus_from_lines_uses_parser(vocab, built, monkeypatch):
    calls = []
    inner = NativeVocabTable.parse_bytes
    monkeypatch.setattr(NativeVocabTable, "parse_bytes",
                        lambda self, data: calls.append(1) or inner(self, data))
    c = Corpus.from_lines(["apple banana", "cherry"], vocab)
    assert calls and c.num_docs == 2
    np.testing.assert_array_equal(c.docs[0], [0, 1])
    np.testing.assert_array_equal(c.docs[1], [2])


def test_large_input_parity_with_jax(built):
    rng = np.random.default_rng(0)
    types = [f"word{i}" for i in range(20_000)]
    vocab = Vocabulary(types)
    words = np.array(types + ["OOV", "Word7"])
    lines = [" ".join(words[rng.integers(0, len(words), 80)])
             for _ in range(2000)]
    table = NativeVocabTable(vocab.types)
    _same_docs(parse_lines(lines, vocab, table=table),
               jax_parse_lines(lines, vocab))


def test_trailing_blank_line_parity(vocab, built):
    lines = ["apple banana", "", ""]
    got = parse_lines(lines, vocab)
    _same_docs(got, _python_parse(lines, vocab))
    _same_docs(got, jax_parse_lines(lines, vocab))
    assert len(got) == 3 and got[2].size == 0


def test_very_long_token_parity(built):
    long_tok = "x" * 300
    vocab = Vocabulary(["short", long_tok])
    lines = [f"short {long_tok.upper()} short"]
    got = parse_lines(lines, vocab)
    _same_docs(got, jax_parse_lines(lines, vocab))
    assert got[0].size == 3


def test_parse_stats_parity(vocab, built):
    toks, uniqs = parse_stats(LINES, vocab)
    j_toks, j_uniqs = jax_parse_stats(LINES, vocab)
    w_toks, w_uniqs = _stats_of_docs(_python_parse(LINES, vocab))
    for got, jax_want, py_want in ((toks, j_toks, w_toks),
                                   (uniqs, j_uniqs, w_uniqs)):
        np.testing.assert_array_equal(got, jax_want)
        np.testing.assert_array_equal(got, py_want)
    table = NativeVocabTable(vocab.types)
    t1, u1 = parse_stats(["apple cherry cherry"], vocab, table=table)
    t2, u2 = parse_stats(["banana"], vocab, table=table)
    np.testing.assert_array_equal([t1, u1, t2, u2], [[3], [2], [1], [1]])


def test_streaming_index_native_equals_python(tmp_path, monkeypatch, built):
    """The indexing pass through the C tokenizer (one reused table) gives
    the same corpus and the same sidecar bytes as the Python parser."""
    corpus = synthetic_corpus(num_docs=300, num_topics=4, num_types=500,
                              mean_doc_length=30.0, seed=1)[0]
    vocab = corpus.vocab
    text = "".join(" ".join(vocab.types[int(i)] for i in d) + "\n"
                   for d in corpus.docs)
    dirs = {}
    for route in ("native", "python"):
        d = tmp_path / route
        d.mkdir()
        (d / "doc.dat").write_text(text)
        with monkeypatch.context() as m:
            if route == "python":
                m.setitem(native._STATE, "module", None)
            sc = StreamingCorpus(str(d / "doc.dat"), vocab)
            dirs[route] = (sc, d)
    (a, da), (b, db) = dirs["native"], dirs["python"]
    assert a.num_docs == b.num_docs == corpus.num_docs
    assert a.num_tokens == b.num_tokens == corpus.num_tokens
    np.testing.assert_array_equal(a._unique_counts, b._unique_counts)
    cache = [p for p in os.listdir(da) if ".rowcache." in p]
    assert len(cache) == 1
    for name in sorted(os.listdir(da / cache[0])):
        if name != "meta.json":
            assert ((da / cache[0] / name).read_bytes()
                    == (db / cache[0] / name).read_bytes()), name
    for sub in (a.subset(range(0, 300, 7)), b.subset(range(0, 300, 7))):
        for i, doc in enumerate(range(0, 300, 7)):
            np.testing.assert_array_equal(sub.docs[i], corpus.docs[doc])


def test_failed_build_falls_back_loudly(tmp_path):
    """Without a C compiler the parse stays in Python: HAVE_NATIVE is
    False, BUILD_ERROR says why and a warning shows it."""
    code = (
        "import warnings, pylda_tpu_torch.native as n\n"
        "from pylda_tpu_torch.corpus.vocabulary import Vocabulary\n"
        f"n.BUILD_DIR = __import__('pathlib').Path({str(tmp_path)!r})\n"
        "with warnings.catch_warnings(record=True) as w:\n"
        "    warnings.simplefilter('always')\n"
        "    docs = n.parse_lines(['a b'], Vocabulary(['a', 'b']))\n"
        "print(n.HAVE_NATIVE, 'no C compiler' in n.BUILD_ERROR,\n"
        "      any('parsing in Python' in str(x.message) for x in w),\n"
        "      docs[0].tolist())\n"
    )
    env = {**os.environ, "PATH": str(tmp_path),
           "PYTHONPATH": os.pathsep.join(sys.path)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "True", "True", "[0,", "1]"]


def test_concurrent_builds_publish_one_library(tmp_path):
    """Processes that build at once into one directory (as the test
    workers do) all load the library; one file is published and no
    temporary is left."""
    code = (
        "import pathlib, sys, pylda_tpu_torch.native as n\n"
        "n.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
        "print(n.have_native(), n.BUILD_ERROR)\n"
    )
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(sys.path)}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(12)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert all(o.split() == ["True", "None"] for o, _ in outs), outs
    built = sorted(p.name for p in tmp_path.iterdir())
    assert len([b for b in built if b.endswith(".so")]) == 1, built
    assert not [b for b in built if ".tmp" in b], built
