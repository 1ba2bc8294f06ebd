"""The port's disk-backed ``StreamingCorpus`` against pylda_tpu's, and SVI
and the CLI on it (CPU).

The same doc.dat (written from a seeded synthetic corpus) goes to both
packages.  Everything here is exact: offsets, token counts, rows and the
parsed-row sidecar's files are compared bit for bit, and a streaming SVI
run is bitwise equal to the in-memory run (the JAX package's contract,
tests/test_svi.py).  Against the JAX CLI the held-out perplexity is held
within 1%, as in tests/test_torch_svi.py.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pylda_tpu.cli.train import main as jax_train_main
from pylda_tpu.corpus.streaming import StreamingCorpus as JaxStreaming
from pylda_tpu.corpus.vocabulary import Vocabulary as JaxVocabulary
from pylda_tpu_torch.corpus import streaming as streaming_mod
from pylda_tpu_torch.corpus.datasets import (
    bundled_corpus_dir,
    load_input_directory,
)
from pylda_tpu_torch.corpus.streaming import StreamingCorpus
from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.corpus.vocabulary import Vocabulary
from pylda_tpu_torch.models import StochasticVariationalBayes
from pylda_tpu_torch.utils.config import LDAConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDECAR_FILES = ("ids.bin", "uids.bin", "ucnts.bin", "offsets.npy",
                 "uoffsets.npy", "uniq.npy", "meta.json")
SVI_CFG = dict(number_of_topics=5, inference_mode="svi", alpha_alpha=0.2,
               alpha_beta=0.02, inner_iterations=30, doc_pad_multiple=8,
               batch_size=64, tau0=16.0, kappa=0.7, seed=0)
RAGGED = dict(dense_vocab_threshold=0, bucket_sizes=(32, 64, 128))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def corpus():
    return synthetic_corpus(num_docs=200, num_topics=5, num_types=150,
                            mean_doc_length=40.0, seed=4)[0]


def _write(corpus, d, extra_line=None):
    """doc.dat of the corpus's documents (plus an empty line and a line
    with out-of-vocabulary words) in directory d; returns its path and
    the vocabulary."""
    os.makedirs(d, exist_ok=True)
    path = os.path.join(str(d), "doc.dat")
    with open(path, "w") as f:
        for doc in corpus.docs:
            f.write(" ".join(corpus.vocab[t] for t in doc) + "\n")
        f.write("\n")
        f.write("Unknown WORDS " + corpus.vocab[3].upper() + "\n")
        if extra_line:
            f.write(extra_line + "\n")
    return path, corpus.vocab


def _jax_vocab(vocab):
    return JaxVocabulary(vocab.types)


def _assert_batches_equal(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        for f in type(a).__dataclass_fields__:
            np.testing.assert_array_equal(getattr(a, f),
                                          np.asarray(getattr(b, f)), err_msg=f)


# -- the corpus against the JAX package's ------------------------------------------


@pytest.mark.parametrize("row_cache", ["auto", "off"])
def test_streaming_corpus_matches_jax(corpus, tmp_path, row_cache):
    ours_path, vocab = _write(corpus, tmp_path / "ours")
    theirs_path, _ = _write(corpus, tmp_path / "theirs")
    ours = StreamingCorpus(ours_path, vocab, row_cache=row_cache)
    theirs = JaxStreaming(theirs_path, _jax_vocab(vocab), row_cache=row_cache)
    assert (ours._row_ids is None) == (row_cache == "off")
    np.testing.assert_array_equal(ours._offsets, theirs._offsets)
    np.testing.assert_array_equal(ours._unique_counts, theirs._unique_counts)
    assert ours.num_docs == theirs.num_docs == corpus.num_docs + 2
    assert ours.num_tokens == theirs.num_tokens == corpus.num_tokens + 1
    assert ours.global_num_docs == theirs.global_num_docs
    assert not ours.process_local
    sizes = (16, 32, 64)
    assert ours.ragged_row_histogram(sizes) == theirs.ragged_row_histogram(
        sizes)
    idx = [3, 0, 17, 201, 200, 5]
    _assert_batches_equal([ours.to_dense(idx, pad_docs_to=8)],
                          [theirs.to_dense(idx, pad_docs_to=8)])
    kw = dict(bucket_sizes=sizes, doc_pad_multiple=8)
    _assert_batches_equal(ours.to_ragged_buckets(**kw),
                          theirs.to_ragged_buckets(**kw))
    _assert_batches_equal(ours.to_ragged_buckets(doc_indices=idx, **kw),
                          theirs.to_ragged_buckets(doc_indices=idx, **kw))
    sub = ours.subset(idx)
    for d, i in enumerate(idx):
        np.testing.assert_array_equal(sub.docs[d],
                                      np.asarray(theirs.subset([i]).docs[0]))
    for a, b in zip(ours.minibatch_indices(64, seed=7),
                    theirs.minibatch_indices(64, seed=7)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sidecar_is_valid_for_both_packages(corpus, tmp_path, monkeypatch,
                                            writer):
    """A sidecar written by either package is read by the other without
    an indexing pass, and both write the same files."""
    path, vocab = _write(corpus, tmp_path / "a")
    other, _ = _write(corpus, tmp_path / "b")
    first = (StreamingCorpus(path, vocab) if writer == "port"
             else JaxStreaming(path, _jax_vocab(vocab)))
    # Both packages' sidecars of one text are the same bytes.
    StreamingCorpus(other, vocab)
    JaxStreaming(other, _jax_vocab(vocab))
    d = first._rowcache_dir()
    assert os.path.basename(d) == f"doc.dat.rowcache.v2.0-{first.num_docs}"
    for name in SIDECAR_FILES:
        with open(os.path.join(d, name), "rb") as f:
            data = f.read()
        with open(os.path.join(str(tmp_path / "b"),
                               os.path.basename(d), name), "rb") as f:
            want = f.read()
        if name == "meta.json":  # the other file's mtime
            data, want = json.loads(data), json.loads(want)
            data.pop("doc_dat_mtime_ns")
            want.pop("doc_dat_mtime_ns")
        assert data == want, name

    def boom(*a, **k):
        raise AssertionError("reopen re-parsed despite a valid sidecar")

    if writer == "port":
        import pylda_tpu.corpus.streaming as jax_streaming

        monkeypatch.setattr(jax_streaming.StreamingCorpus, "_index_scan",
                            boom)
        second = JaxStreaming(path, _jax_vocab(vocab))
    else:
        monkeypatch.setattr(StreamingCorpus, "_index_scan", boom)
        second = StreamingCorpus(path, vocab)
    assert second._row_ids is not None
    assert second.num_tokens == first.num_tokens
    np.testing.assert_array_equal(second._unique_counts, first._unique_counts)
    for i in (0, 5, first.num_docs - 1):
        np.testing.assert_array_equal(np.asarray(second.subset([i]).docs[0]),
                                      np.asarray(first.subset([i]).docs[0]))


def test_sidecar_invalidated_by_text_change(corpus, tmp_path):
    path, vocab = _write(corpus, tmp_path)
    first = StreamingCorpus(path, vocab)
    with open(path, "a") as f:
        f.write(vocab[0] + " " + vocab[1] + "\n")
    fresh = StreamingCorpus(path, vocab)
    assert fresh.num_docs == first.num_docs + 1
    assert fresh.num_tokens == first.num_tokens + 2
    assert fresh._row_ids is not None  # a valid sidecar again
    np.testing.assert_array_equal(fresh.subset([fresh.num_docs - 1]).docs[0],
                                  [0, 1])
    # And a changed vocabulary invalidates it too.
    again = StreamingCorpus(path, Vocabulary(vocab.types[::-1]))
    assert again._rowcache_dir() == fresh._rowcache_dir()
    assert again.num_tokens == fresh.num_tokens
    np.testing.assert_array_equal(again.subset([fresh.num_docs - 1]).docs[0],
                                  [149, 148])


def test_sidecar_unwritable_directory_falls_back(corpus, tmp_path,
                                                 monkeypatch):
    """Where no temporary file can be made beside doc.dat, documents are
    parsed on demand, with the same rows."""
    path, vocab = _write(corpus, tmp_path)

    def refuse(*a, **k):
        raise PermissionError("read-only directory")

    monkeypatch.setattr(streaming_mod.tempfile, "mkstemp", refuse)
    sc = StreamingCorpus(path, vocab)
    assert sc._row_ids is None
    assert not glob.glob(str(tmp_path / "doc.dat.rowcache*"))
    monkeypatch.undo()
    cached = StreamingCorpus(path, vocab)
    assert cached._row_ids is not None and sc.num_tokens == cached.num_tokens
    for a, b in zip(sc.subset([0, 1, 200]).docs,
                    cached.subset([0, 1, 200]).docs):
        np.testing.assert_array_equal(a, b)


def test_streaming_corpus_holds_no_documents(corpus, tmp_path):
    """The point of streaming: no per-document arrays are kept, only one
    int64 offset a document (+1) and the unique counts."""
    path, vocab = _write(corpus, tmp_path)
    stream = StreamingCorpus(path, vocab)
    assert not hasattr(stream, "docs") and not hasattr(stream, "_uniques")
    assert stream._offsets.nbytes == 8 * (stream.num_docs + 1)
    assert stream._unique_counts.nbytes == 4 * stream.num_docs


def test_process_local_streaming_raises(corpus, tmp_path):
    """A process's block of a streaming corpus: the same documents,
    offsets and sidecar name as the JAX package's StreamingCorpus for the
    same block, each block's sidecar its own; a process index outside the
    count raises."""
    path, vocab = _write(corpus, tmp_path)
    vocab_j = JaxVocabulary(vocab.types)
    whole = StreamingCorpus(path, vocab, process_index=0, process_count=1)
    assert not whole.process_local
    for p in range(2):
        ours = StreamingCorpus(path, vocab, process_index=p, process_count=2)
        theirs = JaxStreaming(path, vocab_j, process_index=p,
                                    process_count=2)
        assert ours.process_local and theirs.process_local
        assert (ours.num_docs, ours.global_num_docs, ours.global_doc_offset,
                ours.num_tokens) == (
            theirs.num_docs, theirs.global_num_docs,
            theirs.global_doc_offset, theirs.num_tokens)
        assert ours._rowcache_dir() == theirs._rowcache_dir()
        assert os.path.isdir(ours._rowcache_dir())
        lo = ours.global_doc_offset
        for d in range(ours.num_docs):
            np.testing.assert_array_equal(ours.subset([d]).docs[0],
                                          whole.subset([lo + d]).docs[0])
    assert len(glob.glob(path + ".rowcache.v2.*")) == 3
    with pytest.raises(ValueError, match="outside"):
        StreamingCorpus(path, vocab, process_index=2, process_count=2)


def test_load_input_directory_streaming(tmp_path):
    for name in ("doc.dat", "voc.dat", "test.dat"):
        with open(os.path.join(bundled_corpus_dir(), name)) as f:
            (tmp_path / name).write_text(f.read())
    train, test, vocab = load_input_directory(str(tmp_path), streaming=True)
    mem, test_mem, _ = load_input_directory(str(tmp_path))
    assert isinstance(train, StreamingCorpus)
    assert train.num_docs == mem.num_docs and train.num_tokens == mem.num_tokens
    assert test.num_docs == test_mem.num_docs
    for d in (0, 7, mem.num_docs - 1):
        np.testing.assert_array_equal(train.subset([d]).docs[0], mem.docs[d])


# -- SVI on a streaming corpus ------------------------------------------------------


@pytest.mark.parametrize(
    "layout",
    ["dense", "ragged_scatter", "ragged_auto", "ragged_host_repack"])
def test_streaming_svi_matches_in_memory(corpus, tmp_path, layout):
    """tests/test_svi.py's streaming contract: the same minibatches, the
    same layouts, the same updates — the same bits.  On the dense layout
    the [D+1, V] matrix, on the ragged one the device-resident rows with
    the scatter E-step or the dense sstats plan, or the host repack."""
    extra = {"dense": {},
             "ragged_scatter": dict(RAGGED, sstats_mode="scatter"),
             "ragged_auto": RAGGED,
             "ragged_host_repack": dict(RAGGED, sstats_mode="scatter",
                                        svi_device_rows_budget_mb=0)}[layout]
    path, vocab = _write(corpus, tmp_path)
    stream = StreamingCorpus(path, vocab)
    mem = stream.subset(range(stream.num_docs))
    runs = {}
    for name, c in (("mem", mem), ("stream", stream)):
        eng = StochasticVariationalBayes(LDAConfig(**SVI_CFG, **extra),
                                         device="cpu")
        eng.initialize(c, vocab)
        assert (eng._mb_sstats is None) == (layout != "ragged_auto")
        assert (eng._device_rows is None) == (layout == "ragged_host_repack")
        ests = [eng.learning() for _ in range(2)] + eng.learning_many(1)
        runs[name] = (eng.state.lam, ests, eng.gamma)
    assert runs["mem"][1] == runs["stream"][1]
    assert torch.equal(runs["mem"][0], runs["stream"][0])
    np.testing.assert_array_equal(runs["mem"][2], runs["stream"][2])


# -- the CLI --------------------------------------------------------------------------


def _copy_bundled(d):
    os.makedirs(d, exist_ok=True)
    for name in ("doc.dat", "voc.dat", "test.dat"):
        with open(os.path.join(bundled_corpus_dir(), name)) as f:
            with open(os.path.join(d, name), "w") as g:
                g.write(f.read())
    return d


def _final_perplexity(out):
    (run,) = glob.glob(os.path.join(out, "*", "*"))
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f][-1]["perplexity"], run


def test_cli_streaming_scatter_matches_jax_cli(tmp_path):
    """``python -m pylda_tpu_torch.cli.train --inference_mode=svi
    --streaming_input --sstats_mode=scatter`` on the ragged layout, from
    one initial SVI model file in both packages: the same files, held-out
    perplexity within 1% of the JAX CLI's; and the port's run with the
    corpus in memory gives the same bits."""
    corpus_dir = _copy_bundled(str(tmp_path / "de-news-tiny"))
    train, _, vocab = load_input_directory(corpus_dir)
    init = StochasticVariationalBayes(LDAConfig(
        number_of_topics=10, inference_mode="svi", batch_size=100,
        inner_iterations=20, dense_vocab_threshold=0, sstats_mode="scatter"),
        device="cpu")
    init.initialize(train, vocab)
    init.save(str(tmp_path / "model-0"))
    argv = [f"--input_directory={corpus_dir}", "--number_of_topics=10",
            "--inference_mode=svi", "--training_iterations=2",
            "--snapshot_interval=2", f"--resume={tmp_path / 'model-0'}",
            "--dump_gamma", "--streaming_input"]
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "pylda_tpu_torch.cli.train", *argv,
         f"--output_directory={tmp_path / 'port'}", "--device=cpu"],
        capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    assert glob.glob(os.path.join(corpus_dir, "doc.dat.rowcache.v2.0-400"))
    assert jax_train_main([*argv, f"--output_directory={tmp_path / 'jax'}"]) == 0
    from pylda_tpu_torch.cli.train import main as train_main

    assert train_main([*argv[:-1], f"--output_directory={tmp_path / 'mem'}",
                       "--device=cpu"]) == 0
    ppl, run = _final_perplexity(str(tmp_path / "port"))
    ppl_j, run_j = _final_perplexity(str(tmp_path / "jax"))
    ppl_m, run_m = _final_perplexity(str(tmp_path / "mem"))
    assert sorted(os.listdir(run)) == sorted(os.listdir(run_j))
    assert ppl == pytest.approx(ppl_j, rel=0.01)
    assert ppl == ppl_m
    for name in ("model-2", "gamma-2"):
        with open(os.path.join(run, name), "rb") as f:
            ours = f.read()
        with open(os.path.join(run_m, name), "rb") as f:
            assert ours == f.read(), name


def test_cli_streaming_input_requires_svi(tmp_path):
    from pylda_tpu_torch.cli.train import main as train_main

    corpus_dir = _copy_bundled(str(tmp_path / "c"))
    with pytest.raises(SystemExit, match="requires --inference_mode=svi"):
        train_main([f"--input_directory={corpus_dir}",
                    f"--output_directory={tmp_path / 'o'}",
                    "--number_of_topics=4", "--streaming_input",
                    "--device=cpu"])
    assert not (tmp_path / "o").exists()
