"""The port's CLIs, model files and corpus loading (CPU).

Mirrors tests/test_cli.py for ``python -m pylda_tpu_torch.cli.*`` with
``--device=cpu``, and holds the files against the JAX package's: a
``model-<N>`` written by either package loads in the other and gives the
same held-out perplexity (rel 1e-4: f32 summation order), ``exp_beta`` is
byte-identical for the same lambda, and the bundled corpus parses to the
same arrays.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from pylda_tpu.corpus.datasets import load_input_directory as jax_load
from pylda_tpu.corpus.datasets import make_denews_tiny as jax_make_denews
from pylda_tpu.models import Inferencer as JaxInferencer
from pylda_tpu.models import VariationalBayes as JaxVB
from pylda_tpu.utils.config import LDAConfig as JaxConfig
from pylda_tpu_torch.cli.infer import main as infer_main
from pylda_tpu_torch.cli.test import main as run_launch_test
from pylda_tpu_torch.cli.train import build_parser, config_from_args
from pylda_tpu_torch.cli.train import main as train_main
from pylda_tpu_torch.corpus.datasets import (
    bundled_corpus_dir,
    load_input_directory,
    make_denews_tiny,
)
from pylda_tpu_torch.models import Inferencer, VariationalBayes, state_from_numpy
from pylda_tpu_torch.utils.config import LDAConfig

CPU = "--device=cpu"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    make_denews_tiny(str(d), num_train=120, num_test=30, mean_doc_length=30)
    return str(d)


def _train(corpus_dir, out, *extra):
    return train_main([
        f"--input_directory={corpus_dir}", f"--output_directory={out}",
        "--number_of_topics=5", CPU, *extra,
    ])


def test_reference_flags_accepted():
    args = build_parser().parse_args([
        "--input_directory=/x", "--output_directory=/y",
        "--number_of_topics=25", "--training_iterations=7",
        "--alpha_alpha=0.3", "--alpha_beta=0.01", "--snapshot_interval=3",
        "--inference_mode=1", "--hyper_parameter_optimize_interval=5",
        "--bucket_policy=fixed", "--bucket_sizes=32,64,256",
    ])
    cfg = config_from_args(args)
    assert cfg.number_of_topics == 25
    assert cfg.inference_mode == "gibbs"  # reference int encoding
    assert cfg.alpha_alpha == 0.3 and cfg.training_iterations == 7
    assert cfg.bucket_sizes == (32, 64, 256)
    assert args.device is None  # the card by default
    # Same parser defaults as the JAX package's.
    from pylda_tpu.cli.train import build_parser as jax_parser

    argv = ["--input_directory=/x", "--output_directory=/y",
            "--number_of_topics=20"]
    ours = vars(build_parser().parse_args(argv))
    assert ours.pop("device") is None
    assert ours == vars(jax_parser().parse_args(argv))
    cfg = config_from_args(build_parser().parse_args(argv))
    assert cfg.alpha_alpha is None and cfg.resolved_alpha() == 1.0 / 20
    assert cfg.resolved_eta(100) == 1.0 / 100


def test_train_then_test_cli(corpus_dir, tmp_path):
    out = str(tmp_path / "out")
    rc = _train(corpus_dir, out, "--training_iterations=4",
                "--snapshot_interval=2", "--inner_iterations=20", "--seed=1",
                "--dump_gamma")
    assert rc == 0
    runs = glob.glob(os.path.join(out, "*", "*"))
    assert len(runs) == 1
    run = runs[0]
    assert "-lda-I4-S2-K5-" in run and run.endswith("-imvb")
    for f in ["exp_beta-2", "exp_beta-4", "model-2", "model-4",
              "gamma-2", "gamma-4", "metrics.jsonl"]:
        assert os.path.exists(os.path.join(run, f)), f
    assert np.loadtxt(os.path.join(run, "gamma-4")).shape == (120, 5)
    events = [json.loads(line)["event"]
              for line in open(os.path.join(run, "metrics.jsonl"))]
    assert events.count("iteration") == 4 and events[-1] == "final"

    lines = open(os.path.join(run, "exp_beta-4")).read().splitlines()
    assert lines[0] == "==========\t0\t=========="
    probs = []
    for ln in lines[1:]:
        if ln.startswith("=========="):
            break
        _, p = ln.split("\t")
        probs.append(float(p))
    assert probs == sorted(probs, reverse=True) and len(probs) == 50

    rc = run_launch_test([
        f"--model={os.path.join(run, 'model-4')}",
        f"--input_directory={corpus_dir}",
        f"--output_file={tmp_path / 'gamma.out'}", "--point_estimate", CPU,
    ])
    assert rc == 0
    gamma = np.loadtxt(tmp_path / "gamma.out")
    assert gamma.shape == (30, 5)
    assert (gamma > 0).all()


def test_infer_cli_serving(corpus_dir, tmp_path):
    out = str(tmp_path / "out_infer")
    _train(corpus_dir, out, "--training_iterations=3",
           "--snapshot_interval=3", "--inner_iterations=15", "--seed=1")
    model = glob.glob(os.path.join(out, "*", "*", "model-3"))[0]
    docs = tmp_path / "new_docs.txt"
    docs.write_text("government election vote\nrain snow storm weather\n")
    result = tmp_path / "mixtures.tsv"
    rc = infer_main([f"--model={model}", f"--input={docs}",
                     f"--output={result}", "--top_topics=3", CPU])
    assert rc == 0
    lines = result.read_text().strip().splitlines()
    assert len(lines) == 2
    for ln in lines:
        pairs = [p.split(":") for p in ln.split("\t")]
        assert len(pairs) == 3
        probs = [float(p[1]) for p in pairs]
        assert all(0 <= p <= 1 for p in probs)
        assert probs == sorted(probs, reverse=True)
    rc = infer_main([f"--model={model}", f"--input={docs}",
                     f"--output={result}", "--full", CPU])
    theta = np.loadtxt(result)
    assert theta.shape == (2, 5)
    np.testing.assert_allclose(theta.sum(axis=1), 1.0, rtol=1e-4)


def test_train_cli_resume(corpus_dir, tmp_path):
    out = str(tmp_path / "out_resume")
    _train(corpus_dir, out, "--training_iterations=2",
           "--snapshot_interval=2", "--inner_iterations=20", "--seed=1")
    model = glob.glob(os.path.join(out, "*", "*", "model-2"))[0]
    rc = _train(corpus_dir, out, "--training_iterations=4",
                "--snapshot_interval=2", "--inner_iterations=20",
                f"--resume={model}", "--async_checkpoint")
    assert rc == 0
    (final,) = glob.glob(os.path.join(out, "*", "*", "model-4"))
    assert int(np.load(final)["step"]) == 4


def test_learning_many_matches_learning_loop(corpus_dir):
    train, _, vocab = load_input_directory(corpus_dir)
    kw = dict(number_of_topics=5, inference_mode="vb", inner_iterations=15,
              hyper_parameter_optimize_interval=2, seed=3)
    a = VariationalBayes(LDAConfig(**kw), device="cpu")
    a.initialize(train, vocab)
    ll_loop = [a.learning() for _ in range(4)]
    b = VariationalBayes(LDAConfig(**kw), device="cpu")
    b.initialize(train, vocab)
    np.testing.assert_allclose(b.learning_many(4), ll_loop, rtol=1e-6)
    np.testing.assert_allclose(a.state.alpha.numpy(), b.state.alpha.numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize(
    "flag",
    ["--mesh=2,1", "--shard_vocab", "--shard_topics",
     "--coordinator_address=localhost:1", "--num_processes=2",
     "--process_id=0", "--process_sharded_input", "--streaming_input",
     "--profile_dir=/x", "--roofline", "--phase_timing",
     "--tensorboard_dir=/x", "--coherence", "--checkpoint_format=orbax"],
)
def test_unported_train_flags_exit(corpus_dir, tmp_path, flag):
    with pytest.raises(SystemExit, match="ROADMAP.md Queue 1 item"):
        _train(corpus_dir, str(tmp_path / "o"), flag)
    assert not (tmp_path / "o").exists()


def test_unported_test_flag_and_default_device(corpus_dir, tmp_path,
                                               monkeypatch):
    with pytest.raises(SystemExit, match="ROADMAP.md Queue 1 item 13"):
        run_launch_test(["--model=/x", f"--input_directory={corpus_dir}",
                   "--coherence"])
    # Without --device the CLIs run on the card, and raise without one.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main([f"--input_directory={corpus_dir}",
                    f"--output_directory={tmp_path}", "--number_of_topics=5"])


# -- files across packages ------------------------------------------------------


@pytest.fixture(scope="module")
def jax_trained(corpus_dir):
    """The JAX engine after 3 iterations on the corpus directory."""
    train, test, vocab = jax_load(corpus_dir)
    eng = JaxVB(JaxConfig(number_of_topics=5, inner_iterations=20, seed=2))
    eng.initialize(train, vocab)
    eng.learning_many(3)
    return eng, test


def test_model_file_loads_in_both_packages(corpus_dir, jax_trained, tmp_path):
    """port model -> JAX load, and JAX model -> port load: the same
    held-out perplexity."""
    _, test, vocab = load_input_directory(corpus_dir)
    jax_eng, test_j = jax_trained
    jax_eng.save(str(tmp_path / "model-jax"))
    ours = Inferencer.load(str(tmp_path / "model-jax"), device="cpu")
    assert ours._counter == 3 and ours._vocab.types == vocab.types
    assert ours.perplexity(test) == pytest.approx(jax_eng.perplexity(test_j),
                                                  rel=1e-4)
    ours.save(str(tmp_path / "model-port"), async_write=True)
    ours.wait_for_checkpoint()
    theirs = JaxInferencer.load(str(tmp_path / "model-port"))
    assert theirs._counter == 3
    np.testing.assert_array_equal(np.asarray(theirs.state.lam),
                                  ours.state.lam.numpy())
    assert theirs.perplexity(test_j) == pytest.approx(ours.perplexity(test),
                                                      rel=1e-4)


def test_export_beta_same_bytes(corpus_dir, jax_trained, tmp_path):
    train, _, vocab = load_input_directory(corpus_dir)
    jax_eng, _ = jax_trained
    ours = VariationalBayes(LDAConfig(number_of_topics=5), device="cpu")
    ours.initialize(train, vocab)
    st = jax_eng.state
    ours.state = state_from_numpy(
        {"lam": np.asarray(st.lam), "alpha": np.asarray(st.alpha),
         "eta": np.asarray(st.eta), "step": np.asarray(st.step)},
        device="cpu",
    )
    jax_eng.export_beta(str(tmp_path / "exp_beta-jax"))
    ours.export_beta(str(tmp_path / "exp_beta-port"))
    want = (tmp_path / "exp_beta-jax").read_bytes()
    assert (tmp_path / "exp_beta-port").read_bytes() == want
    assert want.count(b"==========\t") == 5


def test_model_file_refusals(corpus_dir, tmp_path):
    train, _, vocab = load_input_directory(corpus_dir)
    eng = VariationalBayes(LDAConfig(number_of_topics=5), device="cpu")
    eng.initialize(train, vocab)
    with pytest.raises(NotImplementedError, match="JAX-only"):
        eng.save(str(tmp_path / "m"), format="orbax")
    (tmp_path / "orbax_dir").mkdir()
    with pytest.raises(NotImplementedError, match="orbax"):
        Inferencer.load(str(tmp_path / "orbax_dir"), device="cpu")

    def rewrite(path, **changes):
        blobs = dict(np.load(path))
        meta = json.loads(bytes(blobs["meta_json"].tobytes()).decode())
        meta["config"].update(changes)
        blobs["meta_json"] = np.frombuffer(json.dumps(meta).encode(),
                                           dtype=np.uint8)
        with open(path, "wb") as f:
            np.savez(f, **blobs)

    path = str(tmp_path / "model-1")
    eng.save(path)
    rewrite(path, inference_mode="future_engine")
    with pytest.raises(ValueError, match="newer version"):
        Inferencer.load(path, device="cpu")
    eng.save(path)
    rewrite(path, compute_dtype="float8")
    with pytest.raises(ValueError, match="invalid config") as info:
        Inferencer.load(path, device="cpu")
    assert "newer" not in str(info.value)
    eng.save(path)
    rewrite(path, some_new_field=1)
    with pytest.warns(UserWarning, match="some_new_field"):
        loaded = Inferencer.load(path, corpus=train, device="cpu")
    assert loaded.gamma.shape == (120, 5)  # prepared for training


def test_bundled_corpus_matches_jax():
    """data/de-news-tiny parses to the same corpus in both packages."""
    ours = load_input_directory(bundled_corpus_dir())
    theirs = jax_load(bundled_corpus_dir())
    assert ours[2].types == theirs[2].types
    for c, c_j in zip(ours[:2], theirs[:2]):
        assert c.num_docs == c_j.num_docs and c.num_tokens == c_j.num_tokens
        for d in range(c.num_docs):
            np.testing.assert_array_equal(c.docs[d], np.asarray(c_j.docs[d]))
            for a, b in zip(c.doc_unique(d), c_j.doc_unique(d)):
                np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(NotImplementedError, match="item 13"):
        load_input_directory(bundled_corpus_dir(), streaming=True)
    with pytest.raises(NotImplementedError, match="item 12"):
        load_input_directory(bundled_corpus_dir(), process_index=1,
                             process_count=2)


def test_make_denews_tiny_matches_jax(tmp_path):
    make_denews_tiny(str(tmp_path / "a"), num_train=20, num_test=5)
    jax_make_denews(str(tmp_path / "b"), num_train=20, num_test=5)
    for name in ("doc.dat", "test.dat", "voc.dat"):
        assert ((tmp_path / "a" / name).read_bytes()
                == (tmp_path / "b" / name).read_bytes())
