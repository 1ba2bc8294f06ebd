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


@pytest.mark.parametrize("flags, match", [
    # Both ways of splitting lambda at once: the config's error.
    (["--shard_vocab", "--shard_topics"], "exclusive"),
    (["--checkpoint_format=orbax"], "ROADMAP.md Queue 1 item 6"),
])
def test_unported_train_flags_exit(corpus_dir, tmp_path, flags, match):
    with pytest.raises(SystemExit, match=match):
        _train(corpus_dir, str(tmp_path / "o"), *flags)
    assert not (tmp_path / "o").exists()


@pytest.mark.parametrize("flags, match", [
    # One process a card: a data axis of 2 needs 2 processes.
    (["--mesh=2,1"], "launch 2 processes"),
    # A model axis of 2 is two ranks too.
    (["--mesh=1,2"], "launch 2 processes"),
    # A coordinator without both process flags would wait forever.
    (["--coordinator_address=localhost:1"], "--num_processes"),
    (["--coordinator_address=localhost:1", "--num_processes=2"],
     "--process_id"),
])
def test_process_flags_exit(corpus_dir, tmp_path, flags, match):
    with pytest.raises(SystemExit, match=match):
        _train(corpus_dir, str(tmp_path / "o"), *flags)
    assert not (tmp_path / "o").exists()


@pytest.mark.parametrize("flags", [
    ["--num_processes=2"], ["--process_id=0"], ["--process_sharded_input"],
    ["--mesh=1,1"], ["--process_sharded_input", "--mesh=1,1"],
])
def test_process_flags_in_one_process(corpus_dir, tmp_path, flags):
    """--num_processes or --process_id without a coordinator do nothing
    (as in the JAX package); --process_sharded_input in one process loads
    the whole corpus, and --mesh=1,1 is the one-process mesh: each run's
    model-2 equals the plain run's."""
    _train(corpus_dir, str(tmp_path / "a"), "--training_iterations=2")
    _train(corpus_dir, str(tmp_path / "b"), "--training_iterations=2", *flags)
    (a,), (b,) = (glob.glob(str(tmp_path / x / "*" / "*" / "model-2"))
                  for x in "ab")
    for k in ("lam", "alpha", "eta"):
        np.testing.assert_array_equal(np.load(a)[k], np.load(b)[k])


def test_unported_test_flag_and_default_device(corpus_dir, tmp_path,
                                               monkeypatch):
    # The test CLI has no unported flag left (--coherence is ported).
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


def test_bundled_corpus_matches_jax(tmp_path):
    """data/de-news-tiny parses to the same corpus in both packages (in
    RAM, and, from a copy, disk-backed)."""
    ours = load_input_directory(bundled_corpus_dir())
    theirs = jax_load(bundled_corpus_dir())
    assert ours[2].types == theirs[2].types
    for c, c_j in zip(ours[:2], theirs[:2]):
        assert c.num_docs == c_j.num_docs and c.num_tokens == c_j.num_tokens
        for d in range(c.num_docs):
            np.testing.assert_array_equal(c.docs[d], np.asarray(c_j.docs[d]))
            for a, b in zip(c.doc_unique(d), c_j.doc_unique(d)):
                np.testing.assert_array_equal(a, np.asarray(b))
    for name in ("doc.dat", "voc.dat", "test.dat"):
        with open(os.path.join(bundled_corpus_dir(), name), "rb") as f:
            (tmp_path / name).write_bytes(f.read())
    stream = load_input_directory(str(tmp_path), streaming=True)[0]
    theirs_stream = jax_load(str(tmp_path), streaming=True)[0]
    assert stream.num_tokens == theirs_stream.num_tokens == ours[0].num_tokens
    for d in range(stream.num_docs):
        np.testing.assert_array_equal(stream.subset([d]).docs[0],
                                      ours[0].docs[d])
    # Process-local blocks: each process's block against the JAX
    # loader's, the held-out documents whole on every process.
    for p in range(3):
        block, held, _ = load_input_directory(
            bundled_corpus_dir(), process_index=p, process_count=3)
        block_j, held_j, _ = jax_load(bundled_corpus_dir(), process_index=p,
                                      process_count=3)
        assert block.process_local and block_j.process_local
        assert (block.num_docs, block.global_num_docs,
                block.global_doc_offset) == (
            block_j.num_docs, block_j.global_num_docs,
            block_j.global_doc_offset)
        assert block.global_num_docs == ours[0].num_docs
        for d in range(block.num_docs):
            np.testing.assert_array_equal(
                block.docs[d], ours[0].docs[block.global_doc_offset + d])
        assert held.num_docs == held_j.num_docs == ours[1].num_docs


def test_make_denews_tiny_matches_jax(tmp_path):
    make_denews_tiny(str(tmp_path / "a"), num_train=20, num_test=5)
    jax_make_denews(str(tmp_path / "b"), num_train=20, num_test=5)
    for name in ("doc.dat", "test.dat", "voc.dat"):
        assert ((tmp_path / "a" / name).read_bytes()
                == (tmp_path / "b" / name).read_bytes())


# -- the sampling engines through the CLIs ---------------------------------------

# The JAX CLI's final held-out perplexity on data/de-news-tiny (K=10, 10
# iterations, snapshots every 5, 5 kept sweeps after 3 burn-in) over seeds
# 0-19 (`scripts/sampling_seed_spread.py cli`, CPU): the band the port's
# CLI is held to.  Over seeds 0-2 alone the JAX CLI spans 59.89-62.40 (gibbs) and
# 55.53-55.58 (hybrid), which understates the spread: both packages'
# chains settle in one of several modes on this corpus (the JAX hybrid
# CLI's 20 values sort into 55.39-55.58 and 61.12-70.71, the port's into
# 55.30-56.33 and 60.05-66.16), and the port's seed-0 hybrid run (62.47)
# lies in the second.
SAMPLING_CLI_BAND = {"gibbs": (50.3264, 70.8669),
                     "hybrid": (55.3931, 70.7112)}
SAMPLING_CLI_ARGS = ["--number_of_topics=10", "--training_iterations=10",
                     "--snapshot_interval=5", "--number_of_samples=5",
                     "--burn_in_sweeps=3", "--seed=0"]


def _final_perplexity(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f][-1]["perplexity"]


@pytest.mark.parametrize("mode", ["gibbs", "hybrid"])
def test_sampling_modes_train_test_infer_like_jax(mode, tmp_path):
    from pylda_tpu.cli.train import main as jax_train_main

    corpus_dir = bundled_corpus_dir()
    runs = {}
    for who, main, extra in (("port", train_main, [CPU, "--dump_gamma"]),
                             ("jax", jax_train_main, ["--dump_gamma"])):
        rc = main([f"--input_directory={corpus_dir}",
                   f"--output_directory={tmp_path / who}",
                   f"--inference_mode={mode}", *SAMPLING_CLI_ARGS, *extra])
        assert rc in (0, None)
        (runs[who],) = glob.glob(str(tmp_path / who / "*" / "*"))
        assert runs[who].endswith(f"-im{mode}")
    files = {who: sorted(os.listdir(run)) for who, run in runs.items()}
    assert files["port"] == files["jax"]
    for f in ("exp_beta-5", "exp_beta-10", "model-5", "model-10", "gamma-5",
              "gamma-10", "metrics.jsonl"):
        assert f in files["port"], f
    assert np.loadtxt(os.path.join(runs["port"], "gamma-10")).shape == (400,
                                                                        10)
    lo, hi = SAMPLING_CLI_BAND[mode]
    assert lo <= _final_perplexity(runs["port"]) <= hi

    # test: the port reads its own model file and the JAX CLI's.
    for who in ("port", "jax"):
        out = tmp_path / f"gamma.{who}"
        rc = run_launch_test([f"--model={os.path.join(runs[who], 'model-10')}",
                              f"--input_directory={corpus_dir}",
                              f"--output_file={out}", "--point_estimate",
                              CPU])
        gamma = np.loadtxt(out)
        assert rc == 0 and gamma.shape == (100, 10) and (gamma > 0).all()
    theirs = JaxInferencer.load(os.path.join(runs["port"], "model-10"))
    assert type(theirs).__name__ == {"gibbs": "MonteCarlo",
                                     "hybrid": "Hybrid"}[mode]
    assert np.isfinite(theirs.perplexity(jax_load(corpus_dir)[1]))

    docs = tmp_path / "docs.txt"
    docs.write_text("government election vote\nrain snow storm weather\n")
    mix = tmp_path / "mix.tsv"
    rc = infer_main([f"--model={os.path.join(runs['port'], 'model-10')}",
                     f"--input={docs}", f"--output={mix}", "--full", CPU])
    theta = np.loadtxt(mix)
    assert rc == 0 and theta.shape == (2, 10)
    np.testing.assert_allclose(theta.sum(axis=1), 1.0, rtol=1e-4)


# -- observability flags ----------------------------------------------------------


def _events(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_observability_flags_on_the_bundled_corpus(tmp_path):
    """--phase_timing --roofline --coherence --tensorboard_dir
    --profile_dir on data/de-news-tiny, then test --coherence."""
    out, tb, prof = (str(tmp_path / d) for d in ("out", "tb", "prof"))
    assert train_main([
        f"--input_directory={bundled_corpus_dir()}", f"--output_directory={out}",
        "--number_of_topics=10", "--training_iterations=4",
        "--snapshot_interval=2", "--inner_iterations=20", CPU,
        "--phase_timing", "--roofline", "--coherence",
        f"--tensorboard_dir={tb}", f"--profile_dir={prof}",
    ]) == 0
    run = glob.glob(os.path.join(out, "*", "*"))[0]
    events = _events(run)
    by = {}
    for e in events:
        by.setdefault(e["event"], []).append(e)
    assert {"phase_timing", "roofline", "roofline_measured",
            "coherence"} <= set(by)
    times = by["phase_timing"][0]
    assert {"estep_total_ms", "mstep_ms", "bound_ms",
            "hyper_newton_ms"} <= set(times)
    assert {e["phase"] for e in by["roofline"]} == {
        "sweeps_per_sweep", "sstats", "elog_beta"}
    measured = {e["phase"]: e for e in by["roofline_measured"]}
    assert set(measured) == {"iteration", "sweep_counts"}
    assert measured["iteration"]["bound_ms"] > 0
    assert [e["iteration"] for e in by["coherence"]] == [2, 4]
    assert all(e["top_n"] == 10 and e["mean_umass"] < 0
               for e in by["coherence"])
    # TensorBoard's event file, or the event saying why there is none.
    assert (glob.glob(os.path.join(tb, "events.out.tfevents.*"))
            or "tensorboard_unavailable" in by)
    with open(os.path.join(prof, "train_trace.json")) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    assert events[-1]["event"] == "final"

    assert run_launch_test([f"--model={os.path.join(run, 'model-4')}",
                            f"--input_directory={bundled_corpus_dir()}",
                            f"--output_file={tmp_path / 'g'}", CPU,
                            "--coherence", "--coherence_top_n=7"]) == 0


def test_test_cli_coherence_event(corpus_dir, tmp_path, capsys):
    out = str(tmp_path / "out")
    assert _train(corpus_dir, out, "--training_iterations=2",
                  "--snapshot_interval=2", "--inner_iterations=10") == 0
    model = glob.glob(os.path.join(out, "*", "*", "model-2"))[0]
    capsys.readouterr()
    assert run_launch_test([f"--model={model}",
                            f"--input_directory={corpus_dir}", CPU,
                            f"--output_file={tmp_path / 'g'}",
                            "--coherence", "--coherence_top_n=4"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("event=coherence")]
    assert len(line) == 1 and "top_n=4" in line[0]
    per = json.loads(line[0].split("per_topic=")[1].split(" wall_time")[0])
    assert len(per) == 5


@pytest.mark.parametrize("mode", ["vb", "svi", "gibbs", "hybrid"])
def test_phase_timing_and_roofline_flags_every_engine(corpus_dir, tmp_path,
                                                      mode):
    out = str(tmp_path / "out")
    assert _train(corpus_dir, out, f"--inference_mode={mode}",
                  "--training_iterations=2", "--snapshot_interval=2",
                  "--inner_iterations=10", "--number_of_samples=2",
                  "--burn_in_sweeps=1", "--batch_size=40",
                  "--phase_timing", "--roofline") == 0
    events = _events(glob.glob(os.path.join(out, "*", "*"))[0])
    times = [e for e in events if e["event"] == "phase_timing"]
    assert len(times) == 1
    assert all(v > 0 for k, v in times[0].items()
               if k.endswith("_ms"))
    measured = {e["phase"] for e in events
                if e["event"] == "roofline_measured"}
    want = {"vb": {"iteration", "sweep_counts"},
            "hybrid": {"iteration", "sweep_counts"},
            "svi": {"minibatch", "sweep_counts"},
            "gibbs": {"sweep", "joint_likelihood"}}[mode]
    assert measured == want
    # The cost model at start: the VB family (as in the JAX CLI).
    assert any(e["event"] == "roofline" for e in events) == (mode != "gibbs")


def test_tensorboard_unavailable_is_logged(corpus_dir, tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    out = str(tmp_path / "out")
    assert _train(corpus_dir, out, "--training_iterations=1",
                  "--snapshot_interval=1", "--inner_iterations=5",
                  f"--tensorboard_dir={tmp_path / 'tb'}") == 0
    events = _events(glob.glob(os.path.join(out, "*", "*"))[0])
    assert [e["event"] for e in events].count("tensorboard_unavailable") == 1
    assert events[-1]["event"] == "final"
