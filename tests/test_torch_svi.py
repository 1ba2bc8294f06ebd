"""The port's StochasticVariationalBayes against pylda_tpu's (CPU).

Both engines start from the same lambda (numpy, seeded) with
gamma_init="ones" and draw the same minibatch schedule
(``minibatch_indices`` with epoch seed ``counter * 100003 + seed``), so
the only differences are f32 summation order and exit timing.
Tolerances: lambda rtol 1e-4 with atol 1e-4 and alpha/eta rtol 1e-4 (as
for batch VB, tests/test_torch_vb.py); the epoch estimates rel 1e-4;
gamma per row at the fixed point's own tolerance, rtol 5e-4 with atol
5e-4.  In float64 against the float64 oracle ``OracleSVI`` at pinned
sweeps (threshold 0): lambda rel err < 1e-8, estimates < 1e-6, the bounds
of tests/test_svi_f64.py.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from pylda_tpu.cli.train import main as jax_train_main
from pylda_tpu.corpus.synthetic import synthetic_corpus as jax_synthetic
from pylda_tpu.models import Inferencer as JaxInferencer
from pylda_tpu.models import StochasticVariationalBayes as JaxSVI
from pylda_tpu.models import layouts as jax_layouts
from pylda_tpu.oracle import OracleSVI
from pylda_tpu.utils.config import LDAConfig as JaxConfig
from pylda_tpu_torch.cli.train import main as train_main
from pylda_tpu_torch.corpus.datasets import bundled_corpus_dir, load_input_directory
from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.models import Inferencer, StochasticVariationalBayes
from pylda_tpu_torch.models import base as base_mod
from pylda_tpu_torch.models import layouts
from pylda_tpu_torch.utils.config import LDAConfig

K, V, D = 5, 150, 200
RTOL = 1e-4
LAM_ATOL = 1e-4
GAMMA_TOL = 5e-4
# 200 docs in minibatches of 64: the last one holds 8 documents and pads.
CFG = dict(number_of_topics=K, inference_mode="svi", alpha_alpha=0.2,
           alpha_beta=0.02, inner_iterations=30, doc_pad_multiple=8,
           batch_size=64, tau0=16.0, kappa=0.7, seed=0,
           hyper_parameter_optimize_interval=2)
RAGGED = dict(dense_vocab_threshold=0, bucket_sizes=(32, 64, 128))
LAYOUTS = {"ragged": RAGGED, "dense": {}}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def data():
    kw = dict(num_docs=D, num_topics=K, num_types=V, mean_doc_length=40.0,
              seed=4)
    return dict(corpus=synthetic_corpus(**kw)[0],
                corpus_j=jax_synthetic(**kw)[0],
                lam0=np.random.default_rng(1).gamma(100.0, 0.01, (K, V)))


def _ours(data, **extra):
    eng = StochasticVariationalBayes(LDAConfig(**{**CFG, **extra}),
                                     device="cpu")
    eng.initialize(data["corpus"], lam_init=data["lam0"])
    return eng


def _theirs(data, **extra):
    eng = JaxSVI(JaxConfig(**{**CFG, **extra}))
    eng.initialize(data["corpus_j"], lam_init=data["lam0"])
    return eng


def _assert_state_close(ours, theirs):
    for f in ("lam", "alpha", "eta"):
        np.testing.assert_allclose(
            getattr(ours.state, f).numpy(),
            np.asarray(getattr(theirs.state, f)), rtol=RTOL,
            atol=LAM_ATOL if f == "lam" else 0.0, err_msg=f,
        )


# -- (a) layout helpers ---------------------------------------------------------


@pytest.mark.parametrize(
    "seed,docs,types,length,extra",
    [(4, 200, 150, 40.0, RAGGED),
     (0, 300, 6000, 60.0, {}),
     (3, 500, 2000, 150.0, dict(batch_size=100, doc_pad_multiple=16)),
     (7, 64, 900, 400.0, dict(bucket_sizes=(16, 32), batch_size=1000))],
    ids=["fixed_sizes", "auto_sizes", "long_docs", "chunked_rows"],
)
def test_svi_layout_helpers_match_jax(seed, docs, types, length, extra):
    kw = dict(num_docs=docs, num_topics=8, num_types=types,
              mean_doc_length=length, seed=seed)
    ours, theirs = synthetic_corpus(**kw)[0], jax_synthetic(**kw)[0]
    counts = layouts.unique_counts_of(ours)
    for align, cap in ((16, 2048), (16, 40), (8, 64)):
        np.testing.assert_array_equal(
            layouts.aligned_width_histogram(counts, align, cap),
            jax_layouts.aligned_width_histogram(counts, align, cap))
    cfg = {**CFG, **extra}
    caps = layouts.plan_svi_ragged_geometry(ours, LDAConfig(**cfg),
                                            cfg["batch_size"])
    assert caps and caps == jax_layouts.plan_svi_ragged_geometry(
        theirs, JaxConfig(**cfg), cfg["batch_size"])
    hist = ours.ragged_row_histogram(sorted(caps))
    for f in (0.01, 0.3, 1.0):
        expected = {s: hist[s] * f for s in caps}
        assert (layouts.svi_capacities_from_expected(caps, expected, 8)
                == jax_layouts.svi_capacities_from_expected(caps, expected, 8))


# -- (b) the engine against JAX's --------------------------------------------------


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def trained(request, data):
    """learning() x2, then learning_many(2), in each package."""
    extra = LAYOUTS[request.param]
    ours, theirs = _ours(data, **extra), _theirs(data, **extra)
    assert ours._device_rows is not None
    e_ours = [ours.learning() for _ in range(2)]
    g_ours = ours.gamma
    e_theirs = [theirs.learning() for _ in range(2)]
    g_theirs = np.asarray(theirs.gamma)
    e_ours += ours.learning_many(2)
    e_theirs += theirs.learning_many(2)
    return dict(layout=request.param, ours=ours, theirs=theirs,
                e_ours=e_ours, e_theirs=e_theirs, g_ours=g_ours,
                g_theirs=g_theirs)


def test_svi_learning_matches_jax(trained):
    ours, theirs = trained["ours"], trained["theirs"]
    np.testing.assert_allclose(trained["e_ours"], trained["e_theirs"],
                               rtol=RTOL)
    _assert_state_close(ours, theirs)
    assert ours._t == theirs._t == 16
    assert ours._counter == theirs._counter == 4
    # After learning(): the minibatches' own gammas.
    np.testing.assert_allclose(trained["g_ours"], trained["g_theirs"],
                               rtol=GAMMA_TOL, atol=GAMMA_TOL)


def test_svi_lazy_gamma_matches_jax(trained):
    """After learning_many: one rho = 0 epoch at the final state."""
    ours, theirs = trained["ours"], trained["theirs"]
    lam = ours.state.lam.clone()
    g = ours.gamma
    assert g.shape == (D, K) and np.isfinite(g).all()
    np.testing.assert_allclose(g, np.asarray(theirs.gamma), rtol=GAMMA_TOL,
                               atol=GAMMA_TOL)
    assert torch.equal(ours.state.lam, lam) and ours._t == 16


def test_svi_inference_matches_jax(trained, data):
    ours, theirs = trained["ours"], trained["theirs"]
    assert ours.perplexity(data["corpus"]) == pytest.approx(
        theirs.perplexity(data["corpus_j"]), rel=RTOL)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_svi_learning_many_equals_learning_loop(data, layout):
    a, b = _ours(data, **LAYOUTS[layout]), _ours(data, **LAYOUTS[layout])
    assert [a.learning() for _ in range(3)] == b.learning_many(3)
    assert torch.equal(a.state.lam, b.state.lam)
    assert torch.equal(a.state.alpha, b.state.alpha)


def test_svi_k300_ragged_matches_jax():
    """K = 300 (the CUDA kernels' wide range) on the ragged layout at
    pinned sweeps (threshold 0: at K = 300 a row at the threshold freezes
    a sweep apart in the two packages often enough to move rare-word
    lambda entries by ~1e-3): learning() x2 then learning_many(1),
    estimates rel 1e-4, lambda rtol 1e-4 + atol 1e-4, alpha and eta rtol
    1e-4."""
    kw = dict(num_docs=96, num_topics=300, num_types=400,
              mean_doc_length=30.0, seed=2)
    lam0 = np.random.default_rng(3).gamma(100.0, 0.01, (300, 400))
    extra = dict(RAGGED, number_of_topics=300, batch_size=32,
                 inner_iterations=12, convergence_threshold=0.0)
    ours = StochasticVariationalBayes(LDAConfig(**{**CFG, **extra}),
                                      device="cpu")
    ours.initialize(synthetic_corpus(**kw)[0], lam_init=lam0)
    theirs = JaxSVI(JaxConfig(**{**CFG, **extra}))
    theirs.initialize(jax_synthetic(**kw)[0], lam_init=lam0)
    assert ours._device_rows is not None
    e_ours = [ours.learning() for _ in range(2)] + ours.learning_many(1)
    e_theirs = [theirs.learning() for _ in range(2)] + theirs.learning_many(1)
    np.testing.assert_allclose(e_ours, e_theirs, rtol=RTOL)
    _assert_state_close(ours, theirs)


# -- (c) float64 against the oracle ----------------------------------------------


def test_svi_matches_oracle_in_f64():
    kw = dict(num_docs=96, num_topics=5, num_types=120, mean_doc_length=40.0,
              seed=7)
    lam0 = np.random.default_rng(42).gamma(100.0, 0.01, size=(5, 120))
    seed = 3
    eng = StochasticVariationalBayes(LDAConfig(
        number_of_topics=5, inference_mode="svi", seed=seed, batch_size=32,
        tau0=16.0, kappa=0.7, alpha_alpha=0.2, alpha_beta=0.01,
        dtype="float64", inner_iterations=40, convergence_threshold=0.0,
    ), device="cpu")
    eng.initialize(synthetic_corpus(**kw)[0], lam_init=lam0)
    ests = eng.learning_many(3)
    ora = OracleSVI(jax_synthetic(**kw)[0], num_topics=5, alpha=0.2,
                    eta=0.01, batch_size=32, tau0=16.0, kappa=0.7, seed=0,
                    gamma_init="ones", inner_iterations=40,
                    convergence_threshold=0.0)
    ora.lam = lam0.copy()
    ests_ora = [ora.learning(e * 100003 + seed) for e in range(3)]
    assert eng.state.lam.dtype == torch.float64
    err = np.abs(eng.state.lam.numpy() - ora.lam).max() / np.abs(ora.lam).max()
    assert err < 1e-8, err
    np.testing.assert_allclose(ests, ests_ora, rtol=1e-6)


# -- (d) the host-packed fallback ------------------------------------------------------


def test_svi_overflow_fallback_equals_per_batch_layout(data):
    """A minibatch that overflows the device-resident geometry is packed
    on the host; one that overflows the geometry there too takes
    per-batch shapes.  Starved capacities send every minibatch down both
    fallbacks, which must give the same bits as an engine planned with
    per-batch shapes only, and the device-resident path must give the
    same bits as host packing in the same geometry."""
    starved = _ours(data, **RAGGED)
    for rows in starved._device_rows:
        rows.cap = 8
    starved._svi_geometry = {s: 8 for s in starved._svi_geometry}
    assert starved._epoch_index_stacks(0, 0) is None
    per_batch = _ours(data, **RAGGED)
    per_batch._svi_geometry = per_batch._device_rows = None
    a = [starved.learning() for _ in range(2)] + starved.learning_many(2)
    b = [per_batch.learning() for _ in range(2)] + per_batch.learning_many(2)
    assert a == b
    assert torch.equal(starved.state.lam, per_batch.state.lam)
    np.testing.assert_array_equal(starved.gamma, per_batch.gamma)

    resident = _ours(data, **RAGGED)
    host = _ours(data, svi_device_rows_budget_mb=0, **RAGGED)
    assert host._device_rows is None and host._svi_geometry is not None
    c = [resident.learning() for _ in range(3)]
    assert c == [host.learning() for _ in range(3)]
    assert torch.equal(resident.state.lam, host.state.lam)
    # Other bucket shapes move only the fixed points' exit timing.
    np.testing.assert_allclose(a[:2], c[:2], rtol=1e-5)


# -- (e) model files -----------------------------------------------------------------


def test_svi_model_file_loads_in_both_packages(data, tmp_path):
    ours = _ours(data, **RAGGED)
    ours.learning_many(2)
    ours.save(str(tmp_path / "model-port"))
    assert int(np.load(tmp_path / "model-port")["extra_t"]) == 8
    theirs = JaxInferencer.load(str(tmp_path / "model-port"),
                                corpus=data["corpus_j"])
    assert type(theirs).__name__ == "StochasticVariationalBayes"
    assert theirs._t == 8 and theirs._counter == 2
    theirs.learning()
    theirs.save(str(tmp_path / "model-jax"))
    back = Inferencer.load(str(tmp_path / "model-jax"),
                           corpus=data["corpus"], device="cpu")
    assert isinstance(back, StochasticVariationalBayes)
    assert back._t == 12 and back._counter == 3
    ours.learning()
    np.testing.assert_allclose(back.state.lam.numpy(), ours.state.lam.numpy(),
                               rtol=RTOL, atol=LAM_ATOL)
    assert back.learning() == pytest.approx(theirs.learning(), rel=RTOL)
    assert back._t == theirs._t == 16


# -- (f) routes not ported ----------------------------------------------------------------


def test_svi_unported_routes_raise(data, monkeypatch):
    """A process-local corpus in one process trains like a whole one;
    across two processes without a mesh it raises the JAX engine's
    ValueError.  sstats_mode="scatter" and a counts matrix over the budget
    (item 4, ported) now take the scatter route: no counts matrix;
    phase_timings (item 7, ported) times a minibatch."""
    for extra in (dict(sstats_mode="scatter"),
                  dict(sstats_dense_total_budget_mb=0)):
        eng = _ours(data, **RAGGED, **extra)
        assert eng._mb_sstats is None and eng._device_rows is not None
        assert np.isfinite(eng.learning())
    eng = StochasticVariationalBayes(LDAConfig(**CFG), device="cpu")
    local = synthetic_corpus(num_docs=20, num_topics=K, num_types=V,
                             mean_doc_length=10.0, seed=1)[0]
    lam0 = np.random.default_rng(4).gamma(100.0, 0.01, (K, V))
    eng.initialize(local, lam_init=lam0)
    want = eng.learning()
    local.process_local = True
    eng = StochasticVariationalBayes(LDAConfig(**CFG), device="cpu")
    eng.initialize(local, lam_init=lam0)
    assert eng.learning() == want
    monkeypatch.setattr(base_mod, "world", lambda: (0, 2))
    with pytest.raises(ValueError, match="requires a mesh"):
        eng.initialize(local)
    assert set(_ours(data).phase_timings()) == {
        "svi_minibatch_ms", "minibatches_per_epoch"}


# -- (g) the CLI ---------------------------------------------------------------------------


def test_svi_cli_matches_jax_cli(tmp_path):
    """train on the bundled corpus in each package, both resuming one
    initial SVI model file (the packages draw their random lambda from
    different generators): the same files, and held-out perplexity
    within 1%."""
    train, _, vocab = load_input_directory(bundled_corpus_dir())
    init = StochasticVariationalBayes(LDAConfig(
        number_of_topics=10, inference_mode="svi", batch_size=100,
        inner_iterations=20), device="cpu")
    init.initialize(train, vocab)
    init.save(str(tmp_path / "model-0"))
    argv = [f"--input_directory={bundled_corpus_dir()}",
            "--number_of_topics=10", "--inference_mode=svi",
            "--training_iterations=4", "--snapshot_interval=2",
            f"--resume={tmp_path / 'model-0'}", "--dump_gamma"]
    assert train_main([*argv, f"--output_directory={tmp_path / 'port'}",
                       "--device=cpu"]) == 0
    assert jax_train_main([*argv, f"--output_directory={tmp_path / 'jax'}"]) == 0
    runs = {}
    for name in ("port", "jax"):
        (run,) = glob.glob(str(tmp_path / name / "*" / "*"))
        assert run.endswith("-imsvi")
        runs[name] = run
    files = sorted(os.listdir(runs["port"]))
    assert files == sorted(os.listdir(runs["jax"]))
    assert {"exp_beta-2", "exp_beta-4", "model-2", "model-4", "gamma-2",
            "gamma-4", "metrics.jsonl"} <= set(files)
    assert np.loadtxt(os.path.join(runs["port"], "gamma-4")).shape == (
        train.num_docs, 10)

    def final_perplexity(run):
        with open(os.path.join(run, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f][-1]["perplexity"]

    assert final_perplexity(runs["port"]) == pytest.approx(
        final_perplexity(runs["jax"]), rel=0.01)
