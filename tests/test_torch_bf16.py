"""The port's bf16 operand mode (compute_dtype="bfloat16") against the JAX
package's, on the CPU.

In that mode the JAX functions round three operands of each contraction
to bf16 (round to nearest even) and sum in f32; the port's plain versions
round at the same three points (``ops/estep.py``), and its kernels' bf16
builds are held against those on the card
(tests/test_torch_kernels_gpu.py).  Inputs are made with numpy from a
seed and handed to both packages.

Tolerances (measured on these inputs and on other sharp lambdas, PERF.md):

- after ONE pinned sweep (threshold 0) gamma agrees to rel 1e-5 (seen
  <= 1.3e-6): both round the same values, and only f32 summation order
  differs; the float32 plain version misses JAX's bf16 there by > 1e-3
  (seen 5e-3), the negative control;
- past one sweep, f32 summation order sometimes moves a value across a
  bf16 rounding boundary, a one-ulp (2^-8) flip that the fixed point
  carries forward, so gamma is not held elementwise.  Each document's
  share of the bound (``ragged_doc_bound``, in float64) is: after 12
  sweeps within rel 2e-4 (seen <= 1.0e-4).  After 50 the bf16 map has
  amplified those flips on rows that limit-cycle, and the plain version
  run in float64 with the same rounding points, which differs from the
  port's only in summation precision, is as far from JAX as the port's
  (seen up to 1.4e-3 against 7.8e-4 on sharp lambdas): there the bar is
  rel 2e-3.  The float32 plain version (no rounding points) misses both
  bars at K = 100 and 300 (seen 6.5e-4 to 1.1e-2 after 12 and 3.4e-3 to
  1.1e-2 after 50): the negative control; at K = 16 the rounding moves
  the shares too little to separate the two past one sweep (seen 1.1e-5
  to 2.0e-3), so there only the one-sweep control holds;
- the sufficient statistics take no fixed point: rel 1e-6 (+1e-6 of the
  largest entry) and the score rel 1e-6, against the XLA function and the
  Pallas kernel in interpret mode;
- the engines (the data and settings of tests/test_vb_engine.py's bf16
  test): 6 iterations from one lambda in each package, bounds and
  perplexity rel 1e-3 (seen <= 5.1e-4: with threshold 1e-7 the bf16
  fixed points' rows exit at their noise floor, a sweep apart in the two
  packages); the port's bf16 against its own float32 run with that
  test's bars (ELBO rel 2e-3, perplexity rel 5e-3).
"""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylda_tpu.cli.train import main as jax_train_main
from pylda_tpu.corpus.synthetic import synthetic_corpus as jax_synthetic
from pylda_tpu.models import StochasticVariationalBayes as JaxSVI
from pylda_tpu.models import VariationalBayes as JaxVB
from pylda_tpu.ops.estep import estep_dense as jax_dense
from pylda_tpu.ops.estep import estep_dense_sstats as jax_dense_sstats
from pylda_tpu.ops.estep import estep_ragged_gamma as jax_ragged_gamma
from pylda_tpu.ops.pallas_sstats import pallas_dense_sstats
from pylda_tpu.utils.config import LDAConfig as JaxConfig
from pylda_tpu_torch.cli.infer import main as infer_main
from pylda_tpu_torch.cli.test import main as cli_test_main
from pylda_tpu_torch.cli.train import main as train_main
from pylda_tpu_torch.corpus.datasets import bundled_corpus_dir, load_input_directory
from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.models import (
    Inferencer,
    StochasticVariationalBayes,
    VariationalBayes,
)
from pylda_tpu_torch.ops import dense_estep as dense_mod
from pylda_tpu_torch.ops import ragged as ragged_mod
from pylda_tpu_torch.ops import sstats as sstats_mod
from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation
from pylda_tpu_torch.ops.estep import (
    estep_dense,
    estep_dense_sstats,
    estep_ragged_gamma,
    ragged_doc_bound,
)
from pylda_tpu_torch.utils.config import LDAConfig

BF16 = "bfloat16"
ONE_SWEEP_RTOL = 1e-5
# Per-document bound shares after 12 and 50 pinned sweeps.
SHARE_RTOL = {12: 2e-4, 50: 2e-3}
SSTATS_RTOL = 1e-6
ENGINE_RTOL = 1e-3
ELBO_VS_F32, PPL_VS_F32 = 2e-3, 5e-3
TOPICS = [16, 100, 300]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _expelogbeta(K, V, rng):
    """A sharp expElogbeta, like a trained model's (float32)."""
    lam = rng.gamma(0.1, 1.0, (K, V)) * 100.0 + 0.01
    return exp_dirichlet_expectation(torch.tensor(lam)).float().numpy()


def _ragged_inputs(K, D=128, T=64, live=50, V=2000, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (D, T)).astype(np.int32)
    cnts = rng.integers(1, 4, (D, T)).astype(np.float32)
    ids[:, live:] = 0
    cnts[:, live:] = 0.0
    return dict(ids=ids, cnts=cnts, gamma0=np.ones((D, K), np.float32),
                eeb=_expelogbeta(K, V, rng),
                alpha=np.full((K,), 1.0 / K, np.float32))


def _dense_inputs(K, D=96, V=600, density=0.08, seed=1):
    rng = np.random.default_rng(seed)
    counts = ((rng.random((D, V)) < density)
              * rng.integers(1, 4, (D, V))).astype(np.float32)
    return dict(counts=counts, gamma0=np.ones((D, K), np.float32),
                eeb=_expelogbeta(K, V, rng),
                alpha=np.full((K,), 1.0 / K, np.float32))


def _as_ragged(counts):
    """A dense row as its nonzero (column, count) entries, zero-padded."""
    n = (counts != 0).sum(axis=1)
    ids = np.zeros((counts.shape[0], max(1, n.max())), np.int32)
    cnts = np.zeros(ids.shape, np.float32)
    for d, row in enumerate(counts):
        (cols,) = np.nonzero(row)
        ids[d, : cols.size] = cols
        cnts[d, : cols.size] = row[cols]
    return ids, cnts


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.abs(b)).max())


def _share_err(ids, cnts, gamma, gamma_ref, eeb, alpha):
    """Max relative gap of the documents' shares of the bound (float64)."""
    args = (_t(ids), _t(cnts).double())
    e64, a64 = _t(eeb).double(), _t(alpha).double()
    got = ragged_doc_bound(*args, _t(gamma).double(), e64, a64)
    want = ragged_doc_bound(*args, _t(gamma_ref).double(), e64, a64)
    return float(((got - want).abs() / want.abs()).max())


def _ragged_run(x, sweeps, mode):
    g, s = estep_ragged_gamma(
        *(_t(x[k]) for k in ("ids", "cnts", "gamma0", "eeb", "alpha")),
        inner_iterations=sweeps, convergence_threshold=0.0,
        compute_dtype=mode)
    assert int(s) == sweeps
    return g.numpy()


def _dense_run(x, sweeps, mode):
    """(gamma, token score of the final pass)."""
    g, _, tok, s = estep_dense(
        *(_t(x[k]) for k in ("counts", "gamma0", "eeb", "alpha")),
        inner_iterations=sweeps, convergence_threshold=0.0,
        compute_dtype=mode)
    assert int(s) == sweeps
    return g.numpy(), float(tok)


def _jax_ragged(x, sweeps):
    g, _ = jax_ragged_gamma(x["ids"], x["cnts"], x["gamma0"], x["eeb"],
                            x["alpha"], inner_iterations=sweeps,
                            convergence_threshold=0.0, compute_dtype=BF16)
    return np.asarray(g)


def _jax_dense(x, sweeps):
    g, _, tok, _ = jax_dense(x["counts"], x["gamma0"], x["eeb"], x["alpha"],
                             inner_iterations=sweeps,
                             convergence_threshold=0.0, compute_dtype=BF16)
    return np.asarray(g), float(tok)


ROUTES_FP = ("ragged", "dense")


def _fixed_point(route, K, sweeps, mode):
    """(inputs, ids, cnts, the port's gamma, JAX's bf16 gamma): ids/cnts
    are the rows' live entries (a dense row's nonzero columns)."""
    if route == "ragged":
        x = _ragged_inputs(K)
        return (x, x["ids"], x["cnts"], _ragged_run(x, sweeps, mode),
                _jax_ragged(x, sweeps))
    x = _dense_inputs(K)
    ids, cnts = _as_ragged(x["counts"])
    return (x, ids, cnts, _dense_run(x, sweeps, mode)[0],
            _jax_dense(x, sweeps)[0])


# -- the plain gamma fixed points -------------------------------------------


@pytest.mark.parametrize("K", TOPICS)
@pytest.mark.parametrize("route", ROUTES_FP)
def test_gamma_bf16_one_sweep_matches_jax(route, K):
    """One pinned sweep: gamma within rel 1e-5; the float32 plain version
    (no rounding points) misses by > 1e-3."""
    g = _fixed_point(route, K, 1, BF16)[3]
    x, _, _, g32, g_j = _fixed_point(route, K, 1, "float32")
    assert _rel(g, g_j) <= ONE_SWEEP_RTOL
    assert _rel(g32, g_j) > 1e-3
    if route == "dense":
        # The final pass's score at that gamma.  (Its sstats are not held
        # here: a gamma 1e-6 apart can move a rounded operand by one bf16
        # ulp; they are held at equal inputs below.)
        tok, tok_j = _dense_run(x, 1, BF16)[1], _jax_dense(x, 1)[1]
        assert tok == pytest.approx(tok_j, rel=ONE_SWEEP_RTOL)


@pytest.mark.parametrize("sweeps", [12, 50])
@pytest.mark.parametrize("K", TOPICS)
@pytest.mark.parametrize("route", ROUTES_FP)
def test_gamma_bf16_bound_shares_match_jax(route, K, sweeps):
    x, ids, cnts, g, g_j = _fixed_point(route, K, sweeps, BF16)
    assert _share_err(ids, cnts, g, g_j, x["eeb"],
                      x["alpha"]) <= SHARE_RTOL[sweeps]


@pytest.mark.parametrize("sweeps", [12, 50])
@pytest.mark.parametrize("K", [100, 300])
@pytest.mark.parametrize("route", ROUTES_FP)
def test_gamma_float32_misses_the_bf16_bar(route, K, sweeps):
    """Negative control: the plain version without the rounding points
    (float32) against JAX's bf16 mode fails the bar the bf16 version
    meets."""
    x, ids, cnts, g32, g_j = _fixed_point(route, K, sweeps, "float32")
    assert _share_err(ids, cnts, g32, g_j, x["eeb"],
                      x["alpha"]) > SHARE_RTOL[sweeps]


def test_wrappers_take_the_plain_version_in_bf16_on_the_cpu():
    """The kernel wrappers, given CPU tensors, run the plain versions in
    the mode asked for; an unknown mode raises."""
    x = _ragged_inputs(16, D=8)
    args = [_t(x[k]) for k in ("ids", "cnts", "gamma0", "eeb", "alpha")]
    kw = dict(inner_iterations=5, convergence_threshold=0.0)
    for mode in ("float32", BF16):
        got, _ = ragged_mod.ragged_gamma(*args, compute_dtype=mode, **kw)
        want, _ = estep_ragged_gamma(*args, compute_dtype=mode, **kw)
        assert torch.equal(got, want)
    d = _dense_inputs(16, D=8, V=40, density=0.3)
    dargs = [_t(d[k]) for k in ("counts", "gamma0", "eeb", "alpha")]
    got = dense_mod.dense_estep(*dargs, compute_dtype=BF16, **kw)
    want = estep_dense(*dargs, compute_dtype=BF16, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    et = exp_dirichlet_expectation(dargs[1])
    got = sstats_mod.dense_sstats(dargs[0], et, dargs[2], compute_dtype=BF16)
    want = estep_dense_sstats(dargs[0], et, dargs[2], compute_dtype=BF16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    f32 = estep_dense_sstats(dargs[0], et, dargs[2])
    assert not torch.equal(got[0], f32[0])
    for fn, a in ((ragged_mod.ragged_gamma, args),
                  (dense_mod.dense_estep, dargs)):
        with pytest.raises(ValueError, match="compute_dtype"):
            fn(*a, compute_dtype="float16", **kw)


# -- sufficient statistics ------------------------------------------------------


@pytest.mark.parametrize("bf16_counts", [True, False])
@pytest.mark.parametrize("K", TOPICS)
def test_dense_sstats_bf16_matches_jax_and_pallas(K, bf16_counts):
    rng = np.random.default_rng(K)
    D, V, Vc = 72, 500, 640
    counts = ((rng.random((D, V)) < 0.05)
              * rng.integers(1, 5, (D, V))).astype(np.float32)
    counts = np.pad(counts, ((0, 0), (0, Vc - V)))
    et = exp_dirichlet_expectation(
        torch.tensor(rng.gamma(1.0, 1.0, (D, K)))).float().numpy()
    eeb = _expelogbeta(K, V, rng)
    c_t = _t(counts).to(torch.bfloat16) if bf16_counts else _t(counts)
    c_j = jnp.asarray(counts).astype(jnp.bfloat16 if bf16_counts
                                     else jnp.float32)
    ss, tok = estep_dense_sstats(c_t, _t(et), _t(eeb), compute_dtype=BF16)
    ss32, _ = estep_dense_sstats(c_t, _t(et), _t(eeb))
    for name, fn in (("xla", jax_dense_sstats),
                     ("pallas", lambda *a, **k: pallas_dense_sstats(
                         *a, interpret=True, **k))):
        ss_j, tok_j = fn(c_j, et, eeb, compute_dtype=BF16)
        ss_j = np.asarray(ss_j)
        np.testing.assert_allclose(ss.numpy(), ss_j, rtol=SSTATS_RTOL,
                                   atol=SSTATS_RTOL * np.abs(ss_j).max(),
                                   err_msg=name)
        assert float(tok) == pytest.approx(float(tok_j), rel=SSTATS_RTOL)
    # The bf16 mode is another function than float32's.
    assert float((ss - ss32).abs().max()) > 1e-4 * float(ss32.abs().max())


# -- the gather table -------------------------------------------------------------


def _rne_bf16(x):
    """float32 -> bf16 (nearest even) -> float32, on the bits (numpy)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("K", [13, 16, 100, 300])
def test_gather_table_bf16_pads_topics_to_eight(K):
    rng = np.random.default_rng(K)
    eeb = _expelogbeta(K, 57, rng)
    table = ragged_mod.gather_table(_t(eeb), BF16)
    ldb = -(-K // 8) * 8
    assert table.dtype == torch.bfloat16 and table.is_contiguous()
    assert table.shape == (57, ldb)
    assert not table[:, K:].float().any()
    got = table[:, :K].float().numpy()
    np.testing.assert_array_equal(got, _rne_bf16(eeb.T))
    np.testing.assert_array_equal(
        got, np.asarray(jnp.asarray(eeb.T).astype(jnp.bfloat16)
                        .astype(jnp.float32)))


# -- the engines ----------------------------------------------------------------------

# The data and settings of tests/test_vb_engine.py's bf16 test.
K_E, V_E, D_E = 5, 120, 64
ROUTES = {"dense": {}, "ragged": dict(dense_vocab_threshold=64)}
ENGINE_CFG = dict(number_of_topics=K_E, alpha_alpha=0.2, alpha_beta=0.01,
                  inner_iterations=100, convergence_threshold=1e-7,
                  doc_pad_multiple=8, seed=0, gamma_init="ones")
SVI_CFG = dict(inference_mode="svi", batch_size=16, tau0=16.0, kappa=0.7)


@pytest.fixture(scope="module")
def data():
    kw = dict(num_docs=D_E, num_topics=K_E, num_types=V_E,
              mean_doc_length=40, seed=7)
    corpus = synthetic_corpus(**kw)[0]
    corpus_j = jax_synthetic(**kw)[0]
    return dict(corpus=corpus, corpus_j=corpus_j,
                test=corpus.subset(range(12)),
                test_j=corpus_j.subset(range(12)),
                lam0=np.random.default_rng(42).gamma(100.0, 0.01,
                                                     (K_E, V_E)))


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("mode", ["vb", "svi"])
def test_engine_bf16_matches_jax(data, route, mode):
    """Batch VB or SVI in bf16 on each route: the port and the JAX engine
    from one lambda, the bounds of 6 iterations, held-out inference and
    perplexity."""
    engine, jax_engine = ((VariationalBayes, JaxVB) if mode == "vb"
                          else (StochasticVariationalBayes, JaxSVI))
    cfg = dict(ENGINE_CFG, compute_dtype=BF16, **ROUTES[route],
               **(SVI_CFG if mode == "svi" else {}))
    ours = engine(LDAConfig(**cfg), device="cpu")
    ours.initialize(data["corpus"], lam_init=data["lam0"])
    theirs = jax_engine(JaxConfig(**cfg))
    theirs.initialize(data["corpus_j"], lam_init=data["lam0"])
    np.testing.assert_allclose([ours.learning() for _ in range(6)],
                               [theirs.learning() for _ in range(6)],
                               rtol=ENGINE_RTOL)
    assert ours.perplexity(data["test"]) == pytest.approx(
        theirs.perplexity(data["test_j"]), rel=ENGINE_RTOL)
    ll, gamma = ours.inference(data["test"])
    ll_j, _ = theirs.inference(data["test_j"])
    assert ll == pytest.approx(ll_j, rel=ENGINE_RTOL)
    assert gamma.shape == (12, K_E) and np.isfinite(gamma).all()


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_engine_bf16_tracks_float32(data, route):
    """The port's bf16 against its own float32 after 6 iterations, with
    the JAX package's bars (tests/test_vb_engine.py)."""
    runs = {}
    for cd in ("float32", BF16):
        eng = VariationalBayes(
            LDAConfig(**ENGINE_CFG, **ROUTES[route], compute_dtype=cd),
            device="cpu")
        eng.initialize(data["corpus"], lam_init=data["lam0"])
        for _ in range(6):
            elbo = eng.learning()
        runs[cd] = (elbo, eng.perplexity(data["test"]))
    (b32, p32), (b16, p16) = runs["float32"], runs[BF16]
    assert abs(b32 - b16) / abs(b32) < ELBO_VS_F32
    assert abs(p32 - p16) / p32 < PPL_VS_F32
    assert b16 != b32  # the modes differ


# -- the CLIs ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["vb", "svi"])
def test_cli_bf16_matches_jax_cli(tmp_path, mode):
    """train with --compute_dtype bfloat16 in each package from one
    initial model file: the same files and held-out perplexity within the
    engine bar; the model file carries the mode, so test and infer run
    in it."""
    train, _, vocab = load_input_directory(bundled_corpus_dir())
    extra = dict(batch_size=100) if mode == "svi" else {}
    init = (StochasticVariationalBayes if mode == "svi" else VariationalBayes)(
        LDAConfig(number_of_topics=10, inference_mode=mode,
                  inner_iterations=20, compute_dtype=BF16, **extra),
        device="cpu")
    init.initialize(train, vocab)
    init.save(str(tmp_path / "model-0"))
    argv = [f"--input_directory={bundled_corpus_dir()}",
            "--number_of_topics=10", f"--inference_mode={mode}",
            "--training_iterations=4", "--snapshot_interval=2",
            "--compute_dtype=bfloat16", f"--resume={tmp_path / 'model-0'}",
            *([f"--batch_size={extra['batch_size']}"] if extra else [])]
    assert train_main([*argv, f"--output_directory={tmp_path / 'port'}",
                       "--device=cpu"]) == 0
    assert jax_train_main([*argv,
                           f"--output_directory={tmp_path / 'jax'}"]) == 0
    runs = {}
    for name in ("port", "jax"):
        (run,) = glob.glob(str(tmp_path / name / "*" / "*"))
        runs[name] = run
    assert sorted(os.listdir(runs["port"])) == sorted(os.listdir(runs["jax"]))

    def final_perplexity(run):
        with open(os.path.join(run, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f][-1]["perplexity"]

    assert final_perplexity(runs["port"]) == pytest.approx(
        final_perplexity(runs["jax"]), rel=ENGINE_RTOL)
    model = os.path.join(runs["port"], "model-4")
    assert Inferencer.load(model, device="cpu").config.compute_dtype == BF16
    out = tmp_path / "gamma.test"
    assert cli_test_main([f"--model={model}",
                      f"--input_directory={bundled_corpus_dir()}",
                      f"--output_file={out}", "--point_estimate",
                      "--device=cpu"]) == 0
    assert np.loadtxt(out).shape == (100, 10)
    docs = tmp_path / "docs.txt"
    docs.write_text("government election vote\nrain snow storm weather\n")
    mix = tmp_path / "mix.tsv"
    assert infer_main([f"--model={model}", f"--input={docs}",
                       f"--output={mix}", "--full", "--device=cpu"]) == 0
    np.testing.assert_allclose(np.loadtxt(mix).sum(axis=1), 1.0, rtol=1e-4)
