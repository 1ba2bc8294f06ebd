"""The port's roofline (``pylda_tpu_torch.utils.roofline``, CPU).

A mirror of tests/test_roofline.py with one H100's resources (float32 on
the CUDA cores, bf16 on the tensor cores, HBM3) in place of the TPU's MXU
and VPU.  Where the port does the work the JAX model counts (the ragged
fixed point, E[log beta], the n_kv rebuild, the factor refresh, the
joint likelihood, SVI's natural-gradient step and beta_elbo), FLOP and
bytes are held EQUAL to ``pylda_tpu.utils.roofline``'s on the same
corpus (bounds compared at the same peaks).  Where its kernels do other
work (the dense fixed point and the dense sufficient statistics at
nonzero counts only, the cdf sampler's cumsum), the counts are pinned to
the port's formulas (``chip_smoke.py``'s for the sstats).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from pylda_tpu.corpus.synthetic import synthetic_corpus as jax_synthetic
from pylda_tpu.models import make_engine as jax_make_engine
from pylda_tpu.utils import roofline as jax_roofline
from pylda_tpu.utils.config import LDAConfig as JaxConfig
from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.models import Hybrid, make_engine
from pylda_tpu_torch.utils.config import LDAConfig
from pylda_tpu_torch.utils.roofline import (
    H100,
    ChipPeaks,
    _batch_sweep_bound_ms,
    _svi_epoch_bound_ms,
    bound_ms,
    estep_cost_model,
    gibbs_learning_phase_bounds,
    measured_sweep_counts,
    pass_bound_ms,
    rebuild_bound_ms,
    roofline_report,
    suite_mfu,
    svi_epoch_phase_bounds,
    utilisation,
)

CORPUS = dict(num_docs=256, num_topics=8, num_types=600, mean_doc_length=40.0,
              seed=0)
WIDE = dict(num_docs=96, num_topics=6, num_types=5000, mean_doc_length=25,
            seed=0)
SEQ = dict(num_docs=64, num_topics=8, num_types=300, mean_doc_length=30,
           seed=0)
# The JAX and the port's peaks set to the same rates, so equal counts give
# equal bounds.
SAME = dict(hbm_bytes=1e12, lgamma_per_sec=3e10, log_per_sec=2e11)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pair(corpus_kw=CORPUS, **kw):
    """The port's and the JAX engine, prepared on the same corpus."""
    kw.setdefault("dense_vocab_threshold", 8)
    cfg = dict(number_of_topics=corpus_kw["num_topics"], seed=0, **kw)
    cfg.setdefault("inference_mode", "vb")
    ours = make_engine(LDAConfig(**cfg), device="cpu")
    ours.initialize(synthetic_corpus(**corpus_kw)[0])
    theirs = jax_make_engine(JaxConfig(**cfg))
    theirs.initialize(jax_synthetic(**corpus_kw)[0])
    return ours, theirs


def _engine(**kw):
    return _pair(**kw)[0]


def test_cost_model_phases_and_consistency():
    eng = _engine()
    model = estep_cost_model(eng)
    assert set(model) >= {"sweeps_per_sweep", "sstats", "elog_beta"}
    sw = model["sweeps_per_sweep"]
    slots = sum(b.ids.shape[0] * b.ids.shape[1] for b in eng._batches)
    assert sw["flops"] == 4 * slots * 8
    assert sw["bound_ms"] > 0 and sw["bound"] in ("operations", "bytes")
    ss = model["sstats"]
    nnz = sum(int((c != 0).sum()) for c, _ in eng._sstats_plan.chunks)
    assert ss["flops"] == 4 * 8 * nnz
    assert ss["docs"] == sum(c.shape[0] for c, _ in eng._sstats_plan.chunks)


def test_sstats_counts_nonzeros_once_as_chip_smoke_does():
    """dense_sstats keeps phinorm in the kernel and works at nonzero
    counts: its FLOP and bytes are chip_smoke.py's formula, below the
    JAX model's dense form."""
    ours, theirs = _pair()
    got = estep_cost_model(ours)["sstats"]
    K, V = 8, 600
    flops = nbytes = 0
    for counts, _ in ours._sstats_plan.chunks:
        rows = counts.shape[0]
        flops += 4.0 * K * int((counts != 0).sum())
        nbytes += (counts.numel() * counts.element_size() + rows * K * 4
                   + 2 * K * V * 4 + 4)
    assert got["flops"] == flops and got["hbm_bytes"] == nbytes
    want = jax_roofline.estep_cost_model(theirs)["sstats"]
    assert got["flops"] < want["flops"]
    ms, by = chip_smoke.bound(flops, nbytes)
    assert (ms, by) == bound_ms(flops, nbytes)
    assert got["bound_ms"] == pytest.approx(ms, rel=1e-12)


def test_ragged_sweep_matches_jax_and_is_dtype_invariant():
    """The ragged fixed point counts the JAX model's work (4 K FLOP and 8
    bytes a slot); its FMAs are float32 in both operand modes, so the
    bound is dtype-invariant."""
    ours, theirs = _pair()
    f32 = estep_cost_model(ours)["sweeps_per_sweep"]
    want = jax_roofline.estep_cost_model(theirs)["sweeps_per_sweep"]
    assert (f32["flops"], f32["hbm_bytes"]) == (want["flops"],
                                               want["hbm_bytes"])
    bf16 = estep_cost_model(_engine(compute_dtype="bfloat16"))[
        "sweeps_per_sweep"]
    assert f32["bound"] in ("operations", "bytes")
    assert bf16["bound_ms"] == f32["bound_ms"]
    assert bf16["flops"] == f32["flops"]


def test_dense_sweep_counts_nonzeros_and_the_block_once():
    """The dense fixed point sweeps each row's nonzero counts (4 K FLOP
    each) and reads the counts block once a call: below the JAX model's
    matmul form, and the same in both operand modes (the counts' storage
    does not depend on them)."""
    ours, theirs = _pair(dense_vocab_threshold=4096)
    f32 = estep_cost_model(ours)["sweeps_per_sweep"]
    nnz = sum(int((b.counts != 0).sum()) for b in ours._batches)
    nbytes = sum(b.counts.numel() * b.counts.element_size()
                 for b in ours._batches)
    assert f32["flops"] == 4 * 8 * nnz and f32["hbm_bytes"] == nbytes
    want = jax_roofline.estep_cost_model(theirs)["sweeps_per_sweep"]
    assert f32["flops"] < want["flops"]
    bf16 = estep_cost_model(_engine(dense_vocab_threshold=4096,
                                    compute_dtype="bfloat16"))[
        "sweeps_per_sweep"]
    assert (bf16["flops"], bf16["hbm_bytes"]) == (f32["flops"],
                                                 f32["hbm_bytes"])


def test_elog_beta_matches_jax():
    ours, theirs = _pair()
    got = estep_cost_model(ours)["elog_beta"]
    want = jax_roofline.estep_cost_model(theirs)["elog_beta"]
    assert (got["flops"], got["hbm_bytes"]) == (want["flops"],
                                               want["hbm_bytes"])


def test_measured_report_shape():
    """roofline_report pairs measured phase times with bounds and a
    clamped utilisation; sweep counts are the engine's own (<= cap)."""
    eng = _engine()
    eng.learning_many(3)
    counts = measured_sweep_counts(eng)
    assert counts == [float(s) for s in eng.last_sweeps]
    assert len(counts) == len(eng._batches)
    assert all(1 <= c <= eng.config.inner_iterations for c in counts)
    assert pass_bound_ms(eng) > 0
    rep = roofline_report(eng, repeats=1)
    assert len(rep["sweep_counts"]) == len(counts)
    assert {"sweeps", "estep_full", "iteration"} <= set(rep)
    for phase in ("sweeps", "estep_full", "iteration"):
        row = rep[phase]
        assert set(row) == {"measured_ms", "bound_ms", "utilisation"}
        assert 0.0 <= row["utilisation"] <= 1.0
        assert row["bound_ms"] > 0 and row["measured_ms"] > 0


def test_sweep_counts_come_from_the_engines_runs(monkeypatch):
    """measured_sweep_counts reads last_sweeps and runs no E-step of its
    own when the engine has them; without them it times the engine."""
    eng = _engine()
    calls = []
    inner = eng.phase_timings
    monkeypatch.setattr(eng, "phase_timings",
                        lambda repeats=3: calls.append(repeats) or inner(repeats))
    counts = measured_sweep_counts(eng)  # fresh: no run yet
    assert calls == [1] and len(counts) == len(eng._batches)
    eng.learning()
    assert measured_sweep_counts(eng) == [float(s) for s in eng.last_sweeps]
    assert calls == [1]


def test_utilisation_bounds():
    assert utilisation(2.0, 1.0) == 0.5
    assert utilisation(0.5, 1.0) == 1.0  # clamped at speed of light
    assert utilisation(0.0, 1.0) == 0.0
    assert np.isclose(utilisation(4.0, H100.hbm_bytes * 0 + 1.0), 0.25)


def test_hybrid_sequence_layout_report():
    """The sampled local step's model (fixed burn_in + samples sweeps):
    6 K FLOP a slot plus the cdf sampler's K-long cumsum, where the JAX
    sampler's prefix-sum matmul costs 2 K^2."""
    eng = Hybrid(LDAConfig(
        number_of_topics=8, inference_mode="hybrid", seed=0,
        bucket_sizes=(32, 64), number_of_samples=3, burn_in_sweeps=2,
    ), device="cpu")
    eng.initialize(synthetic_corpus(**SEQ)[0])
    counts = measured_sweep_counts(eng)
    assert counts == [5] * len(eng._batches)
    model = estep_cost_model(eng)
    slots = sum(b.tokens.shape[0] * b.tokens.shape[1] for b in eng._batches)
    assert model["sweeps_per_sweep"]["flops"] == 7 * slots * 8
    assert model["sweeps_per_sweep"]["bound_ms"] > 0
    assert pass_bound_ms(eng) > 0
    rep = roofline_report(eng, repeats=1)
    assert "iteration" in rep
    assert 0.0 <= rep["iteration"]["utilisation"] <= 1.0


def test_gibbs_bound_includes_dominant_phases():
    ours, theirs = _pair(WIDE, inference_mode="gibbs",
                         dense_vocab_threshold=4096)
    phases = gibbs_learning_phase_bounds(ours)
    assert set(phases) == {"sampling", "rebuild", "factor_refresh",
                           "joint_ll"}
    assert all(v > 0 for v in phases.values()), phases
    assert phases["rebuild"] >= rebuild_bound_ms(0, 6, 5000)
    assert sum(phases.values()) > phases["sampling"]
    # The same work as the JAX model outside the sampling step.
    got = gibbs_learning_phase_bounds(ours, ChipPeaks(**SAME))
    want = jax_roofline.gibbs_learning_phase_bounds(
        theirs, jax_roofline.ChipPeaks(**SAME))
    for k in ("rebuild", "factor_refresh", "joint_ll"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    rep = roofline_report(ours, repeats=1)
    assert set(rep) == {"sweep", "joint_likelihood"}
    assert all(r["measured_ms"] > 0 and r["bound_ms"] > 0
               for r in rep.values())


def test_svi_bound_includes_dominant_phases():
    ours, theirs = _pair(WIDE, inference_mode="svi", batch_size=32,
                         dense_vocab_threshold=4096)
    phases = svi_epoch_phase_bounds(ours)
    assert {"sstats", "natural_gradient", "elog_beta", "beta_elbo"} <= set(
        phases)
    assert all(v > 0 for v in phases.values()), phases
    expect = 3 * 3 * 6 * 5000 * 4 / H100.hbm_bytes * 1e3
    assert abs(phases["natural_gradient"] - expect) / expect < 1e-12
    assert _svi_epoch_bound_ms(ours) > sum(phases.values())
    got = svi_epoch_phase_bounds(ours, ChipPeaks(**SAME))
    want = jax_roofline.svi_epoch_phase_bounds(
        theirs, jax_roofline.ChipPeaks(**SAME))
    for k in ("natural_gradient", "elog_beta", "beta_elbo"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    ours.learning()
    rep = roofline_report(ours, repeats=1)
    assert set(rep) == {"minibatch", "sweep_counts"}
    assert rep["minibatch"]["bound_ms"] > 0


def test_hybrid_bound_includes_kept_sweep_rebuilds():
    eng = Hybrid(LDAConfig(
        number_of_topics=8, inference_mode="hybrid", seed=0,
        bucket_sizes=(32, 64), number_of_samples=3, burn_in_sweeps=2,
    ), device="cpu")
    eng.initialize(synthetic_corpus(**SEQ)[0])
    sweeps_only = sum(
        _batch_sweep_bound_ms(b, eng.config, H100, s)
        for b, s in zip(eng._batches, measured_sweep_counts(eng)))
    assert pass_bound_ms(eng) > sweeps_only


def test_suite_mfu_all_engine_kinds():
    corpus = synthetic_corpus(**WIDE)[0]
    for mode in ("vb", "svi", "gibbs", "hybrid"):
        eng = make_engine(LDAConfig(
            number_of_topics=6, inference_mode=mode, seed=0, batch_size=32,
            number_of_samples=2, burn_in_sweeps=1, inner_iterations=10,
        ), device="cpu")
        eng.initialize(corpus)
        eng.learning_many(2)
        mfu = suite_mfu(eng, measured_seconds=1e-4)
        assert mfu is not None and 0.0 < mfu <= 1.0, (mode, mfu)


def test_chip_smoke_takes_its_peaks_from_the_roofline():
    assert not hasattr(chip_smoke, "PEAK_F32_FLOPS")
    for args in ((1e9, 1e6), (1e6, 1e9), (4e12, 1e9, "bfloat16")):
        assert chip_smoke.bound(*args) == bound_ms(*args)
    assert chip_smoke.bound(67e12, 0.0) == (1e3, "operations")
    assert chip_smoke.bound(0.0, 3.35e12) == (1e3, "bytes")
    assert chip_smoke.bound(989e12, 0.0, "bfloat16") == (1e3, "operations")
