"""The port above K = 4096 topics (the kernels' cluster range), against
pylda_tpu on the CPU.

The CUDA kernels take any K: above 4096 the gamma fixed points run the
cluster kernel (``csrc/row_fixed_point_tiled.cuh``) and the dense
sufficient statistics theirs (``csrc/dense_sstats.cu``: the topics split
over a cluster, column tiles, batches of nonzeros).  Here, on the CPU,
the wrappers take their plain versions, which have no cap; they are held
at K = 4224 (and 8192) against:

- each TPU kernel in interpret mode: ``pallas_estep_ragged_gamma`` on a
  16 x 16 bucket and ``pallas_estep_dense`` at D = 16, V = 64 (f32: their
  bf16 variant is a storage mode, not the bf16 operand mode; the port's
  bf16 mode is held to the XLA function's below), rtol 5e-4 as at K =
  300 (the kernels' in-kernel digamma series differs);
  ``pallas_dense_sstats`` in f32 and bf16, rtol 2e-5 as at K = 300;
- the XLA functions: f32 at pinned sweeps (rtol 1e-4: phinorm sums 4224
  products in another order in each package) and at the exit rule (per
  row 5e-4 + K * threshold, the sweep count within 1); bf16 at
  tests/test_torch_bf16.py's bars (one sweep rel 1e-5, then each
  document's share of the bound);
- the kernels' arithmetic orders, emulated here: the cluster kernel's
  sweep (slice partials of phinorm, summed over the ranks in order,
  resident and streamed windows, step B's group sums, the CTAs' and the
  ranks' sums of |dgamma|) under the row-major schedule, and the
  sufficient statistics' cluster kernel (rank slices, a thread's rows,
  the butterfly, the warps and the ranks in order, raw in row order,
  batches), each against the batch function (float64: 1e-12; float32:
  1e-5);
- the engines: batch VB on the ragged and dense routes and SVI at pinned
  sweeps against the JAX engines, at tests/test_torch_vb.py's bars, and
  the CLI's train and test round trip.

``ops/sstats.py::plan`` and the cluster kernel's plan
(``ops/row_fixed_point.py::cluster_plan``) are checked beside them.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylda_tpu.corpus.synthetic import synthetic_corpus as jax_synthetic
from pylda_tpu.models import StochasticVariationalBayes as JaxSVI
from pylda_tpu.models import VariationalBayes as JaxVB
from pylda_tpu.ops import dirichlet as jd
from pylda_tpu.ops.estep import estep_dense as jax_dense
from pylda_tpu.ops.estep import estep_dense_sstats as jax_dense_sstats
from pylda_tpu.ops.estep import estep_ragged_gamma as jax_ragged_gamma
from pylda_tpu.ops.pallas_estep import pallas_estep_dense
from pylda_tpu.ops.pallas_ragged import pallas_estep_ragged_gamma
from pylda_tpu.ops.pallas_sstats import pallas_dense_sstats
from pylda_tpu.utils.config import LDAConfig as JaxConfig
from pylda_tpu_torch.cli.test import main as cli_test_main
from pylda_tpu_torch.cli.train import main as train_main
from pylda_tpu_torch.corpus.datasets import bundled_corpus_dir
from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.models import StochasticVariationalBayes, VariationalBayes
from pylda_tpu_torch.ops import dense_estep as dense_mod
from pylda_tpu_torch.ops import ragged as ragged_mod
from pylda_tpu_torch.ops import row_fixed_point as rfp
from pylda_tpu_torch.ops import sstats as sstats_mod
from pylda_tpu_torch.ops.dirichlet import (
    exp_dirichlet_expectation,
    exp_dirichlet_expectation_fast,
)
from pylda_tpu_torch.ops.estep import (
    _exit_update,
    bf16_round,
    estep_dense_sstats,
    estep_ragged_gamma,
    ragged_doc_bound,
)
from pylda_tpu_torch.utils.config import LDAConfig
from torch_sstats_model import LANES, THREADS, WARPS
from torch_sstats_model import butterfly as _butterfly
from torch_sstats_model import cluster_entries as _wide_entries
from torch_sstats_model import cluster_sstats as _wide_sstats

K = 4224  # above 4096, not a power of two: two tiles, the last of 128
BF16 = "bfloat16"
MODES = ["float32", BF16]
# tests/test_torch_vb.py's bars.
RTOL = 1e-4
LAM_ATOL = 1e-4
GAMMA_TOL = 5e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.from_numpy(np.array(x))


def _ragged_case(D=16, T=16, k=K, V=300, seed=7):
    """A 16 x 16 bucket with padded slots and an all-padding row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (D, T)).astype(np.int32)
    cnts = rng.integers(1, 4, (D, T)).astype(np.float32)
    fill = rng.integers(4, T + 1, D)
    pad = np.arange(T)[None, :] >= fill[:, None]
    ids[pad], cnts[pad] = 0, 0.0
    ids[-1], cnts[-1] = 0, 0.0
    lam = rng.gamma(1.0, 1.0, (k, V)).astype(np.float32)
    eeb = np.asarray(jd.exp_dirichlet_expectation(jnp.asarray(lam)))
    alpha = np.full(k, 0.1, np.float32)
    g0 = rng.gamma(100.0, 0.01, (D, k)).astype(np.float32)
    return ids, cnts, g0, eeb, alpha


def _dense_case(D=16, V=64, k=K, seed=3):
    rng = np.random.default_rng(seed)
    counts = ((rng.random((D, V)) < 0.3)
              * rng.integers(1, 4, (D, V))).astype(np.float32)
    counts[-1] = 0.0
    lam = rng.gamma(1.0, 1.0, (k, V)).astype(np.float32)
    eeb = np.asarray(jd.exp_dirichlet_expectation(jnp.asarray(lam)))
    alpha = np.full(k, 0.1, np.float32)
    g0 = rng.gamma(100.0, 0.01, (D, k)).astype(np.float32)
    return counts, g0, eeb, alpha


def _sstats_case(D=24, V=200, k=K, seed=5, v_pad=56):
    rng = np.random.default_rng(seed)
    counts = ((rng.random((D, V)) < 0.05)
              * rng.integers(1, 4, (D, V))).astype(np.float32)
    counts[3, :40] += 1.0  # a long row
    counts[:, 7] += 1.0  # a column every row uses
    counts = np.pad(counts, ((0, 0), (0, v_pad)))
    gamma = rng.gamma(100.0, 0.01, (D, k)).astype(np.float32)
    lam = rng.gamma(100.0, 0.01, (k, V)).astype(np.float32)
    et = np.asarray(jd.exp_dirichlet_expectation(jnp.asarray(gamma)))
    eeb = np.asarray(jd.exp_dirichlet_expectation(jnp.asarray(lam)))
    return counts, et, eeb


# -- the TPU kernels in interpret mode ------------------------------------------


def test_ragged_gamma_wide_matches_pallas_interpret():
    """The wrapper's CPU route against ``pallas_estep_ragged_gamma``
    (interpret mode, f32 storage) at 10 pinned sweeps, rtol 5e-4."""
    ids, cnts, g0, eeb, alpha = _ragged_case()
    g, s = ragged_mod.ragged_gamma(_t(ids), _t(cnts), _t(g0), _t(eeb),
                                   _t(alpha), inner_iterations=10,
                                   convergence_threshold=0.0)
    g_p, _ = pallas_estep_ragged_gamma(
        jnp.asarray(ids), jnp.asarray(cnts), jnp.asarray(g0),
        jnp.asarray(eeb), jnp.asarray(alpha), inner_iterations=10,
        convergence_threshold=0.0, tile_d=16, tile_t=16,
        storage_dtype="float32", interpret=True)
    assert int(s) == 10
    np.testing.assert_allclose(g.numpy(), np.asarray(g_p), rtol=5e-4,
                               atol=5e-4)


@pytest.mark.parametrize("k", [K, 8192])
def test_dense_estep_wide_matches_pallas_interpret(k):
    """The wrapper's CPU route against ``pallas_estep_dense`` (interpret
    mode, f32 storage) at 10 pinned sweeps: gamma rtol 5e-4, sstats rtol
    1e-4 (of the largest entry below it), the score rel 1e-4."""
    counts, g0, eeb, alpha = _dense_case(k=k)
    kw = dict(inner_iterations=10, convergence_threshold=0.0, eps=1e-30)
    g, ss, tok, s = dense_mod.dense_estep(_t(counts), _t(g0), _t(eeb),
                                          _t(alpha), **kw)
    g_p, ss_p, tok_p = (np.asarray(x) for x in pallas_estep_dense(
        jnp.asarray(counts), jnp.asarray(g0), jnp.asarray(eeb),
        jnp.asarray(alpha), tile_d=16, storage_dtype="float32",
        interpret=True, **kw))
    assert int(s) == 10 and ss.shape == (k, 64)
    np.testing.assert_allclose(g.numpy(), g_p, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(ss.numpy(), ss_p, rtol=1e-4,
                               atol=1e-4 * np.abs(ss_p).max())
    assert float(tok) == pytest.approx(float(tok_p), rel=1e-4)


@pytest.mark.parametrize("compute_dtype", MODES)
@pytest.mark.parametrize("k", [K, 8192])
def test_dense_sstats_wide_matches_pallas_interpret(k, compute_dtype):
    """The wrapper's CPU route against ``pallas_dense_sstats`` (interpret
    mode) with bf16 counts, vocab padding, a long row and a column every
    row uses: rtol 2e-5 (atol 1e-6 of the largest entry), the score rel
    2e-5."""
    counts, et, eeb = _sstats_case(k=k)
    ct = _t(counts).to(torch.bfloat16)
    ss, tok = sstats_mod.dense_sstats(ct, _t(et), _t(eeb),
                                      compute_dtype=compute_dtype)
    ss_p, tok_p = pallas_dense_sstats(
        jnp.asarray(counts).astype(jnp.bfloat16), jnp.asarray(et),
        jnp.asarray(eeb), compute_dtype=compute_dtype, interpret=True)
    ss_p = np.asarray(ss_p)
    assert ss.shape == (k, 200)
    np.testing.assert_allclose(ss.numpy(), ss_p, rtol=2e-5,
                               atol=1e-6 * np.abs(ss_p).max())
    assert float(tok) == pytest.approx(float(tok_p), rel=2e-5)


# -- the XLA functions ------------------------------------------------------------


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.abs(b)).max())


def _share_err(ids, cnts, gamma, gamma_ref, eeb, alpha):
    """Max relative gap of the documents' shares of the bound (float64),
    over the rows with a token (an all-padding row's share is 0)."""
    live = cnts.sum(axis=1) > 0
    ids, cnts, gamma, gamma_ref = ids[live], cnts[live], gamma[live], \
        gamma_ref[live]
    args = (_t(ids), _t(cnts).double())
    e64, a64 = _t(eeb).double(), _t(alpha).double()
    got = ragged_doc_bound(*args, _t(gamma).double(), e64, a64)
    want = ragged_doc_bound(*args, _t(gamma_ref).double(), e64, a64)
    return float(((got - want).abs() / want.abs()).max())


def _ragged_both(case, compute_dtype, **kw):
    ids, cnts, g0, eeb, alpha = case
    g, s = estep_ragged_gamma(_t(ids), _t(cnts), _t(g0), _t(eeb), _t(alpha),
                              compute_dtype=compute_dtype, **kw)
    g_j, s_j = jax_ragged_gamma(
        jnp.asarray(ids), jnp.asarray(cnts), jnp.asarray(g0),
        jnp.asarray(eeb), jnp.asarray(alpha), compute_dtype=compute_dtype,
        **kw)
    return g.numpy(), int(s), np.asarray(g_j), int(s_j)


def test_ragged_gamma_wide_matches_xla():
    """float32: 12 pinned sweeps rtol 1e-4; the default exit rule
    (threshold 1e-5, patience 6) per row 5e-4 + K * threshold, the sweep
    count within 1."""
    case = _ragged_case()
    g, s, g_j, s_j = _ragged_both(case, "float32", inner_iterations=12,
                                  convergence_threshold=0.0)
    assert s == s_j == 12
    np.testing.assert_allclose(g, g_j, rtol=RTOL, atol=1e-5)
    g, s, g_j, s_j = _ragged_both(case, "float32", inner_iterations=50,
                                  convergence_threshold=1e-5,
                                  stall_patience=6)
    assert abs(s - s_j) <= 1
    np.testing.assert_allclose(g, g_j, rtol=GAMMA_TOL,
                               atol=GAMMA_TOL + K * 1e-5)


def test_ragged_gamma_wide_bf16_matches_xla():
    """bf16 operands, tests/test_torch_bf16.py's bars: one pinned sweep
    rel 1e-5; after 12 each document's share of the bound rel 2e-4 (a
    ratio at a bf16 midpoint may round one ulp apart and be carried)."""
    case = _ragged_case()
    ids, cnts, _, eeb, alpha = case
    g, s, g_j, s_j = _ragged_both(case, BF16, inner_iterations=1,
                                  convergence_threshold=0.0)
    assert s == s_j == 1 and _rel(g, g_j) <= 1e-5
    g, s, g_j, s_j = _ragged_both(case, BF16, inner_iterations=12,
                                  convergence_threshold=0.0)
    assert s == s_j == 12
    assert _share_err(ids, cnts, g, g_j, eeb, alpha) <= 2e-4


@pytest.mark.parametrize("compute_dtype", MODES)
def test_dense_estep_wide_matches_xla(compute_dtype):
    """``estep_dense`` at pinned sweeps: float32 after 12, gamma rtol 5e-4
    (the fixed point's per-row tolerance: 12 sweeps carry the
    reassociation of 4224-term sums, up to 1.3e-4 here), sstats rtol 1e-4
    of the largest entry, the score rel 1e-4; bf16 after one
    (tests/test_torch_bf16.py: gamma and the score rel 1e-5)."""
    counts, g0, eeb, alpha = _dense_case()
    sweeps = 12 if compute_dtype == "float32" else 1
    kw = dict(inner_iterations=sweeps, convergence_threshold=0.0,
              compute_dtype=compute_dtype)
    g, ss, tok, s = dense_mod.dense_estep(_t(counts), _t(g0), _t(eeb),
                                          _t(alpha), **kw)
    g_j, ss_j, tok_j, s_j = (np.asarray(x) for x in jax_dense(
        jnp.asarray(counts), jnp.asarray(g0), jnp.asarray(eeb),
        jnp.asarray(alpha), **kw))
    assert int(s) == int(s_j) == sweeps
    if compute_dtype == BF16:
        assert _rel(g.numpy(), g_j) <= 1e-5
        assert float(tok) == pytest.approx(float(tok_j), rel=1e-5)
        return
    np.testing.assert_allclose(g.numpy(), g_j, rtol=GAMMA_TOL, atol=1e-5)
    np.testing.assert_allclose(ss.numpy(), ss_j, rtol=RTOL,
                               atol=RTOL * np.abs(ss_j).max())
    assert float(tok) == pytest.approx(float(tok_j), rel=RTOL)


@pytest.mark.parametrize("compute_dtype", MODES)
def test_dense_sstats_wide_matches_xla_topic_range(compute_dtype):
    """The full call and a topic range across the 4096 boundary against
    the XLA function's rows: rtol 2e-5; the range's rows are the full
    call's rows and its score the full score."""
    counts, et, eeb = _sstats_case()
    ct = _t(counts).to(torch.bfloat16)
    ss, tok = sstats_mod.dense_sstats(ct, _t(et), _t(eeb),
                                      compute_dtype=compute_dtype)
    part, tok_r = sstats_mod.dense_sstats(ct, _t(et), _t(eeb),
                                          compute_dtype=compute_dtype,
                                          topic_range=(1000, 4200))
    ss_j, tok_j = jax_dense_sstats(jnp.asarray(counts), jnp.asarray(et),
                                   jnp.asarray(eeb),
                                   compute_dtype=compute_dtype)
    ss_j = np.asarray(ss_j)
    np.testing.assert_allclose(ss.numpy(), ss_j, rtol=2e-5,
                               atol=1e-6 * np.abs(ss_j).max())
    assert float(tok) == pytest.approx(float(tok_j), rel=2e-5)
    assert part.shape == (3200, 200)
    torch.testing.assert_close(part, ss[1000:4200], rtol=0, atol=0)
    assert float(tok_r) == float(tok)


# -- the kernels' arithmetic orders, emulated -------------------------------------

def _group_dot(prod, unit, lanes):
    """A lane group's phinorm dot of each entry over its slice, as the
    cluster kernel sums it: prod [m, units16, unit] (a 16-byte unit's
    products); lane g of ``lanes`` takes units g, g + lanes, .. into four
    running sums (a bf16 unit of 8 topics feeds them twice), (a0 + a1) +
    (a2 + a3), then the butterfly over the group."""
    m, units, _ = prod.shape
    per_lane = -(-units // lanes)
    pad = torch.zeros((m, per_lane * lanes, unit), dtype=prod.dtype)
    pad[:, :units] = prod
    parts = pad.reshape(m, per_lane, lanes, unit // 4, 4)
    a = torch.zeros((m, lanes, 4), dtype=prod.dtype)
    for j in range(per_lane):
        for h in range(unit // 4):
            a = a + parts[:, j, :, h, :]
    x = (a[..., 0] + a[..., 1]) + (a[..., 2] + a[..., 3])
    idx = torch.arange(lanes)
    off = lanes // 2
    while off:
        x = x + x[..., idx ^ off]
        off //= 2
    return x[..., 0]


def _block_sum(v):
    """The CTA's sum of v over its topics: thread tid's topics tid, tid +
    256, .. in order, the butterfly over a warp's lanes, then the 8 warps
    in order (block_sum2)."""
    m_count = max(1, -(-v.numel() // THREADS))
    pad = torch.zeros(m_count * THREADS, dtype=v.dtype)
    pad[:v.numel()] = v
    per = pad.reshape(m_count, THREADS)
    tot = torch.zeros(THREADS, dtype=v.dtype)
    for m in range(m_count):
        tot = tot + per[m]
    w = _butterfly(tot.reshape(WARPS, LANES))
    s = torch.zeros((), dtype=v.dtype)
    for i in range(WARPS):
        s = s + w[i]
    return s


def _cluster_sweep_row(ids, cnts, eeb, alpha, eps, compute_dtype, cluster,
                       resident, window, direct=False):
    """One row's sweep in the cluster kernel's order (cluster CTAs of a
    slice of ks topics each, the row's first ``resident`` live entries one
    window, the rest in windows of ``window``): per window each CTA's
    partial phinorm (``_group_dot`` over its slice, by
    ``rfp.entry_lanes`` lanes), the partials summed in rank order, the
    ratio, and step B into G = 256 / (ks / 4) group sums
    (entry t of a window into group t mod G; one in a ``direct`` plan);
    gamma' from the groups summed in order; |dgamma| summed a CTA
    (``_block_sum``), then over the ranks in order."""
    rnd = bf16_round if compute_dtype == BF16 else (lambda x: x)
    k = eeb.shape[0]
    unit = 8 if compute_dtype == BF16 else 4
    ks = -(-(-(-k // cluster)) // unit) * unit
    nq = ks // 4
    groups = THREADS // nq if nq < THREADS and not direct else 1
    width = cluster * ks
    lanes = rfp.entry_lanes(ks // unit)

    def sweep_row(d, et, g):
        live = cnts[d] != 0
        c = cnts[d][live]
        n = c.numel()
        B = torch.zeros((n, width), dtype=et.dtype)
        B[:, :k] = rnd(eeb.T[ids[d][live]])
        e = torch.zeros(width, dtype=et.dtype)
        e[:k] = rnd(et[0])
        nr = min(n, resident)
        wins = ([(0, nr)] if nr else []) + [
            (t0, min(window, n - t0)) for t0 in range(nr, n, window)]
        acc = torch.zeros((groups, width), dtype=et.dtype)
        for t0, m in wins:
            Bw = B[t0:t0 + m]
            ph = torch.zeros(m, dtype=et.dtype)
            for r in range(cluster):
                sl = slice(r * ks, (r + 1) * ks)
                prod = (Bw[:, sl] * e[sl]).reshape(m, ks // unit, unit)
                ph = ph + _group_dot(prod, unit, lanes)
            ratio = rnd(c[t0:t0 + m] / (ph + eps))
            for t in range(m):
                acc[t % groups] = acc[t % groups] + ratio[t] * Bw[t]
        a = torch.zeros(width, dtype=et.dtype)
        for gg in range(groups):
            a = a + acc[gg]
        x = alpha + et[0] * a[:k]
        dx = (x - g[0]).abs()
        tot = torch.zeros((), dtype=et.dtype)
        for r in range(cluster):
            tot = tot + _block_sum(dx[r * ks:(r + 1) * ks])
        return x[None], tot / k

    return sweep_row


def _row_major_cluster(sweep_row, g0, inner, threshold, patience):
    """The kernels' row-major schedule (tests/test_torch_row_schedule.py)
    with the cluster kernel's sweep: (gamma, S*)."""
    use_stall = patience > 0 and threshold > 0.0

    def run(d, max_sweeps, count):
        g = g0[d:d + 1]
        et = exp_dirichlet_expectation(g)
        best = torch.full((1,), float("inf"), dtype=g.dtype)
        age = torch.zeros((1,), dtype=torch.int32)
        done = torch.zeros((1,), dtype=torch.bool)
        s = 0
        while s < max_sweeps:
            g_new, change = sweep_row(d, et, g)
            best, age, done, exitable = _exit_update(
                change[None], best, age, done, threshold, use_stall, patience)
            if count is not None and not bool(exitable):
                count[s] += 1
            g, et = g_new, exp_dirichlet_expectation_fast(g_new)
            s += 1
            if bool(done):
                break
        return g[0], s

    not_exitable = [0] * inner
    first = [run(d, inner, not_exitable) for d in range(g0.shape[0])]
    s_star = next((s + 1 for s, n in enumerate(not_exitable) if n == 0), inner)
    gamma = torch.stack([g if s <= s_star else run(d, s_star, None)[0]
                         for d, (g, s) in enumerate(first)])
    return gamma, s_star


@pytest.mark.parametrize("dtype,compute_dtype,threshold,cluster,direct", [
    (torch.float64, "float32", 1e-3, rfp.CLUSTER, False),
    (torch.float64, BF16, 1e-3, rfp.CLUSTER, False),
    (torch.float32, "float32", 0.0, rfp.CLUSTER, False),
    (torch.float32, BF16, 0.0, rfp.CLUSTER, False),
    (torch.float64, "float32", 1e-3, rfp.MAX_CLUSTER, True),
    (torch.float32, BF16, 0.0, rfp.MAX_CLUSTER, True)],
    ids=["f64_exit", "f64_bf16_exit", "f32_pinned", "f32_bf16_pinned",
         "f64_direct_exit", "f32_bf16_direct_pinned"])
def test_cluster_sweep_order_matches_batch(dtype, compute_dtype, threshold,
                                           cluster, direct):
    """The cluster kernel's sweep under the row-major schedule against the
    batch fixed point, at 8 CTAs a row with 5 resident entries and
    windows of 3 (rows of 4 to 12 live entries: one resident window, or
    it and 1 to 3 streamed ones), and as a direct plan at 16 CTAs (no
    resident entries, one group sum: 16 CTAs of 264 topics would
    otherwise take 3): in float64 at the exit rule (threshold 1e-3,
    patience 6) the same S* and gamma to 1e-12; in float32 at 4 pinned
    sweeps, rtol 1e-5 (the orders differ by float32 reassociation
    only)."""
    ids, cnts, g0, eeb, alpha = _ragged_case(D=6, T=12, V=200, seed=2)
    ids, cnts = torch.tensor(ids), torch.tensor(cnts, dtype=dtype)
    g0, alpha = torch.tensor(g0, dtype=dtype), torch.tensor(alpha, dtype=dtype)
    eeb = torch.tensor(eeb, dtype=dtype)
    inner = 30 if threshold else 4
    patience = 6 if threshold else 0
    want, sweeps = estep_ragged_gamma(
        ids, cnts, g0, eeb, alpha, inner_iterations=inner,
        convergence_threshold=threshold, stall_patience=patience,
        compute_dtype=compute_dtype)
    got, s_star = _row_major_cluster(
        _cluster_sweep_row(ids, cnts, eeb, alpha, 1e-30, compute_dtype,
                           cluster, 0 if direct else 5, 3, direct), g0,
        inner, threshold, patience)
    assert s_star == int(sweeps)
    if threshold:
        assert s_star < inner
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(got, want, rtol=rtol, atol=0.0)


def _dense_tile_case(D=24, V=40, seed=4):
    """Counts dense enough that a tile holds several batches of 8."""
    rng = np.random.default_rng(seed)
    counts = ((rng.random((D, V)) < 0.6)
              * rng.integers(1, 4, (D, V))).astype(np.float32)
    counts = np.pad(counts, ((0, 0), (0, 8)))
    gamma = rng.gamma(100.0, 0.01, (D, K)).astype(np.float32)
    lam = rng.gamma(100.0, 0.01, (K, V)).astype(np.float32)
    et = np.asarray(jd.exp_dirichlet_expectation(jnp.asarray(gamma)))
    eeb = np.asarray(jd.exp_dirichlet_expectation(jnp.asarray(lam)))
    return counts, et, eeb


@pytest.mark.parametrize("dtype,compute_dtype,batch", [
    (torch.float64, "float32", None), (torch.float64, BF16, None),
    (torch.float32, "float32", None), (torch.float32, BF16, None),
    (torch.float64, "float32", 8), (torch.float32, BF16, 8)],
    ids=["f64-float32", "f64-bfloat16", "f32-float32", "f32-bfloat16",
         "f64-float32-batches", "f32-bfloat16-batches"])
def test_wide_sstats_order_matches_batch(dtype, compute_dtype, batch):
    """The cluster kernel's order at its plan for K = 4224 (16 CTAs of 288
    topics: the 15th holds 192, the 16th none; 32 columns a tile) against
    ``estep_dense_sstats`` (float64: rtol 1e-12; float32: 1e-5 with atol
    1e-5 max|ref|; the score rel 1e-5), and a topic range across slice
    boundaries bitwise the full call's rows.  With ``batch`` 8, counts
    dense enough that every tile runs several batches, which change no
    bit."""
    if batch:
        counts, et, eeb = _dense_tile_case()
    else:
        counts, et, eeb = _sstats_case(D=10, V=40, seed=9, v_pad=8)
    counts, et, eeb = (torch.tensor(x, dtype=dtype) for x in (counts, et, eeb))
    pl = sstats_mod.plan(*counts.shape, K, 132)
    assert (pl.cluster, pl.slice, pl.cols) == (16, 288, 32) and not pl.direct
    want, score_w = estep_dense_sstats(counts, et, eeb,
                                       compute_dtype=compute_dtype)
    got, score = _wide_sstats(counts, et, eeb, 1e-30, 0, K, compute_dtype,
                              pl, batch)
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=rtol * float(want.abs().max()))
    assert float(score) == pytest.approx(float(score_w), rel=rtol)
    part, _ = _wide_sstats(counts, et, eeb, 1e-30, 1000, 4200, compute_dtype,
                           pl, batch)
    torch.testing.assert_close(part, got[1000:4200], rtol=0, atol=0)
    if batch:
        tiles = [_wide_entries(counts, t, pl.cols)[0].shape[0]
                 for t in range(pl.tiles)]
        assert min(tiles) > 2 * batch
        one, score_one = _wide_sstats(counts, et, eeb, 1e-30, 0, K,
                                      compute_dtype, pl, max(tiles))
        torch.testing.assert_close(one, got, rtol=0, atol=0)
        assert float(score_one) == float(score)


# -- the plans and the scratch ------------------------------------------------------


# (K, counts bytes) -> (slice, columns a tile, batch, shared memory a CTA,
# direct), every plan at 16 CTAs a cluster.
_WIDE_PLANS = {
    (4100, 2): (288, 32, 128, 230928, False),
    (5000, 2): (320, 32, 116, 228592, False),
    (8192, 2): (512, 32, 76, 224560, False),
    (8192, 4): (512, 32, 68, 230512, False),
    (16384, 2): (1024, 16, 44, 227888, False),
    (16385, 2): (1028, 32, 256, 119312, True),
}


@pytest.mark.parametrize("k,count_bytes", list(_WIDE_PLANS),
                         ids=[f"{k}-{b}" for k, b in _WIDE_PLANS])
def test_sstats_plan_above_4096(k, count_bytes):
    """The cluster kernel's plan at config 5's first chunk ([1216, 100352]
    counts, 182,065 nonzeros), worked by hand at K = 8192 with bf16
    counts: 16 CTAs a cluster, slice 8192 / 16 = 512 topics (16 whole
    32-row boxes, a lane's 16 rows x 4 columns), 32 columns a tile (128
    bytes of a row), 3,136 tiles.  A CTA's shared memory: the slice tile
    512 x 32 x 4 = 65,536 bytes (expElogbeta resident for the tile), the
    counts ring 3 x 128 x 32 x 2 = 24,576 (a CTA walks 1216 / 16 = 76
    rows of a tile: one chunk), its pushed nonzeros 8 x 160 = 1,280, the
    push area 8 x 16 x 161 = 20,608, 144 fixed, 1,024 to align, and a
    nonzero of the batch 512 x 4 = 2,048 (its expEtheta slice) + 4 x 4 +
    8 + 2 x 16 x 8 = 2,328, the first 32 slices in the tile's buffer:
    (232,448 - 113,168 + 65,536) / 2,328 = 79.4, so 76 (a multiple of
    4), 224,560 bytes; the tile's ~58 nonzeros at this density (182,065
    / 3,136) take one batch (a tile past 76 runs batches of 38).  f32
    counts (a 49,152-byte ring): 68.
    Slices past 512 topics take 16 columns (K = 16384: 1,024 topics),
    past 1,024 the direct plan (32 columns, the slice rounded up to 4
    topics, batches of 256, nothing staged).  The scratch: a f64 score
    part a tile and one counter.  A topic range plans the same."""
    slice_, cols, batch, smem, direct = _WIDE_PLANS[(k, count_bytes)]
    pl = sstats_mod.plan(1216, 100352, k, 132, count_bytes=count_bytes)
    assert pl.wide and (pl.cluster, pl.splits) == (16, 1)
    assert (pl.slice, pl.cols, pl.batch, pl.smem_bytes, pl.direct) == (
        slice_, cols, batch, smem, direct)
    assert pl.tiles == 100352 // cols and pl.kp == 16 * slice_ >= k
    assert pl.smem_bytes <= sstats_mod.SMEM_LIMIT
    assert pl.scratch_bytes == 8 * pl.tiles + 4
    if not direct:
        assert slice_ % sstats_mod.WIDE_BOX == 0 and batch >= 2 * cols
        assert slice_ * cols <= 32 * 8 * sstats_mod.WIDE_LANE_FLOATS
        assert sstats_mod.wide_smem_bytes(slice_, batch + 4, 16, count_bytes,
                                          cols) > sstats_mod.SMEM_LIMIT
    if (k, count_bytes) == (8192, 2):
        assert 182065 / pl.tiles < batch
    rng = sstats_mod.plan(1216, 100352, k, 132, (k // 2, k),
                          count_bytes=count_bytes)
    assert rng == pl
    assert not sstats_mod.plan(100, 1000, 256, 132).wide


def test_wide_batches_counts_the_kernels_batches():
    """``wide_batches`` at K = 8192 (batches of 76, 16 CTAs sharing D =
    320 rows, 20 each): a tile of 76 nonzeros runs one batch, of 77 three
    of 38 (half as many, the slots' two halves in turn), a tile where a
    CTA's share holds 640 nonzeros (more than WIDE_PUSH_CAP = 160: every
    CTA walks the tile) nine of 76, an empty tile none."""
    pl = sstats_mod.plan(320, 128, 8192, 132)
    assert (pl.cluster, pl.cols, pl.batch, pl.tiles) == (16, 32, 76, 4)
    c = torch.zeros(320, 128)
    c[:76, 0] = 1
    c[:77, 32] = 1
    c[:20, 64:96] = 1
    assert sstats_mod.WIDE_PUSH_CAP < 640
    assert sstats_mod.wide_batches(c, pl) == 1 + 3 + 9


# (K, compute_dtype) -> (cluster, slice, resident, window, windows a sweep,
# bytes) at config 5's widest rows (the 256-wide bucket of chip_smoke.py's
# wide_k_kernels) and its 30 inner sweeps.
_CLUSTER_PLANS = {
    (4100, "float32"): (8, 516, 32, 31, 9, 202848),
    (4100, BF16): (16, 264, 256, 0, 1, 175888),
    (5000, "float32"): (8, 628, 25, 26, 10, 203328),
    (5000, BF16): (8, 632, 48, 51, 6, 203712),
    (8192, "float32"): (8, 1024, 14, 16, 17, 202256),
    (8192, BF16): (8, 1024, 26, 32, 9, 203344),
    (16384, "float32"): (8, 2048, 5, 8, 33, 197616),
    (16384, BF16): (8, 2048, 9, 16, 17, 202256),
}


@pytest.mark.parametrize("k,compute_dtype", list(_CLUSTER_PLANS),
                         ids=[f"{k}-{c}" for k, c in _CLUSTER_PLANS])
def test_cluster_plan_above_4096(k, compute_dtype):
    """The cluster kernel's plan, worked by hand.  At K = 8192 float32 a
    row of 256 entries does not stay resident at 16 CTAs (2 KB an entry),
    so the plan takes 8: the slice is 8192 / 8 = 1024 topics (4096 bytes
    an entry); its state is expEtheta, gamma and G = 256 / 256 = 1 group
    sum, 4 x 1024 x 3 = 12288 bytes (bf16: the rounded copy too); the
    histogram 4 x 32, the fixed parts 208 + 16 x 8 (the pair exchange); a
    window is 65536 / 4096 = 16 entries, its ratios 4 bytes an entry and
    the partial exchange 2 x 8 x 4 = 64, the ring 2 x 16 x 4096 = 131072,
    so 144912 bytes without resident entries, and R the most that leave
    the total within 204800: 14 (202256; 15 would need 206352).  A row of
    256 entries then takes 1 + ceil(242 / 16) = 17 windows a sweep.  At
    K = 4100 in bf16 a row stays resident at 16 CTAs (no ring, one window
    a sweep, 528 bytes an entry), so the plan takes 16; at 4100 and 5000
    the last slice is short (4100 - 7 x 516 = 488 topics)."""
    (cluster, slice_, resident, window, windows,
     nbytes) = _CLUSTER_PLANS[(k, compute_dtype)]
    pl = rfp.cluster_plan(k, 256, compute_dtype, inner_iterations=30)
    assert (pl.cluster, pl.slice, pl.resident, pl.window, pl.windows,
            pl.smem_bytes) == (cluster, slice_, resident, window, windows,
                               nbytes)
    assert pl.smem_bytes <= rfp.CLUSTER_SMEM_BUDGET
    bf16 = compute_dtype == BF16
    assert pl.slice % (8 if bf16 else 4) == 0
    assert (pl.cluster - 1) * pl.slice < k <= pl.cluster * pl.slice
    if pl.window:
        over = rfp.cluster_smem_bytes(pl.slice, pl.resident + 1, pl.window,
                                      30, bf16, pl.cluster)
        assert over > rfp.CLUSTER_SMEM_BUDGET
        assert rfp.cluster_plan(k, 256, compute_dtype, 30,
                                cluster=rfp.MAX_CLUSTER).window > 0


def test_cluster_plan_limits():
    """16 CTAs a row (a slice of 512 topics at K = 8192) keep more
    entries resident than 8; above 8 x 4096 topics the plan takes 16; a
    CTA keeps at most 4096 topics in shared memory, so past K = 65536 the
    plan is direct (``test_cluster_plan_direct``); the lanes an entry's
    partial phinorm takes (about eight 16-byte units a lane); the fields
    the launcher writes back."""
    assert not rfp.tiled(4096) and rfp.tiled(4097)
    assert [rfp.entry_lanes(u) for u in (1, 8, 9, 33, 64, 65, 128, 129,
                                         256, 1024)] == [
        1, 1, 2, 8, 8, 16, 16, 32, 32, 32]
    pl = rfp.cluster_plan(8192, 256, "float32", 30, cluster=16)
    assert (pl.slice, pl.window) == (512, 32)
    assert pl.resident > rfp.cluster_plan(8192, 256, "float32", 30).resident
    assert rfp.cluster_plan(40000, 256).cluster == rfp.MAX_CLUSTER
    top = rfp.cluster_plan(rfp.MAX_TOPICS, 16)
    assert top.slice == rfp.SLICE_TOPICS and not top.direct
    assert rfp.cluster_plan(rfp.MAX_TOPICS + 1, 16).direct
    with pytest.raises(ValueError):
        rfp.cluster_plan(8192, 16, cluster=rfp.MAX_CLUSTER + 1)
    fields = [f for f, _ in rfp.Params._fields_]
    assert {"state", "state_ctas", "seg", "nseg"} <= set(fields)
    assert set(rfp.GEOMETRY) <= set(fields)
    assert rfp.GEOMETRY[-5:] == ("cluster", "resident", "window", "windows",
                                 "clusters")


# K -> (slice, windows a sweep, state bytes a CTA) in float32 and bf16.
_DIRECT_PLANS = {
    65537: ((4100, 4, 49200), (4104, 4, 65664)),
    100000: ((6252, 4, 75024), (6256, 4, 100096)),
    1000000: ((62500, 4, 750000), (62504, 4, 1000064)),
}


@pytest.mark.parametrize("k", list(_DIRECT_PLANS))
def test_cluster_plan_direct(k):
    """Past K = 65536 the plan is direct, worked by hand at config 5's
    widest rows (256 entries) and 30 inner sweeps: 16 CTAs; the slice K /
    16 rounded up to 4 (bf16: 8) topics, past the 4096 a CTA keeps in
    shared memory; no entry resident and windows of 64, so 4 a sweep; in
    shared memory only the ratios (4 x 64), the partial exchange (2 x 16 x
    64 x 4 = 8192), the pair exchange (16 x 16), the histogram (4 x 32) and
    208 fixed bytes, 9040 in all; in the device scratch a CTA's state,
    expEtheta, gamma and one group sum (bf16: the rounded copy too), 4
    bytes a topic each."""
    for cd, (slice_, windows, state) in zip(MODES, _DIRECT_PLANS[k]):
        pl = rfp.cluster_plan(k, 256, cd, inner_iterations=30)
        assert pl.direct and (pl.cluster, pl.slice, pl.resident, pl.window,
                              pl.windows, pl.smem_bytes) == (
            rfp.MAX_CLUSTER, slice_, 0, rfp.DIRECT_WINDOW, windows, 9040), cd
        assert rfp.cluster_state_bytes(pl.slice, cd == BF16, True) == state
        assert (pl.cluster - 1) * pl.slice < k <= pl.cluster * pl.slice
    assert rfp.cluster_plan(k, 10).windows == 1


# -- the engines and the CLI ------------------------------------------------------

ENGINE = dict(number_of_topics=K, doc_pad_multiple=8, inner_iterations=6,
              convergence_threshold=0.0, hyper_parameter_optimize_interval=2,
              seed=0)
ROUTES = {"ragged": dict(dense_vocab_threshold=16), "dense": {}}


@pytest.fixture(scope="module")
def data():
    kw = dict(num_docs=40, num_topics=8, num_types=60, mean_doc_length=20.0,
              seed=3)
    return dict(corpus=synthetic_corpus(**kw)[0], corpus_j=jax_synthetic(**kw)[0],
                lam0=np.random.default_rng(11).gamma(100.0, 0.01, (K, 60)))


@pytest.mark.parametrize("scatter", [False, True],
                         ids=["dense_sstats", "scatter"])
def test_ragged_launch_rows_follow_the_device(data, scatter):
    """``estep_memory_budget_mb`` caps a ragged batch's rows only where
    [rows, T, K] arrays are made: on the CPU (the JAX engine's batches,
    shape for shape) and on the scatter route; on the card with dense
    sufficient statistics each bucket is one launch, the same rows."""
    from pylda_tpu.models import layouts as jax_layouts

    from pylda_tpu_torch.models import layouts

    assert layouts.chunks_ragged_rows("cpu", scatter)
    assert layouts.chunks_ragged_rows("cuda", scatter) == scatter
    cfg = {**ENGINE, **ROUTES["ragged"], "estep_memory_budget_mb": 1,
           "sstats_mode": "scatter" if scatter else "auto"}
    eng = VariationalBayes(LDAConfig(**cfg), device="cpu")
    eng.initialize(data["corpus"], lam_init=data["lam0"])
    theirs = jax_layouts.build_vb_batches(data["corpus_j"], JaxConfig(**cfg))
    assert [tuple(b.ids.shape) for b in eng._batches] == [
        tuple(b.ids.shape) for b in theirs]
    chunked = layouts.build_vb_batches(data["corpus"], LDAConfig(**cfg))
    whole = layouts.build_vb_batches(data["corpus"], LDAConfig(**cfg),
                                     chunk_ragged=False)
    widths = [b.ids.shape[1] for b in whole]
    assert len(widths) == len(set(widths)) < len(chunked)
    for w in widths:
        np.testing.assert_array_equal(
            np.concatenate([b.ids for b in chunked if b.ids.shape[1] == w]),
            next(b.ids for b in whole if b.ids.shape[1] == w))


def _assert_state_close(ours, theirs):
    for f in ("lam", "alpha", "eta"):
        np.testing.assert_allclose(
            getattr(ours.state, f).numpy(),
            np.asarray(getattr(theirs.state, f)), rtol=RTOL,
            atol=LAM_ATOL if f == "lam" else 0.0, err_msg=f)


@pytest.mark.parametrize("route", ["ragged", "dense"])
def test_vb_wide_matches_jax(data, route):
    """Batch VB at K = 4224, 6 pinned sweeps, 2 iterations (a hyper
    update at the second) from one lambda: ELBOs rel 1e-4, lambda rtol
    1e-4 (atol 1e-4), alpha and eta rtol 1e-4, gamma 5e-4."""
    cfg = {**ENGINE, **ROUTES[route]}
    ours = VariationalBayes(LDAConfig(**cfg), device="cpu")
    ours.initialize(data["corpus"], lam_init=data["lam0"])
    theirs = JaxVB(JaxConfig(**cfg))
    theirs.initialize(data["corpus_j"], lam_init=data["lam0"])
    assert (ours._sstats_plan is not None) == (route == "ragged")
    e = [ours.learning() for _ in range(2)]
    e_j = [theirs.learning() for _ in range(2)]
    np.testing.assert_allclose(e, e_j, rtol=RTOL)
    _assert_state_close(ours, theirs)
    np.testing.assert_allclose(ours.gamma, np.asarray(theirs.gamma),
                               rtol=GAMMA_TOL, atol=GAMMA_TOL)


def test_svi_wide_matches_jax(data):
    """SVI at K = 4224 on the ragged route, minibatches of 16, 6 pinned
    sweeps, one epoch from one lambda: the estimates rel 1e-4, lambda
    rtol 1e-4 (atol 1e-4)."""
    cfg = {**ENGINE, **ROUTES["ragged"], "inference_mode": "svi",
           "batch_size": 16, "tau0": 16.0, "kappa": 0.7}
    ours = StochasticVariationalBayes(LDAConfig(**cfg), device="cpu")
    ours.initialize(data["corpus"], lam_init=data["lam0"])
    theirs = JaxSVI(JaxConfig(**cfg))
    theirs.initialize(data["corpus_j"], lam_init=data["lam0"])
    np.testing.assert_allclose(ours.learning(), theirs.learning(), rtol=RTOL)
    _assert_state_close(ours, theirs)


def test_cli_train_then_test_wide(tmp_path):
    """The CLI at K = 4224 on the bundled corpus: 2 iterations of 5
    sweeps, then the test CLI on the model file: a finite perplexity."""
    out = tmp_path / "out"
    rc = train_main([
        f"--input_directory={bundled_corpus_dir()}",
        f"--output_directory={out}", f"--number_of_topics={K}",
        "--training_iterations=2", "--snapshot_interval=2",
        "--inner_iterations=5", "--seed=1", "--device=cpu"])
    assert rc == 0
    (run,) = glob.glob(os.path.join(out, "*", "*"))
    model = os.path.join(run, "model-2")
    assert os.path.exists(model) or glob.glob(model + "*")
    result = tmp_path / "gamma.out"
    rc = cli_test_main([f"--model={model}",
                        f"--input_directory={bundled_corpus_dir()}",
                        f"--output_file={result}", "--point_estimate",
                        "--device=cpu"])
    assert rc == 0
    gamma = np.loadtxt(result)
    assert gamma.shape[1] == K and np.isfinite(gamma).all()
