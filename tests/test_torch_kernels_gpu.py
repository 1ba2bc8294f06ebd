"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without a CUDA device every test here skips (decided in
the ``cuda`` fixture, never at import).  On a machine with an H100:

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Shapes are odd and padded on purpose (rows, vocab, topics and token slots
off every tile size).  Tolerances: the sums run in another order in the
kernel than in cuBLAS, so sstats agree to rtol 1e-4 (+1e-6 of the largest
entry) and the score to rel 1e-5; at pinned sweeps gamma agrees to rtol
1e-4 (atol 1e-4); with the exit rule active, to rtol 5e-4 with the sweep
count within +-1 and an atol of 5e-4 + K * threshold: a row whose change
sits at the threshold may freeze a sweep apart in the two versions, and
that sweep moves it by at most K * threshold in sum_k |dgamma|.  The dense
E-step's token score, taken at a gamma within those tolerances, agrees to
rel 1e-4.  The sufficient-statistics kernel works at nonzero counts only:
its cases span densities 0 to 100%, a column every row uses, a row with
every column nonzero, many row splits a tile, Vc >> V, K in {1, 32, 100,
256} and bf16 counts up to 256, and each checks that two calls return
the same bits.  Both gamma kernels run row after row (``csrc/row_fixed_point.cuh``):
cases here also take the re-run of rows past S* and rows longer than the
shared-memory slot buffer (166 slots at K=100, 63 at K=256), which stream
their compacted entries in windows from a scratch list.  The wide range
(K in {257, 1000, 1024, 1025, 2048, 4096}: the core's wide kernels, whose
slot buffer holds ~25 entries at K=1000 and 4 at K=4096, and the sstats
builds of 8, 16 and 32 lanes a column) is held the same way, with rows on
both sides of the slot buffer, bf16 and f32 counts and two calls bitwise
equal.  Above 4096 (the gamma kernels' cluster kernel, the sstats
kernel's cluster kernel, also at K = 16384 and at K off a multiple of
4 or past 16384 (its direct plan), on dense counts, in its direct plan
bitwise and with no host sync) each kernel and build is held
the same way at K in {4100, 8192} (``LARGE_K``), with rows all resident,
partly resident and all streamed, the topic range bitwise, and SVI at
K = 4097 trains on the card.  A whole bucket whose rows fall into
segments (the chunks the CPU's layout makes) ends each at its own S*:
held per segment against the plain version and, through the engine,
against the CPU's chunked run.  On rows still updating at S*
(stalled, not done) gamma depends on rounding, so there each document's
share of the bound (``ragged_doc_bound``) at the kernel's gamma is held
to its share at the float64 plain version's gamma, to rel 1e-5.  The
bf16 warp-group kernel (K <= 256, ``csrc/row_fixed_point_groups.cuh``)
is held at K in ``GROUP_K`` on rows up to a group's capacity and one
past it, its exit records against the plain loop's rule on its own
trajectory.  The bf16 build's tensor-core sstats kernel (K <= 256,
``csrc/dense_sstats_mma.cuh``) is held at K in ``MMA_K`` and densities 0
to 100% by the bf16 hold, two calls bitwise and its launch counters, with
topic ranges off its 16-topic tiles bitwise the full launch's rows.  The
sampling engines (plain PyTorch, no kernel) are held here too: each
sampler's sweep on the card against the CPU from the same noise (z equal
but on at most 0.1% of the documents), count tables bitwise, and both
engines on the card conserving counts and launching no kernel.  The
random gamma inits drawn on the card are held by their statistics (mean
1 and std 0.1 within 0.005 at 10^6 draws) and repeat bit for bit from
one seed, and ``phase_timings`` on the card (CUDA events) leaves every
engine's state bitwise as it was.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pylda_tpu_torch.ops import dense_estep as dense_mod
from pylda_tpu_torch.ops import ragged as ragged_mod
from pylda_tpu_torch.ops import row_fixed_point as rfp
from pylda_tpu_torch.ops import sstats as sstats_mod
from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation
from pylda_tpu_torch.ops.estep import (
    estep_dense,
    estep_dense_sstats,
    estep_ragged_gamma,
    ragged_doc_bound,
)

# The wide range: the core's wide kernels and the sstats cluster kernel's
# clusters of 1, 2, 4 and 8 CTAs, at each edge.
WIDE_K = [257, 1000, 1024, 1025, 2048, 4096]
# Above it: the cluster gamma kernel and the sstats kernel's cluster kernel.
LARGE_K = [4100, 8192]

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _sstats_inputs(D, V, K, v_pad, pad_rows, bf16, dev, seed=0):
    rng = np.random.default_rng(seed)
    counts = rng.poisson(0.05, size=(D, V)).astype(np.float32)
    counts = np.pad(counts, ((0, pad_rows), (0, v_pad)))
    gamma = rng.gamma(100.0, 0.01, size=(D + pad_rows, K))
    lam = rng.gamma(1.0, 1.0, size=(K, V))
    ct = torch.tensor(counts, device=dev)
    if bf16:
        ct = ct.to(torch.bfloat16)
    et = exp_dirichlet_expectation(torch.tensor(gamma, device=dev).float())
    eeb = exp_dirichlet_expectation(torch.tensor(lam, device=dev).float())
    return ct, et, eeb


@pytest.mark.parametrize(
    "D,V,K,v_pad,pad_rows,bf16",
    [
        (37, 333, 7, 0, 0, False),
        (96, 640, 7, 384, 32, True),
        (200, 1000, 32, 24, 8, False),
        (129, 2000, 100, 48, 63, True),
        (64, 515, 200, 61, 0, True),  # K > 128: the 64-topics-a-thread path
    ],
)
def test_dense_sstats_kernel_matches_plain(cuda, D, V, K, v_pad, pad_rows,
                                           bf16):
    ct, et, eeb = _sstats_inputs(D, V, K, v_pad, pad_rows, bf16, cuda)
    before = sstats_mod.LAUNCHES
    ss, tok = sstats_mod.dense_sstats(ct, et, eeb)
    assert sstats_mod.LAUNCHES == before + 1
    ss_p, tok_p = estep_dense_sstats(ct, et, eeb)
    torch.cuda.synchronize()
    assert ss.shape == (K, V)
    tol = 1e-4 * ss_p.abs() + 1e-6 * ss_p.abs().max()
    assert bool(((ss - ss_p).abs() <= tol).all()), float((ss - ss_p).abs().max())
    assert float(tok) == pytest.approx(float(tok_p), rel=1e-5)


def _sparse_sstats_inputs(D, V, K, v_pad, pad_rows, density, bf16, dev,
                          hot=False, full_row=False, max_count=4, seed=0):
    """Counts of a given density (1.0: every count nonzero) with values in
    [1, max_count], optionally a column every row uses and a row with
    every column nonzero; padding rows carry doc 0's expEtheta."""
    rng = np.random.default_rng(seed)
    counts = (rng.random((D, V)) < density) * rng.integers(
        1, max_count + 1, (D, V))
    if hot:
        counts[:, rng.integers(0, V)] = rng.integers(1, max_count + 1, D)
    if full_row:
        counts[rng.integers(0, D)] = rng.integers(1, max_count + 1, V)
    counts = np.pad(counts.astype(np.float32), ((0, pad_rows), (0, v_pad)))
    gamma = rng.gamma(100.0, 0.01, size=(D, K))
    lam = rng.gamma(1.0, 1.0, size=(K, V))
    ct = torch.tensor(counts, device=dev)
    if bf16:
        ct = ct.to(torch.bfloat16)
        assert bool((ct.float().cpu() == torch.tensor(counts)).all())
    et = exp_dirichlet_expectation(torch.tensor(gamma, device=dev).float())
    et = torch.cat([et, et[:1].repeat(pad_rows, 1)])
    eeb = exp_dirichlet_expectation(torch.tensor(lam, device=dev).float())
    return ct, et, eeb


# (D, V, K, v_pad, pad_rows, density, bf16, options): rows off every chunk
# and split, padding on both axes.
_SPARSE_SSTATS = [
    (300, 1000, 100, 24, 20, 0.0, True, {}),  # all-zero counts
    (517, 2000, 100, 48, 11, 0.012, True, {}),  # the ragged flagship's 1.2%
    (333, 1500, 100, 0, 0, 0.03, False, {}),  # the dense flagship's ~3%
    (70, 200, 100, 56, 0, 1.0, True, {}),  # every count nonzero
    (1000, 3000, 100, 72, 9, 0.012, True, dict(hot=True, full_row=True)),
    (4000, 640, 100, 0, 0, 0.02, True, {}),  # many row splits a tile
    (200, 100, 7, 4000, 0, 0.05, True, {}),  # Vc >> V
    (150, 500, 1, 12, 3, 0.03, False, dict(hot=True)),  # K = 1
    (129, 700, 256, 68, 5, 0.03, True, dict(full_row=True)),  # K = 256
    (97, 333, 256, 0, 0, 0.05, False, {}),  # K = 256, f32, unaligned rows
    (100, 400, 32, 0, 0, 0.05, True, dict(max_count=256)),  # bf16 to 256
    # An SVI minibatch block at config 4: 1024 gathered rows of the
    # [D+1, 50176] counts matrix, 0.3% nonzero, K = 200 padded to 256.
    (1024, 50000, 200, 176, 0, 0.003, True, dict(max_count=3)),
]


@pytest.mark.parametrize("D,V,K,v_pad,pad_rows,density,bf16,opts",
                         _SPARSE_SSTATS)
def test_dense_sstats_kernel_sparsity_cases(cuda, D, V, K, v_pad, pad_rows,
                                            density, bf16, opts):
    """Against the plain version at the tolerances above, and two calls on
    the same inputs give the same bits."""
    ct, et, eeb = _sparse_sstats_inputs(D, V, K, v_pad, pad_rows, density,
                                        bf16, cuda, **opts)
    before = sstats_mod.LAUNCHES
    ss, tok = sstats_mod.dense_sstats(ct, et, eeb)
    ss2, tok2 = sstats_mod.dense_sstats(ct, et, eeb)
    assert sstats_mod.LAUNCHES == before + 2
    ss_p, tok_p = estep_dense_sstats(ct, et, eeb)
    torch.cuda.synchronize()
    assert ss.shape == (K, V)
    assert torch.equal(ss, ss2) and torch.equal(tok, tok2)
    tol = 1e-4 * ss_p.abs() + 1e-6 * ss_p.abs().max()
    assert bool(((ss - ss_p).abs() <= tol).all()), float((ss - ss_p).abs().max())
    assert float(tok) == pytest.approx(float(tok_p), rel=1e-5)
    if density == 0.0:
        assert bool((ss == 0).all()) and float(tok) == 0.0


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", LARGE_K)
def test_dense_sstats_kernel_refuses_large_k(cuda, K, compute_dtype):
    """Above its largest build (K = 4096) the kernel no longer refuses: its
    cluster kernel against the plain version (float32: the tolerances above;
    bf16: its own mode, ``_hold_bf16_sstats``), a column every row uses
    and a row with every column nonzero, two calls bitwise equal, each
    topic range (across the 4096 boundary too) the full call's rows bit
    for bit, every call counted as a wide launch."""
    ct, et, eeb = _sparse_sstats_inputs(300, 700, K, 20, 3, 0.03, True,
                                        cuda, hot=True, full_row=True)
    mode = dict(compute_dtype=compute_dtype)
    bf16 = compute_dtype == "bfloat16"
    wide = "BF16_WIDE_LAUNCHES" if bf16 else "WIDE_LAUNCHES"
    before = getattr(sstats_mod, wide)
    ss, tok = sstats_mod.dense_sstats(ct, et, eeb, **mode)
    ss2, tok2 = sstats_mod.dense_sstats(ct, et, eeb, **mode)
    assert getattr(sstats_mod, wide) == before + 2
    ss_p, tok_p = estep_dense_sstats(ct, et, eeb, **mode)
    torch.cuda.synchronize()
    assert ss.shape == (K, 700)
    assert torch.equal(ss, ss2) and torch.equal(tok, tok2)
    if bf16:
        _hold_bf16_sstats(ss, ss_p)
    else:
        tol = 1e-4 * ss_p.abs() + 1e-6 * ss_p.abs().max()
        assert bool(((ss - ss_p).abs() <= tol).all())
    assert float(tok) == pytest.approx(float(tok_p), rel=1e-5)
    for k0, k1 in _topic_ranges(K) + [(1000, 4098)]:
        ss_r, tok_r = sstats_mod.dense_sstats(ct, et, eeb,
                                              topic_range=(k0, k1), **mode)
        torch.cuda.synchronize()
        assert torch.equal(ss_r, ss[k0:k1]) and torch.equal(tok_r, tok)


# The cluster kernel of the sufficient statistics above K = 4096: 16 CTAs a
# cluster, slices of 288, 512 and 1024 topics (32-column tiles, 16 at
# 16384).
CLUSTER_SSTATS_K = [4100, 8192, 16384]
# K off a multiple of 4 (4097: each expEtheta slice by plain loads, no bulk
# copy) and past slices of 1024 topics (16385, 65540: the direct plan, its
# slices rounded up to 4 topics, the last rank's short, more than 32 rows a
# lane).
ODD_SSTATS_K = [4097, 16385, 65540]


def _hold_sstats(ss, ss_p, compute_dtype):
    if compute_dtype == "bfloat16":
        _hold_bf16_sstats(ss, ss_p)
    else:
        tol = 1e-4 * ss_p.abs() + 1e-6 * ss_p.abs().max()
        assert bool(((ss - ss_p).abs() <= tol).all()), float(
            (ss - ss_p).abs().max())


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", CLUSTER_SSTATS_K)
def test_dense_sstats_cluster_kernel(cuda, K, compute_dtype):
    """The cluster kernel against the plain version (float32: the
    tolerances above; bf16: ``_hold_bf16_sstats``), the score rel 1e-5,
    two calls bitwise, one launch counted a call, on 600 rows (three
    counts chunks, the last short) and a vocabulary off the 16-column
    tile, f32 counts; and at V = 333 (rows of expElogbeta off 16 bytes:
    plain loads of the slice, element stores)."""
    mode = dict(compute_dtype=compute_dtype)
    wide = ("BF16_WIDE_LAUNCHES" if compute_dtype == "bfloat16"
            else "WIDE_LAUNCHES")
    for D, V, v_pad, bf16 in ((600, 700, 20, False), (130, 333, 3, True)):
        ct, et, eeb = _sparse_sstats_inputs(D, V, K, v_pad, 0, 0.03, bf16,
                                            cuda, hot=True)
        before = getattr(sstats_mod, wide)
        ss, tok = sstats_mod.dense_sstats(ct, et, eeb, **mode)
        ss2, tok2 = sstats_mod.dense_sstats(ct, et, eeb, **mode)
        assert getattr(sstats_mod, wide) == before + 2
        ss_p, tok_p = estep_dense_sstats(ct, et, eeb, **mode)
        torch.cuda.synchronize()
        assert ss.shape == (K, V)
        assert torch.equal(ss, ss2) and torch.equal(tok, tok2)
        _hold_sstats(ss, ss_p, compute_dtype)
        assert float(tok) == pytest.approx(float(tok_p), rel=1e-5)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", ODD_SSTATS_K)
def test_dense_sstats_cluster_kernel_odd_k(cuda, K, compute_dtype):
    """At ODD_SSTATS_K the plan the wrapper takes (direct past K = 16384)
    against the plain version (float32: the tolerances above; bf16:
    ``_hold_bf16_sstats_f64``), the score rel 1e-5, two calls bitwise
    equal and one launch counted a call, and a topic range across two
    slice boundaries bitwise the full call's rows."""
    mode = dict(compute_dtype=compute_dtype)
    wide = ("BF16_WIDE_LAUNCHES" if compute_dtype == "bfloat16"
            else "WIDE_LAUNCHES")
    ct, et, eeb = _sparse_sstats_inputs(300, 700, K, 20, 3, 0.03, True,
                                        cuda, hot=True, full_row=True)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    pl = sstats_mod.plan(*ct.shape, K, sms, count_bytes=2)
    assert pl.direct == (K > 16384) and pl.kp >= K
    before = getattr(sstats_mod, wide)
    ss, tok = sstats_mod.dense_sstats(ct, et, eeb, **mode)
    ss2, tok2 = sstats_mod.dense_sstats(ct, et, eeb, **mode)
    assert getattr(sstats_mod, wide) == before + 2
    ss_p, tok_p = estep_dense_sstats(ct, et, eeb, **mode)
    torch.cuda.synchronize()
    assert ss.shape == (K, 700)
    assert torch.equal(ss, ss2) and torch.equal(tok, tok2)
    if compute_dtype == "bfloat16":
        _hold_bf16_sstats_f64(ss, ss_p, ct, et, eeb)
    else:
        _hold_sstats(ss, ss_p, compute_dtype)
    assert float(tok) == pytest.approx(float(tok_p), rel=1e-5)
    del ss_p
    k0, k1 = pl.slice - 3, min(K, 2 * pl.slice + 5)
    ss_r, tok_r = sstats_mod.dense_sstats(ct, et, eeb, topic_range=(k0, k1),
                                          **mode)
    torch.cuda.synchronize()
    assert torch.equal(ss_r, ss[k0:k1]) and torch.equal(tok_r, tok)


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_dense_sstats_cluster_kernel_dense_counts(cuda, bf16):
    """Every count nonzero at D = 256, K = 8192: each tile holds 256
    nonzeros a column, more than a CTA pushes (each walks 16 rows: 512),
    so every CTA walks the whole tile's counts and runs many batches (80
    nonzeros each with bf16 counts, 68 with f32); against the plain
    version at the float32 tolerances and two calls bitwise."""
    ct, et, eeb = _sparse_sstats_inputs(256, 300, 8192, 20, 0, 1.0, bf16,
                                        cuda)
    pl = sstats_mod.plan(256, 320, 8192, torch.cuda.get_device_properties(
        cuda).multi_processor_count, count_bytes=ct.element_size())
    assert sstats_mod.wide_batches(ct, pl) >= 20 * pl.tiles
    assert 256 // 16 * 32 > sstats_mod.WIDE_PUSH_CAP
    ss, tok = sstats_mod.dense_sstats(ct, et, eeb)
    ss2, tok2 = sstats_mod.dense_sstats(ct, et, eeb)
    ss_p, tok_p = estep_dense_sstats(ct, et, eeb)
    torch.cuda.synchronize()
    assert torch.equal(ss, ss2) and torch.equal(tok, tok2)
    _hold_sstats(ss, ss_p, "float32")
    assert float(tok) == pytest.approx(float(tok_p), rel=1e-5)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_dense_sstats_cluster_kernel_direct_plan(cuda, compute_dtype):
    """The direct plan (the plan past K = 16384: expElogbeta and
    expEtheta read from device memory, raw summed in the output) at the
    default plan's cluster and slice at K = 8192: sstats and score bitwise
    the default plan's, the full call and a topic range; launched through
    ``sstats_mod.launch``, so no count moves."""
    from pylda_tpu_torch.ops import _build

    ct, et, eeb = _sparse_sstats_inputs(300, 700, 8192, 20, 3, 0.03, True,
                                        cuda, hot=True, full_row=True)
    lib = sstats_mod._lib(compute_dtype)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    pl = sstats_mod.plan(*ct.shape, 8192, sms, count_bytes=2)
    direct = dataclasses.replace(pl, direct=True)
    before = (sstats_mod.WIDE_LAUNCHES, sstats_mod.BF16_WIDE_LAUNCHES)
    for rng in (None, (1000, 5000)):
        geo = {}
        a = sstats_mod.launch(lib, ct, et, eeb, 1e-30, rng, plan_=pl)
        b = sstats_mod.launch(lib, ct, et, eeb, 1e-30, rng, plan_=direct,
                              geometry_out=geo)
        torch.cuda.synchronize()
        assert geo["direct"] and geo["clusters"] >= 1
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert (sstats_mod.WIDE_LAUNCHES, sstats_mod.BF16_WIDE_LAUNCHES) == before
    assert _build.library("dense_sstats", compute_dtype) is lib


@pytest.mark.parametrize("K", [1000, 8192])
def test_dense_sstats_cluster_kernel_makes_no_host_sync(cuda, K):
    """A call of the cluster kernel (at config 5's K = 1000, and above
    K = 4096) under ``set_sync_debug_mode("error")``: the wrapper sizes
    everything from shapes and reads nothing back, so no synchronizing
    operation raises; the result is then checked."""
    ct, et, eeb = _sparse_sstats_inputs(300, 700, K, 20, 3, 0.03, True,
                                        cuda, hot=True)
    sstats_mod.dense_sstats(ct, et, eeb)  # builds, binds and sizes scratch
    torch.cuda.synchronize()
    before = sstats_mod.WIDE_LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        ss, tok = sstats_mod.dense_sstats(ct, et, eeb)
        ss_r, tok_r = sstats_mod.dense_sstats(ct, et, eeb,
                                              topic_range=(0, K // 2))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert sstats_mod.WIDE_LAUNCHES == before + 2
    ss_p, tok_p = estep_dense_sstats(ct, et, eeb)
    _hold_sstats(ss, ss_p, "float32")
    assert torch.equal(ss_r, ss[:K // 2]) and torch.equal(tok_r, tok)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_dense_sstats_cluster_kernel_dense_batch(cuda, compute_dtype):
    """The dense flagship's density (~3% nonzero) at K = 1000 on 1,024
    rows: a CTA's share of a tile (512 rows x 32 columns, ~490 nonzeros)
    is past the push cap, so every CTA of the 2-CTA clusters walks the
    whole tile from device memory, in many batches; against the plain
    version (float32: the tolerances above; bf16: its own mode), two
    calls bitwise equal, one cluster launch a call, a topic range the
    full call's rows."""
    ct, et, eeb = _sparse_sstats_inputs(1024, 700, 1000, 20, 0, 0.03, True,
                                        cuda, hot=True, full_row=True)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    pl = sstats_mod.plan(*ct.shape, 1000, sms, count_bytes=2)
    assert (pl.cluster, pl.slice) == (2, 512)
    share = (ct[:512, :704] != 0).reshape(512, 22, 32).sum(dim=(0, 2))
    assert int(share.max()) > sstats_mod.WIDE_PUSH_CAP
    mode = dict(compute_dtype=compute_dtype)
    wide = ("BF16_WIDE_LAUNCHES" if compute_dtype == "bfloat16"
            else "WIDE_LAUNCHES")
    before = getattr(sstats_mod, wide)
    ss, tok = sstats_mod.dense_sstats(ct, et, eeb, **mode)
    ss2, tok2 = sstats_mod.dense_sstats(ct, et, eeb, **mode)
    assert getattr(sstats_mod, wide) == before + 2
    ss_p, tok_p = estep_dense_sstats(ct, et, eeb, **mode)
    torch.cuda.synchronize()
    assert torch.equal(ss, ss2) and torch.equal(tok, tok2)
    _hold_sstats(ss, ss_p, compute_dtype)
    assert float(tok) == pytest.approx(float(tok_p), rel=1e-5)
    ss_r, tok_r = sstats_mod.dense_sstats(ct, et, eeb, topic_range=(300, 700),
                                          **mode)
    torch.cuda.synchronize()
    assert torch.equal(ss_r, ss[300:700]) and torch.equal(tok_r, tok)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("K", WIDE_K)
def test_dense_sstats_kernel_wide_k(cuda, K, bf16, compute_dtype):
    """The cluster kernel at 256 < K <= 4096 (clusters of 1 to 8 CTAs, the
    plan's) in both builds against the plain version (float32: the
    tolerances above; bf16: its own mode), a column every row uses and a
    row with every column nonzero, rows off every chunk, two calls bitwise
    equal, each call one launch of the cluster kernel."""
    ct, et, eeb = _sparse_sstats_inputs(70, 300, K, 20, 3, 0.03, bf16, cuda,
                                        hot=True, full_row=True)
    mode = dict(compute_dtype=compute_dtype)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    pl = sstats_mod.plan(*ct.shape, K, sms, count_bytes=ct.element_size())
    assert pl.wide and pl.cluster == sstats_mod.wide_cluster(K)
    wide = ("BF16_WIDE_LAUNCHES" if compute_dtype == "bfloat16"
            else "WIDE_LAUNCHES")
    before = getattr(sstats_mod, wide)
    ss, tok = sstats_mod.dense_sstats(ct, et, eeb, **mode)
    ss2, tok2 = sstats_mod.dense_sstats(ct, et, eeb, **mode)
    assert getattr(sstats_mod, wide) == before + 2
    ss_p, tok_p = estep_dense_sstats(ct, et, eeb, **mode)
    torch.cuda.synchronize()
    assert torch.equal(ss, ss2) and torch.equal(tok, tok2)
    _hold_sstats(ss, ss_p, compute_dtype)
    assert float(tok) == pytest.approx(float(tok_p), rel=1e-5)


def _topic_ranges(K):
    """Each half of [0, K), and a range off the float4 boundaries."""
    half = K // 2 if K > 1 else 1
    out = [(0, half), (half, K)] if half < K else [(0, K)]
    if K >= 10:
        out.append((3, K - 5))
    return out


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [1, 7, 100, 200, 257, 1000, 1025, 4096])
def test_dense_sstats_kernel_topic_range(cuda, K, compute_dtype):
    """The topic-range launch (lambda split over topics): its rows are the
    full-range launch's rows bit for bit and its score the full score's
    bits; against the plain version's range at the tolerances above
    (float32) or its own bf16 mode; rows off every chunk, many splits."""
    ct, et, eeb = _sparse_sstats_inputs(1000, 300, K, 20, 3, 0.03, True,
                                        cuda, hot=True, full_row=True)
    mode = dict(compute_dtype=compute_dtype)
    ss, tok = sstats_mod.dense_sstats(ct, et, eeb, **mode)
    counter = ("BF16_RANGE_LAUNCHES" if compute_dtype == "bfloat16"
               else "RANGE_LAUNCHES")
    for k0, k1 in _topic_ranges(K):
        before = getattr(sstats_mod, counter)
        ss_r, tok_r = sstats_mod.dense_sstats(ct, et, eeb,
                                              topic_range=(k0, k1), **mode)
        assert getattr(sstats_mod, counter) == before + ((k0, k1) != (0, K))
        ss_p, _ = estep_dense_sstats(ct, et, eeb, topic_range=(k0, k1),
                                     **mode)
        torch.cuda.synchronize()
        assert ss_r.shape == (k1 - k0, 300)
        assert torch.equal(ss_r, ss[k0:k1]) and torch.equal(tok_r, tok)
        if compute_dtype == "float32":
            tol = 1e-4 * ss_p.abs() + 1e-6 * ss_p.abs().max()
            assert bool(((ss_r - ss_p).abs() <= tol).all())


def _ragged_inputs(D, T, K, V, dev, seed=0, lam_shape=1.0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (D, T)).astype(np.int32)
    cnts = rng.integers(1, 5, (D, T)).astype(np.float32)
    fill = rng.integers(1, T + 1, D)  # ragged rows: slots past fill are pads
    pad = np.arange(T)[None, :] >= fill[:, None]
    ids[pad], cnts[pad] = 0, 0.0
    ids[-3:], cnts[-3:] = 0, 0.0  # padded doc rows
    lam = rng.gamma(lam_shape, 1.0, (K, V))
    eeb = exp_dirichlet_expectation(torch.tensor(lam, device=dev).float())
    g0 = torch.ones((D, K), dtype=torch.float32, device=dev)
    alpha = torch.full((K,), 0.1, dtype=torch.float32, device=dev)
    return (torch.tensor(ids, device=dev), torch.tensor(cnts, device=dev),
            g0, eeb, alpha, int((cnts != 0).sum()))


@pytest.mark.parametrize(
    "D,T,K,V",
    [(37, 21, 13, 500), (300, 70, 100, 3000), (5, 40, 200, 900),
     (64, 160, 100, 10000)],
)
def test_ragged_kernel_pinned_sweeps_match_plain(cuda, D, T, K, V):
    ids, cnts, g0, eeb, alpha, real = _ragged_inputs(D, T, K, V, cuda)
    kw = dict(inner_iterations=12, convergence_threshold=0.0)
    slots = torch.zeros((1,), dtype=torch.int64, device=cuda)
    rows = torch.zeros((D,), dtype=torch.int32, device=cuda)
    before = ragged_mod.LAUNCHES
    g, s = ragged_mod.ragged_gamma(ids, cnts, g0, eeb, alpha,
                                   slots_out=slots, row_sweeps_out=rows, **kw)
    assert ragged_mod.LAUNCHES == before + 1
    g_p, s_p = estep_ragged_gamma(ids, cnts, g0, eeb, alpha, **kw)
    torch.cuda.synchronize()
    assert int(s) == int(s_p) == 12
    assert int(slots) == 12 * real  # no freezing at threshold 0
    assert bool((rows == 12).all())
    torch.testing.assert_close(g, g_p, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("thresh", [0.0, 1e-5])
def test_ragged_kernel_k200_streamed_rows_match_plain(cuda, thresh):
    """SVI config 4's rows: K = 200 and 130-208 live entries a row, all
    past the slot buffer (82 entries at K = 200), so every row streams its
    compacted entries."""
    D, T, K, V = 200, 208, 200, 50000
    rng = np.random.default_rng(6)
    ids = rng.integers(0, V, (D, T)).astype(np.int32)
    cnts = rng.integers(1, 4, (D, T)).astype(np.float32)
    pad = np.arange(T)[None, :] >= rng.integers(130, T + 1, D)[:, None]
    ids[pad], cnts[pad] = 0, 0.0
    ids, cnts = torch.tensor(ids, device=cuda), torch.tensor(cnts, device=cuda)
    lam = rng.gamma(1.0, 1.0, (K, V))
    eeb = exp_dirichlet_expectation(torch.tensor(lam, device=cuda).float())
    g0 = torch.ones((D, K), dtype=torch.float32, device=cuda)
    alpha = torch.full((K,), 1.0 / K, dtype=torch.float32, device=cuda)
    kw = dict(inner_iterations=12 if thresh == 0.0 else 50,
              convergence_threshold=thresh, stall_patience=6)
    g, s = ragged_mod.ragged_gamma(ids, cnts, g0, eeb, alpha, **kw)
    g_p, s_p = estep_ragged_gamma(ids, cnts, g0, eeb, alpha, **kw)
    torch.cuda.synchronize()
    assert int((cnts != 0).sum(dim=1).min()) > 82
    if thresh == 0.0:
        assert int(s) == int(s_p) == 12
        torch.testing.assert_close(g, g_p, rtol=1e-4, atol=1e-4)
    else:
        assert abs(int(s) - int(s_p)) <= 1
        torch.testing.assert_close(g, g_p, rtol=5e-4, atol=5e-4 + K * thresh)


@pytest.mark.parametrize("D,T,K,V,thresh", [(300, 70, 100, 3000, 1e-5),
                                            (37, 21, 13, 500, 1e-3)])
def test_ragged_kernel_exit_rule_matches_plain(cuda, D, T, K, V, thresh):
    ids, cnts, g0, eeb, alpha, _ = _ragged_inputs(D, T, K, V, cuda, seed=1)
    kw = dict(inner_iterations=50, convergence_threshold=thresh,
              stall_patience=6)
    rows = torch.zeros((D,), dtype=torch.int32, device=cuda)
    g, s = ragged_mod.ragged_gamma(ids, cnts, g0, eeb, alpha,
                                   row_sweeps_out=rows, **kw)
    g_p, s_p = estep_ragged_gamma(ids, cnts, g0, eeb, alpha, **kw)
    torch.cuda.synchronize()
    assert abs(int(s) - int(s_p)) <= 1
    assert int(rows.min()) >= 1 and int(rows.max()) <= int(s)
    torch.testing.assert_close(g, g_p, rtol=5e-4, atol=5e-4 + K * thresh)


def _dense_inputs(D, V, K, pad_rows, bf16, dev, seed=0, lam_shape=1.0):
    rng = np.random.default_rng(seed)
    counts = rng.poisson(0.1, (D, V)).astype(np.float32)
    counts = np.pad(counts, ((0, pad_rows), (0, 0)))  # padded doc rows
    lam = rng.gamma(lam_shape, 1.0, (K, V))
    ct = torch.tensor(counts, device=dev)
    if bf16:
        ct = ct.to(torch.bfloat16)
    eeb = exp_dirichlet_expectation(torch.tensor(lam, device=dev).float())
    g0 = torch.ones((D + pad_rows, K), dtype=torch.float32, device=dev)
    alpha = torch.full((K,), 0.1, dtype=torch.float32, device=dev)
    return ct, g0, eeb, alpha


_DENSE_SHAPES = [
    # D, V, K, padded rows, bf16 counts: rows, V and K off every tile
    (37, 333, 7, 0, False),
    (96, 640, 13, 5, True),
    (200, 1000, 100, 8, True),
    (129, 515, 200, 0, False),  # K > 128: 16 topics a thread
    (33, 64, 17, 3, True),
]


@pytest.mark.parametrize("D,V,K,pad_rows,bf16", _DENSE_SHAPES)
def test_dense_estep_pinned_sweeps_match_plain(cuda, D, V, K, pad_rows, bf16):
    ct, g0, eeb, alpha = _dense_inputs(D, V, K, pad_rows, bf16, cuda)
    kw = dict(inner_iterations=12, convergence_threshold=0.0)
    rows = torch.zeros((D + pad_rows,), dtype=torch.int32, device=cuda)
    before = (dense_mod.LAUNCHES, sstats_mod.LAUNCHES)
    g, ss, tok, s = dense_mod.dense_estep(ct, g0, eeb, alpha,
                                          row_sweeps_out=rows, **kw)
    assert (dense_mod.LAUNCHES, sstats_mod.LAUNCHES) == (before[0] + 1,
                                                         before[1] + 1)
    g_p, ss_p, tok_p, s_p = estep_dense(ct, g0, eeb, alpha, **kw)
    torch.cuda.synchronize()
    assert int(s) == int(s_p) == 12
    assert bool((rows == 12).all())  # no freezing at threshold 0
    torch.testing.assert_close(g, g_p, rtol=1e-4, atol=1e-4)
    # The final pass is dense_sstats at the kernel's own gamma.
    ss_at_g, _ = estep_dense_sstats(ct, exp_dirichlet_expectation(g), eeb)
    tol = 1e-4 * ss_at_g.abs() + 1e-6 * ss_at_g.abs().max()
    assert bool(((ss - ss_at_g).abs() <= tol).all())
    assert float(tok) == pytest.approx(float(tok_p), rel=1e-4)


@pytest.mark.parametrize("D,V,K,pad_rows,bf16", _DENSE_SHAPES[:3])
@pytest.mark.parametrize("thresh", [1e-5, 1e-3])
def test_dense_estep_exit_rule_matches_plain(cuda, D, V, K, pad_rows, bf16,
                                             thresh):
    ct, g0, eeb, alpha = _dense_inputs(D, V, K, pad_rows, bf16, cuda, seed=1)
    kw = dict(inner_iterations=50, convergence_threshold=thresh,
              stall_patience=6)
    rows = torch.zeros((D + pad_rows,), dtype=torch.int32, device=cuda)
    g, _, tok, s = dense_mod.dense_estep(ct, g0, eeb, alpha,
                                         row_sweeps_out=rows, **kw)
    g_p, _, tok_p, s_p = estep_dense(ct, g0, eeb, alpha, **kw)
    torch.cuda.synchronize()
    assert abs(int(s) - int(s_p)) <= 1
    # Done rows freeze; a row that is never done runs every sweep, and one
    # such row holds the loop open to its last sweep.
    assert int(rows.min()) >= 1 and int(rows.max()) == int(s)
    torch.testing.assert_close(g, g_p, rtol=5e-4, atol=5e-4 + K * thresh)
    assert float(tok) == pytest.approx(float(tok_p), rel=1e-4)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", LARGE_K)
def test_dense_estep_refuses_large_k(cuda, K, compute_dtype):
    """Above K = 4096 the gamma kernels no longer refuse: the cluster
    kernel of each (dense with its final pass, and ragged) against the
    plain version, float32 at 12 pinned sweeps (rtol 1e-4) and at the exit
    rule (the sweep count within 1, rtol 5e-4 + K * threshold), bf16 after
    one pinned sweep (``_hold_bf16_gamma``); two calls bitwise equal; every
    launch counted as a wide one, with the plan (``cluster_plan``: cluster
    width, slice, resident entries, window, shared memory) in the
    geometry."""
    bf16 = compute_dtype == "bfloat16"
    wide = "BF16_WIDE_LAUNCHES" if bf16 else "WIDE_LAUNCHES"
    ct, g0, eeb, alpha = _dense_inputs(40, 300, K, 3, True, cuda, seed=2)
    ids, cnts, rg0, reeb, ralpha = _wide_ragged_inputs(K, cuda)
    pinned = dict(inner_iterations=1 if bf16 else 12,
                  convergence_threshold=0.0, compute_dtype=compute_dtype)
    before = (getattr(dense_mod, wide), getattr(ragged_mod, wide))
    geo = {}
    g, ss, tok, s = dense_mod.dense_estep(ct, g0, eeb, alpha,
                                          geometry_out=geo, **pinned)
    g2 = dense_mod.dense_estep(ct, g0, eeb, alpha, **pinned)[0]
    r, rs = ragged_mod.ragged_gamma(ids, cnts, rg0, reeb, ralpha, **pinned)
    r2, _ = ragged_mod.ragged_gamma(ids, cnts, rg0, reeb, ralpha, **pinned)
    assert (getattr(dense_mod, wide), getattr(ragged_mod, wide)) == (
        before[0] + 2, before[1] + 2)
    plan = rfp.cluster_plan(K, 300, compute_dtype,
                            pinned["inner_iterations"])
    assert geo["nmax"] == 0 and geo["tile"] == plan.slice
    assert (geo["cluster"], geo["resident"], geo["window"], geo["windows"],
            geo["smem_bytes"]) == (plan.cluster, plan.resident, plan.window,
                                   plan.windows, plan.smem_bytes)
    assert 1 <= geo["clusters"] and geo["grid"] == geo["clusters"] * plan.cluster
    g_p, ss_p, tok_p, _ = estep_dense(ct, g0, eeb, alpha, **pinned)
    r_p, _ = estep_ragged_gamma(ids, cnts, rg0, reeb, ralpha, **pinned)
    torch.cuda.synchronize()
    assert torch.equal(g, g2) and torch.equal(r, r2)
    assert int(s) == int(rs) == pinned["inner_iterations"]
    if bf16:
        _hold_bf16_gamma(g, g_p, ct[:, :300] != 0)
        _hold_bf16_gamma(r, r_p, cnts != 0)
        return
    torch.testing.assert_close(g, g_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(r, r_p, rtol=1e-4, atol=1e-4)
    ss_at_g, _ = estep_dense_sstats(ct, exp_dirichlet_expectation(g), eeb)
    tol = 1e-4 * ss_at_g.abs() + 1e-6 * ss_at_g.abs().max()
    assert bool(((ss - ss_at_g).abs() <= tol).all())
    assert float(tok) == pytest.approx(float(tok_p), rel=1e-4)
    kw = dict(inner_iterations=50, convergence_threshold=1e-5,
              stall_patience=6)
    g, _, _, s = dense_mod.dense_estep(ct, g0, eeb, alpha, **kw)
    g_p, _, _, s_p = estep_dense(ct, g0, eeb, alpha, **kw)
    r, rs = ragged_mod.ragged_gamma(ids, cnts, rg0, reeb, ralpha, **kw)
    r_p, rs_p = estep_ragged_gamma(ids, cnts, rg0, reeb, ralpha, **kw)
    torch.cuda.synchronize()
    assert abs(int(s) - int(s_p)) <= 1 and abs(int(rs) - int(rs_p)) <= 1
    torch.testing.assert_close(g, g_p, rtol=5e-4, atol=5e-4 + K * 1e-5)
    torch.testing.assert_close(r, r_p, rtol=5e-4, atol=5e-4 + K * 1e-5)


def _hold_route(geo, live):
    """A launch whose rows lie on both sides of one block's slot buffer:
    on the entry kernel's route the cluster holds every row (no slot
    buffer of nmax); on the row-resident kernels' the buffer holds the
    shortest rows and the longest stream."""
    if geo["route"] == "entries":
        assert geo["nmax"] == 0
        assert geo["cluster"] * geo["resident"] >= int(live.max())
    else:
        assert geo["route"] == "stream"
        assert int(live.min()) <= geo["nmax"] < int(live.max())


def _wide_ragged_inputs(K, dev, seed=8):
    """24 rows of 20 to 120 live slots: at K >= 1000 rows on both sides of
    the slot buffer (25 entries at K = 1000, 4 at K = 4096), at K = 257
    (104 entries) too."""
    rng = np.random.default_rng(seed)
    D, T, V = 24, 120, 3000
    ids = rng.integers(0, V, (D, T)).astype(np.int32)
    cnts = rng.integers(1, 4, (D, T)).astype(np.float32)
    pad = np.arange(T)[None, :] >= rng.integers(20, T + 1, D)[:, None]
    ids[pad], cnts[pad] = 0, 0.0
    ids[0, :3], cnts[0, :3] = rng.integers(0, V, 3), 2.0  # 3 live slots
    ids[0, 3:], cnts[0, 3:] = 0, 0.0
    lam = rng.gamma(1.0, 1.0, (K, V))
    eeb = exp_dirichlet_expectation(torch.tensor(lam, device=dev).float())
    g0 = torch.ones((D, K), dtype=torch.float32, device=dev)
    alpha = torch.full((K,), 1.0 / K, dtype=torch.float32, device=dev)
    return (torch.tensor(ids, device=dev), torch.tensor(cnts, device=dev),
            g0, eeb, alpha)


@pytest.mark.parametrize("K", WIDE_K)
def test_ragged_kernel_wide_k_matches_plain(cuda, K):
    """At pinned sweeps (12, threshold 0) rtol 1e-4 with every row held;
    with the exit rule, rtol 5e-4 (atol 5e-4 + K * threshold) and the sweep
    count within +-1; rows on both sides of one block's slot buffer (the
    launch takes the entry kernel, whose cluster holds every row, or
    streams the longer rows); two calls bitwise equal."""
    ids, cnts, g0, eeb, alpha = _wide_ragged_inputs(K, cuda)
    live = (cnts != 0).sum(dim=1)
    geo = {}
    kw = dict(inner_iterations=12, convergence_threshold=0.0)
    g, s = ragged_mod.ragged_gamma(ids, cnts, g0, eeb, alpha,
                                   geometry_out=geo, **kw)
    g2, _ = ragged_mod.ragged_gamma(ids, cnts, g0, eeb, alpha, **kw)
    g_p, s_p = estep_ragged_gamma(ids, cnts, g0, eeb, alpha, **kw)
    torch.cuda.synchronize()
    _hold_route(geo, live)
    assert torch.equal(g, g2)
    assert int(s) == int(s_p) == 12
    torch.testing.assert_close(g, g_p, rtol=1e-4, atol=1e-4)
    kw = dict(inner_iterations=50, convergence_threshold=1e-5,
              stall_patience=6)
    g, s = ragged_mod.ragged_gamma(ids, cnts, g0, eeb, alpha, **kw)
    g_p, s_p = estep_ragged_gamma(ids, cnts, g0, eeb, alpha, **kw)
    torch.cuda.synchronize()
    assert abs(int(s) - int(s_p)) <= 1
    torch.testing.assert_close(g, g_p, rtol=5e-4, atol=5e-4 + K * 1e-5)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cluster_kernel_resident_and_streamed_rows(cuda, compute_dtype):
    """The cluster kernel at K = 8192 under three plans: the default
    (float32: 8 CTAs a row, 14 entries resident and windows of 16, so
    rows of 3 to 120 entries lie on both sides; bf16: 16 CTAs, every row
    resident), some entries resident (float32 7, bf16 40; windows of 16)
    and none (R = 0, every entry streamed):
    each two calls bitwise equal and held to the plain version (float32:
    12 pinned sweeps, rtol 1e-4; bf16: one pinned sweep,
    ``_hold_bf16_gamma``), the launch's geometry the plan's.  With the
    exit rule and three segments of 8 rows: each segment's S* within 1 of
    the plain version's chunk call, gamma at rtol 5e-4 + K * threshold."""
    K = 8192
    bf16 = compute_dtype == "bfloat16"
    ids, cnts, g0, eeb, alpha = _wide_ragged_inputs(K, cuda)
    D, T = ids.shape
    table = rfp.gather_table(eeb, compute_dtype)
    entry = rfp.entry("ragged_gamma", compute_dtype)
    pinned = dict(inner_iterations=1 if bf16 else 12,
                  convergence_threshold=0.0, eps=1e-30, stall_patience=0)
    default = rfp.cluster_plan(K, T, compute_dtype,
                               pinned["inner_iterations"])
    window = default.window or 16
    some = default.resident // 2 if default.window else 40
    plans = [default,
             dataclasses.replace(default, resident=some, window=window),
             dataclasses.replace(default, resident=0, window=window)]
    live = (cnts != 0).sum(dim=1)
    if not bf16:
        assert int(live.min()) <= default.resident < int(live.max())
    else:
        assert default.resident == T and default.window == 0
    g_p, _ = estep_ragged_gamma(ids, cnts, g0, eeb, alpha,
                                compute_dtype=compute_dtype, **pinned)

    def call(plan, kw, **extra):
        return rfp.launch(entry, ids, cnts, T, table, alpha, g0,
                          kw["inner_iterations"], kw["convergence_threshold"],
                          kw["eps"], kw["stall_patience"], plan=plan,
                          **extra)

    for plan in plans:
        geo = {}
        g, s = call(plan, pinned, geometry_out=geo)
        g2, _ = call(plan, pinned)
        torch.cuda.synchronize()
        assert torch.equal(g, g2), plan
        assert int(s) == pinned["inner_iterations"]
        assert (geo["resident"], geo["window"], geo["tile"]) == (
            plan.resident, plan.window, plan.slice)
        if bf16:
            _hold_bf16_gamma(g, g_p, cnts != 0)
        else:
            torch.testing.assert_close(g, g_p, rtol=1e-4, atol=1e-4)
    if bf16:
        return
    kw = dict(inner_iterations=50, convergence_threshold=1e-5, eps=1e-30,
              stall_patience=6)
    segments = (8, 8, 8)
    for plan in plans:
        g, s = call(plan, kw, segments=segments)
        g_p, s_p = estep_ragged_gamma(ids, cnts, g0, eeb, alpha,
                                      segments=segments, **kw)
        torch.cuda.synchronize()
        assert s.shape == (3,)
        assert bool(((s - s_p).abs() <= 1).all()), (s, s_p)
        torch.testing.assert_close(g, g_p, rtol=5e-4, atol=5e-4 + K * 1e-5)


# K past 65,536, where the cluster kernel's plan is direct.
DIRECT_K = [65540, 100000]


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cluster_kernel_direct_plan(cuda, compute_dtype):
    """The cluster kernel's direct plan (each CTA's slice state in device
    memory, B read from the table, none resident): at K = 8192 and 8 CTAs
    a row (slices of 1024 topics, one group sum in either plan) gamma and
    each segment's S* bitwise the staged plan's with none resident, at
    the exit rule with three segments of 8 rows.  Past K = 65,536
    (DIRECT_K) the plan the wrappers take is direct, and the ragged
    kernel and the dense E-step are each two calls bitwise equal, counted
    as wide launches and held to the plain version (float32 at 12 pinned
    sweeps, rtol 1e-4; bf16 after one pinned sweep,
    ``_hold_bf16_gamma``)."""
    bf16 = compute_dtype == "bfloat16"
    ids, cnts, g0, eeb, alpha = _wide_ragged_inputs(8192, cuda)
    D, T = ids.shape
    table = rfp.gather_table(eeb, compute_dtype)
    kw = dict(inner_iterations=50, convergence_threshold=1e-5, eps=1e-30,
              stall_patience=6)
    staged = rfp.cluster_plan(8192, T, compute_dtype, 50, cluster=8)
    staged = dataclasses.replace(staged, resident=0, window=16)
    direct = dataclasses.replace(staged, direct=True)
    assert staged.slice == 1024
    outs = [rfp.launch(rfp.entry("ragged_gamma", compute_dtype), ids, cnts,
                       T, table, alpha, g0, kw["inner_iterations"],
                       kw["convergence_threshold"], kw["eps"],
                       kw["stall_patience"], plan=plan, segments=(8, 8, 8))
            for plan in (staged, direct)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    del table, eeb
    wide = "BF16_WIDE_LAUNCHES" if bf16 else "WIDE_LAUNCHES"
    pinned = dict(inner_iterations=1 if bf16 else 12,
                  convergence_threshold=0.0, compute_dtype=compute_dtype)
    for K in DIRECT_K:
        rng = np.random.default_rng(K)
        V = 300
        rids = torch.tensor(rng.integers(0, V, (8, 40)).astype(np.int32),
                            device=cuda)
        rcnts = torch.tensor(rng.integers(0, 4, (8, 40)).astype(np.float32),
                             device=cuda)
        ct, dg0, eeb, alpha = _dense_inputs(8, V, K, 2, True, cuda, seed=3)
        rg0 = dg0[:8]
        plan = rfp.cluster_plan(K, 40, compute_dtype,
                                pinned["inner_iterations"])
        assert plan.direct and plan.cluster == rfp.MAX_CLUSTER
        before = (getattr(ragged_mod, wide), getattr(dense_mod, wide))
        geo = {}
        r, rs = ragged_mod.ragged_gamma(rids, rcnts, rg0, eeb, alpha,
                                        geometry_out=geo, **pinned)
        r2, _ = ragged_mod.ragged_gamma(rids, rcnts, rg0, eeb, alpha,
                                        **pinned)
        g, _, _, s = dense_mod.dense_estep(ct, dg0, eeb, alpha, **pinned)
        g2 = dense_mod.dense_estep(ct, dg0, eeb, alpha, **pinned)[0]
        assert (getattr(ragged_mod, wide), getattr(dense_mod, wide)) == (
            before[0] + 2, before[1] + 2)
        r_p, _ = estep_ragged_gamma(rids, rcnts, rg0, eeb, alpha, **pinned)
        g_p, _, _, _ = estep_dense(ct, dg0, eeb, alpha, **pinned)
        torch.cuda.synchronize()
        assert (geo["tile"], geo["resident"], geo["cluster"]) == (
            plan.slice, 0, plan.cluster)
        assert torch.equal(r, r2) and torch.equal(g, g2)
        assert int(rs) == int(s) == pinned["inner_iterations"]
        if bf16:
            _hold_bf16_gamma(r, r_p, rcnts != 0)
            _hold_bf16_gamma(g, g_p, ct[:, :V] != 0)
        else:
            torch.testing.assert_close(r, r_p, rtol=1e-4, atol=1e-4)
            torch.testing.assert_close(g, g_p, rtol=1e-4, atol=1e-4)
        del ct, eeb, r, r2, g, g2, r_p, g_p
        torch.cuda.empty_cache()


def test_ragged_kernel_stalled_rows_keep_their_bound(cuda):
    """K = 1000 at a sharpened lambda, SVI config 5's settings (30 sweeps,
    threshold 1e-5, patience 6): on the rows still updating at S*, each
    document's share of the bound at the kernel's gamma agrees with its
    share at the float64 plain version's gamma to rel 1e-5 — their gamma
    may drift by rounding, their bound may not."""
    _stalled_rows_keep_their_bound(cuda, 160, 9, 5000)


def test_entry_kernel_stalled_rows_keep_their_bound(cuda):
    """The same at config 5's widest bucket (width 208) over V = 8000 (a
    32 MB gather table, past half the L2): the launch takes the entry
    kernel, 8 CTAs a row, 26 entries each."""
    geo = _stalled_rows_keep_their_bound(cuda, 208, 19, 8000)
    assert (geo["route"], geo["cluster"], geo["resident"]) == (
        "entries", 8, 26)


def _stalled_rows_keep_their_bound(cuda, T, seed, V):
    """The kernel's and the float64 plain version's shares of the bound on
    the rows still updating at S*, rel 1e-5, at K = 1000 on rows of ~150
    tokens in a bucket of width T over V types; returns the launch's
    geometry."""
    K, D = 1000, 64
    rng = np.random.default_rng(seed)
    beta = rng.dirichlet(np.full(V, 0.02), size=K)
    theta = rng.dirichlet(np.full(K, 0.05), size=D)
    ids = np.zeros((D, T), np.int32)
    cnts = np.zeros((D, T), np.float32)
    for d in range(D):
        words = np.array([rng.choice(V, p=beta[rng.choice(K, p=theta[d])])
                          for _ in range(150)])
        u, c = np.unique(words, return_counts=True)
        ids[d, :u.size], cnts[d, :u.size] = u[:T], c[:T]
    lam = (1.0 / V + beta * (D * 150 / K)).astype(np.float32)
    ids, cnts = torch.tensor(ids, device=cuda), torch.tensor(cnts, device=cuda)
    eeb = exp_dirichlet_expectation(torch.tensor(lam, device=cuda))
    g0 = torch.ones((D, K), dtype=torch.float32, device=cuda)
    alpha = torch.full((K,), 1.0 / K, dtype=torch.float32, device=cuda)
    kw = dict(inner_iterations=30, convergence_threshold=1e-5,
              stall_patience=6)
    rows = torch.zeros((D,), dtype=torch.int32, device=cuda)
    geo = {}
    g, s = ragged_mod.ragged_gamma(ids, cnts, g0, eeb, alpha,
                                   row_sweeps_out=rows, geometry_out=geo,
                                   **kw)
    g_64, s_64 = estep_ragged_gamma(ids, cnts.double(), g0.double(),
                                    eeb.double(), alpha.double(), **kw)
    torch.cuda.synchronize()
    assert abs(int(s) - int(s_64)) <= 1
    updating = rows == int(s)
    assert bool(updating.any())
    b_k = ragged_doc_bound(ids, cnts, g.double(), eeb.double(),
                           alpha.double())
    b_64 = ragged_doc_bound(ids, cnts, g_64, eeb.double(), alpha.double())
    rel = ((b_k - b_64).abs() / b_64.abs())[updating]
    assert float(rel.max()) <= 1e-5, float(rel.max())
    return geo


# The entry kernel: (K, T) with rows of 1 to T live entries, the widest
# past one block's slot buffer (at K = 200 two CTAs of 150 entries, 257
# two, 1000 eight of 26, 2048 eight of 13, 4096 eight of 8 in float32).
_ENTRY_K = [(200, 300), (257, 300), (1000, 208), (2048, 100), (4096, 60)]


def _entry_inputs(K, T, dev, seed=13):
    """24 rows of distinct ids, of 1 to T live entries (row 0 full, row 1
    of 2), at a sharp lambda, over a vocabulary whose bf16 gather table
    passes half the card's L2 (so the launch takes the entry kernel, not
    the streamed windows that re-gather from the L2): as a ragged bucket
    (ids, cnts [24, T]) and as dense counts [24, V] of the same
    entries."""
    rng = np.random.default_rng(seed)
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    D, V = 24, max(3000, int(0.6 * l2) // (2 * rfp.table_width(K, BF16)))
    ids = np.zeros((D, T), np.int32)
    cnts = np.zeros((D, T), np.float32)
    counts = np.zeros((D, V), np.float32)
    lens = rng.integers(1, T + 1, D)
    lens[0], lens[1] = T, 2
    for d, n in enumerate(lens):
        ids[d, :n] = rng.choice(V, n, replace=False)
        cnts[d, :n] = rng.integers(1, 4, n)
        counts[d, ids[d, :n]] = cnts[d, :n]
    lam = rng.gamma(0.1, 1.0, (K, V)) * 100.0 + 0.01
    eeb = exp_dirichlet_expectation(torch.tensor(lam, device=dev).float())
    g0 = torch.ones((D, K), dtype=torch.float32, device=dev)
    alpha = torch.full((K,), 1.0 / K, dtype=torch.float32, device=dev)
    return (torch.tensor(ids, device=dev), torch.tensor(cnts, device=dev),
            torch.tensor(counts, device=dev), g0, eeb, alpha)


def _entry_run(layout, inputs, kw, plain=False, dtype=torch.float32,
               **extra):
    """(gamma, sweeps) of the kernel, or of the plain version in dtype, on
    the ragged bucket or on the dense counts (the kernel given the
    batch's largest row nnz)."""
    ids, cnts, counts, g0, eeb, alpha = inputs
    args = [t.to(dtype) for t in (g0, eeb, alpha)]
    if layout == "ragged":
        fn = estep_ragged_gamma if plain else ragged_mod.ragged_gamma
        return fn(ids, cnts.to(dtype), *args, **kw, **extra)
    nnz = int((counts != 0).sum(dim=1).max())
    if plain:
        g, _, _, s = estep_dense(counts.to(dtype), *args, **kw, **extra)
    else:
        g, _, _, s = dense_mod.dense_estep(counts, *args, max_nnz=nnz, **kw,
                                           **extra)
    return g, s


@pytest.mark.parametrize("layout", ["ragged", "dense"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,T", _ENTRY_K)
def test_entry_kernel_matches_plain(cuda, K, T, compute_dtype, layout):
    """The entry kernel against the plain version: float32 at pinned
    sweeps, rtol 1e-4 (12 sweeps at K <= 256, 3 above: there float32
    reassociation alone carries the plain version past that bar within 12
    sweeps, as ``chip_smoke.py``'s PINNED_SWEEPS_WIDE says), bf16 after
    one (``_hold_bf16_gamma``); two calls
    bitwise equal; each launch counted in CLUSTER_LAUNCHES (bf16:
    BF16_CLUSTER_LAUNCHES); the geometry the launcher writes back the
    plan's (``gamma_plan``: cluster width, entries a CTA, shared memory).
    With the exit rule, the ragged bucket in three segments of 8 rows:
    each segment's S* within 1 of the plain version's chunk call; float32
    gamma of the rows done by S* at rtol 5e-4 + K * threshold and the rows
    still updating at S* by their share of the bound, as
    ``chip_smoke.py`` holds them (their gamma drifts by rounding for any
    float32 code): each share within 1e-5, or twice the float32 plain
    version's gap, of the float64 plain version's; bf16 each document's
    share (``_hold_bf16_shares``)."""
    bf16 = compute_dtype == "bfloat16"
    mod = ragged_mod if layout == "ragged" else dense_mod
    counter = "BF16_CLUSTER_LAUNCHES" if bf16 else "CLUSTER_LAUNCHES"
    inputs = _entry_inputs(K, T, cuda)
    ids, cnts = inputs[:2]
    pinned = dict(inner_iterations=1 if bf16 else 12 if K <= 256 else 3,
                  convergence_threshold=0.0, compute_dtype=compute_dtype)
    props = torch.cuda.get_device_properties(cuda)
    plan = rfp.gamma_plan(K, T, compute_dtype, pinned["inner_iterations"],
                          props.shared_memory_per_multiprocessor,
                          props.shared_memory_per_block_optin)
    assert plan.route == "entries" and plan.cluster * plan.share >= T
    before = getattr(mod, counter)
    geo = {}
    g, s = _entry_run(layout, inputs, pinned, geometry_out=geo)
    g2, _ = _entry_run(layout, inputs, pinned)
    g_p, _ = _entry_run(layout, inputs, pinned, plain=True)
    torch.cuda.synchronize()
    assert getattr(mod, counter) == before + 2
    assert geo["route"] == "entries"
    assert (geo["cluster"], geo["resident"], geo["smem_bytes"], geo["tile"],
            geo["nmax"], geo["window"], geo["windows"]) == (
        plan.cluster, plan.share, plan.smem_bytes, K, 0, 0, 1)
    assert 1 <= geo["clusters"]
    assert geo["grid"] == geo["clusters"] * plan.cluster
    assert torch.equal(g, g2)
    assert int(s) == pinned["inner_iterations"]
    if bf16:
        _hold_bf16_gamma(g, g_p, cnts != 0)
    else:
        torch.testing.assert_close(g, g_p, rtol=1e-4, atol=1e-4)
    kw = dict(inner_iterations=50, convergence_threshold=1e-5,
              stall_patience=6, compute_dtype=compute_dtype)
    seg = {"segments": (8, 8, 8)} if layout == "ragged" else {}
    rows = torch.zeros((ids.shape[0],), dtype=torch.int32, device=cuda)
    g, s = _entry_run(layout, inputs, kw, row_sweeps_out=rows, **seg)
    g_p, s_p = _entry_run(layout, inputs, kw, plain=True, **seg)
    g_64, _ = _entry_run(layout, inputs, kw, plain=True, dtype=torch.float64,
                         **seg)
    torch.cuda.synchronize()
    assert s.shape == s_p.shape
    assert bool(((s - s_p).abs() <= 1).all()), (s, s_p)
    if bf16:
        _hold_bf16_shares(ids, cnts, g, g_p, g_64, inputs[4], inputs[5])
        return
    s_row = s.reshape(-1).repeat_interleave(
        torch.tensor(seg.get("segments", (ids.shape[0],)), device=cuda))
    updating = rows >= s_row
    done = ~updating
    torch.testing.assert_close(g[done], g_p[done], rtol=5e-4,
                               atol=5e-4 + K * 1e-5)
    live = updating & (cnts != 0).any(dim=1)
    if live.any():
        err = _shares_err(ids[live], cnts[live], g[live], g_64[live],
                          inputs[4], inputs[5])
        bar = max(1e-5, 2.0 * _shares_err(ids[live], cnts[live], g_p[live],
                                          g_64[live], inputs[4], inputs[5]))
        assert err <= bar, (err, bar)


@pytest.mark.parametrize("layout", ["ragged", "dense"])
def test_rows_past_the_cluster_stream(cuda, layout):
    """At K = 4096 in float32 16 CTAs hold 128 entries of a row: a launch
    whose widest row has 200 takes the row-resident kernels with its long
    rows streamed (4 entries a block), not the entry kernel; held at 12
    pinned sweeps (rtol 1e-4)."""
    K, T = 4096, 200
    inputs = _entry_inputs(K, T, cuda, seed=14)
    pinned = dict(inner_iterations=12, convergence_threshold=0.0)
    assert rfp.gamma_plan(K, T, "float32", 12).route == "stream"
    before = (ragged_mod.CLUSTER_LAUNCHES, dense_mod.CLUSTER_LAUNCHES)
    geo = {}
    g, s = _entry_run(layout, inputs, pinned, geometry_out=geo)
    g_p, _ = _entry_run(layout, inputs, pinned, plain=True)
    torch.cuda.synchronize()
    assert (ragged_mod.CLUSTER_LAUNCHES, dense_mod.CLUSTER_LAUNCHES) == before
    assert (geo["route"], geo["nmax"], geo["cluster"]) == ("stream", 4, 0)
    assert int(s) == 12
    torch.testing.assert_close(g, g_p, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_flagship_bucket_stays_on_the_row_resident_kernels(cuda,
                                                           compute_dtype):
    """The ragged flagship's widest bucket (K = 100, width 160: one block
    holds 167 entries) takes the row-resident kernels in float32 and, in
    bf16, the warp-group kernel (a group holds 224 entries at K = 100):
    the launch counts in LAUNCHES (or BF16_LAUNCHES and
    BF16_GROUP_LAUNCHES), not in the cluster counters, and its slot buffer
    (bf16: a group's slots, 160) is the plan's; held to the plain version
    (float32: 12 pinned sweeps, rtol 1e-4; bf16: one,
    ``_hold_bf16_gamma``)."""
    bf16 = compute_dtype == "bfloat16"
    ids, cnts, g0, eeb, alpha, _ = _ragged_inputs(64, 160, 100, 10000, cuda)
    kw = dict(inner_iterations=1 if bf16 else 12, convergence_threshold=0.0,
              compute_dtype=compute_dtype)
    props = torch.cuda.get_device_properties(cuda)
    plan = rfp.gamma_plan(100, 160, compute_dtype, kw["inner_iterations"],
                          props.shared_memory_per_multiprocessor,
                          props.shared_memory_per_block_optin)
    counters = ("LAUNCHES", "BF16_LAUNCHES", "CLUSTER_LAUNCHES",
                "BF16_CLUSTER_LAUNCHES", "BF16_GROUP_LAUNCHES")
    before = [getattr(ragged_mod, c) for c in counters]
    geo = {}
    g, _ = ragged_mod.ragged_gamma(ids, cnts, g0, eeb, alpha,
                                   geometry_out=geo, **kw)
    g_p, _ = estep_ragged_gamma(ids, cnts, g0, eeb, alpha, **kw)
    torch.cuda.synchronize()
    after = [getattr(ragged_mod, c) for c in counters]
    assert after == [before[0] + (not bf16), before[1] + bf16, before[2],
                     before[3], before[4] + bf16]
    route = "groups" if bf16 else "rows"
    assert (geo["route"], geo["cluster"]) == (route, 0)
    assert plan.route == route
    assert geo["nmax"] == (plan.slots if bf16 else min(plan.nmax, 160))
    if bf16:
        _hold_bf16_gamma(g, g_p, cnts != 0)
    else:
        torch.testing.assert_close(g, g_p, rtol=1e-4, atol=1e-4)


def _gamma_call(layout, inputs, kw, **outs):
    """(gamma, sweeps) of the kernel and of its plain version."""
    if layout == "ragged":
        ids, cnts, g0, eeb, alpha, _ = inputs
        got = ragged_mod.ragged_gamma(ids, cnts, g0, eeb, alpha, **kw, **outs)
        want = estep_ragged_gamma(ids, cnts, g0, eeb, alpha, **kw)
        return got, want
    ct, g0, eeb, alpha = inputs
    g, _, _, s = dense_mod.dense_estep(ct, g0, eeb, alpha, **kw, **outs)
    g_p, _, _, s_p = estep_dense(ct, g0, eeb, alpha, **kw)
    return (g, s), (g_p, s_p)


@pytest.mark.parametrize("layout", ["ragged", "dense"])
def test_gamma_kernel_s_star_before_cap(cuda, layout):
    """Peaked topics at threshold 1e-3: the batch exits before the cap, and
    rows stalled but not done at S* ran past it and are re-run."""
    if layout == "ragged":
        inputs = _ragged_inputs(300, 40, 13, 500, cuda, seed=2,
                                lam_shape=0.05)
    else:
        inputs = _dense_inputs(300, 500, 13, 6, True, cuda, seed=2,
                               lam_shape=0.05)
    K = 13
    kw = dict(inner_iterations=50, convergence_threshold=1e-3,
              stall_patience=6)
    extra = torch.zeros((1,), dtype=torch.int64, device=cuda)
    first = torch.zeros((300 + 6 * (layout == "dense"),), dtype=torch.int32,
                        device=cuda)
    (g, s), (g_p, s_p) = _gamma_call(layout, inputs, kw,
                                     extra_sweeps_out=extra,
                                     row_exit_out=first)
    torch.cuda.synchronize()
    assert int(s_p) < 50 and abs(int(s) - int(s_p)) <= 1
    assert int(extra) > 0  # the re-run of rows past S* happened
    assert int(first.max()) <= int(s) and int(first.min()) >= 1
    torch.testing.assert_close(g, g_p, rtol=5e-4, atol=5e-4 + K * 1e-3)


# Rows longer than the slot buffer, rows on both sides of the register
# tile's 128 entries, K = 256, bf16 and f32 dense counts:
# (layout, rows, width (T or V), K, bf16).
_LONG_ROWS = [
    ("ragged", 40, 300, 100, False),  # up to 300 live slots > 166
    ("ragged", 30, 100, 256, False),  # up to 100 live slots > 63
    ("dense", 40, 3000, 100, True),  # ~300 nonzeros a row > 166
    ("dense", 40, 1400, 100, True),  # ~140: in registers, or not, a row
    ("dense", 40, 700, 256, False),  # ~70 nonzeros a row, some > 63
    ("dense", 40, 700, 256, True),
    ("ragged", 24, 1000, 256, False),  # up to 1000 live slots: 16 windows
    ("dense", 24, 8000, 100, False),  # ~760 nonzeros a row: 5 windows
]


@pytest.mark.parametrize("layout,rows,width,K,bf16", _LONG_ROWS)
@pytest.mark.parametrize("thresh", [0.0, 1e-5])
def test_gamma_kernel_long_rows_match_plain(cuda, layout, rows, width, K,
                                            bf16, thresh):
    if layout == "ragged":
        inputs = _ragged_inputs(rows, width, K, 5000, cuda, seed=4)
    else:
        inputs = _dense_inputs(rows, width, K, 3, bf16, cuda, seed=4)
    kw = dict(inner_iterations=12 if thresh == 0.0 else 50,
              convergence_threshold=thresh, stall_patience=6)
    (g, s), (g_p, s_p) = _gamma_call(layout, inputs, kw)
    torch.cuda.synchronize()
    if thresh == 0.0:
        assert int(s) == int(s_p) == 12
        torch.testing.assert_close(g, g_p, rtol=1e-4, atol=1e-4)
    else:
        assert abs(int(s) - int(s_p)) <= 1
        torch.testing.assert_close(g, g_p, rtol=5e-4, atol=5e-4 + K * thresh)


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("K", WIDE_K)
def test_dense_estep_wide_k_matches_plain(cuda, K, bf16):
    """The dense E-step at the wide K: rows of 0 to ~150 nonzeros, so on
    both sides of the slot buffer; pinned sweeps rtol 1e-4, the final pass
    at the kernel's gamma at the sstats tolerances, the score rel 1e-4;
    two calls bitwise equal."""
    rng = np.random.default_rng(10)
    D, V = 40, 600
    rates = rng.choice([0.0, 0.005, 0.03, 0.25], size=D)
    counts = rng.poisson(rates[:, None], (D, V)).astype(np.float32)
    ct = torch.tensor(counts, device=cuda)
    if bf16:
        ct = ct.to(torch.bfloat16)
    lam = rng.gamma(1.0, 1.0, (K, V))
    eeb = exp_dirichlet_expectation(torch.tensor(lam, device=cuda).float())
    g0 = torch.ones((D, K), dtype=torch.float32, device=cuda)
    alpha = torch.full((K,), 1.0 / K, dtype=torch.float32, device=cuda)
    kw = dict(inner_iterations=12, convergence_threshold=0.0)
    geo = {}
    g, ss, tok, s = dense_mod.dense_estep(ct, g0, eeb, alpha,
                                          geometry_out=geo, **kw)
    g2, ss2, tok2, _ = dense_mod.dense_estep(ct, g0, eeb, alpha, **kw)
    g_p, _, tok_p, s_p = estep_dense(ct, g0, eeb, alpha, **kw)
    torch.cuda.synchronize()
    _hold_route(geo, (ct != 0).sum(dim=1))
    assert torch.equal(g, g2) and torch.equal(ss, ss2) and torch.equal(tok, tok2)
    assert int(s) == int(s_p) == 12
    torch.testing.assert_close(g, g_p, rtol=1e-4, atol=1e-4)
    ss_at_g, _ = estep_dense_sstats(ct, exp_dirichlet_expectation(g), eeb)
    tol = 1e-4 * ss_at_g.abs() + 1e-6 * ss_at_g.abs().max()
    assert bool(((ss - ss_at_g).abs() <= tol).all())
    assert float(tok) == pytest.approx(float(tok_p), rel=1e-4)


@pytest.mark.parametrize("K,bf16", [(100, True), (256, False)])
def test_dense_estep_mixed_row_lengths_match_plain(cuda, K, bf16):
    """One batch whose rows take every path of the kernel in turn: empty,
    register tile, shared-memory sweep, and streamed windows of a scratch
    list that each block reuses from row to row."""
    rng = np.random.default_rng(5)
    D, V = 64, 4096
    rates = rng.choice([0.0, 0.005, 0.03, 0.06, 0.25], size=D)
    counts = rng.poisson(rates[:, None], (D, V)).astype(np.float32)
    ct = torch.tensor(counts, device=cuda)
    if bf16:
        ct = ct.to(torch.bfloat16)
    lam = rng.gamma(1.0, 1.0, (K, V))
    eeb = exp_dirichlet_expectation(torch.tensor(lam, device=cuda).float())
    g0 = torch.ones((D, K), dtype=torch.float32, device=cuda)
    alpha = torch.full((K,), 0.1, dtype=torch.float32, device=cuda)
    nnz = (counts != 0).sum(axis=1)
    assert nnz.min() == 0 and nnz.max() > 4 * 166
    for kw in (dict(inner_iterations=12, convergence_threshold=0.0),
               dict(inner_iterations=50, convergence_threshold=1e-5,
                    stall_patience=6)):
        g, _, tok, s = dense_mod.dense_estep(ct, g0, eeb, alpha, **kw)
        g_p, _, tok_p, s_p = estep_dense(ct, g0, eeb, alpha, **kw)
        torch.cuda.synchronize()
        if kw["convergence_threshold"] == 0.0:
            assert int(s) == int(s_p) == 12
            torch.testing.assert_close(g, g_p, rtol=1e-4, atol=1e-4)
        else:
            assert abs(int(s) - int(s_p)) <= 1
            torch.testing.assert_close(g, g_p, rtol=5e-4, atol=5e-4 + K * 1e-5)
        assert float(tok) == pytest.approx(float(tok_p), rel=1e-4)


@pytest.mark.parametrize(
    "extra",
    [{}, dict(estep_memory_budget_mb=0, doc_pad_multiple=40)],
    ids=["one_batch", "several_batches"],
)
def test_engine_dense_route_on_card_matches_cpu(cuda, extra):
    """The dense route (V <= dense_vocab_threshold): ELBOs rel 1e-4."""
    from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
    from pylda_tpu_torch.models import VariationalBayes
    from pylda_tpu_torch.utils.config import LDAConfig

    corpus, _, _ = synthetic_corpus(num_docs=150, num_topics=8, num_types=300,
                                    mean_doc_length=40.0, seed=3)
    cfg = LDAConfig(**{**dict(number_of_topics=8, doc_pad_multiple=8,
                              hyper_parameter_optimize_interval=2), **extra})
    lam0 = np.random.default_rng(11).gamma(100.0, 0.01, (8, 300))
    elbos = {}
    for dev in (cuda, "cpu"):
        eng = VariationalBayes(cfg, device=dev)
        eng.initialize(corpus, lam_init=lam0)
        if "estep_memory_budget_mb" in extra:
            assert len(eng._batches) == 4
        before = dense_mod.LAUNCHES
        elbos[str(dev)] = [eng.learning() for _ in range(2)] + \
            eng.learning_many(2)
        if dev is cuda:
            assert dense_mod.LAUNCHES == before + 4 * len(eng._batches)
    np.testing.assert_allclose(elbos[str(cuda)], elbos["cpu"], rtol=1e-4)


@pytest.mark.parametrize(
    "extra",
    [{}, dict(bucket_sizes=(16, 32), bucket_policy="fixed"),
     dict(sstats_dense_budget_mb=0, doc_pad_multiple=40)],
    ids=["default", "chunked_long_docs", "several_sstats_chunks"],
)
def test_engine_on_card_matches_cpu(cuda, extra):
    """ELBOs rel 1e-4 (summation order and exit timing differ)."""
    from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
    from pylda_tpu_torch.models import VariationalBayes
    from pylda_tpu_torch.utils.config import LDAConfig

    corpus, _, _ = synthetic_corpus(num_docs=96, num_topics=8, num_types=600,
                                    mean_doc_length=40.0, seed=3)
    cfg = LDAConfig(**{**dict(number_of_topics=8, dense_vocab_threshold=256,
                              doc_pad_multiple=8,
                              hyper_parameter_optimize_interval=2), **extra})
    lam0 = np.random.default_rng(11).gamma(100.0, 0.01, (8, 600))
    elbos = {}
    for dev in (cuda, "cpu"):
        eng = VariationalBayes(cfg, device=dev)
        eng.initialize(corpus, lam_init=lam0)
        elbos[str(dev)] = [eng.learning() for _ in range(2)] + \
            eng.learning_many(2)
    np.testing.assert_allclose(elbos[str(cuda)], elbos["cpu"], rtol=1e-4)


@pytest.mark.parametrize("layout", ["ragged", "dense"])
def test_svi_engine_on_card_matches_cpu(cuda, layout):
    """Epoch estimates rel 1e-4 (summation order and exit timing differ),
    through the kernels on the card."""
    from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
    from pylda_tpu_torch.models import StochasticVariationalBayes
    from pylda_tpu_torch.utils.config import LDAConfig

    corpus, _, _ = synthetic_corpus(num_docs=200, num_topics=8, num_types=600,
                                    mean_doc_length=40.0, seed=3)
    cfg = LDAConfig(number_of_topics=8, inference_mode="svi", batch_size=64,
                    doc_pad_multiple=8, tau0=16.0,
                    hyper_parameter_optimize_interval=2,
                    dense_vocab_threshold=256 if layout == "ragged" else 4096)
    lam0 = np.random.default_rng(11).gamma(100.0, 0.01, (8, 600))
    ests = {}
    for dev in (cuda, "cpu"):
        eng = StochasticVariationalBayes(cfg, device=dev)
        eng.initialize(corpus, lam_init=lam0)
        assert eng._device_rows is not None
        before = {m: m.LAUNCHES for m in (ragged_mod, sstats_mod, dense_mod)}
        ests[str(dev)] = [eng.learning() for _ in range(2)] + \
            eng.learning_many(2)
        if dev is cuda:
            ran = {m for m in before if m.LAUNCHES > before[m]}
            assert ran == ({ragged_mod, sstats_mod} if layout == "ragged"
                           else {dense_mod, sstats_mod})
    np.testing.assert_allclose(ests[str(cuda)], ests["cpu"], rtol=1e-4)


def test_svi_refuses_large_k_on_card(cuda):
    """Above K = 4096 the kernels no longer refuse: SVI at K = 4097 trains
    on the card through the wide kernels (the dense route's gamma cluster
    kernel and two-pass final pass), its estimates at pinned sweeps
    within rel 1e-4 of the CPU run's from one lambda."""
    from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
    from pylda_tpu_torch.models import StochasticVariationalBayes
    from pylda_tpu_torch.utils.config import LDAConfig

    corpus, _, _ = synthetic_corpus(num_docs=20, num_topics=4, num_types=300,
                                    mean_doc_length=10.0, seed=1)
    cfg = LDAConfig(number_of_topics=4097, inference_mode="svi",
                    batch_size=8, inner_iterations=10,
                    convergence_threshold=0.0)
    lam0 = np.random.default_rng(3).gamma(100.0, 0.01, (4097, 300))
    ests = {}
    for dev in (cuda, "cpu"):
        eng = StochasticVariationalBayes(cfg, device=dev)
        eng.initialize(corpus, lam_init=lam0)
        before = (dense_mod.WIDE_LAUNCHES, sstats_mod.WIDE_LAUNCHES)
        ests[str(dev)] = [eng.learning() for _ in range(2)]
        if dev is cuda:
            assert dense_mod.WIDE_LAUNCHES > before[0]
            assert sstats_mod.WIDE_LAUNCHES > before[1]
        assert np.isfinite(ests[str(dev)]).all()
    np.testing.assert_allclose(ests[str(cuda)], ests["cpu"], rtol=1e-4)


def test_engine_on_card_takes_each_bucket_whole(cuda):
    """``estep_memory_budget_mb`` caps a ragged batch's rows where [rows,
    T, K] arrays are made (the CPU, the scatter route): at a 1 MB budget
    the CPU engine and the scatter route on the card chunk the buckets,
    while on the card with dense sufficient statistics batch VB takes
    each bucket in one launch and SVI each width's capacity."""
    from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
    from pylda_tpu_torch.models import (StochasticVariationalBayes,
                                        VariationalBayes)
    from pylda_tpu_torch.utils.config import LDAConfig

    corpus, _, _ = synthetic_corpus(num_docs=300, num_topics=8, num_types=600,
                                    mean_doc_length=30.0, seed=2)
    cfg = LDAConfig(number_of_topics=300, dense_vocab_threshold=256,
                    doc_pad_multiple=8, estep_memory_budget_mb=1)

    def widths(eng):
        return [b.ids.shape[1] for b in eng._batches]

    engs = {}
    for name, dev, c in (("card", cuda, cfg), ("cpu", "cpu", cfg),
                         ("scatter", cuda, dataclasses.replace(
                             cfg, sstats_mode="scatter"))):
        engs[name] = VariationalBayes(c, device=dev)
        engs[name].initialize(corpus)
    card = widths(engs["card"])
    assert len(card) == len(set(card))
    assert widths(engs["cpu"]) == widths(engs["scatter"])
    assert len(widths(engs["cpu"])) > len(card)
    # Each whole bucket's segments are the CPU's chunks of that width.
    for b in engs["card"]._batches:
        cpu = [c.rows for c in engs["cpu"]._batches
               if c.ids.shape[1] == b.ids.shape[1]]
        assert list(b.segments or (b.rows,)) == cpu
    svi = StochasticVariationalBayes(dataclasses.replace(
        cfg, inference_mode="svi", batch_size=128), device=cuda)
    svi.initialize(corpus)
    assert svi._device_rows and all(r.chunk_sizes == [r.cap]
                                    for r in svi._device_rows)
    assert any(r.segments for r in svi._device_rows)


def test_engine_whole_buckets_match_cpu_chunks(cuda):
    """The shape where one S* a whole bucket diverged from the chunked
    runs (``synthetic_corpus(1024, 20, 5000, mean_doc_length=120,
    seed=0)``, K = 20, lambda0 ~ Gamma(100, 0.01) from seed 1, a 1 MB
    budget, the engine's defaults: threshold 1e-5, stall patience 6):
    batch VB on the card (whole buckets, their chunks as segments)
    against the CPU (the chunks as batches) after one learning() from
    lambda0: one sweep count a chunk, each within 1 of the CPU's; each
    document's gamma at rtol 5e-4 + K * threshold; the ELBO rel 1e-4."""
    from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
    from pylda_tpu_torch.models import VariationalBayes
    from pylda_tpu_torch.utils.config import LDAConfig

    corpus, _, _ = synthetic_corpus(num_docs=1024, num_topics=20,
                                    num_types=5000, mean_doc_length=120.0,
                                    seed=0)
    lam0 = np.random.default_rng(1).gamma(100.0, 0.01, (20, 5000))
    cfg = LDAConfig(number_of_topics=20, estep_memory_budget_mb=1, seed=0)
    engs, elbos = {}, {}
    for dev in (cuda, "cpu"):
        eng = VariationalBayes(cfg, device=dev)
        eng.initialize(corpus, lam_init=lam0)
        elbos[str(dev)] = eng.learning()
        engs[str(dev)] = eng
    card, cpu = engs[str(cuda)], engs["cpu"]
    assert len(card._batches) < len(cpu._batches)
    s_card = [int(s) for s in card.last_sweeps]
    s_cpu = [int(s) for s in cpu.last_sweeps]
    assert len(s_card) == len(s_cpu) == len(cpu._batches)
    assert all(abs(a - b) <= 1 for a, b in zip(s_card, s_cpu)), (s_card,
                                                                  s_cpu)
    np.testing.assert_allclose(card.gamma, cpu.gamma, rtol=5e-4,
                               atol=5e-4 + 20 * 1e-5)
    assert elbos[str(cuda)] == pytest.approx(elbos["cpu"], rel=1e-4)


# -- the bf16 builds (compute_dtype="bfloat16") ----------------------------------
#
# Held against the plain version with the same rounding points.  Both round
# the same values, and only f32 summation order differs; where a ratio
# counts / phinorm lies at a bf16 rounding midpoint, the two versions'
# phinorm sums can round it one bf16 ulp apart (2^-8).  So after one pinned
# sweep gamma agrees to rel 1e-5 on all but at most 5% of the live rows,
# each within 2^-7; sstats at equal inputs agree to the float32 tolerance on
# all but at most 0.1% of the entries, each within 2^-7 of its value, and
# the score (f32 phinorm) to rel 1e-5.  At the exit rule the flips are
# carried forward and rows limit-cycle at the bf16 map's noise floor:
# each document's share of the bound is held to its share at the float64
# plain version's gamma (same rounding points) within rel 2e-4, or within
# twice the float32 plain version's own gap where that is larger (the plain
# version shares every rounding point and differs from the kernel only in
# summation order; on the card both reach 2.2e-4 to 3.5e-2 at K = 257 to
# 4096, scripts/torch_bf16_bound_gaps.py).  The float32 builds miss the one-sweep bar against the bf16 plain
# version by > 1e-3 (the negative control).

BF16 = "bfloat16"
BF16_K = [16, 100, 257, 1000, 4096]


def _hold_bf16_gamma(g, g_p, cnts_live):
    live = cnts_live.any(dim=1)
    rel = ((g - g_p).abs() / g_p.abs()).amax(dim=1)[live]
    assert float((rel > 1e-5).float().mean()) <= 0.05, float(rel.max())
    assert float(rel.max()) <= 2.0 ** -7


def _hold_bf16_sstats(ss, ss_p):
    diff, atol = (ss - ss_p).abs(), 1e-6 * float(ss_p.abs().max())
    off = diff > 1e-4 * ss_p.abs() + atol
    assert float(off.float().mean()) <= 1e-3, int(off.sum())
    assert bool((diff <= 2.0 ** -7 * ss_p.abs() + atol).all())


def _hold_bf16_sstats_f64(ss, ss_p, ct, et, eeb):
    """bf16 sstats against the plain version run in float64 (the bf16
    mode's rounding points, float64 sums): the share of entries off it by
    more than 1e-4 rel + 1e-6 max|ref| at most 1e-3 or twice the float32
    plain version's (``ss_p``) share, and every entry within 2^-7 rel +
    1e-6 max|ref|.  Past K = 16384 a bf16 ratio flips where the two
    float32 phinorm sums (the plain version's and the kernel's, in other
    orders) straddle a rounding boundary, so the float32 plain version is
    no reference there for the kernel's rounding."""
    ref, _ = estep_dense_sstats(ct.double(), et.double(), eeb.double(),
                                compute_dtype="bfloat16")
    atol = 1e-6 * float(ref.abs().max())

    def share(x):
        diff = (x.double() - ref).abs()
        return float((diff > 1e-4 * ref.abs() + atol).double().mean())

    assert share(ss) <= max(1e-3, 2.0 * share(ss_p)), (share(ss),
                                                        share(ss_p))
    assert bool(((ss.double() - ref).abs()
                 <= 2.0 ** -7 * ref.abs() + atol).all())


def _share_gaps(ids, cnts, g, g_ref, eeb, alpha):
    """Each live row's relative gap of its share of the bound at ``g`` from
    that at ``g_ref``."""
    live = (cnts != 0).any(dim=1)
    e64, a64 = eeb.double(), alpha.double()
    args = (ids[live], cnts[live].double())
    got = ragged_doc_bound(*args, g[live].double(), e64, a64)
    want = ragged_doc_bound(*args, g_ref[live].double(), e64, a64)
    return (got - want).abs() / want.abs()


def _shares_err(ids, cnts, g, g_ref, eeb, alpha):
    return float(_share_gaps(ids, cnts, g, g_ref, eeb, alpha).max())


def _hold_bf16_shares(ids, cnts, g, g_plain, g_64, eeb, alpha,
                      g_jax=None, moving=None):
    """The kernel's shares of the bound against the float64 plain
    version's: within 2e-4, or twice the float32 plain version's gap; on
    a row still moving at the sweep cap (``moving``, given ``g_jax``, the
    JAX package's bf16 result, another float32 reference) also within
    twice the JAX package's gap on that row."""
    bar = max(2e-4, 2.0 * _shares_err(ids, cnts, g_plain, g_64, eeb, alpha))
    gaps = _share_gaps(ids, cnts, g, g_64, eeb, alpha)
    allow = torch.full_like(gaps, bar)
    if g_jax is not None:
        live = (cnts != 0).any(dim=1)
        jax_gaps = _share_gaps(ids, cnts, g_jax, g_64, eeb, alpha)
        allow = torch.where(moving[live], torch.clamp(2.0 * jax_gaps,
                                                      min=bar), allow)
    assert bool((gaps <= allow).all()), (float(gaps.max()), bar)


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("K", BF16_K)
def test_dense_sstats_bf16_build_matches_plain(cuda, K, bf16):
    ct, et, eeb = _sparse_sstats_inputs(250, 1500, K, 36, 10, 0.03, bf16,
                                        cuda, hot=True)
    before = (sstats_mod.LAUNCHES, sstats_mod.BF16_LAUNCHES)
    ss, tok = sstats_mod.dense_sstats(ct, et, eeb, compute_dtype=BF16)
    ss2, tok2 = sstats_mod.dense_sstats(ct, et, eeb, compute_dtype=BF16)
    assert (sstats_mod.LAUNCHES, sstats_mod.BF16_LAUNCHES) == (
        before[0], before[1] + 2)
    ss_p, tok_p = estep_dense_sstats(ct, et, eeb, compute_dtype=BF16)
    ss_32, _ = sstats_mod.dense_sstats(ct, et, eeb)
    torch.cuda.synchronize()
    assert torch.equal(ss, ss2) and torch.equal(tok, tok2)
    _hold_bf16_sstats(ss, ss_p)
    assert float(tok) == pytest.approx(float(tok_p), rel=1e-5)
    # The float32 build is another function: most entries miss the bar.
    off = (ss_32 - ss_p).abs() > 1e-4 * ss_p.abs() + 1e-6 * ss_p.abs().max()
    assert float(off.float().mean()) > 0.1


# -- the bf16 build's tensor-core kernel (K <= 256) ---------------------------
#
# ``csrc/dense_sstats_mma.cuh``: both products on mma.sync over the dense
# tile, every bf16 launch at K <= 256.  K on and off multiples of 16 (zero
# topics up to the next), rows off the 64-row chunk and the splits, columns
# off the 64-column tile, bf16 counts at even K and f32 counts at odd K.

MMA_K = [1, 7, 16, 17, 100, 128, 200, 255, 256]
MMA_COUNTERS = ("LAUNCHES", "BF16_LAUNCHES", "BF16_MMA_LAUNCHES",
                "BF16_WIDE_LAUNCHES")


@pytest.mark.parametrize("density", [0.0, 0.012, 0.03, 1.0])
@pytest.mark.parametrize("K", MMA_K)
def test_dense_sstats_mma_kernel_matches_plain(cuda, K, density):
    """Against the plain version's bf16 mode (``_hold_bf16_sstats``, the
    score to rel 1e-5), two calls bitwise equal, and each call one launch
    of the tensor-core kernel (padded rows and columns; all-zero counts
    give exactly zero)."""
    ct, et, eeb = _sparse_sstats_inputs(333, 500, K, 28, 7, density,
                                        K % 2 == 0, cuda, hot=density > 0)
    pl = sstats_mod.plan(*ct.shape, K, sstats_mod._sms(0),
                         count_bytes=ct.element_size(), compute_dtype=BF16)
    assert pl.mma and pl.kp == -(-K // 16) * 16
    before = [getattr(sstats_mod, c) for c in MMA_COUNTERS]
    ss, tok = sstats_mod.dense_sstats(ct, et, eeb, compute_dtype=BF16)
    ss2, tok2 = sstats_mod.dense_sstats(ct, et, eeb, compute_dtype=BF16)
    assert [getattr(sstats_mod, c) for c in MMA_COUNTERS] == [
        before[0], before[1] + 2, before[2] + 2, before[3]]
    ss_p, tok_p = estep_dense_sstats(ct, et, eeb, compute_dtype=BF16)
    torch.cuda.synchronize()
    assert ss.shape == (K, 500)
    assert torch.equal(ss, ss2) and torch.equal(tok, tok2)
    if density == 0.0:
        assert bool((ss == 0).all()) and float(tok) == 0.0
        return
    _hold_bf16_sstats(ss, ss_p)
    assert float(tok) == pytest.approx(float(tok_p), rel=1e-5)


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_dense_sstats_mma_kernel_topic_range(cuda, bf16):
    """K = 200, ranges off the 16-topic tiles ((3, 37), (100, 200)) and the
    full range: the range's rows and score bitwise the full launch's, each
    launch counted as a range launch of the tensor-core kernel; many row
    splits a tile."""
    K = 200
    ct, et, eeb = _sparse_sstats_inputs(2000, 300, K, 20, 3, 0.03, bf16,
                                        cuda, hot=True, full_row=True)
    mode = dict(compute_dtype=BF16)
    assert sstats_mod.plan(*ct.shape, K, sstats_mod._sms(0),
                           count_bytes=ct.element_size(), **mode).splits > 1
    ss, tok = sstats_mod.dense_sstats(ct, et, eeb, **mode)
    for k0, k1 in ((3, 37), (100, 200), (0, K)):
        before = (sstats_mod.BF16_RANGE_MMA_LAUNCHES,
                  sstats_mod.BF16_MMA_LAUNCHES)
        ss_r, tok_r = sstats_mod.dense_sstats(ct, et, eeb,
                                              topic_range=(k0, k1), **mode)
        narrow = (k0, k1) != (0, K)
        assert (sstats_mod.BF16_RANGE_MMA_LAUNCHES,
                sstats_mod.BF16_MMA_LAUNCHES) == (before[0] + narrow,
                                                  before[1] + 1)
        ss_p, _ = estep_dense_sstats(ct, et, eeb, topic_range=(k0, k1),
                                     **mode)
        torch.cuda.synchronize()
        assert ss_r.shape == (k1 - k0, 300)
        assert torch.equal(ss_r, ss[k0:k1]) and torch.equal(tok_r, tok)
        _hold_bf16_sstats(ss_r, ss_p)


def _bf16_ragged_inputs(K, T, dev, seed=11):
    """40 rows of 1 to T live slots (some rows of the register tile, of
    the slot buffer and past it, by K and T) at a sharp lambda."""
    rng = np.random.default_rng(seed)
    D, V = 40, 3000
    ids = rng.integers(0, V, (D, T)).astype(np.int32)
    cnts = rng.integers(1, 4, (D, T)).astype(np.float32)
    pad = np.arange(T)[None, :] >= rng.integers(1, T + 1, D)[:, None]
    pad[0] = False  # one full row
    ids[pad], cnts[pad] = 0, 0.0
    lam = rng.gamma(0.1, 1.0, (K, V)) * 100.0 + 0.01
    eeb = exp_dirichlet_expectation(torch.tensor(lam, device=dev).float())
    g0 = torch.ones((D, K), dtype=torch.float32, device=dev)
    alpha = torch.full((K,), 1.0 / K, dtype=torch.float32, device=dev)
    return (torch.tensor(ids, device=dev), torch.tensor(cnts, device=dev),
            g0, eeb, alpha)


# (K, T): the register tile (K <= 128, rows <= 128), rows on both sides of
# the slot buffer (~330 entries at K = 100, ~125 at 257, ~49 at 1000, 6 at
# 4096 in the bf16 builds).
_BF16_RAGGED = [(16, 100), (100, 120), (100, 600), (257, 300), (1000, 160),
                (4096, 24)]


@pytest.mark.parametrize("K,T", _BF16_RAGGED)
def test_ragged_bf16_build_matches_plain(cuda, K, T):
    ids, cnts, g0, eeb, alpha = _bf16_ragged_inputs(K, T, cuda)
    live = (cnts != 0).sum(dim=1)
    one = dict(inner_iterations=1, convergence_threshold=0.0)
    geo = {}
    before = (ragged_mod.LAUNCHES, ragged_mod.BF16_LAUNCHES)
    g, s = ragged_mod.ragged_gamma(ids, cnts, g0, eeb, alpha,
                                   compute_dtype=BF16, geometry_out=geo, **one)
    g2, _ = ragged_mod.ragged_gamma(ids, cnts, g0, eeb, alpha,
                                    compute_dtype=BF16, **one)
    assert (ragged_mod.LAUNCHES, ragged_mod.BF16_LAUNCHES) == (
        before[0], before[1] + 2)
    g_p, _ = estep_ragged_gamma(ids, cnts, g0, eeb, alpha, compute_dtype=BF16,
                                **one)
    g_32, _ = ragged_mod.ragged_gamma(ids, cnts, g0, eeb, alpha, **one)
    torch.cuda.synchronize()
    if K > 128 or T > 128:  # else every row takes the register tile
        _hold_route(geo, live)
    assert int(s) == 1 and torch.equal(g, g2)
    _hold_bf16_gamma(g, g_p, cnts != 0)
    assert float(((g_32 - g_p).abs() / g_p.abs()).max()) > 1e-3
    kw = dict(inner_iterations=50, convergence_threshold=1e-5,
              stall_patience=6)
    g, s = ragged_mod.ragged_gamma(ids, cnts, g0, eeb, alpha,
                                   compute_dtype=BF16, **kw)
    g_p, _ = estep_ragged_gamma(ids, cnts, g0, eeb, alpha, compute_dtype=BF16,
                                **kw)
    g_64, _ = estep_ragged_gamma(ids, cnts.double(), g0.double(),
                                 eeb.double(), alpha.double(),
                                 compute_dtype=BF16, **kw)
    torch.cuda.synchronize()
    _hold_bf16_shares(ids, cnts, g, g_p, g_64, eeb, alpha)


def test_ragged_bf16_stalled_rows_keep_their_bound(cuda):
    """At SVI config 5's settings (K = 1000, 30 sweeps, threshold 1e-5,
    patience 6) on a sharp lambda: the rows still updating at S* keep
    their share of the bound (``_hold_bf16_shares``)."""
    ids, cnts, g0, eeb, alpha = _bf16_ragged_inputs(1000, 160, cuda, seed=12)
    kw = dict(inner_iterations=30, convergence_threshold=1e-5,
              stall_patience=6, compute_dtype=BF16)
    rows = torch.zeros((ids.shape[0],), dtype=torch.int32, device=cuda)
    g, s = ragged_mod.ragged_gamma(ids, cnts, g0, eeb, alpha,
                                   row_sweeps_out=rows, **kw)
    g_p, _ = estep_ragged_gamma(ids, cnts, g0, eeb, alpha, **kw)
    g_64, _ = estep_ragged_gamma(ids, cnts.double(), g0.double(),
                                 eeb.double(), alpha.double(), **kw)
    torch.cuda.synchronize()
    m = (rows == int(s)) & (cnts != 0).any(dim=1)
    assert bool(m.any())
    _hold_bf16_shares(ids[m], cnts[m], g[m], g_p[m], g_64[m], eeb, alpha)


# (D, V, K, bf16 counts, densest row): rows resident and past the slot
# buffer at each K (at K <= 128 rows of the register tile too).
_BF16_DENSE = [(60, 4000, 16, True, 0.5), (60, 3000, 100, False, 0.2),
               (60, 3000, 257, True, 0.2), (40, 1500, 1000, False, 0.2),
               (24, 600, 4096, True, 0.2)]


@pytest.mark.parametrize("D,V,K,bf16,dmax", _BF16_DENSE)
def test_dense_estep_bf16_build_matches_plain(cuda, D, V, K, bf16, dmax):
    rng = np.random.default_rng(K)
    counts = ((rng.random((D, V)) < rng.uniform(0.01, dmax, (D, 1)))
              * rng.integers(1, 4, (D, V))).astype(np.float32)
    counts[0] = 0.0
    counts[0, :3] = 2.0  # a row every slot buffer holds
    ct = torch.tensor(counts, device=cuda)
    ct = ct.to(torch.bfloat16) if bf16 else ct
    lam = rng.gamma(0.1, 1.0, (K, V)) * 100.0 + 0.01
    eeb = exp_dirichlet_expectation(torch.tensor(lam, device=cuda).float())
    g0 = torch.ones((D, K), dtype=torch.float32, device=cuda)
    alpha = torch.full((K,), 1.0 / K, dtype=torch.float32, device=cuda)
    one = dict(inner_iterations=1, convergence_threshold=0.0)
    geo = {}
    before = (dense_mod.LAUNCHES, dense_mod.BF16_LAUNCHES,
              sstats_mod.LAUNCHES, sstats_mod.BF16_LAUNCHES)
    g, ss, tok, _ = dense_mod.dense_estep(ct, g0, eeb, alpha,
                                          compute_dtype=BF16,
                                          geometry_out=geo, **one)
    assert (dense_mod.LAUNCHES, dense_mod.BF16_LAUNCHES, sstats_mod.LAUNCHES,
            sstats_mod.BF16_LAUNCHES) == (before[0], before[1] + 1,
                                          before[2], before[3] + 1)
    g_p, _, tok_p, _ = estep_dense(ct, g0, eeb, alpha, compute_dtype=BF16,
                                   **one)
    ss_at_k, _ = estep_dense_sstats(ct, exp_dirichlet_expectation(g), eeb,
                                    compute_dtype=BF16)
    torch.cuda.synchronize()
    nnz = (ct != 0).sum(dim=1)
    _hold_route(geo, nnz)
    _hold_bf16_gamma(g, g_p, ct != 0)
    _hold_bf16_sstats(ss, ss_at_k)
    assert float(tok) == pytest.approx(float(tok_p), rel=1e-4)
    kw = dict(inner_iterations=50, convergence_threshold=1e-5,
              stall_patience=6, compute_dtype=BF16)
    g = dense_mod.dense_estep(ct, g0, eeb, alpha, **kw)[0]
    g_p = estep_dense(ct, g0, eeb, alpha, **kw)[0]
    g_64 = estep_dense(ct.double(), g0.double(), eeb.double(), alpha.double(),
                       **kw)[0]
    order = torch.sort((ct != 0).to(torch.uint8), dim=1, descending=True,
                       stable=True).indices[:, :int(nnz.max())]
    torch.cuda.synchronize()
    _hold_bf16_shares(order.to(torch.int32), ct.gather(1, order).float(), g,
                      g_p, g_64, eeb, alpha)


def test_bf16_table_is_checked(cuda):
    """A bf16 request launches the bf16 build on a bf16 table and refuses
    the float32 table (no fallback to the float32 build)."""
    ids, cnts, g0, eeb, alpha = _bf16_ragged_inputs(100, 40, cuda)
    with pytest.raises(ValueError, match="gather_table"):
        ragged_mod.ragged_gamma(ids, cnts, g0, eeb, alpha,
                                eeb_t=ragged_mod.gather_table(eeb),
                                compute_dtype=BF16)
    with pytest.raises(ValueError, match="gather_table"):
        ragged_mod.ragged_gamma(ids, cnts, g0, eeb, alpha,
                                eeb_t=ragged_mod.gather_table(eeb, BF16))


# -- the bf16 warp-group kernel (K <= 256, rows that fit a group) --------------
#
# ``csrc/row_fixed_point_groups.cuh``: steps A and B on mma.sync.  Held as
# the bf16 builds are above (one pinned sweep by ``_hold_bf16_gamma``, the
# exit rule by each row's share of the bound, ``_hold_bf16_shares``),
# with S*, each row's sweeps and its first exitable sweep equal to those
# the plain version's loop takes on the kernel's own trajectory
# (``_exit_record``), two calls bitwise equal,
# and the launch on the route of its widest row: a group's capacity
# (``row_fixed_point.group_capacity``) takes the new kernel, one entry
# more the bf16 kernels it replaces.

GROUP_K = [1, 7, 16, 100, 128, 200, 256]
# Live entries of the rows besides the capacity (and capacity + 1).
GROUP_LIVE = (0, 1, 15, 16, 17, 31, 32, 33)


def _group_rows(K, past, seed=13):
    """(ids [D, T], cnts [D, T], the rows' live counts): three rows of each
    of GROUP_LIVE and of the group capacity at K (``past``: and of one
    entry more) in a shuffled order, distinct ids scattered over the
    row's slots, counts 1 to 3."""
    rng = np.random.default_rng(seed + K)
    cap = rfp.group_capacity(K)
    live = [n for n in (*GROUP_LIVE, cap, *([cap + 1] if past else ()))
            for _ in range(3)]
    rng.shuffle(live)
    D, T, V = len(live), max(live), 3000
    ids = np.zeros((D, T), np.int32)
    cnts = np.zeros((D, T), np.float32)
    for d, n in enumerate(live):
        at = np.sort(rng.choice(T, n, replace=False))
        ids[d, at] = rng.choice(V, n, replace=False)
        cnts[d, at] = rng.integers(1, 4, n)
    return ids, cnts, np.array(live), V


def _group_inputs(K, past, dev, layout):
    """The rows of ``_group_rows`` as the layout takes them (ragged: ids
    and counts; dense: [D, V] counts, bf16 at even K, f32 at odd), a sharp
    lambda's expElogbeta, gamma inits drawn with numpy, alpha 1 / K."""
    ids, cnts, live, V = _group_rows(K, past)
    rng = np.random.default_rng(K)
    lam = rng.gamma(0.1, 1.0, (K, V)) * 100.0 + 0.01
    eeb = exp_dirichlet_expectation(torch.tensor(lam, device=dev).float())
    g0 = torch.tensor(rng.gamma(100.0, 0.01, (ids.shape[0], K)),
                      dtype=torch.float32, device=dev)
    alpha = torch.full((K,), 1.0 / K, dtype=torch.float32, device=dev)
    if layout == "ragged":
        rows = (torch.tensor(ids, device=dev), torch.tensor(cnts, device=dev))
    else:
        counts = np.zeros((ids.shape[0], V), np.float32)
        for d in range(ids.shape[0]):
            on = cnts[d] != 0
            counts[d, ids[d, on]] = cnts[d, on]
        ct = torch.tensor(counts, device=dev)
        rows = (ct.to(torch.bfloat16) if K % 2 == 0 else ct,)
    return rows, g0, eeb, alpha, live


def _exit_record(traj, kw):
    """The plain version's loop (``ops/estep.py::_fixed_point``) on a given
    trajectory ``traj`` (gamma after s unfrozen sweeps, s = 0, 1, ..), with
    each row's record kept: (gamma, S*, each row's sweeps to min(its done
    sweep, S*), each row's first exitable sweep or 0)."""
    from pylda_tpu_torch.ops.estep import _exit_update

    thresh, patience = kw["convergence_threshold"], kw["stall_patience"]
    use_stall = patience > 0 and thresh > 0.0
    gamma = traj[0]
    D = gamma.shape[0]
    best = torch.full((D,), float("inf"), dtype=gamma.dtype,
                      device=gamma.device)
    age = torch.zeros((D,), dtype=torch.int32, device=gamma.device)
    done = torch.zeros((D,), dtype=torch.bool, device=gamma.device)
    sweeps = torch.zeros((D,), dtype=torch.int32, device=gamma.device)
    first = torch.zeros((D,), dtype=torch.int32, device=gamma.device)
    i = 0
    while i < kw["inner_iterations"]:
        new = torch.where(done[:, None], gamma, traj[i + 1])
        change = (new - gamma).abs().mean(dim=-1)
        sweeps += (~done).int()
        best, age, done, exitable = _exit_update(
            change, best, age, done, thresh, use_stall, patience)
        i += 1
        first = torch.where(exitable & (first == 0), i, first)
        gamma = new
        if bool(exitable.all()):
            break
    return gamma, i, sweeps, first


def _group_call(layout, rows, g0, eeb, alpha, live, kw, segments=None,
                **outs):
    if layout == "ragged":
        return ragged_mod.ragged_gamma(*rows, g0, eeb, alpha, **kw,
                                       compute_dtype=BF16, segments=segments,
                                       **outs)
    g, _, _, s = dense_mod.dense_estep(rows[0], g0, eeb, alpha, **kw,
                                       compute_dtype=BF16,
                                       max_nnz=int(live.max()), **outs)
    return g, s


def _plain_call(layout, rows, g0, eeb, alpha, kw, segments=None):
    if layout == "ragged":
        return estep_ragged_gamma(*rows, g0, eeb, alpha, **kw,
                                  compute_dtype=BF16, segments=segments)
    g, _, _, s = estep_dense(rows[0], g0, eeb, alpha, **kw,
                             compute_dtype=BF16)
    return g, s


def _jax_call(layout, rows, g0, eeb, alpha, kw, segments=None):
    """The JAX package's bf16 gamma on the CPU (``torch_jax_gamma``: dense
    rows through ``estep_dense``, each ragged segment's rows alone through
    ``estep_ragged_gamma``), on the card."""
    from torch_jax_gamma import jax_gamma

    def host(t):
        return t.detach().float().cpu().numpy()

    if layout == "ragged":
        rows_kw = dict(ids=rows[0].cpu().numpy(), cnts=host(rows[1]),
                       segments=segments)
    else:
        rows_kw = dict(counts=host(rows[0]))
    g = jax_gamma(host(g0), host(eeb), host(alpha), kw, **rows_kw)
    return torch.as_tensor(g, device=g0.device)


def _entries(layout, rows):
    """(ids, counts) of each row's live entries, for the bound's shares."""
    if layout == "ragged":
        return rows
    ct = rows[0]
    width = int((ct != 0).sum(dim=1).max())
    order = torch.sort((ct != 0).to(torch.uint8), dim=1, descending=True,
                       stable=True).indices[:, :width]
    return order.to(torch.int32), ct.gather(1, order).float()


@pytest.mark.parametrize("past", [False, True], ids=["capacity", "past"])
@pytest.mark.parametrize("K", GROUP_K)
@pytest.mark.parametrize("layout", ["ragged", "dense"])
def test_group_kernel_matches_plain(cuda, layout, K, past):
    """Rows of 0 to capacity live entries (``past``: and capacity + 1,
    which sends the launch to the bf16 kernels the group kernel replaced)
    at K off and on multiples of 16; the ragged rows in two segments."""
    rows, g0, eeb, alpha, live = _group_inputs(K, past, cuda, layout)
    D = g0.shape[0]
    seg = (D // 3, D - D // 3) if layout == "ragged" else None
    mod = ragged_mod if layout == "ragged" else dense_mod
    one = dict(inner_iterations=1, convergence_threshold=0.0)
    counters = ("LAUNCHES", "BF16_LAUNCHES", "BF16_GROUP_LAUNCHES")
    before = [getattr(mod, c) for c in counters]
    geo = {}
    g, s = _group_call(layout, rows, g0, eeb, alpha, live, one, seg,
                       geometry_out=geo)
    g2, _ = _group_call(layout, rows, g0, eeb, alpha, live, one, seg)
    assert [getattr(mod, c) for c in counters] == [
        before[0], before[1] + 2, before[2] + 2 * (not past)]
    cap = rfp.group_capacity(K)
    if past:
        assert geo["route"] != "groups"
    else:
        assert (geo["route"], geo["nmax"], geo["resident"]) == (
            "groups", cap, cap)
    g_p, s_p = _plain_call(layout, rows, g0, eeb, alpha, one, seg)
    torch.cuda.synchronize()
    assert torch.equal(g, g2) and torch.equal(s, s_p)
    nonzero = (rows[0] if layout == "dense" else rows[1]) != 0
    _hold_bf16_gamma(g, g_p, nonzero)
    # The exit rule: S*, each row's sweeps and first exitable sweep, and
    # its share of the bound.
    kw = dict(inner_iterations=50, convergence_threshold=1e-5,
              stall_patience=6)
    row_sweeps = torch.zeros((D,), dtype=torch.int32, device=cuda)
    row_exit = torch.zeros((D,), dtype=torch.int32, device=cuda)
    g, s = _group_call(layout, rows, g0, eeb, alpha, live, kw, seg,
                       row_sweeps_out=row_sweeps, row_exit_out=row_exit)
    g2, _ = _group_call(layout, rows, g0, eeb, alpha, live, kw, seg)
    rows_64 = rows[:-1] + (rows[-1].double(),)  # the counts in float64
    g_64, _ = _plain_call(layout, rows_64, g0.double(), eeb.double(),
                          alpha.double(), kw, seg)
    torch.cuda.synchronize()
    assert torch.equal(g, g2)
    # The exit rule of the plain version's loop on each one's own
    # trajectory (gamma after n pinned sweeps): on the plain version's it
    # gives the plain version's gamma and S*, on the kernel's the kernel's
    # gamma, S*, row sweeps and first exitable sweeps, bit for bit.  (The
    # two trajectories part where a ratio's rounding flips, and the bf16
    # map limit-cycles there, so the two S* may differ: the bf16 build
    # before this kernel gave S* 50 against the plain version's 31 at
    # K = 7.)
    pin = dict(convergence_threshold=0.0)
    traj = [g0] + [_group_call(layout, rows, g0, eeb, alpha, live,
                               dict(pin, inner_iterations=n), seg)[0]
                   for n in range(1, kw["inner_iterations"] + 1)]
    traj_p = [g0] + [_plain_call(layout, rows, g0, eeb, alpha,
                                 dict(pin, inner_iterations=n), seg)[0]
                     for n in range(1, kw["inner_iterations"] + 1)]
    g_p, s_p = _plain_call(layout, rows, g0, eeb, alpha, kw, seg)
    torch.cuda.synchronize()
    r0 = 0
    moving = torch.zeros((D,), dtype=torch.bool, device=cuda)
    for i, n in enumerate(seg or (D,)):
        part = slice(r0, r0 + n)
        g_t, s_t, sweeps_t, _ = _exit_record([t[part] for t in traj_p], kw)
        assert torch.equal(g_t, g_p[part])
        assert int(s_p.reshape(-1)[i]) == s_t
        moving[part] = sweeps_t == kw["inner_iterations"]
        g_t, s_t, sweeps_t, first_t = _exit_record([t[part] for t in traj],
                                                   kw)
        assert torch.equal(g[part], g_t)
        assert int(s.reshape(-1)[i]) == s_t
        assert torch.equal(row_sweeps[part], sweeps_t)
        assert torch.equal(row_exit[part], first_t)
        r0 += n
    # On the rows the plain version's loop still sweeps at the cap, the JAX
    # package's bf16 result is one more float32 reference for the shares'
    # bar (there which float32 order drifts less from float64 is chance).
    g_j = _jax_call(layout, rows, g0, eeb, alpha, kw, seg)
    ids, cnts = _entries(layout, rows)
    _hold_bf16_shares(ids, cnts, g, g_p, g_64, eeb, alpha, g_jax=g_j,
                      moving=moving)


def test_rows_kernel_map_along_its_trajectory(cuda):
    """ROADMAP Queue 3's input (``_group_inputs(128, True, .., "dense")``,
    whose ``dense-128-past`` case misses the share hold) on its worst row
    alone: row 28, 16 live entries, the largest share gap
    (``scripts/torch_gamma_bf16_rows_diagnose.py``), on the bf16
    row-resident kernel (``max_nnz`` the batch's 193: the "rows" route).
    At every pinned sweep n = 1..50 the kernel's gamma after n sweeps is
    one plain bf16 sweep from the kernel's own gamma after n - 1
    (``_hold_bf16_gamma``; at most 4.4e-6 rel on the card): the kernel
    computes the bf16 map at every state it visits, so its trajectory and
    the plain version's part by the growth of float32 rounding
    differences along a row still moving at the sweep cap, not by a
    rounding point of the kernel."""
    rows, g0, eeb, alpha, live = _group_inputs(128, True, cuda, "dense")
    ct, g_prev = rows[0][28:29], g0[28:29]
    assert int((ct != 0).sum()) == 16
    pin = dict(convergence_threshold=0.0, compute_dtype=BF16)
    geo, nmax = {}, int(live.max())
    for n in range(1, 51):
        g_n = dense_mod.dense_estep(ct, g0[28:29], eeb, alpha,
                                    inner_iterations=n, max_nnz=nmax,
                                    geometry_out=geo, **pin)[0]
        step = estep_dense(ct, g_prev, eeb, alpha, inner_iterations=1,
                           **pin)[0]
        torch.cuda.synchronize()
        assert geo["route"] == "rows"
        _hold_bf16_gamma(g_n, step, ct != 0)
        g_prev = g_n


def test_group_kernel_stalled_rows_keep_their_bound(cuda):
    """``test_ragged_bf16_stalled_rows_keep_their_bound`` on the warp-group
    kernel: K = 100, rows of 1 to 160 live entries (the ragged flagship's
    widest bucket), 30 sweeps, threshold 1e-5, patience 6, a sharp lambda:
    the rows still updating at S* keep their share of the bound
    (``_hold_bf16_shares``)."""
    ids, cnts, g0, eeb, alpha = _bf16_ragged_inputs(100, 160, cuda, seed=12)
    kw = dict(inner_iterations=30, convergence_threshold=1e-5,
              stall_patience=6, compute_dtype=BF16)
    rows = torch.zeros((ids.shape[0],), dtype=torch.int32, device=cuda)
    geo = {}
    g, s = ragged_mod.ragged_gamma(ids, cnts, g0, eeb, alpha,
                                   row_sweeps_out=rows, geometry_out=geo,
                                   **kw)
    g_p, _ = estep_ragged_gamma(ids, cnts, g0, eeb, alpha, **kw)
    g_64, _ = estep_ragged_gamma(ids, cnts.double(), g0.double(),
                                 eeb.double(), alpha.double(), **kw)
    torch.cuda.synchronize()
    assert geo["route"] == "groups"
    m = (rows == int(s)) & (cnts != 0).any(dim=1)
    assert bool(m.any())
    _hold_bf16_shares(ids[m], cnts[m], g[m], g_p[m], g_64[m], eeb, alpha)


# -- the sampling engines on the card (plain PyTorch, no kernel) ---------------


def _sampling_problem(D, L, V, K, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, V, size=(D, L)).astype(np.int64)
    mask = (np.arange(L)[None, :]
            < rng.integers(1, L + 1, size=(D, 1))).astype(np.float32)
    tokens *= mask.astype(np.int64)
    log_tw = np.log(rng.dirichlet(np.full(V, 0.1), size=K)).astype(np.float32)
    z0 = rng.integers(0, K, size=(D, L)).astype(np.int32)
    return [torch.as_tensor(x) for x in
            (tokens, mask, log_tw, np.full(K, 0.3, np.float32), z0)]


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("K", [16, 100])
@pytest.mark.parametrize("sampler", ["cdf", "gumbel", "race"])
def test_sampling_sweep_card_matches_cpu(cuda, sampler, K, B):
    """The sweep on the card and on the CPU from the same noise (drawn on
    the CPU): z and n_dk equal except on at most 0.1% of the documents (a
    draw within an ulp of a boundary), counts conserved on the card."""
    from pylda_tpu_torch.ops.sampling import (
        draw_noise,
        noise_shape,
        stream,
        sweep_doc_topics,
    )

    D, L, V = 2048, 40, 700
    args = _sampling_problem(D, L, V, K)
    g = stream("cpu", K, B)
    noise = [draw_noise(sampler, noise_shape(sampler, D, L, K, B), g)
             for _ in range(3)]
    kw = dict(num_types=V, burn_in=1, num_samples=2, sampler=sampler,
              block_positions=B)
    out = {}
    for dev in (cuda, "cpu"):
        out[str(dev)] = [x.cpu() for x in sweep_doc_topics(
            *[a.to(dev) for a in args], lambda s: noise[s], **kw)]
    _g, ss, z, ndk = out[str(cuda)]
    _gc, _ssc, zc, ndkc = out["cpu"]
    mask = args[1]
    np.testing.assert_array_equal(ndk.sum(1).numpy(), mask.sum(1).numpy())
    assert float(ss.sum()) == float(mask.sum())
    differ = ((z != zc).any(1) | (ndk != ndkc).any(1)).sum().item()
    assert differ <= 1e-3 * D


def test_count_table_card_bitwise_equals_cpu(cuda):
    from pylda_tpu_torch.ops import sampling

    tokens, mask, _, _, z = _sampling_problem(3000, 50, 5000, 100, seed=1)
    cpu = sampling.count_table(tokens, mask, z, 100, 5000)
    card = sampling.count_table(tokens.to(cuda), mask.to(cuda), z.to(cuda),
                                100, 5000)
    assert torch.equal(card.cpu(), cpu)


@pytest.mark.parametrize("topic_range, vocab_range", [
    (None, (0, 2500)), (None, (2500, 5000)), ((0, 50), None),
    ((50, 100), None)])
def test_count_table_block_on_card(cuda, topic_range, vocab_range):
    """A rank's block of n_kv counted on the card (a model group's split):
    the whole table's block, bit for bit."""
    from pylda_tpu_torch.ops import sampling

    tokens, mask, _, _, z = _sampling_problem(3000, 50, 5000, 100, seed=1)
    args = (tokens.to(cuda), mask.to(cuda), z.to(cuda), 100, 5000)
    whole = sampling.count_table(*args)
    (k0, k1), (v0, v1) = topic_range or (0, 100), vocab_range or (0, 5000)
    block = sampling.count_table(*args, topic_range, vocab_range)
    assert torch.equal(block, whole[k0:k1, v0:v1])


@pytest.mark.parametrize("mode", ["gibbs", "hybrid"])
def test_sampling_engines_on_card(cuda, mode):
    """make_engine places both engines on the card; counts are conserved
    there and no CUDA kernel of the package runs."""
    from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
    from pylda_tpu_torch.models import Hybrid, MonteCarlo, make_engine
    from pylda_tpu_torch.ops.sampling import count_table
    from pylda_tpu_torch.utils.config import LDAConfig

    corpus, _, _ = synthetic_corpus(num_docs=300, num_topics=8,
                                    num_types=900, mean_doc_length=60.0,
                                    seed=3)
    eng = make_engine(LDAConfig(number_of_topics=8, inference_mode=mode,
                                number_of_samples=3, burn_in_sweeps=2,
                                doc_pad_multiple=16))
    assert type(eng) is {"gibbs": MonteCarlo, "hybrid": Hybrid}[mode]
    eng.initialize(corpus)
    mods = (ragged_mod, sstats_mod, dense_mod)
    before = [(m.LAUNCHES, m.BF16_LAUNCHES) for m in mods]
    objs = eng.learning_many(4)
    assert [(m.LAUNCHES, m.BF16_LAUNCHES) for m in mods] == before
    assert np.isfinite(objs).all() and objs[-1] > objs[0]
    if mode == "gibbs":
        assert eng._n_kv.is_cuda
        assert float(eng._n_kv.sum()) == corpus.num_tokens
        recount = sum(count_table(b.tokens, b.token_mask, z, 8, 900)
                      for b, z in zip(eng._buckets, eng._z))
        assert torch.equal(recount, eng._n_kv)
        for b, ndk in zip(eng._buckets, eng._ndk):
            assert torch.equal(ndk.sum(1), b.token_mask.sum(1))
    else:
        assert eng.state.lam.is_cuda
        sstats = eng.state.lam - eng.state.eta[None, :]
        assert float(sstats.sum()) == pytest.approx(corpus.num_tokens,
                                                    rel=1e-5)
    assert np.isfinite(eng.perplexity(corpus.subset(range(40))))


# -- the scatter E-step (estep_ragged: the gamma kernel + the row scatter) ----


def _scatter_problem(D, T, K, V, live, seed=0):
    """A ragged block (padding slots and two padding rows) whose few words
    each fill many slots, so a word's run spans many rows: the order of
    its sum is what makes the scatter repeatable or not."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (D, T)).astype(np.int32)
    cnts = rng.integers(1, 4, (D, T)).astype(np.float32)
    ids[:, live:] = 0
    cnts[:, live:] = 0.0
    ids[-2:] = 0
    cnts[-2:] = 0.0
    lam = rng.gamma(0.1, 1.0, (K, V)) * 100.0 + 0.01
    eeb = exp_dirichlet_expectation(torch.tensor(lam)).float()
    return (torch.tensor(ids), torch.tensor(cnts), eeb,
            torch.full((K,), 1.0 / K))


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [16, 200, 1000])
def test_estep_ragged_card_matches_cpu(cuda, K, cd):
    """At pinned sweeps (12, above K = 256 three; bf16 mode: one) the
    card's estep_ragged — the gamma kernel, then the scatter — against
    the CPU's (the plain version): gamma rtol 1e-4 (atol 1e-4), the score
    rel 1e-5, sstats rel 1e-5 of the largest entry; one kernel launch.
    In bf16 mode expEtheta is rounded to bf16 in phinorm, and where the
    two gammas differ at 1e-6 a rounded value may land one bf16 ulp
    (2^-8) apart, moving each term of an entry's sum by at most about
    2^-8 of itself: there the route's sstats are held entry by entry to
    2^-7 of the entry (atol 1e-6 of the largest) and in all to 1e-3 of
    the largest entry (seen 1.3e-4 at K = 1000), and the scatter at one
    expEtheta on both devices to 1e-5."""
    from pylda_tpu_torch.ops.estep import estep_ragged, scatter_sstats

    ids, cnts, eeb, alpha = _scatter_problem(131, 48, K, 700, 37)
    # Pinned sweeps as the gamma kernels' own checks: above K = 256 float32
    # reassociation grows past the tolerance within 12 sweeps.
    kw = dict(inner_iterations=(12 if K <= 256 else 3) if cd == "float32"
              else 1, convergence_threshold=0.0, compute_dtype=cd)
    args = (ids, cnts, torch.ones((131, K)), eeb, alpha)
    before = ragged_mod.LAUNCHES + ragged_mod.BF16_LAUNCHES
    g, ss, tok, s = estep_ragged(*[a.to(cuda) for a in args], **kw)
    assert ragged_mod.LAUNCHES + ragged_mod.BF16_LAUNCHES == before + 1
    g_c, ss_c, tok_c, s_c = estep_ragged(*args, **kw)
    assert int(s) == int(s_c) == kw["inner_iterations"]
    np.testing.assert_allclose(g.cpu().numpy(), g_c.numpy(), rtol=1e-4,
                               atol=1e-4)
    diff, top = (ss.cpu() - ss_c).abs(), float(ss_c.abs().max())
    err = float(diff.max()) / top
    assert err <= (1e-5 if cd == "float32" else 1e-3), err
    if cd == BF16:
        assert bool((diff <= 2.0 ** -7 * ss_c.abs() + 1e-6 * top).all())
    assert float(tok) == pytest.approx(float(tok_c), rel=1e-5)
    et = exp_dirichlet_expectation(g)
    ss_e = scatter_sstats(ids.to(cuda), cnts.to(cuda), et, eeb.to(cuda),
                          ragged_mod.gather_table(eeb.to(cuda), cd),
                          compute_dtype=cd)[0].cpu()
    ss_ec = scatter_sstats(ids, cnts, et.cpu(), eeb,
                           ragged_mod.gather_table(eeb, cd),
                           compute_dtype=cd)[0]
    assert float((ss_e - ss_ec).abs().max() / ss_ec.abs().max()) <= 1e-5


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_scatter_card_bitwise_repeatable(cuda, cd):
    """Two calls give the same bits (no atomics: a stable sort and one
    segment a word), and the card's scatter at the CPU's gamma agrees
    with the CPU's to rel 1e-5 of the largest entry."""
    from pylda_tpu_torch.ops.estep import estep_ragged, scatter_sstats
    from pylda_tpu_torch.ops.row_fixed_point import gather_table

    ids, cnts, eeb, alpha = _scatter_problem(2000, 64, 100, 40, 60, seed=2)
    dev_args = [a.to(cuda) for a in (ids, cnts, torch.ones((2000, 100)), eeb,
                                     alpha)]
    eeb_t = gather_table(dev_args[3], cd)
    outs = [estep_ragged(*dev_args, compute_dtype=cd, eeb_t=eeb_t)
            for _ in range(2)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    et = exp_dirichlet_expectation(outs[0][0]).cpu()
    ss, tok = scatter_sstats(ids.to(cuda), cnts.to(cuda), et.to(cuda),
                             dev_args[3], eeb_t, compute_dtype=cd)
    ss_c, tok_c = scatter_sstats(ids, cnts, et, eeb, gather_table(eeb, cd),
                                 compute_dtype=cd)
    assert float((ss.cpu() - ss_c).abs().max() / ss_c.abs().max()) <= 1e-5
    assert float(tok) == pytest.approx(float(tok_c), rel=1e-5)


@pytest.mark.parametrize("engine", ["vb", "svi"])
def test_scatter_route_engine_card_matches_cpu(cuda, engine):
    """sstats_mode="scatter" on the ragged layout, on the card against the
    CPU from one lambda: bounds rel 1e-4; the gamma kernel runs, the
    sstats kernel does not."""
    from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
    from pylda_tpu_torch.models import make_engine
    from pylda_tpu_torch.utils.config import LDAConfig

    corpus, _, _ = synthetic_corpus(num_docs=300, num_topics=16,
                                    num_types=3000, mean_doc_length=60.0,
                                    seed=5)
    cfg = LDAConfig(number_of_topics=16, inference_mode=engine,
                    dense_vocab_threshold=2048, doc_pad_multiple=16,
                    batch_size=64, tau0=16.0, sstats_mode="scatter",
                    hyper_parameter_optimize_interval=2)
    lam0 = np.random.default_rng(7).gamma(100.0, 0.01, (16, 3000))
    runs = {}
    for where in (cuda, "cpu"):
        eng = make_engine(cfg, device=where)
        eng.initialize(corpus, lam_init=lam0)
        before = (ragged_mod.LAUNCHES, sstats_mod.LAUNCHES)
        runs[str(where)] = [eng.learning() for _ in range(2)] + \
            eng.learning_many(2)
        launched = (ragged_mod.LAUNCHES - before[0],
                    sstats_mod.LAUNCHES - before[1])
        assert launched[1] == 0
        assert (launched[0] > 0) == (where != "cpu")
    np.testing.assert_allclose(runs[str(cuda)], runs["cpu"], rtol=1e-4)


# -- the random gamma inits and phase_timings on the card ----------------------------


@pytest.mark.parametrize("mode", ["normal", "gamma"])
def test_gamma_init_draws_on_card(cuda, mode):
    """The card's generator draws other bits than the CPU's, so the
    draws are held by their statistics at 10^6 draws (mean 1 and std 0.1
    within 0.005, min 0.2 for "normal") and repeat bit for bit from one
    seed."""
    from pylda_tpu_torch.models.vb import gamma_init
    from pylda_tpu_torch.ops.sampling import stream

    g = gamma_init((10_000, 100), mode, stream(cuda, 0, 0x60A4, 0, 0))
    assert g.device.type == "cuda" and g.dtype == torch.float32
    assert abs(float(g.mean()) - 1.0) < 0.005
    assert abs(float(g.std()) - 0.1) < 0.005
    assert float(g.min()) >= (0.2 if mode == "normal" else 0.0)
    again = gamma_init((10_000, 100), mode, stream(cuda, 0, 0x60A4, 0, 0))
    assert torch.equal(g, again)


@pytest.mark.parametrize("mode,extra", [
    ("vb", dict(dense_vocab_threshold=0)),
    ("vb", dict()),
    ("svi", dict(dense_vocab_threshold=0)),
    ("gibbs", dict()),
    ("hybrid", dict()),
], ids=["vb_ragged", "vb_dense", "svi", "gibbs", "hybrid"])
def test_phase_timings_leave_state_on_card(cuda, mode, extra):
    """Timing on the card (CUDA events) leaves lambda, alpha, eta, the
    step, _t and Gibbs's tables bitwise as they were, and every phase
    takes a positive time."""
    from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
    from pylda_tpu_torch.models import make_engine
    from pylda_tpu_torch.utils.config import LDAConfig

    corpus = synthetic_corpus(num_docs=300, num_topics=12, num_types=900,
                              mean_doc_length=50.0, seed=4)[0]
    eng = make_engine(LDAConfig(number_of_topics=12, inference_mode=mode,
                                gamma_init="gamma", batch_size=100,
                                number_of_samples=2, burn_in_sweeps=1,
                                seed=0, **extra), device=cuda)
    eng.initialize(corpus)
    eng.learning()
    st = eng.state
    before = [t.clone() for t in (st.lam, st.alpha, st.eta, st.step)]
    tables = ([eng._n_kv.clone()] + [z.clone() for z in eng._z]
              if mode == "gibbs" else [])
    t_before = getattr(eng, "_t", None)
    times = eng.phase_timings(repeats=2)
    assert times and all(v > 0 for v in times.values()), times
    st = eng.state
    assert all(torch.equal(a, b) for a, b in
               zip(before, (st.lam, st.alpha, st.eta, st.step)))
    if mode == "gibbs":
        assert all(torch.equal(a, b) for a, b in
                   zip(tables, [eng._n_kv] + list(eng._z)))
    assert getattr(eng, "_t", None) == t_before
