"""The schedule of the dense sufficient-statistics kernel, on the CPU.

``csrc/dense_sstats.cu`` computes the function of ``estep_dense_sstats``
over the nonzero counts only, in its own order.  At K <= 256 (the
one-pass kernel): vocab tiles of 64 columns; row splits from
``ops/sstats.py::plan``; in each split, chunks of rows whose nonzeros are
compacted into one row mask a column; the owners of a column walk its
mask in row order (step t takes each column's t-th nonzero), adding
expEtheta[d] * C / phinorm into the column's sums; the splits' partial
sums meet in split order and are scaled by expElogbeta.  Here that
schedule runs in PyTorch from the same plan and must give the plain
version's result: to 1e-12 in float64, and, in float32, JAX's
``estep_dense_sstats`` to rtol 2e-5.  Above K = 256 the cluster kernel's
order (``torch_sstats_model.cluster_sstats``) is held the same way at
K in {257, 300, 512, 513, 1000, 1025, 2048, 2049, 4096}, at the plan's
cluster (1, 2, 4 or 8 CTAs), with a topic range bitwise the full call's
rows.  The bf16 build's tensor-core kernel at K <= 256
(``torch_sstats_model.mma_sstats``: 16 x 8 output tiles, k16 steps,
64-row chunks, splits met in order) is held against the plain version in
float64 (both operand modes, rtol 1e-12) and, in float32 with bf16
operands, against JAX's ``estep_dense_sstats`` and the Pallas kernel in
interpret mode at K in {1, 7, 100, 200, 256}, with a topic range bitwise
the full model's rows.  The plan's own tests:
>= 2 CTAs an SM at both flagship shapes on 132 SMs, splits that cover
every row, scratch that covers every split, the builds read from the
source, and which K each kernel takes.
"""

import dataclasses
import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylda_tpu.ops.estep import estep_dense_sstats as jax_dense_sstats
from pylda_tpu.ops.pallas_sstats import pallas_dense_sstats
from pylda_tpu_torch.ops import _build
from pylda_tpu_torch.ops import sstats as sstats_mod
from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation
from pylda_tpu_torch.ops.estep import estep_dense_sstats
from torch_sstats_model import cluster_sstats, mma_sstats

H100_SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def kernel_schedule(counts, et, eeb, eps, pl):
    """(sstats [K, V], score) in the kernel's order under plan ``pl``."""
    D, Vc = counts.shape
    K, V = eeb.shape
    dt = et.dtype
    TILE = pl.cols
    width = pl.tiles * TILE
    c = torch.nn.functional.pad(counts.to(dt), (0, width - Vc))
    eeb_w = torch.nn.functional.pad(eeb, (0, width - V))
    sstats = torch.zeros((K, V), dtype=dt)
    score = torch.zeros((), dtype=torch.float64)
    for tile in range(pl.tiles):
        cols = slice(tile * TILE, (tile + 1) * TILE)
        b = eeb_w[:, cols].T  # [TILE, K]: the staged column of each owner
        partials = []
        for split in range(pl.splits):
            acc = torch.zeros((TILE, K), dtype=dt)
            lo = split * pl.rows_per_split
            hi = min(D, lo + pl.rows_per_split)
            for d0 in range(lo, hi, sstats_mod.CHUNK_ROWS):
                block = c[d0:min(hi, d0 + sstats_mod.CHUNK_ROWS), cols]
                # A column's nonzero rows, ascending: its mask's bits.
                rows = [torch.nonzero(block[:, j]).flatten()
                        for j in range(TILE)]
                steps = max(len(r) for r in rows)
                for t in range(steps):
                    on = [j for j in range(TILE) if len(rows[j]) > t]
                    r = torch.stack([rows[j][t] for j in on])
                    on = torch.tensor(on)
                    e = et[d0 + r]  # [n, K]
                    pn = (e * b[on]).sum(dim=1) + eps
                    cv = block[r, on]
                    acc[on] += e * (cv / pn)[:, None]
                    score += (cv * torch.log(pn)).to(torch.float64).sum()
            partials.append(acc)
        total = partials[0]
        for p in partials[1:]:
            total = total + p
        keep = min(TILE, max(0, V - tile * TILE))
        sstats[:, tile * TILE:tile * TILE + keep] = (b * total).T[:, :keep]
    return sstats, score


def _case(D, V, K, v_pad, pad_rows, density, seed, dtype):
    """Counts [D + pad_rows, V + v_pad] (padding rows and columns zero;
    padding rows carry doc 0's expEtheta, as the engine gathers them)."""
    rng = np.random.default_rng(seed)
    counts = rng.poisson(density, size=(D, V)).astype(np.float64)
    counts[:, rng.integers(0, V)] += rng.integers(1, 4, D)  # a hot column
    counts[D // 2] += 1.0  # a row with every column nonzero
    counts = np.pad(counts, ((0, pad_rows), (0, v_pad)))
    gamma = rng.gamma(100.0, 0.01, size=(D, K))
    lam = rng.gamma(1.0, 1.0, size=(K, V))
    et = exp_dirichlet_expectation(torch.tensor(gamma, dtype=dtype))
    et = torch.cat([et, et[:1].repeat(pad_rows, 1)])
    eeb = exp_dirichlet_expectation(torch.tensor(lam, dtype=dtype))
    return torch.tensor(counts, dtype=dtype), et, eeb


# (D, V, K, v_pad, pad_rows, density, sms): tiles, splits and chunks off
# every size; a few SMs so that small shapes still split their rows.
_CASES = [
    (70, 150, 7, 42, 5, 0.05, 4),
    (130, 200, 20, 0, 0, 0.012, 8),
    (97, 64, 100, 64, 31, 0.03, 2),
    (40, 90, 3, 6, 0, 1.0, 3),  # every count nonzero
]
# The cluster kernel's range (K > 256), (D, V, K, v_pad, pad_rows,
# density): the shapes the one-pass wide builds were held at, and K = 4096.
_WIDE_CASES = [
    (45, 70, 257, 6, 3, 0.04),
    (70, 90, 300, 0, 5, 0.03),
    (40, 50, 1000, 14, 0, 0.05),
    (33, 40, 1025, 0, 2, 0.05),
    (20, 36, 4096, 4, 1, 0.1),
]


@pytest.mark.parametrize("per_split", [1, 26])
@pytest.mark.parametrize("D,V,K,v_pad,pad_rows,density,sms", _CASES)
def test_schedule_matches_plain_f64(D, V, K, v_pad, pad_rows, density, sms,
                                    per_split, monkeypatch):
    counts, et, eeb = _case(D, V, K, v_pad, pad_rows, density, seed=D + V,
                            dtype=torch.float64)
    monkeypatch.setattr(sstats_mod, "CHUNKS_PER_SPLIT", per_split)
    pl = sstats_mod.plan(D + pad_rows, V + v_pad, K, sms)
    ss, tok = kernel_schedule(counts, et, eeb, 1e-30, pl)
    ss_p, tok_p = estep_dense_sstats(counts, et, eeb, 1e-30)
    torch.testing.assert_close(ss, ss_p, rtol=1e-12, atol=1e-300)
    assert float(tok) == pytest.approx(float(tok_p), rel=1e-12)


@pytest.mark.parametrize("D,V,K,v_pad,pad_rows,density,sms", _CASES[:3])
def test_schedule_f32_matches_jax(D, V, K, v_pad, pad_rows, density, sms):
    counts, et, eeb = _case(D, V, K, v_pad, pad_rows, density, seed=D + K,
                            dtype=torch.float32)
    pl = sstats_mod.plan(D + pad_rows, V + v_pad, K, sms)
    ss, tok = kernel_schedule(counts, et, eeb, 1e-30, pl)
    ss_j, tok_j = jax_dense_sstats(jnp.asarray(counts.numpy()),
                                   jnp.asarray(et.numpy()),
                                   jnp.asarray(eeb.numpy()))
    np.testing.assert_allclose(ss.numpy(), np.asarray(ss_j), rtol=2e-5,
                               atol=1e-6)
    assert float(tok) == pytest.approx(float(tok_j), rel=2e-5)


# The shapes above and each side of the plan's steps from one cluster
# size to the next (K = 512 / 513, 2048 / 2049), so that clusters of 1, 2,
# 4 and 8 CTAs all run at the plan's own cluster.
_CLUSTER_CASES = _WIDE_CASES + [
    (50, 64, 512, 2, 4, 0.04),
    (36, 70, 513, 5, 1, 0.05),
    (30, 33, 2048, 3, 0, 0.06),
    (24, 40, 2049, 0, 3, 0.08),
]


@pytest.mark.parametrize("D,V,K,v_pad,pad_rows,density", _CLUSTER_CASES,
                         ids=[f"K{c[2]}" for c in _CLUSTER_CASES])
def test_cluster_order_matches_plain_f64(D, V, K, v_pad, pad_rows, density):
    """The cluster kernel's order at the plan's cluster against the plain
    version in float64: sstats to 1e-12, the score rel 1e-12."""
    counts, et, eeb = _case(D, V, K, v_pad, pad_rows, density, seed=D + V,
                            dtype=torch.float64)
    pl = sstats_mod.plan(D + pad_rows, V + v_pad, K, H100_SMS)
    assert pl.wide and pl.cluster == sstats_mod.wide_cluster(K)
    assert not pl.direct
    assert pl.cols == sstats_mod.WIDE_COLS and pl.kp >= K
    ss, tok = cluster_sstats(counts, et, eeb, 1e-30, 0, K, "float32", pl)
    ss_p, tok_p = estep_dense_sstats(counts, et, eeb, 1e-30)
    torch.testing.assert_close(ss, ss_p, rtol=1e-12, atol=1e-300)
    assert float(tok) == pytest.approx(float(tok_p), rel=1e-12)


@pytest.mark.parametrize("D,V,K,v_pad,pad_rows,density", _WIDE_CASES)
def test_cluster_order_f32_matches_jax(D, V, K, v_pad, pad_rows, density):
    """The cluster kernel's order at the plan's cluster in float32 against
    JAX's ``estep_dense_sstats`` (rtol 2e-5), and a topic range across
    slice boundaries bitwise the full call's rows."""
    counts, et, eeb = _case(D, V, K, v_pad, pad_rows, density, seed=D + K,
                            dtype=torch.float32)
    pl = sstats_mod.plan(D + pad_rows, V + v_pad, K, H100_SMS)
    assert pl.wide and pl.cluster == sstats_mod.wide_cluster(K)
    ss, tok = cluster_sstats(counts, et, eeb, 1e-30, 0, K, "float32", pl)
    ss_j, tok_j = jax_dense_sstats(jnp.asarray(counts.numpy()),
                                   jnp.asarray(et.numpy()),
                                   jnp.asarray(eeb.numpy()))
    np.testing.assert_allclose(ss.numpy(), np.asarray(ss_j), rtol=2e-5,
                               atol=1e-6)
    assert float(tok) == pytest.approx(float(tok_j), rel=2e-5)
    k0, k1 = 3, K - 5
    part, _ = cluster_sstats(counts, et, eeb, 1e-30, k0, k1, "float32", pl)
    assert torch.equal(part, ss[k0:k1])


def test_schedule_all_zero_counts():
    """No nonzero: no work, sstats and score exactly zero."""
    counts, et, eeb = _case(40, 100, 5, 28, 8, 0.0, seed=3,
                            dtype=torch.float64)
    counts.zero_()
    ss, tok = kernel_schedule(counts, et, eeb, 1e-30,
                              sstats_mod.plan(48, 128, 5, 4))
    assert bool((ss == 0).all()) and float(tok) == 0.0


@pytest.mark.parametrize(
    "D,Vc,label", [(4096, 10240, "ragged chunk"), (4096, 4096, "dense batch")]
)
def test_plan_fills_an_h100_at_the_flagships(D, Vc, label):
    pl = sstats_mod.plan(D, Vc, 100, H100_SMS)
    assert pl.blocks >= 2 * H100_SMS, label
    assert pl.tiles * pl.cols >= Vc and (pl.tiles - 1) * pl.cols < Vc
    assert pl.kp == 112 and pl.cols == 64


@pytest.mark.parametrize("D", [1, 31, 33, 500, 4096])
def test_plan_covers_rows_and_scratch(D, monkeypatch):
    for K, Vc, per_split in itertools.product(
            [1, 7, 16, 17, 100, 113, 256, 257, 300, 1000, 1024, 1025, 4096],
            [1, 64, 65, 4096], [1, 4, 26, 1000]):
        monkeypatch.setattr(sstats_mod, "CHUNKS_PER_SPLIT", per_split)
        pl = sstats_mod.plan(D, Vc, K, H100_SMS)
        if K > sstats_mod.ONE_PASS_MAX_TOPICS:
            # The cluster kernel: one split of whole 128-row chunks, its
            # slices of at most 512 topics, a score part a tile and one
            # counter.
            assert pl.wide and pl.splits == 1
            assert pl.cluster == sstats_mod.wide_cluster(K)
            assert pl.slice <= sstats_mod.WIDE_SLICE
            assert pl.cols == sstats_mod.WIDE_COLS and pl.kp >= K
            assert pl.tiles * pl.cols >= Vc > (pl.tiles - 1) * pl.cols
            assert pl.rows_per_split >= D
            assert pl.rows_per_split % sstats_mod.WIDE_COUNT_ROWS == 0
            assert pl.smem_bytes <= sstats_mod.SMEM_LIMIT
            assert pl.smem_bytes == sstats_mod.wide_smem_bytes(
                pl.slice, pl.batch, pl.cluster, 2, pl.cols)
            assert pl.partial_floats == 0
            assert pl.scratch_bytes == 8 * pl.tiles + 4
            continue
        n4, lanes = sstats_mod.build_for(K)
        assert (n4, lanes) in sstats_mod.BUILDS
        assert pl.kp == 4 * n4 * lanes >= K
        assert pl.cols * lanes == sstats_mod.THREADS
        # The smallest build that takes K.
        assert all(4 * n * ln < K for n, ln in sstats_mod.BUILDS
                   if 4 * n * ln < pl.kp)
        assert pl.rows_per_split <= per_split * sstats_mod.CHUNK_ROWS
        assert pl.rows_per_split % sstats_mod.CHUNK_ROWS == 0
        # Every row in one split, no split empty.
        assert pl.splits * pl.rows_per_split >= D
        assert (pl.splits - 1) * pl.rows_per_split < max(D, 1)
        # Scratch: one [cols, kp] partial a CTA when the rows are split.
        if pl.splits > 1:
            assert pl.partial_floats == pl.blocks * pl.cols * pl.kp
        else:
            assert pl.partial_floats == 0
        assert pl.blocks == pl.tiles * pl.splits
        assert pl.scratch_bytes == (8 * pl.blocks + 4 * pl.partial_floats
                                    + 4 * (pl.tiles + 1))


def test_plan_topic_padding_matches_the_kernel_builds():
    """The tile width and the scratch a split partial needs follow the
    kernel's builds (``PYLDA_BUILD(n4, lanes)`` in ``csrc/dense_sstats.cu``,
    tried in order): one for each (n4, lanes)."""
    src = (_build.CSRC / "dense_sstats.cu").read_text()
    builds = tuple((int(n), int(lanes)) for n, lanes in re.findall(
        r"PYLDA_BUILD\((\d+), (\d+)\)\n", src))
    assert builds == sstats_mod.BUILDS
    kps = [4 * n * lanes for n, lanes in builds]
    assert kps == sorted(kps) and kps[-1] == sstats_mod.ONE_PASS_MAX_TOPICS


def test_plan_refuses_what_the_kernel_does_not_take():
    """The kernels' ranges: every K in 1..256 has a one-pass build (64
    columns a tile); above it the cluster kernel plans: clusters of the
    smallest power of two whose slices (whole 32-row boxes) hold at most
    512 topics, 32 columns a tile, up to K = 4096 (8 CTAs); above it
    clusters of 16, 32 columns a tile up to slices of 512 topics, 16 up
    to 1024, then the direct plan.  Only K = 0 raises."""
    for K in (1, 7, 17, 100, 113, 200, 256):
        pl = sstats_mod.plan(10, 10, K, H100_SMS)
        assert pl.cols == 64 and pl.kp >= K and not pl.wide, K
    for K, cluster, slice_, cols, direct in (
            (257, 1, 288, 32, False), (300, 1, 320, 32, False),
            (512, 1, 512, 32, False), (513, 2, 288, 32, False),
            (1000, 2, 512, 32, False), (1024, 2, 512, 32, False),
            (1025, 4, 288, 32, False), (2048, 4, 512, 32, False),
            (2049, 8, 288, 32, False), (4096, 8, 512, 32, False),
            (4097, 16, 288, 32, False), (16384, 16, 1024, 16, False),
            (16385, 16, 1028, 32, True)):
        pl = sstats_mod.plan(10, 10, K, H100_SMS)
        assert pl.wide and pl.kp == cluster * slice_ >= K, K
        assert (pl.cluster, pl.slice, pl.cols, pl.direct) == (
            cluster, slice_, cols, direct), K
        assert sstats_mod.wide_cluster(K) == cluster
    with pytest.raises(ValueError):
        sstats_mod.build_for(257)
    with pytest.raises(ValueError):
        sstats_mod.plan(10, 10, 0, H100_SMS)


# The tensor-core kernel's range (bf16, K <= 256), (D, V, K, v_pad,
# pad_rows, density): K off and on multiples of 16, rows off the 64-row
# chunk, columns off the 64-column tile.
_MMA_CASES = [
    (150, 200, 1, 12, 3, 0.05),
    (130, 90, 7, 6, 5, 0.08),
    (200, 150, 100, 24, 0, 0.03),
    (70, 130, 200, 0, 9, 0.05),
    (100, 64, 256, 5, 2, 0.1),
]


def _mma_plan(D, Vc, K, splits):
    """The tensor-core kernel's plan with ``splits`` row splits of whole
    64-row chunks (so that the splits' meeting order is exercised)."""
    pl = sstats_mod.plan(D, Vc, K, H100_SMS, compute_dtype="bfloat16")
    chunks = -(-D // sstats_mod.MMA_ROWS)
    per = -(-chunks // splits)
    return dataclasses.replace(pl, splits=-(-chunks // per),
                               rows_per_split=per * sstats_mod.MMA_ROWS)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,V,K,v_pad,pad_rows,density", _MMA_CASES,
                         ids=[f"K{c[2]}" for c in _MMA_CASES])
def test_mma_order_matches_plain_f64(D, V, K, v_pad, pad_rows, density,
                                     compute_dtype):
    """The tensor-core kernel's order in float64 against the plain version
    in float64 with the same operand mode: sstats to 1e-12, the score
    rel 1e-12."""
    counts, et, eeb = _case(D, V, K, v_pad, pad_rows, density, seed=D + V,
                            dtype=torch.float64)
    pl = _mma_plan(D + pad_rows, V + v_pad, K, 3)
    assert pl.mma and pl.kp == -(-K // 16) * 16 and pl.splits > 1
    ss, tok = mma_sstats(counts, et, eeb, 1e-30, 0, K, compute_dtype, pl)
    ss_p, tok_p = estep_dense_sstats(counts, et, eeb, 1e-30,
                                     compute_dtype=compute_dtype)
    torch.testing.assert_close(ss, ss_p, rtol=1e-12, atol=1e-300)
    assert float(tok) == pytest.approx(float(tok_p), rel=1e-12)


@pytest.mark.parametrize("D,V,K,v_pad,pad_rows,density", _MMA_CASES,
                         ids=[f"K{c[2]}" for c in _MMA_CASES])
def test_mma_order_f32_matches_jax_bf16(D, V, K, v_pad, pad_rows, density):
    """The tensor-core kernel's order in float32 with bf16 operands
    against JAX's ``estep_dense_sstats(compute_dtype="bfloat16")`` and the
    Pallas kernel in its bf16 mode (interpret mode): each a bf16 function
    whose float32 sums run in another order, so a ratio may round one
    bf16 ulp apart (the card's hold, ``_hold_bf16_sstats``): at most 1e-3
    of the entries past 1e-4 rel + 1e-6 max|ref|, every entry within 2^-7
    rel of it; the score rel 1e-5.  A topic range off the 16-topic tiles
    is bitwise the full model's rows."""
    counts, et, eeb = _case(D, V, K, v_pad, pad_rows, density, seed=D + K,
                            dtype=torch.float32)
    pl = _mma_plan(D + pad_rows, V + v_pad, K, 2)
    ss, tok = mma_sstats(counts, et, eeb, 1e-30, 0, K, "bfloat16", pl)
    args = [jnp.asarray(x.numpy()) for x in (counts, et, eeb)]
    for ss_r, tok_r in (
            jax_dense_sstats(*args, compute_dtype="bfloat16"),
            pallas_dense_sstats(*args, compute_dtype="bfloat16",
                                interpret=True)):
        ref = torch.tensor(np.asarray(ss_r))[:, :V]
        diff, atol = (ss - ref).abs(), 1e-6 * float(ref.abs().max())
        off = diff > 1e-4 * ref.abs() + atol
        assert float(off.float().mean()) <= 1e-3, int(off.sum())
        assert bool((diff <= 2.0 ** -7 * ref.abs() + atol).all())
        assert float(tok) == pytest.approx(float(tok_r), rel=1e-5)
    k0, k1 = (3, K - 5) if K >= 10 else (0, 1)
    part, tok_part = mma_sstats(counts, et, eeb, 1e-30, k0, k1, "bfloat16",
                                pl)
    assert torch.equal(part, ss[k0:k1]) and torch.equal(tok_part, tok)


@pytest.mark.parametrize(
    "D,Vc,K,tiles,cols,splits",
    [(4096, 10240, 100, 160, 64, 3), (4096, 4096, 100, 64, 64, 4),
     (1024, 50176, 200, 784, 64, 1), (4096, 10240, 256, 160, 64, 4)])
def test_mma_plan_at_the_flagships(D, Vc, K, tiles, cols, splits):
    """The tensor-core kernel's grid on 132 SMs: the ragged flagship's
    chunk and the dense flagship's batch (two CTAs an SM), the config-4
    block at K = 200 and the chunk at K = 256 (one CTA an SM): 64-column
    tiles, splits of whole 64-row chunks covering every row, and scratch
    for the rounded expEtheta and the splits' partials."""
    pl = sstats_mod.plan(D, Vc, K, H100_SMS, compute_dtype="bfloat16")
    assert pl.mma and not pl.wide
    assert (pl.tiles, pl.splits, pl.cols) == (tiles, splits, cols)
    assert pl.rows_per_split % sstats_mod.MMA_ROWS == 0
    assert pl.splits * pl.rows_per_split >= D
    assert (pl.splits - 1) * pl.rows_per_split < D
    assert pl.smem_bytes == sstats_mod.mma_smem_bytes(K)
    assert pl.smem_bytes <= sstats_mod.SMEM_LIMIT
    parts = 0 if splits == 1 else (pl.blocks * 8 * sstats_mod.THREADS
                                   * pl.mma_tiles)
    assert pl.partial_floats == D * pl.kp // 2 + parts
    assert pl.scratch_bytes == (8 * pl.blocks + 4 * pl.partial_floats
                                + 4 * (pl.tiles + 1))


def test_mma_plan_takes_the_bf16_build_at_k_256_and_below():
    """Every bf16 plan at K <= 256 is the tensor-core kernel's, for both
    count types and any topic range; the float32 plans and every plan
    above 256 are the others' and unchanged by the mode."""
    for K in (1, 7, 16, 17, 100, 128, 200, 255, 256):
        for count_bytes in (2, 4):
            pl = sstats_mod.plan(300, 500, K, H100_SMS, (0, 1), count_bytes,
                                 "bfloat16")
            assert pl.mma and pl.kp == -(-K // 16) * 16, K
            assert pl.cols == sstats_mod.MMA_TILE_V
            assert pl.smem_bytes <= sstats_mod.SMEM_LIMIT
            assert pl.mma_tiles == min(8, 1 << max(
                0, (-(-pl.kp // 32) - 1).bit_length()))
            f32 = sstats_mod.plan(300, 500, K, H100_SMS, None, count_bytes)
            assert not f32.mma and f32.cols == sstats_mod.TILE_V
    for K in (257, 1000, 8192):
        assert (sstats_mod.plan(300, 500, K, H100_SMS,
                                compute_dtype="bfloat16")
                == sstats_mod.plan(300, 500, K, H100_SMS))
