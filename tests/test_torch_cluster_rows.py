"""The plan of the gamma kernels at K <= 4096, and the plain gamma fixed
points at SVI config 5's row width, on the CPU.

A gamma launch at K <= 4096 takes one of four routes
(``ops/row_fixed_point.py::gamma_plan``), chosen on the host from the
launch's widest row (a ragged bucket's width, a dense batch's largest row
nnz):

- "groups": in the bf16 mode at K <= 256 only, every row fits a warp
  group's slots (the warp-group kernel of
  ``csrc/row_fixed_point_groups.cuh``; ``group_capacity`` and
  ``group_smem_bytes`` mirror its ``GroupLayout`` and launcher);
- "rows": every row fits one block's slot buffer (the row-resident
  kernels of ``csrc/row_fixed_point.cuh``; ``slot_buffer`` mirrors the
  launcher's sizing);
- "entries": the entry kernel of ``csrc/row_fixed_point_entries.cuh``,
  a cluster of C CTAs a row, each holding ceil(widest / C) of the row's
  entries in at most ``CLUSTER_SMEM_BUDGET`` bytes of shared memory
  (``entry_smem_bytes`` mirrors its ``EntryLayout``), C the smallest power
  of two that fits, at most 16;
- "stream": past 16 CTAs, or where the gather table fits half the L2,
  the row-resident kernels with the long rows streamed.

The plans of the shapes the main paths give the kernels are worked out by
hand below; the dense batches carry their largest row nnz from the host;
and the plain versions that the card's kernels are held to agree with the
JAX package's functions at config 5's row width (K = 1000, rows of 208
live entries), at pinned sweeps, rtol 1e-4 (atol 1e-5) as
``tests/test_torch_ops.py`` holds them at K = 300.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylda_tpu.ops import dirichlet as jd
from pylda_tpu.ops.estep import estep_dense as jax_dense
from pylda_tpu.ops.estep import estep_ragged_gamma as jax_ragged_gamma
from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.models import StochasticVariationalBayes, VariationalBayes
from pylda_tpu_torch.models.vb import _Dense
from pylda_tpu_torch.ops import _build
from pylda_tpu_torch.ops import row_fixed_point as rfp
from pylda_tpu_torch.ops.estep import estep_dense, estep_ragged_gamma
from pylda_tpu_torch.utils.config import LDAConfig


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _header(name: str) -> str:
    return (_build.CSRC / name).read_text()


# (K, widest, mode, inner sweeps) -> (route, C, entries a CTA, slice).
_PLANS = [
    # bf16 at K <= 256: the warp-group kernel up to a group's capacity
    # (192 entries at K <= 128, 112 at 200, 96 at 256), the bf16
    # row-resident kernels one entry past it, and never above K = 256.
    *[((100, w, "bfloat16", 50), ("groups", 0, 0, 0)) for w in (112, 128,
                                                               144, 160)],
    ((1, 1, "bfloat16", 50), ("groups", 0, 0, 0)),
    ((16, 192, "bfloat16", 50), ("groups", 0, 0, 0)),
    ((128, 192, "bfloat16", 50), ("groups", 0, 0, 0)),
    ((128, 193, "bfloat16", 50), ("rows", 0, 0, 0)),
    ((200, 112, "bfloat16", 30), ("groups", 0, 0, 0)),
    ((200, 113, "bfloat16", 30), ("rows", 0, 0, 0)),
    ((256, 96, "bfloat16", 50), ("groups", 0, 0, 0)),
    ((256, 97, "bfloat16", 50), ("rows", 0, 0, 0)),
    ((257, 16, "bfloat16", 50), ("rows", 0, 0, 0)),
    # The ragged flagship's buckets at K = 100: 167 entries a block.
    *[((100, w, "float32", 50), ("rows", 0, 0, 0)) for w in (112, 128, 144,
                                                            160)],
    # SVI config 4 (K = 200, widths 160 and 208): 82 entries a block, so
    # one CTA of 160 or 208 (the slot 816 B); bf16 holds 164 in a block.
    ((200, 160, "float32", 50), ("entries", 1, 160, 200)),
    ((200, 208, "float32", 50), ("entries", 1, 208, 200)),
    ((200, 160, "bfloat16", 50), ("rows", 0, 0, 0)),
    ((200, 208, "bfloat16", 50), ("entries", 1, 208, 200)),
    # SVI config 5 (K = 1000, widths 160, 176, 208): 25 entries a block
    # (bf16 49); 4016 B a slot (bf16 2000 B).
    ((1000, 160, "float32", 30), ("entries", 4, 40, 252)),
    ((1000, 176, "float32", 30), ("entries", 4, 44, 252)),
    ((1000, 208, "float32", 30), ("entries", 8, 26, 128)),
    ((1000, 160, "bfloat16", 30), ("entries", 2, 80, 500)),
    ((1000, 176, "bfloat16", 30), ("entries", 2, 88, 500)),
    ((1000, 208, "bfloat16", 30), ("entries", 4, 52, 252)),
    # The edges of the wide kernels, and K = 2048.
    ((257, 300, "float32", 50), ("entries", 2, 150, 132)),
    ((2048, 200, "float32", 50), ("entries", 16, 13, 128)),
    # K = 4096: 8 entries a CTA (16400 B a slot), 128 a cluster of 16.
    ((4096, 100, "float32", 50), ("entries", 16, 7, 256)),
    ((4096, 128, "float32", 30), ("entries", 16, 8, 256)),
    ((4096, 129, "float32", 30), ("stream", 0, 0, 0)),
    ((4096, 200, "float32", 50), ("stream", 0, 0, 0)),
]


@pytest.mark.parametrize("args,want", _PLANS,
                         ids=[f"K{a[0]}-w{a[1]}-{a[2]}" for a, _ in _PLANS])
def test_gamma_plan_routes(args, want):
    plan = rfp.gamma_plan(*args)
    assert (plan.route, plan.cluster, plan.share, plan.slice) == want
    K, widest, mode, inner = args
    assert plan.nmax == rfp.slot_buffer(K, mode, inner)
    if plan.route == "groups":
        assert mode == "bfloat16" and K <= rfp.GROUP_MAX_TOPICS
        assert plan.slots == -(-widest // 16) * 16 <= rfp.group_capacity(K)
        assert plan.smem_bytes == rfp.group_smem_bytes(K, plan.slots)
        return
    assert mode == "float32" or widest > rfp.group_capacity(K)
    if plan.route == "rows":
        assert widest <= plan.nmax
        return
    assert widest > plan.nmax
    if plan.route == "stream":
        return
    C = plan.cluster
    nhist = min(inner, rfp.MAX_HIST)
    bf16 = mode == "bfloat16"
    # The CTAs hold the row, a power of two of them; half as many could
    # not, at their own share.
    assert C * plan.share >= widest and plan.slice * C >= K
    assert C & (C - 1) == 0
    assert plan.smem_bytes == rfp.entry_smem_bytes(K, plan.share, plan.slice,
                                                   C, nhist, bf16)
    assert plan.smem_bytes <= rfp.CLUSTER_SMEM_BUDGET
    if C > 1:
        k4, half = -(-K // 4), C // 2
        fewer = rfp.entry_smem_bytes(K, -(-widest // half),
                                     4 * -(-k4 // half), half, nhist, bf16)
        assert fewer > rfp.CLUSTER_SMEM_BUDGET


def test_config5_widest_bucket_by_hand():
    """K = 1000, float32, 30 sweeps, a bucket of width 208.  One block's
    buffer: the wide Layout at nmax = 0 holds et and gam (1004 floats
    each: 251 float4), step B's one group (1000), the histogram (32),
    scan, block sums and flags (8 + 16 + 4): 3068 floats; a slot is 1004
    floats and 3 more a slot (ratio, count, id), so (116,736 - 1024 -
    4 (3068 + 12)) / (4 (1004 + 3)) = 25 entries.  Four CTAs of 52
    entries: 52 x 1004 + 3068 + 3 x 52 floats of the Layout, the four
    ranks' partials of a 252-topic slice (1008), the pairs (8), step A's
    chunk sums (8 x 128) and the row slots and mbarriers (16): 57,488
    floats, 229,952 B, past the 200 KB budget; so eight CTAs of 26 (a
    cluster takes a power of two): 26 x 1004 + 3068 + 3 x 28, 8 x 128,
    16, 1024 and 16 floats, 125,344 B (five of 42 would take 189,680 B)."""
    assert rfp.slot_buffer(1000, "float32", 30) == 25
    assert rfp.entry_smem_bytes(1000, 52, 252, 4, 30, False) == 229952
    assert rfp.entry_smem_bytes(1000, 26, 128, 8, 30, False) == 125344
    assert rfp.entry_smem_bytes(1000, 42, 200, 5, 30, False) == 189680
    assert rfp.gamma_plan(1000, 208, "float32", 30).cluster == 8
    assert rfp.CLUSTER_SMEM_BUDGET == 200 * 1024


@pytest.mark.parametrize("K,V,widest,mode,want", [
    (1000, 4096, 160, "float32", "stream"),  # the dense line: 16.4 MB
    (200, 50_000, 208, "float32", "entries"),  # config 4: 40 MB
    (200, 50_000, 208, "bfloat16", "stream"),  # 20 MB in bf16
    (1000, 100_000, 208, "bfloat16", "entries"),  # config 5: 200 MB
    (100, 10_000, 160, "float32", "rows"),  # the flagship: fits a block
])
def test_gamma_plan_streams_rows_whose_table_fits_the_l2(K, V, widest, mode,
                                                         want):
    """A launch past one block's buffer whose gather table fits half the
    L2 (50 MB on an H100) keeps the row-resident kernels, whose streamed
    windows re-gather from the L2; a larger table takes the entry
    kernel."""
    ldb = rfp.table_width(K, mode)
    table = V * ldb * (2 if mode == "bfloat16" else 4)
    plan = rfp.gamma_plan(K, widest, mode, 30, table_bytes=table)
    assert plan.route == want
    assert rfp.H100_L2_BYTES == 50 * 2**20


def test_gamma_plan_takes_a_given_width_and_refuses_wide_k():
    plan = rfp.gamma_plan(1000, 208, "float32", 30, cluster=8)
    assert (plan.route, plan.cluster, plan.share, plan.slice) == (
        "entries", 8, 26, 128)
    # A forced width takes the entry kernel even where a block holds the
    # row (the row-resident kernels' own case is the plan's default).
    assert rfp.gamma_plan(100, 100, cluster=2).route == "entries"
    with pytest.raises(ValueError):
        rfp.gamma_plan(1000, 208, cluster=rfp.MAX_CLUSTER + 1)
    with pytest.raises(ValueError):
        rfp.gamma_plan(4097, 10)


def test_slot_buffer_mirrors_the_launcher():
    """The host's copy of the launcher's slot-buffer sizing
    (``launch_row_fixed_point``) and of the entry kernel's layout read the
    constants the header compiles with, and give the buffers the records
    cite (25 entries at K = 1000, 49 in bf16, 4 at K = 4096, 82 at
    K = 200)."""
    core = _header("row_fixed_point.cuh")
    consts = {name: eval(expr) for name, expr in re.findall(
        r"constexpr int (k\w+) = ([\d *]+);", core)}
    assert consts["kBlockSmemTarget"] == rfp.BLOCK_SMEM_TARGET
    assert consts["kBlockSmemReserved"] == rfp.BLOCK_SMEM_RESERVED
    assert consts["kThreads"] == rfp.THREADS
    assert consts["kMaxHist"] == rfp.MAX_HIST
    assert consts["kMaxTopics"] == rfp.RESIDENT_TOPICS
    for line in (
            "const int per_slot = (int)sizeof(float) * (fixed.slot + 3);",
            "const int fixed_bytes = (int)sizeof(float) * (fixed.total + 12);",
            "nmax = (kBlockSmemTarget - fixed_bytes) / per_slot;",
            "if (nmax < 16) nmax = 16;",
            "nmax = (sm_bytes / 2 - kBlockSmemReserved - fixed_bytes) / "
            "per_slot;",
            "if (nmax < 1) nmax = (optin - fixed_bytes) / per_slot;"):
        assert line in core, line
    entries = _header("row_fixed_point_entries.cuh")
    for line in ("recv = base.total;", "pairs = recv + C * slice;",
                 "dots = pairs + ((2 * C + 3) & ~3);",
                 "slots = dots + kWarps * kDotSlots;",
                 "bars = slots + 8;", "total = bars + 8;"):
        assert line in entries, line
    assert re.findall(r"constexpr int kDotSlots = (\d+);", entries) == [
        str(rfp.DOT_SLOTS)]
    assert [rfp.slot_buffer(K, cd) for K, cd in (
        (1000, "float32"), (1000, "bfloat16"), (4096, "float32"),
        (200, "float32"))] == [25, 49, 4, 82]
    # One slot of the wide Layout is K rounded to an odd float4 count.
    assert rfp.layout_floats(1000, 1, 50, True, False)[0] == 1004
    assert rfp.layout_floats(1000, 1, 50, True, True)[0] == 500


def test_group_layout_mirrors_the_launcher():
    """The host's copy of the warp-group kernel's ``GroupLayout`` and of
    its launcher's shared memory read the constants the header compiles
    with; the capacity of a group is the most entries (a multiple of 16,
    at most GROUP_MAX_SLOTS) whose CTA of GROUPS groups takes half an
    H100 SM's shared memory less the 1 KB the card keeps a block; and the
    CTA sizes are those the launcher reported on an H100 for the ragged
    flagship's buckets (59,712 to 83,520 B at widths 112 to 160, K =
    100).  Float32 never takes the route."""
    src = _header("row_fixed_point_groups.cuh")
    consts = dict(re.findall(r"constexpr int (kGroup\w+) = (\d+);", src))
    assert {k: int(v) for k, v in consts.items()} == {
        "kGroupWarps": rfp.GROUP_WARPS, "kGroups": rfp.GROUPS,
        "kGroupMaxTopics": rfp.GROUP_MAX_TOPICS,
        "kGroupMaxSlots": rfp.GROUP_MAX_SLOTS}
    for line in ("kt = (K + 15) / 16;", "row16 = 2 * kt + 1;",
                 "etr = b + slots * row16 * 16;", "part = etr + kt * 32;",
                 "cnt = part + kGroupWarps * kt * 64;",
                 "ids = cnt + slots * 4;", "scan = ids + slots * 4;",
                 "red = scan + kGroupWarps * 4;",
                 "flags = red + kGroupWarps * 8;", "total = flags + 16;",
                 "const size_t smem = (size_t)kGroups * "
                 "GroupLayout(p.K, slots).total;",
                 "slots % 16 != 0"):
        assert line in src, line
    assert [rfp.group_smem_bytes(100, w) for w in (112, 128, 144, 160)] == [
        59712, 67648, 75584, 83520]
    assert {K: rfp.group_capacity(K) for K in (1, 100, 128, 200, 256, 257)} \
        == {1: 192, 100: 192, 128: 192, 200: 112, 256: 96, 257: 0}
    budget = rfp.H100_SMEM_PER_SM // 2 - rfp.BLOCK_SMEM_RESERVED
    for K in (1, 7, 16, 100, 128, 200, 256):
        cap = rfp.group_capacity(K)
        assert cap % 16 == 0 and rfp.group_smem_bytes(K, cap) <= budget
        assert (cap == rfp.GROUP_MAX_SLOTS
                or rfp.group_smem_bytes(K, cap + 16) > budget)
        assert rfp.gamma_plan(K, cap, "float32").route != "groups"


def test_dense_batches_carry_their_largest_row():
    """The dense batches' largest row nnz, counted on the host when the
    batch is built, against their counts: batch VB's batches and SVI's
    device-resident rows (each minibatch's batch carries the corpus's)."""
    corpus, _, _ = synthetic_corpus(num_docs=96, num_topics=6, num_types=400,
                                    mean_doc_length=60.0, seed=5)
    vb = VariationalBayes(LDAConfig(number_of_topics=6, seed=0,
                                    doc_pad_multiple=8), device="cpu")
    vb.initialize(corpus)
    dense = [b for b in vb._batches if isinstance(b, _Dense)]
    assert dense
    for b in dense:
        assert b.max_nnz == int((b.counts != 0).sum(dim=1).max())
    svi = StochasticVariationalBayes(
        LDAConfig(number_of_topics=6, inference_mode="svi", batch_size=32,
                  seed=0, doc_pad_multiple=8), device="cpu")
    svi.initialize(corpus)
    (rows,) = svi._device_rows
    assert rows.max_nnz == int((rows.counts != 0).sum(dim=1).max()) > 0
    batches, _ = next(svi._epoch(0, 0).minibatches)
    for b in batches:
        assert b.max_nnz == rows.max_nnz
        assert int((b.counts != 0).sum(dim=1).max()) <= b.max_nnz


def _config5_rows(seed=18):
    """Six rows of width 208 at K = 1000 over V = 2000 (up to 208 distinct
    live entries a row, some rows shorter), a sharpened lambda, and gamma
    inits drawn with numpy."""
    rng = np.random.default_rng(seed)
    D, T, K, V = 6, 208, 1000, 2000
    ids = np.zeros((D, T), np.int32)
    cnts = np.zeros((D, T), np.float32)
    for d, n in enumerate((208, 190, 150, 208, 60, 120)):
        ids[d, :n] = rng.choice(V, n, replace=False)
        cnts[d, :n] = rng.integers(1, 4, n)
    lam = (rng.gamma(0.1, 1.0, (K, V)) * 50.0 + 0.01).astype(np.float32)
    eeb = np.array(jd.exp_dirichlet_expectation(jnp.asarray(lam)))
    alpha = np.full(K, 1.0 / K, np.float32)
    g0 = rng.gamma(100.0, 0.01, (D, K)).astype(np.float32)
    return ids, cnts, g0, eeb, alpha, V


@pytest.mark.parametrize("inner", [1, 3])
def test_plain_ragged_gamma_config5_rows_match_jax(inner):
    """The plain ragged fixed point with two segments of three rows (each
    the JAX function's own call) at pinned sweeps: rtol 1e-4, atol 1e-5."""
    ids, cnts, g0, eeb, alpha, _ = _config5_rows()
    kw = dict(inner_iterations=inner, convergence_threshold=0.0)
    g, s = estep_ragged_gamma(torch.from_numpy(ids), torch.from_numpy(cnts),
                              torch.from_numpy(g0), torch.from_numpy(eeb),
                              torch.from_numpy(alpha), segments=(3, 3), **kw)
    assert [int(x) for x in s] == [inner, inner]
    for r0 in (0, 3):
        rows = slice(r0, r0 + 3)
        g_j, s_j = jax_ragged_gamma(jnp.asarray(ids[rows]),
                                    jnp.asarray(cnts[rows]),
                                    jnp.asarray(g0[rows]), jnp.asarray(eeb),
                                    jnp.asarray(alpha), **kw)
        assert int(s_j) == inner
        np.testing.assert_allclose(g[rows].numpy(), np.asarray(g_j),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("inner", [1, 3])
def test_plain_dense_estep_config5_rows_match_jax(inner):
    """The same rows as dense counts [6, 2000]: the plain dense E-step
    against the JAX function at pinned sweeps, gamma at rtol 1e-4 (atol
    1e-5)."""
    ids, cnts, g0, eeb, alpha, V = _config5_rows()
    counts = np.zeros((ids.shape[0], V), np.float32)
    for d in range(ids.shape[0]):
        live = cnts[d] != 0
        counts[d, ids[d, live]] = cnts[d, live]
    kw = dict(inner_iterations=inner, convergence_threshold=0.0)
    g, _, _, s = estep_dense(torch.from_numpy(counts), torch.from_numpy(g0),
                             torch.from_numpy(eeb), torch.from_numpy(alpha),
                             **kw)
    g_j, _, _, s_j = jax_dense(jnp.asarray(counts), jnp.asarray(g0),
                               jnp.asarray(eeb), jnp.asarray(alpha), **kw)
    assert int(s) == int(s_j) == inner
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-4,
                               atol=1e-5)
