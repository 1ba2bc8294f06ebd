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
that sweep moves it by at most K * threshold in sum_k |dgamma|.
"""

import numpy as np
import pytest
import torch

from pylda_tpu_torch.ops import ragged as ragged_mod
from pylda_tpu_torch.ops import sstats as sstats_mod
from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation
from pylda_tpu_torch.ops.estep import estep_dense_sstats, estep_ragged_gamma

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


def test_dense_sstats_kernel_refuses_large_k(cuda):
    ct, et, eeb = _sstats_inputs(8, 100, 257, 0, 0, False, cuda)
    with pytest.raises(NotImplementedError):
        sstats_mod.dense_sstats(ct, et, eeb)


def _ragged_inputs(D, T, K, V, dev, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (D, T)).astype(np.int32)
    cnts = rng.integers(1, 5, (D, T)).astype(np.float32)
    fill = rng.integers(1, T + 1, D)  # ragged rows: slots past fill are pads
    pad = np.arange(T)[None, :] >= fill[:, None]
    ids[pad], cnts[pad] = 0, 0.0
    ids[-3:], cnts[-3:] = 0, 0.0  # padded doc rows
    lam = rng.gamma(1.0, 1.0, (K, V))
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
    before = ragged_mod.LAUNCHES
    g, s = ragged_mod.ragged_gamma(ids, cnts, g0, eeb, alpha,
                                   slots_out=slots, **kw)
    assert ragged_mod.LAUNCHES == before + 1
    g_p, s_p = estep_ragged_gamma(ids, cnts, g0, eeb, alpha, **kw)
    torch.cuda.synchronize()
    assert int(s) == int(s_p) == 12
    assert int(slots) == 12 * real  # no freezing at threshold 0
    torch.testing.assert_close(g, g_p, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("D,T,K,V,thresh", [(300, 70, 100, 3000, 1e-5),
                                            (37, 21, 13, 500, 1e-3)])
def test_ragged_kernel_exit_rule_matches_plain(cuda, D, T, K, V, thresh):
    ids, cnts, g0, eeb, alpha, _ = _ragged_inputs(D, T, K, V, cuda, seed=1)
    kw = dict(inner_iterations=50, convergence_threshold=thresh,
              stall_patience=6)
    g, s = ragged_mod.ragged_gamma(ids, cnts, g0, eeb, alpha, **kw)
    g_p, s_p = estep_ragged_gamma(ids, cnts, g0, eeb, alpha, **kw)
    torch.cuda.synchronize()
    assert abs(int(s) - int(s_p)) <= 1
    torch.testing.assert_close(g, g_p, rtol=5e-4, atol=5e-4 + K * thresh)


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
