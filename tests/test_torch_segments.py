"""Segments: a whole-bucket gamma launch that ends each of its chunks at its
own exit sweep, against the chunked runs on the CPU.

On the card the route with dense sufficient statistics takes a ragged
bucket in one gamma launch; ``estep_memory_budget_mb`` cuts the same rows
into the JAX engine's batches (``models/layouts.ragged_chunks``), and
those chunks are the launch's segments, each ending at its own S*
(``csrc/row_fixed_point.cuh``).  The plain version takes the same
``segments`` argument, so the card's layout runs here:

- ``estep_ragged_gamma`` with segments over a bucket equals the separate
  chunk calls bit for bit (gamma and each segment's sweeps, float32 and
  bf16, stall patience 6), and each chunk call agrees with the JAX
  function on that chunk;
- the chunks are the JAX engine's batches, row for row;
- batch VB at the shape where whole buckets without segments diverge
  (``synthetic_corpus(1024, 20, 5000, mean_doc_length=120, seed=0)``,
  K = 20, lambda0 ~ Gamma(100, 0.01) from seed 1, a 1 MB budget): whole
  buckets with segments give the chunked run's lambda and ELBOs bit for
  bit, and whole buckets without segments do not;
- SVI at a smaller shape, the same;
- the roofline prices a whole-bucket launch once (its segments'
  operations at their own sweeps, its bytes once), and the engines build
  each bucket's segment index once, on the engine's device.

The card's layout is taken by patching ``layouts.chunks_ragged_rows`` to
answer as it does for the card; without segments, by patching
``layouts.ragged_chunks`` to keep each block whole.
"""

import numpy as np
import pytest
import torch

from pylda_tpu.corpus.synthetic import synthetic_corpus as jax_synthetic
from pylda_tpu.models import layouts as jax_layouts
from pylda_tpu.ops import dirichlet as jd
from pylda_tpu.ops.estep import estep_ragged_gamma as jax_ragged_gamma
from pylda_tpu.utils.config import LDAConfig as JaxConfig
from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.models import StochasticVariationalBayes, VariationalBayes
from pylda_tpu_torch.models import layouts
from pylda_tpu_torch.ops.estep import estep_ragged_gamma
from pylda_tpu_torch.ops.row_fixed_point import segment_rows
from pylda_tpu_torch.utils import roofline
from pylda_tpu_torch.utils.config import LDAConfig

import jax.numpy as jnp


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bucket(D=48, T=24, K=30, V=400, seed=4):
    """A bucket of rows of 3 to T live slots at a peaked lambda: at
    threshold 3e-3 and patience 6 some rows stall, so the segments' S*
    differ (in bf16 too)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (D, T)).astype(np.int32)
    cnts = rng.integers(1, 5, (D, T)).astype(np.float32)
    pad = np.arange(T)[None, :] >= rng.integers(3, T + 1, D)[:, None]
    ids[pad], cnts[pad] = 0, 0.0
    lam = rng.gamma(0.3, 1.0, (K, V)).astype(np.float32)
    eeb = np.asarray(jd.exp_dirichlet_expectation(jnp.asarray(lam)))
    g0 = rng.gamma(100.0, 0.01, (D, K)).astype(np.float32)
    alpha = np.full(K, 0.1, np.float32)
    return ids, cnts, g0, eeb, alpha


SEGMENTS = (16, 8, 16, 8)
FIXED = dict(inner_iterations=40, convergence_threshold=3e-3, eps=1e-30,
             stall_patience=6)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_segments_equal_chunk_calls(compute_dtype):
    """One call with segments = the chunk calls, bit for bit: gamma and
    each segment's sweeps; the segments' S* differ from one another and
    from the whole bucket's (so the test can tell them apart)."""
    ids, cnts, g0, eeb, alpha = (torch.tensor(x) for x in _bucket())
    kw = dict(FIXED, compute_dtype=compute_dtype)
    got, sweeps = estep_ragged_gamma(ids, cnts, g0, eeb, alpha,
                                     segments=SEGMENTS, **kw)
    assert sweeps.shape == (len(SEGMENTS),) and sweeps.dtype == torch.int32
    r0, want = 0, []
    for i, n in enumerate(SEGMENTS):
        g, s = estep_ragged_gamma(ids[r0:r0 + n], cnts[r0:r0 + n],
                                  g0[r0:r0 + n], eeb, alpha, **kw)
        assert int(s) == int(sweeps[i])
        want.append(g)
        r0 += n
    assert torch.equal(got, torch.cat(want))
    whole_g, whole_s = estep_ragged_gamma(ids, cnts, g0, eeb, alpha, **kw)
    assert len(set(sweeps.tolist())) > 1
    assert int(whole_s) == int(sweeps.max()) and int(sweeps.min()) < int(whole_s)
    assert not torch.equal(whole_g, got)
    with pytest.raises(ValueError):
        estep_ragged_gamma(ids, cnts, g0, eeb, alpha, segments=(16, 16), **kw)


def test_segment_calls_match_jax():
    """Each segment of one call against the JAX function on that chunk
    (float32 at the exit rule: the sweep count within 1, gamma per row
    5e-4 + K * threshold, the repo's bars at the exit rule)."""
    ids, cnts, g0, eeb, alpha = _bucket()
    got, sweeps = estep_ragged_gamma(
        *(torch.tensor(x) for x in (ids, cnts, g0, eeb, alpha)),
        segments=SEGMENTS, **FIXED)
    r0 = 0
    for i, n in enumerate(SEGMENTS):
        sl = slice(r0, r0 + n)
        g, s = jax_ragged_gamma(
            jnp.asarray(ids[sl]), jnp.asarray(cnts[sl]), jnp.asarray(g0[sl]),
            jnp.asarray(eeb), jnp.asarray(alpha), **FIXED)
        assert abs(int(s) - int(sweeps[i])) <= 1
        np.testing.assert_allclose(got[sl].numpy(), np.asarray(g), rtol=5e-4,
                                   atol=5e-4 + eeb.shape[0] * 3e-3)
        r0 += n


# Queue 3's shape, cut to a few calls at threshold 1e-3.
QUEUE3 = dict(number_of_topics=20, estep_memory_budget_mb=1,
              convergence_threshold=1e-3, seed=0)
CALLS = 6


@pytest.fixture(scope="module")
def queue3():
    kw = dict(num_docs=1024, num_topics=20, num_types=5000,
              mean_doc_length=120.0, seed=0)
    return dict(corpus=synthetic_corpus(**kw)[0], corpus_j=jax_synthetic(**kw)[0],
                lam0=np.random.default_rng(1).gamma(100.0, 0.01, (20, 5000)))


def _card_layout(monkeypatch, segments=True):
    """The card's layout on the CPU: whole buckets on the route with dense
    sufficient statistics, with or without their chunks as segments."""
    monkeypatch.setattr(layouts, "chunks_ragged_rows",
                        lambda device_type, scatter: scatter)
    if not segments:
        monkeypatch.setattr(layouts, "ragged_chunks",
                            lambda rows, *a: [rows])


def _vb_run(data, cfg):
    eng = VariationalBayes(LDAConfig(**cfg), device="cpu")
    eng.initialize(data["corpus"], lam_init=data["lam0"])
    elbos = [eng.learning() for _ in range(CALLS)]
    return eng, elbos


def test_segments_are_the_jax_batches(queue3, monkeypatch):
    """A whole bucket's segments are the rows of the JAX engine's batches
    of that width, in order (17 chunks in 2 buckets here)."""
    theirs = jax_layouts.build_vb_batches(queue3["corpus_j"],
                                          JaxConfig(**QUEUE3))
    _card_layout(monkeypatch)
    eng = VariationalBayes(LDAConfig(**QUEUE3), device="cpu")
    eng.initialize(queue3["corpus"], lam_init=queue3["lam0"])
    got = [(b.ids.shape[1], n) for b in eng._batches
           for n in (b.segments or (b.rows,))]
    assert got == [tuple(b.ids.shape[::-1]) for b in theirs]
    assert len(eng._batches) < len(theirs)


def test_segment_bound_is_one_launch(queue3, monkeypatch):
    """The bound of the E-step's fixed points with whole buckets: each
    bucket is one launch, its operations its segments' shares of the rows
    at their own sweeps (4 K FLOP a slot a sweep), its bytes (8 a slot)
    read once; and each bucket keeps its segment index, built once."""
    _card_layout(monkeypatch)
    eng = VariationalBayes(LDAConfig(**QUEUE3), device="cpu")
    eng.initialize(queue3["corpus"], lam_init=queue3["lam0"])
    batches = eng._batches
    segs = [b.segments or (b.rows,) for b in batches]
    assert any(len(s) > 1 for s in segs)
    # Segments bound by operations (7 sweeps) and by bytes (1) alike.
    sweeps = [1.0 if i % 2 else 7.0 for i in range(sum(map(len, segs)))]
    peaks, K, it, want = roofline.H100, QUEUE3["number_of_topics"], \
        iter(sweeps), 0.0
    for b, ss in zip(batches, segs):
        T = b.ids.shape[1]
        ops = sum(4.0 * n * T * K * next(it) for n in ss)
        want += max(ops / peaks.f32_flops,
                    8.0 * b.rows * T / peaks.hbm_bytes) * 1e3
    got = roofline._sweeps_bound_ms(eng, batches, sweeps, peaks)
    assert got == pytest.approx(want, rel=1e-12)
    for b in batches:
        if b.segments is None:
            assert b.seg_rows is None
        else:
            assert torch.equal(b.seg_rows, segment_rows(b.segments, "cpu"))


def test_vb_whole_buckets_with_segments_match_chunks(queue3, monkeypatch):
    """Batch VB: whole buckets with segments give the chunked run's lambda
    and ELBOs bit for bit; without segments (one S* a bucket) they do
    not.  Each iteration's sweeps list one count a chunk."""
    chunked, elbo_c = _vb_run(queue3, QUEUE3)
    sweeps_c = [int(s) for s in chunked.last_sweeps]
    with monkeypatch.context() as m:
        _card_layout(m)
        whole, elbo_w = _vb_run(queue3, QUEUE3)
    assert len(whole._batches) < len(chunked._batches)
    assert [int(s) for s in whole.last_sweeps] == sweeps_c
    assert len(set(sweeps_c)) > 1
    assert torch.equal(whole.state.lam, chunked.state.lam)
    assert elbo_w == elbo_c
    with monkeypatch.context() as m:
        _card_layout(m, segments=False)
        one, elbo_1 = _vb_run(queue3, QUEUE3)
    assert all(b.segments is None for b in one._batches)
    assert len(one.last_sweeps) == len(one._batches)
    assert not torch.equal(one.state.lam, chunked.state.lam)
    assert elbo_1 != elbo_c


SVI = dict(number_of_topics=16, inference_mode="svi", batch_size=256,
           tau0=16.0, estep_memory_budget_mb=1, convergence_threshold=1e-3,
           dense_vocab_threshold=1024,
           doc_pad_multiple=16, seed=0)


def _svi_run(corpus, lam0):
    eng = StochasticVariationalBayes(LDAConfig(**SVI), device="cpu")
    eng.initialize(corpus, lam_init=lam0)
    elbos = [eng.learning() for _ in range(2)]
    return eng, elbos


def test_svi_whole_capacities_with_segments_match_chunks(monkeypatch):
    """SVI from the device-resident rows: each width's capacity whole with
    its chunks as segments gives the chunked run's lambda and bound
    estimates bit for bit; whole without segments does not."""
    corpus, _, _ = synthetic_corpus(num_docs=512, num_topics=16,
                                    num_types=3000, mean_doc_length=100.0,
                                    seed=2)
    lam0 = np.random.default_rng(1).gamma(100.0, 0.01, (16, 3000))
    chunked, est_c = _svi_run(corpus, lam0)
    assert any(len(r.chunk_sizes) > 1 for r in chunked._device_rows)
    with monkeypatch.context() as m:
        _card_layout(m)
        whole, est_w = _svi_run(corpus, lam0)
    assert all(r.chunk_sizes == [r.cap] for r in whole._device_rows)
    assert any(r.segments for r in whole._device_rows)
    assert [int(s) for s in whole.last_sweeps] == [
        int(s) for s in chunked.last_sweeps]
    assert torch.equal(whole.state.lam, chunked.state.lam)
    assert est_w == est_c
    with monkeypatch.context() as m:
        _card_layout(m, segments=False)
        one, est_1 = _svi_run(corpus, lam0)
    assert not any(r.segments for r in one._device_rows)
    assert not torch.equal(one.state.lam, chunked.state.lam)
    assert est_1 != est_c
