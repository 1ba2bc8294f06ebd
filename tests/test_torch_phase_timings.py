"""``phase_timings`` of the port's engines (CPU).

Each engine returns the JAX engine's keys on the same corpus and config
(the roofline reads them), every value is positive, and timing leaves
the engine's state bitwise as it was: lambda, alpha, eta, the step, SVI's
minibatch counter ``_t``, Gibbs's z and count tables, and what the next
iteration computes (the same ELBO or likelihood, bit for bit, as an
engine that was never timed).
"""

import numpy as np
import pytest
import torch

from pylda_tpu.corpus.synthetic import synthetic_corpus as jax_synthetic
from pylda_tpu.models import make_engine as jax_make_engine
from pylda_tpu.utils.config import LDAConfig as JaxConfig
from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.models import make_engine
from pylda_tpu_torch.utils.config import LDAConfig

K, V, D = 5, 400, 80
CORPUS = dict(num_docs=D, num_topics=K, num_types=V, mean_doc_length=30.0,
              seed=2)
BASE = dict(number_of_topics=K, inner_iterations=10, doc_pad_multiple=8,
            batch_size=32, number_of_samples=2, burn_in_sweeps=1,
            hyper_parameter_optimize_interval=2, seed=0)
CASES = {
    "vb_ragged_dense_sstats": dict(inference_mode="vb",
                                   dense_vocab_threshold=0),
    "vb_scatter": dict(inference_mode="vb", dense_vocab_threshold=0,
                       sstats_mode="scatter"),
    "vb_dense": dict(inference_mode="vb"),
    "vb_gamma_init": dict(inference_mode="vb", dense_vocab_threshold=0,
                          gamma_init="gamma"),
    "svi_ragged": dict(inference_mode="svi", dense_vocab_threshold=0),
    "svi_scatter": dict(inference_mode="svi", dense_vocab_threshold=0,
                        sstats_mode="scatter"),
    "svi_dense": dict(inference_mode="svi"),
    "gibbs": dict(inference_mode="gibbs"),
    "hybrid": dict(inference_mode="hybrid"),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def corpora():
    return synthetic_corpus(**CORPUS)[0], jax_synthetic(**CORPUS)[0]


def _ours(corpora, case):
    eng = make_engine(LDAConfig(**{**BASE, **CASES[case]}), device="cpu")
    eng.initialize(corpora[0])
    eng.learning()
    return eng


def _snapshot(eng):
    st = eng.state
    snap = {f: getattr(st, f).clone() for f in ("lam", "alpha", "eta", "step")}
    snap["counter"] = eng._counter
    snap["t"] = getattr(eng, "_t", None)
    if hasattr(eng, "_n_kv"):
        snap["n_kv"] = eng._n_kv.clone()
        snap["z"] = [z.clone() for z in eng._z]
        snap["ndk"] = [n.clone() for n in eng._ndk]
    return snap


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("case", sorted(CASES))
def test_keys_match_jax_and_values_positive(corpora, case):
    ours = _ours(corpora, case)
    got = ours.phase_timings(repeats=1)
    theirs = jax_make_engine(JaxConfig(**{**BASE, **CASES[case]}))
    theirs.initialize(corpora[1])
    theirs.learning()
    want = theirs.phase_timings(repeats=1)
    assert set(got) == set(want)
    assert all(v > 0 for v in got.values()), got
    if "minibatches_per_epoch" in got:
        assert got["minibatches_per_epoch"] == want["minibatches_per_epoch"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_timing_leaves_the_state_unchanged(corpora, case):
    timed, untimed = _ours(corpora, case), _ours(corpora, case)
    before = _snapshot(timed)
    timed.phase_timings(repeats=2)
    after = _snapshot(timed)
    assert set(before) == set(after)
    for k in before:
        assert _same(before[k], after[k]), k
    assert timed.learning() == untimed.learning()
    assert torch.equal(timed.state.lam, untimed.state.lam)


def test_base_default_is_empty():
    from pylda_tpu_torch.models.base import Inferencer

    assert Inferencer.phase_timings(object()) == {}


@pytest.mark.parametrize("case", ["vb_ragged_dense_sstats", "svi_ragged"])
def test_timed_sweeps_stay_in_last_sweeps(corpora, case):
    """After timing, ``last_sweeps`` holds one count a timed batch (the
    corpus's buckets, or the timed minibatch's), which the roofline
    reads."""
    eng = _ours(corpora, case)
    eng.phase_timings(repeats=1)
    batches = (eng.timing_minibatch()[0] if case.startswith("svi")
               else eng._batches)
    sweeps = np.asarray([int(s) for s in eng.last_sweeps])
    assert sweeps.size == len(batches)
    assert ((1 <= sweeps) & (sweeps <= BASE["inner_iterations"])).all()
