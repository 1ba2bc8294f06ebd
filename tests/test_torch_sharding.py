"""Lambda split over the mesh's model axis (``--shard_vocab``,
``--shard_topics``) in the port: batch VB on the CPU, ranks in processes.

Mirrors tests/test_sharding.py:74 and :90 (the JAX package's (4, 2) mesh
on 8 simulated devices against its unsharded run): the same corpus,
lambda init and config, run on gloo ranks of the port
(``tests/torch_dist.py``) at meshes (1, 2) and (2, 2), on each route
(the dense layout, the ragged gamma with dense sufficient statistics,
the ragged gamma with the row scatter), held

- against the JAX engine's unsharded run at the JAX tests' bars (ELBO
  rel 1e-4, topic-word matrix atol 3e-3), at the JAX tests' settings;
- against the port's one-process run at pinned sweeps (no convergence
  exit, so only summation orders differ) within 1e-5 (ELBO, lambda,
  held-out perplexity), and bitwise for ``shard_topics`` at (1, 2) off
  the scatter route;
- bitwise across the ranks (every rank gathers the same lambda), each
  lambda block bitwise across its data group and the blocks tiling
  (K, V) after every iteration (``assert_replicas_consistent``).

Also: the plain sufficient statistics' topic and vocab ranges against
the whole call's rows and JAX's, the mesh's groups and checks, the
doc-level terms counted once at (2, 2) and the all-gather's roofline
row.  Gibbs and hybrid under a model axis are held in
tests/test_torch_sharding_sampling.py.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from pylda_tpu.corpus.synthetic import synthetic_corpus as jax_synthetic
from pylda_tpu.models import VariationalBayes as JaxVB
from pylda_tpu.ops.estep import estep_dense_sstats as jax_dense_sstats
from pylda_tpu.utils.config import LDAConfig as JaxConfig
from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.models import make_engine
from pylda_tpu_torch.ops.estep import estep_dense_sstats, scatter_sstats
from pylda_tpu_torch.ops.ragged import gather_table
from pylda_tpu_torch.parallel import mesh as pmesh
from pylda_tpu_torch.utils.config import LDAConfig

from torch_dist import norm_rel, run_ranks

# tests/test_sharding.py's corpus, lambda init and config; held-out
# documents from the same topics.
CORPUS = dict(num_docs=64, num_topics=4, num_types=128, mean_doc_length=30,
              seed=5)
TEST = dict(num_docs=16, num_topics=4, num_types=128, mean_doc_length=30,
            seed=6)
LAM_SEED = 9
BASE = dict(number_of_topics=4, alpha_alpha=0.2, alpha_beta=0.02,
            inner_iterations=30, doc_pad_multiple=8, seed=0,
            gamma_init="ones")
# Pinned sweeps: every row runs the cap.  The Newton updates (every
# iteration) are held in ``test_doc_terms_counted_once_at_2x2``.
PINNED = dict(convergence_threshold=0.0, inner_iterations=20)
HYPERS = dict(hyper_parameter_optimize_interval=1)
# The routes: V = 128 is the dense layout; a threshold below it takes the
# ragged gamma with dense sufficient statistics, or the row scatter.
ROUTES = {"dense": {},
          "ragged": {"dense_vocab_threshold": 64},
          "scatter": {"dense_vocab_threshold": 64, "sstats_mode": "scatter"}}
# The JAX tests' bars, and the pinned-sweep bar against one process.
ELBO_REL, TWD_ATOL, PINNED_REL = 1e-4, 3e-3, 1e-5
ITERATIONS = 2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def lam_init():
    return np.random.default_rng(LAM_SEED).gamma(
        100.0, 0.01, (CORPUS["num_topics"], CORPUS["num_types"]))


def flag(mode: str) -> dict:
    return {"shard_vocab": True} if mode == "vocab" else {"shard_topics": True}


@functools.lru_cache(maxsize=None)
def jax_run(cfg_json: str, iterations: int = ITERATIONS):
    """The JAX engine's unsharded run: (objectives, lambda, topic-word
    matrix)."""
    from pylda_tpu.models import StochasticVariationalBayes as JaxSVI

    cfg = json.loads(cfg_json)
    train = jax_synthetic(**CORPUS)[0]
    eng = (JaxSVI if cfg.get("inference_mode") == "svi" else JaxVB)(
        JaxConfig(**cfg))
    eng.initialize(train, lam_init=lam_init())
    objs = [eng.learning() for _ in range(iterations)]
    return (np.asarray(objs), np.asarray(eng.state.lam),
            eng.topic_word_distribution())


@functools.lru_cache(maxsize=None)
def port_run(cfg_json: str, iterations: int):
    """The port's one-process run on the CPU: (objectives, lambda, alpha,
    eta, held-out perplexity)."""
    train, beta, _ = synthetic_corpus(**CORPUS)
    test = synthetic_corpus(beta=beta, **TEST)[0]
    eng = make_engine(LDAConfig(**json.loads(cfg_json)), device="cpu")
    eng.initialize(train, lam_init=lam_init())
    objs = [eng.learning() for _ in range(iterations)]
    st = eng.state
    return (np.asarray(objs), st.lam.numpy(), st.alpha.numpy(),
            st.eta.numpy(), eng.perplexity(test))


def run_sharded(tmp_path, shape, runs, iterations=ITERATIONS, **extra):
    """``runs`` on a mesh ``shape`` of gloo ranks (``case_shard``); checks
    what must agree across the ranks and returns rank 0's results."""
    spec = dict(corpus=CORPUS, test=TEST, lam_seed=LAM_SEED,
                mesh_shape=list(shape), runs=runs, iterations=iterations,
                **extra)
    ranks = run_ranks("shard", spec, tmp_path, world=shape[0] * shape[1])
    M = shape[1]
    for i in range(len(runs)):
        p = f"r{i}_"
        for r in ranks[1:]:
            for k in ("objs", "lam", "alpha", "eta", "gamma", "twd"):
                np.testing.assert_array_equal(r[p + k], ranks[0][p + k],
                                              err_msg=k)
        mode = "vocab" if runs[i].get("shard_vocab") else "topics"
        axis, total = ((1, CORPUS["num_types"]) if mode == "vocab"
                       else (0, CORPUS["num_topics"]))
        for r, res in enumerate(ranks):
            want = pmesh.block_bounds(total, r % M, M)
            assert tuple(res[p + "bounds"]) == want
            assert res[p + "block"][axis] == want[1] - want[0]
    return ranks[0]


def _elbo_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


_VB_CASES = [
    ("vocab", (1, 2), "dense"), ("topics", (1, 2), "dense"),
    ("vocab", (2, 2), "dense"), ("topics", (2, 2), "dense"),
    ("vocab", (1, 2), "ragged"), ("topics", (1, 2), "ragged"),
    ("vocab", (2, 2), "ragged"),
    ("vocab", (1, 2), "scatter"), ("topics", (1, 2), "scatter"),
    ("topics", (2, 2), "scatter"),
]


@pytest.mark.parametrize("mode, shape, route", _VB_CASES)
def test_vb_lambda_split_matches_jax_and_one_process(tmp_path, mode, shape,
                                                     route):
    """tests/test_sharding.py:74 (vocab) and :90 (topics) on each route,
    and the pinned-sweep hold against one process."""
    defaults = {**BASE, **ROUTES[route]}
    pinned = {**defaults, **PINNED}
    r = run_sharded(tmp_path, shape, [
        {**defaults, **flag(mode), "mesh_shape": list(shape)},
        {**pinned, **flag(mode), "mesh_shape": list(shape)}])
    j_objs, _, j_twd = jax_run(json.dumps(defaults, sort_keys=True))
    assert _elbo_rel(r["r0_objs"], j_objs) < ELBO_REL, (r["r0_objs"], j_objs)
    np.testing.assert_allclose(r["r0_twd"], j_twd, atol=TWD_ATOL)
    p_objs, p_lam, p_alpha, p_eta, p_pp = port_run(
        json.dumps(pinned, sort_keys=True), ITERATIONS)
    assert _elbo_rel(r["r1_objs"], p_objs) < PINNED_REL
    assert norm_rel(r["r1_lam"], p_lam) < PINNED_REL
    assert norm_rel(r["r1_alpha"], p_alpha) < PINNED_REL
    assert norm_rel(r["r1_eta"], p_eta) < PINNED_REL
    # Held-out inference runs on the gathered expElogbeta.
    assert abs(float(r["r1_perplexity"]) - p_pp) / p_pp < PINNED_REL
    if mode == "topics" and shape == (1, 2) and route != "scatter":
        # The gamma kernels see the one-process expElogbeta bits, and the
        # topic range gives the whole call's rows.
        np.testing.assert_array_equal(r["r1_lam"], p_lam)


def test_doc_terms_counted_once_at_2x2(tmp_path):
    """At (2, 2) both groups hold two ranks: the theta terms, E[log theta]
    (alpha's Newton input) and the token score sum over the data group
    once.  Counted over every rank the doc-level ELBO terms and alpha's
    input would double; held to one process at pinned sweeps, the Newton
    alpha and eta updates every iteration."""
    cfg = {**BASE, **PINNED, **HYPERS, "shard_vocab": True,
           "mesh_shape": [2, 2]}
    r = run_sharded(tmp_path, (2, 2), [cfg], iterations=3)
    one = {k: v for k, v in cfg.items() if k not in ("shard_vocab",
                                                      "mesh_shape")}
    p_objs, p_lam, p_alpha, p_eta, _ = port_run(
        json.dumps(one, sort_keys=True), 3)
    assert _elbo_rel(r["r0_objs"], p_objs) < PINNED_REL
    assert norm_rel(r["r0_alpha"], p_alpha) < PINNED_REL
    assert norm_rel(r["r0_eta"], p_eta) < PINNED_REL
    assert norm_rel(r["r0_lam"], p_lam) < PINNED_REL


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K, topic_range", [(7, (0, 3)), (7, (3, 7)),
                                            (100, (0, 50)), (100, (37, 90)),
                                            (257, (128, 257))])
def test_topic_range_plain_matches_full_rows_and_jax(K, topic_range,
                                                     compute_dtype):
    """The plain sufficient statistics over a topic range: the whole
    call's rows bit for bit and the whole score's bits, and JAX's
    ``estep_dense_sstats`` rows within rel 1e-6 (norm)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(K)
    D, V = 40, 300
    counts = (rng.random((D, V)) < 0.05) * rng.integers(1, 4, (D, V))
    et = rng.gamma(1.0, 1.0, (D, K))
    eeb = rng.gamma(1.0, 1.0, (K, V)) / V
    t = [torch.tensor(x, dtype=torch.float32) for x in (counts, et, eeb)]
    ss, tok = estep_dense_sstats(*t, compute_dtype=compute_dtype)
    k0, k1 = topic_range
    ss_r, tok_r = estep_dense_sstats(*t, compute_dtype=compute_dtype,
                                     topic_range=topic_range)
    assert ss_r.shape == (k1 - k0, V)
    assert torch.equal(ss_r, ss[k0:k1]) and torch.equal(tok_r, tok)
    ss_j, _ = jax_dense_sstats(*(jnp.asarray(x.numpy()) for x in t),
                               compute_dtype=compute_dtype)
    assert norm_rel(ss_r.numpy(), np.asarray(ss_j)[k0:k1]) < 1e-6


@pytest.mark.parametrize("which, rng_", [("vocab", (0, 20)),
                                         ("vocab", (13, 37)),
                                         ("vocab", (37, 50)),
                                         ("topics", (0, 3)),
                                         ("topics", (3, 7))])
def test_scatter_range_matches_full_rows(which, rng_):
    """The row scatter over a vocab range (the other words' slots sort
    past the last and are left out) or a topic range: the whole call's
    columns or rows bit for bit; the vocab ranges' token scores add up to
    the whole score."""
    g = torch.Generator().manual_seed(0)
    D, T, K, V = 30, 12, 7, 50
    ids = torch.randint(0, V, (D, T), dtype=torch.int32, generator=g)
    cnts = torch.randint(0, 4, (D, T), generator=g).float()
    et = torch.rand(D, K, generator=g)
    eeb = torch.rand(K, V, generator=g)
    tab = gather_table(eeb)
    ss, tok = scatter_sstats(ids, cnts, et, eeb, tab)
    lo, hi = rng_
    if which == "vocab":
        got, tok_r = scatter_sstats(ids, cnts, et, eeb, tab,
                                    vocab_range=rng_)
        assert torch.equal(got, ss[:, lo:hi])
        rest = [scatter_sstats(ids, cnts, et, eeb, tab, vocab_range=r)[1]
                for r in ((0, lo), (hi, V)) if r[1] > r[0]]
        assert float(tok_r + sum(rest)) == pytest.approx(float(tok),
                                                         rel=1e-6)
    else:
        got, tok_r = scatter_sstats(ids, cnts, et, eeb, tab,
                                    topic_range=rng_)
        assert torch.equal(got, ss[lo:hi]) and torch.equal(tok_r, tok)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_mesh_groups_and_checks(tmp_path, shape):
    """Rank r sits at (r // M, r % M); the data group sums the ranks of
    its model coordinate and the model group those of its data
    coordinate; a [K, V] tensor's blocks gather whole along either axis
    and tile it, a wrong shape is caught, and a lambda block one ulp off
    on one rank fails the replica check where its data group has two
    ranks (on every rank: the check is collective)."""
    D, M = shape
    spec = dict(corpus=CORPUS, mesh_shape=list(shape), shape=[5, 13],
                bump_rank=D * M - 1)
    ranks = run_ranks("groups", spec, tmp_path, world=D * M)
    for r, res in enumerate(ranks):
        d, m = r // M, r % M
        assert (int(res["data_index"]), int(res["model_index"])) == (d, m)
        assert float(res["data_sum"]) == sum(j * M + m for j in range(D))
        assert float(res["model_sum"]) == sum(d * M + j for j in range(M))
        for axis in (0, 1):
            assert bool(res[f"gather_ok_{axis}"])
            assert bool(res[f"bad_tiling_caught_{axis}"])
        assert bool(res["diverged"]) == (D > 1)


@pytest.mark.parametrize("kind, backend, data, model, bounded", [
    ("allgather", "gloo", 1, 2, False), ("allgather", "nccl", 2, 2, False),
    ("allgather", "nccl", 2, 1, True), ("allreduce", "nccl", 1, 2, True)])
def test_collective_rows(kind, backend, data, model, bounded):
    """The roofline's collective rows: a bound only for NCCL over a group
    of one card (the all-reduce runs over the data group, the gather of
    expElogbeta over the model group)."""
    import types

    from pylda_tpu_torch.utils import roofline

    eng = types.SimpleNamespace(
        _mesh=types.SimpleNamespace(data=data, model=model))
    row = roofline.allreduce_row(eng, {f"{kind}_ms": 0.2,
                                       f"{kind}_bytes": 400_000_000,
                                       "allreduce_backend": backend}, kind)
    if bounded:
        assert row["bound_ms"] == pytest.approx(0.4e9 / 3.35e12 * 1e3,
                                                rel=1e-5)
    else:
        assert row["bound_ms"] is None and row["bound"] == "no bound"


def test_lambda_block_setter_and_gather_without_a_group():
    """The ``state`` setter takes the whole lambda and keeps this rank's
    block; a mesh of one model coordinate keeps lambda whole."""
    from pylda_tpu_torch.models.base import state_from_numpy
    from pylda_tpu_torch.parallel.lam_shard import shard_of

    mesh = pmesh.Mesh(data=1, model=2, rank=1, device=torch.device("cpu"),
                      device_group=None, host_group=None, backend=None)
    sh = shard_of(True, False, mesh, 4, 128)
    assert sh.bounds == (64, 128) and sh.vocab_range == (64, 128)
    assert shard_of(True, False, dataclasses.replace(mesh, model=1), 4,
                    128) is None
    train = synthetic_corpus(**CORPUS)[0]
    eng = make_engine(LDAConfig(**BASE), device="cpu")
    eng.initialize(train, lam_init=lam_init())
    eng._shard = sh
    full = state_from_numpy({"lam": lam_init(), "alpha": np.ones(4),
                             "eta": np.ones(128), "step": 0}, "cpu")
    eng.state = full
    np.testing.assert_array_equal(eng.state.lam.numpy(),
                                  full.lam.numpy()[:, 64:])
    with pytest.raises(ValueError, match="exclusive"):
        LDAConfig(**BASE, shard_vocab=True, shard_topics=True).validate()
