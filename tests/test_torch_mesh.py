"""The port's comm layer, ``pylda_tpu_torch.parallel.mesh`` (CPU).

Mirrors tests/test_sharding.py.  The JAX package shards one process's
simulated devices; the port runs one process a card, so its data-parallel
runs are two gloo ranks (``tests/torch_dist.py``), each its own process,
held three ways against one-process runs:

- (a) the JAX package's one-process engine on the same lambda_0, at the
  JAX multi-process tests' bars (ELBO rel 1e-3, lambda sum rel 1e-4,
  gamma sum rel 1e-3, held-out perplexity rel 1e-2);
- (b) the port's own one-process engine at pinned sweeps
  (``convergence_threshold=0``): lambda, sufficient statistics (lambda -
  eta after the first iteration) and the objectives within 1e-5,
  norm-relative;
- (c) bitwise equality of the replicated state across the ranks.

The sampling engines draw their own noise a rank, so they are held to
global count conservation, finite objectives and (c).  Also: the backend
choice, the mesh's refusals, process-local padding against the JAX
function's numpy logic, and block bounds against the JAX loader's.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from pylda_tpu.corpus.synthetic import synthetic_corpus as jax_synthetic
from pylda_tpu.models import Hybrid as JaxHybrid
from pylda_tpu.models import StochasticVariationalBayes as JaxSVI
from pylda_tpu.models import VariationalBayes as JaxVB
from pylda_tpu.parallel.mesh import lift_process_local_buckets as jax_lift
from pylda_tpu.parallel.mesh import make_mesh as jax_make_mesh
from pylda_tpu.utils.config import LDAConfig as JaxConfig
from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.models import make_engine
from pylda_tpu_torch.parallel import mesh as pmesh
from pylda_tpu_torch.utils.config import LDAConfig

from torch_dist import norm_rel, run_ranks

K, V = 4, 128
CORPUS = dict(num_docs=64, num_topics=K, num_types=V, mean_doc_length=30,
              seed=5)
TEST = dict(num_docs=16, num_topics=K, num_types=V, mean_doc_length=30,
            seed=6)
CFG = dict(number_of_topics=K, alpha_alpha=0.2, alpha_beta=0.02,
           inner_iterations=30, convergence_threshold=0.0, doc_pad_multiple=8,
           seed=0)
LAM_SEED = 9
# The JAX multi-process tests' bars, and the port's own at pinned sweeps.
ELBO_REL, LAM_REL, GAMMA_REL, PP_REL = 1e-3, 1e-4, 1e-3, 1e-2
PINNED_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _spec(corpus=CORPUS, test=TEST, **cfg):
    return dict(corpus=corpus, test=test, cfg={**CFG, **cfg},
                lam_seed=LAM_SEED, iterations=2)


def _lam0(K_, V_):
    return np.random.default_rng(LAM_SEED).gamma(100.0, 0.01, (K_, V_))


def _port_one(spec):
    """The port's one-process run of ``spec`` (no mesh)."""
    train, beta, _ = synthetic_corpus(**spec["corpus"])
    test = synthetic_corpus(beta=beta, **spec["test"])[0]
    cfg = LDAConfig(**spec["cfg"])
    eng = make_engine(cfg, device="cpu")
    eng.initialize(train, lam_init=_lam0(cfg.number_of_topics,
                                         train.num_types))
    objs = [eng.learning() for _ in range(spec["iterations"])]
    return eng, objs, eng.perplexity(test)


def _jax_one(spec, cls):
    """The JAX package's one-process run of ``spec``."""
    train, beta, _ = jax_synthetic(**spec["corpus"])
    test = jax_synthetic(beta=beta, **spec["test"])[0]
    cfg = JaxConfig(**spec["cfg"])
    eng = cls(cfg)
    eng.initialize(train, lam_init=_lam0(cfg.number_of_topics,
                                         train.num_types))
    objs = [eng.learning() for _ in range(spec["iterations"])]
    return eng, objs, eng.perplexity(test)


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def _hold(ranks, jax_run, port_run):
    """(c) bitwise across ranks, (a) against the JAX run, (b) against the
    port's one-process run."""
    r0, r1 = ranks
    for k in ("lam", "alpha", "eta", "objs", "gamma", "perplexity"):
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    j_eng, j_objs, j_pp = jax_run
    assert _rel(r0["objs"][-1], j_objs[-1]) < ELBO_REL, (r0["objs"], j_objs)
    j_lam = np.asarray(j_eng.state.lam, np.float64)
    assert _rel(r0["lam"].astype(np.float64).sum(), j_lam.sum()) < LAM_REL
    assert _rel(r0["gamma"].sum(), np.asarray(j_eng.gamma).sum()) < GAMMA_REL
    assert _rel(r0["perplexity"], j_pp) < PP_REL
    p_eng, p_objs, _ = port_run
    assert norm_rel(r0["lam"], p_eng.state.lam.numpy()) < PINNED_REL
    assert norm_rel(r0["objs"][:2], p_objs[:2]) < PINNED_REL


# -- the backend, the mesh and its refusals -----------------------------------------


@pytest.mark.parametrize("device, world, cards, want", [
    ("cuda", 1, 1, "nccl"),  # NCCL at world size 1: real collectives
    ("cuda", 2, 2, "nccl"),  # a card a rank
    ("cuda", 2, 1, "gloo"),  # two ranks sharing a card: NCCL refuses
    ("cuda", 4, 2, "gloo"),
    ("cpu", 2, 0, "gloo"),
    ("cpu", 1, 8, "gloo"),
])
def test_backend_choice(device, world, cards, want):
    assert pmesh.choose_backend(device, world, cards) == want


def test_mesh_in_one_process():
    """Without a process group the mesh is (1, 1) with no groups, and
    nothing is reduced or counted; a mesh of more ranks than the world
    size says how many processes to launch, a model axis too; a mesh
    built by hand for more ranks is refused the same way."""
    mesh = pmesh.make_mesh(device="cpu")
    assert (mesh.data, mesh.model, mesh.rank, mesh.grouped) == (1, 1, 0, False)
    assert mesh.shape == {"data": 1, "model": 1}
    pmesh.validate_process_aligned(mesh)
    before = dict(pmesh.COLLECTIVES)
    t = torch.ones(3)
    assert pmesh.all_reduce_sum(t, mesh) is t and t.sum() == 3
    assert pmesh.all_reduce_sum(t, None) is t
    assert pmesh.allgather_numpy(np.arange(3))[0].tolist() == [0, 1, 2]
    assert pmesh.broadcast_object("x") == "x"
    assert dict(pmesh.COLLECTIVES) == before
    with pytest.raises(ValueError, match="launch 2 processes"):
        pmesh.make_mesh((2, 1))
    with pytest.raises(ValueError, match="launch 2 processes"):
        pmesh.make_mesh((1, 2))
    with pytest.raises(ValueError, match="launch 4 processes"):
        pmesh.make_mesh((2, 2))
    with pytest.raises(ValueError, match="launch 2 processes"):
        pmesh.validate_process_aligned(dataclasses.replace(mesh, model=2))


def test_init_distributed_arguments():
    """No coordinator: a no-op (the JAX package's); a coordinator needs
    both the process count and id; torchrun's environment names all
    three."""
    assert pmesh.init_distributed() is None
    assert pmesh.init_distributed(None, 2, 0) is None
    with pytest.raises(ValueError, match="--num_processes"):
        pmesh.init_distributed("127.0.0.1:1", None, 0)
    with pytest.raises(ValueError, match="outside"):
        pmesh.init_distributed("127.0.0.1:1", 2, 2)
    env = {"MASTER_ADDR": "h", "MASTER_PORT": "7", "WORLD_SIZE": "4",
           "RANK": "3"}
    assert pmesh.environment_process_flags(env) == ("h:7", 4, 3)
    assert pmesh.environment_process_flags({"RANK": "0"}) is None
    assert pmesh.world() == (0, 1)


@pytest.mark.parametrize("total, count", [(120, 2), (121, 2), (10, 4),
                                          (3, 4), (0, 2)])
def test_block_bounds_match_jax_loader(total, count):
    """The ceil block of ``pylda_tpu.corpus.datasets`` (and its streaming
    corpus): the blocks tile [0, total) in order."""
    got = [pmesh.block_bounds(total, p, count) for p in range(count)]
    per = -(-total // count)
    want = [(min(p * per, total), min(min(p * per, total) + per, total))
            for p in range(count)]
    assert got == want
    assert got[0][0] == 0 and got[-1][1] == total


@pytest.mark.parametrize("layout", ["ragged", "sequence"])
def test_padding_and_rebase_match_jax(layout):
    """``pad_buckets_to`` (the numpy part of
    ``lift_process_local_buckets``) against the JAX function's, lifted in
    one process: every bucket padded to the row count (rounded up to
    doc_pad_multiple) with inert rows, doc ids re-based to global."""
    corpus = synthetic_corpus(num_docs=30, num_topics=K, num_types=300,
                              mean_doc_length=40, seed=2)[0]
    corpus_j = jax_synthetic(num_docs=30, num_topics=K, num_types=300,
                             mean_doc_length=40, seed=2)[0]
    sizes, pad, off = (16, 32, 64), 8, 1000
    build = ("to_ragged_buckets" if layout == "ragged"
             else "to_sequence_buckets")
    ours = getattr(corpus, build)(bucket_sizes=sizes, doc_pad_multiple=1)
    theirs = getattr(corpus_j, build)(bucket_sizes=sizes, doc_pad_multiple=1)
    rows = [next((b.mask.shape[0] for b in ours
                  if pmesh._width_of(b) == w), 0) for w in sizes]
    got = pmesh.pad_buckets_to(ours, sizes, rows, pad, off)
    want = jax_lift(theirs, sizes, pad, jax_make_mesh(shape=(1, 1),
                                                      devices=[jax_devices()[0]]),
                    off)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.mask.shape[0] % pad == 0
        for f in dataclasses.fields(g):
            np.testing.assert_array_equal(getattr(g, f.name),
                                          np.asarray(getattr(w, f.name)),
                                          err_msg=f.name)
        real = g.doc_ids >= 0
        assert (g.doc_ids[real] >= off).all() and (g.mask[~real] == 0).all()


def jax_devices():
    import jax

    return jax.devices()


# -- two ranks (mirrors of tests/test_sharding.py) -----------------------------------


def test_data_parallel_matches_single_device(tmp_path):
    """Batch VB on the dense layout, documents split over two ranks: one
    sstats all-reduce and one of the packed scalars an iteration."""
    spec = _spec()
    ranks = run_ranks("engine", spec, tmp_path)
    _hold(ranks, _jax_one(spec, JaxVB), _port_one(spec))
    assert ranks[0]["reduces"].tolist() == [2, 2]
    assert ranks[0]["backend"] == "gloo"


def test_hybrid_sstats_data_parallel_matches(tmp_path):
    """The large-vocabulary route (ragged gamma + dense sufficient
    statistics over each rank's own documents, per-document gamma
    assembled rank-locally) at V = 5000."""
    corpus = dict(num_docs=64, num_topics=K, num_types=5000,
                  mean_doc_length=25, seed=13)
    spec = _spec(corpus=corpus, test={**corpus, "num_docs": 16, "seed": 14},
                 bucket_sizes=(32, 64))
    ranks = run_ranks("engine", spec, tmp_path)
    _hold(ranks, _jax_one(spec, JaxVB), _port_one(spec))


def test_replica_consistency_check(tmp_path):
    """replica_checksums gathers every rank's float64 sums; a rank whose
    lambda differs makes assert_replicas_consistent raise."""
    ranks = run_ranks("replicas", _spec(), tmp_path)
    for r in ranks:
        assert r["same_before"] and r["ranks_in_sums"] == 2
        assert r["diverged"], r


def test_sharded_batch_layout(tmp_path):
    """Each rank's batches hold its own block of documents, padded to a
    row count shared by the ranks; the blocks tile the corpus."""
    for extra in ({}, {"dense_vocab_threshold": 0, "bucket_sizes": [16, 32]}):
        ranks = run_ranks("batches", _spec(**extra), tmp_path)
        seen = []
        for rank, r in enumerate(ranks):
            lo, hi = pmesh.block_bounds(CORPUS["num_docs"], rank, 2)
            assert r["doc_offset"] == lo
            ids = np.concatenate([r[f"doc_ids_{i}"]
                                  for i in range(int(r["num_batches"]))])
            real = np.unique(ids[ids >= 0])
            assert real.min() >= lo and real.max() < hi
            seen.extend(real.tolist())
        assert sorted(seen) == list(range(CORPUS["num_docs"]))
        for i in range(int(ranks[0]["num_batches"])):
            assert (ranks[0][f"doc_ids_{i}"].shape
                    == ranks[1][f"doc_ids_{i}"].shape)
            assert ranks[0][f"doc_ids_{i}"].shape[0] % CFG["doc_pad_multiple"] == 0


@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_svi_doc_sharded_matches_single_device(tmp_path, layout):
    """SVI on a corpus loaded whole on both ranks: the one-process
    schedule (the same minibatches, rhos and scales), each rank taking its
    slice of each minibatch, two all-reduces a minibatch."""
    extra = {} if layout == "dense" else {"dense_vocab_threshold": 0,
                                          "bucket_sizes": [16, 32, 64]}
    spec = _spec(inference_mode="svi", batch_size=16, tau0=16.0, kappa=0.7,
                 **extra)
    ranks = run_ranks("engine", spec, tmp_path)
    _hold(ranks, _jax_one(spec, JaxSVI), _port_one(spec))
    assert ranks[0]["reduces"].tolist() == [8, 8]  # 4 minibatches, 2 each


@pytest.mark.parametrize("mode", ["gibbs", "hybrid"])
def test_sampling_engines_run_sharded(tmp_path, mode):
    """Gibbs and hybrid over two ranks, each drawing its own noise: counts
    conserved globally, finite objectives, the same tables and lambda on
    both ranks; hybrid's held-out perplexity near the JAX engine's."""
    spec = _spec(inference_mode=mode, bucket_sizes=(32, 64),
                 number_of_samples=2, burn_in_sweeps=1)
    r0, r1 = run_ranks("engine", spec, tmp_path)
    for k in ("lam", "alpha", "eta", "objs", "perplexity"):
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert np.isfinite(r0["objs"]).all()
    if mode == "gibbs":
        np.testing.assert_array_equal(r0["n_kv"], r1["n_kv"])
        assert r0["n_kv"].sum() == r0["tokens"]
        assert r0["reduces"].tolist() == [2, 2]  # n_kv and the doc side
        assert np.isfinite(r0["perplexity"])
    else:
        # lambda = eta + sampled sstats: the sstats conserve the tokens.
        sstats = r0["lam"] - r0["eta"][None, :]
        np.testing.assert_allclose(sstats.sum(), r0["tokens"], rtol=1e-5)
        j_pp = _jax_one(spec, JaxHybrid)[2]
        assert _rel(r0["perplexity"], j_pp) < 0.1


@pytest.mark.parametrize("mode", ["vb", "svi", "gibbs"])
def test_phase_timings_allreduce(tmp_path, mode):
    """phase_timings under a mesh adds the step's all-reduce (its bytes:
    the [K, V] sufficient statistics, or n_kv), and the roofline report
    prints it over gloo with "no bound"; the timing leaves the replicated
    state bitwise as it was."""
    extra = {"svi": dict(inference_mode="svi", batch_size=16, tau0=16.0),
             "gibbs": dict(inference_mode="gibbs")}.get(mode, {})
    spec = {**_spec(**extra), "timings": True}
    r0, r1 = run_ranks("engine", spec, tmp_path)
    for r in (r0, r1):
        times = json.loads(str(r["timings"]))
        assert times["allreduce_bytes"] == K * V * 4
        assert times["allreduce_backend"] == "gloo"
        assert times["allreduce_ms"] > 0
        row = json.loads(str(r["roofline"]))["allreduce"]
        assert row["bound"] == "no bound" and row["bound_ms"] is None
    np.testing.assert_array_equal(r0["lam"], r1["lam"])


@pytest.mark.parametrize("cards, world, want", [(1, 1, "nccl"), (1, 2, "gloo"),
                                                (2, 2, "nccl")])
def test_init_distributed_backend_on_cards(monkeypatch, cards, world, want):
    """init_distributed's backend from the device and the world size
    against the card count, with the rank's card made current first (the
    group itself faked: no card here)."""
    calls = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.setdefault("device", d))
    monkeypatch.setattr(pmesh.dist, "init_process_group",
                        lambda **kw: calls.update(kw))
    monkeypatch.setattr(pmesh.dist, "new_group", lambda **kw: "host")
    monkeypatch.setattr(pmesh, "_GROUPS", None)
    rank = world - 1
    got = pmesh.init_distributed("127.0.0.1:1", world, rank, device="cuda")
    assert got == want == calls["backend"]
    assert calls["device"] == rank % cards
    assert calls["init_method"] == "tcp://127.0.0.1:1"
    assert pmesh._GROUPS[3] == f"cuda:{rank % cards}"
    assert pmesh._GROUPS[1] == ("host" if want == "nccl"
                                else pmesh.dist.group.WORLD)


def test_make_mesh_without_a_card_needs_the_cpu_named(monkeypatch):
    """No card and no group: ``make_mesh()`` raises, as an engine's
    ``resolve_device`` does, and names ``device='cpu'``; with it the mesh
    is the CPU's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pmesh, "_GROUPS", None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmesh.make_mesh((1, 1))
    mesh = pmesh.make_mesh(device="cpu")
    assert mesh.device == torch.device("cpu")
    assert (mesh.data, mesh.model, mesh.grouped) == (1, 1, False)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_init_distributed_without_a_card_needs_the_cpu_named(monkeypatch,
                                                             device):
    """No card: ``init_distributed`` with no device (or "cuda") raises
    before it joins a group, naming ``device='cpu'``; with "cpu" it joins
    over gloo and the group's device, which ``make_mesh`` takes, is the
    CPU (the group itself faked)."""
    calls = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pmesh.dist, "init_process_group",
                        lambda **kw: calls.update(kw))
    monkeypatch.setattr(pmesh, "_GROUPS", None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmesh.init_distributed("127.0.0.1:1", 2, 0, device=device)
    assert calls == {} and pmesh._GROUPS is None
    assert pmesh.init_distributed("127.0.0.1:1", 2, 1, device="cpu") == "gloo"
    assert calls["backend"] == "gloo" and calls["rank"] == 1
    assert pmesh._GROUPS[3] == "cpu"


@pytest.mark.parametrize("backend, data, bounded", [("nccl", 1, True),
                                                    ("nccl", 2, False),
                                                    ("gloo", 1, False)])
def test_allreduce_row_bound(backend, data, bounded):
    """The roofline's all-reduce row: a bound (the tensor read once over
    the H100's memory rate) only for NCCL at world size 1, where the
    in-place reduce of one rank reads the tensor and nothing else."""
    import types

    from pylda_tpu_torch.utils import roofline

    eng = types.SimpleNamespace(_mesh=types.SimpleNamespace(data=data))
    row = roofline.allreduce_row(eng, {"allreduce_ms": 0.2,
                                       "allreduce_bytes": 400_000_000,
                                       "allreduce_backend": backend})
    assert row["measured_ms"] == 0.2 and row["backend"] == backend
    if bounded:
        assert row["bound_ms"] == pytest.approx(0.4e9 / 3.35e12 * 1e3,
                                                rel=1e-5)
        assert row["utilisation"] == pytest.approx(row["bound_ms"] / 0.2,
                                                   rel=1e-3)
    else:
        assert row["bound_ms"] is None and row["bound"] == "no bound"
