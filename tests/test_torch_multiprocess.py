"""Multi-process training of the port with process-local input (CPU).

Mirrors tests/test_multiprocess.py case for case: two gloo ranks of the
port (``tests/torch_dist.py``), each parsing only its own block of
doc.dat where the JAX test's hosts do, held against the JAX package's
one-process run of the same global work at the JAX test's bars (ELBO,
estimates and gamma sum rel 1e-3, lambda sum rel 1e-4, held-out
perplexity rel 1e-2) and bitwise across the ranks.  Process-local SVI
runs the JAX engine's per-host schedule, so its reference is the JAX
test's emulation: the same global minibatches through the unsharded
epoch scan.  Also: the negotiated SVI geometry against the JAX
function's on the same blocks (its gathers emulated in threads), a
collective one rank never joins failing within the group timeout, the
train CLI under the process flags and under torchrun's environment, and
model files across world sizes.
"""

import glob
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from pylda_tpu.corpus.datasets import load_input_directory as jax_load
from pylda_tpu.models import Inferencer as JaxInferencer
from pylda_tpu.models import StochasticVariationalBayes as JaxSVI
from pylda_tpu.models import VariationalBayes as JaxVB
from pylda_tpu.models import layouts as jax_layouts
from pylda_tpu.parallel import mesh as jax_mesh
from pylda_tpu.utils.config import LDAConfig as JaxConfig
from pylda_tpu_torch.corpus.datasets import make_denews_tiny
from pylda_tpu_torch.models import Inferencer

from torch_dist import free_port, norm_rel, rank_env, run_ranks, wait_all

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ELBO_REL, LAM_REL, GAMMA_REL, PP_REL = 1e-3, 1e-4, 1e-3, 1e-2
LAM_SEED = 9
# The gamma fixed point's soft stall exit ends a batch when each of its
# rows is done or stalled, so a stalled row's last sweep depends on its
# batch-mates.  A rank's batches hold its own documents (the JAX engine's
# global batch exits on all hosts' rows at once), so runs held to a
# one-process run turn the stall exit off; the per-row freeze at the
# threshold stays, and keeps each row independent of its batch.
STALL_OFF = 0
SVI = dict(inference_mode="svi", batch_size=32, tau0=16.0, kappa=0.7,
           inner_iterations=20, doc_pad_multiple=4, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def denews_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("denews"))
    make_denews_tiny(d, num_train=120, num_test=30, mean_doc_length=25)
    return d


def write_text_corpus(corpus_dir, num_docs=48, num_types=5000, seed=11,
                      oversized=True):
    """doc.dat/voc.dat with V > dense_vocab_threshold and documents
    spanning two buckets, plus (``oversized``) one document over the
    largest bucket (chunked rows): the JAX test's corpus."""
    os.makedirs(corpus_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    with open(os.path.join(corpus_dir, "voc.dat"), "w") as f:
        for v in range(num_types):
            f.write(f"w{v}\n")
    with open(os.path.join(corpus_dir, "doc.dat"), "w") as f:
        for d in range(num_docs):
            if d == 3 and oversized:
                n_unique = 300
            elif d % 2:
                n_unique = int(rng.integers(70, 120))
            else:
                n_unique = int(rng.integers(10, 50))
            ids = rng.choice(num_types, size=n_unique, replace=False)
            toks = np.repeat(ids, rng.integers(1, 4, size=n_unique))
            f.write(" ".join(f"w{t}" for t in toks) + "\n")
    return corpus_dir


@pytest.fixture(scope="module")
def ragged_dir(tmp_path_factory):
    return write_text_corpus(str(tmp_path_factory.mktemp("ragged")))


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def _same(ranks, keys):
    for k in keys:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def _lam0(K, V):
    return np.random.default_rng(LAM_SEED).gamma(100.0, 0.01, (K, V))


# -- batch VB ----------------------------------------------------------------------


@pytest.mark.parametrize("sstats_mode", ["auto", "scatter"])
def test_two_process_ragged_sharded_input_matches_full_load(
        tmp_path, ragged_dir, sstats_mode):
    """The large-vocabulary process-local pipeline: configured-width
    buckets padded to the ranks' largest row counts.  Each rank's dense
    sufficient statistics (auto) or row scatter cover its own documents;
    either matches the JAX package's full-load run of the same route."""
    cfg = dict(number_of_topics=5, inner_iterations=20, doc_pad_multiple=4,
               seed=0, bucket_sizes=[64, 128], sstats_mode=sstats_mode,
               estep_stall_patience=STALL_OFF)
    ranks = run_ranks("engine", dict(corpus_dir=ragged_dir, cfg=cfg,
                                     process_local=True, lam_seed=LAM_SEED,
                                     iterations=2), tmp_path)
    _same(ranks, ("lam", "objs", "gamma"))
    train, test, vocab = jax_load(ragged_dir)
    eng = JaxVB(JaxConfig(**{**cfg, "bucket_sizes": (64, 128)}))
    eng.initialize(train, vocab, lam_init=_lam0(5, len(vocab)))
    ref = [eng.learning() for _ in range(2)]
    assert (eng._sstats_plan is None) == (sstats_mode == "scatter")
    assert _rel(ranks[0]["objs"][-1], ref[-1]) < ELBO_REL, (ranks[0], ref)
    assert _rel(ranks[0]["gamma"].sum(), eng.gamma.sum()) < GAMMA_REL
    assert _rel(ranks[0]["lam"].astype(np.float64).sum(),
                np.asarray(eng.state.lam, np.float64).sum()) < LAM_REL


def test_two_process_sharded_input_matches_full_load(tmp_path, denews_dir):
    """Each rank parses only its half of doc.dat (dense layout, one batch
    of the ranks' shared row count): the same as the JAX package's
    full-corpus run; gamma in global document order."""
    cfg = dict(number_of_topics=5, inner_iterations=20, doc_pad_multiple=4,
               seed=0, estep_stall_patience=STALL_OFF)
    ranks = run_ranks("engine", dict(corpus_dir=denews_dir, cfg=cfg,
                                     process_local=True, lam_seed=LAM_SEED,
                                     iterations=3), tmp_path)
    _same(ranks, ("lam", "objs", "gamma", "perplexity"))
    assert ranks[0]["gamma"].shape == (120, 5)
    train, test, vocab = jax_load(denews_dir)
    eng = JaxVB(JaxConfig(**cfg))
    eng.initialize(train, vocab, lam_init=_lam0(5, len(vocab)))
    ref = [eng.learning() for _ in range(3)]
    assert _rel(ranks[0]["objs"][-1], ref[-1]) < ELBO_REL
    assert _rel(ranks[0]["perplexity"], eng.perplexity(test)) < PP_REL
    assert _rel(ranks[0]["gamma"].sum(), eng.gamma.sum()) < GAMMA_REL


def test_stall_exit_is_per_rank_batch(tmp_path, denews_dir):
    """The divergence STALL_OFF names: with the stall exit off, the
    two-rank run at the default threshold is the port's one-process run
    (1e-5); with it on, the ranks still agree bitwise and the objectives
    are finite, but a stalled row's last sweep follows its rank's batch."""
    from pylda_tpu_torch.corpus.datasets import load_input_directory
    from pylda_tpu_torch.models import VariationalBayes

    train, _, vocab = load_input_directory(denews_dir)
    for patience in (STALL_OFF, 6):
        cfg = dict(number_of_topics=5, inner_iterations=20,
                   doc_pad_multiple=4, seed=0,
                   estep_stall_patience=patience)
        ranks = run_ranks("engine", dict(corpus_dir=denews_dir, cfg=cfg,
                                         process_local=True,
                                         lam_seed=LAM_SEED, iterations=2),
                          tmp_path)
        _same(ranks, ("lam", "objs"))
        assert np.isfinite(ranks[0]["objs"]).all()
        if patience == STALL_OFF:
            from pylda_tpu_torch.utils.config import LDAConfig

            one = VariationalBayes(LDAConfig(**cfg), device="cpu")
            one.initialize(train, vocab, lam_init=_lam0(5, len(vocab)))
            ref = [one.learning() for _ in range(2)]
            assert norm_rel(ranks[0]["objs"], ref) < 1e-5
            assert norm_rel(ranks[0]["lam"], one.state.lam.numpy()) < 1e-5


def test_two_process_training_matches_single(tmp_path):
    """A corpus loaded whole on both ranks, split over the mesh, through
    learning() and learning_many: the JAX one-process run's ELBOs."""
    corpus = dict(num_docs=64, num_topics=4, num_types=128,
                  mean_doc_length=30, seed=5)
    cfg = dict(number_of_topics=4, alpha_alpha=0.2, alpha_beta=0.02,
               inner_iterations=30, doc_pad_multiple=8, seed=0)
    ranks = run_ranks("engine", dict(corpus=corpus, cfg=cfg,
                                     lam_seed=LAM_SEED, iterations=2,
                                     many=2), tmp_path)
    _same(ranks, ("lam", "objs"))
    from pylda_tpu.corpus.synthetic import synthetic_corpus as jax_synthetic

    eng = JaxVB(JaxConfig(**cfg))
    eng.initialize(jax_synthetic(**corpus)[0], lam_init=_lam0(4, 128))
    ref = [eng.learning() for _ in range(2)] + eng.learning_many(2)
    for a, b in zip(ranks[0]["objs"], ref):
        assert _rel(a, b) < ELBO_REL, (ranks[0]["objs"], ref)


# -- the sampling engines --------------------------------------------------------------


def test_two_process_sampling_engines_conserve_counts(tmp_path, denews_dir):
    """Gibbs and hybrid over process-local blocks: n_kv summed over the
    ranks each sweep holds every token of the corpus once, the ranks
    agree bitwise on tables, objectives, held-out perplexity and lambda,
    and the objectives are finite."""
    base = dict(number_of_topics=5, doc_pad_multiple=4, seed=0,
                bucket_sizes=[32, 64], number_of_samples=2, burn_in_sweeps=1)
    gib = run_ranks("engine", dict(
        corpus_dir=denews_dir, process_local=True, iterations=2,
        cfg={**base, "inference_mode": "gibbs"}), tmp_path)
    hyb = run_ranks("engine", dict(
        corpus_dir=denews_dir, process_local=True, iterations=2,
        cfg={**base, "inference_mode": "hybrid"}), tmp_path)
    train, _, _ = jax_load(denews_dir)
    assert gib[0]["tokens"] == train.num_tokens
    assert gib[0]["n_kv"].sum() == train.num_tokens
    _same(gib, ("n_kv", "objs", "perplexity", "gamma"))
    _same(hyb, ("lam", "objs", "perplexity"))
    assert np.isfinite(gib[0]["objs"]).all()
    assert np.isfinite(hyb[0]["objs"]).all()


# -- SVI ----------------------------------------------------------------------------------


def _jax_svi_emulation(corpus_dir, cfg, n_epochs=2, P=2, caps=None):
    """The JAX test's in-process emulation of a 2-host process-local SVI
    run: the per-host permutations, each host's minibatch slice (a dense
    block, or ragged buckets in ``caps``) concatenated in host order,
    through the JAX engine's unsharded epoch scan.  Returns (per-epoch
    mean estimates, lambda, final-epoch gamma)."""
    train, test, vocab = jax_load(corpus_dir)
    total = train.num_docs
    per = -(-total // P)
    b_local = -(-cfg["batch_size"] // P)
    n_batches = -(-per // b_local)
    counts = [max(0, min(per, total - p * per)) for p in range(P)]
    jcfg = JaxConfig(**{**cfg, "bucket_sizes": tuple(cfg.get(
        "bucket_sizes", JaxConfig().bucket_sizes))})
    eng = JaxSVI(jcfg)
    eng.initialize(train, vocab, lam_init=_lam0(jcfg.number_of_topics,
                                                len(vocab)))
    st, t, ests_all, gamma = eng.state, 0, [], None
    for epoch in range(n_epochs):
        key, sub = jax.random.split(st.key)
        seed = epoch * 100003 + jcfg.seed
        perms = [np.random.default_rng((seed, p)).permutation(counts[p])
                 for p in range(P)]
        lists, rhos, scales = [], [], []
        for i in range(n_batches):
            hosts = []
            for p in range(P):
                sel = perms[p][i * b_local:(i + 1) * b_local] + p * per
                hosts.append(
                    [train.to_dense(doc_indices=sel, pad_docs_to=b_local)]
                    if caps is None else train.to_ragged_buckets(
                        bucket_sizes=sorted(caps),
                        doc_pad_multiple=jcfg.doc_pad_multiple,
                        doc_indices=sel, bucket_capacities=caps))
            lists.append([type(bs[0])(**{
                f: np.concatenate([np.asarray(getattr(b, f)) for b in bs])
                for f in type(bs[0]).__dataclass_fields__})
                for bs in zip(*hosts)])
            docs_in = sum(min(b_local, max(0, c - i * b_local))
                          for c in counts)
            scales.append(total / max(1, docs_in))
            rhos.append((jcfg.tau0 + t) ** (-jcfg.kappa))
            t += 1
        stacked = jax.tree.map(lambda *xs: np.stack([np.asarray(x)
                                                     for x in xs]), *lists)
        stacked = [jax.device_put(b) for b in stacked]
        lam, ests, _elog, gammas = eng._jit_epoch_scan(
            st.lam, st.alpha, st.eta, sub, stacked, None,
            np.asarray(rhos, np.float32), np.asarray(scales, np.float32))
        ests_all.append(float(np.mean(np.asarray(ests, np.float64))))
        st = st._replace(lam=lam, key=key)
        gamma = jax_layouts.assemble_gamma(
            [np.asarray(b.doc_ids[i]) for i in range(n_batches)
             for b in stacked],
            [np.asarray(g[i]) for i in range(n_batches) for g in gammas],
            total, np.asarray(st.alpha))
    return ests_all, np.asarray(st.lam, np.float64), gamma


def _hold_svi(ranks, ref):
    _same(ranks, ("lam", "objs", "gamma"))
    ests, lam, gamma = ref
    for a, b in zip(ranks[0]["objs"], ests):
        assert _rel(a, b) < ELBO_REL, (ranks[0]["objs"], ests)
    assert _rel(ranks[0]["lam"].astype(np.float64).sum(), lam.sum()) < LAM_REL
    assert _rel(ranks[0]["gamma"].sum(), gamma.sum()) < GAMMA_REL


def test_two_process_svi_matches_emulated_reference(tmp_path, denews_dir):
    """Process-local SVI on the dense layout (each rank its block,
    b_local = 16 documents a minibatch in the per-host order)."""
    cfg = dict(SVI, number_of_topics=5)
    ranks = run_ranks("engine", dict(corpus_dir=denews_dir, cfg=cfg,
                                     process_local=True, lam_seed=LAM_SEED,
                                     iterations=2), tmp_path)
    assert ranks[0]["reduces"].tolist() == [8, 8]  # 4 minibatches, 2 each
    _hold_svi(ranks, _jax_svi_emulation(denews_dir, cfg))


@pytest.mark.parametrize("sstats_mode", ["scatter", "auto"])
def test_two_process_svi_ragged_matches_emulated_reference(
        tmp_path, sstats_mode):
    """Process-local SVI on the ragged layout (BASELINE config 5's shape):
    the negotiated geometry, then the row scatter (the JAX engine's
    process-local route; the JAX test's corpus with a chunked document)
    or each rank's dense sufficient statistics (the port's default; a
    corpus without chunked documents, where the per-row and per-document
    bounds agree)."""
    corpus_dir = write_text_corpus(str(tmp_path / "c"),
                                   oversized=(sstats_mode == "scatter"))
    cfg = dict(SVI, number_of_topics=5, bucket_sizes=[64, 128],
               sstats_mode=sstats_mode)
    ranks = run_ranks("engine", dict(corpus_dir=corpus_dir, cfg=cfg,
                                     process_local=True, lam_seed=LAM_SEED,
                                     iterations=2), tmp_path)
    caps = {int(w): int(c) for w, c in ranks[0]["geometry"]}
    _same(ranks, ("geometry",))
    _hold_svi(ranks, _jax_svi_emulation(corpus_dir, cfg, caps=caps))


def test_two_process_svi_streaming_matches_memory(tmp_path, ragged_dir):
    """Process-local SVI from each rank's disk-backed block (its own
    sidecar) is bitwise the in-memory process-local run."""
    cfg = dict(SVI, number_of_topics=5, bucket_sizes=[64, 128])
    spec = dict(corpus_dir=ragged_dir, cfg=cfg, process_local=True,
                lam_seed=LAM_SEED, iterations=2)
    mem = run_ranks("engine", spec, tmp_path)
    stream = run_ranks("engine", {**spec, "streaming": True}, tmp_path)
    for k in ("lam", "objs", "gamma", "geometry"):
        np.testing.assert_array_equal(mem[0][k], stream[0][k], err_msg=k)
    assert len(glob.glob(os.path.join(ragged_dir,
                                      "doc.dat.rowcache.v2.*"))) == 2


def _jax_negotiated(blocks, cfg, b_local, monkeypatch):
    """JAX's ``negotiate_svi_ragged_geometry`` on each block, the blocks'
    calls run in threads whose ``process_allgather`` meet at a barrier
    (the gather of a 2-host run, emulated in one process)."""
    from jax.experimental import multihost_utils

    P = len(blocks)
    barrier = threading.Barrier(P, timeout=60)
    slots, local = {}, threading.local()

    def gather(x):
        slots[(local.rank, local.calls)] = np.asarray(x)
        barrier.wait()
        out = np.stack([slots[(p, local.calls)] for p in range(P)])
        barrier.wait()
        local.calls += 1
        return out

    monkeypatch.setattr(multihost_utils, "process_allgather", gather)
    monkeypatch.setattr(jax, "process_count", lambda: P)
    out = [None] * P

    def run(r):
        local.rank, local.calls = r, 0
        out[r] = jax_mesh.negotiate_svi_ragged_geometry(blocks[r], cfg,
                                                        b_local)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(P)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    return out


@pytest.mark.parametrize("policy", ["auto", "fixed"])
def test_negotiated_geometry_matches_jax(tmp_path, ragged_dir, monkeypatch,
                                        policy):
    """The capacities both ranks negotiate (widths from the summed
    histograms under "auto" with the default bucket sizes, else the
    configured ones; capacities from the largest expected rows) equal
    JAX's function on the same blocks."""
    cfg = dict(SVI, number_of_topics=5, bucket_policy=policy)
    if policy == "fixed":
        cfg["bucket_sizes"] = [64, 128]
    ranks = run_ranks("engine", dict(corpus_dir=ragged_dir, cfg=cfg,
                                     process_local=True, iterations=0),
                      tmp_path)
    _same(ranks, ("geometry",))
    blocks = [jax_load(ragged_dir, process_index=p, process_count=2)[0]
              for p in range(2)]
    jcfg = JaxConfig(**{**cfg, "bucket_sizes": tuple(cfg.get(
        "bucket_sizes", JaxConfig().bucket_sizes))})
    want = _jax_negotiated(blocks, jcfg, 16, monkeypatch)
    assert want[0] == want[1]
    assert {int(w): int(c) for w, c in ranks[0]["geometry"]} == want[0]


# -- the group's timeout -------------------------------------------------------------------


def test_hung_collective_fails_within_timeout(tmp_path):
    """A collective one rank never joins fails on the other when the
    group's timeout (here 5 s) runs out, instead of hanging the run."""
    r0, _ = run_ranks("hang", dict(collective_timeout=5, sleep=8), tmp_path,
                      limit=60)
    assert str(r0["error"]), r0
    assert 4 <= float(r0["waited"]) < 30, r0


# -- the train CLI across processes ---------------------------------------------------------


def _cli(corpus_dir, out, *extra, env=None):
    return subprocess.Popen(
        [sys.executable, "-m", "pylda_tpu_torch.cli.train",
         f"--input_directory={corpus_dir}", f"--output_directory={out}",
         "--number_of_topics=5", "--training_iterations=4",
         "--snapshot_interval=2", "--device=cpu", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=env or rank_env())


def _models(out, n):
    return sorted(glob.glob(os.path.join(str(out), "*", "*", f"model-{n}")))


def test_cli_process_flags(tmp_path, denews_dir):
    """Two CLI processes with --coordinator_address/--num_processes/
    --process_id, --process_sharded_input and --mesh 2,1: rank 0 writes
    one run directory whose model-4 the JAX package loads, with lambda
    within 1e-3 (norm-relative) of the one-process CLI's."""
    port = free_port()
    flags = [f"--coordinator_address=127.0.0.1:{port}", "--num_processes=2",
             "--process_sharded_input", "--mesh=2,1", "--dump_gamma"]
    outs = wait_all([_cli(denews_dir, tmp_path / "dist", *flags,
                       f"--process_id={r}") for r in range(2)])
    wait_all([_cli(denews_dir, tmp_path / "one")])
    assert "backend=gloo" in outs[0] and "processes=2" in outs[0]
    assert "iteration=" not in outs[1]  # rank 1 logs nothing
    (dist_model,), (one_model,) = (_models(tmp_path / x, 4)
                                   for x in ("dist", "one"))
    theirs = JaxInferencer.load(dist_model)
    ours = Inferencer.load(one_model, device="cpu")
    assert norm_rel(np.asarray(theirs.state.lam),
                    ours.state.lam.numpy()) < 1e-3
    run = os.path.dirname(dist_model)
    assert np.loadtxt(os.path.join(run, "gamma-4")).shape == (120, 5)
    assert os.path.exists(os.path.join(run, "exp_beta-2"))


def test_cli_torchrun_environment(tmp_path, denews_dir):
    """torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK join the
    group without process flags: disk-backed process-local SVI across two
    ranks writes one run, the same model as in-memory input."""
    port = str(free_port())
    procs = []
    for r in range(2):
        env = dict(rank_env(), MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   WORLD_SIZE="2", RANK=str(r))
        procs.append(_cli(denews_dir, tmp_path / "stream",
                          "--inference_mode=svi", "--batch_size=32",
                          "--process_sharded_input", "--mesh=2,1",
                          "--streaming_input", env=env))
    outs = wait_all(procs)
    assert "processes=2" in outs[0]
    port = str(free_port())
    procs = []
    for r in range(2):
        env = dict(rank_env(), MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   WORLD_SIZE="2", RANK=str(r))
        procs.append(_cli(denews_dir, tmp_path / "mem",
                          "--inference_mode=svi", "--batch_size=32",
                          "--process_sharded_input", "--mesh=2,1", env=env))
    wait_all(procs)
    (a,), (b,) = (_models(tmp_path / x, 4) for x in ("stream", "mem"))
    np.testing.assert_array_equal(np.load(a)["lam"], np.load(b)["lam"])


@pytest.mark.parametrize("mode", ["vb", "gibbs"])
def test_model_files_across_world_sizes(tmp_path, denews_dir, mode):
    """A model saved by two ranks holds the replicated state and, for
    Gibbs, every rank's chains gathered bucket by bucket: it loads in one
    process (this package and the JAX package), with the ranks'
    perplexity; resumed over two ranks, the chains are adopted."""
    cfg = dict(number_of_topics=5, doc_pad_multiple=4, seed=0,
               bucket_sizes=[32, 64], inference_mode=mode)
    path = str(tmp_path / "model-2")
    ranks = run_ranks("engine", dict(corpus_dir=denews_dir, cfg=cfg,
                                     process_local=True, iterations=2,
                                     save=path), tmp_path)
    train, test, vocab = jax_load(denews_dir)
    theirs = JaxInferencer.load(path)
    ours = Inferencer.load(path, device="cpu")
    np.testing.assert_array_equal(np.asarray(theirs.state.lam),
                                  ranks[0]["lam"])
    from pylda_tpu_torch.corpus.datasets import load_input_directory

    test_t = load_input_directory(denews_dir)[1]
    if mode == "vb":
        assert ours.perplexity(test_t) == float(ranks[0]["perplexity"])
        return
    blobs = np.load(path)
    np.testing.assert_array_equal(blobs["extra_n_kv"], ranks[0]["n_kv"])
    # Each bucket's n_dk holds both ranks' rows: every token once.
    assert sum(blobs[k].sum() for k in blobs.files
               if k.startswith("extra_ndk_")) == train.num_tokens
    resumed = run_ranks("resume", dict(corpus_dir=denews_dir,
                                       process_local=True, path=path),
                        tmp_path)
    for r in resumed:
        assert r["adopted"], r
        np.testing.assert_array_equal(r["n_kv"], ranks[0]["n_kv"])


def test_one_process_model_resumes_over_two_ranks(tmp_path, denews_dir):
    """Elastic resume: a model saved by one process continues over two
    ranks (the state is replicated), as the one process continues it
    (stall exit off: STALL_OFF)."""
    from pylda_tpu_torch.corpus.datasets import load_input_directory
    from pylda_tpu_torch.models import VariationalBayes
    from pylda_tpu_torch.utils.config import LDAConfig

    cfg = LDAConfig(number_of_topics=5, doc_pad_multiple=4, seed=0,
                    estep_stall_patience=STALL_OFF)
    train, _, vocab = load_input_directory(denews_dir)
    one = VariationalBayes(cfg, device="cpu")
    one.initialize(train, vocab)
    one.learning()
    path = str(tmp_path / "model-1")
    one.save(path)
    want = one.learning()
    ranks = run_ranks("resume", dict(corpus_dir=denews_dir,
                                     process_local=True, path=path),
                      tmp_path)
    _same(ranks, ("obj", "lam"))
    assert int(ranks[0]["step"]) == 2
    assert _rel(ranks[0]["obj"], want) < 1e-5
    assert norm_rel(ranks[0]["lam"], one.state.lam.numpy()) < 1e-5
