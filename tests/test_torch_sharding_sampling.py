"""Gibbs and hybrid under a model axis above 1 (``--mesh D,M`` with M > 1,
``--shard_vocab`` / ``--shard_topics`` or neither) in the port, on the
CPU, ranks in processes (``tests/torch_dist.py``).

The JAX package runs both engines on any (D, M) mesh, and there a model
axis moves the tables, never the numbers.  The port keeps each rank's
block of n_kv (Gibbs) and lambda, gathers the whole table once a step
before it samples, and counts into its block only; the ranks of a model
group draw the same streams.  So it is held

- bit for bit to the port's one-process engine at (1, 2) under each flag
  and neither (Gibbs: n_kv, z, n_dk, the likelihoods, alpha and beta with
  the slice sampler every sweep; hybrid: lambda, alpha, eta, the chains
  and the ELBOs, with Newton every iteration: the topic side of the bound
  and the Newton eta input are computed from the gathered lambda);
- bit for bit to the (2, 1) run at (2, 2) (the data group sums exact
  integers, doc terms counted once), each block bitwise across its data
  group and the blocks tiling (K, V);
- to the JAX engine at ``make_mesh(shape=(4, 2))`` with the flag, from its
  state and chains: the joint likelihood within rel 1e-6, and hybrid's
  held-out perplexity after free-running iterations within 0.1
  (tests/test_torch_mesh.py's band);

and its model files, its CLI in two processes, its collective counts a
step and its ``phase_timings`` all-gather row are checked.
"""

import functools
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pylda_tpu_torch.corpus.datasets import make_denews_tiny
from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.ops.sampling import count_table, sample_doc_topics, stream
from pylda_tpu_torch.parallel import mesh as pmesh

import torch_dist_worker as worker
from torch_dist import free_port, rank_env, run_ranks, wait_all

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, V = 4, 128
CORPUS = dict(num_docs=64, num_topics=K, num_types=V, mean_doc_length=30,
              seed=5)
TEST = dict(num_docs=16, num_topics=K, num_types=V, mean_doc_length=30,
            seed=6)
# tests/test_sharding.py's settings; short buckets, so documents chunk
# over rows; the slice sampler or Newton every step.
BASE = dict(number_of_topics=K, alpha_alpha=0.2, alpha_beta=0.02,
            doc_pad_multiple=8, seed=0, bucket_sizes=(32, 64),
            number_of_samples=2, burn_in_sweeps=1,
            hyper_parameter_optimize_interval=1)
MODES = {"gibbs": dict(inference_mode="gibbs"),
         "hybrid": dict(inference_mode="hybrid", hybrid_persistent_z=True)}
FLAGS = {"vocab": {"shard_vocab": True}, "topics": {"shard_topics": True},
         "replicas": {}}
ITERATIONS = 3
# The JAX engine's likelihood on identical tables; the held-out
# perplexity band.
JAX_LL_REL, JAX_PP_BAND = 1e-6, 0.1
# Free-running steps after the JAX engine's state is adopted.
FREE_STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def cfg(mode: str, flag: str = "replicas") -> dict:
    return {**BASE, **MODES[mode], **FLAGS[flag]}


def corpora():
    train, beta, _ = synthetic_corpus(**CORPUS)
    return train, synthetic_corpus(beta=beta, **TEST)[0]


def one_process(run: dict, iterations: int = ITERATIONS) -> dict:
    """The port's one-process run of ``run`` in this process (one thread,
    as a rank runs): ``torch_dist_worker.sampling_run`` without a mesh."""
    train, test = corpora()
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return worker.sampling_run(run, {"iterations": iterations}, train,
                                   test, train.vocab, None)
    finally:
        torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def reference(mode: str) -> dict:
    return one_process({"cfg": cfg(mode)})


def results(ranks, i: int) -> list:
    """Run ``i``'s results on each rank, the prefix taken off."""
    p = f"r{i}_"
    return [{k[len(p):]: v for k, v in r.items() if k.startswith(p)}
            for r in ranks]


def assert_same(got: dict, want: dict, keys) -> None:
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def chain_keys(res: dict) -> list:
    return sorted(k for k in res if k.split("_")[0] in ("z", "ndk", "zh")
                  and k.split("_")[-1].isdigit())


# -- the JAX engine at (4, 2) -------------------------------------------------


# The JAX engine's runs: Gibbs under ``shard_vocab``, hybrid under
# ``shard_topics`` (a flag moves the JAX engine's tables, not its numbers).
JAX_FLAG = {"gibbs": "vocab", "hybrid": "topics"}
JAX_STEPS = 2
JAX_LIMIT = 300  # seconds


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX engine of each mode at ``make_mesh(shape=(4, 2))`` with
    its JAX_FLAG (``tests/torch_dist_jax.py``, a process of its own):
    JAX_STEPS steps, then its model file and an npz of its state, n_kv and
    chains (whole); its joint likelihood there (Gibbs), and after
    FREE_STEPS more steps its held-out perplexity."""
    d = tmp_path_factory.mktemp("jax")
    spec = dict(corpus=CORPUS, test=TEST, runs=[
        dict(name=mode, cfg=cfg(mode, JAX_FLAG[mode]), steps=JAX_STEPS,
             free_steps=FREE_STEPS) for mode in MODES])
    subprocess.run([sys.executable, os.path.join(REPO, "tests",
                                                 "torch_dist_jax.py"),
                    str(d), json.dumps(spec)], check=True, cwd=REPO,
                   env=rank_env(), timeout=JAX_LIMIT,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    with open(d / "results.json") as f:
        res = json.load(f)
    return {mode: {**res[mode], "model": str(d / f"model-{mode}"),
                   "chains": str(d / f"{mode}.npz")} for mode in MODES}


# -- the ranks ------------------------------------------------------------------


def _runs_1x2(jax_runs, save_dir):
    """The (1, 2) runs: each mode under each flag and neither (the first
    of each mode saves its model file), from the JAX engine's state and
    chains, and resuming its model file."""
    runs, index = [], {}
    for mode in MODES:
        for flag in FLAGS:
            index[("run", mode, flag)] = len(runs)
            run = {"cfg": cfg(mode, flag)}
            if flag == "vocab":
                run["save"] = str(save_dir / f"model-{mode}")
            runs.append(run)
        j = jax_runs[mode]
        for flag in ("vocab", "topics"):
            index[("chains", mode, flag)] = len(runs)
            runs.append({"cfg": cfg(mode, flag), "chains": j["chains"],
                         "iterations": FREE_STEPS})
        index[("load", mode)] = len(runs)
        runs.append({"load": j["model"]})
    return runs, index


@pytest.fixture(scope="module")
def ranks_1x2(jax_runs, tmp_path_factory):
    d = tmp_path_factory.mktemp("r12")
    runs, index = _runs_1x2(jax_runs, d)
    spec = dict(corpus=CORPUS, test=TEST, mesh_shape=[1, 2], runs=runs,
                iterations=ITERATIONS)
    ranks = run_ranks("sampling", spec, d, world=2)
    return ranks, index, runs


@pytest.fixture(scope="module")
def ranks_2x2_and_2x1(tmp_path_factory):
    """Each mode under each flag at (2, 2), and each mode at (2, 1)."""
    d = tmp_path_factory.mktemp("r22")
    runs = [{"cfg": cfg(m, f)} for m in MODES for f in ("vocab", "topics")]
    r22 = run_ranks("sampling", dict(corpus=CORPUS, test=TEST,
                                     mesh_shape=[2, 2], runs=runs,
                                     iterations=ITERATIONS), d, world=4)
    r21 = run_ranks("sampling", dict(corpus=CORPUS, test=TEST,
                                     mesh_shape=[2, 1],
                                     runs=[{"cfg": cfg(m)} for m in MODES],
                                     iterations=ITERATIONS), d, world=2)
    return r22, r21


def _hold_across_ranks(per_rank: list) -> None:
    """Every rank's whole tables, objectives and gathered chains are the
    same bits."""
    for r in per_rank[1:]:
        keys = ["objs", "lam", "alpha", "eta", "gamma", "twd"] + [
            k for k in ("n_kv", "perplexity") if k in r] + chain_keys(r)
        assert_same(r, per_rank[0], keys)


# -- (1, 2) against one process ---------------------------------------------------


@pytest.mark.parametrize("flag", list(FLAGS))
def test_gibbs_1x2_is_one_process(ranks_1x2, flag):
    """Gibbs at (1, 2), the slice sampler every sweep: the gathered n_kv,
    z, n_dk, every likelihood, alpha and beta, gamma and the held-out
    perplexity bit for bit the one-process engine's; each rank holds its
    block of n_kv and lambda (whole with neither flag)."""
    ranks, index, _ = ranks_1x2
    per_rank = results(ranks, index[("run", "gibbs", flag)])
    _hold_across_ranks(per_rank)
    got, want = per_rank[0], reference("gibbs")
    assert_same(got, want, ["objs", "n_kv", "lam", "alpha", "eta", "gamma",
                            "twd", "perplexity", "point_perplexity"]
                + chain_keys(want))
    assert chain_keys(got) == chain_keys(want)
    assert got["n_kv"].sum() == synthetic_corpus(**CORPUS)[0].num_tokens
    for m, r in enumerate(per_rank):
        lo, hi = pmesh.block_bounds(V if flag == "vocab" else K, m, 2)
        want_block = {"vocab": (K, hi - lo), "topics": (hi - lo, V),
                      "replicas": (K, V)}[flag]
        assert tuple(r["n_kv_block"]) == tuple(r["block"]) == want_block


@pytest.mark.parametrize("flag", list(FLAGS))
def test_hybrid_1x2_is_one_process(ranks_1x2, flag):
    """Hybrid at (1, 2) with persistent chains and Newton every
    iteration: the ELBOs, the gathered lambda, alpha, eta, the chains,
    gamma and the held-out perplexity bit for bit the one-process
    engine's; each rank holds its block of lambda (whole with neither
    flag)."""
    ranks, index, _ = ranks_1x2
    per_rank = results(ranks, index[("run", "hybrid", flag)])
    _hold_across_ranks(per_rank)
    got, want = per_rank[0], reference("hybrid")
    assert_same(got, want, ["objs", "lam", "alpha", "eta", "gamma", "twd",
                            "perplexity", "point_perplexity"]
                + chain_keys(want))
    assert chain_keys(got) == chain_keys(want) != []
    for m, r in enumerate(per_rank):
        lo, hi = pmesh.block_bounds(V if flag == "vocab" else K, m, 2)
        assert tuple(r["block"]) == {"vocab": (K, hi - lo),
                                     "topics": (hi - lo, V),
                                     "replicas": (K, V)}[flag]


# -- (2, 2) against (2, 1) ------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("flag", ["vocab", "topics"])
def test_2x2_is_2x1(ranks_2x2_and_2x1, mode, flag):
    """At (2, 2) both groups hold two ranks: each data coordinate draws
    the (2, 1) run's streams, the blocks sum over the data group (exact
    integers) and the doc-level terms count once, so the tables, chains
    and objectives are the (2, 1) run's bits; every rank agrees, the
    blocks bitwise across their data groups (checked after each step in
    the ranks); Σ n_kv = tokens."""
    r22, r21 = ranks_2x2_and_2x1
    i = list(MODES).index(mode) * 2 + ["vocab", "topics"].index(flag)
    per_rank = results(r22, i)
    _hold_across_ranks(per_rank)
    got, want = per_rank[0], results(r21, list(MODES).index(mode))[0]
    keys = ["objs", "lam", "alpha", "eta", "gamma", "perplexity"]
    if mode == "gibbs":
        keys.append("n_kv")
        assert got["n_kv"].sum() == synthetic_corpus(**CORPUS)[0].num_tokens
    assert_same(got, want, keys + chain_keys(want))
    assert chain_keys(got) == chain_keys(want) != []


# -- against the JAX engine at (4, 2) ------------------------------------------------


@pytest.mark.parametrize("flag", ["vocab", "topics"])
def test_gibbs_likelihood_on_jax_tables(ranks_1x2, jax_runs, flag):
    """The port at (1, 2) under the flag from the JAX engine's state, n_kv
    and chains (its (4, 2) run): the joint likelihood, at its alpha and
    beta and at scalars, within rel 1e-6 of the JAX engine's."""
    ranks, index, _ = ranks_1x2
    j = jax_runs["gibbs"]
    for r in results(ranks, index[("chains", "gibbs", flag)]):
        assert float(r["ll0"]) == pytest.approx(j["ll0"], rel=JAX_LL_REL)
        assert float(r["ll0_scalars"]) == pytest.approx(j["ll0_scalars"],
                                                        rel=JAX_LL_REL)


@pytest.mark.parametrize("flag", ["vocab", "topics"])
def test_hybrid_perplexity_near_jax(ranks_1x2, jax_runs, flag):
    """Hybrid at (1, 2) under the flag from the JAX engine's state and
    chains (its (4, 2) run), then FREE_STEPS iterations on each package's
    own streams: held-out perplexity within JAX_PP_BAND (relative) of the
    JAX engine's."""
    ranks, index, _ = ranks_1x2
    j = jax_runs["hybrid"]
    r = results(ranks, index[("chains", "hybrid", flag)])[0]
    assert len(r["objs"]) == FREE_STEPS
    assert abs(float(r["perplexity"]) - j["perplexity"]) / j[
        "perplexity"] < JAX_PP_BAND


# -- model files ------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
def test_model_file_is_the_one_process_format(ranks_1x2, tmp_path, mode):
    """A model file saved at (1, 2) under ``shard_vocab`` (rank 0 writes)
    holds the one-process file's keys and arrays bit for bit: lambda and
    n_kv whole, every chain."""
    ranks, _, runs = ranks_1x2
    got_path = next(r["save"] for r in runs
                    if r.get("save", "").endswith(f"model-{mode}"))
    want_path = str(tmp_path / f"model-{mode}")
    one_process({"cfg": cfg(mode), "save": want_path})
    with np.load(got_path) as got, np.load(want_path) as want:
        assert set(got.files) == set(want.files)
        assert any(k.startswith("extra_z") for k in got.files)
        for k in got.files:
            if k != "meta_json":
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        meta = json.loads(bytes(got["meta_json"]).decode())
        assert meta["config"]["shard_vocab"] is True
        assert got["lam"].shape == (K, V)
        if mode == "gibbs":
            assert got["extra_n_kv"].shape == (K, V)


@pytest.mark.parametrize("mode", list(MODES))
def test_jax_model_file_resumes_at_1x2(ranks_1x2, jax_runs, mode):
    """The JAX engine's model file (its (4, 2) run under its JAX_FLAG:
    Gibbs with n_kv and z_<i>, hybrid with zh_<i>) resumes at (1, 2)
    under that flag with the one-process port's numbers bit for bit
    (ITERATIONS more steps)."""
    ranks, index, _ = ranks_1x2
    per_rank = results(ranks, index[("load", mode)])
    _hold_across_ranks(per_rank)
    got = per_rank[0]
    assert int(got["block"][0 if JAX_FLAG[mode] == "topics" else 1]) == (
        K if JAX_FLAG[mode] == "topics" else V) // 2
    want = one_process({"load": jax_runs[mode]["model"]})
    keys = ["objs", "lam", "alpha", "eta", "gamma", "perplexity", "step"]
    keys += ["n_kv"] if mode == "gibbs" else []
    assert_same(got, want, keys + chain_keys(want))
    assert int(got["step"]) == JAX_STEPS + ITERATIONS


# -- collectives and phase timings ----------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("flag", list(FLAGS))
def test_collectives_a_step(ranks_1x2, mode, flag):
    """Each step's collectives at (1, 2): Gibbs all-reduces its block and
    the doc side over the data group, one more for each likelihood the
    slice sampler evaluates, and gathers n_kv once under a flag; hybrid
    all-reduces the sufficient statistics and the doc-level terms over
    the data group and gathers lambda once a step under a flag (twice in
    the first, whose Newton step gathers the new lambda the next step
    then reads)."""
    ranks, index, _ = ranks_1x2
    for r in results(ranks, index[("run", mode, flag)]):
        for i, (reduces, gathers, likelihoods) in enumerate(r["steps"]):
            shard = flag != "replicas"
            if mode == "gibbs":
                assert likelihoods > 0
                assert reduces == 2 + likelihoods
                assert gathers == int(shard)
            else:
                assert reduces == 2
                assert gathers == (int(shard) * (2 if i == 0 else 1))


@pytest.mark.parametrize("mode", list(MODES))
def test_phase_timings_allgather_row(tmp_path, mode):
    """phase_timings under ``shard_vocab`` at (1, 2): the all-gather of
    the step's table (Gibbs n_kv's block, hybrid lambda's: the bytes a
    rank receives, K x V/2 float32) and the all-reduce of the block over
    the data group; the roofline prints the gather over gloo with "no
    bound"; the timing leaves the state as it was."""
    spec = dict(corpus=CORPUS, test=TEST, mesh_shape=[1, 2], iterations=1,
                runs=[{"cfg": cfg(mode, "vocab"), "timings": True}])
    for res in results(run_ranks("sampling", spec, tmp_path, world=2), 0):
        times = json.loads(str(res["timings"]))
        assert times["allgather_bytes"] == K * (V // 2) * 4
        assert times["allreduce_bytes"] == K * (V // 2) * 4
        assert times["allgather_ms"] > 0 and times["allreduce_ms"] > 0
        assert times["allreduce_backend"] == "gloo"
        row = json.loads(str(res["roofline"]))["allgather"]
        assert row["bound"] == "no bound" and row["bound_ms"] is None
        assert row["bytes"] == K * (V // 2) * 4


# -- the count table's blocks ------------------------------------------------------------


@pytest.mark.parametrize("topic_range, vocab_range", [
    (None, (0, 64)), (None, (64, 128)), ((0, 2), None), ((2, 4), None),
    ((1, 3), (17, 90)), ((0, K), (0, V))])
def test_count_table_block_is_the_whole_tables_entries(topic_range,
                                                       vocab_range):
    """``count_table`` over a topic or vocabulary range: the whole
    table's block bit for bit (the full ranges: the whole table), and
    ``sample_doc_topics``'s sstats over the range the whole call's block
    from the same stream."""
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, V, (12, 20), generator=g)
    mask = (torch.rand(12, 20, generator=g) > 0.3).float()
    z = torch.randint(0, K, (12, 20), generator=g, dtype=torch.int32)
    whole = count_table(tokens, mask, z, K, V)
    (k0, k1), (v0, v1) = topic_range or (0, K), vocab_range or (0, V)
    got = count_table(tokens, mask, z, K, V, topic_range, vocab_range)
    assert torch.equal(got, whole[k0:k1, v0:v1])
    log_tw = torch.log(torch.rand(K, V, generator=g))
    alpha = torch.full((K,), 0.2)
    kw = dict(num_types=V, burn_in=1, num_samples=2)
    full = sample_doc_topics(tokens, mask, log_tw, alpha, z,
                             stream("cpu", 0, 1), **kw)
    block = sample_doc_topics(tokens, mask, log_tw, alpha, z,
                              stream("cpu", 0, 1), topic_range=topic_range,
                              vocab_range=vocab_range, **kw)
    assert torch.equal(block[1], full[1][k0:k1, v0:v1])
    for a, b in zip((block[0], block[2], block[3]),
                    (full[0], full[2], full[3])):
        assert torch.equal(a, b)


# -- the CLI ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def denews_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("denews"))
    make_denews_tiny(d, num_train=120, num_test=30, mean_doc_length=25)
    return d


def _cli(corpus_dir, out, mode, *extra):
    return subprocess.Popen(
        [sys.executable, "-m", "pylda_tpu_torch.cli.train",
         f"--input_directory={corpus_dir}", f"--output_directory={out}",
         "--number_of_topics=5", "--training_iterations=3",
         "--snapshot_interval=3", f"--inference_mode={mode}",
         "--number_of_samples=2", "--burn_in_sweeps=1",
         "--hyper_parameter_optimize_interval=1", "--device=cpu", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=rank_env())


@pytest.mark.parametrize("mode", list(MODES))
def test_cli_mesh_1x2_writes_the_one_process_model(tmp_path, denews_dir,
                                                   mode):
    """The train CLI in two processes with ``--mesh 1,2`` and each flag
    (``--process_sharded_input``: both ranks read the one data
    coordinate's block, the whole corpus), beside the one-process CLI,
    all five processes at once: each model-3 is the one-process model
    file's arrays bit for bit."""
    extra = ["--hybrid_persistent_z"] if mode == "hybrid" else []
    procs = {}
    for flag in ("vocab", "topics"):
        port = free_port()
        procs[flag] = [_cli(
            denews_dir, tmp_path / flag, mode, *extra,
            f"--coordinator_address=127.0.0.1:{port}", "--num_processes=2",
            f"--process_id={r}", "--process_sharded_input", "--mesh=1,2",
            f"--shard_{flag}") for r in range(2)]
    procs["one"] = [_cli(denews_dir, tmp_path / "one", mode, *extra)]
    outs = dict(zip(procs, (wait_all(p) for p in procs.values())))
    assert "processes=2" in outs["vocab"][0]
    (one,) = glob.glob(str(tmp_path / "one" / "*" / "*" / "model-3"))
    with np.load(one) as want:
        want = {k: want[k] for k in want.files if k != "meta_json"}
    assert any(k.startswith("extra_z") for k in want)
    for flag in ("vocab", "topics"):
        (path,) = glob.glob(str(tmp_path / flag / "*" / "*" / "model-3"))
        with np.load(path) as got:
            assert set(got.files) - {"meta_json"} == set(want)
            for k, v in want.items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)
