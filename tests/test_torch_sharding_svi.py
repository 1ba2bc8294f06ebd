"""Lambda split over the mesh's model axis in the port: SVI, model files
and the CLIs on the CPU, ranks in processes.

Mirrors tests/test_sharding.py:188 (SVI with ``shard_vocab`` at shipping
defaults: estimates rel 1e-3, lambda rtol 5e-3 atol 1e-5) and :211 (at
pinned sweeps: estimates rel 1e-4, lambda rtol 2e-4) against the JAX
engine's unsharded run, on gloo ranks of the port at meshes (1, 2) and
(2, 2), with ``shard_topics`` too and on each route; at pinned sweeps also
against the port's one-process run within 1e-5.  Model files written by a
sharded run are the one-process format (each package loads them whole);
a JAX model file resumes on a (1, 2) mesh and scores held-out documents
within rel 1e-4 of the JAX engine.  The train CLI runs in two processes
with ``--mesh 1,2`` and each flag, and its model file is held to the
one-process CLI's and read by the test and infer CLIs and the JAX
package.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pylda_tpu.corpus.synthetic import synthetic_corpus as jax_synthetic
from pylda_tpu.models import Inferencer as JaxInferencer
from pylda_tpu.models import VariationalBayes as JaxVB
from pylda_tpu.utils.config import LDAConfig as JaxConfig
from pylda_tpu_torch.cli.infer import main as infer_main
from pylda_tpu_torch.cli.test import main as run_test_cli
from pylda_tpu_torch.corpus.datasets import make_denews_tiny
from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.models import Inferencer

from test_torch_sharding import (BASE, CORPUS, LAM_SEED, PINNED, ROUTES,
                                 TEST, _elbo_rel, flag, jax_run, lam_init,
                                 port_run, run_sharded)
from torch_dist import free_port, norm_rel, rank_env, run_ranks, wait_all

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SVI = dict(inference_mode="svi", batch_size=16, tau0=16.0, kappa=0.7)
SVI_ITERATIONS = 3  # tests/test_sharding.py's _run_svi
# :188's bars at defaults, :211's at pinned sweeps, and one process's.
DEFAULT_EST, DEFAULT_LAM_RTOL, DEFAULT_LAM_ATOL = 1e-3, 5e-3, 1e-5
PINNED_EST, PINNED_LAM_RTOL, ONE_REL = 1e-4, 2e-4, 1e-5
CLI_REL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


_SVI_CASES = [
    ("vocab", (1, 2), "dense"), ("vocab", (2, 2), "dense"),
    ("topics", (1, 2), "dense"), ("topics", (2, 2), "dense"),
    ("vocab", (1, 2), "ragged"), ("topics", (1, 2), "ragged"),
    ("vocab", (1, 2), "scatter"), ("topics", (1, 2), "scatter"),
]


@pytest.mark.parametrize("mode, shape, route", _SVI_CASES)
def test_svi_lambda_split_matches_jax_and_one_process(tmp_path, mode, shape,
                                                      route):
    """tests/test_sharding.py:188 at defaults and :211 at pinned sweeps,
    and the pinned run against the port's one process."""
    defaults = {**BASE, **SVI, **ROUTES[route]}
    pinned = {**defaults, **PINNED}
    r = run_sharded(tmp_path, shape, [
        {**defaults, **flag(mode), "mesh_shape": list(shape)},
        {**pinned, **flag(mode), "mesh_shape": list(shape)}],
        iterations=SVI_ITERATIONS)
    j_ests, j_lam, _ = jax_run(json.dumps(defaults, sort_keys=True),
                               SVI_ITERATIONS)
    assert _elbo_rel(r["r0_objs"], j_ests) < DEFAULT_EST
    np.testing.assert_allclose(r["r0_lam"], j_lam, rtol=DEFAULT_LAM_RTOL,
                               atol=DEFAULT_LAM_ATOL)
    j_ests, j_lam, _ = jax_run(json.dumps(pinned, sort_keys=True),
                               SVI_ITERATIONS)
    assert _elbo_rel(r["r1_objs"], j_ests) < PINNED_EST
    np.testing.assert_allclose(r["r1_lam"], j_lam, rtol=PINNED_LAM_RTOL)
    p_ests, p_lam, _, _, p_pp = port_run(json.dumps(pinned, sort_keys=True),
                                         SVI_ITERATIONS)
    assert _elbo_rel(r["r1_objs"], p_ests) < ONE_REL
    assert norm_rel(r["r1_lam"], p_lam) < ONE_REL
    assert abs(float(r["r1_perplexity"]) - p_pp) / p_pp < ONE_REL


@pytest.mark.parametrize("mode", ["vocab", "topics"])
def test_sharded_model_file_is_the_one_process_format(tmp_path, mode):
    """A model file saved on a (1, 2) mesh holds the whole lambda (rank 0
    writes the gathered blocks) under the one-process keys: both packages
    load it in one process, with the ranks' lambda bit for bit and their
    held-out perplexity."""
    path = str(tmp_path / "model-2")
    cfg = {**BASE, **flag(mode), "mesh_shape": [1, 2]}
    r = run_sharded(tmp_path, (1, 2), [cfg], save=path)
    beta = synthetic_corpus(**CORPUS)[1]
    one = Inferencer.load(path, device="cpu")
    theirs = JaxInferencer.load(path)
    K, V = CORPUS["num_topics"], CORPUS["num_types"]
    assert tuple(one.state.lam.shape) == (K, V)
    np.testing.assert_array_equal(one.state.lam.numpy(), r["r0_lam"])
    np.testing.assert_array_equal(np.asarray(theirs.state.lam), r["r0_lam"])
    with np.load(path) as z:
        keys = set(z.files)
    assert keys == {"lam", "alpha", "eta", "step", "key", "vocab",
                    "meta_json"}
    test = synthetic_corpus(beta=beta, **TEST)[0]
    assert abs(one.perplexity(test) - float(r["r0_perplexity"])) / float(
        r["r0_perplexity"]) < ONE_REL


@pytest.mark.parametrize("mode", ["vocab", "topics"])
def test_jax_model_file_resumes_on_a_model_axis(tmp_path, mode):
    """A model file of the JAX engine (trained in one process with the
    shard flag in its config) loads on a (1, 2) mesh: each rank keeps its
    block, and held-out scoring on the gathered expElogbeta is within rel
    1e-4 of the JAX engine's."""
    cfg = {**BASE, **flag(mode)}
    train, beta, _ = jax_synthetic(**CORPUS)
    test = jax_synthetic(beta=beta, **TEST)[0]
    eng = JaxVB(JaxConfig(**cfg))
    eng.initialize(train, lam_init=lam_init())
    eng.learning()
    eng.learning()
    path = str(tmp_path / "model-2")
    eng.save(path)
    spec = dict(corpus=CORPUS, test=TEST, lam_seed=LAM_SEED,
                mesh_shape=[1, 2], load=path)
    ranks = run_ranks("shard", spec, tmp_path, world=2)
    K, V = CORPUS["num_topics"], CORPUS["num_types"]
    for m, res in enumerate(ranks):
        want = (K, V // 2) if mode == "vocab" else (K // 2, V)
        assert tuple(res["load_lam_shape"]) == want
        np.testing.assert_array_equal(res["load_lam"], np.asarray(
            eng.state.lam))
    want_pp = eng.perplexity(test)
    assert abs(float(ranks[0]["load_perplexity"]) - want_pp) / want_pp < 1e-4


def _cli(corpus_dir, out, *extra):
    return subprocess.Popen(
        [sys.executable, "-m", "pylda_tpu_torch.cli.train",
         f"--input_directory={corpus_dir}", f"--output_directory={out}",
         "--number_of_topics=5", "--training_iterations=3",
         "--snapshot_interval=3", "--estep_stall_patience=0", "--device=cpu",
         *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=rank_env())


@pytest.fixture(scope="module")
def denews_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("denews"))
    make_denews_tiny(d, num_train=120, num_test=30, mean_doc_length=25)
    return d


@pytest.mark.parametrize("flag_", ["--shard_vocab", "--shard_topics"])
def test_cli_mesh_1x2_lambda_split(tmp_path, denews_dir, flag_):
    """The train CLI in two processes with --mesh 1,2 and the flag (both
    ranks read the whole corpus with --process_sharded_input: one data
    coordinate): rank 0 writes one run whose model-3 holds the whole
    lambda, within rel 1e-3 of the one-process CLI's; the test and infer
    CLIs and the JAX package read it."""
    port = free_port()
    flags = [f"--coordinator_address=127.0.0.1:{port}", "--num_processes=2",
             "--process_sharded_input", "--mesh=1,2", flag_]
    procs = [_cli(denews_dir, tmp_path / "split", *flags,
                  f"--process_id={r}") for r in range(2)]
    procs.append(_cli(denews_dir, tmp_path / "one"))
    outs = wait_all(procs)
    assert "processes=2" in outs[0] and "iteration=" not in outs[1]
    split, one = (sorted(glob.glob(str(tmp_path / d / "*" / "*" /
                                       "model-3"))) for d in ("split", "one"))
    assert len(split) == len(one) == 1
    lam = np.load(split[0])["lam"]
    assert lam.shape == np.load(one[0])["lam"].shape
    assert norm_rel(lam, np.load(one[0])["lam"]) < CLI_REL
    np.testing.assert_array_equal(np.asarray(JaxInferencer.load(
        split[0]).state.lam), lam)
    assert run_test_cli([f"--model={split[0]}",
                      f"--input_directory={denews_dir}",
                      f"--output_file={tmp_path / 'gamma.out'}",
                      "--device=cpu"]) == 0
    docs = tmp_path / "docs.txt"
    docs.write_text("government election vote\n")
    assert infer_main([f"--model={split[0]}", f"--input={docs}",
                       f"--output={tmp_path / 'mix.tsv'}",
                       "--device=cpu"]) == 0
    assert np.loadtxt(tmp_path / "gamma.out").shape == (30, 5)
