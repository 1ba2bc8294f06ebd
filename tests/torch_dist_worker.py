"""One rank of a multi-process run of pylda_tpu_torch on the CPU.

    python tests/torch_dist_worker.py CASE RANK WORLD INIT_FILE OUT SPEC_JSON

Joins a gloo process group through ``file://INIT_FILE`` (60 s timeout),
runs CASE with the JSON spec, and writes its results to ``OUT`` (an npz).
``tests/torch_dist.py::run_ranks`` starts one process a rank.  This file
imports the port only (no JAX): the tests hold its results against the
JAX package in their own process.
"""

import datetime
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from pylda_tpu_torch.corpus.datasets import load_input_directory  # noqa: E402
from pylda_tpu_torch.corpus.synthetic import synthetic_corpus  # noqa: E402
from pylda_tpu_torch.models import make_engine  # noqa: E402
from pylda_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from pylda_tpu_torch.utils.config import LDAConfig  # noqa: E402


def _corpora(spec, mesh):
    """(train, test, vocab): from ``corpus_dir`` (process-local when
    ``process_local``, disk-backed when ``streaming``) or a seeded
    synthetic corpus (cut to the rank's block when ``process_local``)."""
    local = spec.get("process_local", False)
    if "corpus_dir" in spec:
        return load_input_directory(
            spec["corpus_dir"],
            process_index=mesh.data_index if local else None,
            process_count=mesh.data if local else None,
            streaming=spec.get("streaming", False),
        )
    train, beta, _ = synthetic_corpus(**spec["corpus"])
    test = None
    if "test" in spec:
        test = synthetic_corpus(beta=beta, **spec["test"])[0]
    if local:
        lo, hi = pmesh.block_bounds(train.num_docs, mesh.data_index,
                                    mesh.data)
        block = train.subset(range(lo, hi))
        block.process_local = True
        block.global_num_docs = train.num_docs
        block.global_doc_offset = lo
        train = block
    return train, test, train.vocab


def case_engine(spec, mesh):
    """Initialize, ``iterations`` learning() calls (replicas checked after
    each), ``many`` in learning_many; the state, the objectives, gamma,
    held-out perplexities and the collectives each phase made."""
    train, test, vocab = _corpora(spec, mesh)
    cfg = LDAConfig(**spec["cfg"]).validate()
    K, V = cfg.number_of_topics, len(vocab)
    lam0 = None
    if spec.get("lam_seed") is not None:
        lam0 = np.random.default_rng(spec["lam_seed"]).gamma(
            100.0, 0.01, (K, V))
    eng = make_engine(cfg, device="cpu")
    eng.initialize(train, vocab, lam_init=lam0,
                   mesh=mesh if spec.get("mesh", True) else None)
    out = {}
    objs, reduces = [], []
    for _ in range(spec.get("iterations", 2)):
        before = pmesh.COLLECTIVES["all_reduce"]
        objs.append(eng.learning())
        reduces.append(pmesh.COLLECTIVES["all_reduce"] - before)
        pmesh.assert_replicas_consistent(eng.state, mesh)
    objs += eng.learning_many(spec.get("many", 0))
    out["objs"] = np.asarray(objs, np.float64)
    out["reduces"] = np.asarray(reduces)
    st = eng.state
    for k in ("lam", "alpha", "eta"):
        out[k] = getattr(st, k).numpy()
    out["gamma"] = eng.gamma
    if cfg.inference_mode == "gibbs":
        out["n_kv"] = eng._n_kv.numpy()
        pmesh.assert_replicas_consistent({"n_kv": eng._n_kv}, mesh)
    out["tokens"] = (sum(int(t) for t in pmesh.allgather_numpy(
        train.num_tokens, mesh)) if getattr(train, "process_local", False)
        else train.num_tokens)
    if getattr(eng, "_svi_geometry", None):
        geo = eng._svi_geometry
        out["geometry"] = np.asarray([[w, geo[w]] for w in sorted(geo)])
    if test is not None:
        out["perplexity"] = eng.perplexity(test)
        out["point_perplexity"] = eng.point_estimate_perplexity(test)
    if spec.get("save"):
        eng.save(spec["save"])
    if spec.get("timings"):
        from pylda_tpu_torch.utils.roofline import roofline_report

        times = eng.phase_timings(1)
        out["timings"] = json.dumps(times)
        out["roofline"] = json.dumps(roofline_report(eng, timings=times))
    return out


def case_replicas(spec, mesh):
    """One iteration, then rank 1's lambda nudged by one ulp-sized step:
    the replica check must raise on both ranks."""
    train, _, vocab = _corpora(spec, mesh)
    eng = make_engine(LDAConfig(**spec["cfg"]), device="cpu")
    eng.initialize(train, vocab, mesh=mesh)
    eng.learning()
    sums = pmesh.replica_checksums(eng.state, mesh)
    same = all(len(set(v)) == 1 for v in sums.values())
    if mesh.rank == 1:
        eng.state.lam[0, 0] = torch.nextafter(eng.state.lam[0, 0],
                                              torch.tensor(np.inf))
    try:
        pmesh.assert_replicas_consistent(eng.state, mesh)
        diverged = False
    except AssertionError:
        diverged = True
    return {"same_before": same, "diverged": diverged,
            "ranks_in_sums": len(sums["lam"])}


def case_resume(spec, mesh):
    """A model file resumed over the mesh: for Gibbs, this rank's rows of
    each saved chain adopted; for the VB family, one more iteration."""
    from pylda_tpu_torch.models import Inferencer
    from pylda_tpu_torch.models.gibbs import local_chains

    train, _, _ = _corpora(spec, mesh)
    eng = Inferencer.load(spec["path"], corpus=train, device="cpu", mesh=mesh)
    if eng.config.inference_mode != "gibbs":
        obj = eng.learning()
        return {"obj": obj, "lam": eng.state.lam.numpy(),
                "step": eng._counter}
    blobs = np.load(spec["path"])
    n = sum(1 for k in blobs.files if k.startswith("extra_z_"))
    want = local_chains([blobs[f"extra_z_{i}"] for i in range(n)], mesh)
    adopted = len(eng._z) == n and all(
        np.array_equal(z.numpy(), w) for z, w in zip(eng._z, want))
    return {"adopted": adopted, "n_kv": eng._n_kv.numpy()}


def case_batches(spec, mesh):
    """The rank's VB batches (rows, doc ids) and dense sstats plan size."""
    train, _, vocab = _corpora(spec, mesh)
    eng = make_engine(LDAConfig(**spec["cfg"]), device="cpu")
    eng.initialize(train, vocab, mesh=mesh)
    out = {"num_batches": len(eng._batches),
           "doc_offset": eng._doc_offset,
           "plan_docs": (-1 if eng._sstats_plan is None
                         else eng._sstats_plan.num_docs)}
    for i, b in enumerate(eng._batches):
        out[f"doc_ids_{i}"] = np.asarray(b.doc_ids)
    return out


def case_hang(spec, mesh):
    """On a group with a short timeout (``collective_timeout`` s, made by
    both ranks), rank 0 all-reduces and rank 1 never joins.  Rank 0
    reports the error and how long it waited."""
    import dataclasses

    short = torch.distributed.new_group(
        backend="gloo",
        timeout=datetime.timedelta(seconds=spec["collective_timeout"]))
    mesh = dataclasses.replace(mesh, device_group=short)
    t0 = time.monotonic()
    err = ""
    if mesh.rank == 0:
        try:
            pmesh.all_reduce_sum(torch.ones(4), mesh)
        except Exception as e:  # the group's timeout
            err = type(e).__name__ + ": " + str(e)[:200]
    else:
        time.sleep(spec["sleep"])
    return {"error": err, "waited": time.monotonic() - t0}


def _lam0(spec, K, V):
    if spec.get("lam_seed") is None:
        return None
    return np.random.default_rng(spec["lam_seed"]).gamma(100.0, 0.01, (K, V))


def case_shard(spec, mesh):
    """Lambda split over the model axis: for each config of ``runs``,
    initialize from ``lam_seed``, ``iterations`` learning() calls (each
    lambda block checked bitwise across its data group and the blocks'
    tiling of (K, V) after each), ``many`` in learning_many; the
    objectives, the gathered lambda, alpha, eta, the block's shape and
    bounds, gamma, the topic-word matrix, held-out perplexities and the
    collectives each run made (prefixed ``r<i>_``).  ``save`` writes the
    first run's model file; ``load`` resumes one on the mesh and scores
    the held-out documents."""
    from pylda_tpu_torch.models import Inferencer

    train, test, vocab = _corpora(spec, mesh)
    out = {}
    if spec.get("load"):
        eng = Inferencer.load(spec["load"], device="cpu", mesh=mesh)
        out["load_lam_shape"] = np.asarray(eng.state.lam.shape)
        out["load_perplexity"] = eng.perplexity(test)
        out["load_point_perplexity"] = eng.point_estimate_perplexity(test)
        out["load_lam"] = eng.gathered_lam().numpy()
    for i, run in enumerate(spec.get("runs", [])):
        cfg = LDAConfig(**run).validate()
        K, V = cfg.number_of_topics, len(vocab)
        pmesh.COLLECTIVES.clear()
        eng = make_engine(cfg, device="cpu")
        eng.initialize(train, vocab, lam_init=_lam0(spec, K, V), mesh=mesh)
        objs = []
        for _ in range(spec.get("iterations", 2)):
            objs.append(eng.learning())
            pmesh.assert_replicas_consistent(
                eng.state, mesh, sharded=("lam",), full_shape=(K, V))
        objs += eng.learning_many(spec.get("many", 0))
        p = f"r{i}_"
        out[p + "collectives"] = json.dumps(dict(pmesh.COLLECTIVES))
        out[p + "objs"] = np.asarray(objs, np.float64)
        out[p + "lam"] = eng.gathered_lam().numpy()
        out[p + "block"] = np.asarray(eng.state.lam.shape)
        out[p + "bounds"] = np.asarray(
            eng._shard.bounds if eng._shard is not None else (-1, -1))
        out[p + "alpha"] = eng.state.alpha.numpy()
        out[p + "eta"] = eng.state.eta.numpy()
        out[p + "gamma"] = eng.gamma
        out[p + "twd"] = eng.topic_word_distribution()
        if test is not None:
            out[p + "perplexity"] = eng.perplexity(test)
            out[p + "point_perplexity"] = eng.point_estimate_perplexity(test)
        if spec.get("save") and i == 0:
            eng.save(spec["save"])
    return out


def case_groups(spec, mesh):
    """The mesh's coordinates and groups: the sum of the ranks over the
    data group and over the model group, a [K, V] tensor's blocks
    gathered over the model group along each axis, the tiling check on
    those blocks and on a wrong shape, and the shard replica check
    after ``bump_rank`` nudges its block by one ulp."""
    import torch

    r = torch.tensor([float(mesh.rank)])
    data_sum = float(pmesh.all_reduce_sum(r.clone(), mesh, "data")[0])
    model_sum = float(pmesh.all_reduce_sum(r.clone(), mesh, "model")[0])
    K, V = spec["shape"]
    full = torch.arange(K * V, dtype=torch.float32).reshape(K, V)
    out = {"data_index": mesh.data_index, "model_index": mesh.model_index,
           "data_sum": data_sum, "model_sum": model_sum}
    for axis in (0, 1):
        total = full.shape[axis]
        lo, hi = pmesh.block_bounds(total, mesh.model_index, mesh.model)
        block = full[lo:hi] if axis == 0 else full[:, lo:hi]
        got = pmesh.all_gather_blocks(block.contiguous(), total, mesh, axis)
        out[f"gather_ok_{axis}"] = bool(torch.equal(got, full))
        pmesh.assert_shards_tile(block.shape, (K, V), mesh)
        try:
            pmesh.assert_shards_tile(block.shape, (K + 1, V + 1), mesh)
            out[f"bad_tiling_caught_{axis}"] = False
        except AssertionError:
            out[f"bad_tiling_caught_{axis}"] = True
    lo, hi = pmesh.block_bounds(V, mesh.model_index, mesh.model)
    state = {"lam": full[:, lo:hi].clone(), "alpha": torch.ones(K)}
    pmesh.assert_replicas_consistent(state, mesh, sharded=("lam",),
                                     full_shape=(K, V))
    if mesh.rank == spec["bump_rank"]:
        state["lam"][0, 0] = torch.nextafter(state["lam"][0, 0],
                                             torch.tensor(np.inf))
    try:
        pmesh.assert_replicas_consistent(state, mesh, sharded=("lam",))
        out["diverged"] = False
    except AssertionError:
        out["diverged"] = True
    return out


def sampling_run(run, spec, train, test, vocab, mesh):
    """One Gibbs or hybrid run of ``case_sampling`` (``mesh`` None: the
    one-process reference the tests make in their own process): the
    engine from ``run["load"]`` (a model file, resumed on ``train``) or
    initialized; with ``run["chains"]`` (an npz of a JAX engine's state,
    n_kv and chains, whole) adopted through the ``state`` setter and
    ``set_chains``, and the joint likelihood there (Gibbs); then
    ``iterations`` (the run's, else the spec's) learning() calls, each
    step's collectives recorded (and
    for Gibbs the likelihoods the slice sampler evaluated) and the tables
    checked after each (blocks bitwise across their data groups and
    tiling (K, V), the rest across every rank); ``many`` in
    learning_many.  Returns the objectives, the whole tables, alpha, eta,
    the blocks' shapes, the chains of every data coordinate, gamma, the
    topic-word matrix, held-out perplexities and, with ``timings``,
    phase_timings and the roofline report."""
    from pylda_tpu_torch.models import Inferencer
    from pylda_tpu_torch.models.base import state_from_numpy
    from pylda_tpu_torch.models.gibbs import gather_chains, local_chains

    if run.get("load"):
        eng = Inferencer.load(run["load"], corpus=train, device="cpu",
                              mesh=mesh)
    else:
        eng = make_engine(LDAConfig(**run["cfg"]).validate(), device="cpu")
        eng.initialize(train, vocab, mesh=mesh)
    cfg = eng.config
    gibbs = cfg.inference_mode == "gibbs"
    K, V = cfg.number_of_topics, len(vocab)
    out = {}
    if run.get("chains"):
        with np.load(run["chains"]) as z:
            blobs = {k: z[k] for k in z.files}
        eng.state = state_from_numpy(blobs, "cpu")
        chains = lambda p: local_chains(  # noqa: E731
            [blobs[f"{p}_{i}"] for i in range(sum(
                1 for k in blobs if k.startswith(p + "_")))], mesh)
        if gibbs:
            eng.set_chains(blobs["n_kv"], chains("z"), chains("ndk"))
            out["ll0"] = eng.compute_likelihood()
            out["ll0_scalars"] = eng.compute_likelihood(0.3, 0.02)
        else:
            eng.set_chains(chains("zh"))
    likelihoods = [0]
    if gibbs:
        plain = eng.compute_likelihood

        def counted(*a):
            likelihoods[0] += 1
            return plain(*a)

        eng.compute_likelihood = counted
    sharded = ("lam", "n_kv") if eng._shard is not None else ()
    objs, steps = [], []
    for _ in range(run.get("iterations", spec.get("iterations", 3))):
        pmesh.COLLECTIVES.clear()
        likelihoods[0] = 0
        objs.append(eng.learning())
        steps.append([pmesh.COLLECTIVES["all_reduce"],
                      pmesh.COLLECTIVES["all_gather"], likelihoods[0]])
        tables = {"lam": eng.state.lam, "alpha": eng.state.alpha,
                  "eta": eng.state.eta}
        if gibbs:
            tables["n_kv"] = eng._n_kv
        pmesh.assert_replicas_consistent(tables, mesh, sharded=sharded,
                                         full_shape=(K, V))
    objs += eng.learning_many(spec.get("many", 0))
    out.update(objs=np.asarray(objs, np.float64), steps=np.asarray(steps),
               lam=eng.gathered_lam().numpy(), block=np.asarray(
                   eng.state.lam.shape),
               alpha=eng.state.alpha.numpy(), eta=eng.state.eta.numpy(),
               gamma=eng.gamma, twd=eng.topic_word_distribution(),
               step=eng._counter)
    if gibbs:
        out["n_kv"] = eng._n_kv_whole.numpy()
        out["n_kv_block"] = np.asarray(eng._n_kv.shape)
        chains = {"z": eng._z, "ndk": eng._ndk}
    else:
        chains = {"zh": eng._z_hyb or []}
    for name, ts in chains.items():
        for i, a in enumerate(gather_chains(ts, mesh)):
            out[f"{name}_{i}"] = a
    if test is not None:
        out["perplexity"] = eng.perplexity(test)
        out["point_perplexity"] = eng.point_estimate_perplexity(test)
    if run.get("save"):
        eng.save(run["save"])
    if run.get("timings"):
        from pylda_tpu_torch.utils.roofline import roofline_report

        times = eng.phase_timings(1)
        out["timings"] = json.dumps(times)
        out["roofline"] = json.dumps(roofline_report(eng, timings=times))
    return out


def case_sampling(spec, mesh):
    """Gibbs and hybrid over the mesh, each flag or neither: every run of
    ``runs`` (``sampling_run``), its results prefixed ``r<i>_``."""
    train, test, vocab = _corpora(spec, mesh)
    out = {}
    for i, run in enumerate(spec["runs"]):
        res = sampling_run(run, spec, train, test, vocab, mesh)
        out.update({f"r{i}_{k}": v for k, v in res.items()})
    return out


CASES = {"engine": case_engine, "batches": case_batches, "hang": case_hang,
         "replicas": case_replicas, "resume": case_resume,
         "shard": case_shard, "groups": case_groups,
         "sampling": case_sampling}


def main(argv):
    case, rank, world, init_file, out, spec = argv
    torch.set_num_threads(1)
    spec = json.loads(spec)
    pmesh.init_distributed(
        num_processes=int(world), process_id=int(rank), device="cpu",
        init_method=f"file://{init_file}",
        timeout=datetime.timedelta(seconds=60),
    )
    shape = spec.get("mesh_shape")
    mesh = pmesh.make_mesh(tuple(shape) if shape else None, device="cpu")
    result = CASES[case](spec, mesh)
    result["collectives"] = json.dumps(dict(pmesh.COLLECTIVES))
    result["backend"] = mesh.backend
    np.savez(out, **result)
    if case != "hang":
        pmesh.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
