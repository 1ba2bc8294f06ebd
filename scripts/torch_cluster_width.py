"""Times the gamma kernels above K = 4096 and SVI config 5's gamma launches,
for choosing the cluster kernel's width and comparing two trees.

    PYTHONPATH=. python scripts/torch_cluster_width.py [--widths 4,8,16]

On one CUDA card, with whichever ``pylda_tpu_torch`` is first on
``PYTHONPATH`` (put an older tree, unpacked with ``git archive``, first to
time it; run new and old in turns in one call), it times warm calls (CUDA
events, the mean of 10) of:

- the ragged gamma kernel on config 5's 256-row bucket of width 256 (the
  bucket ``chip_smoke.py``'s ``wide_k_kernels`` holds) at K = 4100, 8192
  and 16384, float32 and bf16, at config 5's settings (30 inner sweeps,
  threshold 1e-5, stall patience 6) and a sharpened lambda, through the
  wrapper (the tree's own plan); with ``cluster_plan`` in the tree also at
  each cluster width of ``--widths`` (the plan's other fields follow);
- the dense E-step (gamma kernel and its final pass) on 256 documents of
  the dense flagship's vocabulary (V = 4096) at K = 8192;
- SVI config 5's first minibatch at K = 1000 (its buckets at
  minibatch-local positions), every bucket one gamma launch: with each
  bucket's segments where the tree has them, and without.

Each line gives the launch's geometry and ms; the script prints the
package's path and the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

import pylda_tpu_torch
from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.models import StochasticVariationalBayes, VariationalBayes
from pylda_tpu_torch.ops import dense_estep as dense_mod
from pylda_tpu_torch.ops import ragged as ragged_mod
from pylda_tpu_torch.ops import row_fixed_point as rfp
from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation_fast
from pylda_tpu_torch.utils.config import LDAConfig

# SVI config 5 as chip_smoke.py builds it.
SVI5 = dict(K=1000, V=100_000, D=8192, LEN=150.0, BATCH=2048, INNER=30,
            SEED=4)
KS = (4100, 8192, 16384)
REPS = 10


def cuda_ms(fn, reps: int = REPS) -> float:
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def wide_lam(beta, K: int, tokens: float, dev, seed: int):
    """chip_smoke.py's sharpened lambda [K, V] above the planted topics."""
    b = torch.as_tensor(beta, dtype=torch.float32, device=dev)
    Kp, V = b.shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    lam = torch.empty((K, V), dtype=torch.float32, device=dev)
    for k0 in range(0, K, Kp):
        k1 = min(K, k0 + Kp)
        lam[k0:k1] = (1.0 / V + b[:k1 - k0] * (tokens / K)) * (
            0.5 + torch.rand((k1 - k0, V), generator=gen, device=dev))
    return lam


def geometry(geo: dict) -> str:
    keys = [k for k in rfp.GEOMETRY if k in geo]
    return " ".join(f"{k}={geo[k]}" for k in keys)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", default="4,8,16")
    args = ap.parse_args()
    widths = [int(w) for w in args.widths.split(",")]
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"package {pylda_tpu_torch.__file__} on {smi}")
    corpus5, beta5, _ = synthetic_corpus(
        num_docs=SVI5["D"], num_topics=SVI5["K"], num_types=SVI5["V"],
        mean_doc_length=SVI5["LEN"], seed=SVI5["SEED"])
    (b,) = corpus5.to_ragged_buckets(bucket_sizes=(256,), doc_pad_multiple=64,
                                     doc_indices=range(256))
    ids = torch.as_tensor(b.ids, device=dev)
    cnts = torch.as_tensor(b.cnts, device=dev)
    kw = dict(inner_iterations=SVI5["INNER"], convergence_threshold=1e-5,
              eps=1e-30, stall_patience=6)
    print(f"config 5 bucket {tuple(ids.shape)}: {int((cnts != 0).sum())} live "
          f"slots, {int((cnts != 0).sum(1).max())} in the longest row")
    for K in KS:
        eeb = exp_dirichlet_expectation_fast(
            wide_lam(beta5, K, corpus5.num_tokens, dev, seed=K))
        alpha = torch.full((K,), 1.0 / K, device=dev)
        g0 = torch.ones((ids.shape[0], K), device=dev)
        for cd in ("float32", "bfloat16"):
            table = rfp.gather_table(eeb, cd)
            geo = {}
            ragged_mod.ragged_gamma(ids, cnts, g0, eeb, alpha, eeb_t=table,
                                    geometry_out=geo, compute_dtype=cd, **kw)
            ms = cuda_ms(lambda: ragged_mod.ragged_gamma(
                ids, cnts, g0, eeb, alpha, eeb_t=table, compute_dtype=cd,
                **kw))
            print(f"ragged K={K} {cd} plan of the tree: {ms:.3f} ms "
                  f"({geometry(geo)})")
            if not hasattr(rfp, "cluster_plan"):
                continue
            entry = rfp.entry("ragged_gamma", cd)
            for c in widths:
                plan = rfp.cluster_plan(K, ids.shape[1], cd,
                                        kw["inner_iterations"], cluster=c)
                geo = {}

                def call(geo=None, plan=plan, table=table, entry=entry):
                    return rfp.launch(entry, ids, cnts, ids.shape[1], table,
                                      alpha, g0, kw["inner_iterations"],
                                      kw["convergence_threshold"], kw["eps"],
                                      kw["stall_patience"], plan=plan,
                                      geometry_out=geo)

                call(geo)
                ms = cuda_ms(call)
                print(f"ragged K={K} {cd} cluster {c}: "
                      f"{ms:.3f} ms ({geometry(geo)})")
            del table
        del eeb
        torch.cuda.empty_cache()
    # The dense E-step on the dense flagship's vocabulary at K = 8192.
    dcorpus, dbeta, _ = synthetic_corpus(num_docs=256, num_topics=100,
                                         num_types=4096, mean_doc_length=120.0,
                                         seed=1)
    K = 8192
    rng = np.random.default_rng(12)
    bw = dbeta[np.arange(K) % dbeta.shape[0]] * (
        0.5 + rng.random((K, dbeta.shape[1]), dtype=np.float32))
    bw /= bw.sum(axis=1, keepdims=True)
    cfgd = LDAConfig(number_of_topics=K, seed=0)
    probe = VariationalBayes(cfgd, device=dev)
    probe.initialize(dcorpus, lam_init=(1.0 / 4096 + bw * (
        dcorpus.num_tokens / K)).astype(np.float32))
    (batch,) = probe._batches
    dc = batch.counts
    eeb = exp_dirichlet_expectation_fast(probe.state.lam)
    g0 = torch.ones((dc.shape[0], K), device=dev)
    dkw = dict(inner_iterations=50, convergence_threshold=1e-5,
               stall_patience=6)
    for cd in ("float32", "bfloat16"):
        geo = {}
        dense_mod.dense_estep(dc, g0, eeb, probe.state.alpha, geometry_out=geo,
                              compute_dtype=cd, **dkw)
        ms = cuda_ms(lambda: dense_mod.dense_estep(
            dc, g0, eeb, probe.state.alpha, compute_dtype=cd, **dkw))
        print(f"dense V=4096 D={dc.shape[0]} K={K} {cd} (gamma and final "
              f"pass): {ms:.3f} ms ({geometry(geo)})")
    del probe, eeb, dc
    torch.cuda.empty_cache()
    # SVI config 5's minibatch at K = 1000.
    cfg5 = LDAConfig(number_of_topics=SVI5["K"], inference_mode="svi",
                     batch_size=SVI5["BATCH"], seed=0,
                     inner_iterations=SVI5["INNER"])
    svi = StochasticVariationalBayes(cfg5, device=dev)
    svi.initialize(corpus5, lam_init=(1.0 / SVI5["V"] + beta5 * (
        corpus5.num_tokens / SVI5["K"])).astype(np.float32))
    eeb = exp_dirichlet_expectation_fast(svi.state.lam)
    alpha = svi.state.alpha
    batches, (_, sel) = next(svi._epoch(cfg5.seed, 0).minibatches)
    buckets = svi._local_plan(batches, sel)[0]
    segs = [getattr(bk, "segments", None) for bk in buckets]
    # Each bucket's segment index, built once, where the tree keeps one.
    seg_rows = [({"seg_rows": bk.seg_rows} if hasattr(bk, "seg_rows")
                 else {}) for bk in buckets]
    for cd in ("float32", "bfloat16"):
        table = rfp.gather_table(eeb, cd)
        g0s = [torch.ones((bk.ids.shape[0], SVI5["K"]), device=dev)
               for bk in buckets]
        for with_segments in ((True, False) if any(segs) else (False,)):
            def run():
                out = []
                for bk, g0, sg, sr in zip(buckets, g0s, segs, seg_rows):
                    extra = {"segments": sg, **sr} if with_segments else {}
                    out.append(ragged_mod.ragged_gamma(
                        bk.ids, bk.cnts, g0, eeb, alpha, eeb_t=table,
                        compute_dtype=cd, **kw, **extra)[1])
                return out
            sweeps = [s.tolist() for s in run()]
            ms = cuda_ms(run)
            print(f"svi config 5 minibatch K={SVI5['K']} {cd}, "
                  f"{len(buckets)} launches "
                  f"{[tuple(bk.ids.shape) for bk in buckets]}, "
                  f"{'segments ' + str(segs) if with_segments else 'one S* a bucket'}"
                  f": {ms:.3f} ms, sweeps {sweeps}")


if __name__ == "__main__":
    main()
