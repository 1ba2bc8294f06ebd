"""Times the gamma kernels at K <= 4096 on the launches whose rows pass one
block's slot buffer, for comparing two trees and the entry kernel's
cluster widths.

    PYTHONPATH=. python scripts/torch_gamma_entry_ab.py [--widths 4,6,8]

On one CUDA card, with whichever ``pylda_tpu_torch`` is first on
``PYTHONPATH`` (put an older tree, unpacked with ``git archive``, first to
time it; run old, new, new, old in turns in one call), it times warm
calls (CUDA events, the mean of 10) through the wrappers, each at a
sharpened lambda and the main path's settings:

- SVI config 5's first minibatch at K = 1000 (V = 100k, 8,192 documents,
  minibatches of 2048, 30 inner sweeps; its buckets at minibatch-local
  positions with their segments), float32 and bf16: the sum over its
  launches;
- SVI config 4's first minibatch at K = 200 (V = 50k, 16,384 documents,
  minibatches of 1024, 50 inner sweeps);
- the dense E-step at K = 1000 on the dense flagship's vocabulary (V =
  4096, 4096 documents, 50 inner sweeps), with the batch's largest row
  nnz where the tree's ``dense_estep`` takes it;
- the ragged flagship's four buckets at K = 100 (V = 10k, 4096 documents),
  float32 and bf16, whose rows fit one block's buffer.

Each line gives the launches' routes and geometry where the tree reports
them.  With ``--widths`` and a tree that has ``gamma_plan``, config 5's
minibatch is also timed with the entry kernel forced to each cluster
width.  The script prints the package's path and the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import inspect
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

REPS = 10
FIELDS = ("route", "cluster", "resident", "nmax", "clusters", "smem_bytes")


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


def geometry(geo: dict) -> str:
    return " ".join(f"{k}={geo[k]}" for k in FIELDS if k in geo)


def sharpened(corpus, beta, K):
    return (1.0 / corpus.num_types + beta * (corpus.num_tokens / K)).astype(
        np.float32)


def svi_minibatch(dev, K, V, D, batch, inner, seed):
    """(buckets of the first minibatch, expElogbeta, alpha, the fixed
    point's settings) of SVI at one config, at a sharpened lambda."""
    corpus, beta, _ = synthetic_corpus(num_docs=D, num_topics=K, num_types=V,
                                       mean_doc_length=150.0, seed=seed)
    cfg = LDAConfig(number_of_topics=K, inference_mode="svi",
                    batch_size=batch, tau0=64.0, kappa=0.7, seed=0,
                    inner_iterations=inner, convergence_threshold=1e-5)
    svi = StochasticVariationalBayes(cfg, device=dev)
    svi.initialize(corpus, lam_init=sharpened(corpus, beta, K))
    eeb = exp_dirichlet_expectation_fast(svi.state.lam)
    batches, (_, sel) = next(svi._epoch(cfg.seed, 0).minibatches)
    buckets = svi._local_plan(batches, sel)[0]
    kw = dict(inner_iterations=inner, convergence_threshold=1e-5, eps=1e-30,
              stall_patience=cfg.estep_stall_patience)
    return buckets, eeb, svi.state.alpha, kw


def time_buckets(label, buckets, eeb, alpha, kw, cd):
    """The buckets' launches through the wrapper, each with its segments
    where the tree keeps them: ms for all of them, and each launch's
    geometry."""
    table = rfp.gather_table(eeb, cd)
    K = eeb.shape[0]
    g0s = [torch.ones((b.ids.shape[0], K), device=eeb.device)
           for b in buckets]
    extra = [{k: getattr(b, k) for k in ("segments", "seg_rows")
              if getattr(b, k, None) is not None} for b in buckets]

    def run(geos=None):
        for i, (b, g0, ex) in enumerate(zip(buckets, g0s, extra)):
            ragged_mod.ragged_gamma(
                b.ids, b.cnts, g0, eeb, alpha, eeb_t=table, compute_dtype=cd,
                geometry_out=None if geos is None else geos[i], **kw, **ex)

    geos = [{} for _ in buckets]
    run(geos)
    ms = cuda_ms(run)
    shapes = [tuple(b.ids.shape) for b in buckets]
    print(f"{label} {cd}: {len(buckets)} launches {shapes}: {ms:.3f} ms; "
          + "; ".join(geometry(g) for g in geos), flush=True)
    return table


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", default="")
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"package {pylda_tpu_torch.__file__} on {smi}", flush=True)
    # SVI config 5.
    buckets, eeb, alpha, kw = svi_minibatch(dev, 1000, 100_000, 8192, 2048,
                                            30, 4)
    for cd in ("float32", "bfloat16"):
        table = time_buckets("svi config 5 minibatch K=1000", buckets, eeb,
                             alpha, kw, cd)
        widths = [int(w) for w in args.widths.split(",") if w]
        if cd != "float32" or not widths or not hasattr(rfp, "gamma_plan"):
            continue
        entry = rfp.entry("ragged_gamma", cd)
        for c in widths:
            plans = [rfp.gamma_plan(1000, b.ids.shape[1], cd,
                                    kw["inner_iterations"], cluster=c)
                     for b in buckets]
            g0s = [torch.ones((b.ids.shape[0], 1000), device=dev)
                   for b in buckets]

            def forced(plans=plans, g0s=g0s, table=table, entry=entry):
                for b, g0, pl in zip(buckets, g0s, plans):
                    rfp.launch(entry, b.ids, b.cnts, b.ids.shape[1], table,
                               alpha, g0, kw["inner_iterations"],
                               kw["convergence_threshold"], kw["eps"],
                               kw["stall_patience"], plan=pl,
                               segments=b.segments, seg_rows=b.seg_rows)

            ms = cuda_ms(forced)
            print(f"svi config 5 minibatch K=1000 {cd} cluster {c}: "
                  f"{ms:.3f} ms (entries a CTA "
                  f"{[pl.share for pl in plans]}, shared memory a CTA "
                  f"{[pl.smem_bytes for pl in plans]})", flush=True)
        del table
    del buckets, eeb
    torch.cuda.empty_cache()
    # SVI config 4.
    buckets, eeb, alpha, kw = svi_minibatch(dev, 200, 50_000, 16_384, 1024,
                                            50, 3)
    time_buckets("svi config 4 minibatch K=200", buckets, eeb, alpha, kw,
                 "float32")
    del buckets, eeb
    # The dense E-step at K = 1000 on V = 4096.
    corpus, beta, _ = synthetic_corpus(num_docs=4096, num_topics=1000,
                                       num_types=4096, mean_doc_length=120.0,
                                       seed=0)
    cfg = LDAConfig(number_of_topics=1000, seed=0)
    vb = VariationalBayes(cfg, device=dev)
    vb.initialize(corpus, lam_init=sharpened(corpus, beta, 1000))
    (batch,) = vb._batches
    dc = batch.counts
    eeb = exp_dirichlet_expectation_fast(vb.state.lam)
    g0 = torch.ones((dc.shape[0], 1000), device=dev)
    dkw = dict(inner_iterations=50, convergence_threshold=1e-5,
               stall_patience=cfg.estep_stall_patience)
    if "max_nnz" in inspect.signature(dense_mod.dense_estep).parameters:
        dkw["max_nnz"] = int((dc != 0).sum(dim=1).max())
    geo = {}
    dense_mod.dense_estep(dc, g0, eeb, vb.state.alpha, geometry_out=geo,
                          **dkw)
    ms = cuda_ms(lambda: dense_mod.dense_estep(dc, g0, eeb, vb.state.alpha,
                                               **dkw))
    print(f"dense K=1000 V=4096 D={dc.shape[0]} (gamma and final pass): "
          f"{ms:.3f} ms; {geometry(geo)}", flush=True)
    del vb, dc, eeb, g0
    torch.cuda.empty_cache()
    # The ragged flagship's buckets at K = 100.
    corpus, beta, _ = synthetic_corpus(num_docs=4096, num_topics=100,
                                       num_types=10_000,
                                       mean_doc_length=120.0, seed=0)
    cfg = LDAConfig(number_of_topics=100, seed=0)
    vb = VariationalBayes(cfg, device=dev)
    vb.initialize(corpus, lam_init=sharpened(corpus, beta, 100))
    eeb = exp_dirichlet_expectation_fast(vb.state.lam)
    kw = dict(inner_iterations=50, convergence_threshold=1e-5, eps=1e-30,
              stall_patience=cfg.estep_stall_patience)
    for cd in ("float32", "bfloat16"):
        time_buckets("ragged flagship K=100", vb._batches, eeb,
                     vb.state.alpha, kw, cd)


if __name__ == "__main__":
    main()
