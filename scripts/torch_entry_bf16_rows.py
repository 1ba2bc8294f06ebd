"""The bf16 gamma kernels' rows against the float64 plain version at SVI
config 5's first minibatch, row by row.

    PYTHONPATH=. python scripts/torch_entry_bf16_rows.py [--clusters 3,4,6]

On one CUDA card, with whichever ``pylda_tpu_torch`` is first on
``PYTHONPATH``: builds config 5 (K = 1000, V = 100k, 8,192 documents,
minibatches of 2048, 30 inner sweeps) at the sharpened lambda
``chip_smoke.py`` uses, takes the first minibatch's buckets (with their
segments) and runs, in the bf16 mode at the main path's exit rule, the
kernel, the plain version in float32 and the plain version in float64
(the same rounding points).  For each bucket it prints each version's
largest gap in a row's share of the bound (``ops/estep.py::
ragged_doc_bound``) from the float64 run, the rows where the kernel's gap
is largest with their live entries, their sweeps (kernel, plain, float64)
and both gaps, and how many rows each version leaves at a gap past the
other's largest.  With ``--clusters`` and a tree that has
``gamma_plan``, each bucket's kernel gap is also given with the entry
kernel forced to each cluster width.  The card's name and power limit
come first.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

import pylda_tpu_torch
from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.models import StochasticVariationalBayes
from pylda_tpu_torch.ops import ragged as ragged_mod
from pylda_tpu_torch.ops import row_fixed_point as rfp
from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation_fast
from pylda_tpu_torch.ops.estep import estep_ragged_gamma, ragged_doc_bound
from pylda_tpu_torch.utils.config import LDAConfig

BF16 = "bfloat16"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clusters", default="")
    widths = [int(c) for c in ap.parse_args().clusters.split(",") if c]
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"package {pylda_tpu_torch.__file__} on {smi}", flush=True)
    K, V = 1000, 100_000
    corpus, beta, _ = synthetic_corpus(num_docs=8192, num_topics=K,
                                       num_types=V, mean_doc_length=150.0,
                                       seed=4)
    cfg = LDAConfig(number_of_topics=K, inference_mode="svi", batch_size=2048,
                    tau0=64.0, kappa=0.7, seed=0, inner_iterations=30)
    svi = StochasticVariationalBayes(cfg, device=dev)
    svi.initialize(corpus, lam_init=(1.0 / V + beta * (
        corpus.num_tokens / K)).astype(np.float32))
    eeb = exp_dirichlet_expectation_fast(svi.state.lam)
    alpha = svi.state.alpha
    batches, (_, sel) = next(svi._epoch(cfg.seed, 0).minibatches)
    buckets = svi._local_plan(batches, sel)[0]
    kw = dict(inner_iterations=cfg.inner_iterations,
              convergence_threshold=cfg.convergence_threshold, eps=cfg.eps,
              stall_patience=cfg.estep_stall_patience, compute_dtype=BF16)
    e64, a64 = eeb.double(), alpha.double()
    for i, b in enumerate(buckets):
        D = b.ids.shape[0]
        g0 = torch.ones((D, K), device=dev)
        seg = b.segments
        rows_k = torch.zeros((D,), dtype=torch.int32, device=dev)
        g_k, _ = ragged_mod.ragged_gamma(b.ids, b.cnts, g0, eeb, alpha,
                                         row_sweeps_out=rows_k, segments=seg,
                                         seg_rows=b.seg_rows, **kw)
        g_p, _ = estep_ragged_gamma(b.ids, b.cnts, g0, eeb, alpha,
                                    segments=seg, **kw)
        g_64, _ = estep_ragged_gamma(b.ids, b.cnts.double(), g0.double(), e64,
                                     a64, segments=seg, **kw)
        live = (b.cnts != 0).any(dim=1)
        ids, cnts = b.ids[live], b.cnts[live].double()
        b64 = ragged_doc_bound(ids, cnts, g_64[live], e64, a64)

        def gaps(g):
            got = ragged_doc_bound(ids, cnts, g[live].double(), e64, a64)
            return ((got - b64).abs() / b64.abs()).cpu()

        gk, gp = gaps(g_k), gaps(g_p)
        n_live = (cnts != 0).sum(dim=1).cpu()
        sweeps = rows_k[live].cpu()
        worst = torch.argsort(gk, descending=True)[:5]
        print(f"bucket {i} {tuple(b.ids.shape)}: {int(live.sum())} live rows; "
              f"largest gap kernel {float(gk.max()):.3e}, plain "
              f"{float(gp.max()):.3e}; rows past the other's largest: "
              f"kernel {int((gk > gp.max()).sum())}, plain "
              f"{int((gp > gk.max()).sum())}; median gap kernel "
              f"{float(gk.median()):.3e}, plain {float(gp.median()):.3e}",
              flush=True)
        for r in worst.tolist():
            print(f"  row {r}: {int(n_live[r])} live entries, kernel sweeps "
                  f"{int(sweeps[r])}, gap kernel {float(gk[r]):.3e}, plain "
                  f"{float(gp[r]):.3e}", flush=True)
        table = rfp.gather_table(eeb, BF16)
        for c in widths:
            plan = rfp.gamma_plan(K, b.ids.shape[1], BF16,
                                  cfg.inner_iterations, cluster=c)
            if plan.smem_bytes > rfp.H100_SMEM_OPTIN:
                continue  # the row does not fit c CTAs
            g_c, _ = rfp.launch(
                rfp.entry("ragged_gamma", BF16), b.ids, b.cnts,
                b.ids.shape[1], table, alpha, g0, cfg.inner_iterations,
                cfg.convergence_threshold, cfg.eps, cfg.estep_stall_patience,
                plan=plan, segments=seg, seg_rows=b.seg_rows)
            print(f"  cluster {c} ({plan.share} entries a CTA): largest gap "
                  f"{float(gaps(g_c).max()):.3e}", flush=True)


if __name__ == "__main__":
    main()
