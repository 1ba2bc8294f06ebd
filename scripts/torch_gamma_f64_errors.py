"""How far the gamma kernels and the float32 plain version land from the
plain version run in float64, split by how each row ended.

    PYTHONPATH=. python scripts/torch_gamma_f64_errors.py [--seeds 0 1 2]

On one CUDA card, for each corpus seed, at the ragged flagship (K=100,
V=10,000, D=4096, mean document length 120: each planner bucket) and the
dense flagship (V=4096: the one dense batch), with the sharpened lambda,
inner 50, threshold 1e-5 and stall patience 6 that ``chip_smoke.py``
uses: runs the kernel (``ragged_gamma`` / ``dense_estep``), the plain
version in float32 and in float64, and splits the rows by how they ended
in the kernel: ``done`` (converged below the threshold and frozen before
the batch's last sweep), ``stalled`` (exitable by the stall rule, not
done, so still updating at the last sweep) and ``never`` (not exitable at
any sweep).  For each group it prints the count, the kernel's and the
float32 plain version's max abs error against float64, the kernel against
the float32 plain version, and the share of ``chip_smoke.py``'s gamma
tolerance (5e-4 + K * threshold + 5e-4 * |gamma|) each error uses (above
1 fails it).  Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.models import VariationalBayes
from pylda_tpu_torch.ops import dense_estep as dense_mod
from pylda_tpu_torch.ops import ragged as ragged_mod
from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation_fast
from pylda_tpu_torch.ops.estep import estep_dense, estep_ragged_gamma
from pylda_tpu_torch.utils.config import LDAConfig

K, D, MEAN_LEN = 100, 4096, 120.0
GAMMA_RTOL = 5e-4


def split_errors(g_k, g_32, g_64, row_exit, row_sweeps, sweeps, atol) -> str:
    g_64 = g_64.float()
    scale = atol + GAMMA_RTOL * g_64.abs()
    done = row_sweeps < int(sweeps)
    parts = []
    for name, rows in (("done", done), ("stalled", (row_exit > 0) & ~done),
                       ("never", row_exit == 0)):
        n = int(rows.sum())
        if n == 0:
            parts.append(f"{name} 0 rows")
            continue
        k, p, c, s = g_k[rows], g_32[rows], g_64[rows], scale[rows]
        parts.append(
            f"{name} {n} rows: kernel vs f64 {float((k - c).abs().max()):.3e} "
            f"(tolerance share {float(((k - c).abs() / s).max()):.3f}), "
            f"f32 plain vs f64 {float((p - c).abs().max()):.3e} (share "
            f"{float(((p - c).abs() / s).max()):.3f}), kernel vs f32 plain "
            f"{float((k - p).abs().max()):.3e}")
    return "; ".join(parts)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = parser.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = LDAConfig(number_of_topics=K, inference_mode="vb",
                    inner_iterations=50, convergence_threshold=1e-5, seed=0)
    kw = dict(inner_iterations=50, convergence_threshold=1e-5, eps=cfg.eps,
              stall_patience=cfg.estep_stall_patience)
    atol = 5e-4 + K * cfg.convergence_threshold
    for seed in args.seeds:
        for V in (10_000, 4096):
            corpus, beta, _ = synthetic_corpus(
                num_docs=D, num_topics=K, num_types=V,
                mean_doc_length=MEAN_LEN, seed=seed)
            lam = (1.0 / V + beta * (corpus.num_tokens / K)).astype(np.float32)
            eng = VariationalBayes(cfg, device=dev)
            eng.initialize(corpus, lam_init=lam)
            eeb = exp_dirichlet_expectation_fast(eng.state.lam)
            alpha = eng.state.alpha
            for i, b in enumerate(eng._batches):
                if V == 4096:
                    x = b.counts
                    g0 = torch.ones((x.shape[0], K), device=dev)
                    row_exit = torch.zeros((x.shape[0],), dtype=torch.int32,
                                           device=dev)
                    row_sweeps = torch.zeros_like(row_exit)
                    g_k, _, _, s_k = dense_mod.dense_estep(
                        x, g0, eeb, alpha, row_exit_out=row_exit,
                        row_sweeps_out=row_sweeps, **kw)
                    g_32 = estep_dense(x, g0, eeb, alpha, **kw)[0]
                    g_64 = estep_dense(x.double(), g0.double(), eeb.double(),
                                       alpha.double(), **kw)[0]
                    label = f"dense batch {tuple(x.shape)}"
                else:
                    g0 = torch.ones((b.ids.shape[0], K), device=dev)
                    row_exit = torch.zeros((b.ids.shape[0],),
                                           dtype=torch.int32, device=dev)
                    row_sweeps = torch.zeros_like(row_exit)
                    g_k, s_k = ragged_mod.ragged_gamma(
                        b.ids, b.cnts, g0, eeb, alpha, row_exit_out=row_exit,
                        row_sweeps_out=row_sweeps, **kw)
                    g_32 = estep_ragged_gamma(b.ids, b.cnts, g0, eeb, alpha,
                                              **kw)[0]
                    g_64 = estep_ragged_gamma(b.ids, b.cnts.double(),
                                              g0.double(), eeb.double(),
                                              alpha.double(), **kw)[0]
                    label = f"ragged bucket {i} {tuple(b.ids.shape)}"
                torch.cuda.synchronize()
                text = split_errors(g_k, g_32, g_64, row_exit, row_sweeps, s_k,
                                    atol)
                print(f"seed {seed}, {label}, S* {int(s_k)}: {text}")
            del eng, eeb, alpha


if __name__ == "__main__":
    main()
