"""How far the gamma kernels' bf16 builds, and their float32 plain version
with the same rounding points, land from the float64 plain version, on
the card.

    PYTHONPATH=. python scripts/torch_bf16_bound_gaps.py

For each input (the bf16 cases of tests/test_torch_kernels_gpu.py: ragged
rows at K in {100, 1000, 4096} and dense rows at K in {16, 100, 257, 1000,
4096}, sharp lambdas), in float32 and in bf16 mode, at the exit rule (50
sweeps, threshold 1e-5, patience 6) and at 50 and 12 pinned sweeps: each
live row's share of the bound (``ops/estep.py::ragged_doc_bound``, in
float64) at the kernel's gamma and at the float32 plain version's gamma,
against its share at the float64 plain version's gamma: the largest
relative gap, the largest gap a token, and the worst row.  The bf16 lines
show how far any float32 code with the bf16 rounding points drifts once
the bf16 map limit-cycles: the bar of the kernels' bf16 tests
(``_hold_bf16_shares``) and of ``chip_smoke.py`` rests on them.  Prints
the card's name and power limit first.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from pylda_tpu_torch.ops import dense_estep as dense_mod
from pylda_tpu_torch.ops import ragged as ragged_mod
from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation
from pylda_tpu_torch.ops.estep import (
    estep_dense,
    estep_ragged_gamma,
    ragged_doc_bound,
)

SETTINGS = {
    "exit rule": dict(inner_iterations=50, convergence_threshold=1e-5,
                      stall_patience=6),
    "50 pinned": dict(inner_iterations=50, convergence_threshold=0.0),
    "12 pinned": dict(inner_iterations=12, convergence_threshold=0.0),
}


def sharp_eeb(rng, K, V, dev):
    lam = rng.gamma(0.1, 1.0, (K, V)) * 100.0 + 0.01
    return exp_dirichlet_expectation(torch.tensor(lam, device=dev).float())


def ragged_case(K, T, dev, seed=11):
    """40 rows of 1 to T live slots (one full row)."""
    rng = np.random.default_rng(seed)
    D, V = 40, 3000
    ids = rng.integers(0, V, (D, T)).astype(np.int32)
    cnts = rng.integers(1, 4, (D, T)).astype(np.float32)
    pad = np.arange(T)[None, :] >= rng.integers(1, T + 1, D)[:, None]
    pad[0] = False
    ids[pad], cnts[pad] = 0, 0.0
    ids = torch.tensor(ids, device=dev)
    cnts = torch.tensor(cnts, device=dev)
    eeb = sharp_eeb(rng, K, V, dev)
    g0 = torch.ones((D, K), device=dev)
    alpha = torch.full((K,), 1.0 / K, device=dev)

    def run(kind, mode, kw):
        if kind == "kernel":
            return ragged_mod.ragged_gamma(ids, cnts, g0, eeb, alpha,
                                           compute_dtype=mode, **kw)[0]
        dt = torch.float64 if kind == "f64" else torch.float32
        return estep_ragged_gamma(ids, cnts.to(dt), g0.to(dt), eeb.to(dt),
                                  alpha.to(dt), compute_dtype=mode, **kw)[0]

    return ids, cnts, eeb, alpha, run


def dense_case(D, V, K, bf16, dmax, dev):
    rng = np.random.default_rng(K)
    counts = ((rng.random((D, V)) < rng.uniform(0.01, dmax, (D, 1)))
              * rng.integers(1, 4, (D, V))).astype(np.float32)
    counts[0] = 0.0
    counts[0, :3] = 2.0
    ct = torch.tensor(counts, device=dev)
    ct = ct.to(torch.bfloat16) if bf16 else ct
    eeb = sharp_eeb(rng, K, V, dev)
    g0 = torch.ones((D, K), device=dev)
    alpha = torch.full((K,), 1.0 / K, device=dev)
    nnz = (ct != 0).sum(dim=1)
    order = torch.sort((ct != 0).to(torch.uint8), dim=1, descending=True,
                       stable=True).indices[:, :int(nnz.max())]

    def run(kind, mode, kw):
        if kind == "kernel":
            return dense_mod.dense_estep(ct, g0, eeb, alpha,
                                         compute_dtype=mode, **kw)[0]
        dt = torch.float64 if kind == "f64" else torch.float32
        c = ct if dt == torch.float32 else ct.double()
        return estep_dense(c, g0.to(dt), eeb.to(dt), alpha.to(dt),
                           compute_dtype=mode, **kw)[0]

    return (order.to(torch.int32), ct.gather(1, order).float(), eeb, alpha,
            run)


def report(label, ids, cnts, eeb, alpha, run) -> None:
    live = (cnts != 0).any(dim=1)
    ids, cnts = ids[live], cnts[live].double()
    e64, a64 = eeb.double(), alpha.double()
    tokens = cnts.sum(dim=1)
    for mode in ("float32", "bfloat16"):
        for name, kw in SETTINGS.items():
            b = {kind: ragged_doc_bound(ids, cnts, run(kind, mode, kw)[live]
                                        .double(), e64, a64)
                 for kind in ("kernel", "plain", "f64")}
            gap = {k: (b[k] - b["f64"]).abs() for k in ("kernel", "plain")}
            rel = {k: gap[k] / b["f64"].abs() for k in gap}
            i = int(rel["kernel"].argmax())
            print(f"{label} {mode} {name}: share rel gap kernel "
                  f"{float(rel['kernel'].max()):.3e} plain "
                  f"{float(rel['plain'].max()):.3e}; a token kernel "
                  f"{float((gap['kernel'] / tokens).max()):.3e} plain "
                  f"{float((gap['plain'] / tokens).max()):.3e}; worst row "
                  f"{float(tokens[i]):.0f} tokens, share "
                  f"{float(b['f64'][i]):.4e}", flush=True)


def main() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for K, T in ((100, 120), (1000, 160), (4096, 24)):
        report(f"ragged K={K} T={T}", *ragged_case(K, T, dev))
    for D, V, K, bf16, dmax in ((60, 4000, 16, True, 0.5),
                                (60, 3000, 100, False, 0.2),
                                (60, 3000, 257, True, 0.2),
                                (40, 1500, 1000, False, 0.2),
                                (24, 600, 4096, True, 0.2)):
        report(f"dense K={K} V={V}", *dense_case(D, V, K, bf16, dmax, dev))


if __name__ == "__main__":
    main()
