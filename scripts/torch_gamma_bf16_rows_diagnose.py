"""Sweep-by-sweep trajectories of the bf16 row-resident gamma kernel
against its plain version, on one input whose widest row is one entry past
a warp group's capacity.

    PYTHONPATH=. python scripts/torch_gamma_bf16_rows_diagnose.py [--sweeps 50]

On one CUDA card.  The input is ``tests/test_torch_kernels_gpu.py``'s
``_group_inputs(128, True, dev, "dense")``: 27 rows of 0 to 193 live
entries (three each of 0, 1, 15, 16, 17, 31, 32, 33, 192 and 193; numpy
seed 141 for the rows, 128 for lambda and gamma0), V = 3000, bf16 counts,
K = 128, alpha 1 / K.  Its widest row, 193 entries, is one past
``row_fixed_point.group_capacity(128)``, so the launch takes the bf16
row-resident kernel of ``csrc/row_fixed_point.cuh`` ("rows").

First the exit rule (50 sweeps, threshold 1e-5, patience 6): each row's
share of the bound (``ops/estep.py::ragged_doc_bound``) at the kernel's
gamma, the plain version's (``estep_dense``, bf16 operands, float32) and
the float64 plain version's; S* of each; the rows ranked by the kernel's
share gap.  Then, at pinned sweeps n = 1 .. ``--sweeps`` from gamma0, for
the rows of largest gap: the largest relative difference of the kernel's
gamma from the float32 plain version's (``traj``), of the float32 plain
version's from the float64 one's (``p32``), of the kernel's from the
float64 one's (``k64``), and ``step``: the kernel's gamma after n sweeps
against one plain sweep from the kernel's own gamma after n - 1 (the
one-sweep bf16 hold along the kernel's trajectory: at most 5% of the live
rows past 1e-5 relative, none past 2^-7).  If ``step`` holds at every
sweep, the kernel computes the bf16 map at every state it visits, and the
trajectories part only where a ratio's rounding flips; if it fails at a
sweep, a rounding point or a summation order of the kernel differs from
the plain version's there.  Ends with a JSON line of the per-sweep
numbers.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from pylda_tpu_torch.ops import dense_estep as dense_mod
from pylda_tpu_torch.ops import row_fixed_point as rfp
from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation
from pylda_tpu_torch.ops.estep import estep_dense, ragged_doc_bound

BF16 = "bfloat16"
K = 128
LIVE = (0, 1, 15, 16, 17, 31, 32, 33)
EXIT = dict(inner_iterations=50, convergence_threshold=1e-5,
            stall_patience=6)


def inputs(dev):
    """The test's ``_group_inputs(128, True, dev, "dense")``."""
    rng = np.random.default_rng(13 + K)
    cap = rfp.group_capacity(K)
    live = [n for n in (*LIVE, cap, cap + 1) for _ in range(3)]
    rng.shuffle(live)
    D, T, V = len(live), max(live), 3000
    ids = np.zeros((D, T), np.int32)
    cnts = np.zeros((D, T), np.float32)
    for d, n in enumerate(live):
        at = np.sort(rng.choice(T, n, replace=False))
        ids[d, at] = rng.choice(V, n, replace=False)
        cnts[d, at] = rng.integers(1, 4, n)
    rng = np.random.default_rng(K)
    lam = rng.gamma(0.1, 1.0, (K, V)) * 100.0 + 0.01
    eeb = exp_dirichlet_expectation(torch.tensor(lam, device=dev).float())
    g0 = torch.tensor(rng.gamma(100.0, 0.01, (D, K)), dtype=torch.float32,
                      device=dev)
    alpha = torch.full((K,), 1.0 / K, dtype=torch.float32, device=dev)
    counts = np.zeros((D, V), np.float32)
    for d in range(D):
        on = cnts[d] != 0
        counts[d, ids[d, on]] = cnts[d, on]
    ct = torch.tensor(counts, device=dev).to(torch.bfloat16)
    return ct, g0, eeb, alpha, np.array(live)


def entries(ct):
    width = int((ct != 0).sum(dim=1).max())
    order = torch.sort((ct != 0).to(torch.uint8), dim=1, descending=True,
                       stable=True).indices[:, :width]
    return order.to(torch.int32), ct.gather(1, order).float()


def shares(ids, cnts, g, eeb, alpha):
    return ragged_doc_bound(ids, cnts.double(), g.double(), eeb.double(),
                            alpha.double())


def rel(a, b):
    """Each row's largest relative difference of a from b."""
    return ((a.double() - b.double()).abs() / b.double().abs()).amax(dim=1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweeps", type=int, default=50)
    ap.add_argument("--rows", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    ct, g0, eeb, alpha, live = inputs(dev)
    nmax = int(live.max())

    def kernel(g, **kw):
        geo = {}
        g, _, _, s = dense_mod.dense_estep(ct, g, eeb, alpha, **kw,
                                           compute_dtype=BF16, max_nnz=nmax,
                                           geometry_out=geo)
        return g, int(s), geo["route"]

    def plain(g, dtype=torch.float32, **kw):
        c = ct if dtype == torch.float32 else ct.double()
        g, _, _, s = estep_dense(c, g.to(dtype), eeb.to(dtype),
                                 alpha.to(dtype), **kw, compute_dtype=BF16)
        return g, int(s)

    ids, cnts = entries(ct)
    on = (cnts != 0).any(dim=1)
    g_k, s_k, route = kernel(g0, **EXIT)
    g_p, s_p = plain(g0, **EXIT)
    g_64, s_64 = plain(g0, torch.float64, **EXIT)
    b64 = shares(ids, cnts, g_64, eeb, alpha)
    gap_k = ((shares(ids, cnts, g_k, eeb, alpha) - b64).abs() / b64.abs())
    gap_p = ((shares(ids, cnts, g_p, eeb, alpha) - b64).abs() / b64.abs())
    gap_k[~on], gap_p[~on] = 0, 0
    bar = max(2e-4, 2.0 * float(gap_p.max()))
    worst = torch.argsort(gap_k, descending=True)[:args.rows].tolist()
    print(f"device: {torch.cuda.get_device_name(0)}; route {route}; "
          f"widest row {nmax} (group capacity {rfp.group_capacity(K)})")
    print(f"exit rule: S* kernel {s_k}, plain f32 {s_p}, plain f64 {s_64}; "
          f"share gap vs f64: kernel {float(gap_k.max()):.4e}, plain f32 "
          f"{float(gap_p.max()):.4e}, bar {bar:.4e} "
          f"{'ok' if float(gap_k.max()) <= bar else 'FAIL'}")
    for r in worst:
        print(f"  row {r}: {int((cnts[r] != 0).sum())} live entries, share "
              f"gap kernel {float(gap_k[r]):.4e}, plain f32 "
              f"{float(gap_p[r]):.4e}")
    pin = dict(convergence_threshold=0.0)
    prev = g0
    out = []
    for n in range(1, args.sweeps + 1):
        gk, _, _ = kernel(g0, inner_iterations=n, **pin)
        gp, _ = plain(g0, inner_iterations=n, **pin)
        g6, _ = plain(g0, torch.float64, inner_iterations=n, **pin)
        gs, _ = plain(prev, inner_iterations=1, **pin)
        step = rel(gk, gs)[on]
        step_ok = (float((step > 1e-5).double().mean()) <= 0.05
                   and float(step.max()) <= 2.0 ** -7)
        row = {"sweep": n,
               "step_max": float(step.max()),
               "step_share_past_1e-5": float((step > 1e-5).double().mean()),
               "step_ok": step_ok,
               "traj_max": float(rel(gk, gp)[on].max()),
               "rows": {str(r): {"traj": float(rel(gk, gp)[r]),
                                 "p32": float(rel(gp, g6)[r]),
                                 "k64": float(rel(gk, g6)[r]),
                                 "step": float(rel(gk, gs)[r])}
                        for r in worst}}
        out.append(row)
        print(f"sweep {n:2d}: step max {row['step_max']:.3e} "
              f"(past 1e-5 {row['step_share_past_1e-5']:.3f}) "
              f"{'ok' if step_ok else 'FAIL'}; traj max "
              f"{row['traj_max']:.3e}; "
              + "; ".join(f"r{r} traj {v['traj']:.2e} p32 {v['p32']:.2e} "
                          f"k64 {v['k64']:.2e} step {v['step']:.2e}"
                          for r, v in row["rows"].items()))
        prev = gk
    print(json.dumps({"route": route, "s_star": [s_k, s_p, s_64],
                      "gap": [float(gap_k.max()), float(gap_p.max())],
                      "bar": bar, "worst": worst, "sweeps": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
