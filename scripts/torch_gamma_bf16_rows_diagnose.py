"""Sweep-by-sweep trajectories of the bf16 row-resident gamma kernel
against its plain version, on one input whose widest row is one entry past
a warp group's capacity.

    PYTHONPATH=. python scripts/torch_gamma_bf16_rows_diagnose.py [--sweeps 50]
    PYTHONPATH=. python scripts/torch_gamma_bf16_rows_diagnose.py --cases

On one CUDA card.  The input is ``tests/test_torch_kernels_gpu.py``'s
``_group_inputs(128, True, dev, "dense")``: 27 rows of 0 to 193 live
entries (three each of 0, 1, 15, 16, 17, 31, 32, 33, 192 and 193; numpy
seed 141 for the rows, 128 for lambda and gamma0), V = 3000, bf16 counts,
K = 128, alpha 1 / K.  Its widest row, 193 entries, is one past
``row_fixed_point.group_capacity(128)``, so the launch takes the bf16
row-resident kernel of ``csrc/row_fixed_point.cuh`` ("rows").

First the exit rule (50 sweeps, threshold 1e-5, patience 6): each row's
share of the bound (``ops/estep.py::ragged_doc_bound``) at the kernel's
gamma, the plain version's (``estep_dense``, bf16 operands, float32), the
JAX package's (``pylda_tpu/ops/estep.py::estep_dense`` in bf16 on the
CPU, run by ``tests/torch_jax_gamma.py`` in a process of its own: this
script imports no JAX) and the float64 plain version's; S* of each; the
share gaps from float64 of the kernel, the plain version and the JAX
package, the bar without the JAX package (twice the plain version's gap,
at least 2e-4), and the rows ranked by the kernel's share gap, each with
its bar with the JAX package were it still moving at the cap (that bar
or twice the JAX package's gap on the row, whichever is larger: the rule
of ``tests/test_torch_kernels_gpu.py::test_group_kernel_matches_plain``).
Then, at pinned sweeps n = 1 .. ``--sweeps`` from gamma0, for the rows of
largest gap: the largest relative difference of the kernel's
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

``--cases`` instead runs every case of ``test_group_kernel_matches_plain``
(each layout, K in ``GROUP_K``, rows up to and past a group's capacity;
its helpers imported from ``tests/test_torch_kernels_gpu.py``) through
the exit rule and prints, a case a line, the share gaps from float64 of
the kernel, the float32 plain version and the JAX package, the rows the
plain version's loop still sweeps at the cap (``moving``: its pinned
trajectory through the test's ``_exit_record``), the bar without the JAX
package (2e-4 or twice the plain version's gap) and the largest bar on a
moving row with it (twice the JAX package's gap on that row, at least the
other), and whether the kernel holds under each.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

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


REPO = pathlib.Path(__file__).resolve().parent.parent
WORK = REPO / "build" / "gamma_bf16_rows_diagnose"


def host(t):
    return t.detach().float().cpu().numpy()


def jax_gammas(jobs, dev):
    """The JAX package's bf16 gamma of the exit rule on the CPU for each
    job (the inputs of ``tests/torch_jax_gamma.py`` as a dict), from that
    file in one process of its own."""
    WORK.mkdir(parents=True, exist_ok=True)
    argv = []
    for i, job in enumerate(jobs):
        np.savez(WORK / f"inputs{i}.npz", **job, **EXIT)
        argv += [str(WORK / f"inputs{i}.npz"), str(WORK / f"gamma{i}.npz")]
    subprocess.run([sys.executable, str(REPO / "tests" / "torch_jax_gamma.py"),
                    *argv], check=True, cwd=REPO)
    return [torch.as_tensor(np.load(WORK / f"gamma{i}.npz")["gamma"],
                            device=dev) for i in range(len(jobs))]


def jax_gamma(ct, g0, eeb, alpha):
    """The JAX package's bf16 gamma of the exit rule on the CPU."""
    return jax_gammas([dict(counts=host(ct), gamma0=host(g0), eeb=host(eeb),
                            alpha=host(alpha))], g0.device)[0]


def cases(dev) -> int:
    """Every case of test_group_kernel_matches_plain: its gaps and bars."""
    sys.path.insert(0, str(REPO / "tests"))
    import test_torch_kernels_gpu as T

    runs, jobs = [], []
    for layout in ("ragged", "dense"):
        for K_ in T.GROUP_K:
            for past in (False, True):
                rows, g0, eeb, alpha, live = T._group_inputs(K_, past, dev,
                                                            layout)
                D = g0.shape[0]
                seg = (D // 3, D - D // 3) if layout == "ragged" else None
                g, _ = T._group_call(layout, rows, g0, eeb, alpha, live,
                                     EXIT, seg)
                g_p, _ = T._plain_call(layout, rows, g0, eeb, alpha, EXIT,
                                       seg)
                rows_64 = rows[:-1] + (rows[-1].double(),)
                g_64, _ = T._plain_call(layout, rows_64, g0.double(),
                                        eeb.double(), alpha.double(), EXIT,
                                        seg)
                pin = dict(inner_iterations=1, convergence_threshold=0.0)
                traj = [g0]
                for _ in range(EXIT["inner_iterations"]):
                    traj.append(T._plain_call(layout, rows, traj[-1], eeb,
                                              alpha, pin, seg)[0])
                moving = torch.zeros((D,), dtype=torch.bool, device=dev)
                r0 = 0
                for n in seg or (D,):
                    part = slice(r0, r0 + n)
                    _, _, sweeps, _ = T._exit_record(
                        [t[part] for t in traj], EXIT)
                    moving[part] = sweeps == EXIT["inner_iterations"]
                    r0 += n
                job = dict(gamma0=host(g0), eeb=host(eeb), alpha=host(alpha))
                if layout == "ragged":
                    job.update(ids=rows[0].cpu().numpy(), cnts=host(rows[1]),
                               segments=np.array(seg))
                else:
                    job.update(counts=host(rows[0]))
                jobs.append(job)
                runs.append((f"{layout}-{K_}-{'past' if past else 'capacity'}",
                             rows, layout, g, g_p, g_64, eeb, alpha, moving))
    torch.cuda.synchronize()
    g_js = jax_gammas(jobs, dev)
    out = []
    for (name, rows, layout, g, g_p, g_64, eeb, alpha, moving), g_j in zip(
            runs, g_js):
        ids, cnts = T._entries(layout, rows)
        live = (cnts != 0).any(dim=1)
        gk, gp, gj = (T._share_gaps(ids, cnts, x, g_64, eeb, alpha)
                      for x in (g, g_p, g_j))
        bar = max(2e-4, 2.0 * float(gp.max()))
        allow = torch.where(moving[live], torch.clamp(2.0 * gj, min=bar),
                            torch.full_like(gk, bar))
        mv = moving[live]
        row = {"case": name, "kernel": float(gk.max()),
               "plain": float(gp.max()), "jax": float(gj.max()),
               "moving": int(mv.sum()), "live": int(live.sum()),
               "bar": bar, "bar_moving_with_jax": float(allow[mv].max())
               if bool(mv.any()) else bar,
               "holds_without_jax": float(gk.max()) <= bar,
               "holds_with_jax": bool((gk <= allow).all())}
        out.append(row)
        print(f"{name}: gap kernel {row['kernel']:.4e}, plain f32 "
              f"{row['plain']:.4e}, JAX {row['jax']:.4e}; moving rows "
              f"{row['moving']} of {row['live']} live; bar {bar:.4e} "
              f"({'ok' if row['holds_without_jax'] else 'FAIL'}), on a "
              f"moving row with JAX at most {row['bar_moving_with_jax']:.4e}"
              f" ({'ok' if row['holds_with_jax'] else 'FAIL'})", flush=True)
    print(json.dumps({"cases": out}))
    return 0


def rel(a, b):
    """Each row's largest relative difference of a from b."""
    return ((a.double() - b.double()).abs() / b.double().abs()).amax(dim=1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweeps", type=int, default=50)
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--cases", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.cases:
        return cases(dev)
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
    g_j = jax_gamma(ct, g0, eeb, alpha)
    b64 = shares(ids, cnts, g_64, eeb, alpha)
    gap_k = ((shares(ids, cnts, g_k, eeb, alpha) - b64).abs() / b64.abs())
    gap_p = ((shares(ids, cnts, g_p, eeb, alpha) - b64).abs() / b64.abs())
    gap_j = ((shares(ids, cnts, g_j, eeb, alpha) - b64).abs() / b64.abs())
    gap_k[~on], gap_p[~on], gap_j[~on] = 0, 0, 0
    bar = max(2e-4, 2.0 * float(gap_p.max()))
    worst = torch.argsort(gap_k, descending=True)[:args.rows].tolist()
    print(f"device: {torch.cuda.get_device_name(0)}; route {route}; "
          f"widest row {nmax} (group capacity {rfp.group_capacity(K)})")
    print(f"exit rule: S* kernel {s_k}, plain f32 {s_p}, plain f64 {s_64}; "
          f"share gap vs f64: kernel {float(gap_k.max()):.4e}, plain f32 "
          f"{float(gap_p.max()):.4e}, JAX {float(gap_j.max()):.4e}; bar "
          f"without JAX {bar:.4e} "
          f"{'ok' if float(gap_k.max()) <= bar else 'FAIL'}")
    for r in worst:
        bar_r = max(bar, 2.0 * float(gap_j[r]))
        print(f"  row {r}: {int((cnts[r] != 0).sum())} live entries, share "
              f"gap kernel {float(gap_k[r]):.4e}, plain f32 "
              f"{float(gap_p[r]):.4e}, JAX {float(gap_j[r]):.4e}; its bar "
              f"with JAX (a row still moving at the cap) {bar_r:.4e} "
              f"{'ok' if float(gap_k[r]) <= bar_r else 'FAIL'}")
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
                      "gap": [float(gap_k.max()), float(gap_p.max()),
                              float(gap_j.max())],
                      "bar": bar, "worst": worst,
                      "sweeps": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
