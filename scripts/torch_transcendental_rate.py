#!/usr/bin/env python
"""Elementwise transcendental rates of PyTorch on one CUDA card.

The port's roofline (``pylda_tpu_torch/utils/roofline.py``) prices the
Griffiths-Steyvers joint likelihood (lgamma over the [K, V] topic table
and the [rows, K] document tables) and the topic-side bound term
``beta_elbo`` (lgamma over [K, V]) by elements a second.  This script
measures those rates on the card: each function runs over a [K, V]
float32 block of values in [0.5, 500) and is reduced to a scalar, timed
with CUDA events over ``n`` calls after two warm ones, best of three.
The rate is elements * n / time.  ``lgamma`` is the best of
``torch.lgamma`` and the port's ``gammaln_fast`` (the engines call both),
so the roofline's rate is the fastest way the card was seen to do it.
The roofline carries the results rounded UP: a rate set too high only
loosens the bound.

Usage (on the card): PYTHONPATH=. python scripts/torch_transcendental_rate.py [--k 1000 --v 100000 --n 32]
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch


def rate(fn, x: torch.Tensor, n: int, repeats: int = 3) -> float:
    """Elements a second of ``fn(x).sum()``, best of ``repeats`` runs of
    ``n`` calls each, timed by CUDA events."""
    fn(x).sum()
    fn(x).sum()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn(x).sum()
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop) / 1e3)
    return x.numel() * n / best


def main() -> int:
    from pylda_tpu_torch.ops.dirichlet import digamma_fast, gammaln_fast

    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=1000)
    ap.add_argument("--v", type=int, default=100_000)
    ap.add_argument("--n", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_transcendental_rate: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"nvidia-smi: {smi}")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((args.k, args.v), generator=g, device="cuda") * 499.5 + 0.5
    out = {}
    for name, fn in (
        ("torch.lgamma", torch.lgamma),
        ("gammaln_fast", gammaln_fast),
        ("log", torch.log),
        ("exp", torch.exp),
        ("torch.digamma", torch.digamma),
        ("digamma_fast", digamma_fast),
    ):
        out[name] = rate(fn, x, args.n)
        print(json.dumps({name: float(f"{out[name]:.4g}")}), flush=True)
    summary = {
        "lgamma_per_sec": max(out["torch.lgamma"], out["gammaln_fast"]),
        "log_per_sec": out["log"],
        "exp_per_sec": out["exp"],
        "digamma_per_sec": max(out["torch.digamma"], out["digamma_fast"]),
    }
    print(json.dumps({k: float(f"{v:.4g}") for k, v in summary.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
