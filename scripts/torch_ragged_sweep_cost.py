"""Per-sweep cost of the ragged gamma kernel on one CUDA card.

    PYTHONPATH=. python scripts/torch_ragged_sweep_cost.py

Times ``pylda_tpu_torch.ops.ragged.ragged_gamma`` (CUDA events, warm,
threshold 0 so every call runs exactly ``inner`` sweeps) on random
buckets of several row counts and widths at K=100, V=10,000, at 1 and 51
sweeps; the difference over 50 is the cost of one sweep, the rest the
fixed cost of a call (the kernel gathers each row's B rows once a call
and reads them twice a sweep, from registers in buckets of width <= 128,
else from shared memory).  Prints one line per shape, with the rate of
those B operand reads, and the card's name and power limit.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from pylda_tpu_torch.ops import ragged
from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation


def timed_ms(fn, reps=20):
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


def main():
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {smi}")
    K, V = 100, 10_000
    rng = np.random.default_rng(0)
    lam = torch.tensor(rng.gamma(1.0, 1.0, (K, V)), device=dev).float()
    eeb = exp_dirichlet_expectation(lam)
    table = ragged.gather_table(eeb)
    alpha = torch.full((K,), 0.01, device=dev)
    # 264 rows is one row a block at K=100, T <= 128 (2 blocks an SM with
    # the register tile x 132 SMs); 396 at T=160 (3 blocks an SM).
    for D, T in ((8, 16), (8, 160), (64, 16), (64, 160), (528, 128),
                 (1056, 128), (1344, 112), (2176, 128), (4224, 128)):
        ids = torch.tensor(rng.integers(0, V, (D, T)), dtype=torch.int32,
                           device=dev)
        cnts = torch.ones((D, T), device=dev)
        g0 = torch.ones((D, K), device=dev)
        ms = {}
        for inner in (1, 51):
            ms[inner] = timed_ms(lambda: ragged.ragged_gamma(
                ids, cnts, g0, eeb, alpha, inner_iterations=inner,
                convergence_threshold=0.0, eeb_t=table))
        per_sweep_us = (ms[51] - ms[1]) / 50 * 1e3
        # B rows read twice a sweep (phinorm, then the accumulation).
        gb = 2 * D * T * 4 * table.shape[1] / 1e9
        print(f"D={D:5d} T={T:4d}: call at 1 sweep {ms[1] * 1e3:8.1f} us, "
              f"per sweep {per_sweep_us:7.2f} us, B operand reads "
              f"{gb / (per_sweep_us * 1e-6):7.1f} GB/s")


if __name__ == "__main__":
    main()
