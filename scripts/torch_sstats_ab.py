"""Times the dense sufficient-statistics kernel against an older build of it,
in turns, at the flagship shapes.

    PYTHONPATH=. python scripts/torch_sstats_ab.py --old OLD/dense_sstats.cu

On one CUDA card.  ``--old`` is an earlier ``csrc/dense_sstats.cu`` with
the dense-form kernel's C interface (``pylda_dense_sstats(counts,
counts_bf16, et, eeb, sstats, score_part, D, Vc, V, K, eps, stream)`` into
a zeroed sstats, and ``pylda_dense_sstats_blocks(Vc)``), e.g. one
unpacked from an older commit with ``git archive`` under ``build/``; the
script compiles it with the package's nvcc flags into
``build/sstats_ab/``.  Both calls are timed whole (allocations and the
score's sum included), CUDA-event means of warm calls, in the order old,
new, new, old, on:

- the ragged flagship's counts chunk: the [4096, 10240] bf16 chunk the
  engine plans for the synthetic corpus (K=100, V=10,000, mean document
  length 120, seed 0);
- the dense flagship's batch: the [4096, 4096] bf16 counts of the same
  corpus at V=4096 (the dense E-step's final pass).

expEtheta comes from a seeded random gamma; the timing depends on the
counts' pattern, not on its values.  With ``--variants`` it also times
the new kernel under other plans (chunks a row split).  Prints the
card's name and power limit first, then one line per timing, the two
kernels' largest difference and whether two calls of the new one gave the
same bits.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import time

import numpy as np
import torch

from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.models import VariationalBayes
from pylda_tpu_torch.ops import _build
from pylda_tpu_torch.ops import sstats as sstats_mod
from pylda_tpu_torch.ops.dirichlet import (
    exp_dirichlet_expectation,
    exp_dirichlet_expectation_fast,
)
from pylda_tpu_torch.utils.config import LDAConfig

K = 100


def cuda_ms(fn, reps: int) -> float:
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


def kernel_ms(fn, reps: int) -> float:
    """Mean device time of the kernels named *dense_sstats_kernel* a call,
    from torch.profiler (the wrapper's other work excluded)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if "dense_sstats_kernel" in e.key)
    return us / 1e3 / reps


def host_ms(fn, reps: int) -> float:
    """Host milliseconds a call takes to enqueue (no synchronisation)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / reps


def old_kernel(source: pathlib.Path):
    """A call of the older kernel, as its wrapper made it."""
    out = _build.BUILD_DIR.parent / "sstats_ab" / "libdense_sstats_old.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(source)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pylda_dense_sstats.argtypes = [p, i, p, p, p, p, i, i, i, i,
                                       ctypes.c_float, p]
    lib.pylda_dense_sstats.restype = i
    lib.pylda_dense_sstats_blocks.argtypes = [i]
    lib.pylda_dense_sstats_blocks.restype = i

    def call(counts, et, eeb, eps=1e-30):
        D, Vc = counts.shape
        Kk, V = eeb.shape
        sstats = torch.zeros((Kk, V), dtype=torch.float32, device=counts.device)
        parts = torch.empty((lib.pylda_dense_sstats_blocks(Vc),),
                            dtype=torch.float64, device=counts.device)
        rc = lib.pylda_dense_sstats(
            counts.data_ptr(), int(counts.dtype == torch.bfloat16),
            et.data_ptr(), eeb.data_ptr(), sstats.data_ptr(),
            parts.data_ptr(), D, Vc, V, Kk, float(eps),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"old kernel launch failed: cudaError {rc}")
        return sstats, parts.sum().to(torch.float32)

    return call


def flagship_counts(V: int, dev) -> tuple:
    """(counts, eeb): the engine's counts block at vocabulary V and a
    sharpened expElogbeta."""
    corpus, beta, _ = synthetic_corpus(num_docs=4096, num_topics=K,
                                       num_types=V, mean_doc_length=120.0,
                                       seed=0)
    cfg = LDAConfig(number_of_topics=K, inference_mode="vb", seed=0)
    lam = (1.0 / V + beta * (corpus.num_tokens / K)).astype(np.float32)
    eng = VariationalBayes(cfg, device=dev)
    eng.initialize(corpus, lam_init=lam)
    if eng._sstats_plan is not None:
        counts = eng._sstats_plan.chunks[0][0]
    else:
        counts = eng._batches[0].counts
    return counts, exp_dirichlet_expectation_fast(eng.state.lam)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=pathlib.Path, required=True)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda", 0)
    old = old_kernel(args.old)
    new = sstats_mod.dense_sstats
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    for label, V in (("ragged flagship chunk", 10_000),
                     ("dense flagship final pass", 4096)):
        counts, eeb = flagship_counts(V, dev)
        D = counts.shape[0]
        gamma = torch.tensor(rng.gamma(100.0, 0.01, (D, K)), device=dev)
        et = exp_dirichlet_expectation(gamma.float())
        nnz = int((counts != 0).sum())
        ss_o, tok_o = old(counts, et, eeb)
        ss_n, tok_n = new(counts, et, eeb)
        ss_n2, tok_n2 = new(counts, et, eeb)
        torch.cuda.synchronize()
        same = torch.equal(ss_n, ss_n2) and torch.equal(tok_n, tok_n2)
        rel = float((ss_n - ss_o).abs().max() / ss_o.abs().max())
        times = []
        for name, fn in (("old", old), ("new", new), ("new", new),
                         ("old", old)):
            times.append((name, cuda_ms(lambda: fn(counts, et, eeb),
                                        args.reps)))
        print(f"{label} [{D}x{counts.shape[1]} {str(counts.dtype)[6:]}, "
              f"K={K}, nonzeros {nnz}]: " + ", ".join(
                  f"{n} {t:.4f} ms" for n, t in times)
              + f"; new vs old max|diff|/max|old| {rel:.3e}, score "
              f"{float(tok_n):.6e} vs {float(tok_o):.6e}; new bitwise "
              f"repeatable {same}")
        for name, fn in (("old", old), ("new", new)):
            print(f"  {name}: kernel alone {kernel_ms(lambda: fn(counts, et, eeb), 20):.4f} ms "
                  f"(torch.profiler), host enqueue "
                  f"{host_ms(lambda: fn(counts, et, eeb), args.reps):.4f} ms a call")
        if args.variants:
            default = sstats_mod.CHUNKS_PER_SPLIT
            for per_split in (8, 16, 20, 26, 32, 48, 64, 128):
                sstats_mod.CHUNKS_PER_SPLIT = per_split
                pl = sstats_mod.plan(D, counts.shape[1], K, sms)
                t = cuda_ms(lambda: new(counts, et, eeb), args.reps)
                print(f"  variant chunks_per_split {per_split} (splits "
                      f"{pl.splits}, CTAs {pl.blocks}): {t:.4f} ms")
            sstats_mod.CHUNKS_PER_SPLIT = default
        del counts, eeb, et, ss_o, ss_n, ss_n2


if __name__ == "__main__":
    main()
