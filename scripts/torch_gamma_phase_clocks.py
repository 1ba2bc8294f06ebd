"""Where a sweep of the row-resident gamma kernels spends its cycles.

    PYTHONPATH=. python scripts/torch_gamma_phase_clocks.py

On one CUDA card: copies ``pylda_tpu_torch/csrc`` into
``build/phase_clocks/``, inserts ``clock64()`` reads into the copy of
``row_fixed_point.cuh`` (the sources in the package are not touched),
builds both kernels from the copy with the package's ``nvcc`` flags, and
runs them on the flagship inputs ``chip_smoke.py`` uses: the ragged
buckets 1 (2176x128) and 3 (64x160) at V=10,000 and the dense batch at
V=4096 (K=100, inner 50, threshold 1e-5, stall patience 6).  For each it
prints the time of the instrumented call and, from thread 0 of every
block, the mean cycles a row-sweep spends in steps A+B (phinorm,
ratio, accumulation), the partial-sum barrier, the block sums and the
rest of step C (fast digamma, exit rule, barrier), and the cycles a row
spends on compaction and gather.  The instrumented libraries are bound
through ``ops/row_fixed_point.py``, as the package's own are.
A block's cycles include those its SM spent on the other blocks it
holds.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.models import VariationalBayes
from pylda_tpu_torch.ops import _build
from pylda_tpu_torch.ops import dense_estep as dense_mod
from pylda_tpu_torch.ops import ragged as ragged_mod
from pylda_tpu_torch.ops import row_fixed_point
from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation_fast
from pylda_tpu_torch.utils.config import LDAConfig

OUT = _build.BUILD_DIR.parent / "phase_clocks"
PHASES = ("A+B", "partial-sum barrier", "block sums", "rest of C")

# (anchor in row_fixed_point.cuh, text put before it)
MARKS = [
    ("namespace {\n\nnamespace cg",
     "__device__ unsigned long long g_clk[8];\n"),
    ("  const int n = compact<CT>(p, L, smem, row);",
     "  long long clk0 = clock64();\n"),
    ("  int s = 0;\n  while (s < max_sweeps) {",
     "  if (tid == 0) {\n"
     "    atomicAdd(&g_clk[4], (unsigned long long)(clock64() - clk0));\n"
     "    atomicAdd(&g_clk[5], 1ull);\n  }\n"),
    ("    float4 acc[kQ];\n",
     "    long long clk1 = clock64();\n"),
    ("    __syncthreads();\n    // C. gamma' = alpha + expEtheta * acc",
     "    long long clk2 = clock64();\n"),
    ("    // C. gamma' = alpha + expEtheta * acc",
     "    long long clk3 = clock64();\n"),
    ("    if (mine) {\n      gam = x;",
     "    long long clk4 = clock64();\n"),
    ("    if (done) break;",
     "    if (tid == 0) {\n"
     "      atomicAdd(&g_clk[0], (unsigned long long)(clk2 - clk1));\n"
     "      atomicAdd(&g_clk[1], (unsigned long long)(clk3 - clk2));\n"
     "      atomicAdd(&g_clk[2], (unsigned long long)(clk4 - clk3));\n"
     "      atomicAdd(&g_clk[3], (unsigned long long)(clock64() - clk4));\n"
     "      atomicAdd(&g_clk[6], 1ull);\n    }\n"),
]
READER = """
extern "C" int phase_clocks(void* out, int zero) {
  if (zero) {
    unsigned long long z[8] = {0};
    return (int)cudaMemcpyToSymbol(g_clk, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, g_clk, 8 * sizeof(unsigned long long));
}
"""


def build() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "row_fixed_point.cuh").read_text()
    for anchor, text in MARKS:
        if src.count(anchor) != 1:
            sys.exit(f"not found once in row_fixed_point.cuh: {anchor!r}")
        src = src.replace(anchor, text + anchor)
    (OUT / "row_fixed_point.cuh").write_text(src)
    for header in _build.CSRC.glob("*.cuh"):
        if header.name != "row_fixed_point.cuh":
            (OUT / header.name).write_text(header.read_text())
    libs = {}
    for name in ("ragged_gamma", "dense_gamma"):
        cu = OUT / f"{name}.cu"
        cu.write_text((_build.CSRC / f"{name}.cu").read_text() + READER)
        lib = OUT / f"lib{name}.so"
        built = subprocess.run(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            capture_output=True, text=True)
        if built.returncode:
            sys.exit(f"nvcc failed for {cu}:\n{built.stdout}{built.stderr}")
        libs[name] = ctypes.CDLL(str(lib))
    for lib in libs.values():
        lib.phase_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    kernels = {name: row_fixed_point.bind(lib, f"pylda_{name}")
               for name, lib in libs.items()}
    ragged_mod._kernel = lambda compute_dtype: kernels["ragged_gamma"]
    dense_mod._kernel = lambda compute_dtype: kernels["dense_gamma"]
    return libs


def cuda_ms(fn, reps=10) -> float:
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


def main() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    libs = build()
    K = 100
    cfg = LDAConfig(number_of_topics=K, inference_mode="vb",
                    inner_iterations=50, convergence_threshold=1e-5, seed=0)
    kw = dict(inner_iterations=50, convergence_threshold=1e-5, eps=cfg.eps,
              stall_patience=cfg.estep_stall_patience)
    cases = []
    for V in (10_000, 4096):
        corpus, beta, _ = synthetic_corpus(num_docs=4096, num_topics=K,
                                           num_types=V, mean_doc_length=120.0,
                                           seed=0)
        lam = (1.0 / V + beta * (corpus.num_tokens / K)).astype(np.float32)
        eng = VariationalBayes(cfg, device=dev)
        eng.initialize(corpus, lam_init=lam)
        eeb = exp_dirichlet_expectation_fast(eng.state.lam)
        alpha = eng.state.alpha
        if V == 10_000:
            table = ragged_mod.gather_table(eeb)
            for i in (1, 3):
                b = eng._batches[i]
                g0 = torch.ones((b.ids.shape[0], K), device=dev)
                cases.append((
                    f"ragged bucket {i} {tuple(b.ids.shape)}", "ragged_gamma",
                    lambda b=b, g0=g0, e=eeb, a=alpha, t=table:
                    ragged_mod.ragged_gamma(b.ids, b.cnts, g0, e, a,
                                            eeb_t=t, **kw)))
        else:
            (b,) = eng._batches
            g0 = torch.ones((b.counts.shape[0], K), device=dev)
            cases.append((
                f"dense gamma + final pass {tuple(b.counts.shape)}",
                "dense_gamma",
                lambda b=b, g0=g0, e=eeb, a=alpha:
                dense_mod.dense_estep(b.counts, g0, e, a, **kw)))
    for label, lib_name, fn in cases:
        ms = cuda_ms(fn)
        lib = libs[lib_name]
        buf = (ctypes.c_ulonglong * 8)()
        lib.phase_clocks(None, 1)
        fn()
        torch.cuda.synchronize()
        lib.phase_clocks(ctypes.byref(buf), 0)
        c = list(buf)
        sweeps, rows = max(c[6], 1), max(c[5], 1)
        per = ", ".join(f"{name} {c[i] / sweeps:.0f}"
                        for i, name in enumerate(PHASES))
        print(f"{label}: instrumented call {ms:.4f} ms; cycles a row-sweep "
              f"(thread 0 of each block): {per}; compaction + gather "
              f"{c[4] / rows:.0f} "
              f"cycles a row ({c[5]} rows, {c[6]} row-sweeps)")


if __name__ == "__main__":
    main()
