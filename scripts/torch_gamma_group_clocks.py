"""Where a sweep of the bf16 warp-group gamma kernel spends its cycles.

    PYTHONPATH=. python scripts/torch_gamma_group_clocks.py

On one CUDA card: copies ``pylda_tpu_torch/csrc`` into
``build/group_clocks/``, inserts ``clock64()`` reads into the copy of
``row_fixed_point_groups.cuh`` (the sources in the package are not
touched), builds both gamma entries from the copy in the bf16 mode with
the package's ``nvcc`` flags, and runs them on the flagship inputs
``chip_smoke.py`` uses: the ragged buckets (1344x112, 2176x128, 640x144,
64x160) at V = 10,000 and the dense batch at V = 4,096 (K = 100, inner
50, threshold 1e-5, stall patience 6, a sharpened lambda).  For each it
prints the time of the instrumented call and, from thread 0 of every
group (warp 0: its times include its waits for the group's other warps),
the mean cycles a row-sweep spends in step A (phinorm on mma.sync), the
ratios, step B, the barrier after it, step C up to the group sums, the
group sums, and the rest of step C with the last barrier; and the cycles a
row spends on its compaction and gather.  The instrumented libraries are
bound through ``ops/row_fixed_point.py``, as the package's own are.  A
group's cycles include those its SM spent on the other groups it holds.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys

import numpy as np
import torch

from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.models import VariationalBayes
from pylda_tpu_torch.ops import _build
from pylda_tpu_torch.ops import row_fixed_point as rfp
from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation_fast
from pylda_tpu_torch.utils.config import LDAConfig

OUT = _build.BUILD_DIR.parent / "group_clocks"
BF16 = "bfloat16"
PHASES = ("step A", "ratios", "step B", "barrier after B",
          "C to the sums", "group sums", "rest of C and barrier")
KW = dict(inner_iterations=50, convergence_threshold=1e-5, eps=1e-30,
          stall_patience=6)

# (anchor in row_fixed_point_groups.cuh, text put before it)
MARKS = [
    ("namespace {\n\n// A warp group",
     "__device__ unsigned long long g_clk[10];\n"),
    ("  const int n = group_compact<CT>(p, L, smem, group, row, p.nmax);",
     "  long long clk0 = clock64();\n"),
    ("  while (s < max_sweeps) {\n    // A.",
     "  long long ph_clk[7] = {0, 0, 0, 0, 0, 0, 0};\n"
     "  if (gtid == 0) {\n"
     "    atomicAdd(&g_clk[7], (unsigned long long)(clock64() - clk0));\n"
     "    atomicAdd(&g_clk[8], 1ull);\n  }\n"),
    ("    // A. phinorm", "    long long c1 = clock64();\n"),
    ("    // The rounded ratios", "    long long c2 = clock64();\n"),
    ("    // B. The warp's partial", "    long long c3 = clock64();\n"),
    ("    group_sync(group);\n    // C. gamma'",
     "    long long c4 = clock64();\n"),
    ("    // C. gamma' = alpha", "    long long c5 = clock64();\n"),
    ("    const float2 sums = group_sum2", "    long long c6 = clock64();\n"),
    ("    const float rt = psi_row_term", "    long long c7 = clock64();\n"),
    ("    if (done) break;\n",
     "    {\n      long long c8 = clock64();\n"
     "      ph_clk[0] += c2 - c1; ph_clk[1] += c3 - c2;\n"
     "      ph_clk[2] += c4 - c3; ph_clk[3] += c5 - c4;\n"
     "      ph_clk[4] += c6 - c5; ph_clk[5] += c7 - c6;\n"
     "      ph_clk[6] += c8 - c7;\n    }\n"),
    ("#pragma unroll\n  for (int j = 0; j < 2; ++j) {\n"
     "    const int k = gtid + kGroupThreads * j;\n"
     "    if (k < K) p.gamma[base + k] = gam[j];",
     "  if (gtid == 0) {\n"
     "    for (int q = 0; q < 7; ++q)\n"
     "      atomicAdd(&g_clk[q], (unsigned long long)ph_clk[q]);\n"
     "    atomicAdd(&g_clk[9], (unsigned long long)s);\n  }\n"),
]


READER = """
extern "C" int group_clocks(void* out, int zero) {
  if (zero) {
    unsigned long long z[10] = {0};
    return (int)cudaMemcpyToSymbol(g_clk, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, g_clk, 10 * sizeof(unsigned long long));
}
"""


def build() -> dict:
    """The instrumented copies' bf16 libraries, by source name."""
    if OUT.exists():
        shutil.rmtree(OUT)
    shutil.copytree(_build.CSRC, OUT)
    path = OUT / "row_fixed_point_groups.cuh"
    text = path.read_text()
    for anchor, mark in MARKS:
        if text.count(anchor) != 1:
            sys.exit(f"not found once in {path.name}: {anchor!r}")
        text = text.replace(anchor, mark + anchor)
    path.write_text(text)
    libs, procs = {}, []
    for name in ("ragged_gamma", "dense_gamma"):
        cu = OUT / f"{name}.cu"
        cu.write_text(cu.read_text() + READER)
        so = OUT / f"lib{name}-clocks.so"
        procs.append((name, so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *_build.MODES[BF16],
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
        libs[name].group_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return libs


def read_clocks(lib, zero: bool = False) -> list:
    """The device counters g_clk (or zeroes them)."""
    host = (ctypes.c_uint64 * 10)()
    rc = lib.group_clocks(ctypes.addressof(host), int(zero))
    if rc:
        raise RuntimeError(f"cudaMemcpy of the counters failed: {rc}")
    return [int(x) for x in host]


def problem(dev, V: int):
    corpus, beta, _ = synthetic_corpus(num_docs=4096, num_topics=100,
                                       num_types=V, mean_doc_length=120.0,
                                       seed=0)
    lam = (1.0 / V + beta * (corpus.num_tokens / 100)).astype(np.float32)
    eng = VariationalBayes(LDAConfig(number_of_topics=100, seed=0),
                           device=dev)
    eng.initialize(corpus, lam_init=lam)
    return (eng._batches, eng.state.alpha,
            exp_dirichlet_expectation_fast(eng.state.lam))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    libs = build()
    for name, V in (("ragged_gamma", 10_000), ("dense_gamma", 4096)):
        lib = libs[name]
        fn = rfp.bind(lib, f"pylda_{name}")
        batches, alpha, eeb = problem(dev, V)
        table = rfp.gather_table(eeb, BF16)
        for i, b in enumerate(batches):
            dense = hasattr(b, "counts")
            g0 = torch.ones((b.rows if dense else b.ids.shape[0], 100),
                            dtype=torch.float32, device=dev)
            geo = {}

            def run():
                if dense:
                    return rfp.launch(fn, None, b.counts, V, table, alpha, g0,
                                      **KW, widest=b.max_nnz,
                                      geometry_out=geo)
                return rfp.launch(fn, b.ids, b.cnts, b.ids.shape[1], table,
                                  alpha, g0, **KW, geometry_out=geo,
                                  segments=getattr(b, "segments", None))
            run()
            torch.cuda.synchronize()
            read_clocks(lib, zero=True)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            stop.record()
            torch.cuda.synchronize()
            got = read_clocks(lib)
            sweeps, rows = max(got[9], 1), max(got[8], 1)
            shape = list(b.counts.shape if dense else b.ids.shape)
            parts = ", ".join(f"{ph} {got[q] / sweeps:.0f}"
                              for q, ph in enumerate(PHASES))
            print(f"{name} batch {i} {shape}: {start.elapsed_time(stop):.4f} "
                  f"ms instrumented, route {geo['route']}, {rows} rows, "
                  f"{sweeps} row-sweeps; cycles a row-sweep: {parts}, total "
                  f"{sum(got[:7]) / sweeps:.0f}; a row's compaction and "
                  f"gather {got[7] / rows:.0f}", flush=True)
    return 0



if __name__ == "__main__":
    sys.exit(main())
