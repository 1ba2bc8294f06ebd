"""Where a row-sweep of the entry kernel (the gamma fixed point at K <= 4096
for rows past one block's slot buffer) spends its cycles.

    PYTHONPATH=. python scripts/torch_entry_phase_clocks.py [--variants a,b]

On one CUDA card: copies ``pylda_tpu_torch/csrc`` into
``build/entry_clocks/``, inserts ``clock64()`` reads into the copy of
``row_fixed_point_entries.cuh`` (the sources in the package are not
touched), builds the ragged kernel from the copy in both modes with the
package's ``nvcc`` flags, and runs it on SVI config 5's first minibatch
(K = 1000, V = 100k, 2048 documents, 30 inner sweeps, a sharpened lambda;
its buckets with their segments) and config 4's (K = 200, V = 50k, 1024
documents, 50 sweeps).  For each launch it prints the time of the
instrumented call and, from thread 0 of every CTA, the mean cycles a
row-sweep spends in step A (phinorm, ratio), step B (the partial sums
and the barrier after them), sending the partials, waiting for them,
gamma' on the slice with its block sums and the pair's sends, waiting
for the pairs, expEtheta on the slice and its sends, waiting for the
gathered expEtheta, and the rest (the bf16 copy, the exit rule, the
barrier; at one CTA a row, all of step C, in place); the cycles a row spends gathering its entries; and a CTA's
cycles in the kernel against the sum of those (the rest: the row
handover, compaction and the phase barrier).  A CTA's cycles include
those of the other CTAs its SM holds.  Prints the card's name, power
limit and SM clock first.  ``--variants`` also builds copies changed as
``VARIANTS`` says (each a study of one cost, not a correct kernel: some
drop a result) and runs each on the first launch of every case.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import torch

from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.models import StochasticVariationalBayes
from pylda_tpu_torch.ops import _build
from pylda_tpu_torch.ops import ragged as ragged_mod
from pylda_tpu_torch.ops import row_fixed_point
from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation_fast
from pylda_tpu_torch.utils.config import LDAConfig

OUT = _build.BUILD_DIR.parent / "entry_clocks"
HEADER = "row_fixed_point_entries.cuh"
PHASES = ("A", "B", "send partials", "wait partials", "gamma' + pair",
          "wait pairs", "expEtheta + sends", "wait expEtheta", "rest of C")

# (anchor in the header, text put before it)
MARKS = [
    ("namespace {\n\n// Slots a batch of step A sums at once:",
     "__device__ unsigned long long g_clk[16];\n"),
    ("  // This CTA's entries [t0, t0 + m)",
     "  long long g0c = clock64();\n"),
    ("  // The topics this rank owns: [k0, k1)",
     "  if (threadIdx.x == 0) {\n"
     "    atomicAdd(&g_clk[10], (unsigned long long)(clock64() - g0c));\n"
     "    atomicAdd(&g_clk[11], 1ull);\n  }\n"),
    ("    // A and B over this CTA's entries.\n",
     "    long long c0 = clock64(), c1 = c0, c2 = c0, c3 = c0, c4 = c0, "
     "c5 = c0, c6 = c0, c7 = c0, c8 = c0;\n"),
    ("      if constexpr (kBf16)\n        entry_sums(L, smem, m, acc);",
     "      c1 = clock64();\n"),
    ("    float tot_abs = 0.f, tot = 0.f;\n    if (C == 1) {",
     "    c2 = clock64();\n"),
    ("      // One CTA a row: step C in place",
     "      c3 = c4 = c5 = c6 = c7 = c8 = clock64();\n"),
    ("      mbar_wait(&bars[1], (parity >> 1) & 1u);",
     "      c3 = clock64();\n"),
    ("      // gamma' on the slice, a topic a thread:",
     "      c4 = clock64();\n"),
    ("      mbar_wait(&bars[2], (parity >> 2) & 1u);",
     "      c5 = clock64();\n"),
    ("      for (int r = 0; r < C; ++r) {\n        tot_abs += pairs[r].x;",
     "      c6 = clock64();\n"),
    ("      mbar_wait(&bars[3], (parity >> 3) & 1u);",
     "      c7 = clock64();\n"),
    ("      if constexpr (kBf16)\n        for (int k = tid; k < K; "
     "k += kThreads)\n          smem[L.etr + k] = bf16_round(et_s[k]);\n"
     "    }\n",
     "      c8 = clock64();\n"),
    ("    if (done) break;",
     "    if (threadIdx.x == 0) {\n"
     "      atomicAdd(&g_clk[0], (unsigned long long)(c1 - c0));\n"
     "      atomicAdd(&g_clk[1], (unsigned long long)(c2 - c1));\n"
     "      atomicAdd(&g_clk[2], (unsigned long long)(c3 - c2));\n"
     "      atomicAdd(&g_clk[3], (unsigned long long)(c4 - c3));\n"
     "      atomicAdd(&g_clk[4], (unsigned long long)(c5 - c4));\n"
     "      atomicAdd(&g_clk[5], (unsigned long long)(c6 - c5));\n"
     "      atomicAdd(&g_clk[6], (unsigned long long)(c7 - c6));\n"
     "      atomicAdd(&g_clk[7], (unsigned long long)(c8 - c7));\n"
     "      atomicAdd(&g_clk[8], (unsigned long long)(clock64() - c8));\n"
     "      atomicAdd(&g_clk[9], 1ull);\n    }\n"),
    ("  uint32_t parity = 0u;\n", "  long long k0c = clock64();\n"),
    ("}\n\n// Launches the entry kernel",
     "  if (threadIdx.x == 0) {\n"
     "    atomicAdd(&g_clk[12], (unsigned long long)(clock64() - k0c));\n"
     "    atomicAdd(&g_clk[13], 1ull);\n  }\n"),
]
# Studies of one cost each: (header, text, replacement) edits of the copy.
VARIANTS = {
    # Steps A and B (float32) unrolled by 2, not 4.
    "unroll2": [(HEADER, "#pragma unroll 4\n      for (int u = u0; u < u1; "
                 "++u) {", "#pragma unroll 2\n      for (int u = u0; "
                 "u < u1; ++u) {"),
                (HEADER, "slot_sums<kWideQ, false, 4>(L, smem, m, acc);",
                 "slot_sums<kWideQ, false, 2>(L, smem, m, acc);")],
}
READER = """
extern "C" int phase_clocks(void* out, int zero) {
  if (zero) {
    unsigned long long z[16] = {0};
    return (int)cudaMemcpyToSymbol(g_clk, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, g_clk, 16 * sizeof(unsigned long long));
}
"""


def build(variant: str = "") -> dict:
    """The instrumented ragged kernel of each mode (with a variant's
    edits), bound as the package binds its own: {mode: (library,
    entry)}."""
    out_dir = OUT / (variant or "base")
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = {h.name: h.read_text() for h in _build.CSRC.glob("*.cuh")}
    for anchor, text in MARKS:
        if srcs[HEADER].count(anchor) != 1:
            sys.exit(f"not found once in {HEADER}: {anchor!r}")
        srcs[HEADER] = srcs[HEADER].replace(anchor, text + anchor)
    for header, old, new in VARIANTS.get(variant, ()):
        if srcs[header].count(old) != 1:
            sys.exit(f"variant {variant}: not found once in {header}: {old!r}")
        srcs[header] = srcs[header].replace(old, new)
    for name, text in srcs.items():
        (out_dir / name).write_text(text)
    cu = out_dir / "ragged_gamma.cu"
    cu.write_text((_build.CSRC / "ragged_gamma.cu").read_text() + READER)
    out = {}
    for mode, flags in _build.MODES.items():
        lib = out_dir / f"libragged_gamma-{mode}.so"
        built = subprocess.run(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o", str(lib),
             str(cu)], capture_output=True, text=True)
        if built.returncode:
            sys.exit(f"nvcc failed for {cu}:\n{built.stdout}{built.stderr}")
        handle = ctypes.CDLL(str(lib))
        handle.phase_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
        out[mode] = (handle, row_fixed_point.bind(handle, "pylda_ragged_gamma"))
    return out


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


def minibatch(dev, K, V, D, batch, inner, seed):
    corpus, beta, _ = synthetic_corpus(num_docs=D, num_topics=K, num_types=V,
                                       mean_doc_length=150.0, seed=seed)
    cfg = LDAConfig(number_of_topics=K, inference_mode="svi",
                    batch_size=batch, tau0=64.0, kappa=0.7, seed=0,
                    inner_iterations=inner, convergence_threshold=1e-5)
    svi = StochasticVariationalBayes(cfg, device=dev)
    svi.initialize(corpus, lam_init=(1.0 / V + beta * (
        corpus.num_tokens / K)).astype(np.float32))
    eeb = exp_dirichlet_expectation_fast(svi.state.lam)
    batches, (_, sel) = next(svi._epoch(cfg.seed, 0).minibatches)
    buckets = svi._local_plan(batches, sel)[0]
    kw = dict(inner_iterations=inner, convergence_threshold=1e-5, eps=1e-30,
              stall_patience=cfg.estep_stall_patience)
    return buckets, eeb, svi.state.alpha, kw


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="")
    variants = [v for v in ap.parse_args().variants.split(",") if v]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    builds = {v: build(v) for v in ["", *variants]}
    cases = [("svi config 5", (1000, 100_000, 8192, 2048, 30, 4),
              ("float32", "bfloat16")),
             ("svi config 4", (200, 50_000, 16_384, 1024, 50, 3),
              ("float32",))]
    for label, shape, modes in cases:
        buckets, eeb, alpha, kw = minibatch(dev, *shape)
        K = shape[0]
        for variant, cd in [(v, cd) for v in builds for cd in modes]:
            libs = builds[variant]
            ragged_mod._kernel = lambda compute_dtype: libs[compute_dtype][1]
            table = ragged_mod.gather_table(eeb, cd)
            for i, b in enumerate(buckets if not variant else buckets[:1]):
                g0 = torch.ones((b.ids.shape[0], K), device=dev)
                geo, rows = {}, torch.zeros((b.ids.shape[0],),
                                            dtype=torch.int32, device=dev)

                def fn(geo=None, rows=None, b=b, g0=g0, table=table, cd=cd):
                    return ragged_mod.ragged_gamma(
                        b.ids, b.cnts, g0, eeb, alpha, eeb_t=table,
                        compute_dtype=cd, geometry_out=geo,
                        row_sweeps_out=rows, segments=b.segments,
                        seg_rows=b.seg_rows, **kw)

                ms = cuda_ms(fn)
                lib = libs[cd][0]
                buf = (ctypes.c_ulonglong * 16)()
                lib.phase_clocks(None, 1)
                _, s = fn(geo, rows)
                torch.cuda.synchronize()
                lib.phase_clocks(ctypes.byref(buf), 0)
                c = list(buf)
                sweeps = max(c[9], 1)
                n_rows, ctas = max(c[11], 1), max(c[13], 1)
                per = ", ".join(f"{name} {c[j] / sweeps:.0f}"
                                for j, name in enumerate(PHASES))
                total = sum(c[:9]) + c[10]
                print(f"{label} {cd}{' ' + variant if variant else ''} "
                      f"launch {i} {tuple(b.ids.shape)}: "
                      f"{ms:.4f} ms, route {geo['route']} cluster "
                      f"{geo['cluster']} entries a CTA {geo['resident']} "
                      f"clusters {geo['clusters']}, S* {s.tolist()}, "
                      f"row-sweeps needed {int(rows.sum())}; cycles a "
                      f"row-sweep (thread 0 of each CTA): {per}; gather "
                      f"{c[10] / n_rows:.0f} a row; a CTA in the kernel "
                      f"{c[12] / ctas:.0f}, of which the rest (handover, "
                      f"compaction, phase barrier) "
                      f"{(c[12] - total) / ctas:.0f} ({c[9]} CTA-sweeps, "
                      f"{c[11]} CTA-rows)", flush=True)
            del table
        del buckets, eeb
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
