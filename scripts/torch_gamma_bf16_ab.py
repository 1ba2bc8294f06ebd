"""Times the bf16 gamma kernels at K <= 256 against an older tree's, in
turns.

    git archive <commit> | tar -x -C build/gamma_parent
    PYTHONPATH=. python scripts/torch_gamma_bf16_ab.py \
        --parent build/gamma_parent [--topics 16,200]

On one CUDA card.  ``--parent`` is the root of the older tree: its
``pylda_tpu_torch/csrc/ragged_gamma.cu`` and ``dense_gamma.cu`` are
compiled in the bf16 operand mode with the package's nvcc flags into
``build/gamma_bf16_ab/``, and its ``pylda_tpu_torch/ops/row_fixed_point.py``
is loaded under another name to plan and launch them (``launch``), so the
older tree's whole launch is timed, host work included.  This tree's
launches go through its own ``row_fixed_point.launch`` at its own plan.
The cases are ``chip_smoke.py``'s kernel lines:

- the ragged flagship (K = 100, V = 10,000, 4,096 documents of 120 tokens,
  seed 0, buckets 1344x112, 2176x128, 640x144, 64x160): the four bucket
  launches of one E-step, summed;
- the dense flagship (V = 4,096, seed 0: one [4096, 4096] bf16 batch, its
  largest row's nnz planning the launch): the gamma launch, and the call
  with its final pass (this tree's bf16 ``dense_sstats`` on the gamma,
  the same code for both trees);

each at a sharpened lambda (the planted topics scaled to the corpus's
tokens a topic), gamma from ones, 50 sweeps, threshold 1e-5, patience 6.
``--topics`` adds the same corpora at other K <= 256.  Each case is timed
old, new, new, old in bf16 (CUDA-event means of warm calls), and this
tree's float32 build of the same launches between (the target of the
bf16 build): each call's launches with their host work, and the kernels
alone (CUDA events around each launch).  Prints the card's name and power
limit first, then a line a case: the times, the bound (4 K FLOP a live
entry a computed sweep at the bf16 tensor-core rate; the counts and ids,
the gather table's rows of the launch's live ids (dense: the whole
table), alpha and gamma read or written once, ``utils/roofline.bound_ms``),
the new launch's route and geometry, the largest relative difference
between the two trees' gamma, whether the new one is bitwise repeatable
and whether the two trees' float32 builds give the same bits.  Then the
routes the change leaves (both builds at K = 300 on both flagships'
corpora and at K = 1000 over V = 100,000, the entry kernel): each tree's
gamma bit for bit.  Ends with a JSON line of the cases.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.models import VariationalBayes
from pylda_tpu_torch.ops import _build
from pylda_tpu_torch.ops import row_fixed_point as rfp
from pylda_tpu_torch.ops import sstats as sstats_mod
from pylda_tpu_torch.ops.dirichlet import (
    exp_dirichlet_expectation,
    exp_dirichlet_expectation_fast,
)
from pylda_tpu_torch.utils.config import LDAConfig
from pylda_tpu_torch.utils.roofline import bound_ms

BF16 = "bfloat16"
DOCS, LENGTH, V_RAGGED, V_DENSE = 4096, 120.0, 10_000, 4096
KW = dict(inner_iterations=50, convergence_threshold=1e-5, eps=1e-30,
          stall_patience=6)
REPS = 20


def cuda_ms(fn, reps: int = REPS) -> float:
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


def timed(fn):
    """(``fn`` with CUDA events recorded around each call, the events): the
    device time of the kernel launches alone, without the host work of
    ``launch`` around them."""
    events = []

    def call(params, stream):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        rc = fn(params, stream)
        stop.record()
        events.append((start, stop))
        return rc
    call.__name__ = getattr(fn, "__name__", "kernel")
    return call, events


def both_ms(mod, fn, batches, alpha, eeb, compute_dtype, dense) -> tuple:
    """(ms of a call's launches with their host work, ms of the kernels
    alone, each launch's ms alone): CUDA-event means over REPS warm
    calls."""
    call, events = timed(fn)
    run = launches(mod, call, batches, alpha, eeb, compute_dtype, dense)
    wall = cuda_ms(run)
    last = [a.elapsed_time(b) for a, b in events[-REPS * len(batches):]]
    each = [sum(last[i::len(batches)]) / REPS for i in range(len(batches))]
    return wall, sum(each), each


def load_parent(root: pathlib.Path):
    """(module, {(source, mode): bound entry}) of the older tree."""
    spec = importlib.util.spec_from_file_location(
        "parent_row_fixed_point",
        root / "pylda_tpu_torch" / "ops" / "row_fixed_point.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    out = _build.BUILD_DIR.parent / "gamma_bf16_ab"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in ("ragged_gamma", "dense_gamma"):
        for mode, flags in _build.MODES.items():
            so = out / f"libparent_{name}-{mode}.so"
            src = root / "pylda_tpu_torch" / "csrc" / f"{name}.cu"
            procs.append(((name, mode), so, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o",
                 str(so), str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for key, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the parent's {key}:\n{log}")
        fns[key] = mod.bind(ctypes.CDLL(str(so)), f"pylda_{key[0]}")
    return mod, fns


def problem(dev, K: int, V: int):
    """(batches, alpha, expElogbeta) of the flagship corpus at K topics
    over V types, as ``chip_smoke.py``'s kernel lines build them."""
    corpus, beta, _ = synthetic_corpus(num_docs=DOCS, num_topics=K,
                                       num_types=V, mean_doc_length=LENGTH,
                                       seed=0)
    lam = (1.0 / V + beta * (corpus.num_tokens / K)).astype(np.float32)
    eng = VariationalBayes(LDAConfig(number_of_topics=K, seed=0), device=dev)
    eng.initialize(corpus, lam_init=lam)
    return (eng._batches, eng.state.alpha,
            exp_dirichlet_expectation_fast(eng.state.lam))


def launches(mod, fn, batches, alpha, eeb, compute_dtype, dense, outs=None):
    """A callable running one E-step's gamma launches of ``batches`` with
    ``mod.launch`` and the bound entry ``fn``; it returns their gammas."""
    table = rfp.gather_table(eeb, compute_dtype)
    K = eeb.shape[0]

    def run():
        got = []
        for i, b in enumerate(batches):
            g0 = torch.ones((b.rows if dense else b.ids.shape[0], K),
                            dtype=torch.float32, device=eeb.device)
            extra = {} if outs is None else outs[i]
            if dense:
                got.append(mod.launch(fn, None, b.counts, eeb.shape[1],
                                      table, alpha, g0, **KW,
                                      widest=b.max_nnz, **extra)[0])
            else:
                got.append(mod.launch(fn, b.ids, b.cnts, b.ids.shape[1],
                                      table, alpha, g0, **KW,
                                      segments=getattr(b, "segments", None),
                                      **extra)[0])
        return got
    return run


def case(label, dev, parent, K, dense):
    V = V_DENSE if dense else V_RAGGED
    batches, alpha, eeb = problem(dev, K, V)
    if dense:
        batches = [b for b in batches if hasattr(b, "counts")]
    src = "dense_gamma" if dense else "ragged_gamma"
    mod, fns = parent
    outs = [dict(slots_out=torch.zeros((1,), dtype=torch.int64, device=dev),
                 geometry_out={}) for _ in batches]
    old = (mod, fns[(src, BF16)], BF16)
    new = (rfp, rfp.entry(src, BF16), BF16)
    f32 = (rfp, rfp.entry(src), "float32")
    g_new = launches(rfp, rfp.entry(src, BF16), batches, alpha, eeb, BF16,
                     dense, outs)()
    g_old = launches(*old[:2], batches, alpha, eeb, BF16, dense)()
    g_again = launches(*new[:2], batches, alpha, eeb, BF16, dense)()
    f32_bits = same_bits(parent, src, batches, alpha, eeb, "float32", dense)
    torch.cuda.synchronize()
    repeat = all(torch.equal(a, b) for a, b in zip(g_new, g_again))
    rel = max(float(((a - b).abs() / b.abs()).max())
              for a, b in zip(g_new, g_old))
    turns = [both_ms(m, fn, batches, alpha, eeb, cd, dense)
             for m, fn, cd in (old, new, f32, new, old)]
    times = [w for w, _, _ in turns]
    kernel = [k for _, k, _ in turns]
    slots = sum(int(o["slots_out"]) for o in outs)
    nbytes = 0.0
    for b in batches:
        if dense:
            nbytes += (b.counts.numel() * b.counts.element_size()
                       + V * rfp.table_width(K, BF16) * 2
                       + 2 * b.counts.shape[0] * K * 4 + K * 4)
        else:
            live = b.cnts != 0
            nbytes += (b.ids.numel() * 8 + int(torch.unique(b.ids[live]).numel())
                       * rfp.table_width(K, BF16) * 2
                       + 2 * b.ids.shape[0] * K * 4 + K * 4)
    b_ms, b_by = bound_ms(4.0 * K * slots, nbytes, BF16)
    row = {"case": label, "K": K, "launches": len(batches),
           "old_ms": [times[0], times[4]], "new_ms": [times[1], times[3]],
           "float32_ms": times[2],
           "old_kernel_ms": [kernel[0], kernel[4]],
           "new_kernel_ms": [kernel[1], kernel[3]],
           "float32_kernel_ms": kernel[2],
           "each_launch_ms": {"old": turns[0][2], "new": turns[1][2],
                              "float32": turns[2][2]},
           "bound_ms": b_ms, "bound_by": b_by,
           "routes": [o["geometry_out"]["route"] for o in outs],
           "geometry": [{f: o["geometry_out"][f] for f in (
               "nmax", "smem_bytes", "blocks_per_sm", "grid")}
               for o in outs],
           "max_rel_diff_vs_old": rel, "new_bitwise_repeatable": repeat,
           "float32_bitwise_parent": f32_bits}
    if dense:
        fin = [exp_dirichlet_expectation(g) for g in g_new]
        pass_ms = cuda_ms(lambda: [sstats_mod.dense_sstats(
            b.counts, e, eeb, compute_dtype=BF16)
            for b, e in zip(batches, fin)])
        f32_pass = cuda_ms(lambda: [sstats_mod.dense_sstats(b.counts, e, eeb)
                                    for b, e in zip(batches, fin)])
        row.update(final_pass_ms=pass_ms, float32_final_pass_ms=f32_pass)
    print(f"{label} K={K}: old {times[0]:.4f} / {times[4]:.4f} ms, new "
          f"{times[1]:.4f} / {times[3]:.4f} ms, float32 {times[2]:.4f} ms"
          + (f" (+ final pass bf16 {row['final_pass_ms']:.4f}, float32 "
             f"{row['float32_final_pass_ms']:.4f})" if dense else "")
          + f"; kernels alone old {kernel[0]:.4f} / {kernel[4]:.4f}, new "
          f"{kernel[1]:.4f} / {kernel[3]:.4f}, float32 {kernel[2]:.4f}"
          f"; bound {b_ms:.5f} ({b_by}); routes {row['routes']}, "
          f"geometry {row['geometry']}; max rel diff vs old {rel:.3e}; new "
          f"bitwise repeatable {repeat}; float32 build bitwise the "
          f"parent's {f32_bits}", flush=True)
    return row


def same_bits(parent, src, batches, alpha, eeb, compute_dtype, dense):
    """Whether this tree's and the older tree's launches of ``src`` in
    ``compute_dtype`` give the same gamma bits on ``batches``."""
    mod, fns = parent
    old = launches(mod, fns[(src, compute_dtype)], batches, alpha, eeb,
                   compute_dtype, dense)()
    new = launches(rfp, rfp.entry(src, compute_dtype), batches, alpha, eeb,
                   compute_dtype, dense)()
    return all(torch.equal(a, b) for a, b in zip(old, new))


def unchanged(dev, parent) -> list:
    """The routes the change leaves, each tree's gamma bit for bit: both
    builds of the ragged flagship's corpus at K = 300 (the row-resident
    kernels and their streamed rows) and over V = 100,000 at K = 1000 (the
    entry kernel), and the dense flagship's batch at K = 300."""
    out = []
    for K, V, dense in ((300, V_RAGGED, False), (1000, 100_000, False),
                        (300, V_DENSE, True)):
        batches, alpha, eeb = problem(dev, K, V)
        if dense:
            batches = [b for b in batches if hasattr(b, "counts")]
        src = "dense_gamma" if dense else "ragged_gamma"
        for cd in ("float32", BF16):
            geo = [{"geometry_out": {}} for _ in batches]
            launches(rfp, rfp.entry(src, cd), batches, alpha, eeb, cd, dense,
                     geo)()
            bits = same_bits(parent, src, batches, alpha, eeb, cd, dense)
            row = {"case": src, "K": K, "V": V, "mode": cd,
                   "routes": [g["geometry_out"]["route"] for g in geo],
                   "bitwise_parent": bits}
            print(f"unchanged route {row}", flush=True)
            out.append(row)
        del batches, alpha, eeb
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True)
    ap.add_argument("--topics", default="",
                    help="more K <= 256, comma separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    parent = load_parent(args.parent)
    _build.build(("ragged_gamma", "dense_gamma"))
    rows = []
    for K in [100] + [int(k) for k in args.topics.split(",") if k]:
        for dense in (False, True):
            rows.append(case("dense flagship" if dense else
                             "ragged flagship", dev, parent, K, dense))
    kept = unchanged(dev, parent)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "cases": rows, "unchanged": kept}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
