"""Times the dense sufficient-statistics kernel against the same function
in an older tree of the package, in turns.

    git archive <commit> | tar -x -C build/sstats_parent
    PYTHONPATH=. python scripts/torch_sstats_wide_ab.py \
        --parent build/sstats_parent [--sweep]

On one CUDA card.  ``--parent`` is the root of the older tree: its
``pylda_tpu_torch/csrc/dense_sstats.cu`` is compiled with the package's
nvcc flags (both operand modes) into ``build/sstats_wide_ab/``, and its
``pylda_tpu_torch/ops/sstats.py`` is loaded under another name to plan
and launch it (``launch(lib, counts, et, eeb, eps, topic_range)``), so the
older tree's whole call is timed, host work included (at
256 < K <= 4096 an older tree runs its one-pass wide builds).  The tree
in this checkout is timed through its own ``sstats.launch`` at its own
plan.  Each case is timed old, new, new, old (CUDA-event means of warm
calls), on the counts ``chip_smoke.py`` builds:

- config 5's corpus as its ``wide_k_kernels`` builds it (8,192
  documents, V = 100,000, seed 4; its first 1,216 documents as a
  [1216, 100352] bf16 chunk): at K = 1000 (SVI config 5's own chunk:
  ``svi5``'s first sstats call) the whole chunk and each half of its
  topics, and its first 25,088 columns at K = 300, 512, 2048 and 4096;
  the whole chunk at K = 8192, the topic range 4096..8191 of it, and its
  first 25,088 columns at K = 4100, 5000 and 16384;
- the ragged flagship's chunk, the sstats call of ``wide_k_vb`` and
  ``shard_topics_vb_wide`` (4,096 documents, V = 10,000, 120 tokens a
  document, seed 0: [4096, 10240] bf16, 1.2% nonzero) at K = 8192;
- the dense flagship's batch (V = 4,096, seed 0: [4096, 4096], 2.8%
  nonzero), the dense E-step's final pass, at K = 1000; its first 256
  documents (``wide_k_dense``'s final pass) at K = 5000 and 8192;
- the one-pass kernel's range, whose code and bits must not move: the
  ragged flagship's chunk and the dense flagship's batch at K = 100, and
  SVI config 4's first 1,024 documents (16,384 documents, V = 50,000,
  150 tokens a document, seed 3: [1024, 50176]) at K = 200;

each in float32 and in the bf16 operand mode.  expElogbeta and expEtheta
come from seeded random gammas (the time depends on the counts' pattern
and the shapes, not on the values).  Prints the card's name and power
limit first, then a line a case: the four times, the bound (the inputs
read once, sstats written once, 4 K FLOP a nonzero; a topic range 2 K +
2 (k1 - k0) FLOP and its rows written; ``utils/roofline.bound_ms``), the
new plan, the largest difference between the two trees' sstats, whether
the two trees' sstats and scores are bitwise equal and whether the new
one is bitwise repeatable.  ``--sweep``: at K <= 4096
each full-range case is also timed at every cluster of 1, 2, 4 and 8
CTAs (the plan's study; each held to the default plan at the float32
tolerances).  Ends with a JSON line of the cases.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import pathlib
import subprocess
import sys

import torch

from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.ops import _build
from pylda_tpu_torch.ops import sstats as sstats_mod
from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation
from pylda_tpu_torch.utils.roofline import bound_ms

ROWS, COLUMNS, CUT = 1216, 100352, 25088
REPS = 10


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


def load_parent(root: pathlib.Path):
    """(module, {mode: library}) of the older tree's sstats wrapper."""
    spec = importlib.util.spec_from_file_location(
        "parent_sstats", root / "pylda_tpu_torch" / "ops" / "sstats.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    src = root / "pylda_tpu_torch" / "csrc" / "dense_sstats.cu"
    out = _build.BUILD_DIR.parent / "sstats_wide_ab"
    out.mkdir(parents=True, exist_ok=True)
    libs, procs = {}, []
    for mode, flags in _build.MODES.items():
        so = out / f"libparent_sstats-{mode}.so"
        procs.append((mode, so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o", str(so),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    for mode, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the parent's source:\n{log}")
        libs[mode] = mod.bind(ctypes.CDLL(str(so)))
    return mod, libs


def counts_of(dev, rows: int, columns: int, **corpus):
    """(The first ``rows`` documents of a synthetic corpus as [rows,
    columns] bf16 counts, its vocabulary's size)."""
    c = synthetic_corpus(**corpus)[0]
    dense = c.to_dense(doc_indices=range(rows)).counts
    counts = torch.zeros((rows, columns), dtype=torch.bfloat16, device=dev)
    counts[:, :c.num_types] = torch.as_tensor(dense, device=dev)
    return counts, c.num_types


def chunk(dev):
    """Config 5's first 1,216 documents as a [1216, 100352] bf16 chunk."""
    return counts_of(dev, ROWS, COLUMNS, num_docs=8192, num_topics=1000,
                     num_types=100_000, mean_doc_length=150.0, seed=4)


def bound(counts, K: int, V: int, rng, compute_dtype: str) -> tuple:
    """(least ms, "bytes" or "operations") of the call on one H100: the
    counts, expEtheta and expElogbeta read once and sstats (the range's
    rows) written once; 4 K FLOP a nonzero (2 K + 2 (k1 - k0) over a
    range), ``chip_smoke.py``'s pricing."""
    D = counts.shape[0]
    k0, k1 = rng or (0, K)
    nnz = int((counts != 0).sum())
    nbytes = (counts.numel() * counts.element_size() + D * K * 4 + K * V * 4
              + (k1 - k0) * V * 4 + 4)
    return bound_ms((2.0 * K + 2.0 * (k1 - k0)) * nnz, nbytes, compute_dtype)


def plan_text(pl) -> str:
    if not pl.wide:
        return f"one pass, {pl.cols} columns x {pl.splits} splits"
    return (f"cluster {pl.cluster}, slice {pl.slice}, {pl.cols} columns, "
            f"batch {pl.batch}" + (", direct" if pl.direct else ""))


def plan_at(cluster: int, *args, **kwargs):
    """``sstats.plan`` with its clusters fixed at ``cluster`` CTAs (the
    study of ``--sweep``: the package's plan takes ``wide_cluster``'s)."""
    fixed = sstats_mod.wide_cluster
    sstats_mod.wide_cluster = lambda K: cluster
    try:
        return sstats_mod.plan(*args, **kwargs)
    finally:
        sstats_mod.wide_cluster = fixed


def sweep(lib, c, et, eeb, ref, K: int) -> list:
    """The cluster kernel at each cluster of 1, 2, 4 and 8 CTAs whose plan
    is not direct, each held to ``ref`` (the default plan's sstats) at the
    float32 tolerances: (plan text, ms, max |diff|) a cluster."""
    sms = torch.cuda.get_device_properties(c.device).multi_processor_count
    out = []
    for cluster in (1, 2, 4, 8):
        pl = plan_at(cluster, *c.shape, K, sms, count_bytes=c.element_size())
        if pl.direct:
            continue

        def call(pl=pl):
            return sstats_mod.launch(lib, c, et, eeb, 1e-30, plan_=pl)

        got = call()
        torch.cuda.synchronize()
        diff = (got[0] - ref).abs()
        ok = bool((diff <= 1e-4 * ref.abs() + 1e-6 * ref.abs().max()).all())
        ms = cuda_ms(call)
        print(f"    sweep {plan_text(pl)}: {ms:.4f} ms, max |diff| to the "
              f"default plan {float(diff.max()):.3e} {'ok' if ok else 'FAIL'}")
        out.append({"plan": plan_text(pl), "ms": ms,
                    "max_abs_diff": float(diff.max()), "ok": ok})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=pathlib.Path)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"nvidia-smi: {smi.strip()}")
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    parent, old_libs = load_parent(args.parent)
    c5 = chunk(dev)
    ragged = counts_of(dev, 4096, 10240, num_docs=4096, num_topics=100,
                       num_types=10_000, mean_doc_length=120.0, seed=0)
    dense = counts_of(dev, 4096, 4096, num_docs=4096, num_topics=100,
                      num_types=4096, mean_doc_length=120.0, seed=0)
    dense256 = (dense[0][:256].contiguous(), dense[1])
    svi4 = counts_of(dev, 1024, 50176, num_docs=16384, num_topics=200,
                     num_types=50_000, mean_doc_length=150.0, seed=3)
    gen = torch.Generator(device=dev).manual_seed(7)
    cases = []
    for (counts, V), K, cols, rng in (
            (c5, 1000, COLUMNS, None), (c5, 1000, COLUMNS, (0, 500)),
            (c5, 1000, COLUMNS, (500, 1000)), (dense, 1000, 4096, None),
            (c5, 300, CUT, None), (c5, 512, CUT, None),
            (c5, 2048, CUT, None), (c5, 4096, CUT, None),
            (c5, 8192, COLUMNS, None), (c5, 8192, COLUMNS, (4096, 8192)),
            (c5, 4100, CUT, None), (c5, 5000, CUT, None),
            (c5, 16384, CUT, None), (ragged, 8192, 10240, None),
            (dense256, 5000, 4096, None), (dense256, 8192, 4096, None),
            (ragged, 100, 10240, None), (dense, 100, 4096, None),
            (svi4, 200, 50176, None)):
        rows = counts.shape[0]
        name = (f"[{rows}x{cols}] K={K}"
                + (f" topics {rng[0]}..{rng[1] - 1}" if rng else ""))
        c = counts[:, :cols].contiguous()
        v = min(cols, V)
        lam = torch.empty((K, v), device=dev).uniform_(0.5, 1.5,
                                                       generator=gen)
        eeb = exp_dirichlet_expectation(lam)
        del lam
        g = torch.empty((rows, K), device=dev).uniform_(0.5, 3.0,
                                                        generator=gen)
        et = exp_dirichlet_expectation(g)
        del g
        pl = sstats_mod.plan(*c.shape, K, sms, rng, c.element_size())
        for cd in ("float32", "bfloat16"):
            new_lib = sstats_mod._lib(cd)

            def old():
                return parent.launch(old_libs[cd], c, et, eeb, 1e-30, rng)

            def new():
                return sstats_mod.launch(new_lib, c, et, eeb, 1e-30, rng)

            a, b, b2 = old(), new(), new()
            torch.cuda.synchronize()
            diff = float((a[0] - b[0]).abs().max())
            same = bool(torch.equal(b[0], b2[0]) and torch.equal(b[1], b2[1]))
            bits = bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))
            t = [cuda_ms(old), cuda_ms(new), cuda_ms(new), cuda_ms(old)]
            b_ms, b_by = bound(c, K, v, rng, cd)
            print(f"{name} {cd}: old {t[0]:.4f} new {t[1]:.4f} new "
                  f"{t[2]:.4f} old {t[3]:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}); new plan {plan_text(pl)}; max |old - new| "
                  f"{diff:.3e} (max |sstats| {float(a[0].abs().max()):.3e}), "
                  f"bitwise the old tree's {bits}, new bitwise repeatable "
                  f"{same}")
            case = {"case": f"{name} {cd}", "old_ms": [t[0], t[3]],
                    "new_ms": [t[1], t[2]], "bound_ms": b_ms,
                    "bound_by": b_by, "plan": plan_text(pl),
                    "max_abs_diff": diff, "bitwise_old": bits,
                    "repeatable": same}
            if args.sweep and 256 < K <= 4096 and rng is None:
                case["sweep"] = sweep(new_lib, c, et, eeb, b[0], K)
            cases.append(case)
            del a, b, b2
        del c, eeb, et
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi.strip(), "cases": cases}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
