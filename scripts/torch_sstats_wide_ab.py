"""Times the dense sufficient-statistics kernel above K = 4096 against the
same function in an older tree of the package, in turns.

    git archive <commit> | tar -x -C build/sstats_parent
    PYTHONPATH=. python scripts/torch_sstats_wide_ab.py \
        --parent build/sstats_parent

On one CUDA card.  ``--parent`` is the root of the older tree: its
``pylda_tpu_torch/csrc/dense_sstats.cu`` is compiled with the package's
nvcc flags (both operand modes) into ``build/sstats_wide_ab/``, and its
``pylda_tpu_torch/ops/sstats.py`` is loaded under another name to plan
and launch it (``launch(lib, counts, et, eeb, eps, topic_range)``), so the
older tree's whole call above K = 4096 is timed, host work included.
The tree in this checkout is timed through its own ``sstats.launch``.
Each case is timed old, new, new, old (CUDA-event means of warm calls),
on the counts ``chip_smoke.py`` builds:

- config 5's corpus as its ``wide_k_kernels`` builds it (8,192
  documents, V = 100,000, seed 4; its first 1,216 documents as a
  [1216, 100352] bf16 chunk): the whole chunk at K = 8192, the topic
  range 4096..8191 of it, and its first 25,088 columns at K = 4100, 5000
  and 16384;
- the ragged flagship's chunk, the sstats call of ``wide_k_vb`` and
  ``shard_topics_vb_wide`` (4,096 documents, V = 10,000, 120 tokens a
  document, seed 0: [4096, 10240] bf16, 1.2% nonzero) at K = 8192;
- the dense flagship's first 256 documents (V = 4,096, seed 0:
  [256, 4096], 2.8% nonzero), the dense E-step's final pass in
  ``wide_k_dense``, at K = 5000 and 8192;

each in float32 and in the bf16 operand mode.  expElogbeta and expEtheta
come from seeded random gammas (the time depends on the counts' pattern
and the shapes, not on the values).  Prints the card's name and power
limit first, then a line a case: the four times, the largest difference
between the two trees' sstats and whether the new one is bitwise
repeatable.  Ends with a JSON line of the cases.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=pathlib.Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"nvidia-smi: {smi.strip()}")
    dev = torch.device("cuda", 0)
    parent, old_libs = load_parent(args.parent)
    c5 = chunk(dev)
    ragged = counts_of(dev, 4096, 10240, num_docs=4096, num_topics=100,
                       num_types=10_000, mean_doc_length=120.0, seed=0)
    dense = counts_of(dev, 256, 4096, num_docs=4096, num_topics=100,
                      num_types=4096, mean_doc_length=120.0, seed=0)
    gen = torch.Generator(device=dev).manual_seed(7)
    cases = []
    for (counts, V), K, cols, rng in (
            (c5, 8192, COLUMNS, None), (c5, 8192, COLUMNS, (4096, 8192)),
            (c5, 4100, CUT, None), (c5, 5000, CUT, None),
            (c5, 16384, CUT, None), (ragged, 8192, 10240, None),
            (dense, 5000, 4096, None), (dense, 8192, 4096, None)):
        rows = counts.shape[0]
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
            t = [cuda_ms(old), cuda_ms(new), cuda_ms(new), cuda_ms(old)]
            name = (f"[{rows}x{cols}] K={K}"
                    + (f" topics {rng[0]}..{rng[1] - 1}" if rng else "")
                    + f" {cd}")
            print(f"{name}: old {t[0]:.4f} new {t[1]:.4f} new {t[2]:.4f} "
                  f"old {t[3]:.4f} ms; max |old - new| {diff:.3e} (max "
                  f"|sstats| {float(a[0].abs().max()):.3e}), new bitwise "
                  f"repeatable {same}")
            cases.append({"case": name, "old_ms": [t[0], t[3]],
                          "new_ms": [t[1], t[2]], "max_abs_diff": diff,
                          "repeatable": same})
        del c, eeb, et
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi.strip(), "cases": cases}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
