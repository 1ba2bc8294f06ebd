"""Where the dense sufficient-statistics kernel spends its time: variants of
``csrc/dense_sstats.cu`` with parts of each chunk's work taken out.

    PYTHONPATH=. python scripts/torch_sstats_phases.py

On one CUDA card.  The script copies the package's kernel source into
``build/sstats_phases/``, makes variants by editing the copy, builds them
all at once with the package's nvcc flags, and times each at the two
flagship shapes of ``scripts/torch_sstats_ab.py`` (torch.profiler device
time of the kernel alone, mean of 20 calls):

- ``full``: the kernel as it is;
- ``no arithmetic``: no step of the column walk (masks built, expEtheta
  staged, nothing computed);
- ``no expEtheta``: also no staging of expEtheta rows;
- ``counts only``: also no compaction: the counts stream through the
  pipeline and its barriers, and nothing else happens in a chunk;
- ``no chunks``: no row at all: a CTA stages its expElogbeta tile, writes
  its partial sums, and the last CTA of each tile sums them (the fixed
  cost of the grid);
- ``no expElogbeta tile``: also no copy of the expElogbeta tile (what is
  left: the partial sums, their reduction, the score and the launch).

The differences between neighbouring lines are what each part costs where
the others run.  Variants other than ``full`` compute wrong results.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from torch_sstats_ab import K, flagship_counts, kernel_ms  # noqa: E402

from pylda_tpu_torch.ops import _build  # noqa: E402
from pylda_tpu_torch.ops import sstats as sstats_mod  # noqa: E402
from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation  # noqa: E402

# (pattern, replacement) edits, applied cumulatively.
EDITS = [
    ("no arithmetic",
     r"const int steps = __reduce_max_sync\(kFull, n\);",
     "const int steps = 0 * __reduce_max_sync(kFull, n);"),
    ("no expEtheta",
     r"load_et\(et_s \+ nxt \* kRows \* L::LD, L::LD, et, d0 \+ kRows,\s*"
     r"touched_rows\(rmask_s \+ nxt \* kWarps\), K, et_vec\);",
     "__pipeline_commit();"),
    ("counts only",
     r"compact\(cbuf\(ci \+ 1\), cmask_s \+ nxt \* kTileV, "
     r"rmask_s \+ nxt \* kWarps\);",
     ";"),
    ("no chunks",
     r"const int chunks = ",
     "const int chunks = 0 * "),
    ("no expElogbeta tile",
     r"__pipeline_memcpy_async\(dst, eeb \+ \(size_t\)k \* V \+ v0 \+ cc, 4\);",
     "*dst = 0.f;"),
]


def variants() -> dict:
    out_dir = _build.BUILD_DIR.parent / "sstats_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "dense_sstats.cu").read_text()
    sources = {"full": src}
    for name, pattern, repl in EDITS:
        src, n = re.subn(pattern, repl, src)
        if n != 1:
            raise RuntimeError(f"edit {name!r} matched {n} times")
        sources[name] = src
    jobs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu = out_dir / f"v{i}.cu"
        cu.write_text(text)
        so = out_dir / f"libv{i}.so"
        jobs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = sstats_mod.bind(ctypes.CDLL(str(so)))
    return libs


def main() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda", 0)
    libs = variants()
    rng = np.random.default_rng(0)
    for label, V in (("ragged flagship chunk", 10_000),
                     ("dense flagship final pass", 4096)):
        counts, eeb = flagship_counts(V, dev)
        D = counts.shape[0]
        gamma = torch.tensor(rng.gamma(100.0, 0.01, (D, K)), device=dev)
        et = exp_dirichlet_expectation(gamma.float())
        pl = sstats_mod.plan(D, counts.shape[1], K,
                             torch.cuda.get_device_properties(dev)
                             .multi_processor_count)
        print(f"{label} [{D}x{counts.shape[1]}], {pl.blocks} CTAs "
              f"({pl.splits} splits, {pl.rows_per_split // 32} chunks each):")
        for name, lib in libs.items():
            ms = kernel_ms(lambda: sstats_mod.launch(lib, counts, et, eeb,
                                                     1e-30), 20)
            print(f"  {name}: {ms:.4f} ms")


if __name__ == "__main__":
    main()
