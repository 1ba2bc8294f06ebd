"""Times the two gamma kernels on rows longer than their shared-memory slot
buffer, where rows stream their entries from L2 each sweep.

    PYTHONPATH=. python scripts/torch_gamma_long_rows.py

On one CUDA card, with whichever ``pylda_tpu_torch`` is first on
``PYTHONPATH`` (so two versions of the package can be timed by the same
script: put a copy of the other tree on ``PYTHONPATH`` and run it again),
it times warm calls (CUDA events) of ``dense_estep`` (gamma fixed point
and final pass) and of ``ragged_gamma`` (all of a corpus's buckets) on the
batches the engine builds from synthetic corpora:

- the dense flagship's corpus (D=4096, V=4096, mean document length 120)
  at K=256, where most rows (~115 nonzeros) exceed the 63-slot buffer;
- long documents on the dense route at K=100: D=1024, V=4096, mean length
  400 and 2000 (hundreds to ~1,400 nonzeros a row against 166 slots);
- the ragged flagship's corpus (D=4096, V=10,000, mean length 120) at
  K=256, and long documents on the ragged route at K=100 (D=1024,
  V=10,000, mean length 1000).

Each case uses a sharpened lambda (the planted topics scaled to tokens per
topic), inner 50, threshold 1e-5, stall patience 6, as ``chip_smoke.py``
does.  One line per case: the nonzeros a row (mean, max), the batch
shapes, the sweeps, and ms per call.  Prints the package's path and the
card's name and power limit first.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

import pylda_tpu_torch
from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.models import VariationalBayes
from pylda_tpu_torch.ops import dense_estep as dense_mod
from pylda_tpu_torch.ops import ragged as ragged_mod
from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation_fast
from pylda_tpu_torch.utils.config import LDAConfig

# (label, route, K, D, V, mean document length)
CASES = [
    ("dense flagship corpus, K=256", "dense", 256, 4096, 4096, 120.0),
    ("dense long documents, K=100", "dense", 100, 1024, 4096, 400.0),
    ("dense long documents, K=100", "dense", 100, 1024, 4096, 2000.0),
    ("ragged flagship corpus, K=256", "ragged", 256, 4096, 10_000, 120.0),
    ("ragged long documents, K=100", "ragged", 100, 1024, 10_000, 1000.0),
]


def cuda_ms(fn, reps: int) -> float:
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
    print(f"package: {pylda_tpu_torch.__file__}")
    print(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for label, route, K, D, V, length in CASES:
        corpus, beta, _ = synthetic_corpus(num_docs=D, num_topics=K,
                                           num_types=V,
                                           mean_doc_length=length, seed=0)
        cfg = LDAConfig(number_of_topics=K, inference_mode="vb",
                        inner_iterations=50, convergence_threshold=1e-5,
                        seed=0)
        kw = dict(inner_iterations=50, convergence_threshold=1e-5,
                  eps=cfg.eps, stall_patience=cfg.estep_stall_patience)
        lam = (1.0 / V + beta * (corpus.num_tokens / K)).astype(np.float32)
        eng = VariationalBayes(cfg, device=dev)
        eng.initialize(corpus, lam_init=lam)
        eeb = exp_dirichlet_expectation_fast(eng.state.lam)
        alpha = eng.state.alpha
        calls, shapes, nnz = [], [], []
        for b in eng._batches:
            if route == "dense":
                shapes.append(tuple(b.counts.shape))
                nnz.append((b.counts != 0).sum(dim=1))
                g0 = torch.ones((b.counts.shape[0], K), device=dev)
                calls.append(lambda b=b, g0=g0: dense_mod.dense_estep(
                    b.counts, g0, eeb, alpha, **kw))
            else:
                shapes.append(tuple(b.ids.shape))
                nnz.append((b.cnts != 0).sum(dim=1))
                g0 = torch.ones((b.ids.shape[0], K), device=dev)
                calls.append(lambda b=b, g0=g0: ragged_mod.ragged_gamma(
                    b.ids, b.cnts, g0, eeb, alpha, **kw))
        sweeps = [int(call()[-1]) for call in calls]
        ms = sum(cuda_ms(call, 3) for call in calls)
        row_nnz = torch.cat(nnz).float()
        print(f"{label} (D={D}, V={V}, mean length {length:g}): nonzeros a "
              f"row mean {float(row_nnz.mean()):.1f} max "
              f"{int(row_nnz.max())}; batches {shapes}; sweeps {sweeps}; "
              f"{route} gamma ms per call (all batches) {ms:.4f}")
        del eng, eeb, alpha, calls


if __name__ == "__main__":
    main()
