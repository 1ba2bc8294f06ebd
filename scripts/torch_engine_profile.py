"""How busy the card is while the engine trains, at both flagships.

    PYTHONPATH=. python scripts/torch_engine_profile.py

On one CUDA card.  For the ragged flagship (K=100, V=10,000, D=4096, mean
document length 120, synthetic corpus seed 0) and the dense flagship (the
same at V=4096), as ``chip_smoke.py`` builds them: ``initialize``, two
warm ``learning_many(2)`` calls, then ``learning_many(ITERS)`` under
``torch.profiler`` (CPU and CUDA activities).  Prints, per flagship, the
host wall time of the window (ending in ``torch.cuda.synchronize()``),
the device's busy time (the union of its kernels' and copies' intervals),
the idle share (1 - busy / wall), and the kernels with the most device
time.  The profiler's own overhead inflates the wall time a little, so
the idle share is an upper figure.  Prints the card's name and power
limit first.
"""

from __future__ import annotations

import subprocess
import time

import torch
from torch.autograd import DeviceType

from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.models import VariationalBayes
from pylda_tpu_torch.utils.config import LDAConfig

K, D, MEAN_LEN, ITERS = 100, 4096, 120.0, 5


def busy_us(events) -> float:
    """Length of the union of the device intervals among events."""
    ivs = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == DeviceType.CUDA)
    total, end = 0.0, None
    for a, b in ivs:
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def main() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda", 0)
    cfg = LDAConfig(number_of_topics=K, inference_mode="vb",
                    inner_iterations=50, convergence_threshold=1e-5, seed=0)
    for label, V in (("ragged flagship", 10_000), ("dense flagship", 4096)):
        corpus, _, _ = synthetic_corpus(num_docs=D, num_topics=K, num_types=V,
                                        mean_doc_length=MEAN_LEN, seed=0)
        eng = VariationalBayes(cfg, device=dev)
        eng.initialize(corpus)
        eng.learning_many(2)
        eng.learning_many(2)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            eng.learning_many(ITERS)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy = busy_us(prof.events())
        print(f"{label}: learning_many({ITERS}) wall {wall_us / ITERS / 1e3:.3f} "
              f"ms an iteration, device busy {busy / ITERS / 1e3:.3f} ms an "
              f"iteration, idle share {1.0 - busy / wall_us:.3f}")
        rows = sorted(
            (e for e in prof.key_averages() if e.self_device_time_total > 0),
            key=lambda e: -e.self_device_time_total)[:8]
        for e in rows:
            print(f"  {e.self_device_time_total / ITERS / 1e3:.4f} ms an "
                  f"iteration, {e.count // ITERS} launches an iteration: {e.key[:90]}")
        del eng, corpus


if __name__ == "__main__":
    main()
