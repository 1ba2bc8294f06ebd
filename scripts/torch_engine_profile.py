"""How busy the card is while the engine trains, at both flagships, and
where the host time goes on each large-vocabulary route.

    PYTHONPATH=. python scripts/torch_engine_profile.py

On one CUDA card.  For the ragged flagship (K=100, V=10,000, D=4096, mean
document length 120, synthetic corpus seed 0), with ``sstats_mode``
"auto" (dense sufficient statistics) and "scatter" (the row scatter),
and the dense flagship (the same at V=4096), as ``chip_smoke.py`` builds
them: ``initialize``, two warm ``learning_many(2)`` calls, then
``learning_many(ITERS)`` timed on the host clock (ending in
``torch.cuda.synchronize()``) and once more under ``torch.profiler`` (CPU
and CUDA activities).  Prints, per run, ms an iteration, the host wall
time of the profiled window, the device's busy time (the union of its
kernels' and copies' intervals), the idle share (1 - busy / wall), the
kernels with the most device time, the CUDA runtime calls that make the
host wait for the device (synchronizations, device-to-host copies) with
their count and host time, and the ops with the most host time of their
own.  The profiler's own overhead inflates the wall time a little, so
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
RUNS = (("ragged flagship", 10_000, "auto"),
        ("ragged flagship", 10_000, "scatter"),
        ("dense flagship", 4096, "auto"))
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync",
         "aten::item", "aten::_local_scalar_dense")


def is_range(event) -> bool:
    """Whether a profiler event is a ``record_function`` range (its device
    side spans the range's kernels and the gaps between them)."""
    return bool(getattr(event, "is_user_annotation", False))


def busy_us(events) -> float:
    """Length of the union of the device intervals among events (kernels
    and copies; ranges left out)."""
    ivs = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == DeviceType.CUDA and not is_range(e))
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
    for label, V, mode in RUNS:
        cfg = LDAConfig(number_of_topics=K, inference_mode="vb",
                        inner_iterations=50, convergence_threshold=1e-5,
                        seed=0, sstats_mode=mode)
        corpus, _, _ = synthetic_corpus(num_docs=D, num_topics=K, num_types=V,
                                        mean_doc_length=MEAN_LEN, seed=0)
        eng = VariationalBayes(cfg, device=dev)
        eng.initialize(corpus)
        eng.learning_many(2)
        eng.learning_many(2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.learning_many(ITERS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / ITERS * 1e3
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            eng.learning_many(ITERS)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy = busy_us(prof.events())
        print(f"{label}, sstats_mode={mode}: {ms:.3f} ms an iteration (host "
              f"clock); learning_many({ITERS}) under the profiler wall "
              f"{wall_us / ITERS / 1e3:.3f} ms an iteration, device busy "
              f"{busy / ITERS / 1e3:.3f} ms an iteration, idle share "
              f"{1.0 - busy / wall_us:.3f}")
        averages = prof.key_averages()
        rows = sorted(
            (e for e in averages
             if e.self_device_time_total > 0 and not is_range(e)),
            key=lambda e: -e.self_device_time_total)[:8]
        for e in rows:
            print(f"  {e.self_device_time_total / ITERS / 1e3:.4f} ms an "
                  f"iteration, {e.count // ITERS} launches an iteration: {e.key[:90]}")
        for e in averages:
            if e.key in WAITS:
                print(f"  waits: {e.key} x{e.count // ITERS} an iteration, "
                      f"{e.cpu_time_total / ITERS / 1e3:.3f} ms host")
        top = sorted(averages, key=lambda e: -e.self_cpu_time_total)[:15]
        for e in top:
            print(f"  host {e.self_cpu_time_total / ITERS / 1e3:.3f} ms an "
                  f"iteration (self), x{e.count // ITERS}: {e.key[:80]}")
        del eng, corpus


if __name__ == "__main__":
    main()
