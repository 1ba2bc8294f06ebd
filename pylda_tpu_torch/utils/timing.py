"""Wall time of one phase on the engine's device.

On a CUDA device each timed call is bracketed by CUDA events recorded on
the current stream, after a warm call and a ``torch.cuda.synchronize()``:
the events time the device work of that call's launches, not their
enqueue.  On the CPU the host clock times the call.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Tuple

import torch


def best_ms(fn: Callable[[], Any], device: torch.device,
            repeats: int = 3) -> Tuple[float, Any]:
    """(the best of ``repeats`` timed calls of ``fn`` in ms, the warm
    call's result)."""
    out = fn()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    best = float("inf")
    for _ in range(max(1, repeats)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            ms = start.elapsed_time(stop)
        else:
            t0 = time.perf_counter()
            fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms)
    return best, out
