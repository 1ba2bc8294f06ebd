"""Structured metrics/logging.

Counterpart of ``pylda_tpu.utils.metrics``: the reference prints the
iteration, wall seconds and log-likelihood to stdout and encodes the config
into the output directory's name; ``MetricsLogger`` keeps those stdout
lines and adds a ``metrics.jsonl`` stream per run, both from process 0
only.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

import torch


def is_host_zero() -> bool:
    """True in a single process, or in rank 0 of an initialised
    ``torch.distributed`` process group."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


class MetricsLogger:
    """Stdout + JSONL metrics, emitted from process 0 only."""

    def __init__(self, output_directory: Optional[str] = None):
        self._jsonl = None
        if output_directory is not None and is_host_zero():
            os.makedirs(output_directory, exist_ok=True)
            self._jsonl = open(
                os.path.join(output_directory, "metrics.jsonl"),
                "a",
                encoding="utf-8",
            )
        self._t0 = time.time()

    def log(self, **fields) -> None:
        if not is_host_zero():
            return
        fields.setdefault("wall_time", round(time.time() - self._t0, 3))
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(fields) + "\n")
            self._jsonl.flush()
        msg = " ".join(f"{k}={v}" for k, v in fields.items())
        print(msg, file=sys.stdout, flush=True)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
