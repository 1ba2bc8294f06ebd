"""Build and load the package's CUDA kernels.

Each source ``pylda_tpu_torch/csrc/<name>.cu`` is compiled on first use by
``nvcc`` into a shared library with a plain C interface and loaded with
``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v [-DPYLDA_BF16=1] -o build/pylda_tpu_torch/lib<name>-<hash>.so <name>.cu

Each source is built in two modes: "float32", and "bfloat16" with
``-DPYLDA_BF16=1``, the kernels' bf16 operand mode (the JAX functions'
``compute_dtype="bfloat16"``), a compile-time variant of the same source
with the same C entry.  The library lands in ``build/pylda_tpu_torch/``
beside the package (a directory git ignores), named by the source, the
mode and a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header is rebuilt and an unchanged one
is reused.  Nothing is
fetched and nothing outside the checkout is compiled.  ``nvcc`` is looked
up in ``$CUDA_HOME/bin``, then on ``PATH``, then in ``/usr/local/cuda/bin``.
A build that fails raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Tuple

_PACKAGE = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "pylda_tpu_torch"
# Every kernel source of the package; the hygiene test checks they exist.
SOURCES = ("dense_gamma", "dense_sstats", "ragged_gamma")
# The operand modes each source is built in, and their extra nvcc flags.
MODES = {"float32": (), "bfloat16": ("-DPYLDA_BF16=1",)}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[Tuple[str, str], ctypes.CDLL] = {}
# "<name>" (float32) or "<name>/bfloat16" -> nvcc's output (the -Xptxas -v
# register and shared-memory lines) for libraries built in this process.
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    candidates = []
    home = os.environ.get("CUDA_HOME")
    if home:
        candidates.append(os.path.join(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin); "
        "the CUDA kernels of pylda_tpu_torch cannot be built"
    )


def _flags(mode: str) -> Tuple[str, ...]:
    return NVCC_FLAGS + MODES[mode]


def _library_path(name: str, mode: str) -> pathlib.Path:
    """The library's path, named by the source, the mode and a hash of the
    source, every shared header of ``csrc/`` (an edited header rebuilds
    every library) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(_flags(mode)).encode())
    tag = "" if mode == "float32" else f"-{mode}"
    return BUILD_DIR / f"lib{name}{tag}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES,
          modes: Iterable[str] = tuple(MODES)) -> None:
    """Compile every named source in every named mode whose library is
    missing, one ``nvcc`` per library, all started together; raises if any
    of them fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = []
    for name in names:
        for mode in modes:
            out = _library_path(name, mode)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
            cmd = [nvcc, *_flags(mode), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
            label = name if mode == "float32" else f"{name}/{mode}"
            jobs.append((label, proc, tmp, out))
    errors = []
    for label, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        BUILD_LOGS[label] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for {label}:\n{log}")
            continue
        # Atomic publish: a concurrent process never loads a partial file.
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def library(name: str, mode: str = "float32") -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` in ``mode``, built on first
    use."""
    with _LOCK:
        lib = _LIBS.get((name, mode))
        if lib is None:
            path = _library_path(name, mode)
            if not path.exists():
                build([name], [mode])
            lib = ctypes.CDLL(str(path))
            _LIBS[(name, mode)] = lib
        return lib
