"""Build and load the package's CUDA kernels.

Each source ``pylda_tpu_torch/csrc/<name>.cu`` is compiled on first use by
``nvcc`` into a shared library with a plain C interface and loaded with
``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/pylda_tpu_torch/lib<name>-<hash>.so <name>.cu

The library lands in ``build/pylda_tpu_torch/`` beside the package (a
directory git ignores), named by a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is reused.  Nothing is
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
from typing import Dict, Iterable

_PACKAGE = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "pylda_tpu_torch"
# Every kernel source of the package; the hygiene test checks they exist.
SOURCES = ("dense_sstats", "ragged_gamma")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> nvcc's output (the -Xptxas -v register and shared-memory lines)
# for libraries built in this process.
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


def _library_path(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> None:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together; raises if any of them fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = []
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, proc, tmp, out))
    errors = []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
            continue
        # Atomic publish: a concurrent process never loads a partial file.
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib
