"""The C corpus tokenizer (``_fastcorpus.c``), built at first use.

Counterpart of ``pylda_tpu.native``: ``parse_lines(lines, vocab)`` and
``parse_stats`` with the reference parser's semantics (lowercase,
whitespace split, out-of-vocabulary tokens dropped), a reusable
``NativeVocabTable``, and ``HAVE_NATIVE``.  The C path takes ASCII
corpora in one pass over the raw bytes; non-ASCII input goes to the
Python parser, whose Unicode lowercasing C cannot match.

The JAX package builds its copy of the source with ``setup.py``; this
package compiles its own copy on first use (``native_module``) with the
system C compiler (``cc`` or ``gcc`` on ``PATH``) against the running
interpreter's headers (``sysconfig``), into ``build/pylda_tpu_torch/``
beside the package, named by a hash of the source, the compiler, the
headers' path and the flags: an unchanged source is built once.  Builds
of several processes meet at a file lock, and each writes a temporary
file and renames it into place, so no process loads a half-written
library.  The library is loaded under the name
``pylda_tpu_torch.native._fastcorpus``, whose last part names its init
function.  When the build fails, parsing stays in Python: ``HAVE_NATIVE``
is False, ``BUILD_ERROR`` holds the compiler's message, and a warning
shows it once.
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.util
import os
import pathlib
import shutil
import subprocess
import sysconfig
import threading
import warnings
from typing import Iterable, List, Optional, Sequence

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().with_name("_fastcorpus.c")
BUILD_DIR = SOURCE.parent.parent.parent / "build" / "pylda_tpu_torch"
MODULE_NAME = "pylda_tpu_torch.native._fastcorpus"
CFLAGS = ("-O3", "-shared", "-fPIC")

_LOCK = threading.Lock()
_STATE: dict = {}  # "module": the loaded extension or None; "error": str
BUILD_ERROR: Optional[str] = None


def _compiler() -> str:
    for name in ("cc", "gcc"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C compiler (cc or gcc) on PATH")


def library_path(cc: str) -> pathlib.Path:
    """The built library's path: the source, the compiler, the headers'
    directory and the flags hashed into its name."""
    include = sysconfig.get_paths()["include"]
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update("\0".join((cc, include, *CFLAGS)).encode())
    return BUILD_DIR / f"_fastcorpus-{h.hexdigest()[:16]}.so"


def _build(cc: str, out: pathlib.Path) -> None:
    """Compile the source to ``out`` unless another process did: under
    the build directory's lock, to a temporary name renamed into place."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "_fastcorpus.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        include = sysconfig.get_paths()["include"]
        cmd = [cc, *CFLAGS, f"-I{include}", "-o", str(tmp), str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{' '.join(cmd)} failed:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)


def _load(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(MODULE_NAME, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def native_module():
    """The C extension, built and loaded on first call; None when it
    cannot be built (``BUILD_ERROR`` says why)."""
    global BUILD_ERROR
    with _LOCK:
        if "module" not in _STATE:
            try:
                cc = _compiler()
                path = library_path(cc)
                if not path.exists():
                    _build(cc, path)
                _STATE["module"] = _load(path)
            except (OSError, RuntimeError, ImportError,
                    subprocess.SubprocessError) as e:
                _STATE["module"] = None
                BUILD_ERROR = str(e)
                warnings.warn(
                    f"the C tokenizer could not be built; parsing in Python: "
                    f"{BUILD_ERROR}", RuntimeWarning, stacklevel=3)
        return _STATE["module"]


def have_native() -> bool:
    """Whether the C tokenizer is built and loaded (building it now if it
    was not)."""
    return native_module() is not None


def __getattr__(name: str):
    if name == "HAVE_NATIVE":
        return have_native()
    raise AttributeError(name)


class NativeVocabTable:
    """A C hash table over the vocabulary, reusable across parses."""

    def __init__(self, types: Sequence[str]):
        self._mod = native_module()
        if self._mod is None:
            raise RuntimeError(f"the C tokenizer is not available: "
                               f"{BUILD_ERROR}")
        self._capsule = self._mod.build_vocab(list(types))

    def parse_flat(self, data: bytes):
        """(ids int32 [tokens], line ends int64 [lines]) of ASCII bytes."""
        ids_b, offs_b = self._mod.parse(self._capsule, data)
        return (np.frombuffer(ids_b, dtype=np.int32),
                np.frombuffer(offs_b, dtype=np.int64))

    def parse_bytes(self, data: bytes) -> List[np.ndarray]:
        ids, offs = self.parse_flat(data)
        docs: List[np.ndarray] = []
        start = 0
        for end in offs:
            docs.append(ids[start:end].copy())
            start = int(end)
        return docs


def _python_parse(lines: Iterable[str], vocab) -> List[np.ndarray]:
    """Reference parser semantics: lowercase, whitespace split, OOV
    tokens dropped; one int32 id array per line."""
    docs = []
    for line in lines:
        toks = line.lower().split()
        ids = [vocab.get(t) for t in toks]
        docs.append(np.asarray([i for i in ids if i >= 0], dtype=np.int32))
    return docs


def _stats_of_docs(docs: List[np.ndarray]):
    return (
        np.asarray([d.size for d in docs], np.int64),
        np.asarray([np.unique(d).size if d.size else 0 for d in docs],
                   np.int32),
    )


def _ascii_text(lines) -> tuple:
    """(the lines without terminators, their "\\n" join, or None when the
    text is not ASCII)."""
    if isinstance(lines, str):
        line_list = lines.splitlines()
    else:
        line_list = [line.rstrip("\r\n") for line in lines]
    text = "\n".join(line_list)
    return line_list, (text.encode("ascii") if text.isascii() else None)


def parse_stats(lines: Iterable[str], vocab,
                table: Optional[NativeVocabTable] = None):
    """(token counts int64 [n_lines], unique type counts int32 [n_lines])
    without per-document arrays: on the C path the flat parse is reduced
    with NumPy, unique types counted through the key doc * V + id."""
    if table is None and not have_native():
        return _stats_of_docs(_python_parse(lines, vocab))
    line_list, data = _ascii_text(lines)
    if data is None:
        return _stats_of_docs(_python_parse(line_list, vocab))
    if table is None:
        table = NativeVocabTable(vocab.types)
    ids, ends = table.parse_flat(data)
    n = len(line_list)
    if len(ends) < n:  # "\n".join drops trailing empty lines; restore them
        last = ends[-1] if len(ends) else 0
        ends = np.concatenate([ends, np.full(n - len(ends), last, np.int64)])
    starts = np.concatenate([np.zeros(1, np.int64), ends[:-1]])
    tok_counts = ends - starts
    V = len(vocab)
    doc_of = np.repeat(np.arange(n, dtype=np.int64), tok_counts)
    uniq_keys = np.unique(doc_of * np.int64(V) + ids.astype(np.int64))
    uniq_counts = np.bincount(uniq_keys // np.int64(V),
                              minlength=n).astype(np.int32)
    return tok_counts, uniq_counts


def parse_lines(lines: Iterable[str], vocab,
                table: Optional[NativeVocabTable] = None) -> List[np.ndarray]:
    """Per-document int32 id arrays of ``lines`` (one document a line).
    ``vocab`` has ``.get(token) -> id or -1`` and ``.types``; ``table``
    reuses one C hash table across calls."""
    if table is None and not have_native():
        return _python_parse(lines, vocab)
    line_list, data = _ascii_text(lines)
    if data is None:
        return _python_parse(line_list, vocab)
    if table is None:
        table = NativeVocabTable(vocab.types)
    docs = table.parse_bytes(data)
    # "\n".join cannot represent trailing empty lines; restore them so the
    # document count matches the Python parser's.
    while len(docs) < len(line_list):
        docs.append(np.zeros((0,), np.int32))
    return docs
