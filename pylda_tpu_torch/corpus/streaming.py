"""Disk-backed streaming corpus for SVI.

Counterpart of ``pylda_tpu.corpus.streaming``.  ``Corpus`` keeps every
document (token arrays and per-document uniques) in host RAM;
``StreamingCorpus`` keeps only the byte offset of each line of
``doc.dat`` (8 bytes a document) and the per-document unique-type counts
(4 bytes), and serves just the requested documents when a layout is
built.

Parsed-row sidecar: the indexing pass reads every document once and
writes what it parsed next to ``doc.dat``, in the directory
``doc.dat.rowcache.v2.<lo>-<hi>``: raw int32 token ids (``ids.bin``), the
raw int32 / float32 per-document unique (ids, counts) rows (``uids.bin``,
``ucnts.bin``), their int64 offsets (``offsets.npy``, ``uoffsets.npy``),
the unique counts (``uniq.npy``) and a fingerprint of the text file and
the vocabulary (``meta.json``: size, mtime in ns, the vocabulary's SHA-1).
It is published atomically (assembled in a temporary directory, then one
rename).  Layouts then read rows from the memmapped sidecar — the same
values as a parse, since they come from one — and a valid sidecar skips
the indexing pass on reopen.  The format and name are the JAX package's,
so a sidecar written by either package is valid for the other.  When the
directory is unwritable (or ``row_cache="off"``) documents are re-parsed
from their lines on demand.

Documents parse through the C tokenizer (``pylda_tpu_torch.native``:
lowercase, whitespace split, out-of-vocabulary tokens dropped; the
indexing pass reuses one vocabulary table for all its blocks), or in
Python for non-ASCII text or without a built tokenizer: the same
documents either way.

Duck-types the part of the ``Corpus`` surface the engines use:
``num_docs / num_types / num_tokens / global_num_docs /
minibatch_indices / to_dense / ragged_row_histogram / to_ragged_buckets
/ subset``.  With ``process_index``/``process_count`` > 1 it indexes
only block ``process_index`` of the file's documents (the loader's ceil
block size): ``process_local`` is True, ``global_doc_offset`` is the
block's first line and ``global_num_docs`` the file's count, and the
sidecar is the block's own (``.<lo>-<hi>``).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import List, Optional, Sequence

import numpy as np

from pylda_tpu_torch.corpus.corpus import Corpus, DenseBatch, RaggedBucket
from pylda_tpu_torch.corpus.vocabulary import Vocabulary
from pylda_tpu_torch.native import NativeVocabTable, have_native, parse_lines
from pylda_tpu_torch.parallel.mesh import block_bounds

_ROWCACHE_VERSION = 2
_PARSE_BLOCK = 4096  # lines a parse step of the indexing pass


class StreamingCorpus:
    """Offset-indexed view of a doc.dat file; documents parse on demand
    or are read from the parsed-row sidecar (module docstring)."""

    process_local = False
    global_doc_offset = 0

    def __init__(
        self,
        path: str,
        vocab: Vocabulary,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        row_cache: str = "auto",
    ):
        if row_cache not in ("auto", "off"):
            raise ValueError(f"unknown row_cache mode: {row_cache}")
        self.path = os.path.abspath(path)
        self.vocab = vocab
        # Pass 1: byte offsets only (8 bytes a document, no parsing).
        offsets = [0]
        with open(self.path, "rb") as f:
            for line in f:
                offsets.append(offsets[-1] + len(line))
        self._offsets = np.asarray(offsets, dtype=np.int64)
        self._total_docs = len(offsets) - 1
        self._lo, self._hi = 0, self._total_docs
        if process_index is not None and (process_count or 1) > 1:
            self._lo, self._hi = block_bounds(self._total_docs, process_index,
                                              process_count)
            self.process_local = True
            self.global_doc_offset = self._lo
        self._row_ids = None  # memmap of the sidecar's int32 token stream
        self._row_offsets = None  # int64 [num_docs + 1]
        if row_cache == "auto" and self._load_rowcache():
            return
        # Pass 2: the token count and per-document unique counts (and,
        # with the cache on, the sidecar), parsing a block at a time.
        self._index_scan(write_cache=(row_cache == "auto"))

    # -- indexing pass + sidecar --------------------------------------------

    def _open_cache_files(self):
        """Three temporary files beside doc.dat for the sidecar's ids,
        uids and ucnts, as (file, path) pairs; [] when the directory is
        unwritable."""
        opened = []
        try:
            for _ in range(3):
                fd, tp = tempfile.mkstemp(
                    prefix=os.path.basename(self.path) + ".rowcache.",
                    dir=os.path.dirname(self.path),
                )
                opened.append((os.fdopen(fd, "wb"), tp))
        except OSError:
            for fobj, tp in opened:
                fobj.close()
                os.unlink(tp)
            return []
        return opened

    def _index_scan(self, write_cache: bool) -> None:
        files = self._open_cache_files() if write_cache else []
        table = NativeVocabTable(self.vocab.types) if have_native() else None
        uniq_chunks: List[np.ndarray] = []
        lens_chunks: List[np.ndarray] = []

        def consume(lines: List[str]) -> None:
            docs = parse_lines(lines, self.vocab, table=table)
            nuniq = np.empty((len(docs),), dtype=np.int32)
            for di, d in enumerate(docs):
                uids, ucnts = np.unique(d, return_counts=True)
                nuniq[di] = uids.size
                if files:
                    for (fobj, _), arr, dt in zip(
                            files, (d, uids, ucnts),
                            (np.int32, np.int32, np.float32)):
                        fobj.write(np.ascontiguousarray(arr, dt).tobytes())
            uniq_chunks.append(nuniq)
            lens_chunks.append(np.asarray([d.size for d in docs], np.int64))

        try:
            with open(self.path, "rb") as f:
                f.seek(self._offsets[self._lo])
                chunk: List[str] = []
                for g in range(self._lo, self._hi):
                    chunk.append(
                        f.read(self._offsets[g + 1] - self._offsets[g])
                        .decode("utf-8", errors="replace"))
                    if len(chunk) >= _PARSE_BLOCK:
                        consume(chunk)
                        chunk = []
                if chunk:
                    consume(chunk)
        except Exception:
            for fobj, tp in files:
                fobj.close()
                os.unlink(tp)
            raise
        # Per-document unique counts (4 bytes a document): the SVI
        # capacity planner's input, without another corpus pass.
        self._unique_counts = (np.concatenate(uniq_chunks) if uniq_chunks
                               else np.zeros((0,), np.int32))
        row_offsets = np.zeros((self.num_docs + 1,), dtype=np.int64)
        if lens_chunks:
            np.cumsum(np.concatenate(lens_chunks), out=row_offsets[1:])
        self._local_tokens = int(row_offsets[-1])
        if not files:
            return
        try:
            for fobj, _ in files:
                fobj.close()
            self._publish_rowcache([tp for _, tp in files], row_offsets)
        except OSError:
            for _, tp in files:
                if os.path.exists(tp):
                    os.unlink(tp)

    def _rowcache_dir(self) -> str:
        return (f"{self.path}.rowcache.v{_ROWCACHE_VERSION}"
                f".{self._lo}-{self._hi}")

    def _fingerprint(self) -> dict:
        st = os.stat(self.path)
        h = hashlib.sha1()
        for t in self.vocab.types:
            h.update(t.encode("utf-8"))
            h.update(b"\n")
        return {
            "version": _ROWCACHE_VERSION,
            "doc_dat_bytes": st.st_size,
            "doc_dat_mtime_ns": st.st_mtime_ns,
            "lo": self._lo,
            "hi": self._hi,
            "vocab_sha1": h.hexdigest(),
            "vocab_size": len(self.vocab),
        }

    def _publish_rowcache(self, tmp_paths: Sequence[str],
                          row_offsets: np.ndarray) -> None:
        """Assemble the sidecar in a temporary directory, then one
        rename: a process killed mid-write never leaves a half-valid
        sidecar."""
        final = self._rowcache_dir()
        tmp_dir = tempfile.mkdtemp(prefix=os.path.basename(final) + ".",
                                   dir=os.path.dirname(self.path))
        for tp, name in zip(tmp_paths, ("ids.bin", "uids.bin", "ucnts.bin")):
            os.replace(tp, os.path.join(tmp_dir, name))
        np.save(os.path.join(tmp_dir, "offsets.npy"), row_offsets)
        uoff = np.zeros((self.num_docs + 1,), dtype=np.int64)
        np.cumsum(self._unique_counts, out=uoff[1:])
        np.save(os.path.join(tmp_dir, "uoffsets.npy"), uoff)
        np.save(os.path.join(tmp_dir, "uniq.npy"), self._unique_counts)
        with open(os.path.join(tmp_dir, "meta.json"), "w") as f:
            json.dump(self._fingerprint(), f)
        try:
            os.rename(tmp_dir, final)
        except OSError:
            # A sidecar is there already: another process's of this text
            # and vocabulary (keep it), or a stale one of another
            # vocabulary under the same name (replace it).
            if not self._sidecar_valid(final):
                shutil.rmtree(final, ignore_errors=True)
                try:
                    os.rename(tmp_dir, final)
                except OSError:
                    pass
            shutil.rmtree(tmp_dir, ignore_errors=True)
        # Documents parse on demand unless a valid sidecar stands.
        self._load_rowcache()

    def _sidecar_valid(self, d: str) -> bool:
        try:
            with open(os.path.join(d, "meta.json")) as f:
                return json.load(f) == self._fingerprint()
        except (OSError, ValueError):
            return False

    def _load_rowcache(self) -> bool:
        d = self._rowcache_dir()
        if not self._sidecar_valid(d):
            return False
        try:
            self._attach_rowcache(d)
        except (OSError, ValueError, KeyError):
            self._row_ids = None
            return False
        self._local_tokens = int(self._row_offsets[-1])
        self._unique_counts = np.load(os.path.join(d, "uniq.npy"))
        return True

    def _attach_rowcache(self, d: str) -> None:
        self._row_offsets = np.load(os.path.join(d, "offsets.npy"))
        self._row_ids = np.memmap(os.path.join(d, "ids.bin"), dtype=np.int32,
                                  mode="r", shape=(int(self._row_offsets[-1]),))
        self._uoffsets = np.load(os.path.join(d, "uoffsets.npy"))
        un = (int(self._uoffsets[-1]),)
        self._uids = np.memmap(os.path.join(d, "uids.bin"), dtype=np.int32,
                               mode="r", shape=un)
        self._ucnts = np.memmap(os.path.join(d, "ucnts.bin"),
                                dtype=np.float32, mode="r", shape=un)

    # -- stats ----------------------------------------------------------------

    @property
    def num_docs(self) -> int:
        return self._hi - self._lo

    @property
    def global_num_docs(self) -> int:
        return self._total_docs

    @property
    def num_types(self) -> int:
        return len(self.vocab)

    @property
    def num_tokens(self) -> int:
        """Token count after out-of-vocabulary tokens are dropped, from
        the indexing pass (``Corpus.num_tokens``'s semantics)."""
        return self._local_tokens

    # -- on-demand parsing ------------------------------------------------------

    def _parse(self, doc_indices: Sequence[int]) -> Corpus:
        """A ``Corpus`` of ONLY the requested documents: their rows from
        the memmapped sidecar when one is attached (the parser's values,
        uniques included), else a parse of just those lines."""
        if self._row_ids is not None:
            offs, uoffs = self._row_offsets, self._uoffsets
            docs, uniques = [], []
            for i in doc_indices:
                i = int(i)
                docs.append(np.array(self._row_ids[offs[i]:offs[i + 1]]))
                uniques.append((np.array(self._uids[uoffs[i]:uoffs[i + 1]]),
                                np.array(self._ucnts[uoffs[i]:uoffs[i + 1]])))
            return Corpus(docs, self.vocab, uniques=uniques)
        lines = []
        with open(self.path, "rb") as f:
            for i in doc_indices:
                g = self._lo + int(i)
                f.seek(self._offsets[g])
                lines.append(f.read(self._offsets[g + 1] - self._offsets[g])
                             .decode("utf-8", errors="replace"))
        return Corpus(parse_lines(lines, self.vocab), self.vocab)

    @staticmethod
    def _remap(batch, doc_indices):
        """Row doc_ids: position in the parsed subset -> corpus index."""
        idx = np.asarray(doc_indices, dtype=np.int32)
        doc_ids = np.where(batch.doc_ids >= 0,
                           idx[np.clip(batch.doc_ids, 0, None)], -1
                           ).astype(np.int32)
        kw = {f: getattr(batch, f) for f in type(batch).__dataclass_fields__}
        kw["doc_ids"] = doc_ids
        return type(batch)(**kw)

    def _indices(self, doc_indices: Optional[Sequence[int]]) -> np.ndarray:
        return (np.arange(self.num_docs) if doc_indices is None
                else np.asarray(doc_indices, dtype=np.int64))

    # -- Corpus-surface layout builders -----------------------------------------

    def to_dense(
        self,
        doc_indices: Optional[Sequence[int]] = None,
        pad_docs_to: Optional[int] = None,
    ) -> DenseBatch:
        idx = self._indices(doc_indices)
        return self._remap(self._parse(idx).to_dense(pad_docs_to=pad_docs_to),
                           idx)

    def ragged_row_histogram(self, bucket_sizes: Sequence[int]) -> dict:
        """``Corpus.ragged_row_histogram`` from the per-document unique
        counts of the indexing pass — no corpus re-read."""
        sizes = sorted(bucket_sizes)
        mx = sizes[-1]
        hist = {s: 0 for s in sizes}
        edges = np.asarray(sizes)
        small = self._unique_counts[self._unique_counts <= mx]
        which = edges[np.searchsorted(edges, small)]
        for s, c in zip(*np.unique(which, return_counts=True)):
            hist[int(s)] += int(c)
        big = self._unique_counts[self._unique_counts > mx]
        hist[mx] += int((-(-big // mx)).sum())
        return hist

    def to_ragged_buckets(
        self,
        bucket_sizes: Sequence[int] = (64, 128, 256, 512, 1024, 2048),
        doc_pad_multiple: int = 64,
        doc_indices: Optional[Sequence[int]] = None,
        bucket_capacities: Optional[dict] = None,
    ) -> List[RaggedBucket]:
        idx = self._indices(doc_indices)
        return [
            self._remap(b, idx)
            for b in self._parse(idx).to_ragged_buckets(
                bucket_sizes=bucket_sizes,
                doc_pad_multiple=doc_pad_multiple,
                bucket_capacities=bucket_capacities,
            )
        ]

    # -- splits / minibatches ----------------------------------------------------

    def subset(self, doc_indices: Sequence[int]) -> Corpus:
        return self._parse(list(doc_indices))

    def minibatch_indices(self, batch_size: int, seed: int = 0
                          ) -> List[np.ndarray]:
        """The random partition of ``Corpus.minibatch_indices``."""
        rng = np.random.default_rng(seed)
        perm = rng.permutation(self.num_docs)
        return [perm[s: s + batch_size]
                for s in range(0, self.num_docs, batch_size)]
