"""Corpus parsing and batch layouts.

One document per line, lowercased, whitespace-tokenised, out-of-vocabulary
tokens dropped; VB consumes per-doc (unique type ids, counts), Gibbs/hybrid
consume full token sequences.  Documents are packed into statically-shaped
batches, as in ``pylda_tpu.corpus.corpus``:

- ``DenseBatch``: a dense doc-term count matrix (small vocabularies);
- ``RaggedBucket``: length-bucketed padded ``(ids, counts)`` pairs (large
  vocabularies);
- ``SequenceBucket``: length-bucketed padded token sequences for the
  sampling engines.

Padding is inert by construction: padded token slots carry count 0 and
padded document rows carry an explicit mask.  The batches hold numpy
arrays; the engines move them to their device once at preparation time.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from pylda_tpu_torch.corpus.vocabulary import Vocabulary
from pylda_tpu_torch.native import parse_lines
from pylda_tpu_torch.utils import round_up as _round_up


@dataclasses.dataclass(frozen=True)
class DenseBatch:
    """Dense doc-term counts."""

    counts: np.ndarray  # [D, V] float32
    mask: np.ndarray  # [D] float32, 1.0 for real docs
    doc_ids: np.ndarray  # [D] int32, -1 for padding rows

    @property
    def num_docs(self) -> int:
        return int(self.mask.sum())

    @property
    def num_tokens(self) -> float:
        return float(self.counts.sum())


@dataclasses.dataclass(frozen=True)
class RaggedBucket:
    """Padded (unique-type ids, counts) rows for one length bucket."""

    ids: np.ndarray  # [D, T] int32 (0 for padded slots)
    cnts: np.ndarray  # [D, T] float32 (0 for padded slots)
    mask: np.ndarray  # [D] float32
    doc_ids: np.ndarray  # [D] int32, -1 for padding rows

    @property
    def num_docs(self) -> int:
        return int(self.mask.sum())

    @property
    def num_tokens(self) -> float:
        return float(self.cnts.sum())


@dataclasses.dataclass(frozen=True)
class SequenceBucket:
    """Padded full token sequences for the sampling engines."""

    tokens: np.ndarray  # [D, L] int32 (0 for padded slots)
    token_mask: np.ndarray  # [D, L] float32
    mask: np.ndarray  # [D] float32
    doc_ids: np.ndarray  # [D] int32

    @property
    def num_docs(self) -> int:
        return int(self.mask.sum())

    @property
    def num_tokens(self) -> float:
        return float(self.token_mask.sum())


class GeometryOverflow(ValueError):
    """A fixed bucket geometry cannot hold this document subset (the
    largest bucket's capacity overflowed)."""


class Corpus:
    """A tokenised corpus: per-document token-id sequences + vocabulary."""

    process_local: bool = False
    global_doc_offset: int = 0

    def __init__(
        self,
        docs: Sequence[np.ndarray],
        vocab: Vocabulary,
        uniques: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None,
    ):
        self.docs: List[np.ndarray] = [
            np.asarray(d, dtype=np.int32) for d in docs
        ]
        self.vocab = vocab
        # Per-doc unique (ids, counts); ``uniques`` lets callers inject
        # precomputed bag-of-words rows.
        if uniques is not None:
            self._uniques = [
                (
                    np.asarray(i, dtype=np.int32),
                    np.asarray(c, dtype=np.float32),
                )
                for i, c in uniques
            ]
            return
        self._uniques: List[Tuple[np.ndarray, np.ndarray]] = []
        for d in self.docs:
            if d.size:
                ids, cnts = np.unique(d, return_counts=True)
            else:
                ids = np.zeros((0,), np.int32)
                cnts = np.zeros((0,), np.int64)
            self._uniques.append(
                (ids.astype(np.int32), cnts.astype(np.float32))
            )

    # -- construction --------------------------------------------------------

    @classmethod
    def from_lines(
        cls, lines: Iterable[str], vocab: Vocabulary
    ) -> "Corpus":
        """Reference parser semantics (lowercase, whitespace split, OOV
        dropped), through the C tokenizer (``pylda_tpu_torch.native``:
        ASCII text; other text, or no built tokenizer, in Python)."""
        return cls(parse_lines(list(lines), vocab), vocab)

    @classmethod
    def from_file(cls, path: str, vocab: Vocabulary) -> "Corpus":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_lines(f, vocab)

    # -- stats ----------------------------------------------------------------

    @property
    def num_docs(self) -> int:
        return len(self.docs)

    @property
    def global_num_docs(self) -> int:
        """Corpus-wide document count (== num_docs unless process_local)."""
        return getattr(self, "_global_num_docs", None) or self.num_docs

    @global_num_docs.setter
    def global_num_docs(self, value: int) -> None:
        self._global_num_docs = int(value)

    @property
    def num_types(self) -> int:
        return len(self.vocab)

    @property
    def num_tokens(self) -> int:
        return int(sum(d.size for d in self.docs))

    def doc_unique(self, d: int) -> Tuple[np.ndarray, np.ndarray]:
        return self._uniques[d]

    # -- batch layouts --------------------------------------------------------

    def to_dense(
        self,
        doc_indices: Optional[Sequence[int]] = None,
        pad_docs_to: Optional[int] = None,
    ) -> DenseBatch:
        """Dense [D, V] counts (optionally a subset / padded doc axis)."""
        idx = (
            np.arange(self.num_docs)
            if doc_indices is None
            else np.asarray(doc_indices, dtype=np.int64)
        )
        D = len(idx) if pad_docs_to is None else pad_docs_to
        if D < len(idx):
            raise ValueError("pad_docs_to smaller than document count")
        counts = np.zeros((D, self.num_types), dtype=np.float32)
        mask = np.zeros((D,), dtype=np.float32)
        doc_ids = np.full((D,), -1, dtype=np.int32)
        for row, d in enumerate(idx):
            ids, cnts = self._uniques[d]
            counts[row, ids] = cnts
            mask[row] = 1.0
            doc_ids[row] = d
        return DenseBatch(counts=counts, mask=mask, doc_ids=doc_ids)

    def ragged_row_histogram(self, bucket_sizes: Sequence[int]) -> dict:
        """size -> number of ragged rows the WHOLE corpus contributes to
        that bucket (oversized docs count one row per chunk)."""
        sizes = sorted(bucket_sizes)
        mx = sizes[-1]
        hist = {s: 0 for s in sizes}
        for ids, _ in self._uniques:
            n = ids.size
            if n <= mx:
                hist[next(b for b in sizes if n <= b)] += 1
            else:
                hist[mx] += -(-n // mx)
        return hist

    def to_ragged_buckets(
        self,
        bucket_sizes: Sequence[int] = (64, 128, 256, 512, 1024, 2048),
        doc_pad_multiple: int = 64,
        doc_indices: Optional[Sequence[int]] = None,
        bucket_capacities: Optional[dict] = None,
    ) -> List[RaggedBucket]:
        """Length-bucketed padded (ids, counts); bucket key = unique types.

        ``bucket_capacities`` (size -> row capacity) requests a FIXED
        output geometry: every capacity bucket is emitted with exactly
        that many rows, and rows overflowing a bucket are promoted to the
        next larger one.  Raises ``GeometryOverflow`` when the largest
        bucket cannot absorb the overflow."""
        idx = (
            range(self.num_docs)
            if doc_indices is None
            else [int(i) for i in doc_indices]
        )
        if bucket_capacities is not None:
            bucket_sizes = sorted(bucket_capacities)
        buckets: dict = {}
        max_bucket = max(bucket_sizes)
        for d in idx:
            n = self._uniques[d][0].size
            # Smallest bucket that fits; oversized docs go to the largest
            # bucket in chunks.
            size = next((b for b in bucket_sizes if n <= b), max_bucket)
            buckets.setdefault(size, []).append(d)
        row_lists: dict = {}
        for size in sorted(buckets):
            members = buckets[size]
            rows: List[Tuple[int, np.ndarray, np.ndarray]] = []
            for d in members:
                ids, cnts = self._uniques[d]
                if ids.size <= size:
                    rows.append((d, ids, cnts))
                else:
                    # Chunk an oversized doc into several rows sharing the
                    # same doc id; the E-step treats chunks as separate
                    # docs and gamma assembly recombines them.
                    for s in range(0, ids.size, size):
                        rows.append((d, ids[s : s + size], cnts[s : s + size]))
            row_lists[size] = rows
        if bucket_capacities is not None:
            sizes_asc = sorted(bucket_capacities)
            for i, size in enumerate(sizes_asc):
                rows = row_lists.setdefault(size, [])
                cap = int(bucket_capacities[size])
                if len(rows) > cap:
                    if i + 1 >= len(sizes_asc):
                        raise GeometryOverflow(
                            f"bucket {size}: {len(rows)} rows > capacity "
                            f"{cap} and no larger bucket to promote into"
                        )
                    promote = rows[cap:]
                    del rows[cap:]
                    row_lists.setdefault(sizes_asc[i + 1], [])[:0] = promote
            row_lists = {s: row_lists.get(s, []) for s in sizes_asc}
        out: List[RaggedBucket] = []
        for size in sorted(row_lists):
            rows = row_lists[size]
            if bucket_capacities is None and not rows:
                continue
            D = (
                int(bucket_capacities[size])
                if bucket_capacities is not None
                else _round_up(len(rows), doc_pad_multiple)
            )
            ids_a = np.zeros((D, size), dtype=np.int32)
            cnt_a = np.zeros((D, size), dtype=np.float32)
            mask = np.zeros((D,), dtype=np.float32)
            doc_ids = np.full((D,), -1, dtype=np.int32)
            for r, (d, ids, cnts) in enumerate(rows):
                ids_a[r, : ids.size] = ids
                cnt_a[r, : cnts.size] = cnts
                mask[r] = 1.0
                doc_ids[r] = d
            out.append(
                RaggedBucket(ids=ids_a, cnts=cnt_a, mask=mask, doc_ids=doc_ids)
            )
        return out

    def to_sequence_buckets(
        self,
        bucket_sizes: Sequence[int] = (64, 128, 256, 512, 1024, 2048),
        doc_pad_multiple: int = 64,
        doc_indices: Optional[Sequence[int]] = None,
        rng: Optional[np.random.Generator] = None,
    ) -> List[SequenceBucket]:
        """Length-bucketed padded token sequences (sampling engines).

        Oversized documents are split into several rows sharing their doc
        id, never truncated.  ``rng`` optionally shuffles an oversized doc
        before chunking so each chunk is a uniform subsample."""
        idx = (
            range(self.num_docs)
            if doc_indices is None
            else [int(i) for i in doc_indices]
        )
        max_bucket = max(bucket_sizes)
        rows: List[Tuple[int, np.ndarray]] = []
        for d in idx:
            seq = self.docs[d]
            if seq.size > max_bucket:
                if rng is not None:
                    seq = rng.permutation(seq)
                for s in range(0, seq.size, max_bucket):
                    rows.append((d, seq[s : s + max_bucket]))
            else:
                rows.append((d, seq))
        buckets: dict = {}
        for d, seq in rows:
            size = next(
                (b for b in bucket_sizes if seq.size <= b), max_bucket
            )
            buckets.setdefault(size, []).append((d, seq))
        out: List[SequenceBucket] = []
        for size in sorted(buckets):
            members = buckets[size]
            D = _round_up(len(members), doc_pad_multiple)
            toks = np.zeros((D, size), dtype=np.int32)
            tmask = np.zeros((D, size), dtype=np.float32)
            mask = np.zeros((D,), dtype=np.float32)
            doc_ids = np.full((D,), -1, dtype=np.int32)
            for r, (d, seq) in enumerate(members):
                toks[r, : seq.size] = seq
                tmask[r, : seq.size] = 1.0
                mask[r] = 1.0
                doc_ids[r] = d
            out.append(
                SequenceBucket(
                    tokens=toks, token_mask=tmask, mask=mask, doc_ids=doc_ids
                )
            )
        return out

    # -- splits / minibatches -------------------------------------------------

    def subset(self, doc_indices: Sequence[int]) -> "Corpus":
        return Corpus([self.docs[int(i)] for i in doc_indices], self.vocab)

    def minibatch_indices(
        self, batch_size: int, seed: int = 0
    ) -> List[np.ndarray]:
        """A random partition of documents into fixed-size minibatches."""
        rng = np.random.default_rng(seed)
        perm = rng.permutation(self.num_docs)
        return [
            perm[s : s + batch_size]
            for s in range(0, self.num_docs, batch_size)
        ]
