"""Batch-layout policy shared by the VB-family engines.

Decides dense vs ragged by vocabulary size, plans the ragged bucket
geometry (and SVI's fixed minibatch geometry), and splits batches into
bounded-memory chunks.  All host-side numpy, held bit-identical to
``pylda_tpu.models.layouts`` by the tests.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

from pylda_tpu_torch.corpus.corpus import Corpus, DenseBatch, RaggedBucket
from pylda_tpu_torch.utils import round_up as _round_up
from pylda_tpu_torch.utils.config import LDAConfig

VBBatch = Union[DenseBatch, RaggedBucket]


def _split_rows(n_rows: int, chunk: int, pad_multiple: int) -> List[int]:
    chunk = max(pad_multiple, (chunk // pad_multiple) * pad_multiple)
    sizes = []
    done = 0
    while done < n_rows:
        sizes.append(min(chunk, _round_up(n_rows - done, pad_multiple)))
        done += sizes[-1]
    return sizes


def ragged_chunks(rows: int, width: int, num_topics: int, pad: int,
                  memory_budget_mb: float) -> List[int]:
    """Rows of each chunk ``estep_memory_budget_mb`` cuts a ragged block of
    ``rows`` rows (a multiple of ``pad``) at width ``width`` into: its
    [rows, T, K] work arrays stay under the budget, chunks on pad-multiple
    boundaries.  ``build_vb_batches`` and SVI's device-resident rows cut by
    it, and where a launch keeps the block whole (on the card) its chunks
    are the launch's segments, each ending at its own exit sweep."""
    budget_rows = max(pad, int(memory_budget_mb * 1e6
                               / (4 * width * num_topics * 3)))
    if rows <= budget_rows:
        return [rows]
    return _split_rows(rows, budget_rows, pad)


def build_vb_batches(
    corpus: Corpus,
    config: LDAConfig,
    doc_indices: Optional[Sequence[int]] = None,
    pad_docs_to: Optional[int] = None,
    memory_budget_mb: Optional[int] = None,
    bucket_capacities: Optional[dict] = None,
    chunk_ragged: bool = True,
) -> List[VBBatch]:
    """Materialise the corpus (or a subset) as E-step ready batches.

    Rows per chunk are capped so each chunk's work arrays stay under
    ``memory_budget_mb`` (default ``config.estep_memory_budget_mb``).
    ``chunk_ragged=False`` keeps each ragged bucket whole (where the
    E-step makes no [rows, T, K] array: ``chunks_ragged_rows``).
    ``bucket_capacities`` (ragged layout only) requests the fixed bucket
    geometry of ``Corpus.to_ragged_buckets``.  May raise
    ``corpus.GeometryOverflow``."""
    V = corpus.num_types
    K = config.number_of_topics
    pad = config.doc_pad_multiple
    if memory_budget_mb is None:
        memory_budget_mb = config.estep_memory_budget_mb
    out: List[VBBatch] = []
    if V <= config.dense_vocab_threshold:
        idx = (
            np.arange(corpus.num_docs)
            if doc_indices is None
            else np.asarray(doc_indices)
        )
        # Rows per chunk bounded by the [rows, V] work arrays.
        budget_rows = max(pad, int(memory_budget_mb * 1e6 / (4 * max(V, K) * 3)))
        if pad_docs_to is not None:
            sizes = [_round_up(pad_docs_to, pad)]
        else:
            sizes = _split_rows(len(idx), budget_rows, pad)
        start = 0
        for size in sizes:
            sel = idx[start : start + size]
            start += len(sel)
            out.append(corpus.to_dense(doc_indices=sel, pad_docs_to=size))
        return out

    buckets = corpus.to_ragged_buckets(
        bucket_sizes=effective_bucket_sizes(corpus, config),
        doc_pad_multiple=pad,
        doc_indices=doc_indices,
        bucket_capacities=bucket_capacities,
    )
    for b in buckets:
        sizes = ragged_chunks(b.ids.shape[0], b.ids.shape[1], K, pad,
                              memory_budget_mb)
        rows = b.ids.shape[0]
        if len(sizes) == 1 or not chunk_ragged:
            out.append(b)
            continue
        # Chunk on pad-multiple boundaries so every chunk keeps the
        # doc_pad_multiple invariant.
        s = 0
        for size in sizes:
            e = min(rows, s + size)
            out.append(
                RaggedBucket(
                    ids=b.ids[s:e],
                    cnts=b.cnts[s:e],
                    mask=b.mask[s:e],
                    doc_ids=b.doc_ids[s:e],
                )
            )
            s = e
    return out


def chunks_ragged_rows(device_type: str, scatter: bool) -> bool:
    """Whether ``estep_memory_budget_mb`` caps a ragged batch's rows: it
    bounds the [rows, T, K] arrays that the plain versions (on the CPU)
    and the row scatter (``ops/estep.scatter_sstats``) make.  The gamma
    kernels make no such array, so on the card the route with dense
    sufficient statistics takes each bucket in one launch at any K, its
    chunks (``ragged_chunks``) passed as the launch's segments."""
    return device_type != "cuda" or scatter


def plan_bucket_sizes(
    unique_counts: Sequence[int],
    max_buckets: int = 8,
    align: int = 16,
    cap: int = 2048,
    row_pad: int = 64,
    bucket_overhead_slots: int = 4096,
    minibatch_fraction: Optional[float] = None,
    width_rows: Optional[dict] = None,
) -> tuple:
    """Corpus-adaptive ragged bucket geometry: a DP that minimises total
    device slots (rows x bucket width, padding included), since padding
    slots cost a sweep exactly as much as real ones.

    Cost per bucket: ``round_up(rows, row_pad) * width +
    bucket_overhead_slots``; the constant keeps the DP from shattering
    the corpus into near-empty buckets.

    - ``align``: candidate widths are multiples of this.
    - ``cap``: documents with more unique types are chunked to
      ``cap``-wide rows, so each contributes ceil(u/cap) rows of width cap.
    - ``minibatch_fraction``: price buckets by the SVI minibatch capacity
      formula (expected rows + 4 sigma, padded) instead of corpus rows.
    - ``width_rows``: precomputed {aligned width: row count} replacing
      the ``unique_counts`` walk.
    - Returns a sorted tuple of bucket widths, usable directly as
      ``LDAConfig.bucket_sizes``.
    """
    rows: dict = dict(width_rows) if width_rows is not None else {}
    if width_rows is None:
        for u in unique_counts:
            u = int(u)
            if u <= 0:
                continue
            if u > cap:
                rows[cap] = rows.get(cap, 0) + -(-u // cap)
            else:
                w = _round_up(u, align)
                rows[w] = rows.get(w, 0) + 1
    rows = {w: r for w, r in rows.items() if r > 0}
    if not rows:
        return (align,)
    widths = sorted(rows)  # candidate edges (aligned)
    n = len(widths)
    counts = np.array([rows[w] for w in widths], dtype=np.int64)
    cum = np.concatenate([[0], np.cumsum(counts)])

    def seg_rows(i: int, j: int) -> int:
        r = int(cum[j + 1] - cum[i])
        if minibatch_fraction is not None:
            e = r * minibatch_fraction
            return _round_up(
                int(np.ceil(e + 4.0 * np.sqrt(max(e, 1.0)))), row_pad
            )
        return _round_up(r, row_pad)

    def seg_cost(i: int, j: int) -> int:  # widths[i..j] into one bucket
        return seg_rows(i, j) * widths[j] + bucket_overhead_slots

    INF = float("inf")
    m = min(max_buckets, n)
    # f[b][j] = min cost covering widths[0..j-1] with b buckets.
    f = [[INF] * (n + 1) for _ in range(m + 1)]
    back = [[-1] * (n + 1) for _ in range(m + 1)]
    f[0][0] = 0.0
    for b in range(1, m + 1):
        for j in range(1, n + 1):
            for i in range(j):
                if f[b - 1][i] == INF:
                    continue
                c = f[b - 1][i] + seg_cost(i, j - 1)
                if c < f[b][j]:
                    f[b][j] = c
                    back[b][j] = i
    best_b = min(range(1, m + 1), key=lambda b: f[b][n])
    edges = []
    j, b = n, best_b
    while j > 0:
        i = back[b][j]
        edges.append(widths[j - 1])
        j, b = i, b - 1
    return tuple(sorted(edges))


def unique_counts_of(corpus: Corpus) -> Optional[np.ndarray]:
    """Per-document unique-type counts, from whichever representation the
    corpus keeps (in-RAM ``_uniques`` or a streaming index's
    ``_unique_counts``); None when unavailable."""
    uniques = getattr(corpus, "_uniques", None)
    if uniques is not None:
        return np.asarray([ids.size for ids, _ in uniques], dtype=np.int64)
    counts = getattr(corpus, "_unique_counts", None)
    if counts is None:
        return None
    return np.asarray(counts, dtype=np.int64)


def aligned_width_histogram(
    unique_counts: np.ndarray, align: int = 16, cap: int = 2048
) -> np.ndarray:
    """Fixed-length [cap // align] row-count vector over aligned widths
    (bin i = width (i+1)*align; oversized docs contribute ceil(u/cap)
    rows to the last bin).  A fixed bin set lets hosts add their vectors
    for a global geometry plan."""
    u = np.asarray(unique_counts, dtype=np.int64)
    u = u[u > 0]
    n_bins = cap // align
    out = np.zeros((n_bins,), dtype=np.int64)
    small = u[u <= cap]
    # Docs with u in (align*n_bins, cap] (cap not a multiple of align)
    # land in the last bin.
    bins = np.minimum((small + align - 1) // align - 1, n_bins - 1)
    np.add.at(out, bins, 1)
    big = u[u > cap]
    out[-1] += int((-(-big // cap)).sum())
    return out


def effective_bucket_sizes(
    corpus: Corpus,
    config: LDAConfig,
    minibatch_fraction: Optional[float] = None,
) -> tuple:
    """The ragged bucket geometry an engine should use for ``corpus``.

    ``bucket_policy="auto"`` plans a slot-minimising geometry from the
    corpus's unique-type histogram (``plan_bucket_sizes``); an explicit
    non-default ``bucket_sizes``, ``bucket_policy="fixed"``, a
    process-local corpus, or a corpus without the histogram keep the
    configured fixed ``bucket_sizes``.
    """
    fixed = tuple(config.bucket_sizes)
    if config.bucket_policy != "auto":
        return fixed
    if fixed != LDAConfig.__dataclass_fields__["bucket_sizes"].default:
        return fixed  # explicit user geometry wins over the planner
    if getattr(corpus, "process_local", False):
        return fixed
    counts = unique_counts_of(corpus)
    if counts is None:
        return fixed
    key = (max(fixed), config.doc_pad_multiple, minibatch_fraction)
    cache = corpus.__dict__.setdefault("_auto_bucket_cache", {})
    if key not in cache:  # O(D) histogram walk — plan once per corpus
        cache[key] = plan_bucket_sizes(
            counts,
            cap=key[0],
            row_pad=key[1],
            minibatch_fraction=minibatch_fraction,
        )
    return cache[key]


def effective_sequence_bucket_sizes(corpus: Corpus, config: LDAConfig
                                    ) -> tuple:
    """The sequence-layout geometry of the sampling engines (Gibbs,
    hybrid): ``effective_bucket_sizes`` keyed on each document's TOKEN
    count (a sweep's cost is rows x width), with documents over the cap
    chunked to cap-wide rows.  The same fallbacks to the fixed
    ``bucket_sizes``, and a corpus without in-RAM documents keeps them."""
    fixed = tuple(config.bucket_sizes)
    if config.bucket_policy != "auto":
        return fixed
    if fixed != LDAConfig.__dataclass_fields__["bucket_sizes"].default:
        return fixed
    if getattr(corpus, "process_local", False):
        return fixed
    uniques = getattr(corpus, "_uniques", None)
    if uniques is None:
        return fixed
    key = ("seq", max(fixed), config.doc_pad_multiple)
    cache = corpus.__dict__.setdefault("_auto_bucket_cache", {})
    if key not in cache:
        cache[key] = plan_bucket_sizes(
            [int(c.sum()) for _, c in uniques],
            cap=key[1],
            row_pad=key[2],
        )
    return cache[key]


def svi_capacities_from_expected(
    sizes: Sequence[int], expected: dict, pad: int
) -> Optional[dict]:
    """Capacity plan (bucket size -> fixed row capacity) from EXPECTED
    per-minibatch row counts per bucket.

    Each capacity covers the hypergeometric row-count fluctuation at +4
    sigma (overflow probability ~3e-5 per bucket per batch).  Buckets
    expecting fewer than half a pad-multiple of rows a minibatch are
    dropped: their documents promote into the next larger bucket.  The
    largest size with any expected mass is always kept.  Deterministic
    in ``(sizes, expected, pad)``."""
    sizes = sorted(sizes)
    top = max((s for s in sizes if expected.get(s, 0) > 0), default=sizes[0])
    caps = {}
    carry = 0.0  # expected rows of dropped buckets promote upward
    for s in sizes:
        if s > top:
            break
        e = float(expected.get(s, 0)) + carry
        if s < top and e < pad / 2:
            carry = e
            continue
        carry = 0.0
        caps[s] = _round_up(int(np.ceil(e + 4.0 * np.sqrt(max(e, 1.0)))), pad)
    return caps or None


def plan_svi_ragged_geometry(
    corpus: Corpus, config: LDAConfig, batch_size: int
) -> Optional[dict]:
    """Capacity plan (bucket size -> fixed row capacity) for SVI
    minibatches on the ragged layout: every minibatch is packed into the
    same bucket shapes, so the corpus's rows can sit on the device once
    and each minibatch gathers its rows by index.  The widths are planned
    under the minibatch capacity cost model (expected rows + 4 sigma,
    padded); a minibatch that overflows a capacity takes per-batch shapes
    (``GeometryOverflow``)."""
    pad = config.doc_pad_multiple
    D = corpus.num_docs
    if D == 0 or batch_size <= 0:
        return None
    f = min(1.0, batch_size / D)
    sizes = sorted(effective_bucket_sizes(corpus, config, minibatch_fraction=f))
    hist = corpus.ragged_row_histogram(sizes)
    return svi_capacities_from_expected(
        sizes, {s: hist[s] * f for s in sizes}, pad
    )


def assemble_gamma(
    doc_ids_list: List[np.ndarray],
    gammas: List[np.ndarray],
    num_docs: int,
    alpha: np.ndarray,
) -> np.ndarray:
    """Stitch per-batch gamma rows back into corpus document order.

    ``doc_ids_list[i][row]`` is the document index of ``gammas[i][row]``
    (-1 for padding rows).  Oversized documents split into several chunk
    rows (same doc id) recombine additively:
    gamma_doc = alpha + sum_chunks (gamma_chunk - alpha), exact because
    the gamma update is additive over a document's token set at a fixed
    phi.
    """
    alpha = np.asarray(alpha)
    out = np.tile(alpha[None, :], (num_docs, 1))
    for doc_ids, g in zip(doc_ids_list, gammas):
        doc_ids = np.asarray(doc_ids)
        valid = doc_ids >= 0
        np.add.at(out, doc_ids[valid], np.asarray(g)[valid] - alpha)
    return out
