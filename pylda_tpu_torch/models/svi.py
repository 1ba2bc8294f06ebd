"""Stochastic variational inference (minibatch) engine.

Counterpart of ``pylda_tpu.models.svi.StochasticVariationalBayes``:
Hoffman et al. 2010 minibatch natural-gradient VB.  Each epoch partitions
the corpus into random minibatches (``Corpus.minibatch_indices`` with
epoch seed ``counter * 100003 + seed``, the JAX engine's schedule), and
for minibatch t of |B| documents:

    local E-step on B (the batch-VB kernels),
    lambda <- (1 - rho_t) lambda + rho_t (eta + (D/|B|) sstats),
    rho_t = (tau0 + t)^(-kappa);

``learning()`` is one epoch and returns the mean of the minibatches'
bound estimates (D/|B| times the doc-side terms, plus the topic-side term
at the epoch's final lambda); the Newton alpha/eta updates run at epoch
ends on schedule.

The corpus sits on the device once and each minibatch gathers its rows
there by index:

- the large-vocabulary layout (V > ``dense_vocab_threshold``): the
  corpus's ragged rows in a fixed bucket geometry
  (``layouts.plan_svi_ragged_geometry``), so every minibatch has the same
  bucket shapes.  While a [D+1, V_pad] counts matrix (bf16 when exact,
  zero row D) fits ``sstats_dense_total_budget_mb`` it sits on the device
  too, and each minibatch gathers its rows for the dense sufficient
  statistics: the gamma fixed point runs per bucket (``ragged_gamma``),
  gammas assemble at minibatch-local positions, and ``dense_sstats``
  computes sstats and the token score.  Otherwise, and for
  ``sstats_mode="scatter"``, each bucket runs the scatter E-step
  (``estep_ragged``: the same gamma kernel, then the row scatter) and no
  counts matrix is built;
- the dense layout: the [D+1, V] doc-term matrix, and the dense E-step
  (``dense_estep``) on each gathered [batch, V] block.

When a minibatch overflows the geometry, or the rows exceed
``svi_device_rows_budget_mb``, the epoch's minibatches are packed on the
host instead (per-batch shapes for an overflowing one) and uploaded; they
run on the same device through the same kernels.  A disk-backed
``corpus.streaming.StreamingCorpus`` feeds every one of these routes:
its rows, parsed blocks or dense blocks are read from its row sidecar
(or re-parsed) when the engine builds them.

PyTorch runs eagerly: ``learning_many`` is a Python loop over epochs and
minibatches whose kernels queue on the device stream, and it reads the
estimates back once.  Per-document gammas are kept by ``learning()``;
after ``learning_many`` the ``gamma`` property recomputes them in one
rho = 0 epoch.  Minibatch i of the epoch at step s draws its gamma inits
(a random ``gamma_init``) from the streams (config seed, tag, s, i,
batch), so ``learning_many(n)`` draws what n ``learning()`` calls draw.
``phase_timings`` times one minibatch step.  On the card every K runs:
above 4096 the gamma kernels' cluster kernel and the sstats kernel's two
passes.  ``estep_memory_budget_mb`` caps the rows a launch takes where
[rows, T, K] arrays are made (on the CPU, as in the JAX engine, and on
the scatter route); on the card the route with dense sufficient
statistics takes each bucket's capacity in one launch
(``models/layouts.chunks_ragged_rows``) whose segments are those chunks,
each ending at its own exit sweep.

Under a mesh (``parallel/mesh.py``) every minibatch's sufficient
statistics and doc-level terms are summed over the ranks
(``_reduce_estep``: two all-reduces a minibatch), so every rank takes the
same lambda step:

- a corpus loaded whole on every rank runs the one-process schedule: the
  same global minibatches, rhos and D/|B| scales, each rank taking the
  r-th contiguous slice of each minibatch's selection;
- a process-local corpus (BASELINE config 5: each rank holds its own
  block of documents) runs the JAX engine's per-host schedule
  (``_process_local_plan``): b_local = ceil(batch_size / P) documents of
  the rank's block a minibatch, in the order of a permutation seeded by
  (epoch seed, rank), which every rank can reconstruct for every other,
  so the global minibatch sizes, scales and rhos agree without
  communication; on the large-vocabulary layout the bucket geometry is
  negotiated across ranks (``negotiate_svi_ragged_geometry``).  The
  dense sufficient statistics run over the rank's own counts matrix,
  where the JAX engine takes the row scatter.

With a model axis (mesh (D, M)) "rank" above reads "data coordinate":
every rank of a model group runs the same minibatches of the same
documents, and the sums run over the data group.  Under ``shard_vocab`` /
``shard_topics`` the natural-gradient step updates this rank's block of
lambda only: its sufficient statistics are the block's (the counts matrix
holds this rank's columns under ``shard_vocab``), and the E-step, the
bound and the Newton eta input follow batch VB's (``models/vb.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from pylda_tpu_torch.corpus.corpus import Corpus, GeometryOverflow
from pylda_tpu_torch.models import layouts
from pylda_tpu_torch.models.base import LDAState
from pylda_tpu_torch.models.vb import (
    TAG_GAMMA_REFRESH,
    TAG_GAMMA_SVI,
    TAG_TIMING,
    VariationalBayes,
    _Bucket,
    _Dense,
    _SstatsPlan,
)
from pylda_tpu_torch.ops.hyper import newton_dirichlet_mle
from pylda_tpu_torch.ops.row_fixed_point import segment_rows
from pylda_tpu_torch.parallel.mesh import (
    block_bounds,
    negotiate_svi_ragged_geometry,
)
from pylda_tpu_torch.utils import round_up
from pylda_tpu_torch.utils.timing import best_ms


@dataclasses.dataclass
class _MinibatchPlan:
    """The corpus's dense counts on the device, for each minibatch's
    scatter-free sufficient statistics."""

    counts: torch.Tensor  # [D+1, V_pad] bf16 or f32; row D is zero
    nonempty: torch.Tensor  # [D+1]: 1 for documents with any token
    num_docs: int  # D
    b_cap: int  # the doc-selection length: batch_size padded
    chunk_sizes: List[int]  # b_cap split to sstats_dense_budget_mb
    # The columns [v0, v1) the counts hold (this rank's under
    # ``shard_vocab``); None: all of them.
    vocab_range: Optional[Tuple[int, int]] = None


@dataclasses.dataclass
class _Rows:
    """The corpus's rows of one layout width on the device, an inert
    sentinel row last (zero counts, document D), and the host-side
    document -> rows map (CSR) that minibatch index assembly reads."""

    ids: Optional[torch.Tensor]  # [R+1, w] int32 (ragged layout)
    cnts: Optional[torch.Tensor]  # [R+1, w] (ragged layout)
    counts: Optional[torch.Tensor]  # [D+1, V] (dense layout)
    row_doc: torch.Tensor  # [R+1] int64: each row's document, D at the sentinel
    cap: int  # rows a minibatch
    chunk_sizes: List[int]  # cap split to estep_memory_budget_mb
    # Where the card takes cap whole: those chunks as the launch's
    # segments (layouts.ragged_chunks); else None.
    segments: Optional[Tuple[int, ...]]
    seg_rows: Optional[torch.Tensor]  # [cap] int32: each row's segment
    doc_of_row: np.ndarray  # [R]
    csr_start: np.ndarray  # [D+1]
    csr_rows: np.ndarray  # [R]
    # Dense layout: the largest nonzero count of a document's row (the
    # gamma launch's max_nnz); None on the ragged layout.
    max_nnz: Optional[int] = None

    @property
    def sentinel(self) -> int:
        return self.doc_of_row.size


# A minibatch's selection: the [b_cap] global document ids (-1 pads) on the
# host and on the device; None on the dense layout.
_Sel = Optional[Tuple[np.ndarray, torch.Tensor]]


@dataclasses.dataclass
class _Epoch:
    """One epoch: its minibatches (device batches with global document
    ids as row indices, and the selection), step sizes and D/|B| scales."""

    minibatches: Iterator[Tuple[list, _Sel]]
    rhos: List[float]
    scales: List[float]

    @property
    def n(self) -> int:
        return len(self.rhos)


class StochasticVariationalBayes(VariationalBayes):
    """SVI: minibatch natural-gradient ascent on lambda."""

    def __init__(self, config, device=None):
        super().__init__(config, device)
        self._t = 0  # global minibatch counter (kept across initialize)
        self._mb_sstats: Optional[_MinibatchPlan] = None
        self._svi_geometry: Optional[dict] = None
        self._device_rows: Optional[List[_Rows]] = None
        self._process_local = False

    # -- setup ----------------------------------------------------------------

    def _prepare(self, corpus: Corpus) -> None:
        cfg = self._config
        local = getattr(corpus, "process_local", False)
        if local:
            self._local_corpus(corpus)  # the JAX engine's refusal, where due
        self._process_local = self._split and local
        self._doc_offset = (corpus.global_doc_offset if self._process_local
                            else 0)
        self._set_gammas(None, None)
        self._mb_sstats = self._svi_geometry = self._device_rows = None
        if self._dense_layout(corpus):
            self._device_rows = self._build_device_dense(corpus)
            return
        self._mb_sstats = self._plan_mb_dense_sstats(corpus)
        if self._process_local:
            self._svi_geometry = negotiate_svi_ragged_geometry(
                corpus, cfg, self._mb_docs(), self._mesh)
        else:
            self._svi_geometry = layouts.plan_svi_ragged_geometry(
                corpus, cfg, cfg.batch_size
            )
        if self._svi_geometry is not None:
            self._device_rows = self._build_device_rows(corpus)

    def _mb_docs(self) -> int:
        """Documents of this rank's corpus a minibatch draws at most:
        b_local = ceil(batch_size / P) for a process-local corpus, else
        ``batch_size``."""
        bs = self._config.batch_size
        return -(-bs // self._mesh.data) if self._process_local else bs

    @staticmethod
    def _unique_blocks(corpus: Corpus, block: int = 4096):
        """(start, [(ids, counts)] of documents start..start+block) over
        the corpus: its cached rows, or for a disk-backed corpus (no
        ``doc_unique``) one parsed block at a time."""
        D = corpus.num_docs
        for start in range(0, D, block):
            stop = min(D, start + block)
            if hasattr(corpus, "doc_unique"):
                yield start, [corpus.doc_unique(d) for d in range(start, stop)]
            else:
                sub = corpus.subset(range(start, stop))
                yield start, [sub.doc_unique(d) for d in range(stop - start)]

    @classmethod
    def _count_stats(cls, corpus: Corpus) -> Tuple[np.ndarray, torch.dtype]:
        """([D+1] f32, 1 for non-empty documents; the storage dtype of
        the counts: bf16 when every count is <= 256, where it is exact)."""
        nonempty = np.zeros((corpus.num_docs + 1,), np.float32)
        maxc = 0.0
        for start, uniq in cls._unique_blocks(corpus):
            for d, (_ids, cts) in enumerate(uniq, start):
                if cts.size:
                    nonempty[d] = 1.0
                    maxc = max(maxc, float(cts.max()))
        return nonempty, (torch.bfloat16 if maxc <= 256.0 else torch.float32)

    def _device_counts(self, corpus: Corpus, width: int,
                       dtype: torch.dtype,
                       cols_range: Optional[Tuple[int, int]] = None
                       ) -> torch.Tensor:
        """[D+1, width] counts of every document on the device (zero row
        D, zero columns past V), filled in blocks of documents so the host
        never holds a dense block; with ``cols_range`` (v0, v1) columns
        v0..v1-1 only, at 0..v1-v0-1."""
        D = corpus.num_docs
        dev = self._device
        v0, v1 = cols_range or (0, corpus.num_types)
        out = torch.zeros((D + 1, width), dtype=dtype, device=dev)
        for start, uniq in self._unique_blocks(corpus):
            cols = np.concatenate([ids for ids, _ in uniq]).astype(np.int64)
            if not cols.size:
                continue
            rows = np.repeat(np.arange(start, start + len(uniq)),
                             [ids.size for ids, _ in uniq])
            vals = np.concatenate([cts for _, cts in uniq])
            if cols_range is not None:
                keep = (cols >= v0) & (cols < v1)
                rows, cols, vals = rows[keep], cols[keep] - v0, vals[keep]
            out.index_put_(
                (torch.as_tensor(rows, device=dev),
                 torch.as_tensor(cols, device=dev)),
                torch.as_tensor(vals, device=dev).to(dtype),
            )
        return out

    def _plan_mb_dense_sstats(self, corpus: Corpus
                              ) -> Optional[_MinibatchPlan]:
        """The [D+1, V_pad] counts matrix of the large-vocabulary layout
        (V padded to a multiple of 1024), and each minibatch's
        doc-selection length split into chunks whose [chunk, V_pad]
        work fits ``sstats_dense_budget_mb``.  None — the minibatches run
        the scatter E-step — where the JAX engine's plan is None:
        ``sstats_mode="scatter"``, no documents or minibatch, or a matrix
        over ``sstats_dense_total_budget_mb`` (tested in bf16 before the
        corpus scan, then in its storage dtype; on the whole vocabulary,
        so a lambda shard takes the one-process route).  Under
        ``shard_vocab`` the matrix holds this rank's columns only."""
        cfg = self._config
        D = corpus.num_docs
        v_pad = round_up(corpus.num_types, 1024)
        budget = cfg.sstats_dense_total_budget_mb * 1e6
        if (cfg.sstats_mode == "scatter" or D == 0 or cfg.batch_size <= 0
                or (D + 1) * v_pad * 2 > budget):
            return None
        nonempty, dtype = self._count_stats(corpus)
        if (D + 1) * v_pad * torch.finfo(dtype).bits // 8 > budget:
            return None
        pad = cfg.doc_pad_multiple
        b_cap = round_up(self._mb_docs(), pad)
        rows_budget = max(pad, int(cfg.sstats_dense_budget_mb * 1e6
                                   // (4 * v_pad)))
        cols = self._own_columns(True)
        if cols is not None:
            v_pad = round_up(cols[1] - cols[0], 1024)
        return _MinibatchPlan(
            counts=self._device_counts(corpus, v_pad, dtype, cols),
            nonempty=torch.as_tensor(nonempty, device=self._device).to(
                self._dtype),
            num_docs=D,
            b_cap=b_cap,
            chunk_sizes=layouts._split_rows(b_cap, rows_budget, pad),
            vocab_range=cols,
        )

    def _build_device_rows(self, corpus: Corpus) -> Optional[List[_Rows]]:
        """The corpus's ragged rows in the geometry's widths, on the
        device once; None over ``svi_device_rows_budget_mb``.  Each width's
        capacity is chunked to ``estep_memory_budget_mb`` exactly as the
        host packing (``build_vb_batches``) chunks it (on the card with
        dense sufficient statistics, ``_chunk_ragged``, one launch whose
        segments are those chunks)."""
        cfg = self._config
        caps = self._svi_geometry
        sizes = sorted(caps)
        hist = corpus.ragged_row_histogram(sizes)
        if sum(hist[s] * s for s in sizes) * 8 / 1e6 > cfg.svi_device_rows_budget_mb:
            return None
        buckets = {
            b.ids.shape[1]: b
            for b in corpus.to_ragged_buckets(bucket_sizes=tuple(sizes),
                                              doc_pad_multiple=1)
        }
        D, K, pad = corpus.num_docs, cfg.number_of_topics, cfg.doc_pad_multiple
        dev = self._device
        out = []
        for s in sizes:
            b = buckets.get(s)
            ids = np.zeros((1, s), np.int32)
            cnts = np.zeros((1, s), np.float32)
            doc_of_row = np.zeros((0,), np.int64)
            if b is not None:
                ids = np.concatenate([b.ids, ids])
                cnts = np.concatenate([b.cnts, cnts])
                doc_of_row = np.asarray(b.doc_ids, np.int64)
            # Rows are doc-major, so a stable sort keeps a chunked
            # document's rows in order.
            start = np.zeros((D + 1,), np.int64)
            np.cumsum(np.bincount(doc_of_row, minlength=D), out=start[1:])
            chunks = layouts.ragged_chunks(int(caps[s]), s, K, pad,
                                           cfg.estep_memory_budget_mb)
            whole = not self._chunk_ragged()
            out.append(_Rows(
                ids=torch.as_tensor(ids, device=dev),
                cnts=torch.as_tensor(cnts, device=dev).to(self._dtype),
                counts=None,
                row_doc=torch.as_tensor(np.append(doc_of_row, D), device=dev),
                cap=int(caps[s]),
                chunk_sizes=[int(caps[s])] if whole else chunks,
                segments=tuple(chunks) if whole and len(chunks) > 1 else None,
                seg_rows=(segment_rows(chunks, dev)
                          if whole and len(chunks) > 1 else None),
                doc_of_row=doc_of_row,
                csr_start=start,
                csr_rows=np.argsort(doc_of_row, kind="stable"),
            ))
        return out

    def _build_device_dense(self, corpus: Corpus) -> Optional[List[_Rows]]:
        """Dense-layout rows: the [D+1, V] doc-term matrix on the device
        once, with the identity document -> row map; None over
        ``svi_device_rows_budget_mb`` (counted in f32, as the JAX engine
        counts it)."""
        cfg = self._config
        D, V = corpus.num_docs, corpus.num_types
        if (D + 1) * V * 4 / 1e6 > cfg.svi_device_rows_budget_mb:
            return None
        if D == 0 or cfg.batch_size <= 0:
            return None
        cap = round_up(self._mb_docs(), cfg.doc_pad_multiple)
        rows = np.arange(D, dtype=np.int64)
        return [_Rows(
            ids=None, cnts=None,
            counts=self._device_counts(corpus, V, self._count_stats(corpus)[1]),
            row_doc=torch.arange(D + 1, device=self._device),
            cap=cap, chunk_sizes=[cap], segments=None, seg_rows=None,
            doc_of_row=rows,
            csr_start=np.arange(D + 1, dtype=np.int64), csr_rows=rows,
            max_nnz=max(ids.size for _, uniq in self._unique_blocks(corpus)
                        for ids, _ in uniq),
        )]

    def _doc_sel_arrays(self, index_lists) -> Optional[List[np.ndarray]]:
        """[b_cap] global document ids per minibatch (-1 pads); None on
        the dense layout.  The minibatch's position map and docs mask
        need each document once: the partition guarantees it, and this
        checks it."""
        if self._mb_sstats is None:
            return None
        out = []
        for sel in index_lists:
            if np.unique(sel).size != len(sel):
                raise ValueError("a minibatch selects a document twice")
            ds = np.full((self._mb_sstats.b_cap,), -1, np.int64)
            ds[: len(sel)] = sel
            out.append(ds)
        return out

    # -- one minibatch ----------------------------------------------------------

    def _minibatch_step(self, lam, alpha, eta, batches, rho, scale,
                        doc_sel: Optional[torch.Tensor], tag: tuple):
        """Local E-step, then lambda <- (1 - rho) lambda + rho (eta +
        scale sstats).  Returns (lambda, the doc-side bound terms times
        scale, the sum of E[log theta] over the minibatch, gammas).
        ``tag`` seeds the gamma inits' streams (``_gamma0s``).

        With the dense sstats plan ``batches`` are buckets whose
        row_index holds each row's global document (D for padding) and
        ``doc_sel`` is the [b_cap] selection (-1 pads): everything after
        the fixed point runs at minibatch-local positions 0..b_cap, and
        the one gamma block returned is in ``doc_sel`` order.  Without it
        (the dense layout, the scatter route) each batch runs its whole
        E-step and returns its own gamma block."""
        gamma0s = self._gamma0s(batches, *tag)
        if self._mb_sstats is None:
            out = self._run_estep_batches(batches, lam, alpha, gamma0s)
        else:
            out = self._run_estep_hybrid(*self._local_plan(batches, doc_sel),
                                         lam, alpha, gamma0s)
        gammas, sstats, token_score, theta_score, elog_sum = out
        sstats, token_score, theta_score, elog_sum = self._reduce_estep(
            sstats, token_score, theta_score, elog_sum)
        lam = (1.0 - rho) * lam + rho * (self._eta_own(eta)[None, :]
                                         + scale * sstats)
        return lam, scale * (token_score + theta_score), elog_sum, gammas

    def _local_plan(self, batches: List[_Bucket], doc_sel: torch.Tensor
                    ) -> Tuple[List[_Bucket], _SstatsPlan]:
        """A large-vocabulary minibatch at minibatch-local positions: its
        buckets with each row's position in ``doc_sel`` as row index, and
        the dense sstats plan of its gathered count rows."""
        plan = self._mb_sstats
        D, b_cap = plan.num_docs, plan.b_cap
        valid = doc_sel >= 0
        safe = torch.where(valid, doc_sel, D)
        pos = torch.arange(b_cap, device=doc_sel.device)
        # Global document -> position in doc_sel; absent documents and
        # padding -> b_cap, the assembly's dropped row.  Every padding
        # slot writes b_cap at index D, so the repeated indices all write
        # one value.
        inv = torch.full((D + 1,), b_cap, dtype=torch.int64,
                         device=doc_sel.device)
        inv.index_put_((safe,), torch.where(valid, pos, b_cap))
        buckets = [dataclasses.replace(b, row_index=inv[b.row_index])
                   for b in batches]
        chunks, s0 = [], 0
        for c in plan.chunk_sizes:
            # Padding positions read the zero row D and doc 0's expEtheta:
            # inert in sstats and the score.
            chunks.append((plan.counts.index_select(0, safe[s0:s0 + c]),
                           torch.where(valid[s0:s0 + c], pos[s0:s0 + c], 0)))
            s0 += c
        # Selected documents only and, as in batch VB, empty documents
        # outside the theta and E[log theta] sums.
        docs_mask = valid.to(self._dtype) * plan.nonempty[safe]
        return buckets, _SstatsPlan(chunks, docs_mask, b_cap,
                                    plan.vocab_range)

    # -- epochs of minibatches --------------------------------------------------

    def _epoch(self, epoch_seed: int, t: int) -> _Epoch:
        """The epoch gathered from the device-resident rows, or packed on
        the host when there are none or a minibatch overflows them."""
        if self._device_rows is not None:
            ep = self._epoch_index_stacks(epoch_seed, t)
            if ep is not None:
                return ep
        return self._epoch_batches(epoch_seed, t)

    def _rhos(self, t: int, n: int) -> List[float]:
        cfg = self._config
        return [(cfg.tau0 + t + i) ** (-cfg.kappa) for i in range(n)]

    def _epoch_plan(self, epoch_seed: int, t: int):
        """(each minibatch's documents of this rank's corpus, the rhos, the
        D/|B| scales) of the epoch: the one-process schedule (under a mesh
        each rank takes its contiguous slice of each minibatch's
        selection), or the per-host schedule of a process-local corpus."""
        if self._process_local:
            return self._process_local_plan(epoch_seed, t)
        D = self._corpus.num_docs
        index_lists = self._corpus.minibatch_indices(self._config.batch_size,
                                                     seed=epoch_seed)
        scales = [D / max(1, len(sel)) for sel in index_lists]
        if self._split:
            P, r = self._mesh.data, self._mesh.data_index
            index_lists = [sel[slice(*block_bounds(len(sel), r, P))]
                           for sel in index_lists]
        return index_lists, self._rhos(t, len(index_lists)), scales

    def _process_local_plan(self, epoch_seed: int, t: int):
        """The JAX engine's ``_process_local_epoch`` schedule: rank p's
        block of ceil(D / P) documents in the order of
        ``default_rng((epoch_seed, p)).permutation``, b_local documents of
        it a minibatch, ceil(block / b_local) minibatches; each scale is D
        over the global minibatch's documents, summed over every rank's
        block without communication."""
        P, my = self._mesh.data, self._mesh.data_index
        total = self._corpus.global_num_docs
        per = -(-total // P)
        b_local = self._mb_docs()
        n = -(-per // b_local)
        counts = [max(0, min(per, total - p * per)) for p in range(P)]
        perm = np.random.default_rng((epoch_seed, my)).permutation(counts[my])
        index_lists = [perm[i * b_local:(i + 1) * b_local] for i in range(n)]
        scales = [total / max(1, sum(min(b_local, max(0, c - i * b_local))
                                     for c in counts)) for i in range(n)]
        return index_lists, self._rhos(t, n), scales

    def _global_ids(self, doc_ids: np.ndarray) -> np.ndarray:
        """This rank's document indices (-1 pads) as global ones."""
        return np.where(doc_ids >= 0, doc_ids + self._doc_offset, -1)

    def _epoch_index_stacks(self, epoch_seed: int, t: int) -> Optional[_Epoch]:
        """Row indices of each minibatch into the device-resident rows
        (each width's capacity block cut into its chunks; the sentinel
        row fills the rest), assembled on the host from the CSR maps;
        None when a minibatch has more rows of a width than its
        capacity."""
        index_lists, rhos, scales = self._epoch_plan(epoch_seed, t)
        n = len(index_lists)
        stacks = [np.full((n, c), rows.sentinel, np.int64)
                  for rows in self._device_rows for c in rows.chunk_sizes]
        gids = [[] for _ in range(n)]
        for i, sel in enumerate(index_lists):
            j = 0
            for rows in self._device_rows:
                st = rows.csr_start
                ln = st[sel + 1] - st[sel]
                tot = int(ln.sum())
                if tot > rows.cap:
                    return None
                full = np.full((rows.cap,), rows.sentinel, np.int64)
                g = np.full((rows.cap,), -1, np.int32)
                if tot:
                    base = np.repeat(st[sel], ln)
                    offs = np.arange(tot) - np.repeat(np.cumsum(ln) - ln, ln)
                    r = rows.csr_rows[base + offs]
                    full[:tot] = r
                    g[:tot] = rows.doc_of_row[r]
                s0 = 0
                for c in rows.chunk_sizes:
                    stacks[j][i] = full[s0:s0 + c]
                    gids[i].append(g[s0:s0 + c])
                    s0 += c
                    j += 1
        docsels = self._doc_sel_arrays(index_lists)
        return _Epoch(self._gathered(stacks, docsels, gids), rhos, scales)

    def _gathered(self, stacks, docsels, gids):
        """Each minibatch's batches gathered on the device from the
        resident rows; the epoch's indices go up once."""
        dev = self._device
        D = self._corpus.num_docs
        idx = [torch.as_tensor(s, device=dev) for s in stacks]
        sels = None if docsels is None else torch.as_tensor(
            np.stack(docsels), device=dev)
        for i in range(len(gids)):
            batches, j = [], 0
            for rows in self._device_rows:
                for _c in rows.chunk_sizes:
                    r = idx[j][i]
                    row_doc = rows.row_doc.index_select(0, r)
                    if rows.counts is not None:
                        batches.append(_Dense(
                            counts=rows.counts.index_select(0, r),
                            mask=(row_doc < D).to(self._dtype),
                            doc_ids=gids[i][j],
                            max_nnz=rows.max_nnz,
                        ))
                    else:
                        batches.append(_Bucket(
                            ids=rows.ids.index_select(0, r),
                            cnts=rows.cnts.index_select(0, r),
                            row_index=row_doc,
                            mask=(row_doc < D).to(self._dtype),
                            doc_ids=gids[i][j],
                            segments=rows.segments,
                            seg_rows=rows.seg_rows,
                        ))
                    j += 1
            yield batches, (None if sels is None else (docsels[i], sels[i]))

    def _epoch_batches(self, epoch_seed: int, t: int) -> _Epoch:
        """The epoch's minibatches packed on the host (the fixed geometry
        where it holds, per-batch shapes where it overflows) and uploaded
        one at a time."""
        cfg = self._config
        corpus = self._corpus
        index_lists, rhos, scales = self._epoch_plan(epoch_seed, t)
        docsels = self._doc_sel_arrays(index_lists)

        def minibatches():
            for i, idx in enumerate(index_lists):
                if self._dense_layout(corpus):
                    bl = layouts.build_vb_batches(
                        corpus, cfg, doc_indices=idx,
                        pad_docs_to=self._mb_docs(),
                    )
                else:
                    bl = self._ragged_minibatch(corpus, cfg, idx)
                sel = None
                if docsels is not None:
                    sel = (docsels[i], torch.as_tensor(docsels[i],
                                                       device=self._device))
                yield self._to_device(bl, corpus.num_docs,
                                      segments=not self._chunk_ragged()), sel

        return _Epoch(minibatches(), rhos, scales)

    def _chunk_ragged(self) -> bool:
        """Whether ``estep_memory_budget_mb`` caps a ragged minibatch's
        launches (``layouts.chunks_ragged_rows``; the scatter route is
        the one without a dense sstats plan)."""
        return layouts.chunks_ragged_rows(self._device.type,
                                          self._mb_sstats is None)

    def _ragged_minibatch(self, corpus, cfg, idx):
        """The fixed geometry when one is planned; per-batch shapes when
        it has none or this minibatch overflows it."""
        chunk = self._chunk_ragged()
        if self._svi_geometry is not None:
            try:
                return layouts.build_vb_batches(
                    corpus, cfg, doc_indices=idx,
                    bucket_capacities=self._svi_geometry,
                    chunk_ragged=chunk,
                )
            except GeometryOverflow:
                pass
        return layouts.build_vb_batches(corpus, cfg, doc_indices=idx,
                                        chunk_ragged=chunk)

    def _run_epoch(self, lam, alpha, eta, ep: _Epoch, keep_gammas: bool,
                   tag: tuple):
        """The epoch's minibatch steps from lambda: (final lambda, the
        [n] bound estimates, the summed E[log theta], gammas and their
        row -> document maps when kept).  Minibatch i's gamma inits draw
        from the streams (config seed, *tag, i, batch)."""
        dev, dt = self._device, self._dtype
        rhos = torch.tensor(ep.rhos, dtype=dt, device=dev)
        scales = torch.tensor(ep.scales, dtype=dt, device=dev)
        ests, gammas, doc_ids = [], [], []
        elog_sum = torch.zeros_like(alpha)
        for i, (batches, sel) in enumerate(ep.minibatches):
            lam, est, elog, gs = self._minibatch_step(
                lam, alpha, eta, batches, rhos[i], scales[i],
                None if sel is None else sel[1], (*tag, i),
            )
            ests.append(est)
            elog_sum = elog_sum + elog
            if keep_gammas:
                gammas.extend(gs)
                doc_ids.extend(self._global_ids(ids) for ids in (
                    [sel[0]] if sel is not None
                    else [b.doc_ids for b in batches]))
        # The topic-side bound term once, at the epoch's final lambda.
        ests = torch.stack(ests) + self._beta_elbo(lam, eta)
        return lam, ests, elog_sum, gammas, doc_ids

    def _train_epoch(self, ep: _Epoch, keep_gammas: bool) -> torch.Tensor:
        """One epoch from ``self.state``, then the scheduled hyper
        updates; publishes the new state and returns the estimates."""
        cfg = self._config
        st = self.state
        lam, ests, elog_sum, gammas, doc_ids = self._run_epoch(
            st.lam, st.alpha, st.eta, ep, keep_gammas,
            (TAG_GAMMA_SVI, self._counter),
        )
        self._t += ep.n
        alpha, eta = st.alpha, st.eta
        if self._hyper_due():
            alpha = newton_dirichlet_mle(
                st.alpha, elog_sum, float(self._corpus.global_num_docs)
            )
            eta = newton_dirichlet_mle(
                st.eta, self._elog_lambda_sum(lam),
                float(cfg.number_of_topics)
            )
        self._state = LDAState(lam=lam, alpha=alpha, eta=eta,
                               step=st.step + 1)
        self._step_host += 1
        if keep_gammas:
            self._set_gammas(gammas, doc_ids)
        return ests

    # -- public training surface --------------------------------------------------

    def learning(self) -> float:
        """One epoch of minibatch updates; returns the mean of the
        minibatches' bound estimates (a stochastic estimate, not the
        batch ELBO)."""
        seed = self._counter * 100003 + self._config.seed
        ests = self._train_epoch(self._epoch(seed, self._t), keep_gammas=True)
        return float(ests.double().mean())

    def learning_many(self, n: int) -> List[float]:
        """n epochs in a loop that stays on the device; the estimates are
        read back once.  Every epoch's indices are assembled first: if a
        minibatch of any of them overflows the device-resident geometry,
        this runs n ``learning()`` calls instead (as the JAX engine does).
        Gammas are recomputed lazily by the ``gamma`` property."""
        if n <= 0:
            return []
        if self._device_rows is None:
            return [self.learning() for _ in range(n)]
        cfg = self._config
        epochs, t = [], self._t
        for e in range(n):
            ep = self._epoch_index_stacks(
                (self._counter + e) * 100003 + cfg.seed, t)
            if ep is None:
                return [self.learning() for _ in range(n)]
            epochs.append(ep)
            t += ep.n
        ests = torch.stack([self._train_epoch(ep, keep_gammas=False)
                            for ep in epochs])
        self._set_gammas(None, None)
        return [float(x) for x in ests.double().mean(dim=1).cpu()]

    # -- lazy gamma ----------------------------------------------------------------

    @property
    def gamma(self) -> Optional[np.ndarray]:
        """Per-document gamma [D, K] in corpus order: the last
        ``learning()``'s minibatch gammas, or, after ``learning_many`` or
        a new state, one rho = 0 epoch at the current state (lambda
        unchanged, every document visited once)."""
        if (self._gamma_np is None and self._gammas_dev is None
                and self._corpus is not None):
            self._recompute_gammas()
        return VariationalBayes.gamma.fget(self)

    def _recompute_gammas(self) -> None:
        cfg = self._config
        st = self.state
        ep = None
        if self._device_rows is not None:
            # The JAX engine's seeds: a partition that fits the geometry
            # (overflow is seed-dependent and rare).
            for trial in range(8):
                ep = self._epoch_index_stacks(
                    (self._counter + 7 * trial) * 100003 + cfg.seed + trial,
                    self._t)
                if ep is not None:
                    break
        if ep is None:
            ep = self._epoch_batches(self._counter * 100003 + cfg.seed,
                                     self._t)
        ep = dataclasses.replace(ep, rhos=[0.0] * ep.n)
        _, _, _, gammas, doc_ids = self._run_epoch(
            st.lam, st.alpha, st.eta, ep, keep_gammas=True,
            tag=(TAG_GAMMA_REFRESH, self._counter))
        self._set_gammas(gammas, doc_ids)

    def timing_minibatch(self):
        """(the first minibatch of the epoch the next ``learning()`` runs:
        its device batches and selection, its rho and D/|B| scale, the
        epoch's minibatch count).  ``_t`` does not move: the epoch takes
        the counter as an argument, and only ``_train_epoch`` advances
        it."""
        ep = self._epoch(self._counter * 100003 + self._config.seed, self._t)
        batches, sel = next(iter(ep.minibatches))
        return batches, sel, ep.rhos[0], ep.scales[0], ep.n

    def phase_timings(self, repeats: int = 3) -> dict:
        """One minibatch step's device time in ms (``svi_minibatch_ms``:
        the local E-step, the natural-gradient lambda step and the bound
        terms, best of ``repeats`` after a warm call; ``utils.timing``)
        and ``minibatches_per_epoch``, the keys of
        ``pylda_tpu.models.svi``, and under a mesh with a process group
        ``allreduce_ms`` (one minibatch's sufficient statistics; every rank
        must call this).  The step runs from the current state
        and its results are dropped: lambda, alpha, eta, the step and
        ``_t`` (the rho schedule) stay as they were, and the gamma inits
        draw from a stream of their own (``TAG_TIMING``).
        ``last_sweeps`` holds the timed minibatch's sweeps a batch."""
        st = self.state
        batches, sel, rho, scale, n = self.timing_minibatch()
        dev, dt = self._device, self._dtype
        rho_t = torch.tensor(rho, dtype=dt, device=dev)
        scale_t = torch.tensor(scale, dtype=dt, device=dev)
        ms, _ = best_ms(lambda: self._minibatch_step(
            st.lam, st.alpha, st.eta, batches, rho_t, scale_t,
            None if sel is None else sel[1], (TAG_TIMING, self._counter, 0),
        ), dev, repeats)
        return {"svi_minibatch_ms": round(ms, 6), "minibatches_per_epoch": n,
                **self._allreduce_timing(st.lam, repeats)}

    # -- model files ------------------------------------------------------------------

    def _extra_state(self) -> dict:
        return {"t": np.asarray(self._t, dtype=np.int64)}

    def _load_extra_state(self, blobs: dict) -> None:
        if "t" in blobs:
            self._t = int(blobs["t"])
