"""Batch mean-field variational Bayes engine.

Counterpart of ``pylda_tpu.models.vb.VariationalBayes`` on each of its
routes:

- the dense route (V <= ``dense_vocab_threshold``): per dense doc-term
  batch, the whole E-step — gamma fixed point, then sufficient statistics
  and token score at the converged gamma — in ``ops/dense_estep``
  (``dense_estep``, CUDA kernels on the card);
- the large-vocab route with dense sufficient statistics (the default
  while the corpus's dense counts fit ``sstats_dense_total_budget_mb``):
  per length bucket the gamma fixed point (``ops/ragged.ragged_gamma``, a
  CUDA kernel on the card), per-document gamma assembly, then sufficient
  statistics and token score against corpus-static dense count chunks
  (``ops/sstats.dense_sstats``, a CUDA kernel on the card);
- the large-vocab scatter route (``sstats_mode="scatter"``, a corpus over
  the budget, or a disk-backed corpus): per bucket the whole E-step in
  ``ops/estep.estep_ragged`` — the same gamma kernel, then the row
  scatter in plain PyTorch — and the bound terms per bucket row;

then lambda = eta + sstats, the ELBO and, on schedule, the Newton
alpha/eta updates.  Every K runs on the card (above 4096 the gamma
kernels' and the sstats kernel's cluster kernels).
``estep_memory_budget_mb`` caps a batch's rows where [rows, T, K] arrays
are made: on the CPU (as the JAX engine's batches) and on the scatter
route; on the card the route with dense sufficient statistics takes each
bucket in one gamma launch (``models/layouts.chunks_ragged_rows``) whose
segments are those chunks (``layouts.ragged_chunks``), each ending at its
own exit sweep as the JAX engine's batch does; ``last_sweeps`` then holds
one count a segment.
``compute_dtype="bfloat16"`` runs every kernel (or,
on the CPU, every plain version) in the JAX engine's bf16 operand mode.
``export_beta``, ``save``/``load`` and the CLIs (``pylda_tpu_torch.cli``)
sit on top (``models/base.py``).

PyTorch runs eagerly, so there is no jit or scan here: ``learning_many``
is a Python loop whose kernels queue on the device stream; it reads the
ELBOs back once at the end (the Newton updates read one scalar per Newton
step).

Each row's fixed point starts from ``gamma_init``: ones, or a random
draw ("normal", "gamma") from a ``torch.Generator`` on the engine's
device seeded by (config seed, purpose tag, step, batch) through
``ops/sampling.stream``, on the JAX engine's schedule: ``learning()``
draws a set an iteration, ``learning_many(n)`` one set for all n, and
held-out inference, the lazy ``gamma`` refresh and ``phase_timings``
draw from tags of their own.  ``phase_timings`` times each phase of an
iteration on the device.

Under a mesh (``initialize(..., mesh=...)``, ``parallel/mesh.py``) each
rank runs the E-step over its block of documents (``_local_corpus``) in
the geometry of the JAX engine's process-local builds (one dense batch of
the ranks' uniform row count, or configured-width ragged buckets padded
to the ranks' largest row counts, ``_build_local_batches``), and each
iteration sums the sufficient statistics in one all-reduce and the
doc-level scalars in another (``_reduce_estep``), so lambda, alpha, eta
and the ELBO are the same bits on every rank.  Held-out inference runs
replicated: every rank holds the whole test corpus, runs its E-step alone
and gets the same answer.  ``gamma`` gathers each rank's documents.

With a model axis above 1 (mesh (D, M)) the ranks of a model group hold
the same documents and the reductions above run over the data group.
Under ``shard_vocab`` / ``shard_topics`` each rank holds its block of
lambda (``parallel/lam_shard.py``): an E-step gathers the whole
expElogbeta over the model group once, runs the same fixed points on
every rank of the group, and computes the sufficient statistics of the
rank's block only (the dense sstats kernel's topic range, the count
chunks' own columns, the scatter's own words or topics), so the M-step
is local.  The token score is a partial sum under ``shard_vocab`` (its
columns' counts) and is summed over the model group too; the bound's
topic side and the Newton eta input are summed over it (``LamShard``).
Held-out inference runs on the gathered expElogbeta with the whole
column range, so every rank gets the one-process numbers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from pylda_tpu_torch.corpus.corpus import Corpus, DenseBatch
from pylda_tpu_torch.models import layouts
from pylda_tpu_torch.models.base import Inferencer, LDAState
from pylda_tpu_torch.ops.dense_estep import dense_estep
from pylda_tpu_torch.ops.dirichlet import (
    beta_elbo,
    dirichlet_expectation,
    exp_dirichlet_expectation,
    exp_dirichlet_expectation_fast,
    theta_elbo,
)
from pylda_tpu_torch.ops.estep import estep_ragged
from pylda_tpu_torch.ops.hyper import newton_dirichlet_mle
from pylda_tpu_torch.ops.ragged import gather_table, ragged_gamma
from pylda_tpu_torch.ops.row_fixed_point import segment_rows
from pylda_tpu_torch.ops.sampling import stream
from pylda_tpu_torch.ops.sstats import dense_sstats
from pylda_tpu_torch.parallel.lam_shard import VOCAB
from pylda_tpu_torch.parallel.mesh import (
    all_reduce_sum,
    lift_process_local_batch,
    lift_process_local_buckets,
)
from pylda_tpu_torch.utils import round_up as _round_up
from pylda_tpu_torch.utils.config import LDAConfig
from pylda_tpu_torch.utils.timing import best_ms


@dataclasses.dataclass
class _Bucket:
    """One ragged bucket on the device."""

    ids: torch.Tensor  # [D_b, T_b] int32
    cnts: torch.Tensor  # [D_b, T_b] f32
    # [D_b] int64: the row's document as a position in the sstats plan's
    # documents (the corpus, or an SVI minibatch's selection), and the
    # plan's num_docs for padding rows.
    row_index: torch.Tensor
    mask: torch.Tensor  # [D_b] f32: 1 for rows of a document
    doc_ids: np.ndarray  # [D_b] int32, -1 for padding rows
    # Rows of each batch the JAX engine's layout makes of this bucket (the
    # gamma launch's segments), where a launch takes it whole; None: one.
    segments: Optional[Tuple[int, ...]] = None
    # [D_b] int32 on the device: each row's segment
    # (row_fixed_point.segment_rows), built once; None without segments.
    seg_rows: Optional[torch.Tensor] = None

    @property
    def rows(self) -> int:
        return self.ids.shape[0]


@dataclasses.dataclass
class _Dense:
    """One dense doc-term batch on the device."""

    counts: torch.Tensor  # [D_b, V] bf16 (counts <= 256) or f32
    mask: torch.Tensor  # [D_b] f32: 1 for real documents
    doc_ids: np.ndarray  # [D_b] int32, -1 for padding rows
    # The largest nonzero count of a row, counted on the host when the
    # batch is built: it sizes the gamma launch (dense_estep's max_nnz).
    max_nnz: Optional[int] = None

    @property
    def rows(self) -> int:
        return self.counts.shape[0]


_Batch = Union[_Bucket, _Dense]


@dataclasses.dataclass
class _SstatsPlan:
    """Dense counts for the sufficient statistics: corpus-static for
    batch VB, gathered for one minibatch by SVI (then ``num_docs`` is the
    minibatch's padded selection length)."""

    chunks: List[Tuple[torch.Tensor, torch.Tensor]]  # (counts, doc index)
    docs_mask: torch.Tensor  # [num_docs] f32: 1 for non-empty docs
    num_docs: int
    # The vocabulary columns [v0, v1) the counts hold (this rank's under
    # ``shard_vocab``), padded; None: all of them.
    vocab_range: Optional[Tuple[int, int]] = None


# Purpose tags of the gamma-init streams: the JAX engine's fold_in
# constants where it has one (a fused dispatch, held-out inference, the
# lazy refresh, phase timing); learning() and SVI's minibatches split the
# JAX state key instead, and take tags of their own here.
TAG_GAMMA_ITER, TAG_GAMMA_FUSED, TAG_GAMMA_SVI = 0x17E4, 0x60A4, 0x5B1
TAG_GAMMA_TEST, TAG_GAMMA_REFRESH, TAG_TIMING = 0x7E57, 0x6A33A, 0x7131

# Gamma(GAMMA_SHAPE) * GAMMA_SCALE: mean 1, std 0.1.
GAMMA_SHAPE, GAMMA_SCALE = 100.0, 0.01


def standard_gamma(shape_param: float, size, generator: torch.Generator,
                   dtype=torch.float32) -> torch.Tensor:
    """Gamma(``shape_param``, 1) draws of ``size`` on the generator's
    device, by Marsaglia and Tsang (2000) for a shape >= 1: one normal x
    and one uniform u a candidate, v = (1 + c x)^3, accepted when
    log u < x^2/2 + d - d v + d log v, the draw d v.  Rejected entries
    are drawn again until none is left (at shape 100 over 99% of
    candidates are accepted).  ``torch.distributions.Gamma`` takes no
    generator, so it cannot give repeatable streams."""
    if shape_param < 1.0:
        raise ValueError("standard_gamma needs a shape >= 1")
    d = shape_param - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    dev = generator.device
    n = math.prod(size)
    out = torch.empty((n,), dtype=dtype, device=dev)
    todo = torch.arange(n, device=dev)
    while todo.numel():
        m = todo.numel()
        x = torch.randn((m,), generator=generator, dtype=dtype, device=dev)
        u = torch.rand((m,), generator=generator, dtype=dtype, device=dev)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(1e-30)))
        out[todo[ok]] = d * v[ok]
        todo = todo[~ok]
    return out.reshape(size)


def gamma_init(shape, mode: str, generator: Optional[torch.Generator],
               dtype=torch.float32, device=None) -> torch.Tensor:
    """A fixed point's per-row cold start (``pylda_tpu.models.vb``'s
    ``_gamma_init``): ones; "normal", clip(1 + 0.1 N(0, 1), 0.2); or
    "gamma", Gamma(100) * 0.01.  The random modes draw from
    ``generator``, on its device."""
    if mode == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if mode == "normal":
        x = torch.randn(shape, generator=generator, dtype=dtype,
                        device=generator.device)
        return (1.0 + 0.1 * x).clamp_(min=0.2)
    if mode == "gamma":
        return standard_gamma(GAMMA_SHAPE, shape, generator, dtype) * GAMMA_SCALE
    raise ValueError(f"unknown gamma_init: {mode}")


def _elog_lambda_sum(lam: torch.Tensor) -> torch.Tensor:
    return dirichlet_expectation(lam).sum(dim=0)


def _assemble_gamma_device(rows, row_index, alpha, num_docs: int):
    """Recombine per-row gammas (bucket rows; chunked long docs share a
    doc id) into per-DOCUMENT gamma [num_docs, K]: gamma_doc = alpha +
    sum_rows (gamma_row - alpha), exact at fixed phi.  Padding rows carry
    index num_docs, an overflow row that is dropped."""
    delta = torch.zeros(
        (num_docs + 1, alpha.shape[0]), dtype=rows.dtype, device=rows.device
    )
    delta.index_add_(0, row_index, rows - alpha[None, :])
    return alpha[None, :] + delta[:num_docs]


def _compact_counts(counts: np.ndarray, device, dtype) -> torch.Tensor:
    """Counts on the device, bf16 when every count is <= 256 (bf16 is
    exact for those integers, and the kernels and plain versions upcast)."""
    store = torch.bfloat16 if counts.max(initial=0.0) <= 256.0 else dtype
    return torch.as_tensor(counts, device=device).to(store)


class VariationalBayes(Inferencer):
    """Batch VB over the full corpus each iteration."""

    # The E-step starts each row's fixed point from ``gamma_init``.
    _USES_GAMMA_INIT = True
    # Under ``shard_vocab`` the E-step's token score covers this rank's
    # columns only (its block of expElogbeta scores its counts).
    _PARTIAL_TOKEN_SCORE = True

    def __init__(
        self,
        config: LDAConfig,
        device: Union[str, torch.device, None] = None,
    ):
        super().__init__(config, device)
        if self._device.type == "cuda" and self._dtype != torch.float32:
            raise NotImplementedError("the CUDA kernels take float32 only")
        self.last_sweeps: List[torch.Tensor] = []
        self._batches: Optional[List[_Batch]] = None
        self._sstats_plan: Optional[_SstatsPlan] = None
        self._doc_offset = 0  # the rank's first global document
        self._set_gammas(None, None)

    # -- corpus preparation ---------------------------------------------------

    def _dense_layout(self, corpus: Corpus) -> bool:
        return corpus.num_types <= self._config.dense_vocab_threshold

    def _build_batches(self, corpus: Corpus) -> List[_Batch]:
        chunk = layouts.chunks_ragged_rows(self._device.type,
                                           self._scatter_route(corpus))
        return self._to_device(
            layouts.build_vb_batches(corpus, self._config, chunk_ragged=chunk),
            corpus.num_docs, segments=not chunk)

    def _build_local_batches(self, corpus: Corpus) -> List[_Batch]:
        """A rank's document block under a mesh, in a geometry uniform
        across ranks (the JAX engine's process-local builds): the dense
        layout as one batch of ceil(D / P) rows rounded up to
        ``doc_pad_multiple``; the ragged layout as buckets of the
        configured ``bucket_sizes`` padded to the ranks' largest row
        counts.  Doc ids are global.  Collective."""
        cfg, mesh = self._config, self._mesh
        off = corpus.global_doc_offset
        if self._dense_layout(corpus):
            rows = _round_up(-(-corpus.global_num_docs // mesh.data),
                             cfg.doc_pad_multiple)
            batches = [lift_process_local_batch(
                corpus.to_dense(pad_docs_to=rows), mesh, off)]
        else:
            batches = lift_process_local_buckets(
                corpus.to_ragged_buckets(
                    bucket_sizes=tuple(cfg.bucket_sizes), doc_pad_multiple=1),
                cfg.bucket_sizes, cfg.doc_pad_multiple, mesh, off)
        return self._to_device(batches, corpus.num_docs, off)

    def _to_device(self, batches: List[layouts.VBBatch],
                   num_docs: int, offset: int = 0,
                   segments: bool = False) -> List[_Batch]:
        """Layout batches on this engine's device; a ragged row's index is
        its global doc id less ``offset`` (the documents' first), and
        ``num_docs`` for padding rows.  ``segments``: the ragged buckets
        are whole, and each gets the chunks ``estep_memory_budget_mb``
        cuts it into as its segments."""
        dev = self._device
        cfg = self._config
        out: List[_Batch] = []
        for b in batches:
            if isinstance(b, DenseBatch):
                out.append(_Dense(
                    counts=_compact_counts(b.counts, dev, self._dtype),
                    mask=torch.as_tensor(b.mask, device=dev).to(self._dtype),
                    doc_ids=b.doc_ids,
                    max_nnz=int((b.counts != 0).sum(axis=1).max(initial=0)),
                ))
                continue
            row_index = np.where(b.doc_ids >= 0, b.doc_ids - offset, num_docs)
            segs = (layouts.ragged_chunks(
                b.ids.shape[0], b.ids.shape[1], cfg.number_of_topics,
                cfg.doc_pad_multiple, cfg.estep_memory_budget_mb)
                if segments else [])
            out.append(_Bucket(
                ids=torch.as_tensor(b.ids, device=dev),
                cnts=torch.as_tensor(b.cnts, device=dev).to(self._dtype),
                row_index=torch.as_tensor(row_index, dtype=torch.int64,
                                          device=dev),
                mask=torch.as_tensor(b.mask, device=dev).to(self._dtype),
                doc_ids=b.doc_ids,
                segments=tuple(segs) if len(segs) > 1 else None,
                seg_rows=(segment_rows(segs, dev) if len(segs) > 1
                          else None),
            ))
        return out

    def _own_columns(self, own: bool) -> Optional[Tuple[int, int]]:
        """The vocabulary columns this rank's sufficient statistics cover
        under ``shard_vocab`` (for ``own``); None: all."""
        if own and self._shard is not None:
            return self._shard.vocab_range
        return None

    def _scatter_route(self, corpus: Corpus) -> bool:
        """Whether a ragged layout's sufficient statistics come from the
        row scatter: ``sstats_mode="scatter"``, a corpus whose [D, V]
        float32 counts exceed ``sstats_dense_total_budget_mb``, or one
        without documents in RAM (disk-backed)."""
        cfg = self._config
        return (cfg.sstats_mode == "scatter"
                or getattr(corpus, "docs", None) is None
                or (corpus.num_docs * corpus.num_types * 4 / 1e6
                    > cfg.sstats_dense_total_budget_mb))

    def _plan_dense_sstats(self, corpus: Corpus, own: bool = True
                           ) -> Optional[_SstatsPlan]:
        """Corpus-static dense counts chunks of the large-vocab route
        (docs chunked to ``sstats_dense_budget_mb``), vocab-prepadded once
        to a multiple of 1024; under ``shard_vocab`` (and ``own``) only
        this rank's columns, padded so.  The route is chosen on the whole
        vocabulary, as in one process.  None — each bucket's E-step computes its
        own sstats — where the JAX engine's plan is None: on the dense
        route, for ``sstats_mode="scatter"``, for a corpus whose [D, V]
        float32 counts exceed ``sstats_dense_total_budget_mb``, and for a
        corpus without documents in RAM (disk-backed)."""
        cfg = self._config
        if self._dense_layout(corpus) or self._scatter_route(corpus):
            return None
        dev = self._device
        pad = cfg.doc_pad_multiple
        rows_budget = int(cfg.sstats_dense_budget_mb * 1e6
                          // (4 * corpus.num_types))
        rows_budget = max(pad, (rows_budget // pad) * pad)
        num_docs = corpus.num_docs
        cols = self._own_columns(own)
        v0, v1 = cols or (0, corpus.num_types)
        v_pad = _round_up(v1 - v0, 1024)
        chunks = []
        for start in range(0, num_docs, rows_budget):
            stop = min(num_docs, start + rows_budget)
            ch = corpus.to_dense(
                doc_indices=range(start, stop),
                pad_docs_to=_round_up(stop - start, pad),
            )
            counts = ch.counts[:, v0:v1]
            if v_pad > counts.shape[1]:
                counts = np.pad(counts, ((0, 0), (0, v_pad - counts.shape[1])))
            # Padding rows gather doc 0's expEtheta but carry all-zero
            # counts — inert in both sstats and the token score.
            cidx = np.where(ch.doc_ids >= 0, ch.doc_ids, 0)
            chunks.append((
                _compact_counts(counts, dev, self._dtype),
                torch.as_tensor(cidx, dtype=torch.int64, device=dev),
            ))
        docs_mask = np.asarray([d.size > 0 for d in corpus.docs], np.float32)
        return _SstatsPlan(
            chunks=chunks,
            docs_mask=torch.as_tensor(docs_mask, device=dev).to(self._dtype),
            num_docs=num_docs,
            vocab_range=cols,
        )

    def _prepare(self, corpus: Corpus) -> None:
        local = self._local_corpus(corpus)
        self._doc_offset = local.global_doc_offset if self._split else 0
        self._batches = (self._build_local_batches(local) if self._split
                         else self._build_batches(local))
        self._sstats_plan = self._plan_dense_sstats(local)
        self._set_gammas(None, None)

    def _state_changed(self) -> None:
        self._set_gammas(None, None)

    def _gamma0s(self, batches: List[_Batch], *tag: int
                 ) -> List[torch.Tensor]:
        """One gamma init a batch; a random mode draws batch i's from the
        stream (config seed, *tag, i), ``tag`` being (purpose, step, ...)."""
        cfg = self._config
        K = cfg.number_of_topics
        mode = cfg.gamma_init if self._USES_GAMMA_INIT else "ones"
        return [
            gamma_init((b.rows, K), mode,
                       None if mode == "ones"
                       else stream(self._device, cfg.seed, *tag, i),
                       self._dtype, self._device)
            for i, b in enumerate(batches)
        ]

    # -- E-step ---------------------------------------------------------------

    def _fixed_point_kw(self) -> dict:
        cfg = self._config
        return dict(
            inner_iterations=cfg.inner_iterations,
            convergence_threshold=cfg.convergence_threshold,
            eps=cfg.eps,
            stall_patience=cfg.estep_stall_patience,
            compute_dtype=cfg.compute_dtype,
        )

    # -- lambda blocks ---------------------------------------------------------

    def _expectations(self, lam) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the whole expElogbeta [K, V], this rank's block of it): the
        block all-gathered over the model group under a lambda shard
        (collective), else the one tensor twice."""
        if self._shard is None:
            eeb = exp_dirichlet_expectation_fast(lam)
            return eeb, eeb
        own = self._shard.exp_elog_beta(lam)
        return self._shard.gather(own), own

    def _eta_own(self, eta) -> torch.Tensor:
        """eta's entries of this rank's lambda columns."""
        return eta if self._shard is None else self._shard.eta_cols(eta)

    def _beta_elbo(self, lam, eta) -> torch.Tensor:
        """The topic side of the bound of the whole lambda."""
        if self._shard is None:
            return beta_elbo(lam, eta)
        return self._shard.beta_elbo(lam, eta)

    def _elog_lambda_sum(self, lam) -> torch.Tensor:
        """[V] E[log beta] summed over topics: the Newton eta input."""
        if self._shard is None:
            return _elog_lambda_sum(lam)
        return self._shard.elog_lambda_sum(lam)

    def _run_estep_batches(self, batches: List[_Batch], lam, alpha,
                           gamma0s, sharded: bool = True):
        """The whole E-step batch by batch (the JAX engine's
        ``_vb_dense_batch`` and ``_vb_ragged_batch``): a dense batch's in
        ``dense_estep``, a ragged bucket's in ``estep_ragged`` (the gamma
        kernel, then the row scatter).  The bound terms sum each batch's
        rows under its row mask, so a document chunked over several rows
        adds one theta term a row, as in the JAX engine.  Returns (gammas,
        sstats, token_score, theta_score, elog_sum), one gamma per batch;
        the sweeps each batch took stay on the device in
        ``last_sweeps``.  Under a lambda shard the sufficient statistics
        are this rank's block (``sharded``) or the whole [K, V]."""
        eeb, _ = self._expectations(lam)
        kw = dict(self._fixed_point_kw(), **self._block_ranges(sharded))
        # The gamma kernel gathers rows of expElogbeta^T, and so does the
        # scatter: one table for all buckets of this E-step.
        eeb_t = (gather_table(eeb, self._config.compute_dtype)
                 if any(isinstance(b, _Bucket) for b in batches) else None)
        sstats = None
        token_score = torch.zeros((), dtype=lam.dtype, device=lam.device)
        theta_score = torch.zeros((), dtype=lam.dtype, device=lam.device)
        elog_sum = torch.zeros(alpha.shape, dtype=lam.dtype, device=lam.device)
        gammas, sweeps = [], []
        for b, gamma0 in zip(batches, gamma0s):
            if isinstance(b, _Dense):
                g, ss, tok, s = dense_estep(b.counts, gamma0, eeb, alpha,
                                            max_nnz=b.max_nnz, **kw)
            else:
                g, ss, tok, s = estep_ragged(b.ids, b.cnts, gamma0, eeb, alpha,
                                             eeb_t=eeb_t, segments=b.segments,
                                             seg_rows=b.seg_rows, **kw)
            sstats = ss if sstats is None else sstats + ss
            token_score = token_score + tok
            theta_score = theta_score + theta_elbo(g, alpha, b.mask)
            elog_sum = elog_sum + (
                dirichlet_expectation(g) * b.mask[:, None]
            ).sum(dim=0)
            gammas.append(g)
            sweeps.extend(s.reshape(-1).unbind())
        self.last_sweeps = sweeps
        return gammas, sstats, token_score, theta_score, elog_sum

    def _ragged_fixed_points(self, batches: List[_Bucket], lam, alpha,
                             gamma0s: List[torch.Tensor]):
        """(the whole expElogbeta, this rank's block of it, each bucket's
        gamma rows, the sweeps of each bucket's segments in order): the
        gamma fixed points alone."""
        eeb, eeb_own = self._expectations(lam)
        # The kernel gathers rows of expElogbeta^T: build the table once
        # for all buckets of this E-step (bf16 in the bf16 operand mode).
        eeb_t = (gather_table(eeb, self._config.compute_dtype) if eeb.is_cuda
                 else None)
        kw = self._fixed_point_kw()
        rows, sweeps = [], []
        for b, gamma0 in zip(batches, gamma0s):
            g, s = ragged_gamma(b.ids, b.cnts, gamma0, eeb, alpha,
                                eeb_t=eeb_t, segments=b.segments,
                                seg_rows=b.seg_rows, **kw)
            rows.append(g)
            sweeps.extend(s.reshape(-1).unbind())
        return eeb, eeb_own, rows, sweeps

    def _run_estep_hybrid(
        self, batches: List[_Bucket], plan: _SstatsPlan, lam, alpha,
        gamma0s: List[torch.Tensor], sharded: bool = True,
    ):
        """Ragged sweeps + scatter-free dense sufficient statistics.
        Returns ([gamma_docs], sstats, token_score, theta_score,
        elog_sum); the sweeps each bucket (each segment) took stay on
        the device in ``last_sweeps``.  The sufficient statistics cover
        the plan's columns and, under ``shard_topics`` (``sharded``), this
        rank's topics."""
        cfg = self._config
        eeb, eeb_own, rows, sweeps = self._ragged_fixed_points(
            batches, lam, alpha, gamma0s)
        if plan.vocab_range is not None:
            eeb = eeb_own
        topic_range = self._block_ranges(sharded).get("topic_range")
        self.last_sweeps = sweeps
        gamma_docs = _assemble_gamma_device(
            torch.cat(rows, dim=0),
            torch.cat([b.row_index for b in batches], dim=0),
            alpha, plan.num_docs,
        )
        et_docs = exp_dirichlet_expectation(gamma_docs)
        sstats = None
        token_score = torch.zeros((), dtype=lam.dtype, device=lam.device)
        for counts, cidx in plan.chunks:
            ss, tok = dense_sstats(counts, et_docs[cidx], eeb, eps=cfg.eps,
                                   compute_dtype=cfg.compute_dtype,
                                   topic_range=topic_range)
            sstats = ss if sstats is None else sstats + ss
            token_score = token_score + tok
        theta_score = theta_elbo(gamma_docs, alpha, plan.docs_mask)
        elog_sum = (
            dirichlet_expectation(gamma_docs) * plan.docs_mask[:, None]
        ).sum(dim=0)
        return [gamma_docs], sstats, token_score, theta_score, elog_sum

    def _run_estep(self, batches, plan, lam, alpha, gamma0s,
                   sharded: bool = True):
        """The E-step of ``batches``: (gammas, sstats, token_score,
        theta_score, elog_sum); ``sharded`` as for
        ``_run_estep_batches``."""
        if plan is None:
            return self._run_estep_batches(batches, lam, alpha, gamma0s,
                                           sharded)
        return self._run_estep_hybrid(batches, plan, lam, alpha, gamma0s,
                                      sharded)

    @staticmethod
    def _gamma_doc_ids_for(batches, plan, offset: int = 0
                           ) -> List[np.ndarray]:
        """Row->document maps matching the gammas ``_run_estep`` returns:
        one per batch, or one per-document block (from document
        ``offset``) with a dense sstats plan."""
        if plan is not None:
            return [np.arange(offset, offset + plan.num_docs, dtype=np.int32)]
        return [b.doc_ids for b in batches]

    def _reduce_estep(self, sstats, token_score, theta_score, elog_sum):
        """A rank's E-step summed over the mesh's data group (its other
        data coordinates' documents): the sufficient statistics in one
        all-reduce, the token score, theta terms and E[log theta] sums
        packed into another.  Under ``shard_vocab`` the token score, a
        partial sum over this rank's columns (``_PARTIAL_TOKEN_SCORE``),
        is first summed over the model group (so over every rank); the
        doc-level terms, the same on every rank of a model group, are not.
        As they are without a process group."""
        mesh = self._mesh
        if mesh is None or not mesh.grouped:
            return sstats, token_score, theta_score, elog_sum
        sstats = all_reduce_sum(sstats.contiguous(), mesh, "data")
        if (self._shard is not None and self._shard.mode == VOCAB
                and self._PARTIAL_TOKEN_SCORE):
            token_score = all_reduce_sum(token_score.reshape(1).clone(),
                                         mesh, "model")[0]
        packed = all_reduce_sum(torch.cat([
            token_score.reshape(1), theta_score.reshape(1), elog_sum]), mesh,
            "data")
        return sstats, packed[0], packed[1], packed[2:]

    # -- one full VB iteration ------------------------------------------------

    def _iteration(self, update_hypers: bool, gamma0s):
        """One batch-VB iteration from ``self.state``; returns
        (new_state, elbo 0-d tensor, gammas)."""
        cfg = self._config
        st = self.state
        gammas, sstats, token_score, theta_score, elog_sum = (
            self._train_estep(gamma0s)
        )
        sstats, token_score, theta_score, elog_sum = self._reduce_estep(
            sstats, token_score, theta_score, elog_sum)
        elbo = token_score + theta_score + self._beta_elbo(st.lam, st.eta)
        lam_new = self._eta_own(st.eta)[None, :] + sstats
        alpha_new, eta_new = st.alpha, st.eta
        if update_hypers:
            alpha_new = newton_dirichlet_mle(
                st.alpha, elog_sum, float(self._corpus.global_num_docs)
            )
            eta_new = newton_dirichlet_mle(
                st.eta, self._elog_lambda_sum(lam_new),
                float(cfg.number_of_topics)
            )
        new_state = LDAState(
            lam=lam_new, alpha=alpha_new, eta=eta_new, step=st.step + 1
        )
        return new_state, elbo, gammas

    def _train_estep(self, gamma0s):
        """The training corpus's E-step at the current state."""
        st = self.state
        return self._run_estep(self._batches, self._sstats_plan, st.lam,
                               st.alpha, gamma0s)

    def _hyper_due(self) -> bool:
        interval = self._config.hyper_parameter_optimize_interval
        return interval > 0 and (self._counter + 1) % interval == 0

    # -- public training surface ------------------------------------------------

    def learning(self) -> float:
        """One batch-VB iteration: E-step, bound, M-step, hyper updates.
        Returns the ELBO at (gamma*, lambda used in the E-step)."""
        new_state, elbo, gammas = self._iteration(
            self._hyper_due(),
            self._gamma0s(self._batches, TAG_GAMMA_ITER, self._counter),
        )
        self._state = new_state
        self._step_host += 1
        self._set_gammas(gammas, self._gamma_doc_ids_for(
            self._batches, self._sstats_plan, self._doc_offset))
        return float(elbo)

    def learning_many(self, n: int) -> List[float]:
        """n iterations in a loop that stays on the device; the gamma
        inits are drawn once for all n (as the JAX scan does: the init is
        an arbitrary cold start whose distribution, not its freshness,
        matters).  Returns the per-iteration ELBOs."""
        if n <= 0:
            return []
        gamma0s = self._gamma0s(self._batches, TAG_GAMMA_FUSED, self._counter)
        elbos = []
        for _ in range(n):
            new_state, elbo, _ = self._iteration(self._hyper_due(), gamma0s)
            self._state = new_state
            self._step_host += 1
            elbos.append(elbo)
        self._set_gammas(None, None)  # lazy: .gamma re-runs the E-step
        return [float(x) for x in torch.stack(elbos).cpu()]

    # -- per-phase timing ----------------------------------------------------------

    def phase_timings(self, repeats: int = 3) -> dict:
        """Per-phase device times in ms of one training iteration at the
        current state (``pylda_tpu.models.vb``'s keys): on the dense
        sstats plan ``estep_hybrid_full_ms`` (the whole E-step) and
        ``estep_sweeps_only_ms`` (expectations and the gamma fixed points
        alone), otherwise ``estep_batch{i}_{shape}_ms`` a batch; then
        ``estep_total_ms``, ``mstep_ms``, ``bound_ms`` and
        ``hyper_newton_ms``; under a mesh with a process group also
        ``allreduce_ms`` (the sufficient statistics' all-reduce,
        ``allreduce_bytes`` and ``allreduce_backend`` beside it, and under
        a lambda shard ``allgather_ms`` and ``allgather_bytes``; every
        rank must call this).  Each phase runs alone (``utils.timing``:
        CUDA events on the card, the best of ``repeats`` after a warm
        call and a synchronize), so their sum leaves out the host work
        an iteration does between phases.

        The engine's state is left bitwise as it was: the phases are pure
        functions of it, and the gamma inits come from a stream of their
        own (``TAG_TIMING``).  ``last_sweeps`` holds the timed E-step's
        sweeps a batch."""
        st = self.state
        cfg = self._config
        dev = self._device
        batches = self._batches
        gamma0s = self._gamma0s(batches, TAG_TIMING, self._counter)
        out = {}

        def timed(name, fn):
            ms, r = best_ms(fn, dev, repeats)
            out[name] = round(ms, 6)
            return r

        plan = self._sstats_plan
        if plan is not None:
            r = timed("estep_hybrid_full_ms", lambda: self._run_estep_hybrid(
                batches, plan, st.lam, st.alpha, gamma0s))
            sweeps = self.last_sweeps
            sstats, elog_sum = r[1], r[4]
            timed("estep_sweeps_only_ms", lambda: self._ragged_fixed_points(
                batches, st.lam, st.alpha, gamma0s))
            out["estep_total_ms"] = out["estep_hybrid_full_ms"]
        else:
            sstats, elog_sum, sweeps = None, None, []
            for i, (b, g0) in enumerate(zip(batches, gamma0s)):
                shape = (f"dense{tuple(b.counts.shape)}"
                         if isinstance(b, _Dense) else f"rows{b.mask.shape[0]}")
                r = timed(f"estep_batch{i}_{shape}_ms", lambda b=b, g0=g0:
                          self._run_estep([b], None, st.lam, st.alpha, [g0]))
                sweeps.extend(self.last_sweeps)
                sstats = r[1] if sstats is None else sstats + r[1]
                elog_sum = r[4] if elog_sum is None else elog_sum + r[4]
            out["estep_total_ms"] = round(
                sum(v for k, v in out.items() if k.startswith("estep_batch")),
                6)
        self.last_sweeps = sweeps
        lam_new = timed("mstep_ms",
                        lambda: self._eta_own(st.eta)[None, :] + sstats)
        timed("bound_ms", lambda: self._beta_elbo(st.lam, st.eta))
        timed("hyper_newton_ms", lambda: (
            newton_dirichlet_mle(st.alpha, elog_sum,
                                 float(self._corpus.global_num_docs)),
            newton_dirichlet_mle(st.eta, self._elog_lambda_sum(lam_new),
                                 float(cfg.number_of_topics)),
        ))
        out.update(self._allreduce_timing(sstats, repeats))
        return out

    # -- gamma bookkeeping --------------------------------------------------------

    def _set_gammas(self, gammas: Optional[List[torch.Tensor]],
                    doc_ids: Optional[List[np.ndarray]]) -> None:
        """``doc_ids[i]`` maps rows of ``gammas[i]`` to document indices
        (-1 for padding rows)."""
        self._gammas_dev = gammas
        self._gamma_doc_ids = doc_ids
        self._gamma_np: Optional[np.ndarray] = None

    @property
    def gamma(self) -> Optional[np.ndarray]:
        """Per-document gamma [D, K] in corpus order (host array; re-run
        at the current lambda when a ``learning_many`` left it stale).
        Under a mesh every rank gathers every rank's documents: collective."""
        if self._gamma_np is None:
            if self._gammas_dev is None:
                if self._batches is None:
                    return None
                st = self.state
                gammas = self._run_estep(
                    self._batches, self._sstats_plan, st.lam, st.alpha,
                    self._gamma0s(self._batches, TAG_GAMMA_REFRESH,
                                  self._counter),
                )[0]
                self._set_gammas(gammas, self._gamma_doc_ids_for(
                    self._batches, self._sstats_plan, self._doc_offset))
            ids, rows = self._gathered_rows(
                self._gamma_doc_ids,
                [g.cpu().numpy() for g in self._gammas_dev])
            self._gamma_np = layouts.assemble_gamma(
                ids, rows, self._corpus.global_num_docs,
                self.state.alpha.cpu().numpy(),
            )
        return self._gamma_np

    # -- held-out ------------------------------------------------------------------

    def inference(self, test_corpus: Corpus) -> Tuple[float, np.ndarray]:
        """E-step on held-out docs with lambda frozen; returns (doc-side
        bound, gamma in corpus order).  Replicated under a mesh: each rank
        runs the whole ``test_corpus`` alone (no collective; under a
        lambda shard the one gather of expElogbeta over the model group,
        then the whole column range)."""
        st = self.state
        batches = self._build_batches(test_corpus)
        plan = self._plan_dense_sstats(test_corpus, own=False)
        gammas, _, token_score, theta_score, _ = self._run_estep(
            batches, plan, st.lam, st.alpha,
            self._gamma0s(batches, TAG_GAMMA_TEST, self._counter),
            sharded=False,
        )
        gamma = layouts.assemble_gamma(
            self._gamma_doc_ids_for(batches, plan),
            [g.cpu().numpy() for g in gammas],
            test_corpus.num_docs,
            st.alpha.cpu().numpy(),
        )
        return float(token_score + theta_score), gamma
