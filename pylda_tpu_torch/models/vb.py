"""Batch mean-field variational Bayes engine.

Counterpart of ``pylda_tpu.models.vb.VariationalBayes`` on its large-vocab
route (V > ``dense_vocab_threshold``): per length bucket the gamma fixed
point (``ops/ragged.ragged_gamma``, a CUDA kernel on the card), per-document
gamma assembly, sufficient statistics and token score against
corpus-static dense count chunks (``ops/sstats.dense_sstats``, a CUDA
kernel on the card), then lambda = eta + sstats, the ELBO and, on
schedule, the Newton alpha/eta updates.

PyTorch runs eagerly, so there is no jit or scan here: ``learning_many``
is a Python loop whose kernels queue on the device stream; it reads the
ELBOs back once at the end (the Newton updates read one scalar per Newton
step).  Three routes of the JAX engine are not ported yet and raise
``NotImplementedError`` naming their ROADMAP item: the dense layout
(V <= dense_vocab_threshold), ``sstats_mode="scatter"``, and a corpus over
``sstats_dense_total_budget_mb``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from pylda_tpu_torch.corpus.corpus import Corpus
from pylda_tpu_torch.models import layouts
from pylda_tpu_torch.models.base import Inferencer, LDAState
from pylda_tpu_torch.ops.dirichlet import (
    beta_elbo,
    dirichlet_expectation,
    exp_dirichlet_expectation,
    exp_dirichlet_expectation_fast,
    theta_elbo,
)
from pylda_tpu_torch.ops.hyper import newton_dirichlet_mle
from pylda_tpu_torch.ops.ragged import gather_table, ragged_gamma
from pylda_tpu_torch.ops.sstats import dense_sstats
from pylda_tpu_torch.utils import round_up as _round_up
from pylda_tpu_torch.utils.config import LDAConfig


@dataclasses.dataclass
class _Bucket:
    """One ragged bucket on the device."""

    ids: torch.Tensor  # [D_b, T_b] int32
    cnts: torch.Tensor  # [D_b, T_b] f32
    row_index: torch.Tensor  # [D_b] int64: doc id, num_docs for padding


@dataclasses.dataclass
class _SstatsPlan:
    """Corpus-static dense counts for the sufficient statistics."""

    chunks: List[Tuple[torch.Tensor, torch.Tensor]]  # (counts, doc index)
    docs_mask: torch.Tensor  # [num_docs] f32: 1 for non-empty docs
    num_docs: int


def _gamma_init(shape, dtype, device) -> torch.Tensor:
    """The per-row gamma init of the fixed point: the deterministic "ones"
    cold start, ``gamma_init``'s default (the engine refuses the random
    modes at construction)."""
    return torch.ones(shape, dtype=dtype, device=device)


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


def _host_gamma(gamma_docs: torch.Tensor, alpha: torch.Tensor) -> np.ndarray:
    """Per-document gamma as a host array, through ``assemble_gamma`` as
    the JAX engine returns it (alpha + (gamma - alpha))."""
    g = gamma_docs.cpu().numpy()
    return layouts.assemble_gamma(
        [np.arange(g.shape[0], dtype=np.int32)], [g], g.shape[0],
        alpha.cpu().numpy(),
    )


class VariationalBayes(Inferencer):
    """Batch VB over the full corpus each iteration."""

    def __init__(
        self,
        config: LDAConfig,
        device: Union[str, torch.device, None] = None,
    ):
        super().__init__(config, device)
        cfg = self._config
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                "compute_dtype='bfloat16' is not ported yet: the kernels "
                "compute in float32 (ROADMAP.md Queue 2, bf16 operands)"
            )
        if cfg.gamma_init != "ones":
            raise NotImplementedError(
                f"gamma_init={cfg.gamma_init!r} needs a torch random stream; "
                "not ported yet (ROADMAP.md Queue 1 item 7)"
            )
        if self._device.type == "cuda" and self._dtype != torch.float32:
            raise NotImplementedError("the CUDA kernels take float32 only")
        self.last_sweeps: List[torch.Tensor] = []
        self._gamma_np: Optional[np.ndarray] = None
        self._gamma_docs: Optional[torch.Tensor] = None

    # -- corpus preparation ---------------------------------------------------

    def _check_route(self, corpus: Corpus) -> None:
        """Raise for the routes of the JAX engine this slice does not port."""
        cfg = self._config
        if corpus.num_types <= cfg.dense_vocab_threshold:
            raise NotImplementedError(
                "the dense layout (V <= dense_vocab_threshold) is not ported "
                "yet (ROADMAP.md Queue 1 item 7, Queue 2 item 3)"
            )
        if cfg.sstats_mode == "scatter":
            raise NotImplementedError(
                "sstats_mode='scatter' is not ported yet (ROADMAP.md Queue 1 "
                "item 7)"
            )
        if getattr(corpus, "process_local", False):
            raise NotImplementedError(
                "process-local corpora are not ported yet (ROADMAP.md Queue 1 "
                "item 12)"
            )
        total_mb = corpus.num_docs * corpus.num_types * 4 / 1e6
        if total_mb > cfg.sstats_dense_total_budget_mb:
            raise NotImplementedError(
                f"a corpus over sstats_dense_total_budget_mb ({total_mb:.0f} "
                f"> {cfg.sstats_dense_total_budget_mb} MB) needs the scatter "
                "route, not ported yet (ROADMAP.md Queue 1 item 7)"
            )

    def _build_batches(self, corpus: Corpus) -> List[_Bucket]:
        dev = self._device
        out = []
        for b in layouts.build_vb_batches(corpus, self._config):
            row_index = np.where(b.doc_ids >= 0, b.doc_ids, corpus.num_docs)
            out.append(_Bucket(
                ids=torch.as_tensor(b.ids, device=dev),
                cnts=torch.as_tensor(b.cnts, device=dev).to(self._dtype),
                row_index=torch.as_tensor(row_index, dtype=torch.int64,
                                          device=dev),
            ))
        return out

    def _plan_dense_sstats(self, corpus: Corpus) -> _SstatsPlan:
        """Corpus-static dense counts chunks (docs chunked to
        ``sstats_dense_budget_mb``), vocab-prepadded once to a multiple of
        1024 and stored bf16 when every count is <= 256 (bf16 is exact
        for those integers, and the kernel upcasts)."""
        cfg = self._config
        dev = self._device
        pad = cfg.doc_pad_multiple
        rows_budget = int(cfg.sstats_dense_budget_mb * 1e6
                          // (4 * corpus.num_types))
        rows_budget = max(pad, (rows_budget // pad) * pad)
        num_docs = corpus.num_docs
        v_pad = _round_up(corpus.num_types, 1024)
        chunks = []
        for start in range(0, num_docs, rows_budget):
            stop = min(num_docs, start + rows_budget)
            ch = corpus.to_dense(
                doc_indices=range(start, stop),
                pad_docs_to=_round_up(stop - start, pad),
            )
            counts = ch.counts
            if v_pad > counts.shape[1]:
                counts = np.pad(counts, ((0, 0), (0, v_pad - counts.shape[1])))
            dtype = (
                torch.bfloat16 if counts.max(initial=0.0) <= 256.0
                else self._dtype
            )
            # Padding rows gather doc 0's expEtheta but carry all-zero
            # counts — inert in both sstats and the token score.
            cidx = np.where(ch.doc_ids >= 0, ch.doc_ids, 0)
            chunks.append((
                torch.as_tensor(counts, device=dev).to(dtype),
                torch.as_tensor(cidx, dtype=torch.int64, device=dev),
            ))
        docs_mask = np.asarray([d.size > 0 for d in corpus.docs], np.float32)
        return _SstatsPlan(
            chunks=chunks,
            docs_mask=torch.as_tensor(docs_mask, device=dev).to(self._dtype),
            num_docs=num_docs,
        )

    def _prepare(self, corpus: Corpus) -> None:
        self._check_route(corpus)
        self._batches = self._build_batches(corpus)
        self._sstats_plan = self._plan_dense_sstats(corpus)
        self._set_gammas(None)

    def _state_changed(self) -> None:
        self._set_gammas(None)

    def _gamma0s(self, batches: List[_Bucket]) -> List[torch.Tensor]:
        K = self._config.number_of_topics
        return [
            _gamma_init((b.ids.shape[0], K), self._dtype, self._device)
            for b in batches
        ]

    # -- E-step ---------------------------------------------------------------

    def _ragged_gamma_fixed_point(self, b: _Bucket, gamma0, eeb, alpha,
                                  eeb_t):
        """Gamma fixed point of one ragged bucket: the CUDA kernel for
        tensors on the card, its plain version on the CPU."""
        cfg = self._config
        return ragged_gamma(
            b.ids, b.cnts, gamma0, eeb, alpha,
            inner_iterations=cfg.inner_iterations,
            convergence_threshold=cfg.convergence_threshold,
            eps=cfg.eps,
            stall_patience=cfg.estep_stall_patience,
            eeb_t=eeb_t,
        )

    def _run_estep_hybrid(
        self, batches: List[_Bucket], plan: _SstatsPlan, lam, alpha,
        gamma0s: List[torch.Tensor],
    ):
        """Ragged sweeps + scatter-free dense sufficient statistics.
        Returns (gamma_docs, sstats, token_score, theta_score, elog_sum);
        the sweeps each bucket took stay on the device in
        ``last_sweeps``."""
        cfg = self._config
        eeb = exp_dirichlet_expectation_fast(lam)
        # The kernel gathers rows of expElogbeta^T: build the table once
        # for all buckets of this E-step.
        eeb_t = gather_table(eeb) if eeb.is_cuda else None
        rows, sweeps = [], []
        for b, gamma0 in zip(batches, gamma0s):
            g, s = self._ragged_gamma_fixed_point(b, gamma0, eeb, alpha, eeb_t)
            rows.append(g)
            sweeps.append(s)
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
            ss, tok = dense_sstats(counts, et_docs[cidx], eeb, eps=cfg.eps)
            sstats = ss if sstats is None else sstats + ss
            token_score = token_score + tok
        theta_score = theta_elbo(gamma_docs, alpha, plan.docs_mask)
        elog_sum = (
            dirichlet_expectation(gamma_docs) * plan.docs_mask[:, None]
        ).sum(dim=0)
        return gamma_docs, sstats, token_score, theta_score, elog_sum

    # -- one full VB iteration ------------------------------------------------

    def _iteration(self, update_hypers: bool, gamma0s):
        """One batch-VB iteration from ``self.state``; returns
        (new_state, elbo 0-d tensor, gamma_docs)."""
        cfg = self._config
        st = self.state
        gamma_docs, sstats, token_score, theta_score, elog_sum = (
            self._run_estep_hybrid(
                self._batches, self._sstats_plan, st.lam, st.alpha, gamma0s
            )
        )
        elbo = token_score + theta_score + beta_elbo(st.lam, st.eta)
        lam_new = st.eta[None, :] + sstats
        alpha_new, eta_new = st.alpha, st.eta
        if update_hypers:
            alpha_new = newton_dirichlet_mle(
                st.alpha, elog_sum, float(self._corpus.global_num_docs)
            )
            eta_new = newton_dirichlet_mle(
                st.eta, _elog_lambda_sum(lam_new), float(cfg.number_of_topics)
            )
        new_state = LDAState(
            lam=lam_new, alpha=alpha_new, eta=eta_new, step=st.step + 1
        )
        return new_state, elbo, gamma_docs

    def _hyper_due(self) -> bool:
        interval = self._config.hyper_parameter_optimize_interval
        return interval > 0 and (self._counter + 1) % interval == 0

    # -- public training surface ------------------------------------------------

    def learning(self) -> float:
        """One batch-VB iteration: E-step, bound, M-step, hyper updates.
        Returns the ELBO at (gamma*, lambda used in the E-step)."""
        new_state, elbo, gamma_docs = self._iteration(
            self._hyper_due(), self._gamma0s(self._batches)
        )
        self._state = new_state
        self._step_host += 1
        self._set_gammas(gamma_docs)
        return float(elbo)

    def learning_many(self, n: int) -> List[float]:
        """n iterations in a loop that stays on the device; the gamma
        inits are made once for all n (as the JAX scan does).  Returns
        the per-iteration ELBOs."""
        if n <= 0:
            return []
        gamma0s = self._gamma0s(self._batches)
        elbos = []
        for _ in range(n):
            new_state, elbo, _ = self._iteration(self._hyper_due(), gamma0s)
            self._state = new_state
            self._step_host += 1
            elbos.append(elbo)
        self._set_gammas(None)  # lazy: .gamma re-runs the E-step
        return [float(x) for x in torch.stack(elbos).cpu()]

    # -- gamma bookkeeping --------------------------------------------------------

    def _set_gammas(self, gamma_docs: Optional[torch.Tensor]) -> None:
        self._gamma_docs = gamma_docs
        self._gamma_np = None

    @property
    def gamma(self) -> Optional[np.ndarray]:
        """Per-document gamma [D, K] in corpus order (host array; re-run
        at the current lambda when a ``learning_many`` left it stale)."""
        if self._gamma_np is None:
            if self._gamma_docs is None:
                if getattr(self, "_batches", None) is None:
                    return None
                st = self.state
                self._gamma_docs = self._run_estep_hybrid(
                    self._batches, self._sstats_plan, st.lam, st.alpha,
                    self._gamma0s(self._batches),
                )[0]
            self._gamma_np = _host_gamma(self._gamma_docs, self.state.alpha)
        return self._gamma_np

    # -- held-out ------------------------------------------------------------------

    def inference(self, test_corpus: Corpus) -> Tuple[float, np.ndarray]:
        """E-step on held-out docs with lambda frozen; returns (doc-side
        bound, gamma in corpus order)."""
        self._check_route(test_corpus)
        st = self.state
        batches = self._build_batches(test_corpus)
        plan = self._plan_dense_sstats(test_corpus)
        gamma_docs, _, token_score, theta_score, _ = self._run_estep_hybrid(
            batches, plan, st.lam, st.alpha, self._gamma0s(batches)
        )
        return float(token_score + theta_score), _host_gamma(gamma_docs,
                                                             st.alpha)
