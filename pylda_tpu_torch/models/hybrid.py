"""Hybrid VB/sampling engine (Mimno, Hoffman & Blei 2012).

Counterpart of ``pylda_tpu.models.hybrid.Hybrid``: the global word-topic
state stays variational (lambda, the VB M-step, ELBO and Newton
alpha/eta), but the per-document local step replaces the gamma fixed
point with collapsed Gibbs sweeps over each document's tokens against
exp(E[log beta]) as the frozen topic-word factor
(``ops/sampling.sample_doc_topics`` on the sequence buckets).  The
sufficient statistics and gamma are averaged over ``number_of_samples``
kept sweeps after ``burn_in_sweeps`` discarded ones, and the token part
of the bound is ``sequence_token_score``.

It rides on ``VariationalBayes`` through its seams: the sequence
buckets (``_build_batches``), no dense sufficient statistics
(``_plan_dense_sstats``) and the sampled local step (``_run_estep`` for
held-out inference and ``gamma``, ``_train_estep`` for training).  It
never reaches VB's ragged + dense-sstats route, so it launches none of
the CUDA kernels.  With ``hybrid_persistent_z`` the topic assignments are
carried across iterations (and saved as ``zh_<i>`` blobs); otherwise each
iteration starts every chain from random z.

Under a mesh each rank samples its block of documents
(``_build_local_batches``: ``gibbs.local_sequence_batches``) from streams
of its own (its data coordinate in the purpose tag), and VB's
``_reduce_estep`` sums the sufficient statistics and doc-level terms over
the data group.

Under ``shard_vocab`` / ``shard_topics`` with a model axis above 1 each
rank keeps its block of lambda (``parallel/lam_shard.py``): a step
gathers the whole lambda over the model group once (``_whole_lam``; kept
for that block, so the bound, the next step's E-step and the Newton eta
input of the new lambda read one gather), computes E[log beta] whole and
samples as in one process, and counts the sufficient statistics into
this rank's block only, so the M-step is local.  The token score is then
whole on every rank (not summed over the model group), and the topic
side of the bound and the Newton eta input are computed from the
gathered lambda, so a (1, M) run gives the one-process bits and a (D, M)
run the (D, 1) run's.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from pylda_tpu_torch.corpus.corpus import Corpus
from pylda_tpu_torch.models.base import bucket_tensors
from pylda_tpu_torch.models.gibbs import (
    SeqBatch,
    gather_chains,
    local_chains,
    local_sequence_batches,
    rank_tag,
    sequence_batches,
)
from pylda_tpu_torch.models.vb import VariationalBayes
from pylda_tpu_torch.ops.dirichlet import (
    beta_elbo,
    dirichlet_expectation,
    theta_elbo,
)
from pylda_tpu_torch.ops.sampling import (
    random_assignments,
    sample_doc_topics,
    sequence_token_score,
    stream,
)

# Purpose tags of the random streams: persistent chains' init, training
# iterations, held-out inference.
TAG_CHAIN, TAG_TRAIN, TAG_TEST = 0x2B1D, 0x4B1D, 0x7E57


class Hybrid(VariationalBayes):
    """VB global step + within-document Gibbs local step."""

    _USES_GAMMA_INIT = False
    # The sampler reads the whole lambda: the token score covers every
    # word on each rank.
    _PARTIAL_TOKEN_SCORE = False
    _CONTIGUOUS_GATHER = True

    def __init__(self, config, device=None):
        super().__init__(config, device)
        # (lambda block, the whole lambda gathered from it) under a shard.
        self._lam_whole = None

    # -- the whole lambda under a shard ------------------------------------------

    def _whole_lam(self, lam: torch.Tensor) -> torch.Tensor:
        """The whole lambda of which ``lam`` is this rank's block: one
        all-gather over the model group, contiguous, kept for that block
        (collective on a block's first use); ``lam`` without a shard."""
        if self._shard is None:
            return lam
        if self._lam_whole is None or self._lam_whole[0] is not lam:
            self._lam_whole = (lam, self._shard.gather(lam, contiguous=True))
        return self._lam_whole[1]

    def gathered_lam(self) -> torch.Tensor:
        return self._whole_lam(self.state.lam)

    def _state_changed(self) -> None:
        super()._state_changed()
        self._lam_whole = None

    def _beta_elbo(self, lam, eta) -> torch.Tensor:
        """The topic side of the bound, from the whole lambda."""
        return beta_elbo(self._whole_lam(lam), eta)

    def _elog_lambda_sum(self, lam) -> torch.Tensor:
        """The Newton eta input, from the whole lambda (its gather is the
        next step's)."""
        return dirichlet_expectation(self._whole_lam(lam)).sum(dim=0)

    def _build_batches(self, corpus: Corpus) -> List[SeqBatch]:
        return sequence_batches(corpus, self._config, self._device,
                                self._dtype)

    def _build_local_batches(self, corpus: Corpus) -> List[SeqBatch]:
        return local_sequence_batches(corpus, self._config, self._mesh,
                                      self._device, self._dtype)

    def _plan_dense_sstats(self, corpus: Corpus, own: bool = True):
        return None  # sstats come from the sampled assignments

    def _prepare(self, corpus: Corpus) -> None:
        super()._prepare(corpus)
        cfg = self._config
        self._z_hyb: Optional[List[torch.Tensor]] = None
        if not cfg.hybrid_persistent_z:
            return
        self._z_hyb = [
            random_assignments(b.tokens.shape, cfg.number_of_topics,
                               stream(self._device, cfg.seed,
                                      rank_tag(TAG_CHAIN, self._mesh), i))
            for i, b in enumerate(self._batches)
        ]
        blobs = getattr(self, "_zh_restore", None)
        if blobs:
            # A model file's chains, when its bucket layout matches this
            # corpus's; otherwise the fresh chains stand (one more
            # burn-in transient, never an error).
            try:
                self.set_chains(local_chains(
                    [blobs[f"zh_{i}"] for i in range(len(blobs))], self._mesh))
            except (KeyError, ValueError):
                pass

    def set_chains(self, zhs) -> None:
        """Place persistent chains given as numpy arrays (a JAX engine's,
        or a model file's ``zh_<i>`` blobs), one [rows, width] array a
        sequence bucket, on the engine's device.  Raises ``ValueError``
        unless every shape matches this engine's buckets."""
        self._z_hyb = bucket_tensors(zhs, self._batches, torch.int32,
                                     self._device, "zh")

    # -- the sampled local step ------------------------------------------------

    def _sampled_estep(self, batches: List[SeqBatch], lam, alpha, tag,
                       zs=None, replicated: bool = False, **ranges):
        """Sampled local step over every sequence bucket against the whole
        ``lam``, from the chains ``zs`` (None: random z a bucket).
        ``tag`` (purpose, step) seeds the streams, with the data
        coordinate in the purpose unless ``replicated``; ``ranges``
        (``topic_range``, ``vocab_range``) makes sstats that block.
        Returns the VB E-step contract (gammas, sstats, token_score,
        theta_score, elog_sum) plus the advanced z."""
        cfg = self._config
        dev = self._device
        elog_beta = dirichlet_expectation(lam)  # frozen for the step
        sstats = None
        token_score = torch.zeros((), dtype=lam.dtype, device=dev)
        theta_score = torch.zeros((), dtype=lam.dtype, device=dev)
        elog_sum = torch.zeros(alpha.shape, dtype=lam.dtype, device=dev)
        gammas, z_out = [], []
        for i, b in enumerate(batches):
            purpose = tag[0] if replicated else rank_tag(tag[0], self._mesh)
            seeds = (cfg.seed, purpose, *tag[1:], i)
            z0 = zs[i] if zs is not None else random_assignments(
                b.tokens.shape, cfg.number_of_topics, stream(dev, *seeds, 1))
            gamma_b, ss, z_new, _ndk = sample_doc_topics(
                b.tokens, b.token_mask, elog_beta, alpha, z0,
                stream(dev, *seeds, 2),
                num_types=self._number_of_types,
                burn_in=cfg.burn_in_sweeps, num_samples=cfg.number_of_samples,
                sampler=cfg.resolved_topic_sampler(),
                block_positions=cfg.sampler_block_positions,
                **ranges,
            )
            elog_theta = dirichlet_expectation(gamma_b)
            token_score = token_score + sequence_token_score(
                b.tokens, b.token_mask, elog_theta, elog_beta)
            theta_score = theta_score + theta_elbo(gamma_b, alpha, b.mask)
            elog_sum = elog_sum + (elog_theta * b.mask[:, None]).sum(dim=0)
            sstats = ss if sstats is None else sstats + ss
            gammas.append(gamma_b)
            z_out.append(z_new)
        return gammas, sstats, token_score, theta_score, elog_sum, z_out

    def _run_estep(self, batches, plan, lam, alpha, gamma0s,
                   sharded: bool = True):
        """Held-out inference and ``gamma``: cold chains against the whole
        lambda of the block ``lam``, sstats of this rank's block when
        ``sharded``.  ``plan`` is always None and ``gamma0s`` unused (the
        sampled step initialises assignments, not gamma).  Held-out
        inference draws the same streams on every rank, so it runs
        replicated."""
        return self._sampled_estep(batches, self._whole_lam(lam), alpha,
                                   (TAG_TEST, self._counter),
                                   replicated=True,
                                   **self._block_ranges(sharded))[:5]

    def _train_estep(self, gamma0s):
        """The training step: persistent chains advance in place."""
        st = self.state
        *out, z_new = self._sampled_estep(
            self._batches, self._whole_lam(st.lam), st.alpha,
            (TAG_TRAIN, self._counter), self._z_hyb, **self._block_ranges())
        if self._z_hyb is not None:
            self._z_hyb = z_new
        return tuple(out)

    # -- model files ------------------------------------------------------------

    def _extra_state(self) -> dict:
        """The persistent chains of every data coordinate (gathered over
        the data group), as ``zh_<i>``."""
        d = super()._extra_state()
        zs = gather_chains(getattr(self, "_z_hyb", None) or (), self._mesh)
        for i, z in enumerate(zs):
            d[f"zh_{i}"] = z
        return d

    def _load_extra_state(self, blobs: dict) -> None:
        super()._load_extra_state(
            {k: v for k, v in blobs.items() if not k.startswith("zh_")})
        self._zh_restore = {k: v for k, v in blobs.items()
                            if k.startswith("zh_")}
