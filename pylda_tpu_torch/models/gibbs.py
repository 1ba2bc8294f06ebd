"""Collapsed Gibbs sampling engine.

Counterpart of ``pylda_tpu.models.gibbs.MonteCarlo``: persistent per-token
topic assignments z on the sequence layout (length buckets of padded
token rows, ``layouts.effective_sequence_bucket_sizes``), the count tables
n_dk and n_kv, one sweep of every bucket per ``learning()`` call, the
Griffiths-Steyvers joint log likelihood as the training objective, and
Wallach slice-sampled alpha/eta every ``hyper_parameter_optimize_interval``
sweeps.

The chain is the JAX engine's AD-LDA approximation (Newman et al. 2009):
the topic-word table is frozen at sweep start, within-document updates
are exact and sequential (leave-block-out at ``sampler_block_positions``
> 1, ``ops/sampling.py``), and n_kv is rebuilt from z after the sweep.
Parity with the JAX engine is statistical: the random streams differ.

Random streams: each bucket's sweep draws from a ``torch.Generator`` on
the engine's device seeded from (config seed, purpose tag, sweep index,
bucket), so ``learning()`` n times and ``learning_many(n)`` draw the same
chain, and a run resumed from a model file continues the unbroken one's.

PyTorch runs eagerly: ``learning_many`` is a Python loop whose operations
queue on the device stream; it keeps every sweep's likelihood on the
device and reads them once a chunk (chunks end at hyperopt boundaries,
where the slice sampler reads the likelihood on the host).
``phase_timings`` times a sweep and the joint likelihood apart.

Under a mesh (``parallel/mesh.py``) this is the JAX engine's multi-host
AD-LDA: each rank holds its block of documents (``_local_corpus``) as
sequence buckets of the configured widths padded to the ranks' largest
row counts (``local_sequence_batches``), its own z and n_dk, and draws
from streams of its own (the rank in the purpose tag, ``_tag``); each
sweep sums n_kv over the data group in one all-reduce (exact: the counts
are integers) and the doc side of the likelihood in another, so n_kv and
the likelihood are the same bits on every rank.  ``gibbs_rebuild_interval``
> 1 warns and runs the exact per-sweep rebuild there.  A model file
carries every rank's chains, gathered bucket by bucket in data order.

With a model axis above 1 (mesh (D, M)) the ranks of a model group hold
the same documents, chains and streams (the purpose tags carry the data
coordinate only, so a (1, M) run draws the one-process streams).  Under
``shard_vocab`` / ``shard_topics`` each rank keeps its block of n_kv
(``parallel/lam_shard.py``, lambda's bounds): the rebuild counts the
rank's tokens into its block only and all-reduces it over the data
group, then the blocks are gathered over the model group once a sweep
(``_n_kv_whole``); the factor, the joint likelihood, the slice sampler,
held-out inference and the model file read that whole table.  The counts
are exact integers, so every table is the one-process (at (1, M)) or
(D, 1) run's bits.  With neither flag each rank keeps n_kv whole.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.special import gammaln

from pylda_tpu_torch.corpus.corpus import Corpus
from pylda_tpu_torch.models import layouts
from pylda_tpu_torch.models.base import Inferencer, LDAState, bucket_tensors
from pylda_tpu_torch.ops.dirichlet import gammaln_fast
from pylda_tpu_torch.ops.hyper import slice_sample
from pylda_tpu_torch.ops.sampling import (
    count_table,
    random_assignments,
    sample_doc_topics,
    sequence_token_score,
    stream,
    stream_seed,
)
from pylda_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_sum,
    host_gather,
    lift_process_local_buckets,
)
from pylda_tpu_torch.utils.timing import best_ms

# Purpose tags of the random streams (the JAX engine's fold_in constants).
TAG_INIT, TAG_SWEEP, TAG_TEST, TAG_SLICE = 0x51BB5, 0x5EE9, 0x7E57, 0x511CE


@dataclasses.dataclass
class SeqBatch:
    """One sequence bucket on the device."""

    tokens: torch.Tensor  # [D_b, L_b] int64 (0 on padding)
    token_mask: torch.Tensor  # [D_b, L_b]: 1 on real token slots
    mask: torch.Tensor  # [D_b]: 1 on real rows
    doc_ids: np.ndarray  # [D_b] int32, -1 for padding rows

    @property
    def rows(self) -> int:
        return self.tokens.shape[0]


def sequence_batches(corpus: Corpus, config, device, dtype) -> List[SeqBatch]:
    """The corpus's sequence buckets (documents over the largest width
    chunked into rows sharing their doc id) on ``device``."""
    return _on_device(corpus.to_sequence_buckets(
        bucket_sizes=layouts.effective_sequence_bucket_sizes(corpus, config),
        doc_pad_multiple=config.doc_pad_multiple,
    ), device, dtype)


def local_sequence_batches(corpus: Corpus, config, mesh: Mesh, device,
                           dtype) -> List[SeqBatch]:
    """A rank's document block as sequence buckets of the configured
    ``bucket_sizes``, padded to the ranks' largest row counts with inert
    rows and doc ids re-based to global (``lift_process_local_buckets``),
    on ``device``.  Collective."""
    return _on_device(lift_process_local_buckets(
        corpus.to_sequence_buckets(bucket_sizes=tuple(config.bucket_sizes),
                                   doc_pad_multiple=1),
        config.bucket_sizes, config.doc_pad_multiple, mesh,
        corpus.global_doc_offset,
    ), device, dtype)


def rank_tag(tag: int, mesh: Optional[Mesh]) -> int:
    """A stream's purpose tag, with the data coordinate in its bits above
    40 when the documents are split over ranks (each data coordinate
    draws its own noise; the ranks of a model group share it, and a
    (1, M) mesh draws the one-process streams)."""
    if mesh is None or mesh.data == 1:
        return tag
    return tag | ((mesh.data_index + 1) << 40)


def gather_chains(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]
                  ) -> List[np.ndarray]:
    """Per-bucket chains as numpy arrays: this rank's rows, or, with the
    documents split over ranks, every data coordinate's rows in order
    (the layout of the JAX engine's global buckets).  Collective over
    the data group then."""
    return [host_gather(t, mesh) for t in tensors]


def local_chains(arrays: Sequence[np.ndarray], mesh: Optional[Mesh]
                 ) -> List[np.ndarray]:
    """This rank's rows of chains ``gather_chains`` wrote under a mesh of
    the same data axis (each array's rows split evenly over the data
    coordinates)."""
    if mesh is None or mesh.data == 1:
        return list(arrays)
    out = []
    for a in arrays:
        rows = a.shape[0] // mesh.data
        d = mesh.data_index
        out.append(a[d * rows:(d + 1) * rows])
    return out


def _on_device(buckets, device, dtype) -> List[SeqBatch]:
    return [
        SeqBatch(
            tokens=torch.as_tensor(b.tokens, device=device).long(),
            token_mask=torch.as_tensor(b.token_mask, device=device).to(dtype),
            mask=torch.as_tensor(b.mask, device=device).to(dtype),
            doc_ids=b.doc_ids,
        )
        for b in buckets
    ]


def doc_topic_counts(z, token_mask, num_topics: int) -> torch.Tensor:
    """n_dk [D, K] of assignments z [D, L]."""
    ndk = torch.zeros((z.shape[0], num_topics), dtype=token_mask.dtype,
                      device=token_mask.device)
    return ndk.scatter_add_(1, z.long(), token_mask)


def _log_phi_hat(n_kv, beta):
    """log[(n_kv + beta_v) / (n_k + sum beta)]."""
    n_k = n_kv.sum(dim=1, keepdim=True)
    return torch.log(n_kv + beta[None, :]) - torch.log(n_k + beta.sum())


def _topic_side_ll(n_kv, beta):
    """K[logG(sum b) - sum logG(b)] + sum_k[sum_v logG(n_kv + b) -
    logG(n_k + sum b)], the [K, V] surface at the fast lgamma."""
    K = n_kv.shape[0]
    n_k = n_kv.sum(dim=1)
    s = K * (gammaln(beta.sum()) - gammaln(beta).sum())
    s = s + gammaln_fast(n_kv + beta[None, :]).sum()
    return s - gammaln_fast(n_k + beta.sum()).sum()


def _doc_side_ll(ndk, mask, alpha):
    """D[logG(sum a) - sum logG(a)] + sum_d[...], padding rows masked."""
    n_d = ndk.sum(dim=1)
    per_doc = (
        gammaln_fast(ndk + alpha[None, :]).sum(dim=1)
        - gammaln_fast(n_d + alpha.sum())
        + gammaln(alpha.sum())
        - gammaln(alpha).sum()
    )
    return (mask * per_doc).sum()


class MonteCarlo(Inferencer):
    """Collapsed Gibbs with per-sweep table synchronisation."""

    _CONTIGUOUS_GATHER = True

    def __init__(self, config, device=None):
        super().__init__(config, device)
        self._buckets: Optional[List[SeqBatch]] = None
        self._z: List[torch.Tensor] = []
        self._ndk: List[torch.Tensor] = []
        # This rank's block of n_kv (the whole table without a shard), and
        # the whole table the sweep reads (the same tensor without one).
        self._n_kv: Optional[torch.Tensor] = None
        self._n_kv_whole: Optional[torch.Tensor] = None
        self._restore: Optional[dict] = None

    # -- corpus preparation -------------------------------------------------

    def _tag(self, tag: int) -> int:
        return rank_tag(tag, self._mesh)

    def _prepare(self, corpus: Corpus) -> None:
        cfg = self._config
        K = cfg.number_of_topics
        local = self._local_corpus(corpus)
        if self._split:
            self._buckets = local_sequence_batches(
                local, cfg, self._mesh, self._device, self._dtype)
        else:
            self._buckets = sequence_batches(corpus, cfg, self._device,
                                             self._dtype)
        if cfg.gibbs_rebuild_interval > 1 and self._mesh is not None:
            warnings.warn(
                "gibbs_rebuild_interval > 1 is single-process only; "
                "running the exact per-sweep rebuild under the mesh",
                stacklevel=2,
            )
        if self._restore_chains():
            return
        self._z = [
            random_assignments(b.tokens.shape, K,
                               stream(self._device, cfg.seed,
                                      self._tag(TAG_INIT), i))
            for i, b in enumerate(self._buckets)
        ]
        self._ndk = [doc_topic_counts(z, b.token_mask, K)
                     for z, b in zip(self._z, self._buckets)]
        self._set_counts(self._count_all(self._z))

    def _restore_chains(self) -> bool:
        """Adopt the chains of a loaded model file when its bucket layout
        matches this corpus's (otherwise the chains start afresh)."""
        blobs = self._restore
        if not blobs or "n_kv" not in blobs:
            return False
        n = sum(1 for k in blobs if k.startswith("z_"))
        try:
            self.set_chains(
                blobs["n_kv"],
                local_chains([blobs[f"z_{i}"] for i in range(n)], self._mesh),
                local_chains([blobs[f"ndk_{i}"] for i in range(n)],
                             self._mesh))
        except (KeyError, ValueError):
            return False
        return True

    def set_chains(self, n_kv, zs, ndks) -> None:
        """Place Gibbs chains given as numpy arrays (a JAX engine's state,
        or a model file's ``n_kv``, ``z_<i>`` and ``ndk_<i>`` blobs) on the
        engine's device: the whole [K, V] table ``n_kv`` (under a shard
        this rank keeps its block, as the ``state`` setter does lambda's)
        and, per sequence bucket, the assignments ``zs`` [rows, width] and
        doc-topic counts ``ndks`` [rows, K].  Raises ``ValueError`` unless
        every shape matches this engine's buckets."""
        K, dev = self._config.number_of_topics, self._device
        want = (K, self._number_of_types)
        if np.shape(n_kv) != want:
            raise ValueError(f"n_kv has shape {np.shape(n_kv)}, want {want}")
        z = bucket_tensors(zs, self._buckets, torch.int32, dev, "z")
        ndk = bucket_tensors(ndks, self._buckets, self._dtype, dev, "ndk",
                             width=K)
        self._set_whole_counts(n_kv)
        self._z, self._ndk = z, ndk

    def _set_whole_counts(self, n_kv) -> None:
        """Adopt a whole [K, V] table given on the host (every rank the
        same): this rank keeps its block, and the whole table stands as
        the gathered one (no collective)."""
        whole = torch.as_tensor(np.array(n_kv), device=self._device).to(
            self._dtype)
        self._n_kv_whole = whole
        self._n_kv = (whole if self._shard is None
                      else self._shard.take(whole).contiguous())

    def _whole(self, block: torch.Tensor) -> torch.Tensor:
        """The whole n_kv from the model group's blocks (one all-gather,
        contiguous); ``block`` itself without a shard."""
        if self._shard is None:
            return block
        return self._shard.gather(block, contiguous=True)

    def _set_counts(self, block: torch.Tensor) -> None:
        """Adopt a rebuilt block of n_kv and gather the whole table."""
        self._n_kv, self._n_kv_whole = block, self._whole(block)

    def _count_all(self, zs) -> torch.Tensor:
        """This rank's block of n_kv counted from the chains ``zs``, summed
        over the data group."""
        K, V = self._config.number_of_topics, self._number_of_types
        n_kv = None
        for b, z in zip(self._buckets, zs):
            t = count_table(b.tokens, b.token_mask, z, K, V,
                            **self._block_ranges())
            n_kv = t if n_kv is None else n_kv + t
        return all_reduce_sum(n_kv, self._mesh, "data")

    # -- sweeps -------------------------------------------------------------------

    def _sample_buckets(self, sweep: int, log_tw, accumulate: bool):
        """One sweep of every bucket against a fixed factor; sweep index
        ``sweep`` seeds the streams.  Returns (z, ndk, this rank's block of
        the rebuilt n_kv summed over the data group, or None)."""
        cfg = self._config
        alpha = self.state.alpha
        z_out, ndk_out, n_kv = [], [], None
        for i, (b, z) in enumerate(zip(self._buckets, self._z)):
            _g, counts, z_new, ndk = sample_doc_topics(
                b.tokens, b.token_mask, log_tw, alpha, z,
                stream(self._device, cfg.seed, self._tag(TAG_SWEEP), sweep,
                       i),
                num_types=self._number_of_types, burn_in=0, num_samples=1,
                sampler=cfg.resolved_topic_sampler(),
                block_positions=cfg.sampler_block_positions,
                accumulate_counts=accumulate,
                **self._block_ranges(),
            )
            z_out.append(z_new)
            ndk_out.append(ndk)
            if accumulate:
                n_kv = counts if n_kv is None else n_kv + counts
        if accumulate:
            n_kv = all_reduce_sum(n_kv, self._mesh, "data")
        return z_out, ndk_out, n_kv

    def _doc_ll(self, ndks, alpha) -> torch.Tensor:
        """The doc side of the joint LL over every document: summed over
        the data group (a model group's ranks hold the same documents)."""
        s = torch.zeros((), dtype=self._dtype, device=self._device)
        for b, ndk in zip(self._buckets, ndks):
            s = s + _doc_side_ll(ndk, b.mask, alpha)
        return all_reduce_sum(s, self._mesh, "data")

    def _sweep(self, sweep: int):
        """One AD-LDA sweep from the current chains, which it leaves as
        they are: sample against the table frozen at sweep start, rebuild
        it from z (this rank's block), gather the whole table.  Returns
        (z, ndk, the block of n_kv, the whole n_kv)."""
        log_tw = _log_phi_hat(self._n_kv_whole, self.state.eta)
        z, ndk, block = self._sample_buckets(sweep, log_tw, accumulate=True)
        return z, ndk, block, self._whole(block)

    def _joint_ll(self, n_kv, ndks) -> torch.Tensor:
        st = self.state
        return _topic_side_ll(n_kv, st.eta) + self._doc_ll(ndks, st.alpha)

    def _exact_sweep(self, sweep: int) -> torch.Tensor:
        """One AD-LDA sweep, adopted; returns the joint LL (0-d, on the
        device)."""
        self._z, self._ndk, self._n_kv, self._n_kv_whole = self._sweep(sweep)
        return self._joint_ll(self._n_kv_whole, self._ndk)

    def _interval_sweeps(self, n: int) -> List[torch.Tensor]:
        """n sweeps at ``gibbs_rebuild_interval`` R > 1: every sweep
        samples against the carried factor, and the [K, V] table, its
        factor and the topic side of the LL are rebuilt only on every
        R-th sweep of the call and on its last one, so the returned tables
        are exact.

        The LL of a sweep without a rebuild is the JAX engine's, kept for
        parity with its printed values: the latest rebuilt table's topic
        side plus that sweep's fresh doc side.  It mixes a stale topic
        side with a fresh doc side, so it is not the joint LL of any one
        state; only the sweeps with a rebuild report one.  One process
        only (the table is whole)."""
        st = self.state
        R = self._config.gibbs_rebuild_interval
        log_tw = _log_phi_hat(self._n_kv_whole, st.eta)
        ll_topic = _topic_side_ll(self._n_kv_whole, st.eta)
        lls = []
        for i in range(n):
            self._z, self._ndk, _ = self._sample_buckets(
                self._counter + i, log_tw, accumulate=False)
            if (i + 1) % R == 0 or i == n - 1:
                self._set_counts(self._count_all(self._z))
                log_tw = _log_phi_hat(self._n_kv_whole, st.eta)
                ll_topic = _topic_side_ll(self._n_kv_whole, st.eta)
            lls.append(ll_topic + self._doc_ll(self._ndk, st.alpha))
        return lls

    def _advance(self, n: int) -> None:
        st = self.state
        self._state = LDAState(lam=st.lam, alpha=st.alpha, eta=st.eta,
                               step=st.step + n)
        self._step_host += n

    def _hyper_due_now(self) -> bool:
        interval = self._config.hyper_parameter_optimize_interval
        return interval > 0 and self._counter % interval == 0

    # -- training -----------------------------------------------------------------

    def learning(self) -> float:
        """One exact Gibbs sweep over the corpus (also at a rebuild
        interval R > 1, as in the JAX engine); returns joint log p(w, z)."""
        ll = self._exact_sweep(self._counter)
        self._advance(1)
        if self._hyper_due_now():
            cfg = self._config
            self.optimize_hyperparameters(cfg.slice_samples, cfg.slice_step)
            return self.compute_likelihood()
        return float(ll)

    def learning_many(self, n: int) -> List[float]:
        """n sweeps in chunks that end at hyperopt boundaries; each
        chunk's likelihoods stay on the device until its end."""
        cfg = self._config
        interval = cfg.hyper_parameter_optimize_interval
        out: List[float] = []
        remaining = n
        while remaining > 0:
            chunk = remaining
            if interval > 0:
                chunk = min(remaining, interval - self._counter % interval)
            if cfg.gibbs_rebuild_interval > 1 and self._mesh is None:
                lls = self._interval_sweeps(chunk)
            else:
                lls = [self._exact_sweep(self._counter + i)
                       for i in range(chunk)]
            self._advance(chunk)
            vals = torch.stack(lls).cpu().tolist()
            if self._hyper_due_now():
                self.optimize_hyperparameters(cfg.slice_samples,
                                              cfg.slice_step)
                vals[-1] = self.compute_likelihood()
            out.extend(vals)
            remaining -= chunk
        return out

    def compute_likelihood(self, alpha_scalar: Optional[float] = None,
                           beta_scalar: Optional[float] = None) -> float:
        """Griffiths-Steyvers joint log likelihood at the current counts
        (the whole table), optionally at scalar alpha / beta.  Collective
        under a mesh (the doc side's all-reduce)."""
        st = self.state
        alpha = (st.alpha if alpha_scalar is None
                 else torch.full_like(st.alpha, alpha_scalar))
        beta = (st.eta if beta_scalar is None
                else torch.full_like(st.eta, beta_scalar))
        return float(_topic_side_ll(self._n_kv_whole, beta)
                     + self._doc_ll(self._ndk, alpha))

    def optimize_hyperparameters(self, samples: int = 5, step: float = 3.0
                                 ) -> None:
        """Slice sampling on (log alpha, log beta) scalars
        (``ops/hyper.slice_sample``): host-side control loop, likelihoods
        on the device.  Its uniforms come from a numpy generator seeded
        from this engine's stream at the current step, the same on every
        rank, so alpha and beta stay equal across the ranks."""
        st = self.state
        rng = np.random.default_rng(
            stream_seed(self._config.seed, TAG_SLICE, self._counter))
        x0 = np.array([math.log(float(st.alpha.mean())),
                       math.log(float(st.eta.mean()))])
        x = slice_sample(
            lambda x: self.compute_likelihood(math.exp(x[0]), math.exp(x[1])),
            x0, rng, samples, step)
        self._state = LDAState(
            lam=st.lam, alpha=torch.full_like(st.alpha, math.exp(x[0])),
            eta=torch.full_like(st.eta, math.exp(x[1])), step=st.step)

    def phase_timings(self, repeats: int = 3) -> dict:
        """Device times in ms (``utils.timing``, best of ``repeats`` after
        a warm call) of one sweep (``gibbs_sweep_ms``: the factor refresh,
        every bucket's sampling, the n_kv rebuild and, under a shard, its
        gather) and of the joint likelihood at the current tables
        (``joint_likelihood_ms``), the keys of ``pylda_tpu.models.gibbs``;
        under a mesh with a process group also ``allreduce_ms`` (n_kv's
        all-reduce over the data group: this rank's block), and under a
        shard ``allgather_ms`` and ``allgather_bytes`` (the gather of the
        blocks over the model group); every rank must call this.  The
        timed sweep's chains are
        dropped: z, the count tables and the step stay as they were, and
        its streams are seeded afresh from the step, as every sweep's
        are, so the next ``learning()`` draws what it would have."""
        dev = self._device
        sweep_ms, _ = best_ms(lambda: self._sweep(self._counter), dev, repeats)
        ll_ms, _ = best_ms(lambda: self._joint_ll(self._n_kv_whole,
                                                  self._ndk), dev, repeats)
        return {"gibbs_sweep_ms": round(sweep_ms, 6),
                "joint_likelihood_ms": round(ll_ms, 6),
                **self._allreduce_timing(self._n_kv, repeats,
                                         block=self._n_kv)}

    # -- topics / held-out ----------------------------------------------------------

    def topic_word_distribution(self) -> np.ndarray:
        """(n_kv + beta) / (n_k + sum beta) point estimate, float64."""
        n_kv = self._n_kv_whole.cpu().numpy().astype(np.float64)
        beta = self.state.eta.cpu().numpy().astype(np.float64)
        return (n_kv + beta[None, :]) / (
            n_kv.sum(axis=1, keepdims=True) + beta.sum())

    _point_beta = topic_word_distribution

    def inference(self, test_corpus: Corpus) -> Tuple[float, np.ndarray]:
        """Sample test-doc topics against the frozen topic counts
        (``burn_in_sweeps`` + ``number_of_samples`` sweeps from random z),
        then score tokens with the point-estimate predictive p(w|d) =
        sum_k theta_hat phi_hat.  Returns (log likelihood, gamma =
        alpha + mean kept n_dk in corpus order; chunk rows of one long
        document recombine additively).  Replicated under a mesh: each
        rank samples the whole ``test_corpus`` from the same streams
        against the whole table (no collective)."""
        st = self.state
        cfg = self._config
        K = cfg.number_of_topics
        log_tw = _log_phi_hat(self._n_kv_whole, st.eta)
        batches = sequence_batches(test_corpus, cfg, self._device,
                                   self._dtype)
        ll = torch.zeros((), dtype=self._dtype, device=self._device)
        gammas = []
        for i, b in enumerate(batches):
            tag = (cfg.seed, TAG_TEST, self._counter, i)
            z0 = random_assignments(b.tokens.shape, K,
                                    stream(self._device, *tag, 1))
            gamma_b, _ss, _z, _ndk = sample_doc_topics(
                b.tokens, b.token_mask, log_tw, st.alpha, z0,
                stream(self._device, *tag, 2),
                num_types=self._number_of_types,
                burn_in=cfg.burn_in_sweeps, num_samples=cfg.number_of_samples,
                sampler=cfg.resolved_topic_sampler(),
                block_positions=cfg.sampler_block_positions,
            )
            theta_hat = gamma_b / gamma_b.sum(dim=1, keepdim=True)
            ll = ll + sequence_token_score(b.tokens, b.token_mask,
                                           torch.log(theta_hat), log_tw)
            gammas.append(gamma_b)
        gamma = layouts.assemble_gamma(
            [b.doc_ids for b in batches], [g.cpu().numpy() for g in gammas],
            test_corpus.num_docs, st.alpha.cpu().numpy())
        return float(ll), gamma

    @property
    def gamma(self) -> Optional[np.ndarray]:
        """Per-document alpha + n_dk [D, K] in corpus order, from the
        current tables (the VB family's gamma surface, for
        ``--dump_gamma``).  Under a mesh every rank gathers every rank's
        documents: collective."""
        if not self._ndk:
            return None
        alpha = self.state.alpha.cpu().numpy()
        ids, rows = self._gathered_rows(
            [b.doc_ids for b in self._buckets],
            [alpha[None, :] + n.cpu().numpy() for n in self._ndk])
        return layouts.assemble_gamma(ids, rows,
                                      self._corpus.global_num_docs, alpha)

    # -- model files ----------------------------------------------------------------

    def _extra_state(self) -> dict:
        """The one-process blobs: n_kv whole, the chains of every data
        coordinate (gathered over the data group)."""
        d = {"n_kv": self._n_kv_whole.cpu().numpy()}
        zs = gather_chains(self._z, self._mesh)
        ndks = gather_chains(self._ndk, self._mesh)
        for i, (z, ndk) in enumerate(zip(zs, ndks)):
            d[f"z_{i}"] = z
            d[f"ndk_{i}"] = ndk
        return d

    def _load_extra_state(self, blobs: dict) -> None:
        if "n_kv" in blobs:
            self._set_whole_counts(blobs["n_kv"])
            self._restore = blobs  # chains adopted in _prepare
