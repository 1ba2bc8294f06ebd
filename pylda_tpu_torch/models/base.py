"""Shared inferencer base.

Counterpart of ``pylda_tpu.models.base``: the reference's ``Inferencer``
surface — ``initialize``, ``learning()``, ``inference()``,
``perplexity()``, ``point_estimate_perplexity()``, ``export_beta()``,
``_counter`` — over a small dataclass of tensors (``LDAState``) on an
explicit device, and the ``model-<N>`` files (``save``/``load``, npz, the
same keys as the JAX package's, so each package loads the other's).
Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card and without that argument they raise.

Across processes (``initialize(..., mesh=...)``, ``parallel/mesh.py``)
each rank trains on the block of documents of its data coordinate
(``_local_corpus``): a process-local corpus as it is, a corpus loaded
whole cut to the block the process-local loader would give it.  State
stays replicated, except lambda under ``shard_vocab`` / ``shard_topics``
with a model axis above 1 (every engine; Gibbs's count table n_kv too):
then ``state.lam`` is this rank's block (``parallel/lam_shard.py``), the
``state`` setter takes the whole lambda and keeps the block, and
``gathered_lam`` returns the whole one.  With a model axis above 1 and
neither flag, a model group is a set of replicas.  ``save`` and
``export_beta`` write from rank 0 after every rank has called them
(engines gather their per-rank chains and lambda blocks into the file:
the one-process format).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import warnings
from typing import Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pylda_tpu_torch.corpus.corpus import Corpus
from pylda_tpu_torch.corpus.vocabulary import Vocabulary
from pylda_tpu_torch.parallel.lam_shard import LamShard, shard_of
from pylda_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_sum,
    allgather_object,
    block_bounds,
    world,
)
from pylda_tpu_torch.utils.config import INFERENCE_MODES, LDAConfig
from pylda_tpu_torch.utils.metrics import is_host_zero
from pylda_tpu_torch.utils.timing import best_ms


@dataclasses.dataclass
class LDAState:
    """Global model state — the only cross-iteration state."""

    lam: torch.Tensor  # [K, V] word-topic variational Dirichlet
    alpha: torch.Tensor  # [K] doc-topic Dirichlet hyperparameter
    eta: torch.Tensor  # [V] word-topic Dirichlet hyperparameter
    step: torch.Tensor  # 0-d int32 iteration counter


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The device an engine runs on: the CUDA card by default.  Raises
    when no card is present and the caller did not ask for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device


def state_from_numpy(
    arrays: Mapping[str, np.ndarray],
    device: Union[str, torch.device, None] = None,
) -> LDAState:
    """Build an ``LDAState`` from the JAX package's state as numpy arrays
    (the keys ``lam``, ``alpha``, ``eta``, ``step`` that
    ``pylda_tpu``'s ``Inferencer.save`` writes)."""
    dev = resolve_device(device)

    def f32(x):
        return torch.tensor(np.asarray(x, dtype=np.float32), device=dev)

    return LDAState(
        lam=f32(arrays["lam"]),
        alpha=f32(arrays["alpha"]),
        eta=f32(arrays["eta"]),
        step=torch.tensor(int(np.asarray(arrays["step"])), dtype=torch.int32,
                          device=dev),
    )


def bucket_tensors(
    arrays: Sequence[np.ndarray],
    buckets: Sequence,
    dtype: torch.dtype,
    device: torch.device,
    name: str,
    width: Optional[int] = None,
) -> list:
    """Per-bucket numpy arrays (a JAX engine's sampling chains, or a model
    file's ``<name>_<i>`` blobs) as tensors on ``device``: one [rows,
    width] array a bucket, ``width`` the bucket's own row width unless
    given.  Raises ``ValueError`` unless every shape matches."""
    if len(arrays) != len(buckets):
        raise ValueError(f"{len(arrays)} {name} arrays for {len(buckets)} "
                         f"buckets")
    out = []
    for i, (a, b) in enumerate(zip(arrays, buckets)):
        want = (b.rows, width or b.tokens.shape[1])
        a = np.array(a)
        if a.shape != want:
            raise ValueError(f"{name}_{i} has shape {a.shape}, want {want}")
        out.append(torch.as_tensor(a, device=device).to(dtype))
    return out


class Inferencer:
    """Base class for the inference engines."""

    # Whether a step gathers its table's blocks into a contiguous whole
    # (the sampling engines, whose reductions over the table then run in
    # the one-process order) rather than a view (``_allreduce_timing``
    # times the step's form).
    _CONTIGUOUS_GATHER = False

    def __init__(
        self,
        config: LDAConfig,
        device: Union[str, torch.device, None] = None,
    ):
        self._config = config.validate()
        self._device = resolve_device(device)
        self._corpus: Optional[Corpus] = None
        self._vocab: Optional[Vocabulary] = None
        self._state: Optional[LDAState] = None
        self._step_host = 0
        self._dtype = getattr(torch, config.dtype)
        self._mesh: Optional[Mesh] = None
        self._shard: Optional[LamShard] = None

    # -- reference-parity accessors --------------------------------------------

    @property
    def _counter(self) -> int:
        """Host-side mirror of state.step (reading the device scalar would
        synchronise)."""
        return self._step_host

    @property
    def _number_of_types(self) -> int:
        return 0 if self._vocab is None else len(self._vocab)

    @property
    def config(self) -> LDAConfig:
        return self._config

    @property
    def state(self) -> LDAState:
        if self._state is None:
            raise RuntimeError("call initialize() first")
        return self._state

    @state.setter
    def state(self, state: LDAState) -> None:
        """Adopt a state (e.g. ``state_from_numpy`` of a JAX engine's),
        moved to this engine's device; the iteration counter follows it.
        ``state.lam`` is the whole [K, V] lambda; under a lambda shard
        this rank keeps its block."""
        K, V = self._config.number_of_topics, self._number_of_types
        if tuple(state.lam.shape) != (K, V):
            raise ValueError(
                f"state lam has shape {tuple(state.lam.shape)}, want {(K, V)}"
            )
        lam = state.lam if self._shard is None else self._shard.take(state.lam)
        self._state = LDAState(
            lam=lam.to(self._device, self._dtype).contiguous(),
            alpha=state.alpha.to(self._device, self._dtype),
            eta=state.eta.to(self._device, self._dtype),
            step=state.step.to(self._device, torch.int32),
        )
        self._step_host = int(state.step)
        self._state_changed()

    def _state_changed(self) -> None:
        """Hook: engines drop what they derived from the old state."""

    def gathered_lam(self) -> torch.Tensor:
        """The whole [K, V] lambda: ``state.lam``, or under a lambda shard
        the model group's blocks gathered (collective over it)."""
        lam = self.state.lam
        return lam if self._shard is None else self._shard.gather(lam)

    # -- lifecycle ----------------------------------------------------------------

    def initialize(
        self,
        corpus: Corpus,
        vocab: Optional[Vocabulary] = None,
        lam_init: Optional[np.ndarray] = None,
        mesh: Optional[Mesh] = None,
    ) -> None:
        """Build state + device batches (reference's ``_initialize``).

        ``lam_init`` replaces the random lambda init, which is the
        reference's Gamma(100, 0.01) drawn from
        ``numpy.random.default_rng(config.seed)``.  ``mesh``
        (``parallel.mesh.make_mesh``) splits the documents over its data
        axis and, under ``shard_vocab`` / ``shard_topics``, lambda over
        its model axis: each rank keeps its block of the whole [K, V]
        init, so a sharded run starts from the one-process run's bits.
        Every rank must pass the same ``lam_init`` and config."""
        cfg = self._config
        self._corpus = corpus
        self._vocab = vocab if vocab is not None else corpus.vocab
        self._set_mesh(mesh)
        K = cfg.number_of_topics
        V = len(self._vocab)
        dev, dt = self._device, self._dtype
        alpha = torch.full((K,), cfg.resolved_alpha(), dtype=dt, device=dev)
        eta = torch.full((V,), cfg.resolved_eta(V), dtype=dt, device=dev)
        if lam_init is not None:
            lam_np = np.asarray(lam_init)
            if lam_np.shape != (K, V):
                raise ValueError(
                    f"lam_init has shape {lam_np.shape}, want {(K, V)}"
                )
        else:
            lam_np = np.random.default_rng(cfg.seed).gamma(100.0, 0.01, (K, V))
        if self._shard is not None:
            lam_np = self._shard.take(lam_np)
        lam = torch.as_tensor(np.ascontiguousarray(lam_np), device=dev).to(dt)
        self._state = LDAState(
            lam=lam, alpha=alpha, eta=eta,
            step=torch.zeros((), dtype=torch.int32, device=dev),
        )
        self._step_host = 0
        self._prepare(corpus)

    # reference-compatible alias
    _initialize = initialize

    def _set_mesh(self, mesh: Optional[Mesh]) -> None:
        """Adopt ``mesh`` and this rank's lambda block (``_shard``; the
        vocabulary must be set)."""
        cfg = self._config
        if mesh is not None and cfg.doc_pad_multiple % mesh.data:
            raise ValueError(
                "doc_pad_multiple must be divisible by the data-axis size")
        self._mesh = mesh
        self._shard = shard_of(cfg.shard_vocab, cfg.shard_topics, mesh,
                               cfg.number_of_topics, self._number_of_types)

    def _block_ranges(self, sharded: bool = True) -> dict:
        """``topic_range`` / ``vocab_range`` of this rank's block of a
        [K, V] table under a lambda shard (and ``sharded``); {} for the
        whole table."""
        if sharded and self._shard is not None:
            return self._shard.ranges
        return {}

    @property
    def _split(self) -> bool:
        """True when the documents are split over more than one rank."""
        return self._mesh is not None and self._mesh.data > 1

    def _local_corpus(self, corpus: Corpus):
        """The documents this rank trains on: the corpus itself in one
        process, a process-local corpus's block as it is, and for a corpus
        loaded whole the block ``[lo, hi)`` of ``ceil(D / P)`` documents
        the process-local loader would give its data coordinate (every
        rank of a model group the same block; ``process_local``,
        ``global_num_docs`` and ``global_doc_offset`` set).  Raises the JAX
        engine's ``ValueError`` for a process-local corpus across
        processes without a mesh."""
        local = getattr(corpus, "process_local", False)
        if not self._split:
            if local and world()[1] > 1:
                raise ValueError(
                    "a process-sharded corpus requires a mesh (--mesh); "
                    "each host holds only its doc block, so training "
                    "without the global sharding would silently diverge"
                )
            return corpus
        if local:
            return corpus
        lo, hi = block_bounds(corpus.num_docs, self._mesh.data_index,
                              self._mesh.data)
        block = corpus.subset(range(lo, hi))
        block.process_local = True
        block.global_num_docs = corpus.num_docs
        block.global_doc_offset = lo
        return block

    def _prepare(self, corpus: Corpus) -> None:
        """Engine-specific device batch construction."""
        raise NotImplementedError

    def learning(self) -> float:
        """One training iteration; returns the training objective."""
        raise NotImplementedError

    def learning_many(self, n: int):
        """n training iterations; returns the per-iteration objectives."""
        return [self.learning() for _ in range(n)]

    def inference(self, test_corpus: Corpus) -> Tuple[float, np.ndarray]:
        """Held-out evaluation with global state frozen; returns
        (log likelihood bound, per-doc gamma [D_test, K])."""
        raise NotImplementedError

    def phase_timings(self, repeats: int = 3) -> dict:
        """Per-phase device times in ms (engines that time their phases
        override this); the ``--phase_timing`` and roofline hook."""
        return {}

    def _gathered_rows(self, doc_ids: list, rows: list) -> Tuple[list, list]:
        """Per-batch (doc ids, rows) of every data coordinate, in order,
        when the documents are split over the data axis (collective over
        the data group: the ranks of a model group hold the same rows);
        as given otherwise."""
        if not self._split:
            return doc_ids, rows
        parts = allgather_object((doc_ids, rows), self._mesh, "data")
        return ([i for p in parts for i in p[0]],
                [r for p in parts for r in p[1]])

    def _allreduce_timing(self, tensor: torch.Tensor, repeats: int,
                          block: Optional[torch.Tensor] = None) -> dict:
        """``allreduce_ms`` (``utils.timing``: one all-reduce over the data
        group of a copy of ``tensor``, the step's largest, best of
        ``repeats``), ``allreduce_bytes`` and ``allreduce_backend`` under a
        mesh with a process group, and under a lambda shard
        ``allgather_ms`` and ``allgather_bytes`` (the step's gather over
        the model group of ``block``, by default this rank's block of
        lambda: the VB family gathers expElogbeta's, hybrid lambda's,
        Gibbs n_kv's; the bytes each rank receives); {} otherwise.
        Collective: every rank times."""
        mesh = self._mesh
        if mesh is None or not mesh.grouped:
            return {}
        buf = tensor.detach().clone().contiguous()
        ms, _ = best_ms(lambda: all_reduce_sum(buf, mesh, "data"),
                        self._device, repeats)
        out = {"allreduce_ms": round(ms, 6),
               "allreduce_bytes": buf.numel() * buf.element_size(),
               "allreduce_backend": mesh.backend}
        if self._shard is not None:
            block = (self.state.lam if block is None else block
                     ).detach().clone()
            ms, full = best_ms(lambda: self._shard.gather(
                block, self._CONTIGUOUS_GATHER), self._device, repeats)
            out.update(allgather_ms=round(ms, 6), allgather_bytes=(
                full.numel() - block.numel()) * block.element_size())
        return out

    def perplexity(self, test_corpus: Corpus) -> float:
        """Per-word held-out perplexity under the engine's native
        convention (the VB family scores tokens with E[log beta])."""
        ll, _ = self.inference(test_corpus)
        return float(np.exp(-ll / max(1, test_corpus.num_tokens)))

    def point_estimate_perplexity(self, test_corpus: Corpus) -> float:
        """Convention-neutral held-out perplexity: p(w|d) = theta_hat @
        beta_hat with theta_hat from this engine's inference gamma and
        beta_hat the engine's topic-word point estimate (``_point_beta``:
        lambda / sum(lambda), or Gibbs's (n_kv + beta) / (n_k + sum beta)),
        in float64 on the host (under a lambda shard every rank calls it:
        the point estimate gathers lambda).  Only the observed (doc, type)
        pairs are scored, in document blocks of bounded size."""
        _ll, gamma = self.inference(test_corpus)
        theta = (gamma / gamma.sum(axis=1, keepdims=True)).astype(np.float64)
        beta = self._point_beta()
        K = beta.shape[0]
        entries_budget = max(1, int(256e6 / (8 * K)))
        tot_ll = 0.0
        tot_n = 0
        d = 0
        D = test_corpus.num_docs
        while d < D:
            ids_l, cnts_l, rows_l = [], [], []
            entries = 0
            while d < D and (entries == 0 or entries < entries_budget):
                ids, cnts = test_corpus.doc_unique(d)
                ids_l.append(ids)
                cnts_l.append(cnts)
                rows_l.append(np.full((ids.size,), d, dtype=np.int64))
                entries += ids.size
                d += 1
            if not entries:
                continue
            all_ids = np.concatenate(ids_l)
            all_cnts = np.concatenate(cnts_l).astype(np.float64)
            rows = np.concatenate(rows_l)
            p = np.einsum("ek,ek->e", theta[rows], beta[:, all_ids].T)
            tot_ll += float((all_cnts * np.log(p + 1e-30)).sum())
            tot_n += int(all_cnts.sum())
        return float(np.exp(-tot_ll / max(1, tot_n)))

    def _point_beta(self) -> np.ndarray:
        """Topic-word point estimate [K, V] in float64: lambda / sum(lambda)
        for the VB family."""
        lam = self.gathered_lam().cpu().numpy().astype(np.float64)
        return lam / lam.sum(axis=1, keepdims=True)

    # -- topics --------------------------------------------------------------------

    def topic_word_distribution(self) -> np.ndarray:
        """Normalised topic-word matrix [K, V]: exp(E[log beta_k]) divided
        by its sum — the reference's exp_beta surface — from lambda in
        float64 on the host (the whole lambda: collective under a lambda
        shard)."""
        from scipy.special import psi

        lam = self.gathered_lam().cpu().numpy().astype(np.float64)
        elog = psi(lam) - psi(lam.sum(axis=1, keepdims=True))
        elog -= elog.max(axis=1, keepdims=True)  # stable exp-normalise
        e = np.exp(elog)
        return e / e.sum(axis=1, keepdims=True)

    def export_beta(self, path: str, top_k: int = 50) -> None:
        """Write the reference's exp_beta format: per topic a
        ``==========\\t<k>\\t==========`` header, then the top ``top_k``
        types by descending p(w|k), one ``type\\tprob`` per line (the same
        bytes as the JAX package for the same lambda)."""
        beta = self.topic_word_distribution()
        if not is_host_zero():
            return
        if self._vocab is None:
            raise RuntimeError("export_beta needs a vocabulary")
        with open(path, "w", encoding="utf-8") as f:
            for k in range(beta.shape[0]):
                f.write(f"==========\t{k}\t==========\n")
                order = np.argsort(-beta[k])[:top_k]
                for v in order:
                    f.write(f"{self._vocab[int(v)]}\t{beta[k, v]:.10g}\n")

    # -- model files ----------------------------------------------------------------

    def _extra_state(self) -> dict:
        """Engine-specific arrays a ``model-<N>`` file carries (saved as
        ``extra_<name>``, the JAX package's keys)."""
        return {}

    def _load_extra_state(self, blobs: dict) -> None:
        """Adopt what ``_extra_state`` saved (names without ``extra_``)."""

    def save(
        self,
        path: str,
        format: Optional[str] = None,
        async_write: bool = False,
    ) -> None:
        """Write a ``model-<N>`` file: one npz with the keys of the JAX
        package (``lam``, ``alpha``, ``eta``, ``step``, ``key``, ``vocab``,
        ``meta_json`` holding ``config``, ``engine`` and
        ``format_version``), published atomically (tmp + rename).  ``key``
        is ``[0, seed]`` as uint32 — the shape of a JAX PRNG key, so
        ``pylda_tpu`` loads the file; this package ignores it on load.

        ``format`` defaults to ``config.checkpoint_format``; "orbax" is
        JAX-only and raises.  ``async_write`` moves the file write to a
        background thread (the device-to-host copy stays on the caller);
        a later ``save`` or ``wait_for_checkpoint`` joins it."""
        self.wait_for_checkpoint()  # at most one in-flight write
        fmt = format or self._config.checkpoint_format
        if fmt != "npz":
            raise NotImplementedError(
                f"checkpoint format {fmt!r} is JAX-only (orbax/tensorstore); "
                "this package writes npz (ROADMAP.md Queue 1 item 6)"
            )
        st = self.state
        blobs = {
            "lam": self.gathered_lam().cpu().numpy(),
            "alpha": st.alpha.cpu().numpy(),
            "eta": st.eta.cpu().numpy(),
            "step": np.asarray(int(st.step), dtype=np.int32),
            "key": np.asarray([0, self._config.seed], dtype=np.uint32),
            "vocab": np.asarray(self._vocab.types if self._vocab else []),
        }
        blobs.update({f"extra_{k}": np.asarray(v)
                      for k, v in self._extra_state().items()})
        meta = {
            "config": {
                k: (list(v) if isinstance(v, tuple) else v)
                for k, v in vars(self._config).items()
            },
            "engine": type(self).__name__,
            "format_version": 1,
        }
        blobs["meta_json"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8
        )
        if not is_host_zero():
            return
        path = os.path.abspath(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)

        def _write():
            # A torn model-<N> must never be visible: resume picks the
            # latest snapshot.
            tmp = f"{path}.tmp.{os.getpid()}"
            try:
                with open(tmp, "wb") as f:
                    np.savez(f, **blobs)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)

        if async_write:
            self._ckpt_thread = threading.Thread(target=_write, daemon=True)
            self._ckpt_thread.start()
        else:
            _write()

    def wait_for_checkpoint(self) -> None:
        """Join an in-flight async ``save`` (no-op otherwise)."""
        t = getattr(self, "_ckpt_thread", None)
        if t is not None:
            t.join()
            self._ckpt_thread = None

    @staticmethod
    def load(
        path: str,
        corpus: Optional[Corpus] = None,
        device: Union[str, torch.device, None] = None,
        mesh: Optional[Mesh] = None,
    ) -> "Inferencer":
        """Restore an engine from a ``model-<N>`` npz file written by this
        package or by ``pylda_tpu``, on ``device`` (the CUDA card by
        default).  With ``mesh`` the engine takes its place in it (a
        lambda shard keeps this rank's block of the file's whole lambda:
        elastic, the saving run's mesh does not matter, and a JAX model
        file resumes sharded); with ``corpus`` it is prepared for
        continued training, its documents split over the mesh's data
        axis; otherwise inference and export are available."""
        from pylda_tpu_torch import models as _models

        if os.path.isdir(path):
            raise NotImplementedError(
                f"{path!r} is an orbax checkpoint directory; orbax is "
                "JAX-only (ROADMAP.md Queue 1 item 6)"
            )
        with open(path, "rb") as f:
            blobs = dict(np.load(f, allow_pickle=False))
        meta = json.loads(bytes(blobs.pop("meta_json").tobytes()).decode())
        cfg_d = meta["config"]
        cfg_d["bucket_sizes"] = tuple(cfg_d.get("bucket_sizes") or ())
        if cfg_d.get("mesh_shape"):
            cfg_d["mesh_shape"] = tuple(cfg_d["mesh_shape"])
        known = {f.name for f in dataclasses.fields(LDAConfig)}
        unknown = sorted(set(cfg_d) - known)
        if unknown:
            warnings.warn(
                f"checkpoint config has fields this build does not know "
                f"{unknown}; ignoring them",
                stacklevel=2,
            )
            cfg_d = {k: v for k, v in cfg_d.items() if k in known}
        # Any other mode means a file written by a newer version.
        mode = cfg_d.get("inference_mode", "vb")
        if mode not in INFERENCE_MODES:
            raise ValueError(
                f"checkpoint {path!r} has inference_mode {mode!r}, unknown "
                "to this build; it may have been saved by a newer version"
            )
        try:
            config = LDAConfig(**cfg_d).validate()
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"checkpoint {path!r} has an invalid config: {e}"
            ) from e
        engine = _models.make_engine(config, device=device)
        engine._vocab = Vocabulary(
            str(t) for t in blobs.pop("vocab").tolist()
        )
        if mesh is not None:
            engine._set_mesh(mesh)
        engine.state = LDAState(
            lam=torch.as_tensor(blobs["lam"]),
            alpha=torch.as_tensor(blobs["alpha"]),
            eta=torch.as_tensor(blobs["eta"]),
            step=torch.tensor(int(blobs["step"]), dtype=torch.int32),
        )
        engine._load_extra_state({k[len("extra_"):]: v
                                  for k, v in blobs.items()
                                  if k.startswith("extra_")})
        if corpus is not None:
            engine._corpus = corpus
            engine._prepare(corpus)
        return engine
