"""Shared inferencer base.

Counterpart of ``pylda_tpu.models.base``: the reference's ``Inferencer``
surface — ``initialize``, ``learning()``, ``inference()``,
``perplexity()``, ``point_estimate_perplexity()``, ``export_beta()``,
``_counter`` — over a small dataclass of tensors (``LDAState``) on an
explicit device, and the ``model-<N>`` files (``save``/``load``, npz, the
same keys as the JAX package's, so each package loads the other's).
Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card and without that argument they raise.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import warnings
from typing import Mapping, Optional, Tuple, Union

import numpy as np
import torch

from pylda_tpu_torch.corpus.corpus import Corpus
from pylda_tpu_torch.corpus.vocabulary import Vocabulary
from pylda_tpu_torch.utils.config import INFERENCE_MODES, LDAConfig
from pylda_tpu_torch.utils.metrics import is_host_zero


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


class Inferencer:
    """Base class for the inference engines."""

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
        moved to this engine's device; the iteration counter follows it."""
        K, V = self._config.number_of_topics, self._number_of_types
        if tuple(state.lam.shape) != (K, V):
            raise ValueError(
                f"state lam has shape {tuple(state.lam.shape)}, want {(K, V)}"
            )
        self._state = LDAState(
            lam=state.lam.to(self._device, self._dtype),
            alpha=state.alpha.to(self._device, self._dtype),
            eta=state.eta.to(self._device, self._dtype),
            step=state.step.to(self._device, torch.int32),
        )
        self._step_host = int(state.step)
        self._state_changed()

    def _state_changed(self) -> None:
        """Hook: engines drop what they derived from the old state."""

    # -- lifecycle ----------------------------------------------------------------

    def initialize(
        self,
        corpus: Corpus,
        vocab: Optional[Vocabulary] = None,
        lam_init: Optional[np.ndarray] = None,
    ) -> None:
        """Build state + device batches (reference's ``_initialize``).

        ``lam_init`` replaces the random lambda init, which is the
        reference's Gamma(100, 0.01) drawn from
        ``numpy.random.default_rng(config.seed)``."""
        cfg = self._config
        self._corpus = corpus
        self._vocab = vocab if vocab is not None else corpus.vocab
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
        lam = torch.as_tensor(lam_np, device=dev).to(dt)
        self._state = LDAState(
            lam=lam, alpha=alpha, eta=eta,
            step=torch.zeros((), dtype=torch.int32, device=dev),
        )
        self._step_host = 0
        self._prepare(corpus)

    # reference-compatible alias
    _initialize = initialize

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

    def perplexity(self, test_corpus: Corpus) -> float:
        """Per-word held-out perplexity under the engine's native
        convention (the VB family scores tokens with E[log beta])."""
        ll, _ = self.inference(test_corpus)
        return float(np.exp(-ll / max(1, test_corpus.num_tokens)))

    def point_estimate_perplexity(self, test_corpus: Corpus) -> float:
        """Convention-neutral held-out perplexity: p(w|d) = theta_hat @
        beta_hat with theta_hat from this engine's inference gamma and
        beta_hat = lambda / sum(lambda), in float64 on the host.  Only the
        observed (doc, type) pairs are scored, in document blocks of
        bounded size."""
        _ll, gamma = self.inference(test_corpus)
        theta = (gamma / gamma.sum(axis=1, keepdims=True)).astype(np.float64)
        lam = self.state.lam.cpu().numpy().astype(np.float64)
        beta = lam / lam.sum(axis=1, keepdims=True)
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

    # -- topics --------------------------------------------------------------------

    def topic_word_distribution(self) -> np.ndarray:
        """Normalised topic-word matrix [K, V]: exp(E[log beta_k]) divided
        by its sum — the reference's exp_beta surface — from lambda in
        float64 on the host."""
        from scipy.special import psi

        lam = self.state.lam.cpu().numpy().astype(np.float64)
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
            "lam": st.lam.cpu().numpy(),
            "alpha": st.alpha.cpu().numpy(),
            "eta": st.eta.cpu().numpy(),
            "step": np.asarray(int(st.step), dtype=np.int32),
            "key": np.asarray([0, self._config.seed], dtype=np.uint32),
            "vocab": np.asarray(self._vocab.types if self._vocab else []),
        }
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
    ) -> "Inferencer":
        """Restore an engine from a ``model-<N>`` npz file written by this
        package or by ``pylda_tpu``, on ``device`` (the CUDA card by
        default).  With ``corpus`` the engine is prepared for continued
        training; otherwise inference and export are available."""
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
        engine.state = LDAState(
            lam=torch.as_tensor(blobs["lam"]),
            alpha=torch.as_tensor(blobs["alpha"]),
            eta=torch.as_tensor(blobs["eta"]),
            step=torch.tensor(int(blobs["step"]), dtype=torch.int32),
        )
        if corpus is not None:
            engine._corpus = corpus
            engine._prepare(corpus)
        return engine
