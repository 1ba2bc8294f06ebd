"""Shared inferencer base.

Counterpart of ``pylda_tpu.models.base``: the reference's ``Inferencer``
surface — ``initialize``, ``learning()``, ``inference()``,
``perplexity()``, ``_counter`` — over a small dataclass of tensors
(``LDAState``) on an explicit device.  Entry points run on the CUDA card
unless the caller passes ``device="cpu"``; without a card and without that
argument they raise.  ``export_beta``, ``save`` and ``load`` wait for the
CLI slice.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple, Union

import numpy as np
import torch

from pylda_tpu_torch.corpus.corpus import Corpus
from pylda_tpu_torch.corpus.vocabulary import Vocabulary
from pylda_tpu_torch.utils.config import LDAConfig


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
