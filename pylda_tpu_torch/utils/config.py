"""Configuration for the PyTorch LDA engines.

The same dataclass as ``pylda_tpu.utils.config.LDAConfig``: the same field
names, defaults and ``validate()``, so a config dict saved by either
package loads in the other.  Fields that only steer the JAX package's TPU
lowering (``use_pallas``, ``sstats_kernel``, ``mesh_shape``,
``checkpoint_format``, ...) are kept and validated for that reason.  In
this package the device of the tensors chooses between a CUDA kernel and
its plain PyTorch version: ``use_pallas`` and ``sstats_kernel`` never route
a CUDA tensor away from a kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class LDAConfig:
    """All knobs for corpus layout, inference engine and training loop.

    The reference's flag names (``number_of_topics``, ``alpha_alpha``,
    ``alpha_beta``, ``training_iterations``, ``snapshot_interval``,
    ``inference_mode``, ``hyper_parameter_optimize_interval``) are kept
    verbatim.
    """

    # ----- model (reference flags) -----
    number_of_topics: int = 10
    # None or a negative value means the default: 1/K for alpha, 1/V for eta.
    alpha_alpha: Optional[float] = None
    alpha_beta: Optional[float] = None

    # ----- training loop (reference flags) -----
    training_iterations: int = 50
    snapshot_interval: int = 10
    # 0 or negative disables the Newton alpha/eta updates.
    hyper_parameter_optimize_interval: int = 0

    # "vb" | "gibbs" | "hybrid" | "svi".
    inference_mode: str = "vb"

    # ----- E-step fixed point -----
    # Sweep cap and the per-row mean|dgamma| threshold of the batched
    # gamma fixed point (ops/estep._exit_update has the exit rule).
    inner_iterations: int = 50
    convergence_threshold: float = 1e-5
    # Per-document gamma initialisation: "ones" (deterministic cold start),
    # "gamma" (Gamma(100, 0.01) draw) or "normal" (N(1, 0.1) surrogate).
    gamma_init: str = "ones"

    # ----- sampling engines -----
    number_of_samples: int = 10
    burn_in_sweeps: int = 5
    # Categorical draw of the sampling engines: "auto" | "cdf" | "gumbel"
    # | "race".
    topic_sampler: str = "auto"

    def resolved_topic_sampler(self) -> str:
        """Concrete sampler for topic_sampler="auto": inverse-CDF up to
        the crossover K*(B) = 680 + 170/B, log-domain gumbel above it
        (the JAX package's rule, kept so both packages agree)."""
        if self.topic_sampler != "auto":
            return self.topic_sampler
        k_star = 680.0 + 170.0 / max(1, self.sampler_block_positions)
        return "cdf" if self.number_of_topics <= k_star else "gumbel"

    # Positions sampled per within-document step (Gibbs/hybrid).
    sampler_block_positions: int = 8
    # Gibbs only: rebuild the topic-word count table every R sweeps.
    gibbs_rebuild_interval: int = 1
    # Hybrid only: carry topic assignments across training iterations.
    hybrid_persistent_z: bool = False

    # ----- Wallach slice sampler (Gibbs hyperopt) -----
    slice_samples: int = 5
    slice_step: float = 3.0

    # ----- SVI -----
    batch_size: int = 256
    tau0: float = 64.0
    kappa: float = 0.7

    # ----- data layout -----
    # Up to this vocabulary size the corpus is a dense doc-term matrix;
    # above it, length-bucketed padded (ids, counts) rows.
    dense_vocab_threshold: int = 4096
    # Token-axis bucket boundaries for the ragged layout.
    bucket_sizes: Tuple[int, ...] = (64, 128, 256, 512, 1024, 2048)
    # "auto": plan a slot-minimising geometry from the corpus's
    # unique-type histogram (models/layouts.plan_bucket_sizes) whenever
    # bucket_sizes is left at its default; "fixed": use bucket_sizes.
    bucket_policy: str = "auto"
    # Pad the document axis of every bucket to a multiple of this.
    doc_pad_multiple: int = 64
    # Sufficient statistics of the ragged layout: "auto"/"dense" compute
    # them against a corpus-static dense counts matrix, "scatter" inside
    # each bucket.
    sstats_mode: str = "auto"
    # Per-chunk budget (MB of f32) for the dense sstats counts matrix.
    sstats_dense_budget_mb: int = 512
    # Consecutive sweeps without a 1% improvement of a row's best change
    # after which the row counts as stalled (exitable but not frozen);
    # 0 disables.
    estep_stall_patience: int = 6
    # Rows per ragged chunk are capped so the [rows, T, K] work arrays
    # stay under this.
    estep_memory_budget_mb: int = 512
    # Total budget for the corpus-static dense counts matrix.
    sstats_dense_total_budget_mb: int = 4096
    # SVI device-resident minibatch rows budget.
    svi_device_rows_budget_mb: int = 2048

    # JAX package only: "auto" | "xla" | "pallas" backend of the dense
    # sufficient statistics.
    sstats_kernel: str = "auto"

    def resolved_sstats_kernel(self, backend: str) -> str:
        """The JAX package's rule ("pallas" off the CPU), kept for config
        compatibility; this package picks by tensor device instead."""
        if self.sstats_kernel != "auto":
            return self.sstats_kernel
        return "xla" if backend == "cpu" else "pallas"

    # JAX package only: "never" | "always" route dense-batch E-steps
    # through its Pallas kernels.
    use_pallas: str = "never"

    # ----- numerics -----
    dtype: str = "float32"
    # "bfloat16" rounds the E-step contraction inputs to bf16.
    compute_dtype: str = "float32"
    # Floor added to phi normalisers before division/log.
    eps: float = 1e-30

    # ----- parallelism -----
    mesh_shape: Optional[Tuple[int, int]] = None
    shard_vocab: bool = False
    shard_topics: bool = False

    # ----- checkpointing -----
    checkpoint_format: str = "npz"

    # ----- misc -----
    seed: int = 0

    def resolved_alpha(self) -> float:
        a = self.alpha_alpha
        if a is None or a <= 0:
            return 1.0 / self.number_of_topics
        return float(a)

    def resolved_eta(self, num_types: int) -> float:
        b = self.alpha_beta
        if b is None or b <= 0:
            return 1.0 / num_types
        return float(b)

    def validate(self) -> "LDAConfig":
        if self.number_of_topics <= 0:
            raise ValueError("number_of_topics must be positive")
        if self.inference_mode not in ("vb", "gibbs", "hybrid", "svi"):
            raise ValueError(f"unknown inference_mode: {self.inference_mode}")
        if self.inner_iterations <= 0:
            raise ValueError("inner_iterations must be positive")
        if not 0.5 < self.kappa <= 1.0:
            raise ValueError("kappa must be in (0.5, 1] for SVI convergence")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype: {self.compute_dtype}")
        if self.gamma_init not in ("gamma", "normal", "ones"):
            raise ValueError(f"unknown gamma_init: {self.gamma_init}")
        if self.checkpoint_format not in ("npz", "orbax"):
            raise ValueError(
                f"unknown checkpoint_format: {self.checkpoint_format}"
            )
        if self.use_pallas not in ("never", "always"):
            raise ValueError(f"unknown use_pallas: {self.use_pallas}")
        if self.sstats_mode not in ("auto", "scatter", "dense"):
            raise ValueError(f"unknown sstats_mode: {self.sstats_mode}")
        if self.sstats_kernel not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown sstats_kernel: {self.sstats_kernel}")
        if self.topic_sampler not in ("auto", "cdf", "gumbel", "race"):
            raise ValueError(f"unknown topic_sampler: {self.topic_sampler}")
        if self.sampler_block_positions < 1:
            raise ValueError("sampler_block_positions must be >= 1")
        if self.gibbs_rebuild_interval < 1:
            raise ValueError("gibbs_rebuild_interval must be >= 1")
        if self.estep_stall_patience < 0:
            raise ValueError("estep_stall_patience must be >= 0")
        if self.bucket_policy not in ("auto", "fixed"):
            raise ValueError(f"unknown bucket_policy: {self.bucket_policy}")
        if not self.bucket_sizes or any(b <= 0 for b in self.bucket_sizes):
            raise ValueError("bucket_sizes must be positive and non-empty")
        if self.shard_vocab and self.shard_topics:
            raise ValueError("shard_vocab and shard_topics are exclusive")
        return self
