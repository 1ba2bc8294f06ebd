"""Roofline bounds of the engines' phases on one NVIDIA H100.

Counterpart of ``pylda_tpu.utils.roofline``: an analytic count of the
operations and HBM bytes each phase of a training iteration needs, held
against the card's peaks, and a report that sets the engines' measured
``phase_timings`` beside those bounds.  A bound is the least time the card
could take: the larger of operations over the peak rate of their kind and
bytes over the memory rate, each input read once and each output written
once.  ``utilisation`` = bound / measured, clipped at 1 as in the JAX
package; a ratio above 1 means the model counts work the code does not do.

The peaks are one H100 SXM's at its 700 W limit (NVIDIA's data sheet,
dense rates): 67 TFLOP/s float32 on the CUDA cores, which run the port's
kernels in both operand modes (the bf16 builds convert their operands and
multiply in float32), 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s
HBM3.  The fixed points are priced at the float32 rate in both modes;
the dense sufficient statistics at the rate of their mode, as
``chip_smoke.py``'s kernel lines price them (in bf16 a looser bound).
The transcendental rates were measured on the card by
``scripts/torch_transcendental_rate.py`` over a [1000, 100000] float32
block (torch.lgamma 2.441e11, log 2.450e11 elements a second; NVIDIA H100
80GB HBM3 at 700.00 W) and are rounded up: a rate set too high only
loosens the bound.

Where the port's code does the work the JAX model counts, the counts are
the JAX model's, operation for operation and byte for byte: the ragged
fixed point (4 K FLOP and 8 bytes a slot, padding slots included), the
E[log beta] refresh (3 K V float32 words), the natural-gradient step, the
n_kv rebuild, the factor refresh and the transcendental phases.  Three
counts differ, because the port's kernels do different work:

- the dense-layout fixed point: the row-resident gamma kernel compacts
  each row's nonzero counts and sweeps those only (4 K FLOP a nonzero a
  sweep), reading the counts block once a call; the JAX model counts the
  [D, V] block's 4 D V K FLOP and 2 D V words a sweep, its matmul form;
- the dense sufficient statistics (``dense_sstats``): phinorm and the
  ratio are needed only at nonzero counts and never leave the kernel, so
  4 K FLOP a nonzero and the counts, expEtheta rows, expEbeta, sstats and
  the score once (``chip_smoke.py``'s formula); the JAX model counts
  4 rows V K FLOP and, on its XLA path, phinorm's round trips;
- the sampled local step (sequence layout): the port's cdf sampler takes
  an inclusive ``cumsum`` (K FLOP a slot), where the JAX sampler runs a
  [K, K] prefix-sum matmul (2 K^2).

The counts hold for every K: above 4096 the gamma cluster kernel reads a
streamed slot's B row once a sweep and the sstats cluster kernel's direct
plan reads expElogbeta twice, but the bound counts what the function needs,
not what a kernel re-reads.

Sweep counts are the engines' own (``last_sweeps``); a phase's bound
prices each batch's fixed point at the sweeps that batch ran.  The JAX
report reads only the batch-VB family; this one also reports SVI (one
minibatch step) and collapsed Gibbs (a sweep, and the joint likelihood).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ChipPeaks:
    """Peak rates of one NVIDIA H100 SXM at its 700 W power limit."""

    f32_flops: float = 67e12  # CUDA cores, float32 FMA
    bf16_flops: float = 989e12  # tensor cores, bf16 products, f32 sums
    hbm_bytes: float = 3.35e12
    # Measured by scripts/torch_transcendental_rate.py, rounded up.
    lgamma_per_sec: float = 2.5e11
    log_per_sec: float = 2.5e11

    def flops(self, compute_dtype: str) -> float:
        return self.bf16_flops if compute_dtype == "bfloat16" else self.f32_flops


H100 = ChipPeaks()


def bound_ms(flops: float, nbytes: float, compute_dtype: str = "float32",
             peaks: ChipPeaks = H100) -> Tuple[float, str]:
    """(the least ms for ``flops`` operations of ``compute_dtype``'s kind
    and ``nbytes`` of HBM traffic, "operations" or "bytes": the larger)."""
    t_ops = flops / peaks.flops(compute_dtype)
    t_bytes = nbytes / peaks.hbm_bytes
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _row(flops: float, nbytes: float, peak: float,
         peaks: ChipPeaks) -> dict:
    t_ops, t_bytes = flops / peak, nbytes / peaks.hbm_bytes
    return {"flops": flops, "hbm_bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound": "operations" if t_ops >= t_bytes else "bytes"}


def _nnz(counts: torch.Tensor) -> int:
    return int((counts != 0).sum())


def sstats_cost(counts: torch.Tensor, num_topics: int, num_types: int
                ) -> Tuple[float, float]:
    """(FLOP, bytes) of ``dense_sstats`` on one counts chunk [rows, V_pad]:
    4 K FLOP a nonzero count; the chunk, its rows' expEtheta, expEbeta
    read, sstats written and the score, once each."""
    rows = counts.shape[0]
    K, V = num_topics, num_types
    return (4.0 * K * _nnz(counts),
            counts.numel() * counts.element_size() + rows * K * 4
            + 2 * K * V * 4 + 4)


# -- one sweep of one batch ----------------------------------------------------------


def _sweep_cost(b, cfg) -> Tuple[float, float]:
    """(FLOP a sweep, bytes a call) of one batch's local step: the ragged
    fixed point (4 K FLOP and 8 bytes a slot), the dense fixed point (4 K
    FLOP a nonzero; the counts block once) or the sampled step (6 K FLOP a
    slot, plus K for the cdf sampler's cumsum; 8 bytes a slot)."""
    K = cfg.number_of_topics
    if hasattr(b, "ids"):
        slots = b.ids.shape[0] * b.ids.shape[1]
        return 4.0 * slots * K, slots * 8.0
    if hasattr(b, "tokens"):
        slots = b.tokens.shape[0] * b.tokens.shape[1]
        per = 6 + (1 if cfg.resolved_topic_sampler() == "cdf" else 0)
        return float(per * slots * K), slots * 8.0
    return (4.0 * K * _nnz(b.counts),
            float(b.counts.numel() * b.counts.element_size()))


def _batch_sweep_bound_ms(b, cfg, peaks: ChipPeaks = H100,
                          sweeps: float = 1.0) -> float:
    """The least ms of ``sweeps`` sweeps of one batch: its operations at
    the float32 rate (the kernels' FMAs are float32 in both operand
    modes), its bytes once."""
    flops, nbytes = _sweep_cost(b, cfg)
    return max(flops * sweeps / peaks.f32_flops,
               nbytes / peaks.hbm_bytes) * 1e3


def rebuild_bound_ms(slots: int, K: int, V: int,
                     peaks: ChipPeaks = H100) -> float:
    """One [K, V] count-table rebuild from per-slot assignments: each
    slot's (word, topic) read once, the table written once."""
    return (slots * 8 + K * V * 4) / peaks.hbm_bytes * 1e3


# -- the batches and sstats chunks a phase runs ----------------------------------------


def _timed_batches(engine) -> list:
    """The batches of the engine's timed E-step: the corpus's (batch VB,
    hybrid), or the minibatch SVI's ``phase_timings`` runs."""
    if engine.config.inference_mode == "svi":
        return engine.timing_minibatch()[0]
    return engine._batches


def _sstats_chunks(engine) -> list:
    """The dense counts chunks of the timed E-step's sufficient
    statistics: the corpus plan's (batch VB), the timed minibatch's
    gathered rows (SVI with a counts matrix), or the dense batches
    themselves (the dense layout, whose final pass computes them); empty
    on the scatter route and the sequence layout."""
    if engine.config.inference_mode == "svi":
        batches, sel, *_ = engine.timing_minibatch()
        if engine._mb_sstats is not None:
            return [c for c, _ in engine._local_plan(batches, sel[1])[1].chunks]
    else:
        batches = engine._batches
        if getattr(engine, "_sstats_plan", None) is not None:
            return [c for c, _ in engine._sstats_plan.chunks]
    return [b.counts for b in batches if hasattr(b, "counts")]


def estep_cost_model(engine, peaks: ChipPeaks = H100) -> Dict[str, dict]:
    """FLOP, HBM bytes and the bound of each phase of one E-step of a
    prepared VB-family engine (SVI: of one minibatch):

    - ``sweeps_per_sweep``: one sweep of every batch's local step;
    - ``sstats``: the dense sufficient statistics, where they run;
    - ``elog_beta``: E[log beta] and its exp from lambda (3 K V words).
    """
    cfg = engine.config
    K, V = cfg.number_of_topics, len(engine._vocab or ())
    cdt = cfg.compute_dtype
    out: Dict[str, dict] = {}
    batches = _timed_batches(engine) or []
    flops = nbytes = 0.0
    for b in batches:
        f, n = _sweep_cost(b, cfg)
        flops, nbytes = flops + f, nbytes + n
    if batches:
        out["sweeps_per_sweep"] = _row(flops, nbytes, peaks.f32_flops, peaks)
    chunks = _sstats_chunks(engine)
    if chunks:
        flops = nbytes = 0.0
        for c in chunks:
            f, n = sstats_cost(c, K, V)
            flops, nbytes = flops + f, nbytes + n
        out["sstats"] = _row(flops, nbytes, peaks.flops(cdt), peaks)
        out["sstats"]["docs"] = sum(c.shape[0] for c in chunks)
    if V and K:
        out["elog_beta"] = _row(0.0, 3.0 * K * V * 4, peaks.f32_flops, peaks)
    return out


def utilisation(measured_ms: float, bound_ms: float) -> float:
    """Fraction of the roofline achieved (1.0 = speed of light)."""
    return 0.0 if measured_ms <= 0 else min(1.0, bound_ms / measured_ms)


def _segments(b) -> Optional[Tuple[int, ...]]:
    """Rows of each segment of a whole-bucket launch (its chunks, in the
    order its sweep counts come); None for a batch of one count."""
    return getattr(b, "segments", None)


def measured_sweep_counts(engine) -> List[float]:
    """Sweeps each batch (each segment of a whole-bucket launch) of the
    engine's timed E-step ran, from the engine's own runs
    (``last_sweeps``: the last iteration, minibatch or
    ``phase_timings``); only when those are not the timed batches' does
    this run ``phase_timings`` once to get them.  The sequence layout
    (hybrid) runs a fixed burn_in + num_samples sweeps."""
    cfg = engine.config
    batches = _timed_batches(engine)
    if any(hasattr(b, "tokens") for b in batches):
        return [float(cfg.burn_in_sweeps + cfg.number_of_samples)
                for _ in batches]
    if len(engine.last_sweeps) != sum(len(_segments(b) or (0,))
                                      for b in batches):
        engine.phase_timings(repeats=1)
    return [float(s) for s in engine.last_sweeps]


def _sweeps_bound_ms(engine, batches, sweeps, peaks: ChipPeaks) -> float:
    """Each batch's fixed point at the sweeps it ran.  A whole-bucket
    launch's operations add up its segments' shares of the rows, each at
    its own count, against the launch's bytes once."""
    cfg = engine.config
    total, it = 0.0, iter(sweeps)
    for b in batches:
        segs = _segments(b)
        if segs is None:
            total += _batch_sweep_bound_ms(b, cfg, peaks, next(it))
            continue
        flops, nbytes = _sweep_cost(b, cfg)
        ops = sum(flops * rows / b.rows * next(it) for rows in segs)
        total += max(ops / peaks.f32_flops, nbytes / peaks.hbm_bytes) * 1e3
    return total


def gibbs_learning_phase_bounds(eng, peaks: ChipPeaks = H100
                                ) -> Dict[str, float]:
    """Bounds (ms) of the phases of one ``MonteCarlo.learning()`` sweep:
    ``sampling`` (every bucket's sampled step), ``rebuild`` (n_kv from
    z), ``factor_refresh`` (log phi_hat: [K, V] read and written, or a
    log an element) and ``joint_ll`` (lgamma over the [K, V] table and
    the [rows, K] document tables)."""
    cfg = eng.config
    K, V = cfg.number_of_topics, len(eng._vocab)
    slots = sum(b.tokens.shape[0] * b.tokens.shape[1] for b in eng._buckets)
    rows = sum(b.tokens.shape[0] for b in eng._buckets)
    return {
        "sampling": sum(_batch_sweep_bound_ms(b, cfg, peaks)
                        for b in eng._buckets),
        "rebuild": rebuild_bound_ms(slots, K, V, peaks),
        "factor_refresh": max(2 * K * V * 4 / peaks.hbm_bytes * 1e3,
                              K * V / peaks.log_per_sec * 1e3),
        "joint_ll": (K * V + rows * K) / peaks.lgamma_per_sec * 1e3,
    }


def _minibatch_phase_bounds(eng, batches, peaks: ChipPeaks
                            ) -> Dict[str, float]:
    """Bounds (ms) of one SVI minibatch step beyond its fixed points: the
    sufficient statistics (``dense_sstats`` on the gathered rows or the
    dense batches; on the scatter route each slot read once, 2 K FLOP a
    slot and the [K, V] partial written), the natural-gradient lambda
    step (lambda and sstats read, lambda written) and the E[log beta]
    refresh (lambda read, the factor written)."""
    cfg = eng.config
    K, V = cfg.number_of_topics, len(eng._vocab)
    out: Dict[str, float] = {}
    chunks = _sstats_chunks(eng)
    if chunks:
        out["sstats"] = sum(bound_ms(*sstats_cost(c, K, V), cfg.compute_dtype,
                                     peaks)[0] for c in chunks)
    else:
        slots = sum(b.ids.shape[0] * b.ids.shape[1] for b in batches)
        out["sstats"] = max(2 * slots * K / peaks.f32_flops,
                            (slots * 8 + K * V * 4) / peaks.hbm_bytes) * 1e3
    out["natural_gradient"] = 3 * K * V * 4 / peaks.hbm_bytes * 1e3
    out["elog_beta"] = 2 * K * V * 4 / peaks.hbm_bytes * 1e3
    return out


def svi_epoch_phase_bounds(eng, peaks: ChipPeaks = H100) -> Dict[str, float]:
    """Bounds (ms) of one SVI epoch beyond its fixed points: each phase of
    ``_minibatch_phase_bounds`` at the timed minibatch, times the epoch's
    minibatches (the device-resident geometry gives every minibatch the
    same shapes), and the topic-side bound term once (lgamma over
    [K, V])."""
    cfg = eng.config
    K, V = cfg.number_of_topics, len(eng._vocab)
    batches, _sel, _rho, _scale, n_mb = eng.timing_minibatch()
    out = {k: n_mb * v
           for k, v in _minibatch_phase_bounds(eng, batches, peaks).items()}
    out["beta_elbo"] = K * V / peaks.lgamma_per_sec * 1e3
    return out


def pass_bound_ms(engine, peaks: ChipPeaks = H100) -> float:
    """Bound (ms) of one training pass of a batch-VB-family engine at its
    current state: each batch's fixed point at the sweeps it ran, plus
    the sstats and E[log beta] phases, and on the sequence layout each
    kept sweep's [K, V] count accumulation."""
    cfg = engine.config
    K, V = cfg.number_of_topics, len(engine._vocab or ())
    total = _sweeps_bound_ms(engine, engine._batches,
                             measured_sweep_counts(engine), peaks)
    for b in engine._batches:
        if hasattr(b, "tokens") and V:
            slots = b.tokens.shape[0] * b.tokens.shape[1]
            total += rebuild_bound_ms(slots, K, V, peaks) * max(
                1, cfg.number_of_samples)
    model = estep_cost_model(engine, peaks)
    for phase in ("sstats", "elog_beta"):
        if phase in model:
            total += model[phase]["bound_ms"]
    return total


def _svi_minibatch_bound_ms(eng, peaks: ChipPeaks) -> float:
    batches = eng.timing_minibatch()[0]
    sweeps = _sweeps_bound_ms(eng, batches, measured_sweep_counts(eng), peaks)
    return sweeps + sum(_minibatch_phase_bounds(eng, batches, peaks).values())


def _svi_epoch_bound_ms(eng, peaks: ChipPeaks = H100) -> float:
    """Bound (ms) of one SVI epoch: the timed minibatch's fixed points at
    the sweeps they ran, times the epoch's minibatches, plus
    ``svi_epoch_phase_bounds``."""
    batches, _sel, _rho, _scale, n_mb = eng.timing_minibatch()
    sweeps = _sweeps_bound_ms(eng, batches, measured_sweep_counts(eng), peaks)
    return n_mb * sweeps + sum(svi_epoch_phase_bounds(eng, peaks).values())


def suite_mfu(eng, measured_seconds: float) -> float:
    """Roofline utilisation of one measured training unit (a pass for
    vb and hybrid, a sweep for gibbs, an epoch for svi)."""
    mode = eng.config.inference_mode
    if mode == "svi":
        bound = _svi_epoch_bound_ms(eng)
    elif mode == "gibbs":
        bound = sum(gibbs_learning_phase_bounds(eng).values())
    else:
        bound = pass_bound_ms(eng)
    return round(utilisation(measured_seconds * 1e3, bound), 6)


def allreduce_row(engine, timings: dict, kind: str = "allreduce") -> dict:
    """The step's all-reduce (``phase_timings``' ``allreduce_ms``), or
    with ``kind`` "allgather" its gather over the model group under a
    lambda shard (expElogbeta's blocks for the VB family, lambda's for
    hybrid, n_kv's for Gibbs; ``allgather_ms``, ``allgather_bytes``:
    what a rank receives), beside its bound where one holds: NCCL over a
    group of one card, where the collective need only read its bytes
    once, over the memory rate (the all-reduce runs over the data group,
    the gather over the model group).  Across ranks, or over gloo (staged
    through the host), the time is printed with "no bound"."""
    ms, nbytes = timings[f"{kind}_ms"], timings[f"{kind}_bytes"]
    backend = timings["allreduce_backend"]
    row = {"measured_ms": round(ms, 6), "bytes": nbytes, "backend": backend}
    mesh = engine._mesh
    ranks = mesh.data if kind == "allreduce" else mesh.model
    if backend == "nccl" and ranks == 1:
        bound = nbytes / H100.hbm_bytes * 1e3
        row.update(bound_ms=round(bound, 6),
                   utilisation=round(utilisation(ms, bound), 4))
    else:
        row.update(bound_ms=None, bound="no bound")
    return row


def roofline_report(engine, repeats: int = 3,
                    timings: Optional[dict] = None) -> dict:
    """Measured phase times (``engine.phase_timings(repeats)``, or
    ``timings`` when the caller already took them) beside their bounds:
    rows of {measured_ms, bound_ms, utilisation}.

    - batch VB and hybrid: ``sweeps`` (the fixed points alone, on the
      dense sstats plan), ``estep_full`` (sweeps + sstats) and
      ``iteration`` (E-step + M-step against ``pass_bound_ms``), and
      ``sweep_counts``;
    - SVI: ``minibatch`` (one minibatch step) and ``sweep_counts``;
    - Gibbs: ``sweep`` (sampling, rebuild, factor refresh) and
      ``joint_likelihood``;
    - under a mesh with a process group, also ``allreduce``
      (``allreduce_row``), and under a lambda shard ``allgather``."""
    if timings is None:
        timings = engine.phase_timings(repeats=repeats)
    rows: dict = {}

    def row(name, measured, bound):
        rows[name] = {"measured_ms": round(measured, 6),
                      "bound_ms": round(bound, 6),
                      "utilisation": round(utilisation(measured, bound), 4)}

    for kind in ("allreduce", "allgather"):
        if f"{kind}_ms" in timings:
            rows[kind] = allreduce_row(engine, timings, kind)
    mode = engine.config.inference_mode
    if mode == "gibbs":
        ph = gibbs_learning_phase_bounds(engine)
        row("sweep", timings["gibbs_sweep_ms"],
            ph["sampling"] + ph["rebuild"] + ph["factor_refresh"])
        row("joint_likelihood", timings["joint_likelihood_ms"], ph["joint_ll"])
        return rows
    sweeps = measured_sweep_counts(engine)
    if mode == "svi":
        row("minibatch", timings["svi_minibatch_ms"],
            _svi_minibatch_bound_ms(engine, H100))
        rows["sweep_counts"] = sweeps
        return rows
    sweep_bound = _sweeps_bound_ms(engine, engine._batches, sweeps, H100)
    model = estep_cost_model(engine)
    if "estep_sweeps_only_ms" in timings:
        row("sweeps", timings["estep_sweeps_only_ms"], sweep_bound)
    if "estep_hybrid_full_ms" in timings and "sstats" in model:
        row("estep_full", timings["estep_hybrid_full_ms"],
            sweep_bound + model["sstats"]["bound_ms"])
    if "estep_total_ms" in timings:
        row("iteration",
            timings["estep_total_ms"] + timings.get("mstep_ms", 0.0),
            pass_bound_ms(engine))
    rows["sweep_counts"] = sweeps
    return rows
