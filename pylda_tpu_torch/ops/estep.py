"""Batched variational E-step: the plain PyTorch versions.

Counterparts of ``pylda_tpu.ops.estep``.  These are the in-package
references of the three CUDA kernels (``ops/ragged.py``,
``ops/sstats.py``, ``ops/dense_estep.py``): the kernel wrappers call them
for CPU tensors, the tests hold them against the JAX functions, and
``chip_smoke.py`` holds each kernel against them on the card.
``estep_ragged`` (the scatter route) is the exception: its fixed point is
the ragged kernel's wrapper, and its sufficient statistics
(``scatter_sstats``) are plain PyTorch on every device, as the JAX
function's are XLA.

Only the "dtk" layout ([D, T, K], topics last) is ported: the JAX
package's "kdt" layout, bf16 factor storage in float32 mode and
token-axis blocking (``_factor_layout``, ``_b_storage_dtype``,
``_pick_t_block``) are lowering choices for XLA on a TPU.  All
contractions run in the input dtype (float32, or float64 in the tests).

``compute_dtype="bfloat16"`` is the JAX functions' bf16 operand mode: each
contraction's inputs are rounded to bf16 (round to nearest even) and the
sums stay in the input dtype.  Each function rounds at exactly the
reference's three points and nowhere else — the gathered or dense
expElogbeta, expEtheta as it enters phinorm (and, in the sufficient
statistics, the sum), and the ratio counts / phinorm — while phinorm,
gamma' = alpha + expEtheta * (...), the token score and the outer
multiply of the sufficient statistics by expElogbeta keep the unrounded
values.  In float64 the same points give the "bf16 operands, exact sums"
version the kernels' bf16 builds are held against.

Under lambda sharding (``parallel/lam_shard.py``) the sufficient
statistics take a ``topic_range`` (k0, k1): rows k0..k1-1 only, as a
[k1 - k0, V] result, with phinorm and the token score over all K; and
the scatter and the dense E-step a ``vocab_range`` (v0, v1): columns
v0..v1-1 only, as [K, v1 - v0], and the token score of those columns'
counts only (a partial sum over the model group).  The fixed point always
reads the whole expElogbeta.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

COMPUTE_DTYPES = ("float32", "bfloat16")
# Slots a part of a word's run in the scatter's two-level sum
# (``sum_by_word``): at a config-4 minibatch on an H100 parts of 64 sum in
# 0.83 ms, of 32 in 0.95 ms, and one segment a word takes 5.81 ms
# (scripts/torch_scatter_sum_order.py).
SUM_RUN = 64
# The profiler range ``estep_ragged`` runs its scatter in (its expEtheta
# and ``scatter_sstats``): the device time of the scatter in a profile.
SCATTER_RANGE = "estep_ragged.scatter"

from pylda_tpu_torch.ops.dirichlet import (
    exp_dirichlet_expectation,
    exp_dirichlet_expectation_fast,
    theta_elbo_per_doc,
)


def check_compute_dtype(compute_dtype: str) -> bool:
    """True for the bf16 operand mode; raises on an unknown mode."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                         f"got {compute_dtype!r}")
    return compute_dtype == "bfloat16"


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (round to nearest even), kept in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def _rounder(compute_dtype: str):
    """The rounding of a contraction's operands: bf16_round in bf16 mode,
    else none."""
    return bf16_round if check_compute_dtype(compute_dtype) else (lambda x: x)


def _exit_update(change, best, age, done, threshold, use_stall, patience):
    """Per-row exit bookkeeping of the gamma fixed point.

    Returns (best, age, done, exitable):

    - ``done`` (sticky) marks rows whose best mean|dgamma| has fallen to
      the threshold — the reference's per-document break.  Done rows
      FREEZE their gamma in the caller, so each row's output does not
      depend on when the other rows exit.
    - ``exitable`` additionally includes rows that are currently stalled:
      no 1% improvement of their best change for ``patience`` consecutive
      sweeps.  Stalling is NOT sticky and does NOT freeze: a stalled row
      keeps updating while other rows hold the loop open.  The loop exits
      when every row is exitable.

    ``threshold == 0`` disables freezing (run to the cap)."""
    improved = change < 0.99 * best
    age_new = torch.where(improved, torch.zeros_like(age), age + 1)
    best_new = torch.minimum(best, change)
    done_new = done
    if threshold > 0.0:
        done_new = done_new | (best_new <= threshold)
    exitable = done_new
    if use_stall:
        exitable = exitable | (age_new >= patience)
    return best_new, age_new, done_new, exitable


def _fixed_point(sweep, gamma_init, inner_iterations, convergence_threshold,
                 stall_patience):
    """The batched gamma fixed point shared by both layouts; returns
    (sweeps_used, gamma).  ``sweep(exp_etheta)`` is one sweep's proposal
    alpha + expEtheta * (...).  The loop tests the exit on the host once
    per sweep — this is the reference version; the CUDA kernels keep the
    whole loop on the card."""
    use_stall = stall_patience > 0 and convergence_threshold > 0.0
    freeze = convergence_threshold > 0.0
    rows = gamma_init.shape[0]
    gamma = gamma_init
    # Exact expectation at the init; the loop uses the fast form.
    exp_etheta = exp_dirichlet_expectation(gamma_init)
    best = torch.full((rows,), float("inf"), dtype=gamma_init.dtype,
                      device=gamma_init.device)
    age = torch.zeros((rows,), dtype=torch.int32, device=gamma_init.device)
    done = torch.zeros((rows,), dtype=torch.bool, device=gamma_init.device)
    i = 0
    while i < inner_iterations:
        gamma_prop = sweep(exp_etheta)
        gamma_new = (
            torch.where(done[:, None], gamma, gamma_prop)
            if freeze else gamma_prop
        )
        change = (gamma_new - gamma).abs().mean(dim=-1)
        best, age, done, exitable = _exit_update(
            change, best, age, done, convergence_threshold, use_stall,
            stall_patience,
        )
        i += 1
        gamma = gamma_new
        exp_etheta = exp_dirichlet_expectation_fast(gamma_new)
        if bool(exitable.all()):
            break
    return i, gamma


def _ragged_sweep_loop(
    ids, cnts, gamma_init, exp_elog_beta, alpha,
    inner_iterations, convergence_threshold, eps, stall_patience=0,
    compute_dtype="float32",
):
    """Ragged fixed point over one (ids, cnts) block: the block
    B = expElogbeta.T[ids] ([D, T, K]) is gathered once; each sweep is two
    batched contractions against it.  bf16 mode rounds B, expEtheta as it
    enters phinorm, and the ratio."""
    rnd = _rounder(compute_dtype)
    B = rnd(exp_elog_beta.T[ids])  # [D, T, K]

    def sweep(exp_etheta):
        phinorm = torch.einsum("dk,dtk->dt", rnd(exp_etheta), B) + eps
        return alpha[None, :] + exp_etheta * torch.einsum(
            "dt,dtk->dk", rnd(cnts / phinorm), B
        )

    return _fixed_point(sweep, gamma_init, inner_iterations,
                        convergence_threshold, stall_patience)


def estep_dense(
    counts: torch.Tensor,  # [D, Vc] float or bf16 (0 pads), Vc >= V
    gamma_init: torch.Tensor,  # [D, K]
    exp_elog_beta: torch.Tensor,  # [K, V]
    alpha: torch.Tensor,  # [K]
    inner_iterations: int = 50,
    convergence_threshold: float = 1e-5,
    eps: float = 1e-30,
    stall_patience: int = 0,
    compute_dtype: str = "float32",
    topic_range: Optional[Tuple[int, int]] = None,
    vocab_range: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense doc-term E-step — ``pylda_tpu``'s ``estep_dense`` in the input
    dtype (bf16 mode: expElogbeta, expEtheta in phinorm and the ratio
    rounded).  Each sweep is two products against expElogbeta:

        phinorm = expEtheta @ expElogbeta + eps            # [D, Vc]
        gamma'  = alpha + expEtheta * ((counts / phinorm) @ expElogbeta^T)

    with the exit rule of ``_exit_update``; then sufficient statistics
    and the token score at the EXACT expectation of the converged gamma
    (``estep_dense_sstats``).  ``counts`` may arrive vocab-prepadded and
    in bf16, as for ``estep_dense_sstats``.  Returns (gamma, sstats,
    token_score, sweeps_used) with sweeps_used a 0-d int32 tensor; the
    final pass takes ``topic_range`` or ``vocab_range`` (module
    docstring)."""
    # Padding columns are all-zero counts: leave them out of the sweeps.
    c = counts[:, : exp_elog_beta.shape[1]].to(gamma_init.dtype)
    rnd = _rounder(compute_dtype)
    eeb_c = rnd(exp_elog_beta)

    def sweep(exp_etheta):
        phinorm = rnd(exp_etheta) @ eeb_c + eps
        return alpha[None, :] + exp_etheta * (
            rnd(c / phinorm) @ eeb_c.T
        )

    i, gamma = _fixed_point(sweep, gamma_init, inner_iterations,
                            convergence_threshold, stall_patience)
    c_own, eeb_own = vocab_block(counts, exp_elog_beta, vocab_range)
    sstats, token_score = estep_dense_sstats(
        c_own, exp_dirichlet_expectation(gamma), eeb_own, eps,
        compute_dtype=compute_dtype, topic_range=topic_range,
    )
    return (gamma, sstats, token_score,
            torch.tensor(i, dtype=torch.int32, device=gamma.device))


def estep_ragged_gamma(
    ids: torch.Tensor,  # [D, T] int32 (0 on padded slots)
    cnts: torch.Tensor,  # [D, T] float (0 on padded slots)
    gamma_init: torch.Tensor,  # [D, K]
    exp_elog_beta: torch.Tensor,  # [K, V]
    alpha: torch.Tensor,  # [K]
    inner_iterations: int = 50,
    convergence_threshold: float = 1e-5,
    eps: float = 1e-30,
    stall_patience: int = 0,
    compute_dtype: str = "float32",
    segments: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ragged fixed point only — returns (gamma, sweeps_used) with
    sweeps_used a 0-d int32 tensor, as ``pylda_tpu``'s
    ``estep_ragged_gamma``.  Sufficient statistics come separately from
    ``estep_dense_sstats``.  Exit rule: ``_exit_update``.

    ``segments`` (row counts summing to D) makes the rows consecutive
    batches, each run as its own call (its own exit sweep): the layout of
    the card's whole-bucket launches.  sweeps_used is then
    [len(segments)] int32, each segment's."""
    if segments is not None:
        if sum(segments) != ids.shape[0] or min(segments, default=0) < 1:
            raise ValueError(f"segments {list(segments)} do not split "
                             f"{ids.shape[0]} rows")
        runs, r0 = [], 0
        for n in segments:
            runs.append(estep_ragged_gamma(
                ids[r0:r0 + n], cnts[r0:r0 + n], gamma_init[r0:r0 + n],
                exp_elog_beta, alpha, inner_iterations,
                convergence_threshold, eps, stall_patience, compute_dtype))
            r0 += n
        return (torch.cat([g for g, _ in runs]),
                torch.stack([s for _, s in runs]))
    i, gamma = _ragged_sweep_loop(
        ids, cnts, gamma_init, exp_elog_beta, alpha,
        inner_iterations, convergence_threshold, eps,
        stall_patience=stall_patience, compute_dtype=compute_dtype,
    )
    return gamma, torch.tensor(i, dtype=torch.int32, device=gamma.device)


def vocab_block(counts: torch.Tensor, exp_elog_beta: torch.Tensor,
                vocab_range: Optional[Tuple[int, int]]):
    """(counts, expElogbeta) of the final pass over columns
    ``vocab_range`` (all of them for None)."""
    if vocab_range is None:
        return counts, exp_elog_beta
    v0, v1 = vocab_range
    return (counts[:, v0:v1].contiguous(),
            exp_elog_beta[:, v0:v1].contiguous())


def estep_dense_sstats(
    counts: torch.Tensor,  # [D, Vc] float or bf16 (0 pads), Vc >= V
    exp_etheta: torch.Tensor,  # [D, K] exp E[log theta] at converged gamma
    exp_elog_beta: torch.Tensor,  # [K, V]
    eps: float = 1e-30,
    compute_dtype: str = "float32",
    topic_range: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter-free sufficient statistics + token score from dense counts:

        phinorm = expEtheta @ expElogbeta + eps          # [D, Vc]
        sstats  = expElogbeta * (expEtheta^T @ (counts / phinorm))[:, :V]
        score   = sum(counts * log(phinorm))

    ``counts`` may arrive vocab-prepadded (Vc > V, zero columns) and in
    bf16 (exact for integer counts <= 256): it is upcast to the compute
    dtype.  Padding columns see expElogbeta = 0 and are sliced away;
    all-zero rows contribute nothing.  bf16 mode rounds expEtheta (in
    both products), expElogbeta in phinorm and the ratio; phinorm, the
    score and the outer multiply by expElogbeta stay unrounded.  A
    ``topic_range`` (k0, k1) gives rows k0..k1-1 of sstats only (the
    second product over those topics of expEtheta), phinorm and the score
    as for all K."""
    dt = exp_etheta.dtype
    V = exp_elog_beta.shape[1]
    Vc = counts.shape[1]
    c = counts.to(dt)
    rnd = _rounder(compute_dtype)
    eeb_w = (
        torch.nn.functional.pad(exp_elog_beta, (0, Vc - V)) if Vc > V
        else exp_elog_beta
    )
    et_c = rnd(exp_etheta)
    phinorm = et_c @ rnd(eeb_w) + eps  # [D, Vc]
    ratio = c / phinorm
    if topic_range is None:
        sstats = exp_elog_beta * (et_c.T @ rnd(ratio))[:, :V]
    else:
        k0, k1 = topic_range
        sstats = (exp_elog_beta[k0:k1]
                  * (et_c[:, k0:k1].T @ rnd(ratio))[:, :V])
    token_score = (c * torch.log(phinorm)).sum()
    return sstats, token_score


def scatter_sstats(
    ids: torch.Tensor,  # [D, T] int32 (0 on padded slots)
    cnts: torch.Tensor,  # [D, T] float (0 on padded slots)
    exp_etheta: torch.Tensor,  # [D, K] exp E[log theta] at converged gamma
    exp_elog_beta: torch.Tensor,  # [K, V]
    eeb_t: torch.Tensor,  # gather_table(exp_elog_beta, compute_dtype)
    eps: float = 1e-30,
    compute_dtype: str = "float32",
    topic_range: Optional[Tuple[int, int]] = None,
    vocab_range: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sufficient statistics + token score of one ragged block by the row
    scatter — what ``pylda_tpu``'s ``estep_ragged`` does after its loop:

        phinorm[d, t] = expEtheta[d] . expElogbeta[:, ids[d, t]] + eps
        A[v]          = sum over slots (d, t) with ids = v of
                        expEtheta[d] * cnts[d, t] / phinorm[d, t]
        sstats        = expElogbeta * A^T           # [K, V]
        score         = sum cnts * log(phinorm)

    bf16 mode rounds expEtheta and the gathered expElogbeta in phinorm
    only; the products and sums stay in the input dtype.  The rows of
    expElogbeta^T are gathered from ``eeb_t``, the ragged kernel's table
    (``ops.row_fixed_point.gather_table``: its bf16 table holds the
    rounded values).  Padding slots (count 0) add exactly 0 to A[0].

    The sum is the same on every call: the flattened ids are sorted
    stably (slot order within a word) and ``sum_by_word`` sums each
    word's run in a fixed order with ``torch.segment_reduce`` — no
    atomics.

    A ``topic_range`` (k0, k1) scatters topics k0..k1-1 only ([k1 - k0,
    V]); a ``vocab_range`` (v0, v1) the slots of words v0..v1-1 only
    ([K, v1 - v0]; the others get the word past the last and sort after
    every kept slot, where the sum leaves them out), and the token score
    of those slots only.  A kept word's run is then the whole call's run,
    so its sum is the whole call's bits."""
    D, T = ids.shape
    K, V = exp_elog_beta.shape
    rnd = _rounder(compute_dtype)
    flat = ids.reshape(-1).long()
    B = eeb_t.index_select(0, flat)[:, :K].to(exp_etheta.dtype)
    phinorm = torch.einsum("dtk,dk->dt", B.reshape(D, T, K),
                           rnd(exp_etheta)) + eps
    del B
    ratio = cnts.to(exp_etheta.dtype) / phinorm
    eeb, et, W = exp_elog_beta, exp_etheta, V
    if vocab_range is not None:
        v0, v1 = vocab_range
        own = (flat >= v0) & (flat < v1)
        W = v1 - v0
        flat = torch.where(own, flat - v0, W)
        cnts = torch.where(own.reshape(D, T), cnts, 0)
        eeb = exp_elog_beta[:, v0:v1]
    if topic_range is not None:
        k0, k1 = topic_range
        eeb, et = exp_elog_beta[k0:k1], exp_etheta[:, k0:k1]
    token_score = (cnts.to(phinorm.dtype) * torch.log(phinorm)).sum()
    words, perm = torch.sort(flat, stable=True)
    U = (et.index_select(0, torch.div(perm, T, rounding_mode="floor"))
         * ratio.reshape(-1)[perm][:, None])
    return eeb * sum_by_word(words, U, W).T, token_score


def sum_by_word(words: torch.Tensor, U: torch.Tensor, V: int,
                run: int = SUM_RUN) -> torch.Tensor:
    """A [V, K]: the rows of U [N, K] summed by word, for ``words`` [N]
    sorted (int64), in one fixed order on every device.  Slots of word V
    (past the last) sort last and are left out.

    ``torch.segment_reduce`` sums each segment in sequence, and a frequent
    word's slots run to thousands, a chain of dependent adds.  So the sum
    takes two levels: each word's run is cut into parts of at most
    ``run`` slots, summed in slot order, and then each word's parts are
    summed in order.  Every shape is fixed by (N, V, run): the number of
    parts is bounded by V + ceil(N / run), the parts past the last are
    empty, and nothing waits on the device."""
    N = words.numel()
    dev = words.device
    v = torch.arange(V + 1, dtype=words.dtype, device=dev)
    offsets = torch.searchsorted(words, v)  # [V + 1] start of each run
    parts = torch.div(offsets[1:] - offsets[:-1] + run - 1, run,
                      rounding_mode="floor")
    base = torch.zeros(V + 1, dtype=words.dtype, device=dev)
    torch.cumsum(parts, 0, out=base[1:])  # [V + 1] first part of each word
    s = torch.arange(V + -(-N // run) + 1, dtype=words.dtype, device=dev)
    # Part s belongs to the last word whose first part is <= s (words
    # with no slots have no part); past the last part, to V.
    owner = torch.searchsorted(base, s, right=True) - 1
    starts = torch.clamp(offsets[owner] + (s - base[owner]) * run, max=N)
    partial = torch.segment_reduce(U, "sum", offsets=starts, axis=0,
                                   unsafe=True)
    return torch.segment_reduce(partial, "sum", offsets=base, axis=0,
                                unsafe=True)


def estep_ragged(
    ids: torch.Tensor,  # [D, T] int32 (0 on padded slots)
    cnts: torch.Tensor,  # [D, T] float (0 on padded slots)
    gamma_init: torch.Tensor,  # [D, K]
    exp_elog_beta: torch.Tensor,  # [K, V]
    alpha: torch.Tensor,  # [K]
    inner_iterations: int = 50,
    convergence_threshold: float = 1e-5,
    eps: float = 1e-30,
    stall_patience: int = 0,
    compute_dtype: str = "float32",
    eeb_t: Optional[torch.Tensor] = None,
    topic_range: Optional[Tuple[int, int]] = None,
    vocab_range: Optional[Tuple[int, int]] = None,
    segments: Optional[Sequence[int]] = None,
    seg_rows: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ragged (ids, counts) E-step with scatter sufficient statistics —
    ``pylda_tpu``'s ``estep_ragged``.  Returns (gamma, sstats [K, V],
    token_score, sweeps_used 0-d int32, or [len(segments)] with
    ``segments``, as ``estep_ragged_gamma``; ``seg_rows`` as
    ``ops.ragged.ragged_gamma``'s).

    Its loop is the loop of ``estep_ragged_gamma`` (the JAX function's
    trajectory is the same at pinned sweeps), so it runs
    ``ops.ragged.ragged_gamma``: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Then ``scatter_sstats`` at the EXACT
    expectation of the converged gamma, gathering from one table
    ``eeb_t`` (``gather_table(exp_elog_beta, compute_dtype)``, built here
    when not passed), over ``topic_range`` or ``vocab_range`` when given.
    The scatter runs in the profiler range ``SCATTER_RANGE``."""
    # ops.ragged imports this module for its plain version.
    from pylda_tpu_torch.ops.ragged import gather_table, ragged_gamma

    if eeb_t is None:
        eeb_t = gather_table(exp_elog_beta, compute_dtype)
    gamma, sweeps = ragged_gamma(
        ids, cnts, gamma_init, exp_elog_beta, alpha,
        inner_iterations=inner_iterations,
        convergence_threshold=convergence_threshold, eps=eps,
        stall_patience=stall_patience, eeb_t=eeb_t,
        compute_dtype=compute_dtype, segments=segments, seg_rows=seg_rows,
    )
    with torch.profiler.record_function(SCATTER_RANGE):
        sstats, token_score = scatter_sstats(
            ids, cnts, exp_dirichlet_expectation(gamma), exp_elog_beta,
            eeb_t, eps, compute_dtype=compute_dtype,
            topic_range=topic_range, vocab_range=vocab_range,
        )
    return gamma, sstats, token_score, sweeps


def ragged_doc_bound(
    ids: torch.Tensor,  # [D, T] int32 (0 on padded slots)
    cnts: torch.Tensor,  # [D, T] float (0 on padded slots)
    gamma: torch.Tensor,  # [D, K]
    exp_elog_beta: torch.Tensor,  # [K, V]
    alpha: torch.Tensor,  # [K]
    eps: float = 1e-30,
) -> torch.Tensor:
    """Each row's share of the bound at its gamma, [D]: its token score
    sum_t cnt_t log(expEtheta . expElogbeta[:, id_t] + eps) at the exact
    expectation, plus its theta terms.  At a fixed point the bound is
    stationary in gamma, so two gammas that differ by rounding give
    shares that agree to second order: the check on rows whose gamma
    depends on rounding."""
    dt = gamma.dtype
    et = exp_dirichlet_expectation(gamma)
    phinorm = torch.einsum("dtk,dk->dt", exp_elog_beta.T.to(dt)[ids.long()],
                           et) + eps
    score = (cnts.to(dt) * torch.log(phinorm)).sum(-1)
    return score + theta_elbo_per_doc(gamma, alpha.to(dt))
