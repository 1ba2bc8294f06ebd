"""Batched within-document Gibbs sampling (PyTorch).

Counterpart of ``pylda_tpu.ops.sampling``.  The topic-word factor is
frozen for a whole call (hybrid: exp E[log beta] from lambda; Gibbs: the
count-table point estimate frozen at sweep start, the AD-LDA scheme of
Newman et al. 2009), and every document sweeps its own tokens: a Python
loop over blocks of ``block_positions`` token positions, with all
documents of a bucket advancing together and drawing one batched
categorical a position.  Within a document the loop is exact sequential
Gibbs at B = 1 (the doc-topic counts n_dk are updated position by
position) and leave-block-out at B > 1.

The sweep takes its randomness as an argument (``sweep_doc_topics``), so
the same noise can be fed to this function and to the JAX package's;
``sample_doc_topics`` draws it from a ``torch.Generator`` on the tensors'
device.  Random streams are seeded from integers (``stream``): the
engines derive each call's seed from (config seed, purpose tag, step,
bucket index), so a resumed run draws what an unbroken one draws.

The counts n_dk and n_kv are float32 holding exact small integers, so
every table here is the same bits whatever order its additions ran in.
This is plain PyTorch on the engine's device: the reference is XLA code,
not a Pallas kernel.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

SAMPLERS = ("cdf", "gumbel", "race")
# Budget of the pre-gathered per-slot factor block [LB, B, D, K]: above it
# each position step gathers its factor rows itself.
PREGATHER_FACTOR_MAX_BYTES = 512 * 1024 * 1024
# Positions of ``sequence_token_score`` are scored in chunks whose
# gathered [D, chunk, K] block stays under this.
SCORE_CHUNK_BYTES = 64 * 1024 * 1024

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_seed(*parts: int) -> int:
    """A 63-bit seed from integers (config seed, purpose tag, step,
    bucket, ...), through a fixed splitmix64 chain."""
    h = 0
    for p in parts:
        h = _splitmix64(h ^ (int(p) & _MASK64))
    return h >> 1


def stream(device, *parts: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded by ``stream_seed(*parts)``.
    The CPU and CUDA generators draw different streams for one seed."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(*parts))
    return g


def count_table(tokens, token_mask, z, num_topics: int, num_types: int,
                topic_range: Optional[Tuple[int, int]] = None,
                vocab_range: Optional[Tuple[int, int]] = None
                ) -> torch.Tensor:
    """[K, V] assignment-count table: entry (k, v) sums the mask over
    token slots with word v assigned topic k.  ``tokens``, ``token_mask``
    and ``z`` are any same-shaped layout of the slots.

    The mask is added into a flat [K*V] table at bin z*V + w, which is
    already the [K, V] result: int64 bins, no temporary and no transpose
    (the JAX package's one-hot branch above its flat-table gate exists
    for its [V*K] temporary and int32 bins).  The values are exact small
    integers, so the table is the same bits as the JAX package's, in
    either of its branches, whatever order the additions run in.

    ``topic_range`` (k0, k1) and ``vocab_range`` (v0, v1) count only the
    block [k0:k1, v0:v1] (a rank's block of a split table): slots outside
    it add 0 to the block's first bin.  The block is the whole table's
    entries bit for bit, and the full ranges give today's table."""
    K, V = num_topics, num_types
    k0, k1 = topic_range or (0, K)
    v0, v1 = vocab_range or (0, V)
    m = token_mask.reshape(-1)
    zf, wf = z.reshape(-1).long(), tokens.reshape(-1).long()
    if (k0, k1, v0, v1) != (0, K, 0, V):
        keep = (zf >= k0) & (zf < k1) & (wf >= v0) & (wf < v1)
        m = torch.where(keep, m, torch.zeros((), dtype=m.dtype,
                                             device=m.device))
        zf = torch.where(keep, zf - k0, 0)
        wf = torch.where(keep, wf - v0, 0)
    Vb = v1 - v0
    flat = torch.zeros((k1 - k0) * Vb, dtype=m.dtype, device=m.device)
    flat.index_add_(0, zf * Vb + wf, m)
    return flat.view(k1 - k0, Vb)


def random_assignments(shape, num_topics: int, generator: torch.Generator
                       ) -> torch.Tensor:
    """Uniform-random initial z, int32, on the generator's device."""
    return torch.randint(0, num_topics, tuple(shape), generator=generator,
                         device=generator.device, dtype=torch.int32)


def sweep_blocks(length: int, block_positions: int) -> Tuple[int, int]:
    """(B, LB): positions a step and steps a sweep for rows of
    ``length`` slots (the last block padded with inert slots)."""
    B = max(1, min(int(block_positions), length))
    return B, -(-length // B)


def noise_shape(sampler: str, num_docs: int, length: int, num_topics: int,
                block_positions: int) -> Tuple[int, ...]:
    """Shape of one sweep's noise: [LB, B, D] uniforms for cdf, [LB, B, D,
    K] uniforms for race and [LB, B, D, K] Gumbel noise for gumbel — the
    layouts of the JAX package's draws."""
    B, LB = sweep_blocks(length, block_positions)
    if sampler == "cdf":
        return (LB, B, num_docs)
    return (LB, B, num_docs, num_topics)


def draw_noise(sampler: str, shape, generator: torch.Generator,
               dtype=torch.float32) -> torch.Tensor:
    """One sweep's noise from ``generator``.  Uniforms lie in [tiny, 1):
    ``torch.rand`` returns [0, 1), and a 0 would let the cdf sampler pick
    a topic whose probability underflowed to 0 and take the log of 0."""
    u = torch.rand(tuple(shape), generator=generator, device=generator.device,
                   dtype=dtype).clamp_min_(torch.finfo(dtype).tiny)
    if sampler == "gumbel":
        return u.log_().neg_().log_().neg_()
    return u


def sweep_doc_topics(
    tokens: torch.Tensor,  # [D, L] int (0 on padding)
    token_mask: torch.Tensor,  # [D, L] float (0 on padding)
    log_topic_word: torch.Tensor,  # [K, V] log-domain topic-word factor
    alpha: torch.Tensor,  # [K]
    z_init: torch.Tensor,  # [D, L] int initial assignments
    noise: Callable[[int], torch.Tensor],
    num_types: int,
    burn_in: int = 5,
    num_samples: int = 10,
    sampler: str = "cdf",
    block_positions: int = 1,
    accumulate_counts: bool = True,
    topic_range: Optional[Tuple[int, int]] = None,
    vocab_range: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Run ``burn_in + num_samples`` sweeps; average over the kept ones.

    ``noise(s)`` returns sweep s's noise in the shape ``noise_shape``
    gives.  Returns (gamma_bar [D, K], sstats [K, V] or None, z_final
    [D, L] int32, ndk_final [D, K]) with gamma_bar = alpha +
    mean_kept(n_dk) and sstats[k, v] = mean_kept(#{slots w=v, z=k});
    ``accumulate_counts=False`` skips both averages (sstats is None,
    gamma_bar is alpha): Gibbs's rebuild interval counts the table itself.
    Burn-in sweeps skip the [K, V] count.  ``topic_range`` and
    ``vocab_range`` (``count_table``'s) make sstats that block of the
    [K, V] statistics, bit for bit (a rank's block of a split table).

    Samplers (one distribution, three ways to draw it):

    - ``cdf``: inverse CDF in the probability domain, p = (n_dk + alpha)
      * phi[:, w] with phi max-normalised per word (exp cannot underflow a
      whole column); the prefix sum is a float32 ``cumsum``, so c is
      monotone and the draw is ``searchsorted(c, u * c[-1])`` = #{c < r},
      clamped to K-1.  The JAX package forms c as a product with a
      triangular matrix, each entry its own dot product (on the CPU in
      float32); where that rounds an entry differently, a draw within an
      ulp of a boundary moves to the adjacent topic.
    - ``race``: exponential races, argmax_k p_k / E_k with 1/E = -1/log u.
    - ``gumbel``: Gumbel-max in the log domain, argmax(log(n_dk + alpha)
      + log phi[:, w] + g), which is ``jax.random.categorical``.

    ``block_positions`` (B): B consecutive positions of every document
    are resampled a step from one n_dk (all B old assignments removed
    first); B = 1 is exact sequential Gibbs within a document.  The
    factor rows of every slot are gathered once a call ([LB, B, D, K],
    under ``PREGATHER_FACTOR_MAX_BYTES``) when the call runs more than
    one sweep.  Padding slots never move and add nothing to any count.
    """
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler: {sampler}")
    D, L = tokens.shape
    K = log_topic_word.shape[0]
    dtype = log_topic_word.dtype
    dev = log_topic_word.device
    B, LB = sweep_blocks(L, block_positions)
    Lp = LB * B
    n_sweeps = burn_in + num_samples

    def blocks(x):
        """[D, L] -> [LB, B, D] (inert zero padding)."""
        xc = x.t()
        if Lp > L:
            xc = torch.cat([xc, xc.new_zeros((Lp - L, D))])
        return xc.reshape(LB, B, D).contiguous()

    tok_c = blocks(tokens.long())
    mask_c = blocks(token_mask.to(dtype))
    neg_mask_t = (-mask_c).transpose(1, 2)  # [LB, D, B] views of the steps
    mask_t = mask_c.transpose(1, 2)
    live_c = mask_c > 0
    z_c = blocks(z_init.long())

    if sampler == "gumbel":
        fac_t = log_topic_word.t().contiguous()  # [V, K]
    else:
        fac_t = torch.exp(
            log_topic_word - log_topic_word.amax(dim=0, keepdim=True)
        ).t().contiguous()
    pregather = (n_sweeps > 1 and LB * B * D * K * fac_t.element_size()
                 <= PREGATHER_FACTOR_MAX_BYTES)
    fac_c = fac_t[tok_c] if pregather else None  # [LB, B, D, K]

    ndk = torch.zeros((D, K), dtype=dtype, device=dev)
    ndk.scatter_add_(1, z_init.long(), token_mask.to(dtype))
    acc_ndk = torch.zeros((D, K), dtype=dtype, device=dev)
    ranges = {"topic_range": topic_range, "vocab_range": vocab_range}
    (k0, k1), (v0, v1) = topic_range or (0, K), vocab_range or (0, num_types)
    acc_kv = (torch.zeros((k1 - k0, v1 - v0), dtype=dtype, device=dev)
              if accumulate_counts else None)
    alpha_row = alpha[None, :]
    for s in range(n_sweeps):
        nz = noise(s)
        if tuple(nz.shape) != noise_shape(sampler, D, L, K, block_positions):
            raise ValueError(f"sweep {s}: noise of shape {tuple(nz.shape)}, "
                             f"want {noise_shape(sampler, D, L, K, B)}")
        nz = nz.to(dev, dtype)
        if sampler == "race":
            nz = torch.log(nz).reciprocal_().neg_()  # 1/E, E ~ Exp(1)
        for t in range(LB):
            z_t = z_c[t]  # [B, D]
            f_t = fac_c[t] if pregather else fac_t[tok_c[t]]  # [B, D, K]
            ndk.scatter_add_(1, z_t.t(), neg_mask_t[t])
            if sampler == "gumbel":
                x = torch.log(ndk + alpha_row) + f_t
                x += nz[t]
                z_new = x.argmax(dim=-1)
            else:
                p = (ndk + alpha_row) * f_t  # [B, D, K]
                if sampler == "cdf":
                    c = torch.cumsum(p, dim=-1)
                    r = nz[t][..., None] * c[..., -1:]
                    z_new = torch.searchsorted(c, r).squeeze(-1)
                    z_new.clamp_max_(K - 1)
                else:
                    z_new = (p * nz[t]).argmax(dim=-1)
            torch.where(live_c[t], z_new, z_t, out=z_t)
            ndk.scatter_add_(1, z_t.t(), mask_t[t])
        if accumulate_counts and s >= burn_in:
            acc_ndk += ndk
            acc_kv += count_table(tok_c, mask_c, z_c, K, num_types, **ranges)
    denom = float(max(1, num_samples))
    gamma_bar = alpha_row + acc_ndk / denom
    sstats = acc_kv / denom if accumulate_counts else None
    z_out = z_c.reshape(Lp, D)[:L].t().to(torch.int32).contiguous()
    return gamma_bar, sstats, z_out, ndk


def sample_doc_topics(
    tokens, token_mask, log_topic_word, alpha, z_init,
    generator: torch.Generator,
    num_types: int,
    burn_in: int = 5,
    num_samples: int = 10,
    sampler: str = "cdf",
    block_positions: int = 1,
    accumulate_counts: bool = True,
    topic_range: Optional[Tuple[int, int]] = None,
    vocab_range: Optional[Tuple[int, int]] = None,
):
    """``sweep_doc_topics`` with each sweep's noise drawn from
    ``generator`` (on the tensors' device) just before the sweep."""
    D, L = tokens.shape
    shape = noise_shape(sampler, D, L, log_topic_word.shape[0],
                        block_positions)
    return sweep_doc_topics(
        tokens, token_mask, log_topic_word, alpha, z_init,
        lambda s: draw_noise(sampler, shape, generator, log_topic_word.dtype),
        num_types=num_types, burn_in=burn_in, num_samples=num_samples,
        sampler=sampler, block_positions=block_positions,
        accumulate_counts=accumulate_counts, topic_range=topic_range,
        vocab_range=vocab_range,
    )


def sequence_token_score(tokens, token_mask, elog_theta, log_topic_word
                         ) -> torch.Tensor:
    """sum_{d,t} mask * logsumexp_k(Elogtheta_dk + logbeta_k,w): the token
    part of the bound on the sequence layout, 0-d.  Positions are scored
    in chunks whose [D, chunk, K] gathered block stays under
    ``SCORE_CHUNK_BYTES``."""
    D, L = tokens.shape
    K = elog_theta.shape[1]
    lbt = log_topic_word.t().contiguous()  # [V, K]
    step = max(1, SCORE_CHUNK_BYTES // max(1, D * K * lbt.element_size()))
    acc = torch.zeros((), dtype=elog_theta.dtype, device=elog_theta.device)
    for s in range(0, L, step):
        x = lbt[tokens[:, s:s + step].long()] + elog_theta[:, None, :]
        acc = acc + (token_mask[:, s:s + step] * torch.logsumexp(x, -1)).sum()
    return acc
