"""The port's sampling ops (``pylda_tpu_torch.ops.sampling``) against
``pylda_tpu.ops.sampling`` on the CPU.

The sweep takes its noise as an argument, so the port is fed the JAX
package's own draws, made along its key path (``fold_in(key, s)`` a
sweep; uniforms with ``minval=tiny`` for cdf and race; ``split(key, LB)``
and a Gumbel draw a step for gumbel, as ``jax.random.categorical`` makes
them).  Tolerances: the count tables, and the sweep's gamma_bar and
sstats, are bitwise equal (exact small integers in float32); z and n_dk
are equal except on at most 0.1% of the documents (a draw within an ulp
of a CDF boundary may land one topic over, since the JAX package's prefix
sums are dot products and the port's a cumsum); counts are conserved in
every case; ``sequence_token_score`` agrees to rel 1e-6 (another
summation order).  The mirrors of ``tests/test_sampler_cdf.py`` keep its
bars: single-token draws within a 4-sigma binomial band of the exact
categorical, no underflow at extreme log factors, conservation under
blocking.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylda_tpu.ops import sampling as jax_sampling
from pylda_tpu_torch.ops import sampling
from pylda_tpu_torch.ops.sampling import (
    count_table,
    draw_noise,
    noise_shape,
    sample_doc_topics,
    sequence_token_score,
    stream,
    sweep_doc_topics,
)

# z and n_dk may differ on at most this share of documents.
Z_DOC_ALLOWANCE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _problem(seed, D, L, V, K, alpha=0.3):
    """Padded token rows of random lengths, a log-domain factor and z0."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, V, size=(D, L)).astype(np.int32)
    lengths = rng.integers(1, L + 1, size=(D, 1))
    mask = (np.arange(L)[None, :] < lengths).astype(np.float32)
    tokens *= mask.astype(np.int32)
    log_tw = np.log(rng.dirichlet(np.ones(V), size=K)).astype(np.float32)
    alpha = np.full((K,), alpha, np.float32)
    z0 = rng.integers(0, K, size=(D, L)).astype(np.int32)
    return tokens, mask, log_tw, alpha, z0


def _jax_noise(key, sampler, D, L, K, B, s):
    """Sweep s's noise as the JAX package draws it, in its layout."""
    shape = noise_shape(sampler, D, L, K, B)
    sub = jax.random.fold_in(key, s)
    if sampler == "gumbel":
        keys = jax.random.split(sub, shape[0])
        return np.stack([np.asarray(jax.random.gumbel(k, shape[1:],
                                                      jnp.float32))
                         for k in keys])
    return np.array(jax.random.uniform(
        sub, shape, jnp.float32, minval=jnp.finfo(jnp.float32).tiny,
        maxval=1.0))


# -- count_table ---------------------------------------------------------------


@pytest.mark.parametrize("branch", ["scalar", "one_hot"])
def test_count_table_bitwise_equal(branch, monkeypatch):
    """The port's one flat table against each of the JAX package's
    branches."""
    tokens, mask, _, _, z = _problem(0, 37, 23, 61, 9)
    K, V = 9, 61
    want = np.asarray(jax_sampling.count_table(
        jnp.asarray(tokens), jnp.asarray(mask), jnp.asarray(z), K, V,
        jnp.float32))
    monkeypatch.setattr(jax_sampling, "SCALAR_COUNTS", branch == "scalar")
    want_branch = np.asarray(jax_sampling.count_table(
        jnp.asarray(tokens), jnp.asarray(mask), jnp.asarray(z), K, V,
        jnp.float32))
    got = count_table(torch.as_tensor(tokens), torch.as_tensor(mask),
                      torch.as_tensor(z), K, V).numpy()
    assert got.shape == (K, V) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, want_branch)
    assert got.sum() == mask.sum()


# -- the noise-injected sweep against the JAX package's ------------------------

_D, _L, _V = 40, 19, 50
_BURN, _KEEP = 1, 2
_jax_cache = {}


def _jax_sweep(sampler, B, K):
    """The JAX package's sample_doc_topics on one problem (cached over the
    pre-gather cases, which do not change its result)."""
    ck = (sampler, B, K)
    if ck not in _jax_cache:
        tokens, mask, log_tw, alpha, z0 = _problem(K + B, _D, _L, _V, K)
        key = jax.random.PRNGKey(K * 10 + B)
        out = jax_sampling.sample_doc_topics(
            jnp.asarray(tokens), jnp.asarray(mask), jnp.asarray(log_tw),
            jnp.asarray(alpha), jnp.asarray(z0), key, num_topics=K,
            num_types=_V, burn_in=_BURN, num_samples=_KEEP, sampler=sampler,
            block_positions=B)
        _jax_cache[ck] = ((tokens, mask, log_tw, alpha, z0), key,
                          [np.asarray(x) for x in out])
    return _jax_cache[ck]


@pytest.mark.parametrize("pregather", [True, False])
@pytest.mark.parametrize("K", [5, 16, 100])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("sampler", ["cdf", "gumbel", "race"])
def test_sweep_with_jax_noise_matches_jax(sampler, B, K, pregather,
                                          monkeypatch):
    (tokens, mask, log_tw, alpha, z0), key, want = _jax_sweep(sampler, B, K)
    if not pregather:
        monkeypatch.setattr(sampling, "PREGATHER_FACTOR_MAX_BYTES", 0)
    gamma, ss, z, ndk = sweep_doc_topics(
        torch.as_tensor(tokens), torch.as_tensor(mask),
        torch.as_tensor(log_tw), torch.as_tensor(alpha), torch.as_tensor(z0),
        lambda s: torch.as_tensor(_jax_noise(key, sampler, _D, _L, K, B, s)),
        num_types=_V, burn_in=_BURN, num_samples=_KEEP, sampler=sampler,
        block_positions=B)
    g_j, ss_j, z_j, ndk_j = want
    z, ndk = z.numpy(), ndk.numpy()
    assert z.dtype == np.int32 and z.shape == (_D, _L)
    # Conservation: padding never moves, rows of n_dk sum to lengths,
    # sstats to the kept sweeps' mean token count.
    np.testing.assert_array_equal(z[mask == 0], z0[mask == 0])
    np.testing.assert_array_equal(ndk.sum(axis=1), mask.sum(axis=1))
    assert ss.numpy().sum() == mask.sum()
    differ = (z != z_j).any(axis=1) | (ndk != ndk_j).any(axis=1)
    # At 40 documents the allowance is 0: every draw must agree.
    assert differ.sum() <= Z_DOC_ALLOWANCE * _D, np.flatnonzero(differ)
    np.testing.assert_array_equal(gamma.numpy(), g_j)
    np.testing.assert_array_equal(ss.numpy(), ss_j)


def test_sweep_refuses_wrong_noise_shape():
    tokens, mask, log_tw, alpha, z0 = _problem(1, 4, 5, 7, 3)
    args = [torch.as_tensor(x) for x in (tokens, mask, log_tw, alpha, z0)]
    with pytest.raises(ValueError, match="noise of shape"):
        sweep_doc_topics(*args, lambda s: torch.rand(5, 4), num_types=7,
                         burn_in=0, num_samples=1, sampler="cdf",
                         block_positions=2)


def test_sample_doc_topics_is_deterministic_in_its_stream():
    tokens, mask, log_tw, alpha, z0 = _problem(2, 16, 11, 20, 6)
    args = [torch.as_tensor(x) for x in (tokens, mask, log_tw, alpha, z0)]
    kw = dict(num_types=20, burn_in=2, num_samples=3, sampler="cdf",
              block_positions=4)
    a = sample_doc_topics(*args, stream("cpu", 7, 1), **kw)
    b = sample_doc_topics(*args, stream("cpu", 7, 1), **kw)
    c = sample_doc_topics(*args, stream("cpu", 7, 2), **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert not np.array_equal(a[2].numpy(), c[2].numpy())


def test_noise_draws_are_positive():
    g = stream("cpu", 0)
    u = draw_noise("cdf", (64, 8, 32), g)
    assert (u > 0).all() and (u < 1).all()
    gum = draw_noise("gumbel", (4, 8, 32, 5), g)
    assert torch.isfinite(gum).all()


# -- mirrors of tests/test_sampler_cdf.py ---------------------------------------

_K, _V7, _DBIG = 7, 13, 40_000


def _sample(tokens, mask, log_tw, alpha, z0, seed, **kw):
    return sample_doc_topics(
        torch.as_tensor(tokens), torch.as_tensor(mask),
        torch.as_tensor(log_tw), torch.as_tensor(alpha), torch.as_tensor(z0),
        stream("cpu", seed), **kw)


@pytest.mark.parametrize("block", [1, 4])
@pytest.mark.parametrize("sampler", ["cdf", "gumbel", "race"])
def test_single_token_matches_exact_categorical(sampler, block):
    """One real token a document (the rest of a block is padding), the
    same word everywhere: the empirical topic histogram over 40,000
    documents matches alpha_k phi_kw / sum within 4 binomial sigma."""
    rng = np.random.default_rng(0)
    word, width = 5, block
    tokens = np.full((_DBIG, width), word, np.int32)
    mask = np.zeros((_DBIG, width), np.float32)
    mask[:, 0] = 1.0
    log_tw = np.log(rng.dirichlet(np.ones(_V7), size=_K)).astype(np.float32)
    alpha = rng.uniform(0.1, 2.0, size=_K).astype(np.float32)
    _g, _ss, z, _ndk = _sample(
        tokens, mask, log_tw, alpha, np.zeros_like(tokens), 3, num_types=_V7,
        burn_in=0, num_samples=1, sampler=sampler, block_positions=block)
    emp = np.bincount(z[:, 0].numpy(), minlength=_K) / _DBIG
    p = alpha * np.exp(log_tw)[:, word]
    p = p / p.sum()
    tol = 4 * np.sqrt(p * (1 - p) / _DBIG)
    assert (np.abs(emp - p) < tol + 1e-3).all(), (emp, p)


def test_cdf_extreme_log_factor_no_underflow():
    """Log factors far below float32's exp range still sample: the
    per-word max-normalisation keeps one entry at exp(0)."""
    tokens = np.zeros((64, 4), np.int32)
    mask = np.ones((64, 4), np.float32)
    log_tw = np.full((5, 3), -500.0, np.float32)
    log_tw[2, 0] = -480.0
    _g, _ss, z, ndk = _sample(
        tokens, mask, log_tw, np.ones(5, np.float32), tokens, 0,
        num_types=3, burn_in=0, num_samples=1, sampler="cdf")
    assert torch.isfinite(ndk).all()
    assert (z.numpy() == 2).mean() > 0.95


@pytest.mark.parametrize("sampler", ["cdf", "gumbel", "race"])
@pytest.mark.parametrize("block", [2, 4, 7])
def test_blocked_sampler_conserves_counts(sampler, block):
    """Blocks that do not divide L (padded steps) keep padding frozen and
    counts exactly conserved."""
    tokens, mask, log_tw, alpha, z0 = _problem(3, 16, 9, _V7, _K)
    _g, ss, z, ndk = _sample(tokens, mask, log_tw, alpha, z0, 7,
                             num_types=_V7, burn_in=1, num_samples=2,
                             sampler=sampler, block_positions=block)
    z = z.numpy()
    np.testing.assert_array_equal(z[mask == 0], z0[mask == 0])
    np.testing.assert_array_equal(ndk.numpy().sum(axis=1), mask.sum(axis=1))
    assert float(ss.sum()) == float(mask.sum())


# -- sequence_token_score ---------------------------------------------------------


def test_sequence_token_score_matches_jax(monkeypatch):
    tokens, mask, log_tw, _, _ = _problem(5, 30, 17, 40, 8)
    elog_theta = np.log(np.random.default_rng(6).dirichlet(
        np.ones(8), size=30)).astype(np.float32)
    want = float(jax_sampling.sequence_token_score(
        jnp.asarray(tokens), jnp.asarray(mask), jnp.asarray(elog_theta),
        jnp.asarray(log_tw)))
    args = [torch.as_tensor(x) for x in (tokens, mask, elog_theta, log_tw)]
    got = float(sequence_token_score(*args))
    assert got == pytest.approx(want, rel=1e-6)
    # Position chunks of one slot score the same.
    monkeypatch.setattr(sampling, "SCORE_CHUNK_BYTES", 1)
    assert float(sequence_token_score(*args)) == pytest.approx(want, rel=1e-6)
