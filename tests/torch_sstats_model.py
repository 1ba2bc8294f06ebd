"""The dense sufficient-statistics kernels' summation orders in PyTorch,
on the CPU: the models the CPU tests hold against the plain version and
JAX's functions.  ``cluster_sstats``: the cluster kernel
(``csrc/dense_sstats.cu``, every plan of ``ops/sstats.py::plan`` above
K = 256).  ``mma_sstats``: the bf16 build's tensor-core kernel at
K <= 256 (``csrc/dense_sstats_mma.cuh``, ``ops/sstats.py::mma_plan``)."""

import torch

from pylda_tpu_torch.ops.estep import bf16_round

LANES, THREADS, WARPS = 32, 256, 8


def butterfly(x):
    """The xor butterfly over the last axis of 32 lanes (16, 8, .., 1):
    every lane ends with the same sum."""
    idx = torch.arange(LANES)
    for off in (16, 8, 4, 2, 1):
        x = x + x[..., idx ^ off]
    return x[..., 0]


def cluster_entries(counts, tile, cols):
    """The nonzeros of one column tile in the cluster kernel's list order,
    row-major (each column's in row order): (rows, columns)."""
    block = counts[:, tile * cols:(tile + 1) * cols]
    rows, cc = torch.nonzero(block != 0, as_tuple=True)  # row-major
    return rows, tile * cols + cc


def cluster_sstats(counts, et, eeb, eps, k0, k1, compute_dtype, pl,
                   batch=None):
    """The cluster kernel's order at plan ``pl``: column tiles of
    ``pl.cols``; CTA r of the cluster owns topics [r S, r S + S), S =
    ``pl.slice``; each tile's nonzeros in row-major order in batches of
    ``batch`` (default ``pl.batch``).  A nonzero's partial phinorm on a
    CTA, by the warp owning its column: lane l's rows l, l + 32, .. in
    two chains (even and odd rows, in order) and their sum, then in
    float64 the xor butterfly over the 32 lanes; the ranks' partials in
    rank order, + eps, rounded once to the inputs' dtype; the ratio
    (bf16: rounded);
    the score terms in
    nonzero order, f64, a tile a part, the parts in the final tree; raw
    of (topic, column) by the lane holding it over the column's nonzeros
    in row order, times expElogbeta."""
    rnd = bf16_round if compute_dtype == "bfloat16" else (lambda x: x)
    D, Vc = counts.shape
    k, V = eeb.shape
    dt = et.dtype
    c = counts.to(dt)
    eeb_w = torch.nn.functional.pad(eeb, (0, Vc - V))
    batch = batch or pl.batch
    S = pl.slice
    per = -(-S // LANES) * LANES  # rows of a slice, whole lanes' rows
    f64 = torch.float64
    raw = torch.zeros(k1 - k0, V, dtype=dt)
    parts = []
    for tile in range(pl.tiles):
        rows, cols = cluster_entries(c, tile, pl.cols)
        part = torch.zeros((), dtype=f64)
        for n0 in range(0, rows.shape[0], batch):
            d, v = rows[n0:n0 + batch], cols[n0:n0 + batch]
            m = d.shape[0]
            ph = torch.zeros(m, dtype=f64)
            for r in range(pl.cluster):
                kb = r * S
                own = max(0, min(k, kb + S) - kb)
                prod = torch.zeros(m, per, dtype=dt)
                prod[:, :own] = (rnd(et[d, kb:kb + own])
                                 * rnd(eeb_w[kb:kb + own, v].T))
                prod = prod.reshape(m, per // LANES, LANES)
                chains = torch.zeros(2, m, LANES, dtype=dt)
                for j in range(per // LANES):
                    chains[j % 2] = chains[j % 2] + prod[:, j]
                ph = ph + butterfly((chains[0] + chains[1]).to(f64))
            cv = c[d, v]
            pn = (ph + eps).to(dt)
            ratio = rnd(cv / pn)
            for term in (cv * torch.log(pn)).to(torch.float64):
                part = part + term
            for n in range(m):
                if v[n] < V:
                    raw[:, v[n]] += rnd(et[d[n], k0:k1]) * ratio[n]
        parts.append(part)
    # The final tree: thread i sums parts i, i + 256, .., then a warp's
    # lanes by halves (16, 8, .., 1) and the warps in order.
    t = torch.zeros(THREADS, dtype=torch.float64)
    for i0 in range(0, len(parts), THREADS):
        chunk = torch.stack(parts[i0:i0 + THREADS])
        t[:chunk.shape[0]] += chunk
    t = t.reshape(WARPS, LANES)
    while t.shape[1] > 1:
        t = t[:, :t.shape[1] // 2] + t[:, t.shape[1] // 2:]
    score = torch.zeros((), dtype=torch.float64)
    for w in range(WARPS):
        score = score + t[w, 0]
    return eeb[k0:k1] * raw, score


MMA_K, MMA_M, MMA_N = 16, 16, 8  # an mma.sync m16n8k16 tile


def mma_sstats(counts, et, eeb, eps, k0, k1, compute_dtype, pl):
    """The tensor-core kernel's order at plan ``pl`` (``pl.mma``): column
    tiles of ``pl.cols``; in each, the row splits' chunks of
    ``sstats_mod.MMA_ROWS`` rows in order.  Step A: phinorm of the chunk
    [rows x cols] as 16 x 8 output tiles accumulated over the k16 steps
    of topics in order (an mma's 16 products summed as one block, then
    added), + eps; where a count is nonzero the ratio (bf16: rounded) and
    the score term C log(phinorm) in float64; zero chunks skipped.  Step
    B: raw [kp x cols] of the split as 16 x 8 output tiles accumulated
    over the chunk's k16 steps of rows in order, only the topic tiles
    that meet [k0, k1); the splits' raw met in split order, times
    expElogbeta.  The score parts summed in a fixed order (the kernel's
    per-thread order is another fixed order, not modelled)."""
    from pylda_tpu_torch.ops import sstats as sstats_mod

    rnd = bf16_round if compute_dtype == "bfloat16" else (lambda x: x)
    D, Vc = counts.shape
    K, V = eeb.shape
    dt = et.dtype
    kp, cols, R = pl.kp, pl.cols, sstats_mod.MMA_ROWS
    width = pl.tiles * cols
    c = torch.nn.functional.pad(counts.to(dt), (0, width - Vc))
    et_b = torch.nn.functional.pad(rnd(et), (0, kp - K))
    eeb_b = torch.nn.functional.pad(rnd(eeb), (0, width - V, 0, kp - K))
    mt_lo, mt_hi = k0 // MMA_M, min(kp // MMA_M, -(-k1 // MMA_M))
    raw_all = torch.zeros(kp, width, dtype=dt)
    score = torch.zeros((), dtype=torch.float64)
    for tile in range(pl.tiles):
        cs = slice(tile * cols, (tile + 1) * cols)
        total = None
        for split in range(pl.splits):
            raw = torch.zeros(kp, cols, dtype=dt)
            lo = split * pl.rows_per_split
            hi = min(D, lo + pl.rows_per_split)
            for d0 in range(lo, hi, R):
                rows = torch.arange(d0, d0 + R)
                live = rows < hi
                cc = torch.zeros(R, cols, dtype=dt)
                e = torch.zeros(R, kp, dtype=dt)
                cc[live] = c[rows[live], cs]
                e[live] = et_b[rows[live]]
                if not bool((cc != 0).any()):
                    continue
                ph = torch.zeros(R, cols, dtype=dt)
                for ks in range(0, kp, MMA_K):
                    ph = ph + e[:, ks:ks + MMA_K] @ eeb_b[ks:ks + MMA_K, cs]
                pn = ph + eps
                on = cc != 0
                ratio = torch.zeros(R, cols, dtype=dt)
                ratio[on] = rnd(cc[on] / pn[on])
                for term in (cc[on] * torch.log(pn[on])).to(torch.float64):
                    score = score + term
                for ks in range(0, R, MMA_K):
                    for mt in range(mt_lo, mt_hi):
                        m = slice(mt * MMA_M, (mt + 1) * MMA_M)
                        raw[m] = raw[m] + (e[ks:ks + MMA_K, m].T
                                           @ ratio[ks:ks + MMA_K])
            total = raw if total is None else total + raw
        raw_all[:, cs] = total
    return eeb[k0:k1] * raw_all[k0:k1, :V], score
