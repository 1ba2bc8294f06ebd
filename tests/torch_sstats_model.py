"""The dense sufficient-statistics cluster kernel's summation order
(``csrc/dense_sstats.cu``'s cluster kernel, every plan of
``ops/sstats.py::plan`` above K = 256) in PyTorch, on the CPU: the model
the CPU tests hold against the plain version and JAX's function."""

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
