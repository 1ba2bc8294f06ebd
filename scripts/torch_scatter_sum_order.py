"""Is the scatter's segmented sum repeatable on the card, and what does it
cost against the other ways to sum by word?

    PYTHONPATH=. python scripts/torch_scatter_sum_order.py

On one CUDA card, at SVI config 4's shapes (K=200, V=50,000, 16,384
synthetic documents of mean length 150, seed 3, minibatches of 1024,
``sstats_mode="scatter"``): the first minibatch's buckets, gathered from
the device-resident rows, their gammas from the ragged kernel at the
planted topics.  For each bucket the per-slot products U = expEtheta[d] *
cnt / phinorm ([slots, K]) are summed by word four ways:

- ``sum_by_word``: slots sorted stably by word, each word's run summed in
  parts of 8 to 128 slots, then the parts (``ops/estep.scatter_sstats``
  takes parts of ``SUM_RUN`` = 64);
- ``segment_reduce``, one segment a word: each word's run in sequence;
- ``index_add_``: unsorted, into [V, K] (atomic adds on the card);
- ``index_put_(accumulate=True)``: unsorted, into [V, K].

Each is called REPEATS times; the script prints whether every call gave
the same bits as the first and its CUDA-event mean time, then the whole
``scatter_sstats`` of the minibatch against ``dense_sstats`` on the same
documents (the dense sstats plan of an ``sstats_mode="auto"`` engine).
Prints the card's name and power limit first.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.models import StochasticVariationalBayes
from pylda_tpu_torch.models.vb import _assemble_gamma_device
from pylda_tpu_torch.ops import ragged as ragged_mod
from pylda_tpu_torch.ops import sstats as sstats_mod
from pylda_tpu_torch.ops.dirichlet import (
    exp_dirichlet_expectation,
    exp_dirichlet_expectation_fast,
)
from pylda_tpu_torch.ops.estep import scatter_sstats, sum_by_word
from pylda_tpu_torch.utils.config import LDAConfig

K, V, D, LEN, BATCH, REPEATS = 200, 50_000, 16_384, 150.0, 1024, 10


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def products(ids, cnts, et, eeb):
    """(flat word ids [N], U [N, K]) of one bucket, unsorted."""
    flat = ids.reshape(-1).long()
    B = eeb.T.index_select(0, flat).reshape(*ids.shape, -1)
    phinorm = torch.einsum("dtk,dk->dt", B, et) + 1e-30
    T = ids.shape[1]
    rows = torch.div(torch.arange(flat.numel(), device=ids.device), T,
                     rounding_mode="floor")
    return flat, et.index_select(0, rows) * (cnts / phinorm).reshape(-1)[:, None]


def by_parts(run):
    def fn(flat, U, nv):
        words, perm = torch.sort(flat, stable=True)
        return sum_by_word(words, U[perm], nv, run)
    return fn


def by_segment_reduce(flat, U, nv):
    words, perm = torch.sort(flat, stable=True)
    offsets = torch.searchsorted(
        words, torch.arange(nv + 1, device=flat.device, dtype=words.dtype))
    return torch.segment_reduce(U[perm], "sum", offsets=offsets, axis=0,
                                unsafe=True)


def by_index_add(flat, U, nv):
    return torch.zeros((nv, U.shape[1]), device=U.device).index_add_(0, flat, U)


def by_index_put(flat, U, nv):
    return torch.zeros((nv, U.shape[1]), device=U.device).index_put_(
        (flat,), U, accumulate=True)


def main() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    corpus, beta, _ = synthetic_corpus(num_docs=D, num_topics=K, num_types=V,
                                       mean_doc_length=LEN, seed=3)
    lam = (1.0 / V + beta * (corpus.num_tokens / K)).astype(np.float32)
    base = dict(number_of_topics=K, inference_mode="svi", batch_size=BATCH,
                tau0=64.0, kappa=0.7, seed=0)
    eng = StochasticVariationalBayes(LDAConfig(**base, sstats_mode="scatter"),
                                     device=dev)
    eng.initialize(corpus, lam_init=lam)
    assert eng._mb_sstats is None
    st = eng.state
    eeb = exp_dirichlet_expectation_fast(st.lam)
    batches, _ = next(eng._epoch(0, 0).minibatches)
    ets, slots = [], 0
    for b in batches:
        g, _ = ragged_mod.ragged_gamma(b.ids, b.cnts, torch.ones(
            (b.ids.shape[0], K), device=dev), eeb, st.alpha)
        ets.append(exp_dirichlet_expectation(g))
        slots += b.ids.numel()
    print(f"minibatch: buckets {[tuple(b.ids.shape) for b in batches]}, "
          f"{slots} slots")
    for name, fn in (*((f"sum_by_word, parts of {r}", by_parts(r))
                       for r in (8, 16, 32, 64, 128)),
                     ("segment_reduce", by_segment_reduce),
                     ("index_add_", by_index_add),
                     ("index_put_(accumulate=True)", by_index_put)):
        same, ms = True, 0.0
        for b, et in zip(batches, ets):
            flat, U = products(b.ids, b.cnts, et, eeb)
            first = fn(flat, U, V)
            for _ in range(REPEATS - 1):
                same = same and torch.equal(first, fn(flat, U, V))
            ms += cuda_ms(lambda: fn(flat, U, V), REPEATS)
        print(f"sum by word with {name}: {REPEATS} calls bitwise equal "
              f"{same}; {ms:.4f} ms a minibatch (CUDA events)")

    eeb_t = ragged_mod.gather_table(eeb)

    def scatter_all():
        for b, et in zip(batches, ets):
            scatter_sstats(b.ids, b.cnts, et, eeb, eeb_t)

    print(f"scatter_sstats of the minibatch: {cuda_ms(scatter_all, REPEATS):.4f}"
          f" ms")
    dense = StochasticVariationalBayes(LDAConfig(**base), device=dev)
    dense.initialize(corpus, lam_init=lam)
    dbatches, (_, sel) = next(dense._epoch(0, 0).minibatches)
    buckets, plan = dense._local_plan(dbatches, sel)
    rows = torch.cat([ragged_mod.ragged_gamma(
        b.ids, b.cnts, torch.ones((b.ids.shape[0], K), device=dev), eeb,
        st.alpha)[0] for b in buckets])
    et_docs = exp_dirichlet_expectation(_assemble_gamma_device(
        rows, torch.cat([b.row_index for b in buckets]), st.alpha,
        plan.num_docs))

    def dense_all():
        for counts, cidx in plan.chunks:
            sstats_mod.dense_sstats(counts, et_docs[cidx], eeb)

    print(f"dense_sstats of the minibatch (gamma assembly excluded): "
          f"{cuda_ms(dense_all, REPEATS):.4f} ms")


if __name__ == "__main__":
    main()
