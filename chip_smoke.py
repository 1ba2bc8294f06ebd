#!/usr/bin/env python3
"""Smoke test of pylda_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero):

1. the card: its name and count, and ``nvidia-smi``'s name and power limit;
2. build: every CUDA kernel of the package from ``pylda_tpu_torch/csrc``
   (one ``nvcc`` per source, started together), with nvcc's register and
   shared-memory report;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it at the flagship configuration
   (K=100, V=10,000, D=4096, mean document length 120): the dense
   sufficient statistics on the [4096, 10240] bf16 counts chunk and the
   ragged gamma fixed point on each planner bucket (inner 50, threshold
   1e-5, patience 6), with times from CUDA events and bounds from this
   run's inputs;
4. engine: ``VariationalBayes`` through ``initialize``, ``learning_many``,
   ``inference`` and ``perplexity`` at the flagship shape, with the kernel
   launch counters zeroed just before and read just after;
5. cross-check: at a small size the engine on the card (kernels) and on
   the CPU (plain versions) give the same ELBOs.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# Peak rates of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# float32 outside the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

K, V, D, MEAN_LEN = 100, 10_000, 4096, 120.0

# Kernel vs plain version on the card.  Sums run in different orders
# (per-thread f32 accumulation vs cuBLAS blocking), so agreement is to
# f32 reassociation noise.  The gamma fixed point adds exit-timing noise:
# a row at the threshold may freeze a sweep apart in the two versions,
# which moves it by at most K * threshold in sum_k |dgamma|.
SSTATS_RTOL, SSTATS_ATOL_REL, SCORE_RTOL = 1e-4, 1e-6, 1e-5
GAMMA_RTOL = 5e-4
ELBO_RTOL = 1e-4  # card vs CPU engine, small cross-check


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card over reps warm calls."""
    import torch

    fn()
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


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
    from pylda_tpu_torch.models import VariationalBayes
    from pylda_tpu_torch.models.vb import _assemble_gamma_device
    from pylda_tpu_torch.ops import _build, ragged as ragged_mod
    from pylda_tpu_torch.ops import sstats as sstats_mod
    from pylda_tpu_torch.ops.dirichlet import (
        exp_dirichlet_expectation,
        exp_dirichlet_expectation_fast,
    )
    from pylda_tpu_torch.ops.estep import (
        estep_dense_sstats,
        estep_ragged_gamma,
    )
    from pylda_tpu_torch.utils.config import LDAConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    print(f"device: {kind} (count {count}); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {_build.SOURCES}")
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "ptxas info" in line and ("registers" in line
                                         or "Compiling entry" in line):
                print(f"  {name}: {line.strip()}")

    # -- kernels at the flagship shapes --------------------------------------
    corpus, beta, _ = synthetic_corpus(
        num_docs=D, num_topics=K, num_types=V, mean_doc_length=MEAN_LEN,
        seed=0,
    )
    cfg = LDAConfig(number_of_topics=K, inference_mode="vb",
                    inner_iterations=50, convergence_threshold=1e-5, seed=0)
    # A sharpened lambda like a trained model's: the planted topics
    # scaled to the corpus's tokens per topic.
    lam_trained = (1.0 / V + beta * (corpus.num_tokens / K)).astype(np.float32)
    probe = VariationalBayes(cfg, device=dev)
    probe.initialize(corpus, lam_init=lam_trained)
    st = probe.state
    eeb = exp_dirichlet_expectation_fast(st.lam)
    eeb_t = ragged_mod.gather_table(eeb)
    gamma_atol = 5e-4 + K * cfg.convergence_threshold
    kw = dict(inner_iterations=cfg.inner_iterations,
              convergence_threshold=cfg.convergence_threshold, eps=cfg.eps,
              stall_patience=cfg.estep_stall_patience)

    rg = dict(ms=0.0, plain_ms=0.0, flops=0.0, nbytes=0.0, err=0.0)
    rows_plain = []
    for i, b in enumerate(probe._batches):
        Db, Tb = b.ids.shape
        g0 = torch.ones((Db, K), dtype=torch.float32, device=dev)
        slots = torch.zeros((1,), dtype=torch.int64, device=dev)
        g_k, s_k = ragged_mod.ragged_gamma(b.ids, b.cnts, g0, eeb, st.alpha,
                                           eeb_t=eeb_t, slots_out=slots,
                                           **kw)
        g_p, s_p = estep_ragged_gamma(b.ids, b.cnts, g0, eeb, st.alpha, **kw)
        torch.cuda.synchronize()
        err = float((g_k - g_p).abs().max())
        ok = bool(((g_k - g_p).abs()
                   <= gamma_atol + GAMMA_RTOL * g_p.abs()).all())
        sk, sp = int(s_k), int(s_p)
        flops = 4.0 * K * int(slots)
        nbytes = Db * Tb * 8 + V * K * 4 + 2 * Db * K * 4 + K * 4
        b_ms, b_by = bound(flops, nbytes)
        k_ms = cuda_ms(lambda: ragged_mod.ragged_gamma(
            b.ids, b.cnts, g0, eeb, st.alpha, eeb_t=eeb_t, **kw), 20)
        p_ms = cuda_ms(lambda: estep_ragged_gamma(
            b.ids, b.cnts, g0, eeb, st.alpha, **kw), 3)
        print(f"kernel ragged_gamma bucket {i} [{Db}x{Tb}]: sweeps kernel "
              f"{sk} plain {sp}, real slots processed {int(slots)}, "
              f"kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} bound_ms "
              f"{b_ms:.5f} ({b_by}), max_abs_err {err:.3e} (tolerance "
              f"{gamma_atol:g} + {GAMMA_RTOL}*|gamma|) {'ok' if ok else 'FAIL'}")
        if not ok or abs(sk - sp) > 1:
            raise AssertionError(f"ragged_gamma bucket {i} disagrees with "
                                 f"its plain version")
        rg["ms"] += k_ms
        rg["plain_ms"] += p_ms
        rg["flops"] += flops
        rg["nbytes"] += nbytes
        rg["err"] = max(rg["err"], err)
        rows_plain.append(g_p)

    plan = probe._sstats_plan
    gamma_docs = _assemble_gamma_device(
        torch.cat(rows_plain), torch.cat([b.row_index for b in probe._batches]),
        st.alpha, plan.num_docs,
    )
    et_docs = exp_dirichlet_expectation(gamma_docs)
    counts, cidx = plan.chunks[0]
    et_c = et_docs[cidx]
    ss_k, tok_k = sstats_mod.dense_sstats(counts, et_c, eeb, eps=cfg.eps)
    ss_p, tok_p = estep_dense_sstats(counts, et_c, eeb, eps=cfg.eps)
    torch.cuda.synchronize()
    ss_err = float((ss_k - ss_p).abs().max())
    ss_tol = SSTATS_RTOL * ss_p.abs() + SSTATS_ATOL_REL * float(ss_p.abs().max())
    tok_rel = abs(float(tok_k) - float(tok_p)) / abs(float(tok_p))
    ss_ok = bool(((ss_k - ss_p).abs() <= ss_tol).all()) and tok_rel <= SCORE_RTOL
    Dc, Vc = counts.shape
    ss_flops = 4.0 * Dc * K * V
    ss_bytes = (counts.numel() * counts.element_size() + Dc * K * 4
                + 2 * K * V * 4 + 4)
    ss_bound, ss_by = bound(ss_flops, ss_bytes)
    ss_ms = cuda_ms(lambda: sstats_mod.dense_sstats(counts, et_c, eeb,
                                                    eps=cfg.eps), 20)
    ss_plain_ms = cuda_ms(lambda: estep_dense_sstats(counts, et_c, eeb,
                                                     eps=cfg.eps), 20)
    print(f"kernel dense_sstats [{Dc}x{Vc} {str(counts.dtype)[6:]}, K={K}]: "
          f"kernel_ms {ss_ms:.4f} plain_ms {ss_plain_ms:.4f} bound_ms "
          f"{ss_bound:.5f} ({ss_by}), max_abs_err {ss_err:.3e} (tolerance "
          f"{SSTATS_RTOL}*|ref| + {SSTATS_ATOL_REL}*max|ref|), score rel err "
          f"{tok_rel:.3e} (tolerance {SCORE_RTOL}) "
          f"{'ok' if ss_ok else 'FAIL'}")
    if not ss_ok:
        raise AssertionError("dense_sstats disagrees with its plain version")
    del probe, st, eeb, eeb_t, rows_plain, gamma_docs, et_docs, et_c

    # -- engine: the main path ------------------------------------------------
    sstats_mod.LAUNCHES = 0
    ragged_mod.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = VariationalBayes(cfg, device=dev)
    eng.initialize(corpus)
    torch.cuda.synchronize()
    print(f"engine: initialize {time.perf_counter() - t0:.2f} s, buckets "
          f"{[tuple(b.ids.shape) for b in eng._batches]}")
    warm = eng.learning_many(2)
    n = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    elbos = eng.learning_many(n)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n
    sweeps = [int(s) for s in eng.last_sweeps]
    print(f"engine: learning_many({n}) {dt * 1e3:.3f} ms/iteration, "
          f"{D / dt:.1f} docs/s; sweeps per bucket (last iteration) "
          f"{sweeps}")
    print(f"engine: ELBOs {[round(e, 1) for e in warm + elbos]}")
    allq = warm + elbos
    if not all(np.isfinite(allq)) or not allq[-1] > allq[0]:
        raise AssertionError("ELBO not finite or not rising")
    test, _, _ = synthetic_corpus(
        num_docs=1024, num_topics=K, num_types=V, mean_doc_length=MEAN_LEN,
        seed=1, beta=beta,
    )
    t0 = time.perf_counter()
    ll, gamma = eng.inference(test)
    t_inf = time.perf_counter() - t0
    t0 = time.perf_counter()
    ppl = eng.perplexity(test)
    t_ppl = time.perf_counter() - t0
    if not (np.isfinite(ll) and np.isfinite(ppl)
            and gamma.shape == (test.num_docs, K)
            and np.isfinite(gamma).all()):
        raise AssertionError("held-out inference is not finite")
    print(f"serving: inference on {test.num_docs} held-out docs "
          f"{t_inf * 1e3:.1f} ms (ll {ll:.1f}), perplexity {ppl:.2f} in "
          f"{t_ppl * 1e3:.1f} ms")
    print(f"engine: peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    launches = {"dense_sstats": sstats_mod.LAUNCHES,
                "ragged_gamma": ragged_mod.LAUNCHES}
    print(f"engine: kernel launches on the main path {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never ran: {launches}")
    del eng

    # -- cross-check: card vs CPU at a small size ----------------------------
    small, _, _ = synthetic_corpus(num_docs=256, num_topics=16,
                                   num_types=3000, mean_doc_length=60.0,
                                   seed=5)
    scfg = LDAConfig(number_of_topics=16, dense_vocab_threshold=2048,
                     doc_pad_multiple=16, hyper_parameter_optimize_interval=2,
                     seed=0)
    lam0 = np.random.default_rng(7).gamma(100.0, 0.01, (16, 3000))
    runs = {}
    for where in ("cuda", "cpu"):
        e = VariationalBayes(scfg, device=where)
        e.initialize(small, lam_init=lam0)
        runs[where] = [e.learning() for _ in range(3)] + e.learning_many(3)
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"], runs["cpu"]))
    print(f"cross-check: ELBOs card {[round(x, 2) for x in runs['cuda']]} "
          f"cpu {[round(x, 2) for x in runs['cpu']]}, max rel diff "
          f"{rel:.2e} (tolerance {ELBO_RTOL})")
    if not rel <= ELBO_RTOL:
        raise AssertionError("card and CPU engines disagree")

    rg_bound, rg_by = bound(rg["flops"], rg["nbytes"])
    record = {"kernels": [
        {"name": "dense_sstats", "route": "cuda",
         "source": "pylda_tpu_torch/csrc/dense_sstats.cu",
         "replaces": "pylda_tpu/ops/pallas_sstats.py:43",
         "launches": launches["dense_sstats"], "max_abs_err": ss_err,
         "ms": ss_ms, "plain_ms": ss_plain_ms, "bound_ms": ss_bound,
         "bound_by": ss_by, "library_ms": None},
        {"name": "ragged_gamma", "route": "cuda",
         "source": "pylda_tpu_torch/csrc/ragged_gamma.cu",
         "replaces": "pylda_tpu/ops/pallas_ragged.py:56",
         "launches": launches["ragged_gamma"], "max_abs_err": rg["err"],
         "ms": rg["ms"], "plain_ms": rg["plain_ms"], "bound_ms": rg_bound,
         "bound_by": rg_by, "library_ms": None},
    ]}
    print(f"nvidia-smi: {nvidia_smi()}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
