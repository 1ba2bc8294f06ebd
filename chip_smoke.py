#!/usr/bin/env python3
"""Smoke test of pylda_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero):

1. the card: its name and count, and ``nvidia-smi``'s name and power limit;
2. build: every CUDA kernel of the package from ``pylda_tpu_torch/csrc``
   (one ``nvcc`` per source, started together), with nvcc's register and
   shared-memory report;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it, with times from CUDA events and
   bounds from this run's inputs:
   - at the ragged flagship (K=100, V=10,000, D=4096, mean document length
     120): the ragged gamma fixed point on each planner bucket (inner 50,
     threshold 1e-5, patience 6) and the dense sufficient statistics on
     the [4096, 10240] bf16 counts chunk;
   - at the dense flagship (K=100, V=4096, D=4096, the largest vocabulary
     the default dense_vocab_threshold sends down the dense route): the
     dense E-step (gamma fixed point + final pass) on the [4096, 4096]
     bf16 counts batch;
4. engines: ``VariationalBayes`` through ``initialize``, ``learning_many``,
   ``inference`` and ``perplexity`` at each flagship, with the kernel
   launch counters zeroed just before and read just after;
5. CLI: ``pylda_tpu_torch.cli.train``, ``.test`` and ``.infer`` in-process
   on the bundled corpus ``data/de-news-tiny`` (K=10) on the card, with
   their output files checked and the launch counters zeroed and read;
6. cross-check: at a small size, on each route, the engine on the card
   (kernels) and on the CPU (plain versions) give the same ELBOs.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys
import time

# Peak rates of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# float32 outside the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

K, V, D, MEAN_LEN = 100, 10_000, 4096, 120.0
V_DENSE = 4096  # the dense flagship: the default dense_vocab_threshold

# Kernel vs plain version on the card.  Sums run in different orders
# (per-thread f32 accumulation vs cuBLAS blocking), so agreement is to
# f32 reassociation noise.  The gamma fixed points add exit-timing noise:
# a row at the threshold may freeze a sweep apart in the two versions,
# which moves it by at most K * threshold in sum_k |dgamma|; the dense
# E-step's token score, taken at such a gamma, agrees to DENSE_SCORE_RTOL.
SSTATS_RTOL, SSTATS_ATOL_REL, SCORE_RTOL = 1e-4, 1e-6, 1e-5
GAMMA_RTOL = 5e-4
DENSE_SCORE_RTOL = 1e-4
ELBO_RTOL = 1e-4  # card vs CPU engine, small cross-check

REPO = pathlib.Path(__file__).resolve().parent
CLI_OUT = REPO / "build" / "chip_smoke_cli"


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


def zero_launches(mods) -> None:
    for mod in mods.values():
        mod.LAUNCHES = 0


def read_launches(mods) -> dict:
    return {name: mod.LAUNCHES for name, mod in mods.items()}


def check_launched(label: str, counts: dict, needed) -> None:
    print(f"{label}: kernel launches {counts}")
    missing = [k for k in needed if counts[k] < 1]
    if missing:
        raise AssertionError(f"{label}: kernels {missing} never ran")


def run_engine(label, cfg, corpus, test, dev, mods, needed):
    """The main path at one flagship: initialize, learning_many(2) warm,
    learning_many(20) timed, inference and perplexity on held-out docs;
    launch counters zeroed just before and read just after."""
    import numpy as np
    import torch

    from pylda_tpu_torch.models import VariationalBayes

    zero_launches(mods)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = VariationalBayes(cfg, device=dev)
    eng.initialize(corpus)
    torch.cuda.synchronize()
    shapes = [tuple((b.ids if hasattr(b, "ids") else b.counts).shape)
              for b in eng._batches]
    print(f"{label}: initialize {time.perf_counter() - t0:.2f} s, batches "
          f"{shapes}")
    warm = eng.learning_many(2)
    n = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    elbos = eng.learning_many(n)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n
    sweeps = [int(s) for s in eng.last_sweeps]
    print(f"{label}: learning_many({n}) {dt * 1e3:.3f} ms/iteration, "
          f"{corpus.num_docs / dt:.1f} docs/s; sweeps per batch (last "
          f"iteration) {sweeps}")
    allq = warm + elbos
    print(f"{label}: ELBOs {[round(e, 1) for e in allq]}")
    if not all(np.isfinite(allq)) or not allq[-1] > allq[0]:
        raise AssertionError(f"{label}: ELBO not finite or not rising")
    t0 = time.perf_counter()
    ll, gamma = eng.inference(test)
    t_inf = time.perf_counter() - t0
    t0 = time.perf_counter()
    ppl = eng.perplexity(test)
    t_ppl = time.perf_counter() - t0
    if not (np.isfinite(ll) and np.isfinite(ppl)
            and gamma.shape == (test.num_docs, cfg.number_of_topics)
            and np.isfinite(gamma).all()):
        raise AssertionError(f"{label}: held-out inference is not finite")
    print(f"{label}: inference on {test.num_docs} held-out docs "
          f"{t_inf * 1e3:.1f} ms (ll {ll:.1f}), perplexity {ppl:.2f} in "
          f"{t_ppl * 1e3:.1f} ms")
    print(f"{label}: peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    counts = read_launches(mods)
    check_launched(label, counts, needed)
    return counts


def run_cli(mods) -> dict:
    """train -> test -> infer through the CLIs' main() on the card."""
    import numpy as np

    from pylda_tpu_torch.cli import infer as cli_infer
    from pylda_tpu_torch.cli import test as cli_test
    from pylda_tpu_torch.cli import train as cli_train
    from pylda_tpu_torch.corpus.datasets import bundled_corpus_dir

    corpus_dir = bundled_corpus_dir()
    shutil.rmtree(CLI_OUT, ignore_errors=True)
    zero_launches(mods)
    t0 = time.perf_counter()
    rc = cli_train.main([
        f"--input_directory={corpus_dir}", f"--output_directory={CLI_OUT}",
        "--number_of_topics=10", "--training_iterations=6",
        "--snapshot_interval=3", "--dump_gamma",
    ])
    runs = sorted((CLI_OUT / "de-news-tiny").iterdir())
    if rc != 0 or len(runs) != 1:
        raise AssertionError(f"cli train: rc {rc}, run dirs {runs}")
    run = runs[0]
    want = ["exp_beta-3", "exp_beta-6", "model-3", "model-6", "gamma-3",
            "gamma-6", "metrics.jsonl"]
    missing = [f for f in want if not (run / f).exists()]
    lines = (run / "exp_beta-6").read_text().splitlines()
    if missing or lines[0] != "==========\t0\t==========" or len(lines) != 510:
        raise AssertionError(f"cli train outputs: missing {missing}, "
                             f"exp_beta lines {len(lines)}")
    gamma_out = CLI_OUT / "gamma.test"
    rc = cli_test.main([f"--model={run / 'model-6'}",
                        f"--input_directory={corpus_dir}",
                        f"--output_file={gamma_out}", "--point_estimate"])
    gamma = np.loadtxt(gamma_out)
    if rc != 0 or gamma.shape != (100, 10) or not (gamma > 0).all():
        raise AssertionError(f"cli test: rc {rc}, gamma {gamma.shape}")
    docs = CLI_OUT / "docs.txt"
    docs.write_text("government election vote\nrain snow storm weather\n")
    mix = CLI_OUT / "mix.tsv"
    rc = cli_infer.main([f"--model={run / 'model-6'}", f"--input={docs}",
                         f"--output={mix}", "--full"])
    theta = np.loadtxt(mix)
    if rc != 0 or theta.shape != (2, 10) or not np.allclose(
            theta.sum(axis=1), 1.0, rtol=1e-4):
        raise AssertionError(f"cli infer: rc {rc}, theta {theta.shape}")
    print(f"cli: train 6 iterations + test + infer on {corpus_dir} in "
          f"{time.perf_counter() - t0:.2f} s; run dir {run.name}")
    counts = read_launches(mods)
    check_launched("cli", counts, ("dense_gamma", "dense_sstats"))
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
    from pylda_tpu_torch.models import VariationalBayes
    from pylda_tpu_torch.models.vb import _assemble_gamma_device
    from pylda_tpu_torch.ops import _build
    from pylda_tpu_torch.ops import dense_estep as dense_mod
    from pylda_tpu_torch.ops import ragged as ragged_mod
    from pylda_tpu_torch.ops import sstats as sstats_mod
    from pylda_tpu_torch.ops.dirichlet import (
        exp_dirichlet_expectation,
        exp_dirichlet_expectation_fast,
    )
    from pylda_tpu_torch.ops.estep import (
        estep_dense,
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
    mods = {"dense_gamma": dense_mod, "dense_sstats": sstats_mod,
            "ragged_gamma": ragged_mod}

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {_build.SOURCES}")
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "ptxas info" in line and ("registers" in line
                                         or "Compiling entry" in line):
                print(f"  {name}: {line.strip()}")

    # -- kernels at the ragged flagship's shapes ------------------------------
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
    # phinorm and the ratio are needed only where a count is nonzero, and
    # the second product sums over those columns only: 4*K FLOP a nonzero.
    ss_nnz = int((counts != 0).sum())
    ss_bytes = (counts.numel() * counts.element_size() + Dc * K * 4
                + 2 * K * V * 4 + 4)
    ss_bound, ss_by = bound(4.0 * K * ss_nnz, ss_bytes)
    ss_dense_bound, _ = bound(4.0 * Dc * K * V, ss_bytes)
    ss_ms = cuda_ms(lambda: sstats_mod.dense_sstats(counts, et_c, eeb,
                                                    eps=cfg.eps), 20)
    ss_plain_ms = cuda_ms(lambda: estep_dense_sstats(counts, et_c, eeb,
                                                     eps=cfg.eps), 20)
    print(f"kernel dense_sstats [{Dc}x{Vc} {str(counts.dtype)[6:]}, K={K}]: "
          f"nonzero counts {ss_nnz}, kernel_ms {ss_ms:.4f} plain_ms "
          f"{ss_plain_ms:.4f} bound_ms {ss_bound:.5f} ({ss_by}; dense form "
          f"{ss_dense_bound:.5f}), max_abs_err {ss_err:.3e} (tolerance "
          f"{SSTATS_RTOL}*|ref| + {SSTATS_ATOL_REL}*max|ref|), score rel err "
          f"{tok_rel:.3e} (tolerance {SCORE_RTOL}) "
          f"{'ok' if ss_ok else 'FAIL'}")
    if not ss_ok:
        raise AssertionError("dense_sstats disagrees with its plain version")
    del probe, st, eeb, eeb_t, rows_plain, gamma_docs, et_docs, et_c

    # -- kernels at the dense flagship's shapes -------------------------------
    dcorpus, dbeta, _ = synthetic_corpus(
        num_docs=D, num_topics=K, num_types=V_DENSE, mean_doc_length=MEAN_LEN,
        seed=0,
    )
    dlam = (1.0 / V_DENSE
            + dbeta * (dcorpus.num_tokens / K)).astype(np.float32)
    probe = VariationalBayes(cfg, device=dev)
    probe.initialize(dcorpus, lam_init=dlam)
    st = probe.state
    eeb = exp_dirichlet_expectation_fast(st.lam)
    (batch,) = probe._batches
    dc = batch.counts
    g0 = torch.ones((dc.shape[0], K), dtype=torch.float32, device=dev)
    row_sweeps = torch.zeros((dc.shape[0],), dtype=torch.int32, device=dev)
    g_k, ss_k, tok_k, s_k = dense_mod.dense_estep(dc, g0, eeb, st.alpha,
                                                  row_sweeps_out=row_sweeps,
                                                  **kw)
    g_p, _, tok_p, s_p = estep_dense(dc, g0, eeb, st.alpha, **kw)
    ss_at_k, _ = estep_dense_sstats(dc, exp_dirichlet_expectation(g_k), eeb,
                                    eps=cfg.eps)
    torch.cuda.synchronize()
    dg_err = float((g_k - g_p).abs().max())
    dg_ok = bool(((g_k - g_p).abs()
                  <= gamma_atol + GAMMA_RTOL * g_p.abs()).all())
    dss_ok = bool(((ss_k - ss_at_k).abs()
                   <= SSTATS_RTOL * ss_at_k.abs()
                   + SSTATS_ATOL_REL * float(ss_at_k.abs().max())).all())
    dtok_rel = abs(float(tok_k) - float(tok_p)) / abs(float(tok_p))
    sk, sp = int(s_k), int(s_p)
    Dd, Vd = dc.shape
    # The work this input needs: each sweep of a row (frozen sweeps
    # excluded) and the final pass do 4*K FLOP for each nonzero count of
    # the row — phinorm and the ratio are needed only there.  The dense
    # form (every column) is printed beside it.  Bytes: counts, eeb, alpha
    # and gamma0 read once; gamma and sstats written once.
    row_nnz = (dc != 0).sum(dim=1)
    dg_nnz = int(row_nnz.sum())
    row_sweeps_total = int(row_sweeps.sum())
    dg_work = int((row_sweeps.long() * row_nnz).sum()) + dg_nnz
    dg_bytes = (dc.numel() * dc.element_size() + 2 * K * V_DENSE * 4
                + 2 * Dd * K * 4 + K * 4 + 4)
    dg_bound, dg_by = bound(4.0 * K * dg_work, dg_bytes)
    dg_dense_bound, _ = bound(4.0 * K * V_DENSE * (row_sweeps_total + Dd),
                              dg_bytes)
    dg_ms = cuda_ms(lambda: dense_mod.dense_estep(dc, g0, eeb, st.alpha,
                                                  **kw), 5)
    dg_plain_ms = cuda_ms(lambda: estep_dense(dc, g0, eeb, st.alpha, **kw), 2)
    et_k = exp_dirichlet_expectation(g_k)
    fin_ms = cuda_ms(lambda: sstats_mod.dense_sstats(dc, et_k, eeb,
                                                     eps=cfg.eps), 10)
    dg_ok = dg_ok and dss_ok and dtok_rel <= DENSE_SCORE_RTOL and abs(sk - sp) <= 1
    print(f"kernel dense_gamma [{Dd}x{Vd} {str(dc.dtype)[6:]}, K={K}]: sweeps "
          f"kernel {sk} plain {sp}, row-sweeps computed {row_sweeps_total}, "
          f"nonzero counts {dg_nnz} ({dg_nnz / dc.numel():.4f} of the block), "
          f"kernel_ms {dg_ms:.4f} (of which final pass dense_sstats "
          f"{fin_ms:.4f}) plain_ms {dg_plain_ms:.4f} bound_ms {dg_bound:.5f} "
          f"({dg_by}; dense form {dg_dense_bound:.5f}), gamma max_abs_err "
          f"{dg_err:.3e} (tolerance "
          f"{gamma_atol:g} + {GAMMA_RTOL}*|gamma|), sstats at the kernel's "
          f"gamma {'ok' if dss_ok else 'FAIL'} (tolerance {SSTATS_RTOL}*|ref| "
          f"+ {SSTATS_ATOL_REL}*max|ref|), score rel err {dtok_rel:.3e} "
          f"(tolerance {DENSE_SCORE_RTOL}) {'ok' if dg_ok else 'FAIL'}")
    if not dg_ok:
        raise AssertionError("dense_estep disagrees with its plain version")
    del probe, st, eeb, batch, dc, g0, g_k, g_p, ss_k, ss_at_k, et_k, row_nnz

    # -- engines: the main paths ---------------------------------------------
    by_path = {}
    test, _, _ = synthetic_corpus(
        num_docs=1024, num_topics=K, num_types=V, mean_doc_length=MEAN_LEN,
        seed=1, beta=beta,
    )
    by_path["ragged"] = run_engine("engine ragged flagship", cfg, corpus,
                                   test, dev, mods,
                                   ("ragged_gamma", "dense_sstats"))
    dtest, _, _ = synthetic_corpus(
        num_docs=1024, num_topics=K, num_types=V_DENSE,
        mean_doc_length=MEAN_LEN, seed=1, beta=dbeta,
    )
    by_path["dense"] = run_engine("engine dense flagship", cfg, dcorpus,
                                  dtest, dev, mods,
                                  ("dense_gamma", "dense_sstats"))
    del corpus, test, dcorpus, dtest

    # -- CLI on the bundled corpus -------------------------------------------
    by_path["cli"] = run_cli(mods)
    # Each kernel's launches on each main path (each run zeroed just before
    # and read just after), and their sum.
    paths = {name: {path: got[name] for path, got in by_path.items()}
             for name in mods}
    launches = {name: sum(per.values()) for name, per in paths.items()}
    print(f"main paths: kernel launches {paths}")

    # -- cross-check: card vs CPU at a small size, on each route -------------
    for route, v_small in (("ragged", 3000), ("dense", 1000)):
        small, _, _ = synthetic_corpus(num_docs=256, num_topics=16,
                                       num_types=v_small, mean_doc_length=60.0,
                                       seed=5)
        scfg = LDAConfig(number_of_topics=16, dense_vocab_threshold=2048,
                         doc_pad_multiple=16,
                         hyper_parameter_optimize_interval=2, seed=0)
        lam0 = np.random.default_rng(7).gamma(100.0, 0.01, (16, v_small))
        runs = {}
        for where in ("cuda", "cpu"):
            e = VariationalBayes(scfg, device=where)
            e.initialize(small, lam_init=lam0)
            runs[where] = [e.learning() for _ in range(3)] + e.learning_many(3)
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(runs["cuda"], runs["cpu"]))
        print(f"cross-check {route}: ELBOs card "
              f"{[round(x, 2) for x in runs['cuda']]} cpu "
              f"{[round(x, 2) for x in runs['cpu']]}, max rel diff "
              f"{rel:.2e} (tolerance {ELBO_RTOL})")
        if not rel <= ELBO_RTOL:
            raise AssertionError(f"card and CPU engines disagree ({route})")

    rg_bound, rg_by = bound(rg["flops"], rg["nbytes"])
    record = {"kernels": [
        {"name": "dense_sstats", "route": "cuda",
         "source": "pylda_tpu_torch/csrc/dense_sstats.cu",
         "replaces": "pylda_tpu/ops/pallas_sstats.py:43",
         "launches": launches["dense_sstats"],
         "launches_by_path": paths["dense_sstats"], "max_abs_err": ss_err,
         "ms": ss_ms, "plain_ms": ss_plain_ms, "bound_ms": ss_bound,
         "bound_by": ss_by, "dense_form_bound_ms": ss_dense_bound,
         "library_ms": None},
        {"name": "ragged_gamma", "route": "cuda",
         "source": "pylda_tpu_torch/csrc/ragged_gamma.cu",
         "replaces": "pylda_tpu/ops/pallas_ragged.py:56",
         "launches": launches["ragged_gamma"],
         "launches_by_path": paths["ragged_gamma"], "max_abs_err": rg["err"],
         "ms": rg["ms"], "plain_ms": rg["plain_ms"], "bound_ms": rg_bound,
         "bound_by": rg_by, "library_ms": None},
        {"name": "dense_gamma", "route": "cuda",
         "source": "pylda_tpu_torch/csrc/dense_gamma.cu",
         "replaces": "pylda_tpu/ops/pallas_estep.py:97",
         "launches": launches["dense_gamma"],
         "launches_by_path": paths["dense_gamma"], "max_abs_err": dg_err,
         "ms": dg_ms, "plain_ms": dg_plain_ms, "bound_ms": dg_bound,
         "bound_by": dg_by, "dense_form_bound_ms": dg_dense_bound,
         "library_ms": None},
    ]}
    print(f"nvidia-smi: {nvidia_smi()}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
