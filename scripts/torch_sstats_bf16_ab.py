"""Times the bf16 dense sufficient statistics at K <= 256 against an older
tree's, in turns.

    git archive <commit> | tar -x -C build/sstats_parent
    PYTHONPATH=. python scripts/torch_sstats_bf16_ab.py \
        --parent build/sstats_parent

On one CUDA card.  ``--parent`` is the root of the older tree: its
``pylda_tpu_torch/csrc/dense_sstats.cu`` (with its headers) is compiled in
both operand modes with the package's nvcc flags into
``build/sstats_bf16_ab/``, and its ``pylda_tpu_torch/ops/sstats.py`` is
loaded under another name to plan and launch it, so the older tree's
whole call is timed, host work included.  This tree's calls go through
its own ``sstats.launch`` at its own plan.  The cases:

- the ragged flagship's counts chunk: the [4096, 10240] bf16 chunk the
  engine plans for the synthetic corpus (K = 100, V = 10,000, 4,096
  documents of 120 tokens, seed 0), and each half of its topics (the
  topic range, lambda split over topics);
- the dense flagship's batch: the [4096, 4096] bf16 counts of the same
  corpus at V = 4,096 (the dense E-step's final pass);
- the ragged chunk at K = 200 and at K = 256 (its counts, expEtheta and
  expElogbeta drawn at those K);

expElogbeta from the planted topics scaled to the corpus's tokens a topic,
expEtheta from a seeded random gamma.  Each case is timed old, new, new,
old in bf16 (CUDA-event means of warm calls, with the call's host work),
then the kernels alone (``torch.profiler``: the device time of every
kernel a call launches, the rounding of expEtheta included), then the
float32 build of both trees at the same case, old, new, new, old.
Prints the card's name and power limit first, then a line a case: the
times, the bound (counts, expEtheta and expElogbeta read once, sstats
written once; 4 K FLOP a nonzero at the bf16 tensor-core rate) and the
dense form's (4 D Vc K FLOP), the new call's plan, its hold against the
plain version (``estep_dense_sstats(compute_dtype="bfloat16")``: the share
of entries past 1e-4 rel + 1e-6 max|ref|, the largest rel error, the
score's), whether two new calls give the same bits, whether a range's
rows are the full call's bits, and whether the two trees' float32 builds
give the same bits.  Then the launches the change leaves, each tree's
bits compared: both builds at K = 300 and 1000 (the cluster kernel) on a
[1216, 25088] cut of the chunk.  ``--variants`` also times scratch
builds of the new kernel with parts taken out (copies of the sources
under ``build/sstats_bf16_variants/``; their results are wrong, only
their times count), and ``--splits 2,3,4`` the new kernel alone at the
flagships with its rows forced into that many splits.  Ends with a JSON
line of the cases.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import importlib.util
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import torch

from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
from pylda_tpu_torch.models import VariationalBayes
from pylda_tpu_torch.ops import _build
from pylda_tpu_torch.ops import sstats as sstats_mod
from pylda_tpu_torch.ops.dirichlet import (
    exp_dirichlet_expectation,
    exp_dirichlet_expectation_fast,
)
from pylda_tpu_torch.ops.estep import estep_dense_sstats
from pylda_tpu_torch.utils.config import LDAConfig
from pylda_tpu_torch.utils.roofline import bound_ms

BF16 = "bfloat16"
DOCS, LENGTH, K, V_RAGGED, V_DENSE = 4096, 120.0, 100, 10_000, 4096
REPS = 30
OUT = _build.BUILD_DIR.parent / "sstats_bf16_ab"
# Scratch builds of the new kernel with a part taken out: (name, the text
# of csrc/dense_sstats_mma.cuh replaced, its replacement).
VARIANTS = (
    ("no step B", "          mma_bf16(acc[i][0], a, b[0], b[1]);\n"
     "          mma_bf16(acc[i][1], a, b[2], b[3]);\n", ""),
    ("no step A mma", "        mma_bf16(ph[0], a, b[0], b[1]);\n"
     "        mma_bf16(ph[1], a, b[2], b[3]);\n"
     "        mma_bf16(ph[2], a, bb[0], bb[1]);\n"
     "        mma_bf16(ph[3], a, bb[2], bb[3]);\n", ""),
    ("no division or log", "      score += (double)(cv * logf(pn));\n"
     "      ratio_s[r * kMmaLdV + c] = __float2bfloat16_rn(cv / pn);\n",
     "      ratio_s[r * kMmaLdV + c] = __float2bfloat16_rn(pn);\n"),
    ("no expEtheta copies", "          __pipeline_memcpy_async(s, etb + "
     "(size_t)d * L.kp + 8 * q, 16);\n", "          ;\n"),
    ("copies and tests only", "    if (!any) continue;\n",
     "    if (any || !any) continue;\n"),
    ("no chunks", "  for (int ci = 0; ci < chunks; ++ci) {\n",
     "  for (int ci = 0; ci < 0; ++ci) {\n"),
)


def cuda_ms(fn, reps: int = REPS) -> float:
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


def kernel_ms(fn, reps: int = REPS) -> float:
    """Device time of every kernel a call launches, from torch.profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.self_device_time_total > 0)
    return us / 1e3 / reps


def compile_trees(jobs) -> list:
    """[{mode: bound library}] of each (root, tag, modes) job's
    dense_sstats.cu, one nvcc a library, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for job, (root, tag, modes) in enumerate(jobs):
        src = root / "pylda_tpu_torch" / "csrc" / "dense_sstats.cu"
        for mode in modes:
            so = OUT / f"lib{tag}-{mode}.so"
            procs.append((job, tag, mode, so, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, *_build.MODES[mode],
                 "-o", str(so), str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    out = [{} for _ in jobs]
    for job, tag, mode, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag} {mode}:\n{log}")
        out[job][mode] = sstats_mod.bind(ctypes.CDLL(str(so)))
    return out


def load_parent_module(root: pathlib.Path):
    spec = importlib.util.spec_from_file_location(
        "parent_sstats", root / "pylda_tpu_torch" / "ops" / "sstats.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def variant_jobs() -> list:
    """(root, tag, modes) of scratch builds of the new kernel with a part
    taken out, bf16 only."""
    jobs = []
    for i, (name, old, new) in enumerate(VARIANTS):
        root = OUT.parent / "sstats_bf16_variants" / f"v{i}"
        shutil.rmtree(root, ignore_errors=True)
        csrc = root / "pylda_tpu_torch" / "csrc"
        shutil.copytree(_build.CSRC, csrc)
        header = csrc / "dense_sstats_mma.cuh"
        text = header.read_text()
        if old not in text:
            raise RuntimeError(f"variant {name!r}: its text is not in the "
                               f"source")
        header.write_text(text.replace(old, new))
        jobs.append((root, f"variant{i}", (BF16,)))
    return jobs


def ragged_chunk(dev):
    corpus, beta, _ = synthetic_corpus(num_docs=DOCS, num_topics=K,
                                       num_types=V_RAGGED,
                                       mean_doc_length=LENGTH, seed=0)
    cfg = LDAConfig(number_of_topics=K, inference_mode="vb", seed=0)
    eng = VariationalBayes(cfg, device=dev)
    lam = (1.0 / V_RAGGED + beta * (corpus.num_tokens / K)).astype(np.float32)
    eng.initialize(corpus, lam_init=lam)
    counts = eng._sstats_plan.chunks[0][0]
    return counts, exp_dirichlet_expectation_fast(eng.state.lam)


def dense_batch(dev):
    """The dense flagship's one counts batch and expElogbeta."""
    corpus, beta, _ = synthetic_corpus(num_docs=DOCS, num_topics=K,
                                       num_types=V_DENSE,
                                       mean_doc_length=LENGTH, seed=0)
    cfg = LDAConfig(number_of_topics=K, inference_mode="vb", seed=0)
    eng = VariationalBayes(cfg, device=dev)
    lam = (1.0 / V_DENSE + beta * (corpus.num_tokens / K)).astype(np.float32)
    eng.initialize(corpus, lam_init=lam)
    (batch,) = eng._batches
    return batch.counts, exp_dirichlet_expectation_fast(eng.state.lam)


def drawn(counts, K_, dev, seed):
    """expEtheta [D, K_] from a seeded gamma and an expElogbeta [K_, V]."""
    rng = np.random.default_rng(seed)
    D, Vc = counts.shape
    et = exp_dirichlet_expectation(torch.tensor(
        rng.gamma(100.0, 0.01, (D, K_)), dtype=torch.float32, device=dev))
    eeb = exp_dirichlet_expectation(torch.tensor(
        rng.gamma(0.1, 1.0, (K_, Vc)) * 100.0 + 0.01, dtype=torch.float32,
        device=dev))
    return et, eeb


def hold(ss, tok, ss_p, tok_p) -> dict:
    diff, atol = (ss - ss_p).abs(), 1e-6 * float(ss_p.abs().max())
    return {"off_share": float((diff > 1e-4 * ss_p.abs() + atol)
                               .double().mean()),
            "max_rel": float((diff / (ss_p.abs() + atol)).max()),
            "score_rel": abs(float(tok) - float(tok_p)) / abs(float(tok_p))}


def case(name, counts, et, eeb, libs, parent, sms, topic_range=None,
         variants=None) -> dict:
    D, Vc = counts.shape
    K_, V = eeb.shape
    k0, k1 = sstats_mod.check_topic_range(topic_range, K_)
    cb = counts.element_size()

    def new(mode, lib=None):
        pl = sstats_mod.plan(D, Vc, K_, sms, topic_range, cb, mode)
        return lambda: sstats_mod.launch(lib or libs["new"][mode], counts,
                                         et, eeb, 1e-30, topic_range, pl)

    def old(mode):
        pl = parent.plan(D, Vc, K_, sms, topic_range, cb)
        return lambda: parent.launch(libs["old"][mode], counts, et, eeb,
                                     1e-30, topic_range, pl)

    row = {"case": name, "shape": [D, Vc], "K": K_,
           "topic_range": [k0, k1], "nonzeros": int((counts != 0).sum())}
    for mode, tag in ((BF16, "bf16"), ("float32", "f32")):
        o, n = old(mode), new(mode)
        row[f"{tag}_ms"] = [cuda_ms(o), cuda_ms(n), cuda_ms(n), cuda_ms(o)]
        row[f"{tag}_kernel_ms"] = [kernel_ms(o), kernel_ms(n), kernel_ms(n),
                                   kernel_ms(o)]
    ss, tok = new(BF16)()
    ss2, tok2 = new(BF16)()
    ss_p, tok_p = estep_dense_sstats(counts, et, eeb, 1e-30, BF16,
                                     topic_range)
    so, _ = old(BF16)()
    n32, t32 = new("float32")()
    o32, to32 = old("float32")()
    torch.cuda.synchronize()
    row["hold"] = hold(ss, tok, ss_p, tok_p)
    row["repeatable"] = torch.equal(ss, ss2) and torch.equal(tok, tok2)
    row["old_new_max_rel"] = float(((ss - so).abs()
                                    / (so.abs() + 1e-30)).max())
    row["f32_bitwise_parent"] = torch.equal(n32, o32) and torch.equal(t32,
                                                                      to32)
    if topic_range is not None:
        full, ftok = sstats_mod.launch(libs["new"][BF16], counts, et, eeb,
                                       1e-30, None, sstats_mod.plan(
                                           D, Vc, K_, sms, None, cb, BF16))
        row["range_bitwise_full"] = (torch.equal(full[k0:k1], ss)
                                     and torch.equal(ftok, tok))
    pl = sstats_mod.plan(D, Vc, K_, sms, topic_range, cb, BF16)
    row["plan"] = {"tiles": pl.tiles, "splits": pl.splits,
                   "rows_per_split": pl.rows_per_split, "kp": pl.kp,
                   "topic_tiles_a_warp": pl.mma_tiles,
                   "smem_bytes": pl.smem_bytes}
    nbytes = (counts.numel() * cb + D * K_ * 4 + K_ * V * 4
              + (k1 - k0) * V * 4)
    flops = (2.0 * K_ + 2.0 * (k1 - k0)) * row["nonzeros"]
    row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, BF16)
    row["dense_form_bound_ms"], _ = bound_ms(
        (2.0 * K_ + 2.0 * (k1 - k0)) * D * Vc, nbytes, BF16)
    if variants:
        row["variants_kernel_ms"] = {
            v: kernel_ms(new(BF16, lib)) for v, lib in variants.items()}
    print(f"{name} [{D}x{Vc}, K={K_}, topics {k0}..{k1 - 1}]: bf16 old/new/"
          f"new/old {' / '.join(f'{x:.4f}' for x in row['bf16_ms'])} ms "
          f"(kernels alone "
          f"{' / '.join(f'{x:.4f}' for x in row['bf16_kernel_ms'])}); "
          f"float32 {' / '.join(f'{x:.4f}' for x in row['f32_ms'])} "
          f"(alone {' / '.join(f'{x:.4f}' for x in row['f32_kernel_ms'])});"
          f" bound {row['bound_ms']:.5f} ({row['bound_by']}), dense form "
          f"{row['dense_form_bound_ms']:.5f}; plan {row['plan']}; hold "
          f"{row['hold']}; repeatable {row['repeatable']}; range bitwise "
          f"the full call's {row.get('range_bitwise_full', '-')}; float32 "
          f"bitwise the parent's {row['f32_bitwise_parent']}"
          + (f"; parts out {row['variants_kernel_ms']}" if variants else ""),
          flush=True)
    return row


def splits_ms(counts, et, eeb, libs, sms, splits) -> float:
    """Kernel-alone ms of the new bf16 call with ``splits`` row splits of
    whole 64-row chunks (the rest of its plan as planned)."""
    D, Vc = counts.shape
    pl = sstats_mod.plan(D, Vc, eeb.shape[0], sms, None,
                         counts.element_size(), BF16)
    chunks = -(-D // sstats_mod.MMA_ROWS)
    per = -(-chunks // splits)
    pl = dataclasses.replace(pl, splits=-(-chunks // per),
                             rows_per_split=per * sstats_mod.MMA_ROWS)
    return kernel_ms(lambda: sstats_mod.launch(libs["new"][BF16], counts, et,
                                               eeb, 1e-30, None, pl))


def left_alone(counts, libs, parent, sms, dev) -> dict:
    """Both builds above K = 256 on a [1216, 25088] cut, each tree's bits."""
    cut = counts[:1216, :25088].contiguous() if counts.shape[1] >= 25088 \
        else counts[:1216].contiguous()
    out = {}
    for K_ in (300, 1000):
        et, eeb = drawn(cut, K_, dev, seed=K_)
        for mode in (BF16, "float32"):
            D, Vc = cut.shape
            a = sstats_mod.launch(libs["new"][mode], cut, et, eeb, 1e-30, None,
                                  sstats_mod.plan(D, Vc, K_, sms, None, 2,
                                                  mode))
            b = parent.launch(libs["old"][mode], cut, et, eeb, 1e-30, None,
                              parent.plan(D, Vc, K_, sms, None, 2))
            torch.cuda.synchronize()
            out[f"K{K_}_{mode}"] = (torch.equal(a[0], b[0])
                                    and torch.equal(a[1], b[1]))
    print(f"above K = 256, each tree's bits equal: {out}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path, required=True)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--splits", default="",
                    help="comma-separated row splits to time the new bf16 "
                         "kernel at (the flagships' full range)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    repo = pathlib.Path(__file__).resolve().parent.parent
    modes = tuple(_build.MODES)
    extra = variant_jobs() if args.variants else []
    built = compile_trees([(args.parent, "parent", modes),
                           (repo, "new", modes)] + extra)
    libs = {"old": built[0], "new": built[1]}
    variants = ({name: b[BF16] for (name, _, _), b in zip(VARIANTS,
                                                          built[2:])}
                if args.variants else None)
    parent = load_parent_module(args.parent)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    counts, eeb = ragged_chunk(dev)
    et, _ = drawn(counts, K, dev, seed=0)
    rows = [case("ragged flagship chunk", counts, et, eeb, libs, parent, sms,
                 variants=variants)]
    for half in ((0, K // 2), (K // 2, K)):
        rows.append(case("ragged flagship chunk, topic half", counts, et,
                         eeb, libs, parent, sms, half))
    dcounts, deeb = dense_batch(dev)
    det, _ = drawn(dcounts, K, dev, seed=1)
    rows.append(case("dense flagship final pass", dcounts, det, deeb, libs,
                     parent, sms, variants=variants))
    for K_ in (200, 256):
        et_k, eeb_k = drawn(counts, K_, dev, seed=K_)
        rows.append(case(f"ragged flagship chunk at K = {K_}", counts, et_k,
                         eeb_k, libs, parent, sms))
    sweep = {}
    for label, (c, e, b) in (("ragged", (counts, et, eeb)),
                             ("dense", (dcounts, det, deeb))):
        for n in filter(None, args.splits.split(",")):
            sweep[f"{label}/{n}"] = splits_ms(c, e, b, libs, sms, int(n))
    if sweep:
        print(f"kernels alone at forced row splits: {sweep}", flush=True)
    alone = left_alone(counts, libs, parent, sms, dev)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi,
                      "cases": rows, "splits_kernel_ms": sweep,
                      "above_256_bitwise": alone}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
