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
     bf16 counts batch, and its final pass, the dense sufficient
     statistics, alone at the kernel's gamma;
   - at SVI config 4 (K=200, V=50,000, 16,384 documents, minibatches of
     1024) and SVI config 5 (K=1000, V=100,000, 8,192 documents,
     minibatches of 2048, 30 inner sweeps): the ragged gamma fixed point on
     each bucket of one gathered minibatch, one launch a bucket (with the
     rows longer than the slot buffer, their windows a sweep and the
     launch's geometry; at config 5 each bucket's rows fall into segments,
     the chunks the 512 MB estep_memory_budget_mb cuts it into, each
     ending at its own S*: held per segment, and each bucket held against
     the CPU's chunked run, ``segments_card_vs_cpu``) and the dense
     sufficient statistics on its first bf16 counts chunk ([1024, 50176]
     and [1216, 100352]);
   - at K=1000 on the dense flagship's vocabulary (V=4096, 4096
     documents): the dense E-step with its final pass, and the final
     pass's inputs again in the bf16 build (the paths ``dense_k1000`` and
     ``dense_k1000_bf16``, each a window of the launch counters, must
     launch the sstats cluster kernel); at K = 1000 (config 5's chunk and
     this final pass) the sstats calls take the cluster kernel, whose
     lines print its plan, and config 5's chunk is also called with no
     host sync (``sstats_sync_free_check``);
   the dense sufficient statistics are also called twice on each input and
   must return the same bits;
   the two gamma fixed points are held against their plain version run in
   float64 and must return the same bits over two calls, and their lines
   also give S* (the sweeps the batch, or each segment, took), the
   row-sweeps the kernels' row-major order computed past S*, and a
   histogram of each row's first exitable sweep; at the SVI shapes each
   document's share of the bound on the rows still updating at S* is held
   to its share at the float64 gamma;
   the bf16 builds of the three kernels (``compute_dtype="bfloat16"``) at
   the ragged flagship's buckets and chunk, the dense flagship with its
   final pass and SVI config 5's minibatch, each beside the float32 line
   of the same input and held to its plain version with the same rounding
   points: gamma after one pinned sweep, each document's share of the
   bound at the main path's exit rule, sstats at equal inputs and over
   two calls;
4. engines: ``VariationalBayes`` through ``initialize``, ``learning_many``,
   ``inference`` and ``perplexity`` at each flagship, and
   ``StochasticVariationalBayes`` at configs 4 and 5, each at full size
   (epochs timed, one profiled, held-out perplexities); the flagships and
   config 5 again in bf16, each held to its float32 run (ELBO rel 2e-3,
   held-out perplexity rel 5e-3); the kernel launch counters of each
   build zeroed just before and read just after;
   the sampling engines, collapsed Gibbs (``MonteCarlo``) and ``Hybrid``,
   at BASELINE config 3 at full size (K=100, V=30,000, 4,096 documents,
   512 held-out): 16 warm and 16 timed sweeps or iterations, 40 more,
   counts conserved on the card, one under ``torch.profiler`` (busy and
   idle share, device launches), held-out native and point-estimate
   perplexity, peak memory, and the gate hybrid point-estimate
   perplexity <= 1.1x Gibbs's; they are plain PyTorch and must launch no
   kernel build; at Gibbs's buckets each sampler's sweep on the card is
   held to the CPU from the same noise, and the count tables bitwise;
   the scatter route (``sstats_mode="scatter"``: each bucket's gamma
   kernel, then the row scatter ``ops/estep.scatter_sstats`` in plain
   PyTorch, and no sstats kernel): ``estep_ragged`` on the card against
   the CPU at the ragged flagship's largest bucket (pinned sweeps); batch
   VB at the ragged flagship against its dense-sstats run from one lambda
   at pinned sweeps, and SVI at config 4 (16,384 documents) one epoch
   from one lambda, each with the sstats of one batch or minibatch by
   both routes timed; two calls of ``estep_ragged`` at a config-4
   minibatch bitwise equal; SVI at config 4 from a disk-backed
   ``StreamingCorpus`` (the corpus written to a doc.dat under build/)
   bitwise equal to the in-memory run; and ``svi4_full``: SVI at config
   4's published 100,000 documents (auto picks the scatter route, no
   counts matrix; initialize timed, one warm and two timed epochs, one
   profiled, the epoch's device time split into gamma and scatter,
   held-out perplexities, peak memory);
5. CLI: ``pylda_tpu_torch.cli.train``, ``.test`` and ``.infer`` in-process
   on the bundled corpus ``data/de-news-tiny`` (K=10) on the card, with
   ``--inference_mode`` vb and svi and ``--compute_dtype`` float32 and
   bfloat16, with gibbs and hybrid (no kernel), and with svi and
   ``--streaming_input`` (from a copy of the corpus), their output files
   checked and the launch counters zeroed and read;
6. cross-check: at a small size, on each route (the scatter route
   among them), at K=16 and at K=300 (the kernels' wide range), in
   float32 and in bf16, each engine on the card (kernels) and on the CPU
   (plain versions) give the same bounds; at K=5000 the same lambda
   (``card_vs_cpu_checks``).

7. across ranks (``parallel/mesh.py``; one card, so two ranks share it
   over gloo, and NCCL runs at world size 1):
   - ``dist_nccl1``: batch VB at the ragged flagship (3 iterations at
     pinned sweeps) and SVI config 5 (one epoch) under an NCCL group of
     one rank, every all-reduce a real call: lambda bitwise equal to the
     same run without a group, the all-reduces counted, one timed;
   - two ranks of this script (``--dist-rank``) on the card over gloo,
     each launching the kernels on its own documents:
     ``dist_gloo2_vb`` (the ragged flagship split over the ranks, lambda
     bitwise equal across them after every iteration, the sufficient
     statistics and ELBOs held to the one-process card run at pinned
     sweeps), ``dist_gloo2_svi5`` (config 5 process-local: a block of
     4,096 documents a rank, the negotiated geometry, one epoch, held-out
     perplexity falling), ``dist_gloo2_gibbs`` and ``dist_gloo2_hybrid``
     (config 3, 4 sweeps or iterations, counts conserved globally, the
     tables equal across the ranks, no kernel launched);
   - ``cli_dist``: the config-1 CLI in two processes with the process
     flags, ``--process_sharded_input`` and ``--mesh 2,1``, its model-6
     held to the one-process CLI's;
   - ``dist_nccl2``: ``dist_gloo2_vb`` under NCCL on two cards, where
     ``torch.cuda.device_count() >= 2`` (otherwise a line says why not);
   each rank's launches join ``launches_by_path`` and the
   ``collectives_by_path`` line gives each phase's all-reduces beside
   those it must make.

8. lambda split over the mesh's model axis (``parallel/lam_shard.py``;
   ranks share the one card over gloo): ``shard_vocab_vb`` and
   ``shard_topics_vb`` (the ragged flagship at mesh (1, 2): 3 + 3
   iterations at pinned sweeps, the ELBOs and the first step's
   sufficient statistics (Frobenius) held to dist_nccl1's one-process run
   within DIST_REL, the gathered lambda compared, bitwise too; 3
   iterations at default settings held at
   tests/test_sharding.py's bars, and for the topic split 3 in bf16
   held at BF16_ELBO_RTOL; each lambda block checked bitwise
   across its data group and the blocks' tiling after every iteration;
   the all-gather timed), ``shard_vocab_vb_2x2`` (mesh (2, 2), four
   processes, pinned sweeps), ``shard_vocab_svi5`` (config 5 at (1, 2):
   two epochs at its defaults and at pinned sweeps, one in bf16, each
   held to its one-process run on the card) and ``cli_shard`` (config 1
   through the CLI in two processes with ``--mesh 1,2`` and each flag,
   model-6 held to ``cli_dist``'s one-process model and read by the test
   and infer CLIs); every run's launches and collectives (each checked
   against those it must make) join ``launches_by_path`` and
   ``collectives_by_path``, and the topic split's paths must launch the
   sstats kernel's topic range (``dense_sstats_range``).  The kernel
   lines add that range launch, float32 and bf16, at the ragged
   flagship's chunk and config 5's, each half of the topics: bitwise
   equal to the full launch's rows, against the plain version's range.

9. Gibbs and hybrid under a model axis (each rank keeps its block of n_kv
   and lambda, gathers the whole table once a step, counts into its
   block; ranks share the card over gloo), at BASELINE config 3's full
   width (K=100, V=30,000, 4,096 documents, 512 held-out), DIST_SWEEPS
   sweeps or iterations with the slice sampler (Gibbs) or Newton and
   persistent chains (hybrid) every step: ``shard_vocab_gibbs``,
   ``shard_topics_gibbs``, ``shard_vocab_hybrid`` and
   ``shard_topics_hybrid`` at mesh (1, 2), held to the one-process run on
   the card (the whole table, the chains, the held-out perplexity, alpha
   and eta bit for bit; Gibbs's likelihoods too, hybrid's ELBOs within
   DIST_REL), and ``shard_vocab_gibbs_2x2`` (four processes) held so to
   the (2, 1) run ``shard_vocab_gibbs_2x1``; the tables checked after
   every step (blocks bitwise across their data group and tiling (K, V)),
   counts conserved, each step's collectives against those it must make,
   no kernel launched, ms a step, the gather's ms and bytes, peak memory
   a rank; and ``cli_shard`` with ``--inference_mode`` gibbs and hybrid
   (two processes a flag, ten at once with the one-process CLIs): each
   model-6 bit for bit the one-process file.

10. above K = 4096 (the gamma kernels' cluster kernel,
   ``csrc/row_fixed_point_tiled.cuh``, and the sstats cluster kernel;
   every launch there counts in ``<kernel>_wide`` too):
   - ``wide_k_kernels``: each kernel in both builds against its plain
     version at K in WIDE_KS (4100, 5000, 8192, 16384) with the holds of
     the K <= 4096 lines, each bitwise over two calls: the ragged gamma on
     a 256-row bucket of config 5's corpus, the dense E-step at D = 256,
     V = 4096 (each gamma line with the cluster kernel's geometry), the
     cluster kernel's direct plan (which takes K past 65,536) at K = 8192
     on that bucket bitwise the default plan's, the sstats on config 5's first [1216, 100352] chunk at K = 8192
     (25,088 columns at the other K), and its topic range at K = 8192
     over [0, 4096), [4096, 8192) and [1000, 5000), each bitwise the full
     launch's rows;
   - ``wide_k_vb`` (the ragged flagship at K = 8192) and ``wide_k_dense``
     (the dense flagship at K = 5000): 2 warm and 5 timed iterations,
     phase_timings and the roofline, float32 and bf16;
   - ``wide_k_svi5``: SVI on config 5's corpus at K = 8192, float32 and
     bf16: one warm and two timed epochs, one profiled (s an epoch,
     docs/s, idle share, peak memory); the gate: held-out point-estimate
     perplexity falls;
   - ``shard_topics_vb_wide``: the ragged flagship at K = 8192 at mesh
     (1, 2) with ``--shard_topics`` over gloo, WIDE_SHARD_ITERS iterations
     at pinned sweeps: lambda bit for bit the one-process run (the topic
     range entry above 4096 on a main path);
   - ``cli_wide_k_vb`` and ``cli_wide_k_svi``: the three CLIs on
     ``data/de-news-tiny`` at ``--number_of_topics 5000``;
   - the card-vs-CPU cross-check at K = 5000 on a cut corpus (64
     documents), on the ragged, scatter and dense routes in both modes:
     lambda after one step at pinned sweeps (WIDE_F64_FACTOR).

The entry kernel (K <= 4096, a launch whose widest row is past one
block's slot buffer, ``csrc/row_fixed_point_entries.cuh``; its launches
count in ``<kernel>_cluster`` and ``<kernel>_cluster_bf16`` too) runs in
the kernel lines of configs 4 and 5, which print its geometry (cluster
width, entries a CTA, clusters in flight, rows still streamed) and are
held as before (the dense line at K = 1000, given the batch's largest row
nnz as the engine gives it, streams: its table fits half the L2, and the
line prints that route's geometry); ``svi4_full`` prints each gamma launch's
route and geometry at its first minibatch; the SVI paths of configs 4 and
5 (and ``svi4_full``) must launch it, the flagship paths must not; the
kernels' record lists it as ``ragged_gamma_cluster`` (and ``_bf16``).

The bf16 warp-group kernel (K <= 256, a bf16 launch whose widest row fits
a warp group's slots, ``csrc/row_fixed_point_groups.cuh``; its launches
count in ``<kernel>_group_bf16`` too) runs every bf16 launch of both
flagships: their bf16 kernel lines (``ragged_checks_bf16``,
``dense_checks_bf16``) hold it against the plain version and print its
geometry (entries a group, shared memory a CTA of two groups, CTAs an
SM), the flagships' bf16 engine paths must launch it, and the kernels'
record lists it as ``ragged_gamma_group_bf16`` and
``dense_gamma_group_bf16``.

The bf16 build's tensor-core sstats kernel (K <= 256: every bf16 sstats
launch there, ``csrc/dense_sstats_mma.cuh``; its launches count in
``dense_sstats_mma_bf16`` and, for a topic range,
``dense_sstats_range_mma_bf16`` too) runs the bf16 sstats lines of both
flagships and the ragged chunk's topic halves: each prints the route,
the plan (tiles, splits, rows a split, kp, topic tiles a warp, shared
memory a CTA), the kernel's registers (ptxas) and the dense form's bound
beside the nonzeros'; both flagships' bf16 engine paths,
``shard_topics_vb``'s bf16 run and the bf16 CLIs must launch it, and the
kernels' record lists it as ``dense_sstats_mma_bf16`` and
``dense_sstats_range_mma_bf16``.

Beside those phases:

- ``vb_gamma_init``: batch VB at each flagship from each random
  ``gamma_init`` ("gamma", "normal"): the gamma inits drawn on the card
  (mean, std, minimum, the same bits twice), learning_many(6) (the gamma
  kernel launched, the ELBO finite and rising), and held-out inference
  against the CPU plain version handed the card's gamma inits;
- the roofline at every engine cell (the flagships, SVI configs 4 and 5,
  ``svi4_full`` and config 3's Gibbs and hybrid): ``phase_timings``
  beside ``pylda_tpu_torch.utils.roofline``'s bounds, each phase's
  unclipped bound / measured ratio at most 1.05, the state bitwise
  unchanged by the timing;
- ``native_index``: the streaming index pass and ``initialize`` at
  16,384 and at 100,000 documents through the C tokenizer and through
  Python (the tokenizer must build; rows and sidecars bitwise equal);
- ``cli_observability``: train with ``--phase_timing --roofline
  --coherence --tensorboard_dir --profile_dir`` and test
  ``--coherence`` on the bundled corpus (the events, the TensorBoard
  file, a CUDA kernel of the port in the profiler trace).

The line before the kernels' record gives the card's name and power
limit; before it, ``scatter:``, ``roofline:``, ``native:`` and ``dist:``
lines hold those phases' numbers (``shard:`` the lambda-sharding
phases').

The line before the last is the kernels' JSON record (the bf16 builds
as ``<kernel>_bf16``; ``launches_by_path`` names each main path; the
sstats cluster kernel at 256 < K <= 4096 as ``dense_sstats_cluster``,
its launches those of the paths before the range above 4096, which
``dense_sstats_wide`` counts at every K); the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import itertools
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

BF16 = "bfloat16"

K, V, D, MEAN_LEN = 100, 10_000, 4096, 120.0
V_DENSE = 4096  # the dense flagship: the default dense_vocab_threshold
# SVI config 4 (BASELINE.json configs[3]): K=200, vocabulary 50k, a
# 16,384-document synthetic corpus, minibatches of 1024.
SVI_K, SVI_V, SVI_D, SVI_LEN, SVI_BATCH = 200, 50_000, 16_384, 150.0, 1024
# SVI config 5 (BASELINE.json configs[4], as bench_suite.py's config5
# builds it): K=1000, vocabulary 100k, 8,192 documents (seed 4), 256
# held-out (seed 104, same beta), minibatches of 2048, 30 inner sweeps.
SVI5 = dict(K=1000, V=100_000, D=8192, LEN=150.0, BATCH=2048, INNER=30,
            SEED=4, TEST_DOCS=256, TEST_SEED=104)
# The dense E-step in the kernels' wide range: K=1000 at the dense
# flagship's vocabulary.
DENSE_WIDE_K = 1000

# Kernel vs plain version on the card.  Sums run in different orders
# (per-thread f32 accumulation vs cuBLAS blocking), so agreement is to
# f32 reassociation noise.  The gamma fixed points add exit-timing noise:
# a row at the threshold may freeze a sweep apart in the two versions,
# which moves it by at most K * threshold in sum_k |dgamma|; the dense
# E-step's token score, taken at such a gamma, agrees to DENSE_SCORE_RTOL.
SSTATS_RTOL, SSTATS_ATOL_REL, SCORE_RTOL = 1e-4, 1e-6, 1e-5
# The gamma fixed points are held against their plain version run in
# float64: rows that stall (exitable by the stall rule, not done) go on
# updating to the last sweep, and there the float32 plain version itself
# drifts from the float64 result by more than this tolerance (PERF.md's
# tolerance finding).  Its float32 error is printed beside, and both split
# into rows that were done and rows still updating at S*.
GAMMA_RTOL = 5e-4
DENSE_SCORE_RTOL = 1e-4
ELBO_RTOL = 1e-4  # card vs CPU engine, small cross-check
# ... above K = 4096 on the cut corpus (64 documents, 3,840 tokens) the
# bound is mostly the topic side over K V entries, which the kernels do
# not compute, and at the exit rule float32 alone moves it by up to 4.3e-4
# (the CPU plain version in float32 against float64, batch VB at K = 5000
# on the ragged route).  There the card is held on what the E-step moves:
# lambda after one step from one lambda at pinned sweeps (threshold 0,
# PINNED_SWEEPS_WIDE a row), the largest entry's difference relative to
# the largest entry.  With 5000 topics over 3,840 tokens every gamma entry
# is small and float32 reassociation alone moves lambda by up to 1.5e-3
# there (the CPU plain version against float64, batch VB on the ragged
# route; 6.2e-5 card vs CPU on an H100), so card and CPU are each held
# to the CPU run in float64 (in bf16 with the same rounding points): the
# card's gap at most WIDE_F64_FACTOR times the CPU float32 run's, as the
# bf16 kernel holds do (BF16_BOUND_FACTOR), or WIDE_LAM_REL (summation
# order only, SCATTER_CARD_CPU_REL's measure).  A wrong topic tile or
# entry moves lambda by its own size.  The ELBOs are printed beside.
WIDE_LAM_REL, WIDE_F64_FACTOR = 1e-5, 2.0
# Rows still updating at S* stall without converging, so their gamma
# depends on rounding; each such document's share of the bound
# (ops/estep.py::ragged_doc_bound) at the kernel's gamma is held to its
# share at the float64 plain version's gamma, to this relative tolerance:
# at K=1000 the float32 plain version's own share moves by up to 8.0e-5
# (PERF.md), a lost window or topic tile by ~1e-2.
DOC_BOUND_RTOL = 2e-4
# Sweeps of the pinned check (threshold 0, every row held to float64):
# above K = 256 float32 reassociation grows past the tolerance within 12
# sweeps for the float32 plain version too (PERF.md), so the wide range
# is held after 3.
PINNED_SWEEPS, PINNED_SWEEPS_WIDE = 12, 3
# The bf16 builds against their plain version with the same rounding
# points (compute_dtype="bfloat16").  Both round the same values; only f32
# summation order differs, so after ONE pinned sweep gamma agrees to rel
# 1e-5, except on rows where a ratio counts / phinorm lay at a bf16
# rounding midpoint and the two versions' phinorm sums rounded it one bf16
# ulp apart (2^-8): at most BF16_FLIP_ROWS of the live rows (a row of 170
# live slots at K=1000 carries such a ratio more often: 3 of 256 rows on
# the card; without the rounding points every row misses by > 1e-3), each
# within BF16_FLIP_RTOL.  Past one sweep such flips are carried forward, and the
# bf16 map's rows limit-cycle at its noise floor, so at the main path's
# exit rule each document's share of the bound is held to its share at
# the float64 plain version's gamma (same rounding points) within
# DOC_BOUND_RTOL, or within BF16_BOUND_FACTOR times the float32 plain
# version's own gap where that is larger: the plain version shares every
# rounding point and differs from the kernel only in summation order
# (scripts/torch_bf16_bound_gaps.py on the card: both reach 2.2e-4 to
# 3.5e-2 at K = 257 to 4096, kernel / plain 0.70 to 1.5).  The sufficient statistics at equal inputs: every
# entry within the float32 tolerance except at most BF16_FLIP_ENTRIES of
# them (the columns whose ratio flipped), each within BF16_FLIP_RTOL of
# its value; the score (f32 phinorm) as in float32.
BF16_ONE_SWEEP_RTOL = 1e-5
BF16_FLIP_RTOL = 2.0 ** -7
BF16_FLIP_ROWS, BF16_FLIP_ENTRIES = 0.05, 1e-3
BF16_BOUND_FACTOR = 2.0
# The bf16 engines against the same tree's float32 run: the JAX package's
# bars for its bf16 mode (tests/test_vb_engine.py).
BF16_ELBO_RTOL, BF16_PPL_RTOL = 2e-3, 5e-3
# BASELINE config 3 (as bench_suite.py's config3 builds it): collapsed
# Gibbs and the hybrid engine at K=100, vocabulary 30k, 4,096 documents of
# mean length 120 (seed 2), 512 held-out documents of the same beta (seed
# 102), 5 kept sweeps after 3 burn-in; the gate: hybrid point-estimate
# perplexity <= 1.1x Gibbs's.
CFG3 = dict(K=100, V=30_000, D=4096, LEN=120.0, SEED=2, TEST_DOCS=512,
            TEST_SEED=102, SAMPLES=5, BURN_IN=3, EXTRA=40, GATE=1.1)
# BASELINE config 4 at its published size (BASELINE.json configs[3],
# "Wikipedia-100k"): 100,000 documents, as bench_suite.py's config4 builds
# it with num_docs=100_000, and its 512 held-out documents (seed 103, same
# beta).  The [D+1, V_pad] counts matrix would be 10.04 GB in bf16, over
# sstats_dense_total_budget_mb, so the engine takes the scatter route.
SVI4_FULL_D, SVI_TEST_DOCS, SVI_TEST_SEED = 100_000, 512, 103
# The scatter route against the dense-sstats route where both run (summation
# order only): batch VB one E-step from one lambda at pinned sweeps, sstats
# rel (of the largest entry) and ELBO rel; SVI over one epoch, each
# minibatch's update from one lambda, lambda rel.  estep_ragged on the card against the CPU at pinned sweeps:
# sstats (rel of the largest entry) and the score.
SCATTER_SSTATS_REL, SCATTER_ELBO_REL, SCATTER_LAM_REL = 1e-5, 1e-6, 1e-5
SCATTER_CARD_CPU_REL = 1e-5
STREAM_DIR = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_stream"

# The sweep on the card against the CPU from the same noise: a draw within
# an ulp of a boundary may land one topic over (another exp/log/cumsum
# rounding), so z may differ on this share of the documents.
SWEEP_DOC_ALLOWANCE = 1e-3

REPO = pathlib.Path(__file__).resolve().parent
CLI_OUT = REPO / "build" / "chip_smoke_cli"


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def wide_tag(K: int) -> str:
    """"_wide" above K = 4096 (the kernels' cluster and two-pass range),
    the suffix of its kernel lines and launch counts."""
    return "_wide" if K > 4096 else ""


def sweeps_list(s) -> list:
    """A gamma call's sweep counts (one, or one a segment) as ints."""
    return [int(x) for x in s.reshape(-1)]


def sweeps_text(s) -> str:
    """A gamma call's sweep count, or its segments' counts as a list."""
    got = sweeps_list(s)
    return str(got[0]) if s.dim() == 0 else str(got)


def row_s_star(s, segments, rows: int):
    """[rows] each row's exit sweep S*: its segment's, where the launch's
    rows fall into segments."""
    import torch

    if segments is None:
        return torch.full((rows,), int(s), dtype=torch.int64, device=s.device)
    return s.long().repeat_interleave(torch.tensor(segments, device=s.device))


def geometry_text(geo: dict) -> str:
    """A gamma launch's geometry: the bf16 warp-group kernel's (a group of
    warps a row), the entry kernel's (a cluster a row, the row's entries
    split across its CTAs), the cluster kernel's plan above K = 4096, else
    the slot buffer."""
    if geo["route"] == "groups":
        return (f"warp-group kernel: {geo['nmax']} entries a group, "
                f"{geo['smem_bytes']} B a CTA of 2 groups, "
                f"{geo['blocks_per_sm']} CTAs an SM, grid {geo['grid']}")
    if geo["route"] == "entries":
        row = geo["cluster"] * geo["resident"]
        return (f"entry kernel: cluster of {geo['cluster']} CTAs a row, "
                f"{geo['resident']} entries a CTA ({row} a row resident), "
                f"{geo['smem_bytes']} B a CTA, {geo['clusters']} clusters "
                f"in flight, grid {geo['grid']}")
    if geo.get("cluster"):
        return (f"cluster of {geo['cluster']} CTAs, slice {geo['tile']} "
                f"topics, {geo['resident']} entries resident, windows of "
                f"{geo['window']} ({geo['windows']} a sweep of the widest "
                f"row), {geo['smem_bytes']} B a CTA, {geo['clusters']} "
                f"clusters in flight, grid {geo['grid']}")
    return (f"slot buffer {geo['nmax']} entries ({geo['smem_bytes']} B a "
            f"block, {geo['blocks_per_sm']} blocks an SM, grid {geo['grid']})")


def streamed_rows(geo: dict, live):
    """(rows past the slot buffer or the cluster's resident entries, their
    windows a sweep; the entry kernel and the warp-group kernel hold every
    row)."""
    if geo["route"] in ("entries", "groups"):
        return live < 0, int((live > 0).sum())
    if geo.get("cluster"):
        R, W = geo["resident"], max(1, geo["window"])
        nr = live.clamp(max=R)
        windows = int(((nr > 0).long() + (live - nr + W - 1) // W).sum())
        return live > R, windows
    nmax = geo["nmax"]
    streamed = live > nmax
    return streamed, int(((live[streamed] + nmax - 1) // nmax).sum())


def sweep_floor_ms(geo: dict, live, row_sweeps, row_bytes: int,
                   nbytes: float, compute_dtype: str = "float32") -> float:
    """The cluster kernel's floor beside the bound: the inputs read once
    and, for each row, the B rows of its entries past the resident ones
    read once a sweep it needs (``row_bytes`` an entry)."""
    past = (live.long() - geo["resident"]).clamp(min=0)
    sweep_bytes = float((past * row_sweeps.long()).sum()) * row_bytes
    return bound(0.0, nbytes + sweep_bytes, compute_dtype)[0]


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


def bound(flops: float, nbytes: float, compute_dtype: str = "float32"):
    """(least ms, "operations" or "bytes") at one H100's peaks, the port's
    one copy of them (``pylda_tpu_torch.utils.roofline.H100``): float32
    outside the tensor cores, or bf16 products with float32 sums on them
    for the bf16 operand mode, and HBM3 bandwidth."""
    from pylda_tpu_torch.utils.roofline import bound_ms

    return bound_ms(flops, nbytes, compute_dtype)


def exit_report(g_k, g_64, g_32, s_k, s_64, row_exit, row_sweeps, extra,
                gamma_atol, check_updating=True, segments=None):
    """A gamma kernel against its plain version in float64 (and, printed
    only, in float32): (ok, max abs err, text).  The text also gives the
    errors of the rows that were done (frozen before S*) and of those
    still updating at S*, S* (each segment's, where the rows fall into
    ``segments``; each within 1 of the plain version's), the row-sweeps
    the kernel computed past S*, and a histogram of each row's first
    exitable sweep in 10-sweep bins ("never": not within the sweeps it
    ran).  With ``check_updating`` False only the done rows are held to
    the tolerance: the rows still updating at S* are printed (see
    ``ragged_checks``)."""
    g_64 = g_64.float()
    diff = (g_k - g_64).abs()
    done = row_sweeps < row_s_star(s_k, segments, g_k.shape[0])
    held = slice(None) if check_updating else done
    ok = bool((diff <= gamma_atol + GAMMA_RTOL * g_64.abs())[held].all())
    ok = ok and all(abs(a - b) <= 1 for a, b in zip(sweeps_list(s_k),
                                                    sweeps_list(s_64)))
    err, diff32 = float(diff.max()), (g_32 - g_64).abs()
    split = ", ".join(
        f"{name} {int(rows.sum())}: {float(diff[rows].max()):.3e} (f32 plain "
        f"{float(diff32[rows].max()):.3e})"
        for name, rows in (("done rows", done), ("rows updating at S*", ~done))
        if rows.any())
    first = row_exit.long()
    n_bins = (int(first.max()) + 9) // 10
    hist = {f"{10 * b + 1}-{10 * b + 10}":
            int(((first > 10 * b) & (first <= 10 * b + 10)).sum())
            for b in range(n_bins)}
    hist["never"] = int((first == 0).sum())
    text = (f"S* kernel {sweeps_text(s_k)} plain f64 {sweeps_text(s_64)}, "
            f"row-sweeps past S* "
            f"{int(extra)}, first exitable sweep {hist}, max_abs_err vs f64 "
            f"{err:.3e} (f32 plain vs f64 {float(diff32.max()):.3e}; "
            f"tolerance {gamma_atol:g} + {GAMMA_RTOL}*|gamma|; {split})")
    return ok, err, text


def bound_check(ids, cnts, rows, g_k, g_64, g_32, eeb, alpha, doc_bound):
    """Each document's share of the bound (``doc_bound``, in float64) on
    ``rows`` at the kernel's gamma against its share at the float64 plain
    version's gamma: (ok, max rel err, text); the float32 plain version's
    error is printed beside."""
    e64, a64, ids, cnts = eeb.double(), alpha.double(), ids[rows], cnts[rows]
    b_64 = doc_bound(ids, cnts, g_64[rows].double(), e64, a64)

    def rel(g):
        got = doc_bound(ids, cnts, g[rows].double(), e64, a64)
        return float(((got - b_64).abs() / b_64.abs()).max())

    err, err32 = rel(g_k), rel(g_32)
    ok = err <= DOC_BOUND_RTOL
    return ok, err, (f"; rows updating at S* {int(rows.sum())}: their share "
                     f"of the bound rel err vs f64 {err:.3e} (f32 plain "
                     f"{err32:.3e}; tolerance {DOC_BOUND_RTOL}) "
                     f"{'ok' if ok else 'FAIL'}")


def pinned_check(run, K):
    """A gamma kernel at pinned sweeps (threshold 0: PINNED_SWEEPS, above
    K = 256 PINNED_SWEEPS_WIDE) against the float64 plain version, every
    row within 0.0005 + GAMMA_RTOL * |gamma|: (ok, text).  ``run(kind,
    kw)`` returns (gamma, sweeps) of the kernel ("kernel") or the plain
    version in float32 ("f32") or float64 ("f64") with the extra
    arguments kw."""
    n = PINNED_SWEEPS if K <= 256 else PINNED_SWEEPS_WIDE
    kw0 = dict(inner_iterations=n, convergence_threshold=0.0)
    (g_k, s_k), (g_32, _), (g_64, _) = (run(kind, kw0)
                                        for kind in ("kernel", "f32", "f64"))
    diff, diff32 = (g_k - g_64.float()).abs(), (g_32 - g_64.float()).abs()
    ok = int(s_k) == n and bool(
        (diff <= 5e-4 + GAMMA_RTOL * g_64.abs()).all())
    return ok, (f"; pinned {n} sweeps at threshold 0: max_abs_err vs f64 "
                f"{float(diff.max()):.3e} (f32 plain {float(diff32.max()):.3e}"
                f"; tolerance 0.0005 + {GAMMA_RTOL}*|gamma|, every row) "
                f"{'ok' if ok else 'FAIL'}")


def sstats_agree(ss, ss_p, compute_dtype):
    """(the entries within the sstats bars, the largest error, the
    entries past the float32 tolerance SSTATS_RTOL |ref| + SSTATS_ATOL_REL
    max |ref|): in float32 none may be past it; in bf16 at most
    BF16_FLIP_ENTRIES of them, each within BF16_FLIP_RTOL |ref| + that
    atol (ratios rounded one bf16 ulp apart)."""
    diff = (ss - ss_p).abs()
    atol = SSTATS_ATOL_REL * float(ss_p.abs().max())
    off = diff > SSTATS_RTOL * ss_p.abs() + atol
    if compute_dtype == BF16:
        ok = float(off.float().mean()) <= BF16_FLIP_ENTRIES and bool(
            (diff <= BF16_FLIP_RTOL * ss_p.abs() + atol).all())
    else:
        ok = not bool(off.any())
    return ok, float(diff.max()), off


def mma_registers() -> dict:
    """Registers a thread of each instance of the bf16 build's tensor-core
    sstats kernel ("<counts type>/<topic tiles a warp>"), from ptxas -v
    in this process's build log (empty if it was not built here)."""
    from pylda_tpu_torch.ops import _build

    out, name = {}, None
    for line in _build.BUILD_LOGS.get("dense_sstats/bfloat16",
                                      "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        k = name and re.search(r"dense_sstats_mma_kernel\w*?I(13__nv_bfloat16"
                               r"|f)Li(\d+)E", name)
        if m and k:
            ct = "bf16" if k.group(1) != "f" else "f32"
            out[f"{ct}/{k.group(2)}"] = int(m.group(1))
            name = None
    return out


def sstats_check(label, counts, et, eeb, eps, sstats_mod, plain,
                 compute_dtype="float32") -> dict:
    """The dense sstats kernel (the build of ``compute_dtype``) against its
    plain version on one input: tolerances, two calls bitwise equal,
    times and bounds; raises if it disagrees.  The record of the shape."""
    import torch

    mode = dict(eps=eps, compute_dtype=compute_dtype)
    ss_k, tok_k = sstats_mod.dense_sstats(counts, et, eeb, **mode)
    ss_k2, tok_k2 = sstats_mod.dense_sstats(counts, et, eeb, **mode)
    ss_p, tok_p = plain(counts, et, eeb, **mode)
    torch.cuda.synchronize()
    same = torch.equal(ss_k, ss_k2) and torch.equal(tok_k, tok_k2)
    ok, err, off = sstats_agree(ss_k, ss_p, compute_dtype)
    tok_rel = abs(float(tok_k) - float(tok_p)) / abs(float(tok_p))
    ok = ok and tok_rel <= SCORE_RTOL
    flips = ""
    if compute_dtype == BF16:
        flips = (f", entries past the float32 tolerance {int(off.sum())} "
                 f"({float(off.float().mean()):.2e} of them; at most "
                 f"{BF16_FLIP_ENTRIES}, each within {BF16_FLIP_RTOL:g}*|ref|: "
                 f"ratios rounded one bf16 ulp apart)")
    D, Vc = counts.shape
    K, V = eeb.shape
    # phinorm and the ratio are needed only where a count is nonzero, and
    # the second product sums over those columns only: 4*K FLOP a nonzero.
    nnz = int((counts != 0).sum())
    nbytes = counts.numel() * counts.element_size() + D * K * 4 + 2 * K * V * 4 + 4
    b_ms, b_by = bound(4.0 * K * nnz, nbytes, compute_dtype)
    dense_ms, _ = bound(4.0 * D * K * V, nbytes, compute_dtype)
    k_ms = cuda_ms(lambda: sstats_mod.dense_sstats(counts, et, eeb, **mode), 20)
    p_ms = cuda_ms(lambda: plain(counts, et, eeb, **mode), 20)
    pl = sstats_mod.plan(D, Vc, K, torch.cuda.get_device_properties(
        counts.device).multi_processor_count,
        count_bytes=counts.element_size(), compute_dtype=compute_dtype)
    grid = (f"{pl.tiles} tiles of {pl.cols} columns x {pl.splits} splits, "
            f"kp {pl.kp}")
    extra = {}
    if pl.mma:
        # The tensor-core kernel, after one launch rounding expEtheta to
        # bf16 ([D, kp]: D K 4 bytes read, D kp 2 written).
        regs = mma_registers()
        extra = {"route": "mma", "rows_per_split": pl.rows_per_split,
                 "topic_tiles_a_warp": pl.mma_tiles,
                 "smem_bytes": pl.smem_bytes, "registers": regs,
                 "launches_a_call": 2,
                 "rounding_bytes": D * K * 4 + D * pl.kp * 2}
        grid = (f"route mma (tensor cores): {pl.tiles} tiles of {pl.cols} "
                f"columns x {pl.splits} splits of {pl.rows_per_split} rows, "
                f"kp {pl.kp}, {pl.mma_tiles} topic tiles a warp, "
                f"{pl.smem_bytes} bytes of shared memory a CTA, registers "
                f"{regs}; expEtheta rounded to bf16 by a launch of its own "
                f"({extra['rounding_bytes'] / 1e6:.2f} MB)")
    if pl.wide:
        geo = {}
        sstats_mod.launch(sstats_mod._lib(compute_dtype), counts, et, eeb,
                          eps, geometry_out=geo)
        extra = {"cluster": pl.cluster, "slice": pl.slice,
                 "batch_capacity": pl.batch,
                 "batches": sstats_mod.wide_batches(counts, pl),
                 "clusters_in_flight": geo["clusters"],
                 "smem_bytes": geo["smem_bytes"], "direct": pl.direct}
        grid = (f"{pl.tiles} tiles of {pl.cols} columns, clusters of "
                f"{pl.cluster} CTAs ({geo['clusters']} in flight) of "
                f"{pl.slice} topics each, batches of up to {pl.batch} "
                f"nonzeros ({extra['batches']} batches), "
                f"{geo['smem_bytes']} bytes of shared memory a CTA"
                f"{', direct' if pl.direct else ''}")
    route = "_wide" if pl.wide else "_mma" if pl.mma else ""
    print(f"kernel dense_sstats{route}"
          f"{'' if compute_dtype == 'float32' else '_bf16'} "
          f"{label} [{D}x{Vc} {str(counts.dtype)[6:]}, K={K}]: grid "
          f"{grid}, scratch {pl.scratch_bytes / 1e6:.1f} MB, "
          f"nonzero counts {nnz}, kernel_ms {k_ms:.4f} plain_ms "
          f"{p_ms:.4f} bound_ms {b_ms:.5f} ({b_by}; dense form "
          f"{dense_ms:.5f}), max_abs_err {err:.3e} (tolerance {SSTATS_RTOL}"
          f"*|ref| + {SSTATS_ATOL_REL}*max|ref|{flips}), score rel err "
          f"{tok_rel:.3e} "
          f"(tolerance {SCORE_RTOL}), two calls bitwise equal {same} "
          f"{'ok' if ok and same else 'FAIL'}")
    if not ok:
        raise AssertionError(f"dense_sstats disagrees with its plain version "
                             f"({label})")
    if not same:
        raise AssertionError(f"dense_sstats is not repeatable ({label})")
    return {"name": label, "shape": [D, Vc], "K": K, "nonzeros": nnz,
            "max_abs_err": err, "score_rel_err": tok_rel, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "dense_form_bound_ms": dense_ms, "columns_a_tile": pl.cols,
            "splits": pl.splits, "scratch_bytes": pl.scratch_bytes, **extra}


def sstats_range_check(label, counts, et, eeb, eps, sstats_mod, plain,
                       compute_dtype="float32", ranges=None) -> list:
    """The dense sstats kernel's topic-range launch (lambda split over
    topics) on one input, at each half of [0, K) (or at ``ranges``): its
    rows bitwise equal
    to the full launch's rows and its score to the full score, two calls
    bitwise equal, and against the plain version's range at
    ``sstats_check``'s tolerances; times and bounds beside the full
    launch's.  Raises if it disagrees; returns a record a half."""
    import torch

    mode = dict(eps=eps, compute_dtype=compute_dtype)
    D, Vc = counts.shape
    K, V = eeb.shape
    ss_f, tok_f = sstats_mod.dense_sstats(counts, et, eeb, **mode)
    full_ms = cuda_ms(lambda: sstats_mod.dense_sstats(counts, et, eeb,
                                                      **mode), 20)
    nnz = int((counts != 0).sum())
    pl = sstats_mod.plan(D, Vc, K, torch.cuda.get_device_properties(
        counts.device).multi_processor_count,
        count_bytes=counts.element_size(), compute_dtype=compute_dtype)
    suffix = ("_wide" if pl.wide else "_mma" if pl.mma else "") + (
        "" if compute_dtype == "float32" else "_bf16")
    out = []
    for k0, k1 in ranges or ((0, K // 2), (K // 2, K)):
        rng = dict(mode, topic_range=(k0, k1))
        ss, tok = sstats_mod.dense_sstats(counts, et, eeb, **rng)
        ss2, tok2 = sstats_mod.dense_sstats(counts, et, eeb, **rng)
        ss_p, tok_p = plain(counts, et, eeb, **rng)
        torch.cuda.synchronize()
        bitwise = (torch.equal(ss, ss_f[k0:k1]) and torch.equal(tok, tok_f)
                   and torch.equal(ss, ss2) and torch.equal(tok, tok2))
        ok, err, _ = sstats_agree(ss, ss_p, compute_dtype)
        ok = ok and (abs(float(tok) - float(tok_p))
                     <= SCORE_RTOL * abs(float(tok_p)))
        # phinorm over all K topics and the sums over the range's: 2 K +
        # 2 (k1 - k0) FLOP a nonzero; the counts, expEtheta and
        # expElogbeta read once, the range's rows written once.
        nbytes = (counts.numel() * counts.element_size() + D * K * 4
                  + K * V * 4 + (k1 - k0) * V * 4 + 4)
        b_ms, b_by = bound((2.0 * K + 2.0 * (k1 - k0)) * nnz, nbytes,
                           compute_dtype)
        k_ms = cuda_ms(lambda: sstats_mod.dense_sstats(counts, et, eeb,
                                                       **rng), 20)
        p_ms = cuda_ms(lambda: plain(counts, et, eeb, **rng), 20)
        print(f"kernel dense_sstats_range{suffix} {label} [{D}x{Vc}, K={K}, "
              f"topics {k0}..{k1 - 1}]: kernel_ms {k_ms:.4f} (full range "
              f"{full_ms:.4f}) plain_ms {p_ms:.4f} bound_ms {b_ms:.5f} "
              f"({b_by}), max_abs_err {err:.3e}, rows and score bitwise equal "
              f"to the full launch's and over two calls {bitwise} "
              f"{'ok' if ok and bitwise else 'FAIL'}")
        if not (ok and bitwise):
            raise AssertionError(f"dense_sstats topic range {k0}..{k1} "
                                 f"({label}) disagrees")
        out.append({"name": label, "shape": [D, Vc], "K": K,
                    "route": ("wide" if pl.wide else "mma" if pl.mma
                              else "one_pass"),
                    "topic_range": [k0, k1], "max_abs_err": err, "ms": k_ms,
                    "full_range_ms": full_ms, "plain_ms": p_ms,
                    "bound_ms": b_ms, "bound_by": b_by,
                    "bitwise_to_full": bitwise})
    return out


def ragged_checks(label, batches, eeb, eeb_t, alpha, kw, gamma_atol, dev,
                  ragged_mod, plain, doc_bound, pinned=False):
    """The ragged gamma kernel on each bucket against its plain version in
    float64 (``exit_report``), timed; raises if one disagrees.  Returns
    the record of the shape (summed over the buckets) and the plain
    float32 gammas.

    ``pinned``: rows that stall without being done go on updating to the
    last sweep, and their gamma then depends on rounding for any float32
    code (at SVI config 4 the float32 plain version drifts from float64
    there by more than the tolerance, PERF.md).  So at the main path's
    settings S* and the done rows are held to float64, the rows still
    updating are held by their share of the bound (``doc_bound``, to
    DOC_BOUND_RTOL), and every row is held to float64 at pinned sweeps
    (12 sweeps at threshold 0: no freezing, no exit), where the
    trajectories compare exactly.  A bucket whose rows fall into segments
    (``b.segments``: the chunks the CPU's layout makes; on the card one
    launch) runs so in both, each segment held to its own S*.  Two calls
    must give the same bits.  Each line gives the launch's geometry
    (``geometry_text``) and the rows that stream past the buffer or the
    cluster's resident entries with their windows a sweep."""
    import torch

    K, V = eeb.shape
    rg = dict(name=label, ms=0.0, plain_ms=0.0, flops=0.0, nbytes=0.0,
              max_abs_err=0.0, rows=0, streamed_rows=0, windows=0,
              launches=len(batches), doc_bound_rel_err=None)
    rows_plain = []
    for i, b in enumerate(batches):
        Db, Tb = b.ids.shape
        seg = getattr(b, "segments", None)
        srows = getattr(b, "seg_rows", None)
        g0 = torch.ones((Db, K), dtype=torch.float32, device=dev)
        slots = torch.zeros((1,), dtype=torch.int64, device=dev)
        extra = torch.zeros((1,), dtype=torch.int64, device=dev)
        row_exit = torch.zeros((Db,), dtype=torch.int32, device=dev)
        row_sweeps = torch.zeros_like(row_exit)
        geo = {}
        g_k, s_k = ragged_mod.ragged_gamma(b.ids, b.cnts, g0, eeb, alpha,
                                           eeb_t=eeb_t, slots_out=slots,
                                           extra_sweeps_out=extra,
                                           row_exit_out=row_exit,
                                           row_sweeps_out=row_sweeps,
                                           geometry_out=geo, segments=seg,
                                           seg_rows=srows, **kw)
        g_k2, _ = ragged_mod.ragged_gamma(b.ids, b.cnts, g0, eeb, alpha,
                                          eeb_t=eeb_t, segments=seg,
                                          seg_rows=srows, **kw)
        g_p, s_p = plain(b.ids, b.cnts, g0, eeb, alpha, segments=seg, **kw)
        g_64, s_64 = plain(b.ids, b.cnts.double(), g0.double(), eeb.double(),
                           alpha.double(), segments=seg, **kw)
        torch.cuda.synchronize()
        ok, err, fp_text = exit_report(g_k, g_64, g_p, s_k, s_64, row_exit,
                                       row_sweeps, extra, gamma_atol,
                                       check_updating=not pinned,
                                       segments=seg)
        bitwise = bool(torch.equal(g_k, g_k2))
        ok = ok and bitwise
        del g_k2
        fp_text += f", two calls bitwise equal {bitwise}"
        if seg is not None:
            fp_text += f", segments {list(seg)}"
        live = (b.cnts != 0).sum(dim=1)
        if pinned:
            updating = (row_sweeps >= row_s_star(s_k, seg, Db)) & (live > 0)
            if updating.any():
                ok_b, rel, text = bound_check(b.ids, b.cnts, updating, g_k,
                                              g_64, g_p, eeb, alpha,
                                              doc_bound)
                fp_text += text
                ok = ok and ok_b
                rg["doc_bound_rel_err"] = max(rel, rg["doc_bound_rel_err"]
                                              or 0.0)
        del g_64
        if pinned:
            def run(kind, kw0, b=b, g0=g0):
                if kind == "kernel":
                    return ragged_mod.ragged_gamma(b.ids, b.cnts, g0, eeb,
                                                   alpha, eeb_t=eeb_t,
                                                   **dict(kw, **kw0))
                dt = torch.float64 if kind == "f64" else torch.float32
                return plain(b.ids, b.cnts.to(dt), g0.to(dt), eeb.to(dt),
                             alpha.to(dt), **dict(kw, **kw0))

            ok0, text = pinned_check(run, K)
            fp_text += text
            ok = ok and ok0
        rows = int((live > 0).sum())
        nmax = geo["nmax"]
        streamed, windows = streamed_rows(geo, live)
        # Bytes: ids and counts, the table rows of the chunk's distinct
        # live ids, alpha and gamma0 read once; gamma written once.  Above
        # K = 4096 a row the cluster cannot keep resident reads its
        # streamed entries' B rows once a sweep at least: that floor is
        # printed beside.
        rows_needed = int(torch.unique(b.ids[b.cnts != 0]).numel())
        flops = 4.0 * K * int(slots)
        nbytes = Db * Tb * 8 + rows_needed * K * 4 + 2 * Db * K * 4 + K * 4
        b_ms, b_by = bound(flops, nbytes)
        floor_text = ""
        if geo["route"] == "cluster":
            floor = sweep_floor_ms(geo, live, row_sweeps,
                                   eeb_t.shape[1] * 4, nbytes)
            rg["sweep_floor_ms"] = rg.get("sweep_floor_ms", 0.0) + floor
            floor_text = (f"; one HBM read a sweep of the entries past the "
                          f"resident ones {floor:.5f} ms")
        k_ms = cuda_ms(lambda: ragged_mod.ragged_gamma(
            b.ids, b.cnts, g0, eeb, alpha, eeb_t=eeb_t, segments=seg,
            seg_rows=srows, **kw), 20)
        p_ms = cuda_ms(lambda: plain(b.ids, b.cnts, g0, eeb, alpha,
                                     segments=seg, **kw), 3)
        print(f"kernel ragged_gamma{wide_tag(K)} {label} bucket {i} "
              f"[{Db}x{Tb}, K={K}]: "
              f"sweeps plain f32 {sweeps_text(s_p)}, {fp_text}, real slots "
              f"processed {int(slots)}, {geometry_text(geo)}, rows streamed "
              f"past it {int(streamed.sum())} of {rows} ({windows} windows a "
              f"sweep), kernel_ms {k_ms:.4f} "
              f"plain_ms {p_ms:.4f} bound_ms {b_ms:.5f} ({b_by}{floor_text}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"ragged_gamma {label} bucket {i} disagrees "
                                 f"with its plain version")
        rg["ms"] += k_ms
        rg["plain_ms"] += p_ms
        rg["flops"] += flops
        rg["nbytes"] += nbytes
        rg["max_abs_err"] = max(rg["max_abs_err"], err)
        rg["rows"] += rows
        rg["streamed_rows"] += int(streamed.sum())
        rg["windows"] += windows
        rg.update(nmax=nmax, smem_bytes=geo["smem_bytes"],
                  blocks_per_sm=geo["blocks_per_sm"],
                  routes=rg.get("routes", []) + [geo["route"]],
                  **{f: geo[f] for f in ("cluster", "tile", "resident",
                                         "window", "clusters")
                     if geo.get("cluster")})
        rows_plain.append(g_p)
    rg["bound_ms"], rg["bound_by"] = bound(rg["flops"], rg["nbytes"])
    print(f"kernel ragged_gamma{wide_tag(K)} {label}: {rg['launches']} "
          f"launches, "
          f"{rg['ms']:.4f} ms (bound {rg['bound_ms']:.5f}, {rg['bound_by']}), "
          f"routes {rg['routes']}, "
          f"rows streamed past the slot buffer or the resident entries "
          f"({rg['nmax'] or rg.get('resident')} entries at K={K}) "
          f"{rg['streamed_rows']} of {rg['rows']}, {rg['windows']} windows a "
          f"sweep")
    return rg, rows_plain


def segments_card_vs_cpu(label, buckets, eeb, eeb_t, alpha, kw, gamma_atol,
                         dev, ragged_mod, plain, doc_bound) -> dict:
    """The card's whole buckets with segments against the CPU's chunked
    run: each bucket whose rows fall into segments (the chunks
    ``estep_memory_budget_mb`` cuts it into) runs in one kernel launch on
    the card, and on the CPU as the CPU engine runs it, each chunk its own
    call of the plain version in float32.  Each segment's S* within 1 of
    its chunk's; the rows done by S* within ``gamma_atol`` + GAMMA_RTOL *
    |gamma| of the CPU's; the rows still updating at S* by their share of
    the bound against the float64 plain version's (DOC_BOUND_RTOL, the
    CPU's printed beside), as ``ragged_checks`` holds them.  Raises if one
    disagrees; returns the segments' S* on both sides and the errors."""
    import torch

    K = eeb.shape[0]
    eeb_c, alpha_c = eeb.cpu(), alpha.cpu()
    out = {"s_star_card": [], "s_star_cpu": [], "max_abs_err_done": 0.0,
           "doc_bound_rel_err": 0.0, "cpu_s": 0.0}
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        for i, b in enumerate(buckets):
            seg = getattr(b, "segments", None)
            if seg is None:
                continue
            Db = b.ids.shape[0]
            g0 = torch.ones((Db, K), dtype=torch.float32, device=dev)
            row_sweeps = torch.zeros((Db,), dtype=torch.int32, device=dev)
            g_k, s_k = ragged_mod.ragged_gamma(
                b.ids, b.cnts, g0, eeb, alpha, eeb_t=eeb_t,
                row_sweeps_out=row_sweeps, segments=seg,
                seg_rows=b.seg_rows, **kw)
            ids_c, cnts_c = b.ids.cpu(), b.cnts.cpu()
            t0 = time.perf_counter()
            chunks, r0 = [], 0
            for n in seg:
                chunks.append(plain(ids_c[r0:r0 + n], cnts_c[r0:r0 + n],
                                    torch.ones((n, K)), eeb_c, alpha_c, **kw))
                r0 += n
            out["cpu_s"] += time.perf_counter() - t0
            g_c = torch.cat([g for g, _ in chunks]).to(dev)
            s_c = [int(sw) for _, sw in chunks]
            g_64, _ = plain(b.ids, b.cnts.double(), g0.double(), eeb.double(),
                            alpha.double(), segments=seg, **kw)
            torch.cuda.synchronize()
            s_card = sweeps_list(s_k)
            ok = all(abs(a - c) <= 1 for a, c in zip(s_card, s_c))
            live = (b.cnts != 0).sum(dim=1)
            done = row_sweeps < row_s_star(s_k, seg, Db)
            diff = (g_k - g_c).abs()
            err = float(diff[done].max()) if done.any() else 0.0
            ok = ok and bool((diff <= gamma_atol
                              + GAMMA_RTOL * g_c.abs())[done].all())
            updating = ~done & (live > 0)
            text = ""
            if updating.any():
                ok_b, rel, text = bound_check(b.ids, b.cnts, updating, g_k,
                                              g_64, g_c, eeb, alpha,
                                              doc_bound)
                ok = ok and ok_b
                out["doc_bound_rel_err"] = max(out["doc_bound_rel_err"], rel)
            out["s_star_card"].append(s_card)
            out["s_star_cpu"].append(s_c)
            out["max_abs_err_done"] = max(out["max_abs_err_done"], err)
            print(f"segments {label} bucket {i} [{Db}x{b.ids.shape[1]}, "
                  f"K={K}] on {nvidia_smi()}: one launch of {len(seg)} "
                  f"segments {list(seg)} against the CPU's {len(seg)} chunk "
                  f"calls: S* card {s_card} CPU {s_c}; rows done by S* "
                  f"{int(done.sum())}: max abs err vs the CPU {err:.3e} "
                  f"(tolerance {gamma_atol:g} + {GAMMA_RTOL}*|gamma|){text} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"segments {label} bucket {i}: the "
                                     f"card's whole bucket disagrees with "
                                     f"the CPU's chunked run")
    finally:
        torch.set_num_threads(threads)
    return out


def bf16_gamma_check(run, ids, cnts, eeb, alpha, doc_bound, kw):
    """A gamma kernel's bf16 build against its plain version with the same
    rounding points: after one pinned sweep, gamma (BF16_ONE_SWEEP_RTOL,
    flipped rows apart); at the main path's exit rule ``kw``, each live
    row's share of the bound against the float64 plain version's
    (DOC_BOUND_RTOL, or BF16_BOUND_FACTOR times the float32 plain
    version's gap).  ``run(kind, kw)`` returns (gamma, sweeps) of the
    bf16 build ("kernel"), or of the plain version in bf16 mode in
    float32 ("plain") or float64 ("f64"), or in float32 mode ("f32",
    printed only: it lacks the rounding points).  ``ids``/``cnts`` are
    the rows' live entries.  Returns (ok, max abs err after one sweep,
    share rel err, text, the plain version's gamma at ``kw``)."""
    import torch

    live = (cnts != 0).any(dim=1)
    if not live.any():  # a chunk of padding rows only
        return True, 0.0, 0.0, "no live rows", run("plain", kw)[0]
    kw1 = dict(kw, inner_iterations=1, convergence_threshold=0.0)
    (g_k, _), (g_p, _), (g_32, _) = (run(kind, kw1)
                                     for kind in ("kernel", "plain", "f32"))
    rel = ((g_k - g_p).abs() / g_p.abs()).amax(dim=1)[live]
    rel32 = float(((g_32 - g_p).abs() / g_p.abs()).max())
    flipped = rel > BF16_ONE_SWEEP_RTOL
    ok = (float(flipped.float().mean()) <= BF16_FLIP_ROWS
          and float(rel.max()) <= BF16_FLIP_RTOL)
    err = float((g_k - g_p).abs().max())
    (g_k, s_k), (g_p, s_p), (g_64, s_64) = (run(kind, kw)
                                            for kind in ("kernel", "plain",
                                                         "f64"))
    e64, a64 = eeb.double(), alpha.double()
    ids, cnts = ids[live], cnts[live].double()
    b_64 = doc_bound(ids, cnts, g_64[live].double(), e64, a64)

    def share_err(g):
        got = doc_bound(ids, cnts, g[live].double(), e64, a64)
        return float(((got - b_64).abs() / b_64.abs()).max())

    eb, eb_p = share_err(g_k), share_err(g_p)
    bar = max(DOC_BOUND_RTOL, BF16_BOUND_FACTOR * eb_p)
    ok = ok and eb <= bar
    text = (f"one pinned sweep: max rel err vs the plain version (same "
            f"rounding) {float(rel.max()):.3e}, rows past "
            f"{BF16_ONE_SWEEP_RTOL:g} {int(flipped.sum())} of {int(live.sum())}"
            f" (at most {BF16_FLIP_ROWS:g} of them, each within "
            f"{BF16_FLIP_RTOL:g}; float32 mode's plain version {rel32:.3e}); "
            f"exit rule: S* kernel {sweeps_text(s_k)} plain "
            f"{sweeps_text(s_p)} plain f64 {sweeps_text(s_64)}, each row's "
            f"share of the bound rel err vs f64 "
            f"{eb:.3e} (plain {eb_p:.3e}; tolerance {bar:.3e}: "
            f"{DOC_BOUND_RTOL} or {BF16_BOUND_FACTOR:g} x the plain "
            f"version's)")
    return ok, err, eb, text, g_p


def ragged_checks_bf16(label, batches, eeb, alpha, kw, dev, ragged_mod,
                       plain, doc_bound, f32_line):
    """The ragged gamma kernel's bf16 build on each bucket
    (``bf16_gamma_check``), timed beside the float32 line of the same
    input (``f32_line``, a ``ragged_checks`` record); raises if one
    disagrees.  Returns the record of the shape (summed over the buckets)
    and the plain version's gammas."""
    import torch

    K, V = eeb.shape
    eeb_t = ragged_mod.gather_table(eeb, BF16)
    rg = dict(name=label, ms=0.0, plain_ms=0.0, flops=0.0, nbytes=0.0,
              max_abs_err=0.0, doc_bound_rel_err=0.0, rows=0,
              streamed_rows=0, windows=0, launches=len(batches))
    rows_plain = []
    for i, b in enumerate(batches):
        Db, Tb = b.ids.shape
        seg = getattr(b, "segments", None)
        srows = getattr(b, "seg_rows", None)
        g0 = torch.ones((Db, K), dtype=torch.float32, device=dev)

        def run(kind, kw0, b=b, g0=g0, seg=seg, srows=srows):
            if kind == "kernel":
                return ragged_mod.ragged_gamma(b.ids, b.cnts, g0, eeb, alpha,
                                               eeb_t=eeb_t, compute_dtype=BF16,
                                               segments=seg, seg_rows=srows,
                                               **kw0)
            dt = torch.float64 if kind == "f64" else torch.float32
            return plain(b.ids, b.cnts.to(dt), g0.to(dt), eeb.to(dt),
                         alpha.to(dt), **kw0, segments=seg,
                         compute_dtype="float32" if kind == "f32" else BF16)

        ok, err, eb, text, g_p = bf16_gamma_check(run, b.ids, b.cnts, eeb,
                                                  alpha, doc_bound, kw)
        slots = torch.zeros((1,), dtype=torch.int64, device=dev)
        row_sweeps = torch.zeros((Db,), dtype=torch.int32, device=dev)
        geo = {}
        g_k, _ = ragged_mod.ragged_gamma(b.ids, b.cnts, g0, eeb, alpha,
                                         eeb_t=eeb_t, compute_dtype=BF16,
                                         slots_out=slots, geometry_out=geo,
                                         row_sweeps_out=row_sweeps,
                                         segments=seg, seg_rows=srows, **kw)
        bitwise = bool(torch.equal(g_k, run("kernel", kw)[0]))
        ok = ok and bitwise
        text += f", two calls bitwise equal {bitwise}"
        del g_k
        live = (b.cnts != 0).sum(dim=1)
        nmax = geo["nmax"]
        streamed, windows = streamed_rows(geo, live)
        # Bytes: ids and counts, the bf16 table rows of the launch's
        # distinct live ids, alpha and gamma0 read once; gamma written.
        rows_needed = int(torch.unique(b.ids[b.cnts != 0]).numel())
        flops = 4.0 * K * int(slots)
        nbytes = (Db * Tb * 8 + rows_needed * eeb_t.shape[1] * 2
                  + 2 * Db * K * 4 + K * 4)
        b_ms, b_by = bound(flops, nbytes, BF16)
        floor_text = ""
        if geo["route"] == "cluster":
            floor = sweep_floor_ms(geo, live, row_sweeps,
                                   eeb_t.shape[1] * 2, nbytes, BF16)
            rg["sweep_floor_ms"] = rg.get("sweep_floor_ms", 0.0) + floor
            floor_text = (f"; one HBM read a sweep of the entries past the "
                          f"resident ones {floor:.5f} ms")
        k_ms = cuda_ms(lambda: run("kernel", kw), 20)
        p_ms = cuda_ms(lambda: run("plain", kw), 3)
        print(f"kernel ragged_gamma{wide_tag(K)}_bf16 {label} bucket {i} "
              f"[{Db}x{Tb}, "
              f"K={K}]: {text}, real slots processed {int(slots)}, "
              f"{geometry_text(geo)}, rows "
              f"streamed past it {int(streamed.sum())} of "
              f"{int((live > 0).sum())} ({windows} windows a sweep), kernel_ms "
              f"{k_ms:.4f} "
              f"plain_ms {p_ms:.4f} bound_ms {b_ms:.5f} ({b_by}{floor_text}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"ragged_gamma bf16 {label} bucket {i} "
                                 f"disagrees with its plain version")
        rg["ms"] += k_ms
        rg["plain_ms"] += p_ms
        rg["flops"] += flops
        rg["nbytes"] += nbytes
        rg["max_abs_err"] = max(rg["max_abs_err"], err)
        rg["doc_bound_rel_err"] = max(rg["doc_bound_rel_err"], eb)
        rg["rows"] += int((live > 0).sum())
        rg["streamed_rows"] += int(streamed.sum())
        rg["windows"] += windows
        rg.update(nmax=nmax, smem_bytes=geo["smem_bytes"],
                  blocks_per_sm=geo["blocks_per_sm"],
                  routes=rg.get("routes", []) + [geo["route"]],
                  **{f: geo[f] for f in ("cluster", "tile", "resident",
                                         "window", "clusters")
                     if geo.get("cluster")})
        rows_plain.append(g_p)
    rg["bound_ms"], rg["bound_by"] = bound(rg["flops"], rg["nbytes"], BF16)
    print(f"kernel ragged_gamma{wide_tag(K)}_bf16 {label}: {rg['launches']} "
          f"launches, "
          f"{rg['ms']:.4f} ms (bound {rg['bound_ms']:.5f}, {rg['bound_by']}), "
          f"routes {rg['routes']}, slot buffer {rg['nmax']} entries, rows "
          f"streamed past it or the cluster "
          f"{rg['streamed_rows']} of {rg['rows']}, {rg['windows']} windows a "
          f"sweep; the float32 line of this input: {f32_line['ms']:.4f} ms "
          f"(bound {f32_line['bound_ms']:.5f}), slot buffer "
          f"{f32_line['nmax']} entries, {f32_line['windows']} windows a sweep")
    return rg, rows_plain


def dense_checks_bf16(label, corpus, beta, cfg, dev, f32_line, probe=None):
    """The dense E-step's bf16 builds (gamma kernel + final pass) on the
    one counts batch of ``corpus`` at a sharpened lambda
    (``bf16_gamma_check``; the final pass by ``sstats_check`` at the
    kernel's gamma), timed beside the float32 line of the same input
    (``f32_line``, a ``dense_checks`` record; ``probe`` as there).
    Raises if it disagrees.  Returns (its record, the final pass's
    sstats record)."""
    import torch

    from pylda_tpu_torch.ops import dense_estep as dense_mod
    from pylda_tpu_torch.ops import sstats as sstats_mod
    from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation
    from pylda_tpu_torch.ops.estep import (
        estep_dense,
        estep_dense_sstats,
        ragged_doc_bound,
    )

    K, Vd = cfg.number_of_topics, corpus.num_types
    kw = dict(inner_iterations=cfg.inner_iterations,
              convergence_threshold=cfg.convergence_threshold, eps=cfg.eps,
              stall_patience=cfg.estep_stall_patience)
    alpha, eeb, dc, g0 = probe or dense_probe(corpus, beta, cfg, dev)
    Dd = dc.shape[0]
    row_nnz = (dc != 0).sum(dim=1)
    ids, cnts = dense_entries(dc, row_nnz)
    # Read once: a read of the card's count in each timed call would sync
    # the host with the card there (the float32 line reads it once too).
    max_nnz = int(row_nnz.max())

    def run(kind, kw0):
        if kind == "kernel":
            out = dense_mod.dense_estep(dc, g0, eeb, alpha, compute_dtype=BF16,
                                        max_nnz=max_nnz, **kw0)
        else:
            dt = torch.float64 if kind == "f64" else torch.float32
            out = estep_dense(dc if dt == torch.float32 else dc.double(),
                              g0.to(dt), eeb.to(dt), alpha.to(dt), **kw0,
                              compute_dtype="float32" if kind == "f32"
                              else BF16)
        return out[0], out[3]

    ok, err, eb, text, _ = bf16_gamma_check(run, ids, cnts, eeb, alpha,
                                            ragged_doc_bound, kw)
    del ids, cnts
    row_sweeps = torch.zeros((Dd,), dtype=torch.int32, device=dev)
    geo = {}
    g_k = dense_mod.dense_estep(dc, g0, eeb, alpha, compute_dtype=BF16,
                                row_sweeps_out=row_sweeps, geometry_out=geo,
                                max_nnz=max_nnz, **kw)[0]
    bitwise = bool(torch.equal(g_k, run("kernel", kw)[0]))
    ok = ok and bitwise
    fin = sstats_check(f"{label} final pass", dc,
                       exp_dirichlet_expectation(g_k), eeb, cfg.eps,
                       sstats_mod, estep_dense_sstats, compute_dtype=BF16)
    nnz = int(row_nnz.sum())
    work = int((row_sweeps.long() * row_nnz).sum()) + nnz
    nbytes = (dc.numel() * dc.element_size() + 2 * K * Vd * 4
              + 2 * Dd * K * 4 + K * 4 + 4)
    b_ms, b_by = bound(4.0 * K * work, nbytes, BF16)
    floor = (sweep_floor_ms(geo, row_nnz, row_sweeps, -(-K // 8) * 16,
                            nbytes, BF16)
             if geo["route"] == "cluster" else None)
    k_ms = cuda_ms(lambda: run("kernel", kw), 5)
    p_ms = cuda_ms(lambda: run("plain", kw), 2)
    streamed = int(streamed_rows(geo, row_nnz)[0].sum())
    print(f"kernel dense_gamma{wide_tag(K)}_bf16 {label} [{Dd}x{dc.shape[1]} "
          f"{str(dc.dtype)[6:]}, K={K}]: {text}, two calls bitwise equal "
          f"{bitwise}, {geometry_text(geo)}, rows streamed past it "
          f"{streamed}, kernel_ms {k_ms:.4f} (of "
          f"which final pass dense_sstats_bf16 "
          f"{fin['ms']:.4f}) plain_ms {p_ms:.4f} bound_ms {b_ms:.5f} "
          f"({b_by}"
          f"{'' if floor is None else f'; one HBM read a sweep of the entries past the resident ones {floor:.5f} ms'}"
          f"); the float32 line of this input: {f32_line['ms']:.4f} ms "
          f"(bound {f32_line['bound_ms']:.5f}), slot buffer "
          f"{f32_line['nmax']} entries {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"dense_estep bf16 disagrees with its plain "
                             f"version ({label})")
    return {"name": label, "shape": [Dd, dc.shape[1]], "K": K,
            "route": geo["route"],
            "max_abs_err": err, "doc_bound_rel_err": eb, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "nmax": geo["nmax"], "streamed_rows": streamed,
            **({} if floor is None else {"sweep_floor_ms": floor})}, fin


def zero_launches(mods) -> None:
    for mod in mods.values():
        mod.LAUNCHES = mod.BF16_LAUNCHES = 0
        mod.WIDE_LAUNCHES = mod.BF16_WIDE_LAUNCHES = 0
        if hasattr(mod, "CLUSTER_LAUNCHES"):
            mod.CLUSTER_LAUNCHES = mod.BF16_CLUSTER_LAUNCHES = 0
        if hasattr(mod, "BF16_GROUP_LAUNCHES"):
            mod.BF16_GROUP_LAUNCHES = 0
        if hasattr(mod, "BF16_MMA_LAUNCHES"):
            mod.BF16_MMA_LAUNCHES = mod.BF16_RANGE_MMA_LAUNCHES = 0
        if hasattr(mod, "RANGE_LAUNCHES"):
            mod.RANGE_LAUNCHES = mod.BF16_RANGE_LAUNCHES = 0
            mod.RANGE_WIDE_LAUNCHES = mod.BF16_RANGE_WIDE_LAUNCHES = 0


def read_launches(mods) -> dict:
    """Each kernel's launches of its float32 build (its name) and of its
    bf16 build (its name + "_bf16"); for the sstats kernel also its
    topic-range launches ("dense_sstats_range", "dense_sstats_range_bf16",
    counted in its builds' launches too).  Of each, the launches of the
    cluster kernels (the gamma one above K = 4096, the sstats one at every
    K above 256) as "<name>_wide" and "<name>_wide_bf16", and of the gamma
    kernels the launches of the entry kernel (K <= 4096, rows past one
    block's slot buffer) as "<name>_cluster" and "<name>_cluster_bf16",
    and of their bf16 builds the launches of the warp-group kernel (K <=
    256, rows that fit a group's slots) as "<name>_group_bf16", and of the
    sstats kernel's bf16 build the launches of its tensor-core kernel (K <=
    256) as "dense_sstats_mma_bf16" and "dense_sstats_range_mma_bf16",
    counted in the others too."""
    out = {}
    for name, mod in mods.items():
        out[name] = mod.LAUNCHES
        out[f"{name}_bf16"] = mod.BF16_LAUNCHES
        if hasattr(mod, "CLUSTER_LAUNCHES"):
            out[f"{name}_cluster"] = mod.CLUSTER_LAUNCHES
            out[f"{name}_cluster_bf16"] = mod.BF16_CLUSTER_LAUNCHES
        if hasattr(mod, "BF16_GROUP_LAUNCHES"):
            out[f"{name}_group_bf16"] = mod.BF16_GROUP_LAUNCHES
        if hasattr(mod, "BF16_MMA_LAUNCHES"):
            out[f"{name}_mma_bf16"] = mod.BF16_MMA_LAUNCHES
            out[f"{name}_range_mma_bf16"] = mod.BF16_RANGE_MMA_LAUNCHES
        if hasattr(mod, "RANGE_LAUNCHES"):
            out[f"{name}_range"] = mod.RANGE_LAUNCHES
            out[f"{name}_range_bf16"] = mod.BF16_RANGE_LAUNCHES
        out[f"{name}_wide"] = mod.WIDE_LAUNCHES
        out[f"{name}_wide_bf16"] = mod.BF16_WIDE_LAUNCHES
        if hasattr(mod, "RANGE_LAUNCHES"):
            out[f"{name}_range_wide"] = mod.RANGE_WIDE_LAUNCHES
            out[f"{name}_range_wide_bf16"] = mod.BF16_RANGE_WIDE_LAUNCHES
    return out


def check_launched(label: str, counts: dict, needed, absent=()) -> None:
    """Raises unless every kernel build in ``needed`` ran, and no build of
    the other operand mode did (a bf16 path never runs a float32 build,
    nor the reverse), nor any build in ``absent`` (the scatter route
    never runs the sstats kernel).  With ``needed`` empty (the sampling
    paths, plain PyTorch) no build may have run at all."""
    print(f"{label}: kernel launches {counts}")
    missing = [k for k in needed if counts[k] < 1]
    if needed:
        bf16 = needed[0].endswith("_bf16")
        stray = [k for k, n in counts.items()
                 if n and (k.endswith("_bf16") != bf16 or k in absent)]
    else:
        stray = [k for k, n in counts.items() if n]
    if missing or stray:
        raise AssertionError(f"{label}: kernels {missing} never ran; builds "
                             f"{stray} of the other mode, or kept off this "
                             f"path, ran")


def dense_probe(corpus, beta, cfg, dev):
    """The dense E-step's inputs on the one counts batch of ``corpus`` at a
    sharpened lambda: (alpha, expElogbeta, counts [D, V], gamma init)."""
    import numpy as np
    import torch

    from pylda_tpu_torch.models import VariationalBayes
    from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation_fast

    K, Vd = cfg.number_of_topics, corpus.num_types
    lam = (1.0 / Vd + beta * (corpus.num_tokens / K)).astype(np.float32)
    probe = VariationalBayes(cfg, device=dev)
    probe.initialize(corpus, lam_init=lam)
    (batch,) = probe._batches
    dc = batch.counts
    g0 = torch.ones((dc.shape[0], K), dtype=torch.float32, device=dev)
    return (probe.state.alpha, exp_dirichlet_expectation_fast(probe.state.lam),
            dc, g0)


def dense_entries(dc, row_nnz):
    """Each dense row as its nonzero (column, count) entries, in column
    order: (ids int32, counts f32) [D, max nonzeros], zero-padded."""
    import torch

    order = torch.sort((dc != 0).to(torch.uint8), dim=1, descending=True,
                       stable=True).indices[:, :int(row_nnz.max())]
    return order.to(torch.int32), dc.gather(1, order).float()


def dense_checks(label, corpus, beta, cfg, dev, pinned=False, probe=None,
                 final_inputs=None):
    """The dense E-step (gamma kernel + final pass) on the one counts batch
    of ``corpus`` at a sharpened lambda, against its plain version in
    float64 (``exit_report``), the final pass at the kernel's gamma and
    the score; timed, with bounds from this run's nonzeros.  ``pinned``
    holds the rows still updating at S* by their share of the bound and
    every row at pinned sweeps, as ``ragged_checks`` does.  Raises if it
    disagrees.  ``probe``: the inputs (``dense_probe``'s tuple) where the
    caller made them.  ``final_inputs`` (a dict) gets the final pass's
    counts, expEtheta and expElogbeta.  Returns (its record, the final
    pass's sstats record)."""
    import torch

    from pylda_tpu_torch.ops import dense_estep as dense_mod
    from pylda_tpu_torch.ops import sstats as sstats_mod
    from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation
    from pylda_tpu_torch.ops.estep import (
        estep_dense,
        estep_dense_sstats,
        ragged_doc_bound,
    )

    K, Vd = cfg.number_of_topics, corpus.num_types
    kw = dict(inner_iterations=cfg.inner_iterations,
              convergence_threshold=cfg.convergence_threshold, eps=cfg.eps,
              stall_patience=cfg.estep_stall_patience)
    gamma_atol = 5e-4 + K * cfg.convergence_threshold
    alpha, eeb, dc, g0 = probe or dense_probe(corpus, beta, cfg, dev)
    row_sweeps = torch.zeros((dc.shape[0],), dtype=torch.int32, device=dev)
    row_exit = torch.zeros_like(row_sweeps)
    extra = torch.zeros((1,), dtype=torch.int64, device=dev)
    geo = {}
    # The batch's largest row nnz, as the engine passes it (counted on the
    # host when the batch is built).
    kmw = dict(kw, max_nnz=int((dc != 0).sum(dim=1).max()))
    g_k, ss_k, tok_k, s_k = dense_mod.dense_estep(dc, g0, eeb, alpha,
                                                  row_sweeps_out=row_sweeps,
                                                  extra_sweeps_out=extra,
                                                  row_exit_out=row_exit,
                                                  geometry_out=geo, **kmw)
    bitwise = bool(torch.equal(
        g_k, dense_mod.dense_estep(dc, g0, eeb, alpha, **kmw)[0]))
    g_p, _, tok_p, s_p = estep_dense(dc, g0, eeb, alpha, **kw)
    g_64, _, _, s_64 = estep_dense(dc.double(), g0.double(), eeb.double(),
                                   alpha.double(), **kw)
    ss_at_k, _ = estep_dense_sstats(dc, exp_dirichlet_expectation(g_k), eeb,
                                    eps=cfg.eps)
    torch.cuda.synchronize()
    dg_ok, dg_err, fp_text = exit_report(g_k, g_64, g_p, s_k, s_64, row_exit,
                                         row_sweeps, extra, gamma_atol,
                                         check_updating=not pinned)
    row_nnz = (dc != 0).sum(dim=1)
    bound_err = None
    if pinned:
        updating = (row_sweeps >= int(s_k)) & (row_nnz > 0)
        if updating.any():
            ok_b, bound_err, text = bound_check(
                *dense_entries(dc, row_nnz), updating,
                g_k, g_64, g_p, eeb, alpha, ragged_doc_bound)
            fp_text += text
            dg_ok = dg_ok and ok_b
        def run(kind, kw0):
            dt = torch.float64 if kind == "f64" else torch.float32
            args = (dc if dt == torch.float32 else dc.double(), g0.to(dt),
                    eeb.to(dt), alpha.to(dt))
            if kind == "kernel":
                out = dense_mod.dense_estep(*args, **dict(kmw, **kw0))
            else:
                out = estep_dense(*args, **dict(kw, **kw0))
            return out[0], out[3]

        ok0, text = pinned_check(run, K)
        fp_text += text
        dg_ok = dg_ok and ok0
    del g_64
    dss_ok = bool(((ss_k - ss_at_k).abs()
                   <= SSTATS_RTOL * ss_at_k.abs()
                   + SSTATS_ATOL_REL * float(ss_at_k.abs().max())).all())
    dtok_rel = abs(float(tok_k) - float(tok_p)) / abs(float(tok_p))
    Dd = dc.shape[0]
    # The work this input needs: each sweep of a row (frozen sweeps
    # excluded) and the final pass do 4*K FLOP for each nonzero count of
    # the row — phinorm and the ratio are needed only there.  The dense
    # form (every column) is printed beside it.  Bytes: counts, eeb, alpha
    # and gamma0 read once; gamma and sstats written once.
    dg_nnz = int(row_nnz.sum())
    row_sweeps_total = int(row_sweeps.sum())
    dg_work = int((row_sweeps.long() * row_nnz).sum()) + dg_nnz
    dg_bytes = (dc.numel() * dc.element_size() + 2 * K * Vd * 4
                + 2 * Dd * K * 4 + K * 4 + 4)
    dg_bound, dg_by = bound(4.0 * K * dg_work, dg_bytes)
    dg_dense_bound, _ = bound(4.0 * K * Vd * (row_sweeps_total + Dd),
                              dg_bytes)
    floor = (sweep_floor_ms(geo, row_nnz, row_sweeps, -(-K // 4) * 16,
                            dg_bytes) if geo["route"] == "cluster" else None)
    dg_ms = cuda_ms(lambda: dense_mod.dense_estep(dc, g0, eeb, alpha,
                                                  **kmw), 5)
    dg_plain_ms = cuda_ms(lambda: estep_dense(dc, g0, eeb, alpha, **kw), 2)
    fin = sstats_check(f"{label} final pass", dc,
                       exp_dirichlet_expectation(g_k), eeb, cfg.eps,
                       sstats_mod, estep_dense_sstats)
    if final_inputs is not None:
        final_inputs.update(counts=dc, et=exp_dirichlet_expectation(g_k),
                            eeb=eeb)
    dg_ok = dg_ok and dss_ok and dtok_rel <= DENSE_SCORE_RTOL and bitwise
    streamed = int(streamed_rows(geo, row_nnz)[0].sum())
    print(f"kernel dense_gamma{wide_tag(K)} {label} [{Dd}x{dc.shape[1]} "
          f"{str(dc.dtype)[6:]}, K={K}]: sweeps plain f32 {int(s_p)}, "
          f"{fp_text}, two calls bitwise equal {bitwise}, row-sweeps needed "
          f"{row_sweeps_total}, "
          f"nonzero counts {dg_nnz} ({dg_nnz / dc.numel():.4f} of the block), "
          f"{geometry_text(geo)}, rows streamed past it "
          f"{streamed}, kernel_ms {dg_ms:.4f} (of which "
          f"final pass "
          f"dense_sstats {fin['ms']:.4f}) plain_ms {dg_plain_ms:.4f} bound_ms "
          f"{dg_bound:.5f} ({dg_by}; dense form {dg_dense_bound:.5f}"
          f"{'' if floor is None else f'; one HBM read a sweep of the entries past the resident ones {floor:.5f} ms'}), sstats "
          f"at the kernel's gamma {'ok' if dss_ok else 'FAIL'} (tolerance "
          f"{SSTATS_RTOL}*|ref| + {SSTATS_ATOL_REL}*max|ref|), score rel err "
          f"{dtok_rel:.3e} (tolerance {DENSE_SCORE_RTOL}) "
          f"{'ok' if dg_ok else 'FAIL'}")
    if not dg_ok:
        raise AssertionError(f"dense_estep disagrees with its plain version "
                             f"({label})")
    return {"name": label, "shape": [Dd, dc.shape[1]], "K": K,
            "max_abs_err": dg_err, "ms": dg_ms, "plain_ms": dg_plain_ms,
            "bound_ms": dg_bound, "bound_by": dg_by,
            "dense_form_bound_ms": dg_dense_bound, "nmax": geo["nmax"],
            "streamed_rows": streamed, "doc_bound_rel_err": bound_err,
            "route": geo["route"],
            **{f: geo[f] for f in ("cluster", "resident", "clusters")
               if geo["route"] == "entries"},
            **({} if floor is None else {"sweep_floor_ms": floor})}, fin


def svi_kernel_lines(label, corpus, beta, cfg, dev, bf16=False,
                     range_lines=None):
    """The ragged gamma and dense sstats kernels at one SVI config's
    shapes: the first minibatch of epoch 0, gathered from the
    device-resident rows at minibatch-local positions, at a sharpened
    lambda; gamma per bucket chunk (``ragged_checks``, pinned), sstats on
    the first counts chunk at the plain gammas.  Returns their records;
    with ``bf16`` also those of the bf16 builds on the same minibatch
    (``ragged_checks_bf16``, sstats at the bf16 plain gammas), else
    None for them.  ``range_lines`` (a dict of lists by build) gets the
    topic-range sstats records on the same chunk."""
    import numpy as np
    import torch

    from pylda_tpu_torch.models import StochasticVariationalBayes
    from pylda_tpu_torch.models.vb import _assemble_gamma_device
    from pylda_tpu_torch.ops import ragged as ragged_mod
    from pylda_tpu_torch.ops import sstats as sstats_mod
    from pylda_tpu_torch.ops.dirichlet import (
        exp_dirichlet_expectation,
        exp_dirichlet_expectation_fast,
    )
    from pylda_tpu_torch.ops.estep import (
        estep_dense_sstats,
        estep_ragged_gamma,
        ragged_doc_bound,
    )

    K, Vs = cfg.number_of_topics, corpus.num_types
    kw = dict(inner_iterations=cfg.inner_iterations,
              convergence_threshold=cfg.convergence_threshold, eps=cfg.eps,
              stall_patience=cfg.estep_stall_patience)
    probe = StochasticVariationalBayes(cfg, device=dev)
    probe.initialize(corpus, lam_init=(
        1.0 / Vs + beta * (corpus.num_tokens / K)).astype(np.float32))
    st = probe.state
    eeb = exp_dirichlet_expectation_fast(st.lam)
    eeb_t = ragged_mod.gather_table(eeb)
    batches, (_, sel) = next(probe._epoch(cfg.seed, 0).minibatches)
    buckets, mb_plan = probe._local_plan(batches, sel)
    rg, rows_plain = ragged_checks(
        label, buckets, eeb, eeb_t, st.alpha, kw,
        5e-4 + K * cfg.convergence_threshold, dev, ragged_mod,
        estep_ragged_gamma, ragged_doc_bound, pinned=True)
    if any(getattr(b, "segments", None) for b in buckets):
        rg["segments_card_vs_cpu"] = segments_card_vs_cpu(
            label, buckets, eeb, eeb_t, st.alpha, kw,
            5e-4 + K * cfg.convergence_threshold, dev, ragged_mod,
            estep_ragged_gamma, ragged_doc_bound)
    gamma_docs = _assemble_gamma_device(
        torch.cat(rows_plain), torch.cat([b.row_index for b in buckets]),
        st.alpha, mb_plan.num_docs,
    )
    counts, cidx = mb_plan.chunks[0]
    print(f"{label}: a minibatch's sstats counts chunks "
          f"{[tuple(c.shape) for c, _ in mb_plan.chunks]}")
    ss = sstats_check(f"{label} minibatch", counts,
                      exp_dirichlet_expectation(gamma_docs)[cidx], eeb,
                      cfg.eps, sstats_mod, estep_dense_sstats)
    if "cluster" in ss:  # the cluster kernel: no host sync either
        sstats_sync_free_check(f"{label} minibatch", counts,
                               exp_dirichlet_expectation(gamma_docs)[cidx],
                               eeb, cfg.eps)
    if range_lines is not None:
        range_lines["float32"] += sstats_range_check(
            f"{label} minibatch", counts,
            exp_dirichlet_expectation(gamma_docs)[cidx], eeb, cfg.eps,
            sstats_mod, estep_dense_sstats)
    if not bf16:
        return rg, ss, None, None
    del rows_plain, gamma_docs, eeb_t
    rg16, rows_plain = ragged_checks_bf16(
        label, buckets, eeb, st.alpha, kw, dev, ragged_mod,
        estep_ragged_gamma, ragged_doc_bound, rg)
    gamma_docs = _assemble_gamma_device(
        torch.cat(rows_plain), torch.cat([b.row_index for b in buckets]),
        st.alpha, mb_plan.num_docs,
    )
    ss16 = sstats_check(f"{label} minibatch", counts,
                        exp_dirichlet_expectation(gamma_docs)[cidx], eeb,
                        cfg.eps, sstats_mod, estep_dense_sstats,
                        compute_dtype=BF16)
    if range_lines is not None:
        range_lines[BF16] += sstats_range_check(
            f"{label} minibatch", counts,
            exp_dirichlet_expectation(gamma_docs)[cidx], eeb, cfg.eps,
            sstats_mod, estep_dense_sstats, compute_dtype=BF16)
    return rg, ss, rg16, ss16


def run_engine(label, cfg, corpus, test, dev, mods, needed, n=20, warm=2,
               lam_init=None, absent=()) -> dict:
    """The main path at one flagship: initialize (from ``lam_init`` when
    given), learning_many(warm) warm, learning_many(n) timed, inference
    and perplexity on held-out docs; launch counters zeroed just before
    and read just after.  Returns the launches ("launches"), the last
    ELBO and the held-out perplexity."""
    import numpy as np
    import torch

    from pylda_tpu_torch.models import VariationalBayes

    zero_launches(mods)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = VariationalBayes(cfg, device=dev)
    eng.initialize(corpus, lam_init=lam_init)
    torch.cuda.synchronize()
    shapes = [tuple((b.ids if hasattr(b, "ids") else b.counts).shape)
              for b in eng._batches]
    print(f"{label}: initialize {time.perf_counter() - t0:.2f} s, batches "
          f"{shapes}")
    warm = eng.learning_many(warm)
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
    check_launched(label, counts, needed, absent)
    return {"launches": counts, "elbo": allq[-1], "perplexity": ppl,
            "engine": eng, "iteration_ms": dt * 1e3}


def hold_bf16(label, r32: dict, r16: dict) -> None:
    """An engine's bf16 run against the same tree's float32 run: its last
    bound (ELBO, or SVI's estimate) and held-out perplexity, with the JAX
    package's bars; raises past them."""
    e = abs(r16["elbo"] - r32["elbo"]) / abs(r32["elbo"])
    p = abs(r16["perplexity"] - r32["perplexity"]) / r32["perplexity"]
    ok = e <= BF16_ELBO_RTOL and p <= BF16_PPL_RTOL
    print(f"{label}: bf16 against float32: bound {r16['elbo']:.1f} vs "
          f"{r32['elbo']:.1f} (rel {e:.3e}, tolerance {BF16_ELBO_RTOL}), "
          f"held-out perplexity {r16['perplexity']:.2f} vs "
          f"{r32['perplexity']:.2f} (rel {p:.3e}, tolerance {BF16_PPL_RTOL}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: bf16 and float32 runs disagree")


def run_svi(label, cfg, corpus, test, dev, mods, n, lam_init=None,
            needed=()) -> dict:
    """SVI at one config: initialize (from ``lam_init`` when given),
    learning_many(1) warm,
    learning_many(n) timed, one more epoch under ``torch.profiler`` (the
    card's busy time, idle share and kernels by device time), then
    ``inference``, ``perplexity`` and ``point_estimate_perplexity`` on
    held-out docs; the point-estimate perplexity must fall below its
    value at init.  Launch counters zeroed just before and read just
    after; ``needed`` names builds the path must launch besides the
    ragged gamma and dense sstats kernels.  Returns the launches
    ("launches"), the last epoch's bound estimate ("elbo"), the held-out
    perplexity, s an epoch, the idle share and the peak memory."""
    import numpy as np
    import torch

    from pylda_tpu_torch.models import StochasticVariationalBayes

    zero_launches(mods)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = StochasticVariationalBayes(cfg, device=dev)
    eng.initialize(corpus, lam_init=lam_init)
    torch.cuda.synchronize()
    mat = eng._mb_sstats.counts
    print(f"{label}: initialize {time.perf_counter() - t0:.2f} s; geometry "
          f"(width: rows a minibatch) {eng._svi_geometry}; device rows "
          f"{[tuple(r.ids.shape) for r in eng._device_rows]}; counts matrix "
          f"{tuple(mat.shape)} {str(mat.dtype)[6:]} "
          f"({mat.numel() * mat.element_size() / 1e9:.3f} GB)")
    pe0 = eng.point_estimate_perplexity(test)
    eng.learning_many(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ests = eng.learning_many(n)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n
    nb = -(-corpus.num_docs // cfg.batch_size)
    print(f"{label}: learning_many({n}) {dt:.4f} s/epoch ({dt / nb * 1e3:.3f} "
          f"ms a minibatch, {nb} minibatches), {corpus.num_docs / dt:.1f} "
          f"docs/s; bound estimates {[round(e, 1) for e in ests]}; sweeps per "
          f"bucket (last minibatch) {[int(s) for s in eng.last_sweeps]}")
    prof = profile_window(lambda: eng.learning_many(1))
    print(f"{label}: one epoch under torch.profiler: wall "
          f"{prof['wall_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} ms, "
          f"idle share {prof['idle_share']:.3f}")
    for count, dev_us, key in sorted(prof["ops"], key=lambda r: -r[1])[:8]:
        print(f"  {dev_us / 1e3:.3f} ms an epoch, {count} launches: "
              f"{key[:90]}")
    t0 = time.perf_counter()
    ll, gamma = eng.inference(test)
    t_inf = time.perf_counter() - t0
    t0 = time.perf_counter()
    ppl = eng.perplexity(test)
    t_ppl = time.perf_counter() - t0
    pe = eng.point_estimate_perplexity(test)
    if not (np.isfinite(ests).all() and np.isfinite(ll) and np.isfinite(ppl)
            and gamma.shape == (test.num_docs, cfg.number_of_topics)
            and np.isfinite(gamma).all()):
        raise AssertionError(f"{label}: not finite")
    print(f"{label}: inference on {test.num_docs} held-out docs "
          f"{t_inf * 1e3:.1f} ms (ll {ll:.1f}), perplexity {ppl:.2f} in "
          f"{t_ppl * 1e3:.1f} ms, point-estimate perplexity {pe:.2f} (at "
          f"init {pe0:.2f})")
    if not pe < pe0:
        raise AssertionError(f"{label}: held-out point-estimate perplexity "
                             f"did not fall ({pe0:.2f} -> {pe:.2f})")
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    print(f"{label}: peak device memory {peak:.1f} MiB")
    counts = read_launches(mods)
    suffix = "_bf16" if cfg.compute_dtype == BF16 else ""
    check_launched(label, counts, (f"ragged_gamma{suffix}",
                                   f"dense_sstats{suffix}", *needed))
    return {"launches": counts, "elbo": ests[-1], "perplexity": ppl,
            "engine": eng, "s_per_epoch": dt,
            "docs_per_s": corpus.num_docs / dt,
            "idle_share": prof["idle_share"], "peak_mib": peak,
            "point_perplexity": [pe0, pe]}


def profile_window(fn) -> dict:
    """Run ``fn`` once under ``torch.profiler``: host wall time (ending in
    a synchronize), the device's busy time and idle share, device kernel
    launches, (count, device µs, name) of each op with device time, and
    the device µs of the kernels under each profiler range
    (``record_function``) in "ranges"."""
    import torch
    from torch.autograd import DeviceType

    from scripts.torch_engine_profile import busy_us, is_range

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    busy = busy_us(events)
    launches = sum(1 for e in events if e.device_type == DeviceType.CUDA
                   and not is_range(e))
    rows = prof.key_averages()
    ops = [(e.count, e.self_device_time_total, e.key) for e in rows
           if e.self_device_time_total > 0 and not is_range(e)]
    ranges = {e.key: e.device_time_total for e in rows
              if is_range(e) and e.device_type == DeviceType.CPU}
    del prof
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall_us, "device_launches": launches,
            "ops": ops, "ranges": ranges}


def sampling_conserved(label, eng, corpus) -> None:
    """Counts conserved on the card: Gibbs's n_kv sums to the corpus's
    tokens and equals its recount from z, each row of n_dk sums to its
    slots; the hybrid's sufficient statistics (lambda - eta) sum to the
    tokens and each document's gamma - alpha to its length."""
    import numpy as np
    import torch

    from pylda_tpu_torch.ops.sampling import count_table

    if hasattr(eng, "_n_kv"):
        K, V = eng._n_kv.shape
        recount = sum(count_table(b.tokens, b.token_mask, z, K, V)
                      for b, z in zip(eng._buckets, eng._z))
        ok = (float(eng._n_kv.sum()) == corpus.num_tokens
              and torch.equal(recount, eng._n_kv)
              and all(torch.equal(n.sum(1), b.token_mask.sum(1))
                      for b, n in zip(eng._buckets, eng._ndk)))
        what = (f"n_kv sums to {float(eng._n_kv.sum()):.0f} of "
                f"{corpus.num_tokens} tokens, equals its recount from z, "
                f"n_dk rows sum to their slots")
    else:
        st = eng.state
        total = float((st.lam - st.eta[None, :]).sum(dtype=torch.float64))
        lengths = np.asarray([d.size for d in corpus.docs], np.float64)
        gamma = eng.gamma
        row_err = np.abs(gamma.sum(1) - float(st.alpha.sum()) - lengths
                         ).max()
        ok = (abs(total - corpus.num_tokens) <= 1e-5 * corpus.num_tokens
              and row_err <= 1e-3)
        what = (f"lambda - eta sums to {total:.2f} of {corpus.num_tokens} "
                f"tokens, gamma - alpha rows within {row_err:.2e} of the "
                f"document lengths")
    print(f"{label}: conservation on the card: {what} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: counts not conserved")


def run_sampling(label, cfg, corpus, test, dev, mods, extra) -> dict:
    """A sampling engine (Gibbs or hybrid) at BASELINE config 3:
    initialize, learning_many(16) warm, learning_many(16) timed,
    learning_many(``extra``) more, conservation on the card, one sweep or
    iteration under ``torch.profiler``, held-out native and
    point-estimate perplexity, peak memory.  The launch counters are
    zeroed just before and read just after: no kernel build may run.
    Returns the launches and the numbers."""
    import numpy as np
    import torch

    from pylda_tpu_torch.models import make_engine

    zero_launches(mods)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    eng = make_engine(cfg, device=dev)
    eng.initialize(corpus)
    torch.cuda.synchronize()
    buckets = eng._buckets if hasattr(eng, "_buckets") else eng._batches
    print(f"{label}: initialize {time.perf_counter() - t0:.2f} s; sequence "
          f"buckets {[tuple(b.tokens.shape) for b in buckets]}")
    objs = eng.learning_many(16)
    n = 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    objs += eng.learning_many(n)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n
    unit = "sweep" if cfg.inference_mode == "gibbs" else "iteration"
    print(f"{label}: learning_many({n}) {dt * 1e3:.3f} ms a {unit}, "
          f"{corpus.num_docs / dt:.1f} docs/s")
    t0 = time.perf_counter()
    objs += eng.learning_many(extra)
    torch.cuda.synchronize()
    print(f"{label}: learning_many({extra}) more in "
          f"{time.perf_counter() - t0:.2f} s; objective every 8th "
          f"{[round(x, 1) for x in objs[::8]]} last {objs[-1]:.1f}")
    if not (np.isfinite(objs).all() and objs[-1] > objs[0]):
        raise AssertionError(f"{label}: objective not finite or not rising")
    sampling_conserved(label, eng, corpus)
    prof = profile_window(lambda: eng.learning_many(1))
    print(f"{label}: one {unit} under torch.profiler: wall "
          f"{prof['wall_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} ms, "
          f"idle share {prof['idle_share']:.3f}, {prof['device_launches']} "
          f"device kernel launches")
    for count, dev_us, key in sorted(prof["ops"], reverse=True)[:8]:
        print(f"  {count} launches, {dev_us / 1e3:.3f} ms: {key[:90]}")
    t0 = time.perf_counter()
    ppl = eng.perplexity(test)
    t_ppl = time.perf_counter() - t0
    pe = eng.point_estimate_perplexity(test)
    if not (np.isfinite(ppl) and np.isfinite(pe)):
        raise AssertionError(f"{label}: held-out perplexity not finite")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"{label}: held-out perplexity on {test.num_docs} docs {ppl:.2f} "
          f"(native, {t_ppl * 1e3:.1f} ms), point-estimate {pe:.2f}; peak "
          f"device memory {peak / 2**20:.1f} MiB ({(peak - base) / 2**20:.1f} "
          f"MiB above the {base / 2**20:.1f} MiB allocated before the phase)")
    counts = read_launches(mods)
    check_launched(label, counts, ())
    return {"engine": eng, "launches": counts, "ms": dt * 1e3,
            "docs_per_s": corpus.num_docs / dt, "objective": objs[-1],
            "perplexity": ppl, "point_perplexity": pe,
            "idle_share": prof["idle_share"], "busy_ms": prof["busy_ms"],
            "device_launches": prof["device_launches"],
            "peak_mib": peak / 2**20,
            "peak_above_base_mib": (peak - base) / 2**20}


def sampling_card_vs_cpu(eng, dev) -> None:
    """The sampling ops on the card against the CPU at config 3's shapes
    (the Gibbs engine's buckets and factor): each sampler's sweep from
    noise drawn on the CPU, z and n_dk equal except on at most
    SWEEP_DOC_ALLOWANCE of the documents, and the count table of every
    bucket's z bitwise equal."""
    import torch

    from pylda_tpu_torch.models.gibbs import _log_phi_hat
    from pylda_tpu_torch.ops.sampling import (
        count_table,
        draw_noise,
        noise_shape,
        stream,
        sweep_doc_topics,
    )

    cfg = eng.config
    K, V = eng._n_kv.shape
    log_tw = _log_phi_hat(eng._n_kv, eng.state.eta)
    i = max(range(len(eng._buckets)),
            key=lambda j: eng._buckets[j].tokens.numel())
    b, z0 = eng._buckets[i], eng._z[i]
    D, L = b.tokens.shape
    B = cfg.sampler_block_positions
    bad = []
    for sampler in ("cdf", "gumbel", "race"):
        g = stream("cpu", 0xC0DE)
        noise = [draw_noise(sampler, noise_shape(sampler, D, L, K, B), g)
                 for _ in range(2)]
        runs = {}
        for where in (dev, torch.device("cpu")):
            args = [x.to(where) for x in (b.tokens, b.token_mask, log_tw,
                                          eng.state.alpha, z0)]
            _g, _ss, z, ndk = sweep_doc_topics(
                *args, lambda s: noise[s], num_types=V, burn_in=1,
                num_samples=1, sampler=sampler, block_positions=B)
            runs[where.type] = (z.cpu(), ndk.cpu())
        (z, ndk), (zc, ndkc) = runs["cuda"], runs["cpu"]
        differ = int(((z != zc).any(1) | (ndk != ndkc).any(1)).sum())
        ok = differ <= SWEEP_DOC_ALLOWANCE * D
        print(f"cross-check sweep {sampler} [{D}, {L}] K={K} B={B}: card and "
              f"CPU differ on {differ} of {D} documents (allowance "
              f"{SWEEP_DOC_ALLOWANCE}) {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(f"sweep {sampler}")
    same = all(
        torch.equal(count_table(bb.tokens, bb.token_mask, z, K, V).cpu(),
                    count_table(bb.tokens.cpu(), bb.token_mask.cpu(),
                                z.cpu(), K, V))
        for bb, z in zip(eng._buckets, eng._z))
    print(f"cross-check count_table on {len(eng._buckets)} buckets: card "
          f"and CPU bitwise equal: {same}")
    if not same:
        bad.append("count_table")
    if bad:
        raise AssertionError(f"card and CPU sampling disagree: {bad}")


def run_cli(mods, mode: str, compute_dtype: str = "float32",
            needed=None, streaming=False, topics: int = 10) -> dict:
    """train -> test -> infer through the CLIs' main() on the card, with
    ``--inference_mode=mode``, ``--compute_dtype=compute_dtype`` (test
    and infer read the mode from the model file) and ``topics`` topics;
    ``needed``: the kernel builds the path must launch (default: the
    dense route's).  ``streaming`` trains with ``--streaming_input`` from
    a copy of the bundled corpus (its row sidecar is written beside the
    copy)."""
    import numpy as np

    from pylda_tpu_torch.cli import infer as cli_infer
    from pylda_tpu_torch.cli import test as cli_test
    from pylda_tpu_torch.cli import train as cli_train
    from pylda_tpu_torch.corpus.datasets import bundled_corpus_dir

    corpus_dir = bundled_corpus_dir()
    suffix = "_bf16" if compute_dtype == BF16 else ""
    out = CLI_OUT / (f"{mode}{suffix}{'_streaming' if streaming else ''}"
                     + ("" if topics == 10 else f"_k{topics}"))
    shutil.rmtree(out, ignore_errors=True)
    extra = []
    if streaming:
        corpus_dir = str(shutil.copytree(corpus_dir,
                                         out / "input" / "de-news-tiny"))
        extra = ["--streaming_input"]
    zero_launches(mods)
    t0 = time.perf_counter()
    rc = cli_train.main([
        f"--input_directory={corpus_dir}", f"--output_directory={out}",
        f"--number_of_topics={topics}", "--training_iterations=6",
        "--snapshot_interval=3", "--dump_gamma", f"--inference_mode={mode}",
        f"--compute_dtype={compute_dtype}", *extra,
    ])
    runs = sorted((out / "de-news-tiny").iterdir())
    if rc != 0 or len(runs) != 1:
        raise AssertionError(f"cli train: rc {rc}, run dirs {runs}")
    run = runs[0]
    want = ["exp_beta-3", "exp_beta-6", "model-3", "model-6", "gamma-3",
            "gamma-6", "metrics.jsonl"]
    missing = [f for f in want if not (run / f).exists()]
    lines = (run / "exp_beta-6").read_text().splitlines()
    if (missing or lines[0] != "==========\t0\t=========="
            or len(lines) != 51 * topics):
        raise AssertionError(f"cli train outputs: missing {missing}, "
                             f"exp_beta lines {len(lines)}")
    gamma_out = out / "gamma.test"
    rc = cli_test.main([f"--model={run / 'model-6'}",
                        f"--input_directory={corpus_dir}",
                        f"--output_file={gamma_out}", "--point_estimate"])
    gamma = np.loadtxt(gamma_out)
    if rc != 0 or gamma.shape != (100, topics) or not (gamma > 0).all():
        raise AssertionError(f"cli test: rc {rc}, gamma {gamma.shape}")
    docs = out / "docs.txt"
    docs.write_text("government election vote\nrain snow storm weather\n")
    mix = out / "mix.tsv"
    rc = cli_infer.main([f"--model={run / 'model-6'}", f"--input={docs}",
                         f"--output={mix}", "--full"])
    theta = np.loadtxt(mix)
    if rc != 0 or theta.shape != (2, topics) or not np.allclose(
            theta.sum(axis=1), 1.0, rtol=1e-4):
        raise AssertionError(f"cli infer: rc {rc}, theta {theta.shape}")
    with open(run / "metrics.jsonl") as f:
        ppl = [json.loads(line) for line in f][-1]["perplexity"]
    meta = json.loads(bytes(np.load(run / "model-6")["meta_json"]).decode())
    if meta["config"]["compute_dtype"] != compute_dtype:
        raise AssertionError(f"cli train: the model file says "
                             f"{meta['config']['compute_dtype']}")
    label = (f"cli {mode} {compute_dtype}{' streaming' if streaming else ''}"
             + ("" if topics == 10 else f" K={topics}"))
    if streaming and not list(pathlib.Path(corpus_dir).glob(
            "doc.dat.rowcache.v2.*/meta.json")):
        raise AssertionError(f"{label}: no row sidecar beside {corpus_dir}")
    print(f"{label}: train 6 iterations + test + infer on "
          f"{corpus_dir} in {time.perf_counter() - t0:.2f} s; run dir "
          f"{run.name}; final held-out perplexity {ppl:.4f}")
    counts = read_launches(mods)
    if needed is None:
        needed = (f"dense_gamma{suffix}", f"dense_sstats{suffix}") + (
            ("dense_sstats_mma_bf16",) if suffix else ())
    check_launched(label, counts, needed)
    return counts


def norm_rel(got, want) -> float:
    """max |got - want| / max |want| (a tensor's error relative to its
    largest entry; a scalar's relative error)."""
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def scatter_card_vs_cpu(label, b, eeb, alpha) -> dict:
    """``estep_ragged`` (the gamma kernel, then the row scatter) on the card
    against the CPU's (the plain version, the same scatter) on one bucket
    at PINNED_SWEEPS pinned sweeps (threshold 0): sstats and the score
    within SCATTER_CARD_CPU_REL of their largest entry; gamma within
    SCATTER_CARD_CPU_REL or, where float32 rounding has grown past it over
    the sweeps, twice the float32 plain version's own distance from its
    float64 run (two float32 versions of one map part by about as much as
    either parts from float64).  Raises past the bars."""
    import torch

    from pylda_tpu_torch.ops.estep import estep_ragged

    kw = dict(inner_iterations=PINNED_SWEEPS, convergence_threshold=0.0)
    g0 = torch.ones((b.ids.shape[0], eeb.shape[0]), device=eeb.device)
    card = estep_ragged(b.ids, b.cnts, g0, eeb, alpha, **kw)
    args = [x.cpu() for x in (b.ids, b.cnts, g0, eeb, alpha)]
    cpu = estep_ragged(*args, **kw)
    g64 = estep_ragged(args[0], *(x.double() for x in args[1:]), **kw)[0]
    errs = [norm_rel(card[i].cpu(), cpu[i]) for i in range(3)]
    gap32, gap_card = norm_rel(cpu[0], g64), norm_rel(card[0].cpu(), g64)
    bar = max(SCATTER_CARD_CPU_REL, 2.0 * gap32)
    ok = (errs[0] <= bar and max(errs[1:]) <= SCATTER_CARD_CPU_REL
          and int(card[3]) == int(cpu[3]) == PINNED_SWEEPS)
    print(f"scatter {label} [{b.ids.shape[0]}x{b.ids.shape[1]}, "
          f"K={eeb.shape[0]}]: estep_ragged card vs CPU at {PINNED_SWEEPS} "
          f"pinned sweeps: sstats rel {errs[1]:.3e}, score rel {errs[2]:.3e} "
          f"(tolerance {SCATTER_CARD_CPU_REL}); gamma rel {errs[0]:.3e} "
          f"(tolerance {bar:.3e}: {SCATTER_CARD_CPU_REL} or twice the f32 "
          f"plain version's {gap32:.3e} from f64; the kernel's {gap_card:.3e})"
          f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"estep_ragged card and CPU disagree ({label})")
    return {"gamma_rel": errs[0], "gamma_f32_gap": gap32,
            "sstats_rel": errs[1], "score_rel": errs[2]}


def sstats_route_ms(buckets, gammas, eeb, alpha, cfg, dense_buckets,
                    plan) -> tuple:
    """CUDA-event ms of the sufficient statistics of one batch or minibatch
    by each route, at the same bucket-row gammas: the scatter (each
    bucket's expEtheta and ``scatter_sstats``) and the dense route (gamma
    assembly by ``dense_buckets``' row indices — the same rows in the same
    order — expEtheta and ``dense_sstats`` on each counts chunk of the
    sstats ``plan``)."""
    import torch

    from pylda_tpu_torch.models.vb import _assemble_gamma_device
    from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation
    from pylda_tpu_torch.ops.estep import scatter_sstats
    from pylda_tpu_torch.ops.ragged import gather_table
    from pylda_tpu_torch.ops.sstats import dense_sstats

    eeb_t = gather_table(eeb)
    rows = torch.cat(gammas)
    row_index = torch.cat([b.row_index for b in dense_buckets])

    def scatter():
        for b, g in zip(buckets, gammas):
            scatter_sstats(b.ids, b.cnts, exp_dirichlet_expectation(g), eeb,
                           eeb_t, cfg.eps)

    def dense():
        et = exp_dirichlet_expectation(_assemble_gamma_device(
            rows, row_index, alpha, plan.num_docs))
        for counts, cidx in plan.chunks:
            dense_sstats(counts, et[cidx], eeb, eps=cfg.eps)

    return cuda_ms(scatter, 10), cuda_ms(dense, 10)


def vb_scatter_vs_dense(label, cfg, corpus, dev, mods) -> dict:
    """Batch VB with ``sstats_mode="scatter"`` against its auto run (dense
    sstats) at pinned sweeps (threshold 0, ``inner_iterations`` sweeps)
    from one lambda: one E-step each, sstats (lambda - eta) rel and ELBO
    rel (summation order only: no document is split over rows here), then
    5 timed iterations of each; the scatter engine's launches are zeroed
    just before and read just after (its path: the gamma kernel only).
    Then the sstats of one iteration by each route at the same gammas
    (``sstats_route_ms``).  Raises past the bars."""
    import torch

    from pylda_tpu_torch.models import VariationalBayes
    from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation_fast

    pinned = dataclasses.replace(cfg, convergence_threshold=0.0)
    engs, out = {}, {}
    for mode in ("auto", "scatter"):
        if mode == "scatter":
            zero_launches(mods)
        eng = VariationalBayes(dataclasses.replace(pinned, sstats_mode=mode),
                               device=dev)
        eng.initialize(corpus)
        if (eng._sstats_plan is None) != (mode == "scatter"):
            raise AssertionError(f"{label}: {mode} took the wrong route")
        st, elbo, gammas = eng._iteration(False, eng._gamma0s(eng._batches))
        out[mode] = (st.lam - eng.state.eta[None, :], float(elbo), gammas)
        eng.learning_many(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.learning_many(5)
        torch.cuda.synchronize()
        out[mode] += ((time.perf_counter() - t0) / 5 * 1e3,)
        engs[mode] = eng
    counts = read_launches(mods)
    check_launched(f"{label} scatter", counts, ("ragged_gamma",),
                   absent=("dense_sstats",))
    ss_rel = norm_rel(out["scatter"][0], out["auto"][0])
    elbo_rel = abs(out["scatter"][1] - out["auto"][1]) / abs(out["auto"][1])
    # The scatter's bucket-row gammas; the auto engine's buckets hold the
    # same rows.
    auto = engs["auto"]
    scatter_ms, dense_ms = sstats_route_ms(
        engs["scatter"]._batches, out["scatter"][2],
        exp_dirichlet_expectation_fast(auto.state.lam), auto.state.alpha,
        cfg, auto._batches, auto._sstats_plan)
    ok = ss_rel <= SCATTER_SSTATS_REL and elbo_rel <= SCATTER_ELBO_REL
    print(f"{label}: scatter vs dense sstats from one lambda at "
          f"{cfg.inner_iterations} pinned sweeps: sstats rel {ss_rel:.3e} (tolerance {SCATTER_SSTATS_REL}), ELBO "
          f"{out['scatter'][1]:.2f} vs {out['auto'][1]:.2f} rel "
          f"{elbo_rel:.3e} (tolerance {SCATTER_ELBO_REL}) "
          f"{'ok' if ok else 'FAIL'}; an iteration {out['scatter'][3]:.3f} "
          f"ms (scatter) vs {out['auto'][3]:.3f} ms (dense sstats); sstats "
          f"of one iteration at the same gammas: scatter {scatter_ms:.4f} ms"
          f" vs dense_sstats {dense_ms:.4f} ms (with the gamma assembly; "
          f"CUDA events)")
    if not ok:
        raise AssertionError(f"{label}: scatter and dense sstats disagree")
    return {"launches": counts, "sstats_rel": ss_rel, "elbo_rel": elbo_rel,
            "scatter_ms": scatter_ms, "dense_sstats_ms": dense_ms,
            "iteration_ms_scatter": out["scatter"][3],
            "iteration_ms_dense": out["auto"][3]}


def svi_scatter_vs_dense(label, cfg, corpus, dev, mods) -> dict:
    """SVI with ``sstats_mode="scatter"`` against its auto run (dense
    sstats) from one lambda over one epoch: each minibatch's update by
    each route from the same lambda (the scatter's lambda carried on), the
    two lambdas within SCATTER_LAM_REL at every step — summation order
    only, since both routes run the gamma kernel on the same rows.  Each
    engine also runs the epoch on its own (``learning()``, launches of
    the scatter engine's zeroed just before and read just after: the
    gamma kernel only), and the two lambdas' distance is printed: there
    it also carries the fixed points' sensitivity to lambda's rounding
    (rows still updating at S* depend on it).  At the first minibatch of
    the next epoch: two calls of ``estep_ragged`` on each bucket give the
    same bits, and the sstats of the minibatch by each route
    (``sstats_route_ms``).  Raises past the bars."""
    import numpy as np
    import torch

    from pylda_tpu_torch.models import StochasticVariationalBayes
    from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation_fast
    from pylda_tpu_torch.ops.estep import estep_ragged
    from pylda_tpu_torch.ops.ragged import gather_table

    engs, lams, ests = {}, {}, {}
    for mode in ("auto", "scatter"):
        if mode == "scatter":
            zero_launches(mods)
        eng = StochasticVariationalBayes(
            dataclasses.replace(cfg, sstats_mode=mode), device=dev)
        eng.initialize(corpus)
        if (eng._mb_sstats is None) != (mode == "scatter"):
            raise AssertionError(f"{label}: {mode} took the wrong route")
        st0 = eng.state
        ests[mode] = eng.learning()
        lams[mode] = eng.state.lam
        engs[mode] = eng
    counts = read_launches(mods)
    check_launched(f"{label} scatter", counts, ("ragged_gamma",),
                   absent=("dense_sstats",))
    free_rel = norm_rel(lams["scatter"], lams["auto"])
    # The same epoch again, each minibatch's update from one lambda.
    sc, au = engs["scatter"], engs["auto"]
    ep_s, ep_a = sc._epoch(cfg.seed, 0), au._epoch(cfg.seed, 0)
    lam, step_rel = st0.lam, 0.0
    for rho, scale, (bs, _), (ba, sel) in zip(ep_s.rhos, ep_s.scales,
                                              ep_s.minibatches,
                                              ep_a.minibatches):
        lam_s = sc._minibatch_step(lam, st0.alpha, st0.eta, bs, rho, scale,
                                   None, ())[0]
        lam_a = au._minibatch_step(lam, st0.alpha, st0.eta, ba, rho, scale,
                                   sel[1], ())[0]
        step_rel = max(step_rel, norm_rel(lam_s, lam_a))
        lam = lam_s
    # The first minibatch of the next epoch, in each engine.
    seed = cfg.seed + 100003
    batches, _ = next(sc._epoch(seed, sc._t).minibatches)
    abatches, (_, sel) = next(au._epoch(seed, au._t).minibatches)
    st = sc.state
    eeb = exp_dirichlet_expectation_fast(st.lam)
    eeb_t = gather_table(eeb)
    kw = sc._fixed_point_kw()
    same, gammas = True, []
    for b in batches:
        g0 = torch.ones((b.ids.shape[0], cfg.number_of_topics), device=dev)
        one, two = (estep_ragged(b.ids, b.cnts, g0, eeb, st.alpha,
                                 eeb_t=eeb_t, **kw) for _ in range(2))
        same = same and all(torch.equal(x, y) for x, y in zip(one, two))
        gammas.append(one[0])
    scatter_ms, dense_ms = sstats_route_ms(
        batches, gammas, eeb, st.alpha, cfg, *au._local_plan(abatches, sel))
    ok = (step_rel <= SCATTER_LAM_REL and same
          and np.isfinite(ests["scatter"]))
    print(f"{label}: scatter vs dense sstats over one epoch from one lambda: "
          f"each minibatch's update from the same lambda, lambda rel at most "
          f"{step_rel:.3e} (tolerance {SCATTER_LAM_REL}); each engine's own "
          f"epoch: bound estimates {ests['scatter']:.2f} vs "
          f"{ests['auto']:.2f}, lambda rel {free_rel:.3e}; estep_ragged "
          f"twice on each of the minibatch's {len(batches)} buckets "
          f"{[tuple(b.ids.shape) for b in batches]}: gamma, sstats, score "
          f"and sweeps bitwise equal {same}; sstats of the minibatch at the "
          f"same gammas: scatter {scatter_ms:.4f} ms vs dense_sstats "
          f"{dense_ms:.4f} ms (with the gamma assembly; CUDA events) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the scatter route disagrees or is "
                             f"not repeatable")
    return {"launches": counts, "lambda_rel_a_step": step_rel,
            "lambda_rel_epoch": free_rel, "scatter_ms": scatter_ms,
            "dense_sstats_ms": dense_ms, "repeatable": same}


def write_doc_dat(corpus, directory: pathlib.Path) -> pathlib.Path:
    """The corpus's documents as doc.dat text (one line a document, its
    tokens' types), in a fresh ``directory``."""
    shutil.rmtree(directory, ignore_errors=True)
    directory.mkdir(parents=True)
    path = directory / "doc.dat"
    types = corpus.vocab.types
    with open(path, "w") as f:
        for doc in corpus.docs:
            f.write(" ".join([types[t] for t in doc]) + "\n")
    return path


def svi_streaming_vs_memory(label, cfg, corpus, dev, mods) -> dict:
    """SVI with ``sstats_mode="scatter"`` from a disk-backed
    ``StreamingCorpus`` (the corpus written to a doc.dat under build/, its
    row sidecar beside it) against the in-memory corpus, on the card:
    ``learning()`` then ``learning_many(1)`` in each, bitwise equal bound
    estimates, lambda and gamma (the JAX package's contract); launches
    zeroed just before the streaming run and read just after it (the
    in-memory run lies outside that window).  Raises if they differ."""
    import numpy as np
    import torch

    from pylda_tpu_torch.corpus.streaming import StreamingCorpus
    from pylda_tpu_torch.models import StochasticVariationalBayes

    t0 = time.perf_counter()
    path = write_doc_dat(corpus, STREAM_DIR)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    stream = StreamingCorpus(str(path), corpus.vocab)
    t_index = time.perf_counter() - t0
    if (stream.num_docs != corpus.num_docs
            or stream.num_tokens != corpus.num_tokens
            or stream._row_ids is None):
        raise AssertionError(f"{label}: the streaming corpus differs")
    scfg = dataclasses.replace(cfg, sstats_mode="scatter")
    runs = {}
    for name, c in (("memory", corpus), ("streaming", stream)):
        if name == "streaming":
            zero_launches(mods)
        t0 = time.perf_counter()
        eng = StochasticVariationalBayes(scfg, device=dev)
        eng.initialize(c)
        t_init = time.perf_counter() - t0
        if eng._mb_sstats is not None or eng._device_rows is None:
            raise AssertionError(f"{label}: {name} took the wrong route")
        ests = [eng.learning()] + eng.learning_many(1)
        runs[name] = (ests, eng.state.lam, eng.gamma, t_init)
    counts = read_launches(mods)  # the streaming run's alone
    check_launched(label, counts, ("ragged_gamma",), absent=("dense_sstats",))
    (e_m, lam_m, g_m, ti_m), (e_s, lam_s, g_s, ti_s) = (runs["memory"],
                                                        runs["streaming"])
    same = (e_m == e_s and torch.equal(lam_m, lam_s)
            and np.array_equal(g_m, g_s))
    print(f"{label}: {corpus.num_docs} documents written to {path} in "
          f"{t_write:.2f} s, indexed (row sidecar written) in {t_index:.2f} "
          f"s; initialize {ti_s:.2f} s streaming vs {ti_m:.2f} s in memory;"
          f" learning() + learning_many(1): bound estimates, lambda and gamma"
          f" bitwise equal to the in-memory run {same} "
          f"{'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"{label}: streaming and in-memory SVI differ")
    shutil.rmtree(STREAM_DIR, ignore_errors=True)
    return {"launches": counts, "index_s": t_index, "init_s": ti_s}


def svi_gamma_geometry(label, eng, cfg, dev) -> list:
    """Each gamma launch of an SVI engine's first minibatch at its
    lambda, one call a bucket (with its segments): the route, the
    geometry (``geometry_text``), the rows still streamed and the ms; a
    line and a record each."""
    import torch

    from pylda_tpu_torch.ops import ragged as ragged_mod
    from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation_fast
    from pylda_tpu_torch.ops.row_fixed_point import GEOMETRY

    eeb = exp_dirichlet_expectation_fast(eng.state.lam)
    eeb_t = ragged_mod.gather_table(eeb, cfg.compute_dtype)
    kw = dict(inner_iterations=cfg.inner_iterations,
              convergence_threshold=cfg.convergence_threshold, eps=cfg.eps,
              stall_patience=cfg.estep_stall_patience, eeb_t=eeb_t,
              compute_dtype=cfg.compute_dtype)
    batches, _ = next(eng._epoch(cfg.seed, 0).minibatches)
    out = []
    for i, b in enumerate(batches):
        g0 = torch.ones((b.ids.shape[0], cfg.number_of_topics), device=dev)
        geo = {}

        def call(geo=None, b=b, g0=g0):
            return ragged_mod.ragged_gamma(
                b.ids, b.cnts, g0, eeb, eng.state.alpha, geometry_out=geo,
                segments=b.segments, seg_rows=b.seg_rows, **kw)

        call(geo)
        ms = cuda_ms(call, 5)
        live = (b.cnts != 0).sum(dim=1)
        streamed = int(streamed_rows(geo, live)[0].sum())
        print(f"{label} gamma launch {i} [{b.ids.shape[0]}x{b.ids.shape[1]}, "
              f"K={cfg.number_of_topics}]: route {geo['route']}, "
              f"{geometry_text(geo)}, rows streamed {streamed} of "
              f"{int((live > 0).sum())}, kernel_ms {ms:.4f}")
        out.append({"shape": list(b.ids.shape), "route": geo["route"],
                    "streamed_rows": streamed, "ms": ms,
                    **{f: geo[f] for f in GEOMETRY}})
    return out


def run_svi4_full(label, cfg, corpus, test, dev, mods) -> dict:
    """SVI at BASELINE config 4's published size (SVI4_FULL_D documents):
    the corpus and its held-out documents made from their seeds;
    ``initialize`` (timed; auto must pick the scatter route — no counts
    matrix — and keep the rows on the device) and the point-estimate
    perplexity at init; then the training path, with the launch counters
    zeroed just before and read just after: one warm and two timed
    epochs, one more under ``torch.profiler`` (the gamma kernel must run,
    the sstats kernel must not); then the held-out path, zeroed and read
    the same way: ``inference``, ``perplexity`` and the point-estimate
    perplexity (it must fall).  The 512 held-out documents' dense counts
    fit the budget, so there the engine takes the dense-sstats route, as
    the JAX engine does.  The profiled epoch's device time is split into
    the gamma kernel, the scatter (the kernels under ``estep_ragged``'s
    profiler range) and the rest.  Returns the numbers, the engine and the
    launches of each path ("launches", "launches_heldout")."""
    import numpy as np
    import torch

    from pylda_tpu_torch.models import StochasticVariationalBayes
    from pylda_tpu_torch.ops.estep import SCATTER_RANGE

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = StochasticVariationalBayes(cfg, device=dev)
    eng.initialize(corpus)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    if eng._mb_sstats is not None or eng._device_rows is None:
        raise AssertionError(f"{label}: auto did not pick the scatter route "
                             f"with the rows on the device")
    rows_mb = sum(r.ids.numel() * 8 for r in eng._device_rows) / 1e6
    print(f"{label}: initialize {t_init:.2f} s; auto picked the scatter route"
          f" (no counts matrix: {(corpus.num_docs + 1) * 50_176 * 2 / 1e9:.2f}"
          f" GB in bf16 > {cfg.sstats_dense_total_budget_mb} MB); geometry "
          f"(width: rows a minibatch) {eng._svi_geometry}; device rows "
          f"{[tuple(r.ids.shape) for r in eng._device_rows]} ({rows_mb:.1f} "
          f"MB)")
    pe0 = eng.point_estimate_perplexity(test)
    gamma_launches = svi_gamma_geometry(label, eng, cfg, dev)
    zero_launches(mods)
    eng.learning_many(1)
    torch.cuda.synchronize()
    n = 2
    t0 = time.perf_counter()
    ests = eng.learning_many(n)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n
    nb = -(-corpus.num_docs // cfg.batch_size)
    print(f"{label}: learning_many({n}) {dt:.4f} s/epoch ({dt / nb * 1e3:.3f} "
          f"ms a minibatch, {nb} minibatches), {corpus.num_docs / dt:.1f} "
          f"docs/s; bound estimates {[round(e, 1) for e in ests]}; sweeps per "
          f"bucket (last minibatch) {[int(s) for s in eng.last_sweeps]}")
    prof = profile_window(lambda: eng.learning_many(1))
    print(f"{label}: one epoch under torch.profiler: wall "
          f"{prof['wall_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} ms, "
          f"idle share {prof['idle_share']:.3f}, {prof['device_launches']} "
          f"device launches")
    for count, dev_us, key in sorted(prof["ops"], key=lambda r: -r[1])[:10]:
        print(f"  {dev_us / 1e3:.3f} ms an epoch, {count} launches: "
              f"{key[:90]}")
    split = {"gamma_ms": sum(us for _, us, key in prof["ops"]
                             if "row_fixed_point" in key) / 1e3,
             "scatter_ms": prof["ranges"].get(SCATTER_RANGE, 0.0) / 1e3}
    split["rest_ms"] = (prof["busy_ms"] - split["gamma_ms"]
                        - split["scatter_ms"])
    print(f"{label}: the profiled epoch's device busy time by part: gamma "
          f"kernel {split['gamma_ms']:.3f} ms, scatter (range "
          f"{SCATTER_RANGE}: expEtheta and scatter_sstats) "
          f"{split['scatter_ms']:.3f} ms, the rest (plain tensor code: "
          f"gathers, bound terms, lambda updates) {split['rest_ms']:.3f} ms")
    if not (split["gamma_ms"] > 0 and split["scatter_ms"] > 0):
        raise AssertionError(f"{label}: the profile holds no gamma kernel or "
                             f"no scatter range")
    counts = read_launches(mods)
    check_launched(label, counts, ("ragged_gamma", "ragged_gamma_cluster"),
                   absent=("dense_sstats",))
    zero_launches(mods)
    t0 = time.perf_counter()
    ll, gamma = eng.inference(test)
    t_inf = time.perf_counter() - t0
    ppl = eng.perplexity(test)
    pe = eng.point_estimate_perplexity(test)
    peak = torch.cuda.max_memory_allocated(dev)
    held = read_launches(mods)
    if not (np.isfinite(ests).all() and np.isfinite(ll) and np.isfinite(ppl)
            and gamma.shape == (test.num_docs, cfg.number_of_topics)
            and np.isfinite(gamma).all()):
        raise AssertionError(f"{label}: not finite")
    print(f"{label}: inference on {test.num_docs} held-out docs "
          f"{t_inf * 1e3:.1f} ms (ll {ll:.1f}), perplexity {ppl:.2f}, "
          f"point-estimate perplexity {pe:.2f} (at init {pe0:.2f}); peak "
          f"device memory {peak / 2**20:.1f} MiB")
    if not pe < pe0:
        raise AssertionError(f"{label}: held-out point-estimate perplexity "
                             f"did not fall ({pe0:.2f} -> {pe:.2f})")
    check_launched(f"{label} held-out", held, ("ragged_gamma",
                                               "dense_sstats"))
    return {"launches": counts, "launches_heldout": held, "engine": eng,
            "init_s": t_init, "epoch_s": dt,
            "docs_per_s": corpus.num_docs / dt,
            "busy_ms": prof["busy_ms"], "idle_share": prof["idle_share"],
            "wall_ms": prof["wall_ms"], "peak_mib": peak / 2**20,
            "perplexity": ppl, "point_perplexity": pe,
            "point_perplexity_init": pe0, "gamma_launches": gamma_launches,
            **split}


# The roofline: a phase's bound over its measured time may not pass this
# (a bound is the least time the card could take; above 1 the cost model
# counts work the code does not do, and timing noise is far below 5%).
ROOFLINE_RATIO_MAX = 1.05
# The random gamma inits drawn on the card (1 + 0.1 N(0, 1) clipped at
# 0.2, or Gamma(100) * 0.01): mean and std within these of 1 and 0.1.
GAMMA0_MEAN_TOL, GAMMA0_STD_TOL = 0.005, 0.005
GAMMA0_ITERATIONS = 6
GAMMA0_TEST_DOCS = 512  # held-out documents of the card-vs-CPU check
NATIVE_DIR = REPO / "build" / "chip_smoke_native"
OBS_OUT = REPO / "build" / "chip_smoke_cli" / "observability"
# The port's CUDA kernels by the names a profiler trace gives them.
KERNEL_NAMES = ("row_fixed_point", "dense_sstats_kernel")


def state_of(eng) -> list:
    """Copies of what phase timing must leave as it was: lambda, alpha,
    eta, the step, SVI's minibatch counter and Gibbs's chains."""
    st = eng.state
    out = [t.clone() for t in (st.lam, st.alpha, st.eta, st.step)]
    out.append(getattr(eng, "_t", None))
    if hasattr(eng, "_n_kv"):
        out += [eng._n_kv.clone()] + [t.clone() for t in eng._z + eng._ndk]
    return out


def same_state(a: list, b: list) -> bool:
    import torch

    return len(a) == len(b) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(a, b))


def roofline_phase(label, eng, mods, iteration_ms=None) -> dict:
    """``phase_timings`` and ``roofline_report`` on an engine at its cell,
    launch counters zeroed just before and read just after: each phase
    beside its bound and the unclipped bound / measured ratio, which may
    not pass ROOFLINE_RATIO_MAX; the engine's state bitwise unchanged by
    the timing.  For batch VB, ``iteration_ms`` (a measured
    ``learning_many`` iteration) is printed beside estep_total_ms +
    mstep_ms."""
    from pylda_tpu_torch.utils.roofline import roofline_report

    before = state_of(eng)
    zero_launches(mods)
    times = eng.phase_timings(repeats=3)
    rows = roofline_report(eng, timings=times)
    counts = read_launches(mods)
    unchanged = same_state(before, state_of(eng))
    print(f"{label}: phase_timings (ms, best of 3, CUDA events) "
          f"{json.dumps(times)}")
    ratios = {}
    for phase, r in rows.items():
        if phase == "sweep_counts":
            print(f"  sweep counts a batch {[int(s) for s in r]}")
            continue
        ratios[phase] = r["bound_ms"] / r["measured_ms"]
        print(f"  {phase}: measured {r['measured_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms, bound / measured {ratios[phase]:.4f} "
              f"(at most {ROOFLINE_RATIO_MAX})")
    if iteration_ms is not None:
        print(f"  estep_total_ms + mstep_ms "
              f"{times['estep_total_ms'] + times['mstep_ms']:.4f} against a "
              f"measured learning_many iteration of {iteration_ms:.4f} ms")
    print(f"  state (lambda, alpha, eta, step, _t, chains) bitwise unchanged "
          f"by the timing: {unchanged}")
    if not unchanged:
        raise AssertionError(f"{label}: phase_timings changed the state")
    bad = {k: v for k, v in ratios.items() if not v <= ROOFLINE_RATIO_MAX}
    if not ratios or bad:
        raise AssertionError(f"{label}: bound / measured above "
                             f"{ROOFLINE_RATIO_MAX}: {bad or 'no rows'}")
    return {"timings": times, "rows": rows, "launches": counts}


def vb_gamma_init(label, cfg, corpus, test, dev, mods, gamma_name) -> dict:
    """Batch VB with each random ``gamma_init`` at one flagship: the
    gamma inits drawn on the card (their mean, std and minimum, and the
    same bits from one seed twice); learning_many(GAMMA0_ITERATIONS) from
    them, launch counters zeroed just before and read just after (the
    gamma kernel ``gamma_name`` must run), the ELBO finite and rising;
    then held-out inference on the card against the CPU plain version
    handed the card's gamma inits (the bound within ELBO_RTOL, the
    card-vs-CPU bar).  Returns the launches of each mode's run."""
    import numpy as np
    import torch

    from pylda_tpu_torch.models import VariationalBayes
    from pylda_tpu_torch.models.vb import TAG_GAMMA_FUSED, TAG_GAMMA_TEST

    out = {}
    for mode in ("gamma", "normal"):
        gcfg = dataclasses.replace(cfg, gamma_init=mode)
        eng = VariationalBayes(gcfg, device=dev)
        eng.initialize(corpus)
        g0 = eng._gamma0s(eng._batches, TAG_GAMMA_FUSED, 0)
        again = eng._gamma0s(eng._batches, TAG_GAMMA_FUSED, 0)
        same = all(torch.equal(a, b) for a, b in zip(g0, again))
        flat = torch.cat([g.reshape(-1) for g in g0]).double()
        mean, std, low = float(flat.mean()), float(flat.std()), float(flat.min())
        ok = (abs(mean - 1.0) <= GAMMA0_MEAN_TOL
              and abs(std - 0.1) <= GAMMA0_STD_TOL
              and (low >= 0.2 if mode == "normal" else low > 0.0) and same)
        print(f"{label} gamma_init={mode}: {flat.numel()} gamma inits drawn "
              f"on the card: mean {mean:.5f} (1 +- {GAMMA0_MEAN_TOL}), std "
              f"{std:.5f} (0.1 +- {GAMMA0_STD_TOL}), min {low:.4f}, the same "
              f"bits drawn twice {same} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label} gamma_init={mode}: the draws")
        del g0, again, flat
        zero_launches(mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        elbos = eng.learning_many(GAMMA0_ITERATIONS)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / GAMMA0_ITERATIONS
        counts = read_launches(mods)
        print(f"{label} gamma_init={mode}: learning_many"
              f"({GAMMA0_ITERATIONS}) {dt * 1e3:.3f} ms/iteration, ELBOs "
              f"{[round(e, 1) for e in elbos]}; sweeps per batch "
              f"{[int(s) for s in eng.last_sweeps]}")
        if not (np.isfinite(elbos).all() and elbos[-1] > elbos[0]):
            raise AssertionError(f"{label} gamma_init={mode}: ELBO not "
                                 f"finite or not rising")
        check_launched(f"{label} gamma_init={mode}", counts, (gamma_name,))
        # The held-out E-step on the card, and on the CPU from the card's
        # gamma inits (the same layout of the same documents).
        g_test = [g.cpu() for g in eng._gamma0s(
            eng._build_batches(test), TAG_GAMMA_TEST, eng._counter)]
        ll_card, _ = eng.inference(test)
        cpu = VariationalBayes(gcfg, device="cpu")
        cpu._vocab = corpus.vocab
        cpu.state = eng.state
        cpu._gamma0s = lambda batches, *tag: g_test
        t0 = time.perf_counter()
        ll_cpu, _ = cpu.inference(test)
        rel = abs(ll_card - ll_cpu) / abs(ll_cpu)
        print(f"{label} gamma_init={mode}: held-out bound on {test.num_docs} "
              f"docs from the card's gamma inits: card {ll_card:.2f}, CPU "
              f"plain version {ll_cpu:.2f} ({time.perf_counter() - t0:.1f} s),"
              f" rel {rel:.2e} (tolerance {ELBO_RTOL}) "
              f"{'ok' if rel <= ELBO_RTOL else 'FAIL'}")
        if not rel <= ELBO_RTOL:
            raise AssertionError(f"{label} gamma_init={mode}: card and CPU "
                                 f"disagree")
        out[mode] = counts
        del eng, cpu
    return out


class python_parser:
    """Within it, corpora parse in Python: the C tokenizer is set aside
    (``pylda_tpu_torch.native``'s loaded module), and restored after."""

    def __enter__(self):
        from pylda_tpu_torch import native

        self._saved = native.native_module()
        native._STATE["module"] = None

    def __exit__(self, *exc):
        from pylda_tpu_torch import native

        native._STATE["module"] = self._saved


def native_index(label, cfg, corpus, dev) -> dict:
    """The streaming index pass (``StreamingCorpus``: line offsets, the
    parse, the row sidecar) and SVI's ``initialize`` from a doc.dat of
    ``corpus``, once with the C tokenizer and once with the Python parser,
    each from its own copy of the file: the C tokenizer must be built
    (``HAVE_NATIVE``), the sidecars' bytes and the engines' device rows
    bitwise equal.  Returns the times."""
    import torch

    from pylda_tpu_torch import native
    from pylda_tpu_torch.corpus.streaming import StreamingCorpus
    from pylda_tpu_torch.models import StochasticVariationalBayes

    if not native.HAVE_NATIVE:
        raise AssertionError(f"{label}: the C tokenizer did not build: "
                             f"{native.BUILD_ERROR}")
    shutil.rmtree(NATIVE_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    path = write_doc_dat(corpus, NATIVE_DIR / "native")
    t_write = time.perf_counter() - t0
    (NATIVE_DIR / "python").mkdir()
    shutil.copy(path, NATIVE_DIR / "python" / "doc.dat")
    scfg = dataclasses.replace(cfg, sstats_mode="scatter")
    runs = {}
    for route in ("native", "python"):
        ctx = python_parser() if route == "python" else contextlib.nullcontext()
        with ctx:
            t0 = time.perf_counter()
            sc = StreamingCorpus(str(NATIVE_DIR / route / "doc.dat"),
                                 corpus.vocab)
            t_index = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng = StochasticVariationalBayes(scfg, device=dev)
        eng.initialize(sc)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        side = sorted((NATIVE_DIR / route).glob("doc.dat.rowcache.v2.*/*"))
        runs[route] = dict(
            index_s=t_index, init_s=t_init,
            side={p.name: p.read_bytes() for p in side
                  if p.name != "meta.json"},
            rows=[t for r in eng._device_rows
                  for t in (r.ids, r.cnts, r.counts) if t is not None],
            tokens=sc.num_tokens)
        del eng, sc
    a, b = runs["native"], runs["python"]
    same = (a["side"] == b["side"] and len(a["side"]) >= 6
            and a["tokens"] == b["tokens"] == corpus.num_tokens
            and len(a["rows"]) == len(b["rows"])
            and all(torch.equal(x, y) for x, y in zip(a["rows"], b["rows"])))
    print(f"{label}: {corpus.num_docs} documents ({corpus.num_tokens} tokens)"
          f" written in {t_write:.2f} s; index pass native "
          f"{a['index_s']:.3f} s, Python {b['index_s']:.3f} s "
          f"({b['index_s'] / a['index_s']:.2f}x); initialize native "
          f"{a['init_s']:.3f} s, Python {b['init_s']:.3f} s; sidecars and "
          f"device rows bitwise equal {same} {'ok' if same else 'FAIL'}")
    shutil.rmtree(NATIVE_DIR, ignore_errors=True)
    if not same:
        raise AssertionError(f"{label}: the two parsers' rows differ")
    return {"docs": corpus.num_docs, "write_s": t_write,
            "index_native_s": a["index_s"], "index_python_s": b["index_s"],
            "init_native_s": a["init_s"], "init_python_s": b["init_s"]}


def cli_observability(mods) -> dict:
    """train with --phase_timing --roofline --coherence --tensorboard_dir
    --profile_dir, then test --coherence, through the CLIs' main() on the
    bundled corpus on the card; launch counters zeroed just before and
    read just after.  metrics.jsonl must hold the phase_timing, roofline,
    roofline_measured and coherence events (each measured row within
    ROOFLINE_RATIO_MAX), the TensorBoard event file must exist (or a
    tensorboard_unavailable event say why), and the profiler trace must
    name one of the port's CUDA kernels."""
    from pylda_tpu_torch.cli import test as cli_test
    from pylda_tpu_torch.cli import train as cli_train
    from pylda_tpu_torch.corpus.datasets import bundled_corpus_dir

    shutil.rmtree(OBS_OUT, ignore_errors=True)
    tb, prof = OBS_OUT / "tensorboard", OBS_OUT / "profile"
    zero_launches(mods)
    t0 = time.perf_counter()
    rc = cli_train.main([
        f"--input_directory={bundled_corpus_dir()}",
        f"--output_directory={OBS_OUT}", "--number_of_topics=10",
        "--training_iterations=6", "--snapshot_interval=3", "--phase_timing",
        "--roofline", "--coherence", f"--tensorboard_dir={tb}",
        f"--profile_dir={prof}",
    ])
    runs = sorted((OBS_OUT / "de-news-tiny").iterdir())
    if rc != 0 or len(runs) != 1:
        raise AssertionError(f"cli observability: rc {rc}, runs {runs}")
    with open(runs[0] / "metrics.jsonl") as f:
        events = [json.loads(line) for line in f]
    kinds = {e["event"] for e in events}
    rc_test = cli_test.main([f"--model={runs[0] / 'model-6'}",
                             f"--input_directory={bundled_corpus_dir()}",
                             f"--output_file={OBS_OUT / 'gamma.test'}",
                             "--coherence"])
    wall = time.perf_counter() - t0
    counts = read_launches(mods)
    tb_files = list(tb.glob("events.out.tfevents.*"))
    trace = (prof / cli_train.PROFILE_TRACE).read_text()
    named = [k for k in KERNEL_NAMES if k in trace]
    measured = [e for e in events if e["event"] == "roofline_measured"
                and "bound_ms" in e]
    ratios = {e["phase"]: e["bound_ms"] / e["measured_ms"] for e in measured}
    need = {"phase_timing", "roofline", "roofline_measured", "coherence"}
    ok = (need <= kinds and rc_test == 0 and named and ratios
          and all(r <= ROOFLINE_RATIO_MAX for r in ratios.values())
          and (tb_files or "tensorboard_unavailable" in kinds))
    print(f"cli observability: train 6 iterations with --phase_timing "
          f"--roofline --coherence --tensorboard_dir --profile_dir, then test "
          f"--coherence, in {wall:.2f} s; events {sorted(kinds)}; phase_timing "
          f"{[e for e in events if e['event'] == 'phase_timing']}; roofline "
          f"bound / measured {ratios}; coherence "
          f"{[e['mean_umass'] for e in events if e['event'] == 'coherence']};"
          f" TensorBoard files {[p.name for p in tb_files]}; the trace "
          f"({len(trace) / 1e6:.1f} MB) names {named} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("cli observability: missing events, files or "
                             "kernels")
    check_launched("cli observability", counts,
                   ("dense_gamma", "dense_sstats"))
    return counts


# -- across ranks: parallel/mesh.py ------------------------------------------

DIST_DIR = REPO / "build" / "chip_smoke_dist"
# Batch-VB iterations of each distributed phase, at pinned sweeps
# (threshold 0, 50 sweeps a row) so a rank's batches and the one-process
# batches run the same sweeps: DIST_ITERS learning() calls, the replicas
# checked after each, then DIST_TIMED in one timed learning_many.  Gibbs
# sweeps and hybrid iterations of the sampling phases (the first one
# untimed).
DIST_ITERS, DIST_TIMED, DIST_SWEEPS = 3, 3, 4
# phase_timings' repeats for the all-reduce (the best of them, after a
# warm call).
DIST_TIMING_REPEATS = 5
# Two ranks against one process at pinned sweeps: the sufficient
# statistics (lambda - eta after the first iteration; max-entry relative)
# and each ELBO.  Only the summation order over documents differs.
DIST_REL = 1e-5
# The config-1 CLI across two processes against one process, lambda of
# model-6 (max-entry relative).  Both run with the stall exit off: a
# rank's batches hold its own documents, so with it on a stalled row's
# last sweep follows its rank's batch (ROADMAP Queue 3; 2.3e-3 on the
# CPU), while the per-row freeze at the threshold keeps each row
# independent of its batch.
CLI_DIST_REL = 1e-3
# Seconds a rank may run, and its process group's timeout.
DIST_RANK_LIMIT, DIST_GROUP_TIMEOUT = 600, 300
# The collectives each phase must make: two all-reduces a batch-VB or
# hybrid iteration and an SVI minibatch (the sufficient statistics, the
# packed doc-level scalars), n_kv and the doc side a Gibbs sweep (and n_kv
# once at initialize).
DIST_SVI5_MINIBATCHES = 4  # an epoch: 4096 documents a rank, 1024 a minibatch
# ... and of the corpus whole on every rank of a model group: 8192
# documents, 2048 a minibatch.
DIST_SVI5_MINIBATCHES_WHOLE = 4


def dist_cfg(name: str):
    """The configuration of a distributed phase (the matching one-rank
    cell's, batch VB at pinned sweeps)."""
    from pylda_tpu_torch.utils.config import LDAConfig

    if name == "vb":
        return LDAConfig(number_of_topics=K, inference_mode="vb",
                         inner_iterations=50, convergence_threshold=0.0,
                         seed=0)
    if name == "svi5":
        return LDAConfig(number_of_topics=SVI5["K"], inference_mode="svi",
                         batch_size=SVI5["BATCH"], tau0=64.0, kappa=0.7,
                         seed=0, inner_iterations=SVI5["INNER"])
    return LDAConfig(number_of_topics=CFG3["K"], inference_mode=name,
                     number_of_samples=CFG3["SAMPLES"],
                     burn_in_sweeps=CFG3["BURN_IN"], seed=0)


@functools.lru_cache(maxsize=None)
def dist_corpus(name: str):
    """(training corpus, held-out corpus or None) of a distributed phase:
    the ragged flagship, SVI config 5, or BASELINE config 3 with its 512
    held-out documents (made once a process)."""
    from pylda_tpu_torch.corpus.synthetic import synthetic_corpus

    if name == "vb":
        return synthetic_corpus(num_docs=D, num_topics=K, num_types=V,
                                mean_doc_length=MEAN_LEN, seed=0)[0], None
    if name == "svi5":
        kw = dict(num_topics=SVI5["K"], num_types=SVI5["V"],
                  mean_doc_length=SVI5["LEN"])
        corpus, beta, _ = synthetic_corpus(num_docs=SVI5["D"],
                                           seed=SVI5["SEED"], **kw)
        test = synthetic_corpus(num_docs=SVI5["TEST_DOCS"],
                                seed=SVI5["TEST_SEED"], beta=beta, **kw)[0]
        return corpus, test
    kw = dict(num_topics=CFG3["K"], num_types=CFG3["V"],
              mean_doc_length=CFG3["LEN"])
    corpus, beta, _ = synthetic_corpus(num_docs=CFG3["D"], seed=CFG3["SEED"],
                                       **kw)
    test = synthetic_corpus(num_docs=CFG3["TEST_DOCS"],
                            seed=CFG3["TEST_SEED"], beta=beta, **kw)[0]
    return corpus, test


def dist_lam0(cfg, V_):
    import numpy as np

    return np.random.default_rng(7).gamma(100.0, 0.01,
                                          (cfg.number_of_topics, V_))


def dist_vb(label, mesh, dev, mods) -> dict:
    """Batch VB at the ragged flagship over ``mesh`` (``None``: one
    process): DIST_ITERS learning() calls from one lambda at pinned
    sweeps, the replicas checked after each, then learning_many
    (DIST_TIMED) timed; the launches and all-reduces of those calls, then
    phase_timings' all-reduce.  Returns numbers and the tensors to
    compare."""
    import torch

    from pylda_tpu_torch.models import VariationalBayes
    from pylda_tpu_torch.parallel import mesh as pmesh

    cfg = dist_cfg("vb")
    corpus, _ = dist_corpus("vb")
    eng = VariationalBayes(cfg, device=dev)
    eng.initialize(corpus, lam_init=dist_lam0(cfg, V), mesh=mesh)
    zero_launches(mods)
    pmesh.COLLECTIVES.clear()
    objs, lam1 = [], None
    for i in range(DIST_ITERS):
        objs.append(eng.learning())
        if mesh is not None:
            pmesh.assert_replicas_consistent(eng.state, mesh)
        if i == 0:
            lam1 = eng.state.lam.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    objs += eng.learning_many(DIST_TIMED)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if mesh is not None:
        pmesh.assert_replicas_consistent(eng.state, mesh)
    out = {"objs": objs, "ms_per_iteration": secs / DIST_TIMED * 1e3,
           "launches": read_launches(mods),
           "all_reduce": pmesh.COLLECTIVES["all_reduce"],
           "sstats1": lam1 - eng.state.eta[None, :], "lam": eng.state.lam,
           "lam_sum": float(eng.state.lam.double().sum())}
    if mesh is not None and mesh.grouped:
        t = eng.phase_timings(DIST_TIMING_REPEATS)
        out.update(allreduce_ms=t["allreduce_ms"],
                   allreduce_bytes=t["allreduce_bytes"])
    print(f"{label}: {DIST_ITERS} + {DIST_TIMED} iterations, "
          f"{out['ms_per_iteration']:.3f} ms an iteration (learning_many), ELBOs {[round(e, 1) for e in objs]}, "
          f"all-reduces {out['all_reduce']}"
          + (f", one all-reduce of {out['allreduce_bytes']} bytes "
             f"{out['allreduce_ms']:.3f} ms" if "allreduce_ms" in out
             else ""))
    return out


def dist_svi5(label, mesh, dev, mods) -> dict:
    """SVI config 5 over ``mesh``: a process-local block a rank (the
    negotiated geometry), one epoch from the seed's lambda (learning(),
    the replicas checked), then one timed (learning_many), held-out
    point-estimate perplexity before and after; or (``mesh`` of one rank,
    or None) the whole corpus."""
    import torch

    from pylda_tpu_torch.models import StochasticVariationalBayes
    from pylda_tpu_torch.parallel import mesh as pmesh

    cfg = dist_cfg("svi5")
    corpus, test = dist_corpus("svi5")
    if mesh is not None and mesh.data > 1:
        lo, hi = pmesh.block_bounds(corpus.num_docs, mesh.rank, mesh.data)
        block = corpus.subset(range(lo, hi))
        block.process_local = True
        block.global_num_docs = corpus.num_docs
        block.global_doc_offset = lo
        corpus = block
    torch.cuda.reset_peak_memory_stats(dev)
    eng = StochasticVariationalBayes(cfg, device=dev)
    eng.initialize(corpus, lam_init=dist_lam0(cfg, SVI5["V"]), mesh=mesh)
    pp0 = eng.point_estimate_perplexity(test)
    zero_launches(mods)
    pmesh.COLLECTIVES.clear()
    est = eng.learning()
    if mesh is not None:
        pmesh.assert_replicas_consistent(eng.state, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est2 = eng.learning_many(1)[0]
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    out = {"objs": [est, est2], "epoch_s": epoch_s,
           "launches": read_launches(mods),
           "all_reduce": pmesh.COLLECTIVES["all_reduce"],
           "lam": eng.state.lam,
           "lam_sum": float(eng.state.lam.double().sum()),
           "geometry": {str(w): int(c) for w, c in sorted(
               (eng._svi_geometry or {}).items())}}
    if mesh is not None:
        pmesh.assert_replicas_consistent(eng.state, mesh)
    pp1 = eng.point_estimate_perplexity(test)
    out.update(pp0=pp0, pp1=pp1,
               peak_mib=torch.cuda.max_memory_allocated(dev) / 2**20)
    if mesh is not None and mesh.grouped:
        t = eng.phase_timings(DIST_TIMING_REPEATS)
        out.update(allreduce_ms=t["allreduce_ms"],
                   allreduce_bytes=t["allreduce_bytes"],
                   minibatch_ms=t["svi_minibatch_ms"])
    print(f"{label}: the second epoch {epoch_s:.4f} s (estimates {est:.1f}, "
          f"{est2:.1f}), "
          f"all-reduces {out['all_reduce']}, geometry {out['geometry']}, "
          f"held-out point-estimate perplexity {pp0:.2f} -> {pp1:.2f}, peak "
          f"{out['peak_mib']:.1f} MiB"
          + (f", one all-reduce of {out['allreduce_bytes']} bytes "
             f"{out['allreduce_ms']:.3f} ms, a minibatch "
             f"{out['minibatch_ms']:.3f} ms" if "allreduce_ms" in out
             else ""))
    if not pp1 < pp0:
        raise AssertionError(f"{label}: held-out perplexity did not fall")
    return out


def dist_sampling(label, name, mesh, dev, mods) -> dict:
    """Gibbs or hybrid at config 3 over ``mesh``: DIST_SWEEPS sweeps or
    iterations, counts conserved globally, the replicated tables checked
    after each; no kernel may launch."""
    import numpy as np
    import torch

    from pylda_tpu_torch.models import Hybrid, MonteCarlo
    from pylda_tpu_torch.parallel import mesh as pmesh

    cfg = dist_cfg(name)
    corpus, _ = dist_corpus(name)
    eng = (MonteCarlo if name == "gibbs" else Hybrid)(cfg, device=dev)
    zero_launches(mods)
    pmesh.COLLECTIVES.clear()
    eng.initialize(corpus, mesh=mesh)
    objs, secs = [], 0.0
    for i in range(DIST_SWEEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        objs.append(eng.learning())
        if i:
            secs += time.perf_counter() - t0
        tables = ({"n_kv": eng._n_kv} if name == "gibbs"
                  else {"lam": eng.state.lam})
        pmesh.assert_replicas_consistent(tables, mesh)
    if name == "gibbs":
        total = float(eng._n_kv.sum(dtype=torch.float64))
    else:
        st = eng.state
        total = float((st.lam - st.eta[None, :]).sum(dtype=torch.float64))
    ok = (abs(total - corpus.num_tokens) <= 1e-5 * corpus.num_tokens
          and np.isfinite(objs).all())
    out = {"objs": objs, "ms_per_sweep": secs / (DIST_SWEEPS - 1) * 1e3,
           "launches": read_launches(mods),
           "all_reduce": pmesh.COLLECTIVES["all_reduce"], "total": total,
           "lam_sum": float(eng.state.lam.double().sum())}
    print(f"{label}: {DIST_SWEEPS} {'sweeps' if name == 'gibbs' else 'iterations'}"
          f", the last {DIST_SWEEPS - 1} {out['ms_per_sweep']:.3f} ms each, "
          f"objectives "
          f"{[round(o, 1) for o in objs]}, counts {total:.1f} of "
          f"{corpus.num_tokens} tokens {'ok' if ok else 'FAIL'}, all-reduces "
          f"{out['all_reduce']}")
    if not ok:
        raise AssertionError(f"{label}: counts not conserved or not finite")
    return out


# Lambda split over the model axis (``--shard_vocab`` / ``--shard_topics``):
# the ragged flagship at mesh (1, 2) and (2, 2), config 5 at (1, 2).  Its
# default-settings runs are held to one process at tests/test_sharding.py's
# bars: batch VB ELBO rel 1e-4 and topic-word atol 3e-3 (:74, :90), SVI
# estimates rel 1e-3 and lambda rtol 5e-3 atol 1e-5 (:188), and at pinned
# sweeps rel 1e-4 and rtol 2e-4 (:211); batch VB at pinned sweeps within
# DIST_REL (ELBOs and the gathered lambda), SVI in bf16 at BF16_ELBO_RTOL.
SHARD_VB_ELBO_REL, SHARD_TWD_ATOL = 1e-4, 3e-3
SHARD_SVI_EST_REL, SHARD_SVI_LAM_RTOL, SHARD_SVI_LAM_ATOL = 1e-3, 5e-3, 1e-5
SHARD_SVI_PINNED_REL, SHARD_SVI_PINNED_RTOL = 1e-4, 2e-4
SHARD_DEFAULT_ITERS = 3


def shard_cfg(name: str, mode: str, shape, **kw):
    """A shard phase's config: ``dist_cfg(name)`` (pinned batch VB, or
    config 5 SVI at its defaults) with the flag of ``mode`` and the mesh,
    then ``kw``."""
    return dataclasses.replace(
        dist_cfg(name), mesh_shape=tuple(shape),
        **{"shard_vocab" if mode == "vocab" else "shard_topics": True}, **kw)


def shard_collectives(mode: str, steps: int, ends: int, checks: int) -> dict:
    """The collectives a shard run must make: a step (a batch-VB iteration
    or an SVI minibatch) gathers expElogbeta once and all-reduces the
    sufficient statistics and the packed doc-level terms over the data
    group, and under ``shard_vocab`` the row sums and the token score over
    the model group; the bound's topic side (an iteration's, an epoch's
    end) all-reduces its part (and the row sums again under
    ``shard_vocab``); each replica check gathers checksums and block
    shapes (two host gathers)."""
    vocab = mode == "vocab"
    return {"all_reduce": steps * (4 if vocab else 2) + ends * (2 if vocab
                                                                 else 1),
            "all_gather": steps + 2 * checks}


def shard_vb(label, mode, mesh, dev, mods) -> dict:
    """Batch VB at the ragged flagship with lambda split over the model
    group: at pinned sweeps DIST_ITERS learning() calls (each lambda block
    checked bitwise across its data group and the blocks' tiling after
    each) and DIST_TIMED timed in learning_many, then phase_timings'
    all-reduce and all-gather; at default settings (mesh (1, M) only)
    SHARD_DEFAULT_ITERS learning() calls, and as many in bf16 for
    ``shard_topics``.  Each run's launches and
    collectives are zeroed just before and read just after; rank 0 saves
    the gathered lambdas."""
    import torch

    from pylda_tpu_torch.models import VariationalBayes
    from pylda_tpu_torch.parallel import mesh as pmesh

    corpus, _ = dist_corpus("vb")
    shape = (mesh.data, mesh.model)
    runs = [("pinned", shard_cfg("vb", mode, shape))]
    if mesh.data == 1:
        runs.append(("default", shard_cfg(
            "vb", mode, shape, convergence_threshold=1e-5)))
    if mesh.data == 1 and mode == "topics":
        # The topic range's bf16 build on its main path.
        runs.append(("bf16", shard_cfg("vb", mode, shape,
                                       convergence_threshold=1e-5,
                                       compute_dtype=BF16)))
    out = {}
    for name, cfg in runs:
        torch.cuda.reset_peak_memory_stats(dev)
        eng = VariationalBayes(cfg, device=dev)
        eng.initialize(corpus, lam_init=dist_lam0(cfg, V), mesh=mesh)
        zero_launches(mods)
        pmesh.COLLECTIVES.clear()
        iters = DIST_ITERS if name == "pinned" else SHARD_DEFAULT_ITERS
        objs, sstats1 = [], None
        for i in range(iters):
            objs.append(eng.learning())
            pmesh.assert_replicas_consistent(eng.state, mesh, sharded=("lam",),
                                             full_shape=(K, V))
            if i == 0 and name == "pinned":
                # The first step's sufficient statistics, gathered.
                sstats1 = (eng.gathered_lam() - eng.state.eta[None, :]).cpu()
        r = {}
        if name == "pinned":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            objs += eng.learning_many(DIST_TIMED)
            torch.cuda.synchronize()
            r["ms_per_iteration"] = (time.perf_counter() - t0) / DIST_TIMED * 1e3
        steps = len(objs)
        # The gather of the first step's sstats is the test's own.
        gathers = steps + 2 * iters + (sstats1 is not None)
        r.update(objs=objs, launches=read_launches(mods),
                 collectives=dict(pmesh.COLLECTIVES),
                 expected={**shard_collectives(mode, steps, steps, iters),
                           "all_gather": gathers},
                 block=list(eng.state.lam.shape),
                 peak_mib=torch.cuda.max_memory_allocated(dev) / 2**20)
        lam = eng.gathered_lam()
        r["lam_sum"] = float(lam.double().sum())
        if name == "pinned":
            t = eng.phase_timings(DIST_TIMING_REPEATS)
            r.update({k: t[k] for k in ("allreduce_ms", "allreduce_bytes",
                                        "allgather_ms", "allgather_bytes")})
        if mesh.rank == 0:
            torch.save(lam.cpu(), DIST_DIR / f"{label.split()[0]}_{name}.pt")
            if sstats1 is not None:
                torch.save(sstats1, DIST_DIR / f"{label.split()[0]}_sstats1.pt")
        print(f"{label} {name}: {len(objs)} iterations, blocks {r['block']}, "
              f"ELBOs {[round(e, 1) for e in objs]}, collectives "
              f"{r['collectives']} (expected {r['expected']})"
              + (f", {r['ms_per_iteration']:.3f} ms an iteration "
                 f"(learning_many), all-gather of {r['allgather_bytes']} bytes "
                 f"{r['allgather_ms']:.3f} ms, all-reduce of "
                 f"{r['allreduce_bytes']} bytes {r['allreduce_ms']:.3f} ms"
                 if name == "pinned" else "")
              + f", peak {r['peak_mib']:.1f} MiB")
        out[name] = r
        del eng, lam
    return out


def shard_svi5(label, mode, mesh, dev, mods) -> dict:
    """SVI config 5 with lambda split over the model group (the corpus
    whole on each rank: the one-process schedule): two epochs (learning(),
    the blocks checked, then learning_many(1) timed) at its defaults and
    at pinned sweeps, one epoch in bf16; then phase_timings' minibatch,
    all-reduce and all-gather.  Rank 0 saves each run's gathered
    lambda."""
    import torch

    from pylda_tpu_torch.models import StochasticVariationalBayes
    from pylda_tpu_torch.parallel import mesh as pmesh

    corpus, _ = dist_corpus("svi5")
    shape = (mesh.data, mesh.model)
    runs = (("default", shard_cfg("svi5", mode, shape), 2),
            ("pinned", shard_cfg("svi5", mode, shape,
                                 convergence_threshold=0.0), 2),
            ("bf16", shard_cfg("svi5", mode, shape, compute_dtype=BF16), 1))
    out = {}
    for name, cfg, epochs in runs:
        torch.cuda.reset_peak_memory_stats(dev)
        eng = StochasticVariationalBayes(cfg, device=dev)
        eng.initialize(corpus, lam_init=dist_lam0(cfg, SVI5["V"]), mesh=mesh)
        zero_launches(mods)
        pmesh.COLLECTIVES.clear()
        objs = [eng.learning()]
        pmesh.assert_replicas_consistent(
            eng.state, mesh, sharded=("lam",),
            full_shape=(SVI5["K"], SVI5["V"]))
        r = {}
        if epochs == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            objs += eng.learning_many(1)
            torch.cuda.synchronize()
            r["epoch_s"] = time.perf_counter() - t0
        r.update(objs=objs, launches=read_launches(mods),
                 collectives=dict(pmesh.COLLECTIVES),
                 expected=shard_collectives(
                     mode, epochs * DIST_SVI5_MINIBATCHES_WHOLE, epochs, 1),
                 block=list(eng.state.lam.shape),
                 peak_mib=torch.cuda.max_memory_allocated(dev) / 2**20)
        lam = eng.gathered_lam()
        r["lam_sum"] = float(lam.double().sum())
        if name == "default":
            t = eng.phase_timings(DIST_TIMING_REPEATS)
            r.update({k: t[k] for k in (
                "svi_minibatch_ms", "allreduce_ms", "allreduce_bytes",
                "allgather_ms", "allgather_bytes")})
        if mesh.rank == 0:
            torch.save(lam.cpu(), DIST_DIR / f"{label.split()[0]}_{name}.pt")
        print(f"{label} {name}: {len(objs)} epoch(s), blocks {r['block']}, "
              f"estimates {[round(e, 1) for e in objs]}, collectives "
              f"{r['collectives']} (expected {r['expected']})"
              + (f", the second epoch {r['epoch_s']:.4f} s" if epochs == 2
                 else "")
              + (f", a minibatch {r['svi_minibatch_ms']:.3f} ms, all-gather "
                 f"of {r['allgather_bytes']} bytes {r['allgather_ms']:.3f} "
                 f"ms, all-reduce of {r['allreduce_bytes']} bytes "
                 f"{r['allreduce_ms']:.3f} ms" if name == "default" else "")
              + f", peak {r['peak_mib']:.1f} MiB")
        out[name] = r
        del eng, lam
        torch.cuda.empty_cache()
    return out


# Gibbs and hybrid under a model axis (``--shard_vocab`` / ``--shard_topics``
# with M > 1): BASELINE config 3 at full width, DIST_SWEEPS sweeps or
# iterations with the slice sampler (Gibbs) or Newton and persistent chains
# (hybrid) every step.  Each is held to its one-process run on the card at
# (1, 2), and to the (2, 1) run at (2, 2): the tables, chains, likelihoods
# and held-out perplexity bit for bit (the hybrid ELBOs within DIST_REL).
SAMPLING_MODES = ("gibbs", "hybrid")


def sampling_cfg(name: str, mode=None, shape=None):
    """A sampling phase's config: ``dist_cfg(name)`` (config 3) with the
    hyperparameters every step and, for hybrid, persistent chains; with
    ``mode`` its flag and the mesh ``shape``."""
    cfg = dataclasses.replace(dist_cfg(name),
                              hyper_parameter_optimize_interval=1,
                              hybrid_persistent_z=name == "hybrid")
    if mode is None:
        return cfg
    return dataclasses.replace(cfg, mesh_shape=tuple(shape), **{
        "shard_vocab" if mode == "vocab" else "shard_topics": True})


def sampling_collectives(name: str, shard: bool, likelihoods) -> list:
    """The collectives each step of a sampling run must make: Gibbs
    all-reduces its block of n_kv and the doc side over the data group,
    one more for each likelihood its slice sampler evaluated that step
    (``likelihoods``), and gathers the blocks once under a shard; hybrid
    all-reduces the sufficient statistics and the packed doc-level terms
    over the data group, and gathers lambda once a step under a shard
    (twice in the first: its Newton step gathers the new lambda, which
    the next step reads)."""
    if name == "gibbs":
        return [{"all_reduce": 2 + n, "all_gather": int(shard)}
                for n in likelihoods]
    return [{"all_reduce": 2, "all_gather": int(shard) * (1 + (i == 0))}
            for i in range(len(likelihoods))]


def chain_digest(arrays) -> str:
    """One sha256 of a list of chains (numpy arrays), in order."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def sampling_run(label, name, cfg, mesh, dev, mods):
    """Gibbs or hybrid (``name``) at config 3 over ``mesh`` (None: one
    process): initialize, DIST_SWEEPS learning() calls (the last
    DIST_SWEEPS - 1 timed; each step's collectives and, for Gibbs, the
    likelihoods its slice sampler evaluated; under a mesh the tables
    checked after each: blocks bitwise across their data group and tiling
    (K, V), the rest across every rank), counts conserved (n_kv, or the
    last step's sampled sufficient statistics), the chains of
    every data coordinate digested, held-out perplexity on config 3's 512
    documents, no kernel launched (the counters zeroed just before
    initialize and read after the perplexity), peak memory above what was
    allocated before; then phase_timings (a sweep or an E-step alone, and
    under a group the all-reduce and the all-gather).  Returns (numbers, the whole table: n_kv or
    lambda)."""
    import torch

    from pylda_tpu_torch.models import make_engine
    from pylda_tpu_torch.models.gibbs import gather_chains
    from pylda_tpu_torch.parallel import mesh as pmesh

    corpus, test = dist_corpus(name)
    gibbs = name == "gibbs"
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    zero_launches(mods)
    eng = make_engine(cfg, device=dev)
    eng.initialize(corpus, mesh=mesh)
    likelihoods = [0]
    if gibbs:
        plain = eng.compute_likelihood

        def counted(*a):
            likelihoods[0] += 1
            return plain(*a)

        eng.compute_likelihood = counted
    sharded = ("lam", "n_kv") if eng._shard is not None else ()
    objs, steps, evals, secs = [], [], [], 0.0
    for i in range(DIST_SWEEPS):
        eta_before = eng.state.eta.clone()
        pmesh.COLLECTIVES.clear()
        likelihoods[0] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        objs.append(eng.learning())
        torch.cuda.synchronize()
        if i:
            secs += time.perf_counter() - t0
        steps.append({k: pmesh.COLLECTIVES[k]
                      for k in ("all_reduce", "all_gather")})
        evals.append(likelihoods[0])
        if mesh is not None:
            tables = {"lam": eng.state.lam, "alpha": eng.state.alpha,
                      "eta": eng.state.eta}
            if gibbs:
                tables["n_kv"] = eng._n_kv
            pmesh.assert_replicas_consistent(
                tables, mesh, sharded=sharded,
                full_shape=(CFG3["K"], CFG3["V"]))
    whole = eng._n_kv_whole if gibbs else eng.gathered_lam()
    st = eng.state
    # Hybrid: the last step's sufficient statistics (lambda less the eta
    # it was made with; Newton has moved eta since).
    counted_tokens = whole if gibbs else whole - eta_before[None, :]
    total = float(counted_tokens.sum(dtype=torch.float64))
    chains = ([*eng._z, *eng._ndk] if gibbs else list(eng._z_hyb))
    digest = chain_digest(gather_chains(chains, mesh))
    t0 = time.perf_counter()
    pp = eng.perplexity(test)
    pp_ms = (time.perf_counter() - t0) * 1e3
    out = {"objs": objs, "ms_per_step": secs / (DIST_SWEEPS - 1) * 1e3,
           "perplexity": pp, "perplexity_ms": pp_ms, "total": total,
           "alpha": float(st.alpha[0]), "eta": float(st.eta[0]),
           "chains": digest, "steps": steps,
           "expected": sampling_collectives(name, eng._shard is not None,
                                            evals),
           "launches": read_launches(mods), "block": list(st.lam.shape),
           "peak_above_base_mib": (torch.cuda.max_memory_allocated(dev)
                                   - base) / 2**20}
    if gibbs:
        out["n_kv_block"] = list(eng._n_kv.shape)
    t = eng.phase_timings(DIST_TIMING_REPEATS)
    out["timed_step_ms"] = t.get("gibbs_sweep_ms", t.get("estep_total_ms"))
    if mesh is not None and mesh.grouped:
        out.update({k: t[k] for k in ("allreduce_ms", "allreduce_bytes",
                                      "allgather_ms", "allgather_bytes")
                    if k in t})
    ok = (total == corpus.num_tokens if gibbs
          else abs(total - corpus.num_tokens) <= 1e-5 * corpus.num_tokens)
    unit = "sweeps" if gibbs else "iterations"
    print(f"{label}: {DIST_SWEEPS} {unit}, the last {DIST_SWEEPS - 1} "
          f"{out['ms_per_step']:.3f} ms each, objectives "
          f"{[round(o, 1) for o in objs]}, blocks {out['block']}, counts "
          f"{total:.1f} of {corpus.num_tokens} tokens "
          f"{'ok' if ok else 'FAIL'}, held-out perplexity {pp:.4f} "
          f"({pp_ms:.1f} ms), collectives a step {steps} (expected "
          f"{out['expected']})"
          + (f", all-gather of {out['allgather_bytes']} bytes "
             f"{out['allgather_ms']:.3f} ms" if "allgather_ms" in out else "")
          + (f", all-reduce of {out['allreduce_bytes']} bytes "
             f"{out['allreduce_ms']:.3f} ms" if "allreduce_ms" in out
             else "")
          + f", timed step {out['timed_step_ms']:.3f} ms (phase_timings: "
          f"{'the sweep' if gibbs else 'the E-step'} alone), peak "
          f"{out['peak_above_base_mib']:.1f} MiB above the "
          f"{base / 2**20:.1f} MiB allocated before")
    if not ok:
        raise AssertionError(f"{label}: counts not conserved")
    return out, whole


def shard_sampling(label, name, mode, mesh, dev, mods) -> dict:
    """A rank's sampling phase over ``mesh`` (``sampling_run``); rank 0
    saves the whole table."""
    import torch

    out, whole = sampling_run(label, name, sampling_cfg(
        name, mode, (mesh.data, mesh.model)), mesh, dev, mods)
    if mesh.rank == 0:
        torch.save(whole.cpu(), DIST_DIR / f"{label.split()[0]}.pt")
    return out


def hold_sampling(label, ranks, phase, ref, ref_table, smi) -> dict:
    """A sampling phase's ranks against its reference run (one process,
    or the (2, 1) run): every rank's objectives, perplexity and chains
    the same bits; the reference's chains, perplexity, alpha and eta bit
    for bit, and its whole table (rank 0's, saved) bit for bit; Gibbs's
    likelihoods bit for bit, hybrid's ELBOs within DIST_REL (bitwise
    printed).  Each rank's collectives a step as it must make them and no
    kernel launched.  Returns the numbers."""
    import torch

    rows = [r[phase] for r in ranks]
    for r, row in enumerate(rows):
        if row["steps"] != row["expected"]:
            raise AssertionError(f"{label}: rank {r} made {row['steps']} "
                                 f"collectives a step, not {row['expected']}")
        check_launched(f"{label} rank {r}", row["launches"], ())
        for k in ("objs", "perplexity", "chains", "alpha", "eta", "total"):
            if row[k] != rows[0][k]:
                raise AssertionError(f"{label}: ranks differ in {k}")
    got = rows[0]
    table = torch.load(DIST_DIR / f"{phase}.pt")
    same = {k: got[k] == ref[k] for k in ("objs", "perplexity", "chains",
                                          "alpha", "eta")}
    same["table"] = bool(torch.equal(table, ref_table))
    elbo = max(abs(a - b) / abs(b) for a, b in zip(got["objs"], ref["objs"]))
    need = ["table", "perplexity", "chains", "alpha", "eta"]
    if "gibbs" in phase:
        need.append("objs")
    ok = all(same[k] for k in need) and elbo <= DIST_REL
    print(f"{label} on {smi}: against its reference: bit for bit {same}; "
          f"objectives rel {elbo:.3e} (tolerance {DIST_REL}); "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the run disagrees with its "
                             f"reference")
    return {"bitwise": same, "elbo_rel": elbo,
            **{k: got[k] for k in ("ms_per_step", "perplexity",
                                   "perplexity_ms", "block",
                                   "peak_above_base_mib", "timed_step_ms",
                                   "allreduce_ms",
                                   "allreduce_bytes", "allgather_ms",
                                   "allgather_bytes") if k in got}}


def sampling_phases(ranks12, ranks22, gloo2, refs, by_path, coll, smi
                    ) -> dict:
    """The sampling phases under a model axis: ``shard_<flag>_<mode>`` at
    (1, 2) held to one process, ``shard_vocab_gibbs_2x2`` held to the
    (2, 1) run ``shard_vocab_gibbs_2x1``; each rank's launches and
    collectives recorded."""
    res = {}
    for mode in SAMPLING_MODES:
        for flag in ("vocab", "topics"):
            phase = f"shard_{flag}_{mode}"
            ref = refs[f"{mode}_one"]
            res[phase] = hold_sampling(phase, ranks12, phase, ref,
                                       ref["table"], smi)
    import torch

    ref = gloo2[0]["shard_vocab_gibbs_2x1"]
    res["shard_vocab_gibbs_2x2"] = hold_sampling(
        "shard_vocab_gibbs_2x2", ranks22, "shard_vocab_gibbs_2x2", ref,
        torch.load(DIST_DIR / "shard_vocab_gibbs_2x1.pt"), smi)
    res["shard_vocab_gibbs_2x1"] = {k: ref[k] for k in (
        "ms_per_step", "perplexity", "peak_above_base_mib", "timed_step_ms",
        "allreduce_ms", "allreduce_bytes") if k in ref}
    for mode in SAMPLING_MODES:
        ref = refs[f"{mode}_one"]
        res[f"{mode}_one_process"] = {k: ref[k] for k in (
            "ms_per_step", "perplexity", "peak_above_base_mib",
            "timed_step_ms")}
    for ranks, phase in ([(ranks12, f"shard_{f}_{m}") for m in SAMPLING_MODES
                          for f in ("vocab", "topics")]
                         + [(ranks22, "shard_vocab_gibbs_2x2"),
                            (gloo2, "shard_vocab_gibbs_2x1")]):
        for r, rank in enumerate(ranks):
            row = rank[phase]
            by_path[f"{phase}_rank{r}"] = row["launches"]
            coll[f"{phase}_rank{r}"] = {"steps": row["steps"],
                                        "expected": row["expected"]}
    return res


def cli_shard_sampling(smi: str) -> dict:
    """The config-1 CLI with ``--inference_mode`` gibbs and hybrid
    (``--hybrid_persistent_z``) in two processes with ``--mesh 1,2`` and
    each flag (``--process_sharded_input``), beside the one-process CLI
    of each mode, all ten at once on the card: every array of each
    model-6 bit for bit the one-process file's.  Returns the wall time
    and each process's launches (none may run)."""
    import socket

    import numpy as np

    from pylda_tpu_torch.corpus.datasets import bundled_corpus_dir

    out = DIST_DIR / "cli_shard_sampling"
    shutil.rmtree(out, ignore_errors=True)

    def train(dest, mode, *extra):
        return subprocess.Popen(
            [sys.executable, "-c", CLI_WITH_LAUNCHES,
             f"--input_directory={bundled_corpus_dir()}",
             f"--output_directory={out / dest}", "--number_of_topics=10",
             "--training_iterations=6", "--snapshot_interval=6",
             f"--inference_mode={mode}",
             *(["--hybrid_persistent_z"] if mode == "hybrid" else []),
             *extra],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)

    procs, t0 = {}, time.perf_counter()
    for mode in SAMPLING_MODES:
        procs[(mode, "one")] = [train(f"{mode}_one", mode)]
        for flag in ("vocab", "topics"):
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            procs[(mode, flag)] = [train(
                f"{mode}_{flag}", mode,
                f"--coordinator_address=127.0.0.1:{port}",
                "--num_processes=2", f"--process_id={r}",
                "--process_sharded_input", "--mesh=1,2", f"--shard_{flag}")
                for r in range(2)]
    outs = {k: wait_all(p) for k, p in procs.items()}
    wall = time.perf_counter() - t0
    res = {"wall_s": wall, "launches": {}}
    for key, ps in procs.items():
        for p, o in zip(ps, outs[key]):
            if p.returncode != 0:
                raise AssertionError(f"cli_shard {key}: a process exited "
                                     f"{p.returncode}:\n{o[-3000:]}")
        res["launches"][f"cli_shard_{key[0]}_{key[1]}"] = [
            json.loads(o.rsplit("LAUNCHES ", 1)[1].splitlines()[0])
            for o in outs[key]]

    def model(dest):
        (path,) = sorted((out / dest).glob("*/*/model-6"))
        with np.load(path) as z:
            return {k: z[k] for k in z.files if k != "meta_json"}

    for mode in SAMPLING_MODES:
        want = model(f"{mode}_one")
        for flag in ("vocab", "topics"):
            got = model(f"{mode}_{flag}")
            differ = sorted(k for k in set(got) | set(want)
                            if k not in got or k not in want
                            or not np.array_equal(got[k], want[k]))
            ok = not differ and any(k.startswith("extra_z") for k in got)
            print(f"cli_shard {mode} {flag}: config-1 CLI, 2 processes on "
                  f"{smi} (--mesh 1,2 --shard_{flag}): model-6 "
                  f"{len(got)} arrays, bit for bit the one-process CLI's "
                  f"{'ok' if ok else f'FAIL: {differ}'}")
            if not ok:
                raise AssertionError(f"cli_shard {mode} {flag}: the model "
                                     f"file differs in {differ}")
    print(f"cli_shard: the sampling CLIs' ten processes in {wall:.2f} s")
    return res


def dist_rank(argv) -> int:
    """One rank of the multi-process phases (``--dist-rank RANK WORLD
    RENDEZVOUS OUT PHASES MESH``): joins the group on the card (NCCL with
    a card a rank, else gloo), makes the mesh MESH ("D,M"), runs each
    phase, writes its numbers to OUT/rank<RANK>.json and, for batch VB,
    its tensors to OUT."""
    import datetime

    import torch

    from pylda_tpu_torch.ops import dense_estep as dense_mod
    from pylda_tpu_torch.ops import ragged as ragged_mod
    from pylda_tpu_torch.ops import sstats as sstats_mod
    from pylda_tpu_torch.parallel import mesh as pmesh

    rank, world, rendezvous, out_dir, phases, shape = argv
    rank, world, out_dir = int(rank), int(world), pathlib.Path(out_dir)
    torch.backends.cuda.matmul.allow_tf32 = False
    backend = pmesh.init_distributed(
        num_processes=world, process_id=rank, device="cuda",
        init_method=f"file://{rendezvous}",
        timeout=datetime.timedelta(seconds=DIST_GROUP_TIMEOUT))
    mesh = pmesh.make_mesh(tuple(int(x) for x in shape.split(",")))
    dev = mesh.device
    mods = {"dense_gamma": dense_mod, "dense_sstats": sstats_mod,
            "ragged_gamma": ragged_mod}
    results = {"backend": backend, "device": str(dev)}
    for name in phases.split(","):
        label = f"{name} rank {rank}/{world} ({backend}, mesh {shape})"
        if name == "vb":
            r = dist_vb(label, mesh, dev, mods)
            torch.save({k: r.pop(k).cpu() for k in ("sstats1", "lam")},
                       out_dir / f"vb_rank{rank}.pt")
        elif name == "svi5":
            r = dist_svi5(label, mesh, dev, mods)
            del r["lam"]
        elif name.startswith("shard_"):
            mode, engine = name.split("_")[1:3]
            if engine in SAMPLING_MODES:
                r = shard_sampling(label, engine, mode, mesh, dev, mods)
            else:
                fn = {"svi5": shard_svi5, "vbwide": shard_vb_wide}.get(
                    engine, shard_vb)
                r = fn(label, mode, mesh, dev, mods)
        else:
            r = dist_sampling(label, name, mesh, dev, mods)
        results[name] = r
    (out_dir / f"rank{rank}.json").write_text(json.dumps(results))
    pmesh.shutdown()
    return 0


def wait_all(procs) -> list:
    """Each process's output, waiting DIST_RANK_LIMIT s at most for each;
    one still running then is killed (so none outlives this script)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DIST_RANK_LIMIT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def run_ranks(out_dir: pathlib.Path, phases: str, shape=(2, 1)) -> list:
    """D * M ranks of this script (``dist_rank``) on the card(s) on a mesh
    ``shape`` (D, M); returns each rank's results.  A rank that fails, or
    outlives DIST_RANK_LIMIT, fails the run."""
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    world = shape[0] * shape[1]
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--dist-rank", str(r),
         str(world), str(out_dir / "rendezvous"), str(out_dir), phases,
         f"{shape[0]},{shape[1]}"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    outs = wait_all(procs)
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            print(f"  [rank {r}] {line}")
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {phases} exited "
                                 f"{p.returncode}")
    return [json.loads((out_dir / f"rank{r}.json").read_text())
            for r in range(world)]


def hold_ranks(label, ranks, name, keys=("objs", "lam_sum")) -> None:
    """Every rank's replicated numbers the same bits."""
    for k in keys:
        for r in ranks[1:]:
            if r[name][k] != ranks[0][name][k]:
                raise AssertionError(f"{label}: ranks differ in {k}: "
                                     f"{ranks[0][name][k]} / {r[name][k]}")


def hold_vb_to_one(label, out_dir, ranks, ref) -> dict:
    """Two ranks' batch VB against the one-process run on the card at
    pinned sweeps: the first iteration's sufficient statistics and every
    ELBO within DIST_REL."""
    import torch

    got = torch.load(out_dir / "vb_rank0.pt")
    ss = norm_rel(got["sstats1"], ref["sstats1"].cpu())
    lam = norm_rel(got["lam"], ref["lam"].cpu())
    elbo = max(abs(a - b) / abs(b)
               for a, b in zip(ranks[0]["vb"]["objs"], ref["objs"]))
    ok = max(ss, elbo) <= DIST_REL
    print(f"{label}: against one process at pinned sweeps: sstats rel "
          f"{ss:.3e}, ELBO rel {elbo:.3e} (tolerance {DIST_REL}), lambda "
          f"after {DIST_ITERS + DIST_TIMED} iterations rel {lam:.3e}; ranks' "
          f"ELBOs and lambda bitwise equal {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: two ranks and one process disagree")
    return {"sstats_rel": ss, "elbo_rel": elbo, "lam_rel": lam}


# The train CLI's main() in a process of its own, then its kernel launches
# (each build's counter) as one "LAUNCHES {json}" line.
CLI_WITH_LAUNCHES = """
import json, sys
from pylda_tpu_torch.cli.train import main
from pylda_tpu_torch.ops import dense_estep, ragged, sstats
rc = main(sys.argv[1:])
mods = {"dense_gamma": dense_estep, "dense_sstats": sstats,
        "ragged_gamma": ragged}
counts = {}
for name, mod in mods.items():
    counts[name] = mod.LAUNCHES
    counts[name + "_bf16"] = mod.BF16_LAUNCHES
    counts[name + "_wide"] = mod.WIDE_LAUNCHES
    counts[name + "_wide_bf16"] = mod.BF16_WIDE_LAUNCHES
    if hasattr(mod, "CLUSTER_LAUNCHES"):
        counts[name + "_cluster"] = mod.CLUSTER_LAUNCHES
        counts[name + "_cluster_bf16"] = mod.BF16_CLUSTER_LAUNCHES
    if hasattr(mod, "BF16_GROUP_LAUNCHES"):
        counts[name + "_group_bf16"] = mod.BF16_GROUP_LAUNCHES
counts["dense_sstats_range"] = sstats.RANGE_LAUNCHES
counts["dense_sstats_range_bf16"] = sstats.BF16_RANGE_LAUNCHES
counts["dense_sstats_range_wide"] = sstats.RANGE_WIDE_LAUNCHES
counts["dense_sstats_range_wide_bf16"] = sstats.BF16_RANGE_WIDE_LAUNCHES
counts["dense_sstats_mma_bf16"] = sstats.BF16_MMA_LAUNCHES
counts["dense_sstats_range_mma_bf16"] = sstats.BF16_RANGE_MMA_LAUNCHES
print("LAUNCHES " + json.dumps(counts), flush=True)
sys.exit(rc)
"""


def cli_dist(smi: str) -> dict:
    """The config-1 CLI across two processes on the card
    (``--coordinator_address``, ``--num_processes``, ``--process_id``,
    ``--process_sharded_input``, ``--mesh 2,1``) beside the one-process
    CLI, all three processes at once: model-6 of the two held to the
    one-process model within CLI_DIST_REL (max-entry relative)."""
    import socket

    import numpy as np
    import torch

    from pylda_tpu_torch.corpus.datasets import bundled_corpus_dir

    out = DIST_DIR / "cli"
    shutil.rmtree(out, ignore_errors=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    def train(dest, *extra):
        return subprocess.Popen(
            [sys.executable, "-c", CLI_WITH_LAUNCHES,
             f"--input_directory={bundled_corpus_dir()}",
             f"--output_directory={out / dest}", "--number_of_topics=10",
             "--training_iterations=6", "--snapshot_interval=6",
             "--estep_stall_patience=0", *extra],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)

    t0 = time.perf_counter()
    flags = [f"--coordinator_address=127.0.0.1:{port}", "--num_processes=2",
             "--process_sharded_input", "--mesh=2,1"]
    procs = [train("dist", *flags, f"--process_id={r}") for r in range(2)]
    procs.append(train("one"))
    outs = wait_all(procs)
    wall = time.perf_counter() - t0
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"cli_dist: a process exited "
                                 f"{p.returncode}:\n{o[-3000:]}")
    models = {d: sorted((out / d).glob("*/*/model-6")) for d in ("dist", "one")}
    if [len(m) for m in models.values()] != [1, 1]:
        raise AssertionError(f"cli_dist: model files {models}")
    lam = {d: torch.as_tensor(np.load(m[0])["lam"]) for d, m in models.items()}
    rel = norm_rel(lam["dist"], lam["one"])
    ok = rel <= CLI_DIST_REL and "backend=gloo" in outs[0]
    print(f"cli_dist: config-1 CLI, 2 processes on {smi} (backend gloo, "
          f"--process_sharded_input --mesh 2,1) and 1 process at once in "
          f"{wall:.2f} s: model-6 lambda rel {rel:.3e} (tolerance "
          f"{CLI_DIST_REL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("cli_dist: the two-process model disagrees")
    launches = [json.loads(o.rsplit("LAUNCHES ", 1)[1].splitlines()[0])
                for o in outs[:2]]
    return {"lam_rel": rel, "wall_s": wall, "launches": launches}


def cli_shard(smi: str) -> dict:
    """The config-1 CLI in two processes with ``--mesh 1,2`` and
    ``--shard_vocab``, and in two more with ``--shard_topics``, all four
    at once (``--process_sharded_input``: a model group reads one block);
    each model-6 (the whole lambda, rank 0's file) held to ``cli_dist``'s
    one-process model within CLI_DIST_REL, then read by the test and infer
    CLIs in this process on the card.  Returns each run's ranks'
    launches."""
    import socket

    import numpy as np
    import torch

    from pylda_tpu_torch.cli.infer import main as infer_main
    from pylda_tpu_torch.cli.test import main as test_main
    from pylda_tpu_torch.corpus.datasets import bundled_corpus_dir

    out = DIST_DIR / "cli_shard"
    shutil.rmtree(out, ignore_errors=True)
    procs, t0 = {}, time.perf_counter()
    for mode in ("vocab", "topics"):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        procs[mode] = [subprocess.Popen(
            [sys.executable, "-c", CLI_WITH_LAUNCHES,
             f"--input_directory={bundled_corpus_dir()}",
             f"--output_directory={out / mode}", "--number_of_topics=10",
             "--training_iterations=6", "--snapshot_interval=6",
             "--estep_stall_patience=0",
             f"--coordinator_address=127.0.0.1:{port}", "--num_processes=2",
             f"--process_id={r}", "--process_sharded_input", "--mesh=1,2",
             f"--shard_{mode}"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(2)]
    outs = dict(zip(procs, (wait_all(p) for p in procs.values())))
    wall = time.perf_counter() - t0
    one = sorted((DIST_DIR / "cli" / "one").glob("*/*/model-6"))
    lam_one = torch.as_tensor(np.load(one[0])["lam"])
    res = {"wall_s": wall}
    docs = out / "docs.txt"
    docs.write_text("government election vote\nrain snow storm\n")
    for mode, ps in procs.items():
        for p, o in zip(ps, outs[mode]):
            if p.returncode != 0:
                raise AssertionError(f"cli_shard {mode}: a process exited "
                                     f"{p.returncode}:\n{o[-3000:]}")
        model = sorted((out / mode).glob("*/*/model-6"))
        lam = torch.as_tensor(np.load(model[0])["lam"])
        rel = norm_rel(lam, lam_one)
        rc_test = test_main([f"--model={model[0]}",
                             f"--input_directory={bundled_corpus_dir()}",
                             f"--output_file={out / mode / 'gamma.out'}",
                             "--point_estimate"])
        rc_infer = infer_main([f"--model={model[0]}", f"--input={docs}",
                               f"--output={out / mode / 'mix.tsv'}"])
        ok = (len(model) == 1 and tuple(lam.shape) == tuple(lam_one.shape)
              and rel <= CLI_DIST_REL and rc_test == 0 and rc_infer == 0)
        print(f"cli_shard {mode}: config-1 CLI, 2 processes on {smi} "
              f"(--mesh 1,2 --shard_{mode}): model-6 lambda {tuple(lam.shape)}"
              f" rel {rel:.3e} to the one-process CLI's (tolerance "
              f"{CLI_DIST_REL}); test CLI rc {rc_test}, infer CLI rc "
              f"{rc_infer} on it {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"cli_shard {mode}: the model disagrees or "
                                 f"a CLI failed on it")
        res[mode] = {"lam_rel": rel, "launches": [
            json.loads(o.rsplit("LAUNCHES ", 1)[1].splitlines()[0])
            for o in outs[mode]]}
    print(f"cli_shard: the four processes in {wall:.2f} s")
    return res


def topic_words(lam):
    """The topic-word matrix of ``topic_word_distribution`` from a lambda
    tensor (float64 on the host)."""
    import numpy as np
    from scipy.special import psi

    lam = lam.double().numpy()
    elog = psi(lam) - psi(lam.sum(axis=1, keepdims=True))
    e = np.exp(elog - elog.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


@contextlib.contextmanager
def row_sums_in_blocks(M: int):
    """One process's expElogbeta with each topic's row sum taken as the
    sum of its M column blocks' sums (``block_bounds``, each block summed
    as a contiguous tensor, the sums added in block order), as a
    ``shard_vocab`` model group of M ranks takes it: the reference whose
    expElogbeta is the sharded run's bit for bit.  Past the first sweeps
    an ulp of a row sum moves the rows that stall at pinned sweeps, so
    the plain one-process run is not that reference (its gap is
    printed)."""
    from pylda_tpu_torch.models import vb as vbmod
    from pylda_tpu_torch.parallel.mesh import block_bounds

    plain = vbmod.exp_dirichlet_expectation_fast

    def blocked(x, row_sum=None):
        if row_sum is None:
            V_ = x.shape[-1]
            row_sum = sum(x[:, lo:hi].contiguous().sum(dim=-1, keepdim=True)
                          for lo, hi in (block_bounds(V_, m, M)
                                         for m in range(M)))
        return plain(x, row_sum)

    vbmod.exp_dirichlet_expectation_fast = blocked
    try:
        yield
    finally:
        vbmod.exp_dirichlet_expectation_fast = plain


def one_process_refs(dev, mods) -> dict:
    """The one-process runs on the card the shard phases are held to
    (beside dist_nccl1's): batch VB at the ragged flagship at pinned
    sweeps with its row sums in two blocks (``row_sums_in_blocks``; 3 + 3
    iterations) and at default settings (SHARD_DEFAULT_ITERS learning()
    calls, in float32 and in bf16), config 5 SVI at pinned sweeps (two epochs) and in bf16 (one),
    each from dist_lam0; objectives, lambda and the first step's
    sufficient statistics on the host; and Gibbs and hybrid at config 3
    (``sampling_run``: the numbers and the whole table)."""
    import torch

    from pylda_tpu_torch.models import (
        StochasticVariationalBayes,
        VariationalBayes,
    )

    refs = {}
    with row_sums_in_blocks(2):
        r = dist_vb("one process, row sums in two blocks", None, dev, mods)
    refs["vb_pinned_blocked"] = {k: (r[k].cpu() if k != "objs" else r[k])
                                 for k in ("objs", "lam", "sstats1")}
    cfg = dataclasses.replace(dist_cfg("vb"), convergence_threshold=1e-5)
    eng = VariationalBayes(cfg, device=dev)
    eng.initialize(dist_corpus("vb")[0], lam_init=dist_lam0(cfg, V))
    refs["vb_default"] = {"objs": [eng.learning()
                                   for _ in range(SHARD_DEFAULT_ITERS)],
                          "lam": eng.state.lam.cpu()}
    eng = VariationalBayes(dataclasses.replace(cfg, compute_dtype=BF16),
                           device=dev)
    eng.initialize(dist_corpus("vb")[0], lam_init=dist_lam0(cfg, V))
    refs["vb_bf16"] = {"objs": [eng.learning()
                                for _ in range(SHARD_DEFAULT_ITERS)],
                       "lam": eng.state.lam.cpu()}
    for name, kw, epochs in (("svi5_pinned", {"convergence_threshold": 0.0},
                              2), ("svi5_bf16", {"compute_dtype": BF16}, 1)):
        cfg = dataclasses.replace(dist_cfg("svi5"), **kw)
        eng = StochasticVariationalBayes(cfg, device=dev)
        eng.initialize(dist_corpus("svi5")[0],
                       lam_init=dist_lam0(cfg, SVI5["V"]))
        objs = [eng.learning()] + eng.learning_many(epochs - 1)
        refs[name] = {"objs": objs, "lam": eng.state.lam.cpu()}
        del eng
        torch.cuda.empty_cache()
    for name in SAMPLING_MODES:
        r, whole = sampling_run(f"one process {name} config 3", name,
                                sampling_cfg(name), None, dev, mods)
        check_launched(f"one process {name} config 3", r["launches"], ())
        refs[f"{name}_one"] = {**r, "table": whole.cpu()}
        del whole
    print(f"one-process references: {json.dumps({k: v['objs'] for k, v in refs.items()})}")
    return refs


def fro_rel(got, want) -> float:
    """||got - want|| / ||want|| (Frobenius, in float64): the measure of
    ``tests/torch_dist.py::norm_rel``."""
    return float((got.double() - want.double()).norm() / want.double().norm())


def hold_shard(label, got: dict, lam, ref: dict, elbo_rel: float,
               sstats1=None, rtol=None, atol=0.0, twd_atol=None, also=None):
    """A shard run (rank 0's objectives, its gathered lambda) against one
    process: each objective within ``elbo_rel``; the first step's
    sufficient statistics within ``sstats1`` (the largest entry's error
    relative to the largest entry; Frobenius printed beside it, and
    lambda after the last step: past a step the float32 ulps of a
    perturbed expElogbeta are amplified by the rows that stall at pinned
    sweeps, ROADMAP Queue 3); every entry of lambda within ``rtol`` |ref|
    + ``atol``; the topic-word matrices within ``twd_atol``.  ``also``:
    another one-process run (the plain one where ``ref`` takes the row
    sums in blocks) whose gaps are printed, and theirs to ``ref``.
    Returns (numbers, ok)."""
    import torch

    elbo = max(abs(a - b) / abs(b) for a, b in zip(got["objs"], ref["objs"]))
    out = {"elbo_rel": elbo, "lam_rel": norm_rel(lam, ref["lam"]),
           "lam_fro_rel": fro_rel(lam, ref["lam"])}
    ok = len(got["objs"]) == len(ref["objs"]) and elbo <= elbo_rel
    text = (f"objectives rel {elbo:.3e} (tolerance {elbo_rel}), lambda after "
            f"the last step rel {out['lam_rel']:.3e} (largest entry), "
            f"{out['lam_fro_rel']:.3e} (Frobenius)")
    if sstats1 is not None:
        got1 = torch.load(DIST_DIR / f"{label.split()[0]}_sstats1.pt")
        out["sstats1_rel"] = norm_rel(got1, ref["sstats1"])
        out["sstats1_fro_rel"] = fro_rel(got1, ref["sstats1"])
        out["sstats1_bitwise"] = bool(torch.equal(got1, ref["sstats1"]))
        ok = ok and out["sstats1_rel"] <= sstats1
        text += (f", the first step's sstats rel {out['sstats1_rel']:.3e} "
                 f"(largest entry; tolerance {sstats1}), "
                 f"{out['sstats1_fro_rel']:.3e} (Frobenius), bitwise "
                 f"{out['sstats1_bitwise']}")
        if also is not None:
            out["plain_sstats1_rel"] = norm_rel(got1, also["sstats1"])
            out["plain_sstats1_fro_rel"] = fro_rel(got1, also["sstats1"])
            out["plain_elbo_rel"] = max(abs(a - b) / abs(b) for a, b in
                                        zip(got["objs"], also["objs"]))
            out["blocks_vs_plain_sstats1_fro_rel"] = fro_rel(
                ref["sstats1"], also["sstats1"])
            text += (f"; against the plain one process (row sums whole) "
                     f"sstats rel {out['plain_sstats1_rel']:.3e} (largest "
                     f"entry), {out['plain_sstats1_fro_rel']:.3e} "
                     f"(Frobenius), objectives {out['plain_elbo_rel']:.3e}, "
                     f"where one process with its row sums in blocks is "
                     f"{out['blocks_vs_plain_sstats1_fro_rel']:.3e} "
                     f"(Frobenius) from it")
    if rtol is not None:
        worst = float(((lam.double() - ref["lam"].double()).abs()
                       - atol).div(ref["lam"].double().abs()).max())
        out["lam_worst_rtol"] = worst
        ok = ok and worst <= rtol
        text += f", lambda worst (|diff| - {atol:g}) / |ref| {worst:.3e} " \
                f"(tolerance rtol {rtol})"
    if twd_atol is not None:
        import numpy as np

        out["twd_max_abs"] = float(np.abs(topic_words(lam)
                                          - topic_words(ref["lam"])).max())
        ok = ok and out["twd_max_abs"] <= twd_atol
        text += f", topic-word max abs {out['twd_max_abs']:.3e} (tolerance " \
                f"{twd_atol})"
    out["lam_bitwise"] = bool(torch.equal(lam, ref["lam"]))
    print(f"{label}: against one process on the card: {text}; lambda bitwise "
          f"equal {out['lam_bitwise']} {'ok' if ok else 'FAIL'}")
    return out, ok


def shard_phases(mods, by_path: dict, coll: dict, refs: dict, gloo2: list
                 ) -> dict:
    """The lambda-sharding phases (module docstring): two ranks at mesh
    (1, 2) over gloo on the card (``shard_vocab_vb``, ``shard_topics_vb``,
    ``shard_vocab_svi5``, ``shard_{vocab,topics}_{gibbs,hybrid}``), four
    at (2, 2) (``shard_vocab_vb_2x2``, ``shard_vocab_gibbs_2x2``), each
    run's launches and collectives checked and recorded, then each held to
    its one-process run (the Gibbs 2x2 phase to ``gloo2``'s (2, 1) run);
    and ``cli_shard``, with the sampling engines too."""
    import torch

    smi = nvidia_smi()
    res, failed = {}, []
    sampling = ",".join(f"shard_{f}_{m}" for m in SAMPLING_MODES
                        for f in ("vocab", "topics"))
    ranks12 = run_ranks(DIST_DIR / "shard",
                        "shard_vocab_vb,shard_topics_vb,shard_vocab_svi5,"
                        + sampling, (1, 2))
    ranks22 = run_ranks(DIST_DIR / "shard_2x2",
                        "shard_vocab_vb_2x2,shard_vocab_gibbs_2x2", (2, 2))
    holds = {
        ("shard_vocab_vb", "pinned"): dict(ref=refs["vb_pinned_blocked"],
                                           also=refs["vb_pinned"],
                                           elbo_rel=DIST_REL,
                                           sstats1=DIST_REL),
        ("shard_topics_vb", "pinned"): dict(ref=refs["vb_pinned"],
                                            elbo_rel=DIST_REL,
                                            sstats1=DIST_REL),
        ("shard_vocab_vb_2x2", "pinned"): dict(
            ref=refs["vb_pinned_blocked"], also=refs["vb_pinned"],
            elbo_rel=DIST_REL, sstats1=DIST_REL),
        ("shard_vocab_vb", "default"): dict(ref=refs["vb_default"],
                                            elbo_rel=SHARD_VB_ELBO_REL,
                                            twd_atol=SHARD_TWD_ATOL),
        ("shard_topics_vb", "default"): dict(ref=refs["vb_default"],
                                             elbo_rel=SHARD_VB_ELBO_REL,
                                             twd_atol=SHARD_TWD_ATOL),
        ("shard_vocab_svi5", "default"): dict(
            ref=refs["svi5_default"], elbo_rel=SHARD_SVI_EST_REL,
            rtol=SHARD_SVI_LAM_RTOL, atol=SHARD_SVI_LAM_ATOL),
        ("shard_vocab_svi5", "pinned"): dict(
            ref=refs["svi5_pinned"], elbo_rel=SHARD_SVI_PINNED_REL,
            rtol=SHARD_SVI_PINNED_RTOL),
        ("shard_vocab_svi5", "bf16"): dict(ref=refs["svi5_bf16"],
                                           elbo_rel=BF16_ELBO_RTOL),
        ("shard_topics_vb", "bf16"): dict(ref=refs["vb_bf16"],
                                          elbo_rel=BF16_ELBO_RTOL),
    }
    for (phase, run), hold in holds.items():
        ranks = ranks22 if phase.endswith("2x2") else ranks12
        label = f"{phase}_{run}"
        if ranks[0]["backend"] != "gloo":
            raise AssertionError(f"{label}: backend {ranks[0]['backend']}")
        rows = [{phase: r[phase][run]} for r in ranks]
        hold_ranks(label, rows, phase)
        topics = "topics" in phase
        suffix = "_bf16" if run == "bf16" else ""
        # Config 5 (K = 1000) takes the sstats cluster kernel.
        svi5 = "svi5" in phase
        needed = tuple(f"{k}{suffix}" for k in (
            "ragged_gamma", "dense_sstats")
            + (("dense_sstats_range",) if topics else ())
            + (("dense_sstats_wide",) if svi5 else ())
            # bf16 at K <= 256: the sstats tensor-core kernel.
            + (("dense_sstats_mma",) if suffix and not svi5 else ())
            + (("dense_sstats_range_mma",) if suffix and topics else ()))
        for r, row in enumerate(rows):
            got = row[phase]
            check_launched(f"{label} rank {r}", got["launches"], needed,
                           absent=() if topics else ("dense_sstats_range",
                                                     "dense_sstats_range_bf16"))
            by_path[f"{label}_rank{r}"] = got["launches"]
            coll[f"{label}_rank{r}"] = {**got["collectives"],
                                       "expected": got["expected"]}
            if any(got["collectives"].get(k, 0) != n
                   for k, n in got["expected"].items()):
                raise AssertionError(f"{label}: rank {r} made "
                                     f"{got['collectives']} collectives, not "
                                     f"{got['expected']}")
        lam = torch.load(DIST_DIR / f"{phase}_{run}.pt")
        ref = hold.pop("ref")
        numbers = {k: v for k, v in rows[0][phase].items()
                   if k not in ("launches", "objs", "collectives",
                                "expected")}
        held, ok = hold_shard(f"{phase} {run} on {smi}", rows[0][phase],
                              lam, ref, **hold)
        numbers.update(held)
        res[label] = numbers
        if not ok:
            failed.append(label)
    # Every hold is printed before a failing one stops the run.
    if failed:
        print(f"shard: {json.dumps(res)}")
        raise AssertionError(f"shard runs disagree with one process: "
                             f"{failed}")
    res.update(sampling_phases(ranks12, ranks22, gloo2, refs, by_path, coll,
                               smi))
    res["cli_shard"] = cli_shard(smi)
    for mode in ("vocab", "topics"):
        needed = ("dense_gamma", "dense_sstats") + (
            ("dense_sstats_range",) if mode == "topics" else ())
        for r, got in enumerate(res["cli_shard"][mode].pop("launches")):
            check_launched(f"cli_shard_{mode} rank {r}", got, needed,
                           absent=() if mode == "topics"
                           else ("dense_sstats_range",))
            by_path[f"cli_shard_{mode}_rank{r}"] = got
    res["cli_shard_sampling"] = cli_shard_sampling(smi)
    for path, per_proc in res["cli_shard_sampling"].pop("launches").items():
        for r, got in enumerate(per_proc):
            check_launched(f"{path} process {r}", got, ())
            by_path[f"{path}_rank{r}"] = got
    print(f"shard: {json.dumps(res)}")
    return res


def dist_phases(mods, dev, by_path: dict) -> dict:
    """The distributed phases (module docstring): dist_nccl1 here, the
    two-rank phases in two processes of this script, cli_dist, and
    dist_nccl2 where a second card is present.  Adds each phase's (and
    each rank's) launches to ``by_path``; returns the numbers and the
    collectives each phase made beside those it must make."""
    import torch

    from pylda_tpu_torch.parallel import mesh as pmesh

    smi = nvidia_smi()
    coll = {}
    res = {}
    refs = {}
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    DIST_DIR.mkdir(parents=True)
    # -- dist_nccl1: NCCL at world size 1, real collectives ------------------
    backend = pmesh.init_distributed(
        num_processes=1, process_id=0, device="cuda",
        init_method=f"file://{DIST_DIR / 'nccl1_rendezvous'}")
    if backend != "nccl":
        raise AssertionError(f"dist_nccl1: backend {backend}, want nccl")
    mesh = pmesh.make_mesh()
    try:
        for name, fn in (("vb", dist_vb), ("svi5", dist_svi5)):
            label = f"dist_nccl1 {name}"
            plain = fn(f"{label} without a group", None, dev, mods)
            grouped = fn(f"{label} (nccl, world 1) on {smi}", mesh, dev, mods)
            same = torch.equal(plain["lam"], grouped["lam"])
            want = 2 * (DIST_ITERS + DIST_TIMED if name == "vb"
                        else 2 * DIST_SVI5_MINIBATCHES)
            coll[f"dist_nccl1_{name}"] = {"all_reduce": grouped["all_reduce"],
                                          "expected": want}
            print(f"{label}: lambda bitwise equal to the run without a group "
                  f"{'ok' if same else 'FAIL'}; all-reduces "
                  f"{grouped['all_reduce']} (expected {want})")
            if not same or grouped["all_reduce"] != want:
                raise AssertionError(f"{label}: a reduce of one rank is not "
                                     f"exact, or the collectives are off")
            needed = ("ragged_gamma", "dense_sstats") + (
                ("dense_sstats_wide",) if name == "svi5" else ())
            check_launched(label, grouped["launches"], needed)
            by_path[f"dist_nccl1_{name}"] = grouped["launches"]
            res[f"dist_nccl1_{name}"] = {
                k: grouped[k] for k in grouped
                if k in ("ms_per_iteration", "epoch_s", "allreduce_ms",
                         "allreduce_bytes", "minibatch_ms", "peak_mib")}
            if name == "vb":
                ref_vb = plain
            refs[f"{name}_pinned" if name == "vb" else "svi5_default"] = {
                "objs": plain["objs"], "lam": plain["lam"].cpu(),
                "sstats1": plain.get("sstats1", plain["lam"]).cpu()}
            del plain, grouped
    finally:
        pmesh.shutdown()
    # -- two ranks sharing the card over gloo ----------------------------------
    out_dir = DIST_DIR / "gloo2"
    ranks = run_ranks(out_dir, "vb,svi5,gibbs,hybrid,shard_vocab_gibbs_2x1")
    want = {"vb": 2 * (DIST_ITERS + DIST_TIMED),
            "svi5": 4 * DIST_SVI5_MINIBATCHES,
            "gibbs": 1 + 2 * DIST_SWEEPS, "hybrid": 2 * DIST_SWEEPS}
    for name in ("vb", "svi5", "gibbs", "hybrid"):
        label = f"dist_gloo2_{name}"
        if ranks[0]["backend"] != "gloo":
            raise AssertionError(f"{label}: backend {ranks[0]['backend']}")
        hold_ranks(label, ranks, name)
        needed = (("ragged_gamma", "dense_sstats")
                  + (("dense_sstats_wide",) if name == "svi5" else ())
                  if name in ("vb", "svi5") else ())
        for r in range(2):
            check_launched(f"{label} rank {r}", ranks[r][name]["launches"],
                           needed)
            by_path[f"{label}_rank{r}"] = ranks[r][name]["launches"]
            coll[f"{label}_rank{r}"] = {
                "all_reduce": ranks[r][name]["all_reduce"],
                "expected": want[name]}
            if ranks[r][name]["all_reduce"] != want[name]:
                raise AssertionError(f"{label}: rank {r} made "
                                     f"{ranks[r][name]['all_reduce']} "
                                     f"all-reduces, not {want[name]}")
        res[label] = {k: v for k, v in ranks[0][name].items()
                      if k not in ("launches", "objs")}
        print(f"{label}: 2 ranks on {smi} (gloo): {res[label]}")
    if ranks[0]["svi5"]["geometry"] != ranks[1]["svi5"]["geometry"]:
        raise AssertionError("dist_gloo2_svi5: the ranks negotiated "
                             "different geometries")
    res["dist_gloo2_vb"].update(hold_vb_to_one("dist_gloo2_vb", out_dir,
                                               ranks, ref_vb))
    # -- the config-1 CLI across two processes ---------------------------------
    res["cli_dist"] = cli_dist(smi)
    for r, got in enumerate(res["cli_dist"].pop("launches")):
        check_launched(f"cli_dist rank {r}", got,
                       ("dense_gamma", "dense_sstats"))
        by_path[f"cli_dist_rank{r}"] = got
    # -- lambda split over the model axis ---------------------------------------
    refs.update(one_process_refs(dev, mods))
    torch.cuda.empty_cache()
    res.update(shard_phases(mods, by_path, coll, refs, ranks))
    del refs
    torch.cuda.empty_cache()
    # -- the topic range above K = 4096 on a main path -------------------------
    res["shard_topics_vb_wide"] = shard_topics_vb_wide(dev, mods, by_path,
                                                       coll)
    # -- NCCL across two cards, where there are two ---------------------------
    if torch.cuda.device_count() >= 2:
        out_dir = DIST_DIR / "nccl2"
        ranks = run_ranks(out_dir, "vb")
        if ranks[0]["backend"] != "nccl":
            raise AssertionError(f"dist_nccl2: backend {ranks[0]['backend']}")
        hold_ranks("dist_nccl2", ranks, "vb")
        for r in range(2):
            check_launched(f"dist_nccl2 rank {r}", ranks[r]["vb"]["launches"],
                           ("ragged_gamma", "dense_sstats"))
            by_path[f"dist_nccl2_vb_rank{r}"] = ranks[r]["vb"]["launches"]
            coll[f"dist_nccl2_vb_rank{r}"] = {
                "all_reduce": ranks[r]["vb"]["all_reduce"],
                "expected": want["vb"]}
        res["dist_nccl2"] = hold_vb_to_one("dist_nccl2", out_dir, ranks,
                                           ref_vb)
    else:
        print(f"dist_nccl2: not run: {torch.cuda.device_count()} card(s); "
              f"NCCL needs a card a rank, so two ranks on one card run over "
              f"gloo (dist_gloo2_*). Not counted as a pass.")
    print(f"collectives_by_path: {json.dumps(coll)}")
    return res


# -- above K = 4096: the kernels' tiled and two-pass range --------------------

# K of each kernel check: 4100 just past the row-resident range, 5000 not a
# multiple of 128 (the gather table's padding), 8192 the configurations'
# K (the largest power of two at which the TPU kernel's own planner still
# fits its VMEM budget at config 5's chunk), 16384 no constant cap.
WIDE_KS = (4100, 5000, 8192, 16384)
WIDE_K, WIDE_DENSE_K = 8192, 5000
# The sstats chunk at K = 8192: config 5's first documents at its padded
# vocabulary ([1216, 100352]); at the other K its first WIDE_CUT_COLUMNS.
WIDE_CHUNK_ROWS, WIDE_CHUNK_COLUMNS, WIDE_CUT_COLUMNS = 1216, 100352, 25088
# The sstats kernel on every count nonzero (many batches a tile): the
# dense E-step's final pass shape, [256 documents, V_DENSE].
WIDE_DENSE_ROWS = 256
# Topic ranges of the range entry at K = 8192: each half and one across it.
WIDE_RANGES = ((0, 4096), (4096, 8192), (1000, 5000))
# shard_topics_vb_wide: learning() calls at pinned sweeps (threshold 0,
# WIDE_SHARD_SWEEPS a row) at mesh (1, 2), held to one process bit for bit.
WIDE_SHARD_ITERS, WIDE_SHARD_SWEEPS = 2, 10
# The paths of the range above K = 4096 (the other paths' launches are
# also summed apart from theirs).
WIDE_PATH_PREFIXES = ("wide_k_", "cli_wide_k", "shard_topics_vb_wide")


def wide_lam(beta, K: int, tokens: float, dev, seed: int):
    """A sharpened lambda [K, V] on the card for K above the planted topics
    of ``beta`` [Kp, V]: topic k is planted topic k mod Kp scaled to the
    corpus's tokens a topic (as the flagships' lambda is), times a factor
    in [0.5, 1.5) drawn from a seeded generator on the card."""
    import torch

    b = torch.as_tensor(beta, dtype=torch.float32, device=dev)
    Kp, V = b.shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    lam = torch.empty((K, V), dtype=torch.float32, device=dev)
    for k0 in range(0, K, Kp):
        k1 = min(K, k0 + Kp)
        lam[k0:k1] = (1.0 / V + b[:k1 - k0] * (tokens / K)) * (
            0.5 + torch.rand((k1 - k0, V), generator=gen, device=dev))
    return lam


def uniform_lam0(K: int, V: int, seed: int):
    """The engines' random lambda init at K above 4096: the mean 1 and
    spread 0.1 of their gamma(100, 0.01) draw, drawn as uniform float32 on
    the host (819M gamma draws at config 5's K = 8192 take the host
    ~40 s)."""
    import numpy as np

    lam = np.random.default_rng(seed).random((K, V), dtype=np.float32)
    lam *= 0.35
    lam += 0.825
    return lam


def wide_kernels(corpus5, beta5, dcorpus, dbeta, dev) -> dict:
    """``wide_k_kernels``: each kernel in both builds against its plain
    version on the card at each K of WIDE_KS, at the main paths' settings
    (config 5's 30 inner sweeps for the ragged gamma, the flagships' 50
    for the dense E-step), with the holds of the K <= 4096 lines:
    - the ragged gamma on a 256-row bucket of config 5's corpus
      (``ragged_checks`` pinned, ``ragged_checks_bf16``);
    - the dense E-step on 256 documents of the dense flagship's
      vocabulary (V = 4096; ``dense_checks`` pinned, ``dense_checks_bf16``)
      with its final pass;
    - the dense sstats on config 5's first [1216, 100352] chunk at
      K = 8192, on its first 25,088 columns at the other K
      (``sstats_check``: two calls bitwise; the cluster kernel's plan), and
      the topic range at K = 8192 over WIDE_RANGES, each range's rows
      bitwise the full launch's (``sstats_range_check``); at K = 8192 its
      direct plan bitwise the default plan (``sstats_direct_plan_check``),
      calls under ``set_sync_debug_mode("error")``
      (``sstats_sync_free_check``) and every count nonzero at
      [256 x 4096] (many batches a tile);
    - at K = 8192 the cluster kernel's direct plan on the ragged bucket
      (``direct_plan_check``).
    Returns the records by kernel line name."""
    import types

    import numpy as np
    import torch

    from pylda_tpu_torch.ops import ragged as ragged_mod
    from pylda_tpu_torch.ops import sstats as sstats_mod
    from pylda_tpu_torch.ops.dirichlet import (
        exp_dirichlet_expectation,
        exp_dirichlet_expectation_fast,
    )
    from pylda_tpu_torch.ops.estep import (
        estep_dense_sstats,
        estep_ragged_gamma,
        ragged_doc_bound,
    )
    from pylda_tpu_torch.utils.config import LDAConfig

    out = {n: [] for n in ("ragged_gamma_wide", "ragged_gamma_wide_bf16",
                           "dense_gamma_wide", "dense_gamma_wide_bf16",
                           "dense_sstats_wide", "dense_sstats_wide_bf16",
                           "dense_sstats_range_wide",
                           "dense_sstats_range_wide_bf16")}
    (b,) = corpus5.to_ragged_buckets(bucket_sizes=(256,), doc_pad_multiple=64,
                                     doc_indices=range(256))
    bucket = types.SimpleNamespace(ids=torch.as_tensor(b.ids, device=dev),
                                   cnts=torch.as_tensor(b.cnts, device=dev))
    V5 = corpus5.num_types
    dense = corpus5.to_dense(doc_indices=range(WIDE_CHUNK_ROWS)).counts
    counts = torch.zeros((WIDE_CHUNK_ROWS, WIDE_CHUNK_COLUMNS),
                         dtype=torch.bfloat16, device=dev)
    counts[:, :V5] = torch.as_tensor(dense, device=dev)
    del dense
    gen = torch.Generator(device=dev).manual_seed(11)
    rng = np.random.default_rng(12)
    print(f"wide_k_kernels: config 5 bucket {tuple(bucket.ids.shape)} "
          f"({int((bucket.cnts != 0).sum())} live slots), sstats chunk "
          f"{tuple(counts.shape)} ({int((counts != 0).sum())} nonzeros)")
    for K in WIDE_KS:
        cfg5 = LDAConfig(number_of_topics=K, inference_mode="svi",
                         batch_size=SVI5["BATCH"], seed=0,
                         inner_iterations=SVI5["INNER"])
        kw = dict(inner_iterations=cfg5.inner_iterations,
                  convergence_threshold=cfg5.convergence_threshold,
                  eps=cfg5.eps, stall_patience=cfg5.estep_stall_patience)
        alpha = torch.full((K,), cfg5.resolved_alpha(), device=dev)
        eeb = exp_dirichlet_expectation_fast(
            wide_lam(beta5, K, corpus5.num_tokens, dev, seed=K))
        label = f"config 5 bucket K={K}"
        rg, _ = ragged_checks(label, [bucket], eeb,
                              ragged_mod.gather_table(eeb), alpha, kw,
                              5e-4 + K * cfg5.convergence_threshold, dev,
                              ragged_mod, estep_ragged_gamma,
                              ragged_doc_bound, pinned=True)
        rg16, _ = ragged_checks_bf16(label, [bucket], eeb, alpha, kw, dev,
                                     ragged_mod, estep_ragged_gamma,
                                     ragged_doc_bound, rg)
        out["ragged_gamma_wide"].append({**rg, "K": K})
        out["ragged_gamma_wide_bf16"].append({**rg16, "K": K})
        if K == WIDE_K:
            direct_plan_check(label, bucket, eeb, alpha, kw)
        # The sstats chunk: expEtheta of peaked random topic mixtures.
        cols = WIDE_CHUNK_COLUMNS if K == WIDE_K else WIDE_CUT_COLUMNS
        c = counts[:, :cols].contiguous()
        e = eeb[:, :min(cols, V5)].contiguous()
        w = (-torch.log(torch.rand((WIDE_CHUNK_ROWS, K), generator=gen,
                                   device=dev))) ** 4
        et = exp_dirichlet_expectation(
            alpha + 150.0 * w / w.sum(dim=1, keepdim=True))
        del w, eeb
        for cd in ("float32", BF16):
            name = f"dense_sstats_wide{'' if cd == 'float32' else '_bf16'}"
            out[name].append(sstats_check(
                f"config 5 chunk K={K}", c, et, e, cfg5.eps, sstats_mod,
                estep_dense_sstats, compute_dtype=cd))
            if K == WIDE_K:
                out[name.replace("sstats", "sstats_range")] += \
                    sstats_range_check(f"config 5 chunk K={K}", c, et, e,
                                       cfg5.eps, sstats_mod,
                                       estep_dense_sstats, compute_dtype=cd,
                                       ranges=WIDE_RANGES)
        if K == WIDE_K:
            cut = c[:, :WIDE_CUT_COLUMNS].contiguous()
            sstats_direct_plan_check(
                f"config 5 chunk K={K} [{WIDE_CHUNK_ROWS}x{WIDE_CUT_COLUMNS}]",
                cut, et, e[:, :WIDE_CUT_COLUMNS].contiguous(), cfg5.eps)
            sstats_sync_free_check(f"config 5 chunk K={K}", c, et, e,
                                   cfg5.eps)
            # Every count nonzero: 8,192 a tile, many batches a tile.
            dc = torch.randint(1, 5, (WIDE_DENSE_ROWS, V_DENSE),
                               generator=gen, device=dev).to(torch.bfloat16)
            out["dense_sstats_wide"].append(sstats_check(
                f"dense counts K={K}", dc, et[:WIDE_DENSE_ROWS].contiguous(),
                e[:, :V_DENSE].contiguous(), cfg5.eps, sstats_mod,
                estep_dense_sstats))
            del cut, dc
        del c, e, et
        # The dense E-step on the dense flagship's vocabulary.
        cfgd = LDAConfig(number_of_topics=K, inference_mode="vb",
                         inner_iterations=50, convergence_threshold=1e-5,
                         seed=0)
        bw = dbeta[np.arange(K) % dbeta.shape[0]] * (
            0.5 + rng.random((K, dbeta.shape[1]), dtype=np.float32))
        probe = dense_probe(dcorpus, bw / bw.sum(axis=1, keepdims=True),
                            cfgd, dev)
        dg, fin = dense_checks(f"dense V=4096 K={K}", dcorpus, None, cfgd,
                               dev, pinned=True, probe=probe)
        dg16, fin16 = dense_checks_bf16(f"dense V=4096 K={K}", dcorpus, None,
                                        cfgd, dev, dg, probe=probe)
        out["dense_gamma_wide"].append(dg)
        out["dense_gamma_wide_bf16"].append(dg16)
        out["dense_sstats_wide"].append(fin)
        out["dense_sstats_wide_bf16"].append(fin16)
        del probe
        torch.cuda.empty_cache()
    return out


def sstats_direct_plan_check(label: str, counts, et, eeb, eps) -> None:
    """The sstats cluster kernel's direct plan (the plan past K = 16384:
    expElogbeta and expEtheta read from device memory, raw summed in the
    output) at the default plan's cluster and slice, in both builds, the
    full call and a topic range: sstats and score must be bitwise the
    default plan's.  Launches through ``sstats.launch``, not the wrapper,
    so no count moves."""
    import torch

    from pylda_tpu_torch.ops import sstats as sstats_mod

    D, Vc = counts.shape
    K = eeb.shape[0]
    pl = sstats_mod.plan(D, Vc, K, torch.cuda.get_device_properties(
        counts.device).multi_processor_count,
        count_bytes=counts.element_size())
    direct = dataclasses.replace(pl, direct=True)
    for cd in ("float32", BF16):
        lib = sstats_mod._lib(cd)
        same = True
        for rng in (None, WIDE_RANGES[2]):
            a = sstats_mod.launch(lib, counts, et, eeb, eps, rng, plan_=pl)
            b = sstats_mod.launch(lib, counts, et, eeb, eps, rng,
                                  plan_=direct)
            torch.cuda.synchronize()
            same = same and bool(torch.equal(a[0], b[0])
                                 and torch.equal(a[1], b[1]))
        ms = cuda_ms(lambda: sstats_mod.launch(lib, counts, et, eeb, eps,
                                               plan_=direct), 3)
        ms_default = cuda_ms(lambda: sstats_mod.launch(lib, counts, et, eeb,
                                                       eps, plan_=pl), 3)
        print(f"kernel dense_sstats_wide{'' if cd == 'float32' else '_bf16'} "
              f"direct plan {label}: cluster {pl.cluster}, slice {pl.slice}, "
              f"batches of {direct.batch}, kernel_ms {ms:.4f} (default plan "
              f"{ms_default:.4f}), sstats and score (full, topics "
              f"{WIDE_RANGES[2][0]}..{WIDE_RANGES[2][1] - 1}) bitwise the "
              f"default plan's {same} {'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"sstats direct plan {label} {cd} differs "
                                 "from the default plan")


def sstats_sync_free_check(label: str, counts, et, eeb, eps) -> None:
    """One call of the sstats cluster kernel in each build, and one over
    the first half of the topics, under
    ``torch.cuda.set_sync_debug_mode("error")``: a call that synchronised
    with the host (a read back) would raise.  The results are held
    bitwise to a call made outside the mode."""
    import torch

    from pylda_tpu_torch.ops import sstats as sstats_mod

    half = (0, eeb.shape[0] // 2)
    for cd in ("float32", BF16):
        mode = dict(eps=eps, compute_dtype=cd)
        ref = sstats_mod.dense_sstats(counts, et, eeb, **mode)
        ref_r = sstats_mod.dense_sstats(counts, et, eeb, topic_range=half,
                                        **mode)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = sstats_mod.dense_sstats(counts, et, eeb, **mode)
            got_r = sstats_mod.dense_sstats(counts, et, eeb,
                                            topic_range=half, **mode)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(got + got_r,
                                                       ref + ref_r))
        print(f"kernel dense_sstats_wide{'' if cd == 'float32' else '_bf16'} "
              f"{label}: two calls (full, topics 0..{half[1] - 1}) under "
              f"set_sync_debug_mode('error') completed with no host sync, "
              f"bitwise the calls outside it {same} "
              f"{'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"sstats sync-free call {label} {cd} "
                                 "differs")


def direct_plan_check(label: str, bucket, eeb, alpha, kw: dict) -> None:
    """The cluster kernel's direct plan (the plan past K = 65,536: each
    CTA's slice state in device memory, B read from the table, no entry
    resident) at the default plan's cluster and slice, in both builds: at
    K = 8192 the default plan's slice has one group sum too, so gamma and
    the sweeps must be bitwise the default launch's.  Launches through
    ``row_fixed_point.launch``, not the wrappers, so no count moves."""
    import torch

    from pylda_tpu_torch.ops import row_fixed_point as rfp

    ids, cnts = bucket.ids, bucket.cnts
    K = eeb.shape[0]
    g0 = torch.ones((ids.shape[0], K), device=ids.device)
    args = (kw["inner_iterations"], kw["convergence_threshold"], kw["eps"],
            kw["stall_patience"])
    for cd in ("float32", BF16):
        table = rfp.gather_table(eeb, cd)
        plan = rfp.cluster_plan(K, ids.shape[1], cd, kw["inner_iterations"])
        direct = dataclasses.replace(plan, resident=0, direct=True,
                                     window=rfp.DIRECT_WINDOW)

        def call(pl):
            return rfp.launch(rfp.entry("ragged_gamma", cd), ids, cnts,
                              ids.shape[1], table, alpha, g0, *args, plan=pl)

        (g1, s1), (g2, s2) = call(plan), call(direct)
        same = bool(torch.equal(g1, g2) and torch.equal(s1, s2))
        ms = cuda_ms(lambda: call(direct), 3)
        ms_default = cuda_ms(lambda: call(plan), 3)
        print(f"kernel ragged_gamma_wide{'' if cd == 'float32' else '_bf16'} "
              f"direct plan {label}: cluster {plan.cluster}, slice "
              f"{plan.slice}, windows of {rfp.DIRECT_WINDOW}, sweeps "
              f"{int(s2)}, kernel_ms {ms:.4f} (default plan {ms_default:.4f}),"
              f" gamma and sweeps bitwise the default plan's {same} "
              f"{'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"direct plan {label} {cd} differs from the "
                                 "default plan")
        del table


def wide_engines(corpus, test, dcorpus, dtest, corpus5, test5, dev, mods,
                 by_path: dict, roofline: dict) -> dict:
    """``wide_k_vb``, ``wide_k_dense`` and ``wide_k_svi5`` (module
    docstring): batch VB at the ragged flagship at K = 8192 (2 warm and 5
    timed iterations, phase_timings and the roofline), at the dense
    flagship at K = 5000 (the same), and SVI on config 5's corpus at
    K = 8192 (one warm and two timed epochs, one profiled; the gate:
    held-out point-estimate perplexity falls), each in float32 and bf16,
    the kernels' wide launches required.  Adds each path's launches to
    ``by_path`` and the roofline rows to ``roofline``; returns the
    numbers."""
    import torch

    from pylda_tpu_torch.utils.config import LDAConfig

    res = {}
    for path, data, K, cfg in (
            ("wide_k_vb", (corpus, test), WIDE_K,
             LDAConfig(number_of_topics=WIDE_K, inference_mode="vb",
                       inner_iterations=50, convergence_threshold=1e-5,
                       seed=0)),
            ("wide_k_dense", (dcorpus, dtest), WIDE_DENSE_K,
             LDAConfig(number_of_topics=WIDE_DENSE_K, inference_mode="vb",
                       inner_iterations=50, convergence_threshold=1e-5,
                       seed=0))):
        gamma = "ragged_gamma" if path == "wide_k_vb" else "dense_gamma"
        lam0 = uniform_lam0(K, data[0].num_types, 0)
        for cd in ("float32", BF16):
            s = "" if cd == "float32" else "_bf16"
            label = f"engine {path} K={K} {cd}"
            r = run_engine(label, dataclasses.replace(cfg, compute_dtype=cd), *data,
                           dev, mods, (f"{gamma}{s}", f"dense_sstats{s}",
                                       f"{gamma}_wide{s}",
                                       f"dense_sstats_wide{s}"),
                           n=5, warm=2, lam_init=lam0)
            rl = roofline_phase(label, r.pop("engine"), mods,
                                iteration_ms=r["iteration_ms"])
            roofline[f"{path}{s}"] = rl["rows"]
            by_path[f"{path}{s}"] = r.pop("launches")
            by_path[f"roofline_{path}{s}"] = rl["launches"]
            res[f"{path}{s}"] = r
            torch.cuda.empty_cache()
        bf, f32 = res[f"{path}_bf16"], res[path]
        print(f"engine {path}: bf16 against float32 at K={K}: ELBO rel "
              f"{abs(bf['elbo'] - f32['elbo']) / abs(f32['elbo']):.3e}, "
              f"held-out perplexity rel "
              f"{abs(bf['perplexity'] - f32['perplexity']) / f32['perplexity']:.3e}"
              f" (printed, not held to the K <= 4096 bars {BF16_ELBO_RTOL} "
              f"and {BF16_PPL_RTOL}: seven iterations leave K = {K} topics "
              f"far from trained, held-out perplexity above the "
              f"vocabulary's size, and the bf16 rows limit-cycle to the "
              f"sweep cap, so the two runs take different sweeps)")
    cfg = LDAConfig(number_of_topics=WIDE_K, inference_mode="svi",
                    batch_size=SVI5["BATCH"], tau0=64.0, kappa=0.7, seed=0,
                    inner_iterations=SVI5["INNER"])
    lam0 = uniform_lam0(WIDE_K, corpus5.num_types, 0)
    for cd in ("float32", BF16):
        s = "" if cd == "float32" else "_bf16"
        label = f"engine wide_k_svi5 K={WIDE_K} {cd}"
        r = run_svi(label, dataclasses.replace(cfg, compute_dtype=cd), corpus5, test5,
                    dev, mods, 2, lam_init=lam0,
                    needed=(f"ragged_gamma_wide{s}", f"dense_sstats_wide{s}"))
        del r["engine"]
        by_path[f"wide_k_svi5{s}"] = r.pop("launches")
        res[f"wide_k_svi5{s}"] = r
        print(f"{label}: {r['s_per_epoch']:.4f} s an epoch, "
              f"{r['docs_per_s']:.1f} docs/s, idle share "
              f"{r['idle_share']:.3f}, peak {r['peak_mib'] / 1024:.2f} GiB, "
              f"held-out point-estimate perplexity {r['point_perplexity']}")
        torch.cuda.empty_cache()
    del lam0
    return res


def wide_shard_cfg(mode: str = None, shape=None):
    """shard_topics_vb_wide's config: the ragged flagship at K = 8192,
    WIDE_SHARD_SWEEPS pinned sweeps, with ``--shard_topics`` on the mesh
    ``shape`` (none for the one-process reference)."""
    cfg = dataclasses.replace(dist_cfg("vb"), number_of_topics=WIDE_K,
                              inner_iterations=WIDE_SHARD_SWEEPS)
    if mode is None:
        return cfg
    return dataclasses.replace(cfg, mesh_shape=tuple(shape),
                               **{f"shard_{mode}": True})


def shard_vb_wide(label, mode, mesh, dev, mods) -> dict:
    """A rank of ``shard_topics_vb_wide``: WIDE_SHARD_ITERS learning()
    calls, each lambda block checked across its data group and the
    blocks' tiling after each; launches and collectives zeroed just before
    and read just after; rank 0 saves the gathered lambda."""
    import torch

    from pylda_tpu_torch.models import VariationalBayes
    from pylda_tpu_torch.parallel import mesh as pmesh

    corpus, _ = dist_corpus("vb")
    cfg = wide_shard_cfg(mode, (mesh.data, mesh.model))
    eng = VariationalBayes(cfg, device=dev)
    eng.initialize(corpus, lam_init=uniform_lam0(WIDE_K, V, 7), mesh=mesh)
    zero_launches(mods)
    pmesh.COLLECTIVES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    objs = []
    for _ in range(WIDE_SHARD_ITERS):
        objs.append(eng.learning())
        pmesh.assert_replicas_consistent(eng.state, mesh, sharded=("lam",),
                                         full_shape=(WIDE_K, V))
    torch.cuda.synchronize()
    r = {"objs": objs, "launches": read_launches(mods),
         "collectives": dict(pmesh.COLLECTIVES),
         "expected": shard_collectives(mode, WIDE_SHARD_ITERS,
                                       WIDE_SHARD_ITERS, WIDE_SHARD_ITERS),
         "block": list(eng.state.lam.shape),
         "ms_per_iteration": (time.perf_counter() - t0) / WIDE_SHARD_ITERS
         * 1e3}
    lam = eng.gathered_lam()
    if mesh.rank == 0:
        torch.save(lam.cpu(), DIST_DIR / f"shard_{mode}_vbwide.pt")
    print(f"{label}: {WIDE_SHARD_ITERS} iterations, block {r['block']}, "
          f"ELBOs {objs}, collectives {r['collectives']} (expected "
          f"{r['expected']}), {r['ms_per_iteration']:.1f} ms an iteration")
    return r


def shard_topics_vb_wide(dev, mods, by_path: dict, coll: dict) -> dict:
    """``shard_topics_vb_wide``: the ragged flagship at K = 8192 at mesh
    (1, 2) with ``--shard_topics`` over gloo (each rank's final pass the
    sstats kernel's topic range above 4096) against the same run in one
    process on the card: lambda bit for bit, the ELBOs within DIST_REL
    (their bits printed), every rank's launches and collectives checked."""
    import torch

    from pylda_tpu_torch.models import VariationalBayes

    DIST_DIR.mkdir(parents=True, exist_ok=True)
    eng = VariationalBayes(wide_shard_cfg(), device=dev)
    eng.initialize(dist_corpus("vb")[0], lam_init=uniform_lam0(WIDE_K, V, 7))
    ref_objs = [eng.learning() for _ in range(WIDE_SHARD_ITERS)]
    ref_lam = eng.state.lam.cpu()
    del eng
    torch.cuda.empty_cache()
    ranks = run_ranks(DIST_DIR / "shard_wide", "shard_topics_vbwide", (1, 2))
    rows = [{"shard_topics_vbwide": r["shard_topics_vbwide"]} for r in ranks]
    hold_ranks("shard_topics_vb_wide", rows, "shard_topics_vbwide",
               keys=("objs",))
    needed = tuple(f"{k}{w}" for k in ("ragged_gamma", "dense_sstats",
                                       "dense_sstats_range")
                   for w in ("", "_wide"))
    for r, row in enumerate(rows):
        got = row["shard_topics_vbwide"]
        if ranks[r]["backend"] != "gloo":
            raise AssertionError(f"shard_topics_vb_wide: backend "
                                 f"{ranks[r]['backend']}")
        check_launched(f"shard_topics_vb_wide rank {r}", got["launches"],
                       needed)
        by_path[f"shard_topics_vb_wide_rank{r}"] = got["launches"]
        coll[f"shard_topics_vb_wide_rank{r}"] = {**got["collectives"],
                                                 "expected": got["expected"]}
        if any(got["collectives"].get(k, 0) != n
               for k, n in got["expected"].items()):
            raise AssertionError(f"shard_topics_vb_wide rank {r} made "
                                 f"{got['collectives']} collectives, not "
                                 f"{got['expected']}")
    got = rows[0]["shard_topics_vbwide"]
    lam = torch.load(DIST_DIR / "shard_topics_vbwide.pt")
    bitwise = bool(torch.equal(lam, ref_lam))
    elbo = max(abs(a - b) / abs(b) for a, b in zip(got["objs"], ref_objs))
    ok = bitwise and elbo <= DIST_REL
    print(f"shard_topics_vb_wide on {nvidia_smi()}: K={WIDE_K} at mesh (1, 2), "
          f"{WIDE_SHARD_ITERS} iterations of {WIDE_SHARD_SWEEPS} pinned "
          f"sweeps: gathered lambda bitwise equal to one process {bitwise}, "
          f"ELBOs rel {elbo:.3e} (tolerance {DIST_REL}; bitwise "
          f"{got['objs'] == ref_objs}), {got['ms_per_iteration']:.1f} ms an "
          f"iteration a rank {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("shard_topics_vb_wide: not the one-process run "
                             "bit for bit")
    return {"lam_bitwise": bitwise, "elbo_rel": elbo,
            "elbo_bitwise": got["objs"] == ref_objs,
            "ms_per_iteration": got["ms_per_iteration"]}


def wide_card_vs_cpu(engine, cfg, corpus, lam0) -> tuple:
    """Above K = 4096: one step of ``engine`` from ``lam0`` at pinned
    sweeps on the card, on the CPU and on the CPU in float64, lambda held
    as WIDE_F64_FACTOR says: (ok, text)."""
    lams, elbos = {}, {}
    for where, c in (("cuda", cfg), ("cpu", cfg),
                     ("f64", dataclasses.replace(cfg, dtype="float64"))):
        e = engine(c, device="cpu" if where == "f64" else where)
        e.initialize(corpus, lam_init=lam0)
        elbos[where] = e.learning()
        lams[where] = e.state.lam.double().cpu()
        del e

    def rel(a, b):
        return float((lams[a] - lams[b]).abs().max() / lams[b].abs().max())

    card64, cpu64 = rel("cuda", "f64"), rel("cpu", "f64")
    bar = max(WIDE_LAM_REL, WIDE_F64_FACTOR * cpu64)
    text = (f"lambda after one step at {PINNED_SWEEPS_WIDE} pinned sweeps, "
            f"max-entry rel: card vs CPU {rel('cuda', 'cpu'):.2e}; against "
            f"the CPU run in float64: card {card64:.2e}, CPU {cpu64:.2e} "
            f"(tolerance {bar:.2e}); ELBO card {elbos['cuda']:.2f} CPU "
            f"{elbos['cpu']:.2f}, rel "
            f"{abs(elbos['cuda'] - elbos['cpu']) / abs(elbos['cpu']):.2e} "
            f"(printed)")
    return card64 <= bar, text


def card_vs_cpu_checks(ks=(16, 300, None)) -> list:
    """The card-vs-CPU cross-check at a small size on each route (ragged,
    scatter, dense), each K of ``ks`` (None: WIDE_DENSE_K) and mode, batch
    VB and SVI from one lambda: at K <= 4096 the ELBOs within ELBO_RTOL,
    above it ``wide_card_vs_cpu``.  Returns the cases that disagree."""
    import numpy as np

    from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
    from pylda_tpu_torch.models import (StochasticVariationalBayes,
                                        VariationalBayes)
    from pylda_tpu_torch.utils.config import LDAConfig

    disagree = []
    for (route, v_small), k_small, cd in itertools.product(
            (("ragged", 3000), ("scatter", 3000), ("dense", 1000)),
            [k or WIDE_DENSE_K for k in ks], ("float32", BF16)):
        wide = k_small > 4096
        # Above K = 4096 on a cut corpus: 64 documents.
        small, _, _ = synthetic_corpus(num_docs=64 if wide else 256,
                                       num_topics=k_small,
                                       num_types=v_small, mean_doc_length=60.0,
                                       seed=5)
        scfg = LDAConfig(number_of_topics=k_small, dense_vocab_threshold=2048,
                         doc_pad_multiple=16, compute_dtype=cd,
                         hyper_parameter_optimize_interval=2, seed=0,
                         sstats_mode="scatter" if route == "scatter"
                         else "auto")
        if wide:
            scfg = dataclasses.replace(scfg, inner_iterations=PINNED_SWEEPS_WIDE,
                                       convergence_threshold=0.0)
        lam0 = np.random.default_rng(7).gamma(100.0, 0.01, (k_small, v_small))
        for engine, n in ((VariationalBayes, 3), (StochasticVariationalBayes, 2)):
            ecfg = dataclasses.replace(
                scfg, inference_mode="svi", batch_size=64, tau0=16.0,
            ) if engine is StochasticVariationalBayes else scfg
            label = f"cross-check {engine.__name__} {route} K={k_small} {cd}"
            if wide:
                ok, text = wide_card_vs_cpu(engine, ecfg, small, lam0)
                print(f"{label}: {text} {'ok' if ok else 'FAIL'}")
                if not ok:
                    disagree.append(label)
                continue
            runs = {}
            for where in ("cuda", "cpu"):
                e = engine(ecfg, device=where)
                e.initialize(small, lam_init=lam0)
                runs[where] = [e.learning() for _ in range(n)] + \
                    e.learning_many(n)
            rel = max(abs(a - b) / abs(b)
                      for a, b in zip(runs["cuda"], runs["cpu"]))
            ok = rel <= ELBO_RTOL
            print(f"{label}: bounds card {[round(x, 2) for x in runs['cuda']]}"
                  f" cpu {[round(x, 2) for x in runs['cpu']]}, max rel diff "
                  f"{rel:.2e} (tolerance {ELBO_RTOL}) {'ok' if ok else 'FAIL'}")
            if not ok:
                disagree.append(label)
    return disagree


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    import numpy as np

    from pylda_tpu_torch.corpus.synthetic import synthetic_corpus
    from pylda_tpu_torch.models import (
        StochasticVariationalBayes,
        VariationalBayes,
    )
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
        estep_dense_sstats,
        estep_ragged_gamma,
        ragged_doc_bound,
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

    rg, rows_plain = ragged_checks("ragged flagship", probe._batches, eeb,
                                   eeb_t, st.alpha, kw, gamma_atol, dev,
                                   ragged_mod, estep_ragged_gamma,
                                   ragged_doc_bound)

    plan = probe._sstats_plan
    gamma_docs = _assemble_gamma_device(
        torch.cat(rows_plain), torch.cat([b.row_index for b in probe._batches]),
        st.alpha, plan.num_docs,
    )
    et_docs = exp_dirichlet_expectation(gamma_docs)
    counts, cidx = plan.chunks[0]
    et_c = et_docs[cidx]
    ss_shapes = [sstats_check("ragged flagship chunk", counts, et_c, eeb,
                              cfg.eps, sstats_mod, estep_dense_sstats)]
    # The topic-range launch (lambda split over topics), each half.
    range_lines = {"float32": sstats_range_check(
        "ragged flagship chunk", counts, et_c, eeb, cfg.eps, sstats_mod,
        estep_dense_sstats), BF16: []}
    del eeb_t, rows_plain, gamma_docs, et_docs, et_c
    # ... and the bf16 builds on the same inputs.
    rg16, rows_plain = ragged_checks_bf16(
        "ragged flagship", probe._batches, eeb, st.alpha, kw, dev, ragged_mod,
        estep_ragged_gamma, ragged_doc_bound, rg)
    gamma_docs = _assemble_gamma_device(
        torch.cat(rows_plain), torch.cat([b.row_index for b in probe._batches]),
        st.alpha, plan.num_docs,
    )
    ss16_shapes = [sstats_check(
        "ragged flagship chunk", counts,
        exp_dirichlet_expectation(gamma_docs)[cidx], eeb, cfg.eps, sstats_mod,
        estep_dense_sstats, compute_dtype=BF16)]
    range_lines[BF16] += sstats_range_check(
        "ragged flagship chunk", counts,
        exp_dirichlet_expectation(gamma_docs)[cidx], eeb, cfg.eps, sstats_mod,
        estep_dense_sstats, compute_dtype=BF16)
    # The scatter E-step on the card against the CPU at the largest bucket.
    scatter = {"card_vs_cpu": scatter_card_vs_cpu(
        "ragged flagship largest bucket",
        max(probe._batches, key=lambda b: b.ids.shape[0]), eeb, st.alpha)}
    del probe, st, eeb, rows_plain, gamma_docs

    # -- kernels at the dense flagship's shapes -------------------------------
    dcorpus, dbeta, _ = synthetic_corpus(
        num_docs=D, num_topics=K, num_types=V_DENSE, mean_doc_length=MEAN_LEN,
        seed=0,
    )
    dg, fin = dense_checks("dense flagship", dcorpus, dbeta, cfg, dev)
    ss_shapes.append(fin)
    dg16, fin16 = dense_checks_bf16("dense flagship", dcorpus, dbeta, cfg, dev,
                                    dg)
    # Both flagships' bf16 kernel lines are the warp-group kernel's.
    if set(rg16["routes"]) != {"groups"} or dg16["route"] != "groups":
        raise AssertionError(f"bf16 flagship lines off the warp-group "
                             f"kernel: {rg16['routes']}, {dg16['route']}")
    ss16_shapes.append(fin16)
    # ... and at K=1000 on its vocabulary: the core's wide kernels and the
    # sstats cluster kernel.
    wcorpus, wbeta, _ = synthetic_corpus(
        num_docs=D, num_topics=DENSE_WIDE_K, num_types=V_DENSE,
        mean_doc_length=MEAN_LEN, seed=0,
    )
    # Its final pass takes the sstats cluster kernel (2 CTAs of 512 topics):
    # its launches, in each build, as the paths "dense_k1000" and
    # "dense_k1000_bf16" (the float32 check, then the final pass's inputs
    # in the bf16 build).
    final = {}
    zero_launches(mods)
    dg_wide, fin_wide = dense_checks(
        f"dense K={DENSE_WIDE_K}", wcorpus, wbeta,
        dataclasses.replace(cfg, number_of_topics=DENSE_WIDE_K), dev,
        pinned=True, final_inputs=final)
    dense_k1000 = read_launches(mods)
    check_launched(f"dense K={DENSE_WIDE_K}", dense_k1000,
                   ("dense_gamma", "dense_sstats", "dense_sstats_wide"))
    ss_shapes.append(fin_wide)
    zero_launches(mods)
    fin_wide16 = sstats_check(
        f"dense K={DENSE_WIDE_K} final pass", final["counts"], final["et"],
        final["eeb"], cfg.eps, sstats_mod, estep_dense_sstats,
        compute_dtype=BF16)
    ss16_shapes.append(fin_wide16)
    dense_k1000_bf16 = read_launches(mods)
    check_launched(f"dense K={DENSE_WIDE_K} final pass bf16",
                   dense_k1000_bf16, ("dense_sstats_bf16",
                                      "dense_sstats_wide_bf16"))
    del final
    dg_shapes = [dg, dg_wide]
    del wcorpus, wbeta

    # -- kernels at SVI config 4's and 5's shapes: one minibatch's ----------
    svi_corpus, svi_beta, _ = synthetic_corpus(
        num_docs=SVI_D, num_topics=SVI_K, num_types=SVI_V,
        mean_doc_length=SVI_LEN, seed=3,
    )
    svi_cfg = LDAConfig(number_of_topics=SVI_K, inference_mode="svi",
                        batch_size=SVI_BATCH, tau0=64.0, kappa=0.7,
                        inner_iterations=50, convergence_threshold=1e-5,
                        seed=0)
    svi_rg, svi_ss, _, _ = svi_kernel_lines("svi config 4", svi_corpus,
                                            svi_beta, svi_cfg, dev)
    svi5_corpus, svi5_beta, _ = synthetic_corpus(
        num_docs=SVI5["D"], num_topics=SVI5["K"], num_types=SVI5["V"],
        mean_doc_length=SVI5["LEN"], seed=SVI5["SEED"],
    )
    svi5_cfg = LDAConfig(number_of_topics=SVI5["K"], inference_mode="svi",
                         batch_size=SVI5["BATCH"], tau0=64.0, kappa=0.7,
                         seed=0, inner_iterations=SVI5["INNER"])
    svi5_rg, svi5_ss, svi5_rg16, svi5_ss16 = svi_kernel_lines(
        "svi config 5", svi5_corpus, svi5_beta, svi5_cfg, dev, bf16=True,
        range_lines=range_lines)
    rg_shapes = [rg, svi_rg, svi5_rg]
    ss_shapes += [svi_ss, svi5_ss]
    rg16_shapes = [rg16, svi5_rg16]
    ss16_shapes.append(svi5_ss16)

    # -- engines: the main paths ---------------------------------------------
    by_path = {"dense_k1000": dense_k1000,
               "dense_k1000_bf16": dense_k1000_bf16}
    test, _, _ = synthetic_corpus(
        num_docs=1024, num_topics=K, num_types=V, mean_doc_length=MEAN_LEN,
        seed=1, beta=beta,
    )
    cfg16 = dataclasses.replace(cfg, compute_dtype=BF16)
    dtest, _, _ = synthetic_corpus(
        num_docs=1024, num_topics=K, num_types=V_DENSE,
        mean_doc_length=MEAN_LEN, seed=1, beta=dbeta,
    )
    roofline = {}
    for route, data in (("ragged", (corpus, test)), ("dense", (dcorpus, dtest))):
        label = f"engine {route} flagship"
        gamma = "ragged_gamma" if route == "ragged" else "dense_gamma"
        # Every flagship row fits one block's slot buffer: the entry
        # kernel (the gamma kernels' "_cluster" counts) stays off the path.
        off = [f"{name}_cluster{m}" for name in ("ragged_gamma", "dense_gamma")
               for m in ("", "_bf16")]
        r32 = run_engine(label, cfg, *data, dev, mods,
                         (gamma, "dense_sstats"), absent=off)
        rl = roofline_phase(label, r32.pop("engine"), mods,
                            iteration_ms=r32["iteration_ms"])
        roofline[route] = rl["rows"]
        by_path[f"roofline_{route}"] = rl["launches"]
        # In bf16 every flagship launch takes the warp-group kernel, and
        # every sstats launch the tensor-core kernel.
        r16 = run_engine(f"{label} bf16", cfg16, *data, dev, mods,
                         (f"{gamma}_bf16", f"{gamma}_group_bf16",
                          "dense_sstats_bf16", "dense_sstats_mma_bf16"),
                         absent=off)
        del r16["engine"]
        hold_bf16(label, r32, r16)
        by_path[route] = r32["launches"]
        by_path[f"{route}_bf16"] = r16["launches"]
        # Batch VB from each random gamma init on the card.
        held = synthetic_corpus(num_docs=GAMMA0_TEST_DOCS, num_topics=K,
                                num_types=data[0].num_types,
                                mean_doc_length=MEAN_LEN, seed=1,
                                beta=beta if route == "ragged" else dbeta)[0]
        for mode, got in vb_gamma_init(label, cfg, data[0], held, dev, mods,
                                       gamma).items():
            by_path[f"vb_gamma_init_{route}_{mode}"] = got
    # The scatter route against the dense-sstats route at the ragged flagship.
    scatter["vb_ragged_flagship"] = vb_scatter_vs_dense(
        "engine ragged flagship", cfg, corpus, dev, mods)
    by_path["vb_scatter"] = scatter["vb_ragged_flagship"].pop("launches")
    svi_test, _, _ = synthetic_corpus(
        num_docs=512, num_topics=SVI_K, num_types=SVI_V,
        mean_doc_length=SVI_LEN, seed=103, beta=svi_beta,
    )
    # Every row of configs 4 and 5 is past one block's slot buffer: the
    # launches take the entry kernel.
    r = run_svi("engine svi config 4", svi_cfg, svi_corpus, svi_test, dev,
                mods, 4, needed=("ragged_gamma_cluster",))
    by_path["svi"] = r["launches"]
    rl = roofline_phase("engine svi config 4", r.pop("engine"), mods)
    roofline["svi4"], by_path["roofline_svi4"] = rl["rows"], rl["launches"]
    # ... the scatter route against it, and from a disk-backed corpus.
    scatter["svi_config4"] = svi_scatter_vs_dense(
        "engine svi config 4", svi_cfg, svi_corpus, dev, mods)
    by_path["svi_scatter"] = scatter["svi_config4"].pop("launches")
    scatter["svi_streaming"] = svi_streaming_vs_memory(
        "engine svi config 4 streaming", svi_cfg, svi_corpus, dev, mods)
    by_path["svi_streaming"] = scatter["svi_streaming"].pop("launches")
    # The index pass through the C tokenizer and through Python.
    native = {"config4": native_index("native index svi config 4", svi_cfg,
                                      svi_corpus, dev)}
    del svi_corpus, svi_test
    svi5_test, _, _ = synthetic_corpus(
        num_docs=SVI5["TEST_DOCS"], num_topics=SVI5["K"],
        num_types=SVI5["V"], mean_doc_length=SVI5["LEN"],
        seed=SVI5["TEST_SEED"], beta=svi5_beta,
    )
    # ... and its sstats chunks (K = 1000) the sstats cluster kernel.
    r32 = run_svi("engine svi config 5", svi5_cfg, svi5_corpus, svi5_test,
                  dev, mods, 2, needed=("ragged_gamma_cluster",
                                        "dense_sstats_wide"))
    rl = roofline_phase("engine svi config 5", r32.pop("engine"), mods)
    roofline["svi5"], by_path["roofline_svi5"] = rl["rows"], rl["launches"]
    r16 = run_svi("engine svi config 5 bf16",
                  dataclasses.replace(svi5_cfg, compute_dtype=BF16),
                  svi5_corpus, svi5_test, dev, mods, 2,
                  needed=("ragged_gamma_cluster_bf16",
                          "dense_sstats_wide_bf16"))
    del r16["engine"]
    hold_bf16("engine svi config 5", r32, r16)
    by_path["svi5"], by_path["svi5_bf16"] = r32["launches"], r16["launches"]
    del r32, r16
    torch.cuda.empty_cache()

    # -- above K = 4096: the kernels' tiled and two-pass range ----------------
    t_wide = time.perf_counter()
    wdcorpus, wdbeta, _ = synthetic_corpus(
        num_docs=256, num_topics=K, num_types=V_DENSE,
        mean_doc_length=MEAN_LEN, seed=0,
    )
    wide = wide_kernels(svi5_corpus, svi5_beta, wdcorpus, wdbeta, dev)
    del wdcorpus, wdbeta
    torch.cuda.empty_cache()
    wide_runs = wide_engines(corpus, test, dcorpus, dtest, svi5_corpus,
                             svi5_test, dev, mods, by_path, roofline)
    print(f"wide phases (kernels and engines): "
          f"{time.perf_counter() - t_wide:.1f} s")
    del corpus, test, dcorpus, dtest
    del svi5_corpus, svi5_test, svi5_beta

    # -- SVI at config 4's published 100,000 documents: the scatter route -----
    kw4 = dict(num_topics=SVI_K, num_types=SVI_V, mean_doc_length=SVI_LEN)
    t0 = time.perf_counter()
    corpus4, beta4, _ = synthetic_corpus(num_docs=SVI4_FULL_D, seed=3, **kw4)
    test4, _, _ = synthetic_corpus(num_docs=SVI_TEST_DOCS, seed=SVI_TEST_SEED,
                                   beta=beta4, **kw4)
    print(f"engine svi config 4 full: corpus of {corpus4.num_docs} documents "
          f"({corpus4.num_tokens} tokens) and {test4.num_docs} held-out made "
          f"in {time.perf_counter() - t0:.2f} s")
    del beta4
    scatter["svi4_full"] = run_svi4_full("engine svi config 4 full", svi_cfg,
                                         corpus4, test4, dev, mods)
    by_path["svi4_full"] = scatter["svi4_full"].pop("launches")
    by_path["svi4_full_heldout"] = scatter["svi4_full"].pop("launches_heldout")
    rl = roofline_phase("engine svi config 4 full",
                        scatter["svi4_full"].pop("engine"), mods)
    roofline["svi4_full"] = rl["rows"]
    by_path["roofline_svi4_full"] = rl["launches"]
    native["svi4_full"] = native_index("native index svi config 4 full",
                                       svi_cfg, corpus4, dev)
    del corpus4, test4

    # -- the sampling engines at BASELINE config 3 (plain PyTorch) -----------
    c3_kw = dict(num_topics=CFG3["K"], num_types=CFG3["V"],
                 mean_doc_length=CFG3["LEN"])
    c3, c3_beta, _ = synthetic_corpus(num_docs=CFG3["D"], seed=CFG3["SEED"],
                                      **c3_kw)
    c3_test, _, _ = synthetic_corpus(num_docs=CFG3["TEST_DOCS"],
                                     seed=CFG3["TEST_SEED"], beta=c3_beta,
                                     **c3_kw)
    sampling = {}
    for mode in ("gibbs", "hybrid"):
        c3_cfg = LDAConfig(number_of_topics=CFG3["K"], inference_mode=mode,
                           number_of_samples=CFG3["SAMPLES"],
                           burn_in_sweeps=CFG3["BURN_IN"], seed=0)
        r = run_sampling(f"engine {mode} config 3", c3_cfg, c3, c3_test, dev,
                         mods, CFG3["EXTRA"])
        eng = r.pop("engine")
        by_path[mode] = r.pop("launches")
        sampling[mode] = r
        rl = roofline_phase(f"engine {mode} config 3", eng, mods)
        roofline[mode] = rl["rows"]
        by_path[f"roofline_{mode}"] = rl["launches"]
        if mode == "gibbs":
            sampling_card_vs_cpu(eng, dev)
        del eng
    ratio = (sampling["hybrid"]["point_perplexity"]
             / sampling["gibbs"]["point_perplexity"])
    print(f"config 3 gate: hybrid point-estimate perplexity "
          f"{sampling['hybrid']['point_perplexity']:.2f} is {ratio:.4f}x "
          f"Gibbs's {sampling['gibbs']['point_perplexity']:.2f} (gate "
          f"<= {CFG3['GATE']}x) {'ok' if ratio <= CFG3['GATE'] else 'FAIL'}")
    print(f"sampling: {json.dumps(sampling)}")
    if not ratio <= CFG3["GATE"]:
        raise AssertionError("config 3: hybrid misses the 1.1x gate")
    del c3, c3_test, c3_beta

    # -- CLI on the bundled corpus -------------------------------------------
    for mode, cd in itertools.product(("vb", "svi"), ("float32", BF16)):
        path = ("cli" if mode == "vb" else "cli_svi") + (
            "_bf16" if cd == BF16 else "")
        by_path[path] = run_cli(mods, mode, cd)
    for mode in ("gibbs", "hybrid"):
        by_path[f"cli_{mode}"] = run_cli(mods, mode, needed=())
    by_path["cli_svi_streaming"] = run_cli(mods, "svi", streaming=True)
    by_path["cli_observability"] = cli_observability(mods)
    for mode in ("vb", "svi"):
        by_path[f"cli_wide_k_{mode}"] = run_cli(
            mods, mode, topics=WIDE_DENSE_K,
            needed=("dense_gamma", "dense_sstats", "dense_gamma_wide",
                    "dense_sstats_wide"))
    # -- across ranks ----------------------------------------------------------
    dist = dist_phases(mods, dev, by_path)
    # Each kernel build's launches on each main path (each run zeroed just
    # before and read just after), and their sum.
    paths = {name: {path: got[name] for path, got in by_path.items()}
             for name in read_launches(mods)}
    launches = {name: sum(per.values()) for name, per in paths.items()}
    print(f"main paths: kernel launches {paths}")
    earlier = {name: sum(n for path, n in per.items()
                         if not path.removeprefix("roofline_").startswith(
                             WIDE_PATH_PREFIXES))
               for name, per in paths.items()}
    print(f"kernel launches on the paths this script drove before the wide "
          f"range: {earlier}")

    # -- cross-check: card vs CPU at a small size, on each route -------------
    disagree = card_vs_cpu_checks()
    if disagree:
        raise AssertionError(f"card and CPU engines disagree: {disagree}")

    record = {"kernels": [
        {"name": "dense_sstats", "route": "cuda",
         "source": "pylda_tpu_torch/csrc/dense_sstats.cu",
         "replaces": "pylda_tpu/ops/pallas_sstats.py:114",
         "launches": launches["dense_sstats"],
         "launches_by_path": paths["dense_sstats"],
         **{k: ss_shapes[0][k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "dense_form_bound_ms")},
         "library_ms": None, "shapes": ss_shapes},
        {"name": "ragged_gamma", "route": "cuda",
         "source": "pylda_tpu_torch/csrc/ragged_gamma.cu",
         "replaces": "pylda_tpu/ops/pallas_ragged.py:212",
         "launches": launches["ragged_gamma"],
         "launches_by_path": paths["ragged_gamma"],
         **{k: rg[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by")},
         "library_ms": None, "shapes": rg_shapes},
        {"name": "dense_gamma", "route": "cuda",
         "source": "pylda_tpu_torch/csrc/dense_gamma.cu",
         "replaces": "pylda_tpu/ops/pallas_estep.py:272",
         "launches": launches["dense_gamma"],
         "launches_by_path": paths["dense_gamma"],
         **{k: dg[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "dense_form_bound_ms")},
         "library_ms": None, "shapes": dg_shapes},
    ]}
    # The bf16 builds (nvcc -DPYLDA_BF16=1 of the same sources).
    for name, line, shapes in (("dense_sstats", ss16_shapes[0], ss16_shapes),
                               ("ragged_gamma", rg16, rg16_shapes),
                               ("dense_gamma", dg16, [dg16])):
        f32 = next(k for k in record["kernels"] if k["name"] == name)
        record["kernels"].append({
            **{k: f32[k] for k in ("route", "source", "replaces")},
            "name": f"{name}_bf16", "build": "-DPYLDA_BF16=1",
            "launches": launches[f"{name}_bf16"],
            "launches_by_path": paths[f"{name}_bf16"],
            **{k: line[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by")},
            "library_ms": None, "shapes": shapes})
    # The gamma kernels' entry kernel (K <= 4096, rows past one block's
    # slot buffer), counted in the ragged gamma builds' launches above too:
    # its lines are SVI config 5's minibatch (every launch on it).
    for name, line in (("ragged_gamma_cluster", svi5_rg),
                       ("ragged_gamma_cluster_bf16", svi5_rg16)):
        f32 = next(k for k in record["kernels"] if k["name"] == "ragged_gamma")
        record["kernels"].append({
            **{k: f32[k] for k in ("route", "source", "replaces")},
            "name": name,
            **({"build": "-DPYLDA_BF16=1"} if name.endswith("_bf16") else {}),
            "core": "pylda_tpu_torch/csrc/row_fixed_point_entries.cuh",
            "launches": launches[name], "launches_by_path": paths[name],
            **{k: line[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by")},
            "library_ms": None,
            "shapes": [r for r in (rg_shapes + rg16_shapes + dg_shapes)
                       if "entries" in r.get("routes", [r.get("route")])]})
    # The bf16 warp-group kernel (K <= 256, rows that fit a group's slots),
    # counted in the gamma kernels' bf16 launches above too: its lines are
    # the flagships' (every launch there on it).
    for name, line in (("ragged_gamma_group_bf16", rg16),
                       ("dense_gamma_group_bf16", dg16)):
        f32 = next(k for k in record["kernels"]
                   if k["name"] == name.replace("_group_bf16", ""))
        record["kernels"].append({
            **{k: f32[k] for k in ("route", "source", "replaces")},
            "name": name, "build": "-DPYLDA_BF16=1",
            "core": "pylda_tpu_torch/csrc/row_fixed_point_groups.cuh",
            "launches": launches[name], "launches_by_path": paths[name],
            **{k: line[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by")},
            "library_ms": None, "shapes": [line]})
        if not launches[name]:
            raise AssertionError(f"{name}: no launch on the main paths")
    # The sstats kernel's topic-range launches (lambda split over topics):
    # counted in its builds' launches above too.
    f32 = record["kernels"][0]
    for cd, suffix in (("float32", ""), (BF16, "_bf16")):
        name = f"dense_sstats_range{suffix}"
        line = range_lines[cd][0]
        record["kernels"].append({
            **{k: f32[k] for k in ("route", "source", "replaces")},
            "name": name, **({"build": "-DPYLDA_BF16=1"} if suffix else {}),
            "entry": "pylda_dense_sstats_range",
            "launches": launches[name], "launches_by_path": paths[name],
            **{k: line[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "full_range_ms")},
            "library_ms": None, "shapes": range_lines[cd]})
    # The bf16 build's tensor-core kernel (K <= 256: every bf16 sstats
    # launch of the flagships, the bf16 CLIs and shard_topics_vb's bf16
    # run), counted in "dense_sstats_bf16" (and its range launches in
    # "dense_sstats_range_bf16") too: its lines are the ragged flagship
    # chunk's and the dense final pass's, and the chunk's topic halves.
    for name, line, shapes in (
            ("dense_sstats_mma_bf16", ss16_shapes[0],
             [r for r in ss16_shapes if r.get("route") == "mma"]),
            ("dense_sstats_range_mma_bf16", range_lines[BF16][0],
             [r for r in range_lines[BF16] if r.get("route") == "mma"])):
        f32 = record["kernels"][0]
        record["kernels"].append({
            **{k: f32[k] for k in ("route", "source", "replaces")},
            "name": name, "build": "-DPYLDA_BF16=1",
            "core": "pylda_tpu_torch/csrc/dense_sstats_mma.cuh",
            "entry": "pylda_dense_sstats_range",
            "launches": launches[name], "launches_by_path": paths[name],
            **{k: line[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by")},
            "library_ms": None, "shapes": shapes})
        if not launches[name] or not shapes:
            raise AssertionError(f"{name}: no launch on the main paths")
    # The sstats cluster kernel at 256 < K <= 4096 (SVI config 5's K = 1000
    # chunk, the dense K = 1000 final pass): counted in "dense_sstats" and
    # "dense_sstats_wide" too (every cluster launch at any K); its launches
    # are the cluster kernel's on the paths before the range above 4096.
    for name, line, shapes in (
            ("dense_sstats_cluster", svi5_ss, [svi5_ss, fin_wide]),
            ("dense_sstats_cluster_bf16", svi5_ss16, [svi5_ss16, fin_wide16])):
        counter = name.replace("cluster", "wide")
        f32 = record["kernels"][0]
        record["kernels"].append({
            **{k: f32[k] for k in ("route", "source", "replaces")},
            "name": name,
            **({"build": "-DPYLDA_BF16=1"} if name.endswith("_bf16") else {}),
            "entry": "pylda_dense_sstats_wide",
            "launches": earlier[counter],
            "launches_by_path": {
                path: n for path, n in paths[counter].items()
                if n and not path.removeprefix("roofline_").startswith(
                    WIDE_PATH_PREFIXES)},
            **{k: line[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by")},
            "library_ms": None, "shapes": shapes})
    # The range above K = 4096 (the gamma and the sstats cluster kernels and
    # the sstats topic range): counted in the lines above too; its launches
    # are those on the paths of that range (the sstats cluster kernel's on
    # the others are the rows above).
    # Each line is the K = 8192 check's; "shapes" holds every K's.  The
    # bf16 topic range above 4096 is on no main path (shard_topics_vb_wide
    # runs in float32): its checks are the wide_k_kernels lines.
    for name in wide:
        if name == "dense_sstats_range_wide_bf16":
            continue
        base = name.replace("_wide", "").replace("_bf16", "")
        f32 = next(k for k in record["kernels"]
                   if k["name"] == base.replace("_range", ""))
        line = next(r for r in wide[name] if r["K"] == WIDE_K)
        record["kernels"].append({
            **{k: f32[k] for k in ("route", "source", "replaces")},
            "name": name,
            **({"build": "-DPYLDA_BF16=1"} if name.endswith("_bf16") else {}),
            **({"core": "pylda_tpu_torch/csrc/row_fixed_point_tiled.cuh"}
               if "gamma" in name else {"entry": "pylda_dense_sstats_wide"}),
            "launches": launches[name] - earlier[name],
            "launches_by_path": {
                path: n for path, n in paths[name].items()
                if path.removeprefix("roofline_").startswith(
                    WIDE_PATH_PREFIXES)},
            **{k: line[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by")},
            "library_ms": None, "shapes": wide[name]})
    print(f"wide: {json.dumps(wide_runs)}")
    print(f"scatter: {json.dumps(scatter)}")
    print(f"roofline: {json.dumps(roofline)}")
    print(f"native: {json.dumps(native)}")
    print(f"dist: {json.dumps(dist)}")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(f"nvidia-smi: {nvidia_smi()}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-rank"]:
        sys.exit(dist_rank(sys.argv[2:]))
    sys.exit(main())
