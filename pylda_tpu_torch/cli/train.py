"""Training launcher — the reference's ``launch_train.py`` surface.

    python -m pylda_tpu_torch.cli.train --input_directory=DIR \\
        --output_directory=OUT --number_of_topics=10 [--device=cpu]

Counterpart of ``pylda_tpu.cli.train`` (``pylda-train``): the same flags,
defaults and config mapping.  It loads doc.dat/voc.dat[/test.dat], creates
the run directory ``<out>/<corpus>/<timestamp>-lda-I..-S..-K..-aa..-ab..
-im..``, runs ``learning_many`` in chunks up to each snapshot, logging each
iteration's wall time and log-likelihood to stdout and ``metrics.jsonl``,
and writes ``exp_beta-<N>``, ``model-<N>`` (and, with ``--dump_gamma``,
``gamma-<N>``) at every snapshot and at the end, with held-out perplexity
when test.dat exists.  The observability flags: ``--coherence`` (UMass
coherence at each snapshot), ``--tensorboard_dir`` (TensorBoard scalars
through ``torch.utils.tensorboard``), ``--profile_dir`` (a
``torch.profiler`` Chrome trace of the training loop, with the card's
kernels when the engine runs there), ``--phase_timing`` (the engine's
``phase_timings`` after training) and ``--roofline`` (the cost model at
start, the measured phases beside their H100 bounds after training).
``--device`` picks the torch device (the CUDA card by default).

Across processes, one a card: ``--coordinator_address HOST:PORT
--num_processes P --process_id R`` joins the process group
(``parallel.mesh.init_distributed``; run under ``torchrun`` without these
flags, its ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``
do the same), ``--mesh D,M`` runs D * M ranks, the documents split over
the D data coordinates (rank r at d = r // M), and
``--process_sharded_input`` makes each rank parse only the block of
doc.dat of its data coordinate (streaming too; the M ranks of a model
group read the same block).  With M > 1, ``--shard_vocab`` or
``--shard_topics`` splits lambda (and Gibbs's count table) over the
model group's M ranks, in every mode; with neither flag the M ranks of a
model group are replicas.
Rank 0 writes the run directory, the logs and the files, in the
one-process format; every rank runs the snapshots, which are collective.
A mesh whose D * M is not the number of processes exits saying how to
launch them; both shard flags together exit with the config's error.
"""

from __future__ import annotations

import argparse
import datetime
import os
import time
from typing import List, Optional

import numpy as np

from pylda_tpu_torch.corpus.datasets import load_input_directory
from pylda_tpu_torch.parallel import mesh as pmesh
from pylda_tpu_torch.utils.config import LDAConfig
from pylda_tpu_torch.utils.metrics import MetricsLogger, is_host_zero

# The reference's --inference_mode may be an integer selector; accept both.
_MODE_ALIASES = {
    "0": "vb", "vb": "vb", "variational": "vb", "variational_bayes": "vb",
    "1": "gibbs", "gibbs": "gibbs", "mc": "gibbs", "monte_carlo": "gibbs",
    "2": "hybrid", "hybrid": "hybrid",
    "3": "svi", "svi": "svi", "online": "svi", "stochastic": "svi",
}

# The Chrome trace --profile_dir writes.
PROFILE_TRACE = "train_trace.json"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pylda_tpu_torch.cli.train",
        description="LDA training on PyTorch (PyLDA-compatible flags)",
    )
    # -- reference flags --
    p.add_argument("--input_directory", required=True)
    p.add_argument("--output_directory", required=True)
    p.add_argument("--number_of_topics", type=int, required=True)
    p.add_argument("--training_iterations", type=int, default=50)
    p.add_argument("--alpha_alpha", type=float, default=-1.0,
                   help="doc-topic Dirichlet; <=0 means 1/K (reference default)")
    p.add_argument("--alpha_beta", type=float, default=-1.0,
                   help="topic-word Dirichlet; <=0 means 1/V (reference default)")
    p.add_argument("--snapshot_interval", type=int, default=10)
    p.add_argument("--hyper_parameter_optimize_interval", type=int, default=0)
    p.add_argument("--inference_mode", default="vb",
                   help="vb|gibbs|hybrid|svi (or reference ints 0/1/2)")
    # -- engine knobs --
    p.add_argument("--inner_iterations", type=int, default=50)
    p.add_argument("--convergence_threshold", type=float, default=1e-5)
    p.add_argument("--number_of_samples", type=int, default=10)
    p.add_argument("--burn_in_sweeps", type=int, default=5)
    # -- SVI --
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--tau0", type=float, default=64.0)
    p.add_argument("--kappa", type=float, default=0.7)
    # -- layout / parallelism --
    p.add_argument("--dense_vocab_threshold", type=int, default=4096)
    p.add_argument("--bucket_policy", default="auto",
                   choices=["auto", "fixed"],
                   help="ragged-layout bucket geometry: 'auto' plans a "
                        "corpus-adaptive slot-minimising geometry from "
                        "the unique-type histogram; 'fixed' (and any "
                        "explicit --bucket_sizes) uses the configured "
                        "boundaries")
    p.add_argument("--bucket_sizes", default=None,
                   help="comma-separated ragged bucket boundaries "
                        "(e.g. 64,128,256,2048); implies a fixed "
                        "geometry")
    p.add_argument("--sstats_mode", default="auto",
                   choices=["auto", "scatter", "dense"],
                   help="ragged-layout sufficient statistics: 'auto' uses "
                        "the scatter-free dense form when the "
                        "corpus-static dense counts fit the budget, "
                        "else the row scatter; 'scatter' always takes "
                        "the row scatter")
    p.add_argument("--sstats_dense_total_budget_mb", type=int, default=4096,
                   help="budget for the dense sstats counts matrix")
    p.add_argument("--sstats_kernel", default="auto",
                   choices=["auto", "xla", "pallas"],
                   help="JAX package only (kept in the config); this "
                        "package picks the CUDA kernel by device")
    p.add_argument("--topic_sampler", default="auto",
                   choices=["auto", "cdf", "gumbel", "race"],
                   help="batched categorical draw of the Gibbs/hybrid "
                        "engines (kept in the config)")
    p.add_argument("--sampler_block_positions", type=int, default=None,
                   help="positions sampled per within-doc scan step "
                        "(Gibbs/hybrid; default: the config default)")
    p.add_argument("--gibbs_rebuild_interval", type=int, default=None,
                   help="Gibbs: rebuild the [K,V] count table every R "
                        "sweeps of a learning_many chunk and at its end "
                        "(1 = exact per-sweep sync; default: the config "
                        "default).  At R > 1 the log-likelihood printed "
                        "for a sweep without a rebuild is approximate: "
                        "the last rebuilt table's topic side plus that "
                        "sweep's doc side, not the joint LL of one state "
                        "(the JAX package prints the same values)")
    p.add_argument("--slice_samples", type=int, default=None,
                   help="Wallach slice-sampler draws per hyperopt call "
                        "(Gibbs; default: the config default)")
    p.add_argument("--slice_step", type=float, default=None,
                   help="slice-sampler initial bracket step in log "
                        "space (default: the config default)")
    p.add_argument("--hybrid_persistent_z", action="store_true",
                   help="hybrid: carry per-doc topic assignments across "
                        "iterations (default off)")
    p.add_argument("--doc_pad_multiple", type=int, default=None,
                   help="row-count alignment for batch layouts "
                        "(default: the config default)")
    p.add_argument("--estep_stall_patience", type=int, default=None,
                   help="sweeps without 1%% best-change improvement "
                        "before a row counts as stalled; 0 disables "
                        "(default: the config default)")
    p.add_argument("--estep_memory_budget_mb", type=int, default=None,
                   help="cap on per-chunk E-step work arrays "
                        "(default: the config default)")
    p.add_argument("--sstats_dense_budget_mb", type=int, default=None,
                   help="per-chunk budget for the dense sstats counts "
                        "matrix (default: the config default)")
    p.add_argument("--svi_device_rows_budget_mb", type=int, default=None,
                   help="device-resident corpus rows budget for SVI "
                        "(default: the config default)")
    p.add_argument("--use_pallas", default=None,
                   choices=["never", "always"],
                   help="JAX package only (kept in the config); this "
                        "package runs its CUDA kernels on the card")
    p.add_argument("--mesh", default=None,
                   help="data,model mesh shape: data * model = the number "
                        "of processes (one a card); rank r holds the "
                        "documents of data coordinate r // model")
    p.add_argument("--shard_vocab", action="store_true",
                   help="split lambda's vocabulary axis (and Gibbs's "
                        "count table's) over the model axis")
    p.add_argument("--shard_topics", action="store_true",
                   help="split lambda's topic axis (and Gibbs's count "
                        "table's) over the model axis")
    p.add_argument("--coordinator_address", default=None,
                   help="multi-process: host:port of process 0's "
                        "rendezvous")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--process_sharded_input", action="store_true",
                   help="each process parses only the block of doc.dat "
                        "of its data coordinate")
    p.add_argument("--streaming_input", action="store_true",
                   help="disk-backed SVI input: doc.dat read by line "
                        "offsets and a parsed-row sidecar beside it "
                        "(requires --inference_mode=svi)")
    # -- misc --
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="bfloat16 = mixed-precision E-step contractions "
                        "(bf16 operands, f32 sums: the kernels' bf16 "
                        "builds)")
    p.add_argument("--gamma_init", default=None,
                   choices=["gamma", "normal", "ones"],
                   help="per-E-step cold-start init (default: the "
                        "config default, ones)")
    p.add_argument("--checkpoint_format", default="npz",
                   choices=["npz", "orbax"],
                   help="model-<N> snapshots as one npz file; orbax is "
                        "JAX-only")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler Chrome trace of the "
                        f"training loop here ({PROFILE_TRACE})")
    p.add_argument("--phase_timing", action="store_true",
                   help="log per-phase device times after training")
    p.add_argument("--coherence", action="store_true",
                   help="log UMass topic coherence at snapshots")
    p.add_argument("--async_checkpoint", action="store_true",
                   help="write periodic model-<N> snapshots from a "
                        "background thread")
    p.add_argument("--roofline", action="store_true",
                   help="log the H100 roofline cost model at start and "
                        "the measured phases beside it after training")
    p.add_argument("--tensorboard_dir", default=None,
                   help="write TensorBoard scalars here")
    p.add_argument("--resume", default=None,
                   help="path to a model-<N> checkpoint to resume from")
    p.add_argument("--dump_gamma", action="store_true",
                   help="also write per-document gamma-<N> at snapshots")
    p.add_argument("--device", default=None,
                   help="torch device: the CUDA card by default; 'cpu' "
                        "runs the plain PyTorch versions of the kernels")
    return p


def config_from_args(args) -> LDAConfig:
    mode = _MODE_ALIASES.get(str(args.inference_mode).lower())
    if mode is None:
        raise SystemExit(f"unknown --inference_mode: {args.inference_mode}")
    return LDAConfig(
        number_of_topics=args.number_of_topics,
        alpha_alpha=None if args.alpha_alpha <= 0 else args.alpha_alpha,
        alpha_beta=None if args.alpha_beta <= 0 else args.alpha_beta,
        training_iterations=args.training_iterations,
        snapshot_interval=args.snapshot_interval,
        hyper_parameter_optimize_interval=(
            args.hyper_parameter_optimize_interval
        ),
        inference_mode=mode,
        inner_iterations=args.inner_iterations,
        convergence_threshold=args.convergence_threshold,
        number_of_samples=args.number_of_samples,
        burn_in_sweeps=args.burn_in_sweeps,
        batch_size=args.batch_size,
        tau0=args.tau0,
        kappa=args.kappa,
        dense_vocab_threshold=args.dense_vocab_threshold,
        bucket_policy=args.bucket_policy,
        **(
            {"bucket_sizes": tuple(
                int(x) for x in args.bucket_sizes.split(","))}
            if args.bucket_sizes else {}
        ),
        sstats_mode=args.sstats_mode,
        sstats_dense_total_budget_mb=args.sstats_dense_total_budget_mb,
        sstats_kernel=args.sstats_kernel,
        topic_sampler=args.topic_sampler,
        **{
            k: getattr(args, k)
            for k in (
                "sampler_block_positions", "gibbs_rebuild_interval",
                "slice_samples", "slice_step", "doc_pad_multiple",
                "estep_stall_patience", "estep_memory_budget_mb",
                "sstats_dense_budget_mb", "svi_device_rows_budget_mb",
                "use_pallas", "gamma_init",
            )
            if getattr(args, k) is not None
        },
        **({"hybrid_persistent_z": True} if args.hybrid_persistent_z
           else {}),
        mesh_shape=(
            tuple(int(x) for x in args.mesh.split(",")) if args.mesh else None
        ),
        shard_vocab=args.shard_vocab,
        shard_topics=args.shard_topics,
        seed=args.seed,
        dtype=args.dtype,
        compute_dtype=args.compute_dtype,
        checkpoint_format=args.checkpoint_format,
    ).validate()


def output_run_directory(args, config: LDAConfig) -> str:
    """Reference-style run dir: <out>/<corpus>/<timestamp>-lda-I..-S..-K..
    -aa..-ab..-im.. (the config is readable from the path)."""
    corpus_name = os.path.basename(os.path.normpath(args.input_directory))
    ts = datetime.datetime.now().strftime("%y%m%d-%H%M%S")
    aa = config.alpha_alpha if config.alpha_alpha else config.resolved_alpha()
    ab = config.alpha_beta if config.alpha_beta else 0.0
    suffix = (
        f"{ts}-lda-I{config.training_iterations}"
        f"-S{config.snapshot_interval}-K{config.number_of_topics}"
        f"-aa{aa:g}-ab{ab:g}-im{config.inference_mode}"
    )
    return os.path.join(args.output_directory, corpus_name, suffix)


def join_processes(args) -> Optional[str]:
    """Join the process group the flags (or ``torchrun``'s environment)
    describe; returns the device group's backend, or None in one process.
    ``--num_processes`` or ``--process_id`` without a coordinator do
    nothing, as in the JAX package; a coordinator without both exits."""
    if args.coordinator_address is not None:
        if args.num_processes is None or args.process_id is None:
            raise SystemExit(
                "--coordinator_address needs --num_processes and "
                "--process_id (every process passes the same address and "
                "count, and its own id)")
        flags = (args.coordinator_address, args.num_processes,
                 args.process_id)
    elif args.num_processes is None and args.process_id is None:
        flags = pmesh.environment_process_flags()
    else:
        flags = None
    if flags is None:
        return None
    device = "cpu" if str(args.device or "cuda").startswith("cpu") else "cuda"
    return pmesh.init_distributed(*flags, device=device)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        config = config_from_args(args)
    except ValueError as e:
        raise SystemExit(f"invalid configuration: {e}") from e
    if config.checkpoint_format == "orbax":
        raise SystemExit(
            "--checkpoint_format=orbax is JAX-only; this package writes npz "
            "(ROADMAP.md Queue 1 item 6)"
        )
    if args.streaming_input and config.inference_mode != "svi":
        raise SystemExit("--streaming_input requires --inference_mode=svi")

    backend = join_processes(args)
    try:
        return _train(args, config, backend)
    finally:
        pmesh.shutdown()


def _train(args, config: LDAConfig, backend: Optional[str]) -> int:
    mesh = None
    if config.mesh_shape is not None:
        try:
            mesh = pmesh.make_mesh(config.mesh_shape, device=args.device)
        except ValueError as e:
            raise SystemExit(str(e)) from e
    rank, world = pmesh.world()
    if args.process_sharded_input:
        # The block of the rank's data coordinate: a model group reads one.
        index, count = ((mesh.data_index, mesh.data) if mesh is not None
                        else (rank, world))
        train, test, vocab = load_input_directory(
            args.input_directory, process_index=index, process_count=count,
            streaming=args.streaming_input,
        )
    else:
        train, test, vocab = load_input_directory(
            args.input_directory, streaming=args.streaming_input
        )
    # Rank 0's run directory (and timestamp) for every rank.
    run_dir = pmesh.broadcast_object(output_run_directory(args, config))
    if is_host_zero():
        os.makedirs(run_dir, exist_ok=True)
    metrics = MetricsLogger(run_dir)
    # Corpus-wide counts: each rank of a process-local run holds a block.
    global_docs = train.global_num_docs
    global_tokens = train.num_tokens
    if getattr(train, "process_local", False):
        global_tokens = int(sum(pmesh.allgather_numpy(train.num_tokens, mesh,
                                                      "data")))
    metrics.log(
        event="start",
        corpus=args.input_directory,
        documents=global_docs,
        types=len(vocab),
        tokens=global_tokens,
        mode=config.inference_mode,
        K=config.number_of_topics,
        mesh=str(config.mesh_shape),
        device=args.device or "cuda",
        processes=world,
        backend=backend,
    )

    from pylda_tpu_torch.models import Inferencer, make_engine

    if args.resume:
        engine = Inferencer.load(args.resume, corpus=train, device=args.device,
                                 mesh=mesh)
        start_iter = engine._counter
        metrics.log(event="resume", checkpoint=args.resume, iteration=start_iter)
    else:
        engine = make_engine(config, device=args.device)
        engine.initialize(train, vocab, mesh=mesh)
        start_iter = 0

    if args.roofline and hasattr(engine, "_batches"):
        from pylda_tpu_torch.utils.roofline import estep_cost_model

        for phase, row in estep_cost_model(engine).items():
            metrics.log(event="roofline", phase=phase, **{
                k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in row.items()
            })

    tb_writer = None
    if args.tensorboard_dir and is_host_zero():
        try:
            from torch.utils.tensorboard import SummaryWriter

            tb_writer = SummaryWriter(args.tensorboard_dir)
        except ImportError as e:
            metrics.log(event="tensorboard_unavailable", error=str(e))

    profiler = None
    if args.profile_dir:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if engine._device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
        profiler.start()

    # Iterations run in learning_many chunks between snapshot boundaries.
    it = start_iter
    while it < config.training_iterations:
        snap = config.snapshot_interval
        to_snap = (
            snap - (it % snap) if snap > 0 else config.training_iterations - it
        )
        chunk = min(to_snap, config.training_iterations - it)
        t0 = time.time()
        lls = engine.learning_many(chunk)
        dt = (time.time() - t0) / max(1, len(lls))
        for j, ll in enumerate(lls):
            metrics.log(
                event="iteration",
                iteration=it + j + 1,
                seconds=round(dt, 3),
                log_likelihood=ll,
                docs_per_sec=round(global_docs / max(dt, 1e-9), 2),
            )
            if tb_writer is not None:
                tb_writer.add_scalar("train/log_likelihood", ll, it + j + 1)
                tb_writer.add_scalar("train/docs_per_sec",
                                     global_docs / max(dt, 1e-9), it + j + 1)
        it += chunk
        # Snapshots run on every rank: saving and gamma gather per-rank
        # chains and documents, and rank 0 writes.
        if snap > 0 and it % snap == 0:
            engine.export_beta(
                os.path.join(run_dir, f"exp_beta-{it}"), top_k=50
            )
            engine.save(os.path.join(run_dir, f"model-{it}"),
                        async_write=args.async_checkpoint)
            if args.coherence and getattr(train, "_uniques", None) is not None:
                from pylda_tpu_torch.utils.coherence import engine_coherence

                coh = engine_coherence(engine, train)
                metrics.log(event="coherence", iteration=it,
                            mean_umass=round(coh["mean"], 4),
                            top_n=coh["top_n"])
            gamma = engine.gamma if args.dump_gamma else None
            if gamma is not None and is_host_zero():
                np.savetxt(
                    os.path.join(run_dir, f"gamma-{it}"),
                    gamma, fmt="%.8g", delimiter="\t",
                )
            if test is not None:
                pp = engine.perplexity(test)
                metrics.log(
                    event="heldout", iteration=it, perplexity=round(pp, 4)
                )
                if tb_writer is not None:
                    tb_writer.add_scalar("eval/perplexity", pp, it)

    if profiler is not None:
        profiler.stop()
        os.makedirs(args.profile_dir, exist_ok=True)
        profiler.export_chrome_trace(
            os.path.join(args.profile_dir, PROFILE_TRACE))

    if args.phase_timing:
        times = engine.phase_timings()
        if times:
            metrics.log(event="phase_timing", **times)

    if args.roofline:
        # The measured phases beside their bounds at the sweeps the
        # engine ran.
        from pylda_tpu_torch.utils.roofline import roofline_report

        try:
            for phase, r in roofline_report(engine).items():
                if phase == "sweep_counts":
                    metrics.log(event="roofline_measured", phase=phase,
                                counts=r)
                else:
                    metrics.log(event="roofline_measured", phase=phase, **r)
        except Exception as e:  # never sink a finished run on a report
            metrics.log(event="roofline_measured_failed", error=str(e))

    n = config.training_iterations
    engine.export_beta(os.path.join(run_dir, f"exp_beta-{n}"), top_k=50)
    engine.save(os.path.join(run_dir, f"model-{n}"))
    engine.wait_for_checkpoint()
    if test is not None:
        metrics.log(
            event="final",
            perplexity=round(engine.perplexity(test), 4),
            run_dir=run_dir,
        )
    if tb_writer is not None:
        tb_writer.flush()
        tb_writer.close()
    metrics.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
