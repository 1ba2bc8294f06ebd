"""Process groups, the data split and the collectives: the whole comm layer.

Counterpart of ``pylda_tpu.parallel.mesh`` on ``torch.distributed``.  The
JAX package runs one process a host with a ``("data", "model")`` mesh over
its local devices, and GSPMD inserts the collectives.  This package runs
one process (rank) a card, and makes its collectives by hand:

- a mesh (D, M) runs D * M ranks; rank r sits at data coordinate
  d = r // M and model coordinate m = r % M.  The ranks of one m form a
  *data group*, those of one d a *model group* (``Mesh.group``); with
  M = 1 the data group is the world;
- each data coordinate holds whole documents: a process-local corpus's
  block d, or, for a corpus loaded whole on every rank, the same
  contiguous block of ``ceil(N / D)`` documents the process-local loader
  would give it (SVI splits each global minibatch's selection instead).
  Every rank of a model group holds the same documents.  A document's
  rows never straddle two data coordinates, so per-document gamma
  assembly and the dense sufficient statistics stay rank-local;
- lambda (and Gibbs's n_kv) is whole on every rank, or, with
  ``--shard_vocab`` / ``--shard_topics`` and M > 1, split over the model
  group (``parallel/lam_shard.py``: each rank holds its block of columns
  or rows, gathered with ``all_gather_blocks``);
- one sum all-reduce of the sufficient statistics (n_kv for Gibbs) a
  step over the data group, and one of the doc-level scalars packed
  together, keep each lambda block the same bits across its data group
  (``all_reduce_sum``);
- two groups: the *device group* carries the tensors on the engine's
  device (NCCL when every rank has a card of its own, gloo on the CPU or
  when ranks share a card), and the *host group*, always gloo, carries
  numpy negotiation (histograms, capacities, checksums, gathered gamma).
  The backend is decided once, in ``init_distributed``, from the device
  and the world size against ``torch.cuda.device_count()``.

Every collective this module makes bumps ``COLLECTIVES`` by kind, as the
kernel wrappers count ``LAUNCHES``.  No collective is skipped for a group
of one rank: without a process group nothing is reduced, with one every
call is made.

``shard_stacked_batch`` has no counterpart: the port's SVI does not stack
an epoch's minibatches into a scan, and no rank builds a global array.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# Collectives made, by kind ("all_reduce", "all_gather", "broadcast").
COLLECTIVES: collections.Counter = collections.Counter()

DEFAULT_TIMEOUT = datetime.timedelta(seconds=600)

# (device group, host group, device-group backend, the rank's device) of
# this process, set by ``init_distributed``.
_GROUPS: Optional[Tuple[Any, Any, str, str]] = None
# The timeout every group of this process gets, set by ``init_distributed``.
_TIMEOUT = DEFAULT_TIMEOUT
# (data, model) -> {"data": (device, host), "model": (device, host)}: the
# sub-groups of a mesh with a model axis, made once (every rank makes every
# group, in one order, as ``new_group`` requires).
_SUBGROUPS: Dict[Tuple[int, int], Dict[str, Tuple[Any, Any]]] = {}


def choose_backend(device_type: str, world_size: int,
                   device_count: int) -> str:
    """The device group's backend: NCCL when the ranks run on CUDA cards
    and each has one of its own (NCCL refuses two ranks on one card),
    gloo otherwise (the CPU, or ranks sharing a card: gloo reduces CUDA
    tensors too)."""
    if device_type == "cuda" and world_size <= device_count:
        return "nccl"
    return "gloo"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: Optional[str] = None,
    init_method: Optional[str] = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> Optional[str]:
    """Join the process group (``jax.distributed.initialize``'s place).

    A no-op returning None without ``coordinator_address`` and
    ``init_method``, as the JAX package's is without a coordinator.
    Otherwise ``num_processes`` and ``process_id`` are required; the
    rendezvous is ``tcp://<coordinator_address>`` (or ``init_method``,
    e.g. ``file://...``).  ``device`` is "cuda" (the default; raises
    without a card) or "cpu": on CUDA the rank's card is
    ``rank % device_count``, made current before any engine is built.
    Every group gets ``timeout``, so a collective one rank never joins
    fails instead of hanging.  Returns the device group's backend."""
    global _GROUPS, _TIMEOUT
    if coordinator_address is None and init_method is None:
        return None
    if num_processes is None or process_id is None:
        raise ValueError(
            "a coordinator address needs both the number of processes and "
            "this process's id (--num_processes and --process_id)"
        )
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is outside "
                         f"0..{num_processes - 1}")
    if device is None:
        device = "cuda"
    count = 0
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to join "
                "the process group on the CPU")
        count = torch.cuda.device_count()
        torch.cuda.set_device(process_id % count)
    backend = choose_backend(device, num_processes, count)
    if device == "cuda":
        device = f"cuda:{process_id % count}"
    dist.init_process_group(
        backend=backend,
        init_method=init_method or f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, timeout=timeout,
    )
    host = (dist.group.WORLD if backend == "gloo"
            else dist.new_group(backend="gloo", timeout=timeout))
    _GROUPS = (dist.group.WORLD, host, backend, device)
    _TIMEOUT = timeout
    return backend


def environment_process_flags(
    env: Optional[Dict[str, str]] = None,
) -> Optional[Tuple[str, int, int]]:
    """(coordinator address, world size, rank) from ``torchrun``'s
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``), or None when it is not set."""
    env = os.environ if env is None else env
    keys = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
    if not all(k in env for k in keys):
        return None
    return (f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
            int(env["WORLD_SIZE"]), int(env["RANK"]))


def shutdown() -> None:
    """Leave the process group ``init_distributed`` joined."""
    global _GROUPS
    if _GROUPS is not None:
        dist.destroy_process_group()
        _GROUPS = None
        _SUBGROUPS.clear()


def world() -> Tuple[int, int]:
    """(rank, world size) of this process: (0, 1) without a group."""
    if _GROUPS is None:
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The port's mesh: ``data`` x ``model`` ranks (one a card), this
    process's rank and device, and its groups (None in a single process
    without a group): the device and host groups of the world, and, with
    a model axis above 1, those of its data group and its model group
    (``subgroups``; with M = 1 the data group is the world and the model
    group is this rank alone, which no collective is made over)."""

    data: int
    model: int
    rank: int
    device: torch.device
    device_group: Any
    host_group: Any
    backend: Optional[str]
    subgroups: Optional[Dict[str, Tuple[Any, Any]]] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def grouped(self) -> bool:
        return self.device_group is not None

    @property
    def data_index(self) -> int:
        """The rank's data coordinate d = rank // model: its documents."""
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        """The rank's model coordinate m = rank % model: its lambda block."""
        return self.rank % self.model

    def group(self, which: str, host: bool = False):
        """The device (or, ``host``, the gloo host) group of ``which``:
        "world", "data" (the ranks of this model coordinate) or "model"
        (the ranks of this data coordinate); None without a group."""
        if not self.grouped:
            return None
        if which == "world" or (which == "data" and self.model == 1):
            return self.host_group if host else self.device_group
        if which not in ("data", "model"):
            raise ValueError(f"unknown group {which!r}")
        if self.model == 1:
            raise ValueError("a mesh with a model axis of 1 has no model "
                             "group to reduce over")
        return self.subgroups[which][1 if host else 0]


def _launch_hint(size: int) -> str:
    return (f"launch {size} processes (--coordinator_address HOST:PORT "
            f"--num_processes {size} --process_id 0..{size - 1}, or torchrun "
            f"--nproc_per_node {size})")


def _make_subgroups(data: int, model: int) -> Dict[str, Tuple[Any, Any]]:
    """This rank's data group (the ranks m, m + M, .. of its model
    coordinate m) and model group (the ranks d M .. d M + M - 1 of its
    data coordinate d), device and host, of a (D, M) = (``data``,
    ``model``) mesh; every rank makes every group of the mesh, in one
    order."""
    key = (data, model)
    if key in _SUBGROUPS:
        return _SUBGROUPS[key]
    rank = dist.get_rank()
    gloo = _GROUPS[2] == "gloo"
    mine: Dict[str, Tuple[Any, Any]] = {}
    layouts = (("data", [[d * model + m for d in range(data)]
                         for m in range(model)]),
               ("model", [[d * model + m for m in range(model)]
                          for d in range(data)]))
    for which, all_ranks in layouts:
        for ranks in all_ranks:
            dev = dist.new_group(ranks, timeout=_TIMEOUT,
                                 backend=_GROUPS[2])
            host = dev if gloo else dist.new_group(ranks, timeout=_TIMEOUT,
                                                   backend="gloo")
            if rank in ranks:
                mine[which] = (dev, host)
    _SUBGROUPS[key] = mine
    return mine


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              device: Optional[str] = None) -> Mesh:
    """The mesh of this process group: ``shape`` (data, model) defaults to
    (world size, 1).  data * model must equal the world size (one process
    a card); else ``ValueError`` says how many processes to launch.  With
    a model axis above 1 the data and model groups are made here:
    collective, every rank calls it with the same shape.  ``device``
    defaults to the rank's device under a group, else the current card;
    without a group and a card it must be given ("cpu"), as an engine's
    (``models/base.py::resolve_device``)."""
    rank, size = world()
    if shape is None:
        shape = (size, 1)
    d, m = int(shape[0]), int(shape[1])
    if d < 1 or m < 1:
        raise ValueError(f"mesh {d},{m}: both axes must be positive")
    if d * m != size:
        raise ValueError(
            f"mesh {d},{m} asks for {d * m} ranks ({d} data x {m} model "
            f"shards), but this run has {size} process(es): pylda_tpu_torch "
            f"runs one process a card, so {_launch_hint(d * m)}"
        )
    groups = _GROUPS or (None, None, None, None)
    if device is None:
        device = groups[3]
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to make a "
                "mesh on the CPU")
        device = f"cuda:{torch.cuda.current_device()}"
    sub = _make_subgroups(d, m) if m > 1 and _GROUPS is not None else None
    return Mesh(data=d, model=m, rank=rank, device=torch.device(device),
                device_group=groups[0], host_group=groups[1],
                backend=groups[2], subgroups=sub)


def validate_process_aligned(mesh: Mesh) -> None:
    """Rank r holds the contiguous document block d = r // model, so the
    mesh must cover the world: data * model ranks, this process's rank
    (``make_mesh`` checks both; this re-checks a mesh built by hand)."""
    rank, size = world()
    if mesh.data * mesh.model != size:
        raise ValueError(
            f"mesh {mesh.data},{mesh.model} needs {mesh.data * mesh.model} "
            f"ranks but this process group has {size}: "
            f"{_launch_hint(mesh.data * mesh.model)}"
        )
    if mesh.rank != rank:
        raise ValueError(
            f"mesh at rank {mesh.rank} does not match this process group "
            f"({size} processes, rank {rank})"
        )


# -- collectives -----------------------------------------------------------


def all_reduce_sum(tensor: torch.Tensor, mesh: Optional[Mesh],
                   group: str = "world") -> torch.Tensor:
    """Sum ``tensor`` in place over ``group`` of the mesh ("world",
    "data" or "model", ``Mesh.group``) on its device group and return it;
    without a group, ``tensor`` as it is."""
    if mesh is None or not mesh.grouped:
        return tensor
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=mesh.group(group))
    COLLECTIVES["all_reduce"] += 1
    return tensor


def all_gather_blocks(local: torch.Tensor, total: int, mesh: Mesh,
                      dim: int = 0, contiguous: bool = False
                      ) -> torch.Tensor:
    """The whole tensor of which each rank of the model group holds the
    block ``block_bounds(total, m, M)`` along ``dim`` (in model order):
    one all-gather over the model group's device group, of the blocks
    moved to the front and padded to the ceil block size, into one
    buffer's M contiguous parts (``all_gather`` into views, which gloo
    takes for CUDA tensors too).
    Along dim 1 the result is a transposed view of the gathered [total,
    rows] tensor, or with ``contiguous`` a copy in row-major order (the
    layout of a tensor that was never split, so reductions over it run
    in the one-process order).  Collective over the model group."""
    M = mesh.model
    per = -(-total // M)
    front = local if dim == 0 else local.movedim(dim, 0)
    send = front.new_zeros((per,) + tuple(front.shape[1:]))
    send[: front.shape[0]].copy_(front)
    out = front.new_empty((M * per,) + tuple(front.shape[1:]))
    dist.all_gather(list(out.chunk(M)), send, group=mesh.group("model"))
    COLLECTIVES["all_gather"] += 1
    # Every block before the last non-empty one is whole (ceil blocks), so
    # the padding sits past ``total``.
    out = out[:total]
    if dim != 0:
        out = out.movedim(0, dim)
    return out.contiguous() if contiguous else out


def _host_group(mesh: Optional[Mesh], group: str = "world"):
    if mesh is not None:
        return mesh.group(group, host=True)
    return None if _GROUPS is None else _GROUPS[1]


def allgather_object(obj: Any, mesh: Optional[Mesh] = None,
                     group: str = "world") -> List[Any]:
    """Every rank's picklable ``obj`` in rank order, over the host group
    of ``group`` (``Mesh.group``); a list of one without a group."""
    g = _host_group(mesh, group)
    if g is None:
        return [obj]
    out: List[Any] = [None] * dist.get_world_size(g)
    dist.all_gather_object(out, obj, group=g)
    COLLECTIVES["all_gather"] += 1
    return out


def allgather_numpy(x: Any, mesh: Optional[Mesh] = None,
                    group: str = "world") -> List[np.ndarray]:
    """Every rank's ``x`` as a numpy array, in rank order, over the host
    group of ``group`` (``multihost_utils.process_allgather``'s
    counterpart; shapes may differ between ranks)."""
    return allgather_object(np.asarray(x), mesh, group)


def broadcast_object(obj: Any, mesh: Optional[Mesh] = None) -> Any:
    """Rank 0's ``obj`` on every rank (over the host group)."""
    group = _host_group(mesh)
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=group)
    COLLECTIVES["broadcast"] += 1
    return box[0]


def host_gather(x: Any, mesh: Optional[Mesh] = None) -> np.ndarray:
    """This rank's rows of a document-sharded array concatenated with
    every other data coordinate's, in order, on the host (a tensor or an
    array), over the data group; the array itself without a group or with
    one data coordinate."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if mesh is None or mesh.data == 1:
        return np.asarray(x)
    return np.concatenate(allgather_numpy(x, mesh, "data"), axis=0)


# -- process-local input ----------------------------------------------------


def block_bounds(total: int, index: int, count: int) -> Tuple[int, int]:
    """[lo, hi) of block ``index`` of ``count`` over ``total`` documents:
    the loader's ceil block size, the last blocks short or empty.  Raises
    ``ValueError`` for an index outside 0..count-1."""
    if not 0 <= index < count:
        raise ValueError(f"process index {index} is outside 0..{count - 1}")
    per = -(-total // count)
    lo = min(index * per, total)
    return lo, min(lo + per, total)


def _rebase(doc_ids: np.ndarray, offset: int) -> np.ndarray:
    return np.where(doc_ids >= 0, doc_ids + offset, -1).astype(np.int32)


def lift_process_local_batch(batch, mesh: Mesh, global_doc_offset: int = 0):
    """This rank's dense batch of its document block with doc ids re-based
    to global indices.  Each rank keeps its own rows (no global array is
    built); the rows-per-rank count must agree across ranks, as JAX's
    ``make_array_from_process_local_data`` requires, and is checked over
    the host group."""
    validate_process_aligned(mesh)
    rows = [int(r) for r in allgather_numpy(batch.mask.shape[0], mesh,
                                            "data")]
    if len(set(rows)) != 1:
        raise ValueError(f"process-local batches differ in rows: {rows}")
    return dataclasses.replace(
        batch, doc_ids=_rebase(np.asarray(batch.doc_ids), global_doc_offset))


def _width_of(b) -> int:
    for f in dataclasses.fields(b):
        v = getattr(b, f.name)
        if np.ndim(v) == 2:
            return v.shape[1]
    raise TypeError(f"no 2-D field on {type(b).__name__}")


def pad_buckets_to(local_buckets: Sequence, widths: Sequence[int],
                   rows_by_width: Sequence[int], doc_pad_multiple: int,
                   global_doc_offset: int) -> list:
    """Each width's bucket padded to ``rows_by_width`` rounded up to
    ``doc_pad_multiple`` (widths of no rows dropped), with inert padding
    rows (zero counts and mask, doc id -1) and doc ids re-based by
    ``global_doc_offset``: the numpy part of
    ``lift_process_local_buckets``, on any bucket dataclass whose 2-D
    fields are [rows, width]."""
    local = {_width_of(b): b for b in local_buckets}
    out = []
    for w, rows in zip(widths, rows_by_width):
        if rows == 0:
            continue
        rows = -(-int(rows) // doc_pad_multiple) * doc_pad_multiple
        b = local.get(w)
        tmpl = b if b is not None else local_buckets[0]
        fields = {}
        for f in dataclasses.fields(tmpl):
            src = np.asarray(getattr(tmpl, f.name))
            shape = (rows,) + ((w,) if src.ndim == 2 else ())
            arr = (np.full(shape, -1, dtype=src.dtype) if f.name == "doc_ids"
                   else np.zeros(shape, dtype=src.dtype))
            if b is not None:
                n = src.shape[0]
                arr[:n] = (_rebase(src, global_doc_offset)
                           if f.name == "doc_ids" else src)
            fields[f.name] = arr
        out.append(type(tmpl)(**fields))
    return out


def lift_process_local_buckets(local_buckets: Sequence, bucket_sizes,
                               doc_pad_multiple: int, mesh: Mesh,
                               global_doc_offset: int) -> list:
    """Uniform bucket geometry across ranks: all-gather the rows-a-width
    histogram over the host group, take the elementwise max, and pad this
    rank's buckets to it with inert rows, doc ids re-based to global
    (``pad_buckets_to``).  Each rank keeps its own padded rows.
    ``local_buckets`` must be built unpadded (doc_pad_multiple=1).
    Collective: call from every rank."""
    validate_process_aligned(mesh)
    widths = sorted(set(int(s) for s in bucket_sizes))
    local = {_width_of(b): b for b in local_buckets}
    hist = np.asarray([local[w].mask.shape[0] if w in local else 0
                       for w in widths], dtype=np.int64)
    max_rows = np.stack(allgather_numpy(hist, mesh, "data")).max(axis=0)
    if not local_buckets:
        raise ValueError("a rank with no documents has no bucket template")
    return pad_buckets_to(local_buckets, widths, max_rows, doc_pad_multiple,
                          global_doc_offset)


def negotiate_svi_ragged_geometry(corpus, config, b_local: int,
                                  mesh: Mesh) -> Optional[dict]:
    """SVI's fixed bucket geometry for process-local ragged corpora (the
    JAX function's protocol): widths from the all-gathered SUM of the
    data coordinates' aligned-width histograms (over the data group: the
    ranks of a model group hold one block) under ``bucket_policy="auto"`` (with
    the default ``bucket_sizes``; else the configured widths), capacities
    from the elementwise MAX of each rank's expected rows a minibatch
    (``local_hist[w] * b_local / local_docs``) through the shared +4-sigma
    formula.  Returns {width: capacity}, or None when the corpus has no
    per-document unique counts.  Collective: call from every rank."""
    from pylda_tpu_torch.models import layouts
    from pylda_tpu_torch.utils.config import LDAConfig

    pad = config.doc_pad_multiple
    uc = layouts.unique_counts_of(corpus)
    if uc is None:
        return None
    fixed = tuple(config.bucket_sizes)
    cap = max(fixed)
    P = mesh.data
    use_auto = (
        config.bucket_policy == "auto"
        and fixed == LDAConfig.__dataclass_fields__["bucket_sizes"].default
    )
    if use_auto:
        align = 16
        local_vec = layouts.aligned_width_histogram(uc, align=align, cap=cap)
        global_vec = np.stack(allgather_numpy(local_vec, mesh,
                                              "data")).sum(axis=0)
        width_rows = {align * (i + 1): int(r)
                      for i, r in enumerate(global_vec) if r > 0}
        f_global = min(1.0, (b_local * P) / max(1, corpus.global_num_docs))
        sizes = layouts.plan_bucket_sizes(
            [], cap=cap, row_pad=pad, minibatch_fraction=f_global,
            width_rows=width_rows,
        )
    else:
        sizes = fixed
    sizes = sorted(int(s) for s in sizes)
    hist_local = corpus.ragged_row_histogram(sizes)
    f_local = min(1.0, b_local / corpus.num_docs) if corpus.num_docs else 0.0
    e_local = np.asarray([hist_local[s] * f_local for s in sizes],
                         dtype=np.float64)
    e_max = np.stack(allgather_numpy(e_local, mesh, "data")).max(axis=0)
    return layouts.svi_capacities_from_expected(
        sizes, dict(zip(sizes, e_max)), pad)


# -- replica consistency --------------------------------------------------------


def _tensors_of(state) -> Dict[str, torch.Tensor]:
    if isinstance(state, dict):
        return dict(state)
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


def replica_checksums(state, mesh: Optional[Mesh] = None
                      ) -> Dict[str, List[float]]:
    """{field: [each rank's float64 sum]}, in rank order, of every tensor
    of ``state`` (an ``LDAState``, or a dict of tensors such as n_kv),
    over the host group: after each all-reduced step, a replicated tensor
    must be the same bits on every rank, and a lambda block on every rank
    of its data group."""
    sums = np.asarray([
        float(t.detach().double().sum().cpu())
        for t in _tensors_of(state).values()
    ], dtype=np.float64)
    per_rank = np.stack(allgather_numpy(sums, mesh))
    return {name: [float(x) for x in per_rank[:, i]]
            for i, name in enumerate(_tensors_of(state))}


def assert_replicas_consistent(state, mesh: Optional[Mesh] = None,
                               sharded: Sequence[str] = (),
                               full_shape: Optional[Tuple[int, int]] = None
                               ) -> None:
    """Raise ``AssertionError`` if a tensor differs where it must agree:
    the fields named in ``sharded`` (lambda under ``--shard_vocab`` /
    ``--shard_topics``) across each data group, every other field across
    all ranks.  With ``full_shape`` the model group's blocks of the first
    sharded field must also tile it (``assert_shards_tile``).
    Collective: call from every rank."""
    M = 1 if mesh is None else mesh.model
    for name, sums in replica_checksums(state, mesh).items():
        groups = ([sums[m::M] for m in range(M)] if name in sharded
                  else [sums])
        for g in groups:
            if len(set(g)) > 1:
                raise AssertionError(
                    f"replica divergence in state.{name}: {sums}")
    if full_shape is not None and sharded:
        assert_shards_tile(_tensors_of(state)[sharded[0]].shape, full_shape,
                           mesh)


def assert_shards_tile(shape, full_shape: Tuple[int, int],
                       mesh: Optional[Mesh]) -> None:
    """Raise ``AssertionError`` unless the model group's blocks (each
    rank's ``shape``, gathered in model order over the host group) tile
    ``full_shape``: all whole along one axis, their lengths along the
    other the ``block_bounds`` blocks summing to it.  Collective."""
    if mesh is not None and mesh.grouped and mesh.model > 1:
        shapes = [tuple(int(x) for x in s) for s in
                  allgather_numpy(np.asarray(shape), mesh, "model")]
    else:
        shapes = [tuple(int(x) for x in shape)]
    M = len(shapes)
    for axis in (0, 1):
        other = 1 - axis
        want = [hi - lo for lo, hi in (block_bounds(full_shape[axis], m, M)
                                       for m in range(M))]
        if (all(s[other] == full_shape[other] for s in shapes)
                and [s[axis] for s in shapes] == want):
            return
    raise AssertionError(f"lambda blocks {shapes} do not tile {full_shape}")
