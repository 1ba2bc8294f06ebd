"""Host side of the row-resident gamma fixed point (``csrc/row_fixed_point.cuh``),
shared by the wrappers of its two kernels, ``ops/ragged.py::ragged_gamma``
and ``ops/dense_estep.py::dense_estep``.

Both C entries take the same two arguments, a pointer to the core's
``Params`` struct (mirrored here field for field) and a CUDA stream::

    int pylda_ragged_gamma(void* params, void* stream);
    int pylda_dense_gamma(void* params, void* stream);

``launch`` allocates the scratch the kernel needs, fills a ``Params``,
makes the call and returns the output gamma and sweep counts.  The
launcher writes the geometry it chose back into the ``Params``
(``GEOMETRY``).  Both kernels take any K: up to ``RESIDENT_TOPICS`` the
row-resident kernels of ``csrc/row_fixed_point.cuh`` run, above it the
cluster kernel of ``csrc/row_fixed_point_tiled.cuh``, which sweeps a row
with a cluster of CTAs that split its topics, each keeping its slice of
the row's state in shared memory and its slice of the row's B rows
resident or streamed through a ring; ``cluster_plan`` sizes it (cluster
width, slice, resident entries, window).  Past ``MAX_TOPICS`` a slice no
longer fits a CTA, and the plan is direct: the slices' state in a device
scratch and B read from the table.  A launch's rows may fall into
segments, each a batch that ends at its own exit sweep (``segments``).
Each is built in two modes (``ops/_build.py``): float32, and the bf16
operand mode, whose entry takes a bf16 gather table
(``gather_table(.., "bfloat16")``) and rounds expEtheta and the ratio as
the reference does.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

from pylda_tpu_torch.ops import _build
from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation
from pylda_tpu_torch.ops.estep import check_compute_dtype

# The blocks of one streamed row's scratch list an SM needs: a row longer
# than the slot buffer implies a ~72 KB buffer, so 3 blocks an SM (at
# K > 256, 2 or 1).
LIST_BLOCKS_PER_SM = 3
# Largest K of the row-resident kernels (kMaxTopics of the core: its wide
# kernels keep up to 4 float4 sums a thread); above it the cluster kernel
# runs.
RESIDENT_TOPICS = 4096
# The cluster kernel: threads a CTA (kThreads), float4 step-B sums a thread
# (kClusterQ), so a slice in shared memory of at most SLICE_TOPICS topics;
# clusters of at most MAX_CLUSTER CTAs (kMaxCluster); per-sweep histogram
# entries kept in shared memory (kMaxHist).  Past MAX_TOPICS the plan is
# direct, with entries a window of DIRECT_WINDOW.
THREADS = 256
CLUSTER_Q = 4
SLICE_TOPICS = THREADS * 4 * CLUSTER_Q
MAX_CLUSTER = 16
MAX_HIST = 256
MAX_TOPICS = MAX_CLUSTER * SLICE_TOPICS
DIRECT_WINDOW = 64
# The cluster width the plan takes: 8 CTAs (15 clusters in flight on an
# H100), or MAX_CLUSTER where a whole row then stays resident; chosen from
# their times at config 5's bucket (scripts/torch_cluster_width.py,
# PERF.md section 6).
CLUSTER = 8
# Shared memory a CTA of the cluster kernel aims at (one CTA an SM: its
# registers allow no second), and the bytes a streamed window aims at
# (fewer, larger windows: each costs an exchange across the cluster).
CLUSTER_SMEM_BUDGET = 200 * 1024
WINDOW_BYTES = 64 * 1024
# The launch geometry the launcher writes back: live entries the slot
# buffer holds (a row with more streams; 0 in the cluster kernel), shared
# memory a block, blocks an SM, the grid, the topics a CTA's sweep covers
# (K, or the cluster kernel's slice), and in the cluster kernel the
# cluster width, resident entries, window, windows a sweep of the widest
# row and clusters in flight.
GEOMETRY = ("nmax", "smem_bytes", "blocks_per_sm", "grid", "tile",
            "cluster", "resident", "window", "windows", "clusters")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class Params(ctypes.Structure):
    """``struct Params`` of ``csrc/row_fixed_point.cuh``; the launcher sets
    ``nmax``, ``nhist`` and the launch geometry."""

    _fields_ = [
        ("ids", _P), ("cnts", _P), ("table", _P), ("alpha", _P),
        ("gamma0", _P), ("et0", _P), ("gamma", _P), ("not_exitable", _P),
        ("queues", _P), ("row_run", _P), ("row_nnz", _P),
        ("sweeps_out", _P), ("row_sweeps", _P), ("row_exit", _P),
        ("slots_out", _P), ("extra_out", _P), ("lists", _P), ("seg", _P),
        ("state", _P),
        ("D", _I), ("ld", _I), ("L", _I), ("K", _I), ("ldb", _I),
        ("cnts_bf16", _I), ("table_bf16", _I), ("list_blocks", _I),
        ("nmax", _I), ("nhist", _I),
        ("inner_iterations", _I), ("threshold", _F), ("eps", _F),
        ("patience", _I), ("use_stall", _I), ("nseg", _I),
        ("cluster", _I), ("slice", _I), ("resident", _I), ("window", _I),
        ("state_ctas", _I),
        ("smem_bytes", _I), ("blocks_per_sm", _I), ("grid", _I),
        ("tile", _I), ("windows", _I), ("clusters", _I),
    ]


def bind(lib: ctypes.CDLL, name: str) -> Callable:
    """The C entry ``name`` of ``lib`` with its argument types set."""
    fn = getattr(lib, name)
    fn.argtypes = [_P, _P]
    fn.restype = _I
    return fn


_ENTRIES = {}


def entry(source: str, compute_dtype: str = "float32") -> Callable:
    """The bound entry ``pylda_<source>`` of ``csrc/<source>.cu`` built in
    the ``compute_dtype`` mode."""
    fn = _ENTRIES.get((source, compute_dtype))
    if fn is None:
        fn = _ENTRIES[(source, compute_dtype)] = bind(
            _build.library(source, compute_dtype), f"pylda_{source}")
    return fn


def tiled(K: int) -> bool:
    """True where the cluster kernel runs (K > RESIDENT_TOPICS)."""
    return K > RESIDENT_TOPICS


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def cluster_state_bytes(slice_: int, bf16: bool, direct: bool) -> int:
    """Bytes of a CTA's slice state in the cluster kernel (``ClusterLayout``
    of ``csrc/row_fixed_point_tiled.cuh``): its expEtheta, rounded copy
    (bf16), gamma and step-B group sums (one group in a direct plan); in
    shared memory, or in a direct plan in the device scratch."""
    groups = (THREADS // (slice_ // 4)
              if slice_ // 4 < THREADS and not direct else 1)
    return 4 * slice_ * ((3 if bf16 else 2) + groups)


def cluster_smem_bytes(slice_: int, resident: int, window: int, nhist: int,
                       bf16: bool, cluster: int, direct: bool = False) -> int:
    """Shared memory of a CTA of the cluster kernel (``ClusterLayout``):
    the slice state (``cluster_state_bytes``; not in a direct plan); the
    window's ratios; the two exchange arrays of the ranks' partial
    phinorms ([cluster, wmax] each) and of their (|dgamma|, gamma')
    pairs; the histogram; 208 bytes of scan, block sums, flags, row slots
    and mbarriers; the resident tile and the ring of two windows (not in
    a direct plan)."""
    wmax = _up(max(resident, window), 4)
    stride = slice_ * (2 if bf16 else 4)
    return ((0 if direct else cluster_state_bytes(slice_, bf16, False))
            + 4 * wmax + 8 * cluster * wmax + 16 * cluster
            + 4 * _up(nhist, 4) + 32 + 64 + 16 + 32 + 64
            + (0 if direct else (resident + 2 * window) * stride))


def entry_lanes(units16: int) -> int:
    """Lanes that sum one entry's partial phinorm in the cluster kernel
    (``entry_lanes`` of the header), for a slice of ``units16`` 16-byte
    units: the power of two that gives each lane about eight units, at
    most 32."""
    lanes = 1
    while lanes < 32 and lanes * 8 < units16:
        lanes *= 2
    return lanes


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """The cluster kernel's geometry for rows of up to L live entries."""

    cluster: int  # CTAs a cluster
    slice: int  # topics a CTA owns (the last CTA's may be short or empty)
    resident: int  # entries of a row kept in shared memory for all sweeps
    window: int  # entries a streamed window (0: every row is resident)
    windows: int  # windows a sweep of a row of L live entries
    smem_bytes: int  # shared memory a CTA
    # The slices' state in a device scratch and B read from the table,
    # not staged (resident 0): K past MAX_TOPICS.
    direct: bool = False


def cluster_plan(K: int, L: int, compute_dtype: str = "float32",
                 inner_iterations: int = 50,
                 cluster: Optional[int] = None) -> ClusterPlan:
    """The cluster kernel's plan for K > RESIDENT_TOPICS and rows of up to
    L live entries: C = ``cluster`` CTAs a row (by default MAX_CLUSTER
    where every entry of a row then stays resident, else ``CLUSTER``); the
    slice K / C rounded up to the 16-byte unit (4 float32 or 8 bf16
    topics); every entry resident when the whole row fits
    ``CLUSTER_SMEM_BUDGET`` bytes a CTA, else a ring of two windows of
    ``WINDOW_BYTES`` / an entry's slice entries (4 to 64, fewer where the
    ring would not fit) and as many resident entries as the budget
    leaves.  A slice past SLICE_TOPICS (K > MAX_TOPICS at MAX_CLUSTER)
    makes the plan direct: windows of DIRECT_WINDOW entries, none
    resident.  Raises on a cluster width the kernel does not take."""
    if cluster is None:
        if K <= MAX_TOPICS:
            wide = cluster_plan(K, L, compute_dtype, inner_iterations,
                                MAX_CLUSTER)
            if wide.window == 0:
                return wide
        cluster = CLUSTER if K <= CLUSTER * SLICE_TOPICS else MAX_CLUSTER
    C = int(cluster)
    if not 1 <= C <= MAX_CLUSTER:
        raise ValueError(f"cluster must be 1..{MAX_CLUSTER}, got {C}")
    bf16 = check_compute_dtype(compute_dtype)
    unit, elem = (8, 2) if bf16 else (4, 4)
    slice_ = _up(-(-K // C), unit)
    nhist = min(inner_iterations, MAX_HIST)
    stride = slice_ * elem
    if slice_ > SLICE_TOPICS:
        window = min(max(L, 1), DIRECT_WINDOW)
        return ClusterPlan(C, slice_, 0, window, -(-L // window),
                           cluster_smem_bytes(slice_, 0, window, nhist, bf16,
                                              C, direct=True),
                           direct=True)

    def size(r, w):
        return cluster_smem_bytes(slice_, r, w, nhist, bf16, C)

    budget = CLUSTER_SMEM_BUDGET
    if size(L, 0) <= budget:
        resident, window = L, 0
    else:
        window = min(L, max(4, min(64, WINDOW_BYTES // stride)))
        while window > 1 and size(0, window) > budget:
            window -= 1
        resident = min(L - 1, max(0, (budget - size(0, window)) // stride))
        while resident > 0 and size(resident, window) > budget:
            resident -= 1
        if size(resident, window) > budget:
            raise ValueError(f"K = {K}: the slice's state and two windows "
                             "exceed a CTA's shared memory")
    nr = min(L, resident)
    windows = int(nr > 0) + (-(-(L - nr) // window) if L > nr else 0)
    return ClusterPlan(C, slice_, resident, window, windows,
                       size(resident, window))


def segment_rows(segments: Sequence[int], dev) -> torch.Tensor:
    """[sum(segments)] int32 on dev: each row's segment, rows in order.
    The engines build it once a bucket and pass it to ``launch``."""
    counts = [int(n) for n in segments]
    if not counts or min(counts) < 1:
        raise ValueError("segments must be positive row counts")
    return torch.repeat_interleave(
        torch.arange(len(counts), dtype=torch.int32),
        torch.tensor(counts)).to(dev)


def table_width(K: int, compute_dtype: str = "float32") -> int:
    """ldb of the gather table: K rounded up to 4 (float32) or 8 (bf16),
    so each row is whole 16-byte copies."""
    unit = 8 if check_compute_dtype(compute_dtype) else 4
    return -(-K // unit) * unit


def gather_table(exp_elog_beta: torch.Tensor,
                 compute_dtype: str = "float32") -> torch.Tensor:
    """expElogbeta^T as the kernels gather it: [V, ldb] with ldb =
    ``table_width(K, compute_dtype)`` (zero columns past K), in float32,
    or in bf16 (each value rounded to nearest even) for the bf16 operand
    mode, built from expElogbeta in one pass.  Callers running several
    buckets against one expElogbeta build it once and pass it as
    ``eeb_t``."""
    K, V = exp_elog_beta.shape
    ldb = table_width(K, compute_dtype)
    dtype = (torch.bfloat16 if compute_dtype == "bfloat16"
             else exp_elog_beta.dtype)
    if ldb == K and dtype == exp_elog_beta.dtype:
        return exp_elog_beta.T.contiguous()
    table = exp_elog_beta.new_empty((V, ldb), dtype=dtype)
    table[:, :K].copy_(exp_elog_beta.T)
    table[:, K:].zero_()
    return table


def check_out(t: Optional[torch.Tensor], dtype, shape, dev, name: str):
    """Raises unless an optional output is None or a contiguous tensor of
    this dtype and shape on dev."""
    if t is not None and (t.dtype != dtype or tuple(t.shape) != shape
                          or t.device != dev or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {shape} on the device")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def launch(
    kernel: Callable,
    ids: Optional[torch.Tensor],  # [D, ld] int32, or None: id = column
    cnts: torch.Tensor,  # [D, ld] f32 or bf16
    length: int,  # entries of a row used: its first `length` columns
    table: torch.Tensor,  # gather_table(expElogbeta, mode) [V, ldb]
    alpha: torch.Tensor,  # [K] f32
    gamma_init: torch.Tensor,  # [D, K] f32
    inner_iterations: int,
    convergence_threshold: float,
    eps: float,
    stall_patience: int,
    row_sweeps_out: Optional[torch.Tensor] = None,
    row_exit_out: Optional[torch.Tensor] = None,
    slots_out: Optional[torch.Tensor] = None,
    extra_sweeps_out: Optional[torch.Tensor] = None,
    geometry_out: Optional[dict] = None,
    segments: Optional[Sequence[int]] = None,
    plan: Optional[ClusterPlan] = None,
    seg_rows: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of a gamma kernel (``kernel``, a bound entry; the
    cluster kernel above ``RESIDENT_TOPICS``, with ``plan`` or else
    ``cluster_plan``'s for rows of ``length`` entries) on checked CUDA
    inputs: (gamma [D, K],
    sweeps: 0-d int32, or [len(segments)] int32, each segment's own, when
    ``segments`` splits the rows into consecutive segments; ``seg_rows``,
    their ``segment_rows`` on the device, is built here when not passed).
    Checks the optional outputs; ``geometry_out`` gets the ``GEOMETRY``
    the launcher chose.  Raises if the launch fails."""
    D, K = gamma_init.shape
    dev = gamma_init.device
    seg = None
    if segments is not None:
        seg = segment_rows(segments, dev) if seg_rows is None else seg_rows
        if sum(segments) != D or seg.numel() != D:
            raise ValueError(f"segments cover {sum(segments)} rows, not {D}")
    nseg = 1 if segments is None else len(segments)
    check_out(row_sweeps_out, torch.int32, (D,), dev, "row_sweeps_out")
    check_out(row_exit_out, torch.int32, (D,), dev, "row_exit_out")
    check_out(slots_out, torch.int64, (1,), dev, "slots_out")
    check_out(extra_sweeps_out, torch.int64, (1,), dev, "extra_sweeps_out")
    cnts = cnts.contiguous()
    ids = None if ids is None else ids.contiguous()
    alpha = alpha.contiguous()
    gamma0 = gamma_init.contiguous()
    # The first expEtheta uses the exact digamma, as the JAX loop does.
    et0 = exp_dirichlet_expectation(gamma0).contiguous()
    gamma = torch.empty_like(gamma0)
    not_exitable = torch.zeros((nseg * inner_iterations,),
                               dtype=torch.int32, device=dev)
    queues = torch.zeros((2,), dtype=torch.int32, device=dev)
    rows = torch.empty((2, D), dtype=torch.int32, device=dev)
    sweeps = torch.empty((nseg,), dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    list_blocks = min(D, LIST_BLOCKS_PER_SM * sms)
    lists = torch.empty((list_blocks, 2, max(length, 1)), dtype=torch.int32,
                        device=dev)
    bf16 = table.dtype == torch.bfloat16
    if tiled(K) and plan is None:
        plan = cluster_plan(K, length, "bfloat16" if bf16 else "float32",
                            inner_iterations)
    # A direct plan's slice states in device memory: room for a CTA an SM
    # (the launcher runs at most state_ctas CTAs).
    state = (torch.empty((sms * cluster_state_bytes(plan.slice, bf16, True)
                          // 4,), dtype=torch.float32, device=dev)
             if tiled(K) and plan.direct else None)
    p = Params(
        ids=_ptr(ids), cnts=cnts.data_ptr(), table=table.data_ptr(),
        alpha=alpha.data_ptr(), gamma0=gamma0.data_ptr(),
        et0=et0.data_ptr(), gamma=gamma.data_ptr(),
        not_exitable=not_exitable.data_ptr(), queues=queues.data_ptr(),
        row_run=rows[0].data_ptr(), row_nnz=rows[1].data_ptr(),
        sweeps_out=sweeps.data_ptr(), row_sweeps=_ptr(row_sweeps_out),
        row_exit=_ptr(row_exit_out), slots_out=_ptr(slots_out),
        extra_out=_ptr(extra_sweeps_out), lists=lists.data_ptr(),
        seg=_ptr(seg), state=_ptr(state),
        D=D, ld=cnts.shape[1], L=length, K=K, ldb=table.shape[1],
        cnts_bf16=int(cnts.dtype == torch.bfloat16),
        table_bf16=int(bf16), list_blocks=list_blocks,
        inner_iterations=int(inner_iterations),
        threshold=float(convergence_threshold), eps=float(eps),
        patience=int(stall_patience),
        use_stall=int(stall_patience > 0 and convergence_threshold > 0.0),
        nseg=nseg,
    )
    if tiled(K):
        p.cluster, p.slice = plan.cluster, plan.slice
        p.resident, p.window = plan.resident, plan.window
        p.state_ctas = 0 if state is None else sms
    # The scratch tensors may be freed once the launch is enqueued: the
    # caching allocator hands their memory out again only in stream order.
    with torch.cuda.device(dev):
        rc = kernel(ctypes.byref(p), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel.__name__} launch failed: cudaError {rc}")
    if geometry_out is not None:
        geometry_out.update({f: getattr(p, f) for f in GEOMETRY})
    return gamma, sweeps if segments is not None else sweeps.reshape(())
