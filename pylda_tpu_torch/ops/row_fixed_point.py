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
(``GEOMETRY``).  Both kernels take any K.  Up to ``RESIDENT_TOPICS``
``gamma_plan`` picks per launch, from the launch's widest row (a ragged
bucket's width, a dense batch's largest row nnz): the row-resident kernels
of ``csrc/row_fixed_point.cuh`` where it fits one block's slot buffer
(``slot_buffer``, the launcher's sizing), else the entry kernel of
``csrc/row_fixed_point_entries.cuh`` (a cluster of CTAs a row, each
holding a share of the row's entries for all sweeps), else (16 CTAs cannot
hold it, or the gather table fits half the L2) the row-resident kernels
with its long rows streamed.  In the bf16 operand mode at K <=
``GROUP_MAX_TOPICS`` a launch whose widest row fits a warp group's slots
(``group_capacity``) takes the warp-group kernel of
``csrc/row_fixed_point_groups.cuh`` instead (two groups of four warps a
CTA, a row a group, both products of a sweep on ``mma.sync``).
Above ``RESIDENT_TOPICS`` the cluster kernel of
``csrc/row_fixed_point_tiled.cuh`` runs, which sweeps a row
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
from typing import Callable, Optional, Sequence, Tuple, Union

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
# The row-resident launcher's slot buffer (launch_row_fixed_point): at
# K <= THREADS ~BLOCK_SMEM_TARGET bytes a block (at least 16 entries); above
# it half an SM's shared memory less the BLOCK_SMEM_RESERVED bytes the card
# keeps a block, or where a slot does not fit that, all a block may opt
# into.  An H100's shared memory an SM and a block's opt-in limit (what the
# launcher reads from the device), the defaults of the CPU's plans.
BLOCK_SMEM_TARGET = 72 * 1024
BLOCK_SMEM_RESERVED = 1024
H100_SMEM_PER_SM = 233472
H100_SMEM_OPTIN = 232448
# An H100's L2 (bytes).  A launch whose gather table fits half of it keeps
# the row-resident kernels: their streamed windows re-gather from the L2,
# which beat the entry kernel there (PERF.md).
H100_L2_BYTES = 50 * 1024 * 1024
# Slots a batch of the entry kernel's step A sums at once (kDotSlots).
DOT_SLOTS = 128
# The bf16 warp-group kernel (``csrc/row_fixed_point_groups.cuh``): warps
# a group (a row, kGroupWarps), groups a CTA (kGroups), its largest K
# (kGroupMaxTopics) and most live entries a group (kGroupMaxSlots), in
# tiles of 16.
GROUP_WARPS = 4
GROUPS = 2
GROUP_MAX_TOPICS = 256
GROUP_MAX_SLOTS = 192
# The launch geometry the launcher writes back: live entries the slot
# buffer holds (a row with more streams; 0 in the cluster kernels), shared
# memory a block, blocks an SM, the grid, the topics a CTA's sweep covers
# (K, or the cluster kernel's slice), and in the cluster kernels the
# cluster width, resident entries (the entry kernel: entries a CTA holds),
# window, windows a sweep of the widest row and clusters in flight.
# ``launch`` adds the route its plan took (``GammaPlan.route``).
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
        ("state_ctas", _I), ("group_slots", _I),
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


def _trunc_div(a: int, b: int) -> int:
    """a / b rounded toward zero, as C's integer division."""
    return -((-a) // b) if a < 0 else a // b


def layout_floats(K: int, nmax: int, nhist: int, wide: bool,
                  bf16: bool) -> Tuple[int, int]:
    """(floats a slot, floats of a block's shared memory) of the core's
    ``Layout`` (``csrc/row_fixed_point.cuh``) for a buffer of nmax slots."""
    k4, k8 = -(-K // 4), -(-K // 8)
    s4, s8 = k4 | 1, k8 | 1
    slot = s8 * 4 if bf16 else s4 * 4
    groups = THREADS // k4 if k4 < THREADS else 1
    n4 = _up(nmax, 4)
    part = (nmax * slot + s4 * 4 + (k8 * 8 if bf16 else 0)
            + (s4 * 4 if wide else 0))
    hist = part + groups * k4 * 4 + 3 * n4
    warps = THREADS // 32
    return slot, hist + _up(nhist, 4) + warps + 2 * warps + 4


def slot_buffer(K: int, compute_dtype: str = "float32",
                inner_iterations: int = 50,
                sm_bytes: int = H100_SMEM_PER_SM,
                optin: int = H100_SMEM_OPTIN) -> int:
    """The live entries one block's slot buffer holds in the row-resident
    kernels (the launcher's nmax before it is cut to the launch's row
    width): a row with more streams."""
    bf16 = check_compute_dtype(compute_dtype)
    wide = K > THREADS
    nhist = min(inner_iterations, MAX_HIST)
    slot, fixed = layout_floats(K, 0, nhist, wide, bf16)
    per_slot = 4 * (slot + 3)
    fixed_bytes = 4 * (fixed + 12)
    if not wide:
        return max(16, _trunc_div(BLOCK_SMEM_TARGET - fixed_bytes, per_slot))
    nmax = _trunc_div(sm_bytes // 2 - BLOCK_SMEM_RESERVED - fixed_bytes,
                      per_slot)
    if nmax < 1:
        nmax = _trunc_div(optin - fixed_bytes, per_slot)
    if nmax < 1:
        raise ValueError(f"K = {K}: no slot fits a block")
    return nmax


def entry_smem_bytes(K: int, share: int, slice_: int, cluster: int,
                     nhist: int, bf16: bool) -> int:
    """Shared memory of a CTA of the entry kernel (``EntryLayout`` of
    ``csrc/row_fixed_point_entries.cuh``): the wide ``Layout`` with a buffer
    of ``share`` slots, then the partials of the rank's slice from each
    rank, the ranks' (|dgamma|, gamma') pairs, step A's chunk sums
    ([warps][DOT_SLOTS]), the row slots and four mbarriers."""
    _, base = layout_floats(K, share, nhist, True, bf16)
    return 4 * (base + cluster * slice_ + _up(2 * cluster, 4)
                + THREADS // 32 * DOT_SLOTS + 16)


def group_layout_bytes(K: int, slots: int) -> int:
    """Shared memory of one warp group (``GroupLayout`` of
    ``csrc/row_fixed_point_groups.cuh``) at K topics and ``slots`` entries:
    a slot is 16 kt bf16 topics (kt = K / 16 rounded up) and one 16-byte
    pad; then the rounded expEtheta (16 kt bf16), the four warps' step-B
    partials (16 kt f32 each), the counts and ids, and 64 bytes of scan,
    sums and the row slot."""
    kt = -(-K // 16)
    return (slots * (2 * kt + 1) * 16 + kt * 32 + GROUP_WARPS * kt * 64
            + slots * 8 + GROUP_WARPS * 12 + 16)


def group_smem_bytes(K: int, slots: int) -> int:
    """Shared memory of a CTA of the warp-group kernel (GROUPS groups)."""
    return GROUPS * group_layout_bytes(K, slots)


def group_capacity(K: int, sm_bytes: int = H100_SMEM_PER_SM) -> int:
    """The most live entries a row of the warp-group kernel may have at K
    (0 above GROUP_MAX_TOPICS): the largest multiple of 16, at most
    GROUP_MAX_SLOTS, whose CTA takes at most half an SM's shared memory
    less the BLOCK_SMEM_RESERVED bytes the card keeps a block (two CTAs,
    four rows, an SM).  192 at K = 100 and 128, 112 at 200, 96 at 256."""
    if K > GROUP_MAX_TOPICS:
        return 0
    budget = sm_bytes // 2 - BLOCK_SMEM_RESERVED
    slots = GROUP_MAX_SLOTS
    while slots > 0 and group_smem_bytes(K, slots) > budget:
        slots -= 16
    return slots


@dataclasses.dataclass(frozen=True)
class GammaPlan:
    """A launch's plan at K <= RESIDENT_TOPICS for rows of up to
    ``widest`` live entries: the bf16 warp-group kernel ("groups"), the
    row-resident kernels with every row in one block's slot buffer
    ("rows"), the entry kernel ("entries"), or the row-resident kernels
    with the longer rows streamed ("stream").  ``launch`` reports the
    route, or "cluster" above RESIDENT_TOPICS."""

    route: str  # "groups", "rows", "entries" or "stream"
    nmax: int  # entries one block's slot buffer holds (slot_buffer)
    cluster: int = 0  # the entry kernel: CTAs a row
    share: int = 0  # entries a CTA holds (its slot buffer)
    slice: int = 0  # topics a rank owns in the exchange (a multiple of 4)
    smem_bytes: int = 0  # shared memory a CTA
    slots: int = 0  # the warp-group kernel: entries a group holds


def gamma_plan(K: int, widest: int, compute_dtype: str = "float32",
               inner_iterations: int = 50,
               sm_bytes: int = H100_SMEM_PER_SM,
               optin: int = H100_SMEM_OPTIN,
               cluster: Optional[int] = None, table_bytes: int = 0,
               l2_bytes: int = H100_L2_BYTES) -> GammaPlan:
    """The plan of a launch at K <= RESIDENT_TOPICS whose rows have at most
    ``widest`` live entries (a host-known bound: a ragged bucket's width,
    a dense batch's largest row nnz): in the bf16 mode at K <=
    GROUP_MAX_TOPICS "groups" where ``widest`` rounded up to 16 fits
    ``group_capacity`` (a group's slots); "rows" where it fits one block's
    slot buffer; "stream" where the gather table (``table_bytes``) fits
    half the L2 (``l2_bytes``), whose re-gathers the row-resident kernels'
    streamed windows then read; else "entries", the smallest cluster of a
    power of two CTAs, at most MAX_CLUSTER (or ``cluster``), whose CTAs
    hold it in ``CLUSTER_SMEM_BUDGET`` bytes each, the row's entries split
    into shares of ceil(widest / C) and the topics into slices of 4
    ceil(K / 4C); else "stream".  (Clusters of 2, 4 or 8 CTAs fill a
    GPC's SMs, 3, 5 or 7 leave some idle: PERF.md.)"""
    if tiled(K):
        raise ValueError(f"K = {K}: above {RESIDENT_TOPICS} the cluster "
                         "kernel's plan applies (cluster_plan)")
    bf16 = check_compute_dtype(compute_dtype)
    nmax = slot_buffer(K, compute_dtype, inner_iterations, sm_bytes, optin)
    slots = _up(max(widest, 1), 16)
    if bf16 and cluster is None and slots <= group_capacity(K, sm_bytes):
        return GammaPlan("groups", nmax, slots=slots,
                         smem_bytes=group_smem_bytes(K, slots))
    if widest <= nmax and cluster is None:
        return GammaPlan("rows", nmax)
    if cluster is None and 0 < table_bytes <= l2_bytes // 2:
        return GammaPlan("stream", nmax)
    nhist = min(inner_iterations, MAX_HIST)
    k4 = -(-K // 4)
    widths = [1 << i for i in range(MAX_CLUSTER.bit_length())]
    for C in widths if cluster is None else (cluster,):
        if not 1 <= C <= MAX_CLUSTER:
            raise ValueError(f"cluster must be 1..{MAX_CLUSTER}, got {C}")
        share = max(1, -(-widest // C))
        slice_ = 4 * -(-k4 // C)
        smem = entry_smem_bytes(K, share, slice_, C, nhist, bf16)
        if smem <= CLUSTER_SMEM_BUDGET or cluster is not None:
            return GammaPlan("entries", nmax, C, share, slice_, smem)
    return GammaPlan("stream", nmax)


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
    plan: Optional[Union[ClusterPlan, GammaPlan]] = None,
    seg_rows: Optional[torch.Tensor] = None,
    widest: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of a gamma kernel (``kernel``, a bound entry) on checked
    CUDA inputs, by ``plan``, else by ``gamma_plan``'s for rows of at most
    ``widest`` live entries (default ``length``) or, above
    ``RESIDENT_TOPICS``, ``cluster_plan``'s for rows of ``length``:
    (gamma [D, K],
    sweeps: 0-d int32, or [len(segments)] int32, each segment's own, when
    ``segments`` splits the rows into consecutive segments; ``seg_rows``,
    their ``segment_rows`` on the device, is built here when not passed).
    Checks the optional outputs; ``geometry_out`` gets the ``GEOMETRY``
    the launcher chose and the plan's route ("route").  Raises if the
    launch fails."""
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
    mode = "bfloat16" if bf16 else "float32"
    if plan is None and tiled(K):
        plan = cluster_plan(K, length, mode, inner_iterations)
    elif plan is None:
        props = torch.cuda.get_device_properties(dev)
        plan = gamma_plan(K, length if widest is None else min(length, widest),
                          mode, inner_iterations,
                          props.shared_memory_per_multiprocessor,
                          getattr(props, "shared_memory_per_block_optin",
                                  H100_SMEM_OPTIN),
                          table_bytes=table.numel() * table.element_size(),
                          l2_bytes=props.L2_cache_size)
    route = plan.route if isinstance(plan, GammaPlan) else "cluster"
    # A direct plan's slice states in device memory: room for a CTA an SM
    # (the launcher runs at most state_ctas CTAs).
    state = (torch.empty((sms * cluster_state_bytes(plan.slice, bf16, True)
                          // 4,), dtype=torch.float32, device=dev)
             if route == "cluster" and plan.direct else None)
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
    if route == "cluster":
        p.cluster, p.slice = plan.cluster, plan.slice
        p.resident, p.window = plan.resident, plan.window
        p.state_ctas = 0 if state is None else sms
    elif route == "entries":
        p.cluster, p.slice, p.resident = plan.cluster, plan.slice, plan.share
    elif route == "groups":
        p.group_slots = plan.slots
    # The scratch tensors may be freed once the launch is enqueued: the
    # caching allocator hands their memory out again only in stream order.
    with torch.cuda.device(dev):
        rc = kernel(ctypes.byref(p), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel.__name__} launch failed: cudaError {rc}")
    if geometry_out is not None:
        geometry_out.update({f: getattr(p, f) for f in GEOMETRY},
                            route=route)
    return gamma, sweeps if segments is not None else sweeps.reshape(())
