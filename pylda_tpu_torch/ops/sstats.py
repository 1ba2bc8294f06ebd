"""Fused dense sufficient statistics: the wrapper of ``csrc/dense_sstats.cu``.

Replaces ``pylda_tpu/ops/pallas_sstats.py::pallas_dense_sstats``.  For
CUDA tensors ``dense_sstats`` launches the hand-written kernel; for CPU
tensors it runs the plain version,
``pylda_tpu_torch.ops.estep.estep_dense_sstats``.  There is no other
route: a CUDA tensor the kernel does not take raises.

The kernel works only where a count is nonzero: 4*K FLOP a nonzero
(phinorm, the ratio, the score term, expEtheta * ratio into the column's
sums), and it reads the dense counts once.  Its bound on an H100 is that
read (the 84 MB bf16 chunk of the ragged flagship: ~25 us at 3.35 TB/s,
against ~3 us of arithmetic for its 1.2% nonzeros); what holds it back
from the bound is each row chunk's latency and the grid's fixed cost
(``PERF.md``).  Design and determinism: the source note of
``csrc/dense_sstats.cu``.  The grid is planned here (``plan``), so the
CPU tests reach it: at K <= ``ONE_PASS_MAX_TOPICS`` (256, the one-pass
kernel's largest build) vocab tiles of 64 columns, 32-row chunks, and row
splits enough for ``MIN_CTAS_PER_SM`` CTAs on every SM; the splits'
partial sums meet in split order, so two calls on the same inputs return
the same bits.  The scratch (score and split partials, the tiles'
counters, which each launch leaves zero) is kept per device and stream
and reused.  Above it one launch of a cluster kernel runs instead: the
topics split over a thread-block cluster of ``Plan.cluster`` CTAs (the
smallest power of two whose slices hold at most 512 topics: 1 at
K <= 512, 2 at config 5's K = 1000, 8 at 4096, 16 above 4096), each
holding a slice of ``Plan.slice`` topics of a ``Plan.cols``-column tile
of expElogbeta, read from device memory once; each CTA walks its share
of the tile's count rows and pushes their nonzeros to the whole cluster,
which works through them in row order in batches of up to
``Plan.batch``; the CTAs' partial phinorms meet in rank order
(``csrc/dense_sstats.cu``).
``plan`` sizes everything from the shapes (nothing is read back from the
card), and such calls count in ``WIDE_LAUNCHES`` / ``BF16_WIDE_LAUNCHES``
too.  Past K = 16 * 1024 a slice no longer fits a CTA's registers and
the plan is direct (``Plan.direct``: the same sums, read from device
memory); nothing caps K but the card's memory.
``compute_dtype="bfloat16"`` launches its bf16 build
(``ops/_build.py``: expEtheta, expElogbeta in phinorm and the ratio
rounded to bf16, the outer multiply by expElogbeta in float32), never the
float32 build.  At K <= ``ONE_PASS_MAX_TOPICS`` that build runs a
tensor-core kernel (``csrc/dense_sstats_mma.cuh``) instead of the walk:
both products on ``mma.sync`` over the dense tile, planned by
``mma_plan`` (64-column tiles, 64-row chunks, expEtheta rounded to
bf16 once a call into the scratch), counted in ``BF16_MMA_LAUNCHES`` (and
``BF16_RANGE_MMA_LAUNCHES``) too; its topic range is bitwise the full
call's rows as well.

``topic_range=(k0, k1)`` (lambda split over topics,
``parallel/lam_shard.py``) returns rows k0..k1-1 only, as a [k1 - k0, V]
result: phinorm and the score still run over all K, in the build and on
the grid of the whole K, and only the range's sums are accumulated,
stored and written, so its rows are the full call's rows bit for bit
(``csrc/dense_sstats.cu``; above K = 256 the whole K's cluster plan,
rows outside the range summed nowhere and not written).  Such calls
count in ``RANGE_LAUNCHES`` and ``BF16_RANGE_LAUNCHES`` besides
``LAUNCHES`` and ``BF16_LAUNCHES`` (and above K = 256 in
``RANGE_WIDE_LAUNCHES`` / ``BF16_RANGE_WIDE_LAUNCHES``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from pylda_tpu_torch.ops import _build
from pylda_tpu_torch.ops.estep import check_compute_dtype, estep_dense_sstats

# Kernel launches made by dense_sstats (one per call on CUDA tensors): of
# the float32 build, and of the bf16 build.
LAUNCHES = 0
BF16_LAUNCHES = 0
# Of those, the launches with a topic range narrower than [0, K).
RANGE_LAUNCHES = 0
BF16_RANGE_LAUNCHES = 0
# Of each, the launches of the cluster kernel, at any K (every call above
# ONE_PASS_MAX_TOPICS that ``plan`` sends to it).
WIDE_LAUNCHES = 0
BF16_WIDE_LAUNCHES = 0
RANGE_WIDE_LAUNCHES = 0
BF16_RANGE_WIDE_LAUNCHES = 0
# Of the bf16 launches, those of the tensor-core kernel (every bf16 call at
# K <= ONE_PASS_MAX_TOPICS), and of those the topic-range ones.
BF16_MMA_LAUNCHES = 0
BF16_RANGE_MMA_LAUNCHES = 0
# Largest topic count of the one-pass kernel (its largest build); above it
# the cluster kernel.
ONE_PASS_MAX_TOPICS = 256
# The cluster kernel above it (``csrc/dense_sstats.cu``'s constants):
# WIDE_COLS columns a tile (kWideCols; WIDE_NARROW_COLS, kWideNarrowCols,
# past slices of 512 topics), WIDE_LANE_FLOATS slice values a lane holds
# (kWideLaneFloats: a slice of at most 32 * WIDE_LANE_FLOATS * 8 / cols
# topics), a slice whole TMA boxes of WIDE_BOX rows (kWideBox), counts
# chunks of WIDE_COUNT_ROWS rows (kWideCountRows) in a ring of
# WIDE_COUNT_BUFS (kWideCountBufs), at most WIDE_PUSH_CAP nonzeros a CTA
# pushes to its cluster a tile (kWidePushCap), at most WIDE_MAX_CLUSTER
# CTAs a cluster (kWideMaxCluster) and WIDE_MAX_BATCH nonzeros a batch
# (kWideMaxBatch).
WIDE_COLS = 32
WIDE_NARROW_COLS = 16
WIDE_LANE_FLOATS = 64
WIDE_BOX = 32
WIDE_COUNT_ROWS = 128
WIDE_COUNT_BUFS = 3
WIDE_PUSH_CAP = 160
WIDE_MAX_CLUSTER = 16
WIDE_MAX_BATCH = 256
# The shared memory a CTA may take on an H100 (227 KB), which bounds the
# batch.
SMEM_LIMIT = 232448
# The slice the plan gives a CTA at most (a lane's WIDE_LANE_FLOATS values
# of a WIDE_COLS-column tile): the cluster is the smallest power of two
# whose slices hold at most this many topics (at most WIDE_MAX_CLUSTER).
WIDE_SLICE = 32 * 8 * WIDE_LANE_FLOATS // WIDE_COLS
# Threads of a CTA; vocab columns a CTA owns at 4 lanes a column.
THREADS = 256
TILE_V = 64
# Rows a chunk: the kernel's kRows (a column's row mask is a 32-bit word).
CHUNK_ROWS = 32
# The one-pass kernel's builds, (n4, lanes) of ``PYLDA_BUILD`` in
# ``csrc/dense_sstats.cu``: a column's sums are held by ``lanes`` (4) lanes
# of n4 float4s each, so K <= 4 * lanes * n4 topics (kp), and a CTA owns
# THREADS / lanes columns.  The first build that takes K runs.
BUILDS = ((1, 4), (2, 4), (4, 4), (7, 4), (8, 4), (16, 4))
# The grid has at least this many CTAs an SM, and a split at most
# CHUNKS_PER_SPLIT chunks: the fewest splits that meet both.  (Measured on
# an H100, PERF.md: fewer rows a split add CTAs whose fixed cost, the
# expElogbeta tile and the partial sums, is paid again; more rows leave
# too few CTAs to hide each chunk's latency.)
MIN_CTAS_PER_SM = 2
CHUNKS_PER_SPLIT = 26
# The bf16 build's tensor-core kernel at K <= ONE_PASS_MAX_TOPICS
# (``csrc/dense_sstats_mma.cuh``'s constants): MMA_TILE_V columns a tile
# (kMmaTileV), chunks of MMA_ROWS rows (kMmaRows) in MMA_BUFS buffers
# (kMmaBufs), bf16 tile rows of MMA_LD_V elements (kMmaLdV).  Its row
# splits minimise rounds x (chunks a split + MMA_SPLIT_COST): a round is
# as many CTAs an SM as run at once (``mma_plan``), and MMA_SPLIT_COST
# chunks' time is a split's own cost (staging the expElogbeta tile,
# storing and meeting its partials).
MMA_TILE_V = 64
MMA_ROWS = 64
MMA_BUFS = 3
MMA_LD_V = MMA_TILE_V + 8
MMA_SPLIT_COST = 2

_BOUND = set()


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's grid for one call: ``tiles`` x ``splits`` CTAs, a tile
    ``cols`` vocab columns; split s owns rows [s * rows_per_split,
    (s + 1) * rows_per_split) in chunks of ``CHUNK_ROWS``; ``kp`` topics
    (K padded to the kernel build's 4 * lanes * n4) are a column's sums a
    lane group holds, and ``qr`` float4s of them (the topic range's,
    rounded out to whole float4s) the length of a column's split
    partials.

    Above ONE_PASS_MAX_TOPICS (``cluster`` > 0) the cluster kernel's
    plan: ``tiles`` column tiles of ``cols`` columns (WIDE_COLS, or
    WIDE_NARROW_COLS past slices of 512 topics) over the counts' Vc,
    clusters of ``cluster`` CTAs each holding ``slice``
    topics (``kp`` = cluster * slice), batches of up to ``batch``
    nonzeros, ``direct`` past the slices a CTA holds; one split."""

    tiles: int
    splits: int
    rows_per_split: int
    kp: int
    cols: int
    qr: int = 0
    cluster: int = 0
    slice: int = 0
    batch: int = 0
    direct: bool = False
    smem_bytes: int = 0
    mma: bool = False
    D: int = 0

    @property
    def wide(self) -> bool:
        """The cluster kernel's plan (K > ONE_PASS_MAX_TOPICS)."""
        return self.cluster > 0

    @property
    def blocks(self) -> int:
        """CTAs of the one-pass grid, and entries of the f64 score
        partials (the cluster kernel: one a tile)."""
        return self.tiles * self.splits

    @property
    def mma_tiles(self) -> int:
        """The tensor-core kernel's topic tiles a warp (MT2 of
        ``mma_tiles_a_warp``): ceil(kp / 32) rounded up to a power of
        two."""
        mt = self.kp // 16
        return 1 if mt <= 2 else 2 if mt <= 4 else 4 if mt <= 8 else 8

    @property
    def partial_floats(self) -> int:
        """f32 scratch of the splits' partial sums (none for one split);
        the tensor-core kernel's also holds expEtheta rounded to bf16 ahead
        of them, [D, kp] bf16, and its partials are 8 * mma_tiles floats a
        thread of a split."""
        if self.mma:
            parts = (0 if self.splits == 1
                     else self.blocks * 8 * THREADS * self.mma_tiles)
            return self.D * self.kp // 2 + parts
        if self.splits == 1:
            return 0
        return self.blocks * self.cols * 4 * self.qr

    @property
    def scratch_bytes(self) -> int:
        """Device scratch of the call: f64 score partials, and f32 split
        partials and the int32 counters (one pass), or one int32 counter
        (the cluster kernel)."""
        if self.wide:
            return 8 * self.blocks + 4
        return 8 * self.blocks + 4 * self.partial_floats + 4 * (self.tiles + 1)


def wide_smem_bytes(slice_: int, batch: int, cluster: int, count_bytes: int,
                    cols: int = WIDE_COLS, direct: bool = False) -> int:
    """The cluster kernel's dynamic shared memory a CTA: ``WideLayout`` of
    ``csrc/dense_sstats.cu`` and 1024 bytes to align its base."""
    total = 0 if direct else slice_ * cols * 4 + (batch - cols) * slice_ * 4
    total += WIDE_COUNT_BUFS * WIDE_COUNT_ROWS * cols * count_bytes
    total += 8 * WIDE_PUSH_CAP + 8 * cluster * (1 + WIDE_PUSH_CAP)
    total += batch * (4 + 4 + 4 + 4 + 8 + 8 * 2 * cluster)
    total += 8 * (THREADS // 32) + 16 + 64
    return total + 1024


def wide_cluster(K: int) -> int:
    """The cluster kernel's CTAs a cluster at K topics: the smallest power
    of two whose slices hold at most WIDE_SLICE topics (1 at K <= 512, 2
    at <= 1024, 4 at <= 2048, 8 at <= 4096), at most WIDE_MAX_CLUSTER."""
    cluster = 1
    while -(-K // cluster) > WIDE_SLICE and cluster < WIDE_MAX_CLUSTER:
        cluster *= 2
    return cluster


def wide_plan(K: int, count_bytes: int = 2
              ) -> Tuple[int, int, int, int, bool]:
    """(cluster, slice, cols, batch, direct) of the cluster kernel at
    K > ONE_PASS_MAX_TOPICS: ``wide_cluster(K)`` CTAs, each a slice of
    K / cluster topics rounded up to whole WIDE_BOX-row boxes, at
    WIDE_COLS columns a tile while the slice holds at most 512 topics (a
    lane's WIDE_LANE_FLOATS values), else WIDE_NARROW_COLS up to 1024
    topics; the largest batch (a multiple of 4, at most WIDE_MAX_BATCH)
    whose shared memory fits SMEM_LIMIT (its first expEtheta rows fill the
    slice tile's buffer, then at least as many past it, where the epilogue
    stages the tile).  Past that the direct plan (WIDE_COLS columns, the
    slice rounded up to 4 topics, no rows staged)."""
    cluster = wide_cluster(K)
    per = -(-K // cluster)
    direct = per * WIDE_NARROW_COLS > 32 * 8 * WIDE_LANE_FLOATS
    if direct:
        cols, slice_ = WIDE_COLS, -(-per // 4) * 4
    else:
        cols = (WIDE_COLS if per * WIDE_COLS <= 32 * 8 * WIDE_LANE_FLOATS
                else WIDE_NARROW_COLS)
        slice_ = -(-per // WIDE_BOX) * WIDE_BOX
    batch = WIDE_MAX_BATCH
    while wide_smem_bytes(slice_, batch, cluster, count_bytes, cols,
                          direct) > SMEM_LIMIT:
        batch -= 4
    if not direct and batch < 2 * cols:
        raise ValueError(f"no batch of {cols} nonzeros fits at K = {K}")
    return cluster, slice_, cols, batch, direct


def mma_smem_bytes(K: int, count_bytes: int = 2) -> int:
    """The tensor-core kernel's dynamic shared memory a CTA: ``MmaLayout``
    of ``csrc/dense_sstats_mma.cuh`` (bf16 counts take their ratios in
    place, f32 counts a tile of its own)."""
    kp = -(-K // 16) * 16
    cnt_ld = MMA_TILE_V + 16 // count_bytes
    return (kp * MMA_LD_V * 2 + MMA_BUFS * MMA_ROWS * (kp + 8) * 2
            + MMA_BUFS * MMA_ROWS * cnt_ld * count_bytes
            + (0 if count_bytes == 2 else MMA_ROWS * MMA_LD_V * 2))


@functools.lru_cache(maxsize=256)
def mma_plan(D: int, Vc: int, K: int, sms: int, count_bytes: int = 2
             ) -> Plan:
    """The bf16 build's grid at K <= ONE_PASS_MAX_TOPICS (the tensor-core
    kernel): MMA_TILE_V-column tiles, kp = K rounded up to 16, and the
    row splits (whole MMA_ROWS-row chunks, none empty) that minimise
    rounds x (chunks a split + MMA_SPLIT_COST), a round being as many CTAs
    an SM as run at once (two at the flagships' K = 100, one past
    kp = 128), the fewest splits on a tie.  The same for any topic
    range.  Cached: an engine's calls repeat a few shapes, and the search
    is host time on every call."""
    kp = -(-K // 16) * 16
    tiles = max(1, -(-Vc // MMA_TILE_V))
    chunks = max(1, -(-D // MMA_ROWS))
    smem = mma_smem_bytes(K, count_bytes)
    # Past kp = 128 a thread's registers (ptxas: ~165) leave room for one
    # CTA an SM; below, the shared memory says.
    at_once = 1 if kp > 128 else max(1, min(2, SMEM_LIMIT // (smem + 1024)))
    best = None
    for splits in range(1, chunks + 1):
        per = -(-chunks // splits)
        if (splits - 1) * per >= chunks:
            continue  # an empty split
        per_sm = -(-tiles * splits // sms)
        cost = -(-per_sm // at_once) * (per + MMA_SPLIT_COST)
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    _, splits, per = best
    return Plan(tiles=tiles, splits=splits, rows_per_split=per * MMA_ROWS,
                kp=kp, cols=MMA_TILE_V, smem_bytes=smem, mma=True, D=D)


def build_for(K: int) -> Tuple[int, int]:
    """(n4, lanes) of the one-pass kernel build that runs at K topics."""
    if not 1 <= K <= ONE_PASS_MAX_TOPICS:
        raise ValueError(f"the one-pass builds take K in "
                         f"[1, {ONE_PASS_MAX_TOPICS}], got {K}")
    return next(b for b in BUILDS if 4 * b[0] * b[1] >= K)


def plan(D: int, Vc: int, K: int, sms: int,
         topic_range: Optional[Tuple[int, int]] = None,
         count_bytes: int = 2, compute_dtype: str = "float32") -> Plan:
    """The grid for counts [D, Vc] at K topics on a card of ``sms`` SMs:
    the build's tile width, then the fewest row splits that give
    ``MIN_CTAS_PER_SM`` CTAs an SM and at most ``CHUNKS_PER_SPLIT`` 32-row
    chunks a split (both read at call time), no more splits than chunks,
    and no empty split.  A ``topic_range``
    (k0, k1) sizes the split partials only: the grid is the whole K's.
    Without one a column's partials take kp floats, the length every
    build of the kernel's source has used.  Above ONE_PASS_MAX_TOPICS the
    cluster kernel's plan (``wide_plan``; its batch depends on the counts'
    ``count_bytes``, 2 for bf16, 4 for f32), the same for any range; at
    or below it in bf16 the tensor-core kernel's (``mma_plan``)."""
    if K < 1:
        raise ValueError(f"K must be at least 1, got {K}")
    k0, k1 = check_topic_range(topic_range, K)
    if check_compute_dtype(compute_dtype) and K <= ONE_PASS_MAX_TOPICS:
        return mma_plan(D, Vc, K, sms, count_bytes)
    if K > ONE_PASS_MAX_TOPICS:
        cluster, slice_, cols, batch, direct = wide_plan(K, count_bytes)
        return Plan(tiles=max(1, -(-Vc // cols)), splits=1,
                    rows_per_split=max(1, -(-D // WIDE_COUNT_ROWS))
                    * WIDE_COUNT_ROWS,
                    kp=cluster * slice_, cols=cols, cluster=cluster,
                    slice=slice_, batch=batch, direct=direct,
                    smem_bytes=wide_smem_bytes(slice_, batch, cluster,
                                               count_bytes, cols, direct))
    n4, lanes = build_for(K)
    kp, cols = 4 * lanes * n4, THREADS // lanes
    tiles = max(1, -(-Vc // cols))
    chunks = max(1, -(-D // CHUNK_ROWS))
    want = max(-(-MIN_CTAS_PER_SM * sms // tiles),
               -(-chunks // CHUNKS_PER_SPLIT))
    splits = min(chunks, max(1, want))
    rows_per_split = -(-chunks // splits) * CHUNK_ROWS
    splits = max(1, -(-D // rows_per_split))
    return Plan(tiles=tiles, splits=splits, rows_per_split=rows_per_split,
                kp=kp, cols=cols, qr=(kp // 4 if topic_range is None
                                      else -(-k1 // 4) - k0 // 4))


def check_topic_range(topic_range: Optional[Tuple[int, int]], K: int
                      ) -> Tuple[int, int]:
    """(k0, k1) of ``topic_range``, (0, K) for None; raises ``ValueError``
    unless 0 <= k0 < k1 <= K."""
    k0, k1 = (0, K) if topic_range is None else map(int, topic_range)
    if not 0 <= k0 < k1 <= K:
        raise ValueError(f"topic range {topic_range} is not within [0, {K})")
    return k0, k1


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the argument types of ``pylda_dense_sstats`` (and of
    ``pylda_dense_sstats_range`` where the source has it) on a library
    built from ``csrc/dense_sstats.cu`` (or from a variant of it)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pylda_dense_sstats.argtypes = [
        p, i, p, p, p, p, p, p, p, i, i, i, i, f, i, i, p,
    ]
    lib.pylda_dense_sstats.restype = i
    if hasattr(lib, "pylda_dense_sstats_wide"):
        lib.pylda_dense_sstats_wide.argtypes = [
            p, i, p, p, p, p, p, p, i, i, i, i, i, i, f, i, i, i, i, i, p, p,
        ]
        lib.pylda_dense_sstats_wide.restype = i
    if hasattr(lib, "pylda_dense_sstats_range"):
        lib.pylda_dense_sstats_range.argtypes = [
            p, i, p, p, p, p, p, p, p, i, i, i, i, i, i, f, i, i, p,
        ]
        lib.pylda_dense_sstats_range.restype = i
    return lib


def _lib(compute_dtype: str) -> ctypes.CDLL:
    lib = _build.library("dense_sstats", compute_dtype)
    if compute_dtype not in _BOUND:
        bind(lib)
        _BOUND.add(compute_dtype)
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# (device index, stream) -> [score partials f64, split partials f32,
# counters int32].  The kernel leaves its counters zero, and a stream runs
# its calls in turn, so one set serves every call on that stream; it grows
# when a call needs more.
_SCRATCH: Dict[Tuple[int, int], list] = {}


def _scratch(dev: torch.device, stream: int, pl: Plan) -> list:
    key = (dev.index, stream)
    need = (pl.blocks, max(pl.partial_floats, 1),
            1 if pl.wide else pl.tiles + 1)
    have = _SCRATCH.get(key)
    if have is None or any(t.numel() < n for t, n in zip(have, need)):
        if have is not None:
            need = tuple(max(t.numel(), n) for t, n in zip(have, need))
        have = _SCRATCH[key] = [
            torch.empty((need[0],), dtype=torch.float64, device=dev),
            torch.empty((need[1],), dtype=torch.float32, device=dev),
            torch.zeros((need[2],), dtype=torch.int32, device=dev),
        ]
    return have


def dense_sstats(
    counts: torch.Tensor,  # [D, Vc] bf16 or f32, Vc >= V (zero pads)
    exp_etheta: torch.Tensor,  # [D, K] f32
    exp_elog_beta: torch.Tensor,  # [K, V] f32
    eps: float = 1e-30,
    compute_dtype: str = "float32",
    topic_range: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sstats [K, V], or [k1 - k0, V] for a ``topic_range`` (k0, k1),
    token score 0-d) — see ``estep_dense_sstats``."""
    global LAUNCHES, BF16_LAUNCHES, RANGE_LAUNCHES, BF16_RANGE_LAUNCHES
    global WIDE_LAUNCHES, BF16_WIDE_LAUNCHES, RANGE_WIDE_LAUNCHES
    global BF16_RANGE_WIDE_LAUNCHES, BF16_MMA_LAUNCHES
    global BF16_RANGE_MMA_LAUNCHES
    check_compute_dtype(compute_dtype)
    if not counts.is_cuda:
        return estep_dense_sstats(counts, exp_etheta, exp_elog_beta, eps,
                                  compute_dtype=compute_dtype,
                                  topic_range=topic_range)
    D, Vc = counts.shape
    K, V = exp_elog_beta.shape
    if counts.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"counts must be bf16 or f32, got {counts.dtype}")
    if exp_etheta.dtype != torch.float32 or exp_elog_beta.dtype != torch.float32:
        raise TypeError("the sstats kernel takes float32 expEtheta/expElogbeta")
    if exp_etheta.shape != (D, K) or Vc < V:
        raise ValueError(
            f"shape mismatch: counts {tuple(counts.shape)}, expEtheta "
            f"{tuple(exp_etheta.shape)}, expElogbeta {tuple(exp_elog_beta.shape)}"
        )
    k0, k1 = check_topic_range(topic_range, K)
    dev = counts.device
    if exp_etheta.device != dev or exp_elog_beta.device != dev:
        raise ValueError("all inputs must be on one device")
    pl = plan(D, Vc, K, _sms(dev.index), topic_range, counts.element_size(),
              compute_dtype)
    out = launch(_lib(compute_dtype), counts.contiguous(), exp_etheta.contiguous(),
                 exp_elog_beta.contiguous(), eps, topic_range, pl)
    narrow = (k0, k1) != (0, K)
    wide = pl.wide
    if compute_dtype == "bfloat16":
        BF16_LAUNCHES += 1
        BF16_RANGE_LAUNCHES += narrow
        BF16_WIDE_LAUNCHES += wide
        BF16_RANGE_WIDE_LAUNCHES += narrow and wide
        BF16_MMA_LAUNCHES += pl.mma
        BF16_RANGE_MMA_LAUNCHES += narrow and pl.mma
    else:
        LAUNCHES += 1
        RANGE_LAUNCHES += narrow
        WIDE_LAUNCHES += wide
        RANGE_WIDE_LAUNCHES += narrow and wide
    return out


def launch(lib: ctypes.CDLL, counts: torch.Tensor, exp_etheta: torch.Tensor,
           exp_elog_beta: torch.Tensor, eps: float,
           topic_range: Optional[Tuple[int, int]] = None,
           plan_: Optional[Plan] = None,
           geometry_out: Optional[dict] = None,
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``lib``'s kernel on checked, contiguous CUDA inputs:
    (sstats, score); raises if the launch fails.  Without a
    ``topic_range`` it calls the full-range entry, which a library built
    from an older source also has.  A wide plan (``plan_``, default
    ``plan``'s in float32; a bf16 library at K <= ONE_PASS_MAX_TOPICS takes
    the bf16 plan): the cluster kernel (a direct plan at another K's
    cluster and slice is the check of its bits), with its geometry
    (clusters, shared memory a CTA, grid) in ``geometry_out``."""
    D, Vc = counts.shape
    K, V = exp_elog_beta.shape
    k0, k1 = check_topic_range(topic_range, K)
    dev = counts.device
    pl = plan_ or plan(D, Vc, K, _sms(dev.index), topic_range,
                       counts.element_size())
    # The last CTA of each tile (one pass), or each CTA for its slice (the
    # cluster kernel), writes every entry of its columns.
    sstats = torch.empty((k1 - k0, V), dtype=torch.float32, device=dev)
    score = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        parts, partial, counters = _scratch(dev, stream, pl)
        bf16 = int(counts.dtype == torch.bfloat16)
        if pl.wide:
            geo = (ctypes.c_int * 3)()
            rc = lib.pylda_dense_sstats_wide(
                counts.data_ptr(), bf16, exp_etheta.data_ptr(),
                exp_elog_beta.data_ptr(), sstats.data_ptr(), parts.data_ptr(),
                score.data_ptr(), counters.data_ptr(), D, Vc, V, K, k0, k1,
                float(eps), pl.cluster, pl.slice, pl.cols, pl.batch,
                int(pl.direct), geo, stream)
            if geometry_out is not None:
                geometry_out.update(clusters=geo[0], smem_bytes=geo[1],
                                    grid=geo[2], cluster=pl.cluster,
                                    slice=pl.slice, cols=pl.cols,
                                    batch=pl.batch, direct=pl.direct)
        else:
            args = (counts.data_ptr(), bf16, exp_etheta.data_ptr(),
                    exp_elog_beta.data_ptr(), sstats.data_ptr(),
                    parts.data_ptr(), score.data_ptr(), partial.data_ptr(),
                    counters.data_ptr(), D, Vc, V, K)
            tail = (float(eps), pl.splits, pl.rows_per_split, stream)
            if topic_range is None:
                rc = lib.pylda_dense_sstats(*args, *tail)
            else:
                rc = lib.pylda_dense_sstats_range(*args, k0, k1, *tail)
    if rc != 0:
        raise RuntimeError(f"dense_sstats kernel launch failed: cudaError {rc}")
    return sstats, score


def wide_batches(counts: torch.Tensor, pl: Plan) -> int:
    """The batches the cluster kernel runs on ``counts`` at ``pl``: a
    tile's nonzeros in one batch where they fit ``pl.batch``, else in
    batches of half as many, or of ``pl.batch`` where a CTA's share of
    the tile's rows holds more than WIDE_PUSH_CAP (every CTA then walks
    the tile); none for a tile without nonzeros.  Reads the counts (a
    report, not the launch's plan)."""
    D, Vc = counts.shape
    rows = -(-D // pl.cluster) * pl.cluster
    nz = torch.nn.functional.pad((counts != 0).to(torch.uint8),
                                 (0, pl.tiles * pl.cols - Vc, 0, rows - D))
    share = nz.reshape(pl.cluster, rows // pl.cluster, pl.tiles,
                       pl.cols).sum(dim=(1, 3))
    per_tile = share.sum(dim=0)
    size = torch.where((share > WIDE_PUSH_CAP).any(dim=0)
                       | (per_tile <= pl.batch), pl.batch, pl.batch // 2)
    return int(((per_tile + size - 1) // size).sum())
