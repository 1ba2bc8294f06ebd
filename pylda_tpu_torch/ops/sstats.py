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
CPU tests reach it: vocab tiles of ``Plan.cols`` columns (64 at K <= 256;
32, 16 or 8 above, where more lanes hold a column's sums), 32-row chunks,
and row splits enough for ``MIN_CTAS_PER_SM`` CTAs on every SM; the
splits' partial sums meet in split order, so two calls on the same inputs
return the same bits.  The scratch (score and split partials, the tiles'
counters, which each launch leaves zero) is kept per device and stream
and reused.  Above ``ONE_PASS_MAX_TOPICS`` (K = 4096, the largest build)
the kernel runs two passes over a column list of the nonzeros (a count
and a fill, then per nonzero phinorm, the ratio and the score over all
K, then each (column tile, topic tile)'s sums): ``plan`` gives their grid
and, from the nonzero count the count pass leaves on the card (read back
to size the list: one host sync a call), their scratch; such calls count
in ``WIDE_LAUNCHES`` / ``BF16_WIDE_LAUNCHES`` too.  Nothing caps K but
the card's memory.  ``compute_dtype="bfloat16"`` launches its bf16 build
(``ops/_build.py``: expEtheta, expElogbeta in phinorm and the ratio
rounded to bf16, the outer multiply by expElogbeta in float32), never the
float32 build.

``topic_range=(k0, k1)`` (lambda split over topics,
``parallel/lam_shard.py``) returns rows k0..k1-1 only, as a [k1 - k0, V]
result: phinorm and the score still run over all K, in the build and on
the grid of the whole K, and only the range's sums are accumulated,
stored and written, so its rows are the full call's rows bit for bit
(``csrc/dense_sstats.cu``; above K = 4096 the range's topic tiles of the
second pass).  Such calls count in ``RANGE_LAUNCHES`` and
``BF16_RANGE_LAUNCHES`` besides ``LAUNCHES`` and ``BF16_LAUNCHES`` (and
above K = 4096 in ``RANGE_WIDE_LAUNCHES`` / ``BF16_RANGE_WIDE_LAUNCHES``).
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
# Of each, the launches of the two passes (K > ONE_PASS_MAX_TOPICS).
WIDE_LAUNCHES = 0
BF16_WIDE_LAUNCHES = 0
RANGE_WIDE_LAUNCHES = 0
BF16_RANGE_WIDE_LAUNCHES = 0
# Largest topic count of the one-pass kernel (its largest build); above
# it the two passes run, a CTA TWO_PASS_COLS columns (kTpCols) and, in the
# second pass, TWO_PASS_TOPICS topics (kTpTopics).
ONE_PASS_MAX_TOPICS = 4096
TWO_PASS_COLS = 32
TWO_PASS_TOPICS = 256
# Threads of a CTA; vocab columns a CTA owns at 4 lanes a column.
THREADS = 256
TILE_V = 64
# Rows a chunk: the kernel's kRows (a column's row mask is a 32-bit word).
CHUNK_ROWS = 32
# The kernel's builds, (n4, lanes) of ``PYLDA_BUILD`` in
# ``csrc/dense_sstats.cu``: a column's sums are held by ``lanes`` lanes of
# n4 float4s each, so K <= 4 * lanes * n4 topics (kp), and a CTA owns
# THREADS / lanes columns.  The first build that takes K runs.
BUILDS = ((1, 4), (2, 4), (4, 4), (7, 4), (8, 4), (16, 4),
          (16, 8), (16, 16), (16, 32), (32, 32))
# The grid has at least this many CTAs an SM, and a split at most
# CHUNKS_PER_SPLIT chunks (times kp / 256 above kp = 256): the fewest
# splits that meet both.  (Measured on an H100 at kp <= 256, PERF.md:
# fewer rows a split add CTAs whose fixed cost, the expElogbeta tile and
# the partial sums, is paid again; more rows leave too few CTAs to hide
# each chunk's latency.  Above kp = 256 that fixed cost, [cols, kp] floats
# twice, grows with kp while a lane's work a nonzero does not: the rows a
# split grow with it, a choice not measured.)
MIN_CTAS_PER_SM = 2
CHUNKS_PER_SPLIT = 26

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

    ``two_pass`` (K > ONE_PASS_MAX_TOPICS): ``tiles`` first-pass CTAs of
    ``cols`` columns over the ``vc`` counts columns (and as many f64 score
    partials), one split, ``kp`` K rounded up to the second pass's topic
    tile, and a column list of ``nnz`` nonzeros."""

    tiles: int
    splits: int
    rows_per_split: int
    kp: int
    cols: int
    qr: int = 0
    two_pass: bool = False
    vc: int = 0
    nnz: int = 0

    @property
    def blocks(self) -> int:
        """CTAs (of the first pass), and entries of the f64 score
        partials."""
        return self.tiles * self.splits

    @property
    def partial_floats(self) -> int:
        """f32 scratch of the splits' partial sums (none for one split)."""
        if self.splits == 1:
            return 0
        return self.blocks * self.cols * 4 * self.qr

    @property
    def scratch_bytes(self) -> int:
        """Device scratch of the call: f64 score partials, and f32 split
        partials and the int32 counters (one pass), or the int64 column
        starts and the list's rows, counts and ratios, 12 bytes a nonzero
        (two passes)."""
        if self.two_pass:
            return 8 * self.blocks + 8 * (self.vc + 1) + 12 * self.nnz
        return 8 * self.blocks + 4 * self.partial_floats + 4 * (self.tiles + 1)


def build_for(K: int) -> Tuple[int, int]:
    """(n4, lanes) of the one-pass kernel build that runs at K topics."""
    if not 1 <= K <= ONE_PASS_MAX_TOPICS:
        raise ValueError(f"the one-pass builds take K in "
                         f"[1, {ONE_PASS_MAX_TOPICS}], got {K}")
    return next(b for b in BUILDS if 4 * b[0] * b[1] >= K)


def plan(D: int, Vc: int, K: int, sms: int,
         topic_range: Optional[Tuple[int, int]] = None,
         nnz: int = 0) -> Plan:
    """The grid for counts [D, Vc] at K topics on a card of ``sms`` SMs:
    the build's tile width, then the fewest row splits that give
    ``MIN_CTAS_PER_SM`` CTAs an SM and at most ``CHUNKS_PER_SPLIT`` (times
    kp / 256 above 256) 32-row chunks a split (both read at call time), no
    more splits than chunks, and no empty split.  A ``topic_range``
    (k0, k1) sizes the split partials only: the grid is the whole K's.
    Without one a column's partials take kp floats, the length every
    build of the kernel's source has used.  Above ONE_PASS_MAX_TOPICS the
    two passes' grid, with a list of ``nnz`` nonzeros."""
    if K < 1:
        raise ValueError(f"K must be at least 1, got {K}")
    k0, k1 = check_topic_range(topic_range, K)
    if K > ONE_PASS_MAX_TOPICS:
        chunks = max(1, -(-D // CHUNK_ROWS))
        return Plan(tiles=max(1, -(-Vc // TWO_PASS_COLS)), splits=1,
                    rows_per_split=chunks * CHUNK_ROWS,
                    kp=-(-K // TWO_PASS_TOPICS) * TWO_PASS_TOPICS,
                    cols=TWO_PASS_COLS, two_pass=True, vc=Vc, nnz=nnz)
    n4, lanes = build_for(K)
    kp, cols = 4 * lanes * n4, THREADS // lanes
    tiles = max(1, -(-Vc // cols))
    chunks = max(1, -(-D // CHUNK_ROWS))
    per_split = CHUNKS_PER_SPLIT * max(1, kp // 256)
    want = max(-(-MIN_CTAS_PER_SM * sms // tiles), -(-chunks // per_split))
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
    if hasattr(lib, "pylda_dense_sstats_two_pass"):
        lib.pylda_dense_sstats_two_pass_count.argtypes = [p, i, i, i, p, p]
        lib.pylda_dense_sstats_two_pass_count.restype = i
        lib.pylda_dense_sstats_two_pass.argtypes = [
            p, i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, f, p,
        ]
        lib.pylda_dense_sstats_two_pass.restype = i
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
    need = (pl.blocks, max(pl.partial_floats, 1), pl.tiles + 1)
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
    global BF16_RANGE_WIDE_LAUNCHES
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
    out = launch(_lib(compute_dtype), counts.contiguous(), exp_etheta.contiguous(),
                 exp_elog_beta.contiguous(), eps, topic_range)
    narrow = (k0, k1) != (0, K)
    wide = K > ONE_PASS_MAX_TOPICS
    if compute_dtype == "bfloat16":
        BF16_LAUNCHES += 1
        BF16_RANGE_LAUNCHES += narrow
        BF16_WIDE_LAUNCHES += wide
        BF16_RANGE_WIDE_LAUNCHES += narrow and wide
    else:
        LAUNCHES += 1
        RANGE_LAUNCHES += narrow
        WIDE_LAUNCHES += wide
        RANGE_WIDE_LAUNCHES += narrow and wide
    return out


def launch(lib: ctypes.CDLL, counts: torch.Tensor, exp_etheta: torch.Tensor,
           exp_elog_beta: torch.Tensor, eps: float,
           topic_range: Optional[Tuple[int, int]] = None,
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``lib``'s kernel on checked, contiguous CUDA inputs:
    (sstats, score); raises if the launch fails.  Without a
    ``topic_range`` it calls the full-range entry, which a library built
    from an older source also has."""
    D, Vc = counts.shape
    K, V = exp_elog_beta.shape
    k0, k1 = check_topic_range(topic_range, K)
    dev = counts.device
    if K > ONE_PASS_MAX_TOPICS:
        return _launch_two_pass(lib, counts, exp_etheta, exp_elog_beta, eps,
                                k0, k1)
    pl = plan(D, Vc, K, _sms(dev.index), topic_range)
    # The last CTA of each tile writes every entry of its columns.
    sstats = torch.empty((k1 - k0, V), dtype=torch.float32, device=dev)
    score = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        parts, partial, counters = _scratch(dev, stream, pl)
        args = (counts.data_ptr(), int(counts.dtype == torch.bfloat16),
                exp_etheta.data_ptr(), exp_elog_beta.data_ptr(),
                sstats.data_ptr(), parts.data_ptr(), score.data_ptr(),
                partial.data_ptr(), counters.data_ptr(), D, Vc, V, K)
        tail = (float(eps), pl.splits, pl.rows_per_split, stream)
        if topic_range is None:
            rc = lib.pylda_dense_sstats(*args, *tail)
        else:
            rc = lib.pylda_dense_sstats_range(*args, k0, k1, *tail)
    if rc != 0:
        raise RuntimeError(f"dense_sstats kernel launch failed: cudaError {rc}")
    return sstats, score


def _launch_two_pass(lib: ctypes.CDLL, counts: torch.Tensor,
                     exp_etheta: torch.Tensor, exp_elog_beta: torch.Tensor,
                     eps: float, k0: int, k1: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two passes above ONE_PASS_MAX_TOPICS: the count pass, the
    nonzero count read back (one sync) to size the column list, then the
    rest; (sstats [k1 - k0, V], score)."""
    D, Vc = counts.shape
    K, V = exp_elog_beta.shape
    dev = counts.device
    bf16 = int(counts.dtype == torch.bfloat16)
    colptr = torch.empty((Vc + 1,), dtype=torch.int64, device=dev)
    sstats = torch.empty((k1 - k0, V), dtype=torch.float32, device=dev)
    score = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pylda_dense_sstats_two_pass_count(
            counts.data_ptr(), bf16, D, Vc, colptr.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"dense_sstats count pass launch failed: "
                               f"cudaError {rc}")
        nnz = int(colptr[Vc])
        pl = plan(D, Vc, K, _sms(dev.index), (k0, k1), nnz=nnz)
        rows = torch.empty((max(nnz, 1),), dtype=torch.int32, device=dev)
        vals = torch.empty((max(nnz, 1),), dtype=torch.float32, device=dev)
        ratio = torch.empty_like(vals)
        parts = torch.empty((pl.blocks,), dtype=torch.float64, device=dev)
        rc = lib.pylda_dense_sstats_two_pass(
            counts.data_ptr(), bf16, exp_etheta.data_ptr(),
            exp_elog_beta.data_ptr(), sstats.data_ptr(), score.data_ptr(),
            colptr.data_ptr(), rows.data_ptr(), vals.data_ptr(),
            ratio.data_ptr(), parts.data_ptr(), D, Vc, V, K, k0, k1,
            float(eps), stream)
    if rc != 0:
        raise RuntimeError(f"dense_sstats two-pass launch failed: "
                           f"cudaError {rc}")
    return sstats, score
