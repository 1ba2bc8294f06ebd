"""Host side of the row-resident gamma fixed point (``csrc/row_fixed_point.cuh``),
shared by the wrappers of its two kernels, ``ops/ragged.py::ragged_gamma``
and ``ops/dense_estep.py::dense_estep``.

Both C entries take the same two arguments, a pointer to the core's
``Params`` struct (mirrored here field for field) and a CUDA stream::

    int pylda_ragged_gamma(void* params, void* stream);
    int pylda_dense_gamma(void* params, void* stream);

``launch`` allocates the scratch the kernel needs, fills a ``Params``,
makes the call and returns the output gamma and sweep count.  The
launcher writes the geometry it chose back into the ``Params``
(``GEOMETRY``).  Both kernels take any K >= 1: up to ``RESIDENT_TOPICS``
the row-resident kernels of ``csrc/row_fixed_point.cuh`` run, above it
the tiled kernel of ``csrc/row_fixed_point_tiled.cuh``, which keeps a
row's state in a block's scratch in device memory (``state``,
``tiled_state_floats`` a block) and walks the topics in tiles of
``TILE_TOPICS``.  Nothing caps K but the card's memory: an allocation the
card cannot make raises PyTorch's out-of-memory error, which names the
bytes.  Each is built in two modes (``ops/_build.py``): float32, and the
bf16 operand mode, whose entry takes a bf16 gather table
(``gather_table(.., "bfloat16")``) and rounds expEtheta and the ratio as
the reference does.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch

from pylda_tpu_torch.ops import _build
from pylda_tpu_torch.ops.dirichlet import exp_dirichlet_expectation
from pylda_tpu_torch.ops.estep import check_compute_dtype

# The blocks of one streamed row's scratch list an SM needs: a row longer
# than the slot buffer implies a ~72 KB buffer, so 3 blocks an SM (at
# K > 256, 2 or 1).
LIST_BLOCKS_PER_SM = 3
# Largest K of the row-resident kernels (kMaxTopics of the core: its wide
# kernels keep up to 4 float4 sums a thread); above it the tiled kernel
# runs, over topic tiles of TILE_TOPICS (kTileTopics).
RESIDENT_TOPICS = 4096
TILE_TOPICS = 4096
# The launch geometry the launcher writes back: live entries the slot
# buffer holds (a row with more streams; 0 in the tiled kernel, where
# every row streams), shared memory a block, blocks an SM, the grid, and
# the topics a tile of the sweep (K where it is not tiled).
GEOMETRY = ("nmax", "smem_bytes", "blocks_per_sm", "grid", "tile")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class Params(ctypes.Structure):
    """``struct Params`` of ``csrc/row_fixed_point.cuh``; the launcher sets
    ``nmax``, ``nhist`` and the launch geometry."""

    _fields_ = [
        ("ids", _P), ("cnts", _P), ("table", _P), ("alpha", _P),
        ("gamma0", _P), ("et0", _P), ("gamma", _P), ("not_exitable", _P),
        ("queues", _P), ("row_run", _P), ("row_nnz", _P),
        ("sweeps_out", _P), ("row_sweeps", _P), ("row_exit", _P),
        ("slots_out", _P), ("extra_out", _P), ("lists", _P), ("state", _P),
        ("D", _I), ("ld", _I), ("L", _I), ("K", _I), ("ldb", _I),
        ("cnts_bf16", _I), ("table_bf16", _I), ("list_blocks", _I),
        ("nmax", _I), ("nhist", _I),
        ("inner_iterations", _I), ("threshold", _F), ("eps", _F),
        ("patience", _I), ("use_stall", _I),
        ("smem_bytes", _I), ("blocks_per_sm", _I), ("grid", _I),
        ("tile", _I),
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
    """True where the tiled kernel runs (K > RESIDENT_TOPICS)."""
    return K > RESIDENT_TOPICS


def tiled_state_floats(K: int, L: int) -> int:
    """Floats of one block's state in the tiled kernel
    (``tiled_state_floats`` of the header): expEtheta, its bf16-rounded
    copy and gamma at K rounded up to 8 each, then the ratios of L live
    entries rounded up to 4."""
    kp = -(-K // 8) * 8
    return 3 * kp + -(-L // 4) * 4


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of a gamma kernel (``kernel``, a bound entry; the tiled
    kernel above ``RESIDENT_TOPICS``) on checked CUDA inputs: (gamma
    [D, K], sweeps 0-d int32).  Checks the optional outputs;
    ``geometry_out`` gets the ``GEOMETRY`` the launcher chose.  Raises if
    the launch fails."""
    D, K = gamma_init.shape
    dev = gamma_init.device
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
    not_exitable = torch.zeros((inner_iterations,), dtype=torch.int32,
                               device=dev)
    queues = torch.zeros((2,), dtype=torch.int32, device=dev)
    rows = torch.empty((2, D), dtype=torch.int32, device=dev)
    sweeps = torch.empty((), dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    list_blocks = min(D, LIST_BLOCKS_PER_SM * sms)
    lists = torch.empty((list_blocks, 2, max(length, 1)), dtype=torch.int32,
                        device=dev)
    state = None
    if tiled(K):
        state = torch.empty((list_blocks, tiled_state_floats(K, length)),
                            dtype=torch.float32, device=dev)
    p = Params(
        ids=_ptr(ids), cnts=cnts.data_ptr(), table=table.data_ptr(),
        alpha=alpha.data_ptr(), gamma0=gamma0.data_ptr(),
        et0=et0.data_ptr(), gamma=gamma.data_ptr(),
        not_exitable=not_exitable.data_ptr(), queues=queues.data_ptr(),
        row_run=rows[0].data_ptr(), row_nnz=rows[1].data_ptr(),
        sweeps_out=sweeps.data_ptr(), row_sweeps=_ptr(row_sweeps_out),
        row_exit=_ptr(row_exit_out), slots_out=_ptr(slots_out),
        extra_out=_ptr(extra_sweeps_out), lists=lists.data_ptr(),
        state=_ptr(state),
        D=D, ld=cnts.shape[1], L=length, K=K, ldb=table.shape[1],
        cnts_bf16=int(cnts.dtype == torch.bfloat16),
        table_bf16=int(table.dtype == torch.bfloat16), list_blocks=list_blocks,
        inner_iterations=int(inner_iterations),
        threshold=float(convergence_threshold), eps=float(eps),
        patience=int(stall_patience),
        use_stall=int(stall_patience > 0 and convergence_threshold > 0.0),
    )
    # The scratch tensors may be freed once the launch is enqueued: the
    # caching allocator hands their memory out again only in stream order.
    with torch.cuda.device(dev):
        rc = kernel(ctypes.byref(p), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel.__name__} launch failed: cudaError {rc}")
    if geometry_out is not None:
        geometry_out.update({f: getattr(p, f) for f in GEOMETRY})
    return gamma, sweeps
