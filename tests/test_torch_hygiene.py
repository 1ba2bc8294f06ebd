"""Rules of the PyTorch port that hold on any machine.

- Nothing in ``pylda_tpu_torch/`` or ``chip_smoke.py`` imports JAX,
  jaxlib or the JAX package ``pylda_tpu`` (the module or its
  submodules; the port's own name merely starts with it).
- Without a CUDA device, entry points that were not asked for the CPU
  raise instead of running there.
- Every CUDA source the build names exists.
- The ctypes mirror of the gamma kernels' ``Params`` struct matches the
  struct in ``csrc/row_fixed_point.cuh``, field for field, and each
  Python mirror of a kernel constant its ``constexpr``.
"""

import ast
import ctypes
import pathlib
import re

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "pylda_tpu")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _port_files():
    return (sorted((REPO / "pylda_tpu_torch").rglob("*.py"))
            + sorted((REPO / "scripts").glob("torch_*.py"))
            + [REPO / "chip_smoke.py"])


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module):
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_forbidden_matcher():
    assert _forbidden("jax.numpy") and _forbidden("pylda_tpu.ops")
    assert _forbidden("pylda_tpu") and _forbidden("jaxlib")
    assert not _forbidden("pylda_tpu_torch.ops") and not _forbidden("jaxtyping")


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(REPO))
)
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_engine_without_device_raises_without_cuda(monkeypatch):
    from pylda_tpu_torch.models import (
        VariationalBayes,
        make_engine,
        state_from_numpy,
    )
    from pylda_tpu_torch.utils.config import LDAConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VariationalBayes(LDAConfig(number_of_topics=4))
    for mode in ("svi", "gibbs", "hybrid"):
        cfg = LDAConfig(number_of_topics=4, inference_mode=mode)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_engine(cfg)
        with pytest.raises(RuntimeError):
            make_engine(cfg, device="cuda")
        make_engine(cfg, device="cpu")
    with pytest.raises(RuntimeError):
        VariationalBayes(LDAConfig(number_of_topics=4), device="cuda")
    with pytest.raises(RuntimeError):
        state_from_numpy({"lam": [[1.0]], "alpha": [1.0], "eta": [1.0],
                          "step": 0})
    VariationalBayes(LDAConfig(number_of_topics=4), device="cpu")


def test_build_sources_exist():
    from pylda_tpu_torch.ops import _build

    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file(), name
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == set(_build.SOURCES)


def test_chip_smoke_refuses_without_cuda(monkeypatch, capsys):
    """No card: non-zero exit and no result line."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def _c_struct_fields(source: str, name: str):
    """(field, ctypes type) of a plain C struct of pointers, ints and
    floats, in declaration order."""
    body = source.split(f"struct {name} {{", 1)[1].split("};", 1)[0]
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        m = re.fullmatch(r"(?:const\s+)?(unsigned long long|int|float|void)"
                         r"\s*(.*)", decl, re.S)
        base, rest = m.groups()
        for part in rest.split(","):
            part = part.strip()
            if part.startswith("*"):
                fields.append((part.lstrip("* "), ctypes.c_void_p))
            else:
                fields.append((part, {"int": ctypes.c_int,
                                      "float": ctypes.c_float}[base]))
    return fields


def test_params_mirror_matches_the_kernel_struct():
    from pylda_tpu_torch.ops import _build, row_fixed_point

    src = (_build.CSRC / "row_fixed_point.cuh").read_text()
    want = _c_struct_fields(src, "Params")
    got = [(n, t) for n, t in row_fixed_point.Params._fields_]
    assert got == want
    assert len(want) > 20


# (module of pylda_tpu_torch.ops, its mirror, kernel source, constexpr)
_CONSTANT_MIRRORS = [
    ("row_fixed_point", "RESIDENT_TOPICS", "row_fixed_point.cuh", "kMaxTopics"),
    ("row_fixed_point", "THREADS", "row_fixed_point.cuh", "kThreads"),
    ("row_fixed_point", "MAX_HIST", "row_fixed_point.cuh", "kMaxHist"),
    ("row_fixed_point", "CLUSTER_Q", "row_fixed_point_tiled.cuh",
     "kClusterQ"),
    ("row_fixed_point", "GROUP_WARPS", "row_fixed_point_groups.cuh",
     "kGroupWarps"),
    ("row_fixed_point", "GROUPS", "row_fixed_point_groups.cuh", "kGroups"),
    ("row_fixed_point", "GROUP_MAX_TOPICS", "row_fixed_point_groups.cuh",
     "kGroupMaxTopics"),
    ("row_fixed_point", "GROUP_MAX_SLOTS", "row_fixed_point_groups.cuh",
     "kGroupMaxSlots"),
    ("row_fixed_point", "MAX_CLUSTER", "row_fixed_point_tiled.cuh",
     "kMaxCluster"),
    ("sstats", "THREADS", "dense_sstats.cu", "kThreads"),
    ("sstats", "TILE_V", "dense_sstats.cu", "kTileV"),
    ("sstats", "CHUNK_ROWS", "dense_sstats.cu", "kRows"),
    ("sstats", "WIDE_COLS", "dense_sstats.cu", "kWideCols"),
    ("sstats", "WIDE_NARROW_COLS", "dense_sstats.cu", "kWideNarrowCols"),
    ("sstats", "WIDE_LANE_FLOATS", "dense_sstats.cu", "kWideLaneFloats"),
    ("sstats", "WIDE_BOX", "dense_sstats.cu", "kWideBox"),
    ("sstats", "WIDE_COUNT_ROWS", "dense_sstats.cu", "kWideCountRows"),
    ("sstats", "WIDE_COUNT_BUFS", "dense_sstats.cu", "kWideCountBufs"),
    ("sstats", "WIDE_PUSH_CAP", "dense_sstats.cu", "kWidePushCap"),
    ("sstats", "WIDE_MAX_CLUSTER", "dense_sstats.cu", "kWideMaxCluster"),
    ("sstats", "WIDE_MAX_BATCH", "dense_sstats.cu", "kWideMaxBatch"),
    ("sstats", "MMA_TILE_V", "dense_sstats_mma.cuh", "kMmaTileV"),
    ("sstats", "MMA_ROWS", "dense_sstats_mma.cuh", "kMmaRows"),
    ("sstats", "MMA_BUFS", "dense_sstats_mma.cuh", "kMmaBufs"),
]


@pytest.mark.parametrize("module,name,source,const", _CONSTANT_MIRRORS,
                         ids=[m[1] for m in _CONSTANT_MIRRORS])
def test_constant_mirrors_match_the_kernels(module, name, source, const):
    """The Python planners' and the CPU emulations' copies of the
    kernels' constants equal the constants the kernels compile with."""
    import importlib

    from pylda_tpu_torch.ops import _build

    mod = importlib.import_module(f"pylda_tpu_torch.ops.{module}")
    src = (_build.CSRC / source).read_text()
    found = re.findall(rf"constexpr int {const} = (\d+);", src)
    assert found == [str(getattr(mod, name))], (name, found)
