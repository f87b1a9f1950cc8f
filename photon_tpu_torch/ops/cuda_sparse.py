"""ELL sparse passes: the Hopper kernels, their wrappers and plain versions.

Port of ``photon_tpu/ops/pallas_sparse.py``. The TPU kernel there,
``_gather_onehot_kernel`` (launched by ``_run_op``), computes all three
sparse passes through ``matvec_pallas`` and ``rmatvec_pallas``; here they are
CUDA kernels in ``csrc/ell_sparse.cu``:

* ``ell_panel_matvec`` z[r] = Σ_k val[r,k]·w[idx[r,k]]          (scores)
  over a panel-sorted entry list (``build_panels``), w staged in shared
  memory one column panel at a time;
* ``ell_matvec``      the same sum straight from the ELL arrays, a stream
  of row tiles, for layouts where ``build_panels`` finds the panels not
  worth their reloads;
* ``csc_rmatvec``     g[c] = Σ_{entries of column c} val·v[row]  (gradient)
  with ``square=True`` the same sum with val² (Hessian diagonal).

The port keeps the function, not the TPU's 128-lane slot tables. The panel
matvec cuts rows into tiles and columns into panels that fit a shared-memory
stage, so its gathers of w hit shared memory instead of 32-byte L2 sectors.
The row-tile matvec streams tiles of whole rows into shared memory by bulk
copies and sums each row with a group of threads (``ell_tile_plan``).
The transpose reads a column-sorted entry list (``build_csc``) cut into
merge-path tiles of equal work, so a column of any length is summed by as
many blocks as its entries fill. Every sum runs in an order fixed by the
layout, with no float atomics — two runs give bit-identical results.

Values come as float32, float64 or bfloat16; the vector and the result are
float32 or float64, the values' own type, except that bfloat16 values go
with a float32 vector and give a float32 result (JAX's ``promote_types``):
each kernel has a ``*_bf16`` entry point that upcasts a value to float on
load (before squaring, in ``csc_sq_rmatvec``) and is bit-equal to its f32
form run on the upcast values. The plain versions upcast the same way.

Each wrapper checks device, dtype, shape and contiguity. A CPU tensor takes
the plain PyTorch version beside it; a CUDA tensor launches the kernel or
raises. ``LAUNCHES`` counts kernel launches per kernel, so a run can show
that its path went through the kernel.

The kernels build at first use with ``nvcc`` into ``photon_tpu_torch/_build``
(one shared library per source content, plain C interface, loaded with
``ctypes``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time

import torch

Tensor = torch.Tensor

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "ell_sparse.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

KERNELS = ("ell_panel_matvec", "ell_matvec", "csc_rmatvec", "csc_sq_rmatvec")
# The transposes over row panels (``csc_panel_rmatvec``): counted here, their
# float32 entry points, the bit-for-bit witness of the bf16 ones (no float32
# or float64 production route takes them).
PANEL_TRANSPOSES = ("csc_panel_rmatvec", "csc_sq_panel_rmatvec")
# Every kernel's bf16-value entry points, counted apart.
BF16_KERNELS = tuple(f"{name}_bf16" for name in KERNELS + PANEL_TRANSPOSES)
ALL_KERNELS = KERNELS + PANEL_TRANSPOSES + BF16_KERNELS
# Launches per kernel since the last reset_launch_counts(); a wrapper adds one
# where it launches its kernel and nowhere else.
LAUNCHES = {name: 0 for name in ALL_KERNELS}
_COUNT_LOCK = threading.Lock()
_LIB_LOCK = threading.Lock()
_LIB = None

_FLOAT_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# Stored value types, each with its kernels' entry-point suffix.
_VALUE_SUFFIX = {**_FLOAT_SUFFIX, torch.bfloat16: "bf16"}


def as_value_dtype(spec) -> torch.dtype:
    """A value dtype from a torch dtype or its name (``"bfloat16"``, as
    ``PHOTON_VALUE_DTYPE`` gives it); any other name raises ValueError."""
    if isinstance(spec, torch.dtype):
        return spec
    dt = getattr(torch, str(spec).removeprefix("torch."), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"unknown value dtype {spec!r}")
    return dt


def compute_dtype(value_dtype: torch.dtype) -> torch.dtype:
    """The type of the vectors and results that go with values stored as
    ``value_dtype``: float32 for bfloat16 values, else the values' own."""
    return torch.float32 if value_dtype == torch.bfloat16 else value_dtype


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for name in ALL_KERNELS:
            LAUNCHES[name] = 0


def launch_counts() -> dict:
    """Launches of every entry point (``ALL_KERNELS``) since the last
    reset."""
    with _COUNT_LOCK:
        return dict(LAUNCHES)


def _counted(name: str, value_dtype: torch.dtype) -> str:
    return f"{name}_bf16" if value_dtype == torch.bfloat16 else name


def _count(name: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


# ----------------------------------------------------------------- build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
            "photon_tpu_torch build at first use and need the CUDA toolkit"
        )
    return path


def library_path() -> str:
    """Where the build of the current source lives (content-addressed)."""
    with open(SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libell_sparse.{tag}.so")


def build_library() -> dict:
    """Compile ``csrc/ell_sparse.cu`` unless this source's build exists.

    Returns ``{"path", "built", "seconds", "log"}``; ``log`` is nvcc's output
    (``-Xptxas -v``: registers, shared memory and spills per kernel), also
    kept beside the library as ``<lib>.log``.
    """
    out = library_path()
    log_path = out + ".log"
    if os.path.exists(out):
        log = open(log_path).read() if os.path.exists(log_path) else ""
        return {"path": out, "built": False, "seconds": 0.0, "log": log}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{log}"
        )
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, out)
    return {"path": out, "built": True, "seconds": seconds, "log": log}


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build_library()["path"])
            vp, i64 = ctypes.c_void_p, ctypes.c_int64
            for sfx in ("f32", "f64", "bf16"):
                fn = getattr(lib, f"ell_matvec_{sfx}")
                fn.argtypes = [vp] * 4 + [i64] * 6 + [vp]
                fn.restype = ctypes.c_int
                fn = getattr(lib, f"ell_panel_matvec_{sfx}")
                fn.argtypes = [vp] * 5 + [i64] * 6 + [vp]
                fn.restype = ctypes.c_int
                for name in ("csc_rmatvec", "csc_sq_rmatvec"):
                    fn = getattr(lib, f"{name}_{sfx}")
                    fn.argtypes = [vp] * 8 + [i64] * 4 + [vp]
                    fn.restype = ctypes.c_int
            for sfx in ("f32", "bf16"):
                for name in PANEL_TRANSPOSES:
                    fn = getattr(lib, f"{name}_{sfx}")
                    fn.argtypes = [vp] * 9 + [i64] * 10 + [vp]
                    fn.restype = ctypes.c_int
            lib.ell_sparse_error_string.argtypes = [ctypes.c_int]
            lib.ell_sparse_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def _launch(name: str, dev: torch.device, fn, *args) -> None:
    """Call ``fn``, an entry point of kernel ``name``, with ``args`` and
    ``dev``'s current stream; raise on the CUDA error it returns and count
    the launch. The device switches only when ``dev`` is not the current
    one, and the stream is read as a raw pointer: a Stream object and a
    device guard cost more host time than a small kernel takes on the
    card."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index == torch.cuda.current_device():
        code = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            code = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if code != 0:
        msg = _lib().ell_sparse_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")
    _count(name)


# ----------------------------------------------------------------- checks


def _check_float(t: Tensor, what: str) -> None:
    if t.dtype not in _FLOAT_SUFFIX:
        raise TypeError(f"{what} must be float32 or float64, got {t.dtype}")


def _check_values(values: Tensor, vec: Tensor, what: str, vwhat: str) -> None:
    """Values of one of the three stored types, with a vector of their
    compute type: bfloat16 values take a float32 vector; float32 and
    float64 values a vector of their own type."""
    _check_float(vec, vwhat)
    if values.dtype not in _VALUE_SUFFIX:
        raise TypeError(f"{what} must be float32, float64 or bfloat16, got {values.dtype}")
    if vec.dtype != compute_dtype(values.dtype):
        raise TypeError(f"{vwhat} dtype {vec.dtype} does not go with {what} dtype "
                        f"{values.dtype} (bfloat16 values take a float32 {vwhat})")


def _check_same_device(*named) -> torch.device:
    dev = named[0][1].device
    for what, t in named[1:]:
        if t.device != dev:
            raise ValueError(f"{what} is on {t.device}, expected {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}: the kernels run on cuda")
    return dev


def _check_contiguous(*named) -> None:
    for what, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")


def _check_ell(idx: Tensor, val: Tensor, dim: int) -> None:
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if idx.dim() != 2 or val.shape != idx.shape:
        raise ValueError(
            f"idx and val must be [N, K] of one shape, got {tuple(idx.shape)} "
            f"and {tuple(val.shape)}"
        )
    if val.dtype not in _VALUE_SUFFIX:
        raise TypeError(f"val must be float32, float64 or bfloat16, got {val.dtype}")
    if dim < 0:
        raise ValueError(f"dim must be >= 0, got {dim}")


# ----------------------------------------------------------------- matvec


def ell_matvec_plain(idx: Tensor, val: Tensor, w: Tensor, dim: int) -> Tensor:
    """z = A·w over ELL arrays, as ``photon_tpu/data/batch.py`` computes it:
    gather through w extended by a zero ghost column. Entries whose column
    lies outside [0, dim) read the ghost and contribute 0. Sums in float64
    and rounds once to w's dtype, as the kernel does (bfloat16 values are
    upcast exactly, as the f32 path on the upcast values)."""
    w_ext = torch.cat([w, w.new_zeros(1)]).double()
    safe = torch.where((idx >= 0) & (idx < dim), idx, dim).long()
    return (w_ext[safe] * val.double()).sum(dim=-1).to(w.dtype)


def ell_rmatvec_plain(idx: Tensor, val: Tensor, v: Tensor, dim: int,
                      square: bool = False) -> Tensor:
    """g = Aᵀ·v (with ``square``, (A∘A)ᵀ·v) straight from the ELL arrays, as
    ``photon_tpu/data/batch.py``'s segment sum: each entry adds val·v[row]
    to its column; ghost and out-of-range entries land in the dropped ghost
    slot. Sums in float64 and rounds once, as the kernel does. The CPU
    version of ``csc_rmatvec`` where no CSC layout is attached."""
    x = val.double()          # upcast before squaring
    if square:
        x = x * x
    safe = torch.where((idx >= 0) & (idx < dim), idx, dim).long()
    out = torch.zeros(dim + 1, dtype=torch.float64, device=v.device)
    out.index_add_(0, safe.reshape(-1), (v.double()[:, None] * x).reshape(-1))
    return out[:dim].to(v.dtype)


# The row-tile matvec's block: ELL_THREADS threads, each loading up to
# ELL_ITEMS entries of its slice of a row at once (kEllThreads / kEllItems
# in ell_sparse.cu). A stage holds ELL_STAGE_ENTRIES entries (indices and
# values); the kernel keeps two.
ELL_THREADS = 256
ELL_ITEMS = 12
ELL_STAGE_ENTRIES = 4096
# What a block may hold in shared memory on an H100 (227 KB), less the
# kernel's static scratch (the two barriers and a double a warp) rounded up.
ELL_SMEM_LIMIT = 232448 - 1024


@dataclasses.dataclass(frozen=True)
class EllPlan:
    """How ``ell_matvec`` cuts an [N, K] ELL matrix: tiles of
    ``tile_rows`` rows, each row summed by ``group`` threads (each over a
    slice of ceil(K / group) entries), ``stage`` entries a shared-memory
    stage."""

    tile_rows: int
    group: int
    stage: int


def ell_group(k: int, items: int = ELL_ITEMS) -> int:
    """G, the threads that sum one row of K entries: the least power of
    two with G·items ≥ K, at most a block (``items`` is the kernel's
    ELL_ITEMS; ``tools/ell_ablation.py`` asks for others). It alone (with
    K) fixes the kernel's summation order."""
    need = max(-(-k // items), 1)
    return min(1 << (need - 1).bit_length(), ELL_THREADS)


def ell_smem_bytes(dtype: torch.dtype, stage: int = ELL_STAGE_ENTRIES) -> int:
    """The row-tile kernel's dynamic shared memory: two stages of indices
    and values, each array with 16 bytes for its run's offset in a line."""
    return 2 * (stage * (4 + torch.finfo(dtype).bits // 8) + 32)


@functools.lru_cache(maxsize=None)
def ell_tile_plan(k: int, dtype: torch.dtype, stage: int = ELL_STAGE_ENTRIES,
                  items: int = ELL_ITEMS) -> EllPlan:
    """The row-tile matvec's plan for rows of K entries in ``dtype``.

    R is the most rows whose R·K entries fit one stage, rounded down to a
    multiple of 4 / gcd(K, 4), so that a tile's run of indices (4 bytes an
    entry) and of values (4 or 8) is a multiple of 16 bytes and every tile
    of an aligned layout starts 16-byte aligned (a multiple of 8 / gcd(K,
    8) for 2-byte bfloat16 values; R does not enter the summation order,
    so the bf16 kernel stays bit-equal to the f32 one). A row longer than a
    quarter stage is a tile of its own, brought in stage-sized chunks.
    With ELL_STAGE_ENTRIES entries a tile, the tiles cover the H100's 132
    SMs wherever the matrix holds 132 stages of entries (132 rows, where a
    row is longer than a stage)."""
    if dtype not in _VALUE_SUFFIX:
        raise TypeError(f"dtype must be float32, float64 or bfloat16, got {dtype}")
    if k < 0:
        raise ValueError(f"K must be >= 0, got {k}")
    if stage < 4 or stage % 4 or ell_smem_bytes(dtype, stage) > ELL_SMEM_LIMIT:
        raise ValueError(f"a {stage}-entry stage of {dtype} does not fit")
    if k > stage // 4:
        rows = 1
    else:
        unit = 16 // min(4, torch.finfo(dtype).bits // 8)
        step = unit // math.gcd(k, unit)
        rows = stage // max(k, 1) // step * step
    return EllPlan(tile_rows=rows, group=ell_group(k, items), stage=stage)


def ell_matvec(idx: Tensor, val: Tensor, w: Tensor, dim: int) -> Tensor:
    """z[r] = Σ_k val[r,k]·w[idx[r,k]] — kernel ``ell_matvec`` on CUDA.

    ``idx [N, K]`` int32 (ghost column == dim, value 0), ``val [N, K]`` and
    ``w [dim]`` float32 or float64 of one dtype, or bfloat16 values with a
    float32 w → ``z [N]`` in w's dtype. Replaces
    ``matvec_pallas`` (photon_tpu/ops/pallas_sparse.py).

    Tiles of whole rows (``ell_tile_plan``) stream into shared memory by
    bulk copies; a group of ``ell_group(K)`` threads sums each row, each
    thread its contiguous slice in order in float64, the group by a fixed
    tree. The order depends on K alone: two runs give the same bits. Any
    contiguous input works, a row-sliced view at any offset included.
    """
    _check_ell(idx, val, dim)
    if w.dim() != 1 or w.shape[0] != dim:
        raise ValueError(f"w must be [{dim}], got {tuple(w.shape)}")
    _check_values(val, w, "val", "w")
    dev = _check_same_device(("idx", idx), ("val", val), ("w", w))
    _check_contiguous(("idx", idx), ("val", val), ("w", w))
    if dev.type == "cpu":
        return ell_matvec_plain(idx, val, w, dim)
    n, k = idx.shape
    z = torch.empty(n, dtype=w.dtype, device=dev)
    if n == 0:
        return z
    plan = ell_tile_plan(k, val.dtype)
    _launch(_counted("ell_matvec", val.dtype), dev,
            getattr(_lib(), f"ell_matvec_{_VALUE_SUFFIX[val.dtype]}"),
            idx.data_ptr(), val.data_ptr(), w.data_ptr(), z.data_ptr(),
            n, k, dim, plan.tile_rows, plan.group, plan.stage)
    return z


# ----------------------------------------------------------- panel matvec

# The panel kernel's chunk: PANEL_THREADS threads, each summing
# PANEL_ITEMS consecutive entries. PANEL_BYTES is one shared-memory stage of
# w. Must equal kPanelThreads / kPanelItems / kPanelBytes / kMaxTileRows /
# kPadRow in ell_sparse.cu; the launcher refuses other panel widths.
PANEL_THREADS = 1024
PANEL_ITEMS = 8
PANEL_BYTES = 64 * 1024
MIN_TILE_ROWS, MAX_TILE_ROWS = 1024, 8192
SEGMENT_ALIGN = 4            # entries: 16 bytes of codes
CODE_SHIFT = 16              # code = row in tile << 16 | column in panel
PAD_ROW = 0xFFFF             # row field of a skip entry (value 0)
H100_SMS = 132
L2_SECTOR_BYTES = 32
# Dynamic shared memory the panel kernel may ask for: the H100's 227 KB a
# block, less 16 KB kept for its static scan scratch (8.5 KB today).
PANEL_SMEM_BYTES = 232448 - 16 * 1024


def panel_cols(dtype: torch.dtype) -> int:
    """Columns of one panel: one shared-memory stage of w (16,384 in f32,
    8,192 in f64). Given a value dtype, the panel of its compute type (a
    bfloat16 layout stages a float32 w)."""
    if dtype not in _VALUE_SUFFIX:
        raise TypeError(f"dtype must be float32, float64 or bfloat16, got {dtype}")
    return PANEL_BYTES // (torch.finfo(compute_dtype(dtype)).bits // 8)


def tile_rows_for(n_rows: int) -> int:
    """Rows of one tile: the smallest power of two ≥ n_rows / 132, so that
    the tiles cover the H100's 132 SMs where n_rows allows, clamped to
    [1,024, 8,192] (a tile's double accumulators share the SM's shared
    memory with the two w stages)."""
    per_sm = -(-n_rows // H100_SMS)
    return min(max(1 << max(per_sm - 1, 0).bit_length(), MIN_TILE_ROWS),
               MAX_TILE_ROWS)


def panel_smem_bytes(tile_rows: int, n_panels: int) -> int:
    """The panel kernel's dynamic shared memory: two w stages, a float64
    accumulator a row and the tile's segment offsets."""
    return 2 * PANEL_BYTES + 8 * tile_rows + 8 * (n_panels + 1)


def panels_pay_off(n_rows: int, dim: int, nnz: int, itemsize: int) -> bool:
    """Whether staging w panel by panel moves fewer L2 bytes than gathering
    it: each tile reloads all of w, ceil(N/R)·dim·itemsize bytes, against
    one 32-byte sector per gathered entry, nnz·32 bytes. (And whether the
    tile fits the kernel's shared memory: dim up to ~39M f32 columns.)"""
    tile_rows = tile_rows_for(n_rows)
    n_tiles = -(-n_rows // tile_rows)
    n_panels = -(-dim // (PANEL_BYTES // itemsize))
    return (n_tiles * dim * itemsize < nnz * L2_SECTOR_BYTES
            and panel_smem_bytes(tile_rows, n_panels) <= PANEL_SMEM_BYTES)


@dataclasses.dataclass(frozen=True)
class PanelLayout:
    """An ELL matrix's entries sorted by (row tile, column panel), for the
    panel matvec.

    Rows are cut into tiles of ``tile_rows`` and columns into panels of
    ``panel_cols``. Segment (t, p) holds the entries of tile t's rows whose
    column falls in panel p, stable by row (a row's entries keep their ELL
    order), at ``offsets[t, p] : offsets[t, p + 1]`` (``[T, P+1]`` int64;
    ``offsets[t, P] == offsets[t + 1, 0]``). Each entry is one 32-bit code
    in ``codes`` (int32 storage), row in tile << 16 | column in panel, and
    its value in ``vals``. Every segment is padded with skip entries (row
    field ``PAD_ROW``, column 0, value 0) to a multiple of
    ``SEGMENT_ALIGN``, so that each starts 16-byte aligned. Ghost and
    out-of-range entries are dropped.
    """

    codes: Tensor
    vals: Tensor
    offsets: Tensor
    n_rows: int
    dim: int
    tile_rows: int
    panel_cols: int

    @property
    def n_tiles(self) -> int:
        return int(self.offsets.shape[0])

    @property
    def n_panels(self) -> int:
        return int(self.offsets.shape[1]) - 1

    @property
    def device(self) -> torch.device:
        return self.codes.device


def _pack_segments(seg: Tensor, sort_key: Tensor, code: Tensor, values: Tensor,
                   n_major: int, n_minor: int) -> tuple[Tensor, Tensor, Tensor]:
    """Entries sorted stably by ``sort_key`` (whose order refines their
    segment's, ``seg`` = major · n_minor + minor), each segment padded with
    skip entries (key field 0xFFFF, index 0, value 0) to a multiple of
    ``SEGMENT_ALIGN``: the packed codes (int32 storage of the uint32 codes),
    values and the ``[n_major, n_minor + 1]`` segment offsets
    (``offsets[t, n_minor] == offsets[t + 1, 0]``)."""
    dev = seg.device
    n_seg = n_major * n_minor
    order = torch.sort(sort_key, stable=True).indices
    seg = seg[order]
    counts = torch.bincount(seg, minlength=n_seg)
    padded = (counts + SEGMENT_ALIGN - 1) // SEGMENT_ALIGN * SEGMENT_ALIGN
    start = torch.zeros(n_seg + 1, dtype=torch.int64, device=dev)
    start[1:] = torch.cumsum(padded, 0)
    first = torch.zeros(n_seg + 1, dtype=torch.int64, device=dev)
    first[1:] = torch.cumsum(counts, 0)
    dest = start[seg] + torch.arange(seg.shape[0], device=dev) - first[seg]
    total = int(start[-1])
    codes = torch.full((total,), PAD_ROW << CODE_SHIFT, dtype=torch.int64, device=dev)
    codes[dest] = code[order]
    vals = torch.zeros(total, dtype=values.dtype, device=dev)
    vals[dest] = values[order]
    if n_seg:
        windows = (torch.arange(n_major, device=dev)[:, None] * n_minor
                   + torch.arange(n_minor + 1, device=dev))
        offsets = start[windows]
    else:
        offsets = torch.zeros((n_major, n_minor + 1), dtype=torch.int64, device=dev)
    codes = torch.where(codes >= 1 << 31, codes - (1 << 32), codes)   # as uint32
    return codes.to(torch.int32), vals, offsets.contiguous()


def _real_entries(idx: Tensor, dim: int) -> tuple[Tensor, Tensor, Tensor]:
    """The ELL entries whose column lies in [0, dim), in row-major order:
    their flat positions, rows and columns."""
    k = idx.shape[1]
    flat = idx.reshape(-1).long()
    pos = torch.nonzero((flat >= 0) & (flat < dim)).reshape(-1)
    return pos, pos // max(k, 1), flat[pos]


def panel_layout(idx: Tensor, val: Tensor, dim: int, tile_rows: int,
                 panel_cols: int) -> PanelLayout:
    """Sort the ELL entries into (tile, panel) segments, with torch ops on
    ``idx``'s device. Any ``tile_rows`` and ``panel_cols`` below 2^16 make a
    valid layout; the kernel takes ``tile_rows`` up to MAX_TILE_ROWS and
    only its own ``panel_cols(dtype)`` (``build_panels`` picks both)."""
    _check_ell(idx, val, dim)
    _check_same_device(("idx", idx), ("val", val))
    if not (1 <= tile_rows < PAD_ROW and 1 <= panel_cols <= 1 << CODE_SHIFT):
        raise ValueError(f"tile_rows {tile_rows} / panel_cols {panel_cols} "
                         "do not fit the 16-bit fields of a code")
    n = idx.shape[0]
    n_tiles = -(-n // tile_rows)
    n_panels = -(-dim // panel_cols)
    pos, rows, cols = _real_entries(idx, dim)
    seg = (rows // tile_rows) * n_panels + cols // panel_cols
    codes, vals, offsets = _pack_segments(
        seg, seg, (rows % tile_rows) << CODE_SHIFT | cols % panel_cols,
        val.reshape(-1)[pos], n_tiles, n_panels)
    return PanelLayout(
        codes=codes, vals=vals, offsets=offsets,
        n_rows=n, dim=dim, tile_rows=tile_rows, panel_cols=panel_cols,
    )


def build_panels(idx: Tensor, val: Tensor, dim: int) -> PanelLayout | None:
    """The panel layout at the kernel's own tile and panel sizes, or
    ``None`` where reloading w for every tile would cost more L2 bytes than
    the gathers it saves (``panels_pay_off``): the caller then keeps
    ``ell_matvec``. Built once per layout, on ``idx``'s device. Bfloat16
    values give the float32 layout (the same decision, tiles and panels:
    w is float32) with its values kept in bfloat16."""
    _check_ell(idx, val, dim)
    nnz = int(((idx >= 0) & (idx < dim)).sum())
    n = idx.shape[0]
    w_size = torch.finfo(compute_dtype(val.dtype)).bits // 8
    if n == 0 or not panels_pay_off(n, dim, nnz, w_size):
        return None
    return panel_layout(idx, val, dim, tile_rows_for(n), panel_cols(val.dtype))


def _decode(codes: Tensor, offsets: Tensor, key_tile: int,
            idx_panel: int) -> tuple[Tensor, Tensor, Tensor]:
    """Each stored entry of a segmented layout (segments (t, p) at
    ``offsets[t, p] : offsets[t, p + 1]``, codes key in tile << 16 | index
    in panel): its global key (t·key_tile + key), global index
    (p·idx_panel + index) and whether it is a real entry."""
    lengths = offsets.diff(dim=1).reshape(-1)
    seg = torch.repeat_interleave(torch.arange(lengths.shape[0], device=codes.device),
                                  lengths)
    code = codes.long() & 0xFFFFFFFF
    local_key, local_idx = code >> CODE_SHIFT, code & ((1 << CODE_SHIFT) - 1)
    real = local_key != PAD_ROW
    n_panels = max(int(offsets.shape[1]) - 1, 1)
    key = (seg // n_panels) * key_tile + local_key
    index = (seg % n_panels) * idx_panel + local_idx
    return key, index, real


def ell_panel_matvec_plain(panels: PanelLayout, w: Tensor) -> Tensor:
    """z = A·w from the panel layout's entries, decoded: a float64 segment
    sum by row, rounded once, as the kernel does."""
    row, col, real = _decode(panels.codes, panels.offsets, panels.tile_rows,
                             panels.panel_cols)
    prod = panels.vals.double()[real] * w.double()[col[real]]
    out = torch.zeros(panels.n_rows, dtype=torch.float64, device=w.device)
    out.index_add_(0, row[real], prod)
    return out.to(w.dtype)


def ell_panel_matvec(panels: PanelLayout, w: Tensor) -> Tensor:
    """z[r] = Σ_k val[r,k]·w[idx[r,k]] — kernel ``ell_panel_matvec`` on
    CUDA, over a layout from ``build_panels``. Replaces ``matvec_pallas``
    (photon_tpu/ops/pallas_sparse.py).

    One block per row tile: the panels of w come into shared memory by TMA
    bulk copies, each row's panel partial comes from a block segmented
    reduction, and one thread adds it to the row's float64 accumulator in
    panel order. Deterministic: the order depends only on the layout.
    """
    if w.dim() != 1 or w.shape[0] != panels.dim:
        raise ValueError(f"w must be [{panels.dim}], got {tuple(w.shape)}")
    _check_values(panels.vals, w, "panel values", "w")
    named = (("codes", panels.codes), ("vals", panels.vals),
             ("offsets", panels.offsets), ("w", w))
    dev = _check_same_device(*named)
    _check_contiguous(*named)
    if dev.type == "cpu":
        return ell_panel_matvec_plain(panels, w)
    if panels.panel_cols != panel_cols(w.dtype):
        raise ValueError(f"panel_cols {panels.panel_cols} is not the kernel's "
                         f"{panel_cols(w.dtype)} for {w.dtype}")
    if not 1 <= panels.tile_rows <= MAX_TILE_ROWS:
        raise ValueError(f"tile_rows {panels.tile_rows} outside [1, {MAX_TILE_ROWS}]")
    for what, t in named[:2] + named[3:]:
        if t.data_ptr() % 16:
            raise ValueError(f"{what} must be 16-byte aligned for the TMA copies")
    z = torch.empty(panels.n_rows, dtype=w.dtype, device=dev)
    if panels.n_rows == 0:
        return z
    _launch(_counted("ell_panel_matvec", panels.vals.dtype), dev,
            getattr(_lib(), f"ell_panel_matvec_{_VALUE_SUFFIX[panels.vals.dtype]}"),
            panels.codes.data_ptr(), panels.vals.data_ptr(),
            panels.offsets.data_ptr(), w.data_ptr(), z.data_ptr(),
            panels.n_rows, panels.dim, panels.tile_rows, panels.n_tiles,
            panels.n_panels, panels.panel_cols)
    return z


# ----------------------------------------------------------------- rmatvec

# The transpose kernel's tile: CSC_THREADS threads, each walking
# CSC_ITEMS_PER_THREAD consecutive merge-path items (column ends and
# entries). Must equal kCscThreads / kCscItemsPerThread in ell_sparse.cu;
# the launcher refuses any other tile size.
CSC_THREADS = 256
CSC_ITEMS_PER_THREAD = 4
TILE_ITEMS = CSC_THREADS * CSC_ITEMS_PER_THREAD


@dataclasses.dataclass(frozen=True)
class CscLayout:
    """Column-sorted entry list of an ELL matrix, for the transpose pass.

    ``colptr [dim+1]`` int64: column c owns entries ``colptr[c]:colptr[c+1]``;
    ``rows [nnz]`` int32 and ``vals [nnz]``: each entry's row and value,
    stable by column (within a column, entries keep their row-major ELL
    order). Ghost and out-of-range entries are dropped.

    ``tiles [T+1, 2]`` and ``splits [S, 3]`` int64 are the kernel's
    merge-path partition (``merge_path_tiles``, ``split_columns``), built
    once with the layout on its device.
    """

    colptr: Tensor
    rows: Tensor
    vals: Tensor
    n_rows: int
    dim: int
    tiles: Tensor
    splits: Tensor

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def device(self) -> torch.device:
        return self.rows.device


def merge_path_tiles(colptr: Tensor) -> Tensor:
    """Cut the merge of column ends and entries into tiles of equal work.

    Merge-path (Merrill and Garland, SC'16) over ``dim + nnz`` items: column
    c's end sits at merged position ``colptr[c+1] + c``, after its entries.
    Tile t covers positions ``[t·TILE_ITEMS, (t+1)·TILE_ITEMS)``; row t of
    the result is its start coordinate (columns ended, entries consumed)
    and the last row is ``(dim, nnz)``. ``[T+1, 2]`` int64 on colptr's
    device; T = ceil((dim + nnz) / TILE_ITEMS).
    """
    dim = colptr.shape[0] - 1
    nnz = int(colptr[-1])
    total = dim + nnz
    n_tiles = -(-total // TILE_ITEMS)
    dev = colptr.device
    k = torch.clamp(torch.arange(n_tiles + 1, device=dev) * TILE_ITEMS, max=total)
    ends = colptr[1:] + torch.arange(dim, device=dev)
    col = torch.searchsorted(ends, k)
    return torch.stack([col, k - col], dim=1).contiguous()


def split_columns(colptr: Tensor, tiles: Tensor) -> Tensor:
    """The columns that cross a tile boundary, one row ``(c, a, h)`` each:
    column c ends in tile h and began in an earlier tile; tiles a..h-1 each
    hold a partial sum of it (their tail). ``[S, 3]`` int64."""
    start_col, start_entry = tiles[:-1, 0], tiles[:-1, 1]
    end_col = tiles[1:, 0].contiguous()
    safe = torch.clamp(start_col, max=colptr.shape[0] - 2)
    heads = torch.nonzero(
        (end_col > start_col) & (colptr[safe] < start_entry)
    ).reshape(-1)
    cols = start_col[heads]
    first = torch.searchsorted(end_col, cols)
    return torch.stack([cols, first, heads], dim=1).contiguous()


def build_csc(idx: Tensor, val: Tensor, dim: int) -> CscLayout:
    """Build the column-sorted entry list on the host (once per dataset),
    place it on ``idx``'s device and partition it there. Stable by column,
    as ``photon_tpu/ops/fast_sparse.py``'s column-sorted table."""
    _check_ell(idx, val, dim)
    _check_same_device(("idx", idx), ("val", val))
    n, k = idx.shape
    if n >= 2**31:
        raise ValueError(f"{n} rows exceed the int32 row ids of the CSC list")
    flat = idx.detach().cpu().reshape(-1).long()
    keep = (flat >= 0) & (flat < dim)
    cols = flat[keep]
    rows = torch.arange(n, dtype=torch.int32).repeat_interleave(k)[keep]
    vals = val.detach().cpu().reshape(-1)[keep]
    order = torch.sort(cols, stable=True).indices
    colptr = torch.zeros(dim + 1, dtype=torch.int64)
    colptr[1:] = torch.cumsum(torch.bincount(cols, minlength=dim), 0)
    dev = idx.device
    colptr = colptr.to(dev)
    tiles = merge_path_tiles(colptr)
    return CscLayout(
        colptr=colptr,
        rows=rows[order].contiguous().to(dev),
        vals=vals[order].contiguous().to(dev),
        n_rows=n,
        dim=dim,
        tiles=tiles,
        splits=split_columns(colptr, tiles),
    )


def csc_rmatvec_plain(csc: CscLayout, v: Tensor, square: bool = False) -> Tensor:
    """g = Aᵀ·v (with ``square``, (A∘A)ᵀ·v) as a segment sum of per-entry
    contributions by column, as ``photon_tpu/data/batch.py`` computes it.
    Sums in float64 and rounds once, as the kernel does; bfloat16 values
    upcast first, and square after."""
    cols = torch.repeat_interleave(
        torch.arange(csc.dim, device=csc.device), csc.colptr.diff()
    )
    x = csc.vals.double()
    if square:
        x = x * x
    out = torch.zeros(csc.dim, dtype=torch.float64, device=v.device)
    out.index_add_(0, cols, v.double()[csc.rows.long()] * x)
    return out.to(v.dtype)


def csc_rmatvec(csc: CscLayout, v: Tensor, square: bool = False) -> Tensor:
    """g[c] = Σ_{entries of column c} val·v[row] (val² with ``square``) —
    kernels ``csc_rmatvec`` / ``csc_sq_rmatvec`` on CUDA. Replaces
    ``rmatvec_pallas`` (photon_tpu/ops/pallas_sparse.py).

    One block per merge-path tile of ``csc.tiles``, so no block's work
    depends on a column's length; columns split across tiles are finished
    by a second launch over ``csc.splits`` from float64 partials in a
    scratch buffer allocated here. Deterministic: the summation order
    depends only on the layout and the tile size, and no atomics are used.
    """
    if v.dim() != 1 or v.shape[0] != csc.n_rows:
        raise ValueError(f"v must be [{csc.n_rows}], got {tuple(v.shape)}")
    _check_values(csc.vals, v, "CSC values", "v")
    named = (("colptr", csc.colptr), ("rows", csc.rows), ("vals", csc.vals),
             ("tiles", csc.tiles), ("splits", csc.splits), ("v", v))
    dev = _check_same_device(*named)
    _check_contiguous(*named)
    if dev.type == "cpu":
        return csc_rmatvec_plain(csc, v, square)
    name = "csc_sq_rmatvec" if square else "csc_rmatvec"
    g = torch.empty(csc.dim, dtype=v.dtype, device=dev)
    if csc.dim == 0:
        return g
    n_tiles, n_splits = csc.tiles.shape[0] - 1, csc.splits.shape[0]
    partials = torch.empty(2 * n_tiles, dtype=torch.float64, device=dev)
    _launch(_counted(name, csc.vals.dtype), dev,
            getattr(_lib(), f"{name}_{_VALUE_SUFFIX[csc.vals.dtype]}"),
            csc.colptr.data_ptr(), csc.rows.data_ptr(),
            csc.vals.data_ptr(), v.data_ptr(), csc.tiles.data_ptr(),
            csc.splits.data_ptr(), partials.data_ptr(), g.data_ptr(),
            n_tiles, n_splits, csc.n_rows, TILE_ITEMS)
    return g


# ------------------------------------------------- transpose over row panels

# The row-panel transpose (``csc_panel_rmatvec``): a panel is one
# shared-memory stage of the float32 v (PANEL_ROWS rows), a tile at most
# MAX_TILE_COLS columns (kMaxTileCols in ell_sparse.cu; a double accumulator
# a column beside the two stages). A segment of fewer than STAGE_MIN
# entries gathers v from device memory instead of staging its panel
# (kStageMin). The segments are cut into one run a block (one block an
# SM), each of about the same work in units of one entry: a segment costs
# SEGMENT_COST more, a band BAND_COST, and an entry of a run of LONG_RUN
# or more entries of one column in a segment (an intercept's)
# LONG_RUN_COST more (a fit to per-block times measured on an H100); no
# block is given under MIN_BLOCK_WORK. Each run is cut into
# bands at the tiles' edges and every MAX_BAND_PANELS panels (a band's
# offsets sit in shared memory).
PANEL_ROWS = PANEL_BYTES // 4
MAX_TILE_COLS = 8192
STAGE_MIN = PANEL_BYTES // L2_SECTOR_BYTES
PAD_COL = PAD_ROW            # column field of a skip entry (value 0)
SEGMENT_COST = 16384
BAND_COST = 10240
LONG_RUN, LONG_RUN_COST = 1024, 0.7
MIN_BLOCK_WORK = 4 * PANEL_THREADS * PANEL_ITEMS
MAX_BAND_PANELS = 2048


def tile_cols_for(dim: int) -> int:
    """Columns of one transpose tile: MAX_TILE_COLS (the fewest tiles, so
    the fewest reloads of v), or all of a narrower matrix's."""
    return max(1, min(MAX_TILE_COLS, dim))


def transpose_smem_bytes(tile_cols: int, band_panels: int) -> int:
    """The row-panel transpose's dynamic shared memory: two v stages, a
    float64 accumulator a column and the band's segment offsets."""
    return 2 * PANEL_BYTES + 8 * tile_cols + 8 * (band_panels + 1)


def transpose_panels_pay_off(n_rows: int, dim: int, nnz: int,
                             segments: int | None = None) -> bool:
    """Whether the row-panel transpose should take a layout from the
    merge path, from L2 bytes and shared memory:

    * the blocks fill the card: nnz ≥ 132 · MIN_BLOCK_WORK. Below that the
      one-block-an-SM panel kernel leaves SMs idle, where the merge path's
      small blocks (8 an SM) spread any layout over every SM;
    * a tile's own costs are paid off: at least PANEL_ROWS entries a tile.
      Each tile's band clears and flushes C float64 accumulators in shared
      memory and waits for its first panel of v, where the merge path pays
      one merge item a column (at fit C's lanes, ~8,000 entries a tile of
      8,192 columns, the panel kernel ran 2.1x the merge path's time);
    * staging v moves fewer L2 bytes than the merge path's gathers: each
      non-empty (tile, panel) segment reloads its panel of v (``segments``;
      every tile's every panel where not given) and each block's two cut
      tiles write and read a float64 partial row, against one 32-byte
      sector per gathered entry, nnz · 32 bytes;
    * a band's tile fits the kernel's shared memory."""
    if n_rows < 1 or dim < 1:
        return False
    cols = tile_cols_for(dim)
    n_tiles = -(-dim // cols)
    n_panels = -(-n_rows // PANEL_ROWS)
    if segments is None:
        segments = n_tiles * n_panels
    reload = segments * min(n_rows, PANEL_ROWS) * 4
    split = 2 * 2 * H100_SMS * cols * 8
    return (nnz >= H100_SMS * MIN_BLOCK_WORK
            and nnz >= n_tiles * PANEL_ROWS
            and reload + split < nnz * L2_SECTOR_BYTES
            and transpose_smem_bytes(cols, min(n_panels, MAX_BAND_PANELS))
            <= PANEL_SMEM_BYTES)


@dataclasses.dataclass(frozen=True)
class RowPanelLayout:
    """An ELL matrix's entries sorted by (column tile, row panel), for the
    transpose over row panels.

    Columns are cut into tiles of ``tile_cols`` and rows into panels of
    ``panel_rows``. Segment (t, p) holds the entries of tile t's columns
    whose row falls in panel p, sorted by (column, row) and stable (a row's
    duplicates keep their ELL order), at ``offsets[t, p] : offsets[t, p +
    1]`` (``[T, P+1]`` int64). Each entry is one 32-bit code in ``codes``
    (int32 storage), column in tile << 16 | row in panel, and its value in
    ``vals``; every segment is padded with skip entries (column field
    ``PAD_COL``, row 0, value 0) to a multiple of ``SEGMENT_ALIGN``. Ghost
    and out-of-range entries are dropped.

    ``bands [B, 4]`` int64 in (tile, panel) order: (tile, first panel, end
    panel, slot), slot -1 for a band that holds its whole tile, else the
    band's row of float64 partials; block b of the kernel takes bands
    ``starts[b] : starts[b + 1]`` (``[G + 1]`` int64). ``fixups [F, 3]``
    (tile, first slot, bands) for each tile cut into several bands, summed
    in band order. ``n_slots`` partial rows in all; ``max_band_panels`` the
    longest band.
    """

    codes: Tensor
    vals: Tensor
    offsets: Tensor
    bands: Tensor
    starts: Tensor
    fixups: Tensor
    n_rows: int
    dim: int
    tile_cols: int
    panel_rows: int
    n_slots: int
    max_band_panels: int

    @property
    def n_tiles(self) -> int:
        return int(self.offsets.shape[0])

    @property
    def n_panels(self) -> int:
        return int(self.offsets.shape[1]) - 1

    @property
    def device(self) -> torch.device:
        return self.codes.device


def transpose_bands(offsets: Tensor, long_entries: Tensor | None = None) -> dict:
    """Cut the segments, in (tile, panel) order, into one run a block of
    about the same work (entries, plus ``SEGMENT_COST`` a non-empty
    segment, ``BAND_COST`` a tile and ``LONG_RUN_COST`` each of a
    segment's ``long_entries``, ``[T, P]``; at most 132 blocks, one an
    SM, each at least ``MIN_BLOCK_WORK``), and each run into bands at the
    tiles' edges and every ``MAX_BAND_PANELS`` panels. Returns
    ``RowPanelLayout``'s ``bands``, ``starts``, ``fixups``, ``n_slots`` and
    ``max_band_panels``. With torch ops on ``offsets``' device."""
    dev = offsets.device
    n_tiles, n_panels = int(offsets.shape[0]), int(offsets.shape[1]) - 1
    i64 = dict(dtype=torch.int64, device=dev)
    n_seg = n_tiles * n_panels
    if n_seg == 0:     # no rows or no columns: each tile (if any) one empty band
        tiles = torch.arange(n_tiles, **i64)
        bands = torch.stack([tiles, tiles * 0, tiles * 0, tiles * 0 - 1], 1)
        return {"bands": bands.contiguous(), "starts": torch.tensor([0, n_tiles], **i64),
                "fixups": torch.zeros((0, 3), **i64), "n_slots": 0, "max_band_panels": 0}
    counts = offsets.diff(dim=1).reshape(-1)
    cost = counts + torch.where(counts > 0, SEGMENT_COST, 0)
    if long_entries is not None:
        cost += (long_entries.reshape(-1).double() * LONG_RUN_COST).long()
    cost[::n_panels] += BAND_COST
    before = torch.cumsum(cost, 0) - cost
    total = int(cost.sum())
    blocks = max(1, min(H100_SMS, total // MIN_BLOCK_WORK))
    # block k's run starts at the first segment with k/blocks of the work before it
    firsts = torch.searchsorted(before, torch.arange(blocks, **i64) * total // blocks)
    firsts = firsts.clamp(max=n_seg - 1)
    firsts[0] = 0
    seg = torch.arange(n_seg, **i64)
    cut = (seg % n_panels) % MAX_BAND_PANELS == 0
    cut[firsts] = True
    start = torch.nonzero(cut).reshape(-1)
    length = torch.diff(start, append=torch.tensor([n_seg], **i64))
    tile, p_lo = start // n_panels, start % n_panels
    per = torch.bincount(tile, minlength=n_tiles)
    split = per[tile] >= 2
    slot = torch.where(split, torch.cumsum(split.long(), 0) - 1, -1)
    heads = torch.nonzero(split & (p_lo == 0)).reshape(-1)
    block = torch.searchsorted(firsts, start, right=True) - 1
    return {"bands": torch.stack([tile, p_lo, p_lo + length, slot], 1).contiguous(),
            "starts": torch.searchsorted(block, torch.arange(blocks + 1, **i64)),
            "fixups": torch.stack([tile[heads], slot[heads], per[tile[heads]]], 1)
            .contiguous(),
            "n_slots": int(split.sum()), "max_band_panels": int(length.max())}


def row_panel_layout(idx: Tensor, val: Tensor, dim: int) -> RowPanelLayout:
    """Sort the ELL entries into (column tile, row panel) segments, tiles of
    ``tile_cols_for(dim)`` columns, and cut them into the blocks' bands
    (``transpose_bands``), with torch ops on ``idx``'s device (a sort of
    the entries, no host copy of them)."""
    _check_ell(idx, val, dim)
    _check_same_device(("idx", idx), ("val", val))
    cols_t = tile_cols_for(dim)
    n = idx.shape[0]
    if n >= 2**31:
        raise ValueError(f"{n} rows exceed the kernel's int32 panel arithmetic")
    n_tiles = -(-dim // cols_t)
    n_panels = -(-n // PANEL_ROWS)
    pos, rows, cols = _real_entries(idx, dim)
    seg = (cols // cols_t) * n_panels + rows // PANEL_ROWS
    local = rows % PANEL_ROWS
    pair = seg * cols_t + cols % cols_t
    codes, vals, offsets = _pack_segments(
        seg, pair, (cols % cols_t) << CODE_SHIFT | local,
        val.reshape(-1)[pos], n_tiles, n_panels)
    # each segment's entries in runs of LONG_RUN or more of one column
    runs, lengths = torch.unique(pair, return_counts=True)
    long = lengths >= LONG_RUN
    long_entries = torch.zeros(n_tiles * n_panels, dtype=torch.int64, device=idx.device)
    long_entries.index_add_(0, runs[long] // cols_t, lengths[long])
    return RowPanelLayout(codes=codes, vals=vals, offsets=offsets, n_rows=n, dim=dim,
                          tile_cols=cols_t, panel_rows=PANEL_ROWS,
                          **transpose_bands(offsets, long_entries))


def transpose_route(idx: Tensor, val: Tensor, dim: int) -> str:
    """The route rule of the transposes: ``"panel"`` for bfloat16 values
    where ``transpose_panels_pay_off`` finds the row panels pay (counting
    this layout's non-empty segments, on ``idx``'s device), else
    ``"merge"`` (the float32 and float64 transposes keep the merge path)."""
    if val.dtype != torch.bfloat16:
        return "merge"
    tile = tile_cols_for(dim)
    pos, rows, cols = _real_entries(idx, dim)
    n_panels = -(-idx.shape[0] // PANEL_ROWS)
    n_seg = -(-dim // tile) * n_panels
    seg = (cols // tile) * n_panels + rows // PANEL_ROWS
    segments = int(torch.count_nonzero(torch.bincount(seg, minlength=n_seg)))
    pays = transpose_panels_pay_off(idx.shape[0], dim, int(pos.numel()), segments)
    return "panel" if pays else "merge"


def build_transpose(idx: Tensor, val: Tensor, dim: int) -> CscLayout | RowPanelLayout:
    """The transposes' layout, where ``transpose_route`` sends these values:
    ``row_panel_layout`` for the transpose over row panels, else
    ``build_csc``'s column-sorted list for the merge path."""
    _check_ell(idx, val, dim)
    if transpose_route(idx, val, dim) == "panel":
        return row_panel_layout(idx, val, dim)
    return build_csc(idx, val, dim)


def csc_panel_rmatvec_plain(layout: RowPanelLayout, v: Tensor,
                            square: bool = False) -> Tensor:
    """g = Aᵀ·v (with ``square``, (A∘A)ᵀ·v) from the row-panel layout's
    entries, decoded: a float64 segment sum by column, rounded once, as the
    kernel does (bfloat16 values upcast first, and square after)."""
    col, row, real = _decode(layout.codes, layout.offsets, layout.tile_cols,
                             layout.panel_rows)
    x = layout.vals.double()[real]
    if square:
        x = x * x
    out = torch.zeros(layout.dim, dtype=torch.float64, device=v.device)
    out.index_add_(0, col[real], x * v.double()[row[real]])
    return out.to(v.dtype)


def csc_panel_rmatvec(layout: RowPanelLayout, v: Tensor, square: bool = False) -> Tensor:
    """g[c] = Σ_{entries of column c} val·v[row] (val² with ``square``) —
    kernels ``csc_panel_rmatvec`` / ``csc_sq_panel_rmatvec`` on CUDA, over a
    layout from ``row_panel_layout``, for float32 or bfloat16 values with a
    float32 v. Replaces ``rmatvec_pallas`` (photon_tpu/ops/pallas_sparse.py)
    where ``build_transpose`` routes a layout here.

    Persistent blocks, each over its run of bands: a band's panels of v
    come into shared memory by TMA bulk copies, each column's panel partial
    comes from a block segmented reduction, and one thread adds it to the
    column's float64 accumulator in panel order; the bands of a tile cut
    between blocks are summed in band order by a second launch, from
    float64 partials in a scratch buffer allocated here. Deterministic: the
    order depends only on the layout.
    """
    if v.dim() != 1 or v.shape[0] != layout.n_rows:
        raise ValueError(f"v must be [{layout.n_rows}], got {tuple(v.shape)}")
    _check_values(layout.vals, v, "panel values", "v")
    named = (("codes", layout.codes), ("vals", layout.vals),
             ("offsets", layout.offsets), ("bands", layout.bands),
             ("starts", layout.starts), ("fixups", layout.fixups), ("v", v))
    dev = _check_same_device(*named)
    _check_contiguous(*named)
    if dev.type == "cpu":
        return csc_panel_rmatvec_plain(layout, v, square)
    if v.dtype != torch.float32:
        raise TypeError(f"the row-panel transpose takes float32 or bfloat16 values "
                        f"with a float32 v, got {layout.vals.dtype} values")
    if layout.panel_rows != PANEL_ROWS or not 1 <= layout.tile_cols <= MAX_TILE_COLS:
        raise ValueError(f"panel_rows {layout.panel_rows} / tile_cols "
                         f"{layout.tile_cols} are not the kernel's")
    if transpose_smem_bytes(layout.tile_cols, layout.max_band_panels) > PANEL_SMEM_BYTES:
        raise ValueError(f"a band of {layout.max_band_panels} panels over "
                         f"{layout.tile_cols} columns does not fit shared memory")
    for what, t in (named[0], named[1], named[6]):
        if t.data_ptr() % 16:
            raise ValueError(f"{what} must be 16-byte aligned for the TMA copies")
    g = torch.empty(layout.dim, dtype=torch.float32, device=dev)
    if layout.dim == 0:
        return g
    if layout.n_rows == 0:
        return g.zero_()
    partials = torch.empty(max(layout.n_slots, 1) * layout.tile_cols,
                           dtype=torch.float64, device=dev)
    name = "csc_sq_panel_rmatvec" if square else "csc_panel_rmatvec"
    _launch(_counted(name, layout.vals.dtype), dev,
            getattr(_lib(), f"{name}_{_VALUE_SUFFIX[layout.vals.dtype]}"),
            layout.codes.data_ptr(), layout.vals.data_ptr(),
            layout.offsets.data_ptr(), layout.bands.data_ptr(),
            layout.starts.data_ptr(), layout.fixups.data_ptr(), v.data_ptr(),
            g.data_ptr(), partials.data_ptr(), layout.n_rows, layout.dim,
            layout.tile_cols, layout.n_tiles, layout.n_panels, layout.panel_rows,
            int(layout.bands.shape[0]), int(layout.starts.shape[0]) - 1,
            int(layout.fixups.shape[0]), layout.max_band_panels)
    return g
