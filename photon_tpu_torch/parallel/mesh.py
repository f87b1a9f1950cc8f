"""Device meshes, row shards and the deterministic fold.

Port of ``photon_tpu/parallel/mesh.py``. PyTorch has no single-controller
``jax.sharding.Mesh``; here a :class:`Mesh` is an ordered array of
``torch.device``s shaped by named axes:

  * ``data``    — batch rows (data parallelism; the gradient fold),
  * ``entity``  — random-effect entities (sharded lanes),
  * ``feature`` — coefficient dimension (``parallel/model_parallel.py``
    names its axis ``model``, as the JAX package does),
  * ``dcn``     — the outer, cross-process axis, listed first.

A mesh built by :func:`make_mesh` or :func:`make_multislice_mesh` lives in
one process. :func:`photon_tpu_torch.parallel.distributed.multihost_mesh`
spans a ``torch.distributed`` process group: its ``dcn`` axis has one entry
per process, and ``devices`` holds only this process's devices (the ``dcn``
extent of the array is 1).

A repeated device is accepted only when the caller passes ``devices``
explicitly — the counterpart of jax's forced host devices: the tests put 4
shards on the one CPU device, ``chip_smoke.py`` 4 shards on the one card. A
driver never builds such a mesh (``cli/params.mesh_from_flags`` takes
distinct visible cards).

Row sharding (:func:`pad_and_shard_batch`) pads the rows to the axis size
with weight-0 rows whose ELL indices are the ghost column ``dim``, cuts
contiguous row blocks in mesh order and moves each block to its device,
where it builds its own layouts (the CSC of the transposes, the matvec's
panels): the hand-written kernels run per shard. The JAX package strips its
aux tables before sharding (``strip_unshardable_aux``); here each shard owns
its own, so nothing is stripped.

The ``psum`` counterpart is :func:`fold`: each shard's partial (a value, a
gradient, an H·v) is copied to the mesh's first device and summed in shard
order in float64; across processes each process's folded partial is
``all_gather``ed and summed in rank order on every rank, so every rank
holds the same bits. No library-ordered ``all_reduce`` and no float
atomics. Only D-sized vectors and scalars cross devices; per-row margins
stay on their shard.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
ENTITY_AXIS = "entity"
FEATURE_AXIS = "feature"
DCN_AXIS = "dcn"

Tensor = torch.Tensor


def axis_tuple(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over an ordered array of devices.

    ``devices`` is this process's device array, shaped by the axis sizes
    (the ``process_axis``, when set, has extent 1 in it: its other entries
    live in the other processes of the group). ``processes`` is the size of
    that axis; ``rank`` is this process's index on it."""

    devices: np.ndarray
    axis_names: tuple
    process_axis: Optional[str] = None
    processes: int = 1
    rank: int = 0

    @property
    def shape(self) -> dict:
        out = dict(zip(self.axis_names, self.devices.shape))
        if self.process_axis is not None:
            out[self.process_axis] = self.processes
        return out

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    @property
    def local_devices(self) -> list:
        return list(self.devices.flat)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices={[str(d) for d in self.local_devices]}"
                + (f", rank={self.rank}" if self.process_axis else "") + ")")


def axes_size(mesh: Mesh, axis) -> int:
    """The number of shards over ``axis`` (one name or a tuple), across
    every process of the mesh."""
    shape = mesh.shape
    return int(np.prod([shape[a] for a in axis_tuple(axis)]))


def _as_devices(devices) -> list:
    """Devices with their index: ``cuda`` is the current card, so that a
    shard's device compares equal to its tensors'."""
    out = []
    for d in map(torch.device, devices):
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    return out


def visible_devices() -> list:
    """The visible cards, in order (the default of :func:`make_mesh`)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(axis_sizes: Optional[dict] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh from ``{axis: size}``; by default every visible card on
    ``data``. A device may repeat only in an explicit ``devices`` list."""
    explicit = devices is not None
    devs = _as_devices(devices) if explicit else visible_devices()
    if not devs:
        raise ValueError("make_mesh: no devices (no visible card; pass devices=)")
    if not explicit and len(set(devs)) != len(devs):  # pragma: no cover
        raise ValueError("make_mesh: visible devices repeat")
    if not axis_sizes:
        axis_sizes = {DATA_AXIS: len(devs)}
    names = tuple(axis_sizes)
    sizes = tuple(int(s) for s in axis_sizes.values())
    n = int(np.prod(sizes))
    if n != len(devs):
        raise ValueError(
            f"mesh wants {n} devices ({axis_sizes}) but {len(devs)} available")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(devices=arr.reshape(sizes), axis_names=names)


def make_multislice_mesh(n_slices: int, axis_sizes: Optional[dict] = None,
                         devices: Optional[Sequence] = None,
                         dcn_axis: str = DCN_AXIS) -> Mesh:
    """A 2-level mesh in one process: an outer ``dcn`` axis over slices
    (slowest-varying) and the given axes within each slice. Its fold sums
    each slice's shards, then the slices, in order: the same order as a
    flat fold over the mesh."""
    devs = _as_devices(devices) if devices is not None else visible_devices()
    if len(devs) % n_slices:
        raise ValueError(f"{len(devs)} devices not divisible by {n_slices} slices")
    per_slice = len(devs) // n_slices
    if not axis_sizes:
        axis_sizes = {DATA_AXIS: per_slice}
    inner = tuple(int(s) for s in axis_sizes.values())
    if int(np.prod(inner)) != per_slice:
        raise ValueError(
            f"inner axes {axis_sizes} want {int(np.prod(inner))} devices/slice, "
            f"have {per_slice}")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(devices=arr.reshape((n_slices,) + inner),
                axis_names=(dcn_axis,) + tuple(axis_sizes))


def shard_devices(mesh: Mesh, axis=DATA_AXIS) -> list:
    """This process's devices along ``axis`` (one name or a tuple), in mesh
    order: the other axes are taken at their first entry (the shards are
    replicated over them)."""
    axes = [a for a in axis_tuple(axis) if a != mesh.process_axis]
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"mesh {mesh.shape} has no axis {a!r}")
    order = [mesh.axis_names.index(a) for a in axes]
    rest = [i for i in range(len(mesh.axis_names)) if i not in order]
    arr = np.transpose(mesh.devices, order + rest)
    arr = arr.reshape(arr.shape[:len(order)] + (-1,))[..., 0]
    return list(np.asarray(arr).flat)


def spans_processes(mesh: Mesh, axis) -> bool:
    """True when ``axis`` includes the process axis of a multi-process
    mesh: its shards live in several processes and its fold crosses them."""
    return (mesh.process_axis is not None and mesh.processes > 1
            and mesh.process_axis in axis_tuple(axis))


# ---------------------------------------------------------------- the fold

# Seconds spent copying partials between devices and processes in folds
# (``chip_smoke.py`` reads it; the copies are device-to-device on cards).
FOLD_STATS = {"folds": 0, "copies": 0, "seconds": 0.0}


def reset_fold_stats() -> None:
    FOLD_STATS.update(folds=0, copies=0, seconds=0.0)


def fold(parts: Sequence[Tensor], mesh: Optional[Mesh] = None, axis=DATA_AXIS,
         device: Optional[torch.device] = None) -> Tensor:
    """Σ of per-shard partials, deterministic: on ``device`` (default the
    first part's), in float64, in shard order; then, where ``axis`` spans
    processes, every process's sum gathered and added in rank order. The
    result has the parts' dtype, on ``device``, and the same bits on every
    rank."""
    import time

    t0 = time.perf_counter()
    dev = parts[0].device if device is None else device
    dt = parts[0].dtype
    acc = None
    for p in parts:
        if p.device != dev:
            FOLD_STATS["copies"] += 1
        q = p.to(device=dev, dtype=torch.float64)
        acc = q if acc is None else acc + q
    if mesh is not None and spans_processes(mesh, axis):
        acc = _fold_processes(acc)
    FOLD_STATS["folds"] += 1
    FOLD_STATS["seconds"] += time.perf_counter() - t0
    return acc.to(dt)


def _fold_processes(local: Tensor) -> Tensor:
    """Every rank's ``local`` gathered (through the host where the backend
    is gloo, which has no CUDA all_gather) and summed in rank order."""
    import torch.distributed as dist

    world = dist.get_world_size()
    staged = local
    if dist.get_backend() == "gloo" and local.device.type != "cpu":
        staged = local.cpu()
    out = [torch.empty_like(staged) for _ in range(world)]
    dist.all_gather(out, staged.contiguous())
    FOLD_STATS["copies"] += world - 1
    acc = out[0]
    for t in out[1:]:
        acc = acc + t
    return acc.to(local.device)


# ------------------------------------------------------------ row sharding


@dataclasses.dataclass(frozen=True, eq=False)
class RowShards:
    """A batch (or bare features) cut into contiguous row blocks over a
    mesh axis: ``shards[i]`` lives on ``devices[i]``. ``n_rows`` is the
    true row count of the whole (every process's) batch, ``rows_per_shard``
    the block size after padding, ``first_shard`` this process's first
    global shard index."""

    shards: tuple
    devices: tuple
    mesh: Mesh
    axis: object
    n_rows: int
    rows_per_shard: int
    first_shard: int = 0

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def row_range(self, i: int) -> tuple[int, int]:
        """Global rows [lo, hi) of local shard ``i`` (padding included)."""
        lo = (self.first_shard + i) * self.rows_per_shard
        return lo, lo + self.rows_per_shard

    def with_offsets(self, offsets: Tensor) -> "RowShards":
        """The shards with ``offsets`` (the global [N] vector) cut to each
        block (zero on the padding rows): the per-step input of a
        coordinate-descent fixed effect, whose features never move."""
        outs = []
        for i, (b, dev) in enumerate(zip(self.shards, self.devices)):
            lo, hi = self.row_range(i)
            part = offsets[lo:min(hi, offsets.shape[0])]
            pad = hi - lo - part.shape[0]
            if pad:
                part = torch.cat([part, part.new_zeros(pad)])
            outs.append(b.with_offsets(part.to(device=dev, dtype=b.labels.dtype)))
        return dataclasses.replace(self, shards=tuple(outs))

    def matvec(self, w: Tensor) -> Tensor:
        """Scores of bare feature shards: each block's matvec on its
        device, the rows gathered on the first device in order and the
        padding dropped (this process's rows only)."""
        ws = replicate(w, self.devices)
        z = torch.cat([f.matvec(wi).to(self.device)
                       for f, wi in zip(self.shards, ws)])
        lo = self.first_shard * self.rows_per_shard
        return z[: max(0, min(z.shape[0], self.n_rows - lo))]


def replicate(w: Tensor, devices: Sequence) -> list:
    """``w`` on each of ``devices``: one copy per distinct device."""
    seen: dict = {}
    out = []
    for d in devices:
        if d not in seen:
            seen[d] = w if w.device == d else w.to(d)
        out.append(seen[d])
    return out


def _pad_rows(a: Tensor, rows: int, fill=0) -> Tensor:
    r = rows - a.shape[0]
    if r <= 0:
        return a
    return torch.cat([a, a.new_full((r,) + tuple(a.shape[1:]), fill)])


def pad_rows_to_multiple(obj, multiple: int):
    """Pad the row count to a multiple of ``multiple``: zero fill, except
    ELL indices, whose padded rows point at the ghost column ``dim``; a
    padded row of a ``LabeledBatch`` has weight 0 and adds nothing. Layouts
    attached to the input are dropped (each shard builds its own)."""
    from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures

    def padded(n):
        return -(-n // multiple) * multiple

    if isinstance(obj, SparseFeatures):
        n = padded(obj.n_rows)
        return SparseFeatures(idx=_pad_rows(obj.idx, n, obj.dim),
                              val=_pad_rows(obj.val, n), dim=obj.dim)
    if isinstance(obj, LabeledBatch):
        n = padded(obj.n_rows)
        return LabeledBatch(features=pad_rows_to_multiple(obj.features, multiple),
                            labels=_pad_rows(obj.labels, n),
                            offsets=_pad_rows(obj.offsets, n),
                            weights=_pad_rows(obj.weights, n))
    raise TypeError(f"cannot pad rows of {type(obj).__name__}")


def _rows(obj, lo: int, hi: int, device: torch.device):
    """Rows [lo, hi) of a (padded) batch or features, on ``device``."""
    from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures

    def cut(a):
        return a[lo:hi].to(device).contiguous()

    if isinstance(obj, SparseFeatures):
        return SparseFeatures(idx=cut(obj.idx), val=cut(obj.val), dim=obj.dim)
    return LabeledBatch(features=_rows(obj.features, lo, hi, device),
                        labels=cut(obj.labels), offsets=cut(obj.offsets),
                        weights=cut(obj.weights))


def shard_rows(obj, mesh: Mesh, axis=DATA_AXIS, *, layouts: str = "all",
               first_shard: Optional[int] = None,
               n_rows: Optional[int] = None) -> RowShards:
    """Cut ``obj`` (already padded to a multiple of this process's shard
    count) into contiguous row blocks, one per local shard of ``axis``,
    each moved to its device with its layouts built there (``layouts``:
    ``"all"`` the accelerator paths, ``"matvec"`` only the matvec's, for
    scoring)."""
    devices = shard_devices(mesh, axis)
    k = len(devices)
    n = obj.n_rows
    if n % k:
        raise ValueError(f"{n} rows do not divide over {k} shards")
    r = n // k
    shards = []
    for i, dev in enumerate(devices):
        s = _rows(obj, i * r, (i + 1) * r, dev)
        if layouts == "matvec":
            s = s.with_matvec_layout()
        else:
            s = s.with_accelerator_paths()
        shards.append(s)
    return RowShards(shards=tuple(shards), devices=tuple(devices), mesh=mesh,
                     axis=axis, n_rows=n if n_rows is None else n_rows,
                     rows_per_shard=r,
                     first_shard=0 if first_shard is None else first_shard)


def pad_and_shard_batch(batch, mesh: Mesh, axis=DATA_AXIS, *,
                        layouts: str = "all") -> RowShards:
    """The row-distribution preamble of training and scoring: pad the rows
    to the axis size, cut this process's block of them into its shards and
    build each shard's layouts on its device. ``batch`` is the whole batch
    (every process's rows, as a global array is in jax); a process keeps
    only its own block."""
    total = axes_size(mesh, axis)
    n_true = batch.n_rows
    padded = pad_rows_to_multiple(batch, total)
    first = 0
    if spans_processes(mesh, axis):
        local = len(shard_devices(mesh, axis))
        per_proc = padded.n_rows // mesh.processes
        first = mesh.rank * local
        padded = _slice_rows(padded, mesh.rank * per_proc,
                             (mesh.rank + 1) * per_proc)
    return shard_rows(padded, mesh, axis, layouts=layouts, first_shard=first,
                      n_rows=n_true)


# (features, weights, labels, mesh, axis) -> RowShards, most recent last:
# the shards of a coordinate-descent fixed effect are cut and their layouts
# built once per batch, not once per step or configuration.
_SHARD_CACHE: list = []
_SHARD_CACHE_SIZE = 4


def cached_row_shards(batch, mesh: Mesh, axis=DATA_AXIS) -> RowShards:
    """``pad_and_shard_batch(batch, mesh, axis)``, kept for the batch's
    features, weights and labels (by identity: a down-sampled batch is
    another) on this mesh; the caller re-cuts the offsets
    (``RowShards.with_offsets``)."""
    held = (batch.features, batch.weights, batch.labels, mesh)
    for entry in _SHARD_CACHE:
        if entry[2] == axis and all(a is b for a, b in zip(entry[0], held)):
            return entry[1]
    shards = pad_and_shard_batch(batch, mesh, axis)
    _SHARD_CACHE.append((held, shards, axis))
    del _SHARD_CACHE[:-_SHARD_CACHE_SIZE]
    return shards


def _slice_rows(obj, lo: int, hi: int):
    from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures

    if isinstance(obj, SparseFeatures):
        return SparseFeatures(idx=obj.idx[lo:hi], val=obj.val[lo:hi], dim=obj.dim)
    return LabeledBatch(features=_slice_rows(obj.features, lo, hi),
                        labels=obj.labels[lo:hi], offsets=obj.offsets[lo:hi],
                        weights=obj.weights[lo:hi])

