"""Out-of-core fixed-effect training: host-resident row chunks streamed to
the device every pass.

Port of ``photon_tpu/optim/out_of_core.py``. A dataset too large for the
card's memory stays on the host, cut into fixed-shape row chunks; every
optimizer pass copies the chunks to the device one after another and runs
the sparse kernels on each. Everything O(rows) or O(dim) stays on the
device: labels, offsets and weights per chunk, the margins z = Xw + offsets,
the direction's margins, w, the gradient and the L-BFGS history. Line-search
probes are elementwise over the resident margins, never a data pass, so an
L-BFGS iteration is 2 streamed passes (the direction's matvec and the
gradient's rmatvec), as in the JAX package; ``data_passes`` counts them
alike.

The port's gradient runs ``csc_rmatvec`` over a column-sorted layout, which
the host sorts (``build_csc``). A chunk builds it once, when it is made:
each ``HostChunk`` holds both layouts, ELL (``idx``/``val``) for the matvec
and CSC (``colptr``/``rows``/``vals`` and the merge-path ``tiles``/
``splits``) for the rmatvec, in page-locked host memory when the data feed
a card. A pass copies only the layout it reads. Chunk i+1's copies run on
a copy stream while chunk i computes (``_Feeder``, as
``io/prefetch.py``'s ``iter_chunks_pipelined``); with a
``data/device_cache.py`` sweep cache a chunk that fits stays on the device
after its first copy. ``streamed_bytes_per_pass`` reports each layout's
bytes.

The solver loops are the JAX module's, line for line, over the
single-lane pieces of ``optim/lanes.py`` (the two-loop recursion, the
history push, the orthant pseudo-gradient) and ``optim/base.py``'s
convergence test, with the same Armijo constants: out-of-core reaches the
in-core optimum. They run in the data's dtype (float32, or float64 for
parity tests; the JAX module is float32 only). Values may be stored as
bfloat16 (``value_dtype``, ``PHOTON_VALUE_DTYPE`` in the GLM driver).

Checkpoints are the port's own file (``_MAGIC`` + CRC32 + an ``.npz``
payload), guarded by a fingerprint of problem and data as JAX's
``_ckpt_tag``; unlike JAX's they hold the resident margins too, so a resumed
solve is bit-identical to an uninterrupted one (no score-rebuild pass). A
file of another format (a JAX checkpoint) is never read: the solve starts
fresh, with a warning.

Recovery (``runtime/``): an ``oom``-classified failure of a solve (a real
``torch.cuda.OutOfMemoryError``, or ``device_oom`` injected at the
``optim.ooc_chunk`` fault point, hit once per streamed ELL chunk) halves
``chunk_rows`` (``ChunkedGLMData.rechunk``), drops the old cut's sweep-cache
pins and re-enters; bounded by ``PHOTON_OOM_MAX_DOWNSHIFTS``, journaled,
counted in ``oom_downshifts_total{site="optim.ooc_chunk"}``. The re-cut
solve starts its loop again (the checkpoint fingerprint covers the chunking)
and equals, bit for bit, a solve started at the halved cut. A classified
device loss (``device_lost`` at ``optim.ooc_iteration``, the top of every
iteration) releases the caches, proves the CUDA context with a tiny op and
re-enters, resuming from the solver's checkpoint, or re-running the
deterministic loop without one: bit-identical either way; bounded by
``PHOTON_DEVICE_LOST_MAX_RECOVERIES``. A poisoned context ends the solve
instead (``DeviceContextLost``). Both leave the ``except`` block before
they retry, so the failed attempt's tensors are freed first.

Not ported: meshes (``_kernels_for_spmd``, ``_mesh_puts``: the multi-GPU
slice, M14) and the trace spans (the observability slice).
"""
from __future__ import annotations

import dataclasses
import io
import logging
import math
import os
import struct
import time
import zlib
from typing import Callable, Optional

import numpy as np
import torch

from photon_tpu_torch.faults import fault_point
from photon_tpu_torch.ops.cuda_sparse import (
    CscLayout,
    as_value_dtype,
    build_csc,
    csc_rmatvec,
    ell_matvec,
)
from photon_tpu_torch.optim import lanes
from photon_tpu_torch.optim.base import (
    FUNCTION_VALUES_CONVERGED,
    MAX_ITERATIONS,
    NOT_CONVERGED,
    OptimizerConfig,
    OptimizerResult,
    check_convergence,
)

Tensor = torch.Tensor
logger = logging.getLogger("photon_tpu_torch.ooc")

# The port's out-of-core checkpoint framing: magic + little-endian CRC32 of
# the payload (an .npz). A JAX checkpoint is a bare .npz (a zip) and never
# matches.
_MAGIC = b"PHTOOC01"


@dataclasses.dataclass(frozen=True)
class HostChunk:
    """One fixed-shape row chunk on the host, in both layouts: the ELL
    arrays (``idx [C, K]`` int32, ghost column == dim with value 0;
    ``val [C, K]``) for the matvec, and their column-sorted ``csc`` for the
    rmatvec, built once with the chunk."""

    idx: Tensor
    val: Tensor
    csc: CscLayout

    @property
    def ell_nbytes(self) -> int:
        return _nbytes(self.idx, self.val)

    @property
    def csc_nbytes(self) -> int:
        c = self.csc
        return _nbytes(c.colptr, c.rows, c.vals, c.tiles, c.splits)


def _nbytes(*ts: Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _make_chunk(idx: np.ndarray, val: Tensor, dim: int, pin: bool) -> HostChunk:
    it = torch.from_numpy(np.ascontiguousarray(idx))
    csc = build_csc(it, val, dim)
    if pin:
        it, val = it.pin_memory(), val.pin_memory()
        csc = dataclasses.replace(
            csc, colptr=csc.colptr.pin_memory(), rows=csc.rows.pin_memory(),
            vals=csc.vals.pin_memory(), tiles=csc.tiles.pin_memory(),
            splits=csc.splits.pin_memory())
    return HostChunk(idx=it, val=val, csc=csc)


def _host_values(val: np.ndarray, dtype: torch.dtype,
                 value_dtype: Optional[torch.dtype]) -> Tensor:
    # a copy, always: the stream's assembly buffer is reused for the next chunk
    t = torch.tensor(val, dtype=dtype)
    if value_dtype is not None and value_dtype != dtype:
        if value_dtype != torch.bfloat16 or dtype != torch.float32:
            raise TypeError(f"value_dtype narrows float32 values to bfloat16; "
                            f"got {dtype} -> {value_dtype}")
        t = t.to(value_dtype)
    return t.contiguous()


@dataclasses.dataclass
class ChunkedGLMData:
    """A fixed-effect dataset as host chunks plus per-chunk device rows.

    ``labels`` / ``offsets`` / ``weights`` are per-chunk tensors on
    ``device`` in ``dtype``; padding rows carry weight 0 (and ghost-only
    features), so they add nothing. ``n_rows`` is the true row count."""

    chunks: list
    labels: list
    offsets: list
    weights: list
    dim: int
    n_rows: int
    chunk_rows: int
    device: torch.device
    dtype: torch.dtype = torch.float32
    # host -> device bytes the passes over this dataset have copied
    h2d_bytes: int = 0

    @classmethod
    def from_arrays(
        cls,
        idx: np.ndarray,
        val: np.ndarray,
        labels: np.ndarray,
        dim: int,
        offsets: Optional[np.ndarray] = None,
        weights: Optional[np.ndarray] = None,
        chunk_rows: int = 1 << 20,
        value_dtype=None,
        device=None,
        dtype: torch.dtype = torch.float32,
    ) -> "ChunkedGLMData":
        """Cut in-memory ELL arrays into chunks of ``chunk_rows`` rows (the
        last one padded). ``device`` defaults to ``cuda``; ``dtype`` is the
        solve's (float32, or float64); ``value_dtype`` (``bfloat16``)
        narrows the stored values."""
        from photon_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        vdt = None if value_dtype is None else as_value_dtype(value_dtype)
        idx, val = np.asarray(idx), np.asarray(val)
        n, k = idx.shape
        if offsets is None:
            offsets = np.zeros(n, np.float64)
        if weights is None:
            weights = np.ones(n, np.float64)
        out = cls(chunks=[], labels=[], offsets=[], weights=[], dim=dim,
                  n_rows=n, chunk_rows=chunk_rows, device=dev, dtype=dtype)
        for c in range(max(1, math.ceil(n / chunk_rows))):
            lo, hi = c * chunk_rows, min((c + 1) * chunk_rows, n)
            m = hi - lo
            ci = np.full((chunk_rows, k), dim, np.int32)
            cv = np.zeros((chunk_rows, k), np.float64)
            ci[:m] = idx[lo:hi]
            cv[:m] = val[lo:hi]
            out.chunks.append(_make_chunk(ci, _host_values(cv, dtype, vdt), dim,
                                          dev.type == "cuda"))
            for src, dst in ((labels, out.labels), (offsets, out.offsets),
                             (weights, out.weights)):
                dst.append(out._rows(np.pad(np.asarray(src, np.float64)[lo:hi],
                                            (0, chunk_rows - m))))
        return out

    def _rows(self, a: np.ndarray) -> Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.dtype).to(self.device)

    @classmethod
    def from_stream(
        cls,
        chunk_iter,
        shard: str,
        dim: int,
        chunk_rows: int = 1 << 20,
        value_dtype=None,
        on_chunk: Optional[Callable] = None,
        device=None,
        dtype: torch.dtype = torch.float32,
    ) -> "ChunkedGLMData":
        """Build from streamed chunks (``StreamingAvroReader.iter_chunks``:
        host ELL per shard) one at a time, never holding the dataset as one
        array. The ELL width K may grow mid-stream: flushed chunks are then
        ghost-padded to the new width (their CSC, which drops ghosts, is
        kept). ``on_chunk(i, host_chunk, labels, offsets, weights)`` runs the
        moment chunk i is made, so a validation error in early data stops
        the stream at once."""
        from photon_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        vdt = None if value_dtype is None else as_value_dtype(value_dtype)
        pin = dev.type == "cuda"
        cur_k = 1
        idx = np.full((chunk_rows, cur_k), dim, np.int32)
        val = np.zeros((chunk_rows, cur_k), np.float64)
        lab = np.zeros(chunk_rows, np.float64)
        off = np.zeros(chunk_rows, np.float64)
        wgt = np.zeros(chunk_rows, np.float64)
        out = cls(chunks=[], labels=[], offsets=[], weights=[], dim=dim,
                  n_rows=0, chunk_rows=chunk_rows, device=dev, dtype=dtype)
        fill = 0

        def regrow(new_k: int):
            nonlocal cur_k, idx, val
            for i, h in enumerate(out.chunks):
                gi = torch.full((chunk_rows, new_k), dim, dtype=torch.int32)
                gv = torch.zeros((chunk_rows, new_k), dtype=h.val.dtype)
                gi[:, :cur_k] = h.idx
                gv[:, :cur_k] = h.val
                if pin:
                    gi, gv = gi.pin_memory(), gv.pin_memory()
                out.chunks[i] = HostChunk(idx=gi, val=gv, csc=h.csc)
            gi = np.full((chunk_rows, new_k), dim, np.int32)
            gv = np.zeros((chunk_rows, new_k), np.float64)
            gi[:, :cur_k] = idx
            gv[:, :cur_k] = val
            idx, val, cur_k = gi, gv, new_k

        def flush():
            nonlocal fill
            out.chunks.append(_make_chunk(idx.copy(), _host_values(val, dtype, vdt),
                                          dim, pin))
            out.labels.append(out._rows(lab.copy()))
            out.offsets.append(out._rows(off.copy()))
            out.weights.append(out._rows(wgt.copy()))
            if on_chunk is not None:
                on_chunk(len(out.chunks) - 1, out.chunks[-1], out.labels[-1],
                         out.offsets[-1], out.weights[-1])
            idx[:] = dim
            val[:] = 0.0
            lab[:] = 0.0
            off[:] = 0.0
            wgt[:] = 0.0
            fill = 0

        for c in chunk_iter:
            sf = c.features[shard]
            ci, cv = np.asarray(sf.idx), np.asarray(sf.val)
            if ci.shape[1] > cur_k:
                regrow(ci.shape[1])
            out.n_rows += c.n_rows
            at = 0
            while at < c.n_rows:
                take = min(chunk_rows - fill, c.n_rows - at)
                sl = slice(fill, fill + take)
                idx[sl, : ci.shape[1]] = ci[at:at + take]
                val[sl, : cv.shape[1]] = cv[at:at + take]
                lab[sl] = c.labels[at:at + take]
                off[sl] = c.offsets[at:at + take]
                wgt[sl] = c.weights[at:at + take]
                fill += take
                at += take
                if fill == chunk_rows:
                    flush()
        if fill:
            flush()
        if not out.chunks:
            raise ValueError("no rows streamed")
        return out

    def rechunk(self, factor: int = 2) -> "ChunkedGLMData":
        """The same dataset cut at ``ceil(chunk_rows / factor)`` rows a
        chunk, the padding rows weight 0 as before (each piece builds its
        CSC anew). Raises ValueError when no smaller cut exists."""
        if factor < 2:
            raise ValueError(f"rechunk factor must be >= 2, got {factor}")
        new_rows = -(-self.chunk_rows // factor)
        if new_rows >= self.chunk_rows:
            raise ValueError(f"cannot rechunk below chunk_rows={self.chunk_rows}")
        out = ChunkedGLMData(chunks=[], labels=[], offsets=[], weights=[],
                             dim=self.dim, n_rows=self.n_rows, chunk_rows=new_rows,
                             device=self.device, dtype=self.dtype)
        pin = self.device.type == "cuda"
        for i, c in enumerate(self.chunks):
            k = c.idx.shape[1]
            for lo in range(0, self.chunk_rows, new_rows):
                hi = min(lo + new_rows, self.chunk_rows)
                pad = new_rows - (hi - lo)
                ci = torch.full((new_rows, k), self.dim, dtype=torch.int32)
                cv = torch.zeros((new_rows, k), dtype=c.val.dtype)
                ci[: hi - lo] = c.idx[lo:hi]
                cv[: hi - lo] = c.val[lo:hi]
                out.chunks.append(_make_chunk(ci.numpy(), cv, self.dim, pin))
                for src, dst in ((self.labels, out.labels),
                                 (self.offsets, out.offsets),
                                 (self.weights, out.weights)):
                    dst.append(torch.nn.functional.pad(src[i][lo:hi], (0, pad)))
        return out

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    @property
    def value_dtype(self) -> torch.dtype:
        return self.chunks[0].val.dtype

    def streamed_bytes_per_pass(self, layout: str = "ell") -> int:
        """Host→device bytes of one pass: ``"ell"`` (the matvec's pass: idx
        and val, padding rows included) or ``"csc"`` (the gradient's:
        column pointers, rows, values and the merge-path partition)."""
        if layout == "ell":
            return sum(c.ell_nbytes for c in self.chunks)
        if layout == "csc":
            return sum(c.csc_nbytes for c in self.chunks)
        raise ValueError(f"layout must be 'ell' or 'csc', got {layout!r}")

    def labels_np(self) -> np.ndarray:
        return torch.cat(self.labels).cpu().numpy()[: self.n_rows]

    def weights_np(self) -> np.ndarray:
        return torch.cat(self.weights).cpu().numpy()[: self.n_rows]


# ----------------------------------------------------------------- feeding


class _Feeder:
    """Copies chunk layouts to the device on a copy stream, one chunk ahead
    of the consumer (``bytes`` counts what crossed; on the CPU the host
    tensors are used as they are). A sweep cache, when given and enabled,
    keeps each chunk layout that fits its budget on the device after its
    first copy."""

    def __init__(self, device: torch.device, cache=None, counter=None):
        self.device = device
        self.cache = cache
        self.counter = counter          # an object with an ``h2d_bytes`` count
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.bytes = 0

    def _copy(self, tensors: tuple) -> tuple:
        with torch.cuda.stream(self.stream):
            out = tuple(t.to(self.device, non_blocking=True) for t in tensors)
        n = _nbytes(*tensors)
        self.bytes += n
        if self.counter is not None:
            self.counter.h2d_bytes += n
        return out

    def _put(self, c: HostChunk, layout: str):
        if layout == "ell":
            key, host = ("ooc_ell", id(c.idx)), (c.idx, c.val)
        else:
            s = c.csc
            key, host = ("ooc_csc", id(s.rows)), (s.colptr, s.rows, s.vals, s.tiles,
                                                  s.splits)
        if self.stream is None:
            return host, False
        if self.cache is not None and self.cache.enabled:
            # A cached entry is complete on the device: waiting on the copy
            # stream once more is harmless.
            got = self.cache.get_or_put(key, _nbytes(*host),
                                        lambda: self._copy(host), retain=host[0])
            return got, True
        return self._copy(host), True

    def _ready(self, item, c: HostChunk, layout: str):
        tensors, copied = item
        if copied:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_stream(self.stream)
            for t in tensors:
                t.record_stream(cur)
        if layout == "ell":
            return tensors
        colptr, rows, vals, tiles, splits = tensors
        return dataclasses.replace(c.csc, colptr=colptr, rows=rows, vals=vals,
                                   tiles=tiles, splits=splits)

    def one(self, c: HostChunk, layout: str):
        return self._ready(self._put(c, layout), c, layout)

    def stream_pass(self, chunks, layout: str):
        """Each chunk's ``layout`` on the device, in order, chunk i+1's
        copies issued before chunk i is handed over."""
        pending = None
        for c in chunks:
            item = (self._put(c, layout), c)
            if pending is not None:
                yield self._ready(pending[0], pending[1], layout)
            pending = item
        if pending is not None:
            yield self._ready(pending[0], pending[1], layout)


# ----------------------------------------------------------- chunk kernels


def _chunk_matvec(w: Tensor, ell: tuple, offsets: Tensor, dim: int) -> Tensor:
    idx, val = ell
    return ell_matvec(idx, val, w, dim) + offsets


def _chunk_value(loss, z: Tensor, labels: Tensor, weights: Tensor) -> Tensor:
    return torch.sum(weights * loss.loss(z, labels))


def _chunk_grad(loss, z: Tensor, labels: Tensor, weights: Tensor,
                csc: CscLayout) -> tuple[Tensor, Tensor]:
    lv = loss.loss(z, labels)
    d1 = loss.d1(z, labels)
    return torch.sum(weights * lv), csc_rmatvec(csc, (weights * d1).contiguous())


class StreamPrimer:
    """The solve's first pass computed per chunk as the data stream in.

    Pass an instance as ``ChunkedGLMData.from_stream(..., on_chunk=primer)``:
    the moment chunk i is made, its layouts go to the device (through the
    sweep cache, when given, so that the solve's first pass reuses the
    copy) and its margins z = X·w0 + offsets and data value / gradient are
    computed, so that with a prefetched chunk iterator the init pass
    overlaps the decode. ``optimize(..., primed=primer.primed())`` then
    skips its two init passes, bit-identically: the per-chunk kernels and
    the order of the sums are the solver's own."""

    def __init__(self, loss, dim: int, w0=None, device_cache=None, device=None,
                 dtype: torch.dtype = torch.float32):
        from photon_tpu_torch.device import resolve_device

        self.loss = loss
        self.dim = int(dim)
        dev = resolve_device(device)
        self.w0 = (torch.zeros(dim, dtype=dtype, device=dev) if w0 is None
                   else torch.as_tensor(w0).to(dtype=dtype, device=dev))
        self.device_cache = device_cache
        self._feeder = _Feeder(dev, device_cache)
        self.z: list = []
        self.fd = torch.zeros((), dtype=dtype, device=dev)
        self.gd = torch.zeros(dim, dtype=dtype, device=dev)
        self._fed_keys: list = []
        self._chunks_seen: list = []
        self._ell_width: Optional[int] = None

    def __call__(self, i, host_chunk: HostChunk, labels, offsets, weights) -> None:
        # A regrow replaced the flushed chunks' ELL arrays: the pins made
        # for the old ones can never be hit again (z / f / g stay exact).
        width = int(host_chunk.idx.shape[1])
        if (self.device_cache is not None and self._ell_width is not None
                and width != self._ell_width):
            for k in self._fed_keys:
                self.device_cache.discard(k)
            self._fed_keys.clear()
        self._ell_width = width
        ell = self._feeder.one(host_chunk, "ell")
        csc = self._feeder.one(host_chunk, "csc")
        if self.device_cache is not None:
            self._fed_keys.append(("ooc_ell", id(host_chunk.idx)))
        self._chunks_seen.append(host_chunk)
        z = _chunk_matvec(self.w0, ell, offsets, self.dim)
        fc, gc = _chunk_grad(self.loss, z, labels, weights, csc)
        self.z.append(z)
        self.fd = self.fd + fc
        self.gd = self.gd + gc

    def primed(self) -> dict:
        """State for ``optimize(..., primed=...)``: the resident margins and
        the data-only value / gradient at ``w0``, stamped with the chunk
        objects the pass ran over."""
        return {"z": self.z, "fd": self.fd, "gd": self.gd, "w0": self.w0,
                "chunks": list(self._chunks_seen)}


# ----------------------------------------------------------------- solvers


def _save(path: str, arrays: dict) -> None:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as fh:
            fh.write(_MAGIC)
            fh.write(struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF))
            fh.write(payload)
        os.replace(tmp, path)
    except OSError as e:   # a failed save must never kill the solve
        logger.warning("checkpoint %s not written (%s)", path, e)


def _load(path: str) -> Optional[dict]:
    """The checkpoint's arrays; None (with a warning) for a file that is
    not the port's or is corrupt. Never unpickles."""
    with open(path, "rb") as fh:
        head = fh.read(len(_MAGIC))
        if head != _MAGIC:
            logger.warning(
                "checkpoint %s is not a checkpoint of photon_tpu_torch (magic "
                "%r; a JAX out-of-core checkpoint?): not read, starting fresh",
                path, head)
            return None
        crc = struct.unpack("<I", fh.read(4))[0]
        payload = fh.read()
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        logger.warning("checkpoint %s fails its checksum: starting fresh", path)
        return None
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@dataclasses.dataclass(frozen=True)
class OutOfCoreLBFGS:
    """Host-loop L-BFGS over a :class:`ChunkedGLMData` (see the module
    docstring)."""

    loss: object                      # ops.losses.PointwiseLoss
    l2_weight: float = 0.0
    reg_mask: Optional[Tensor] = None
    config: OptimizerConfig = OptimizerConfig()
    # Called after every iteration with (it, value, grad_norm, passes).
    progress: Optional[Callable] = None
    # Per-iteration checkpoint file, written atomically after an accepted
    # step: the first, then at most one per checkpoint_min_interval_s, and
    # the last.
    checkpoint_path: Optional[str] = None
    checkpoint_min_interval_s: float = 60.0
    device_cache: Optional[object] = None

    # -- shared scaffolding ------------------------------------------------

    def _streams(self, data: ChunkedGLMData):
        """``(stream_scores, data_value, data_value_at_t, stream_grad)``:
        the streamed-pass closures every solver loop is built from."""
        loss, dim = self.loss, data.dim
        labels, offsets, weights = data.labels, data.offsets, data.weights
        feeder = _Feeder(data.device, self.device_cache, counter=data)

        def stream_scores(wv: Tensor, with_offsets: bool = True) -> list:
            zero = torch.zeros_like(offsets[0])
            out = []
            for i, ell in enumerate(feeder.stream_pass(data.chunks, "ell")):
                # Chaos hook: error="device_oom" per streamed chunk drives
                # the halve-chunk_rows ladder of optimize().
                fault_point("optim.ooc_chunk", chunk_rows=data.chunk_rows)
                out.append(_chunk_matvec(
                    wv, ell, offsets[i] if with_offsets else zero, dim))
            return out

        def data_value(z_chunks) -> Tensor:
            return sum(_chunk_value(loss, z, labels[i], weights[i])
                       for i, z in enumerate(z_chunks))

        def data_value_at_t(z_chunks, zd_chunks, t: float) -> Tensor:
            return sum(_chunk_value(loss, z + t * zd, labels[i], weights[i])
                       for i, (z, zd) in enumerate(zip(z_chunks, zd_chunks)))

        def stream_grad(z_chunks):
            f = torch.zeros((), dtype=data.dtype, device=data.device)
            g = torch.zeros(dim, dtype=data.dtype, device=data.device)
            for i, csc in enumerate(feeder.stream_pass(data.chunks, "csc")):
                fc, gc = _chunk_grad(loss, z_chunks[i], labels[i], weights[i], csc)
                f, g = f + fc, g + gc
            return f, g

        return stream_scores, data_value, data_value_at_t, stream_grad

    def _l2_vec(self, w: Tensor) -> Tensor:
        if self.reg_mask is None:
            return torch.full_like(w, self.l2_weight)
        return self.l2_weight * self.reg_mask.to(w)

    def _ckpt_tag(self, data: ChunkedGLMData, prefix: str, extra: str = "") -> str:
        """Fingerprint that keeps a checkpoint from resuming a different
        problem or dataset: loss, shapes, chunking, regularization (weights
        and mask; ``extra`` carries the L1 weight), iteration cap, dtypes,
        and cheap probes of every data component (labels, weights, offsets,
        the first chunk's features)."""
        cfg = self.config
        c0 = data.chunks[0]
        probe = (
            float(data.labels[0].double().sum()),
            float(data.weights[0].double().sum()),
            float(data.offsets[0].double().sum()),
            int(c0.idx.long().sum()),
            float(c0.val.double().sum()),
        )
        mask = ("none" if self.reg_mask is None
                else repr(float(self.reg_mask.double().sum())))
        return (
            f"photon_tpu_torch:{prefix}:{self.loss.name}:{data.n_rows}:{data.dim}:"
            f"{data.n_chunks}:{data.chunk_rows}:{data.dtype}:{data.value_dtype}:"
            f"{self.l2_weight}:{extra}{mask}:{cfg.history_length}:"
            f"{cfg.max_iterations}:{probe!r}"
        )

    def _load_checkpoint(self, tag: str, data: ChunkedGLMData) -> Optional[dict]:
        if self.checkpoint_path is None or not os.path.exists(self.checkpoint_path):
            return None
        try:
            state = _load(self.checkpoint_path)
        except (OSError, ValueError, EOFError, struct.error) as e:
            logger.warning("checkpoint %s unreadable (%s: %s): starting fresh",
                           self.checkpoint_path, type(e).__name__, e)
            return None
        if state is None or str(state.get("tag", "")) != tag:
            return None      # another problem or dataset: never cross-resume
        return state

    def _save_checkpoint(self, tag: str, st: dict) -> None:
        if self.checkpoint_path is None:
            return
        arrays = {"tag": np.asarray(tag)}
        for k, v in st.items():
            if isinstance(v, list):
                arrays.update({f"{k}_{i}": x.cpu().numpy() for i, x in enumerate(v)})
                arrays[f"{k}_n"] = np.asarray(len(v))
            elif isinstance(v, torch.Tensor):
                arrays[k] = v.detach().cpu().numpy()
            else:
                arrays[k] = np.asarray(v)
        _save(self.checkpoint_path, arrays)

    @staticmethod
    def _restore(state: dict, data: ChunkedGLMData) -> dict:
        def t(a):
            return torch.from_numpy(np.array(a)).to(data.device)

        def tl(k):
            return [t(state[f"{k}_{i}"]) for i in range(int(state[f"{k}_n"]))]

        return dict(
            w=t(state["w"]), g=t(state["g"]), z=tl("z"),
            hist=lanes.LaneHistory(s=t(state["hist_s"]), y=t(state["hist_y"]),
                                   rho=t(state["hist_rho"]),
                                   count=t(state["hist_count"])),
            n_hist=int(state["n_hist"]), it=int(state["it"]),
            passes=int(state["passes"]), f=t(state["f"]), f_prev=t(state["f_prev"]),
            gnorm0=t(state["gnorm0"]), values=np.array(state["values"]),
            grad_norms=np.array(state["grad_norms"]))

    def _state(self, w, g, z, hist, n_hist, it, passes, f, f_prev, gnorm0,
               values, grad_norms) -> dict:
        return dict(w=w, g=g, z=z, hist_s=hist.s, hist_y=hist.y, hist_rho=hist.rho,
                    hist_count=hist.count, n_hist=n_hist, it=it, passes=passes,
                    f=f, f_prev=f_prev, gnorm0=gnorm0, values=values,
                    grad_norms=grad_norms)

    def _primed_init(self, primed, data: ChunkedGLMData, w: Tensor):
        """(z, fd, gd) of a :class:`StreamPrimer` when it ran over exactly
        these chunk objects at exactly this start point, else None (the
        solve then runs its own init passes)."""
        if primed is None:
            return None
        z = primed.get("z") or []
        chunks = primed.get("chunks") or []
        if len(z) != data.n_chunks or len(chunks) != data.n_chunks or any(
                a is not b for a, b in zip(chunks, data.chunks)):
            return None
        w0 = primed.get("w0")
        if w0 is None or w0.shape != w.shape or w0.dtype != w.dtype or not bool(
                torch.equal(w0, w)):
            return None
        return z, primed["fd"], primed["gd"]

    @staticmethod
    def _result(w, f, gnorm, it, reason, values, grad_norms,
                passes) -> OptimizerResult:
        return OptimizerResult(
            x=w, value=float(f), grad_norm=float(gnorm), iterations=int(it),
            converged_reason=int(reason), values=torch.from_numpy(values),
            grad_norms=torch.from_numpy(grad_norms), data_passes=int(passes))

    def _two_loop(self, g: Tensor, hist, n_hist: int) -> Tensor:
        return lanes.two_loop_direction(g[None], hist, n_hist)[0]

    def _update(self, hist, n_hist: int, s: Tensor, y: Tensor):
        ones = torch.ones(1, dtype=torch.bool, device=s.device)
        m = hist.s.shape[1]
        return lanes.update_history(hist, s[None], y[None], ones), min(n_hist + 1, m)

    # -- the solve -----------------------------------------------------------
    # A solver names its checkpoint tag and supplies three pieces: the
    # objective from one gradient pass (``_finish``), the gradient the
    # convergence test reads (``_test_grad``), and the direction with its
    # line search (``_step``); the loop, init, resume and saves are shared.

    _TAG = "ooc-v1"

    def _tag_extra(self) -> str:
        return ""

    def _reg(self, w: Tensor) -> tuple:
        """The solve's regularization vectors, built once: (L2, L1)."""
        return self._l2_vec(w), None

    @staticmethod
    def _finish(reg: tuple, wv: Tensor, fd: Tensor, gd: Tensor):
        """(objective, smooth gradient) at ``wv`` from one pass's data
        value ``fd`` and gradient ``gd``."""
        l2v = reg[0]
        return fd + 0.5 * torch.sum(l2v * wv * wv), gd + l2v * wv

    @staticmethod
    def _test_grad(reg: tuple, wv: Tensor, g: Tensor) -> Tensor:
        return g

    def _step(self, streams, reg, w, z, f, g, tg, hist, n_hist):
        """One iteration's direction and line search: ``(passes, hist,
        n_hist, move)``, ``move`` None when no step decreases f, else
        ``(w_new, s, z_new)``."""
        stream_scores, _, data_value_at_t, _ = streams
        l2v = reg[0]
        d = self._two_loop(g, hist, n_hist)
        dg = torch.dot(d, g)
        if float(dg) >= 0.0:    # not a descent direction: restart memory
            hist, n_hist = lanes.empty_history(self.config.history_length, w[None]), 0
            d, dg = -g, -torch.dot(g, g)
        zd = stream_scores(d, with_offsets=False)
        # Armijo backtracking over the resident margins (no data pass a
        # probe), the constants of the in-core line search.
        t, ft, accept, t_last = 1.0, f, False, 0.0
        c1, shrink = 1e-4, 0.5
        for _ in range(self.config.max_line_search_iterations):
            wt = w + t * d
            ft = data_value_at_t(z, zd, t) + 0.5 * torch.sum(l2v * wt * wt)
            if bool(torch.isfinite(ft)) and float(ft) <= float(f + c1 * t * dg):
                accept = True
                break
            t_last = t
            t *= shrink
        if not accept and bool(torch.isfinite(ft)) and float(ft) < float(f):
            # The smallest probed step still decreases f: take it.
            t = t_last
            accept = t > 0.0
        if not accept:
            return 1, hist, n_hist, None
        s = t * d
        return 1, hist, n_hist, (w + s, s, [z[i] + t * zd[i] for i in range(len(z))])

    def optimize(self, data: ChunkedGLMData, x0: Tensor,
                 primed: Optional[dict] = None) -> OptimizerResult:
        """Minimize from ``x0``. ``primed`` (``StreamPrimer.primed()``)
        carries the init pass computed while the data streamed in; a valid
        prime skips the two init passes bit-identically (``data_passes``
        records the fused pass as 1).

        Under the recovery of the module docstring: an OOM re-cuts the data
        at half the rows a chunk and re-enters; a device loss releases the
        caches and re-enters from the checkpoint."""
        from photon_tpu_torch.runtime import backend_guard as _bg
        from photon_tpu_torch.runtime import memory_guard as _mg

        recoveries = 0
        while True:
            try:
                return self._optimize_impl(data, x0, primed=primed)
            except Exception as e:  # noqa: BLE001 - classified below
                if _mg.is_oom(e):
                    new_rows = -(-data.chunk_rows // 2)
                    if data.chunk_rows <= 1:
                        _mg.journal_event(
                            "oom_exhausted", site="optim.ooc_chunk",
                            cause="oom", plan=f"chunk_rows={data.chunk_rows}",
                            reason="chunk_rows already 1")
                        raise
                    if not _mg.downshifter("optim.ooc_chunk").absorb(
                            e, before=f"chunk_rows={data.chunk_rows}",
                            after=f"chunk_rows={new_rows}"):
                        raise   # absorb journaled the spent budget
                    action = "rechunk"
                elif (_bg.is_device_lost(e)
                        and recoveries < _bg.max_inrun_recoveries()):
                    logger.warning(
                        "device lost mid-solve (%s: %s); in-run recovery %d/%d%s",
                        type(e).__name__, e, recoveries + 1,
                        _bg.max_inrun_recoveries(),
                        ", resuming from the checkpoint" if self.checkpoint_path
                        else ", re-running the deterministic loop")
                    action = "recover"
                else:
                    raise
            # Out of the handler: the failed attempt's tensors are freed.
            primed = None   # the prime's margins belong to the old attempt
            if action == "rechunk":
                if self.device_cache is not None:
                    # The old cut's pins can never be hit again.
                    for c in data.chunks:
                        self.device_cache.discard(("ooc_ell", id(c.idx)))
                        self.device_cache.discard(("ooc_csc", id(c.csc.rows)))
                data = data.rechunk(2)
            else:
                recoveries += 1
                _bg.recover_from_device_loss("out-of-core solve",
                                             device_cache=self.device_cache,
                                             logger=logger)

    def _optimize_impl(self, data: ChunkedGLMData, x0: Tensor,
                       primed: Optional[dict] = None) -> OptimizerResult:
        cfg = self.config
        dt, dev = data.dtype, data.device
        streams = self._streams(data)
        stream_scores, stream_grad = streams[0], streams[3]
        w = torch.as_tensor(x0).to(dtype=dt, device=dev)
        reg = self._reg(w)

        def test_norm(wv, gv):
            return torch.linalg.vector_norm(self._test_grad(reg, wv, gv))

        max_it = cfg.max_iterations
        np_dt = np.float64 if dt == torch.float64 else np.float32
        tag = self._ckpt_tag(data, self._TAG, extra=self._tag_extra())
        state = self._load_checkpoint(tag, data)
        if state is not None:
            st = self._restore(state, data)
            w, g, z, hist = st["w"], st["g"], st["z"], st["hist"]
            n_hist, it, passes = st["n_hist"], st["it"], st["passes"]
            f, f_prev, gnorm0 = st["f"], st["f_prev"], st["gnorm0"]
            values, grad_norms = st["values"], st["grad_norms"]
        else:
            prime = self._primed_init(primed, data, w)
            if prime is not None:
                z, fd, gd = prime
                passes = 1
            else:
                z = stream_scores(w)
                fd, gd = stream_grad(z)
                passes = 2
            f, g = self._finish(reg, w, fd, gd)
            gnorm0 = test_norm(w, g)
            hist, n_hist = lanes.empty_history(cfg.history_length, w[None]), 0
            values = np.full(max_it + 1, np.inf, np_dt)
            grad_norms = np.full(max_it + 1, np.inf, np_dt)
            values[0] = float(f)
            grad_norms[0] = float(gnorm0)
            it = 0
            f_prev = torch.full((), math.inf, dtype=dt, device=dev)

        reason = NOT_CONVERGED
        last_save = float("-inf")
        while True:
            # Chaos hook: error="device_lost" here drives the in-run
            # recovery of optimize() (checkpoint fast-forward).
            fault_point("optim.ooc_iteration", it=it)
            # The convergence test comes before the iteration cap, as in the
            # in-core loop.
            tg = self._test_grad(reg, w, g)
            reason = int(check_convergence(it, f_prev, f, torch.linalg.vector_norm(tg),
                                           gnorm0, cfg.tolerance))
            if reason != NOT_CONVERGED:
                break
            if it >= max_it:
                reason = MAX_ITERATIONS
                break
            used, hist, n_hist, move = self._step(streams, reg, w, z, f, g, tg,
                                                  hist, n_hist)
            passes += used
            if move is None:
                reason = FUNCTION_VALUES_CONVERGED
                break
            w, s, z = move
            f_prev = f
            f, g_new = self._finish(reg, w, *stream_grad(z))
            passes += 1
            hist, n_hist = self._update(hist, n_hist, s, g_new - g)
            g = g_new
            it += 1
            values[it] = float(f)
            grad_norms[it] = float(test_norm(w, g))
            now = time.monotonic()
            if it == 1 or now - last_save >= self.checkpoint_min_interval_s:
                self._save_checkpoint(tag, self._state(
                    w, g, z, hist, n_hist, it, passes, f, f_prev, gnorm0, values,
                    grad_norms))
                last_save = now
            if self.progress is not None:
                self.progress(it, values[it], grad_norms[it], passes)

        self._save_checkpoint(tag, self._state(w, g, z, hist, n_hist, it, passes, f,
                                               f_prev, gnorm0, values, grad_norms))
        return self._result(w, f, test_norm(w, g), it, reason, values, grad_norms,
                            passes)


@dataclasses.dataclass(frozen=True)
class OutOfCoreOWLQN(OutOfCoreLBFGS):
    """Host-loop OWL-QN over a :class:`ChunkedGLMData`: L1 and elastic net
    out of core, the in-core ``optim/lanes.py`` OWL-QN semantics (pseudo-
    gradient, smooth-gradient history, direction alignment, orthant
    projection of trial points, Armijo on the total objective). The orthant
    projection makes a trial point nonlinear in the step, so each probe
    streams one scores pass; an iteration accepted at t = 1 is 2 passes.
    ``l1_weight`` scales ``reg_mask`` (ones if absent)."""

    l1_weight: float = 0.0

    _TAG = "ooc-owlqn-v1"

    def _tag_extra(self) -> str:
        return f"{self.l1_weight}:"

    def _l1_vec(self, w: Tensor) -> Tensor:
        if self.reg_mask is None:
            return torch.full_like(w, self.l1_weight)
        return self.l1_weight * self.reg_mask.to(w)

    def _reg(self, w: Tensor) -> tuple:
        return self._l2_vec(w), self._l1_vec(w)

    @staticmethod
    def _finish(reg: tuple, wv: Tensor, fd: Tensor, gd: Tensor):
        """(total objective, smooth gradient)."""
        l2v, l1v = reg
        return (fd + 0.5 * torch.sum(l2v * wv * wv)
                + torch.sum(l1v * torch.abs(wv))), gd + l2v * wv

    @staticmethod
    def _test_grad(reg: tuple, wv: Tensor, g: Tensor) -> Tensor:
        return lanes.pseudo_gradient(wv, g, reg[1])

    def _step(self, streams, reg, w, z, f, g, tg, hist, n_hist):
        stream_scores, data_value, _, _ = streams
        l2v, l1v = reg
        pg = tg
        d = self._two_loop(pg, hist, n_hist)
        # Orthant alignment; steepest descent if nothing is left.
        d = torch.where(d * (-pg) > 0.0, d, 0.0)
        if float(torch.dot(d, d)) == 0.0:
            d = -pg
        xi = torch.where(w != 0.0, torch.sign(w), torch.sign(-pg))
        # Backtracking Armijo on the total objective, each trial point
        # projected onto the orthant: one streamed scores pass a probe.
        t, accept, xt, zt, ft, passes = 1.0, False, w, z, f, 0
        for _ in range(self.config.max_line_search_iterations):
            xt = w + t * d
            xt = torch.where(xt * xi >= 0.0, xt, 0.0)
            zt = stream_scores(xt)
            passes += 1
            ft = (data_value(zt) + 0.5 * torch.sum(l2v * xt * xt)
                  + torch.sum(l1v * torch.abs(xt)))
            decrease = torch.dot(pg, xt - w)
            if bool(torch.isfinite(ft)) and float(ft) <= float(f + 1e-4 * decrease):
                accept = True
                break
            t *= 0.5
        if not accept and bool(torch.isfinite(ft)) and float(ft) < float(f):
            accept = True   # the smallest probed step still decreases f
        if not accept:
            return passes, hist, n_hist, None
        return passes, hist, n_hist, (xt, xt - w, zt)


def scores_out_of_core(data: ChunkedGLMData, w) -> np.ndarray:
    """Streamed scores z = Xw + offsets of every true row: the chunked
    counterpart of ``GeneralizedLinearModel.compute_score``."""
    w = torch.as_tensor(w).to(dtype=data.dtype, device=data.device)
    feeder = _Feeder(data.device, counter=data)
    outs = [_chunk_matvec(w, ell, data.offsets[i], data.dim)
            for i, ell in enumerate(feeder.stream_pass(data.chunks, "ell"))]
    return torch.cat(outs).cpu().numpy()[: data.n_rows]


def run_out_of_core(problem, data: ChunkedGLMData, w0=None, reg_mask=None,
                    progress=None, checkpoint_path=None, device_cache=None,
                    primed=None, mesh=None, checkpoint_min_interval_s: float = 60.0):
    """``GLMOptimizationProblem.run`` for the out-of-core path: the same
    task → loss map, regularization and mask, and ``(model, result)``
    return. LBFGS takes smooth L2; OWLQN any L1 component (L1 / elastic
    net), as in-core: an L1 component under L-BFGS raises, and TRON (which
    needs Hessian passes) is refused. Variances are not computed."""
    from photon_tpu_torch.models.coefficients import Coefficients
    from photon_tpu_torch.models.glm import GeneralizedLinearModel
    from photon_tpu_torch.ops.losses import loss_for_task
    from photon_tpu_torch.optim import OptimizerType

    if mesh is not None:
        raise NotImplementedError(
            "out-of-core streaming over a device mesh comes with the "
            "multi-GPU slice (M14)")
    l1 = problem.regularization.l1_weight(float(problem.reg_weight))
    common = dict(
        loss=loss_for_task(problem.task),
        l2_weight=problem.regularization.l2_weight(float(problem.reg_weight)),
        reg_mask=reg_mask,
        config=problem.optimizer_config,
        progress=progress,
        checkpoint_path=checkpoint_path,
        checkpoint_min_interval_s=checkpoint_min_interval_s,
        device_cache=device_cache,
    )
    if problem.optimizer_type == OptimizerType.OWLQN:
        solver = OutOfCoreOWLQN(l1_weight=l1, **common)
    elif problem.optimizer_type != OptimizerType.LBFGS:
        raise NotImplementedError(
            "out-of-core training supports LBFGS (smooth L2) and OWLQN "
            f"(L1/elastic-net) only; got {problem.optimizer_type}")
    elif l1 > 0.0:
        raise NotImplementedError(
            "L1 components need an orthant-wise optimizer: use "
            "OptimizerType.OWLQN out-of-core, same as the in-core rule; "
            f"got LBFGS with {problem.regularization.reg_type.name}")
    else:
        solver = OutOfCoreLBFGS(**common)
    if w0 is None:
        w0 = torch.zeros(data.dim, dtype=data.dtype, device=data.device)
    result = solver.optimize(data, w0, primed=primed)
    model = GeneralizedLinearModel(Coefficients(means=result.x, variances=None),
                                   problem.task)
    return model, result
