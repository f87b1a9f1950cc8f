"""Pipelined ingest → device data path: prefetched decode and staged copies.

Port of ``photon_tpu/io/prefetch.py`` (without the bf16 feed, which comes
with the K1-bf16 slice, and without the fault points, spans and metrics of
the observability slice):

* :func:`prefetch` runs any chunk iterator (``StreamingAvroReader
  .iter_chunks`` or the worker pool of ``io/parallel_ingest.py``) on a
  producer thread, ``depth`` chunks ahead: block decode of chunk N+1
  overlaps whatever the consumer does with chunk N (the native decoder
  releases the interpreter lock). The producer only decodes into numpy; it
  never touches CUDA.
* :class:`PinnedStaging` stands where ``jax.device_put(donate=True)`` stood:
  each host array is copied into a reused page-locked staging buffer, then
  to the device with ``non_blocking=True`` on a dedicated copy stream. A
  buffer is reused only after the event recorded behind its last copy has
  completed, and :meth:`PinnedStaging.ready` makes the consumer's stream
  wait on the copy stream and marks every tensor with ``record_stream``, so
  the caching allocator never reuses memory a copy still reads or writes.
* :func:`pipelined_puts` keeps one put in flight ahead of the consumer: the
  copies of chunk N+1 are issued before chunk N is handed over. Every CUDA
  call stays on the consumer's thread.
* :func:`read_bundle_pipelined` is the whole-dataset read: chunks decoded
  ahead, assembled by ``io.streaming.chunks_to_bundle`` into the same
  ``GameDataBundle`` as ``StreamingAvroReader.read``, bit for bit.

On a CPU device the staging is skipped: the arrays become tensors in place.
"""
from __future__ import annotations

import collections
import os
import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

__all__ = [
    "default_prefetch_depth",
    "prefetch",
    "pipelined_puts",
    "PinnedStaging",
    "device_put_chunk",
    "iter_chunks_pipelined",
    "read_bundle_pipelined",
]


def default_prefetch_depth() -> int:
    """Queue bound of the background decode stage (``PHOTON_PREFETCH_DEPTH``,
    default 2; 0 disables prefetching)."""
    try:
        return max(0, int(os.environ.get("PHOTON_PREFETCH_DEPTH", "2")))
    except ValueError:
        return 2


def prefetch(iterable: Iterable, depth: Optional[int] = None) -> Iterator:
    """Yield from ``iterable`` while a background thread runs it ``depth``
    items ahead.

    An exception of the producer re-raises at the consumer's next pull, in
    order: a failing stream fails the pipeline, never hangs it. Abandoning
    the generator (``close()`` or garbage collection) stops the producer: it
    checks a stop flag around every bounded put. ``depth <= 0`` is plain
    iteration, with no thread.
    """
    if depth is None:
        depth = default_prefetch_depth()
    if depth <= 0:
        yield from iterable
        return

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce() -> None:
        try:
            for item in iterable:
                if not put(item):
                    return
            put((end, None))
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            put((end, e))

    t = threading.Thread(target=produce, name="photon-prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is end:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        stop.set()
        # Drain so a producer blocked on a full queue sees the stop flag.
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=5.0)


def pipelined_puts(items: Iterable, put: Callable, ahead: int = 1,
                   ready: Optional[Callable] = None) -> Iterator:
    """Apply ``put`` to each item, keeping ``ahead`` results in flight: the
    copies of item N+1 are issued before item N is yielded. ``ready`` (if
    given) runs on each result as it is handed to the consumer."""
    pending: collections.deque = collections.deque()
    done = ready or (lambda x: x)
    for item in items:
        pending.append(put(item))
        while len(pending) > max(ahead, 0):
            yield done(pending.popleft())
    while pending:
        yield done(pending.popleft())


class PinnedStaging:
    """Host → device copies through reused page-locked buffers on one copy
    stream.

    ``put(array)`` copies ``array`` into the next staging buffer of a ring
    (grown when too small), issues the device copy with ``non_blocking=True``
    on ``stream`` and records an event behind it; the buffer is written
    again only after that event completes. ``ready(tensors)`` makes the
    current stream wait on the copy stream and calls ``record_stream`` on
    each tensor. ``bytes`` counts what was copied to the device; ``copies``
    the copies.
    """

    def __init__(self, device: torch.device, slots: int = 16):
        if device.type != "cuda":
            raise ValueError(f"PinnedStaging copies to a CUDA device, not {device}")
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._ring: list = [None] * slots       # (uint8 pinned buffer, event)
        self._next = 0
        self.bytes = 0
        self.copies = 0

    def _buffer(self, nbytes: int) -> tuple:
        slot = self._next
        self._next = (self._next + 1) % len(self._ring)
        held = self._ring[slot]
        if held is not None:
            held[1].synchronize()     # its last copy has finished reading it
        if held is None or held[0].numel() < nbytes:
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
            held = (buf, torch.cuda.Event())
        if not held[0].is_pinned():
            raise RuntimeError("staging buffer is not page-locked: a "
                               "non_blocking copy from it would be synchronous")
        self._ring[slot] = held
        return slot, held

    def put(self, a: np.ndarray) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        slot, (buf, event) = self._buffer(a.nbytes)
        host = buf[: a.nbytes]
        if a.nbytes:
            host.numpy()[:] = a.reshape(-1).view(np.uint8)
        with torch.cuda.stream(self.stream):
            out = host.to(self.device, non_blocking=True)
            event.record(self.stream)
        self.bytes += a.nbytes
        self.copies += 1
        return out.view(_torch_dtype(a.dtype)).reshape(a.shape)

    def ready(self, tensors: Iterable[torch.Tensor]) -> None:
        current = torch.cuda.current_stream(self.device)
        current.wait_stream(self.stream)
        for t in tensors:
            t.record_stream(current)


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dt)).dtype


def _chunk_tensors(chunk) -> list:
    return [t for sf in chunk.features.values() for t in (sf.idx, sf.val)]


def device_put_chunk(chunk, device: torch.device,
                     staging: Optional[PinnedStaging] = None):
    """One streamed ``GameDataChunk`` with its features (ELL idx / val) as
    tensors on ``device``; labels, offsets, weights and the string columns
    stay numpy (the port's ``GameDataBundle`` keeps its row columns on the
    host). On CUDA the copies go through ``staging`` (required there) and
    are not yet ordered before the consumer's work: pass the result through
    ``staging.ready``."""
    from photon_tpu_torch.data.batch import SparseFeatures
    from photon_tpu_torch.io.streaming import GameDataChunk

    if device.type == "cuda":
        if staging is None:
            raise ValueError("a CUDA device_put_chunk needs its PinnedStaging")
        put = staging.put
    else:
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return GameDataChunk(
        labels=chunk.labels, offsets=chunk.offsets, weights=chunk.weights,
        uids=chunk.uids, id_tags=chunk.id_tags,
        features={s: SparseFeatures(idx=put(sf.idx), val=put(sf.val), dim=sf.dim)
                  for s, sf in chunk.features.items()})


def iter_chunks_pipelined(
    reader,
    paths,
    dtype=np.float32,
    require_labels: bool = True,
    depth: Optional[int] = None,
    workers: int = 0,
    device: Optional[torch.device] = None,
    staging: Optional[PinnedStaging] = None,
) -> Iterator:
    """``StreamingAvroReader.iter_chunks`` behind the prefetch stage.

    ``workers > 1`` decodes file shards on the ``parallel_ingest`` worker
    pool (chunks come back in file order) instead of in-process. With a
    ``device`` the chunks' features are copied there, one chunk ahead of
    the consumer (on CUDA through ``staging``, made here if not given)."""
    if workers and workers > 1:
        from photon_tpu_torch.io.parallel_ingest import iter_chunks_parallel

        src = iter_chunks_parallel(
            paths, reader.index_maps, reader.shard_configs, reader.columns,
            reader.id_tag_columns, n_workers=workers,
            chunk_rows=reader.chunk_rows, capture_uids=reader.capture_uids,
            dtype=dtype, require_labels=require_labels)
    else:
        src = reader.iter_chunks(paths, dtype=dtype,
                                 require_labels=require_labels)
    out = prefetch(src, depth=depth)
    if device is None:
        return out
    if device.type == "cuda" and staging is None:
        staging = PinnedStaging(device)

    def ready(chunk):
        if staging is not None:
            staging.ready(_chunk_tensors(chunk))
        return chunk

    return pipelined_puts(
        out, lambda c: device_put_chunk(c, device, staging), ahead=1,
        ready=ready)


def read_bundle_pipelined(
    index_maps,
    shard_configs,
    columns,
    id_tag_columns,
    paths,
    device: torch.device,
    dtype=np.float32,
    require_labels: bool = True,
    capture_uids: bool = False,
    depth: Optional[int] = None,
    workers: int = 0,
    chunk_rows: int = 1 << 20,
    reader=None,
    staging: Optional[PinnedStaging] = None,
):
    """Whole-dataset read through the prefetched decode stage: block decode
    of chunk N+1 runs on the producer thread while the consumer takes chunk
    N; the chunks are then assembled by ``chunks_to_bundle`` (on CUDA
    copied through ``staging``, made there if not given). The same rows in
    the same order as ``StreamingAvroReader.read``, bit for bit. Raises
    ``io.streaming.Unsupported`` exactly where that read would, so callers
    keep their per-record fallback. ``reader`` (a ``StreamingAvroReader``)
    reuses its compiled programs and hash tables across calls; given, it
    overrides the construction arguments."""
    from photon_tpu_torch.io.streaming import StreamingAvroReader, chunks_to_bundle

    if reader is None:
        reader = StreamingAvroReader(
            index_maps, shard_configs, columns, id_tag_columns,
            chunk_rows=chunk_rows, capture_uids=capture_uids)
    chunks = list(iter_chunks_pipelined(
        reader, paths, dtype=dtype, require_labels=require_labels,
        depth=depth, workers=workers))
    return chunks_to_bundle(chunks, index_maps, id_tag_columns, device, dtype,
                            staging=staging)
