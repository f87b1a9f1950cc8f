"""Intra-host parallel ingest: worker processes decoding file shards.

Port of ``photon_tpu/io/parallel_ingest.py``: a spawn pool where worker
``w`` of ``n`` block-decodes whole files through the native decoder and
ships numpy chunks back, and the parent reassembles them in file order into
the same ``GameDataBundle`` an in-process read gives (equality-tested).

* Workers start by ``spawn``, never ``fork``: a fork after CUDA
  initialization is broken. They never initialize CUDA: the pool's
  initializer hides every device (``CUDA_VISIBLE_DEVICES=""``) before the
  worker imports anything that imports torch, and the decode path builds
  numpy chunks only.
* Everything crossing the process boundary pickles: index maps travel as
  specs (key lists, or the mmap store's directory), chunks as numpy dicts
  with their dictionary columns materialized.
* Results are consumed in file order, so the rows keep the global order of
  a sequential read whatever the workers' timing.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Sequence

import numpy as np

from photon_tpu_torch.index.index_map import (
    DefaultIndexMap,
    IndexMap,
    MmapIndexMap,
    feature_key,
)

__all__ = ["read_parallel", "iter_chunks_parallel"]


def _worker_init() -> None:
    """Pool initializer: hide the GPUs from the worker before torch loads."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def _index_spec(im: IndexMap):
    if isinstance(im, MmapIndexMap):
        from photon_tpu_torch.io.streaming import Unsupported

        # Workers reopen the store by path (spawn = same filesystem); a
        # missing directory must surface as Unsupported HERE, before a pool
        # spawns, so the caller's in-process fallback triggers cleanly.
        if not os.path.isdir(im.store_dir):
            raise Unsupported(
                f"mmap index store not a directory: {im.store_dir!r}"
            )
        return ("mmap", im.store_dir)
    try:
        return ("keys", list(im.keys_in_order))
    except AttributeError:
        # feature_key keeps the delimiter for empty terms (the intercept's
        # key is "(INTERCEPT)\x01") so worker-side lookups stay exact.
        return ("keys", [
            feature_key(*im.get_feature(i)) for i in range(len(im))
        ])


def _index_from_spec(spec) -> IndexMap:
    kind, payload = spec
    if kind == "mmap":
        if not os.path.isdir(payload):
            raise FileNotFoundError(
                f"mmap index store {payload!r} not visible in worker "
                "process (store must live on a filesystem shared with the "
                "driver)"
            )
        return MmapIndexMap(payload)
    return DefaultIndexMap(payload)


@dataclasses.dataclass
class _WorkerConfig:
    """Picklable reader construction recipe."""

    index_specs: dict
    shard_configs: dict
    columns: object
    id_tag_columns: tuple
    chunk_rows: int
    capture_uids: bool
    dtype: str
    require_labels: bool


def _chunk_payload(chunk, capture_uids: bool) -> dict:
    """GameDataChunk -> picklable numpy dict (dictionaries materialized).
    With ``capture_uids=False`` the uid column is all defaults — ship None
    instead of n_rows empty-string objects."""
    return {
        "n": chunk.n_rows,
        "labels": chunk.labels,
        "offsets": chunk.offsets,
        "weights": chunk.weights,
        "uids": chunk.uids.materialize("") if capture_uids else None,
        "id_tags": {t: c.materialize() for t, c in chunk.id_tags.items()},
        "features": {
            s: (np.asarray(sf.idx), np.asarray(sf.val), sf.dim)
            for s, sf in chunk.features.items()
        },
    }


def _payload_chunk(payload: dict):
    from photon_tpu_torch.io.streaming import DictColumn, GameDataChunk, HostEll

    def col(values):
        return DictColumn(np.arange(len(values), dtype=np.int32), values)

    uids = payload["uids"]
    if uids is None:  # capture_uids=False: all-default column
        uids = DictColumn(
            np.full(payload["n"], -1, np.int32), np.zeros(0, object)
        )
    else:
        uids = col(uids)
    return GameDataChunk(
        labels=payload["labels"],
        offsets=payload["offsets"],
        weights=payload["weights"],
        uids=uids,
        id_tags={t: col(v) for t, v in payload["id_tags"].items()},
        features={
            s: HostEll(idx=i, val=v, dim=d)
            for s, (i, v, d) in payload["features"].items()
        },
    )


# One reader per worker process, built lazily on the first job (spawn pools
# reuse workers across jobs, so the per-process hash tables amortize).
_WORKER_READER = None


def _worker_file(args) -> tuple:
    """Decode ONE file; returns (file_pos, [payload, ...]). Per-file jobs
    bound worker memory to a single file's chunks and let results stream
    back to the parent as each file completes."""
    global _WORKER_READER
    cfg, pos, path = args
    if _WORKER_READER is None:
        from photon_tpu_torch.io.streaming import StreamingAvroReader

        _WORKER_READER = StreamingAvroReader(
            {s: _index_from_spec(sp) for s, sp in cfg.index_specs.items()},
            cfg.shard_configs,
            cfg.columns,
            cfg.id_tag_columns,
            chunk_rows=cfg.chunk_rows,
            capture_uids=cfg.capture_uids,
        )
    payloads = [
        _chunk_payload(chunk, cfg.capture_uids)
        for chunk in _WORKER_READER.iter_chunks(
            [path], dtype=np.dtype(cfg.dtype),
            require_labels=cfg.require_labels,
        )
    ]
    return pos, payloads


def iter_chunks_parallel(
    paths,
    index_maps: Mapping[str, IndexMap],
    shard_configs: Mapping[str, object],
    columns=None,
    id_tag_columns: Sequence[str] = (),
    n_workers: int = 0,
    chunk_rows: int = 1 << 20,
    capture_uids: bool = True,
    dtype=np.float32,
    require_labels: bool = True,
):
    """Stream ``GameDataChunk``s decoded by ``n_workers`` processes, in the
    exact global order of a sequential read.

    The worker-pool analog of ``StreamingAvroReader.iter_chunks`` — the feed
    stage ``io/prefetch.py`` builds on: the ORDERED ``imap`` keeps per-file
    results arriving in submission (= file) order while the pool decodes up
    to ``n_workers`` files ahead, so the consumer overlaps whatever it does
    per chunk with the remaining decode. A worker crash (pool teardown,
    corrupt file) surfaces at the consumer's next pull — fast-fail, never a
    hang — and abandoning the generator terminates the pool. Falls back to
    the in-process reader for ``n_workers <= 1``; raises ``Unsupported``
    when the native decoder is unavailable, like the sequential path.
    """
    from photon_tpu_torch import native
    from photon_tpu_torch.io.data_reader import InputColumnNames, _expand_paths
    from photon_tpu_torch.io.streaming import StreamingAvroReader, Unsupported

    if native.get_lib() is None:
        raise Unsupported("native decoder unavailable")
    columns = columns or InputColumnNames()
    files = _expand_paths(paths)
    n_workers = min(int(n_workers), len(files))
    if n_workers <= 1:
        yield from StreamingAvroReader(
            index_maps, shard_configs, columns, id_tag_columns,
            chunk_rows=chunk_rows, capture_uids=capture_uids,
        ).iter_chunks(files, dtype=dtype, require_labels=require_labels)
        return

    cfg = _WorkerConfig(
        index_specs={s: _index_spec(m) for s, m in index_maps.items()},
        shard_configs=dict(shard_configs),
        columns=columns,
        id_tag_columns=tuple(id_tag_columns),
        chunk_rows=chunk_rows,
        capture_uids=capture_uids,
        dtype=np.dtype(dtype).name,
        require_labels=require_labels,
    )
    jobs = iter((cfg, pos, f) for pos, f in enumerate(files))
    import collections
    import concurrent.futures as cf
    import itertools
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    # ProcessPoolExecutor, NOT mp.Pool: an abruptly-dead worker (OOM kill,
    # SIGKILL) raises BrokenProcessPool at result() — mp.Pool silently
    # replaces the worker, loses the job, and a .get() on it hangs forever,
    # which would wedge the training driver's default ingest.
    with cf.ProcessPoolExecutor(max_workers=n_workers, mp_context=ctx,
                                initializer=_worker_init) as pool:
        try:
            # Bounded submission window, not submit-everything: a slow
            # streaming consumer must bound parent-side buffering to
            # ~n_workers+1 files' payloads, never accumulate the whole
            # decoded dataset (the constant-memory contract this iterator
            # exists for). Results are consumed in submission (= file =
            # global row) order; worker exceptions AND worker death
            # surface at result() — fast-fail, never a hang.
            pending: collections.deque = collections.deque(
                pool.submit(_worker_file, job)
                for job in itertools.islice(jobs, n_workers + 1)
            )
            while pending:
                _pos, payloads = pending.popleft().result()
                nxt = next(jobs, None)
                if nxt is not None:
                    pending.append(pool.submit(_worker_file, nxt))
                for p in payloads:
                    yield _payload_chunk(p)
        except BaseException:
            # Worker failure OR abandoned consumer: drop queued work so the
            # with-exit's shutdown(wait=True) only drains files already
            # RUNNING — without this a corrupt file's error would sit
            # behind minutes of pointless decode of every queued file.
            for fut in pending:
                fut.cancel()
            raise


def read_parallel(
    paths,
    index_maps: Mapping[str, IndexMap],
    shard_configs: Mapping[str, object],
    device,
    columns=None,
    id_tag_columns: Sequence[str] = (),
    n_workers: int = 0,
    chunk_rows: int = 1 << 20,
    capture_uids: bool = True,
    dtype=np.float32,
    require_labels: bool = True,
):
    """Read a multi-file Avro dataset with ``n_workers`` decode processes.

    Returns the same ``GameDataBundle`` (same rows, same order) as
    ``StreamingAvroReader.read`` — workers are a throughput detail, not a
    semantics change. ``n_workers <= 1`` stays in-process. Raises
    ``Unsupported`` (like the streaming reader) when the native decoder or
    schema dialect is unavailable.
    """
    from photon_tpu_torch import native
    from photon_tpu_torch.io.data_reader import InputColumnNames, _expand_paths
    from photon_tpu_torch.io.streaming import (
        StreamingAvroReader,
        Unsupported,
        chunks_to_bundle,
    )

    if native.get_lib() is None:
        # Fail BEFORE spawning a pool: every worker would only start a full
        # interpreter to discover the same thing.
        raise Unsupported("native decoder unavailable")
    columns = columns or InputColumnNames()
    files = _expand_paths(paths)
    if int(n_workers) > len(files) > 0:
        import logging

        logging.getLogger("photon_tpu_torch.io").warning(
            "parallel ingest: %d workers requested but only %d input "
            "file(s) — parallelism is per-file (split the input, or accept "
            "%d-way decode)", n_workers, len(files), len(files),
        )
    n_workers = min(int(n_workers), len(files))
    if n_workers <= 1:
        return StreamingAvroReader(
            index_maps, shard_configs, columns, id_tag_columns,
            chunk_rows=chunk_rows, capture_uids=capture_uids,
        ).read(files, device, dtype=dtype, require_labels=require_labels)

    cfg = _WorkerConfig(
        index_specs={s: _index_spec(m) for s, m in index_maps.items()},
        shard_configs=dict(shard_configs),
        columns=columns,
        id_tag_columns=tuple(id_tag_columns),
        chunk_rows=chunk_rows,
        capture_uids=capture_uids,
        dtype=np.dtype(dtype).name,
        require_labels=require_labels,
    )
    jobs = [(cfg, pos, f) for pos, f in enumerate(files)]
    # spawn, not fork: a fork after CUDA initialization is broken. Per-file
    # jobs and imap_unordered stream results back as each file finishes, so
    # a worker holds at most one file's chunks.
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with ctx.Pool(n_workers, initializer=_worker_init) as pool:
        by_pos = dict(pool.imap_unordered(_worker_file, jobs))
    chunks = [
        _payload_chunk(p) for pos in range(len(files)) for p in by_pos[pos]
    ]
    return chunks_to_bundle(chunks, index_maps, id_tag_columns, device, dtype)
