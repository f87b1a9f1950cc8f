"""Step-level checkpoint and resume for GAME training.

Port of ``photon_tpu/checkpoint.py``. After every coordinate-descent step the
whole training state (per-coordinate models, scores, best-model tracking,
tracker records, position) is snapshotted; a restarted fit resumes mid-sweep
and ends with the model the uninterrupted run would have produced, bit for
bit (``tests/test_torch_checkpoint.py``).

* ``save`` copies every tensor of the state to host numpy (on CUDA: every
  copy issued without blocking, then one synchronize) and hands the snapshot
  to a background writer thread: training does not wait for the disk.
* Writes are atomic: the pickle streams to ``<dir>/tmp-<step>-<tag>``, where
  the tag is unique to the manager, then ``os.replace`` renames it to
  ``<dir>/step-<n>``. Two managers may write one directory at once (a
  restarted attempt beside the draining writer of the attempt before it):
  both snapshots of a step hold the same state, so the last rename wins.
* Each file is ``_MAGIC`` + the CRC32 of the payload + the pickle. A
  checksum mismatch or an undecodable payload raises
  :class:`CheckpointCorrupt`, and ``load_latest`` falls back to the
  snapshot before. The magic is the port's own: a file with any other magic
  (a snapshot of the JAX package, whose unpickling would import its
  classes) raises :class:`ForeignCheckpoint` before anything is unpickled,
  and ``load_latest`` does not pass over it. ``run_fingerprint`` names the
  torch backend, so the two packages' run identities never match either.
* The newest ``keep`` snapshots are kept. ``fail_after`` is a test hook: the
  save that reaches that count waits for the disk and raises
  ``KeyboardInterrupt``, as a killed run would stop.
* Loading puts every tensor that lived on the card back on the caller's
  device, in its dtype (CPU tensors stay on the CPU).

The JAX module stamps a compile-store reference into the metadata and calls
fault points; both belong to the runtime-guards slice and are not ported.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import queue
import re
import struct
import threading
import time
import zlib
from typing import Any, Optional

import numpy as np
import torch

logger = logging.getLogger("photon_tpu_torch.checkpoint")

_STEP_RE = re.compile(r"^step-(\d+)$")

# The port's snapshot framing: magic + little-endian CRC32 of the payload.
# It differs from the JAX package's (b"PHCKPT1\x00").
_MAGIC = b"PHTORCH1"


class CheckpointCorrupt(RuntimeError):
    """A snapshot file that must not be trusted: checksum mismatch or an
    undecodable (torn) payload. ``load_latest`` falls back past it."""


class ForeignCheckpoint(ValueError):
    """A file in the checkpoint directory that is not a snapshot of this
    package (another magic: a snapshot of the JAX package, say). Refused
    before unpickling; ``load_latest`` raises it rather than resume past
    it."""


class _Crc32Writer:
    """File-like pass-through that CRCs everything written (the pickle
    streams to disk once, with no copy of the whole blob in memory)."""

    __slots__ = ("_f", "crc")

    def __init__(self, f):
        self._f = f
        self.crc = 0

    def write(self, data) -> int:
        self.crc = zlib.crc32(data, self.crc) & 0xFFFFFFFF
        return self._f.write(data)


def run_fingerprint(parts: Any, length: int = 16) -> str:
    """Stable digest of a run's configuration identity (``repr``-hashed),
    naming the torch backend so no JAX run's fingerprint can equal it."""
    import hashlib

    return hashlib.sha256(
        repr(("photon_tpu_torch", parts)).encode()).hexdigest()[:length]


@dataclasses.dataclass(frozen=True)
class _HostTensor:
    """A tensor of a snapshot, as its host array; ``on_card`` tells a tensor
    that lived on an accelerator (restored on the caller's device) from a
    CPU one (restored on the CPU)."""

    array: np.ndarray
    on_card: bool


_ATOMS = (str, bytes, int, float, bool, complex, type(None), np.ndarray,
          np.generic)


def _map_tree(tree, leaf, memo: dict):
    """``tree`` with ``leaf(x)`` in place of every object ``leaf`` accepts
    (it returns NotImplemented for the rest), through dicts, lists, tuples
    (named ones too) and dataclass instances. Shared objects stay shared
    (``memo`` by id); a dataclass keeps its fields only, so cached
    properties are recomputed after a load."""
    key = id(tree)
    if key in memo:
        return memo[key][1]
    out = leaf(tree)
    if out is NotImplemented:
        if isinstance(tree, _ATOMS) or isinstance(tree, type):
            return tree
        if isinstance(tree, dict):
            out = type(tree)((k, _map_tree(v, leaf, memo)) for k, v in tree.items())
        elif isinstance(tree, list):
            out = [_map_tree(v, leaf, memo) for v in tree]
        elif isinstance(tree, tuple):
            vals = [_map_tree(v, leaf, memo) for v in tree]
            out = type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
        elif dataclasses.is_dataclass(tree):
            out = object.__new__(type(tree))
            for f in dataclasses.fields(tree):
                object.__setattr__(out, f.name,
                                   _map_tree(getattr(tree, f.name), leaf, memo))
        else:
            out = tree
    memo[key] = (tree, out)     # the original is held: its id stays unique
    return out


def _to_host(tree):
    """Every tensor of ``tree`` as a ``_HostTensor``. CUDA tensors are copied
    without blocking and the host waits once for all of them."""
    copies: list = []

    def leaf(x):
        if not isinstance(x, torch.Tensor):
            return NotImplemented
        x = x.detach()
        # A CPU tensor is copied too: the writer thread must not see a
        # later in-place change.
        host = x.to("cpu", non_blocking=True) if x.is_cuda else x.clone()
        wrapped = _HostTensor(None, x.device.type != "cpu")
        copies.append((wrapped, host, x.is_cuda))
        return wrapped

    out = _map_tree(tree, leaf, {})
    if any(on_card for _, _, on_card in copies):
        torch.cuda.synchronize()
    for wrapped, host, _ in copies:
        object.__setattr__(wrapped, "array", host.numpy())
    return out


def _from_host(tree, device: torch.device):
    """Every ``_HostTensor`` of ``tree`` as a tensor on ``device``."""
    def leaf(x):
        if not isinstance(x, _HostTensor):
            return NotImplemented
        t = torch.from_numpy(x.array)
        return t.to(device) if x.on_card else t

    return _map_tree(tree, leaf, {})


@dataclasses.dataclass
class CheckpointManager:
    """Asynchronous, atomic, keep-N checkpoint writer and loader."""

    directory: str
    keep: int = 2
    # Test hook: raise after this many saves (a crash mid-training).
    fail_after: Optional[int] = None

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._tmp_tag = f"{os.getpid():x}-{id(self):x}"
        # Remove tmp files left by crashed predecessors, but only stale
        # ones: a live peer's tmp file is seconds old.
        stale_s = 15 * 60.0
        for name in os.listdir(self.directory):
            if name.startswith("tmp-"):
                path = os.path.join(self.directory, name)
                try:
                    if time.time() - os.path.getmtime(path) > stale_s:
                        os.remove(path)
                except OSError:
                    pass
        self._queue: "queue.Queue" = queue.Queue()
        self._error: Optional[BaseException] = None
        self._saves = 0
        self.last_skipped: list[tuple[int, str]] = []
        # seconds of the last save's host copy; seconds and bytes of the last
        # file the writer thread wrote
        self.last_save_seconds = 0.0
        self.last_write_seconds = 0.0
        self.last_bytes = 0
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------ save

    def save(self, step: int, state: Any, meta: Optional[dict] = None) -> None:
        """Snapshot now (device → host); write to disk in the background."""
        if self._error is not None:
            raise RuntimeError("checkpoint writer failed") from self._error
        t0 = time.perf_counter()
        payload = {"state": _to_host(state), "meta": dict(meta or {}),
                   "step": step}
        self.last_save_seconds = time.perf_counter() - t0
        self._queue.put((step, payload))
        self._saves += 1
        if self.fail_after is not None and self._saves >= self.fail_after:
            self.wait()
            raise KeyboardInterrupt(
                f"simulated crash after {self._saves} checkpoint saves")

    def _drain(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            step, payload = item
            t0 = time.perf_counter()
            try:
                tmp = os.path.join(self.directory, f"tmp-{step}-{self._tmp_tag}")
                with open(tmp, "wb") as f:
                    # Stream the pickle through the CRC (placeholder patched
                    # afterwards) rather than hold the whole blob.
                    f.write(_MAGIC)
                    f.write(struct.pack("<I", 0))
                    crc_writer = _Crc32Writer(f)
                    pickle.dump(payload, crc_writer,
                                protocol=pickle.HIGHEST_PROTOCOL)
                    f.flush()
                    self.last_bytes = f.tell()
                    f.seek(len(_MAGIC))
                    f.write(struct.pack("<I", crc_writer.crc))
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, os.path.join(self.directory, f"step-{step}"))
                self.last_write_seconds = time.perf_counter() - t0
                self._gc()
            except BaseException as e:  # noqa: BLE001 - surfaced on the next save()
                self._error = e
            finally:
                self._queue.task_done()

    def _gc(self) -> None:
        steps = sorted(self._list_steps())
        for s in steps[: -self.keep]:
            try:
                os.remove(os.path.join(self.directory, f"step-{s}"))
            except OSError:
                pass

    def wait(self) -> None:
        """Block until every queued snapshot is on disk."""
        self._queue.join()
        if self._error is not None:
            raise RuntimeError("checkpoint writer failed") from self._error

    def close(self) -> None:
        self.wait()
        self._queue.put(None)
        self._worker.join(timeout=60.0)

    # ------------------------------------------------------------------ load

    def _list_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return out

    def load_file(self, path: str,
                  device: Optional[torch.device] = None) -> dict:
        """Read and verify one snapshot; its tensors come back on ``device``
        (default the CPU). Another magic raises ``ForeignCheckpoint`` and a
        bad checksum or payload ``CheckpointCorrupt``, both before
        unpickling anything untrusted."""
        with open(path, "rb") as f:
            head = f.read(len(_MAGIC))
            if head != _MAGIC:
                if len(head) < len(_MAGIC) and _MAGIC.startswith(head):
                    raise CheckpointCorrupt(f"{path}: truncated checkpoint header")
                raise ForeignCheckpoint(
                    f"{path} is not a snapshot of photon_tpu_torch (magic "
                    f"{head!r}, expected {_MAGIC!r}; a snapshot of the JAX "
                    "package?): refusing to unpickle it; use a fresh "
                    "--checkpoint-dir")
            crc_bytes = f.read(4)
            if len(crc_bytes) < 4:
                raise CheckpointCorrupt(f"{path}: truncated checkpoint header")
            (stored,) = struct.unpack("<I", crc_bytes)
            blob = f.read()
        if zlib.crc32(blob) & 0xFFFFFFFF != stored:
            raise CheckpointCorrupt(
                f"{path}: checksum mismatch (stored {stored:#010x}); refusing "
                "a corrupted snapshot")
        try:
            payload = pickle.loads(blob)
        except Exception as e:
            raise CheckpointCorrupt(
                f"{path}: undecodable payload ({type(e).__name__}: {e})") from e
        return _from_host(payload, torch.device("cpu") if device is None
                          else device)

    def load_latest(self, device: Optional[torch.device] = None) -> Optional[dict]:
        """The newest trustworthy snapshot, or None. A corrupt newest file
        (a torn write, a checksum refusal) falls back to the one before;
        each refusal is logged and kept in ``last_skipped`` as
        ``(step, reason)``. A foreign file raises."""
        self.last_skipped = []
        for s in sorted(self._list_steps(), reverse=True):
            path = os.path.join(self.directory, f"step-{s}")
            try:
                return self.load_file(path, device)
            except CheckpointCorrupt as e:
                logger.warning("refusing checkpoint step-%d (%s); falling back "
                               "to the previous snapshot", s, e)
                self.last_skipped.append((s, str(e)))
            except ForeignCheckpoint:
                raise
            except OSError as e:
                self.last_skipped.append((s, f"unreadable: {e}"))
        return None

    def load_checked(self, kind: str, fingerprint: str,
                     device: Optional[torch.device] = None) -> Optional[dict]:
        """``load_latest`` guarded by run identity: a snapshot of another
        kind or fingerprint raises rather than resume incompatible state.
        Pair with ``save(..., meta={'kind': kind, 'fingerprint':
        fingerprint, ...})``."""
        payload = self.load_latest(device)
        if payload is None:
            return None
        meta = payload.get("meta", {})
        if meta.get("kind") != kind or meta.get("fingerprint") != fingerprint:
            raise ValueError(
                "checkpoint directory holds snapshots from a run with a "
                f"different configuration (kind={meta.get('kind')!r}): "
                "resuming would mix incompatible state; use a fresh "
                "--checkpoint-dir")
        return payload
