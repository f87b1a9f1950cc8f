"""The durable delta log: write-once fan-out for online model deltas.

A copy of the JAX package's ``replication/log.py`` (it imports neither
torch nor JAX); ``tests/test_torch_replication.py`` compares the code, so
edit both or neither.

Generalizes the event-log machinery (``online/events.py``) and the patch
journal (``online/delta.py``) into the replication substrate: the online
trainer's publisher appends each :class:`ModelDelta` ONCE, and any number
of serving replicas tail the file independently, each with its own atomic
cursor. One record per line, one ``os.write`` + ``os.fsync`` per record
on an O_APPEND fd, so a tailing replica never sees a torn line
mid-record and a crashed host never loses a record whose append
returned.

Record schema (``delta-log.jsonl``):

    {"seq": 12, "ts": 1754300000.1, "trace_id": "a1b2...",
     "delta": {"seq": 7, "event_horizon": 4096, "patches": {...}}}

    {"seq": 13, "ts": 1754300100.0, "trace_id": null,
     "snapshot": {"model_dir": "out/nightly/best", "note": "retrain"}}

``seq`` is the LOG sequence — dense, monotone, assigned by the writer
(resuming a log continues from the tail); ``delta.seq`` inside stays the
trainer's own delta sequence. A ``snapshot`` record is a full-model
marker: "a registry built from ``model_dir`` holds all state through this
log seq" — the catch-up shortcut for a replica whose lag exceeds its
threshold (docs/serving.md §"Replication": jump to the marker via
``prepare_standby``/``swap``, resume tailing at ``seq + 1``).

``trace_id`` is the publisher's trace id at append time: the tailer
applies under the same id, so the fleet merger joins publish→apply across
processes exactly like the HTTP header path does.

Reader discipline (:func:`iter_log`): the log is dense by construction, so
the reader PROVES exactly-once — a record whose seq it has already passed
is a duplicate (skipped, reported via ``on_duplicate``), a seq beyond the
next expected is a GAP (a corrupt or truncated log: refused loudly, never
silently skipped), and an unterminated final line is a write in flight
(waited on under ``follow``, skipped otherwise).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Callable, Iterator, Optional

from photon_tpu_torch.online.delta import ModelDelta

logger = logging.getLogger("photon_tpu_torch.replication")

LOG_FILENAME = "delta-log.jsonl"


def _fsync_dir(path: str) -> None:
    """fsync a DIRECTORY so a just-created/renamed entry survives a
    crash (best-effort: not every platform/filesystem allows it)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class DeltaLogError(ValueError):
    """A corrupt delta log (torn non-tail line, seq gap, bad record) —
    must fail loud: a replica silently skipping records would serve
    permanently divergent coefficients."""


@dataclasses.dataclass(frozen=True)
class DeltaLogRecord:
    """One parsed log record: a delta or a full-snapshot marker."""

    seq: int
    ts: float
    trace_id: Optional[str]
    delta: Optional[ModelDelta] = None
    snapshot: Optional[dict] = None      # {"model_dir": ..., "note": ...}

    @property
    def is_snapshot(self) -> bool:
        return self.snapshot is not None

    @classmethod
    def from_dict(cls, d: dict, path: str = "<log>") -> "DeltaLogRecord":
        if not isinstance(d, dict) or "seq" not in d:
            raise DeltaLogError(f"{path}: record missing 'seq': {d!r:.120}")
        seq = int(d["seq"])
        ts = float(d.get("ts") or 0.0)
        tid = d.get("trace_id") or None
        if d.get("snapshot") is not None:
            snap = d["snapshot"]
            if not isinstance(snap, dict) or not snap.get("model_dir"):
                raise DeltaLogError(
                    f"{path}: seq {seq}: snapshot marker needs a model_dir")
            return cls(seq=seq, ts=ts, trace_id=tid, snapshot=dict(snap))
        try:
            delta = ModelDelta.from_wire(d.get("delta") or {})
        except ValueError as e:
            raise DeltaLogError(
                f"{path}: seq {seq}: bad delta record: {e}") from None
        return cls(seq=seq, ts=ts, trace_id=tid, delta=delta)


def _tail_next_seq(path: str, window: int = 1 << 16) -> int:
    """``last complete line's seq + 1`` from the file TAIL only (seqs are
    dense-monotone, so the last complete line suffices; a torn final line
    was never durably published and is ignored — same contract as
    ``events._tail_next_seq``)."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return 0
    if size == 0:
        return 0
    with open(path, "rb") as f:
        f.seek(max(0, size - window))
        tail = f.read()
    complete = tail[: tail.rfind(b"\n") + 1] if b"\n" in tail else b""
    lines = [x for x in complete.split(b"\n") if x.strip()]
    for raw in reversed(lines):
        try:
            return int(json.loads(raw).get("seq", -1)) + 1
        except (ValueError, AttributeError, TypeError):
            continue
    # No parseable line in the window (pathologically long records): full
    # scan, rare and loud-safe.
    next_seq = 0
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                if not line.endswith("\n") or not line.strip():
                    continue
                try:
                    next_seq = max(next_seq,
                                   int(json.loads(line).get("seq", -1)) + 1)
                except ValueError:
                    continue
    except OSError:
        pass
    return next_seq


def log_next_seq(path: str) -> int:
    """The log HEAD: the seq the next append will get. ``head - cursor``
    is a replica's lag."""
    return _tail_next_seq(path)


def pending_records(path: str, start_seq: int = 0,
                    end_seq: Optional[int] = None) -> list:
    """Materialize ``[start_seq, end_seq)`` as a list (non-follow read).

    The control plane's canary window read: the controller snapshots a
    wave's records at soak begin so its promote decision appends exactly
    the records it adjudicated, even if the trainer keeps publishing into
    the side channel mid-soak. Same seq discipline as :func:`iter_log`
    (duplicates skipped, gaps refused)."""
    out = []
    for rec in iter_log(path, start_seq=start_seq, follow=False):
        if rec is None:
            continue
        if end_seq is not None and rec.seq >= end_seq:
            break
        out.append(rec)
    return out


class DeltaLogWriter:
    """Durable appender assigning dense monotone log ``seq``; resuming an
    existing log continues the sequence from its tail.

    Durability contract: ``append`` returns only after the record is
    written AND fsynced — the trainer's commit-after-publish step may
    advance past a delta the moment ``publish`` returns, so a host crash
    must not be able to eat a record the trainer already committed past.
    (The log's directory entry is fsynced once at creation; renames never
    touch this file afterwards, appends only.)"""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(path) or "."
        os.makedirs(parent, exist_ok=True)
        existed = os.path.exists(path)
        self._next_seq = _tail_next_seq(path)
        self._fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                           0o644)
        if not existed:
            _fsync_dir(parent)

    @property
    def next_seq(self) -> int:
        return self._next_seq

    def _append_row(self, row: dict) -> int:
        seq = self._next_seq
        self._next_seq += 1
        row = {"seq": seq, "ts": time.time(), **row}
        os.write(self._fd, (json.dumps(row) + "\n").encode("utf-8"))
        # Page cache is not durability: a power loss could otherwise
        # drop a record whose publish already returned (class doc).
        os.fsync(self._fd)
        return seq

    def append(self, delta: ModelDelta,
               trace_id: Optional[str] = None) -> int:
        """Append one delta; returns its assigned log seq."""
        return self._append_row(
            {"trace_id": trace_id, "delta": delta.to_wire()})

    def append_snapshot(self, model_dir: str,
                        note: Optional[str] = None) -> int:
        """Append a full-snapshot marker: ``model_dir`` holds everything
        through the assigned seq. Written at log creation for the base
        model, and whenever a batch retrain republishes a full model —
        the catch-up shortcut lagging replicas jump to."""
        return self._append_row(
            {"trace_id": None,
             "snapshot": {"model_dir": str(model_dir),
                          **({"note": note} if note else {})}})

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self) -> "DeltaLogWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def iter_log(
    path: str,
    start_seq: int = 0,
    follow: bool = False,
    poll_s: float = 0.05,
    stop: Optional[Callable[[], bool]] = None,
    idle_yield_s: float = 0.0,
    on_duplicate: Optional[Callable[[int], None]] = None,
) -> Iterator[Optional[DeltaLogRecord]]:
    """Replay records with ``seq >= start_seq``; ``follow=True`` tails the
    log until ``stop()`` returns true.

    Seq discipline (the exactly-once half the cursor can't supply alone):
    the log is dense, so after the first yielded record each next record
    must carry exactly ``previous + 1``. A record at an already-passed seq
    is a DUPLICATE — skipped, counted via ``on_duplicate(seq)`` (a replayed
    or concatenated log must not double-apply). A record BEYOND the next
    expected seq is a GAP — :class:`DeltaLogError`, because silently
    skipping it would leave this replica permanently divergent.

    ``idle_yield_s > 0`` (follow mode) yields ``None`` after that long
    without a new record — an idle tick, so the tailer can refresh its lag
    gauge on a quiet stream. A final line without a newline is a write in
    flight: waited on under follow, skipped with a warning otherwise.
    """
    expected = int(start_seq)
    with open(path, "r", encoding="utf-8") as f:
        buf = ""
        idle_since = time.monotonic()
        while True:
            chunk = f.readline()
            if chunk:
                buf += chunk
                if not buf.endswith("\n"):
                    continue  # torn tail: wait for the rest of the line
                line, buf = buf.strip(), ""
                if not line:
                    continue
                try:
                    d = json.loads(line)
                except ValueError:
                    raise DeltaLogError(
                        f"{path}: corrupt log line: {line[:120]!r}"
                    ) from None
                rec = DeltaLogRecord.from_dict(d, path)
                idle_since = time.monotonic()
                if rec.seq < expected:
                    if rec.seq >= start_seq:
                        # Passed already: a duplicate, never re-applied.
                        logger.warning(
                            "%s: duplicate log seq %d skipped (expected "
                            "%d)", path, rec.seq, expected)
                        if on_duplicate is not None:
                            on_duplicate(rec.seq)
                    continue  # below start_seq: already consumed, silent
                if rec.seq > expected:
                    raise DeltaLogError(
                        f"{path}: seq gap: expected {expected}, found "
                        f"{rec.seq} — the log is corrupt or truncated "
                        "mid-stream; refusing to skip records")
                expected = rec.seq + 1
                yield rec
                continue
            # EOF
            if not follow:
                if buf:
                    logger.warning(
                        "%s: unterminated final line (%d bytes) skipped — "
                        "a write in flight; the cursor has not passed it",
                        path, len(buf),
                    )
                return
            if stop is not None and stop():
                return
            if idle_yield_s > 0 and \
                    time.monotonic() - idle_since >= idle_yield_s:
                idle_since = time.monotonic()
                yield None  # idle tick
            time.sleep(poll_s)


def find_latest_snapshot(path: str,
                         min_seq: int = 0) -> Optional[DeltaLogRecord]:
    """The LATEST snapshot marker with ``seq >= min_seq`` (full scan —
    called once per catch-up decision, not per record). None when the log
    holds no eligible marker, in which case catch-up degrades to plain
    replay."""
    latest = None
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                if not line.endswith("\n") or not line.strip():
                    continue
                try:
                    d = json.loads(line)
                except ValueError:
                    continue  # torn/corrupt lines are the reader's problem
                if d.get("snapshot") is not None and \
                        int(d.get("seq", -1)) >= min_seq:
                    latest = DeltaLogRecord.from_dict(d, path)
    except OSError:
        return None
    return latest


class ReplicaCursor:
    """One replica's exactly-once AUDIT watermark, persisted atomically
    as ``<dir>/replica-cursor.<replica_id>.json``.

    ``next_seq`` is the first log seq this replica identity has not yet
    journaled as applied — saved only after ``ModelRegistry.apply_delta``
    returns. It deliberately does NOT set where a rebooted replica starts
    applying: registry state is in-memory only, so every boot replays the
    log from 0 (or a snapshot marker) to rebuild it, journaling
    pre-cursor records as replays (``replication/tailer.py`` module doc).
    The cursor's job is lag accounting and keeping the per-seq
    ``replica_delta_applied`` audit rows exactly-once across
    incarnations. Saves fsync the temp file before the atomic replace,
    so a crash can never leave a cursor pointing past rows the journal
    never recorded."""

    def __init__(self, out_dir: str, replica_id: str):
        safe = "".join(c if (c.isalnum() or c in "-_.") else "_"
                       for c in str(replica_id))
        self.replica_id = str(replica_id)
        self.path = os.path.join(out_dir, f"replica-cursor.{safe}.json")
        os.makedirs(out_dir, exist_ok=True)

    def load(self) -> int:
        try:
            with open(self.path) as f:
                return int(json.load(f).get("next_seq", 0))
        except (OSError, ValueError):
            return 0

    def save(self, next_seq: int, applied_total: int = 0) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "next_seq": int(next_seq),
                "replica_id": self.replica_id,
                "applied_total": int(applied_total),
                "updated_at": time.strftime(
                    "%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            }, f)
            f.flush()
            os.fsync(f.fileno())    # content durable BEFORE the rename
        os.replace(tmp, self.path)  # atomic: never a torn cursor
        _fsync_dir(os.path.dirname(self.path) or ".")


class DeltaLogPublisher:
    """Online-trainer publisher writing to the durable delta log: the
    trainer publishes ONCE; every replica fans out by tailing. The
    publish-time trace id rides the record so each replica's apply span
    joins the trainer's publish span in the merged fleet timeline."""

    def __init__(self, path: str, snapshot_model_dir: Optional[str] = None):
        self.writer = DeltaLogWriter(path)
        # Base snapshot marker at log creation: a brand-new log's first
        # record tells late-joining replicas which full model dir is the
        # floor everything after builds on (the catch-up anchor).
        if snapshot_model_dir and self.writer.next_seq == 0:
            self.writer.append_snapshot(snapshot_model_dir, note="base")

    @property
    def path(self) -> str:
        return self.writer.path

    def publish(self, delta: ModelDelta) -> dict:
        from photon_tpu_torch.obs import current_trace_id

        seq = self.writer.append(delta, trace_id=current_trace_id())
        return {"log_seq": seq, "log_path": self.writer.path}

    def close(self) -> None:
        self.writer.close()


class FanoutPublisher:
    """Compose publishers: the delta log AND a direct HTTP push during a
    migration window (each ``publish`` must succeed — the trainer's
    commit-after-publish contract covers them all)."""

    def __init__(self, *publishers):
        self.publishers = [p for p in publishers if p is not None]
        if not self.publishers:
            raise ValueError("FanoutPublisher needs >= 1 publisher")

    def publish(self, delta: ModelDelta) -> dict:
        out: dict = {}
        for p in self.publishers:
            r = p.publish(delta)
            if isinstance(r, dict):
                out.update(r)
        return out

    def close(self) -> None:
        for p in self.publishers:
            if hasattr(p, "close"):
                p.close()
