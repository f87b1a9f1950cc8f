"""Online event log: JSONL schema, durable append, replay cursor, resolver.

A copy of the JAX package's ``online/events.py`` (it imports neither torch
nor JAX); ``tests/test_torch_online.py`` compares the code, so edit both
or neither.

One event = one labeled observation (docs/online.md §"Event schema"):

    {"seq": 17, "ts": 1754300000.1,
     "entities": {"userId": "u3"},
     "features": [{"name": "c", "term": "4", "value": 1.2}],
     "label": 1.0, "offset": 0.0, "weight": 1.0}

``features`` is either a flat list (the default ``features`` bag) or a map
of bag → list, mirroring the training records' feature-bag fields and the
serving request schema — the three ingest surfaces stay one dialect.
``seq`` is assigned monotonically by the writer; the replay cursor persists
``next_seq`` so a restarted trainer resumes exactly where it stopped
(events below the cursor were fully refreshed AND published — the cursor
only advances after a successful delta publish).

Appends go through the same O_APPEND whole-line discipline as
``utils/logging.write_metrics_jsonl`` (each line written in one syscall),
so a concurrent producer and a tailing trainer never see a torn line; the
reader side treats an unterminated final line as "not yet written" and
(under ``follow=True``) waits for the rest.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Callable, Iterator, Mapping, Optional, Sequence

import numpy as np

logger = logging.getLogger("photon_tpu_torch.online")


class EventError(ValueError):
    """A malformed event (bad schema, over-cap features) — the producer's
    bug, reported per event so one bad record never kills the stream."""


@dataclasses.dataclass(frozen=True)
class OnlineEvent:
    """One labeled observation on the stream."""

    entities: Mapping[str, str]          # re_type -> entity key
    features: Mapping[str, Sequence]     # bag -> [{"name","term","value"}]
    label: float
    offset: float = 0.0
    weight: float = 1.0
    ts: float = 0.0                      # producer timestamp (epoch seconds)
    seq: int = -1                        # assigned by the writer

    def __post_init__(self):
        if isinstance(self.features, (list, tuple)):
            # A flat list means the default "features" bag, as on the wire.
            object.__setattr__(self, "features",
                               {"features": list(self.features)})

    def to_dict(self) -> dict:
        return {
            "seq": self.seq,
            "ts": self.ts,
            "entities": dict(self.entities),
            "features": {k: list(v) for k, v in self.features.items()},
            "label": self.label,
            "offset": self.offset,
            "weight": self.weight,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "OnlineEvent":
        if not isinstance(d, dict):
            raise EventError(f"event must be a JSON object, got {type(d)}")
        feats = d.get("features") or {}
        if isinstance(feats, (list, tuple)):
            feats = {"features": list(feats)}  # flat list = default bag
        if not isinstance(feats, dict):
            raise EventError('"features" must be a list or a bag map')
        entities = d.get("entities") or {}
        if not isinstance(entities, dict):
            raise EventError('"entities" must be a map of RE type -> id')
        if "label" not in d:
            raise EventError('event missing required "label"')
        try:
            return cls(
                entities={str(k): str(v) for k, v in entities.items()},
                features=feats,
                label=float(d["label"]),
                offset=float(d.get("offset") or 0.0),
                weight=float(d.get("weight", 1.0)),
                ts=float(d.get("ts") or 0.0),
                seq=int(d.get("seq", -1)),
            )
        except (TypeError, ValueError) as e:
            raise EventError(f"bad event field: {e}") from None


class EventWriter:
    """Durable JSONL appender assigning monotone ``seq``.

    Each event lands as ONE ``os.write`` of a full line on an O_APPEND fd —
    the same whole-line-atomic contract as ``write_metrics_jsonl`` (no
    rotation here: the event log is the replay substrate and ``seq`` is the
    cursor's coordinate system). Resuming an existing log continues the
    sequence from the last recorded ``seq``.
    """

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._next_seq = _tail_next_seq(path)
        self._fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                           0o644)

    @property
    def next_seq(self) -> int:
        return self._next_seq

    def append(self, event: OnlineEvent) -> int:
        """Write one event; returns its assigned ``seq``."""
        seq = self._next_seq
        self._next_seq += 1
        d = event.to_dict()
        d["seq"] = seq
        if not d["ts"]:
            d["ts"] = time.time()
        os.write(self._fd, (json.dumps(d) + "\n").encode("utf-8"))
        return seq

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self) -> "EventWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _tail_next_seq(path: str, window: int = 1 << 16) -> int:
    """``last complete line's seq + 1`` by reading only the file TAIL
    (seqs are monotone, so the last line suffices — a full-log parse per
    writer open would make repeated ``append_events`` batches O(n²)).
    Falls back to a full scan only when the final ``window`` bytes hold no
    complete line (pathologically long records)."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return 0
    if size == 0:
        return 0
    with open(path, "rb") as f:
        f.seek(max(0, size - window))
        tail = f.read()
    # Drop a torn final line (write in flight / crashed writer): its seq
    # was never durably published, and the reader skips it too.
    complete = tail[: tail.rfind(b"\n") + 1] if b"\n" in tail else b""
    lines = [x for x in complete.split(b"\n") if x.strip()]
    if lines:
        # Lines before the first newline of a mid-file window may be
        # partial — walk from the END, where lines are whole.
        for raw in reversed(lines):
            try:
                return int(json.loads(raw).get("seq", -1)) + 1
            except (ValueError, AttributeError, TypeError):
                continue
    # No parseable line in the window: full scan (rare, loud to stay safe).
    next_seq = 0
    for ev in iter_events(path):
        next_seq = max(next_seq, ev.seq + 1)
    return next_seq


def append_events(path: str, events: Sequence[OnlineEvent]) -> int:
    """One-shot append; returns the first assigned seq."""
    with EventWriter(path) as w:
        first = w.next_seq
        for ev in events:
            w.append(ev)
    return first


def iter_events(
    path: str,
    start_seq: int = 0,
    follow: bool = False,
    poll_s: float = 0.05,
    stop: Optional[Callable[[], bool]] = None,
    idle_yield_s: float = 0.0,
) -> Iterator[OnlineEvent]:
    """Replay events with ``seq >= start_seq``; ``follow=True`` tails the
    log (polling) until ``stop()`` returns true.

    ``idle_yield_s > 0`` (follow mode) yields ``None`` after that long
    without a new event — an IDLE TICK, so a consumer driving a refresh
    cadence (``OnlineTrainer.run``) still fires on a quiet stream instead
    of blocking in the poll loop with dirty entities unpublished.

    A final line without a newline is a write in flight: under follow the
    reader waits for the rest; without follow it is skipped with a warning
    (the next run's cursor has not passed it, so nothing is lost). A
    malformed COMPLETE line raises :class:`EventError` — a corrupt log must
    fail loud, not silently drop labeled data.
    """
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
                    raise EventError(
                        f"{path}: corrupt event line: {line[:120]!r}"
                    ) from None
                ev = OnlineEvent.from_dict(d)
                idle_since = time.monotonic()
                if ev.seq >= start_seq:
                    yield ev
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
                yield None  # idle tick: let the consumer's cadence fire
            time.sleep(poll_s)


class EventCursor:
    """Replay position, persisted as ``<dir>/online-cursor.json``.

    ``next_seq`` is the first UNPUBLISHED event: the trainer saves the
    cursor only after a delta publish succeeds, so a crash between refresh
    and publish replays those events — refreshes are idempotent re-solves
    over the window, so replay converges to the same coefficients.
    """

    FILENAME = "online-cursor.json"

    def __init__(self, out_dir: str):
        self.path = os.path.join(out_dir, self.FILENAME)
        os.makedirs(out_dir, exist_ok=True)

    def load(self) -> int:
        try:
            with open(self.path) as f:
                return int(json.load(f).get("next_seq", 0))
        except (OSError, ValueError):
            return 0

    def save(self, next_seq: int) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "next_seq": int(next_seq),
                "updated_at": time.strftime(
                    "%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            }, f)
        os.replace(tmp, self.path)  # atomic: never a torn cursor


def resolve_event_features(
    event: OnlineEvent,
    index_maps: Mapping[str, object],
    shard_configs: Mapping[str, object],
    shards: Sequence[str],
    max_nnz: int,
) -> dict:
    """Event feature bags → fixed-width ELL rows, one per shard.

    The same resolution rules as the serving request parser
    (``RowScorer.parse_request``) and the reader: features resolve through
    the shard's index map, unindexed features DROP, the intercept column is
    prepended when the shard config says so, and a row over ``max_nnz``
    indexed features is refused (stable-shape contract — raise the knob,
    never truncate). Returns ``{shard: (idx[int32 K], val[float32 K])}``
    with ghost padding ``== len(index_map)``.
    """
    out = {}
    for shard in shards:
        imap = index_maps[shard]
        cfg = shard_configs[shard]
        dim = len(imap)
        idxs, vals = [], []
        icpt = imap.intercept_index if getattr(cfg, "add_intercept", False) \
            else None
        if icpt is not None and icpt >= 0:
            idxs.append(icpt)
            vals.append(1.0)
        for bag in cfg.feature_bags:
            feats = event.features.get(bag)
            if feats is None:
                continue
            for feat in feats:
                try:
                    i = imap.get_index(feat["name"], feat.get("term"))
                    v = float(feat["value"])
                except (TypeError, KeyError, ValueError) as e:
                    raise EventError(
                        f"bad feature entry in bag {bag!r}: {e}"
                    ) from None
                if i >= 0:  # unindexed features dropped, as the reader
                    idxs.append(i)
                    vals.append(v)
        if len(idxs) > max_nnz:
            raise EventError(
                f"event has {len(idxs)} indexed features in shard "
                f"{shard!r}; the online trainer caps rows at "
                f"max_event_nnz={max_nnz} (raise the knob, don't truncate)"
            )
        row_i = np.full(max_nnz, dim, np.int32)
        row_v = np.zeros(max_nnz, np.float32)
        row_i[: len(idxs)] = idxs
        row_v[: len(vals)] = vals
        out[shard] = (row_i, row_v)
    return out
