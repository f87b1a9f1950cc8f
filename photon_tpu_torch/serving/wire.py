"""Binary wire encoding for the serving front line (docs/serving.md §wire).

A copy of the JAX package's ``serving/wire.py``: it imports neither JAX nor
torch, and ``tests/test_torch_frontline.py`` compares the code, so edit
both or neither.

One frame format serves two boundaries:

* the **IPC hop** between a front-end worker and the device-owning scorer
  process (every request crosses it, so parse cost is the front line's
  per-row CPU floor), and
* the **HTTP edge**, where a trusted co-located client (the bench, a
  router on the same box) may POST a pre-encoded frame with
  ``Content-Type: application/x-photon-wire`` instead of JSON — JSON is
  still accepted everywhere, the binary path is an opt-in fast lane.

Design rules:

* little-endian throughout; a fixed 16-byte header carries magic,
  version, frame kind, flags, and a request id — decoders REFUSE unknown
  magic/version loudly (``WireError``) instead of guessing;
* feature arrays travel **pre-resolved and pre-padded**: ``int32`` column
  ids + ``float32`` values at the serving row width ``k`` (=
  ``max_row_nnz``), straight ``ndarray.tobytes()`` / ``np.frombuffer``
  with zero per-feature marshalling — the decode cost of a row is two
  buffer views, not a JSON tree walk;
* entity keys ride as flagged UTF-8 strings; a worker that verified a key
  MISSING in its read-only mmap store marks it ``KNOWN_MISS`` with the
  store generation it checked, so the scorer can skip the dead lookup when
  the generation still matches (deltas bump it — correctness never
  depends on worker store freshness);
* control traffic (tune/healthz/drain/hello/heartbeat) is framed the same
  way but carries JSON — it is not the hot path, and keeping it schemaless
  lets the admin surface grow without a wire version bump.

This module is deliberately **jax-free**: front-end workers import it at
boot and must never pay (or depend on) an accelerator runtime.
"""
from __future__ import annotations

import dataclasses
import json
import struct
from typing import Mapping, Optional, Sequence

import numpy as np

MAGIC = b"PhW1"
VERSION = 1

# Frame kinds.
KIND_SCORE_REQ = 1
KIND_SCORE_RESP = 2
KIND_CTL_REQ = 3
KIND_CTL_RESP = 4
KIND_HEARTBEAT = 5

# Response status codes (mirror the HTTP edge contract).
STATUS_OK = 0
STATUS_BAD_REQUEST = 1    # HTTP 400
STATUS_OVERLOADED = 2     # HTTP 503 + Retry-After (shed)
STATUS_DEADLINE = 3       # HTTP 503 (expired)
STATUS_INTERNAL = 4       # HTTP 500
STATUS_DRAINING = 5       # HTTP 503 + Retry-After (drain)

# Response flag bits.
RESP_FLAG_TRACE_PROMOTED = 0x01  # scorer's tail sampler kept this chain

# Per-(row, coordinate) entity flags.
ENT_NONE = 0         # no key: fixed-effect-only row by request
ENT_KEY = 1          # key attached, scorer resolves it
ENT_KNOWN_MISS = 3   # key attached but worker-verified absent from the
#                      store at the frame's store_generation

_HEADER = struct.Struct("<4sHBBQ")  # magic, version, kind, flags, req_id
HEADER_SIZE = _HEADER.size

WIRE_CONTENT_TYPE = "application/x-photon-wire"


class WireError(ValueError):
    """Malformed, truncated, or wrong-version frame (client error)."""


@dataclasses.dataclass
class WireRow:
    """One pre-resolved scoring row (structurally a scorer ``ParsedRow``).

    ``known_miss`` lists RE coordinate ids whose key the ENCODING side
    verified absent from its (read-only, possibly stale) coefficient
    store; the decoder surfaces them so the scorer can skip the lookup
    when store generations match.
    """

    shard_idx: Mapping[str, np.ndarray]      # shard -> [K] int32
    shard_val: Mapping[str, np.ndarray]      # shard -> [K] float32
    offset: float
    entity_keys: Mapping[str, Optional[str]]  # RE coordinate -> key
    known_miss: frozenset = frozenset()


@dataclasses.dataclass
class ScoreRequest:
    req_id: int
    trace_id: str
    deadline_ms: float        # 0 = server default timeout
    store_generation: int
    rows: Sequence[WireRow]


@dataclasses.dataclass
class ScoreResponse:
    req_id: int
    status: int = STATUS_OK
    error: str = ""
    retry_after_s: float = 0.0
    model_version: int = 0
    flags: int = 0
    scores: np.ndarray = None
    degraded: Sequence[tuple] = ()        # per row: tuple of RE coord ids
    stages: Mapping[str, float] = None    # stage -> seconds (f64)

    @property
    def trace_promoted(self) -> bool:
        return bool(self.flags & RESP_FLAG_TRACE_PROMOTED)


class _Writer:
    __slots__ = ("buf",)

    def __init__(self):
        self.buf = bytearray()

    def raw(self, b) -> None:
        self.buf += b

    def pack(self, fmt: str, *vals) -> None:
        self.buf += struct.pack(fmt, *vals)

    def str8(self, s: str) -> None:
        b = s.encode("utf-8")
        if len(b) > 0xFF:
            raise WireError(f"string too long for u8 length: {len(b)}")
        self.buf += struct.pack("<B", len(b))
        self.buf += b

    def str16(self, s: str) -> None:
        b = s.encode("utf-8")
        if len(b) > 0xFFFF:
            raise WireError(f"string too long for u16 length: {len(b)}")
        self.buf += struct.pack("<H", len(b))
        self.buf += b


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise WireError(
                f"truncated frame: need {n} bytes at offset {self.pos}, "
                f"have {len(self.buf) - self.pos}"
            )
        out = self.buf[self.pos: self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        s = struct.Struct(fmt)
        vals = s.unpack(self.take(s.size))
        return vals if len(vals) > 1 else vals[0]

    def str8(self) -> str:
        n = self.unpack("<B")
        return self.take(n).decode("utf-8")

    def str16(self) -> str:
        n = self.unpack("<H")
        return self.take(n).decode("utf-8")

    def array(self, dtype, count: int) -> np.ndarray:
        it = np.dtype(dtype).itemsize
        raw = self.take(it * count)
        return np.frombuffer(raw, dtype=dtype, count=count)


def _header(kind: int, req_id: int, flags: int = 0) -> bytes:
    return _HEADER.pack(MAGIC, VERSION, kind, flags, req_id)


def frame_kind(buf: bytes) -> tuple[int, int]:
    """Peek ``(kind, req_id)`` after validating magic + version."""
    if len(buf) < HEADER_SIZE:
        raise WireError(f"frame shorter than header: {len(buf)} bytes")
    magic, version, kind, _flags, req_id = _HEADER.unpack_from(buf, 0)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r} (want {MAGIC!r})")
    if version != VERSION:
        raise WireError(
            f"unsupported wire version {version} (this build speaks "
            f"{VERSION})"
        )
    return kind, req_id


def is_wire(body: bytes) -> bool:
    """Cheap sniff for the HTTP edge: does this body claim to be a frame?"""
    return len(body) >= 4 and body[:4] == MAGIC


# ------------------------------------------------------------- score request


def encode_score_request(
    rows: Sequence[WireRow],
    *,
    req_id: int = 0,
    trace_id: str = "",
    deadline_ms: float = 0.0,
    store_generation: int = 0,
) -> bytes:
    if not rows:
        raise WireError("a score request must carry at least one row")
    if len(rows) > 0xFFFF:
        raise WireError(f"too many rows in one frame: {len(rows)}")
    shards = sorted(rows[0].shard_idx)
    res = sorted(rows[0].entity_keys)
    if len(shards) > 0xFF or len(res) > 0xFF:
        raise WireError("too many shards / RE coordinates for the frame")
    k = int(rows[0].shard_idx[shards[0]].shape[0]) if shards else 0
    w = _Writer()
    w.raw(_header(KIND_SCORE_REQ, req_id))
    w.pack("<If", store_generation, deadline_ms)
    w.str8(trace_id)
    w.pack("<HHBB", len(rows), k, len(shards), len(res))
    for s in shards:
        w.str8(s)
    for cid in res:
        w.str8(cid)
    for s in shards:
        mi = np.empty((len(rows), k), np.int32)
        mv = np.empty((len(rows), k), np.float32)
        for r, row in enumerate(rows):
            mi[r] = row.shard_idx[s]
            mv[r] = row.shard_val[s]
        w.raw(mi.tobytes())
        w.raw(mv.tobytes())
    w.raw(np.asarray([row.offset for row in rows], np.float32).tobytes())
    for row in rows:
        for cid in res:
            key = row.entity_keys.get(cid)
            if key is None:
                w.pack("<B", ENT_NONE)
            else:
                flag = (ENT_KNOWN_MISS if cid in row.known_miss
                        else ENT_KEY)
                w.pack("<B", flag)
                w.str16(str(key))
    return bytes(w.buf)


def decode_score_request(buf: bytes) -> ScoreRequest:
    kind, req_id = frame_kind(buf)
    if kind != KIND_SCORE_REQ:
        raise WireError(f"expected score request, got frame kind {kind}")
    r = _Reader(buf, HEADER_SIZE)
    store_generation, deadline_ms = r.unpack("<If")
    trace_id = r.str8()
    n_rows, k, n_shards, n_re = r.unpack("<HHBB")
    shards = [r.str8() for _ in range(n_shards)]
    res = [r.str8() for _ in range(n_re)]
    per_shard = {}
    for s in shards:
        mi = r.array(np.int32, n_rows * k).reshape(n_rows, k)
        mv = r.array(np.float32, n_rows * k).reshape(n_rows, k)
        per_shard[s] = (mi, mv)
    offsets = r.array(np.float32, n_rows)
    rows = []
    for i in range(n_rows):
        keys, miss = {}, set()
        for cid in res:
            flag = r.unpack("<B")
            if flag == ENT_NONE:
                keys[cid] = None
            elif flag in (ENT_KEY, ENT_KNOWN_MISS):
                keys[cid] = r.str16()
                if flag == ENT_KNOWN_MISS:
                    miss.add(cid)
            else:
                raise WireError(f"unknown entity flag {flag}")
        rows.append(WireRow(
            shard_idx={s: per_shard[s][0][i] for s in shards},
            shard_val={s: per_shard[s][1][i] for s in shards},
            offset=float(offsets[i]),
            entity_keys=keys,
            known_miss=frozenset(miss),
        ))
    return ScoreRequest(
        req_id=req_id,
        trace_id=trace_id,
        deadline_ms=float(deadline_ms),
        store_generation=int(store_generation),
        rows=rows,
    )


# ------------------------------------------------------------ score response


def encode_score_response(
    req_id: int,
    *,
    status: int = STATUS_OK,
    error: str = "",
    retry_after_s: float = 0.0,
    model_version: int = 0,
    flags: int = 0,
    scores: Optional[np.ndarray] = None,
    degraded: Sequence[Sequence[str]] = (),
    stages: Optional[Mapping[str, float]] = None,
) -> bytes:
    w = _Writer()
    w.raw(_header(KIND_SCORE_RESP, req_id, flags))
    w.pack("<B", status)
    w.str16(error[:2000])
    w.pack("<fI", retry_after_s, model_version)
    sc = (np.asarray(scores, np.float32)
          if scores is not None else np.zeros(0, np.float32))
    w.pack("<H", len(sc))
    w.raw(sc.tobytes())
    # Degraded coordinates as a per-row bitmask over a shared name table:
    # 16 bits bounds the RE coordinate count per model, which the serving
    # config bounds far lower in practice.
    names = sorted({c for row in degraded for c in row})
    if len(names) > 16:
        raise WireError(f"too many degraded coordinates: {len(names)}")
    w.pack("<B", len(names))
    for n in names:
        w.str8(n)
    if names:
        at = {n: i for i, n in enumerate(names)}
        for i in range(len(sc)):
            row = degraded[i] if i < len(degraded) else ()
            mask = 0
            for c in row:
                mask |= 1 << at[c]
            w.pack("<H", mask)
    st = stages or {}
    if len(st) > 0xFF:
        raise WireError("too many stages")
    w.pack("<B", len(st))
    for name, sec in st.items():
        w.str8(name)
        w.pack("<d", float(sec))
    return bytes(w.buf)


def decode_score_response(buf: bytes) -> ScoreResponse:
    kind, req_id = frame_kind(buf)
    if kind != KIND_SCORE_RESP:
        raise WireError(f"expected score response, got frame kind {kind}")
    flags = _HEADER.unpack_from(buf, 0)[3]
    r = _Reader(buf, HEADER_SIZE)
    status = r.unpack("<B")
    error = r.str16()
    retry_after_s, model_version = r.unpack("<fI")
    n = r.unpack("<H")
    scores = r.array(np.float32, n)
    n_names = r.unpack("<B")
    names = [r.str8() for _ in range(n_names)]
    degraded: list[tuple] = []
    if names:
        for _ in range(n):
            mask = r.unpack("<H")
            degraded.append(tuple(
                nm for b, nm in enumerate(names) if mask & (1 << b)))
    else:
        degraded = [()] * n
    n_stages = r.unpack("<B")
    stages = {}
    for _ in range(n_stages):
        name = r.str8()
        stages[name] = r.unpack("<d")
    return ScoreResponse(
        req_id=req_id,
        status=status,
        error=error,
        retry_after_s=float(retry_after_s),
        model_version=int(model_version),
        flags=flags,
        scores=scores,
        degraded=degraded,
        stages=stages,
    )


# ----------------------------------------------------------------- control


def encode_control(kind: int, req_id: int, payload: dict) -> bytes:
    """Control frame (tune / healthz / drain / hello / heartbeat): JSON
    body behind the binary header — schemaless on purpose, see module
    docstring."""
    if kind not in (KIND_CTL_REQ, KIND_CTL_RESP, KIND_HEARTBEAT):
        raise WireError(f"not a control frame kind: {kind}")
    body = json.dumps(payload).encode("utf-8")
    w = _Writer()
    w.raw(_header(kind, req_id))
    w.pack("<I", len(body))
    w.raw(body)
    return bytes(w.buf)


def decode_control(buf: bytes) -> tuple[int, int, dict]:
    """``(kind, req_id, payload)`` for any control-family frame."""
    kind, req_id = frame_kind(buf)
    if kind not in (KIND_CTL_REQ, KIND_CTL_RESP, KIND_HEARTBEAT):
        raise WireError(f"not a control frame kind: {kind}")
    r = _Reader(buf, HEADER_SIZE)
    n = r.unpack("<I")
    try:
        payload = json.loads(r.take(n).decode("utf-8"))
    except ValueError as e:
        raise WireError(f"bad control payload: {e}") from None
    if not isinstance(payload, dict):
        raise WireError("control payload must be a JSON object")
    return kind, req_id, payload
