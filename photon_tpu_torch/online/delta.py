"""Model deltas: changed-entity coefficient patches + the patch journal.

A copy of the JAX package's ``online/delta.py``: it imports neither JAX nor
torch, and ``tests/test_torch_frontline.py`` compares the code, so edit
both or neither.

Publication is by DELTA, never snapshot: a refresh of 500 entities out of
10M ships 500 sparse coefficient vectors, applied atomically to the
serving ``CoefficientStore`` overlay (``apply_patches`` swaps one dict
reference — a scoring thread sees the whole delta or none of it) with the
device LRU hot-set invalidated only for the patched keys.

The wire format (``POST /admin/patch``, docs/online.md §"Delta protocol"):

    {"seq": 12, "event_horizon": 4096,
     "patches": {"perUser": {"u3": {"cols": [0, 7], "vals": [0.2, -1.1]}}}}

``cols`` are GLOBAL feature columns, ascending (the layout the scoring
kernel's binary search requires — validated at apply). ``seq`` is the
trainer's delta sequence; ``event_horizon`` the highest event seq the delta
covers, so the journal is a replayable record of WHICH data produced WHICH
published coefficients.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Mapping, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class EntityPatch:
    """One entity's full replacement coefficient vector (sparse, global
    columns ascending)."""

    key: str
    cols: np.ndarray    # int32, ascending
    vals: np.ndarray    # float32

    def __post_init__(self):
        cols = np.asarray(self.cols, np.int32)
        vals = np.asarray(self.vals, np.float32)
        if cols.shape != vals.shape or cols.ndim != 1:
            raise ValueError(
                f"patch for {self.key!r}: cols/vals must be matching 1-D "
                f"arrays, got {cols.shape} vs {vals.shape}"
            )
        if len(cols) > 1 and np.any(np.diff(cols) < 0):
            order = np.argsort(cols)   # defensive: kernel needs sorted cols
            cols, vals = cols[order], vals[order]
        object.__setattr__(self, "cols", cols)
        object.__setattr__(self, "vals", vals)

    @property
    def nnz(self) -> int:
        return int(len(self.cols))


@dataclasses.dataclass(frozen=True)
class ModelDelta:
    """One published refresh: per-coordinate entity patches + provenance."""

    seq: int
    patches: Mapping[str, Mapping[str, EntityPatch]]  # cid -> key -> patch
    event_horizon: int = -1       # highest event seq covered
    created_ts: float = 0.0

    @property
    def n_entities(self) -> int:
        return sum(len(p) for p in self.patches.values())

    def coordinates(self) -> list:
        return sorted(self.patches)

    def to_wire(self) -> dict:
        """JSON wire form (``POST /admin/patch``)."""
        return {
            "seq": int(self.seq),
            "event_horizon": int(self.event_horizon),
            "patches": {
                cid: {
                    p.key: {
                        "cols": [int(c) for c in p.cols],
                        "vals": [float(v) for v in p.vals],
                    }
                    for p in by_key.values()
                }
                for cid, by_key in self.patches.items()
            },
        }

    def idempotency_key(self) -> str:
        """Identity for at-least-once publication dedupe
        (``X-Photon-Idempotency-Key`` on ``POST /admin/patch``).

        ``seq`` plus a digest of the canonical wire form — NOT the bare
        seq: a restarted trainer incarnation restarts ``_delta_seq`` at 0
        (in-memory by design), so two different incarnations reuse
        low seqs for genuinely different deltas, and those must both
        apply. Content-addressing makes the key collide exactly when the
        payload is byte-identical — i.e. exactly when a retry of the SAME
        publish is in flight."""
        import hashlib

        digest = hashlib.sha256(
            json.dumps(self.to_wire(), sort_keys=True).encode()
        ).hexdigest()[:16]
        return f"{int(self.seq)}:{digest}"

    @classmethod
    def from_wire(cls, d: dict) -> "ModelDelta":
        if not isinstance(d, dict) or not isinstance(d.get("patches"), dict):
            raise ValueError('delta must be {"patches": {cid: {key: ...}}}')
        patches: dict = {}
        for cid, by_key in d["patches"].items():
            if not isinstance(by_key, dict):
                raise ValueError(f"coordinate {cid!r}: patches must be a map")
            out = {}
            for key, p in by_key.items():
                try:
                    out[key] = EntityPatch(
                        key=str(key),
                        cols=np.asarray(p["cols"], np.int32),
                        vals=np.asarray(p["vals"], np.float32),
                    )
                except (TypeError, KeyError, ValueError) as e:
                    raise ValueError(
                        f"coordinate {cid!r} entity {key!r}: bad patch: {e}"
                    ) from None
            patches[cid] = out
        return cls(
            seq=int(d.get("seq", -1)),
            patches=patches,
            event_horizon=int(d.get("event_horizon", -1)),
            created_ts=float(d.get("created_ts") or 0.0),
        )

    def raw_patches(self) -> dict:
        """``{cid: {key: (cols, vals)}}`` — the shape the serving layer's
        ``ModelRegistry.apply_delta`` consumes (serving never imports the
        online package)."""
        return {
            cid: {p.key: (p.cols, p.vals) for p in by_key.values()}
            for cid, by_key in self.patches.items()
        }


class PatchJournal:
    """Append-only JSONL record of every published delta.

    Lives at ``<output-dir>/patch-journal.jsonl`` under the same
    whole-line O_APPEND contract as the recovery journal: one publish, one
    line, readable while being written. The journal is the durable side of
    the overlay (the serving store's patch overlay is process state): a
    replacement server can be caught up by replaying the journal tail, and
    a chaos drill asserts the journal never records a delta the store does
    not fully hold.
    """

    FILENAME = "patch-journal.jsonl"

    def __init__(self, out_dir: str):
        self.path = os.path.join(out_dir, self.FILENAME)
        os.makedirs(out_dir, exist_ok=True)
        self._fd = os.open(self.path,
                           os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)

    def record(self, delta: ModelDelta, published: dict,
               freshness_s: Optional[Sequence[float]] = None) -> dict:
        fresh = list(freshness_s or ())
        row = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "seq": int(delta.seq),
            "event_horizon": int(delta.event_horizon),
            "coordinates": delta.coordinates(),
            "entities": delta.n_entities,
            "published": published,
            "freshness_max_s": round(max(fresh), 4) if fresh else None,
        }
        os.write(self._fd, (json.dumps(row) + "\n").encode("utf-8"))
        return row

    def read_all(self) -> list:
        try:
            with open(self.path) as f:
                return [json.loads(x) for x in f if x.strip()]
        except OSError:
            return []

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self) -> "PatchJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
