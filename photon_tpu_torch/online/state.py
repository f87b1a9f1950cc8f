"""Trainer-side state: per-entity sliding windows, dirty set, posteriors.

A copy of the JAX package's ``online/state.py`` (it imports neither torch
nor JAX); ``tests/test_torch_online.py`` compares the code, so edit both
or neither.

Three host-side structures, all keyed by entity:

* :class:`EntityWindows` — the last ``window`` observation rows per entity
  (a bounded deque of fixed-width ELL rows). The window IS the refresh's
  training data: each refresh re-solves the entity's GLM on its window,
  anchored to the previous posterior, so the solve stays a bounded-size
  batched Newton problem no matter how long the stream runs.
* the **dirty set** (inside :class:`EntityWindows`) — entities with events
  since their last published refresh, ordered by the FIRST pending event's
  timestamp. Refresh cycles drain oldest-first, so the freshness histogram
  measures the true worst-wait, not a lucky recent arrival.
* :class:`OnlineModelState` — the trainer's per-entity posterior (sparse
  global cols → means + variances). Seeded from the base model's export;
  updated only AFTER a delta publish succeeds, so the prior each refresh
  anchors to is exactly what serving is scoring with.
"""
from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Optional, Sequence

import numpy as np


class EntityWindows:
    """Sliding windows + dirty-set bookkeeping for ONE random-effect
    coordinate. Thread-safe: the consume loop appends while a refresh
    drains (the trainer serializes refreshes, but ingest may be a
    different thread)."""

    def __init__(self, window: int):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        self._rows: dict = {}            # key -> deque of row tuples
        # key -> (first_pending_ts, first_pending_seq); insertion order is
        # NOT the refresh order — pop_dirty sorts by first pending ts.
        self._dirty: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.rows_total = 0

    def add_row(
        self, key: str, idx: np.ndarray, val: np.ndarray,
        label: float, weight: float, offset: float, ts: float, seq: int,
    ) -> None:
        """Append one observation row; marks the entity dirty."""
        with self._lock:
            dq = self._rows.get(key)
            if dq is None:
                dq = self._rows[key] = deque(maxlen=self.window)
            dq.append((idx, val, float(label), float(weight),
                       float(offset), float(ts), int(seq)))
            self.rows_total += 1
            if key not in self._dirty:
                self._dirty[key] = (float(ts), int(seq))

    @property
    def n_dirty(self) -> int:
        with self._lock:
            return len(self._dirty)

    @property
    def n_entities(self) -> int:
        with self._lock:
            return len(self._rows)

    def peek_dirty(self, max_n: int) -> list:
        """Up to ``max_n`` dirty keys, oldest first-pending-event first.
        Does NOT clear dirtiness — the trainer clears only after the
        refresh's delta publishes (``clear_dirty``), so a failed publish
        retries the same entities next cycle."""
        with self._lock:
            ordered = sorted(self._dirty.items(), key=lambda kv: kv[1])
            return [(k, ts, seq) for k, (ts, seq) in ordered[:max_n]]

    def clear_dirty(self, keys: Sequence[str],
                    horizon: Optional[int] = None) -> None:
        """Un-mark ``keys`` up to event seq ``horizon``: a key whose window
        holds an event NEWER than the just-published horizon stays dirty,
        re-stamped with that event's (ts, seq) — an ingest thread racing a
        refresh can never lose an event's refresh."""
        with self._lock:
            for k in keys:
                if horizon is not None:
                    dq = self._rows.get(k)
                    pending = next(
                        (r for r in (dq or ()) if r[6] > horizon), None)
                    if pending is not None:
                        self._dirty[k] = (pending[5], pending[6])
                        continue
                self._dirty.pop(k, None)

    def rows_for(self, key: str) -> list:
        """Current window rows for one entity (snapshot list)."""
        with self._lock:
            dq = self._rows.get(key)
            return list(dq) if dq else []

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "entities": len(self._rows),
                "dirty": len(self._dirty),
                "rows_total": self.rows_total,
                "window": self.window,
            }


class OnlineModelState:
    """Per-entity posterior (cols → means, variances) for one coordinate.

    This is the trainer's mirror of what serving holds after every
    published delta: means are the serving coefficients, variances the
    posterior widths the NEXT refresh's :class:`PriorDistribution` derives
    its precisions from (missing variances default to 1 — the same
    unit-variance default as ``PriorDistribution.from_model``).
    """

    def __init__(self):
        self._by_key: dict = {}   # key -> (cols i64, means f64, vars f64|None)

    @classmethod
    def from_random_effect_model(cls, model) -> "OnlineModelState":
        """Seed from a loaded/trained ``RandomEffectModel`` via its sparse
        per-entity export (one host pass, same gather as the coefficient
        store build)."""
        st = cls()
        for key in model.entity_keys:
            gi, gv, vv = model.export_for(key)
            st._by_key[str(key)] = (
                np.asarray(gi, np.int64),
                np.asarray(gv, np.float64),
                None if vv is None else np.asarray(vv, np.float64),
            )
        return st

    @property
    def n_entities(self) -> int:
        return len(self._by_key)

    def posterior_for(
        self, key: str
    ) -> Optional[tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]]:
        return self._by_key.get(key)

    def update(self, key: str, cols: np.ndarray, means: np.ndarray,
               variances: Optional[np.ndarray]) -> None:
        self._by_key[str(key)] = (
            np.asarray(cols, np.int64),
            np.asarray(means, np.float64),
            None if variances is None else np.asarray(variances, np.float64),
        )

    def score_contribution(self, key: str, idx: np.ndarray,
                           val: np.ndarray, dim: int) -> float:
        """This entity's additive score for one ELL row (host dot) — used
        when composing another coordinate's offsets. Unseen entities score
        0 (the zero-model fallback, as everywhere else)."""
        post = self._by_key.get(key)
        if post is None:
            return 0.0
        cols, means, _ = post
        valid = idx < dim
        if not valid.any():
            return 0.0
        pos = np.searchsorted(cols, idx[valid])
        pos = np.clip(pos, 0, max(len(cols) - 1, 0))
        hit = (len(cols) > 0) & (cols[pos] == idx[valid]) \
            if len(cols) else np.zeros(valid.sum(), bool)
        if not np.any(hit):
            return 0.0
        return float(np.sum(means[pos[hit]] * val[valid][hit]))
