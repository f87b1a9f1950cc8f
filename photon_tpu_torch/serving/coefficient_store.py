"""Per-entity random-effect coefficients for serving: host table + device LRU.

Port of ``photon_tpu/serving/coefficient_store.py``. Any single request needs
one coefficient vector per random-effect coordinate, out of millions, so an
online server does point lookups:

* ``CoefficientStore`` — the full per-entity table on the host in a flat
  CSR layout (``offsets/cols/vals`` arrays + key index), the JAX package's
  code: a store saved by either package loads in the other, and a saved
  store reopens as ``np.load(mmap_mode="r")`` views shared by every process
  of a box (the front line's workers resolve entity keys against it).
* ``DeviceCoefficientCache`` — an LRU hot-set of entities on an explicit
  torch device as fixed-shape ``[capacity+1, P]`` projection/coefficient
  tables that the scoring program gathers from. Row ``capacity`` is a
  permanent all-ghost zero row: unseen entities (and rows with no entity)
  map there and score fixed-effect-only, the batch scorer's zero-model
  fallback. A batch's misses reach the device in one host-to-device copy
  and one ``index_copy_`` per table; the table shapes never change.

Importing this module loads no ``torch`` (only ``DeviceCoefficientCache``
does, when it is built): the accelerator-free front-line workers import it.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np

from photon_tpu_torch.faults import fault_point
from photon_tpu_torch.serving.circuit import CircuitBreaker

_META = "store-meta.json"


class CoefficientStore:
    """Host-resident sparse per-entity coefficient table for ONE random-effect
    coordinate. ``cols`` are global feature columns, ascending per entity
    (the layout ``additive_score_rows``'s binary search requires)."""

    def __init__(
        self,
        keys,
        offsets: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        global_dim: int,
    ):
        self.keys = list(keys)
        self._key_to_row = {k: i for i, k in enumerate(self.keys)}
        self.offsets = offsets
        self.cols = cols
        self.vals = vals
        self.global_dim = int(global_dim)
        # Online-delta overlay (docs/online.md): patched entities resolve
        # here BEFORE the base CSR arrays (which may be read-only mmaps).
        # ``apply_patches`` swaps the whole dict reference in one
        # assignment, so a concurrent ``lookup`` sees the entire delta or
        # none of it — never a torn mix.
        self._patches: dict = {}

    @property
    def n_entities(self) -> int:
        """Distinct resolvable entities: base table + patched-in NEW keys."""
        extra = sum(1 for k in self._patches if k not in self._key_to_row)
        return len(self.keys) + extra

    @property
    def n_patched(self) -> int:
        return len(self._patches)

    def validate_patches(self, patches) -> dict:
        """Validate (and normalize) a patch batch WITHOUT applying it:
        ``{key: (cols, vals)}`` → staged dict of int32/float32 arrays.
        Raises on mismatched shapes, non-ascending columns (the kernel's
        binary-search layout), or out-of-range columns. Callers that need
        cross-store atomicity (``ModelRegistry.apply_delta``) validate
        EVERY store first, then apply."""
        staged = {}
        for key, (cols, vals) in patches.items():
            cols = np.asarray(cols, np.int32)
            vals = np.asarray(vals, np.float32)
            if cols.shape != vals.shape or cols.ndim != 1:
                raise ValueError(
                    f"patch for {key!r}: cols/vals must be matching 1-D "
                    f"arrays, got {cols.shape} vs {vals.shape}"
                )
            if len(cols) > 1 and np.any(np.diff(cols) < 0):
                raise ValueError(
                    f"patch for {key!r}: cols must be ascending "
                    "(additive_score_rows binary-searches them)"
                )
            if len(cols) and (cols[0] < 0 or cols[-1] >= self.global_dim):
                raise ValueError(
                    f"patch for {key!r}: cols out of range "
                    f"[0, {self.global_dim})"
                )
            staged[key] = (cols, vals)
        return staged

    def apply_patches(self, patches) -> int:
        """Atomically overlay full replacement coefficient vectors.

        ``patches`` maps entity key → ``(cols, vals)`` (global columns,
        ascending — validated via :meth:`validate_patches` so a bad
        producer can never corrupt scoring). Entities absent from the
        base table are ADDED (cold-start entities streaming in). The base
        arrays are never touched: they may be ``mmap_mode="r"`` views
        shared across processes. Returns the number of entities patched.

        The overlay is PROCESS state — the durable record of published
        deltas is the trainer's patch journal (docs/online.md); ``save``
        persists the base table only.
        """
        staged = self.validate_patches(patches)
        # Build-then-swap: one reference assignment publishes everything.
        merged = dict(self._patches)
        merged.update(staged)
        self._patches = merged
        return len(staged)

    @property
    def max_width(self) -> int:
        if len(self.offsets) <= 1:
            return 1
        return max(1, int(np.max(np.diff(self.offsets))))

    @classmethod
    def from_model(cls, model) -> "CoefficientStore":
        """Build from a trained or loaded ``RandomEffectModel`` (the sparse
        view of ``coefficients_for``), each bucket's stacks brought to the
        host ONCE: one device-to-host copy per entity would cost minutes of
        swap latency at millions of entities."""
        keys = list(model.entity_keys)
        proj_np = [_host(p) for p in model.bucket_proj]
        coef_np = [_host(c) for c in model.bucket_coefs]
        offsets = np.zeros(len(keys) + 1, np.int64)
        cols_parts, vals_parts = [], []
        for i in range(len(keys)):
            b, lane = model.entity_to_slot[i]
            pv = proj_np[b][lane]
            valid = pv < model.global_dim
            gi = pv[valid].astype(np.int64)
            gv = coef_np[b][lane][valid]
            if len(gi) > 1 and np.any(np.diff(gi) < 0):
                order = np.argsort(gi)  # defensive: kernel needs sorted cols
                gi, gv = gi[order], gv[order]
            cols_parts.append(gi.astype(np.int32))
            vals_parts.append(np.asarray(gv, np.float32))
            offsets[i + 1] = offsets[i] + len(gi)
        cols = (
            np.concatenate(cols_parts) if cols_parts else np.zeros(0, np.int32)
        )
        vals = (
            np.concatenate(vals_parts)
            if vals_parts
            else np.zeros(0, np.float32)
        )
        return cls(keys, offsets, cols, vals, model.global_dim)

    def lookup(self, key) -> Optional[tuple[np.ndarray, np.ndarray]]:
        """(global_cols, values) views for one entity, or None if unseen."""
        # Chaos hook: latency spikes (delay_s) and IO errors on the store
        # path — what an mmap'd table on a sick filesystem really does.
        fault_point("serving.store_lookup", key=key)
        patched = self._patches.get(key)  # one dict read; ref-swap atomic
        if patched is not None:
            return patched
        row = self._key_to_row.get(key)
        if row is None:
            return None
        s, e = int(self.offsets[row]), int(self.offsets[row + 1])
        return self.cols[s:e], self.vals[s:e]

    # ------------------------------------------------------------- on disk

    def save(self, out_dir: str) -> None:
        """Persist as npy arrays + key list; ``load`` reopens them memory-
        mapped so a 10M-entity table costs ~zero resident RAM per process."""
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, "offsets.npy"), self.offsets)
        np.save(os.path.join(out_dir, "cols.npy"), self.cols)
        np.save(os.path.join(out_dir, "vals.npy"), self.vals)
        with open(os.path.join(out_dir, "keys.json"), "w") as f:
            json.dump([str(k) for k in self.keys], f)
        with open(os.path.join(out_dir, _META), "w") as f:
            json.dump(
                {"global_dim": self.global_dim, "n_entities": len(self.keys)},
                f,
            )

    @classmethod
    def load(cls, store_dir: str, mmap: bool = True) -> "CoefficientStore":
        with open(os.path.join(store_dir, _META)) as f:
            meta = json.load(f)
        with open(os.path.join(store_dir, "keys.json")) as f:
            keys = json.load(f)
        mode = "r" if mmap else None
        return cls(
            keys,
            np.load(os.path.join(store_dir, "offsets.npy"), mmap_mode=mode),
            np.load(os.path.join(store_dir, "cols.npy"), mmap_mode=mode),
            np.load(os.path.join(store_dir, "vals.npy"), mmap_mode=mode),
            meta["global_dim"],
        )


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array as a host ndarray."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


class DeviceCoefficientCache:
    """LRU hot-set of ``CoefficientStore`` rows on ``device`` (module doc).

    The same bookkeeping as the JAX package's cache: LRU order, slots pinned
    for one batch, the fallback slot, breaker-guarded lookups, ``stats`` and
    ``snapshot()``. Internal state is lock-protected, but a resolve-then-
    ``gather`` sequence is not atomic against other threads resolving in
    between: the server funnels every resolve and gather through the
    micro-batcher's one worker thread, and direct users of
    ``RowScorer.score_rows`` must serialize scoring calls per cache.
    """

    def __init__(
        self, store: CoefficientStore, capacity: int = 4096,
        width: Optional[int] = None,
        breaker: Optional[CircuitBreaker] = None,
        device=None,
    ):
        import torch

        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if device is None:
            raise ValueError("DeviceCoefficientCache needs an explicit device")
        self.store = store
        self.capacity = int(capacity)
        self.width = _next_pow2(width or store.max_width)
        self.device = torch.device(device)
        # Optional circuit breaker around store lookups: when open, misses
        # degrade to the fallback zero row (fixed-effect-only) instead of
        # touching — or failing on — a sick store. Cache hits still serve
        # full random-effect scores.
        self.breaker = breaker
        # +1 row: the permanent fallback zero row (all-ghost projection).
        self.proj = torch.full((self.capacity + 1, self.width),
                               store.global_dim, dtype=torch.int32,
                               device=self.device)
        self.coef = torch.zeros((self.capacity + 1, self.width),
                                dtype=torch.float32, device=self.device)
        self._slots: OrderedDict = OrderedDict()   # key -> slot, LRU order
        self._free = list(range(self.capacity))
        self._lock = threading.Lock()
        self.stats = {
            "hits": 0, "misses": 0, "evictions": 0, "fallbacks": 0,
            "degraded": 0, "invalidations": 0,
        }
        # Host-to-device copies: resolve's (one per batch with misses) and
        # those of a gather handed host slots.
        self.h2d_copies = 0

    def invalidate(self, keys) -> int:
        """Drop patched entities from the hot-set so their next resolve
        restages fresh coefficients from the (just-patched) store.

        Bookkeeping only: a freed slot's stale row is overwritten by the
        next ``resolve`` that reuses it, and every resolve + gather runs on
        the micro-batcher's one worker thread, so a batch that already
        resolved the old slot gathers consistent pre-delta rows. Returns
        the number of entities dropped.
        """
        n = 0
        with self._lock:
            for key in keys:
                slot = self._slots.pop(key, None)
                if slot is not None:
                    self._free.append(slot)
                    n += 1
            self.stats["invalidations"] += n
        return n

    @property
    def fallback_slot(self) -> int:
        return self.capacity

    def slot_for(self, key) -> int:
        """Cache slot for ONE entity, staging its coefficients on a miss.
        ``None`` keys and unseen entities get the fallback zero row."""
        return int(self.slots_for([key])[0])

    def slots_for(self, keys) -> np.ndarray:
        """Cache slots for a batch of entity keys (see :meth:`resolve`)."""
        return self.resolve(keys)[0]

    def resolve(self, keys) -> tuple[np.ndarray, np.ndarray]:
        """``(slots, degraded)`` for a batch of entity keys, staging misses.
        ``degraded[i]`` marks rows sent to the fallback zero row because the
        store breaker was open or the store call failed — not rows whose
        entity is simply unseen (those are correct fallbacks).

        Slots handed out within this batch are pinned against eviction
        until the batch resolves: a batch touching more distinct entities
        than fit would otherwise evict a slot it already assigned. Requires
        ``capacity >= distinct keys per batch`` (the scorer floors capacity
        at ``max_batch``).

        The batch's missed rows go to the device as ONE packed int32 buffer
        (slots, then the columns, then the values' bits) and land by one
        ``index_copy_`` per table.
        """
        import torch

        out = np.empty(len(keys), np.int32)
        degraded = np.zeros(len(keys), bool)
        with self._lock:
            pinned: set = set()
            staged: list = []  # (slot, padded cols row, padded vals row)
            for i, key in enumerate(keys):
                out[i], degraded[i] = self._slot_locked(key, pinned, staged)
                if out[i] != self.capacity:
                    pinned.add(int(out[i]))
            if staged:
                n, w = len(staged), self.width
                buf = np.empty(n * (1 + 2 * w), np.int32)
                buf[:n] = [s for s, _, _ in staged]
                buf[n: n + n * w] = np.concatenate([p for _, p, _ in staged])
                buf[n + n * w:] = np.concatenate(
                    [c for _, _, c in staged]).view(np.int32)
                dev = torch.from_numpy(buf).to(self.device)
                self.h2d_copies += 1
                rows = dev[:n].long()
                self.proj.index_copy_(0, rows, dev[n: n + n * w].view(n, w))
                self.coef.index_copy_(
                    0, rows, dev[n + n * w:].view(torch.float32).view(n, w))
        return out, degraded

    def _guarded_lookup(self, key) -> tuple[Optional[tuple], bool]:
        """``store.lookup`` behind the breaker: ``(hit, degraded)``.
        Degraded = the store was not consulted (breaker open) or its call
        failed / ran slow — the row scores fixed-effect-only but the
        request survives."""
        br = self.breaker
        if br is None:
            return self.store.lookup(key), False
        if not br.allow():
            self.stats["degraded"] += 1
            return None, True
        t0 = time.monotonic()
        try:
            hit = self.store.lookup(key)
        except Exception:  # noqa: BLE001 - degrade, never fail the request
            br.record_failure()
            self.stats["degraded"] += 1
            return None, True
        br.record_success(time.monotonic() - t0)
        return hit, False

    def _slot_locked(self, key, pinned: set, staged: list) -> tuple[int, bool]:
        slot = self._slots.get(key) if key is not None else None
        if slot is not None:
            self._slots.move_to_end(key)
            self.stats["hits"] += 1
            return slot, False
        hit, degraded = (
            self._guarded_lookup(key) if key is not None else (None, False)
        )
        if hit is None:
            if not degraded:
                self.stats["fallbacks"] += 1
            return self.capacity, degraded
        cols, vals = hit
        if len(cols) > self.width:
            raise ValueError(
                f"entity {key!r} has {len(cols)} coefficients but the "
                f"device cache width is {self.width}"
            )
        if self._free:
            slot = self._free.pop()
        else:
            victim = next(
                (k for k, s in self._slots.items() if s not in pinned), None
            )
            if victim is None:
                raise RuntimeError(
                    f"batch needs more than {self.capacity} distinct "
                    "entities; raise cache capacity above max_batch"
                )
            slot = self._slots.pop(victim)
            self.stats["evictions"] += 1
        row_p = np.full(self.width, self.store.global_dim, np.int32)
        row_c = np.zeros(self.width, np.float32)
        row_p[: len(cols)] = cols
        row_c[: len(vals)] = vals
        staged.append((slot, row_p, row_c))
        self._slots[key] = slot
        self.stats["misses"] += 1
        return slot, False

    def gather(self, slots) -> tuple:
        """Per-row (proj, coef) ``[B, P]`` tensors on the device for a slot
        vector: one ``index_select`` a table. A slot tensor already on the
        device (the scorer's, which rides in its batch copy) costs no copy;
        a host array costs one, counted in ``h2d_copies``."""
        import torch

        s = (slots if isinstance(slots, torch.Tensor)
             else torch.from_numpy(np.asarray(slots, np.int32)))
        if s.device.type != self.device.type:
            s = s.to(self.device)
            self.h2d_copies += 1
        return self.proj.index_select(0, s), self.coef.index_select(0, s)

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "capacity": self.capacity,
                "width": self.width,
                "resident": len(self._slots),
                "store_patched": self.store.n_patched,
                **self.stats,
            }
        if self.breaker is not None:
            out["breaker"] = self.breaker.snapshot()
        return out
