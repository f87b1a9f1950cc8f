"""Device-resident sweep cache: stop re-uploading the dataset every sweep.

Port of ``photon_tpu/data/device_cache.py`` on one device. Multi-sweep GAME
training re-enters every coordinate once per sweep; a host-resident
random-effect dataset (``host_resident=True``) would upload every bucket on
every train and every score. :class:`DeviceSweepCache` pins such a dataset
on the device at its first use, within a memory budget
(``PHOTON_SWEEP_CACHE_MB``, default 2048; the drivers' ``--sweep-cache-mb``;
0 disables). A dataset that does not fit the budget spills: it keeps
streaming, bucket by bucket, as without the cache. Budget pressure costs
throughput, never memory.

Identity matters: ``RandomEffectCoordinate`` tells a model trained on its
dataset by the identity of the buckets' ``proj`` tensors, so the mirror of a
dataset is the same object for the cache's lifetime (a spilled dataset's
"mirror" is the dataset itself, equally stable).

The budget is clamped by ``runtime/memory_guard.effective_sweep_budget``
(half the card's live limit at most, halved again after an OOM restart).
Every live cache is registered (weakly): a device-loss recovery drops every
pin at once (:func:`release_all_caches`), and the memory watchdog's
pressure valve sheds the oldest chunk pins (:func:`shed_pins`,
:meth:`DeviceSweepCache.shed`).

The JAX module reports residency through metrics gauges, which wait for the
observability slice; here the cache counts ``hits``, ``misses``,
``uploaded_bytes``, ``resident_bytes`` and ``spilled_bytes`` as attributes.
Its mesh placement (M14) is not ported.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import weakref
from typing import Callable, Optional

__all__ = ["DeviceSweepCache", "default_budget_bytes", "release_all_caches",
           "shed_pins"]

_LIVE_CACHES: "weakref.WeakSet" = weakref.WeakSet()


def release_all_caches() -> int:
    """Release every live :class:`DeviceSweepCache`; returns how many."""
    caches = list(_LIVE_CACHES)
    for c in caches:
        c.release()
    return len(caches)


def shed_pins(max_bytes: int) -> int:
    """Spill up to ``max_bytes`` of pinned chunk entries across every live
    cache, oldest pins first: the memory watchdog's pressure valve. Shed
    entries are copied again on their next use, as over-budget ones are.
    Returns the bytes freed."""
    freed = 0
    for c in list(_LIVE_CACHES):
        if freed >= max_bytes:
            break
        freed += c.shed(max_bytes - freed)
    return freed


def default_budget_bytes() -> int:
    """``PHOTON_SWEEP_CACHE_MB`` (default 2048 MB; 0 disables caching)."""
    try:
        mb = float(os.environ.get("PHOTON_SWEEP_CACHE_MB", "2048"))
    except ValueError:
        mb = 2048.0
    return max(0, int(mb * 1e6))


class DeviceSweepCache:
    """Budgeted pin of host training data on the device across sweeps."""

    def __init__(self, budget_bytes: Optional[int] = None):
        requested = (default_budget_bytes() if budget_bytes is None
                     else max(0, int(budget_bytes)))
        if requested:
            from photon_tpu_torch.runtime.memory_guard import (
                effective_sweep_budget,
            )

            requested = effective_sweep_budget(requested)
        self.budget_bytes = requested
        # key -> (device value, nbytes, the host object the key's id names:
        # held so that a freed and reused id never aliases a stale entry)
        self._entries: dict = {}
        self._mirrors: dict = {}
        self._spilled_keys: dict = {}       # key -> (host object, nbytes)
        self.resident_bytes = 0
        self.spilled_bytes = 0
        self.hits = 0
        self.misses = 0
        self.uploaded_bytes = 0
        self._lock = threading.Lock()
        _LIVE_CACHES.add(self)

    @property
    def enabled(self) -> bool:
        return self.budget_bytes > 0

    def stats(self) -> dict:
        return {"budget_bytes": self.budget_bytes,
                "resident_bytes": self.resident_bytes,
                "spilled_bytes": self.spilled_bytes,
                "entries": len(self._entries)}

    def get_or_put(self, key, nbytes: int, build: Callable, retain=None):
        """The device value for ``key``: the pinned one on a hit; on a miss
        ``build()`` runs (the upload) and its result is kept only when
        ``nbytes`` fits what is left of the budget. Otherwise it is returned
        unpinned (a spill: the next use uploads again; its bytes count once
        per key). ``retain`` is the host object the key was made from."""
        with self._lock:
            hit = self._entries.get(key)
            spilled = key in self._spilled_keys
            if hit is not None:
                self.hits += 1
                return hit[0]
            self.misses += 1
        fits = (self.enabled and not spilled
                and self.resident_bytes + nbytes <= self.budget_bytes)
        built = build()
        with self._lock:
            self.uploaded_bytes += int(nbytes)
            if not fits:
                if key not in self._spilled_keys:
                    self._spilled_keys[key] = (retain, int(nbytes))
                    self.spilled_bytes += int(nbytes)
                return built
            if key not in self._entries:
                self._entries[key] = (built, int(nbytes), retain)
                self.resident_bytes += int(nbytes)
        return built

    def discard(self, key) -> None:
        """Forget one key (its host object was replaced) and roll its byte
        accounting back; unknown keys are a no-op."""
        with self._lock:
            entry = self._entries.pop(key, None)
            spilled = self._spilled_keys.pop(key, None)
            self._mirrors.pop(key, None)
            if entry is not None:
                self.resident_bytes -= entry[1]
            if spilled is not None:
                self.spilled_bytes -= spilled[1]

    def release(self) -> None:
        """Drop every pin (device memory frees once consumers drop their
        own references)."""
        with self._lock:
            self._entries.clear()
            self._mirrors.clear()
            self._spilled_keys.clear()
            self.resident_bytes = 0
            self.spilled_bytes = 0

    def shed(self, max_bytes: int) -> int:
        """Spill up to ``max_bytes`` of pinned chunk entries, oldest first,
        marking them spilled (they are copied on every later use instead of
        pinned again: memory pressure proved they do not fit). Dataset
        mirrors are exempt: a mirror must stay the same object for the
        cache's lifetime. Returns the bytes freed."""
        if max_bytes <= 0:
            return 0
        freed = 0
        with self._lock:
            for key in list(self._entries):
                if freed >= max_bytes:
                    break
                if key in self._mirrors:
                    continue
                _built, nbytes, retain = self._entries.pop(key)
                self.resident_bytes -= nbytes
                freed += nbytes
                if key not in self._spilled_keys:
                    self._spilled_keys[key] = (retain, nbytes)
                    self.spilled_bytes += nbytes
        return freed

    def dataset_mirror(self, dataset):
        """The device-resident mirror of a host-resident
        ``RandomEffectDataset``: the same object for the cache's lifetime.
        A dataset already on the device, a disabled cache, or a dataset
        over the budget give the dataset itself (which then uploads per
        bucket, as without the cache)."""
        if not self.enabled or not getattr(dataset, "host_resident", False):
            return dataset
        key = ("re_dataset", id(dataset))
        with self._lock:
            hit = self._mirrors.get(key)
            if hit is not None:
                # A spilled dataset's mirror is the host original: each use
                # still uploads, so it counts as a miss.
                if key in self._spilled_keys:
                    self.misses += 1
                else:
                    self.hits += 1
                return hit
            self.misses += 1
        nbytes = sum(b.nbytes for b in dataset.buckets)
        if self.resident_bytes + nbytes > self.budget_bytes:
            with self._lock:
                if key not in self._mirrors:
                    self._mirrors[key] = dataset
                    self._spilled_keys[key] = (dataset, int(nbytes))
                    self.spilled_bytes += int(nbytes)
                return self._mirrors[key]
        mirror = dataclasses.replace(
            dataset, buckets=tuple(b.to(dataset.device) for b in dataset.buckets),
            host_resident=False, lane_layouts={})
        with self._lock:
            if key not in self._mirrors:
                self._mirrors[key] = mirror
                self._entries[key] = (mirror, int(nbytes), dataset)
                self.resident_bytes += int(nbytes)
                self.uploaded_bytes += int(nbytes)
            return self._mirrors[key]
