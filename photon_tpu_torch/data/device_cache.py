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

Residency is reported as in the JAX module: the registry's
``sweep_cache_bytes``, ``sweep_cache_entries``, ``sweep_cache_spilled_bytes``
gauges and ``sweep_cache_hits_total`` / ``sweep_cache_misses_total``
counters (summed over every live cache; descent's ``cache.sweep_residency``
instant reads them), and every upload on a miss is an
``ingest.device_put`` span. Each cache also counts its own ``hits``,
``misses``, ``uploaded_bytes``, ``resident_bytes`` and ``spilled_bytes``.

Under a mesh (``DeviceSweepCache(mesh=...)``) the budget is per device and
the cache's total is that times the entity axis's shards (shrunk by the
run's sticky shard loss: ``effective_devices``). A mirror's buckets are
padded to the mesh multiple with the solve's inert lanes and pinned
entity-sharded: each shard's contiguous block of lanes on its device
(``RandomEffectDataset.shard_pins``), the padded host buckets kept for the
structure; ``bucket(b)`` puts a bucket's pieces together, device to device.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import weakref
from typing import Callable, Optional

from photon_tpu_torch.obs import trace_span
from photon_tpu_torch.obs.metrics import REGISTRY

__all__ = ["DeviceSweepCache", "default_budget_bytes", "release_all_caches",
           "shed_pins"]

_LIVE_CACHES: "weakref.WeakSet" = weakref.WeakSet()

_CACHE_BYTES = REGISTRY.gauge(
    "sweep_cache_bytes",
    "Device bytes currently pinned by DeviceSweepCache instances",
)
_CACHE_ENTRIES = REGISTRY.gauge(
    "sweep_cache_entries",
    "Entries currently resident across DeviceSweepCache instances",
)
_CACHE_HITS = REGISTRY.counter(
    "sweep_cache_hits_total",
    "Sweep-cache lookups served from device-resident arrays",
)
_CACHE_MISSES = REGISTRY.counter(
    "sweep_cache_misses_total",
    "Sweep-cache lookups that had to upload (first touch)",
)
_CACHE_SPILLED = REGISTRY.gauge(
    "sweep_cache_spilled_bytes",
    "Bytes that did NOT fit the sweep-cache budget and re-stream per sweep",
)


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
    """``PHOTON_SWEEP_CACHE_MB`` (default 2048 MB; 0 disables caching):
    per device, multiplied by a mesh's entity shards."""
    try:
        mb = float(os.environ.get("PHOTON_SWEEP_CACHE_MB", "2048"))
    except ValueError:
        mb = 2048.0
    return max(0, int(mb * 1e6))


class DeviceSweepCache:
    """Budgeted pin of host training data on the device across sweeps."""

    def __init__(self, budget_bytes: Optional[int] = None, mesh=None,
                 entity_axis="data"):
        requested = (default_budget_bytes() if budget_bytes is None
                     else max(0, int(budget_bytes)))
        if requested:
            from photon_tpu_torch.runtime.memory_guard import (
                effective_sweep_budget,
            )

            requested = effective_sweep_budget(requested)
        # Per device; ``budget_bytes`` (the cache's total) is a property so
        # that a sticky shard loss shrinks it.
        self._per_device_budget = requested
        self.mesh = mesh
        self.entity_axis = entity_axis
        self.n_devices = 1
        if mesh is not None:
            from photon_tpu_torch.parallel.mesh import shard_devices

            self.n_devices = len(shard_devices(mesh, entity_axis))
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

    def effective_devices(self) -> int:
        """The shards the pins spread over now: the mesh's entity axis,
        shrunk by the run's sticky shard loss (``re.shard``)."""
        if self.n_devices <= 1:
            return self.n_devices
        from photon_tpu_torch.runtime import memory_guard as _mg

        m = int((_mg.sticky_plan("re.shard") or {}).get("shards") or 0)
        return m if 0 < m < self.n_devices else self.n_devices

    @property
    def budget_bytes(self) -> int:
        """The cache's total: the per-device budget times the shards the
        pins spread over."""
        return self._per_device_budget * max(1, self.effective_devices())

    @property
    def enabled(self) -> bool:
        return self.budget_bytes > 0

    # The registry mirrors of the attributes (held under ``_lock``).
    def _hit(self) -> None:
        self.hits += 1
        _CACHE_HITS.inc()

    def _miss(self) -> None:
        self.misses += 1
        _CACHE_MISSES.inc()

    def _resident(self, nbytes: int, entries: int) -> None:
        self.resident_bytes += nbytes
        _CACHE_BYTES.inc(nbytes)
        _CACHE_ENTRIES.inc(entries)

    def _spilled(self, nbytes: int) -> None:
        self.spilled_bytes += nbytes
        _CACHE_SPILLED.inc(nbytes)

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
                self._hit()
                return hit[0]
            self._miss()
        fits = (self.enabled and not spilled
                and self.resident_bytes + nbytes <= self.budget_bytes)
        with trace_span("ingest.device_put", cat="ingest",
                        bytes=int(nbytes), cached=bool(fits)):
            built = build()
        with self._lock:
            self.uploaded_bytes += int(nbytes)
            if not fits:
                if key not in self._spilled_keys:
                    self._spilled_keys[key] = (retain, int(nbytes))
                    self._spilled(int(nbytes))
                return built
            if key not in self._entries:
                self._entries[key] = (built, int(nbytes), retain)
                self._resident(int(nbytes), 1)
        return built

    def discard(self, key) -> None:
        """Forget one key (its host object was replaced) and roll its byte
        accounting back; unknown keys are a no-op."""
        with self._lock:
            entry = self._entries.pop(key, None)
            spilled = self._spilled_keys.pop(key, None)
            self._mirrors.pop(key, None)
            if entry is not None:
                self._resident(-entry[1], -1)
            if spilled is not None:
                self._spilled(-spilled[1])

    def release(self) -> None:
        """Drop every pin (device memory frees once consumers drop their
        own references)."""
        with self._lock:
            self._resident(-self.resident_bytes, -len(self._entries))
            self._spilled(-self.spilled_bytes)
            self._entries.clear()
            self._mirrors.clear()
            self._spilled_keys.clear()

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
                self._resident(-nbytes, -1)
                freed += nbytes
                if key not in self._spilled_keys:
                    self._spilled_keys[key] = (retain, nbytes)
                    self._spilled(nbytes)
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
                    self._miss()
                else:
                    self._hit()
                return hit
        nbytes = sum(b.nbytes for b in dataset.buckets)
        if self.resident_bytes + nbytes > self.budget_bytes:
            with self._lock:
                self._miss()
                if key not in self._mirrors:
                    self._mirrors[key] = dataset
                    self._spilled_keys[key] = (dataset, int(nbytes))
                    self._spilled(int(nbytes))
                return self._mirrors[key]
        with self._lock:
            self._miss()
        with trace_span("ingest.device_put", cat="ingest",
                        bytes=int(nbytes), cached=True,
                        what=f"re_dataset:{dataset.re_type}"):
            if self.mesh is not None:
                mirror = self._mesh_mirror(dataset)
            else:
                mirror = dataclasses.replace(
                    dataset,
                    buckets=tuple(b.to(dataset.device) for b in dataset.buckets),
                    host_resident=False, lane_layouts={})
        with self._lock:
            if key not in self._mirrors:
                self._mirrors[key] = mirror
                self._entries[key] = (mirror, int(nbytes), dataset)
                self._resident(int(nbytes), 1)
                self.uploaded_bytes += int(nbytes)
            return self._mirrors[key]

    def _mesh_mirror(self, dataset):
        """``dataset`` with each bucket padded to the mesh multiple and
        pinned as its shards' pieces, one contiguous block of lanes on each
        shard's device. The mesh is the run's effective one (after a
        shard loss the rebuild lands on the survivors)."""
        from photon_tpu_torch.game.random_effect import (
            _effective_mesh,
            _entity_devices,
            _lanes,
            _pad_bucket,
        )

        mesh, axis = _effective_mesh(self.mesh, self.entity_axis)
        devices = _entity_devices(mesh, axis)
        n = len(devices)
        padded = tuple(_pad_bucket(b, n, dataset.n_rows, dataset.global_dim)
                       for b in dataset.buckets)
        pins = []
        for b in padded:
            per = b.n_entities // n
            pins.append(tuple(_lanes(b, i * per, (i + 1) * per, d)
                              for i, d in enumerate(devices)))
        return dataclasses.replace(dataset, buckets=padded, host_resident=True,
                                   shard_pins=tuple(pins), lane_layouts={})
