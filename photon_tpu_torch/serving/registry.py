"""Versioned model registry with atomic hot-swap for online scoring.

Port of ``photon_tpu/serving/registry.py``, on one explicit device: every
version's model and scorer live there (``device=None`` is the card, through
``resolve_device``, which raises without a GPU; the CPU only when named).
Model directories and exported coefficient stores are the format both
packages share.

A registry owns the serving-side view of one training-driver output
directory: the ``MmapIndexMap``s the model was trained with, the loaded
``GameModel``, per-coordinate data configs reconstructed from
``game-metadata.json`` (the same reconstruction the batch scoring driver
does), and a warmed ``RowScorer``.

Hot-swap contract: ``swap(model_dir)`` builds and WARMS the new version
entirely in the calling thread (typically an admin request handler or a
background poller) while traffic keeps flowing against the current
version; only then does the current-version pointer move, under a lock, in
one reference assignment. Requests capture a version reference at submit
time and score against it even if a swap lands mid-flight — nothing is
ever torn down under an in-flight request (old versions are garbage-
collected when the last request referencing them completes).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Optional

import torch

from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.estimators.config import (
    FixedEffectDataConfig,
    RandomEffectDataConfig,
)
from photon_tpu_torch.index.index_map import MmapIndexMap
from photon_tpu_torch.io.data_reader import FeatureShardConfig
from photon_tpu_torch.io.model_io import default_index_root, load_game_model
from photon_tpu_torch.serving.scorer import RowScorer


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Operational knobs (docs/serving.md §knobs)."""

    max_batch: int = 64          # micro-batch row cap (pow2 recommended)
    max_wait_ms: float = 2.0     # batcher coalescing window
    cache_entities: int = 4096   # LRU device hot-set capacity per RE coord
    max_row_nnz: int = 128       # per-shard padded feature width per row
    default_bags: tuple = ("features",)  # pre-metadata models only
    # Robustness knobs (docs/robustness.md): bounded admission queue
    # (beyond it requests shed with HTTP 503 + Retry-After), per-request
    # deadline propagated into the batcher, and the coefficient-store
    # circuit breaker (0 breaker_failures disables; when open, RE lookups
    # degrade to fixed-effect-only scoring, flagged in the response).
    max_queue: int = 1024        # admission-queue bound (load shedding)
    request_timeout_s: float = 30.0  # per-request deadline
    breaker_failures: int = 5    # consecutive store failures to open
    breaker_cooldown_s: float = 2.0  # open-state duration before a probe
    breaker_slow_call_s: float = 0.0  # store-lookup latency SLO (0 = off)


@dataclasses.dataclass(frozen=True)
class ModelVersion:
    """One immutable, fully-warmed serving snapshot of a model directory."""

    version: int
    model_dir: str
    meta: dict
    scorer: RowScorer
    loaded_at: float

    @property
    def coordinates(self) -> dict:
        return self.meta["coordinates"]


def _model_dir_stamp(model_dir: str) -> tuple:
    """Content stamp of a model directory's top-level files
    ((name, mtime_ns, size) per entry, sorted): a re-push between
    ``prepare_standby`` and ``swap`` changes it, so a warmed-but-stale
    standby is detected and rebuilt instead of silently published."""
    out = []
    try:
        for name in sorted(os.listdir(model_dir)):
            try:
                st = os.stat(os.path.join(model_dir, name))
            except OSError:
                continue
            out.append((name, st.st_mtime_ns, st.st_size))
    except OSError:
        pass
    return tuple(out)


def _build_version(
    version: int, model_dir: str, config: ServingConfig,
    index_dir: Optional[str] = None, device: Optional[torch.device] = None,
) -> ModelVersion:
    with open(os.path.join(model_dir, "game-metadata.json")) as f:
        meta = json.load(f)
    shards = {info["feature_shard"] for info in meta["coordinates"].values()}
    index_root = index_dir or default_index_root(model_dir)
    index_maps = {
        s: MmapIndexMap(os.path.join(index_root, s)) for s in sorted(shards)
    }
    for im in index_maps.values():
        # Touch every partition now: lazy mmap loads must not land on the
        # first request's latency.
        im.preload()
    model, meta = load_game_model(model_dir, index_maps,
                                  dtype=torch.float32, device=device)

    data_configs = {}
    for cid, info in meta["coordinates"].items():
        if info["type"] == "fixed":
            data_configs[cid] = FixedEffectDataConfig(info["feature_shard"])
        else:
            data_configs[cid] = RandomEffectDataConfig(
                re_type=info["re_type"], feature_shard=info["feature_shard"]
            )
    saved_shards = meta.get("feature_shards", {})
    shard_configs = {
        s: (
            FeatureShardConfig(
                feature_bags=tuple(saved_shards[s]["feature_bags"]),
                add_intercept=saved_shards[s]["add_intercept"],
            )
            if s in saved_shards
            else FeatureShardConfig(feature_bags=tuple(config.default_bags))
        )
        for s in index_maps
    }
    scorer = RowScorer(model, data_configs, index_maps, shard_configs, config,
                       device)
    scorer.warmup()
    return ModelVersion(
        version=version,
        model_dir=model_dir,
        meta=meta,
        scorer=scorer,
        loaded_at=time.time(),
    )


class ModelRegistry:
    """Holds the current ModelVersion; ``swap`` replaces it atomically."""

    # Class-level default so partially constructed registries (tests build
    # bare instances via __new__ to isolate apply_delta) can still bump it.
    _store_generation = 0

    def __init__(
        self,
        model_dir: str,
        config: ServingConfig = ServingConfig(),
        index_dir: Optional[str] = None,
        device=None,
    ):
        self.config = config
        self.device = resolve_device(device)
        self._index_dir = index_dir
        self._lock = threading.Lock()
        self._swap_lock = threading.Lock()  # serializes concurrent swaps
        self._next_version = 1
        self._current: Optional[ModelVersion] = None
        # Warm standby (docs/robustness.md §"Recovery time"): a fully
        # built + warmed next version held aside so the swap that publishes
        # it collapses to a pointer move (prepare_standby / swap). The
        # directory stamp detects a re-push between prepare and swap.
        self._standby: Optional[ModelVersion] = None
        self._standby_prepared_at: Optional[float] = None
        self._standby_stamp: Optional[tuple] = None
        # Online-delta freshness bookkeeping (docs/online.md): patch_seq /
        # timestamps survive hot-swaps so /healthz freshness is measurable
        # with or without a trainer attached.
        self._patch_state = {
            "patch_seq": 0,
            "last_patch_ts": None,
            "last_patch_entities": 0,
            "patched_entities_total": 0,
            "last_event_horizon": None,
        }
        # Coefficient-visibility generation (docs/serving.md §"Front
        # line"): bumped on every swap AND every applied delta. Front-end
        # workers stamp the generation of their read-only store export on
        # each wire frame; the scorer only honors worker-verified entity
        # misses when the generations still match, so worker store
        # staleness can never change a score.
        self._store_generation = 0
        self.swap(model_dir)

    @property
    def current(self) -> ModelVersion:
        with self._lock:
            return self._current

    def prepare_standby(self, model_dir: str) -> dict:
        """Build + fully WARM ``model_dir`` as a standby version NOW —
        index preload, coefficient store, and the scorer's whole
        compiled-shape ladder — without publishing it. The next
        :meth:`swap` to the same directory then collapses to a pointer
        move: no load, no warmup, zero scoring-kernel retraces on the
        serving threads (docs/robustness.md §"Recovery time").

        Serialized against swaps (same lock), invisible to traffic. A
        failed build leaves any previous standby intact."""
        with self._swap_lock:
            stamp = _model_dir_stamp(model_dir)
            version = _build_version(
                self._next_version, model_dir, self.config, self._index_dir,
                self.device,
            )
            with self._lock:
                self._standby = version
                self._standby_prepared_at = time.time()
                self._standby_stamp = stamp
        from photon_tpu_torch.obs import instant

        instant("serving.standby_prepared", cat="serving",
                model_dir=model_dir)
        return {"model_dir": model_dir, "prepared_at": time.time(),
                "warmed": True}

    def standby_snapshot(self) -> dict:
        """Standby state for /healthz: is a pre-warmed next version ready,
        and for which model directory."""
        with self._lock:
            sb, at = self._standby, self._standby_prepared_at
        return {
            "ready": sb is not None,
            "model_dir": None if sb is None else sb.model_dir,
            "prepared_at": at,
        }

    def swap(self, model_dir: str) -> ModelVersion:
        """Load + warm ``model_dir`` as a new version, then publish it.

        Blocking for the caller; invisible to in-flight traffic until the
        final pointer assignment. Raises (and keeps the current version)
        if the new directory fails to load — a bad push can't take the
        server down.

        When :meth:`prepare_standby` already warmed this directory, the
        build + warmup are skipped entirely and the swap IS the pointer
        assignment — the ``swap_to_first_score_seconds`` the scorer stamps
        then measures one dispatch, not a model load. Either way the
        published scorer's swap clock is armed at publish time.
        """
        with self._swap_lock:
            with self._lock:
                standby = self._standby
                stamp = self._standby_stamp
                if standby is not None and standby.model_dir == model_dir:
                    self._standby = None
                    self._standby_prepared_at = None
                    self._standby_stamp = None
                else:
                    standby = None
            if standby is not None and stamp != _model_dir_stamp(model_dir):
                # The directory was re-pushed after prepare_standby: the
                # warmed snapshot no longer matches what's on disk.
                # Publishing it would silently serve OUTDATED coefficients
                # under the new version number — discard it and take the
                # build path (a slower swap, never a stale one).
                from photon_tpu_torch.obs import instant

                instant("serving.standby_stale", cat="serving",
                        model_dir=model_dir)
                standby = None
            from_standby = standby is not None
            if from_standby:
                version = dataclasses.replace(
                    standby, version=self._next_version,
                    loaded_at=time.time())
            else:
                version = _build_version(
                    self._next_version, model_dir, self.config,
                    self._index_dir, self.device
                )
            with self._lock:
                hot = self._current is not None
                self._current = version
                self._next_version += 1
                self._store_generation += 1
            if hot:
                # Swap→first-score clock (docs/robustness.md §recovery
                # time): armed at the pointer move, closed by the first
                # served batch. Not armed for the registry's initial load —
                # "time since construction" is startup, not a swap.
                version.scorer.arm_swap_clock()
        if hot:
            from photon_tpu_torch.obs import instant

            instant("serving.hot_swap", cat="serving",
                    version=version.version, from_standby=from_standby)
        return version

    def apply_delta(self, patches_by_coordinate, seq: Optional[int] = None,
                    event_horizon: Optional[int] = None) -> dict:
        """Apply an online model delta to the CURRENT version, atomically
        per coordinate (docs/online.md §"Delta protocol").

        ``patches_by_coordinate`` maps coordinate id → {entity key →
        ``(cols, vals)``}. Runs under the swap lock so a delta and a
        hot-swap serialize: a delta never lands half on an outgoing
        version; in-flight requests that captured the version pre-apply
        score consistent pre-delta coefficients (the store overlay swap is
        itself atomic). Validation failures (unknown coordinate, over-wide
        patch, unsorted cols) apply NOTHING.
        """
        with self._swap_lock:
            version = self.current
            # Validate EVERYTHING across EVERY coordinate before the first
            # apply — unknown coordinate, over-wide patch, bad column
            # layout anywhere refuses the whole delta with no coordinate
            # half-published (tested: a multi-coordinate delta with one
            # poisoned coordinate applies nothing).
            for cid, patches in patches_by_coordinate.items():
                version.scorer.validate_delta(cid, patches)
            applied = {}
            total = 0
            for cid, patches in patches_by_coordinate.items():
                applied[cid] = version.scorer.apply_delta(cid, patches)
                total += applied[cid]["patched"]
            with self._lock:
                st = self._patch_state
                st["patch_seq"] += 1
                st["last_patch_ts"] = time.time()
                st["last_patch_entities"] = total
                st["patched_entities_total"] += total
                if event_horizon is not None:
                    st["last_event_horizon"] = int(event_horizon)
                patch_seq = st["patch_seq"]
                self._store_generation += 1
        from photon_tpu_torch.obs import instant

        instant("serving.delta_applied", cat="serving", patch_seq=patch_seq,
                entities=total, trainer_seq=seq)
        return {
            "model_version": version.version,
            "patch_seq": patch_seq,
            "patched": total,
            "coordinates": applied,
        }

    @property
    def store_generation(self) -> int:
        with self._lock:
            return self._store_generation

    def export_frontline(self, runtime_dir: str) -> dict:
        """Write everything an accelerator-free front-end worker needs to
        parse + pre-resolve requests (docs/serving.md §"Front line"): the
        per-RE-coordinate ``CoefficientStore`` saved in its mmap-able flat
        layout, plus a ``frontline.json`` manifest carrying the parse
        config (feature bags, intercepts, row width), index-map locations,
        and the store generation at export time. Returns the manifest."""
        v = self.current
        scorer = v.scorer
        os.makedirs(runtime_dir, exist_ok=True)
        index_root = self._index_dir or default_index_root(v.model_dir)
        res = {}
        for cid, _shard in scorer.re_parts:
            store_dir = os.path.join(runtime_dir, "stores", cid)
            scorer._caches[cid].store.save(store_dir)
            res[cid] = {
                "re_type": scorer._re_types[cid],
                "feature_shard": scorer.data_configs[cid].feature_shard,
                "store_dir": store_dir,
            }
        shards = {}
        for s in scorer._shards_used:
            cfg = scorer.shard_configs[s]
            shards[s] = {
                "feature_bags": list(cfg.feature_bags),
                "add_intercept": bool(cfg.add_intercept),
                "dim": len(scorer.index_maps[s]),
                "intercept_index": scorer._intercepts.get(s),
                "index_dir": os.path.join(index_root, s),
            }
        manifest = {
            "generation": self.store_generation,
            "model_version": v.version,
            "model_dir": v.model_dir,
            "max_row_nnz": int(self.config.max_row_nnz),
            "request_timeout_s": float(self.config.request_timeout_s),
            "shards": shards,
            "re_coordinates": res,
        }
        path = os.path.join(runtime_dir, "frontline.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=2)
        os.replace(tmp, path)
        return manifest

    def freshness_snapshot(self) -> dict:
        """Serving freshness for /healthz and /metrics (measurable without
        the trainer attached): active version, when it was swapped in, and
        the delta-patch watermark."""
        v = self.current
        with self._lock:
            st = dict(self._patch_state)
        return {
            "model_version": v.version,
            "last_swap_ts": v.loaded_at,
            "seconds_since_swap": round(time.time() - v.loaded_at, 1),
            "patch_seq": st["patch_seq"],
            "last_patch_ts": st["last_patch_ts"],
            "seconds_since_patch": (
                round(time.time() - st["last_patch_ts"], 1)
                if st["last_patch_ts"] else None
            ),
            "last_patch_entities": st["last_patch_entities"],
            "patched_entities_total": st["patched_entities_total"],
            "last_event_horizon": st["last_event_horizon"],
        }
