"""The streaming incremental trainer (port of ``photon_tpu/online/trainer.py``).

Consume → dirty → micro-batch refresh → delta publish, as one loop:

1. **Consume.** Each event's feature bags resolve once per shard (same
   rules as the serving request parser); the row's OFFSET is composed at
   ingest from the frozen fixed-effect coordinates (their host ``w_ext``)
   plus the other random-effect coordinates' CURRENT published
   coefficients: the online analog of coordinate descent's "offsets from
   the other coordinates" (an entity refreshed later sees the offsets that
   were live at ingest, the one-sweep-stale semantics batch GAME has
   mid-sweep).
2. **Refresh.** Dirty entities (oldest pending event first) re-solve on
   their sliding windows as ONE ``build_random_effect_dataset`` micro-batch
   on the trainer's device: the bucketing and projection of batch
   training, solved at a FIXED ladder chunk (``fit_bucket_in_chunks``) by
   the batch gates' tier: primal Newton (P <= ``NEWTON_MAX_P``), the dual
   (S < P, S + u_max <= ``DUAL_MAX_T``), else the masked batched L-BFGS
   lanes (``problem.run_lanes`` over each padded chunk's block-diagonal
   ``LaneFeatures``, whose passes are the ``ell_matvec`` and
   ``csc_rmatvec`` kernels on the card). Each entity's solve is anchored
   to its previous posterior via :class:`PriorDistribution`
   (``incremental_weight`` folds into the precisions; 0 disables anchoring
   entirely, making a full-window refresh mathematically identical to a
   batch retrain on the same rows: the convergence-equivalence contract).
   One device-to-host fetch of a bucket's means and variances is the sync
   point, so a device loss surfaces before any state changes.
3. **Publish.** The refresh becomes a :class:`ModelDelta` (full
   replacement sparse vectors per changed entity; columns with no support
   in the window keep their previous posterior unchanged) handed to the
   publisher: in-process ``RegistryPublisher``, HTTP ``POST /admin/patch``
   or the delta log (``photon_tpu_torch.replication``). State, dirty marks,
   the journal, and the replay cursor advance ONLY after the publish
   returns: a failed publish leaves everything pending and the next cycle
   retries the same entities.

Failure contract: a classified device loss mid-refresh releases the
device caches (``supervisor.clear_executable_caches``) and re-runs the
refresh bit-identically (windows and priors are untouched until publish),
bounded by ``PHOTON_DEVICE_LOST_MAX_RECOVERIES``; a CUDA context that a
sticky error poisoned fails its tiny op (``backend_guard.context_usable``)
and ends the refresh with ``DeviceContextLost`` (cause ``device_lost``),
never retried in-process. An ``oom``-classified failure halves
``refresh_batch`` instead (sticky). The ``online.refresh`` and
``online.publish`` fault points let the chaos drills drive each path.
The JAX trainer's compile-store and retrace hooks have no counterpart:
the port compiles no XLA programs.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Iterable, Mapping, Optional, Sequence

import numpy as np

from photon_tpu_torch.faults import fault_point
from photon_tpu_torch.obs import instant, trace_span
from photon_tpu_torch.obs.metrics import REGISTRY
from photon_tpu_torch.online.delta import EntityPatch, ModelDelta, PatchJournal
from photon_tpu_torch.online.events import (
    EventCursor,
    EventError,
    OnlineEvent,
    resolve_event_features,
)
from photon_tpu_torch.online.state import EntityWindows, OnlineModelState

logger = logging.getLogger("photon_tpu_torch.online")

_EVENTS_TOTAL = REGISTRY.counter(
    "online_events_total",
    "events consumed by the online incremental trainer",
)
_ENTITIES_REFRESHED = REGISTRY.counter(
    "online_entities_refreshed_total",
    "entities re-solved and published by the online trainer",
)
_DELTAS_PUBLISHED = REGISTRY.counter(
    "online_deltas_published_total",
    "model deltas published into the serving registry",
)
_FRESHNESS = REGISTRY.histogram(
    "online_freshness_seconds",
    "event->published-delta freshness per refreshed entity (oldest "
    "pending event to publish completion)",
)
_DIRTY_GAUGE = REGISTRY.gauge(
    "online_dirty_entities",
    "entities with unrefreshed events, per coordinate",
)


@dataclasses.dataclass(frozen=True)
class OnlineCoordinate:
    """One refreshable random-effect coordinate."""

    cid: str
    re_type: str          # entity id column, e.g. "userId"
    feature_shard: str


@dataclasses.dataclass(frozen=True)
class OnlineTrainerConfig:
    """Operational knobs (docs/online.md §knobs)."""

    window: int = 64              # sliding-window rows per entity
    max_event_nnz: int = 64       # fixed per-shard feature width per event
    refresh_batch: int = 4096     # dirty entities per refresh cycle (cap)
    chunk: int = 256              # blessed lane count (must be on the
                                  # PHOTON_RE_CHUNK_LADDER: stable shapes)
    cadence_s: float = 0.0        # 0 = refresh on batch-full / drain only
    incremental_weight: float = 1.0   # prior anchor strength (0 = none)
    reg_weight: float = 1.0       # per-refresh L2 weight
    max_iterations: int = 30
    tolerance: float = 1e-7
    dtype: str = "float32"        # solve precision for assembled windows

    def __post_init__(self):
        from photon_tpu_torch.game.newton_re import chunk_ladder

        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.refresh_batch < 1:
            raise ValueError(
                f"refresh_batch must be >= 1, got {self.refresh_batch}")
        if self.incremental_weight < 0.0:
            raise ValueError(
                "incremental_weight must be >= 0, got "
                f"{self.incremental_weight}")
        if self.chunk not in chunk_ladder():
            raise ValueError(
                f"chunk={self.chunk} is not on the blessed chunk ladder "
                f"{chunk_ladder()} (PHOTON_RE_CHUNK_LADDER): off-ladder "
                "lane counts would give every refresh its own lane shapes"
            )


class RegistryPublisher:
    """In-process delta publisher: applies straight to a live
    ``ModelRegistry`` (the bench / embedded-trainer path)."""

    def __init__(self, registry):
        self.registry = registry

    def publish(self, delta: ModelDelta) -> dict:
        return self.registry.apply_delta(
            delta.raw_patches(), seq=delta.seq,
            event_horizon=delta.event_horizon,
        )


_PUBLISH_RETRIES = REGISTRY.counter(
    "online_publish_retries_total",
    "delta publish attempts retried on a transient connection error",
)


class HttpPublisher:
    """Cross-process delta publisher: ``POST /admin/patch`` against a live
    scoring server (docs/online.md §"Delta protocol").

    Transient connection failures (refused/reset/timeout — a serving
    replica restarting mid-publish) retry with bounded backoff using the
    supervisor's decorrelated-jitter :class:`RestartPolicy` math (``seed``
    pins the delay stream for tests); each retry bumps
    ``online_publish_retries_total``. An HTTP *response* never retries:
    the server got the delta, and a validation 4xx would fail identically
    forever — except a 503 shed, which is a "not now" the backoff exists
    for.

    Retry semantics are AT-LEAST-ONCE on the wire but exactly-once at the
    server: every POST carries ``X-Photon-Idempotency-Key`` (the delta's
    ``seq`` + content digest, :meth:`ModelDelta.idempotency_key`), so a
    timeout that fired AFTER the server applied the patch — reply lost in
    flight — makes the retry replay the first application's cached result
    (``"duplicate": true`` in the reply, ``serve_patch_duplicates_total``
    bumped) instead of re-applying. ``patch_seq``,
    ``patched_entities_total``, and the ``serving.delta_applied``
    journal/trace rows therefore count each logical delta once. For
    durable write-once fan-out with a per-seq exactly-once audit, use the
    delta log instead (``photon_tpu_torch.replication`` — docs/serving.md
    §"Replication")."""

    def __init__(self, base_url: str, timeout_s: float = 30.0,
                 retries: int = 3, backoff_s: float = 0.2,
                 max_backoff_s: float = 2.0,
                 seed: Optional[int] = None):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = float(timeout_s)
        self.retries = int(retries)
        # Lazy import at call time keeps this module import-light; the
        # policy itself is a frozen dataclass, safe to build per publisher.
        from photon_tpu_torch.supervisor import RestartPolicy

        self._policy = RestartPolicy(
            max_restarts=self.retries,
            backoff_seconds=float(backoff_s),
            max_backoff_seconds=float(max_backoff_s),
            seed=seed,
        )

    def publish(self, delta: ModelDelta) -> dict:
        import json
        import urllib.error
        import urllib.request

        from photon_tpu_torch.obs import current_trace_id, instant

        headers = {"Content-Type": "application/json"}
        # Cross-process trace join (docs/observability.md §"Fleet view"):
        # the publish span's trace id rides the request so the serving
        # process's /admin/patch spans land on the SAME id — the fleet
        # merger then shows event→refresh→publish→apply as one flow.
        tid = current_trace_id()
        if tid is not None:
            headers["X-Photon-Trace-Id"] = tid
        # One key for ALL attempts of this publish call: the server
        # dedupes a retry whose predecessor applied but whose reply was
        # lost (class docstring — the at-least-once double-count fix).
        headers["X-Photon-Idempotency-Key"] = delta.idempotency_key()
        data = json.dumps(delta.to_wire()).encode("utf-8")
        delays = self._policy.delays()
        last: Optional[BaseException] = None
        for attempt in range(self.retries + 1):
            req = urllib.request.Request(
                self.base_url + "/admin/patch", data=data,
                headers=headers, method="POST",
            )
            try:
                with urllib.request.urlopen(
                        req, timeout=self.timeout_s) as resp:
                    return json.loads(resp.read())
            except urllib.error.HTTPError as e:
                if e.code == 503 and attempt < self.retries:
                    # A shed/draining replica: transient by contract
                    # (503 + Retry-After), worth the backoff.
                    last = e
                else:
                    # Surface the server's actionable validation message
                    # (e.g. the over-wide-patch guidance), not just
                    # "HTTP Error 400".
                    detail = ""
                    try:
                        detail = e.read().decode("utf-8", "replace")[:500]
                    except Exception:  # noqa: BLE001 - best-effort
                        pass
                    raise RuntimeError(
                        f"delta publish rejected by {self.base_url} "
                        f"(HTTP {e.code}): {detail or e.reason}"
                    ) from e
            except (urllib.error.URLError, ConnectionError,
                    TimeoutError, OSError) as e:
                # Connection-level failure. A refused/reset connection
                # means the server never saw the delta; a TIMEOUT may
                # fire after the server applied it with the reply in
                # flight, so this retry is at-least-once (class doc):
                # idempotent for coefficients (full-replacement patches),
                # but patch_seq and the delta_applied rows can
                # double-count the re-post.
                last = e
            if attempt >= self.retries:
                break
            delay = next(delays)
            _PUBLISH_RETRIES.inc()
            instant("online.publish_retry", cat="online",
                    attempt=attempt + 1, delay_s=round(delay, 3),
                    error=f"{type(last).__name__}: {str(last)[:200]}")
            logger.warning(
                "delta publish to %s failed (%s: %s); retry %d/%d in "
                "%.2fs", self.base_url, type(last).__name__, last,
                attempt + 1, self.retries, delay,
            )
            time.sleep(delay)
        raise RuntimeError(
            f"delta publish to {self.base_url} failed after "
            f"{self.retries + 1} attempt(s): "
            f"{type(last).__name__}: {last}"
        ) from last


class OnlineTrainer:
    """Streaming per-entity delta trainer (module doc).

    ``publisher`` is anything with ``publish(ModelDelta) -> dict``; None
    runs the trainer "open-loop" (state + journal advance, nothing served —
    useful for shadow evaluation). ``on_bad_event`` receives
    (:class:`EventError`, event dict) per malformed event (default: warn
    and continue — one producer bug must not kill the stream). ``device``
    is where the refreshes solve: ``cuda`` unless the caller names the CPU
    (``resolve_device``: no GPU raises, never a fallback).
    """

    def __init__(
        self,
        task,
        coordinates: Sequence[OnlineCoordinate],
        index_maps: Mapping[str, object],
        shard_configs: Mapping[str, object],
        config: OnlineTrainerConfig = OnlineTrainerConfig(),
        publisher=None,
        fixed_weights: Optional[Mapping[str, tuple]] = None,
        journal: Optional[PatchJournal] = None,
        cursor: Optional[EventCursor] = None,
        on_bad_event: Optional[Callable] = None,
        device=None,
    ):
        from photon_tpu_torch.device import resolve_device

        if not coordinates:
            raise ValueError("online trainer needs >= 1 random-effect "
                             "coordinate")
        self.task = task
        self.coordinates = {c.cid: c for c in coordinates}
        self.index_maps = dict(index_maps)
        self.shard_configs = dict(shard_configs)
        self.config = config
        self.publisher = publisher
        self.journal = journal
        self.cursor = cursor
        self.on_bad_event = on_bad_event
        self.device = resolve_device(device)
        # Fixed-effect coordinates stay FROZEN online; their host-side
        # extended weight vectors (ghost column == dim -> 0) compose each
        # event's offset at ingest.
        self._fixed_ext: dict = {}
        for cid, (shard, w) in (fixed_weights or {}).items():
            w = np.asarray(w, np.float64)
            self._fixed_ext[cid] = (shard, np.concatenate([w, [0.0]]))
        self.windows: dict = {
            cid: EntityWindows(config.window) for cid in self.coordinates
        }
        self.state: dict = {
            cid: OnlineModelState() for cid in self.coordinates
        }
        self._shards_used = sorted(
            {c.feature_shard for c in coordinates}
            | {shard for shard, _ in self._fixed_ext.values()}
        )
        self._problem = self._build_problem()
        self._delta_seq = 0
        self._consumed_seq = -1       # highest event seq ingested
        self._last_refresh_t = time.monotonic()
        self.totals = {
            "events": 0, "bad_events": 0, "cycles": 0, "deltas": 0,
            "entities_refreshed": 0, "device_loss_recoveries": 0,
        }

    # ------------------------------------------------------------- assembly

    @classmethod
    def from_game_model(
        cls,
        model,
        data_configs: Mapping[str, object],
        index_maps: Mapping[str, object],
        shard_configs: Mapping[str, object],
        config: OnlineTrainerConfig = OnlineTrainerConfig(),
        **kwargs,
    ) -> "OnlineTrainer":
        """Seed from a trained/loaded ``GameModel`` + its data configs:
        fixed coordinates freeze into offset composers (host copies of
        their means), random-effect coordinates seed the posterior state
        each refresh anchors to (a model loaded on the CPU seeds without a
        device fetch per entity)."""
        from photon_tpu_torch.estimators.config import (
            FixedEffectDataConfig,
            RandomEffectDataConfig,
        )
        from photon_tpu_torch.game.coordinates import FixedEffectModel

        coords, fixed, task = [], {}, None
        for cid, dcfg in data_configs.items():
            m = model[cid]
            if isinstance(dcfg, FixedEffectDataConfig):
                if not isinstance(m, FixedEffectModel):
                    raise TypeError(
                        f"{cid!r}: fixed-effect config, {type(m)} model")
                task = m.model.task
                fixed[cid] = (
                    dcfg.feature_shard,
                    m.model.coefficients.means.cpu().numpy().astype(
                        np.float64),
                )
            elif isinstance(dcfg, RandomEffectDataConfig):
                task = m.task
                coords.append(OnlineCoordinate(
                    cid=cid, re_type=dcfg.re_type,
                    feature_shard=dcfg.feature_shard,
                ))
        trainer = cls(
            task=task, coordinates=coords, index_maps=index_maps,
            shard_configs=shard_configs, config=config,
            fixed_weights=fixed, **kwargs,
        )
        for c in coords:
            trainer.state[c.cid] = (
                OnlineModelState.from_random_effect_model(model[c.cid]))
        return trainer

    def _build_problem(self):
        from photon_tpu_torch.functions.problem import (
            GLMOptimizationProblem,
            VarianceComputationType,
        )
        from photon_tpu_torch.optim import (
            OptimizerConfig,
            OptimizerType,
            RegularizationContext,
            RegularizationType,
        )

        # LBFGS type + smooth L2 keeps every refresh inside the history-free
        # Newton gates (newton_re._smooth_ok); SIMPLE variances feed the
        # next refresh's prior precisions.
        return GLMOptimizationProblem(
            task=self.task,
            optimizer_type=OptimizerType.LBFGS,
            optimizer_config=OptimizerConfig(
                max_iterations=self.config.max_iterations,
                tolerance=self.config.tolerance,
            ),
            regularization=RegularizationContext(RegularizationType.L2),
            reg_weight=self.config.reg_weight,
            variance_type=VarianceComputationType.SIMPLE,
        )

    # -------------------------------------------------------------- consume

    def ingest(self, event: OnlineEvent) -> bool:
        """Resolve one event into window rows; returns False on a
        malformed event (reported via ``on_bad_event``)."""
        try:
            rows = resolve_event_features(
                event, self.index_maps, self.shard_configs,
                self._shards_used, self.config.max_event_nnz,
            )
        except EventError as e:
            self.totals["bad_events"] += 1
            if self.on_bad_event is not None:
                self.on_bad_event(e, event)
            else:
                logger.warning("bad event (seq %d) skipped: %s",
                               event.seq, e)
            return False
        fixed_total = 0.0
        for shard, w_ext in self._fixed_ext.values():
            idx, val = rows[shard]
            fixed_total += float(np.sum(w_ext[idx] * np.asarray(
                val, np.float64)))
        any_entity = False
        for cid, coord in self.coordinates.items():
            key = event.entities.get(coord.re_type)
            if key is None:
                continue
            any_entity = True
            idx, val = rows[coord.feature_shard]
            offset = event.offset + fixed_total
            # Other coordinates' published contributions at INGEST time
            # (one-sweep-stale offsets — module doc).
            for ocid, other in self.coordinates.items():
                if ocid == cid:
                    continue
                okey = event.entities.get(other.re_type)
                if okey is None:
                    continue
                oidx, oval = rows[other.feature_shard]
                offset += self.state[ocid].score_contribution(
                    okey, oidx, oval,
                    len(self.index_maps[other.feature_shard]),
                )
            self.windows[cid].add_row(
                key, idx, val, event.label, event.weight, offset,
                event.ts or time.time(), event.seq,
            )
        self.totals["events"] += 1
        _EVENTS_TOTAL.inc()
        if event.seq >= 0:
            self._consumed_seq = max(self._consumed_seq, event.seq)
        return any_entity

    # -------------------------------------------------------------- refresh

    def n_dirty(self) -> int:
        return sum(w.n_dirty for w in self.windows.values())

    def _should_refresh(self) -> bool:
        if self.n_dirty() == 0:
            return False
        if any(w.n_dirty >= self.config.refresh_batch
               for w in self.windows.values()):
            return True
        return (self.config.cadence_s > 0.0
                and time.monotonic() - self._last_refresh_t
                >= self.config.cadence_s)

    def refresh(self) -> Optional[dict]:
        """One refresh cycle: re-solve dirty entities of every coordinate,
        publish ONE delta covering them all. Returns a summary dict, or
        None when nothing was dirty."""
        plan = {}
        for cid, w in self.windows.items():
            dirty = w.peek_dirty(self.config.refresh_batch)
            if dirty:
                plan[cid] = dirty
        if not plan:
            return None
        # Horizon: the highest event seq this refresh can cover. Captured
        # BEFORE solving so events racing in mid-solve stay dirty (and the
        # cursor never advances past unpublished data).
        horizon = self._consumed_seq
        t0 = time.monotonic()
        with trace_span("online.refresh", cat="online",
                        coordinates=sorted(plan),
                        entities=sum(len(d) for d in plan.values())) as sp:
            solved = self._solve_plan_recovering(plan)
            patches = {
                cid: self._merge_patches(cid, by_key)
                for cid, by_key in solved.items()
            }
            delta = ModelDelta(
                seq=self._delta_seq,
                patches=patches,
                event_horizon=horizon,
                created_ts=time.time(),
            )
            published = self._publish(delta, plan, solved)
            sp.set(seq=delta.seq, published=bool(self.publisher))
        wall = time.monotonic() - t0
        n = delta.n_entities
        self._last_refresh_t = time.monotonic()
        self.totals["cycles"] += 1
        self.totals["deltas"] += 1
        self.totals["entities_refreshed"] += n
        for cid, w in self.windows.items():
            _DIRTY_GAUGE.set(w.n_dirty, coordinate=cid)
        return {
            "seq": delta.seq,
            "entities": n,
            "coordinates": sorted(plan),
            "seconds": round(wall, 4),
            "entities_per_sec": round(n / wall, 1) if wall > 0 else None,
            "freshness_s": published["freshness_s"],
            "device_loss_recoveries": published["recoveries"],
        }

    def _solve_plan_recovering(self, plan: Mapping[str, list]) -> dict:
        """Solve every coordinate's dirty micro-batch, absorbing up to
        ``PHOTON_DEVICE_LOST_MAX_RECOVERIES`` classified device losses by
        releasing the device caches and re-running bit-identically
        (windows/priors are immutable until publish, so the retry solves
        the exact same problem). A CUDA context that fails its tiny op
        after the release was poisoned by a sticky error: the refresh ends
        with ``DeviceContextLost`` (cause ``device_lost``), never retried in
        this process.

        An ``oom``-classified failure takes the DEGRADATION ladder instead:
        ``refresh_batch`` halves (sticky, the config stays halved for the
        trainer's lifetime) and the PLAN is trimmed in place to the new
        cap, so this cycle publishes a smaller delta and the un-trimmed
        entities simply stay dirty for the next cycle (exactly the
        existing refresh-batch cap semantics; no state mutates until
        publish, so nothing tears). Bounded by
        ``PHOTON_OOM_MAX_DOWNSHIFTS``."""
        from photon_tpu_torch.runtime import memory_guard as _mg
        from photon_tpu_torch.runtime.backend_guard import (
            DeviceContextLost,
            context_usable,
            is_device_lost,
            max_inrun_recoveries,
        )
        from photon_tpu_torch.supervisor import clear_executable_caches

        recoveries = 0
        while True:
            try:
                fault_point("online.refresh",
                            entities=sum(len(d) for d in plan.values()))
                out = {cid: self._solve_coordinate(cid, dirty)
                       for cid, dirty in plan.items()}
                self._recoveries_last = recoveries
                return out
            except KeyboardInterrupt:
                raise  # a user abort is never a retryable device loss
            except Exception as e:  # noqa: BLE001 - classified below
                if _mg.is_oom(e):
                    cur = self.config.refresh_batch
                    new = max(1, cur // 2)
                    if new >= cur:
                        # No cheaper rung: journal the classified
                        # exhaustion before escalating (re.solve contract).
                        _mg.journal_event(
                            "oom_exhausted", site="online.refresh",
                            cause="oom", plan=f"refresh_batch={cur}",
                            reason="refresh_batch already 1")
                        raise
                    if not _mg.downshifter("online.refresh").absorb(
                            e, before=f"refresh_batch={cur}",
                            after=f"refresh_batch={new}"):
                        raise  # absorb journaled the spent budget
                    # Sticky: every later cycle plans at the halved cap.
                    self.config = dataclasses.replace(
                        self.config, refresh_batch=new)
                    for cid in list(plan):
                        plan[cid] = plan[cid][:new]
                    continue
                if not is_device_lost(e) or \
                        recoveries >= max_inrun_recoveries():
                    raise
                recoveries += 1
                self.totals["device_loss_recoveries"] += 1
                instant("recovery.online_refresh", cat="recovery",
                        attempt=recoveries,
                        error=f"{type(e).__name__}: {str(e)[:200]}")
                logger.warning(
                    "device loss mid-refresh (%s); releasing the device "
                    "caches and re-running (recovery %d)", e, recoveries,
                )
                clear_executable_caches("online refresh recovery")
                if self.device.type == "cuda" and not context_usable():
                    raise DeviceContextLost(
                        "CUDA context unusable after a sticky error "
                        "mid-refresh: the device is lost to this process; "
                        "restart it (the replay cursor resumes at the last "
                        "published delta)") from e

    def _solve_coordinate(self, cid: str, dirty: list) -> dict:
        """Re-solve one coordinate's dirty entities on their windows.
        Returns ``{key: (cols, means, variances, first_pending_ts)}``:
        host numpy only (one device-to-host fetch of each bucket's means
        and variances is the device sync, so a device loss surfaces HERE,
        before any state mutation)."""
        import torch

        from photon_tpu_torch.data.random_effect import (
            build_random_effect_dataset,
        )

        coord = self.coordinates[cid]
        w = self.windows[cid]
        keys, first_ts = [], {}
        rows_keys, rows_idx, rows_val = [], [], []
        rows_lab, rows_wt, rows_off = [], [], []
        for key, ts, _seq in dirty:
            rows = w.rows_for(key)
            if not rows:
                continue
            keys.append(key)
            first_ts[key] = ts
            for (idx, val, label, weight, offset, _ts, _s) in rows:
                rows_keys.append(key)
                rows_idx.append(idx)
                rows_val.append(val)
                rows_lab.append(label)
                rows_wt.append(weight)
                rows_off.append(offset)
        if not keys:
            return {}
        dt = np.dtype(self.config.dtype)
        dim = len(self.index_maps[coord.feature_shard])
        dataset = build_random_effect_dataset(
            coord.re_type,
            np.asarray(rows_keys, object),
            np.stack(rows_idx).astype(np.int32),
            np.stack(rows_val).astype(dt),
            np.asarray(rows_lab, dt),
            global_dim=dim,
            weights=np.asarray(rows_wt, dt),
            dtype=getattr(torch, self.config.dtype),
            device=self.device,
        )
        offsets_vec = torch.from_numpy(np.asarray(rows_off, dt)).to(
            self.device)
        out: dict = {}
        for b_i, bucket in enumerate(dataset.buckets):
            proj = bucket.proj.cpu().numpy()
            eids = bucket.entity_ids.cpu().numpy()
            batches = bucket.local_batches(offsets_vec)
            w0, prior = self._bucket_warmstart(cid, dataset, proj, eids, dt)
            mask = torch.ones((bucket.n_entities, bucket.local_dim),
                              dtype=batches.features.val.dtype,
                              device=self.device)
            with trace_span("online.solve", cat="online", coordinate=cid,
                            bucket=b_i, entities=bucket.n_entities,
                            local_dim=bucket.local_dim) as sp:
                models, solver = self._solve_bucket(
                    batches, w0, mask, prior)
                # One D2H fetch of means (+ variances) = the device sync.
                c = models.coefficients
                fetched = (c.means if c.variances is None else
                           torch.stack([c.means, c.variances])).cpu().numpy()
                means = fetched if c.variances is None else fetched[0]
                variances = None if c.variances is None else fetched[1]
                sp.set(solver=solver)
            for lane in range(bucket.n_entities):
                dense = int(eids[lane])
                if dense < 0:
                    continue
                key = dataset.entity_keys[dense]
                pv = proj[lane]
                valid = pv < dim
                cols = pv[valid].astype(np.int64)
                out[key] = (
                    cols,
                    means[lane][valid].astype(np.float64),
                    (variances[lane][valid].astype(np.float64)
                     if variances is not None else None),
                    first_ts[key],
                )
        return out

    def _bucket_warmstart(self, cid: str, dataset, proj: np.ndarray,
                          eids: np.ndarray, dt):
        """(w0, prior) for one bucket (``proj`` / ``eids``: its projection
        and entity ids on the host): previous posterior projected into
        each lane's local subspace. Missing entities/columns get the
        N(0, 1) default posterior — the same fill as
        ``RandomEffectModel.project_posteriors_to``; ``incremental_weight
        == 0`` returns no prior at all (plain warm start). The means and
        variances go to the trainer's device in one copy."""
        import torch

        from photon_tpu_torch.functions.prior import PriorDistribution

        state = self.state[cid]
        e, p = proj.shape
        means = np.zeros((e, p), np.float64)
        var = np.ones((e, p), np.float64)
        for lane in range(e):
            dense = int(eids[lane])
            if dense < 0:
                continue
            post = state.posterior_for(dataset.entity_keys[dense])
            if post is None:
                continue
            cols, m, v = post
            if len(cols) == 0:
                continue
            pv = proj[lane]
            pos = np.clip(np.searchsorted(cols, pv), 0, len(cols) - 1)
            hit = (cols[pos] == pv) & (pv < dataset.global_dim)
            means[lane][hit] = m[pos[hit]]
            if v is not None:
                var[lane][hit] = v[pos[hit]]
        if self.config.incremental_weight <= 0.0:
            return torch.from_numpy(means.astype(dt)).to(self.device), None
        # w0, the prior's means, its variances: three [E, P] slices of one
        # upload (the solvers never write into w0).
        dev = torch.from_numpy(
            np.stack([means, means, var]).astype(dt)).to(self.device)
        return dev[0], PriorDistribution.from_model(
            dev[1], dev[2], self.config.incremental_weight)

    def _solve_bucket(self, batches, w0, mask, prior):
        """History-free solve at a FIXED blessed chunk size: primal Newton
        for small local dims, span-reduced dual for the few-rows-wide-
        subspace regime, the masked batched L-BFGS lanes as the
        unconditional fallback (each padded chunk's lanes over their
        block-diagonal ``LaneFeatures`` with the accelerator layouts, no
        normalization, as the JAX trainer's vmapped solve passes none).
        Every dispatch pads the entity axis to ``config.chunk`` lanes
        (``fit_bucket_in_chunks``), so refreshes see a closed set of lane
        shapes. Returns ``(models, solver)``."""
        from photon_tpu_torch.data.batch import LabeledBatch, LaneFeatures
        from photon_tpu_torch.game.newton_re import (
            DUAL_MAX_T,
            NEWTON_MAX_P,
            fit_bucket_in_chunks,
            fit_bucket_newton,
            fit_bucket_newton_dual,
            penalty_terms,
            u_max_for,
        )

        problem = self._problem
        e, s, _ = batches.features.idx.shape
        p = batches.features.dim
        solver = "vmapped_lbfgs"
        if p <= NEWTON_MAX_P:
            solver = "newton_primal"

            def fit_one(b, w, m, pr):
                return fit_bucket_newton(problem, b, w, m, pr)
        elif s < p and s <= DUAL_MAX_T:
            u_max = u_max_for(penalty_terms(problem, mask, prior)[3])
            if s + u_max <= DUAL_MAX_T:
                solver = "newton_dual"

                def fit_one(b, w, m, pr):
                    return fit_bucket_newton_dual(problem, b, w, m, pr,
                                                  u_max)
        if solver == "vmapped_lbfgs":
            def fit_one(b, w, m, pr):
                f = b.features
                lanes = LabeledBatch(
                    features=LaneFeatures.from_bucket(
                        f.idx, f.val, f.dim).with_accelerator_paths(),
                    labels=b.labels, offsets=b.offsets, weights=b.weights)
                return problem.run_lanes(lanes, w, m, None, pr)
        models, _result = fit_bucket_in_chunks(
            fit_one, self.config.chunk, batches, w0, mask, prior)
        return models, solver

    # -------------------------------------------------------------- publish

    def _merge_patches(self, cid: str, solved: Mapping[str, tuple]) -> dict:
        """Solve results → full replacement patches: columns with no
        support in the entity's window keep their previous posterior
        value (the prior is the only force on them, and its optimum IS the
        previous mean)."""
        state = self.state[cid]
        out = {}
        for key, (cols, means, variances, _ts) in solved.items():
            prev = state.posterior_for(key)
            if prev is not None and len(prev[0]):
                pcols, pmeans, _pv = prev
                keep = ~np.isin(pcols, cols)
                if keep.any():
                    cols = np.concatenate([cols, pcols[keep]])
                    means = np.concatenate([means, pmeans[keep]])
                    order = np.argsort(cols)
                    cols, means = cols[order], means[order]
            out[key] = EntityPatch(
                key=str(key), cols=cols.astype(np.int32),
                vals=means.astype(np.float32),
            )
        return out

    def _publish(self, delta: ModelDelta, plan: Mapping[str, list],
                 solved: Mapping[str, Mapping[str, tuple]]) -> dict:
        """Publish + commit: state, dirty marks, journal, cursor advance
        ONLY after the publisher returns. The commit order is the no-torn-
        delta contract's trainer half (the store half is the overlay
        swap): an exception anywhere in here leaves every window dirty and
        every posterior unrefreshed, so the next cycle re-solves and
        re-publishes the identical delta."""
        solved_keys = {cid: [k for k, _, _ in dirty]
                       for cid, dirty in plan.items()}
        publish_result = None
        from photon_tpu_torch.obs import current_trace_id, new_trace_id, \
            trace_context

        # One trace id per publish, attached to this thread so the span
        # below AND the HttpPublisher's X-Photon-Trace-Id header carry it
        # — the serving side joins on the same id (fleet merge contract).
        with trace_context(current_trace_id() or new_trace_id()), \
                trace_span("online.publish", cat="online", seq=delta.seq,
                           entities=delta.n_entities) as sp:
            fault_point("online.publish", seq=delta.seq)
            if self.publisher is not None:
                publish_result = self.publisher.publish(delta)
            now = time.time()
            fresh = []
            for cid, dirty in plan.items():
                for key, ts, _seq in dirty:
                    if key in delta.patches.get(cid, {}):
                        fresh.append(max(0.0, now - ts))
            for f in fresh:
                _FRESHNESS.observe(f)
            sp.set(freshness_max_s=round(max(fresh), 4) if fresh else None)
        # -- commit (post-publish) ----------------------------------------
        for cid, by_key in delta.patches.items():
            state = self.state[cid]
            for key, patch in by_key.items():
                # Variances aligned to the (merged) patch columns: solved
                # columns take the fresh SIMPLE variances, carried-over
                # columns keep their previous posterior width — the anchor
                # for the NEXT refresh of this entity.
                state.update(key, patch.cols.astype(np.int64),
                             patch.vals.astype(np.float64),
                             _aligned_variances(
                                 patch, state.posterior_for(key),
                                 solved.get(cid, {}).get(key)))
            self.windows[cid].clear_dirty(solved_keys[cid],
                                          horizon=delta.event_horizon)
        _DELTAS_PUBLISHED.inc()
        for cid, by_key in delta.patches.items():
            _ENTITIES_REFRESHED.inc(len(by_key), coordinate=cid)
        if self.journal is not None:
            self.journal.record(delta, publish_result or {"local": True},
                                freshness_s=fresh)
        if self.cursor is not None:
            # The HORIZON, not the live consumed seq: events ingested while
            # this refresh solved are unpublished and must replay after a
            # restart.
            self.cursor.save(delta.event_horizon + 1)
        self._delta_seq += 1
        return {"freshness_s": fresh, "recoveries":
                getattr(self, "_recoveries_last", 0),
                "publish_result": publish_result}

    # ----------------------------------------------------------------- run

    def run(
        self,
        events: Iterable[OnlineEvent],
        max_cycles: Optional[int] = None,
        drain: bool = True,
    ) -> dict:
        """Consume the stream, refreshing on the configured cadence; a
        final drain refresh covers the tail. ``None`` items are IDLE TICKS
        (a followed-but-quiet stream — ``iter_events(idle_yield_s=...)``):
        nothing ingests, but the cadence check still runs so dirty
        entities never sit unpublished waiting for the next event.
        Returns a totals summary."""
        refresh_summaries = []
        for ev in events:
            if ev is not None:
                self.ingest(ev)
            if self._should_refresh():
                s = self.refresh()
                if s is not None:
                    refresh_summaries.append(s)
                if max_cycles is not None and \
                        self.totals["cycles"] >= max_cycles:
                    break
        if drain and (max_cycles is None
                      or self.totals["cycles"] < max_cycles):
            s = self.refresh()
            if s is not None:
                refresh_summaries.append(s)
        fresh = [f for s in refresh_summaries for f in s["freshness_s"]]
        fresh.sort()

        def q(p: float) -> Optional[float]:
            if not fresh:
                return None
            return fresh[min(len(fresh) - 1, int(p * len(fresh)))]

        return {
            **self.totals,
            "refreshes": refresh_summaries,
            "freshness_p50_s": q(0.50),
            "freshness_p95_s": q(0.95),
            "freshness_samples": len(fresh),
        }


def _aligned_variances(patch: EntityPatch, prev, solved) -> np.ndarray:
    """Posterior variances for a patch's merged column set: default 1,
    previous posterior where carried over, fresh solved variances where
    re-solved (solved wins on overlap — it saw the window's data)."""
    var = np.ones(len(patch.cols), np.float64)
    pcols = patch.cols.astype(np.int64)
    for src in (prev, solved):
        if src is None:
            continue
        scols, svar = np.asarray(src[0], np.int64), src[2]
        if svar is None or len(scols) == 0:
            continue
        pos = np.searchsorted(pcols, scols)
        ok = pos < len(pcols)
        ok[ok] &= pcols[pos[ok]] == scols[ok]
        var[pos[ok]] = np.asarray(svar, np.float64)[ok]
    return var
