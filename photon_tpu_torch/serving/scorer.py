"""Row scorer: request parsing + padded micro-batch assembly + the kernel.

Port of ``photon_tpu/serving/scorer.py``. One ``RowScorer`` per
``ModelVersion``, on one explicit device. It owns the device-resident fixed
coefficients, the per-random-effect ``CoefficientStore`` + LRU device cache,
and the stable shapes of the scoring program
(``estimators.game_transformer.additive_score_rows``):

* row counts pad to the next power of two, capped at ``max_batch``: a fixed
  ladder of bucket shapes, each run once by ``warmup()`` (on CUDA: the
  kernel library is loaded and the allocator holds every bucket's blocks);
* per-shard feature width is the fixed ``max_row_nnz`` (requests beyond it
  are refused with a client error, never truncated);
* the random-effect subspace width is fixed per version by the coefficient
  store's widest entity; LRU staging rewrites table rows, never shapes.

The JAX scorer's XLA-only parts have no counterpart here: the port compiles
no programs, so there is no retrace sentinel, no compile store and no
``kernel_traces_total`` metric. Its form of "no recompile after warmup": a
request of any bucket launches the kernels that the bucket's warmup
launched and builds no library.

A batch's rows and its random effects' cache slots are assembled in one
host buffer (pinned on CUDA) and reach the device in one copy (a batch's
missed entities are staged by the cache in one more); the scores come back in one device-to-host copy,
the batch's only sync point, inside the ``serve.kernel`` span. A scorer on
the card never scores on the CPU: a failed build or launch of
``ell_matvec`` fails the request.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from photon_tpu_torch.estimators.config import (
    FixedEffectDataConfig,
    RandomEffectDataConfig,
)
from photon_tpu_torch.estimators.game_transformer import additive_score_rows
from photon_tpu_torch.faults import fault_point
from photon_tpu_torch.game.coordinates import FixedEffectModel
from photon_tpu_torch.game.random_effect import RandomEffectModel
from photon_tpu_torch.obs import trace_span
from photon_tpu_torch.serving.circuit import CircuitBreaker
from photon_tpu_torch.serving.coefficient_store import (
    CoefficientStore,
    DeviceCoefficientCache,
    _next_pow2,
)


class RequestError(ValueError):
    """Client-side problem with one request (HTTP 400, not 500)."""


@dataclasses.dataclass
class ParsedRow:
    """One request after feature-index resolution (host numpy only)."""

    shard_idx: Mapping[str, np.ndarray]   # shard -> [K] int32 (ghost = dim)
    shard_val: Mapping[str, np.ndarray]   # shard -> [K] float32
    offset: float
    entity_keys: Mapping[str, Optional[str]]  # RE coordinate id -> key


def _align(n: int) -> int:
    """``n`` int32 words rounded up to 16 bytes."""
    return -(-n // 4) * 4


class RowScorer:
    def __init__(self, model, data_configs, index_maps, shard_configs, config,
                 device):
        self.model = model
        self.data_configs = dict(data_configs)
        self.index_maps = dict(index_maps)
        self.shard_configs = dict(shard_configs)
        self.config = config
        self.device = torch.device(device)
        self._intercepts = {
            s: im.intercept_index
            for s, im in index_maps.items()
            if shard_configs[s].add_intercept
            and im.intercept_index is not None
        }

        fixed_parts, re_parts = [], []
        self._fixed_ws, self._caches = {}, {}
        for cid, dcfg in self.data_configs.items():
            m = model[cid]
            if isinstance(dcfg, FixedEffectDataConfig):
                if not isinstance(m, FixedEffectModel):
                    raise TypeError(
                        f"{cid!r}: fixed-effect config, {type(m)} model"
                    )
                w = m.model.coefficients.means.to(self.device, torch.float32)
                self._fixed_ws[cid] = torch.cat([w, w.new_zeros(1)])
                fixed_parts.append((cid, dcfg.feature_shard))
            elif isinstance(dcfg, RandomEffectDataConfig):
                if not isinstance(m, RandomEffectModel):
                    raise TypeError(
                        f"{cid!r}: random-effect config, {type(m)} model"
                    )
                store = CoefficientStore.from_model(m)
                breaker = None
                if getattr(config, "breaker_failures", 0) > 0:
                    breaker = CircuitBreaker(
                        failure_threshold=config.breaker_failures,
                        cooldown_s=config.breaker_cooldown_s,
                        slow_call_s=config.breaker_slow_call_s or None,
                    )
                self._caches[cid] = DeviceCoefficientCache(
                    store,
                    # Floor at max_batch: a batch pins its own slots against
                    # eviction, one slot per distinct entity at worst.
                    capacity=max(config.cache_entities, config.max_batch),
                    breaker=breaker,
                    device=self.device,
                )
                re_parts.append((cid, dcfg.feature_shard))
            else:  # pragma: no cover - union is closed
                raise TypeError(f"unknown data config {type(dcfg)}")
        self.fixed_parts = tuple(fixed_parts)
        self.re_parts = tuple(re_parts)
        self._re_types = {
            cid: self.data_configs[cid].re_type for cid, _ in re_parts
        }
        self._shards_used = sorted(
            {shard for _, shard in fixed_parts + re_parts}
        )
        # Kernel-path circuit breaker: the store breakers above degrade a
        # sick coefficient STORE; this one bounds recovery attempts when the
        # scoring program itself fails on a classified device loss. Closed:
        # one cache release + re-run. Open: the error fast-fails the batch.
        # breaker_failures=0 disables it (kernel errors surface unrecovered).
        kernel_failures = getattr(config, "breaker_failures", 5)
        self.kernel_breaker = (
            CircuitBreaker(
                failure_threshold=max(1, int(kernel_failures)),
                cooldown_s=getattr(config, "breaker_cooldown_s", 2.0) or 2.0,
            )
            if kernel_failures > 0 else None
        )
        # Effective micro-batch cap under the OOM ladder: an oom-classified
        # kernel failure halves it to the next-smaller warmed bucket, sticky
        # for the run (a hot-swap's fresh scorer starts at the proven cap).
        cap = int(config.max_batch)
        from photon_tpu_torch.runtime.memory_guard import sticky_plan

        sticky = sticky_plan("serving.kernel")
        if sticky and sticky.get("max_batch"):
            cap = max(1, min(cap, int(sticky["max_batch"])))
        self._max_batch_cap = cap
        self._warming = False
        # One batch's rows, packed: per shard [bucket, K] columns and value
        # bits, then the offsets' bits, then each random effect's cache
        # slots; pinned on CUDA so the one copy a batch is a DMA. Sized for
        # max_batch (every bucket is a prefix).
        k = int(config.max_row_nnz)
        words = _align(int(config.max_batch) * k) * 2 * len(
            self._shards_used) + _align(int(config.max_batch)) * (
                1 + len(self.re_parts))
        self._host = torch.empty(words, dtype=torch.int32,
                                 pin_memory=self.device.type == "cuda")
        # Host-to-device copies of batch assembly (one a scored chunk; the
        # cache slots ride in it, so a gather copies nothing).
        self.h2d_copies = 0

    # -------------------------------------------------------------- parsing

    def parse_request(self, payload: dict) -> ParsedRow:
        """JSON request → index-resolved row.

        Feature lists live under the shard's feature-bag keys (the record
        fields the training data used); entity ids under ``entities`` (or a
        top-level field named like the RE type, as the reader's metadataMap
        fallback). Unindexed features drop, as in the reader; unknown
        entities keep the row and fall back to fixed-effect-only.
        """
        if not isinstance(payload, dict):
            raise RequestError("request body must be a JSON object")
        k_cap = self.config.max_row_nnz
        shard_idx, shard_val = {}, {}
        for shard in self._shards_used:
            imap = self.index_maps[shard]
            cfg = self.shard_configs[shard]
            dim = len(imap)
            idxs, vals = [], []
            icpt = self._intercepts.get(shard)
            if icpt is not None:
                idxs.append(icpt)
                vals.append(1.0)
            for bag in cfg.feature_bags:
                feats = payload.get(bag)
                if feats is None:
                    continue
                if not isinstance(feats, (list, tuple)):
                    raise RequestError(f"feature bag {bag!r} must be a list")
                for feat in feats:
                    try:
                        i = imap.get_index(feat["name"], feat.get("term"))
                        v = float(feat["value"])
                    except (TypeError, KeyError, ValueError) as e:
                        raise RequestError(
                            f"bad feature entry in bag {bag!r}: {e}"
                        ) from None
                    if i >= 0:  # unindexed features dropped, as the reader
                        idxs.append(i)
                        vals.append(v)
            if len(idxs) > k_cap:
                raise RequestError(
                    f"row has {len(idxs)} features in shard {shard!r}; "
                    f"serving caps rows at max_row_nnz={k_cap} "
                    "(raise the knob, don't truncate)"
                )
            row_i = np.full(k_cap, dim, np.int32)
            row_v = np.zeros(k_cap, np.float32)
            row_i[: len(idxs)] = idxs
            row_v[: len(vals)] = vals
            shard_idx[shard] = row_i
            shard_val[shard] = row_v

        entities = payload.get("entities") or {}
        if not isinstance(entities, dict):
            raise RequestError('"entities" must be a map of RE type -> id')
        entity_keys = {}
        for cid, re_type in self._re_types.items():
            key = entities.get(re_type)
            if key is None:
                key = payload.get(re_type)  # top-level fallback, as reader
            entity_keys[cid] = None if key is None else str(key)
        try:
            offset = float(payload.get("offset") or 0.0)
        except (TypeError, ValueError):
            raise RequestError("offset must be a number") from None
        return ParsedRow(
            shard_idx=shard_idx,
            shard_val=shard_val,
            offset=offset,
            entity_keys=entity_keys,
        )

    # -------------------------------------------------------------- scoring

    def _bucket(self, n: int) -> int:
        return min(_next_pow2(n), self._max_batch_cap)

    def score_rows(self, rows: Sequence[ParsedRow]) -> np.ndarray:
        """Scores for up to ``max_batch`` rows as ONE padded program call;
        longer sequences score in max_batch-sized chunks."""
        return self.score_rows_flagged(rows)[0]

    def arm_swap_clock(self, t0: Optional[float] = None) -> None:
        """Start the hot-swap→first-score clock (the registry arms it when
        this scorer's version is published). The first served batch after
        arming stamps ``swap_to_first_score_seconds``."""
        import time as _time

        self._swap_armed_t0 = _time.monotonic() if t0 is None else t0

    def _note_swap_first_score(self) -> None:
        # dict.pop is atomic under the GIL: exactly one serving thread
        # claims the armed clock, the rest see a no-op.
        t0 = self.__dict__.pop("_swap_armed_t0", None)
        if t0 is None:
            return
        import time as _time

        from photon_tpu_torch.obs import instant
        from photon_tpu_torch.obs.metrics import REGISTRY

        seconds = _time.monotonic() - t0
        REGISTRY.gauge(
            "swap_to_first_score_seconds",
            "seconds from a registry hot-swap publishing a version to its "
            "first completed scored batch",
        ).set(round(seconds, 4))
        instant("recovery.swap_first_score", cat="recovery",
                seconds=round(seconds, 4))

    def score_rows_flagged(
        self, rows: Sequence[ParsedRow],
        stage_sink: Optional[dict] = None,
    ) -> tuple[np.ndarray, list]:
        """``(scores, flags)``: ``flags[i]`` is the tuple of RE coordinate
        ids whose contribution row ``i`` lost to an open coefficient-store
        circuit breaker (fixed-effect-only degradation); empty for fully
        scored rows.

        ``stage_sink``, when given, accumulates the per-stage latency
        waterfall in seconds (``batch_assembly`` / ``store_resolve`` /
        ``kernel``) across every chunk, downshift retries included.

        An ``oom``-classified kernel failure is absorbed by the bounded
        max-batch downshift (``_absorb_kernel_oom``): the failed chunk and
        the ones after it re-score at the smaller cap; completed chunks are
        kept."""
        out, flags = [], []
        lo = 0
        while lo < len(rows):
            chunk = rows[lo: lo + self._max_batch_cap]
            try:
                s, f = self._score_chunk(chunk, stage_sink)
            except Exception as e:  # noqa: BLE001 - classified below
                if not self._absorb_kernel_oom(e):
                    raise
                continue  # retry THIS chunk's rows at the smaller cap
            out.append(s)
            flags.extend(f)
            lo += len(chunk)
        if rows:
            self._note_swap_first_score()
        return (
            np.concatenate(out) if out else np.zeros(0, np.float32),
            flags,
        )

    def _absorb_kernel_oom(self, err) -> bool:
        """May the scoring path retry ``err`` at a halved micro-batch?

        The kernel breaker counts every OOM as a failure, and an open
        breaker refuses the downshift; otherwise the cap halves to the
        next-smaller warmed power-of-two bucket (floor 1 row). Bounded by
        ``PHOTON_OOM_MAX_DOWNSHIFTS``; each downshift is journaled, counted
        (``runtime/memory_guard``) and sticky for the run."""
        from photon_tpu_torch.runtime import memory_guard as _mg

        if not _mg.is_oom(err):
            return False
        if self.kernel_breaker is not None:
            self.kernel_breaker.record_failure()
            if not self.kernel_breaker.allow():
                _mg.journal_event(
                    "oom_exhausted", site="serving.kernel", cause="oom",
                    plan=f"max_batch={self._max_batch_cap}",
                    reason="kernel breaker open")
                return False
        cap = self._max_batch_cap
        half = cap // 2
        if half < 1:
            _mg.journal_event(
                "oom_exhausted", site="serving.kernel", cause="oom",
                plan="max_batch=1", reason="no smaller batch shape")
            return False
        new_cap = 1 << (half.bit_length() - 1)  # largest warmed pow2 <= half
        if not _mg.downshifter("serving.kernel").absorb(
                err, before=f"max_batch={cap}",
                after=f"max_batch={new_cap}"):
            return False
        self._max_batch_cap = new_cap
        # Process-sticky: the next hot-swap's scorer starts here too.
        _mg.set_sticky_plan("serving.kernel", {"max_batch": new_cap})
        return True

    def _assemble(self, rows: Sequence[ParsedRow], bp: int,
                  slots: Mapping[str, np.ndarray]) -> tuple:
        """The batch's ``[bp, K]`` arrays, offsets and cache slots, packed
        into the host buffer and copied to the device in one copy:
        ``(shard_idx, shard_val, offsets, slots)`` as device views of that
        copy."""
        k = self.config.max_row_nnz
        host = self._host.numpy()
        plane = _align(bp * k)
        spans, o = [], 0
        for shard in self._shards_used:
            dim = len(self.index_maps[shard])
            mi = host[o: o + bp * k].reshape(bp, k)
            mv = host[o + plane: o + plane + bp * k].view(np.float32).reshape(bp, k)
            mi[len(rows):] = dim
            mv[len(rows):] = 0.0
            for r, row in enumerate(rows):
                mi[r] = row.shard_idx[shard]
                mv[r] = row.shard_val[shard]
            spans.append((shard, o, o + plane))
            o += 2 * plane
        offs = host[o: o + bp].view(np.float32)
        offs[:] = 0.0
        for r, row in enumerate(rows):
            offs[r] = row.offset
        at = {}
        for i, (cid, _) in enumerate(self.re_parts):
            at[cid] = o + _align(bp) * (1 + i)
            host[at[cid]: at[cid] + bp] = slots[cid]
        used = o + _align(bp) * (1 + len(self.re_parts))
        dev = self._host[:used].to(self.device, copy=True)
        self.h2d_copies += 1
        shard_idx = {s: dev[a: a + bp * k].view(bp, k) for s, a, _ in spans}
        shard_val = {s: dev[b: b + bp * k].view(torch.float32).view(bp, k)
                     for s, _, b in spans}
        return (shard_idx, shard_val, dev[o: o + bp].view(torch.float32),
                {cid: dev[a: a + bp] for cid, a in at.items()})

    def _score_chunk(
        self, rows: Sequence[ParsedRow],
        stage_sink: Optional[dict] = None,
    ) -> tuple[np.ndarray, list]:
        b = len(rows)
        bp = self._bucket(b)
        # The slots are resolved first (staging the misses) so that they
        # reach the device in the batch's one copy.
        resolve_seconds = 0.0
        slots = {}
        degraded_rows: list[list[str]] = [[] for _ in range(b)]
        for cid, _ in self.re_parts:
            cache = self._caches[cid]
            keys = [row.entity_keys[cid] for row in rows]
            keys += [None] * (bp - b)  # pad rows → fallback zero row
            with trace_span("serve.store_resolve", cat="serving",
                            coordinate=cid, keys=b) as resolve_span:
                slots[cid], degraded = cache.resolve(keys)
            resolve_seconds += resolve_span.seconds
            if degraded.any():
                for r in np.flatnonzero(degraded[:b]):
                    degraded_rows[int(r)].append(cid)
        with trace_span("serve.batch_assembly", cat="serving",
                        rows=b) as assembly_span:
            shard_idx, shard_val, offsets, dev_slots = self._assemble(
                rows, bp, slots)
        re_proj, re_coef = {}, {}
        for cid, _ in self.re_parts:
            re_proj[cid], re_coef[cid] = self._caches[cid].gather(dev_slots[cid])

        def run_kernel() -> np.ndarray:
            # Chaos hook: error="device_lost" exercises the breaker-gated
            # recovery below without a real device loss. Quiet during
            # warmup so a plan's `after` counts only served batches.
            if not self._warming:
                fault_point("serving.kernel", rows=b, bucket=bp)
            scores = additive_score_rows(
                offsets, shard_idx, shard_val, self._fixed_ws, re_proj,
                re_coef, fixed_parts=self.fixed_parts,
                re_parts=self.re_parts)
            # The device-to-host copy is the sync point; inside the span so
            # it reports completed compute, not the launch.
            return scores.cpu().numpy()

        with trace_span("serve.kernel", cat="serving", rows=b,
                        bucket=bp) as kernel_span:
            try:
                host_scores = run_kernel()
                if self.kernel_breaker is not None:
                    self.kernel_breaker.record_success()
            except Exception as e:  # noqa: BLE001 - classified below
                host_scores = self._recover_kernel(e, run_kernel)
        if stage_sink is not None:
            # Accumulate (not assign): a downshift retry re-runs the chunk
            # and the waterfall must price both passes.
            for stage, sec in (("batch_assembly", assembly_span.seconds),
                               ("store_resolve", resolve_seconds),
                               ("kernel", kernel_span.seconds)):
                stage_sink[stage] = stage_sink.get(stage, 0.0) + sec
        return host_scores[:b], [tuple(d) for d in degraded_rows]

    def _recover_kernel(self, err: Exception, run_kernel) -> np.ndarray:
        """Kernel device-loss recovery, bounded by the kernel breaker:
        release the device caches and re-run the batch ONCE. Only a
        classified device loss is recoverable this way, and only while the
        CUDA context still answers (``backend_guard.context_usable``): a
        poisoned context stays poisoned for the life of the process, so it
        is not retried — the breaker opens, the batch fast-fails and
        ``/healthz`` reports the kernel breaker (the process must be
        restarted). Once open, recovery is short-circuited until the
        cooldown's probe."""
        from photon_tpu_torch.obs.metrics import REGISTRY
        from photon_tpu_torch.runtime.backend_guard import (
            DeviceContextLost,
            classify_backend_error,
            context_usable,
            is_device_lost,
        )

        cause = classify_backend_error(err)
        REGISTRY.counter(
            "serve_kernel_errors_total",
            "scoring-kernel failures by classified cause",
        ).inc(cause=cause)
        if self.kernel_breaker is None or not is_device_lost(err):
            raise err
        self.kernel_breaker.record_failure()
        if not self.kernel_breaker.allow():
            raise err
        from photon_tpu_torch.obs import instant
        from photon_tpu_torch.supervisor import clear_executable_caches

        instant("recovery.kernel_reinit", cat="recovery", cause=cause,
                error=f"{type(err).__name__}: {str(err)[:200]}")
        clear_executable_caches(f"serving kernel recovery [{cause}]")
        if not context_usable():
            while self.kernel_breaker.state != "open":
                self.kernel_breaker.record_failure()
            raise DeviceContextLost(
                "CUDA context unusable after a device loss in the scoring "
                "program; restart the serving process") from err
        try:
            host_scores = run_kernel()
        except Exception:
            self.kernel_breaker.record_failure()
            raise
        self.kernel_breaker.record_success()
        REGISTRY.counter(
            "serve_kernel_recoveries_total",
            "scoring batches recovered by kernel re-initialization",
        ).inc(cause=cause)
        # The cache release dropped the allocator's blocks: warm the ladder
        # again so no request pays for them.
        self.warmup()
        return host_scores

    def warmup(self) -> int:
        """Score every row-bucket shape once (empty rows, fallback
        entities), so that no request pays for the kernel library's load or
        the allocator's first blocks. Returns the number of buckets
        warmed."""
        dummy = ParsedRow(
            shard_idx={
                s: np.full(
                    self.config.max_row_nnz,
                    len(self.index_maps[s]),
                    np.int32,
                )
                for s in self._shards_used
            },
            shard_val={
                s: np.zeros(self.config.max_row_nnz, np.float32)
                for s in self._shards_used
            },
            offset=0.0,
            entity_keys={cid: None for cid, _ in self.re_parts},
        )
        sizes, b = [], 1
        # The ladder tops out at the EFFECTIVE cap: under a sticky OOM
        # downshift the buckets above it are unreachable.
        while b < self._max_batch_cap:
            sizes.append(b)
            b <<= 1
        sizes.append(self._max_batch_cap)  # reachable even when not pow2
        self._warming = True
        try:
            for size in sizes:
                self._score_chunk([dummy] * size)
        finally:
            self._warming = False
        return len(sizes)

    def validate_delta(self, coordinate: str, patches) -> None:
        """Validate one coordinate's entity patches WITHOUT applying:
        coordinate exists, every patch fits the device-cache row width,
        and the store accepts the column layout. The registry calls this
        for EVERY coordinate before the first apply."""
        cache = self._caches.get(coordinate)
        if cache is None:
            raise ValueError(
                f"unknown random-effect coordinate {coordinate!r}; "
                f"patchable: {sorted(self._caches)}"
            )
        for key, (cols, _vals) in patches.items():
            if len(cols) > cache.width:
                raise ValueError(
                    f"patch for {coordinate!r}/{key!r} has {len(cols)} "
                    f"coefficients but the device cache width is "
                    f"{cache.width}; widen the serving config or shrink "
                    "the online subspace (max_event_nnz x window bounds it)"
                )
        cache.store.validate_patches(patches)

    def apply_delta(self, coordinate: str, patches) -> dict:
        """Apply one coordinate's entity patches: validate (a delta applies
        whole or not at all), overlay the store in one reference swap, then
        invalidate exactly the patched entities in the device hot-set.
        ``patches`` maps entity key → ``(cols, vals)``."""
        self.validate_delta(coordinate, patches)
        cache = self._caches[coordinate]
        patched = cache.store.apply_patches(patches)
        invalidated = cache.invalidate(list(patches))
        return {"patched": patched, "invalidated": invalidated}

    def cache_snapshot(self) -> dict:
        return {cid: c.snapshot() for cid, c in self._caches.items()}

    def breaker_snapshot(self) -> dict:
        """Per-RE-coordinate store breakers + the kernel breaker (for
        /metrics and /healthz). The kernel breaker rides under the reserved
        ``__kernel__`` key."""
        out = {
            cid: c.breaker.snapshot()
            for cid, c in self._caches.items()
            if c.breaker is not None
        }
        if self.kernel_breaker is not None:
            out["__kernel__"] = self.kernel_breaker.snapshot()
        return out
