"""Memory-pressure resilience: the OOM degradation ladder and the device
memory watchdog.

Port of ``photon_tpu/runtime/memory_guard.py``. Restarting an attempt
with the same shapes re-runs out of memory; only a smaller plan helps:

* **Classified-OOM retry with downshift.** When a solve raises an
  ``oom``-classified error (``torch.cuda.OutOfMemoryError``, a cuBLAS /
  cuSOLVER allocation failure, the kernels' ``out of memory`` launch error,
  an injected ``DeviceOomError``), the failing site retries at the next
  cheaper plan: a random-effect bucket drops one blessed chunk tier, then
  falls to the vmapped lanes (``game/random_effect.py``); the out-of-core
  solver halves ``chunk_rows`` (``optim/out_of_core.py``). Each downshift
  is bounded per site (``PHOTON_OOM_MAX_DOWNSHIFTS``, default 3),
  journaled as an ``oom_downshift`` row with the plan before and after,
  counted in ``oom_downshifts_total{site,cause}``, and sticky for the rest
  of the run. The sites leave their ``except`` block before they retry, so
  the failed attempt's tensors (held by the exception's traceback) are
  freed first.
* **Device-memory watchdog.** :class:`MemoryGuard` samples the card
  (``torch.cuda.mem_get_info`` and the caching allocator's
  ``memory_stats``), exports the ``device_memory_{bytes_in_use,bytes_limit,
  watermark}`` gauges, asks the sweep caches to shed pins above the
  high-water fraction, and :func:`effective_sweep_budget` clamps the sweep
  cache's budget to the live device limit.
* **Supervisor policy.** An OOM-caused restart is attempted at most once,
  pre-degraded (:func:`pre_degrade_for_restart`), with no backoff sleep.

On the CPU, or before the process has a CUDA context, the watchdog reports
nothing and sheds nothing, while the classified-OOM ladder still works:
which is what makes the ladder testable on the CPU with the injected
``device_oom`` fault.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional

from photon_tpu_torch.obs import instant
from photon_tpu_torch.obs.metrics import REGISTRY

__all__ = [
    "MemoryGuard",
    "OomDownshifter",
    "downshifter",
    "effective_sweep_budget",
    "guard",
    "is_oom",
    "journal_event",
    "max_oom_downshifts",
    "pre_degrade_for_restart",
    "reset_state",
    "set_journal",
    "set_sticky_plan",
    "sticky_plan",
]

logger = logging.getLogger("photon_tpu_torch.memory_guard")

_OOM_DOWNSHIFTS = REGISTRY.counter(
    "oom_downshifts_total",
    "OOM-classified failures absorbed by downshifting to a cheaper plan, "
    "by site",
)
_PRESSURE_SPILLS = REGISTRY.counter(
    "memory_pressure_spills_total",
    "proactive sweep-cache spills triggered by the device-memory watchdog",
)
_MEM_IN_USE = REGISTRY.gauge(
    "device_memory_bytes_in_use",
    "bytes the caching allocator holds on the card",
)
_MEM_LIMIT = REGISTRY.gauge(
    "device_memory_bytes_limit",
    "the most the caching allocator could hold: its own bytes plus the "
    "card's free bytes, under the per-process fraction when one is set",
)
_MEM_WATERMARK = REGISTRY.gauge(
    "device_memory_watermark",
    "bytes_in_use / bytes_limit (0 without a CUDA context)",
)


def max_oom_downshifts(default: int = 3) -> int:
    """Per-site bound on OOM downshifts (``PHOTON_OOM_MAX_DOWNSHIFTS``);
    past it the original error escalates (journaled exhaustion)."""
    try:
        return max(0, int(os.environ.get(
            "PHOTON_OOM_MAX_DOWNSHIFTS", default)))
    except (TypeError, ValueError):
        return int(default)


def is_oom(err) -> bool:
    """Is this failure the one cause the downshift ladder may absorb?"""
    from photon_tpu_torch.runtime.backend_guard import (
        CAUSE_OOM,
        classify_backend_error,
    )

    return classify_backend_error(err) == CAUSE_OOM


# ------------------------------------------------------------ journal hook
#
# Downshifts happen deep inside solves, far from the RunSupervisor that
# owns the recovery journal; the supervisor registers its journal here for
# the run, so in-run OOM events land as journal rows beside the restarts.

_journal_lock = threading.Lock()
_JOURNAL = None


def set_journal(journal):
    """Register the active journal (anything with
    ``record(event, **fields)``; None detaches). Returns the journal
    registered before, so a scoped caller can restore it."""
    global _JOURNAL
    with _journal_lock:
        prev = _JOURNAL
        _JOURNAL = journal
        return prev


def journal_event(event: str, **fields) -> None:
    """One recovery event: a journal row when a journal is registered (the
    journal mirrors it as a trace instant), else the ``recovery.<event>``
    instant alone."""
    with _journal_lock:
        j = _JOURNAL
    if j is not None:
        try:
            j.record(event, **fields)
            return
        except Exception:  # noqa: BLE001 - evidence, never a failure mode
            pass
    instant(f"recovery.{event}", cat="recovery", **fields)


# ------------------------------------------------------------ sticky plans
#
# A downshift is sticky for the rest of the run: the OOM proved the bigger
# plan does not fit, and going back up would run out of memory again on
# the next sweep. Re-promotion happens only in a fresh process.

_sticky_lock = threading.Lock()
_STICKY: dict = {}


def sticky_plan(site: str) -> Optional[dict]:
    """The sticky degraded plan of ``site`` (``{"chunk": 1024}`` for
    ``re.solve``), or None when the site runs at its full plan."""
    with _sticky_lock:
        p = _STICKY.get(site)
        return dict(p) if p is not None else None


def set_sticky_plan(site: str, plan: dict) -> None:
    with _sticky_lock:
        _STICKY[site] = dict(plan)


class OomDownshifter:
    """Bounded absorber of OOM-classified failures at one site.

    ``absorb(err, before=..., after=...)`` returns True when the caller may
    retry at the cheaper plan (journaled and counted); False once the
    site's bound is spent (the exhaustion is journaled and the caller
    re-raises). Thread-safe."""

    def __init__(self, site: str):
        self.site = site
        self.count = 0
        self._lock = threading.Lock()

    def absorb(self, err, before=None, after=None, **ctx) -> bool:
        from photon_tpu_torch.runtime.backend_guard import classify_backend_error

        cause = classify_backend_error(err)
        with self._lock:
            if self.count >= max_oom_downshifts():
                journal_event(
                    "oom_exhausted", site=self.site, cause=cause,
                    downshifts=self.count,
                    error=f"{type(err).__name__}: {str(err)[:200]}", **ctx)
                logger.error(
                    "OOM at %s with the downshift budget spent (%d/%d) — "
                    "escalating: %s", self.site, self.count,
                    max_oom_downshifts(), err)
                return False
            self.count += 1
            n = self.count
        _OOM_DOWNSHIFTS.inc(site=self.site, cause=cause)
        journal_event(
            "oom_downshift", site=self.site, cause=cause, downshift=n,
            before=before, after=after,
            error=f"{type(err).__name__}: {str(err)[:200]}", **ctx)
        logger.warning(
            "OOM at %s (%s: %s) — downshifting %s -> %s (%d/%d; sticky for "
            "this run)", self.site, type(err).__name__, str(err)[:200],
            before, after, n, max_oom_downshifts())
        return True


_shifter_lock = threading.Lock()
_SHIFTERS: dict = {}


def downshifter(site: str) -> OomDownshifter:
    """The process-global downshifter of ``site`` (its bound is per run,
    shared by every solve at the site)."""
    with _shifter_lock:
        s = _SHIFTERS.get(site)
        if s is None:
            s = _SHIFTERS[site] = OomDownshifter(site)
        return s


# --------------------------------------------------------- memory watchdog


def _default_stats() -> Optional[dict]:
    """The card's memory as the caching allocator sees it, or None without
    a CUDA context (this never creates one):

    * ``bytes_in_use``: the allocator's reserved bytes;
    * ``bytes_limit``: its reserved bytes plus the card's free bytes, under
      ``torch.cuda.set_per_process_memory_fraction`` when one is set;
    * ``watermark``: their ratio; plus ``bytes_allocated`` (live tensors),
      ``device_free`` and ``device_total``."""
    try:
        import torch

        if not torch.cuda.is_initialized():
            return None
        free, total = torch.cuda.mem_get_info()
        stats = torch.cuda.memory_stats()
        reserved = float(stats.get("reserved_bytes.all.current", 0.0))
        limit = reserved + float(free)
        get_frac = getattr(torch.cuda, "get_per_process_memory_fraction", None)
        if get_frac is not None:
            limit = min(limit, float(get_frac()) * float(total))
        if limit <= 0:
            return None
        return {"bytes_in_use": reserved, "bytes_limit": limit,
                "watermark": reserved / limit,
                "bytes_allocated": float(
                    stats.get("allocated_bytes.all.current", 0.0)),
                "device_free": float(free), "device_total": float(total)}
    except Exception:  # noqa: BLE001 - a sick device must not break callers
        return None


def _env_fraction(name: str, default: float) -> float:
    try:
        v = float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default
    return v if 0.0 < v <= 1.0 else default


class MemoryGuard:
    """Device-memory watchdog: sample, export, spill.

    One instance per process (:func:`guard`). ``stats_fn`` is the test
    seam: a fake returning any watermark runs the spill path on the CPU.
    Samples are throttled (``min_sample_interval_s``).

    Thresholds (fractions of ``bytes_limit``): ``high_water``
    (``PHOTON_MEM_HIGH_WATER``, default 0.85), above which :meth:`check`
    sheds sweep-cache pins; ``critical`` (``PHOTON_MEM_CRITICAL``, default
    0.95), the serving slice's shedding line.
    """

    def __init__(
        self,
        high_water: Optional[float] = None,
        critical: Optional[float] = None,
        stats_fn: Optional[Callable[[], Optional[dict]]] = None,
        min_sample_interval_s: float = 0.5,
    ):
        self.high_water = (
            _env_fraction("PHOTON_MEM_HIGH_WATER", 0.85)
            if high_water is None else float(high_water))
        self.critical = (
            _env_fraction("PHOTON_MEM_CRITICAL", 0.95)
            if critical is None else float(critical))
        self.stats_fn = stats_fn if stats_fn is not None else _default_stats
        self.min_sample_interval_s = float(min_sample_interval_s)
        self._lock = threading.Lock()
        self._last_sample: Optional[dict] = None
        self._last_sample_t = float("-inf")
        self._spills = 0

    def sample(self, force: bool = False) -> Optional[dict]:
        """The latest stats (throttled; ``force`` bypasses the throttle),
        or None without them. Sets the ``device_memory_*`` gauges."""
        now = time.monotonic()
        with self._lock:
            if (not force
                    and now - self._last_sample_t
                    < self.min_sample_interval_s):
                return self._last_sample
        s = self.stats_fn()
        with self._lock:
            self._last_sample = s
            self._last_sample_t = now
        if s is not None:
            _MEM_IN_USE.set(s["bytes_in_use"])
            _MEM_LIMIT.set(s["bytes_limit"])
            _MEM_WATERMARK.set(round(s["watermark"], 4))
        else:
            _MEM_WATERMARK.set(0.0)
        return s

    def watermark(self) -> Optional[float]:
        s = self.sample()
        return None if s is None else s["watermark"]

    def under_pressure(self) -> bool:
        """Watermark at or above high water."""
        w = self.watermark()
        return w is not None and w >= self.high_water

    def check(self) -> dict:
        """One watchdog pass: a fresh sample and, above high water, sweep
        cache pins shed down to the line. Returns ``{available, watermark,
        spilled_bytes}``."""
        s = self.sample(force=True)
        if s is None:
            return {"available": False, "watermark": None,
                    "spilled_bytes": 0}
        freed = 0
        if s["watermark"] >= self.high_water:
            # The sweep cache's contents are expendable by contract (a shed
            # entry is copied again on its next use): it is the valve.
            target = int(s["bytes_in_use"]
                         - self.high_water * s["bytes_limit"])
            from photon_tpu_torch.data.device_cache import shed_pins

            freed = shed_pins(max(0, target))
            if freed:
                self._spills += 1
                _PRESSURE_SPILLS.inc()
                instant("memory.pressure_spill", cat="recovery",
                        watermark=round(s["watermark"], 4),
                        freed_bytes=int(freed))
                logger.warning(
                    "device memory watermark %.2f >= high water %.2f — "
                    "shed %d sweep-cache bytes (the next pass copies them "
                    "again)", s["watermark"], self.high_water, freed)
        return {"available": True,
                "watermark": round(s["watermark"], 4),
                "spilled_bytes": int(freed)}

    def snapshot(self) -> dict:
        s = self._last_sample
        return {
            "high_water": self.high_water,
            "critical": self.critical,
            "watermark": None if s is None else round(s["watermark"], 4),
            "spills": self._spills,
        }


_guard_lock = threading.Lock()
_GUARD: Optional[MemoryGuard] = None


def guard() -> MemoryGuard:
    """The process-global :class:`MemoryGuard` (made on first use)."""
    global _GUARD
    with _guard_lock:
        if _GUARD is None:
            _GUARD = MemoryGuard()
        return _GUARD


# ----------------------------------------------- sweep-cache budget policy

_budget_lock = threading.Lock()
_BUDGET_SCALE = 1.0
_clamp_warned = False


def sweep_budget_scale() -> float:
    """Run-wide multiplier on sweep-cache budgets (halved by each
    :func:`pre_degrade_for_restart`)."""
    with _budget_lock:
        return _BUDGET_SCALE


def effective_sweep_budget(requested_bytes: int) -> int:
    """The budget a ``DeviceSweepCache`` actually gets:

    * scaled by the run's degradation multiplier (an OOM-pre-degraded
      restart must not pin the budget that ended the attempt);
    * clamped to ``PHOTON_SWEEP_CACHE_DEVICE_FRACTION`` (default 0.5) of
      the live ``bytes_limit`` when there is a CUDA context: a budget the
      card cannot hold is an OOM schedule, not a cache. One warning when
      the clamp fires; without a context the requested budget stands.
    """
    global _clamp_warned
    b = int(requested_bytes * sweep_budget_scale())
    if b <= 0:
        return 0
    s = guard().sample()
    if s is None or s["bytes_limit"] <= 0:
        return b
    frac = _env_fraction("PHOTON_SWEEP_CACHE_DEVICE_FRACTION", 0.5)
    cap = int(s["bytes_limit"] * frac)
    if b > cap:
        with _budget_lock:
            warn = not _clamp_warned
            _clamp_warned = True
        if warn:
            logger.warning(
                "sweep-cache budget %d bytes exceeds %.0f%% of the live "
                "device limit (%d bytes) — clamping to %d. Set "
                "PHOTON_SWEEP_CACHE_MB (or PHOTON_SWEEP_CACHE_DEVICE_"
                "FRACTION) to size the cache to this card.",
                b, 100.0 * frac, int(s["bytes_limit"]), cap)
        return cap
    return b


def pre_degrade_for_restart(reason: str = "supervised OOM restart") -> dict:
    """Shrink the NEXT attempt's memory plan after an OOM-caused attempt
    failure: halve the sweep-cache budget scale and cap the random-effect
    chunk ladder one blessed tier below its current cap
    (``game/newton_re.chunk_ladder``). Journaled. Returns the plan."""
    global _BUDGET_SCALE
    with _budget_lock:
        _BUDGET_SCALE *= 0.5
        scale = _BUDGET_SCALE
    from photon_tpu_torch.game.newton_re import chunk_ladder

    ladder = chunk_ladder()
    cur = sticky_plan("re.solve") or {}
    eff = cur.get("chunk") or ladder[-1] + 1
    smaller = [c for c in ladder if c < eff]
    new_chunk = max(smaller) if smaller else ladder[0]
    set_sticky_plan("re.solve", {**cur, "chunk": new_chunk})
    plan = {
        "sweep_cache_budget_scale": scale,
        "re_chunk_cap": new_chunk,
        "reason": reason,
    }
    journal_event("oom_predegrade", **plan)
    logger.warning(
        "pre-degrading the next attempt after OOM: sweep-cache budget "
        "scale %.3f, RE chunk cap %d (%s)", scale, new_chunk, reason)
    return plan


def reset_state() -> None:
    """Forget sticky plans, downshift counts, the budget scale, the journal
    hook and the guard singleton (tests, and a phase that must start at
    full plan)."""
    global _GUARD, _BUDGET_SCALE, _clamp_warned
    with _sticky_lock:
        _STICKY.clear()
    with _shifter_lock:
        _SHIFTERS.clear()
    with _budget_lock:
        _BUDGET_SCALE = 1.0
        _clamp_warned = False
    with _guard_lock:
        _GUARD = None
    set_journal(None)
