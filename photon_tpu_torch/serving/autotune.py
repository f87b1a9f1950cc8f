"""Histogram-autotuned micro-batching (a copy of the JAX package's
``serving/autotune.py``; it imports neither JAX nor torch).

The micro-batcher's two knobs — ``max_batch`` (coalescing cap) and
``max_wait_ms`` (coalescing deadline) — are chosen **continuously from
live telemetry**: every tick the tuner diffs the
``serve_stage_latency_seconds`` labeled-child states (the stage
waterfall, the same mergeable histogram state the fleet aggregator
consumes) and the batcher's own fill counters, then nudges the knobs
along the scorer's WARMED power-of-two bucket ladder. Staying on the
ladder is load-bearing: every shape the autotuner can choose was run by
``warmup()``.

Damping follows the control plane's autoscaler (``control/policy.py`` in
the JAX package):

* **hysteresis bands** — scale up only above ``queue_high`` occupancy,
  down only below ``queue_low``; between the bands the tuner holds;
* **min_run** — a direction must persist for N consecutive ticks before
  it acts (one bursty tick is noise, not a regime);
* **per-lever cooldown shared by both directions** — after an action the
  lever freezes, so an up/down flap inside the cooldown is impossible by
  construction.

The tuner reports its current choice and reasoning via :meth:`snapshot`,
which ``/admin/tune`` exposes (the control plane keeps one actuation
surface).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

from photon_tpu_torch.utils.logging import LatencyHistogram


def _delta_hist(prev: Optional[dict], cur: dict) -> LatencyHistogram:
    """Histogram of ONLY the samples observed since ``prev`` (bin-wise
    state subtraction — exact, same contract the fleet merger relies on)."""
    if prev is None or len(prev["counts"]) != len(cur["counts"]):
        return LatencyHistogram.from_state(cur)
    return LatencyHistogram.from_state({
        "lo_ms": cur["lo_ms"],
        "bins_per_decade": cur.get("bins_per_decade", 20),
        "counts": [max(0, c - p) for c, p in
                   zip(cur["counts"], prev["counts"])],
        "sum": max(0.0, cur["sum"] - prev["sum"]),
        "max": cur["max"],
        "n": max(0, cur["n"] - prev["n"]),
    })


def _pow2_ladder(top: int) -> list[int]:
    """The warmed bucket ladder: powers of two below ``top``, plus ``top``
    itself (warmup() compiles exactly this set)."""
    sizes, b = [], 1
    while b < top:
        sizes.append(b)
        b <<= 1
    sizes.append(int(top))
    return sizes


class BatchAutotuner:
    """Drives ``MicroBatcher.reconfigure`` from live stage-latency state.

    ``ladder_max`` is the scorer's warmed batch cap (``ServingConfig
    .max_batch``); ``cap_fn`` optionally reports the scorer's CURRENT
    effective cap (the OOM downshift ladder may have lowered it) so the
    tuner never proposes an unreachable shape.
    """

    def __init__(
        self,
        batcher,
        stage_hist,
        *,
        ladder_max: int,
        cap_fn: Optional[Callable[[], int]] = None,
        tick_s: float = 1.0,
        min_run: int = 3,
        cooldown_s: float = 10.0,
        queue_high: float = 0.5,
        queue_low: float = 0.05,
        knee_latency_ms: float = 50.0,
        wait_bounds_ms: tuple = (0.25, 8.0),
        min_samples: int = 16,
        logger=None,
    ):
        self.batcher = batcher
        self.stage_hist = stage_hist
        self.ladder_max = int(ladder_max)
        self.cap_fn = cap_fn
        self.tick_s = float(tick_s)
        self.min_run = int(min_run)
        self.cooldown_s = float(cooldown_s)
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.knee_latency_ms = float(knee_latency_ms)
        self.wait_bounds_ms = (float(wait_bounds_ms[0]),
                               float(wait_bounds_ms[1]))
        self.min_samples = int(min_samples)
        self.logger = logger
        self._prev_states: dict = {}
        self._prev_stats: dict = {}
        self._streak: dict = {"batch": 0, "wait": 0}
        self._cooldown_until: dict = {"batch": 0.0, "wait": 0.0}
        self._suppressed = {"cooldown": 0, "min_run": 0, "idle": 0}
        self._actions: deque = deque(maxlen=16)
        self._basis: dict = {}
        self._ticks = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        from photon_tpu_torch.obs.metrics import REGISTRY

        self._action_counter = REGISTRY.counter(
            "serve_autotune_actions_total",
            "autotuner knob movements by lever and direction",
        )
        self._choice_gauge = REGISTRY.gauge(
            "serve_autotune_choice",
            "autotuned micro-batcher knobs (lever -> current value)",
        )
        self._publish_choice()

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="photon-serve-autotune", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.tick_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - a sick tuner must not kill serving
                if self.logger is not None:
                    self.logger.exception("autotune tick failed")

    # ------------------------------------------------------------------ tick

    def _stage_delta(self, stage: str) -> LatencyHistogram:
        cur = self.stage_hist.child(stage=stage).state()
        d = _delta_hist(self._prev_states.get(stage), cur)
        self._prev_states[stage] = cur
        return d

    def tick(self, now: Optional[float] = None) -> Optional[dict]:
        """One observation + (maybe) one actuation. Returns the action
        applied this tick, or None. Synchronous and side-effect-complete:
        tests drive it directly with synthetic histogram states."""
        now = time.monotonic() if now is None else now
        with self._lock:
            return self._tick_locked(now)

    def _tick_locked(self, now: float) -> Optional[dict]:
        self._ticks += 1
        snap = self.batcher.snapshot()
        queue_frac = snap["queued"] / max(1, snap["max_queue"])
        d_batches = snap["batches"] - self._prev_stats.get("batches", 0)
        d_rows = snap["rows"] - self._prev_stats.get("rows", 0)
        self._prev_stats = {"batches": snap["batches"],
                            "rows": snap["rows"]}
        kernel = self._stage_delta("kernel")
        queue_wait = self._stage_delta("queue_wait")
        kernel_p95 = kernel.quantile_ms(0.95)
        kernel_p50 = kernel.quantile_ms(0.50)
        queue_p95 = queue_wait.quantile_ms(0.95)
        fill = (d_rows / d_batches / max(1, snap["max_batch"])
                if d_batches else 0.0)
        self._basis = {
            "queue_frac": round(queue_frac, 4),
            "kernel_p50_ms": round(kernel_p50, 3),
            "kernel_p95_ms": round(kernel_p95, 3),
            "queue_wait_p95_ms": round(queue_p95, 3),
            "batch_fill": round(fill, 3),
            "delta_rows": d_rows,
            "delta_samples": kernel._n,
        }
        if d_batches == 0 and queue_frac == 0.0:
            # Idle box: no evidence either way — hold everything. (An idle
            # tuner that shrank knobs would greet the next burst mistuned.)
            self._streak["batch"] = 0
            self._streak["wait"] = 0
            self._suppressed["idle"] += 1
            return None
        action = self._tune_batch(now, queue_frac, kernel_p95, fill, d_rows)
        if action is None:
            action = self._tune_wait(now, kernel, kernel_p50)
        return action

    # ---------------------------------------------------------------- levers

    def _ladder(self) -> list[int]:
        top = self.ladder_max
        if self.cap_fn is not None:
            try:
                top = max(1, min(top, int(self.cap_fn())))
            except Exception:  # noqa: BLE001 - cap probe must not stop tuning
                pass
        return _pow2_ladder(top)

    def _act(self, lever: str, direction: str, now: float,
             **changes) -> dict:
        cfg = self.batcher.reconfigure(**changes)
        self._cooldown_until[lever] = now + self.cooldown_s
        self._streak[lever] = 0
        self._action_counter.inc(lever=lever, direction=direction)
        action = {"lever": lever, "direction": direction, "at": time.time(),
                  "applied": changes, "basis": dict(self._basis)}
        self._actions.append(action)
        self._publish_choice()
        if self.logger is not None:
            self.logger.info(
                "autotune: %s %s -> %s  [%s]", lever, direction, changes,
                ", ".join(f"{k}={v}" for k, v in self._basis.items()))
        return {"config": cfg, **action}

    def _gate(self, lever: str, want: int, now: float) -> bool:
        """Hysteresis + cooldown shared by both directions (the
        autoscaler's discipline). ``want`` is -1/0/+1; returns True when the lever may
        act NOW."""
        if want == 0:
            self._streak[lever] = 0
            return False
        streak = self._streak[lever]
        streak = streak + want if (streak == 0 or (streak > 0) == (want > 0)) \
            else want
        self._streak[lever] = streak
        if abs(streak) < self.min_run:
            self._suppressed["min_run"] += 1
            return False
        if now < self._cooldown_until[lever]:
            self._suppressed["cooldown"] += 1
            return False
        return True

    def _tune_batch(self, now, queue_frac, kernel_p95, fill,
                    d_rows) -> Optional[dict]:
        ladder = self._ladder()
        cur = self.batcher.max_batch
        # Snap onto the ladder (an operator /admin/tune may have set an
        # off-ladder value): the largest warmed size <= cur.
        at = max(i for i, s in enumerate(ladder) if s <= cur) \
            if cur >= ladder[0] else 0
        want = 0
        if (queue_frac >= self.queue_high
                and kernel_p95 <= self.knee_latency_ms
                and at + 1 < len(ladder)):
            # Queue is backing up while the kernel still has headroom:
            # bigger batches drain more rows per dispatch.
            want = +1
        elif (queue_frac <= self.queue_low and fill > 0
                and fill <= 0.25 and at > 0 and d_rows > 0):
            # Mostly-empty batches at a quiet queue: a smaller cap wastes
            # less padded compute per dispatch.
            want = -1
        if not self._gate("batch", want, now):
            return None
        new = ladder[at + want]
        if new == cur:
            return None
        return self._act("batch", "up" if want > 0 else "down", now,
                         max_batch=new)

    def _tune_wait(self, now, kernel: LatencyHistogram,
                   kernel_p50: float) -> Optional[dict]:
        if kernel._n < self.min_samples:
            self._streak["wait"] = 0
            return None
        # The coalescing deadline should cost about what one dispatch
        # costs: waiting much longer adds latency a bigger batch can't
        # repay; much shorter and concurrent rows miss the bus and pay a
        # whole extra kernel.
        lo, hi = self.wait_bounds_ms
        target = min(max(0.5 * kernel_p50, lo), hi)
        cur = self.batcher.max_wait_s * 1e3
        if cur <= 0:
            cur = lo
        ratio = target / cur
        want = +1 if ratio > 1.25 else (-1 if ratio < 0.8 else 0)
        if not self._gate("wait", want, now):
            return None
        return self._act("wait", "up" if want > 0 else "down", now,
                         max_wait_ms=round(target, 4))

    # ------------------------------------------------------------- reporting

    def _publish_choice(self) -> None:
        self._choice_gauge.set(float(self.batcher.max_batch),
                               lever="max_batch")
        self._choice_gauge.set(round(self.batcher.max_wait_s * 1e3, 4),
                               lever="max_wait_ms")

    def snapshot(self) -> dict:
        """Current choice + decision basis, reported via /admin/tune."""
        with self._lock:
            return {
                "enabled": True,
                "ticks": self._ticks,
                "current": {
                    "max_batch": self.batcher.max_batch,
                    "max_wait_ms": round(self.batcher.max_wait_s * 1e3, 4),
                },
                "ladder": self._ladder(),
                "basis": dict(self._basis),
                "suppressed": dict(self._suppressed),
                "actions": list(self._actions),
                "policy": {
                    "queue_high": self.queue_high,
                    "queue_low": self.queue_low,
                    "knee_latency_ms": self.knee_latency_ms,
                    "min_run": self.min_run,
                    "cooldown_s": self.cooldown_s,
                    "wait_bounds_ms": list(self.wait_bounds_ms),
                },
            }
