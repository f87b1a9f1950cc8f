"""Circuit breaker for the serving coefficient-store path
(docs/robustness.md §degradation ladder).

A copy of the JAX package's ``serving/circuit.py``: it imports neither JAX nor
torch, and ``tests/test_torch_frontline.py`` compares the code, so edit
both or neither.

A misbehaving coefficient store — IO errors from an mmap'd table on a sick
filesystem, or latency spikes that stall the batcher's single worker —
must not fail or stall scoring requests: GAME scoring degrades cleanly to
fixed-effect-only (the same zero-model fallback unseen entities already
take), which is a worse score but a correct one. The breaker makes that
degradation *deliberate and bounded* instead of per-call:

* CLOSED: calls flow; consecutive failures (and calls slower than
  ``slow_call_s``, if set) count toward ``failure_threshold``.
* OPEN: every call is short-circuited to the fallback for ``cooldown_s`` —
  a sick store is not hammered while it is sick, and scoring latency stays
  flat instead of absorbing per-request store timeouts.
* HALF_OPEN: after the cooldown one probe call is let through; success
  closes the breaker, failure re-opens it for another cooldown.

Thread-safe; the ``clock`` parameter exists for deterministic tests.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

__all__ = ["CircuitBreaker"]

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    def __init__(
        self,
        failure_threshold: int = 5,
        cooldown_s: float = 2.0,
        slow_call_s: Optional[float] = None,
        clock=time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}"
            )
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.slow_call_s = slow_call_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._open_until = 0.0
        self._probe_in_flight = False
        self.stats = {
            "successes": 0, "failures": 0, "slow_calls": 0,
            "opens": 0, "short_circuited": 0,
        }

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May the protected call proceed? ``False`` = degrade right now.
        In OPEN past the cooldown, admits exactly ONE probe (HALF_OPEN);
        the caller must follow up with ``record_success``/``record_failure``
        to resolve the probe."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN and self._clock() >= self._open_until:
                self._state = HALF_OPEN
                self._probe_in_flight = False
            if self._state == HALF_OPEN and not self._probe_in_flight:
                self._probe_in_flight = True
                return True
            self.stats["short_circuited"] += 1
            return False

    def record_success(self, duration_s: float = 0.0) -> None:
        with self._lock:
            slow = (
                self.slow_call_s is not None and duration_s > self.slow_call_s
            )
            if slow:
                # The call returned a usable value, but a store this slow is
                # failing its latency contract: count toward opening.
                self.stats["slow_calls"] += 1
                self._record_failure_locked()
                return
            self.stats["successes"] += 1
            self._consecutive_failures = 0
            if self._state == HALF_OPEN:
                self._state = CLOSED
                self._probe_in_flight = False

    def record_failure(self) -> None:
        with self._lock:
            self._record_failure_locked()

    def _record_failure_locked(self) -> None:
        self.stats["failures"] += 1
        self._consecutive_failures += 1
        if self._state == HALF_OPEN or (
            self._state == CLOSED
            and self._consecutive_failures >= self.failure_threshold
        ):
            self._state = OPEN
            self._open_until = self._clock() + self.cooldown_s
            self._probe_in_flight = False
            self.stats["opens"] += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "failure_threshold": self.failure_threshold,
                "cooldown_s": self.cooldown_s,
                **self.stats,
            }
