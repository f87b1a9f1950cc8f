"""Logging and stage timing.

Port of ``photon_tpu/utils/logging.py`` (``PhotonLogger``, ``Timed``,
``write_metrics_jsonl`` without its size-bounded rotation, and the
``LatencyHistogram`` that ``obs/metrics.py`` builds its histograms on): a
logger that writes a log file into the job's output directory alongside
stderr, a ``Timed`` block that logs wall-clock per driver stage, an
append-only JSON-lines writer and a log-spaced latency histogram.
"""
from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from typing import Any, Iterable, Mapping, Optional

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


class PhotonLogger:
    """Logger bound to an output directory: ``<dir>/photon.log`` + stderr.

    Use as a context manager so file handlers are released deterministically.
    """

    def __init__(
        self,
        output_dir: Optional[str] = None,
        name: str = "photon_tpu_torch",
        level: int = logging.INFO,
    ):
        self.logger = logging.getLogger(name)
        self.logger.setLevel(level)
        self._handlers: list[logging.Handler] = []

        have_stream = any(
            isinstance(h, logging.StreamHandler)
            and not isinstance(h, logging.FileHandler)
            for h in self.logger.handlers
        )
        if not have_stream:
            sh = logging.StreamHandler()
            sh.setFormatter(logging.Formatter(_FORMAT))
            self.logger.addHandler(sh)
            self._handlers.append(sh)
        if output_dir is not None:
            os.makedirs(output_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(output_dir, "photon.log"))
            fh.setFormatter(logging.Formatter(_FORMAT))
            self.logger.addHandler(fh)
            self._handlers.append(fh)

    def __enter__(self) -> logging.Logger:
        return self.logger

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        for h in self._handlers:
            self.logger.removeHandler(h)
            h.close()
        self._handlers.clear()


class Timed:
    """``with Timed("read data", logger): ...`` — logs elapsed wall-clock,
    and records it in ``seconds`` for programmatic use."""

    def __init__(self, stage: str, logger: Optional[logging.Logger] = None):
        self.stage = stage
        self.logger = logger or logging.getLogger("photon_tpu_torch")
        self.seconds: float = 0.0

    def __enter__(self) -> "Timed":
        self._t0 = time.perf_counter()
        self.logger.info("%s: started", self.stage)
        return self

    def __exit__(self, exc_type, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0
        status = "failed" if exc_type else "done"
        self.logger.info("%s: %s in %.3fs", self.stage, status, self.seconds)


def write_metrics_jsonl(path: str, records: Iterable[Mapping[str, Any]]) -> None:
    """Append metric records as JSON lines, one object per line, each line
    one unbuffered ``write()`` on an append-mode file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "ab", buffering=0) as f:
        for rec in records:
            f.write((json.dumps(dict(rec)) + "\n").encode("utf-8"))


class LatencyHistogram:
    """Log-spaced latency histogram with approximate quantiles.

    Serving instrumentation (docs/serving.md): memory stays bounded under
    any traffic volume (fixed bin array, no sample retention) while
    p50/p95/p99 stay within one bin's relative width (~12% at the default
    20 bins/decade). Sum and max are tracked exactly. Thread-safe.
    """

    def __init__(
        self,
        lo_ms: float = 0.05,
        hi_ms: float = 60_000.0,
        bins_per_decade: int = 20,
    ):
        self._lo = lo_ms / 1e3
        self._bins_per_decade = int(bins_per_decade)
        self._ratio = 10.0 ** (1.0 / bins_per_decade)
        self._log_ratio = math.log(self._ratio)
        n = int(math.ceil(math.log(hi_ms / lo_ms) / self._log_ratio)) + 1
        self._counts = [0] * (n + 2)  # + underflow/overflow bins
        self._lock = threading.Lock()
        self._sum = 0.0
        self._max = 0.0
        self._n = 0

    def observe(self, seconds: float) -> None:
        if seconds <= 0:
            seconds = 1e-9
        b = int(math.floor(math.log(seconds / self._lo) / self._log_ratio)) + 1
        b = min(max(b, 0), len(self._counts) - 1)
        with self._lock:
            self._counts[b] += 1
            self._sum += seconds
            self._max = max(self._max, seconds)
            self._n += 1

    def quantile_ms(self, q: float) -> float:
        """Approximate q-quantile in milliseconds (geometric bin midpoint)."""
        with self._lock:
            n = self._n
            counts = list(self._counts)
        if n == 0:
            return 0.0
        target = q * n
        seen = 0
        for b, c in enumerate(counts):
            seen += c
            if seen >= target:
                if b == 0:
                    return self._lo * 1e3
                lo = self._lo * self._ratio ** (b - 1)
                return lo * (self._ratio ** 0.5) * 1e3
        return self._max * 1e3

    def snapshot(self) -> dict:
        with self._lock:
            n, s, mx = self._n, self._sum, self._max
        return {
            "count": n,
            "mean_ms": round(s / n * 1e3, 3) if n else 0.0,
            "p50_ms": round(self.quantile_ms(0.50), 3),
            "p95_ms": round(self.quantile_ms(0.95), 3),
            "p99_ms": round(self.quantile_ms(0.99), 3),
            "max_ms": round(mx * 1e3, 3),
        }

    # -------------------------------------------------- fleet aggregation
    #
    # Full mergeable state (not just the quantile snapshot): per-process
    # registry shards dump it, the fleet aggregator adds bin counts
    # elementwise — exact, associative, commutative (obs/fleet.py).

    def state(self) -> dict:
        with self._lock:
            return {
                "lo_ms": self._lo * 1e3,
                "bins_per_decade": self._bins_per_decade,
                "counts": list(self._counts),
                "sum": self._sum,
                "max": self._max,
                "n": self._n,
            }

    @classmethod
    def from_state(cls, state: Mapping[str, Any]) -> "LatencyHistogram":
        """Reconstruct a histogram with EXACTLY the state's bin layout —
        the aggregator's entry point for a shard whose exporter used a
        non-default layout (bin count is restored verbatim, not re-derived
        from a hi_ms round-trip)."""
        h = cls(lo_ms=float(state["lo_ms"]),
                bins_per_decade=int(state.get("bins_per_decade", 20)))
        with h._lock:
            h._counts = [int(c) for c in state["counts"]]
            h._sum = float(state["sum"])
            h._max = float(state["max"])
            h._n = int(state["n"])
        return h

    def merge_state(self, state: Mapping[str, Any]) -> None:
        """Fold another histogram's :meth:`state` into this one. Refuses a
        mismatched bin layout — summing misaligned bins would silently
        corrupt every quantile downstream."""
        counts = state["counts"]
        if (len(counts) != len(self._counts)
                or abs(float(state["lo_ms"]) - self._lo * 1e3) > 1e-9
                or int(state.get("bins_per_decade",
                                 self._bins_per_decade))
                != self._bins_per_decade):
            raise ValueError(
                "histogram bin layout mismatch: cannot merge "
                f"{len(counts)} bins @ lo={state['lo_ms']}ms into "
                f"{len(self._counts)} bins @ lo={self._lo * 1e3}ms"
            )
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += int(c)
            self._sum += float(state["sum"])
            self._max = max(self._max, float(state["max"]))
            self._n += int(state["n"])
