"""Process-wide tracing: Chrome trace-event spans and instants.

The part of ``photon_tpu/obs/trace.py`` that the runtime guards emit
through: :class:`trace_span` and :func:`instant`, and a bounded in-memory
:class:`TraceCollector` with its install and uninstall
(:func:`start_tracing`, :func:`stop_tracing`, :class:`tracing`). Events are
the JAX module's Chrome trace-event JSON (``{"traceEvents": [...]}``,
loadable in Perfetto). Trace ids across threads, the fleet anchor, span
sampling, the size cap and the tail sampler come with the observability
slice, as do the drivers' ``--trace-out``.

Both hooks cost one module-global read when no collector is installed, as
``faults.fault_point`` does: :class:`trace_span` still measures its wall
time into ``span.seconds``.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Optional

__all__ = [
    "TraceCollector",
    "instant",
    "start_tracing",
    "stop_tracing",
    "trace_span",
    "tracing",
]

# One clock for every collector of the process: microseconds from import.
_EPOCH = time.perf_counter()

_span_ids = itertools.count(1)

# A leaked collector must not grow host memory without bound; dropped
# events are counted in the written artifact.
_DEFAULT_MAX_EVENTS = 1_000_000


class TraceCollector:
    """Thread-safe in-memory buffer of Chrome trace events, at most
    ``max_events`` of them (the rest counted in ``dropped``)."""

    def __init__(self, max_events: int = _DEFAULT_MAX_EVENTS):
        self.max_events = int(max_events)
        self.events: list[dict] = []
        self.dropped = 0
        self._lock = threading.Lock()
        self._pid = os.getpid()

    def add(self, event: dict) -> None:
        with self._lock:
            if len(self.events) >= self.max_events:
                self.dropped += 1
                return
            self.events.append(event)

    def complete(self, name: str, cat: str, t0: float, dur_s: float,
                 args: Optional[dict] = None) -> None:
        """One 'X' (complete) event; ``t0`` is a ``perf_counter`` value."""
        self.add({"name": name, "cat": cat, "ph": "X",
                  "ts": round((t0 - _EPOCH) * 1e6, 1),
                  "dur": round(dur_s * 1e6, 1), "pid": self._pid,
                  "tid": threading.get_ident() & 0xFFFFFFFF,
                  "args": args or {}})

    def instant(self, name: str, cat: str, args: Optional[dict] = None) -> None:
        """One 'i' (instant) event at now."""
        self.add({"name": name, "cat": cat, "ph": "i", "s": "t",
                  "ts": round((time.perf_counter() - _EPOCH) * 1e6, 1),
                  "pid": self._pid, "tid": threading.get_ident() & 0xFFFFFFFF,
                  "args": args or {}})

    def to_dict(self) -> dict:
        with self._lock:
            out = {"traceEvents": list(self.events), "displayTimeUnit": "ms"}
            if self.dropped:
                out["photon.trace.dropped"] = self.dropped
        return out

    def write(self, path: str) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
        return path


_ACTIVE: Optional[TraceCollector] = None


def start_tracing(max_events: int = _DEFAULT_MAX_EVENTS) -> TraceCollector:
    """Install a process-wide collector (replacing any active one)."""
    global _ACTIVE
    _ACTIVE = TraceCollector(max_events=max_events)
    return _ACTIVE


def stop_tracing(path: Optional[str] = None) -> Optional[TraceCollector]:
    """Uninstall the active collector; write it to ``path`` if given."""
    global _ACTIVE
    col = _ACTIVE
    _ACTIVE = None
    if col is not None and path:
        col.write(path)
    return col


class tracing:
    """``with tracing(path) as col:``: a scoped collector, written on exit
    when ``path`` is given; whatever was active before comes back."""

    __slots__ = ("path", "max_events", "collector", "_prev")

    def __init__(self, path: Optional[str] = None,
                 max_events: int = _DEFAULT_MAX_EVENTS):
        self.path = path
        self.max_events = max_events
        self.collector: Optional[TraceCollector] = None

    def __enter__(self) -> TraceCollector:
        global _ACTIVE
        self._prev = _ACTIVE
        self.collector = TraceCollector(max_events=self.max_events)
        _ACTIVE = self.collector
        return self.collector

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        _ACTIVE = self._prev
        if self.path and self.collector is not None:
            self.collector.write(self.path)


class trace_span:
    """``with trace_span("descent.step", cat="descent", sweep=0) as sp:``

    Measures wall time into ``sp.seconds`` always; emits a complete event
    only when a collector is installed. ``sp.set(key=value)`` adds result
    attributes before exit; an escaping exception is recorded as
    ``args["error"]``."""

    __slots__ = ("name", "cat", "args", "seconds", "_t0")

    def __init__(self, name: str, cat: str = "app", **args):
        self.name = name
        self.cat = cat
        self.args = args
        self.seconds = 0.0

    def set(self, **args) -> "trace_span":
        self.args.update(args)
        return self

    def __enter__(self) -> "trace_span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.seconds = time.perf_counter() - self._t0
        col = _ACTIVE
        if col is None:
            return
        args = self.args
        if exc_type is not None:
            args = {**args, "error": exc_type.__name__}
        col.complete(self.name, self.cat, self._t0, self.seconds,
                     {**args, "span_id": next(_span_ids)})


def instant(name: str, cat: str = "event", **args) -> None:
    """An instant event (no duration) when a collector is installed: fault
    firings and the ``recovery.*`` events of the runtime guards."""
    col = _ACTIVE
    if col is not None:
        col.instant(name, cat, args)
