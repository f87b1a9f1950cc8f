"""Process-wide metrics registry: named counters, gauges, histograms.

A copy of ``photon_tpu/obs/metrics.py`` (it imports no JAX). Every
instrument is thread-safe and resettable, and a registry exports two views
of the same state: :meth:`MetricsRegistry.snapshot`, a nested JSON dict,
and :meth:`MetricsRegistry.to_prometheus`, Prometheus text exposition
(version 0.0.4). Labels are one flat ``dict`` of pairs per child;
histograms reuse ``utils.LatencyHistogram`` and export as a Prometheus
summary. The module-level :data:`REGISTRY` is the process default: the
runtime guards count through it (``oom_downshifts_total``,
``run_restarts_total``, ``backend_failovers_total``, the
``device_memory_*`` gauges).
"""
from __future__ import annotations

import math
import re
import threading
import time
from typing import Callable, Mapping, Optional

from photon_tpu_torch.utils.logging import LatencyHistogram

__all__ = [
    "Counter",
    "Gauge",
    "HistogramMetric",
    "MetricsRegistry",
    "REGISTRY",
    "get_registry",
]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _prom_labels(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    body = ",".join(
        f'{_prom_name(str(k))}="{_escape_label(str(v))}"'
        for k, v in sorted(labels.items())
    )
    return "{" + body + "}"


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_value(v) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f) if not f.is_integer() else str(int(f))


class Counter:
    """Monotonic counter, optionally with one level of labels.

    ``inc()`` bumps the unlabeled value; ``inc(kernel="score")`` bumps the
    ``{kernel="score"}`` child. ``value()``/``value(kernel=...)`` read.
    """

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0
        self._children: dict[tuple, float] = {}

    @staticmethod
    def _key(labels: Mapping[str, str]) -> tuple:
        return tuple(sorted((str(k), str(v)) for k, v in labels.items()))

    def inc(self, n: float = 1, **labels) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease by {n}")
        with self._lock:
            if labels:
                k = self._key(labels)
                self._children[k] = self._children.get(k, 0.0) + n
            else:
                self._value += n

    def value(self, **labels) -> float:
        with self._lock:
            if labels:
                return self._children.get(self._key(labels), 0.0)
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0
            self._children.clear()

    def collect(self) -> list[tuple[dict, float]]:
        """(labels, value) series, unlabeled first."""
        with self._lock:
            out = []
            if self._value or not self._children:
                out.append(({}, self._value))
            out.extend((dict(k), v) for k, v in sorted(self._children.items()))
            return out

    def snapshot_value(self):
        with self._lock:
            if self._children:
                return {
                    ".".join(v for _, v in k): val
                    for k, val in sorted(self._children.items())
                } | ({"": self._value} if self._value else {})
            return self._value

    def fold_series(self, labels: Mapping[str, str], value: float) -> None:
        """Merge primitive (obs/fleet.py): add one (labels, value) series
        from another process's shard. Counters SUM — bypasses ``inc``'s
        identifier-keyed kwargs so arbitrary label keys round-trip."""
        with self._lock:
            if labels:
                k = self._key(labels)
                self._children[k] = self._children.get(k, 0.0) + float(value)
            else:
                self._value += float(value)


class Gauge(Counter):
    """Settable instantaneous value; ``fn`` makes it a callback gauge read
    at collection time (queue depth, device-memory watermark)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 fn: Optional[Callable[[], float]] = None):
        super().__init__(name, help)
        self._fn = fn

    def set(self, v: float, **labels) -> None:
        with self._lock:
            if labels:
                self._children[self._key(labels)] = float(v)
            else:
                self._value = float(v)

    def inc(self, n: float = 1, **labels) -> None:  # gauges may move freely
        with self._lock:
            if labels:
                k = self._key(labels)
                self._children[k] = self._children.get(k, 0.0) + n
            else:
                self._value += n

    def dec(self, n: float = 1, **labels) -> None:
        self.inc(-n, **labels)

    def collect(self) -> list[tuple[dict, float]]:
        if self._fn is not None:
            try:
                v = self._fn()
            except Exception:  # noqa: BLE001 - a sick probe must not 500 /metrics
                return []
            if isinstance(v, Mapping):
                return [(dict(k) if isinstance(k, tuple) else {"key": str(k)},
                         float(val)) for k, val in sorted(v.items())]
            return [({}, float(v))] if v is not None else []
        return super().collect()

    def snapshot_value(self):
        if self._fn is not None:
            series = self.collect()
            if len(series) == 1 and not series[0][0]:
                return series[0][1]
            return {
                ".".join(f"{k}={v}" for k, v in sorted(lbl.items())): val
                for lbl, val in series
            }
        return super().snapshot_value()

    def fold_series(self, labels: Mapping[str, str], value: float) -> None:
        """Merge primitive: gauges are instantaneous, so a fold REPLACES
        the series value — latest-by-anchor ordering is the registry's job
        (``MetricsRegistry.merge`` folds shards in anchor order)."""
        with self._lock:
            if labels:
                self._children[self._key(labels)] = float(value)
            else:
                self._value = float(value)


class HistogramMetric:
    """A named ``LatencyHistogram`` exported as a Prometheus summary.

    Supports the same single flat label level as Counter/Gauge:
    ``observe(seconds, stage="kernel")`` lands the sample in a per-label
    child histogram (identical bin layout to the base, so children stay
    mergeable), and the exposition emits one quantile/sum/count series
    per child — p95 queue-wait vs p95 kernel is ONE scrape, not a
    trace-file autopsy (docs/serving.md §"Latency waterfall")."""

    kind = "summary"
    QUANTILES = (0.5, 0.95, 0.99)

    def __init__(self, name: str, help: str = "",
                 histogram: Optional[LatencyHistogram] = None):
        self.name = name
        self.help = help
        self.histogram = histogram or LatencyHistogram()
        self._children: dict[tuple, LatencyHistogram] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(labels: Mapping[str, str]) -> tuple:
        return tuple(sorted((str(k), str(v)) for k, v in labels.items()))

    def _blank_child(self) -> LatencyHistogram:
        """A zeroed histogram with EXACTLY the base's bin layout, so every
        child of one metric merges bin-for-bin across shards."""
        h = self.histogram
        return LatencyHistogram.from_state({
            "lo_ms": h._lo * 1e3,
            "bins_per_decade": h._bins_per_decade,
            "counts": [0] * len(h._counts),
            "sum": 0.0, "max": 0.0, "n": 0,
        })

    def child(self, **labels) -> LatencyHistogram:
        """The (created-on-first-use) child histogram for one label set;
        no labels returns the base histogram."""
        if not labels:
            return self.histogram
        k = self._key(labels)
        with self._lock:
            h = self._children.get(k)
            if h is None:
                h = self._blank_child()
                self._children[k] = h
            return h

    def observe(self, seconds: float, **labels) -> None:
        if labels:
            self.child(**labels).observe(seconds)
        else:
            self.histogram.observe(seconds)

    def reset(self) -> None:
        # LatencyHistogram has no public reset; replace it wholesale (racy
        # observers at worst land one sample in the discarded instance).
        self.histogram = LatencyHistogram()
        with self._lock:
            self._children.clear()

    def collect_children(self) -> list[tuple[dict, LatencyHistogram]]:
        with self._lock:
            return [(dict(k), h) for k, h in sorted(self._children.items())]

    def fold_child(self, labels: Mapping[str, str], state: Mapping) -> None:
        """Merge primitive (obs/fleet.py): fold one child's histogram
        state from another process's shard. Raises ValueError on a bin
        layout mismatch, same contract as ``LatencyHistogram.merge_state``."""
        k = self._key(labels)
        with self._lock:
            h = self._children.get(k)
            if h is None:
                self._children[k] = LatencyHistogram.from_state(state)
                return
        h.merge_state(state)

    def snapshot_value(self) -> dict:
        with self._lock:
            children = dict(self._children)
        if not children:
            return self.histogram.snapshot()
        out = {
            ".".join(v for _, v in k): h.snapshot()
            for k, h in sorted(children.items())
        }
        if self.histogram._n:
            out[""] = self.histogram.snapshot()
        return out

    def prometheus_lines(self, exposed_name: Optional[str] = None) -> list[str]:
        name = exposed_name or _prom_name(self.name)
        with self._lock:
            children = sorted(self._children.items())
        lines: list[str] = []

        def emit(h: LatencyHistogram, labels: dict) -> None:
            with h._lock:
                n, s = h._n, h._sum
            for q in self.QUANTILES:
                lines.append(
                    f"{name}{_prom_labels({**labels, 'quantile': str(q)})} "
                    f"{_prom_value(h.quantile_ms(q) / 1e3)}"
                )
            lines.append(f"{name}_sum{_prom_labels(labels)} {_prom_value(s)}")
            lines.append(
                f"{name}_count{_prom_labels(labels)} {_prom_value(n)}")

        if self.histogram._n or not children:
            emit(self.histogram, {})
        for k, h in children:
            emit(h, dict(k))
        return lines


class MetricsRegistry:
    """Name → instrument registry. Instruments are created on first use and
    shared thereafter (idempotent ``counter``/``gauge``/``histogram``
    accessors), so call sites don't coordinate setup order."""

    def __init__(self, prefix: str = "photon"):
        self.prefix = prefix
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}
        # Fleet-merge bookkeeping (docs/observability.md §"Fleet view"):
        # per-shard retained states (shard_id -> (anchor, state)) so
        # re-merging a shard REPLACES its contribution instead of
        # double-counting, and per-gauge-series anchors so gauges resolve
        # latest-by-anchor whatever order shards arrive in.
        self._shard_states: dict[str, tuple] = {}
        self._fold_anchors: dict[tuple, float] = {}

    def _get(self, name: str, factory, kind) -> object:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, lambda: Counter(name, help), Counter)

    def gauge(self, name: str, help: str = "") -> Gauge:
        m = self._get(name, lambda: Gauge(name, help), Gauge)
        return m

    def gauge_fn(self, name: str, fn: Callable[[], float],
                 help: str = "") -> Gauge:
        return self._get(name, lambda: Gauge(name, help, fn=fn), Gauge)

    def histogram(self, name: str, help: str = "",
                  histogram: Optional[LatencyHistogram] = None
                  ) -> HistogramMetric:
        return self._get(
            name, lambda: HistogramMetric(name, help, histogram),
            HistogramMetric,
        )

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def reset(self) -> None:
        """Zero every instrument (tests; NOT for production use — counters
        are contractually monotonic between scrapes)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            reset = getattr(m, "reset", None)
            if reset is not None:
                reset()

    # ----------------------------------------------- fleet merge protocol
    #
    # The aggregation substrate the multi-process topology needs
    # (obs/fleet.py; docs/observability.md §"Fleet view"). Semantics:
    # counters SUM, gauges keep the value from the LATEST anchor (wall
    # clock at shard export), histograms merge bin counts exactly. The
    # pairwise fold is associative and commutative; idempotence ("a
    # double-collected shard changes nothing") comes from the shard
    # protocol — merge with a shard_id retains per-shard state and a
    # re-merge REPLACES that shard's contribution instead of adding it
    # again (the SolverCostTable.merge precedent from the mesh work).

    def dump_state(self) -> dict:
        """Full mergeable state: counter/gauge series with label dicts,
        histograms as raw bin counts (JSON-serializable — the registry-
        shard wire format)."""
        with self._lock:
            metrics = dict(self._metrics)
        out = {}
        for name, m in sorted(metrics.items()):
            if isinstance(m, HistogramMetric):
                spec = {"kind": "summary", "help": m.help,
                        "state": m.histogram.state()}
                children = m.collect_children()
                if children:
                    spec["children"] = [[labels, h.state()]
                                        for labels, h in children]
                out[name] = spec
            else:
                out[name] = {
                    "kind": m.kind, "help": m.help,
                    "series": [[labels, value] for labels, value
                               in m.collect()],
                }
        return out

    def _fold(self, state: Mapping, anchor: float) -> None:
        import logging

        for name, spec in state.items():
            kind = spec.get("kind")
            help_ = spec.get("help", "")
            if kind == "summary":
                hstate = spec["state"]
                with self._lock:
                    absent = name not in self._metrics
                if absent:
                    # Create with the SHARD's bin layout, not the default:
                    # a component exporting a non-default LatencyHistogram
                    # must fold, not mismatch.
                    hm = self.histogram(
                        name, help_,
                        histogram=LatencyHistogram.from_state(hstate))
                else:
                    hm = self.histogram(name, help_)
                    try:
                        hm.histogram.merge_state(hstate)
                    except (ValueError, TypeError, KeyError) as e:
                        # One incompatible shard histogram must not kill the
                        # whole aggregation (the run report's contract) —
                        # skip the metric, loudly.
                        logging.getLogger("photon_tpu_torch.obs").warning(
                            "fleet merge: skipping histogram %r (%s)",
                            name, e)
                        continue
                for labels, cstate in spec.get("children", ()):
                    try:
                        hm.fold_child(labels, cstate)
                    except (ValueError, TypeError, KeyError) as e:
                        logging.getLogger("photon_tpu_torch.obs").warning(
                            "fleet merge: skipping histogram %r child %r "
                            "(%s)", name, labels, e)
            elif kind == "gauge":
                g = self.gauge(name, help_)
                for labels, value in spec.get("series", ()):
                    key = (name, tuple(sorted(
                        (str(k), str(v)) for k, v in labels.items())))
                    if anchor >= self._fold_anchors.get(key, float("-inf")):
                        self._fold_anchors[key] = anchor
                        g.fold_series(labels, value)
            elif kind == "counter":
                c = self.counter(name, help_)
                for labels, value in spec.get("series", ()):
                    if value:
                        c.fold_series(labels, value)
            # unknown kinds are skipped: a newer shard schema must not
            # kill an older aggregator

    @staticmethod
    def _hist_state_delta(ns: Mapping, os_: Mapping) -> Optional[dict]:
        """Elementwise ``new - old`` of one histogram state, or ``None``
        when the bin layout changed (caller folds the whole new state)."""
        if (len(ns.get("counts", ())) != len(os_.get("counts", ()))
                or ns.get("lo_ms") != os_.get("lo_ms")):
            return None
        return {
            **ns,
            "counts": [int(a) - int(b) for a, b
                       in zip(ns["counts"], os_["counts"])],
            "sum": float(ns["sum"]) - float(os_["sum"]),
            "n": int(ns["n"]) - int(os_["n"]),
            "max": max(float(ns["max"]), float(os_["max"])),
        }

    @staticmethod
    def _state_delta(new: Mapping, old: Mapping) -> dict:
        """``new - old`` as a foldable state: the replacement delta for a
        re-exported shard. Counters/histogram bins subtract elementwise
        (a restarted shard's lower counts fold as a negative correction);
        gauges pass through as-is (the fold's latest-anchor rule decides);
        a histogram max watermark is monotone (max of the two)."""
        out: dict = {}
        for name, spec in new.items():
            prev = old.get(name)
            if prev is None or prev.get("kind") != spec.get("kind"):
                out[name] = spec
                continue
            kind = spec.get("kind")
            if kind == "counter":
                old_by = {tuple(sorted((str(k), str(v))
                                       for k, v in labels.items())): value
                          for labels, value in prev.get("series", ())}
                series = []
                for labels, value in spec.get("series", ()):
                    key = tuple(sorted((str(k), str(v))
                                       for k, v in labels.items()))
                    series.append([labels, value - old_by.pop(key, 0.0)])
                for key, value in old_by.items():  # vanished series
                    series.append([dict(key), -value])
                out[name] = {**spec, "series": series}
            elif kind == "summary":
                diff = MetricsRegistry._hist_state_delta(
                    spec["state"], prev["state"])
                if diff is None:
                    out[name] = spec  # layout changed: fold whole (skipped
                    continue          # by merge_state's mismatch guard)
                delta_spec = {**spec, "state": diff}
                if "children" in spec or "children" in prev:
                    old_children = {
                        tuple(sorted((str(k), str(v))
                                     for k, v in labels.items())): st
                        for labels, st in prev.get("children", ())
                    }
                    children = []
                    for labels, st in spec.get("children", ()):
                        key = tuple(sorted((str(k), str(v))
                                           for k, v in labels.items()))
                        ost = old_children.pop(key, None)
                        cdiff = (None if ost is None
                                 else MetricsRegistry._hist_state_delta(
                                     st, ost))
                        children.append([labels, st if cdiff is None
                                         else cdiff])
                    # Vanished children (an in-place reset) fold as a
                    # negative correction, mirroring counter series.
                    for key, ost in old_children.items():
                        children.append([dict(key), {
                            **ost,
                            "counts": [-int(c) for c in ost["counts"]],
                            "sum": -float(ost["sum"]),
                            "n": -int(ost["n"]),
                            "max": float(ost["max"]),
                        }])
                    if children:
                        delta_spec["children"] = children
                    else:
                        delta_spec.pop("children", None)
                out[name] = delta_spec
            else:
                out[name] = spec
        return out

    def merge(self, other, anchor: Optional[float] = None,
              shard_id: Optional[str] = None) -> "MetricsRegistry":
        """Fold another registry (or a :meth:`dump_state` dict) into this
        one. ``anchor`` is the state's export wall time (defaults to now)
        — it decides which gauge value is "latest". With ``shard_id`` the
        merge is idempotent per shard: a re-merge with the same or an
        older anchor is a no-op; a newer anchor REPLACES that shard's
        previous contribution by folding the DELTA between the retained
        and new states — live instruments are updated in place, so the
        registry's own (non-shard) counters and any held instrument
        references stay attached and keep counting between merges."""
        state = other.dump_state() if isinstance(
            other, MetricsRegistry) else dict(other)
        anchor = time.time() if anchor is None else float(anchor)
        if shard_id is None:
            self._fold(state, anchor)
            return self
        prev = self._shard_states.get(shard_id)
        if prev is not None and prev[0] >= anchor:
            return self  # idempotent: double-collected shard changes nothing
        delta = state if prev is None else self._state_delta(state, prev[1])
        self._shard_states[shard_id] = (anchor, state)
        self._fold(delta, anchor)
        return self

    # ------------------------------------------------------------ exports

    def snapshot(self) -> dict:
        """Flat name → value dict (counters/gauges scalar or per-label dict,
        histograms their quantile snapshot)."""
        with self._lock:
            metrics = dict(self._metrics)
        return {name: m.snapshot_value() for name, m in sorted(metrics.items())}

    def to_prometheus(self, extra: Optional["MetricsRegistry"] = None) -> str:
        """Prometheus text exposition of this registry (merged with
        ``extra`` — typically the process-global registry — when given)."""
        with self._lock:
            metrics = dict(self._metrics)
        if extra is not None:
            with extra._lock:
                for name, m in extra._metrics.items():
                    metrics.setdefault(name, m)
        lines: list[str] = []
        for name in sorted(metrics):
            m = metrics[name]
            pname = _prom_name(f"{self.prefix}_{name}")
            if m.help:
                lines.append(f"# HELP {pname} {m.help}")
            lines.append(f"# TYPE {pname} {m.kind}")
            if isinstance(m, HistogramMetric):
                lines.extend(m.prometheus_lines(pname))
            else:
                for labels, value in m.collect():
                    lines.append(
                        f"{pname}{_prom_labels(labels)} {_prom_value(value)}"
                    )
        return "\n".join(lines) + "\n"

    def now(self) -> float:  # patchable in tests
        return time.time()


# Process-global default registry: kernel retrace counters, device-memory
# gauges, ingest/descent counters — anything not owned by a single server.
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY
