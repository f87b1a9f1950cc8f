"""Metrics and events of the port (the core of ``photon_tpu/obs``).

* ``metrics``: :data:`REGISTRY` of named counters, gauges and histograms,
  with JSON snapshots and Prometheus text exposition;
* ``trace``: :class:`trace_span` / :func:`instant`, Chrome trace-event
  JSON into an installed :class:`TraceCollector`.

The runtime guards count through the registry and emit ``recovery.*`` and
``fault:*`` instants. Both hooks cost one module-global read when off. The
rest of the JAX package's ``obs`` (fleet view, analysis, the drivers'
``--trace-out``, ``--telemetry-dir`` and ``--profile-dir``) comes with the
observability slice.
"""
from photon_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    HistogramMetric,
    MetricsRegistry,
    REGISTRY,
    get_registry,
)
from photon_tpu_torch.obs.trace import (
    TraceCollector,
    instant,
    start_tracing,
    stop_tracing,
    trace_span,
    tracing,
)

__all__ = [
    "Counter",
    "Gauge",
    "HistogramMetric",
    "MetricsRegistry",
    "REGISTRY",
    "TraceCollector",
    "get_registry",
    "instant",
    "start_tracing",
    "stop_tracing",
    "trace_span",
    "tracing",
]
