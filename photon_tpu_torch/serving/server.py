"""Concurrent JSON scoring server on stdlib ``ThreadingHTTPServer``.

Port of ``photon_tpu/serving/server.py``. The routes, bodies, shedding,
drain and metrics are the JAX server's; what differs: ``/healthz`` names
the registry's torch device type as the backend (``cuda`` or ``cpu``), the
``device_memory_bytes`` gauge reads the CUDA caching allocator, and the
metrics snapshot has no ``kernel_traces`` / ``kernel_retraces_after_warmup``
(the port compiles no programs); the handler sets ``TCP_NODELAY``, so a
kept-alive client does not wait out its delayed ACK for a reply's body; and
the listen backlog is 128, not the stdlib's 5.

Routes:

* ``POST /score``       — one JSON row → ``{"score": .., "model_version"}``
  (plus ``"degraded": [..]`` when RE coordinates scored fixed-effect-only
  behind an open coefficient-store circuit breaker)
* ``GET  /healthz``     — liveness + current model version; 503 once the
  batcher worker has died
* ``GET  /metrics``     — latency histogram (p50/p95/p99), lifetime +
  interval throughput, shed/expired counters, batcher + coefficient-cache
  + breaker stats (JSON)
* ``GET  /metrics?format=prom`` — the same state as Prometheus text
  exposition (docs/observability.md §scrape): latency summary, request
  counters, queue depth, device-memory watermark
* ``POST /admin/swap``  — ``{"model_dir": ..}`` → hot-swap; blocking,
  atomic, in-flight requests unaffected

Handler threads only parse and wait; all device work funnels through the
micro-batcher's single worker. Overload story (docs/robustness.md): a full
admission queue sheds the request with HTTP 503 + ``Retry-After`` instead
of queueing unboundedly, and each admitted request carries a deadline the
batcher honors — an expired row is dropped before the kernel runs and its
waiter gets 503, never a hang. Metrics snapshots append to the output
directory's ``serving-metrics.jsonl`` through ``utils/logging``'s JSONL
writer (periodically and at shutdown).
"""
from __future__ import annotations

import json
import threading
import time
import urllib.parse
from collections import OrderedDict
from concurrent.futures import TimeoutError as FuturesTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from photon_tpu_torch.obs import (
    MetricsRegistry,
    REGISTRY as GLOBAL_REGISTRY,
    instant,
    new_trace_id,
    trace_context,
    trace_span,
)
from photon_tpu_torch.obs import trace as obs_trace
from photon_tpu_torch.serving.batcher import (
    DeadlineExceeded,
    MicroBatcher,
    Overloaded,
)
from photon_tpu_torch.serving.registry import ModelRegistry
from photon_tpu_torch.serving.scorer import RequestError
from photon_tpu_torch.utils import write_metrics_jsonl

_REQUEST_TIMEOUT_S = 30.0


class _HTTPServer(ThreadingHTTPServer):
    # The listen backlog: the stdlib's 5 overflows when a few dozen clients
    # connect at once while a hot swap's model load holds the interpreter,
    # and the kernel then resets connections.
    request_queue_size = 128
    daemon_threads = True


def _device_memory_series(device) -> dict:
    """``{(label_tuple): bytes}`` of the caching allocator's live and peak
    bytes on a CUDA ``device``, or {} (the CPU, or no CUDA context yet)."""
    try:
        import torch

        if device is None or device.type != "cuda" or \
                not torch.cuda.is_initialized():
            return {}
        key = f"cuda:{device.index or 0}"
        return {
            (("device", key), ("kind", "in_use")):
                float(torch.cuda.memory_allocated(device)),
            (("device", key), ("kind", "peak")):
                float(torch.cuda.max_memory_allocated(device)),
        }
    except Exception:  # noqa: BLE001 - a sick backend must not break /metrics
        return {}


class ScoringServer:
    """Owns the HTTP front-end + instrumentation around registry/batcher."""

    def __init__(
        self,
        registry: ModelRegistry,
        batcher: MicroBatcher,
        host: str = "127.0.0.1",
        port: int = 0,
        logger=None,
        metrics_path: Optional[str] = None,
        metrics_interval_s: float = 60.0,
        request_timeout_s: float = _REQUEST_TIMEOUT_S,
        slo_config=None,
    ):
        self.registry = registry
        self.batcher = batcher
        self.logger = logger
        self.metrics_path = metrics_path
        self.request_timeout_s = float(request_timeout_s)
        # Declarative SLOs (docs/observability.md §SLO): a config path or
        # SloConfig, judged against each periodic metrics flush and the
        # shutdown flush — violations bump the process-global
        # slo_violations_total{slo=...} (visible on this server's
        # /metrics?format=prom via the registry merge) and emit trace
        # instants; the last report rides the JSON snapshot under "slo".
        if isinstance(slo_config, str):
            from photon_tpu_torch.obs.analysis.slo import SloConfig

            slo_config = SloConfig.from_file(slo_config)
        self.slo_config = slo_config
        self._slo_last = None
        # Per-server metrics registry (docs/observability.md): the old
        # hand-rolled counter dict, the latency histogram, and the batcher/
        # cache/breaker snapshots all live here now, giving one state with
        # two exports — the JSON snapshot below and the Prometheus text
        # exposition at /metrics?format=prom. Per-instance (not the process
        # global) so multiple servers in one process never collide; the
        # process-global registry (recovery and memory-guard counters) is
        # merged at exposition time.
        self.metrics = MetricsRegistry()
        self._counters = {
            name: self.metrics.counter(
                f"serve_{name}_total", f"scoring requests: {name}")
            for name in (
                "requests", "errors", "swaps", "patches", "shed", "expired",
                "degraded", "patch_duplicates", "tunes", "memory_sheds",
            )
        }
        # /admin/patch idempotency (docs/online.md): a publisher whose
        # POST timed out AFTER the server applied the delta retries the
        # same logical delta; replaying the cached result instead of
        # re-applying keeps the patch counters and patch_seq honest.
        # Bounded LRU — the publisher retries back-to-back, so even a
        # tiny window covers the at-least-once race with room to spare.
        self._patch_seen: "OrderedDict[str, dict]" = OrderedDict()
        self._patch_seen_lock = threading.Lock()
        self._latency = self.metrics.histogram(
            "serve_request_latency_seconds",
            "end-to-end /score latency (successful requests)",
        )
        # Per-stage latency waterfall (docs/serving.md §"Latency
        # waterfall"): one labeled summary, so p95 queue-wait vs p95
        # kernel is a single scrape, not a trace-file autopsy.
        self._stage_hist = self.metrics.histogram(
            "serve_stage_latency_seconds",
            "per-request stage waterfall: admission / queue_wait / "
            "batch_assembly / store_resolve / kernel / response "
            "(successful requests)",
        )
        self.metrics.gauge_fn(
            "serve_queue_depth", lambda: self.batcher.snapshot()["queued"],
            "requests waiting in the micro-batcher admission queue",
        )
        self.metrics.gauge_fn(
            "serve_batch_rows_mean",
            lambda: self.batcher.snapshot()["mean_batch_rows"],
            "mean coalesced micro-batch size",
        )
        self.metrics.gauge_fn(
            "serve_uptime_seconds", lambda: time.time() - self._started_at,
            "seconds since server start",
        )
        self.metrics.gauge_fn(
            "device_memory_bytes",
            lambda: _device_memory_series(
                getattr(self.registry, "device", None)),
            "Device memory watermark: the caching allocator's bytes in use "
            "and peak on the serving device (absent on the CPU)",
        )
        # Startup registration of the recovery watermarks (gauge warm-up
        # audit, docs/observability.md): both read 0 ("never yet") from
        # the very first scrape instead of being absent until the first
        # swap/restart stamps them. recovery_snapshot still maps 0 →
        # None, so /healthz semantics are unchanged.
        for gname, ghelp in (
            ("swap_to_first_score_seconds",
             "seconds from a registry hot-swap publishing a version to "
             "its first completed scored batch"),
            ("restart_to_first_step_seconds",
             "seconds from process start to the restarted run's first "
             "completed step"),
        ):
            g = GLOBAL_REGISTRY.gauge(gname, ghelp)
            if not g.value():
                g.set(0.0)
        self._started_at = time.time()
        # Interval-rate state (satellite fix): lifetime requests/uptime
        # understates the current rate after any idle period, so each
        # snapshot also reports the rate over the window since the previous
        # snapshot/flush.
        self._rate_lock = threading.Lock()
        self._rate_prev_t = self._started_at
        self._rate_prev_requests = 0
        # Replication (docs/serving.md §"Replication"): a ReplicaTailer
        # attached via attach_replication surfaces its seq watermark + lag
        # on /healthz and the metrics snapshot — the staleness signal the
        # router weights traffic by.
        self.replication = None
        # Histogram batch autotuner (docs/serving.md §"Autotuned
        # batching"), attached by the front-line driver; /admin/tune
        # reports its current choice so operators see what the loop is
        # doing through the same surface they'd override it on.
        self.autotuner = None
        # Live fleet view: when set (serving driver, --telemetry-dir),
        # every metrics flush also exports the registry shard here so the
        # obs driver can aggregate this process BEFORE it exits.
        self.telemetry_shard_path: Optional[str] = None
        # Drain state (SIGTERM contract): the flag 503s requests arriving
        # on kept-alive connections after the listener closed; the
        # condition variable lets shutdown() wait for in-flight /score
        # handlers to finish before the batcher goes away.
        self._draining = False
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # A reply is two writes (headers, then body). With Nagle's
            # algorithm on, a kept-alive client's delayed ACK holds the
            # body back ~40 ms; TCP_NODELAY sends it at once.
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):  # route through PhotonLogger
                if server.logger is not None:
                    server.logger.debug("http: " + fmt, *args)

            def _reply(self, code: int, payload: dict, headers=()) -> None:
                body = json.dumps(payload).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _read_json(self) -> dict:
                if self.headers.get("Transfer-Encoding"):
                    # Only Content-Length bodies are read; silently scoring
                    # an empty row for a chunked body would be a wrong
                    # answer, not an error — refuse loudly instead. The
                    # unread chunk bytes would desync a kept-alive
                    # connection (parsed as the next request line), so
                    # this connection must close after the error reply.
                    self.close_connection = True
                    raise RequestError(
                        "chunked transfer encoding not supported; "
                        "send Content-Length"
                    )
                n = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(n) if n else b"{}"
                try:
                    return json.loads(raw or b"{}")
                except ValueError:
                    raise RequestError("request body is not valid JSON")

            def do_GET(self):
                path, _, query = self.path.partition("?")
                if path == "/metrics":
                    q = urllib.parse.parse_qs(query)
                    if q.get("format", ["json"])[0] in ("prom", "prometheus"):
                        # Prometheus text exposition: this server's registry
                        # merged with the process-global one (kernel
                        # recoveries, memory guard).
                        body = server.metrics.to_prometheus(
                            extra=GLOBAL_REGISTRY
                        ).encode("utf-8")
                        self.send_response(200)
                        self.send_header(
                            "Content-Type",
                            "text/plain; version=0.0.4; charset=utf-8",
                        )
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    else:
                        self._reply(200, server.metrics_snapshot())
                    return
                if self.path == "/healthz":
                    v = server.registry.current
                    # Backend identity + restart/recovery counts ride every
                    # health reply (docs/robustness.md): an orchestrator —
                    # or an operator — can see at a glance
                    # WHICH backend is serving and whether the process has
                    # been limping through recoveries, not just alive/dead.
                    base = {
                        "model_version": v.version,
                        "backend": server.backend_name(),
                        "restarts": server.restart_counts(),
                        # Serving freshness (docs/online.md): swap + delta
                        # watermarks, so freshness SLOs are measurable
                        # whether or not an online trainer is attached.
                        "freshness": server.freshness(),
                        # Recovery latency watermarks + standby readiness
                        # (docs/robustness.md §"Recovery time").
                        "recovery": server.recovery_snapshot(),
                    }
                    if server.replication is not None:
                        # Seq watermark + lag (docs/serving.md
                        # §"Replication"): the router's staleness signal.
                        base["replication"] = server.replication.snapshot()
                    if not server.batcher.healthy:
                        self._reply(503, {
                            "status": "unhealthy",
                            "error": "batcher worker died: "
                                     f"{server.batcher.failed!r}",
                            "degraded": ["batcher_worker_dead"],
                            **base,
                        })
                        return
                    degraded = server.degraded_reasons(v)
                    self._reply(200, {
                        "status": "degraded" if degraded else "ok",
                        "degraded": degraded,
                        "model_dir": v.model_dir,
                        "uptime_s": round(
                            time.time() - server._started_at, 1),
                        **base,
                    })
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path == "/score":
                    self._score()
                elif self.path == "/admin/swap":
                    self._swap()
                elif self.path == "/admin/standby":
                    self._standby()
                elif self.path == "/admin/patch":
                    self._patch()
                elif self.path == "/admin/tune":
                    self._tune()
                elif self.path == "/admin/memory/shed":
                    self._memory_shed()
                elif self.path == "/admin/replication/restart":
                    self._replication_restart()
                else:
                    # Drain the unread body first: on a kept-alive
                    # connection it would otherwise be parsed as the next
                    # request line (same desync the chunked path closes).
                    n = int(self.headers.get("Content-Length") or 0)
                    if n:
                        self.rfile.read(n)
                    if self.headers.get("Transfer-Encoding"):
                        self.close_connection = True
                    self._reply(404, {"error": f"no route {self.path}"})

            def _score(self):
                # Drain gate (SIGTERM contract, docs/serving.md): once
                # shutdown began, the listener is closed — but a request
                # riding an already-open kept-alive connection could still
                # land here. Refuse it with the shed contract (503 +
                # Retry-After, connection closed) instead of racing the
                # batcher teardown; the router retries it on a live
                # replica.
                if server._draining:
                    n = int(self.headers.get("Content-Length") or 0)
                    if n:
                        self.rfile.read(n)
                    self.close_connection = True
                    self._reply(503, {"error": "server draining",
                                      "shed": True},
                                headers=(("Retry-After", "1"),))
                    return
                with server._inflight_cv:
                    server._inflight += 1
                try:
                    # Trace root: one trace id per request, attached to
                    # this thread for the admission spans and carried
                    # across the batcher boundary on the queue item
                    # (docs/observability.md). A client-supplied
                    # X-Photon-Trace-Id joins this server's spans to the
                    # CALLER's trace shard — the fleet merger renders the
                    # cross-process flow as one timeline
                    # (docs/observability.md §"Fleet view").
                    tid = (self.headers.get("X-Photon-Trace-Id")
                           or new_trace_id())
                    # Tail-based sampling (docs/observability.md §"Tail
                    # sampling"): register the request so its spans buffer
                    # in the ring; the verdict comes after the root span
                    # closes — promote on threshold breach or error,
                    # discard the boring majority.
                    tail = obs_trace.tail_sampler()
                    if tail is not None:
                        tail.begin(tid)
                    try:
                        with trace_context(tid), \
                                trace_span("serve.request",
                                           cat="serving") as req_span:
                            self._score_traced(req_span)
                    finally:
                        if tail is not None:
                            status = req_span.args.get("status")
                            tail.finish(
                                tid, req_span.seconds,
                                # Sheds are fast, loud, and counted — a
                                # shed flood must not flood the trace too.
                                error=status is None or (
                                    int(status) >= 500
                                    and not req_span.args.get("shed")),
                            )
                finally:
                    with server._inflight_cv:
                        server._inflight -= 1
                        server._inflight_cv.notify_all()

            def _score_traced(self, req_span):
                t0 = time.perf_counter()
                try:
                    with trace_span("serve.admission",
                                    cat="serving") as adm_span:
                        payload = self._read_json()
                        # Pressure-aware load shedding (docs/robustness.md
                        # §"Memory pressure"): past the critical device-
                        # memory watermark, admitting more rows only
                        # manufactures the next OOM — shed with the same
                        # 503 + Retry-After contract as a full queue. The
                        # body is read FIRST (an unread body would desync
                        # the kept-alive connection).
                        if server.shed_for_memory_pressure():
                            raise Overloaded(
                                "device memory watermark over critical; "
                                "shedding until pressure drains")
                        version = server.registry.current
                        row = version.scorer.parse_request(payload)
                        deadline = (
                            time.monotonic() + server.request_timeout_s
                        )
                        fut = server.batcher.submit(
                            version, row, deadline=deadline
                        )
                    # The batcher fails the future at the deadline; the
                    # +1s slack only covers a dead worker missed by the
                    # crash drain — a waiter must NEVER outlive its budget
                    # by more than that.
                    score = fut.result(
                        timeout=server.request_timeout_s + 1.0
                    )
                except RequestError as e:
                    server._count(errors=1)
                    req_span.set(status=400)
                    self._reply(400, {"error": str(e)})
                    return
                except Overloaded as e:
                    # Load shed: bounded queue full. 503 + Retry-After is
                    # the contract a client-side retry policy needs.
                    server._count(shed=1)
                    req_span.set(status=503, shed=True)
                    self._reply(503, {"error": str(e), "shed": True},
                                headers=(("Retry-After", "1"),))
                    return
                except (DeadlineExceeded, FuturesTimeout, TimeoutError):
                    server._count(expired=1)
                    req_span.set(status=503, expired=True)
                    self._reply(503, {"error": "request deadline exceeded"},
                                headers=(("Retry-After", "1"),))
                    return
                except Exception as e:  # noqa: BLE001 - a 500, not a crash
                    server._count(errors=1)
                    req_span.set(status=500)
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                total = time.perf_counter() - t0
                server.latency.observe(total)
                server._count(requests=1)
                req_span.set(status=200)
                # Stage waterfall (docs/serving.md §"Latency waterfall"):
                # admission measured here, queue_wait/batch_assembly/
                # store_resolve/kernel carried back on the ScoreResult,
                # response = everything the stage clock didn't cover
                # (future handoff, reply serialization).
                stages = {"admission": adm_span.seconds}
                stages.update(getattr(score, "stages", None) or {})
                stages["response"] = max(0.0, total - sum(stages.values()))
                for stage, sec in stages.items():
                    server._stage_hist.observe(sec, stage=stage)
                out = {"score": score, "model_version": version.version}
                degraded = getattr(score, "degraded", ())
                if degraded:
                    # Fixed-effect-only fallback behind an open store
                    # breaker: a usable score, but the client deserves to
                    # know which coordinates are missing.
                    server._count(degraded=1)
                    out["degraded"] = sorted(degraded)
                if "uid" in payload:
                    out["uid"] = payload["uid"]
                headers = ()
                if (self.headers.get("X-Photon-Timing") or "").lower() in (
                        "1", "true", "yes", "on"):
                    # Server-Timing-style opt-in breakdown on the response
                    # — durations in ms, stage order = waterfall order.
                    parts = [f"{st};dur={sec * 1e3:.3f}"
                             for st, sec in stages.items()]
                    parts.append(f"total;dur={total * 1e3:.3f}")
                    headers = (("X-Photon-Timing", ", ".join(parts)),)
                self._reply(200, out, headers=headers)

            def _swap(self):
                try:
                    payload = self._read_json()
                    if not isinstance(payload, dict):
                        raise RequestError(
                            "request body must be a JSON object")
                    model_dir = payload.get("model_dir")
                    if not model_dir:
                        raise RequestError("model_dir required")
                    v = server.registry.swap(model_dir)
                except RequestError as e:
                    self._reply(400, {"error": str(e)})
                    return
                except Exception as e:  # noqa: BLE001 - bad push, keep old
                    server._count(errors=1)
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                server._count(swaps=1)
                if server.logger is not None:
                    server.logger.info(
                        "hot-swapped to version %d (%s)", v.version, model_dir
                    )
                self._reply(200, {"model_version": v.version})

            def _standby(self):
                """Pre-warm the NEXT version (docs/robustness.md §"Recovery
                time"): build + warm model_dir off the hot path so the
                following /admin/swap to the same directory is a pointer
                move with no model load or warmup."""
                try:
                    payload = self._read_json()
                    if not isinstance(payload, dict):
                        raise RequestError(
                            "request body must be a JSON object")
                    model_dir = payload.get("model_dir")
                    if not model_dir:
                        raise RequestError("model_dir required")
                    info = server.registry.prepare_standby(model_dir)
                except RequestError as e:
                    self._reply(400, {"error": str(e)})
                    return
                except Exception as e:  # noqa: BLE001 - bad dir, keep old
                    server._count(errors=1)
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                if server.logger is not None:
                    server.logger.info("standby prepared: %s", model_dir)
                self._reply(200, {"status": "prepared", **info})

            def _tune(self):
                """Hot-tune the micro-batcher (the control plane's damped
                autoscaling lever — docs/control.md §levers). Bounds are
                validated by ``MicroBatcher.reconfigure``; a bad value
                changes nothing."""
                try:
                    payload = self._read_json()
                    if not isinstance(payload, dict):
                        raise RequestError(
                            "request body must be a JSON object")
                    max_batch = payload.get("max_batch")
                    max_queue = payload.get("max_queue")
                    max_wait_ms = payload.get("max_wait_ms")
                    if (max_batch is None and max_queue is None
                            and max_wait_ms is None):
                        raise RequestError(
                            "max_batch, max_queue, or max_wait_ms required")
                    try:
                        cfg = server.batcher.reconfigure(
                            max_batch=(None if max_batch is None
                                       else int(max_batch)),
                            max_queue=(None if max_queue is None
                                       else int(max_queue)),
                            max_wait_ms=(None if max_wait_ms is None
                                         else float(max_wait_ms)),
                        )
                    except (TypeError, ValueError) as e:
                        raise RequestError(str(e)) from None
                except RequestError as e:
                    self._reply(400, {"error": str(e)})
                    return
                except Exception as e:  # noqa: BLE001 - keep old config
                    server._count(errors=1)
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                server._count(tunes=1)
                instant("serving.batcher_tuned", cat="serving", **cfg)
                if server.logger is not None:
                    server.logger.info(
                        "batcher tuned: max_batch=%d max_queue=%d "
                        "max_wait_ms=%.3f", cfg["max_batch"],
                        cfg["max_queue"], cfg["max_wait_ms"])
                # One actuation surface for the whole box: manual tunes
                # and the histogram autotuner act on the same batcher, so
                # the reply always reports the tuner's current choice.
                out = dict(cfg)
                out["autotune"] = (
                    server.autotuner.snapshot()
                    if server.autotuner is not None else {"enabled": False})
                self._reply(200, out)

            def _memory_shed(self):
                """Proactive device-memory shed (control plane's answer to
                a rising watermark, fired BEFORE the OOM ladder would).
                Spills every pinned sweep-cache byte — expendable by
                contract: spilled entries re-stream on next use."""
                n = int(self.headers.get("Content-Length") or 0)
                if n:
                    self.rfile.read(n)  # body carries nothing
                try:
                    out = server.shed_memory()
                except Exception as e:  # noqa: BLE001 - shed must not 500
                    server._count(errors=1)
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                server._count(memory_sheds=1)
                self._reply(200, out)

            def _replication_restart(self):
                """Journaled restart request for a dead replica tailer
                (the controller's ``replication_tailer_dead`` remediation;
                budget enforcement lives controller-side)."""
                n = int(self.headers.get("Content-Length") or 0)
                if n:
                    self.rfile.read(n)
                if server.replication is None:
                    self._reply(400, {
                        "error": "no replication tailer attached"})
                    return
                try:
                    out = server.replication.restart()
                except Exception as e:  # noqa: BLE001
                    server._count(errors=1)
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                if server.logger is not None:
                    server.logger.info(
                        "replication tailer restart requested "
                        "(restarted=%s)", out.get("restarted"))
                self._reply(200, out)

            def _patch(self):
                """Online model delta (docs/online.md §"Delta protocol"):
                changed-entity coefficient patches applied atomically to
                the current version's coefficient stores, device hot-set
                invalidated only for the patched entities. The publisher's
                X-Photon-Trace-Id (HttpPublisher attaches its publish
                span's id) carries through this handler's span and the
                serving.delta_applied instant, so the merged fleet
                timeline shows event→refresh→publish→apply as ONE flow."""
                tid = self.headers.get("X-Photon-Trace-Id")
                with trace_context(tid or new_trace_id()), \
                        trace_span("serve.patch", cat="serving"):
                    self._patch_traced()

            def _patch_traced(self):
                # At-least-once dedupe: HttpPublisher stamps each POST
                # with the delta's identity (seq + content digest); a
                # retry of a publish whose reply was lost replays the
                # FIRST application's result instead of double-applying —
                # patch_seq, patched_entities_total, and the
                # serving.delta_applied instant stay exactly-once. Keyed
                # on content, not bare seq: a restarted trainer
                # incarnation reuses low seqs for genuinely NEW deltas
                # (the trainer's replay contract), and those must apply.
                idem_key = self.headers.get("X-Photon-Idempotency-Key")
                if idem_key:
                    with server._patch_seen_lock:
                        cached = server._patch_seen.get(idem_key)
                        if cached is not None:
                            server._patch_seen.move_to_end(idem_key)
                    if cached is not None:
                        server._count(patch_duplicates=1)
                        if server.logger is not None:
                            server.logger.info(
                                "duplicate delta publish suppressed "
                                "(key=%s)", idem_key)
                        self._reply(200, {**cached, "duplicate": True})
                        return
                try:
                    payload = self._read_json()
                    from photon_tpu_torch.online.delta import ModelDelta

                    try:
                        delta = ModelDelta.from_wire(payload)
                    except ValueError as e:
                        raise RequestError(str(e)) from None
                    if not delta.patches:
                        raise RequestError("delta has no patches")
                    result = server.registry.apply_delta(
                        delta.raw_patches(), seq=delta.seq,
                        event_horizon=delta.event_horizon,
                    )
                except RequestError as e:
                    server._count(errors=1)
                    self._reply(400, {"error": str(e)})
                    return
                except ValueError as e:
                    # Validation refused the delta (unknown coordinate,
                    # over-wide patch): the producer's bug, nothing applied.
                    server._count(errors=1)
                    self._reply(400, {"error": str(e)})
                    return
                except Exception as e:  # noqa: BLE001 - bad push, keep old
                    server._count(errors=1)
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                server._count(patches=1)
                if idem_key:
                    with server._patch_seen_lock:
                        server._patch_seen[idem_key] = result
                        while len(server._patch_seen) > 256:
                            server._patch_seen.popitem(last=False)
                if server.logger is not None:
                    server.logger.info(
                        "applied delta patch_seq=%d (%d entities)",
                        result["patch_seq"], result["patched"],
                    )
                self._reply(200, result)

        self.httpd = _HTTPServer((host, port), Handler)
        self._loop_started = False
        self._serve_thread: Optional[threading.Thread] = None
        self._metrics_stop = threading.Event()
        self._metrics_thread: Optional[threading.Thread] = None
        # The flush loop runs for EITHER consumer: a JSONL path to append
        # to, or SLOs to judge on the flush cadence (an SLO-only server
        # must still evaluate periodically, not just at shutdown).
        if metrics_path or self.slo_config is not None:
            self._metrics_thread = threading.Thread(
                target=self._metrics_loop,
                args=(float(metrics_interval_s),),
                name="photon-serve-metrics",
                daemon=True,
            )
            self._metrics_thread.start()

    # ---------------------------------------------------------------- admin

    @property
    def address(self) -> tuple:
        return self.httpd.server_address[:2]

    def _count(self, **deltas) -> None:
        for k, d in deltas.items():
            self._counters[k].inc(d)

    @property
    def counters(self) -> dict:
        """Back-compat view of the old counter dict (registry-backed)."""
        return {k: int(c.value()) for k, c in self._counters.items()}

    def backend_name(self) -> str:
        """The device type serving this process's kernels (the registry's:
        ``cuda`` or ``cpu``)."""
        try:
            return self.registry.device.type
        except Exception:  # noqa: BLE001 - health must answer regardless
            return "unknown"

    def restart_counts(self) -> dict:
        """Process-wide restart/recovery counts by classified cause
        (``run_restarts_total`` + the scorer's kernel recoveries) for the
        health payload: ``{"total": N, "<cause>": n, ...}``."""
        out: dict = {"total": 0}
        for name in ("run_restarts_total", "serve_kernel_recoveries_total"):
            for labels, value in GLOBAL_REGISTRY.counter(name).collect():
                if not value:
                    continue
                out["total"] += int(value)
                key = labels.get("cause", "unclassified")
                out[key] = out.get(key, 0) + int(value)
        return out

    def freshness(self) -> dict:
        """Registry freshness watermarks (active version, last swap, last
        delta patch) for /healthz and the metrics snapshot."""
        try:
            return self.registry.freshness_snapshot()
        except Exception:  # noqa: BLE001 - harness fakes lack a registry
            return {}

    def memory_snapshot(self) -> dict:
        """Device-memory watchdog state (thresholds + last watermark) for
        the metrics snapshot (docs/robustness.md §"Memory pressure")."""
        try:
            from photon_tpu_torch.runtime.memory_guard import guard

            return guard().snapshot()
        except Exception:  # noqa: BLE001 - metrics must answer regardless
            return {}

    def recovery_snapshot(self) -> dict:
        """Recovery-time watermarks for /healthz (docs/robustness.md
        §"Recovery time"): the two latency gauges the zero-recompile stack
        stamps (None until first stamped) and standby readiness."""
        out: dict = {
            "restart_to_first_step_seconds": None,
            "swap_to_first_score_seconds": None,
        }
        try:
            for name in out:
                v = GLOBAL_REGISTRY.gauge(name).value()
                out[name] = v if v > 0 else None
        except Exception:  # noqa: BLE001 - health must answer regardless
            pass
        try:
            out["standby"] = self.registry.standby_snapshot()
        except Exception:  # noqa: BLE001 - harness fakes lack a registry
            out["standby"] = {"ready": False}
        return out

    def shed_memory(self) -> dict:
        """Unconditional proactive shed (``POST /admin/memory/shed``):
        spill ALL pinned sweep-cache bytes and resample the watermark.
        Unlike ``MemoryGuard.check`` this does not wait for high water —
        the control plane fires it on a watermark TREND, before the OOM
        ladder would have to act reactively. Spilled entries re-stream on
        next use: throughput cost, never a wrong answer."""
        from photon_tpu_torch.data.device_cache import shed_pins
        from photon_tpu_torch.runtime.memory_guard import guard

        freed = shed_pins(1 << 62)
        g = guard()
        sample = g.sample(force=True)
        instant("serving.memory_shed", cat="serving",
                freed_bytes=int(freed),
                watermark=(None if sample is None
                           else round(sample["watermark"], 4)))
        if self.logger is not None:
            self.logger.info(
                "proactive memory shed freed %d bytes", freed)
        return {
            "freed_bytes": int(freed),
            "watermark": (None if sample is None
                          else round(sample["watermark"], 4)),
            "available": sample is not None,
        }

    def shed_for_memory_pressure(self) -> bool:
        """Admission gate: shed once the device-memory watermark crosses
        critical (``runtime/memory_guard``; throttled sample, so this is a
        cached-float compare per request, not a device call)."""
        try:
            from photon_tpu_torch.runtime.memory_guard import guard

            return guard().should_shed()
        except Exception:  # noqa: BLE001 - shedding must never 500
            return False

    def degraded_reasons(self, version=None) -> list:
        """Why this (otherwise alive) server is serving worse answers:
        open/half-open circuit breakers (per-coordinate store breakers and
        the scorer's kernel breaker), device memory pressure over the
        high-water mark, and a dead or errored replication tailer (a
        replica whose state is permanently frozen must be drained by the
        router, not kept in rotation at an ever-staler watermark).
        Empty = fully healthy."""
        v = version if version is not None else self.registry.current
        reasons = []
        try:
            snap = v.scorer.breaker_snapshot()
        except Exception:  # noqa: BLE001 - harness fakes lack a scorer
            snap = {}
        for cid, s in sorted(snap.items()):
            if s.get("state") in ("open", "half_open"):
                kind = "kernel" if cid == "__kernel__" else f"store:{cid}"
                reasons.append(f"breaker_{s['state']}:{kind}")
        try:
            from photon_tpu_torch.runtime.memory_guard import guard

            if guard().under_pressure():
                reasons.append("memory_pressure")
        except Exception:  # noqa: BLE001 - health must answer regardless
            pass
        rep = getattr(self, "replication", None)
        if rep is not None:
            try:
                rsnap = rep.snapshot()
                if rsnap.get("error"):
                    # Refused delta or follow-loop crash: the tailer
                    # refuses to advance, so the watermark is frozen.
                    reasons.append("replication_error")
                elif rsnap.get("started") and not rsnap.get("running"):
                    # start() was called but the thread is gone without a
                    # deliberate stop(): dead tailer, frozen state.
                    reasons.append("replication_tailer_dead")
            except Exception:  # noqa: BLE001 - health must answer
                reasons.append("replication_unknown")
        return reasons

    @property
    def latency(self):
        """The live latency histogram — resolved through the registry
        metric so a registry reset can never orphan the server's view."""
        return self._latency.histogram

    def metrics_snapshot(self, advance_interval: bool = False) -> dict:
        """Live metrics. ``advance_interval`` moves the interval-rate
        window forward; only the periodic JSONL flush passes True, so an
        external scraper polling ``GET /metrics`` cannot shrink the window
        the persisted interval rate covers — scrapes see the rate since
        the last flush, read-only."""
        v = self.registry.current
        now = time.time()
        elapsed = max(now - self._started_at, 1e-9)
        # Interval rate (deltas between flushes): the lifetime
        # requests/uptime figure understates the CURRENT rate after any
        # idle period — a server idle overnight then serving 1k rows/s
        # would report ~0. Both are reported; dashboards want the interval
        # figure, capacity ledgers the lifetime one. Counter reads happen
        # INSIDE the lock so two concurrent snapshots can never observe a
        # window whose request delta went backwards (negative rate).
        with self._rate_lock:
            counters = self.counters
            dt = now - self._rate_prev_t
            dreq = counters["requests"] - self._rate_prev_requests
            if advance_interval:
                self._rate_prev_t = now
                self._rate_prev_requests = counters["requests"]
        interval_rate = round(dreq / dt, 2) if dt > 1e-3 else None
        return {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "model_version": v.version,
            "latency": self.latency.snapshot(),
            "throughput_rows_per_sec": round(
                counters["requests"] / elapsed, 2),
            "throughput_interval_rows_per_sec": interval_rate,
            "interval_s": round(dt, 3),
            **counters,
            "freshness": self.freshness(),
            "memory": self.memory_snapshot(),
            "batcher": self.batcher.snapshot(),
            "coefficient_caches": v.scorer.cache_snapshot(),
            "breakers": v.scorer.breaker_snapshot(),
            # getattr: harness fakes build servers via __new__ and only
            # set what they exercise
            **({"replication": self.replication.snapshot()}
               if getattr(self, "replication", None) is not None else {}),
            **({"slo": self._slo_last.to_dict()}
               if getattr(self, "_slo_last", None) is not None else {}),
        }

    def _metrics_loop(self, interval_s: float) -> None:
        while not self._metrics_stop.wait(interval_s):
            self.flush_metrics()

    def check_slos(self, snapshot: Optional[dict] = None) -> Optional[dict]:
        """Judge the configured SLOs against ``snapshot`` (or a fresh one;
        called at every flush + shutdown, and directly by benches/tests).
        Returns the report dict, or None without a config."""
        if self.slo_config is None:
            return None
        if snapshot is None:
            snapshot = self.metrics_snapshot()
        self._slo_last = self.slo_config.evaluate(snapshot, where="serving")
        if not self._slo_last.ok and self.logger is not None:
            self.logger.warning(
                "serving SLO violations: %s",
                [r.name for r in self._slo_last.violations])
        return self._slo_last.to_dict()

    def flush_metrics(self) -> None:
        # SLO judgment happens on the flush cadence whether or not a JSONL
        # path is configured — the violation counter and trace instants
        # are the contract; the JSONL record is one more consumer. ONE
        # snapshot serves both, so the persisted record and the SLO values
        # written beside it can never disagree (and the interval window
        # only advances when a record is actually persisted).
        if (self.slo_config is None and not self.metrics_path
                and not self.telemetry_shard_path):
            return
        snap = self.metrics_snapshot(
            advance_interval=bool(self.metrics_path))
        slo = self.check_slos(snapshot=snap)
        if slo is not None:
            snap = {**snap, "slo": slo}
        if self.metrics_path:
            write_metrics_jsonl(self.metrics_path, [snap])
        if self.telemetry_shard_path:
            # Live fleet view (docs/observability.md §"Live fleet view"):
            # export the registry shard on the flush cadence, not only at
            # exit, so the obs driver's /fleet sees this replica's
            # counters WHILE it serves. Atomic write + idempotent
            # per-shard_id merge make the re-export safe; best-effort by
            # the telemetry contract.
            try:
                from photon_tpu_torch.obs import fleet
                fleet.write_registry_shard(
                    self.telemetry_shard_path, registries=(self.metrics,))
            except Exception as e:  # noqa: BLE001 - evidence, never a failure
                if self.logger is not None:
                    self.logger.warning(
                        "live registry shard export failed: %s", e)

    def start(self) -> None:
        """Serve in a background thread (tests / embedded use)."""
        self._loop_started = True
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever,
            name="photon-serve-http",
            daemon=True,
        )
        self._serve_thread.start()

    def serve_forever(self) -> None:
        self._loop_started = True
        self.httpd.serve_forever()

    def attach_replication(self, tailer) -> None:
        """Expose a ``ReplicaTailer``'s watermark/lag on /healthz and the
        metrics snapshot (the serving driver's ``--delta-log`` replica
        mode wires this before serving starts)."""
        self.replication = tailer

    def shutdown(self, drain_timeout_s: float = 10.0) -> None:
        """Graceful drain (the SIGTERM contract, docs/serving.md):

        1. **Stop accepting** — the draining flag 503-sheds requests that
           arrive on already-open kept-alive connections, and the
           listening socket closes, so nothing new is admitted.
        2. **Finish in-flight batches** — wait (bounded by
           ``drain_timeout_s``) for every admitted /score handler to get
           its answer through the batcher before the worker goes away.
        3. **Close the batcher** — anything still queued past the
           deadline fails fast rather than hanging its waiter.
        4. **Flush telemetry** — the final metrics snapshot lands in the
           JSONL history (and SLOs are judged once more); the driver
           writes the registry telemetry shard right after this returns.
        """
        self._draining = True
        self._metrics_stop.set()
        if self._loop_started:
            # socketserver.shutdown() handshakes with serve_forever() and
            # would block forever if the loop never ran (build-only use).
            self.httpd.shutdown()
        self.httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=5.0)
        # Handler threads are daemons (never joined by server_close), so
        # the in-flight wait below is the ONLY thing standing between an
        # admitted request and a batcher teardown under its feet.
        deadline = time.monotonic() + float(drain_timeout_s)
        with self._inflight_cv:
            while self._inflight > 0 and time.monotonic() < deadline:
                self._inflight_cv.wait(timeout=0.1)
            leftover = self._inflight
        if leftover and self.logger is not None:
            self.logger.warning(
                "shutdown drain timed out with %d request(s) in flight",
                leftover)
        self.batcher.close()
        self.flush_metrics()
