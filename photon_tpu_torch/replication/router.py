"""The staleness- and pressure-aware routing front door.

A copy of the JAX package's ``replication/router.py`` (it imports neither
torch nor JAX); ``tests/test_torch_replication.py`` compares the code, so
edit both or neither.

:class:`RouterServer` fronts N serving replicas: a thin stdlib HTTP
process (no model, no torch — it boots in milliseconds and never competes
with replicas for the accelerator) that

* **health-checks** every replica on a cadence (``GET /healthz``),
  reading the status, the degraded-reason list, and the replication
  block's seq watermark;
* **weights** ``/score`` traffic by staleness: a replica's weight is
  ``1 / (1 + staleness_penalty * seq_lag)`` against the freshest
  watermark in the pool, so a converged replica takes proportionally
  more traffic than one still replaying its backlog;
* **drains** replicas reporting ``degraded`` (open breakers, memory
  pressure — docs/robustness.md) or an unhealthy/unreachable state:
  weight 0 while the condition holds, traffic restored automatically by
  the next clean health check. When EVERY replica is degraded the router
  serves through them anyway (a degraded answer beats no answer);
* **retries** idempotent reads: a connect failure (or a 503 shed) on one
  replica re-dispatches the same request to the next-best replica,
  bounded by ``retries`` — a killed replica costs its in-flight requests
  one retry, not an error;
* **forwards** ``X-Photon-Trace-Id`` (minting one when absent), so a
  routed request renders as router → replica one flow in the merged
  fleet timeline.

Routes: ``POST /score`` (balanced), ``GET /healthz`` (the router's view
of the pool; 503 when no replica is reachable), ``GET /metrics`` (JSON,
``?format=prom`` for text exposition).
"""
from __future__ import annotations

import http.client
import json
import math
import random
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

from photon_tpu_torch.obs import (
    MetricsRegistry,
    REGISTRY as GLOBAL_REGISTRY,
    new_trace_id,
    trace_context,
    trace_span,
)

_CONNECT_ERRORS = (ConnectionError, TimeoutError, OSError)


class _ReplicaState:
    """The router's last-known view of one replica."""

    def __init__(self, url: str):
        self.url = url.rstrip("/")
        self.reachable = False
        self.status = "unknown"          # ok | degraded | unhealthy | ...
        self.degraded: list = []
        self.seq_watermark: Optional[int] = None
        self.lag: Optional[int] = None
        self.model_version: Optional[int] = None
        self.last_check_ts: Optional[float] = None
        self.consecutive_failures = 0
        # Keep-alive probe connection, owned by the health thread only.
        self.conn: Optional[http.client.HTTPConnection] = None

    def snapshot(self) -> dict:
        return {
            "url": self.url,
            "reachable": self.reachable,
            "status": self.status,
            "degraded": list(self.degraded),
            "seq_watermark": self.seq_watermark,
            "lag": self.lag,
            "model_version": self.model_version,
            "last_check_ts": self.last_check_ts,
            "consecutive_failures": self.consecutive_failures,
        }


class RouterServer:
    """Health-checked, staleness-weighted ``/score`` fan-in (module doc)."""

    def __init__(
        self,
        replicas: Sequence[str],
        host: str = "127.0.0.1",
        port: int = 0,
        health_interval_s: float = 1.0,
        health_timeout_s: float = 2.0,
        staleness_penalty: float = 0.25,
        retries: int = 1,
        timeout_s: float = 30.0,
        logger=None,
        seed: Optional[int] = None,
    ):
        if not replicas:
            raise ValueError("router needs >= 1 replica URL")
        self.logger = logger
        self.health_interval_s = float(health_interval_s)
        self.health_timeout_s = float(health_timeout_s)
        self.staleness_penalty = float(staleness_penalty)
        self.retries = int(retries)
        self.timeout_s = float(timeout_s)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._replicas = [_ReplicaState(u) for u in replicas]
        self._started_at = time.time()
        self.metrics = MetricsRegistry()
        self._requests_c = self.metrics.counter(
            "router_requests_total", "routed /score requests by outcome")
        self._upstream_c = self.metrics.counter(
            "router_upstream_requests_total",
            "requests dispatched to each replica")
        self._retries_c = self.metrics.counter(
            "router_retries_total",
            "idempotent reads re-dispatched to another replica")
        self._upstream_err_c = self.metrics.counter(
            "router_upstream_errors_total",
            "connect failures / sheds per replica")
        self._health_conn_c = self.metrics.counter(
            "router_health_probes_total",
            "health probes by transport (reused keep-alive vs new TCP)")
        self._latency = self.metrics.histogram(
            "router_request_latency_seconds",
            "end-to-end routed /score latency (successes)")
        # Per-dispatch upstream latency labeled by outcome, so a retry
        # storm (ok collapsing into retry) and a shed flood are
        # distinguishable in ONE Prometheus scrape: ok = 200 on the first
        # attempt, retry = 200 after re-dispatch, shed = upstream 503
        # re-dispatched, error = connect failure or non-200 relay.
        self._upstream_latency = self.metrics.histogram(
            "router_upstream_latency_seconds",
            "per-dispatch upstream latency by outcome "
            "(ok/retry/shed/error)")
        for outcome in ("ok", "retry", "shed", "error"):
            # Registered empty at startup: a warm-up scrape reads four
            # zero-count series, never "metric missing".
            self._upstream_latency.child(outcome=outcome)
        self.metrics.gauge_fn(
            "router_healthy_replicas",
            lambda: sum(1 for r in self._routable()),
            "replicas currently eligible for traffic")
        self.metrics.gauge_fn(
            "router_known_replicas", lambda: len(self._replicas),
            "replicas configured on this router")
        # Per-replica drain state as a LABELED gauge (1 = receiving no
        # traffic: unreachable, unhealthy, or degraded-drained), so the
        # control plane and the fleet report read drain posture from one
        # registry scrape instead of a /healthz fan-out.
        self._drained_g = self.metrics.gauge(
            "router_drained_replicas",
            "1 when the labeled replica is excluded from routing")
        # Startup registration (docs/observability.md §"Gauge warm-up"):
        # every configured replica starts DRAINED (1) until its first
        # clean health sweep proves otherwise — a scrape during warm-up
        # reads the honest posture, never "metric missing".
        for r in self._replicas:
            self._drained_g.set(1.0, replica=r.url)
        router = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                if router.logger is not None:
                    router.logger.debug("router http: " + fmt, *args)

            def _reply(self, code: int, payload, headers=()) -> None:
                body = payload if isinstance(payload, bytes) \
                    else json.dumps(payload).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path, _, query = self.path.partition("?")
                if path == "/healthz":
                    snap = router.health_snapshot()
                    self._reply(
                        200 if snap["status"] != "unhealthy" else 503, snap)
                elif path == "/metrics":
                    if "prom" in query:
                        body = router.metrics.to_prometheus(
                            extra=GLOBAL_REGISTRY).encode("utf-8")
                        self.send_response(200)
                        self.send_header(
                            "Content-Type",
                            "text/plain; version=0.0.4; charset=utf-8")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    else:
                        self._reply(200, router.metrics_snapshot())
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path != "/score":
                    n = int(self.headers.get("Content-Length") or 0)
                    if n:
                        self.rfile.read(n)
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b"{}"
                tid = self.headers.get("X-Photon-Trace-Id") or new_trace_id()
                timing = (self.headers.get("X-Photon-Timing")
                          or "").lower() in ("1", "true", "yes", "on")
                with trace_context(tid), \
                        trace_span("router.request", cat="router") as sp:
                    code, payload, hdrs = router.route_score(
                        body, tid, sp, timing=timing)
                self._reply(code, payload, headers=hdrs)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self._loop_started = False
        self._serve_thread: Optional[threading.Thread] = None
        self._health_stop = threading.Event()
        self._health_thread = threading.Thread(
            target=self._health_loop, name="photon-router-health",
            daemon=True)
        self._health_thread.start()

    # --------------------------------------------------------------- health

    @property
    def address(self) -> tuple:
        return self.httpd.server_address[:2]

    def _health_loop(self) -> None:
        self.check_replicas()
        while not self._health_stop.wait(self.health_interval_s):
            self.check_replicas()

    def check_replicas(self) -> None:
        """One health sweep (also callable synchronously from tests).
        Never raises: the health thread runs for the router's whole
        life, and a single replica answering garbage must not freeze the
        pool view forever."""
        for r in self._replicas:
            try:
                self._check_one(r)
            except Exception as e:  # noqa: BLE001 - keep the loop alive
                if self.logger is not None:
                    self.logger.warning(
                        "health check of %s failed unexpectedly: %s: %s",
                        r.url, type(e).__name__, e)
                with self._lock:
                    r.status = "unhealthy"
                    r.consecutive_failures += 1
                    r.last_check_ts = time.time()
        # Stamp drain posture once per sweep (not per request): the gauge
        # answers "who is out of rotation RIGHT NOW" at sweep granularity,
        # which is exactly the granularity the pool view updates at.
        with self._lock:
            states = [(r.url, r.reachable and r.status == "ok"
                       and not r.degraded) for r in self._replicas]
        for url, routable in states:
            self._drained_g.set(0.0 if routable else 1.0, replica=url)

    def _health_fetch(self, r: _ReplicaState) -> tuple:
        """``GET /healthz`` over the replica's cached keep-alive
        connection; returns ``(status_code, body_bytes)``.

        The sweep probes every replica every ``health_interval_s`` for
        the router's whole life — a fresh TCP handshake per probe is
        pure per-sweep overhead that, on a busy box, competes with
        scoring traffic for accept cycles and keeps the
        ``router_upstream_latency_seconds`` floor higher than it needs
        to be. The connection lives on the replica state; concurrent
        sweeps hand it off atomically. A REUSED socket that fails
        mid-probe gets one fresh-connection retry (the upstream may have
        idle-closed it between sweeps) before the failure counts; a
        fresh socket failing is a real connect failure and raises.
        """
        last_exc: Optional[BaseException] = None
        for _ in range(2):
            with self._lock:
                # Atomic take: tests drive check_replicas() concurrently
                # with the health thread's initial sweep, and two probes
                # sharing one socket would interleave their frames.
                conn, r.conn = r.conn, None
            reused = conn is not None
            if conn is None:
                u = urllib.parse.urlsplit(r.url)
                conn = http.client.HTTPConnection(
                    u.hostname, u.port, timeout=self.health_timeout_s)
            try:
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                raw = resp.read()  # drain fully or the next probe desyncs
            except _CONNECT_ERRORS + (http.client.HTTPException,) as e:
                conn.close()
                last_exc = e
                if reused:
                    continue  # retry once on a fresh socket
                raise
            if resp.will_close:
                conn.close()
            else:
                with self._lock:
                    if r.conn is None:
                        r.conn = conn
                    else:      # a concurrent probe already parked one
                        conn.close()
            self._health_conn_c.inc(
                1, transport="reused" if reused else "new")
            return resp.status, raw
        raise last_exc  # fresh-socket retry also failed

    def _check_one(self, r: _ReplicaState) -> None:
        try:
            code, raw = self._health_fetch(r)
        except _CONNECT_ERRORS + (http.client.HTTPException,
                                  urllib.error.URLError):
            with self._lock:
                r.reachable = False
                r.status = "unreachable"
                r.consecutive_failures += 1
                r.last_check_ts = time.time()
            return
        # Parse OUTSIDE the fetch try: a 200 carrying a non-JSON body (a
        # proxy error page, a half-written reply) or malformed fields must
        # degrade THIS replica, not kill the health thread.
        try:
            payload = json.loads(raw)
            if not isinstance(payload, dict):
                raise ValueError(f"healthz body is {type(payload).__name__}")
            status = payload.get("status") or \
                ("ok" if code == 200 else "unhealthy")
            degraded = list(payload.get("degraded") or ())
            rep = payload.get("replication") or {}
            watermark = (int(rep["seq_watermark"])
                         if rep.get("seq_watermark") is not None else None)
            lag = int(rep.get("lag") or 0) if watermark is not None else None
            fresh = payload.get("freshness") or {}
            version = (int(fresh["model_version"])
                       if fresh.get("model_version") is not None else None)
        except (ValueError, TypeError, AttributeError) as e:
            if self.logger is not None:
                self.logger.warning(
                    "unparseable /healthz from %s (HTTP %d): %s",
                    r.url, code, e)
            with self._lock:
                r.reachable = True        # it answered — just uselessly
                r.status = "unhealthy"    # drained until it answers sanely
                r.consecutive_failures += 1
                r.last_check_ts = time.time()
            return
        with self._lock:
            r.reachable = True
            r.consecutive_failures = 0
            r.last_check_ts = time.time()
            r.status = status
            r.degraded = degraded
            if watermark is not None:
                r.seq_watermark = watermark
                r.lag = lag
            if version is not None:
                r.model_version = version

    # -------------------------------------------------------------- routing

    def _routable(self) -> list:
        """Replicas eligible for traffic: reachable, healthy, undrained."""
        with self._lock:
            pool = list(self._replicas)
        return [r for r in pool
                if r.reachable and r.status == "ok" and not r.degraded]

    def _weights(self, exclude=()) -> list:
        """(replica, weight) pairs for one pick. Staleness-weighted over
        the routable pool; when that pool is empty, degrade to ANY
        reachable non-unhealthy replica at uniform weight (a stale or
        pressured answer beats refusing everyone)."""
        pool = [r for r in self._routable() if r not in exclude]
        if not pool:
            with self._lock:
                pool = [r for r in self._replicas
                        if r.reachable and r.status != "unhealthy"
                        and r not in exclude]
            return [(r, 1.0) for r in pool]
        marks = [r.seq_watermark for r in pool
                 if r.seq_watermark is not None]
        head = max(marks) if marks else None
        out = []
        for r in pool:
            if head is None or r.seq_watermark is None:
                w = 1.0
            else:
                w = 1.0 / (1.0 + self.staleness_penalty
                           * max(0, head - r.seq_watermark))
            out.append((r, w))
        return out

    def _pick(self, exclude=()):
        weighted = self._weights(exclude=exclude)
        if not weighted:
            return None
        total = sum(w for _, w in weighted)
        x = self._rng.uniform(0.0, total)
        for r, w in weighted:
            x -= w
            if x <= 0:
                return r
        return weighted[-1][0]

    def route_score(self, body: bytes, trace_id: str, span,
                    timing: bool = False) -> tuple:
        """Dispatch one /score read; returns (code, payload-bytes, hdrs).
        Connect failures and 503 sheds retry on the NEXT-best replica
        (scores are idempotent reads) up to ``retries`` times. With
        ``timing`` the X-Photon-Timing opt-in is forwarded upstream and
        the router hop is prepended to the replica's stage breakdown."""
        t0 = time.perf_counter()
        tried: list = []
        last_err: Optional[str] = None
        for attempt in range(self.retries + 1):
            r = self._pick(exclude=tried)
            if r is None:
                break
            if attempt:
                self._retries_c.inc()
            tried.append(r)
            self._upstream_c.inc(1, replica=r.url)
            a0 = time.perf_counter()
            try:
                headers = {"Content-Type": "application/json",
                           "X-Photon-Trace-Id": trace_id}
                if timing:
                    headers["X-Photon-Timing"] = "1"
                req = urllib.request.Request(
                    r.url + "/score", data=body, method="POST",
                    headers=headers)
                with urllib.request.urlopen(
                        req, timeout=self.timeout_s) as resp:
                    payload = resp.read()
                    code = resp.status
                    upstream_timing = resp.headers.get("X-Photon-Timing")
            except urllib.error.HTTPError as e:
                payload = e.read()
                code = e.code
                upstream_timing = e.headers.get("X-Photon-Timing")
                if code == 503 and attempt < self.retries:
                    # A shed (queue full, memory pressure, draining):
                    # idempotent read, another replica may have room.
                    self._upstream_latency.observe(
                        time.perf_counter() - a0, outcome="shed")
                    self._upstream_err_c.inc(1, replica=r.url,
                                             kind="shed")
                    last_err = f"{r.url} shed (503)"
                    continue
            except _CONNECT_ERRORS + (urllib.error.URLError,) as e:
                # Connect failure: mark it down NOW (don't wait for the
                # health sweep) and retry elsewhere.
                self._upstream_latency.observe(
                    time.perf_counter() - a0, outcome="error")
                self._upstream_err_c.inc(1, replica=r.url, kind="connect")
                with self._lock:
                    r.reachable = False
                    r.status = "unreachable"
                    r.consecutive_failures += 1
                last_err = f"{r.url}: {type(e).__name__}: {e}"
                span.set(retried=True)
                continue
            # Success or a non-retryable client/server answer: relay it.
            upstream_s = time.perf_counter() - a0
            outcome = "ok" if code == 200 else f"http_{code}"
            self._upstream_latency.observe(
                upstream_s,
                outcome=("ok" if code == 200 and not attempt else
                         "retry" if code == 200 else "error"))
            self._requests_c.inc(1, outcome=outcome)
            total = time.perf_counter() - t0
            if code == 200:
                self._latency.histogram.observe(total)
            span.set(status=code, replica=r.url, attempts=attempt + 1)
            hdrs = ()
            if timing:
                # router hop = everything spent in front of the replica
                # (pick, failed attempts, proxying) — total minus the
                # answering attempt's upstream wall time.
                hop = max(0.0, total - upstream_s)
                breakdown = f"router;dur={(hop * 1e3):.3f}"
                if upstream_timing:
                    breakdown += ", " + upstream_timing
                hdrs = (("X-Photon-Timing", breakdown),)
            return code, payload, hdrs
        self._requests_c.inc(1, outcome="no_replica")
        span.set(status=503, attempts=len(tried))
        return 503, {
            "error": "no replica available"
                     + (f" (last: {last_err})" if last_err else ""),
        }, (("Retry-After", self._retry_after_hint()),)

    def _retry_after_hint(self) -> str:
        """Retry-After for pool exhaustion, derived from the HEALTHIEST
        replica's probe schedule instead of a fixed constant: the pool
        view can only improve at that replica's next health sweep, so the
        honest hint is the time until ``last_check_ts +
        health_interval_s`` — a client told "1" against a 30 s sweep would
        hammer a door that cannot open yet. Clamped to >= 1 s (ceil)."""
        now = time.time()
        with self._lock:
            checked = [r for r in self._replicas
                       if r.last_check_ts is not None]
            if not checked:
                return str(max(1, math.ceil(self.health_interval_s)))
            best = min(checked,
                       key=lambda r: (r.consecutive_failures,
                                      -(r.last_check_ts or 0.0)))
            eta = (best.last_check_ts + self.health_interval_s) - now
        return str(max(1, math.ceil(eta)))

    # ------------------------------------------------------------ snapshots

    def health_snapshot(self) -> dict:
        with self._lock:
            reps = [r.snapshot() for r in self._replicas]
        routable = sum(1 for r in self._routable())
        reachable = sum(1 for r in reps if r["reachable"])
        status = "ok" if routable else (
            "degraded" if reachable else "unhealthy")
        marks = [r["seq_watermark"] for r in reps
                 if r["seq_watermark"] is not None]
        return {
            "status": status,
            "routable": routable,
            "reachable": reachable,
            "replicas": reps,
            "head_seq_watermark": max(marks) if marks else None,
            "uptime_s": round(time.time() - self._started_at, 1),
        }

    def metrics_snapshot(self) -> dict:
        return {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "latency": self._latency.histogram.snapshot(),
            "metrics": self.metrics.snapshot(),
            "health": self.health_snapshot(),
        }

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        self._loop_started = True
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever,
            name="photon-router-http", daemon=True)
        self._serve_thread.start()

    def serve_forever(self) -> None:
        self._loop_started = True
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        self._health_stop.set()
        if self._loop_started:
            self.httpd.shutdown()
        self.httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=5.0)
        self._health_thread.join(timeout=5.0)
        for r in self._replicas:  # drop cached keep-alive probe sockets
            if r.conn is not None:
                r.conn.close()
                r.conn = None
