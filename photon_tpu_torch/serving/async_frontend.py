"""Async front-end worker for the serving front line (docs/serving.md).

A copy of the JAX package's ``serving/async_frontend.py``: it imports neither JAX nor
torch, and ``tests/test_torch_frontline.py`` compares the code, so edit
both or neither.

One of N identical **accelerator-free** processes the scorer-side
:class:`~photon_tpu_torch.serving.frontline.FrontLine` supervisor spawns. Each
worker:

* binds the box's public scoring port with ``SO_REUSEPORT`` (the kernel
  load-balances accepted connections across workers — no userspace
  router in front of the box);
* speaks a hand-rolled asyncio HTTP/1.1 (keep-alive) edge accepting BOTH
  JSON ``POST /score`` bodies (the classic contract) and pre-encoded
  binary :mod:`wire` frames (``Content-Type: application/x-photon-wire``,
  the co-located fast lane) — a wire request gets a wire response;
* parses + pre-resolves rows itself: feature names resolve against the
  model's ``MmapIndexMap``s and entity keys are membership-checked
  against a **read-only mmap** of the exported ``CoefficientStore``
  (page cache shared with every sibling worker), so the scorer process
  receives only packed index/value arrays;
* forwards rows to the single device-owning scorer over the lock-free
  shared-memory ring (or unix-socket fallback) and maps wire statuses
  back onto the HTTP shed/deadline/drain contract.

The worker is deliberately **jax-free**: importing an accelerator
runtime here would multiply device memory by N and serialize startup
behind N× jit warmup — the entire point of the topology is that exactly
one process pays for the device.

Observability spans the process split (docs/observability.md): the
worker owns the worker-side stages (``admission`` / ``parse`` / ``ipc``
/ ``response``) in ITS registry shard (role ``frontend``); the scorer
owns queue_wait/batch_assembly/store_resolve/kernel in its own — merged,
every stage of the box waterfall is counted exactly once, and the
opt-in ``X-Photon-Timing`` response header reports all of them because
the scorer ships its stages back on every response frame. Tail sampling
promotes cross-process chains as a unit: the scorer judges its half
first and flags the frame; the worker forwards that verdict as
``force=`` to its own sampler.

Run as ``python -m photon_tpu_torch.serving.async_frontend`` (the FrontLine
supervisor builds the command line; it is also runnable by hand against
an exported ``frontline.json`` for debugging).
"""
from __future__ import annotations

import argparse
import asyncio
import itertools
import json
import logging
import os
import signal
import socket
import sys
import threading
import time
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from photon_tpu_torch.index.index_map import MmapIndexMap
from photon_tpu_torch.obs import trace as obs_trace
from photon_tpu_torch.obs.metrics import MetricsRegistry
from photon_tpu_torch.obs.trace import new_trace_id
from photon_tpu_torch.serving import ipc, wire
from photon_tpu_torch.serving.coefficient_store import CoefficientStore

log = logging.getLogger("photon_tpu_torch.frontend")

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found", 405: "Method Not "
    "Allowed", 500: "Internal Server Error", 503: "Service Unavailable",
}

# wire status -> (http code, counter outcome)
_STATUS_HTTP = {
    wire.STATUS_OK: (200, "ok"),
    wire.STATUS_BAD_REQUEST: (400, "bad_request"),
    wire.STATUS_OVERLOADED: (503, "shed"),
    wire.STATUS_DEADLINE: (503, "expired"),
    wire.STATUS_INTERNAL: (500, "error"),
    wire.STATUS_DRAINING: (503, "draining"),
}


class ParseError(ValueError):
    """Client-side request defect (HTTP 400)."""


class RowParser:
    """JSON request → pre-resolved :class:`wire.WireRow`, mirroring
    ``RowScorer.parse_request`` semantics exactly (same bags, same
    intercept injection, same unindexed-feature drop, same nnz cap) —
    tests assert score parity between the two paths.

    Entity keys are additionally membership-checked against the
    worker's read-only store mmap; a verified miss is flagged
    ``KNOWN_MISS`` so the scorer can skip the dead lookup — but only
    while the store generation still matches (``check_miss`` flips off
    the moment the scorer reports a newer generation, because a delta
    may have ADDED the entity the worker's stale export lacks)."""

    def __init__(self, manifest: dict):
        self.k = int(manifest["max_row_nnz"])
        self.generation = int(manifest["generation"])
        self.request_timeout_s = float(manifest["request_timeout_s"])
        self.model_version = int(manifest["model_version"])
        self.check_miss = True
        self.shards: dict[str, tuple] = {}
        for name, cfg in manifest["shards"].items():
            imap = MmapIndexMap(cfg["index_dir"])
            imap.preload()
            self.shards[name] = (
                imap, list(cfg["feature_bags"]), cfg["intercept_index"],
                int(cfg["dim"]))
        self.re: dict[str, tuple] = {}
        for cid, rcfg in manifest["re_coordinates"].items():
            store = CoefficientStore.load(rcfg["store_dir"], mmap=True)
            self.re[cid] = (rcfg["re_type"], store)

    def parse(self, payload) -> wire.WireRow:
        if not isinstance(payload, dict):
            raise ParseError("request body must be a JSON object")
        shard_idx, shard_val = {}, {}
        for shard, (imap, bags, icpt, dim) in self.shards.items():
            idxs, vals = [], []
            if icpt is not None:
                idxs.append(int(icpt))
                vals.append(1.0)
            for bag in bags:
                feats = payload.get(bag)
                if feats is None:
                    continue
                if not isinstance(feats, (list, tuple)):
                    raise ParseError(f"feature bag {bag!r} must be a list")
                for feat in feats:
                    try:
                        i = imap.get_index(feat["name"], feat.get("term"))
                        v = float(feat["value"])
                    except (TypeError, KeyError, ValueError) as e:
                        raise ParseError(
                            f"bad feature entry in bag {bag!r}: {e}"
                        ) from None
                    if i >= 0:  # unindexed features dropped, as the reader
                        idxs.append(i)
                        vals.append(v)
            if len(idxs) > self.k:
                raise ParseError(
                    f"row has {len(idxs)} features in shard {shard!r}; "
                    f"serving caps rows at max_row_nnz={self.k} "
                    "(raise the knob, don't truncate)")
            row_i = np.full(self.k, dim, np.int32)
            row_v = np.zeros(self.k, np.float32)
            row_i[: len(idxs)] = idxs
            row_v[: len(vals)] = vals
            shard_idx[shard] = row_i
            shard_val[shard] = row_v
        entities = payload.get("entities") or {}
        if not isinstance(entities, dict):
            raise ParseError('"entities" must be a map of RE type -> id')
        keys, miss = {}, set()
        for cid, (re_type, store) in self.re.items():
            key = entities.get(re_type)
            if key is None:
                key = payload.get(re_type)  # top-level fallback, as reader
            if key is None:
                keys[cid] = None
                continue
            key = str(key)
            keys[cid] = key
            if self.check_miss:
                try:
                    if store.lookup(key) is None:
                        miss.add(cid)
                except Exception:  # noqa: BLE001 - sick mmap: let scorer decide
                    pass
        try:
            offset = float(payload.get("offset") or 0.0)
        except (TypeError, ValueError):
            raise ParseError("offset must be a number") from None
        return wire.WireRow(
            shard_idx=shard_idx, shard_val=shard_val, offset=offset,
            entity_keys=keys, known_miss=frozenset(miss))


class ScorerClient:
    """This worker's end of the IPC link: one response-reader thread
    resolves asyncio futures by req_id; sends are non-blocking against
    the ring (``RingFull`` backpressure becomes an async backoff, never
    an event-loop stall)."""

    def __init__(self, channel, loop: asyncio.AbstractEventLoop):
        self._chan = channel
        self._ring = isinstance(channel, ipc.RingChannel)
        self._loop = loop
        self._pending: dict[int, asyncio.Future] = {}
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self.closed = False
        self._reader = threading.Thread(
            target=self._read_loop, name="photon-fe-reader", daemon=True)
        self._reader.start()

    def next_id(self) -> int:
        return next(self._ids)

    def _read_loop(self) -> None:
        while not self.closed:
            try:
                frame = self._chan.recv(timeout=0.5)
            except ipc.TransportClosed:
                break
            if frame is None:
                continue
            try:
                kind, req_id = wire.frame_kind(frame)
                if kind == wire.KIND_SCORE_RESP:
                    result = wire.decode_score_response(frame)
                elif kind in (wire.KIND_CTL_RESP, wire.KIND_HEARTBEAT):
                    result = wire.decode_control(frame)[2]
                else:
                    continue
            except wire.WireError as e:
                log.warning("dropping undecodable frame: %s", e)
                continue
            with self._lock:
                fut = self._pending.pop(req_id, None)
            if fut is not None:
                self._loop.call_soon_threadsafe(self._resolve, fut, result)
        self.closed = True
        with self._lock:
            pending, self._pending = dict(self._pending), {}
        for fut in pending.values():
            self._loop.call_soon_threadsafe(
                self._reject, fut, ipc.TransportClosed("scorer link down"))

    @staticmethod
    def _resolve(fut: asyncio.Future, result) -> None:
        if not fut.done():
            fut.set_result(result)

    @staticmethod
    def _reject(fut: asyncio.Future, exc: BaseException) -> None:
        if not fut.done():
            fut.set_exception(exc)

    async def _send(self, frame: bytes, budget_s: float = 0.25) -> None:
        if not self._ring:
            # Unix-socket sends complete in one syscall at these frame
            # sizes; the kernel buffer is the backpressure.
            self._chan.send(frame, timeout=5.0)
            return
        deadline = time.monotonic() + budget_s
        while True:
            try:
                self._chan.send(frame, timeout=0)
                return
            except ipc.RingFull:
                if time.monotonic() >= deadline:
                    raise
                await asyncio.sleep(0.002)

    async def request(self, frame: bytes, req_id: int, timeout: float):
        if self.closed:
            raise ipc.TransportClosed("scorer link down")
        fut = self._loop.create_future()
        with self._lock:
            self._pending[req_id] = fut
        try:
            await self._send(frame)
            return await asyncio.wait_for(fut, timeout)
        finally:
            with self._lock:
                self._pending.pop(req_id, None)

    async def control(self, payload: dict, timeout: float = 5.0,
                      kind: int = wire.KIND_CTL_REQ) -> dict:
        rid = self.next_id()
        return await self.request(
            wire.encode_control(kind, rid, payload), rid, timeout)

    def close(self) -> None:
        self.closed = True
        self._chan.close()


class FrontendWorker:
    def __init__(self, worker_id: int, parser: RowParser,
                 client: ScorerClient, *, host: str, port: int,
                 heartbeat_s: float = 1.0,
                 telemetry_dir: Optional[str] = None):
        self.worker_id = worker_id
        self.parser = parser
        self.client = client
        self.host = host
        self.port = port
        self.heartbeat_s = float(heartbeat_s)
        self.telemetry_dir = telemetry_dir
        self.served = 0
        self.inflight = 0
        self.draining = False
        self._box_health: dict = {}
        self._box_health_at = 0.0
        self._server: Optional[asyncio.AbstractServer] = None
        self._stopped = asyncio.Event()
        self.metrics = MetricsRegistry()
        self._requests = self.metrics.counter(
            "frontend_http_requests_total",
            "HTTP requests at this front-end worker, by outcome")
        self._stage_hist = self.metrics.histogram(
            "serve_stage_latency_seconds",
            "worker-side stage waterfall: admission / parse / ipc / "
            "response (this shard owns ONLY the worker stages; the "
            "scorer shard owns queue_wait/batch_assembly/store_resolve/"
            "kernel — merged, each stage counts once)")
        self._latency = self.metrics.histogram(
            "frontend_request_latency_seconds",
            "end-to-end worker-observed /score latency (successful)")
        self._ring_stalls = self.metrics.counter(
            "frontend_ipc_backpressure_total",
            "score requests shed because the scorer ring stayed full "
            "past the send budget")
        self.metrics.gauge_fn(
            "frontend_inflight", lambda: float(self.inflight),
            "requests currently inside this worker")

    # ----------------------------------------------------------- HTTP edge

    async def start(self) -> None:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # SO_REUSEPORT is the whole load-balancing story: every worker
        # binds the same (host, port) and the kernel spreads accepts.
        if hasattr(socket, "SO_REUSEPORT"):
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        sock.bind((self.host, self.port))
        sock.setblocking(False)
        self._server = await asyncio.start_server(self._serve_conn,
                                                  sock=sock)

    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                t0 = time.perf_counter()
                line = await reader.readline()
                if not line:
                    return
                try:
                    method, target, proto = (
                        line.decode("latin-1").strip().split(" ", 2))
                except ValueError:
                    return
                headers = {}
                while True:
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = h.decode("latin-1").partition(":")
                    headers[k.strip().lower()] = v.strip()
                n = int(headers.get("content-length") or 0)
                body = await reader.readexactly(n) if n else b""
                conn = headers.get("connection", "").lower()
                keep = (conn != "close"
                        and (proto == "HTTP/1.1" or conn == "keep-alive"))
                code, extra, out, ctype = await self._dispatch(
                    method, target, headers, body, t0)
                writer.write(_http_response(code, out, ctype=ctype,
                                            extra=extra, keep=keep))
                await writer.drain()
                if not keep:
                    return
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            return
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001 - peer already gone
                pass

    async def _dispatch(self, method, target, headers, body, t0):
        url = urlparse(target)
        path = url.path
        if path == "/score" and method == "POST":
            return await self._score(headers, body, t0)
        if path == "/healthz" and method == "GET":
            return await self._healthz()
        if path == "/metrics" and method == "GET":
            return self._metrics(parse_qs(url.query))
        if path == "/admin/tune" and method == "POST":
            return await self._tune(body)
        code = 405 if path in ("/score", "/admin/tune", "/healthz",
                               "/metrics") else 404
        return _json(code, {"error": f"no route {method} {path}"})

    # --------------------------------------------------------------- score

    async def _score(self, headers, body, t0):
        tid = headers.get("x-photon-trace-id") or new_trace_id()
        tail = obs_trace.tail_sampler()
        if tail is not None:
            tail.begin(tid)
        admission = time.perf_counter() - t0
        if self.draining:
            self._requests.inc(outcome="draining")
            self._tail_done(tail, tid, t0, error=False)
            return _json(503, {"error": "worker draining", "shed": True},
                         extra=(("Retry-After", "1"),))
        wants_wire = wire.is_wire(body) or headers.get(
            "content-type", "").startswith(wire.WIRE_CONTENT_TYPE)
        p0 = time.perf_counter()
        client_req_id = 0
        deadline_ms = 0.0
        try:
            if wants_wire:
                creq = wire.decode_score_request(body)
                rows = creq.rows
                client_req_id = creq.req_id
                deadline_ms = creq.deadline_ms
                # The client encoded against ITS store knowledge; only a
                # frame claiming our export's generation may keep its
                # known-miss flags through the scorer's gate.
                gen = creq.store_generation or self.parser.generation
            else:
                payload = json.loads(body.decode("utf-8"))
                rows = [self.parser.parse(payload)]
                gen = self.parser.generation
        except (ParseError, wire.WireError, UnicodeDecodeError,
                json.JSONDecodeError) as e:
            self._requests.inc(outcome="bad_request")
            self._tail_done(tail, tid, t0, error=False)
            return _json(400, {"error": str(e)})
        parse_s = time.perf_counter() - p0

        i0 = time.perf_counter()
        rid = self.client.next_id()
        frame = wire.encode_score_request(
            rows, req_id=rid, trace_id=tid, deadline_ms=deadline_ms,
            store_generation=gen)
        self.inflight += 1
        try:
            resp = await self.client.request(
                frame, rid, timeout=self.parser.request_timeout_s + 1.0)
        except ipc.RingFull:
            self._ring_stalls.inc()
            self._requests.inc(outcome="shed")
            self._tail_done(tail, tid, t0, error=False)
            return _json(503, {"error": "scorer ring backpressure",
                               "shed": True},
                         extra=(("Retry-After", "1"),))
        except asyncio.TimeoutError:
            self._requests.inc(outcome="expired")
            self._tail_done(tail, tid, t0, error=False)
            return _json(503, {"error": "request deadline exceeded"},
                         extra=(("Retry-After", "1"),))
        except ipc.TransportClosed:
            self._requests.inc(outcome="error")
            self._tail_done(tail, tid, t0, error=True)
            return _json(503, {"error": "scorer unavailable"},
                         extra=(("Retry-After", "1"),))
        finally:
            self.inflight -= 1
        ipc_total = time.perf_counter() - i0

        code, outcome = _STATUS_HTTP.get(resp.status, (500, "error"))
        self._requests.inc(outcome=outcome)
        total = time.perf_counter() - t0
        # Worker-side waterfall. The scorer's stages happened INSIDE the
        # ipc window, so the worker's ipc stage reports only the transport
        # overhead (encode + ring + decode + future handoff) — stages must
        # tile the request, never double-cover it.
        scorer_s = sum((resp.stages or {}).values())
        stages = {
            "admission": admission,
            "parse": parse_s,
            "ipc": max(0.0, ipc_total - scorer_s),
        }
        if code == 200:
            full = {"admission": admission, "parse": parse_s,
                    **(resp.stages or {}), "ipc": stages["ipc"]}
            full["response"] = max(0.0, total - sum(full.values()))
            stages["response"] = full["response"]
            for st, sec in stages.items():
                self._stage_hist.observe(sec, stage=st)
            self._latency.observe(total)
            self.served += 1
            col = obs_trace.active_collector()
            if col is not None:
                base = t0
                for st in ("admission", "parse", "ipc"):
                    col.complete(f"frontend.{st}", "serving", base,
                                 stages[st], {"trace_id": tid})
                    base += stages[st]
                col.complete("frontend.request", "serving", t0, total,
                             {"trace_id": tid, "worker": self.worker_id})
        promoted = self._tail_done(
            tail, tid, t0, error=code >= 500 and outcome == "error",
            force=resp.trace_promoted)
        extra = []
        if code == 200 and (headers.get("x-photon-timing", "").lower()
                            in ("1", "true", "yes", "on")):
            parts = [f"{st};dur={sec * 1e3:.3f}"
                     for st, sec in full.items()]
            parts.append(f"total;dur={total * 1e3:.3f}")
            extra.append(("X-Photon-Timing", ", ".join(parts)))
        extra.append(("X-Photon-Worker", str(self.worker_id)))

        if wants_wire:
            flags = resp.flags | (
                wire.RESP_FLAG_TRACE_PROMOTED if promoted else 0)
            out = wire.encode_score_response(
                client_req_id, status=resp.status, error=resp.error,
                retry_after_s=resp.retry_after_s,
                model_version=resp.model_version, flags=flags,
                scores=resp.scores, degraded=resp.degraded,
                stages=(full if code == 200 else resp.stages))
            return code, tuple(extra), out, wire.WIRE_CONTENT_TYPE
        if code != 200:
            payload_out = {"error": resp.error}
            if outcome in ("shed", "draining"):
                payload_out["shed"] = True
                extra.append(("Retry-After",
                              str(max(1, int(resp.retry_after_s or 1)))))
            return _json(code, payload_out, extra=tuple(extra))
        out = {"score": float(resp.scores[0]),
               "model_version": resp.model_version}
        if resp.degraded and resp.degraded[0]:
            out["degraded"] = sorted(resp.degraded[0])
        if not wants_wire and "uid" in payload:
            out["uid"] = payload["uid"]
        return _json(200, out, extra=tuple(extra))

    def _tail_done(self, tail, tid, t0, error: bool,
                   force: bool = False) -> bool:
        if tail is None:
            return force
        return tail.finish(tid, time.perf_counter() - t0, error=error,
                           force=force)

    # ------------------------------------------------------------- control

    async def _healthz(self):
        health = await self._box_health_fresh()
        if not health:
            return _json(503, {
                "status": "unhealthy", "role": "frontend",
                "worker_id": self.worker_id,
                "degraded": ["scorer_unreachable"], "pid": os.getpid()})
        health = dict(health)
        health.update({
            "role": "frontend", "worker_id": self.worker_id,
            "pid": os.getpid(), "served": self.served,
            "worker_draining": self.draining,
        })
        code = 503 if health.get("status") == "unhealthy" else 200
        return _json(code, health)

    async def _box_health_fresh(self, max_age_s: float = 2.0) -> dict:
        if time.monotonic() - self._box_health_at <= max_age_s:
            return self._box_health
        try:
            health = await self.client.control({"op": "healthz"},
                                               timeout=3.0)
        except (ipc.TransportClosed, asyncio.TimeoutError, ipc.RingFull):
            return {}
        self._box_health = health
        self._box_health_at = time.monotonic()
        return health

    def _metrics(self, query: dict):
        if (query.get("format") or [""])[0] == "prom":
            text = self.metrics.to_prometheus()
            return 200, (), text.encode("utf-8"), "text/plain; version=0.0.4"
        tail = obs_trace.tail_sampler()
        return _json(200, {
            "role": "frontend", "worker_id": self.worker_id,
            "pid": os.getpid(), "served": self.served,
            "inflight": self.inflight, "draining": self.draining,
            "store_generation": self.parser.generation,
            "known_miss_active": self.parser.check_miss,
            "tail_sampler": tail.snapshot() if tail is not None else None,
            "metrics": self.metrics.snapshot(),
        })

    async def _tune(self, body: bytes):
        try:
            payload = json.loads(body.decode("utf-8")) if body else {}
            if not isinstance(payload, dict):
                raise ValueError("request body must be a JSON object")
        except (ValueError, UnicodeDecodeError) as e:
            return _json(400, {"error": str(e)})
        try:
            reply = await self.client.control(
                {"op": "tune", **payload}, timeout=5.0)
        except (ipc.TransportClosed, asyncio.TimeoutError, ipc.RingFull):
            return _json(503, {"error": "scorer unavailable"})
        if reply.pop("bad_request", None):
            return _json(400, reply)
        return _json(200, {**reply, "proxied_by_worker": self.worker_id})

    # ----------------------------------------------------------- lifecycle

    async def run(self) -> None:
        loop = asyncio.get_running_loop()
        hello = await self.client.control(
            {"op": "hello", "worker_id": self.worker_id,
             "pid": os.getpid()}, timeout=10.0)
        gen = int(hello.get("generation", self.parser.generation))
        if gen != self.parser.generation:
            self.parser.check_miss = False
        await self.start()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(
                sig, lambda: asyncio.ensure_future(self.shutdown()))
        hb = asyncio.ensure_future(self._heartbeat_loop())
        log.info("frontend worker %d serving on %s:%d (pid %d, %s)",
                 self.worker_id, self.host, self.port, os.getpid(),
                 "shm ring" if isinstance(self.client._chan,
                                          ipc.RingChannel) else "socket")
        await self._stopped.wait()
        hb.cancel()

    async def _heartbeat_loop(self) -> None:
        boss = os.getppid()  # the scorer process that spawned us
        misses = 0
        while not self._stopped.is_set():
            if os.getppid() != boss:
                # Re-parented to init: the scorer died. A socket link
                # reports this as TransportClosed, but a shm ring has no
                # peer-death signal — without this check a SIGKILLed
                # scorer leaves orphan workers squatting the REUSEPORT
                # group, answering 503 forever next to its replacement.
                log.error("scorer process gone (orphaned); exiting")
                await self.shutdown()
                return
            try:
                reply = await self.client.control(
                    {"op": "heartbeat", "worker_id": self.worker_id,
                     "served": self.served}, timeout=3.0)
                misses = 0
                if reply.get("health"):
                    self._box_health = reply["health"]
                    self._box_health_at = time.monotonic()
                gen = reply.get("generation")
                if gen is not None and int(gen) != self.parser.generation:
                    self.parser.check_miss = False
            except (ipc.TransportClosed, asyncio.TimeoutError,
                    ipc.RingFull):
                misses += 1
                if self.client.closed or misses >= 5:
                    log.error("scorer link down (%d missed heartbeats); "
                              "exiting", misses)
                    await self.shutdown()
                    return
            self._export_shard()
            try:
                await asyncio.wait_for(self._stopped.wait(),
                                       timeout=self.heartbeat_s)
            except asyncio.TimeoutError:
                pass

    def _export_shard(self) -> None:
        """Live fleet view (docs/observability.md §"Fleet view"): flush
        this worker's registry shard every heartbeat, same convention as
        the scoring server's flush loop."""
        if not self.telemetry_dir:
            return
        try:
            from photon_tpu_torch.obs import fleet

            fleet.write_registry_shard(
                os.path.join(
                    self.telemetry_dir,
                    f"registry.frontend.{os.getpid()}.json"),
                registries=[self.metrics], role="frontend",
                extra={"worker_id": self.worker_id})
        except Exception as e:  # noqa: BLE001 - evidence, never a failure mode
            log.debug("shard export failed: %s", e)

    async def shutdown(self, grace_s: float = 10.0) -> None:
        if self.draining:
            return
        self.draining = True
        log.info("worker %d draining (%d inflight)", self.worker_id,
                 self.inflight)
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        deadline = time.monotonic() + grace_s
        while self.inflight > 0 and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
        self._export_shard()
        self._stopped.set()


def _http_response(code: int, body: bytes, *, ctype: str = "application/"
                   "json", extra=(), keep: bool = True) -> bytes:
    head = [
        f"HTTP/1.1 {code} {_REASONS.get(code, 'OK')}",
        f"Content-Type: {ctype}",
        f"Content-Length: {len(body)}",
        f"Connection: {'keep-alive' if keep else 'close'}",
    ]
    for k, v in extra:
        head.append(f"{k}: {v}")
    return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body


def _json(code: int, payload: dict, extra=()):
    return (code, tuple(extra), json.dumps(payload).encode("utf-8"),
            "application/json")


def build_channel(spec: str, worker_id: int):
    """``shm:<token>`` → attach the scorer-created ring pair;
    ``sock:<path>`` → connect the unix-socket fallback."""
    scheme, _, arg = spec.partition(":")
    if scheme == "shm":
        return ipc.attach_worker_rings(arg, worker_id)
    if scheme == "sock":
        return ipc.SocketChannel.connect(arg)
    raise ValueError(f"unknown ipc spec {spec!r} (want shm:… or sock:…)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="photon-tpu async serving front-end worker")
    ap.add_argument("--manifest", required=True,
                    help="frontline.json written by ModelRegistry."
                         "export_frontline")
    ap.add_argument("--worker-id", type=int, required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--ipc", required=True,
                    help="shm:<token> | sock:<path>")
    ap.add_argument("--heartbeat-s", type=float, default=1.0)
    ap.add_argument("--telemetry-dir", default=None)
    ap.add_argument("--trace-out", default=None)
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format=f"%(asctime)s fe{args.worker_id} %(levelname)s %(message)s")
    assert "jax" not in sys.modules, (
        "front-end workers must stay jax-free; an import above pulled in "
        "the accelerator runtime")

    from photon_tpu_torch.cli import params

    params.enable_telemetry(args, role="frontend")
    params.enable_trace(args.trace_out)
    if obs_trace.tail_sampler() is None:
        obs_trace.install_tail_sampler(obs_trace._env_tail_sampler())

    with open(args.manifest) as f:
        manifest = json.load(f)
    parser = RowParser(manifest)
    channel = build_channel(args.ipc, args.worker_id)

    async def _amain() -> None:
        loop = asyncio.get_running_loop()
        client = ScorerClient(channel, loop)
        worker = FrontendWorker(
            args.worker_id, parser, client, host=args.host, port=args.port,
            heartbeat_s=args.heartbeat_s, telemetry_dir=args.telemetry_dir)
        try:
            await worker.run()
        finally:
            client.close()

    try:
        asyncio.run(_amain())
        return 0
    finally:
        params.finish_trace(args.trace_out)


if __name__ == "__main__":
    sys.exit(main())
