"""Scorer-side front line: the IPC service + worker supervision.

A copy of the JAX package's ``serving/frontline.py`` (it imports no JAX;
its workers run ``photon_tpu_torch.serving.async_frontend``). The front
line splits the serving box into N
accelerator-free async front-end workers and ONE device-owning scorer
process. This module is the scorer's half:

* :class:`FrontLine` exports the registry's coefficient stores + parse
  manifest for the workers (``ModelRegistry.export_frontline``), creates
  one IPC channel per worker (lock-free shm rings when the box has POSIX
  shared memory, unix-socket fallback otherwise), spawns + supervises the
  worker processes (liveness via heartbeats, bounded journaled restarts),
  and answers their wire frames;
* per-link service threads decode :mod:`wire` score requests into
  ``ParsedRow``s and feed the EXISTING micro-batcher — warm standby, the
  circuit breakers, OOM downshift, pressure shedding, and graceful drain
  all apply to front-line traffic exactly as they do to the threaded
  server's, because it is literally the same batcher and registry;
* responses carry the scorer-side stage waterfall (queue_wait /
  batch_assembly / store_resolve / kernel) and the scorer's tail-sampling
  verdict, so the worker can stamp a full cross-process waterfall and
  force-promote its half of the trace chain.

Metric ownership is partitioned by process to keep the fleet merge
honest: the scorer observes ONLY the scorer-side stages into
``serve_stage_latency_seconds`` (the autotuner's live signal); workers
observe only worker-side stages (admission / parse / ipc / response).
Merged across shards, each stage of the box-level waterfall is counted
exactly once.
"""
from __future__ import annotations

import json
import os
import secrets
import signal
import subprocess
import sys
import threading
import time
from typing import Optional

import numpy as np

from photon_tpu_torch.obs import trace as obs_trace
from photon_tpu_torch.obs.trace import trace_context
from photon_tpu_torch.serving import ipc, wire
from photon_tpu_torch.serving.batcher import DeadlineExceeded, Overloaded
from photon_tpu_torch.serving.scorer import ParsedRow

_HEARTBEAT_STALE_S = 3.0
_RESTART_WINDOW_S = 60.0
_MAX_RESTARTS_PER_WINDOW = 3


def pick_port(host: str = "127.0.0.1") -> int:
    """A currently-free TCP port. The front line needs ONE concrete port
    shared by every worker (SO_REUSEPORT); 'bind 0 and see' per worker
    would scatter them."""
    import socket as _socket

    with _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


class _WorkerLink:
    """Supervisor-side state for one front-end worker."""

    def __init__(self, worker_id: int, channel):
        self.worker_id = worker_id
        self.channel = channel
        self.proc: Optional[subprocess.Popen] = None
        self.pid: Optional[int] = None
        self.state = "starting"      # starting | live | dead | restarting
        self.last_seen = time.monotonic()
        self.hello = threading.Event()
        self.served = 0
        self.errors = 0
        self.restarts: list = []     # monotonic restart timestamps
        self.log_path: Optional[str] = None

    def snapshot(self) -> dict:
        return {
            "worker_id": self.worker_id,
            "pid": self.pid,
            "state": self.state,
            "seconds_since_seen": round(
                time.monotonic() - self.last_seen, 2),
            "served": self.served,
            "errors": self.errors,
            "restarts": len(self.restarts),
        }


class FrontLine:
    """Runs the multi-process serving box around an existing
    :class:`ScoringServer` (which keeps serving its own port as the box's
    admin plane — /admin/swap, /admin/patch, /metrics all stay there;
    scoring traffic enters through the workers' shared port)."""

    def __init__(
        self,
        server,
        *,
        workers: int = 2,
        host: str = "127.0.0.1",
        port: int = 8080,
        runtime_dir: str,
        transport: str = "auto",   # auto | shm | socket
        autotuner=None,
        telemetry_dir: Optional[str] = None,
        journal=None,
        logger=None,
        ring_bytes: int = ipc.DEFAULT_RING_BYTES,
    ):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.server = server
        self.registry = server.registry
        self.batcher = server.batcher
        self.n_workers = int(workers)
        self.host = host
        self.port = int(port)
        self.runtime_dir = runtime_dir
        self.telemetry_dir = telemetry_dir
        self.journal = journal
        self.logger = logger
        self.autotuner = autotuner
        self.ring_bytes = int(ring_bytes)
        self.token = secrets.token_hex(4)
        if transport == "auto":
            transport = "shm" if ipc.shm_available() else "socket"
        if transport not in ("shm", "socket"):
            raise ValueError(f"unknown transport {transport!r}")
        self.transport = transport
        self._listener: Optional[ipc.SocketListener] = None
        self._links: dict[int, _WorkerLink] = {}
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._started = False
        self.manifest: Optional[dict] = None
        from photon_tpu_torch.obs.metrics import REGISTRY

        self._ipc_requests = REGISTRY.counter(
            "serve_frontline_requests_total",
            "wire score requests handled by the scorer IPC service, "
            "by outcome")
        self._known_miss_skips = REGISTRY.counter(
            "serve_frontline_known_miss_skips_total",
            "entity-store lookups skipped because a worker verified the "
            "key absent at a matching store generation")
        self._restart_counter = REGISTRY.counter(
            "serve_frontline_worker_restarts_total",
            "front-end worker processes restarted by the supervisor")

    # ------------------------------------------------------------- lifecycle

    @property
    def address(self) -> tuple:
        return (self.host, self.port)

    def start(self, ready_timeout_s: float = 30.0) -> None:
        os.makedirs(self.runtime_dir, exist_ok=True)
        self.manifest = self.registry.export_frontline(self.runtime_dir)
        if self.transport == "socket":
            self._listener = ipc.SocketListener(
                os.path.join(self.runtime_dir, "frontline.sock"))
            accept_t = threading.Thread(
                target=self._accept_loop, name="photon-fl-accept",
                daemon=True)
            accept_t.start()
            self._threads.append(accept_t)
        for i in range(self.n_workers):
            link = _WorkerLink(i, None)
            if self.transport == "shm":
                link.channel = ipc.create_worker_rings(
                    self.token, i, capacity=self.ring_bytes)
            self._links[i] = link
            self._spawn(link)
            if link.channel is not None:
                self._start_link_thread(link)
        deadline = time.monotonic() + ready_timeout_s
        for link in self._links.values():
            remaining = deadline - time.monotonic()
            if not link.hello.wait(timeout=max(0.1, remaining)):
                tail = self._log_tail(link)
                self.stop(drain=False)
                raise RuntimeError(
                    f"front-end worker {link.worker_id} (pid {link.pid}) "
                    f"never reported ready within {ready_timeout_s:.0f}s"
                    + (f"; last log lines:\n{tail}" if tail else "")
                )
        monitor = threading.Thread(
            target=self._monitor_loop, name="photon-fl-monitor", daemon=True)
        monitor.start()
        self._threads.append(monitor)
        if self.autotuner is not None:
            self.autotuner.start()
        self._started = True
        if self.logger is not None:
            self.logger.info(
                "front line up: %d worker(s) on http://%s:%d over %s "
                "(runtime %s, store generation %d)",
                self.n_workers, self.host, self.port, self.transport,
                self.runtime_dir, self.manifest["generation"])

    def stop(self, drain: bool = True, timeout_s: float = 10.0) -> None:
        self._stop.set()
        if self.autotuner is not None:
            self.autotuner.stop()
        for link in self._links.values():
            if link.proc is not None and link.proc.poll() is None:
                try:
                    link.proc.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        deadline = time.monotonic() + timeout_s
        for link in self._links.values():
            if link.proc is None:
                continue
            try:
                link.proc.wait(timeout=max(0.1,
                                           deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                link.proc.kill()
                link.proc.wait(timeout=5.0)
            link.state = "dead"
        for link in self._links.values():
            if link.channel is not None:
                link.channel.close()
        if self._listener is not None:
            self._listener.close()

    # --------------------------------------------------------------- workers

    def _worker_cmd(self, link: _WorkerLink) -> list:
        if self.transport == "shm":
            spec = f"shm:{self.token}"
        else:
            spec = f"sock:{self._listener.path}"
        cmd = [
            sys.executable, "-m", "photon_tpu_torch.serving.async_frontend",
            "--manifest", os.path.join(self.runtime_dir, "frontline.json"),
            "--worker-id", str(link.worker_id),
            "--host", self.host,
            "--port", str(self.port),
            "--ipc", spec,
        ]
        if self.telemetry_dir:
            cmd += ["--telemetry-dir", self.telemetry_dir]
        return cmd

    def _spawn(self, link: _WorkerLink) -> None:
        link.log_path = os.path.join(
            self.runtime_dir, f"worker-{link.worker_id}.log")
        log = open(link.log_path, "ab")
        try:
            link.proc = subprocess.Popen(
                self._worker_cmd(link), stdout=log, stderr=log,
                env=dict(os.environ))
        finally:
            log.close()
        link.pid = link.proc.pid
        link.state = "starting"
        link.last_seen = time.monotonic()
        self._write_worker_table()

    def _log_tail(self, link: _WorkerLink, n: int = 15) -> str:
        try:
            with open(link.log_path, "r", errors="replace") as f:
                return "".join(f.readlines()[-n:])
        except OSError:
            return ""

    def _write_worker_table(self) -> None:
        """``frontline-workers.json`` next to the manifest: pids + states
        for operators and the chaos drill (which needs a pid to SIGKILL)."""
        path = os.path.join(self.runtime_dir, "frontline-workers.json")
        try:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"port": self.port,
                           "scorer_pid": os.getpid(),
                           "workers": [l.snapshot()
                                       for l in self._links.values()]},
                          f, indent=2)
            os.replace(tmp, path)
        except OSError:
            pass

    def _accept_loop(self) -> None:
        """Socket fallback: workers connect and introduce themselves with
        a hello control frame carrying their worker id."""
        while not self._stop.is_set():
            ch = self._listener.accept()
            if ch is None:
                return
            try:
                frame = ch.recv(timeout=5.0)
                kind, req_id, payload = wire.decode_control(frame)
                wid = int(payload["worker_id"])
                link = self._links[wid]
            except Exception:  # noqa: BLE001 - a bad client must not kill accept
                ch.close()
                continue
            link.channel = ch
            self._handle_control(link, req_id, payload)
            self._start_link_thread(link)

    def _start_link_thread(self, link: _WorkerLink) -> None:
        t = threading.Thread(
            target=self._serve_link, args=(link,),
            name=f"photon-fl-w{link.worker_id}", daemon=True)
        t.start()
        self._threads.append(t)

    def _monitor_loop(self) -> None:
        while not self._stop.wait(0.25):
            for link in list(self._links.values()):
                if link.proc is None:
                    continue
                exited = link.proc.poll() is not None
                stale = (time.monotonic() - link.last_seen
                         > _HEARTBEAT_STALE_S)
                if link.state == "live" and (exited or stale) and exited:
                    self._on_worker_death(link)

    def _on_worker_death(self, link: _WorkerLink) -> None:
        rc = link.proc.returncode
        link.state = "dead"
        if self.logger is not None:
            self.logger.warning(
                "front-end worker %d (pid %s) died (rc=%s)",
                link.worker_id, link.pid, rc)
        if self.journal is not None:
            self.journal.record(
                "frontline_worker_exit", worker_id=link.worker_id,
                pid=link.pid, returncode=rc)
        now = time.monotonic()
        link.restarts = [t for t in link.restarts
                         if now - t < _RESTART_WINDOW_S]
        if self._stop.is_set():
            return
        if len(link.restarts) >= _MAX_RESTARTS_PER_WINDOW:
            if self.logger is not None:
                self.logger.error(
                    "worker %d exceeded %d restarts in %.0fs; leaving it "
                    "down (surviving workers keep the port)",
                    link.worker_id, _MAX_RESTARTS_PER_WINDOW,
                    _RESTART_WINDOW_S)
            self._write_worker_table()
            return
        link.restarts.append(now)
        link.hello.clear()
        link.state = "restarting"
        # shm rings survive a worker death (the scorer owns them); a
        # restarted worker re-attaches to the same segments. Any frames
        # the dead worker left half-consumed are bounded by the ring and
        # drained by the link thread as usual.
        self._restart_counter.inc()
        if self.journal is not None:
            self.journal.record(
                "frontline_worker_restart", worker_id=link.worker_id)
        self._spawn(link)

    # ------------------------------------------------------------ link serve

    def _serve_link(self, link: _WorkerLink) -> None:
        while not self._stop.is_set():
            try:
                frame = link.channel.recv(timeout=0.5)
            except ipc.TransportClosed:
                return
            if frame is None:
                continue
            link.last_seen = time.monotonic()
            try:
                kind, req_id = wire.frame_kind(frame)
            except wire.WireError:
                link.errors += 1
                continue
            try:
                if kind == wire.KIND_SCORE_REQ:
                    self._handle_score(link, frame)
                elif kind in (wire.KIND_CTL_REQ, wire.KIND_HEARTBEAT):
                    _, _, payload = wire.decode_control(frame)
                    self._handle_control(link, req_id, payload)
            except ipc.TransportClosed:
                return
            except Exception as e:  # noqa: BLE001 - one bad frame, not the link
                link.errors += 1
                try:
                    link.channel.send(wire.encode_score_response(
                        req_id, status=wire.STATUS_INTERNAL,
                        error=f"{type(e).__name__}: {e}"))
                except Exception:  # noqa: BLE001 - peer may be gone
                    pass

    # --------------------------------------------------------------- scoring

    def _wire_to_parsed(self, req: wire.ScoreRequest, scorer) -> list:
        """Validate + convert wire rows to ``ParsedRow``s. The arrays come
        pre-resolved and pre-padded; the scorer still bounds-checks every
        index (a worker — or a binary-edge client — is trusted for
        EFFORT, never for MEMORY SAFETY: a bad column id would gather
        garbage coefficients)."""
        k = scorer.config.max_row_nnz
        gen_match = (req.store_generation
                     == self.registry.store_generation)
        rows = []
        for row in req.rows:
            shard_idx, shard_val = {}, {}
            for shard in scorer._shards_used:
                idx = row.shard_idx.get(shard)
                val = row.shard_val.get(shard)
                if idx is None or val is None:
                    raise wire.WireError(
                        f"frame is missing feature shard {shard!r}")
                if idx.shape[0] != k:
                    raise wire.WireError(
                        f"shard {shard!r} row width {idx.shape[0]} != "
                        f"serving max_row_nnz {k}")
                dim = len(scorer.index_maps[shard])
                if idx.min(initial=0) < 0 or idx.max(initial=0) > dim:
                    raise wire.WireError(
                        f"feature index out of range for shard {shard!r} "
                        f"(dim {dim})")
                shard_idx[shard] = idx
                shard_val[shard] = val
            keys = {}
            for cid in scorer._re_types:
                key = row.entity_keys.get(cid)
                if key is not None and gen_match and cid in row.known_miss:
                    # Worker verified the key absent at this generation:
                    # skip the store lookup, go straight to the
                    # fixed-effect fallback (same score either way).
                    self._known_miss_skips.inc()
                    key = None
                keys[cid] = key
            rows.append(ParsedRow(
                shard_idx=shard_idx, shard_val=shard_val,
                offset=row.offset, entity_keys=keys))
        return rows

    def _handle_score(self, link: _WorkerLink, frame: bytes) -> None:
        t0 = time.perf_counter()
        server = self.server
        req = wire.decode_score_request(frame)
        tid = req.trace_id or None
        if server._draining:
            link.channel.send(wire.encode_score_response(
                req.req_id, status=wire.STATUS_DRAINING,
                error="server draining", retry_after_s=1.0))
            return
        tail = obs_trace.tail_sampler()
        if tail is not None and tid:
            tail.begin(tid)
        version = self.registry.current
        try:
            if server.shed_for_memory_pressure():
                raise Overloaded(
                    "device memory watermark over critical; shedding "
                    "until pressure drains")
            rows = self._wire_to_parsed(req, version.scorer)
            timeout_s = (req.deadline_ms / 1e3 if req.deadline_ms > 0
                         else server.request_timeout_s)
            deadline = time.monotonic() + timeout_s
            with server._inflight_cv:
                server._inflight += len(rows)
            futs = []
            try:
                with trace_context(tid):
                    for row in rows:
                        futs.append(self.batcher.submit(
                            version, row, deadline=deadline))
            except BaseException:
                # Never cancel() a submitted future — the batcher worker
                # set_results unconditionally and a cancelled future would
                # poison its whole batch. Let already-submitted rows score
                # and release their inflight slot on completion.
                with server._inflight_cv:
                    server._inflight -= len(rows) - len(futs)
                    server._inflight_cv.notify_all()

                def _release(_f):
                    with server._inflight_cv:
                        server._inflight -= 1
                        server._inflight_cv.notify_all()

                for f in futs:
                    f.add_done_callback(_release)
                raise
        except wire.WireError as e:
            self._finish_tail(tail, tid, t0, error=False)
            self._respond_error(link, req.req_id, wire.STATUS_BAD_REQUEST,
                                str(e))
            return
        except Overloaded as e:
            server._count(shed=1)
            self._finish_tail(tail, tid, t0, error=False)
            self._respond_error(link, req.req_id, wire.STATUS_OVERLOADED,
                                str(e), retry_after_s=1.0)
            return
        except Exception as e:  # noqa: BLE001 - a 500-class reply, not a crash
            server._count(errors=1)
            self._finish_tail(tail, tid, t0, error=True)
            self._respond_error(link, req.req_id, wire.STATUS_INTERNAL,
                                f"{type(e).__name__}: {e}")
            return
        pending = _PendingScore(self, link, req, version, futs, t0, tail)
        for f in futs:
            f.add_done_callback(pending.one_done)

    def _respond_error(self, link, req_id, status, error,
                       retry_after_s: float = 0.0) -> None:
        link.errors += 1
        self._ipc_requests.inc(outcome=_OUTCOMES.get(status, "error"))
        try:
            link.channel.send(wire.encode_score_response(
                req_id, status=status, error=error,
                retry_after_s=retry_after_s))
        except (ipc.TransportClosed, ipc.RingFull):
            pass

    def _finish_tail(self, tail, tid, t0, error: bool) -> bool:
        if tail is None or not tid:
            return False
        return tail.finish(tid, time.perf_counter() - t0, error=error)

    # --------------------------------------------------------------- control

    def workers_snapshot(self) -> list:
        return [link.snapshot() for link in self._links.values()]

    def _box_health(self) -> dict:
        """The scorer-side health block workers embed in their /healthz:
        the single-process /healthz fields PLUS the worker table, so ANY
        worker can report a degraded sibling (SO_REUSEPORT means the
        caller cannot choose which worker answers)."""
        server = self.server
        v = self.registry.current
        degraded = server.degraded_reasons(v)
        workers = self.workers_snapshot()
        for w in workers:
            if w["state"] != "live":
                degraded = list(degraded) + [
                    f"frontline_worker_{w['worker_id']}_{w['state']}"]
        return {
            "status": ("unhealthy" if not self.batcher.healthy
                       else "degraded" if degraded else "ok"),
            "degraded": degraded,
            "draining": server._draining,
            "model_version": v.version,
            "model_dir": v.model_dir,
            "backend": server.backend_name(),
            "store_generation": self.registry.store_generation,
            "freshness": server.freshness(),
            "recovery": server.recovery_snapshot(),
            "batcher": self.batcher.snapshot(),
            "workers": workers,
        }

    def _handle_control(self, link: _WorkerLink, req_id: int,
                        payload: dict) -> None:
        op = payload.get("op")
        if op == "hello":
            link.pid = payload.get("pid", link.pid)
            link.state = "live"
            link.hello.set()
            self._write_worker_table()
            if self.journal is not None:
                self.journal.record("frontline_worker_joined",
                                    worker_id=link.worker_id, pid=link.pid)
            reply = {"ok": True,
                     "generation": self.registry.store_generation,
                     "model_version": self.registry.current.version}
        elif op == "heartbeat":
            link.served = int(payload.get("served", link.served))
            if link.state == "starting":
                link.state = "live"
            reply = {"ok": True,
                     "draining": self.server._draining,
                     "generation": self.registry.store_generation,
                     "health": self._box_health()}
        elif op == "healthz":
            reply = self._box_health()
        elif op == "tune":
            reply = self._ctl_tune(payload)
        else:
            reply = {"error": f"unknown control op {op!r}"}
        try:
            link.channel.send(
                wire.encode_control(wire.KIND_CTL_RESP, req_id, reply))
        except (ipc.TransportClosed, ipc.RingFull):
            pass

    def _ctl_tune(self, payload: dict) -> dict:
        """The /admin/tune proxy target: ONE
        actuation surface for the whole box — a worker forwards the HTTP
        body here, the scorer's batcher applies it, and the reply reports
        the autotuner's current choice alongside."""
        try:
            cfg = self.batcher.reconfigure(
                max_batch=(None if payload.get("max_batch") is None
                           else int(payload["max_batch"])),
                max_queue=(None if payload.get("max_queue") is None
                           else int(payload["max_queue"])),
                max_wait_ms=(None if payload.get("max_wait_ms") is None
                             else float(payload["max_wait_ms"])),
            )
        except (TypeError, ValueError) as e:
            return {"error": str(e), "bad_request": True}
        self.server._count(tunes=1)
        from photon_tpu_torch.obs import instant

        instant("serving.batcher_tuned", cat="serving", **cfg)
        return {
            **cfg,
            "autotune": (self.autotuner.snapshot()
                         if self.autotuner is not None
                         else {"enabled": False}),
        }


_OUTCOMES = {
    wire.STATUS_OK: "ok",
    wire.STATUS_BAD_REQUEST: "bad_request",
    wire.STATUS_OVERLOADED: "shed",
    wire.STATUS_DEADLINE: "expired",
    wire.STATUS_INTERNAL: "error",
    wire.STATUS_DRAINING: "draining",
}


class _PendingScore:
    """Gathers one wire request's row futures; the LAST completion builds
    and sends the response (on the batcher worker thread — response
    encoding is microseconds, cheaper than a handoff to yet another
    thread would be)."""

    __slots__ = ("fl", "link", "req", "version", "futs", "t0", "tail",
                 "_remaining", "_lock")

    def __init__(self, fl, link, req, version, futs, t0, tail):
        self.fl = fl
        self.link = link
        self.req = req
        self.version = version
        self.futs = futs
        self.t0 = t0
        self.tail = tail
        self._remaining = len(futs)
        self._lock = threading.Lock()

    def one_done(self, _fut) -> None:
        with self._lock:
            self._remaining -= 1
            if self._remaining:
                return
        try:
            self._complete()
        finally:
            server = self.fl.server
            with server._inflight_cv:
                server._inflight -= len(self.futs)
                server._inflight_cv.notify_all()

    def _complete(self) -> None:
        fl, link, req = self.fl, self.link, self.req
        server = fl.server
        scores, degraded, stages = [], [], {}
        status, error, retry_after = wire.STATUS_OK, "", 0.0
        for f in self.futs:
            exc = f.exception()
            if exc is None:
                score = f.result()
                scores.append(float(score))
                degraded.append(tuple(getattr(score, "degraded", ())))
                for st, sec in (getattr(score, "stages", None)
                                or {}).items():
                    # Rows of one request overwhelmingly share a batch;
                    # max() reports the batch's stage cost once instead
                    # of summing the same kernel N times.
                    stages[st] = max(stages.get(st, 0.0), float(sec))
            elif isinstance(exc, Overloaded):
                status, error = wire.STATUS_OVERLOADED, str(exc)
                retry_after = 1.0
            elif isinstance(exc, DeadlineExceeded):
                status, error = wire.STATUS_DEADLINE, str(exc)
            else:
                status = wire.STATUS_INTERNAL
                error = f"{type(exc).__name__}: {exc}"
        total = time.perf_counter() - self.t0
        promoted = False
        if status == wire.STATUS_OK:
            link.served += len(scores)
            server._count(requests=1)  # scorer owns serve_* counters box-wide
            for st, sec in stages.items():
                server._stage_hist.observe(sec, stage=st)
            server.latency.observe(total)
            if any(degraded):
                server._count(degraded=1)
            promoted = fl._finish_tail(self.tail, req.trace_id or None,
                                       self.t0, error=False)
        else:
            if status == wire.STATUS_DEADLINE:
                server._count(expired=1)
            elif status == wire.STATUS_INTERNAL:
                server._count(errors=1)
            promoted = fl._finish_tail(
                self.tail, req.trace_id or None, self.t0,
                error=status == wire.STATUS_INTERNAL)
        fl._ipc_requests.inc(outcome=_OUTCOMES.get(status, "error"))
        flags = wire.RESP_FLAG_TRACE_PROMOTED if promoted else 0
        try:
            link.channel.send(wire.encode_score_response(
                req.req_id, status=status, error=error,
                retry_after_s=retry_after,
                model_version=self.version.version, flags=flags,
                scores=np.asarray(scores, np.float32),
                degraded=degraded, stages=stages))
        except (ipc.TransportClosed, ipc.RingFull):
            link.errors += 1
