"""Online GAME scoring server driver.

Port of ``photon_tpu/cli/serving_driver.py``. Where the scoring driver reads
a dataset and writes a file, this one loads the same training-driver output
directory and serves single-row JSON requests at low latency:

    python -m photon_tpu_torch.cli.serving_driver \\
        --model-dir out/best --port 8080 --output-dir serve_logs

    curl -s localhost:8080/score -d '{"features": [{"name": "g", \\
        "term": "0", "value": 1.2}], "entities": {"userId": "user3"}}'

Scores equal the batch scorer's (the same index maps and the same additive
program, ``additive_score_rows``), unseen entities fall back to
fixed-effect-only, and ``POST /admin/swap`` hot-swaps to a newly trained
model directory without dropping in-flight requests. ``--workers N`` runs
the multi-process front line: N accelerator-free worker processes share
``--port`` and feed this process, the one that owns the card.

``--delta-log`` makes the process a serving REPLICA: a
``ReplicaTailer`` (``photon_tpu_torch.replication``) converges to the log
head before the first health check, then tails the log while serving,
applying every record exactly once through the registry (its watermark
and lag ride ``/healthz``); ``--replica-id``, ``--cursor-dir`` and
``--catchup-lag`` configure it.

Runs on the card by default (``--device cuda``, which fails when no GPU is
visible); ``--device cpu`` scores with the kernels' plain versions.
``--compilation-cache-dir`` and ``--compile-store`` are refused for good
(the port compiles no XLA programs).
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from photon_tpu_torch.cli.params import (
    NO_COMPILED_PROGRAMS,
    add_backend_policy_flag,
    add_fault_plan_flag,
    add_telemetry_flag,
    add_trace_flag,
    console_main,
    enable_backend_guard,
    enable_fault_plan,
    enable_telemetry,
    enable_trace,
    finish_telemetry,
    finish_trace,
    refuse_unported,
)
from photon_tpu_torch.serving import (
    MicroBatcher,
    ModelRegistry,
    ScoringServer,
    ServingConfig,
)
from photon_tpu_torch.utils import PhotonLogger, Timed

# Flags of the JAX driver the port refuses: (flag, is it set, why). Each is
# refused when set, never ignored.
_REFUSED = (
    ("--compilation-cache-dir", lambda a: a.compilation_cache_dir is not None,
     NO_COMPILED_PROGRAMS),
    ("--compile-store", lambda a: a.compile_store is not None,
     NO_COMPILED_PROGRAMS),
)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="serving-driver",
        description="Serve a trained GAME model over HTTP (JSON rows; "
                    "PyTorch/CUDA).",
    )
    p.add_argument("--model-dir", required=True,
                   help="a 'best' or 'models/<i>' directory from the "
                        "training driver")
    p.add_argument("--index-dir", default=None,
                   help="per-shard index stores (default: <model-dir>/../index)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080,
                   help="0 binds an ephemeral port (logged at startup)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model and the scoring program live "
                        "(default cuda; no fallback)")
    p.add_argument("--max-batch", type=int, default=64,
                   help="micro-batch row cap (bucket shapes warm at startup)")
    p.add_argument("--max-wait-ms", type=float, default=2.0,
                   help="micro-batcher coalescing window")
    p.add_argument("--cache-entities", type=int, default=4096,
                   help="LRU device hot-set capacity per RE coordinate")
    p.add_argument("--max-row-nnz", type=int, default=128,
                   help="per-shard feature cap per request row (stable-shape "
                        "contract; over-cap rows get HTTP 400)")
    p.add_argument("--max-queue", type=int, default=1024,
                   help="admission-queue bound; beyond it requests shed "
                        "with HTTP 503 + Retry-After")
    p.add_argument("--request-timeout", type=float, default=30.0,
                   help="per-request deadline in seconds, enforced inside "
                        "the batcher (expired rows never reach the kernel)")
    p.add_argument("--breaker-failures", type=int, default=5,
                   help="consecutive coefficient-store failures that open "
                        "the circuit breaker (0 disables); while open, RE "
                        "lookups degrade to fixed-effect-only scoring")
    p.add_argument("--breaker-cooldown", type=float, default=2.0,
                   help="seconds the breaker stays open before a probe")
    p.add_argument("--output-dir", default=None,
                   help="photon.log + serving-metrics.jsonl land here")
    # Replica mode: tail the durable delta log instead of waiting for
    # point-to-point /admin/patch pushes.
    p.add_argument("--delta-log", default=None,
                   help="durable delta log (JSONL) to tail as a serving "
                        "REPLICA: every logged delta applies exactly once "
                        "through the registry, the seq watermark + lag "
                        "ride /healthz, and a kill/rejoin resumes from "
                        "the per-replica cursor")
    p.add_argument("--replica-id", default=None,
                   help="stable replica identity for the cursor file, "
                        "journal rows, and metrics labels (default: "
                        "r<pid>, NOT restart-stable; set it explicitly "
                        "for rejoin-and-converge)")
    p.add_argument("--cursor-dir", default=None,
                   help="directory for the per-replica cursor (default: "
                        "--output-dir, else the delta log's directory)")
    p.add_argument("--catchup-lag", type=int, default=0,
                   help="replay backlog beyond which a rejoining replica "
                        "jumps to the log's latest full-snapshot marker "
                        "via prepare_standby/swap instead of replaying "
                        "(0 disables snapshot catch-up)")
    p.add_argument("--workers", type=int, default=0,
                   help="front-end worker processes; 0 = classic "
                        "single-process threaded server")
    p.add_argument("--ipc", choices=["auto", "shm", "socket"],
                   default="auto",
                   help="worker<->scorer transport: lock-free shared-"
                        "memory rings or unix-socket fallback (auto "
                        "probes /dev/shm)")
    p.add_argument("--autotune", action="store_true",
                   help="histogram-autotuned micro-batching: continuously "
                        "re-choose (max_batch, max_wait_ms) from live "
                        "serve_stage_latency_seconds deltas, damped with "
                        "hysteresis + cooldown")
    p.add_argument("--metrics-interval", type=float, default=60.0,
                   help="seconds between JSONL metrics snapshots")
    p.add_argument("--slo-config",
                   default=os.environ.get("PHOTON_SLO_CONFIG") or None,
                   help="JSON SLO rules judged at every metrics flush; "
                        "violations bump slo_violations_total and emit "
                        "trace instants")
    add_backend_policy_flag(p)
    add_fault_plan_flag(p)
    add_telemetry_flag(p)
    add_trace_flag(p)
    # The JAX driver's flags the port refuses (_REFUSED).
    p.add_argument("--compilation-cache-dir", default=None)
    p.add_argument("--compile-store", default=None)
    return p


def _parse(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    p = build_arg_parser()
    args = p.parse_args(argv)
    refuse_unported(p, args, _REFUSED)
    return args


def build_server(args) -> tuple[ScoringServer, PhotonLogger]:
    """Registry (load + warm) → batcher → HTTP front end, not yet serving.
    The backend guard goes first: a card that fails its probe refuses to
    start (strict) or the run goes to the CPU, stamped (failover)."""
    guard = enable_backend_guard(args)
    device = "cpu" if guard["backend"] == "cpu" else args.device
    # A delta-log tailer makes this process a REPLICA in the fleet
    # topology: the role rides every trace anchor and telemetry shard name.
    role = "replica" if args.delta_log else "serving"
    telemetry_dir = enable_telemetry(args, role=role)
    enable_trace(args.trace_out)
    plogger = PhotonLogger(args.output_dir)
    logger = plogger.logger
    config = ServingConfig(
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        cache_entities=args.cache_entities,
        max_row_nnz=args.max_row_nnz,
        max_queue=args.max_queue,
        request_timeout_s=args.request_timeout,
        breaker_failures=args.breaker_failures,
        breaker_cooldown_s=args.breaker_cooldown,
    )
    with Timed("load + warm model", logger):
        registry = ModelRegistry(
            args.model_dir, config, index_dir=args.index_dir, device=device
        )
    batcher = MicroBatcher(
        max_batch=config.max_batch,
        max_wait_ms=config.max_wait_ms,
        max_queue=config.max_queue,
    )
    # JSONL metrics history lands in the output dir; without one, a
    # --telemetry-dir still captures it under the fleet shard naming.
    if args.output_dir:
        metrics_path = os.path.join(args.output_dir,
                                    "serving-metrics.jsonl")
    elif telemetry_dir:
        metrics_path = os.path.join(
            telemetry_dir, f"metrics.{role}.{os.getpid()}.jsonl")
    else:
        metrics_path = None
    server = ScoringServer(
        registry,
        batcher,
        host=args.host,
        port=args.port,
        logger=logger,
        metrics_path=metrics_path,
        metrics_interval_s=args.metrics_interval,
        request_timeout_s=config.request_timeout_s,
        slo_config=args.slo_config,
    )
    if telemetry_dir:
        # Live fleet view: the flush loop re-exports this shard on the
        # metrics cadence (the path finish_telemetry finalizes at exit).
        server.telemetry_shard_path = os.path.join(
            telemetry_dir, f"registry.{role}.{os.getpid()}.json")
    if args.delta_log:
        _attach_tailer(args, registry, server, logger)
    v = registry.current
    logger.info(
        "serving model version %d (%s) on http://%s:%d  "
        "[device %s; coordinates: %s; max_batch=%d, wait=%.1fms, cache=%d]",
        v.version, v.model_dir, *server.address, registry.device,
        ",".join(sorted(v.coordinates)), config.max_batch,
        config.max_wait_ms, config.cache_entities,
    )
    return server, plogger


def _attach_tailer(args, registry, server, logger) -> None:
    """Make the server a replica of ``--delta-log``: converge to the log
    head BEFORE the first health check can read a watermark (a rejoining
    replica that advertised itself while still replaying its backlog would
    soak up traffic at stale coefficients), attach the tailer to
    ``/healthz`` and journal ``replica_joined``. The follow thread starts
    with serving."""
    from photon_tpu_torch.replication import ReplicaTailer
    from photon_tpu_torch.supervisor import RecoveryJournal

    journal = (
        RecoveryJournal(os.path.join(args.output_dir, "recovery.jsonl"))
        if args.output_dir else None
    )
    tailer = ReplicaTailer(
        registry,
        args.delta_log,
        replica_id=args.replica_id,
        cursor_dir=args.cursor_dir or args.output_dir or None,
        catchup_lag=args.catchup_lag,
        journal=journal,
        logger=logger,
        metrics=server.metrics,
    )
    applied = tailer.run_once()
    server.attach_replication(tailer)
    snap = tailer.snapshot()
    if journal is not None:
        journal.record("replica_joined", replica=tailer.replica_id,
                       seq_watermark=snap["seq_watermark"],
                       applied_at_join=applied)
    logger.info(
        "replica %s joined: delta log %s, watermark %d "
        "(%d record(s) applied at boot, %d catch-up jump(s))",
        tailer.replica_id, args.delta_log, snap["seq_watermark"],
        applied, snap["catchups"],
    )


def run(
    argv: Optional[Sequence[str]] = None, serve_forever: bool = True
) -> dict:
    """Build and (by default) serve until interrupted. ``serve_forever=
    False`` builds, warms, and tears down — the smoke/integration entry.
    ``--fault-plan`` is installed for the run only."""
    args = _parse(argv)
    # finish_trace in a finally covering the BUILD too: a model load or
    # warmup failure is exactly the run whose timeline matters most.
    try:
        with enable_fault_plan(args.fault_plan):
            return _run(args, serve_forever)
    finally:
        finish_trace(args.trace_out)


def _build_frontline(args, server, public_port: int):
    """Assemble (not start) the multi-process front line around a built
    server: optional histogram autotuner + the worker supervisor."""
    from photon_tpu_torch.serving.autotune import BatchAutotuner
    from photon_tpu_torch.serving.frontline import FrontLine

    tuner = None
    if args.autotune:
        scorer = server.registry.current.scorer
        tuner = BatchAutotuner(
            server.batcher,
            server._stage_hist,
            ladder_max=scorer._max_batch_cap,
            # The cap moves with OOM downshifts and hot-swaps; resolve it
            # through the registry at every tick, never cache it.
            cap_fn=lambda: server.registry.current.scorer._max_batch_cap,
            logger=server.logger,
        )
        server.autotuner = tuner
    journal = None
    if args.output_dir:
        from photon_tpu_torch.supervisor import RecoveryJournal

        journal = RecoveryJournal(
            os.path.join(args.output_dir, "recovery.jsonl"))
    if args.output_dir:
        runtime_dir = os.path.join(args.output_dir, "frontline")
    else:
        import tempfile

        runtime_dir = tempfile.mkdtemp(prefix="photon-frontline-")
    return FrontLine(
        server,
        workers=args.workers,
        host=args.host,
        port=public_port,
        runtime_dir=runtime_dir,
        transport=args.ipc,
        autotuner=tuner,
        telemetry_dir=getattr(args, "telemetry_dir", None),
        journal=journal,
        logger=server.logger,
    )


def _run(args, serve_forever: bool) -> dict:
    frontline_port = None
    if args.workers > 0:
        from photon_tpu_torch.serving.frontline import pick_port

        # Workers take the public port (SO_REUSEPORT); the in-process
        # HTTP server drops to an ephemeral port as the admin plane.
        frontline_port = args.port or pick_port(args.host)
        args.port = 0
    server, plogger = build_server(args)
    v = server.registry.current
    summary = {
        "address": list(server.address),
        "model_version": v.version,
        "model_dir": v.model_dir,
        "coordinates": sorted(v.coordinates),
        "device": str(server.registry.device),
    }
    if server.replication is not None:
        summary["replica_id"] = server.replication.replica_id
    fl = None
    if frontline_port is not None:
        fl = _build_frontline(args, server, frontline_port)
        summary["address"] = [args.host, frontline_port]
        summary["admin_address"] = list(server.address)
        summary["frontline"] = {
            "workers": args.workers,
            "transport": fl.transport,
            "runtime_dir": fl.runtime_dir,
            "autotune": bool(args.autotune),
        }
    if not serve_forever:
        server.shutdown()
        finish_telemetry(args, registries=(server.metrics,))
        plogger.close()
        return summary

    def _graceful(signum, frame):
        raise KeyboardInterrupt

    try:
        import signal

        # Production stops send SIGTERM; route it through the same graceful
        # path as Ctrl-C (drain batcher, flush metrics). Main thread only:
        # embedded callers that run() from a worker thread keep theirs.
        signal.signal(signal.SIGTERM, _graceful)
    except ValueError:
        pass
    try:
        if server.replication is not None:
            server.replication.start()  # follow the log while serving
        if fl is not None:
            fl.start()
            server.logger.info(
                "front line: %d worker(s) on http://%s:%d (%s), admin "
                "plane on http://%s:%d%s",
                args.workers, args.host, frontline_port, fl.transport,
                *server.address,
                ", autotune on" if args.autotune else "")
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        # Stop mutating the registry before the drain: a delta landing
        # mid-teardown has no one left to serve it.
        if server.replication is not None:
            server.replication.stop()
        # Workers first: they hold the public port and must stop taking
        # traffic before the batcher they feed goes away.
        if fl is not None:
            fl.stop()
        server.shutdown()
        # Registry shard AFTER shutdown: the final flush's counters are
        # exactly what the fleet report should aggregate.
        finish_telemetry(args, registries=(server.metrics,))
        plogger.close()
    return summary


def main() -> None:  # pragma: no cover - console entry
    console_main(run)


if __name__ == "__main__":  # pragma: no cover
    main()
