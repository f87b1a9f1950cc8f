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

Runs on the card by default (``--device cuda``, which fails when no GPU is
visible); ``--device cpu`` scores with the kernels' plain versions. The JAX
driver's replica flags (``--delta-log``, ``--replica-id``,
``--cursor-dir``, ``--catchup-lag``) belong to the replication slice and
are refused; ``--compilation-cache-dir`` and ``--compile-store`` are
refused for good (the port compiles no XLA programs).
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

REPLICATION_SLICE = "comes with the replication slice (M15b)"

# Flags of the JAX driver the port refuses: (flag, is it set, why). Each is
# refused when set, never ignored.
_REFUSED = (
    ("--delta-log", lambda a: a.delta_log is not None,
     f"serving replicas {REPLICATION_SLICE}"),
    ("--replica-id", lambda a: a.replica_id is not None,
     f"serving replicas {REPLICATION_SLICE}"),
    ("--cursor-dir", lambda a: a.cursor_dir is not None,
     f"serving replicas {REPLICATION_SLICE}"),
    ("--catchup-lag", lambda a: a.catchup_lag != 0,
     f"replica catch-up {REPLICATION_SLICE}"),
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
    p.add_argument("--delta-log", default=None)
    p.add_argument("--replica-id", default=None)
    p.add_argument("--cursor-dir", default=None)
    p.add_argument("--catchup-lag", type=int, default=0)
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
    telemetry_dir = enable_telemetry(args, role="serving")
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
            telemetry_dir, f"metrics.serving.{os.getpid()}.jsonl")
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
            telemetry_dir, f"registry.serving.{os.getpid()}.json")
    v = registry.current
    logger.info(
        "serving model version %d (%s) on http://%s:%d  "
        "[device %s; coordinates: %s; max_batch=%d, wait=%.1fms, cache=%d]",
        v.version, v.model_dir, *server.address, registry.device,
        ",".join(sorted(v.coordinates)), config.max_batch,
        config.max_wait_ms, config.cache_entities,
    )
    return server, plogger


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
