"""Staleness-aware routing front door for serving replicas
(docs/serving.md §"Replication").

A copy of the JAX package's ``cli/router_driver.py`` (it imports neither
torch nor JAX); ``tests/test_torch_replication.py`` compares the code, so
edit both or neither.

The seventh driver: where the serving driver answers ``/score`` itself,
this one fronts N of them — health-checking each replica's ``/healthz``
(status, degradation reasons, delta-log seq watermark), weighting traffic
toward the freshest healthy replicas, draining degraded or
memory-pressured ones, and retrying idempotent reads on a second replica
when a connection fails mid-request:

    python -m photon_tpu_torch.cli.router_driver \\
        --replica http://127.0.0.1:8081 --replica http://127.0.0.1:8082 \\
        --port 8080 --output-dir router_logs

Deliberately accelerator-free: the router never imports torch and needs no
backend guard — it must keep routing while every replica behind it is
busy recompiling or recovering.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

from photon_tpu_torch.utils import PhotonLogger


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="router-driver",
        description="Route /score traffic across serving replicas with "
                    "staleness- and pressure-aware weighting.",
    )
    p.add_argument("--replica", action="append", default=None,
                   metavar="URL", dest="replicas",
                   help="replica base URL (repeatable; at least one "
                        "required), e.g. http://127.0.0.1:8081")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080,
                   help="0 binds an ephemeral port (logged at startup)")
    p.add_argument("--health-interval", type=float, default=1.0,
                   help="seconds between /healthz sweeps across replicas")
    p.add_argument("--health-timeout", type=float, default=2.0,
                   help="per-replica /healthz timeout; a miss marks the "
                        "replica unreachable until the next sweep")
    p.add_argument("--staleness-penalty", type=float, default=0.25,
                   help="weight divisor per seq of delta-log lag behind "
                        "the freshest replica (0 = ignore staleness)")
    p.add_argument("--retries", type=int, default=1,
                   help="idempotent-read retries on a DIFFERENT replica "
                        "after a connection failure or 503 shed")
    p.add_argument("--request-timeout", type=float, default=30.0,
                   help="per-upstream-request deadline in seconds")
    p.add_argument("--seed", type=int, default=None,
                   help="pin the weighted-choice random stream "
                        "(deterministic routing for tests)")
    p.add_argument("--output-dir", default=None,
                   help="photon.log lands here")
    from photon_tpu_torch.cli.params import (
        add_fault_plan_flag,
        add_telemetry_flag,
        add_trace_flag,
    )

    add_fault_plan_flag(p)
    add_telemetry_flag(p)
    add_trace_flag(p)
    return p


def run(argv: Optional[Sequence[str]] = None,
        serve_forever: bool = True) -> dict:
    args = build_arg_parser().parse_args(argv)
    from photon_tpu_torch.cli.params import finish_trace

    try:
        return _run(args, serve_forever)
    finally:
        finish_trace(args.trace_out)


def _run(args, serve_forever: bool) -> dict:
    from photon_tpu_torch.cli.params import (
        enable_fault_plan,
        enable_telemetry,
        enable_trace,
        finish_telemetry,
    )
    from photon_tpu_torch.replication import RouterServer

    if not args.replicas:
        raise SystemExit("router-driver: at least one --replica required")
    enable_fault_plan(args.fault_plan)
    enable_telemetry(args, role="router")
    enable_trace(args.trace_out)
    plogger = PhotonLogger(args.output_dir)
    logger = plogger.logger
    router = RouterServer(
        args.replicas,
        host=args.host,
        port=args.port,
        health_interval_s=args.health_interval,
        health_timeout_s=args.health_timeout,
        staleness_penalty=args.staleness_penalty,
        retries=args.retries,
        timeout_s=args.request_timeout,
        logger=logger,
        seed=args.seed,
    )
    # One synchronous sweep before announcing ourselves: an immediate
    # client sees real routability, not "no replica available" while the
    # background health loop warms up.
    router.check_replicas()
    summary = {
        "address": list(router.address),
        "replicas": list(args.replicas),
        **{k: router.health_snapshot()[k]
           for k in ("status", "routable", "reachable")},
    }
    logger.info("router on http://%s:%d fronting %d replica(s): %s",
                *router.address, len(args.replicas), json.dumps(summary))
    if not serve_forever:
        router.shutdown()
        finish_telemetry(args, registries=(router.metrics,))
        plogger.close()
        return summary

    def _graceful(signum, frame):
        raise KeyboardInterrupt

    try:
        import signal

        # SIGTERM routes through the same graceful stop as Ctrl-C, same
        # contract as the serving driver. Main-thread only.
        signal.signal(signal.SIGTERM, _graceful)
    except ValueError:
        pass
    try:
        router.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        router.shutdown()
        summary["requests"] = router.metrics_snapshot().get(
            "router_requests_total", {})
        finish_telemetry(args, registries=(router.metrics,))
        plogger.close()
    return summary


def main() -> None:  # pragma: no cover - console entry
    from photon_tpu_torch.cli.params import console_main

    console_main(run)


if __name__ == "__main__":  # pragma: no cover
    main()
