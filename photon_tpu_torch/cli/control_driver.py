"""Closed-loop control plane driver (docs/control.md).

A copy of the JAX package's ``cli/control_driver.py`` (it imports neither
torch nor JAX); ``tests/test_torch_control.py`` compares the code, so edit
both or neither.

The eighth driver: where the router fronts replicas and the supervisor
restarts processes, this one closes the loop ABOVE them — it ticks a
:class:`~photon_tpu_torch.control.Controller` that observes live replica
telemetry, matches it against a declarative policy (anomaly→action
rules, canary soak gates, damped autoscaling), actuates pre-existing
levers over HTTP, and journals every decision to
``control-ledger.jsonl``:

    python -m photon_tpu_torch.cli.control_driver \\
        --replica http://127.0.0.1:8081 --canary http://127.0.0.1:8082 \\
        --delta-log main/delta-log.jsonl \\
        --canary-log online/delta-log.canary.jsonl \\
        --model-dir out/best --output-dir control_out --max-ticks 30

Deliberately accelerator-free, like the router: the controller never
imports torch — it must keep deciding while every replica behind it is
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
        prog="control-driver",
        description="Closed-loop controller: anomaly→action policies, "
                    "canary delta publication with auto-rollback, and "
                    "damped serving autoscaling.",
    )
    p.add_argument("--replica", action="append", default=None,
                   metavar="URL", dest="replicas",
                   help="traffic-bearing replica base URL (repeatable)")
    p.add_argument("--canary", default=None, metavar="URL",
                   help="the designated canary replica (at most one); "
                        "requires --delta-log, --canary-log and "
                        "--model-dir")
    p.add_argument("--delta-log", default=None,
                   help="MAIN delta log — the controller owns its writer "
                        "and appends promoted canary waves to it")
    p.add_argument("--canary-log", default=None,
                   help="canary side-channel log the online trainer "
                        "publishes waves into (its --canary-log)")
    p.add_argument("--model-dir", default=None,
                   help="base model directory: the rollback / standby-swap "
                        "target")
    p.add_argument("--policy", default=None,
                   help="ControlPolicy JSON file (default: built-in "
                        "defaults; see docs/control.md §policy schema)")
    p.add_argument("--probe", default=None,
                   help="JSON file with scoring rows for the per-tick "
                        "latency probe and the canary drift probe "
                        "(without it the controller falls back to "
                        "/healthz round-trips and health-only canary "
                        "verdicts)")
    p.add_argument("--router", default=None, metavar="URL",
                   help="router base URL (recorded in the ledger for the "
                        "fleet report's topology join)")
    p.add_argument("--tick", type=float, default=None,
                   help="override the policy's tick interval in seconds")
    p.add_argument("--max-ticks", type=int, default=0,
                   help="stop after N ticks (0 = run until interrupted)")
    p.add_argument("--restart-budget", type=int, default=3,
                   help="max tailer-restart grants per replica "
                        "(supervisor RestartPolicy pacing; 0 disables "
                        "the restart_tailer lever's budget gate)")
    p.add_argument("--lever-timeout", type=float, default=10.0,
                   help="per-lever HTTP deadline in seconds")
    p.add_argument("--output-dir", default=None,
                   help="photon.log + control-ledger.jsonl land here "
                        "(default: cwd for the ledger)")
    from photon_tpu_torch.cli.params import (
        add_fault_plan_flag,
        add_telemetry_flag,
        add_trace_flag,
    )

    add_fault_plan_flag(p)
    add_telemetry_flag(p)
    add_trace_flag(p)
    return p


def run(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_arg_parser().parse_args(argv)
    from photon_tpu_torch.cli.params import finish_trace

    try:
        return _run(args)
    finally:
        finish_trace(args.trace_out)


def _run(args) -> dict:
    from photon_tpu_torch.cli.params import (
        enable_fault_plan,
        enable_telemetry,
        enable_trace,
        finish_telemetry,
    )
    from photon_tpu_torch.control import (
        ControlLedger,
        ControlPolicy,
        Controller,
        LEDGER_FILENAME,
        Levers,
        ReplicaTarget,
    )

    replicas = [ReplicaTarget(u) for u in (args.replicas or ())]
    if args.canary:
        replicas.append(ReplicaTarget(args.canary, canary=True))
    if not replicas:
        raise SystemExit("control-driver: at least one --replica or "
                         "--canary required")
    if args.canary and not (args.delta_log and args.canary_log
                            and args.model_dir):
        raise SystemExit("control-driver: --canary requires --delta-log, "
                         "--canary-log and --model-dir")
    enable_fault_plan(args.fault_plan)
    enable_telemetry(args, role="control")
    enable_trace(args.trace_out)
    plogger = PhotonLogger(args.output_dir)
    logger = plogger.logger

    if args.policy:
        policy = ControlPolicy.from_file(args.policy)
    else:
        policy = ControlPolicy()
    if args.tick is not None:
        import dataclasses

        policy = dataclasses.replace(policy, tick_s=args.tick)
    probe_rows = None
    if args.probe:
        with open(args.probe) as f:
            probe_rows = json.load(f)
        if not isinstance(probe_rows, list):
            raise SystemExit("control-driver: --probe must be a JSON "
                             "list of scoring rows")
    restart_policy = None
    if args.restart_budget > 0:
        from photon_tpu_torch.supervisor import RestartPolicy

        restart_policy = RestartPolicy(max_restarts=args.restart_budget)

    ledger_dir = args.output_dir or "."
    os.makedirs(ledger_dir, exist_ok=True)
    ledger = ControlLedger(os.path.join(ledger_dir, LEDGER_FILENAME))
    controller = Controller(
        policy,
        replicas,
        ledger,
        main_log_path=args.delta_log,
        canary_log_path=args.canary_log,
        base_model_dir=args.model_dir,
        probe_rows=probe_rows,
        router_url=args.router,
        levers=Levers(timeout_s=args.lever_timeout),
        restart_policy=restart_policy,
        logger=logger,
    )
    logger.info(
        "control loop over %d replica(s)%s: policy %s, tick %.3gs%s",
        len(replicas),
        f" (canary {args.canary})" if args.canary else "",
        policy.digest(), policy.tick_s,
        f", max_ticks={args.max_ticks}" if args.max_ticks else "")

    def _graceful(signum, frame):
        raise KeyboardInterrupt

    try:
        import signal

        # SIGTERM routes through the same graceful stop as Ctrl-C, same
        # contract as the serving and router drivers. Main-thread only.
        signal.signal(signal.SIGTERM, _graceful)
    except ValueError:
        pass
    try:
        controller.run(max_ticks=args.max_ticks or None)
    except KeyboardInterrupt:
        controller._stop.set()
    finally:
        finish_telemetry(args, registries=(controller.metrics,))
    summary = {
        "replicas": [r.url for r in replicas],
        "canary": args.canary,
        "ticks": controller.ticks,
        "actions": controller.actions_total,
        "policy_digest": policy.digest(),
        "ledger": os.path.abspath(ledger.path),
    }
    logger.info("control loop done: %s", json.dumps(summary))
    if args.output_dir:
        with open(os.path.join(args.output_dir,
                               "control-summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
    plogger.close()
    return summary


def main() -> None:  # pragma: no cover - console entry
    from photon_tpu_torch.cli.params import console_main

    console_main(run)


if __name__ == "__main__":  # pragma: no cover
    main()
