"""Online incremental training driver.

Port of ``photon_tpu/cli/online_training_driver.py``. Where the training
driver batch-fits a model directory and the serving driver scores it, this
one sits BETWEEN them: it tails an event log, re-solves dirty entities on a
cadence, and publishes model deltas into a live scoring server, a durable
delta log that serving replicas tail, or a canary log that the control
driver soaks and promotes:

    python -m photon_tpu_torch.cli.online_training_driver \\
        --model-dir out/best --events events.jsonl \\
        --serve-url http://127.0.0.1:8080 --output-dir online_out --follow

Without a sink the trainer runs open-loop (state + patch journal advance,
nothing served): the shadow-evaluation mode. The replay cursor
(``<output-dir>/online-cursor.json``) advances only past PUBLISHED events,
so a restarted driver resumes exactly where its last delta left off.

The refreshes solve on the card by default (``--device cuda``, which fails
when no GPU is visible); ``--device cpu`` solves with the kernels' plain
versions. ``--compilation-cache-dir`` and ``--compile-store`` are refused
for good (the port compiles no XLA programs).
"""
from __future__ import annotations

import argparse
import json
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
    stamp_failover,
)
from photon_tpu_torch.utils import PhotonLogger

# Flags of the JAX driver the port refuses: (flag, is it set, why).
_REFUSED = (
    ("--compilation-cache-dir", lambda a: a.compilation_cache_dir is not None,
     NO_COMPILED_PROGRAMS),
    ("--compile-store", lambda a: a.compile_store is not None,
     NO_COMPILED_PROGRAMS),
)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="online-training-driver",
        description="Stream events into per-entity model deltas published "
                    "to a live GAME scoring server (PyTorch/CUDA).",
    )
    p.add_argument("--model-dir", required=True,
                   help="a 'best' or 'models/<i>' directory from the "
                        "training driver: the base model whose fixed "
                        "effects freeze and whose random-effect posteriors "
                        "seed the refresh anchors")
    p.add_argument("--index-dir", default=None,
                   help="per-shard index stores (default: "
                        "<model-dir>/../index)")
    p.add_argument("--events", required=True,
                   help="JSONL event log (one labeled observation a line)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the refreshes solve (default cuda; no "
                        "fallback)")
    p.add_argument("--serve-url", default=None,
                   help="live scoring server base URL; deltas publish via "
                        "POST /admin/patch (omit to run open-loop)")
    p.add_argument("--delta-log", default=None,
                   help="durable delta log (JSONL) to append every "
                        "published delta to: the write-once fan-out N "
                        "serving replicas tail; combinable with --serve-url "
                        "(both must succeed per publish)")
    p.add_argument("--canary-log", default=None,
                   help="publish deltas into this CANARY side-channel log "
                        "instead of the mainline --delta-log; only the "
                        "designated canary replica tails it, and the "
                        "control driver promotes soaked waves into the "
                        "main log. Mutually exclusive with --delta-log")
    p.add_argument("--publish-retries", type=int, default=3,
                   help="bounded retries (decorrelated-jitter backoff) "
                        "for --serve-url publishes hitting transient "
                        "connection errors or 503 sheds")
    p.add_argument("--output-dir", default=None,
                   help="photon.log + patch-journal.jsonl + "
                        "online-cursor.json + online-summary.json land here")
    p.add_argument("--window", type=int, default=64,
                   help="sliding-window rows per entity (the refresh's "
                        "training data)")
    p.add_argument("--max-event-nnz", type=int, default=64,
                   help="per-shard feature cap per event (stable-shape "
                        "contract; over-cap events are rejected)")
    p.add_argument("--refresh-batch", type=int, default=4096,
                   help="dirty entities per refresh cycle")
    p.add_argument("--chunk", type=int, default=256,
                   help="blessed entity-chunk size for the batched solves "
                        "(must be on PHOTON_RE_CHUNK_LADDER)")
    p.add_argument("--cadence-s", type=float, default=1.0,
                   help="refresh cadence in seconds (0 = only when "
                        "refresh-batch entities are dirty, or at drain)")
    p.add_argument("--incremental-weight", type=float, default=1.0,
                   help="Gaussian-prior anchor strength to the previous "
                        "posterior (0 = plain warm start, no anchoring)")
    p.add_argument("--reg-weight", type=float, default=1.0,
                   help="L2 weight per refresh solve")
    p.add_argument("--max-iter", type=int, default=30)
    p.add_argument("--tol", type=float, default=1e-7)
    p.add_argument("--max-cycles", type=int, default=0,
                   help="stop after N refresh cycles (0 = run to stream "
                        "end / until interrupted under --follow)")
    p.add_argument("--follow", action="store_true",
                   help="tail the event log instead of stopping at EOF")
    p.add_argument("--no-resume", action="store_true",
                   help="ignore the saved replay cursor and start from "
                        "event seq 0")
    p.add_argument("--prefetch-depth", type=int, default=None,
                   help="read events through the bounded background "
                        "prefetch stage (io/prefetch.py; default "
                        "$PHOTON_PREFETCH_DEPTH, 0 disables)")
    add_backend_policy_flag(p)
    add_fault_plan_flag(p)
    add_telemetry_flag(p)
    add_trace_flag(p)
    # The JAX driver's flags the port refuses (_REFUSED).
    p.add_argument("--compilation-cache-dir", default=None)
    p.add_argument("--compile-store", default=None)
    return p


def _load_base(args, logger):
    """Model dir → (GameModel, data configs, index maps, shard configs):
    the metadata reconstruction the serving registry does, so the trainer
    and the server can never disagree about feature assembly. The model
    loads on the CPU: it only seeds the trainer's host state (the frozen
    fixed effects' weights and the random effects' posteriors)."""
    import torch

    from photon_tpu_torch.estimators.config import (
        FixedEffectDataConfig,
        RandomEffectDataConfig,
    )
    from photon_tpu_torch.index.index_map import MmapIndexMap
    from photon_tpu_torch.io.data_reader import FeatureShardConfig
    from photon_tpu_torch.io.model_io import default_index_root, load_game_model

    with open(os.path.join(args.model_dir, "game-metadata.json")) as f:
        meta = json.load(f)
    shards = {info["feature_shard"] for info in meta["coordinates"].values()}
    index_root = args.index_dir or default_index_root(args.model_dir)
    index_maps = {
        s: MmapIndexMap(os.path.join(index_root, s)) for s in sorted(shards)
    }
    for im in index_maps.values():
        im.preload()
    model, meta = load_game_model(args.model_dir, index_maps,
                                  dtype=torch.float32,
                                  device=torch.device("cpu"))
    data_configs = {}
    for cid, info in meta["coordinates"].items():
        if info["type"] == "fixed":
            data_configs[cid] = FixedEffectDataConfig(info["feature_shard"])
        else:
            data_configs[cid] = RandomEffectDataConfig(
                re_type=info["re_type"], feature_shard=info["feature_shard"]
            )
    saved_shards = meta.get("feature_shards", {})
    shard_configs = {
        s: (
            FeatureShardConfig(
                feature_bags=tuple(saved_shards[s]["feature_bags"]),
                add_intercept=saved_shards[s]["add_intercept"],
            )
            if s in saved_shards
            else FeatureShardConfig(feature_bags=("features",))
        )
        for s in index_maps
    }
    logger.info(
        "online base model: %s (%d coordinates, shards: %s)",
        args.model_dir, len(data_configs), ",".join(sorted(index_maps)),
    )
    return model, data_configs, index_maps, shard_configs


def _parse(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    p = build_arg_parser()
    args = p.parse_args(argv)
    refuse_unported(p, args, _REFUSED)
    if args.delta_log and args.canary_log:
        raise SystemExit(
            "--delta-log and --canary-log are mutually exclusive: under "
            "canary control the CONTROLLER owns the main log (waves reach "
            "it only by promotion)")
    return args


def run(argv: Optional[Sequence[str]] = None) -> dict:
    """Replay (or follow) the event log through the trainer; returns the
    summary written to ``online-summary.json``. ``--fault-plan`` is
    installed for the run only."""
    args = _parse(argv)
    try:
        with enable_fault_plan(args.fault_plan):
            return _run(args)
    finally:
        finish_trace(args.trace_out)
        finish_telemetry(args)


def _run(args) -> dict:
    from photon_tpu_torch.io.prefetch import prefetch
    from photon_tpu_torch.online import (
        EventCursor,
        HttpPublisher,
        OnlineTrainer,
        OnlineTrainerConfig,
        PatchJournal,
        iter_events,
    )

    guard = enable_backend_guard(args)
    device = "cpu" if guard["backend"] == "cpu" else args.device
    enable_telemetry(args, role="online")
    enable_trace(args.trace_out)
    plogger = PhotonLogger(args.output_dir)
    logger = plogger.logger

    model, data_configs, index_maps, shard_configs = _load_base(args, logger)
    config = OnlineTrainerConfig(
        window=args.window,
        max_event_nnz=args.max_event_nnz,
        refresh_batch=args.refresh_batch,
        chunk=args.chunk,
        cadence_s=args.cadence_s,
        incremental_weight=args.incremental_weight,
        reg_weight=args.reg_weight,
        max_iterations=args.max_iter,
        tolerance=args.tol,
    )
    # Publisher fan-out: the point-to-point HTTP push and the durable delta
    # log compose: a delta is "published" only when every sink took it.
    sinks = []
    if args.serve_url:
        sinks.append(HttpPublisher(args.serve_url,
                                   retries=args.publish_retries))
    # Under canary control the trainer writes the SIDE CHANNEL only; the
    # control driver owns the main log and appends promoted waves there.
    wave_log = args.canary_log or args.delta_log
    if wave_log:
        from photon_tpu_torch.replication import DeltaLogPublisher

        sinks.append(DeltaLogPublisher(
            wave_log, snapshot_model_dir=args.model_dir))
    if len(sinks) > 1:
        from photon_tpu_torch.replication import FanoutPublisher

        publisher = FanoutPublisher(*sinks)
    else:
        publisher = sinks[0] if sinks else None
    journal = PatchJournal(args.output_dir) if args.output_dir else None
    cursor = EventCursor(args.output_dir) if args.output_dir else None
    trainer = OnlineTrainer.from_game_model(
        model, data_configs, index_maps, shard_configs, config,
        publisher=publisher, journal=journal, cursor=cursor, device=device,
    )
    start_seq = 0
    if cursor is not None and not args.no_resume:
        start_seq = cursor.load()
        if start_seq:
            logger.info("resuming event replay at seq %d (cursor)",
                        start_seq)
    events = iter_events(
        args.events, start_seq=start_seq, follow=args.follow,
        # Idle ticks on a quiet followed stream: the cadence must still
        # fire with dirty entities pending, not block until the next event.
        idle_yield_s=args.cadence_s if args.follow else 0.0,
    )
    # Background tailing through the bounded prefetch stage: event decode
    # and the refresh solves overlap, as in training ingest.
    events = prefetch(events, depth=args.prefetch_depth)
    try:
        summary = trainer.run(
            events, max_cycles=args.max_cycles or None,
        )
    except KeyboardInterrupt:
        summary = {**trainer.totals, "interrupted": True}
    summary = {
        "model_dir": args.model_dir,
        "events_path": args.events,
        "serve_url": args.serve_url,
        "delta_log": args.delta_log,
        "canary_log": args.canary_log,
        "start_seq": start_seq,
        "device": str(trainer.device),
        **{k: v for k, v in summary.items() if k != "refreshes"},
    }
    summary = stamp_failover(summary)
    logger.info("online trainer done: %s", json.dumps(summary))
    if args.output_dir:
        with open(os.path.join(args.output_dir,
                               "online-summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
    plogger.close()
    return summary


def main() -> None:  # pragma: no cover - console entry
    console_main(run)


if __name__ == "__main__":  # pragma: no cover
    main()
