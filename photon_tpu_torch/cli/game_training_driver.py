"""GAME training driver: Avro data → trained model directory.

Port of ``photon_tpu/cli/game_training_driver.py`` (``run`` / ``_run_inner``)
on one device: parse flags → build (or load) the feature index maps → read
the Avro training (and validation) data → sanity checks →
the feature summary (``--feature-summary``) →
``GameEstimator.fit`` over the regularization-weight sweep (with
``--normalization`` and per-coordinate ``downsample``), fixed and random
effects by coordinate descent, evaluated after every step when
``--evaluators`` and ``--validation-data`` are given → select the best
configuration by the primary evaluator → save the model(s), the index maps,
``training-summary.json`` and ``metrics.jsonl``. The output layout is the
JAX driver's (``best/``, ``models/<i>/`` under ``--output-mode ALL``,
``index/<shard>``), so either package's scoring driver scores what this one
writes.

Runs on the card by default (``--device cuda``, which fails when no GPU is
visible); ``--device cpu`` runs the plain versions of the kernels. The data
is read as the JAX driver reads it: one ``StreamingAvroReader`` (native
block decoder) for the training and validation reads, chunks decoded ahead
on a thread (``--prefetch-depth``) or by worker processes
(``--ingest-workers``) and copied to the card through pinned staging
buffers; a schema the streaming engine cannot express falls back, logged,
to the per-record reader (``training-summary.json`` names the reader that
ran). ``--checkpoint-dir`` snapshots every coordinate step and resumes a
killed run; ``--re-routing measured`` routes the random-effect solves by a
measured cost table (``--re-cost-table``); ``--sweep-cache-mb`` sizes the
device cache of host-resident random-effect buckets. Flags of the JAX
driver that belong to later slices of the port (restarts, tuning, meshes,
the bfloat16 feed, profiling, the runtime guards) are refused with a
message naming the slice.

    python -m photon_tpu_torch.cli.game_training_driver \\
      --train-data data/train --output-dir out --task LOGISTIC_REGRESSION \\
      --coordinate "fixed:type=fixed,shard=global,reg=L2,reg_weights=0.1|1|10" \\
      [--device cuda]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
from contextlib import contextmanager
from typing import Optional, Sequence

import torch

from photon_tpu_torch.cli.params import (
    add_re_routing_flags,
    configs_from_specs,
    enable_re_routing,
    parse_coordinates,
    parse_feature_shard,
)
from photon_tpu_torch.data.normalization import NormalizationType
from photon_tpu_torch.data.statistics import compute_feature_statistics
from photon_tpu_torch.data.validators import DataValidationType, sanity_check_data
from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.estimators.config import RandomEffectDataConfig
from photon_tpu_torch.estimators.game_estimator import GameEstimator, select_best
from photon_tpu_torch.evaluation import EvaluationSuite
from photon_tpu_torch.index.index_map import MmapIndexMap, build_mmap_index
from photon_tpu_torch.io.data_reader import (
    AvroDataReader,
    FeatureShardConfig,
    InputColumnNames,
    build_index_from_avro,
)
from photon_tpu_torch.io.model_io import (
    load_game_model,
    save_feature_summary,
    save_game_model,
)
from photon_tpu_torch.types import TaskType
from photon_tpu_torch.utils import PhotonLogger, Timed, write_metrics_jsonl

_DTYPES = {"float32": torch.float32, "float64": torch.float64}

# Flags of the JAX driver that belong to later slices: (flag, is it set,
# the slice it comes with). Each is refused when set, never ignored.
_LATER_SLICES = (
    ("--max-restarts", lambda a: a.max_restarts > 0,
     "supervised restarts come with the runtime-guards slice (M13); use 0"),
    ("--restart-backoff", lambda a: a.restart_backoff is not None,
     "supervised restarts come with the runtime-guards slice (M13)"),
    ("--heartbeat-dir", lambda a: a.heartbeat_dir is not None,
     "heartbeats come with the runtime-guards slice (M13)"),
    ("--tuning", lambda a: a.tuning is not None,
     "hyperparameter tuning comes with the tuning slice (M12)"),
    ("--tuning-iterations", lambda a: a.tuning_iterations is not None,
     "hyperparameter tuning comes with the tuning slice (M12)"),
    ("--tuning-range", lambda a: a.tuning_range is not None,
     "hyperparameter tuning comes with the tuning slice (M12)"),
    ("--devices", lambda a: a.devices != 1,
     "multi-device training comes with the multi-GPU slice (M14); use 1"),
    ("--mesh", lambda a: a.mesh is not None,
     "meshes come with the multi-GPU slice (M14)"),
    ("--bf16-feed", lambda a: a.bf16_feed,
     "the bfloat16 feed needs the kernels that read bfloat16 values "
     "(the K1-bf16 slice, with M2's with_value_dtype)"),
    ("--profile-dir", lambda a: a.profile_dir is not None,
     "profiling comes with the observability slice"),
    ("--debug-nans", lambda a: a.debug_nans,
     "NaN checks come with the runtime-guards slice (M13)"),
    ("--trace-out", lambda a: a.trace_out is not None,
     "tracing comes with the observability slice"),
    ("--telemetry-dir", lambda a: a.telemetry_dir is not None,
     "fleet telemetry comes with the observability slice"),
    ("--backend-policy", lambda a: a.backend_policy is not None,
     "backend policies come with the runtime-guards slice (M13)"),
    ("--distributed-policy", lambda a: a.distributed_policy is not None,
     "multi-host bring-up comes with the multi-GPU slice (M14)"),
    ("--fault-plan", lambda a: a.fault_plan is not None,
     "fault injection comes with the runtime-guards slice (M13)"),
    ("--compilation-cache-dir", lambda a: a.compilation_cache_dir is not None,
     "the port compiles no programs to cache; its kernels build once per "
     "source (runtime-guards slice, M13)"),
    ("--compile-store", lambda a: a.compile_store is not None,
     "compile stores come with the runtime-guards slice (M13)"),
    ("--clear-caches-per-config", lambda a: a.clear_caches_per_config,
     "executable-cache bounds come with the runtime-guards slice (M13)"),
)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="game-training-driver",
        description="Train a GAME model (PyTorch/CUDA).",
    )
    p.add_argument("--train-data", nargs="+", required=True,
                   help="Avro files/dirs/globs with training data")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--task", required=True, choices=[t.name for t in TaskType])
    p.add_argument("--feature-shard", action="append", default=None,
                   metavar="SHARD[:BAG+BAG][:no-intercept]",
                   help="feature shard spec (repeatable); default 'global:features'")
    p.add_argument("--coordinate", action="append", required=True,
                   metavar="CID:K=V,...",
                   help="coordinate spec mini-DSL (repeatable); see cli/params.py")
    p.add_argument("--update-sequence", default=None,
                   help="comma-separated coordinate order (default: flag order)")
    p.add_argument("--sweeps", type=int, default=1,
                   help="coordinate-descent sweeps")
    p.add_argument("--data-validation", default="VALIDATE_FULL",
                   choices=[v.name for v in DataValidationType])
    p.add_argument("--output-mode", default="BEST", choices=["BEST", "ALL"],
                   help="save only the selected model or every swept config")
    p.add_argument("--model-input-dir", default=None,
                   help="warm-start GAME model directory")
    p.add_argument("--index-dir", default=None,
                   help="prebuilt per-shard index stores (else built from training data)")
    p.add_argument("--offset-column", default="offset")
    p.add_argument("--weight-column", default="weight")
    p.add_argument("--response-column", default="response")
    p.add_argument("--uid-column", default="uid")
    p.add_argument("--dtype", default="float32", choices=sorted(_DTYPES),
                   help="training precision")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where training runs (default cuda; no fallback)")
    p.add_argument("--validation-data", nargs="+", default=None,
                   help="Avro files/dirs/globs with validation data")
    p.add_argument("--evaluators", nargs="+", default=None,
                   help="evaluator specs (AUC, RMSE, LOGISTIC_LOSS, AUC:col, "
                        "PRECISION@k:col, ...); the first selects the best model")
    p.add_argument("--normalization", default="NONE",
                   choices=[n.name for n in NormalizationType])
    p.add_argument("--feature-summary", action="store_true",
                   help="write per-feature summary statistics (mean/var/min/"
                        "max/nnz) of every shard to <output-dir>/summary/"
                        "<shard>.avro")
    p.add_argument("--checkpoint-dir", default=None,
                   help="snapshot every coordinate step here; a run over the "
                        "same inputs resumes from the newest snapshot")
    p.add_argument("--ingest-workers", type=int, default=0,
                   help="decode worker processes (one file each at a time; "
                        "0 or 1 decodes in this process)")
    p.add_argument("--prefetch-depth", type=int, default=None,
                   help="chunks decoded ahead of the device copies (default "
                        "$PHOTON_PREFETCH_DEPTH or 2; 0 disables)")
    p.add_argument("--sweep-cache-mb", type=float, default=None,
                   help="device cache budget for host-resident random-effect "
                        "buckets (default $PHOTON_SWEEP_CACHE_MB or 2048; 0 "
                        "disables)")
    add_re_routing_flags(p)
    # The JAX driver's flags that later slices bring: refused when set.
    p.add_argument("--max-restarts", type=int, default=0)
    p.add_argument("--restart-backoff", type=float, default=None)
    p.add_argument("--heartbeat-dir", default=None)
    p.add_argument("--tuning", default=None)
    p.add_argument("--tuning-iterations", type=int, default=None)
    p.add_argument("--tuning-range", action="append", default=None)
    p.add_argument("--devices", type=int, default=1)
    p.add_argument("--mesh", default=None)
    p.add_argument("--bf16-feed", action="store_true")
    p.add_argument("--profile-dir", default=None)
    p.add_argument("--debug-nans", action="store_true")
    p.add_argument("--trace-out", default=None)
    p.add_argument("--telemetry-dir", default=None)
    p.add_argument("--backend-policy", default=None)
    p.add_argument("--distributed-policy", default=None)
    p.add_argument("--fault-plan", default=None)
    p.add_argument("--compilation-cache-dir", default=None)
    p.add_argument("--compile-store", default=None)
    p.add_argument("--clear-caches-per-config", action="store_true")
    return p


def _parse(argv: Optional[Sequence[str]]):
    p = build_arg_parser()
    args = p.parse_args(argv)
    for flag, is_set, later in _LATER_SLICES:
        if is_set(args):
            p.error(f"{flag}: not in the port yet; {later}")
    try:
        specs = parse_coordinates(args.coordinate)
    except NotImplementedError as e:
        p.error(f"--coordinate: {e}")
    return args, specs


@contextmanager
def _checkpointing(directory: Optional[str]):
    """A CheckpointManager's lifecycle: closed on success; on failure
    drained without masking the original error."""
    if not directory:
        yield None
        return
    from photon_tpu_torch.checkpoint import CheckpointManager

    mgr = CheckpointManager(directory)
    try:
        yield mgr
    except BaseException:
        try:
            mgr.close()
        except Exception:  # noqa: BLE001 - the original error wins
            pass
        raise
    else:
        mgr.close()


def _load_or_build_indexes(args, shard_specs, logger):
    shard_cfgs = {
        s.shard: FeatureShardConfig(
            feature_bags=s.feature_bags, add_intercept=s.add_intercept
        )
        for s in shard_specs
    }
    index_maps = {}
    for shard, cfg in shard_cfgs.items():
        if args.index_dir:
            index_maps[shard] = MmapIndexMap(os.path.join(args.index_dir, shard))
            logger.info("index[%s]: loaded %d features (mmap)",
                        shard, len(index_maps[shard]))
        else:
            index_maps[shard] = build_index_from_avro(
                args.train_data, feature_bags=cfg.feature_bags,
                add_intercept=cfg.add_intercept)
            logger.info("index[%s]: built %d features from training data",
                        shard, len(index_maps[shard]))
    return shard_cfgs, index_maps


def run(argv: Optional[Sequence[str]] = None) -> dict:
    """Run training; returns the result summary (also written to disk)."""
    args, specs = _parse(argv)
    device = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    with PhotonLogger(args.output_dir) as logger:
        enable_re_routing(args, args.output_dir)
        return _run_inner(args, specs, TaskType[args.task], device, logger)


def _run_inner(args, specs, task: TaskType, device: torch.device, logger) -> dict:
    data_configs, configs = configs_from_specs(specs)
    update_sequence = (
        tuple(s.strip() for s in args.update_sequence.split(","))
        if args.update_sequence
        else tuple(c.cid for c in specs)
    )
    shard_specs = [
        parse_feature_shard(s)
        for s in (args.feature_shard or ["global:features"])
    ]
    needed = {c.feature_shard for c in data_configs.values()}
    have = {s.shard for s in shard_specs}
    if needed - have:
        raise ValueError(
            f"coordinates use feature shards {sorted(needed - have)} with no "
            f"--feature-shard spec (have {sorted(have)})"
        )
    shard_cfgs, index_maps = _load_or_build_indexes(args, shard_specs, logger)
    suite = EvaluationSuite.parse(args.evaluators) if args.evaluators else None
    id_tags = sorted(
        {c.re_type for c in data_configs.values()
         if isinstance(c, RandomEffectDataConfig)}
        | {ev.group_column for ev in (suite.evaluators if suite else ())
           if ev.group_column}
    )
    reader = AvroDataReader(
        index_maps,
        shard_cfgs,
        columns=InputColumnNames(
            uid=args.uid_column,
            response=args.response_column,
            offset=args.offset_column,
            weight=args.weight_column,
        ),
        id_tag_columns=id_tags,
    )
    dtype = _DTYPES[args.dtype]
    # The reader keeps one streaming reader for the training and validation
    # reads: its compiled decode programs and hash tables are reused.
    depth = None if args.prefetch_depth is None else max(0, args.prefetch_depth)
    readers_used = []

    def read_data(paths):
        # Training never reads the uid column.
        bundle = reader.read(paths, dtype=dtype, device=device,
                             capture_uids=False, depth=depth,
                             workers=args.ingest_workers)
        readers_used.append(reader.last_reader)
        return bundle

    with Timed("read training data", logger) as t_read:
        train = read_data(args.train_data)
    logger.info("training rows: %d on %s (%s reader)", train.n_rows, device,
                readers_used[-1])
    validation = None
    if args.validation_data:
        with Timed("read validation data", logger):
            validation = read_data(args.validation_data)
        logger.info("validation rows: %d", validation.n_rows)

    vtype = DataValidationType[args.data_validation]
    with Timed("data validation", logger):
        for shard in sorted(needed):
            sanity_check_data(train.batch(shard), task, vtype)

    if args.feature_summary:
        with Timed("feature summarization", logger):
            for shard in sorted(needed):
                stats = compute_feature_statistics(train.batch(shard))
                save_feature_summary(
                    os.path.join(args.output_dir, "summary", f"{shard}.avro"),
                    index_maps[shard], stats)
                logger.info("feature summary[%s]: %d features", shard, stats.dim)

    initial_model = None
    if args.model_input_dir:
        with Timed("load warm-start model", logger):
            initial_model, _ = load_game_model(
                args.model_input_dir, index_maps, dtype=dtype, device=device)

    estimator = GameEstimator(
        task=task,
        coordinate_data_configs=data_configs,
        update_sequence=update_sequence,
        n_sweeps=args.sweeps,
        evaluator_specs=tuple(args.evaluators or ()),
        normalization=NormalizationType[args.normalization],
        intercept_indices={s: im.intercept_index for s, im in index_maps.items()},
        sweep_cache_mb=args.sweep_cache_mb,
    )
    with _checkpointing(args.checkpoint_dir) as ckpt, \
            Timed("fit", logger) as fit_timer:
        results = estimator.fit(
            train, validation if suite else None, configs,
            initial_model=initial_model, checkpoint_manager=ckpt)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    # Without evaluators the first configuration is the selected one, as in
    # the JAX driver.
    best = select_best(results, suite) if suite else results[0]
    best_i = next(i for i, r in enumerate(results) if r is best)

    shard_by_coordinate = {cid: c.feature_shard for cid, c in data_configs.items()}
    saved = {}
    with Timed("save models", logger):
        if args.output_mode == "ALL":
            for i, r in enumerate(results):
                mdir = os.path.join(args.output_dir, "models", str(i))
                save_game_model(mdir, r.model, index_maps, shard_by_coordinate,
                                shard_cfgs)
                saved[str(i)] = mdir
        bdir = os.path.join(args.output_dir, "best")
        save_game_model(bdir, best.model, index_maps, shard_by_coordinate,
                        shard_cfgs)
        saved["best"] = bdir
        for shard, im in index_maps.items():
            idir = os.path.join(args.output_dir, "index", shard)
            if isinstance(im, MmapIndexMap):
                # Copy a loaded store so the output directory is a
                # self-contained scoring input.
                if not os.path.exists(idir):
                    shutil.copytree(im.store_dir, idir)
            else:
                build_mmap_index(im, idir)

    for i, r in enumerate(results):
        for rec in r.tracker:
            res = rec.result
            if isinstance(res, list):       # a random effect's bucket results
                its = [int(b.iterations.max()) for b in res if b.iterations.numel()]
                logger.info(
                    "config %d sweep %d coord %s: %d buckets, at most %d "
                    "solver iterations a lane", i, rec.sweep, rec.coordinate_id,
                    len(res), max(its, default=0))
            else:
                logger.info(
                    "config %d sweep %d coord %s: %d iterations, %s, %d data "
                    "passes", i, rec.sweep, rec.coordinate_id, res.iterations,
                    res.reason_name(), res.data_passes)
    summary = {
        "task": task.name,
        "n_configs": len(results),
        "best_config_index": best_i,
        "best_config": {
            cid: dataclasses.asdict(best.config[cid]) for cid in best.config
        },
        "evaluation": dict(best.evaluation.values) if best.evaluation else None,
        "fit_seconds": fit_timer.seconds,
        "read_seconds": t_read.seconds,
        "reader": readers_used[0],
        "model_dirs": saved,
    }
    # enums are not JSON-serializable through asdict
    summary = json.loads(json.dumps(
        summary, default=lambda o: getattr(o, "name", str(o))))
    with open(os.path.join(args.output_dir, "training-summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    write_metrics_jsonl(
        os.path.join(args.output_dir, "metrics.jsonl"),
        (
            {"config": i, "sweep": rec.sweep, "coordinate": rec.coordinate_id,
             "seconds": rec.seconds,
             **(rec.validation.values if rec.validation else {})}
            for i, r in enumerate(results)
            for rec in r.tracker
        ),
    )
    logger.info("done; best config %d, evaluation %s", best_i,
                summary["evaluation"])
    return summary


def main() -> None:  # pragma: no cover - console entry
    run()


if __name__ == "__main__":  # pragma: no cover
    main()
