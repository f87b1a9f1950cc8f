"""GAME training driver: Avro data → trained model directory.

Port of ``photon_tpu/cli/game_training_driver.py`` (``run`` / ``_run_inner``)
for fixed-effect coordinates on one device: parse flags → build (or load)
the feature index maps → read the Avro training data → sanity checks →
``GameEstimator.fit`` over the regularization-weight sweep → save the
model(s), the index maps, ``training-summary.json`` and ``metrics.jsonl``.
The output layout is the JAX driver's (``best/``, ``models/<i>/`` under
``--output-mode ALL``, ``index/<shard>``), so either package's scoring
driver scores what this one writes.

Runs on the card by default (``--device cuda``, which fails when no GPU is
visible); ``--device cpu`` runs the plain versions of the kernels. Flags of
the JAX driver that belong to later slices of the port (random effects,
validation and evaluators, normalization, checkpoints and restarts, tuning,
meshes, the ingest pipeline, profiling and the runtime guards) are refused
with a message naming the slice.

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
from typing import Optional, Sequence

import torch

from photon_tpu_torch.cli.params import (
    configs_from_specs,
    parse_coordinates,
    parse_feature_shard,
)
from photon_tpu_torch.data.validators import DataValidationType, sanity_check_data
from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.estimators.game_estimator import GameEstimator
from photon_tpu_torch.index.index_map import MmapIndexMap, build_mmap_index
from photon_tpu_torch.io.data_reader import (
    AvroDataReader,
    FeatureShardConfig,
    InputColumnNames,
    build_index_from_avro,
)
from photon_tpu_torch.io.model_io import load_game_model, save_game_model
from photon_tpu_torch.types import TaskType
from photon_tpu_torch.utils import PhotonLogger, Timed, write_metrics_jsonl

_DTYPES = {"float32": torch.float32, "float64": torch.float64}

# Flags of the JAX driver that belong to later slices: (flag, is it set,
# the slice it comes with). Each is refused when set, never ignored.
_LATER_SLICES = (
    ("--validation-data", lambda a: a.validation_data is not None,
     "validation comes with the evaluation slice (M7)"),
    ("--evaluators", lambda a: a.evaluators is not None,
     "evaluators come with the evaluation slice (M7)"),
    ("--normalization", lambda a: a.normalization != "NONE",
     "feature normalization comes with the data-preparation slice (M8); use NONE"),
    ("--feature-summary", lambda a: a.feature_summary,
     "feature statistics come with the data-preparation slice (M8)"),
    ("--checkpoint-dir", lambda a: a.checkpoint_dir is not None,
     "checkpoints come with the checkpoint slice (M9)"),
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
    ("--ingest-workers", lambda a: a.ingest_workers > 1,
     "parallel decode comes with the ingest slice (M10); use 0 or 1"),
    ("--prefetch-depth", lambda a: a.prefetch_depth is not None,
     "the pipelined reader comes with the ingest slice (M10)"),
    ("--bf16-feed", lambda a: a.bf16_feed,
     "the bfloat16 feed comes with the ingest slice (M10)"),
    ("--sweep-cache-mb", lambda a: a.sweep_cache_mb is not None,
     "the device sweep cache comes with the ingest slice (M10)"),
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
    ("--re-routing", lambda a: a.re_routing is not None,
     "random-effect solver routing comes with the random-effect training "
     "slice (M6)"),
    ("--re-cost-table", lambda a: a.re_cost_table is not None,
     "random-effect solver routing comes with the random-effect training "
     "slice (M6)"),
)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="game-training-driver",
        description="Train a GAME model's fixed effects (PyTorch/CUDA).",
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
    # The JAX driver's flags that later slices bring: refused when set.
    p.add_argument("--validation-data", nargs="+", default=None)
    p.add_argument("--evaluators", nargs="+", default=None)
    p.add_argument("--normalization", default="NONE")
    p.add_argument("--feature-summary", action="store_true")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--max-restarts", type=int, default=0)
    p.add_argument("--restart-backoff", type=float, default=None)
    p.add_argument("--heartbeat-dir", default=None)
    p.add_argument("--tuning", default=None)
    p.add_argument("--tuning-iterations", type=int, default=None)
    p.add_argument("--tuning-range", action="append", default=None)
    p.add_argument("--devices", type=int, default=1)
    p.add_argument("--mesh", default=None)
    p.add_argument("--ingest-workers", type=int, default=0)
    p.add_argument("--prefetch-depth", type=int, default=None)
    p.add_argument("--bf16-feed", action="store_true")
    p.add_argument("--sweep-cache-mb", type=float, default=None)
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
    p.add_argument("--re-routing", default=None)
    p.add_argument("--re-cost-table", default=None)
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
    reader = AvroDataReader(
        index_maps,
        shard_cfgs,
        columns=InputColumnNames(
            uid=args.uid_column,
            response=args.response_column,
            offset=args.offset_column,
            weight=args.weight_column,
        ),
    )
    dtype = _DTYPES[args.dtype]
    with Timed("read training data", logger):
        train = reader.read(args.train_data, dtype=dtype, device=device)
    logger.info("training rows: %d on %s", train.n_rows, device)

    vtype = DataValidationType[args.data_validation]
    with Timed("data validation", logger):
        for shard in sorted(needed):
            sanity_check_data(train.batch(shard), task, vtype)

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
        intercept_indices={s: im.intercept_index for s, im in index_maps.items()},
    )
    with Timed("fit", logger) as fit_timer:
        results = estimator.fit(train, None, configs, initial_model=initial_model)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    # No evaluators: the first configuration is the selected one, as in the
    # JAX driver without --evaluators.
    best_i = 0
    best = results[best_i]

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
            logger.info(
                "config %d sweep %d coord %s: %d iterations, %s, %d data passes",
                i, rec.sweep, rec.coordinate_id, res.iterations,
                res.reason_name(), res.data_passes)
    summary = {
        "task": task.name,
        "n_configs": len(results),
        "best_config_index": best_i,
        "best_config": {
            cid: dataclasses.asdict(best.config[cid]) for cid in best.config
        },
        "evaluation": None,
        "fit_seconds": fit_timer.seconds,
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
             "seconds": rec.seconds}
            for i, r in enumerate(results)
            for rec in r.tracker
        ),
    )
    logger.info("done; best config %d", best_i)
    return summary


def main() -> None:  # pragma: no cover - console entry
    run()


if __name__ == "__main__":  # pragma: no cover
    main()
