"""Single-GLM training driver with diagnostics (PyTorch/CUDA).

Port of ``photon_tpu/cli/glm_training_driver.py``: read the training (and
validation) Avro data → optional normalization → one fixed-effect GLM per
regularization weight of the grid → validate and select → diagnostics on
the selected model (bootstrap coefficient CIs, Hosmer–Lemeshow calibration,
feature importance) → the model as a one-coordinate GAME model with its
mmap index, and the HTML / JSON fit report.

Two routes, as in the JAX driver:
* in-core: the whole dataset on the device (``--row-chunk-rows 0``);
* out-of-core (``optim/out_of_core.py``): the ELL and CSC layouts stay on
  the host in row chunks and stream to the device every pass
  (``--row-chunk-rows N``; L-BFGS with L2 or OWL-QN with any L1 component,
  no normalization, variance or bootstrap: ``_ooc_unsupported_flag``). With
  ``--row-chunk-rows -1`` (the default) a run on ``cuda`` routes out of core
  when the Avro bytes × ``PHOTON_AVRO_EXPANSION_FACTOR`` (default 4) exceed
  ``PHOTON_DEVICE_DATA_BUDGET_GB`` (default 10), the JAX driver's rule and
  defaults, unless a flag needs the in-core path.

``PHOTON_VALUE_DTYPE=bfloat16`` stores the feature values as bfloat16: the
out-of-core chunks (half the value bytes of every streamed pass) and, on
``cuda``, the in-core layouts (``SparseFeatures.with_accelerator_paths``).

``--device`` (default ``cuda``; ``cpu`` only when named) places the run.
``--backend-policy`` probes the card first (``strict``, the default: a
failed probe exits 2 with one classified line; ``failover``: the CPU, with
``backend: cpu`` in the summary; ``cpu-only``: ``--device cpu``). An
out-of-core solve recovers in-run from an OOM (half the rows a chunk) and
from a device loss (``optim/out_of_core.py``). ``--trace-out`` and
``--telemetry-dir`` (role ``glm-training``) write the run's trace and
registry shard as the JAX driver does, also for a failed run.
``--devices N`` (0 = every visible card) streams the out-of-core chunks
row-sharded over N cards, as the JAX driver does (N must divide the chunk
rows; the in-core route ignores it, as JAX's does);
``--compilation-cache-dir`` is refused for good (the port compiles no XLA
programs).

    python -m photon_tpu_torch.cli.glm_training_driver \\
      --train-data data/train --validation-data data/val \\
      --output-dir out --task LOGISTIC_REGRESSION \\
      --regularization L2 --reg-weights 0.01 0.1 1 10 \\
      --bootstrap-replicates 32
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import Optional, Sequence

import numpy as np
import torch

from photon_tpu_torch.cli.params import (
    NO_COMPILED_PROGRAMS,
    add_backend_policy_flag,
    add_telemetry_flag,
    add_trace_flag,
    console_main,
    enable_backend_guard,
    enable_telemetry,
    enable_trace,
    finish_telemetry,
    finish_trace,
    mesh_from_flags,
    parse_feature_shard,
    refuse_unported,
    stamp_failover,
)
from photon_tpu_torch.data.normalization import NormalizationType, context_from_statistics
from photon_tpu_torch.data.statistics import compute_feature_statistics
from photon_tpu_torch.data.validators import (
    SAMPLE_ROWS_DEFAULT,
    DataValidationType,
    sanity_check_data,
)
from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.evaluation import EvaluationSuite
from photon_tpu_torch.functions.problem import (
    GLMOptimizationProblem,
    VarianceComputationType,
)
from photon_tpu_torch.index.index_map import MmapIndexMap, build_mmap_index
from photon_tpu_torch.io.data_reader import (
    AvroDataReader,
    FeatureShardConfig,
    InputColumnNames,
    _expand_paths,
    build_index_from_avro,
)
from photon_tpu_torch.io.model_io import save_game_model
from photon_tpu_torch.optim import OptimizerConfig, OptimizerType
from photon_tpu_torch.optim.regularization import (
    RegularizationContext,
    RegularizationType,
)
from photon_tpu_torch.runtime import memory_guard
from photon_tpu_torch.types import TaskType
from photon_tpu_torch.utils import PhotonLogger, Timed

SHARD = "global"
_DTYPES = {"float32": torch.float32, "float64": torch.float64}

# Flags of the JAX driver the port refuses: (flag, is it set, why). Each is
# refused when set, never ignored.
_LATER_SLICES = (
    ("--compilation-cache-dir", lambda a: a.compilation_cache_dir is not None,
     NO_COMPILED_PROGRAMS),
)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="glm-training-driver",
        description="Train a single fixed-effect GLM with diagnostics "
                    "(PyTorch/CUDA).",
    )
    p.add_argument("--train-data", nargs="+", required=True)
    p.add_argument("--validation-data", nargs="+", default=None)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--task", required=True, choices=[t.name for t in TaskType])
    p.add_argument("--feature-shard", default="global:features",
                   metavar="SHARD[:BAG+BAG][:no-intercept]",
                   help=f"single feature-shard spec (shard name must be '{SHARD}')")
    p.add_argument("--optimizer", default="LBFGS",
                   choices=[o.name for o in OptimizerType])
    p.add_argument("--regularization", default="L2",
                   choices=[r.name for r in RegularizationType])
    p.add_argument("--elastic-net-alpha", type=float, default=0.5)
    p.add_argument("--reg-weights", nargs="+", type=float, default=[1.0],
                   help="regularization-weight grid")
    p.add_argument("--max-iterations", type=int, default=80)
    p.add_argument("--tolerance", type=float, default=1e-7)
    p.add_argument("--normalization", default="NONE",
                   choices=[n.name for n in NormalizationType])
    p.add_argument("--data-validation", default="VALIDATE_FULL",
                   choices=[v.name for v in DataValidationType])
    p.add_argument("--evaluators", nargs="+", default=None,
                   help="evaluator specs; first is primary; defaults per task")
    p.add_argument("--variance", default="SIMPLE",
                   choices=[v.name for v in VarianceComputationType],
                   help="coefficient variances saved with the model")
    p.add_argument("--index-dir", default=None)
    p.add_argument("--bootstrap-replicates", type=int, default=0,
                   help="0 disables bootstrap CIs")
    p.add_argument("--bootstrap-confidence", type=float, default=0.95)
    p.add_argument("--hl-bins", type=int, default=10,
                   help="Hosmer-Lemeshow bins (logistic task only)")
    p.add_argument("--no-report", action="store_true",
                   help="skip the HTML fit report")
    p.add_argument("--offset-column", default="offset")
    p.add_argument("--weight-column", default="weight")
    p.add_argument("--response-column", default="response")
    p.add_argument("--uid-column", default="uid")
    p.add_argument("--dtype", default="float32", choices=sorted(_DTYPES))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where training runs (default cuda; no fallback)")
    p.add_argument("--row-chunk-rows", type=int, default=-1,
                   help="out-of-core training: keep the data on the host in "
                        "row chunks of this size and stream them to the "
                        "device every pass (LBFGS+L2 or OWLQN, normalization "
                        "and variance NONE, float32). 0 = always in-core; -1 "
                        "= auto (on cuda, out of core when the input files "
                        "times $PHOTON_AVRO_EXPANSION_FACTOR, default 4, "
                        "exceed $PHOTON_DEVICE_DATA_BUDGET_GB, default 10)")
    add_backend_policy_flag(p)
    add_telemetry_flag(p)
    add_trace_flag(p)
    p.add_argument("--devices", type=int, default=1,
                   help="out-of-core route only: stream row chunks sharded "
                        "over this many devices (0 = all visible, 1 = single "
                        "device; the device count must divide "
                        "--row-chunk-rows)")
    # The JAX driver's flags the port refuses (_LATER_SLICES).
    p.add_argument("--compilation-cache-dir", default=None)
    return p


def _default_evaluators(task: TaskType) -> tuple[str, ...]:
    return {
        TaskType.LOGISTIC_REGRESSION: ("AUC", "LOGISTIC_LOSS"),
        TaskType.LINEAR_REGRESSION: ("RMSE",),
        TaskType.POISSON_REGRESSION: ("POISSON_LOSS",),
        TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: ("AUC",),
    }[task]


def _columns(args) -> InputColumnNames:
    return InputColumnNames(uid=args.uid_column, response=args.response_column,
                            offset=args.offset_column, weight=args.weight_column)


def _save_best(args, imap, shard_cfg, best, logger) -> None:
    """The selected model as a one-coordinate GAME model plus its mmap
    index: shared by both routes."""
    from photon_tpu_torch.game.coordinates import FixedEffectModel
    from photon_tpu_torch.game.descent import GameModel

    with Timed("save model", logger):
        gm = GameModel(models={"fixed": FixedEffectModel(model=best,
                                                         feature_shard=SHARD)})
        save_game_model(os.path.join(args.output_dir, "best"), gm,
                        {SHARD: imap}, {"fixed": SHARD}, {SHARD: shard_cfg})
        idir = os.path.join(args.output_dir, "index", SHARD)
        if isinstance(imap, MmapIndexMap):
            if not os.path.exists(idir):
                shutil.copytree(imap.store_dir, idir)
        else:
            build_mmap_index(imap, idir)


def _ooc_unsupported_flag(args):
    """``(flag, wanted, got)`` for the first flag the out-of-core route
    cannot honor, else None: the one rule of the auto-router (which stays
    in-core, and says why) and of an explicit ``--row-chunk-rows`` (which
    raises)."""
    ok_pairs = {
        ("LBFGS", "L2"), ("OWLQN", "L1"), ("OWLQN", "ELASTIC_NET"),
        ("OWLQN", "L2"),
    }
    if (args.optimizer, args.regularization) not in ok_pairs:
        if args.optimizer not in ("LBFGS", "OWLQN"):
            return "--optimizer", "LBFGS|OWLQN", args.optimizer
        return ("--regularization",
                "L2" if args.optimizer == "LBFGS" else "L1|ELASTIC_NET|L2",
                args.regularization)
    for flag, want, got in (
        ("--normalization", "NONE", args.normalization),
        ("--variance", "NONE", args.variance),
        ("--dtype", "float32", args.dtype),
    ):
        if got != want:
            return flag, want, got
    if args.bootstrap_replicates:
        return "--bootstrap-replicates", "0", str(args.bootstrap_replicates)
    return None


def _problem(args, task, lam: float, variance=VarianceComputationType.NONE):
    return GLMOptimizationProblem(
        task=task,
        optimizer_type=OptimizerType[args.optimizer],
        optimizer_config=OptimizerConfig(max_iterations=args.max_iterations,
                                         tolerance=args.tolerance),
        regularization=RegularizationContext(
            RegularizationType[args.regularization],
            elastic_net_alpha=args.elastic_net_alpha),
        reg_weight=lam,
        variance_type=variance,
    )


def _run_out_of_core(args, task, imap, shard_cfg, chunk_rows, device,
                     logger) -> dict:
    """The out-of-core route (``optim/out_of_core.py``); a flag it cannot
    honor raises rather than degrade."""
    from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures
    from photon_tpu_torch.io.prefetch import prefetch
    from photon_tpu_torch.io.streaming import StreamingAvroReader
    from photon_tpu_torch.optim.out_of_core import (
        ChunkedGLMData,
        run_out_of_core,
        scores_out_of_core,
    )

    bad = _ooc_unsupported_flag(args)
    if bad is not None:
        flag, want, got = bad
        raise ValueError(
            f"out-of-core training supports {flag}={want} only (got {got}); "
            "pass --row-chunk-rows 0 to force in-core")
    # Chunks stream row-sharded over a data mesh (--devices); the device
    # count must divide the chunk rows, checked before any decoding.
    mesh = mesh_from_flags(args.devices, None, device)
    if mesh is not None:
        if chunk_rows % mesh.devices.size != 0:
            raise ValueError(
                f"--row-chunk-rows {chunk_rows} must be divisible by the "
                f"{mesh.devices.size}-device data mesh (--devices) for "
                "row-sharded streaming")
        logger.info("out-of-core streaming over %d-device data mesh",
                    mesh.devices.size)
    columns = _columns(args)
    sreader = StreamingAvroReader({SHARD: imap}, {SHARD: shard_cfg}, columns, (),
                                  chunk_rows=chunk_rows, capture_uids=False)
    value_dtype = os.environ.get("PHOTON_VALUE_DTYPE") or None
    validation = DataValidationType[args.data_validation]

    def validate_chunk(i, c, lab, off, wgt):
        """``--data-validation`` on each chunk the moment it is made (a NaN
        in the first chunk raises at once), on the host copy; padding rows
        carry weight 0 and ghost columns, as the in-core batch."""
        idx, val = c.idx, c.val
        lab, off, wgt = lab.cpu(), off.cpu(), wgt.cpu()
        if validation is DataValidationType.VALIDATE_SAMPLE:
            n = SAMPLE_ROWS_DEFAULT
            idx, val, lab, off, wgt = idx[:n], val[:n], lab[:n], off[:n], wgt[:n]
        sanity_check_data(
            LabeledBatch(features=SparseFeatures(idx=idx, val=val, dim=len(imap)),
                         labels=lab, offsets=off, weights=wgt),
            task, validation)

    on_chunk = (None if validation is DataValidationType.VALIDATE_DISABLED
                else validate_chunk)
    with Timed("stream training data (host chunks, validated)", logger) as t_read:
        data = ChunkedGLMData.from_stream(
            prefetch(sreader.iter_chunks(args.train_data)), SHARD, len(imap),
            chunk_rows=chunk_rows, value_dtype=value_dtype, on_chunk=on_chunk,
            device=device)
    gb_ell = data.streamed_bytes_per_pass("ell") / 1e9
    gb_csc = data.streamed_bytes_per_pass("csc") / 1e9
    logger.info("out-of-core: %d rows in %d chunks (values %s), %.3f GB a "
                "matvec pass, %.3f GB a gradient pass", data.n_rows,
                data.n_chunks, data.value_dtype, gb_ell, gb_csc)

    suite = EvaluationSuite.parse(list(args.evaluators or _default_evaluators(task)))
    val_batch = None
    if args.validation_data:
        reader = AvroDataReader({SHARD: imap}, {SHARD: shard_cfg}, columns=columns)
        with Timed("read validation data", logger):
            val_batch = reader.read(args.validation_data, dtype=torch.float32,
                                    device=device, capture_uids=False).batch(SHARD)

    sweep, models, results, best_i = [], [], [], 0
    ck_dir = os.path.join(args.output_dir, "ooc_checkpoints")
    os.makedirs(ck_dir, exist_ok=True)
    with Timed("regularization sweep (out-of-core)", logger) as t_fit:
        for i, lam in enumerate(args.reg_weights):
            # A killed run resumes each λ's solve at its last saved
            # iteration (the fingerprint guards against other data or
            # configuration; λ is in the file name).
            model, result = run_out_of_core(
                _problem(args, task, lam), data,
                progress=lambda it, f, gn, p, lam=lam: logger.info(
                    "λ=%g iter %d: f=%.6g |g|=%.3g passes=%d", lam, it, f, gn, p),
                checkpoint_path=os.path.join(ck_dir, f"lam_{lam:g}.ckpt"),
                mesh=mesh)
            if val_batch is not None:
                scores = model.compute_score(val_batch.features, val_batch.offsets)
                ev = suite.evaluate(scores, val_batch.labels, val_batch.weights)
            else:
                scores = torch.from_numpy(scores_out_of_core(data, model.coefficients.means))
                ev = suite.evaluate(scores, torch.from_numpy(data.labels_np()),
                                    torch.from_numpy(data.weights_np()))
            sweep.append({
                "reg_weight": lam,
                "iterations": int(result.iterations),
                "objective": float(result.value),
                "data_passes": int(result.data_passes),
                **{k: float(v) for k, v in ev.values.items()},
            })
            models.append(model)
            results.append(result)
            if i > 0 and suite.primary.better_than(
                    ev.primary, sweep[best_i][suite.primary.name]):
                best_i = i
            logger.info("λ=%g: %s", lam, sweep[-1])
    best, best_lam = models[best_i], args.reg_weights[best_i]
    logger.info("selected λ=%g (%s)", best_lam, suite.primary.name)
    _save_best(args, imap, shard_cfg, best, logger)

    summary = {
        "task": task.name,
        "mode": "out_of_core",
        "row_chunk_rows": chunk_rows,
        "n_rows": data.n_rows,
        "n_chunks": data.n_chunks,
        "value_dtype": str(data.value_dtype).removeprefix("torch."),
        "streamed_gb_per_pass": round(gb_ell, 3),
        "streamed_gb_per_gradient_pass": round(gb_csc, 3),
        "h2d_bytes": data.h2d_bytes + sum(
            view.h2d_bytes for _, view in data.mesh_views.values()),
        "read_seconds": t_read.seconds,
        "fit_seconds": t_fit.seconds,
        "selected_reg_weight": best_lam,
        "sweep": sweep,
        "evaluation": sweep[best_i],
        "converged_reason": results[best_i].reason_name(),
        "model_dir": os.path.join(args.output_dir, "best"),
    }
    with open(os.path.join(args.output_dir, "training-summary.json"), "w") as f:
        json.dump(stamp_failover(summary), f, indent=2)
    return summary


def _auto_chunk_rows(args, device, logger) -> int:
    """The auto-router: ``--row-chunk-rows -1`` on ``cuda`` goes out of core
    (chunks of 2^20 rows) when the estimated decoded size passes the
    device budget, unless a flag needs in-core (then it stays, and says
    why). On the CPU it stays in-core."""
    budget_gb = float(os.environ.get("PHOTON_DEVICE_DATA_BUDGET_GB", "10"))
    total = sum(os.path.getsize(f) for f in _expand_paths(args.train_data))
    # On-disk Avro bytes underestimate the decoded size (deflate blocks
    # shrink 3-5x; ELL adds padding): a conservative expansion factor.
    expand = float(os.environ.get("PHOTON_AVRO_EXPANSION_FACTOR", "4"))
    est = total * expand
    rows = (1 << 20) if (device.type == "cuda" and est > budget_gb * 1e9) else 0
    bad = _ooc_unsupported_flag(args) if rows else None
    if bad is not None:
        logger.warning(
            "train data est. %.1f GB decoded exceeds device budget %.0f GB but "
            "%s=%s requires the in-core path; staying in-core (set %s=%s to "
            "enable out-of-core streaming; forcing with --row-chunk-rows N "
            "also needs that flag)", est / 1e9, budget_gb, bad[0], bad[2],
            bad[0], bad[1])
        rows = 0
    if rows:
        logger.info("train data %.1f GB on disk (est. %.1f GB decoded) exceeds "
                    "device budget %.0f GB: out-of-core path (chunk %d rows)",
                    total / 1e9, est / 1e9, budget_gb, rows)
    return rows


def run(argv: Optional[Sequence[str]] = None) -> dict:
    p = build_arg_parser()
    args = p.parse_args(argv)
    refuse_unported(p, args, _LATER_SLICES)
    try:
        mesh_from_flags(args.devices, None, args.device)
    except ValueError as e:
        p.error(str(e))
    guard = enable_backend_guard(args)
    enable_telemetry(args, role="glm-training")
    enable_trace(args.trace_out)
    try:
        return _run(args, guard)
    finally:
        finish_trace(args.trace_out)
        finish_telemetry(args)


def _run(args, guard: dict) -> dict:
    device = resolve_device("cpu" if guard["backend"] == "cpu" else args.device)
    memory_guard.reset_state()      # downshifts are sticky for one run
    task = TaskType[args.task]
    os.makedirs(args.output_dir, exist_ok=True)
    with PhotonLogger(args.output_dir) as logger:
        shard_spec = parse_feature_shard(args.feature_shard)
        if shard_spec.shard != SHARD:
            raise ValueError(
                f"the single-GLM driver uses one shard named '{SHARD}', got "
                f"{shard_spec.shard!r}")
        shard_cfg = FeatureShardConfig(feature_bags=shard_spec.feature_bags,
                                       add_intercept=shard_spec.add_intercept)
        if args.index_dir:
            imap = MmapIndexMap(os.path.join(args.index_dir, SHARD))
        else:
            imap = build_index_from_avro(args.train_data,
                                         feature_bags=shard_cfg.feature_bags,
                                         add_intercept=shard_cfg.add_intercept)
        logger.info("index: %d features", len(imap))
        rows = args.row_chunk_rows
        if rows < 0:
            rows = _auto_chunk_rows(args, device, logger)
        if rows:
            return _run_out_of_core(args, task, imap, shard_cfg, rows, device,
                                    logger)
        return _run_in_core(args, task, imap, shard_cfg, device, logger)


def _run_in_core(args, task, imap, shard_cfg, device, logger) -> dict:
    dtype = _DTYPES[args.dtype]
    reader = AvroDataReader({SHARD: imap}, {SHARD: shard_cfg}, columns=_columns(args))
    with Timed("read training data", logger) as t_read:
        # Training never reads the uid column.
        train = reader.read(args.train_data, dtype=dtype, device=device,
                            capture_uids=False)
    batch = train.batch(SHARD)
    sanity_check_data(batch, task, DataValidationType[args.data_validation])
    # On cuda: the CSC (and, where it pays, the panel) layout, once; under
    # PHOTON_VALUE_DTYPE the values narrow. Nothing on the CPU.
    batch = batch.with_accelerator_paths()
    val_batch = None
    if args.validation_data:
        with Timed("read validation data", logger):
            val_batch = reader.read(args.validation_data, dtype=dtype, device=device,
                                    capture_uids=False).batch(SHARD)

    # One statistics pass serves the normalization context and the feature
    # importance.
    stats = compute_feature_statistics(batch)
    norm = None
    if NormalizationType[args.normalization] != NormalizationType.NONE:
        norm = context_from_statistics(stats, NormalizationType[args.normalization],
                                       imap.intercept_index)
    suite = EvaluationSuite.parse(list(args.evaluators or _default_evaluators(task)))
    d = batch.features.dim
    w0 = torch.zeros(d, dtype=batch.labels.dtype, device=device)
    eval_batch = val_batch if val_batch is not None else batch
    sweep, models, best_i = [], [], 0
    # The sweep solves with variances off; the winner's variances come from
    # one warm-started refit afterwards.
    with Timed("regularization sweep", logger) as t_fit:
        for i, lam in enumerate(args.reg_weights):
            model, result = _problem(args, task, lam).fit(batch, w0, normalization=norm)
            scores = model.compute_score(eval_batch.features, eval_batch.offsets)
            ev = suite.evaluate(scores, eval_batch.labels, eval_batch.weights)
            sweep.append({
                "reg_weight": lam,
                "iterations": int(result.iterations),
                "objective": float(result.value),
                **{k: float(v) for k, v in ev.values.items()},
            })
            models.append(model)
            if suite.primary.better_than(
                    ev.primary, sweep[best_i][suite.primary.name]) and i > 0:
                best_i = i
            logger.info("λ=%g: %s", lam, sweep[-1])
    best, best_lam = models[best_i], args.reg_weights[best_i]
    logger.info("selected λ=%g (%s)", best_lam, suite.primary.name)
    variance_type = VarianceComputationType[args.variance]
    if variance_type != VarianceComputationType.NONE:
        with Timed("selected-model variances", logger):
            best, _ = _problem(args, task, best_lam, variance_type).fit(
                batch, best.coefficients.means, normalization=norm)

    from photon_tpu_torch.diagnostics import (
        bootstrap_coefficients,
        feature_importance,
        hosmer_lemeshow,
        write_fit_report,
    )

    boot = None
    if args.bootstrap_replicates > 0:
        with Timed("bootstrap CIs", logger):
            boot = bootstrap_coefficients(
                _problem(args, task, best_lam), batch, w0,
                n_replicates=args.bootstrap_replicates,
                confidence=args.bootstrap_confidence, normalization=norm)
    hl = None
    if task == TaskType.LOGISTIC_REGRESSION and args.hl_bins > 1:
        scores = best.compute_score(eval_batch.features, eval_batch.offsets)
        hl = hosmer_lemeshow(scores, eval_batch.labels, n_bins=args.hl_bins,
                             weights=eval_batch.weights)
        logger.info("Hosmer-Lemeshow: stat=%.3f df=%d p=%.4f", hl.statistic, hl.df,
                    hl.p_value)
    coefs = best.coefficients.means.detach().cpu().numpy()
    imp = feature_importance(coefs, stats)

    _save_best(args, imap, shard_cfg, best, logger)

    report_path = None
    if not args.no_report:
        names = [imap.get_feature(j) for j in range(len(imap))]
        report_path = write_fit_report(
            args.output_dir,
            task=task.name,
            feature_names=[f"{n}:{t}" if t else n for n, t in names],
            coefficients=np.asarray(coefs),
            config_summary={
                "optimizer": args.optimizer,
                "regularization": args.regularization,
                "selected_reg_weight": best_lam,
                "normalization": args.normalization,
                "dtype": args.dtype,
                "n_rows": train.n_rows,
                "n_features": d,
            },
            sweep_metrics=sweep,
            bootstrap=boot,
            hosmer_lemeshow=hl,
            importance=imp,
        )
        logger.info("fit report: %s", report_path)

    summary = {
        "task": task.name,
        "selected_reg_weight": best_lam,
        "sweep": sweep,
        "evaluation": sweep[best_i],
        "hosmer_lemeshow_p": None if hl is None else hl.p_value,
        "report": report_path,
        "model_dir": os.path.join(args.output_dir, "best"),
        "mode": "in_core",
        "value_dtype": str(batch.features.val.dtype).removeprefix("torch."),
        "read_seconds": t_read.seconds,
        "fit_seconds": t_fit.seconds,
    }
    with open(os.path.join(args.output_dir, "training-summary.json"), "w") as f:
        json.dump(stamp_failover(summary), f, indent=2)
    return summary


def main() -> None:  # pragma: no cover - console entry
    console_main(run)


if __name__ == "__main__":  # pragma: no cover
    main()
