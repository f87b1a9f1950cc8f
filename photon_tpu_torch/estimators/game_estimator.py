"""GameEstimator: GAME fit over a configuration sweep, and the dataset
preparation it shares with the transformer.

Port of ``photon_tpu/estimators/game_estimator.py``:
per-coordinate datasets (fixed-effect batches with their accelerator
layouts, bucketed random-effect datasets) are built once and shared by every
configuration of the sweep; each configuration runs coordinate descent,
with validation after every step when evaluators and validation data are
given, and yields a ``GameFitResult``; ``select_best`` picks the
configuration by the primary evaluator. A ``normalization`` other than NONE
builds one context per feature shard from its feature statistics, shared
by the shard's fixed and random effects; a coordinate's
``down_sampling_rate`` below 1 trains it on a down-sampled copy of its data
(fresh per configuration, keyed from ``seed`` as in the JAX package).
With a ``checkpoint_manager`` every coordinate step and every finished
configuration is snapshotted, and a fit over the same inputs resumes from
the newest snapshot, ending bit-identical to the uninterrupted fit.
Host-resident random-effect datasets are pinned on the device by one
``DeviceSweepCache`` per prepared bundle (``sweep_cache_mb``). A factored
random effect (``FactoredRandomEffectDataConfig``) trains on a plain random
effect's dataset; it refuses incremental training, down-sampling,
variances and normalization, as in the JAX package.

With a ``mesh`` (``parallel/mesh.py``) fixed effects train data-parallel
over its ``data_axis`` (the batch cut into row shards once, each with its
own layouts) and random effects entity-sharded over it, the sweep cache
pinning per device; a factored random effect trains on one device, as in
the JAX package. With ``model_axis`` (or, unset, for a fixed effect wider
than ``auto_p3_threshold`` on a mesh with a ``model`` axis) a fixed effect
trains feature-sharded (``parallel/model_parallel.py``); FULL variances,
other optimizers and normalization with a prior stay data-parallel.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from photon_tpu_torch.data.normalization import (
    NormalizationType,
    context_from_statistics,
)
from photon_tpu_torch.data.random_effect import (
    RandomEffectDataset,
    build_random_effect_dataset,
    down_sample_dataset,
)
from photon_tpu_torch.data.sampling import down_sampler_for_task
from photon_tpu_torch.data.statistics import compute_feature_statistics
from photon_tpu_torch.estimators.config import (
    CoordinateDataConfig,
    FactoredRandomEffectDataConfig,
    FixedEffectDataConfig,
    GameOptimizationConfiguration,
    GLMOptimizationConfiguration,
    RandomEffectDataConfig,
)
from photon_tpu_torch.evaluation import EvaluationResults, EvaluationSuite
from photon_tpu_torch.functions.objective import intercept_reg_mask
from photon_tpu_torch.functions.prior import PriorDistribution
from photon_tpu_torch.game.coordinates import (
    Coordinate,
    FactoredRandomEffectCoordinate,
    FixedEffectCoordinate,
    RandomEffectCoordinate,
)
from photon_tpu_torch.game.descent import (
    CoordinateDescent,
    CoordinateStepRecord,
    GameModel,
    ValidationData,
)
from photon_tpu_torch.io.data_reader import GameDataBundle
from photon_tpu_torch.parallel.model_parallel import MODEL_AXIS
from photon_tpu_torch.types import TaskType
from photon_tpu_torch.utils import threefry

logger = logging.getLogger("photon_tpu_torch.estimators")


def build_re_dataset_from_bundle(
    bundle: GameDataBundle,
    cfg: RandomEffectDataConfig,
    intercept_index: Optional[int] = None,
    for_scoring: bool = False,
) -> RandomEffectDataset:
    """Group a bundle's rows by ``cfg.re_type`` into a bucketed per-entity
    dataset on the bundle's device, in its feature values' dtype. For
    scoring and validation every entity is kept (rows of entities unseen at
    training time score 0) and no active/passive split or feature filter
    applies."""
    sf = bundle.features[cfg.feature_shard]
    if cfg.re_type not in bundle.id_tags:
        raise ValueError(
            f"random effect {cfg.re_type!r} needs id tag column "
            f"{cfg.re_type!r}; bundle has {sorted(bundle.id_tags)}"
        )
    # The bucket values follow the features' dtype, except that values
    # stored narrower than float32 (the bf16 feed) re-pack as float32, the
    # already rounded values, as the JAX package does: the Newton solves'
    # batched matmul and Cholesky run in float32.
    return build_random_effect_dataset(
        re_type=cfg.re_type,
        entity_keys_per_row=bundle.id_tags[cfg.re_type],
        idx=sf.idx.detach().cpu().numpy(),
        val=sf.val.detach().cpu().to(sf.dtype).numpy(),
        labels=np.asarray(bundle.labels),
        global_dim=sf.dim,
        weights=bundle.weights,
        intercept_index=intercept_index,
        dtype=sf.dtype,
        device=sf.device,
        active_bound=None if for_scoring else cfg.active_bound,
        min_entity_rows=1 if for_scoring else cfg.min_entity_rows,
        max_features_per_entity=(
            None if for_scoring else cfg.max_features_per_entity),
        max_bucket_entities=cfg.max_bucket_entities,
        host_resident=cfg.host_resident,
    )


def _factorize_group_ids(values: np.ndarray, device: torch.device):
    keys, inv = np.unique(values, return_inverse=True)
    return torch.from_numpy(inv.reshape(-1).astype(np.int32)).to(device), len(keys)


@dataclasses.dataclass(frozen=True)
class GameFitResult:
    """One entry of the estimator's output: the model, its evaluation on
    the validation data (None without), the configuration and the per-step
    tracker."""

    model: GameModel
    evaluation: Optional[EvaluationResults]
    config: GameOptimizationConfiguration
    tracker: Sequence[CoordinateStepRecord]


@dataclasses.dataclass
class GameEstimator:
    """Configured GAME trainer; ``fit`` runs the configuration sweep.

    ``intercept_indices`` (shard → column) excludes intercepts from the L2
    penalty, for fixed and random effects alike. The solves run where the
    bundle's features live. ``normalization`` is a ``NormalizationType`` or
    its name; ``seed`` keys the down-sampling draws.
    """

    task: TaskType
    coordinate_data_configs: Mapping[str, CoordinateDataConfig]
    update_sequence: Optional[Sequence[str]] = None
    n_sweeps: int = 1
    evaluator_specs: Sequence[str] = ()
    normalization: NormalizationType = NormalizationType.NONE
    intercept_indices: Optional[Mapping[str, int]] = None
    # Device sweep cache budget in MB for host-resident random-effect data
    # (data/device_cache.py); None = PHOTON_SWEEP_CACHE_MB (default 2048),
    # 0 disables. Per device under a mesh.
    sweep_cache_mb: Optional[float] = None
    seed: int = 0
    # A device mesh (parallel/mesh.py): fixed effects data-parallel and
    # random effects entity-sharded over ``data_axis``.
    mesh: Optional[object] = None
    data_axis: object = "data"
    # When set (with a mesh that has this axis), every fixed effect's
    # coefficients, gradient and optimizer state shard over it
    # (parallel/model_parallel.py). Unset, a mesh with a "model" axis
    # routes a fixed effect there when its dimension exceeds
    # ``auto_p3_threshold`` and fit_model_parallel supports its problem.
    model_axis: Optional[str] = None
    auto_p3_threshold: int = 1 << 20

    def __post_init__(self):
        if self.update_sequence is None:
            self.update_sequence = tuple(self.coordinate_data_configs)
        for cid in self.update_sequence:
            if cid not in self.coordinate_data_configs:
                raise ValueError(
                    f"update sequence names unknown coordinate {cid!r}"
                )
        for cid, dcfg in self.coordinate_data_configs.items():
            if not isinstance(dcfg, (FixedEffectDataConfig,
                                     RandomEffectDataConfig)):
                raise TypeError(f"coordinate {cid!r}: unknown data config "
                                f"{type(dcfg).__name__}")
        if isinstance(self.normalization, str):
            self.normalization = NormalizationType.parse(self.normalization)

    def fingerprint_parts(self) -> tuple:
        """The estimator's training-semantics identity, for checkpoint
        fingerprints."""
        return (
            self.task,
            tuple(self.update_sequence),
            self.n_sweeps,
            tuple(self.evaluator_specs),
            self.normalization,
            sorted((cid, repr(c))
                   for cid, c in self.coordinate_data_configs.items()),
        )

    def fit(
        self,
        data: GameDataBundle,
        validation_data: Optional[GameDataBundle] = None,
        configs: Sequence[GameOptimizationConfiguration] = (),
        initial_model: Optional[GameModel] = None,
        checkpoint_manager=None,
    ) -> list[GameFitResult]:
        """Train one GameModel per optimization configuration, on the
        device of the bundle's features. The datasets, their accelerator
        layouts and the validation structures are built once for the whole
        sweep; ``initial_model`` warm-starts every configuration.

        ``checkpoint_manager`` (``photon_tpu_torch.checkpoint
        .CheckpointManager``) snapshots every coordinate step and every
        finished configuration; a fit over the same inputs resumes from the
        newest snapshot (checked against this run's fingerprint)."""
        if not configs:
            raise ValueError("at least one GameOptimizationConfiguration required")
        for cfg in configs:
            missing = [c for c in self.update_sequence if c not in cfg]
            if missing:
                raise ValueError(f"configuration missing coordinates {missing}")
        suite = (EvaluationSuite.parse(self.evaluator_specs)
                 if self.evaluator_specs else None)
        if validation_data is not None and suite is None:
            raise ValueError("validation data provided but no evaluator_specs")

        prep = self._prepare_cached(data)
        validation = (self._prepare_validation_cached(validation_data, suite)
                      if validation_data is not None else None)
        # Offsets enter as float32, as in the JAX estimator (the f64 parity
        # with offsets depends on this cast).
        base_offsets = torch.as_tensor(
            np.asarray(data.offsets), dtype=torch.float32, device=data.device)
        # One layout build per distinct feature object across the sweep
        # (and across fits on the same bundle).
        accel_cache = prep["accel_cache"]
        results: list[GameFitResult] = []
        start_config, descent_resume, fingerprint = 0, None, None
        if checkpoint_manager is not None:
            from photon_tpu_torch.checkpoint import run_fingerprint

            fingerprint = run_fingerprint((
                self.fingerprint_parts(),
                [sorted((cid, repr(c)) for cid, c in cfg.items())
                 for cfg in configs],
                data.n_rows,
            ))
            payload = checkpoint_manager.load_checked(
                "game_fit", fingerprint, device=data.device)
            if payload is not None:
                meta = payload["meta"]
                results = list(payload["state"].get("completed_results", []))
                if meta.get("phase") == "config_done":
                    start_config = meta["config_index"] + 1
                else:
                    start_config = meta["config_index"]
                    descent_resume = payload
                logger.info("resuming from checkpoint step %d (config %d)",
                            payload["step"], start_config)
        # Each configuration owns steps_per_config descent steps and one
        # config-done slot.
        steps_per_config = self.n_sweeps * len(self.update_sequence)
        for i, cfg in enumerate(configs):
            if i < start_config:
                continue
            logger.info("=== configuration %d/%d ===", i + 1, len(configs))
            coordinates = self._build_coordinates(
                prep, cfg, i, initial_model, accel_cache)
            model, tracker = CoordinateDescent(
                update_sequence=tuple(self.update_sequence),
                n_sweeps=self.n_sweeps,
            ).run(
                coordinates,
                n_rows=data.n_rows,
                base_offsets=base_offsets,
                validation=validation,
                suite=suite,
                initial_models=dict(initial_model.models) if initial_model else None,
                checkpointer=checkpoint_manager,
                resume=descent_resume if i == start_config else None,
                step_base=i * (steps_per_config + 1),
                checkpoint_meta={"config_index": i, "kind": "game_fit",
                                 "fingerprint": fingerprint},
                extra_state={"completed_results": results},
            )
            evaluation = (self._evaluate(model, validation, suite)
                          if validation is not None else None)
            results.append(GameFitResult(model, evaluation, cfg, tracker))
            if checkpoint_manager is not None:
                checkpoint_manager.save(
                    i * (steps_per_config + 1) + steps_per_config,
                    state={"completed_results": results},
                    meta={"phase": "config_done", "config_index": i,
                          "kind": "game_fit", "fingerprint": fingerprint},
                )
        if checkpoint_manager is not None:
            checkpoint_manager.wait()
        return results

    def _intercept_for(self, shard: str) -> Optional[int]:
        if self.intercept_indices is None:
            return None
        return self.intercept_indices.get(shard)

    def _prepare_cached(self, data: GameDataBundle) -> dict:
        """Per-bundle preparation cache (size 1, identity-keyed): repeated
        fits on the same bundle reuse its datasets instead of regrouping
        the random effects."""
        cached = getattr(self, "_prep_cache", None)
        if cached is not None and cached[0] is data:
            return cached[1]
        if cached is not None:
            # a new bundle: drop the old one's device pins
            cached[1]["device_cache"].release()
        prep = self._prepare(data)
        self._prep_cache = (data, prep)
        return prep

    def _prepare_validation_cached(
        self, vdata: GameDataBundle, suite: EvaluationSuite
    ) -> ValidationData:
        cached = getattr(self, "_validation_cache", None)
        if cached is not None and cached[0] is vdata and cached[1] == suite:
            return cached[2]
        v = self._prepare_validation(vdata, suite)
        self._validation_cache = (vdata, suite, v)
        return v

    def _prepare(self, data: GameDataBundle) -> dict:
        """Per-shard batches and normalization contexts (None without
        normalization), per-coordinate random-effect datasets."""
        batches = {
            shard: data.batch(shard)
            for shard in sorted({c.feature_shard
                                 for c in self.coordinate_data_configs.values()})
        }
        accel_cache: dict = {}
        norm = {}
        for shard, batch in batches.items():
            norm[shard] = None
            if self.normalization != NormalizationType.NONE:
                # the statistics' sums are transposes: on CUDA through the
                # layouts the fixed effect then reuses
                stats = compute_feature_statistics(
                    batch.with_accelerator_paths(accel_cache))
                norm[shard] = context_from_statistics(
                    stats, self.normalization, self._intercept_for(shard))
        datasets = {
            cid: build_re_dataset_from_bundle(
                data, dcfg, self._intercept_for(dcfg.feature_shard))
            for cid, dcfg in self.coordinate_data_configs.items()
            if isinstance(dcfg, RandomEffectDataConfig)
        }
        # One sweep cache per prepared bundle, shared by every configuration
        # (same data: one upload for the whole sweep of configurations).
        from photon_tpu_torch.data.device_cache import DeviceSweepCache

        cache = DeviceSweepCache(None if self.sweep_cache_mb is None
                                 else int(self.sweep_cache_mb * 1e6),
                                 mesh=self.mesh, entity_axis=self.data_axis)
        return {"batches": batches, "norm": norm, "datasets": datasets,
                "prior_proj": {}, "accel_cache": accel_cache,
                "device_cache": cache}

    def _build_coordinates(
        self,
        prep: dict,
        cfg: GameOptimizationConfiguration,
        config_index: int,
        initial_model: Optional[GameModel],
        accel_cache: dict,
    ) -> dict[str, Coordinate]:
        # Every data config gets a coordinate: those outside the update
        # sequence score locked warm-start models with a default problem
        # that never runs.
        coordinates: dict[str, Coordinate] = {}
        for cid, dcfg in self.coordinate_data_configs.items():
            ocfg = cfg.get(cid, GLMOptimizationConfiguration())
            problem = ocfg.problem(self.task)
            intercept = self._intercept_for(dcfg.feature_shard)
            norm = prep["norm"][dcfg.feature_shard]
            sampler = key = None
            if ocfg.down_sampling_rate < 1.0:
                # per (configuration, coordinate): reproducible
                sampler = down_sampler_for_task(self.task, ocfg.down_sampling_rate)
                key = threefry.fold_in(threefry.fold_in(
                    threefry.PRNGKey(self.seed), config_index), len(coordinates))
            init_m = None
            if ocfg.incremental_weight > 0.0:
                init_m = (initial_model.models.get(cid)
                          if initial_model is not None else None)
                if init_m is None:
                    raise ValueError(
                        f"coordinate {cid!r}: incremental_weight > 0 requires "
                        "an initial_model containing this coordinate"
                    )
            if isinstance(dcfg, FixedEffectDataConfig):
                batch = prep["batches"][dcfg.feature_shard]
                mask = intercept_reg_mask(batch.dim, intercept,
                                          device=batch.labels.device)
                if mask is not None:
                    problem = dataclasses.replace(problem, reg_mask=mask)
                if init_m is not None:
                    problem = dataclasses.replace(
                        problem,
                        prior=PriorDistribution.from_model(
                            init_m.model.coefficients.means,
                            init_m.model.coefficients.variances,
                            ocfg.incremental_weight,
                        ),
                    )
                if sampler is not None:
                    batch = sampler.down_sample(key, batch)
                model_axis = self.model_axis
                if (
                    model_axis is None
                    and self.mesh is not None
                    and MODEL_AXIS in self.mesh.axis_names
                    and batch.dim > self.auto_p3_threshold
                    # Route only what fit_model_parallel supports; the rest
                    # stays data-parallel (replicated over the model axis)
                    # instead of failing mid-sweep.
                    and problem.optimizer_type.name in ("LBFGS", "OWLQN", "TRON")
                    and problem.variance_type.name != "FULL"
                    and not (norm is not None and problem.prior is not None)
                ):
                    model_axis = MODEL_AXIS
                coordinates[cid] = FixedEffectCoordinate(
                    # Under a mesh the shards build their own layouts; the
                    # whole batch only scores (ell_matvec needs none).
                    batch=(batch.with_accelerator_paths(accel_cache)
                           if self.mesh is None else batch),
                    problem=problem,
                    feature_shard=dcfg.feature_shard,
                    normalization=norm,
                    mesh=self.mesh,
                    data_axis=self.data_axis,
                    model_axis=model_axis,
                )
            elif isinstance(dcfg, FactoredRandomEffectDataConfig):
                # Options the factored solve does not take fail loudly
                # rather than silently do nothing.
                unsupported = []
                if ocfg.incremental_weight > 0.0:
                    unsupported.append("incremental training")
                if ocfg.down_sampling_rate < 1.0:
                    unsupported.append("down-sampling")
                if ocfg.variance_type.name != "NONE":
                    unsupported.append("coefficient variances")
                if norm is not None:
                    unsupported.append("feature normalization")
                if unsupported:
                    raise ValueError(
                        f"coordinate {cid!r}: {', '.join(unsupported)} "
                        "not supported for factored random effects"
                    )
                coordinates[cid] = FactoredRandomEffectCoordinate(
                    dataset=prep["datasets"][cid],
                    problem=problem,
                    latent_dim=dcfg.latent_dim,
                    n_alternations=dcfg.n_alternations,
                    seed=self.seed,
                )
            else:
                dataset = prep["datasets"][cid]
                priors = None
                if init_m is not None:
                    # The posterior projection does not depend on the
                    # configuration: cached across the sweep, keyed by the
                    # model object (identity checked on a hit).
                    hit = prep["prior_proj"].get(cid)
                    if hit is None or hit[0] is not init_m:
                        hit = (init_m, init_m.project_posteriors_to(dataset))
                        prep["prior_proj"][cid] = hit
                    means, variances = hit[1]
                    priors = [PriorDistribution.from_model(
                        m, v, ocfg.incremental_weight)
                        for m, v in zip(means, variances)]
                if sampler is not None:
                    # a fresh copy per configuration; it shares the
                    # prepared dataset's lane layouts
                    dataset = down_sample_dataset(dataset, sampler, key)
                coordinates[cid] = RandomEffectCoordinate(
                    dataset=dataset,
                    problem=problem,
                    global_reg_mask=intercept_reg_mask(
                        dataset.global_dim, intercept, device=dataset.device),
                    normalization=norm,
                    priors=priors,
                    # The cache pins only the shared prepared dataset: a
                    # down-sampled copy is a fresh object per configuration
                    # and streams per sweep.
                    device_cache=(prep["device_cache"] if sampler is None
                                  else None),
                    mesh=self.mesh,
                    entity_axis=self.data_axis,
                )
        return coordinates

    def _prepare_validation(
        self, vdata: GameDataBundle, suite: EvaluationSuite
    ) -> ValidationData:
        """Validation rows, per-coordinate scorers and grouped-evaluator
        ids, on the validation bundle's device."""
        shards = {c.feature_shard for c in self.coordinate_data_configs.values()}
        # Scoring runs one matvec per step: only the matvec's layout.
        v_feats = {s: vdata.features[s].with_matvec_layout() for s in shards}
        scorers: dict = {}
        for cid, dcfg in self.coordinate_data_configs.items():
            if isinstance(dcfg, FixedEffectDataConfig):
                vf = v_feats[dcfg.feature_shard]
                scorers[cid] = (
                    lambda m, vf=vf: vf.matvec(m.model.coefficients.means))
            else:
                v_ds = build_re_dataset_from_bundle(
                    vdata, dcfg, self._intercept_for(dcfg.feature_shard),
                    for_scoring=True)
                scorers[cid] = lambda m, v_ds=v_ds: m.score_new_dataset(v_ds)

        group_cols = {ev.group_column for ev in suite.evaluators
                      if ev.group_column is not None}
        gids, ngroups = {}, {}
        for col in group_cols:
            if col not in vdata.id_tags:
                raise ValueError(
                    f"grouped evaluator needs id tag column {col!r} in "
                    f"validation data; bundle has {sorted(vdata.id_tags)}"
                )
            gids[col], ngroups[col] = _factorize_group_ids(
                vdata.id_tags[col], vdata.device)

        def f32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                   device=vdata.device)

        return ValidationData(
            labels=f32(vdata.labels),
            weights=f32(vdata.weights),
            offsets=f32(vdata.offsets),
            scorers=scorers,
            group_ids_by_column=gids or None,
            num_groups_by_column=ngroups or None,
        )

    def _evaluate(self, model: GameModel, validation: ValidationData,
                  suite: EvaluationSuite) -> EvaluationResults:
        scores = validation.offsets + sum(
            validation.scorers[cid](model[cid]) for cid in model.keys())
        return suite.evaluate(
            scores, validation.labels, validation.weights,
            validation.group_ids_by_column, validation.num_groups_by_column)


def select_best(results: Sequence[GameFitResult],
                suite: EvaluationSuite) -> GameFitResult:
    """The configuration whose final validation primary metric is best (the
    first without any evaluation)."""
    scored = [r for r in results if r.evaluation is not None]
    if not scored:
        return results[0]
    best = scored[0]
    for r in scored[1:]:
        if suite.primary.better_than(r.evaluation.primary, best.evaluation.primary):
            best = r
    return best
