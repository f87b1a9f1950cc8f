"""GameEstimator: GAME fit over a configuration sweep, and the dataset
preparation it shares with the transformer.

Port of ``photon_tpu/estimators/game_estimator.py`` for fixed-effect
coordinates on one device: per-shard batches (with their accelerator
layouts) are built once and shared by every configuration of the sweep;
each configuration runs coordinate descent and yields a ``GameFitResult``.
Random-effect coordinates, down-sampling, feature normalization and
validation with evaluators belong to later slices of the port and raise
``NotImplementedError`` naming them.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from photon_tpu_torch.data.batch import LabeledBatch
from photon_tpu_torch.data.random_effect import (
    RandomEffectDataset,
    build_random_effect_dataset,
)
from photon_tpu_torch.estimators.config import (
    CoordinateDataConfig,
    FixedEffectDataConfig,
    GameOptimizationConfiguration,
    GLMOptimizationConfiguration,
    RandomEffectDataConfig,
)
from photon_tpu_torch.functions.objective import intercept_reg_mask
from photon_tpu_torch.functions.prior import PriorDistribution
from photon_tpu_torch.game.coordinates import FixedEffectCoordinate
from photon_tpu_torch.game.descent import (
    CoordinateDescent,
    CoordinateStepRecord,
    GameModel,
)
from photon_tpu_torch.io.data_reader import GameDataBundle
from photon_tpu_torch.types import TaskType

logger = logging.getLogger("photon_tpu_torch.estimators")


def build_re_dataset_from_bundle(
    bundle: GameDataBundle,
    cfg: RandomEffectDataConfig,
    intercept_index: Optional[int] = None,
) -> RandomEffectDataset:
    """Group a bundle's rows by ``cfg.re_type`` into a bucketed per-entity
    scoring dataset: every entity is kept (rows of entities unseen at
    training time score 0) and no active/passive split applies. The buckets
    follow the feature values' dtype and device. (The JAX function's
    training form — active bound, minimum rows, Pearson filter — comes with
    the training slice.)"""
    sf = bundle.features[cfg.feature_shard]
    if cfg.re_type not in bundle.id_tags:
        raise ValueError(
            f"random effect {cfg.re_type!r} needs id tag column "
            f"{cfg.re_type!r}; bundle has {sorted(bundle.id_tags)}"
        )
    return build_random_effect_dataset(
        re_type=cfg.re_type,
        entity_keys_per_row=bundle.id_tags[cfg.re_type],
        idx=sf.idx.detach().cpu().numpy(),
        val=sf.val.detach().cpu().numpy(),
        labels=np.asarray(bundle.labels),
        global_dim=sf.dim,
        weights=bundle.weights,
        intercept_index=intercept_index,
        dtype=sf.val.dtype,
        device=sf.device,
    )


@dataclasses.dataclass(frozen=True)
class GameFitResult:
    """One entry of the estimator's output: the model, its evaluation
    (None: validation comes with the evaluation slice), the configuration
    and the per-step tracker."""

    model: GameModel
    evaluation: Optional[dict]
    config: GameOptimizationConfiguration
    tracker: Sequence[CoordinateStepRecord]


@dataclasses.dataclass
class GameEstimator:
    """Configured GAME trainer; ``fit`` runs the configuration sweep.

    ``intercept_indices`` (shard → column) excludes intercepts from the L2
    penalty. The solves run where the bundle's features live. Evaluators
    and a ``normalization`` other than "NONE" (the JAX package's
    ``NormalizationType`` by name) belong to later slices and are refused.
    """

    task: TaskType
    coordinate_data_configs: Mapping[str, CoordinateDataConfig]
    update_sequence: Optional[Sequence[str]] = None
    n_sweeps: int = 1
    evaluator_specs: Sequence[str] = ()
    normalization: str = "NONE"
    intercept_indices: Optional[Mapping[str, int]] = None

    def __post_init__(self):
        if self.update_sequence is None:
            self.update_sequence = tuple(self.coordinate_data_configs)
        for cid in self.update_sequence:
            if cid not in self.coordinate_data_configs:
                raise ValueError(
                    f"update sequence names unknown coordinate {cid!r}"
                )
        for cid, dcfg in self.coordinate_data_configs.items():
            if not isinstance(dcfg, FixedEffectDataConfig):
                raise NotImplementedError(
                    f"coordinate {cid!r}: random-effect training is not in "
                    "the port yet (it comes with the random-effect training "
                    "slice, M5/M6)"
                )
        if self.evaluator_specs:
            raise NotImplementedError(
                "evaluators are not in the port yet (they come with the "
                "evaluation slice, M7)"
            )
        if self.normalization != "NONE":
            raise NotImplementedError(
                "feature normalization is not in the port yet (it comes with "
                "the data-preparation slice, M8)"
            )

    def fit(
        self,
        data: GameDataBundle,
        validation_data: Optional[GameDataBundle] = None,
        configs: Sequence[GameOptimizationConfiguration] = (),
        initial_model: Optional[GameModel] = None,
    ) -> list[GameFitResult]:
        """Train one GameModel per optimization configuration, on the
        device of the bundle's features. The per-shard batches and their
        accelerator layouts are built once for the whole sweep;
        ``initial_model`` warm-starts every configuration."""
        if not configs:
            raise ValueError("at least one GameOptimizationConfiguration required")
        if validation_data is not None:
            raise NotImplementedError(
                "validation data is not in the port yet (it comes with the "
                "evaluation slice, M7)"
            )
        for cfg in configs:
            missing = [c for c in self.update_sequence if c not in cfg]
            if missing:
                raise ValueError(f"configuration missing coordinates {missing}")
            for cid, ocfg in cfg.items():
                if ocfg.down_sampling_rate < 1.0:
                    raise NotImplementedError(
                        f"coordinate {cid!r}: down-sampling is not in the "
                        "port yet (it comes with the data-preparation slice, "
                        "M8)"
                    )

        batches = {
            shard: data.batch(shard)
            for shard in sorted({c.feature_shard
                                 for c in self.coordinate_data_configs.values()})
        }
        # Offsets enter as float32, as in the JAX estimator (the f64 parity
        # with offsets depends on this cast).
        base_offsets = torch.as_tensor(
            np.asarray(data.offsets), dtype=torch.float32, device=data.device)
        # One layout build per distinct feature object across the sweep.
        accel_cache: dict = {}
        results: list[GameFitResult] = []
        for i, cfg in enumerate(configs):
            logger.info("=== configuration %d/%d ===", i + 1, len(configs))
            coordinates = self._build_coordinates(
                batches, cfg, initial_model, accel_cache)
            model, tracker = CoordinateDescent(
                update_sequence=tuple(self.update_sequence),
                n_sweeps=self.n_sweeps,
            ).run(
                coordinates,
                n_rows=data.n_rows,
                base_offsets=base_offsets,
                initial_models=dict(initial_model.models) if initial_model else None,
            )
            results.append(GameFitResult(model, None, cfg, tracker))
        return results

    def _intercept_for(self, shard: str) -> Optional[int]:
        if self.intercept_indices is None:
            return None
        return self.intercept_indices.get(shard)

    def _build_coordinates(
        self,
        batches: Mapping[str, LabeledBatch],
        cfg: GameOptimizationConfiguration,
        initial_model: Optional[GameModel],
        accel_cache: dict,
    ) -> dict[str, FixedEffectCoordinate]:
        # Every data config gets a coordinate: those outside the update
        # sequence score locked warm-start models with a default problem
        # that never runs.
        coordinates = {}
        for cid, dcfg in self.coordinate_data_configs.items():
            ocfg = cfg.get(cid, GLMOptimizationConfiguration())
            problem = ocfg.problem(self.task)
            batch = batches[dcfg.feature_shard]
            mask = intercept_reg_mask(
                batch.dim, self._intercept_for(dcfg.feature_shard),
                device=batch.labels.device)
            if mask is not None:
                problem = dataclasses.replace(problem, reg_mask=mask)
            if ocfg.incremental_weight > 0.0:
                init_m = (initial_model.models.get(cid)
                          if initial_model is not None else None)
                if init_m is None:
                    raise ValueError(
                        f"coordinate {cid!r}: incremental_weight > 0 requires "
                        "an initial_model containing this coordinate"
                    )
                problem = dataclasses.replace(
                    problem,
                    prior=PriorDistribution.from_model(
                        init_m.model.coefficients.means,
                        init_m.model.coefficients.variances,
                        ocfg.incremental_weight,
                    ),
                )
            coordinates[cid] = FixedEffectCoordinate(
                batch=batch.with_accelerator_paths(accel_cache),
                problem=problem,
                feature_shard=dcfg.feature_shard,
            )
        return coordinates
