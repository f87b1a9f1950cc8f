"""Per-coordinate configuration objects for the GAME estimator.

Port of ``photon_tpu/estimators/config.py``: what data a coordinate trains
on (a data config, fixed per estimator) apart from how it optimizes (an
optimization config, swept over by ``GameEstimator.fit``). The factored
random-effect data config comes with a later slice (M12).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Mapping, Optional, Sequence, Union

from photon_tpu_torch.functions.problem import (
    GLMOptimizationProblem,
    VarianceComputationType,
)
from photon_tpu_torch.optim import OptimizerConfig, OptimizerType
from photon_tpu_torch.optim.regularization import RegularizationContext
from photon_tpu_torch.types import TaskType


@dataclasses.dataclass(frozen=True)
class FixedEffectDataConfig:
    """One population-level GLM on every row of one feature shard."""

    feature_shard: str = "global"


@dataclasses.dataclass(frozen=True)
class RandomEffectDataConfig:
    """Per-entity GLMs grouped by an id column.

    ``active_bound`` caps the rows each entity trains on (later rows are
    passive: scored, not trained on); ``min_entity_rows`` drops entities
    with fewer rows (they score through the zero model);
    ``max_features_per_entity`` keeps each entity's features most
    correlated with the label (Pearson); ``max_bucket_entities`` caps the
    entities of a bucket. ``host_resident`` keeps the buckets in host memory:
    the device sweep cache pins them on the device at first use, or they
    upload one bucket at a time.
    """

    re_type: str
    feature_shard: str = "global"
    active_bound: Optional[int] = None
    min_entity_rows: int = 1
    max_features_per_entity: Optional[int] = None
    max_bucket_entities: Optional[int] = None
    host_resident: bool = False


CoordinateDataConfig = Union[FixedEffectDataConfig, RandomEffectDataConfig]


@dataclasses.dataclass(frozen=True)
class GLMOptimizationConfiguration:
    """One coordinate's optimization recipe: optimizer, iterations,
    tolerance, regularization and its weight, down-sampling rate, variance
    mode and the incremental-training prior weight (0 = plain warm start)."""

    optimizer_type: OptimizerType = OptimizerType.LBFGS
    max_iterations: int = 80
    tolerance: float = 1e-7
    regularization: RegularizationContext = RegularizationContext()
    reg_weight: float = 0.0
    down_sampling_rate: float = 1.0
    variance_type: VarianceComputationType = VarianceComputationType.NONE
    incremental_weight: float = 0.0

    def __post_init__(self):
        if self.incremental_weight < 0.0:
            raise ValueError(
                f"incremental_weight must be >= 0, got {self.incremental_weight}"
            )
        if not (0.0 < self.down_sampling_rate <= 1.0):
            raise ValueError(
                f"down_sampling_rate must be in (0, 1], got {self.down_sampling_rate}"
            )

    def problem(self, task: TaskType) -> GLMOptimizationProblem:
        return GLMOptimizationProblem(
            task=task,
            optimizer_type=self.optimizer_type,
            optimizer_config=OptimizerConfig(
                max_iterations=self.max_iterations, tolerance=self.tolerance
            ),
            regularization=self.regularization,
            reg_weight=self.reg_weight,
            variance_type=self.variance_type,
        )

    def with_reg_weight(self, w: float) -> "GLMOptimizationConfiguration":
        return dataclasses.replace(self, reg_weight=w)


# One full GAME optimization configuration: coordinate id -> its opt config.
GameOptimizationConfiguration = Mapping[str, GLMOptimizationConfiguration]


def reg_weight_sweep(
    base: GameOptimizationConfiguration,
    reg_weights: Mapping[str, Sequence[float]],
) -> list[dict[str, GLMOptimizationConfiguration]]:
    """The cartesian product of per-coordinate regularization weights over
    a base configuration (the reference driver's multi-weight sweep)."""
    for cid in reg_weights:
        if cid not in base:
            raise ValueError(f"reg_weights names unknown coordinate {cid!r}")
    cids = sorted(reg_weights)
    out = []
    for combo in itertools.product(*(reg_weights[c] for c in cids)):
        cfg = dict(base)
        for cid, w in zip(cids, combo):
            cfg[cid] = cfg[cid].with_reg_weight(w)
        out.append(cfg)
    return out
