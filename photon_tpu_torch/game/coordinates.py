"""GAME coordinate models.

Port of ``photon_tpu/game/coordinates.py``: ``FixedEffectModel`` and the
trainable ``FixedEffectCoordinate`` on one device (no mesh, no
feature-sharded model axis; the random-effect coordinates come with the
random-effect training slice). A coordinate owns its training data and
problem and exposes ``train(offsets, init) -> (model, result)`` and
``score(model) -> [N]``; offsets are per-row tensors in the global sample
order, so residuals are elementwise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from photon_tpu_torch.data.batch import LabeledBatch
from photon_tpu_torch.functions.problem import GLMOptimizationProblem
from photon_tpu_torch.game.random_effect import RandomEffectModel
from photon_tpu_torch.models.glm import GeneralizedLinearModel
from photon_tpu_torch.optim import OptimizerResult

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FixedEffectModel:
    """Population-level GLM for one feature shard."""

    model: GeneralizedLinearModel
    feature_shard: str

    def score_batch(self, batch: LabeledBatch) -> Tensor:
        """Raw per-row scores WITHOUT offsets (GAME sums coordinate scores)."""
        return batch.features.matvec(self.model.coefficients.means)


@dataclasses.dataclass(frozen=True)
class FixedEffectCoordinate:
    """Train one GLM on all rows of the batch (whose offsets field is
    replaced per ``train`` call)."""

    batch: LabeledBatch
    problem: GLMOptimizationProblem
    feature_shard: str = "global"

    def train(
        self, offsets: Tensor, init: Optional[FixedEffectModel] = None
    ) -> tuple[FixedEffectModel, OptimizerResult]:
        batch = self.batch.with_offsets(offsets.to(self.batch.labels.dtype))
        if init is not None:
            w0 = init.model.coefficients.means
        else:
            w0 = torch.zeros(batch.dim, dtype=batch.labels.dtype,
                             device=batch.labels.device)
        model, result = self.problem.fit(batch, w0)
        return FixedEffectModel(model, self.feature_shard), result

    def score(self, model: FixedEffectModel) -> Tensor:
        return model.score_batch(self.batch)


Coordinate = FixedEffectCoordinate
DatumScoringModel = Union[FixedEffectModel, RandomEffectModel]
