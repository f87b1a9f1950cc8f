"""GAME coordinate models.

Port of ``photon_tpu/game/coordinates.py`` (``FixedEffectModel.score_batch``;
the trainable coordinates come with the training slice).
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch

from photon_tpu_torch.data.batch import LabeledBatch
from photon_tpu_torch.game.random_effect import RandomEffectModel
from photon_tpu_torch.models.glm import GeneralizedLinearModel

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FixedEffectModel:
    """Population-level GLM for one feature shard."""

    model: GeneralizedLinearModel
    feature_shard: str

    def score_batch(self, batch: LabeledBatch) -> Tensor:
        """Raw per-row scores WITHOUT offsets (GAME sums coordinate scores)."""
        return batch.features.matvec(self.model.coefficients.means)


DatumScoringModel = Union[FixedEffectModel, RandomEffectModel]
