"""Generalized linear models: coefficients + task type.

Port of ``photon_tpu/models/glm.py`` (``compute_score``; ``compute_mean``
needs the losses and comes with the training slice).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_tpu_torch.data.batch import SparseFeatures
from photon_tpu_torch.models.coefficients import Coefficients
from photon_tpu_torch.types import TaskType

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GeneralizedLinearModel:
    """means (+variances) with a task type; scoring is pure."""

    coefficients: Coefficients
    task: TaskType

    @property
    def dim(self) -> int:
        return self.coefficients.dim

    def compute_score(
        self, features: SparseFeatures, offsets: Optional[Tensor] = None
    ) -> Tensor:
        """Raw linear score xᵀβ (+ offset)."""
        z = features.matvec(self.coefficients.means)
        if offsets is not None:
            z = z + offsets
        return z
