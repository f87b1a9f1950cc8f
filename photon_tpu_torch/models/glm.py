"""Generalized linear models: coefficients + task type.

Port of ``photon_tpu/models/glm.py``: one frozen dataclass with a task in
place of the reference's per-task model classes; the task picks the mean
function.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_tpu_torch.data.batch import SparseFeatures
from photon_tpu_torch.models.coefficients import Coefficients
from photon_tpu_torch.ops.losses import loss_for_task
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

    def compute_mean(
        self, features: SparseFeatures, offsets: Optional[Tensor] = None
    ) -> Tensor:
        """Score through the inverse link (reference ``computeMeanFunction``)."""
        return loss_for_task(self.task).mean(self.compute_score(features, offsets))

    @staticmethod
    def zeros(dim: int, task: TaskType, dtype: torch.dtype = torch.float32,
              device: Optional[torch.device] = None) -> "GeneralizedLinearModel":
        return GeneralizedLinearModel(Coefficients.zeros(dim, dtype, device=device), task)
