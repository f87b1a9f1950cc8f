"""Model coefficients.

Port of ``photon_tpu/models/coefficients.py``: means[D] plus optional
per-coefficient variances[D], as a frozen dataclass of tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Coefficients:
    """means[D] (+ optional variances[D]) for one generalized linear model."""

    means: Tensor
    variances: Optional[Tensor] = None

    @property
    def dim(self) -> int:
        return self.means.shape[-1]

    @staticmethod
    def zeros(dim: int, dtype: torch.dtype = torch.float32,
              device: Optional[torch.device] = None) -> "Coefficients":
        return Coefficients(torch.zeros(dim, dtype=dtype, device=device))
