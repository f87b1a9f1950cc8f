"""Gaussian prior from a previous model's posterior: incremental training.

Port of ``photon_tpu/functions/prior.py``. Retraining on new data penalizes
deviation from the previous model, per coefficient:

    P(w) = ½ Σⱼ precⱼ (wⱼ − μⱼ)²,   precⱼ = λ_inc / σⱼ²

where (μ, σ²) are the previous coefficients' means and variances (variance 1
where the previous run computed none) and λ_inc the incremental weight. The
terms add to the smooth objective's value, gradient, H·v and diagonal.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PriorDistribution:
    """Per-coefficient Gaussian prior; ``precisions`` already folds in the
    incremental weight. Zero precision means no prior on that coefficient."""

    means: Tensor        # [D]
    precisions: Tensor   # [D]

    @staticmethod
    def from_model(
        means: Tensor,
        variances: Optional[Tensor],
        incremental_weight: float = 1.0,
        min_variance: float = 1e-12,
    ) -> "PriorDistribution":
        """Previous posterior → prior; missing variances default to 1."""
        if variances is None:
            var = torch.ones_like(means)
        else:
            var = torch.clamp(variances, min=min_variance)
        return PriorDistribution(means=means, precisions=incremental_weight / var)

    def value(self, w: Tensor) -> Tensor:
        d = w - self.means
        return 0.5 * torch.sum(self.precisions * d * d)

    def gradient(self, w: Tensor) -> Tensor:
        return self.precisions * (w - self.means)

    def hessian_vector(self, v: Tensor) -> Tensor:
        return self.precisions * v

    def hessian_diagonal(self) -> Tensor:
        return self.precisions
