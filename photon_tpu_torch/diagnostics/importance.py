"""Feature importance for fitted GLMs.

Port of ``photon_tpu/diagnostics/importance.py``: feature j's importance is
|w_j| · std_j (the coefficient scaled by the feature's spread in the
training data); a feature of spread 0 ranks by |w_j| · |mean_j|, so that a
constant but used column (the intercept) still appears.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from photon_tpu_torch.data.statistics import FeatureDataStatistics


@dataclasses.dataclass(frozen=True)
class FeatureImportance:
    """Ranked importance. Both arrays are [D], sorted descending."""

    order: np.ndarray        # indices into the coefficient vector
    importance: np.ndarray   # importance, aligned with ``order``

    def top(self, k: int) -> list[tuple[int, float]]:
        k = min(k, len(self.order))
        return [(int(self.order[i]), float(self.importance[i])) for i in range(k)]


def feature_importance(coefficients, stats: FeatureDataStatistics) -> FeatureImportance:
    w = np.asarray(coefficients, np.float64)
    std = stats.std().detach().cpu().numpy().astype(np.float64)
    mean = stats.mean.detach().cpu().numpy().astype(np.float64)
    score = np.abs(w) * np.where(std > 0, std, np.abs(mean))
    order = np.argsort(-score, kind="stable")
    return FeatureImportance(order=order, importance=score[order])
