"""Slice sampler for GP hyperparameter posteriors.

Copy of ``photon_tpu/hyperparameter/slice_sampler.py`` (numpy and scipy only, no
torch: the searches run on the host).

Parity: reference ⟦photon-lib/.../hyperparameter/SliceSampler.scala⟧
(SURVEY.md §2.1): univariate slice sampling with step-out and shrinkage
(Neal 2003), applied coordinate-wise to the log-hyperparameter vector — the
same scheme Spearmint-style tuners and the reference use to integrate out GP
hyperparameters.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np


@dataclasses.dataclass
class SliceSampler:
    """Coordinate-wise slice sampling of an unnormalized log-density."""

    log_density: Callable[[np.ndarray], float]
    width: float = 1.0
    max_step_out: int = 8
    max_shrink: int = 32
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def _sample_coord(self, x: np.ndarray, i: int, logp_x: float) -> tuple[np.ndarray, float]:
        # Vertical slice: y ~ U(0, p(x)) → log y = log p(x) − Exp(1).
        log_y = logp_x - self._rng.exponential()
        # Step out.
        u = self._rng.uniform()
        lo = x[i] - self.width * u
        hi = lo + self.width
        for _ in range(self.max_step_out):
            if self._logp_at(x, i, lo) <= log_y:
                break
            lo -= self.width
        for _ in range(self.max_step_out):
            if self._logp_at(x, i, hi) <= log_y:
                break
            hi += self.width
        # Shrinkage.
        for _ in range(self.max_shrink):
            xi = self._rng.uniform(lo, hi)
            lp = self._logp_at(x, i, xi)
            if lp > log_y:
                x_new = x.copy()
                x_new[i] = xi
                return x_new, lp
            if xi < x[i]:
                lo = xi
            else:
                hi = xi
        return x, logp_x  # shrunk to nothing: keep the current point

    def _logp_at(self, x: np.ndarray, i: int, xi: float) -> float:
        x2 = x.copy()
        x2[i] = xi
        return self.log_density(x2)

    def sample(
        self, x0: np.ndarray, n_samples: int, n_burn: int = 0, thin: int = 1
    ) -> np.ndarray:
        """Draw ``n_samples`` states after ``n_burn`` burn-in sweeps."""
        x = np.asarray(x0, float).copy()
        logp = self.log_density(x)
        if not np.isfinite(logp):
            raise ValueError("slice sampler started at a zero-density point")
        out = []
        total = n_burn + n_samples * thin
        for it in range(total):
            for i in range(len(x)):
                x, logp = self._sample_coord(x, i, logp)
            if it >= n_burn and (it - n_burn) % thin == 0:
                out.append(x.copy())
        return np.stack(out)
