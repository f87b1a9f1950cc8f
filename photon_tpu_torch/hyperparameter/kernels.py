"""GP covariance kernels: RBF and Matérn-5/2 with ARD lengthscales.

Copy of ``photon_tpu/hyperparameter/kernels.py`` (numpy and scipy only, no
torch: the searches run on the host).

Parity: reference ⟦photon-lib/.../hyperparameter/estimators/kernels/
RBF.scala, Matern52.scala⟧ (SURVEY.md §2.1 "Hyperparameter tuning"): both
kernels carry an amplitude and per-dimension lengthscales; the reference adds
the observation-noise variance at the GP level, as does this port.

Host-side numpy: the GP fits over dozens of points — device offload would be
pure overhead.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _sq_dists(x1: np.ndarray, x2: np.ndarray, ls: np.ndarray) -> np.ndarray:
    a = x1 / ls
    b = x2 / ls
    return (
        np.sum(a * a, axis=1)[:, None]
        + np.sum(b * b, axis=1)[None, :]
        - 2.0 * a @ b.T
    ).clip(min=0.0)


@dataclasses.dataclass(frozen=True)
class RBF:
    """k(x, x') = amp² · exp(−½‖(x−x')/ℓ‖²)."""

    amplitude: float = 1.0
    lengthscales: np.ndarray = None  # [d] or scalar broadcast

    def __call__(self, x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
        ls = np.asarray(self.lengthscales if self.lengthscales is not None else 1.0)
        d2 = _sq_dists(np.atleast_2d(x1), np.atleast_2d(x2), ls)
        return self.amplitude**2 * np.exp(-0.5 * d2)

    def diag(self, xs: np.ndarray) -> np.ndarray:
        """k(x, x) per row — constant amp² for stationary kernels (avoids the
        m×m matrix in the acquisition hot path)."""
        return np.full(np.atleast_2d(xs).shape[0], self.amplitude**2)

    def with_params(self, amplitude: float, lengthscales) -> "RBF":
        return RBF(amplitude, np.asarray(lengthscales, float))


@dataclasses.dataclass(frozen=True)
class Matern52:
    """k(r) = amp² · (1 + √5 r + 5r²/3) exp(−√5 r), r = ‖(x−x')/ℓ‖.

    The reference's default kernel for Bayesian optimization (twice
    differentiable but less smooth than RBF — better for noisy metric
    surfaces)."""

    amplitude: float = 1.0
    lengthscales: np.ndarray = None

    def __call__(self, x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
        ls = np.asarray(self.lengthscales if self.lengthscales is not None else 1.0)
        r = np.sqrt(_sq_dists(np.atleast_2d(x1), np.atleast_2d(x2), ls))
        s5r = np.sqrt(5.0) * r
        return self.amplitude**2 * (1.0 + s5r + s5r**2 / 3.0) * np.exp(-s5r)

    def diag(self, xs: np.ndarray) -> np.ndarray:
        return np.full(np.atleast_2d(xs).shape[0], self.amplitude**2)

    def with_params(self, amplitude: float, lengthscales) -> "Matern52":
        return Matern52(amplitude, np.asarray(lengthscales, float))


KERNELS = {"rbf": RBF, "matern52": Matern52}
