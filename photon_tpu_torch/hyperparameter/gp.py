"""Gaussian-process surrogate model for Bayesian optimization.

Copy of ``photon_tpu/hyperparameter/gp.py`` (numpy and scipy only, no
torch: the searches run on the host).

Parity: reference ⟦photon-lib/.../hyperparameter/estimators/
GaussianProcessModel.scala, GaussianProcessEstimator.scala⟧ (SURVEY.md §2.1):
a GP posterior over the metric surface with kernel hyperparameters
(amplitude, lengthscales, noise) integrated out by **slice sampling** from
their posterior — predictions average over the sampled hyperparameter
settings, exactly the reference's estimator structure.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from photon_tpu_torch.hyperparameter.kernels import Matern52
from photon_tpu_torch.hyperparameter.slice_sampler import SliceSampler


@dataclasses.dataclass(frozen=True)
class GaussianProcessModel:
    """Posterior of a zero-mean GP given observations (x, y) and a kernel.

    ``noise`` is observation-noise *variance* added to the diagonal.
    """

    x: np.ndarray          # [n, d]
    y: np.ndarray          # [n]
    kernel: object
    noise: float = 1e-6
    mean: float = 0.0      # constant prior mean (set to y.mean() by the fitter)

    def __post_init__(self):
        k = self.kernel(self.x, self.x)
        k[np.diag_indices_from(k)] += max(self.noise, 1e-10)
        chol = np.linalg.cholesky(k)
        alpha = np.linalg.solve(
            chol.T, np.linalg.solve(chol, self.y - self.mean)
        )
        object.__setattr__(self, "_chol", chol)
        object.__setattr__(self, "_alpha", alpha)

    def predict(self, xs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Posterior (mean, variance) at query points [m, d]."""
        xs = np.atleast_2d(xs)
        ks = self.kernel(self.x, xs)            # [n, m]
        mu = self.mean + ks.T @ self._alpha
        v = np.linalg.solve(self._chol, ks)     # [n, m]
        kss = (
            self.kernel.diag(xs)
            if hasattr(self.kernel, "diag")
            else np.diag(self.kernel(xs, xs))
        )
        var = np.maximum(kss - np.sum(v * v, axis=0), 1e-12)
        return mu, var

    def log_marginal_likelihood(self) -> float:
        n = len(self.y)
        return float(
            -0.5 * (self.y - self.mean) @ self._alpha
            - np.sum(np.log(np.diag(self._chol)))
            - 0.5 * n * np.log(2.0 * np.pi)
        )


def _lml_for(theta: np.ndarray, x, y, kernel_cls, mean: float) -> float:
    """Log marginal likelihood + log-normal priors over θ = log(amp, noise,
    ℓ₁..ℓ_d) — the posterior the slice sampler explores (reference: priors on
    log-hyperparameters keep the sampler in sane ranges)."""
    amp, noise = np.exp(theta[0]), np.exp(theta[1])
    ls = np.exp(theta[2:])
    if amp > 1e3 or noise > 1e2 or np.any(ls > 1e3):
        return -np.inf
    try:
        m = GaussianProcessModel(x, y, kernel_cls(amp, ls), noise=noise, mean=mean)
    except np.linalg.LinAlgError:
        return -np.inf
    # N(0, 1) priors on log-params (weakly informative, as the reference's).
    return m.log_marginal_likelihood() - 0.5 * float(theta @ theta)


@dataclasses.dataclass
class GaussianProcessEstimator:
    """Fit GP hyperparameters by slice-sampling their posterior.

    ``fit(x, y)`` returns a list of GaussianProcessModel draws; predictions
    should average over them (``predict_mean_var``).
    """

    kernel_cls: type = Matern52
    n_samples: int = 8
    n_burn: int = 16
    seed: int = 0

    def fit(self, x: np.ndarray, y: np.ndarray) -> list[GaussianProcessModel]:
        x = np.atleast_2d(np.asarray(x, float))
        y = np.asarray(y, float)
        d = x.shape[1]
        mean = float(y.mean()) if len(y) else 0.0
        theta0 = np.zeros(2 + d)
        theta0[1] = np.log(max(1e-3, float(np.var(y)) * 0.01 + 1e-6))
        sampler = SliceSampler(
            lambda t: _lml_for(t, x, y, self.kernel_cls, mean), seed=self.seed
        )
        thetas = sampler.sample(theta0, self.n_samples, n_burn=self.n_burn)
        models = []
        for t in thetas:
            amp, noise = np.exp(t[0]), np.exp(t[1])
            ls = np.exp(t[2:])
            models.append(
                GaussianProcessModel(
                    x, y, self.kernel_cls(amp, ls), noise=noise, mean=mean
                )
            )
        return models


def predict_mean_var(
    models: Sequence[GaussianProcessModel], xs: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Average posterior over hyperparameter draws (law of total variance)."""
    mus, vars_ = zip(*(m.predict(xs) for m in models))
    mus = np.stack(mus)
    vars_ = np.stack(vars_)
    mu = mus.mean(axis=0)
    var = vars_.mean(axis=0) + mus.var(axis=0)
    return mu, var
