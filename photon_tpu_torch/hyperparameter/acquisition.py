"""Acquisition functions for Bayesian optimization.

Copy of ``photon_tpu/hyperparameter/acquisition.py`` (numpy and scipy only, no
torch: the searches run on the host).

Parity: reference ⟦photon-lib/.../hyperparameter/ExpectedImprovement.scala⟧
(SURVEY.md §2.1): expected improvement over the incumbent for a
*minimization* problem (the reference minimizes its evaluation function;
callers negate bigger-is-better metrics).
"""
from __future__ import annotations

import numpy as np
from scipy import special


def _norm_pdf(z: np.ndarray) -> np.ndarray:
    return np.exp(-0.5 * z * z) / np.sqrt(2.0 * np.pi)


def _norm_cdf(z: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + special.erf(z / np.sqrt(2.0)))


def expected_improvement(
    mu: np.ndarray, var: np.ndarray, best: float, xi: float = 0.0
) -> np.ndarray:
    """EI(x) = E[max(best − ξ − f(x), 0)] for minimization.

    ``mu``/``var`` are the surrogate posterior at candidate points; ``best``
    is the incumbent (lowest observed value); ``xi`` trades off exploration.
    """
    sigma = np.sqrt(np.maximum(var, 0.0))
    imp = best - xi - mu
    safe = np.where(sigma > 0.0, sigma, 1.0)
    z = imp / safe
    ei = imp * _norm_cdf(z) + sigma * _norm_pdf(z)
    # Zero-uncertainty candidates degenerate to the deterministic improvement.
    return np.where(sigma > 0.0, ei, np.maximum(imp, 0.0))
