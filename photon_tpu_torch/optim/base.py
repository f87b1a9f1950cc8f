"""Optimizer base types: convergence reasons, config, result, scalar fetches.

Port of ``photon_tpu/optim/base.py``. The JAX optimizers run their whole
loop on the device inside one ``lax.while_loop``; here the loop is a plain
host loop over eager tensors. Vectors (coefficients, gradients, history)
stay on the batch's device. The loop's scalar decisions — convergence, the
line search's accept test, the history's curvature test, the trust-region
updates — are taken on the host from values fetched with
:func:`host_scalars`, one device sync per fetch, in double precision: in a
float64 run that is the JAX package's arithmetic exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

Tensor = torch.Tensor

# Convergence reason codes (0 means "still running").
NOT_CONVERGED = 0
MAX_ITERATIONS = 1
FUNCTION_VALUES_CONVERGED = 2
GRADIENT_CONVERGED = 3

CONVERGENCE_REASON_NAMES = {
    NOT_CONVERGED: "NOT_CONVERGED",
    MAX_ITERATIONS: "MAX_ITERATIONS",
    FUNCTION_VALUES_CONVERGED: "FUNCTION_VALUES_CONVERGED",
    GRADIENT_CONVERGED: "GRADIENT_CONVERGED",
}

# An objective for first-order optimizers: x -> (value, gradient).
ValueAndGrad = Callable[[Tensor], tuple[Tensor, Tensor]]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Optimizer hyperparameters. ``tolerance`` is the relative
    function-change tolerance, also applied to the gradient norm relative to
    the initial one (the reference's dual convergence check)."""

    max_iterations: int = 80
    tolerance: float = 1e-7
    # L-BFGS/OWL-QN history length (Breeze default m=10).
    history_length: int = 10
    # Line-search probe cap per iteration.
    max_line_search_iterations: int = 25
    # TRON inner conjugate-gradient iteration cap.
    max_cg_iterations: int = 20


@dataclasses.dataclass(frozen=True)
class OptimizerResult:
    """Terminal state and per-iteration history.

    ``values[i]`` / ``grad_norms[i]`` (host tensors of the solve's dtype,
    ``max_iterations + 1`` long) are valid for i ≤ ``iterations``; beyond
    that they hold ``inf``. ``data_passes`` counts full-data touches (one
    matvec OR one rmatvec over all N·K entries) where the loop makes them:
    line-search probes, gradient refreshes, CG Hessian-vector products.
    """

    x: Tensor
    value: float
    grad_norm: float
    iterations: int
    converged_reason: int
    values: Tensor
    grad_norms: Tensor
    data_passes: int

    def reason_name(self) -> str:
        return CONVERGENCE_REASON_NAMES[self.converged_reason]


def host_scalars(*values: Tensor) -> list[float]:
    """0-dim tensors → Python floats, in one device-to-host copy."""
    return torch.stack(values).tolist()


def history_arrays(f0: float, gnorm0: float, max_iterations: int):
    """The per-iteration value and gradient-norm tracks, ``inf``-padded."""
    values = [float("inf")] * (max_iterations + 1)
    gnorms = [float("inf")] * (max_iterations + 1)
    values[0], gnorms[0] = f0, gnorm0
    return values, gnorms


def check_convergence(
    it: int,
    f_prev: float,
    f: float,
    gnorm: float,
    gnorm0: float,
    config: OptimizerConfig,
) -> int:
    """Dual convergence test → reason code (0 if not done): the gradient
    relative to the initial gradient norm, the function value by relative
    change."""
    tol = config.tolerance
    grad_ok = gnorm <= tol * np.maximum(gnorm0, 1e-30)
    denom = np.maximum(np.maximum(abs(f_prev), abs(f)), 1.0)
    fun_ok = it > 0 and abs(f_prev - f) <= tol * denom
    if grad_ok:
        return GRADIENT_CONVERGED
    return FUNCTION_VALUES_CONVERGED if fun_ok else NOT_CONVERGED


def finalize_reason(reason: int, it: int, max_iterations: int) -> int:
    """A loop still running at the iteration cap ends as MAX_ITERATIONS."""
    if reason == NOT_CONVERGED and it >= max_iterations:
        return MAX_ITERATIONS
    return reason


def make_result(x: Tensor, f: float, gnorm: float, it: int, reason: int,
                values: list, gnorms: list, passes: int,
                max_iterations: int) -> OptimizerResult:
    return OptimizerResult(
        x=x, value=f, grad_norm=gnorm, iterations=it,
        converged_reason=finalize_reason(reason, it, max_iterations),
        values=torch.tensor(values, dtype=x.dtype),
        grad_norms=torch.tensor(gnorms, dtype=x.dtype),
        data_passes=passes,
    )


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Common interface: ``optimize(value_and_grad, x0) -> OptimizerResult``."""

    config: OptimizerConfig = OptimizerConfig()

    def optimize(self, value_and_grad: ValueAndGrad, x0: Tensor, **kw) -> OptimizerResult:
        raise NotImplementedError
