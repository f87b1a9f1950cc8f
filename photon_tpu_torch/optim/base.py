"""Optimizer base types: convergence reasons, config, result, scalar fetches.

Port of ``photon_tpu/optim/base.py``. The JAX optimizers run their whole
loop on the device inside one ``lax.while_loop``; here every solve runs as
masked batched lanes (``optim/lanes.py``, a single solve one lane), its
decisions taken on the device in the solve's dtype, as the JAX package
takes them; the host only fetches whether any lane still runs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

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
    """Terminal state and per-iteration history: per-lane tensors from the
    lanes (``[E]``; tracks ``[E, max_iterations + 1]``), Python scalars and
    host tracks from a single solve (``LBFGS`` / ``OWLQN`` / ``TRON``).

    ``values[i]`` / ``grad_norms[i]`` are valid for i ≤ ``iterations``;
    beyond that they hold ``inf``. ``data_passes`` counts full-data touches (one
    matvec OR one rmatvec over all N·K entries) where the loop makes them:
    line-search probes, gradient refreshes, CG Hessian-vector products.
    """

    x: Tensor
    value: "float | Tensor"
    grad_norm: "float | Tensor"
    iterations: "int | Tensor"
    converged_reason: "int | Tensor"
    values: Tensor
    grad_norms: Tensor
    data_passes: "int | Tensor"

    def reason_name(self) -> str:
        return CONVERGENCE_REASON_NAMES[self.converged_reason]


def check_convergence(it: int, f_prev: Tensor, f: Tensor, gnorm: Tensor,
                      gnorm0: Tensor, tolerance: float) -> Tensor:
    """Dual convergence test over lanes → int32 reason codes (0 where not
    done): the gradient norm relative to the initial one, the function
    value by relative change. The tolerance is cast to the lanes' dtype
    first (a fill on the device: a tensor made from the host scalar would
    be a copy that syncs)."""
    tol = torch.full((), tolerance, dtype=f.dtype, device=f.device)
    grad_ok = gnorm <= tol * torch.clamp(gnorm0, min=1e-30)
    denom = torch.clamp(torch.maximum(f_prev.abs(), f.abs()), min=1.0)
    fun_ok = (it > 0) & ((f_prev - f).abs() <= tol * denom)
    return torch.where(
        grad_ok, GRADIENT_CONVERGED,
        torch.where(fun_ok, FUNCTION_VALUES_CONVERGED, NOT_CONVERGED),
    ).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Common interface: ``optimize(value_and_grad, x0) -> OptimizerResult``.

    ``dot`` is the inner product of coefficient vectors, ``[E, P] × [E, P]
    → [E]`` over lanes (None: the plain sum over the last axis). A
    feature-sharded solve (``parallel/model_parallel.py``) passes one that
    folds each shard's partial over the ``model`` axis, so every shard runs
    the optimizer on its own block of the coefficients: the counterpart of
    the JAX optimizers' ``axis_name``."""

    config: OptimizerConfig = OptimizerConfig()
    dot: Optional[Callable[[Tensor, Tensor], Tensor]] = None

    def optimize(self, value_and_grad: ValueAndGrad, x0: Tensor, **kw) -> OptimizerResult:
        raise NotImplementedError
