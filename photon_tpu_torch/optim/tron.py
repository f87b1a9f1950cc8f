"""TRON: trust-region Newton with truncated conjugate-gradient inner solves.

Port of ``photon_tpu/optim/tron.py`` (LIBLINEAR's TRON, Lin, Weng & Keerthi
2008): an outer trust-region loop whose step comes from a Steihaug truncated
CG solve of ``H p = −g`` with Hessian-vector products only, and the classic
η/σ radius updates. No line search.

Both loops run on the host (see ``optim/base.py``); the CG vectors stay on
the device. Host syncs: two per CG step (the curvature and trial-step norm
together, then the residual norm the loop tests), and two per outer
iteration (the model's predicted reduction with the step norm, then the
trial value with its gradient norm).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from photon_tpu_torch.optim.base import (
    FUNCTION_VALUES_CONVERGED,
    NOT_CONVERGED,
    Optimizer,
    OptimizerResult,
    ValueAndGrad,
    check_convergence,
    history_arrays,
    host_scalars,
    make_result,
)

Tensor = torch.Tensor

# LIBLINEAR TRON constants.
_ETA0, _ETA1, _ETA2 = 1e-4, 0.25, 0.75
_SIGMA1, _SIGMA2, _SIGMA3 = 0.25, 0.5, 4.0


def _boundary_tau(pp: float, pd: float, dd: float, delta: float) -> float:
    """τ ≥ 0 with ‖p + τ·d‖ = delta (positive root of the quadratic), from
    pᵀp, pᵀd and dᵀd."""
    disc = math.sqrt(np.maximum(pd * pd + dd * (delta * delta - pp), 0.0))
    return (-pd + disc) / np.maximum(dd, 1e-30)


def steihaug_cg(hvp: Callable[[Tensor], Tensor], g: Tensor, delta: float,
                max_iters: int, tol: float):
    """Truncated CG for H p = −g inside ‖p‖ ≤ delta.

    Returns ``(p, Hp, n_hvp)``: Hp is kept incrementally so the caller can
    price the predicted reduction without another Hessian pass; ``n_hvp``
    counts the Hessian-vector products (for pass accounting).
    """
    r = -g
    d = r
    p = torch.zeros_like(g)
    hp = torch.zeros_like(g)
    rr_t = torch.dot(r, r)
    (rr,) = host_scalars(rr_t)
    it, done = 0, False
    while not done and it < max_iters and math.sqrt(rr) > tol:
        hd = hvp(d)
        dhd_t = torch.dot(d, hd)
        # The trial step's norm is fetched with the curvature: α on the
        # device is the same IEEE quotient as α on the host.
        alpha_t = rr_t / torch.where(dhd_t > 1e-30, dhd_t, torch.ones_like(dhd_t))
        p_try = p + alpha_t * d
        dhd, ptp, pp, pd, dd = host_scalars(
            dhd_t, torch.dot(p_try, p_try), torch.dot(p, p), torch.dot(p, d),
            torch.dot(d, d))
        alpha = rr / (dhd if dhd > 1e-30 else 1.0)
        # Negative curvature or a step outside the region: walk to the edge.
        hit_boundary = dhd <= 1e-30 or math.sqrt(ptp) >= delta
        step = _boundary_tau(pp, pd, dd, delta) if hit_boundary else alpha
        p = p + step * d
        hp = hp + step * hd
        r = r - step * hd
        rr_new_t = torch.dot(r, r)
        (rr_new,) = host_scalars(rr_new_t)
        beta = rr_new / np.maximum(rr, 1e-30)
        d = r + beta * d
        rr, rr_t = rr_new, rr_new_t
        it += 1
        done = hit_boundary
    return p, hp, it


@dataclasses.dataclass(frozen=True)
class TRON(Optimizer):
    """Trust-region Newton: ``optimize(value_and_grad, x0, hvp_at)`` where
    ``hvp_at(x)`` returns ``v ↦ H(x)·v`` (see ``GLMObjective.bind_hvp_at``,
    which computes the margins once per point)."""

    def optimize(  # type: ignore[override]
        self,
        value_and_grad: ValueAndGrad,
        x0: Tensor,
        hvp_at: Callable[[Tensor], Callable[[Tensor], Tensor]],
    ) -> OptimizerResult:
        """``data_passes`` counts ``GLMObjective.bind_hvp_at``'s costs: one
        pass per ``hvp_at(x)`` call (the margins) and two per H·v."""
        cfg = self.config
        max_it = cfg.max_iterations
        f0_t, g0 = value_and_grad(x0)
        f0, gg0 = host_scalars(f0_t, torch.dot(g0, g0))
        gnorm0 = math.sqrt(gg0)
        values, gnorms = history_arrays(f0, gnorm0, max_it)
        x, f, g, gnorm, delta = x0, f0, g0, gnorm0, gnorm0
        it, reason, passes = 0, NOT_CONVERGED, 2   # the initial value+grad

        while reason == NOT_CONVERGED and it < max_it:
            p, hp, n_hvp = steihaug_cg(
                hvp_at(x), g, delta, cfg.max_cg_iterations, 0.1 * gnorm)
            gp, php, pp = host_scalars(
                torch.dot(g, p), torch.dot(p, hp), torch.dot(p, p))
            # Predicted reduction of the quadratic model: −(gᵀp + ½ pᵀHp).
            pred = -(gp + 0.5 * php)
            x_try = x + p
            f_try_t, g_try = value_and_grad(x_try)
            f_try, gg_try = host_scalars(f_try_t, torch.dot(g_try, g_try))
            actual = f - f_try
            rho = actual / (pred if abs(pred) > 1e-30 else 1.0)
            if not math.isfinite(f_try):
                rho = -math.inf      # a non-finite trial takes the shrink branch
            pnorm = math.sqrt(pp)
            # LIBLINEAR radius update: shrink on poor agreement, halve on
            # moderate, expand (bounded) on good.
            if rho < _ETA1:
                delta_new = np.maximum(_SIGMA1 * np.minimum(pnorm, delta), 1e-12)
            elif rho < _ETA2:
                delta_new = _SIGMA2 * delta
            else:
                delta_new = np.clip(_SIGMA3 * pnorm, delta, _SIGMA3 * delta)
            delta = float(delta_new)
            accept = rho > _ETA0
            it += 1
            if accept:
                gnorm_new = math.sqrt(gg_try)
                # The function-value test only means something on accepted
                # steps; a rejected one shrinks delta and retries.
                reason = check_convergence(it, f, f_try, gnorm_new, gnorm0, cfg)
                x, f, g, gnorm = x_try, f_try, g_try, gnorm_new
            if delta <= 1e-12 and reason == NOT_CONVERGED:
                reason = FUNCTION_VALUES_CONVERGED   # collapsed radius
            values[it], gnorms[it] = f, gnorm
            # The hoisted margins, 2 per CG H·v, and the fused trial
            # value+grad.
            passes += 1 + 2 * n_hvp + 2
        return make_result(x, f, gnorm, it, reason, values, gnorms, passes,
                           max_it)
