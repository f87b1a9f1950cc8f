"""OWL-QN (Orthant-Wise Limited-memory Quasi-Newton) for L1 regularization.

Port of ``photon_tpu/optim/owlqn.py`` (Andrew & Gao 2007):
  * the pseudo-gradient of f(x) + Σ l1ᵢ|xᵢ| picks the steepest-descent
    subgradient,
  * the two-loop L-BFGS direction is built from the *smooth* gradient
    history and sign-aligned with the negative pseudo-gradient,
  * line-search iterates are projected onto the orthant of the start point.

The per-coefficient L1 weights (λ·mask) leave the intercept unpenalized.
The loop runs on the host (see ``optim/base.py``); host syncs per
iteration: the aligned direction's norm, one per probe, and one for the
history test and the pseudo-gradient norm together.
"""
from __future__ import annotations

import dataclasses
import math

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
from photon_tpu_torch.optim.lbfgs import (
    empty_history,
    two_loop_direction,
    update_history,
)

Tensor = torch.Tensor


def pseudo_gradient(x: Tensor, g: Tensor, l1: Tensor) -> Tensor:
    """Steepest-descent subgradient of f(x) + Σ l1ᵢ|xᵢ| (Andrew & Gao eq. 4)."""
    right = g + l1
    left = g - l1
    zero = torch.zeros_like(g)
    at_zero = torch.where(left > 0.0, left, torch.where(right < 0.0, right, zero))
    return torch.where(x > 0.0, right, torch.where(x < 0.0, left, at_zero))


def orthant(x: Tensor, pg: Tensor) -> Tensor:
    """ξᵢ = sign(xᵢ), or sign(−pgᵢ) where xᵢ = 0: the search orthant."""
    return torch.where(x != 0.0, torch.sign(x), torch.sign(-pg))


@dataclasses.dataclass(frozen=True)
class OWLQN(Optimizer):
    """Orthant-wise L-BFGS: ``optimize(value_and_grad, x0, l1_weights)``
    where ``value_and_grad`` is the *smooth* part (loss + any L2 term) and
    ``l1_weights`` the [D] per-coefficient L1 penalties."""

    def optimize(  # type: ignore[override]
        self, value_and_grad: ValueAndGrad, x0: Tensor, l1_weights: Tensor
    ) -> OptimizerResult:
        cfg = self.config
        max_it = cfg.max_iterations
        l1 = l1_weights.to(x0.dtype)

        f0s_t, g0 = value_and_grad(x0)
        pg0 = pseudo_gradient(x0, g0, l1)
        f0s, l1x0, pgpg0 = host_scalars(
            f0s_t, torch.dot(l1, torch.abs(x0)), torch.dot(pg0, pg0))
        f0 = f0s + l1x0
        gnorm0 = math.sqrt(pgpg0)
        values, gnorms = history_arrays(f0, gnorm0, max_it)
        hist = empty_history(cfg.history_length, x0)
        x, f, g, gnorm = x0, f0, g0, gnorm0
        it, reason, passes = 0, NOT_CONVERGED, 2   # the initial value+grad

        while reason == NOT_CONVERGED and it < max_it:
            pg = pseudo_gradient(x, g, l1)
            d = two_loop_direction(pg, hist)
            # Align the direction with −pg (zero the disagreeing parts);
            # fall back to steepest descent if nothing is left.
            d = torch.where(d * (-pg) > 0.0, d, torch.zeros_like(d))
            (dd,) = host_scalars(torch.dot(d, d))
            if not dd > 0.0:
                d = -pg
            xi = orthant(x, pg)

            # Backtracking Armijo on the total objective, each trial point
            # projected onto the orthant (Andrew & Gao's constrained step).
            t, ft, gt, xt, n, ok = 1.0, f, g, x, 0, False
            while not ok and n < cfg.max_line_search_iterations:
                xt = x + t * d
                xt = torch.where(xt * xi >= 0.0, xt, torch.zeros_like(xt))
                fts_t, gt = value_and_grad(xt)
                fts, l1xt, decrease = host_scalars(
                    fts_t, torch.dot(l1, torch.abs(xt)), torch.dot(pg, xt - x))
                ft = fts + l1xt
                # Armijo via the projected displacement.
                ok = math.isfinite(ft) and ft <= f + 1e-4 * decrease
                if not ok:
                    t = 0.5 * t
                n += 1
            accept = ok or (math.isfinite(ft) and ft < f)
            x_new, f_new, g_new = (xt, ft, gt) if accept else (x, f, g)

            s, yv = x_new - x, g_new - g
            pg_new = pseudo_gradient(x_new, g_new, l1)
            sy, ss, yy, pgpg = host_scalars(
                torch.dot(s, yv), torch.dot(s, s), torch.dot(yv, yv),
                torch.dot(pg_new, pg_new))
            update_history(hist, s, yv, sy, ss, yy)
            it += 1
            gnorm = math.sqrt(pgpg)
            reason = check_convergence(it, f, f_new, gnorm, gnorm0, cfg)
            if not accept and reason == NOT_CONVERGED:
                reason = FUNCTION_VALUES_CONVERGED
            values[it], gnorms[it] = f_new, gnorm
            passes += 2 * n            # each probe is one fused value+grad
            x, f, g = x_new, f_new, g_new

        return make_result(x, f, gnorm, it, reason, values, gnorms, passes,
                           max_it)
