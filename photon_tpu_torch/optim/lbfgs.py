"""L-BFGS with the two-loop recursion and Armijo backtracking.

Port of ``photon_tpu/optim/lbfgs.py``: limited-memory quasi-Newton with a
circular curvature history, backtracking Armijo line search from t = 1 with
halving, and the dual convergence test. ``optimize`` prices each probe with
one fused value+grad (2 data passes); ``optimize_scored`` maintains the
margins z = Xw + offsets, so an iteration is one matvec (Xp) and one rmatvec
(the gradient) whatever the probe count, plus a matvec that refreshes z from
w every 8th iteration.

The loop runs on the host (see ``optim/base.py``); the history's vectors
([m, D]) stay on the device and are updated in place, its count, slot and
ρ = 1/sᵀy on the host. Only valid history slots are visited, which is what
the JAX package's masked loop over all m slots computes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

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


@dataclasses.dataclass
class LBFGSHistory:
    """Circular-buffer curvature history, updated in place."""

    s: Tensor            # [m, D] parameter deltas
    y: Tensor            # [m, D] gradient deltas
    rho: list            # [m] 1 / (sᵀy), host floats
    count: int = 0       # valid corrections (≤ m)
    pos: int = 0         # next write slot


def empty_history(m: int, like: Tensor) -> LBFGSHistory:
    d = like.shape[-1]
    return LBFGSHistory(
        s=torch.zeros((m, d), dtype=like.dtype, device=like.device),
        y=torch.zeros((m, d), dtype=like.dtype, device=like.device),
        rho=[0.0] * m,
    )


def two_loop_direction(g: Tensor, hist: LBFGSHistory) -> Tensor:
    """−H·g by the two-loop recursion over the valid history; steepest
    descent when the history is empty. No host sync."""
    m = hist.s.shape[0]
    q = g
    alpha: list = [None] * m
    for j in range(hist.count):
        idx = (hist.pos - 1 - j) % m
        a = hist.rho[idx] * torch.dot(hist.s[idx], q)
        q = q - a * hist.y[idx]
        alpha[idx] = a
    r = q
    if hist.count > 0:
        # Initial Hessian scaling γ = sᵀy / yᵀy from the newest pair.
        newest = (hist.pos - 1) % m
        sy = torch.dot(hist.s[newest], hist.y[newest])
        yy = torch.dot(hist.y[newest], hist.y[newest])
        r = (sy / torch.clamp(yy, min=1e-30)) * q
    for j in range(hist.count):
        idx = (hist.pos - hist.count + j) % m
        b = hist.rho[idx] * torch.dot(hist.y[idx], r)
        r = r + (alpha[idx] - b) * hist.s[idx]
    return -r


def update_history(hist: LBFGSHistory, s: Tensor, y: Tensor,
                   sy: float, ss: float, yy: float) -> None:
    """Push a curvature pair unless sᵀy is not sufficiently positive
    (``sy``, ``ss``, ``yy``: sᵀy, sᵀs, yᵀy fetched by the caller)."""
    if not sy > 1e-10 * math.sqrt(ss) * math.sqrt(yy):
        return
    m = hist.s.shape[0]
    hist.s[hist.pos] = s
    hist.y[hist.pos] = y
    hist.rho[hist.pos] = 1.0 / sy
    hist.count = min(hist.count + 1, m)
    hist.pos = (hist.pos + 1) % m


def armijo_backtrack(
    probe: Callable[[float], tuple[float, object]],
    f: float,
    dg: float,
    init_aux,
    max_iters: int,
):
    """Armijo backtracking from t = 1, sufficient-decrease constant 1e-4,
    halving the step. ``probe: t ↦ (f(x + t·d), aux)``
    (the plain path's aux is the probe's gradient; the scored path's is
    nothing).

    Returns ``(t_final, ft, aux, accept, n_probes)``; ``t_final`` is 0 on a
    fully failed search. If no step satisfies Armijo within the cap, the
    last (smallest) probe is accepted only if it still decreases f.
    Non-finite probe values count as failures.
    """
    t, ft, aux, t_used, n, ok = 1.0, f, init_aux, 1.0, 0, False
    while not ok and n < max_iters:
        ft, aux = probe(t)
        ok = ft <= f + 1e-4 * t * dg and math.isfinite(ft)
        t_used = t
        if not ok:
            t = t * 0.5
        n += 1
    accept = ok or (math.isfinite(ft) and ft < f)
    return (t_used if accept else 0.0), ft, aux, accept, n


@dataclasses.dataclass(frozen=True)
class LBFGS(Optimizer):
    """Limited-memory BFGS."""

    def _solve(self, x0: Tensor, f0: float, g0: Tensor, extra0,
               step_fn) -> OptimizerResult:
        """Shared loop: direction, step via ``step_fn``, history update,
        convergence bookkeeping. ``step_fn(x, f, g, extra, dvec, dg, it) →
        (x, f, g, extra, t_final, passes)``; ``t_final == 0`` marks a fully
        failed line search. Host syncs per iteration: dᵀg, one per probe,
        and one for the history test and gradient norm together."""
        cfg = self.config
        max_it = cfg.max_iterations
        (gg0,) = host_scalars(torch.dot(g0, g0))
        gnorm0 = math.sqrt(gg0)
        values, gnorms = history_arrays(f0, gnorm0, max_it)
        hist = empty_history(cfg.history_length, x0)
        x, f, g, extra, gnorm = x0, f0, g0, extra0, gnorm0
        it, reason, passes = 0, NOT_CONVERGED, 2   # the initial value+grad

        while reason == NOT_CONVERGED and it < max_it:
            dvec = two_loop_direction(g, hist)
            (dg,) = host_scalars(torch.dot(dvec, g))
            if not dg < 0:
                # Not a descent direction: restart from −g.
                dvec = -g
                (dg,) = host_scalars(torch.dot(dvec, g))
            x_new, f_new, g_new, extra, t, step_passes = step_fn(
                x, f, g, extra, dvec, dg, it)
            s, yv = x_new - x, g_new - g
            sy, ss, yy, gg = host_scalars(
                torch.dot(s, yv), torch.dot(s, s), torch.dot(yv, yv),
                torch.dot(g_new, g_new))
            update_history(hist, s, yv, sy, ss, yy)
            it += 1
            gnorm = math.sqrt(gg)
            reason = check_convergence(it, f, f_new, gnorm, gnorm0, cfg)
            if t == 0.0 and reason == NOT_CONVERGED:
                reason = FUNCTION_VALUES_CONVERGED
            values[it], gnorms[it] = f_new, gnorm
            passes += step_passes
            x, f, g = x_new, f_new, g_new

        return make_result(x, f, gnorm, it, reason, values, gnorms, passes,
                           max_it)

    def optimize(self, value_and_grad: ValueAndGrad, x0: Tensor) -> OptimizerResult:
        cfg = self.config
        f0_t, g0 = value_and_grad(x0)
        (f0,) = host_scalars(f0_t)

        def probe_at(x, dvec):
            def probe(t):
                ft, gt = value_and_grad(x + t * dvec)
                return host_scalars(ft)[0], gt
            return probe

        def step(x, f, g, extra, dvec, dg, it):
            t, ft, gt, accept, n_probes = armijo_backtrack(
                probe_at(x, dvec), f, dg, g, cfg.max_line_search_iterations)
            if not accept:
                return x, f, g, extra, t, 2 * n_probes
            # Each probe is one fused value+grad = 1 matvec + 1 rmatvec.
            return x + t * dvec, ft, gt, extra, t, 2 * n_probes

        return self._solve(x0, f0, g0, None, step)

    def optimize_scored(self, so, x0: Tensor) -> OptimizerResult:
        """L-BFGS with incrementally maintained margins z = Xw + offsets:
        Xp is computed ONCE per iteration, every probe prices f(w + t·p)
        from z + t·Xp elementwise, and the accepted point costs one rmatvec
        for the gradient. ``so`` is a ``functions.objective.
        ScoreSpaceObjective``."""
        cfg = self.config
        z0 = so.score(x0)
        (f0,) = host_scalars(so.value_from_scores(z0, x0))
        g0 = so.grad_from_scores(z0, x0)

        def step(x, f, g, z, dvec, dg, it):
            zp = so.score_delta(dvec)          # the one matvec
            t, ft, _, accept, _ = armijo_backtrack(
                lambda t: (host_scalars(
                    so.value_from_scores(z + t * zp, x + t * dvec))[0], None),
                f, dg, None, cfg.max_line_search_iterations)
            x_new, z_new, f_new = x, z, f
            if accept:
                x_new, z_new, f_new = x + t * dvec, z + t * zp, ft
            # Refresh z from x every 8 iterations: the incremental z gains
            # one rounding per accepted step. One extra matvec.
            refresh = (it + 1) % 8 == 0
            if refresh:
                z_new = so.score(x_new)
            g_new = so.grad_from_scores(z_new, x_new)   # the one rmatvec
            return x_new, f_new, g_new, z_new, t, 2 + int(refresh)

        return self._solve(x0, f0, g0, z0, step)
