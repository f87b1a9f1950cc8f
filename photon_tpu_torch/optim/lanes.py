"""L-BFGS, OWL-QN and TRON as masked batched lanes of independent solves.

The JAX package solves a random-effect bucket with ``jax.vmap(problem.run)``
over the ``lax.while_loop``s of ``photon_tpu/optim/{lbfgs,owlqn,tron}.py``:
every lane runs the loop body until the last lane is done, and a finished
lane's state is selected, unchanged, out of each step. Here the same loops
run over ``[E, P]`` state (an L-BFGS history of ``[E, m, P]``): each lane
carries an ``active`` mask, the line search and the CG loop carry their own
mask inside it, and every update goes through ``torch.where``, never a
scaling by 0. A lane that has stopped keeps its state bit for bit, so its
iterations, reason, values and ``data_passes`` are those of its own
unbatched solve.

The host decides whether any lane is still running from one fetch per outer
iteration, and one per probe round or CG round (``SYNCS`` counts them);
everything else stays on the device. An iteration evaluates the objective
for every lane at once (one pass over the whole bucket, see
``data/batch.py`` ``LaneFeatures``), the stopped ones' results discarded.

Objectives map ``[E, P]`` to per-lane values ``[E]`` and gradients
``[E, P]``. Each result is an ``OptimizerResult`` of per-lane tensors.

A single solve (the fixed effect: ``LBFGS``, ``OWLQN`` and ``TRON``, the
counterparts of ``photon_tpu/optim/{lbfgs,owlqn,tron}.py``'s classes) is one
lane over ``[1, D]``: the same loops, the same arithmetic.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import dataclasses

import torch

from photon_tpu_torch.optim.base import (
    FUNCTION_VALUES_CONVERGED,
    MAX_ITERATIONS,
    NOT_CONVERGED,
    Optimizer,
    OptimizerConfig,
    OptimizerResult,
    ValueAndGrad,
    check_convergence,
)

Tensor = torch.Tensor
LaneValueAndGrad = Callable[[Tensor], tuple[Tensor, Tensor]]

# Device-to-host fetches of the lane loops' conditions since the last
# ``reset_syncs``: outer iterations, line-search probe rounds, CG rounds.
SYNCS = {"outer": 0, "probe": 0, "cg": 0}

# LIBLINEAR TRON constants.
_ETA0, _ETA1, _ETA2 = 1e-4, 0.25, 0.75
_SIGMA1, _SIGMA2, _SIGMA3 = 0.25, 0.5, 4.0


def reset_syncs() -> None:
    for k in SYNCS:
        SYNCS[k] = 0


def _any(mask: Tensor, kind: str) -> bool:
    SYNCS[kind] += 1
    return bool(mask.any())


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b, dim=-1)


def _norm(a: Tensor, dot=_dot) -> Tensor:
    return torch.sqrt(dot(a, a))


def _pick(mask: Tensor, new: Tensor, old: Tensor) -> Tensor:
    """``new`` where the lane's ``mask`` is set, else ``old``."""
    return torch.where(mask.view(mask.shape + (1,) * (new.dim() - 1)), new, old)


class _Track:
    """Per-lane loop bookkeeping: iterations, reasons, data passes and the
    value / gradient-norm tracks (``inf`` beyond a lane's last iteration)."""

    def __init__(self, f0: Tensor, gnorm0: Tensor, max_it: int, passes0: int):
        e = f0.shape[0]
        dev, dt = f0.device, f0.dtype
        self.max_it = max_it
        self.values = torch.full((e, max_it + 1), float("inf"), dtype=dt, device=dev)
        self.gnorms = torch.full_like(self.values, float("inf"))
        self.values[:, 0] = f0
        self.gnorms[:, 0] = gnorm0
        self.reason = torch.full((e,), NOT_CONVERGED, dtype=torch.int32, device=dev)
        self.iters = torch.zeros((e,), dtype=torch.int32, device=dev)
        self.passes = torch.full((e,), passes0, dtype=torch.int32, device=dev)
        self.active = torch.ones((e,), dtype=torch.bool, device=dev)
        self.it = 0
        self._running = e > 0 and max_it > 0   # every lane starts NOT_CONVERGED

    def running(self) -> bool:
        """The loop condition: the one fetch of an outer iteration (none
        before the first, where every lane runs)."""
        if self.it > 0 and self._running:
            self._running = self.it < self.max_it and _any(self.active, "outer")
        return self._running

    def step(self, reason: Tensor, f_new: Tensor, gnorm_new: Tensor,
             passes: Tensor) -> None:
        """Record one iteration of the active lanes. (An active lane has run
        every iteration so far, so its iteration is the loop's: the
        convergence tests take ``it + 1``.)"""
        act = self.active
        self.it += 1
        self.reason = torch.where(act, reason, self.reason)
        self.values[:, self.it] = torch.where(act, f_new, self.values[:, self.it])
        self.gnorms[:, self.it] = torch.where(act, gnorm_new, self.gnorms[:, self.it])
        self.passes = self.passes + torch.where(act, passes, 0).to(torch.int32)
        self.iters = self.iters + act.to(torch.int32)
        self.active = self.reason == NOT_CONVERGED

    def result(self, x: Tensor, f: Tensor, grad_norm: Tensor) -> OptimizerResult:
        reason = torch.where(
            (self.reason == NOT_CONVERGED) & (self.iters >= self.max_it),
            torch.full_like(self.reason, MAX_ITERATIONS), self.reason)
        return OptimizerResult(
            x=x, value=f, grad_norm=grad_norm, iterations=self.iters,
            converged_reason=reason, values=self.values, grad_norms=self.gnorms,
            data_passes=self.passes)


# ------------------------------------------------------------ L-BFGS history


class LaneHistory(NamedTuple):
    """Per-lane curvature histories, newest pair last: slot m − 1 − j
    holds a lane's j-th newest pair, the slots beyond its count zeros. A
    push shifts the lane's pairs down one slot, the oldest of a full
    history falling out: the JAX package's circular buffer, in an order
    every lane shares, so that a slot is a view and never a gather."""

    s: Tensor        # [E, m, P] parameter deltas
    y: Tensor        # [E, m, P] gradient deltas
    rho: Tensor      # [E, m] 1 / (sᵀy)
    count: Tensor    # [E] valid pairs (≤ m)


def empty_history(m: int, like: Tensor) -> LaneHistory:
    e, p = like.shape
    z = dict(dtype=like.dtype, device=like.device)
    return LaneHistory(s=torch.zeros((e, m, p), **z), y=torch.zeros((e, m, p), **z),
                       rho=torch.zeros((e, m), **z),
                       count=torch.zeros(e, dtype=torch.int64, device=like.device))


def two_loop_direction(g: Tensor, hist: LaneHistory, n_slots: int,
                       dot=_dot) -> Tensor:
    """−H·g per lane by the two-loop recursion over each lane's valid
    pairs, steepest descent where a lane's history is empty. ``n_slots``
    bounds every lane's count (the iterations run so far, at most m); the
    slots past a lane's count are masked, as in the JAX package's loop over
    all m slots, and the second loop visits each lane's pairs oldest
    first."""
    m = hist.s.shape[1]
    valid = torch.arange(n_slots, device=g.device) < hist.count[:, None]
    q = g
    alpha = []
    for j in range(n_slots):
        k = m - 1 - j
        a = torch.where(valid[:, j], hist.rho[:, k] * dot(hist.s[:, k], q), 0.0)
        q = q - a[:, None] * hist.y[:, k]
        alpha.append(a)
    # Initial Hessian scaling γ = sᵀy / yᵀy from the newest pair.
    s_new, y_new = hist.s[:, m - 1], hist.y[:, m - 1]
    gamma = torch.where(hist.count > 0,
                        dot(s_new, y_new) / torch.clamp(dot(y_new, y_new), min=1e-30),
                        1.0)
    r = gamma[:, None] * q
    for j in reversed(range(n_slots)):
        k = m - 1 - j
        b = hist.rho[:, k] * dot(hist.y[:, k], r)
        corr = torch.where(valid[:, j], alpha[j] - b, 0.0)
        r = r + corr[:, None] * hist.s[:, k]
    return -r


def update_history(hist: LaneHistory, s: Tensor, y: Tensor,
                   active: Tensor, dot=_dot) -> LaneHistory:
    """Push each active lane's curvature pair unless its sᵀy is not
    sufficiently positive."""
    m = hist.s.shape[1]
    sy = dot(s, y)
    ok = active & (sy > 1e-10 * torch.sqrt(dot(s, s)) * torch.sqrt(dot(y, y)))

    def push(old: Tensor, new: Tensor) -> Tensor:
        return _pick(ok, torch.cat([old[:, 1:], new[:, None]], dim=1), old)

    return LaneHistory(s=push(hist.s, s), y=push(hist.y, y), rho=push(hist.rho, 1.0 / sy),
                       count=torch.where(ok, torch.clamp(hist.count + 1, max=m),
                                         hist.count))


# ----------------------------------------------------------------- line search


def armijo_backtrack(probe: Callable[[Tensor], tuple[Tensor, Tensor, tuple]],
                     f: Tensor, init_aux: tuple, active: Tensor, max_iters: int):
    """Per-lane backtracking from t = 1, halving: ``probe: t[E] ↦ (f_t,
    bound, aux)`` gives each lane's probe value, its sufficient-decrease
    bound (L-BFGS: f + 1e-4·t·dᵀg; OWL-QN: f + 1e-4·pgᵀ(x_t − x)) and a
    tuple of per-lane tensors to keep. A lane searches while it is
    ``active``, has not passed and has probed fewer than ``max_iters``
    times; each round probes every lane and keeps the searching lanes'
    results.

    Returns ``(t_final, f_t, aux, accept, n_probes)`` per lane; ``t_final``
    is 0 on a fully failed search, where the last probe is accepted only if
    it still decreases f. Non-finite probe values count as failures.
    """
    t = torch.ones_like(f)
    t_used = torch.ones_like(f)
    ft, aux = f, init_aux
    n = torch.zeros(f.shape, dtype=torch.int32, device=f.device)
    ok = torch.zeros_like(active)
    searching = active
    for rnd in range(max_iters):
        ft_p, bound, aux_p = probe(t)
        ok_p = (ft_p <= bound) & torch.isfinite(ft_p)
        ft = torch.where(searching, ft_p, ft)
        aux = tuple(_pick(searching, a, b) for a, b in zip(aux_p, aux))
        t_used = torch.where(searching, t, t_used)
        ok = torch.where(searching, ok_p, ok)
        t = torch.where(searching & ~ok_p, t * 0.5, t)
        n = n + searching.to(torch.int32)
        searching = searching & ~ok
        if rnd + 1 == max_iters or not _any(searching, "probe"):
            break
    accept = ok | (torch.isfinite(ft) & (ft < f))
    return torch.where(accept, t_used, 0.0), ft, aux, accept, n


# ----------------------------------------------------------------- L-BFGS


def _lbfgs_loop(cfg: OptimizerConfig, x0: Tensor, f0: Tensor, g0: Tensor,
                extra0, step_fn, dot=_dot) -> OptimizerResult:
    """The shared L-BFGS loop over lanes: direction, step via ``step_fn``,
    history update, convergence. ``step_fn(x, f, g, extra, d, it, active) →
    (x, f, g, extra, t_final, passes)``, per-lane tensors; ``t_final == 0``
    marks a fully failed line search."""
    gnorm0 = _norm(g0, dot)
    tr = _Track(f0, gnorm0, cfg.max_iterations, 2)    # the initial value+grad
    hist = empty_history(cfg.history_length, x0)
    x, f, g, extra = x0, f0, g0, extra0
    while tr.running():
        act = tr.active
        d = two_loop_direction(g, hist, min(tr.it, cfg.history_length), dot)
        # Not a descent direction: restart from −g.
        d = _pick(dot(d, g) < 0, d, -g)
        x_new, f_new, g_new, extra_new, t, passes = step_fn(x, f, g, extra, d,
                                                            tr.it, act)
        hist = update_history(hist, x_new - x, g_new - g, act, dot)
        gnorm = _norm(g_new, dot)
        reason = check_convergence(tr.it + 1, f, f_new, gnorm, gnorm0, cfg.tolerance)
        reason = torch.where((t == 0.0) & (reason == NOT_CONVERGED),
                             FUNCTION_VALUES_CONVERGED, reason).to(torch.int32)
        x, f, g = _pick(act, x_new, x), _pick(act, f_new, f), _pick(act, g_new, g)
        if extra is not None:
            extra = _pick(act, extra_new, extra)
        tr.step(reason, f_new, gnorm, passes)
    return tr.result(x, f, _norm(g, dot))


def lbfgs(cfg: OptimizerConfig, value_and_grad: LaneValueAndGrad,
          x0: Tensor, dot=_dot) -> OptimizerResult:
    """L-BFGS over lanes (``photon_tpu/optim/lbfgs.py`` ``optimize``): each
    probe one fused value+grad of every lane (2 data passes). ``dot`` is
    the coefficient-space inner product (see ``Optimizer.dot``)."""
    f0, g0 = value_and_grad(x0)

    def step(x, f, g, extra, d, it, active):
        dg = dot(d, g)

        def probe(t):
            ft, gt = value_and_grad(x + t[:, None] * d)
            return ft, f + 1e-4 * t * dg, (gt,)

        t, ft, (gt,), accept, n = armijo_backtrack(
            probe, f, (g,), active, cfg.max_line_search_iterations)
        x_new = _pick(accept, x + t[:, None] * d, x)
        return (x_new, torch.where(accept, ft, f), _pick(accept, gt, g), extra,
                t, 2 * n)

    return _lbfgs_loop(cfg, x0, f0, g0, None, step, dot)


def lbfgs_scored(cfg: OptimizerConfig, so, x0: Tensor) -> OptimizerResult:
    """L-BFGS over lanes (``optimize_scored``), with the margins z = Xw +
    offsets ([E, S]) maintained: one matvec (Xd) per iteration, the probes
    elementwise over z + t·Xd, one rmatvec for the gradient, and a matvec
    refreshing z from w every 8th iteration. ``so`` is a
    ``ScoreSpaceObjective`` over lanes."""
    z0 = so.score(x0)
    f0 = so.value_from_scores(z0, x0)
    g0 = so.grad_from_scores(z0, x0)

    def step(x, f, g, z, d, it, active):
        zd = so.score_delta(d)                            # the one matvec
        dg = _dot(d, g)
        t, ft, _, accept, _ = armijo_backtrack(
            lambda t: (so.value_from_scores(z + t[:, None] * zd, x + t[:, None] * d),
                       f + 1e-4 * t * dg, ()),
            f, (), active, cfg.max_line_search_iterations)
        x_new = _pick(accept, x + t[:, None] * d, x)
        z_new = _pick(accept, z + t[:, None] * zd, z)
        # Refresh z from x every 8 iterations (an active lane's iteration is
        # the loop's): the incremental z gains one rounding per step.
        refresh = (it + 1) % 8 == 0
        if refresh:
            z_new = so.score(x_new)
        g_new = so.grad_from_scores(z_new, x_new)         # the one rmatvec
        passes = torch.full_like(accept, 2 + int(refresh), dtype=torch.int32)
        return x_new, torch.where(accept, ft, f), g_new, z_new, t, passes

    return _lbfgs_loop(cfg, x0, f0, g0, z0, step)


# ----------------------------------------------------------------- OWL-QN


def pseudo_gradient(x: Tensor, g: Tensor, l1: Tensor) -> Tensor:
    """Steepest-descent subgradient of f(x) + Σ l1ᵢ|xᵢ| (Andrew & Gao eq. 4)."""
    right, left = g + l1, g - l1
    at_zero = torch.where(left > 0.0, left, torch.where(right < 0.0, right, 0.0))
    return torch.where(x > 0.0, right, torch.where(x < 0.0, left, at_zero))


def owlqn(cfg: OptimizerConfig, value_and_grad: LaneValueAndGrad, x0: Tensor,
          l1: Tensor, dot=_dot) -> OptimizerResult:
    """OWL-QN over lanes (Andrew & Gao 2007): ``value_and_grad`` the smooth
    part (loss + any L2 term),
    ``l1`` the ``[E, P]`` per-coefficient L1 weights."""
    l1 = l1.to(x0.dtype)

    def total(x, fs):
        return fs + dot(l1, torch.abs(x))

    f0s, g0 = value_and_grad(x0)
    f0 = total(x0, f0s)
    gnorm0 = _norm(pseudo_gradient(x0, g0, l1), dot)
    tr = _Track(f0, gnorm0, cfg.max_iterations, 2)
    hist = empty_history(cfg.history_length, x0)
    x, f, g = x0, f0, g0
    while tr.running():
        act = tr.active
        pg = pseudo_gradient(x, g, l1)
        d = two_loop_direction(pg, hist, min(tr.it, cfg.history_length), dot)
        # Align with −pg (zero the disagreeing parts); steepest descent where
        # nothing is left.
        d = torch.where(d * (-pg) > 0.0, d, 0.0)
        d = _pick(dot(d, d) > 0.0, d, -pg)
        xi = torch.where(x != 0.0, torch.sign(x), torch.sign(-pg))

        def probe(t):
            # The trial point projected onto the search orthant; Armijo on
            # the total objective along the projected displacement.
            xt = x + t[:, None] * d
            xt = torch.where(xt * xi >= 0.0, xt, 0.0)
            fts, gt = value_and_grad(xt)
            return total(xt, fts), f + 1e-4 * dot(pg, xt - x), (gt, xt)

        _, ft, (gt, xt), accept, n = armijo_backtrack(
            probe, f, (g, x), act, cfg.max_line_search_iterations)
        x_new, f_new, g_new = _pick(accept, xt, x), torch.where(accept, ft, f), \
            _pick(accept, gt, g)
        hist = update_history(hist, x_new - x, g_new - g, act, dot)
        gnorm = _norm(pseudo_gradient(x_new, g_new, l1), dot)
        reason = check_convergence(tr.it + 1, f, f_new, gnorm, gnorm0, cfg.tolerance)
        reason = torch.where(~accept & (reason == NOT_CONVERGED),
                             FUNCTION_VALUES_CONVERGED, reason).to(torch.int32)
        x, f, g = _pick(act, x_new, x), _pick(act, f_new, f), _pick(act, g_new, g)
        tr.step(reason, f_new, gnorm, 2 * n)   # a probe is one value+grad
    return tr.result(x, f, _norm(pseudo_gradient(x, g, l1), dot))


# ------------------------------------------------------------------- TRON


def _boundary_tau(p: Tensor, d: Tensor, delta: Tensor, dot=_dot) -> Tensor:
    """τ ≥ 0 with ‖p + τ·d‖ = delta, per lane."""
    dd, pd, pp = dot(d, d), dot(p, d), dot(p, p)
    disc = torch.sqrt(torch.clamp(pd * pd + dd * (delta * delta - pp), min=0.0))
    return (-pd + disc) / torch.clamp(dd, min=1e-30)


def steihaug_cg(hvp: Callable[[Tensor], Tensor], g: Tensor, delta: Tensor,
                max_iters: int, tol: Tensor, active: Tensor, dot=_dot):
    """Per-lane truncated CG for H p = −g inside ‖p‖ ≤ delta. A lane
    iterates while it is ``active``, has not hit the boundary, has run
    fewer than ``max_iters`` steps and its residual norm exceeds ``tol``;
    each round is one H·v of every lane. Returns ``(p, Hp, n_hvp)``."""
    r = -g
    d, p, hp = r, torch.zeros_like(g), torch.zeros_like(g)
    rr = dot(r, r)
    n = torch.zeros(g.shape[0], dtype=torch.int32, device=g.device)
    cg = active & (torch.sqrt(rr) > tol) if max_iters > 0 else torch.zeros_like(active)
    for rnd in range(max_iters):
        hd = hvp(d)
        dhd = dot(d, hd)
        alpha = rr / torch.where(dhd > 1e-30, dhd, 1.0)
        # Negative curvature or a step outside the region: walk to the edge.
        p_try = p + alpha[:, None] * d
        hit = (dhd <= 1e-30) | (_norm(p_try, dot) >= delta)
        step = torch.where(hit, _boundary_tau(p, d, delta, dot), alpha)[:, None]
        p_new, hp_new, r_new = p + step * d, hp + step * hd, r - step * hd
        rr_new = dot(r_new, r_new)
        beta = rr_new / torch.clamp(rr, min=1e-30)
        d_new = r_new + beta[:, None] * d
        p, hp, r, d = (_pick(cg, p_new, p), _pick(cg, hp_new, hp),
                       _pick(cg, r_new, r), _pick(cg, d_new, d))
        rr = torch.where(cg, rr_new, rr)
        n = n + cg.to(torch.int32)
        cg = cg & ~hit & (n < max_iters) & (torch.sqrt(rr) > tol)
        if rnd + 1 == max_iters or not _any(cg, "cg"):
            break
    return p, hp, n


def tron(cfg: OptimizerConfig, value_and_grad: LaneValueAndGrad, x0: Tensor,
         hvp_at: Callable[[Tensor], Callable[[Tensor], Tensor]],
         dot=_dot) -> OptimizerResult:
    """TRON over lanes (LIBLINEAR's trust-region Newton with Steihaug CG,
    Lin, Weng & Keerthi 2008). ``hvp_at(x)`` gives ``v ↦ H(x)·v`` of
    every lane, its margins computed once per point (1 pass), each H·v 2
    passes."""
    f0, g0 = value_and_grad(x0)
    gnorm0 = _norm(g0, dot)
    tr = _Track(f0, gnorm0, cfg.max_iterations, 2)
    x, f, g, delta = x0, f0, g0, gnorm0
    while tr.running():
        act = tr.active
        gnorm = _norm(g, dot)
        p, hp, n_hvp = steihaug_cg(hvp_at(x), g, delta, cfg.max_cg_iterations,
                                   0.1 * gnorm, act, dot)
        # Predicted reduction of the quadratic model: −(gᵀp + ½ pᵀHp).
        pred = -(dot(g, p) + 0.5 * dot(p, hp))
        x_try = x + p
        f_try, g_try = value_and_grad(x_try)
        rho = (f - f_try) / torch.where(torch.abs(pred) > 1e-30, pred, 1.0)
        # A non-finite trial value takes the shrink branch.
        rho = torch.where(torch.isfinite(f_try), rho, -float("inf"))
        pnorm = _norm(p, dot)
        delta_new = torch.where(
            rho < _ETA1,
            torch.clamp(_SIGMA1 * torch.minimum(pnorm, delta), min=1e-12),
            torch.where(rho < _ETA2, _SIGMA2 * delta,
                        torch.minimum(torch.maximum(_SIGMA3 * pnorm, delta),
                                      _SIGMA3 * delta)))
        accept = rho > _ETA0
        x_new, f_new, g_new = (_pick(accept, x_try, x), torch.where(accept, f_try, f),
                               _pick(accept, g_try, g))
        gnorm_new = _norm(g_new, dot)
        # The function-value test only means something on accepted steps.
        reason = torch.where(
            accept,
            check_convergence(tr.it + 1, f, f_new, gnorm_new, gnorm0, cfg.tolerance),
            NOT_CONVERGED)
        # A collapsed radius ends the lane.
        reason = torch.where((delta_new <= 1e-12) & (reason == NOT_CONVERGED),
                             FUNCTION_VALUES_CONVERGED, reason).to(torch.int32)
        x, f, g = _pick(act, x_new, x), _pick(act, f_new, f), _pick(act, g_new, g)
        delta = torch.where(act, delta_new, delta)
        # The hoisted margins, 2 per H·v, and the trial value+grad.
        tr.step(reason, f_new, gnorm_new, 1 + 2 * n_hvp + 2)
    return tr.result(x, f, _norm(g, dot))


# ------------------------------------------------------- one solve, one lane


def _one_lane(value_and_grad: ValueAndGrad) -> LaneValueAndGrad:
    def vg(x: Tensor) -> tuple[Tensor, Tensor]:
        f, g = value_and_grad(x[0])
        return f.reshape(1), g[None]
    return vg


def _unbatched(r: OptimizerResult) -> OptimizerResult:
    """A one-lane result as a single solve's: Python scalars (one fetch)
    and host tracks."""
    f, gnorm, it, reason, passes = torch.stack([
        r.value[0].double(), r.grad_norm[0].double(), r.iterations[0].double(),
        r.converged_reason[0].double(), r.data_passes[0].double()]).tolist()
    return OptimizerResult(
        x=r.x[0], value=f, grad_norm=gnorm, iterations=int(it),
        converged_reason=int(reason), values=r.values[0].cpu(),
        grad_norms=r.grad_norms[0].cpu(), data_passes=int(passes))


def _dot_of(opt: Optimizer):
    return _dot if opt.dot is None else opt.dot


@dataclasses.dataclass(frozen=True)
class LBFGS(Optimizer):
    """Limited-memory BFGS on one ``[D]`` solve."""

    def optimize(self, value_and_grad: ValueAndGrad, x0: Tensor) -> OptimizerResult:
        return _unbatched(lbfgs(self.config, _one_lane(value_and_grad), x0[None],
                                _dot_of(self)))

    def optimize_scored(self, so, x0: Tensor) -> OptimizerResult:
        """With the margins z = Xw + offsets maintained (``so`` a
        ``functions.objective.ScoreSpaceObjective``)."""
        lane = dataclasses.replace(
            so,
            score=lambda w: so.score(w[0])[None],
            score_delta=lambda p: so.score_delta(p[0])[None],
            value_from_scores=lambda z, w: so.value_from_scores(z[0], w[0]).reshape(1),
            grad_from_scores=lambda z, w: so.grad_from_scores(z[0], w[0])[None])
        return _unbatched(lbfgs_scored(self.config, lane, x0[None]))


@dataclasses.dataclass(frozen=True)
class OWLQN(Optimizer):
    """Orthant-wise L-BFGS: ``optimize(value_and_grad, x0, l1_weights)``
    with ``value_and_grad`` the smooth part and ``l1_weights`` the ``[D]``
    per-coefficient L1 penalties."""

    def optimize(  # type: ignore[override]
        self, value_and_grad: ValueAndGrad, x0: Tensor, l1_weights: Tensor
    ) -> OptimizerResult:
        return _unbatched(owlqn(self.config, _one_lane(value_and_grad), x0[None],
                                l1_weights[None], _dot_of(self)))


@dataclasses.dataclass(frozen=True)
class TRON(Optimizer):
    """Trust-region Newton: ``optimize(value_and_grad, x0, hvp_at)`` with
    ``hvp_at(x)`` returning ``v ↦ H(x)·v`` (``GLMObjective.bind_hvp_at``
    computes the margins once per point)."""

    def optimize(  # type: ignore[override]
        self,
        value_and_grad: ValueAndGrad,
        x0: Tensor,
        hvp_at: Callable[[Tensor], Callable[[Tensor], Tensor]],
    ) -> OptimizerResult:
        def lane_hvp_at(x: Tensor) -> Callable[[Tensor], Tensor]:
            hv = hvp_at(x[0])
            return lambda v: hv(v[0])[None]

        return _unbatched(tron(self.config, _one_lane(value_and_grad), x0[None],
                               lane_hvp_at, _dot_of(self)))
