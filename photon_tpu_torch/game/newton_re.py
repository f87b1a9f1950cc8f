"""Batched Newton solvers for random-effect buckets (primal and dual).

Port of ``photon_tpu/game/newton_re.py``. Every entity of a bucket is one
lane of a batched solve; there is no per-entity loop. Two history-free
solvers, picked per bucket by shape:

* **Primal dense Newton** (``fit_bucket_newton``), for small local dims
  (P ≤ ``NEWTON_MAX_P``): the per-entity Hessian ``Xᵀ diag(d2) X`` [P, P] is
  one batched matmul, solved by a batched Cholesky.
* **Span-reduced (dual) Newton** (``fit_bucket_newton_dual``), for few rows
  in a wide subspace (S < P): with an L2 penalty or Gaussian prior the
  optimum is ``w = D⁺(Xᵀα + q) + Σ_u β_u e_u`` (β for the unpenalized
  columns, typically the intercept), so the solve lives in S + U dimensions:
  margins are linear in θ = (α, β) through the Gram matrix ``G = X D⁺ Xᵀ``.

Both share ``_newton_loop``: ridge-damped batched Cholesky solves, a
steepest-descent fallback per lane, and a line search whose 12 backtracking
steps are evaluated in one ``[L, E]`` pass. The JAX ``lax.while_loop``
becomes a host loop over lanes masked on the device: every per-lane
decision is a tensor op, and the loop condition ``any(active)`` is the one
device-to-host fetch of an iteration (``SYNCS`` counts them).

The products are plain torch (``torch.bmm`` and the triangular solves on
cuBLAS, ``torch.linalg.cholesky_ex`` on cuSOLVER on the card):
the JAX package computes them outside any Pallas kernel too. The f32
products rely on PyTorch's default of no TF32 in matmuls, which the port
never changes. A failed Cholesky does not raise here: ``cholesky_ex``
reports it in ``info``, and a lane with ``info != 0`` takes the
steepest-descent step, as a NaN factor does in the JAX version.

The dense design is built by one scatter per ELL slot k: within one k every
(entity, row) target is distinct, so duplicate (row, column) entries sum in
k order on every device, bit for bit from run to run.

Gates, budget and chunk ladder are the JAX module's, read from the same
environment (``PHOTON_RE_NEWTON``, ``PHOTON_RE_NEWTON_BUDGET_MB``,
``PHOTON_RE_CHUNK_LADDER``), so both packages pick the same plan for a
bucket. Everything solves in ``w0.dtype``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import torch

from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures
from photon_tpu_torch.functions.prior import PriorDistribution
from photon_tpu_torch.models.coefficients import Coefficients
from photon_tpu_torch.models.glm import GeneralizedLinearModel
from photon_tpu_torch.ops.losses import loss_for_task
from photon_tpu_torch.optim.base import (
    FUNCTION_VALUES_CONVERGED,
    MAX_ITERATIONS,
    NOT_CONVERGED,
    OptimizerResult,
    check_convergence,
)

Tensor = torch.Tensor

NEWTON_MAX_P = 64           # [P,P] solves stay tiny; beyond this, no primal
NEWTON_CHUNK_MAX_P = 128    # wider P admitted for chunked primal candidates
DUAL_MAX_T = 80             # S + U cap; beyond this the systems stop being tiny
_DEFAULT_BUDGET_MB = 2048   # dense X + H + probe buffers cap
# Blessed entity-chunk sizes of a sub-batched solve (the last chunk padded
# up). Override: PHOTON_RE_CHUNK_LADDER=256,1024,...
_DEFAULT_CHUNK_LADDER = (256, 1024, 4096, 16384)

# Device-to-host fetches of the Newton loops' conditions since the last
# ``reset_syncs`` (one per iteration of a bucket or chunk solve).
SYNCS = {"newton_loop": 0}


def reset_syncs() -> None:
    SYNCS["newton_loop"] = 0


def chunk_ladder() -> tuple:
    raw = os.environ.get("PHOTON_RE_CHUNK_LADDER", "")
    if raw:
        sizes = tuple(sorted({int(x) for x in raw.split(",") if x.strip()}))
        if not sizes or min(sizes) < 1:
            raise ValueError(
                f"PHOTON_RE_CHUNK_LADDER must be positive ints, got {raw!r}"
            )
        return sizes
    return _DEFAULT_CHUNK_LADDER


def _budget_bytes() -> float:
    return float(os.environ.get("PHOTON_RE_NEWTON_BUDGET_MB",
                                _DEFAULT_BUDGET_MB)) * 1e6


def _smooth_ok(problem, normalization) -> bool:
    if os.environ.get("PHOTON_RE_NEWTON", "") == "0":
        return False
    from photon_tpu_torch.optim import OptimizerType

    if problem.optimizer_type not in (OptimizerType.LBFGS, OptimizerType.TRON):
        return False  # OWL-QN/L1: non-smooth, orthant semantics
    if problem.regularization.l1_weight(float(problem.reg_weight)) > 0.0:
        return False
    return normalization is None


def penalty_terms(problem, local_mask: Tensor,
                  local_prior: Optional[PriorDistribution],
                  dtype: torch.dtype = torch.float32):
    """``(l2v, pm, pp, d_pen)`` in ``dtype``: the quadratic-penalty pieces
    both solvers and the dual gate derive everything from (one definition,
    so the gate's count of unpenalized columns and the dual solver's D⁺
    always agree)."""
    lam = problem.regularization.l2_weight(float(problem.reg_weight))
    l2v = lam * local_mask.to(dtype)
    if local_prior is not None:
        pm = local_prior.means.to(dtype)
        pp = local_prior.precisions.to(dtype)
    else:
        pm = torch.zeros_like(l2v)
        pp = torch.zeros_like(l2v)
    return l2v, pm, pp, l2v + pp


def u_max_for(d_pen: Tensor) -> int:
    """Worst-per-entity count of unpenalized columns (d_pen == 0) that the
    dual path carries as explicit β parameters. One device-to-host fetch."""
    return int((d_pen <= 0.0).sum(dim=1).max().item())


def bucket_u_max(problem, local_mask: Tensor,
                 local_prior: Optional[PriorDistribution],
                 rows: int = 16384) -> int:
    """``u_max_for`` of a whole bucket's ``penalty_terms``, over blocks of
    ``rows`` entities: the bucket's [E, P] penalty pieces (four of them)
    are never all on the device at once, only a block's. One fetch."""
    worst = []
    for lo in range(0, local_mask.shape[0], rows):
        prior = (None if local_prior is None else PriorDistribution(
            means=local_prior.means[lo:lo + rows],
            precisions=local_prior.precisions[lo:lo + rows]))
        d_pen = penalty_terms(problem, local_mask[lo:lo + rows], prior)[3]
        worst.append((d_pen <= 0.0).sum(dim=1).max())
    return int(torch.stack(worst).max().item())


def _primal_need_bytes(e: int, s: int, p: int, esize: float) -> float:
    """Dominant dense buffers of an E-entity primal solve: X [E,S,P+1],
    H [E,P,P] and the probe batch's [L,E,S] margins, [L,E,S] losses and
    [L,E,P] trial parameters (L = 12)."""
    return esize * (e * s * (p + 1) + e * p * p + 12 * e * (2 * s + p))


def _dual_need_bytes(e: int, s: int, p: int, u: int, esize: float) -> float:
    """Dominant dense buffers of an E-entity dual solve: X [E,S,P+1],
    G/J [E,S,S+U] and the probe batch's [12,E,S] margins and losses and
    [12,E,S+U] trial parameters."""
    return esize * (e * s * (p + 1) + 2 * e * s * (s + u)
                    + 12 * e * (2 * s + s + u))


def _bucket_shape(bucket) -> tuple[int, int, int, float]:
    e, s, _ = bucket.idx.shape
    return int(e), int(s), int(bucket.local_dim), float(bucket.val.element_size())


def newton_eligible(problem, bucket, normalization, shards: int = 1) -> bool:
    """True when this bucket's solve may take the PRIMAL dense-Newton path
    on the whole bucket at once. ``shards`` (the entity axis of a mesh)
    prices the per-device slice, E/shards lanes: a mesh widens what Newton
    admits."""
    if os.environ.get("PHOTON_RE_NEWTON", "") == "dual":
        return False  # test/debug override: route to the dual path
    if not _smooth_ok(problem, normalization):
        return False
    e, s, p, esize = _bucket_shape(bucket)
    if p > NEWTON_MAX_P:
        return False
    e_dev = -(-e // max(1, shards))
    return _primal_need_bytes(e_dev, s, p, esize) <= _budget_bytes()


def _largest_fitting_chunk(need_at: Callable[[int], float], e: int,
                           multiple_of: int = 1):
    """Best blessed chunk size for an E-entity bucket, or None when even the
    smallest ladder size busts the budget: the largest budget-fitting size
    whose padded lanes ``ceil(E/C)*C`` stay within 12.5% of E; if none
    qualifies, the size with the fewest padded lanes. ``multiple_of`` (the
    entity axis of a mesh) keeps only sizes that shard evenly."""
    budget = _budget_bytes()
    fitting = []
    for c in chunk_ladder():
        if need_at(c) > budget:
            break  # ladder is sorted: larger sizes only need more
        if c % multiple_of:
            continue
        fitting.append(c)
        if c >= e:
            break  # larger sizes only add padding
    if not fitting:
        return None
    for c in reversed(fitting):
        if -(-e // c) * c <= e + (e >> 3):
            return c
    return min(fitting, key=lambda c: (-(-e // c) * c, -c))


def newton_chunk_size(problem, bucket, normalization, max_p: int = NEWTON_MAX_P,
                      shards: int = 1):
    """Blessed chunk size for an entity-sub-batched PRIMAL solve, or None.
    ``shards`` > 1 prices each chunk's per-device slice and keeps the
    mesh-divisible sizes."""
    if os.environ.get("PHOTON_RE_NEWTON", "") == "dual":
        return None
    if not _smooth_ok(problem, normalization):
        return None
    e, s, p, esize = _bucket_shape(bucket)
    if p > max_p:
        return None
    sh = max(1, shards)
    return _largest_fitting_chunk(
        lambda c: _primal_need_bytes(-(-c // sh), s, p, esize), e, multiple_of=sh)


def dual_precheck(problem, bucket, normalization) -> bool:
    """The dual gates that need no u_max (so no device fetch): smooth, no
    FULL variances, and S < P with S ≤ DUAL_MAX_T."""
    if not _smooth_ok(problem, normalization):
        return False
    from photon_tpu_torch.functions.problem import VarianceComputationType

    if problem.variance_type == VarianceComputationType.FULL:
        return False  # diag(H^-1) needs the [P,P] primal Hessian
    _, s, p, _ = _bucket_shape(bucket)
    return s < p and s <= DUAL_MAX_T


def dual_eligible(problem, bucket, normalization, u_max: int,
                  shards: int = 1) -> bool:
    """True when this bucket may take the span-reduced Newton path on the
    whole bucket at once; ``shards`` prices the per-device slice."""
    if not dual_precheck(problem, bucket, normalization):
        return False
    e, s, p, esize = _bucket_shape(bucket)
    if s + u_max > DUAL_MAX_T:
        return False
    e_dev = -(-e // max(1, shards))
    return _dual_need_bytes(e_dev, s, p, u_max, esize) <= _budget_bytes()


def dual_chunk_size(problem, bucket, normalization, u_max: int,
                    shards: int = 1):
    """Blessed chunk size for an entity-sub-batched DUAL solve, or None
    (``shards`` as in ``newton_chunk_size``)."""
    if not dual_precheck(problem, bucket, normalization):
        return None
    e, s, p, esize = _bucket_shape(bucket)
    if s + u_max > DUAL_MAX_T:
        return None
    sh = max(1, shards)
    return _largest_fitting_chunk(
        lambda c: _dual_need_bytes(-(-c // sh), s, p, u_max, esize), e,
        multiple_of=sh)


def _dense_design(batches: LabeledBatch, dtype: torch.dtype):
    """Dense local design [E,S,P+1]: the ELL ghost column (== P) lands in
    the extra zero column. One scatter per ELL slot k, in k order; within a
    slot every (entity, row) target is distinct, so the sums are the same
    on every run. Also returns (y, off, tw) in ``dtype``."""
    feats = batches.features
    idx = feats.idx.long()
    val = feats.val.to(dtype)
    e, s, k = idx.shape
    p = feats.dim
    x_ext = torch.zeros((e * s, p + 1), dtype=dtype, device=val.device)
    for j in range(k):
        x_ext.scatter_add_(1, idx[:, :, j].reshape(-1, 1),
                           val[:, :, j].reshape(-1, 1))
    return (
        x_ext.reshape(e, s, p + 1),
        batches.labels.to(dtype),
        batches.offsets.to(dtype),
        batches.weights.to(dtype),
    )


def _newton_loop(x0, z0, cfg, value_at, grad_at, hess_at, lin_map,
                 probe_values, ridge):
    """Shared damped-Newton driver over a batch of independent lanes.

    ``x0`` [E,T] parameters, ``z0`` [E,S] resident margins. Closures:
    ``value_at(x, z) -> [E]``, ``grad_at(x, z) -> [E,T]``,
    ``hess_at(x, z) -> [E,T,T]``, ``lin_map(d) -> [E,S]`` (margins are
    linear in the parameters), ``probe_values(x, z, d, zd, ts) -> [L,E]``
    (objective at every backtracking step in one pass). ``ridge`` scales
    the trace-relative jitter that keeps degenerate lanes PD.

    Returns ``(x, z, f, g, reason, it, values, gnorms, passes, iters)``.
    """
    e, t_dim = x0.shape
    dt, dev = x0.dtype, x0.device
    max_it = cfg.max_iterations
    # 12 probes reach t = 2^-11 ≈ 5e-4; below that a damped-Newton step on
    # a smooth convex objective is noise.
    n_probe = min(cfg.max_line_search_iterations, 12)
    ts = 0.5 ** torch.arange(n_probe, dtype=dt, device=dev)
    eye = torch.eye(t_dim, dtype=dt, device=dev)
    c1 = 1e-4

    x, z = x0, z0
    f = value_at(x, z)
    g = grad_at(x, z)
    gnorm0 = torch.linalg.vector_norm(g, dim=1)
    values = torch.full((e, max_it + 1), float("inf"), dtype=dt, device=dev)
    gnorms = torch.full((e, max_it + 1), float("inf"), dtype=dt, device=dev)
    values[:, 0] = f
    gnorms[:, 0] = gnorm0
    reason = torch.full((e,), NOT_CONVERGED, dtype=torch.int32, device=dev)
    passes = torch.full((e,), 2, dtype=torch.int32, device=dev)
    iters = torch.zeros((e,), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    it = 0
    running = e > 0 and max_it > 0      # every lane starts NOT_CONVERGED
    while running:
        active = reason == NOT_CONVERGED

        h = hess_at(x, z)
        scale = 1.0 + torch.diagonal(h, dim1=1, dim2=2).sum(dim=1) / t_dim
        h_damped = h + (ridge * scale)[:, None, None] * eye
        chol, info = torch.linalg.cholesky_ex(h_damped)
        # cho_solve as two triangular solves, as JAX's is (and with no
        # status read back from the device)
        y = torch.linalg.solve_triangular(chol, g[..., None], upper=False)
        d = -torch.linalg.solve_triangular(chol.mT, y, upper=True)[..., 0]
        dg = torch.sum(d * g, dim=1)
        # A non-descent lane, a non-finite step or a failed factorization
        # takes steepest descent.
        bad = (dg >= 0.0) | ~torch.isfinite(dg) | (info != 0)
        d = torch.where(bad[:, None], -g, d)
        dg = torch.where(bad, -torch.sum(g * g, dim=1), dg)

        zd = lin_map(d)                                        # [E, S]
        ft = probe_values(x, z, d, zd, ts)                     # [L, E]
        armijo = torch.isfinite(ft) & (ft <= f[None] + c1 * ts[:, None]
                                       * dg[None])
        any_ok = armijo.any(dim=0)
        first = torch.argmax(armijo.to(torch.int8), dim=0)    # largest t
        # No probe passes: the smallest step that still decreases f, else
        # the lane freezes.
        last = ft[-1]
        salvage = (~any_ok) & torch.isfinite(last) & (last < f)
        t_pick = torch.where(any_ok, ts[first],
                             torch.where(salvage, ts[-1], zero))
        stepped = active & (t_pick > 0.0)

        x_new = torch.where(stepped[:, None], x + t_pick[:, None] * d, x)
        z_new = torch.where(stepped[:, None], z + t_pick[:, None] * zd, z)
        fs = value_at(x_new, z_new)
        gs = grad_at(x_new, z_new)
        f_new = torch.where(stepped, fs, f)
        g_new = torch.where(stepped[:, None], gs, g)

        it += 1
        gn = torch.linalg.vector_norm(g_new, dim=1)
        conv = check_convergence(it, f, f_new, gn, gnorm0, cfg.tolerance)
        reason = torch.where(
            active,
            torch.where(stepped, conv,
                        torch.full_like(conv, FUNCTION_VALUES_CONVERGED)),
            reason,
        )
        values[:, it] = torch.where(stepped, f_new, float("inf"))
        gnorms[:, it] = torch.where(stepped, gn, float("inf"))
        # Hessian + gradient assembly ≈ 2 data-equivalent passes, the probe
        # batch 1.
        passes = passes + torch.where(active, 3, 0).to(torch.int32)
        iters = iters + stepped.to(torch.int32)
        x, z, f, g = x_new, z_new, f_new, g_new
        if it >= max_it:
            break
        SYNCS["newton_loop"] += 1
        running = bool((reason == NOT_CONVERGED).any())
    reason = torch.where((reason == NOT_CONVERGED) & (it >= max_it),
                         torch.full_like(reason, MAX_ITERATIONS), reason)
    return x, z, f, g, reason, it, values, gnorms, passes, iters


def _result(w, f, gnorm, reason, values, gnorms, passes, iters, dtype):
    """Per-lane ``OptimizerResult``: every field is a tensor with the
    entity axis first."""
    return OptimizerResult(
        x=w.to(dtype), value=f, grad_norm=gnorm, iterations=iters,
        converged_reason=reason, values=values, grad_norms=gnorms,
        data_passes=passes,
    )


def fit_bucket_newton(problem, batches: LabeledBatch, w0: Tensor,
                      local_mask: Tensor,
                      local_prior: Optional[PriorDistribution]):
    """Primal damped-Newton solve of every entity in one bucket.
    ``batches`` holds ``[E, S, ...]`` leaves; returns ``(model, result)``
    with ``[E, P]`` coefficients and per-lane results."""
    from photon_tpu_torch.functions.problem import VarianceComputationType

    dt = w0.dtype
    loss = loss_for_task(problem.task)
    x_ext, y, off, tw = _dense_design(batches, dt)
    x = x_ext[..., : batches.features.dim].contiguous()
    xt = x.transpose(1, 2)                                  # [E, P, S]
    l2v, pm, pp, _ = penalty_terms(problem, local_mask, local_prior, dt)

    def value_at(w, z):
        return (
            torch.sum(tw * loss.loss(z, y), dim=1)
            + 0.5 * torch.sum(l2v * w * w, dim=1)
            + 0.5 * torch.sum(pp * (w - pm) ** 2, dim=1)
        )

    def grad_at(w, z):
        d1 = tw * loss.d1(z, y)
        return torch.bmm(d1[:, None, :], x)[:, 0] + l2v * w + pp * (w - pm)

    def hess_at(w, z):
        d2 = tw * loss.d2(z, y)
        h = torch.bmm(xt, x * d2[..., None])
        return h + torch.diag_embed(l2v + pp)

    def lin_map(d):
        return torch.bmm(x, d[..., None])[..., 0]

    def probe_values(w, z, d, zd, ts):
        zt = z[None] + ts[:, None, None] * zd[None]            # [L, E, S]
        wt = w[None] + ts[:, None, None] * d[None]             # [L, E, P]
        return (
            torch.sum(tw[None] * loss.loss(zt, y[None]), dim=2)
            + 0.5 * torch.sum(l2v[None] * wt * wt, dim=2)
            + 0.5 * torch.sum(pp[None] * (wt - pm[None]) ** 2, dim=2)
        )

    w = w0.to(dt)
    z = off + lin_map(w)
    (w, z, f, g, reason, _, values, gnorms, passes, iters) = _newton_loop(
        w, z, problem.optimizer_config, value_at, grad_at, hess_at,
        lin_map, probe_values, ridge=1e-8,
    )

    variances = None
    if problem.variance_type != VarianceComputationType.NONE:
        # GLMOptimizationProblem's formulas from the final Hessian (L2 and
        # prior precision included): SIMPLE = 1/diag H, FULL = diag H⁻¹.
        h = hess_at(w, z)
        if problem.variance_type == VarianceComputationType.SIMPLE:
            diag = torch.diagonal(h, dim1=1, dim2=2)
            variances = 1.0 / torch.clamp(diag, min=1e-12)
        else:
            eye = torch.eye(w.shape[1], dtype=dt, device=w.device)
            hinv, info = torch.linalg.inv_ex(h + 1e-12 * eye)
            variances = torch.diagonal(hinv, dim1=1, dim2=2)
            # A singular lane has no inverse: NaN, as the JAX inverse gives.
            variances = torch.where((info != 0)[:, None],
                                    torch.full_like(variances, float("nan")),
                                    variances)
        variances = variances.to(w0.dtype).contiguous()

    result = _result(w, f, torch.linalg.vector_norm(g, dim=1), reason,
                     values, gnorms, passes, iters, w0.dtype)
    model = GeneralizedLinearModel(
        Coefficients(means=w.to(w0.dtype), variances=variances), problem.task)
    return model, result


def fit_bucket_newton_dual(problem, batches: LabeledBatch, w0: Tensor,
                           local_mask: Tensor,
                           local_prior: Optional[PriorDistribution],
                           u_max: int):
    """Span-reduced Newton solve of every entity in one bucket, from θ = 0.
    ``w0`` gives only the solve's dtype: a warm start lies outside the span
    parametrization, so the dual path ignores its values (a warm-started
    sweep changes nothing here). Variances: NONE or SIMPLE."""
    from photon_tpu_torch.functions.problem import VarianceComputationType

    dt = w0.dtype
    loss = loss_for_task(problem.task)
    x_ext, y, off, tw = _dense_design(batches, dt)
    e, s, _ = x_ext.shape
    p = batches.features.dim
    x = x_ext[..., :p].contiguous()

    _, pm, pp, d_pen = penalty_terms(problem, local_mask, local_prior, dt)
    d_pinv = torch.where(d_pen > 0.0, 1.0 / torch.clamp(d_pen, min=1e-30),
                         torch.zeros_like(d_pen))
    q = pp * pm                                            # [E, P]

    # Unpenalized columns (d_pen == 0): the first u_max per entity, ghost
    # column P (zero in x_ext) where an entity has fewer.
    if u_max > 0:
        zero_d = d_pen <= 0.0                              # [E, P]
        order = torch.argsort((~zero_d).to(torch.int8), dim=1,
                              stable=True)[:, :u_max]
        have = torch.gather(zero_d, 1, order)
        u_idx = torch.where(have, order, torch.full_like(order, p))
        x_u = torch.gather(x_ext, 2, u_idx[:, None, :].expand(e, s, u_max))
    else:
        u_idx = torch.zeros((e, 0), dtype=torch.int64, device=x.device)
        x_u = x.new_zeros((e, s, 0))

    xd = x * d_pinv[:, None, :]                            # X·D⁺  [E,S,P]
    gram = torch.bmm(xd, x.transpose(1, 2))                # G = XD⁺Xᵀ [E,S,S]
    j_mat = torch.cat([gram, x_u], dim=2).contiguous()     # [E, S, T]
    j_t = j_mat.transpose(1, 2)                            # [E, T, S]
    if local_prior is None:
        # q ≡ 0: the θ=0 margins are the offsets and the constant vanishes.
        z0 = off
        c_reg = torch.zeros((e,), dtype=dt, device=x.device)
    else:
        z0 = off + torch.bmm(xd, q[..., None])[..., 0]     # margins at θ=0
        # Primal-objective constant: reg(w(θ)) = ½αᵀGα + c_reg.
        c_reg = 0.5 * torch.sum(pp * pm * pm, dim=1) - 0.5 * torch.sum(
            d_pinv * q * q, dim=1)

    def ga_of(alpha):
        return torch.einsum("est,...et->...es", gram, alpha)

    def value_at(theta, z):
        alpha = theta[:, :s]
        return (torch.sum(tw * loss.loss(z, y), dim=1)
                + 0.5 * torch.sum(alpha * ga_of(alpha), dim=1) + c_reg)

    def grad_at(theta, z):
        d1 = tw * loss.d1(z, y)
        g = torch.bmm(d1[:, None, :], j_mat)[:, 0]
        return torch.cat([g[:, :s] + ga_of(theta[:, :s]), g[:, s:]], dim=1)

    def hess_at(theta, z):
        d2 = tw * loss.d2(z, y)
        h = torch.bmm(j_t, j_mat * d2[..., None])
        h[:, :s, :s] += gram
        return h

    def lin_map(d):
        return torch.bmm(j_mat, d[..., None])[..., 0]

    def probe_values(theta, z, d, zd, ts):
        zt = z[None] + ts[:, None, None] * zd[None]          # [L, E, S]
        alpha_t = theta[None, :, :s] + ts[:, None, None] * d[None, :, :s]
        return (torch.sum(tw[None] * loss.loss(zt, y[None]), dim=2)
                + 0.5 * torch.sum(alpha_t * ga_of(alpha_t), dim=2)
                + c_reg[None])

    theta0 = torch.zeros((e, s + u_max), dtype=dt, device=x.device)
    (theta, z, f, g, reason, _, values, gnorms, passes,
     iters) = _newton_loop(
        theta0, z0, problem.optimizer_config, value_at, grad_at, hess_at,
        # G can be singular along directions outside the row span (w(θ) is
        # unaffected there): a slightly larger ridge damps and picks the
        # min-norm step.
        lin_map, probe_values, ridge=1e-7,
    )

    # Primal coefficients: w = D⁺(Xᵀα + q) + scatter(β at u_idx).
    alpha, beta = theta[:, :s], theta[:, s:]
    w = d_pinv * (torch.bmm(alpha[:, None, :], x)[:, 0] + q)
    if u_max > 0:
        # A lane's real u_idx entries are distinct columns (where w is 0);
        # only its padding entries repeat, all at the dropped column P, so
        # no kept sum depends on the order of the adds.
        w_full = torch.cat([w, w.new_zeros((e, 1))], dim=1)
        w_full.scatter_add_(1, u_idx, beta)
        w = w_full[:, :p]

    # The primal gradient norm for the reported result (θ-space norms steer
    # the loop).
    z_w = off + torch.bmm(x, w[..., None])[..., 0]
    d1 = tw * loss.d1(z_w, y)
    g_primal = torch.bmm(d1[:, None, :], x)[:, 0] + d_pen * w - q

    variances = None
    if problem.variance_type == VarianceComputationType.SIMPLE:
        d2 = tw * loss.d2(z_w, y)
        diag = torch.einsum("es,esp->ep", d2, x * x) + d_pen
        variances = (1.0 / torch.clamp(diag, min=1e-12)).to(w0.dtype)

    w = w.contiguous()
    result = _result(w, f, torch.linalg.vector_norm(g_primal, dim=1), reason,
                     values, gnorms, passes, iters, w0.dtype)
    model = GeneralizedLinearModel(
        Coefficients(means=w.to(w0.dtype), variances=variances), problem.task)
    return model, result


# ------------------------------------------------------- entity sub-batching


def _slice_pad_lanes(a: Tensor, lo: int, hi: int, chunk: int, fill=0) -> Tensor:
    """One [E, ...] per-entity tensor sliced to lanes [lo, hi) and padded
    with ``fill`` to ``chunk`` lanes."""
    a = a[lo:hi]
    pad = chunk - (hi - lo)
    if pad:
        a = torch.cat([a, a.new_full((pad,) + tuple(a.shape[1:]), fill)])
    return a


def _slice_pad_batches(batches: LabeledBatch, lo: int, hi: int,
                       chunk: int) -> LabeledBatch:
    """``batches[lo:hi]`` padded to exactly ``chunk`` lanes. Padding lanes
    are inert by the JAX ``_pad_bucket`` convention: ghost feature columns
    (== local dim, dropped by the dense scatter), value/label/offset 0,
    weight 0."""
    f = batches.features

    def pz(a, fill=0):
        return _slice_pad_lanes(a, lo, hi, chunk, fill)

    return LabeledBatch(
        features=SparseFeatures(idx=pz(f.idx, f.dim), val=pz(f.val), dim=f.dim),
        labels=pz(batches.labels),
        offsets=pz(batches.offsets),
        weights=pz(batches.weights),
    )


def _map_fit(fn, model: GeneralizedLinearModel, result: OptimizerResult):
    """Apply ``fn`` to every per-lane tensor of a bucket fit."""
    c = model.coefficients
    model = GeneralizedLinearModel(
        Coefficients(means=fn(c.means),
                     variances=None if c.variances is None else fn(c.variances)),
        model.task)
    result = OptimizerResult(**{
        k.name: fn(getattr(result, k.name))
        for k in dataclasses.fields(result)})
    return model, result


def fit_bucket_in_chunks(fit_one, chunk: int, batches: LabeledBatch,
                         w0: Tensor, local_mask: Tensor,
                         local_prior: Optional[PriorDistribution],
                         with_lo: bool = False):
    """Solve one bucket in entity chunks of a blessed size and restack.

    ``fit_one(batches, w0, local_mask, local_prior) -> (model, result)``
    closes over the solver and its fixed arguments. Every chunk has exactly
    ``chunk`` lanes; the padded tail carries weight-0 rows, mask 1 (so the
    ridge keeps its Hessians PD) and precision-0 priors, converges at the
    zero model and is sliced away. Each chunk's loop stops when its own
    slowest lane converges. ``with_lo`` passes each chunk's first lane to
    ``fit_one`` as ``lo=``. The bucket's [E, ...] outputs are allocated
    once, after the first chunk, and each chunk is copied into its lanes,
    so the restack never holds a second copy of them: the chunk's own
    working set is what the tier's size moves (the OOM ladder's lever).
    """
    e = w0.shape[0]
    out = None
    for lo in range(0, e, chunk):
        hi = min(lo + chunk, e)
        prior = (
            PriorDistribution(
                means=_slice_pad_lanes(local_prior.means, lo, hi, chunk),
                precisions=_slice_pad_lanes(local_prior.precisions, lo, hi, chunk))
            if local_prior is not None else None
        )
        model, result = fit_one(
            _slice_pad_batches(batches, lo, hi, chunk),
            _slice_pad_lanes(w0, lo, hi, chunk),
            _slice_pad_lanes(local_mask, lo, hi, chunk, fill=1),
            prior,
            **({"lo": lo} if with_lo else {}),
        )
        n = hi - lo
        if n == e:
            return _map_fit(lambda a: a[:n], model, result)
        if out is None:
            out = _map_fit(
                lambda a: a.new_empty((e,) + tuple(a.shape[1:])), model, result)
        _copy_lanes(out, (model, result), lo, hi)
        del model, result
    return out


def _copy_lanes(dst, src, lo: int, hi: int) -> None:
    """Copy lanes [0, hi - lo) of a chunk's fit into lanes [lo, hi) of the
    bucket's outputs, every per-lane tensor."""
    (dm, dr), (sm, sr) = dst, src
    n = hi - lo
    pairs = [(dm.coefficients.means, sm.coefficients.means)]
    if dm.coefficients.variances is not None:
        pairs.append((dm.coefficients.variances, sm.coefficients.variances))
    pairs += [(getattr(dr, k.name), getattr(sr, k.name))
              for k in dataclasses.fields(dr)]
    for d, s in pairs:
        d[lo:hi].copy_(s[:n])
