"""Optimization problems: optimizer + objective + regularization + variances.

Port of ``photon_tpu/functions/problem.py``: ``GLMOptimizationProblem.run``
is the whole solve of one GLM on one batch, with or without a feature
normalization context; ``run_lanes`` solves every lane of a random-effect
bucket at once, the counterpart of ``jax.vmap(problem.run)``. PyTorch runs
eagerly and has no compilation cache to key, so ``fit`` is ``run``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

from photon_tpu_torch.data.batch import LabeledBatch
from photon_tpu_torch.data.normalization import (
    LocalNormalizationContext,
    NormalizationContext,
)
from photon_tpu_torch.functions.objective import GLMObjective
from photon_tpu_torch.functions.prior import PriorDistribution
from photon_tpu_torch.models.coefficients import Coefficients
from photon_tpu_torch.models.glm import GeneralizedLinearModel
from photon_tpu_torch.ops.losses import loss_for_task
from photon_tpu_torch.optim import lanes as lanes_opt
from photon_tpu_torch.optim import (
    LBFGS,
    OWLQN,
    TRON,
    OptimizerConfig,
    OptimizerResult,
    OptimizerType,
    RegularizationContext,
)
from photon_tpu_torch.types import TaskType

Tensor = torch.Tensor


def _active(normalization):
    """The context, or None where there is none or it is the identity."""
    return (normalization if normalization is not None
            and not normalization.is_identity else None)


class VarianceComputationType(enum.Enum):
    """NONE / SIMPLE (1/diag H) / FULL (diag H⁻¹)."""

    NONE = "NONE"
    SIMPLE = "SIMPLE"
    FULL = "FULL"


# FULL variance cap: a 16384² Hessian is ~1 GB in float32, the largest that
# is still plainly a "moderate-D fixed effect".
FULL_VARIANCE_MAX_DIM = 16384


@dataclasses.dataclass(frozen=True)
class GLMOptimizationProblem:
    """Binds task, optimizer choice, regularization and variance mode;
    ``run(batch, w0)`` returns the trained model and the optimizer's
    result."""

    task: TaskType
    optimizer_type: OptimizerType = OptimizerType.LBFGS
    optimizer_config: OptimizerConfig = OptimizerConfig()
    regularization: RegularizationContext = RegularizationContext()
    reg_weight: float = 0.0
    variance_type: VarianceComputationType = VarianceComputationType.NONE
    reg_mask: Optional[Tensor] = None
    # Incremental-training prior.
    prior: Optional[PriorDistribution] = None

    def objective(
        self,
        reg_mask: Optional[Tensor] = None,
        prior: Optional[PriorDistribution] = None,
        reg_weight: Optional[float] = None,
    ) -> GLMObjective:
        rw = self.reg_weight if reg_weight is None else reg_weight
        return GLMObjective(
            loss=loss_for_task(self.task),
            l2_weight=self.regularization.l2_weight(rw),
            reg_mask=self.reg_mask if reg_mask is None else reg_mask,
            prior=self.prior if prior is None else prior,
        )

    def fit(
        self,
        batch: LabeledBatch,
        w0: Tensor,
        reg_mask: Optional[Tensor] = None,
        normalization=None,
        prior: Optional[PriorDistribution] = None,
    ) -> tuple[GeneralizedLinearModel, OptimizerResult]:
        """``run`` (the JAX package's ``fit`` adds only a jit cache) under
        its ``optim.glm_fit`` span: one a solve, closed when the solve
        returns."""
        from photon_tpu_torch.obs import trace_span

        with trace_span("optim.glm_fit", cat="optim", rows=batch.n_rows,
                        dim=batch.dim, optimizer=self.optimizer_type.name):
            return self.run(batch, w0, reg_mask, normalization, prior)

    def run(
        self,
        batch: LabeledBatch,
        w0: Tensor,
        reg_mask: Optional[Tensor] = None,
        normalization: Optional[NormalizationContext] = None,
        prior: Optional[PriorDistribution] = None,
        reg_weight: Optional[float] = None,
    ) -> tuple[GeneralizedLinearModel, OptimizerResult]:
        """Full solve. ``reg_mask`` / ``prior`` / ``reg_weight`` override the
        problem's own.

        With a non-identity ``normalization`` the optimizer runs in the
        transformed feature space (the L2 term applies there) against the
        raw features, on the plain ``optimize`` path, and the model is
        mapped back to the original space."""
        return self._solve(batch, w0, reg_mask, normalization, prior,
                           reg_weight, lanes=False)

    def run_lanes(
        self,
        batch: LabeledBatch,
        w0: Tensor,
        reg_mask: Optional[Tensor] = None,
        normalization: Optional[LocalNormalizationContext] = None,
        prior: Optional[PriorDistribution] = None,
    ) -> tuple[GeneralizedLinearModel, OptimizerResult]:
        """``run`` of every lane of a random-effect bucket at once, as the
        JAX package's ``jax.vmap(problem.run)``: ``batch`` over
        ``LaneFeatures`` (``[E, S]`` rows), ``w0`` / ``reg_mask`` and the
        prior's and the context's leaves ``[E, P]``. The optimizers are the
        masked batched lanes of ``optim/lanes.py``; the result holds
        per-lane tensors."""
        return self._solve(batch, w0, reg_mask, normalization, prior, None,
                           lanes=True)

    def value_and_grad(self, batch: LabeledBatch, reg_mask: Optional[Tensor] = None,
                       normalization=None, prior: Optional[PriorDistribution] = None,
                       reg_weight: Optional[float] = None):
        """The smooth objective the optimizer minimizes, ``w ↦ (value,
        grad)`` (``[D]``, or ``[E, P]`` over lanes; OWL-QN adds the L1
        term). Under a non-identity ``normalization`` it takes the
        transformed-space coefficients: the data term through the
        coefficient map, the L2 term on the transformed coefficients."""
        obj = self.objective(reg_mask, prior, reg_weight)
        norm = _active(normalization)
        if norm is None:
            return obj.bind(batch)
        inner = norm.wrap_value_and_grad(
            dataclasses.replace(obj, l2_weight=0.0).bind(batch))

        def vg(wp: Tensor) -> tuple[Tensor, Tensor]:
            v, g = inner(wp)
            lam = obj._l2_vec(wp)
            return v + 0.5 * torch.sum(lam * wp * wp, dim=-1), g + lam * wp

        return vg

    def _solve(self, batch, w0, reg_mask, normalization, prior, reg_weight,
               lanes: bool):
        obj = self.objective(reg_mask, prior, reg_weight)
        rw = self.reg_weight if reg_weight is None else reg_weight
        norm = _active(normalization)
        vg = self.value_and_grad(batch, reg_mask, norm, prior, reg_weight)
        if norm is not None:
            w0 = norm.coef_to_transformed(w0)
        # L1 (and the L1 part of elastic net) is only handled by OWL-QN;
        # pairing it with a smooth optimizer would silently train
        # unregularized.
        if (
            self.optimizer_type != OptimizerType.OWLQN
            and self.regularization.l1_weight(rw) > 0.0
        ):
            raise ValueError(
                f"{self.regularization.reg_type.name} regularization requires "
                f"OptimizerType.OWLQN, got {self.optimizer_type.name}"
            )

        cfg = self.optimizer_config
        if self.optimizer_type == OptimizerType.LBFGS:
            if norm is None:
                # Incremental-score path: one matvec + one rmatvec per
                # iteration.
                so = obj.score_space(batch)
                result = (lanes_opt.lbfgs_scored(cfg, so, w0) if lanes
                          else LBFGS(cfg).optimize_scored(so, w0))
            else:
                result = (lanes_opt.lbfgs(cfg, vg, w0) if lanes
                          else LBFGS(cfg).optimize(vg, w0))
        elif self.optimizer_type == OptimizerType.OWLQN:
            l1 = self.regularization.l1_weight(rw)
            mask = obj.reg_mask if obj.reg_mask is not None else torch.ones_like(w0)
            l1w = l1 * mask.to(w0.dtype)
            result = (lanes_opt.owlqn(cfg, vg, w0, l1w) if lanes
                      else OWLQN(cfg).optimize(vg, w0, l1w))
        elif self.optimizer_type == OptimizerType.TRON:
            if norm is None:
                hvp_at = obj.bind_hvp_at(batch)
            else:
                data_obj = dataclasses.replace(obj, l2_weight=0.0)
                inner_at = norm.wrap_hvp_at(data_obj.bind_hvp_at(batch))

                def hvp_at(wp: Tensor):
                    hv = inner_at(wp)
                    return lambda vp: hv(vp) + obj._l2_vec(vp) * vp

            result = (lanes_opt.tron(cfg, vg, w0, hvp_at) if lanes
                      else TRON(cfg).optimize(vg, w0, hvp_at))
        else:  # pragma: no cover - enum is closed
            raise ValueError(f"unknown optimizer {self.optimizer_type}")

        x = result.x if norm is None else norm.coef_to_original(result.x)
        # Variances of the original-space coefficients, from the curvature
        # of the objective actually minimized.
        variances = self._variances(obj, x, batch, norm)
        model = GeneralizedLinearModel(
            Coefficients(means=x, variances=variances), self.task)
        return model, result

    def _variances(self, obj: GLMObjective, w: Tensor, batch: LabeledBatch,
                   norm=None, curvature=None) -> Optional[Tensor]:
        """NONE, SIMPLE (1 / diag H) or FULL (diag H⁻¹) at ``w`` (``[D]``,
        or ``[E, P]`` over lanes). Under normalization the trained L2 term
        λ‖w'‖² is λ/f² per original-space coefficient, and that effective
        penalty enters the curvature. ``curvature`` = ``(hessian_diagonal,
        hvp_at)`` of the objective without its L2 term (default: ``obj``'s
        over ``batch``; the sharded objective passes its folded ones)."""
        if self.variance_type == VarianceComputationType.NONE:
            return None
        if curvature is None:
            data_obj = dataclasses.replace(obj, l2_weight=0.0)
            curvature = (lambda x: data_obj.hessian_diagonal(x, batch),
                         data_obj.bind_hvp_at(batch))
        hess_diag, hvp_at = curvature
        lam = obj._l2_vec(w)
        if norm is not None and norm.factors is not None:
            f, _ = norm._effective()
            lam = lam / (f * f)
        if self.variance_type == VarianceComputationType.SIMPLE:
            diag = hess_diag(w) + lam
            return 1.0 / torch.clamp(diag, min=1e-12)
        # FULL: H column by column through H·v products, then invert. Only
        # for moderate D: refuse a Hessian that could not fit.
        d = int(w.shape[-1])
        if d > FULL_VARIANCE_MAX_DIM:
            itemsize = w.element_size()
            name = str(w.dtype).replace("torch.", "")
            raise ValueError(
                f"FULL variance materializes a {d}x{d} Hessian "
                f"({d * d * itemsize / 1e9:.1f} GB at {name}), "
                f"over the {FULL_VARIANCE_MAX_DIM}-feature cap; use "
                "VarianceComputationType.SIMPLE for wide models"
            )
        eye = torch.eye(d, dtype=w.dtype, device=w.device)
        hv = hvp_at(w)
        # h[..., i, :] = H·e_i (every lane at once over lanes)
        h = torch.stack([hv(eye[i].expand_as(w).contiguous()) for i in range(d)],
                        dim=-2)
        h = 0.5 * (h + h.mT) + torch.diag_embed(lam)
        return torch.diagonal(torch.linalg.inv(h + 1e-12 * eye),
                              dim1=-2, dim2=-1).contiguous()
