"""Optimization problems: optimizer + objective + regularization + variances.

Port of ``photon_tpu/functions/problem.py`` without feature normalization
(a later slice): ``GLMOptimizationProblem.run`` is the whole solve of one
GLM on one batch. PyTorch runs eagerly and has no compilation cache to key,
so ``fit`` is ``run``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

from photon_tpu_torch.data.batch import LabeledBatch
from photon_tpu_torch.functions.objective import GLMObjective
from photon_tpu_torch.functions.prior import PriorDistribution
from photon_tpu_torch.models.coefficients import Coefficients
from photon_tpu_torch.models.glm import GeneralizedLinearModel
from photon_tpu_torch.ops.losses import loss_for_task
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
        """``run`` (the JAX package's ``fit`` adds only a jit cache)."""
        return self.run(batch, w0, reg_mask, normalization, prior)

    def run(
        self,
        batch: LabeledBatch,
        w0: Tensor,
        reg_mask: Optional[Tensor] = None,
        normalization=None,
        prior: Optional[PriorDistribution] = None,
        reg_weight: Optional[float] = None,
    ) -> tuple[GeneralizedLinearModel, OptimizerResult]:
        """Full solve. ``reg_mask`` / ``prior`` / ``reg_weight`` override the
        problem's own. ``normalization`` must be None: feature
        normalization comes with a later slice of the port."""
        if normalization is not None:
            raise NotImplementedError(
                "feature normalization is not in the port yet (it comes with "
                "the data-preparation slice, M8)"
            )
        obj = self.objective(reg_mask, prior, reg_weight)
        rw = self.reg_weight if reg_weight is None else reg_weight
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

        if self.optimizer_type == OptimizerType.LBFGS:
            # Incremental-score path: one matvec + one rmatvec per iteration.
            result = LBFGS(self.optimizer_config).optimize_scored(
                obj.score_space(batch), w0)
        elif self.optimizer_type == OptimizerType.OWLQN:
            l1 = self.regularization.l1_weight(rw)
            mask = obj.reg_mask if obj.reg_mask is not None else torch.ones_like(w0)
            result = OWLQN(self.optimizer_config).optimize(
                obj.bind(batch), w0, (l1 * mask.to(w0.dtype)))
        elif self.optimizer_type == OptimizerType.TRON:
            result = TRON(self.optimizer_config).optimize(
                obj.bind(batch), w0, obj.bind_hvp_at(batch))
        else:  # pragma: no cover - enum is closed
            raise ValueError(f"unknown optimizer {self.optimizer_type}")

        variances = self._variances(obj, result.x, batch)
        model = GeneralizedLinearModel(
            Coefficients(means=result.x, variances=variances), self.task)
        return model, result

    def _variances(self, obj: GLMObjective, w: Tensor,
                   batch: LabeledBatch) -> Optional[Tensor]:
        if self.variance_type == VarianceComputationType.NONE:
            return None
        data_obj = dataclasses.replace(obj, l2_weight=0.0)
        lam = obj._l2_vec(w)
        if self.variance_type == VarianceComputationType.SIMPLE:
            diag = data_obj.hessian_diagonal(w, batch) + lam
            return 1.0 / torch.clamp(diag, min=1e-12)
        # FULL: H column by column through H·v products, then invert. Only
        # for moderate D: refuse a Hessian that could not fit.
        d = int(w.shape[0])
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
        hv = data_obj.bind_hvp_at(batch)(w)
        h = torch.stack([hv(eye[i]) for i in range(d)])
        h = 0.5 * (h + h.T) + torch.diag(lam)
        return torch.diagonal(torch.linalg.inv(h + 1e-12 * eye)).contiguous()
