"""GLM objective over a batch: value, gradient, H·v, Hessian diagonal.

Port of ``photon_tpu/functions/objective.py``. Conventions as there:
  * total loss = Σᵢ wᵢ ℓ(zᵢ, yᵢ) with zᵢ = xᵢᵀβ + offsetᵢ (no 1/N scaling),
  * L2 term = λ/2 ‖β_masked‖², the mask excluding the intercept,
  * L1 is never part of the smooth objective (OWL-QN handles it).

Every derivative is written out by hand (the JAX package's are too), so each
method's data passes are explicit: ``value_and_grad`` is one matvec and one
rmatvec, ``hessian_vector`` two matvecs and one rmatvec, and the H·v of
``bind_hvp_at`` two passes, its margins computed once per point. On CUDA the
passes are the kernels of ``ops/cuda_sparse.py`` (see ``data/batch.py``);
the rest is elementwise torch on the batch's device.

Every sum runs over the last axis, so the same objective serves a batch of
random-effect lanes: over ``LaneFeatures`` (``data/batch.py``) the
coefficients are ``[E, P]``, the rows ``[E, S]`` and each value ``[E]``, one
per lane, with ``reg_mask`` and the prior's leaves ``[E, P]``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from photon_tpu_torch.data.batch import LabeledBatch
from photon_tpu_torch.functions.prior import PriorDistribution
from photon_tpu_torch.ops.losses import PointwiseLoss

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GLMObjective:
    """Smooth GLM objective bound to a loss; the batch is passed per call.

    ``reg_mask`` (None = all ones) is a per-coefficient L2 penalty weight
    (0 on the intercept). ``prior`` adds a Gaussian prior's terms.
    """

    loss: PointwiseLoss
    l2_weight: float = 0.0
    reg_mask: Optional[Tensor] = None
    prior: Optional[PriorDistribution] = None

    def _l2_vec(self, like: Tensor) -> Tensor:
        """Per-coefficient L2 penalty λᵢ = λ·maskᵢ."""
        if self.reg_mask is None:
            return torch.full_like(like, self.l2_weight)
        return self.l2_weight * self.reg_mask.to(like.dtype)

    def value(self, w: Tensor, batch: LabeledBatch) -> Tensor:
        z = batch.features.matvec(w) + batch.offsets
        out = torch.sum(batch.weights * self.loss.loss(z, batch.labels), dim=-1)
        out = out + 0.5 * torch.sum(self._l2_vec(w) * w * w, dim=-1)
        if self.prior is not None:
            out = out + self.prior.value(w)
        return out

    def value_and_grad(self, w: Tensor, batch: LabeledBatch) -> tuple[Tensor, Tensor]:
        """One matvec and one rmatvec: z → (ℓ, dℓ/dz) → Xᵀ(w·dz) + L2
        terms."""
        z = batch.features.matvec(w) + batch.offsets
        lv = torch.sum(batch.weights * self.loss.loss(z, batch.labels), dim=-1)
        dz = batch.weights * self.loss.d1(z, batch.labels)
        g = batch.features.rmatvec(dz)
        lam = self._l2_vec(w)
        lv = lv + 0.5 * torch.sum(lam * w * w, dim=-1)
        g = g + lam * w
        if self.prior is not None:
            lv = lv + self.prior.value(w)
            g = g + self.prior.gradient(w)
        return lv, g

    def hessian_vector(self, w: Tensor, v: Tensor, batch: LabeledBatch) -> Tensor:
        """H·v = Xᵀ(diag(w·d2)·Xv) + λ·v_masked."""
        z = batch.features.matvec(w) + batch.offsets
        d2 = batch.weights * self.loss.d2(z, batch.labels)
        hv = batch.features.rmatvec(d2 * batch.features.matvec(v))
        hv = hv + self._l2_vec(v) * v
        if self.prior is not None:
            hv = hv + self.prior.hessian_vector(v)
        return hv

    def hessian_diagonal(self, w: Tensor, batch: LabeledBatch) -> Tensor:
        """diag(H) = Σᵢ wᵢ d2ᵢ xᵢⱼ² + λ·mask: one matvec, one sq_rmatvec."""
        z = batch.features.matvec(w) + batch.offsets
        d2 = batch.weights * self.loss.d2(z, batch.labels)
        diag = batch.features.sq_rmatvec(d2)
        diag = diag + self._l2_vec(w)
        if self.prior is not None:
            diag = diag + self.prior.hessian_diagonal()
        return diag

    # -- score-space interface (incremental-z optimizers) --------------------

    def value_from_scores(self, z: Tensor, w: Tensor, batch: LabeledBatch) -> Tensor:
        """Objective value given margins z = Xw + offsets: no data pass."""
        lv = torch.sum(batch.weights * self.loss.loss(z, batch.labels), dim=-1)
        lv = lv + 0.5 * torch.sum(self._l2_vec(w) * w * w, dim=-1)
        if self.prior is not None:
            lv = lv + self.prior.value(w)
        return lv

    def grad_from_scores(self, z: Tensor, w: Tensor, batch: LabeledBatch) -> Tensor:
        """Gradient given margins: exactly one rmatvec."""
        dz = batch.weights * self.loss.d1(z, batch.labels)
        g = batch.features.rmatvec(dz) + self._l2_vec(w) * w
        if self.prior is not None:
            g = g + self.prior.gradient(w)
        return g

    def score_space(self, batch: LabeledBatch) -> "ScoreSpaceObjective":
        """Bundle of score-space callables for ``LBFGS.optimize_scored``."""
        return ScoreSpaceObjective(
            score=lambda w: batch.features.matvec(w) + batch.offsets,
            score_delta=lambda p: batch.features.matvec(p),
            value_from_scores=lambda z, w: self.value_from_scores(z, w, batch),
            grad_from_scores=lambda z, w: self.grad_from_scores(z, w, batch),
        )

    # -- closures for the optimizers -----------------------------------------

    def bind(self, batch: LabeledBatch) -> Callable[[Tensor], tuple[Tensor, Tensor]]:
        """``w ↦ (value, grad)`` for ``Optimizer.optimize``."""
        return lambda w: self.value_and_grad(w, batch)

    def bind_hvp_at(
        self, batch: LabeledBatch
    ) -> Callable[[Tensor], Callable[[Tensor], Tensor]]:
        """``w ↦ (v ↦ H(w)·v)`` with the margins z and the curvature d2
        computed ONCE at w (1 pass), so that each H·v inside TRON's CG loop
        costs exactly 2 passes (Xv matvec + rmatvec)."""

        def at(w: Tensor) -> Callable[[Tensor], Tensor]:
            z = batch.features.matvec(w) + batch.offsets
            d2 = batch.weights * self.loss.d2(z, batch.labels)

            def hv(v: Tensor) -> Tensor:
                out = batch.features.rmatvec(d2 * batch.features.matvec(v))
                out = out + self._l2_vec(v) * v
                if self.prior is not None:
                    out = out + self.prior.hessian_vector(v)
                return out

            return hv

        return at


@dataclasses.dataclass(frozen=True)
class ScoreSpaceObjective:
    """Callables an incremental-score optimizer needs: line-search probes
    are elementwise over z, and a full iteration is 1 matvec + 1 rmatvec."""

    score: Callable[[Tensor], Tensor]               # w ↦ z = Xw + offsets
    score_delta: Callable[[Tensor], Tensor]         # p ↦ Xp  (no offsets)
    value_from_scores: Callable[[Tensor, Tensor], Tensor]   # (z, w) ↦ f
    grad_from_scores: Callable[[Tensor, Tensor], Tensor]    # (z, w) ↦ ∇f


def intercept_reg_mask(
    dim: int, intercept_index: Optional[int],
    device: Optional[torch.device] = None,
) -> Optional[Tensor]:
    """float32 1s everywhere except the intercept column, on ``device``."""
    if intercept_index is None:
        return None
    mask = torch.ones(dim, dtype=torch.float32, device=device)
    mask[intercept_index] = 0.0
    return mask
