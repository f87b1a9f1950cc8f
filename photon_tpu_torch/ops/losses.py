"""Pointwise GLM losses as functions of the margin.

Port of ``photon_tpu/ops/losses.py``. Each loss gives, for the margin
z = wᵀx (+ offset) and the label y, the per-example ``loss(z, y)``, its
first and second margin derivatives ``d1`` / ``d2`` and the inverse link
``mean(z)``. They are elementwise torch functions of tensors on any device,
in the same overflow-safe forms as the JAX package: softplus as
``logaddexp(z, 0)`` (exact at every z, where ``torch.nn.functional.softplus``
switches to z above its threshold), the smoothed hinge piecewise. The Poisson
loss is exp(z) and overflows for z ≳ 88 in float32 (≳ 709 in float64).
Labels: {0, 1} for logistic and smoothed hinge, reals for linear, counts ≥ 0
for Poisson.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from photon_tpu_torch.types import TaskType

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PointwiseLoss:
    """A pointwise loss ℓ(z, y) with first and second margin-derivatives and
    the GLM's mean function."""

    name: str
    loss: Callable[[Tensor, Tensor], Tensor]
    d1: Callable[[Tensor, Tensor], Tensor]
    d2: Callable[[Tensor, Tensor], Tensor]
    mean: Callable[[Tensor], Tensor]


# Logistic: ℓ = log(1 + e^z) − y·z ; ℓ' = σ(z) − y ; ℓ'' = σ(z)(1 − σ(z)).

def _logistic_loss(z: Tensor, y: Tensor) -> Tensor:
    return torch.logaddexp(z, torch.zeros_like(z)) - y * z


def _logistic_d2(z: Tensor, y: Tensor) -> Tensor:
    s = torch.sigmoid(z)
    return s * (1.0 - s)


LogisticLoss = PointwiseLoss(
    name="logistic",
    loss=_logistic_loss,
    d1=lambda z, y: torch.sigmoid(z) - y,
    d2=_logistic_d2,
    mean=torch.sigmoid,
)


# Squared: ℓ = ½(z − y)².

def _squared_loss(z: Tensor, y: Tensor) -> Tensor:
    d = z - y
    return 0.5 * d * d


SquaredLoss = PointwiseLoss(
    name="squared",
    loss=_squared_loss,
    d1=lambda z, y: z - y,
    d2=lambda z, y: torch.ones_like(z),
    mean=lambda z: z,
)


# Poisson (negative log-likelihood up to a constant): ℓ = e^z − y·z.

PoissonLoss = PointwiseLoss(
    name="poisson",
    loss=lambda z, y: torch.exp(z) - y * z,
    d1=lambda z, y: torch.exp(z) - y,
    d2=lambda z, y: torch.exp(z),
    mean=torch.exp,
)


# Smoothed hinge (Rennie & Srebro 2005), s = 2y − 1, t = s·z:
#   ℓ = ½ − t (t ≤ 0);  ½(1 − t)² (0 < t < 1);  0 (t ≥ 1).
# d2 is the a.e. second derivative (1 on 0 < t < 1).

def _smoothed_hinge_loss(z: Tensor, y: Tensor) -> Tensor:
    t = (2.0 * y - 1.0) * z
    zero = torch.zeros_like(t)
    return torch.where(t <= 0.0, 0.5 - t,
                       torch.where(t < 1.0, 0.5 * (1.0 - t) ** 2, zero))


def _smoothed_hinge_d1(z: Tensor, y: Tensor) -> Tensor:
    s = 2.0 * y - 1.0
    t = s * z
    dt = torch.where(t <= 0.0, -torch.ones_like(t),
                     torch.where(t < 1.0, t - 1.0, torch.zeros_like(t)))
    return s * dt


def _smoothed_hinge_d2(z: Tensor, y: Tensor) -> Tensor:
    t = (2.0 * y - 1.0) * z
    return ((t > 0.0) & (t < 1.0)).to(z.dtype)


SmoothedHingeLoss = PointwiseLoss(
    name="smoothed_hinge",
    loss=_smoothed_hinge_loss,
    d1=_smoothed_hinge_d1,
    d2=_smoothed_hinge_d2,
    mean=lambda z: z,
)


_BY_NAME = {
    "logistic": LogisticLoss,
    "squared": SquaredLoss,
    "poisson": PoissonLoss,
    "smoothed_hinge": SmoothedHingeLoss,
}

_BY_TASK = {
    TaskType.LOGISTIC_REGRESSION: LogisticLoss,
    TaskType.LINEAR_REGRESSION: SquaredLoss,
    TaskType.POISSON_REGRESSION: PoissonLoss,
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: SmoothedHingeLoss,
}


def loss_for_task(task: TaskType) -> PointwiseLoss:
    """The pointwise loss of a task type."""
    return _BY_TASK[task]


def get_loss(name: str) -> PointwiseLoss:
    return _BY_NAME[name]
