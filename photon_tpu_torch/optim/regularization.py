"""Regularization configuration.

Port of ``photon_tpu/optim/regularization.py`` (a copy: that module loads no
jax, but the port imports nothing of the JAX package). Reference
⟦photon-lib/.../optimization/RegularizationContext.scala⟧ —
NONE / L1 / L2 / ELASTIC_NET with an elastic-net mixing weight α splitting a
single regularization weight λ into λ·α (L1) and λ·(1−α) (L2).

The L2 part is added analytically to value/gradient/Hessian by the objective
(reference ⟦L2RegularizationDiff/TwiceDiff⟧ stackable traits); the L1 part is
handled by OWL-QN's pseudo-gradient — never by smooth differentiation.

A ``reg_mask`` (1.0 for regularized coefficients, 0.0 for the intercept)
reproduces the reference convention that the intercept is never regularized.
"""
from __future__ import annotations

import dataclasses
import enum


class RegularizationType(enum.Enum):
    NONE = "NONE"
    L1 = "L1"
    L2 = "L2"
    ELASTIC_NET = "ELASTIC_NET"


@dataclasses.dataclass(frozen=True)
class RegularizationContext:
    reg_type: RegularizationType = RegularizationType.NONE
    # Elastic-net mixing: fraction of the weight that is L1.
    elastic_net_alpha: float = 0.0

    def l1_weight(self, reg_weight: float) -> float:
        if self.reg_type == RegularizationType.L1:
            return reg_weight
        if self.reg_type == RegularizationType.ELASTIC_NET:
            return reg_weight * self.elastic_net_alpha
        return 0.0

    def l2_weight(self, reg_weight: float) -> float:
        if self.reg_type == RegularizationType.L2:
            return reg_weight
        if self.reg_type == RegularizationType.ELASTIC_NET:
            return reg_weight * (1.0 - self.elastic_net_alpha)
        return 0.0


NoRegularizationContext = RegularizationContext(RegularizationType.NONE)
L1RegularizationContext = RegularizationContext(RegularizationType.L1)
L2RegularizationContext = RegularizationContext(RegularizationType.L2)


def elastic_net_context(alpha: float) -> RegularizationContext:
    return RegularizationContext(RegularizationType.ELASTIC_NET, alpha)
