"""Core optimizers: L-BFGS, OWL-QN, TRON.

Port of ``photon_tpu/optim/__init__.py``. ``OptimizerType`` matches the
reference's optimizer dispatch in ⟦GLMOptimizationConfiguration⟧.
"""
from __future__ import annotations

import enum

from photon_tpu_torch.optim.base import (
    CONVERGENCE_REASON_NAMES,
    FUNCTION_VALUES_CONVERGED,
    GRADIENT_CONVERGED,
    MAX_ITERATIONS,
    NOT_CONVERGED,
    Optimizer,
    OptimizerConfig,
    OptimizerResult,
)
from photon_tpu_torch.optim.lbfgs import LBFGS
from photon_tpu_torch.optim.owlqn import OWLQN
from photon_tpu_torch.optim.regularization import (
    L1RegularizationContext,
    L2RegularizationContext,
    NoRegularizationContext,
    RegularizationContext,
    RegularizationType,
    elastic_net_context,
)
from photon_tpu_torch.optim.tron import TRON


class OptimizerType(enum.Enum):
    LBFGS = "LBFGS"
    OWLQN = "OWLQN"
    TRON = "TRON"


def make_optimizer(opt_type: OptimizerType, config: OptimizerConfig) -> Optimizer:
    return {
        OptimizerType.LBFGS: LBFGS,
        OptimizerType.OWLQN: OWLQN,
        OptimizerType.TRON: TRON,
    }[opt_type](config)


__all__ = [
    "LBFGS", "OWLQN", "TRON", "Optimizer", "OptimizerConfig",
    "OptimizerResult", "OptimizerType", "make_optimizer",
    "RegularizationContext", "RegularizationType",
    "NoRegularizationContext", "L1RegularizationContext",
    "L2RegularizationContext", "elastic_net_context",
    "NOT_CONVERGED", "MAX_ITERATIONS", "FUNCTION_VALUES_CONVERGED",
    "GRADIENT_CONVERGED", "CONVERGENCE_REASON_NAMES",
]
