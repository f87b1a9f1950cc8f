"""Core type aliases and task enumeration.

Port of ``photon_tpu/types.py`` (the task enumeration; the TPU backend
allowlist has no counterpart here).
"""
from __future__ import annotations

import enum

class TaskType(enum.Enum):
    """Training objective family: LOGISTIC_REGRESSION, LINEAR_REGRESSION,
    POISSON_REGRESSION, SMOOTHED_HINGE_LOSS_LINEAR_SVM."""

    LOGISTIC_REGRESSION = "LOGISTIC_REGRESSION"
    LINEAR_REGRESSION = "LINEAR_REGRESSION"
    POISSON_REGRESSION = "POISSON_REGRESSION"
    SMOOTHED_HINGE_LOSS_LINEAR_SVM = "SMOOTHED_HINGE_LOSS_LINEAR_SVM"

    @classmethod
    def parse(cls, s: str) -> "TaskType":
        key = s.strip().upper()
        aliases = {
            "LOGISTIC": cls.LOGISTIC_REGRESSION,
            "LINEAR": cls.LINEAR_REGRESSION,
            "POISSON": cls.POISSON_REGRESSION,
            "SVM": cls.SMOOTHED_HINGE_LOSS_LINEAR_SVM,
            "SMOOTHED_HINGE": cls.SMOOTHED_HINGE_LOSS_LINEAR_SVM,
        }
        if key in aliases:
            return aliases[key]
        return cls(key)
