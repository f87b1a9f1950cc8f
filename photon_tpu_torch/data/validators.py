"""Pre-training data sanity checks.

Port of ``photon_tpu/data/validators.py``: finite features, offsets and
weights, and the task's label checks (binary for logistic and smoothed-hinge
SVM, finite for linear, non-negative for Poisson), in VALIDATE_FULL,
VALIDATE_SAMPLE or VALIDATE_DISABLED mode. The checks are reductions over
the batch's tensors on its device; only the vector of violation counts
comes to the host, and a failure raises ``DataValidationError`` listing
every failed check. Rows of weight 0 (padding) are skipped; SAMPLE mode
checks the first ``sample_rows`` rows.
"""
from __future__ import annotations

import enum

import torch

from photon_tpu_torch.data.batch import LabeledBatch
from photon_tpu_torch.types import TaskType

# Rows checked under VALIDATE_SAMPLE.
SAMPLE_ROWS_DEFAULT = 1024


class DataValidationType(enum.Enum):
    VALIDATE_FULL = "VALIDATE_FULL"
    VALIDATE_SAMPLE = "VALIDATE_SAMPLE"
    VALIDATE_DISABLED = "VALIDATE_DISABLED"


class DataValidationError(ValueError):
    """Raised with the complete list of failed checks."""

    def __init__(self, failures: list[str]):
        self.failures = failures
        super().__init__("data validation failed: " + "; ".join(failures))


_CHECKS = (
    "features are not all finite",
    "offsets are not all finite",
    "weights are not all finite and non-negative",
    "labels are not all finite",
    "labels are not all binary (0/1) as required by the task",
    "labels are not all non-negative as required by Poisson regression",
)

_BINARY_TASKS = (TaskType.LOGISTIC_REGRESSION,
                 TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM)


def _violation_counts(val: torch.Tensor, labels: torch.Tensor,
                      offsets: torch.Tensor, weights: torch.Tensor,
                      task: TaskType) -> list[int]:
    mask = weights != 0

    def count(bad: torch.Tensor) -> torch.Tensor:
        return torch.sum(bad & mask)

    zero = torch.zeros((), dtype=torch.int64, device=labels.device)
    counts = torch.stack([
        count(~torch.all(torch.isfinite(val), dim=-1)),
        count(~torch.isfinite(offsets)),
        torch.sum(~torch.isfinite(weights) | (weights < 0)),
        count(~torch.isfinite(labels)),
        count((labels != 0) & (labels != 1)) if task in _BINARY_TASKS else zero,
        count(labels < 0) if task == TaskType.POISSON_REGRESSION else zero,
    ])
    return counts.tolist()


def sanity_check_data(
    batch: LabeledBatch,
    task: TaskType,
    validation_type: DataValidationType = DataValidationType.VALIDATE_FULL,
    sample_rows: int = SAMPLE_ROWS_DEFAULT,
) -> None:
    """Run every applicable check and raise ``DataValidationError`` once
    with the full list of failures."""
    if validation_type == DataValidationType.VALIDATE_DISABLED:
        return
    n = batch.n_rows
    if validation_type == DataValidationType.VALIDATE_SAMPLE:
        n = min(sample_rows, n)
    counts = _violation_counts(batch.features.val[:n], batch.labels[:n],
                               batch.offsets[:n], batch.weights[:n], task)
    failures = [f"{msg} ({c} rows)" for msg, c in zip(_CHECKS, counts) if c > 0]
    if failures:
        raise DataValidationError(failures)
