"""Model diagnostics for the single-GLM training driver.

Port of ``photon_tpu/diagnostics/``: bootstrap confidence intervals (the
replicates solved as masked batched lanes of ``optim/lanes.py``), the
Hosmer–Lemeshow calibration test (bins and sums on the scores' device),
feature importance and the HTML / JSON fit report.
"""
from photon_tpu_torch.diagnostics.bootstrap import (
    BootstrapResult,
    bootstrap_coefficients,
)
from photon_tpu_torch.diagnostics.hosmer_lemeshow import (
    HosmerLemeshowResult,
    hosmer_lemeshow,
)
from photon_tpu_torch.diagnostics.importance import (
    FeatureImportance,
    feature_importance,
)
from photon_tpu_torch.diagnostics.report import write_fit_report

__all__ = [
    "BootstrapResult",
    "bootstrap_coefficients",
    "HosmerLemeshowResult",
    "hosmer_lemeshow",
    "FeatureImportance",
    "feature_importance",
    "write_fit_report",
]
