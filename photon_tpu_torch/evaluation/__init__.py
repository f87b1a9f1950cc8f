"""Evaluation: metric functions and the evaluator / suite API (port of
``photon_tpu/evaluation``)."""
from photon_tpu_torch.evaluation.evaluator import (  # noqa: F401
    EvaluationResults,
    EvaluationSuite,
    Evaluator,
    parse_evaluator,
)
from photon_tpu_torch.evaluation.metrics import (  # noqa: F401
    auc,
    grouped_auc,
    grouped_pointwise,
    grouped_precision_at_k,
    logistic_loss,
    poisson_loss,
    rmse,
    smoothed_hinge_loss,
    squared_loss,
)
