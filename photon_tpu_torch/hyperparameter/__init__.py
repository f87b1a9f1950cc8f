"""Hyperparameter tuning — reference ⟦photon-lib/.../hyperparameter⟧
(SURVEY.md §1 H, §2.1): GP surrogate (Matérn-5/2 / RBF), Expected
Improvement, slice-sampled GP hyperparameters, random search, range
rescaling/serialization, and the GAME reg-weight tuner.

Port of ``photon_tpu/hyperparameter``: the search modules are copies
(numpy and scipy); ``tuner.py`` trains each trial with the port's
``GameEstimator``."""
from photon_tpu_torch.hyperparameter.acquisition import expected_improvement
from photon_tpu_torch.hyperparameter.gp import (
    GaussianProcessEstimator,
    GaussianProcessModel,
    predict_mean_var,
)
from photon_tpu_torch.hyperparameter.kernels import KERNELS, Matern52, RBF
from photon_tpu_torch.hyperparameter.rescaling import (
    ParamRange,
    VectorRescaling,
    ranges_from_json,
    ranges_to_json,
)
from photon_tpu_torch.hyperparameter.search import (
    GaussianProcessSearch,
    RandomSearch,
    SearchResult,
)
from photon_tpu_torch.hyperparameter.slice_sampler import SliceSampler
from photon_tpu_torch.hyperparameter.tuner import TuningResult, tune_regularization

__all__ = [
    "expected_improvement",
    "GaussianProcessEstimator",
    "GaussianProcessModel",
    "predict_mean_var",
    "KERNELS",
    "Matern52",
    "RBF",
    "ParamRange",
    "VectorRescaling",
    "ranges_from_json",
    "ranges_to_json",
    "GaussianProcessSearch",
    "RandomSearch",
    "SearchResult",
    "SliceSampler",
    "TuningResult",
    "tune_regularization",
]
