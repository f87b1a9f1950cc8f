"""The single-GLM driver's diagnostics (``photon_tpu_torch/diagnostics/``)
against the JAX package's, on the same numpy inputs in float64.

Tolerances: bootstrap replicate coefficients within 1e-8 (each replicate a
float64 L-BFGS solve, lanes against ``jax.vmap``; equal convergence flags),
so the percentile intervals within 1e-8 too; the Hosmer–Lemeshow bins, the
statistic and its p-value within 1e-10 relative; feature importance: the
same ranking, scores within 1e-12 relative; the report's JSON equal.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu.data.batch import LabeledBatch as JaxBatch
from photon_tpu.data.batch import SparseFeatures as JaxSparse
from photon_tpu.data.normalization import NormalizationType as JaxNormType
from photon_tpu.data.normalization import context_from_statistics as jax_context
from photon_tpu.data.statistics import compute_feature_statistics as jax_stats
from photon_tpu.diagnostics import bootstrap_coefficients as jax_bootstrap
from photon_tpu.diagnostics import feature_importance as jax_importance
from photon_tpu.diagnostics import hosmer_lemeshow as jax_hl
from photon_tpu.diagnostics import write_fit_report as jax_report
from photon_tpu.functions.problem import GLMOptimizationProblem as JaxProblem
from photon_tpu.optim import OptimizerConfig as JaxConfig
from photon_tpu.optim import RegularizationContext as JaxReg
from photon_tpu.optim import RegularizationType as JaxRegType
from photon_tpu.types import TaskType as JaxTask
from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures
from photon_tpu_torch.data.normalization import NormalizationType, context_from_statistics
from photon_tpu_torch.data.statistics import compute_feature_statistics
from photon_tpu_torch.diagnostics import (
    bootstrap_coefficients,
    feature_importance,
    hosmer_lemeshow,
    write_fit_report,
)
from photon_tpu_torch.functions.problem import GLMOptimizationProblem
from photon_tpu_torch.optim import OptimizerConfig
from photon_tpu_torch.optim.regularization import RegularizationContext, RegularizationType
from photon_tpu_torch.types import TaskType

D = 12


@pytest.fixture(scope="module")
def data():
    """Logistic data with an intercept column (D - 1) in every row."""
    rng = np.random.default_rng(42)
    n, k = 180, 4
    idx = rng.integers(0, D - 1, size=(n, k)).astype(np.int32)
    idx[:, -1] = D - 1
    val = rng.normal(size=(n, k)) * 1.5 + 0.3
    val[:, -1] = 1.0
    w_true = rng.normal(size=D)
    z = (val * w_true[idx]).sum(1)
    labels = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    weights = np.where(rng.random(n) < 0.1, 2.0, 1.0)
    return idx, val, labels, weights


def _port_batch(idx, val, labels, weights):
    n = len(labels)
    return LabeledBatch(SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), D),
                        torch.from_numpy(labels), torch.zeros(n, dtype=torch.float64),
                        torch.from_numpy(weights))


def _jax_batch(idx, val, labels, weights):
    return JaxBatch(JaxSparse(jnp.asarray(idx), jnp.asarray(val), D), jnp.asarray(labels),
                    jnp.zeros(len(labels), jnp.float64), jnp.asarray(weights))


@pytest.mark.parametrize("normalized", [False, True], ids=["plain", "standardized"])
def test_bootstrap_matches_jax(data, normalized):
    pb, jb = _port_batch(*data), _jax_batch(*data)
    cfg = dict(max_iterations=60, tolerance=1e-10)
    pp = GLMOptimizationProblem(task=TaskType.LOGISTIC_REGRESSION,
                                optimizer_config=OptimizerConfig(**cfg),
                                regularization=RegularizationContext(RegularizationType.L2),
                                reg_weight=0.5)
    jp = JaxProblem(task=JaxTask.LOGISTIC_REGRESSION, optimizer_config=JaxConfig(**cfg),
                    regularization=JaxReg(JaxRegType.L2), reg_weight=0.5)
    pn = jn = None
    if normalized:
        pn = context_from_statistics(compute_feature_statistics(pb),
                                     NormalizationType.STANDARDIZATION, D - 1)
        jn = jax_context(jax_stats(jb), JaxNormType.STANDARDIZATION, D - 1)
    got = bootstrap_coefficients(pp, pb, torch.zeros(D, dtype=torch.float64),
                                 n_replicates=6, confidence=0.9, seed=3, normalization=pn)
    want = jax_bootstrap(jp, jb, jnp.zeros(D, jnp.float64), n_replicates=6,
                         confidence=0.9, seed=3, normalization=jn)
    assert got.n_replicates == want.n_replicates == 6
    np.testing.assert_allclose(got.samples, want.samples, rtol=0, atol=1e-8)
    for f in ("lower", "upper", "mean", "std_error"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(got.converged, want.converged)
    assert got.confidence == want.confidence
    # the replicates are distinct resamples
    assert np.std(got.samples[:, 0]) > 1e-3


@pytest.mark.parametrize("bins", [4, 10])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_hosmer_lemeshow_matches_jax(data, bins, weighted):
    _, _, labels, weights = data
    rng = np.random.default_rng(bins)
    scores = rng.normal(size=len(labels)) * 2.0
    w = weights if weighted else None
    got = hosmer_lemeshow(torch.from_numpy(scores), torch.from_numpy(labels), n_bins=bins,
                          weights=None if w is None else torch.from_numpy(w))
    want = jax_hl(jnp.asarray(scores), jnp.asarray(labels), n_bins=bins,
                  weights=None if w is None else jnp.asarray(w))
    assert (got.df, got.n_bins) == (want.df, want.n_bins)
    for f in ("bin_count", "observed_positives", "expected_positives"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-10)
    assert got.statistic == pytest.approx(want.statistic, rel=1e-10)
    assert got.p_value == pytest.approx(want.p_value, rel=1e-10)


def test_feature_importance_matches_jax(data):
    pb, jb = _port_batch(*data), _jax_batch(*data)
    coef = np.random.default_rng(9).normal(size=D)
    coef[3] = 0.0
    got = feature_importance(coef, compute_feature_statistics(pb))
    want = jax_importance(coef, jax_stats(jb))
    np.testing.assert_array_equal(got.order, want.order)
    np.testing.assert_allclose(got.importance, want.importance, rtol=1e-12)
    assert got.top(3) == pytest.approx(want.top(3))


def test_fit_report_has_the_jax_keys(data, tmp_path):
    labels = data[2]
    pb, jb = _port_batch(*data), _jax_batch(*data)
    coef = np.linspace(-1, 1, D)
    scores = np.random.default_rng(1).normal(size=len(labels))
    common = dict(task="LOGISTIC_REGRESSION",
                  feature_names=[f"f{j}" for j in range(D)], coefficients=coef,
                  config_summary={"optimizer": "LBFGS", "selected_reg_weight": 0.5,
                                  "n_rows": len(labels)},
                  sweep_metrics=[{"reg_weight": 0.5, "AUC": 0.7}], top_k=5)
    p = write_fit_report(str(tmp_path / "p"), hosmer_lemeshow=hosmer_lemeshow(
        torch.from_numpy(scores), torch.from_numpy(labels)),
        importance=feature_importance(coef, compute_feature_statistics(pb)), **common)
    j = jax_report(str(tmp_path / "j"), hosmer_lemeshow=jax_hl(
        jnp.asarray(scores), jnp.asarray(labels)),
        importance=jax_importance(coef, jax_stats(jb)), **common)
    pj = json.loads((tmp_path / "p" / "fit-report.json").read_text())
    jj = json.loads((tmp_path / "j" / "fit-report.json").read_text())
    assert set(pj) == set(jj) and pj["config"] == jj["config"]
    assert pj["sweep_metrics"] == jj["sweep_metrics"]
    assert pj["hosmer_lemeshow"] == pytest.approx(jj["hosmer_lemeshow"], rel=1e-10)
    ph, jh = open(p).read(), open(j).read()
    assert ph.count("<h2>") == jh.count("<h2>") == 4 and ph.count("<tr>") == jh.count("<tr>")
