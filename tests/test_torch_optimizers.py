"""The PyTorch port's optimizers against the JAX package's, on the CPU.

L-BFGS (``optimize_scored`` through ``GLMOptimizationProblem.run``, and the
plain ``optimize`` on the bound objective), TRON and OWL-QN, on the tasks of
``tests/test_problem.py`` (each dense design laid out as ELL rows holding
every column), in float64 on the same numpy-made data. The coefficients
agree to ``atol 1e-9``; ``iterations``, ``converged_reason`` and
``data_passes`` are equal; SIMPLE variances agree to ``rtol 1e-10`` and FULL
variances (a 50-feature case) too. The L1 guard and the FULL-variance
refusal raise as in JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import photon_tpu.functions.problem as jax_problem_mod
from photon_tpu.data.batch import LabeledBatch as JaxBatch
from photon_tpu.data.batch import SparseFeatures as JaxFeatures
from photon_tpu.functions.objective import intercept_reg_mask as jax_mask
from photon_tpu.functions.prior import PriorDistribution as JaxPrior
from photon_tpu.functions.problem import GLMOptimizationProblem as JaxProblem
from photon_tpu.functions.problem import VarianceComputationType as JaxVariance
from photon_tpu.optim import LBFGS as JaxLBFGS
from photon_tpu.optim import OptimizerConfig as JaxConfig
from photon_tpu.optim import OptimizerType as JaxOptimizer
from photon_tpu.optim import RegularizationContext as JaxReg
from photon_tpu.optim import RegularizationType as JaxRegType
from photon_tpu.types import TaskType as JaxTask
import photon_tpu_torch.functions.problem as problem_mod
from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures
from photon_tpu_torch.functions.objective import intercept_reg_mask
from photon_tpu_torch.functions.prior import PriorDistribution
from photon_tpu_torch.functions.problem import (
    GLMOptimizationProblem,
    VarianceComputationType,
)
from photon_tpu_torch.optim import (
    LBFGS,
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
    make_optimizer,
)
from photon_tpu_torch.types import TaskType


def _batches(x, y, offsets=None):
    n, d = x.shape
    idx = np.tile(np.arange(d, dtype=np.int32), (n, 1))
    off = np.zeros(n) if offsets is None else offsets
    jb = JaxBatch(JaxFeatures(jnp.asarray(idx), jnp.asarray(x), d), jnp.asarray(y),
                  jnp.asarray(off), jnp.ones(n))
    tb = LabeledBatch(SparseFeatures(torch.from_numpy(idx), torch.from_numpy(x), d),
                      torch.from_numpy(y), torch.from_numpy(off),
                      torch.ones(n, dtype=torch.float64))
    return jb, tb


def _with_intercept(x):
    return np.concatenate([np.ones((x.shape[0], 1)), x], axis=1)


def _problems(task, optimizer, reg, lam, variance="NONE", max_iter=80, tol=1e-7,
              intercept=False, d=None):
    jp = JaxProblem(
        task=JaxTask[task], optimizer_type=JaxOptimizer[optimizer],
        optimizer_config=JaxConfig(max_iterations=max_iter, tolerance=tol),
        regularization=JaxReg(JaxRegType[reg]), reg_weight=lam,
        variance_type=JaxVariance[variance],
        reg_mask=jax_mask(d, 0) if intercept else None)
    tp = GLMOptimizationProblem(
        task=TaskType[task], optimizer_type=OptimizerType[optimizer],
        optimizer_config=OptimizerConfig(max_iterations=max_iter, tolerance=tol),
        regularization=RegularizationContext(RegularizationType[reg]),
        reg_weight=lam, variance_type=VarianceComputationType[variance],
        reg_mask=intercept_reg_mask(d, 0) if intercept else None)
    return jp, tp


def _task_data(name, rng):
    """The data of ``tests/test_problem.py``'s tasks."""
    if name in ("logistic_lbfgs", "owlqn_intercept"):
        n, d = 400, 6
        x = rng.normal(size=(n, d))
        w = rng.normal(size=d)
        y = (1 / (1 + np.exp(-(x @ w + 0.3))) > rng.uniform(size=n)).astype(float)
        return _with_intercept(x), y
    if name == "linear_tron":
        n, d = 200, 5
        x = rng.normal(size=(n, d))
        return x, x @ rng.normal(size=d) + 0.1 * rng.normal(size=n)
    if name == "poisson_owlqn":
        n, d = 300, 10
        x = rng.normal(size=(n, d)) * 0.4
        w_true = np.zeros(d)
        w_true[:3] = [0.8, -0.5, 0.6]
        return x, rng.poisson(np.exp(x @ w_true)).astype(float)
    if name == "simple_variances":
        n, d = 150, 4
        x = rng.normal(size=(n, d))
        return x, rng.integers(0, 2, n).astype(float)
    if name == "hinge_lbfgs":
        n, d = 200, 5
        x = rng.normal(size=(n, d))
        return x, (x @ rng.normal(size=d) > 0).astype(float)
    if name == "full_variance_50":
        n, d = 300, 50
        x = rng.normal(size=(n, d)) * 0.3
        return x, rng.poisson(np.exp(x @ (rng.normal(size=d) * 0.2))).astype(float)
    raise KeyError(name)


# name: (task, optimizer, reg, λ, variance, max_iter, tol, intercept)
CASES = {
    "logistic_lbfgs": ("LOGISTIC_REGRESSION", "LBFGS", "L2", 1.0, "SIMPLE", 300, 1e-10, True),
    "linear_tron": ("LINEAR_REGRESSION", "TRON", "L2", 2.0, "FULL", 100, 1e-12, False),
    "poisson_owlqn": ("POISSON_REGRESSION", "OWLQN", "L1", 15.0, "NONE", 200, 1e-7, False),
    "simple_variances": ("LOGISTIC_REGRESSION", "LBFGS", "L2", 0.5, "SIMPLE", 80, 1e-7, False),
    "hinge_lbfgs": ("SMOOTHED_HINGE_LOSS_LINEAR_SVM", "LBFGS", "L2", 0.1, "NONE", 200, 1e-7, False),
    "full_variance_50": ("POISSON_REGRESSION", "TRON", "L2", 1.0, "FULL", 50, 1e-9, True),
    "owlqn_intercept": ("LOGISTIC_REGRESSION", "OWLQN", "L1", 0.5, "SIMPLE", 100, 1e-9, True),
}


def _compare(jm, jr, tm, tr, variance):
    assert tr.iterations == int(jr.iterations)
    assert tr.converged_reason == int(jr.converged_reason)
    assert tr.reason_name() == jr.reason_name()
    assert tr.data_passes == int(jr.data_passes)
    np.testing.assert_allclose(tm.coefficients.means.numpy(),
                               np.asarray(jm.coefficients.means), rtol=0, atol=1e-9)
    np.testing.assert_allclose(tr.value, float(jr.value), rtol=1e-12)
    n = tr.iterations + 1
    np.testing.assert_allclose(tr.values[:n].numpy(), np.asarray(jr.values)[:n],
                               rtol=1e-10)
    assert torch.isinf(tr.values[n:]).all() and torch.isinf(tr.grad_norms[n:]).all()
    if variance == "NONE":
        assert tm.coefficients.variances is None
    else:
        np.testing.assert_allclose(tm.coefficients.variances.numpy(),
                                   np.asarray(jm.coefficients.variances), rtol=1e-10)


@pytest.mark.parametrize("name", list(CASES))
def test_problem_run_matches_jax(name):
    task, opt, reg, lam, variance, max_iter, tol, intercept = CASES[name]
    rng = np.random.default_rng(list(CASES).index(name))
    x, y = _task_data(name, rng)
    offsets = rng.normal(size=len(y)) * 0.1
    jb, tb = _batches(x, y, offsets)
    jp, tp = _problems(task, opt, reg, lam, variance, max_iter, tol, intercept,
                       x.shape[1])
    d = x.shape[1]
    if opt == "OWLQN" and intercept:
        # The estimator's path: ``fit`` carries the weight in the working
        # dtype, so the masked L1 vector is float64 (``run`` with a Python
        # weight builds it in the mask's float32).
        jm, jr = jp.fit(jb, jnp.zeros(d))
    else:
        jm, jr = jp.run(jb, jnp.zeros(d))
    tm, tr = tp.run(tb, torch.zeros(d, dtype=torch.float64))
    assert tr.iterations >= 2
    _compare(jm, jr, tm, tr, variance)


def test_incremental_prior_matches_jax():
    rng = np.random.default_rng(11)
    x, y = _task_data("logistic_lbfgs", rng)
    d = x.shape[1]
    jb, tb = _batches(x, y)
    mu, var = rng.normal(size=d) * 0.2, rng.uniform(0.5, 2.0, size=d)
    jp, tp = _problems("LOGISTIC_REGRESSION", "TRON", "L2", 1.0, "SIMPLE", 50, 1e-9,
                       True, d)
    jp = dataclasses.replace(jp, prior=JaxPrior.from_model(jnp.asarray(mu), jnp.asarray(var), 3.0))
    tp = dataclasses.replace(tp, prior=PriorDistribution.from_model(
        torch.from_numpy(mu), torch.from_numpy(var), 3.0))
    jm, jr = jp.run(jb, jnp.zeros(d))
    tm, tr = tp.run(tb, torch.zeros(d, dtype=torch.float64))
    _compare(jm, jr, tm, tr, "SIMPLE")


def test_plain_lbfgs_optimize_matches_jax():
    """``LBFGS.optimize`` (one fused value+grad per probe) on the bound
    objective."""
    rng = np.random.default_rng(3)
    x, y = _task_data("logistic_lbfgs", rng)
    d = x.shape[1]
    jb, tb = _batches(x, y)
    jp, tp = _problems("LOGISTIC_REGRESSION", "LBFGS", "L2", 1.0, intercept=True, d=d,
                       tol=1e-10, max_iter=100)
    jr = JaxLBFGS(jp.optimizer_config).optimize(jp.objective().bind(jb), jnp.zeros(d))
    tr = make_optimizer(OptimizerType.LBFGS, tp.optimizer_config).optimize(
        tp.objective().bind(tb), torch.zeros(d, dtype=torch.float64))
    assert isinstance(make_optimizer(OptimizerType.LBFGS, OptimizerConfig()), LBFGS)
    assert tr.iterations == int(jr.iterations) and tr.iterations >= 2
    assert tr.converged_reason == int(jr.converged_reason)
    assert tr.data_passes == int(jr.data_passes)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0, atol=1e-9)


def test_l1_guard_raises_as_in_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(40, 3))
    y = x @ rng.normal(size=3)
    jb, tb = _batches(x, y)
    jp, tp = _problems("LINEAR_REGRESSION", "LBFGS", "L1", 0.0, max_iter=5, d=3)
    for p, b, w0 in ((jp, jb, jnp.zeros(3)), (tp, tb, torch.zeros(3, dtype=torch.float64))):
        with pytest.raises(ValueError, match="L1 regularization requires OptimizerType.OWLQN, got LBFGS"):
            p.run(b, w0, reg_weight=1.0)
        with pytest.raises(ValueError, match="requires OptimizerType.OWLQN"):
            dataclasses.replace(p, reg_weight=1.0).run(b, w0)
        dataclasses.replace(p, reg_weight=1.0).run(b, w0, reg_weight=0.0)


def test_full_variance_refuses_wide_models_as_in_jax(monkeypatch):
    monkeypatch.setattr(jax_problem_mod, "FULL_VARIANCE_MAX_DIM", 64)
    monkeypatch.setattr(problem_mod, "FULL_VARIANCE_MAX_DIM", 64)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(30, 65))
    y = x[:, 0] + 0.1 * rng.normal(size=30)
    jb, tb = _batches(x, y)
    jp, tp = _problems("LINEAR_REGRESSION", "LBFGS", "L2", 1.0, "FULL", 5, d=65)
    msgs = []
    for p, b, w0 in ((jp, jb, jnp.zeros(65)), (tp, tb, torch.zeros(65, dtype=torch.float64))):
        with pytest.raises(ValueError, match="FULL variance.*SIMPLE") as e:
            p.run(b, w0)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_normalization_is_refused():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(20, 3))
    _, tb = _batches(x, x[:, 0])
    _, tp = _problems("LINEAR_REGRESSION", "LBFGS", "L2", 1.0, d=3)
    with pytest.raises(NotImplementedError, match="M8"):
        tp.run(tb, torch.zeros(3, dtype=torch.float64), normalization=object())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["logistic_lbfgs", "linear_tron", "poisson_owlqn"])
def test_problem_on_card_matches_cpu(name, cuda_device):
    """The same float64 solve through the kernels on the card and through
    the plain versions on the CPU: equal iterations, reasons and passes,
    coefficients within 1e-10 of the largest."""
    task, opt, reg, lam, variance, max_iter, tol, intercept = CASES[name]
    rng = np.random.default_rng(list(CASES).index(name))
    x, y = _task_data(name, rng)
    _, tb = _batches(x, y, rng.normal(size=len(y)) * 0.1)
    _, tp = _problems(task, opt, reg, lam, variance, max_iter, tol, intercept,
                      x.shape[1])
    d = x.shape[1]
    tm, tr = tp.run(tb, torch.zeros(d, dtype=torch.float64))

    def on(t):
        return t.to(cuda_device)

    batch = LabeledBatch(SparseFeatures(on(tb.features.idx), on(tb.features.val), d),
                         on(tb.labels), on(tb.offsets), on(tb.weights))
    tp_d = dataclasses.replace(
        tp, reg_mask=None if tp.reg_mask is None else on(tp.reg_mask))
    dm, dr = tp_d.run(batch.with_accelerator_paths(),
                      torch.zeros(d, dtype=torch.float64, device=cuda_device))
    assert (dr.iterations, dr.converged_reason, dr.data_passes) == \
        (tr.iterations, tr.converged_reason, tr.data_passes)
    scale = tm.coefficients.means.abs().max().item()
    assert (dm.coefficients.means.cpu() - tm.coefficients.means).abs().max().item() \
        <= 1e-10 * scale
