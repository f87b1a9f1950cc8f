"""The ``model`` axis (``photon_tpu_torch/parallel/model_parallel.py``)
against the JAX package's ``fit_model_parallel`` on the CPU.

The cases of ``tests/test_model_parallel.py`` (sparse parity, dense data of
an uneven dimension, ``reg_mask`` and a prior, a ragged row count, the
linear task, the validation errors, OWL-QN with L1, SIMPLE variances, both
normalizations, the estimator's auto-route and its model axis, the
multi-slice mesh, TRON, TRON with a prior, TRON-Poisson with variances and
normalization), each on the same arrays (made from a seed with numpy)
through the port on its CPU mesh (the shards on the one CPU device) and
through the JAX package on its forced CPU devices; the normalization
contexts and priors come from each package's own builders.

Also: the GAME driver's ``--mesh data=2,model=2`` (4 CPU devices through
``cli/params.visible_devices``), and two gloo processes over a
``("dcn", "data")`` x ``model`` mesh against one process.

Tolerances (f64): coefficients within 1e-12 of JAX's, with equal
iterations and reasons; the final value within relative 1e-12; SIMPLE
variances within relative 1e-12. Each is also within 1e-12 of the port's
own unsharded fit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from photon_tpu.data.batch import LabeledBatch as JaxBatch
from photon_tpu.data.batch import SparseFeatures as JaxFeatures
from photon_tpu.data.batch import make_dense_batch as jax_dense_batch
from photon_tpu.data.normalization import NormalizationType as JaxNormType
from photon_tpu.data.normalization import context_from_statistics as jax_context
from photon_tpu.data.statistics import compute_feature_statistics as jax_stats
from photon_tpu.functions.prior import PriorDistribution as JaxPrior
from photon_tpu.functions.problem import GLMOptimizationProblem as JaxProblem
from photon_tpu.functions.problem import VarianceComputationType as JaxVariance
from photon_tpu.optim import OptimizerConfig as JaxConfig
from photon_tpu.optim import OptimizerType as JaxOptimizer
from photon_tpu.optim import RegularizationContext as JaxReg
from photon_tpu.optim import RegularizationType as JaxRegType
from photon_tpu.optim.regularization import elastic_net_context as jax_elastic_net
from photon_tpu.parallel.mesh import make_mesh as jax_make_mesh
from photon_tpu.parallel.mesh import make_multislice_mesh as jax_multislice
from photon_tpu.parallel.model_parallel import fit_model_parallel as jax_fit
from photon_tpu.types import TaskType as JaxTask
from photon_tpu_torch.data.batch import DenseFeatures, LabeledBatch, SparseFeatures
from photon_tpu_torch.data.normalization import NormalizationType, context_from_statistics
from photon_tpu_torch.data.statistics import compute_feature_statistics
from photon_tpu_torch.functions.prior import PriorDistribution
from photon_tpu_torch.functions.problem import (
    GLMOptimizationProblem,
    VarianceComputationType,
)
from photon_tpu_torch.optim import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
)
from photon_tpu_torch.optim.regularization import elastic_net_context
from photon_tpu_torch.parallel.mesh import make_mesh, make_multislice_mesh
from photon_tpu_torch.parallel.model_parallel import fit_model_parallel
from photon_tpu_torch.types import TaskType

CPU = torch.device("cpu")
TOL = 1e-12


def sparse_arrays(rng, n=300, d=37, k=6, task="LOGISTIC_REGRESSION"):
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
    val = rng.normal(size=(n, k))
    z = (val * rng.normal(size=d)[idx]).sum(1)
    if task == "LOGISTIC_REGRESSION":
        y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    elif task == "POISSON_REGRESSION":
        y = np.floor(np.abs(z + 0.1 * rng.normal(size=n)))
    else:
        y = z + 0.1 * rng.normal(size=n)
    return dict(idx=idx, val=val, y=y, d=d)


def with_intercept(a):
    """An intercept column (id 0, value 1 in every row) in front."""
    n = len(a["y"])
    return dict(a, idx=np.concatenate([np.zeros((n, 1), np.int32), a["idx"]], 1),
                val=np.concatenate([np.ones((n, 1)), a["val"]], 1))


def port_batch(a) -> LabeledBatch:
    n = len(a["y"])
    t = torch.from_numpy
    feats = (DenseFeatures(t(a["x"])) if "x" in a
             else SparseFeatures(t(a["idx"]), t(a["val"]), a["d"]))
    return LabeledBatch(feats, t(a["y"]), torch.zeros(n, dtype=torch.float64),
                        torch.ones(n, dtype=torch.float64))


def jax_batch(a) -> JaxBatch:
    if "x" in a:
        return jax_dense_batch(a["x"], a["y"], dtype=jnp.float64)
    n = len(a["y"])
    return JaxBatch(JaxFeatures(jnp.asarray(a["idx"]), jnp.asarray(a["val"]), a["d"]),
                    jnp.asarray(a["y"]), jnp.zeros(n, jnp.float64),
                    jnp.ones(n, jnp.float64))


def problems(task="LOGISTIC_REGRESSION", optimizer="LBFGS", reg="L2", weight=1.0,
             iterations=60, variance="NONE", reg_mask=None, prior=None):
    """The same problem in both packages; ``reg`` a regularization type's
    name or ``("elastic_net", alpha)``; ``prior`` (means, variances, weight)."""
    def one(Problem, Task, Opt, Config, Reg, RegType, elastic, Var, Prior, arr):
        r = (elastic(reg[1]) if isinstance(reg, tuple) else Reg(RegType[reg]))
        p = Problem(task=Task[task], optimizer_type=Opt[optimizer],
                    optimizer_config=Config(max_iterations=iterations),
                    regularization=r, reg_weight=weight, variance_type=Var[variance])
        if reg_mask is not None:
            p = dataclasses.replace(p, reg_mask=arr(reg_mask))
        if prior is not None:
            p = dataclasses.replace(p, prior=Prior.from_model(
                arr(prior[0]), arr(prior[1]), incremental_weight=prior[2]))
        return p

    return (one(GLMOptimizationProblem, TaskType, OptimizerType, OptimizerConfig,
                RegularizationContext, RegularizationType, elastic_net_context,
                VarianceComputationType, PriorDistribution, torch.from_numpy),
            one(JaxProblem, JaxTask, JaxOptimizer, JaxConfig, JaxReg, JaxRegType,
                jax_elastic_net, JaxVariance, JaxPrior, jnp.asarray))


def contexts(a, norm: str, intercept=0):
    port = context_from_statistics(compute_feature_statistics(port_batch(a)),
                                   NormalizationType[norm], intercept_index=intercept)
    jx = jax_context(jax_stats(jax_batch(a)), JaxNormType[norm],
                     intercept_index=intercept)
    return port, jx


def meshes(shape: dict, slices=None):
    n = int(np.prod(list(shape.values()))) * (slices or 1)
    if slices:
        return (make_multislice_mesh(slices, shape, devices=[CPU] * n),
                jax_multislice(n_slices=slices, axis_sizes=shape,
                               devices=jax.devices()[:n]))
    return make_mesh(shape, devices=[CPU] * n), jax_make_mesh(shape, devices=jax.devices()[:n])


def fit_both(a, probs, shape=None, norms=(None, None), data_axis="data", slices=None):
    """The port's and JAX's sharded fits and the port's unsharded fit."""
    pp, jp = probs
    pm_, jm_ = meshes(shape or {"data": 4, "model": 2}, slices)
    d = a["d"] if "x" not in a else a["x"].shape[1]
    w0 = np.zeros(d)
    port = fit_model_parallel(pp, port_batch(a), torch.from_numpy(w0), pm_,
                              data_axis=data_axis, normalization=norms[0])
    jx = jax_fit(jp, jax_batch(a), jnp.asarray(w0), jm_, data_axis=data_axis,
                 normalization=norms[1])
    one = pp.fit(port_batch(a), torch.from_numpy(w0), normalization=norms[0])
    return port, jx, one


def assert_parity(port, jx, one, variances=False):
    (pm_, pr), (jm_, jr), (om, orr) = port, jx, one
    got = pm_.coefficients.means.numpy()
    assert got.shape == np.asarray(jm_.coefficients.means).shape
    np.testing.assert_allclose(got, np.asarray(jm_.coefficients.means), rtol=0, atol=TOL)
    np.testing.assert_allclose(got, om.coefficients.means.numpy(), rtol=0, atol=TOL)
    assert pr.iterations == int(jr.iterations) == orr.iterations
    assert pr.converged_reason == int(jr.converged_reason) == orr.converged_reason
    assert pr.value == pytest.approx(float(jr.value), rel=TOL)
    assert np.abs(got).max() > 0.01
    if variances:
        pv = pm_.coefficients.variances.numpy()
        np.testing.assert_allclose(pv, np.asarray(jm_.coefficients.variances),
                                   rtol=TOL, atol=0)
        np.testing.assert_allclose(pv, om.coefficients.variances.numpy(),
                                   rtol=TOL, atol=0)
    else:
        assert pm_.coefficients.variances is None


# ------------------------------------------------------------------ parity


def test_sparse_matches_jax(rng):
    assert_parity(*fit_both(sparse_arrays(rng), problems()))


def test_dense_and_uneven_dim(rng):
    """d = 37 over 4 model shards: the padding columns stay exact."""
    a = dict(x=rng.normal(size=(256, 37)),
             y=(rng.random(256) < 0.5).astype(np.float64), d=37)
    port, jx, one = fit_both(a, problems(), {"data": 2, "model": 4})
    assert port[0].coefficients.means.shape == (37,)
    assert_parity(port, jx, one)


def test_reg_mask_and_prior(rng):
    a = sparse_arrays(rng)
    mask = np.ones(a["d"])
    mask[0] = 0.0
    prior = (rng.normal(size=a["d"]), 0.5 + rng.random(a["d"]), 3.0)
    assert_parity(*fit_both(a, problems(reg_mask=mask, prior=prior)))


def test_rows_not_divisible(rng):
    assert_parity(*fit_both(sparse_arrays(rng, n=301), problems()))


def test_linear_task(rng):
    a = sparse_arrays(rng, task="LINEAR_REGRESSION")
    assert_parity(*fit_both(a, problems(task="LINEAR_REGRESSION", weight=0.5,
                                        iterations=80)))


def test_unsupported_options_raise_as_jax(rng):
    a = sparse_arrays(rng)
    mesh = make_mesh({"data": 4, "model": 2}, devices=[CPU] * 8)
    w0 = torch.zeros(a["d"], dtype=torch.float64)
    full, _ = problems(variance="FULL")
    with pytest.raises(ValueError, match="FULL"):
        fit_model_parallel(full, port_batch(a), w0, mesh)
    enet, _ = problems(reg=("elastic_net", 0.5))
    with pytest.raises(ValueError, match="OWLQN"):
        fit_model_parallel(enet, port_batch(a), w0, mesh)
    a1 = with_intercept(a)
    norm, _ = contexts(a1, "STANDARDIZATION")
    with_prior, _ = problems(prior=(np.zeros(a["d"]), np.ones(a["d"]), 1.0))
    with pytest.raises(ValueError, match="normalization context with an "
                                         "incremental-training prior"):
        fit_model_parallel(with_prior, port_batch(a1), w0, mesh, normalization=norm)


def test_owlqn_l1_matches_jax(rng):
    a = sparse_arrays(rng)
    port, jx, one = fit_both(a, problems(optimizer="OWLQN", reg="L1", weight=0.8,
                                         iterations=80))
    assert_parity(port, jx, one)
    means = port[0].coefficients.means.numpy()
    np.testing.assert_array_equal(means == 0.0,
                                  np.asarray(jx[0].coefficients.means) == 0.0)
    assert (means == 0.0).any()


def test_simple_variance_matches_jax(rng):
    assert_parity(*fit_both(sparse_arrays(rng), problems(variance="SIMPLE")),
                  variances=True)


@pytest.mark.parametrize("norm", ["SCALE_WITH_STANDARD_DEVIATION", "STANDARDIZATION"])
def test_normalization_matches_jax(rng, norm):
    a = with_intercept(sparse_arrays(rng))
    mask = np.ones(a["d"])
    mask[0] = 0.0
    assert_parity(*fit_both(a, problems(reg_mask=mask), norms=contexts(a, norm)))


def test_dcn_data_model_matches_jax(rng):
    assert_parity(*fit_both(sparse_arrays(rng), problems(), {"data": 2, "model": 2},
                            data_axis=("dcn", "data"), slices=2))


def test_tron_matches_jax(rng):
    assert_parity(*fit_both(sparse_arrays(rng), problems(optimizer="TRON",
                                                         iterations=40)))


def test_tron_prior_and_reg_mask(rng):
    a = sparse_arrays(rng)
    mask = np.ones(a["d"])
    mask[0] = 0.0
    prior = (rng.normal(size=a["d"]), 0.5 + rng.random(a["d"]), 3.0)
    assert_parity(*fit_both(a, problems(optimizer="TRON", iterations=40,
                                        reg_mask=mask, prior=prior)))


def test_tron_poisson_with_variance_and_normalization(rng):
    a = sparse_arrays(rng, task="POISSON_REGRESSION")
    port_ctx = context_from_statistics(compute_feature_statistics(port_batch(a)),
                                       NormalizationType.SCALE_WITH_STANDARD_DEVIATION,
                                       intercept_index=None)
    jax_ctx = jax_context(jax_stats(jax_batch(a)),
                          JaxNormType.SCALE_WITH_STANDARD_DEVIATION, intercept_index=None)
    assert_parity(*fit_both(a, problems(task="POISSON_REGRESSION", optimizer="TRON",
                                        iterations=40, variance="SIMPLE"),
                            {"data": 2, "model": 4}, norms=(port_ctx, jax_ctx)),
                  variances=True)


# --------------------------------------------------------------- estimator


def _bundles(rng, d=40):
    """One fixed-effect shard of ``d`` columns in both packages' bundles."""
    from photon_tpu.io.data_reader import GameDataBundle as JaxBundle
    from photon_tpu_torch.io.data_reader import GameDataBundle

    a = sparse_arrays(rng, n=240, d=d)
    n = len(a["y"])
    common = dict(labels=a["y"], offsets=np.zeros(n), weights=np.ones(n),
                  uids=np.full(n, "", object), id_tags={})
    port = GameDataBundle(features={"global": SparseFeatures(
        torch.from_numpy(a["idx"]), torch.from_numpy(a["val"]), d)}, **common)
    jx = JaxBundle(features={"global": JaxFeatures(
        jnp.asarray(a["idx"]), jnp.asarray(a["val"]), d)}, **common)
    return port, jx


def _estimators(port_mesh, jax_mesh, **kw):
    from photon_tpu.estimators.config import FixedEffectDataConfig as JaxFixed
    from photon_tpu.estimators.game_estimator import GameEstimator as JaxEstimator
    from photon_tpu_torch.estimators.config import FixedEffectDataConfig
    from photon_tpu_torch.estimators.game_estimator import GameEstimator

    return (GameEstimator(TaskType.LOGISTIC_REGRESSION,
                          {"fixed": FixedEffectDataConfig("global")},
                          mesh=port_mesh, **kw),
            JaxEstimator(JaxTask.LOGISTIC_REGRESSION,
                         {"fixed": JaxFixed("global")}, mesh=jax_mesh, **kw))


def _configs(optimizer="LBFGS", variance="NONE"):
    from photon_tpu.estimators.config import GLMOptimizationConfiguration as JaxGLM
    from photon_tpu_torch.estimators.config import GLMOptimizationConfiguration

    def one(GLM, Opt, Reg, RegType, Var):
        return [{"fixed": GLM(optimizer_type=Opt[optimizer], max_iterations=30,
                              regularization=Reg(RegType.L2), reg_weight=1.0,
                              variance_type=Var[variance])}]

    return (one(GLMOptimizationConfiguration, OptimizerType, RegularizationContext,
                RegularizationType, VarianceComputationType),
            one(JaxGLM, JaxOptimizer, JaxReg, JaxRegType, JaxVariance))


def _routed(monkeypatch):
    """Count each package's fit_model_parallel calls."""
    import photon_tpu.parallel.model_parallel as jax_mp
    import photon_tpu_torch.parallel.model_parallel as port_mp

    calls = {"port": 0, "jax": 0}
    for name, mod in (("port", port_mp), ("jax", jax_mp)):
        orig = mod.fit_model_parallel

        def spy(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(mod, "fit_model_parallel", spy)
    return calls


@pytest.mark.parametrize("threshold,optimizer,variance,routed", [
    (8, "LBFGS", "NONE", True),         # wider than the threshold: model axis
    (1 << 20, "LBFGS", "NONE", False),  # below it: data-parallel
    (8, "TRON", "SIMPLE", True),
    (8, "LBFGS", "FULL", False),        # FULL variances stay data-parallel
], ids=["wide", "narrow", "tron_simple", "full_variance"])
def test_estimator_auto_routes_wide_coordinates_as_jax(rng, monkeypatch, threshold,
                                                       optimizer, variance, routed):
    port_b, jax_b = _bundles(rng)
    pm_, jm_ = meshes({"data": 4, "model": 2})
    pe, je = _estimators(pm_, jm_, auto_p3_threshold=threshold)
    pc, jc = _configs(optimizer, variance)
    calls = _routed(monkeypatch)
    (pr,) = pe.fit(port_b, None, pc)
    (jr,) = je.fit(jax_b, None, jc)
    assert calls == {"port": int(routed), "jax": int(routed)}
    pmn = pr.model["fixed"].model.coefficients.means.numpy()
    np.testing.assert_allclose(pmn, np.asarray(jr.model["fixed"].model.coefficients.means),
                               rtol=0, atol=1e-9 if variance == "FULL" else TOL)
    (one,) = _estimators(None, None)[0].fit(port_b, None, pc)
    np.testing.assert_allclose(pmn, one.model["fixed"].model.coefficients.means.numpy(),
                               rtol=0, atol=TOL)


def test_estimator_with_model_axis(rng, monkeypatch):
    """``model_axis="model"`` trains the fixed effect feature-sharded and
    lands within 1e-12 of the unsharded estimator and of JAX's."""
    port_b, jax_b = _bundles(rng)
    pm_, jm_ = meshes({"data": 4, "model": 2})
    pe, je = _estimators(pm_, jm_, model_axis="model")
    pc, jc = _configs()
    calls = _routed(monkeypatch)
    (pr,) = pe.fit(port_b, None, pc)
    (jr,) = je.fit(jax_b, None, jc)
    assert calls == {"port": 1, "jax": 1}
    (one,) = _estimators(None, None)[0].fit(port_b, None, pc)
    pmn = pr.model["fixed"].model.coefficients.means.numpy()
    for ref in (np.asarray(jr.model["fixed"].model.coefficients.means),
                one.model["fixed"].model.coefficients.means.numpy()):
        np.testing.assert_allclose(pmn, ref, rtol=0, atol=TOL)


# ------------------------------------------------------------------ driver


def test_game_driver_trains_the_model_axis(tmp_path, monkeypatch):
    """``--mesh data=2,model=2`` with 4 visible (CPU) devices trains the
    fixed effect feature-sharded through the GAME driver, and its model
    equals the one-device driver's within 1e-12."""
    from photon_tpu_torch.cli import game_training_driver, params
    from test_torch_scoring_driver import _write_game_avro
    from test_torch_training_driver import _saved

    _write_game_avro(tmp_path / "train.avro", seed=1)
    common = ["--train-data", str(tmp_path / "train.avro"), "--task",
              "LOGISTIC_REGRESSION", "--coordinate",
              "fixed:type=fixed,shard=global,reg=L2,reg_weights=1,variance=SIMPLE",
              "--dtype", "float64", "--device", "cpu"]
    one = game_training_driver.run(common + ["--output-dir", str(tmp_path / "one")])
    calls = _routed(monkeypatch)
    monkeypatch.setattr(params, "visible_devices", lambda device="cuda": [CPU] * 4)
    two = game_training_driver.run(common + ["--output-dir", str(tmp_path / "mp"),
                                             "--mesh", "data=2,model=2"])
    assert calls["port"] == 1
    assert one["best_config_index"] == two["best_config_index"]
    pm_, pv = _saved(tmp_path / "mp" / "best")
    om, ov = _saved(tmp_path / "one" / "best")
    assert set(pm_) == set(om) and len(om) > 3
    assert max(abs(pm_[k] - om[k]) for k in om) <= TOL
    assert max(abs(pv[k] - ov[k]) / abs(ov[k]) for k in ov) <= TOL


# ------------------------------------------------------- across processes


def _gloo_model_worker(rank: int, world: int, port: int, out: str) -> None:
    """One rank of two: the ``("dcn", "data")`` x ``model`` mesh, this
    rank's rows in 2 row blocks x 2 column blocks; the data folds gather
    across the gloo group (from one shard thread, in a fixed order)."""
    import os

    from photon_tpu_torch.parallel import distributed as pd

    assert pd.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                     backend="gloo")
    a = sparse_arrays(np.random.default_rng(7))
    mesh = pd.multihost_mesh({"data": 2, "model": 2}, devices=[CPU] * 4)
    assert mesh.shape == {"dcn": 2, "data": 2, "model": 2}
    pp, _ = problems(optimizer="TRON", iterations=40, variance="SIMPLE")
    model, result = fit_model_parallel(pp, port_batch(a),
                                       torch.zeros(a["d"], dtype=torch.float64),
                                       mesh, data_axis=("dcn", "data"))
    np.savez(os.path.join(out, f"rank{rank}.npz"), w=model.coefficients.means.numpy(),
             v=model.coefficients.variances.numpy(), it=result.iterations)
    pd.shutdown_distributed()


def test_two_gloo_processes_match_one_process(tmp_path):
    import socket

    import torch.multiprocessing as tmp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tmp.spawn(_gloo_model_worker, args=(2, port, str(tmp_path)), nprocs=2, join=True)
    a = sparse_arrays(np.random.default_rng(7))
    pp, _ = problems(optimizer="TRON", iterations=40, variance="SIMPLE")
    ref, rr = fit_model_parallel(pp, port_batch(a),
                                 torch.zeros(a["d"], dtype=torch.float64),
                                 make_mesh({"data": 4, "model": 2}, devices=[CPU] * 8))
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for got in ranks:
        np.testing.assert_allclose(got["w"], ref.coefficients.means.numpy(),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(got["v"], ref.coefficients.variances.numpy(),
                                   rtol=TOL, atol=0)
        assert int(got["it"]) == rr.iterations
    np.testing.assert_array_equal(ranks[0]["w"], ranks[1]["w"])
