"""Data-parallel fixed effects (``photon_tpu_torch/parallel/spmd_objective.py``
and ``data_parallel.py``) on the CPU, against the port's single-device fit
and the JAX package's mesh fits.

The port's mesh: 4 shards on the one CPU device; the JAX package's: 4 of
the 8 CPU devices ``tests/conftest.py`` forces. Each case is one fit at
float64 of a ragged row count (203 rows over 4 shards).

Tolerances:
* against the port's own single-device fit (``GLMOptimizationProblem.run``:
  the scored L-BFGS path, or OWL-QN / TRON): coefficients within 1e-12,
  equal iterations and reasons;
* against the JAX package's ``fit_spmd`` (and, with normalization or
  variances, its GSPMD ``fit_data_parallel``) on its 4-device mesh: the
  port's f64 parity bar (``tests/test_torch_optimizers.py``): coefficients
  within 1e-9, equal iterations and reasons; SIMPLE variances within
  relative 1e-10. OWL-QN on these data is 9.5e-9 (elastic net) and 1.8e-9
  (L1) from JAX's already on one device each, so its bar is 1e-8; and for
  every case the gap to JAX under the meshes equals the gap on one device
  within 1e-12 (the meshes move neither package's fit).
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
from photon_tpu.data.normalization import NormalizationType as JaxNormType
from photon_tpu.data.normalization import context_from_statistics as jax_context
from photon_tpu.data.statistics import compute_feature_statistics as jax_stats
from photon_tpu.functions.objective import intercept_reg_mask as jax_mask
from photon_tpu.functions.problem import GLMOptimizationProblem as JaxProblem
from photon_tpu.functions.problem import VarianceComputationType as JaxVariance
from photon_tpu.optim import OptimizerConfig as JaxConfig
from photon_tpu.optim import OptimizerType as JaxOptimizer
from photon_tpu.optim import RegularizationContext as JaxReg
from photon_tpu.optim import RegularizationType as JaxRegType
from photon_tpu.parallel.data_parallel import fit_data_parallel as jax_fit_dp
from photon_tpu.parallel.mesh import make_mesh as jax_make_mesh
from photon_tpu.parallel.mesh import make_multislice_mesh as jax_multislice
from photon_tpu.parallel.spmd_objective import fit_spmd as jax_fit_spmd
from photon_tpu.types import TaskType as JaxTask
from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures
from photon_tpu_torch.data.normalization import (
    NormalizationType,
    context_from_statistics,
)
from photon_tpu_torch.data.statistics import compute_feature_statistics
from photon_tpu_torch.functions.objective import intercept_reg_mask
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
from photon_tpu_torch.parallel import (
    fit_data_parallel,
    fit_spmd,
    make_mesh,
    make_multislice_mesh,
    spmd_value_and_grad,
)
from photon_tpu_torch.types import TaskType

CPU = torch.device("cpu")
N, DIM, K = 203, 40, 6


def arrays(task: str, seed: int = 0):
    """An intercept at column 0 and K - 1 random columns a row; labels
    for the task (0/1, counts, or reals)."""
    rng = np.random.default_rng(seed)
    idx = np.concatenate([np.zeros((N, 1), np.int32),
                          rng.integers(1, DIM, size=(N, K - 1)).astype(np.int32)], 1)
    val = np.concatenate([np.ones((N, 1)), rng.normal(size=(N, K - 1))], 1)
    z = val[:, 1:].sum(1) * 0.3
    if task == "POISSON_REGRESSION":
        labels = rng.poisson(np.exp(0.3 * z)).astype(np.float64)
    elif task == "LINEAR_REGRESSION":
        labels = z + rng.normal(size=N)
    else:
        labels = (rng.random(N) < 1 / (1 + np.exp(-z))).astype(np.float64)
    return idx, val, labels, rng.normal(size=N) * 0.1


def batches(task: str, seed: int = 0):
    idx, val, labels, offsets = arrays(task, seed)
    w = np.ones(N)
    t = torch.from_numpy
    pb = LabeledBatch(SparseFeatures(t(idx), t(val), DIM), t(labels), t(offsets),
                      t(w))
    jb = JaxBatch(JaxFeatures(jnp.asarray(idx), jnp.asarray(val), DIM),
                  jnp.asarray(labels), jnp.asarray(offsets), jnp.asarray(w))
    return pb, jb


def problems(task: str, optimizer: str, reg: str = "L2", variance="NONE",
             iterations=60):
    alpha = {"alpha": 0.5} if reg == "ELASTIC_NET" else {}
    p = GLMOptimizationProblem(
        task=TaskType[task], optimizer_type=OptimizerType[optimizer],
        optimizer_config=OptimizerConfig(max_iterations=iterations),
        regularization=RegularizationContext(
            RegularizationType[reg],
            **({"elastic_net_alpha": 0.5} if alpha else {})),
        reg_weight=0.3, variance_type=VarianceComputationType[variance],
        reg_mask=intercept_reg_mask(DIM, 0))
    j = JaxProblem(
        task=JaxTask[task], optimizer_type=JaxOptimizer[optimizer],
        optimizer_config=JaxConfig(max_iterations=iterations),
        regularization=JaxReg(JaxRegType[reg],
                              **({"elastic_net_alpha": 0.5} if alpha else {})),
        reg_weight=0.3, variance_type=JaxVariance[variance],
        reg_mask=jax_mask(DIM, 0))
    return p, j


def port_mesh(n=4):
    return make_mesh({"data": n}, devices=[CPU] * n)


def jax_mesh(n=4):
    return jax_make_mesh({"data": n}, devices=jax.devices()[:n])


def assert_same(port, ref, atol, what):
    (pm_, pr), (rm, rr) = port, ref
    np.testing.assert_allclose(pm_.coefficients.means.numpy(),
                               np.asarray(rm.coefficients.means),
                               rtol=0, atol=atol, err_msg=what)
    assert int(pr.iterations) == int(rr.iterations), what
    assert int(pr.converged_reason) == int(rr.converged_reason), what


CASES = [
    ("LOGISTIC_REGRESSION", "LBFGS", "L2"),
    ("LOGISTIC_REGRESSION", "TRON", "L2"),
    ("LOGISTIC_REGRESSION", "OWLQN", "ELASTIC_NET"),
    ("POISSON_REGRESSION", "LBFGS", "L2"),
    ("POISSON_REGRESSION", "TRON", "L2"),
    ("POISSON_REGRESSION", "OWLQN", "L1"),
    ("LINEAR_REGRESSION", "LBFGS", "L2"),
]


@pytest.mark.parametrize("task,optimizer,reg", CASES,
                         ids=["-".join(c) for c in CASES])
def test_fit_spmd_matches_single_device_and_jax(task, optimizer, reg):
    pb, jb = batches(task)
    p, j = problems(task, optimizer, reg)
    w0 = torch.zeros(DIM, dtype=torch.float64)
    one = p.run(pb, w0)
    four = fit_spmd(p, pb, w0, port_mesh())
    assert_same(four, one, 1e-12, "port 4 shards vs 1 device")
    jfit = jax_fit_spmd(j, jb, jnp.zeros(DIM), jax_mesh())
    assert_same(four, jfit, 1e-8 if optimizer == "OWLQN" else 1e-9,
                "port vs JAX fit_spmd")
    jone = j.run(jb, jnp.zeros(DIM))
    gap_mesh = four[0].coefficients.means.numpy() - np.asarray(
        jfit[0].coefficients.means)
    gap_one = one[0].coefficients.means.numpy() - np.asarray(
        jone[0].coefficients.means)
    np.testing.assert_allclose(gap_mesh, gap_one, rtol=0, atol=1e-12)


@pytest.mark.parametrize("ntype", ["STANDARDIZATION", "SCALE_WITH_MAX_MAGNITUDE"])
@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_fit_data_parallel_with_normalization_and_variances(ntype, optimizer):
    """The JAX package's GSPMD ``fit_data_parallel`` takes a normalization
    context and computes variances; the port's one implementation does
    too."""
    pb, jb = batches("LOGISTIC_REGRESSION", seed=1)
    p, j = problems("LOGISTIC_REGRESSION", optimizer, variance="SIMPLE")
    pctx = context_from_statistics(compute_feature_statistics(pb),
                                   NormalizationType[ntype], 0)
    jctx = jax_context(jax_stats(jb), JaxNormType[ntype], 0)
    w0 = torch.zeros(DIM, dtype=torch.float64)
    one = p.run(pb, w0, normalization=pctx)
    four = fit_data_parallel(p, pb, w0, port_mesh(), normalization=pctx)
    assert_same(four, one, 1e-12, "port 4 shards vs 1 device")
    np.testing.assert_allclose(four[0].coefficients.variances.numpy(),
                               one[0].coefficients.variances.numpy(),
                               rtol=1e-12)
    jfit = jax_fit_dp(j, jb, jnp.zeros(DIM), jax_mesh(), normalization=jctx)
    assert_same(four, jfit, 1e-9, "port vs JAX fit_data_parallel")
    np.testing.assert_allclose(four[0].coefficients.variances.numpy(),
                               np.asarray(jfit[0].coefficients.variances),
                               rtol=1e-10)


def test_full_variances_under_a_mesh():
    pb, _ = batches("POISSON_REGRESSION", seed=2)
    p, _ = problems("POISSON_REGRESSION", "LBFGS", variance="FULL")
    w0 = torch.zeros(DIM, dtype=torch.float64)
    one = p.run(pb, w0)
    four = fit_data_parallel(p, pb, w0, port_mesh())
    np.testing.assert_allclose(four[0].coefficients.variances.numpy(),
                               one[0].coefficients.variances.numpy(), rtol=1e-10)


def test_spmd_value_and_grad_entry_point():
    pb, jb = batches("LOGISTIC_REGRESSION", seed=3)
    p, _ = problems("LOGISTIC_REGRESSION", "LBFGS")
    obj = p.objective()
    vg = spmd_value_and_grad(obj, pb, port_mesh())
    w = torch.from_numpy(np.random.default_rng(5).normal(size=DIM))
    v1, g1 = obj.value_and_grad(w, pb)
    v2, g2 = vg(w)
    np.testing.assert_allclose(float(v2), float(v1), rtol=1e-13)
    np.testing.assert_allclose(g2.numpy(), g1.numpy(), rtol=0, atol=1e-12)


def test_multislice_mesh_fit_matches_jax():
    """Rows sharded over ``("dcn", "data")`` of a 2 x 2 mesh, as the JAX
    package's multi-slice deployment shards them."""
    pb, jb = batches("LOGISTIC_REGRESSION", seed=4)
    p, j = problems("LOGISTIC_REGRESSION", "LBFGS")
    w0 = torch.zeros(DIM, dtype=torch.float64)
    mesh = make_multislice_mesh(2, {"data": 2}, devices=[CPU] * 4)
    four = fit_spmd(p, pb, w0, mesh, data_axis=("dcn", "data"))
    one = p.run(pb, w0)
    assert_same(four, one, 1e-12, "2 x 2 vs 1 device")
    jmesh = jax_multislice(2, {"data": 2}, devices=jax.devices()[:4])
    jfit = jax_fit_spmd(j, jb, jnp.zeros(DIM), jmesh, data_axis=("dcn", "data"))
    assert_same(four, jfit, 1e-9, "port vs JAX on the 2 x 2 mesh")


def test_l1_needs_owlqn_under_a_mesh():
    pb, _ = batches("LOGISTIC_REGRESSION")
    p, _ = problems("LOGISTIC_REGRESSION", "LBFGS", reg="L1")
    with pytest.raises(ValueError, match="requires OptimizerType.OWLQN"):
        fit_spmd(p, pb, torch.zeros(DIM, dtype=torch.float64), port_mesh())


def test_fixed_effect_coordinate_under_a_mesh_reuses_its_shards():
    """A coordinate-descent fixed effect cuts its batch into shards once and
    re-cuts only the offsets each step; each step equals the unsharded
    coordinate's."""
    from photon_tpu_torch.game.coordinates import FixedEffectCoordinate
    from photon_tpu_torch.parallel import mesh as pmesh

    pb, _ = batches("LOGISTIC_REGRESSION", seed=6)
    p, _ = problems("LOGISTIC_REGRESSION", "LBFGS")
    one = FixedEffectCoordinate(batch=pb, problem=p)
    four = dataclasses.replace(one, mesh=port_mesh())
    rng = np.random.default_rng(7)
    cut = []
    for _ in range(2):
        off = torch.from_numpy(rng.normal(size=N) * 0.2)
        m1, _ = one.train(off)
        m4, _ = four.train(off)
        np.testing.assert_allclose(m4.model.coefficients.means.numpy(),
                                   m1.model.coefficients.means.numpy(),
                                   rtol=0, atol=1e-12)
        cut.append(pmesh.cached_row_shards(pb, four.mesh))
    assert cut[0] is cut[1]
