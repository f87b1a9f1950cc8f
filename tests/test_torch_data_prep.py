"""The port's data preparation against the JAX package's.

From the same numpy data, in float64 with x64 on, on the CPU:

* ``compute_feature_statistics`` on dense and sparse batches, with
  weight-0 rows and columns no row touches, within 1e-12;
* ``context_from_statistics`` for all four normalization types, and the
  coefficient maps of the shard and the local contexts: the port's equal
  JAX's, they round-trip, and the port's written-out adjoint equals
  ``jax.vjp`` of the map; the normalized objective, gradient and H·v
  lifted through them;
* ``utils/threefry.py``'s ``PRNGKey`` / ``fold_in`` / ``uniform`` bit-equal to
  ``jax.random`` in float32 and float64, for ``[N]`` and ``[E, S]``;
* down-sampled weights (both samplers, a fixed-effect batch and a
  random-effect dataset), ``compact`` and ``DenseFeatures``' passes.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from photon_tpu.data import normalization as jn
from photon_tpu.data import sampling as js
from photon_tpu.data.batch import DenseFeatures as JaxDense
from photon_tpu.data.batch import LabeledBatch as JaxBatch
from photon_tpu.data.batch import SparseFeatures as JaxSparse
from photon_tpu.data.random_effect import build_random_effect_dataset as jax_build
from photon_tpu.data.random_effect import down_sample_dataset as jax_down_sample_dataset
from photon_tpu.data.statistics import compute_feature_statistics as jax_stats
from photon_tpu.functions.problem import GLMOptimizationProblem as JaxProblem
from photon_tpu.functions.problem import VarianceComputationType as JaxVariance
from photon_tpu.optim import OptimizerConfig as JaxConfig
from photon_tpu.optim import OptimizerType as JaxOptimizer
from photon_tpu.optim import RegularizationContext as JaxReg
from photon_tpu.optim import RegularizationType as JaxRegType
from photon_tpu.types import TaskType as JaxTask
from photon_tpu_torch.data import normalization as tn
from photon_tpu_torch.data import sampling as ts
from photon_tpu_torch.data.batch import DenseFeatures, LabeledBatch, SparseFeatures
from photon_tpu_torch.data.random_effect import (
    build_random_effect_dataset,
    down_sample_dataset,
)
from photon_tpu_torch.data.statistics import compute_feature_statistics
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
from photon_tpu_torch.types import TaskType
from photon_tpu_torch.utils import threefry

CPU = torch.device("cpu")
STAT_TOL = 1e-12


def sparse_arrays(seed=0, n=60, dim=25, k=4):
    """ELL rows over ``dim`` columns (the last three untouched), one
    duplicate-free row set, ghost-padded slots, some weight-0 rows."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(dim - 3, size=k, replace=False) for _ in range(n)])
    idx[rng.random((n, k)) < 0.2] = dim                  # ghost slots
    val = rng.normal(size=(n, k)) * 2.0
    val[idx == dim] = 0.0
    val[3, 0] = 0.0                                      # an explicit zero
    labels = (rng.random(n) < 0.4).astype(np.float64)
    weights = rng.uniform(0.5, 2.0, size=n)
    weights[[1, 7, 20]] = 0.0
    return idx.astype(np.int32), val, labels, weights, dim


def batches(idx, val, labels, weights, dim, offsets=None):
    offsets = np.zeros(len(labels)) if offsets is None else offsets
    jb = JaxBatch(JaxSparse(jnp.asarray(idx), jnp.asarray(val), dim),
                  jnp.asarray(labels), jnp.asarray(offsets), jnp.asarray(weights))
    tb = LabeledBatch(SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), dim),
                      torch.from_numpy(labels), torch.from_numpy(offsets),
                      torch.from_numpy(weights))
    return jb, tb


def dense_batches(x, labels, weights):
    z = np.zeros(len(labels))
    jb = JaxBatch(JaxDense(jnp.asarray(x)), jnp.asarray(labels), jnp.asarray(z),
                  jnp.asarray(weights))
    tb = LabeledBatch(DenseFeatures(torch.from_numpy(x)), torch.from_numpy(labels),
                      torch.from_numpy(z), torch.from_numpy(weights))
    return jb, tb


def assert_stats_equal(js_, ts_):
    for f in ("mean", "variance", "min", "max", "num_nonzeros"):
        np.testing.assert_allclose(getattr(ts_, f).numpy(), np.asarray(getattr(js_, f)),
                                   rtol=STAT_TOL, atol=STAT_TOL, err_msg=f)
    assert float(ts_.count) == float(js_.count)


@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_feature_statistics_match_jax(kind):
    idx, val, labels, weights, dim = sparse_arrays()
    if kind == "sparse":
        jb, tb = batches(idx, val, labels, weights, dim)
    else:
        x = np.zeros((len(labels), dim))
        for r in range(len(labels)):
            for c, v in zip(idx[r], val[r]):
                if c < dim:
                    x[r, c] += v
        x[:, dim - 1] = 0.0
        jb, tb = dense_batches(x, labels, weights)
    jst, tst = jax_stats(jb), compute_feature_statistics(tb)
    assert_stats_equal(jst, tst)
    # untouched columns read 0; a column with implicit zeros has min <= 0
    assert (tst.min.numpy()[-3:] == 0).all() and (tst.max.numpy()[-3:] == 0).all()
    assert tst.count.item() == 57


@pytest.mark.parametrize("ntype", [t.name for t in tn.NormalizationType])
def test_contexts_from_statistics_match_jax(ntype):
    idx, val, labels, weights, dim = sparse_arrays(1)
    idx[:, 0] = 0                                        # column 0: the intercept
    val[:, 0] = 1.0
    jb, tb = batches(idx, val, labels, weights, dim)
    jctx = jn.context_from_statistics(jax_stats(jb), jn.NormalizationType[ntype], 0)
    tctx = tn.context_from_statistics(compute_feature_statistics(tb),
                                      tn.NormalizationType[ntype], 0)
    assert tctx.is_identity == jctx.is_identity
    for f in ("factors", "shifts"):
        a, b = getattr(jctx, f), getattr(tctx, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=STAT_TOL, atol=0)
    if ntype == "STANDARDIZATION":
        with pytest.raises(ValueError, match="intercept"):
            tn.context_from_statistics(compute_feature_statistics(tb),
                                       tn.NormalizationType.STANDARDIZATION, None)


def _shard_contexts(dim, seed, shifts=True):
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.3, 3.0, size=dim)
    s = rng.normal(size=dim) if shifts else None
    jctx = jn.NormalizationContext(jnp.asarray(f), None if s is None else jnp.asarray(s), 2)
    tctx = tn.NormalizationContext(torch.from_numpy(f),
                                   None if s is None else torch.from_numpy(s), 2)
    return jctx, tctx


@pytest.mark.parametrize("shifts", [True, False], ids=["factors_shifts", "factors"])
def test_coefficient_maps_and_adjoint_match_jax(shifts):
    dim = 9
    jctx, tctx = _shard_contexts(dim, 3, shifts)
    rng = np.random.default_rng(4)
    w, g = rng.normal(size=dim), rng.normal(size=dim)
    # shard context: the maps, the round trip, the adjoint against jax.vjp
    jo = np.asarray(jctx.coef_to_original(jnp.asarray(w)))
    to = tctx.coef_to_original(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(to, jo, rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(
        tctx.coef_to_transformed(torch.from_numpy(to)).numpy(), w, rtol=1e-12, atol=1e-12)
    _, pull = jax.vjp(jctx.coef_to_original, jnp.asarray(w))
    np.testing.assert_allclose(tctx.coef_adjoint(torch.from_numpy(g)).numpy(),
                               np.asarray(pull(jnp.asarray(g))[0]), rtol=1e-14, atol=1e-14)
    # local contexts over [E, P] lanes (ghost slots at dim; lane 1 has no
    # intercept slot)
    proj = np.array([[2, 0, 5, dim], [1, 4, 8, 7], [6, 2, dim, dim]], np.int32)
    jl = jn.project_context(jctx, jnp.asarray(proj), dim)
    tl = tn.project_context(tctx, torch.from_numpy(proj), dim)
    for f in ("factors", "shifts", "intercept_onehot"):
        a, b = getattr(jl, f), getattr(tl, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)
    wl, gl = rng.normal(size=proj.shape), rng.normal(size=proj.shape)
    jol = np.asarray(jax.vmap(lambda c, w_: c.coef_to_original(w_))(jl, jnp.asarray(wl)))
    tol_ = tl.coef_to_original(torch.from_numpy(wl)).numpy()
    np.testing.assert_allclose(tol_, jol, rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(tl.coef_to_transformed(torch.from_numpy(tol_)).numpy(), wl,
                               rtol=1e-12, atol=1e-12)
    jadj = jax.vmap(lambda c, w_, g_: jax.vjp(c.coef_to_original, w_)[1](g_)[0])(
        jl, jnp.asarray(wl), jnp.asarray(gl))
    np.testing.assert_allclose(tl.coef_adjoint(torch.from_numpy(gl)).numpy(),
                               np.asarray(jadj), rtol=1e-14, atol=1e-14)
    # a lifted H·v (H = diag(d)) against JAX's wrap_hvp
    d = rng.uniform(0.5, 2.0, size=dim)
    v = rng.normal(size=dim)
    jhv = jctx.wrap_hvp(lambda x, u: jnp.asarray(d) * u)(jnp.asarray(w), jnp.asarray(v))
    thv = tctx.wrap_hvp(lambda x, u: torch.from_numpy(d) * u)(torch.from_numpy(w),
                                                              torch.from_numpy(v))
    np.testing.assert_allclose(thv.numpy(), np.asarray(jhv), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("optimizer", ["LBFGS", "OWLQN", "TRON"])
def test_normalized_fixed_effect_matches_jax(optimizer):
    """``problem.run`` under a STANDARDIZATION context: the data term
    through the coefficient map, L2 in the transformed space, SIMPLE
    variances of the original-space coefficients."""
    idx, val, labels, weights, dim = sparse_arrays(5, n=80)
    idx[:, 0], val[:, 0] = 2, 1.0                        # column 2: the intercept
    offsets = np.random.default_rng(6).normal(size=len(labels)) * 0.2
    jb, tb = batches(idx, val, labels, weights, dim, offsets)
    jctx = jn.context_from_statistics(jax_stats(jb), jn.NormalizationType.STANDARDIZATION, 2)
    tctx = tn.context_from_statistics(compute_feature_statistics(tb),
                                      tn.NormalizationType.STANDARDIZATION, 2)
    reg = "L1" if optimizer == "OWLQN" else "L2"
    mask = np.ones(dim)
    mask[2] = 0.0
    jp = JaxProblem(task=JaxTask.LOGISTIC_REGRESSION, optimizer_type=JaxOptimizer[optimizer],
                    optimizer_config=JaxConfig(max_iterations=50),
                    regularization=JaxReg(JaxRegType[reg]), reg_weight=0.6,
                    reg_mask=jnp.asarray(mask), variance_type=JaxVariance.SIMPLE)
    tp = GLMOptimizationProblem(
        task=TaskType.LOGISTIC_REGRESSION, optimizer_type=OptimizerType[optimizer],
        optimizer_config=OptimizerConfig(max_iterations=50),
        regularization=RegularizationContext(RegularizationType[reg]), reg_weight=0.6,
        reg_mask=torch.from_numpy(mask), variance_type=VarianceComputationType.SIMPLE)
    w0 = np.random.default_rng(8).normal(size=dim) * 0.1
    jm, jr = jp.run(jb, jnp.asarray(w0), normalization=jctx)
    tm, tr = tp.run(tb, torch.from_numpy(w0), normalization=tctx)
    assert tr.iterations == int(jr.iterations)
    assert tr.converged_reason == int(jr.converged_reason)
    assert tr.data_passes == int(jr.data_passes)
    jw = np.asarray(jm.coefficients.means)
    assert np.abs(tm.coefficients.means.numpy() - jw).max() <= 1e-9 * np.abs(jw).max()
    np.testing.assert_allclose(tm.coefficients.variances.numpy(),
                               np.asarray(jm.coefficients.variances), rtol=1e-9)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", [(1001,), (37, 16)], ids=["N", "ExS"])
def test_threefry_is_bit_equal_to_jax_random(dtype, shape):
    for seed in (0, 42, 2**40 + 3):
        jk = jax.random.PRNGKey(seed)
        tk = threefry.PRNGKey(seed)
        np.testing.assert_array_equal(tk, np.asarray(jk))
        for data in (0, 5, 2**31 + 7):
            jk2 = jax.random.fold_in(jax.random.fold_in(jk, data), 3)
            tk2 = threefry.fold_in(threefry.fold_in(tk, data), 3)
            np.testing.assert_array_equal(tk2, np.asarray(jk2))
            want = np.asarray(jax.random.uniform(jk2, shape, dtype=dtype))
            got = threefry.uniform(tk2, shape, dtype)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rate", [0.5, 0.3])
@pytest.mark.parametrize("task", ["LOGISTIC_REGRESSION", "LINEAR_REGRESSION"])
def test_down_sampled_weights_are_bit_equal(task, rate):
    idx, val, labels, weights, dim = sparse_arrays(2, n=300)
    jb, tb = batches(idx, val, labels, weights, dim)
    key = jax.random.fold_in(jax.random.PRNGKey(7), 1)
    tkey = threefry.fold_in(threefry.PRNGKey(7), 1)
    js_s = js.down_sampler_for_task(JaxTask[task], rate)
    ts_s = ts.down_sampler_for_task(TaskType[task], rate)
    assert type(ts_s).__name__ == type(js_s).__name__
    jw = np.asarray(js_s.down_sample(key, jb).weights)
    tw = ts_s.down_sample(tkey, tb).weights.numpy()
    np.testing.assert_array_equal(tw, jw)
    kept = (tw != 0) & (weights != 0)
    assert 0 < kept.sum() < (weights != 0).sum()
    # compact keeps the same rows as JAX's
    jc, tc = js.compact(js_s.down_sample(key, jb), 64), ts.compact(
        ts_s.down_sample(tkey, tb), 64)
    for a, b in ((jc.features.idx, tc.features.idx), (jc.features.val, tc.features.val),
                 (jc.labels, tc.labels), (jc.weights, tc.weights)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_down_sampled_random_effect_dataset_is_bit_equal():
    rng = np.random.default_rng(3)
    n, dim = 200, 30
    idx = rng.integers(0, dim, size=(n, 3)).astype(np.int32)
    val = rng.normal(size=(n, 3))
    labels = (rng.random(n) < 0.5).astype(np.float64)
    keys = np.array([f"e{i}" for i in rng.integers(0, 25, size=n)], object)
    jd = jax_build("re", keys, idx, val, labels, dim, dtype=np.float64)
    td = build_random_effect_dataset("re", keys, idx, val, labels, dim,
                                     dtype=torch.float64, device=CPU)
    key = jax.random.PRNGKey(11)
    jds = jax_down_sample_dataset(jd, js.BinaryClassificationDownSampler(0.4), key)
    tds = down_sample_dataset(td, ts.BinaryClassificationDownSampler(0.4),
                              threefry.PRNGKey(11))
    assert len(tds.buckets) == len(jds.buckets) > 1
    for a, b, orig in zip(jds.buckets, tds.buckets, td.buckets):
        np.testing.assert_array_equal(b.train_weights.numpy(), np.asarray(a.train_weights))
        assert b.idx is orig.idx and b.weights is orig.weights
    assert tds.lane_layouts is td.lane_layouts


def test_dense_features_passes_match_jax():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(13, 6))
    w, v = rng.normal(size=6), rng.normal(size=13)
    jf, tf = JaxDense(jnp.asarray(x)), DenseFeatures(torch.from_numpy(x))
    for name, arg in (("matvec", w), ("rmatvec", v), ("sq_rmatvec", v)):
        np.testing.assert_allclose(getattr(tf, name)(torch.from_numpy(arg)).numpy(),
                                   np.asarray(getattr(jf, name)(jnp.asarray(arg))),
                                   rtol=1e-14, atol=1e-14)
