"""f32 solves of the PyTorch port against the JAX package's, on the CPU.

    JAX_PLATFORMS=cpu python scripts/f32_stopping_vs_jax.py

Equal float32 inputs (numpy, fixed seeds) go through both packages'
fixed-effect L-BFGS (logistic, L2 weight 1, 40 iterations; the incremental
score path) and primal Newton random-effect bucket solve (30 iterations), at
the default tolerance 1e-7 and at 1e-5. Printed per seed: each side's
iterations, reason and data passes, the iteration at which the two objective
tracks first differ and by how many float32 ulps, and the coefficients' gap
over the largest; for the Newton bucket, the lanes whose iterations or
reasons differ. The port's CPU passes sum in float64 and round once (as its
CUDA kernels do) and torch reduces in another order than XLA, so the f32
objectives differ in their last bits from the first iteration on; a
tolerance of 1e-7 tests changes of one ulp of an objective of ~1e3.
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from photon_tpu.data.batch import LabeledBatch as JaxBatch  # noqa: E402
from photon_tpu.data.batch import SparseFeatures as JaxFeatures  # noqa: E402
from photon_tpu.data.random_effect import build_random_effect_dataset as jax_build  # noqa: E402
from photon_tpu.functions.problem import GLMOptimizationProblem as JaxProblem  # noqa: E402
from photon_tpu.game import newton_re as jnr  # noqa: E402
from photon_tpu.optim import OptimizerConfig as JaxConfig  # noqa: E402
from photon_tpu.optim import RegularizationContext as JaxReg  # noqa: E402
from photon_tpu.optim import RegularizationType as JaxRegType  # noqa: E402
from photon_tpu.types import TaskType as JaxTask  # noqa: E402
from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures  # noqa: E402
from photon_tpu_torch.data.random_effect import build_random_effect_dataset  # noqa: E402
from photon_tpu_torch.functions.problem import GLMOptimizationProblem  # noqa: E402
from photon_tpu_torch.game import newton_re as tnr  # noqa: E402
from photon_tpu_torch.optim import (  # noqa: E402
    OptimizerConfig,
    RegularizationContext,
    RegularizationType,
)
from photon_tpu_torch.types import TaskType  # noqa: E402


def fixed_data(seed, n=2000, dim=300, k=8):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, dim, size=(n, k)).astype(np.int32)
    val = (rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32)
    w = rng.normal(size=dim)
    z = (val * w[idx]).sum(1)
    y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float32)
    off = (rng.normal(size=n) * 0.1).astype(np.float32)
    return idx, val, y, off, dim


def problems(tol, max_iter):
    jp = JaxProblem(task=JaxTask.LOGISTIC_REGRESSION,
                    optimizer_config=JaxConfig(max_iterations=max_iter, tolerance=tol),
                    regularization=JaxReg(JaxRegType.L2), reg_weight=1.0)
    tp = GLMOptimizationProblem(
        task=TaskType.LOGISTIC_REGRESSION,
        optimizer_config=OptimizerConfig(max_iterations=max_iter, tolerance=tol),
        regularization=RegularizationContext(RegularizationType.L2), reg_weight=1.0)
    return jp, tp


def fixed_effect(seed, tol):
    idx, val, y, off, dim = fixed_data(seed)
    ones = np.ones(len(y), np.float32)
    jb = JaxBatch(JaxFeatures(jnp.asarray(idx), jnp.asarray(val), dim), jnp.asarray(y),
                  jnp.asarray(off), jnp.asarray(ones))
    tb = LabeledBatch(SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), dim),
                      torch.from_numpy(y), torch.from_numpy(off), torch.from_numpy(ones))
    jp, tp = problems(tol, 40)
    jm, jr = jp.run(jb, jnp.zeros(dim, jnp.float32))
    tm, tr = tp.run(tb, torch.zeros(dim))
    n = min(int(jr.iterations), tr.iterations) + 1
    jv, tv = np.asarray(jr.values)[:n], tr.values.numpy()[:n]
    ulps = np.abs(jv - tv) / np.spacing(np.abs(jv))
    differ = np.flatnonzero(jv != tv)
    jw = np.asarray(jm.coefficients.means)
    return {"iterations": (int(jr.iterations), tr.iterations),
            "reasons": (int(jr.converged_reason), tr.converged_reason),
            "data_passes": (int(jr.data_passes), tr.data_passes),
            "first_differing_iteration": int(differ[0]) if differ.size else None,
            "max_value_ulps": float(ulps.max()),
            "coef_rel_err": float(np.abs(jw - tm.coefficients.means.numpy()).max()
                                  / np.abs(jw).max())}


def newton_bucket(seed, tol):
    rng = np.random.default_rng(seed)
    dim, rows = 40, []
    keys, idx, val, y = [], [], [], []
    for e in range(40):
        sup = rng.choice(dim, size=rng.integers(10, 18), replace=False)
        w = rng.normal(size=dim)
        for _ in range(rng.integers(3, 9)):
            cols = rng.choice(sup, size=5, replace=False)
            v = rng.normal(size=5)
            y.append(float(rng.random() < 1 / (1 + np.exp(-float(v @ w[cols])))))
            idx.append(cols)
            val.append(v)
            keys.append(f"e{e:02d}")
    idx = np.asarray(idx, np.int32)
    val = np.asarray(val, np.float32)
    y = np.asarray(y, np.float32)
    keys = np.asarray(keys, object)
    off = (rng.normal(size=len(y)) * 0.3).astype(np.float32)
    jd = jax_build("re", keys, idx, val, y, dim, dtype=np.float32)
    td = build_random_effect_dataset("re", keys, idx, val, y, dim, dtype=torch.float32,
                                     device=torch.device("cpu"))
    b = int(np.argmax([bb.n_entities for bb in jd.buckets]))
    jb, tb = jd.buckets[b], td.buckets[b]
    e, p = jb.proj.shape
    jp, tp = problems(tol, 30)
    jm, jr = jnr.fit_bucket_newton(jp, jb.local_batches(jnp.asarray(off)),
                                   jnp.zeros((e, p), jnp.float32),
                                   jnp.ones((e, p), jnp.float32), None)
    tm, tr = tnr.fit_bucket_newton(tp, tb.local_batches(torch.from_numpy(off)),
                                   torch.zeros((e, p)), torch.ones((e, p)), None)
    jw = np.asarray(jm.coefficients.means)
    return {"lanes": e,
            "iterations_apart": int((np.asarray(jr.iterations) != tr.iterations.numpy()).sum()),
            "reasons_apart": int((np.asarray(jr.converged_reason)
                                  != tr.converged_reason.numpy()).sum()),
            "coef_rel_err": float(np.abs(jw - tm.coefficients.means.numpy()).max()
                                  / np.abs(jw).max())}


def main():
    for tol in (1e-7, 1e-5):
        for seed in range(6):
            print(f"tol {tol:g} seed {seed} fixed effect:", fixed_effect(seed, tol))
        for seed in range(4):
            print(f"tol {tol:g} seed {seed} Newton bucket:", newton_bucket(seed, tol))


if __name__ == "__main__":
    main()
