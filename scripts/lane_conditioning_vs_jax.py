"""How reproducible a STANDARDIZATION GAME fit on sparse columns can be.

    JAX_PLATFORMS=cpu python scripts/lane_conditioning_vs_jax.py [USERS]

On ``chip_smoke.py``'s fit C data (``vm_arrays``: ``bench_game_scale``'s
rows with an intercept on the global shard) at USERS users (default
1,024), in float64 on the CPU, the JAX package and the PyTorch port run
(1) one random-effect step, per user over the global shard, with the
shard's STANDARDIZATION context, L-BFGS L2 weight 1, 15 iterations and
then 200; and (2) the whole fit C (fixed + random effect, down-sampling
0.5, 2 sweeps, 15 iterations), also on offsets moved by ±1e-15. Printed:
the context's factor range, each result's coefficient gap over the largest
with the lanes whose iterations differ, and how far each package's whole
fit moves on the moved offsets. Equal arithmetic up to rounding order gives gaps far
above f64 rounding when the factors reach ~1e4: the configuration's
conditioning, in either package.
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from photon_tpu.data.batch import LabeledBatch as JaxBatch  # noqa: E402
from photon_tpu.data.batch import SparseFeatures as JaxFeatures  # noqa: E402
from photon_tpu.data.normalization import NormalizationType as JaxNorm  # noqa: E402
from photon_tpu.data.normalization import context_from_statistics as jax_context  # noqa: E402
from photon_tpu.data.random_effect import build_random_effect_dataset as jax_build  # noqa: E402
from photon_tpu.data.statistics import compute_feature_statistics as jax_stats  # noqa: E402
from photon_tpu.estimators.config import FixedEffectDataConfig as JaxFixed  # noqa: E402
from photon_tpu.estimators.config import GLMOptimizationConfiguration as JaxOpt  # noqa: E402
from photon_tpu.estimators.config import RandomEffectDataConfig as JaxRandom  # noqa: E402
from photon_tpu.estimators.game_estimator import GameEstimator as JaxEstimator  # noqa: E402
from photon_tpu.functions.problem import GLMOptimizationProblem as JaxProblem  # noqa: E402
from photon_tpu.game import random_effect as jre  # noqa: E402
from photon_tpu.io.data_reader import GameDataBundle as JaxBundle  # noqa: E402
from photon_tpu.optim import OptimizerConfig as JaxConfig  # noqa: E402
from photon_tpu.optim import RegularizationContext as JaxReg  # noqa: E402
from photon_tpu.optim import RegularizationType as JaxRegType  # noqa: E402
from photon_tpu.types import TaskType as JaxTask  # noqa: E402
from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures  # noqa: E402
from photon_tpu_torch.data.normalization import (  # noqa: E402
    NormalizationType,
    context_from_statistics,
)
from photon_tpu_torch.data.random_effect import build_random_effect_dataset  # noqa: E402
from photon_tpu_torch.data.statistics import compute_feature_statistics  # noqa: E402
from photon_tpu_torch.functions.problem import GLMOptimizationProblem  # noqa: E402
from photon_tpu_torch.game import random_effect as tre  # noqa: E402
from photon_tpu_torch.optim import (  # noqa: E402
    OptimizerConfig,
    RegularizationContext,
    RegularizationType,
)
from photon_tpu_torch.types import TaskType  # noqa: E402

CPU = torch.device("cpu")
PERTURBATION = 1e-15     # a few ulps of the margins


def gap(a, b) -> float:
    a = np.asarray(a)
    return float(np.abs(a - np.asarray(b)).max() / np.abs(a).max())


def one_step(a):
    idx, val, dim = a["idx"], a["val"].astype(np.float64), a["dim"]
    n, gi = len(a["labels"]), a["global_intercept"]
    z, ones = np.zeros(n), np.ones(n)
    jctx = jax_context(jax_stats(JaxBatch(
        JaxFeatures(jnp.asarray(idx), jnp.asarray(val), dim), jnp.asarray(a["labels"]),
        jnp.asarray(z), jnp.asarray(ones))), JaxNorm.STANDARDIZATION, gi)
    tctx = context_from_statistics(compute_feature_statistics(LabeledBatch(
        SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), dim),
        torch.from_numpy(a["labels"]), torch.from_numpy(z), torch.from_numpy(ones))),
        NormalizationType.STANDARDIZATION, gi)
    print(f"factors: {tctx.factors.min().item():.3g} .. {tctx.factors.max().item():.4g}")
    jd = jax_build("u", a["keys"], idx, val, a["labels"], dim, intercept_index=gi,
                   dtype=np.float64)
    td = build_random_effect_dataset("u", a["keys"], idx, val, a["labels"], dim,
                                     intercept_index=gi, dtype=torch.float64, device=CPU)
    mask = np.ones(dim)
    mask[gi] = 0.0
    for iters in (15, 200):
        jp = JaxProblem(task=JaxTask.LOGISTIC_REGRESSION,
                        optimizer_config=JaxConfig(max_iterations=iters),
                        regularization=JaxReg(JaxRegType.L2), reg_weight=1.0)
        tp = GLMOptimizationProblem(
            task=TaskType.LOGISTIC_REGRESSION,
            optimizer_config=OptimizerConfig(max_iterations=iters),
            regularization=RegularizationContext(RegularizationType.L2), reg_weight=1.0)
        jm, jr = jre.train_random_effects(jp, jd, jnp.zeros(n),
                                          global_reg_mask=jnp.asarray(mask),
                                          normalization=jctx)
        tm, tr = tre.train_random_effects(tp, td, torch.zeros(n, dtype=torch.float64),
                                          global_reg_mask=torch.from_numpy(mask),
                                          normalization=tctx)
        for x, y, r1, r2 in zip(jm.bucket_coefs, tm.bucket_coefs, jr, tr):
            it = np.asarray(r1.iterations)
            print(f"one RE step, {iters} iterations: gap {gap(x, y.numpy()):.3g}, "
                  f"lanes apart {int((it != r2.iterations.numpy()).sum())}, "
                  f"iterations median {np.median(it)} max {it.max()}")


def whole_fit(a, iters=15, offsets=None):
    """Fit C in both packages on the CPU in float64: (JAX's, the port's)
    coefficient tensors, fixed effect first."""
    n = len(a["labels"])
    off = np.zeros(n) if offsets is None else offsets
    jb = JaxBundle(
        features={"global": JaxFeatures(jnp.asarray(a["idx"]),
                                        jnp.asarray(a["val"].astype(np.float64)), a["dim"])},
        labels=a["labels"], offsets=off, weights=np.ones(n),
        uids=np.arange(n).astype(object), id_tags={"userId": a["keys"]})
    opt = JaxOpt(regularization=JaxReg(JaxRegType.L2), reg_weight=1.0,
                 max_iterations=iters, down_sampling_rate=0.5)
    jest = JaxEstimator(JaxTask.LOGISTIC_REGRESSION,
                        {"fixed": JaxFixed("global"), "perUser": JaxRandom("userId", "global")},
                        n_sweeps=2, normalization=JaxNorm.STANDARDIZATION,
                        intercept_indices={"global": a["global_intercept"]})
    jm = jest.fit(jb, None, [{"fixed": opt, "perUser": opt}])[0].model
    tm = chip_smoke.vm_estimator(a, "global", "STANDARDIZATION", ()).fit(
        chip_smoke.game_bundle(torch, a, CPU, torch.float64, off), None,
        chip_smoke.vm_configs(("LBFGS", "L2"), ("LBFGS", "L2"), "NONE", 0.5, iters))[0].model
    return ([np.asarray(jm["fixed"].model.coefficients.means)]
            + [np.asarray(x) for x in jm["perUser"].bucket_coefs],
            [tm["fixed"].model.coefficients.means.numpy()]
            + [y.numpy() for y in tm["perUser"].bucket_coefs])


def coef_gaps(a, b) -> str:
    return (f"fixed effect {gap(a[0], b[0]):.3g}, random effect "
            f"{max(gap(x, y) for x, y in zip(a[1:], b[1:])):.3g}")


def main():
    users = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    a = chip_smoke.vm_arrays(dict(chip_smoke.GAME), users, 2, True)
    one_step(a)
    jax_fit, port_fit = whole_fit(a)
    print(f"whole fit, JAX against the port: {coef_gaps(jax_fit, port_fit)}")
    # the same fit on offsets moved by ±PERTURBATION: each package against
    # itself
    pert = np.random.default_rng(14).choice([-PERTURBATION, PERTURBATION],
                                            size=len(a["labels"]))
    jax_moved, port_moved = whole_fit(a, offsets=pert)
    print(f"whole fit, JAX against JAX on moved offsets: {coef_gaps(jax_moved, jax_fit)}")
    print(f"whole fit, the port against the port on moved offsets: "
          f"{coef_gaps(port_moved, port_fit)}")


if __name__ == "__main__":
    main()
