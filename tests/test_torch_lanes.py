"""The port's masked batched lanes against the JAX package's vmapped solve.

The same numpy-made random-effect bucket (``tests/test_torch_newton_re.py``'s
builder, float64, on the CPU, padded with all-zero lanes by the JAX
``_pad_bucket`` convention) goes through JAX's ``_fit_bucket_jitted``
(``jax.vmap(problem.run)``) and the port's ``GLMOptimizationProblem.run_lanes``
over the bucket's block-diagonal ``LaneFeatures``: L-BFGS on the scored path
(no normalization) and the plain path (with one), OWL-QN with L1 and elastic
net, TRON; with and without a ``LocalNormalizationContext`` (factors and
shifts, or factors alone) and a Gaussian prior; NONE, SIMPLE and FULL
variances. In every lane the iterations, converged reasons and data passes
are equal, the coefficients within 1e-9 of the bucket's largest and the
values and variances within 1e-9 relative; the lanes stop at different
iterations and the padding lanes stay at the zero model.

The loops fetch from the device once per outer iteration and once per probe
or CG round (``optim/lanes.py`` ``SYNCS``); on the card (tests marked
``cuda``) the CUDA sync debug mode sees no other sync, and each optimizer's
lanes equal the same lanes on the CPU.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu.data.normalization import NormalizationContext as JaxNorm
from photon_tpu.data.normalization import project_context as jax_project
from photon_tpu.functions.problem import GLMOptimizationProblem as JaxProblem
from photon_tpu.functions.problem import VarianceComputationType as JaxVariance
from photon_tpu.game.random_effect import _fit_bucket_jitted
from photon_tpu.game.random_effect import _pad_bucket as jax_pad_bucket
from photon_tpu.optim import OptimizerConfig as JaxConfig
from photon_tpu.optim import OptimizerType as JaxOptimizer
from photon_tpu.optim import RegularizationContext as JaxReg
from photon_tpu.optim import RegularizationType as JaxRegType
from photon_tpu.optim.regularization import elastic_net_context as jax_elastic_net
from photon_tpu.types import TaskType as JaxTask
from photon_tpu_torch.data.batch import LabeledBatch, LaneFeatures
from photon_tpu_torch.data.normalization import NormalizationContext
from photon_tpu_torch.data.normalization import project_context
from photon_tpu_torch.functions.problem import (
    GLMOptimizationProblem,
    VarianceComputationType,
)
from photon_tpu_torch.optim import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
    elastic_net_context,
)
from photon_tpu_torch.optim import lanes
from photon_tpu_torch.types import TaskType
from test_torch_newton_re import buckets, masks, pad_bucket, priors

COEF_TOL = 1e-9            # of the largest |coefficient| in the bucket
RTOL = 1e-9


def problems(optimizer, reg, variance="NONE", task="LOGISTIC_REGRESSION",
             max_iter=40):
    jreg = (jax_elastic_net(0.5) if reg == "ELASTIC_NET"
            else JaxReg(JaxRegType[reg]))
    treg = (elastic_net_context(0.5) if reg == "ELASTIC_NET"
            else RegularizationContext(RegularizationType[reg]))
    jp = JaxProblem(task=JaxTask[task], optimizer_type=JaxOptimizer[optimizer],
                    optimizer_config=JaxConfig(max_iterations=max_iter),
                    regularization=jreg, reg_weight=0.7,
                    variance_type=JaxVariance[variance])
    tp = GLMOptimizationProblem(
        task=TaskType[task], optimizer_type=OptimizerType[optimizer],
        optimizer_config=OptimizerConfig(max_iterations=max_iter),
        regularization=treg, reg_weight=0.7,
        variance_type=VarianceComputationType[variance])
    return jp, tp


def contexts(kind, jb, tb, dim, seed=11):
    """A shard context of ``kind`` (None, "standardize": factors and shifts
    with the intercept at column 0, "scale": factors alone) gathered into
    the bucket's lanes by both packages."""
    if kind is None:
        return None, None
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.4, 2.5, size=dim)
    s = rng.normal(size=dim) * 0.3 if kind == "standardize" else None
    jctx = JaxNorm(jnp.asarray(f), None if s is None else jnp.asarray(s), 0)
    tctx = NormalizationContext(torch.from_numpy(f),
                                None if s is None else torch.from_numpy(s), 0)
    return jax_project(jctx, jb.proj, dim), project_context(tctx, tb.proj, dim)


def lane_batch(tb, offsets):
    batch = tb.local_batches(torch.from_numpy(offsets))
    return LabeledBatch(LaneFeatures.from_bucket(tb.idx, tb.val, tb.local_dim),
                        batch.labels, batch.offsets, batch.weights)


def padded_buckets(seed=3, task="LOGISTIC_REGRESSION"):
    """The test bucket with the intercept at column 0, padded to a multiple
    of 4 lanes with all-zero lanes."""
    jb, tb, offsets, dim = buckets(seed=seed, task=task, intercept=0)
    n = len(offsets)
    jb, tb = jax_pad_bucket(jb, 4, n, dim), pad_bucket(tb, 4, n, dim)
    assert (tb.entity_ids < 0).any()
    return jb, tb, offsets, dim


def compare(jout, tout):
    (jm, jr), (tm, tr) = jout, tout
    jw = np.asarray(jm.coefficients.means)
    tw = tm.coefficients.means.numpy()
    assert tw.shape == jw.shape and np.isfinite(tw).all()
    scale = max(np.abs(jw).max(), 1e-30)
    assert np.abs(tw - jw).max() <= COEF_TOL * scale, np.abs(tw - jw).max() / scale
    for f in ("iterations", "converged_reason", "data_passes"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)), err_msg=f)
    np.testing.assert_allclose(tr.value.numpy(), np.asarray(jr.value),
                               rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(tr.grad_norm.numpy(), np.asarray(jr.grad_norm),
                               rtol=1e-6, atol=1e-9)
    jv, tv = jm.coefficients.variances, tm.coefficients.variances
    assert (jv is None) == (tv is None)
    if jv is not None:
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL, atol=1e-12)
    return tr


CASES = [
    # (optimizer, reg, context, prior, variance)
    ("LBFGS", "L2", None, False, "NONE"),
    ("LBFGS", "L2", None, True, "SIMPLE"),
    ("LBFGS", "L2", "standardize", False, "SIMPLE"),
    ("LBFGS", "L2", "standardize", True, "NONE"),
    ("LBFGS", "L2", "scale", False, "FULL"),
    ("OWLQN", "L1", None, False, "NONE"),
    ("OWLQN", "L1", "standardize", True, "SIMPLE"),
    ("OWLQN", "ELASTIC_NET", None, True, "NONE"),
    ("OWLQN", "ELASTIC_NET", "scale", False, "NONE"),
    ("TRON", "L2", None, False, "SIMPLE"),
    ("TRON", "L2", "standardize", True, "NONE"),
    ("TRON", "L2", "scale", True, "FULL"),
]


@pytest.mark.parametrize("optimizer,reg,context,prior,variance", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_lanes_match_jax_vmapped_solve(optimizer, reg, context, prior, variance):
    jb, tb, offsets, dim = padded_buckets()
    jp, tp = problems(optimizer, reg, variance)
    jmask, tmask = masks(jb, tb, 0)
    jprior, tprior = priors(jb, 5) if prior else (None, None)
    jnorm, tnorm = contexts(context, jb, tb, dim)
    rng = np.random.default_rng(7)
    w0 = rng.normal(size=tuple(jb.proj.shape)) * 0.1
    pad = (tb.entity_ids < 0).numpy()
    w0[pad] = 0.0
    jout = _fit_bucket_jitted(jp, jb.local_batches(jnp.asarray(offsets)),
                              jnp.asarray(w0), jmask, jnorm, jprior)
    tout = tp.run_lanes(lane_batch(tb, offsets), torch.from_numpy(w0), tmask,
                        tnorm, tprior)
    tr = compare(jout, tout)
    # lanes stop at different iterations; padding lanes stay at zero
    assert len(set(tr.iterations[~torch.from_numpy(pad)].tolist())) > 1
    if prior:
        return
    assert (tout[0].coefficients.means.numpy()[pad] == 0).all()


@pytest.mark.parametrize("task", ["POISSON_REGRESSION", "LINEAR_REGRESSION"])
def test_lanes_match_jax_for_other_losses(task):
    jb, tb, offsets, dim = padded_buckets(seed=4, task=task)
    jp, tp = problems("LBFGS", "L2", "SIMPLE", task=task)
    jmask, tmask = masks(jb, tb, 0)
    jnorm, tnorm = contexts("standardize", jb, tb, dim)
    w0 = np.zeros(tuple(jb.proj.shape))
    compare(_fit_bucket_jitted(jp, jb.local_batches(jnp.asarray(offsets)),
                               jnp.asarray(w0), jmask, jnorm, None),
            tp.run_lanes(lane_batch(tb, offsets), torch.from_numpy(w0), tmask,
                         tnorm, None))


@pytest.mark.parametrize("optimizer,reg", [("LBFGS", "L2"), ("OWLQN", "L1"),
                                           ("TRON", "L2")])
def test_loops_fetch_once_per_iteration_and_round(optimizer, reg):
    """Outer fetches: one after every iteration but one that ends at the
    cap; probe / CG fetches: at most one per round, each round at least one
    probe or H·v of some lane."""
    jb, tb, offsets, dim = padded_buckets()
    _, tp = problems(optimizer, reg, max_iter=40)
    _, tnorm = contexts("standardize", jb, tb, dim)
    lanes.reset_syncs()
    _, r = tp.run_lanes(lane_batch(tb, offsets),
                        torch.zeros(tuple(tb.proj.shape), dtype=torch.float64),
                        masks(jb, tb, 0)[1], tnorm, None)
    loop = int(r.iterations.max())
    assert 1 <= loop < 40
    assert lanes.SYNCS["outer"] == loop
    inner = lanes.SYNCS["cg" if optimizer == "TRON" else "probe"]
    assert loop <= inner <= loop * (20 if optimizer == "TRON" else 25)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the lanes' kernels run only there")
    return torch.device("cuda")


def _on(dev, t):
    return None if t is None else t.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer,reg,context", [
    ("LBFGS", "L2", "standardize"), ("OWLQN", "L1", None), ("TRON", "L2", "scale")])
def test_lanes_on_card_match_cpu(optimizer, reg, context, cuda_device):
    """The same float64 lanes (prior, SIMPLE variances) on the card, through
    the kernels, and on the CPU: equal iterations, reasons and passes in
    every lane, coefficients within 1e-10 of the largest; two card runs
    bit-equal; no sync beyond the loops' counted fetches."""
    import os
    import traceback
    import warnings

    import photon_tpu_torch
    from photon_tpu_torch.functions.prior import PriorDistribution
    from photon_tpu_torch.ops import cuda_sparse as cs

    jb, tb, offsets, dim = padded_buckets()
    _, tp = problems(optimizer, reg, "SIMPLE")
    _, tmask = masks(jb, tb, 0)
    _, tprior = priors(jb, 5)
    _, tnorm = contexts(context, jb, tb, dim)
    w0 = torch.zeros(tuple(tb.proj.shape), dtype=torch.float64)
    batch = lane_batch(tb, offsets)
    cm, cr = tp.run_lanes(batch, w0, tmask, tnorm, tprior)

    dev = cuda_device
    g = LabeledBatch(
        LaneFeatures.from_bucket(tb.idx.to(dev), tb.val.to(dev),
                                 tb.local_dim).with_accelerator_paths(),
        batch.labels.to(dev), batch.offsets.to(dev), batch.weights.to(dev))
    gprior = PriorDistribution(tprior.means.to(dev), tprior.precisions.to(dev))
    gnorm = None if tnorm is None else type(tnorm)(
        _on(dev, tnorm.factors), _on(dev, tnorm.shifts),
        _on(dev, tnorm.intercept_onehot))
    args = (g, w0.to(dev), tmask.to(dev), gnorm, gprior)
    gm, gr = tp.run_lanes(*args)
    cs.reset_launch_counts()
    lanes.reset_syncs()
    sites = []
    pkg = os.path.dirname(photon_tpu_torch.__file__) + os.sep

    def hook(message, category, filename, lineno, file=None, line=None):
        # syncs the port makes (switching the debug mode syncs once itself)
        if "synchroniz" in str(message):
            ours = [f for f in traceback.extract_stack()
                    if f.filename.startswith(pkg)]
            if ours:
                sites.append(f"{ours[-1].filename}:{ours[-1].lineno}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            gm2, _ = tp.run_lanes(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert len(sites) <= sum(lanes.SYNCS.values()), sites
    launched = cs.launch_counts()
    assert launched["ell_matvec"] + launched["ell_panel_matvec"] > 0
    assert launched["csc_rmatvec"] > 0 and launched["csc_sq_rmatvec"] > 0
    assert torch.equal(gm.coefficients.means, gm2.coefficients.means)
    for f in ("converged_reason", "iterations", "data_passes"):
        assert torch.equal(getattr(gr, f).cpu(), getattr(cr, f)), f
    scale = cm.coefficients.means.abs().max().item()
    assert (gm.coefficients.means.cpu() - cm.coefficients.means).abs().max().item() \
        <= 1e-10 * scale
