"""The port's batched Newton random-effect solvers against the JAX package's.

Same numpy-made buckets (built by both packages' builders, float64, on the
CPU) go through ``photon_tpu.game.newton_re`` and
``photon_tpu_torch.game.newton_re``: the primal and the dual solvers, whole
and in entity chunks, without and with Gaussian priors, with NONE, SIMPLE
and FULL variances, for the logistic, Poisson and linear losses. Per bucket
the coefficients agree within 1e-9 of the largest |coefficient| and the
variances within 1e-9 relative; converged reasons, iterations and data
passes are equal in every lane. Degenerate lanes: all-zero padded entities
(the JAX ``_pad_bucket`` convention) converge at the zero model, and a lane whose damped
Hessian is not PD (a negative prior precision on a column no row touches)
takes the steepest-descent fallback on both sides, with equal results. The
gates (primal / dual eligibility, the lazily fetched u_max, chunk sizes)
decide alike over a grid of (E, S, P, U, dtype), under the default budget
and ladder and under set ones.
"""
import itertools
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu.data.random_effect import build_random_effect_dataset as jax_build
from photon_tpu.functions.prior import PriorDistribution as JaxPrior
from photon_tpu.functions.problem import GLMOptimizationProblem as JaxProblem
from photon_tpu.functions.problem import VarianceComputationType as JaxVariance
from photon_tpu.game import newton_re as jnr
from photon_tpu.game.random_effect import _pad_bucket as jax_pad_bucket
from photon_tpu.optim import OptimizerConfig as JaxConfig
from photon_tpu.optim import OptimizerType as JaxOptimizer
from photon_tpu.optim import RegularizationContext as JaxReg
from photon_tpu.optim import RegularizationType as JaxRegType
from photon_tpu.types import TaskType as JaxTask
from photon_tpu_torch.data.random_effect import (
    EntityBucket,
    build_random_effect_dataset,
)
from photon_tpu_torch.functions.prior import PriorDistribution
from photon_tpu_torch.functions.problem import (
    GLMOptimizationProblem,
    VarianceComputationType,
)
from photon_tpu_torch.game import newton_re as tnr
from photon_tpu_torch.optim import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
)
from photon_tpu_torch.types import TaskType

CPU = torch.device("cpu")
COEF_TOL = 1e-9          # of the largest |coefficient| in the bucket
VAR_RTOL = 1e-9


def entity_data(seed, n_entities=12, dim=40, k=5, rows=(3, 9), support=(10, 18),
                task="LOGISTIC_REGRESSION"):
    """Rows of entities that each touch their own column subset, labels from
    a per-entity model. Few rows in a wide support: S < P (dual regime)
    with P ≤ 64 (primal regime too)."""
    rng = np.random.default_rng(seed)
    idx_rows, val_rows, labels, keys = [], [], [], []
    for e in range(n_entities):
        sup = rng.choice(dim, size=rng.integers(*support), replace=False)
        w = rng.normal(size=dim)
        for _ in range(rng.integers(*rows)):
            cols = rng.choice(sup, size=k, replace=False)
            vals = rng.normal(size=k)
            z = float(vals @ w[cols])
            if task == "LOGISTIC_REGRESSION":
                y = float(rng.random() < 1 / (1 + np.exp(-z)))
            elif task == "POISSON_REGRESSION":
                y = float(rng.poisson(np.exp(np.clip(0.3 * z, -3, 3))))
            else:
                y = z + 0.1 * rng.normal()
            idx_rows.append(cols)
            val_rows.append(vals)
            labels.append(y)
            keys.append(f"e{e:02d}")
    order = rng.permutation(len(labels))
    idx = np.asarray(idx_rows, np.int32)[order]
    val = np.asarray(val_rows)[order]
    return idx, val, np.asarray(labels)[order], np.asarray(keys, object)[order], dim


def problems(task="LOGISTIC_REGRESSION", variance="NONE", reg_weight=0.7,
             max_iter=30, tol=1e-7):
    jp = JaxProblem(
        task=JaxTask[task], optimizer_type=JaxOptimizer.LBFGS,
        optimizer_config=JaxConfig(max_iterations=max_iter, tolerance=tol),
        regularization=JaxReg(JaxRegType.L2), reg_weight=reg_weight,
        variance_type=JaxVariance[variance])
    tp = GLMOptimizationProblem(
        task=TaskType[task], optimizer_type=OptimizerType.LBFGS,
        optimizer_config=OptimizerConfig(max_iterations=max_iter, tolerance=tol),
        regularization=RegularizationContext(RegularizationType.L2),
        reg_weight=reg_weight, variance_type=VarianceComputationType[variance])
    return jp, tp


def buckets(seed=0, task="LOGISTIC_REGRESSION", intercept=None, zero_entry=False,
            **kw):
    """The largest bucket of both builders' datasets, plus row offsets."""
    idx, val, y, keys, dim = entity_data(seed, task=task, **kw)
    if zero_entry:
        # entity e00's first row: a column of its own with value 0 (in the
        # entity's subspace, untouched by the data)
        r = int(np.flatnonzero(keys == "e00")[0])
        idx[r, 0], val[r, 0] = dim, 0.0
        dim += 1
    offsets = np.random.default_rng(seed + 100).normal(size=len(y)) * 0.3
    jd = jax_build("re", keys, idx, val, y, dim, intercept_index=intercept,
                   dtype=np.float64)
    td = build_random_effect_dataset("re", keys, idx, val, y, dim,
                                     intercept_index=intercept,
                                     dtype=torch.float64, device=CPU)
    b = int(np.argmax([bb.n_entities for bb in jd.buckets]))
    return jd.buckets[b], td.buckets[b], offsets, dim


def pad_bucket(bucket, multiple, n_rows, global_dim):
    """The JAX ``_pad_bucket`` convention, which the chunked solves' padding
    follows, on a port bucket: the entity axis padded to a multiple of
    ``multiple`` with inert lanes (weight-0 rows, ghost row ids, ghost local
    and global columns, entity id -1)."""
    e = bucket.n_entities
    r = (-e) % multiple

    def pad(a, fill):
        return tnr._slice_pad_lanes(a, 0, e, e + r, fill)

    return EntityBucket(
        idx=pad(bucket.idx, bucket.local_dim), val=pad(bucket.val, 0),
        labels=pad(bucket.labels, 0), weights=pad(bucket.weights, 0),
        train_weights=pad(bucket.train_weights, 0),
        row_ids=pad(bucket.row_ids, n_rows), proj=pad(bucket.proj, global_dim),
        entity_ids=pad(bucket.entity_ids, -1))


def masks(jb, tb, intercept):
    """The projected intercept-free L2 mask, ghost slots at 1."""
    dim = tb.proj.max().item()
    g = np.ones(dim + 1)
    if intercept is not None:
        g[intercept] = 0.0
    m = g[np.asarray(jb.proj)]
    return jnp.asarray(m), torch.from_numpy(m)


def priors(jb, seed, neg_lane=None):
    rng = np.random.default_rng(seed)
    e, p = jb.proj.shape
    means = rng.normal(size=(e, p)) * 0.3
    prec = rng.uniform(0.5, 2.0, size=(e, p))
    if neg_lane is not None:
        prec[neg_lane] = 1.0
        means[neg_lane] = 0.0
    return (JaxPrior(jnp.asarray(means), jnp.asarray(prec)),
            PriorDistribution(torch.from_numpy(means), torch.from_numpy(prec)))


def compare(jout, tout):
    (jm, jr), (tm, tr) = jout, tout
    jw = np.asarray(jm.coefficients.means)
    tw = tm.coefficients.means.numpy()
    assert tw.shape == jw.shape and np.isfinite(tw).all()
    scale = max(np.abs(jw).max(), 1e-30)
    assert np.abs(tw - jw).max() <= COEF_TOL * scale, np.abs(tw - jw).max() / scale
    np.testing.assert_array_equal(tr.converged_reason.numpy(),
                                  np.asarray(jr.converged_reason))
    np.testing.assert_array_equal(tr.iterations.numpy(), np.asarray(jr.iterations))
    np.testing.assert_array_equal(tr.data_passes.numpy(), np.asarray(jr.data_passes))
    np.testing.assert_allclose(tr.value.numpy(), np.asarray(jr.value),
                               rtol=1e-10, atol=1e-10)
    jv, tv = jm.coefficients.variances, tm.coefficients.variances
    assert (jv is None) == (tv is None)
    if jv is not None:
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=VAR_RTOL,
                                   atol=1e-12)
    return jr


CASES = [
    # (solver, chunk, prior, variance, task)
    ("primal", None, False, "NONE", "LOGISTIC_REGRESSION"),
    ("primal", None, True, "SIMPLE", "LOGISTIC_REGRESSION"),
    ("primal", None, False, "FULL", "LOGISTIC_REGRESSION"),
    ("primal", None, True, "FULL", "POISSON_REGRESSION"),
    ("primal", 4, True, "SIMPLE", "LOGISTIC_REGRESSION"),
    ("dual", None, False, "NONE", "LOGISTIC_REGRESSION"),
    ("dual", None, True, "SIMPLE", "LOGISTIC_REGRESSION"),
    ("dual", None, False, "SIMPLE", "LINEAR_REGRESSION"),
    ("dual", 4, False, "SIMPLE", "LOGISTIC_REGRESSION"),
    ("dual", 4, True, "NONE", "POISSON_REGRESSION"),
]


@pytest.mark.parametrize("solver,chunk,prior,variance,task", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
@pytest.mark.parametrize("intercept", [None, 0], ids=["no_intercept", "intercept"])
def test_bucket_solve_matches_jax(solver, chunk, prior, variance, task, intercept):
    jb, tb, offsets, _ = buckets(seed=3, task=task, intercept=intercept)
    assert tb.max_samples < tb.local_dim <= tnr.NEWTON_MAX_P
    jp, tp = problems(task, variance)
    jmask, tmask = masks(jb, tb, intercept)
    jprior, tprior = priors(jb, 5) if prior else (None, None)
    jbat = jb.local_batches(jnp.asarray(offsets))
    tbat = tb.local_batches(torch.from_numpy(offsets))
    rng = np.random.default_rng(7)
    w0 = rng.normal(size=tuple(jb.proj.shape)) * 0.1     # the primal's warm start
    jw0, tw0 = jnp.asarray(w0), torch.from_numpy(w0)
    if solver == "primal":
        def jfit(b, w, m, pr):
            return jnr.fit_bucket_newton(jp, b, w, m, pr)

        def tfit(b, w, m, pr):
            return tnr.fit_bucket_newton(tp, b, w, m, pr)
    else:
        ju = jnr.u_max_for(jnr.penalty_terms(jp, jmask, jprior)[3])
        tu = tnr.u_max_for(tnr.penalty_terms(tp, tmask, tprior)[3])
        # the intercept is the one unpenalized column, unless a prior
        # gives it precision
        assert ju == tu == (1 if intercept is not None and not prior else 0)

        def jfit(b, w, m, pr):
            return jnr.fit_bucket_newton_dual(jp, b, w, m, pr, ju)

        def tfit(b, w, m, pr):
            return tnr.fit_bucket_newton_dual(tp, b, w, m, pr, tu)
    if chunk is None:
        jout = jfit(jbat, jw0, jmask, jprior)
        tout = tfit(tbat, tw0, tmask, tprior)
    else:
        assert tb.n_entities > chunk and tb.n_entities % chunk
        jout = jnr.fit_bucket_in_chunks(jfit, chunk, jbat, jw0, jmask, jprior)
        tout = tnr.fit_bucket_in_chunks(tfit, chunk, tbat, tw0, tmask, tprior)
    jr = compare(jout, tout)
    assert (np.asarray(jr.iterations) >= 1).all()


@pytest.mark.parametrize("solver", ["primal", "dual"])
def test_padded_all_zero_lanes_converge_at_zero(solver):
    """Inert lanes of ``_pad_bucket`` (all-zero entities) solve to the zero
    model, and the real lanes are unchanged."""
    jb, tb, offsets, dim = buckets(seed=4)
    n = len(offsets)
    jb = jax_pad_bucket(jb, 8, n, dim)
    tb = pad_bucket(tb, 8, n, dim)
    for f in ("idx", "val", "labels", "weights", "train_weights", "row_ids",
              "proj", "entity_ids"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    e = tb.n_entities
    jp, tp = problems()
    jmask, tmask = jnp.ones(tuple(jb.proj.shape)), torch.ones(tuple(tb.proj.shape),
                                                             dtype=torch.float64)
    jbat = jb.local_batches(jnp.asarray(offsets))
    tbat = tb.local_batches(torch.from_numpy(offsets))
    jw0, tw0 = jnp.zeros(tuple(jb.proj.shape)), torch.zeros(tuple(tb.proj.shape),
                                                            dtype=torch.float64)
    if solver == "primal":
        jout = jnr.fit_bucket_newton(jp, jbat, jw0, jmask, None)
        tout = tnr.fit_bucket_newton(tp, tbat, tw0, tmask, None)
    else:
        jout = jnr.fit_bucket_newton_dual(jp, jbat, jw0, jmask, None, 0)
        tout = tnr.fit_bucket_newton_dual(tp, tbat, tw0, tmask, None, 0)
    compare(jout, tout)
    pad = (tb.entity_ids < 0).numpy()
    assert pad.sum() > 0 and e % 8 == 0
    assert (tout[0].coefficients.means.numpy()[pad] == 0).all()


def test_non_pd_lane_takes_steepest_descent_as_in_jax():
    """A negative prior precision on a column that no row of lane 0 touches
    makes lane 0's damped Hessian indefinite: ``cholesky_ex`` reports it,
    the lane steps along -g on both sides, and every lane matches."""
    jb, tb, offsets, _ = buckets(seed=6, zero_entry=True)
    lane = 0
    p_local = tb.local_dim
    dense = np.zeros((tb.max_samples, p_local + 1))
    idx = tb.idx[lane].numpy()
    val = tb.val[lane].numpy()
    for s in range(idx.shape[0]):
        for k in range(idx.shape[1]):
            dense[s, idx[s, k]] += val[s, k]
    real = np.flatnonzero(tb.proj[lane].numpy() < tb.proj.max().item())
    untouched = [c for c in real if not np.any(dense[:, c])]
    assert untouched, "the zeroed entry left no untouched column"
    col = untouched[0]
    jprior, tprior = priors(jb, 9, neg_lane=lane)
    means, prec = np.asarray(jprior.means).copy(), np.asarray(jprior.precisions).copy()
    prec[lane, col] = -0.9          # λ 0.7 + (-0.9) < 0: indefinite
    jprior = JaxPrior(jnp.asarray(means), jnp.asarray(prec))
    tprior = PriorDistribution(torch.from_numpy(means), torch.from_numpy(prec))
    jp, tp = problems("LOGISTIC_REGRESSION", "SIMPLE", max_iter=12)
    jmask, tmask = masks(jb, tb, None)
    h = torch.linalg.cholesky_ex(torch.diag_embed(
        tnr.penalty_terms(tp, tmask, tprior, torch.float64)[3]))[1]
    assert h[lane] != 0 and (h[1:] == 0).all()
    w0 = np.zeros(tuple(jb.proj.shape))
    jout = jnr.fit_bucket_newton(jp, jb.local_batches(jnp.asarray(offsets)),
                                 jnp.asarray(w0), jmask, jprior)
    tout = tnr.fit_bucket_newton(tp, tb.local_batches(torch.from_numpy(offsets)),
                                 torch.from_numpy(w0), tmask, tprior)
    compare(jout, tout)


def test_newton_loop_counts_one_fetch_per_iteration():
    jb, tb, offsets, _ = buckets(seed=3)
    _, tp = problems()
    tnr.reset_syncs()
    _, r = tnr.fit_bucket_newton(
        tp, tb.local_batches(torch.from_numpy(offsets)),
        torch.zeros(tuple(tb.proj.shape), dtype=torch.float64),
        torch.ones(tuple(tb.proj.shape), dtype=torch.float64), None)
    loop_iterations = int(r.iterations.max())
    assert tnr.SYNCS["newton_loop"] == loop_iterations


def _fake_buckets(e, s, p, np_dtype):
    jb = types.SimpleNamespace(idx=types.SimpleNamespace(shape=(e, s, 4)),
                               local_dim=p, val=np.zeros(1, np_dtype))
    tb = types.SimpleNamespace(idx=types.SimpleNamespace(shape=(e, s, 4)),
                               local_dim=p,
                               val=torch.zeros(1, dtype=getattr(torch, np_dtype)))
    return jb, tb


GRID = list(itertools.product((200, 5000, 100_000, 400_000), (8, 16, 64, 79),
                              (16, 64, 256, 1024), (0, 1, 3, 20),
                              ("float32", "float64")))


@pytest.mark.parametrize("env", [{}, {"PHOTON_RE_NEWTON_BUDGET_MB": "64",
                                      "PHOTON_RE_CHUNK_LADDER": "128,512,2048"},
                                 {"PHOTON_RE_NEWTON": "dual"}],
                         ids=["default", "budget_ladder", "force_dual"])
@pytest.mark.parametrize("variance", ["NONE", "FULL"])
def test_gates_decide_as_jax(monkeypatch, env, variance):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jp, tp = problems(variance=variance)
    for e, s, p, u, dt in GRID:
        jb, tb = _fake_buckets(e, s, p, dt)
        want = (jnr.newton_eligible(jp, jb, None), jnr.dual_precheck(jp, jb, None),
                jnr.dual_eligible(jp, jb, None, u),
                jnr.newton_chunk_size(jp, jb, None),
                jnr.dual_chunk_size(jp, jb, None, u))
        got = (tnr.newton_eligible(tp, tb, None), tnr.dual_precheck(tp, tb, None),
               tnr.dual_eligible(tp, tb, None, u),
               tnr.newton_chunk_size(tp, tb, None),
               tnr.dual_chunk_size(tp, tb, None, u))
        assert got == want, (e, s, p, u, dt, got, want)


def test_non_smooth_problems_fit_no_newton_tier():
    """OWL-QN / L1 problems are not smooth: every gate declines, as in JAX."""
    jp = JaxProblem(task=JaxTask.LOGISTIC_REGRESSION,
                    optimizer_type=JaxOptimizer.OWLQN,
                    regularization=JaxReg(JaxRegType.L1), reg_weight=1.0)
    tp = GLMOptimizationProblem(task=TaskType.LOGISTIC_REGRESSION,
                                optimizer_type=OptimizerType.OWLQN,
                                regularization=RegularizationContext(RegularizationType.L1),
                                reg_weight=1.0)
    jb, tb = _fake_buckets(1000, 8, 32, "float32")
    assert not tnr.newton_eligible(tp, tb, None) and not jnr.newton_eligible(jp, jb, None)
    assert tnr.dual_precheck(tp, tb, None) == jnr.dual_precheck(jp, jb, None) is False
    assert tnr.newton_chunk_size(tp, tb, None) is None


def test_dense_design_sums_duplicates_in_slot_order():
    """Duplicate (row, column) entries sum in ELL slot order, as XLA's
    scatter does: bit-equal to the JAX design."""
    rng = np.random.default_rng(11)
    e, s, k, p = 5, 6, 7, 4
    idx = rng.integers(0, p + 1, size=(e, s, k)).astype(np.int32)
    idx[:, :, 1] = idx[:, :, 0]                      # duplicates in every row
    val = rng.normal(size=(e, s, k)) * 10.0 ** rng.integers(-8, 8, size=(e, s, k))
    from photon_tpu.data.batch import LabeledBatch as JB
    from photon_tpu.data.batch import SparseFeatures as JF
    from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures

    z = np.zeros((e, s))
    jx = jnr._dense_design(JB(JF(jnp.asarray(idx), jnp.asarray(val), p),
                              jnp.asarray(z), jnp.asarray(z), jnp.asarray(z)),
                           jnp.float64)[0]
    tx = tnr._dense_design(LabeledBatch(SparseFeatures(
        torch.from_numpy(idx), torch.from_numpy(val), p), torch.from_numpy(z),
        torch.from_numpy(z), torch.from_numpy(z)), torch.float64)[0]
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's batched solves run only there")
    return torch.device("cuda")


def _to(batch, dev):
    from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures

    f = batch.features
    return LabeledBatch(SparseFeatures(f.idx.to(dev), f.val.to(dev), f.dim),
                        batch.labels.to(dev), batch.offsets.to(dev),
                        batch.weights.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["primal", "dual"])
def test_bucket_solve_on_card_matches_cpu(solver, cuda_device):
    """The same float64 bucket solve (priors, SIMPLE variances) on the card
    (cuBLAS / cuSOLVER) and on the CPU: equal reasons, iterations and
    passes in every lane, coefficients within 1e-10 of the largest; two
    card runs bit-equal."""
    _, tb, offsets, _ = buckets(seed=3, intercept=0)
    _, tp = problems("LOGISTIC_REGRESSION", "SIMPLE")
    _, tmask = masks(tb, tb, 0)
    _, tprior = priors(tb, 5)
    batch = tb.local_batches(torch.from_numpy(offsets))
    w0 = torch.zeros(tuple(tb.proj.shape), dtype=torch.float64)

    def fit(b, w, m, pr):
        if solver == "primal":
            return tnr.fit_bucket_newton(tp, b, w, m, pr)
        return tnr.fit_bucket_newton_dual(tp, b, w, m, pr, 0)

    cm, cr = fit(batch, w0, tmask, tprior)
    dev_prior = PriorDistribution(tprior.means.to(cuda_device),
                                  tprior.precisions.to(cuda_device))
    runs = [fit(_to(batch, cuda_device), w0.to(cuda_device), tmask.to(cuda_device),
                dev_prior) for _ in range(2)]
    (gm, gr), (gm2, _) = runs
    assert torch.equal(gm.coefficients.means, gm2.coefficients.means)
    for f in ("converged_reason", "iterations", "data_passes"):
        assert torch.equal(getattr(gr, f).cpu(), getattr(cr, f)), f
    scale = cm.coefficients.means.abs().max().item()
    assert (gm.coefficients.means.cpu() - cm.coefficients.means).abs().max().item() \
        <= 1e-10 * scale
    torch.testing.assert_close(gm.coefficients.variances.cpu(),
                               cm.coefficients.variances, rtol=1e-10, atol=0)


@pytest.mark.cuda
def test_dense_design_on_card_is_bit_equal_to_cpu(cuda_device):
    """One scatter per ELL slot: duplicates sum in slot order on the card
    as on the CPU, bit for bit, every run."""
    from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures

    rng = np.random.default_rng(12)
    e, s, k, p = 300, 16, 9, 40
    idx = rng.integers(0, p + 1, size=(e, s, k)).astype(np.int32)
    idx[:, :, 1] = idx[:, :, 0]
    idx[:, :, 5] = idx[:, :, 0]
    val = rng.normal(size=(e, s, k)) * 10.0 ** rng.integers(-6, 6, size=(e, s, k))
    z = torch.zeros((e, s), dtype=torch.float64)
    cpu_batch = LabeledBatch(SparseFeatures(torch.from_numpy(idx),
                                            torch.from_numpy(val), p), z, z, z)
    want = tnr._dense_design(cpu_batch, torch.float64)[0]
    for dt in (torch.float64, torch.float32):
        ref = tnr._dense_design(cpu_batch, dt)[0]
        for _ in range(2):
            got = tnr._dense_design(_to(cpu_batch, cuda_device), dt)[0]
            assert torch.equal(got.cpu(), ref)
    assert want.dtype == torch.float64
