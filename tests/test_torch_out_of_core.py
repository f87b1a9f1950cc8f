"""Out-of-core fixed-effect training (``photon_tpu_torch/optim/out_of_core.py``)
against the port's in-core fit and the JAX package's out-of-core solver.

Tolerances:
* float64, out-of-core against in-core (the same loop over the same
  objective; only the chunked sums reassociate): coefficients within 1e-9
  of the largest, equal iterations and reasons; OWL-QN's ``data_passes``
  equal too where every line search takes its first probe;
* float32 against JAX's out-of-core solver (float32 only), capped at 5
  iterations so that neither stops on a float32 function-value tie:
  equal iterations, reasons and ``data_passes``, coefficients within 1e-5
  (relative above 1): the port's passes sum in float64 and round once;
* resume from a checkpoint, a primed solve, bf16 values against float32
  values on the bf16-rounded data: bit-identical.
"""
from __future__ import annotations

import dataclasses
import logging

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu.functions.problem import GLMOptimizationProblem as JaxProblem
from photon_tpu.optim import OptimizerConfig as JaxConfig
from photon_tpu.optim import OptimizerType as JaxOptType
from photon_tpu.optim import RegularizationContext as JaxReg
from photon_tpu.optim import RegularizationType as JaxRegType
from photon_tpu.optim.out_of_core import ChunkedGLMData as JaxChunked
from photon_tpu.optim.out_of_core import OutOfCoreLBFGS as JaxOOCLBFGS
from photon_tpu.optim.out_of_core import run_out_of_core as jax_run_ooc
from photon_tpu.ops.losses import loss_for_task as jax_loss_for_task
from photon_tpu.types import TaskType as JaxTask
from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures
from photon_tpu_torch.functions.problem import GLMOptimizationProblem
from photon_tpu_torch.ops.losses import loss_for_task
from photon_tpu_torch.optim import OptimizerConfig, OptimizerType
from photon_tpu_torch.optim.base import FUNCTION_VALUES_CONVERGED, GRADIENT_CONVERGED
from photon_tpu_torch.optim.out_of_core import (
    ChunkedGLMData,
    OutOfCoreLBFGS,
    OutOfCoreOWLQN,
    StreamPrimer,
    run_out_of_core,
    scores_out_of_core,
)
from photon_tpu_torch.optim.regularization import (
    RegularizationContext,
    RegularizationType,
    elastic_net_context,
)
from photon_tpu_torch.types import TaskType

CPU = torch.device("cpu")
F64 = torch.float64
DIM = 150


def _data(n=700, dim=DIM, k=8, seed=0, task=TaskType.LOGISTIC_REGRESSION):
    """``tests/test_out_of_core.py``'s generator."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, dim, size=(n, k)).astype(np.int32)
    val = (rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32)
    w_true = rng.normal(size=dim).astype(np.float32)
    z = (val * w_true[idx]).sum(1)
    if task == TaskType.POISSON_REGRESSION:
        labels = rng.poisson(np.exp(np.clip(z, None, 3))).astype(np.float32)
    elif task == TaskType.LINEAR_REGRESSION:
        labels = (z + 0.1 * rng.normal(size=n)).astype(np.float32)
    else:
        labels = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float32)
    return idx, val, labels


def _batch(idx, val, labels, offsets=None, weights=None, dtype=F64):
    n = len(labels)

    def t(a, fill):
        return torch.from_numpy(np.full(n, fill) if a is None else np.asarray(a)).to(dtype)

    return LabeledBatch(
        features=SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val).to(dtype),
                                DIM),
        labels=t(labels, 0.0), offsets=t(offsets, 0.0), weights=t(weights, 1.0))


def _problem(task=TaskType.LOGISTIC_REGRESSION, opt=OptimizerType.LBFGS,
             reg=RegularizationType.L2, reg_weight=1.0, max_iter=120, tol=1e-9,
             context=None):
    return GLMOptimizationProblem(
        task=task, optimizer_type=opt,
        optimizer_config=OptimizerConfig(max_iterations=max_iter, tolerance=tol),
        regularization=context or RegularizationContext(
            reg, elastic_net_alpha=0.5 if reg == RegularizationType.ELASTIC_NET else 0.0),
        reg_weight=reg_weight)


def _jax_problem(task, opt, reg, reg_weight=1.0, max_iter=5, tol=1e-9):
    return JaxProblem(
        task=JaxTask[task.name], optimizer_type=JaxOptType[opt.name],
        optimizer_config=JaxConfig(max_iterations=max_iter, tolerance=tol),
        regularization=JaxReg(JaxRegType[reg.name], elastic_net_alpha=0.5),
        reg_weight=reg_weight)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(a, b, tol):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max()), np.abs(a - b).max()


def _chunked(idx, val, labels, chunk_rows, dtype=F64, **kw):
    return ChunkedGLMData.from_arrays(idx, val, labels, DIM, chunk_rows=chunk_rows,
                                      device=CPU, dtype=dtype, **kw)


SMOOTH = [TaskType.LOGISTIC_REGRESSION, TaskType.LINEAR_REGRESSION,
          TaskType.POISSON_REGRESSION]


@pytest.mark.parametrize("task", SMOOTH)
def test_out_of_core_matches_in_core_and_jax(task):
    idx, val, labels = _data(task=task)
    problem = _problem(task)
    m_in, r_in = problem.run(_batch(idx, val, labels), torch.zeros(DIM, dtype=F64))
    data = _chunked(idx, val, labels, 256)
    assert data.n_chunks == 3                 # 700 rows / 256: a padded chunk
    m_out, r_out = run_out_of_core(problem, data)
    assert r_out.converged_reason in (FUNCTION_VALUES_CONVERGED, GRADIENT_CONVERGED)
    assert (r_out.iterations, r_out.converged_reason) == \
        (r_in.iterations, r_in.converged_reason)
    assert r_out.data_passes == 2 + 2 * r_out.iterations
    _close(m_out.coefficients.means, m_in.coefficients.means, 1e-9)
    assert r_out.value == pytest.approx(r_in.value, rel=1e-12)

    # float32 against the JAX package's out-of-core solver
    jm, jr = jax_run_ooc(_jax_problem(task, OptimizerType.LBFGS, RegularizationType.L2),
                         JaxChunked.from_arrays(idx, val, labels, DIM, chunk_rows=256))
    pm, pr = run_out_of_core(_problem(task, max_iter=5),
                             _chunked(idx, val, labels, 256, dtype=torch.float32))
    assert (pr.iterations, pr.converged_reason, pr.data_passes) == \
        (int(jr.iterations), int(jr.converged_reason), int(jr.data_passes))
    _close(pm.coefficients.means, jm.coefficients.means, 1e-5)
    np.testing.assert_allclose(pr.values.numpy()[:6], np.asarray(jr.values)[:6],
                               rtol=1e-5)


def test_out_of_core_weights_and_offsets():
    """Offsets and zero-weight rows (the padding convention) as in-core."""
    idx, val, labels = _data(n=500, seed=3)
    rng = np.random.default_rng(4)
    offsets = rng.normal(size=500) * 0.3
    weights = (rng.random(500) > 0.2).astype(np.float64)
    problem = _problem()
    m_in, r_in = problem.run(_batch(idx, val, labels, offsets, weights),
                             torch.zeros(DIM, dtype=F64))
    data = _chunked(idx, val, labels, 128, offsets=offsets, weights=weights)
    m_out, r_out = run_out_of_core(problem, data)
    assert r_out.iterations == r_in.iterations
    _close(m_out.coefficients.means, m_in.coefficients.means, 1e-9)
    z = scores_out_of_core(data, m_out.coefficients.means)
    ref = m_out.compute_score(_batch(idx, val, labels, offsets).features,
                              torch.from_numpy(offsets))
    np.testing.assert_allclose(z, ref.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(data.labels_np(), labels.astype(np.float64))
    np.testing.assert_array_equal(data.weights_np(), weights)


def test_out_of_core_pass_count_is_two_per_iteration():
    idx, val, labels = _data(n=400, seed=5)
    data = _chunked(idx, val, labels, 200, dtype=torch.float32)
    solver = OutOfCoreLBFGS(loss=loss_for_task(TaskType.LOGISTIC_REGRESSION),
                            l2_weight=1.0,
                            config=OptimizerConfig(max_iterations=40, tolerance=1e-9))
    res = solver.optimize(data, torch.zeros(DIM))
    assert res.data_passes == 2 + 2 * res.iterations
    assert data.h2d_bytes == 0                # nothing crosses on the CPU


def test_out_of_core_value_dtype_and_budget_helpers():
    idx, val, labels = _data(n=300, seed=6)
    data = _chunked(idx, val, labels, 128, dtype=torch.float32, value_dtype="bfloat16")
    jd = JaxChunked.from_arrays(idx, val, labels, DIM, chunk_rows=128,
                                value_dtype=jnp.bfloat16)
    assert data.value_dtype == data.chunks[0].csc.vals.dtype == torch.bfloat16
    # the ELL pass: 3 chunks x 128 rows x 8 entries x (4 B idx + 2 B val),
    # the JAX package's count
    assert data.streamed_bytes_per_pass() == jd.streamed_bytes_per_pass() == 3 * 128 * 8 * 6
    nnz = sum(int(c.csc.rows.numel()) for c in data.chunks)
    assert nnz == 300 * 8
    tiles = sum(c.csc.tiles.numel() + c.csc.splits.numel() for c in data.chunks)
    assert data.streamed_bytes_per_pass("csc") == \
        nnz * (4 + 2) + 3 * (DIM + 1) * 8 + tiles * 8
    with pytest.raises(ValueError, match="layout"):
        data.streamed_bytes_per_pass("panels")
    # bf16 values: the float32 solve on the bf16-rounded values, bit for bit
    rounded = val.astype(ml_dtypes.bfloat16).astype(np.float32)
    ref = _chunked(idx, rounded, labels, 128, dtype=torch.float32)
    _, r16 = run_out_of_core(_problem(), data)
    _, r32 = run_out_of_core(_problem(), ref)
    assert torch.equal(r16.x, r32.x) and r16.iterations == r32.iterations
    with pytest.raises(TypeError, match="bfloat16"):
        _chunked(idx, val, labels, 128, dtype=F64, value_dtype="bfloat16")


@pytest.mark.parametrize("case", ["tron", "l1_lbfgs", "mesh"])
def test_out_of_core_refuses(case):
    idx, val, labels = _data(n=100, seed=7)
    data = _chunked(idx, val, labels, 64)
    if case == "tron":
        with pytest.raises(NotImplementedError, match="LBFGS"):
            run_out_of_core(_problem(opt=OptimizerType.TRON), data)
    elif case == "l1_lbfgs":
        with pytest.raises(NotImplementedError, match="L1 component"):
            run_out_of_core(_problem(context=elastic_net_context(0.5)), data)
    else:
        with pytest.raises(NotImplementedError, match="M14"):
            run_out_of_core(_problem(), data, mesh=object())


class _Chunk:
    def __init__(self, idx, val, dim):
        n = idx.shape[0]
        self.features = {"s": SparseFeatures(idx=torch.from_numpy(idx),
                                             val=torch.from_numpy(val), dim=dim)}
        self.labels = np.zeros(n, np.float32)
        self.offsets = np.zeros(n, np.float32)
        self.weights = np.ones(n, np.float32)
        self.n_rows = n


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_from_stream_regrows_on_wider_chunks(dtype):
    """A width that grows mid-stream ghost-pads the earlier chunks (their
    CSC, which holds no ghosts, is kept), as ``from_arrays`` would cut the
    concatenated data; in either solve dtype (no chunk shares the stream's
    reused assembly buffer)."""
    dim = 40
    rng = np.random.default_rng(20)
    a = _Chunk(rng.integers(0, dim, (30, 2)).astype(np.int32),
               rng.normal(size=(30, 2)).astype(np.float32), dim)
    b = _Chunk(rng.integers(0, dim, (30, 5)).astype(np.int32),
               rng.normal(size=(30, 5)).astype(np.float32), dim)
    data = ChunkedGLMData.from_stream(iter([a, b]), "s", dim, chunk_rows=25, device=CPU,
                                      dtype=dtype)
    assert all(c.idx.shape[1] == 5 for c in data.chunks)
    assert data.n_rows == 60 and data.n_chunks == 3
    assert (data.chunks[0].idx[:, 2:] == dim).all()
    assert (data.chunks[0].val[:, 2:] == 0).all()
    idx = np.full((60, 5), dim, np.int32)
    val = np.zeros((60, 5), np.float32)
    idx[:30, :2], val[:30, :2] = a.features["s"].idx.numpy(), a.features["s"].val.numpy()
    idx[30:], val[30:] = b.features["s"].idx.numpy(), b.features["s"].val.numpy()
    ref = ChunkedGLMData.from_arrays(idx, val, np.zeros(60), dim, chunk_rows=25,
                                     device=CPU, dtype=dtype)
    for got, want in zip(data.chunks, ref.chunks):
        assert torch.equal(got.idx, want.idx) and torch.equal(got.val, want.val)
        for f in ("colptr", "rows", "vals", "tiles", "splits"):
            assert torch.equal(getattr(got.csc, f), getattr(want.csc, f))


def test_from_stream_on_chunk_fails_fast():
    dim = 16
    rng = np.random.default_rng(7)
    consumed, seen = [], []

    def stream():
        for i in range(10):
            consumed.append(i)
            yield _Chunk(rng.integers(0, dim, (10, 2)).astype(np.int32),
                         rng.normal(size=(10, 2)).astype(np.float32), dim)

    def on_chunk(i, c, lab, off, wgt):
        seen.append(i)
        assert tuple(c.idx.shape) == (10, 2) and c.csc.nnz == 20
        if i == 1:
            raise ValueError("bad chunk")

    with pytest.raises(ValueError, match="bad chunk"):
        ChunkedGLMData.from_stream(stream(), "s", dim, chunk_rows=10,
                                   on_chunk=on_chunk, device=CPU)
    assert seen == [0, 1] and len(consumed) <= 3


class _Stop(Exception):
    pass


def _bomb(it, f, gn, p):
    if it >= 3:
        raise _Stop


@pytest.mark.parametrize("solver_kind", ["lbfgs", "owlqn"])
def test_checkpoint_resume_is_bit_identical(tmp_path, solver_kind):
    """A solve killed after iteration 3 resumes from its checkpoint and ends
    with the uninterrupted solve's bits (iterations, passes, tracks); a
    different λ never resumes from it."""
    idx, val, labels = _data(n=400, seed=11)
    data = _chunked(idx, val, labels, 128, dtype=torch.float32)
    ck = str(tmp_path / "ck.ckpt")

    def solver(path=None, weight=0.5):
        cls, extra = ((OutOfCoreLBFGS, {}) if solver_kind == "lbfgs"
                      else (OutOfCoreOWLQN, {"l1_weight": 0.05}))
        return cls(loss=loss_for_task(TaskType.LOGISTIC_REGRESSION), l2_weight=weight,
                   config=OptimizerConfig(max_iterations=30, tolerance=1e-7),
                   checkpoint_path=path, checkpoint_min_interval_s=0.0, **extra)

    w0 = torch.zeros(DIM)
    ref = solver().optimize(data, w0)
    with pytest.raises(_Stop):
        dataclasses.replace(solver(ck), progress=_bomb).optimize(data, w0)
    res = solver(ck).optimize(data, w0)
    assert ref.iterations > 3
    assert torch.equal(res.x, ref.x)
    assert (res.iterations, res.converged_reason, res.data_passes, res.value) == \
        (ref.iterations, ref.converged_reason, ref.data_passes, ref.value)
    assert torch.equal(res.values, ref.values)
    # another λ: a fresh solve, not a resume of this file
    fresh = solver(weight=2.0).optimize(data, w0)
    other = solver(ck, weight=2.0).optimize(data, w0)
    assert torch.equal(other.x, fresh.x)


def test_jax_checkpoint_is_refused(tmp_path, caplog):
    """A checkpoint the JAX package wrote at the same path is never read:
    the port solves fresh and says why."""
    idx, val, labels = _data(n=400, seed=12)
    ck = str(tmp_path / "shared.ckpt")
    JaxOOCLBFGS(loss=jax_loss_for_task(JaxTask.LOGISTIC_REGRESSION), l2_weight=0.5,
                config=JaxConfig(max_iterations=4),
                checkpoint_path=ck, checkpoint_min_interval_s=0.0).optimize(
        JaxChunked.from_arrays(idx, val, labels, DIM, chunk_rows=128),
        jnp.zeros((DIM,), jnp.float32))
    data = _chunked(idx, val, labels, 128, dtype=torch.float32)

    def solver(path):
        return OutOfCoreLBFGS(loss=loss_for_task(TaskType.LOGISTIC_REGRESSION),
                              l2_weight=0.5, config=OptimizerConfig(max_iterations=6),
                              checkpoint_path=path, checkpoint_min_interval_s=0.0)

    fresh = solver(None).optimize(data, torch.zeros(DIM))
    with caplog.at_level(logging.WARNING, logger="photon_tpu_torch.ooc"):
        got = solver(ck).optimize(data, torch.zeros(DIM))
    assert "not a checkpoint of photon_tpu_torch" in caplog.text
    assert torch.equal(got.x, fresh.x) and got.data_passes == fresh.data_passes
    with open(ck, "rb") as f:                 # now the port's own file
        assert f.read(8) == b"PHTOOC01"


def test_stream_primer_skips_the_init_passes_bit_identically():
    dim = 60
    rng = np.random.default_rng(17)
    chunks = [_Chunk(rng.integers(0, dim, (37, 4)).astype(np.int32),
                     rng.normal(size=(37, 4)).astype(np.float32), dim) for _ in range(3)]
    for c in chunks:
        c.labels = (rng.random(37) < 0.5).astype(np.float32)
    loss = loss_for_task(TaskType.LOGISTIC_REGRESSION)
    primer = StreamPrimer(loss, dim, device=CPU)
    data = ChunkedGLMData.from_stream(iter(chunks), "s", dim, chunk_rows=32,
                                      on_chunk=primer, device=CPU)
    solver = OutOfCoreLBFGS(loss=loss, l2_weight=0.3,
                            config=OptimizerConfig(max_iterations=20, tolerance=1e-7))
    plain = solver.optimize(data, torch.zeros(dim))
    primed = solver.optimize(data, torch.zeros(dim), primed=primer.primed())
    assert torch.equal(primed.x, plain.x) and primed.iterations == plain.iterations
    assert primed.data_passes == plain.data_passes - 1
    # a prime from other chunks (or another start) is not trusted
    other = ChunkedGLMData.from_stream(iter(chunks), "s", dim, chunk_rows=32, device=CPU)
    assert solver.optimize(other, torch.zeros(dim),
                           primed=primer.primed()).data_passes == plain.data_passes


def test_rechunk_keeps_the_solve():
    idx, val, labels = _data(n=300, seed=19)
    data = _chunked(idx, val, labels, 128)
    half = data.rechunk(2)
    assert half.chunk_rows == 64 and half.n_chunks == 6 and half.n_rows == 300
    _, r1 = run_out_of_core(_problem(), data)
    _, r2 = run_out_of_core(_problem(), half)
    assert r1.iterations == r2.iterations
    _close(r2.x, r1.x, 1e-9)
    with pytest.raises(ValueError):
        data.rechunk(1)


OWLQN_TASKS = SMOOTH + [TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM]


@pytest.mark.parametrize("task", OWLQN_TASKS)
def test_owlqn_out_of_core_matches_in_core_and_jax(task):
    """OWL-QN out of core against in-core in float64 (the hinge loss under
    elastic net, as the JAX test runs it) and against JAX's out-of-core
    OWL-QN in float32."""
    svm = task == TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM
    idx, val, labels = _data(n=600, seed=31,
                             task=TaskType.LOGISTIC_REGRESSION if svm else task)
    reg = RegularizationType.ELASTIC_NET if svm else RegularizationType.L1
    problem = _problem(task, OptimizerType.OWLQN, reg, reg_weight=0.05, max_iter=150)
    m_in, r_in = problem.run(_batch(idx, val, labels), torch.zeros(DIM, dtype=F64))
    m_out, r_out = run_out_of_core(problem, _chunked(idx, val, labels, 256))
    assert (r_out.iterations, r_out.converged_reason) == \
        (r_in.iterations, r_in.converged_reason)
    _close(m_out.coefficients.means, m_in.coefficients.means, 1e-9)
    z_in = m_in.coefficients.means == 0
    assert torch.equal(z_in, m_out.coefficients.means == 0)
    if task in (TaskType.LOGISTIC_REGRESSION, TaskType.LINEAR_REGRESSION):
        assert int(z_in.sum()) > 0

    jm, jr = jax_run_ooc(_jax_problem(task, OptimizerType.OWLQN, reg, reg_weight=0.05),
                         JaxChunked.from_arrays(idx, val, labels, DIM, chunk_rows=256))
    pm, pr = run_out_of_core(
        _problem(task, OptimizerType.OWLQN, reg, reg_weight=0.05, max_iter=5),
        _chunked(idx, val, labels, 256, dtype=torch.float32))
    assert (pr.iterations, pr.converged_reason, pr.data_passes) == \
        (int(jr.iterations), int(jr.converged_reason), int(jr.data_passes))
    _close(pm.coefficients.means, jm.coefficients.means, 1e-5)


def test_owlqn_out_of_core_elastic_net_and_mask():
    """Elastic net splits λ; a reg mask exempts column 0 from both parts."""
    idx, val, labels = _data(n=500, seed=32)
    problem = _problem(opt=OptimizerType.OWLQN, reg=RegularizationType.ELASTIC_NET,
                       reg_weight=0.1, max_iter=150)
    mask = torch.ones(DIM, dtype=F64)
    mask[0] = 0.0
    m_in, r_in = problem.run(_batch(idx, val, labels), torch.zeros(DIM, dtype=F64),
                             reg_mask=mask)
    data = _chunked(idx, val, labels, 128)
    m_out, r_out = run_out_of_core(problem, data, reg_mask=mask)
    assert r_out.iterations == r_in.iterations
    _close(m_out.coefficients.means, m_in.coefficients.means, 1e-9)
    direct = OutOfCoreOWLQN(
        loss=loss_for_task(TaskType.LOGISTIC_REGRESSION), l2_weight=0.05,
        l1_weight=0.05, reg_mask=mask,
        config=OptimizerConfig(max_iterations=150, tolerance=1e-9),
    ).optimize(data, torch.zeros(DIM, dtype=F64))
    assert torch.equal(direct.x, r_out.x)
