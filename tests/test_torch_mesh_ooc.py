"""Out-of-core training under a mesh (``run_out_of_core(mesh=...)``,
``ChunkedGLMData.sharded``) and the GLM driver's ``--devices``, on the CPU,
against the port's unsharded solve and the JAX package's mesh solve.

The port's mesh: 4 shards on the one CPU device; the JAX package's: 4 of
the 8 CPU devices ``tests/conftest.py`` forces. ``tests/test_torch_out_of
_core.py``'s data (700 rows, a padded last chunk).

Tolerances:
* float64, the mesh against one device: coefficients within 1e-12, equal
  iterations, reasons and data passes;
* float32 against the JAX package's ``run_out_of_core(mesh=...)`` (float32
  only), capped at 5 iterations: the out-of-core parity bar of
  ``tests/test_torch_out_of_core.py`` (equal iterations, reasons and data
  passes, coefficients within 1e-5);
* a checkpoint resumed under the mesh, and an OOM re-cut under it: bit
  for bit the uninterrupted mesh solve / the solve started at the half cut.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

from photon_tpu.optim.out_of_core import ChunkedGLMData as JaxChunked
from photon_tpu.optim.out_of_core import run_out_of_core as jax_run_ooc
from photon_tpu.parallel.mesh import make_mesh as jax_make_mesh
from photon_tpu_torch.optim import OptimizerType
from photon_tpu_torch.optim.out_of_core import ChunkedGLMData, run_out_of_core
from photon_tpu_torch.optim.regularization import RegularizationType
from photon_tpu_torch.parallel.mesh import make_mesh
from photon_tpu_torch.runtime import memory_guard as mg
from photon_tpu_torch.types import TaskType
from test_torch_glm_driver import (  # noqa: F401
    _check_sweeps,
    _close_maps,
    _common,
    _saved,
    data,
)
from test_torch_jax_decoder import jax_decoder  # noqa: F401
from test_torch_out_of_core import (
    CPU,
    DIM,
    F64,
    _chunked,
    _close,
    _data,
    _jax_problem,
    _problem,
)


def port_mesh(n=4):
    return make_mesh({"data": n}, devices=[CPU] * n)


def same_fit(a, b, tol):
    (ma, ra), (mb, rb) = a, b
    assert (int(ra.iterations), int(ra.converged_reason), int(ra.data_passes)) == \
        (int(rb.iterations), int(rb.converged_reason), int(rb.data_passes))
    _close(ma.coefficients.means, mb.coefficients.means, tol)


@pytest.mark.parametrize("task,opt,reg", [
    (TaskType.LOGISTIC_REGRESSION, OptimizerType.LBFGS, RegularizationType.L2),
    (TaskType.POISSON_REGRESSION, OptimizerType.LBFGS, RegularizationType.L2),
    (TaskType.LOGISTIC_REGRESSION, OptimizerType.OWLQN, RegularizationType.L1),
], ids=["logistic_lbfgs", "poisson_lbfgs", "logistic_owlqn"])
def test_out_of_core_under_a_mesh_matches_one_device_and_jax(task, opt, reg):
    idx, val, labels = _data(task=task)
    problem = _problem(task, opt=opt, reg=reg, reg_weight=0.5)
    one = run_out_of_core(problem, _chunked(idx, val, labels, 256))
    data = _chunked(idx, val, labels, 256)
    four = run_out_of_core(problem, data, mesh=port_mesh())
    same_fit(four, one, 1e-12)
    (view,) = [v for _, v in data.mesh_views.values()]
    assert view.n_chunks == 4 * data.n_chunks and view.chunk_rows == 64
    assert view.group == 4
    # float32 against JAX's out-of-core solver on its 4-device mesh
    jmesh = jax_make_mesh({"data": 4}, devices=jax.devices()[:4])
    jm, jr = jax_run_ooc(_jax_problem(task, opt, reg, reg_weight=0.5),
                         JaxChunked.from_arrays(idx, val, labels, DIM,
                                                chunk_rows=256), mesh=jmesh)
    pm, pr = run_out_of_core(_problem(task, opt=opt, reg=reg, reg_weight=0.5,
                                      max_iter=5),
                             _chunked(idx, val, labels, 256, dtype=torch.float32),
                             mesh=port_mesh())
    same_fit((pm, pr), (jm, jr), 1e-5)


def test_mesh_view_is_cut_once_and_refuses_ragged_shards():
    idx, val, labels = _data(n=300)
    data = _chunked(idx, val, labels, 128)
    mesh = port_mesh()
    assert data.sharded(mesh) is data.sharded(mesh)
    with pytest.raises(ValueError, match="must divide evenly"):
        data.sharded(port_mesh(3))


def test_checkpoint_resume_under_a_mesh_is_bit_identical(tmp_path):
    idx, val, labels = _data(seed=3)
    mesh = port_mesh()
    problem = _problem(max_iter=40)
    full = run_out_of_core(problem, _chunked(idx, val, labels, 256), mesh=mesh)
    ck = str(tmp_path / "ooc.ckpt")

    def stop(it, *_):
        if it == 5:
            raise KeyboardInterrupt("killed after iteration 5's checkpoint")

    with pytest.raises(KeyboardInterrupt):
        run_out_of_core(problem, _chunked(idx, val, labels, 256), mesh=mesh,
                        checkpoint_path=ck, checkpoint_min_interval_s=0.0,
                        progress=stop)
    resumed = run_out_of_core(problem, _chunked(idx, val, labels, 256), mesh=mesh,
                              checkpoint_path=ck)
    assert full[1].iterations > 5
    assert torch.equal(resumed[0].coefficients.means, full[0].coefficients.means)
    assert resumed[1].iterations == full[1].iterations


def test_oom_under_a_mesh_recuts_and_reshards():
    """An injected OOM halves the chunk rows of the source and shards the
    new cut again; the solve equals one started at the half cut."""
    from photon_tpu_torch.faults import FaultPlan, FaultSpec, active_plan

    idx, val, labels = _data(seed=4)
    mesh = port_mesh()
    problem = _problem(max_iter=30)
    mg.reset_state()
    try:
        plan = FaultPlan(specs=[FaultSpec(site="optim.ooc_chunk",
                                          error="device_oom", count=1)])
        with active_plan(plan):
            got = run_out_of_core(problem, _chunked(idx, val, labels, 256),
                                  mesh=mesh)
    finally:
        mg.reset_state()
    want = run_out_of_core(problem, _chunked(idx, val, labels, 128), mesh=mesh)
    assert torch.equal(got[0].coefficients.means, want[0].coefficients.means)


# --------------------------------------------------------- the GLM driver


def test_glm_driver_devices_through_the_seam(data, tmp_path, monkeypatch, capsys):
    """``--devices 4`` streams the out-of-core chunks over 4 shards (the
    visible devices patched to 4 CPU devices): the model equals the JAX
    driver's ``--devices 4`` run at the out-of-core driver bar of
    ``tests/test_torch_glm_driver.py`` (6 iterations, float32: equal
    iterations and data passes, means within 1e-4) and the port's
    one-device run within 1e-6; ``--devices 2`` with one visible device
    exits 2."""
    from photon_tpu.cli import glm_training_driver as jax_glm
    from photon_tpu_torch.cli import glm_training_driver, params

    args = _common(data, "--variance", "NONE", "--row-chunk-rows", "64",
                   "--max-iterations", "6")
    monkeypatch.setattr(params, "visible_devices", lambda device="cuda": [CPU] * 4)
    four = glm_training_driver.run(args + ["--output-dir", str(tmp_path / "p4"),
                                           "--devices", "4", "--device", "cpu"])
    one = glm_training_driver.run(args + ["--output-dir", str(tmp_path / "p1"),
                                          "--device", "cpu"])
    js = jax_glm.run(args + ["--output-dir", str(tmp_path / "j4"), "--devices", "4"])
    assert four["mode"] == one["mode"] == js["mode"] == "out_of_core"
    _check_sweeps(four, js, 1e-6, 1e-5)
    p4, _ = _saved(tmp_path / "p4" / "best")
    p1, _ = _saved(tmp_path / "p1" / "best")
    j4, _ = _saved(tmp_path / "j4" / "best")
    _close_maps(p4, p1, 1e-6)
    _close_maps(p4, j4, 1e-4)
    monkeypatch.setattr(params, "visible_devices", lambda device="cuda": [CPU])
    with pytest.raises(SystemExit) as e:
        glm_training_driver.run(args + ["--output-dir", str(tmp_path / "x"),
                                        "--devices", "2", "--device", "cpu"])
    assert e.value.code == 2
    assert "--devices 2 > 1 visible devices" in capsys.readouterr().err
