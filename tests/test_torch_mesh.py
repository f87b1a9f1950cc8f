"""Meshes, row shards, the fold and scoring under a mesh
(``photon_tpu_torch/parallel/mesh.py``), against the JAX package on the CPU.

The port's mesh of 4 shards lives on the one CPU device (a repeated device
in an explicit ``devices`` list, the counterpart of jax's forced host
devices); the JAX package's on 4 of the 8 CPU devices ``tests/conftest.py``
forces.

Tolerances:
* row blocks: each shard's padded rows equal what JAX's
  ``pad_and_shard_batch`` puts on the matching device, exactly;
* the folded objective against the port's single-device objective at
  float64: value within relative 1e-13, gradient and H·v within 1e-12;
* scoring under a mesh: the port's scores equal its unsharded scores within
  1e-12 and the JAX transformer's under its mesh within 1e-12.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from photon_tpu.data.batch import LabeledBatch as JaxBatch
from photon_tpu.data.batch import SparseFeatures as JaxFeatures
from photon_tpu.parallel.mesh import make_mesh as jax_make_mesh
from photon_tpu.parallel.mesh import pad_and_shard_batch as jax_pad_and_shard
from photon_tpu_torch.cli import params
from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures
from photon_tpu_torch.functions.problem import GLMOptimizationProblem
from photon_tpu_torch.optim import OptimizerConfig, RegularizationContext
from photon_tpu_torch.optim.regularization import RegularizationType
from photon_tpu_torch.parallel import mesh as pm
from photon_tpu_torch.parallel.spmd_objective import SpmdGLMObjective
from photon_tpu_torch.types import TaskType

CPU = torch.device("cpu")
ALL_TASKS = (TaskType.LOGISTIC_REGRESSION, TaskType.LINEAR_REGRESSION,
             TaskType.POISSON_REGRESSION, TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM)


def cpu_mesh(n=4, axis="data"):
    return pm.make_mesh({axis: n}, devices=[CPU] * n)


def fe_arrays(seed=0, n=103, dim=48, k=6):
    """A ragged row count on purpose (103 rows over 4 shards)."""
    rng = np.random.default_rng(seed)
    return dict(idx=rng.integers(0, dim, size=(n, k)).astype(np.int32),
                val=rng.normal(size=(n, k)),
                labels=(rng.random(n) < 0.5).astype(np.float64),
                offsets=0.1 * rng.normal(size=n),
                weights=rng.uniform(0.5, 2.0, size=n), dim=dim)


def port_batch(a) -> LabeledBatch:
    t = torch.from_numpy
    return LabeledBatch(SparseFeatures(t(a["idx"]), t(a["val"]), a["dim"]),
                        t(a["labels"]), t(a["offsets"]), t(a["weights"]))


def jax_batch(a) -> JaxBatch:
    return JaxBatch(JaxFeatures(jnp.asarray(a["idx"]), jnp.asarray(a["val"]),
                                a["dim"]),
                    jnp.asarray(a["labels"]), jnp.asarray(a["offsets"]),
                    jnp.asarray(a["weights"]))


def problem(task=TaskType.LOGISTIC_REGRESSION):
    return GLMOptimizationProblem(
        task=task, optimizer_config=OptimizerConfig(max_iterations=60),
        regularization=RegularizationContext(RegularizationType.L2),
        reg_weight=0.3)


# ------------------------------------------------------------------ meshes


def test_make_mesh_shapes_and_axes():
    m = pm.make_mesh({"data": 2, "entity": 2}, devices=[CPU] * 4)
    assert m.shape == {"data": 2, "entity": 2} and m.size == 4
    assert m.axis_names == ("data", "entity")
    assert pm.axes_size(m, "data") == 2 and pm.axes_size(m, ("data", "entity")) == 4
    assert len(pm.shard_devices(m, "data")) == 2
    assert len(pm.shard_devices(m, ("data", "entity"))) == 4
    with pytest.raises(ValueError, match="wants 4 devices"):
        pm.make_mesh({"data": 4}, devices=[CPU] * 3)
    ms = pm.make_multislice_mesh(2, {"data": 2}, devices=[CPU] * 4)
    assert ms.axis_names == ("dcn", "data") and ms.shape == {"dcn": 2, "data": 2}
    assert pm.axes_size(ms, ("dcn", "data")) == 4
    with pytest.raises(ValueError, match="not divisible"):
        pm.make_multislice_mesh(3, devices=[CPU] * 4)


def test_visible_mesh_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default mesh is over it")
    with pytest.raises(ValueError, match="no devices"):
        pm.make_mesh()


@pytest.mark.parametrize("n", [2, 4, 8])
def test_row_blocks_equal_jax_pad_and_shard(n):
    """Each port shard's padded rows equal the rows JAX's
    ``pad_and_shard_batch`` places on the matching device of its mesh."""
    a = fe_arrays()
    shards = pm.pad_and_shard_batch(port_batch(a), cpu_mesh(n))
    jmesh = jax_make_mesh({"data": n}, devices=jax.devices()[:n])
    jb = jax_pad_and_shard(jax_batch(a), jmesh)
    assert shards.n_rows == 103 and shards.rows_per_shard * n == jb.n_rows
    for field in ("labels", "offsets", "weights"):
        by_dev = {s.device: np.asarray(s.data)
                  for s in getattr(jb, field).addressable_shards}
        for i, dev in enumerate(jmesh.devices.flat):
            np.testing.assert_array_equal(
                getattr(shards.shards[i], field).numpy(), by_dev[dev])
    for field in ("idx", "val"):
        by_dev = {s.device: np.asarray(s.data)
                  for s in getattr(jb.features, field).addressable_shards}
        for i, dev in enumerate(jmesh.devices.flat):
            np.testing.assert_array_equal(
                getattr(shards.shards[i].features, field).numpy(), by_dev[dev])
    # padding rows: weight 0, every index the ghost column
    last = shards.shards[-1]
    pad = shards.rows_per_shard * n - 103
    if pad:
        assert last.weights[-pad:].abs().sum() == 0
        assert bool((last.features.idx[-pad:] == a["dim"]).all())


def test_fold_sums_in_shard_order_in_float64():
    parts = [torch.tensor([1.0, 1e-8], dtype=torch.float32),
             torch.tensor([1e8, 1.0], dtype=torch.float32),
             torch.tensor([-1e8, 2.0], dtype=torch.float32)]
    got = pm.fold(parts)
    assert got.dtype == torch.float32
    want = (np.float64(1.0) + 1e8 - 1e8, np.float64(1e-8) + 1.0 + 2.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))
    assert torch.equal(pm.fold(parts), got)      # the same bits every time


# ------------------------------------------------------ the folded objective


@pytest.mark.parametrize("task", ALL_TASKS, ids=lambda t: t.name)
def test_folded_value_grad_hvp_match_single_device(task):
    a = fe_arrays(seed=1)
    batch = port_batch(a)
    obj = problem(task).objective()
    so = SpmdGLMObjective.build(obj, batch, cpu_mesh(4))
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.normal(size=a["dim"]))
    v = torch.from_numpy(rng.normal(size=a["dim"]))
    v1, g1 = obj.value_and_grad(w, batch)
    v2, g2 = so.value_and_grad(w)
    np.testing.assert_allclose(float(v2), float(v1), rtol=1e-13)
    np.testing.assert_allclose(g2.numpy(), g1.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(so.hessian_vector(w, v).numpy(),
                               obj.hessian_vector(w, v, batch).numpy(),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(so.hessian_diagonal(w).numpy(),
                               obj.hessian_diagonal(w, batch).numpy(),
                               rtol=0, atol=1e-12)


def test_with_offsets_recuts_only_the_offsets():
    a = fe_arrays(seed=3)
    batch = port_batch(a)
    mesh = cpu_mesh(4)
    shards = pm.cached_row_shards(batch, mesh)
    assert pm.cached_row_shards(batch, mesh) is shards   # cut once
    new = torch.from_numpy(np.random.default_rng(4).normal(size=103))
    moved = shards.with_offsets(new)
    got = torch.cat([s.offsets for s in moved.shards])
    np.testing.assert_array_equal(got[:103].numpy(), new.numpy())
    assert got[103:].abs().sum() == 0
    assert moved.shards[0].features is shards.shards[0].features


# ------------------------------------------------------------ scoring


def test_scoring_under_a_mesh_matches_unsharded_and_jax():
    """``GameTransformer`` with a mesh shards the fixed effect's features
    alone: the port's scores equal its unsharded scores and the JAX
    transformer's under a 4-device mesh."""
    from photon_tpu.estimators.game_transformer import GameTransformer as JaxT
    from photon_tpu_torch.estimators.game_transformer import GameTransformer
    from test_torch_re_training import bundles, estimators, opt_pair

    jtrain, ptrain = bundles(6)
    jest, pest = estimators(1, ())
    jcfg, pcfg = opt_pair(1.0, variance="NONE")
    jm = jest.fit(jtrain, None, [{"fixed": jcfg, "perUser": jcfg}])[0].model
    pm_ = pest.fit(ptrain, None, [{"fixed": pcfg, "perUser": pcfg}])[0].model
    cfgs = pest.coordinate_data_configs
    one = GameTransformer(pm_, cfgs).transform(ptrain)
    four = GameTransformer(pm_, cfgs, mesh=cpu_mesh(4)).transform(ptrain)
    np.testing.assert_allclose(four.numpy(), one.numpy(), rtol=0, atol=1e-12)
    jmesh = jax_make_mesh({"data": 4}, devices=jax.devices()[:4])
    jscores = JaxT(jm, jest.coordinate_data_configs, mesh=jmesh).transform(jtrain)
    np.testing.assert_allclose(four.numpy(), np.asarray(jscores), rtol=0, atol=1e-9)


# ------------------------------------------------------- the drivers' flags


def test_mesh_from_flags_semantics(monkeypatch):
    monkeypatch.setattr(params, "visible_devices", lambda device="cuda": [CPU] * 4)
    assert params.mesh_from_flags(1) is None
    m = params.mesh_from_flags(0)
    assert m.shape == {"data": 4}
    assert params.mesh_from_flags(2).shape == {"data": 2}
    assert params.mesh_from_flags(1, "data=2,dcn=2").shape == {"data": 2, "dcn": 2}
    with pytest.raises(ValueError, match=r"--devices 5 > 4 visible devices"):
        params.mesh_from_flags(5)
    with pytest.raises(ValueError, match=r"--devices must be >= 0, got -1"):
        params.mesh_from_flags(-1)
    with pytest.raises(ValueError, match="must include the 'data' axis"):
        params.mesh_from_flags(1, "entity=2")
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        params.mesh_from_flags(1, "data=8")
    assert params.mesh_from_flags(1, "data=2,model=2").shape == {"data": 2, "model": 2}


def test_visible_devices_on_the_cpu_is_one():
    assert params.visible_devices("cpu") == [CPU]
    assert params.mesh_from_flags(0, None, "cpu") is None
    with pytest.raises(ValueError, match="> 1 visible devices"):
        params.mesh_from_flags(2, None, "cpu")


def test_jax_mesh_messages_match():
    """The port raises the JAX package's own messages for the flags it
    shares with it."""
    from photon_tpu.cli.params import mesh_from_flags as jax_flags

    for args in ((-1,), (99,), (1, "entity=2"), (1, "data=99")):
        with pytest.raises(ValueError) as je:
            jax_flags(*args)
        with pytest.raises(ValueError) as pe:
            params.mesh_from_flags(*args, device="cpu")
        jm = str(je.value).split(" have ")[0].split(" > ")[0]
        assert str(pe.value).startswith(jm), (str(pe.value), str(je.value))
