"""The port's checkpoints (``photon_tpu_torch/checkpoint.py``) and resume
through ``CoordinateDescent`` and ``GameEstimator.fit``.

* The manager round-trips tensors (back on the caller's device, in their
  dtype) and keeps the newest ``keep`` snapshots; a corrupt newest snapshot
  (truncated payload, one flipped bit, a header torn inside the CRC) is
  refused and the one before it loads.
* A snapshot written by the JAX package (``tests/data/jax_checkpoint``,
  made by ``scripts/make_jax_checkpoint_fixture.py``) is refused by its
  magic before anything is unpickled.
* A GAME fit (fixed effect + per-user random effect, 2 sweeps, validated
  with AUC) killed after 1, 2 or 3 checkpoint saves and resumed in a fresh
  manager ends bit-identical to the uninterrupted port fit: final
  coefficients, tracker records, their results and validation metrics. In
  f64 the resumed fit is also within 1e-9 (relative to the largest
  coefficient) of the JAX package's uninterrupted fit on the same numpy
  inputs; a changed run is refused.
"""
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu.data.batch import SparseFeatures as JaxSparse
from photon_tpu.estimators.config import (
    FixedEffectDataConfig as JaxFixedCfg,
    GLMOptimizationConfiguration as JaxGLMCfg,
    RandomEffectDataConfig as JaxRandomCfg,
)
from photon_tpu.estimators.game_estimator import GameEstimator as JaxEstimator
from photon_tpu.io.data_reader import GameDataBundle as JaxBundle
from photon_tpu.optim import RegularizationContext as JaxReg
from photon_tpu.optim import RegularizationType as JaxRegType
from photon_tpu.types import TaskType as JaxTask
from photon_tpu_torch import checkpoint as ckpt
from photon_tpu_torch.checkpoint import (
    CheckpointCorrupt,
    CheckpointManager,
    ForeignCheckpoint,
)
from photon_tpu_torch.data.batch import SparseFeatures
from photon_tpu_torch.estimators.config import (
    FixedEffectDataConfig,
    GLMOptimizationConfiguration,
    RandomEffectDataConfig,
)
from photon_tpu_torch.estimators.game_estimator import GameEstimator
from photon_tpu_torch.io.data_reader import GameDataBundle
from photon_tpu_torch.optim import RegularizationContext, RegularizationType
from photon_tpu_torch.types import TaskType
from test_torch_jax_decoder import jax_decoder  # noqa: F401

CPU = torch.device("cpu")
JAX_SNAPSHOT = os.path.join(os.path.dirname(__file__), "data", "jax_checkpoint")


def game_arrays(seed=0, n_users=6, rows_per_user=30, d_global=8, d_user=3):
    """A fixed-effect block and a per-user block over one shard (the JAX
    ``tests/test_checkpoint.py`` generator)."""
    rng = np.random.default_rng(seed)
    n = n_users * rows_per_user
    dim = d_global + n_users * d_user
    users = np.repeat(np.arange(n_users), rows_per_user)
    rng.shuffle(users)
    gi = rng.integers(0, d_global, size=(n, 5)).astype(np.int32)
    gv = rng.normal(size=(n, 5))
    ui = (d_global + users[:, None] * d_user
          + rng.integers(0, d_user, size=(n, 2))).astype(np.int32)
    uv = rng.normal(size=(n, 2))
    z = (gv * 0.5).sum(1) + uv.sum(1) * 0.5
    return dict(idx=np.concatenate([gi, ui], 1), val=np.concatenate([gv, uv], 1),
                labels=(rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64),
                dim=dim, users=np.array([f"u{u}" for u in users], object))


def torch_bundle(a, dtype=torch.float64):
    n = len(a["labels"])
    return GameDataBundle(
        features={"g": SparseFeatures(torch.from_numpy(a["idx"]),
                                      torch.from_numpy(a["val"]).to(dtype),
                                      a["dim"])},
        labels=a["labels"], offsets=np.zeros(n), weights=np.ones(n),
        uids=np.arange(n).astype(object), id_tags={"userId": a["users"]})


def jax_bundle(a):
    n = len(a["labels"])
    return JaxBundle(
        features={"g": JaxSparse(jnp.asarray(a["idx"]), jnp.asarray(a["val"]),
                                 a["dim"])},
        labels=a["labels"], offsets=np.zeros(n), weights=np.ones(n),
        uids=np.arange(n).astype(object), id_tags={"userId": a["users"]})


def estimator(host_resident=False, sweep_cache_mb=None):
    return GameEstimator(
        task=TaskType.LOGISTIC_REGRESSION,
        coordinate_data_configs={
            "fixed": FixedEffectDataConfig("g"),
            "perUser": RandomEffectDataConfig(re_type="userId", feature_shard="g",
                                              host_resident=host_resident)},
        n_sweeps=2, evaluator_specs=("AUC",), sweep_cache_mb=sweep_cache_mb)


def configs():
    base = dict(regularization=RegularizationContext(RegularizationType.L2),
                max_iterations=15)
    return [{"fixed": GLMOptimizationConfiguration(reg_weight=0.5, **base),
             "perUser": GLMOptimizationConfiguration(reg_weight=1.0, **base)}]


def final_arrays(results) -> list:
    out = []
    for r in results:
        out.append(r.model["fixed"].model.coefficients.means)
        out.extend(r.model["perUser"].bucket_coefs)
    return out


def result_tensors(res) -> list:
    """Every tensor of a tracker record's result (a fixed effect's
    OptimizerResult or a random effect's per-bucket list)."""
    out = []
    for r in (res if isinstance(res, list) else [res]):
        for v in vars(r).values():
            out.append(v if isinstance(v, torch.Tensor) else torch.tensor(v))
    return out


def assert_same_fits(got, want):
    """Bit-identical models, tracker records (all but their seconds),
    results and validation metrics."""
    assert len(got) == len(want)
    for a, b in zip(final_arrays(got), final_arrays(want)):
        assert torch.equal(a, b)
    for rg, rw in zip(got, want):
        assert rg.evaluation.values == rw.evaluation.values
        assert len(rg.tracker) == len(rw.tracker)
        for tg, tw in zip(rg.tracker, rw.tracker):
            assert (tg.sweep, tg.coordinate_id) == (tw.sweep, tw.coordinate_id)
            assert tg.validation.values == tw.validation.values
            for x, y in zip(result_tensors(tg.result), result_tensors(tw.result)):
                assert torch.equal(x, y)


@pytest.fixture(scope="module")
def fits():
    """The uninterrupted port fit (f64) and the JAX package's, on the same
    numpy inputs."""
    a, v = game_arrays(), game_arrays(seed=1)
    port = estimator().fit(torch_bundle(a), torch_bundle(v), configs())
    jbase = dict(regularization=JaxReg(JaxRegType.L2), max_iterations=15)
    jax_results = JaxEstimator(
        task=JaxTask.LOGISTIC_REGRESSION,
        coordinate_data_configs={
            "fixed": JaxFixedCfg("g"),
            "perUser": JaxRandomCfg(re_type="userId", feature_shard="g")},
        n_sweeps=2, evaluator_specs=("AUC",),
    ).fit(jax_bundle(a), jax_bundle(v),
          [{"fixed": JaxGLMCfg(reg_weight=0.5, **jbase),
            "perUser": JaxGLMCfg(reg_weight=1.0, **jbase)}])
    return a, v, port, jax_results


def test_manager_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    for step in range(5):
        mgr.save(step, {"a": torch.arange(3, dtype=torch.float64) + step,
                        "i": torch.arange(2, dtype=torch.int32), "b": [step]},
                 {"tag": step})
    mgr.wait()
    payload = mgr.load_latest(CPU)
    assert payload["step"] == 4 and payload["meta"]["tag"] == 4
    assert torch.equal(payload["state"]["a"],
                       torch.arange(3, dtype=torch.float64) + 4)
    assert payload["state"]["i"].dtype == torch.int32
    assert payload["state"]["b"] == [4]
    assert sorted(os.listdir(tmp_path / "ck")) == ["step-3", "step-4"]
    assert mgr.last_bytes > 0
    mgr.close()


def _tear(path, how):
    data = bytearray(open(path, "rb").read())
    if how == "torn":
        data = data[: len(data) // 2]
    elif how == "bitflip":
        data[len(data) // 2] ^= 0x10
    else:                                   # header torn inside the CRC
        data = data[: len(ckpt._MAGIC) + 2]
    open(path, "wb").write(bytes(data))


@pytest.mark.parametrize("how", ["torn", "bitflip", "header"])
def test_corrupt_newest_falls_back(tmp_path, how):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=3)
    mgr.save(0, {"x": torch.arange(4)})
    mgr.save(1, {"x": torch.arange(4) + 1})
    mgr.wait()
    newest = str(tmp_path / "ck" / "step-1")
    _tear(newest, how)
    with pytest.raises(CheckpointCorrupt):
        mgr.load_file(newest)
    payload = mgr.load_latest()
    assert torch.equal(payload["state"]["x"], torch.arange(4))
    assert [s for s, _ in mgr.last_skipped] == [1]
    mgr.close()


def test_jax_snapshot_refused_before_unpickling(tmp_path, monkeypatch):
    from photon_tpu.checkpoint import CheckpointManager as JaxManager

    ckdir = tmp_path / "ck"
    shutil.copytree(JAX_SNAPSHOT, ckdir)
    # the fixture is a real JAX snapshot: its own package loads it
    jm = JaxManager(str(ckdir))
    assert jm.load_latest()["meta"]["kind"] == "game_fit"
    jm.close()
    monkeypatch.setattr(pickle, "loads", _never_unpickle)
    mgr = CheckpointManager(str(ckdir))
    with pytest.raises(ForeignCheckpoint, match="not a snapshot of photon_tpu_torch"):
        mgr.load_latest()
    with pytest.raises(ForeignCheckpoint):
        mgr.load_checked("game_fit", "any")
    mgr.close()


def _never_unpickle(_blob):
    raise AssertionError("a foreign snapshot reached pickle.loads")


def test_port_fit_matches_jax_f64(fits):
    _, _, port, jax_results = fits
    for t, j in zip(final_arrays(port), [
            np.asarray(jax_results[0].model["fixed"].model.coefficients.means),
            *[np.asarray(c) for c in jax_results[0].model["perUser"].bucket_coefs]]):
        assert np.abs(t.numpy() - j).max() <= 1e-9 * max(np.abs(j).max(), 1e-30)


@pytest.mark.parametrize("fail_after", [1, 2, 3])
def test_kill_and_resume_bit_identical(tmp_path, fits, fail_after):
    a, v, ref, jax_results = fits
    ckdir = str(tmp_path / "ck")
    mgr = CheckpointManager(ckdir, fail_after=fail_after)
    with pytest.raises(KeyboardInterrupt):
        estimator().fit(torch_bundle(a), torch_bundle(v), configs(),
                        checkpoint_manager=mgr)
    mgr.close()
    mgr2 = CheckpointManager(ckdir)
    resumed = estimator().fit(torch_bundle(a), torch_bundle(v), configs(),
                              checkpoint_manager=mgr2)
    mgr2.close()
    assert_same_fits(resumed, ref)
    # and the resumed f64 fit sits on the JAX package's
    jfx = np.asarray(jax_results[0].model["fixed"].model.coefficients.means)
    got = resumed[0].model["fixed"].model.coefficients.means.numpy()
    assert np.abs(got - jfx).max() <= 1e-9 * np.abs(jfx).max()


def test_resume_refuses_changed_run(tmp_path, fits):
    a, v, _, _ = fits
    ckdir = str(tmp_path / "ck")
    mgr = CheckpointManager(ckdir, fail_after=2)
    with pytest.raises(KeyboardInterrupt):
        estimator().fit(torch_bundle(a), torch_bundle(v), configs(),
                        checkpoint_manager=mgr)
    mgr.close()
    changed = [{cid: GLMOptimizationConfiguration(
        regularization=RegularizationContext(RegularizationType.L2),
        max_iterations=15, reg_weight=2.0) for cid in ("fixed", "perUser")}]
    mgr2 = CheckpointManager(ckdir)
    with pytest.raises(ValueError, match="different configuration"):
        estimator().fit(torch_bundle(a), torch_bundle(v), changed,
                        checkpoint_manager=mgr2)
    mgr2.close()
