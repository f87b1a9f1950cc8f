"""The PyTorch port's training driver against the JAX training driver.

Both drivers train fixed-effect-only models on the same Avro data (written
as ``tests/test_torch_scoring_driver.py`` writes it, with offsets), in
``--dtype float64``, the port's with ``--device cpu``: logistic L-BFGS L2
with SIMPLE variances (a two-weight sweep, ``--output-mode ALL``), Poisson
TRON L2, and linear OWL-QN L1. Saved means and variances agree to ``atol
1e-8`` and the summaries match. Each package's scoring driver then scores
the other package's model, and those scores agree with the package's scores
of its own model to the scoring test's float64 ``atol 1e-12``. Every flag
of the JAX driver is either taken by the port's or refused with the slice
that brings it, and so is every coordinate kind of a later slice. The
driver's data sanity checks fail on the same rows as the JAX package's.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu.cli import game_scoring_driver as jax_scoring
from photon_tpu.cli import game_training_driver as jax_training
from photon_tpu.io.avro import read_records
from photon_tpu_torch.cli import game_scoring_driver, game_training_driver
from test_torch_scoring_driver import _write_game_avro

CONFIGS = {
    "logistic_lbfgs": ("LOGISTIC_REGRESSION",
                       "fixed:type=fixed,shard=global,reg=L2,reg_weights=1|10,variance=SIMPLE"),
    "poisson_tron": ("POISSON_REGRESSION",
                     "fixed:type=fixed,shard=global,optimizer=TRON,reg=L2,reg_weights=1,variance=SIMPLE"),
    "linear_owlqn": ("LINEAR_REGRESSION",
                     "fixed:type=fixed,shard=global,optimizer=OWLQN,reg=L1,reg_weights=0.3"),
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    # A live jax backend in this process spares the JAX drivers their
    # backend probe, which takes a machine-wide lock for the process's life.
    jnp.zeros(1).block_until_ready()
    d = tmp_path_factory.mktemp("torch_training")
    _write_game_avro(d / "train.avro", seed=1, offsets=True)
    _write_game_avro(d / "score.avro", seed=2, n_users=10, rows_per_user=6,
                     offsets=True)
    return d


def _train(driver, d, out, task, spec, extra):
    return driver.run([
        "--train-data", str(d / "train.avro"), "--output-dir", str(out),
        "--task", task, "--coordinate", spec, "--dtype", "float64",
        "--output-mode", "ALL", *extra,
    ])


def _saved(model_dir):
    (rec,) = read_records(str(model_dir / "fixed-effect" / "fixed" / "coefficients.avro"))
    return ({(m["name"], m["term"]): m["value"] for m in rec["means"]},
            {(m["name"], m["term"]): m["value"] for m in rec["variances"] or ()})


def _close_maps(got, want):
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-8, (k, got[k], want[k])


def _scores(driver, d, model_dir, dest, extra=()):
    driver.run(["--data", str(d / "score.avro"), "--model-dir", str(model_dir),
                "--output-dir", str(dest), "--dtype", "float64", *extra])
    return np.array([r["predictionScore"] for r in read_records(str(dest / "scores.avro"))])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_training_driver_matches_jax(data, tmp_path, name):
    task, spec = CONFIGS[name]
    js = _train(jax_training, data, tmp_path / "jax", task, spec, ["--devices", "1"])
    ps = _train(game_training_driver, data, tmp_path / "port", task, spec,
                ["--device", "cpu"])
    assert set(ps["model_dirs"]) == set(js["model_dirs"]) >= {"best", "0"}
    assert {k: v for k, v in ps.items() if k not in ("fit_seconds", "model_dirs")} == \
        {k: v for k, v in js.items() if k not in ("fit_seconds", "model_dirs")}
    assert json.loads((tmp_path / "port" / "training-summary.json").read_text()) == ps
    for sub in ps["model_dirs"]:
        rel = "best" if sub == "best" else f"models/{sub}"
        pm, pv = _saved(tmp_path / "port" / rel)
        jm, jv = _saved(tmp_path / "jax" / rel)
        _close_maps(pm, jm)
        _close_maps(pv, jv)
        assert len(pm) > 5 and (bool(pv) == ("SIMPLE" in spec))
    assert (tmp_path / "port" / "index" / "global" / "index-meta.json").exists()
    plines = (tmp_path / "port" / "metrics.jsonl").read_text().splitlines()
    jlines = (tmp_path / "jax" / "metrics.jsonl").read_text().splitlines()
    assert [sorted(json.loads(x)) for x in plines] == [sorted(json.loads(x)) for x in jlines]

    # Each scoring driver scores the other package's model as its own.
    cpu = ["--device", "cpu"]
    port_own = _scores(game_scoring_driver, data, tmp_path / "port" / "best",
                       tmp_path / "s_pp", cpu)
    port_on_jax = _scores(game_scoring_driver, data, tmp_path / "jax" / "best",
                          tmp_path / "s_pj", cpu)
    jax_own = _scores(jax_scoring, data, tmp_path / "jax" / "best", tmp_path / "s_jj")
    jax_on_port = _scores(jax_scoring, data, tmp_path / "port" / "best", tmp_path / "s_jp")
    assert np.std(port_own) > 0.05
    np.testing.assert_allclose(port_on_jax, port_own, rtol=0, atol=1e-12)
    np.testing.assert_allclose(jax_on_port, jax_own, rtol=0, atol=1e-12)


# Each refused flag with a value that sets it.
REFUSED = {
    "--validation-data": ["x.avro"], "--evaluators": ["AUC"],
    "--normalization": ["STANDARDIZATION"], "--feature-summary": [],
    "--checkpoint-dir": ["ckpt"], "--max-restarts": ["1"],
    "--restart-backoff": ["2"], "--heartbeat-dir": ["hb"], "--tuning": ["gp"],
    "--tuning-iterations": ["3"], "--tuning-range": ["fixed:0.1:10"],
    "--devices": ["2"], "--mesh": ["data=2"], "--ingest-workers": ["4"],
    "--prefetch-depth": ["2"], "--bf16-feed": [], "--sweep-cache-mb": ["64"],
    "--profile-dir": ["prof"], "--debug-nans": [], "--trace-out": ["t.json"],
    "--telemetry-dir": ["tel"], "--backend-policy": ["strict"],
    "--distributed-policy": ["strict"], "--fault-plan": ["plan.json"],
    "--compilation-cache-dir": ["cc"], "--compile-store": ["cs"],
    "--clear-caches-per-config": [], "--re-routing": ["static"],
    "--re-cost-table": ["costs.json"],
}
REFUSED_COORDINATES = {
    "random": "perUser:type=random,re_type=userId,shard=global",
    "factored": "perUser:type=factored,re_type=userId,shard=global,latent=2",
    "downsample": "fixed:type=fixed,shard=global,downsample=0.5",
}


def _base_args(tmp_path, coordinate="fixed:type=fixed,shard=global"):
    return ["--train-data", str(tmp_path / "x.avro"), "--output-dir",
            str(tmp_path / "out"), "--task", "LOGISTIC_REGRESSION",
            "--coordinate", coordinate, "--device", "cpu"]


def test_refused_table_covers_every_later_flag():
    assert set(REFUSED) == {flag for flag, _, _ in game_training_driver._LATER_SLICES}


def test_every_jax_flag_is_taken_or_refused():
    jax_flags = set(jax_training.build_arg_parser()._option_string_actions)
    port_flags = set(game_training_driver.build_arg_parser()._option_string_actions)
    assert jax_flags - port_flags == set()


@pytest.mark.parametrize("flag", list(REFUSED))
def test_later_slice_flags_are_refused(tmp_path, capsys, flag):
    with pytest.raises(SystemExit) as e:
        game_training_driver.run(_base_args(tmp_path) + [flag, *REFUSED[flag]])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert flag in err and "not in the port yet" in err and "slice" in err
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("kind", list(REFUSED_COORDINATES))
def test_later_slice_coordinates_are_refused(tmp_path, capsys, kind):
    with pytest.raises(SystemExit) as e:
        game_training_driver.run(_base_args(tmp_path, REFUSED_COORDINATES[kind]))
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "--coordinate" in err and "not in the port yet" in err and "slice" in err


def test_training_driver_defaults_to_cuda_and_raises_without_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _base_args(tmp_path)[:-2]
    assert game_training_driver.build_arg_parser().parse_args(args).device == "cuda"
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            game_training_driver.run(args + extra)
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("task", ["LOGISTIC_REGRESSION", "POISSON_REGRESSION",
                                  "LINEAR_REGRESSION"])
@pytest.mark.parametrize("mode", ["VALIDATE_FULL", "VALIDATE_SAMPLE"])
def test_sanity_checks_match_jax(task, mode):
    """``sanity_check_data`` raises with the JAX package's list of failed
    checks on the same bad rows (and passes where it passes)."""
    from photon_tpu.data.batch import LabeledBatch as JaxBatch
    from photon_tpu.data.batch import SparseFeatures as JaxFeatures
    from photon_tpu.data.validators import DataValidationError as JaxError
    from photon_tpu.data.validators import DataValidationType as JaxMode
    from photon_tpu.data.validators import sanity_check_data as jax_check
    from photon_tpu.types import TaskType as JaxTask
    from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures
    from photon_tpu_torch.data.validators import (
        DataValidationError,
        DataValidationType,
        sanity_check_data,
    )
    from photon_tpu_torch.types import TaskType

    rng = np.random.default_rng(3)
    n = 40
    idx = rng.integers(0, 10, size=(n, 3)).astype(np.int32)
    val = rng.normal(size=(n, 3))
    y = rng.integers(0, 2, size=n).astype(np.float64)
    off, wt = np.zeros(n), np.ones(n)
    val[3, 1] = np.nan
    off[5] = np.inf
    wt[7] = -1.0
    y[9], y[11] = 2.0, -1.0
    y[13] = np.nan
    val[15, 0], wt[15] = np.inf, 0.0         # padding rows are skipped

    def outcome(check, error, batch, t, m, sample):
        try:
            check(batch, t, m, sample)
        except error as e:
            return e.failures
        return []

    for sample in (n, 8):
        want = outcome(jax_check, JaxError, JaxBatch(
            JaxFeatures(jnp.asarray(idx), jnp.asarray(val), 10), jnp.asarray(y),
            jnp.asarray(off), jnp.asarray(wt)), JaxTask[task], JaxMode[mode], sample)
        got = outcome(sanity_check_data, DataValidationError, LabeledBatch(
            SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), 10),
            torch.from_numpy(y), torch.from_numpy(off), torch.from_numpy(wt)),
            TaskType[task], DataValidationType[mode], sample)
        assert got == want and len(want) >= 3
