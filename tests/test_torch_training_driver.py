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
that brings it (``--re-routing`` only with ``measured``), and so is every
coordinate kind or option of a later slice (factored random effects,
host-resident buckets). With ``--normalization STANDARDIZATION
--feature-summary``, down-sampling and an L1 OWL-QN random effect, each
driver's model scores alike under both scoring drivers and the two feature
summaries agree. The driver's data sanity checks fail on the same rows as
the JAX package's. Random-effect training through the drivers is held
against JAX in ``tests/test_torch_re_training.py``.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu.cli import game_scoring_driver as jax_scoring
from photon_tpu.cli import game_training_driver as jax_training
from photon_tpu.io.avro import read_records
from photon_tpu_torch.cli import game_scoring_driver, game_training_driver
from photon_tpu_torch.game import random_effect as tre
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
    # the port's summary also names the reader that ran and its seconds
    assert ps["reader"] == "native" and ps["read_seconds"] >= 0
    port_only = ("fit_seconds", "model_dirs", "reader", "read_seconds")
    assert {k: v for k, v in ps.items() if k not in port_only} == \
        {k: v for k, v in js.items() if k not in port_only}
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


NORMALIZED_SPECS = [
    "fixed:type=fixed,shard=global,reg=L2,reg_weights=1,downsample=0.5,variance=SIMPLE",
    "perUser:type=random,re_type=userId,shard=global,optimizer=OWLQN,reg=L1,"
    "reg_weights=0.2,downsample=0.7,max_iter=30",
]


def _summary(path):
    return {(r["featureName"], r["featureTerm"]): r["metrics"]
            for r in read_records(str(path))}


def test_normalized_drivers_cross_score_and_summaries_agree(data, tmp_path):
    common = ["--train-data", str(data / "train.avro"), "--task",
              "LOGISTIC_REGRESSION", "--coordinate", NORMALIZED_SPECS[0],
              "--coordinate", NORMALIZED_SPECS[1], "--sweeps", "2",
              "--dtype", "float64", "--normalization", "STANDARDIZATION",
              "--feature-summary"]
    js = jax_training.run(common + ["--output-dir", str(tmp_path / "jax"),
                                    "--devices", "1"])
    ps = game_training_driver.run(common + ["--output-dir", str(tmp_path / "port"),
                                            "--device", "cpu"])
    strip = ("fit_seconds", "model_dirs", "reader", "read_seconds")
    assert {k: v for k, v in ps.items() if k not in strip} == \
        {k: v for k, v in js.items() if k not in strip}
    jsum = _summary(tmp_path / "jax" / "summary" / "global.avro")
    psum = _summary(tmp_path / "port" / "summary" / "global.avro")
    assert set(psum) == set(jsum) and len(jsum) > 10
    for k, want in jsum.items():
        for m, v in want.items():
            assert abs(psum[k][m] - v) <= 1e-12 * max(abs(v), 1.0), (k, m)
    pm, _ = _saved(tmp_path / "port" / "best")
    jm, _ = _saved(tmp_path / "jax" / "best")
    assert set(pm) == set(jm)
    assert max(abs(pm[k] - jm[k]) for k in jm) <= 1e-8 * max(map(abs, jm.values()))
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
    "--max-restarts": ["1"],
    "--restart-backoff": ["2"], "--heartbeat-dir": ["hb"], "--tuning": ["gp"],
    "--tuning-iterations": ["3"], "--tuning-range": ["fixed:0.1:10"],
    "--devices": ["2"], "--mesh": ["data=2"], "--bf16-feed": [],
    "--profile-dir": ["prof"], "--debug-nans": [], "--trace-out": ["t.json"],
    "--telemetry-dir": ["tel"], "--backend-policy": ["strict"],
    "--distributed-policy": ["strict"], "--fault-plan": ["plan.json"],
    "--compilation-cache-dir": ["cc"], "--compile-store": ["cs"],
    "--clear-caches-per-config": [],
}
REFUSED_COORDINATES = {
    "factored": "perUser:type=factored,re_type=userId,shard=global,latent=2",
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


def test_bf16_feed_names_its_slice(tmp_path, capsys):
    with pytest.raises(SystemExit):
        game_training_driver.run(_base_args(tmp_path) + ["--bf16-feed"])
    assert "K1-bf16" in capsys.readouterr().err


GAME_SPECS = [
    "fixed:type=fixed,shard=global,reg=L2,reg_weights=1,max_iter=30",
    "perUser:type=random,re_type=userId,shard=global,reg=L2,reg_weights=1,"
    "max_iter=30",
]


def _seed_cost_table(path, train_avro):
    """One cost table for both packages: every (solver, ladder chunk) of
    every bucket shape of the drivers' random effect, the vmapped lanes
    cheapest, under each package's own key (bucket shapes are equal)."""
    from photon_tpu_torch.estimators.config import RandomEffectDataConfig
    from photon_tpu_torch.estimators.game_estimator import build_re_dataset_from_bundle
    from photon_tpu_torch.game import newton_re, solver_routing
    from photon_tpu_torch.io.data_reader import AvroDataReader, build_index_from_avro

    im = build_index_from_avro(train_avro)
    bundle = AvroDataReader({"global": im}, id_tag_columns=["userId"]).read(
        train_avro, dtype=torch.float64, device=torch.device("cpu"))
    ds = build_re_dataset_from_bundle(bundle, RandomEffectDataConfig("userId"),
                                      im.intercept_index)
    costs = {f"{s}@{c}": (1e-9 if s == "vmapped_lbfgs" else 1e9)
             for s in ("newton_primal", "newton_dual", "vmapped_lbfgs")
             for c in newton_re.chunk_ladder()}
    entries = {}
    for b in ds.buckets:
        key = solver_routing.shape_class(b)
        entries[key] = entries[key.split("/")[-1]] = costs
    json.dump({"version": 1, "entries": entries}, open(path, "w"))


FLAG_CASES = {
    "checkpoint_ingest": (GAME_SPECS, ["--checkpoint-dir", "{tmp}/{pkg}_ck",
                                       "--ingest-workers", "2",
                                       "--prefetch-depth", "1"]),
    "measured_routing": (GAME_SPECS, ["--re-routing", "measured",
                                      "--re-cost-table", "{tmp}/costs.json"]),
    "sweep_cache": ([GAME_SPECS[0], GAME_SPECS[1] + ",host_resident=1"],
                    ["--sweep-cache-mb", "64"]),
}


@pytest.mark.parametrize("case", list(FLAG_CASES))
def test_ported_flags_write_jax_models(data, tmp_path, monkeypatch, case):
    """The flags this slice ports run, and the port's driver writes the
    model the JAX driver writes given the same flags (f64, 2 sweeps)."""
    from test_torch_re_training import _saved_re
    from photon_tpu.game import solver_routing as jsr
    from photon_tpu_torch.game import solver_routing as tsr

    specs, flags = FLAG_CASES[case]
    flags = [f.replace("{tmp}", str(tmp_path)) for f in flags]
    # the drivers install their routing flags in the environment
    monkeypatch.setenv("PHOTON_RE_ROUTING", "static")
    monkeypatch.setenv("PHOTON_RE_COST_TABLE", "")
    monkeypatch.setenv("PHOTON_RE_CHUNK_LADDER", "4,8")
    for mod in (tsr, jsr):
        mod.reset_process_table()
    if case == "measured_routing":
        _seed_cost_table(tmp_path / "costs.json", str(data / "train.avro"))
    train = [str(data / "train.avro")] + (
        [str(data / "score.avro")] if case == "checkpoint_ingest" else [])
    common = ["--train-data", *train, "--task", "LOGISTIC_REGRESSION",
              "--coordinate", specs[0], "--coordinate", specs[1],
              "--sweeps", "2", "--dtype", "float64", *flags]
    try:
        jax_training.run([a.replace("{pkg}", "jax") for a in common]
                         + ["--output-dir", str(tmp_path / "jax"), "--devices", "1"])
        ps = game_training_driver.run(
            [a.replace("{pkg}", "port") for a in common]
            + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    finally:
        for mod in (tsr, jsr):
            mod.reset_process_table()
    assert ps["reader"] == "native"
    pm, jm = _saved(tmp_path / "port" / "best")[0], _saved(tmp_path / "jax" / "best")[0]
    _close_maps(pm, jm)
    pr, jr = _saved_re(tmp_path / "port" / "best"), _saved_re(tmp_path / "jax" / "best")
    assert set(pr) == set(jr) and len(pr) > 20
    assert max(abs(pr[k] - jr[k]) for k in jr) <= 1e-8
    if case == "checkpoint_ingest":
        # each package refuses the other's snapshots: separate directories
        assert any(n.startswith("step-") for n in os.listdir(tmp_path / "port_ck"))
    if case == "measured_routing":
        recs = tre.bucket_records()
        assert recs and all(r["routing"] == "measured" and not r["calibrated"]
                            and r["solver"] == "vmapped_lbfgs" for r in recs)
