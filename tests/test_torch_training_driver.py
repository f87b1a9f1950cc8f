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
that brings it (its compile-cache flags for good), and each runtime-guard
flag trains the model a run without it trains. With
``--normalization STANDARDIZATION --feature-summary``, down-sampling and an
L1 OWL-QN random effect, each driver's model scores alike under both
scoring drivers and the two feature summaries agree. The driver's data
sanity checks fail on the same rows as the JAX package's. ``--tuning gp``
and ``--tuning random`` (with ``--checkpoint-dir``) choose the JAX driver's
weights and write its model, a rerun resuming from the trial snapshots, and
the tuning checks fail with the JAX driver's messages; a ``type=factored``
random effect trains the JAX driver's model, which the JAX scoring driver
scores as the port's does, and the factored refusals (down-sampling,
normalization, variances, incremental training) are the JAX driver's. Random-effect training through the drivers is held
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
from test_torch_jax_decoder import jax_decoder  # noqa: F401

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


# Each refused flag with a value that sets it. The compile-cache flags are
# refused for good (the port compiles no XLA programs). A mesh's ``model``
# axis is taken, so ``--mesh data=2,model=2`` is refused on the CPU's one
# device only for want of devices, before any work. ``--devices``, ``--mesh
# data=...`` and ``--distributed-policy`` are taken
# (tests/test_torch_distributed.py).
REFUSED = {
    "--mesh": ["data=2,model=2"],
    "--compilation-cache-dir": ["cc"], "--compile-store": ["cs"],
    "--clear-caches-per-config": [],
}
FOR_GOOD = {"--compilation-cache-dir", "--compile-store", "--clear-caches-per-config"}


def _base_args(tmp_path, coordinate="fixed:type=fixed,shard=global"):
    return ["--train-data", str(tmp_path / "x.avro"), "--output-dir",
            str(tmp_path / "out"), "--task", "LOGISTIC_REGRESSION",
            "--coordinate", coordinate, "--device", "cpu"]


def test_refused_table_covers_every_later_flag():
    assert FOR_GOOD == {flag for flag, _, _ in game_training_driver._LATER_SLICES}
    assert FOR_GOOD <= set(REFUSED)


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
    if flag in FOR_GOOD:
        assert flag in err and "refused for good" in err and "compiles no XLA" in err
    else:
        assert "--mesh needs 4 devices, have 1" in err
    assert not (tmp_path / "out").exists()


# The observability flags, refused until the port had them: each with its
# value (under tmp_path) and the artefact it leaves.
OBSERVABILITY_FLAGS = {"--profile-dir": "prof", "--trace-out": "t.json",
                       "--telemetry-dir": "tel"}


@pytest.mark.parametrize("flag", list(OBSERVABILITY_FLAGS))
def test_observability_flags_are_taken(data, tmp_path, flag):
    """Each observability flag trains the model a run without it trains
    and writes its artefact: the profile named in the summary, the trace
    with the run's steps, or the trace and registry shards under the fleet
    names (``tests/test_torch_trace_parity.py`` holds them against JAX)."""
    value = str(tmp_path / OBSERVABILITY_FLAGS[flag])
    base = ["--train-data", str(data / "train.avro"), "--task", "LOGISTIC_REGRESSION",
            "--coordinate", CONFIGS["logistic_lbfgs"][1], "--dtype", "float64",
            "--device", "cpu"]
    got = game_training_driver.run(base + ["--output-dir", str(tmp_path / "on"),
                                           flag, value])
    want = game_training_driver.run(base + ["--output-dir", str(tmp_path / "off")])
    assert _saved(tmp_path / "on" / "best") == _saved(tmp_path / "off" / "best")
    assert got["evaluation"] == want["evaluation"]
    pid = os.getpid()
    if flag == "--profile-dir":
        assert got["profile"] == os.path.join(value, f"profile.{pid}.json")
        assert json.load(open(got["profile"]))["traceEvents"]
    else:
        trace = (value if flag == "--trace-out"
                 else os.path.join(value, f"trace.training.{pid}.json"))
        names = [e["name"] for e in json.load(open(trace))["traceEvents"]]
        assert names.count("descent.step") == 2 and "photon.anchor" in names
        assert "profile" not in got
    if flag == "--telemetry-dir":
        assert sorted(os.listdir(value)) == [f"registry.training.{pid}.json",
                                             f"trace.training.{pid}.json"]


# The runtime-guard flags of the JAX driver, each with a value that sets it,
# and what the run shows for it (``tests/test_torch_chaos.py`` drives them
# through faults).
GUARD_FLAGS = {
    "--max-restarts": ["1"],
    "--restart-backoff": ["0.5", "--max-restarts", "1"],
    "--heartbeat-dir": ["HB"],
    "--debug-nans": [],
    "--backend-policy": ["cpu-only"],
    "--fault-plan": ["PLAN"],
}


@pytest.mark.parametrize("flag", list(GUARD_FLAGS))
def test_runtime_guard_flags_are_taken(data, tmp_path, flag):
    """Each flag the runtime-guards slice ports trains the same model as a
    run without it (``--backend-policy cpu-only`` without ``--device cpu``:
    the CPU, no probe; ``--fault-plan`` with a transient read error that
    the ingest retries)."""
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"seed": 0, "specs": [
        {"site": "io.block_read", "error": "os", "count": 1}]}))
    values = [str(tmp_path / "hb") if v == "HB" else str(plan) if v == "PLAN" else v
              for v in GUARD_FLAGS[flag]]
    base = ["--train-data", str(data / "train.avro"), "--task", "LOGISTIC_REGRESSION",
            "--coordinate", CONFIGS["logistic_lbfgs"][1], "--dtype", "float64"]
    device = [] if flag == "--backend-policy" else ["--device", "cpu"]
    got = game_training_driver.run(base + device + [
        "--output-dir", str(tmp_path / "on"), flag, *values])
    want = game_training_driver.run(base + ["--device", "cpu", "--output-dir",
                                            str(tmp_path / "off")])
    assert _saved(tmp_path / "on" / "best") == _saved(tmp_path / "off" / "best")
    assert got["evaluation"] == want["evaluation"] and "backend" not in got
    journal = tmp_path / "on" / "recovery.jsonl"
    if "--max-restarts" in [flag, *values]:
        rows = [json.loads(r) for r in journal.read_text().splitlines()]
        assert [r["event"] for r in rows] == ["attempt_start", "first_step", "run_ok"]
    else:
        assert not journal.exists()
    if flag == "--fault-plan":     # the injected read error was retried
        assert "transient read error" in (tmp_path / "on" / "photon.log").read_text()
    if flag == "--heartbeat-dir":
        beat = json.loads((tmp_path / "hb" / "host-0.hb").read_text())
        assert beat["process_id"] == 0 and beat["epoch"] == 0


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
    """``--bf16-feed`` is ported (``tests/test_torch_bf16.py``); as in the
    JAX driver it cannot honor ``--dtype float64`` and says so."""
    with pytest.raises(ValueError, match="--bf16-feed.*float64"):
        game_training_driver.run(_base_args(tmp_path) + ["--bf16-feed",
                                                         "--dtype", "float64"])
    assert "--bf16-feed" not in {f for f, _, _ in game_training_driver._LATER_SLICES}


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


TUNING_SPECS = [
    "fixed:type=fixed,shard=global,reg=L2,reg_weights=1,max_iter=20",
    "perUser:type=random,re_type=userId,shard=global,reg=L2,reg_weights=1,"
    "max_iter=20",
]


def _tuning_args(data, out, strategy, extra=()):
    return ["--train-data", str(data / "train.avro"),
            "--validation-data", str(data / "score.avro"),
            "--evaluators", "AUC", "--output-dir", str(out),
            "--task", "LOGISTIC_REGRESSION", "--dtype", "float64",
            "--coordinate", TUNING_SPECS[0], "--coordinate", TUNING_SPECS[1],
            "--tuning", strategy, "--tuning-iterations", "3",
            "--tuning-range", "fixed:0.01:100", "--tuning-range", "perUser:0.01:100",
            *extra]


@pytest.mark.parametrize("strategy", ["gp", "random"])
def test_tuning_driver_matches_jax_and_resumes(data, tmp_path, strategy):
    """``--tuning`` with ``--checkpoint-dir``: the port picks the JAX
    driver's weights (1e-9) and saves its model (1e-8); a rerun over the
    same checkpoint directory resumes past every trial and writes the same
    summary."""
    from test_torch_re_training import _saved_re

    js = jax_training.run(_tuning_args(
        data, tmp_path / "jax", strategy,
        ["--checkpoint-dir", str(tmp_path / "jax_ck"), "--devices", "1"]))
    port = _tuning_args(data, tmp_path / "port", strategy,
                        ["--checkpoint-dir", str(tmp_path / "port_ck"),
                         "--device", "cpu"])
    ps = game_training_driver.run(port)
    assert ps["n_configs"] == 1 and ps["best_config_index"] == 0
    for cid in ("fixed", "perUser"):
        got = ps["best_config"][cid]["reg_weight"]
        want = js["best_config"][cid]["reg_weight"]
        assert abs(got - want) <= 1e-9 * want and 0.01 <= got <= 100
    assert abs(ps["evaluation"]["AUC"] - js["evaluation"]["AUC"]) <= 1e-9
    _close_maps(_saved(tmp_path / "port" / "best")[0],
                _saved(tmp_path / "jax" / "best")[0])
    pr, jr = _saved_re(tmp_path / "port" / "best"), _saved_re(tmp_path / "jax" / "best")
    assert set(pr) == set(jr) and max(abs(pr[k] - jr[k]) for k in jr) <= 1e-8
    steps = sorted(n for n in os.listdir(tmp_path / "port_ck") if n.startswith("step-"))
    assert steps == ["step-2", "step-3"]
    log = (tmp_path / "port" / "photon.log").read_text()
    assert "tuning best params" in log and "hyperparameter tuning: done" in log
    again = game_training_driver.run(port)
    assert {k: v for k, v in again.items() if not k.endswith("seconds")} == \
        {k: v for k, v in ps.items() if not k.endswith("seconds")}


TUNING_CHECKS = {
    "no_evaluators": (["--tuning", "gp", "--tuning-range", "fixed:0.1:10"], False),
    "no_range": (["--tuning", "gp"], True),
    "no_iterations": (["--tuning", "random", "--tuning-iterations", "0",
                       "--tuning-range", "fixed:0.1:10"], True),
    "grid_sweep": (["--tuning", "gp", "--tuning-range", "fixed:0.1:10"], True),
}


@pytest.mark.parametrize("case", list(TUNING_CHECKS))
def test_tuning_checks_match_jax(data, tmp_path, case):
    flags, validated = TUNING_CHECKS[case]
    spec = ("fixed:type=fixed,shard=global,reg=L2,reg_weights="
            + ("1|10" if case == "grid_sweep" else "1"))
    common = ["--train-data", str(data / "train.avro"), "--task",
              "LOGISTIC_REGRESSION", "--coordinate", spec, *flags]
    if validated:
        common += ["--validation-data", str(data / "score.avro"),
                   "--evaluators", "AUC"]
    with pytest.raises(ValueError) as jerr:
        jax_training.run(common + ["--output-dir", str(tmp_path / "j"),
                                   "--devices", "1"])
    with pytest.raises(ValueError) as terr:
        game_training_driver.run(common + ["--output-dir", str(tmp_path / "t"),
                                           "--device", "cpu"])
    assert str(terr.value) == str(jerr.value) and "--tuning" in str(terr.value)


FACTORED_SPECS = [
    "fixed:type=fixed,shard=global,reg=L2,reg_weights=1,max_iter=20",
    "perUser:type=factored,re_type=userId,shard=global,reg=L2,reg_weights=1,"
    "max_iter=20,latent=2",
]


@pytest.fixture(scope="module")
def factored_runs(data, tmp_path_factory):
    """Both drivers' f64 runs with a factored random effect (2 sweeps)."""
    root = tmp_path_factory.mktemp("factored_drivers")
    common = ["--train-data", str(data / "train.avro"), "--task",
              "LOGISTIC_REGRESSION", "--dtype", "float64", "--sweeps", "2",
              "--coordinate", FACTORED_SPECS[0], "--coordinate", FACTORED_SPECS[1]]
    js = jax_training.run(common + ["--output-dir", str(root / "jax"),
                                    "--devices", "1"])
    ps = game_training_driver.run(common + ["--output-dir", str(root / "port"),
                                            "--device", "cpu"])
    return root, js, ps


def test_factored_driver_scored_by_jax(data, factored_runs):
    """The port's factored model: the JAX driver's (saved means 1e-6),
    saved in its layout, and the JAX scoring driver scores it as the port's
    scoring driver does (1e-9)."""
    from test_torch_re_training import _saved_re

    root, js, ps = factored_runs
    cdir = root / "port" / "best" / "random-effect" / "perUser"
    assert np.load(cdir / "projection.npy").shape[1] == 2
    meta = json.loads((root / "port" / "best" / "game-metadata.json").read_text())
    assert meta["coordinates"]["perUser"]["factored_latent_dim"] == 2
    pr, jr = _saved_re(root / "port" / "best"), _saved_re(root / "jax" / "best")
    assert set(pr) == set(jr) and len(pr) > 10
    scale = max(map(abs, jr.values()))
    assert max(abs(pr[k] - jr[k]) for k in jr) <= 1e-6 * scale
    port_own = _scores(game_scoring_driver, data, root / "port" / "best",
                       root / "s_pp", ["--device", "cpu"])
    jax_on_port = _scores(jax_scoring, data, root / "port" / "best", root / "s_jp")
    assert np.std(port_own) > 0.05
    np.testing.assert_allclose(jax_on_port, port_own, rtol=0, atol=1e-9)


FACTORED_REFUSALS = {
    "down-sampling": ([FACTORED_SPECS[1] + ",downsample=0.5"], []),
    "feature normalization": ([FACTORED_SPECS[1]],
                              ["--normalization", "STANDARDIZATION"]),
    "coefficient variances": ([FACTORED_SPECS[1] + ",variance=SIMPLE"], []),
    "incremental training": ([FACTORED_SPECS[1] + ",incremental=1"],
                             ["--model-input-dir", "{model}"]),
}


@pytest.mark.parametrize("knob", list(FACTORED_REFUSALS))
def test_factored_refusals_match_jax(data, factored_runs, tmp_path, knob):
    root = factored_runs[0]
    specs, flags = FACTORED_REFUSALS[knob]
    flags = [f.replace("{model}", str(root / "port" / "best")) for f in flags]
    common = ["--train-data", str(data / "train.avro"), "--task",
              "LOGISTIC_REGRESSION", "--dtype", "float64",
              "--coordinate", FACTORED_SPECS[0], "--coordinate", specs[0], *flags]
    with pytest.raises(ValueError) as jerr:
        jax_training.run(common + ["--output-dir", str(tmp_path / "j"),
                                   "--devices", "1"])
    with pytest.raises(ValueError) as terr:
        game_training_driver.run(common + ["--output-dir", str(tmp_path / "t"),
                                           "--device", "cpu"])
    assert str(terr.value) == str(jerr.value)
    assert f"{knob} not supported for factored random effects" in str(terr.value)
