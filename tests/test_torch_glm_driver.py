"""The port's single-GLM training driver (in-core and out-of-core) and its
feature indexing driver, against the JAX package's drivers on the same Avro
files.

Tolerances:
* in-core, float64 (L-BFGS with SIMPLE variances and a bootstrap; OWL-QN
  L1): equal iterations; objectives within 1e-10 relative, metrics within
  1e-9; saved means and variances within 1e-8; the Hosmer–Lemeshow p-value
  within 1e-8 relative;
* out-of-core (the route is float32 only in both packages), capped at 6
  iterations so that neither stops on a float32 tie: equal iterations and
  ``data_passes``, objectives within 1e-6 relative, means within 1e-4;
* scores of one package's model by the other's scoring driver against the
  owner's scores: 1e-12 (float64 models), 1e-5 (float32);
* the feature index: the same files, byte for byte.
"""
from __future__ import annotations

import argparse
import filecmp
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu.cli import feature_indexing_driver as jax_indexing
from photon_tpu.cli import game_scoring_driver as jax_scoring
from photon_tpu.cli import glm_training_driver as jax_glm
from photon_tpu.io.avro import read_records, write_container
from photon_tpu_torch.cli import feature_indexing_driver, game_scoring_driver
from photon_tpu_torch.cli import glm_training_driver
from test_torch_jax_decoder import jax_decoder  # noqa: F401
from test_torch_scoring_driver import RECORD_SCHEMA, _write_game_avro

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    jnp.zeros(1).block_until_ready()
    d = tmp_path_factory.mktemp("torch_glm")
    _write_game_avro(d / "train.avro", seed=3, n_users=6, rows_per_user=40, offsets=True)
    _write_game_avro(d / "val.avro", seed=4, n_users=6, rows_per_user=10, offsets=True)
    return d


def _common(d, *extra):
    return ["--train-data", str(d / "train.avro"), "--validation-data",
            str(d / "val.avro"), "--task", "LOGISTIC_REGRESSION",
            "--reg-weights", "0.5", "2", *extra]


def _saved(model_dir):
    (rec,) = read_records(str(model_dir / "fixed-effect" / "fixed" / "coefficients.avro"))
    return ({(m["name"], m["term"]): m["value"] for m in rec["means"]},
            {(m["name"], m["term"]): m["value"] for m in rec["variances"] or ()})


def _close_maps(got, want, tol):
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= tol * max(1.0, abs(want[k])), (k, got[k], want[k])


def _scores(driver, d, model_dir, dest, extra=()):
    driver.run(["--data", str(d / "val.avro"), "--model-dir", str(model_dir),
                "--output-dir", str(dest), *extra])
    return np.array([r["predictionScore"] for r in read_records(str(dest / "scores.avro"))])


def _check_sweeps(ps, js, obj_rel, metric_tol):
    assert len(ps["sweep"]) == len(js["sweep"])
    for p, j in zip(ps["sweep"], js["sweep"]):
        assert set(p) == set(j)
        assert p["iterations"] == j["iterations"]
        assert p.get("data_passes") == j.get("data_passes")
        assert p["objective"] == pytest.approx(j["objective"], rel=obj_rel)
        for k in ("AUC", "LOGISTIC_LOSS"):
            assert abs(p[k] - j[k]) <= metric_tol, (k, p[k], j[k])
    assert ps["selected_reg_weight"] == js["selected_reg_weight"]


IN_CORE = {
    "lbfgs_variance_bootstrap": ["--variance", "SIMPLE", "--bootstrap-replicates", "4"],
    "owlqn_l1": ["--optimizer", "OWLQN", "--regularization", "L1", "--variance", "NONE"],
}


@pytest.mark.parametrize("case", list(IN_CORE))
def test_in_core_driver_matches_jax_and_cross_scores(data, tmp_path, case):
    args = _common(data, "--dtype", "float64", *IN_CORE[case])
    ps = glm_training_driver.run(args + ["--output-dir", str(tmp_path / "p")] + CPU)
    js = jax_glm.run(args + ["--output-dir", str(tmp_path / "j")])
    assert ps["mode"] == "in_core" and ps["value_dtype"] == "float64"
    _check_sweeps(ps, js, 1e-10, 1e-9)
    assert ps["hosmer_lemeshow_p"] == pytest.approx(js["hosmer_lemeshow_p"], rel=1e-8)
    port_only = {"mode", "value_dtype", "read_seconds", "fit_seconds", "report",
                 "model_dir", "sweep", "evaluation", "hosmer_lemeshow_p"}
    assert {k: v for k, v in ps.items() if k not in port_only} == \
        {k: v for k, v in js.items() if k not in port_only}
    pm, pv = _saved(tmp_path / "p" / "best")
    jm, jv = _saved(tmp_path / "j" / "best")
    _close_maps(pm, jm, 1e-8)
    _close_maps(pv, jv, 1e-8)
    assert bool(pv) == ("SIMPLE" in IN_CORE[case])
    pr = json.loads((tmp_path / "p" / "fit-report.json").read_text())
    jr = json.loads((tmp_path / "j" / "fit-report.json").read_text())
    assert set(pr) == set(jr) and pr["config"] == jr["config"]
    assert pr["n_bootstrap_replicates"] == jr["n_bootstrap_replicates"]
    for sub in ("index/global/index-meta.json", "best/game-metadata.json"):
        assert (tmp_path / "p" / sub).exists()
    port_own = _scores(game_scoring_driver, data, tmp_path / "p" / "best",
                       tmp_path / "s_pp", CPU + ["--dtype", "float64"])
    jax_on_port = _scores(jax_scoring, data, tmp_path / "p" / "best", tmp_path / "s_jp",
                          ["--dtype", "float64"])
    jax_own = _scores(jax_scoring, data, tmp_path / "j" / "best", tmp_path / "s_jj",
                      ["--dtype", "float64"])
    port_on_jax = _scores(game_scoring_driver, data, tmp_path / "j" / "best",
                          tmp_path / "s_pj", CPU + ["--dtype", "float64"])
    assert np.std(port_own) > 0.05
    np.testing.assert_allclose(jax_on_port, port_own, rtol=0, atol=1e-12)
    np.testing.assert_allclose(port_on_jax, jax_own, rtol=0, atol=1e-12)


OUT_OF_CORE = {
    "lbfgs": [],
    "owlqn_l1": ["--optimizer", "OWLQN", "--regularization", "L1"],
}


@pytest.mark.parametrize("case", list(OUT_OF_CORE))
def test_out_of_core_driver_matches_jax_and_resumes(data, tmp_path, case):
    args = _common(data, "--variance", "NONE", "--row-chunk-rows", "64",
                   "--max-iterations", "6", *OUT_OF_CORE[case])
    ps = glm_training_driver.run(args + ["--output-dir", str(tmp_path / "p")] + CPU)
    js = jax_glm.run(args + ["--output-dir", str(tmp_path / "j")])
    assert ps["mode"] == js["mode"] == "out_of_core"
    assert ps["n_chunks"] == js["n_chunks"] == 4        # 240 rows / 64
    assert ps["n_rows"] == js["n_rows"] == 240
    assert ps["streamed_gb_per_pass"] == js["streamed_gb_per_pass"]
    assert ps["value_dtype"] == "float32" and ps["h2d_bytes"] == 0
    _check_sweeps(ps, js, 1e-6, 1e-5)
    pm, _ = _saved(tmp_path / "p" / "best")
    jm, _ = _saved(tmp_path / "j" / "best")
    _close_maps(pm, jm, 1e-4)
    # each λ left a finished checkpoint: a rerun resumes it, the same bits
    assert sorted(os.listdir(tmp_path / "p" / "ooc_checkpoints")) == \
        ["lam_0.5.ckpt", "lam_2.ckpt"]
    again = glm_training_driver.run(args + ["--output-dir", str(tmp_path / "p")] + CPU)
    assert again["sweep"] == ps["sweep"]
    port_own = _scores(game_scoring_driver, data, tmp_path / "p" / "best",
                       tmp_path / "s_pp", CPU)
    jax_on_port = _scores(jax_scoring, data, tmp_path / "p" / "best", tmp_path / "s_jp")
    np.testing.assert_allclose(jax_on_port, port_own, rtol=0, atol=1e-5)


def test_out_of_core_bf16_values(data, tmp_path, monkeypatch):
    """PHOTON_VALUE_DTYPE=bfloat16 stores the chunks' values as bf16: the
    ELL pass's bytes are 6 an entry, and the fit still reads every row."""
    args = _common(data, "--variance", "NONE", "--row-chunk-rows", "64",
                   "--max-iterations", "6", "--no-report")
    f32 = glm_training_driver.run(args + ["--output-dir", str(tmp_path / "f")] + CPU)
    monkeypatch.setenv("PHOTON_VALUE_DTYPE", "bfloat16")
    b16 = glm_training_driver.run(args + ["--output-dir", str(tmp_path / "b")] + CPU)
    assert b16["value_dtype"] == "bfloat16"
    k_bytes = 4 * 64 * 6
    assert f32["streamed_gb_per_pass"] * 1e9 % k_bytes == 0
    width = round(f32["streamed_gb_per_pass"] * 1e9 / (4 * 64 * 8))
    assert round(b16["streamed_gb_per_pass"] * 1e9) == 4 * 64 * width * 6
    assert b16["sweep"][0]["AUC"] == pytest.approx(f32["sweep"][0]["AUC"], abs=0.02)


def _ns(**kw):
    base = dict(optimizer="LBFGS", regularization="L2", normalization="NONE",
                variance="NONE", dtype="float32", bootstrap_replicates=0)
    base.update(kw)
    return argparse.Namespace(**base)


GUARDS = {
    "ok": {}, "owlqn_l1": dict(optimizer="OWLQN", regularization="L1"),
    "owlqn_elastic": dict(optimizer="OWLQN", regularization="ELASTIC_NET"),
    "tron": dict(optimizer="TRON"), "lbfgs_l1": dict(regularization="L1"),
    "normalization": dict(normalization="STANDARDIZATION"),
    "variance": dict(variance="SIMPLE"), "float64": dict(dtype="float64"),
    "bootstrap": dict(bootstrap_replicates=8),
}


@pytest.mark.parametrize("case", list(GUARDS))
def test_ooc_unsupported_flag_matches_jax(case, data, tmp_path):
    ns = _ns(**GUARDS[case])
    assert glm_training_driver._ooc_unsupported_flag(ns) == jax_glm._ooc_unsupported_flag(ns)
    bad = glm_training_driver._ooc_unsupported_flag(ns)
    assert (bad is None) == (case in ("ok", "owlqn_l1", "owlqn_elastic"))
    if bad is None:
        return
    flag = bad[0]
    argv = ["--train-data", str(data / "train.avro"), "--task", "LOGISTIC_REGRESSION",
            "--output-dir", str(tmp_path / "o"), "--row-chunk-rows", "32",
            "--optimizer", ns.optimizer, "--regularization", ns.regularization,
            "--normalization", ns.normalization, "--variance", ns.variance,
            "--dtype", ns.dtype, "--bootstrap-replicates", str(ns.bootstrap_replicates)]
    with pytest.raises(ValueError, match=f"out-of-core training supports {flag}"):
        glm_training_driver.run(argv + CPU)


def test_auto_route(data, tmp_path, monkeypatch, caplog):
    """``--row-chunk-rows -1``: on cuda, past the device budget, out of core
    (chunks of 2^20 rows) unless a flag needs in-core; on the CPU in-core."""
    import logging

    log = logging.getLogger("test")
    args = glm_training_driver.build_arg_parser().parse_args(
        _common(data, "--variance", "NONE", "--output-dir", str(tmp_path)))
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert glm_training_driver._auto_chunk_rows(args, cuda, log) == 0
    monkeypatch.setenv("PHOTON_DEVICE_DATA_BUDGET_GB", "1e-7")
    assert glm_training_driver._auto_chunk_rows(args, cuda, log) == 1 << 20
    assert glm_training_driver._auto_chunk_rows(args, cpu, log) == 0
    args.variance = "SIMPLE"
    with caplog.at_level(logging.WARNING, logger="test"):
        assert glm_training_driver._auto_chunk_rows(args, cuda, log) == 0
    assert "--variance=SIMPLE requires the in-core path" in caplog.text


def test_out_of_core_driver_validates_chunks(tmp_path):
    recs = [{"uid": str(i), "response": float("nan") if i == 7 else float(i % 2),
             "offset": None, "weight": None,
             "features": [{"name": "g", "term": "0", "value": 1.0}],
             "metadataMap": {}} for i in range(20)]
    write_container(str(tmp_path / "train.avro"), RECORD_SCHEMA, recs)
    with pytest.raises(ValueError, match="label|response|finite|NaN|nan"):
        glm_training_driver.run([
            "--train-data", str(tmp_path / "train.avro"), "--output-dir",
            str(tmp_path / "o"), "--task", "LOGISTIC_REGRESSION", "--variance", "NONE",
            "--no-report", "--row-chunk-rows", "8"] + CPU)


# ``--devices`` is taken (tests/test_torch_mesh_ooc.py).
REFUSED = {"--compilation-cache-dir": ["cc"]}


@pytest.mark.parametrize("flag", list(REFUSED))
def test_later_slice_flags_are_refused(data, tmp_path, capsys, flag):
    assert set(REFUSED) == {f for f, _, _ in glm_training_driver._LATER_SLICES}
    with pytest.raises(SystemExit) as e:
        glm_training_driver.run(_common(data, "--output-dir", str(tmp_path / "o"),
                                        flag, *REFUSED[flag]) + CPU)
    assert e.value.code == 2
    err = capsys.readouterr().err
    if flag == "--compilation-cache-dir":   # refused for good
        assert flag in err and "refused for good" in err and "compiles no XLA" in err
    else:
        assert flag in err and "not in the port yet" in err and "slice" in err
    assert not (tmp_path / "o").exists()


@pytest.mark.parametrize("flag", ["--trace-out", "--telemetry-dir"])
@pytest.mark.parametrize("mode", ["0", "64"])
def test_observability_flags_are_taken(data, tmp_path, flag, mode):
    """``--trace-out`` and ``--telemetry-dir`` (refused until the port had
    them), in core and out of core: the sweep of a run without them, and a
    trace of the solve (``tests/test_torch_trace_parity.py`` holds its spans
    against the JAX driver's)."""
    value = str(tmp_path / ("t.json" if flag == "--trace-out" else "tel"))
    common = _common(data, "--variance", "NONE", "--no-report",
                     "--row-chunk-rows", mode) + CPU
    got = glm_training_driver.run(common + ["--output-dir", str(tmp_path / "a"),
                                            flag, value])
    want = glm_training_driver.run(common + ["--output-dir", str(tmp_path / "b")])
    assert got["sweep"] == want["sweep"]
    pid = os.getpid()
    trace = (value if flag == "--trace-out"
             else os.path.join(value, f"trace.glm-training.{pid}.json"))
    names = {e["name"] for e in json.load(open(trace))["traceEvents"]}
    assert ("optim.ooc_grad_chunk" if mode != "0" else "optim.glm_fit") in names
    if flag == "--telemetry-dir":
        assert sorted(os.listdir(value)) == [f"registry.glm-training.{pid}.json",
                                             f"trace.glm-training.{pid}.json"]


@pytest.mark.parametrize("policy", ["strict", "failover", "cpu-only"])
def test_backend_policy_is_taken(data, tmp_path, policy, monkeypatch):
    """``--backend-policy`` in the GLM and feature-indexing drivers: with
    ``--device cpu`` (and ``cpu-only`` without it) nothing is probed and the
    model is the plain run's; without a GPU a ``cuda`` run under ``strict``
    raises the classified error before any output, and under ``failover``
    goes on on the CPU with the swap stamped in its summary."""
    from photon_tpu_torch.runtime import backend_guard

    monkeypatch.setattr(backend_guard, "_STATE", None)
    monkeypatch.setattr(backend_guard, "_PROBED_OK", False)
    common = _common(data, "--variance", "NONE", "--no-report")
    plain = glm_training_driver.run(common + ["--output-dir", str(tmp_path / "a")] + CPU)
    device = [] if policy == "cpu-only" else CPU
    got = glm_training_driver.run(common + ["--output-dir", str(tmp_path / "b"),
                                            "--backend-policy", policy] + device)
    assert got["sweep"] == plain["sweep"] and "backend" not in got
    assert backend_guard.guard_snapshot()["probe_attempts"] == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    on_card = common + ["--output-dir", str(tmp_path / "c"), "--backend-policy", policy]
    if policy == "strict":
        with pytest.raises(backend_guard.BackendUnusable, match="init_unavailable"):
            glm_training_driver.run(on_card)
        assert not (tmp_path / "c").exists()
    elif policy == "failover":
        got = glm_training_driver.run(on_card)
        assert got["sweep"] == plain["sweep"]
        assert got["backend"]["backend"] == "cpu"
        assert got["backend"]["failover"]["cause"] == "init_unavailable"
    idx = feature_indexing_driver.run(["--data", str(data / "train.avro"),
                                       "--output-dir", str(tmp_path / "i"),
                                       "--backend-policy", policy])
    assert idx["features_per_shard"]["global"] > 0


def test_every_jax_flag_is_taken_or_refused():
    for port, jax in ((glm_training_driver, jax_glm),
                      (feature_indexing_driver, jax_indexing)):
        jax_flags = set(jax.build_arg_parser()._option_string_actions)
        assert jax_flags - set(port.build_arg_parser()._option_string_actions) == set()


def test_glm_driver_defaults_to_cuda_and_raises_without_gpu(data, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _common(data, "--output-dir", str(tmp_path / "o"))
    assert glm_training_driver.build_arg_parser().parse_args(args).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        glm_training_driver.run(args)


@pytest.mark.parametrize("parts", [1, 3])
def test_feature_indexing_driver_writes_jax_index(data, tmp_path, parts):
    args = ["--data", str(data / "train.avro"), str(data / "val.avro"),
            "--feature-shard", "global:features", "--feature-shard",
            "bare:features:no-intercept", "--num-partitions", str(parts)]
    ps = feature_indexing_driver.run(args + ["--output-dir", str(tmp_path / "p")])
    js = jax_indexing.run(args + ["--output-dir", str(tmp_path / "j")])
    assert ps == js and ps["features_per_shard"]["global"] == \
        ps["features_per_shard"]["bare"] + 1
    for shard in ("global", "bare"):
        names = sorted(os.listdir(tmp_path / "j" / shard))
        assert sorted(os.listdir(tmp_path / "p" / shard)) == names
        _, mismatch, errors = filecmp.cmpfiles(tmp_path / "p" / shard,
                                               tmp_path / "j" / shard, names, shallow=False)
        assert mismatch == errors == []
    # the GLM driver trains on the prebuilt index: the same model
    common = _common(data, "--variance", "NONE", "--no-report", "--dtype", "float64")
    a = glm_training_driver.run(common + ["--output-dir", str(tmp_path / "a")] + CPU)
    b = glm_training_driver.run(common + ["--index-dir", str(tmp_path / "p"),
                                          "--output-dir", str(tmp_path / "b")] + CPU)
    assert a["sweep"] == b["sweep"]
    # traced: the same index files, and a trace with the fleet anchor
    traced = feature_indexing_driver.run(args + [
        "--output-dir", str(tmp_path / "x"), "--trace-out", str(tmp_path / "t.json")])
    assert traced == ps
    doc = json.load(open(tmp_path / "t.json"))
    anchor = next(e for e in doc["traceEvents"] if e["name"] == "photon.anchor")
    assert anchor["args"]["role"] == "indexing"
    for shard in ("global", "bare"):
        names = sorted(os.listdir(tmp_path / "p" / shard))
        _, mismatch, errors = filecmp.cmpfiles(tmp_path / "x" / shard,
                                               tmp_path / "p" / shard, names,
                                               shallow=False)
        assert mismatch == errors == []
