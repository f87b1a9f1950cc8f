"""The PyTorch port's scoring driver against the JAX scoring driver.

One GAME model (fixed effect + perUser) is trained by the JAX
``game_training_driver`` on Avro data written as ``tests/test_drivers.py``
writes it (one configuration, one sweep). Both scoring drivers then score
held-out data with it — the port's on the CPU (``--device cpu``) — and their
``scores.avro`` files must agree: the same uids and labels in the same
order, scores within f32 ``atol 1e-5`` (f64 ``1e-12``). With
``--evaluators`` (plain and grouped by the ``userId`` tag) both summaries
hold the same metrics within 1e-6 (each package evaluates its own float32
cast of the scores).
"""
import json

import numpy as np
import pytest

from photon_tpu.cli import game_scoring_driver as jax_scoring_driver
from photon_tpu.cli import game_training_driver
from photon_tpu.io.avro import read_records, write_container
from photon_tpu_torch.cli import game_scoring_driver
from test_torch_jax_decoder import jax_decoder  # noqa: F401

RECORD_SCHEMA = {
    "type": "record",
    "name": "TrainingExampleAvro",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "response", "type": "double"},
        {"name": "offset", "type": ["null", "double"], "default": None},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "features", "type": {"type": "array", "items": {
            "type": "record", "name": "FeatureAvro", "fields": [
                {"name": "name", "type": "string"},
                {"name": "term", "type": ["null", "string"], "default": None},
                {"name": "value", "type": "double"},
            ]}}},
        {"name": "metadataMap",
         "type": ["null", {"type": "map", "values": "string"}], "default": None},
    ],
}


def _write_game_avro(path, seed, n_users=8, rows_per_user=24, d_global=5, d_user=3,
                     offsets=False):
    """GLMix data: global features g/0..4 + per-user block features u/<u>_j
    (``tests/test_drivers.py``'s generator, plus optional offsets)."""
    truth = np.random.default_rng(77)
    wg = truth.normal(size=d_global)
    wu = truth.normal(size=(n_users, d_user)) * 1.5
    rng = np.random.default_rng(seed)
    n = n_users * rows_per_user
    users = rng.permutation(np.repeat(np.arange(n_users), rows_per_user))
    recs = []
    for i in range(n):
        u = int(users[i])
        xg = rng.normal(size=d_global)
        xu = rng.normal(size=d_user)
        z = xg @ wg + xu @ wu[u]
        y = float(rng.random() < 1 / (1 + np.exp(-z)))
        feats = [
            {"name": "g", "term": str(j), "value": float(xg[j])}
            for j in range(d_global)
        ] + [
            {"name": "u", "term": f"{u}_{j}", "value": float(xu[j])}
            for j in range(d_user)
        ]
        recs.append({
            "uid": str(i),
            "response": y,
            "offset": float(rng.normal()) * 0.1 if offsets else None,
            "weight": None,
            "features": feats,
            "metadataMap": {"userId": f"user{u}"},
        })
    write_container(str(path), RECORD_SCHEMA, recs)
    return n


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_scoring")
    _write_game_avro(d / "train.avro", seed=1)
    # Held-out rows: two users the model never saw (user8, user9) and offsets.
    n_score = _write_game_avro(d / "score.avro", seed=2, n_users=10,
                               rows_per_user=6, offsets=True)
    out = d / "train_out"
    game_training_driver.run([
        "--train-data", str(d / "train.avro"),
        "--output-dir", str(out),
        "--task", "LOGISTIC_REGRESSION",
        "--feature-shard", "global:features",
        "--coordinate",
        "fixed:type=fixed,shard=global,reg=L2,max_iter=15,reg_weights=1",
        "--coordinate",
        "perUser:type=random,re_type=userId,shard=global,reg=L2,max_iter=15,reg_weights=1",
        "--sweeps", "1",
        "--devices", "1",
    ])
    return d, out, n_score


def _score(driver, d, out, dest, extra=()):
    summary = driver.run([
        "--data", str(d / "score.avro"),
        "--model-dir", str(out / "best"),
        "--output-dir", str(dest),
        *extra,
    ])
    return summary, read_records(str(dest / "scores.avro"))


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("float64", 1e-12)])
def test_port_driver_matches_jax_driver(trained, tmp_path, dtype, atol):
    d, out, n_score = trained
    js, jrecs = _score(jax_scoring_driver, d, out, tmp_path / "jax", ["--dtype", dtype])
    ps, precs = _score(game_scoring_driver, d, out, tmp_path / "port",
                       ["--dtype", dtype, "--device", "cpu"])
    # the port's summary also names the reader that ran
    assert ps.pop("reader") == "native"
    assert ps == js == {"n_rows": n_score, "evaluation": None}
    assert json.loads((tmp_path / "port" / "scoring-summary.json").read_text()) == {
        **ps, "reader": "native"}
    assert [r["uid"] for r in precs] == [r["uid"] for r in jrecs] == [
        str(i) for i in range(n_score)]
    assert [r["label"] for r in precs] == [r["label"] for r in jrecs]
    got = np.array([r["predictionScore"] for r in precs])
    want = np.array([r["predictionScore"] for r in jrecs])
    assert np.isfinite(got).all() and np.std(got) > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert (tmp_path / "port" / "photon.log").exists()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_port_driver_evaluators_match_jax(trained, tmp_path, dtype):
    d, out, n_score = trained
    ev = ["--evaluators", "AUC", "LOGISTIC_LOSS", "AUC:userId", "RMSE:userId"]
    js, _ = _score(jax_scoring_driver, d, out, tmp_path / "jax",
                   ["--dtype", dtype, *ev])
    ps, _ = _score(game_scoring_driver, d, out, tmp_path / "port",
                   ["--dtype", dtype, "--device", "cpu", *ev])
    assert ps["n_rows"] == js["n_rows"] == n_score
    assert list(ps["evaluation"]) == list(js["evaluation"]) == [
        "AUC", "LOGISTIC_LOSS", "AUC:userId", "RMSE:userId"]
    for k, want in js["evaluation"].items():
        assert abs(ps["evaluation"][k] - want) <= 1e-6, (k, ps["evaluation"][k], want)
    assert 0.5 < ps["evaluation"]["AUC"] < 1.0


@pytest.mark.parametrize("flags,slice_name", [
    (["--devices", "2"], "multi-GPU"),
], ids=["devices"])
def test_port_driver_refuses_later_slices(tmp_path, capsys, flags, slice_name):
    with pytest.raises(SystemExit) as e:
        game_scoring_driver.run([
            "--data", "x.avro", "--model-dir", "m", "--output-dir", str(tmp_path),
            "--device", "cpu", *flags,
        ])
    assert e.value.code == 2
    assert slice_name in capsys.readouterr().err


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("float64", 1e-12)])
def test_chunked_scoring_matches_jax_and_whole(trained, tmp_path, dtype, atol):
    """``--chunk-rows`` streams 20 rows at a time (padded as JAX pads them):
    the same scores and grouped evaluation as the JAX driver with the same
    flags, and as the port's whole-dataset path."""
    d, out, n_score = trained
    ev = ["--evaluators", "AUC", "AUC:userId"]
    js, jrecs = _score(jax_scoring_driver, d, out, tmp_path / "jax",
                       ["--dtype", dtype, "--chunk-rows", "20", *ev])
    ps, precs = _score(game_scoring_driver, d, out, tmp_path / "port",
                       ["--dtype", dtype, "--device", "cpu", "--chunk-rows", "20",
                        *ev])
    ws, wrecs = _score(game_scoring_driver, d, out, tmp_path / "whole",
                       ["--dtype", dtype, "--device", "cpu", *ev])
    assert ps["n_rows"] == js["n_rows"] == n_score and ps["reader"] == "native"
    for recs in (jrecs, wrecs):
        assert [r["uid"] for r in precs] == [r["uid"] for r in recs]
        np.testing.assert_allclose([r["predictionScore"] for r in precs],
                                   [r["predictionScore"] for r in recs],
                                   rtol=0, atol=atol)
    for k, want in js["evaluation"].items():
        assert abs(ps["evaluation"][k] - want) <= 1e-6
        assert abs(ps["evaluation"][k] - ws["evaluation"][k]) <= 1e-6
