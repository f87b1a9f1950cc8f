"""The port's drivers traced against the JAX package's drivers.

Both packages' drivers run on the same Avro data (written as
``tests/test_torch_scoring_driver.py`` writes it, with offsets; the port's
with ``--device cpu``) under ``--trace-out``: the GAME training driver
(a fixed effect with SIMPLE variances and a random effect, 2 sweeps,
float64), the GLM driver in core (float64) and out of core (float32, chunks
of 64 rows), the scoring driver (whole and chunked) and the
feature-indexing driver. For each, the census of spans is the JAX
driver's: the multiset of (name, category, argument keys, parent span's
name), and so is the census of instants. The one difference is named:
the port's out-of-core GLM driver reads its chunks through the prefetch
stage, which the JAX driver does not use, so its trace also holds the
stage's ``ingest.prefetch_queue_wait`` spans.

Also: traced models and scores are byte-equal to untraced ones; each
step record's ``seconds`` is its ``descent.step`` span's duration;
``--telemetry-dir`` writes the JAX driver's shard names; a run failed by
an injected fault still writes its trace and registry shard;
``--profile-dir`` on the CPU writes one ``torch.profiler`` trace, named in
the summary; ``PHOTON_SLO_CONFIG`` is judged on the heartbeat (and warned
about without one).
"""
import collections
import json
import logging
import os

import pytest

import jax.numpy as jnp

from photon_tpu.cli import feature_indexing_driver as jax_indexing
from photon_tpu.cli import game_scoring_driver as jax_scoring
from photon_tpu.cli import game_training_driver as jax_training
from photon_tpu.cli import glm_training_driver as jax_glm
from photon_tpu_torch.cli import (
    feature_indexing_driver,
    game_scoring_driver,
    game_training_driver,
    glm_training_driver,
)
from test_torch_scoring_driver import _write_game_avro
from test_torch_jax_decoder import jax_decoder  # noqa: F401

CPU = ["--device", "cpu"]
GAME_SPECS = [
    "--coordinate", "fixed:type=fixed,shard=global,reg=L2,reg_weights=1,variance=SIMPLE",
    "--coordinate", "perUser:type=random,re_type=userId,shard=global,reg=L2,reg_weights=1",
]
# Spans that only the port emits, by run: the out-of-core GLM driver reads
# its chunks through the prefetch stage (the JAX driver reads them inline).
PORT_ONLY = {"glm_out_of_core": {"ingest.prefetch_queue_wait"}}


def census(path, kind="X"):
    """(name, cat, sorted argument keys, parent span's name) -> count, for
    the trace's spans (``kind`` "X") or its instants ("i"). A span's parent
    is the innermost span of its thread that contains it."""
    events = json.load(open(path))["traceEvents"]
    out = collections.Counter()
    if kind == "i":
        for e in events:
            if e["ph"] == "i":
                out[(e["name"], e["cat"], tuple(sorted(e["args"])), None)] += 1
        return out
    threads = collections.defaultdict(list)
    for e in events:
        if e["ph"] == "X":
            threads[(e["pid"], e["tid"])].append(e)
    for spans in threads.values():
        spans.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for e in spans:
            # ts and dur are rounded to 0.1 us each
            while stack and e["ts"] + e["dur"] > stack[-1]["ts"] + stack[-1]["dur"] + 0.25:
                stack.pop()
            keys = tuple(sorted(k for k in e["args"] if k != "span_id"))
            out[(e["name"], e["cat"], keys, stack[-1]["name"] if stack else None)] += 1
            stack.append(e)
    return out


def _payload(path):
    """A file's bytes; an Avro file's without its sync marker (16 random
    bytes a file, its last 16)."""
    data = open(path, "rb").read()
    return data.replace(data[-16:], b"") if str(path).endswith(".avro") else data


def model_dirs_differ(a, b):
    """Files in which two model directories differ."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    fa, fb = files(a), files(b)
    if fa != fb:
        return sorted(set(fa) ^ set(fb))
    return [f for f in fa if _payload(os.path.join(a, f)) != _payload(os.path.join(b, f))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every driver traced in both packages, and the port's untraced."""
    jnp.zeros(1).block_until_ready()
    d = tmp_path_factory.mktemp("trace_parity")
    _write_game_avro(d / "train.avro", seed=1, offsets=True)
    _write_game_avro(d / "score.avro", seed=2, n_users=10, rows_per_user=6,
                     offsets=True)
    train = ["--train-data", str(d / "train.avro"), "--task", "LOGISTIC_REGRESSION"]
    glm = train + ["--reg-weights", "1", "--no-report"]
    score = ["--data", str(d / "score.avro"), "--dtype", "float64"]
    # The JAX drivers on one device: the port has no mesh (M14).
    plans = {
        "game": (jax_training, game_training_driver,
                 train + GAME_SPECS + ["--dtype", "float64", "--sweeps", "2"], True),
        "glm_in_core": (jax_glm, glm_training_driver,
                        glm + ["--dtype", "float64", "--row-chunk-rows", "0"], True),
        "glm_out_of_core": (jax_glm, glm_training_driver,
                            glm + ["--dtype", "float32", "--variance", "NONE",
                                   "--row-chunk-rows", "64"], True),
        "indexing": (jax_indexing, feature_indexing_driver,
                     ["--data", str(d / "train.avro")], False),
    }
    out = {"dir": d}
    for name, (jax_driver, port_driver, args, on_device) in plans.items():
        dev = CPU if on_device else []
        one = ["--devices", "1"] if on_device else []
        out[name] = {
            "jax": jax_driver.run(args + one + ["--output-dir", str(d / f"{name}_jax"),
                                          "--trace-out", str(d / f"{name}_jax.json")]),
            "port": port_driver.run(args + dev + [
                "--output-dir", str(d / f"{name}_port"),
                "--trace-out", str(d / f"{name}_port.json")]),
            "plain": port_driver.run(args + dev + ["--output-dir",
                                                   str(d / f"{name}_plain")]),
        }
    model = str(d / "game_port" / "best")
    for name, extra in (("scoring", []), ("scoring_chunked", ["--chunk-rows", "16"])):
        args = score + ["--model-dir", model] + extra
        out[name] = {
            "jax": jax_scoring.run(args + ["--output-dir", str(d / f"{name}_jax"),
                                           "--trace-out", str(d / f"{name}_jax.json")]),
            "port": game_scoring_driver.run(args + CPU + [
                "--output-dir", str(d / f"{name}_port"),
                "--trace-out", str(d / f"{name}_port.json")]),
            "plain": game_scoring_driver.run(args + CPU + [
                "--output-dir", str(d / f"{name}_plain")]),
        }
    return out


RUNS = ["game", "glm_in_core", "glm_out_of_core", "scoring", "scoring_chunked",
        "indexing"]


@pytest.mark.parametrize("name", RUNS)
def test_span_census_is_jax_drivers(runs, name):
    d = runs["dir"]
    want = census(d / f"{name}_jax.json")
    got = census(d / f"{name}_port.json")
    only = PORT_ONLY.get(name, set())
    assert {k[0] for k in got if k[0] in only} == only
    got = collections.Counter({k: n for k, n in got.items() if k[0] not in only})
    assert got == want
    assert census(d / f"{name}_port.json", "i") == census(d / f"{name}_jax.json", "i")
    if name == "game":
        assert sum(n for k, n in want.items() if k[0] == "descent.step") == 4


@pytest.mark.parametrize("name", ["game", "glm_in_core", "glm_out_of_core"])
def test_traced_models_are_byte_equal_to_untraced(runs, name):
    d = runs["dir"]
    assert model_dirs_differ(d / f"{name}_port" / "best", d / f"{name}_plain" / "best") == []
    strip = ("fit_seconds", "read_seconds")
    got, want = runs[name]["port"], runs[name]["plain"]
    assert {k: v for k, v in got.items() if k not in strip and "dir" not in k} == \
        {k: v for k, v in want.items() if k not in strip and "dir" not in k}


@pytest.mark.parametrize("name", ["scoring", "scoring_chunked"])
def test_traced_scores_are_byte_equal_to_untraced(runs, name):
    d = runs["dir"]
    for f in ("scores.avro", "scoring-summary.json"):
        assert _payload(d / f"{name}_port" / f) == _payload(d / f"{name}_plain" / f)
    assert runs[name]["port"] == runs[name]["plain"]


def test_step_record_seconds_are_the_step_spans(runs):
    d = runs["dir"]
    records = [json.loads(x) for x in
               (d / "game_port" / "metrics.jsonl").read_text().splitlines()]
    steps = [e for e in json.load(open(d / "game_port.json"))["traceEvents"]
             if e["name"] == "descent.step"]
    assert [(r["sweep"], r["coordinate"]) for r in records] == \
        [(s["args"]["sweep"], s["args"]["coordinate"]) for s in steps]
    for r, s in zip(records, steps):
        assert abs(r["seconds"] * 1e6 - s["dur"]) <= 0.051, (r, s)


def _tiny_game(d, out, *extra):
    return ["--train-data", str(d / "train.avro"), "--task", "LOGISTIC_REGRESSION",
            "--coordinate", "fixed:type=fixed,shard=global,reg=L2,reg_weights=1",
            "--output-dir", str(out), *extra]


def test_telemetry_dir_writes_jax_shard_names(runs, tmp_path):
    d = runs["dir"]
    names = {}
    for pkg, driver, dev in (("jax", jax_training, ["--devices", "1"]),
                             ("port", game_training_driver, CPU)):
        tel = tmp_path / f"tel_{pkg}"
        driver.run(_tiny_game(d, tmp_path / pkg, "--telemetry-dir", str(tel)) + dev)
        names[pkg] = sorted(os.listdir(tel))
    pid = os.getpid()
    assert names["port"] == names["jax"] == [f"registry.training.{pid}.json",
                                             f"trace.training.{pid}.json"]
    doc = json.load(open(tmp_path / "tel_port" / f"trace.training.{pid}.json"))
    anchor = next(e for e in doc["traceEvents"] if e["name"] == "photon.anchor")
    assert anchor["args"]["role"] == "training" and "photon.trace.dropped" not in doc


def test_failed_run_still_writes_trace_and_shard(runs, tmp_path):
    """A preemption injected at the first step fails the run; its trace
    (with the fault's instant) and its registry shard are written, as in the
    JAX driver."""
    d = runs["dir"]
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"seed": 0, "specs": [
        {"site": "descent.step", "error": "preemption", "count": 1}]}))
    written = {}
    for pkg, driver, dev in (("jax", jax_training, ["--devices", "1"]),
                             ("port", game_training_driver, CPU)):
        tel = tmp_path / f"tel_{pkg}"
        with pytest.raises(Exception, match="injected fault at 'descent.step'"):
            driver.run(_tiny_game(d, tmp_path / pkg, "--telemetry-dir", str(tel),
                                  "--fault-plan", str(plan)) + dev)
        trace = tel / f"trace.training.{os.getpid()}.json"
        written[pkg] = census(trace, "i")
        assert (tel / f"registry.training.{os.getpid()}.json").exists()
        spans = census(trace)
        assert not any(k[0].startswith("descent.") for k in spans)
    assert written["port"] == written["jax"]
    assert any(k[0].startswith("fault") for k in written["port"])


def test_profile_dir_writes_one_trace_named_in_summary(runs, tmp_path):
    d = runs["dir"]
    prof = tmp_path / "prof"
    summary = game_training_driver.run(
        _tiny_game(d, tmp_path / "out", "--profile-dir", str(prof)) + CPU)
    (name,) = os.listdir(prof)
    assert summary["profile"] == str(prof / name)
    saved = json.loads((tmp_path / "out" / "training-summary.json").read_text())
    assert saved["profile"] == summary["profile"]
    events = json.load(open(prof / name))["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_slo_config_is_judged_by_the_heartbeat(runs, tmp_path, monkeypatch, caplog):
    """``PHOTON_SLO_CONFIG``: judged on the heartbeat's thread (its beat
    interval shortened here), a violated and a passed rule landing in the
    trace and in ``slo_violations_total``; without ``--heartbeat-dir`` the
    driver warns that it judges none, as the JAX driver does."""
    from photon_tpu_torch import supervisor
    from photon_tpu_torch.obs.metrics import REGISTRY

    d = runs["dir"]
    cfg = tmp_path / "slo.json"
    cfg.write_text(json.dumps({"slos": [
        {"name": "cache_pinned", "metric": "sweep_cache_bytes", "op": ">=",
         "threshold": 0},
        {"name": "cache_negative", "metric": "sweep_cache_bytes", "op": "<",
         "threshold": 0}]}))
    monkeypatch.setenv("PHOTON_SLO_CONFIG", str(cfg))

    class FastBeat(supervisor.Heartbeat):
        def __init__(self, directory, interval_seconds, **kw):
            super().__init__(directory, interval_seconds=0.02, **kw)

    monkeypatch.setattr(game_training_driver, "Heartbeat", FastBeat)
    before = REGISTRY.counter("slo_violations_total").value(slo="cache_negative")
    game_training_driver.run(_tiny_game(d, tmp_path / "hb_run", "--heartbeat-dir",
                                        str(tmp_path / "hb"), "--trace-out",
                                        str(tmp_path / "t.json"), "--sweeps", "3") + CPU)
    slo = [e for e in json.load(open(tmp_path / "t.json"))["traceEvents"]
           if e["name"].startswith("slo.")]
    assert {(e["name"], e["args"]["slo"], e["args"]["where"]) for e in slo} == {
        ("slo.pass", "cache_pinned", "heartbeat"),
        ("slo.violation", "cache_negative", "heartbeat")}
    assert REGISTRY.counter("slo_violations_total").value(slo="cache_negative") > before
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        game_training_driver.run(_tiny_game(d, tmp_path / "no_hb") + CPU)
    assert any("PHOTON_SLO_CONFIG" in r.getMessage() and "--heartbeat-dir" in r.getMessage()
               for r in caplog.records)


def _traced_serving(pkg, model_dirs, val, path):
    """One run of requests through ``pkg``'s scoring server under a trace
    collector: the registry's build and warmup, one request at a time (one
    row a batch), a patch, a standby, a swap and a request after it."""
    import http.client
    import importlib

    from photon_tpu_torch.io.avro import read_records

    serving = importlib.import_module(f"{pkg}.serving")
    trace = importlib.import_module(f"{pkg}.obs.trace")
    config = serving.ServingConfig(max_batch=4, cache_entities=8, max_row_nnz=32)
    kw = {"device": "cpu"} if pkg == "photon_tpu_torch" else {}
    trace.start_tracing()
    try:
        registry = serving.ModelRegistry(model_dirs[0], config, **kw)
        server = serving.ScoringServer(
            registry, serving.MicroBatcher(max_batch=4, max_wait_ms=1.0), port=0)
        server.start()
        recs = read_records(val)

        def post(route, body):
            conn = http.client.HTTPConnection(*server.address, timeout=30)
            conn.request("POST", route, body=json.dumps(body).encode())
            resp = conn.getresponse()
            assert resp.status == 200, resp.read()
            resp.read()
            conn.close()

        for r in recs[:6]:
            post("/score", {"features": r["features"], "entities": r["metadataMap"]})
        key = recs[0]["metadataMap"]["userId"]
        post("/admin/patch", {"seq": 1, "patches": {"perUser": {key: {
            "cols": [0], "vals": [0.5]}}}})
        post("/admin/standby", {"model_dir": model_dirs[1]})
        post("/admin/swap", {"model_dir": model_dirs[1]})
        post("/score", {"features": recs[0]["features"],
                        "entities": recs[0]["metadataMap"]})
        server.shutdown()
    finally:
        trace.stop_tracing(str(path))


def test_serving_span_census_is_jax_servers(tmp_path):
    """The ``serve.*`` spans and the serving instants of one run of
    requests, with JAX's argument keys: the census equals the JAX server's
    (the JAX server's XLA compiles emit no span or instant here)."""
    from test_torch_serving import train_models

    trained = train_models(tmp_path)
    for pkg in ("photon_tpu", "photon_tpu_torch"):
        _traced_serving(pkg, trained.jax, trained.val, tmp_path / f"{pkg}.json")
    want = census(tmp_path / "photon_tpu.json")
    got = census(tmp_path / "photon_tpu_torch.json")
    assert got == want
    assert census(tmp_path / "photon_tpu_torch.json", "i") == \
        census(tmp_path / "photon_tpu.json", "i")
    names = {k[0] for k in want}
    assert {"serve.request", "serve.admission", "serve.queue_wait", "serve.batch",
            "serve.batch_assembly", "serve.store_resolve", "serve.kernel",
            "serve.patch"} <= names
    assert sum(n for k, n in want.items() if k[0] == "serve.kernel") > 7
