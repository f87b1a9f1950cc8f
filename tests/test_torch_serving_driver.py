"""The port's serving driver (``photon_tpu_torch/cli/serving_driver.py``)
against the JAX driver's flags, on the CPU.

* Every flag of the JAX driver is either taken or refused by name:
  ``--compilation-cache-dir`` and ``--compile-store`` are refused for good;
  each refusal exits 2 before any work.
* The replica flags (``--delta-log``, ``--replica-id``, ``--cursor-dir``,
  ``--catchup-lag``) are taken: the tailer converges to the log head
  before serving, attaches to the server, journals ``replica_joined`` and
  names its replica in the summary.
* The taken flags build, warm and tear down (``run(serve_forever=False)``)
  and leave their artefacts; ``--workers`` assembles the front line.
* Run as a process, the driver serves a request and drains on SIGTERM,
  flushing its metrics.
"""
import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from photon_tpu.cli import serving_driver as jax_serving_driver
from photon_tpu_torch.cli import serving_driver
from photon_tpu_torch.io.avro import read_records
from test_torch_faults import REPO
from test_torch_jax_decoder import jax_decoder  # noqa: F401
from test_torch_serving import payload, train_models

REFUSED = {
    "--compilation-cache-dir": (["--compilation-cache-dir", "cc"], "refused for good"),
    "--compile-store": (["--compile-store", "cs"], "refused for good"),
}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return train_models(tmp_path_factory.mktemp("torch_serving_driver"))


def test_every_jax_flag_is_taken_or_refused():
    jax_flags = set(jax_serving_driver.build_arg_parser()._option_string_actions)
    port_flags = set(serving_driver.build_arg_parser()._option_string_actions)
    assert jax_flags - port_flags == set()
    assert port_flags - jax_flags == {"--device"}
    assert {f for f, _, _ in serving_driver._REFUSED} == set(REFUSED)


@pytest.mark.parametrize("flag", sorted(REFUSED))
def test_refused_flags_exit_before_work(flag, tmp_path, capsys):
    argv, why = REFUSED[flag]
    with pytest.raises(SystemExit) as e:
        serving_driver.run(["--model-dir", str(tmp_path / "none"), "--device",
                            "cpu", "--output-dir", str(tmp_path / "out"), *argv],
                           serve_forever=False)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert flag in err and why in err
    assert not (tmp_path / "out").exists()


def test_driver_builds_and_tears_down(trained, tmp_path):
    out = tmp_path / "serve_out"
    summary = serving_driver.run([
        "--model-dir", trained.jax[0], "--port", "0", "--max-batch", "4",
        "--output-dir", str(out), "--device", "cpu"], serve_forever=False)
    assert summary["model_version"] == 1 and summary["device"] == "cpu"
    assert summary["coordinates"] == ["fixed", "perUser"]
    assert (out / "photon.log").exists()
    assert (out / "serving-metrics.jsonl").exists()


@pytest.mark.parametrize("flag", ["--trace-out", "--telemetry-dir", "--fault-plan",
                                  "--backend-policy", "--slo-config", "--workers",
                                  "--autotune"])
def test_jax_flags_are_taken(trained, tmp_path, flag):
    pid = os.getpid()
    extra = {
        "--trace-out": ["--trace-out", str(tmp_path / "t.json")],
        "--telemetry-dir": ["--telemetry-dir", str(tmp_path / "tel")],
        "--fault-plan": ["--fault-plan", str(tmp_path / "plan.json")],
        "--backend-policy": ["--backend-policy", "cpu-only"],
        "--slo-config": ["--slo-config", str(tmp_path / "slo.json")],
        "--workers": ["--workers", "1", "--ipc", "socket"],
        "--autotune": ["--workers", "1", "--autotune"],
    }[flag]
    if flag == "--fault-plan":
        (tmp_path / "plan.json").write_text(json.dumps({"seed": 0, "specs": [
            {"site": "serving.kernel", "error": "device_lost", "count": 1}]}))
    if flag == "--slo-config":
        (tmp_path / "slo.json").write_text(json.dumps({"slos": [
            {"name": "errors", "metric": "errors", "op": "<=", "threshold": 0}]}))
    device = [] if flag == "--backend-policy" else ["--device", "cpu"]
    summary = serving_driver.run([
        "--model-dir", trained.jax[0], "--port", "0", *device, *extra,
        "--output-dir", str(tmp_path / "out")], serve_forever=False)
    assert summary["model_version"] == 1 and summary["device"] == "cpu"
    if flag == "--trace-out":
        names = {e["name"] for e in json.load(open(tmp_path / "t.json"))["traceEvents"]}
        assert "serve.kernel" in names and "serve.batch_assembly" in names
    if flag == "--telemetry-dir":
        assert sorted(os.listdir(tmp_path / "tel")) == [
            f"registry.serving.{pid}.json", f"trace.serving.{pid}.json"]
    if flag == "--slo-config":
        rows = [json.loads(line) for line in open(tmp_path / "out" /
                                                  "serving-metrics.jsonl")]
        assert rows[-1]["slo"]["ok"] is True
    if flag in ("--workers", "--autotune"):
        assert summary["frontline"]["workers"] == 1
        assert summary["frontline"]["autotune"] == (flag == "--autotune")


@pytest.mark.parametrize("flag", ["--delta-log", "--replica-id", "--cursor-dir",
                                  "--catchup-lag"])
def test_replica_flags_are_taken(trained, tmp_path, flag):
    """Each replica flag is taken and the tailer attaches: it applies the
    log before serving (a catch-up jump to the newer snapshot under
    ``--catchup-lag``), journals ``replica_joined`` and names the replica."""
    from photon_tpu_torch.online.delta import EntityPatch, ModelDelta
    from photon_tpu_torch.replication import DeltaLogWriter, ReplicaCursor

    log = str(tmp_path / "delta-log.jsonl")
    with DeltaLogWriter(log) as w:
        w.append_snapshot(trained.jax[0], note="base")
        for seq in (1, 2):
            w.append(ModelDelta(seq=seq, patches={"perUser": {"user1": EntityPatch(
                key="user1", cols=np.array([0], np.int32),
                vals=np.array([0.5 * seq], np.float32))}}, event_horizon=seq))
        if flag == "--catchup-lag":
            w.append_snapshot(trained.jax[1], note="retrain")
    out = tmp_path / "out"
    extra = {"--delta-log": [],
             "--replica-id": ["--replica-id", "r7"],
             "--cursor-dir": ["--cursor-dir", str(tmp_path / "cur")],
             "--catchup-lag": ["--catchup-lag", "1"]}[flag]
    summary = serving_driver.run([
        "--model-dir", trained.jax[0], "--port", "0", "--device", "cpu",
        "--delta-log", log, "--output-dir", str(out), *extra],
        serve_forever=False)
    replica = summary["replica_id"]
    assert replica == ("r7" if flag == "--replica-id" else f"r{os.getpid()}")
    rows = [json.loads(x) for x in open(out / "recovery.jsonl")]
    joined = [r for r in rows if r["event"] == "replica_joined"]
    if flag == "--catchup-lag":
        assert joined[0]["applied_at_join"] == 0 and joined[0]["seq_watermark"] == 3
        assert any(r["event"] == "replica_catchup_done" for r in rows)
    else:
        assert joined == [dict(joined[0], replica=replica, seq_watermark=2,
                               applied_at_join=2)]
    cursor_dir = tmp_path / "cur" if flag == "--cursor-dir" else out
    assert ReplicaCursor(str(cursor_dir), replica).load() == 4 - (
        flag != "--catchup-lag")


def test_driver_process_serves_and_drains_on_sigterm(trained, tmp_path):
    out = tmp_path / "proc"
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.Popen(
        [sys.executable, "-m", "photon_tpu_torch.cli.serving_driver",
         "--model-dir", trained.jax[0], "--port", "0", "--device", "cpu",
         "--output-dir", str(out)],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        addr = None
        deadline = time.monotonic() + 120
        while addr is None and time.monotonic() < deadline:
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            log = (out / "photon.log").read_text() if (out / "photon.log").exists() else ""
            m = re.search(r"on http://([0-9.]+):(\d+)", log)
            addr = m and (m.group(1), int(m.group(2)))
            time.sleep(0.1)
        assert addr, "the driver never logged its address"
        rec = read_records(trained.val)[0]
        req = urllib.request.Request(f"http://{addr[0]}:{addr[1]}/score",
                                     data=json.dumps(payload(rec)).encode())
        with urllib.request.urlopen(req, timeout=30) as resp:
            body = json.loads(resp.read())
        assert body["model_version"] == 1 and "score" in body
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        rows = [json.loads(line) for line in open(out / "serving-metrics.jsonl")]
        assert rows[-1]["requests"] == 1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
