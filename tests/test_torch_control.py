"""The port's control plane (``photon_tpu_torch/control``,
``photon_tpu_torch/cli/control_driver.py``) over the port's replicas, on the
CPU.

* ``control/{actions,controller,ledger,policy,__init__}.py`` and
  ``cli/control_driver.py`` are copies: without docstrings, each equals the
  JAX package's with the package name renamed.
* The canary protocol over two of the port's ``ScoringServer``s, each with
  a following ``ReplicaTailer`` (the reference on the main log, the canary
  on the canary log), with the short tick and soak settings of the JAX
  package's canary tests: a clean wave soaks, is promoted and reaches the
  reference replica; a poisoned wave (the probed entity's coefficients
  moved by 99) is rolled back from the ledger's own rows (standby + swap
  to the base model, then the mainline resync) and never reaches the
  reference replica or the main log.
* The control driver's process maps neither torch's nor JAX's libraries.

Every wait has a timeout.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from photon_tpu_torch.control import (
    CanaryPolicy,
    ControlLedger,
    ControlPolicy,
    Controller,
    LEDGER_FILENAME,
    ReplicaTarget,
    read_ledger,
)
from photon_tpu_torch.io.avro import read_records
from photon_tpu_torch.online.delta import EntityPatch, ModelDelta
from photon_tpu_torch.replication import (
    DeltaLogWriter,
    ReplicaTailer,
    log_next_seq,
)
from photon_tpu_torch.serving import (
    MicroBatcher,
    ModelRegistry,
    ScoringServer,
    ServingConfig,
)
from test_torch_faults import REPO, _code
from test_torch_jax_decoder import jax_decoder  # noqa: F401
from test_torch_replication import FORBIDDEN_LIBS, _maps
from test_torch_serving import payload, train_models

COPIES = ["control/actions.py", "control/controller.py", "control/ledger.py",
          "control/policy.py", "control/__init__.py", "cli/control_driver.py"]
CONFIG = dict(max_batch=8, cache_entities=16, max_row_nnz=32)


@pytest.mark.parametrize("rel", COPIES)
def test_control_modules_are_copies(rel):
    port = os.path.join(REPO, "photon_tpu_torch", rel)
    jax = os.path.join(REPO, "photon_tpu", rel)
    assert _code(port, rename=True) == _code(jax, rename=False)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return train_models(tmp_path_factory.mktemp("torch_control"))


def _wait(pred, timeout_s=30.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def _replica(model_dir, log_path, name, tmp_path):
    registry = ModelRegistry(model_dir, ServingConfig(**CONFIG), device="cpu")
    server = ScoringServer(registry, MicroBatcher(max_batch=8, max_wait_ms=1.0),
                           port=0, metrics_interval_s=3600)
    tailer = ReplicaTailer(registry, log_path, replica_id=name,
                           cursor_dir=str(tmp_path), poll_s=0.005)
    tailer.run_once()
    server.attach_replication(tailer)
    server.start()
    tailer.start()
    return server


def _url(server):
    return f"http://{server.address[0]}:{server.address[1]}"


def _coefs(server, key):
    return server.registry.current.scorer._caches["perUser"].store.lookup(key)


def _wave(key, cols, vals, seq):
    return ModelDelta(seq=seq, patches={"perUser": {key: EntityPatch(
        key=key, cols=np.asarray(cols, np.int32),
        vals=np.asarray(vals, np.float32))}}, event_horizon=seq)


def _tick_until(ctl, event, limit=50):
    for _ in range(limit):
        ctl.tick()
        rows = [r for r in ctl.ledger.rows() if r["event"] == event]
        if rows:
            return rows
    raise AssertionError(f"no {event} row in {limit} ticks")


def test_canary_promotes_clean_wave_and_rolls_back_poison(trained, tmp_path):
    base = trained.jax[0]
    main_log = str(tmp_path / "delta-log.jsonl")
    canary_log = str(tmp_path / "delta-log.canary.jsonl")
    probe = payload(read_records(trained.val)[0])
    key = probe["entities"]["userId"]
    ref = _replica(base, main_log, "ref", tmp_path)
    can = _replica(base, canary_log, "can", tmp_path)
    try:
        policy = ControlPolicy(
            tick_s=0.01, rules=(), autoscale=None,
            canary=CanaryPolicy(soak_ticks=2, drift_threshold=0.25,
                                settle_ticks=2))
        ctl = Controller(
            policy, [ReplicaTarget(_url(ref)), ReplicaTarget(_url(can),
                                                             canary=True)],
            ControlLedger(str(tmp_path / LEDGER_FILENAME)),
            main_log_path=main_log, canary_log_path=canary_log,
            base_model_dir=base, probe_rows=[probe])
        assert log_next_seq(main_log) == 1           # the base marker
        cols, vals = _coefs(ref, key)
        good = vals + np.float32(0.01)
        # The clean wave: applied by the canary before the controller looks.
        with DeltaLogWriter(canary_log) as w:
            w.append(_wave(key, cols, good, 0))
        _wait(lambda: can.replication.snapshot()["seq_watermark"] >= 0,
              what="the canary's apply")
        promote = _tick_until(ctl, "canary_promote")
        assert promote[0]["main_seqs"] == [1]
        probes = [r for r in ctl.ledger.rows() if r["event"] == "canary_probe"]
        assert len(probes) == 2 and all(p["drift"] < 0.25 for p in probes)
        _wait(lambda: ref.replication.snapshot()["seq_watermark"] >= 1,
              what="the promoted wave on the reference")
        np.testing.assert_array_equal(_coefs(ref, key)[1], good)
        # The poisoned wave: the probed entity's coefficients moved by 99.
        with DeltaLogWriter(canary_log) as w:
            w.append(_wave(key, cols, vals + np.float32(99.0), 1))
        _wait(lambda: can.replication.snapshot()["seq_watermark"] >= 1,
              what="the canary's apply")
        rollback = _tick_until(ctl, "canary_rollback")
        assert len(rollback) == 1 and rollback[0]["reason"] == "score_drift"
        rows = ctl.ledger.rows()
        resync = [r for r in rows if r["event"] == "canary_resync"]
        assert resync == [dict(resync[0], ok=True, deltas=1)]
        # Rolled back from the ledger's own rows: the canary swapped to the
        # base model and holds the promoted wave again, not the poison.
        assert can.registry.current.model_dir == base
        assert can.registry.current.version == 2
        np.testing.assert_array_equal(_coefs(can, key)[1], good)
        # The poison never reached the main log or the reference replica.
        assert log_next_seq(main_log) == 2
        time.sleep(0.05)
        assert ref.replication.snapshot()["seq_watermark"] == 1
        assert ref.registry.current.version == 1
        np.testing.assert_array_equal(_coefs(ref, key)[1], good)
        ledger = list(read_ledger(str(tmp_path / LEDGER_FILENAME)))
        assert [r["event"] for r in ledger].count("canary_promote") == 1
    finally:
        for s in (ref, can):
            s.replication.stop()
            s.shutdown()


def test_control_driver_process_loads_neither_torch_nor_jax(trained, tmp_path):
    base = trained.jax[0]
    ref = _replica(base, str(tmp_path / "log.jsonl"), "ref", tmp_path)
    out = tmp_path / "ctl"
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.Popen(
        [sys.executable, "-m", "photon_tpu_torch.cli.control_driver",
         "--replica", _url(ref), "--tick", "0.2", "--max-ticks", "300",
         "--output-dir", str(out)],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        ledger = out / LEDGER_FILENAME

        def ticked():
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            return ledger.exists() and "controller_started" in ledger.read_text()

        _wait(ticked, timeout_s=60, what="the controller's first row")
        maps = _maps(proc.pid)
        assert "python" in maps
        for lib in FORBIDDEN_LIBS:
            assert lib not in maps, lib
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
        ref.replication.stop()
        ref.shutdown()
    rows = [json.loads(x) for x in open(out / LEDGER_FILENAME) if x.strip()]
    assert rows[-1]["event"] == "controller_stopped"
