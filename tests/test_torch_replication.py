"""The port's replicated serving tier (``photon_tpu_torch/replication``,
``photon_tpu_torch/cli/router_driver.py``) against the JAX package's, on
the CPU.

* ``replication/{log,tailer,router,__init__}.py`` and
  ``cli/router_driver.py`` are copies: without docstrings, each equals the
  JAX package's with the package name renamed.
* A delta log written by JAX's ``DeltaLogWriter`` tails into the port's
  registry, and one written by the port's into JAX's: the same records,
  watermarks and served coefficients.
* The tailer over the port's ``ModelRegistry``: exactly once across a
  rejoin (the replay rebuilds the overlay, the journal books each seq once)
  and the snapshot catch-up through ``prepare_standby`` / ``swap``.
* The router over two of the port's ``ScoringServer``s: it routes (the
  scores are the replicas' own), drains a replica whose tailer refused a
  delta, and answers 503 when every replica is dead.
* The router driver's process maps neither torch's nor JAX's libraries.

Every wait has a timeout.
"""
import http.client
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

from photon_tpu import replication as jax_replication
from photon_tpu.online.delta import (
    EntityPatch as JaxPatch,
    ModelDelta as JaxDelta,
)
from photon_tpu.serving import (
    ModelRegistry as JaxRegistry,
    ServingConfig as JaxServingConfig,
)
from photon_tpu_torch import replication
from photon_tpu_torch.io.avro import read_records
from photon_tpu_torch.online.delta import EntityPatch, ModelDelta
from photon_tpu_torch.serving import (
    MicroBatcher,
    ModelRegistry,
    ScoringServer,
    ServingConfig,
)
from photon_tpu_torch.supervisor import RecoveryJournal
from test_torch_faults import REPO, _code
from test_torch_jax_decoder import jax_decoder  # noqa: F401
from test_torch_serving import payload, train_models

COPIES = ["replication/log.py", "replication/tailer.py",
          "replication/router.py", "replication/__init__.py",
          "cli/router_driver.py"]
CONFIG = dict(max_batch=8, cache_entities=16, max_row_nnz=32)


@pytest.mark.parametrize("rel", COPIES)
def test_replication_modules_are_copies(rel):
    port = os.path.join(REPO, "photon_tpu_torch", rel)
    jax = os.path.join(REPO, "photon_tpu", rel)
    assert _code(port, rename=True) == _code(jax, rename=False)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return train_models(tmp_path_factory.mktemp("torch_replication"))


def _delta(seq, entity="user1", val=0.1, pkg="port"):
    patch, delta = ((EntityPatch, ModelDelta) if pkg == "port"
                    else (JaxPatch, JaxDelta))
    return delta(seq=seq, patches={"perUser": {entity: patch(
        key=entity, cols=np.array([0], np.int32),
        vals=np.array([val], np.float32))}}, event_horizon=seq)


def _registry(model_dir):
    return ModelRegistry(model_dir, ServingConfig(**CONFIG), device="cpu")


def _journal_rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _http(addr, method, path, body=None):
    conn = http.client.HTTPConnection(*addr, timeout=30)
    data = None if body is None else json.dumps(body).encode()
    conn.request(method, path, body=data,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


def _wait(pred, timeout_s=30.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


# ------------------------------------------------------- across packages


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_delta_log_tails_across_packages(trained, writer, tmp_path):
    """The log one package writes is applied by the other's tailer into
    the other's registry: the same records, the same watermark, the same
    patched coefficients."""
    m1 = trained.jax[0]
    path = str(tmp_path / "delta-log.jsonl")
    wpkg = jax_replication if writer == "jax" else replication
    with wpkg.DeltaLogWriter(path) as w:
        w.append_snapshot(m1, note="base")
        w.append(_delta(1, val=0.25, pkg=writer), trace_id="tid-1")
        w.append(_delta(2, entity="user2", val=0.7, pkg=writer))
        w.append(_delta(3, val=-0.5, pkg=writer))
    recs = {pkg: [(r.seq, r.is_snapshot, r.trace_id,
                   None if r.delta is None else r.delta.to_wire())
                  for r in mod.iter_log(path)]
            for pkg, mod in (("jax", jax_replication), ("port", replication))}
    assert recs["port"] == recs["jax"]
    if writer == "jax":
        registry = _registry(m1)
        tailer = replication.ReplicaTailer(registry, path, replica_id="rP",
                                           cursor_dir=str(tmp_path))
    else:
        registry = JaxRegistry(m1, JaxServingConfig(**CONFIG))
        tailer = jax_replication.ReplicaTailer(
            registry, path, replica_id="rJ", cursor_dir=str(tmp_path))
    assert tailer.run_once() == 3
    snap = tailer.snapshot()
    assert snap["seq_watermark"] == 3 and snap["lag"] == 0
    store = registry.current.scorer._caches["perUser"].store
    assert store.lookup("user1")[1][0] == pytest.approx(-0.5)
    assert store.lookup("user2")[1][0] == pytest.approx(0.7)


# ---------------------------------------------------------------- tailer


def test_tailer_exactly_once_across_rejoin(trained, tmp_path):
    m1 = trained.jax[0]
    log_path = str(tmp_path / "delta-log.jsonl")
    journal = RecoveryJournal(str(tmp_path / "recovery.jsonl"))
    with replication.DeltaLogWriter(log_path) as w:
        w.append_snapshot(m1, note="base")
        w.append(_delta(1, val=0.1), trace_id="tid-1")
        w.append(_delta(2, entity="user2", val=0.7), trace_id="tid-2")
        w.append(_delta(3, val=0.3), trace_id="tid-3")
    tailer = replication.ReplicaTailer(_registry(m1), log_path,
                                       replica_id="rA",
                                       cursor_dir=str(tmp_path),
                                       journal=journal)
    assert tailer.run_once() == 3
    assert tailer.run_once() == 0                 # idempotent drain
    assert tailer.snapshot()["applied_total"] == 3
    with replication.DeltaLogWriter(log_path) as w:
        w.append(_delta(4, val=0.9))
    # The rejoining incarnation boots a fresh registry: it replays the
    # journaled backlog, then applies only the new record.
    registry2 = _registry(m1)
    rejoined = replication.ReplicaTailer(registry2, log_path,
                                         replica_id="rA",
                                         cursor_dir=str(tmp_path),
                                         journal=journal)
    assert rejoined.run_once() == 4
    snap = rejoined.snapshot()
    assert snap["seq_watermark"] == 4
    assert snap["replayed_total"] == 3 and snap["applied_total"] == 1
    store = registry2.current.scorer._caches["perUser"].store
    assert store.lookup("user2")[1][0] == pytest.approx(0.7)
    assert store.lookup("user1")[1][0] == pytest.approx(0.9)
    rows = _journal_rows(journal.path)
    applied = [r["seq"] for r in rows if r["event"] == "replica_delta_applied"]
    assert sorted(applied) == [1, 2, 3, 4]
    replayed = [r["seq"] for r in rows
                if r["event"] == "replica_delta_replayed"]
    assert sorted(replayed) == [1, 2, 3]
    assert replication.ReplicaCursor(str(tmp_path), "rA").load() == 5


def test_tailer_snapshot_catchup_swaps(trained, tmp_path):
    m1, m2 = trained.jax
    log_path = str(tmp_path / "delta-log.jsonl")
    with replication.DeltaLogWriter(log_path) as w:
        w.append_snapshot(m1, note="base")        # seq 0
        for i in range(1, 5):
            w.append(_delta(i))                   # seqs 1..4
        w.append_snapshot(m2, note="retrain")     # seq 5
        w.append(_delta(9, val=0.4))              # seq 6
    registry = _registry(m1)
    journal = RecoveryJournal(str(tmp_path / "recovery.jsonl"))
    tailer = replication.ReplicaTailer(registry, log_path, replica_id="rC",
                                       cursor_dir=str(tmp_path),
                                       catchup_lag=2, journal=journal)
    assert tailer.run_once() == 1
    snap = tailer.snapshot()
    assert snap["catchups"] == 1 and snap["seq_watermark"] == 6
    assert registry.current.model_dir == m2
    assert registry.current.version == 2
    store = registry.current.scorer._caches["perUser"].store
    assert store.lookup("user1")[1][0] == pytest.approx(0.4)
    events = [r["event"] for r in _journal_rows(journal.path)]
    assert "replica_catchup_begin" in events
    assert "replica_catchup_done" in events
    lazy = replication.ReplicaTailer(_registry(m1), log_path, replica_id="rD",
                                     cursor_dir=str(tmp_path),
                                     catchup_lag=100)
    assert lazy.run_once() == 5
    assert lazy.snapshot()["catchups"] == 0


# ---------------------------------------------------------------- router


@pytest.fixture
def replicas(trained, tmp_path):
    """Two port replicas of one model, each a threaded ScoringServer with a
    tailer attached (replica b's log holds a delta its registry refuses)."""
    servers = []
    for name in ("a", "b"):
        registry = _registry(trained.jax[0])
        server = ScoringServer(registry, MicroBatcher(max_batch=8,
                                                      max_wait_ms=1.0),
                               port=0, metrics_interval_s=3600)
        log = str(tmp_path / f"log-{name}.jsonl")
        with replication.DeltaLogWriter(log) as w:
            w.append(_delta(1, val=0.5))
            if name == "b":
                bad = ModelDelta(seq=2, patches={"perUser": {"user3": EntityPatch(
                    key="user3", cols=np.array([10 ** 6], np.int32),
                    vals=np.array([1.0], np.float32))}}, event_horizon=2)
                w.append(bad)
        tailer = replication.ReplicaTailer(registry, log, replica_id=name,
                                           cursor_dir=str(tmp_path))
        if name == "b":
            with pytest.raises(ValueError, match="out of range"):
                tailer.run_once()
        else:
            tailer.run_once()
        server.attach_replication(tailer)
        server.start()
        servers.append(server)
    yield servers
    for s in servers:
        s.shutdown()


def _router(servers, **kw):
    kw.setdefault("health_interval_s", 3600)     # sweeps driven by the test
    kw.setdefault("seed", 17)
    r = replication.RouterServer(
        [f"http://{s.address[0]}:{s.address[1]}" for s in servers], port=0,
        **kw)
    r.check_replicas()
    r.start()
    return r


def test_router_routes_drains_and_fails_closed(trained, replicas):
    a, b = replicas
    st, health_b = _http(b.address, "GET", "/healthz")
    assert "replication_error" in health_b["degraded"]
    router = _router(replicas, retries=1)
    try:
        for rec in read_records(trained.val)[:12]:
            body = payload(rec)
            st, direct = _http(a.address, "POST", "/score", body)
            st2, routed = _http(router.address, "POST", "/score", body)
            assert st == st2 == 200
            assert routed["score"] == direct["score"]
        assert a.metrics_snapshot()["requests"] == 24
        assert b.metrics_snapshot()["requests"] == 0   # drained
        st, health = _http(router.address, "GET", "/healthz")
        assert st == 200 and health["head_seq_watermark"] == 0
        for s in replicas:
            s.shutdown()
        router.check_replicas()
        st, body = _http(router.address, "POST", "/score",
                         payload(read_records(trained.val)[0]))
        assert st == 503 and "no replica available" in body["error"]
        st, health = _http(router.address, "GET", "/healthz")
        assert st == 503 and health["status"] == "unhealthy"
    finally:
        router.shutdown()


def _maps(pid) -> str:
    with open(f"/proc/{pid}/maps") as f:
        return f.read()


FORBIDDEN_LIBS = ("libtorch", "site-packages/torch/", "site-packages/jax/",
                  "jaxlib", "xla_extension")


def test_router_driver_process_loads_neither_torch_nor_jax(replicas, tmp_path):
    a, _ = replicas
    out = tmp_path / "router"
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.Popen(
        [sys.executable, "-m", "photon_tpu_torch.cli.router_driver",
         "--replica", f"http://{a.address[0]}:{a.address[1]}", "--port", "0",
         "--output-dir", str(out)],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        addr = None
        deadline = time.monotonic() + 60
        while addr is None:
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            assert time.monotonic() < deadline, "the router never logged"
            log = ((out / "photon.log").read_text()
                   if (out / "photon.log").exists() else "")
            m = re.search(r"http://([0-9.]+):(\d+)", log)
            addr = m and (m.group(1), int(m.group(2)))
            time.sleep(0.05)
        st, health = _http(addr, "GET", "/healthz")
        assert st == 200
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
