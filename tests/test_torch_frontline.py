"""The port's serving front line (``photon_tpu_torch/serving/{wire,ipc,
circuit,autotune,batcher,frontline,async_frontend}.py`` and
``online/delta.py``) against the JAX package's.

* The modules are copies: without docstrings, each equals the JAX
  package's with the package name renamed.
* Frames encoded by one package decode in the other, byte for byte the
  same encodings; a shared-memory ring made by one package carries frames
  to the other.
* One front-line box at a tiny size (the port's registry on the CPU, one
  worker process): JSON and wire requests through the worker score as the
  threaded server's batcher does, and the worker process has mapped
  neither torch's nor JAX's libraries. Every wait has a timeout.
"""
import http.client
import json
import os

import numpy as np
import pytest

from photon_tpu.serving import ipc as jax_ipc
from photon_tpu.serving import wire as jax_wire
from photon_tpu_torch.io.avro import read_records
from photon_tpu_torch.serving import (
    MicroBatcher,
    ModelRegistry,
    ScoringServer,
    ServingConfig,
)
from photon_tpu_torch.serving import ipc, wire
from photon_tpu_torch.serving.frontline import FrontLine, pick_port
from test_torch_faults import REPO, _code
from test_torch_jax_decoder import jax_decoder  # noqa: F401
from test_torch_serving import payload, train_models

COPIES = ["serving/circuit.py", "serving/wire.py", "serving/ipc.py",
          "serving/autotune.py", "serving/batcher.py", "serving/frontline.py",
          "serving/async_frontend.py", "online/delta.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_serving_modules_are_copies(rel):
    port = os.path.join(REPO, "photon_tpu_torch", rel)
    jax = os.path.join(REPO, "photon_tpu", rel)
    assert _code(port, rename=True) == _code(jax, rename=False)


def _rows(w, n=3, k=6):
    rng = np.random.default_rng(7)
    return [w.WireRow(
        shard_idx={"global": rng.integers(0, 100, k).astype(np.int32)},
        shard_val={"global": rng.normal(size=k).astype(np.float32)},
        offset=float(i) * 0.5,
        entity_keys={"perUser": f"user{i}" if i != 2 else None,
                     "perItem": f"ítem-{i}"},
        known_miss=frozenset({"perItem"} if i == 1 else ()),
    ) for i in range(n)]


def _frames(w):
    return {
        "request": w.encode_score_request(
            _rows(w), req_id=42, trace_id="t-abc", deadline_ms=125.0,
            store_generation=7),
        "response": w.encode_score_response(
            9, model_version=3, scores=np.asarray([0.25, -1.5, 3.0], np.float32),
            degraded=[(), ("perUser",), ("perUser", "perItem")],
            stages={"queue_wait": 0.001234, "kernel": 0.000789},
            flags=w.RESP_FLAG_TRACE_PROMOTED),
        "error": w.encode_score_response(
            5, status=w.STATUS_OVERLOADED, error="queue full", retry_after_s=1.0),
        "control": w.encode_control(w.KIND_CTL_REQ, 11, {"op": "tune",
                                                         "max_batch": 8}),
    }


def _decoded(w, kind, buf):
    if kind == "request":
        r = w.decode_score_request(buf)
        return (r.req_id, r.trace_id, r.deadline_ms, r.store_generation,
                [(dict((s, a.tolist()) for s, a in x.shard_idx.items()),
                  dict((s, a.tolist()) for s, a in x.shard_val.items()),
                  x.offset, dict(x.entity_keys), sorted(x.known_miss))
                 for x in r.rows])
    if kind == "control":
        return w.decode_control(buf)
    r = w.decode_score_response(buf)
    return (r.req_id, r.status, r.error, r.retry_after_s, r.model_version,
            r.trace_promoted, r.scores.tolist(), list(r.degraded),
            dict(r.stages))


@pytest.mark.parametrize("kind", ["request", "response", "error", "control"])
def test_frames_cross_packages(kind):
    """Each package's encoding of one frame is the same bytes, and each
    decodes the other's to the same values."""
    jbuf, pbuf = _frames(jax_wire)[kind], _frames(wire)[kind]
    assert bytes(jbuf) == bytes(pbuf)
    assert _decoded(wire, kind, jbuf) == _decoded(jax_wire, kind, jbuf)
    assert _decoded(jax_wire, kind, pbuf) == _decoded(wire, kind, pbuf)


def test_shm_ring_carries_frames_across_packages():
    if not ipc.shm_available():
        pytest.skip("no POSIX shared memory on this host")
    token = f"x{os.getpid() % 100000}"
    ring = jax_ipc.ShmRing.create(f"{token}-t", 1 << 16)
    try:
        peer = ipc.ShmRing.attach(f"{token}-t")
        try:
            for buf in _frames(jax_wire).values():
                ring.send(bytes(buf), timeout=5.0)
                assert peer.recv(timeout=5.0) == bytes(buf)
        finally:
            peer.close()
    finally:
        ring.close()


def _mapped_libraries(pid) -> str:
    with open(f"/proc/{pid}/maps") as f:
        return f.read()


@pytest.fixture(scope="module")
def flbox(tmp_path_factory):
    trained = train_models(tmp_path_factory.mktemp("torch_frontline"))
    runtime = tmp_path_factory.mktemp("flruntime")
    config = ServingConfig(max_batch=8, max_wait_ms=1.0, cache_entities=16,
                           max_row_nnz=32, max_queue=64, request_timeout_s=10.0)
    registry = ModelRegistry(trained.jax[0], config, device="cpu")
    server = ScoringServer(registry, MicroBatcher(max_batch=8, max_wait_ms=1.0,
                                                  max_queue=64),
                           port=0, metrics_interval_s=3600)
    server.start()
    env_before = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env_before) if p)
    fl = FrontLine(server, workers=1, host="127.0.0.1", port=pick_port(),
                   runtime_dir=str(runtime))
    try:
        fl.start(ready_timeout_s=60.0)
    except Exception:
        server.shutdown()
        raise
    finally:
        if env_before is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = env_before
    yield fl, server, trained
    fl.stop(timeout_s=10.0)
    server.shutdown()


def _post(addr, path, body, headers=None):
    conn = http.client.HTTPConnection(*addr, timeout=30)
    conn.request("POST", path, body=body, headers=headers or {})
    resp = conn.getresponse()
    out = resp.status, resp.read(), dict(resp.getheaders())
    conn.close()
    return out


def test_frontline_scores_as_threaded_server(flbox):
    fl, server, trained = flbox
    version = server.registry.current
    for rec in read_records(trained.val):
        row = version.scorer.parse_request(payload(rec))
        want = server.batcher.submit(version, row).result(timeout=10)
        st, data, hdrs = _post(server.address, "/score",
                               json.dumps(payload(rec)).encode())
        threaded = json.loads(data)
        st2, data2, hdrs2 = _post(fl.address, "/score",
                                  json.dumps(payload(rec)).encode())
        assert st == st2 == 200 and "X-Photon-Worker" in hdrs2
        body = json.loads(data2)
        assert body["score"] == threaded["score"] == float(want)
        # the same JSON text for the score
        assert json.dumps(body["score"]) == json.dumps(threaded["score"])
        assert body["model_version"] == 1 and body["uid"] == rec["uid"]
    st, data, _ = _post(fl.address, "/score", b'{"features": "nope"}')
    assert st == 400 and "error" in json.loads(data)


def test_frontline_wire_roundtrip(flbox):
    fl, server, trained = flbox
    version = server.registry.current
    rec = read_records(trained.val)[1]
    parsed = version.scorer.parse_request(payload(rec))
    want = float(server.batcher.submit(version, parsed).result(timeout=10))
    frame = wire.encode_score_request(
        [wire.WireRow(shard_idx=parsed.shard_idx, shard_val=parsed.shard_val,
                      offset=parsed.offset, entity_keys=parsed.entity_keys)],
        req_id=7, trace_id="t-wire", store_generation=server.registry.store_generation)
    st, data, hdrs = _post(fl.address, "/score", frame,
                           {"Content-Type": wire.WIRE_CONTENT_TYPE})
    assert st == 200 and hdrs["Content-Type"] == wire.WIRE_CONTENT_TYPE
    resp = wire.decode_score_response(data)
    assert resp.req_id == 7 and resp.status == wire.STATUS_OK
    assert float(resp.scores[0]) == want
    assert "kernel" in resp.stages and "ipc" in resp.stages


def test_frontline_worker_loads_neither_torch_nor_jax(flbox):
    fl, _, _ = flbox
    workers = fl.workers_snapshot()
    pids = [w["pid"] for w in workers]
    assert len(pids) == 1 and workers[0]["state"] == "live"
    maps = _mapped_libraries(pids[0])
    assert "python" in maps  # the worker is alive and readable
    for lib in ("libtorch", "site-packages/torch/", "site-packages/jax/",
                "jaxlib", "xla_extension"):
        assert lib not in maps, lib
    st, data, _ = _post(fl.address, "/admin/tune",
                        json.dumps({"max_wait_ms": 1.5}).encode())
    assert st == 200 and json.loads(data)["max_wait_ms"] == 1.5
