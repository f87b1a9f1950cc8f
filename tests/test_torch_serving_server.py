"""The port's scoring server (``photon_tpu_torch/serving/server.py``) end to
end over HTTP, on the CPU, against the JAX package's server.

* One scripted run of requests (scores, bad bodies, unknown routes,
  ``/healthz``, ``/admin/tune``, ``/admin/patch`` with an idempotency key,
  ``/admin/standby``, ``/admin/swap``, ``/admin/memory/shed``,
  ``/admin/replication/restart``) gets the same statuses and JSON bodies
  from both servers on the same model directory, with timings and clock
  readings taken out (scores within 1e-5·(1+|score|)).
* Hot swap under concurrent requests (none fails; new traffic scores on the
  new model), the warm standby's pointer-move swap, shedding past the queue
  bound (503 + Retry-After), expired rows never reaching the kernel, the
  store breaker degrading to fixed-effect-only, memory-pressure shedding,
  the kernel breaker's device-loss recovery, the OOM downshift to a warmed
  bucket, a poisoned CUDA context that is not retried, and the SIGTERM
  drain.
"""
import http.client
import json
import threading
import time

import numpy as np
import pytest

from photon_tpu.serving import (
    MicroBatcher as JaxBatcher,
    ModelRegistry as JaxRegistry,
    ScoringServer as JaxServer,
    ServingConfig as JaxServingConfig,
)
from photon_tpu_torch.faults import FaultPlan, FaultSpec, active_plan
from photon_tpu_torch.io.avro import read_records
from photon_tpu_torch.runtime import memory_guard
from photon_tpu_torch.serving import (
    DeadlineExceeded,
    MicroBatcher,
    ModelRegistry,
    Overloaded,
    ScoringServer,
    ServingConfig,
)
from test_torch_jax_decoder import jax_decoder  # noqa: F401
from test_torch_serving import CONFIG, close, payload, train_models


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return train_models(tmp_path_factory.mktemp("torch_serving_server"))


@pytest.fixture(autouse=True)
def _clean_guards():
    memory_guard.reset_state()
    yield
    memory_guard.reset_state()


def request(addr, method, path, body=None, headers=None, raw=None):
    conn = http.client.HTTPConnection(*addr, timeout=30)
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    conn.request(method, path, body=data, headers=headers or {})
    resp = conn.getresponse()
    text = resp.read()
    out = (resp.status, json.loads(text), dict(resp.getheaders()))
    conn.close()
    return out


def port_server(model_dir, config=None, **batcher):
    registry = ModelRegistry(model_dir, config or ServingConfig(**CONFIG),
                             device="cpu")
    server = ScoringServer(registry, MicroBatcher(
        **{"max_batch": 8, "max_wait_ms": 1.0, **batcher}), port=0)
    server.start()
    return server


# Per-route keys whose values are timings or clock readings.
_CLOCKS = {"uptime_s", "last_swap_ts", "seconds_since_swap", "last_patch_ts",
           "seconds_since_patch", "prepared_at", "swap_to_first_score_seconds",
           "restart_to_first_step_seconds"}


def normalize(body):
    if isinstance(body, dict):
        return {k: ("<clock>" if v is not None else None) if k in _CLOCKS
                else normalize(v) for k, v in body.items() if k != "restarts"}
    if isinstance(body, list):
        return [normalize(v) for v in body]
    return body


def script(trained):
    recs = read_records(trained.val)
    key = recs[0]["metadataMap"]["userId"]
    over = {"features": [{"name": "g", "term": str(j % 5), "value": 1.0}
                         for j in range(40)]}
    patch = {"seq": 3, "event_horizon": 41, "patches": {"perUser": {key: {
        "cols": [0, 2], "vals": [0.5, -0.25]}}}}
    idem = {"X-Photon-Idempotency-Key": "delta-3"}
    steps = [("GET", "/healthz", None, None, None)]
    steps += [("POST", "/score", payload(r), None, None) for r in recs]
    steps += [
        ("POST", "/score", {**payload(recs[0]), "entities": {"userId": "ghost"}},
         None, None),
        ("POST", "/score", None, None, b"{not json"),
        ("POST", "/score", over, None, None),
        ("POST", "/score", [1, 2], None, None),
        ("GET", "/nope", None, None, None),
        ("POST", "/nope", {"x": 1}, None, None),
        ("POST", "/admin/tune", {"max_batch": 4, "max_queue": 64}, None, None),
        ("POST", "/admin/tune", {}, None, None),
        ("POST", "/admin/tune", {"max_batch": 0}, None, None),
        ("POST", "/admin/patch", patch, idem, None),
        ("POST", "/admin/patch", patch, idem, None),
        ("POST", "/admin/patch", {"patches": {"noSuchCoord": {
            "x": {"cols": [0], "vals": [1.0]}}}}, None, None),
        ("POST", "/admin/patch", {"patches": {"perUser": {key: {
            "cols": [10 ** 6], "vals": [1.0]}}}}, None, None),
        ("POST", "/score", payload(recs[0]), None, None),
        ("POST", "/admin/standby", {"model_dir": trained.jax[1]}, None, None),
        ("GET", "/healthz", None, None, None),
        ("POST", "/admin/swap", {"model_dir": trained.jax[1]}, None, None),
        ("POST", "/admin/swap", {}, None, None),
        ("POST", "/admin/swap", {"model_dir": str(trained.d / "missing")},
         None, None),
        ("POST", "/score", payload(recs[1]), None, None),
        ("POST", "/admin/memory/shed", {}, None, None),
        ("POST", "/admin/replication/restart", {}, None, None),
        ("GET", "/healthz", None, None, None),
    ]
    return steps


def _reset_recovery_gauges():
    """Both packages' process-global recovery gauges back to unstamped: a
    swap scored by an earlier test in the same process stamps its own
    package's ``swap_to_first_score_seconds``, which ``/healthz`` reports."""
    from photon_tpu.obs.metrics import REGISTRY as JAX_REGISTRY
    from photon_tpu_torch.obs.metrics import REGISTRY as PORT_REGISTRY

    for registry in (JAX_REGISTRY, PORT_REGISTRY):
        for name in ("swap_to_first_score_seconds",
                     "restart_to_first_step_seconds"):
            registry.gauge(name).reset()


def test_http_routes_match_jax_server(trained):
    _reset_recovery_gauges()
    jax_registry = JaxRegistry(trained.jax[0], JaxServingConfig(**CONFIG))
    jax_server = JaxServer(jax_registry, JaxBatcher(max_batch=8, max_wait_ms=1.0),
                           port=0)
    jax_server.start()
    server = port_server(trained.jax[0])
    try:
        n_score = 0
        for method, path, body, headers, raw in script(trained):
            js, jb, _ = request(jax_server.address, method, path, body, headers, raw)
            ps, pb, ph = request(server.address, method, path, body, headers, raw)
            assert ps == js, (path, pb, jb)
            if "score" in jb:
                close([pb.pop("score")], [jb.pop("score")])
                n_score += 1
            assert normalize(pb) == normalize(jb), (path, pb, jb)
            if ps == 503:
                assert ph["Retry-After"] == "1"
        assert n_score == len(read_records(trained.val)) + 3
        # the metrics snapshot: the JAX keys less the XLA retrace counters
        jm = jax_server.metrics_snapshot()
        pm = server.metrics_snapshot()
        assert set(jm) - set(pm) == {"kernel_traces", "kernel_retraces_after_warmup"}
        assert set(pm) <= set(jm)
        for k in ("requests", "errors", "swaps", "patches", "patch_duplicates",
                  "tunes", "memory_sheds", "model_version"):
            assert pm[k] == jm[k], k
        assert pm["coefficient_caches"] == jm["coefficient_caches"]
    finally:
        jax_server.shutdown()
        server.shutdown()


def test_hot_swap_under_concurrent_load(trained):
    """Eight client threads keep sending rows while the model swaps from
    ``models/0`` to ``models/1``: no request fails, and after the swap every
    score is the new model's."""
    server = port_server(trained.jax[0])
    recs = read_records(trained.val)
    stop, failures, served = threading.Event(), [], []

    def client(i):
        while not stop.is_set():
            st, body, _ = request(server.address, "POST", "/score",
                                  payload(recs[i % len(recs)]))
            (served if st == 200 else failures).append(body)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    try:
        for t in threads:
            t.start()
        while len(served) < 40:
            time.sleep(0.01)
        st, body, _ = request(server.address, "POST", "/admin/swap",
                              {"model_dir": trained.jax[1]})
        assert st == 200 and body == {"model_version": 2}
        n = len(served)
        while len(served) < n + 40:
            time.sleep(0.01)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert failures == []
        assert {b["model_version"] for b in served} == {1, 2}
        scorer = server.registry.current.scorer
        want = scorer.score_rows([scorer.parse_request(payload(r)) for r in recs])
        for i, r in enumerate(recs):
            st, body, _ = request(server.address, "POST", "/score", payload(r))
            assert st == 200 and body["model_version"] == 2
            assert body["score"] == float(want[i])
    finally:
        stop.set()
        server.shutdown()


def test_standby_swap_is_pointer_move(trained):
    registry = ModelRegistry(trained.jax[0], ServingConfig(**CONFIG), device="cpu")
    info = registry.prepare_standby(trained.jax[1])
    assert info["warmed"] and registry.standby_snapshot()["ready"]
    standby = registry._standby
    v = registry.swap(trained.jax[1])
    assert v.scorer is standby.scorer and v.version == 2
    assert not registry.standby_snapshot()["ready"]
    # a swap to another directory builds it afresh
    v3 = registry.swap(trained.jax[0])
    assert v3.version == 3 and v3.scorer is not standby.scorer


def test_apply_delta_rejects_overwide_patch(trained):
    registry = ModelRegistry(trained.jax[0], ServingConfig(**CONFIG), device="cpu")
    cache = registry.current.scorer._caches["perUser"]
    key = list(cache.store.keys)[0]
    wide = np.arange(cache.width + 1, dtype=np.int32)
    with pytest.raises(ValueError, match="cache width"):
        registry.apply_delta({"perUser": {
            key: (wide, np.ones(len(wide), np.float32))}})
    assert cache.store.n_patched == 0
    assert registry.freshness_snapshot()["patch_seq"] == 0


def test_shedding_past_queue_bound(trained):
    """Bounded admission: past ``max_queue`` a submit raises ``Overloaded``
    at once, and over HTTP the request gets 503 + Retry-After; admitted
    rows still score."""
    server = port_server(trained.jax[0], max_queue=1, start=False)
    version = server.registry.current
    rec = read_records(trained.val)[0]
    row = version.scorer.parse_request(payload(rec))
    try:
        admitted = server.batcher.submit(version, row)
        with pytest.raises(Overloaded):
            server.batcher.submit(version, row)
        st, body, hdrs = request(server.address, "POST", "/score", payload(rec))
        assert st == 503 and body["shed"] is True and hdrs["Retry-After"] == "1"
        assert server.counters["shed"] == 1 and server.batcher.stats["shed"] == 2
        server.batcher.start()
        assert isinstance(admitted.result(timeout=30), float)
    finally:
        server.shutdown()


def test_expired_rows_never_reach_kernel(trained):
    registry = ModelRegistry(trained.jax[0], ServingConfig(**CONFIG), device="cpu")
    version = registry.current
    row = version.scorer.parse_request(payload(read_records(trained.val)[0]))
    batcher = MicroBatcher(max_batch=8, max_wait_ms=1.0, start=False)
    expired = batcher.submit(version, row, deadline=time.monotonic() - 0.01)
    live = batcher.submit(version, row, deadline=time.monotonic() + 30.0)
    plan = FaultPlan(seed=0, specs=[FaultSpec(site="serving.kernel", delay_s=0.0)])
    with active_plan(plan) as injector:
        batcher.start()
        assert isinstance(live.result(timeout=30), float)
        with pytest.raises(DeadlineExceeded):
            expired.result(timeout=30)
    # one scored batch, of the live row alone
    assert [e["site"] for e in injector.events] == ["serving.kernel"]
    assert batcher.stats["expired"] == 1 and batcher.stats["rows"] == 1
    batcher.close()


def test_store_breaker_degrades_to_fixed_effect_only(trained):
    config = ServingConfig(**CONFIG, breaker_failures=3, breaker_cooldown_s=0.2)
    server = port_server(trained.jax[0], config)
    scorer = server.registry.current.scorer
    rec = read_records(trained.val)[0]
    try:
        fixed_only = float(scorer.score_rows([scorer.parse_request(
            {**payload(rec), "entities": {}})])[0])
        cached, flags = scorer.score_rows_flagged([scorer.parse_request(payload(rec))])
        assert flags[0] == ()
        ghost = {**payload(rec), "entities": {"userId": "chaos-ghost"}}
        outage = FaultPlan(seed=0, specs=[
            FaultSpec(site="serving.store_lookup", error="os")])
        with active_plan(outage):
            st, body, _ = request(server.address, "POST", "/score", ghost)
            assert st == 200 and body["degraded"] == ["perUser"]
            assert body["score"] == pytest.approx(fixed_only, abs=1e-6)
            for _ in range(4):
                request(server.address, "POST", "/score", ghost)
            snap = scorer.cache_snapshot()["perUser"]
            assert snap["breaker"]["state"] == "open" and snap["degraded"] >= 3
            st, health, _ = request(server.address, "GET", "/healthz")
            assert health["degraded"] == ["breaker_open:store:perUser"]
            # a cached entity still scores its full random effect
            st, body, _ = request(server.address, "POST", "/score", payload(rec))
            assert "degraded" not in body
            assert body["score"] == pytest.approx(float(cached[0]), abs=1e-7)
        time.sleep(0.25)
        st, body, _ = request(server.address, "POST", "/score", ghost)
        assert "degraded" not in body
        assert scorer.cache_snapshot()["perUser"]["breaker"]["state"] == "closed"
        assert server.counters["degraded"] >= 5
    finally:
        server.shutdown()


def test_memory_pressure_sheds_and_shed_route(trained, monkeypatch):
    stats = {"bytes_in_use": 97, "bytes_limit": 100, "watermark": 0.97}
    guard = memory_guard.MemoryGuard(stats_fn=lambda: dict(stats),
                                     min_sample_interval_s=0.0)
    monkeypatch.setattr(memory_guard, "_GUARD", guard)
    server = port_server(trained.jax[0])
    rec = read_records(trained.val)[0]
    try:
        st, body, hdrs = request(server.address, "POST", "/score", payload(rec))
        assert st == 503 and body["shed"] and hdrs["Retry-After"] == "1"
        st, health, _ = request(server.address, "GET", "/healthz")
        assert "memory_pressure" in health["degraded"]
        st, out, _ = request(server.address, "POST", "/admin/memory/shed", {})
        assert st == 200 and out == {"freed_bytes": 0, "watermark": 0.97,
                                     "available": True}
        stats.update(bytes_in_use=10, watermark=0.1)
        st, body, _ = request(server.address, "POST", "/score", payload(rec))
        assert st == 200
        assert server.counters["shed"] == 1 and server.counters["memory_sheds"] == 1
    finally:
        server.shutdown()


def test_kernel_device_lost_recovers_through_breaker(trained):
    server = port_server(trained.jax[0])
    scorer = server.registry.current.scorer
    rec = read_records(trained.val)[0]
    want = float(scorer.score_rows([scorer.parse_request(payload(rec))])[0])
    plan = FaultPlan(seed=0, specs=[
        FaultSpec(site="serving.kernel", error="device_lost", count=1)])
    try:
        with active_plan(plan):
            st, body, _ = request(server.address, "POST", "/score", payload(rec))
        assert st == 200 and body["score"] == want
        snap = scorer.breaker_snapshot()["__kernel__"]
        assert snap["state"] == "closed" and snap["failures"] == 1
        st, health, _ = request(server.address, "GET", "/healthz")
        assert health["status"] == "ok" and health["restarts"]["device_lost"] >= 1
    finally:
        server.shutdown()


def test_poisoned_context_is_not_retried(trained, monkeypatch):
    """A device loss whose CUDA context no longer answers is not re-run: the
    kernel breaker opens, the batch fails with ``DeviceContextLost`` and
    ``/healthz`` reports the kernel breaker."""
    from photon_tpu_torch.runtime import backend_guard

    server = port_server(trained.jax[0])
    scorer = server.registry.current.scorer
    rec = read_records(trained.val)[0]
    monkeypatch.setattr(backend_guard, "context_usable", lambda: False)
    plan = FaultPlan(seed=0, specs=[
        FaultSpec(site="serving.kernel", error="device_lost")])
    try:
        with active_plan(plan) as injector:
            st, body, _ = request(server.address, "POST", "/score", payload(rec))
            assert st == 500 and "DeviceContextLost" in body["error"]
            assert len(injector.events) == 1   # no re-run of the batch
            st, body, _ = request(server.address, "POST", "/score", payload(rec))
            assert st == 500
        assert scorer.breaker_snapshot()["__kernel__"]["state"] == "open"
        st, health, _ = request(server.address, "GET", "/healthz")
        assert health["degraded"] == ["breaker_open:kernel"]
    finally:
        server.shutdown()


def test_kernel_oom_downshifts_to_warmed_bucket(trained):
    server = port_server(trained.jax[0])
    scorer = server.registry.current.scorer
    recs = read_records(trained.val)
    rows = [scorer.parse_request(payload(r)) for r in recs[:8]]
    want = scorer.score_rows(rows)
    plan = FaultPlan(seed=0, specs=[
        FaultSpec(site="serving.kernel", error="device_oom", count=1)])
    try:
        with active_plan(plan):
            got = scorer.score_rows(rows)
        np.testing.assert_array_equal(got, want)
        assert scorer._max_batch_cap == 4
        assert memory_guard.sticky_plan("serving.kernel") == {"max_batch": 4}
        # a fresh version starts at the sticky cap, its ladder warmed to it
        st, body, _ = request(server.address, "POST", "/admin/swap",
                              {"model_dir": trained.jax[1]})
        assert st == 200 and server.registry.current.scorer._max_batch_cap == 4
        st, body, _ = request(server.address, "POST", "/score", payload(recs[0]))
        assert st == 200
    finally:
        server.shutdown()


def test_sigterm_drain_finishes_inflight_and_flushes(trained, tmp_path):
    registry = ModelRegistry(trained.jax[0], ServingConfig(**CONFIG), device="cpu")
    batcher = MicroBatcher(max_batch=8, max_wait_ms=400.0)
    metrics_path = tmp_path / "serving-metrics.jsonl"
    server = ScoringServer(registry, batcher, port=0,
                           metrics_path=str(metrics_path), metrics_interval_s=3600)
    server.start()
    rec = read_records(trained.val)[0]
    results = []

    def one():
        results.append(request(server.address, "POST", "/score", payload(rec)))

    threads = [threading.Thread(target=one) for _ in range(4)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 5
    while server._inflight < 4 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert server._inflight == 4
    server.shutdown(drain_timeout_s=10.0)
    for t in threads:
        t.join(timeout=30)
    assert [st for st, _, _ in results] == [200] * 4
    handler = server.httpd.RequestHandlerClass

    class _Fake:
        headers = {"Content-Length": "0"}

        def _reply(self, code, body, headers=()):
            self.code, self.body, self.hdrs = code, body, headers

    fake = _Fake()
    handler._score(fake)
    assert fake.code == 503 and fake.body["shed"] is True
    rows = [json.loads(line) for line in open(metrics_path) if line.strip()]
    assert rows and rows[-1]["requests"] >= 4


def test_timing_header_returns_stage_waterfall(trained):
    """The opt-in stage waterfall header, the handler's TCP_NODELAY (a
    reply's body is not held back behind a kept-alive client's delayed
    ACK) and the listen backlog of 128."""
    server = port_server(trained.jax[0])
    assert server.httpd.RequestHandlerClass.disable_nagle_algorithm is True
    assert server.httpd.request_queue_size == 128
    rec = read_records(trained.val)[0]
    try:
        st, body, hdrs = request(server.address, "POST", "/score", payload(rec),
                                 {"X-Photon-Timing": "1"})
        assert st == 200
        parts = dict(p.split(";dur=") for p in hdrs["X-Photon-Timing"].split(", "))
        assert list(parts) == ["admission", "queue_wait", "batch_assembly",
                               "store_resolve", "kernel", "response", "total"]
        assert all(float(v) >= 0 for v in parts.values())
        st, prom, _ = (lambda c: (c.status, c.read().decode(), None))(
            _raw_get(server.address, "/metrics?format=prom"))
        assert 'serve_stage_latency_seconds' in prom and "kernel" in prom
    finally:
        server.shutdown()


def _raw_get(addr, path):
    conn = http.client.HTTPConnection(*addr, timeout=30)
    conn.request("GET", path)
    return conn.getresponse()
