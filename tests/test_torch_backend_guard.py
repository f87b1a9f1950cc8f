"""The port's backend guard (``photon_tpu_torch/runtime/backend_guard.py``)
against the JAX package's.

* The classification table of ``tests/test_backend_guard.py`` gives equal
  causes in both packages, by text and by exception type; CUDA's own texts
  (out of memory, an illegal address, a launch failure, no device, an
  ``nvcc`` failure) land in the same classes, and the port's OOM types
  (``torch.cuda.OutOfMemoryError``) classify by type.
* The probe is a child under a hard deadline: a hanging child is killed at
  the deadline and a failing child is classified, in both packages alike;
  a process without a CUDA device fails at once, classified, with no child.
* ``strict`` raises a classified error, which the drivers' console entry
  turns into one line and exit 2; ``failover`` stamps its provenance;
  ``cpu-only`` and a run asked onto the CPU never probe; a process whose
  CUDA context is up skips the child.
* ``recover_from_device_loss`` releases the sweep caches and counts the
  recovery; a poisoned context raises ``DeviceContextLost``.
"""
import pytest
import torch

from photon_tpu.faults import DeviceLostError as JaxDeviceLost
from photon_tpu.runtime import backend_guard as jbg
from photon_tpu_torch.faults import DeviceLostError, DeviceOomError
from photon_tpu_torch.obs.metrics import REGISTRY
from photon_tpu_torch.runtime import backend_guard as bg


@pytest.fixture(autouse=True)
def _fresh_guard():
    bg.reset_guard()
    yield
    bg.reset_guard()


# tests/test_backend_guard.py's table, plus texts of the JAX module's
# patterns that table does not reach.
JAX_TABLE = [
    "UNAVAILABLE: TPU backend setup/compile error",
    "RuntimeError: Unable to initialize backend: UNAVAILABLE",
    "probe hung past the 120s PHOTON_BACKEND_INIT_TIMEOUT_S deadline "
    "(wedged device grant?)",
    "INTERNAL: device was lost mid-collective",
    "XlaRuntimeError: DEVICE_LOST: heartbeat missed",
    "RESOURCE_EXHAUSTED: out of memory allocating 16G on HBM",
    "XlaCompile failed: unsupported op",
    "Mosaic failed to lower kernel",
    "ValueError: bad flag",
    "peer host 3 lost: missed beacon",
    "socket closed by tunnel",
    "no visible devices",
]


@pytest.mark.parametrize("text", JAX_TABLE)
def test_classification_equals_jax(text):
    assert bg.classify_backend_error(text) == jbg.classify_backend_error(text)
    assert bg.classify_backend_error(RuntimeError(text)) == \
        jbg.classify_backend_error(RuntimeError(text))


@pytest.mark.parametrize("text,cause", [
    ("CUDA out of memory. Tried to allocate 2.00 GiB (GPU 0; 79.1 GiB total)", "oom"),
    ("ell_matvec launch failed: CUDA error 2 (out of memory)", "oom"),
    ("cudaErrorMemoryAllocation", "oom"),
    ("CUBLAS_STATUS_ALLOC_FAILED when calling cublasCreate(handle)", "oom"),
    ("cusolver error: CUSOLVER_STATUS_ALLOC_FAILED", "oom"),
    ("CUDA error: an illegal memory access was encountered", "device_lost"),
    ("csc_rmatvec launch failed: CUDA error 719 (unspecified launch failure)",
     "device_lost"),
    ("CUDA error: uncorrectable ECC error encountered", "device_lost"),
    ("GPU has fallen off the bus", "device_lost"),
    ("CUDA context unusable after a sticky error (x)", "device_lost"),
    ("RuntimeError: No CUDA GPUs are available; no CUDA-capable device is "
     "detected", "init_unavailable"),
    ("no CUDA device is available (torch.cuda.is_available() is false)",
     "init_unavailable"),
    ("CUDA driver version is insufficient for CUDA runtime version",
     "init_unavailable"),
    ("AssertionError: Torch not compiled with CUDA enabled", "init_unavailable"),
    ("CUDA-capable device(s) is/are busy or unavailable", "init_unavailable"),
    ("nvcc failed with exit code 1: ell_sparse.cu(12): error", "compile_error"),
    ("CUDA error: device-side assert triggered", "unknown"),
])
def test_cuda_texts_classify(text, cause):
    assert bg.classify_backend_error(text) == cause


def test_types_outrank_text_as_in_jax():
    for port, jax_err in ((DeviceLostError("boom"), JaxDeviceLost("boom")),
                          (MemoryError("x"), MemoryError("x")),
                          (OSError("connection reset by peer"),
                           OSError("connection reset by peer")),
                          (ConnectionError("socket closed"),
                           ConnectionError("socket closed"))):
        assert bg.classify_backend_error(port) == jbg.classify_backend_error(jax_err)
    assert bg.classify_backend_error(DeviceOomError("nothing said")) == "oom"
    assert bg.classify_backend_error(torch.cuda.OutOfMemoryError("?")) == "oom"
    assert bg.is_device_lost(DeviceLostError("x"))
    assert not bg.is_device_lost(RuntimeError("something else"))


def test_env_knobs_degrade_never_disable(monkeypatch):
    for name, fn in (("PHOTON_BACKEND_INIT_TIMEOUT_S", "backend_init_timeout_s"),
                     ("PHOTON_DEVICE_LOST_MAX_RECOVERIES", "max_inrun_recoveries")):
        for raw in ("7", "not-a-number", "-3"):
            monkeypatch.setenv(name, raw)
            assert getattr(bg, fn)() == getattr(jbg, fn)()


# -------------------------------------------------------------------- probe


def test_hanging_child_killed_at_the_deadline():
    import time

    t0 = time.monotonic()
    r = bg.probe_backend(timeout_s=1.5, probe_code="import time; time.sleep(600)")
    assert time.monotonic() - t0 < 30.0
    assert not r.ok and r.cause == "init_unavailable" and "deadline" in r.reason


@pytest.mark.parametrize("stderr,cause", [
    ("Unable to initialize backend: UNAVAILABLE", "init_unavailable"),
    ("RuntimeError: CUDA error: no CUDA-capable device is detected",
     "init_unavailable"),
    ("torch.OutOfMemoryError: CUDA out of memory.", "oom"),
])
def test_failing_child_classified_as_in_jax(stderr, cause):
    code = f"import sys; sys.stderr.write({stderr!r}); sys.exit(1)"
    port, jax = (m.probe_backend(timeout_s=30.0, probe_code=code) for m in (bg, jbg))
    assert not port.ok and port.cause == cause
    if "CUDA" not in stderr:
        assert jax.cause == cause
    assert stderr.split(":")[0] in port.reason


def test_probe_success_reports_backend_and_device():
    r = bg.probe_backend(timeout_s=30.0, attempts=2, probe_code=(
        "print('PHOTON_DEVICE=NVIDIA Test'); print('PHOTON_BACKEND=cuda')"))
    assert r.ok and r.backend == "cuda" and r.device_name == "NVIDIA Test"
    assert r.attempts == 1 and r.cause is None
    r = bg.probe_backend(timeout_s=30.0, attempts=2, probe_code="import sys; sys.exit(3)")
    assert not r.ok and r.attempts == 2


def test_no_cuda_device_fails_without_a_child(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bg, "_probe_once", lambda *a: pytest.fail("probed"))
    r = bg.probe_backend(timeout_s=30.0)
    assert not r.ok and r.attempts == 0 and r.cause == "init_unavailable"


# ------------------------------------------------------------------ policies


FAILING = "import sys; sys.stderr.write('UNAVAILABLE'); sys.exit(1)"


def test_strict_raises_classified_and_console_exits_2(capsys):
    from photon_tpu_torch.cli.params import console_main

    with pytest.raises(bg.BackendUnusable) as ei:
        bg.ensure_backend("strict", timeout_s=30.0, probe_code=FAILING)
    assert ei.value.cause == "init_unavailable"

    def run():
        bg.ensure_backend("strict", timeout_s=30.0, probe_code=FAILING)

    with pytest.raises(SystemExit) as ex:
        console_main(run)
    assert ex.value.code == 2
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith("fatal [init_unavailable]: ")


def test_failover_stamps_its_provenance():
    c = REGISTRY.counter("backend_failovers_total")
    before = c.value(cause="init_unavailable")
    snap = bg.ensure_backend("failover", timeout_s=30.0, probe_code=FAILING)
    assert snap["backend"] == "cpu" and snap["policy"] == "failover"
    assert snap["failover"]["to"] == "cpu"
    assert snap["failover"]["cause"] == "init_unavailable"
    assert bg.guard_snapshot() == snap
    assert c.value(cause="init_unavailable") == before + 1
    from photon_tpu_torch.cli.params import stamp_failover

    assert stamp_failover({})["backend"] == snap


@pytest.mark.parametrize("policy,device", [("cpu-only", "cuda"), ("strict", "cpu"),
                                           ("failover", "cpu")])
def test_cpu_runs_never_probe(monkeypatch, policy, device):
    monkeypatch.setattr(bg, "probe_backend", lambda **k: pytest.fail("probed"))
    snap = bg.ensure_backend(policy, device=device)
    assert snap["backend"] == "cpu" and snap["probe_attempts"] == 0
    assert snap["failover"] is None
    from photon_tpu_torch.cli.params import stamp_failover

    assert stamp_failover({}) == {}


def test_initialized_process_skips_the_child(monkeypatch):
    monkeypatch.setattr(bg, "_cuda_initialized", lambda: True)
    monkeypatch.setattr(bg, "probe_backend", lambda **k: pytest.fail("probed"))
    assert bg.ensure_backend("strict")["backend"] == "cuda"
    monkeypatch.setattr(bg, "_cuda_initialized", lambda: False)
    monkeypatch.setenv("PHOTON_BACKEND_PROBE", "0")
    assert bg.ensure_backend("strict")["backend"] == "cuda"


def test_unknown_policy_rejected():
    with pytest.raises(ValueError, match="unknown backend policy"):
        bg.ensure_backend("yolo")


# --------------------------------------------------------- in-run recovery


def test_recover_releases_caches_and_counts():
    from photon_tpu_torch.data.device_cache import DeviceSweepCache

    cache = DeviceSweepCache(budget_bytes=1 << 20)
    cache.get_or_put(("k", 1), 64, lambda: torch.zeros(16))
    assert cache.resident_bytes == 64
    c = REGISTRY.counter("run_restarts_total")
    before = c.value(cause="device_lost")
    out = bg.recover_from_device_loss("test")
    assert out["caches_released"] >= 1 and cache.resident_bytes == 0
    assert c.value(cause="device_lost") == before + 1


def test_poisoned_context_raises(monkeypatch):
    monkeypatch.setattr(bg, "context_usable", lambda: False)
    with pytest.raises(bg.DeviceContextLost) as ei:
        bg.recover_from_device_loss("test")
    assert bg.classify_backend_error(ei.value) == "device_lost"
