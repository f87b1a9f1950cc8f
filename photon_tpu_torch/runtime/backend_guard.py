"""Fail-fast backend health probe, error classification, failure policy.

Port of ``photon_tpu/runtime/backend_guard.py`` for CUDA. Three pieces:

* :func:`probe_backend`: a CUDA bring-up in a SUBPROCESS under a hard
  deadline (``PHOTON_BACKEND_INIT_TIMEOUT_S``, default 120 s). The child
  runs ``torch.cuda.init()``, one small op on the card, and prints the
  device's name. A wedged driver blocks in C++, where no in-process
  timeout reaches, so the probe is a child the parent can kill: SIGTERM
  first, SIGKILL as the backstop. A process that sees no CUDA device at all
  fails without a child.
* :func:`classify_backend_error`: maps a failure onto the causes the
  recovery layers act on: ``init_unavailable``, ``compile_error`` (a kernel
  build), ``device_lost`` (the one cause recovered in-run), ``oom`` (the
  degradation ladder, ``runtime/memory_guard``) and ``host_lost``. Types
  outrank text; CUDA's own texts join the JAX package's patterns in the
  same classes. Everything else is ``unknown``, never guessed.
* :func:`ensure_backend`: the ``--backend-policy`` contract of the drivers.

  ========== ==============================================================
  policy     on a failed probe
  ========== ==============================================================
  strict     raise :class:`BackendUnusable` (classified cause; the driver
             exits 2 with one line) — the default: never train on other
             hardware than asked
  failover   go on on the CPU, the swap stamped into :func:`guard_snapshot`
             (the drivers write ``backend: cpu`` into their summaries), a
             warning logged and ``backend_failovers_total`` counted
  cpu-only   ``--device cpu`` under another name: no probe, the CPU
  ========== ==============================================================

  A run asked onto the CPU probes nothing either, and a process whose CUDA
  context is already up skips the probe (it proves nothing more).

In-run recovery from a device loss (:func:`recover_from_device_loss`) is
the step ``game/descent.py`` and ``optim/out_of_core.py`` take after they
checkpoint. Unlike a JAX client, a CUDA context cannot be re-created in the
process: after a sticky error (an illegal address, a launch failure, an ECC
error) every later call fails. So the recovery proves the context with a
tiny op first; when it fails, :class:`DeviceContextLost` ends the attempt
with the ``device_lost`` cause, the supervisor does not restart in-process,
and the scheduler's restart resumes from the checkpoint the caller saved.
An injected :class:`~photon_tpu_torch.faults.DeviceLostError` leaves the
context intact and recovers in-run, as in the JAX package. The chip-claim
lock of the JAX module is TPU tooling and is not ported.
"""
from __future__ import annotations

import dataclasses
import os
import re
import time
from typing import Optional

__all__ = [
    "BACKEND_POLICIES",
    "CAUSE_INIT_UNAVAILABLE",
    "CAUSE_COMPILE_ERROR",
    "CAUSE_DEVICE_LOST",
    "CAUSE_HOST_LOST",
    "CAUSE_OOM",
    "CAUSE_UNKNOWN",
    "BackendProbeResult",
    "BackendUnusable",
    "DeviceContextLost",
    "backend_init_timeout_s",
    "classify_backend_error",
    "context_usable",
    "ensure_backend",
    "guard_snapshot",
    "is_device_lost",
    "max_inrun_recoveries",
    "probe_backend",
    "record_failover",
    "recover_from_device_loss",
    "reset_guard",
]

BACKEND_POLICIES = ("strict", "failover", "cpu-only")

CAUSE_INIT_UNAVAILABLE = "init_unavailable"
CAUSE_COMPILE_ERROR = "compile_error"
CAUSE_DEVICE_LOST = "device_lost"
CAUSE_HOST_LOST = "host_lost"
CAUSE_OOM = "oom"
CAUSE_UNKNOWN = "unknown"


def backend_init_timeout_s(default: float = 120.0) -> float:
    """Hard deadline of the probe (``PHOTON_BACKEND_INIT_TIMEOUT_S``).
    Malformed or non-positive values fall back to ``default``: a typo
    degrades the deadline, never disables it."""
    try:
        v = float(os.environ.get("PHOTON_BACKEND_INIT_TIMEOUT_S", default))
    except (TypeError, ValueError):
        return float(default)
    return v if v > 0 else float(default)


def max_inrun_recoveries(default: int = 2) -> int:
    """Bound on in-run device-loss recoveries per scope
    (``PHOTON_DEVICE_LOST_MAX_RECOVERIES``); past it the error escalates to
    the :class:`~photon_tpu_torch.supervisor.RunSupervisor`."""
    try:
        return max(0, int(os.environ.get(
            "PHOTON_DEVICE_LOST_MAX_RECOVERIES", default)))
    except (TypeError, ValueError):
        return int(default)


# Ordered classification: the FIRST match wins, so the order is part of the
# contract (the JAX package's order; CUDA's texts added to each class).
_CAUSE_PATTERNS: tuple = (
    (CAUSE_HOST_LOST, re.compile(
        r"peer host|host\W{0,3}(was\s+)?lost|missed beacon"
        r"|beacon.{0,30}stale|mesh barrier.{0,30}(timed? ?out|timeout)"
        r"|collective.{0,40}waiting for host",
        re.IGNORECASE)),
    (CAUSE_OOM, re.compile(
        r"RESOURCE_EXHAUSTED|out of memory|\bOOM\b|hbm.{0,20}exhausted"
        r"|cudaErrorMemoryAllocation|CUBLAS_STATUS_ALLOC_FAILED"
        r"|CUSOLVER_STATUS_ALLOC_FAILED|CUSPARSE_STATUS_ALLOC_FAILED",
        re.IGNORECASE)),
    (CAUSE_DEVICE_LOST, re.compile(
        r"device\W{0,3}(was\s+)?lost|DEVICE_LOST|device is in an invalid"
        r"|socket closed|connection reset|broken pipe.{0,40}device"
        r"|tunnel.{0,30}(closed|dropped|reset)"
        r"|illegal memory access|illegal address|unspecified launch failure"
        r"|uncorrectable ECC|ECC error|fallen off the bus"
        r"|launch timed out and was terminated|cudaErrorIllegalAddress"
        r"|cudaErrorLaunchFailure|cudaErrorECCUncorrectable"
        r"|CUDA context unusable",
        re.IGNORECASE)),
    (CAUSE_INIT_UNAVAILABLE, re.compile(
        r"UNAVAILABLE|[Uu]nable to initialize backend"
        r"|[Ff]ailed to initialize|[Nn]o visible device"
        r"|backend init.{0,30}(timed? ?out|deadline)"
        r"|probe hung|wedged device grant"
        r"|no CUDA-capable device|[Nn]o CUDA device|cudaErrorNoDevice"
        r"|CUDA driver version is insufficient|cudaErrorInsufficientDriver"
        r"|CUDA driver initialization failed|cudaErrorInitializationError"
        r"|busy or unavailable|[Nn]ot compiled with CUDA enabled",
    )),
    (CAUSE_COMPILE_ERROR, re.compile(
        r"XlaCompile|compilation (error|failure|failed)"
        r"|compile (error|failed)|lowering (error|failed)|Mosaic failed"
        r"|nvcc failed|ptxas (error|fatal)",
        re.IGNORECASE)),
)


def classify_backend_error(err) -> str:
    """One of the cause constants for an exception (or message text).

    Exception types outrank message text: an injected
    :class:`~photon_tpu_torch.faults.DeviceLostError`, a
    ``torch.cuda.OutOfMemoryError`` or a ``MemoryError`` classifies by what
    it is, not what it says; a plain ``OSError`` / ``ConnectionError`` is
    never a device loss, whatever its text (it takes the I/O retry and the
    supervisor's path)."""
    text = err if isinstance(err, str) else f"{type(err).__name__}: {err}"
    if not isinstance(err, str):
        from photon_tpu_torch.faults import DeviceLostError, DeviceOomError

        if isinstance(err, DeviceLostError):
            return CAUSE_DEVICE_LOST
        if isinstance(err, (MemoryError, DeviceOomError)):
            return CAUSE_OOM
        import torch

        torch_oom = getattr(torch, "OutOfMemoryError", None)
        if torch_oom is not None and isinstance(err, torch_oom):
            return CAUSE_OOM
        if isinstance(err, (OSError, ConnectionError)):
            return CAUSE_UNKNOWN
    for cause, pattern in _CAUSE_PATTERNS:
        if pattern.search(text):
            return cause
    return CAUSE_UNKNOWN


def is_device_lost(err) -> bool:
    """Is this the one cause the in-run recovery may absorb?"""
    return classify_backend_error(err) == CAUSE_DEVICE_LOST


class BackendUnusable(RuntimeError):
    """The backend failed its probe under ``--backend-policy strict``: the
    classified ``cause`` and the probe's ``reason``."""

    def __init__(self, cause: str, reason: str):
        self.cause = cause
        self.reason = reason
        super().__init__(f"backend unusable [{cause}]: {reason}")


class DeviceContextLost(RuntimeError):
    """The CUDA context failed the tiny op of a recovery: a sticky error
    poisoned it, and only a new process can use the card again. Classifies
    ``device_lost`` by its text."""


@dataclasses.dataclass(frozen=True)
class BackendProbeResult:
    """Outcome of one (possibly multi-attempt) probe."""

    ok: bool
    backend: str             # "cuda" when the child brought the card up
    seconds: float           # wall time of the LAST attempt
    attempts: int
    cause: Optional[str] = None
    reason: Optional[str] = None
    device_name: Optional[str] = None

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        return {k: v for k, v in out.items() if v is not None}


_PROBE_MARK = "PHOTON_BACKEND="
_DEVICE_MARK = "PHOTON_DEVICE="
_DEFAULT_PROBE_CODE = (
    "import torch; torch.cuda.init(); "
    "x = torch.ones(8, device='cuda'); "
    "assert float(x.sum()) == 8.0; "
    f"print('{_DEVICE_MARK}' + torch.cuda.get_device_name(0)); "
    f"print('{_PROBE_MARK}cuda', flush=True)"
)


def _probe_once(code: str, timeout_s: float) -> BackendProbeResult:
    import subprocess
    import sys

    t0 = time.monotonic()
    p = subprocess.Popen(
        [sys.executable, "-c", code],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        out, err = p.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        p.terminate()
        try:
            p.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
        return BackendProbeResult(
            ok=False, backend="", seconds=time.monotonic() - t0, attempts=1,
            cause=CAUSE_INIT_UNAVAILABLE,
            reason=(f"backend init timed out after {timeout_s:.0f}s "
                    "deadline (wedged driver?) — probe child killed"),
        )
    took = time.monotonic() - t0
    backend, name = "", None
    for line in (out or "").splitlines():
        if line.startswith(_PROBE_MARK):
            backend = line[len(_PROBE_MARK):].strip()
        elif line.startswith(_DEVICE_MARK):
            name = line[len(_DEVICE_MARK):].strip()
    if p.returncode == 0 and backend:
        return BackendProbeResult(ok=True, backend=backend, seconds=took,
                                  attempts=1, device_name=name)
    tail = (err or out or "").strip()[-400:]
    reason = f"probe exited {p.returncode}: {tail}" if tail else (
        f"probe exited {p.returncode} with no output")
    return BackendProbeResult(
        ok=False, backend=backend, seconds=took, attempts=1,
        cause=classify_backend_error(tail or reason), reason=reason,
    )


def probe_backend(
    timeout_s: Optional[float] = None,
    attempts: Optional[int] = None,
    probe_code: Optional[str] = None,
) -> BackendProbeResult:
    """The card's health check in a child process under a hard deadline.

    ``probe_code`` is the test seam: a child that hangs or prints a canned
    failure runs the deadline kill and the classification without a card.
    ``attempts`` (``PHOTON_BACKEND_PROBE_ATTEMPTS``, default 1) retries the
    probe. A real probe (no ``probe_code``) in a process that sees no CUDA
    device fails at once, classified, without a child."""
    deadline = backend_init_timeout_s() if timeout_s is None else timeout_s
    if attempts is None:
        try:
            attempts = max(1, int(os.environ.get(
                "PHOTON_BACKEND_PROBE_ATTEMPTS", "1")))
        except (TypeError, ValueError):
            attempts = 1
    if probe_code is None:
        import torch

        if not torch.cuda.is_available():
            return BackendProbeResult(
                ok=False, backend="", seconds=0.0, attempts=0,
                cause=CAUSE_INIT_UNAVAILABLE,
                reason="no CUDA device is available "
                       "(torch.cuda.is_available() is false)")
    code = probe_code or _DEFAULT_PROBE_CODE
    last = None
    for i in range(attempts):
        last = _probe_once(code, deadline)
        if last.ok:
            return dataclasses.replace(last, attempts=i + 1)
    return dataclasses.replace(last, attempts=attempts)


# ------------------------------------------------------------- guard state
#
# One guard decision per process; the drivers stamp the snapshot into their
# summaries.

_STATE: Optional[dict] = None
_PROBED_OK = False


def guard_snapshot() -> Optional[dict]:
    """The guard's decision for provenance, or None when no guard ran:
    ``{policy, backend, backend_init_seconds, probe_attempts, failover}``
    (and ``device_name`` when a probe read it)."""
    return None if _STATE is None else dict(_STATE)


def reset_guard() -> None:
    """Test hook: forget the process's guard decision and probe memo."""
    global _STATE, _PROBED_OK
    _STATE = None
    _PROBED_OK = False


def _cuda_initialized() -> bool:
    """True when THIS process already has a CUDA context: a child's probe
    then proves nothing more."""
    import torch

    return bool(torch.cuda.is_initialized())


def _snapshot(policy: str, backend, seconds: float = 0.0, attempts: int = 0,
              failover=None, device_name=None) -> dict:
    global _STATE
    _STATE = {"policy": policy, "backend": backend,
              "backend_init_seconds": round(seconds, 3),
              "probe_attempts": attempts, "failover": failover}
    if device_name is not None:
        _STATE["device_name"] = device_name
    return dict(_STATE)


def ensure_backend(
    policy: str = "strict",
    timeout_s: Optional[float] = None,
    logger=None,
    probe_code: Optional[str] = None,
    device: str = "cuda",
) -> dict:
    """Enforce the backend policy before the process touches the card.

    Returns the guard snapshot (kept module-global for provenance): its
    ``backend`` is where the run goes, ``"cuda"`` or ``"cpu"``. ``device``
    is where the caller was asked to run: ``"cpu"`` probes nothing (the
    card is not wanted). Under ``strict`` a failed probe raises
    :class:`BackendUnusable`; under ``failover`` the run goes to the CPU
    with the swap recorded; ``cpu-only`` is the CPU, never probed."""
    global _PROBED_OK
    if policy not in BACKEND_POLICIES:
        raise ValueError(
            f"unknown backend policy {policy!r}; known: {BACKEND_POLICIES}")
    if policy == "cpu-only" or str(device).split(":")[0] == "cpu":
        return _snapshot(policy, "cpu")
    if probe_code is None and (
            _PROBED_OK or _cuda_initialized()
            or os.environ.get("PHOTON_BACKEND_PROBE") == "0"):
        prev = _STATE or {}
        return _snapshot(policy, "cuda", prev.get("backend_init_seconds", 0.0),
                         prev.get("probe_attempts", 0),
                         device_name=prev.get("device_name"))

    probe = probe_backend(timeout_s=timeout_s, probe_code=probe_code)
    if probe.ok:
        _PROBED_OK = True
        return _snapshot(policy, probe.backend, probe.seconds, probe.attempts,
                         device_name=probe.device_name)

    from photon_tpu_torch.obs import instant
    from photon_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "backend_probe_failures_total",
        "health-probe failures by classified cause (runtime/backend_guard)",
    ).inc(cause=probe.cause or CAUSE_UNKNOWN)
    instant("recovery.backend_probe_failed", cat="recovery",
            cause=probe.cause, reason=probe.reason,
            seconds=round(probe.seconds, 3), policy=policy)
    if logger is not None:
        logger.warning(
            "backend probe failed [%s] after %.1fs (attempt %d): %s",
            probe.cause, probe.seconds, probe.attempts, probe.reason)
    if policy == "strict":
        raise BackendUnusable(probe.cause or CAUSE_UNKNOWN,
                              probe.reason or "probe failed")
    return record_failover(probe, logger=logger, policy=policy)


def record_failover(
    probe: BackendProbeResult, logger=None, policy: str = "failover",
) -> dict:
    """Go on on the CPU and stamp the swap: the guard snapshot (the drivers'
    summaries then say ``backend: cpu``), ``backend_failovers_total`` and a
    ``recovery.backend_failover`` instant, so a failover run is never
    mistaken for a run on the card. Shared by :func:`ensure_backend` and
    the supervisor's between-attempts path."""
    from photon_tpu_torch.obs import instant
    from photon_tpu_torch.obs.metrics import REGISTRY

    failover = {
        "to": "cpu",
        "cause": probe.cause or CAUSE_UNKNOWN,
        "reason": probe.reason,
        "probe_seconds": round(probe.seconds, 3),
    }
    REGISTRY.counter(
        "backend_failovers_total",
        "policy-driven backend failovers by classified cause",
    ).inc(cause=failover["cause"])
    instant("recovery.backend_failover", cat="recovery", **failover)
    if logger is not None:
        logger.warning(
            "backend policy 'failover': going on on the CPU [%s] — the run's "
            "artifacts say backend=cpu (not comparable to runs on the card)",
            failover["cause"])
    return _snapshot(policy, "cpu", probe.seconds, probe.attempts,
                     failover=failover)


# --------------------------------------------------------- in-run recovery


def context_usable() -> bool:
    """True unless this process's CUDA context fails a tiny op (a process
    without a context has nothing to poison)."""
    import torch

    if not torch.cuda.is_initialized():
        return True
    try:
        x = torch.ones(1, device="cuda")
        x.add_(1)
        torch.cuda.synchronize()
        return True
    except Exception:  # noqa: BLE001 - any failure here is the answer
        return False


def recover_from_device_loss(reason: str, device_cache=None,
                             logger=None) -> dict:
    """The shared mid-run recovery step (descent, out-of-core):

    1. release the device caches (``supervisor.clear_executable_caches``:
       every live sweep cache's pins, then ``torch.cuda.empty_cache``), or
       ``device_cache`` alone when the caller owns one;
    2. prove the CUDA context with a tiny op; a poisoned one raises
       :class:`DeviceContextLost` (the caller's checkpoint stands, and the
       scheduler's restart resumes from it).

    The caller checkpoints BEFORE calling this. Emits the
    ``recovery.device_lost`` / ``recovery.backend_reinit`` instants and
    counts ``run_restarts_total{cause="device_lost"}``."""
    from photon_tpu_torch.obs import instant
    from photon_tpu_torch.obs.metrics import REGISTRY

    instant("recovery.device_lost", cat="recovery", reason=reason)
    REGISTRY.counter(
        "run_restarts_total",
        "training restarts/recoveries by classified cause",
    ).inc(cause=CAUSE_DEVICE_LOST)
    if device_cache is not None:
        device_cache.release()
    from photon_tpu_torch.supervisor import clear_executable_caches

    released = clear_executable_caches(f"device-loss recovery: {reason}")
    if not context_usable():
        raise DeviceContextLost(
            f"CUDA context unusable after a sticky error ({reason}): the "
            "device is lost to this process; restart it (a checkpoint "
            "resume fast-forwards)")
    instant("recovery.backend_reinit", cat="recovery", reason=reason,
            caches_released=released)
    if logger is not None:
        logger.warning(
            "device-loss recovery (%s): %d sweep cache(s) released, the CUDA "
            "context answers — resuming from the checkpointed state",
            reason, released)
    return {"caches_released": released}
