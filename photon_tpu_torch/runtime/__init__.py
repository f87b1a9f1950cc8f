"""Runtime services of the port: backend health, failure policy, recovery.

``backend_guard`` makes a card that fails to come up, or is lost mid-run,
a classified and tested contract: fail fast under a hard deadline, classify
the cause, recover under an explicit policy. ``memory_guard`` turns an
out-of-memory failure into a cheaper plan instead of a restart, and watches
the card's memory. The JAX package's ``compile_store`` caches compiled XLA
programs; the port compiles none (its kernels build once per source into
``photon_tpu_torch/_build/``), so it has no counterpart here.
"""
from photon_tpu_torch.runtime.backend_guard import (
    BACKEND_POLICIES,
    BackendProbeResult,
    BackendUnusable,
    DeviceContextLost,
    backend_init_timeout_s,
    classify_backend_error,
    context_usable,
    ensure_backend,
    guard_snapshot,
    is_device_lost,
    max_inrun_recoveries,
    probe_backend,
    recover_from_device_loss,
)
from photon_tpu_torch.runtime.memory_guard import (
    MemoryGuard,
    OomDownshifter,
    is_oom,
    max_oom_downshifts,
)

__all__ = [
    "MemoryGuard",
    "OomDownshifter",
    "is_oom",
    "max_oom_downshifts",
    "BACKEND_POLICIES",
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
    "recover_from_device_loss",
]
