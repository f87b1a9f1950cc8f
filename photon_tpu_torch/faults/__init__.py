"""Deterministic fault injection and chaos helpers (port of
``photon_tpu/faults``).

``fault_point(site, **ctx)`` hooks are threaded through the streaming
ingest, checkpoints, coordinate descent, the out-of-core solver and the
random-effect solve; a seeded :class:`FaultPlan` decides which of them
misbehave. The chaos tests (``tests/test_torch_chaos.py``) drive training
under injected plans and hold the recovery contracts: bit-identical
resume, in-run recovery, bounded degradation.
"""
from photon_tpu_torch.faults.chaos import bit_flip, torn_write
from photon_tpu_torch.faults.plan import (
    DeviceLostError,
    DeviceOomError,
    FaultInjector,
    FaultPlan,
    FaultSpec,
    PreemptionError,
    active_plan,
    deactivate,
    fault_point,
    install,
    install_from_file,
)

__all__ = [
    "DeviceLostError",
    "DeviceOomError",
    "FaultInjector",
    "FaultPlan",
    "FaultSpec",
    "PreemptionError",
    "active_plan",
    "bit_flip",
    "deactivate",
    "fault_point",
    "install",
    "install_from_file",
    "torn_write",
]
