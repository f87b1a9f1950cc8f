"""Closed-loop control plane (docs/control.md).

A copy of the JAX package's ``control/__init__.py`` (it imports neither
torch nor JAX); ``tests/test_torch_control.py`` compares the code, so edit
both or neither.

Observation (the fleet telemetry + the replicas' live HTTP surfaces) feeds a
declarative policy engine whose decisions actuate existing levers — the
standby+swap, the memory shed, the replica tailer's restart, the batcher's
reconfigure — with hysteresis, per-lever cooldowns, and budgets so the loop
provably damps. Every decision is journaled to ``control-ledger.jsonl``
under the recovery journal's row contract. Importable without torch: the control
driver runs on boxes that never load an accelerator runtime.
"""
from photon_tpu_torch.control.actions import LeverError, Levers, promote_wave
from photon_tpu_torch.control.controller import Controller, ReplicaTarget
from photon_tpu_torch.control.ledger import (
    LEDGER_FILENAME,
    ControlLedger,
    read_ledger,
)
from photon_tpu_torch.control.policy import (
    AutoscalePolicy,
    CanaryPolicy,
    ControlPolicy,
    Decision,
    PolicyEngine,
    Rule,
)

__all__ = [
    "AutoscalePolicy",
    "CanaryPolicy",
    "Controller",
    "ControlLedger",
    "ControlPolicy",
    "Decision",
    "LEDGER_FILENAME",
    "LeverError",
    "Levers",
    "PolicyEngine",
    "ReplicaTarget",
    "Rule",
    "promote_wave",
    "read_ledger",
]
