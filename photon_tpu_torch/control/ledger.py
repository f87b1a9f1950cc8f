"""Journaled control decisions — ``control-ledger.jsonl`` (docs/control.md).

A copy of the JAX package's ``control/ledger.py`` (it imports neither
torch nor JAX); ``tests/test_torch_control.py`` compares the code, so edit
both or neither.

The control plane's whole value is auditability: a loop that silently
actuates levers is indistinguishable from flakiness. Every decision the
controller takes — observation, the rule that matched, the action fired,
and the action's outcome — lands as one row here, under the SAME row
contract as the supervisor's :class:`~photon_tpu_torch.supervisor.RecoveryJournal`
(the fleet journal contract): ``{"time": <ISO-8601 UTC>, "t": <sub-second wall stamp>,
"event": <name>, "pid": ..., **fields}``, one unbuffered whole-line
O_APPEND write per row, mirrored as a ``control.<event>`` trace instant so
the chaos drill's ledger and timeline tell one story. The shared contract
is what lets ``obs/fleet.merge_journals`` interleave control rows with
recovery rows causally and the fleet report render a "## Control" section
without a second parser.

Event vocabulary (the closed set the report counts; see docs/control.md):

=============================  =========================================
event                          meaning
=============================  =========================================
``controller_started``         loop came up (policy digest in fields)
``controller_stopped``         loop exited (ticks, actions totals)
``observation``                one tick's per-target signal snapshot
                               (only journaled when a rule fired or
                               ``verbose`` — observations are high-rate)
``rule_fired``                 a policy rule's predicate latched
``action``                     a lever actuated (action, target, params)
``action_outcome``             the lever's reply (ok/error + detail)
``action_suppressed``          predicate held but cooldown/budget vetoed
``budget_exhausted``           a rule ran out of budget (journaled once)
``canary_soak_begin``          new canary wave entered soak
``canary_probe``               one soak drift probe (drift, latencies)
``canary_promote``             wave promoted into the main delta log
``canary_rollback``            wave rejected; canary reset to base
``canary_resync``              canary re-fed the promoted mainline state
=============================  =========================================
"""
from __future__ import annotations

import json
import os
import time
from typing import Iterator, Optional

__all__ = ["ControlLedger", "LEDGER_FILENAME", "read_ledger"]

# fleet.discover keys on this name (family: control_ledgers); keep the
# two in sync or the report loses the Control section.
LEDGER_FILENAME = "control-ledger.jsonl"


class ControlLedger:
    """Append-only JSONL record of control-plane decisions.

    Mirrors :class:`photon_tpu_torch.supervisor.RecoveryJournal` byte-for-byte in
    row shape (``time``/``t``/``event``/``pid``) because the fleet journal
    merger and the report's ledger counters are shared between the two —
    the control plane buys its observability by speaking the existing
    contract, not by inventing one. Writes are best-effort: the ledger is
    evidence, never a new failure mode."""

    def __init__(self, path: str):
        self.path = path

    def record(self, event: str, _mirror: bool = True, **fields) -> None:
        """Append one row; ``_mirror=False`` skips the trace instant for
        events whose canonical timeline instant is emitted elsewhere."""
        from photon_tpu_torch.obs import instant
        from photon_tpu_torch.utils import write_metrics_jsonl

        row = {
            "time": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            # Sub-second stamp: merge_journals orders control rows against
            # recovery rows from other processes; the ISO second alone
            # cannot sequence an action against the restart it requested.
            "t": round(time.time(), 6),
            "event": event,
            "pid": os.getpid(),
            **fields,
        }
        try:
            write_metrics_jsonl(self.path, [row])
        except OSError:
            pass  # evidence, never a failure mode
        if _mirror:
            instant(f"control.{event}", cat="control", **fields)

    def rows(self) -> list[dict]:
        """All rows currently on disk (tests / smoke audits)."""
        return list(read_ledger(self.path))


def read_ledger(path: str) -> Iterator[dict]:
    """Yield ledger rows; tolerates a torn trailing line (a reader racing
    the writer sees whole lines only, but a crashed writer may leave one)."""
    try:
        f = open(path, "r", encoding="utf-8")
    except OSError:
        return
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                continue
