"""Replicated serving tier (docs/serving.md §"Replication").

A copy of the JAX package's ``replication/__init__.py`` (it imports
neither torch nor JAX); ``tests/test_torch_replication.py`` compares the
code, so edit both or neither.

Upstream photon-ml stops at offline batch scoring (``GameScoringDriver``
writes scored Avro — PAPER.md §0); our serving path so far is ONE
``ThreadingHTTPServer`` box fed point-to-point by the online trainer's
``POST /admin/patch``. This package goes horizontal:

* **log** — the durable delta log: the online trainer's publisher writes
  each :class:`~photon_tpu_torch.online.delta.ModelDelta` ONCE as an append-only,
  seq-numbered JSONL record (same whole-line O_APPEND contract as the
  event log), and N replicas tail it independently. Torn-tail-safe reader,
  atomic per-replica cursors, snapshot markers for the catch-up path.
* **tailer** — :class:`ReplicaTailer`: a serving replica's consume loop.
  Applies each log record exactly once through the existing
  ``ModelRegistry.apply_delta`` path (dense-seq cursor proves it), exposes
  its seq watermark + lag for ``/healthz``, and when its lag exceeds the
  catch-up threshold swaps to the latest full-snapshot marker through the
  registry's ``prepare_standby``/``swap`` machinery instead of replaying
  the whole backlog.
* **router** — :class:`RouterServer`: the staleness- and pressure-aware
  front door. Health-checks replicas, weights ``/score`` traffic by seq
  lag, drains replicas reporting ``degraded`` or memory pressure, retries
  idempotent reads on a second replica on connect failure, and forwards
  ``X-Photon-Trace-Id`` so a routed request renders as one cross-process
  flow in the merged fleet timeline.

Deployment shape: ``cli/online_training_driver --delta-log`` produces,
``cli/serving_driver --delta-log`` replicas consume, and
``cli/router_driver`` fronts them; ``scripts/replica_smoke.py`` drills the
whole topology (kill/rejoin, exactly-once audit, zero routed errors).
"""
from photon_tpu_torch.replication.log import (
    DeltaLogError,
    DeltaLogPublisher,
    DeltaLogRecord,
    DeltaLogWriter,
    FanoutPublisher,
    ReplicaCursor,
    iter_log,
    log_next_seq,
    pending_records,
)
from photon_tpu_torch.replication.router import RouterServer
from photon_tpu_torch.replication.tailer import ReplicaTailer

__all__ = [
    "DeltaLogError",
    "DeltaLogPublisher",
    "DeltaLogRecord",
    "DeltaLogWriter",
    "FanoutPublisher",
    "ReplicaCursor",
    "ReplicaTailer",
    "RouterServer",
    "iter_log",
    "log_next_seq",
    "pending_records",
]
