"""Multi-process bring-up, host file shards and process-local batches.

Port of the static half of ``photon_tpu/parallel/distributed.py`` (its
lines 1-290): ``torch.distributed`` in place of ``jax.distributed``. One
process per host (or per card); the mesh's outer ``dcn`` axis is the
process group (:func:`multihost_mesh`), each process streams only its own
input files (:func:`process_file_shard`) and assembles its own rows
(:func:`global_batch_from_local`); the fixed effect's fold gathers each
process's partial and sums them in rank order on every rank
(``parallel/mesh.fold``).

Bring-up (:func:`initialize_distributed`) reads torchrun's environment
(``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``), the
counterpart of the TPU pod's auto-detection; a single process is a no-op.
A failed bring-up is never silent: under ``strict`` it raises
:class:`DistributedInitError` (the drivers print ``fatal [<cause>]`` and
exit 2); under ``degrade`` it is journaled (``distributed_init_failed``),
counted (``distributed_init_failed_total{cause}``) and the run goes on
single-host. The backend is NCCL between cards and gloo on the CPU (NCCL
refuses two ranks on one card; pass ``backend="gloo"`` there).

Not here: the elastic mesh (``MeshMembership``, the JAX module's lines
298-791) and ``parallel/elastic.py`` come with the elastic slice.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

from photon_tpu_torch.runtime.backend_guard import BackendUnusable

__all__ = [
    "DistributedInitError",
    "HostLostError",
    "assign_file_shards",
    "global_batch_from_local",
    "initialize_distributed",
    "multihost_mesh",
    "process_file_shard",
    "process_index",
    "process_count",
    "resolve_distributed_policy",
]

_initialized = False

DISTRIBUTED_POLICIES = ("strict", "degrade")
POLICY_ENV = "PHOTON_DISTRIBUTED_POLICY"
# Seconds a process waits for the group to form before bring-up fails.
TIMEOUT_ENV = "PHOTON_DISTRIBUTED_INIT_TIMEOUT_S"


def resolve_distributed_policy(policy: Optional[str] = None) -> str:
    """'strict' | 'degrade' from the arg, else $PHOTON_DISTRIBUTED_POLICY,
    else strict (never silently train a different topology than asked)."""
    pol = (policy or os.environ.get(POLICY_ENV) or "strict").strip().lower()
    if pol not in DISTRIBUTED_POLICIES:
        raise ValueError(
            f"distributed policy must be one of {DISTRIBUTED_POLICIES}, "
            f"got {pol!r}"
        )
    return pol


class DistributedInitError(BackendUnusable):
    """Bring-up failed under --distributed-policy strict. A
    ``BackendUnusable``, so ``cli.params.console_main`` prints the
    classified one-liner ``fatal [<cause>]: ...`` and exits 2: a worker
    that cannot join the group never trains alone as if it were the
    fleet."""


class HostLostError(RuntimeError):
    """A peer process of the mesh died or a collective timed out waiting
    for it. The message matches ``backend_guard.classify_backend_error`` →
    ``host_lost``."""

    def __init__(self, dead: Sequence[int], detail: str = ""):
        self.dead = sorted(int(d) for d in dead)
        msg = f"peer host lost: missed beacon from host(s) {self.dead}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


def _group_up() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    import torch.distributed as dist

    return dist.get_rank() if _group_up() else 0


def process_count() -> int:
    """The group's size (1 without a process group)."""
    import torch.distributed as dist

    return dist.get_world_size() if _group_up() else 1


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    policy: Optional[str] = None,
    journal=None,
    logger=None,
) -> bool:
    """Join the process group; True iff this call formed it.

    With no arguments the environment decides: torchrun's ``WORLD_SIZE``
    above 1 (with ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK``) joins, else
    the call is a no-op. ``coordinator_address`` is ``host:port``.
    ``backend`` defaults to NCCL where a card is visible, else gloo. The
    wait for the other processes is bounded by
    ``PHOTON_DISTRIBUTED_INIT_TIMEOUT_S`` (default 300). A group already
    formed in this process is left as it is (False)."""
    global _initialized
    if _initialized or _group_up():
        return False
    env = os.environ
    if coordinator_address is None and num_processes is None:
        try:
            world = int(env.get("WORLD_SIZE", "1"))
        except ValueError:
            world = 1
        if world <= 1:
            return False
        num_processes = world
        process_id = int(env.get("RANK", "0"))
        coordinator_address = (f"{env.get('MASTER_ADDR', '127.0.0.1')}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    import datetime
    import logging

    import torch
    import torch.distributed as dist

    log = logger or logging.getLogger("photon_tpu_torch.parallel")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    timeout = float(env.get(TIMEOUT_ENV, "300"))
    try:
        dist.init_process_group(
            backend=backend,
            init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes),
            rank=int(process_id or 0),
            timeout=datetime.timedelta(seconds=timeout),
        )
    except Exception as e:  # noqa: BLE001 - every failure takes the policy path
        return _init_failed(e, policy, journal, log)
    _initialized = True
    return True


def _init_failed(e, policy, journal, log) -> bool:
    from photon_tpu_torch.obs import trace as _trace
    from photon_tpu_torch.obs.metrics import REGISTRY
    from photon_tpu_torch.runtime.backend_guard import classify_backend_error

    cause = classify_backend_error(e)
    pol = resolve_distributed_policy(policy)
    reason = (
        f"torch.distributed bring-up failed ({type(e).__name__}: {e}) — "
        f"policy={pol}"
    )
    REGISTRY.counter(
        "distributed_init_failed_total",
        "torch.distributed.init_process_group failures by classified cause",
    ).inc(cause=cause, policy=pol)
    _trace.instant("distributed_init_failed", cat="warning",
                   cause=cause, policy=pol)
    if journal is not None:
        journal.record("distributed_init_failed", cause=cause, policy=pol,
                       error=str(e)[:500])
    if pol == "strict":
        raise DistributedInitError(cause, reason) from e
    log.error(
        "DEGRADED to single-host: %s — this worker now trains alone on its "
        "file shard only (journaled distributed_init_failed)", reason,
    )
    return False


def shutdown_distributed() -> None:
    """Leave the process group this module formed (a no-op otherwise)."""
    global _initialized
    if _initialized and _group_up():
        import torch.distributed as dist

        dist.destroy_process_group()
    _initialized = False


def process_file_shard(files: Optional[Sequence] = None):
    """This process's input-file shard.

    Without arguments: ``(process_index, process_count)``, usable as
    ``StreamingAvroReader.iter_chunks(..., file_shard=...)``. With
    ``files`` (the ordered global list): the sublist this process owns
    under :func:`assign_file_shards` (possibly empty; an empty-shard
    process still joins every collective)."""
    if files is None:
        return process_index(), process_count()
    shards = assign_file_shards(files, range(process_count()))
    return shards[process_index()]


def assign_file_shards(files: Sequence, members: Sequence[int]) -> dict:
    """Deterministic round-robin file→host assignment: {host: [files]}.

    Every file lands on exactly one host; every member gets a key (possibly
    an empty list). The assignment depends only on (file order, sorted
    member set), so every host computes the same map locally."""
    hosts = sorted(set(int(m) for m in members))
    if not hosts:
        raise ValueError("assign_file_shards: no members")
    out: dict = {h: [] for h in hosts}
    for i, f in enumerate(files):
        out[hosts[i % len(hosts)]].append(f)
    return out


def multihost_mesh(axis_sizes: Optional[dict] = None, devices=None):
    """The ``("dcn", "data")`` mesh over the process group: the outer
    ``dcn`` axis has one entry per process, the inner axes this process's
    ``devices`` (default its visible cards). Pass ``data_axis=("dcn",
    "data")`` to shard rows over every process's shards. In a single
    process this is a plain local mesh."""
    import numpy as np

    from photon_tpu_torch.parallel.mesh import DCN_AXIS, Mesh, make_mesh

    local = make_mesh(axis_sizes, devices=devices)
    n = process_count()
    if n <= 1:
        return local
    return Mesh(devices=local.devices[np.newaxis],
                axis_names=(DCN_AXIS,) + local.axis_names,
                process_axis=DCN_AXIS, processes=n, rank=process_index())


def global_batch_from_local(batch, mesh, axis=None, *, layouts: str = "all"):
    """This process's rows (read through its file shard) as its shards of
    the global batch: the global rows are the processes' rows in rank
    order, cut into the mesh's row blocks over ``axis`` (default
    ``("dcn", "data")`` on a process-spanning mesh, else ``data``). Local
    row counts must be equal across processes and divide the local shard
    count (pad the tail with ``mesh.pad_rows_to_multiple``, as the
    reference pads partitions). Single-process this is ``shard_rows``."""
    from photon_tpu_torch.parallel.mesh import (
        DATA_AXIS,
        DCN_AXIS,
        shard_devices,
        shard_rows,
        spans_processes,
    )

    if axis is None:
        axis = ((DCN_AXIS, DATA_AXIS) if mesh.process_axis is not None
                else DATA_AXIS)
    n_local = batch.n_rows
    first = 0
    if spans_processes(mesh, axis):
        first = mesh.rank * len(shard_devices(mesh, axis))
    return shard_rows(batch, mesh, axis, layouts=layouts, first_shard=first,
                      n_rows=n_local * (mesh.processes
                                        if spans_processes(mesh, axis) else 1))
