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

Elastic membership (:class:`MeshMembership`, a copy of the JAX module's
lines 291-791 with its imports renamed) is the other transport: a
shared-filesystem protocol over the supervisor's liveness beacons, with
barriers, per-part reductions and an epoch-journaled shrink and grow in
host space, so that a SIGKILLed host is classified (``host_lost``), its
file and entity shards are redistributed and the survivors resume from the
last committed step (``parallel/elastic.ElasticTrainer`` is the consumer;
drill: ``scripts/multihost_smoke_torch.py``). A ``torch.distributed`` group
cannot shrink or re-form after a peer dies, so that path uses none.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional, Sequence

from photon_tpu_torch.runtime.backend_guard import BackendUnusable

__all__ = [
    "DistributedInitError",
    "HostLostError",
    "MeshMembership",
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

# Epoch-defining ledger events (mesh-epochs.jsonl). Any row whose ``event``
# is one of these redefines (epoch, members, file assignment); everything
# else (host_lost / host_rejoined / shard_redistributed) is commentary the
# fleet report renders as the host-loss ledger.
EPOCH_EVENTS = ("mesh_formed", "mesh_shrunk", "mesh_grown")


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


# ---------------------------------------------------------------------------
# Elastic mesh membership
# ---------------------------------------------------------------------------


def _atomic_write_json(path: str, payload: dict) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


class MeshMembership:
    """Shared-filesystem elastic membership: beacons, epochs, barriers, and
    per-file partial reductions for an N-host mesh on one coordinated run.

    Design (docs/scaling.md §"Multi-host mesh"):

    * **Liveness** rides ``supervisor.Heartbeat`` beacon files in
      ``<mesh_dir>/beacons`` (atomic writes, staleness judged by shared-fs
      mtime). Every wait loop in the protocol checks beacons, so a
      SIGKILLed host converts a would-be hang into :class:`HostLostError`
      within ~3 beat intervals. Beacon ages are exported as
      ``host_beacon_age_seconds{host=...}`` gauges (the fleet report and
      the live ``/fleet`` view show dead hosts without reading journals).
    * **Epochs** live in the append-only ledger ``mesh-epochs.jsonl``
      (``supervisor.RecoveryJournal`` rows). An epoch row names (epoch,
      members, file assignment); only the coordinator — the smallest live
      host id — appends. Shrink and grow are therefore single-writer;
      everyone else adopts the newest epoch row.
    * **Barriers** are per-(epoch, name) arrival files: a host arrives by
      touching ``barriers/e<epoch>/<name>/host-<id>`` and waits for every
      member of ITS epoch, beacon-checked. Empty-shard hosts barrier like
      everyone else — membership, not data volume, defines the collective.
    * **Reductions** (:meth:`reduce_parts`) are keyed by *part id*, not by
      host: each host publishes one partial file per input part it owns and
      waits for the canonical global part set. Summing in canonical part
      order makes the reduced value bit-identical under ANY assignment of
      parts to hosts — the property that lets a shrink resume ≤1e-12 (in
      fact exactly) equal to the uninterrupted run.
    * **Shrink** (:meth:`handle_loss`): the surviving coordinator journals
      classified ``host_lost`` rows, per-shard ``shard_redistributed``
      rows, and a ``mesh_shrunk`` epoch row; survivors adopt it and redo
      the in-flight step under the new epoch (reduce/exchange namespaces
      are epoch-scoped, so a dead host's stale partials are never read).
      Bounded by the existing recovery budget
      (``backend_guard.max_inrun_recoveries``).
    * **Grow** (:meth:`maybe_grow`, coordinator, at step boundaries): a
      returning host beacons + drops a join request; the next boundary
      journals ``host_rejoined`` + redistribution rows and a ``mesh_grown``
      epoch row scaling the mesh back up.
    """

    def __init__(
        self,
        mesh_dir: str,
        host_id: int,
        n_hosts: int,
        part_ids: Sequence[str],
        *,
        beat_seconds: float = 0.4,
        stale_factor: float = 3.0,
        wait_timeout: float = 120.0,
        poll_seconds: float = 0.03,
        max_shrinks: Optional[int] = None,
        logger=None,
    ):
        import logging

        from photon_tpu_torch.runtime.backend_guard import max_inrun_recoveries
        from photon_tpu_torch.supervisor import Heartbeat, RecoveryJournal

        self.mesh_dir = mesh_dir
        self.host_id = int(host_id)
        self.expected = list(range(int(n_hosts)))
        self.part_ids = [str(p) for p in part_ids]
        self.beat_seconds = float(beat_seconds)
        self.stale_seconds = float(stale_factor) * self.beat_seconds
        self.wait_timeout = float(wait_timeout)
        self.poll_seconds = float(poll_seconds)
        self.max_shrinks = (max_inrun_recoveries()
                            if max_shrinks is None else int(max_shrinks))
        self.log = logger or logging.getLogger("photon_tpu_torch.parallel")
        os.makedirs(mesh_dir, exist_ok=True)
        self.ledger_path = os.path.join(mesh_dir, "mesh-epochs.jsonl")
        self.journal = RecoveryJournal(self.ledger_path)
        self.hb = Heartbeat(
            os.path.join(mesh_dir, "beacons"),
            process_id=self.host_id,
            interval_seconds=self.beat_seconds,
            memory_guard=None,
            peer_gauges=self.expected,
        )
        self.epoch = -1
        self.members: list[int] = []
        self.files: dict[int, list[str]] = {}
        self.shrinks = 0
        self.rejoined = False  # True when this host joined via request_join

    # -- ledger ------------------------------------------------------------

    def _read_ledger(self) -> list[dict]:
        rows = []
        try:
            with open(self.ledger_path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rows.append(json.loads(line))
                    except ValueError:
                        continue  # torn tail mid-append; next poll sees it
        except OSError:
            pass
        return rows

    def _newest_epoch_row(self) -> Optional[dict]:
        newest = None
        for row in self._read_ledger():
            if row.get("event") in EPOCH_EVENTS:
                newest = row
        return newest

    def _adopt(self, row: dict) -> None:
        self.epoch = int(row["epoch"])
        self.members = [int(m) for m in row["members"]]
        self.files = {int(h): list(fs)
                      for h, fs in (row.get("files") or {}).items()}

    def _write_epoch(self, event: str, members: Sequence[int],
                     **fields) -> dict:
        members = sorted(int(m) for m in members)
        files = assign_file_shards(self.part_ids, members)
        row = dict(event=event, epoch=self.epoch + 1, members=members,
                   files={str(h): fs for h, fs in files.items()}, **fields)
        self.journal.record(**row)
        self._adopt(row)
        return row

    def _journal_redistribution(self, old_files: dict, new_files: dict,
                                old_members: Sequence[int]) -> None:
        """One ``shard_redistributed`` row per host whose file shard
        changed, plus one for the entity re-hash (ownership is
        ``entity % len(members)``, so ANY membership change remaps it)."""
        for h, fs in new_files.items():
            gained = [f for f in fs if f not in (old_files.get(h) or [])]
            if gained:
                self.journal.record(
                    "shard_redistributed", kind="files", host=h,
                    n_items=len(gained), items=gained[:32],
                )
        self.journal.record(
            "shard_redistributed", kind="entities",
            members_before=sorted(old_members),
            members_after=sorted(self.members),
        )

    # -- liveness ----------------------------------------------------------

    def beacon_ages(self, hosts: Optional[Sequence[int]] = None) -> dict:
        """host → seconds since its last beacon (-1: no beacon file),
        judged against our own beacon's mtime (shared-fs clock)."""
        hosts = list(self.expected if hosts is None else hosts)
        try:
            now = os.path.getmtime(self.hb._path(self.host_id))
        except OSError:
            now = time.time()
        out = {}
        for h in hosts:
            try:
                out[h] = max(0.0, now - os.path.getmtime(self.hb._path(h)))
            except OSError:
                out[h] = -1.0
        return out

    def _check_members(self, detail: str) -> None:
        """Raise :class:`HostLostError` if any CURRENT member's beacon is
        stale or missing (self excluded — we are demonstrably alive)."""
        peers = [m for m in self.members if m != self.host_id]
        if not peers:
            return
        report = self.hb.check_peers(peers, max_age_seconds=self.stale_seconds)
        dead = sorted(report.dead + report.missing)
        if dead:
            raise HostLostError(dead, detail)

    # -- lifecycle ---------------------------------------------------------

    @property
    def coordinator(self) -> int:
        return min(self.members) if self.members else min(self.expected)

    @property
    def is_coordinator(self) -> bool:
        return self.host_id == self.coordinator

    def my_files(self) -> list[str]:
        return list(self.files.get(self.host_id, []))

    def owner_of_entity(self, entity_id: int) -> int:
        """Deterministic entity→host hash over the CURRENT members."""
        members = sorted(self.members)
        return members[int(entity_id) % len(members)]

    def start(self, form_timeout: float = 60.0) -> "MeshMembership":
        """Beacon up and join the mesh: form it (first boot), adopt the
        current epoch, or — when the ledger shows a mesh we are not a
        member of — request a rejoin and wait for the scale-up epoch."""
        self.hb.start()
        row = self._newest_epoch_row()
        if row is None:
            if self.host_id == min(self.expected):
                self._form(form_timeout)
            else:
                self._wait_for_membership(form_timeout,
                                          "initial mesh formation")
            return self
        if self.host_id in [int(m) for m in row["members"]]:
            self._adopt(row)
            return self
        self.request_join()
        self._wait_for_membership(self.wait_timeout, "rejoin scale-up")
        self.rejoined = True
        return self

    def _form(self, timeout: float) -> None:
        """Coordinator first boot: wait for every expected beacon (or the
        deadline), then journal epoch 0. Hosts that never showed are formed
        around — journaled ``host_lost`` so the absence is never silent."""
        deadline = time.monotonic() + timeout
        while True:
            ages = self.beacon_ages(self.expected)
            live = [h for h, a in ages.items()
                    if 0.0 <= a <= self.stale_seconds]
            if len(live) == len(self.expected) or time.monotonic() > deadline:
                break
            time.sleep(self.poll_seconds)
        for h in sorted(set(self.expected) - set(live)):
            self.journal.record("host_lost", host=h, cause="host_lost",
                                phase="formation",
                                beacon_age_seconds=ages.get(h, -1.0))
        self._write_epoch("mesh_formed", live or [self.host_id])

    def _wait_for_membership(self, timeout: float, detail: str) -> None:
        deadline = time.monotonic() + timeout
        while True:
            row = self._newest_epoch_row()
            if row is not None and self.host_id in [int(m)
                                                    for m in row["members"]]:
                self._adopt(row)
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"host {self.host_id} never became a mesh member "
                    f"({detail}; ledger={self.ledger_path})"
                )
            time.sleep(self.poll_seconds * 4)

    def stop(self) -> None:
        self.hb.stop()

    # -- barriers + reductions --------------------------------------------

    def barrier(self, name: str, timeout: Optional[float] = None) -> None:
        """Arrive at the named barrier of the CURRENT epoch and wait for
        every member, beacon-checked (a dead member raises
        :class:`HostLostError` instead of hanging)."""
        d = os.path.join(self.mesh_dir, "barriers", f"e{self.epoch}", name)
        os.makedirs(d, exist_ok=True)
        mine = os.path.join(d, f"host-{self.host_id}")
        with open(mine, "w") as f:
            f.write(str(time.time()))
        deadline = time.monotonic() + (timeout or self.wait_timeout)
        while True:
            try:
                present = set(os.listdir(d))
            except OSError:
                present = set()
            missing = [m for m in self.members
                       if f"host-{m}" not in present]
            if not missing:
                return
            self._check_members(f"mesh barrier {name!r} epoch {self.epoch}")
            if time.monotonic() > deadline:
                raise HostLostError(
                    missing, f"mesh barrier timeout at {name!r} "
                             f"epoch {self.epoch}")
            time.sleep(self.poll_seconds)

    def reduce_parts(self, tag: str, payloads: dict,
                     timeout: Optional[float] = None) -> dict:
        """All-reduce keyed by canonical part id.

        ``payloads``: {part_id: {name: np.ndarray}} for the parts THIS host
        owns (possibly empty — the host still waits, i.e. participates).
        Publishes one npz per part under the CURRENT epoch's namespace and
        blocks until every part id of the canonical global list is present,
        beacon-checked. Returns {part_id: {name: np.ndarray}} for ALL
        parts; the caller folds them in canonical order so the global sum
        is independent of which host computed which part.
        """
        import numpy as np

        d = os.path.join(self.mesh_dir, "reduce", f"e{self.epoch}", tag)
        os.makedirs(d, exist_ok=True)
        for pid, arrs in payloads.items():
            path = os.path.join(d, f"part-{pid}.npz")
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                np.savez(f, **arrs)
            os.replace(tmp, path)
        want = {f"part-{pid}.npz" for pid in self.part_ids}
        deadline = time.monotonic() + (timeout or self.wait_timeout)
        while True:
            try:
                present = want & set(os.listdir(d))
            except OSError:
                present = set()
            if present == want:
                break
            self._check_members(f"reduction {tag!r} epoch {self.epoch}")
            if time.monotonic() > deadline:
                raise HostLostError(
                    sorted(m for m in self.members if m != self.host_id),
                    f"collective {tag!r} timed out waiting for host parts "
                    f"{sorted(want - present)[:8]}")
            time.sleep(self.poll_seconds)
        out = {}
        for pid in self.part_ids:
            with np.load(os.path.join(d, f"part-{pid}.npz")) as z:
                out[pid] = {k: z[k] for k in z.files}
        return out

    def exchange(self, tag: str, outbound: dict,
                 timeout: Optional[float] = None) -> dict:
        """All-to-all under the current epoch: ``outbound`` maps target
        host → {name: array} (EVERY member except self must have an entry,
        even if its arrays are empty — an empty-shard host still
        participates). Returns {source host: {name: array}} for every
        member except self."""
        import numpy as np

        d = os.path.join(self.mesh_dir, "exchange", f"e{self.epoch}", tag)
        os.makedirs(d, exist_ok=True)
        for target, arrs in outbound.items():
            path = os.path.join(d, f"from-{self.host_id}-to-{target}.npz")
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                np.savez(f, **arrs)
            os.replace(tmp, path)
        peers = [m for m in self.members if m != self.host_id]
        want = {f"from-{s}-to-{self.host_id}.npz" for s in peers}
        deadline = time.monotonic() + (timeout or self.wait_timeout)
        while want:
            try:
                present = want & set(os.listdir(d))
            except OSError:
                present = set()
            if present == want:
                break
            self._check_members(f"exchange {tag!r} epoch {self.epoch}")
            if time.monotonic() > deadline:
                raise HostLostError(peers, f"exchange {tag!r} timed out")
            time.sleep(self.poll_seconds)
        out = {}
        for s in peers:
            p = os.path.join(d, f"from-{s}-to-{self.host_id}.npz")
            with np.load(p) as z:
                out[s] = {k: z[k] for k in z.files}
        return out

    # -- shrink / grow -----------------------------------------------------

    def handle_loss(self, dead_hint: Sequence[int]) -> None:
        """Coordinated shrink after :class:`HostLostError`.

        The smallest SURVIVING host journals the classified ``host_lost``
        rows, the redistribution rows, and the ``mesh_shrunk`` epoch; every
        other survivor waits for that row and adopts it. Coordinator death
        is covered: if the writer-elect also goes stale during the wait,
        the next-smallest survivor takes over (the loop re-runs with the
        larger dead set). Budget: more than
        ``backend_guard.max_inrun_recoveries()`` shrinks in one run
        escalates to the supervisor restart path."""
        ages = self.beacon_ages(self.members)
        dead = sorted(
            {int(d) for d in dead_hint}
            | {h for h, a in ages.items()
               if h != self.host_id and (a < 0.0 or a > self.stale_seconds)}
        )
        dead = [d for d in dead if d in self.members]
        if not dead:
            return  # spurious (e.g. barrier raced a slow beacon); retry
        self.shrinks += 1
        if self.shrinks > self.max_shrinks:
            self.journal.record("recovery_budget_exhausted",
                                scope="mesh_shrink", shrinks=self.shrinks,
                                budget=self.max_shrinks)
            raise RuntimeError(
                f"mesh shrink budget exhausted ({self.shrinks} > "
                f"{self.max_shrinks}); escalating to supervisor restart"
            )
        survivors = [m for m in self.members if m not in dead]
        old_members, old_files = list(self.members), dict(self.files)
        if self.host_id == min(survivors):
            for h in dead:
                self.journal.record(
                    "host_lost", host=h, cause="host_lost",
                    epoch=self.epoch, beacon_age_seconds=ages.get(h, -1.0),
                )
            self._write_epoch("mesh_shrunk", survivors, dead=dead)
            self._journal_redistribution(
                old_files, {int(h): f for h, f in self.files.items()},
                old_members)
            self.log.warning(
                "mesh shrunk: epoch %d, lost %s, members %s",
                self.epoch, dead, self.members)
            return
        # Non-coordinator survivor: wait for the shrink row; if the elected
        # writer dies mid-shrink, re-enter with it added to the dead set.
        deadline = time.monotonic() + self.wait_timeout
        while True:
            row = self._newest_epoch_row()
            if row is not None and int(row["epoch"]) > self.epoch:
                if self.host_id in [int(m) for m in row["members"]]:
                    self._adopt(row)
                    return
            writer = min(survivors)
            age = self.beacon_ages([writer]).get(writer, -1.0)
            if age < 0.0 or age > self.stale_seconds:
                return self.handle_loss(dead + [writer])
            if time.monotonic() > deadline:
                raise HostLostError(
                    [writer], "waiting for mesh_shrunk epoch row")
            time.sleep(self.poll_seconds)

    def request_join(self) -> None:
        d = os.path.join(self.mesh_dir, "join")
        os.makedirs(d, exist_ok=True)
        _atomic_write_json(
            os.path.join(d, f"host-{self.host_id}.json"),
            {"host": self.host_id, "pid": os.getpid(), "time": time.time()},
        )

    def maybe_grow(self) -> bool:
        """Coordinator, at a step boundary: admit rejoin requests whose
        beacons are fresh. Journals ``host_rejoined`` + redistribution rows
        and the ``mesh_grown`` epoch; returns True when the mesh grew."""
        if not self.is_coordinator:
            return False
        d = os.path.join(self.mesh_dir, "join")
        try:
            reqs = [int(n[len("host-"):-len(".json")])
                    for n in os.listdir(d)
                    if n.startswith("host-") and n.endswith(".json")]
        except OSError:
            return False
        ages = self.beacon_ages(sorted(set(reqs)))
        joiners = [h for h in sorted(set(reqs))
                   if h not in self.members
                   and 0.0 <= ages.get(h, -1.0) <= self.stale_seconds]
        stale_reqs = [h for h in reqs if h in self.members]
        for h in stale_reqs:  # already members: consumed requests
            try:
                os.remove(os.path.join(d, f"host-{h}.json"))
            except OSError:
                pass
        if not joiners:
            return False
        old_members, old_files = list(self.members), dict(self.files)
        for h in joiners:
            self.journal.record("host_rejoined", host=h, epoch=self.epoch)
        self._write_epoch("mesh_grown", old_members + joiners,
                          joined=joiners)
        self._journal_redistribution(
            old_files, {int(h): f for h, f in self.files.items()},
            old_members)
        for h in joiners:
            try:
                os.remove(os.path.join(d, f"host-{h}.json"))
            except OSError:
                pass
        self.log.warning("mesh grown: epoch %d, rejoined %s, members %s",
                         self.epoch, joiners, self.members)
        return True

    def sync_epoch(self) -> bool:
        """Adopt the newest ledger epoch (non-coordinators see grow rows
        here). Returns True when (epoch, members, assignment) changed. A
        host finding itself EXCLUDED from the newest epoch (a conservative
        peer declared us dead while we were merely slow) self-heals by
        filing a rejoin request and waiting for the scale-up."""
        row = self._newest_epoch_row()
        if row is None or int(row["epoch"]) == self.epoch:
            return False
        if self.host_id not in [int(m) for m in row["members"]]:
            self.log.warning(
                "host %d evicted at epoch %s; requesting rejoin",
                self.host_id, row["epoch"])
            self.request_join()
            self._wait_for_membership(self.wait_timeout, "post-eviction")
            self.rejoined = True
            return True
        self._adopt(row)
        return True
