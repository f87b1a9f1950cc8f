"""Measured cost-model routing for random-effect bucket solvers.

Port of ``photon_tpu/game/solver_routing.py`` on one device. The static
gates of ``game/newton_re.py`` say which solvers CAN run on a bucket; this
module picks the one that runs fastest, by measurement:

* Buckets are classed by shape (``S``, ``K``, ``P``, dtype; the entity count
  is left out: the table stores per-entity costs). The key also names the
  torch backend and the card (``torch/<device name>/...``), so a table of
  the JAX package and a table of the port, or of two cards, never
  cross-read.
* The first bucket of a class runs a calibration race: every feasible
  ``(solver, chunk)`` candidate solves one probe slice of the bucket at its
  chunk size. The port compiles nothing, but a candidate's first call pays
  its one-time costs (a kernel build, cuBLAS / cuSOLVER handles, lazy module
  loads), so each candidate gets one untimed warm probe, then one timed
  probe between two device synchronizations. Per-entity costs land in a
  process-wide :class:`SolverCostTable`.
* Later buckets of the class route straight to the measured winner,
  including every later sweep: the race is paid once per shape class.
* The table round-trips as JSON. ``PHOTON_RE_COST_TABLE=<path>`` (the
  drivers' ``--re-cost-table``) loads it at first use and saves it after
  every race, so a restart skips calibration and repeats the first run's
  decisions exactly (a re-run race could flip a winner).

Every candidate is chunked at a blessed ladder size
(``newton_re.chunk_ladder()``), the vmapped baseline included (capped at
``VMAPPED_CHUNK_CAP``): the lanes then run over an entity slice of the
bucket's block-diagonal layout, padded with inert lanes.

Routing mode is ``PHOTON_RE_ROUTING``: ``static`` (default, the gate ladder
of ``random_effect.plan_bucket``) or ``measured``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Callable, Optional, Sequence

from photon_tpu_torch.game import newton_re

ROUTING_ENV = "PHOTON_RE_ROUTING"
TABLE_ENV = "PHOTON_RE_COST_TABLE"

# Largest chunk the vmapped baseline races and runs at under measured
# routing (its per-entity cost is nearly flat in the chunk size).
VMAPPED_CHUNK_CAP = 4096

_MODES = ("static", "measured")


def routing_mode() -> str:
    mode = (os.environ.get(ROUTING_ENV) or "static").strip().lower()
    if mode not in _MODES:
        raise ValueError(f"{ROUTING_ENV} must be one of {_MODES}, got {mode!r}")
    return mode


def _device_tag(device) -> str:
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def shape_class(bucket, shards: int = 1) -> str:
    """Cost-table key of a bucket: backend and card, then rows per entity
    S, ELL width K, local dim P and dtype. ``shards`` (the entity axis of a
    mesh) adds a ``@devN`` suffix: a cost measured over N shards is never
    read by a run over another count."""
    _, s, k = bucket.idx.shape
    dtype = str(bucket.val.dtype).removeprefix("torch.")
    key = (f"torch/{_device_tag(bucket.val.device)}/"
           f"s{s}k{k}p{bucket.local_dim}:{dtype}")
    return key if shards <= 1 else f"{key}@dev{shards}"


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One raceable (solver, chunk-size) combination."""

    solver: str   # newton_primal | newton_dual | vmapped_lbfgs
    chunk: int

    @property
    def key(self) -> str:
        return f"{self.solver}@{self.chunk}"


class SolverCostTable:
    """Thread-safe per-(shape class, candidate) measured cost store.

    Costs are seconds per padded entity lane at the candidate's chunk size.
    ``winner`` returns the cheapest recorded candidate among the caller's
    feasible ones, or None unless every feasible candidate has a cost.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: dict = {}            # shape_key -> {cand_key: cost}

    def record(self, shape_key: str, cand: Candidate,
               seconds_per_entity: float) -> None:
        with self._lock:
            self._entries.setdefault(shape_key, {})[cand.key] = float(
                seconds_per_entity)

    def costs(self, shape_key: str) -> dict:
        with self._lock:
            return dict(self._entries.get(shape_key, {}))

    def winner(self, shape_key: str,
               feasible: Sequence[Candidate]) -> Optional[Candidate]:
        """Cheapest recorded candidate among ``feasible``, or None unless
        every feasible candidate has a recorded cost (the caller then races
        the missing ones): a table saved by a run that admitted fewer
        candidates must not pin the routing to what it happened to
        measure."""
        by_key = {c.key: c for c in feasible}
        with self._lock:
            entries = self._entries.get(shape_key)
            if not entries:
                return None
            hits = [(cost, k) for k, cost in entries.items() if k in by_key]
        if len(hits) < len(by_key):
            return None
        return by_key[min(hits)[1]]

    def to_json(self) -> dict:
        with self._lock:
            return {"version": 1,
                    "entries": {k: dict(v) for k, v in self._entries.items()}}

    def load_json(self, payload: dict) -> None:
        if payload.get("version") != 1:
            raise ValueError(
                f"unsupported cost-table version {payload.get('version')!r}")
        with self._lock:
            for k, v in payload.get("entries", {}).items():
                self._entries.setdefault(k, {}).update(
                    {ck: float(c) for ck, c in v.items()})

    def save(self, path: str) -> None:
        """Atomic write (tmp + rename): a kill mid-save leaves no torn
        table."""
        payload = self.to_json()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, path)

    def load(self, path: str) -> None:
        with open(path) as f:
            self.load_json(json.load(f))

    def merge(self, other: "SolverCostTable") -> None:
        """Fold another table in: the mean where both measured a candidate,
        the other's cost where only it did."""
        with other._lock:
            theirs = {k: dict(v) for k, v in other._entries.items()}
        with self._lock:
            for key, cands in theirs.items():
                mine = self._entries.setdefault(key, {})
                for ck, cost in cands.items():
                    mine[ck] = (0.5 * (mine[ck] + float(cost)) if ck in mine
                                else float(cost))

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()


_TABLE = SolverCostTable()
_loaded_paths: set = set()
_load_lock = threading.Lock()


def process_table() -> SolverCostTable:
    """The process-wide table, loaded once per distinct
    ``PHOTON_RE_COST_TABLE`` path."""
    path = os.environ.get(TABLE_ENV)
    if path:
        with _load_lock:
            if path not in _loaded_paths:
                _loaded_paths.add(path)
                if os.path.exists(path):
                    _TABLE.load(path)
    return _TABLE


def _persist(table: SolverCostTable) -> None:
    path = os.environ.get(TABLE_ENV)
    if path:
        table.save(path)


def reset_process_table() -> None:
    """Forget the measurements and the load history (tests)."""
    with _load_lock:
        _TABLE.reset()
        _loaded_paths.clear()


def merge_host_tables(paths, out_path: str) -> SolverCostTable:
    """Fold several saved tables into one saved table; unreadable files are
    skipped (a torn file must not poison the result)."""
    merged = SolverCostTable()
    for p in paths:
        other = SolverCostTable()
        try:
            other.load(p)
        except (OSError, ValueError, KeyError):
            continue
        merged.merge(other)
    merged.save(out_path)
    return merged


def candidates_for(problem, bucket, normalization, u_max: int,
                   shards: int = 1) -> list:
    """Feasible chunked candidates for this bucket, Newton variants first.

    The primal candidate is admitted up to ``NEWTON_CHUNK_MAX_P``, wider
    than the static gate: the race decides there. The vmapped baseline is
    raced whenever a Newton variant is. ``u_max`` < 0 means the dual
    precheck refused the bucket. ``shards`` > 1 keeps mesh-divisible chunks
    and prices each one's per-device slice.
    """
    out = []
    c = newton_re.newton_chunk_size(problem, bucket, normalization,
                                    max_p=newton_re.NEWTON_CHUNK_MAX_P,
                                    shards=shards)
    if c:
        out.append(Candidate("newton_primal", c))
    c = (newton_re.dual_chunk_size(problem, bucket, normalization, u_max,
                                   shards=shards)
         if u_max >= 0 else None)
    if c:
        out.append(Candidate("newton_dual", c))
    if out:
        cap = VMAPPED_CHUNK_CAP
        if shards > 1:
            cap = max(shards, cap - cap % shards)
        out.append(Candidate(
            "vmapped_lbfgs", min(max(cand.chunk for cand in out), cap)))
    return out


def _probe_args(batches, w0, local_mask, local_prior, chunk: int):
    from photon_tpu_torch.functions.prior import PriorDistribution

    probe_e = min(w0.shape[0], chunk)
    prior = (PriorDistribution(
        means=newton_re._slice_pad_lanes(local_prior.means, 0, probe_e, chunk),
        precisions=newton_re._slice_pad_lanes(local_prior.precisions, 0,
                                              probe_e, chunk))
        if local_prior is not None else None)
    return (newton_re._slice_pad_batches(batches, 0, probe_e, chunk),
            newton_re._slice_pad_lanes(w0, 0, probe_e, chunk),
            newton_re._slice_pad_lanes(local_mask, 0, probe_e, chunk, fill=1),
            prior)


def solve_measured(
    problem,
    bucket,
    batches,
    w0,
    local_mask,
    local_prior,
    normalization,
    u_max: int,
    fit_for: Callable[[str], Callable],
    sync: Callable[[], None],
    table: Optional[SolverCostTable] = None,
    shards: int = 1,
):
    """Route one bucket through the measured cost table.

    ``fit_for(solver) -> fit_one(batches, w0, mask, prior, lo=0)`` gives
    each solver's closure (``lo`` is the chunk's first lane, for the
    vmapped lanes' layout); ``sync()`` waits for the device. Under a mesh
    the closures run each chunk entity-sharded over ``shards`` devices,
    so a probe times the sharded dispatch the solve uses, and its cost
    lands under the ``@devN`` key.

    Returns ``(model, result, info)``, ``info`` =
    ``{solver, chunk, routing, calibration_seconds, calibrated}``.
    """
    table = table if table is not None else process_table()
    key = shape_class(bucket, shards)
    cands = candidates_for(problem, bucket, normalization, u_max, shards)
    info = {"routing": "measured", "calibration_seconds": 0.0,
            "calibrated": False}

    if not any(c.solver != "vmapped_lbfgs" for c in cands):
        # No Newton variant admitted (a non-smooth objective, a
        # normalization context, nothing under the budget): nothing to
        # race; the whole bucket runs as lanes, as the static plan does.
        model, result = fit_for("vmapped_lbfgs")(batches, w0, local_mask,
                                                 local_prior)
        info.update(solver="vmapped_lbfgs", chunk=None)
        return model, result, info

    win = table.winner(key, cands)
    if win is None:
        t0 = time.perf_counter()
        recorded = table.costs(key)
        for cand in cands:
            if cand.key in recorded:
                continue  # only unmeasured candidates race
            fit_one = fit_for(cand.solver)
            args = _probe_args(batches, w0, local_mask, local_prior, cand.chunk)
            fit_one(*args, lo=0)     # warm: one-time costs, untimed
            sync()
            t1 = time.perf_counter()
            fit_one(*args, lo=0)
            sync()
            exec_s = max(time.perf_counter() - t1, 1e-9)
            table.record(key, cand, exec_s / cand.chunk)
        info["calibration_seconds"] = time.perf_counter() - t0
        info["calibrated"] = True
        _persist(table)
        win = table.winner(key, cands)

    model, result = newton_re.fit_bucket_in_chunks(
        fit_for(win.solver), win.chunk, batches, w0, local_mask, local_prior,
        with_lo=True)
    info.update(solver=win.solver, chunk=win.chunk)
    return model, result, info
