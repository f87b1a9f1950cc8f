"""Replica consume loop: tail the delta log, apply exactly once, converge.

A copy of the JAX package's ``replication/tailer.py`` (it imports neither
torch nor JAX); ``tests/test_torch_replication.py`` compares the code, so
edit both or neither.

A :class:`ReplicaTailer` is the replication half of a serving replica
(``cli/serving_driver --delta-log``): it tails the durable delta log from
its persisted cursor and applies every record through the existing
``ModelRegistry.apply_delta`` path — the same validate-all-then-apply,
swap-lock-serialized route ``POST /admin/patch`` takes, so replication
and direct pushes can never interleave torn state.

Applied state is IN-MEMORY ONLY (the registry's coefficient overlay dies
with the process), so a (re)booting tailer always rebuilds it: replay
starts at seq 0 into the freshly loaded registry — or jumps straight to
the log's latest full-snapshot marker when the backlog exceeds
``catchup_lag`` — and only converges the watermark once the registry
really holds every logged delta. The persisted cursor deliberately does
NOT set the replay start: it is the exactly-once AUDIT watermark, the
first log seq this replica identity has not yet journaled as applied.
Records below it re-apply on rejoin (full-replacement patches make the
replay idempotent for coefficients) but are journaled as
``replica_delta_replayed``; records at/after it journal
``replica_delta_applied`` and advance the cursor (atomic replace) only
after ``apply_delta`` returns. Those per-apply rows — each log seq
exactly once across every incarnation of a replica id — are the audit
trail ``scripts/replica_smoke.py`` sums across the fleet.

Catch-up: when the boot backlog (log head − replay position) exceeds
``catchup_lag`` and the log holds a full-snapshot marker ahead of the
replay position, the tailer jumps — ``prepare_standby`` + ``swap`` to the
marker's model dir (the registry's warm-standby machinery, so the swap is a
pointer move) and replay resumes at ``marker seq + 1``. No eligible
marker degrades to plain replay, which is always correct, just slower.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Optional

from photon_tpu_torch.obs import (
    REGISTRY as GLOBAL_REGISTRY,
    new_trace_id,
    trace_context,
    trace_span,
)
from photon_tpu_torch.replication.log import (
    DeltaLogRecord,
    ReplicaCursor,
    find_latest_snapshot,
    iter_log,
    log_next_seq,
)


class ReplicaTailer:
    """Owns one replica's delta-log consumption (module doc)."""

    def __init__(
        self,
        registry,
        log_path: str,
        replica_id: Optional[str] = None,
        cursor_dir: Optional[str] = None,
        catchup_lag: int = 0,
        poll_s: float = 0.05,
        journal=None,
        logger=None,
        metrics=None,
    ):
        self.registry = registry
        self.log_path = log_path
        self.replica_id = str(replica_id or f"r{os.getpid()}")
        self.catchup_lag = int(catchup_lag)
        self.poll_s = float(poll_s)
        self.journal = journal
        self.logger = logger
        self.cursor = ReplicaCursor(
            cursor_dir or (os.path.dirname(log_path) or "."),
            self.replica_id)
        m = metrics if metrics is not None else GLOBAL_REGISTRY
        self._applied_c = m.counter(
            "replica_deltas_applied_total",
            "delta-log records applied by this replica")
        self._replayed_c = m.counter(
            "replica_deltas_replayed_total",
            "pre-cursor records re-applied at boot to rebuild in-memory "
            "state")
        self._dup_c = m.counter(
            "replica_duplicate_seqs_total",
            "delta-log records skipped as already-applied duplicates")
        self._catchup_c = m.counter(
            "replica_catchups_total",
            "snapshot catch-up jumps taken instead of full replay")
        self._error_c = m.counter(
            "replica_apply_errors_total",
            "delta-log records the registry refused")
        self._watermark_g = m.gauge(
            "replica_seq_watermark",
            "highest delta-log seq this replica has applied")
        self._lag_g = m.gauge(
            "replica_lag",
            "delta-log records between the log head and this replica")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started = False
        self._lock = threading.Lock()
        self._applied_total = 0
        self._replayed_total = 0
        self._duplicates = 0
        self._catchups = 0
        self._last_applied_ts: Optional[float] = None
        self._last_error: Optional[str] = None
        self._refused = False   # a validation-refused delta poisons the log
        # The registry handed in was just rebuilt from its model dir: it
        # holds NONE of the deltas a previous incarnation applied (the
        # overlay is in-memory only), so replay starts at 0 regardless of
        # the persisted cursor — the cursor is the exactly-once JOURNAL
        # watermark, not the state watermark (module doc).
        self._next_seq = 0
        self._audit_next = self.cursor.load()
        self._stamp_gauges()

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        """Tail in a background thread until :meth:`stop`."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._started = True
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run_follow,
            name=f"photon-replica-tail-{self.replica_id}",
            daemon=True,
        )
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._started = False       # a deliberate stop is not a dead tailer
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def restart(self) -> dict:
        """Journaled restart request (``POST /admin/replication/restart``,
        the control plane's ``replication_tailer_dead`` remediation).

        A live follow thread makes this a no-op (``restarted: false``) —
        the lever is for the DEAD-tailer state, and an idempotent restart
        must not double-journal. A VALIDATION-refused delta also refuses
        to restart: the log itself is poisoned, so re-tailing would refuse
        again at the same seq — the error correctly keeps the replica
        drained until an operator intervenes. A transient follow-loop
        death clears the error and restarts the thread. Returns
        ``{"restarted", "snapshot"}``."""
        alive = self._thread is not None and self._thread.is_alive()
        if alive:
            return {"restarted": False, "snapshot": self.snapshot()}
        with self._lock:
            refused = self._refused
            err = self._last_error
            if not refused:
                self._last_error = None
        if refused:
            return {"restarted": False, "refused": True,
                    "snapshot": self.snapshot()}
        self._journal("replica_tailer_restarted",
                      prior_error=(err or "")[:200] or None)
        self.start()
        return {"restarted": True, "snapshot": self.snapshot()}

    def _run_follow(self) -> None:
        try:
            self._consume(follow=True)
        except Exception as e:  # noqa: BLE001 - surfaced on /healthz
            with self._lock:
                self._last_error = f"{type(e).__name__}: {e}"
            if self.logger is not None:
                self.logger.error("replica tailer died: %s", e)
            self._journal("replica_tailer_died",
                          error=f"{type(e).__name__}: {str(e)[:200]}")

    def run_once(self) -> int:
        """Synchronous drain to the current log head (tests, and the
        serving driver's boot: converge BEFORE the first health check
        reports a watermark). Returns the number of records applied."""
        return self._consume(follow=False)

    # -------------------------------------------------------------- consume

    def _consume(self, follow: bool) -> int:
        # A replica may boot before the publisher's first append creates
        # the log: wait for it under follow, no-op otherwise (the boot
        # drain has nothing to converge to yet).
        while not os.path.exists(self.log_path):
            if not follow or self._stop.is_set():
                self._stamp_gauges()
                return 0
            time.sleep(self.poll_s)
        self._maybe_catch_up()
        applied = 0
        records = iter_log(
            self.log_path,
            start_seq=self._next_seq,
            follow=follow,
            poll_s=self.poll_s,
            stop=self._stop.is_set,
            idle_yield_s=1.0 if follow else 0.0,
            on_duplicate=self._on_duplicate,
        )
        for rec in records:
            if rec is None:           # idle tick: refresh the lag gauge
                self._stamp_gauges()
                continue
            if rec.is_snapshot:
                # Reached sequentially, everything before it is already
                # applied — the marker is informational here; only a
                # catch-up JUMP builds from its model dir.
                self._advance(rec, applied_delta=False)
                continue
            self._apply(rec)
            applied += 1
        self._stamp_gauges()
        return applied

    def _apply(self, rec: DeltaLogRecord) -> None:
        # The publisher's trace id rides the log record; applying under it
        # joins this replica's apply span to the trainer's publish span in
        # the merged fleet timeline — the file-based analog of the
        # X-Photon-Trace-Id header on /admin/patch.
        with trace_context(rec.trace_id or new_trace_id()), \
                trace_span("replica.apply", cat="replication",
                           seq=rec.seq, replica=self.replica_id) as sp:
            try:
                result = self.registry.apply_delta(
                    rec.delta.raw_patches(),
                    seq=rec.delta.seq,
                    event_horizon=rec.delta.event_horizon,
                )
            except Exception as e:
                # A refused delta (validation) poisons every replica the
                # same way — record it and refuse to advance past it: a
                # cursor that skips a rejected record would diverge this
                # replica from the ones that applied it.
                self._error_c.inc(1, replica=self.replica_id)
                with self._lock:
                    self._last_error = f"{type(e).__name__}: {e}"
                    self._refused = True
                self._journal(
                    "replica_apply_refused", seq=rec.seq,
                    error=f"{type(e).__name__}: {str(e)[:200]}")
                raise
            sp.set(patch_seq=result["patch_seq"],
                   entities=result["patched"])
        self._advance(rec, applied_delta=True, result=result)

    def _advance(self, rec: DeltaLogRecord, applied_delta: bool,
                 result: Optional[dict] = None) -> None:
        # A record below the audit watermark is a boot-time REPLAY: a
        # previous incarnation already journaled it as applied, so it
        # rebuilds in-memory state but must not double-count in the
        # exactly-once audit, and the durable cursor never regresses.
        with self._lock:
            self._next_seq = rec.seq + 1
            replay = rec.seq < self._audit_next
            if not replay:
                self._audit_next = rec.seq + 1
            if applied_delta:
                if replay:
                    self._replayed_total += 1
                else:
                    self._applied_total += 1
                self._last_applied_ts = time.time()
            applied_total = self._applied_total
        if not replay:
            self.cursor.save(rec.seq + 1, applied_total=applied_total)
        if applied_delta:
            if replay:
                self._replayed_c.inc(1, replica=self.replica_id)
                self._journal("replica_delta_replayed", seq=rec.seq,
                              delta_seq=rec.delta.seq)
            else:
                self._applied_c.inc(1, replica=self.replica_id)
                self._journal(
                    "replica_delta_applied", seq=rec.seq,
                    delta_seq=rec.delta.seq,
                    patch_seq=(result or {}).get("patch_seq"),
                    entities=(result or {}).get("patched"),
                )
        self._stamp_gauges()

    def _on_duplicate(self, seq: int) -> None:
        with self._lock:
            self._duplicates += 1
        self._dup_c.inc(1, replica=self.replica_id)
        self._journal("replica_duplicate_seq", seq=seq)

    # ------------------------------------------------------------- catch-up

    def _maybe_catch_up(self) -> None:
        """Snapshot catch-up at (re)join time: when the replay backlog
        (log head − in-memory replay position) exceeds ``catchup_lag``
        and a full-snapshot marker sits at/ahead of that position, swap
        to it instead of replaying the whole backlog. At boot the replay
        position is 0, so ANY marker in the log is eligible — including
        the base marker a fresh log starts with."""
        if self.catchup_lag <= 0:
            return
        head = log_next_seq(self.log_path)
        lag = head - self._next_seq
        if lag <= self.catchup_lag:
            return
        marker = find_latest_snapshot(self.log_path,
                                      min_seq=self._next_seq)
        if marker is not None and marker.seq <= self._next_seq:
            # Jumping to a marker AT the replay position (e.g. the base
            # marker at seq 0 on a fresh boot) rebuilds nothing replay
            # wouldn't cover for free — skip the swap.
            marker = None
        if marker is None:
            if self.logger is not None:
                self.logger.info(
                    "replica %s lag %d exceeds catch-up threshold %d but "
                    "the log holds no snapshot marker ahead of seq %d; "
                    "replaying", self.replica_id, lag, self.catchup_lag,
                    self._next_seq)
            return
        model_dir = marker.snapshot["model_dir"]
        self._journal("replica_catchup_begin", lag=lag,
                      snapshot_seq=marker.seq, model_dir=model_dir)
        t0 = time.monotonic()
        with trace_span("replica.catchup", cat="replication",
                        replica=self.replica_id, snapshot_seq=marker.seq):
            # Warm off the hot path, then a pointer-move swap.
            self.registry.prepare_standby(model_dir)
            self.registry.swap(model_dir)
        with self._lock:
            self._next_seq = marker.seq + 1
            # The jump covers every seq through the marker; the audit
            # watermark moves forward (never back — a jump below the
            # cursor is pure state rebuild, already journaled).
            self._audit_next = max(self._audit_next, marker.seq + 1)
            audit_next = self._audit_next
            self._catchups += 1
            applied_total = self._applied_total
        self.cursor.save(audit_next, applied_total=applied_total)
        self._catchup_c.inc(1, replica=self.replica_id)
        self._journal("replica_catchup_done", snapshot_seq=marker.seq,
                      seconds=round(time.monotonic() - t0, 3))
        if self.logger is not None:
            self.logger.info(
                "replica %s caught up via snapshot seq %d (%s); lag was %d",
                self.replica_id, marker.seq, model_dir, lag)
        self._stamp_gauges()

    # ------------------------------------------------------------ telemetry

    def _journal(self, event: str, **fields) -> None:
        if self.journal is not None:
            self.journal.record(event, replica=self.replica_id,
                                log_path=self.log_path, **fields)

    def _stamp_gauges(self) -> None:
        snap = self.snapshot()
        self._watermark_g.set(snap["seq_watermark"],
                              replica=self.replica_id)
        self._lag_g.set(snap["lag"], replica=self.replica_id)

    def snapshot(self) -> dict:
        """Replication state for ``/healthz`` and the metrics snapshot:
        watermark + lag are the staleness signal the router weights by."""
        head = log_next_seq(self.log_path)
        with self._lock:
            next_seq = self._next_seq
            out = {
                "replica_id": self.replica_id,
                "log_path": self.log_path,
                "seq_watermark": next_seq - 1,
                "next_seq": next_seq,
                "audit_next_seq": self._audit_next,
                "head_seq": head,
                "lag": max(0, head - next_seq),
                "applied_total": self._applied_total,
                "replayed_total": self._replayed_total,
                "duplicates_skipped": self._duplicates,
                "catchups": self._catchups,
                "last_applied_ts": self._last_applied_ts,
                "started": self._started,
                "running": (self._thread is not None
                            and self._thread.is_alive()),
                "error": self._last_error,
            }
        return out
