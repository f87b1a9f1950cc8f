"""Request micro-batcher: coalesce concurrent single rows into one kernel call.

A copy of the JAX package's ``serving/batcher.py``: it imports neither JAX nor
torch, and ``tests/test_torch_frontline.py`` compares the code, so edit
both or neither.

The serve-path economics: one padded kernel dispatch costs roughly the
same for 1 row as for 64 (the device work is tiny; dispatch dominates), so
under concurrency the batcher turns N in-flight single-row requests into
ceil(N / max_batch) dispatches. A single idle request pays at most
``max_wait_ms`` of coalescing latency.

One worker thread owns all device interaction (LRU staging + kernel
dispatch), which keeps the coefficient-cache mutation single-threaded by
construction. Each queue item carries its ``ModelVersion`` reference: a
batch only ever contains rows of ONE version, so a hot-swap mid-stream
simply splits a batch — in-flight requests finish on the version they
captured, new ones ride the new version, none are dropped.

Overload and failure story (docs/robustness.md):

* ADMISSION is bounded: at most ``max_queue`` requests may wait. Beyond
  that ``submit`` raises :class:`Overloaded` immediately — the server turns
  it into HTTP 503 + ``Retry-After`` (load shedding) instead of letting the
  queue, and every queued request's latency, grow without bound.
* DEADLINES propagate into the worker: a request whose deadline passed
  while it sat in the queue is failed with :class:`DeadlineExceeded`
  *before* the jitted kernel runs — the waiter already gave up, so burning
  device time on its row would only add latency to live requests behind it.
* A WORKER CRASH (exception escaping the loop itself, not a per-batch
  scoring error) fails every pending future immediately and marks the
  batcher unhealthy (``/healthz`` goes 503) — queued waiters must not sit
  out the full request timeout against a dead worker.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional

from photon_tpu_torch.faults import fault_point
from photon_tpu_torch.obs import trace as obs_trace
from photon_tpu_torch.obs.trace import current_trace_id, trace_span


class Overloaded(RuntimeError):
    """Admission queue full; the caller should shed this request (503)."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before its row reached the kernel."""


class _Pending:
    __slots__ = ("version", "row", "deadline", "future", "trace_id",
                 "enqueued_at")

    def __init__(self, version, row, deadline=None):
        self.version = version
        self.row = row
        self.deadline = deadline  # time.monotonic() value, or None
        self.future: Future = Future()
        # Trace propagation across the thread boundary (Dapper-style): the
        # submitting request's trace id rides the queue item so the worker
        # can correlate queue wait + kernel time back to the request.
        self.trace_id = current_trace_id()
        self.enqueued_at = time.perf_counter()


class MicroBatcher:
    def __init__(
        self,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        max_queue: int = 1024,
        start: bool = True,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_queue = int(max_queue)
        # A bounded stdlib queue IS the admission control: put_nowait past
        # maxsize raises queue.Full, which submit turns into Overloaded.
        self._q: queue.Queue = queue.Queue(maxsize=self.max_queue)
        self._carry: list = []  # other-version items deferred one round
        self._inflight: list = []  # items the worker holds this round
        self._stop = threading.Event()
        self.failed: Optional[BaseException] = None
        # Serializes submit vs close/crash: a submit that passed the checks
        # must finish its put before a drain runs, or the item's future
        # would sit unresolved until the request timeout.
        self._submit_lock = threading.Lock()
        self.stats = {
            "batches": 0, "rows": 0, "max_batch_rows": 0,
            "shed": 0, "expired": 0,
        }
        self._thread = threading.Thread(
            target=self._loop, name="photon-serve-batcher", daemon=True
        )
        if start:
            self._thread.start()

    def start(self) -> None:
        if not self._thread.is_alive():
            self._thread.start()

    @property
    def healthy(self) -> bool:
        """False once the worker has died from an unexpected exception."""
        return self.failed is None

    def submit(self, version, row, deadline: Optional[float] = None) -> Future:
        """Enqueue one parsed row against ``version``; resolves to its
        score (or the scoring exception). ``deadline`` is a
        ``time.monotonic()`` value after which the row is dropped unscored
        (future fails with :class:`DeadlineExceeded`). Raises
        :class:`Overloaded` when the admission queue is full."""
        with self._submit_lock:
            if self.failed is not None:
                raise RuntimeError(
                    "batcher worker died"
                ) from self.failed
            if self._stop.is_set():
                raise RuntimeError("batcher is shut down")
            item = _Pending(version, row, deadline)
            try:
                self._q.put_nowait(item)
            except queue.Full:
                self.stats["shed"] += 1
                raise Overloaded(
                    f"admission queue full ({self.max_queue} waiting)"
                ) from None
        return item.future

    def close(self) -> None:
        with self._submit_lock:
            self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
        # Fail anything still queued rather than hanging its waiter.
        self._fail_pending(RuntimeError("scoring server shut down"))

    # ------------------------------------------------------------ internals

    def _take(self, timeout: Optional[float]) -> _Pending:
        """Pop one queued item (worker thread / final drain)."""
        if timeout is not None:
            return self._q.get(timeout=timeout)
        return self._q.get_nowait()

    def _fail_pending(self, error: BaseException) -> None:
        # _inflight first: items the worker had already dequeued when it
        # died would otherwise be invisible to the drain below and leave
        # their waiters hanging the full request timeout.
        leftovers = list(self._inflight) + list(self._carry)
        self._inflight = []
        self._carry = []
        while True:
            try:
                leftovers.append(self._take(None))
            except queue.Empty:
                break
        for item in leftovers:
            if not item.future.done():
                item.future.set_exception(error)

    def _loop(self) -> None:
        try:
            self._run()
        except BaseException as e:  # noqa: BLE001 - worker death, not a batch error
            # Mark failure UNDER the submit lock: any submit that has not
            # yet enqueued will now raise, and everything already enqueued
            # is drained below — no future can slip through unresolved.
            with self._submit_lock:
                self.failed = e
            self._fail_pending(
                RuntimeError(f"batcher worker died: {type(e).__name__}: {e}")
            )

    def _run(self) -> None:
        while not self._stop.is_set():
            items = self._carry
            self._carry = []
            if not items:
                try:
                    items = [self._take(timeout=0.1)]
                except queue.Empty:
                    continue
            deadline = time.monotonic() + self.max_wait_s
            while len(items) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    items.append(self._take(timeout=remaining))
                except queue.Empty:
                    break
            # Drain anything already queued (no extra waiting).
            while len(items) < self.max_batch:
                try:
                    items.append(self._take(None))
                except queue.Empty:
                    break
            # Deadline-expired rows are dropped BEFORE the kernel runs:
            # their waiters have (or are about to) time out, and scoring
            # them would only delay the live rows behind them.
            now = time.monotonic()
            live = []
            for it in items:
                if it.deadline is not None and now >= it.deadline:
                    self.stats["expired"] += 1
                    if not it.future.done():
                        it.future.set_exception(DeadlineExceeded(
                            "request deadline passed before scoring"
                        ))
                else:
                    live.append(it)
            if not live:
                continue
            items = live
            self._inflight = items  # crash drain covers dequeued items
            fault_point("serving.batcher_batch", rows=len(items))
            v0 = items[0].version
            batch = [it for it in items if it.version is v0]
            self._carry = [it for it in items if it.version is not v0]
            picked = time.perf_counter()
            col = obs_trace.active_collector()
            if col is not None:
                # Queue-wait spans, one per admitted row, stamped with the
                # ORIGINATING request's trace id: the span starts at submit
                # time (producer thread) and ends here (worker thread) —
                # exactly the cross-thread hop the timeline must bridge.
                for it in batch:
                    col.complete(
                        "serve.queue_wait", "serving", it.enqueued_at,
                        picked - it.enqueued_at,
                        {"trace_id": it.trace_id} if it.trace_id else {},
                    )
            # Per-batch stage clock (docs/serving.md §"Latency waterfall"):
            # the scorer accumulates batch_assembly / store_resolve /
            # kernel seconds into the sink; queue_wait is per-row. The
            # whole dict rides each ScoreResult back across the thread
            # boundary so the server can expose the waterfall.
            stage_sink: dict = {}
            try:
                with trace_span(
                    "serve.batch", cat="serving", rows=len(batch),
                    trace_ids=[it.trace_id for it in batch
                               if it.trace_id is not None] or None,
                ):
                    scores, flags = v0.scorer.score_rows_flagged(
                        [it.row for it in batch], stage_sink=stage_sink
                    )
                for it, s, fl in zip(batch, scores, flags):
                    it.future.set_result(ScoreResult(
                        float(s), fl,
                        {"queue_wait": picked - it.enqueued_at,
                         **stage_sink}))
            except Exception as e:  # noqa: BLE001 - routed to the waiter
                for it in batch:
                    if not it.future.done():
                        it.future.set_exception(e)
            self._inflight = []
            self.stats["batches"] += 1
            self.stats["rows"] += len(batch)
            self.stats["max_batch_rows"] = max(
                self.stats["max_batch_rows"], len(batch)
            )

    def reconfigure(self, max_batch: Optional[int] = None,
                    max_queue: Optional[int] = None,
                    max_wait_ms: Optional[float] = None) -> dict:
        """Hot-tune batch/queue/deadline limits (the control plane's
        damped autoscaling lever, ``POST /admin/tune`` — and the
        histogram autotuner's actuation surface, docs/serving.md
        §"Autotuned batching").

        The worker reads ``self.max_batch`` / ``self.max_wait_s`` fresh
        at every assembly round and ``Queue.maxsize`` is consulted under
        the queue's own mutex on each ``put_nowait``, so all changes take
        effect at the next admission/dispatch without pausing the worker.
        Shrinking ``max_queue`` below the current depth never drops
        queued waiters — the bound only gates NEW admissions. Returns the
        active config."""
        with self._submit_lock:
            if max_batch is not None:
                if int(max_batch) < 1:
                    raise ValueError(
                        f"max_batch must be >= 1, got {max_batch}")
                self.max_batch = int(max_batch)
            if max_queue is not None:
                if int(max_queue) < 1:
                    raise ValueError(
                        f"max_queue must be >= 1, got {max_queue}")
                self.max_queue = int(max_queue)
                self._q.maxsize = self.max_queue
            if max_wait_ms is not None:
                if float(max_wait_ms) < 0:
                    raise ValueError(
                        f"max_wait_ms must be >= 0, got {max_wait_ms}")
                self.max_wait_s = float(max_wait_ms) / 1e3
            return {"max_batch": self.max_batch,
                    "max_queue": self.max_queue,
                    "max_wait_ms": round(self.max_wait_s * 1e3, 4)}

    def snapshot(self) -> dict:
        s = dict(self.stats)
        s["mean_batch_rows"] = round(
            s["rows"] / s["batches"], 2) if s["batches"] else 0.0
        s["queued"] = self._q.qsize()
        s["max_batch"] = self.max_batch
        s["max_queue"] = self.max_queue
        s["healthy"] = self.healthy
        return s


class ScoreResult(float):
    """A score that IS a float (full arithmetic/JSON compatibility) plus the
    degradation flags: which RE coordinates scored fixed-effect-only because
    their coefficient-store circuit breaker was open — and the per-stage
    latency waterfall (``stages``: stage name → seconds) the batcher
    measured for this row's batch."""

    __slots__ = ("degraded", "stages")

    def __new__(cls, value: float, degraded=(), stages=None):
        obj = super().__new__(cls, value)
        obj.degraded = tuple(degraded)
        obj.stages = stages or {}
        return obj
