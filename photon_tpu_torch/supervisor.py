"""Failure detection and restart supervision for training.

Port of ``photon_tpu/supervisor.py`` for one process. The recovery model is
checkpoint-restart (``checkpoint.py`` resumes bit-identically) plus:

* :func:`run_with_recovery` and :class:`RunSupervisor`: run a training
  attempt, classify a failure as retryable (runtime, I/O, device errors,
  preemptions) or fatal (``ValueError`` / ``TypeError`` / assertions and
  user aborts), and restart up to a budget with seeded, decorrelated
  backoff. Each attempt re-enters the driver, whose ``--checkpoint-dir``
  resume fast-forwards past completed coordinate steps. The supervisor
  also journals every attempt (:class:`RecoveryJournal`, an append-only
  JSONL file), counts ``run_restarts_total{cause}``, restarts an
  out-of-memory failure once, pre-degraded and without backoff, and
  under ``--backend-policy failover`` re-probes the card between attempts.

  Limit: a CUDA context poisoned by a sticky error (an illegal address, a
  launch failure, an ECC error) cannot be re-created in the process. A
  ``device_lost`` failure whose context fails a tiny op is therefore not
  restarted in-process: the attempt ends with the classified cause, and
  the scheduler's process restart resumes from the checkpoint.
* :class:`Heartbeat`: a liveness beacon file, rewritten every interval by a
  daemon thread, which also runs the map-count and device-memory
  watchdogs and exports every expected peer's beacon age. Across the
  processes of a group, the retry loop checks its peers' beacons
  (``check_peers``), waits for every peer to reach its attempt epoch
  (``wait_for_epoch``: a lone retrier would issue collectives no peer
  joins), and arms a :class:`PeerWatchdog` around each attempt, which ends
  a process wedged in a collective whose peer died (exit
  :data:`WATCHDOG_EXIT_CODE`).
* :class:`MapCountWatchdog`: warns as the process's memory-map count nears
  ``vm.max_map_count``.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import threading
import time
from typing import Callable, Iterator, Optional, Sequence

from photon_tpu_torch.faults import fault_point

__all__ = [
    "RestartPolicy",
    "RestartBudget",
    "AttemptFailure",
    "RestartsExhausted",
    "run_with_recovery",
    "RecoveryJournal",
    "RunSupervisor",
    "Heartbeat",
    "PeerReport",
    "PeerWatchdog",
    "WATCHDOG_EXIT_CODE",
    "MapCountWatchdog",
    "arm_first_step_clock",
    "clear_executable_caches",
    "disarm_first_step_clock",
    "install_map_count_gauge",
    "note_first_step",
]

logger = logging.getLogger("photon_tpu_torch.supervisor")


class MapCountWatchdog:
    """Warn when this process's memory-map count nears ``vm.max_map_count``.

    ``check()`` reads ``/proc/self/maps`` and logs a warning once the used
    fraction crosses ``warn_fraction`` (default 0.5), at most every
    ``rewarn_seconds`` and only while above it. Without procfs ``check()``
    reports ``maps=-1`` and never warns."""

    #: Linux default when /proc/sys/vm/max_map_count is unreadable.
    DEFAULT_MAX_MAP_COUNT = 65530

    def __init__(self, warn_fraction: float = 0.5,
                 rewarn_seconds: float = 300.0):
        if not 0.0 < warn_fraction <= 1.0:
            raise ValueError(f"warn_fraction must be in (0, 1], got "
                             f"{warn_fraction}")
        self.warn_fraction = warn_fraction
        self.rewarn_seconds = rewarn_seconds
        # None: never warned, so the first check over the threshold warns
        # whatever the clock reads (time.monotonic() starts near 0 on a
        # freshly booted host).
        self._last_warn: Optional[float] = None

    @staticmethod
    def map_count() -> int:
        """Live memory-map count of this process, or -1 without procfs."""
        try:
            with open("/proc/self/maps", "rb") as f:
                return sum(1 for _ in f)
        except OSError:
            return -1

    @staticmethod
    def map_limit() -> int:
        try:
            with open("/proc/sys/vm/max_map_count") as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return MapCountWatchdog.DEFAULT_MAX_MAP_COUNT

    def check(self) -> dict:
        """One watchdog pass: ``{maps, limit, fraction, warned}``."""
        maps = self.map_count()
        limit = self.map_limit()
        frac = (maps / limit) if (maps >= 0 and limit > 0) else 0.0
        warned = False
        now = time.monotonic()
        if frac >= self.warn_fraction and (
            self._last_warn is None
            or now - self._last_warn >= self.rewarn_seconds
        ):
            self._last_warn = now
            warned = True
            logger.warning(
                "memory-map count %d is %.0f%% of vm.max_map_count=%d — a "
                "new mapping (a loaded library, a pinned buffer) will fail "
                "with ENOMEM at the limit; raise the sysctl or end the "
                "process sooner", maps, 100.0 * frac, limit)
        return {"maps": maps, "limit": limit, "fraction": round(frac, 4),
                "warned": warned}


def install_map_count_gauge() -> None:
    """Register the ``process_memory_maps`` callback gauge (idempotent)."""
    from photon_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.gauge_fn(
        "process_memory_maps",
        lambda: float(max(MapCountWatchdog.map_count(), 0)),
        "Live /proc/self/maps count (see supervisor.MapCountWatchdog)",
    )


def clear_executable_caches(reason: str = "") -> int:
    """The port's counterpart of dropping JAX's compiled-executable caches:
    it compiles no programs to drop, so it releases what a device loss or
    a restart leaves behind: every live sweep cache's pins, then the
    caching allocator's unused blocks (``torch.cuda.empty_cache``, when the
    process has a CUDA context). Returns the number of sweep caches
    released."""
    from photon_tpu_torch.data.device_cache import release_all_caches

    released = release_all_caches()
    import torch

    if torch.cuda.is_initialized():
        try:
            torch.cuda.empty_cache()
        except Exception:  # noqa: BLE001 - a poisoned context is judged
            pass  # by the caller's context check, not here
    logger.info("released %d sweep cache(s) and the allocator's cache%s",
                released, f" ({reason})" if reason else "")
    return released


def _default_retryable() -> tuple:
    """Exception types that may heal on a restart: runtime and I/O errors
    (CUDA errors surface as ``RuntimeError``)."""
    return (RuntimeError, OSError, ConnectionError)


# Config bugs and user aborts: retrying cannot help.
_FATAL = (ValueError, TypeError, AssertionError, KeyboardInterrupt)


@dataclasses.dataclass(frozen=True)
class RestartPolicy:
    """How many times to restart and how to pace the attempts.

    With ``jitter`` (the default) each delay is ``min(max_backoff,
    uniform(backoff, 3 * previous_delay))``, decorrelated jitter that keeps
    restarting processes out of lockstep; ``seed`` pins the stream (None
    seeds from OS entropy). ``jitter=False`` paces exactly
    ``backoff * multiplier^n``, capped at ``max_backoff_seconds``."""

    max_restarts: int = 3
    backoff_seconds: float = 1.0
    backoff_multiplier: float = 2.0
    max_backoff_seconds: float = 60.0
    jitter: bool = True
    seed: Optional[int] = None
    retryable: tuple = dataclasses.field(default_factory=_default_retryable)

    def is_retryable(self, err: BaseException) -> bool:
        if isinstance(err, _FATAL):
            return False
        return isinstance(err, self.retryable)

    def delays(self) -> Iterator[float]:
        """The (possibly jittered) inter-attempt delay sequence."""
        rng = random.Random(self.seed)
        delay = self.backoff_seconds
        while True:
            if self.jitter:
                delay = min(
                    self.max_backoff_seconds,
                    rng.uniform(
                        self.backoff_seconds,
                        max(self.backoff_seconds, 3.0 * delay),
                    ),
                )
                yield delay
            else:
                yield min(self.max_backoff_seconds, delay)
                delay *= self.backoff_multiplier


class RestartBudget:
    """Counted restart allowance with :class:`RestartPolicy` pacing:
    ``allow()`` consumes a grant and returns True, or returns False when the
    budget is spent or the pacing window has not passed."""

    def __init__(self, policy: RestartPolicy,
                 clock: Optional[Callable[[], float]] = None):
        self.policy = policy
        self._clock = clock or time.monotonic
        self._delays = policy.delays()
        self.spent = 0
        self._not_before: Optional[float] = None

    @property
    def remaining(self) -> int:
        return max(0, self.policy.max_restarts - self.spent)

    def allow(self) -> bool:
        if self.spent >= self.policy.max_restarts:
            return False
        now = self._clock()
        if self._not_before is not None and now < self._not_before:
            return False
        self.spent += 1
        self._not_before = now + next(self._delays)
        return True

    def snapshot(self) -> dict:
        return {"spent": self.spent, "remaining": self.remaining,
                "max_restarts": self.policy.max_restarts}


@dataclasses.dataclass
class AttemptFailure:
    """One failed attempt. ``cause`` is the classified cause when the
    failure went through :class:`RunSupervisor`; None for the plain loop."""

    attempt: int
    error_type: str
    message: str
    seconds: float
    cause: Optional[str] = None


class RestartsExhausted(RuntimeError):
    """Every attempt in the budget failed: carries the history, and via
    :attr:`cause` the last classified cause."""

    def __init__(self, failures: Sequence[AttemptFailure], last: BaseException):
        self.failures = list(failures)
        self.last = last
        super().__init__(
            f"{len(self.failures)} attempt(s) failed; last: "
            f"{type(last).__name__}: {last}"
        )

    @property
    def cause(self) -> Optional[str]:
        return self.failures[-1].cause if self.failures else None


def run_with_recovery(
    make_attempt: Callable[[int], object],
    policy: RestartPolicy = RestartPolicy(),
    logger=None,
    sleep: Callable[[float], None] = time.sleep,
):
    """Run ``make_attempt(attempt_index)`` under the restart policy.

    Returns what the first successful attempt returns. A non-retryable
    exception propagates at once; retryable failures restart with backoff
    until the budget is spent, then :class:`RestartsExhausted` is raised,
    chained to the last error. An OOM neither sleeps nor draws a delay."""
    failures: list[AttemptFailure] = []
    delays = policy.delays()
    for attempt in range(policy.max_restarts + 1):
        t0 = time.monotonic()
        try:
            return make_attempt(attempt)
        except BaseException as e:  # noqa: BLE001 - classified below
            took = time.monotonic() - t0
            if not policy.is_retryable(e):
                raise
            failures.append(
                AttemptFailure(attempt, type(e).__name__, str(e), took)
            )
            if logger is not None:
                logger.warning(
                    "attempt %d failed after %.1fs (%s: %s); %s",
                    attempt, took, type(e).__name__, e,
                    "restarting" if attempt < policy.max_restarts
                    else "budget exhausted",
                )
            if attempt >= policy.max_restarts:
                raise RestartsExhausted(failures, e) from e
            from photon_tpu_torch.runtime.memory_guard import is_oom

            delay = 0.0 if is_oom(e) else next(delays)
            if delay > 0:
                sleep(delay)
    raise AssertionError("unreachable")


# ---------------------------------------------------------------- supervision


class RecoveryJournal:
    """Append-only JSONL record of supervision events.

    Each row: ``{"time": <ISO-8601 UTC>, "t": <unix seconds>, "event":
    <name>, "pid": ..., **fields}``, one unbuffered whole-line append each
    (``utils.write_metrics_jsonl``), so rows of a restart racing the dying
    attempt's last record never tear. Every row is mirrored as a
    ``recovery.<event>`` trace instant."""

    def __init__(self, path: str):
        self.path = path

    def record(self, event: str, _mirror: bool = True, **fields) -> None:
        """Append one row; ``_mirror=False`` skips the trace instant for
        events whose instant is emitted elsewhere."""
        from photon_tpu_torch.obs import instant
        from photon_tpu_torch.utils import write_metrics_jsonl

        row = {
            "time": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "t": round(time.time(), 6),
            "event": event,
            "pid": os.getpid(),
            **fields,
        }
        try:
            write_metrics_jsonl(self.path, [row])
        except OSError:
            pass  # the journal is evidence, never a new failure mode
        if _mirror:
            instant(f"recovery.{event}", cat="recovery", **fields)

    def rows(self) -> list[dict]:
        """Every row written so far (an absent file has none)."""
        try:
            with open(self.path) as f:
                return [json.loads(line) for line in f if line.strip()]
        except FileNotFoundError:
            return []


# ------------------------------------------------ restart-to-first-step clock

_clock_lock = threading.Lock()
_first_step: Optional[dict] = None


def arm_first_step_clock(attempt: int = 0, journal=None) -> None:
    """Start the (re)start → first committed step clock; the supervisor
    arms one per attempt. The next :func:`note_first_step` stamps the
    seconds into the ``restart_to_first_step_seconds`` gauge, a
    ``recovery.first_step`` instant and a ``first_step`` journal row."""
    global _first_step
    with _clock_lock:
        _first_step = {"t0": time.monotonic(), "attempt": int(attempt),
                       "journal": journal}


def disarm_first_step_clock() -> None:
    """Drop an armed clock without stamping it (the supervised run ended
    before any step committed)."""
    global _first_step
    with _clock_lock:
        _first_step = None


def note_first_step(phase: str) -> Optional[float]:
    """Close the armed clock (a no-op when none is armed: callers stamp
    after every committed step, and only the first after arming lands).
    Returns the seconds when it fired."""
    global _first_step
    with _clock_lock:
        st = _first_step
        _first_step = None
    if st is None:
        return None
    seconds = time.monotonic() - st["t0"]
    from photon_tpu_torch.obs import instant
    from photon_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.gauge(
        "restart_to_first_step_seconds",
        "seconds from the start of the latest supervised attempt to its "
        "first committed training step",
    ).set(round(seconds, 4))
    instant("recovery.first_step", cat="recovery", phase=phase,
            attempt=st["attempt"], seconds=round(seconds, 4))
    journal = st["journal"]
    if journal is not None:
        try:
            journal.record(
                "first_step", _mirror=False, attempt=st["attempt"],
                phase=phase, restart_to_first_step_seconds=round(seconds, 4))
        except Exception:  # noqa: BLE001 - the journal is evidence
            pass
    return seconds


class RunSupervisor:
    """Checkpoint-resume restart supervision with classified causes.

    Wraps an attempt factory as :func:`run_with_recovery` does (the same
    policy, retryable/fatal split and checkpoint fast-forward) and adds:

    * every failure classified (``runtime/backend_guard``, plus
      ``preemption`` / ``io`` from the exception type) and counted in
      ``run_restarts_total{cause}``;
    * every attempt's start, failure, restart and success in the
      :class:`RecoveryJournal` and as ``recovery.*`` instants, with the
      seconds from each attempt's start to its first committed step;
    * an OOM restarted at most once, at once, pre-degraded
      (``memory_guard.pre_degrade_for_restart``);
    * a ``device_lost`` failure whose CUDA context fails a tiny op not
      restarted in-process (``context_lost`` row; see the module
      docstring);
    * under ``failover_policy="failover"``, a backend-level failure
      re-probes the card between attempts and sends the next attempt to
      the CPU when the card stays down (stamped in the guard snapshot).
    """

    def __init__(
        self,
        policy: RestartPolicy = RestartPolicy(),
        journal: Optional[object] = None,
        logger=None,
        failover_policy: str = "strict",
        sleep: Callable[[float], None] = time.sleep,
    ):
        if isinstance(journal, str):
            journal = RecoveryJournal(journal)
        self.policy = policy
        self.journal = journal
        self.logger = logger
        self.failover_policy = failover_policy
        self.sleep = sleep

    @staticmethod
    def classify(err: BaseException) -> str:
        """Cause label: the backend classification when it matches, else
        the exception family."""
        from photon_tpu_torch.faults import PreemptionError
        from photon_tpu_torch.runtime.backend_guard import (
            CAUSE_UNKNOWN,
            classify_backend_error,
        )

        if isinstance(err, PreemptionError):
            return "preemption"
        cause = classify_backend_error(err)
        if cause != CAUSE_UNKNOWN:
            return cause
        if isinstance(err, (OSError, ConnectionError)):
            return "io"
        return CAUSE_UNKNOWN

    def _journal(self, event: str, **fields) -> None:
        if self.journal is not None:
            self.journal.record(event, **fields)
        else:
            from photon_tpu_torch.obs import instant

            instant(f"recovery.{event}", cat="recovery", **fields)

    def _maybe_failover(self, cause: str) -> None:
        """Between attempts, under the failover policy only: a backend-level
        failure re-probes the card in a child and, when it stays down,
        records the failover (the next attempt then runs on the CPU)."""
        if self.failover_policy != "failover":
            return
        from photon_tpu_torch.runtime import backend_guard as bg

        if cause not in (bg.CAUSE_INIT_UNAVAILABLE, bg.CAUSE_DEVICE_LOST,
                         bg.CAUSE_COMPILE_ERROR):
            return
        probe = bg.probe_backend()
        if probe.ok:
            return
        if self.journal is not None:
            self.journal.record("backend_failover", _mirror=False,
                                to="cpu", cause=probe.cause,
                                reason=probe.reason)
        bg.record_failover(probe, logger=self.logger)

    def run(self, make_attempt: Callable[[int], object]):
        """Run ``make_attempt(attempt_index)`` under the policy; returns the
        first successful attempt's result. Non-retryable errors propagate
        at once (journaled ``fatal``); an exhausted budget raises
        :class:`RestartsExhausted` whose ``cause`` is the last classified
        failure. The journal is registered with ``memory_guard`` for the
        run, so in-run OOM downshifts land in it too."""
        from photon_tpu_torch.runtime import memory_guard as mg_mod

        if self.journal is None:
            return self._run(make_attempt)
        prev_journal = mg_mod.set_journal(self.journal)
        try:
            return self._run(make_attempt)
        finally:
            mg_mod.set_journal(prev_journal)

    def _run(self, make_attempt: Callable[[int], object]):
        from photon_tpu_torch.obs.metrics import REGISTRY
        from photon_tpu_torch.runtime import backend_guard as bg
        from photon_tpu_torch.runtime import memory_guard as mg_mod

        restarts = REGISTRY.counter(
            "run_restarts_total",
            "training restarts/recoveries by classified cause",
        )
        failures: list[AttemptFailure] = []
        delays = self.policy.delays()
        attempt = 0
        oom_restarts = 0
        other_restarts = 0
        while True:
            t0 = time.monotonic()
            self._journal("attempt_start", attempt=attempt)
            arm_first_step_clock(attempt=attempt, journal=self.journal)
            try:
                result = make_attempt(attempt)
            except BaseException as e:  # noqa: BLE001 - classified below
                took = round(time.monotonic() - t0, 3)
                cause = self.classify(e)
                retryable = self.policy.is_retryable(e)
                is_oom_failure = cause == bg.CAUSE_OOM
                context_lost = (cause == bg.CAUSE_DEVICE_LOST
                                and not bg.context_usable())
                if context_lost:
                    will_restart = False
                elif is_oom_failure:
                    # The one pre-degraded OOM restart rides outside the
                    # transient budget; a zero budget still restarts nothing.
                    will_restart = (retryable and oom_restarts < 1
                                    and self.policy.max_restarts > 0)
                else:
                    will_restart = (retryable and other_restarts
                                    < self.policy.max_restarts)
                failures.append(AttemptFailure(
                    attempt, type(e).__name__, str(e), took, cause=cause))
                self._journal(
                    "attempt_failed", attempt=attempt, cause=cause,
                    error=f"{type(e).__name__}: {str(e)[:300]}",
                    seconds=took, ok=False, will_restart=will_restart)
                if self.logger is not None:
                    self.logger.warning(
                        "attempt %d failed after %.1fs [%s] (%s: %s); %s",
                        attempt, took, cause, type(e).__name__, e,
                        "restarting" if will_restart
                        else "fatal" if not retryable else "not restarting")
                if not retryable:
                    disarm_first_step_clock()
                    self._journal("fatal", attempt=attempt, cause=cause)
                    raise
                if not will_restart:
                    disarm_first_step_clock()
                    if context_lost:
                        self._journal(
                            "context_lost", attempt=attempt, cause=cause,
                            reason="the CUDA context fails a tiny op; only a "
                                   "new process can resume (checkpoint)")
                    self._journal("exhausted", attempts=len(failures),
                                  cause=cause)
                    raise RestartsExhausted(failures, e) from e
                restarts.inc(cause=cause)
                self._maybe_failover(cause)
                if is_oom_failure:
                    oom_restarts += 1
                    mg_mod.pre_degrade_for_restart(
                        f"attempt {attempt} oom: {str(e)[:120]}")
                else:
                    other_restarts += 1
                clear_executable_caches(f"restart attempt {attempt + 1}")
                delay = 0.0 if is_oom_failure else next(delays)
                self._journal("restart", attempt=attempt + 1, cause=cause,
                              backoff_s=round(delay, 3))
                if delay > 0:
                    self.sleep(delay)
                attempt += 1
                continue
            took = round(time.monotonic() - t0, 3)
            disarm_first_step_clock()
            self._journal("run_ok", attempt=attempt, seconds=took, ok=True,
                          prior_failures=len(failures))
            return result


# ---------------------------------------------------------------------------
# Liveness


@dataclasses.dataclass
class PeerReport:
    """Result of a liveness check."""

    alive: list[int]
    dead: list[int]          # stale heartbeat
    missing: list[int]       # never wrote one

    @property
    def healthy(self) -> bool:
        return not self.dead and not self.missing


class Heartbeat:
    """Per-process liveness beacon: ``<dir>/host-<process_id>.hb`` holds a
    JSON payload (pid, wall time, beat count, attempt epoch), rewritten
    atomically (tmp + ``os.replace``) every ``interval_seconds`` by a daemon
    thread. The same thread runs the map-count watchdog and the
    device-memory watchdog (``memory_guard``; ``"auto"`` is the process's
    guard, None disables it) and, when given, ``slo_watchdog``
    (``obs.analysis.slo.SloWatchdog``: SLO rules judged on the beat
    cadence, rate-limited by the watchdog's own ``min_interval_s``, from
    the thread that survives a wedged main thread). ``process_id`` is the
    beacon's process (default: this process's rank in its group, 0
    without one). ``peer_gauges``, the expected process ids, are exported
    on every beat as ``host_beacon_age_seconds{host=...}`` (-1: no beacon
    file), so the fleet report shows a dead host as a climbing age.
    Staleness is judged by the files' mtimes on the shared filesystem: one
    clock for every reader."""

    def __init__(self, directory: str, process_id: Optional[int] = None,
                 interval_seconds: float = 10.0, slo_watchdog=None,
                 memory_guard="auto",
                 peer_gauges: Optional[Sequence[int]] = None):
        if process_id is None:
            from photon_tpu_torch.parallel.distributed import process_index

            process_id = process_index()
        self.directory = directory
        self.process_id = int(process_id)
        self.interval_seconds = interval_seconds
        self.slo_watchdog = slo_watchdog
        self.memory_guard = memory_guard
        self.peer_gauges = (None if peer_gauges is None
                            else [int(p) for p in peer_gauges])
        self.epoch = 0
        self._stop = None
        self._thread = None
        self._beats = 0
        os.makedirs(directory, exist_ok=True)

    def _path(self, pid: int) -> str:
        return os.path.join(self.directory, f"host-{pid}.hb")

    def beat_once(self) -> None:
        # Chaos hook: an injected OSError here makes THIS beacon go stale
        # while the process keeps running.
        fault_point("heartbeat.beat", process_id=self.process_id)
        self._beats += 1
        payload = {
            "process_id": self.process_id,
            "pid": os.getpid(),
            "time": time.time(),
            "beats": self._beats,
            "epoch": self.epoch,
        }
        # Thread-unique tmp name: set_epoch beats from the caller's thread
        # while the loop beats on its own.
        tmp = (f"{self._path(self.process_id)}.tmp{os.getpid()}"
               f".{threading.get_ident()}")
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self._path(self.process_id))

    def set_epoch(self, epoch: int) -> None:
        """Advertise this process's attempt index (and beat at once).

        In-process retry across processes is safe only when every process
        re-enters the attempt together: one retrying alone issues
        collectives that a peer still blocked in the previous attempt
        never joins, and both then hang with fresh beacons. The epoch in
        the beacon is what :meth:`wait_for_epoch` waits on."""
        self.epoch = int(epoch)
        self.beat_once()

    def peer_epochs(self, expected: Sequence[int]) -> dict:
        """Last advertised attempt epoch per peer (-1: no or unreadable
        beacon)."""
        out = {}
        for pid in expected:
            try:
                with open(self._path(pid)) as f:
                    out[pid] = int(json.load(f).get("epoch", -1))
            except (OSError, ValueError):
                out[pid] = -1
        return out

    def wait_for_epoch(self, expected: Sequence[int], epoch: int,
                       timeout_seconds: float = 30.0,
                       poll_seconds: Optional[float] = None) -> list:
        """Block until every expected peer advertises ``epoch`` or newer;
        returns the laggards (empty: the barrier passed). A peer wedged in
        the previous attempt's collective never advances its epoch, so the
        caller fails fast instead of retrying alone."""
        poll = self.interval_seconds if poll_seconds is None else poll_seconds
        deadline = time.monotonic() + timeout_seconds
        while True:
            laggards = [p for p, e in self.peer_epochs(expected).items()
                        if e < epoch]
            if not laggards or time.monotonic() >= deadline:
                return laggards
            time.sleep(poll)

    def start(self) -> "Heartbeat":
        if self._thread is not None:
            return self
        self.beat_once()
        self._stop = threading.Event()
        map_watch = MapCountWatchdog()
        install_map_count_gauge()
        mem_guard = self.memory_guard
        if mem_guard == "auto":
            from photon_tpu_torch.runtime.memory_guard import guard

            mem_guard = guard()

        def loop():
            while not self._stop.wait(self.interval_seconds):
                try:
                    self.beat_once()
                except OSError:
                    pass  # a filesystem hiccup; the next beat retries
                try:
                    self.export_peer_gauges()
                except Exception:  # noqa: BLE001 - gauge export must
                    pass  # never take the liveness beacon down with it
                map_watch.check()
                if mem_guard is not None:
                    try:
                        mem_guard.check()
                    except Exception:  # noqa: BLE001 - the watchdog must
                        pass  # never take the liveness beacon down with it
                if self.slo_watchdog is not None:
                    try:
                        self.slo_watchdog.check()
                    except Exception:  # noqa: BLE001 - SLO judgment must
                        pass  # never take the liveness beacon down with it

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="photon-heartbeat")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def export_peer_gauges(self, expected: Optional[Sequence[int]] = None) -> None:
        """Export ``host_beacon_age_seconds{host=...}`` for each expected
        peer (default the ``peer_gauges`` set; nothing when unset), judged
        against this process's own beacon mtime; a host with no beacon
        file exports -1."""
        expected = self.peer_gauges if expected is None else expected
        if not expected:
            return
        from photon_tpu_torch.obs.metrics import REGISTRY

        gauge = REGISTRY.gauge(
            "host_beacon_age_seconds",
            "Seconds since each expected host's last liveness beacon "
            "(-1: no beacon file); a frozen, climbing age is a dead host",
        )
        try:
            now = os.path.getmtime(self._path(self.process_id))
        except OSError:
            now = time.time()
        for pid in expected:
            try:
                age = max(0.0, now - os.path.getmtime(self._path(pid)))
            except OSError:
                age = -1.0
            gauge.set(age, host=str(pid))

    def watchdog(self, expected: Sequence[int], **kwargs) -> "PeerWatchdog":
        """A :class:`PeerWatchdog` over this beacon."""
        return PeerWatchdog(self, expected, **kwargs)

    def check_peers(self, expected: Sequence[int],
                    max_age_seconds: Optional[float] = None) -> PeerReport:
        """Classify each expected process id by beacon freshness (default
        3x the interval), judged against this process's own beacon mtime
        (the filesystem's clock)."""
        if max_age_seconds is None:
            max_age_seconds = 3.0 * self.interval_seconds
        try:
            now = os.path.getmtime(self._path(self.process_id))
        except OSError:
            now = time.time()
        alive, dead, missing = [], [], []
        for pid in expected:
            try:
                age = now - os.path.getmtime(self._path(pid))
            except OSError:
                missing.append(pid)
                continue
            (alive if age <= max_age_seconds else dead).append(pid)
        return PeerReport(alive=alive, dead=dead, missing=missing)


WATCHDOG_EXIT_CODE = 43  # distinct from restart-budget exits; scheduler-visible


class PeerWatchdog:
    """Live peer monitor that ends a process hung in a collective whose
    peer died.

    Such a collective blocks inside the communication library, where no
    Python exception reaches it, so the retry loop's between-attempts
    ``check_peers`` never runs. This daemon thread checks the peers'
    beacons every ``check_interval_seconds`` while an attempt runs; after
    ``grace_checks`` consecutive unhealthy reports it calls
    ``on_dead(report)``: by default it writes
    ``<dir>/watchdog-abort.host-<id>.json``, logs, and ends the process
    with ``os._exit(WATCHDOG_EXIT_CODE)`` (the main thread will never
    unwind), handing recovery to the scheduler's process restart and the
    checkpoint resume. A peer never seen counts as unhealthy only after
    ``startup_grace_seconds``; one seen and then gone counts at once."""

    def __init__(self, heartbeat: Heartbeat, expected: Sequence[int],
                 check_interval_seconds: Optional[float] = None,
                 max_age_seconds: Optional[float] = None,
                 grace_checks: int = 2, startup_grace_seconds: float = 120.0,
                 on_dead: Optional[Callable[[PeerReport], None]] = None,
                 logger=None):
        self.heartbeat = heartbeat
        self.expected = [int(p) for p in expected]
        self.check_interval_seconds = (heartbeat.interval_seconds
                                       if check_interval_seconds is None
                                       else check_interval_seconds)
        self.max_age_seconds = max_age_seconds
        self.grace_checks = max(1, int(grace_checks))
        self.startup_grace_seconds = startup_grace_seconds
        self.on_dead = on_dead if on_dead is not None else self._abort
        self.logger = logger
        self.fired: Optional[PeerReport] = None
        self._seen: set = set()
        self._stop = None
        self._thread = None

    def _abort(self, report: PeerReport) -> None:
        try:
            payload = {"process_id": self.heartbeat.process_id,
                       "time": time.time(), "dead": report.dead,
                       "missing": report.missing, "alive": report.alive}
            path = os.path.join(
                self.heartbeat.directory,
                f"watchdog-abort.host-{self.heartbeat.process_id}.json")
            with open(path + ".tmp", "w") as f:
                json.dump(payload, f)
            os.replace(path + ".tmp", path)
        except OSError:
            pass  # the exit below is the point; the breadcrumb is best-effort
        if self.logger is not None:
            self.logger.error(
                "peer watchdog: dead=%s missing=%s — aborting for scheduler "
                "restart (exit %d; checkpoint resume fast-forwards)",
                report.dead, report.missing, WATCHDOG_EXIT_CODE)
        os._exit(WATCHDOG_EXIT_CODE)

    def start(self) -> "PeerWatchdog":
        if self._thread is not None:
            return self
        self._stop = threading.Event()
        started = time.monotonic()

        def loop():
            strikes = 0
            while not self._stop.wait(self.check_interval_seconds):
                try:
                    report = self.heartbeat.check_peers(self.expected,
                                                        self.max_age_seconds)
                except OSError:
                    continue  # a filesystem hiccup; the next check retries
                self._seen.update(report.alive)
                self._seen.update(report.dead)  # a stale file was still seen
                in_grace = time.monotonic() - started < self.startup_grace_seconds
                unhealthy = bool(report.dead) or any(
                    (p in self._seen) or not in_grace for p in report.missing)
                strikes = strikes + 1 if unhealthy else 0
                if strikes >= self.grace_checks:
                    self.fired = report
                    self.on_dead(report)
                    return

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="photon-peer-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "PeerWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
