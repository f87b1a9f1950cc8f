"""The closed-loop controller: observe → decide → actuate → journal.

A copy of the JAX package's ``control/controller.py`` (it imports neither
torch nor JAX); ``tests/test_torch_control.py`` compares the code, so edit
both or neither.

One tick (``ControlPolicy.tick_s``):

1. **Observe** every target replica — ``GET /healthz`` (degraded reasons,
   replication watermark), ``GET /metrics`` (batcher queue depth,
   memory watermark, error counters), and one probe ``POST /score`` whose
   round-trip is the tick's latency sample (the server histogram is
   lifetime-cumulative; the probe series is windowed by construction).
2. **Decide** via :class:`~photon_tpu_torch.control.policy.PolicyEngine` — the
   hysteresis / cooldown / budget gates live there, so the controller
   never has to reason about restraint.
3. **Actuate** through :class:`~photon_tpu_torch.control.actions.Levers` — every
   lever is pre-existing machinery (standby+swap, memory shed, tailer
   restart, batcher tune).
4. **Journal** everything to the :class:`ControlLedger` — observation,
   rule, action, outcome — so a chaos drill can prove, from the ledger
   alone, that the loop converged instead of oscillated.

The canary protocol (docs/control.md) runs alongside: the online trainer
publishes waves into a SIDE-CHANNEL delta log tailed only by the canary
replica; this controller owns the MAIN log's writer, so a wave reaches
non-canary replicas only by surviving its soak (probe drift vs a
reference replica + latency/error gates) and being promoted — and a
poisoned wave is rolled back by a pointer move to the base model dir plus
a mainline resync, never having touched the fleet.
"""
from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

from photon_tpu_torch.control.actions import LeverError, Levers, promote_wave
from photon_tpu_torch.control.ledger import ControlLedger
from photon_tpu_torch.control.policy import ControlPolicy, Decision, PolicyEngine
from photon_tpu_torch.obs.metrics import MetricsRegistry
from photon_tpu_torch.replication.log import (
    DeltaLogWriter,
    iter_log,
    log_next_seq,
    pending_records,
)

__all__ = ["ReplicaTarget", "Controller"]


class ReplicaTarget:
    """One replica under control. ``url`` doubles as its ledger identity
    (the router names replicas the same way)."""

    def __init__(self, url: str, canary: bool = False):
        self.url = url.rstrip("/")
        self.canary = bool(canary)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"ReplicaTarget({self.url!r}, canary={self.canary})"


class _CanaryState:
    __slots__ = ("phase", "wave_start", "wave_end", "settle_left",
                 "probes", "records")

    def __init__(self):
        self.phase = "idle"          # idle | settling | soaking
        self.wave_start = 0          # first canary-log seq of the wave
        self.wave_end = 0            # one past the last seq of the wave
        self.settle_left = 0
        self.probes: list[dict] = []
        self.records: list = []


class Controller:
    """Tick loop binding policy to levers for one replica fleet.

    ``probe_rows`` drive both the latency sample and the canary drift
    probe; without them the controller falls back to ``/healthz``
    round-trips for latency and promotes canary waves on health alone
    (journaled as ``drift: null`` so the weaker verdict is visible)."""

    def __init__(
        self,
        policy: ControlPolicy,
        replicas: Sequence[ReplicaTarget],
        ledger: ControlLedger,
        *,
        main_log_path: Optional[str] = None,
        canary_log_path: Optional[str] = None,
        base_model_dir: Optional[str] = None,
        probe_rows: Optional[Sequence[dict]] = None,
        router_url: Optional[str] = None,
        levers: Optional[Levers] = None,
        restart_policy=None,
        logger=None,
        clock=None,
    ):
        self.policy = policy
        self.replicas = list(replicas)
        self.ledger = ledger
        self.main_log_path = main_log_path
        self.canary_log_path = canary_log_path
        self.base_model_dir = base_model_dir
        self.probe_rows = list(probe_rows or ())
        self.router_url = router_url.rstrip("/") if router_url else None
        self.levers = levers or Levers()
        self.logger = logger
        self.engine = PolicyEngine(policy, clock=clock)
        # Restart requests ride the supervisor's own budget contract: at
        # most max_restarts grants per target, paced by the policy's
        # decorrelated-jitter delays (photon_tpu_torch.supervisor.RestartBudget).
        self._restart_policy = restart_policy
        self._restart_budgets: dict = {}
        self.ticks = 0
        self.actions_total = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._canary = _CanaryState()
        self._main_writer: Optional[DeltaLogWriter] = None
        self._canary_next = 0  # first canary-log seq not yet adjudicated

        canaries = [r for r in self.replicas if r.canary]
        if len(canaries) > 1:
            raise ValueError("at most one canary replica")
        self.canary_replica = canaries[0] if canaries else None
        self.reference_replica = next(
            (r for r in self.replicas if not r.canary), None)

        self.metrics = MetricsRegistry()
        self._ticks_c = self.metrics.counter(
            "control_ticks_total", "controller loop iterations")
        self._actions_c = self.metrics.counter(
            "control_actions_total", "lever actuations by action")
        self._suppressed_c = self.metrics.counter(
            "control_suppressed_total",
            "rule firings vetoed by cooldown/budget")
        self._verdicts_c = self.metrics.counter(
            "control_canary_verdicts_total", "canary waves adjudicated")

        if self.canary_replica is not None:
            if not (main_log_path and canary_log_path):
                raise ValueError(
                    "canary control needs main_log_path and canary_log_path")
            if not base_model_dir:
                raise ValueError("canary rollback needs base_model_dir")
            self._main_writer = DeltaLogWriter(main_log_path)
            if self._main_writer.next_seq == 0:
                # The controller owns the main log: the base marker anchors
                # catch-up for replicas booting before any promotion.
                self._main_writer.append_snapshot(
                    base_model_dir, note="canary-control base")
            # Adjudicate only waves published AFTER the controller came up:
            # pre-existing canary-log records were either already promoted
            # by a prior controller incarnation or predate control entirely
            # — re-promoting them would duplicate mainline records.
            self._canary_next = log_next_seq(canary_log_path)

    # ------------------------------------------------------------------
    # observation
    # ------------------------------------------------------------------
    def _observe(self, target: ReplicaTarget) -> Optional[dict]:
        """One tick's signals for ``target``; None when unreachable."""
        signals: dict = {}
        try:
            if self.probe_rows:
                latency_ms, _ = self.levers.score(target.url, self.probe_rows)
            else:
                t0 = time.monotonic()
                self.levers.healthz(target.url)
                latency_ms = (time.monotonic() - t0) * 1e3
            signals["probe_latency_ms"] = latency_ms
            health = self.levers.healthz(target.url)
            metrics = self.levers.metrics(target.url)
        except LeverError as e:
            self.ledger.record(
                "observation", target=target.url, error=str(e)[:200])
            return None
        degraded = health.get("degraded") or []
        signals["tailer_dead"] = (
            1.0 if "replication_tailer_dead" in degraded else 0.0)
        mem = metrics.get("memory") or {}
        if mem.get("watermark") is not None:
            signals["memory_watermark"] = float(mem["watermark"])
        lat = metrics.get("latency") or {}
        if lat.get("p95_ms") is not None:
            signals["latency_p95_ms"] = float(lat["p95_ms"])
        batcher = metrics.get("batcher") or {}
        max_queue = batcher.get("max_queue") or 0
        if max_queue:
            signals["queue_frac"] = (
                float(batcher.get("queued") or 0) / float(max_queue))
        signals["errors"] = float(metrics.get("errors") or 0)
        # Tick-scoped context (not series): autoscaler sizing inputs and
        # the replication watermark for canary settle tracking.
        signals["_max_batch"] = batcher.get("max_batch")
        signals["_max_queue"] = max_queue
        rep = health.get("replication") or {}
        signals["_replication_watermark"] = rep.get("seq_watermark")
        signals["_model_version"] = health.get("model_version")
        signals["_degraded"] = degraded
        return signals

    # ------------------------------------------------------------------
    # actuation
    # ------------------------------------------------------------------
    def _dispatch(self, d: Decision) -> dict:
        if d.action == "standby_swap":
            if not self.base_model_dir:
                raise LeverError("standby_swap needs base_model_dir")
            return self.levers.standby_swap(d.target, self.base_model_dir)
        if d.action == "shed_cache":
            return self.levers.shed_cache(d.target)
        if d.action == "restart_tailer":
            if self._restart_policy is not None:
                from photon_tpu_torch.supervisor import RestartBudget

                budget = self._restart_budgets.get(d.target)
                if budget is None:
                    budget = self._restart_budgets[d.target] = (
                        RestartBudget(self._restart_policy))
                if not budget.allow():
                    raise LeverError(
                        f"restart budget refused ({budget.snapshot()})")
            return self.levers.restart_tailer(d.target)
        if d.action == "scale_batcher":
            return self.levers.tune_batcher(
                d.target, d.params["max_batch"], d.params.get("max_queue"))
        raise LeverError(f"unknown action {d.action!r}")

    def _actuate(self, decisions: Sequence[Decision]) -> None:
        for d in decisions:
            self.ledger.record(
                "rule_fired", rule=d.rule, target=d.target, **d.evidence)
            self.ledger.record(
                "action", action=d.action, target=d.target,
                rule=d.rule, params=d.params)
            self._actions_c.inc(action=d.action)
            self.actions_total += 1
            try:
                outcome = self._dispatch(d)
                self.ledger.record(
                    "action_outcome", action=d.action, target=d.target,
                    rule=d.rule, ok=True,
                    outcome={k: outcome[k] for k in list(outcome)[:6]})
                if self.logger is not None:
                    self.logger.info(
                        "control: %s on %s (%s)", d.action, d.target, d.rule)
            except LeverError as e:
                self.ledger.record(
                    "action_outcome", action=d.action, target=d.target,
                    rule=d.rule, ok=False, error=str(e)[:200])
                if self.logger is not None:
                    self.logger.warning(
                        "control: %s on %s FAILED: %s",
                        d.action, d.target, e)

    def _journal_suppressed(self) -> None:
        for s in self.engine.drain_suppressed():
            self._suppressed_c.inc(reason=s.get("reason", ""))
            if s.get("reason") == "budget" and s.pop("first", False):
                self.ledger.record("budget_exhausted", **s)
            else:
                s.pop("first", None)
                self.ledger.record("action_suppressed", **s)

    # ------------------------------------------------------------------
    # canary protocol
    # ------------------------------------------------------------------
    def _canary_tick(self, canary_signals: Optional[dict]) -> None:
        if self.canary_replica is None:
            return
        cp = self.policy.canary
        st = self._canary
        if st.phase == "idle":
            head = log_next_seq(self.canary_log_path)
            if head <= self._canary_next:
                return
            st.phase = "settling"
            st.wave_start, st.wave_end = self._canary_next, head
            st.settle_left = max(1, cp.settle_ticks)
            st.probes = []
            st.records = pending_records(
                self.canary_log_path, start_seq=st.wave_start,
                end_seq=st.wave_end)
            self.ledger.record(
                "canary_soak_begin", target=self.canary_replica.url,
                wave_start=st.wave_start, wave_end=st.wave_end,
                deltas=sum(1 for r in st.records if r.delta is not None))
            return
        if st.phase == "settling":
            applied = None
            if canary_signals is not None:
                applied = canary_signals.get("_replication_watermark")
            # seq_watermark is the LAST APPLIED log seq; the wave covers
            # [wave_start, wave_end), so the canary has the whole wave
            # once the watermark reaches wave_end - 1.
            if applied is not None and int(applied) >= st.wave_end - 1:
                st.phase = "soaking"
            else:
                st.settle_left -= 1
                if st.settle_left <= 0:
                    # Settle window exhausted: an unobservable canary must
                    # not gate the fleet forever, and a reachable canary
                    # whose watermark never reaches the wave (tailer stuck
                    # or refusing the delta) is itself evidence the wave is
                    # bad. Either way the wave must not promote.
                    self._canary_verdict(
                        False,
                        reason=("canary_unreachable" if applied is None
                                else "canary_stalled"))
                return
        if st.phase != "soaking":
            return
        probe = self._canary_probe(canary_signals)
        st.probes.append(probe)
        self.ledger.record(
            "canary_probe", target=self.canary_replica.url,
            wave_start=st.wave_start, wave_end=st.wave_end, **probe)
        if probe.get("breach"):
            self._canary_verdict(False, reason=probe["breach"])
            return
        if len(st.probes) >= cp.soak_ticks:
            self._canary_verdict(True, reason="soak_complete")

    def _canary_probe(self, canary_signals: Optional[dict]) -> dict:
        """One soak observation: drift vs reference + latency/error gate."""
        cp = self.policy.canary
        out: dict = {"drift": None, "canary_latency_ms": None}
        if canary_signals is None:
            out["breach"] = "canary_unreachable"
            return out
        lat = canary_signals.get("probe_latency_ms")
        out["canary_latency_ms"] = lat
        if lat is not None and lat > cp.max_probe_latency_ms:
            out["breach"] = "canary_latency"
            return out
        if "replication_error" in (canary_signals.get("_degraded") or []):
            out["breach"] = "canary_replication_error"
            return out
        if self.probe_rows and self.reference_replica is not None:
            try:
                _, c = self.levers.score(
                    self.canary_replica.url, self.probe_rows)
                _, r = self.levers.score(
                    self.reference_replica.url, self.probe_rows)
                cs = [float(s) for s in c.get("scores") or []]
                rs = [float(s) for s in r.get("scores") or []]
                if cs and len(cs) == len(rs):
                    drift = sum(
                        abs(a - b) for a, b in zip(cs, rs)) / len(cs)
                    out["drift"] = round(drift, 6)
                    if drift > cp.drift_threshold:
                        out["breach"] = "score_drift"
            except LeverError as e:
                out["breach"] = f"probe_error:{str(e)[:120]}"
        return out

    def _canary_verdict(self, promote: bool, reason: str) -> None:
        st = self._canary
        canary = self.canary_replica
        assert canary is not None
        self._verdicts_c.inc(
            verdict="promote" if promote else "rollback")
        if promote:
            seqs = promote_wave(self._main_writer, st.records)
            self.ledger.record(
                "canary_promote", target=canary.url, reason=reason,
                wave_start=st.wave_start, wave_end=st.wave_end,
                main_seqs=seqs, probes=len(st.probes))
            if self.logger is not None:
                self.logger.info(
                    "canary wave [%d,%d) promoted -> main seqs %s",
                    st.wave_start, st.wave_end, seqs)
        else:
            self.ledger.record(
                "canary_rollback", target=canary.url, reason=reason,
                wave_start=st.wave_start, wave_end=st.wave_end,
                probes=len(st.probes))
            if self.logger is not None:
                self.logger.warning(
                    "canary wave [%d,%d) ROLLED BACK (%s)",
                    st.wave_start, st.wave_end, reason)
            try:
                self.levers.standby_swap(canary.url, self.base_model_dir)
                resynced = self._resync_canary(canary.url)
                self.ledger.record(
                    "canary_resync", target=canary.url, ok=True,
                    deltas=resynced)
            except LeverError as e:
                self.ledger.record(
                    "canary_resync", target=canary.url, ok=False,
                    error=str(e)[:200])
        self._canary_next = st.wave_end
        st.phase = "idle"
        st.probes = []
        st.records = []

    def _resync_canary(self, url: str) -> int:
        """Re-feed the promoted mainline deltas to the rolled-back canary.

        The swap built a fresh version from the base model dir, dropping
        BOTH the poisoned wave and every previously promoted delta; the
        mainline log is the durable record of the latter, so replaying it
        over HTTP restores the canary to exactly the fleet's state. No
        idempotency keys here: these ARE intentional re-applications."""
        n = 0
        for rec in iter_log(self.main_log_path, start_seq=0):
            if rec.delta is None:
                continue
            self.levers.post_patch(url, rec.delta.to_wire(),
                                   trace_id=rec.trace_id)
            n += 1
        return n

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------
    def tick(self) -> dict:
        """One observe→decide→actuate→journal pass. Returns a summary the
        driver logs (and tests assert on)."""
        self.ticks += 1
        self._ticks_c.inc()
        summary: dict = {"tick": self.ticks, "decisions": 0}
        canary_signals: Optional[dict] = None
        for target in self.replicas:
            signals = self._observe(target)
            if target.canary:
                canary_signals = signals
            if signals is None:
                continue
            series_signals = {
                k: v for k, v in signals.items() if not k.startswith("_")}
            self.engine.observe(target.url, series_signals)
            # The canary soaks in isolation: anomaly rules still watch it
            # (a dead tailer on the canary matters) but the autoscaler
            # only tunes traffic-bearing replicas.
            context = {
                "max_batch": None if target.canary
                else signals.get("_max_batch"),
                "max_queue": signals.get("_max_queue"),
            }
            decisions = self.engine.decide(target.url, context)
            if decisions:
                self.ledger.record(
                    "observation", target=target.url, **{
                        k: (round(v, 4) if isinstance(v, float) else v)
                        for k, v in series_signals.items()})
            self._actuate(decisions)
            summary["decisions"] += len(decisions)
        self._journal_suppressed()
        self._canary_tick(canary_signals)
        summary["canary_phase"] = self._canary.phase
        return summary

    def run(self, max_ticks: Optional[int] = None,
            stop: Optional[threading.Event] = None) -> dict:
        stop = stop or self._stop
        self.ledger.record(
            "controller_started", policy_digest=self.policy.digest(),
            tick_s=self.policy.tick_s,
            replicas=[r.url for r in self.replicas],
            canary=(self.canary_replica.url
                    if self.canary_replica else None))
        try:
            while not stop.is_set():
                t0 = time.monotonic()
                self.tick()
                if max_ticks is not None and self.ticks >= max_ticks:
                    break
                elapsed = time.monotonic() - t0
                stop.wait(max(0.0, self.policy.tick_s - elapsed))
        finally:
            self.ledger.record(
                "controller_stopped", ticks=self.ticks,
                actions=self.actions_total)
            if self._main_writer is not None:
                self._main_writer.close()
        return {"ticks": self.ticks}

    def start(self, max_ticks: Optional[int] = None) -> None:
        self._thread = threading.Thread(
            target=self.run, kwargs={"max_ticks": max_ticks},
            name="photon-control", daemon=True)
        self._thread.start()

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
