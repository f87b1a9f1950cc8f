"""Declarative control policies + the damped decision engine.

A copy of the JAX package's ``control/policy.py`` (it imports neither
torch nor JAX); ``tests/test_torch_control.py`` compares the code, so edit
both or neither.

The policy layer answers one question per tick, per target: *given the
observed signal series, which lever (if any) fires now?* — and answers it
with three structural damping guarantees (docs/control.md) instead of
tuning folklore:

1. **Hysteresis bands.** A rule acts only when its signal sits beyond a
   threshold for ``min_run`` consecutive ticks, and the opposite action
   needs the signal beyond a *different* (lower/higher) threshold — a
   single noisy sample can never flap a lever, because the band between
   ``low`` and ``high`` is a dead zone by construction.
2. **Per-lever cooldown.** Cooldowns are keyed by ``(lever, target)`` and
   shared by BOTH directions of a lever, so a reversal within the cooldown
   window is structurally impossible, not merely unlikely — the property
   the chaos drill asserts from the ledger.
3. **Budgets.** Every rule carries an action budget for the run; an
   exhausted budget suppresses the rule (journaled once), bounding the
   worst case of a pathological signal at a constant number of actions.

The engine itself (:class:`PolicyEngine`) is pure observation-in /
decision-out: no HTTP, no threads, injectable clock — the controller owns
actuation, the engine owns restraint, and tests drive the engine with
synthetic series to prove the damping claims without a fleet.

Level-shift detection reuses the fleet report's
:func:`~photon_tpu_torch.obs.analysis.report.robust_scores` /
``detect_level_shifts`` detector on the controller's OWN per-tick
probe latencies — the serving ``/metrics`` histogram is lifetime-
cumulative, so an 8× shift would take thousands of samples to move its
p95, while the probe series shifts on the very next tick.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from collections import deque
from typing import Callable, Optional, Sequence

from photon_tpu_torch.obs.analysis.report import detect_level_shifts

__all__ = [
    "Rule",
    "CanaryPolicy",
    "AutoscalePolicy",
    "ControlPolicy",
    "Decision",
    "PolicyEngine",
]

# Signals the engine understands (observation dict keys). The controller
# populates what it can each tick; rules referencing an absent signal
# simply do not fire that tick.
KNOWN_SIGNALS = (
    "probe_latency_ms",   # controller's own /score round-trip this tick
    "latency_p95_ms",     # server-reported lifetime p95 (context only)
    "memory_watermark",   # device-memory high-water fraction [0, 1]
    "tailer_dead",        # 1.0 when healthz says replication_tailer_dead
    "queue_frac",         # batcher queued / max_queue [0, 1]
    "errors",             # server error counter (cumulative)
)

_KINDS = ("level_shift", "threshold", "flag")
_ACTIONS = ("standby_swap", "shed_cache", "restart_tailer", "scale_batcher")


@dataclasses.dataclass(frozen=True)
class Rule:
    """One anomaly→action binding.

    ``kind`` selects the predicate: ``level_shift`` runs the robust
    z-score detector over the signal series; ``threshold`` requires the
    last ``min_run`` samples at/above ``high`` (and, when ``trend_ticks``
    is set, a rising trend across that many ticks — the memory rule fires
    on trajectory, before the OOM ladder would); ``flag`` requires the
    signal truthy for ``min_run`` consecutive ticks (tailer death)."""

    name: str
    signal: str
    kind: str
    action: str
    high: float = 0.0
    min_run: int = 2
    trend_ticks: int = 0
    z_threshold: float = 6.0
    window: int = 8
    min_history: int = 4
    cooldown_s: float = 30.0
    budget: Optional[int] = 3

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown rule kind {self.kind!r}")
        if self.action not in _ACTIONS:
            raise ValueError(f"unknown rule action {self.action!r}")
        if self.signal not in KNOWN_SIGNALS:
            raise ValueError(f"unknown rule signal {self.signal!r}")
        if self.min_run < 1:
            raise ValueError("min_run must be >= 1")

    def to_dict(self) -> dict:
        # Keep None values: budget=None means UNLIMITED and must survive a
        # JSON round-trip (dropping it would resurrect the default budget
        # and silently change the policy digest).
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Rule":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class CanaryPolicy:
    """Canary wave verdict thresholds (docs/control.md §canary protocol).

    ``soak_ticks`` probes must pass before promotion; any single probe
    breaching ``drift_threshold`` (mean |canary − reference| score delta)
    or ``max_probe_latency_ms`` rolls the wave back immediately — a
    poisoned delta should not get to finish its soak."""

    soak_ticks: int = 3
    drift_threshold: float = 0.25
    max_probe_latency_ms: float = 2000.0
    settle_ticks: int = 2  # ticks to wait for the canary to apply a wave

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "CanaryPolicy":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Damped micro-batcher sizing from the measured saturation point.

    Scale UP (``max_batch`` ×2, queue re-derived) only when admission
    pressure is high (``queue_frac >= queue_high`` for ``min_run`` ticks)
    AND latency still has headroom below the knee — batching more when
    already past saturation would worsen the very latency the queue depth
    is complaining about. Scale DOWN (÷2) only when latency sits above the
    knee while the queue is shallow (``queue_frac <= queue_low``) — the
    batch itself is the bottleneck. Between the bands: do nothing. Both
    directions share one ``(scale_batcher, target)`` cooldown."""

    queue_high: float = 0.75
    queue_low: float = 0.25
    knee_latency_ms: float = 250.0
    min_run: int = 2
    max_batch_floor: int = 8
    max_batch_ceiling: int = 4096
    queue_per_batch: int = 4  # max_queue follows max_batch at this ratio
    cooldown_s: float = 20.0
    budget: Optional[int] = 6

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "AutoscalePolicy":
        return cls(**d)


def _default_rules() -> tuple:
    return (
        # 8× latency level shift ⇒ pre-warm standby + swap (the standby lever).
        Rule(name="latency_shift", signal="probe_latency_ms",
             kind="level_shift", action="standby_swap",
             z_threshold=6.0, window=8, min_history=4, min_run=2,
             cooldown_s=30.0, budget=2),
        # Memory watermark trend ⇒ proactive shed before the OOM ladder.
        Rule(name="memory_trend", signal="memory_watermark",
             kind="threshold", action="shed_cache",
             high=0.75, min_run=2, trend_ticks=3,
             cooldown_s=15.0, budget=4),
        # Dead replication tailer ⇒ journaled restart request, budgeted
        # like the supervisor's own restart policy (max_restarts).
        Rule(name="tailer_dead", signal="tailer_dead",
             kind="flag", action="restart_tailer",
             min_run=2, cooldown_s=10.0, budget=3),
    )


@dataclasses.dataclass(frozen=True)
class ControlPolicy:
    """The whole declarative policy: tick cadence + three rule families.

    JSON round-trips (``to_json``/``from_file``) so the control driver can
    run an operator-authored policy via ``--policy``; :meth:`digest` stamps
    the ledger's ``controller_started`` row so a drill's decisions are
    attributable to the exact policy that made them."""

    tick_s: float = 1.0
    rules: Sequence[Rule] = dataclasses.field(default_factory=_default_rules)
    canary: CanaryPolicy = dataclasses.field(default_factory=CanaryPolicy)
    autoscale: Optional[AutoscalePolicy] = dataclasses.field(
        default_factory=AutoscalePolicy)
    max_actions_per_tick: int = 4

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {names}")

    def to_dict(self) -> dict:
        return {
            "tick_s": self.tick_s,
            "max_actions_per_tick": self.max_actions_per_tick,
            "rules": [r.to_dict() for r in self.rules],
            "canary": self.canary.to_dict(),
            "autoscale": (None if self.autoscale is None
                          else self.autoscale.to_dict()),
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    def digest(self) -> str:
        return hashlib.sha256(
            json.dumps(self.to_dict(), sort_keys=True).encode()
        ).hexdigest()[:12]

    @classmethod
    def from_dict(cls, d: dict) -> "ControlPolicy":
        kw: dict = {}
        if "tick_s" in d:
            kw["tick_s"] = float(d["tick_s"])
        if "max_actions_per_tick" in d:
            kw["max_actions_per_tick"] = int(d["max_actions_per_tick"])
        if "rules" in d:
            kw["rules"] = tuple(Rule.from_dict(r) for r in d["rules"])
        if "canary" in d:
            kw["canary"] = CanaryPolicy.from_dict(d["canary"])
        if "autoscale" in d:
            kw["autoscale"] = (None if d["autoscale"] is None
                               else AutoscalePolicy.from_dict(d["autoscale"]))
        return cls(**kw)

    @classmethod
    def from_json(cls, text: str) -> "ControlPolicy":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_file(cls, path: str) -> "ControlPolicy":
        with open(path) as f:
            return cls.from_json(f.read())


@dataclasses.dataclass(frozen=True)
class Decision:
    """One actuation the engine is asking the controller to perform."""

    rule: str
    action: str
    target: str
    params: dict
    evidence: dict


class _RuleState:
    __slots__ = ("spent", "budget_logged")

    def __init__(self):
        self.spent = 0
        self.budget_logged = False


class PolicyEngine:
    """Observation-in / decision-out evaluator with the damping state.

    Feed one :meth:`observe` per (tick, target) and collect decisions.
    ``clock`` is injectable (monotonic seconds) so tests prove cooldown
    semantics without sleeping."""

    def __init__(self, policy: ControlPolicy,
                 clock: Optional[Callable[[], float]] = None):
        import time as _time

        self.policy = policy
        self._clock = clock or _time.monotonic
        # (signal, target) -> series of samples, newest last. Window keeps
        # level-shift history plus slack; deque bounds memory for days-long
        # loops.
        self._series: dict[tuple[str, str], deque] = {}
        # (lever, target) -> monotonic stamp of the last actuation. Keyed
        # by LEVER, not rule/direction — the no-reversal-in-cooldown
        # guarantee lives here.
        self._cooldowns: dict[tuple[str, str], float] = {}
        self._rule_state: dict[str, _RuleState] = {}
        self.suppressed: list[dict] = []   # drained by the controller

    # -- observation intake ------------------------------------------------
    def observe(self, target: str, signals: dict) -> None:
        for name, value in signals.items():
            if value is None:
                continue
            key = (name, target)
            series = self._series.get(key)
            if series is None:
                depth = 4 * max(
                    [r.window for r in self.policy.rules] or [8]) + 8
                series = self._series[key] = deque(maxlen=depth)
            series.append(float(value))

    def series(self, signal: str, target: str) -> list[float]:
        return list(self._series.get((signal, target), ()))

    # -- damping primitives ------------------------------------------------
    def _cooldown_remaining(self, lever: str, target: str,
                            cooldown_s: float) -> float:
        stamp = self._cooldowns.get((lever, target))
        if stamp is None:
            return 0.0
        return max(0.0, cooldown_s - (self._clock() - stamp))

    def _note_actuated(self, lever: str, target: str) -> None:
        self._cooldowns[(lever, target)] = self._clock()

    def _admit(self, rule_name: str, lever: str, target: str,
               cooldown_s: float, budget: Optional[int],
               evidence: dict) -> bool:
        """Cooldown + budget gate; False records a suppression."""
        state = self._rule_state.setdefault(rule_name, _RuleState())
        remaining = self._cooldown_remaining(lever, target, cooldown_s)
        if remaining > 0:
            self.suppressed.append({
                "rule": rule_name, "target": target, "reason": "cooldown",
                "cooldown_remaining_s": round(remaining, 3), **evidence})
            return False
        if budget is not None and state.spent >= budget:
            self.suppressed.append({
                "rule": rule_name, "target": target, "reason": "budget",
                "budget": budget, "first": not state.budget_logged,
                **evidence})
            state.budget_logged = True
            return False
        state.spent += 1
        self._note_actuated(lever, target)
        return True

    # -- predicates --------------------------------------------------------
    def _predicate(self, rule: Rule, target: str) -> Optional[dict]:
        """Evidence dict when the rule's condition holds NOW, else None."""
        series = self.series(rule.signal, target)
        if not series:
            return None
        if rule.kind == "flag":
            tail = series[-rule.min_run:]
            if len(tail) >= rule.min_run and all(v >= 1.0 for v in tail):
                return {"signal": rule.signal, "run": len(tail)}
            return None
        if rule.kind == "threshold":
            tail = series[-rule.min_run:]
            if len(tail) < rule.min_run or not all(
                    v >= rule.high for v in tail):
                return None
            if rule.trend_ticks > 1:
                trend = series[-rule.trend_ticks:]
                if len(trend) < rule.trend_ticks or trend[-1] <= trend[0]:
                    return None  # level high but not rising: not a ramp
            return {"signal": rule.signal, "value": series[-1],
                    "high": rule.high}
        # level_shift: shift must be live at the series edge — a shift that
        # detected ticks ago and re-baselined is history, not a condition.
        shifts = detect_level_shifts(
            series, window=rule.window, z_threshold=rule.z_threshold,
            min_history=rule.min_history, min_run=rule.min_run)
        live = [s for s in shifts if s["index"] == len(series) - 1]
        if not live:
            return None
        s = live[0]
        return {"signal": rule.signal, "value": s["value"],
                "median": s["median"], "z": s["z"]}

    # -- evaluation --------------------------------------------------------
    def decide(self, target: str, signals: dict) -> list[Decision]:
        """Evaluate every rule family for ``target`` this tick.

        ``signals`` carries tick-scoped context the series don't (current
        ``max_batch``/``max_queue`` for the autoscaler)."""
        decisions: list[Decision] = []
        for rule in self.policy.rules:
            evidence = self._predicate(rule, target)
            if evidence is None:
                continue
            if not self._admit(rule.name, rule.action, target,
                               rule.cooldown_s, rule.budget, evidence):
                continue
            params: dict = {}
            decisions.append(Decision(
                rule=rule.name, action=rule.action, target=target,
                params=params, evidence=evidence))
        auto = self._decide_autoscale(target, signals)
        if auto is not None:
            decisions.append(auto)
        return decisions[: self.policy.max_actions_per_tick]

    def _decide_autoscale(self, target: str,
                          signals: dict) -> Optional[Decision]:
        ap = self.policy.autoscale
        if ap is None:
            return None
        max_batch = signals.get("max_batch")
        if not max_batch:
            return None
        queue = self.series("queue_frac", target)
        lat = self.series("probe_latency_ms", target)
        if len(queue) < ap.min_run or len(lat) < ap.min_run:
            return None
        q_tail = queue[-ap.min_run:]
        l_tail = lat[-ap.min_run:]
        max_batch = int(max_batch)
        new_batch = None
        direction = None
        if (all(q >= ap.queue_high for q in q_tail)
                and all(l < ap.knee_latency_ms for l in l_tail)
                and max_batch < ap.max_batch_ceiling):
            new_batch = min(max_batch * 2, ap.max_batch_ceiling)
            direction = "up"
        elif (all(q <= ap.queue_low for q in q_tail)
                and all(l >= ap.knee_latency_ms for l in l_tail)
                and max_batch > ap.max_batch_floor):
            new_batch = max(max_batch // 2, ap.max_batch_floor)
            direction = "down"
        if new_batch is None or new_batch == max_batch:
            return None
        evidence = {
            "queue_frac": q_tail[-1], "probe_latency_ms": l_tail[-1],
            "direction": direction, "max_batch": max_batch,
        }
        if not self._admit("autoscale", "scale_batcher", target,
                           ap.cooldown_s, ap.budget, evidence):
            return None
        new_queue = new_batch * ap.queue_per_batch
        return Decision(
            rule="autoscale", action="scale_batcher", target=target,
            params={"max_batch": new_batch, "max_queue": new_queue},
            evidence=evidence)

    def drain_suppressed(self) -> list[dict]:
        out, self.suppressed = self.suppressed, []
        return out
