"""The port's supervisor (``photon_tpu_torch/supervisor.py``) and memory
guard's restart policy against the JAX package's.

* ``RestartPolicy`` gives the JAX delays for the same seed, jittered or
  not, and ``RestartBudget`` grants alike.
* ``run_with_recovery`` and ``RunSupervisor`` retry what JAX retries:
  fatal errors (``ValueError``, ``TypeError``, assertions) and
  ``KeyboardInterrupt`` are not retried; an exhausted budget carries the
  history of every attempt with its classified cause; the journal rows are
  JAX's, event for event.
* An OOM restart is pre-degraded (the sticky random-effect chunk cap one
  blessed tier down, the sweep-cache budget halved), skips the backoff, and
  a second OOM escalates; the port's own rule: a ``device_lost`` failure
  whose CUDA context fails a tiny op is not restarted in-process.
* ``Heartbeat`` writes its beacon file with the attempt epoch in one
  process, its ``heartbeat.beat`` fault point makes it stale, and its loop
  runs the memory watchdog.
"""
import json
import time

import pytest

from photon_tpu import supervisor as js
from photon_tpu.faults import PreemptionError as JaxPreemption
from photon_tpu.runtime import memory_guard as jmg
from photon_tpu_torch import supervisor as ts
from photon_tpu_torch.faults import (
    DeviceLostError,
    DeviceOomError,
    FaultPlan,
    FaultSpec,
    PreemptionError,
    active_plan,
)
from photon_tpu_torch.runtime import backend_guard as bg
from photon_tpu_torch.runtime import memory_guard as mg


@pytest.fixture(autouse=True)
def _fresh():
    mg.reset_state()
    jmg.reset_state()
    yield
    mg.reset_state()
    jmg.reset_state()


@pytest.mark.parametrize("kw", [
    dict(seed=0), dict(seed=7, backoff_seconds=0.5, max_backoff_seconds=4.0),
    dict(jitter=False, backoff_seconds=0.25, backoff_multiplier=3.0,
         max_backoff_seconds=5.0),
])
def test_backoff_delays_equal_jax(kw):
    port, jax = ts.RestartPolicy(**kw).delays(), js.RestartPolicy(**kw).delays()
    assert [next(port) for _ in range(12)] == [next(jax) for _ in range(12)]


def test_restart_budget_grants_as_jax():
    t = [0.0]
    port = ts.RestartBudget(ts.RestartPolicy(max_restarts=3, seed=1), clock=lambda: t[0])
    jax = js.RestartBudget(js.RestartPolicy(max_restarts=3, seed=1), clock=lambda: t[0])
    got = []
    for step in range(40):
        t[0] = step * 0.4
        got.append((port.allow(), jax.allow()))
    assert all(a == b for a, b in got) and sum(a for a, _ in got) == 3
    assert port.snapshot() == jax.snapshot()


def _flaky(errors, log):
    def attempt(i):
        log.append(i)
        if i < len(errors):
            raise errors[i]
        return f"ok@{i}"
    return attempt


@pytest.mark.parametrize("err", [ValueError("bad flag"), TypeError("x"),
                                 AssertionError("y"), KeyboardInterrupt()])
def test_fatal_errors_and_interrupts_are_not_retried(err):
    for mod in (ts, js):
        log = []
        with pytest.raises(type(err)):
            mod.run_with_recovery(_flaky([err], log),
                                  mod.RestartPolicy(max_restarts=3, jitter=False),
                                  sleep=lambda s: None)
        assert log == [0]


def test_exhausted_budget_carries_its_history_as_jax(tmp_path):
    errors = [OSError("disk hiccup"), RuntimeError("CUDA error: unspecified launch "
                                                    "failure"), OSError("again")]
    got = {}
    for name, mod, pre in (("port", ts, PreemptionError), ("jax", js, JaxPreemption)):
        sleeps = []
        with pytest.raises(mod.RestartsExhausted) as ei:
            mod.run_with_recovery(_flaky(errors + [pre("p")], []),
                                  mod.RestartPolicy(max_restarts=2, seed=3),
                                  sleep=sleeps.append)
        got[name] = ([(f.attempt, f.error_type, f.message) for f in ei.value.failures],
                     sleeps, str(ei.value))
    assert got["port"] == got["jax"] and len(got["port"][0]) == 3


def _supervise(mod, tmp_path, name, errors, **kw):
    journal = tmp_path / f"{name}.jsonl"
    sleeps, log = [], []
    sup_kw = {"compile_store": None} if mod is js else {}
    sup = mod.RunSupervisor(mod.RestartPolicy(seed=5, **kw),
                            journal=str(journal), sleep=sleeps.append, **sup_kw)
    try:
        out = sup.run(_flaky(errors, log))
    except BaseException as e:  # noqa: BLE001 - compared below
        out = e
    rows = [json.loads(r) for r in journal.read_text().splitlines()]
    keep = ("event", "attempt", "cause", "will_restart", "backoff_s", "attempts")
    return out, log, sleeps, [{k: r[k] for k in keep if k in r} for r in rows]


@pytest.mark.parametrize("case", ["preemption", "io_then_ok", "exhausted", "fatal"])
def test_run_supervisor_journal_equals_jax(tmp_path, case):
    def errors(pre):
        return {"preemption": [pre("preempted")],
                "io_then_ok": [OSError("nfs"), RuntimeError("INTERNAL: device "
                                                            "was lost")],
                "exhausted": [OSError("a"), OSError("b"), OSError("c")],
                "fatal": [ValueError("config bug")]}[case]

    port = _supervise(ts, tmp_path, "port", errors(PreemptionError), max_restarts=2)
    jax = _supervise(js, tmp_path, "jax", errors(JaxPreemption), max_restarts=2)
    assert port[1:] == jax[1:]
    assert type(port[0]).__name__ == type(jax[0]).__name__
    if case == "exhausted":
        assert port[0].cause == jax[0].cause == "io"
    if case == "preemption":
        assert [r["cause"] for r in port[3] if r["event"] == "restart"] == ["preemption"]


def test_oom_restart_is_predegraded_without_backoff(tmp_path):
    from photon_tpu_torch.game.newton_re import chunk_ladder

    out, log, sleeps, rows = _supervise(ts, tmp_path, "p", [DeviceOomError("x")],
                                        max_restarts=2)
    assert out == "ok@1" and log == [0, 1] and sleeps == []
    events = [r["event"] for r in rows]
    assert events == ["attempt_start", "attempt_failed", "oom_predegrade",
                      "restart", "attempt_start", "run_ok"]
    assert mg.sticky_plan("re.solve") == {"chunk": chunk_ladder()[-1]}
    assert mg.sweep_budget_scale() == 0.5
    # the same in JAX: one restart, no backoff, the same degraded chunk cap
    from photon_tpu.faults import DeviceOomError as JaxOom

    jout, jlog, jsleeps, jrows = _supervise(js, tmp_path, "j", [JaxOom("x")],
                                            max_restarts=2)
    assert (jout, jlog, jsleeps) == (out, log, sleeps)
    assert [r["event"] for r in jrows] == events
    assert jmg.sticky_plan("re.solve") == mg.sticky_plan("re.solve")
    # a second OOM escalates, classified
    mg.reset_state()
    out, *_ = _supervise(ts, tmp_path, "p2", [DeviceOomError("x")] * 2, max_restarts=5)
    assert isinstance(out, ts.RestartsExhausted) and out.cause == "oom"


def test_run_with_recovery_oom_draws_no_delay():
    sleeps = []
    assert ts.run_with_recovery(_flaky([DeviceOomError("x"), OSError("y")], []),
                                ts.RestartPolicy(max_restarts=3, seed=2),
                                sleep=sleeps.append) == "ok@2"
    assert sleeps == [next(ts.RestartPolicy(max_restarts=3, seed=2).delays())]


def test_poisoned_context_is_not_restarted_in_process(tmp_path, monkeypatch):
    monkeypatch.setattr(bg, "context_usable", lambda: False)
    out, log, _, rows = _supervise(
        ts, tmp_path, "p", [RuntimeError("CUDA error: an illegal memory access")],
        max_restarts=3)
    assert isinstance(out, ts.RestartsExhausted) and out.cause == "device_lost"
    assert log == [0]
    assert [r["event"] for r in rows][-2:] == ["context_lost", "exhausted"]
    # an injected loss leaves the context usable: restarted as in JAX
    monkeypatch.setattr(bg, "context_usable", lambda: True)
    out, log, *_ = _supervise(ts, tmp_path, "q", [DeviceLostError("x")], max_restarts=3)
    assert out == "ok@1" and log == [0, 1]


def test_first_step_clock_journals_once(tmp_path):
    journal = ts.RecoveryJournal(str(tmp_path / "j.jsonl"))
    ts.arm_first_step_clock(attempt=1, journal=journal)
    time.sleep(0.01)
    assert ts.note_first_step("descent.step") >= 0.01
    assert ts.note_first_step("descent.step") is None       # disarmed
    (row,) = journal.rows()
    assert row["event"] == "first_step" and row["attempt"] == 1
    assert row["restart_to_first_step_seconds"] >= 0.01


def test_heartbeat_in_one_process(tmp_path):
    calls = []

    class Guard:
        def check(self):
            calls.append(1)
            return {}

    hb = ts.Heartbeat(str(tmp_path / "hb"), interval_seconds=0.05,
                      memory_guard=Guard())
    with hb:
        hb.set_epoch(2)
        time.sleep(0.3)
        beat = json.loads((tmp_path / "hb" / "host-0.hb").read_text())
        assert beat["epoch"] == 2 and beat["beats"] >= 2
        assert hb.check_peers([0]).healthy
        report = hb.check_peers([0, 1])
        assert report.alive == [0] and report.missing == [1]
    assert calls
    with active_plan(FaultPlan(specs=[FaultSpec(site="heartbeat.beat", error="os")])):
        with pytest.raises(OSError):
            hb.beat_once()


def test_map_count_watchdog():
    w = ts.MapCountWatchdog(warn_fraction=1e-9, rewarn_seconds=0.0)
    first = w.check()
    w.rewarn_seconds = 1e9
    second = w.check()
    assert first["maps"] > 0 and first["warned"] and not second["warned"]
    with pytest.raises(ValueError):
        ts.MapCountWatchdog(warn_fraction=0)
