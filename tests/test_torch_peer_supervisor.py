"""The supervisor's peer half in the port (``photon_tpu_torch/supervisor.py``)
and the GAME driver's attempt guards, with real OS processes on the CPU.

The peer cases of ``tests/test_supervisor.py``, each with its peer a
separate interpreter where the JAX test uses a second object or a thread:
beacon freshness, the attempt-epoch barrier, the tolerated corrupt beacon,
the beacon-age gauges, the live ``PeerWatchdog`` (its default abort ends a
process blocked in its main thread with exit 43 and a breadcrumb file; a
never-seen peer is forgiven inside the startup grace), and the driver's
dead-peer check and epoch barrier before a retry. Then two ranks of the GAME
driver over gloo: rank 1 fails its first attempt and retries alone while
rank 0 waits in the fixed effect's fold; the epoch barrier stops rank 1
instead of letting it hang. Times are the JAX tests' (beats of 0.05 s,
staleness 0.3-0.4 s); every process has a ``timeout``.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time

import pytest

from photon_tpu_torch import supervisor as sup
from photon_tpu_torch.supervisor import (
    WATCHDOG_EXIT_CODE,
    Heartbeat,
    PeerWatchdog,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": REPO}

# A peer process: beacon ``pid`` in ``dir`` every ``interval`` at attempt
# ``epoch``, for ``seconds`` (then it ends, its beacon going stale), or
# pinned there until killed.
_PEER = r"""
import sys, time
from photon_tpu_torch.supervisor import Heartbeat
d, pid, interval, epoch, seconds = sys.argv[1:6]
hb = Heartbeat(d, process_id=int(pid), interval_seconds=float(interval),
               memory_guard=None)
hb.set_epoch(int(epoch))
hb.start()
print("up", flush=True)
time.sleep(float(seconds))
hb.stop()
"""


def _peer(hdir, pid: int, interval=0.05, epoch=0, seconds=60.0):
    """A live peer process; returns once its first beacon is written."""
    p = subprocess.Popen([sys.executable, "-c", _PEER, str(hdir), str(pid),
                          str(interval), str(epoch), str(seconds)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=ENV)
    assert p.stdout.readline().strip() == "up", p.stderr.read()
    return p


def _end(p) -> None:
    if p.poll() is None:
        p.kill()
    p.communicate(timeout=30)


def test_heartbeat_detects_stale_and_missing(tmp_path):
    hdir = str(tmp_path / "hb")
    me = Heartbeat(hdir, process_id=0, interval_seconds=0.05, memory_guard=None)
    me.beat_once()
    peer = _peer(hdir, 1, seconds=0.0)
    peer.communicate(timeout=30)
    report = me.check_peers([0, 1, 2], max_age_seconds=10.0)
    assert report.alive == [0, 1] and report.missing == [2]
    assert not report.healthy
    old = time.time() - 60.0
    os.utime(os.path.join(hdir, "host-1.hb"), (old, old))
    report = me.check_peers([0, 1], max_age_seconds=1.0)
    assert report.alive == [0] and report.dead == [1]


def test_attempt_epoch_barrier(tmp_path):
    """A peer pinned in an earlier attempt is a laggard; a peer process that
    advances passes the barrier before the timeout."""
    hdir = str(tmp_path / "hb")
    me = Heartbeat(hdir, process_id=0, interval_seconds=0.05, memory_guard=None)
    me.set_epoch(1)
    stuck = _peer(hdir, 1, epoch=0)
    try:
        assert me.wait_for_epoch([0, 1], 1, timeout_seconds=0.3,
                                 poll_seconds=0.05) == [1]
    finally:
        _end(stuck)
    advanced = []

    def advance():
        time.sleep(0.2)
        advanced.append(_peer(hdir, 1, epoch=1))

    t = threading.Thread(target=advance)
    t.start()
    try:
        assert me.wait_for_epoch([0, 1], 1, timeout_seconds=30.0,
                                 poll_seconds=0.05) == []
        t.join(timeout=30)
        assert not t.is_alive()
        assert me.peer_epochs([0, 1]) == {0: 1, 1: 1}
    finally:
        t.join(timeout=30)
        for p in advanced:
            _end(p)


def test_peer_epochs_tolerates_corrupt_and_missing(tmp_path):
    hdir = str(tmp_path / "hb")
    me = Heartbeat(hdir, process_id=0, interval_seconds=0.05, memory_guard=None)
    me.set_epoch(2)
    with open(os.path.join(hdir, "host-1.hb"), "w") as f:
        f.write("{torn json")
    assert me.peer_epochs([0, 1, 2]) == {0: 2, 1: -1, 2: -1}
    assert me.wait_for_epoch([0, 1], 1, timeout_seconds=0.2,
                             poll_seconds=0.05) == [1]


def test_export_peer_gauges(tmp_path):
    from photon_tpu_torch.obs.metrics import REGISTRY

    hdir = str(tmp_path / "hb")
    hb = Heartbeat(hdir, process_id=0, memory_guard=None, peer_gauges=[0, 1, 2])
    hb.beat_once()
    peer = _peer(hdir, 1, seconds=0.0)
    peer.communicate(timeout=30)
    hb.export_peer_gauges()
    snap = REGISTRY.snapshot()["host_beacon_age_seconds"]
    assert 0.0 <= snap["0"] < 5.0 and 0.0 <= snap["1"] < 30.0
    assert snap["2"] == -1.0            # never beaconed: the sentinel, not 0


def test_watchdog_fires_on_a_killed_peer(tmp_path):
    """A peer process killed mid-"collective": the watchdog's thread reports
    it dead while the main thread still waits."""
    hdir = str(tmp_path / "hb")
    me = Heartbeat(hdir, process_id=0, interval_seconds=0.05,
                   memory_guard=None).start()
    peer = _peer(hdir, 1)
    hung, reports = threading.Event(), []

    def on_dead(report):
        reports.append(report)
        hung.set()

    wd = PeerWatchdog(me, expected=[0, 1], check_interval_seconds=0.05,
                      max_age_seconds=0.4, grace_checks=2, on_dead=on_dead).start()
    try:
        assert not hung.wait(0.5)       # healthy while both beat
        peer.kill()
        t0 = time.monotonic()
        assert hung.wait(5.0), "the watchdog never fired on a dead peer"
        assert time.monotonic() - t0 < 5.0
        assert reports[0].dead == [1] and wd.fired is not None
    finally:
        wd.stop()
        me.stop()
        _end(peer)


def test_watchdog_default_abort_hard_exits_process(tmp_path):
    hdir = str(tmp_path / "hb")
    code = f"""
import time
from photon_tpu_torch.supervisor import Heartbeat, PeerWatchdog
me = Heartbeat({hdir!r}, process_id=0, interval_seconds=0.05, memory_guard=None).start()
Heartbeat({hdir!r}, process_id=1, interval_seconds=0.05, memory_guard=None).beat_once()
PeerWatchdog(me, [0, 1], check_interval_seconds=0.05, max_age_seconds=0.3,
             grace_checks=2).start()
time.sleep(60)  # a hung collective's stand-in: the watchdog ends us first
"""
    p = subprocess.run([sys.executable, "-c", code], env=ENV, timeout=60,
                       capture_output=True, text=True)
    assert p.returncode == WATCHDOG_EXIT_CODE == 43, (p.returncode, p.stderr[-500:])
    with open(os.path.join(hdir, "watchdog-abort.host-0.json")) as f:
        assert json.load(f)["dead"] == [1]


def test_watchdog_startup_grace_for_never_seen_peers(tmp_path):
    hdir = str(tmp_path / "hb")
    me = Heartbeat(hdir, process_id=0, interval_seconds=0.05,
                   memory_guard=None).start()
    fired = threading.Event()
    wd = PeerWatchdog(me, expected=[0, 1], check_interval_seconds=0.05,
                      max_age_seconds=0.4, grace_checks=2,
                      startup_grace_seconds=600.0,
                      on_dead=lambda r: fired.set()).start()
    try:
        assert not fired.wait(0.6), "fired on a never-seen peer inside the grace"
        peer = _peer(hdir, 1, seconds=0.0)
        peer.communicate(timeout=30)
        time.sleep(0.2)                 # the watchdog sees it alive
        os.remove(os.path.join(hdir, "host-1.hb"))
        assert fired.wait(5.0), "did not fire on a vanished peer"
        assert wd.fired is not None and wd.fired.missing == [1]
    finally:
        wd.stop()
        me.stop()


# ------------------------------------------------------------ the driver


@pytest.fixture
def game_avro(tmp_path):
    from test_torch_scoring_driver import _write_game_avro

    d = tmp_path / "data"
    d.mkdir()
    _write_game_avro(d / "train.avro", seed=1, n_users=4, rows_per_user=12)
    return d / "train.avro"


def _driver_args(data, out, hdir):
    return ["--train-data", str(data), "--output-dir", str(out),
            "--task", "LOGISTIC_REGRESSION", "--feature-shard", "global:features",
            "--coordinate",
            "fixed:type=fixed,shard=global,reg=L2,max_iter=5,reg_weights=1",
            "--max-restarts", "3", "--restart-backoff", "0",
            "--heartbeat-dir", str(hdir), "--device", "cpu"]


@pytest.fixture
def two_process_job(monkeypatch):
    """The driver believes it is one of 2 processes; its live watchdog,
    whose default hard-exits, is neutralized (the abort has its own test)."""
    from photon_tpu_torch.parallel import distributed as pd

    class _NoopWatchdog:
        def start(self):
            return self

        def stop(self):
            pass

    monkeypatch.setattr(pd, "process_count", lambda: 2)
    monkeypatch.setattr(sup.Heartbeat, "watchdog",
                        lambda self, *a, **k: _NoopWatchdog())


def _always_fail(monkeypatch):
    from photon_tpu_torch.estimators.game_estimator import GameEstimator

    def fail(self, *a, **kw):
        raise RuntimeError("transient-looking failure")

    monkeypatch.setattr(GameEstimator, "fit", fail)


def test_driver_fails_fast_on_dead_peer(tmp_path, game_avro, monkeypatch,
                                        two_process_job):
    """A retry whose peer process died stops with RestartsUselessError
    instead of re-entering a fit the peer cannot join."""
    from photon_tpu_torch.cli import game_training_driver
    from photon_tpu_torch.cli.game_training_driver import RestartsUselessError

    hdir = tmp_path / "hb"
    _peer(hdir, 1, seconds=0.0).communicate(timeout=30)   # beat once, died
    old = time.time() - 3600
    os.utime(hdir / "host-1.hb", (old, old))
    _always_fail(monkeypatch)
    with pytest.raises(RestartsUselessError, match=r"dead=\[1\]"):
        game_training_driver.run(_driver_args(game_avro, tmp_path / "out", hdir))


def test_driver_epoch_barrier_blocks_lone_retry(tmp_path, game_avro, monkeypatch,
                                                two_process_job):
    """A retry whose peer process beats freshly but stays in attempt 0 (the
    wedged-in-a-collective signature) fails fast at the epoch barrier."""
    from photon_tpu_torch.cli import game_training_driver
    from photon_tpu_torch.cli.game_training_driver import RestartsUselessError

    hdir = tmp_path / "hb"
    peer = _peer(hdir, 1, interval=0.2, epoch=0)
    orig_wait = sup.Heartbeat.wait_for_epoch

    def fast_wait(self, expected, epoch, timeout_seconds=30.0, **kw):
        return orig_wait(self, expected, epoch, timeout_seconds=1.0,
                         poll_seconds=0.1)

    monkeypatch.setattr(sup.Heartbeat, "wait_for_epoch", fast_wait)
    _always_fail(monkeypatch)
    try:
        with pytest.raises(RestartsUselessError, match="attempt epoch"):
            game_training_driver.run(_driver_args(game_avro, tmp_path / "out", hdir))
    finally:
        _end(peer)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gloo_lone_retrier_is_stopped_by_the_epoch_barrier(tmp_path, game_avro):
    """Two ranks of the GAME driver over gloo. Rank 1's first coordinate
    step fails (a fault plan, its own) and it retries; rank 0 waits in the
    fixed effect's fold, beating freshly at attempt 0. Rank 1 passes the
    dead-peer check, then the attempt-epoch barrier stops it: without the
    barrier it would re-enter the fit alone and issue a fold rank 0 never
    joins. Rank 0 then ends too (its watchdog, exit 43, or its own retry's
    dead-peer check): no rank hangs."""
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"seed": 0, "specs": [
        {"site": "descent.step", "error": "runtime", "count": 1}]}))
    hdir = tmp_path / "hb"
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {**ENV, "WORLD_SIZE": "2", "RANK": str(rank),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        argv = _driver_args(game_avro, tmp_path / f"out{rank}", hdir)
        if rank == 1:
            argv += ["--fault-plan", str(plan)]
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "photon_tpu_torch.cli.game_training_driver",
             *argv], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        _, err1 = procs[1].communicate(timeout=180)
        _, err0 = procs[0].communicate(timeout=120)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    assert procs[1].returncode not in (0, None), err1[-2000:]
    assert "RestartsUselessError" in err1 and \
        "never reached attempt epoch 1" in err1, err1[-2000:]
    journal = [json.loads(line) for line in
               (tmp_path / "out1" / "recovery.jsonl").read_text().splitlines()]
    assert [r["event"] for r in journal if r["event"] == "restart"] == ["restart"]
    assert procs[0].returncode != 0, err0[-2000:]
    assert procs[0].returncode == WATCHDOG_EXIT_CODE or \
        "dead=[1]" in err0, (procs[0].returncode, err0[-2000:])
