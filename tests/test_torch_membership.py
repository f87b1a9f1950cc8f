"""Elastic mesh membership in the port (``photon_tpu_torch.parallel
.distributed.MeshMembership``) against the JAX package's.

The membership cases of ``tests/test_multihost.py`` (formation, barrier
and part-keyed reduction with an empty shard, the coordinated shrink, the
shrink budget, the beacon gauges, the fleet report's Mesh section, the
file-shard assignment), plus the grow at a step boundary, the all-to-all
exchange and a self-healing eviction. Each scenario runs over threads as
the JAX tests do, once with the port's class and once with the JAX
package's, and the ledger rows (``mesh-epochs.jsonl``) must be equal field
for field, leaving out only the wall stamps (``time``, ``t``), the process
id and the measured beacon ages. The class is a copy: its source equals the
JAX package's with the imports renamed.
"""
from __future__ import annotations

import inspect
import json
import threading
import time

import numpy as np
import pytest

from photon_tpu.parallel import distributed as jax_dist
from photon_tpu_torch.parallel import distributed as port_dist

VOLATILE = {"time", "t", "pid", "beacon_age_seconds"}
BOTH = pytest.mark.parametrize("dist", [port_dist, jax_dist], ids=["port", "jax"])


def _run_hosts(fn, n, timeout=60.0):
    errors = []

    def wrap(h):
        try:
            fn(h)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append((h, e))

    threads = [threading.Thread(target=wrap, args=(h,)) for h in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if errors:
        raise errors[0][1]
    assert not any(t.is_alive() for t in threads), "host thread hung"


def _rows(path) -> list:
    return [json.loads(line) for line in open(path).read().splitlines()]


def _stable(rows) -> list:
    return [{k: v for k, v in r.items() if k not in VOLATILE} for r in rows]


def test_membership_is_a_copy_of_the_jax_class():
    port = inspect.getsource(port_dist.MeshMembership)
    jax = (inspect.getsource(jax_dist.MeshMembership)
           .replace("photon_tpu.", "photon_tpu_torch."))
    assert port == jax
    assert port_dist.EPOCH_EVENTS == jax_dist.EPOCH_EVENTS


# ------------------------------------------------------------- scenarios


def _form_reduce(dist, d, results):
    def host(h):
        mem = dist.MeshMembership(str(d), h, 3, ["a", "b"], beat_seconds=0.1,
                                  stale_factor=30.0, wait_timeout=30.0)
        try:
            mem.start(form_timeout=30.0)
            assert mem.members == [0, 1, 2] and mem.epoch == 0
            payloads = {pid: {"v": np.full(2, float(h) + 1.0)}
                        for pid in mem.my_files()}
            out = mem.reduce_parts("t0", payloads)
            folded = sum(out[p]["v"][0] for p in mem.part_ids)
            mem.barrier("done")
            results[h] = (mem.my_files(), folded)
        finally:
            mem.stop()

    _run_hosts(host, 3)


def _shrink(dist, d, out, max_shrinks=None):
    formed, die = threading.Event(), threading.Event()

    def host(h):
        mem = dist.MeshMembership(str(d), h, 2, ["a", "b"], beat_seconds=0.1,
                                  stale_factor=3.0, wait_timeout=30.0,
                                  max_shrinks=max_shrinks)
        mem.start(form_timeout=30.0)
        if h == 1:              # this host "dies": beacons stop, thread exits
            formed.wait(30.0)
            mem.hb.stop()
            die.set()
            return
        formed.set()
        die.wait(30.0)
        time.sleep(0.5)         # host 1's last beat ages past staleness
        try:
            if max_shrinks == 0:
                with pytest.raises(RuntimeError, match="budget exhausted"):
                    mem.handle_loss([1])
            else:
                mem.handle_loss([1])
            out.update(members=mem.members, files=mem.files, epoch=mem.epoch)
        finally:
            mem.stop()

    _run_hosts(host, 2)


def _grow(dist, d, out):
    """Host 1 leaves (its beacon stops), host 0 shrinks; host 1 comes back
    with a fresh process's membership, requests to join and is admitted at
    host 0's next step boundary; both exchange rows under the new epoch."""
    formed, left, shrunk = threading.Event(), threading.Event(), threading.Event()

    def make(h):
        return dist.MeshMembership(str(d), h, 2, ["a", "b", "c"], beat_seconds=0.1,
                                   stale_factor=3.0, wait_timeout=30.0)

    def host(h):
        mem = make(h)
        mem.start(form_timeout=30.0)
        if h == 1:
            formed.wait(30.0)
            mem.hb.stop()
            left.set()
            shrunk.wait(30.0)
            back = make(1).start()            # rejoins: request + wait
            try:
                got = back.exchange("x", {0: {"v": np.array([1.0])}})
                out["from_0"] = got[0]["v"].tolist()
                back.barrier("after")
                out["rejoined"] = back.rejoined
                out["back_members"] = back.members
            finally:
                back.stop()
            return
        formed.set()
        left.wait(30.0)
        time.sleep(0.5)
        try:
            mem.handle_loss([1])
            shrunk.set()
            deadline = time.monotonic() + 30.0
            while not mem.maybe_grow():
                assert time.monotonic() < deadline, "no rejoin request"
                time.sleep(0.05)
            got = mem.exchange("x", {1: {"v": np.array([0.0, 2.0])}})
            out["from_1"] = got[1]["v"].tolist()
            mem.barrier("after")
            out.update(members=mem.members, files=mem.files, epoch=mem.epoch,
                       sync=mem.sync_epoch())
        finally:
            mem.stop()

    _run_hosts(host, 2)


def _evicted(dist, d, out):
    """A slow host declared dead finds itself outside the newest epoch at
    ``sync_epoch``, requests to rejoin and is admitted."""
    joined, shrunk = threading.Event(), threading.Event()

    def host(h):
        mem = dist.MeshMembership(str(d), h, 2, ["a"], beat_seconds=0.1,
                                  stale_factor=3.0, wait_timeout=30.0)
        mem.start(form_timeout=30.0)
        try:
            if h == 1:
                joined.set()
                shrunk.wait(30.0)
                assert mem.sync_epoch()         # evicted: rejoins
                out["rejoined"] = mem.rejoined
                out["members_1"] = mem.members
                return
            joined.wait(30.0)
            mem._write_epoch("mesh_shrunk", [0], dead=[1])   # a false loss
            shrunk.set()
            deadline = time.monotonic() + 30.0
            while not mem.maybe_grow():
                assert time.monotonic() < deadline, "no rejoin request"
                time.sleep(0.05)
            out["members_0"] = mem.members
        finally:
            mem.stop()

    _run_hosts(host, 2)


@BOTH
def test_form_barrier_reduce_with_empty_shard(tmp_path, dist):
    """3 hosts over 2 parts: the part-less host still barriers and gets
    the full reduction."""
    results = {}
    _form_reduce(dist, tmp_path, results)
    assert results[0][0] == ["a"] and results[1][0] == ["b"]
    assert results[2][0] == []
    assert {r[1] for r in results.values()} == {3.0}


@BOTH
def test_shrink_journals_loss_and_redistributes(tmp_path, dist):
    out = {}
    _shrink(dist, tmp_path, out)
    assert out == {"members": [0], "files": {0: ["a", "b"]}, "epoch": 1}
    rows = _rows(tmp_path / "mesh-epochs.jsonl")
    events = [r["event"] for r in rows]
    assert events[0] == "mesh_formed"
    assert "host_lost" in events and "mesh_shrunk" in events
    lost = rows[events.index("host_lost")]
    assert lost["host"] == 1 and lost["cause"] == "host_lost"
    moved = [r for r in rows if r["event"] == "shard_redistributed"
             and r.get("kind") == "files"]
    assert moved and moved[0]["host"] == 0 and "b" in moved[0]["items"]


@BOTH
def test_shrink_budget_exhaustion_escalates(tmp_path, dist):
    _shrink(dist, tmp_path, {}, max_shrinks=0)
    rows = _rows(tmp_path / "mesh-epochs.jsonl")
    assert any(r["event"] == "recovery_budget_exhausted"
               and r["scope"] == "mesh_shrink" for r in rows)


@BOTH
def test_grow_at_a_step_boundary_and_exchange(tmp_path, dist):
    out = {}
    _grow(dist, tmp_path, out)
    assert out["members"] == out["back_members"] == [0, 1] and out["epoch"] == 2
    assert out["files"] == {0: ["a", "c"], 1: ["b"]} and out["rejoined"]
    assert out["from_0"] == [0.0, 2.0] and out["from_1"] == [1.0]
    assert out["sync"] is False
    events = [r["event"] for r in _rows(tmp_path / "mesh-epochs.jsonl")]
    assert events.index("mesh_shrunk") < events.index("host_rejoined") \
        < events.index("mesh_grown")


@BOTH
def test_eviction_heals_by_rejoining(tmp_path, dist):
    out = {}
    _evicted(dist, tmp_path, out)
    assert out["rejoined"] and out["members_1"] == out["members_0"] == [0, 1]


@pytest.mark.parametrize("scenario", [
    lambda dist, d: _form_reduce(dist, d, {}),
    lambda dist, d: _shrink(dist, d, {}),
    lambda dist, d: _shrink(dist, d, {}, max_shrinks=0),
    lambda dist, d: _grow(dist, d, {}),
    lambda dist, d: _evicted(dist, d, {}),
], ids=["form", "shrink", "budget", "grow", "evicted"])
def test_ledger_rows_equal_jax_field_for_field(tmp_path, scenario):
    for name, dist in (("port", port_dist), ("jax", jax_dist)):
        scenario(dist, tmp_path / name)
    port = _stable(_rows(tmp_path / "port" / "mesh-epochs.jsonl"))
    jax = _stable(_rows(tmp_path / "jax" / "mesh-epochs.jsonl"))
    assert port == jax and port


# -------------------------------------------------- beacons and the report


def test_membership_exports_beacon_gauges(tmp_path):
    from photon_tpu_torch.obs.metrics import REGISTRY

    mem = port_dist.MeshMembership(str(tmp_path), 0, 2, ["a"], beat_seconds=0.1)
    assert mem.hb.peer_gauges == [0, 1]
    mem.hb.beat_once()
    mem.hb.export_peer_gauges()
    snap = REGISTRY.snapshot()["host_beacon_age_seconds"]
    assert 0.0 <= snap["0"] < 5.0
    assert snap["1"] == -1.0
    assert mem.beacon_ages() == {0: pytest.approx(0.0, abs=5.0), 1: -1.0}


LEDGER = [
    {"event": "mesh_formed", "epoch": 0, "t": 1.0, "members": [0, 1],
     "files": {"0": ["a"], "1": ["b"]}},
    {"event": "host_lost", "host": 1, "cause": "host_lost", "epoch": 0,
     "t": 2.0, "time": "T1", "beacon_age_seconds": 1.5},
    {"event": "mesh_shrunk", "epoch": 1, "t": 2.1, "members": [0],
     "files": {"0": ["a", "b"]}, "dead": [1]},
    {"event": "shard_redistributed", "kind": "files", "host": 0, "t": 2.2,
     "items": ["b"]},
    {"event": "host_rejoined", "host": 1, "epoch": 1, "t": 3.0, "time": "T2"},
    {"event": "mesh_grown", "epoch": 2, "t": 3.1, "members": [0, 1],
     "files": {"0": ["a"], "1": ["b"]}, "joined": [1]},
]


def test_mesh_section_shape_equals_jax():
    from photon_tpu.obs.analysis.report import _mesh_section as jax_section
    from photon_tpu_torch.obs.analysis.report import _mesh_section

    snap = {"host_beacon_age_seconds": {"0": 0.1, "1": 7.5}}
    mesh = _mesh_section(snap, LEDGER)
    assert mesh == jax_section(snap, LEDGER)
    assert mesh["epoch"] == 2 and mesh["members"] == [0, 1]
    assert mesh["host_losses"] == [{"host": 1, "epoch": 0, "time": "T1",
                                    "beacon_age_seconds": 1.5}]
    assert mesh["rejoins"][0]["host"] == 1 and mesh["redistributions"] == 1
    assert _mesh_section({}, []) is None
    assert _mesh_section({"other_metric": 1.0}, [{"event": "run_restart"}]) is None


def test_report_end_to_end_renders_a_membership_ledger(tmp_path):
    """A shrink journaled by the port's membership, with the registry shard
    an elastic host writes, renders as the report's Mesh section."""
    from photon_tpu_torch.obs import fleet
    from photon_tpu_torch.obs.analysis.report import build_report, format_markdown

    _shrink(port_dist, tmp_path, {})
    mem = port_dist.MeshMembership(str(tmp_path), 0, 2, ["a", "b"])
    mem.hb.beat_once()
    mem.hb.export_peer_gauges()
    fleet.write_registry_shard(str(tmp_path / "registry.mesh-host-0.json"),
                               role="mesh-host")
    report = build_report(str(tmp_path))
    assert report["mesh"]["members"] == [0]
    md = format_markdown(report)
    assert "## Mesh" in md and "host LOST: 1" in md


# ------------------------------------------------------------- file shards


@pytest.mark.parametrize("files,members", [
    (["a", "b", "c", "d", "e"], [0, 1, 2]),     # ragged round robin
    (["only"], [0, 1, 2]),                      # fewer files than hosts
    ([], [0, 1]),                               # no files
    (["a", "b", "c"], [2, 0, 1]),               # unsorted members
])
def test_file_shards_equal_jax(files, members):
    got = port_dist.assign_file_shards(files, members)
    assert got == jax_dist.assign_file_shards(files, members)
    assert sorted(f for fs in got.values() for f in fs) == sorted(files)
    assert set(got) == set(members)


# ------------------------------------------------------------- known fault


@BOTH
def test_fast_restart_hides_a_death_from_a_survivor(tmp_path, dist):
    """A fault of the membership protocol that the port shares with the JAX
    package (ROADMAP, Queue 3): host 2 dies, host 0 journals the shrink, and
    host 2 restarts and beacons again before host 1 has looked. Host 1,
    still in the old epoch, finds every member's beacon fresh, so no loss
    is raised; its barrier of the old epoch waits for hosts that have left
    it until the timeout, and its shrink then journals a second epoch 1
    that holds host 1 alone. The test holds while the fault stands; a
    repair (a waiting host adopting the newer epoch row) turns it into the
    check that host 1 moves to host 0's epoch."""
    d = str(tmp_path)

    def make(h):
        # a wide staleness window (2 s): only the death below reads as one
        return dist.MeshMembership(d, h, 3, ["a", "b", "c"], beat_seconds=0.1,
                                   stale_factor=20.0, wait_timeout=30.0)

    mems = [make(h) for h in range(3)]
    _run_hosts(lambda h: mems[h].start(form_timeout=30.0), 3)
    back = None
    try:
        assert [m.epoch for m in mems] == [0, 0, 0]
        mems[2].hb.stop()                   # host 2 dies
        time.sleep(2.5)                     # its last beat ages past 2 s
        mems[0].handle_loss([2])            # host 0 shrinks to [0, 1]
        assert (mems[0].epoch, mems[0].members) == (1, [0, 1])
        back = make(2)                      # host 2 restarts: a fresh beacon
        back.hb.start()
        back.request_join()
        time.sleep(0.3)
        mems[1]._check_members("after the restart")     # no loss seen
        assert (mems[1].epoch, mems[1].members) == (0, [0, 1, 2])
        with pytest.raises(dist.HostLostError, match="barrier timeout") as err:
            mems[1].barrier("step-3", timeout=1.0)
        assert err.value.dead == [0, 2]
        mems[1].handle_loss(err.value.dead)
    finally:
        for m in mems + [back]:
            if m is not None:
                m.stop()
    shrinks = [(r["epoch"], r["members"]) for r in _rows(f"{d}/mesh-epochs.jsonl")
               if r["event"] == "mesh_shrunk"]
    assert shrinks == [(1, [0, 1]), (1, [1])]
