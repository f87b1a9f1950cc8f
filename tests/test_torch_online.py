"""The port's online learning (``photon_tpu_torch/online``,
``photon_tpu_torch/cli/online_training_driver.py``) against the JAX
package's, on the CPU.

* ``online/{events,state,__init__}.py`` are copies: without docstrings,
  each equals the JAX package's with the package name renamed.
* Event logs and replay cursors written by one package are read by the
  other; offsets composed at ingest (frozen fixed effects plus another
  coordinate's published posterior) equal JAX's bit for bit.
* The same events through JAX's ``OnlineTrainer`` and the port's at
  ``dtype="float64"``, over primal, dual and vmapped buckets, with
  ``incremental_weight`` 0 and 1 and the LOGISTIC and LINEAR losses: the
  same tier for every bucket, the same ``online.*`` spans with the same
  argument keys, the same journal rows, every published delta
  within 1e-9 of each entity's largest coefficient (and the f64 posteriors
  too).
* The convergence-equivalence contract: refreshes with no anchoring over
  the cumulative window land on one batch retrain through the port's
  ``train_random_effects`` (1e-3, the JAX test's bound).
* The chaos drills: a device loss publishes a bit-identical delta, an OOM
  halves the batch with no torn delta, losses past the recovery budget
  escalate, a failed publish applies nothing.
* The port's online driver against JAX's on the same model and events:
  equal totals, journal rows and cursors, deltas within f32 tolerance, and
  a cursor resume that ends where the uninterrupted run ends.
"""
import json
import os

import numpy as np
import pytest
import torch

from photon_tpu import online as jax_online
from photon_tpu.cli import online_training_driver as jax_online_driver
from photon_tpu.index.index_map import (
    DefaultIndexMap as JaxIndexMap,
    feature_key as jax_feature_key,
)
from photon_tpu.io.data_reader import FeatureShardConfig as JaxShardConfig
from photon_tpu.obs import start_tracing as jax_start_tracing
from photon_tpu.obs import stop_tracing as jax_stop_tracing
from photon_tpu.types import TaskType as JaxTaskType
from photon_tpu_torch import online
from photon_tpu_torch.cli import game_training_driver as port_training_driver
from photon_tpu_torch.cli import online_training_driver
from photon_tpu_torch.data.random_effect import build_random_effect_dataset
from photon_tpu_torch.faults import (
    DeviceLostError,
    FaultPlan,
    FaultSpec,
    active_plan,
)
from photon_tpu_torch.game.random_effect import train_random_effects
from photon_tpu_torch.index.index_map import DefaultIndexMap, feature_key
from photon_tpu_torch.io.avro import read_records
from photon_tpu_torch.io.data_reader import FeatureShardConfig
from photon_tpu_torch.obs import start_tracing, stop_tracing
from photon_tpu_torch.replication import iter_log
from photon_tpu_torch.serving import CoefficientStore, DeviceCoefficientCache
from photon_tpu_torch.types import TaskType
from test_torch_faults import REPO, _code
from test_torch_jax_decoder import jax_decoder  # noqa: F401
from test_torch_scoring_driver import _write_game_avro

CPU = torch.device("cpu")
COPIES = ["online/events.py", "online/state.py", "online/__init__.py"]
D = 200          # global columns of the tier mix
D_SMALL = 8      # global columns of the small-entity cases


@pytest.mark.parametrize("rel", COPIES)
def test_online_modules_are_copies(rel):
    port = os.path.join(REPO, "photon_tpu_torch", rel)
    jax = os.path.join(REPO, "photon_tpu", rel)
    assert _code(port, rename=True) == _code(jax, rename=False)


# ----------------------------------------------------------- helpers


class RecordingPublisher:
    """Captures every published delta."""

    def __init__(self):
        self.deltas = []

    def publish(self, delta):
        self.deltas.append(delta)
        return {"recorded": len(self.deltas)}


def _pkg(which):
    """(online module, index map class, feature_key, shard config, task
    enum) of one package."""
    if which == "jax":
        return (jax_online, JaxIndexMap, jax_feature_key, JaxShardConfig,
                JaxTaskType)
    return online, DefaultIndexMap, feature_key, FeatureShardConfig, TaskType


def _trainer(which, dim=D_SMALL, task="LOGISTIC_REGRESSION", publisher=None,
             journal=None, cursor=None, coordinates=(("perUser", "userId"),),
             fixed_weights=None, **cfg):
    m, imap, fk, shard, tasks = _pkg(which)
    config = m.OnlineTrainerConfig(**{
        "window": 64, "max_event_nnz": dim, "refresh_batch": 256,
        "chunk": 256, "incremental_weight": 0.0, "reg_weight": 1.0,
        "max_iterations": 50, "dtype": "float64", **cfg})
    kw = {} if which == "jax" else {"device": "cpu"}
    return m.OnlineTrainer(
        task=getattr(tasks, task),
        coordinates=[m.OnlineCoordinate(cid, re, "global")
                     for cid, re in coordinates],
        index_maps={"global": imap([fk("c", str(j)) for j in range(dim)])},
        shard_configs={"global": shard(("features",), add_intercept=False)},
        config=config, publisher=publisher, journal=journal, cursor=cursor,
        fixed_weights=fixed_weights, **kw)


def _events(which, raw):
    m = _pkg(which)[0]
    return [m.OnlineEvent(**e) for e in raw]


def _gen_small(task="LOGISTIC_REGRESSION", n_entities=6, rows=20, seed=1,
               nnz=3):
    """The JAX test's synthetic events (dicts) and their rows."""
    rng = np.random.default_rng(seed)
    wu = rng.normal(size=(n_entities, D_SMALL))
    events, rows_out = [], []
    for i in range(n_entities * rows):
        u = i % n_entities
        cols = np.sort(rng.choice(D_SMALL, size=nnz, replace=False))
        vals = rng.normal(size=nnz)
        z = float((wu[u][cols] * vals).sum())
        if task == "LOGISTIC_REGRESSION":
            y = float(rng.random() < 1 / (1 + np.exp(-z)))
        else:
            y = z + float(rng.normal()) * 0.1
        events.append(dict(
            entities={"userId": f"u{u}"},
            features=[{"name": "c", "term": str(int(c)), "value": float(v)}
                      for c, v in zip(cols, vals)],
            label=y, ts=float(i), seq=i))
        rows_out.append((f"u{u}", cols, vals, y))
    return events, rows_out


def _gen_tiers(task, seed=0):
    """Events whose buckets take all three tiers: few columns (primal),
    few rows over many columns (dual), many rows over many columns (the
    vmapped lanes, once an entity's window holds more than DUAL_MAX_T
    rows)."""
    rng = np.random.default_rng(seed)
    evs, seq = [], 0
    for g, ne, rows, nnz, span in (("p", 4, 6, 3, 8), ("d", 3, 6, 20, D),
                                   ("v", 2, 90, 20, D)):
        w = rng.normal(size=(ne, D)) * 0.3
        for _ in range(rows):
            for u in range(ne):
                cols = np.sort(rng.choice(span, nnz, replace=False))
                vals = rng.normal(size=nnz)
                z = float((w[u][cols] * vals).sum())
                y = (float(rng.random() < 1 / (1 + np.exp(-z)))
                     if task == "LOGISTIC_REGRESSION"
                     else z + 0.1 * float(rng.normal()))
                evs.append(dict(
                    entities={"userId": f"{g}{u}"},
                    features=[{"name": "c", "term": str(int(c)),
                               "value": float(v)} for c, v in zip(cols, vals)],
                    label=y, ts=float(seq), seq=seq))
                seq += 1
    return evs


def _online_census(col):
    """Each ``online`` span's and instant's name with its argument keys."""
    return sorted({(e["name"], tuple(sorted(e.get("args", {}))))
                   for e in col.events if e.get("cat") == "online"})


def _solve_spans(col):
    return [(e["args"]["coordinate"], e["args"]["bucket"],
             e["args"]["entities"], e["args"]["local_dim"], e["args"]["solver"])
            for e in col.events if e.get("name") == "online.solve"]


# ----------------------------------------------------------- event layer


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_event_logs_and_cursors_cross_packages(writer, tmp_path):
    m_w = _pkg(writer)[0]
    m_r = _pkg("port" if writer == "jax" else "jax")[0]
    path = str(tmp_path / "events.jsonl")
    raw, _ = _gen_small(n_entities=3, rows=2)
    for e in raw:
        e.pop("seq")
    assert m_w.append_events(path, [m_w.OnlineEvent(**e) for e in raw]) == 0
    with m_w.EventWriter(path) as w:
        assert w.append(m_w.OnlineEvent(**raw[0])) == len(raw)
    with open(path, "a") as f:
        f.write('{"seq": 99, "label":')          # a torn tail
    back = list(m_r.iter_events(path))
    mine = list(m_w.iter_events(path))
    assert [e.to_dict() for e in back] == [e.to_dict() for e in mine]
    assert [e.seq for e in back] == list(range(len(raw) + 1))
    assert [e.seq for e in m_r.iter_events(path, start_seq=4)] == [4, 5, 6]
    m_w.EventCursor(str(tmp_path)).save(5)
    assert m_r.EventCursor(str(tmp_path)).load() == 5


def test_offsets_composed_at_ingest_equal_jax():
    """Frozen fixed effects (host ``w_ext``) plus the other coordinate's
    published posterior, composed into each window row's offset."""
    rng = np.random.default_rng(4)
    fixed = {"fixed": ("global", rng.normal(size=D_SMALL))}
    coords = (("perUser", "userId"), ("perItem", "itemId"))
    raw = []
    for i in range(24):
        cols = np.sort(rng.choice(D_SMALL, 3, replace=False))
        raw.append(dict(
            entities={"userId": f"u{i % 4}", "itemId": f"i{i % 3}"},
            features=[{"name": "c", "term": str(int(c)),
                       "value": float(rng.normal())} for c in cols],
            label=float(i % 2), offset=float(rng.normal()), ts=float(i),
            seq=i))
    out = {}
    for which in ("jax", "port"):
        tr = _trainer(which, coordinates=coords, fixed_weights=fixed)
        for k in range(3):
            tr.state["perItem"].update(
                f"i{k}", np.asarray([1, 4, 6]), np.full(3, k + 0.5), None)
        for ev in _events(which, raw):
            tr.ingest(ev)
        out[which] = {cid: {key: [r[4] for r in tr.windows[cid].rows_for(key)]
                            for key in (f"u{u}" for u in range(4))}
                      for cid in ("perUser",)}
        out[which]["items"] = {
            f"i{k}": [r[4] for r in tr.windows["perItem"].rows_for(f"i{k}")]
            for k in range(3)}
    assert out["port"] == out["jax"]
    assert any(v != 0.0 for rows in out["port"]["perUser"].values()
               for v in rows)


# ------------------------------------------------------- trainer parity


@pytest.mark.parametrize("task", ["LOGISTIC_REGRESSION", "LINEAR_REGRESSION"])
@pytest.mark.parametrize("iw", [0.0, 1.0])
def test_trainer_matches_jax_f64_over_all_tiers(task, iw, tmp_path):
    raw = _gen_tiers(task)
    half = len(raw) // 2
    got = {}
    for which, (start, stop) in (("jax", (jax_start_tracing,
                                          jax_stop_tracing)),
                                 ("port", (start_tracing, stop_tracing))):
        m = _pkg(which)[0]
        pub = RecordingPublisher()
        journal = m.PatchJournal(str(tmp_path / which))
        tr = _trainer(which, dim=D, task=task, publisher=pub, journal=journal,
                      window=128, max_event_nnz=20, incremental_weight=iw)
        evs = _events(which, raw)
        start()
        try:
            tr.run(evs[:half])
            tr.run(evs[half:])
        finally:
            col = stop()
        rows = [{k: v for k, v in r.items() if k != "ts"}
                for r in journal.read_all()]
        got[which] = (pub.deltas, _solve_spans(col), rows, tr.state["perUser"],
                      _online_census(col))
    (jd, jt, jrows, jstate, jc), (pd, pt, prows, pstate, pc) = (got["jax"],
                                                                 got["port"])
    assert pt == jt
    assert pc == jc and {n for n, _ in pc} == {"online.refresh", "online.solve",
                                               "online.publish"}
    assert {t[-1] for t in pt} == {"newton_primal", "newton_dual",
                                   "vmapped_lbfgs"}
    for r in jrows + prows:
        r.pop("freshness_max_s")
    assert prows == jrows
    assert len(pd) == len(jd) == 2
    for a, b in zip(jd, pd):
        assert (a.seq, a.event_horizon) == (b.seq, b.event_horizon)
        assert set(a.patches["perUser"]) == set(b.patches["perUser"])
        for key, pa in a.patches["perUser"].items():
            pb = b.patches["perUser"][key]
            np.testing.assert_array_equal(pa.cols, pb.cols)
            scale = max(1.0, float(np.abs(pa.vals).max()))
            assert np.abs(pa.vals.astype(np.float64) - pb.vals).max() \
                <= 1e-9 * scale, key
            jc, jm, jv = jstate.posterior_for(key)
            pc, pm, pv = pstate.posterior_for(key)
            np.testing.assert_array_equal(jc, pc)
            scale = max(1.0, float(np.abs(jm).max()))
            assert np.abs(jm - pm).max() <= 1e-9 * scale, key
            assert np.abs(jv - pv).max() <= 1e-9 * max(1.0, jv.max()), key


@pytest.mark.parametrize("task", ["LOGISTIC_REGRESSION", "LINEAR_REGRESSION"])
def test_incremental_refresh_matches_batch_retrain(task):
    """Three refresh cycles, a window covering the cumulative data and no
    anchoring land on the per-entity optimum of ONE batch retrain over the
    same rows (the port's ``train_random_effects``)."""
    tr = _trainer("port", task=task)
    raw, rows_out = _gen_small(task)
    evs = _events("port", raw)
    n3 = len(evs) // 3
    tr.run(evs[:n3])
    tr.run(evs[n3:2 * n3])
    tr.run(evs[2 * n3:])
    assert tr.totals["cycles"] == 3
    n = len(rows_out)
    idx = np.full((n, D_SMALL), D_SMALL, np.int32)
    val = np.zeros((n, D_SMALL))
    keys = np.empty(n, object)
    labels = np.zeros(n)
    for r, (k, c, v, y) in enumerate(rows_out):
        idx[r, :len(c)] = c
        val[r, :len(c)] = v
        keys[r] = k
        labels[r] = y
    ds = build_random_effect_dataset("userId", keys, idx, val, labels, D_SMALL,
                                     dtype=torch.float64, device=CPU)
    model, _ = train_random_effects(tr._problem, ds,
                                    torch.zeros(n, dtype=torch.float64))
    for u in range(6):
        gi, gv = model.coefficients_for(f"u{u}")
        post = tr.state["perUser"].posterior_for(f"u{u}")
        batch_full = np.zeros(D_SMALL)
        batch_full[gi] = gv
        online_full = np.zeros(D_SMALL)
        online_full[post[0]] = post[1]
        np.testing.assert_allclose(online_full, batch_full, atol=1e-3,
                                   err_msg=f"entity u{u} diverged")


def test_trainer_defaults_to_cuda_and_chunk_on_the_ladder(monkeypatch):
    with pytest.raises(ValueError, match="blessed chunk ladder"):
        online.OnlineTrainerConfig(chunk=100)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        online.OnlineTrainer(
            task=TaskType.LOGISTIC_REGRESSION,
            coordinates=[online.OnlineCoordinate("perUser", "userId",
                                                 "global")],
            index_maps={"global": DefaultIndexMap([feature_key("c", "0")])},
            shard_configs={"global": FeatureShardConfig(("features",))})


# ----------------------------------------------------------- chaos drills


def _run_with(plan, events, **cfg):
    pub = RecordingPublisher()
    tr = _trainer("port", publisher=pub, max_iterations=15, dtype="float32",
                  **cfg)
    if plan is None:
        tr.run(events)
        return tr, pub
    with active_plan(plan) as inj:
        tr.run(events)
        assert inj.fired("online.refresh") == 1
    return tr, pub


def _same_delta(a, b):
    assert a.event_horizon == b.event_horizon
    assert set(a.patches["perUser"]) == set(b.patches["perUser"])
    for key, pa in a.patches["perUser"].items():
        pb = b.patches["perUser"][key]
        np.testing.assert_array_equal(pa.cols, pb.cols)
        np.testing.assert_array_equal(pa.vals, pb.vals)      # bit-identical


def test_chaos_device_lost_mid_refresh_publishes_bitidentical_delta():
    raw, _ = _gen_small(n_entities=4, rows=6, seed=3)
    events = _events("port", raw)
    clean_tr, clean_pub = _run_with(None, events)
    plan = FaultPlan(seed=5, specs=[
        FaultSpec(site="online.refresh", error="device_lost", count=1)])
    faulted_tr, faulted_pub = _run_with(plan, events)
    assert faulted_tr.totals["device_loss_recoveries"] == 1
    assert len(faulted_pub.deltas) == len(clean_pub.deltas) == 1
    _same_delta(clean_pub.deltas[0], faulted_pub.deltas[0])


def test_chaos_oom_mid_refresh_halves_batch_no_torn_delta():
    from photon_tpu_torch.obs.metrics import REGISTRY
    from photon_tpu_torch.runtime import memory_guard as mg

    mg.reset_state()
    try:
        raw, _ = _gen_small(n_entities=4, rows=6, seed=3)
        events = _events("port", raw)
        clean_tr, clean_pub = _run_with(None, events, refresh_batch=8)
        counter = REGISTRY.counter("oom_downshifts_total")
        before = counter.value(site="online.refresh", cause="oom")
        plan = FaultPlan(seed=5, specs=[
            FaultSpec(site="online.refresh", error="device_oom", count=1)])
        faulted_tr, faulted_pub = _run_with(plan, events, refresh_batch=8)
        assert faulted_tr.config.refresh_batch == 4       # halved, sticky
        assert clean_tr.config.refresh_batch == 8
        assert counter.value(site="online.refresh", cause="oom") == before + 1
        assert faulted_tr.totals["device_loss_recoveries"] == 0
        assert len(faulted_pub.deltas) == len(clean_pub.deltas) == 1
        _same_delta(clean_pub.deltas[0], faulted_pub.deltas[0])
    finally:
        mg.reset_state()


def test_chaos_device_lost_escalates_past_recovery_budget(monkeypatch):
    monkeypatch.setenv("PHOTON_DEVICE_LOST_MAX_RECOVERIES", "1")
    raw, _ = _gen_small(n_entities=2, rows=2)
    tr = _trainer("port", max_iterations=5, dtype="float32")
    plan = FaultPlan(seed=5, specs=[
        FaultSpec(site="online.refresh", error="device_lost", count=3)])
    with active_plan(plan):
        with pytest.raises(DeviceLostError):
            tr.run(_events("port", raw))
    assert tr.totals["device_loss_recoveries"] == 1
    assert tr.totals["deltas"] == 0


class StorePublisher:
    """Publishes into a CoefficientStore + its CPU cache: the serving-side
    apply without a server."""

    def __init__(self, store, cache):
        self.store, self.cache = store, cache

    def publish(self, delta):
        raw = delta.raw_patches().get("perUser", {})
        patched = self.store.apply_patches(raw)
        self.cache.invalidate(list(raw))
        return {"patched": patched}


def test_chaos_failed_publish_applies_nothing_and_retries():
    store = CoefficientStore([], np.zeros(1, np.int64), np.zeros(0, np.int32),
                             np.zeros(0, np.float32), D_SMALL)
    cache = DeviceCoefficientCache(store, capacity=4, device=CPU)
    tr = _trainer("port", publisher=StorePublisher(store, cache),
                  max_iterations=10, dtype="float32")
    raw, _ = _gen_small(n_entities=3, rows=4, seed=9)
    for ev in _events("port", raw):
        tr.ingest(ev)
    plan = FaultPlan(seed=1, specs=[
        FaultSpec(site="online.publish", error="os", count=1)])
    with active_plan(plan) as inj:
        with pytest.raises(OSError):
            tr.refresh()
        assert inj.fired("online.publish") == 1
    assert store.n_patched == 0
    assert tr.state["perUser"].n_entities == 0
    assert tr.totals["deltas"] == 0
    assert tr.windows["perUser"].n_dirty == 3
    summary = tr.refresh()
    assert summary is not None and summary["entities"] == 3
    assert store.n_patched == 3
    assert tr.windows["perUser"].n_dirty == 0
    for u in range(3):
        hit = store.lookup(f"u{u}")
        assert hit is not None and len(hit[0]) > 0


# ------------------------------------------------------------- the driver


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """A GAME model trained by the port's driver on the CPU, and an event
    log of other rows of the same users (plus two unseen ones)."""
    d = tmp_path_factory.mktemp("torch_online_driver")
    _write_game_avro(d / "train.avro", seed=1, n_users=6, rows_per_user=16)
    _write_game_avro(d / "events.avro", seed=2, n_users=8, rows_per_user=4,
                     offsets=True)
    port_training_driver.run([
        "--train-data", str(d / "train.avro"), "--task", "LOGISTIC_REGRESSION",
        "--feature-shard", "global:features", "--output-dir", str(d / "train"),
        "--coordinate", "fixed:type=fixed,shard=global,reg=L2,max_iter=25,"
        "reg_weights=1",
        "--coordinate", "perUser:type=random,re_type=userId,shard=global,"
        "reg=L2,max_iter=25,reg_weights=1",
        "--device", "cpu"])
    events = [online.OnlineEvent(
        entities=r["metadataMap"], features=r["features"],
        label=r["response"], offset=r["offset"] or 0.0, ts=float(i))
        for i, r in enumerate(read_records(str(d / "events.avro")))]
    online.append_events(str(d / "events.jsonl"), events)
    return d


def _drive(which, base, out, *extra):
    argv = ["--model-dir", str(base / "train" / "best"),
            "--events", str(base / "events.jsonl"), "--output-dir", str(out),
            "--delta-log", str(out / "delta-log.jsonl"), "--cadence-s", "0",
            "--refresh-batch", "3", "--prefetch-depth", "0", *extra]
    if which == "jax":
        return jax_online_driver.run([*argv, "--backend-policy", "cpu-only"])
    return online_training_driver.run([*argv, "--device", "cpu"])


def _log_patches(path):
    return [(r.seq, r.delta.seq, r.delta.event_horizon,
             {k: (p.cols.tolist(), p.vals) for k, p in
              r.delta.patches["perUser"].items()})
            for r in iter_log(str(path)) if r.delta is not None]


TOTALS = ("events", "bad_events", "cycles", "deltas", "entities_refreshed",
          "device_loss_recoveries", "freshness_samples", "start_seq")


def _check_same_run(jout, pout, jsum, psum):
    assert {k: psum[k] for k in TOTALS} == {k: jsum[k] for k in TOTALS}
    strip = ("ts", "freshness_max_s")
    rows = [[{k: v for k, v in r.items() if k not in strip}
             for r in online.PatchJournal(str(o)).read_all()]
            for o in (jout, pout)]
    for r in rows[0] + rows[1]:
        r["published"]["log_path"] = os.path.basename(
            r["published"]["log_path"])
    assert rows[0] == rows[1]
    assert (online.EventCursor(str(pout)).load()
            == online.EventCursor(str(jout)).load())
    jl, pl = (_log_patches(o / "delta-log.jsonl") for o in (jout, pout))
    assert [x[:3] for x in pl] == [x[:3] for x in jl]
    for (_, _, _, jp), (_, _, _, pp) in zip(jl, pl):
        assert jp.keys() == pp.keys()
        for key, (jc, jv) in jp.items():
            pc, pv = pp[key]
            assert pc == jc
            assert np.abs(pv.astype(np.float64) - jv).max() \
                <= 1e-4 * (1.0 + np.abs(jv).max()), key


def test_driver_matches_jax_driver(base, tmp_path):
    jsum = _drive("jax", base, tmp_path / "jax")
    psum = _drive("port", base, tmp_path / "port")
    assert psum["device"] == "cpu" and psum["deltas"] >= 3
    assert psum["events"] == 32
    _check_same_run(tmp_path / "jax", tmp_path / "port", jsum, psum)
    saved = json.load(open(tmp_path / "port" / "online-summary.json"))
    assert saved["deltas"] == psum["deltas"]


def test_driver_cursor_resume_ends_equal(base, tmp_path):
    """One cycle, then a run resumed from the cursor to the end, in each
    package: the resumed runs agree as the uninterrupted ones do, and
    their cursor ends where an uninterrupted run's ends."""
    runs = {}
    for which in ("jax", "port"):
        out = tmp_path / which
        first = _drive(which, base, out, "--max-cycles", "1")
        assert first["deltas"] == 1
        runs[which] = _drive(which, base, out)
        assert runs[which]["start_seq"] > 0
    _check_same_run(tmp_path / "jax", tmp_path / "port", runs["jax"],
                    runs["port"])
    whole = _drive("port", base, tmp_path / "whole")
    assert (online.EventCursor(str(tmp_path / "port")).load()
            == online.EventCursor(str(tmp_path / "whole")).load()
            == whole["events"])


@pytest.mark.parametrize("flag", ["--compilation-cache-dir", "--compile-store"])
def test_driver_refuses_compile_flags_for_good(flag, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        online_training_driver.run([
            "--model-dir", str(tmp_path / "m"), "--events", "e.jsonl",
            "--device", "cpu", "--output-dir", str(tmp_path / "out"),
            flag, "x"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert flag in err and "refused for good" in err
    assert not (tmp_path / "out").exists()


def test_driver_flags_are_the_jax_drivers():
    jax_flags = set(jax_online_driver.build_arg_parser()._option_string_actions)
    port_flags = set(online_training_driver.build_arg_parser()
                     ._option_string_actions)
    assert jax_flags - port_flags == set()
    assert port_flags - jax_flags == {"--device"}
    with pytest.raises(SystemExit, match="mutually exclusive"):
        online_training_driver.run([
            "--model-dir", "m", "--events", "e", "--device", "cpu",
            "--delta-log", "a", "--canary-log", "b"])
