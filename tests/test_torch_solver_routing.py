"""The port's measured solver routing (``game/solver_routing.py``) against
the JAX package's.

* ``SolverCostTable``: the JSON round trip, feasibility-aware winners (a
  feasible candidate without a cost forces a race), ``merge`` and
  ``merge_host_tables``; ``routing_mode`` validation; cost-table keys name
  the torch backend and the device.
* With a seeded table (a timing race is not deterministic) the port builds
  JAX's candidates for every bucket, picks JAX's winner and, in f64,
  matches JAX's coefficients within 1e-9 of the largest: once with the
  vmapped baseline cheapest (the chunked lanes against JAX's chunked
  vmapped solve) and once with each Newton variant cheapest.
* The chunked lanes' padding is inert: chunks that do not divide the
  bucket (and one chunk larger than it) give the whole-bucket lanes'
  coefficients and per-lane results.
* A problem that admits no Newton candidate (L1) solves the whole bucket as
  lanes without a race; a race runs once, persists, and a fresh table
  loaded from its file repeats the decisions and coefficients bit for bit.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu.game import newton_re as jnr
from photon_tpu.game import random_effect as jre
from photon_tpu.game import solver_routing as jsr
from photon_tpu_torch.game import newton_re as tnr
from photon_tpu_torch.game import random_effect as tre
from photon_tpu_torch.game import solver_routing as tsr
from test_torch_re_training import re_datasets, re_problems


def test_cost_table_roundtrip_winner_and_merge(tmp_path):
    t = tsr.SolverCostTable()
    c1, c2 = tsr.Candidate("newton_dual", 4096), tsr.Candidate("vmapped_lbfgs", 4096)
    c3 = tsr.Candidate("newton_primal", 4096)
    t.record("k", c1, 1.5e-5)
    t.record("k", c2, 9.0e-5)
    assert t.winner("k", [c1, c2]) == c1 and t.winner("k", [c2]) == c2
    assert t.winner("other", [c1, c2]) is None
    assert t.winner("k", [c1, c2, c3]) is None      # c3 unmeasured: race it
    path = str(tmp_path / "costs.json")
    t.save(path)
    t2 = tsr.SolverCostTable()
    t2.load(path)
    assert t2.costs("k") == t.costs("k")
    with pytest.raises(ValueError):
        t2.load_json({"version": 99})
    o = tsr.SolverCostTable()
    o.record("k", c1, 2.5e-5)
    o.record("k", c3, 1.0e-5)
    t.merge(o)
    assert t.costs("k") == {c1.key: 2.0e-5, c2.key: 9.0e-5, c3.key: 1.0e-5}
    o.save(str(tmp_path / "o.json"))
    (tmp_path / "torn.json").write_text("{")
    merged = tsr.merge_host_tables(
        [path, str(tmp_path / "o.json"), str(tmp_path / "torn.json")],
        str(tmp_path / "merged.json"))
    assert merged.costs("k") == t.costs("k")
    assert json.load(open(tmp_path / "merged.json"))["version"] == 1


def test_routing_mode_and_keys(monkeypatch):
    monkeypatch.setenv("PHOTON_RE_ROUTING", "sometimes")
    with pytest.raises(ValueError):
        tsr.routing_mode()
    monkeypatch.setenv("PHOTON_RE_ROUTING", "measured")
    assert tsr.routing_mode() == "measured"
    monkeypatch.delenv("PHOTON_RE_ROUTING")
    assert tsr.routing_mode() == "static"
    jd, td, _, _ = re_datasets("primal")
    key = tsr.shape_class(td.buckets[0])
    assert key.startswith("torch/cpu/") and key.endswith(":float64")
    assert key != jsr.shape_class(jd.buckets[0])    # never cross-read


@pytest.fixture
def measured(monkeypatch, tmp_path):
    path = str(tmp_path / "solver_costs.json")
    monkeypatch.setenv("PHOTON_RE_ROUTING", "measured")
    monkeypatch.setenv("PHOTON_RE_COST_TABLE", path)
    monkeypatch.setenv("PHOTON_RE_CHUNK_LADDER", "2,4")
    for mod in (tsr, jsr):
        mod.reset_process_table()
    yield path
    for mod in (tsr, jsr):
        mod.reset_process_table()


def _seed_tables(jp, tp, jd, td, mask, cheapest):
    """Seed both packages' tables with the same costs per bucket (the
    ``cheapest`` solver at 1e-9, the rest at 1e9); returns the candidates."""
    seeded = []
    jt, tt = jsr.process_table(), tsr.process_table()
    for b, (jb, tb) in enumerate(zip(jd.buckets, td.buckets)):
        tmask = tre.bucket_inputs(td, b, torch.zeros(td.n_rows, dtype=torch.float64),
                                  torch.from_numpy(mask))[0]
        jmask = jnp.asarray(tmask.numpy())
        ju = (jnr.u_max_for(jnr.penalty_terms(jp, jmask, None)[3])
              if jnr.dual_precheck(jp, jb, None) else -1)
        tu = tre._u_max(tp, tb, tmask, None, None)
        jc = jsr.candidates_for(jp, jb, None, ju)
        tc = tsr.candidates_for(tp, tb, None, tu)
        assert [(c.solver, c.chunk) for c in tc] == [(c.solver, c.chunk) for c in jc]
        for c in jc:
            jt.record(jsr.shape_class(jb), c, 1e-9 if c.solver == cheapest else 1e9)
        for c in tc:
            tt.record(tsr.shape_class(tb), c, 1e-9 if c.solver == cheapest else 1e9)
        seeded.append([c.solver for c in tc])
    return seeded


@pytest.mark.parametrize("shape,cheapest", [
    ("primal", "vmapped_lbfgs"), ("primal", "newton_primal"),
    ("dual", "newton_dual")])
def test_seeded_table_routes_as_jax(measured, shape, cheapest):
    jd, td, offsets, mask = re_datasets(shape)
    jp, tp = re_problems()
    seeded = _seed_tables(jp, tp, jd, td, mask, cheapest)
    assert all(cheapest in s for s in seeded)
    jm, _ = jre.train_random_effects(jp, jd, jnp.asarray(offsets),
                                     global_reg_mask=jnp.asarray(mask))
    tm, _ = tre.train_random_effects(tp, td, torch.from_numpy(offsets),
                                     global_reg_mask=torch.from_numpy(mask))
    trec = tre.bucket_records()
    assert [(r["solver"], r["chunk"]) for r in trec] == [
        (r["solver"], r["chunk"]) for r in jre.LAST_BUCKET_TIMINGS]
    assert all(r["solver"] == cheapest and r["chunk"] is not None
               and not r["calibrated"] and r["routing"] == "measured"
               for r in trec)
    for a, b in zip(jm.bucket_coefs, tm.bucket_coefs):
        a = np.asarray(a)
        assert np.abs(b.numpy() - a).max() <= 1e-9 * max(np.abs(a).max(), 1e-30)


def test_chunked_lanes_padding_inert():
    jd, td, offsets, mask = re_datasets("primal")
    _, tp = re_problems()
    b = max(range(len(td.buckets)), key=lambda i: td.buckets[i].n_entities)
    bucket = td.buckets[b]
    e = bucket.n_entities
    lmask, batches, _ = tre.bucket_inputs(td, b, torch.from_numpy(offsets),
                                          torch.from_numpy(mask))
    w0 = torch.zeros((e, bucket.local_dim), dtype=torch.float64)
    full_m, full_r = tp.run_lanes(tre.lane_batch(td, b, batches), w0, lmask,
                                  None, None)

    def fit_one(bb, w, m, pr, lo):
        return tp.run_lanes(tre._chunk_lanes(td, b, bucket, bb, lo), w, m, None, pr)

    for chunk in (e + 7, max(2, e - 1), 3):
        ch_m, ch_r = tnr.fit_bucket_in_chunks(fit_one, chunk, batches, w0, lmask,
                                              None, with_lo=True)
        assert ch_m.coefficients.means.shape == full_m.coefficients.means.shape
        assert torch.abs(ch_m.coefficients.means - full_m.coefficients.means
                         ).max() <= 1e-12
        assert torch.equal(ch_r.iterations, full_r.iterations)
    assert ("chunk", b, 0, 3) in td.lane_layouts      # built once, kept


def test_no_newton_candidate_solves_whole_bucket(measured):
    jd, td, offsets, mask = re_datasets("primal")
    jp, tp = re_problems(optimizer="OWLQN", reg="L1")
    jre.train_random_effects(jp, jd, jnp.asarray(offsets),
                             global_reg_mask=jnp.asarray(mask))
    tre.train_random_effects(tp, td, torch.from_numpy(offsets),
                             global_reg_mask=torch.from_numpy(mask))
    for recs in (tre.bucket_records(), jre.LAST_BUCKET_TIMINGS):
        assert {(r["solver"], r["chunk"], r["calibrated"]) for r in recs} == {
            ("vmapped_lbfgs", None, False)}
    assert not os.path.exists(measured)


def test_race_runs_once_persists_and_replays(measured):
    jd, td, offsets, mask = re_datasets("primal")
    _, tp = re_problems()
    args = (tp, td, torch.from_numpy(offsets))
    kw = dict(global_reg_mask=torch.from_numpy(mask))
    first, _ = tre.train_random_effects(*args, **kw)
    rec1 = tre.bucket_records()
    assert any(r["calibrated"] for r in rec1)
    assert all(r["calibration_seconds"] >= 0 for r in rec1)
    assert os.path.exists(measured)
    tre.train_random_effects(*args, **kw)
    assert not any(r["calibrated"] for r in tre.bucket_records())
    tsr.reset_process_table()                  # a restart: reload the file
    again, _ = tre.train_random_effects(*args, **kw)
    rec3 = tre.bucket_records()
    assert not any(r["calibrated"] for r in rec3)
    assert [(r["solver"], r["chunk"]) for r in rec3] == [
        (r["solver"], r["chunk"]) for r in rec1]
    for a, b in zip(first.bucket_coefs, again.bucket_coefs):
        assert torch.equal(a, b)
