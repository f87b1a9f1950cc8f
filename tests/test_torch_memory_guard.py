"""The port's memory guard (``photon_tpu_torch/runtime/memory_guard.py``),
the random-effect OOM ladder and the out-of-core re-chunking, against the
JAX package's.

On the CPU, the ladder is driven by the injected ``device_oom`` fault (a
real ``torch.cuda.OutOfMemoryError`` drives it in ``chip_smoke.py``):

* ``is_oom`` and the downshifter's bound and journal rows;
* ``_oom_next_tier`` / ``_apply_sticky_plan`` equal JAX's over a grid of
  (solver, chunk, E, vmapped_chunkable, sticky plan);
* an injected ``re.solve`` OOM: the downshifted f64 fit takes JAX's tiers
  and is within 1e-9 of JAX's same downshifted fit (of the largest
  coefficient), and bit-equal to the port's own run started at that tier
  with the sticky plan set; the journal rows are JAX's;
* the measured-routing demotion (one tier below the static plan, sticky),
  and a ladder that runs out of tiers or of its bound escalates with the
  original error, as in JAX;
* out of core, an OOM at ``optim.ooc_chunk`` halves ``chunk_rows``: the
  f64 solve is bit-equal to the port's solve started at the halved cut,
  and in f32 within 1e-5 (relative above 1) of JAX's uninterrupted solve,
  with JAX's iterations, reasons and data passes (JAX's out-of-core solver
  is float32 only: the out-of-core test's bar). The JAX oracle of the
  downshift itself fails on the reference's own runs, so it is not used.
  A ``device_lost`` at ``optim.ooc_iteration`` recovers in-run,
  bit-identically, with a checkpoint and without, and escalates past its
  bound;
* ``MemoryGuard`` with injected stats sheds sweep-cache pins above high
  water; ``effective_sweep_budget`` and ``pre_degrade_for_restart`` give
  JAX's numbers.
"""
import itertools
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu import faults as jfaults
from photon_tpu.game import random_effect as jre
from photon_tpu.optim.out_of_core import ChunkedGLMData as JaxChunked
from photon_tpu.optim.out_of_core import run_out_of_core as jax_run_ooc
from photon_tpu.runtime import memory_guard as jmg
from photon_tpu.supervisor import RecoveryJournal as JaxJournal
from photon_tpu_torch import faults as tfaults
from photon_tpu_torch.game import random_effect as tre
from photon_tpu_torch.optim import OptimizerType
from photon_tpu_torch.optim.out_of_core import run_out_of_core
from photon_tpu_torch.optim.regularization import RegularizationType
from photon_tpu_torch.runtime import memory_guard as mg
from photon_tpu_torch.supervisor import RecoveryJournal
from test_torch_out_of_core import DIM, _chunked, _data, _jax_problem, _problem
from test_torch_re_training import SHAPES, game_arrays, re_problems


@pytest.fixture(autouse=True)
def _fresh():
    mg.reset_state()
    jmg.reset_state()
    yield
    mg.reset_state()
    jmg.reset_state()


def _rows(path):
    keep = ("event", "site", "cause", "downshift", "before", "after", "plan",
            "downshifts")
    return [{k: r[k] for k in keep if k in r}
            for r in map(json.loads, open(path).read().splitlines())]


def test_is_oom():
    for err in (torch.cuda.OutOfMemoryError("CUDA out of memory."), MemoryError(),
                tfaults.DeviceOomError("x"),
                RuntimeError("ell_matvec launch failed: CUDA error 2 (out of memory)"),
                RuntimeError("CUBLAS_STATUS_ALLOC_FAILED")):
        assert mg.is_oom(err)
    for err in (RuntimeError("CUDA error: an illegal memory access"),
                tfaults.DeviceLostError("x"), OSError("out of memory on NFS"),
                ValueError("bad")):
        assert not mg.is_oom(err)


def test_downshifter_bound_and_journal_rows(tmp_path, monkeypatch):
    monkeypatch.setenv("PHOTON_OOM_MAX_DOWNSHIFTS", "2")
    got = {}
    for name, mod, journal, err in (
            ("port", mg, RecoveryJournal, tfaults.DeviceOomError("boom")),
            ("jax", jmg, JaxJournal, jfaults.DeviceOomError("boom"))):
        path = str(tmp_path / f"{name}.jsonl")
        mod.set_journal(journal(path))
        shifter = mod.downshifter("re.solve")
        assert mod.downshifter("re.solve") is shifter
        got[name] = [shifter.absorb(err, before=f"p{i}", after=f"p{i + 1}")
                     for i in range(4)]
        mod.set_journal(None)
        got[name] = (got[name], shifter.count, _rows(path))
    assert got["port"] == got["jax"]
    assert got["port"][0] == [True, True, False, False]
    assert [r["event"] for r in got["port"][2]] == [
        "oom_downshift", "oom_downshift", "oom_exhausted", "oom_exhausted"]


SOLVERS = ("newton_primal", "newton_dual", "vmapped_lbfgs")
CHUNKS = (None, 256, 300, 1024, 4096, 16384)
ES = (100, 256, 1000, 5000, 100_000)
STICKY = (None, {"chunk": 1024}, {"chunk": 256, "solver": "vmapped_lbfgs"},
          {"chunk": 64}, {"chunk": 4096, "solver": None})


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("chunkable", [True, False])
def test_ladder_tiers_equal_jax(solver, chunkable):
    for chunk, e in itertools.product(CHUNKS, ES):
        assert tre._oom_next_tier(solver, chunk, e, vmapped_chunkable=chunkable) == \
            jre._oom_next_tier(solver, chunk, e, vmapped_chunkable=chunkable)
        for sticky in STICKY:
            assert tre._apply_sticky_plan((solver, chunk), sticky, e, chunkable) == \
                jre._apply_sticky_plan((solver, chunk), sticky, e, chunkable)
        assert tre._plan_desc(solver, chunk) == jre._plan_desc(solver, chunk)


# tests/test_torch_re_training.py's dual data at 40 users: its first bucket
# (5 entities) solves whole on the dual path, the next ones in dual chunks,
# so an OOM of the first dispatch drops it one blessed tier (to chunks of 4).
LADDER = {"PHOTON_RE_NEWTON_BUDGET_MB": "0.03",
          "PHOTON_RE_CHUNK_LADDER": "1,2,4,8,16"}


def _datasets():
    from photon_tpu.data.random_effect import build_random_effect_dataset as jbuild
    from photon_tpu_torch.data.random_effect import build_random_effect_dataset

    idx, val, dim, labels, offsets, keys = game_arrays(1, n_users=40, **SHAPES["dual"])
    jd = jbuild("u", keys, idx, val, labels, dim, intercept_index=0, dtype=np.float64)
    td = build_random_effect_dataset("u", keys, idx, val, labels, dim,
                                     intercept_index=0, dtype=torch.float64,
                                     device=torch.device("cpu"))
    mask = np.ones(dim)
    mask[0] = 0.0
    return jd, td, offsets, mask


def _train_both(monkeypatch, tmp_path, specs, env=LADDER):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jd, td, offsets, mask = _datasets()
    jp, tp = re_problems()
    out = {}
    for name, faults, mod, journal, train in (
            ("jax", jfaults, jmg, JaxJournal, lambda: jre.train_random_effects(
                jp, jd, jnp.asarray(offsets), global_reg_mask=jnp.asarray(mask))),
            ("port", tfaults, mg, RecoveryJournal, lambda: tre.train_random_effects(
                tp, td, torch.from_numpy(offsets),
                global_reg_mask=torch.from_numpy(mask)))):
        path = str(tmp_path / f"{name}.jsonl")
        mod.set_journal(journal(path))
        plan = faults.FaultPlan(seed=0, specs=[faults.FaultSpec(**s) for s in specs])
        try:
            with faults.active_plan(plan) as inj:
                model, _ = train()
        except Exception as e:  # noqa: BLE001 - compared by the caller
            model = e
        finally:
            mod.set_journal(None)
        records = (tre.bucket_records() if name == "port"
                   else list(jre.LAST_BUCKET_TIMINGS))
        out[name] = {"model": model, "fired": inj.fired(),
                     "plans": [(r["solver"], r["chunk"]) for r in records],
                     "sticky": mod.sticky_plan("re.solve"),
                     "rows": _rows(path)}
    return out, td, tp, offsets, mask


def _coef_close(jm, tm, tol=1e-9):
    for a, b in zip(jm.bucket_coefs, tm.bucket_coefs):
        a = np.asarray(a)
        assert np.abs(b.numpy() - a).max() <= tol * max(np.abs(a).max(), 1e-30)


def test_injected_re_oom_downshifts_as_jax(monkeypatch, tmp_path):
    out, td, tp, offsets, mask = _train_both(
        monkeypatch, tmp_path, [dict(site="re.solve", error="device_oom", count=1)])
    port, jax = out["port"], out["jax"]
    assert port["fired"] == jax["fired"] == 1
    assert port["plans"] == jax["plans"]
    assert port["plans"][0] == ("newton_dual", 4)
    assert port["sticky"] == jax["sticky"] == {"chunk": 4, "solver": None}
    assert port["rows"] == jax["rows"]
    assert [(r["event"], r["before"], r["after"]) for r in port["rows"]] == [
        ("oom_downshift", "newton_dual@full", "newton_dual@4")]
    _coef_close(jax["model"], port["model"])
    # bit-equal to the port's own run started at that tier (sticky plan set)
    mg.reset_state()
    mg.set_sticky_plan("re.solve", {"chunk": 4, "solver": None})
    again, _ = tre.train_random_effects(tp, td, torch.from_numpy(offsets),
                                        global_reg_mask=torch.from_numpy(mask))
    assert [(r["solver"], r["chunk"]) for r in tre.bucket_records()] == port["plans"]
    for a, b in zip(again.bucket_coefs, port["model"].bucket_coefs):
        assert torch.equal(a, b)
    assert mg.downshifter("re.solve").count == 0     # nothing planted: no guard


def test_measured_plan_oom_is_demoted_as_jax(monkeypatch, tmp_path):
    env = dict(LADDER, PHOTON_RE_ROUTING="measured")
    monkeypatch.setenv("PHOTON_RE_COST_TABLE", str(tmp_path / "costs.json"))
    from photon_tpu.game import solver_routing as jsr
    from photon_tpu_torch.game import solver_routing as tsr

    jsr.reset_process_table()
    tsr.reset_process_table()
    out, *_ = _train_both(monkeypatch, tmp_path, [dict(
        site="re.solve", error="device_oom", count=1, match={"routing": "measured"})],
        env=env)
    jsr.reset_process_table()
    tsr.reset_process_table()
    port, jax = out["port"], out["jax"]
    assert port["fired"] == jax["fired"] == 1
    assert port["plans"] == jax["plans"] and port["plans"][0] == ("newton_dual", 4)
    assert port["sticky"] == jax["sticky"] == {"chunk": 4, "solver": None}
    assert port["rows"] == jax["rows"]
    assert port["rows"][0]["before"] == "measured(newton_dual@full)"
    _coef_close(jax["model"], port["model"])


@pytest.mark.parametrize("bound", ["3", "1"])
def test_exhausted_ladder_escalates_as_jax(monkeypatch, tmp_path, bound):
    monkeypatch.setenv("PHOTON_OOM_MAX_DOWNSHIFTS", bound)
    out, *_ = _train_both(monkeypatch, tmp_path,
                          [dict(site="re.solve", error="device_oom")])
    port, jax = out["port"], out["jax"]
    assert type(port["model"]).__name__ == type(jax["model"]).__name__ == "DeviceOomError"
    assert port["rows"] == jax["rows"] and port["fired"] == jax["fired"]
    assert port["rows"][-1]["event"] == "oom_exhausted"
    assert len(port["rows"]) == (4 if bound == "3" else 2)


# ------------------------------------------------------------ out of core


OOC_N = 256        # two chunks of 128, or four of 64: the cuts coincide


def test_ooc_oom_halves_chunk_rows(tmp_path):
    idx, val, labels = _data(n=OOC_N, seed=19)
    journal = str(tmp_path / "j.jsonl")
    mg.set_journal(RecoveryJournal(journal))
    plan = tfaults.FaultPlan(specs=[tfaults.FaultSpec(
        site="optim.ooc_chunk", error="device_oom", after=1, count=1)])
    with tfaults.active_plan(plan) as inj:
        m, r = run_out_of_core(_problem(), _chunked(idx, val, labels, 128))
    mg.set_journal(None)
    assert inj.fired("optim.ooc_chunk") == 1
    rows = _rows(journal)
    assert [(x["event"], x["before"], x["after"]) for x in rows] == [
        ("oom_downshift", "chunk_rows=128", "chunk_rows=64")]
    m64, r64 = run_out_of_core(_problem(), _chunked(idx, val, labels, 64))
    assert torch.equal(m.coefficients.means, m64.coefficients.means)
    assert (r.iterations, r.converged_reason, r.data_passes) == \
        (r64.iterations, r64.converged_reason, r64.data_passes)
    # f32 against JAX's uninterrupted out-of-core solve
    jm, jr = jax_run_ooc(_jax_problem(*_kinds()), JaxChunked.from_arrays(
        idx, val, labels, DIM, chunk_rows=128))
    with tfaults.active_plan(plan):
        pm, pr = run_out_of_core(_problem(max_iter=5), _chunked(
            idx, val, labels, 128, dtype=torch.float32))
    assert (pr.iterations, pr.converged_reason, pr.data_passes) == \
        (int(jr.iterations), int(jr.converged_reason), int(jr.data_passes))
    b = np.asarray(jm.coefficients.means, np.float64)
    a = pm.coefficients.means.numpy().astype(np.float64)
    assert np.abs(a - b).max() <= 1e-5 * max(1.0, np.abs(b).max())


def _kinds():
    from photon_tpu_torch.types import TaskType

    return TaskType.LOGISTIC_REGRESSION, OptimizerType.LBFGS, RegularizationType.L2


def test_ooc_oom_at_one_row_escalates(monkeypatch):
    idx, val, labels = _data(n=4, seed=3)
    plan = tfaults.FaultPlan(specs=[tfaults.FaultSpec(site="optim.ooc_chunk",
                                                      error="device_oom")])
    monkeypatch.setenv("PHOTON_OOM_MAX_DOWNSHIFTS", "10")
    with tfaults.active_plan(plan), pytest.raises(tfaults.DeviceOomError):
        run_out_of_core(_problem(), _chunked(idx, val, labels, 4))
    assert mg.downshifter("optim.ooc_chunk").count == 2        # 4 -> 2 -> 1


@pytest.mark.parametrize("with_checkpoint", [True, False])
def test_ooc_device_lost_recovers_in_run(tmp_path, with_checkpoint):
    idx, val, labels = _data(n=300, seed=5)
    ckpt = str(tmp_path / "ooc.ckpt") if with_checkpoint else None
    want_m, want_r = run_out_of_core(_problem(), _chunked(idx, val, labels, 128))
    plan = tfaults.FaultPlan(specs=[tfaults.FaultSpec(
        site="optim.ooc_iteration", error="device_lost", after=4, count=1)])
    with tfaults.active_plan(plan) as inj:
        m, r = run_out_of_core(_problem(), _chunked(idx, val, labels, 128),
                               checkpoint_path=ckpt, checkpoint_min_interval_s=0.0)
    assert inj.fired("optim.ooc_iteration") == 1
    assert torch.equal(m.coefficients.means, want_m.coefficients.means)
    assert (r.iterations, r.converged_reason) == (want_r.iterations,
                                                  want_r.converged_reason)


def test_ooc_device_lost_escalates_past_its_bound(monkeypatch):
    monkeypatch.setenv("PHOTON_DEVICE_LOST_MAX_RECOVERIES", "1")
    idx, val, labels = _data(n=300, seed=5)
    plan = tfaults.FaultPlan(specs=[tfaults.FaultSpec(
        site="optim.ooc_iteration", error="device_lost", after=2)])
    with tfaults.active_plan(plan) as inj, pytest.raises(tfaults.DeviceLostError):
        run_out_of_core(_problem(), _chunked(idx, val, labels, 128))
    assert inj.fired("optim.ooc_iteration") == 2


# ------------------------------------------------------------- watchdog


def _stats(in_use, limit=1000.0):
    return lambda: {"bytes_in_use": in_use, "bytes_limit": limit,
                    "watermark": in_use / limit}


def test_memory_guard_sheds_pins_above_high_water():
    from photon_tpu_torch.data.device_cache import DeviceSweepCache

    assert mg._default_stats() is None           # no CUDA context here
    assert mg.MemoryGuard().check() == jmg.MemoryGuard(
        stats_fn=lambda: None).check() == {"available": False, "watermark": None,
                                           "spilled_bytes": 0}
    cache = DeviceSweepCache(budget_bytes=10_000)
    for i in range(4):
        cache.get_or_put(("ooc_ell", i), 100, lambda: torch.zeros(25))
    cache.dataset_mirror(object())                # not host-resident: no pin
    low = mg.MemoryGuard(stats_fn=_stats(500.0))
    assert low.check() == jmg.MemoryGuard(stats_fn=_stats(500.0)).check()
    assert cache.resident_bytes == 400
    high = mg.MemoryGuard(stats_fn=_stats(980.0), high_water=0.85)
    out = high.check()
    assert out == {"available": True, "watermark": 0.98, "spilled_bytes": 200}
    assert cache.resident_bytes == 200 and cache.spilled_bytes == 200
    # a shed entry is copied on its next use, never pinned again
    cache.get_or_put(("ooc_ell", 0), 100, lambda: torch.zeros(25))
    assert cache.resident_bytes == 200 and ("ooc_ell", 0) not in cache._entries
    assert high.snapshot()["spills"] == 1 and high.under_pressure()


@pytest.mark.parametrize("requested", [100, 400, 501, 10_000])
def test_effective_sweep_budget_and_predegrade_equal_jax(requested):
    mg._GUARD = mg.MemoryGuard(stats_fn=_stats(200.0))
    jmg._GUARD = jmg.MemoryGuard(stats_fn=_stats(200.0))
    for _ in range(3):
        assert mg.effective_sweep_budget(requested) == \
            jmg.effective_sweep_budget(requested)
        port, jax = mg.pre_degrade_for_restart("x"), jmg.pre_degrade_for_restart("x")
        assert port == jax
    assert mg.sticky_plan("re.solve") == jmg.sticky_plan("re.solve")
    mg._GUARD = mg.MemoryGuard(stats_fn=lambda: None)
    assert mg.effective_sweep_budget(requested) == int(requested * 0.125)
