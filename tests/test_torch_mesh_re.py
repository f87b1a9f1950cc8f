"""Random effects under a mesh (``photon_tpu_torch/game/random_effect.py``)
on the CPU: entity-sharded buckets, the chunked tiers, measured routing,
the OOM ladder's mesh-divisible tiers, one lost shard and the sweep cache's
per-device budget, against the port's unsharded solves and the JAX
package's mesh solves.

The port's mesh: N shards on the one CPU device; the JAX package's: N of
the 8 CPU devices ``tests/conftest.py`` forces. Data at float64 with a
ragged entity count (37, or 203 for the chunked tiers, over 4 shards).

Tolerances:
* the port's mesh solve against its unsharded solve: coefficients within
  1e-12, equal plans;
* against the JAX package's mesh solve: equal plans (solver and chunk) and
  the port's f64 parity bar for random effects
  (``tests/test_torch_re_training.py``): coefficients within 1e-9 of the
  largest, equal iterations and reasons;
* the chunk ladder's gates and the OOM ladder's tiers: equal to JAX's at 2,
  4 and 8 shards;
* one lost shard: within 1e-12 of the uninterrupted mesh run.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from photon_tpu.data.random_effect import build_random_effect_dataset as jax_build
from photon_tpu.functions.problem import GLMOptimizationProblem as JaxProblem
from photon_tpu.game import newton_re as jnewton
from photon_tpu.game import random_effect as jre
from photon_tpu.optim import OptimizerConfig as JaxConfig
from photon_tpu.optim import OptimizerType as JaxOptimizer
from photon_tpu.optim import RegularizationContext as JaxReg
from photon_tpu.optim import RegularizationType as JaxRegType
from photon_tpu.parallel.mesh import make_mesh as jax_make_mesh
from photon_tpu.types import TaskType as JaxTask
from photon_tpu_torch.data.random_effect import build_random_effect_dataset
from photon_tpu_torch.functions.problem import GLMOptimizationProblem
from photon_tpu_torch.game import newton_re, solver_routing
from photon_tpu_torch.game import random_effect as tre
from photon_tpu_torch.optim import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
)
from photon_tpu_torch.parallel.mesh import make_mesh
from photon_tpu_torch.runtime import memory_guard as mg
from photon_tpu_torch.types import TaskType

CPU = torch.device("cpu")
TASKS = ("LOGISTIC_REGRESSION", "LINEAR_REGRESSION", "POISSON_REGRESSION",
         "SMOOTHED_HINGE_LOSS_LINEAR_SVM")


def port_mesh(n=4):
    return make_mesh({"data": n}, devices=[CPU] * n)


def jax_mesh(n=4):
    return jax_make_mesh({"data": n}, devices=jax.devices()[:n])


def datasets(seed=0, n_entities=37, rows=6, dim=24, k=4):
    rng = np.random.default_rng(seed)
    n = n_entities * rows
    keys = np.asarray([f"e{i // rows}" for i in range(n)])
    idx = rng.integers(0, dim, size=(n, k)).astype(np.int32)
    val = rng.normal(size=(n, k))
    labels = rng.random(n)
    jd = jax_build("e", keys, idx, val, labels, global_dim=dim, dtype=np.float64)
    td = build_random_effect_dataset("e", keys, idx, val, labels, global_dim=dim,
                                     dtype=torch.float64, device=CPU)
    return jd, td


def problems(task="LOGISTIC_REGRESSION", optimizer="LBFGS", reg="L2", iters=60):
    j = JaxProblem(task=JaxTask[task], optimizer_type=JaxOptimizer[optimizer],
                   optimizer_config=JaxConfig(max_iterations=iters),
                   regularization=JaxReg(JaxRegType[reg]), reg_weight=0.3)
    t = GLMOptimizationProblem(
        task=TaskType[task], optimizer_type=OptimizerType[optimizer],
        optimizer_config=OptimizerConfig(max_iterations=iters),
        regularization=RegularizationContext(RegularizationType[reg]),
        reg_weight=0.3)
    return j, t


def plans(records):
    return [(r["solver"], r["chunk"]) for r in records]


def assert_close(a_models, b_models, atol):
    for a, b in zip(a_models.bucket_coefs, b_models.bucket_coefs):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= atol * max(np.abs(a).max(), 1.0), (
            np.abs(a - b).max())


def assert_parity(jm, jr, tm, tr):
    assert_close(jm, tm, 1e-9)
    for a, b in zip(jr, tr):
        for f in ("iterations", "converged_reason"):
            np.testing.assert_array_equal(getattr(b, f).numpy(),
                                          np.asarray(getattr(a, f)), err_msg=f)


@pytest.fixture(autouse=True)
def _fresh_guards():
    mg.reset_state()
    yield
    mg.reset_state()


# ------------------------------------------------------ full-bucket solves


@pytest.mark.parametrize("task", TASKS)
def test_entity_sharded_full_bucket_matches_unsharded_and_jax(task):
    jd, td = datasets()
    jp, tp = problems(task)
    off = np.zeros(td.n_rows)
    tm1, _ = tre.train_random_effects(tp, td, torch.from_numpy(off))
    p1 = plans(tre.LAST_BUCKET_TIMINGS)
    tm4, tr4 = tre.train_random_effects(tp, td, torch.from_numpy(off),
                                        mesh=port_mesh())
    p4 = plans(tre.LAST_BUCKET_TIMINGS)
    assert p1 == p4 and all(r["shards"] == 4 for r in tre.LAST_BUCKET_TIMINGS)
    assert [r["entities_padded"] % 4 for r in tre.LAST_BUCKET_TIMINGS] == [0] * len(p4)
    assert_close(tm1, tm4, 1e-12)
    jm4, jr4 = jre.train_random_effects(jp, jd, jnp.asarray(off), mesh=jax_mesh())
    assert p4 == plans(jre.LAST_BUCKET_TIMINGS)
    assert_parity(jm4, jr4, tm4, tr4)


@pytest.mark.parametrize("optimizer,reg", [("OWLQN", "L1"), ("TRON", "L2")])
def test_vmapped_lanes_under_a_mesh(optimizer, reg, monkeypatch):
    """The vmapped tier's lanes run per shard, each block over its own lane
    layout (built once per block: the second fit reuses them). TRON's
    bucket takes the lanes with the Newton tiers off in both packages."""
    monkeypatch.setenv("PHOTON_RE_NEWTON", "0")
    jd, td = datasets(seed=1)
    jp, tp = problems(optimizer=optimizer, reg=reg)
    off = torch.from_numpy(np.random.default_rng(2).normal(size=td.n_rows) * 0.1)
    tm1, _ = tre.train_random_effects(tp, td, off)
    tm4, tr4 = tre.train_random_effects(tp, td, off, mesh=port_mesh())
    assert set(plans(tre.LAST_BUCKET_TIMINGS)) == {("vmapped_lbfgs", None)}
    assert_close(tm1, tm4, 1e-12)
    layouts = {k: v[1] for k, v in td.lane_layouts.items()
               if isinstance(k, tuple) and k[0] == "chunk"}
    assert len(layouts) >= 4
    tre.train_random_effects(tp, td, off, mesh=port_mesh())
    assert all(td.lane_layouts[k][1] is v for k, v in layouts.items())
    jm4, jr4 = jre.train_random_effects(jp, jd, jnp.asarray(off.numpy()),
                                        mesh=jax_mesh())
    assert_parity(jm4, jr4, tm4, tr4)


def test_normalized_lanes_under_a_mesh():
    """A normalization context is sliced with the lanes of each shard."""
    from photon_tpu_torch.data.normalization import (
        NormalizationType,
        context_from_statistics,
    )
    from photon_tpu_torch.data.statistics import compute_feature_statistics
    from test_torch_data_parallel import batches

    _, td = datasets(seed=3, dim=40)
    pb, _ = batches("LOGISTIC_REGRESSION", seed=3)
    ctx = context_from_statistics(compute_feature_statistics(pb),
                                  NormalizationType.SCALE_WITH_STANDARD_DEVIATION)
    _, tp = problems()
    off = torch.zeros(td.n_rows, dtype=torch.float64)
    tm1, _ = tre.train_random_effects(tp, td, off, normalization=ctx)
    tm4, _ = tre.train_random_effects(tp, td, off, normalization=ctx,
                                      mesh=port_mesh())
    assert set(plans(tre.LAST_BUCKET_TIMINGS)) == {("vmapped_lbfgs", None)}
    assert_close(tm1, tm4, 1e-12)


def test_priors_and_warm_starts_are_padded_with_the_lanes():
    jd, td = datasets(seed=4)
    _, tp = problems()
    off = torch.zeros(td.n_rows, dtype=torch.float64)
    m0, _ = tre.train_random_effects(tp, td, off)
    priors = m0.project_prior_to(td, incremental_weight=2.0)
    m1, _ = tre.train_random_effects(tp, td, off * 2, priors=priors,
                                     init_coefs=m0.bucket_coefs)
    m4, _ = tre.train_random_effects(tp, td, off * 2, priors=priors,
                                     init_coefs=m0.bucket_coefs, mesh=port_mesh())
    assert_close(m1, m4, 1e-12)


# ------------------------------------------------------------- chunked tiers


def _chunk_budget_window(jd, n_dev, chunk):
    """The JAX mesh test's budget: every full tier refused on both arms,
    the chunked primal tier admitted at ``chunk``."""
    big = max(jd.buckets, key=lambda b: b.n_entities)
    e, s, _ = big.idx.shape
    p = big.local_dim
    e_dev = -(-e // n_dev)
    b_hi = jnewton._primal_need_bytes(e_dev, s, p, 8.0)
    if s < p:
        b_hi = min(b_hi, jnewton._dual_need_bytes(e_dev, s, p, 1, 8.0))
    b_lo = jnewton._primal_need_bytes(chunk, s, p, 8.0)
    assert b_lo < b_hi
    return ((b_lo + b_hi) / 2) / 1e6


@pytest.mark.parametrize("task", ["LOGISTIC_REGRESSION", "POISSON_REGRESSION"])
def test_chunked_tier_under_a_mesh_matches_unsharded_and_jax(task, monkeypatch):
    """203 entities (ragged over 4), chunks of 16 cut into 4 lanes a shard."""
    jd, td = datasets(seed=5, n_entities=203, rows=8, dim=6)
    monkeypatch.setenv("PHOTON_RE_CHUNK_LADDER", "16")
    monkeypatch.setenv("PHOTON_RE_NEWTON_BUDGET_MB",
                       str(_chunk_budget_window(jd, 4, 16)))
    jp, tp = problems(task)
    off = np.zeros(td.n_rows)
    tm1, _ = tre.train_random_effects(tp, td, torch.from_numpy(off))
    p1 = plans(tre.LAST_BUCKET_TIMINGS)
    tm4, tr4 = tre.train_random_effects(tp, td, torch.from_numpy(off),
                                        mesh=port_mesh())
    p4 = plans(tre.LAST_BUCKET_TIMINGS)
    assert ("newton_primal", 16) in p1 and ("newton_primal", 16) in p4
    assert_close(tm1, tm4, 1e-12)
    jm4, jr4 = jre.train_random_effects(jp, jd, jnp.asarray(off), mesh=jax_mesh())
    assert p4 == plans(jre.LAST_BUCKET_TIMINGS)
    assert_parity(jm4, jr4, tm4, tr4)


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("budget_mb", ["0.002", "0.01", "0.05", "2048"])
def test_chunk_plan_equals_jax(shards, budget_mb, monkeypatch):
    """Every gate that decides a bucket's plan, per-device priced and
    mesh-divisible, gives JAX's answer for the same bucket and shard
    count."""
    monkeypatch.setenv("PHOTON_RE_NEWTON_BUDGET_MB", budget_mb)
    monkeypatch.setenv("PHOTON_RE_CHUNK_LADDER", "4,6,8,16,32,64")
    jd, td = datasets(seed=6, n_entities=150, rows=6, dim=30)
    jp, tp = problems()
    for jb, tb in zip(jd.buckets, td.buckets):
        for u in (0, 1, 3):
            assert newton_re.newton_eligible(tp, tb, None, shards=shards) == \
                jnewton.newton_eligible(jp, jb, None, shards=shards)
            assert newton_re.newton_chunk_size(tp, tb, None, shards=shards) == \
                jnewton.newton_chunk_size(jp, jb, None, shards=shards)
            assert newton_re.dual_eligible(tp, tb, None, u, shards=shards) == \
                jnewton.dual_eligible(jp, jb, None, u, shards=shards)
            assert newton_re.dual_chunk_size(tp, tb, None, u, shards=shards) == \
                jnewton.dual_chunk_size(jp, jb, None, u, shards=shards)
    for solver in ("newton_primal", "newton_dual", "vmapped_lbfgs"):
        for chunk in (None, 64, 16, 8, 4):
            for chunkable in (True, False):
                assert tre._oom_next_tier(solver, chunk, 150, chunkable, shards) == \
                    jre._oom_next_tier(solver, chunk, 150, chunkable, shards)
            for cap in (5, 12, 30, 100):
                sticky = {"chunk": cap, "solver": None}
                assert tre._apply_sticky_plan((solver, chunk), sticky, 150, True,
                                              shards) == \
                    jre._apply_sticky_plan((solver, chunk), sticky, 150, True, shards)
    if shards <= 4 and budget_mb == "0.01":   # the chunked tiers' window
        off = np.zeros(td.n_rows)
        tre.train_random_effects(tp, td, torch.from_numpy(off),
                                 mesh=port_mesh(shards))
        jre.train_random_effects(jp, jd, jnp.asarray(off), mesh=jax_mesh(shards))
        assert plans(tre.LAST_BUCKET_TIMINGS) == plans(jre.LAST_BUCKET_TIMINGS)


def test_oom_ladder_under_a_mesh_keeps_divisible_tiers(monkeypatch):
    """An injected OOM at the full tier steps down to a mesh-divisible
    chunk, as JAX's ladder does, and lands on the tier's own result."""
    from photon_tpu_torch.faults import FaultPlan, FaultSpec, active_plan

    monkeypatch.setenv("PHOTON_RE_CHUNK_LADDER", "6,8,16")
    _, td = datasets(seed=7, n_entities=40)
    _, tp = problems()
    off = torch.zeros(td.n_rows, dtype=torch.float64)
    plan = FaultPlan(specs=[FaultSpec(site="re.solve", error="device_oom",
                                      count=1)])
    with active_plan(plan):
        m, _ = tre.train_random_effects(tp, td, off, mesh=port_mesh())
    got = plans(tre.LAST_BUCKET_TIMINGS)
    assert got[0][1] is not None and got[0][1] % 4 == 0, got
    mg.reset_state()
    m1, _ = tre.train_random_effects(tp, td, off)
    assert_close(m1, m, 1e-12)


# ------------------------------------------------------------ measured routing


def test_measured_routing_under_a_mesh(monkeypatch, tmp_path):
    """The race runs on sharded probes and keeps its costs under the
    shape key with the shard count (``@dev4``), beside the unsharded
    key."""
    jd, td = datasets(seed=8, n_entities=24)
    _, tp = problems()
    off = torch.zeros(td.n_rows, dtype=torch.float64)
    table = tmp_path / "costs.json"
    monkeypatch.setenv("PHOTON_RE_ROUTING", "measured")
    monkeypatch.setenv("PHOTON_RE_COST_TABLE", str(table))
    solver_routing.reset_process_table()
    try:
        m1, _ = tre.train_random_effects(tp, td, off)
        m4, _ = tre.train_random_effects(tp, td, off, mesh=port_mesh())
        assert "measured" in [r["routing"] for r in tre.LAST_BUCKET_TIMINGS]
        keys = json.loads(table.read_text())["entries"]
        assert any(k.endswith("@dev4") for k in keys), keys
        assert any("@dev" not in k for k in keys), keys
    finally:
        solver_routing.reset_process_table()
    assert_close(m1, m4, 1e-3)   # the two arms may crown different tiers
    b = td.buckets[0]
    assert solver_routing.shape_class(b, 1) == solver_routing.shape_class(b)
    assert solver_routing.shape_class(b, 4) == solver_routing.shape_class(b) + "@dev4"


# ------------------------------------------------------------ shard loss


@pytest.mark.chaos
def test_single_shard_loss_redistributes_and_completes(tmp_path):
    """One injected ``device_lost`` at ``re.shard``: the bucket solves again
    on the next smaller mesh in the same process, within 1e-12 of the
    uninterrupted mesh run, with a ``shard_lost`` journal row; the
    degraded mesh is sticky for the run."""
    from photon_tpu_torch.faults import FaultPlan, FaultSpec, active_plan
    from photon_tpu_torch.obs.metrics import REGISTRY
    from photon_tpu_torch.supervisor import RecoveryJournal

    _, td = datasets(seed=9)
    _, tp = problems()
    off = torch.zeros(td.n_rows, dtype=torch.float64)
    mesh = port_mesh(4)
    m_ok, _ = tre.train_random_effects(tp, td, off, mesh=mesh)
    journal = RecoveryJournal(str(tmp_path / "recovery.jsonl"))
    prev = mg.set_journal(journal)
    losses0 = REGISTRY.counter("re_shard_losses_total").value()
    try:
        plan = FaultPlan(specs=[FaultSpec(site="re.shard", error="device_lost",
                                          count=1)])
        with active_plan(plan) as inj:
            m_rec, _ = tre.train_random_effects(tp, td, off, mesh=mesh)
        assert inj.fired("re.shard") == 1
    finally:
        mg.set_journal(prev)
    rows = [json.loads(line) for line in
            (tmp_path / "recovery.jsonl").read_text().splitlines()]
    lost = [r for r in rows if r["event"] == "shard_lost"]
    assert len(lost) == 1 and lost[0]["cause"] == "device_lost"
    assert lost[0]["site"] == "re.shard"
    assert (lost[0]["devices_before"], lost[0]["devices_after"]) == (4, 2)
    assert REGISTRY.counter("re_shard_losses_total").value() == losses0 + 1
    assert mg.sticky_plan("re.shard") == {"shards": 2}
    assert_close(m_ok, m_rec, 1e-12)
    m_next, _ = tre.train_random_effects(tp, td, off, mesh=mesh)
    assert {r["shards"] for r in tre.LAST_BUCKET_TIMINGS} == {2}
    assert_close(m_ok, m_next, 1e-12)


@pytest.mark.chaos
def test_shard_loss_on_one_shard_escalates():
    """With no shard to lose (no mesh, or a one-shard mesh) a device loss
    propagates to the caller's recovery, as in JAX."""
    from photon_tpu_torch.faults import DeviceLostError, FaultPlan, FaultSpec
    from photon_tpu_torch.faults import active_plan

    _, td = datasets(seed=10, n_entities=8)
    _, tp = problems()
    off = torch.zeros(td.n_rows, dtype=torch.float64)
    for mesh, site in ((None, "re.solve"), (port_mesh(1), "re.solve")):
        mg.reset_state()
        plan = FaultPlan(specs=[FaultSpec(site=site, error="device_lost", count=1)])
        with active_plan(plan):
            with pytest.raises(DeviceLostError):
                tre.train_random_effects(tp, td, off, mesh=mesh)
    assert tre._degrade_mesh(port_mesh(1), "data") is None


# ------------------------------------------------------------- sweep cache


def test_sweep_cache_budget_is_per_device_and_pins_shards():
    """A mesh-attached cache's total is its per-device budget times the
    entity shards (shrunk by a sticky shard loss); its mirror pads every
    bucket to the mesh multiple and pins one block of lanes a shard, and
    a solve over the mirror equals the unsharded solve."""
    from photon_tpu_torch.data.device_cache import DeviceSweepCache

    _, td = datasets(seed=11)
    host = build_random_effect_dataset(
        "e", *_host_inputs(11), dtype=torch.float64, device=CPU,
        host_resident=True)
    cache = DeviceSweepCache(1_000_000, mesh=port_mesh(4))
    assert cache.n_devices == 4 and cache.budget_bytes == 4_000_000
    assert DeviceSweepCache(1_000_000).budget_bytes == 1_000_000
    mirror = cache.dataset_mirror(host)
    assert cache.dataset_mirror(host) is mirror
    assert mirror.shard_pins is not None
    for b, pins in zip(mirror.buckets, mirror.shard_pins):
        assert len(pins) == 4 and b.n_entities % 4 == 0
        assert sum(p.n_entities for p in pins) == b.n_entities
    _, tp = problems()
    off = torch.zeros(td.n_rows, dtype=torch.float64)
    m1, _ = tre.train_random_effects(tp, td, off)
    m4, _ = tre.train_random_effects(tp, mirror, off, mesh=port_mesh(4))
    for a, b, e in zip(m1.bucket_coefs, m4.bucket_coefs, td.buckets):
        np.testing.assert_allclose(b[: e.n_entities].numpy(), a.numpy(),
                                   rtol=0, atol=1e-12)
    np.testing.assert_allclose(m4.score_dataset(mirror).numpy(),
                               m1.score_dataset(td).numpy(), rtol=0, atol=1e-12)
    mg.set_sticky_plan("re.shard", {"shards": 2})
    assert cache.effective_devices() == 2 and cache.budget_bytes == 2_000_000


def _host_inputs(seed, n_entities=37, rows=6, dim=24, k=4):
    rng = np.random.default_rng(seed)
    n = n_entities * rows
    keys = np.asarray([f"e{i // rows}" for i in range(n)])
    idx = rng.integers(0, dim, size=(n, k)).astype(np.int32)
    val = rng.normal(size=(n, k))
    labels = rng.random(n)
    return keys, idx, val, labels, dim
