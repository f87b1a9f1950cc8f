"""GAME training with random effects in the port against the JAX package.

On the CPU, in float64, from the same numpy data:

* ``train_random_effects`` picks the plan JAX's ``_solve_bucket`` picks
  (full primal, full dual, chunked primal, chunked dual, vmapped), with the
  budget and chunk ladder set by the environment for both, and trains the
  same coefficients (1e-9 of the largest); an OWL-QN / L1 random effect and
  a normalized one (L-BFGS, TRON) solve on the vmapped tier as masked
  batched lanes, with JAX's per-lane iterations, reasons and data passes; a
  ``measured`` routing request raises in the port, naming its slice.
* ``GameEstimator.fit`` with STANDARDIZATION, down-sampling 0.5 and an L1
  OWL-QN random effect matches the JAX fit within 1e-6.
* ``GameEstimator.fit`` with a fixed effect and a random effect, 2 sweeps,
  two random-effect weights and validation with ``AUC`` and
  ``LOGISTIC_LOSS``: each step's coordinate scores on the training rows
  (every sweep of every configuration) agree within 1e-8 of the largest
  |score|, every step's
  validation metrics within 1e-10 relative, and the chosen configuration is
  the same; on data whose buckets take the primal path and data whose
  buckets take the dual path.
* Incremental training: priors projected from a trained model
  (``project_prior_to``) give the same fit in both packages.
* The coordinate DSL parses random-effect specs into the JAX parser's
  data and optimization fields.
* Each package's training driver (``--evaluators``, ``--validation-data``,
  a two-weight sweep, 2 sweeps) writes a model the other package's scoring
  driver scores as its own: scores within the fixed-effect cross test's
  float64 ``atol 1e-12`` (``tests/test_torch_training_driver.py``);
  the saved coefficients agree to ``atol 1e-8`` and the summaries match.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu.cli import game_scoring_driver as jax_scoring
from photon_tpu.cli import game_training_driver as jax_training
from photon_tpu.data.batch import SparseFeatures as JaxFeatures
from photon_tpu.data.random_effect import build_random_effect_dataset as jax_build
from photon_tpu.estimators.config import FixedEffectDataConfig as JaxFixedCfg
from photon_tpu.estimators.config import GLMOptimizationConfiguration as JaxOpt
from photon_tpu.estimators.config import RandomEffectDataConfig as JaxRECfg
from photon_tpu.estimators.game_estimator import GameEstimator as JaxEstimator
from photon_tpu.estimators.game_estimator import select_best as jax_select_best
from photon_tpu.evaluation import EvaluationSuite as JaxSuite
from photon_tpu.functions.problem import GLMOptimizationProblem as JaxProblem
from photon_tpu.functions.problem import VarianceComputationType as JaxVariance
from photon_tpu.game import random_effect as jre
from photon_tpu.io.avro import read_records
from photon_tpu.io.data_reader import GameDataBundle as JaxBundle
from photon_tpu.optim import OptimizerConfig as JaxConfig
from photon_tpu.optim import OptimizerType as JaxOptimizer
from photon_tpu.optim import RegularizationContext as JaxReg
from photon_tpu.optim import RegularizationType as JaxRegType
from photon_tpu.types import TaskType as JaxTask
from photon_tpu_torch.cli import game_scoring_driver, game_training_driver
from photon_tpu_torch.data.batch import SparseFeatures
from photon_tpu_torch.data.random_effect import build_random_effect_dataset
from photon_tpu_torch.estimators.config import (
    FixedEffectDataConfig,
    GLMOptimizationConfiguration,
    RandomEffectDataConfig,
)
from photon_tpu_torch.estimators.game_estimator import GameEstimator, select_best
from photon_tpu_torch.evaluation import EvaluationSuite
from photon_tpu_torch.functions.problem import (
    GLMOptimizationProblem,
    VarianceComputationType,
)
from photon_tpu_torch.game import random_effect as tre
from photon_tpu_torch.io.data_reader import GameDataBundle
from photon_tpu_torch.optim import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
)
from photon_tpu_torch.types import TaskType
from test_torch_scoring_driver import _write_game_avro

CPU = torch.device("cpu")


def game_arrays(seed, n_users=10, rows=(5, 14), d_global=6, k_global=3,
                d_user=3, k_user=2):
    """GAME rows: an intercept (column 0), ``k_global`` entries of a global
    block and ``k_user`` of the row's user block; labels from a logistic
    model with per-user weights (shared by every seed)."""
    truth = np.random.default_rng(99)
    wg = truth.normal(size=d_global) * 0.5
    wu = truth.normal(size=(n_users, d_user))
    rng = np.random.default_rng(seed)
    counts = rng.integers(*rows, size=n_users)
    users = rng.permutation(np.repeat(np.arange(n_users), counts))
    n = len(users)
    gi = 1 + np.stack([rng.choice(d_global, size=k_global, replace=False)
                       for _ in range(n)])
    gv = rng.normal(size=(n, k_global))
    ul = np.stack([rng.choice(d_user, size=k_user, replace=False) for _ in range(n)])
    ui = 1 + d_global + users[:, None] * d_user + ul
    uv = rng.normal(size=(n, k_user))
    idx = np.concatenate([np.zeros((n, 1), int), gi, ui], axis=1).astype(np.int32)
    val = np.concatenate([np.ones((n, 1)), gv, uv], axis=1)
    z = (gv * wg[gi - 1]).sum(1) + (uv * wu[users[:, None], ul]).sum(1)
    labels = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    offsets = rng.normal(size=n) * 0.1
    keys = np.array([f"u{u}" for u in users], object)
    return idx, val, 1 + d_global + n_users * d_user, labels, offsets, keys


def bundles(seed, **kw):
    idx, val, dim, labels, offsets, keys = game_arrays(seed, **kw)
    common = dict(labels=labels, offsets=offsets, weights=np.ones(len(labels)),
                  uids=np.arange(len(labels)).astype(object),
                  id_tags={"userId": keys})
    jb = JaxBundle(features={"global": JaxFeatures(jnp.asarray(idx), jnp.asarray(val),
                                                   dim)}, **common)
    tb = GameDataBundle(features={"global": SparseFeatures(
        torch.from_numpy(idx), torch.from_numpy(val), dim)}, **common)
    return jb, tb


def opt_pair(reg_weight, variance="SIMPLE", max_iter=30):
    j = JaxOpt(regularization=JaxReg(JaxRegType.L2), reg_weight=reg_weight,
               max_iterations=max_iter, variance_type=JaxVariance[variance])
    t = GLMOptimizationConfiguration(
        regularization=RegularizationContext(RegularizationType.L2),
        reg_weight=reg_weight, max_iterations=max_iter,
        variance_type=VarianceComputationType[variance])
    return j, t


# Primal data: per-user subspaces of ≤ 16 columns (S > P); dual data: a
# wide global block makes P 64-128 with S ≤ 16.
SHAPES = {"primal": dict(), "dual": dict(rows=(4, 12), d_global=120, k_global=10)}


def estimators(n_sweeps, evaluators=("AUC", "LOGISTIC_LOSS")):
    j = JaxEstimator(
        task=JaxTask.LOGISTIC_REGRESSION,
        coordinate_data_configs={"fixed": JaxFixedCfg("global"),
                                 "perUser": JaxRECfg("userId", "global")},
        n_sweeps=n_sweeps, evaluator_specs=evaluators,
        intercept_indices={"global": 0})
    t = GameEstimator(
        task=TaskType.LOGISTIC_REGRESSION,
        coordinate_data_configs={"fixed": FixedEffectDataConfig("global"),
                                 "perUser": RandomEffectDataConfig("userId", "global")},
        n_sweeps=n_sweeps, evaluator_specs=evaluators,
        intercept_indices={"global": 0})
    return j, t


def record_step_scores(monkeypatch, coordinate_classes, to_numpy):
    """Wrap each coordinate class's ``score``: the descent scores the model
    of every step once, so the list gets each step's coordinate scores on
    the training rows, in step order."""
    seen = []
    for cls in coordinate_classes:
        orig = cls.score

        def score(self, model, orig=orig):
            out = orig(self, model)
            seen.append(to_numpy(out))
            return out

        monkeypatch.setattr(cls, "score", score)
    return seen


@pytest.mark.parametrize("shape", list(SHAPES))
def test_game_fit_matches_jax(shape, monkeypatch):
    from photon_tpu.game import coordinates as jcoords
    from photon_tpu_torch.game import coordinates as tcoords

    jsteps = record_step_scores(
        monkeypatch, (jcoords.FixedEffectCoordinate, jcoords.RandomEffectCoordinate),
        np.asarray)
    tsteps = record_step_scores(
        monkeypatch, (tcoords.FixedEffectCoordinate, tcoords.RandomEffectCoordinate),
        lambda t: t.numpy())
    jtrain, ttrain = bundles(1, **SHAPES[shape])
    jval, tval = bundles(2, **SHAPES[shape])
    n_sweeps = 2
    jest, test = estimators(n_sweeps)
    jcfgs, tcfgs = [], []
    for rw in (1.0, 30.0):
        jf, tf = opt_pair(1.0)
        jr, tr = opt_pair(rw)
        jcfgs.append({"fixed": jf, "perUser": jr})
        tcfgs.append({"fixed": tf, "perUser": tr})
    jres = jest.fit(jtrain, jval, jcfgs)
    tres = test.fit(ttrain, tval, tcfgs)
    plans = [(r["solver"], r["chunk"]) for r in tre.bucket_records()]
    assert plans == [(r["solver"], r["chunk"]) for r in jre.LAST_BUCKET_TIMINGS]
    assert ("newton_dual" if shape == "dual" else "newton_primal", None) in plans
    # each (config, sweep, coordinate) step's scores on the training rows
    assert len(tsteps) == len(jsteps) == 2 * 2 * n_sweeps
    for got, want in zip(tsteps, jsteps):
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got - want).max() <= 1e-8 * scale
    for jr_, tr_ in zip(jres, tres):
        assert len(tr_.tracker) == len(jr_.tracker) == 2 * n_sweeps
        for jrec, trec in zip(jr_.tracker, tr_.tracker):
            assert (trec.sweep, trec.coordinate_id) == (jrec.sweep, jrec.coordinate_id)
            for k, want in jrec.validation.values.items():
                got = trec.validation.values[k]
                assert abs(got - want) <= 1e-10 * abs(want), (k, got, want)
        for k, want in jr_.evaluation.values.items():
            assert abs(tr_.evaluation.values[k] - want) <= 1e-10 * abs(want)
    jbest = jax_select_best(jres, JaxSuite.parse(["AUC", "LOGISTIC_LOSS"]))
    tbest = select_best(tres, EvaluationSuite.parse(["AUC", "LOGISTIC_LOSS"]))
    assert [r is jbest for r in jres] == [r is tbest for r in tres]


def re_problems(optimizer="LBFGS", reg="L2", variance="NONE"):
    jp = JaxProblem(task=JaxTask.LOGISTIC_REGRESSION,
                    optimizer_type=JaxOptimizer[optimizer],
                    optimizer_config=JaxConfig(max_iterations=30),
                    regularization=JaxReg(JaxRegType[reg]), reg_weight=0.8,
                    variance_type=JaxVariance[variance])
    tp = GLMOptimizationProblem(task=TaskType.LOGISTIC_REGRESSION,
                                optimizer_type=OptimizerType[optimizer],
                                optimizer_config=OptimizerConfig(max_iterations=30),
                                regularization=RegularizationContext(RegularizationType[reg]),
                                reg_weight=0.8,
                                variance_type=VarianceComputationType[variance])
    return jp, tp


def re_datasets(shape, intercept=0):
    idx, val, dim, labels, offsets, keys = game_arrays(1, **SHAPES[shape])
    jd = jax_build("u", keys, idx, val, labels, dim, intercept_index=intercept,
                   dtype=np.float64)
    td = build_random_effect_dataset("u", keys, idx, val, labels, dim,
                                     intercept_index=intercept,
                                     dtype=torch.float64, device=CPU)
    mask = np.ones(dim)
    mask[0] = 0.0
    return jd, td, offsets, mask


PLANS = {
    "full_primal": ("primal", {}),
    "full_dual": ("dual", {}),
    "chunked_primal": ("primal", {"PHOTON_RE_NEWTON_BUDGET_MB": "0.02",
                                  "PHOTON_RE_CHUNK_LADDER": "2,4"}),
    "chunked_dual": ("dual", {"PHOTON_RE_NEWTON_BUDGET_MB": "0.03",
                              "PHOTON_RE_CHUNK_LADDER": "1,2"}),
}


@pytest.mark.parametrize("plan", list(PLANS))
def test_train_random_effects_plans_and_fits_as_jax(monkeypatch, plan):
    shape, env = PLANS[plan]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jd, td, offsets, mask = re_datasets(shape)
    jp, tp = re_problems(variance="SIMPLE")
    jm, jr = jre.train_random_effects(jp, jd, jnp.asarray(offsets),
                                      global_reg_mask=jnp.asarray(mask))
    tm, tr = tre.train_random_effects(tp, td, torch.from_numpy(offsets),
                                      global_reg_mask=torch.from_numpy(mask))
    want = [(r["solver"], r["chunk"]) for r in jre.LAST_BUCKET_TIMINGS]
    got = [(r["solver"], r["chunk"]) for r in tre.bucket_records()]
    assert got == want
    solver, chunked = plan.split("_")[1], plan.startswith("chunked")
    assert any(s == f"newton_{solver}" and (c is not None) == chunked for s, c in got)
    for a, b in zip(jm.bucket_coefs, tm.bucket_coefs):
        a = np.asarray(a)
        assert np.abs(b.numpy() - a).max() <= 1e-9 * max(np.abs(a).max(), 1e-30)
    for a, b in zip(jm.bucket_variances, tm.bucket_variances):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-9)
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(b.iterations.numpy(), np.asarray(a.iterations))
        np.testing.assert_array_equal(b.converged_reason.numpy(),
                                      np.asarray(a.converged_reason))
    np.testing.assert_allclose(tm.score_dataset(td).numpy(),
                               np.asarray(jm.score_dataset(jd)), rtol=0, atol=1e-9)


def test_incremental_priors_fit_as_jax():
    jd, td, offsets, mask = re_datasets("primal")
    jp, tp = re_problems(variance="SIMPLE")
    jm0, _ = jre.train_random_effects(jp, jd, jnp.asarray(offsets))
    tm0, _ = tre.train_random_effects(tp, td, torch.from_numpy(offsets))
    jpri = jm0.project_prior_to(jd, incremental_weight=2.0)
    tpri = tm0.project_prior_to(td, incremental_weight=2.0)
    for a, b in zip(jpri, tpri):
        np.testing.assert_allclose(b.precisions.numpy(), np.asarray(a.precisions),
                                   rtol=1e-9)
    jm, _ = jre.train_random_effects(jp, jd, jnp.asarray(offsets) * 2, priors=jpri)
    tm, _ = tre.train_random_effects(tp, td, torch.from_numpy(offsets) * 2,
                                     priors=tpri)
    for a, b in zip(jm.bucket_coefs, tm.bucket_coefs):
        a = np.asarray(a)
        assert np.abs(b.numpy() - a).max() <= 1e-9 * np.abs(a).max()


def test_vmapped_plan_and_measured_routing_raise(monkeypatch):
    """A bucket whose static plan is the vmapped tier (OWL-QN / L1) solves
    as masked batched lanes, as JAX's vmapped solve does; under ``measured``
    routing such a bucket admits no Newton candidate, so it races nothing
    and solves the whole bucket as lanes, to the static run's coefficients
    bit for bit."""
    jd, td, offsets, mask = re_datasets("primal")
    jp, tp = re_problems(optimizer="OWLQN", reg="L1")
    jm, jr = jre.train_random_effects(jp, jd, jnp.asarray(offsets),
                                      global_reg_mask=jnp.asarray(mask))
    tm, tr = tre.train_random_effects(tp, td, torch.from_numpy(offsets),
                                      global_reg_mask=torch.from_numpy(mask))
    plans = [(r["solver"], r["chunk"]) for r in tre.bucket_records()]
    assert plans == [(r["solver"], r["chunk"]) for r in jre.LAST_BUCKET_TIMINGS]
    assert plans and all(p == ("vmapped_lbfgs", None) for p in plans)
    assert_same_fit(jm, jr, tm, tr)
    monkeypatch.setenv("PHOTON_RE_ROUTING", "measured")
    monkeypatch.delenv("PHOTON_RE_COST_TABLE", raising=False)
    mm, _ = tre.train_random_effects(tp, td, torch.from_numpy(offsets),
                                     global_reg_mask=torch.from_numpy(mask))
    recs = tre.bucket_records()
    assert recs and all(
        (r["routing"], r["solver"], r["chunk"], r["calibrated"])
        == ("measured", "vmapped_lbfgs", None, False) for r in recs)
    for a, b in zip(tm.bucket_coefs, mm.bucket_coefs):
        assert torch.equal(a, b)


def assert_same_fit(jm, jr, tm, tr, coef_tol=1e-9):
    for a, b in zip(jm.bucket_coefs, tm.bucket_coefs):
        a = np.asarray(a)
        assert np.abs(b.numpy() - a).max() <= coef_tol * max(np.abs(a).max(), 1e-30)
    for a, b in zip(jr, tr):
        for f in ("iterations", "converged_reason", "data_passes"):
            np.testing.assert_array_equal(getattr(b, f).numpy(),
                                          np.asarray(getattr(a, f)), err_msg=f)


@pytest.mark.parametrize("optimizer,ntype", [
    ("LBFGS", "STANDARDIZATION"), ("TRON", "SCALE_WITH_STANDARD_DEVIATION"),
    ("LBFGS", "SCALE_WITH_MAX_MAGNITUDE")])
def test_normalized_random_effects_take_the_vmapped_tier_as_jax(optimizer, ntype):
    """A shard context turns the Newton tiers off in both packages: every
    bucket solves on the vmapped tier with the context gathered into its
    lanes, to the same per-lane results."""
    from photon_tpu.data.normalization import NormalizationType as JaxNormType
    from photon_tpu.data.normalization import context_from_statistics as jax_ctx
    from photon_tpu.data.statistics import compute_feature_statistics as jax_stats
    from photon_tpu_torch.data.normalization import (
        NormalizationType,
        context_from_statistics,
    )
    from photon_tpu_torch.data.statistics import compute_feature_statistics

    jd, td, offsets, mask = re_datasets("dual")
    jp, tp = re_problems(optimizer=optimizer, variance="SIMPLE")
    jb, tb = bundles(1, **SHAPES["dual"])
    jctx = jax_ctx(jax_stats(jb.batch("global")), JaxNormType[ntype], 0)
    tctx = context_from_statistics(compute_feature_statistics(tb.batch("global")),
                                   NormalizationType[ntype], 0)
    jm, jr = jre.train_random_effects(jp, jd, jnp.asarray(offsets),
                                      global_reg_mask=jnp.asarray(mask),
                                      normalization=jctx)
    tm, tr = tre.train_random_effects(tp, td, torch.from_numpy(offsets),
                                      global_reg_mask=torch.from_numpy(mask),
                                      normalization=tctx)
    plans = [r["solver"] for r in tre.bucket_records()]
    assert plans == [r["solver"] for r in jre.LAST_BUCKET_TIMINGS]
    assert set(plans) == {"vmapped_lbfgs"}
    assert_same_fit(jm, jr, tm, tr)
    for a, b in zip(jm.bucket_variances, tm.bucket_variances):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-9)


def test_normalized_down_sampled_l1_game_fit_matches_jax():
    """``GameEstimator.fit`` with STANDARDIZATION, down-sampling 0.5 on
    both coordinates and an L1 OWL-QN random effect: the same rows kept,
    coefficients and validation metrics within 1e-6, and a second
    configuration (its own down-sampling key) alike."""
    import dataclasses

    from photon_tpu.data.normalization import NormalizationType as JaxNormType
    from photon_tpu_torch.data.normalization import NormalizationType

    jtrain, ttrain = bundles(1)
    jval, tval = bundles(2)
    jest, test = estimators(2)
    jest.normalization = JaxNormType.STANDARDIZATION
    test.normalization = NormalizationType.STANDARDIZATION
    jcfgs, tcfgs = [], []
    for rw in (0.3, 1.0):
        jf, tf = opt_pair(1.0)
        jcfgs.append({
            "fixed": dataclasses.replace(jf, down_sampling_rate=0.5),
            "perUser": JaxOpt(optimizer_type=JaxOptimizer.OWLQN,
                              regularization=JaxReg(JaxRegType.L1), reg_weight=rw,
                              max_iterations=30, down_sampling_rate=0.5)})
        tcfgs.append({
            "fixed": dataclasses.replace(tf, down_sampling_rate=0.5),
            "perUser": GLMOptimizationConfiguration(
                optimizer_type=OptimizerType.OWLQN,
                regularization=RegularizationContext(RegularizationType.L1),
                reg_weight=rw, max_iterations=30, down_sampling_rate=0.5)})
    jres = jest.fit(jtrain, jval, jcfgs)
    tres = test.fit(ttrain, tval, tcfgs)
    assert {r["solver"] for r in tre.bucket_records()} == {"vmapped_lbfgs"}
    for jr_, tr_ in zip(jres, tres):
        jf = np.asarray(jr_.model["fixed"].model.coefficients.means)
        tf = tr_.model["fixed"].model.coefficients.means.numpy()
        assert np.abs(tf - jf).max() <= 1e-6 * np.abs(jf).max()
        for a, b in zip(jr_.model["perUser"].bucket_coefs,
                        tr_.model["perUser"].bucket_coefs):
            a = np.asarray(a)
            assert np.abs(b.numpy() - a).max() <= 1e-6 * max(np.abs(a).max(), 1e-30)
        for k, want in jr_.evaluation.values.items():
            assert abs(tr_.evaluation.values[k] - want) <= 1e-6 * abs(want), k
    # the down-sampled fixed-effect weights are JAX's, per configuration
    ja = [np.asarray(r.model["fixed"].model.coefficients.means) for r in jres]
    assert np.abs(ja[0] - ja[1]).max() > 0


RE_SPEC = ("perUser:type=random,re_type=userId,shard=global,reg=L2,"
           "reg_weights=1|10,max_iter=20,variance=SIMPLE")
FE_SPEC = "fixed:type=fixed,shard=global,reg=L2,reg_weights=1,variance=SIMPLE"


@pytest.fixture(scope="module")
def avro_data(tmp_path_factory):
    jnp.zeros(1).block_until_ready()
    d = tmp_path_factory.mktemp("torch_re_driver")
    _write_game_avro(d / "train.avro", seed=1, offsets=True)
    _write_game_avro(d / "valid.avro", seed=3, offsets=True)
    _write_game_avro(d / "score.avro", seed=2, n_users=10, rows_per_user=6,
                     offsets=True)
    return d


def _saved_re(model_dir):
    out = {}
    for rec in read_records(str(model_dir / "random-effect" / "perUser" / "part-00000.avro")):
        for m in rec["means"]:
            out[(rec["modelId"], m["name"], m["term"])] = m["value"]
    return out


def test_drivers_cross_score_random_effect_models(avro_data, tmp_path):
    d = avro_data
    common = ["--train-data", str(d / "train.avro"), "--validation-data",
              str(d / "valid.avro"), "--evaluators", "AUC", "LOGISTIC_LOSS",
              "--task", "LOGISTIC_REGRESSION", "--coordinate", FE_SPEC,
              "--coordinate", RE_SPEC, "--sweeps", "2", "--dtype", "float64",
              "--output-mode", "ALL"]
    js = jax_training.run(common + ["--output-dir", str(tmp_path / "jax"),
                                    "--devices", "1"])
    ps = game_training_driver.run(common + ["--output-dir", str(tmp_path / "port"),
                                            "--device", "cpu", "--re-routing",
                                            "static"])
    strip = ("fit_seconds", "model_dirs", "evaluation", "reader", "read_seconds")
    assert {k: v for k, v in ps.items() if k not in strip} == \
        {k: v for k, v in js.items() if k not in strip}
    assert set(ps["evaluation"]) == {"AUC", "LOGISTIC_LOSS"}
    for k, want in js["evaluation"].items():
        assert abs(ps["evaluation"][k] - want) <= 1e-10 * abs(want)
    for sub in ("best", "models/0", "models/1"):
        pm, jm = _saved_re(tmp_path / "port" / sub), _saved_re(tmp_path / "jax" / sub)
        assert set(pm) == set(jm) and len(pm) > 20
        assert max(abs(pm[k] - jm[k]) for k in jm) <= 1e-8
    plines = (tmp_path / "port" / "metrics.jsonl").read_text().splitlines()
    jlines = (tmp_path / "jax" / "metrics.jsonl").read_text().splitlines()
    assert [sorted(json.loads(x)) for x in plines] == [sorted(json.loads(x)) for x in jlines]

    def scores(driver, model_dir, dest, extra=()):
        driver.run(["--data", str(d / "score.avro"), "--model-dir", str(model_dir),
                    "--output-dir", str(dest), "--dtype", "float64", *extra])
        return np.array([r["predictionScore"]
                         for r in read_records(str(dest / "scores.avro"))])

    cpu = ["--device", "cpu"]
    port_own = scores(game_scoring_driver, tmp_path / "port" / "best", tmp_path / "pp", cpu)
    port_on_jax = scores(game_scoring_driver, tmp_path / "jax" / "best", tmp_path / "pj", cpu)
    jax_own = scores(jax_scoring, tmp_path / "jax" / "best", tmp_path / "jj")
    jax_on_port = scores(jax_scoring, tmp_path / "port" / "best", tmp_path / "jp")
    assert np.std(port_own) > 0.05
    np.testing.assert_allclose(port_on_jax, port_own, rtol=0, atol=1e-12)
    np.testing.assert_allclose(jax_on_port, jax_own, rtol=0, atol=1e-12)


@pytest.mark.parametrize("spec", [
    "perUser:type=random,re_type=userId,shard=user,reg=L2,reg_weights=1|10",
    "perUser:type=random,re_type=userId,active_bound=5,min_rows=2,max_features=10,"
    "max_bucket_entities=100,reg=L2,reg_weights=0.5,variance=SIMPLE,max_iter=7",
    "perItem:type=random,re_type=itemId,host_resident=0,optimizer=TRON,tol=1e-6",
])
def test_random_effect_dsl_parses_as_jax(spec):
    from photon_tpu.cli.params import parse_coordinate_spec as jax_parse
    from photon_tpu_torch.cli.params import parse_coordinate_spec

    j, t = jax_parse(spec), parse_coordinate_spec(spec)
    assert (t.cid, t.reg_weights) == (j.cid, j.reg_weights)
    for f in ("re_type", "feature_shard", "active_bound", "min_entity_rows",
              "max_features_per_entity", "max_bucket_entities", "host_resident"):
        assert getattr(t.data, f) == getattr(j.data, f), f
    for f in ("max_iterations", "tolerance", "reg_weight", "incremental_weight"):
        assert getattr(t.optimization, f) == getattr(j.optimization, f), f
    assert t.optimization.optimizer_type.name == j.optimization.optimizer_type.name
    assert t.optimization.variance_type.name == j.optimization.variance_type.name
