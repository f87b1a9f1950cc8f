"""Factored random effects in the port against the JAX package.

On the CPU, in float64, from the same numpy data (the low-rank per-user data
of ``tests/test_factored_random_effect.py``):

* ``_project_bucket_features`` (the port's: one matvec of the bucket's
  global-column design a latent column) equals JAX's gather within 1e-12;
* the projection step's objective and its written-out gradient equal
  ``jax.value_and_grad`` of JAX's autodiff objective at one point within
  1e-10 relative;
* one ``_latent_step`` (the dense lanes) takes JAX's per-lane iterations and
  reasons, coefficients within 1e-8;
* ``_factor_model`` (the seeded ``svds`` over the port's passes) gives
  JAX's P0 and β0 within 1e-8, and that operator scipy's products;
* ``train_factored_random_effects`` end to end, fresh and warm-started from
  a loaded effective model, gives JAX's effective coefficients within 1e-6;
  a host-resident dataset trains bit for bit as a resident one;
* ``GameEstimator.fit`` with a fixed effect and a factored random effect:
  the port's saved model scores under JAX's loader as the port scores it,
  and the other way round, within 1e-9; the saved layout (effective model,
  ``projection.npy``, ``factored_latent_dim``) is JAX's; JAX's refusals
  (incremental training, down-sampling, variances, normalization) word for
  word; a fit killed after its factored step resumes bit-identical;
* the coordinate DSL parses ``type=factored`` as JAX's parser does.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from photon_tpu.data.batch import SparseFeatures as JaxFeatures
from photon_tpu.data.random_effect import build_random_effect_dataset as jax_build
from photon_tpu.estimators import config as jcfg
from photon_tpu.estimators.game_estimator import GameEstimator as JaxEstimator
from photon_tpu.functions.problem import GLMOptimizationProblem as JaxProblem
from photon_tpu.game import factored_random_effect as jfre
from photon_tpu.index.index_map import DefaultIndexMap as JaxIndexMap
from photon_tpu.io import model_io as jio
from photon_tpu.io.data_reader import GameDataBundle as JaxBundle
from photon_tpu.ops.losses import loss_for_task as jax_loss_for_task
from photon_tpu.optim import OptimizerConfig as JaxConfig
from photon_tpu.optim import OptimizerType as JaxOptimizer
from photon_tpu.optim import RegularizationContext as JaxReg
from photon_tpu.optim import RegularizationType as JaxRegType
from photon_tpu.types import TaskType as JaxTask
from photon_tpu_torch.data.batch import SparseFeatures
from photon_tpu_torch.data.random_effect import build_random_effect_dataset
from photon_tpu_torch.estimators import config as tcfg
from photon_tpu_torch.estimators.game_estimator import GameEstimator
from photon_tpu_torch.functions.problem import GLMOptimizationProblem
from photon_tpu_torch.game import factored_random_effect as tfre
from photon_tpu_torch.index.index_map import DefaultIndexMap, feature_key
from photon_tpu_torch.io import model_io as tio
from photon_tpu_torch.io.data_reader import GameDataBundle
from photon_tpu_torch.optim import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
)
from photon_tpu_torch.types import TaskType
from test_factored_random_effect import _low_rank_game_data

CPU = torch.device("cpu")
LATENT = 3


def _problems(max_iter=25, lam=1.0):
    j = JaxProblem(task=JaxTask.LOGISTIC_REGRESSION,
                   optimizer_type=JaxOptimizer.LBFGS,
                   optimizer_config=JaxConfig(max_iterations=max_iter),
                   regularization=JaxReg(JaxRegType.L2), reg_weight=lam)
    t = GLMOptimizationProblem(task=TaskType.LOGISTIC_REGRESSION,
                               optimizer_type=OptimizerType.LBFGS,
                               optimizer_config=OptimizerConfig(max_iterations=max_iter),
                               regularization=RegularizationContext(RegularizationType.L2),
                               reg_weight=lam)
    return j, t


@pytest.fixture(scope="module")
def low_rank():
    """The same per-user data as a JAX and a port dataset (f64), plus
    offsets and the raw arrays."""
    idx, val, y, _, keys, _, dim = _low_rank_game_data(1, n_users=60)
    val = val.astype(np.float64)
    y = y.astype(np.float64)
    offsets = np.random.default_rng(5).normal(size=len(y)) * 0.1
    jds = jax_build("userId", keys, idx, val, y, dim, dtype=np.float64)
    tds = build_random_effect_dataset("userId", keys, idx, val, y, dim,
                                      dtype=torch.float64, device=CPU)
    return {"j": jds, "t": tds, "offsets": offsets, "idx": idx, "val": val,
            "y": y, "keys": keys, "dim": dim}


def _point(dim, n_entities_by_bucket, seed=3):
    rng = np.random.default_rng(seed)
    P = rng.normal(size=(dim, LATENT)) * 0.3
    lats = [rng.normal(size=(e, LATENT)) for e in n_entities_by_bucket]
    return P, lats


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def test_project_bucket_features_matches_jax(low_rank):
    jds, tds = low_rank["j"], low_rank["t"]
    P, _ = _point(low_rank["dim"], [b.n_entities for b in tds.buckets])
    P_ext = jnp.concatenate([jnp.asarray(P), jnp.zeros((1, LATENT))])
    for jb, tb in zip(jds.buckets, tds.buckets):
        want = np.asarray(jfre._project_bucket_features(P_ext, jb))
        got = tfre._project_bucket_features(
            torch.from_numpy(P), tb, tfre.bucket_design(tb, tds.global_dim)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def _jax_projection_objective(problem, buckets, offsets, lats, shape):
    """JAX's projection-step objective, as ``_projection_step`` writes it."""
    loss = jax_loss_for_task(problem.task)
    lam = problem.regularization.l2_weight(problem.reg_weight)
    bases = [b.local_batches(offsets) for b in buckets]

    def objective(p_flat):
        P_ = p_flat.reshape(shape)
        P_ext = jnp.concatenate([P_, jnp.zeros_like(P_[:1])])
        total = 0.0
        for bucket, base, beta in zip(buckets, bases, lats):
            xp = jfre._project_bucket_features(P_ext, bucket)
            z = jnp.einsum("esp,ep->es", xp, beta) + base.offsets
            total = total + jnp.sum(base.weights * loss.loss(z, base.labels))
        return total + 0.5 * lam * jnp.sum(p_flat * p_flat)

    return objective


def test_projection_objective_and_gradient_match_jax(low_rank):
    jds, tds, off = low_rank["j"], low_rank["t"], low_rank["offsets"]
    jp, tp = _problems(lam=0.7)
    P, lats = _point(low_rank["dim"], [b.n_entities for b in tds.buckets])
    shape = P.shape
    fj, gj = jax.value_and_grad(_jax_projection_objective(
        jp, jds.buckets, jnp.asarray(off), [jnp.asarray(b) for b in lats], shape))(
            jnp.asarray(P.reshape(-1)))
    designs = [tfre.bucket_design(b, tds.global_dim) for b in tds.buckets]
    vg = tfre.projection_value_and_grad(
        tp, tds.buckets, designs, torch.from_numpy(off),
        [torch.from_numpy(b) for b in lats], shape)
    ft, gt = vg(torch.from_numpy(P.reshape(-1)))
    assert abs(ft.item() - float(fj)) <= 1e-10 * abs(float(fj))
    assert _rel(gt.numpy(), gj) <= 1e-10
    # the same point twice: bit for bit
    ft2, gt2 = vg(torch.from_numpy(P.reshape(-1)))
    assert torch.equal(ft, ft2) and torch.equal(gt, gt2)


def test_latent_step_matches_jax(low_rank):
    jds, tds, off = low_rank["j"], low_rank["t"], low_rank["offsets"]
    jp, tp = _problems(max_iter=20)
    P, lats = _point(low_rank["dim"], [b.n_entities for b in tds.buckets], seed=4)
    for jb, tb, b0 in zip(jds.buckets, tds.buckets, lats):
        jw, jr = jfre._latent_step(jp, jnp.asarray(P), jb, jnp.asarray(off),
                                   jnp.asarray(b0))
        tw, tr = tfre._latent_step(tp, torch.from_numpy(P), tb,
                                   tfre.bucket_design(tb, tds.global_dim),
                                   torch.from_numpy(off), torch.from_numpy(b0))
        np.testing.assert_array_equal(tr.iterations.numpy(), np.asarray(jr.iterations))
        np.testing.assert_array_equal(tr.converged_reason.numpy(),
                                      np.asarray(jr.converged_reason))
        np.testing.assert_array_equal(tr.data_passes.numpy(), np.asarray(jr.data_passes))
        assert _rel(tw.numpy(), jw) <= 1e-8


def test_factor_model_matches_jax(low_rank):
    from photon_tpu.game.random_effect import train_random_effects as jax_train_re
    from photon_tpu_torch.game.random_effect import train_random_effects

    jds, tds, off = low_rank["j"], low_rank["t"], low_rank["offsets"]
    jp, tp = _problems()
    jplain, _ = jax_train_re(jp, jds, jnp.asarray(off))
    tplain, _ = train_random_effects(tp, tds, torch.from_numpy(off))
    jP, jl = jfre._factor_model(jplain, jds, LATENT, seed=0)
    tP, tl = tfre._factor_model(tplain, tds, LATENT, seed=0)
    assert tP.dtype == torch.float64
    assert _rel(tP.numpy(), jP) <= 1e-8
    for a, b in zip(tl, jl):
        assert _rel(a.numpy(), b) <= 1e-8


def test_coefficient_operator_matches_scipy():
    """``svds``' operator (the port's passes over W's rows) gives scipy's
    CSR products, and ``svds`` over it scipy's singular triplets (each up to
    the sign of its pair, which round-off may flip: W = U S Vᵀ either way)."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import svds

    rng = np.random.default_rng(8)
    n, d = 40, 90
    dense = rng.normal(size=(n, d)) * (rng.random((n, d)) < 0.1)
    dense[7] = 0.0                                  # an entity with no entries
    rows, cols = np.nonzero(dense)
    op = tfre.coefficient_operator(rows, cols, dense[rows, cols], (n, d), CPU)
    W = sp.csr_matrix(dense)
    x, y = rng.normal(size=d), rng.normal(size=n)
    np.testing.assert_allclose(op.matvec(x), W @ x, rtol=0, atol=1e-12)
    np.testing.assert_allclose(op.rmatvec(y), W.T @ y, rtol=0, atol=1e-12)
    v0 = np.random.default_rng(0).normal(size=n)
    (u, s, vt), (wu, ws, wvt) = svds(op, k=4, v0=v0), svds(W, k=4, v0=v0)
    np.testing.assert_allclose(s, ws, rtol=1e-12)
    sign = np.sign(np.sum(vt * wvt, axis=1))
    np.testing.assert_allclose(u * s * sign, wu * ws, rtol=0, atol=1e-10)
    np.testing.assert_allclose(vt * sign[:, None], wvt, rtol=0, atol=1e-10)


def _effective(model):
    return [np.asarray(c) if not isinstance(c, torch.Tensor) else c.numpy()
            for c in model.effective.bucket_coefs]


def test_train_factored_end_to_end_matches_jax(low_rank):
    jds, tds, off = low_rank["j"], low_rank["t"], low_rank["offsets"]
    jp, tp = _problems()
    jm, jr = jfre.train_factored_random_effects(
        jp, jds, jnp.asarray(off), latent_dim=LATENT, n_alternations=2)
    tm, tr = tfre.train_factored_random_effects(
        tp, tds, torch.from_numpy(off), latent_dim=LATENT, n_alternations=2)
    assert tm.latent_dim == LATENT and tuple(tm.projection.shape) == (tds.global_dim, LATENT)
    assert len(tr) == len(tds.buckets)
    for a, b in zip(_effective(tm), _effective(jm)):
        assert _rel(a, b) <= 1e-6
    scores = tm.score_dataset(tds).numpy()
    np.testing.assert_allclose(scores, np.asarray(jm.score_dataset(jds)),
                               rtol=0, atol=1e-6 * np.abs(scores).max())
    gi, gv = tm.coefficients_for(tds.entity_keys[0])
    jgi, jgv = jm.coefficients_for(tds.entity_keys[0])
    np.testing.assert_array_equal(gi, jgi)
    assert _rel(gv, jgv) <= 1e-6
    # warm start from the loaded (effective) form: re-factored, then trained
    jw, _ = jfre.train_factored_random_effects(
        jp, jds, jnp.asarray(off), latent_dim=LATENT, n_alternations=1,
        init=jm.effective)
    tw, _ = tfre.train_factored_random_effects(
        tp, tds, torch.from_numpy(off), latent_dim=LATENT, n_alternations=1,
        init=tm.effective)
    for a, b in zip(_effective(tw), _effective(jw)):
        assert _rel(a, b) <= 1e-6


def test_host_resident_dataset_trains_bit_for_bit(low_rank):
    tds, off = low_rank["t"], low_rank["offsets"]
    _, tp = _problems(max_iter=10)
    host = build_random_effect_dataset(
        "userId", low_rank["keys"], low_rank["idx"], low_rank["val"],
        low_rank["y"], low_rank["dim"], dtype=torch.float64, device=CPU,
        host_resident=True)
    assert host.host_resident
    a, _ = tfre.train_factored_random_effects(tp, tds, torch.from_numpy(off),
                                              latent_dim=LATENT, n_alternations=1)
    b, _ = tfre.train_factored_random_effects(tp, host, torch.from_numpy(off),
                                              latent_dim=LATENT, n_alternations=1)
    assert torch.equal(a.projection, b.projection)
    for x, y in zip(a.effective.bucket_coefs, b.effective.bucket_coefs):
        assert torch.equal(x, y)


# ------------------------------------------------------------- the estimator

def _bundles(seed=3, n_users=50):
    """A fixed effect (global block + intercept) and per-user low-rank
    blocks in one shard, as a JAX and a port bundle (f64)."""
    idx, val, y, _, keys, _, d_user = _low_rank_game_data(seed, n_users=n_users)
    rng = np.random.default_rng(seed + 100)
    n = len(y)
    gi = 1 + d_user + rng.integers(0, 8, size=(n, 2))
    idx = np.concatenate([np.zeros((n, 1), np.int64), 1 + idx, gi], 1).astype(np.int32)
    val = np.concatenate([np.ones((n, 1)), val, rng.normal(size=(n, 2))], 1)
    dim = 1 + d_user + 8
    common = dict(labels=y.astype(np.float64), offsets=rng.normal(size=n) * 0.1,
                  weights=np.ones(n), uids=np.arange(n).astype(object),
                  id_tags={"userId": keys})
    jb = JaxBundle(features={"global": JaxFeatures(jnp.asarray(idx), jnp.asarray(val),
                                                   dim)}, **common)
    tb = GameDataBundle(features={"global": SparseFeatures(
        torch.from_numpy(idx), torch.from_numpy(val), dim)}, **common)
    names = [feature_key("(INTERCEPT)", "")] + [feature_key(f"f{i}", "")
                                               for i in range(dim - 1)]
    return jb, tb, names


def _estimators(evaluators=("AUC",), normalization="NONE", latent=LATENT):
    from photon_tpu.data.normalization import NormalizationType as JaxNorm

    kw = dict(n_sweeps=2, evaluator_specs=evaluators,
              intercept_indices={"global": 0})
    j = JaxEstimator(task=JaxTask.LOGISTIC_REGRESSION,
                     coordinate_data_configs={
                         "fixed": jcfg.FixedEffectDataConfig("global"),
                         "perUser": jcfg.FactoredRandomEffectDataConfig(
                             re_type="userId", feature_shard="global",
                             latent_dim=latent, n_alternations=2)},
                     normalization=JaxNorm[normalization], **kw)
    t = GameEstimator(task=TaskType.LOGISTIC_REGRESSION,
                      coordinate_data_configs={
                          "fixed": tcfg.FixedEffectDataConfig("global"),
                          "perUser": tcfg.FactoredRandomEffectDataConfig(
                              re_type="userId", feature_shard="global",
                              latent_dim=latent, n_alternations=2)},
                      normalization=normalization, **kw)
    return j, t


def _configs(**over):
    def pair(w):
        j = jcfg.GLMOptimizationConfiguration(
            regularization=JaxReg(JaxRegType.L2), reg_weight=w, max_iterations=20,
            **over)
        t = tcfg.GLMOptimizationConfiguration(
            regularization=RegularizationContext(RegularizationType.L2),
            reg_weight=w, max_iterations=20,
            **{k: (_port_enum(v)) for k, v in over.items()})
        return j, t

    (jf, tf), (ju, tu) = pair(1.0), pair(2.0)
    return {"fixed": jf, "perUser": ju}, {"fixed": tf, "perUser": tu}


def _port_enum(v):
    from photon_tpu_torch.functions.problem import VarianceComputationType

    return VarianceComputationType[v.name] if hasattr(v, "name") else v


@pytest.fixture(scope="module")
def fitted():
    jb, tb, names = _bundles()
    je, te = _estimators()
    jc, tc = _configs()
    jr = je.fit(jb, jb, [jc])[0]
    tr = te.fit(tb, tb, [tc])[0]
    return {"jb": jb, "tb": tb, "names": names, "je": je, "te": te,
            "jr": jr, "tr": tr, "tc": tc}


def test_estimator_fit_matches_jax(fitted):
    jr, tr = fitted["jr"], fitted["tr"]
    assert isinstance(tr.model["perUser"], tfre.FactoredRandomEffectModel)
    for a, b in zip(_effective(tr.model["perUser"]), _effective(jr.model["perUser"])):
        assert _rel(a, b) <= 1e-6
    assert _rel(tr.model["fixed"].model.coefficients.means.numpy(),
                jr.model["fixed"].model.coefficients.means) <= 1e-6
    assert abs(tr.evaluation.primary - jr.evaluation.primary) <= 1e-6


def test_saved_factored_models_cross_score(fitted, tmp_path):
    """Each package's saved factored model, loaded by the other package,
    scores as its own package scores it (f64, 1e-9)."""
    names, jb, tb = fitted["names"], fitted["jb"], fitted["tb"]
    shards = {"fixed": "global", "perUser": "global"}
    tio.save_game_model(str(tmp_path / "port"), fitted["tr"].model,
                        {"global": DefaultIndexMap(names)}, shards)
    jio.save_game_model(str(tmp_path / "jax"), fitted["jr"].model,
                        {"global": JaxIndexMap(names)}, shards)
    for side in ("port", "jax"):
        cdir = tmp_path / side / "random-effect" / "perUser"
        assert (cdir / "projection.npy").exists()
        meta = json.loads((tmp_path / side / "game-metadata.json").read_text())
        assert meta["coordinates"]["perUser"]["factored_latent_dim"] == LATENT
        assert meta["coordinates"]["perUser"]["type"] == "random"
    np.testing.assert_array_equal(
        np.load(tmp_path / "port" / "random-effect" / "perUser" / "projection.npy"),
        fitted["tr"].model["perUser"].projection.numpy())

    def jax_scores(model_dir):
        m, _ = jio.load_game_model(str(model_dir), {"global": JaxIndexMap(names)},
                                   dtype=jnp.float64)
        prep = fitted["je"]._prepare(jb)
        ds = prep["train"]["perUser"]
        return np.asarray(m["perUser"].score_new_dataset(ds))

    def port_scores(model_dir):
        m, _ = tio.load_game_model(str(model_dir), {"global": DefaultIndexMap(names)},
                                   dtype=torch.float64, device=CPU)
        ds = fitted["te"]._prepare_cached(tb)["datasets"]["perUser"]
        return m["perUser"].score_new_dataset(ds).numpy()

    own_port = fitted["tr"].model["perUser"].score_new_dataset(
        fitted["te"]._prepare_cached(tb)["datasets"]["perUser"]).numpy()
    own_jax = np.asarray(fitted["jr"].model["perUser"].score_new_dataset(
        fitted["je"]._prepare(jb)["train"]["perUser"]))
    assert np.std(own_port) > 0.05
    np.testing.assert_allclose(jax_scores(tmp_path / "port"), own_port, rtol=0, atol=1e-9)
    np.testing.assert_allclose(port_scores(tmp_path / "jax"), own_jax, rtol=0, atol=1e-9)
    np.testing.assert_allclose(port_scores(tmp_path / "port"), own_port, rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("knob", ["incremental", "down-sampling", "variances",
                                  "normalization"])
def test_factored_refusals_match_jax(fitted, knob):
    jb, tb = fitted["jb"], fitted["tb"]
    over = {"down-sampling": {"down_sampling_rate": 0.5},
            "incremental": {"incremental_weight": 1.0}}.get(knob, {})
    if knob == "variances":
        from photon_tpu.functions.problem import VarianceComputationType as JV

        over = {"variance_type": JV.SIMPLE}
    jc, tc = _configs(**over)
    je, te = _estimators(normalization="STANDARDIZATION" if knob == "normalization"
                         else "NONE")
    init_j = init_t = None
    if knob == "incremental":
        init_j, init_t = fitted["jr"].model, fitted["tr"].model
    with pytest.raises(ValueError) as jerr:
        je.fit(jb, None, [jc], initial_model=init_j)
    with pytest.raises(ValueError) as terr:
        te.fit(tb, None, [tc], initial_model=init_t)
    assert str(terr.value) == str(jerr.value)
    assert "not supported for factored random effects" in str(terr.value)


def test_factored_data_config_validation_matches_jax():
    for kw in ({"latent_dim": 0}, {"n_alternations": 0}):
        with pytest.raises(ValueError) as jerr:
            jcfg.FactoredRandomEffectDataConfig(re_type="u", **kw)
        with pytest.raises(ValueError) as terr:
            tcfg.FactoredRandomEffectDataConfig(re_type="u", **kw)
        assert str(terr.value) == str(jerr.value)


def test_dsl_parses_factored_as_jax():
    from photon_tpu.cli.params import parse_coordinate_spec as jax_parse
    from photon_tpu_torch.cli.params import parse_coordinate_spec

    spec = ("perUser:type=factored,re_type=userId,latent=4,alternations=3,"
            "reg=L2,reg_weights=1|10,host_resident=1")
    j, t = jax_parse(spec), parse_coordinate_spec(spec)
    assert isinstance(t.data, tcfg.FactoredRandomEffectDataConfig)
    assert dataclasses.asdict(t.data) == dataclasses.asdict(j.data)
    assert t.reg_weights == j.reg_weights
    for bad in ("x:type=random,re_type=u,latent=4", "x:type=fixed,latent=4"):
        with pytest.raises(ValueError) as jerr:
            jax_parse(bad)
        with pytest.raises(ValueError) as terr:
            parse_coordinate_spec(bad)
        assert str(terr.value) == str(jerr.value)


def test_resume_after_factored_step_is_bit_identical(fitted, tmp_path):
    """A fit killed after its first factored step resumes from the snapshot
    (the restored model re-attached through ``adopt``) and ends bit for bit
    where the uninterrupted fit ends."""
    from photon_tpu_torch.checkpoint import CheckpointManager

    tb, tc = fitted["tb"], fitted["tc"]
    _, te = _estimators()
    ref = te.fit(tb, tb, [tc])[0]
    ck = str(tmp_path / "ck")
    mgr = CheckpointManager(ck, fail_after=2)      # fixed, then perUser
    with pytest.raises(KeyboardInterrupt):
        _estimators()[1].fit(tb, tb, [tc], checkpoint_manager=mgr)
    mgr.close()
    mgr = CheckpointManager(ck)
    got = _estimators()[1].fit(tb, tb, [tc], checkpoint_manager=mgr)[0]
    mgr.close()
    a, b = got.model["perUser"], ref.model["perUser"]
    assert torch.equal(a.projection, b.projection)
    for x, y in zip(a.effective.bucket_coefs, b.effective.bucket_coefs):
        assert torch.equal(x, y)
    assert torch.equal(got.model["fixed"].model.coefficients.means,
                       ref.model["fixed"].model.coefficients.means)
    assert got.evaluation.values == ref.evaluation.values
