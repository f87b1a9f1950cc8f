"""Hyperparameter tuning in the port against the JAX package.

The search modules (kernels, acquisition, slice sampler, GP, rescaling,
search) are copies of the JAX package's: their code is the JAX code with
the imports renamed, and from the same inputs they give the same outputs bit
for bit (kernel matrices, expected improvement, the slice sampler's draws,
the GP posterior, the range JSON, the proposals of ``RandomSearch`` and
``GaussianProcessSearch`` on Branin). A search resumed from the state of
trial 1, 3 or 5 repeats the uninterrupted history bit for bit.
``tune_regularization`` over the port's ``GameEstimator`` (f64, on the CPU)
proposes JAX's points (the seeded ones equal, the GP's within 1e-9) with
JAX's values (1e-9); killed after a trial under the port's
``CheckpointManager`` it resumes to the uninterrupted history, a changed
configuration is refused, and a JAX tuning snapshot is refused by its magic
before anything is unpickled.
"""
import ast
import os

import numpy as np
import pytest
import torch

from photon_tpu import hyperparameter as jh
from photon_tpu.hyperparameter import search as jsearch
from photon_tpu_torch import hyperparameter as th
from photon_tpu_torch.hyperparameter import search as tsearch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = ("acquisition", "kernels", "gp", "rescaling", "slice_sampler", "search")


def _body(path: str, rename: bool) -> str:
    """A module's code without its docstring, imports renamed to the JAX
    package's."""
    src = open(path).read()
    if rename:
        src = src.replace("photon_tpu_torch", "photon_tpu")
    tree = ast.parse(src)
    if ast.get_docstring(tree) is not None:
        tree.body = tree.body[1:]
    return ast.unparse(tree)


@pytest.mark.parametrize("name", COPIES)
def test_search_modules_are_copies(name):
    port = os.path.join(REPO, "photon_tpu_torch", "hyperparameter", f"{name}.py")
    jax = os.path.join(REPO, "photon_tpu", "hyperparameter", f"{name}.py")
    assert _body(port, rename=True) == _body(jax, rename=False)
    assert "torch" not in _body(port, rename=True)


def test_kernels_and_acquisition_equal():
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=(7, 3)), rng.normal(size=(4, 3))
    ls = np.asarray([0.7, 1.3, 2.0])
    for name in ("RBF", "Matern52"):
        np.testing.assert_array_equal(getattr(th, name)(1.5, ls)(x, y),
                                      getattr(jh, name)(1.5, ls)(x, y))
    assert set(th.KERNELS) == set(jh.KERNELS)
    mu, var = rng.normal(size=32), rng.random(32) * 2
    var[:3] = 0.0
    np.testing.assert_array_equal(th.expected_improvement(mu, var, best=0.1),
                                  jh.expected_improvement(mu, var, best=0.1))


def test_slice_sampler_draws_equal():
    def logp(v):
        return float(-0.5 * v @ v) if v[0] > -1.0 else -np.inf

    got = th.SliceSampler(logp, seed=3).sample(np.zeros(2), n_samples=200, n_burn=20)
    want = jh.SliceSampler(logp, seed=3).sample(np.zeros(2), n_samples=200, n_burn=20)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="zero-density"):
        th.SliceSampler(lambda v: -np.inf, seed=0).sample(np.zeros(2), 1)


def test_gp_posterior_equal():
    rng = np.random.default_rng(1)
    x, y, xs = rng.random((12, 2)), rng.normal(size=12), rng.random((9, 2))
    kern = (th.Matern52(1.2, np.asarray([0.4, 0.9])),
            jh.Matern52(1.2, np.asarray([0.4, 0.9])))
    got = th.GaussianProcessModel(x, y, kern[0], noise=0.01).predict(xs)
    want = jh.GaussianProcessModel(x, y, kern[1], noise=0.01).predict(xs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    tm = th.GaussianProcessEstimator(n_samples=4, n_burn=6, seed=2).fit(x, y)
    jm = jh.GaussianProcessEstimator(n_samples=4, n_burn=6, seed=2).fit(x, y)
    for a, b in zip(th.predict_mean_var(tm, xs), jh.predict_mean_var(jm, xs)):
        np.testing.assert_array_equal(a, b)


def test_rescaling_and_json_equal():
    spec = [("a", -2.0, 4.0, "linear"), ("b", 1e-4, 1e2, "log")]
    tr = th.VectorRescaling([th.ParamRange(*s) for s in spec])
    jr = jh.VectorRescaling([jh.ParamRange(*s) for s in spec])
    x = np.asarray([[1.0, 0.5], [-2.0, 1e-4], [4.0, 1e2]])
    np.testing.assert_array_equal(tr.to_unit(x), jr.to_unit(x))
    np.testing.assert_array_equal(tr.from_unit(tr.to_unit(x)), jr.from_unit(jr.to_unit(x)))
    np.testing.assert_array_equal(tr.sample(np.random.default_rng(4), 5),
                                  jr.sample(np.random.default_rng(4), 5))
    text = th.ranges_to_json(list(tr.ranges))
    assert text == jh.ranges_to_json(list(jr.ranges))
    assert [r.__dict__ for r in th.ranges_from_json(text)] == \
        [r.__dict__ for r in jh.ranges_from_json(text)]


def _branin(v):
    x, y = v[0], v[1]
    a, b, c = 1.0, 5.1 / (4 * np.pi**2), 5 / np.pi
    r, s, t = 6.0, 10.0, 1 / (8 * np.pi)
    return a * (y - b * x**2 + c * x - r) ** 2 + s * (1 - t) * np.cos(x) + s


def _branin_ranges(pkg):
    return pkg.VectorRescaling([pkg.ParamRange("x", -5.0, 10.0),
                                pkg.ParamRange("y", 0.0, 15.0)])


@pytest.mark.parametrize("strategy", ["GaussianProcessSearch", "RandomSearch"])
def test_search_proposals_on_branin_equal(strategy):
    got = getattr(tsearch, strategy)(_branin_ranges(th), seed=0).search(_branin, 7)
    want = getattr(jsearch, strategy)(_branin_ranges(jh), seed=0).search(_branin, 7)
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.values, want.values)
    assert got.best_index == want.best_index


def _ranges(pkg):
    return pkg.VectorRescaling([pkg.ParamRange("a", 0.01, 100.0, scale="log"),
                                pkg.ParamRange("b", -2.0, 2.0, scale="linear")])


def _objective(p):
    return float((np.log10(p[0]) - 0.3) ** 2 + (p[1] - 0.5) ** 2)


@pytest.mark.parametrize("strategy", ["gp", "random"])
@pytest.mark.parametrize("crash_after", [1, 3, 5])
def test_search_resume_bit_identical(strategy, crash_after):
    """The JAX test's cases: resumed from the state saved after trial
    ``crash_after``, the search repeats the uninterrupted history (and the
    JAX package's)."""
    name = "GaussianProcessSearch" if strategy == "gp" else "RandomSearch"
    cls, jcls = getattr(tsearch, name), getattr(jsearch, name)
    ref = cls(_ranges(th), seed=7).search(_objective, 6)
    states = {}
    cls(_ranges(th), seed=7).search(_objective, 6,
                                    on_trial=lambda s, i: states.__setitem__(i, s))
    resumed = cls(_ranges(th), seed=7).search(_objective, 6, state=states[crash_after])
    np.testing.assert_array_equal(resumed.points, ref.points)
    np.testing.assert_array_equal(resumed.values, ref.values)
    want = jcls(_ranges(jh), seed=7).search(_objective, 6)
    np.testing.assert_array_equal(ref.points, want.points)


# -------------------------------------------------------------- the tuner

RANGES = {"fixed": (0.01, 100.0), "perUser": (0.01, 100.0)}


@pytest.fixture(scope="module")
def game():
    """A small GAME bundle (fixed + perUser), training and validation, and
    both packages' estimators with AUC (f64)."""
    from test_torch_re_training import bundles, opt_pair

    from photon_tpu.estimators.config import FixedEffectDataConfig as JaxFixedCfg
    from photon_tpu.estimators.config import RandomEffectDataConfig as JaxRECfg
    from photon_tpu.estimators.game_estimator import GameEstimator as JaxEstimator
    from photon_tpu.types import TaskType as JaxTask
    from photon_tpu_torch.estimators.config import (
        FixedEffectDataConfig,
        RandomEffectDataConfig,
    )
    from photon_tpu_torch.estimators.game_estimator import GameEstimator
    from photon_tpu_torch.types import TaskType

    (jt, tt), (jv, tv) = bundles(11), bundles(12)
    (jf, tf), (ju, tu) = opt_pair(1.0, "NONE", 15), opt_pair(1.0, "NONE", 15)

    def estimators():
        kw = dict(n_sweeps=1, evaluator_specs=("AUC",),
                  intercept_indices={"global": 0})
        return (JaxEstimator(JaxTask.LOGISTIC_REGRESSION,
                             {"fixed": JaxFixedCfg("global"),
                              "perUser": JaxRECfg("userId", "global")}, **kw),
                GameEstimator(TaskType.LOGISTIC_REGRESSION,
                              {"fixed": FixedEffectDataConfig("global"),
                               "perUser": RandomEffectDataConfig("userId", "global")},
                              **kw))

    return {"j": (jt, jv), "t": (tt, tv), "jbase": {"fixed": jf, "perUser": ju},
            "tbase": {"fixed": tf, "perUser": tu}, "estimators": estimators}


@pytest.mark.parametrize("strategy", ["gp", "random"])
def test_tune_regularization_matches_jax(game, strategy):
    je, te = game["estimators"]()
    want = jh.tune_regularization(je, *game["j"], game["jbase"], RANGES,
                                  n_iterations=4, strategy=strategy, seed=0)
    got = th.tune_regularization(te, *game["t"], game["tbase"], RANGES,
                                 n_iterations=4, strategy=strategy, seed=0)
    # the seeded points are equal; the GP's proposal follows the values
    np.testing.assert_array_equal(got.search.points[:3], want.search.points[:3])
    np.testing.assert_allclose(got.search.points, want.search.points, rtol=1e-9, atol=0)
    np.testing.assert_allclose(got.search.values, want.search.values, rtol=1e-9, atol=0)
    assert got.search.best_index == want.search.best_index
    assert -got.search.best_value > 0.5
    for cid in RANGES:
        assert got.best_config[cid].reg_weight == pytest.approx(
            want.best_config[cid].reg_weight, rel=1e-9)
    assert got.best_result.evaluation.primary == -got.search.best_value
    assert got.best_result.config == got.best_config


def test_tuner_resumes_after_a_kill_and_refuses_other_runs(game, tmp_path):
    """Killed after trial 2 under the port's ``CheckpointManager``, the
    tuner resumes to the uninterrupted history bit for bit (and refits the
    best model where it predates the resume); a changed configuration and a
    JAX tuning snapshot are refused."""
    from photon_tpu.checkpoint import CheckpointManager as JaxManager
    from photon_tpu_torch.checkpoint import CheckpointManager, ForeignCheckpoint

    train, valid = game["t"]
    ref = th.tune_regularization(game["estimators"]()[1], train, valid,
                                 game["tbase"], RANGES, n_iterations=4, seed=3)
    ck = str(tmp_path / "ck")
    mgr = CheckpointManager(ck, fail_after=2)
    with pytest.raises(KeyboardInterrupt):
        th.tune_regularization(game["estimators"]()[1], train, valid, game["tbase"],
                               RANGES, n_iterations=4, seed=3, checkpoint_manager=mgr)
    mgr.close()
    mgr = CheckpointManager(ck)
    got = th.tune_regularization(game["estimators"]()[1], train, valid, game["tbase"],
                                 RANGES, n_iterations=4, seed=3, checkpoint_manager=mgr)
    mgr.close()
    np.testing.assert_array_equal(got.search.points, ref.search.points)
    np.testing.assert_array_equal(got.search.values, ref.search.values)
    for cid in ("fixed",):
        assert torch.equal(got.best_result.model[cid].model.coefficients.means,
                           ref.best_result.model[cid].model.coefficients.means)
    for a, b in zip(got.best_result.model["perUser"].bucket_coefs,
                    ref.best_result.model["perUser"].bucket_coefs):
        assert torch.equal(a, b)
    mgr = CheckpointManager(ck)
    with pytest.raises(ValueError, match="different configuration"):
        th.tune_regularization(game["estimators"]()[1], train, valid, game["tbase"],
                               RANGES, n_iterations=5, seed=3, checkpoint_manager=mgr)
    mgr.close()
    # a JAX tuning snapshot (its own framing) is refused before unpickling
    jdir = str(tmp_path / "jax_ck")
    jm = JaxManager(jdir)
    jm.save(1, {"points": [np.ones(2)], "values": [0.5], "queue": [],
                "rng_state": np.random.default_rng(0).bit_generator.state},
            {"kind": "tuning", "fingerprint": "x"})
    jm.close()
    mgr = CheckpointManager(jdir)
    with pytest.raises(ForeignCheckpoint, match="not a snapshot of photon_tpu_torch"):
        th.tune_regularization(game["estimators"]()[1], train, valid, game["tbase"],
                               RANGES, n_iterations=4, seed=3, checkpoint_manager=mgr)
    mgr.close()
