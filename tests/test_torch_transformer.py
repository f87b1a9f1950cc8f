"""GAME scoring of the PyTorch port against the JAX package, on the CPU.

A JAX ``GameModel`` (fixed effect + ``perUser`` random effect with
trained-shape bucket stacks) is exported to numpy, carried into the port by
``game_model_from_numpy``, and both ``GameTransformer.transform`` score the
same bundle, made from a numpy seed. Rows of users the model never saw score
through the zero model. Tolerances: f32 ``atol 1e-5``, f64 ``atol 1e-12``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu.data.batch import SparseFeatures as JaxSparseFeatures
from photon_tpu.data.random_effect import (
    build_random_effect_dataset as jax_build_re_dataset,
)
from photon_tpu.estimators.config import (
    FixedEffectDataConfig as JaxFixedCfg,
    RandomEffectDataConfig as JaxRandomCfg,
)
from photon_tpu.estimators.game_transformer import GameTransformer as JaxTransformer
from photon_tpu.game.coordinates import FixedEffectModel as JaxFixedEffectModel
from photon_tpu.game.descent import GameModel as JaxGameModel
from photon_tpu.game.random_effect import RandomEffectModel as JaxRandomEffectModel
from photon_tpu.io.data_reader import GameDataBundle as JaxBundle
from photon_tpu.models.coefficients import Coefficients as JaxCoefficients
from photon_tpu.models.glm import GeneralizedLinearModel as JaxGLM
from photon_tpu.types import TaskType as JaxTaskType
from photon_tpu_torch.data.batch import SparseFeatures
from photon_tpu_torch.data.random_effect import build_random_effect_dataset
from photon_tpu_torch.estimators.config import (
    FixedEffectDataConfig,
    RandomEffectDataConfig,
)
from photon_tpu_torch.estimators.game_transformer import GameTransformer
from photon_tpu_torch.game.coordinates import FixedEffectModel
from photon_tpu_torch.game.random_effect import RandomEffectModel
from photon_tpu_torch.io.convert import game_model_from_numpy
from photon_tpu_torch.io.data_reader import GameDataBundle
from test_torch_jax_decoder import jax_decoder  # noqa: F401

CPU = torch.device("cpu")
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, 1e-5),
          "f64": (np.float64, jnp.float64, torch.float64, 1e-12)}
N_USERS, N_UNSEEN, ROWS_PER_USER, D_GLOBAL, D_USER = 10, 3, 12, 20, 3
INTERCEPT = 0


def _ell(seed, users, dim_dtype):
    """GAME-shaped ELL rows: intercept + 6 global + 2 per-user entries per
    row (the layout of bench.py's ``_game_bundle``, cut to a small size)."""
    rng = np.random.default_rng(seed)
    n = len(users)
    gi = 1 + rng.integers(0, D_GLOBAL, size=(n, 6))
    ui = 1 + D_GLOBAL + users[:, None] * D_USER + rng.integers(0, D_USER, size=(n, 2))
    idx = np.concatenate([np.zeros((n, 1), np.int64), gi, ui], axis=1).astype(np.int32)
    val = np.concatenate(
        [np.ones((n, 1)), rng.normal(size=(n, 6)) / 2, rng.normal(size=(n, 2))], axis=1)
    # a few padding slots (ghost column == dim, value 0)
    dim = 1 + D_GLOBAL + (N_USERS + N_UNSEEN) * D_USER
    ghost = rng.random(idx.shape) < 0.1
    ghost[:, 0] = False
    idx = np.where(ghost, dim, idx).astype(np.int32)
    val = np.where(ghost, 0.0, val).astype(dim_dtype)
    return idx, val, dim


def _score_arrays(dtype):
    """The scoring rows: every seen user plus N_UNSEEN users the model
    never saw, shuffled."""
    rng = np.random.default_rng(7)
    users = rng.permutation(np.repeat(np.arange(N_USERS + N_UNSEEN), ROWS_PER_USER))
    idx, val, dim = _ell(11, users, dtype)
    n = len(users)
    offsets = rng.normal(size=n) * 0.1
    labels = (rng.random(n) < 0.5).astype(np.float64)
    keys = np.array([f"user{u}" for u in users], object)
    return idx, val, dim, keys, offsets, labels


def _jax_model(np_dt, j_dt):
    """Fixed effect + perUser RE whose buckets have the shapes training
    gives: the RE dataset of seen users' training rows, random coefficients
    on each entity's real columns."""
    rng = np.random.default_rng(5)
    users = np.repeat(np.arange(N_USERS), ROWS_PER_USER - 4)
    idx, val, dim = _ell(3, users, np_dt)
    # uneven entity sizes: drop some rows of the first users
    keep = ~((users < 4) & (rng.random(len(users)) < 0.6))
    idx, val, users = idx[keep], val[keep], users[keep]
    ds = jax_build_re_dataset(
        re_type="userId", entity_keys_per_row=np.array([f"user{u}" for u in users], object),
        idx=idx, val=val, labels=np.zeros(len(users)), global_dim=dim,
        intercept_index=INTERCEPT, dtype=np_dt,
    )
    coefs = []
    for b in ds.buckets:
        proj = np.asarray(b.proj)
        c = np.where(proj < dim, rng.normal(size=proj.shape), 0.0)
        coefs.append(jnp.asarray(c, j_dt))
    re = JaxRandomEffectModel(
        re_type="userId", task=JaxTaskType.LOGISTIC_REGRESSION,
        bucket_coefs=coefs, bucket_proj=[b.proj for b in ds.buckets],
        bucket_entity_ids=[b.entity_ids for b in ds.buckets],
        entity_keys=ds.entity_keys, entity_to_slot=ds.entity_to_slot,
        global_dim=dim,
    )
    fixed = JaxFixedEffectModel(
        JaxGLM(JaxCoefficients(jnp.asarray(rng.normal(size=dim), j_dt)),
               JaxTaskType.LOGISTIC_REGRESSION),
        "global",
    )
    assert len(ds.buckets) >= 2
    return JaxGameModel({"fixed": fixed, "perUser": re})


def export_to_numpy(model) -> dict:
    """The spec ``game_model_from_numpy`` takes, from a JAX GameModel."""
    spec = {}
    for cid in model.keys():
        m = model[cid]
        if isinstance(m, JaxFixedEffectModel):
            var = m.model.coefficients.variances
            spec[cid] = {
                "type": "fixed", "feature_shard": m.feature_shard,
                "task": m.model.task.value,
                "means": np.asarray(m.model.coefficients.means),
                "variances": None if var is None else np.asarray(var),
            }
        else:
            spec[cid] = {
                "type": "random", "re_type": m.re_type, "task": m.task.value,
                "global_dim": m.global_dim, "entity_keys": list(m.entity_keys),
                "bucket_coefs": [np.asarray(a) for a in m.bucket_coefs],
                "bucket_proj": [np.asarray(a) for a in m.bucket_proj],
                "bucket_entity_ids": [np.asarray(a) for a in m.bucket_entity_ids],
                "bucket_variances": (
                    None if m.bucket_variances is None
                    else [np.asarray(a) for a in m.bucket_variances]),
            }
    return spec


def _both_bundles(np_dt):
    idx, val, dim, keys, offsets, labels = _score_arrays(np_dt)
    common = dict(labels=labels, offsets=offsets, weights=np.ones(len(keys)),
                  uids=np.arange(len(keys)).astype(object), id_tags={"userId": keys})
    jb = JaxBundle(features={"global": JaxSparseFeatures(
        jnp.asarray(idx), jnp.asarray(val), dim)}, **common)
    pb = GameDataBundle(features={"global": SparseFeatures(
        torch.from_numpy(idx), torch.from_numpy(val), dim)}, **common)
    return jb, pb


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_transform_matches_jax(dtype):
    np_dt, j_dt, t_dt, atol = DTYPES[dtype]
    jmodel = _jax_model(np_dt, j_dt)
    model = game_model_from_numpy(export_to_numpy(jmodel), CPU, t_dt)
    jb, pb = _both_bundles(np_dt)
    want = np.asarray(JaxTransformer(
        jmodel, {"fixed": JaxFixedCfg("global"), "perUser": JaxRandomCfg("userId", "global")},
        intercept_indices={"global": INTERCEPT}).transform(jb))
    got = GameTransformer(
        model, {"fixed": FixedEffectDataConfig("global"),
                "perUser": RandomEffectDataConfig("userId", "global")},
        intercept_indices={"global": INTERCEPT}).transform(pb)
    assert got.dtype == t_dt and got.device == CPU
    assert got.shape == want.shape == (pb.n_rows,)
    assert want.dtype == np_dt
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_unseen_entities_score_zero(dtype):
    """Rows of users the model never saw get offset + fixed score only; the
    seen users' rows get a nonzero random-effect share."""
    np_dt, j_dt, t_dt, atol = DTYPES[dtype]
    model = game_model_from_numpy(export_to_numpy(_jax_model(np_dt, j_dt)), CPU, t_dt)
    _, pb = _both_bundles(np_dt)
    total = GameTransformer(
        model, {"fixed": FixedEffectDataConfig("global"),
                "perUser": RandomEffectDataConfig("userId", "global")},
        intercept_indices={"global": INTERCEPT}).transform(pb).numpy()
    with pytest.raises(ValueError, match="no data config"):
        GameTransformer(model, {"fixed": FixedEffectDataConfig("global")}).transform(pb)
    fe = (pb.features["global"].matvec(model["fixed"].model.coefficients.means).numpy()
          + pb.offsets.astype(np.float32))
    unseen = np.isin(pb.id_tags["userId"], [f"user{u}" for u in range(N_USERS, N_USERS + N_UNSEEN)])
    assert unseen.sum() == N_UNSEEN * ROWS_PER_USER
    np.testing.assert_allclose(total[unseen], fe[unseen], rtol=0, atol=atol)
    assert np.all(np.abs(total[~unseen] - fe[~unseen]) > 0)


@pytest.mark.parametrize(
    "intercept,dtype",
    [(INTERCEPT, "f32"), (None, "f32"), (INTERCEPT, "f64"), (None, "f64")],
    ids=["intercept", "no_intercept", "intercept_f64", "no_intercept_f64"])
def test_scoring_re_dataset_equals_jax(intercept, dtype):
    """The port's scoring dataset builder gives the JAX builder's buckets,
    entity order and slots exactly."""
    np_dt, _, t_dt, _ = DTYPES[dtype]
    idx, val, dim, keys, _, labels = _score_arrays(np_dt)
    kw = dict(re_type="userId", entity_keys_per_row=keys, idx=idx, val=val,
              labels=labels, global_dim=dim, intercept_index=intercept)
    want = jax_build_re_dataset(**kw, dtype=np_dt)
    got = build_random_effect_dataset(**kw, dtype=t_dt, device=CPU)
    assert list(got.entity_keys) == list(want.entity_keys)
    assert got.entity_to_slot == want.entity_to_slot
    assert len(got.buckets) == len(want.buckets)
    for gb, wb in zip(got.buckets, want.buckets):
        for field in ("idx", "val", "labels", "weights", "row_ids", "proj", "entity_ids"):
            g, w = getattr(gb, field).numpy(), np.asarray(getattr(wb, field))
            assert g.dtype == w.dtype, field
            np.testing.assert_array_equal(g, w, err_msg=field)


def test_game_model_from_numpy_places_and_types():
    spec = export_to_numpy(_jax_model(np.float32, jnp.float32))
    model = game_model_from_numpy(spec, CPU, torch.float64)
    fe, re = model["fixed"], model["perUser"]
    assert isinstance(fe, FixedEffectModel) and isinstance(re, RandomEffectModel)
    assert fe.model.coefficients.means.dtype == torch.float64
    assert all(c.dtype == torch.float64 for c in re.bucket_coefs)
    assert all(p.dtype == torch.int32 for p in re.bucket_proj)
    jre = _jax_model(np.float32, jnp.float32)["perUser"]
    assert re.entity_to_slot == jre.entity_to_slot
    for key in ("user0", "user5", "nobody"):
        gi, gv, gvar = re.export_for(key)
        wi, wv = jre.coefficients_for(key)
        assert gvar is None
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gv.astype(np.float32), wv)
