"""The port's random-effect dataset builder (training form) against JAX's.

The same numpy inputs go through ``photon_tpu.data.random_effect`` and
``photon_tpu_torch.data.random_effect`` over the option grids of
``tests/test_random_effect.py`` (its builder-equivalence grid, the
active/passive split, the Pearson filter with and without an intercept,
and the bucket cap): entity keys, slots and every bucket array
(``idx``, ``val``, ``labels``, ``weights``, ``train_weights``,
``row_ids``, ``proj``, ``entity_ids``) are exactly equal, dtypes included.
``local_batches`` gathers the same offsets, with the ghost row at 0.
``pearson_scores`` is bit-equal. Host-resident buckets are refused.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu.data.random_effect import build_random_effect_dataset as jax_build
from photon_tpu.data.random_effect import pearson_scores as jax_pearson
from photon_tpu_torch.data.random_effect import (
    build_random_effect_dataset,
    pearson_scores,
)

CPU = torch.device("cpu")
FIELDS = ("idx", "val", "labels", "weights", "train_weights", "row_ids",
          "proj", "entity_ids")


def grid_data(dtype):
    """``TestVectorizedBuilderEquivalence``'s inputs: 37 entities over 200
    rows, some ghost entries, uneven weights."""
    rng = np.random.default_rng(17)
    n_ent, dg, k = 37, 50, 5
    ents = rng.integers(0, n_ent, size=200)
    n = len(ents)
    idx = rng.integers(0, dg + 1, size=(n, k)).astype(np.int32)
    val = np.where(idx < dg, rng.normal(size=(n, k)), 0.0).astype(dtype)
    labels = (rng.random(n) < 0.5).astype(dtype)
    weights = rng.uniform(0.5, 2.0, size=n).astype(dtype)
    keys = np.array([f"e{e:03d}" for e in ents], object)
    return keys, idx, val, labels, dg, weights


def signal_noise_data():
    """``TestPearsonFiltering``'s inputs: intercept at 0, signal columns
    1-3, noise columns 4-23."""
    rng = np.random.default_rng(42)
    d, n_per, n_entities, k = 24, 300, 6, 8
    n = n_per * n_entities
    users = np.asarray([f"u{i % n_entities}" for i in range(n)], object)
    idx = np.zeros((n, k), np.int32)
    val = np.zeros((n, k))
    val[:, 0] = 1.0
    idx[:, 1:4] = np.array([1, 2, 3])
    val[:, 1:4] = rng.normal(size=(n, 3))
    idx[:, 4:] = rng.integers(4, d, size=(n, 4))
    val[:, 4:] = 1e-3 * rng.normal(size=(n, 4))
    z = 4.0 * val[:, 1] - 3.5 * val[:, 2] + 3.0 * val[:, 3]
    y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    return users, idx, val, y, d, None


def assert_same(got, want):
    assert list(got.entity_keys) == list(want.entity_keys)
    assert got.entity_to_slot == want.entity_to_slot
    assert got.n_rows == want.n_rows and got.global_dim == want.global_dim
    assert len(got.buckets) == len(want.buckets)
    for gb, wb in zip(got.buckets, want.buckets):
        for f in FIELDS:
            g, w = getattr(gb, f).numpy(), np.asarray(getattr(wb, f))
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)


OPTS = [
    dict(),
    dict(min_entity_rows=3),
    dict(active_bound=2),
    dict(intercept_index=0),
    dict(max_features_per_entity=3),
    dict(intercept_index=0, max_features_per_entity=3, active_bound=2,
         min_entity_rows=2),
    dict(max_bucket_entities=2),
    dict(max_bucket_entities=5, intercept_index=0, min_entity_rows=4),
    dict(min_entity_rows=100),
]


@pytest.mark.parametrize("opts", OPTS, ids=[",".join(f"{k}={v}" for k, v in o.items())
                                            or "defaults" for o in OPTS])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_training_builder_equals_jax(opts, dtype):
    keys, idx, val, labels, dg, weights = grid_data(dtype)
    want = jax_build("re", keys, idx, val, labels, dg, weights=weights,
                     dtype=np.dtype(dtype), **opts)
    got = build_random_effect_dataset("re", keys, idx, val, labels, dg,
                                      weights=weights, dtype=getattr(torch, dtype),
                                      device=CPU, **opts)
    assert_same(got, want)
    if opts.get("min_entity_rows") == 100:
        assert got.buckets == () and got.entity_keys == []


@pytest.mark.parametrize("m,intercept", [(3, 0), (4, 0), (3, None), (30, 0)])
def test_pearson_filter_equals_jax(m, intercept):
    users, idx, val, y, d, _ = signal_noise_data()
    kw = dict(intercept_index=intercept, max_features_per_entity=m)
    want = jax_build("u", users, idx, val, y, d, dtype=np.float64, **kw)
    got = build_random_effect_dataset("u", users, idx, val, y, d,
                                      dtype=torch.float64, device=CPU, **kw)
    assert_same(got, want)
    if m < 10:
        assert max(b.local_dim for b in got.buckets) <= 8


def test_active_passive_split_equals_jax():
    """``test_active_passive_split``'s data: rows past the bound keep their
    scoring weight and lose their training weight."""
    keys, idx, val, labels, dg, _ = grid_data("float64")
    want = jax_build("re", keys, idx, val, labels, dg, active_bound=5,
                     dtype=np.float64)
    got = build_random_effect_dataset("re", keys, idx, val, labels, dg,
                                      active_bound=5, dtype=torch.float64,
                                      device=CPU)
    assert_same(got, want)
    for b in got.buckets:
        assert (b.train_weights.sum(1) <= 5 + 1e-9).all()
        assert ((b.train_weights > 0) <= (b.weights > 0)).all()


def test_local_batches_equal_jax():
    keys, idx, val, labels, dg, weights = grid_data("float64")
    offsets = np.random.default_rng(3).normal(size=len(labels))
    kw = dict(weights=weights, active_bound=3, intercept_index=0)
    jd = jax_build("re", keys, idx, val, labels, dg, dtype=np.float64, **kw)
    td = build_random_effect_dataset("re", keys, idx, val, labels, dg,
                                     dtype=torch.float64, device=CPU, **kw)
    for jb, tb in zip(jd.buckets, td.buckets):
        j = jb.local_batches(jnp.asarray(offsets))
        t = tb.local_batches(torch.from_numpy(offsets))
        assert t.features.dim == j.features.dim == tb.local_dim
        for got, want in ((t.offsets, j.offsets), (t.weights, j.weights),
                          (t.labels, j.labels), (t.features.idx, j.features.idx)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (t.offsets[tb.row_ids == len(labels)] == 0).all()


def test_pearson_scores_equal_jax():
    rng = np.random.default_rng(5)
    s, k, p = 50, 4, 6
    local = np.stack([rng.choice(p + 1, size=k, replace=False)
                      for _ in range(s)]).astype(np.int32)
    vals = rng.normal(size=(s, k))
    y = rng.normal(size=s)
    np.testing.assert_array_equal(pearson_scores(local, vals, y, p),
                                  jax_pearson(local, vals, y, p))


def test_host_resident_is_refused():
    """Host-resident buckets (the sweep cache's input) hold the JAX
    builder's host arrays; each upload through ``bucket(b)`` is counted.
    A bucket cap of 0 is still refused."""
    keys, idx, val, labels, dg, _ = grid_data("float32")
    from photon_tpu_torch.data import random_effect as tre_data

    want = jax_build("re", keys, idx, val, labels, dg, dtype=np.float32,
                     host_resident=True)
    got = build_random_effect_dataset("re", keys, idx, val, labels, dg,
                                      dtype=torch.float32, device=CPU,
                                      host_resident=True)
    assert got.host_resident and isinstance(want.buckets[0].idx, np.ndarray)
    assert_same(got, want)
    tre_data.reset_uploads()
    up = [got.bucket(b) for b in range(len(got.buckets))]
    assert tre_data.UPLOADS == {"buckets": len(got.buckets),
                                "bytes": sum(b.nbytes for b in got.buckets)}
    for gb, ub in zip(got.buckets, up):
        assert all(torch.equal(getattr(gb, f), getattr(ub, f)) for f in FIELDS)
    with pytest.raises(ValueError, match="max_bucket_entities"):
        build_random_effect_dataset("re", keys, idx, val, labels, dg,
                                    dtype=torch.float32, device=CPU,
                                    max_bucket_entities=0)
