"""The port's online scoring core (``photon_tpu_torch/serving``) against the
JAX package's (``photon_tpu/serving``), on the CPU.

* ``additive_score_rows`` on seeded inputs: fixed and random-effect parts,
  ghost columns, an unseen (all-ghost) entity, a width-0 random-effect
  model, f32 and f64 (relative 1e-12 in f64, 1e-5·(1+|score|) in f32: the
  port's fixed parts sum in float64 and round once, the JAX program sums
  in float32).
* ``transform_rows`` against JAX's and against the port's ``transform``.
* ``CoefficientStore.from_model`` arrays equal JAX's; a store saved by one
  package loads in the other.
* ``DeviceCoefficientCache``: one seeded key stream gives JAX's slots,
  degraded flags, stats, ``snapshot()`` and gathered rows.
* ``RowScorer.parse_request`` and ``score_rows`` on the same JSON payloads
  as JAX's (unknown features, the over-cap row and bad payloads included),
  the registry loading models across packages, and the post-warmup
  contract: a request of any bucket runs the ops of that bucket's warmup
  and builds no kernel library.

The model (JAX's ``trained`` fixture's shape: 6 users x 16 rows) is trained
once per module by each package's training driver.
"""
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from photon_tpu.cli import game_training_driver as jax_training_driver
from photon_tpu.estimators import (
    FixedEffectDataConfig as JaxFixedConfig,
    GameTransformer as JaxTransformer,
    RandomEffectDataConfig as JaxRandomConfig,
)
from photon_tpu.estimators.game_transformer import (
    additive_score_rows as jax_score_rows,
)
from photon_tpu.index.index_map import MmapIndexMap as JaxIndexMap
from photon_tpu.io.data_reader import (
    AvroDataReader as JaxReader,
    FeatureShardConfig as JaxShardConfig,
)
from photon_tpu.io.model_io import load_game_model as jax_load_model
from photon_tpu.serving import (
    CoefficientStore as JaxStore,
    DeviceCoefficientCache as JaxCache,
    ModelRegistry as JaxRegistry,
    ServingConfig as JaxServingConfig,
)
from photon_tpu.serving.scorer import RequestError as JaxRequestError
from photon_tpu_torch.cli import game_training_driver as port_training_driver
from photon_tpu_torch.estimators.config import (
    FixedEffectDataConfig,
    RandomEffectDataConfig,
)
from photon_tpu_torch.estimators.game_transformer import (
    GameTransformer,
    additive_score_rows,
)
from photon_tpu_torch.index.index_map import MmapIndexMap
from photon_tpu_torch.io.avro import read_records
from photon_tpu_torch.io.data_reader import AvroDataReader, FeatureShardConfig
from photon_tpu_torch.io.model_io import load_game_model
from photon_tpu_torch.ops import cuda_sparse as cs
from photon_tpu_torch.serving import (
    CoefficientStore,
    DeviceCoefficientCache,
    MicroBatcher,
    ModelRegistry,
    ServingConfig,
)
from photon_tpu_torch.serving.scorer import RequestError
from test_torch_jax_decoder import jax_decoder  # noqa: F401
from test_torch_scoring_driver import _write_game_avro

CPU = torch.device("cpu")
CONFIG = dict(max_batch=8, cache_entities=16, max_row_nnz=32)


def train_models(d):
    """Train one model sweep (per-user weights 1 and 100, ``--output-mode
    ALL``) with each package's driver on the same rows; held-out rows
    include two users no model saw, and offsets."""
    _write_game_avro(d / "train.avro", seed=1, n_users=6, rows_per_user=16)
    n_val = _write_game_avro(d / "val.avro", seed=2, n_users=8,
                             rows_per_user=4, offsets=True)
    common = [
        "--train-data", str(d / "train.avro"), "--task", "LOGISTIC_REGRESSION",
        "--feature-shard", "global:features", "--output-mode", "ALL",
        "--coordinate", "fixed:type=fixed,shard=global,reg=L2,max_iter=25,"
        "reg_weights=1",
        "--coordinate", "perUser:type=random,re_type=userId,shard=global,"
        "reg=L2,max_iter=25,reg_weights=1|100",
    ]
    # cpu-only: the JAX driver's backend probe would take the machine-wide
    # accelerator claim lock for the life of the test process
    jax_training_driver.run([*common, "--output-dir", str(d / "jax"),
                             "--devices", "1", "--backend-policy", "cpu-only"])
    port_training_driver.run([*common, "--output-dir", str(d / "port"),
                              "--device", "cpu"])
    return SimpleNamespace(
        d=d, val=str(d / "val.avro"), n_val=n_val,
        jax=[str(d / "jax" / "models" / str(i)) for i in (0, 1)],
        port=[str(d / "port" / "models" / str(i)) for i in (0, 1)],
        jax_index=str(d / "jax" / "index" / "global"),
        port_index=str(d / "port" / "index" / "global"))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return train_models(tmp_path_factory.mktemp("torch_serving"))


def payload(rec):
    return {"features": rec["features"], "entities": rec["metadataMap"],
            "uid": rec["uid"], "offset": rec["offset"]}


def close(got, want, f32=True):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    if f32:
        assert np.all(np.abs(got - want) <= 1e-5 * (1 + np.abs(want))), (got, want)
    else:
        assert np.all(np.abs(got - want) <= 1e-12 * np.maximum(1, np.abs(want))), (
            got, want)


# ------------------------------------------------------ additive_score_rows


def _rows_case(case: str, dt, seed=0):
    """Seeded inputs of one case: (offsets, idx, val, fixed_ws, proj, coef,
    fixed_parts, re_parts) as numpy."""
    rng = np.random.default_rng(seed)
    b, k = 9, 7
    shards = {"g": 40, "u": 25} if case == "two_parts" else {"g": 40}
    idx, val = {}, {}
    for s, dim in shards.items():
        i = rng.integers(0, dim, (b, k)).astype(np.int32)
        i[rng.random((b, k)) < 0.3] = dim          # ghost columns
        v = rng.normal(size=(b, k)).astype(np.float32)
        v[i == dim] = 0.0
        idx[s], val[s] = i, v
    fixed, fws = [], {}
    for cid, s in ({"two_parts": [("fa", "g"), ("fb", "u")]}.get(
            case, [("fa", "g")])):
        fws[cid] = np.concatenate([rng.normal(size=shards[s]), [0.0]]).astype(dt)
        fixed.append((cid, s))
    re_specs = {"fixed_and_re": [("ra", "g", 6)], "width0": [("ra", "g", 0)],
                "two_parts": [("ra", "g", 6), ("rb", "u", 4)]}[case]
    proj, coef, re = {}, {}, []
    for cid, s, p in re_specs:
        dim = shards[s]
        pr = np.full((b, p), dim, np.int32)
        for r in range(b):
            n = int(rng.integers(0, p + 1))
            # row 0 has an unseen entity (all ghost); others overlap idx
            if r and n:
                seen = idx[s][r][:2]
                cols = np.unique(np.concatenate(
                    [seen[seen < dim], rng.integers(0, dim, n)]))[:p]
                pr[r, :len(cols)] = cols
        proj[cid] = pr
        coef[cid] = np.where(pr < dim, rng.normal(size=(b, p)), 0.0).astype(dt)
        re.append((cid, s))
    off = rng.normal(size=b).astype(np.float32)
    return off, idx, val, fws, proj, coef, tuple(fixed), tuple(re)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", ["fixed_and_re", "width0", "two_parts"])
def test_additive_score_rows_matches_jax(case, dtype):
    off, idx, val, fws, proj, coef, fixed, re = _rows_case(case, np.dtype(dtype))
    kw = dict(fixed_parts=fixed, re_parts=re)

    def j(d):
        return {k: jnp.asarray(v) for k, v in d.items()}

    def t(d):
        return {k: torch.from_numpy(v) for k, v in d.items()}

    want = np.asarray(jax_score_rows(jnp.asarray(off), j(idx), j(val), j(fws),
                                     j(proj), j(coef), **kw))
    got = additive_score_rows(torch.from_numpy(off), t(idx), t(val), t(fws),
                              t(proj), t(coef), **kw)
    assert got.dtype == getattr(torch, dtype) and want.dtype == np.dtype(dtype)
    close(got.numpy(), want, f32=dtype == "float32")
    if case == "width0":  # a width-0 model adds nothing: fixed part alone
        alone = additive_score_rows(torch.from_numpy(off), t(idx), t(val), t(fws),
                                    {}, {}, fixed_parts=fixed, re_parts=())
        assert torch.equal(alone, got)
    if case == "fixed_and_re":  # row 0's all-ghost subspace is the zero model
        alone = additive_score_rows(torch.from_numpy(off), t(idx), t(val), t(fws),
                                    {}, {}, fixed_parts=fixed, re_parts=())
        assert alone[0] == got[0] and not torch.equal(alone, got)


# -------------------------------------------------------- transform_rows


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_transform_rows_matches_jax_and_transform(trained, dtype):
    """Both packages load the JAX-trained model at ``dtype``, read the
    held-out rows and score them through ``transform_rows``; the port's
    also equals its own ``transform`` (1e-5·(1+|s|) in f32, 1e-12 in f64)."""
    configs = {"fixed": ("global",), "perUser": ("userId", "global")}
    jimap = JaxIndexMap(trained.jax_index)
    jmodel, _ = jax_load_model(trained.jax[0], {"global": jimap},
                               dtype=getattr(jnp, dtype))
    jt = JaxTransformer(jmodel, {
        "fixed": JaxFixedConfig(*configs["fixed"]),
        "perUser": JaxRandomConfig(re_type="userId", feature_shard="global")},
        intercept_indices={"global": jimap.intercept_index})
    jb = JaxReader({"global": jimap}, {"global": JaxShardConfig(("features",), True)},
                   id_tag_columns=["userId"]).read([trained.val], dtype=getattr(jnp, dtype),
                                                   require_labels=False)
    want = np.asarray(jt.transform_rows(jb))

    imap = MmapIndexMap(trained.jax_index)
    model, _ = load_game_model(trained.jax[0], {"global": imap},
                               dtype=getattr(torch, dtype), device=CPU)
    pt = GameTransformer(model, {
        "fixed": FixedEffectDataConfig("global"),
        "perUser": RandomEffectDataConfig(re_type="userId", feature_shard="global")},
        intercept_indices={"global": imap.intercept_index})
    pb = AvroDataReader({"global": imap},
                        {"global": FeatureShardConfig(("features",), True)},
                        id_tag_columns=["userId"]).read(
        [trained.val], require_labels=False, device=CPU,
        dtype=getattr(torch, dtype))
    got = pt.transform_rows(pb)
    assert got.dtype == getattr(torch, dtype) and len(got) == trained.n_val
    f32 = dtype == "float32"
    close(got.numpy(), want, f32)
    close(got.numpy(), pt.transform(pb).numpy(), f32)
    assert np.std(want) > 0.1


# ----------------------------------------------------- coefficient stores


def _re_models(trained):
    jimap = JaxIndexMap(trained.jax_index)
    jm, _ = jax_load_model(trained.jax[0], {"global": jimap})
    imap = MmapIndexMap(trained.jax_index)
    pm, _ = load_game_model(trained.jax[0], {"global": imap}, dtype=torch.float32,
                            device=CPU)
    return jm["perUser"], pm["perUser"]


def test_coefficient_store_matches_jax_and_loads_across_packages(trained, tmp_path):
    jm, pm = _re_models(trained)
    js, ps = JaxStore.from_model(jm), CoefficientStore.from_model(pm)
    assert ps.keys == js.keys and ps.global_dim == js.global_dim
    for a in ("offsets", "cols", "vals"):
        assert getattr(ps, a).dtype == getattr(js, a).dtype
        np.testing.assert_array_equal(getattr(ps, a), getattr(js, a))
    assert ps.max_width == js.max_width and ps.n_entities == js.n_entities
    assert ps.lookup("ghost-entity") is None
    ps.save(str(tmp_path / "port"))
    js.save(str(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for a, b in ((JaxStore.load(str(tmp_path / "port")), ps),
                 (CoefficientStore.load(str(tmp_path / "jax")), js)):
        assert isinstance(a.cols, np.memmap)
        for key in ps.keys:
            (ac, av), (bc, bv) = a.lookup(str(key)), b.lookup(key)
            np.testing.assert_array_equal(ac, bc)
            np.testing.assert_array_equal(av, bv)


def test_device_cache_matches_jax_eviction_sequence(trained):
    """One seeded key stream (known, unseen and absent entities, batches of
    at most the capacity) through both caches: the same slots, degraded
    flags and gathered rows every batch, the same stats and ``snapshot()``
    after, an invalidation included."""
    jm, pm = _re_models(trained)
    js, ps = JaxStore.from_model(jm), CoefficientStore.from_model(pm)
    jc, pc = JaxCache(js, capacity=3), DeviceCoefficientCache(ps, capacity=3,
                                                              device=CPU)
    assert pc.width == jc.width
    rng = np.random.default_rng(5)
    universe = list(ps.keys) + ["ghost-a", "ghost-b", None]
    for step in range(40):
        keys = list(rng.choice(np.array(universe, dtype=object),
                               int(rng.integers(1, 4)), replace=False))
        if step == 20:
            assert pc.invalidate(keys) == jc.invalidate(keys)
        (jsl, jdg), (psl, pdg) = jc.resolve(keys), pc.resolve(keys)
        np.testing.assert_array_equal(psl, jsl)
        np.testing.assert_array_equal(pdg, jdg)
        (jp, jcoef), (pp, pcoef) = jc.gather(jsl), pc.gather(psl)
        np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(pcoef.numpy(), np.asarray(jcoef))
    assert pc.snapshot() == jc.snapshot()
    assert pc.stats["evictions"] > 0 and pc.stats["fallbacks"] > 0
    assert pc.h2d_copies <= pc.stats["misses"]
    with pytest.raises(RuntimeError, match="distinct entities"):
        pc.slots_for(list(ps.keys)[:4])


# --------------------------------------------------------- scorer, registry


def _odd_payloads(recs):
    """Payloads beyond the held-out rows: unknown features and bags, an
    unseen entity, no entity, the entity as a top-level field, no offset."""
    base = payload(recs[0])
    out = [
        {**base, "features": base["features"] + [
            {"name": "never", "term": "seen", "value": 3.0}]},
        {**base, "entities": {"userId": "never-seen"}},
        {**base, "entities": {}},
        {"features": base["features"], "userId": recs[1]["metadataMap"]["userId"]},
        {"features": base["features"][:2], "other_bag": [{"name": "x", "value": 1}]},
        {},
    ]
    return out


BAD = [
    [1, 2],
    {"features": {"name": "g"}},
    {"features": [{"name": "g", "term": "0"}]},
    {"features": [{"name": "g", "term": "0", "value": "abc"}]},
    {"entities": ["user1"]},
    {"offset": "x"},
    {"features": [{"name": "g", "term": str(j % 5), "value": 1.0}
                  for j in range(40)]},                   # over max_row_nnz
]


def test_parse_request_and_score_rows_match_jax(trained):
    jr = JaxRegistry(trained.jax[0], JaxServingConfig(**CONFIG))
    pr = ModelRegistry(trained.jax[0], ServingConfig(**CONFIG), device="cpu")
    js, ps = jr.current.scorer, pr.current.scorer
    recs = read_records(trained.val)
    payloads = [payload(r) for r in recs] + _odd_payloads(recs)
    jrows = [js.parse_request(p) for p in payloads]
    prows = [ps.parse_request(p) for p in payloads]
    for a, b in zip(prows, jrows):
        assert a.entity_keys == b.entity_keys and a.offset == b.offset
        for s in b.shard_idx:
            np.testing.assert_array_equal(a.shard_idx[s], b.shard_idx[s])
            np.testing.assert_array_equal(a.shard_val[s], b.shard_val[s])
    for lo, hi in ((0, len(prows)), (0, 3), (5, 6)):
        close(ps.score_rows(prows[lo:hi]), js.score_rows(jrows[lo:hi]))
    for bad in BAD:
        with pytest.raises(JaxRequestError) as je:
            js.parse_request(bad)
        with pytest.raises(RequestError) as pe:
            ps.parse_request(bad)
        assert str(pe.value) == str(je.value)
    assert ps.cache_snapshot() == js.cache_snapshot()
    assert ps.breaker_snapshot() == js.breaker_snapshot()


@pytest.mark.parametrize("trained_by", ["jax", "port"])
def test_registry_loads_models_across_packages(trained, trained_by):
    """Each package's registry serves each package's saved models: the same
    scores on every held-out row, for both models of the sweep."""
    recs = read_records(trained.val)
    for model_dir in getattr(trained, trained_by):
        jr = JaxRegistry(model_dir, JaxServingConfig(**CONFIG))
        pr = ModelRegistry(model_dir, ServingConfig(**CONFIG), device="cpu")
        js, ps = jr.current.scorer, pr.current.scorer
        want = js.score_rows([js.parse_request(payload(r)) for r in recs])
        got = ps.score_rows([ps.parse_request(payload(r)) for r in recs])
        close(got, want)
        assert pr.current.version == jr.current.version == 1
        assert pr.current.meta == jr.current.meta
        assert pr.device == CPU


def test_scorer_matches_batch_transform_and_unseen_fallback(trained):
    """The port's scorer against the port's batch scorer on every held-out
    row; an unseen entity scores as a request without one."""
    pr = ModelRegistry(trained.port[1], ServingConfig(
        max_batch=8, cache_entities=2, max_row_nnz=32), device="cpu")
    scorer = pr.current.scorer
    imap = MmapIndexMap(trained.port_index)
    model, _ = load_game_model(trained.port[1], {"global": imap},
                               dtype=torch.float32, device=CPU)
    t = GameTransformer(model, {
        "fixed": FixedEffectDataConfig("global"),
        "perUser": RandomEffectDataConfig(re_type="userId", feature_shard="global")},
        intercept_indices={"global": imap.intercept_index})
    bundle = AvroDataReader({"global": imap},
                            {"global": FeatureShardConfig(("features",), True)},
                            id_tag_columns=["userId"]).read(
        [trained.val], require_labels=False, device=CPU, dtype=torch.float32)
    recs = read_records(trained.val)
    got = scorer.score_rows([scorer.parse_request(payload(r)) for r in recs])
    close(got, t.transform(bundle).numpy())
    assert scorer.cache_snapshot()["perUser"]["capacity"] == 8  # max_batch floor
    p = payload(recs[0])
    unseen = scorer.score_rows([scorer.parse_request(
        {**p, "entities": {"userId": "never-seen"}})])[0]
    none = scorer.score_rows([scorer.parse_request({**p, "entities": {}})])[0]
    assert unseen == none and abs(unseen - got[0]) > 1e-6


def test_batch_reaches_device_in_one_copy_with_its_slots(trained, monkeypatch):
    """A scored chunk makes one assembly copy, and the random effect's
    cache slots ride in it: ``gather`` is handed a view of that copy (int32
    slots already on the device), so it copies nothing; the cache's own
    copies are its staged misses, at most one a chunk."""
    pr = ModelRegistry(trained.port[1], ServingConfig(
        max_batch=8, cache_entities=2, max_row_nnz=32), device="cpu")
    scorer = pr.current.scorer
    cache = scorer._caches["perUser"]
    handed = []
    real = cache.gather
    monkeypatch.setattr(cache, "gather", lambda s: handed.append(s) or real(s))
    rows = [scorer.parse_request(payload(r)) for r in read_records(trained.val)]
    a0, s0, m0 = scorer.h2d_copies, cache.h2d_copies, cache.stats["misses"]
    scorer.score_rows(rows)
    chunks = -(-len(rows) // 8)
    assert len(handed) == chunks and scorer.h2d_copies - a0 == chunks
    assert all(isinstance(s, torch.Tensor) and s.dtype == torch.int32
               and s.device.type == scorer.device.type for s in handed)
    assert 0 < cache.h2d_copies - s0 <= chunks and cache.stats["misses"] > m0
    # a host slot vector costs the cache one copy (none on the CPU, where
    # the tables already are)
    cache.gather(np.zeros(3, np.int32))
    assert cache.h2d_copies - s0 <= chunks


def test_no_build_after_warmup(trained, monkeypatch):
    """The port's form of "no recompile after warmup": after the registry's
    warmup, a request of any bucket runs exactly the ops that the same
    bucket ran in warmup (profiled by op name; its entities resident, so
    nothing is staged) and builds no kernel library."""
    builds = []
    monkeypatch.setattr(cs, "build_library", lambda: builds.append(1))
    pr = ModelRegistry(trained.jax[0], ServingConfig(**CONFIG), device="cpu")
    scorer = pr.current.scorer
    rows = [scorer.parse_request(payload(r)) for r in read_records(trained.val)]
    dummy = scorer._score_chunk  # the warmup's call, one bucket at a time

    def ops(fn):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
            fn()
        return sorted({e.key for e in p.key_averages()})

    scorer.score_rows(rows)  # entities resident: no request below stages one
    for size in (1, 2, 3, 5, 7, 8):
        bp = scorer._bucket(size)
        scorer._warming = True
        try:
            warm = ops(lambda: dummy([rows[0]] * bp))
        finally:
            scorer._warming = False
        assert ops(lambda: scorer.score_rows(rows[:size])) == warm, size
    assert builds == []


def test_batcher_coalesces_port_rows(trained):
    pr = ModelRegistry(trained.jax[0], ServingConfig(**CONFIG), device="cpu")
    version = pr.current
    rows = [version.scorer.parse_request(payload(r))
            for r in read_records(trained.val)[:8]]
    ref = version.scorer.score_rows(rows)
    batcher = MicroBatcher(max_batch=8, max_wait_ms=50.0, start=False)
    futures = [batcher.submit(version, row) for row in rows]
    t0 = time.monotonic()
    batcher.start()
    got = [f.result(timeout=30) for f in futures]
    assert time.monotonic() - t0 < 30
    np.testing.assert_array_equal(got, ref)
    assert batcher.stats["batches"] == 1 and batcher.stats["max_batch_rows"] == 8
    assert set(got[0].stages) == {"queue_wait", "batch_assembly", "store_resolve",
                                  "kernel"}
    batcher.close()
    with pytest.raises(RuntimeError):
        batcher.submit(version, rows[0])
    assert json.dumps(float(got[0]))
