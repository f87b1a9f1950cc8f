"""Host I/O of the PyTorch port against the JAX package, on the CPU.

What one package writes, the other reads: Avro containers, ``MmapIndexMap``
stores (byte for byte), GAME model directories (fixed effect + per-user
random effect, equal arrays after a load, both ways) and ``scores.avro``.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu.game.coordinates import FixedEffectModel as JaxFixedEffectModel
from photon_tpu.game.descent import GameModel as JaxGameModel
from photon_tpu.index import index_map as jax_index_map
from photon_tpu.io import avro as jax_avro
from photon_tpu.io import model_io as jax_model_io
from photon_tpu.models.coefficients import Coefficients as JaxCoefficients
from photon_tpu.models.glm import GeneralizedLinearModel as JaxGLM
from photon_tpu.types import TaskType as JaxTaskType
from photon_tpu_torch.index import index_map as port_index_map
from photon_tpu_torch.io import avro as port_avro
from photon_tpu_torch.io import model_io as port_model_io
from photon_tpu_torch.io.schemas import TRAINING_EXAMPLE_AVRO

CPU = torch.device("cpu")
PACKAGES = {
    "jax": (jax_avro, jax_index_map, jax_model_io),
    "port": (port_avro, port_index_map, port_model_io),
}
DIRECTIONS = [("jax", "port"), ("port", "jax")]


def _records(seed=0, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        feats = [
            {"name": f"f{j}", "term": None if j % 3 else f"t{j}",
             "value": float(rng.normal())}
            for j in rng.choice(12, size=int(rng.integers(0, 5)), replace=False)
        ]
        out.append({
            "uid": None if i % 7 == 0 else f"u{i}",
            "label": float(rng.random() < 0.5),
            "weight": None if i % 2 else float(rng.random()),
            "offset": float(rng.normal()) if i % 3 == 0 else None,
            "features": feats,
            "metadataMap": {"userId": f"user{i % 5}"} if i % 4 else None,
        })
    return out


@pytest.mark.parametrize("codec", ["null", "deflate"])
@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_avro_containers_cross_read(tmp_path, writer, reader, codec):
    recs = _records()
    path = str(tmp_path / "data.avro")
    PACKAGES[writer][0].write_container(
        path, TRAINING_EXAMPLE_AVRO, recs, codec=codec, block_records=7
    )
    schema, it = PACKAGES[reader][0].read_container(path)
    assert schema["name"] == "TrainingExampleAvro"
    assert list(it) == recs


EVERY_TYPE = {
    "type": "record", "name": "Node", "namespace": "t",
    "fields": [
        {"name": "flag", "type": "boolean"},
        {"name": "i", "type": "int"},
        {"name": "big", "type": "long"},
        {"name": "f", "type": "float"},
        {"name": "d", "type": "double"},
        {"name": "raw", "type": "bytes"},
        {"name": "s", "type": "string"},
        {"name": "fx", "type": {"type": "fixed", "name": "Four", "size": 4}},
        {"name": "e", "type": {"type": "enum", "name": "Color",
                               "symbols": ["RED", "GREEN", "BLUE"]}},
        {"name": "m", "type": {"type": "map", "values": ["null", "double"]}},
        {"name": "colors", "type": {"type": "array", "items": "Color"}},
        {"name": "next", "type": ["null", "Node"]},
    ],
}


def _node(depth, k):
    return {"flag": k % 2 == 0, "i": -k * 1000, "big": (1 << 40) + k, "f": 0.5 * k,
            "d": -1.25e300 * k, "raw": bytes(range(k % 7)), "s": f"é{k}" * k,
            "fx": b"\x00\x01\x02\x03", "e": ["RED", "GREEN", "BLUE"][k % 3],
            "m": {f"k{j}": (None if j % 2 else j / 3) for j in range(k % 4)},
            "colors": ["BLUE"] * (k % 3),
            "next": _node(depth - 1, k + 1) if depth else None}


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_every_avro_type_cross_decodes(writer, reader):
    """Each primitive and complex type, named-type references and a
    recursive record encode in one package and decode in the other."""
    value = _node(3, 1)
    data = PACKAGES[writer][0].Encoder(EVERY_TYPE).encode(value)
    got, pos = PACKAGES[reader][0].Decoder(EVERY_TYPE).decode(data)
    assert pos == len(data)
    assert got == value


def _keys():
    keys = [jax_index_map.feature_key(jax_index_map.INTERCEPT_NAME, "")]
    keys += [jax_index_map.feature_key(f"f{i}", f"t{i % 4}") for i in range(50)]
    keys += ["ünïcode\x01ter m", "g\x01"]
    return keys


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_mmap_index_stores_interchangeable(tmp_path, writer, reader):
    keys = _keys()
    w_mod, r_mod = PACKAGES[writer][1], PACKAGES[reader][1]
    w_mod.build_mmap_index(w_mod.DefaultIndexMap(keys), str(tmp_path), num_partitions=3)
    imap = r_mod.MmapIndexMap(str(tmp_path))
    assert len(imap) == len(keys)
    assert imap.intercept_index == 0
    for i, k in enumerate(keys):
        name, _, term = k.partition("\x01")
        assert imap.get_index(name, term) == i
        assert imap.get_feature(i) == (name, term)
    assert imap.get_index("absent", "x") == -1


def test_mmap_index_preloaded_lookups(tmp_path, monkeypatch):
    """A preloaded small map answers point lookups from one dict of every
    key, hits and misses alike, as the store does; a map over the bound
    keeps looking up the store."""
    keys = _keys()
    port_index_map.build_mmap_index(port_index_map.DefaultIndexMap(keys),
                                    str(tmp_path), num_partitions=3)
    imap = port_index_map.MmapIndexMap(str(tmp_path))
    imap.preload()                       # every key in one dict: 52 <= 2^21
    assert len(imap._keys) == len(keys)
    for i, k in enumerate(keys + ["absent\x01x"]):
        name, _, term = k.partition("\x01")
        want = i if i < len(keys) else -1
        assert imap.get_index(name, term) == imap.index_of(k) == want
    assert imap.get_index("g", None) == imap.index_of("g\x01") == len(keys) - 1
    assert imap.intercept_index == 0
    monkeypatch.setattr(port_index_map, "_KEYS_MAX", 10)
    big = port_index_map.MmapIndexMap(str(tmp_path))
    big.preload()                        # over the bound: point lookups only
    assert big._keys is None and big.get_index("f7", "t3") == 8


def test_mmap_index_stores_byte_identical(tmp_path):
    keys = _keys()
    for name, mod in (("jax", jax_index_map), ("port", port_index_map)):
        mod.build_mmap_index(mod.DefaultIndexMap(keys), str(tmp_path / name), 2)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port"))
    for f in files:
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes(), f


def _index(tmp_path):
    d_global, n_users, d_user = 9, 6, 3
    keys = [jax_index_map.feature_key(jax_index_map.INTERCEPT_NAME, "")]
    keys += [jax_index_map.feature_key("g", str(j)) for j in range(d_global)]
    keys += [jax_index_map.feature_key("u", f"{u}_{j}")
             for u in range(n_users) for j in range(d_user)]
    jax_index_map.build_mmap_index(jax_index_map.DefaultIndexMap(keys), str(tmp_path / "index"))
    return keys, d_global, n_users, d_user


def _jax_model(dim, d_global, n_users, d_user, with_var):
    """A JAX GameModel: fixed effect + per-user RE with size-bucketed stacks
    (an intercept plus 1, 2 or 3 user columns → pow2 widths 2 and 4)."""
    rng = np.random.default_rng(3)
    means = np.where(rng.random(dim) < 0.7, rng.normal(size=dim), 0.0)
    var = np.abs(rng.normal(size=dim)) if with_var else None
    fixed = JaxFixedEffectModel(
        JaxGLM(JaxCoefficients(jnp.asarray(means, jnp.float64),
                               None if var is None else jnp.asarray(var, jnp.float64)),
               JaxTaskType.LOGISTIC_REGRESSION),
        "global",
    )
    keys, sparse, sparse_var = [], [], []
    for u in range(n_users):
        m = 1 + u % d_user
        cols = 1 + d_global + u * d_user + np.arange(m)
        cols = np.append(cols, 0)[::-1].copy()       # intercept, unsorted
        keys.append(f"user{u}")
        sparse.append((cols.astype(np.int64), rng.normal(size=len(cols))))
        sparse_var.append((cols.astype(np.int64), np.abs(rng.normal(size=len(cols))) + 0.1))
    re = jax_model_io._synthetic_random_effect_model(
        "userId", JaxTaskType.LOGISTIC_REGRESSION, keys, sparse, dim,
        sparse_var if with_var else None, dtype=jnp.float64,
    )
    return JaxGameModel({"fixed": fixed, "perUser": re})


def _flatten(model):
    """Every array of a (JAX or port) GameModel as float64/int numpy."""
    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    fe, re = model["fixed"], model["perUser"]
    out = {"means": host(fe.model.coefficients.means).astype(np.float64)}
    if fe.model.coefficients.variances is not None:
        out["variances"] = host(fe.model.coefficients.variances).astype(np.float64)
    for b in range(len(re.bucket_coefs)):
        out[f"coefs{b}"] = host(re.bucket_coefs[b]).astype(np.float64)
        out[f"proj{b}"] = host(re.bucket_proj[b])
        out[f"ids{b}"] = host(re.bucket_entity_ids[b])
        if re.bucket_variances is not None:
            out[f"var{b}"] = host(re.bucket_variances[b]).astype(np.float64)
    out["keys"] = np.asarray(re.entity_keys, object)
    out["slots"] = np.asarray(
        [(k, b, lane) for k, (b, lane) in sorted(re.entity_to_slot.items())], np.int64)
    return out


def _assert_same_model(a, b):
    fa, fb = _flatten(a), _flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _load(pkg, model_dir, imaps, dtype):
    if pkg == "jax":
        return jax_model_io.load_game_model(
            model_dir, imaps, dtype=jnp.float32 if dtype == "f32" else jnp.float64)
    return port_model_io.load_game_model(
        model_dir, imaps, dtype=torch.float32 if dtype == "f32" else torch.float64,
        device=CPU)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("with_var", [False, True], ids=["means", "variances"])
@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_model_directory_round_trips_across_packages(tmp_path, writer, reader, with_var, dtype):
    """A model saved by one package loads in the other with the same arrays
    (including the RE stacks' power-of-2 widths) as the writer's own load."""
    keys, d_global, n_users, d_user = _index(tmp_path)
    dim = len(keys)
    idx_dir = str(tmp_path / "index")
    maps = {name: {"global": PACKAGES[name][1].MmapIndexMap(idx_dir)} for name in PACKAGES}
    model_dir = str(tmp_path / "model")
    src = _jax_model(dim, d_global, n_users, d_user, with_var)
    if writer == "port":
        # put the model through the port first, so the port's writer saves it
        src, _ = port_model_io.load_game_model(
            _save_jax(src, tmp_path / "seed", maps["jax"]), maps["port"],
            dtype=torch.float64, device=CPU)
    shard_cfgs = {"global": _shard_cfg()}
    PACKAGES[writer][2].save_game_model(
        model_dir, src, maps[writer], {"fixed": "global", "perUser": "global"},
        shard_cfgs)
    got, meta = _load(reader, model_dir, maps[reader], dtype)
    want, want_meta = _load(writer, model_dir, maps[writer], dtype)
    assert meta == want_meta
    assert meta["coordinates"]["perUser"] == {
        "type": "random", "feature_shard": "global",
        "task": "LOGISTIC_REGRESSION", "re_type": "userId"}
    assert meta["feature_shards"] == {
        "global": {"feature_bags": ["features"], "add_intercept": True}}
    _assert_same_model(got, want)
    widths = sorted(c.shape[1] for c in got["perUser"].bucket_coefs)
    assert widths == [2, 4]


def _shard_cfg():
    from photon_tpu_torch.io.data_reader import FeatureShardConfig

    return FeatureShardConfig(feature_bags=("features",), add_intercept=True)


def _save_jax(model, path, maps):
    jax_model_io.save_game_model(str(path), model, maps,
                                 {"fixed": "global", "perUser": "global"})
    return str(path)


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_scores_avro_records_match(tmp_path, writer, reader):
    rng = np.random.default_rng(8)
    scores = rng.normal(size=25).astype(np.float32)
    uids = np.array([f"r{i}" for i in range(25)], object)
    labels = np.where(rng.random(25) < 0.3, np.nan, rng.random(25))
    ours = str(tmp_path / "a.avro")
    theirs = str(tmp_path / "b.avro")
    PACKAGES[writer][2].save_scores(ours, scores, uids=uids, labels=labels)
    PACKAGES[reader][2].save_scores(theirs, scores, uids=uids, labels=labels)
    a = PACKAGES[reader][0].read_records(ours)
    b = PACKAGES[writer][0].read_records(theirs)
    assert a == b
    assert [r["uid"] for r in a] == list(uids)
    assert sum(r["label"] is None for r in a) == int(np.isnan(labels).sum())


def test_port_scores_writer_takes_tensors(tmp_path):
    scores = torch.tensor([0.5, -1.25], dtype=torch.float64)
    path = str(tmp_path / "s.avro")
    port_model_io.save_scores(path, scores, uids=["a", "b"])
    recs = jax_avro.read_records(path)
    assert [r["predictionScore"] for r in recs] == [0.5, -1.25]
    assert port_model_io.default_index_root("/x/out/models/3") == "/x/out/index"
    assert port_model_io.default_index_root("/x/out/best") == "/x/out/index"


def _unicode_index(tmp_path):
    """``_index``'s keys plus a column whose name and term are not ASCII,
    as an mmap store under ``tmp_path / "index"``; returns the keys."""
    keys, d_global, n_users, d_user = _index(tmp_path)
    keys = keys + [jax_index_map.feature_key("ünï", "cödé")]
    jax_index_map.build_mmap_index(jax_index_map.DefaultIndexMap(keys),
                                   str(tmp_path / "index"))
    return keys, d_global, n_users, d_user


def _maps(kind, keys, idx_dir):
    if kind == "mmap":
        return {name: {"global": PACKAGES[name][1].MmapIndexMap(idx_dir)}
                for name in PACKAGES}
    return {name: {"global": PACKAGES[name][1].DefaultIndexMap(keys)}
            for name in PACKAGES}


@pytest.mark.parametrize("kind", ["mmap", "dict"])
@pytest.mark.parametrize("with_var", [False, True], ids=["means", "variances"])
def test_port_model_files_equal_jax_byte_for_byte(tmp_path, monkeypatch, with_var, kind):
    """The port writes a model's records as bytes it encodes itself; given
    the same sync marker, its files equal the JAX package's byte for byte
    (zero coefficients skipped, a non-ASCII name and term)."""
    keys, d_global, n_users, d_user = _unicode_index(tmp_path)
    maps = _maps(kind, keys, str(tmp_path / "index"))
    src = _jax_model(len(keys), d_global, n_users, d_user, with_var)
    seed = _save_jax(src, tmp_path / "seed", maps["jax"])
    port_src, _ = port_model_io.load_game_model(seed, maps["port"],
                                                dtype=torch.float64, device=CPU)
    monkeypatch.setattr(os, "urandom", lambda n: bytes(range(n)))
    _save_jax(src, tmp_path / "jax", maps["jax"])
    port_model_io.save_game_model(str(tmp_path / "port"), port_src, maps["port"],
                                  {"fixed": "global", "perUser": "global"})
    files = [os.path.join(d, f)[len(str(tmp_path / "jax")) + 1:]
             for d, _, fs in os.walk(tmp_path / "jax") for f in fs]
    assert sorted(files) == sorted(
        os.path.join(d, f)[len(str(tmp_path / "port")) + 1:]
        for d, _, fs in os.walk(tmp_path / "port") for f in fs)
    assert any(f.endswith(".avro") for f in files)
    for f in files:
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes(), f


@pytest.mark.parametrize("with_var", [False, True], ids=["means", "variances"])
def test_port_model_load_paths_agree(tmp_path, with_var):
    """The port decodes its own model files in bulk through an mmap index's
    key bytes; a map without bulk keys, and a file whose writer schema is
    another (read record by record), load the same arrays. A coefficient
    that is NaN is not written, and a key the index lacks is dropped."""
    keys, d_global, n_users, d_user = _unicode_index(tmp_path)
    maps = _maps("mmap", keys, str(tmp_path / "index"))
    src = _jax_model(len(keys), d_global, n_users, d_user, with_var)
    model, _ = port_model_io.load_game_model(
        _save_jax(src, tmp_path / "seed", maps["jax"]), maps["port"],
        dtype=torch.float64, device=CPU)
    model["fixed"].model.coefficients.means[3] = float("nan")
    mdir = str(tmp_path / "model")
    port_model_io.save_game_model(mdir, model, maps["port"],
                                  {"fixed": "global", "perUser": "global"})
    fast, _ = _load("port", mdir, maps["port"], "f64")
    assert not torch.isnan(fast["fixed"].model.coefficients.means).any()
    assert fast["fixed"].model.coefficients.means[3] == 0.0
    fallback, _ = _load("port", mdir, {"global": port_index_map.DefaultIndexMap(keys)},
                        "f64")
    _assert_same_model(fast, fallback)

    # another writer schema (a "doc" attribute): read record by record
    from photon_tpu_torch.io.schemas import BAYESIAN_LINEAR_MODEL_AVRO

    other = dict(BAYESIAN_LINEAR_MODEL_AVRO, doc="written elsewhere")
    for sub in ("fixed-effect/fixed/coefficients.avro",
                "random-effect/perUser/part-00000.avro"):
        path = os.path.join(mdir, sub)
        recs = port_avro.read_records(path)
        port_avro.write_container(path, other, recs)
    foreign, _ = _load("port", mdir, maps["port"], "f64")
    _assert_same_model(fast, foreign)

    # a smaller index: the dropped column's keys are skipped on both paths
    small = str(tmp_path / "small")
    port_index_map.build_mmap_index(port_index_map.DefaultIndexMap(keys[:-4]), small)
    port_model_io.save_game_model(mdir, model, maps["port"],
                                  {"fixed": "global", "perUser": "global"})
    cut_fast, _ = _load("port", mdir, {"global": port_index_map.MmapIndexMap(small)},
                        "f64")
    cut_slow, _ = _load("port", mdir, {"global": port_index_map.DefaultIndexMap(keys[:-4])},
                        "f64")
    _assert_same_model(cut_fast, cut_slow)
    assert cut_fast["fixed"].model.coefficients.means.shape[0] == len(keys) - 4
