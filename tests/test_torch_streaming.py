"""The port's streaming ingest (``io/streaming.py``, ``native/``,
``io/parallel_ingest.py``) against the JAX package's streaming reader and
the port's per-record reader.

On the same files (two containers, deflate and null codecs, small blocks;
unindexed features, null offsets / weights / uids, entity ids from a
top-level field or the ``metadataMap``), the port's ``StreamingAvroReader
.read`` gives labels, offsets, weights, uids, tags and ELL arrays bit-equal
to JAX's ``StreamingAvroReader.read`` and to the port's own
``read_per_record``; ``collect_feature_keys`` gives JAX's index. Then the
cases of ``tests/test_streaming.py``: two shards over one bag, ``file_shard``,
chunked iteration and ``split``, unlabeled scoring reads, an empty file, an
``Unsupported`` schema that falls back, no native library, truncated and
corrupted blocks and a clobbered sync marker, and ``read_parallel`` with two
worker processes against the in-process read.
"""
import numpy as np
import pytest
import torch

from photon_tpu.index.index_map import DefaultIndexMap as JaxIndexMap
from photon_tpu.io.data_reader import FeatureShardConfig as JaxShardConfig
from photon_tpu.io.streaming import StreamingAvroReader as JaxStreamingReader
from photon_tpu.io.streaming import collect_feature_keys as jax_collect
from photon_tpu_torch import native
from photon_tpu_torch.index.index_map import (
    INTERCEPT_NAME,
    DefaultIndexMap,
    feature_key,
)
from photon_tpu_torch.io import streaming
from photon_tpu_torch.io.avro import SchemaError, write_container
from photon_tpu_torch.io.data_reader import (
    AvroDataReader,
    FeatureShardConfig,
    build_index_from_avro,
)
from photon_tpu_torch.io.parallel_ingest import read_parallel
from photon_tpu_torch.io.streaming import (
    StreamingAvroReader,
    Unsupported,
    collect_feature_keys,
    ell_from_triples,
)

CPU = torch.device("cpu")

SCHEMA = {
    "type": "record", "name": "TrainingExampleAvro", "fields": [
        {"name": "uid", "type": ["null", "string"]},
        {"name": "label", "type": ["null", "double"]},
        {"name": "offset", "type": ["null", "double"]},
        {"name": "weight", "type": ["null", "double"]},
        {"name": "junk", "type": {"type": "array", "items": "long"}},
        {"name": "features", "type": {"type": "array", "items": {
            "type": "record", "name": "FeatureAvro", "fields": [
                {"name": "name", "type": "string"},
                {"name": "term", "type": ["null", "string"]},
                {"name": "value", "type": "double"},
            ]}}},
        {"name": "userId", "type": ["null", "string"]},
        {"name": "metadataMap",
         "type": ["null", {"type": "map", "values": ["null", "string"]}]},
    ],
}


def make_records(rng, n=800):
    """``tests/test_streaming.py``'s generator."""
    feat_names = [(f"f{i}", f"t{i % 3}" if i % 4 else None) for i in range(50)]
    records = []
    for i in range(n):
        feats = [{"name": nm, "term": tm, "value": float(rng.normal())}
                 for nm, tm in (feat_names[j] for j in
                                rng.integers(0, 50, rng.integers(1, 9)))]
        if i % 7 == 0:
            feats.append({"name": "UNKNOWN", "term": None, "value": 9.0})
        records.append({
            "uid": f"u{i}" if i % 5 else None,
            "label": float(i % 2),
            "offset": 0.25 * i if i % 3 else None,
            "weight": 2.0 if i % 11 == 0 else None,
            "junk": [i, i + 1],
            "features": feats,
            "userId": f"user{i % 13}" if i % 2 else None,
            "metadataMap": {"userId": f"user{i % 13}", "x": None},
        })
    return feat_names, records


def index_keys(feat_names):
    return [feature_key(INTERCEPT_NAME, "")] + [feature_key(a, b)
                                                for a, b in feat_names]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_streaming")
    feat_names, records = make_records(np.random.default_rng(42))
    p1, p2 = str(d / "a.avro"), str(d / "b.avro")
    write_container(p1, SCHEMA, records[:500], codec="deflate", block_records=64)
    write_container(p2, SCHEMA, records[500:], codec="null", block_records=64)
    return index_keys(feat_names), [p1, p2], records


def assert_bundles_equal(got, want):
    """Bit-equal row columns, tags and ELL arrays; ``want`` may be a JAX
    bundle."""
    for f in ("labels", "offsets", "weights"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert list(got.uids) == [str(u) for u in want.uids]
    assert set(got.id_tags) == set(want.id_tags)
    for t in got.id_tags:
        assert list(got.id_tags[t]) == list(want.id_tags[t])
    assert set(got.features) == set(want.features)
    for s, g in got.features.items():
        w = want.features[s]
        gi, gv = g.idx.numpy(), g.val.numpy()
        wi, wv = np.asarray(w.idx), np.asarray(w.val)
        assert g.dim == w.dim and gi.dtype == wi.dtype and gv.dtype == wv.dtype
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_streaming_read_equals_jax_and_per_record(dataset, dtype):
    keys, paths, _ = dataset
    reader = AvroDataReader({"g": DefaultIndexMap(keys)},
                            id_tag_columns=("userId",))
    got = reader.read(paths, dtype=getattr(torch, dtype), device=CPU)
    assert reader.last_reader == "native"
    jax_got = JaxStreamingReader({"g": JaxIndexMap(keys)},
                                 id_tag_columns=("userId",)).read(
        paths, dtype=np.dtype(dtype))
    assert_bundles_equal(got, jax_got)
    assert_bundles_equal(got, reader.read_per_record(
        paths, dtype=getattr(torch, dtype), device=CPU))


def test_two_shards_one_bag(dataset):
    keys, paths, _ = dataset
    maps = {"g": DefaultIndexMap(keys), "sub": DefaultIndexMap(keys[:20])}
    cfgs = {"g": FeatureShardConfig(), "sub": FeatureShardConfig(add_intercept=False)}
    reader = AvroDataReader(maps, cfgs)
    assert_bundles_equal(
        reader.read(paths, dtype=torch.float32, device=CPU),
        reader.read_per_record(paths, dtype=torch.float32, device=CPU))


def test_collect_feature_keys_equal_jax_and_per_record(dataset, monkeypatch):
    keys, paths, _ = dataset
    cfg = {"g": FeatureShardConfig(("features",))}
    got = collect_feature_keys(paths, cfg)
    assert got["g"] == jax_collect(paths, {"g": JaxShardConfig(("features",))})["g"]
    assert collect_feature_keys(paths, cfg, file_shard=(1, 2))["g"] == \
        collect_feature_keys(paths[1], cfg)["g"]
    assert collect_feature_keys(paths, cfg, reset_every_rows=64)["g"] == got["g"]
    native_map = build_index_from_avro(paths)
    monkeypatch.setattr(streaming, "collect_feature_keys",
                        lambda *a, **k: (_ for _ in ()).throw(Unsupported("forced")))
    fallback = build_index_from_avro(paths)
    assert native_map.keys_in_order == fallback.keys_in_order


def test_chunks_file_shard_and_split(dataset):
    keys, paths, records = dataset
    sr = StreamingAvroReader({"g": DefaultIndexMap(keys)},
                             id_tag_columns=("userId",), chunk_rows=100)
    chunks = list(sr.iter_chunks(paths))
    assert len(chunks) > 2 and sum(c.n_rows for c in chunks) == len(records)
    np.testing.assert_array_equal(np.concatenate([c.labels for c in chunks]),
                                  [r["label"] for r in records])
    tags = np.concatenate([c.id_tags["userId"].materialize() for c in chunks])
    assert list(tags) == [f"user{i % 13}" for i in range(len(records))]
    whole = StreamingAvroReader({"g": DefaultIndexMap(keys)},
                                id_tag_columns=("userId",))
    assert [sum(c.n_rows for c in whole.iter_chunks(paths, file_shard=(i, 2)))
            for i in (0, 1)] == [500, 300]
    [chunk] = list(whole.iter_chunks(paths[1]))
    parts = chunk.split(3)
    np.testing.assert_array_equal(np.concatenate([p.labels for p in parts]),
                                  chunk.labels)
    np.testing.assert_array_equal(
        np.concatenate([p.features["g"].idx for p in parts]),
        chunk.features["g"].idx)


def test_ell_from_triples():
    sf = ell_from_triples(rows=np.array([0, 0, 2]), idx=np.array([3, 1, 0]),
                          vals=np.array([1.0, 2.0, 3.0]), n_rows=3, dim=5,
                          intercept_index=4)
    np.testing.assert_array_equal(sf.idx, [[4, 3, 1], [4, 5, 5], [4, 0, 5]])
    np.testing.assert_array_equal(sf.val, [[1, 1, 2], [1, 0, 0], [1, 3, 0]])
    empty = ell_from_triples(np.zeros(0, np.int64), np.zeros(0, np.int64),
                             np.zeros(0), n_rows=0, dim=5)
    assert empty.idx.shape == (0, 1)


def test_unlabeled_empty_and_unsupported(tmp_path):
    rng = np.random.default_rng(3)
    feat_names, records = make_records(rng, n=40)
    for r in records:
        r["label"] = None
    p = str(tmp_path / "u.avro")
    write_container(p, SCHEMA, records)
    reader = AvroDataReader({"g": DefaultIndexMap(index_keys(feat_names))})
    with pytest.raises(ValueError):
        reader.read(p, dtype=torch.float32, device=CPU)
    bundle = reader.read(p, dtype=torch.float32, device=CPU, require_labels=False)
    assert np.isnan(bundle.labels).all() and reader.last_reader == "native"

    e = str(tmp_path / "e.avro")
    write_container(e, SCHEMA, [])
    empty = AvroDataReader({"g": DefaultIndexMap(index_keys([]))}).read(
        e, dtype=torch.float32, device=CPU, require_labels=False)
    assert empty.n_rows == 0 and empty.features["g"].idx.shape[0] == 0

    odd = {"type": "record", "name": "Odd", "fields": [
        {"name": "response", "type": "double"},
        {"name": "features", "type": {"type": "array",
                                      "items": {"type": "map", "values": "double"}}}]}
    o = str(tmp_path / "odd.avro")
    write_container(o, odd, [{"response": 1.0, "features": []},
                             {"response": 0.0, "features": []}])
    imap = DefaultIndexMap(index_keys([]))
    with pytest.raises(Unsupported):
        list(StreamingAvroReader({"g": imap}).iter_chunks(o))
    reader = AvroDataReader({"g": imap})
    np.testing.assert_array_equal(
        reader.read(o, dtype=torch.float32, device=CPU).labels, [1.0, 0.0])
    assert reader.last_reader == "per_record"


def test_no_native_library_falls_back(dataset, monkeypatch):
    keys, paths, _ = dataset
    monkeypatch.setattr(native, "get_lib", lambda: None)
    reader = AvroDataReader({"g": DefaultIndexMap(keys)})
    assert reader.read(paths, dtype=torch.float32, device=CPU).n_rows == 800
    assert reader.last_reader == "per_record"


def test_truncated_and_corrupted_blocks(tmp_path):
    """Corruption surfaces as an error (bounds-checked decode); a truncation
    that still decodes is an exact prefix of the clean read."""
    rng = np.random.default_rng(5)
    feat_names, records = make_records(rng, n=120)
    path = str(tmp_path / "x.avro")
    write_container(path, SCHEMA, records, block_records=40)
    sr = StreamingAvroReader({"g": DefaultIndexMap(index_keys(feat_names))},
                             id_tag_columns=("userId",))
    clean = sr.read(path, CPU)
    raw = open(path, "rb").read()
    failures = 0
    rng2 = np.random.default_rng(7)
    for trial in range(30):
        mutated = bytearray(raw)
        kind = trial % 3
        if kind == 0:
            mutated = mutated[:int(rng2.integers(len(raw) // 4, len(raw)))]
        elif kind == 1:
            for _ in range(4):
                mutated[int(rng2.integers(len(raw) // 4, len(raw)))] ^= int(
                    rng2.integers(1, 256))
        else:
            i = int(rng2.integers(len(raw) // 4, len(raw)))
            mutated[i:i] = bytes(rng2.integers(0, 256, 16, dtype=np.uint8))
        bad = tmp_path / f"bad{trial}.avro"
        bad.write_bytes(bytes(mutated))
        fresh = StreamingAvroReader({"g": DefaultIndexMap(index_keys(feat_names))},
                                    id_tag_columns=("userId",))
        try:
            bundle = fresh.read(str(bad), CPU)
        except (SchemaError, ValueError, UnicodeDecodeError):
            failures += 1
            continue
        n = bundle.n_rows
        assert n <= clean.n_rows
        if kind == 0:
            np.testing.assert_array_equal(bundle.labels, clean.labels[:n])
    assert failures > 5
    sync = bytearray(raw)
    sync[-8] ^= 0xFF
    (tmp_path / "badsync.avro").write_bytes(bytes(sync))
    with pytest.raises(SchemaError):
        sr.read(str(tmp_path / "badsync.avro"), CPU)


def test_read_parallel_equals_in_process(dataset):
    keys, paths, _ = dataset
    maps = {"g": DefaultIndexMap(keys)}
    cfgs = {"g": FeatureShardConfig()}
    want = StreamingAvroReader(maps, cfgs, id_tag_columns=("userId",)).read(paths, CPU)
    got = read_parallel(paths, maps, cfgs, CPU, id_tag_columns=("userId",),
                        n_workers=2)
    assert_bundles_equal(got, want)
