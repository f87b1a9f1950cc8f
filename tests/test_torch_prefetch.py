"""The port's pipelined ingest (``io/prefetch.py``) and device sweep cache
(``data/device_cache.py``).

* ``prefetch`` keeps order and content, bounds how far the producer runs
  ahead, re-raises the producer's error in order and stops the producer
  when the consumer abandons it; ``pipelined_puts`` keeps one put in flight
  (``tests/test_prefetch.py``'s cases).
* ``read_bundle_pipelined`` (prefetched decode into ``chunks_to_bundle``)
  is bit-identical to the port's ``StreamingAvroReader.read`` and to JAX's
  ``read_bundle_pipelined``, in process and with two worker processes;
  ``iter_chunks_pipelined`` with a device hands over each chunk of
  ``iter_chunks`` with its features on that device. On the card (``cuda``
  marker) the copies of both go through page-locked staging buffers on a
  copy stream.
* The sweep cache's hits, misses, budget spill (counted once per key),
  discard, disabled budget and the identity of a dataset's mirror; a GAME
  fit over host-resident random-effect buckets is bit-identical with the
  cache on and off, and its second sweep uploads nothing with the cache on.
"""
import threading
import time

import numpy as np
import pytest
import torch

from photon_tpu.index.index_map import DefaultIndexMap as JaxIndexMap
from photon_tpu.io.data_reader import FeatureShardConfig as JaxShardConfig
from photon_tpu.io.data_reader import InputColumnNames as JaxColumns
from photon_tpu.io.prefetch import read_bundle_pipelined as jax_read_pipelined
from photon_tpu_torch.data import random_effect as tre_data
from photon_tpu_torch.data.device_cache import DeviceSweepCache
from photon_tpu_torch.data.random_effect import build_random_effect_dataset
from photon_tpu_torch.index.index_map import DefaultIndexMap
from photon_tpu_torch.io.data_reader import FeatureShardConfig, InputColumnNames
from photon_tpu_torch.io.prefetch import (
    PinnedStaging,
    iter_chunks_pipelined,
    pipelined_puts,
    prefetch,
    read_bundle_pipelined,
)
from photon_tpu_torch.io.streaming import StreamingAvroReader
from test_torch_checkpoint import (
    assert_same_fits,
    configs,
    estimator,
    game_arrays,
    torch_bundle,
)
from test_torch_streaming import assert_bundles_equal, dataset  # noqa: F401
from test_torch_jax_decoder import jax_decoder  # noqa: F401

CPU = torch.device("cpu")


def test_prefetch_order_and_disabled_path():
    items = list(range(57))
    assert list(prefetch(iter(items), depth=3)) == items
    assert list(prefetch(iter(items), depth=0)) == items


def test_prefetch_backpressure():
    produced = []

    def gen():
        for i in range(50):
            produced.append(i)
            yield i

    it = prefetch(gen(), depth=2)
    assert next(it) == 0
    time.sleep(0.2)
    assert len(produced) <= 1 + 2 + 2
    assert list(it) == list(range(1, 50))


def test_prefetch_error_in_order():
    def gen():
        yield 1
        yield 2
        raise OSError("stream died")

    it = prefetch(gen(), depth=4)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(OSError, match="stream died"):
        next(it)


def test_prefetch_abandoned_consumer_stops_producer():
    state = {"n": 0}

    def gen():
        while True:
            state["n"] += 1
            yield state["n"]

    it = prefetch(gen(), depth=2)
    assert next(it) == 1
    it.close()
    n_after = state["n"]
    time.sleep(0.2)
    assert state["n"] == n_after
    assert threading.active_count() < 50


def test_pipelined_puts_keeps_one_in_flight():
    calls = []

    def put(x):
        calls.append(x)
        return x * 10

    out = [(y, len(calls)) for y in pipelined_puts(iter(range(5)), put, ahead=1)]
    assert [y for y, _ in out] == [0, 10, 20, 30, 40]
    assert [c for _, c in out] == [2, 3, 4, 5, 5]


@pytest.mark.parametrize("workers", [0, 2])
def test_read_bundle_pipelined_bit_identical(dataset, workers):  # noqa: F811
    keys, paths, _ = dataset
    maps, cfgs = {"g": DefaultIndexMap(keys)}, {"g": FeatureShardConfig()}
    want = StreamingAvroReader(maps, cfgs, id_tag_columns=("userId",)).read(
        paths, CPU)
    got = read_bundle_pipelined(maps, cfgs, InputColumnNames(), ("userId",),
                                paths, CPU, depth=2, workers=workers,
                                capture_uids=True, chunk_rows=100)
    assert_bundles_equal(got, want)
    jax_got = jax_read_pipelined({"g": JaxIndexMap(keys)},
                                 {"g": JaxShardConfig()}, JaxColumns(),
                                 ("userId",), paths, capture_uids=True,
                                 chunk_rows=100)
    assert_bundles_equal(got, jax_got)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the pinned copy stream has no CPU mode")
    return torch.device("cuda")


def _assert_chunks_put(got, want, device):
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.labels, w.labels)
        for s, sf in w.features.items():
            gf = g.features[s]
            assert gf.idx.device.type == device.type and gf.dim == sf.dim
            np.testing.assert_array_equal(gf.idx.cpu().numpy(), sf.idx)
            np.testing.assert_array_equal(gf.val.cpu().numpy(), sf.val)


def test_iter_chunks_pipelined_puts_each_chunk(dataset):  # noqa: F811
    keys, paths, _ = dataset
    reader = StreamingAvroReader({"g": DefaultIndexMap(keys)},
                                 {"g": FeatureShardConfig()}, chunk_rows=100)
    want = list(reader.iter_chunks(paths))
    got = list(iter_chunks_pipelined(reader, paths, depth=2, device=CPU))
    _assert_chunks_put(got, want, CPU)


@pytest.mark.cuda
def test_pinned_staging_read_on_card(dataset, cuda_device):  # noqa: F811
    keys, paths, _ = dataset
    maps, cfgs = {"g": DefaultIndexMap(keys)}, {"g": FeatureShardConfig()}
    want = StreamingAvroReader(maps, cfgs, id_tag_columns=("userId",)).read(
        paths, CPU)
    staging = PinnedStaging(cuda_device, slots=1)   # its one slot reused
    got = read_bundle_pipelined(maps, cfgs, InputColumnNames(), ("userId",),
                                paths, cuda_device, capture_uids=True,
                                chunk_rows=50, staging=staging)
    assert got.features["g"].idx.is_cuda
    assert staging.copies == 2 and staging.bytes > 0
    assert all(held[0].is_pinned() for held in staging._ring if held)
    for s in got.features:
        got.features[s] = type(got.features[s])(
            idx=got.features[s].idx.cpu(), val=got.features[s].val.cpu(),
            dim=got.features[s].dim)
    assert_bundles_equal(got, want)
    # chunk by chunk, one put in flight: the ring's slots reused many times
    reader = StreamingAvroReader(maps, cfgs, chunk_rows=50)
    staging = PinnedStaging(cuda_device, slots=3)
    chunks = list(iter_chunks_pipelined(reader, paths, device=cuda_device,
                                        staging=staging))
    assert staging.copies == 2 * len(chunks) > 6
    _assert_chunks_put(chunks, list(reader.iter_chunks(paths)), cuda_device)


def _cache_put(cache, key, a):
    return cache.get_or_put(key, a.nbytes, lambda: torch.from_numpy(a.copy()),
                            retain=a)


def test_sweep_cache_hit_miss_spill_discard():
    cache = DeviceSweepCache(budget_bytes=1000)
    a, big = np.ones(100, np.float32), np.ones(1000, np.float32)
    assert _cache_put(cache, ("a",), a) is _cache_put(cache, ("a",), a)
    assert (cache.hits, cache.misses) == (1, 1)
    s1, s2 = _cache_put(cache, ("big",), big), _cache_put(cache, ("big",), big)
    assert s1 is not s2 and torch.equal(s1, torch.from_numpy(big))
    for _ in range(3):
        _cache_put(cache, ("big",), big)
    assert cache.spilled_bytes == big.nbytes      # counted once per key
    assert cache.stats() == {"budget_bytes": 1000, "resident_bytes": 400,
                             "spilled_bytes": 4000, "entries": 1}
    cache.discard(("a",))
    cache.discard(("missing",))
    assert cache.stats()["entries"] == 0 and cache.resident_bytes == 0
    cache.release()
    assert cache.spilled_bytes == 0
    off = DeviceSweepCache(budget_bytes=0)
    assert not off.enabled
    _cache_put(off, ("k",), a)
    assert off.stats()["entries"] == 0


def _host_dataset(n=60, k=4, dim=30, users=6, seed=1):
    rng = np.random.default_rng(seed)
    return build_random_effect_dataset(
        "userId", np.array([f"u{i % users}" for i in range(n)], object),
        rng.integers(0, dim, size=(n, k)).astype(np.int32),
        rng.normal(size=(n, k)).astype(np.float32),
        (rng.random(n) < 0.5).astype(np.float32), dim,
        dtype=torch.float32, device=CPU, host_resident=True)


def test_sweep_cache_dataset_mirror_identity():
    ds = _host_dataset()
    cache = DeviceSweepCache()
    m1 = cache.dataset_mirror(ds)
    assert m1 is cache.dataset_mirror(ds) and not m1.host_resident
    assert (cache.hits, cache.misses) == (1, 1)
    for bh, bd in zip(ds.buckets, m1.buckets):
        assert torch.equal(bh.proj, bd.proj)
    tiny = DeviceSweepCache(budget_bytes=8)
    assert tiny.dataset_mirror(ds) is ds and tiny.dataset_mirror(ds) is ds
    assert tiny.hits == 0 and tiny.misses == 2     # a spilled mirror never hits
    assert DeviceSweepCache(budget_bytes=0).dataset_mirror(ds) is ds


def test_fit_with_sweep_cache_matches_without():
    """Host-resident random-effect buckets: the fit is bit-identical with
    the cache on and off; with it on, only the first touch uploads."""
    a, v = game_arrays(), game_arrays(seed=1)
    fits, uploads = {}, {}
    for mb in (2048, 0):
        tre_data.reset_uploads()
        fits[mb] = estimator(host_resident=True, sweep_cache_mb=mb).fit(
            torch_bundle(a), torch_bundle(v), configs())
        uploads[mb] = dict(tre_data.UPLOADS)
    assert_same_fits(fits[2048], fits[0])
    # cache off: the training dataset uploads on every train and score
    # (the validation dataset is host-resident too and uploads per step)
    assert uploads[0]["buckets"] > uploads[2048]["buckets"]
    ref = estimator().fit(torch_bundle(a), torch_bundle(v), configs())
    assert_same_fits(fits[2048], ref)
