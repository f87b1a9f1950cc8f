"""Bfloat16 feature values: the four kernels' bf16 forms, ``with_value_dtype``,
the host-side bf16 feed and the GAME driver's ``--bf16-feed``, against the
JAX package.

Tolerances:
* the port's plain bf16 passes against JAX's ``matvec_fast`` /
  ``rmatvec_fast`` on ``with_value_dtype(jnp.bfloat16)`` data: the atol of
  ``tests/test_torch_sparse.py`` (5e-5), both sides reading the same
  rounded values;
* bf16 against f32 on the upcast values, plain on the CPU and the kernels
  on the card (tests marked ``cuda``): bit-equal;
* ``host_feed_array`` against JAX's: bit-equal on float32 and float64
  inputs, values on a float32 or a bfloat16 rounding tie included;
* the GAME driver with ``--bf16-feed``, on values bfloat16 holds exactly:
  bit-equal to the port's float32 fit, within 1e-4 (relative above 1) of
  the JAX driver's float32 fit (float32 solves capped at 8 iterations: the
  same iterations, the last ulps differ); the port's model and the JAX
  driver's ``--bf16-feed`` model scored by the other package's scoring
  driver as by their own, to 1e-5.
"""
from __future__ import annotations

import json

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu.cli import game_scoring_driver as jax_scoring
from photon_tpu.cli import game_training_driver as jax_training
from photon_tpu.data.batch import SparseFeatures as JaxSparse
from photon_tpu.io.avro import read_records
from photon_tpu.io.prefetch import host_feed_array as jax_host_feed
from photon_tpu_torch.cli import game_scoring_driver, game_training_driver
from photon_tpu_torch.data.batch import LabeledBatch, LaneFeatures, SparseFeatures
from photon_tpu_torch.estimators.config import RandomEffectDataConfig
from photon_tpu_torch.estimators.game_estimator import build_re_dataset_from_bundle
from photon_tpu_torch.io.data_reader import GameDataBundle
from photon_tpu_torch.io.prefetch import host_feed_array
from photon_tpu_torch.ops import cuda_sparse as cs
from test_torch_jax_decoder import jax_decoder  # noqa: F401
from test_torch_scoring_driver import _write_game_avro
from test_torch_sparse import ATOL_F32, _case, _ell_card_case, _random_ell, _t

CPU = torch.device("cpu")
BF16_CASES = ["300x200x4", "1000x700x6", "hot_dup", "long_col", "empty_runs"]


def _bf16_case(name):
    """The grid case with its values rounded to bfloat16 (as float32)."""
    idx, val, d, w, dz = _case(name)
    return idx, val.astype(ml_dtypes.bfloat16).astype(np.float32), d, w, dz


@pytest.mark.parametrize("name", BF16_CASES)
def test_bf16_plain_passes_match_jax_fast_path(name):
    idx, val, d, w, dz = _case(name)
    jf = JaxSparse(jnp.asarray(idx), jnp.asarray(val), d).with_fast_path() \
        .with_value_dtype(jnp.bfloat16)
    assert jf.fast is not None and jf.val.dtype == jnp.bfloat16
    refs = (np.asarray(jf.matvec(jnp.asarray(w))),
            np.asarray(jf.rmatvec(jnp.asarray(dz))),
            np.asarray(jf.sq_rmatvec(jnp.asarray(dz))))
    sf = SparseFeatures(_t(idx), _t(val), d).with_value_dtype(torch.bfloat16)
    assert sf.val.dtype == torch.bfloat16 and sf.dtype == torch.float32
    got = (sf.matvec(_t(w)), sf.rmatvec(_t(dz)), sf.sq_rmatvec(_t(dz)))
    for g, r in zip(got, refs):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=ATOL_F32)


@pytest.mark.parametrize("name", BF16_CASES)
def test_bf16_plain_is_f32_plain_on_upcast_values(name):
    idx, val, d, w, dz = _case(name)
    vb = _t(val).to(torch.bfloat16)
    up = vb.float()
    i, wt, dzt = _t(idx), _t(w), _t(dz)
    assert torch.equal(cs.ell_matvec(i, vb, wt, d), cs.ell_matvec(i, up, wt, d))
    for square in (False, True):
        assert torch.equal(cs.ell_rmatvec_plain(i, vb, dzt, d, square),
                           cs.ell_rmatvec_plain(i, up, dzt, d, square))
        assert torch.equal(cs.csc_rmatvec(cs.build_csc(i, vb, d), dzt, square),
                           cs.csc_rmatvec(cs.build_csc(i, up, d), dzt, square))
    n = idx.shape[0]
    lb = cs.panel_layout(i, vb, d, cs.tile_rows_for(n), cs.panel_cols(vb.dtype))
    lf = cs.panel_layout(i, up, d, cs.tile_rows_for(n), cs.panel_cols(up.dtype))
    assert lb.vals.dtype == torch.bfloat16
    assert torch.equal(lb.codes, lf.codes) and torch.equal(lb.vals.float(), lf.vals)
    assert torch.equal(cs.ell_panel_matvec(lb, wt), cs.ell_panel_matvec(lf, wt))


def test_with_value_dtype_casts_attached_layouts_and_keeps_f32_vectors():
    idx, val, d, _, _ = _case("1000x700x6")
    i, v = _t(idx), _t(val)
    sf = SparseFeatures(i, v, d, panels=cs.panel_layout(i, v, d, 1024, 16384),
                        csc=cs.build_csc(i, v, d))
    for spec in (torch.bfloat16, "bfloat16"):
        nb = sf.with_value_dtype(spec)
        assert nb.val.dtype == nb.panels.vals.dtype == nb.csc.vals.dtype == torch.bfloat16
        assert nb.dtype == torch.float32
        assert torch.equal(nb.csc.rows, sf.csc.rows)
        assert nb.with_value_dtype("bfloat16") is nb
    assert sf.with_value_dtype(torch.float32) is sf
    with pytest.raises(TypeError, match="bfloat16"):
        SparseFeatures(i, v.double(), d).with_value_dtype("bfloat16")
    # the bundle's row columns follow the compute dtype, not the storage
    bundle = GameDataBundle(features={"g": sf.with_value_dtype("bfloat16")},
                            labels=np.ones(len(idx)), offsets=np.zeros(len(idx)),
                            weights=np.ones(len(idx)), uids=np.zeros(0, object),
                            id_tags={})
    b = bundle.batch("g")
    assert b.labels.dtype == b.weights.dtype == torch.float32


def test_accelerator_paths_do_not_narrow_on_cpu(monkeypatch):
    """PHOTON_VALUE_DTYPE acts where the layouts attach: on CUDA, as the
    JAX package narrows only on its accelerators."""
    monkeypatch.setenv("PHOTON_VALUE_DTYPE", "bfloat16")
    idx, val, d, _, _ = _case("300x200x4")
    sf = SparseFeatures(_t(idx), _t(val), d)
    assert sf.with_accelerator_paths() is sf


@pytest.mark.parametrize("mix", ["bf16_f64", "f32_bf16", "f64_f32", "f16"])
def test_kernel_wrappers_refuse_other_dtype_mixes(mix):
    idx, val, d, w, dz = _case("300x200x4")
    i = _t(idx)
    vt, wt = {"bf16_f64": (torch.bfloat16, torch.float64),
              "f32_bf16": (torch.float32, torch.bfloat16),
              "f64_f32": (torch.float64, torch.float32),
              "f16": (torch.float16, torch.float32)}[mix]
    v, wv, dzv = _t(val).to(vt), _t(w).to(wt), _t(dz).to(wt)
    with pytest.raises(TypeError):
        cs.ell_matvec(i, v, wv, d)
    if vt != torch.float16:
        with pytest.raises(TypeError):
            cs.csc_rmatvec(cs.build_csc(i, v, d), dzv)


@pytest.mark.parametrize("k", [1, 3, 4, 6, 8, 17, 32, 33, 400])
def test_bf16_tile_plan_keeps_value_runs_16_byte_aligned(k):
    plan = cs.ell_tile_plan(k, torch.bfloat16)
    f32 = cs.ell_tile_plan(k, torch.float32)
    assert plan.group == f32.group          # the same summation order
    if plan.tile_rows > 1:
        assert plan.tile_rows * k * 2 % 16 == 0
        assert plan.tile_rows * k <= plan.stage
    assert cs.ell_smem_bytes(torch.bfloat16, plan.stage) <= cs.ELL_SMEM_LIMIT


def _ties(dtype):
    """Values on bfloat16 ties and, for float64, on float32 ties that a
    direct rounding to bfloat16 would break the other way."""
    base = np.array([1.0, -1.0, 3.0, 1024.0, 2.0 ** -20], np.float64)
    out = [base * (1 + 2.0 ** -8), base * (1 + 3 * 2.0 ** -8), base,
           np.array([0.0, -0.0, np.inf, -np.inf, 65504.0])]
    if dtype == np.float64:
        out += [base * (1 + 2.0 ** -8 + 2.0 ** -40), base * (1 + 2.0 ** -8 - 2.0 ** -40)]
    rng = np.random.default_rng(5)
    out.append(rng.normal(size=400) * 10.0 ** rng.integers(-5, 5, 400))
    return np.concatenate(out).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_host_feed_array_is_bit_equal_to_jax(dtype):
    a = _ties(dtype).reshape(-1, 5)
    got = host_feed_array(a, "bfloat16")
    want = np.asarray(jax_host_feed(a, "bfloat16"))
    assert got.dtype == torch.bfloat16 and got.shape == a.shape
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                  want.view(np.uint16))
    assert host_feed_array(a, None) is a
    with pytest.raises(ValueError, match="bfloat16"):
        host_feed_array(a, np.dtype(dtype).name)


def test_re_buckets_of_a_bf16_bundle_are_float32():
    rng = np.random.default_rng(3)
    n, d = 60, 12
    idx, val = _random_ell(rng, n, d, 4, ghost_frac=0.1)
    sf = SparseFeatures(_t(idx), _t(val), d).with_value_dtype("bfloat16")
    bundle = GameDataBundle(features={"g": sf}, labels=(rng.random(n) < .5) * 1.0,
                            offsets=np.zeros(n), weights=np.ones(n),
                            uids=np.zeros(0, object),
                            id_tags={"userId": np.array([f"u{i % 5}" for i in range(n)],
                                                        object)})
    ds = build_re_dataset_from_bundle(
        bundle, RandomEffectDataConfig(re_type="userId", feature_shard="g"))
    up = sf.val.float()
    assert ds.buckets and all(b.val.dtype == torch.float32 for b in ds.buckets)
    total = sum(float(b.val.double().abs().sum()) for b in ds.buckets)
    assert total == pytest.approx(float(up.double().abs().sum()), rel=1e-12)


# ----------------------------------------------------------- the GAME driver

SPECS = [
    "fixed:type=fixed,shard=global,reg=L2,reg_weights=1,max_iter=8",
    "perUser:type=random,re_type=userId,shard=global,reg=L2,reg_weights=1,max_iter=8",
]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The drivers' GLMix data with every feature value rounded to bfloat16,
    so that the bf16 feed reads exactly the values a float32 read does."""
    from photon_tpu.io.avro import write_container
    from test_torch_scoring_driver import RECORD_SCHEMA

    jnp.zeros(1).block_until_ready()
    d = tmp_path_factory.mktemp("torch_bf16")
    for name, seed, users, rows in (("train", 5, 8, 24), ("score", 6, 10, 6)):
        _write_game_avro(d / f"{name}.avro", seed=seed, n_users=users,
                         rows_per_user=rows, offsets=True)
        recs = read_records(str(d / f"{name}.avro"))
        for r in recs:
            for f in r["features"]:
                f["value"] = float(np.float32(f["value"]).astype(ml_dtypes.bfloat16))
        write_container(str(d / f"{name}.avro"), RECORD_SCHEMA, recs)
    return d


def _means(model_dir, coord):
    out = {}
    for sub in ("fixed-effect", "random-effect"):
        for p in sorted((model_dir / sub / coord).glob("*.avro")):
            for rec in read_records(str(p)):
                for m in rec["means"]:
                    out[(rec.get("modelId"), m["name"], m["term"])] = m["value"]
    return out


def _scores(driver, d, model_dir, dest, extra=()):
    driver.run(["--data", str(d / "score.avro"), "--model-dir", str(model_dir),
                "--output-dir", str(dest), *extra])
    return np.array([r["predictionScore"] for r in read_records(str(dest / "scores.avro"))])


def test_bf16_feed_drivers_agree_and_cross_score(data, tmp_path):
    """On values that bfloat16 holds exactly, the port's ``--bf16-feed`` fit
    is its float32 fit bit for bit (the kernels upcast on load; the random
    effect re-packs float32), and within float32 bounds of the JAX driver's
    float32 fit. The JAX driver's own ``--bf16-feed`` fit runs its fixed
    effect in bfloat16 arithmetic (its ``GameDataBundle.batch`` gives the
    labels the values' dtype): its model and the port's are each scored
    by the other package's scoring driver as by their own."""
    common = ["--train-data", str(data / "train.avro"), "--task",
              "LOGISTIC_REGRESSION", "--coordinate", SPECS[0], "--coordinate",
              SPECS[1], "--sweeps", "2"]
    cpu = ["--device", "cpu"]
    ps = game_training_driver.run(common + ["--bf16-feed", "--output-dir",
                                            str(tmp_path / "port")] + cpu)
    p32 = game_training_driver.run(common + ["--output-dir", str(tmp_path / "p32")] + cpu)
    j32 = jax_training.run(common + ["--output-dir", str(tmp_path / "j32")])
    jax_training.run(common + ["--bf16-feed", "--output-dir", str(tmp_path / "jax")])
    assert ps["reader"] == "native"
    assert json.loads((tmp_path / "port" / "training-summary.json").read_text()) == ps
    for coord in ("fixed", "perUser"):
        pm = _means(tmp_path / "port" / "best", coord)
        assert pm == _means(tmp_path / "p32" / "best", coord) and len(pm) > 3
        jm = _means(tmp_path / "j32" / "best", coord)
        assert set(pm) == set(jm)
        for k in jm:
            assert abs(pm[k] - jm[k]) <= 1e-4 * max(1.0, abs(jm[k])), (coord, k)
    assert ps["best_config"] == p32["best_config"] == j32["best_config"]
    port_own = _scores(game_scoring_driver, data, tmp_path / "port" / "best",
                       tmp_path / "s_pp", cpu)
    port_on_jax = _scores(game_scoring_driver, data, tmp_path / "jax" / "best",
                          tmp_path / "s_pj", cpu)
    jax_own = _scores(jax_scoring, data, tmp_path / "jax" / "best", tmp_path / "s_jj")
    jax_on_port = _scores(jax_scoring, data, tmp_path / "port" / "best", tmp_path / "s_jp")
    assert np.std(port_own) > 0.05
    np.testing.assert_allclose(port_on_jax, jax_own, rtol=0, atol=1e-5)
    np.testing.assert_allclose(jax_on_port, port_own, rtol=0, atol=1e-5)


def test_bf16_feed_narrows_the_read_values(data):
    from photon_tpu_torch.io.data_reader import AvroDataReader, build_index_from_avro

    imap = build_index_from_avro([str(data / "train.avro")])
    reader = AvroDataReader({"global": imap})
    b32 = reader.read([str(data / "train.avro")], dtype=torch.float32, device=CPU)
    b16 = reader.read([str(data / "train.avro")], dtype=torch.float32, device=CPU,
                      feed_dtype="bfloat16")
    v32, v16 = b32.features["global"].val, b16.features["global"].val
    assert v16.dtype == torch.bfloat16 and reader.last_reader == "native"
    assert torch.equal(v16, v32.to(torch.bfloat16))
    assert torch.equal(b16.features["global"].idx, b32.features["global"].idx)


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", BF16_CASES)
def test_bf16_kernels_bit_equal_f32_kernels_on_card(name, cuda_device):
    """Each of the four kernels' bf16 entry point against its f32 entry
    point on the upcast values: the same bits (and one launch each)."""
    idx, val, d, w, dz = _case(name)
    i = _t(idx).to(cuda_device)
    vb = _t(val).to(cuda_device).to(torch.bfloat16)
    up = vb.float()
    wt, dzt = _t(w).to(cuda_device), _t(dz).to(cuda_device)
    n = idx.shape[0]
    cs.reset_launch_counts()
    pairs = [(cs.ell_matvec(i, vb, wt, d), cs.ell_matvec(i, up, wt, d))]
    sizes = (cs.tile_rows_for(n), cs.panel_cols(torch.bfloat16))
    pairs.append((cs.ell_panel_matvec(cs.panel_layout(i, vb, d, *sizes), wt),
                  cs.ell_panel_matvec(cs.panel_layout(i, up, d, *sizes), wt)))
    cb, cf = cs.build_csc(i, vb, d), cs.build_csc(i, up, d)
    for square in (False, True):
        pairs.append((cs.csc_rmatvec(cb, dzt, square), cs.csc_rmatvec(cf, dzt, square)))
    torch.cuda.synchronize()
    assert cs.launch_counts() == {name: 1 for name in cs.ALL_KERNELS}
    for got, want in pairs:
        assert got.dtype == torch.float32
        assert torch.equal(got, want)
    ref = cs.ell_matvec_plain(_t(idx), vb.cpu(), _t(w), d)
    np.testing.assert_allclose(pairs[0][0].cpu().numpy(), ref.numpy(), rtol=0,
                               atol=ATOL_F32)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rows_not_multiple", "rows_below_tile",
                                  "sliced_odd_k", "lanes", "row400", "row5000"])
def test_bf16_row_tile_kernel_on_edge_layouts(name, cuda_device):
    """The row-tile kernel's bf16 form on its edge layouts (a row-sliced
    view whose runs start off 16-byte alignment, a short last tile, rows
    longer than a stage): bit-equal to the f32 kernel on the upcast
    values."""
    idx, val, d, w = _ell_card_case(name)
    i = _t(idx).to(cuda_device)
    vb = _t(val).to(cuda_device).to(torch.bfloat16)
    up = vb.float()
    wd = _t(w).to(cuda_device)
    if name == "sliced_odd_k":
        i, vb, up = i[5:-2], vb[5:-2], up[5:-2]
        assert vb.data_ptr() % 16
    assert torch.equal(cs.ell_matvec(i, vb, wd, d), cs.ell_matvec(i, up, wd, d))


@pytest.mark.cuda
def test_bf16_panel_kernel_at_its_own_sizes(cuda_device):
    """``build_panels`` on bf16 values gives the f32 layout (tiles, panels,
    codes) with bf16 values; the bf16 panel kernel is bit-equal to the f32
    one, over 3 tiles and 3 panels with a hot column and duplicates."""
    rng = np.random.default_rng(13)
    n, d, k = 2500, 40001, 16
    idx, val = _random_ell(rng, n, d, k)
    idx[:, 0] = 7
    idx[:, 1] = idx[:, 2]
    i = _t(idx).to(cuda_device)
    vb = _t(val).to(cuda_device).to(torch.bfloat16)
    lb, lf = cs.build_panels(i, vb, d), cs.build_panels(i, vb.float(), d)
    assert lb is not None and lb.n_tiles == 3 and lb.vals.dtype == torch.bfloat16
    assert torch.equal(lb.codes, lf.codes) and torch.equal(lb.offsets, lf.offsets)
    w = _t(rng.normal(size=d).astype(np.float32)).to(cuda_device)
    assert torch.equal(cs.ell_panel_matvec(lb, w), cs.ell_panel_matvec(lf, w))


@pytest.mark.cuda
def test_bf16_glm_passes_through_sparse_features_on_card(cuda_device, monkeypatch):
    """Under PHOTON_VALUE_DTYPE the layouts attach and narrow on the card;
    the passes equal the f32 features' on the upcast values. A
    random-effect bucket's lanes do not narrow."""
    idx, val, d, w, dz = _bf16_case("1000x700x6")
    i, v = _t(idx).to(cuda_device), _t(val).to(cuda_device)
    ref = SparseFeatures(i, v, d).with_accelerator_paths()
    monkeypatch.setenv("PHOTON_VALUE_DTYPE", "bfloat16")
    sf = SparseFeatures(i, v, d).with_accelerator_paths()
    assert sf.val.dtype == sf.csc.vals.dtype == torch.bfloat16
    wt, dzt = _t(w).to(cuda_device), _t(dz).to(cuda_device)
    assert torch.equal(sf.matvec(wt), ref.matvec(wt))
    assert torch.equal(sf.rmatvec(dzt), ref.rmatvec(dzt))
    assert torch.equal(sf.sq_rmatvec(dzt), ref.sq_rmatvec(dzt))
    batch = LabeledBatch(sf, torch.zeros(len(idx), device=cuda_device),
                         torch.zeros(len(idx), device=cuda_device),
                         torch.ones(len(idx), device=cuda_device))
    assert batch.features.dtype == torch.float32
    # random-effect lanes attach their layouts and stay float32
    lanes = LaneFeatures.from_bucket(i.reshape(10, 100, -1), v.reshape(10, 100, -1),
                                     d).with_accelerator_paths()
    assert lanes.flat.val.dtype == lanes.flat.csc.vals.dtype == torch.float32
