#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``photon_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA GPU

Phases, each printing one JSON line; any failure ends the run with a nonzero
exit code and no result line:

0. card: ``nvidia-smi`` name and power limit, and the kernels' build
   (``nvcc`` into ``photon_tpu_torch/_build``, from the sources here), with
   each kernel's registers, shared memory and spills from nvcc's log.
1. kernels at full width (2^19 rows x 32 entries over 262,144 global + a
   per-user block of features, the repository's headline single-chip shape):
   ``ell_panel_matvec`` (over ``build_panels``' layout), ``ell_matvec``,
   ``csc_rmatvec`` and ``csc_sq_rmatvec`` against their plain PyTorch
   versions on the card (f32: rtol 1e-5, atol 1e-5 x max|ref|; f64: 1e-12)
   on three layouts: the GAME layout, a hot-and-duplicate-column case, and a
   long-column case (a column of every row plus columns at the transpose
   kernel's tile size and one off it). Every kernel repeats bit-equal in f32
   and f64. Times in f32: kernel, one library call as a yardstick (cuSPARSE
   through ``torch.sparse_csr_tensor``; never called by the port), plain
   version and the bound from bytes moved, on each layout.
2. transformer at full width: ``GameTransformer.transform`` of an in-memory
   bundle (4,096 users x 128 rows, fixed effect + ``perUser``) on cuda and
   on cpu; the scores agree within the stated tolerance and
   ``ell_panel_matvec`` launched.
3. driver end to end: Avro data, index store and model directory written by
   the port's own writers (same widths, 32,768 rows: the per-record Avro
   reader is pure Python, so depth is cut here), scored by
   ``photon_tpu_torch.cli.game_scoring_driver`` with ``--device cuda`` and
   ``--device cpu``; both ``scores.avro`` agree and the matvec kernel that
   ``build_panels``' rule picks for these rows launched.
4. training at full width (``bench.py``'s headline fixed-effect shape: 2^19
   rows x 32 entries over 2^18 features, its ``_make_data``): logistic
   L-BFGS, L2 weight 1, SIMPLE variances, 40 iterations at tolerance 0,
   through ``GameEstimator.fit`` on an in-memory bundle. In f32 on cuda
   twice (bit-equal), against cpu (final objective within relative 1e-5);
   in f64 for 10 iterations on both (coefficients within relative 1e-10).
   The counted fit launches ``ell_panel_matvec``, ``csc_rmatvec`` and
   ``csc_sq_rmatvec``, and its launch counts equal the pass counter's.
   TRON-Poisson and OWL-QN-linear at ``bench.py``'s 2^17 x 16 over 2^15,
   cuda against cpu (objective within 1e-5). The solve alone is timed,
   profiled (``torch.profiler``: device busy and kernel shares) and its
   host syncs counted, in f32 and in f64 (at most 40 iterations: tolerance
   0 stops where the objective stops changing, sooner in f32).
5. training driver: ``photon_tpu_torch.cli.game_training_driver`` on phase
   3's Avro data (fixed-effect logistic, SIMPLE variances) with ``--device
   cuda`` and ``--device cpu``; the saved models agree (f32, 1e-3 of the
   largest coefficient) and the card's model is scored by the port's
   scoring driver on cuda; stage times from ``photon.log``.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Model weights and data are random, made
from fixed seeds. Work files go to ``photon_tpu_torch/_build/chip_smoke/``
and are removed on success; nvcc's log stays beside the built library.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "photon_tpu_torch", "_build", "chip_smoke")

FULL = dict(n_users=4096, rows_per_user=128, d_global=262144, d_user=16,
            k_global=28, k_user=4, driver_rows_per_user=8)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}   # outside tensor cores
REPLACES = "photon_tpu/ops/pallas_sparse.py:248"        # _gather_onehot_kernel
TPU_ENTRY = {"ell_panel_matvec": "matvec_pallas (pallas_sparse.py:331)",
             "ell_matvec": "matvec_pallas (pallas_sparse.py:331)",
             "csc_rmatvec": "rmatvec_pallas (pallas_sparse.py:313)",
             "csc_sq_rmatvec": "rmatvec_pallas(square_vals=True) (pallas_sparse.py:313)"}
RTOL_F32, ATOL_F32_REL, ATOL_F64 = 1e-5, 1e-5, 1e-12


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# ------------------------------------------------------------------ data


def game_arrays(n_users, rows_per_user, d_global, d_user, k_global, k_user,
                col0=0, seed=2, **_):
    """Rows laid out as bench.py's ``_game_bundle``: ``k_global`` entries
    from a global block and ``k_user`` from the row's user block; columns
    start at ``col0`` (1 when column 0 is the intercept)."""
    rng = np.random.default_rng(seed)
    n = n_users * rows_per_user
    users = np.repeat(np.arange(n_users), rows_per_user)
    rng.shuffle(users)
    gi = col0 + rng.integers(0, d_global, size=(n, k_global))
    gv = rng.normal(size=(n, k_global)) / np.sqrt(k_global)
    ul = rng.integers(0, d_user, size=(n, k_user))
    ui = col0 + d_global + users[:, None] * d_user + ul
    uv = rng.normal(size=(n, k_user)) / 2.0
    idx = np.concatenate([gi, ui], axis=1).astype(np.int32)
    val = np.concatenate([gv, uv], axis=1).astype(np.float32)
    dim = col0 + d_global + n_users * d_user
    keys = np.array([f"u{u}" for u in users], object)
    return idx, val, dim, users, keys


def model_spec(n_users, d_global, d_user, intercept: bool, seed=9, **_) -> dict:
    """A fixed effect over every column and a ``perUser`` random effect
    for the numpy-to-port converter. Users with ``u % 16 == 15`` are not in
    the model (they score through the zero model); the rest carry their whole
    user block (u % 3 != 0) or its first half, plus the intercept when there
    is one — two bucket widths."""
    rng = np.random.default_rng(seed)
    col0 = 1 if intercept else 0
    dim = col0 + d_global + n_users * d_user
    seen = [u for u in range(n_users) if u % 16 != 15]
    groups: dict = {}
    for u in seen:
        width = d_user if u % 3 else d_user // 2
        cols = col0 + d_global + u * d_user + np.arange(width)
        if intercept:
            cols = np.concatenate([[0], cols])
        p = 1 << (len(cols) - 1).bit_length()
        groups.setdefault(p, []).append((u, cols))
    keys, coefs, proj, ids = [], [], [], []
    for p, members in sorted(groups.items()):
        c = np.zeros((len(members), p), np.float64)
        pr = np.full((len(members), p), dim, np.int32)
        e = np.zeros(len(members), np.int32)
        for lane, (u, cols) in enumerate(members):
            pr[lane, :len(cols)] = cols
            c[lane, :len(cols)] = rng.normal(size=len(cols)) * 0.5
            e[lane] = len(keys)
            keys.append(f"u{u}")
        coefs.append(c)
        proj.append(pr)
        ids.append(e)
    return {
        "fixed": {"type": "fixed", "feature_shard": "global",
                  "task": "LOGISTIC_REGRESSION",
                  "means": rng.normal(size=dim) * 0.1, "variances": None},
        "perUser": {"type": "random", "re_type": "userId",
                    "task": "LOGISTIC_REGRESSION", "global_dim": dim,
                    "entity_keys": keys, "bucket_coefs": coefs,
                    "bucket_proj": proj, "bucket_entity_ids": ids,
                    "bucket_variances": None},
    }


def kernel_bound(name: str, n: int, k: int, dim: int, nnz: int, dtype: str) -> dict:
    """Least time the card could take: each input read once, each output
    written once, over 3.35 TB/s; operations over the peak for the type."""
    vb = 4 if dtype == "float32" else 8
    if name in ("ell_matvec", "ell_panel_matvec"):
        nbytes = n * k * (4 + vb) + dim * vb + n * vb
        ops = 2 * n * k
    else:
        nbytes = (dim + 1) * 8 + nnz * (4 + vb) + n * vb + dim * vb
        ops = (3 if name == "csc_sq_rmatvec" else 2) * nnz
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


# ------------------------------------------------------------------ timing


def time_ms(torch, fn, warmup=3, reps=20, rounds=5) -> float:
    """Device time of one call: the median over ``rounds`` of a CUDA-event
    timing of ``reps`` back-to-back calls, divided by ``reps``, after
    warm-up. Back-to-back calls keep the card busy, so the host's launch
    overhead stays hidden wherever a call takes longer on the card than on
    the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def _close(torch, got, ref, dtype: str) -> float:
    err = (got.double() - ref.double()).abs().max().item() if got.numel() else 0.0
    if dtype == "float32":
        atol = ATOL_F32_REL * max(ref.abs().max().item(), 1e-30)
        ok = torch.allclose(got, ref, rtol=RTOL_F32, atol=atol)
    else:
        ok = torch.allclose(got, ref, rtol=ATOL_F64, atol=ATOL_F64)
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version ({dtype}): "
                             f"max abs err {err}")
    return err


# ------------------------------------------------------------------ phases


def library_calls(torch, idx, val, w, v, csc, dim) -> dict:
    """One library call per kernel as a yardstick, never called by the port:
    cuSPARSE's CSR SpMV (through ``torch.sparse_csr_tensor``) of A for the
    matvec and of Aᵀ (from the same CSC arrays; values squared for the
    Hessian diagonal) for the transposes."""
    n = idx.shape[0]
    keep = (idx >= 0) & (idx < dim)
    crow = torch.zeros(n + 1, dtype=torch.int32, device=idx.device)
    crow[1:] = torch.cumsum(keep.sum(1), 0)
    a = torch.sparse_csr_tensor(crow, idx[keep], val[keep], size=(n, dim))
    at = torch.sparse_csr_tensor(csc.colptr.int(), csc.rows, csc.vals, size=(dim, n))
    at2 = torch.sparse_csr_tensor(csc.colptr.int(), csc.rows, csc.vals * csc.vals,
                                  size=(dim, n))
    return {"ell_panel_matvec": lambda: a @ w, "ell_matvec": lambda: a @ w,
            "csc_rmatvec": lambda: at @ v, "csc_sq_rmatvec": lambda: at2 @ v}


def kernel_calls(cs, idx, val, w, v, csc, panels, dim) -> dict:
    """Each kernel's wrapper and its plain version, on the same inputs."""
    return {
        "ell_panel_matvec": (lambda: cs.ell_panel_matvec(panels, w),
                             lambda: cs.ell_panel_matvec_plain(panels, w)),
        "ell_matvec": (lambda: cs.ell_matvec(idx, val, w, dim),
                       lambda: cs.ell_matvec_plain(idx, val, w, dim)),
        "csc_rmatvec": (lambda: cs.csc_rmatvec(csc, v),
                        lambda: cs.csc_rmatvec_plain(csc, v)),
        "csc_sq_rmatvec": (lambda: cs.csc_rmatvec(csc, v, square=True),
                           lambda: cs.csc_rmatvec_plain(csc, v, square=True)),
    }


def check_case(torch, cs, dev, idx_np, val_np, dim, seed) -> dict:
    """The four kernels on one layout, in f32 and f64: each against its
    plain version, each run twice and bit-equal. In f32: times of the
    kernel, its plain version and the library call, and the bound."""
    n, k = idx_np.shape
    rng = np.random.default_rng(seed)
    w_np, v_np = rng.normal(size=dim), rng.normal(size=n)
    idx = torch.from_numpy(idx_np).to(dev)
    out = {}
    for dtype, tdt in (("float32", torch.float32), ("float64", torch.float64)):
        val = torch.from_numpy(val_np).to(dev, tdt)
        w = torch.from_numpy(w_np).to(dev, tdt)
        v = torch.from_numpy(v_np).to(dev, tdt)
        t0 = time.perf_counter()
        csc = cs.build_csc(idx, val, dim)
        csc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        panels = cs.build_panels(idx, val, dim)
        torch.cuda.synchronize()
        panels_s = time.perf_counter() - t0
        if panels is None:
            raise AssertionError(f"build_panels found no gain at {n} rows ({dtype})")
        calls = kernel_calls(cs, idx, val, w, v, csc, panels, dim)
        res = {}
        for name, (kern, plain) in calls.items():
            got = kern()
            torch.cuda.synchronize()
            res[name] = {"max_abs_err": _close(torch, got, plain(), dtype)}
            again = kern()
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"{name}: two runs differ ({dtype})")
            res[name]["bit_equal_repeat"] = True
        if dtype == "float32":
            library = library_calls(torch, idx, val, w, v, csc, dim)
            for name, (kern, plain) in calls.items():
                lib_err = (library[name]().double() - plain().double()).abs().max()
                res[name].update(
                    library_max_abs_err=lib_err.item(),
                    ms=time_ms(torch, kern), plain_ms=time_ms(torch, plain),
                    library_ms=time_ms(torch, library[name]),
                    **kernel_bound(name, n, k, dim, csc.nnz, dtype))
        out[dtype] = {"build_csc_s": csc_s, "nnz": csc.nnz,
                      "tiles": csc.tiles.shape[0] - 1,
                      "split_columns": csc.splits.shape[0],
                      "build_panels_s": panels_s, "row_tiles": panels.n_tiles,
                      "tile_rows": panels.tile_rows, "panels": panels.n_panels,
                      "panel_entries": panels.codes.shape[0],
                      "panel_dynamic_smem_bytes": cs.panel_smem_bytes(
                          panels.tile_rows, panels.n_panels),
                      "kernels": res}
    return out


def long_column_arrays(idx_np, dim, tile_items):
    """A column of every row (column 7) plus three new columns whose
    lengths sit exactly at the transpose kernel's tile size and one off it
    on either side: ``(idx, dim + 3, lengths)``."""
    idx = idx_np.copy()
    idx[:, 0] = 7
    lengths = (tile_items, tile_items - 1, tile_items + 1)
    start = 0
    for j, length in enumerate(lengths):
        idx[start:start + length, 1] = dim + j
        start += length
    return idx, dim + len(lengths), lengths


def phase_kernels(torch, dev) -> dict:
    from photon_tpu_torch.ops import cuda_sparse as cs

    idx_np, val_np, dim, _, _ = game_arrays(**FULL)
    n, k = idx_np.shape
    out = {"shape": {"n": n, "k": k, "dim": dim},
           "game": check_case(torch, cs, dev, idx_np, val_np, dim, 4)}
    # hot and duplicate columns at full width (as test_pallas_sparse.py)
    hot_idx = idx_np.copy()
    hot_idx[:, 0] = 7                       # a column in every row
    hot_idx[:, 1] = hot_idx[:, 2]           # duplicates within rows
    out["hot_dup"] = check_case(torch, cs, dev, hot_idx, val_np, dim, 5)
    long_idx, long_dim, lengths = long_column_arrays(idx_np, dim, cs.TILE_ITEMS)
    out["long_col"] = check_case(torch, cs, dev, long_idx, val_np, long_dim, 6)
    out["long_col"]["tile_length_columns"] = lengths
    return out


def _bundle(torch, sizes, dev, dtype):
    from photon_tpu_torch.data.batch import SparseFeatures
    from photon_tpu_torch.io.data_reader import GameDataBundle

    idx, val, dim, _, keys = game_arrays(**sizes)
    n = len(keys)
    rng = np.random.default_rng(6)
    return GameDataBundle(
        features={"global": SparseFeatures(
            torch.from_numpy(idx).to(dev), torch.from_numpy(val).to(dev, dtype), dim)},
        labels=(rng.random(n) < 0.5).astype(np.float64),
        offsets=rng.normal(size=n) * 0.1,
        weights=np.ones(n),
        uids=np.arange(n).astype(object),
        id_tags={"userId": keys},
    )


def phase_transformer(torch, sizes, dev, ref_dev) -> dict:
    """Score one in-memory bundle on ``dev`` and on ``ref_dev``."""
    from photon_tpu_torch.estimators.config import (
        FixedEffectDataConfig,
        RandomEffectDataConfig,
    )
    from photon_tpu_torch.estimators.game_transformer import GameTransformer
    from photon_tpu_torch.io.convert import game_model_from_numpy

    spec = model_spec(intercept=False, **sizes)
    cfgs = {"fixed": FixedEffectDataConfig("global"),
            "perUser": RandomEffectDataConfig("userId", "global")}
    scores, seconds = {}, {}
    for d in (dev, ref_dev):
        model = game_model_from_numpy(spec, d, torch.float32)
        bundle = _bundle(torch, sizes, d, torch.float32)
        t0 = time.perf_counter()
        s = GameTransformer(model, cfgs).transform(bundle)
        if d.type == "cuda":
            torch.cuda.synchronize(d)
        seconds[d.type] = time.perf_counter() - t0
        scores[d.type] = s.cpu()
    got, ref = scores[dev.type], scores[ref_dev.type]
    n = sizes["n_users"] * sizes["rows_per_user"]
    if got.shape != (n,) or not torch.isfinite(got).all():
        raise AssertionError(f"transform gave shape {tuple(got.shape)} / non-finite")
    err = _close(torch, got, ref, "float32")
    return {"rows": n, "max_abs_err_vs_ref": err, "score_std": got.std().item(),
            "transform_s": seconds}


def transform_breakdown(torch, sizes, dev) -> dict:
    """Seconds of the transform's pieces, run one by one on ``dev`` (after
    the counted transform, so nothing is cold): the fixed-effect layout
    attach (``build_panels``) and matvec, the random-effect dataset build
    (host) and the random-effect projection + bucket scoring."""
    from photon_tpu_torch.estimators.config import RandomEffectDataConfig
    from photon_tpu_torch.estimators.game_estimator import build_re_dataset_from_bundle
    from photon_tpu_torch.io.convert import game_model_from_numpy

    model = game_model_from_numpy(model_spec(intercept=False, **sizes), dev,
                                  torch.float32)
    bundle = _bundle(torch, sizes, dev, torch.float32)
    cfg = RandomEffectDataConfig("userId", "global")

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    feats, t_attach = timed(lambda: bundle.features["global"].with_matvec_layout())
    _, t_fixed = timed(lambda: feats.matvec(model["fixed"].model.coefficients.means))
    ds, t_build = timed(lambda: build_re_dataset_from_bundle(bundle, cfg))
    _, t_score = timed(lambda: model["perUser"].score_new_dataset(ds))
    return {"fixed_attach": t_attach, "fixed_matvec": t_fixed,
            "re_dataset_build": t_build,
            "re_project_and_score": t_score}


def write_driver_inputs(torch, sizes, root: str) -> dict:
    """Avro data, index store and model directory, written by the port's
    own writers: ``root/data.avro``, ``root/out/index/global``,
    ``root/out/best``."""
    from photon_tpu_torch.index.index_map import (
        INTERCEPT_NAME,
        DefaultIndexMap,
        MmapIndexMap,
        build_mmap_index,
        feature_key,
    )
    from photon_tpu_torch.io.avro import ContainerWriter
    from photon_tpu_torch.io.convert import game_model_from_numpy
    from photon_tpu_torch.io.data_reader import FeatureShardConfig
    from photon_tpu_torch.io.model_io import save_game_model
    from photon_tpu_torch.io.schemas import TRAINING_EXAMPLE_AVRO

    d_global, d_user, n_users = sizes["d_global"], sizes["d_user"], sizes["n_users"]
    rows = dict(sizes, rows_per_user=sizes["driver_rows_per_user"])
    idx, val, dim, users, keys = game_arrays(col0=1, seed=3, **rows)
    names = [feature_key(INTERCEPT_NAME, "")]
    names += [feature_key("g", str(j)) for j in range(d_global)]
    names += [feature_key("u", f"{u}_{j}") for u in range(n_users) for j in range(d_user)]
    assert len(names) == dim
    t0 = time.perf_counter()
    index_dir = os.path.join(root, "out", "index", "global")
    build_mmap_index(DefaultIndexMap(names), index_dir)
    imap = MmapIndexMap(index_dir)
    t_index = time.perf_counter() - t0

    t0 = time.perf_counter()
    rng = np.random.default_rng(8)
    name_term = [n.split("\x01") for n in names]
    with ContainerWriter(os.path.join(root, "data.avro"), TRAINING_EXAMPLE_AVRO) as w:
        for r in range(len(users)):
            w.write({
                "uid": f"r{r}",
                "label": float(rng.random() < 0.5),
                "weight": None,
                "offset": float(rng.normal()) * 0.1,
                "features": [
                    {"name": name_term[c][0], "term": name_term[c][1],
                     "value": float(x)}
                    for c, x in zip(idx[r], val[r])
                ],
                "metadataMap": {"userId": keys[r]},
            })
    t_data = time.perf_counter() - t0

    t0 = time.perf_counter()
    model = game_model_from_numpy(
        model_spec(intercept=True, **sizes), torch.device("cpu"), torch.float32)
    save_game_model(os.path.join(root, "out", "best"), model, {"global": imap},
                    {"fixed": "global", "perUser": "global"},
                    {"global": FeatureShardConfig(("features",), True)})
    t_model = time.perf_counter() - t0
    return {"rows": len(users), "dim": dim, "write_index_s": t_index,
            "write_data_s": t_data, "write_model_s": t_model}


def _stage_seconds(log_path: str) -> dict:
    out = {}
    with open(log_path) as f:
        for line in f:
            m = re.search(r": ([a-z ]+): done in ([0-9.]+)s", line)
            if m:
                out[m.group(1).replace(" ", "_") + "_s"] = float(m.group(2))
    return out


def phase_driver(torch, sizes, dev, ref_dev, root: str, inputs: dict) -> dict:
    """Score ``root/data.avro`` with the port's scoring driver on ``dev``
    and ``ref_dev``; compare the two ``scores.avro``."""
    from photon_tpu_torch.cli import game_scoring_driver
    from photon_tpu_torch.io.avro import read_records

    runs = {}
    for d in (dev, ref_dev):
        dest = os.path.join(root, f"scores_{d.type}")
        t0 = time.perf_counter()
        summary = game_scoring_driver.run([
            "--data", os.path.join(root, "data.avro"),
            "--model-dir", os.path.join(root, "out", "best"),
            "--output-dir", dest, "--device", d.type,
        ])
        wall = time.perf_counter() - t0
        if summary != {"n_rows": inputs["rows"], "evaluation": None}:
            raise AssertionError(f"unexpected driver summary {summary}")
        recs = read_records(os.path.join(dest, "scores.avro"))
        runs[d.type] = {"recs": recs, "wall_s": wall,
                        **_stage_seconds(os.path.join(dest, "photon.log"))}
    a, b = runs[dev.type]["recs"], runs[ref_dev.type]["recs"]
    if [r["uid"] for r in a] != [r["uid"] for r in b] or len(a) != inputs["rows"]:
        raise AssertionError("scores.avro rows differ between devices")
    got = torch.tensor([r["predictionScore"] for r in a], dtype=torch.float64)
    ref = torch.tensor([r["predictionScore"] for r in b], dtype=torch.float64)
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite scores")
    err = _close(torch, got.float(), ref.float(), "float32")
    for r in runs.values():
        del r["recs"]
    return {"rows": len(a), "max_abs_err_vs_ref": err,
            "score_std": got.std().item(), "runs": runs}


# ------------------------------------------------------------------ training

# The headline fixed-effect shape (bench.py:309) and bench.py's TRON /
# OWL-QN shape (bench_owlqn_tron).
TRAIN = dict(n_rows=1 << 19, dim=1 << 18, k=32, iterations=40, f64_iterations=10)
SMALL = dict(n_rows=1 << 17, dim=1 << 15, k=16, iterations=25)
OBJ_RTOL_F32 = 1e-5          # final objective, cuda against cpu, float32
COEF_RTOL_F64 = 1e-10        # coefficients, cuda against cpu, float64
# Saved coefficients of the driver phase, cuda against cpu in float32, as a
# share of the largest |coefficient|: two devices round their reductions
# and transcendentals differently, and 20 L-BFGS iterations carry that on.
DRIVER_COEF_RTOL_F32 = 1e-3
OUR_KERNELS = ("ell_panel_kernel", "ell_matvec_kernel", "csc_tile_kernel",
               "csc_fixup_kernel")


def bench_data(n_rows, dim, k, seed=0, **_):
    """bench.py's ``_make_data``: uniform columns, N(0, 1/k) values and
    labels drawn from a logistic model with N(0, 1) true weights (values in
    float32, as bench.py's division gives them under NumPy 1)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, dim, size=(n_rows, k)).astype(np.int32)
    val = rng.normal(size=(n_rows, k)).astype(np.float32) / np.float32(np.sqrt(k))
    w_true = rng.normal(size=dim).astype(np.float32)
    z = (val * w_true[idx]).sum(axis=1)
    labels = (rng.random(n_rows) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    return idx, val, labels


def small_data(n_rows, dim, k, seed=1, **_):
    """bench.py's ``bench_owlqn_tron`` data: linear and Poisson labels."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, dim, size=(n_rows, k)).astype(np.int32)
    val = rng.normal(size=(n_rows, k)).astype(np.float32) / np.float32(np.sqrt(k))
    w_true = rng.normal(size=dim).astype(np.float32)
    z = (val * w_true[idx]).sum(axis=1)
    y_lin = (z + 0.1 * rng.normal(size=n_rows)).astype(np.float32)
    y_poi = rng.poisson(np.exp(np.clip(0.2 * z, -4, 4))).astype(np.float32)
    return idx, val, y_lin, y_poi


def train_bundle(torch, idx, val, labels, dim, dev, dtype):
    from photon_tpu_torch.data.batch import SparseFeatures
    from photon_tpu_torch.io.data_reader import GameDataBundle

    n = len(labels)
    return GameDataBundle(
        features={"global": SparseFeatures(
            torch.from_numpy(idx).to(dev), torch.from_numpy(val).to(dev, dtype), dim)},
        labels=labels.astype(np.float64), offsets=np.zeros(n),
        weights=np.ones(n), uids=np.full(n, "", object), id_tags={})


def opt_config(optimizer: str, reg: str, iterations: int, variance="NONE"):
    from photon_tpu_torch.estimators.config import GLMOptimizationConfiguration
    from photon_tpu_torch.functions.problem import VarianceComputationType
    from photon_tpu_torch.optim import OptimizerType
    from photon_tpu_torch.optim.regularization import (
        RegularizationContext,
        RegularizationType,
    )

    return GLMOptimizationConfiguration(
        optimizer_type=OptimizerType[optimizer], max_iterations=iterations,
        tolerance=0.0, regularization=RegularizationContext(RegularizationType[reg]),
        reg_weight=1.0, variance_type=VarianceComputationType[variance])


def fit(torch, bundle, task: str, ocfg) -> dict:
    """One ``GameEstimator.fit`` of a fixed effect on the bundle's device."""
    from photon_tpu_torch.estimators.config import FixedEffectDataConfig
    from photon_tpu_torch.estimators.game_estimator import GameEstimator
    from photon_tpu_torch.types import TaskType

    est = GameEstimator(TaskType[task], {"fixed": FixedEffectDataConfig("global")})
    t0 = time.perf_counter()
    (res,) = est.fit(bundle, None, [{"fixed": ocfg}])
    if bundle.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step = res.tracker[0]
    coefs = res.model["fixed"].model.coefficients
    r = step.result
    return {"fit_s": wall, "step_s": step.seconds,
            "ms_per_iteration": step.seconds * 1e3 / max(r.iterations, 1),
            "iterations": r.iterations, "reason": r.reason_name(),
            "data_passes": r.data_passes, "value": r.value,
            "means": coefs.means, "variances": coefs.variances}


def _public(run: dict) -> dict:
    return {k: v for k, v in run.items() if k not in ("means", "variances")}


def _rel_close(a: float, b: float, rtol: float, what: str) -> float:
    rel = abs(a - b) / max(abs(b), 1e-30)
    if not rel <= rtol:
        raise AssertionError(f"{what}: {a} against {b}, relative {rel} > {rtol}")
    return rel


def _coef_rel_err(torch, a, b) -> float:
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


def solve_stats(torch, batch, problem) -> dict:
    """``GLMOptimizationProblem.run`` on an attached batch on the card:
    timed five times after a warm-up run (host clock to a synchronize; the
    median and every run, since the host's clock moves between runs), once
    under ``torch.profiler`` (device time of the port's kernels and of all
    kernels, over the median wall time), and once under PyTorch's CUDA sync
    debug mode (host syncs)."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    w0 = torch.zeros(batch.dim, dtype=batch.labels.dtype, device=batch.labels.device)
    problem.run(batch, w0)
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, r = problem.run(batch, w0)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    wall = statistics.median(runs)
    out = {"iterations": r.iterations, "reason": r.reason_name(),
           "data_passes": r.data_passes, "run_s": wall, "run_s_all": runs,
           "ms_per_iteration": wall * 1e3 / max(r.iterations, 1)}
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            problem.run(batch, w0)
            torch.cuda.synchronize()
        ours = total = 0.0
        count = 0
        for ev in prof.key_averages():
            if "CUDA" not in str(getattr(ev, "device_type", "")):
                continue
            us = getattr(ev, "self_device_time_total", None)
            us = ev.self_cuda_time_total if us is None else us
            total += us
            count += ev.count
            if any(k in ev.key for k in OUR_KERNELS):
                ours += us
        out["profile"] = {"device_kernels": count, "device_us": total,
                          "port_kernels_us": ours,
                          "device_busy_share": total / (wall * 1e6),
                          "port_kernel_share": ours / (wall * 1e6)}
    except Exception as e:  # noqa: BLE001 - the profiler is untried here
        out["profile"] = {"error": f"{type(e).__name__}: {e}"}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            problem.run(batch, w0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    out.update(syncs=syncs, syncs_per_iteration=syncs / max(r.iterations, 1))
    return out


def phase_training(torch, cs, sizes, small, dev, ref_dev) -> dict:
    """Fixed-effect GLM training through ``GameEstimator.fit``: logistic
    L-BFGS with SIMPLE variances at ``sizes`` (f32 twice on ``dev``, bit
    for bit; against ``ref_dev``; f64 on both), then TRON-Poisson and
    OWL-QN-linear at ``small``. The first f32 fit on ``dev`` is the counted
    run: its kernel launches are returned under ``launches``."""
    from photon_tpu_torch.ops import pass_counter

    idx, val, labels = bench_data(**sizes)
    dim = sizes["dim"]
    out: dict = {"shape": {k: sizes[k] for k in ("n_rows", "dim", "k")}}
    if dev.type == "cuda":
        idx_d = torch.from_numpy(idx).to(dev)
        val_d = torch.from_numpy(val).to(dev)
        t0 = time.perf_counter()
        panels = cs.build_panels(idx_d, val_d, dim)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cs.build_csc(idx_d, val_d, dim)
        torch.cuda.synchronize()
        out["layouts"] = {
            "build_panels_s": t1 - t0, "build_csc_s": time.perf_counter() - t1,
            "row_tiles": panels.n_tiles if panels else None,
            "tile_rows": panels.tile_rows if panels else None,
            "panels": panels.n_panels if panels else None}
        del idx_d, val_d, panels

    cfg = opt_config("LBFGS", "L2", sizes["iterations"], "SIMPLE")
    b32 = train_bundle(torch, idx, val, labels, dim, dev, torch.float32)
    cs.reset_launch_counts()
    with pass_counter.counting() as passes:
        first = fit(torch, b32, "LOGISTIC_REGRESSION", cfg)
    launches = cs.launch_counts()
    passes = dict(passes)
    second = fit(torch, b32, "LOGISTIC_REGRESSION", cfg)
    if not (torch.equal(first["means"], second["means"])
            and torch.equal(first["variances"], second["variances"])):
        raise AssertionError("two f32 fits on the same data differ")
    ref = fit(torch, train_bundle(torch, idx, val, labels, dim, ref_dev,
                                  torch.float32), "LOGISTIC_REGRESSION", cfg)
    obj_rel = _rel_close(first["value"], ref["value"], OBJ_RTOL_F32,
                         "f32 final objective")
    for run in (first, ref):
        v = run["variances"]
        if not (torch.isfinite(run["means"]).all() and torch.isfinite(v).all()
                and (v > 0).all()):
            raise AssertionError("non-finite coefficients or variances")
    if dev.type == "cuda":
        if passes["matvec"] != launches["ell_panel_matvec"] + launches["ell_matvec"]:
            raise AssertionError(f"matvec passes {passes} != launches {launches}")
        if passes["rmatvec"] != launches["csc_rmatvec"]:
            raise AssertionError(f"rmatvec passes {passes} != launches {launches}")
        if passes["sq_rmatvec"] != launches["csc_sq_rmatvec"]:
            raise AssertionError(f"sq_rmatvec passes {passes} != launches {launches}")
        for name in ("ell_panel_matvec", "csc_rmatvec", "csc_sq_rmatvec"):
            if launches[name] < 1:
                raise AssertionError(f"training phase never launched {name}")
    out["logistic_lbfgs_f32"] = {
        "run": _public(first), "repeat": _public(second), "ref": _public(ref),
        "bit_equal_repeat": True, "objective_rel_err_vs_ref": obj_rel,
        "coef_rel_err_vs_ref": _coef_rel_err(torch, first["means"], ref["means"]),
        "pass_counter": passes}

    cfg64 = opt_config("LBFGS", "L2", sizes["f64_iterations"], "SIMPLE")
    f64 = {d.type: fit(torch, train_bundle(torch, idx, val, labels, dim, d,
                                           torch.float64),
                       "LOGISTIC_REGRESSION", cfg64) for d in (dev, ref_dev)}
    rel64 = _coef_rel_err(torch, f64[dev.type]["means"], f64[ref_dev.type]["means"])
    if not rel64 <= COEF_RTOL_F64:
        raise AssertionError(f"f64 coefficients differ by {rel64} > {COEF_RTOL_F64}")
    out["logistic_lbfgs_f64"] = {"runs": {k: _public(v) for k, v in f64.items()},
                                 "coef_rel_err_vs_ref": rel64}

    sidx, sval, y_lin, y_poi = small_data(**small)
    for name, task, y, opt, reg in (
            ("tron_poisson_l2", "POISSON_REGRESSION", y_poi, "TRON", "L2"),
            ("owlqn_linear_l1", "LINEAR_REGRESSION", y_lin, "OWLQN", "L1")):
        c = opt_config(opt, reg, small["iterations"])
        runs = {d.type: fit(torch, train_bundle(torch, sidx, sval, y, small["dim"],
                                                d, torch.float32), task, c)
                for d in (dev, ref_dev)}
        rel = _rel_close(runs[dev.type]["value"], runs[ref_dev.type]["value"],
                         OBJ_RTOL_F32, f"{name} final objective")
        out[name] = {"shape": {k: small[k] for k in ("n_rows", "dim", "k")},
                     "runs": {k: _public(v) for k, v in runs.items()},
                     "objective_rel_err_vs_ref": rel}

    if dev.type == "cuda":
        # The solve alone, f32 as fitted above and f64 (which runs longer
        # before its objective stops changing).
        from photon_tpu_torch.types import TaskType

        task = TaskType.LOGISTIC_REGRESSION
        out["solve_f32"] = solve_stats(
            torch, b32.batch("global").with_accelerator_paths(), cfg.problem(task))
        b64 = train_bundle(torch, idx, val, labels, dim, dev, torch.float64)
        out["solve_f64"] = solve_stats(
            torch, b64.batch("global").with_accelerator_paths(),
            opt_config("LBFGS", "L2", sizes["iterations"], "SIMPLE").problem(task))
    out["launches"] = launches
    return out


def _read_fixed(path: str) -> dict:
    from photon_tpu_torch.io.avro import read_records

    (rec,) = read_records(os.path.join(path, "fixed-effect", "fixed", "coefficients.avro"))
    out = {"means": {(m["name"], m["term"]): m["value"] for m in rec["means"]}}
    out["variances"] = {(m["name"], m["term"]): m["value"]
                        for m in rec["variances"] or ()}
    return out


def _saved_rel_err(a: dict, b: dict) -> float:
    keys = set(a) | set(b)
    scale = max((abs(v) for v in b.values()), default=0.0)
    diff = max((abs(a.get(k, 0.0) - b.get(k, 0.0)) for k in keys), default=0.0)
    return diff / max(scale, 1e-30)


def phase_training_driver(torch, cs, dev, ref_dev, root: str, inputs: dict) -> dict:
    """Train on ``root/data.avro`` with the port's training driver on
    ``dev`` and ``ref_dev`` (fixed-effect logistic L-BFGS, SIMPLE
    variances), compare the saved models, then score ``dev``'s model with
    the port's scoring driver on ``dev``. Returns the launches of the
    ``dev`` training run under ``launches``."""
    from photon_tpu_torch.cli import game_scoring_driver, game_training_driver
    from photon_tpu_torch.io.avro import read_records

    spec = "fixed:type=fixed,shard=global,reg=L2,reg_weights=1,max_iter=20,variance=SIMPLE"
    runs, launches = {}, None
    for d in (dev, ref_dev):
        dest = os.path.join(root, f"train_{d.type}")
        cs.reset_launch_counts()
        t0 = time.perf_counter()
        summary = game_training_driver.run([
            "--train-data", os.path.join(root, "data.avro"),
            "--output-dir", dest, "--task", "LOGISTIC_REGRESSION",
            "--coordinate", spec, "--index-dir", os.path.join(root, "out", "index"),
            "--device", d.type,
        ])
        wall = time.perf_counter() - t0
        if d == dev:
            launches = cs.launch_counts()
        runs[d.type] = {"wall_s": wall, "fit_seconds": summary["fit_seconds"],
                        **_stage_seconds(os.path.join(dest, "photon.log"))}
    a = _read_fixed(os.path.join(root, f"train_{dev.type}", "best"))
    b = _read_fixed(os.path.join(root, f"train_{ref_dev.type}", "best"))
    errs = {k: _saved_rel_err(a[k], b[k]) for k in ("means", "variances")}
    for k, e in errs.items():
        if not e <= DRIVER_COEF_RTOL_F32 or not b[k]:
            raise AssertionError(f"saved {k} differ between devices: {e}")

    dest = os.path.join(root, f"score_trained_{dev.type}")
    summary = game_scoring_driver.run([
        "--data", os.path.join(root, "data.avro"),
        "--model-dir", os.path.join(root, f"train_{dev.type}", "best"),
        "--output-dir", dest, "--device", dev.type,
    ])
    recs = read_records(os.path.join(dest, "scores.avro"))
    scores = np.array([r["predictionScore"] for r in recs])
    if summary["n_rows"] != inputs["rows"] or not np.isfinite(scores).all():
        raise AssertionError("scoring the trained model failed")
    return {"rows": inputs["rows"], "coefficients": len(a["means"]),
            "saved_rel_err_vs_ref": errs, "runs": runs,
            "scoring": {"score_std": float(scores.std()),
                        **_stage_seconds(os.path.join(dest, "photon.log"))},
            "launches": launches}


# ------------------------------------------------------------------ main


KERNEL_SYMBOLS = {"ell_panel_kernel": "ell_panel_matvec",
                  "ell_matvec_kernel": "ell_matvec",
                  "csc_tile_kernel": "csc_rmatvec", "csc_fixup_kernel": "csc_fixup"}


def ptxas_usage(log: str) -> dict:
    """Registers, shared memory (static bytes) and spills of each compiled
    kernel, from nvcc's ``-Xptxas -v`` log, keyed ``name<type>`` (the
    transposes' tile kernel as ``csc_rmatvec<f32>`` and
    ``csc_sq_rmatvec<f32>``)."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = None
            k = re.search(r"(ell_panel_kernel|ell_matvec_kernel|csc_tile_kernel|"
                          r"csc_fixup_kernel)I([fd])E?(Lb([01])E)?", m.group(1))
            if k:
                name = KERNEL_SYMBOLS[k.group(1)]
                if k.group(4) == "1":
                    name = "csc_sq_rmatvec"
                current = f"{name}<{'f32' if k.group(2) == 'f' else 'f64'}>"
                out[current] = {}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[current].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[current]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[current]["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "photon_tpu_torch")):
        print("chip_smoke: photon_tpu_torch/ is not beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script measures "
              "the port on the card and has no CPU mode", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from photon_tpu_torch.device import resolve_device
    from photon_tpu_torch.ops import cuda_sparse as cs

    t_start = time.perf_counter()
    dev, cpu = resolve_device(), torch.device("cpu")
    card = card_line()
    build = cs.build_library()
    os.makedirs(WORK, exist_ok=True)
    emit({"phase": "card", "nvidia_smi": card,
          "kind": torch.cuda.get_device_name(0), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build["seconds"],
          "built": build["built"], "library": os.path.relpath(build["path"], REPO),
          "ptxas": ptxas_usage(build["log"])})

    kern = phase_kernels(torch, dev)
    emit({"phase": "kernels", **kern})

    cs.reset_launch_counts()
    tr = phase_transformer(torch, FULL, dev, cpu)
    tr_launches = cs.launch_counts()
    tr["breakdown_s"] = transform_breakdown(torch, FULL, dev)
    emit({"phase": "transformer", "launches": tr_launches, **tr})
    if tr_launches["ell_panel_matvec"] < 1:
        raise AssertionError("transformer phase never launched ell_panel_matvec")

    inputs = write_driver_inputs(torch, FULL, WORK)
    emit({"phase": "driver_inputs", **inputs})
    cs.reset_launch_counts()
    dr = phase_driver(torch, FULL, dev, cpu, WORK, inputs)
    dr_launches = cs.launch_counts()
    # build_panels' rule for the driver's rows (f32)
    nnz = (FULL["k_global"] + FULL["k_user"]) * inputs["rows"]
    chosen = ("ell_panel_matvec" if cs.panels_pay_off(inputs["rows"], inputs["dim"], nnz, 4)
              else "ell_matvec")
    emit({"phase": "driver", "launches": dr_launches, "matvec_kernel": chosen, **dr})
    if dr_launches[chosen] < 1:
        raise AssertionError(f"driver phase never launched {chosen}")

    tn = phase_training(torch, cs, TRAIN, SMALL, dev, cpu)
    tn_launches = tn.pop("launches")
    emit({"phase": "training", "launches": tn_launches, **tn})

    td = phase_training_driver(torch, cs, dev, cpu, WORK, inputs)
    td_launches = td.pop("launches")
    emit({"phase": "training_driver", "launches": td_launches,
          "matvec_kernel": chosen, **td})
    for name in (chosen, "csc_rmatvec", "csc_sq_rmatvec"):
        if td_launches[name] < 1:
            raise AssertionError(f"training driver phase never launched {name}")

    sources = "photon_tpu_torch/csrc/ell_sparse.cu"
    by_phase = {"transformer": tr_launches, "driver": dr_launches,
                "training": tn_launches, "training_driver": td_launches}
    rows = []
    for name in cs.KERNELS:
        f32 = kern["game"]["float32"]["kernels"][name]
        hot = kern["hot_dup"]["float32"]["kernels"][name]
        long = kern["long_col"]["float32"]["kernels"][name]
        rows.append({
            "name": name, "route": "cuda", "source": sources,
            "replaces": REPLACES, "via": TPU_ENTRY[name],
            "launches": sum(c[name] for c in by_phase.values()),
            "launches_by_phase": {k: c[name] for k, c in by_phase.items()},
            "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
            "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
            "max_abs_err_f64": kern["game"]["float64"]["kernels"][name]["max_abs_err"],
            "hot_dup_ms": hot["ms"], "hot_dup_library_ms": hot["library_ms"],
            "hot_dup_over_game": hot["ms"] / f32["ms"],
            "long_col_ms": long["ms"], "long_col_library_ms": long["library_ms"],
        })
    emit({"kernels": rows})
    shutil.rmtree(WORK, ignore_errors=True)
    print(f"total {time.perf_counter() - t_start:.1f}s", file=sys.stderr)
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
