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
6. GAME training with random effects (``bench.py``'s ``bench_game_scale``
   shape and data, ``_game_bundle``'s arithmetic: 100,000 users x 16 rows,
   2^14 global + 8 columns a user): ``GameEstimator.fit`` of a fixed effect
   and a per-user random effect, 2 sweeps, validated after every step with
   AUC and LOGISTIC_LOSS on a seed-3 bundle. Fit A: one shard, per-user
   weights 1 and 10 (``select_best`` picks one); its bucket solves on the
   chunked dual path. Fit B: the random effect over a ``user`` shard (user
   block + intercept), SIMPLE variances on both coordinates; full-bucket
   primal. Each in f32 on cuda twice (bit-equal asserted) and on cpu:
   every lane's final objective within 5e-3, each fixed-effect step that
   stopped at the same iteration on both devices within 1e-3 of the
   largest coefficient, validation metrics within 1e-4, the same
   configuration chosen; the final coefficients' difference and each
   bucket's summed objective are reported (see ``compare_game_fits``).
   The random-effect step alone on both devices on the same offsets: each
   bucket's summed final objective within 1e-5 (``re_step_vs_ref``). The
   random-effect step alone on the card is timed, profiled, its host syncs counted, and its f32
   solution held within 1e-3 of the same solve in f64. Both fits in f64 at
   8,192 users under a 256 MB Newton budget (fit A chunked dual at 4,096,
   as at full size; fit B full primal) and fit A at 10,000 users (full
   dual), cuda against cpu: coefficients within 1e-9 of the largest where
   both devices took every decision alike (see ``compare_f64_fits``).
   Every bucket's plan equals what the gate functions give for its shape;
   the matvec kernel and ``csc_rmatvec`` launch in every sweep,
   ``csc_sq_rmatvec`` in fit B; TF32 must be off.
7. GAME training driver: ``game_training_driver`` on phase 3's Avro data
   with a per-user random effect (weights 1 and 10, 2 sweeps), validated
   on a second Avro file with AUC and LOGISTIC_LOSS, on cuda and cpu; saved
   models (1e-3 of the largest), evaluations (1e-4) and the chosen
   configuration agree; the card's best model is scored by the port's
   scoring driver with ``--evaluators AUC``.

8. GAME training on the vmapped tier (phase ``game_training_vmapped``; fit
   A's shape and data, 15 iterations, 2 sweeps, validated as phase 6):
   fit C, STANDARDIZATION (an intercept on the global shard), L-BFGS L2 on
   both coordinates, the random effect per user over the global shard,
   down-sampling 0.5 on both: vmapped L-BFGS over 100,000 lanes; fit D,
   the random effect over the ``user`` shard with OWL-QN L1: vmapped
   OWL-QN; fit E, SCALE_WITH_MAX_MAGNITUDE, TRON L2 on both over the
   ``user`` shard, SIMPLE variances: vmapped TRON. Each on the card twice
   (bit-equal asserted) with its plans against the gates'; the
   random-effect step alone timed, profiled, its syncs against the lane
   loops' fetches (asserted no more) and its kernels counted; at 8,192
   users on cuda and cpu, in f32 the lanes' objective at one point (value
   and gradient; ``vm_point_gap``) and fits D's and E's final lane
   objectives, in f64 the coefficients (``compare_f64_fits`` for fits D
   and E; fit C to a fixed bound set from how far the JAX package's own
   fit C moves, ``VM_F64_RTOL_FIT_C``), each held to a bound set from
   readings.
   ``ell_matvec`` where the path runs it, fit C's block-diagonal lanes and
   the drivers' 32,768 rows: against its plain version in f32 and f64,
   bit-equal on repeat, timed beside cuSPARSE. Reported only (no routing
   change): ``ell_panel_matvec`` over fit C's lanes at ``build_panels``'
   sizes, and ``csc_rmatvec`` / ``csc_sq_rmatvec`` at fit C's and fit E's
   lane layouts, each beside its bound and cuSPARSE; the kernels' device
   time in each random-effect step, by kernel.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Model weights and data are random, made
from fixed seeds. Work files go to ``photon_tpu_torch/_build/chip_smoke/``
and are removed on success; nvcc's log stays beside the built library.
"""
from __future__ import annotations

import contextlib
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


def host_us(torch, fn, reps=2000) -> float:
    """Host microseconds a call of ``fn`` (host clock over back-to-back
    calls, no synchronize inside): what a launch-bound call costs."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def process_state() -> dict:
    """What in this process can slow Python on the host: trace and profile
    hooks, live threads, the garbage collector's counts and tracked
    objects."""
    import gc
    import threading

    return {"trace_hook": sys.gettrace() is not None,
            "profile_hook": sys.getprofile() is not None,
            "threads": threading.active_count(), "gc_counts": gc.get_count(),
            "gc_tracked": len(gc.get_objects())}


def time_pair(torch, fn, other, rounds=3) -> tuple:
    """``time_ms`` of ``fn`` and of ``other`` in alternating turns (fn,
    other, other, fn, ...): the median of each over ``rounds``. Two calls
    compared in turns see the same host and card, which matters where a
    call's time is its host work."""
    a, b = [], []
    for r in range(rounds):
        for f, out in ((fn, a), (other, b)) if r % 2 == 0 else ((other, b), (fn, a)):
            out.append(time_ms(torch, f))
    return statistics.median(a), statistics.median(b)


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
    ds, t_build = timed(lambda: build_re_dataset_from_bundle(bundle, cfg,
                                                           for_scoring=True))
    _, t_score = timed(lambda: model["perUser"].score_new_dataset(ds))
    return {"fixed_attach": t_attach, "fixed_matvec": t_fixed,
            "re_dataset_build": t_build,
            "re_project_and_score": t_score}


def feature_names(sizes) -> list:
    """The index's feature keys: the intercept, ``g``/j for the global
    block and ``u``/<user>_j for the user blocks, in column order."""
    from photon_tpu_torch.index.index_map import INTERCEPT_NAME, feature_key

    names = [feature_key(INTERCEPT_NAME, "")]
    names += [feature_key("g", str(j)) for j in range(sizes["d_global"])]
    names += [feature_key("u", f"{u}_{j}") for u in range(sizes["n_users"])
              for j in range(sizes["d_user"])]
    return names


def write_game_avro(sizes, path: str, rows_per_user: int, seed: int,
                    label_seed: int, uid_prefix: str) -> int:
    """Rows laid out by ``game_arrays`` (intercept in column 0) as Avro
    training examples with coin-flip labels and small offsets; returns the
    row count."""
    from photon_tpu_torch.io.avro import ContainerWriter
    from photon_tpu_torch.io.schemas import TRAINING_EXAMPLE_AVRO

    idx, val, dim, users, keys = game_arrays(
        col0=1, seed=seed, **dict(sizes, rows_per_user=rows_per_user))
    name_term = [n.split("\x01") for n in feature_names(sizes)]
    assert len(name_term) == dim
    rng = np.random.default_rng(label_seed)
    with ContainerWriter(path, TRAINING_EXAMPLE_AVRO) as w:
        for r in range(len(users)):
            w.write({
                "uid": f"{uid_prefix}{r}",
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
    return len(users)


def write_driver_inputs(torch, sizes, root: str) -> dict:
    """Avro data, index store and model directory, written by the port's
    own writers: ``root/data.avro``, ``root/out/index/global``,
    ``root/out/best``."""
    from photon_tpu_torch.index.index_map import (
        DefaultIndexMap,
        MmapIndexMap,
        build_mmap_index,
    )
    from photon_tpu_torch.io.convert import game_model_from_numpy
    from photon_tpu_torch.io.data_reader import FeatureShardConfig
    from photon_tpu_torch.io.model_io import save_game_model

    t0 = time.perf_counter()
    index_dir = os.path.join(root, "out", "index", "global")
    build_mmap_index(DefaultIndexMap(feature_names(sizes)), index_dir)
    imap = MmapIndexMap(index_dir)
    t_index = time.perf_counter() - t0

    t0 = time.perf_counter()
    n = write_game_avro(sizes, os.path.join(root, "data.avro"),
                        sizes["driver_rows_per_user"], seed=3, label_seed=8,
                        uid_prefix="r")
    t_data = time.perf_counter() - t0

    t0 = time.perf_counter()
    model = game_model_from_numpy(
        model_spec(intercept=True, **sizes), torch.device("cpu"), torch.float32)
    save_game_model(os.path.join(root, "out", "best"), model, {"global": imap},
                    {"fixed": "global", "perUser": "global"},
                    {"global": FeatureShardConfig(("features",), True)})
    t_model = time.perf_counter() - t0
    return {"rows": n, "dim": len(feature_names(sizes)), "write_index_s": t_index,
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
    out["profile"] = device_busy(torch, lambda: problem.run(batch, w0), wall,
                                 OUR_KERNELS)
    _, sites = counted_syncs(torch, lambda: problem.run(batch, w0))
    syncs = sum(sites.values())
    out.update(syncs=syncs, syncs_per_iteration=syncs / max(r.iterations, 1))
    return out


def device_busy(torch, fn, wall: float, ours=()) -> dict:
    """``fn()`` once under ``torch.profiler``: the device kernels it ran,
    their device time and its share of ``wall`` (a host-clock time of the
    same work); with ``ours``, the same for the kernels whose names hold
    one of those strings."""
    from torch.profiler import ProfilerActivity, profile

    mine = total = 0.0
    count = 0
    by_kernel: dict = {}
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if "CUDA" not in str(getattr(ev, "device_type", "")):
                continue
            us = getattr(ev, "self_device_time_total", None)
            us = ev.self_cuda_time_total if us is None else us
            total += us
            count += ev.count
            hit = [k for k in ours if k in ev.key]
            if hit:
                mine += us
                by_kernel[hit[0]] = by_kernel.get(hit[0], 0.0) + us
    except Exception as e:  # noqa: BLE001 - the profiler is untried here
        return {"error": f"{type(e).__name__}: {e}"}
    out = {"device_kernels": count, "device_us": total,
           "device_busy_share": total / (wall * 1e6)}
    if ours:
        out.update(port_kernels_us=mine, port_kernel_share=mine / (wall * 1e6),
                   port_kernels_of_device_time=mine / max(total, 1e-30),
                   port_kernel_us_by_name=by_kernel)
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


# ------------------------------------------------------------------ GAME training

# bench.py's bench_game_scale shape (bench.py:2866-2898): 100,000 users x 16
# rows, 2^14 global columns + 8 per user, 12 global and 4 per-user entries.
GAME = dict(n_users=100_000, rows_per_user=16, d_global=1 << 14, d_user=8,
            iterations=15)
# f64 fits, cuda against cpu, at 8,192 users under a 256 MB Newton budget:
# between the f64 dual need of a 4,096-entity chunk (170 MB at S=16, P=256)
# and of the whole bucket (341 MB), so fit A takes the main path's chunked
# dual at 4,096 and fit B (72 MB) stays full-bucket primal.
GAME_F64_USERS = 8192
GAME_F64_BUDGET_MB = 256
# f64 coefficients, cuda against cpu, of a configuration in which both
# devices took every decision alike (each Newton lane's iterations and
# reason, each L-BFGS step's iterations, reason and data passes); where a
# decision differs (a lane ends one iteration apart on a convergence test
# that f64 rounding decides), the configuration is held to the second bound
# (one such lane read 4.0e-9 on an NVIDIA H100 80GB HBM3 at 700 W).
GAME_COEF_RTOL_F64 = 1e-9
GAME_COEF_RTOL_F64_SPLIT = 1e-6
# A bucket's summed final objective, cuda against cpu, of the random-effect
# step on the same offsets (``re_step_vs_ref``). At the end of a fit the
# sums are reported only: where an f32 fixed-effect step stopped an
# iteration apart on the two devices the random effects saw other offsets.
# Readings on an NVIDIA H100 80GB HBM3 at 700 W: 1.3e-8 (fit A) and 1.2e-8
# (fit B) on the same offsets; 1.4e-5 at the end of fit A, whose second
# fixed-effect step stopped at 13 and 14 iterations.
RE_OBJ_RTOL_F32 = 1e-5
# A lane's final objective, cuda against cpu, |fa - fb| / max(|fb|, 1). The
# lanes see the fixed effect's offsets, so its gap reaches them: 6.2e-5
# (fit A) and 2.1e-3 (fit B, whose fixed effect stopped one L-BFGS
# iteration apart on the two devices) on an NVIDIA H100 80GB HBM3 at 700 W.
LANE_OBJ_RTOL_F32 = 5e-3
METRIC_ATOL = 1e-4            # validation metrics, cuda against cpu
# f32 coefficients within 1e-3 of the largest, asserted where the two
# solves took the same decisions: the random-effect solve on the card
# against the same solve in f64 on the same offsets, and each fixed-effect
# step that took the same iterations on both devices. The final GAME
# coefficients, cuda against cpu, are reported against it.
COEF_BAR_F32 = 1e-3


@contextlib.contextmanager
def _env(name: str, value: str):
    """``os.environ[name] = value`` inside the block, restored after."""
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def game_arrays_bench(n_users, rows_per_user, d_global, d_user, seed=2, **_):
    """bench.py's ``_game_bundle`` arithmetic (no item block): 12 global
    entries and 4 of the row's user block; labels from latent weights of a
    fixed rng, shared by every ``seed``. Also the ``user`` shard: an
    intercept (column 0) plus the row's user-block entries."""
    wrng = np.random.default_rng(1234)
    wg = wrng.normal(size=d_global).astype(np.float32) * 0.5
    wu = wrng.normal(size=(n_users, d_user)).astype(np.float32) * 0.8
    rng = np.random.default_rng(seed)
    n = n_users * rows_per_user
    dim = d_global + n_users * d_user
    users = np.repeat(np.arange(n_users), rows_per_user)
    rng.shuffle(users)
    k = 12
    gi = rng.integers(0, d_global, size=(n, k)).astype(np.int32)
    gv = (rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32)
    ul = rng.integers(0, d_user, size=(n, 4))
    ui = (d_global + users[:, None] * d_user + ul).astype(np.int32)
    uv = (rng.normal(size=(n, 4)) / 2.0).astype(np.float32)
    z = (gv * wg[gi]).sum(1) + (uv * wu[users[:, None], ul]).sum(1)
    labels = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    user_idx = np.concatenate([np.zeros((n, 1), np.int32),
                               (1 + users[:, None] * d_user + ul).astype(np.int32)], 1)
    user_val = np.concatenate([np.ones((n, 1), np.float32), uv], 1)
    return {"idx": np.concatenate([gi, ui], 1), "val": np.concatenate([gv, uv], 1),
            "dim": dim, "labels": labels,
            "keys": np.array([f"u{u}" for u in users], object),
            "user_idx": user_idx, "user_val": user_val,
            "user_dim": 1 + n_users * d_user}


def game_bundle(torch, arrays, dev, dtype, offsets=None):
    from photon_tpu_torch.data.batch import SparseFeatures
    from photon_tpu_torch.io.data_reader import GameDataBundle

    def sf(i, v, d):
        return SparseFeatures(torch.from_numpy(i).to(dev),
                              torch.from_numpy(v).to(dev, dtype), d)

    n = len(arrays["labels"])
    return GameDataBundle(
        features={"global": sf(arrays["idx"], arrays["val"], arrays["dim"]),
                  "user": sf(arrays["user_idx"], arrays["user_val"],
                             arrays["user_dim"])},
        labels=arrays["labels"], offsets=np.zeros(n) if offsets is None else offsets,
        weights=np.ones(n), uids=np.arange(n).astype(object),
        id_tags={"userId": arrays["keys"]})


def game_estimator(re_shard: str, n_sweeps: int, evaluators=("AUC", "LOGISTIC_LOSS")):
    from photon_tpu_torch.estimators.config import (
        FixedEffectDataConfig,
        RandomEffectDataConfig,
    )
    from photon_tpu_torch.estimators.game_estimator import GameEstimator
    from photon_tpu_torch.types import TaskType

    return GameEstimator(
        TaskType.LOGISTIC_REGRESSION,
        {"fixed": FixedEffectDataConfig("global"),
         "perUser": RandomEffectDataConfig("userId", re_shard)},
        n_sweeps=n_sweeps, evaluator_specs=evaluators,
        intercept_indices={"user": 0} if re_shard == "user" else None)


def game_configs(re_weights, iterations: int, variance: str) -> list:
    from photon_tpu_torch.estimators.config import GLMOptimizationConfiguration
    from photon_tpu_torch.functions.problem import VarianceComputationType
    from photon_tpu_torch.optim.regularization import (
        RegularizationContext,
        RegularizationType,
    )

    def opt(w):
        return GLMOptimizationConfiguration(
            regularization=RegularizationContext(RegularizationType.L2),
            reg_weight=w, max_iterations=iterations,
            variance_type=VarianceComputationType[variance])

    return [{"fixed": opt(1.0), "perUser": opt(w)} for w in re_weights]


class _StepLaunches:
    """Kernel launch counts at the end of every coordinate step: a logging
    handler on the descent's logger, which logs once per step."""

    def __init__(self, cs):
        import logging

        self.cs, self.snaps = cs, []
        self.handler = logging.Handler()
        self.handler.emit = lambda rec: self.snaps.append(
            (rec.args[:2], cs.launch_counts()))
        self.logger = logging.getLogger("photon_tpu_torch.game")

    def __enter__(self):
        self.level = self.logger.level
        self.logger.setLevel(20)
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)

    def per_sweep(self) -> list:
        """Launches of each (config, sweep): deltas between snapshots."""
        out, prev = [], {k: 0 for k in self.cs.KERNELS}
        for (sweep, cid), snap in self.snaps:
            delta = {k: snap[k] - prev[k] for k in snap}
            prev = snap
            if out and out[-1]["sweep"] == sweep and cid not in out[-1]["steps"]:
                out[-1]["steps"].append(cid)
                for k, v in delta.items():
                    out[-1]["launches"][k] += v
            else:
                out.append({"sweep": sweep, "steps": [cid], "launches": delta})
        return out


def _step_solver(result) -> dict:
    """A fixed-effect step's iterations and reason; a random-effect step's
    largest Newton iteration count over its lanes."""
    if isinstance(result, (list, tuple)):
        return {"newton_iterations_max": max(
            (int(r.iterations.max().item()) for r in result if r.iterations.numel()),
            default=0)}
    return {"iterations": result.iterations, "reason": result.reason_name()}


def game_fit(torch, cs, est, train, valid, cfgs, counted=False) -> dict:
    """One ``GameEstimator.fit`` (fixed + perUser, validated after every
    step when ``valid`` is given) on the bundle's device; with ``counted``
    the kernel launches of the fit and of each sweep. A repeated fit of the
    same estimator and bundle reuses the datasets and layouts built by the
    first."""
    from photon_tpu_torch.game import newton_re
    from photon_tpu_torch.game import random_effect as re_mod

    dev = train.device
    if counted:
        cs.reset_launch_counts()
    newton_re.reset_syncs()
    with _StepLaunches(cs) as steps:
        t0 = time.perf_counter()
        results = est.fit(train, valid, cfgs)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {"fit_s": wall, "results": results,
           "buckets": re_mod.bucket_records(),
           "newton_loop_fetches": newton_re.SYNCS["newton_loop"],
           "steps": [{"config": i, "sweep": r.sweep, "coordinate": r.coordinate_id,
                      "seconds": r.seconds, **_step_solver(r.result),
                      "validation": dict(r.validation.values) if r.validation else None}
                     for i, res in enumerate(results) for r in res.tracker]}
    if counted:
        out["launches"] = cs.launch_counts()
        out["launches_per_sweep"] = steps.per_sweep()
    if valid is not None:
        from photon_tpu_torch.estimators.game_estimator import select_best
        from photon_tpu_torch.evaluation import EvaluationSuite

        best = select_best(results, EvaluationSuite.parse(list(est.evaluator_specs)))
        out["best_config"] = next(i for i, r in enumerate(results) if r is best)
    return out


def _game_tensors(result) -> list:
    """Every coefficient tensor of a GAME fit result, in a fixed order."""
    out = []
    for cid in sorted(result.model.keys()):
        m = result.model[cid]
        if hasattr(m, "bucket_coefs"):
            out += list(m.bucket_coefs) + list(m.bucket_variances or [])
        else:
            c = m.model.coefficients
            out += [c.means] + ([c.variances] if c.variances is not None else [])
    return out


def _stack_rel_err(torch, a_list, b_list) -> float:
    """max |a - b| over max |b|, across a list of tensors."""
    diff = max((a.detach().cpu().double() - b.detach().cpu().double()).abs().max().item()
               for a, b in zip(a_list, b_list))
    scale = max(b.detach().cpu().double().abs().max().item() for b in b_list)
    return diff / max(scale, 1e-30)


def _coef_errs(torch, run, ref, split_at=None) -> dict:
    """Per configuration and coordinate, max |a - b| over the largest |b|
    (random effects over all their buckets); with ``split_at``, the fixed
    effect's global block (columns below it) and per-user block apart,
    each over the whole vector's largest."""
    out = {}
    for i, (ra, rb) in enumerate(zip(run["results"], ref["results"])):
        for cid in ra.model.keys():
            ma, mb = ra.model[cid], rb.model[cid]
            if hasattr(ma, "bucket_coefs"):
                out[f"{i}/{cid}"] = _stack_rel_err(torch, ma.bucket_coefs,
                                                   mb.bucket_coefs)
                continue
            a, b = ma.model.coefficients.means, mb.model.coefficients.means
            out[f"{i}/{cid}"] = _stack_rel_err(torch, [a], [b])
            if split_at is not None:
                scale = b.detach().abs().max().item()
                for part, sl in (("global", slice(0, split_at)),
                                 ("user_block", slice(split_at, None))):
                    d = (a[sl].detach().cpu().double()
                         - b[sl].detach().cpu().double()).abs().max().item()
                    out[f"{i}/{cid}/{part}"] = d / max(scale, 1e-30)
    return out


def _fixed_steps(torch, run, ref) -> list:
    """Each fixed-effect step of both fits: iterations, reasons and data
    passes, the final objectives' relative gap and the step's coefficients'
    gap (over the largest), and the first iteration whose objectives
    differ."""
    out = []
    for i, (ra, rb) in enumerate(zip(run["results"], ref["results"])):
        for sa, sb in zip(ra.tracker, rb.tracker):
            if sa.coordinate_id != "fixed":
                continue
            a, b = sa.result, sb.result
            n = min(a.iterations, b.iterations) + 1
            va, vb = a.values[:n].double(), b.values[:n].double()
            differ = torch.nonzero(va != vb).flatten()
            out.append({"config": i, "sweep": sa.sweep,
                        "iterations": [a.iterations, b.iterations],
                        "reasons": [a.reason_name(), b.reason_name()],
                        "data_passes": [a.data_passes, b.data_passes],
                        "value_rel_err": abs(a.value - b.value) / max(abs(b.value), 1e-30),
                        "coef_rel_err": _stack_rel_err(torch, [a.x], [b.x]),
                        "first_differing_iteration":
                            int(differ[0]) if differ.numel() else None})
    return out


def _lane_path_diffs(run, ref) -> dict:
    """Lanes whose Newton iterations or converged reason differ between the
    two fits, per (configuration, sweep) random-effect step."""
    out = {}
    for i, (ra, rb) in enumerate(zip(run["results"], ref["results"])):
        for sa, sb in zip(ra.tracker, rb.tracker):
            if sa.coordinate_id == "fixed":
                continue
            n = sum(int(((x.iterations.cpu() != y.iterations.cpu())
                         | (x.converged_reason.cpu() != y.converged_reason.cpu()))
                        .sum()) for x, y in zip(sa.result, sb.result))
            out[f"{i}/{sa.sweep}"] = n
    return out


def _lane_objective_err(run, ref) -> float:
    """The largest |fa - fb| / max(|fb|, 1) over every lane of every bucket,
    at the end of each configuration's last random-effect step."""
    worst = 0.0
    for ra, rb in zip(run["results"], ref["results"]):
        la = [r for r in ra.tracker if r.coordinate_id == "perUser"][-1]
        lb = [r for r in rb.tracker if r.coordinate_id == "perUser"][-1]
        for ba, bb in zip(la.result, lb.result):
            fa, fb = ba.value.detach().cpu().double(), bb.value.detach().cpu().double()
            worst = max(worst, ((fa - fb).abs() / fb.abs().clamp(min=1.0)).max().item())
    return worst


def _bucket_sum_errs(results, ref_results) -> list:
    """Per bucket, |Σfa − Σfb| / |Σfb| of the lanes' final objectives."""
    out = []
    for a, b in zip(results, ref_results):
        fa, fb = a.value.double().sum().item(), b.value.double().sum().item()
        out.append(abs(fa - fb) / max(abs(fb), 1e-30))
    return out


def re_step_vs_ref(torch, ests, bundles, re_shard, variance, ref_result,
                   dev, ref_dev) -> dict:
    """The random-effect step of the first configuration alone on both
    devices, on the same offsets (the ``ref_dev`` fit's final fixed
    effect's scores) and the datasets the fits used: each bucket's summed
    final objective within ``RE_OBJ_RTOL_F32`` and every lane's
    |fa − fb| / max(|fb|, 1), cuda against cpu."""
    from photon_tpu_torch.functions.objective import intercept_reg_mask
    from photon_tpu_torch.game.random_effect import train_random_effects
    from photon_tpu_torch.types import TaskType

    problem = game_configs([1.0], GAME["iterations"], variance)[0]["perUser"].problem(
        TaskType.LOGISTIC_REGRESSION)
    offsets = bundles[ref_dev.type].features["global"].with_matvec_layout().matvec(
        ref_result.model["fixed"].model.coefficients.means)
    results = {}
    for d in (dev, ref_dev):
        ds = ests[d.type]._prepare_cached(bundles[d.type])["datasets"]["perUser"]
        mask = intercept_reg_mask(ds.global_dim, 0 if re_shard == "user" else None,
                                  device=d)
        results[d.type] = train_random_effects(problem, ds, offsets.to(d),
                                               global_reg_mask=mask)[1]
    sums = _bucket_sum_errs(results[dev.type], results[ref_dev.type])
    lane = max(((a.value.cpu().double() - b.value.double()).abs()
                / b.value.double().abs().clamp(min=1.0)).max().item()
               for a, b in zip(results[dev.type], results[ref_dev.type]))
    out = {"bucket_objective_rel_err": sums, "lane_objective_rel_err": lane,
           "failures": []}
    if not max(sums) <= RE_OBJ_RTOL_F32:
        out["failures"].append(f"random-effect step on the same offsets: bucket "
                               f"objectives {sums} > {RE_OBJ_RTOL_F32}")
    return out


def compare_game_fits(torch, run, ref, split_at: int) -> dict:
    """A GAME fit on the card against the same fit on the CPU. Asserted:
    every lane's final objective at the end of each configuration's last
    random-effect step (each bucket's sum is reported); each fixed-effect step
    that stopped at the same iteration on both devices within
    ``COEF_BAR_F32``; each step's validation metrics and the chosen
    configuration. The final coefficients are reported against
    ``COEF_BAR_F32``, the fixed effect's by block as well (``split_at``: its
    first per-user column): an f32 solve stops where its f32 objective
    stops resolving a change, so a step that stops an iteration apart on the
    two devices (``fixed_steps``) leaves its coefficients apart by that
    iteration's step. Every comparison is made and reported before any
    failure is raised."""
    out = {"coef_rel_err": _coef_errs(torch, run, ref, split_at),
           "coef_bar": COEF_BAR_F32,
           "fixed_steps": _fixed_steps(torch, run, ref),
           "bucket_objective_rel_err": [],
           "lane_objective_rel_err": _lane_objective_err(run, ref),
           "metric_abs_err": 0.0, "failures": []}
    out["coef_bar_met"] = max(out["coef_rel_err"].values()) <= COEF_BAR_F32
    for st in out["fixed_steps"]:
        same = st["iterations"][0] == st["iterations"][1] and \
            st["reasons"][0] == st["reasons"][1]
        if same and not st["coef_rel_err"] <= COEF_BAR_F32:
            out["failures"].append(
                f"fixed step {st['config']}/{st['sweep']}: same iterations, "
                f"coefficients {st['coef_rel_err']} apart > {COEF_BAR_F32}")
    for ra, rb in zip(run["results"], ref["results"]):
        la = [r for r in ra.tracker if r.coordinate_id == "perUser"][-1]
        lb = [r for r in rb.tracker if r.coordinate_id == "perUser"][-1]
        out["bucket_objective_rel_err"] += _bucket_sum_errs(la.result, lb.result)
    if not out["lane_objective_rel_err"] <= LANE_OBJ_RTOL_F32:
        out["failures"].append(f"lane objectives differ by "
                               f"{out['lane_objective_rel_err']} > {LANE_OBJ_RTOL_F32}")
    for sa, sb in zip(run["steps"], ref["steps"]):
        for k, v in (sa["validation"] or {}).items():
            e = abs(v - sb["validation"][k])
            out["metric_abs_err"] = max(out["metric_abs_err"], e)
            if not e <= METRIC_ATOL:
                out["failures"].append(f"validation {k} differs by {e}")
    if run.get("best_config") != ref.get("best_config"):
        out["failures"].append("the devices chose different configurations")
    return out


def compare_f64_fits(torch, run, ref) -> dict:
    """f64 GAME fits, cuda against cpu, per configuration: the coefficients'
    gap over the largest, and the decisions taken apart (Newton lanes whose
    iterations or reason differ, fixed-effect steps whose iterations,
    reason or data passes differ). Held to ``GAME_COEF_RTOL_F64`` where no
    decision differs, else to ``GAME_COEF_RTOL_F64_SPLIT``."""
    lanes = _lane_path_diffs(run, ref)
    steps = _fixed_steps(torch, run, ref)
    out = {"configs": [], "fixed_steps": steps, "lanes_on_other_paths": lanes,
           "failures": []}
    for i, (ra, rb) in enumerate(zip(run["results"], ref["results"])):
        rel = _stack_rel_err(torch, _game_tensors(ra), _game_tensors(rb))
        split_lanes = sum(n for k, n in lanes.items() if k.startswith(f"{i}/"))
        split_steps = sum(1 for st in steps if st["config"] == i and (
            len({st["iterations"][0], st["iterations"][1]}) > 1
            or len(set(st["reasons"])) > 1 or len(set(st["data_passes"])) > 1))
        lim = GAME_COEF_RTOL_F64 if not (split_lanes or split_steps) \
            else GAME_COEF_RTOL_F64_SPLIT
        out["configs"].append({"coef_rel_err": rel, "lanes_apart": split_lanes,
                               "fixed_steps_apart": split_steps, "limit": lim})
        if not rel <= lim:
            out["failures"].append(f"config {i}: f64 coefficients {rel} apart "
                                   f"({split_lanes} lanes, {split_steps} fixed "
                                   f"steps on other paths) > {lim}")
    out["coef_rel_err"] = max(c["coef_rel_err"] for c in out["configs"])
    return out


def expected_plans(problem, dataset, u_max: int, normalization=None) -> list:
    """Each bucket's static plan from the gate functions and the bucket's
    shape alone (``u_max`` from the configuration: 1 with an intercept):
    the vmapped tier where no Newton tier admits the problem (non-smooth,
    normalized) or the bucket."""
    from photon_tpu_torch.game import newton_re as nr

    norm = normalization
    plans = []
    for b in dataset.buckets:
        if nr.newton_eligible(problem, b, norm):
            plans.append(("newton_primal", None))
        elif nr.dual_eligible(problem, b, norm, u_max):
            plans.append(("newton_dual", None))
        elif nr.newton_chunk_size(problem, b, norm):
            plans.append(("newton_primal", nr.newton_chunk_size(problem, b, norm)))
        elif nr.dual_chunk_size(problem, b, norm, u_max):
            plans.append(("newton_dual", nr.dual_chunk_size(problem, b, norm, u_max)))
        else:
            plans.append(("vmapped_lbfgs", None))
    return plans


def re_step_stats(torch, est, bundle, re_shard, variance, fit_result) -> dict:
    """The random-effect step alone on the card, on the dataset the fit
    used (``est``'s preparation of ``bundle``) at the trained model's
    fixed-effect offsets: timed (host clock to a synchronize, median of 3),
    profiled (device busy share), its host syncs counted (sync debug mode)
    against the Newton loops' iterations, held against the same solve in
    f64; and the dense design's build."""
    from photon_tpu_torch.functions.objective import intercept_reg_mask
    from photon_tpu_torch.game import newton_re
    from photon_tpu_torch.game.random_effect import bucket_records, train_random_effects
    from photon_tpu_torch.types import TaskType

    dev = bundle.device
    ds = est._prepare_cached(bundle)["datasets"]["perUser"]
    problem = game_configs([1.0], GAME["iterations"], variance)[0]["perUser"].problem(
        TaskType.LOGISTIC_REGRESSION)
    mask = intercept_reg_mask(ds.global_dim, 0 if re_shard == "user" else None,
                              device=dev)
    offsets = bundle.features["global"].with_matvec_layout().matvec(
        fit_result.model["fixed"].model.coefficients.means)

    def run():
        return train_random_effects(problem, ds, offsets, global_reg_mask=mask)

    run()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    out = {"re_step_s": wall, "re_step_s_all": walls,
           "entities": ds.n_entities, "entities_per_s": ds.n_entities / wall,
           "buckets": bucket_records(),
           "plans_from_gates": expected_plans(
               problem, ds, 1 if re_shard == "user" else 0)}
    out["profile"] = device_busy(torch, run, wall)
    newton_re.reset_syncs()
    _, sites = counted_syncs(torch, run)
    syncs = sum(sites.values())
    out["sync_sites"] = dict(list(sites.items())[:6])
    iters = sum(max(r["newton_iterations_max"], 1) for r in bucket_records())
    chunks = sum(-(-r["entities"] // (r["chunk"] or r["entities"]))
                 for r in bucket_records())
    out.update(syncs=syncs, newton_loop_fetches=newton_re.SYNCS["newton_loop"],
               newton_iterations_slowest_lane_per_bucket=iters, solves=chunks,
               syncs_per_newton_fetch=syncs / max(newton_re.SYNCS["newton_loop"], 1))
    # The solver alone against the same solve in f64 on the card, on the
    # same offsets: the f32 solve's own distance from the optimum it
    # approximates, without the fixed effect's.
    import dataclasses

    ds64 = dataclasses.replace(ds, buckets=tuple(
        dataclasses.replace(b, **{f.name: (getattr(b, f.name).double()
                                           if getattr(b, f.name).is_floating_point()
                                           else getattr(b, f.name))
                                  for f in dataclasses.fields(b)})
        for b in ds.buckets))
    model, results = run()
    records = bucket_records()
    model_64, results_64 = train_random_effects(
        problem, ds64, offsets.double(),
        global_reg_mask=None if mask is None else mask.double())
    err = _stack_rel_err(torch, model.bucket_coefs, model_64.bucket_coefs)
    lane = max(((a.value.double() - b.value).abs() / b.value.abs().clamp(min=1.0))
               .max().item() for a, b in zip(results, results_64))
    out["solver_vs_f64"] = {"coef_rel_err": err, "lane_objective_rel_err": lane,
                            "f64_buckets": bucket_records()}
    # the dense design of one solve's batch (a chunk, or the whole bucket)
    big = max(range(len(ds.buckets)), key=lambda i: ds.buckets[i].n_entities)
    b = ds.buckets[big]
    n = records[big]["chunk"] or b.n_entities
    batch = b.local_batches(offsets)
    part = newton_re._slice_pad_batches(batch, 0, min(n, b.n_entities), n)
    newton_re._dense_design(part, torch.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    newton_re._dense_design(part, torch.float32)
    torch.cuda.synchronize()
    out["dense_design"] = {"entities": n, "shape": [n, b.max_samples, b.local_dim + 1],
                           "s": time.perf_counter() - t0}
    return out


GAME_FITS = (("fit_a", "global", (1.0, 10.0), "NONE"),
             ("fit_b", "user", (1.0,), "SIMPLE"))


def phase_game_training(torch, cs, sizes, f64_users, dev, ref_dev,
                        f64_users_full_dual=10_000) -> dict:
    """GAME training with random effects through ``GameEstimator.fit``.

    Fit A (``bench_game_scale``'s shape, one shard): fixed + perUser, L2
    weight 1 and per-user weights 1 and 10, ``sizes['iterations']``
    iterations, 2 sweeps, validated on a seed-3 bundle with AUC and
    LOGISTIC_LOSS. Fit B: the same users, the random effect over the
    ``user`` shard (user block + intercept), SIMPLE variances on both
    coordinates. Each in f32 on ``dev`` twice (bit-equality asserted) and
    on ``ref_dev`` at the full size (the f32 bounds of
    ``compare_game_fits`` hold where the devices' fixed effects start
    alike: at 8,192 users the f32 fixed effect's first step already stops
    an iteration apart between the devices); each again in f64 at ``f64_users`` users on both devices under a
    ``GAME_F64_BUDGET_MB`` Newton budget, so that fit A solves chunked on
    the dual path as at full size; and fit A in f64 at
    ``f64_users_full_dual`` users under the default budget. Returns the
    counted fits' launches under ``launches``."""
    arrays = game_arrays_bench(seed=2, **sizes)
    varrays = game_arrays_bench(seed=3, **sizes)
    it = sizes["iterations"]
    out: dict = {"shape": {k: sizes[k] for k in ("n_users", "rows_per_user",
                                                  "d_global", "d_user")},
                 "rows": len(arrays["labels"]),
                 "tf32_matmul": torch.backends.cuda.matmul.allow_tf32}
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the f32 products need true f32")
    launches, failures = {}, []
    data = {d.type: (game_bundle(torch, arrays, d, torch.float32),
                     game_bundle(torch, varrays, d, torch.float32))
            for d in (dev, ref_dev)}
    for name, shard, weights, variance in GAME_FITS:
        cfgs = game_configs(weights, it, variance)
        est = {d.type: game_estimator(shard, 2) for d in (dev, ref_dev)}
        first = game_fit(torch, cs, est[dev.type], *data[dev.type], cfgs,
                         counted=True)
        second = game_fit(torch, cs, est[dev.type], *data[dev.type], cfgs)
        ref = game_fit(torch, cs, est[ref_dev.type], *data[ref_dev.type], cfgs)
        bit_equal = all(
            torch.equal(a, b) for ra, rb in zip(first["results"], second["results"])
            for a, b in zip(_game_tensors(ra), _game_tensors(rb)))
        if not bit_equal:
            failures.append(f"{name}: two f32 card fits differ")
        cmp = compare_game_fits(torch, first, ref, sizes["d_global"])
        cmp["re_step_same_offsets"] = re_step_vs_ref(
            torch, est, {d.type: data[d.type][0] for d in (dev, ref_dev)}, shard,
            variance, ref["results"][0], dev, ref_dev)
        failures += [f"{name}: {f}" for f in cmp["failures"]
                     + cmp["re_step_same_offsets"].pop("failures")]
        for s in first["steps"]:
            if not all(np.isfinite(v) for v in (s["validation"] or {}).values()):
                failures.append(f"{name}: non-finite validation metrics")
        launches[name] = first.pop("launches")
        if dev.type == "cuda":
            mv = ("ell_panel_matvec", "ell_matvec")
            for sw in first["launches_per_sweep"]:
                if not (sum(sw["launches"][k] for k in mv) and sw["launches"]["csc_rmatvec"]):
                    failures.append(f"{name}: a sweep launched no matvec or "
                                    f"csc_rmatvec: {sw}")
            if name == "fit_b" and launches[name]["csc_sq_rmatvec"] < 1:
                failures.append("fit B never launched csc_sq_rmatvec")
        stats = (re_step_stats(torch, est[dev.type], data[dev.type][0], shard,
                               variance, first["results"][0])
                 if dev.type == "cuda" else None)
        if stats is not None and not stats["solver_vs_f64"]["coef_rel_err"] <= COEF_BAR_F32:
            failures.append(f"{name}: the f32 random-effect solve is "
                            f"{stats['solver_vs_f64']['coef_rel_err']} from the f64 "
                            f"solve on the same offsets (> {COEF_BAR_F32})")
        plans = [(r["solver"], r["chunk"]) for r in first["buckets"]]
        out[name] = {
            "re_shard": shard, "re_weights": weights, "variance": variance,
            "fit_s": {"run": first["fit_s"], "repeat": second["fit_s"],
                      "ref": ref["fit_s"]},
            "steps": first["steps"], "ref_steps": ref["steps"],
            "buckets": first["buckets"], "plans": plans,
            "best_config": first.get("best_config"),
            "newton_loop_fetches": first["newton_loop_fetches"],
            "launches_per_sweep": first["launches_per_sweep"],
            "bit_equal_repeat": bit_equal, "vs_ref": cmp, "re_step": stats}
        del est, first, second, ref

    del data
    # fit A in f64 at 10,000 users under the default budget (full dual): no
    # decision may differ, so the bound holds without exception
    ten = game_arrays_bench(seed=2, **dict(sizes, n_users=f64_users_full_dual))
    f64 = {d.type: game_fit(torch, cs, game_estimator("global", 2, ()),
                            game_bundle(torch, ten, d, torch.float64), None,
                            game_configs((1.0,), it, "NONE"))
           for d in (dev, ref_dev)}
    rel = _stack_rel_err(torch, _game_tensors(f64[dev.type]["results"][0]),
                         _game_tensors(f64[ref_dev.type]["results"][0]))
    out["fit_a_f64_full_dual"] = {
        "users": f64_users_full_dual, "coef_rel_err_vs_ref": rel,
        "fit_s": {k: v["fit_s"] for k, v in f64.items()},
        "plans": [(r["entities"], r["solver"], r["chunk"])
                  for r in f64[dev.type]["buckets"]]}
    if not rel <= GAME_COEF_RTOL_F64:
        failures.append(f"fit A f64 at {f64_users_full_dual} users: coefficients "
                        f"differ by {rel}")
    small = game_arrays_bench(seed=2, **dict(sizes, n_users=f64_users))
    with _env("PHOTON_RE_NEWTON_BUDGET_MB", str(GAME_F64_BUDGET_MB)):
        for name, shard, weights, variance in GAME_FITS:
            cfgs = game_configs(weights, it, variance)
            f64 = {d.type: game_fit(torch, cs, game_estimator(shard, 2, ()),
                                    game_bundle(torch, small, d, torch.float64),
                                    None, cfgs)
                   for d in (dev, ref_dev)}
            cmp = compare_f64_fits(torch, f64[dev.type], f64[ref_dev.type])
            failures += [f"{name} f64: {f}" for f in cmp.pop("failures")]
            out[f"{name}_f64"] = {
                "users": f64_users, "budget_mb": GAME_F64_BUDGET_MB,
                "coef_rel_err_vs_ref": cmp.pop("coef_rel_err"), "vs_ref": cmp,
                "fit_s": {k: v["fit_s"] for k, v in f64.items()},
                "plans": {k: [(r["entities"], r["solver"], r["chunk"])
                              for r in v["buckets"]] for k, v in f64.items()}}
    if failures:
        emit({"phase": "game_training", **{k: v for k, v in out.items()
                                            if k != "launches"}})
        raise AssertionError("; ".join(failures))
    out["launches"] = launches
    return out


def _read_random(path: str, cid: str = "perUser") -> dict:
    from photon_tpu_torch.io.avro import read_records

    out = {}
    for rec in read_records(os.path.join(path, "random-effect", cid, "part-00000.avro")):
        for m in rec["means"]:
            out[(rec["modelId"], m["name"], m["term"])] = m["value"]
    return out


def check_game_plans(gt: dict) -> None:
    """Fit A's large bucket solves chunked on the dual path and fit B's
    buckets whole on the primal path, every plan is the one the gate
    functions compute from the bucket's shape, and the f64 fits at
    ``GAME_F64_USERS`` users take the same plans."""
    for name in ("fit_a", "fit_b"):
        st = gt[name]["re_step"]
        got = [(r["solver"], r["chunk"]) for r in st["buckets"]]
        if got != [tuple(p) for p in st["plans_from_gates"]] or got != gt[name]["plans"]:
            raise AssertionError(f"{name}: plans {got} are not the gates' "
                                 f"{st['plans_from_gates']}")
    big = max(gt["fit_a"]["buckets"], key=lambda r: r["entities"])
    if (big["solver"], big["chunk"]) != ("newton_dual", 4096):
        raise AssertionError(f"fit A's bucket did not take chunked dual: {big}")
    if any(r["solver"] != "newton_primal" or r["chunk"] is not None
           for r in gt["fit_b"]["buckets"]):
        raise AssertionError(f"fit B did not take full primal: {gt['fit_b']['buckets']}")
    # the f64 fits at 8,192 users under GAME_F64_BUDGET_MB take the same
    # plans on both devices
    if [tuple(p[1:]) for p in gt["fit_a_f64_full_dual"]["plans"]] != [("newton_dual", None)]:
        raise AssertionError(f"fit A f64 at 10,000 users: plans "
                             f"{gt['fit_a_f64_full_dual']['plans']}")
    for d, plans in gt["fit_a_f64"]["plans"].items():
        if tuple(max(plans)[1:]) != ("newton_dual", 4096):
            raise AssertionError(f"fit A f64 on {d}: plans {plans}")
    for d, plans in gt["fit_b_f64"]["plans"].items():
        if any(tuple(p[1:]) != ("newton_primal", None) for p in plans):
            raise AssertionError(f"fit B f64 on {d}: plans {plans}")


def phase_game_training_driver(torch, cs, sizes, dev, ref_dev, root: str,
                               inputs: dict) -> dict:
    """The port's training driver with a random effect on ``root/data.avro``
    (fixed + perUser, per-user weights 1 and 10, 2 sweeps), validated on
    ``root/valid.avro`` with AUC and LOGISTIC_LOSS, on ``dev`` and
    ``ref_dev``; the saved models and summaries agree; ``dev``'s best model
    is scored by the port's scoring driver with ``--evaluators AUC``.
    Returns the launches of the ``dev`` run under ``launches``."""
    from photon_tpu_torch.cli import game_scoring_driver, game_training_driver

    # Validation rows from other seeds, a quarter as many a user (the
    # per-record Avro reader is pure Python).
    t0 = time.perf_counter()
    n_valid = write_game_avro(sizes, os.path.join(root, "valid.avro"),
                              max(1, sizes["driver_rows_per_user"] // 4),
                              seed=4, label_seed=10, uid_prefix="v")
    write_s = time.perf_counter() - t0
    specs = ["fixed:type=fixed,shard=global,reg=L2,reg_weights=1,max_iter=20",
             "perUser:type=random,re_type=userId,shard=global,reg=L2,"
             "reg_weights=1|10,max_iter=20"]
    runs, summaries, launches = {}, {}, None
    for d in (dev, ref_dev):
        dest = os.path.join(root, f"game_train_{d.type}")
        cs.reset_launch_counts()
        t0 = time.perf_counter()
        summaries[d.type] = game_training_driver.run([
            "--train-data", os.path.join(root, "data.avro"),
            "--validation-data", os.path.join(root, "valid.avro"),
            "--evaluators", "AUC", "LOGISTIC_LOSS",
            "--output-dir", dest, "--task", "LOGISTIC_REGRESSION",
            "--coordinate", specs[0], "--coordinate", specs[1], "--sweeps", "2",
            "--index-dir", os.path.join(root, "out", "index"),
            "--re-routing", "static", "--device", d.type,
        ])
        runs[d.type] = {"wall_s": time.perf_counter() - t0,
                        "fit_seconds": summaries[d.type]["fit_seconds"],
                        **_stage_seconds(os.path.join(dest, "photon.log"))}
        if d == dev:
            launches = cs.launch_counts()
    sa, sb = summaries[dev.type], summaries[ref_dev.type]
    if sa["best_config_index"] != sb["best_config_index"]:
        raise AssertionError("the devices chose different configurations")
    metric_err = max(abs(sa["evaluation"][k] - sb["evaluation"][k])
                     for k in sb["evaluation"])
    if not metric_err <= METRIC_ATOL:
        raise AssertionError(f"driver evaluations differ by {metric_err}")
    best = {d.type: os.path.join(root, f"game_train_{d.type}", "best")
            for d in (dev, ref_dev)}
    fa, fb = _read_fixed(best[dev.type]), _read_fixed(best[ref_dev.type])
    ra, rb = _read_random(best[dev.type]), _read_random(best[ref_dev.type])
    errs = {"fixed_means": _saved_rel_err(fa["means"], fb["means"]),
            "random_means": _saved_rel_err(ra, rb)}
    for k, e in errs.items():
        if not e <= DRIVER_COEF_RTOL_F32:
            raise AssertionError(f"saved {k} differ between devices: {e}")
    dest = os.path.join(root, f"game_score_{dev.type}")
    scored = game_scoring_driver.run([
        "--data", os.path.join(root, "valid.avro"), "--model-dir", best[dev.type],
        "--output-dir", dest, "--device", dev.type, "--evaluators", "AUC",
    ])
    if scored["n_rows"] != n_valid or not np.isfinite(scored["evaluation"]["AUC"]):
        raise AssertionError(f"scoring the trained GAME model failed: {scored}")
    return {"rows": inputs["rows"], "validation_rows": n_valid,
            "write_validation_s": write_s, "best_config_index": sa["best_config_index"],
            "evaluation": sa["evaluation"], "evaluation_ref": sb["evaluation"],
            "metric_abs_err_vs_ref": metric_err, "saved_rel_err_vs_ref": errs,
            "random_effect_coefficients": len(ra), "runs": runs,
            "scoring": {"evaluation": scored["evaluation"],
                        **_stage_seconds(os.path.join(dest, "photon.log"))},
            "launches": launches}


# ------------------------------------------------------ GAME training, lanes

# Fits whose random-effect buckets take the vmapped tier (masked batched
# lanes, optim/lanes.py), at fit A's shape (GAME), 15 iterations, 2 sweeps:
# (name, random-effect shard, normalization, fixed (optimizer, reg),
# random (optimizer, reg), variance, down-sampling rate).
VM_FITS = (
    ("fit_c", "global", "STANDARDIZATION", ("LBFGS", "L2"), ("LBFGS", "L2"),
     "NONE", 0.5),
    ("fit_d", "user", "NONE", ("LBFGS", "L2"), ("OWLQN", "L1"), "NONE", 1.0),
    ("fit_e", "user", "SCALE_WITH_MAX_MAGNITUDE", ("TRON", "L2"), ("TRON", "L2"),
     "SIMPLE", 1.0),
)
# f32 lane objectives at the end of the last random-effect step, cuda
# against cpu at GAME_F64_USERS users, |fa - fb| / max(|fb|, 1): the lanes
# see the fixed effect's offsets, so its f32 gap reaches them. Readings on
# an NVIDIA H100 80GB HBM3 at 700 W: fit D 2.5e-4, fit E 1.1e-4. Fit C's
# (0.73) is reported, not held: its lanes end at the 15-iteration cap on
# paths that f32 rounding moves (a chaotic fit, see VM_F64_RTOL_FIT_C), so
# its end point says nothing f32 can resolve.
VM_LANE_OBJ_RTOL_F32 = {"fit_d": 2.5e-3, "fit_e": 1e-3}
# The lanes' objective at one point, cuda against cpu in f32 at
# GAME_F64_USERS users (``vm_point_gap``): per-lane values |fa - fb| /
# max(|fb|, 1), gradients max |ga - gb| over the bucket's max |gb|.
# Readings on an NVIDIA H100 80GB HBM3 at 700 W: values 9.5e-7 / 2.4e-7 /
# 2.9e-7 and gradients 3.4e-7 / 2.9e-7 / 4.0e-7 (fits C / D / E).
VM_POINT_RTOL_F32 = {"value": 1e-5, "grad": 1e-5}
# Fit C's f64 coefficients, cuda against cpu at GAME_F64_USERS users.
# STANDARDIZATION of columns this sparse gives factors up to 4.2e4 (8,192
# users) and the lanes stop at the 15-iteration cap, so the fit amplifies
# rounding. On the CPU in f64 at 8,192 users (scripts/lane_conditioning_vs_jax.py):
# offsets moved by ±1e-15 move the JAX package's own fit C 1.76e-5 and the
# port's 1.24e-4; the two packages' fits end 8.2e-4 apart, though one
# random-effect step of 15 iterations agrees within 4.7e-9 (200
# iterations: 5.0e-4, 25 lanes ending apart). The bound sits above the
# largest of these rounding-level moves. The other fits keep
# compare_f64_fits' 1e-9 / 1e-6.
VM_F64_RTOL_FIT_C = 1e-3


def vm_arrays(sizes, n_users, seed, intercept: bool):
    """``game_arrays_bench`` at ``n_users`` users; with ``intercept``, the
    global shard gains an intercept column (its last, index ``dim``) in
    every row."""
    a = game_arrays_bench(seed=seed, **dict(sizes, n_users=n_users))
    if intercept:
        n = len(a["labels"])
        a["idx"] = np.concatenate([a["idx"], np.full((n, 1), a["dim"], np.int32)], 1)
        a["val"] = np.concatenate([a["val"], np.ones((n, 1), np.float32)], 1)
        a["global_intercept"] = a["dim"]
        a["dim"] += 1
    return a


def vm_estimator(arrays, re_shard: str, normalization: str, evaluators):
    from photon_tpu_torch.estimators.config import (
        FixedEffectDataConfig,
        RandomEffectDataConfig,
    )
    from photon_tpu_torch.estimators.game_estimator import GameEstimator
    from photon_tpu_torch.types import TaskType

    intercepts = {"user": 0}
    if "global_intercept" in arrays:
        intercepts["global"] = arrays["global_intercept"]
    return GameEstimator(
        TaskType.LOGISTIC_REGRESSION,
        {"fixed": FixedEffectDataConfig("global"),
         "perUser": RandomEffectDataConfig("userId", re_shard)},
        n_sweeps=2, evaluator_specs=evaluators, normalization=normalization,
        intercept_indices=intercepts)


def vm_configs(fixed, random, variance: str, rate: float, iterations: int) -> list:
    from photon_tpu_torch.estimators.config import GLMOptimizationConfiguration
    from photon_tpu_torch.functions.problem import VarianceComputationType
    from photon_tpu_torch.optim import OptimizerType
    from photon_tpu_torch.optim.regularization import (
        RegularizationContext,
        RegularizationType,
    )

    def opt(spec):
        return GLMOptimizationConfiguration(
            optimizer_type=OptimizerType[spec[0]],
            regularization=RegularizationContext(RegularizationType[spec[1]]),
            reg_weight=1.0, max_iterations=iterations, down_sampling_rate=rate,
            variance_type=VarianceComputationType[variance])

    return [{"fixed": opt(fixed), "perUser": opt(random)}]


def _iteration_stats(results) -> dict:
    its = np.concatenate([r.iterations.cpu().numpy() for r in results]) \
        if results else np.zeros(0)
    return {"lanes": int(its.size),
            "iterations_median": float(np.median(its)) if its.size else 0.0,
            "iterations_max": int(its.max()) if its.size else 0}


def vm_step_stats(torch, cs, est, bundle, cfg, fit_result) -> dict:
    """The random-effect step alone on the card, as the fit ran it (the
    configuration's coordinate: its down-sampled dataset, normalization and
    mask) at the trained fixed effect's offsets: timed (host clock to a
    synchronize, median of 3), profiled (device busy share), its host syncs
    counted (sync debug mode) against the lane loops' fetches, the kernels
    it launched counted; lanes per second, loop iterations, iterations per
    lane."""
    from photon_tpu_torch.game.random_effect import bucket_records
    from photon_tpu_torch.optim import lanes

    prep = est._prepare_cached(bundle)
    coords = est._build_coordinates(prep, cfg, 0, None, prep["accel_cache"])
    offsets = coords["fixed"].score(fit_result.model["fixed"])
    rc = coords["perUser"]

    def run():
        return rc.train(offsets)

    run()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    n_lanes = sum(b.n_entities for b in rc.dataset.buckets)
    out = {"re_step_s": wall, "re_step_s_all": walls, "lanes": n_lanes,
           "lanes_per_s": n_lanes / wall, "buckets": bucket_records(),
           "plans_from_gates": expected_plans(
               rc.problem, rc.dataset, 0, rc.normalization)}
    out["profile"] = device_busy(torch, run, wall, OUR_KERNELS)
    lanes.reset_syncs()
    cs.reset_launch_counts()
    (_, results), sync_sites = counted_syncs(torch, run)
    out["launches"] = cs.launch_counts()
    n_syncs = sum(sync_sites.values())
    fetches = dict(lanes.SYNCS)
    # the loop of a bucket runs until its slowest lane stops
    loop_iterations = sum(r["newton_iterations_max"] for r in bucket_records())
    out.update(syncs=n_syncs, sync_sites=sync_sites,
               lane_loop_fetches=fetches, loop_iterations=loop_iterations,
               syncs_per_iteration=n_syncs / max(loop_iterations, 1),
               **_iteration_stats(results), failures=[])
    if n_syncs > sum(fetches.values()):
        out["failures"].append(
            f"the lane loops synced {n_syncs} times for "
            f"{sum(fetches.values())} loop fetches: {sync_sites}")
    mv = out["launches"]["ell_matvec"] + out["launches"]["ell_panel_matvec"]
    if not (mv and out["launches"]["csc_rmatvec"]):
        out["failures"].append(f"the lanes launched no matvec or csc_rmatvec: "
                               f"{out['launches']}")
    return out


def counted_syncs(torch, fn):
    """``fn()`` under the CUDA sync debug mode: its result and the host
    syncs the port made, each by the innermost line of the port on the
    stack where it happened (``file:line``, with the torch line for syncs
    inside torch). Syncs with no line of the port on the stack (switching
    the debug mode syncs once) are not the port's and are left out."""
    import traceback
    import warnings

    sites: dict = {}
    pkg = os.path.join(REPO, "photon_tpu_torch")
    build = os.path.join(pkg, "_build")

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()
                if f.filename.startswith(pkg) and not f.filename.startswith(build)]
        if not ours:
            return
        key = f"{os.path.relpath(ours[-1].filename, REPO)}:{ours[-1].lineno}"
        if not filename.startswith(pkg):
            key += f" ({os.path.basename(filename)}:{lineno})"
        sites[key] = sites.get(key, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return res, dict(sorted(sites.items(), key=lambda kv: -kv[1]))


def matvec_at(torch, cs, idx_np, val_np, dim, seed, dev) -> dict:
    """``ell_matvec`` on one layout where the path runs it: in f64 and f32
    against its plain version and run twice, bit-equal; in f32 its time,
    the plain version's and one cuSPARSE call's (and the kernel's ratio to
    it), its bound, its tile plan, and whether ``panels_pay_off`` would
    stage w instead."""
    n, k = idx_np.shape
    rng = np.random.default_rng(seed)
    w_np = rng.normal(size=dim)
    idx = torch.from_numpy(idx_np).to(dev)
    errs = {}
    for dtype, tdt in (("float64", torch.float64), ("float32", torch.float32)):
        val = torch.from_numpy(val_np).to(dev, tdt)
        w = torch.from_numpy(w_np).to(dev, tdt)
        got = cs.ell_matvec(idx, val, w, dim)
        again = cs.ell_matvec(idx, val, w, dim)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"ell_matvec at {n} x {k}: two runs differ ({dtype})")
        errs[dtype] = _close(torch, got, cs.ell_matvec_plain(idx, val, w, dim), dtype)
    kern = lambda: cs.ell_matvec(idx, val, w, dim)          # noqa: E731
    plain = lambda: cs.ell_matvec_plain(idx, val, w, dim)   # noqa: E731
    keep = (idx >= 0) & (idx < dim)
    crow = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    crow[1:] = torch.cumsum(keep.sum(1), 0)
    a = torch.sparse_csr_tensor(crow, idx[keep], val[keep], size=(n, dim))
    nnz = int(keep.sum().item())
    plan = cs.ell_tile_plan(k, torch.float32)
    ms, library_ms = time_pair(torch, kern, lambda: a @ w)
    host = {"wrapper": host_us(torch, kern), "library": host_us(torch, lambda: a @ w),
            "empty": host_us(torch, lambda: torch.empty(n, dtype=val.dtype, device=dev)),
            "process": process_state()}
    return {"rows": n, "k": k, "dim": dim, "nnz": nnz, "max_abs_err": errs["float32"],
            "host_us_a_call": host,
            "max_abs_err_f64": errs["float64"], "bit_equal_repeat": True,
            "tile_rows": plan.tile_rows, "group": plan.group,
            "panels_pay_off": cs.panels_pay_off(n, dim, n * k, 4),
            "ms": ms, "plain_ms": time_ms(torch, plain), "library_ms": library_ms,
            "library_ratio": ms / library_ms,
            **kernel_bound("ell_matvec", n, k, dim, nnz, "float32")}


def lane_layout_kernels(torch, cs, flat, seed, with_panels: bool) -> dict:
    """Reported, not routed: on a bucket's block-diagonal lane layout as the
    lanes run it (f32, its CSC attached), ``csc_rmatvec`` and
    ``csc_sq_rmatvec``, and with ``with_panels`` ``ell_panel_matvec`` over
    ``panel_layout`` at ``build_panels``' tile and panel sizes (where
    ``panels_pay_off`` declines it): each against its plain version, its
    time, the plain version's, one cuSPARSE call's and its bound."""
    n, k = flat.idx.shape
    dim, dev = flat.dim, flat.device
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(size=dim)).to(dev, flat.dtype)
    v = torch.from_numpy(rng.normal(size=n)).to(dev, flat.dtype)
    csc = flat.csc
    panels = (cs.panel_layout(flat.idx, flat.val, dim, cs.tile_rows_for(n),
                              cs.panel_cols(flat.dtype)) if with_panels else None)
    calls = kernel_calls(cs, flat.idx, flat.val, w, v, csc, panels, dim)
    library = library_calls(torch, flat.idx, flat.val, w, v, csc, dim)
    out = {"rows": n, "k": k, "dim": dim, "nnz": csc.nnz}
    names = ["csc_rmatvec", "csc_sq_rmatvec"] + (["ell_panel_matvec"] if panels else [])
    for name in names:
        kern, plain = calls[name]
        err = _close(torch, kern(), plain(), "float32")
        ms, library_ms = time_pair(torch, kern, library[name])
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": time_ms(torch, plain),
                     "library_ms": library_ms, "library_ratio": ms / library_ms,
                     **kernel_bound(name, n, k, dim, csc.nnz, "float32")}
    if panels is not None:
        out["ell_panel_matvec"].update(
            tile_rows=panels.tile_rows, row_tiles=panels.n_tiles, panels=panels.n_panels,
            panels_pay_off=cs.panels_pay_off(n, dim, n * k, 4),
            panel_entries=panels.codes.shape[0])
    return out


def vm_point_gap(torch, ests, bundles, cfg, ref_fit, dev, ref_dev) -> dict:
    """The objective the random-effect lanes minimize (value and gradient,
    in the transformed space through the coefficient map under
    normalization), at one point on both devices in the fits' dtype: the
    ``ref_dev`` fit's fixed-effect offsets and each bucket's lane iterate at
    the end of its last random-effect step, the same bits on each device,
    over the datasets the fits used (``ests``' preparation of
    ``bundles``). Per-lane values |fa - fb| / max(|fb|, 1), gradients max
    |ga - gb| over the bucket's max |gb|."""
    from photon_tpu_torch.game import random_effect as re_mod

    coords = {}
    for d in (dev, ref_dev):
        prep = ests[d.type]._prepare_cached(bundles[d.type])
        coords[d.type] = ests[d.type]._build_coordinates(prep, cfg, 0, None,
                                                         prep["accel_cache"])
    result = ref_fit["results"][0]
    offsets = coords[ref_dev.type]["fixed"].score(result.model["fixed"])
    last = [r for r in result.tracker if r.coordinate_id == "perUser"][-1]
    out = {"value": 0.0, "grad": 0.0, "lanes": 0, "failures": []}
    for b, res in enumerate(last.result):
        got = {}
        for d in (dev, ref_dev):
            rc = coords[d.type]["perUser"]
            mask, batches, norm = re_mod.bucket_inputs(
                rc.dataset, b, offsets.to(d), rc.global_reg_mask, rc.normalization)
            got[d.type] = (rc.dataset.buckets[b].proj.cpu(), batches.labels.cpu(),
                           *[t.cpu().double() for t in rc.problem.value_and_grad(
                               re_mod.lane_batch(rc.dataset, b, batches), mask,
                               norm)(res.x.to(d))])
        (pa, ya, fa, ga), (pb, yb, fb, gb) = got[dev.type], got[ref_dev.type]
        if not (torch.equal(pa, pb) and torch.equal(ya, yb)):
            out["failures"].append(f"bucket {b}: the devices' datasets differ")
            continue
        out["lanes"] += int(fb.numel())
        out["value"] = max(out["value"],
                           ((fa - fb).abs() / fb.abs().clamp(min=1.0)).max().item())
        out["grad"] = max(out["grad"], ((ga - gb).abs().max()
                                        / gb.abs().max().clamp(min=1e-30)).item())
    return out


def phase_game_training_vmapped(torch, cs, sizes, small_users, dev, ref_dev) -> dict:
    """GAME fits whose random-effect buckets take the vmapped tier, through
    ``GameEstimator.fit`` at ``sizes`` (fit A's shape), validated on a
    seed-3 bundle with AUC and LOGISTIC_LOSS:

    * fit C: STANDARDIZATION (the global shard gains an intercept), L-BFGS
      L2 on both coordinates, the random effect per user over the global
      shard, down-sampling 0.5 on both (the binary sampler): vmapped
      L-BFGS over every lane, on the plain ``optimize`` path;
    * fit D: the random effect over the ``user`` shard with OWL-QN and L1:
      vmapped OWL-QN;
    * fit E: SCALE_WITH_MAX_MAGNITUDE, TRON L2 on both, the random effect
      over the ``user`` shard, SIMPLE variances: vmapped TRON.

    Each in f32 on ``dev`` twice (bit-equal asserted), its plans against
    the gates', the random-effect step alone measured; then at
    ``small_users`` users on both devices, in f32 (the lanes' objective at
    one point, ``vm_point_gap``; fits D's and E's final lane objectives)
    and in f64 (``compare_f64_fits``; fit C to ``VM_F64_RTOL_FIT_C``), each
    held to a bound set from readings. Returns the counted fits' launches
    under ``launches``."""
    it = sizes["iterations"]
    out: dict = {"shape": {k: sizes[k] for k in ("n_users", "rows_per_user",
                                                  "d_global", "d_user")}}
    launches, failures = {}, []
    for name, shard, norm, fixed, random, variance, rate in VM_FITS:
        intercept = norm == "STANDARDIZATION"
        cfgs = vm_configs(fixed, random, variance, rate, it)
        arrays = vm_arrays(sizes, sizes["n_users"], 2, intercept)
        varrays = vm_arrays(sizes, sizes["n_users"], 3, intercept)
        train = game_bundle(torch, arrays, dev, torch.float32)
        valid = game_bundle(torch, varrays, dev, torch.float32)
        est = vm_estimator(arrays, shard, norm, ("AUC", "LOGISTIC_LOSS"))
        first = game_fit(torch, cs, est, train, valid, cfgs, counted=True)
        second = game_fit(torch, cs, est, train, valid, cfgs)
        bit_equal = all(
            torch.equal(a, b) for ra, rb in zip(first["results"], second["results"])
            for a, b in zip(_game_tensors(ra), _game_tensors(rb)))
        if not bit_equal:
            failures.append(f"{name}: two f32 card fits differ")
        launches[name] = first.pop("launches")
        plans = [(r["solver"], r["chunk"]) for r in first["buckets"]]
        stats = None
        if dev.type == "cuda":
            stats = vm_step_stats(torch, cs, est, train, cfgs[0], first["results"][0])
            failures += [f"{name}: {f}" for f in stats.pop("failures")]
            if plans != [tuple(p) for p in stats["plans_from_gates"]]:
                failures.append(f"{name}: plans {plans}, gates "
                                f"{stats['plans_from_gates']}")
        if any(p != ("vmapped_lbfgs", None) for p in plans):
            failures.append(f"{name}: plans {plans} are not the vmapped tier")
        for s in first["steps"]:
            if not all(np.isfinite(v) for v in (s["validation"] or {}).values()):
                failures.append(f"{name}: non-finite validation metrics")
        if dev.type == "cuda" and name == "fit_e" and launches[name]["csc_sq_rmatvec"] < 1:
            failures.append("fit E never launched csc_sq_rmatvec")
        res = {"re_shard": shard, "normalization": norm, "fixed": fixed,
               "random": random, "variance": variance, "down_sampling": rate,
               "fit_s": {"run": first["fit_s"], "repeat": second["fit_s"]},
               "steps": first["steps"], "buckets": first["buckets"],
               "plans": plans, "launches_per_sweep": first["launches_per_sweep"],
               "bit_equal_repeat": bit_equal, "re_step": stats}
        ctx = est._prepare_cached(train)["norm"]["global"]
        if ctx is not None:
            res["global_factors"] = {"min": ctx.factors.min().item(),
                                     "max": ctx.factors.max().item()}
        if name in ("fit_c", "fit_e") and dev.type == "cuda":
            ds = est._prepare_cached(train)["datasets"]["perUser"]
            big = max(range(len(ds.buckets)), key=lambda i: ds.buckets[i].n_entities)
            flat = ds.lane_features(big).flat
            if name == "fit_c":
                res["lane_matvec"] = matvec_at(
                    torch, cs, flat.idx.cpu().numpy(), flat.val.cpu().numpy(),
                    flat.dim, 12, dev)
            res["lane_layout"] = lane_layout_kernels(torch, cs, flat, 14,
                                                     with_panels=name == "fit_c")
        del train, valid, est, first, second

        # cpu reference and f64 witness at small_users users
        small = vm_arrays(sizes, small_users, 2, intercept)
        vsmall = vm_arrays(sizes, small_users, 3, intercept)
        ests = {d.type: vm_estimator(small, shard, norm, ("AUC", "LOGISTIC_LOSS"))
                for d in (dev, ref_dev)}
        bundles = {d.type: game_bundle(torch, small, d, torch.float32)
                   for d in (dev, ref_dev)}
        f32 = {d.type: game_fit(torch, cs, ests[d.type], bundles[d.type],
                                game_bundle(torch, vsmall, d, torch.float32), cfgs)
               for d in (dev, ref_dev)}
        lane_err = _lane_objective_err(f32[dev.type], f32[ref_dev.type])
        point = vm_point_gap(torch, ests, bundles, cfgs[0], f32[ref_dev.type],
                             dev, ref_dev)
        metric_err = max((abs(v - sb["validation"][k])
                          for sa, sb in zip(f32[dev.type]["steps"], f32[ref_dev.type]["steps"])
                          for k, v in (sa["validation"] or {}).items()), default=0.0)
        if name in VM_LANE_OBJ_RTOL_F32 and not lane_err <= VM_LANE_OBJ_RTOL_F32[name]:
            failures.append(f"{name}: f32 lane objectives differ by {lane_err} > "
                            f"{VM_LANE_OBJ_RTOL_F32[name]}")
        for k, lim in VM_POINT_RTOL_F32.items():
            if not point[k] <= lim:
                failures.append(f"{name}: the lanes' f32 objective {k} at one point "
                                f"differs by {point[k]} > {lim}")
        failures += [f"{name}: {f}" for f in point.pop("failures")]
        f64 = {d.type: game_fit(torch, cs, vm_estimator(small, shard, norm, ()),
                                game_bundle(torch, small, d, torch.float64), None, cfgs)
               for d in (dev, ref_dev)}
        cmp = compare_f64_fits(torch, f64[dev.type], f64[ref_dev.type])
        f64_failures = [f"{name} f64: {f}" for f in cmp.pop("failures")]
        if name == "fit_c":
            cmp["rule_1e-9_1e-6"] = f64_failures
            cmp["limit"] = VM_F64_RTOL_FIT_C
            if not cmp["coef_rel_err"] <= VM_F64_RTOL_FIT_C:
                failures.append(f"{name} f64: coefficients {cmp['coef_rel_err']} "
                                f"apart > {VM_F64_RTOL_FIT_C}")
        else:
            failures += f64_failures
        res["small"] = {
            "users": small_users,
            "f32": {"lane_objective_rel_err": lane_err,
                    "lane_objective_limit": VM_LANE_OBJ_RTOL_F32.get(name),
                    "at_one_point": point, "at_one_point_limit": VM_POINT_RTOL_F32,
                    "metric_abs_err": metric_err,
                    "fit_s": {k: v["fit_s"] for k, v in f32.items()},
                    "lanes_on_other_paths": _lane_path_diffs(f32[dev.type],
                                                             f32[ref_dev.type]),
                    "fixed_steps": _fixed_steps(torch, f32[dev.type], f32[ref_dev.type])},
            "f64": {"coef_rel_err_vs_ref": cmp.pop("coef_rel_err"), "vs_ref": cmp,
                    "fit_s": {k: v["fit_s"] for k, v in f64.items()},
                    "plans": {k: [(r["entities"], r["solver"], r["chunk"])
                                  for r in v["buckets"]] for k, v in f64.items()}}}
        out[name] = res
        del f32, f64, ests, bundles
    if dev.type == "cuda":
        # ell_matvec where it runs on the drivers' path: 32,768 rows as the
        # training and scoring drivers read them (an intercept and 32
        # entries)
        d_idx, d_val, d_dim, _, _ = game_arrays(**dict(FULL, rows_per_user=FULL[
            "driver_rows_per_user"]), col0=1)
        n = d_idx.shape[0]
        out["driver_matvec"] = matvec_at(
            torch, cs, np.concatenate([np.zeros((n, 1), np.int32), d_idx], 1),
            np.concatenate([np.ones((n, 1), np.float32), d_val], 1), d_dim, 13, dev)
    if failures:
        emit({"phase": "game_training_vmapped", **out})
        raise AssertionError("; ".join(failures))
    out["launches"] = launches
    return out


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
          "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
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

    gt = phase_game_training(torch, cs, GAME, GAME_F64_USERS, dev, cpu)
    gt_fits = gt.pop("launches")
    gt_launches = {k: sum(f[k] for f in gt_fits.values()) for k in cs.KERNELS}
    emit({"phase": "game_training", "launches": gt_launches,
          "launches_by_fit": gt_fits, **gt})
    check_game_plans(gt)

    gd = phase_game_training_driver(torch, cs, FULL, dev, cpu, WORK, inputs)
    gd_launches = gd.pop("launches")
    emit({"phase": "game_training_driver", "launches": gd_launches,
          "matvec_kernel": chosen, **gd})
    for name in (chosen, "csc_rmatvec"):
        if gd_launches[name] < 1:
            raise AssertionError(f"GAME training driver phase never launched {name}")

    vm = phase_game_training_vmapped(torch, cs, GAME, GAME_F64_USERS, dev, cpu)
    vm_fits = vm.pop("launches")
    vm_launches = {k: sum(f[k] for f in vm_fits.values()) for k in cs.KERNELS}
    emit({"phase": "game_training_vmapped", "launches": vm_launches,
          "launches_by_fit": vm_fits, **vm})

    sources = "photon_tpu_torch/csrc/ell_sparse.cu"
    by_phase = {"transformer": tr_launches, "driver": dr_launches,
                "training": tn_launches, "training_driver": td_launches,
                "game_training": gt_launches, "game_training_driver": gd_launches,
                "game_training_vmapped": vm_launches}
    status = {"ell_panel_matvec": "ported; redesigned: column panels of w staged by TMA",
              "ell_matvec": "ported; redesigned: row tiles streamed by TMA",
              "csc_rmatvec": "ported; redesigned: merge-path segmented reduction",
              "csc_sq_rmatvec": "ported; redesigned: merge-path segmented reduction"}
    rows = []
    for name in cs.KERNELS:
        f32 = kern["game"]["float32"]["kernels"][name]
        hot = kern["hot_dup"]["float32"]["kernels"][name]
        long = kern["long_col"]["float32"]["kernels"][name]
        rows.append({
            "name": name, "route": "cuda", "source": sources,
            "replaces": REPLACES, "via": TPU_ENTRY[name], "status": status[name],
            "launches": sum(c[name] for c in by_phase.values()),
            "launches_by_phase": {k: c[name] for k, c in by_phase.items()},
            "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
            "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
            "max_abs_err_f64": kern["game"]["float64"]["kernels"][name]["max_abs_err"],
            "hot_dup_ms": hot["ms"], "hot_dup_library_ms": hot["library_ms"],
            "hot_dup_over_game": hot["ms"] / f32["ms"],
            "long_col_ms": long["ms"], "long_col_library_ms": long["library_ms"],
            "library_ratio": f32["ms"] / f32["library_ms"],
            "hot_dup_library_ratio": hot["ms"] / hot["library_ms"],
            "long_col_library_ratio": long["ms"] / long["library_ms"],
        })
        if name == "ell_matvec":
            # where the path runs it: the drivers' rows and fit C's lanes
            keys = ("rows", "k", "dim", "ms", "plain_ms", "library_ms", "library_ratio",
                    "bound_ms", "bound_by", "panels_pay_off", "max_abs_err",
                    "max_abs_err_f64", "tile_rows", "group")
            rows[-1]["driver_shape"] = {k: vm["driver_matvec"][k] for k in keys}
            rows[-1]["lane_shape"] = {k: vm["fit_c"]["lane_matvec"][k] for k in keys}
        else:
            # reported at the lanes' layouts, where the path does not route
            # ell_panel_matvec and does run the transposes
            rows[-1]["lane_layouts"] = {
                fit: vm[fit]["lane_layout"][name] for fit in ("fit_c", "fit_e")
                if name in vm[fit]["lane_layout"]}
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
