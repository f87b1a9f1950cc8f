#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``photon_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA GPU

Phases, each printing one JSON line (``at_s``: seconds from the start to the
phase's end); any failure ends the run with a nonzero exit code and no
result line:

0. card: ``nvidia-smi`` name and power limit, and the kernels' build
   (``nvcc`` into ``photon_tpu_torch/_build``, from the sources here), with
   each kernel's registers, shared memory and spills from nvcc's log; the
   native Avro decoder's build (``g++``, ``photon_tpu_torch/native``).
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
   the port's own writers (same widths, 32,768 rows), scored by
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
   primal. Each in f32 on cuda twice (bit-equal asserted; fit A's second
   run is phase 9's killed and resumed fit) and on cpu:
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

9. checkpoint: phase 6's fit A (its estimator, bundles and configurations)
   with ``--checkpoint-dir``'s manager killed after its second coordinate
   step (``fail_after``) and resumed in a fresh manager: bit-identical to
   phase 6's uninterrupted fit A (coefficients, tracker records, their
   results and validation metrics); save, write and resume seconds and
   bytes a snapshot; a snapshot the JAX package wrote is refused by magic.
10. routing: fit A's random-effect coordinate on its prepared dataset at
   fit A's fixed-effect offsets, static and under
   ``PHOTON_RE_ROUTING=measured`` with a cost table: per shape class the
   candidates, per-entity costs, winner and calibration seconds; a second
   solve with the table reloaded calibrates nothing and repeats the
   decisions and coefficients bit for bit.
11. sweep_cache: fit B with host-resident random-effect buckets, 2 sweeps,
   the device sweep cache at 2048 MB and off: bit-identical models; H2D
   bytes a sweep (none in sweep 2 with the cache on), resident and spilled
   bytes, hits and misses.
12. ingest (after phase 8): FULL's widths at 128 rows a user (2^19 rows)
   written as 8 Avro files by 8 spawned writers; on phase 3's 32,768 rows
   the per-record read against the streaming read (native decoder
   asserted) and the pipelined read, bit-equal; on 2^19 rows the streaming,
   pipelined (chunks of 65,536 rows through pinned staging: H2D bytes and
   the card's busy share) and 4-worker reads, bit-equal; the scoring driver
   with ``--chunk-rows 65536`` and 0 (scores within 1e-5) and the training
   driver on the 2^19 rows, with their stage times.
13. bf16_kernels, glm_driver, bf16_feed: the kernels' bf16 entry points
   against their f32 kernels, the GLM driver in-core and out of core, and
   the GAME driver with ``--bf16-feed``, its model files byte for byte those
   of the f32 driver on bf16-rounded values (see each phase's docstring).
14. factored: a factored per-user random effect at phase 6's widths
   (``phase_factored``): its steps timed, the projection gradient bit-equal
   on repeat and against cpu, an f64 witness, the model saved and scored.
15. tuning: GP regularization tuning at BASELINE config 4's widths, killed
   after a trial and resumed bit for bit, then the training driver's
   ``--tuning gp`` with a factored random effect (``phase_tuning``).
16. runtime_guards: the backend probe (run first, before any CUDA work), a
   genuine CUDA OOM in fit A's largest random-effect bucket under a
   per-process memory cap (one tier down, bit-equal to the solve at that
   tier), an injected OOM under measured routing, the supervised GAME
   driver restarting after a preemption (byte-equal model), the GLM
   driver's out-of-core OOM re-chunking and device-loss recovery
   (bit-equal), the memory watchdog, and no guard firing unplanted
   (``phase_runtime_guards``).

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
# outside the tensor cores; bf16 values are upcast and summed as f32 / f64
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12, "bfloat16": 67e12}
VALUE_BYTES = {"float32": 4, "float64": 8, "bfloat16": 2}
REPLACES = "photon_tpu/ops/pallas_sparse.py:248"        # _gather_onehot_kernel
TPU_ENTRY = {"ell_panel_matvec": "matvec_pallas (pallas_sparse.py:331)",
             "ell_matvec": "matvec_pallas (pallas_sparse.py:331)",
             "csc_rmatvec": "rmatvec_pallas (pallas_sparse.py:313)",
             "csc_sq_rmatvec": "rmatvec_pallas(square_vals=True) (pallas_sparse.py:313)"}
RTOL_F32, ATOL_F32_REL, ATOL_F64 = 1e-5, 1e-5, 1e-12


# perf_counter at main()'s start: each phase line carries its end as "at_s"
_START = [None]


def emit(obj: dict) -> None:
    if "phase" in obj and _START[0] is not None:
        obj = {**obj, "at_s": time.perf_counter() - _START[0]}
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
    written once, over 3.35 TB/s; operations over the peak for the type.
    ``dtype`` is the values' type; bf16 values go with f32 vectors."""
    vb = VALUE_BYTES[dtype]
    xb = 8 if dtype == "float64" else 4
    if name in ("ell_matvec", "ell_panel_matvec"):
        nbytes = n * k * (4 + vb) + dim * xb + n * xb
        ops = 2 * n * k
    else:
        nbytes = (dim + 1) * 8 + nnz * (4 + vb) + n * xb + dim * xb
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
                    label_seed: int, uid_prefix: str, bf16: bool = False) -> int:
    """Rows laid out by ``game_arrays`` (intercept in column 0) as Avro
    training examples with coin-flip labels and small offsets; returns the
    row count. ``bf16`` writes the feature values rounded to bfloat16 (the
    values a ``--bf16-feed`` read of the unrounded file gives)."""
    from photon_tpu_torch.io.avro import ContainerWriter
    from photon_tpu_torch.io.schemas import TRAINING_EXAMPLE_AVRO

    idx, val, dim, users, keys = game_arrays(
        col0=1, seed=seed, **dict(sizes, rows_per_user=rows_per_user))
    if bf16:
        import torch

        val = torch.from_numpy(val).to(torch.bfloat16).float().numpy()
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
        if summary != {"n_rows": inputs["rows"], "evaluation": None,
                       "reader": "native"}:
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


def game_arrays_bench(n_users, rows_per_user, d_global, d_user, seed=2,
                      n_items=0, **_):
    """bench.py's ``_game_bundle`` arithmetic: 12 global entries and 4 of
    the row's user block, and with ``n_items`` 3 of the row's item block
    (an ``itemId`` tag); labels from latent weights of a fixed rng, shared
    by every ``seed``. Also the ``user`` shard: an intercept (column 0)
    plus the row's user-block entries."""
    wrng = np.random.default_rng(1234)
    wg = wrng.normal(size=d_global).astype(np.float32) * 0.5
    wu = wrng.normal(size=(n_users, d_user)).astype(np.float32) * 0.8
    wi = (wrng.normal(size=(n_items, d_user)).astype(np.float32) * 0.6
          if n_items else None)
    rng = np.random.default_rng(seed)
    n = n_users * rows_per_user
    dim = d_global + n_users * d_user + n_items * d_user
    users = np.repeat(np.arange(n_users), rows_per_user)
    rng.shuffle(users)
    k = 12
    gi = rng.integers(0, d_global, size=(n, k)).astype(np.int32)
    gv = (rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32)
    ul = rng.integers(0, d_user, size=(n, 4))
    ui = (d_global + users[:, None] * d_user + ul).astype(np.int32)
    uv = (rng.normal(size=(n, 4)) / 2.0).astype(np.float32)
    parts_i, parts_v = [gi, ui], [gv, uv]
    z = (gv * wg[gi]).sum(1) + (uv * wu[users[:, None], ul]).sum(1)
    tags = {"userId": np.array([f"u{u}" for u in users], object)}
    if n_items:
        items = rng.integers(0, n_items, size=n)
        il = rng.integers(0, d_user, size=(n, 3))
        parts_i.append((d_global + n_users * d_user + items[:, None] * d_user
                        + il).astype(np.int32))
        parts_v.append((rng.normal(size=(n, 3)) / 2.0).astype(np.float32))
        tags["itemId"] = np.array([f"i{it}" for it in items], object)
        z = z + (parts_v[-1] * wi[items[:, None], il]).sum(1)
    labels = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    user_idx = np.concatenate([np.zeros((n, 1), np.int32),
                               (1 + users[:, None] * d_user + ul).astype(np.int32)], 1)
    user_val = np.concatenate([np.ones((n, 1), np.float32), uv], 1)
    return {"idx": np.concatenate(parts_i, 1), "val": np.concatenate(parts_v, 1),
            "dim": dim, "labels": labels, "tags": tags,
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
        id_tags=dict(arrays["tags"]))


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
        out, prev = [], {k: 0 for k in self.cs.ALL_KERNELS}
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
        m = getattr(m, "effective", m)      # a factored model's effective model
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
# The full-size f32 cpu references run one of the fits' two sweeps, and fit
# A's only its first configuration of two (cuts of depth, to keep the script
# well inside its time: the references are host work), held against the
# card's fit cut alike; both sweeps and both configurations are compared
# across the devices in f64 (fit_a_f64 / fit_b_f64).
GAME_REF_SWEEPS = 1
GAME_REF_CONFIGS = 1


def phase_game_training(torch, cs, sizes, f64_users, dev, ref_dev,
                        f64_users_full_dual=10_000, keep=None) -> dict:
    """GAME training with random effects through ``GameEstimator.fit``.

    Fit A (``bench_game_scale``'s shape, one shard): fixed + perUser, L2
    weight 1 and per-user weights 1 and 10, ``sizes['iterations']``
    iterations, 2 sweeps, validated on a seed-3 bundle with AUC and
    LOGISTIC_LOSS. Fit B: the same users, the random effect over the
    ``user`` shard (user block + intercept), SIMPLE variances on both
    coordinates. Each in f32 on ``dev`` twice (bit-equality asserted), and
    cut to ``GAME_REF_SWEEPS`` sweeps and ``GAME_REF_CONFIGS``
    configurations on ``dev`` and on ``ref_dev`` at the full size (the f32
    bounds of
    ``compare_game_fits`` hold where the devices' fixed effects start
    alike: at 8,192 users the f32 fixed effect's first step already stops
    an iteration apart between the devices); each again in f64 at ``f64_users`` users on both devices under a
    ``GAME_F64_BUDGET_MB`` Newton budget, so that fit A solves chunked on
    the dual path as at full size; and fit A in f64 at
    ``f64_users_full_dual`` users under the default budget. Returns the
    counted fits' launches under ``launches``. ``keep`` (a dict) receives
    fit A's estimator, bundles, configurations and results on ``dev`` for
    the checkpoint and routing phases, which reuse that fit; with it, fit
    A's repeat on the card is phase checkpoint's killed and resumed fit."""
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
        card_est = game_estimator(shard, 2)
        ref_est = game_estimator(shard, GAME_REF_SWEEPS)
        first = game_fit(torch, cs, card_est, *data[dev.type], cfgs,
                         counted=True)
        # Fit A's repeat on the card is phase checkpoint's killed and resumed
        # fit, held bit-identical to this one there.
        second = (None if name == "fit_a" and keep is not None else
                  game_fit(torch, cs, card_est, *data[dev.type], cfgs))
        # the card's fit cut to the reference's sweeps: the same estimator,
        # its prepared datasets reused
        card_est.n_sweeps = GAME_REF_SWEEPS
        ref_cfgs = cfgs[:GAME_REF_CONFIGS]
        cut = game_fit(torch, cs, card_est, *data[dev.type], ref_cfgs)
        card_est.n_sweeps = 2
        ref = game_fit(torch, cs, ref_est, *data[ref_dev.type], ref_cfgs)
        bit_equal = second is None or all(
            torch.equal(a, b) for ra, rb in zip(first["results"], second["results"])
            for a, b in zip(_game_tensors(ra), _game_tensors(rb)))
        if not bit_equal:
            failures.append(f"{name}: two f32 card fits differ")
        cmp = compare_game_fits(torch, cut, ref, sizes["d_global"])
        cmp["re_step_same_offsets"] = re_step_vs_ref(
            torch, {ref_dev.type: ref_est, dev.type: card_est}, {d.type: data[d.type][0] for d in (dev, ref_dev)}, shard,
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
        stats = (re_step_stats(torch, card_est, data[dev.type][0], shard,
                               variance, first["results"][0])
                 if dev.type == "cuda" else None)
        if stats is not None and not stats["solver_vs_f64"]["coef_rel_err"] <= COEF_BAR_F32:
            failures.append(f"{name}: the f32 random-effect solve is "
                            f"{stats['solver_vs_f64']['coef_rel_err']} from the f64 "
                            f"solve on the same offsets (> {COEF_BAR_F32})")
        plans = [(r["solver"], r["chunk"]) for r in first["buckets"]]
        out[name] = {
            "re_shard": shard, "re_weights": weights, "variance": variance,
            "fit_s": {"run": first["fit_s"],
                      "repeat": None if second is None else second["fit_s"],
                      "cut_to_ref_sweeps": cut["fit_s"], "ref": ref["fit_s"]},
            "ref_sweeps": GAME_REF_SWEEPS, "ref_configs": len(ref_cfgs),
            "steps": first["steps"], "ref_steps": ref["steps"],
            "buckets": first["buckets"], "plans": plans,
            "best_config": first.get("best_config"),
            "newton_loop_fetches": first["newton_loop_fetches"],
            "launches_per_sweep": first["launches_per_sweep"],
            "bit_equal_repeat": ("in phase checkpoint" if second is None
                                 else bit_equal), "vs_ref": cmp, "re_step": stats}
        if name == "fit_a" and keep is not None:
            keep.update(est=card_est, data=data[dev.type], cfgs=cfgs,
                        results=first["results"])
        del card_est, ref_est, first, second, cut, ref

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


def _load_model(torch, path: str, index_root: str):
    """A saved GAME model (shard ``global``) through the port's
    ``io/model_io`` loader, in f64 on the CPU."""
    from photon_tpu_torch.index.index_map import MmapIndexMap
    from photon_tpu_torch.io.model_io import load_game_model

    imap = MmapIndexMap(os.path.join(index_root, "global"))
    return load_game_model(path, {"global": imap}, dtype=torch.float64,
                           device=torch.device("cpu"))[0]


def _re_rel_err(a, b) -> float:
    """max |a - b| over max |b| of two loaded random effects' means, matched
    by entity key and global column (absent entries are 0): array work,
    no Python pass over the coefficients."""
    ids = {k: i for i, k in enumerate(sorted(set(a.entity_keys) | set(b.entity_keys)))}

    def entries(m):
        ks, vs = [], []
        for coefs, proj, eids in zip(m.bucket_coefs, m.bucket_proj, m.bucket_entity_ids):
            p = proj.numpy().astype(np.int64)
            ent = np.array([ids[m.entity_keys[e]] for e in eids.tolist()], np.int64)
            ok = p < m.global_dim
            ks.append((ent[:, None] * (m.global_dim + 1) + p)[ok])
            vs.append(coefs.numpy()[ok])
        return np.concatenate(ks), np.concatenate(vs)

    (ka, va), (kb, vb) = entries(a), entries(b)
    keys = np.union1d(ka, kb)
    xa, xb = np.zeros(keys.size), np.zeros(keys.size)
    xa[np.searchsorted(keys, ka)] = va
    xb[np.searchsorted(keys, kb)] = vb
    return float(np.abs(xa - xb).max() / max(np.abs(xb).max(), 1e-30))


def _model_dirs_differ(a: str, b: str) -> list:
    """The files in which two saved model directories differ: each Avro
    file compared byte for byte without its sync marker (a random 16 bytes
    the writer draws per file, the file's last 16 bytes), every other file
    byte for byte. Equal bytes are equal schemas, blocks and records."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    def payload(path):
        with open(path, "rb") as f:
            data = f.read()
        return data.replace(data[-16:], b"") if path.endswith(".avro") else data

    fa, fb = files(a), files(b)
    if fa != fb:
        return sorted(set(fa) ^ set(fb))
    return [f for f in fa if payload(os.path.join(a, f)) != payload(os.path.join(b, f))]


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
    t0 = time.perf_counter()
    index_root = os.path.join(root, "out", "index")
    ra = _load_model(torch, best[dev.type], index_root)["perUser"]
    rb = _load_model(torch, best[ref_dev.type], index_root)["perUser"]
    errs = {"fixed_means": _saved_rel_err(fa["means"], fb["means"]),
            "random_means": _re_rel_err(ra, rb)}
    compare_s = time.perf_counter() - t0
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
            "random_effect_coefficients": sum(int((p < ra.global_dim).sum())
                                              for p in ra.bucket_proj),
            "compare_saved_models_s": compare_s, "runs": runs,
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
# Sweeps of the f32 fits at GAME_F64_USERS users, both devices (2 where not
# named). Fit C's run one of two, a cut of depth to keep the script well
# inside its time (its cpu fit is host work: 45 s of 2 sweeps on the H100
# machine's host): what they serve, the objective at one point, holds after
# any sweep; its f64 witness runs both.
VM_SMALL_F32_SWEEPS = {"fit_c": 1}
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


def vm_estimator(arrays, re_shard: str, normalization: str, evaluators,
                 n_sweeps: int = 2):
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
        n_sweeps=n_sweeps, evaluator_specs=evaluators,
        normalization=normalization, intercept_indices=intercepts)


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


def phase_game_training_vmapped(torch, cs, sizes, small_users, dev, ref_dev,
                                keep=None) -> dict:
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
    one point, ``vm_point_gap``; fits D's and E's final lane objectives;
    fit C's cut to ``VM_SMALL_F32_SWEEPS``) and in f64 (``compare_f64_fits``; fit C to ``VM_F64_RTOL_FIT_C``), each
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
            if name == "fit_c" and keep is not None:
                # phase bf16_kernels' lane layout
                keep["fit_c_lanes"] = (flat.idx.cpu().numpy(), flat.val.cpu().numpy(),
                                       flat.dim)
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
        ests = {d.type: vm_estimator(small, shard, norm, ("AUC", "LOGISTIC_LOSS"),
                                     VM_SMALL_F32_SWEEPS.get(name, 2))
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
            "f32": {"sweeps": VM_SMALL_F32_SWEEPS.get(name, 2),
                    "lane_objective_rel_err": lane_err,
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


# ------------------------------------------------------------------ ingest

# The ingest phase's headline data: FULL's widths at 128 rows a user
# (2^19 rows), written as INGEST_PARTS Avro files by as many processes.
INGEST_PARTS = 8
SCORE_CHUNK_ROWS = 65536
INGEST_ROWS_PER_USER = 128      # FULL's 4,096 users x 128 = 2^19 rows
# chunked against whole-dataset scores: tests/test_torch_scoring_driver.py's
# float32 tolerance (a chunk pads K to the widest chunk so far, which can
# change the matvec's summation groups)
SCORE_ATOL_F32 = 1e-5


def _write_ingest_part(args) -> int:
    """Rows [lo, hi) of ``game_arrays`` (intercept in column 0) as Avro
    training examples with coin-flip labels and small offsets drawn for all
    rows from ``seed + 1``: one part file of the ingest phase's data."""
    from photon_tpu_torch.io.avro import ContainerWriter
    from photon_tpu_torch.io.schemas import TRAINING_EXAMPLE_AVRO

    sizes, path, lo, hi, seed = args
    idx, val, dim, users, keys = game_arrays(col0=1, seed=seed, **sizes)
    rng = np.random.default_rng(seed + 1)
    labels = (rng.random(len(users)) < 0.5).astype(float)
    offsets = rng.normal(size=len(users)) * 0.1
    name_term = [n.split("\x01") for n in feature_names(sizes)]
    with ContainerWriter(path, TRAINING_EXAMPLE_AVRO) as w:
        for r in range(lo, hi):
            w.write({
                "uid": f"i{r}", "label": float(labels[r]), "weight": None,
                "offset": float(offsets[r]),
                "features": [{"name": name_term[c][0], "term": name_term[c][1],
                              "value": float(x)} for c, x in zip(idx[r], val[r])],
                "metadataMap": {"userId": keys[r]},
            })
    return hi - lo


def write_ingest_data(sizes, root: str, seed: int = 5) -> dict:
    """The ingest phase's data: ``INGEST_PARTS`` part files under
    ``root/ingest``, written in parallel by spawned processes with the
    port's ``ContainerWriter``."""
    import concurrent.futures as cf
    import multiprocessing as mp

    d = os.path.join(root, "ingest")
    os.makedirs(d, exist_ok=True)
    n = sizes["n_users"] * sizes["rows_per_user"]
    bounds = np.linspace(0, n, INGEST_PARTS + 1).astype(int)
    jobs = [(sizes, os.path.join(d, f"part-{i:05d}.avro"), int(lo), int(hi), seed)
            for i, (lo, hi) in enumerate(zip(bounds, bounds[1:]))]
    t0 = time.perf_counter()
    with cf.ProcessPoolExecutor(max_workers=min(INGEST_PARTS, os.cpu_count() or 1),
                                mp_context=mp.get_context("spawn")) as pool:
        rows = sum(pool.map(_write_ingest_part, jobs))
    return {"dir": d, "rows": rows, "files": INGEST_PARTS,
            "bytes": sum(os.path.getsize(j[1]) for j in jobs),
            "write_s": time.perf_counter() - t0}


def _bundle_diffs(torch, got, want) -> list:
    """Names of the bundle fields that are not bit-equal (every array, every
    shard; features compared on the host)."""
    bad = [f for f in ("labels", "offsets", "weights")
           if not np.array_equal(getattr(got, f), getattr(want, f), equal_nan=True)]
    if list(got.uids) != list(want.uids):
        bad.append("uids")
    bad += [f"id_tags[{t}]" for t in want.id_tags
            if list(got.id_tags.get(t, ())) != list(want.id_tags[t])]
    for s, w in want.features.items():
        g = got.features.get(s)
        if (g is None or g.dim != w.dim or g.val.dtype != w.val.dtype
                or not torch.equal(g.idx.cpu(), w.idx.cpu())
                or not torch.equal(g.val.cpu(), w.val.cpu())):
            bad.append(f"features[{s}]")
    return bad


def _timed(torch, dev, fn):
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_ingest(torch, cs, sizes, dev, root: str, inputs: dict) -> dict:
    """The streaming ingest at FULL's widths. On the drivers' 32,768-row file:
    the per-record read against the streaming read (native decoder asserted)
    and the pipelined read, all bit-equal. On 2^19 rows (``INGEST_PARTS``
    files): the streaming read, the pipelined read (one reader for both
    files, as the streaming reads share reader's; pinned staging, its H2D
    bytes and the device's busy share during the read) and the read by 4
    worker processes, bit-equal. Then the
    scoring driver with ``--chunk-rows SCORE_CHUNK_ROWS`` and 0 and the
    training driver (a fixed effect) on the 2^19 rows, with their stage
    times. Returns the launches of the drivers' runs under ``launches``."""
    from photon_tpu_torch.cli import game_scoring_driver, game_training_driver
    from photon_tpu_torch.index.index_map import MmapIndexMap
    from photon_tpu_torch.io.avro import read_records
    from photon_tpu_torch.io.data_reader import (
        AvroDataReader,
        FeatureShardConfig,
        InputColumnNames,
    )
    from photon_tpu_torch.io.parallel_ingest import read_parallel
    from photon_tpu_torch.io.prefetch import PinnedStaging, read_bundle_pipelined
    from photon_tpu_torch.io.streaming import StreamingAvroReader

    f32 = torch.float32
    failures: list = []
    data = write_ingest_data(sizes, root)
    out = {"rows_per_user": sizes["rows_per_user"], "data": data}
    index_root = os.path.join(root, "out", "index")
    maps = {"global": MmapIndexMap(os.path.join(index_root, "global"))}
    cfgs = {"global": FeatureShardConfig(("features",), True)}
    cols, tags = InputColumnNames(), ["userId"]
    reader = AvroDataReader(maps, cfgs, cols, tags)

    def staging():
        return PinnedStaging(dev) if dev.type == "cuda" else None

    # the pipelined reads' one reader: its decode programs and the index's
    # hash table are built in its first read (the small file's), as
    # reader's are in its first streaming read
    piped_reader = StreamingAvroReader(maps, cfgs, cols, tags,
                                       chunk_rows=SCORE_CHUNK_ROWS)

    def pipelined(path, st):
        return read_bundle_pipelined(maps, cfgs, cols, tags, path, dev,
                                     reader=piped_reader, staging=st)

    small = os.path.join(root, "data.avro")
    per_record, t_pr = _timed(torch, dev, lambda: reader.read_per_record(
        small, dtype=f32, device=dev))
    streamed, t_st = _timed(torch, dev, lambda: reader.read(small, dtype=f32,
                                                          device=dev))
    if reader.last_reader != "native":
        failures.append(f"the streaming read fell back to {reader.last_reader}")
    piped, t_pl = _timed(torch, dev, lambda: pipelined(small, staging()))
    for name, b in (("streaming", streamed), ("pipelined", piped)):
        bad = _bundle_diffs(torch, b, per_record)
        if bad:
            failures.append(f"32,768 rows: the {name} bundle differs from the "
                            f"per-record one in {bad}")
    out["small"] = {"rows": per_record.n_rows, "per_record_s": t_pr,
                    "streaming_s": t_st, "pipelined_s": t_pl,
                    "per_record_over_streaming": t_pr / t_st}
    del per_record, streamed, piped

    big = data["dir"]
    full, t_full = _timed(torch, dev, lambda: reader.read(big, dtype=f32, device=dev))
    # chunks of SCORE_CHUNK_ROWS rows decoded ahead on the producer thread
    st = staging()
    piped, t_piped = _timed(torch, dev, lambda: pipelined(big, st))
    workers, t_workers = _timed(torch, dev, lambda: read_parallel(
        big, maps, cfgs, dev, cols, tags, n_workers=4))
    for name, b in (("pipelined", piped), ("4-worker", workers)):
        bad = _bundle_diffs(torch, b, full)
        if bad:
            failures.append(f"2^19 rows: the {name} bundle differs from the "
                            f"streaming one in {bad}")
    out["full"] = {"rows": full.n_rows, "k": full.features["global"].idx.shape[1],
                   "streaming_s": t_full, "pipelined_s": t_piped,
                   "workers_4_s": t_workers,
                   "rows_per_s_streaming": full.n_rows / t_full}
    if st is not None:
        st2 = PinnedStaging(dev)
        busy = device_busy(torch, lambda: pipelined(big, st2), t_piped,
                           ours=("Memcpy HtoD",))
        out["full"].update(h2d_bytes=st.bytes, h2d_copies=st.copies,
                           h2d_gbytes_per_s_of_read=st.bytes / t_piped / 1e9,
                           read_profile=busy)
    del full, piped, workers

    cs.reset_launch_counts()
    scoring = {}
    for chunk in (SCORE_CHUNK_ROWS, 0):
        dest = os.path.join(root, f"ingest_scores_{chunk}")
        summary, wall = _timed(torch, dev, lambda: game_scoring_driver.run([
            "--data", big, "--model-dir", os.path.join(root, "out", "best"),
            "--output-dir", dest, "--device", dev.type,
            "--chunk-rows", str(chunk)]))
        if summary != {"n_rows": data["rows"], "evaluation": None,
                       "reader": "native"}:
            failures.append(f"scoring --chunk-rows {chunk}: summary {summary}")
        recs = read_records(os.path.join(dest, "scores.avro"))
        scoring[chunk] = {"wall_s": wall,
                          "scores": np.array([r["predictionScore"] for r in recs]),
                          "uids": [r["uid"] for r in recs],
                          **_stage_seconds(os.path.join(dest, "photon.log"))}
    a, b = scoring[SCORE_CHUNK_ROWS], scoring[0]
    if a["uids"] != b["uids"] or not np.isfinite(a["scores"]).all():
        failures.append("chunked scores are not the whole-dataset rows")
    err = float(np.abs(a["scores"] - b["scores"]).max())
    if not err <= SCORE_ATOL_F32:
        failures.append(f"chunked scores differ from the whole-dataset scores "
                        f"by {err} (> {SCORE_ATOL_F32})")
    equal = float(np.mean(a["scores"] == b["scores"]))
    for r in scoring.values():
        del r["scores"], r["uids"]
    out["scoring"] = {"chunk_rows": SCORE_CHUNK_ROWS, "runs": scoring,
                      "max_abs_err_chunked_vs_whole": err,
                      "bit_equal_share": equal}
    # a fixed effect: a per-user random effect over these rows would spend
    # ~80 s writing its 4,096 x ~4,000-column model (the export is host
    # Python), the GAME driver path runs in phase game_training_driver
    dest = os.path.join(root, "ingest_train")
    summary, wall = _timed(torch, dev, lambda: game_training_driver.run([
        "--train-data", big, "--output-dir", dest, "--task", "LOGISTIC_REGRESSION",
        "--index-dir", index_root, "--device", dev.type, "--coordinate",
        "fixed:type=fixed,shard=global,reg=L2,reg_weights=1,max_iter=20,variance=SIMPLE"]))
    if summary["reader"] != "native":
        failures.append(f"training driver read with {summary['reader']}")
    out["training_driver"] = {"wall_s": wall, "fit_seconds": summary["fit_seconds"],
                              "read_seconds": summary["read_seconds"],
                              **_stage_seconds(os.path.join(dest, "photon.log"))}
    out["launches"] = cs.launch_counts()
    if failures:
        emit({"phase": "ingest", **{k: v for k, v in out.items() if k != "launches"}})
        raise AssertionError("; ".join(failures))
    return out


# ------------------------------------------------------------ bf16 values

# The GLM driver phase's iterations (a cap at tolerance 1e-7; the λ grid is
# one weight) and its out-of-core chunk: 2^19 rows / 65,536 = 8 chunks.
GLM_ITERATIONS = 20
GLM_CHUNK_ROWS = 65536
# The f64 witness's iterations (out-of-core against in-core, 1e-9).
GLM_F64_ITERATIONS = 10
GLM_F64_RTOL = 1e-9
# f32 on equal inputs: the in-core and streamed objective at one point
# (each sums in float64 and rounds once; the streamed sum adds 8 rounded
# chunk partials), value and gradient.
GLM_POINT_RTOL_F32 = 1e-5
# --bf16-feed against the float32 driver run on the unrounded values: the
# validation metrics (the values rounded to 8 bits of mantissa move the
# model a little). The gate that decides is bit equality with the float32
# run on the rounded values.
BF16_FEED_METRIC_ATOL = 1e-2


# The yardstick for a bf16 kernel: cuSPARSE SpMV with bf16 values and
# vector (torch's CSR ``@`` on bf16 operands, float accumulation).
BF16_LIBRARY_CALL = "cuSPARSE SpMV, bf16 values and vector (torch.sparse_csr @)"


def bf16_case(torch, cs, dev, idx_np, val_np, dim, seed, names) -> dict:
    """The bf16 entry points of ``names`` on one layout, values rounded to
    bf16: each bit-equal to its f32 kernel on the upcast values, bit-equal
    on repeat, within the f32 tolerance of its plain version; times of the
    bf16 kernel and of the f32 kernel (in turns), the plain version, the
    library call; the bound from the bf16 layout's bytes."""
    import dataclasses

    n, k = idx_np.shape
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(idx_np).to(dev)
    vb = torch.from_numpy(val_np).to(dev, torch.float32).to(torch.bfloat16)
    up = vb.float()
    w = torch.from_numpy(rng.normal(size=dim)).to(dev, torch.float32)
    v = torch.from_numpy(rng.normal(size=n)).to(dev, torch.float32)
    csc_up = cs.build_csc(idx, up, dim)
    csc_b = dataclasses.replace(csc_up, vals=csc_up.vals.to(torch.bfloat16))
    p_up = p_b = None
    if "ell_panel_matvec" in names:
        p_up = cs.panel_layout(idx, up, dim, cs.tile_rows_for(n), cs.panel_cols(torch.float32))
        p_b = dataclasses.replace(p_up, vals=p_up.vals.to(torch.bfloat16))
    calls_b = kernel_calls(cs, idx, vb, w, v, csc_b, p_b, dim)
    calls_f = kernel_calls(cs, idx, up, w, v, csc_up, p_up, dim)
    lib = library_calls(torch, idx, vb, w.to(torch.bfloat16), v.to(torch.bfloat16),
                        csc_b, dim)
    out = {"rows": n, "k": k, "dim": dim, "nnz": csc_up.nnz,
           "library_call": BF16_LIBRARY_CALL}
    for name in names:
        (kb, pb), (kf, _) = calls_b[name], calls_f[name]
        got, ref, again = kb(), kf(), kb()
        torch.cuda.synchronize()
        if got.dtype != torch.float32 or not torch.equal(got, ref):
            raise AssertionError(f"{name}_bf16 at {n} x {k} is not its f32 kernel on "
                                 "the upcast values bit for bit")
        if not torch.equal(got, again):
            raise AssertionError(f"{name}_bf16 at {n} x {k}: two runs differ")
        ms, f32_ms = time_pair(torch, kb, kf)
        lib_ms = time_ms(torch, lib[name])
        out[name] = {"bit_equal_f32_on_upcast": True, "bit_equal_repeat": True,
                     "max_abs_err": _close(torch, got, pb(), "float32"),
                     "ms": ms, "f32_kernel_ms": f32_ms, "over_f32": ms / f32_ms,
                     "plain_ms": time_ms(torch, pb), "library_ms": lib_ms,
                     "library_ratio": ms / lib_ms,
                     **kernel_bound(name, n, k, dim, csc_up.nnz, "bfloat16")}
        if name == "ell_matvec":
            plan = cs.ell_tile_plan(k, torch.bfloat16)
            out[name].update(tile_rows=plan.tile_rows, group=plan.group)
    return out


def phase_bf16_kernels(torch, cs, dev, lanes) -> dict:
    """The four kernels' bf16 entry points (``bf16_case``) at the 2^19-row
    scoring layout (all four), at fit C's lanes (``lanes``: the block-
    diagonal layout of phase ``game_training_vmapped``'s biggest fit C
    bucket; ``ell_matvec`` and the transposes, as the lanes run them) and at
    the drivers' 32,768 rows x 33 (the same three)."""
    idx_np, val_np, dim, _, _ = game_arrays(**FULL)
    out = {"game": bf16_case(torch, cs, dev, idx_np, val_np, dim, 21, cs.KERNELS)}
    three = ("ell_matvec", "csc_rmatvec", "csc_sq_rmatvec")
    out["lanes"] = bf16_case(torch, cs, dev, *lanes, 22, three)
    d_idx, d_val, d_dim, _, _ = game_arrays(**dict(FULL, rows_per_user=FULL[
        "driver_rows_per_user"]), col0=1)
    n = d_idx.shape[0]
    out["drivers"] = bf16_case(
        torch, cs, dev, np.concatenate([np.zeros((n, 1), np.int32), d_idx], 1),
        np.concatenate([np.ones((n, 1), np.float32), d_val], 1), d_dim, 23, three)
    return out


def _ooc_pass(torch, data, loss, w, reps=3) -> dict:
    """One streamed data pass of the out-of-core solver as it runs one
    (the matvec's ELL pass, then the gradient's CSC pass): seconds and H2D
    bytes a pass (the median of ``reps``), and the device's busy share over
    one pass."""
    from photon_tpu_torch.optim.out_of_core import OutOfCoreLBFGS

    scores, _, _, grad = OutOfCoreLBFGS(loss=loss, l2_weight=1.0)._streams(data)

    def two():
        return grad(scores(w))

    walls, h2d = [], []
    for _ in range(reps + 1):            # the first pass warms up
        b0 = data.h2d_bytes
        _, t = _timed(torch, data.device, two)
        walls.append(t)
        h2d.append(data.h2d_bytes - b0)
    wall = statistics.median(walls[1:])
    busy = (device_busy(torch, two, wall, ours=OUR_KERNELS + ("Memcpy HtoD",))
            if data.device.type == "cuda" else "not measured (cpu)")
    return {"seconds_a_pass": wall / 2, "h2d_bytes_a_pass": h2d[0] / 2,
            "h2d_ell_bytes": data.streamed_bytes_per_pass("ell"),
            "h2d_csc_bytes": data.streamed_bytes_per_pass("csc"),
            "h2d_gbytes_per_s": h2d[0] / wall / 1e9, "profile": busy}


def glm_witness(torch, cs, dev, big: str, index_root: str, w_point, root: str,
                chunk_rows: int = GLM_CHUNK_ROWS) -> dict:
    """The GLM path's checks on the driver phase's files, outside the
    drivers: f32 in-core and out-of-core objectives at one point (the
    in-core driver's model); out-of-core L-BFGS against in-core in f64;
    bf16 values against f32 values rounded to bf16, bit for bit; a solve
    killed after 3 iterations and resumed from its checkpoint, bit for bit;
    one streamed pass timed at f32 and at bf16 values."""
    import dataclasses

    from photon_tpu_torch.functions.objective import GLMObjective
    from photon_tpu_torch.functions.problem import GLMOptimizationProblem
    from photon_tpu_torch.index.index_map import MmapIndexMap
    from photon_tpu_torch.io.data_reader import AvroDataReader, FeatureShardConfig
    from photon_tpu_torch.io.streaming import StreamingAvroReader
    from photon_tpu_torch.ops.losses import loss_for_task
    from photon_tpu_torch.optim import OptimizerConfig, OptimizerType
    from photon_tpu_torch.optim.out_of_core import (
        ChunkedGLMData,
        HostChunk,
        OutOfCoreLBFGS,
        run_out_of_core,
    )
    from photon_tpu_torch.optim.regularization import (
        RegularizationContext,
        RegularizationType,
    )
    from photon_tpu_torch.types import TaskType

    maps = {"global": MmapIndexMap(os.path.join(index_root, "global"))}
    cfgs = {"global": FeatureShardConfig(("features",), True)}
    loss = loss_for_task(TaskType.LOGISTIC_REGRESSION)
    failures, out = [], {}

    def chunked(dtype, value_dtype=None):
        sr = StreamingAvroReader(maps, cfgs, chunk_rows=chunk_rows, capture_uids=False)
        return ChunkedGLMData.from_stream(sr.iter_chunks(big), "global", len(maps["global"]),
                                          chunk_rows=chunk_rows, device=dev,
                                          dtype=dtype, value_dtype=value_dtype)

    def problem(iters, tol):
        return GLMOptimizationProblem(
            task=TaskType.LOGISTIC_REGRESSION, optimizer_type=OptimizerType.LBFGS,
            optimizer_config=OptimizerConfig(max_iterations=iters, tolerance=tol),
            regularization=RegularizationContext(RegularizationType.L2), reg_weight=1.0)

    reader = AvroDataReader(maps, cfgs)
    # f32 at one point: the in-core objective against the streamed one
    batch = reader.read(big, dtype=torch.float32, device=dev,
                        capture_uids=False).batch("global").with_accelerator_paths()
    data = chunked(torch.float32)
    # halfway to the in-core optimum, where the gradient is far from 0
    w = 0.5 * w_point.to(dev, torch.float32)
    obj = GLMObjective(loss=loss, l2_weight=1.0)
    f_in, g_in = obj.value_and_grad(w, batch)
    scores, _, _, grad = OutOfCoreLBFGS(loss=loss, l2_weight=1.0)._streams(data)
    f_d, g_d = grad(scores(w))
    f_out, g_out = f_d + 0.5 * torch.sum(w * w), g_d + w
    point = {"value_rel_err": abs(float(f_out) - float(f_in)) / abs(float(f_in)),
             "grad_rel_err": float((g_out - g_in).abs().max() / g_in.abs().max())}
    for key, e in point.items():
        if not e <= GLM_POINT_RTOL_F32:
            failures.append(f"f32 out-of-core {key} at one point {e} > {GLM_POINT_RTOL_F32}")
    out["f32_at_one_point"] = point
    del batch

    # bf16 values against f32 values rounded to bf16, and the pass times
    def cast(src, dt):
        c = ChunkedGLMData(chunks=[], labels=src.labels, offsets=src.offsets,
                           weights=src.weights, dim=src.dim, n_rows=src.n_rows,
                           chunk_rows=src.chunk_rows, device=src.device, dtype=src.dtype)
        def pin(t):
            return t.pin_memory() if dev.type == "cuda" else t

        for h in src.chunks:
            val = pin(h.val.to(torch.bfloat16).to(dt))
            c.chunks.append(HostChunk(idx=h.idx, val=val, csc=dataclasses.replace(
                h.csc, vals=pin(h.csc.vals.to(torch.bfloat16).to(dt)))))
        return c

    b16 = chunked(torch.float32, "bfloat16")
    rounded = cast(data, torch.float32)
    same_layout = all(torch.equal(a.idx, b.idx) and torch.equal(a.csc.rows, b.csc.rows)
                      and torch.equal(a.val.float(), b.val)
                      for a, b in zip(b16.chunks, rounded.chunks))
    _, r_b = run_out_of_core(problem(5, 1e-7), b16)
    _, r_r = run_out_of_core(problem(5, 1e-7), rounded)
    bf16_equal = same_layout and torch.equal(r_b.x, r_r.x) and \
        r_b.data_passes == r_r.data_passes
    if not bf16_equal:
        failures.append("out-of-core bf16 values are not the f32 fit on the rounded "
                        "values bit for bit")
    out["bf16_vs_f32_on_rounded"] = {"bit_identical": bf16_equal,
                                     "iterations": r_b.iterations}
    out["pass"] = {"f32": _ooc_pass(torch, data, loss, w),
                   "bf16": _ooc_pass(torch, b16, loss, w)}
    out["pass"]["bf16_over_f32_seconds"] = (out["pass"]["bf16"]["seconds_a_pass"]
                                            / out["pass"]["f32"]["seconds_a_pass"])
    del b16, rounded

    # killed after 3 iterations and resumed
    ck = os.path.join(root, "glm_resume.ckpt")

    class _Stop(Exception):
        pass

    def bomb(it, *_):
        if it >= 3:
            raise _Stop

    def solver(progress=None):
        return OutOfCoreLBFGS(loss=loss, l2_weight=1.0,
                              config=OptimizerConfig(max_iterations=8, tolerance=1e-7),
                              progress=progress, checkpoint_path=ck,
                              checkpoint_min_interval_s=0.0)

    zero = torch.zeros(data.dim, device=dev)
    ref = dataclasses.replace(solver(), checkpoint_path=None).optimize(data, zero)
    t0 = time.perf_counter()
    try:
        solver(bomb).optimize(data, zero)
        failures.append("the killed out-of-core solve was not stopped")
    except _Stop:
        pass
    killed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = solver().optimize(data, zero)
    resumed_s = time.perf_counter() - t0
    resumed_equal = (torch.equal(res.x, ref.x) and res.iterations == ref.iterations
                     and res.data_passes == ref.data_passes)
    if not resumed_equal:
        failures.append("the resumed out-of-core solve is not bit-identical")
    out["resume"] = {"bit_identical": resumed_equal, "iterations": res.iterations,
                     "killed_after": 3, "killed_run_s": killed_s, "resumed_s": resumed_s,
                     "checkpoint_bytes": os.path.getsize(ck)}
    del data

    # f64: out-of-core against in-core
    b64 = reader.read(big, dtype=torch.float64, device=dev,
                      capture_uids=False).batch("global").with_accelerator_paths()
    m_in, r_in = problem(GLM_F64_ITERATIONS, 1e-9).run(
        b64, torch.zeros(b64.dim, dtype=torch.float64, device=dev))
    del b64
    d64 = chunked(torch.float64)
    m_out, r_out = run_out_of_core(problem(GLM_F64_ITERATIONS, 1e-9), d64)
    a, b = m_out.coefficients.means, m_in.coefficients.means
    rel = float((a - b).abs().max() / b.abs().max())
    same = (r_out.iterations, r_out.converged_reason) == (r_in.iterations,
                                                          r_in.converged_reason)
    if not (rel <= GLM_F64_RTOL and same):
        failures.append(f"f64 out-of-core against in-core: coefficients {rel} apart, "
                        f"iterations/reasons {(r_out.iterations, r_out.converged_reason)} "
                        f"against {(r_in.iterations, r_in.converged_reason)}")
    out["f64_vs_in_core"] = {"coef_rel_err": rel, "limit": GLM_F64_RTOL,
                             "iterations": r_out.iterations,
                             "reason": r_out.reason_name(),
                             "data_passes": {"out_of_core": r_out.data_passes,
                                             "in_core": r_in.data_passes}}
    out["failures"] = failures
    return out


GLM_RUNS = {   # name: (driver flags, PHOTON_VALUE_DTYPE)
    "in_core": (["--row-chunk-rows", "0", "--variance", "NONE"], ""),
    "in_core_bf16": (["--row-chunk-rows", "0", "--variance", "SIMPLE"], "bfloat16"),
    "out_of_core": (["--row-chunk-rows", str(GLM_CHUNK_ROWS), "--variance", "NONE"], ""),
    "out_of_core_bf16": (["--row-chunk-rows", str(GLM_CHUNK_ROWS), "--variance", "NONE"],
                         "bfloat16"),
    "out_of_core_owlqn_l1": (["--row-chunk-rows", str(GLM_CHUNK_ROWS), "--variance",
                              "NONE", "--optimizer", "OWLQN", "--regularization", "L1"], ""),
}


def phase_glm_driver(torch, cs, dev, root: str, big: str,
                     chunk_rows: int = GLM_CHUNK_ROWS) -> dict:
    """The port's GLM training driver on phase ``ingest``'s 2^19 rows (FULL's
    widths: 327,681 columns, 32 + 1 entries a row), logistic L-BFGS L2 (one
    λ, ``GLM_ITERATIONS`` iterations at most): in-core, in-core with bf16
    values (``PHOTON_VALUE_DTYPE``; SIMPLE variances), out-of-core in chunks
    of ``GLM_CHUNK_ROWS`` rows at f32 and at bf16 values, and out-of-core
    OWL-QN L1; each run's stages, passes an iteration and H2D bytes; the
    out-of-core model scored by the port's scoring driver. Then
    ``glm_witness`` and ``feature_indexing_driver`` on the same files.
    Returns the drivers' launches under ``launches``."""
    from photon_tpu_torch.cli import feature_indexing_driver, game_scoring_driver
    from photon_tpu_torch.cli import glm_training_driver

    index_root = os.path.join(root, "out", "index")
    common = ["--train-data", big, "--task", "LOGISTIC_REGRESSION", "--index-dir",
              index_root, "--device", dev.type, "--no-report", "--reg-weights", "1",
              "--max-iterations", str(GLM_ITERATIONS)]
    runs, failures = {}, []
    launches = {k: 0 for k in cs.ALL_KERNELS}
    for name, (flags, vd) in GLM_RUNS.items():
        flags = [str(chunk_rows) if f == str(GLM_CHUNK_ROWS) else f for f in flags]
        dest = os.path.join(root, f"glm_{name}")
        cs.reset_launch_counts()
        with _env("PHOTON_VALUE_DTYPE", vd):
            summary, wall = _timed(torch, dev, lambda: glm_training_driver.run(
                common + flags + ["--output-dir", dest]))
        got = cs.launch_counts()
        launches = {k: launches[k] + got[k] for k in launches}
        sweep = summary["sweep"][0]
        run = {"wall_s": wall, "mode": summary["mode"],
               "value_dtype": summary["value_dtype"], "iterations": sweep["iterations"],
               "objective": sweep["objective"], "AUC": sweep["AUC"],
               "read_seconds": summary["read_seconds"],
               "fit_seconds": summary["fit_seconds"], "launches": got,
               **_stage_seconds(os.path.join(dest, "photon.log"))}
        if summary["mode"] == "out_of_core":
            passes = sweep["data_passes"]
            run.update(n_chunks=summary["n_chunks"], data_passes=passes,
                       passes_an_iteration=(passes - 2) / max(sweep["iterations"], 1),
                       h2d_bytes=summary["h2d_bytes"],
                       h2d_bytes_a_pass=summary["h2d_bytes"] / max(passes, 1),
                       fit_seconds_a_pass=summary["fit_seconds"] / max(passes, 1),
                       streamed_gb_per_pass=summary["streamed_gb_per_pass"],
                       streamed_gb_per_gradient_pass=summary[
                           "streamed_gb_per_gradient_pass"])
            want = -(-summary["n_rows"] // chunk_rows)
            if summary["n_chunks"] != want:
                failures.append(f"{name}: {summary['n_chunks']} chunks, not {want}")
        # in-core values narrow where the layouts attach: on the card
        narrow = vd and (summary["mode"] == "out_of_core" or dev.type == "cuda")
        if not np.isfinite(sweep["objective"]) or summary["value_dtype"] != (
                vd if narrow else "float32"):
            failures.append(f"{name}: objective {sweep['objective']}, values "
                            f"{summary['value_dtype']}")
        runs[name] = run
    a, b = runs["out_of_core"], runs["in_core"]
    runs["out_of_core_vs_in_core"] = {
        "objective_rel_err": abs(a["objective"] - b["objective"]) / abs(b["objective"]),
        "iterations": (a["iterations"], b["iterations"])}
    bf, f = runs["out_of_core_bf16"], runs["out_of_core"]
    runs["bf16_over_f32"] = {
        k: (bf[k] / f[k] if f[k] else None)
        for k in ("h2d_bytes_a_pass", "fit_seconds_a_pass", "streamed_gb_per_pass",
                  "streamed_gb_per_gradient_pass")}
    # the out-of-core model through the scoring driver
    dest = os.path.join(root, "glm_scores")
    scored = game_scoring_driver.run([
        "--data", big, "--model-dir", os.path.join(root, "glm_out_of_core", "best"),
        "--output-dir", dest, "--device", dev.type, "--evaluators", "AUC"])
    if abs(scored["evaluation"]["AUC"] - f["AUC"]) > 1e-4:
        failures.append(f"the scoring driver's AUC {scored['evaluation']['AUC']} is not "
                        f"the driver's {f['AUC']}")
    from photon_tpu_torch.io.avro import read_records

    (rec,) = read_records(os.path.join(root, "glm_in_core", "best", "fixed-effect",
                                       "fixed", "coefficients.avro"))
    from photon_tpu_torch.index.index_map import MmapIndexMap

    imap = MmapIndexMap(os.path.join(index_root, "global"))
    w = torch.zeros(len(imap), dtype=torch.float64)
    for m in rec["means"]:
        w[imap.get_index(m["name"], m["term"])] = m["value"]
    witness = glm_witness(torch, cs, dev, big, index_root, w, root, chunk_rows)
    failures += witness.pop("failures")
    # the feature index of the same files
    t0 = time.perf_counter()
    idx = feature_indexing_driver.run(["--data", big, "--output-dir",
                                       os.path.join(root, "glm_index")])
    n_feat = idx["features_per_shard"]["global"]
    if not 0 < n_feat <= len(imap):
        failures.append(f"feature indexing found {n_feat} features")
    out = {"rows": scored["n_rows"], "runs": runs, "scoring": scored["evaluation"],
           "witness": witness,
           "feature_indexing": {"features": n_feat, "index_features": len(imap),
                                "seconds": time.perf_counter() - t0},
           "launches": launches}
    if failures:
        emit({"phase": "glm_driver", **{k: v for k, v in out.items() if k != "launches"}})
        raise AssertionError("; ".join(failures))
    return out


def phase_bf16_feed(torch, cs, sizes, dev, root: str, f32_run: dict) -> dict:
    """``game_training_driver --bf16-feed`` on the drivers' 32,768 rows with
    phase ``game_training_driver``'s configuration on the card, held bit for
    bit against the float32 driver on the same rows with their values
    rounded to bfloat16 (the bf16 kernels upcast on load, the random effect
    re-packs float32: both fits see the same numbers); its validation
    metrics beside that phase's f32 run on the unrounded values; its model
    scored by the port's scoring driver. Returns its launches under
    ``launches``."""
    from photon_tpu_torch.cli import game_scoring_driver, game_training_driver

    specs = ["fixed:type=fixed,shard=global,reg=L2,reg_weights=1,max_iter=20",
             "perUser:type=random,re_type=userId,shard=global,reg=L2,"
             "reg_weights=1|10,max_iter=20"]
    # the same rows as phase driver_inputs' and game_training_driver's files
    t0 = time.perf_counter()
    rounded = {name: os.path.join(root, f"{name}_bf16.avro") for name in ("data", "valid")}
    write_game_avro(sizes, rounded["data"], sizes["driver_rows_per_user"], seed=3,
                    label_seed=8, uid_prefix="r", bf16=True)
    write_game_avro(sizes, rounded["valid"], max(1, sizes["driver_rows_per_user"] // 4),
                    seed=4, label_seed=10, uid_prefix="v", bf16=True)
    write_s = time.perf_counter() - t0

    def train(data, valid, dest, flags):
        return _timed(torch, dev, lambda: game_training_driver.run([
            "--train-data", data, "--validation-data", valid,
            "--evaluators", "AUC", "LOGISTIC_LOSS", "--output-dir", dest,
            "--task", "LOGISTIC_REGRESSION", "--coordinate", specs[0],
            "--coordinate", specs[1], "--sweeps", "2",
            "--index-dir", os.path.join(root, "out", "index"),
            "--re-routing", "static", "--device", dev.type, *flags]))

    dest = os.path.join(root, "game_train_bf16")
    cs.reset_launch_counts()
    summary, wall = train(os.path.join(root, "data.avro"),
                          os.path.join(root, "valid.avro"), dest, ["--bf16-feed"])
    launches = cs.launch_counts()
    ctl_dest = os.path.join(root, "game_train_f32_rounded")
    control, ctl_wall = train(rounded["data"], rounded["valid"], ctl_dest, [])
    best, ctl_best = os.path.join(dest, "best"), os.path.join(ctl_dest, "best")
    # The models bit for bit, as files: loading both through io/model_io
    # costs what phase game_training_driver's compare_saved_models_s reads.
    files_differ, bytes_s = _timed(torch, dev, lambda: _model_dirs_differ(best, ctl_best))
    diffs = [f"model file {f}" for f in files_differ] + [k for k, a, b in (
        ("evaluation", summary["evaluation"], control["evaluation"]),
        ("best_config_index", summary["best_config_index"],
         control["best_config_index"])) if a != b]
    err = max(abs(summary["evaluation"][k] - f32_run["evaluation"][k])
              for k in f32_run["evaluation"])
    scored = game_scoring_driver.run([
        "--data", os.path.join(root, "valid.avro"), "--model-dir", best,
        "--output-dir", os.path.join(root, "bf16_scores"),
        "--device", dev.type, "--evaluators", "AUC"])
    out = {"wall_s": wall, "fit_seconds": summary["fit_seconds"],
           "read_seconds": summary["read_seconds"], "reader": summary["reader"],
           "evaluation": summary["evaluation"],
           "bit_equal_f32_on_rounded": not diffs, "differs_from_f32_on_rounded": diffs,
           "compare_model_files_s": bytes_s,
           "f32_on_rounded": {"wall_s": ctl_wall, "fit_seconds": control["fit_seconds"],
                              "write_rounded_s": write_s},
           "evaluation_f32": f32_run["evaluation"],
           "metric_abs_err_vs_f32": err, "limit": BF16_FEED_METRIC_ATOL,
           "best_config_index": summary["best_config_index"],
           "scoring": scored["evaluation"],
           **_stage_seconds(os.path.join(dest, "photon.log")), "launches": launches}
    if summary["reader"] != "native" or diffs or not err <= BF16_FEED_METRIC_ATOL or \
            not np.isfinite(scored["evaluation"]["AUC"]):
        emit({"phase": "bf16_feed", **{k: v for k, v in out.items() if k != "launches"}})
        raise AssertionError(f"--bf16-feed: reader {summary['reader']}, differs from "
                             f"the f32 fit on rounded values in {diffs}, metrics "
                             f"{err} from the f32 run, scoring {scored['evaluation']}")
    return out


# ----------------------------------------------- factored random effects (M12)

FACTORED = dict(latent=8, alternations=2)
# The projection objective and its gradient at one point, cuda against cpu
# on equal inputs (f32): |fa - fb| / |fb| and max |ga - gb| / max |gb|.
FACTORED_POINT_RTOL_F32 = 1e-5
FACTORED_F64_USERS = 8192
# f64 effective coefficients, cuda against cpu (max |a - b| over max |b|),
# where both devices took every decision alike, else the second bound.
FACTORED_RTOL_F64 = 1e-9
FACTORED_RTOL_F64_SPLIT = 1e-6
# rows of the f64 witness written as Avro for the scoring driver
FACTORED_SCORE_ROWS = 16384


class _FactoredSteps:
    """Seconds, solver readings and kernel launches of each step of
    ``train_factored_random_effects``: its module functions wrapped (the
    device synchronized around each) while the block runs, restored after."""

    NAMES = ("train_random_effects", "_factor_model", "_latent_step",
             "_projection_step")

    def __init__(self, torch, cs, dev):
        self.torch, self.cs, self.dev = torch, cs, dev
        self.records: list = []

    def _sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()

    def __enter__(self):
        from photon_tpu_torch.game import factored_random_effect as fre

        self.fre, self.saved = fre, {n: getattr(fre, n) for n in self.NAMES}

        def timed(name, fn):
            def run(*a, **kw):
                self._sync()
                c0, t0 = self.cs.launch_counts(), time.perf_counter()
                out = fn(*a, **kw)
                self._sync()
                rec = {"step": name, "seconds": time.perf_counter() - t0}
                c1 = self.cs.launch_counts()
                rec["launches"] = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
                if name == "_latent_step":
                    res = out[1]
                    rec.update(lanes=a[2].n_entities,
                               iterations_max=int(res.iterations.max()),
                               iterations_median=float(res.iterations.double().median()))
                    rec["lanes_per_s"] = rec["lanes"] / rec["seconds"]
                elif name == "_projection_step":
                    # an evaluation of the objective is 2 data passes
                    res = out[1]
                    rec.update(iterations=res.iterations, reason=res.reason_name(),
                               data_passes=res.data_passes, value=res.value)
                self.records.append(rec)
                return out
            return run

        for n in self.NAMES:
            setattr(fre, n, timed(n, self.saved[n]))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.fre, n, fn)

    def summary(self) -> dict:
        def of(name):
            return [r for r in self.records if r["step"] == name]

        return {"spectral_init_s": {"plain_re_solve": sum(r["seconds"] for r in of(
                    "train_random_effects")), "svds": sum(r["seconds"] for r in of(
                    "_factor_model"))},
                "latent_steps": of("_latent_step"),
                "projection_steps": of("_projection_step")}


def factored_estimator(latent: int, alternations: int, evaluators=("AUC",),
                       n_sweeps: int = 1):
    from photon_tpu_torch.estimators.config import (
        FactoredRandomEffectDataConfig,
        FixedEffectDataConfig,
    )
    from photon_tpu_torch.estimators.game_estimator import GameEstimator
    from photon_tpu_torch.types import TaskType

    return GameEstimator(
        TaskType.LOGISTIC_REGRESSION,
        {"fixed": FixedEffectDataConfig("global"),
         "perUser": FactoredRandomEffectDataConfig(
             "userId", "global", latent_dim=latent, n_alternations=alternations)},
        n_sweeps=n_sweeps, evaluator_specs=evaluators)


def _factored_fit(torch, cs, est, train, valid, cfgs, dev) -> tuple:
    """One factored ``GameEstimator.fit`` on ``dev``, its steps measured."""
    with _FactoredSteps(torch, cs, dev) as steps:
        out = game_fit(torch, cs, est, train, valid, cfgs)
    return out, steps


def _decisions_apart(torch, a_steps, b_steps, run, ref) -> dict:
    """Stopping decisions that differ between two factored fits: the
    latent steps' lanes (iterations or reason; the final step's through the
    tracker), each projection step's iterations, reason or data passes, and
    the fixed-effect steps'."""
    proj = [i for i, (x, y) in enumerate(zip(a_steps.summary()["projection_steps"],
                                            b_steps.summary()["projection_steps"]))
            if (x["iterations"], x["reason"], x["data_passes"])
            != (y["iterations"], y["reason"], y["data_passes"])]
    lanes = _lane_path_diffs(run, ref)
    fixed = [st for st in _fixed_steps(torch, run, ref)
             if len(set(st["iterations"])) > 1 or len(set(st["reasons"])) > 1
             or len(set(st["data_passes"])) > 1]
    return {"projection_steps": proj, "final_latent_lanes": lanes,
            "fixed_steps": len(fixed)}


def write_rows_avro(path: str, arrays: dict, names: list, rows: int) -> int:
    """The first ``rows`` rows of ``arrays`` (``game_arrays_bench``'s
    global shard) as Avro training examples, uid = row index."""
    from photon_tpu_torch.io.avro import ContainerWriter
    from photon_tpu_torch.io.schemas import TRAINING_EXAMPLE_AVRO

    name_term = [n.split("\x01") for n in names]
    idx, val = arrays["idx"], arrays["val"]
    with ContainerWriter(path, TRAINING_EXAMPLE_AVRO) as w:
        for r in range(rows):
            w.write({"uid": str(r), "label": float(arrays["labels"][r]),
                     "weight": None, "offset": 0.0,
                     "features": [{"name": name_term[c][0], "term": name_term[c][1],
                                   "value": float(x)} for c, x in zip(idx[r], val[r])],
                     "metadataMap": {"userId": arrays["tags"]["userId"][r]}})
    return rows


def _bench_names(sizes, n_users: int) -> list:
    """Feature keys of ``game_arrays_bench``'s global shard, in column order."""
    from photon_tpu_torch.index.index_map import feature_key

    return ([feature_key("g", str(j)) for j in range(sizes["d_global"])]
            + [feature_key("u", f"{u}_{j}") for u in range(n_users)
               for j in range(sizes["d_user"])])


def factored_save_and_score(torch, sizes, arrays, est, bundle, result, dev,
                            root: str) -> dict:
    """Save ``result``'s model (f64, ``arrays``' users) with the port's
    ``save_game_model``, score its first ``FACTORED_SCORE_ROWS`` rows with
    the port's scoring driver, and hold the scores against the in-memory
    model's on the same rows (1e-9)."""
    from photon_tpu_torch.cli import game_scoring_driver
    from photon_tpu_torch.index.index_map import DefaultIndexMap, build_mmap_index
    from photon_tpu_torch.io.avro import read_records
    from photon_tpu_torch.io.data_reader import FeatureShardConfig
    from photon_tpu_torch.io.model_io import save_game_model

    n_users = len(arrays["labels"]) // sizes["rows_per_user"]
    names = _bench_names(sizes, n_users)
    assert len(names) == arrays["dim"]
    base = os.path.join(root, "factored_model")
    imap = DefaultIndexMap(names)
    build_mmap_index(imap, os.path.join(base, "index", "global"))
    t0 = time.perf_counter()
    save_game_model(os.path.join(base, "best"), result.model, {"global": imap},
                    {"fixed": "global", "perUser": "global"},
                    {"global": FeatureShardConfig(("features",), False)})
    save_s = time.perf_counter() - t0
    rows = min(FACTORED_SCORE_ROWS, len(arrays["labels"]))
    data = os.path.join(base, "rows.avro")
    t0 = time.perf_counter()
    write_rows_avro(data, arrays, names, rows)
    write_s = time.perf_counter() - t0
    dest = os.path.join(base, "scores")
    scored = game_scoring_driver.run([
        "--data", data, "--model-dir", os.path.join(base, "best"),
        "--output-dir", dest, "--device", dev.type, "--dtype", "float64"])
    got = np.array([r["predictionScore"] for r in read_records(
        os.path.join(dest, "scores.avro"))])
    model = result.model
    ds = est._prepare_cached(bundle)["datasets"]["perUser"]
    want = (bundle.features["global"].matvec(model["fixed"].model.coefficients.means)
            + model["perUser"].score_dataset(ds))[:rows].cpu().numpy()
    err = float(np.abs(got - want).max())
    if not (scored["n_rows"] == rows and err <= 1e-9 and np.std(got) > 0):
        raise AssertionError(f"the saved factored model scores {err} from the "
                             f"in-memory model ({scored['n_rows']} rows)")
    return {"rows": rows, "save_s": save_s, "write_rows_s": write_s,
            "scores_max_abs_err_vs_model": err,
            "projection_npy": os.path.exists(os.path.join(
                base, "best", "random-effect", "perUser", "projection.npy")),
            **_stage_seconds(os.path.join(dest, "photon.log"))}


def phase_factored(torch, cs, sizes, f64_users, dev, ref_dev, root: str) -> dict:
    """A factored random effect at fit A's data and widths (phase 6's
    ``bench_game_scale`` bundle: 100,000 users x 16 rows, 2^14 global + 8
    columns a user): fixed + ``perUser`` as ``FactoredRandomEffectDataConfig``
    (latent 8, 2 alternations), logistic L2 1, ``sizes['iterations']``
    iterations, 1 sweep, f32, through ``GameEstimator.fit`` on ``dev``
    (no validation data: the checks below hold what comes out). Prints the
    spectral init (the plain RE solve, then ``svds``), each latent step
    (seconds, lanes/s) and projection step (seconds, iterations, data
    passes, two an evaluation, its launches: a matvec kernel and
    ``csc_rmatvec`` asserted) and the phase's launches; the projection objective and gradient at the fit's final point
    on ``dev`` twice (bit-equal) and on ``ref_dev`` from equal inputs
    (``FACTORED_POINT_RTOL_F32``); an f64 witness at ``f64_users`` users on
    both devices (``FACTORED_RTOL_F64`` where every decision agrees); the
    witness's card model saved and scored back by the port's scoring
    driver. Returns the phase's launches under ``launches``."""
    import dataclasses

    from photon_tpu_torch.game import factored_random_effect as fre
    from photon_tpu_torch.types import TaskType

    arrays = game_arrays_bench(seed=2, **sizes)
    cfgs = game_configs((1.0,), sizes["iterations"], "NONE")
    train = game_bundle(torch, arrays, dev, torch.float32)
    est = factored_estimator(FACTORED["latent"], FACTORED["alternations"], ())
    cs.reset_launch_counts()
    fit, steps = _factored_fit(torch, cs, est, train, None, cfgs, dev)
    launches = cs.launch_counts()
    result = fit["results"][0]
    model = result.model["perUser"]
    out = {"shape": {k: sizes[k] for k in ("n_users", "rows_per_user", "d_global",
                                           "d_user")},
           "rows": len(arrays["labels"]), **FACTORED, "fit_s": fit["fit_s"],
           "steps": fit["steps"], **steps.summary(),
           "projection_shape": list(model.projection.shape)}
    failures = []
    if not all(torch.isfinite(t).all() for t in _game_tensors(result)):
        failures.append("non-finite coefficients")
    if dev.type == "cuda":
        for st in out["projection_steps"]:
            if not (st["launches"].get("csc_rmatvec", 0) and (
                    st["launches"].get("ell_matvec", 0)
                    + st["launches"].get("ell_panel_matvec", 0))):
                failures.append(f"a projection step launched no matvec kernel or "
                                f"csc_rmatvec: {st['launches']}")

    # the projection objective at the fit's final point, on equal inputs
    ds = est._prepare_cached(train)["datasets"]["perUser"]
    problem = cfgs[0]["perUser"].problem(TaskType.LOGISTIC_REGRESSION)
    offsets = train.features["global"].matvec(
        result.model["fixed"].model.coefficients.means)
    lats, P = list(model.bucket_latent), model.projection
    vg = fre.projection_value_and_grad(
        problem, list(ds.buckets), fre._designs(ds, list(ds.buckets)), offsets, lats,
        tuple(P.shape))
    (f1, g1), t1 = _timed(torch, dev, lambda: vg(P.reshape(-1)))
    f2, g2 = vg(P.reshape(-1))
    bit_equal = bool(torch.equal(f1, f2) and torch.equal(g1, g2))
    cpu_buckets = [b.to(ref_dev) for b in ds.buckets]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    cpu_ds = dataclasses.replace(ds, buckets=tuple(cpu_buckets), device=ref_dev,
                                 lane_layouts={})
    t0 = time.perf_counter()
    vg_ref = fre.projection_value_and_grad(
        problem, cpu_buckets, fre._designs(cpu_ds, cpu_buckets), offsets.to(ref_dev),
        [b.to(ref_dev) for b in lats], tuple(P.shape))
    fr, gr = vg_ref(P.reshape(-1).to(ref_dev))
    ref_s = time.perf_counter() - t0
    f_err = abs(f1.item() - fr.item()) / abs(fr.item())
    g_err = _stack_rel_err(torch, [g1], [gr])
    out["point"] = {"value": f1.item(), "value_rel_err_vs_ref": f_err,
                    "grad_rel_err_vs_ref": g_err, "limit": FACTORED_POINT_RTOL_F32,
                    "bit_equal_repeat": bit_equal, "evaluation_s": t1,
                    "ref_evaluation_s": ref_s}
    if not (bit_equal and f_err <= FACTORED_POINT_RTOL_F32
            and g_err <= FACTORED_POINT_RTOL_F32):
        failures.append(f"projection objective at one point: {out['point']}")
    del vg, vg_ref, cpu_buckets, cpu_ds, g1, g2, gr

    # the f64 witness, cuda against cpu
    small = game_arrays_bench(seed=2, **dict(sizes, n_users=f64_users))
    wit, wsteps, kept = {}, {}, {}
    for d in (dev, ref_dev):
        b64 = game_bundle(torch, small, d, torch.float64)
        e64 = factored_estimator(FACTORED["latent"], FACTORED["alternations"], ())
        wit[d.type], wsteps[d.type] = _factored_fit(torch, cs, e64, b64, None, cfgs, d)
        if d == dev:
            kept = {"est": e64, "bundle": b64}
    apart = _decisions_apart(torch, wsteps[dev.type], wsteps[ref_dev.type], wit[dev.type],
                             wit[ref_dev.type])
    rel = _stack_rel_err(torch, _game_tensors(wit[dev.type]["results"][0]),
                         _game_tensors(wit[ref_dev.type]["results"][0]))
    split = bool(apart["projection_steps"] or sum(apart["final_latent_lanes"].values())
                 or apart["fixed_steps"])
    lim = FACTORED_RTOL_F64_SPLIT if split else FACTORED_RTOL_F64
    out["f64"] = {"users": f64_users, "coef_rel_err_vs_ref": rel, "limit": lim,
                  "decisions_apart": apart,
                  "fit_s": {k: v["fit_s"] for k, v in wit.items()},
                  "projection_iterations": {
                      k: [s["iterations"] for s in v.summary()["projection_steps"]]
                      for k, v in wsteps.items()}}
    if not rel <= lim:
        failures.append(f"f64 witness: effective coefficients {rel} apart "
                        f"(decisions apart {apart}) > {lim}")
    out["save_and_score"] = factored_save_and_score(
        torch, dict(sizes, n_users=f64_users), small, kept["est"], kept["bundle"],
        wit[dev.type]["results"][0], dev, root)
    if failures:
        emit({"phase": "factored", **out})
        raise AssertionError("; ".join(failures))
    out["launches"] = launches
    return out


# ----------------------------------------------------------- tuning (M12)

# BASELINE config 4 (``bench.py``'s ``bench_tuner``): per-user + per-item
# random effects, GP over three (0.01, 100) ranges, 3 trials.
TUNER = dict(n_users=2000, rows_per_user=16, valid_rows_per_user=4, d_global=4096,
             d_user=8, n_items=500, iterations=10, trials=3)
TUNER_RANGES = {"fixed": (0.01, 100.0), "perUser": (0.01, 100.0),
                "perItem": (0.01, 100.0)}


def tuner_estimator():
    from photon_tpu_torch.estimators.config import (
        FixedEffectDataConfig,
        RandomEffectDataConfig,
    )
    from photon_tpu_torch.estimators.game_estimator import GameEstimator
    from photon_tpu_torch.types import TaskType

    return GameEstimator(
        TaskType.LOGISTIC_REGRESSION,
        {"fixed": FixedEffectDataConfig("global"),
         "perUser": RandomEffectDataConfig("userId", "global"),
         "perItem": RandomEffectDataConfig("itemId", "global")},
        n_sweeps=1, evaluator_specs=("AUC",))


def phase_tuning(torch, cs, sizes, dev, root: str) -> dict:
    """Regularization tuning at BASELINE config 4's widths (``bench_tuner``:
    2,000 users x 16 rows, validation 2,000 x 4, 4,096 global columns, 500
    items; fixed + perUser + perItem, AUC, ``sizes['iterations']``
    iterations, 1 sweep; GP over three (0.01, 100) ranges,
    ``sizes['trials']`` trials) through ``tune_regularization`` on ``dev``:
    seconds a trial and the best AUC. Killed after trial 1 under the port's
    ``CheckpointManager`` and resumed: the history (points, values) and the
    best model bit-identical to the uninterrupted search. Then
    ``game_training_driver`` on the drivers' rows (``root/data.avro``,
    validated on ``root/valid.avro``) with ``--tuning gp`` over
    ``fixed`` and a factored ``perUser`` (latent 4) and ``--checkpoint-dir``;
    its best model scored by the port's scoring driver. Returns the
    phase's launches under ``launches``."""
    from photon_tpu_torch.checkpoint import CheckpointManager
    from photon_tpu_torch.cli import game_scoring_driver, game_training_driver
    from photon_tpu_torch.estimators.config import GLMOptimizationConfiguration
    from photon_tpu_torch.hyperparameter import tune_regularization
    from photon_tpu_torch.optim.regularization import (
        RegularizationContext,
        RegularizationType,
    )

    shape = {k: sizes[k] for k in ("n_users", "rows_per_user", "d_global", "d_user",
                                   "n_items")}
    train = game_bundle(torch, game_arrays_bench(seed=5, **shape), dev, torch.float32)
    valid = game_bundle(torch, game_arrays_bench(
        seed=6, **dict(shape, rows_per_user=sizes["valid_rows_per_user"])),
        dev, torch.float32)
    base = {cid: GLMOptimizationConfiguration(
        regularization=RegularizationContext(RegularizationType.L2), reg_weight=1.0,
        max_iterations=sizes["iterations"]) for cid in TUNER_RANGES}
    n = sizes["trials"]
    cs.reset_launch_counts()
    est = tuner_estimator()
    trial_s: list = []
    fit = est.fit

    def timed_fit(*a, **kw):
        out, dt = _timed(torch, dev, lambda: fit(*a, **kw))
        trial_s.append(dt)
        return out

    est.fit = timed_fit
    ref, wall = _timed(torch, dev, lambda: tune_regularization(
        est, train, valid, base, TUNER_RANGES, n_iterations=n, strategy="gp", seed=0))
    ck = os.path.join(root, "tuning_ck")
    shutil.rmtree(ck, ignore_errors=True)
    mgr = CheckpointManager(ck, fail_after=1)
    killed = False
    try:
        tune_regularization(tuner_estimator(), train, valid, base, TUNER_RANGES,
                            n_iterations=n, strategy="gp", seed=0,
                            checkpoint_manager=mgr)
    except KeyboardInterrupt:
        killed = True
    mgr.close()
    mgr = CheckpointManager(ck)
    resumed, resume_s = _timed(torch, dev, lambda: tune_regularization(
        tuner_estimator(), train, valid, base, TUNER_RANGES, n_iterations=n,
        strategy="gp", seed=0, checkpoint_manager=mgr))
    mgr.close()
    identical = (killed
                 and np.array_equal(resumed.search.points, ref.search.points)
                 and np.array_equal(resumed.search.values, ref.search.values)
                 and all(torch.equal(a, b) for a, b in zip(
                     _game_tensors(resumed.best_result),
                     _game_tensors(ref.best_result))))
    out = {"shape": shape, "iterations": sizes["iterations"], "trials": n,
           "wall_s": wall, "trial_s": trial_s,
           "points": ref.search.points.tolist(), "values": ref.search.values.tolist(),
           "best_auc": -ref.search.best_value,
           "best_reg_weights": {c: ref.best_config[c].reg_weight for c in TUNER_RANGES},
           "killed_after_trial": 1, "resume_s": resume_s,
           "resumed_bit_identical": identical}

    # the driver: GP tuning over a fixed and a factored random effect
    dest = os.path.join(root, "game_train_tuned")
    shutil.rmtree(os.path.join(root, "tuned_ck"), ignore_errors=True)
    specs = ["fixed:type=fixed,shard=global,reg=L2,reg_weights=1,max_iter=20",
             "perUser:type=factored,re_type=userId,shard=global,latent=4,reg=L2,"
             "reg_weights=1,max_iter=20"]
    summary, dwall = _timed(torch, dev, lambda: game_training_driver.run([
        "--train-data", os.path.join(root, "data.avro"),
        "--validation-data", os.path.join(root, "valid.avro"),
        "--evaluators", "AUC", "--output-dir", dest, "--task", "LOGISTIC_REGRESSION",
        "--coordinate", specs[0], "--coordinate", specs[1],
        "--index-dir", os.path.join(root, "out", "index"),
        "--tuning", "gp", "--tuning-iterations", "3",
        "--tuning-range", "fixed:0.01:100", "--tuning-range", "perUser:0.01:100",
        "--checkpoint-dir", os.path.join(root, "tuned_ck"),
        "--re-routing", "static", "--device", dev.type]))
    scored = game_scoring_driver.run([
        "--data", os.path.join(root, "valid.avro"), "--model-dir",
        os.path.join(dest, "best"), "--output-dir", os.path.join(root, "tuned_scores"),
        "--device", dev.type, "--evaluators", "AUC"])
    out["driver"] = {"wall_s": dwall, "fit_seconds": summary["fit_seconds"],
                     "evaluation": summary["evaluation"],
                     "best_config": {c: summary["best_config"][c]["reg_weight"]
                                     for c in ("fixed", "perUser")},
                     "factored_latent_dim": json.load(open(os.path.join(
                         dest, "best", "game-metadata.json")))["coordinates"][
                             "perUser"].get("factored_latent_dim"),
                     "scoring": scored["evaluation"],
                     **_stage_seconds(os.path.join(dest, "photon.log"))}
    ok = (identical and np.isfinite(out["values"]).all() and out["best_auc"] > 0.5
          and out["driver"]["factored_latent_dim"] == 4
          and np.isfinite(scored["evaluation"]["AUC"]))
    if not ok:
        emit({"phase": "tuning", **out})
        raise AssertionError(f"tuning: resumed bit-identical {identical}, values "
                             f"{out['values']}, driver {out['driver']}")
    out["launches"] = cs.launch_counts()
    return out


# ------------------------------------------------------------------ checkpoints

JAX_SNAPSHOT = os.path.join(REPO, "tests", "data", "jax_checkpoint")


def _values(evaluation):
    return None if evaluation is None else evaluation.values


def _tracker_diffs(torch, got, want) -> list:
    """Where two fits' results differ: coefficients, evaluations, tracker
    records (position, validation metrics, every result tensor)."""
    bad = []
    for i, (rg, rw) in enumerate(zip(got, want)):
        if not all(torch.equal(a, b) for a, b in zip(_game_tensors(rg),
                                                     _game_tensors(rw))):
            bad.append(f"config {i}: coefficients")
        if _values(rg.evaluation) != _values(rw.evaluation):
            bad.append(f"config {i}: evaluation")
        if len(rg.tracker) != len(rw.tracker):
            bad.append(f"config {i}: tracker length")
        for tg, tw in zip(rg.tracker, rw.tracker):
            where = f"config {i} sweep {tw.sweep} {tw.coordinate_id}"
            if (tg.sweep, tg.coordinate_id) != (tw.sweep, tw.coordinate_id):
                bad.append(f"{where}: position")
            if _values(tg.validation) != _values(tw.validation):
                bad.append(f"{where}: validation metrics")
            res = [(tg.result, tw.result)] if not isinstance(tw.result, list) \
                else list(zip(tg.result, tw.result))
            for a, b in res:
                for k, v in vars(b).items():
                    x = getattr(a, k)
                    if isinstance(v, torch.Tensor):
                        same = torch.equal(x, v)
                    else:
                        same = x == v
                    if not same:
                        bad.append(f"{where}: result {k}")
    return bad


def phase_checkpoint(torch, cs, keep: dict, root: str) -> dict:
    """Fit A of phase ``game_training`` (same estimator, bundles and
    configurations) with ``CheckpointManager(fail_after=2)``: killed after
    its second coordinate step, resumed in a fresh manager; the result is
    bit-identical to phase ``game_training``'s uninterrupted fit A (models,
    tracker records, their results and validation metrics): fit A's repeat
    on the card. A snapshot the JAX package wrote
    (``tests/data/jax_checkpoint``) is refused by its magic."""
    from photon_tpu_torch.checkpoint import CheckpointManager, ForeignCheckpoint

    est, (train, valid), cfgs = keep["est"], keep["data"], keep["cfgs"]
    dev = train.device
    ckdir = os.path.join(root, "checkpoint")
    shutil.rmtree(ckdir, ignore_errors=True)
    cs.reset_launch_counts()
    mgr = CheckpointManager(ckdir, fail_after=2)
    t0 = time.perf_counter()
    try:
        est.fit(train, valid, cfgs, checkpoint_manager=mgr)
        raise AssertionError("the checkpointed fit was not killed by fail_after")
    except KeyboardInterrupt:
        killed_s = time.perf_counter() - t0
    mgr.close()
    out = {"steps_before_kill": 2, "killed_fit_s": killed_s,
           "save_host_copy_s": mgr.last_save_seconds,
           "save_write_s": mgr.last_write_seconds,
           "snapshot_bytes": mgr.last_bytes,
           "snapshots": sorted(os.listdir(ckdir))}
    fresh = CheckpointManager(ckdir)
    payload, load_s = _timed(torch, dev, lambda: fresh.load_latest(dev))
    out["load_s"] = load_s
    out["resumed_from"] = {k: payload["meta"][k] for k in ("sweep", "coord_index",
                                                           "config_index")}
    del payload
    resumed, resume_s = _timed(torch, dev, lambda: est.fit(
        train, valid, cfgs, checkpoint_manager=fresh))
    fresh.close()
    out["resume_fit_s"] = resume_s
    out["launches"] = cs.launch_counts()
    bad = _tracker_diffs(torch, resumed, keep["results"])
    out["bit_identical"] = not bad
    jdir = os.path.join(root, "jax_checkpoint")
    shutil.rmtree(jdir, ignore_errors=True)
    shutil.copytree(JAX_SNAPSHOT, jdir)
    try:
        CheckpointManager(jdir).load_latest(dev)
        bad.append("the JAX package's snapshot was not refused")
    except ForeignCheckpoint as e:
        out["jax_snapshot_refused"] = str(e).split(":", 1)[1].strip()[:120]
    if bad:
        emit({"phase": "checkpoint", **out})
        raise AssertionError("resume: " + "; ".join(bad[:10]))
    return out


# ------------------------------------------------------------------ routing


def phase_routing(torch, cs, keep: dict, root: str) -> dict:
    """Fit A's random-effect coordinate (its prepared dataset, at fit A's
    final fixed-effect offsets) under the static plan, then under
    ``PHOTON_RE_ROUTING=measured`` with a cost table in ``root``: the first
    measured solve races each shape class's candidates and saves the table;
    each bucket whose winner is its static plan solves bit for bit as the
    static solve; a second solve with the table reloaded (as a restarted
    process loads it) calibrates nothing, repeats every decision and the
    coefficients bit for bit. Then the chunked vmapped baseline: the table
    seeded with the lanes cheapest routes every bucket to lanes over
    entity slices of ``VMAPPED_CHUNK_CAP``, held within ``COEF_BAR_F32`` of
    the whole-bucket lanes (``PHOTON_RE_NEWTON=0``'s static plan) on the
    same offsets."""
    from photon_tpu_torch.functions.objective import intercept_reg_mask
    from photon_tpu_torch.game import solver_routing
    from photon_tpu_torch.game.random_effect import bucket_records, train_random_effects
    from photon_tpu_torch.types import TaskType

    est, (train, _), cfgs = keep["est"], keep["data"], keep["cfgs"]
    dev = train.device
    ds = est._prepare_cached(train)["datasets"]["perUser"]
    problem = cfgs[0]["perUser"].problem(TaskType.LOGISTIC_REGRESSION)
    mask = intercept_reg_mask(ds.global_dim, None, device=dev)
    offsets = train.features["global"].with_matvec_layout().matvec(
        keep["results"][0].model["fixed"].model.coefficients.means)

    def solve():
        return train_random_effects(problem, ds, offsets, global_reg_mask=mask)

    def run():
        return solve()[0]

    run()
    static, static_s = _timed(torch, dev, run)
    static_plans = [(r["solver"], r["chunk"]) for r in bucket_records()]
    table = os.path.join(root, "solver_costs.json")
    if os.path.exists(table):
        os.remove(table)
    cs.reset_launch_counts()
    with _env("PHOTON_RE_ROUTING", "measured"), _env("PHOTON_RE_COST_TABLE", table):
        solver_routing.reset_process_table()
        first, first_s = _timed(torch, dev, run)
        rec1 = bucket_records()
        solver_routing.reset_process_table()      # a restart reloads the file
        second, second_s = _timed(torch, dev, run)
        rec2 = bucket_records()
    solver_routing.reset_process_table()
    with open(table) as f:
        entries = json.load(f)["entries"]
    # every candidate raced is priced; the lanes cheapest
    seeded = os.path.join(root, "solver_costs_lanes.json")
    with open(seeded, "w") as f:
        json.dump({"version": 1, "entries": {
            key: {ck: 1e-9 if ck.startswith("vmapped_lbfgs@") else 1e9
                  for ck in costs} for key, costs in entries.items()}}, f)
    with _env("PHOTON_RE_ROUTING", "measured"), _env("PHOTON_RE_COST_TABLE", seeded):
        solver_routing.reset_process_table()
        (chunked, chunked_res), chunked_s = _timed(torch, dev, solve)
        rec3 = bucket_records()
    solver_routing.reset_process_table()
    launches = cs.launch_counts()
    with _env("PHOTON_RE_NEWTON", "0"):
        (whole, whole_res), whole_s = _timed(torch, dev, solve)
        rec4 = bucket_records()
    classes = {}
    for b, r in zip(ds.buckets, rec1):
        key = solver_routing.shape_class(b)
        c = classes.setdefault(key, {"buckets": 0, "entities": 0,
                                     "calibration_s": 0.0, "costs": entries.get(key)})
        c["buckets"] += 1
        c["entities"] += r["entities"]
        c["calibration_s"] += r["calibration_seconds"]
        c["winner"] = f"{r['solver']}@{r['chunk']}"
        c["static_plan"] = f"{static_plans[r['bucket']][0]}@{static_plans[r['bucket']][1]}"
    out = {"classes": classes, "re_step_s": {"static": static_s,
                                             "measured_first": first_s,
                                             "measured_reloaded": second_s},
           "calibrated_buckets": sum(r["calibrated"] for r in rec1),
           "coef_rel_err_measured_vs_static": _stack_rel_err(
               torch, first.bucket_coefs, static.bucket_coefs),
           "launches": launches}
    bad = []
    if not any(r["calibrated"] for r in rec1):
        bad.append("the first measured solve raced nothing")
    same_plan = [b for b, r in enumerate(rec1)
                 if (r["solver"], r["chunk"]) == static_plans[b]]
    out["static_plan_buckets_bit_equal"] = [
        torch.equal(first.bucket_coefs[b], static.bucket_coefs[b]) for b in same_plan]
    if not all(out["static_plan_buckets_bit_equal"]):
        bad.append("a bucket routed to its static plan solved otherwise than "
                   "the static solve")
    lanes_rel = _stack_rel_err(torch, chunked.bucket_coefs, whole.bucket_coefs)
    out["chunked_lanes"] = {
        "plans": [f"{r['solver']}@{r['chunk']}" for r in rec3],
        "whole_plans": [f"{r['solver']}@{r['chunk']}" for r in rec4],
        "re_step_s": {"chunked": chunked_s, "whole_bucket": whole_s},
        "coef_rel_err_vs_whole_bucket": lanes_rel, "bar": COEF_BAR_F32,
        "lanes_iterations_equal_share": float(np.mean(np.concatenate([
            (a.iterations == b.iterations).cpu().numpy()
            for a, b in zip(chunked_res, whole_res)])))}
    # the lanes' raced chunk: the widest Newton chunk, capped at
    # VMAPPED_CHUNK_CAP (4,096 at fit A's size)
    if any(r["solver"] != "vmapped_lbfgs" or r["calibrated"]
           or f"vmapped_lbfgs@{r['chunk']}" not in entries[
               solver_routing.shape_class(ds.buckets[r["bucket"]])]
           for r in rec3):
        bad.append(f"the lanes-cheapest table routed {out['chunked_lanes']['plans']}")
    if any((r["solver"], r["chunk"]) != ("vmapped_lbfgs", None) for r in rec4):
        bad.append(f"PHOTON_RE_NEWTON=0 planned {out['chunked_lanes']['whole_plans']}")
    if not lanes_rel <= COEF_BAR_F32:
        bad.append(f"the chunked lanes are {lanes_rel} from the whole-bucket "
                   f"lanes (> {COEF_BAR_F32})")
    if any(r["calibrated"] for r in rec2):
        bad.append("the reloaded table calibrated again")
    if [(r["solver"], r["chunk"]) for r in rec2] != [(r["solver"], r["chunk"])
                                                     for r in rec1]:
        bad.append("the reloaded table routed otherwise")
    if not all(torch.equal(a, b) for a, b in zip(first.bucket_coefs,
                                                 second.bucket_coefs)):
        bad.append("the reloaded table's coefficients differ")
    out["repeat_bit_equal"] = "the reloaded table's coefficients differ" not in bad
    if bad:
        emit({"phase": "routing", **{k: v for k, v in out.items()
                                     if k != "launches"}})
        raise AssertionError("; ".join(bad))
    return out


# ------------------------------------------------------------------ sweep cache


class _StepUploads:
    """Host-to-device bytes of host-resident random-effect data at the end
    of every coordinate step (bucket uploads and the sweep cache's
    mirror), by the descent logger's per-step message."""

    def __init__(self, cache_of):
        import logging

        from photon_tpu_torch.data import random_effect as re_data

        self.snaps = []
        self.handler = logging.Handler()
        self.handler.emit = lambda rec: self.snaps.append(
            (rec.args[0], re_data.UPLOADS["bytes"] + cache_of().uploaded_bytes))
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
        out, prev = {}, 0
        for sweep, total in self.snaps:
            out[sweep] = out.get(sweep, 0) + total - prev
            prev = total
        return [out[k] for k in sorted(out)]


def phase_sweep_cache(torch, cs, sizes, dev) -> dict:
    """Fit B (the ``user`` shard, SIMPLE variances, 2 sweeps, no validation)
    with host-resident random-effect buckets, the device sweep cache at
    2048 MB and at 0 (off): bit-identical models; the host-to-device bytes
    of each sweep, the cache's resident and spilled bytes, hits and
    misses. With the cache on, sweep 2 uploads nothing."""
    from photon_tpu_torch.data import random_effect as re_data
    from photon_tpu_torch.estimators.config import (
        FixedEffectDataConfig,
        RandomEffectDataConfig,
    )
    from photon_tpu_torch.estimators.game_estimator import GameEstimator
    from photon_tpu_torch.types import TaskType

    arrays = game_arrays_bench(seed=2, **sizes)
    train = game_bundle(torch, arrays, dev, torch.float32)
    cfgs = game_configs((1.0,), sizes["iterations"], "SIMPLE")
    runs, models = {}, {}
    cs.reset_launch_counts()
    for mb in (2048, 0):
        est = GameEstimator(
            TaskType.LOGISTIC_REGRESSION,
            {"fixed": FixedEffectDataConfig("global"),
             "perUser": RandomEffectDataConfig("userId", "user", host_resident=True)},
            n_sweeps=2, intercept_indices={"user": 0}, sweep_cache_mb=mb)
        re_data.reset_uploads()
        with _StepUploads(lambda: est._prep_cache[1]["device_cache"]) as ups:
            results, wall = _timed(torch, dev, lambda: est.fit(train, None, cfgs))
        cache = est._prep_cache[1]["device_cache"]
        runs[mb] = {"fit_s": wall, "h2d_bytes_per_sweep": ups.per_sweep(),
                    "bucket_uploads": re_data.UPLOADS["buckets"],
                    "resident_bytes": cache.resident_bytes,
                    "spilled_bytes": cache.spilled_bytes, "hits": cache.hits,
                    "misses": cache.misses}
        models[mb] = results
        del est
    launches = cs.launch_counts()
    bad = [f"cache on against off: {d}"
           for d in _tracker_diffs(torch, models[2048], models[0])]
    on, off = runs[2048]["h2d_bytes_per_sweep"], runs[0]["h2d_bytes_per_sweep"]
    if len(on) != 2 or on[1] != 0:
        bad.append(f"sweep 2 uploaded {on[1:]} bytes with the cache on")
    if len(off) != 2 or not off[1] > 0:
        bad.append(f"sweep 2 uploaded {off[1:]} bytes with the cache off")
    out = {"runs": {"cache_2048mb": runs[2048], "cache_off": runs[0]},
           "bit_identical": not bad, "launches": launches}
    if bad:
        emit({"phase": "sweep_cache", **out})
        raise AssertionError("; ".join(bad))
    return out


# ----------------------------------------------------------- runtime guards

GUARD_GLM_AFTER = 5         # the out-of-core faults fire a few hits in
# The Newton budget of the real OOM: fit A's bucket (100,000 entities, S =
# 16, P = 256) then plans its whole-bucket dual solve (a 1.6 GB dense design
# in f32, 2.1 GB by newton_re's budget formula), and one tier down is dual
# chunks of 16,384 entities. At the default 2,048 MB the plan is dual
# chunks of 4,096, whose peak of live bytes was no higher than that of
# chunks of 1,024 on an H100 80GB HBM3: no cap separates those two.
GUARD_RE_BUDGET_MB = 8192


class _JournalTap:
    """A ``memory_guard`` journal that keeps every row. At a downshift (inside
    the ladder's handler) it reads the failed attempt's peak bytes and the
    memory watchdog."""

    def __init__(self, torch, dev, guard):
        self.torch, self.dev, self.guard = torch, dev, guard
        self.rows = []

    def record(self, event, **fields):
        row = {"event": event, **fields}
        if event == "oom_downshift" and self.dev.type == "cuda":
            row["failed_peak_allocated"] = self.torch.cuda.max_memory_allocated(
                self.dev)
            row["memory_guard_sample"] = self.guard.sample(force=True)
            row["memory_guard_check"] = self.guard.check()
        self.rows.append(row)


def _peak_reset_at(torch, dev, site: str, chunk, into: dict):
    """A fault spec that raises nothing: where the ladder dispatches
    ``chunk`` (its retry, after the failed attempt's handler has freed that
    attempt's tensors) it notes the bytes in use and resets the peak
    counter, so the peak after the run is the retry's own."""
    from photon_tpu_torch.faults import FaultSpec

    def probe(message):
        into["retry_base_allocated"] = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    return FaultSpec(site=site, error_factory=probe, match={"chunk": str(chunk)},
                     count=1)


def _guard_counts() -> dict:
    """Every guard's counter: OOM downshifts and restarts, by label."""
    from photon_tpu_torch.obs.metrics import REGISTRY

    out = {}
    for name in ("oom_downshifts_total", "run_restarts_total"):
        for labels, v in REGISTRY.counter(name).collect():
            out[f"{name}{sorted(labels.items())}"] = v
    return out


def _measured(torch, dev, fn, before=None):
    """``fn()`` from an emptied allocator cache with the peak counters reset:
    (result, {seconds, and on the card the reserved and allocated bytes
    before it and their peaks above that}); ``before(stats)`` runs just
    before ``fn``."""
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    st = {"base_reserved": torch.cuda.memory_reserved(dev) if cuda else None,
          "base_allocated": torch.cuda.memory_allocated(dev) if cuda else None}
    if before is not None:
        before(st)
    out, st["seconds"] = _timed(torch, dev, fn)
    if cuda:
        st["peak_reserved_above"] = torch.cuda.max_memory_reserved(dev) - st[
            "base_reserved"]
        st["peak_allocated_above"] = torch.cuda.max_memory_allocated(dev) - st[
            "base_allocated"]
    return out, st


def _glm_run(torch, dev, root, name, flags, plan=None) -> dict:
    """The GLM driver's out-of-core run (``GLM_RUNS["out_of_core"]``'s flags
    plus ``flags``), under a fault plan when given."""
    from photon_tpu_torch.cli import glm_training_driver
    from photon_tpu_torch.faults import FaultPlan, FaultSpec, active_plan

    dest = os.path.join(root, name)
    plan = FaultPlan(specs=[FaultSpec(**plan)] if plan else [])
    with _env("PHOTON_VALUE_DTYPE", ""), active_plan(plan) as inj:
        summary, wall = _timed(torch, dev, lambda: glm_training_driver.run(flags + [
            "--output-dir", dest]))
    with open(os.path.join(dest, "photon.log")) as f:
        log = f.read()
    return {"wall_s": wall, "fit_seconds": summary["fit_seconds"], "fired": inj.fired(),
            "iterations": summary["sweep"][0]["iterations"],
            "data_passes": summary["sweep"][0]["data_passes"],
            "n_chunks": summary["n_chunks"], "dir": os.path.join(dest, "best"),
            "log": log}


def phase_runtime_guards(torch, cs, keep: dict, root: str, big: str, probe: dict,
                         dev, chunk_rows: int = GLM_CHUNK_ROWS) -> dict:
    """The runtime guards on the card (``runtime/``, ``supervisor.py``,
    ``faults/``). (a) The backend probe ``main`` ran before any CUDA work.
    (b) A genuine ``torch.cuda.OutOfMemoryError`` in fit A's largest
    random-effect bucket, its plan the whole-bucket dual solve (under
    ``GUARD_RE_BUDGET_MB``): the process capped by
    ``set_per_process_memory_fraction`` between the peaks of its plan and of
    one tier down (both measured first; the cap bisected until the plan
    fails and the tier below completes); the ladder must
    downshift exactly one tier and give the coefficients of the solve
    started at that tier with the sticky plan set, bit for bit, at a lower
    peak; the cap is lifted after. (c) An injected ``device_oom`` at
    ``re.solve`` under measured routing demotes to that same sticky tier.
    (d) The GAME training driver on the drivers' rows with
    ``--checkpoint-dir``, ``--max-restarts 2`` and a preemption at
    ``descent.step`` step 2: its model files byte-equal (without their Avro
    sync markers) to phase ``game_training_driver``'s unsupervised run, one
    classified restart in ``recovery.jsonl``. (e) The GLM driver out of core
    on phase ``ingest``'s 2^19 rows (chunks of ``chunk_rows``): a
    ``device_oom`` at ``optim.ooc_chunk`` completes at half the rows a chunk,
    bit-equal to a run started there; a ``device_lost`` at
    ``optim.ooc_iteration`` recovers in-run, bit-equal to phase
    ``glm_driver``'s uninterrupted run. (f) ``MemoryGuard`` readings during
    (b) and ``effective_sweep_budget`` of a request above the free bytes.
    (g) Every run without a planted fault leaves every guard's counter as
    it was, and the planted ones move them by exactly their faults. On a
    CPU (the isolation test) (b) injects the OOM instead of capping."""
    from photon_tpu_torch.cli import game_training_driver
    from photon_tpu_torch.faults import FaultPlan, FaultSpec, active_plan
    from photon_tpu_torch.functions.objective import intercept_reg_mask
    from photon_tpu_torch.game import random_effect as re_mod
    from photon_tpu_torch.game import solver_routing
    from photon_tpu_torch.runtime import memory_guard as mg
    from photon_tpu_torch.types import TaskType

    cuda = dev.type == "cuda"
    failures = []
    out = {"probe": probe}
    cs.reset_launch_counts()
    counts0 = _guard_counts()

    def unplanted(what, fn):
        before = _guard_counts()
        res = fn()
        if _guard_counts() != before:
            failures.append(f"{what}: a guard fired with no fault planted")
        return res

    # (b) a real OOM in fit A's largest bucket
    est, (train, _), cfgs = keep["est"], keep["data"], keep["cfgs"]
    ds = est._prepare_cached(train)["datasets"]["perUser"]
    problem = cfgs[0]["perUser"].problem(TaskType.LOGISTIC_REGRESSION)
    mask = intercept_reg_mask(ds.global_dim, None, device=dev)
    offsets = train.features["global"].with_matvec_layout().matvec(
        keep["results"][0].model["fixed"].model.coefficients.means)
    b = max(range(len(ds.buckets)), key=lambda i: ds.buckets[i].n_entities)
    bucket = ds.bucket(b)
    local_mask, batches, _ = re_mod.bucket_inputs(ds, b, offsets, mask, None, bucket)
    w0 = torch.zeros((bucket.n_entities, bucket.local_dim), dtype=bucket.val.dtype,
                     device=dev)

    def solve():
        model, _, info = re_mod._solve_bucket(problem, ds, b, batches, w0, local_mask,
                                              None, None, None, bucket)
        return model.coefficients.means, (info["solver"], info["chunk"])

    # Under GUARD_RE_BUDGET_MB the bucket's static plan is its whole-bucket
    # dual solve; (c) sets measured routing itself.
    saved_env = {k: os.environ.get(k) for k in ("PHOTON_RE_ROUTING",
                                                "PHOTON_RE_NEWTON_BUDGET_MB")}
    os.environ.update(PHOTON_RE_ROUTING="static",
                      PHOTON_RE_NEWTON_BUDGET_MB=str(GUARD_RE_BUDGET_MB))

    mg.reset_state()
    (got, plan), hi = unplanted("re_solve_plan", lambda: _measured(torch, dev, solve))
    del got
    nxt = re_mod._oom_next_tier(*plan, bucket.n_entities)
    sticky = {"chunk": nxt[1], "solver": nxt[0] if nxt[0] == "vmapped_lbfgs" else None}
    mg.set_sticky_plan("re.solve", sticky)
    (want, lo_plan), lo = unplanted("re_solve_next_tier",
                                    lambda: _measured(torch, dev, solve))
    mg.reset_state()
    guard = mg.MemoryGuard(min_sample_interval_s=0.0)
    oom = {"bucket": b, "entities": bucket.n_entities, "S": bucket.max_samples,
           "P": bucket.local_dim, "plan": plan, "next_tier": nxt,
           "plan_run": hi, "next_tier_run": lo, "watchdog_before": guard.check()}

    def attempt(above=None):
        """The solve under a cap of ``above`` bytes over the memory held
        before it (on the card), or under an injected OOM (on a CPU):
        (coefficients, plan, run stats, downshift rows, escalated error)."""
        tap = _JournalTap(torch, dev, guard)
        mg.reset_state()
        mg.set_journal(tap)
        retry, fields = {}, {}
        got = got_plan = run = err = None
        if above is None:
            specs = [FaultSpec(site="re.solve", error="device_oom", count=1)]
        else:
            specs = [_peak_reset_at(torch, dev, "re.solve", nxt[1], retry)]
            index = torch.cuda.current_device() if dev.index is None else dev.index
            total = torch.cuda.mem_get_info(dev)[1]

            def cap(st):
                fields.update(cap_above_base=above, cap_bytes=st["base_reserved"] + above,
                              device_total=total)
                torch.cuda.set_per_process_memory_fraction(fields["cap_bytes"] / total,
                                                           index)
        try:
            with active_plan(FaultPlan(specs=specs)):
                (got, got_plan), run = _measured(torch, dev, solve,
                                                 before=None if above is None else cap)
        except Exception as e:  # noqa: BLE001 - a cap too low for every tier
            if not mg.is_oom(e):
                raise
            err = f"{type(e).__name__}: {str(e)[:160]}"
        finally:
            mg.set_journal(None)
            if above is not None:
                torch.cuda.set_per_process_memory_fraction(1.0, index)
        if run is not None:
            run.update(fields)
            if "retry_base_allocated" in retry:
                run["retry_peak_allocated_above"] = (
                    torch.cuda.max_memory_allocated(dev) - retry["retry_base_allocated"])
        return got, got_plan, run, [r for r in tap.rows
                                    if r["event"] == "oom_downshift"], err

    if cuda:
        # The cap: bisected between the next tier's peak of live bytes (a cap
        # below it leaves that tier no room) and the plan's peak of reserved
        # bytes (the plan ran within it), until the plan runs out of memory
        # and the ladder's one step down completes. The allocator frees its
        # cached blocks before it gives up, so where in that range the plan
        # fails is the allocator's to say, not a formula's.
        low, high = lo["peak_allocated_above"], hi["peak_reserved_above"]
        trials = []
        result = None
        for _ in range(8):
            if high - low < 2 << 20:
                break
            above = (low + high) // 2
            got, got_plan, run, downs, err = attempt(above)
            trials.append({"cap_above_base": above, "downshifts": len(downs),
                           "plan": got_plan, "escalated": err})
            if err is None and not downs:
                high = above            # the plan fit: lower the cap
            elif err is None and len(downs) == 1 and tuple(got_plan) == tuple(nxt):
                result = got, got_plan, run, downs
                break
            else:
                low = above             # more than one tier down: raise it
        oom["cap_trials"] = trials
        oom["re_solve_downshifts_in_trials"] = sum(t["downshifts"] for t in trials)
        if result is None:
            raise AssertionError(f"no cap between {low} and {high} bytes took the plan "
                                 f"exactly one tier down: {trials}")
        got, got_plan, run, downs = result
    else:
        got, got_plan, run, downs, _ = attempt()
        oom["re_solve_downshifts_in_trials"] = len(downs)
    oom.update(run=run, tiers=[r.get("before") for r in downs] + [
        re_mod._plan_desc(*got_plan)], downshifts=len(downs),
        error=downs[0]["error"] if downs else None,
        classified_oom=bool(downs) and downs[0]["cause"] == "oom",
        bit_equal_next_tier=bool(torch.equal(got, want)),
        watchdog_after=guard.check())
    if cuda and downs:
        oom.update(failed_peak_allocated_above=downs[0]["failed_peak_allocated"]
                   - run["base_allocated"],
                   retry_peak_allocated_above=run["retry_peak_allocated_above"],
                   watchdog_at_oom={"sample": downs[0]["memory_guard_sample"],
                                    "check": downs[0]["memory_guard_check"]})
        if not run["retry_peak_allocated_above"] < hi["peak_allocated_above"]:
            failures.append("the retry's peak did not fall below the plan's")
        if "OutOfMemoryError" not in downs[0]["error"]:
            failures.append(f"not a torch OOM: {downs[0]['error']}")
    if len(downs) != 1 or tuple(got_plan) != tuple(nxt) or lo_plan != got_plan:
        failures.append(f"the ladder took {oom['tiers']}, not one tier to {nxt}")
    if not oom["bit_equal_next_tier"]:
        failures.append("the downshifted solve differs from the solve at its tier")
    out["real_oom" if cuda else "injected_oom"] = oom
    mg.reset_state()

    # (c) measured routing: an injected device_oom demotes to the same tier
    table = os.path.join(root, "guard_costs.json")
    with _env("PHOTON_RE_ROUTING", "measured"), _env("PHOTON_RE_COST_TABLE", table):
        solver_routing.reset_process_table()
        plan_c = FaultPlan(specs=[FaultSpec(site="re.solve", error="device_oom",
                                            count=1, match={"routing": "measured"})])
        with active_plan(plan_c) as inj:
            (got_c, plan_got_c), run_c = _measured(torch, dev, solve)
        solver_routing.reset_process_table()
    for k, v in saved_env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    out["measured_demotion"] = {"fired": inj.fired(), "plan": plan_got_c,
                                "sticky": mg.sticky_plan("re.solve"),
                                "seconds": run_c["seconds"],
                                "bit_equal_next_tier": bool(torch.equal(got_c, want))}
    if (inj.fired() != 1 or tuple(plan_got_c) != tuple(nxt)
            or mg.sticky_plan("re.solve") != sticky or not torch.equal(got_c, want)):
        failures.append(f"measured demotion: {out['measured_demotion']}")
    mg.reset_state()
    del got, got_c, want, w0, local_mask, batches

    # (f) the sweep-cache clamp at a request above the card's free bytes
    s = guard.sample(force=True)
    if s is not None:
        ask = int(2 * s["device_free"])
        got_b = mg.effective_sweep_budget(ask)
        out["sweep_budget"] = {"requested": ask, "effective": got_b,
                               "bytes_limit": s["bytes_limit"]}
        if got_b != int(s["bytes_limit"] * 0.5):
            failures.append(f"sweep budget {got_b} is not half the limit")
        mg.reset_state()

    # (d) the supervised GAME driver against the unsupervised one
    plan_path = os.path.join(root, "guard_preempt.json")
    with open(plan_path, "w") as f:
        json.dump({"seed": 0, "specs": [{"site": "descent.step", "error": "preemption",
                                         "after": 2, "count": 1}]}, f)
    specs = ["fixed:type=fixed,shard=global,reg=L2,reg_weights=1,max_iter=20",
             "perUser:type=random,re_type=userId,shard=global,reg=L2,"
             "reg_weights=1|10,max_iter=20"]
    dest = os.path.join(root, "guard_supervised")
    _, wall = _timed(torch, dev, lambda: game_training_driver.run([
        "--train-data", os.path.join(root, "data.avro"),
        "--validation-data", os.path.join(root, "valid.avro"),
        "--evaluators", "AUC", "LOGISTIC_LOSS", "--output-dir", dest,
        "--task", "LOGISTIC_REGRESSION", "--coordinate", specs[0],
        "--coordinate", specs[1], "--sweeps", "2",
        "--index-dir", os.path.join(root, "out", "index"), "--re-routing", "static",
        "--device", dev.type, "--checkpoint-dir", os.path.join(root, "guard_ck"),
        "--max-restarts", "2", "--restart-backoff", "0", "--fault-plan", plan_path]))
    with open(os.path.join(dest, "recovery.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    failed = [r for r in rows if r["event"] == "attempt_failed"]
    restarts = [r for r in rows if r["event"] == "restart"]
    resumed = [r for r in rows if r["event"] == "first_step" and r["attempt"] == 1]
    differ = _model_dirs_differ(os.path.join(dest, "best"),
                                os.path.join(root, f"game_train_{dev.type}", "best"))
    out["supervised_driver"] = {
        "wall_s": wall, "events": [r["event"] for r in rows],
        "restart_causes": [r["cause"] for r in restarts],
        "failure_to_resume_s": (resumed[0]["t"] - failed[0]["t"]
                                if resumed and failed else None),
        "restart_to_first_step_s": (resumed[0]["restart_to_first_step_seconds"]
                                    if resumed else None),
        "model_files_differ": differ}
    if [r["cause"] for r in restarts] != ["preemption"] or not resumed or differ:
        failures.append(f"supervised driver: {out['supervised_driver']}")

    # (e) out of core: an OOM halves the chunks, a device loss recovers in-run
    common = ["--train-data", big, "--task", "LOGISTIC_REGRESSION", "--index-dir",
              os.path.join(root, "out", "index"), "--device", dev.type, "--no-report",
              "--reg-weights", "1", "--max-iterations", str(GLM_ITERATIONS),
              "--variance", "NONE"]
    half = max(1, chunk_rows // 2)
    ooc = {
        "oom": _glm_run(torch, dev, root, "guard_glm_oom",
                        common + ["--row-chunk-rows", str(chunk_rows)],
                        dict(site="optim.ooc_chunk", error="device_oom",
                             after=GUARD_GLM_AFTER, count=1)),
        "half": unplanted("glm_half_cut", lambda: _glm_run(
            torch, dev, root, "guard_glm_half",
            common + ["--row-chunk-rows", str(half)])),
        "lost": _glm_run(torch, dev, root, "guard_glm_lost",
                         common + ["--row-chunk-rows", str(chunk_rows)],
                         dict(site="optim.ooc_iteration", error="device_lost",
                              after=GUARD_GLM_AFTER, count=1)),
    }
    ooc["oom"]["downshift"] = f"chunk_rows={chunk_rows} -> chunk_rows={half}"
    checks = {
        "oom_downshifted": ooc["oom"]["downshift"] in ooc["oom"]["log"],
        "oom_bit_equal_half_cut": not _model_dirs_differ(ooc["oom"]["dir"],
                                                         ooc["half"]["dir"]),
        "lost_recovered_in_run": "in-run recovery 1/" in ooc["lost"]["log"],
        "lost_bit_equal_uninterrupted": not _model_dirs_differ(
            ooc["lost"]["dir"], os.path.join(root, "glm_out_of_core", "best")),
        "fired": [ooc["oom"]["fired"], ooc["lost"]["fired"]] == [1, 1],
    }
    for run in ooc.values():
        del run["log"], run["dir"]
    ooc["half_chunks"] = ooc["half"]["n_chunks"]
    out["out_of_core"] = {**ooc, "checks": checks}
    failures += [f"out of core: {k}" for k, ok in checks.items() if not ok]

    # (g) the planted faults moved the counters by exactly their count
    moved = {k: v - counts0.get(k, 0) for k, v in _guard_counts().items()
             if v != counts0.get(k, 0)}
    want_moved = {"oom_downshifts_total[('cause', 'oom'), ('site', 're.solve')]":
                  oom["re_solve_downshifts_in_trials"] + 1,
                  "oom_downshifts_total[('cause', 'oom'), ('site', 'optim.ooc_chunk')]": 1,
                  "run_restarts_total[('cause', 'preemption')]": 1,
                  "run_restarts_total[('cause', 'device_lost')]": 1}
    out["guard_counters_moved"] = moved
    if moved != want_moved:
        failures.append(f"guard counters moved {moved}, not {want_moved}")
    out["launches"] = cs.launch_counts()
    if failures:
        emit({"phase": "runtime_guards",
              **{k: v for k, v in out.items() if k != "launches"}})
        raise AssertionError("runtime guards: " + "; ".join(failures))
    return out


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
    t_start = time.perf_counter()
    _START[0] = t_start
    # (runtime_guards, a) the backend probe, before any CUDA work here
    from photon_tpu_torch.runtime.backend_guard import ensure_backend

    probe = ensure_backend("strict")
    probe["wall_s"] = time.perf_counter() - t_start
    if probe["backend"] != "cuda" or not probe.get("device_name"):
        raise AssertionError(f"the backend probe did not bring the card up: {probe}")
    from photon_tpu_torch.device import resolve_device
    from photon_tpu_torch.ops import cuda_sparse as cs

    dev, cpu = resolve_device(), torch.device("cpu")
    card = card_line()
    build = cs.build_library()
    from photon_tpu_torch import native

    if native.get_lib() is None:
        raise AssertionError("the native Avro decoder did not build")
    os.makedirs(WORK, exist_ok=True)
    emit({"phase": "card", "nvidia_smi": card,
          "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "kind": torch.cuda.get_device_name(0), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build["seconds"],
          "built": build["built"], "library": os.path.relpath(build["path"], REPO),
          "native_decoder_build_s": native.BUILD_SECONDS,
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

    fit_a: dict = {}
    gt = phase_game_training(torch, cs, GAME, GAME_F64_USERS, dev, cpu, keep=fit_a)
    gt_fits = gt.pop("launches")
    gt_launches = {k: sum(f[k] for f in gt_fits.values()) for k in cs.ALL_KERNELS}
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

    ck = phase_checkpoint(torch, cs, fit_a, WORK)
    ck_launches = ck.pop("launches")
    emit({"phase": "checkpoint", "launches": ck_launches, **ck})
    rt = phase_routing(torch, cs, fit_a, WORK)
    rt_launches = rt.pop("launches")
    emit({"phase": "routing", "launches": rt_launches, **rt})

    sc = phase_sweep_cache(torch, cs, GAME, dev)
    sc_launches = sc.pop("launches")
    emit({"phase": "sweep_cache", "launches": sc_launches, **sc})

    lanes: dict = {}
    vm = phase_game_training_vmapped(torch, cs, GAME, GAME_F64_USERS, dev, cpu,
                                     keep=lanes)
    vm_fits = vm.pop("launches")
    vm_launches = {k: sum(f[k] for f in vm_fits.values()) for k in cs.ALL_KERNELS}
    emit({"phase": "game_training_vmapped", "launches": vm_launches,
          "launches_by_fit": vm_fits, **vm})

    bk = phase_bf16_kernels(torch, cs, dev, lanes.pop("fit_c_lanes"))
    emit({"phase": "bf16_kernels", **bk})

    ig = phase_ingest(torch, cs, dict(FULL, rows_per_user=INGEST_ROWS_PER_USER),
                      dev, WORK, inputs)
    ig_launches = ig.pop("launches")
    emit({"phase": "ingest", "launches": ig_launches, "matvec_kernel": chosen, **ig})
    # the fixed effect's gradients in every resumed, cached or ingested fit;
    # the ingest phase's drivers score through a matvec kernel
    for name, launched in (("checkpoint", ck_launches), ("sweep_cache", sc_launches),
                           ("ingest", ig_launches)):
        if launched["csc_rmatvec"] < 1:
            raise AssertionError(f"phase {name} never launched csc_rmatvec")
    if ig_launches["ell_matvec"] + ig_launches["ell_panel_matvec"] < 1:
        raise AssertionError("phase ingest never launched a matvec kernel")

    gl = phase_glm_driver(torch, cs, dev, WORK, ig["data"]["dir"])
    gl_launches = gl.pop("launches")
    emit({"phase": "glm_driver", "launches": gl_launches, **gl})
    bf = phase_bf16_feed(torch, cs, FULL, dev, WORK, gd)
    bf_launches = bf.pop("launches")
    emit({"phase": "bf16_feed", "launches": bf_launches, "matvec_kernel": chosen, **bf})
    # every kernel in both value types on the GLM driver's path; the bf16
    # feed's fixed effect through the bf16 kernels
    missing = [k for k in ("ell_panel_matvec", "ell_matvec", "csc_rmatvec",
                           *cs.BF16_KERNELS) if gl_launches[k] < 1]
    missing += [f"bf16_feed:{k}" for k in (f"{chosen}_bf16", "csc_rmatvec_bf16")
                if bf_launches[k] < 1]
    if missing:
        raise AssertionError(f"kernels never launched on their path: {missing}")

    fc = phase_factored(torch, cs, GAME, FACTORED_F64_USERS, dev, cpu, WORK)
    fc_launches = fc.pop("launches")
    emit({"phase": "factored", "launches": fc_launches, **fc})
    tu = phase_tuning(torch, cs, TUNER, dev, WORK)
    tu_launches = tu.pop("launches")
    emit({"phase": "tuning", "launches": tu_launches, "matvec_kernel": chosen, **tu})
    # the projection step's passes (asserted per step in the phase), and the
    # tuning trials' fixed effects and factored driver runs
    missing = [f"{ph}:{k}" for ph, c in (("factored", fc_launches),
                                         ("tuning", tu_launches))
               for k in ("csc_rmatvec",) if c[k] < 1]
    missing += [f"{ph}:matvec" for ph, c in (("factored", fc_launches),
                                             ("tuning", tu_launches))
                if c["ell_matvec"] + c["ell_panel_matvec"] < 1]
    if missing:
        raise AssertionError(f"kernels never launched on their path: {missing}")

    rg = phase_runtime_guards(torch, cs, fit_a, WORK, ig["data"]["dir"], probe, dev)
    del fit_a
    rg_launches = rg.pop("launches")
    emit({"phase": "runtime_guards", "launches": rg_launches, **rg})
    # the supervised GAME driver's and the out-of-core solves' passes
    if rg_launches["csc_rmatvec"] < 1 or rg_launches["ell_matvec"] + rg_launches[
            "ell_panel_matvec"] < 1:
        raise AssertionError("phase runtime_guards never launched a matvec kernel "
                             "and csc_rmatvec")

    sources = "photon_tpu_torch/csrc/ell_sparse.cu"
    by_phase = {"transformer": tr_launches, "driver": dr_launches,
                "training": tn_launches, "training_driver": td_launches,
                "game_training": gt_launches, "game_training_driver": gd_launches,
                "checkpoint": ck_launches, "routing": rt_launches,
                "sweep_cache": sc_launches,
                "game_training_vmapped": vm_launches, "ingest": ig_launches,
                "glm_driver": gl_launches, "bf16_feed": bf_launches,
                "factored": fc_launches, "tuning": tu_launches,
                "runtime_guards": rg_launches}
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
            "launches_counted": "f32 and f64 entry points (bf16: the _bf16 rows)",
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
    for name in cs.KERNELS:
        bname, g = f"{name}_bf16", bk["game"][name]
        row = {
            "name": bname, "route": "cuda", "source": sources, "replaces": REPLACES,
            "via": TPU_ENTRY[name] + " on with_value_dtype(bfloat16) values",
            "status": "ported (bf16 values upcast on load, bit-equal to the f32 "
                      "kernel on the upcast values)",
            "launches": sum(c[bname] for c in by_phase.values()),
            "launches_by_phase": {k: c[bname] for k, c in by_phase.items()},
            "max_abs_err": g["max_abs_err"], "ms": g["ms"], "plain_ms": g["plain_ms"],
            "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
            "library_ms": g["library_ms"], "library_call": bk["game"]["library_call"],
            "f32_kernel_ms": g["f32_kernel_ms"], "over_f32": g["over_f32"],
            "library_ratio": g["library_ratio"]}
        for shape in ("lanes", "drivers"):
            if name in bk[shape]:
                row[f"{shape}_shape"] = {k: bk[shape][name][k] for k in (
                    "ms", "f32_kernel_ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by", "max_abs_err")} | {"rows": bk[shape]["rows"],
                                                   "k": bk[shape]["k"]}
        rows.append(row)
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
