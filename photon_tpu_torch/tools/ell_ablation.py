"""Where the row-tile matvec's time goes: ``ell_matvec`` against copies of
itself with one choice changed, on one card, in one process.

    python -m photon_tpu_torch.tools.ell_ablation     # repository root, one GPU

Each variant is ``csrc/ell_sparse.cu`` with a text edit (built by ``nvcc``
into ``_build/ablation_ell/``, all builds at once) and a stage size,
launched through its own ``ell_matvec_f32`` with the plan ``ell_tile_plan``
gives for that stage and item count. Layouts: a block-diagonal lane layout
of fit C's shape in ``chip_smoke.py`` (100,000 lanes x 16 rows x 17
entries over 256 local columns each, 5% ghosts) and of fits D's and E's
(5 entries over 16), the drivers' 32,768 x 33 rows and the 2^19 x 32
scoring layout. Variant ``warp_per_row`` is the design the kernel
replaced, put back in place of the launch. Times are CUDA-event timings of
back-to-back calls (``chip_smoke.time_ms``), three rounds in alternating
order, beside the port's wrapper and one cuSPARSE call; every variant is
held to the plain version (f32 tolerance of ``chip_smoke.py``). Prints one
JSON line per layout and variant and the ``nvidia-smi`` line.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

_BOUNDS = "__launch_bounds__(kEllThreads)\nell_matvec_kernel"
_MIN3 = (_BOUNDS, "__launch_bounds__(kEllThreads, 3)\nell_matvec_kernel")
_ITEMS = "kEllItems = 12;"
_GATHER = "__ldg(w + c[i])"
_PASSES = "    for (int p = 0; p < passes; ++p) {"
_ATTR = "    if ((err = cudaFuncSetAttribute(ell_matvec_kernel<T>,"


def _carveout(percent: int) -> tuple:
    """Ask for a shared-memory carveout of ``percent`` of the SM's 228 KB
    (the rest is L1) before the dynamic shared memory is set."""
    return (_ATTR, "    cudaFuncSetAttribute(ell_matvec_kernel<T>, "
                   f"cudaFuncAttributePreferredSharedMemoryCarveout, {percent});\n" + _ATTR)


# The design this kernel replaced: one warp per row, lanes striding
# over K, a butterfly of the lanes' partials; the grid strides over rows.
_SMEM_NOTE = "// Shared memory of the row-tile matvec: two stages of `stage` entries."
_WARP_PER_ROW = """template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_per_row_kernel(const int32_t* __restrict__ idx, const T* __restrict__ val,
                    const T* __restrict__ w, T* __restrict__ z, int64_t n,
                    int64_t k, int64_t dim) {
  const int lane = threadIdx.x % kWarp;
  const int64_t first = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t r = first; r < n; r += stride) {
    const int32_t* ri = idx + r * k;
    const T* rv = val + r * k;
    Acc acc = Acc(0);
    for (int64_t j = lane; j < k; j += kWarp) {
      const int64_t c = ri[j];
      if (c >= 0 && c < dim) acc += (Acc)rv[j] * (Acc)w[c];
    }
    acc = warp_sum(acc);
    if (lane == 0) z[r] = (T)acc;
  }
}

"""
_ROW_TILE_LAUNCH = """  ell_matvec_kernel<T><<<(unsigned)blocks, kEllThreads, (size_t)smem,
                         (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const T*)val, (const T*)w, (T*)z, n, k, dim,
      (int)tile_rows, (int)group, (int)stage);"""
_WARP_PER_ROW_LAUNCH = """  (void)blocks;
  warp_per_row_kernel<T><<<(unsigned)blocks_for(n), kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const T*)val, (const T*)w, (T*)z, n, k, dim);"""
# name -> ([(old, new), ...] applied to the source, stage entries, items)
VARIANTS = {
    "as_built": ([], 4096, 12),
    "warp_per_row": ([(_SMEM_NOTE, _WARP_PER_ROW + _SMEM_NOTE),
                          (_ROW_TILE_LAUNCH, _WARP_PER_ROW_LAUNCH)], 4096, 12),
    "stage_2048": ([], 2048, 12),
    "items_16": ([(_ITEMS, "kEllItems = 16;")], 4096, 16),
    "min_blocks_3": ([_MIN3], 4096, 12),
    "gather_l2_only": ([(_GATHER, "__ldcg(w + c[i])")], 4096, 12),
    "passes_unrolled_2": ([(_PASSES, "#pragma unroll 2\n" + _PASSES)], 4096, 12),
    # fewer resident stages, more L1 for the gathers of w
    "stage_2048_carveout_50": ([_carveout(50)], 2048, 12),
    "stage_1024_carveout_32": ([_carveout(32)], 1024, 12),
    "stage_4096_carveout_60": ([_carveout(60)], 4096, 12),
}


def _build(cs, variants: dict) -> dict:
    src = open(cs.SOURCE).read()
    out_dir = os.path.join(cs.BUILD_DIR, "ablation_ell")
    os.makedirs(out_dir, exist_ok=True)
    procs, libs = {}, {}
    for name, (edits, _, _) in variants.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in {cs.SOURCE}")
            text = text.replace(old, new)
        key = repr(edits)
        if key in libs:
            procs[name] = libs[key]
            continue
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{name}.so")
        libs[key] = procs[name] = (lib, subprocess.Popen(
            [cs._nvcc(), *cs.NVCC_FLAGS, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns, logs = {}, {}
    for name, (lib, proc) in procs.items():
        if proc not in logs:
            logs[proc] = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{logs[proc]}")
        fn = ctypes.CDLL(lib).ell_matvec_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def lane_layout(torch, dev, n_lanes=100_000, rows=16, k=17, p=256, seed=3,
                ghosts=0.05):
    """A bucket laid out as ``LaneFeatures.from_bucket`` lays it: lane e's
    row s is row e·rows + s, its local column c is column e·p + c."""
    import numpy as np

    from photon_tpu_torch.data.batch import LaneFeatures

    rng = np.random.default_rng(seed)
    local = rng.integers(0, p, size=(n_lanes, rows, k)).astype(np.int32)
    local = np.where(rng.random(local.shape) < ghosts, p, local).astype(np.int32)
    val = np.where(local < p, rng.normal(size=local.shape), 0.0).astype(np.float32)
    flat = LaneFeatures.from_bucket(torch.from_numpy(local).to(dev),
                                    torch.from_numpy(val).to(dev), p).flat
    return flat.idx, flat.val, flat.dim


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as smk
    from photon_tpu_torch.ops import cuda_sparse as cs

    if not torch.cuda.is_available():
        print("ell_ablation: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    fns = _build(cs, VARIANTS)
    layouts = {"lanes": lane_layout(torch, dev),
               "lanes_p16": lane_layout(torch, dev, k=5, p=16, ghosts=0.0)}
    d_idx, d_val, d_dim, _, _ = smk.game_arrays(**dict(
        smk.FULL, rows_per_user=smk.FULL["driver_rows_per_user"]), col0=1)
    n = d_idx.shape[0]
    layouts["driver_rows"] = (
        torch.from_numpy(np.concatenate([np.zeros((n, 1), np.int32), d_idx], 1)).to(dev),
        torch.from_numpy(np.concatenate([np.ones((n, 1), np.float32), d_val], 1)).to(dev),
        d_dim)
    g_idx, g_val, g_dim, _, _ = smk.game_arrays(**smk.FULL)
    layouts["scoring_2^19"] = (torch.from_numpy(g_idx).to(dev),
                               torch.from_numpy(g_val).to(dev), g_dim)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for case, (idx, val, dim) in layouts.items():
        rows, k = idx.shape
        w = torch.from_numpy(np.random.default_rng(4).normal(size=dim)).to(dev, torch.float32)
        ref = cs.ell_matvec_plain(idx, val, w, dim)
        z = torch.empty_like(ref)

        def call(name):
            _, stage, items = VARIANTS[name]
            plan = cs.ell_tile_plan(k, torch.float32, stage=stage, items=items)
            code = fns[name](idx.data_ptr(), val.data_ptr(), w.data_ptr(), z.data_ptr(),
                             rows, k, dim, plan.tile_rows, plan.group, plan.stage, stream)
            if code:
                raise RuntimeError(f"{name}: launch failed: CUDA error {code}")

        keep = (idx >= 0) & (idx < dim)
        crow = torch.zeros(rows + 1, dtype=torch.int32, device=dev)
        crow[1:] = torch.cumsum(keep.sum(1), 0)
        a = torch.sparse_csr_tensor(crow, idx[keep], val[keep], size=(rows, dim))
        times = {name: [] for name in [*fns, "wrapper", "cusparse"]}
        for rnd in range(3):
            names = list(fns) if rnd % 2 == 0 else list(reversed(list(fns)))
            for name in names:
                times[name].append(smk.time_ms(torch, lambda: call(name)))
            times["wrapper"].append(smk.time_ms(torch, lambda: cs.ell_matvec(idx, val, w, dim)))
            times["cusparse"].append(smk.time_ms(torch, lambda: a @ w))
        bound = smk.kernel_bound("ell_matvec", rows, k, dim, int(keep.sum()), "float32")
        print(json.dumps({"case": case, "rows": rows, "k": k, "dim": dim,
                          "bound_ms": bound["bound_ms"], "wrapper_ms": times["wrapper"],
                          "cusparse_ms": times["cusparse"]}), flush=True)
        for name in fns:
            call(name)
            torch.cuda.synchronize()
            err = smk._close(torch, z, ref, "float32")
            print(json.dumps({"case": case, "variant": name, "ms": times[name],
                              "max_abs_err": err}), flush=True)
    print(smk.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
