"""Where the panel matvec's time goes: the kernel against copies of itself
with one piece changed or taken out, on one card, in one process.

    python -m photon_tpu_torch.tools.panel_ablation     # repository root, one GPU

Each variant is ``csrc/ell_sparse.cu`` with a text edit, built by ``nvcc``
into ``_build/ablation/`` (all builds at once) and launched through its own
``ell_panel_matvec_f32`` on the GAME layout of ``chip_smoke.py`` (2^19 rows
x 32 entries, 327,680 columns) and its hot+dup variant. Times are CUDA-event
timings of back-to-back calls (``chip_smoke.time_ms``), taken in three
rounds in alternating order, beside the port's own wrapper
(``ell_panel_matvec``, whose host work per call the back-to-back timing
hides only while it is shorter than the kernel). Variants that drop work
give wrong sums: their errors against the plain version are printed, and
only their times mean anything. Prints one JSON line per variant and the
``nvidia-smi`` line.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

_SCAN = "const Acc s = block_segmented_scan(walk.run, key, s_wsum, s_wkey, s_scan);"
_RELOAD = ("        if (p3 < n_panels) load_panel(s_w + (j & 1) * kCols, w, dim, p3, "
           "&s_full[j & 1]);\n")
_WAIT = "        mbar_wait(&s_full[j & 1], (j >> 1) & 1);\n"
_EXIT = "    if (!__any_sync(0xffffffffu, same)) break;\n"

# name -> [(old, new), ...] applied to the source
VARIANTS = {
    "as_built": [],
    "items_4": [("kPanelItems = 8;", "kPanelItems = 4;")],
    "l2_prefetch_0": [("kPanelPrefetch = 1;", "kPanelPrefetch = 0;")],
    "l2_prefetch_2": [("kPanelPrefetch = 1;", "kPanelPrefetch = 2;")],
    "scan_without_early_exit": [(_EXIT, "")],
    # timing only (wrong sums):
    "no_w_reloads": [(_RELOAD, ""), (_WAIT, "        if (j < 2) " + _WAIT.lstrip())],
    "no_block_scan": [(_SCAN, "const Acc s = walk.run; __syncthreads();")],
    "neither": [(_RELOAD, ""), (_WAIT, "        if (j < 2) " + _WAIT.lstrip()),
                (_SCAN, "const Acc s = walk.run; __syncthreads();")],
}


def _build(cs, variants: dict) -> dict:
    src = open(cs.SOURCE).read()
    out_dir = os.path.join(cs.BUILD_DIR, "ablation")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in {cs.SOURCE}")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [cs._nvcc(), *cs.NVCC_FLAGS, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        fn = ctypes.CDLL(lib).ell_panel_matvec_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as smk
    from photon_tpu_torch.ops import cuda_sparse as cs

    if not torch.cuda.is_available():
        print("panel_ablation: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    fns = _build(cs, VARIANTS)
    idx_np, val_np, dim, _, _ = smk.game_arrays(**smk.FULL)
    hot_np = idx_np.copy()
    hot_np[:, 0] = 7
    hot_np[:, 1] = hot_np[:, 2]
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.normal(size=dim)).to(dev, torch.float32)
    val = torch.from_numpy(val_np).to(dev, torch.float32)
    for case, inp in (("game", idx_np), ("hot_dup", hot_np)):
        idx = torch.from_numpy(inp).to(dev)
        lay = cs.build_panels(idx, val, dim)
        ref = cs.ell_matvec_plain(idx, val, w, dim)
        z = torch.empty_like(ref)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def call(fn):
            code = fn(lay.codes.data_ptr(), lay.vals.data_ptr(), lay.offsets.data_ptr(),
                      w.data_ptr(), z.data_ptr(), lay.n_rows, lay.dim, lay.tile_rows,
                      lay.n_tiles, lay.n_panels, lay.panel_cols, stream)
            if code:
                raise RuntimeError(f"launch failed: CUDA error {code}")

        times = {name: [] for name in fns}
        times["wrapper"] = []
        for rnd in range(3):
            names = list(fns) if rnd % 2 == 0 else list(reversed(list(fns)))
            for name in names:
                times[name].append(smk.time_ms(torch, lambda: call(fns[name])))
            times["wrapper"].append(smk.time_ms(torch, lambda: cs.ell_panel_matvec(lay, w)))
        print(json.dumps({"case": case, "variant": "wrapper", "ms": times["wrapper"]}))
        for name, fn in fns.items():
            call(fn)
            torch.cuda.synchronize()
            err = (z.double() - ref.double()).abs().max().item()
            print(json.dumps({"case": case, "variant": name, "ms": times[name],
                              "max_abs_err": err}), flush=True)
    print(smk.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
