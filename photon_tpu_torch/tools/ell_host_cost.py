"""What one ``ell_matvec`` call costs the host, and whether the row-tile
kernel's time depends on K, on one card.

    python -m photon_tpu_torch.tools.ell_host_cost     # repository root, one GPU

At the drivers' 32,768 x 33 rows of ``chip_smoke.py`` (a launch-bound
shape): host microseconds a call (host clock over 2,000 back-to-back calls,
no synchronize inside) of the wrapper, of the bare ``ctypes`` entry point,
of ``torch.empty`` for z, of a ``torch.cuda.device`` guard, of a
``torch.cuda.current_stream`` Stream object and of the wrapper's checks;
then the wrapper's and the entry point's device time (``chip_smoke.time_ms``)
beside one cuSPARSE call's; all of it again after one ``torch.profiler``
session in the process. Then the kernel against cuSPARSE on 2^24
uniform random entries over 327,680 columns at K = 31, 32, 33, 64 and 17
(rows = 2^24 / K): at K = 32 every row of a stage starts on shared-memory
bank 0. Prints JSON lines and the ``nvidia-smi`` line.
"""
from __future__ import annotations

import json
import sys
import time


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as smk
    from photon_tpu_torch.ops import cuda_sparse as cs

    if not torch.cuda.is_available():
        print("ell_host_cost: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    d_idx, d_val, d_dim, _, _ = smk.game_arrays(**dict(
        smk.FULL, rows_per_user=smk.FULL["driver_rows_per_user"]), col0=1)
    n = d_idx.shape[0]
    idx = torch.from_numpy(np.concatenate([np.zeros((n, 1), np.int32), d_idx], 1)).to(dev)
    val = torch.from_numpy(np.concatenate([np.ones((n, 1), np.float32), d_val], 1)).to(dev)
    w = torch.randn(d_dim, device=dev)
    z = torch.empty(n, device=dev)
    fn = cs._lib().ell_matvec_f32
    plan = cs.ell_tile_plan(idx.shape[1], torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def host_us(f, reps=2000):
        for _ in range(50):
            f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            f()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / reps * 1e6

    def raw():
        return fn(idx.data_ptr(), val.data_ptr(), w.data_ptr(), z.data_ptr(), n,
                  idx.shape[1], d_dim, plan.tile_rows, plan.group, plan.stage, stream)

    def checks():
        cs._check_ell(idx, val, d_dim)
        cs._check_same_device(("idx", idx), ("val", val), ("w", w))
        cs._check_contiguous(("idx", idx), ("val", val), ("w", w))

    keep = (idx >= 0) & (idx < d_dim)
    crow = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    crow[1:] = torch.cumsum(keep.sum(1), 0)
    a = torch.sparse_csr_tensor(crow, idx[keep], val[keep], size=(n, d_dim))

    def costs():
        return {
            "wrapper_host_us": host_us(lambda: cs.ell_matvec(idx, val, w, d_dim)),
            "raw_ctypes_host_us": host_us(raw),
            "empty_us": host_us(lambda: torch.empty(n, dtype=torch.float32, device=dev)),
            "current_device_us": host_us(torch.cuda.current_device),
            "device_ctx_us": host_us(lambda: torch.cuda.device(dev).__enter__()),
            "current_stream_us": host_us(lambda: torch.cuda.current_stream(dev).cuda_stream),
            "checks_us": host_us(checks),
            "wrapper_ms": smk.time_ms(torch, lambda: cs.ell_matvec(idx, val, w, d_dim)),
            "raw_ms": smk.time_ms(torch, raw),
            "cusparse_host_us": host_us(lambda: a @ w),
            "cusparse_ms": smk.time_ms(torch, lambda: a @ w)}

    print(json.dumps(costs()), flush=True)
    # the same after one torch.profiler session over a call, as chip_smoke.py
    # runs them before it times the drivers' rows
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        cs.ell_matvec(idx, val, w, d_dim)
        torch.cuda.synchronize()
    print(json.dumps({"after_profiler": costs()}), flush=True)

    rng = np.random.default_rng(0)
    for k in (31, 32, 33, 64, 17):
        rows = (1 << 24) // k
        gi = torch.from_numpy(rng.integers(0, 327680, size=(rows, k)).astype(np.int32)).to(dev)
        gv = torch.randn(rows, k, device=dev)
        gw = torch.randn(327680, device=dev)
        crow = torch.arange(rows + 1, device=dev, dtype=torch.int32) * k
        a = torch.sparse_csr_tensor(crow, gi.reshape(-1), gv.reshape(-1), size=(rows, 327680))
        pairs = [(smk.time_ms(torch, lambda: cs.ell_matvec(gi, gv, gw, 327680)),
                  smk.time_ms(torch, lambda: a @ gw)) for _ in range(2)]
        print(json.dumps({"k": k, "rows": rows, "kernel_vs_cusparse_ms": pairs}), flush=True)
    print(smk.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
