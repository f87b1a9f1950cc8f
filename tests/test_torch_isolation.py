"""The PyTorch port stands alone and never falls back to the CPU.

* A fresh interpreter imports every module of ``photon_tpu_torch`` and runs
  the CPU-importable parts of ``chip_smoke.py`` (its data, model, bound and
  phase functions, the training phases included, at a tiny size, with the
  CPU as both devices); afterwards neither ``jax`` nor any ``photon_tpu``
  module is loaded.
* No source line of the port or of ``chip_smoke.py`` imports them.
* Without a GPU, ``resolve_device()`` and the port's scoring driver run
  without ``--device cpu`` raise instead of running on the CPU (the GPU is
  hidden here by patching ``torch.cuda.is_available``, so this holds on any
  machine), and a tensor on another device type is refused.
"""
import os
import re
import subprocess
import sys

import pytest
import torch

import photon_tpu_torch
from photon_tpu_torch.cli import game_scoring_driver
from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.ops import cuda_sparse as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|photon_tpu)(\.|\s|$)")

_CHILD = r"""
import importlib, os, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import photon_tpu_torch
names = [m.name for m in pkgutil.walk_packages(photon_tpu_torch.__path__, "photon_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke, torch
cpu = torch.device("cpu")
tiny = dict(n_users=32, rows_per_user=6, d_global=48, d_user=4, k_global=5,
            k_user=2, driver_rows_per_user=2)
b = chip_smoke.kernel_bound("ell_matvec", 1 << 19, 32, 327680, 1 << 24, "float32")
assert b["bound_by"] == "bytes" and 0.03 < b["bound_ms"] < 0.05, b
tr = chip_smoke.phase_transformer(torch, tiny, cpu, cpu)
assert tr["rows"] == 32 * 6 and tr["max_abs_err_vs_ref"] == 0.0, tr
parts = chip_smoke.transform_breakdown(torch, tiny, cpu)
assert set(parts) == {"fixed_attach", "fixed_matvec", "re_dataset_build",
                     "re_project_and_score"}, parts
root = os.path.join(os.getcwd(), "smoke")
inputs = chip_smoke.write_driver_inputs(torch, tiny, root)
dr = chip_smoke.phase_driver(torch, tiny, cpu, cpu, root, inputs)
assert dr["rows"] == 64 and dr["score_std"] > 0, dr
assert set(dr["runs"]["cpu"]) >= {"read_data_s", "score_s"}, dr
from photon_tpu_torch.ops import cuda_sparse as cs
tn = chip_smoke.phase_training(
    torch, cs, dict(n_rows=512, dim=128, k=6, iterations=6, f64_iterations=3),
    dict(n_rows=256, dim=64, k=4, iterations=4), cpu, cpu)
lb = tn["logistic_lbfgs_f32"]
assert lb["bit_equal_repeat"] and lb["run"]["iterations"] == 6, tn
assert lb["pass_counter"] == {"matvec": 9, "rmatvec": 7, "sq_rmatvec": 1}, tn
assert set(tn) >= {"tron_poisson_l2", "owlqn_linear_l1", "logistic_lbfgs_f64"}, tn
td = chip_smoke.phase_training_driver(torch, cs, cpu, cpu, root, inputs)
assert td["saved_rel_err_vs_ref"] == {"means": 0.0, "variances": 0.0}, td
assert td["scoring"]["score_std"] > 0 and "fit_s" in td["runs"]["cpu"], td
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "photon_tpu"))
print("MODULES", len(names), "BAD", bad)
"""


def test_port_and_chip_smoke_run_without_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, REPO], capture_output=True, text=True,
        timeout=300, cwd=tmp_path, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith("MODULES") and last.endswith("BAD []"), last
    assert int(last.split()[1]) >= 20


def _sources():
    """The package's own .py files (not its gitignored ``_build`` output)
    and chip_smoke.py."""
    root = os.path.dirname(photon_tpu_torch.__file__)
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "_build"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_source_line_imports_jax_or_the_jax_package():
    hits = []
    for path in _sources():
        with open(path) as f:
            for no, line in enumerate(f, 1):
                if FORBIDDEN.search(line):
                    hits.append(f"{os.path.relpath(path, REPO)}:{no}: {line.strip()}")
    assert not hits, hits


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_scoring_driver_defaults_to_cuda_and_raises_without_gpu(no_gpu, tmp_path):
    args = ["--data", str(tmp_path / "x.avro"), "--model-dir", str(tmp_path / "m"),
            "--output-dir", str(tmp_path / "out")]
    assert game_scoring_driver.build_arg_parser().parse_args(args).device == "cuda"
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            game_scoring_driver.run(args + extra)
    assert not (tmp_path / "out").exists()


def test_wrappers_refuse_other_device_types():
    """Only CPU tensors take the plain versions; anything else that is not
    CUDA is refused rather than computed some other way."""
    idx = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    val = torch.zeros((2, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cs.ell_matvec(idx, val, torch.zeros(4, device="meta"), 4)
    cpu_idx = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="expected cpu"):
        cs.ell_matvec(cpu_idx, torch.zeros((2, 3)), torch.zeros(4, device="meta"), 4)
