"""The PyTorch port stands alone and never falls back to the CPU.

* A fresh interpreter imports every module of ``photon_tpu_torch`` (the
  native decoder's loader included) and runs the CPU-importable parts of
  ``chip_smoke.py`` (its data, model, bound and phase functions, the
  training, GAME training, checkpoint, routing, sweep-cache, vmapped GAME
  training, ingest, GLM driver, bf16-feed, factored and tuning phases
  included, the runtime-guards phase with an injected OOM in place of
  the card's capped one, the observability phase, the serving phase, the online phase and
  the mesh phase (its gloo processes on the CPU; no NCCL rank), at
  a tiny size, with the CPU as both devices);
  afterwards neither ``jax`` nor any
  ``photon_tpu`` (nor ``ml_dtypes``) module is loaded.
* No source line of the port, of ``chip_smoke.py`` or of
  ``scripts/multihost_smoke_torch.py`` imports them.
* Without a GPU, ``resolve_device()`` and the port's scoring, serving and
  online training drivers run without ``--device cpu`` raise instead of
  running on the CPU (the GPU is
  hidden here by patching ``torch.cuda.is_available``, so this holds on any
  machine), and a tensor on another device type is refused. The fleet
  view's ``obs_driver`` needs no device and touches none.
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
FORBIDDEN = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|photon_tpu|ml_dtypes)(\.|\s|$)")

_CHILD = r"""
import importlib, json, os, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import photon_tpu_torch
names = [m.name for m in pkgutil.walk_packages(photon_tpu_torch.__path__, "photon_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke, torch
cpu = torch.device("cpu")
tiny = dict(n_users=32, rows_per_user=6, d_global=48, d_user=4, k_global=5,
            k_user=2, driver_rows_per_user=2)
every = torch.arange(327680).view(-1, 32)   # a layout touching every column
b = chip_smoke.kernel_bound("ell_matvec", 1 << 19, 32, 327680, 1 << 24, "float32", every)
assert b["bound_by"] == "bytes" and 0.03 < b["bound_ms"] < 0.05, b
# a gather counts the sectors of w that its non-ghost columns touch: two
# columns in one sector and one in another, the ghost column none
few = torch.tensor([[0, 7, 327680], [9, 327680, 327680]], dtype=torch.int32)
g = chip_smoke.kernel_bound("ell_matvec", 2, 3, 327680, 3, "float32", few)
assert g["bytes"] == 2 * 3 * 8 + 2 * 32 + 2 * 4, g
t = chip_smoke.kernel_bound("csc_rmatvec", 2, 3, 327680, 3, "float32", few)
assert t["bytes"] == 327681 * 8 + 3 * 8 + 32 + 327680 * 4, t
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
gd = chip_smoke.phase_game_training_driver(torch, cs, tiny, cpu, cpu, root, inputs)
assert gd["saved_rel_err_vs_ref"] == {"fixed_means": 0.0, "random_means": 0.0}, gd
assert gd["random_effect_coefficients"] > 0 and gd["validation_rows"] == 32, gd
assert set(gd["scoring"]["evaluation"]) == {"AUC"}, gd
keep = {}
gt = chip_smoke.phase_game_training(
    torch, cs, dict(n_users=40, rows_per_user=6, d_global=48, d_user=4,
                    iterations=4), 12, cpu, cpu, f64_users_full_dual=10, keep=keep)
assert not gt["tf32_matmul"] and set(gt["launches"]) == {"fit_a", "fit_b"}, gt
assert gt["fit_a"]["bit_equal_repeat"] == "in phase checkpoint", gt["fit_a"]
for fit in ("fit_a", "fit_b"):
    assert gt[fit]["bit_equal_repeat"] and gt[fit]["plans"], gt[fit]
    assert len(gt[fit]["ref_steps"]) == 2 * gt[fit]["ref_configs"] == 2, gt[fit]
    assert len(gt[fit]["steps"]) == 4 * len(gt[fit]["re_weights"]), gt[fit]
    assert gt[fit]["vs_ref"]["metric_abs_err"] == 0.0, gt[fit]
    assert gt[fit]["vs_ref"]["lane_objective_rel_err"] == 0.0, gt[fit]
    assert gt[fit]["vs_ref"]["coef_rel_err"]["0/fixed/user_block"] == 0.0, gt[fit]
    assert gt[fit + "_f64"]["coef_rel_err_vs_ref"] == 0.0, gt
assert gt["fit_a_f64_full_dual"]["coef_rel_err_vs_ref"] == 0.0, gt
ck = chip_smoke.phase_checkpoint(torch, cs, keep, root)
assert ck["bit_identical"] and ck["jax_snapshot_refused"], ck
assert ck["resumed_from"] == {"sweep": 0, "coord_index": 1, "config_index": 0}, ck
rt = chip_smoke.phase_routing(torch, cs, keep, root)
assert rt["repeat_bit_equal"] and rt["calibrated_buckets"] > 0, rt
assert all(rt["static_plan_buckets_bit_equal"]), rt
assert rt["chunked_lanes"]["coef_rel_err_vs_whole_bucket"] <= 1e-3, rt
assert all(c["costs"] and c["winner"] for c in rt["classes"].values()), rt
sc = chip_smoke.phase_sweep_cache(
    torch, cs, dict(n_users=40, rows_per_user=6, d_global=48, d_user=4,
                    iterations=4), cpu)
on, off = sc["runs"]["cache_2048mb"], sc["runs"]["cache_off"]
assert sc["bit_identical"] and on["h2d_bytes_per_sweep"][1] == 0, sc
assert off["h2d_bytes_per_sweep"][1] > 0 and on["hits"] > 0, sc
ig = chip_smoke.phase_ingest(torch, cs, dict(tiny, rows_per_user=6), cpu, root,
                             inputs)
assert ig["full"]["rows"] == 32 * 6 and ig["small"]["rows"] == 64, ig
assert ig["scoring"]["bit_equal_share"] == 1.0, ig
assert ig["training_driver"]["read_seconds"] > 0, ig
vm = chip_smoke.phase_game_training_vmapped(
    torch, cs, dict(n_users=40, rows_per_user=6, d_global=48, d_user=4,
                    iterations=4), 12, cpu, cpu)
assert set(vm["launches"]) == {"fit_c", "fit_d", "fit_e"}, vm
for fit in ("fit_c", "fit_d", "fit_e"):
    assert vm[fit]["bit_equal_repeat"] and vm[fit]["plans"], vm[fit]
    assert set(vm[fit]["plans"]) == {("vmapped_lbfgs", None)}, vm[fit]
    assert vm[fit]["small"]["f64"]["coef_rel_err_vs_ref"] == 0.0, vm[fit]
gl = chip_smoke.phase_glm_driver(torch, cs, cpu, root, ig["data"]["dir"],
                                chunk_rows=48)
runs = gl["runs"]
assert runs["out_of_core"]["n_chunks"] == 4 and runs["in_core"]["iterations"] > 0, gl
assert runs["out_of_core_bf16"]["value_dtype"] == "bfloat16", gl
assert runs["out_of_core"]["passes_an_iteration"] == 2.0, gl
w = gl["witness"]
assert w["bf16_vs_f32_on_rounded"]["bit_identical"] and w["resume"]["bit_identical"], w
assert w["f64_vs_in_core"]["coef_rel_err"] <= 1e-9, w
assert gl["feature_indexing"]["features"] > 0, gl
bf = chip_smoke.phase_bf16_feed(torch, cs, tiny, cpu, root, gd)
assert bf["reader"] == "native" and bf["metric_abs_err_vs_f32"] <= 1e-2, bf
assert bf["bit_equal_f32_on_rounded"], bf
fc = chip_smoke.phase_factored(
    torch, cs, dict(n_users=40, rows_per_user=6, d_global=48, d_user=4,
                    iterations=4), 12, cpu, cpu, root)
assert fc["point"]["bit_equal_repeat"] and fc["point"]["grad_rel_err_vs_ref"] == 0.0, fc
assert fc["f64"]["coef_rel_err_vs_ref"] == 0.0 and fc["projection_shape"] == [208, 8], fc
assert len(fc["latent_steps"]) == 3 and len(fc["projection_steps"]) == 2, fc
assert fc["save_and_score"]["scores_max_abs_err_vs_model"] <= 1e-9, fc
tu = chip_smoke.phase_tuning(
    torch, cs, dict(n_users=30, rows_per_user=6, valid_rows_per_user=3,
                    d_global=40, d_user=3, n_items=7, iterations=4, trials=3),
    cpu, root)
assert tu["resumed_bit_identical"] and len(tu["trial_s"]) == 3, tu
assert tu["driver"]["factored_latent_dim"] == 4, tu
rg = chip_smoke.phase_runtime_guards(torch, cs, keep, root, ig["data"]["dir"],
                                     {"backend": "cpu"}, cpu, chunk_rows=48)
oom = rg["injected_oom"]
assert oom["downshifts"] == 1 and oom["bit_equal_next_tier"], oom
assert rg["measured_demotion"]["bit_equal_next_tier"], rg
assert rg["supervised_driver"]["restart_causes"] == ["preemption"], rg
assert not rg["supervised_driver"]["model_files_differ"], rg
assert all(rg["out_of_core"]["checks"].values()), rg
assert rg["out_of_core"]["half_chunks"] == 2 * gl["runs"]["out_of_core"]["n_chunks"], rg
ob = chip_smoke.phase_observability(torch, cs, cpu, root, ig["data"]["dir"], gd,
                                    chunk_rows=48)
game = ob["game_driver"]
assert not game["model_files_differ"] and game["trace"]["dropped"] == 0, game
assert len(game["step_span_vs_record"]) == 8 and game["critical_path_top5"], game
assert game["profile"]["missing"] == {} and game["profile"]["fit_busy_share"] == 0.0, game
assert ob["scoring"]["scores_byte_equal"] and not ob["glm_out_of_core"]["model_files_differ"], ob
assert ob["glm_out_of_core"]["chunk_spans"]["optim.ooc_grad_chunk"] > 0, ob
assert ob["report"]["rc"] == 0 and ob["report"]["names_shard"], ob
sv = chip_smoke.phase_serving(torch, cs, cpu, cpu, root,
                             knobs=dict(max_batch=8, clients=4, swap_passes=20))
assert sv["parity"]["rows"] == 32 and sv["threaded"]["failed"] == 0, sv
assert sv["frontline"]["scores_byte_equal_threaded"], sv
assert sv["hot_swap"]["version"] == 2 and sv["hot_swap"]["load"]["failed"] == 0, sv
assert sv["hot_swap"]["from_standby"], sv
plain = sv["hot_swap"]["plain"]
assert plain["version"] == 3 and plain["load"]["failed"] == 0, plain
assert set(plain["rows_by_version"]) == {"2", "3"}, plain
assert sv["faults"]["oom"]["max_batch_after"] == 4, sv
assert sv["threaded"]["cache"]["evictions"] > 0, sv
assert json.loads(json.dumps(sv))["knobs"]["swap_passes"] == 20  # emit()-able
on = chip_smoke.phase_online(torch, cs, tiny, cpu, cpu, root, knobs=dict(
    heavy_users=8, heavy_rows=90, repl_users=8, router_rows=16, clients=4,
    wave_users=4, fault_events=40, probe_user=30, ctl_timeout_s=60.0))
assert on["control"]["rollback_reason"] == "score_drift", on["control"]
assert on["control"]["promoted_main_seqs"] == [1], on["control"]
assert all(on["replication"]["exactly_once"].values()), on["replication"]
assert on["replication"]["router"]["failed"] == 0, on["replication"]
assert on["f64_witness"]["coef_rel_err"] <= 1e-9, on["f64_witness"]
assert on["faults"]["oom"]["refresh_batch_after"] == 4096, on["faults"]
assert json.loads(json.dumps(on))["tiers"] == {"main": ["newton_primal"],
                                                 "heavy": ["newton_primal"]}, on
# the mesh phase last: it leaves the earlier phases as they ran before it
ms = chip_smoke.phase_mesh(
    torch, cs, keep, cpu, root, ig["data"]["dir"],
    sizes=dict(n_users=40, rows_per_user=6, d_global=48, d_user=4, iterations=4),
    f64_users=12, full=tiny, chunk_rows=48)
assert ms["f64_witness"]["coef_rel_err_4_vs_1"] <= 1e-12, ms
assert ms["out_of_core"]["f64_witness"]["coef_rel_err_4_vs_1"] <= 1e-12, ms
assert ms["processes"]["ranks_bit_equal"] and ms["scoring"]["bit_equal"], ms
assert all(g["coef_rel_err_vs_4_shards"] <= 1e-12 for g in ms["processes"]["gloo"]), ms
assert {p[2] for p in ms["fit_a"]["plans"]["4"]} == {4}, ms["fit_a"]
assert json.loads(json.dumps(ms))["shards"] == 4       # emit()-able
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "photon_tpu", "ml_dtypes"))
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
    """The package's own .py files (not its gitignored ``_build`` output),
    chip_smoke.py and the port's elastic drill."""
    root = os.path.dirname(photon_tpu_torch.__file__)
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "_build"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "scripts", "multihost_smoke_torch.py")


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


def test_serving_driver_defaults_to_cuda_and_raises_without_gpu(no_gpu, tmp_path):
    from photon_tpu_torch.cli import serving_driver

    args = ["--model-dir", str(tmp_path / "m"), "--port", "0",
            "--output-dir", str(tmp_path / "out")]
    assert serving_driver.build_arg_parser().parse_args(args).device == "cuda"
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serving_driver.run(args + extra, serve_forever=False)
    from photon_tpu_torch.serving import ModelRegistry

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelRegistry(str(tmp_path / "m"))
    assert not torch.cuda.is_initialized()


def test_online_driver_defaults_to_cuda_and_raises_without_gpu(no_gpu, tmp_path):
    from photon_tpu_torch.cli import online_training_driver

    args = ["--model-dir", str(tmp_path / "m"), "--events", str(tmp_path / "e"),
            "--output-dir", str(tmp_path / "out")]
    assert online_training_driver.build_arg_parser().parse_args(args).device == "cuda"
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            online_training_driver.run(args + extra)
    assert not (tmp_path / "out").exists()
    assert not torch.cuda.is_initialized()


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


def test_obs_driver_needs_no_device(no_gpu, tmp_path):
    """The fleet view's driver runs without a GPU and brings no CUDA context
    up: it reads files and serves HTTP."""
    from photon_tpu_torch.cli import obs_driver

    out = obs_driver.run(["--telemetry-dir", str(tmp_path), "--port", "0"],
                         serve_forever=False)
    assert out["telemetry_dir"] == str(tmp_path) and out["n_live_anomalies"] == 0
    assert any(n.startswith("registry.obs.") for n in os.listdir(tmp_path))
    assert not torch.cuda.is_initialized()
