"""Elastic multi-host GAME training in the port
(``photon_tpu_torch/parallel/elastic.py``) on the CPU, with real worker
processes (``python -m photon_tpu_torch.parallel.elastic --device cpu``).

* The part files and manifest of ``make_synthetic_parts`` equal the JAX
  package's byte for byte, and each package's worker reads the other's.
* 1 and 2 port workers give bit-equal ``w`` and ``re_scores``: the
  reduction folds per-part partials in part order, so the assignment of
  parts to hosts cannot change what is summed.
* The port's 1-host run is within 1e-12 (f64) of the JAX package's
  ``python -m photon_tpu.parallel.elastic`` on the same manifest, and a
  worker that row-shards each part over a local mesh of 2 within 1e-12 of
  one that does not.
* The drill: 3 workers, host 2 SIGKILLed after ``commit-1`` and restarted
  (``scripts/multihost_smoke_torch.py``, through ``chip_smoke
  .phase_elastic`` in an interpreter without JAX): the shrink and the
  regrow journaled, no new shape after warmup, within 1e-12 of the
  uninterrupted run, and leg 1's first sweep equal to a one-host witness's.

Tiny sizes (4 parts x 12 rows, dim 5, 6 entities); every process has a
``timeout``.
"""
from __future__ import annotations

import filecmp
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from photon_tpu.parallel import elastic as jax_elastic
from photon_tpu_torch.parallel import elastic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_parts=4, rows_per_part=12, dim=5, n_entities=6)
WORKER = ["--sweeps", "1", "--max-iterations", "8", "--beat-seconds", "0.5",
          "--stale-factor", "20"]


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    return elastic.make_synthetic_parts(str(tmp_path_factory.mktemp("parts")), **TINY)


def _run(module: str, mesh_dir, manifest, hosts: int, extra=(), env=None):
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, "--mesh-dir", str(mesh_dir),
         "--host-id", str(h), "--hosts", str(hosts), "--manifest", manifest,
         *WORKER, *extra],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1", **(env or {})})
        for h in range(hosts)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-1500:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    with open(os.path.join(mesh_dir, "final.json")) as f:
        summary = json.load(f)
    # the port's shape sentinel, the JAX package's retrace sentinel
    key = ("new_shapes_after_warmup" if module.startswith("photon_tpu_torch")
           else "retraces_after_warmup")
    assert summary[key] == 0
    return np.load(os.path.join(mesh_dir, "final-model.npz"))


def _port(mesh_dir, manifest, hosts=1, extra=()):
    return _run("photon_tpu_torch.parallel.elastic", mesh_dir, manifest, hosts,
                ("--device", "cpu", *extra))


def test_parts_and_manifest_equal_jax(tmp_path, manifest):
    theirs = jax_elastic.make_synthetic_parts(str(tmp_path), **TINY)
    mine = os.path.dirname(manifest)
    names = sorted(os.listdir(mine))
    assert names == sorted(os.listdir(tmp_path))
    for n in names:
        if n.endswith(".npz"):
            a, b = np.load(os.path.join(mine, n)), np.load(tmp_path / n)
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
                assert a[k].dtype == b[k].dtype
        else:
            assert filecmp.cmp(os.path.join(mine, n), tmp_path / n, shallow=False)
    assert elastic.load_manifest(str(theirs)) == jax_elastic.load_manifest(theirs)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "other"}))
    with pytest.raises(ValueError, match="not an elastic manifest"):
        elastic.load_manifest(str(bad))


def test_host_lbfgs_equals_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(12, 6))
    h = a.T @ a + np.eye(6)
    b = rng.normal(size=6)

    def vg(w):
        return 0.5 * w @ h @ w - b @ w, h @ w - b

    got = elastic._host_lbfgs(vg, np.zeros(6), 30, 5, 1e-12)
    want = jax_elastic._host_lbfgs(vg, np.zeros(6), 30, 5, 1e-12)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    np.testing.assert_allclose(got[0], np.linalg.solve(h, b), rtol=0, atol=1e-6)


def test_one_and_two_workers_bit_equal_and_jax_within_1e12(tmp_path, manifest):
    one = _port(tmp_path / "one", manifest)
    two = _port(tmp_path / "two", manifest, hosts=2)
    np.testing.assert_array_equal(one["w"], two["w"])
    np.testing.assert_array_equal(one["re_scores"], two["re_scores"])
    np.testing.assert_array_equal(one["ents"], np.arange(TINY["n_entities"]))
    jx = _run("photon_tpu.parallel.elastic", tmp_path / "jax", manifest, 1,
              env={"JAX_PLATFORMS": "cpu"})
    for k in ("w", "re_scores"):
        np.testing.assert_allclose(one[k], jx[k], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(one["ents"], jx["ents"])
    assert float(np.std(one["re_scores"])) > 0.01 and float(np.abs(one["w"]).max()) > 0.1


def test_local_mesh_within_1e12(tmp_path, manifest):
    one = _port(tmp_path / "one", manifest)
    sharded = _port(tmp_path / "local2", manifest, extra=("--local-devices", "2"))
    for k in ("w", "re_scores"):
        np.testing.assert_allclose(sharded[k], one[k], rtol=0, atol=1e-12)


def test_merge_mesh_cost_tables(tmp_path):
    from photon_tpu_torch.game.solver_routing import SolverCostTable

    assert elastic.merge_mesh_cost_tables(str(tmp_path)) is None
    for h, entries in ((0, {"S32_P8@dev1": {"newton@256": 1.0, "lbfgs": 4.0}}),
                       (1, {"S32_P8@dev1": {"newton@256": 3.0}})):
        t = SolverCostTable()
        t.load_json({"version": 1, "entries": entries})
        t.save(str(tmp_path / f"solver_costs.host-{h}.json"))
    out = elastic.merge_mesh_cost_tables(str(tmp_path))
    assert out == str(tmp_path / "solver_costs.merged.json")
    entries = json.load(open(out))["entries"]
    assert entries["S32_P8@dev1"] == {"newton@256": 2.0, "lbfgs": 4.0}


_DRILL = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
import torch, chip_smoke
from photon_tpu_torch.ops import cuda_sparse as cs
out = chip_smoke.phase_elastic(torch, cs, torch.device("cpu"), os.getcwd(),
                               sizes=json.loads(sys.argv[2]))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "photon_tpu", "ml_dtypes"))
print(json.dumps({"out": out, "bad": bad}))
"""


def test_sigkill_and_rejoin_drill(tmp_path):
    sizes = dict(TINY, sweeps=4, max_iterations=12)
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    proc = subprocess.run([sys.executable, "-c", _DRILL, REPO, json.dumps(sizes)],
                          capture_output=True, text=True, timeout=300,
                          cwd=tmp_path, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    out = got["out"]
    assert out["max_abs_diff"] == {"w": 0.0, "re_scores": 0.0}
    assert out["kill_to_shrink_s"] > 0 and out["rejoin_to_grow_s"] > 0
    assert len(out["leg2_step_seconds"]["2"]) >= 1      # the restarted host trained
    assert len(out["leg2_step_seconds"]["0"]) == 2 * sizes["sweeps"]
    assert set(out["launches"]) >= {"ell_matvec", "csc_rmatvec"}
    # the one-host CPU witness of the first sweep against leg 1's commit-1:
    # the same device here, so the same bits (on the card, within the bar)
    assert out["witness"]["device"] == "cpu"
    assert out["witness"]["rel_err"] == {"w": 0.0, "re_scores": 0.0}


def test_chip_smoke_kernel_bound_catches_one_wrong_entry(monkeypatch):
    """``chip_smoke.check_bounded``, the elastic phase's kernel check on a
    part's layout (columns as long as the part): the plain versions pass
    (exactly, on the CPU), and a transpose off by one entry's worth in one
    column fails in f32 and f64, though the bound allows for reordered
    sums of 4,096 terms."""
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke
    from photon_tpu_torch.ops import cuda_sparse as cs

    rng = np.random.default_rng(5)
    n, dim = 4096, 8
    idx = np.tile(np.arange(dim, dtype=np.int32), (n, 1))
    val = rng.normal(size=(n, dim))
    cpu = torch.device("cpu")
    out = chip_smoke.check_bounded(torch, cs, cpu, idx, val, dim, seed=16)
    assert (out["col_terms"], out["row_terms"]) == (n, dim)
    for dtype in ("float32", "float64"):
        assert all(r["max_abs_err"] == 0.0 for r in out[dtype].values())
    plain = cs.csc_rmatvec
    for wrong in (torch.float32, torch.float64):
        def off_by_one_entry(csc, v, square=False, wrong=wrong):
            r = plain(csc, v, square=square).clone()
            if r.dtype == wrong and not square:
                r[3] += float(abs(val[0, 3] * v[0]))
            return r

        monkeypatch.setattr(cs, "csc_rmatvec", off_by_one_entry)
        with pytest.raises(AssertionError, match="csc_rmatvec disagrees"):
            chip_smoke.check_bounded(torch, cs, cpu, idx, val, dim, seed=16)
