"""Process groups and the drivers' mesh flags
(``photon_tpu_torch/parallel/distributed.py``, ``cli/params``) on the CPU.

* ``initialize_distributed``: a no-op in one process; against an
  unreachable coordinator ``strict`` raises a classified
  ``DistributedInitError`` (the driver prints ``fatal [<cause>]`` and exits
  2) and ``degrade`` journals ``distributed_init_failed`` and goes on.
* File shards: ``assign_file_shards`` equals the JAX package's.
* Two gloo processes, each with a 2-shard mesh whose ``dcn`` axis is the
  group: each rank's fixed-effect fit equals the one-process 4-shard fit
  within 1e-12 (f64), every rank's coefficients are bit-equal to rank 0's,
  and a batch assembled from each rank's own rows fits the same.
* The GAME training and scoring drivers with ``--devices 4`` (the visible
  devices patched to 4 CPU devices): model files and scores equal the JAX
  drivers' ``--devices 4`` runs at the f64 driver bar of
  ``tests/test_torch_re_training.py`` (1e-8; scores 1e-12) and the port's
  one-device run within 1e-10; ``--devices 2`` on one visible device and a
  ``model`` axis exit 2.
"""
from __future__ import annotations

import json
import os
import socket

import numpy as np
import pytest
import torch

CPU = torch.device("cpu")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(autouse=True)
def _no_group(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    yield
    from photon_tpu_torch.parallel import distributed as pd

    pd.shutdown_distributed()


# ------------------------------------------------------------------ bring-up


def test_initialize_is_a_noop_in_one_process(monkeypatch):
    from photon_tpu_torch.parallel import distributed as pd

    assert pd.initialize_distributed() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert pd.initialize_distributed() is False
    assert (pd.process_index(), pd.process_count()) == (0, 1)
    assert pd.process_file_shard() == (0, 1)
    assert pd.process_file_shard(["a", "b", "c"]) == ["a", "b", "c"]
    mesh = pd.multihost_mesh({"data": 2}, devices=[CPU, CPU])
    assert mesh.shape == {"data": 2} and mesh.process_axis is None


def test_policy_resolution(monkeypatch):
    from photon_tpu_torch.parallel.distributed import resolve_distributed_policy

    monkeypatch.delenv("PHOTON_DISTRIBUTED_POLICY", raising=False)
    assert resolve_distributed_policy() == "strict"
    monkeypatch.setenv("PHOTON_DISTRIBUTED_POLICY", "degrade")
    assert resolve_distributed_policy() == "degrade"
    assert resolve_distributed_policy("strict") == "strict"
    with pytest.raises(ValueError):
        resolve_distributed_policy("yolo")


@pytest.mark.parametrize("policy", ["strict", "degrade"])
def test_unreachable_coordinator(policy, tmp_path, monkeypatch):
    """Rank 1 of 2 dials a port nobody listens on: the bring-up fails
    within the timeout, is counted and journaled; strict raises the
    classified error, degrade goes on single-host."""
    from photon_tpu_torch.obs.metrics import REGISTRY
    from photon_tpu_torch.parallel import distributed as pd
    from photon_tpu_torch.supervisor import RecoveryJournal

    monkeypatch.setenv("PHOTON_DISTRIBUTED_INIT_TIMEOUT_S", "2")
    journal = RecoveryJournal(str(tmp_path / "recovery.jsonl"))
    counter = REGISTRY.counter("distributed_init_failed_total")
    before = {c: counter.value(cause=c, policy=policy)
              for c in ("unknown", "init_unavailable", "host_lost")}
    addr = f"127.0.0.1:{free_port()}"
    if policy == "strict":
        with pytest.raises(pd.DistributedInitError) as ei:
            pd.initialize_distributed(addr, 2, 1, backend="gloo", policy=policy,
                                      journal=journal)
        assert ei.value.cause
    else:
        assert pd.initialize_distributed(addr, 2, 1, backend="gloo",
                                         policy=policy, journal=journal) is False
    rows = [json.loads(x) for x in
            (tmp_path / "recovery.jsonl").read_text().splitlines()]
    assert [r["event"] for r in rows] == ["distributed_init_failed"]
    assert rows[0]["policy"] == policy and rows[0]["cause"]
    cause = rows[0]["cause"]
    assert counter.value(cause=cause, policy=policy) == before.get(cause, 0.0) + 1
    assert pd.process_count() == 1


def test_strict_driver_exits_2_with_the_classified_line(tmp_path, monkeypatch,
                                                         capsys):
    from photon_tpu_torch.cli import game_training_driver

    monkeypatch.setenv("PHOTON_DISTRIBUTED_INIT_TIMEOUT_S", "2")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    monkeypatch.setattr("sys.argv", [
        "game_training_driver", "--train-data", str(tmp_path / "x.avro"),
        "--output-dir", str(tmp_path / "out"), "--task", "LOGISTIC_REGRESSION",
        "--coordinate", "fixed:type=fixed,shard=global", "--device", "cpu",
        "--distributed-policy", "strict"])
    with pytest.raises(SystemExit) as e:
        game_training_driver.main()
    assert e.value.code == 2
    assert "fatal [" in capsys.readouterr().err
    rows = (tmp_path / "out" / "recovery.jsonl").read_text().splitlines()
    assert json.loads(rows[0])["event"] == "distributed_init_failed"


@pytest.mark.parametrize("files,hosts", [(7, 3), (2, 4), (0, 2), (5, 1)])
def test_file_shards_equal_jax(files, hosts):
    from photon_tpu.parallel.distributed import assign_file_shards as jax_assign
    from photon_tpu_torch.parallel.distributed import assign_file_shards

    names = [f"part-{i:05d}.avro" for i in range(files)]
    assert assign_file_shards(names, range(hosts)) == jax_assign(names, range(hosts))
    with pytest.raises(ValueError):
        assign_file_shards(names, [])


# ------------------------------------------------- two gloo processes


def fe_inputs():
    from test_torch_data_parallel import batches, problems

    pb, _ = batches("LOGISTIC_REGRESSION", seed=11)
    p, _ = problems("LOGISTIC_REGRESSION", "LBFGS")
    return pb, p


def _gloo_worker(rank: int, world: int, port: int, out: str) -> None:
    """One rank: join the group, fit the whole batch over the ``("dcn",
    "data")`` mesh (this rank's block in 2 shards), then fit a batch
    assembled from this rank's own rows; write both coefficient vectors."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from photon_tpu_torch.parallel import distributed as pd
    from photon_tpu_torch.parallel.mesh import pad_rows_to_multiple
    from photon_tpu_torch.parallel.spmd_objective import fit_spmd

    assert pd.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                     backend="gloo")
    pb, p = fe_inputs()
    mesh = pd.multihost_mesh({"data": 2}, devices=[CPU, CPU])
    assert mesh.shape == {"dcn": 2, "data": 2} and mesh.rank == rank
    w0 = torch.zeros(pb.dim, dtype=torch.float64)
    model, result = fit_spmd(p, pb, w0, mesh, data_axis=("dcn", "data"))
    padded = pad_rows_to_multiple(pb, 4)
    half = padded.n_rows // 2
    from photon_tpu_torch.parallel.mesh import _slice_rows

    mine = _slice_rows(padded, rank * half, (rank + 1) * half)
    local = pd.global_batch_from_local(mine, mesh)
    m2, r2 = fit_spmd(p, local, w0, mesh)
    np.savez(os.path.join(out, f"rank{rank}.npz"),
             w=model.coefficients.means.numpy(), it=int(result.iterations),
             w_local=m2.coefficients.means.numpy())
    pd.shutdown_distributed()


def test_two_gloo_processes_match_one_process_four_shards(tmp_path):
    import torch.multiprocessing as tmp

    from photon_tpu_torch.parallel import fit_spmd, make_mesh

    port = free_port()
    tmp.spawn(_gloo_worker, args=(2, port, str(tmp_path)), nprocs=2, join=True)
    pb, p = fe_inputs()
    w0 = torch.zeros(pb.dim, dtype=torch.float64)
    ref, rr = fit_spmd(p, pb, w0, make_mesh({"data": 4}, devices=[CPU] * 4))
    ref = ref.coefficients.means.numpy()
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for got in ranks:
        np.testing.assert_allclose(got["w"], ref, rtol=0, atol=1e-12)
        np.testing.assert_allclose(got["w_local"], ref, rtol=0, atol=1e-12)
        assert int(got["it"]) == int(rr.iterations)
        np.testing.assert_array_equal(got["w"], ranks[0]["w"])
        np.testing.assert_array_equal(got["w_local"], ranks[0]["w_local"])


# --------------------------------------------------------------- drivers


FE = "fixed:type=fixed,shard=global,reg=L2,reg_weights=1,variance=SIMPLE"
RE = ("perUser:type=random,re_type=userId,shard=global,reg=L2,"
      "reg_weights=1,max_iter=20")


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The GAME training driver over 4 shards and over one device, and the
    JAX driver over 4 devices, on the same Avro files (f64, 2 sweeps)."""
    import jax.numpy as jnp

    from photon_tpu.cli import game_training_driver as jax_training
    from photon_tpu_torch.cli import game_training_driver, params
    from test_torch_jax_decoder import ensure_jax_decoder
    from test_torch_scoring_driver import _write_game_avro

    ensure_jax_decoder()
    jnp.zeros(1).block_until_ready()
    d = tmp_path_factory.mktemp("mesh_drivers")
    _write_game_avro(d / "train.avro", seed=1, offsets=True)
    _write_game_avro(d / "score.avro", seed=2, n_users=10, rows_per_user=6,
                     offsets=True)
    common = ["--train-data", str(d / "train.avro"), "--task",
              "LOGISTIC_REGRESSION", "--coordinate", FE, "--coordinate", RE,
              "--sweeps", "2", "--dtype", "float64"]
    orig = params.visible_devices
    params.visible_devices = lambda device="cuda": [CPU] * 4
    try:
        four = game_training_driver.run(common + [
            "--output-dir", str(d / "p4"), "--device", "cpu", "--devices", "4"])
    finally:
        params.visible_devices = orig
    one = game_training_driver.run(common + ["--output-dir", str(d / "p1"),
                                             "--device", "cpu"])
    jx = jax_training.run(common + ["--output-dir", str(d / "j4"), "--devices", "4"])
    return d, four, one, jx


def test_game_driver_devices_through_the_seam(mesh_runs):
    from test_torch_re_training import _saved_re
    from test_torch_training_driver import _saved

    d, four, one, jx = mesh_runs
    assert four["best_config_index"] == one["best_config_index"] == \
        jx["best_config_index"]
    for other, tol in ((d / "p1", 1e-10), (d / "j4", 1e-8)):
        pm, pv = _saved(d / "p4" / "best")
        om, ov = _saved(other / "best")
        assert set(pm) == set(om) and set(pv) == set(ov)
        assert max(abs(pm[k] - om[k]) for k in om) <= tol
        assert max(abs(pv[k] - ov[k]) / abs(ov[k]) for k in ov) <= tol
        pr, orr = _saved_re(d / "p4" / "best"), _saved_re(other / "best")
        assert set(pr) == set(orr) and len(pr) > 20
        assert max(abs(pr[k] - orr[k]) for k in orr) <= tol


def test_scoring_driver_devices_through_the_seam(mesh_runs, tmp_path, monkeypatch):
    from photon_tpu.cli import game_scoring_driver as jax_scoring
    from photon_tpu.io.avro import read_records
    from photon_tpu_torch.cli import game_scoring_driver, params

    d = mesh_runs[0]

    def scores(driver, dest, extra):
        driver.run(["--data", str(d / "score.avro"), "--model-dir",
                    str(d / "p4" / "best"), "--output-dir", str(dest),
                    "--dtype", "float64", *extra])
        return np.array([r["predictionScore"]
                         for r in read_records(str(dest / "scores.avro"))])

    one = scores(game_scoring_driver, tmp_path / "s1", ["--device", "cpu"])
    monkeypatch.setattr(params, "visible_devices", lambda device="cuda": [CPU] * 4)
    four = scores(game_scoring_driver, tmp_path / "s4",
                  ["--device", "cpu", "--devices", "4"])
    jx = scores(jax_scoring, tmp_path / "j4", ["--devices", "4"])
    assert np.std(four) > 0.05
    np.testing.assert_allclose(four, one, rtol=0, atol=1e-12)
    np.testing.assert_allclose(four, jx, rtol=0, atol=1e-12)


@pytest.mark.parametrize("flags,message", [
    (["--devices", "2"], "--devices 2 > 1 visible devices"),
    (["--mesh", "data=2"], "--mesh needs 2 devices, have 1"),
    (["--mesh", "data=2,model=2"], "--mesh needs 4 devices, have 1"),
], ids=["devices", "mesh", "model_axis"])
def test_game_driver_refuses_impossible_meshes(tmp_path, capsys, flags, message):
    from photon_tpu_torch.cli import game_training_driver

    with pytest.raises(SystemExit) as e:
        game_training_driver.run([
            "--train-data", str(tmp_path / "x.avro"), "--output-dir",
            str(tmp_path / "out"), "--task", "LOGISTIC_REGRESSION",
            "--coordinate", "fixed:type=fixed,shard=global", "--device", "cpu",
            *flags])
    assert e.value.code == 2
    assert message in capsys.readouterr().err
    assert not (tmp_path / "out").exists()
