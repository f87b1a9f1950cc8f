"""Chaos tests of training: the port's GAME training driver under injected
fault plans (``--fault-plan``) holds the recovery contracts.

On a small GAME fit (200 users of 8 rows, a fixed effect and a per-user
random effect, 2 sweeps, float64, ``--device cpu``):

* a preemption at ``descent.step`` mid-sweep, under ``--max-restarts`` and
  ``--checkpoint-dir``, restarts once (one classified ``preemption``
  restart in ``recovery.jsonl``) and resumes to the port's uninterrupted
  model bit for bit, within 1e-9 (of the largest coefficient) of the JAX
  driver's uninterrupted f64 model;
* a bit-flipped newest snapshot is refused by its checksum, the resume
  falls back to the one before and still ends on the uninterrupted model;
* a ``device_lost`` at ``descent.device`` recovers in the run (no restart)
  bit-identically, with a checkpoint directory and without one, and past
  ``PHOTON_DEVICE_LOST_MAX_RECOVERIES`` escalates to the supervisor, which
  journals its classified exhaustion;
* a ``device_oom`` in the random-effect sweep downshifts the bucket one
  chunk tier and does not restart (the chunked solve within 1e-9 of the
  uninterrupted model; the port bit-equal to its own run at that tier is
  ``tests/test_torch_memory_guard.py``'s);
* a fault at ``checkpoint.write`` surfaces on the next save as a
  retryable failure, and the restart resumes bit-identically;
* a preemption at ``io.block_read`` through ``--fault-plan`` ends an
  unsupervised run and is restarted by a supervised one.
"""
import json
import os

import pytest

import jax.numpy as jnp

from photon_tpu.cli import game_training_driver as jax_training
from photon_tpu.io.avro import read_records
from photon_tpu_torch.cli import game_training_driver
from photon_tpu_torch.faults import DeviceLostError, PreemptionError, bit_flip
from photon_tpu_torch.obs.metrics import REGISTRY
from photon_tpu_torch.supervisor import RestartsExhausted
from test_torch_jax_decoder import jax_decoder  # noqa: F401
from test_torch_scoring_driver import _write_game_avro

SPECS = ["fixed:type=fixed,shard=global,reg=L2,reg_weights=1,max_iter=30",
         "perUser:type=random,re_type=userId,shard=global,reg=L2,reg_weights=1,"
         "max_iter=30"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    jnp.zeros(1).block_until_ready()
    d = tmp_path_factory.mktemp("torch_chaos")
    _write_game_avro(d / "train.avro", seed=1, n_users=200, rows_per_user=8,
                     offsets=True)
    _write_game_avro(d / "valid.avro", seed=3, n_users=200, rows_per_user=3,
                     offsets=True)
    return d


def _args(d, out, *extra):
    return ["--train-data", str(d / "train.avro"), "--validation-data",
            str(d / "valid.avro"), "--evaluators", "AUC", "--task",
            "LOGISTIC_REGRESSION", "--coordinate", SPECS[0], "--coordinate",
            SPECS[1], "--sweeps", "2", "--dtype", "float64", "--output-dir",
            str(out), *extra]


def _port(d, out, *extra, plan=None):
    if plan is not None:
        path = out.parent / f"{out.name}.plan.json"
        path.write_text(json.dumps({"seed": 0, "specs": plan}))
        extra = extra + ("--fault-plan", str(path))
    return game_training_driver.run(_args(d, out, "--device", "cpu", *extra))


def _saved(model_dir) -> dict:
    (fixed,) = read_records(str(model_dir / "fixed-effect" / "fixed" / "coefficients.avro"))
    out = {("fixed", m["name"], m["term"]): m["value"] for m in fixed["means"]}
    for rec in read_records(str(model_dir / "random-effect" / "perUser" / "part-00000.avro")):
        out.update({(rec["modelId"], m["name"], m["term"]): m["value"]
                    for m in rec["means"]})
    return out


def _journal(out) -> list:
    path = out / "recovery.jsonl"
    return [json.loads(r) for r in path.read_text().splitlines()] if path.exists() else []


@pytest.fixture(scope="module")
def reference(data, tmp_path_factory):
    """The uninterrupted runs: the port's, and the JAX driver's in f64."""
    root = tmp_path_factory.mktemp("chaos_ref")
    summary = _port(data, root / "port")
    jax_training.run(_args(data, root / "jax", "--devices", "1"))
    return summary, _saved(root / "port" / "best"), _saved(root / "jax" / "best")


def test_reference_matches_jax(reference):
    _, port, jax = reference
    assert set(port) == set(jax) and len(port) > 200
    scale = max(abs(v) for v in jax.values())
    assert max(abs(port[k] - jax[k]) for k in jax) <= 1e-9 * scale


def test_preemption_mid_sweep_resumes_bit_identical(data, reference, tmp_path):
    summary, want, jax = reference
    out = tmp_path / "run"
    got = _port(data, out, "--checkpoint-dir", str(tmp_path / "ck"), "--max-restarts",
                "2", "--restart-backoff", "0",
                plan=[{"site": "descent.step", "error": "preemption", "after": 2,
                       "count": 1}])
    assert _saved(out / "best") == want and got["evaluation"] == summary["evaluation"]
    scale = max(abs(v) for v in jax.values())
    assert max(abs(want[k] - jax[k]) for k in jax) <= 1e-9 * scale
    rows = _journal(out)
    assert [r["event"] for r in rows] == [
        "attempt_start", "first_step", "attempt_failed", "restart", "attempt_start",
        "first_step", "run_ok"]
    restart = rows[3]
    assert restart["cause"] == "preemption" and restart["backoff_s"] == 0.0
    assert "resuming from checkpoint" in (out / "photon.log").read_text()


def test_corrupt_checkpoint_falls_back_then_resumes_identical(data, reference,
                                                              tmp_path):
    _, want, _ = reference
    ck = tmp_path / "ck"
    with pytest.raises(PreemptionError):
        _port(data, tmp_path / "a", "--checkpoint-dir", str(ck),
              plan=[{"site": "descent.step", "error": "preemption", "after": 3,
                     "count": 1}])
    steps = sorted(int(n.split("-")[1]) for n in os.listdir(ck) if n.startswith("step-"))
    assert len(steps) == 2
    bit_flip(str(ck / f"step-{steps[-1]}"), n_flips=1, seed=5, min_offset=16)
    _port(data, tmp_path / "b", "--checkpoint-dir", str(ck))
    log = (tmp_path / "b" / "photon.log").read_text()
    assert f"refusing checkpoint step-{steps[-1]}" in log and "checksum" in log
    assert _saved(tmp_path / "b" / "best") == want


@pytest.mark.parametrize("with_checkpoint", [True, False])
def test_device_lost_recovers_in_run_bit_identical(data, reference, tmp_path,
                                                   with_checkpoint):
    _, want, _ = reference
    counter = REGISTRY.counter("run_restarts_total")
    before = counter.value(cause="device_lost")
    extra = ("--checkpoint-dir", str(tmp_path / "ck")) if with_checkpoint else ()
    out = tmp_path / "run"
    _port(data, out, *extra, "--max-restarts", "1",
          plan=[{"site": "descent.device", "error": "device_lost", "after": 2,
                 "count": 1}])
    assert _saved(out / "best") == want
    assert counter.value(cause="device_lost") == before + 1
    assert [r["event"] for r in _journal(out)] == ["attempt_start", "first_step",
                                                   "run_ok"]      # no restart
    assert "in-run recovery 1/2" in (out / "photon.log").read_text()
    if with_checkpoint:
        assert any(n.startswith("step-") for n in os.listdir(tmp_path / "ck"))


def test_device_lost_escalates_past_its_budget(data, tmp_path, monkeypatch):
    monkeypatch.setenv("PHOTON_DEVICE_LOST_MAX_RECOVERIES", "1")
    out = tmp_path / "run"
    with pytest.raises(RestartsExhausted) as ei:
        _port(data, out, "--max-restarts", "1", "--restart-backoff", "0",
              plan=[{"site": "descent.device", "error": "device_lost"}])
    assert ei.value.cause == "device_lost"
    assert isinstance(ei.value.last, DeviceLostError)
    rows = _journal(out)
    assert [r["event"] for r in rows if r["event"] != "attempt_start"] == [
        "attempt_failed", "restart", "attempt_failed", "exhausted"]
    assert all(r["cause"] == "device_lost" for r in rows if "cause" in r)


def test_device_oom_mid_re_sweep_downshifts_without_restart(data, reference,
                                                            tmp_path, monkeypatch):
    _, want, _ = reference
    monkeypatch.setenv("PHOTON_RE_CHUNK_LADDER", "16,64")
    out = tmp_path / "run"
    _port(data, out, "--max-restarts", "2",
          plan=[{"site": "re.solve", "error": "device_oom", "after": 1, "count": 1}])
    rows = _journal(out)
    assert [r["event"] for r in rows] == ["attempt_start", "first_step",
                                          "oom_downshift", "run_ok"]
    assert rows[2]["site"] == "re.solve" and rows[2]["after"].endswith("@64")
    got = _saved(out / "best")
    scale = max(abs(v) for v in want.values())
    assert set(got) == set(want)
    assert max(abs(got[k] - want[k]) for k in want) <= 1e-9 * scale


def test_checkpoint_write_fault_surfaces_as_retryable(data, reference, tmp_path):
    _, want, _ = reference
    out = tmp_path / "run"
    _port(data, out, "--checkpoint-dir", str(tmp_path / "ck"), "--max-restarts", "1",
          "--restart-backoff", "0",
          plan=[{"site": "checkpoint.write", "error": "os", "after": 1, "count": 1}])
    rows = _journal(out)
    failed = [r for r in rows if r["event"] == "attempt_failed"]
    assert len(failed) == 1 and failed[0]["will_restart"]
    assert "checkpoint writer failed" in failed[0]["error"]
    assert [r["event"] for r in rows][-1] == "run_ok"
    assert _saved(out / "best") == want


def test_block_read_preemption_through_fault_plan(data, reference, tmp_path):
    _, want, _ = reference
    plan = [{"site": "io.block_read", "error": "preemption", "count": 1}]
    with pytest.raises(PreemptionError):
        _port(data, tmp_path / "a", plan=plan)
    out = tmp_path / "b"
    _port(data, out, "--max-restarts", "1", "--restart-backoff", "0", plan=plan)
    assert [r["cause"] for r in _journal(out) if r["event"] == "restart"] == ["preemption"]
    assert _saved(out / "best") == want


def test_debug_nans_names_the_step(data, tmp_path, monkeypatch):
    """``--debug-nans`` checks each step's model and scores at the commit
    gate: a random effect whose scores turn non-finite stops the run with
    ``FloatingPointError`` naming its sweep, coordinate and step."""
    from photon_tpu_torch.game import coordinates

    score = coordinates.RandomEffectCoordinate.score
    monkeypatch.setattr(coordinates.RandomEffectCoordinate, "score",
                        lambda self, model: score(self, model) * float("nan"))
    with pytest.raises(FloatingPointError,
                       match="sweep 0, coordinate 'perUser', step 1"):
        _port(data, tmp_path / "run", "--debug-nans")
