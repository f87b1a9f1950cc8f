"""Multi-host elasticity drill for the PyTorch port.

    python scripts/multihost_smoke_torch.py                 # on the card
    python scripts/multihost_smoke_torch.py --device cpu    # on the CPU

N real OS processes on one machine play an elastic mesh over a shared
filesystem (``python -m photon_tpu_torch.parallel.elastic``), the
counterpart of ``scripts/multihost_smoke.py``:

1. **Uninterrupted reference**: 3 workers train the elastic GAME loop to
   the end; every host must report zero new shapes after warmup, and the
   mesh ledger exactly one ``mesh_formed`` epoch.
2. **SIGKILL drill**: the same run, but host 2 is SIGKILLed after
   ``commit-1`` lands. The survivors must classify the silence as
   ``host_lost``, journal the coordinated shrink (``mesh_shrunk`` with
   members ``[0, 1]``, ``shard_redistributed`` rows for the dead host's
   file parts and for its entities), redo the step in flight from the last
   commit and train on. The victim is then restarted: it must journal
   ``host_rejoined`` and grow the mesh back to ``[0, 1, 2]``
   (``mesh_grown``) at a step boundary; its process is brought up beside
   the others and starts the worker when the drill tells it, so
   rejoin-to-grow is the protocol's time, from the restart to the scale-up
   (the interpreter's and the card's start-up are not in it). The drill
   restarts it once host 1 has arrived in the shrunk epoch: restarted as
   soon as the shrink row lands (the JAX drill's timing), its fresh beacon
   can hide the death from host 1 before host 1 has seen it, and host 1
   then waits in the old epoch's barrier until its timeout (a fault of the
   membership protocol, shared with the JAX package). Both
   survivors shrank, neither saw a new shape after warmup, and ``w`` and
   ``re_scores`` are within 1e-12 of leg 1 (bit-equal by construction: the
   reduction folds per-part partials in part order, so who computed a part
   never changes what is summed).
3. **Fleet posture**: the port's fleet report over the run directory
   renders the Mesh section with the loss and the rejoin.

Every worker runs on ``--device`` (the card by default), at the JAX
drill's sizes. Legs 1 and 2 compare the card with itself, so a witness
checks the card's answers: when the workers are on the card, one host on
the CPU runs the first sweep beside leg 1, and leg 1's ``commit-1`` (``w``
and ``re_scores`` after that sweep) must be within ``WITNESS_RTOL`` of
it, relative to the largest value.
:func:`run_drill` takes other sizes and returns the legs' timings (step
seconds, kill-to-shrink and rejoin-to-grow seconds) for callers that
measure (``chip_smoke.phase_elastic``).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOSTS = 3
# The witness's bar: one f64 sweep on two devices, whose sums differ only
# in order (a wrong kernel is off by far more than rounding).
WITNESS_RTOL = 1e-9
WITNESS_THREADS = 3     # its intra-op threads (it runs beside leg 1)


class DrillFailed(AssertionError):
    """A check of the drill did not hold."""


def check(cond, msg: str, log=print, rows=None) -> None:
    if not cond:
        if rows is not None:       # the ledger, for the post-mortem
            msg += "; ledger: " + json.dumps(
                [{k: r.get(k) for k in ("event", "epoch", "members", "host")}
                 for r in rows])[:3000]
        raise DrillFailed(msg)
    log(f"  ok: {msg}")


# A worker that is up (imports and device) before it is told to start: the
# restarted host 2, brought up beside the others so that its start-up does
# not race the survivors to the end of the run (it takes over host 2's id
# only once the drill writes the go file).
_STANDBY = r"""
import os, sys, time
import torch
from photon_tpu_torch.parallel import elastic
argv = sys.argv[2:]
torch.zeros(1, device=argv[argv.index("--device") + 1])
while not os.path.exists(sys.argv[1]):
    time.sleep(0.01)
sys.exit(elastic.worker_main(argv))
"""


def spawn(mesh_dir: str, manifest: str, host_id: int, opts: dict,
          min_step: float = 0.0, go_file=None, hosts: int = HOSTS,
          threads: int = 1):
    """One elastic worker process (its own interpreter: a SIGKILL must take
    out a real host, beacons and all) of a mesh of ``hosts``, with
    ``threads`` intra-op threads; with ``go_file``, a standby that starts
    the worker when the file appears."""
    args = [
        "--mesh-dir", mesh_dir, "--host-id", str(host_id),
        "--hosts", str(hosts), "--manifest", manifest,
        "--device", opts["device"],
        "--sweeps", str(opts["sweeps"]), "--min-step-seconds", str(min_step),
        # N processes timeshare the cores, so a beacon thread can starve
        # for seconds: a wide staleness window (0.5 s x 10) keeps "slow"
        # from reading as "dead", and the SIGKILL is still seen in ~5 s.
        "--beat-seconds", "0.5", "--stale-factor", "10",
        "--max-iterations", str(opts["max_iterations"]),
    ]
    cmd = ([sys.executable, "-c", _STANDBY, go_file] if go_file
           else [sys.executable, "-m", "photon_tpu_torch.parallel.elastic"])
    # one intra-op thread a worker: the workers share the machine's cores
    env = {**os.environ, "OMP_NUM_THREADS": str(threads),
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return subprocess.Popen(cmd + args, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def finish(proc, who: str, deadline_s: float) -> dict:
    try:
        out, err = proc.communicate(timeout=deadline_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate(timeout=30)
        raise DrillFailed(f"{who} timed out after {deadline_s}s; stderr tail: "
                          + (err or "")[-800:])
    if proc.returncode != 0:
        raise DrillFailed(f"{who} exited {proc.returncode}; stderr tail: "
                          + (err or "")[-800:])
    return json.loads((out or "").strip().splitlines()[-1])


def ledger_rows(mesh_dir: str) -> list:
    rows = []
    path = os.path.join(mesh_dir, "mesh-epochs.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        rows.append(json.loads(line))
                    except ValueError:
                        continue  # a row mid-append; the next poll sees it
    return rows


def wait_for(pred, what: str, deadline_s: float) -> float:
    """Seconds until ``pred()`` held (polled every 50 ms)."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        if pred():
            return time.monotonic() - t0
        time.sleep(0.05)
    raise DrillFailed(f"timed out waiting for {what}")


def _has_event(mesh_dir: str, event: str):
    return lambda: any(r["event"] == event for r in ledger_rows(mesh_dir))


def run_drill(work: str, *, device: str = "cuda", n_parts: int = 6,
              rows_per_part: int = 24, dim: int = 6, n_entities: int = 12,
              sweeps: int = 4, max_iterations: int = 12,
              min_step: float = 0.4, deadline_s: float = 280.0,
              witness=None, log=print) -> dict:
    """The three legs in ``work``; raises :class:`DrillFailed` when a check
    does not hold, else returns the timings and the largest differences
    from the uninterrupted run. ``witness``: the device of a one-host run
    of the first sweep beside leg 1, held against leg 1's ``commit-1``
    within ``WITNESS_RTOL`` (None: no witness)."""
    import numpy as np

    from photon_tpu_torch.parallel.elastic import make_synthetic_parts

    opts = {"device": device, "sweeps": sweeps, "max_iterations": max_iterations}
    t0 = time.perf_counter()
    manifest = make_synthetic_parts(
        os.path.join(work, "data"), n_parts=n_parts,
        rows_per_part=rows_per_part, dim=dim, n_entities=n_entities)
    out = {"data_s": time.perf_counter() - t0}

    log("leg 1: uninterrupted 3-host run"
        + (f", a one-host witness on {witness} beside it" if witness else ""))
    t0 = time.perf_counter()
    mesh_a = os.path.join(work, "meshA")
    mesh_w = os.path.join(work, "meshW")
    procs = [spawn(mesh_a, manifest, h, opts) for h in range(HOSTS)]
    wit = (spawn(mesh_w, manifest, 0, dict(opts, device=witness, sweeps=1),
                 hosts=1, threads=WITNESS_THREADS) if witness else None)
    try:
        sums = [finish(p, f"reference host {h}", deadline_s)
                for h, p in enumerate(procs)]
        out["leg1_s"] = time.perf_counter() - t0
        if wit is not None:
            ws = finish(wit, f"witness on {witness}", deadline_s)
            out["witness"] = {"device": witness, "threads": WITNESS_THREADS,
                              "s": time.perf_counter() - t0,
                              "step_seconds": ws["step_seconds"]}
    finally:
        for p in procs + [wit]:
            if p is not None and p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    if wit is not None:
        # leg 1 after its first sweep against the witness's whole run
        with np.load(os.path.join(mesh_a, "commits", "commit-1.npz")) as a, \
                np.load(os.path.join(mesh_w, "final-model.npz")) as b:
            rel = {name: float(np.max(np.abs(a[name] - b[name]))
                               / max(float(np.max(np.abs(b[name]))), 1e-300))
                   for name in ("w", "re_scores")}
        out["witness"]["rel_err"] = rel
        out["witness"]["bar"] = WITNESS_RTOL
        for name, r in rel.items():
            check(r <= WITNESS_RTOL, f"{name} after the first sweep within "
                  f"{WITNESS_RTOL} of the {witness} witness ({r:.3e})", log)
    for s in sums:
        check(s["new_shapes_after_warmup"] == 0,
              f"reference host {s['host_id']}: no new shape after warmup", log)
    check([r["event"] for r in ledger_rows(mesh_a)] == ["mesh_formed"],
          "reference ledger is exactly one mesh_formed epoch", log)
    out["leg1_step_seconds"] = {s["host_id"]: s["step_seconds"] for s in sums}
    ref = np.load(os.path.join(mesh_a, "final-model.npz"))

    log("leg 2: SIGKILL host 2 mid-sweep, restart it")
    t0 = time.perf_counter()
    mesh_b = os.path.join(work, "meshB")
    survivors = [spawn(mesh_b, manifest, h, opts, min_step) for h in (0, 1)]
    victim = spawn(mesh_b, manifest, 2, opts, min_step)
    go = os.path.join(work, "rejoin-go")
    rejoiner = spawn(mesh_b, manifest, 2, opts, min_step, go_file=go)
    try:
        wait_for(lambda: os.path.exists(
            os.path.join(mesh_b, "commits", "commit-1.json")),
            "commit-1 (kill point)", deadline_s)
        os.kill(victim.pid, signal.SIGKILL)
        victim.communicate(timeout=30)
        log(f"  killed host 2 (pid {victim.pid})")
        out["kill_to_shrink_s"] = wait_for(_has_event(mesh_b, "mesh_shrunk"),
                                           "journaled mesh shrink", deadline_s)
        # Restart host 2 once the other survivor has adopted the shrink (it
        # arrived at a barrier of the new epoch): a host 2 beaconing again
        # before then can hide the death from it, which then waits for
        # host 2 in the old epoch's barrier until its timeout (ROADMAP,
        # Queue 3).
        epoch = [r for r in ledger_rows(mesh_b) if r["event"] == "mesh_shrunk"][0]["epoch"]
        wait_for(lambda: glob.glob(os.path.join(mesh_b, "barriers", f"e{epoch}",
                                                "*", "host-1")),
                 "host 1 in the shrunk epoch", deadline_s)
        open(go, "w").close()       # host 2 restarts
        out["rejoin_to_grow_s"] = wait_for(_has_event(mesh_b, "mesh_grown"),
                                           "journaled mesh grow", deadline_s)
        s0 = finish(survivors[0], "survivor host 0", deadline_s)
        s1 = finish(survivors[1], "survivor host 1", deadline_s)
        s2 = finish(rejoiner, "rejoined host 2", deadline_s)
    finally:
        for p in survivors + [victim, rejoiner]:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    out["leg2_s"] = time.perf_counter() - t0
    out["leg2_step_seconds"] = {s["host_id"]: s["step_seconds"]
                                for s in (s0, s1, s2)}
    # the kernels' launches in every worker that finished (not the victim)
    out["launches"] = {k: sum(s["kernel_launches"][k] for s in sums + [s0, s1, s2])
                       for k in s0["kernel_launches"]}

    rows = ledger_rows(mesh_b)
    events = [r["event"] for r in rows]
    lost = [r for r in rows if r["event"] == "host_lost"]
    check(lost and lost[0]["host"] == 2 and lost[0]["cause"] == "host_lost",
          "host_lost journaled for host 2 with classified cause", log, rows)
    shrunk = [r for r in rows if r["event"] == "mesh_shrunk"]
    check(shrunk and shrunk[0]["members"] == [0, 1] and shrunk[0]["dead"] == [2],
          "mesh_shrunk epoch journaled with surviving members [0, 1]", log, rows)
    redist = [r for r in rows if r["event"] == "shard_redistributed"]
    check({"files", "entities"} <= {r["kind"] for r in redist},
          "dead host's file parts AND entity shard redistributed", log, rows)
    mine = [f"p{i:03d}" for i in range(2, n_parts, HOSTS)]
    moved = [i for r in redist if r["kind"] == "files" and r.get("items")
             for i in r["items"]]
    check(any(i in mine for i in moved),
          "host 2's file parts reassigned to survivors", log, rows)
    check("host_rejoined" in events and "mesh_grown" in events,
          "restart journaled host_rejoined + mesh_grown scale-up", log, rows)
    grown = [r for r in rows if r["event"] == "mesh_grown"][-1]
    check(grown["members"] == [0, 1, 2], "mesh grew back to all 3 hosts", log, rows)
    check(events.index("mesh_shrunk") < events.index("mesh_grown"),
          "shrink precedes scale-up in the ledger", log, rows)
    check(s0["shrinks"] >= 1 and s1["shrinks"] >= 1,
          "both survivors ran the coordinated shrink", log, rows)
    check(s2["rejoined"], "host 2 came back via the rejoin path", log, rows)
    check(s0["new_shapes_after_warmup"] == 0 and s1["new_shapes_after_warmup"] == 0,
          "survivors: no new shape after warmup across shrink AND regrow", log, rows)
    got = np.load(os.path.join(mesh_b, "final-model.npz"))
    out["max_abs_diff"] = {}
    for name in ("w", "re_scores"):
        diff = float(np.max(np.abs(ref[name] - got[name])))
        out["max_abs_diff"][name] = diff
        check(diff <= 1e-12,
              f"{name} matches uninterrupted run (max diff {diff:.3e})", log)

    log("leg 3: fleet report + merged cost table")
    from photon_tpu_torch.obs.analysis.report import build_report, format_markdown

    report = build_report(mesh_b)
    mesh = report.get("mesh")
    check(mesh is not None, "report has a mesh section", log)
    check(mesh["members"] == [0, 1, 2] and len(mesh["host_losses"]) >= 1
          and len(mesh["rejoins"]) >= 1,
          "mesh section carries topology + host-loss ledger", log)
    md = format_markdown(report)
    check("## Mesh" in md and "host LOST: 2" in md and "host rejoined: 2" in md,
          "markdown render shows the loss and the rejoin", log)
    check(mesh["beacon_age_seconds"], "per-host beacon ages exported", log)
    if glob.glob(os.path.join(mesh_b, "solver_costs.host-*.json")):
        check(os.path.exists(os.path.join(mesh_b, "solver_costs.merged.json")),
              "coordinator folded per-host cost tables into "
              "solver_costs.merged.json", log)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="where the workers solve: cuda (default) or cpu")
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)
    with tempfile.TemporaryDirectory(prefix="multihost_smoke_torch_") as work:
        try:
            out = run_drill(work, device=args.device,
                            witness=None if args.device == "cpu" else "cpu")
        except DrillFailed as e:
            print(f"MULTIHOST SMOKE FAILED: {e}", file=sys.stderr)
            return 1
    print(json.dumps(out))
    print("MULTIHOST SMOKE PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
