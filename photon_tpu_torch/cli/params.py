"""CLI parameter parsing for the GAME training driver.

Port of the parts of ``photon_tpu/cli/params.py`` that the training
drivers need: the coordinate mini-DSL (``parse_coordinate_spec``,
``parse_coordinates``), the sweep expansion (``configs_from_specs``),
``parse_feature_shard``, the random-effect routing flags
(``add_re_routing_flags``, ``enable_re_routing``), the runtime guards'
flags (``add_backend_policy_flag``, ``enable_backend_guard``,
``console_main``, ``add_fault_plan_flag``, ``enable_fault_plan``), the
observability flags (``add_trace_flag``, ``enable_trace``,
``finish_trace``, ``add_telemetry_flag``, ``enable_telemetry``,
``finish_telemetry``, ``add_profile_flag``, ``profiling``,
``profile_range``), the meshes' flags (``mesh_from_flags`` over
``visible_devices``, ``add_distributed_flags``) and the one table of the
JAX drivers' flags that the port refuses (``refuse_unported``).

Coordinate spec (one ``--coordinate`` flag per coordinate):

    <cid>:<k>=<v>,<k>=<v>,...

keys: ``type`` fixed|random|factored (required); ``shard`` feature shard id;
``re_type`` entity id column (random, required); ``active_bound`` int;
``min_rows`` int; ``max_features`` int (Pearson filter);
``max_bucket_entities`` int; ``host_resident`` 0|1 (buckets kept on the
host for the device sweep cache); ``optimizer`` LBFGS|OWLQN|TRON; ``max_iter``
int; ``tol`` float; ``reg`` NONE|L1|L2|ELASTIC_NET; ``alpha`` elastic-net α;
``reg_weights`` '|'-separated floats (sweep, default 0); ``downsample``
rate in (0, 1]; ``variance`` NONE|SIMPLE|FULL; ``incremental`` prior weight
for incremental training from --model-input-dir; ``latent`` int and
``alternations`` int (``type=factored`` only: the latent dimension and the
latent/projection alternations, default 8 and 2).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import TYPE_CHECKING, Sequence

# The estimator and optimizer config types import torch. Only the coordinate
# mini-DSL needs them, so they load inside its functions, as in the JAX
# package's params.py: the serving front line's accelerator-free workers
# (``serving/async_frontend.py``, a checked copy of the JAX module, which
# imports ``cli.params``) use this module's trace and telemetry helpers and
# must load neither torch nor jax.
if TYPE_CHECKING:  # pragma: no cover - typing only
    from photon_tpu_torch.estimators.config import (
        CoordinateDataConfig,
        GLMOptimizationConfiguration,
    )

_RANDOM_ONLY = ("re_type", "active_bound", "min_rows", "max_features",
                "latent", "alternations", "max_bucket_entities",
                "host_resident")


@dataclasses.dataclass(frozen=True)
class CoordinateSpec:
    """One parsed ``--coordinate`` flag."""

    cid: str
    data: CoordinateDataConfig
    optimization: GLMOptimizationConfiguration
    reg_weights: tuple[float, ...]


def parse_coordinate_spec(spec: str) -> CoordinateSpec:
    from photon_tpu_torch.estimators.config import (
        FactoredRandomEffectDataConfig,
        FixedEffectDataConfig,
        GLMOptimizationConfiguration,
        RandomEffectDataConfig,
    )
    from photon_tpu_torch.functions.problem import VarianceComputationType
    from photon_tpu_torch.optim import OptimizerType
    from photon_tpu_torch.optim.regularization import (
        RegularizationContext,
        RegularizationType,
        elastic_net_context,
    )

    cid, sep, body = spec.partition(":")
    cid = cid.strip()
    if not sep or not cid:
        raise ValueError(
            f"coordinate spec must be '<cid>:k=v,...', got {spec!r}"
        )
    kv: dict[str, str] = {}
    for item in body.split(","):
        item = item.strip()
        if not item:
            continue
        k, sep, v = item.partition("=")
        if not sep:
            raise ValueError(f"coordinate {cid!r}: bad item {item!r} (need k=v)")
        kv[k.strip()] = v.strip()

    known = {"type", "shard", "optimizer", "max_iter", "tol", "reg", "alpha",
             "reg_weights", "downsample", "variance", "incremental",
             *_RANDOM_ONLY}
    unknown = set(kv) - known
    if unknown:
        raise ValueError(f"coordinate {cid!r}: unknown keys {sorted(unknown)}")

    ctype = kv.get("type")
    if ctype not in ("fixed", "random", "factored"):
        raise ValueError(
            f"coordinate {cid!r}: type must be 'fixed', 'random' or "
            f"'factored', got {ctype!r}"
        )
    shard = kv.get("shard", "global")
    if ctype == "fixed":
        for k in _RANDOM_ONLY:
            if k in kv:
                raise ValueError(f"coordinate {cid!r}: {k} is random-effect only")
        data: CoordinateDataConfig = FixedEffectDataConfig(feature_shard=shard)
    else:
        if "re_type" not in kv:
            raise ValueError(f"coordinate {cid!r}: random effects need re_type")
        re_kwargs = dict(
            re_type=kv["re_type"],
            feature_shard=shard,
            active_bound=int(kv["active_bound"]) if "active_bound" in kv else None,
            min_entity_rows=int(kv.get("min_rows", 1)),
            max_features_per_entity=(
                int(kv["max_features"]) if "max_features" in kv else None),
            max_bucket_entities=(
                int(kv["max_bucket_entities"])
                if "max_bucket_entities" in kv else None),
            host_resident=_parse_bool(cid, "host_resident",
                                      kv.get("host_resident", "0")),
        )
        if ctype == "factored":
            data = FactoredRandomEffectDataConfig(
                latent_dim=int(kv.get("latent", 8)),
                n_alternations=int(kv.get("alternations", 2)),
                **re_kwargs,
            )
        else:
            if "latent" in kv or "alternations" in kv:
                raise ValueError(
                    f"coordinate {cid!r}: latent/alternations need type=factored")
            data = RandomEffectDataConfig(**re_kwargs)

    reg_type = RegularizationType(kv.get("reg", "NONE").upper())
    if reg_type == RegularizationType.ELASTIC_NET:
        reg_ctx = elastic_net_context(float(kv.get("alpha", 0.5)))
    else:
        reg_ctx = RegularizationContext(reg_type)

    opt = GLMOptimizationConfiguration(
        optimizer_type=OptimizerType(kv.get("optimizer", "LBFGS").upper()),
        max_iterations=int(kv.get("max_iter", 80)),
        tolerance=float(kv.get("tol", 1e-7)),
        regularization=reg_ctx,
        down_sampling_rate=float(kv.get("downsample", 1.0)),
        variance_type=VarianceComputationType(kv.get("variance", "NONE").upper()),
        incremental_weight=float(kv.get("incremental", 0.0)),
    )
    weights = tuple(
        float(w) for w in kv.get("reg_weights", "0").split("|") if w != ""
    )
    return CoordinateSpec(cid=cid, data=data, optimization=opt,
                          reg_weights=weights or (0.0,))


def _parse_bool(cid: str, key: str, raw: str) -> bool:
    """Strict DSL booleans, as the JAX parser's."""
    low = raw.strip().lower()
    if low in ("1", "true", "yes"):
        return True
    if low in ("0", "false", "no"):
        return False
    raise ValueError(
        f"coordinate {cid!r}: {key} must be one of 1/0/true/false/yes/no, "
        f"got {raw!r}"
    )


def parse_coordinates(specs: Sequence[str]) -> list[CoordinateSpec]:
    out = [parse_coordinate_spec(s) for s in specs]
    seen = set()
    for c in out:
        if c.cid in seen:
            raise ValueError(f"duplicate coordinate id {c.cid!r}")
        seen.add(c.cid)
    return out


def configs_from_specs(specs: Sequence[CoordinateSpec]):
    """(data configs by cid, optimization-config sweep) from parsed specs."""
    from photon_tpu_torch.estimators.config import reg_weight_sweep

    data_configs = {c.cid: c.data for c in specs}
    base = {c.cid: c.optimization.with_reg_weight(c.reg_weights[0]) for c in specs}
    sweep_axes = {
        c.cid: list(c.reg_weights) for c in specs if len(c.reg_weights) > 1
    }
    configs = reg_weight_sweep(base, sweep_axes) if sweep_axes else [base]
    return data_configs, configs


@dataclasses.dataclass(frozen=True)
class FeatureShardSpec:
    """One parsed ``--feature-shard`` flag: ``<shard>:<bag>[+<bag>...][:no-intercept]``."""

    shard: str
    feature_bags: tuple[str, ...]
    add_intercept: bool


def parse_feature_shard(spec: str) -> FeatureShardSpec:
    parts = spec.split(":")
    if not (1 <= len(parts) <= 3) or not parts[0]:
        raise ValueError(
            f"feature shard spec must be '<shard>[:<bag>+<bag>][:no-intercept]', got {spec!r}"
        )
    shard = parts[0]
    bags = tuple((parts[1] if len(parts) > 1 and parts[1] else "features").split("+"))
    add_intercept = True
    if len(parts) == 3:
        if parts[2] != "no-intercept":
            raise ValueError(f"feature shard {shard!r}: expected 'no-intercept', got {parts[2]!r}")
        add_intercept = False
    return FeatureShardSpec(shard, bags, add_intercept)


def add_re_routing_flags(parser) -> None:
    """The random-effect solver-routing flags: ``--re-routing`` picks the
    static gate ladder or the measured cost table
    (``game/solver_routing.py``); ``--re-cost-table`` keeps the calibration
    results, so a restart skips the race and repeats the first run's
    decisions."""
    import os

    parser.add_argument(
        "--re-routing", choices=["static", "measured"],
        default=os.environ.get("PHOTON_RE_ROUTING") or "static",
        help="random-effect bucket solver routing: 'static' = the "
             "eligibility gates (primal / dual Newton, chunked tiers, lanes); "
             "'measured' = a per-shape cost table filled by a one-time "
             "calibration race (default: $PHOTON_RE_ROUTING or static)")
    parser.add_argument(
        "--re-cost-table",
        default=os.environ.get("PHOTON_RE_COST_TABLE") or None,
        help="JSON file of the measured-routing cost table (loaded at start "
             "if present, saved after every race); under --re-routing "
             "measured it defaults to <output-dir>/solver_costs.json "
             "(default: $PHOTON_RE_COST_TABLE)")


def enable_re_routing(args, output_dir=None) -> None:
    """Install the routing flags for the process (the bucket solver reads
    the environment). Under measured routing with no table path, the table
    is kept beside the model in ``output_dir``."""
    import logging
    import os

    os.environ["PHOTON_RE_ROUTING"] = args.re_routing
    table = args.re_cost_table
    if table is None and args.re_routing == "measured" and output_dir:
        table = os.path.join(output_dir, "solver_costs.json")
    if table:
        os.environ["PHOTON_RE_COST_TABLE"] = table
        logging.getLogger("photon_tpu_torch.cli").info(
            "RE solver routing: %s (cost table: %s%s)", args.re_routing,
            table, ", resuming" if os.path.exists(table) else "")


def visible_devices(device="cuda") -> list:
    """The distinct devices a driver's mesh may take for ``device``: every
    visible card for ``cuda``, the one CPU for ``cpu``. The drivers read
    the visible devices through this function alone (a test may patch it
    to give several CPU devices)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def mesh_from_flags(n_devices: int, mesh_spec=None, device="cuda"):
    """Shared --devices/--mesh handling for the drivers: 0 = all visible
    devices, 1 = no mesh (None), N = a ``data`` mesh over the first N
    distinct visible devices; ``mesh_spec`` ("data=4", "data=2,dcn=2")
    builds an explicit mesh, a ``model`` axis included ("data=2,model=2").
    Negative counts and over-subscription fail loud, with the JAX package's
    messages."""
    from photon_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh

    devices = visible_devices(device)
    avail = len(devices)
    if mesh_spec:
        axes = {}
        for item in mesh_spec.split(","):
            name, sep, size = item.partition("=")
            if not sep:
                raise ValueError(f"--mesh items must be axis=size, got {item!r}")
            axes[name.strip()] = int(size)
        if DATA_AXIS not in axes:
            raise ValueError(
                f"--mesh must include the '{DATA_AXIS}' axis (got {sorted(axes)})"
            )
        total = 1
        for s in axes.values():
            total *= s
        if total > avail:
            raise ValueError(f"--mesh needs {total} devices, have {avail}")
        return make_mesh(axes, devices=devices[:total])
    if n_devices < 0:
        raise ValueError(f"--devices must be >= 0, got {n_devices}")
    n = avail if n_devices == 0 else n_devices
    if n <= 1:      # no mesh, whatever is visible (a run on no card fails later)
        return None
    if n > avail:
        raise ValueError(f"--devices {n} > {avail} visible devices")
    return make_mesh({DATA_AXIS: n}, devices=devices[:n])


def add_distributed_flags(parser) -> None:
    """Shared --distributed-policy flag (default: $PHOTON_DISTRIBUTED_POLICY
    or 'strict'): what to do when the multi-process bring-up
    (``torch.distributed.init_process_group``) fails. Either way the
    failure is classified, counted and journaled
    (``distributed_init_failed``); the policy only decides whether the
    process dies or goes on single-host."""
    import os

    parser.add_argument(
        "--distributed-policy", choices=["strict", "degrade"],
        default=os.environ.get("PHOTON_DISTRIBUTED_POLICY") or "strict",
        help="on a failed multi-process bring-up: 'strict' = classified error "
             "+ exit 2 (a silent 1/N-sized mesh must never masquerade as the "
             "fleet); 'degrade' = journal the failure and continue "
             "single-host (default: $PHOTON_DISTRIBUTED_POLICY or strict)")


# Why a flag of the JAX drivers is refused: the same words in every driver.
NO_COMPILED_PROGRAMS = (
    "refused for good: the port compiles no XLA programs (its kernels build "
    "once per source into photon_tpu_torch/_build/), so there is nothing to "
    "cache, store or clear")


def refuse_unported(parser, args, table) -> None:
    """``parser.error`` (exit 2, before any work) for the first flag of
    ``table`` that is set. ``table`` holds ``(flag, is_set(args), why)``;
    every ``why`` left is ``NO_COMPILED_PROGRAMS``. A refused flag is never
    ignored."""
    for flag, is_set, why in table:
        if is_set(args):
            parser.error(f"{flag}: {why}")


def add_backend_policy_flag(parser) -> None:
    """``--backend-policy`` (default ``$PHOTON_BACKEND_POLICY`` or
    ``strict``): what to do when the card fails its health probe
    (``runtime/backend_guard``). The probe runs in a child process under
    the ``PHOTON_BACKEND_INIT_TIMEOUT_S`` deadline (default 120 s)."""
    import os

    parser.add_argument(
        "--backend-policy", choices=["strict", "failover", "cpu-only"],
        default=os.environ.get("PHOTON_BACKEND_POLICY") or "strict",
        help="on a failed CUDA health probe: 'strict' = one classified line "
             "and exit 2 (never train on other hardware than asked); "
             "'failover' = go on on the CPU, logged, with backend=cpu in the "
             "run's summary; 'cpu-only' = --device cpu (default: "
             "$PHOTON_BACKEND_POLICY or strict)")


def enable_backend_guard(args, logger=None, device=None) -> dict:
    """Enforce ``--backend-policy`` before the process touches the card;
    returns the guard snapshot, whose ``backend`` (``cuda`` or ``cpu``) is
    where the run goes. ``device`` defaults to ``args.device``; a run asked
    onto the CPU probes nothing. A failed probe under ``strict`` raises
    ``BackendUnusable`` (see :func:`console_main`)."""
    import logging

    from photon_tpu_torch.runtime.backend_guard import ensure_backend

    return ensure_backend(
        policy=getattr(args, "backend_policy", None) or "strict",
        logger=logger or logging.getLogger("photon_tpu_torch.runtime"),
        device=device or getattr(args, "device", None) or "cuda",
    )


def stamp_failover(summary: dict) -> dict:
    """``summary`` with the guard snapshot under ``backend`` when the run
    failed over to the CPU, so its numbers are never read as the card's."""
    from photon_tpu_torch.runtime.backend_guard import guard_snapshot

    snap = guard_snapshot()
    if snap is not None and snap.get("failover"):
        summary["backend"] = snap
    return summary


def console_main(run_fn) -> None:
    """Console entry of the drivers: a failed health probe under
    ``--backend-policy strict`` exits 2 with ONE classified line
    (``fatal [init_unavailable]: ...``), not a traceback."""
    import sys

    from photon_tpu_torch.runtime.backend_guard import BackendUnusable

    try:
        run_fn()
    except BackendUnusable as e:
        print(f"fatal [{e.cause}]: {e.reason}", file=sys.stderr)
        raise SystemExit(2) from None


def add_fault_plan_flag(parser) -> None:
    """``--fault-plan`` (default ``$PHOTON_FAULT_PLAN``): run the driver
    under a seeded fault-injection plan, for chaos drills; never set in
    production."""
    import os

    parser.add_argument(
        "--fault-plan",
        default=os.environ.get("PHOTON_FAULT_PLAN") or None,
        help="JSON FaultPlan file (photon_tpu_torch.faults): inject seeded "
             "faults (I/O errors, preemptions, device loss, OOM) at the "
             "hook points to rehearse recovery (default: $PHOTON_FAULT_PLAN)")


class enable_fault_plan:
    """Install the plan file ``path`` (no-op if falsy). As a context
    manager (``with enable_fault_plan(path) as injector:``, ``injector``
    None without a plan) the plan is the run's only: the plan active
    before comes back on exit. Called bare, as the router and control
    drivers (copies of the JAX drivers) call it, the plan stays installed
    for the process, as the JAX package's ``enable_fault_plan`` leaves
    it."""

    def __init__(self, path):
        self.injector = None
        self._scope = None
        if not path:
            return
        import logging

        from photon_tpu_torch.faults import FaultPlan, active_plan

        self._scope = active_plan(FaultPlan.from_file(path))
        self.injector = self._scope.__enter__()
        logging.getLogger("photon_tpu_torch.faults").warning(
            "FAULT INJECTION ACTIVE: plan %s (chaos drill, not production)",
            path)

    def __enter__(self):
        return self.injector

    def __exit__(self, *exc) -> bool:
        if self._scope is not None:
            self._scope.__exit__(None, None, None)
            self._scope = None
        return False


def add_trace_flag(parser) -> None:
    """``--trace-out`` (default ``$PHOTON_TRACE_OUT``): write the run's
    spans (ingest blocks and chunks, coordinate steps, optimizer solves,
    injected faults, recovery events) as Chrome trace-event JSON, loadable
    in Perfetto."""
    import os

    parser.add_argument(
        "--trace-out",
        default=os.environ.get("PHOTON_TRACE_OUT") or None,
        help="write an end-to-end Chrome trace-event JSON timeline of this "
             "run to this file (open in https://ui.perfetto.dev; "
             "default: $PHOTON_TRACE_OUT)")


def enable_trace(path) -> None:
    """Install the process-wide trace collector (no-op if falsy); pair
    with :func:`finish_trace` in a ``finally``."""
    if not path:
        return
    from photon_tpu_torch.obs import start_tracing

    start_tracing()


def finish_trace(path) -> None:
    """Write and uninstall the collector of :func:`enable_trace` (no-op if
    falsy). Runs in the driver's ``finally``: a failed run still leaves
    its timeline."""
    if not path:
        return
    import logging

    from photon_tpu_torch.obs import stop_tracing

    col = stop_tracing(path)
    if col is not None:
        logging.getLogger("photon_tpu_torch.obs").info(
            "trace written: %s (%d events%s)", path, len(col.events),
            f", {col.dropped} dropped" if col.dropped else "",
        )


def add_telemetry_flag(parser) -> None:
    """``--telemetry-dir`` (default ``$PHOTON_TELEMETRY_DIR``): every
    process of one run points here and writes its trace shard
    (``trace.<role>.<pid>.json``) and metrics-registry shard
    (``registry.<role>.<pid>.json``);
    ``python -m photon_tpu_torch.obs.analysis report <dir>`` fuses them
    into one merged timeline and run report."""
    import os

    parser.add_argument(
        "--telemetry-dir",
        default=os.environ.get("PHOTON_TELEMETRY_DIR") or None,
        help="shared fleet-telemetry directory: this process writes its "
             "trace shard and metrics-registry shard here, mergeable "
             "across processes by `python -m photon_tpu_torch.obs.analysis "
             "report` (default: $PHOTON_TELEMETRY_DIR)")


def enable_telemetry(args, role: str):
    """Stamp this process's ``role`` (carried by every trace anchor) and,
    under ``--telemetry-dir``, default ``--trace-out`` to the shard layout.
    Returns the telemetry directory (or None). Call before
    :func:`enable_trace`: the anchor is stamped at collector install."""
    import os

    from photon_tpu_torch.obs import trace

    trace.set_process_role(role)
    d = getattr(args, "telemetry_dir", None)
    if not d:
        return None
    os.makedirs(d, exist_ok=True)
    if getattr(args, "trace_out", None) is None:
        args.trace_out = os.path.join(
            d, f"trace.{role}.{os.getpid()}.json")
    return d


def finish_telemetry(args, registries=()) -> None:
    """Export this process's metrics-registry shard into the telemetry
    directory (no-op without ``--telemetry-dir``). Runs in the driver's
    ``finally``; best-effort: telemetry is evidence, never a new failure
    mode."""
    d = getattr(args, "telemetry_dir", None)
    if not d:
        return
    import logging
    import os

    from photon_tpu_torch.obs import fleet, trace

    path = os.path.join(
        d, f"registry.{trace.process_role()}.{os.getpid()}.json")
    try:
        fleet.write_registry_shard(path, registries=list(registries))
    except Exception as e:  # noqa: BLE001 - evidence, never a failure mode
        logging.getLogger("photon_tpu_torch.obs").warning(
            "registry shard export failed (%s): %s", path, e)


def add_profile_flag(parser) -> None:
    """``--profile-dir``: profile the run with ``torch.profiler`` (CPU and,
    on ``cuda``, CUDA activities) into one Chrome-trace file there."""
    parser.add_argument(
        "--profile-dir", default=None,
        help="write a torch.profiler Chrome trace of the run (host ops and, "
             "on cuda, the device's kernels and copies) into this directory; "
             "training-summary.json names the file")


class profiling:
    """``with profiling(directory, device) as prof:`` runs ``torch.profiler``
    over the block and writes ``<directory>/profile.<pid>.json`` on exit,
    also when the block raises (``prof.path`` names it). On ``cuda`` the
    CUDA activity is part of the request: a profiler that cannot start
    raises, so a run asked to be profiled never runs unprofiled. No-op
    (``prof.path`` None) when ``directory`` is falsy."""

    def __init__(self, directory, device):
        self.directory = directory
        self.device = device
        self.path = None
        self._prof = None

    def __enter__(self) -> "profiling":
        if not self.directory:
            return self
        import os

        import torch.profiler as tp

        os.makedirs(self.directory, exist_ok=True)
        activities = [tp.ProfilerActivity.CPU]
        if getattr(self.device, "type", self.device) == "cuda":
            if tp.ProfilerActivity.CUDA not in tp.supported_activities():
                raise RuntimeError(
                    "--profile-dir on cuda: this torch build's profiler "
                    "cannot record CUDA activity")
            activities.append(tp.ProfilerActivity.CUDA)
        self._prof = tp.profile(activities=activities)
        self._prof.__enter__()
        self.path = os.path.join(self.directory,
                                 f"profile.{os.getpid()}.json")
        return self

    def __exit__(self, *exc) -> None:
        prof, self._prof = self._prof, None
        if prof is None:
            return
        import logging

        prof.__exit__(None, None, None)
        prof.export_chrome_trace(self.path)
        logging.getLogger("photon_tpu_torch.obs").info(
            "profile written: %s", self.path)


def profile_range(name: str, active: bool):
    """A ``torch.profiler.record_function`` range named ``name`` when
    ``active`` (a profiled run), so that the profile marks the stage's
    window; a no-op context otherwise."""
    if not active:
        return contextlib.nullcontext()
    import torch.profiler

    return torch.profiler.record_function(name)
