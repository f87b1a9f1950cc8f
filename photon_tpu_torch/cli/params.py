"""CLI parameter parsing for the GAME training driver.

Port of the parts of ``photon_tpu/cli/params.py`` that the training
drivers need: the coordinate mini-DSL (``parse_coordinate_spec``,
``parse_coordinates``), the sweep expansion (``configs_from_specs``),
``parse_feature_shard``, the random-effect routing flags
(``add_re_routing_flags``, ``enable_re_routing``), the runtime guards'
flags (``add_backend_policy_flag``, ``enable_backend_guard``,
``console_main``, ``add_fault_plan_flag``, ``enable_fault_plan``) and the
one table of the JAX drivers' flags that the port refuses
(``refuse_unported``).

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
from typing import Sequence

from photon_tpu_torch.estimators.config import (
    CoordinateDataConfig,
    FactoredRandomEffectDataConfig,
    FixedEffectDataConfig,
    GLMOptimizationConfiguration,
    RandomEffectDataConfig,
    reg_weight_sweep,
)
from photon_tpu_torch.functions.problem import VarianceComputationType
from photon_tpu_torch.optim import OptimizerType
from photon_tpu_torch.optim.regularization import (
    RegularizationContext,
    RegularizationType,
    elastic_net_context,
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


# Why a flag of the JAX drivers is refused: the same words in every driver.
OBSERVABILITY_SLICE = "comes with the observability slice"
MULTI_GPU_SLICE = "comes with the multi-GPU slice (M14)"
NO_COMPILED_PROGRAMS = (
    "refused for good: the port compiles no XLA programs (its kernels build "
    "once per source into photon_tpu_torch/_build/), so there is nothing to "
    "cache, store or clear")


def refuse_unported(parser, args, table) -> None:
    """``parser.error`` (exit 2, before any work) for the first flag of
    ``table`` that is set. ``table`` holds ``(flag, is_set(args), why)``:
    ``why`` is either a later slice's words (``OBSERVABILITY_SLICE``,
    ``MULTI_GPU_SLICE``, after the feature's name) or
    ``NO_COMPILED_PROGRAMS``. A refused flag is never ignored."""
    for flag, is_set, why in table:
        if is_set(args):
            if why == NO_COMPILED_PROGRAMS:
                parser.error(f"{flag}: {why}")
            parser.error(f"{flag}: not in the port yet; {why}")


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


@contextlib.contextmanager
def enable_fault_plan(path):
    """``with enable_fault_plan(path) as injector:`` installs the plan file
    for the run (``injector`` None without one) and restores the plan
    active before on exit."""
    if not path:
        yield None
        return
    import logging

    from photon_tpu_torch.faults import FaultPlan, active_plan

    with active_plan(FaultPlan.from_file(path)) as injector:
        logging.getLogger("photon_tpu_torch.faults").warning(
            "FAULT INJECTION ACTIVE: plan %s (chaos drill, not production)",
            path)
        yield injector
