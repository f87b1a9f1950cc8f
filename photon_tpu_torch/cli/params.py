"""CLI parameter parsing for the GAME training driver.

Port of the parts of ``photon_tpu/cli/params.py`` that the training
driver needs: the coordinate mini-DSL (``parse_coordinate_spec``,
``parse_coordinates``), the sweep expansion (``configs_from_specs``),
``parse_feature_shard`` and the random-effect routing flags
(``add_re_routing_flags``, ``enable_re_routing``).

Coordinate spec (one ``--coordinate`` flag per coordinate):

    <cid>:<k>=<v>,<k>=<v>,...

keys: ``type`` fixed|random (required); ``shard`` feature shard id;
``re_type`` entity id column (random, required); ``active_bound`` int;
``min_rows`` int; ``max_features`` int (Pearson filter);
``max_bucket_entities`` int; ``host_resident`` 0|1 (buckets kept on the
host for the device sweep cache); ``optimizer`` LBFGS|OWLQN|TRON; ``max_iter``
int; ``tol`` float; ``reg`` NONE|L1|L2|ELASTIC_NET; ``alpha`` elastic-net α;
``reg_weights`` '|'-separated floats (sweep, default 0); ``downsample``
rate in (0, 1]; ``variance`` NONE|SIMPLE|FULL; ``incremental`` prior weight
for incremental training from --model-input-dir. The JAX package's
``type=factored`` (with ``latent`` / ``alternations``) belongs to a later
slice of the port and raises ``NotImplementedError`` naming it; its keys
are still recognized.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from photon_tpu_torch.estimators.config import (
    CoordinateDataConfig,
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
    if ctype == "factored":
        raise NotImplementedError(
            f"coordinate {cid!r}: type=factored is not in the port yet "
            "(factored random effects come with the factored-random-effect "
            "slice, M12)"
        )
    if ctype == "fixed":
        for k in _RANDOM_ONLY:
            if k in kv:
                raise ValueError(f"coordinate {cid!r}: {k} is random-effect only")
        data: CoordinateDataConfig = FixedEffectDataConfig(feature_shard=shard)
    else:
        if "re_type" not in kv:
            raise ValueError(f"coordinate {cid!r}: random effects need re_type")
        if "latent" in kv or "alternations" in kv:
            raise ValueError(
                f"coordinate {cid!r}: latent/alternations need type=factored")
        data = RandomEffectDataConfig(
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
