"""CLI parameter parsing for the GAME training driver.

Port of the parts of ``photon_tpu/cli/params.py`` that the fixed-effect
training driver needs: the coordinate mini-DSL (``parse_coordinate_spec``,
``parse_coordinates``), the sweep expansion (``configs_from_specs``) and
``parse_feature_shard``.

Coordinate spec (one ``--coordinate`` flag per coordinate):

    <cid>:<k>=<v>,<k>=<v>,...

keys: ``type`` fixed (required); ``shard`` feature shard id; ``optimizer``
LBFGS|OWLQN|TRON; ``max_iter`` int; ``tol`` float; ``reg``
NONE|L1|L2|ELASTIC_NET; ``alpha`` elastic-net α; ``reg_weights``
'|'-separated floats (sweep, default 0); ``downsample`` rate; ``variance``
NONE|SIMPLE|FULL; ``incremental`` prior weight for incremental training
from --model-input-dir. The JAX package's ``type=random`` / ``type=factored``
coordinates and a ``downsample`` below 1 belong to later slices of the port
and raise ``NotImplementedError``; their keys are still recognized.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from photon_tpu_torch.estimators.config import (
    CoordinateDataConfig,
    FixedEffectDataConfig,
    GLMOptimizationConfiguration,
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
    if ctype in ("random", "factored"):
        raise NotImplementedError(
            f"coordinate {cid!r}: type={ctype} is not in the port yet "
            "(random-effect training comes with the random-effect training "
            "slice, M5/M6)"
        )
    if ctype != "fixed":
        raise ValueError(
            f"coordinate {cid!r}: type must be 'fixed', 'random' or "
            f"'factored', got {ctype!r}"
        )
    for k in _RANDOM_ONLY:
        if k in kv:
            raise ValueError(f"coordinate {cid!r}: {k} is random-effect only")
    data = FixedEffectDataConfig(feature_shard=kv.get("shard", "global"))

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
    if opt.down_sampling_rate < 1.0:
        raise NotImplementedError(
            f"coordinate {cid!r}: downsample below 1 is not in the port yet "
            "(down-sampling comes with the data-preparation slice, M8)"
        )
    weights = tuple(
        float(w) for w in kv.get("reg_weights", "0").split("|") if w != ""
    )
    return CoordinateSpec(cid=cid, data=data, optimization=opt,
                          reg_weights=weights or (0.0,))


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
