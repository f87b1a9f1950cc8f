"""Per-coordinate data configurations.

Port of ``photon_tpu/estimators/config.py`` (``FixedEffectDataConfig`` and
``RandomEffectDataConfig``; the optimization configurations come with the
training slice).
"""
from __future__ import annotations

import dataclasses
from typing import Union


@dataclasses.dataclass(frozen=True)
class FixedEffectDataConfig:
    """One population-level GLM on every row of one feature shard."""

    feature_shard: str = "global"


@dataclasses.dataclass(frozen=True)
class RandomEffectDataConfig:
    """Per-entity GLMs grouped by an id column. (The training fields of the
    JAX config — active bound, minimum rows, Pearson filter, bucket caps —
    come with the training slice.)"""

    re_type: str
    feature_shard: str = "global"


CoordinateDataConfig = Union[FixedEffectDataConfig, RandomEffectDataConfig]
