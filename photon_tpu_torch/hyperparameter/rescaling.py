"""Hyperparameter range definitions and [0,1]^d rescaling.

Copy of ``photon_tpu/hyperparameter/rescaling.py`` (numpy and scipy only, no
torch: the searches run on the host).

Parity: reference ⟦photon-lib/.../hyperparameter/VectorRescaling.scala,
HyperparameterSerialization.scala⟧ (SURVEY.md §2.1): search ranges declared
per parameter with linear or log scale, mapped to the unit cube for the GP
(kernel lengthscales are meaningful only on normalized axes), and back to
native units for evaluation. JSON (de)serialization of the range config.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class ParamRange:
    """One tunable parameter: name + [min, max] + scale ('linear'|'log')."""

    name: str
    min: float
    max: float
    scale: str = "linear"

    def __post_init__(self):
        if self.scale not in ("linear", "log"):
            raise ValueError(f"{self.name}: scale must be linear|log, got {self.scale}")
        if not (self.max > self.min):
            raise ValueError(f"{self.name}: need max > min")
        if self.scale == "log" and self.min <= 0:
            raise ValueError(f"{self.name}: log scale needs min > 0")


@dataclasses.dataclass(frozen=True)
class VectorRescaling:
    """Map native parameter vectors ↔ the unit cube."""

    ranges: Sequence[ParamRange]

    @property
    def dim(self) -> int:
        return len(self.ranges)

    @property
    def names(self) -> list[str]:
        return [r.name for r in self.ranges]

    def to_unit(self, x: np.ndarray) -> np.ndarray:
        x = np.atleast_2d(np.asarray(x, float))
        out = np.empty_like(x)
        for j, r in enumerate(self.ranges):
            if r.scale == "log":
                out[:, j] = (np.log(x[:, j]) - np.log(r.min)) / (
                    np.log(r.max) - np.log(r.min)
                )
            else:
                out[:, j] = (x[:, j] - r.min) / (r.max - r.min)
        return out

    def from_unit(self, u: np.ndarray) -> np.ndarray:
        u = np.clip(np.atleast_2d(np.asarray(u, float)), 0.0, 1.0)
        out = np.empty_like(u)
        for j, r in enumerate(self.ranges):
            if r.scale == "log":
                out[:, j] = np.exp(
                    np.log(r.min) + u[:, j] * (np.log(r.max) - np.log(r.min))
                )
            else:
                out[:, j] = r.min + u[:, j] * (r.max - r.min)
        return out

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """n native-unit samples uniform in the (scaled) cube."""
        return self.from_unit(rng.random((n, self.dim)))


def ranges_to_json(ranges: Sequence[ParamRange]) -> str:
    return json.dumps(
        {
            "variables": [
                {"name": r.name, "min": r.min, "max": r.max, "scale": r.scale}
                for r in ranges
            ]
        },
        indent=2,
    )


def ranges_from_json(text: str) -> list[ParamRange]:
    """Parse the reference-style JSON range config:
    {"variables": [{"name", "min", "max", "scale"?}, ...]}."""
    obj = json.loads(text)
    if "variables" not in obj:
        raise ValueError("hyperparameter config needs a 'variables' list")
    out = []
    for v in obj["variables"]:
        out.append(
            ParamRange(
                name=v["name"],
                min=float(v["min"]),
                max=float(v["max"]),
                scale=v.get("scale", "linear"),
            )
        )
    return out
