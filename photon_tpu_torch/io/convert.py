"""Carry a GAME model across from the JAX package as numpy arrays.

The port imports nothing of the JAX package, so a model crosses over as a
plain dict of numpy arrays (the exporter from a JAX ``GameModel`` lives in
the tests). Per coordinate id, the spec holds:

* fixed effect: ``{"type": "fixed", "feature_shard", "task", "means" [D],
  "variances" [D] | None}``;
* random effect: ``{"type": "random", "re_type", "task", "global_dim",
  "entity_keys", "bucket_coefs" [[E, P], ...], "bucket_proj" [[E, P], ...],
  "bucket_entity_ids" [[E], ...], "bucket_variances" [[E, P], ...] | None}``
  — the fields of ``RandomEffectModel``. Each entity's slot is recovered from
  ``bucket_entity_ids`` (padding lanes carry -1).

``task`` is a ``TaskType`` value string.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from photon_tpu_torch.game.coordinates import FixedEffectModel
from photon_tpu_torch.game.descent import GameModel
from photon_tpu_torch.game.random_effect import RandomEffectModel
from photon_tpu_torch.models.coefficients import Coefficients
from photon_tpu_torch.models.glm import GeneralizedLinearModel
from photon_tpu_torch.types import TaskType


def game_model_from_numpy(
    spec: Mapping[str, Mapping], device: torch.device, dtype: torch.dtype
) -> GameModel:
    """Build a port ``GameModel`` with float arrays in ``dtype`` on
    ``device`` and index arrays as int32."""

    def floats(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)

    def ints(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.int32)).to(device)

    models = {}
    for cid, c in spec.items():
        task = TaskType(c["task"])
        if c["type"] == "fixed":
            var = c.get("variances")
            coefs = Coefficients(
                means=floats(c["means"]),
                variances=None if var is None else floats(var),
            )
            models[cid] = FixedEffectModel(
                GeneralizedLinearModel(coefs, task), c["feature_shard"]
            )
        elif c["type"] == "random":
            entity_ids = [np.asarray(e, np.int64) for e in c["bucket_entity_ids"]]
            entity_to_slot = {
                int(dense): (b, lane)
                for b, ids in enumerate(entity_ids)
                for lane, dense in enumerate(ids)
                if dense >= 0
            }
            var = c.get("bucket_variances")
            models[cid] = RandomEffectModel(
                re_type=c["re_type"],
                task=task,
                bucket_coefs=[floats(a) for a in c["bucket_coefs"]],
                bucket_proj=[ints(a) for a in c["bucket_proj"]],
                bucket_entity_ids=[ints(a) for a in entity_ids],
                entity_keys=list(c["entity_keys"]),
                entity_to_slot=entity_to_slot,
                global_dim=int(c["global_dim"]),
                bucket_variances=(
                    None if var is None else [floats(a) for a in var]
                ),
            )
        else:
            raise ValueError(f"{cid}: unknown coordinate type {c['type']!r}")
    return GameModel(models)
