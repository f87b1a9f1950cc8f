"""Dataset preparation shared by the estimator and the transformer.

Port of ``photon_tpu/estimators/game_estimator.py``
(``build_re_dataset_from_bundle``; the estimator itself comes with the
training slice).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from photon_tpu_torch.data.random_effect import (
    RandomEffectDataset,
    build_random_effect_dataset,
)
from photon_tpu_torch.estimators.config import RandomEffectDataConfig
from photon_tpu_torch.io.data_reader import GameDataBundle


def build_re_dataset_from_bundle(
    bundle: GameDataBundle,
    cfg: RandomEffectDataConfig,
    intercept_index: Optional[int] = None,
) -> RandomEffectDataset:
    """Group a bundle's rows by ``cfg.re_type`` into a bucketed per-entity
    scoring dataset: every entity is kept (rows of entities unseen at
    training time score 0) and no active/passive split applies. The buckets
    follow the feature values' dtype and device. (The JAX function's
    training form — active bound, minimum rows, Pearson filter — comes with
    the training slice.)"""
    sf = bundle.features[cfg.feature_shard]
    if cfg.re_type not in bundle.id_tags:
        raise ValueError(
            f"random effect {cfg.re_type!r} needs id tag column "
            f"{cfg.re_type!r}; bundle has {sorted(bundle.id_tags)}"
        )
    return build_random_effect_dataset(
        re_type=cfg.re_type,
        entity_keys_per_row=bundle.id_tags[cfg.re_type],
        idx=sf.idx.detach().cpu().numpy(),
        val=sf.val.detach().cpu().numpy(),
        labels=np.asarray(bundle.labels),
        global_dim=sf.dim,
        weights=bundle.weights,
        intercept_index=intercept_index,
        dtype=sf.val.dtype,
        device=sf.device,
    )
