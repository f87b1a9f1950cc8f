"""GameTransformer: score a dataset with a trained GameModel.

Port of ``photon_tpu/estimators/game_transformer.py`` (``transform``,
``transform_and_evaluate`` and ``evaluate_scored_arrays``, without a mesh;
``transform_rows`` and the shared ``additive_score_rows`` program come with
the serving slice). Per
coordinate, the data is scored and the scores summed additively; rows whose
entity was unseen at training fall back to the zero model.

Fixed-effect scoring is one sparse matvec on the whole batch — on CUDA the
``ell_panel_matvec`` kernel over the attached panel layout (``ell_matvec``
where the layout does not pay). Random-effect scoring projects the trained
per-entity coefficients into the scoring dataset's bucket structure on the
host, then scores each bucket with one batched gather-dot.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from photon_tpu_torch.estimators.config import (
    CoordinateDataConfig,
    FixedEffectDataConfig,
    RandomEffectDataConfig,
)
from photon_tpu_torch.estimators.game_estimator import (
    _factorize_group_ids,
    build_re_dataset_from_bundle,
)
from photon_tpu_torch.evaluation import EvaluationResults, EvaluationSuite
from photon_tpu_torch.game.coordinates import FixedEffectModel
from photon_tpu_torch.game.descent import GameModel
from photon_tpu_torch.game.random_effect import RandomEffectModel
from photon_tpu_torch.io.data_reader import GameDataBundle

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GameTransformer:
    """Bind a trained model to the per-coordinate data configs it was
    trained with (shard names + entity columns)."""

    model: GameModel
    coordinate_data_configs: Mapping[str, CoordinateDataConfig]
    intercept_indices: Optional[Mapping[str, int]] = None

    def _intercept_for(self, shard: str) -> Optional[int]:
        if self.intercept_indices is None:
            return None
        return self.intercept_indices.get(shard)

    def _score_fixed(self, m: FixedEffectModel, batch) -> Tensor:
        # Scoring runs one matvec, so only its layout attaches: on CUDA the
        # panel layout of ell_panel_matvec (see SparseFeatures). The
        # transposes' CSC layout is for training.
        feats = batch.features.with_matvec_layout()
        return feats.matvec(m.model.coefficients.means)

    def transform(self, data: GameDataBundle) -> Tensor:
        """Total additive score per row: offsets + Σ coordinate scores, on
        the device the bundle's features live on. Offsets enter as float32,
        as in the JAX transformer."""
        total = torch.as_tensor(data.offsets, dtype=torch.float32).to(data.device)
        for cid in self.model.keys():
            dcfg = self.coordinate_data_configs.get(cid)
            if dcfg is None:
                raise ValueError(
                    f"model coordinate {cid!r} has no data config; "
                    f"configs cover {sorted(self.coordinate_data_configs)}"
                )
            m = self.model[cid]
            if isinstance(dcfg, FixedEffectDataConfig):
                if not isinstance(m, FixedEffectModel):
                    raise TypeError(f"{cid!r}: fixed-effect config, {type(m)} model")
                total = total + self._score_fixed(
                    m, data.batch(dcfg.feature_shard)
                )
            elif isinstance(dcfg, RandomEffectDataConfig):
                if not isinstance(m, RandomEffectModel):
                    raise TypeError(f"{cid!r}: random-effect config, {type(m)} model")
                ds = build_re_dataset_from_bundle(
                    data, dcfg, self._intercept_for(dcfg.feature_shard),
                    for_scoring=True,
                )
                total = total + m.score_new_dataset(ds)
            else:  # pragma: no cover - union is closed
                raise TypeError(f"unknown data config {type(dcfg)}")
        return total

    def transform_and_evaluate(
        self, data: GameDataBundle, suite: EvaluationSuite
    ) -> tuple[Tensor, EvaluationResults]:
        """Score, then evaluate the scores with the suite (the scoring
        driver's ``--evaluators``)."""
        scores = self.transform(data)
        return scores, evaluate_scored_arrays(
            suite, scores, data.labels, data.weights, data.id_tags)


def evaluate_scored_arrays(suite: EvaluationSuite, scores: Tensor, labels,
                           weights, id_tags: Mapping,
                           factorized: Optional[Mapping] = None) -> EvaluationResults:
    """Evaluate precomputed scores: factorize each grouped evaluator's id
    column, cast to float32 on the scores' device, run the suite.
    ``factorized`` maps a group column to ``(codes, n_groups)`` already
    dense (the chunked scoring driver encodes them chunk by chunk)."""
    dev = scores.device
    gids, ngroups = {}, {}
    for col in {ev.group_column for ev in suite.evaluators if ev.group_column}:
        if factorized is not None and col in factorized:
            codes, n = factorized[col]
            gids[col] = torch.from_numpy(np.asarray(codes, np.int32)).to(dev)
            ngroups[col] = int(n)
        elif col not in id_tags:
            raise ValueError(f"grouped evaluator needs id column {col!r}")
        else:
            gids[col], ngroups[col] = _factorize_group_ids(id_tags[col], dev)

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

    return suite.evaluate(scores.to(torch.float32), f32(labels), f32(weights),
                          gids or None, ngroups or None)
