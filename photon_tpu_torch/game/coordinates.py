"""GAME coordinate models.

Port of ``photon_tpu/game/coordinates.py``: ``FixedEffectModel``, the
trainable ``FixedEffectCoordinate`` and ``RandomEffectCoordinate`` on one
device, with the device sweep cache's hook (no mesh, no feature-sharded
model axis; the factored random effect comes with a later slice). A coordinate owns its
training data, its problem and its shard's normalization context (None
without one) and exposes ``train(offsets, init) -> (model, result)`` and
``score(model) -> [N]``; offsets are per-row tensors in the global sample
order, so residuals are elementwise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

from photon_tpu_torch.data.batch import LabeledBatch
from photon_tpu_torch.data.normalization import NormalizationContext
from photon_tpu_torch.data.random_effect import RandomEffectDataset
from photon_tpu_torch.functions.prior import PriorDistribution
from photon_tpu_torch.functions.problem import GLMOptimizationProblem
from photon_tpu_torch.game.random_effect import (
    RandomEffectModel,
    train_random_effects,
)
from photon_tpu_torch.models.glm import GeneralizedLinearModel
from photon_tpu_torch.optim import OptimizerResult

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FixedEffectModel:
    """Population-level GLM for one feature shard."""

    model: GeneralizedLinearModel
    feature_shard: str

    def score_batch(self, batch: LabeledBatch) -> Tensor:
        """Raw per-row scores WITHOUT offsets (GAME sums coordinate scores)."""
        return batch.features.matvec(self.model.coefficients.means)


@dataclasses.dataclass(frozen=True)
class FixedEffectCoordinate:
    """Train one GLM on all rows of the batch (whose offsets field is
    replaced per ``train`` call)."""

    batch: LabeledBatch
    problem: GLMOptimizationProblem
    feature_shard: str = "global"
    normalization: Optional[NormalizationContext] = None

    def train(
        self, offsets: Tensor, init: Optional[FixedEffectModel] = None
    ) -> tuple[FixedEffectModel, OptimizerResult]:
        batch = self.batch.with_offsets(offsets.to(self.batch.labels.dtype))
        if init is not None:
            w0 = init.model.coefficients.means
        else:
            w0 = torch.zeros(batch.dim, dtype=batch.labels.dtype,
                             device=batch.labels.device)
        model, result = self.problem.fit(batch, w0,
                                         normalization=self.normalization)
        return FixedEffectModel(model, self.feature_shard), result

    def score(self, model: FixedEffectModel) -> Tensor:
        return model.score_batch(self.batch)


@dataclasses.dataclass(frozen=True)
class RandomEffectCoordinate:
    """Per-entity GLMs over a ``RandomEffectDataset``. ``train`` returns the
    model and the per-bucket results (per-lane tensors)."""

    dataset: RandomEffectDataset
    problem: GLMOptimizationProblem
    global_reg_mask: Optional[Tensor] = None
    normalization: Optional[NormalizationContext] = None
    # Per-bucket priors for incremental training
    # (RandomEffectModel.project_prior_to).
    priors: Optional[Sequence[PriorDistribution]] = None
    # Device sweep cache (data/device_cache.py): a host-resident dataset is
    # pinned on the device at first touch, so later sweeps (train and
    # score) stop uploading it bucket by bucket. Its mirror is the same
    # object every sweep, so _same_structure keeps holding.
    device_cache: Optional[object] = None

    def _data(self) -> RandomEffectDataset:
        """The dataset every train and score reads: the cache's device
        mirror when a cache holds it, else the dataset itself."""
        if self.device_cache is None:
            return self.dataset
        return self.device_cache.dataset_mirror(self.dataset)

    def _same_structure(self, model: RandomEffectModel) -> bool:
        # A model trained on THIS dataset (every coordinate-descent sweep)
        # shares its projections by identity; anything else (a loaded
        # model, a model of other data) is re-projected.
        dataset = self._data()
        return len(model.bucket_coefs) == len(dataset.buckets) and all(
            p is b.proj for p, b in zip(model.bucket_proj, dataset.buckets)
        )

    def adopt(self, model: RandomEffectModel) -> RandomEffectModel:
        """``model`` with this dataset's own structure tensors in place of
        equal copies (a model restored from a checkpoint), so it scores by
        the same path as the model the run trained; else ``model``."""
        dataset = self._data()
        if len(model.bucket_proj) != len(dataset.buckets) or not all(
                torch.equal(p.to(b.proj.device), b.proj)
                for p, b in zip(model.bucket_proj, dataset.buckets)):
            return model
        return dataclasses.replace(
            model,
            bucket_proj=[b.proj for b in dataset.buckets],
            bucket_entity_ids=[b.entity_ids for b in dataset.buckets],
            entity_keys=dataset.entity_keys,
            entity_to_slot=dataset.entity_to_slot,
        )

    def _init_coefs(self, init: Optional[RandomEffectModel]):
        if init is None:
            return None
        return (init.bucket_coefs if self._same_structure(init)
                else init.project_to(self._data()))

    def train(self, offsets: Tensor, init: Optional[RandomEffectModel] = None):
        return train_random_effects(
            self.problem, self._data(), offsets,
            global_reg_mask=self.global_reg_mask,
            init_coefs=self._init_coefs(init),
            normalization=self.normalization,
            priors=self.priors,
        )

    def score(self, model: RandomEffectModel) -> Tensor:
        dataset = self._data()
        if self._same_structure(model):
            return model.score_dataset(dataset)
        # A foreign model (loaded warm start or locked coordinate) is
        # projected into this dataset's structure first.
        return model.score_new_dataset(dataset)


Coordinate = Union[FixedEffectCoordinate, RandomEffectCoordinate]
DatumScoringModel = Union[FixedEffectModel, RandomEffectModel]
