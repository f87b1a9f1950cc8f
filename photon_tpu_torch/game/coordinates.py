"""GAME coordinate models.

Port of ``photon_tpu/game/coordinates.py``: ``FixedEffectModel``, the
trainable ``FixedEffectCoordinate``, ``RandomEffectCoordinate`` (with the
device sweep cache's hook) and ``FactoredRandomEffectCoordinate``. With a
``mesh`` the fixed effect trains data-parallel (``parallel/data_parallel``:
its batch cut into row shards once, the offsets re-cut each step) and the
random effect entity-sharded; with a ``model_axis`` too the fixed effect
trains feature-sharded (``parallel/model_parallel``); the factored random
effect trains on one device, as in the JAX package. A coordinate owns its
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
from photon_tpu_torch.game.factored_random_effect import (
    FactoredRandomEffectModel,
    train_factored_random_effects,
)
from photon_tpu_torch.game.random_effect import (
    RandomEffectModel,
    train_random_effects,
)
from photon_tpu_torch.models.glm import GeneralizedLinearModel
from photon_tpu_torch.obs import trace_span, tracing_active
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
    mesh: Optional[object] = None
    data_axis: object = "data"
    # With a mesh that has this axis, the coefficients, gradient and
    # optimizer state shard over it: the feature-sharded path for very
    # wide feature spaces.
    model_axis: Optional[str] = None

    def train(
        self, offsets: Tensor, init: Optional[FixedEffectModel] = None
    ) -> tuple[FixedEffectModel, OptimizerResult]:
        batch = self.batch.with_offsets(offsets.to(self.batch.labels.dtype))
        if init is not None:
            w0 = init.model.coefficients.means
        else:
            w0 = torch.zeros(batch.dim, dtype=batch.labels.dtype,
                             device=batch.labels.device)
        with trace_span("optim.fixed_solve", cat="optim",
                        shard=self.feature_shard, rows=batch.n_rows,
                        dim=batch.dim) as sp:
            if self.mesh is not None and self.model_axis is not None:
                from photon_tpu_torch.parallel.model_parallel import (
                    fit_model_parallel,
                )

                model, result = fit_model_parallel(
                    self.problem, batch, w0, self.mesh, self.data_axis,
                    self.model_axis, normalization=self.normalization)
            elif self.mesh is not None:
                from photon_tpu_torch.parallel.data_parallel import (
                    fit_data_parallel,
                )
                from photon_tpu_torch.parallel.mesh import cached_row_shards

                shards = cached_row_shards(self.batch, self.mesh, self.data_axis)
                model, result = fit_data_parallel(
                    self.problem, shards.with_offsets(batch.offsets), w0,
                    self.mesh, self.data_axis, normalization=self.normalization)
            else:
                model, result = self.problem.fit(
                    batch, w0, normalization=self.normalization)
            if tracing_active():
                # A single solve's iterations and reason are host scalars
                # already: the span adds no fetch.
                sp.set(iterations=int(result.iterations),
                       reason=result.reason_name())
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
    mesh: Optional[object] = None
    entity_axis: object = "data"

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
        return adopt_structure(model, self._data())

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
            mesh=self.mesh,
            entity_axis=self.entity_axis,
        )

    def score(self, model: RandomEffectModel) -> Tensor:
        dataset = self._data()
        if self._same_structure(model):
            return model.score_dataset(dataset)
        # A foreign model (loaded warm start or locked coordinate) is
        # projected into this dataset's structure first.
        return model.score_new_dataset(dataset)


def adopt_structure(model: RandomEffectModel,
                    dataset: RandomEffectDataset) -> RandomEffectModel:
    """``model`` with ``dataset``'s own structure tensors in place of equal
    copies, when its projections equal the dataset's; else ``model``."""
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


@dataclasses.dataclass(frozen=True)
class FactoredRandomEffectCoordinate:
    """Per-entity models in a learned latent space
    (``game/factored_random_effect.py``). ``train`` returns the model and
    the final latent step's per-bucket results."""

    dataset: RandomEffectDataset
    problem: GLMOptimizationProblem
    latent_dim: int = 8
    n_alternations: int = 2
    seed: int = 0

    def train(self, offsets: Tensor, init=None):
        # A loaded warm start arrives as the saved EFFECTIVE RandomEffectModel:
        # train_factored_random_effects re-factors it spectrally (the
        # effective matrix is exactly rank-p).
        if not isinstance(init, (FactoredRandomEffectModel, RandomEffectModel)):
            init = None
        return train_factored_random_effects(
            self.problem, self.dataset, offsets,
            latent_dim=self.latent_dim,
            n_alternations=self.n_alternations,
            seed=self.seed,
            init=init,
        )

    def adopt(self, model):
        """A restored factored model whose effective model shares this
        dataset's structure tensors (``adopt_structure``), so a resumed run
        scores it as the uninterrupted run scored the live model."""
        if isinstance(model, FactoredRandomEffectModel):
            return dataclasses.replace(
                model, effective=adopt_structure(model.effective, self.dataset))
        return model

    def score(self, model) -> Tensor:
        # Through the effective per-entity model; a foreign model (a loaded
        # warm start or a locked coordinate, possibly a plain
        # RandomEffectModel) is projected into this dataset's structure.
        eff = getattr(model, "effective", model)
        same = len(eff.bucket_proj) == len(self.dataset.buckets) and all(
            p is b.proj for p, b in zip(eff.bucket_proj, self.dataset.buckets))
        return (eff.score_dataset(self.dataset) if same
                else eff.score_new_dataset(self.dataset))


Coordinate = Union[FixedEffectCoordinate, RandomEffectCoordinate,
                   FactoredRandomEffectCoordinate]
DatumScoringModel = Union[FixedEffectModel, RandomEffectModel,
                          FactoredRandomEffectModel]
