"""Down-sampling for class imbalance, per coordinate.

Port of ``photon_tpu/data/sampling.py``. A coordinate may train on a
down-sampled copy of its data: a dropped row gets weight 0 (the padded-row
convention of ``LabeledBatch``: it does not exist for the loss, gradient or
Hessian) and a kept row's weight is rescaled by 1/rate so the objective
stays an unbiased estimate. The binary-classification sampler keeps every
positive and down-samples only the negatives. ``compact`` repacks the kept
rows into a smaller batch on the host.

The keep draws are ``utils/threefry.py``'s, bit-equal to the JAX package's
``jax.random.uniform``, in the weights' float dtype (the JAX driver draws in
float64 exactly when it trains in float64), so both packages keep the same
rows.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_tpu_torch.data.batch import DenseFeatures, LabeledBatch, SparseFeatures
from photon_tpu_torch.data.random_effect import numpy_dtype
from photon_tpu_torch.types import TaskType
from photon_tpu_torch.utils import threefry

Tensor = torch.Tensor


def _keep_draw(key: np.ndarray, rate: float, like: Tensor) -> Tensor:
    """u < rate for u = ``uniform(key, like.shape)`` in ``like``'s dtype,
    on ``like``'s device."""
    dt = numpy_dtype(like.dtype)
    u = threefry.uniform(key, tuple(like.shape), dt)
    return torch.from_numpy(u < dt.type(rate)).to(like.device)


@dataclasses.dataclass(frozen=True)
class DownSampler:
    """Uniform down-sampling at ``rate`` ∈ (0, 1]; weights rescaled by
    1/rate."""

    rate: float

    def __post_init__(self):
        if not (0.0 < self.rate <= 1.0):
            raise ValueError(f"down-sampling rate must be in (0, 1], got {self.rate}")

    def down_sample_weights(self, key: np.ndarray, labels: Tensor,
                            weights: Tensor) -> Tensor:
        """Weights of any shape: dropped rows 0, kept rows rescaled (the
        fixed-effect batch and the per-entity training weights alike)."""
        keep = _keep_draw(key, self.rate, weights)
        # a Python scalar operand is cast to the weights' dtype first, as
        # in jnp
        return torch.where(keep, weights / self.rate, 0.0)

    def down_sample(self, key: np.ndarray, batch: LabeledBatch) -> LabeledBatch:
        return dataclasses.replace(
            batch, weights=self.down_sample_weights(key, batch.labels, batch.weights))


@dataclasses.dataclass(frozen=True)
class BinaryClassificationDownSampler(DownSampler):
    """Keeps every positive; down-samples negatives at ``rate``, the kept
    ones re-weighted by 1/rate."""

    def down_sample_weights(self, key: np.ndarray, labels: Tensor,
                            weights: Tensor) -> Tensor:
        is_pos = labels > 0
        keep = is_pos | _keep_draw(key, self.rate, weights)
        scale = torch.where(is_pos, 1.0, torch.full_like(weights, 1.0 / self.rate))
        return torch.where(keep, weights * scale, 0.0)


def down_sampler_for_task(task: TaskType, rate: float) -> DownSampler:
    """Binary tasks get the class-aware sampler, every other task the
    uniform one."""
    if task in (TaskType.LOGISTIC_REGRESSION,
                TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM):
        return BinaryClassificationDownSampler(rate)
    return DownSampler(rate)


def compact(batch: LabeledBatch, row_multiple: int = 128) -> LabeledBatch:
    """Host-side repack: the rows of nonzero weight, padded with weight-0
    rows (ghost columns for sparse features) up to a multiple of
    ``row_multiple``; on the batch's device."""
    w = batch.weights.detach().cpu().numpy()
    keep = np.nonzero(w != 0)[0]
    n = max(int(len(keep)), 1)
    total = n + (-n % row_multiple)
    dev = batch.weights.device

    def take(t: Tensor, fill=0) -> Tensor:
        a = t.detach().cpu().numpy()
        out = np.full((total,) + a.shape[1:], fill, a.dtype)
        out[: len(keep)] = a[keep]
        return torch.from_numpy(out).to(dev)

    feats = batch.features
    if isinstance(feats, DenseFeatures):
        new_feats = DenseFeatures(take(feats.x))
    elif isinstance(feats, SparseFeatures):
        new_feats = SparseFeatures(idx=take(feats.idx, feats.dim),
                                   val=take(feats.val), dim=feats.dim)
    else:
        raise TypeError(f"unknown feature container {type(feats).__name__}")
    return LabeledBatch(features=new_feats, labels=take(batch.labels),
                        offsets=take(batch.offsets), weights=take(batch.weights))
