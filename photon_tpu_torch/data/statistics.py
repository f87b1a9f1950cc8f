"""Per-feature summary statistics for normalization and the feature summary.

Port of ``photon_tpu/data/statistics.py``: mean, variance, min, max and
nonzero count per feature column over the rows with weight > 0 of one
feature shard. Sparse columns count their implicit zeros: a column with
fewer explicit nonzeros than rows also holds 0 for min / max, and the
variance is Bessel-corrected, as Spark's summarizer reports it.

Plain torch (the JAX package computes these with XLA, not Pallas). On a
sparse shard the column sums Σx and Σx² are the transposes Xᵀm and
(X∘X)ᵀm of the row mask m: the kernels ``csc_rmatvec`` / ``csc_sq_rmatvec``
on CUDA (the features' layouts are attached first), their plain versions on
the CPU, so the sums are the same from run to run. Counts add whole numbers
in float64 and min / max are ``scatter_reduce`` with ``amin`` / ``amax``:
exact in any order.
"""
from __future__ import annotations

import dataclasses

import torch

from photon_tpu_torch.data.batch import DenseFeatures, LabeledBatch, SparseFeatures

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FeatureDataStatistics:
    """Summary over one feature shard. All tensors are [D]; ``count`` is
    the number of rows with weight > 0 (a 0-dim float32 tensor)."""

    mean: Tensor
    variance: Tensor
    min: Tensor
    max: Tensor
    num_nonzeros: Tensor
    count: Tensor

    @property
    def dim(self) -> int:
        return self.mean.shape[-1]

    def std(self) -> Tensor:
        return torch.sqrt(torch.clamp(self.variance, min=0.0))

    def max_magnitude(self) -> Tensor:
        return torch.maximum(self.min.abs(), self.max.abs())


def compute_feature_statistics(batch: LabeledBatch) -> FeatureDataStatistics:
    """One-pass per-feature summary over the rows with weight > 0."""
    mask = (batch.weights > 0).to(torch.float32)
    n = mask.sum()
    n_safe = torch.clamp(n, min=1.0)
    feats = batch.features
    inf = float("inf")

    if isinstance(feats, DenseFeatures):
        on = mask[:, None] > 0
        x = feats.x * mask[:, None]
        s1 = x.sum(0)
        s2 = (x * x).sum(0)
        # Masked-out rows never win min / max; no rows at all reads 0.
        mn = torch.where(on, feats.x, inf).amin(0)
        mx = torch.where(on, feats.x, -inf).amax(0)
        mn = torch.where(torch.isinf(mn), 0.0, mn)
        mx = torch.where(torch.isinf(mx), 0.0, mx)
        nnz = ((feats.x != 0) & on).sum(0).to(torch.float32)
    elif isinstance(feats, SparseFeatures):
        d = feats.dim
        if feats.device.type == "cuda":
            feats = feats.with_layouts()
        m = mask.to(feats.dtype)
        s1 = feats.rmatvec(m)
        s2 = feats.sq_rmatvec(m)
        cols = torch.where((feats.idx >= 0) & (feats.idx < d), feats.idx,
                           d).long().reshape(-1)
        present = ((feats.val != 0) & (mask[:, None] > 0)).reshape(-1)
        nnz = torch.zeros(d + 1, dtype=torch.float64, device=feats.device)
        nnz = nnz.index_add_(0, cols, present.to(torch.float64))[:d].to(torch.float32)
        val = feats.val.reshape(-1).to(feats.dtype)   # bfloat16 values upcast

        def extreme(fill: float, reduce: str) -> Tensor:
            src = torch.where(present, val, fill)
            out = torch.full((d + 1,), fill, dtype=val.dtype, device=val.device)
            return out.scatter_reduce_(0, cols, src, reduce=reduce)[:d]

        mn, mx = extreme(inf, "amin"), extreme(-inf, "amax")
        # Implicit zeros: a column with fewer explicit nonzeros than rows
        # also holds 0; columns never touched read min = max = 0.
        has_zero = nnz < n
        mn = torch.where(has_zero, torch.clamp(mn, max=0.0), mn)
        mx = torch.where(has_zero, torch.clamp(mx, min=0.0), mx)
        mn = torch.where(torch.isinf(mn), 0.0, mn)
        mx = torch.where(torch.isinf(mx), 0.0, mx)
    else:
        raise TypeError(f"unknown feature container {type(feats).__name__}")

    mean = s1 / n_safe
    # Sample variance with Bessel's correction.
    var = torch.clamp(s2 - n * mean * mean, min=0.0) / torch.clamp(n - 1.0, min=1.0)
    return FeatureDataStatistics(mean=mean, variance=var, min=mn, max=mx,
                                 num_nonzeros=nnz, count=n)
