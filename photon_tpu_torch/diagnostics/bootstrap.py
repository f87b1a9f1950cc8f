"""Bootstrap confidence intervals for GLM coefficients.

Port of ``photon_tpu/diagnostics/bootstrap.py``. A resample that draws row i
k times is the original batch with ``weights[i] *= k``, so the replicates
are multinomial count weights over one shared batch. The JAX package solves
them as one ``jax.vmap`` of ``problem.run``; here they run as masked batched
lanes (``GLMOptimizationProblem.run_lanes``, ``optim/lanes.py``): one lane a
replicate, every lane's data pass a pass of the shared features with that
lane's coefficients. The counts are drawn from ``np.random.default_rng(seed)``
exactly as the JAX package draws them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_tpu_torch.data.batch import LabeledBatch
from photon_tpu_torch.data.normalization import project_context
from photon_tpu_torch.functions.problem import GLMOptimizationProblem

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class BootstrapResult:
    """Percentile CIs from B replicate fits. All arrays are [D] except
    ``samples`` ([B, D]) and ``converged`` ([B] bool)."""

    lower: np.ndarray
    upper: np.ndarray
    mean: np.ndarray
    std_error: np.ndarray
    samples: np.ndarray
    converged: np.ndarray
    confidence: float

    @property
    def n_replicates(self) -> int:
        return self.samples.shape[0]


@dataclasses.dataclass(frozen=True)
class SharedLaneFeatures:
    """One feature matrix shared by every lane: ``matvec`` takes ``[E, D]``
    coefficients to ``[E, N]`` margins and the transposes go back, one pass
    of the shared features a lane (on CUDA the kernels of
    ``ops/cuda_sparse.py``)."""

    features: object          # SparseFeatures or DenseFeatures
    n_lanes: int

    @property
    def dim(self) -> int:
        return self.features.dim

    @property
    def device(self) -> torch.device:
        return self.features.device

    @property
    def dtype(self) -> torch.dtype:
        return self.features.dtype

    def with_accelerator_paths(self) -> "SharedLaneFeatures":
        return dataclasses.replace(self, features=self.features.with_accelerator_paths())

    def _each(self, fn, x: Tensor) -> Tensor:
        return torch.stack([fn(x[e].contiguous()) for e in range(x.shape[0])])

    def matvec(self, w: Tensor) -> Tensor:
        return self._each(self.features.matvec, w)

    def rmatvec(self, v: Tensor) -> Tensor:
        return self._each(self.features.rmatvec, v)

    def sq_rmatvec(self, v: Tensor) -> Tensor:
        return self._each(self.features.sq_rmatvec, v)


def bootstrap_coefficients(
    problem: GLMOptimizationProblem,
    batch: LabeledBatch,
    w0: Tensor,
    n_replicates: int = 32,
    confidence: float = 0.95,
    seed: int = 0,
    normalization=None,
) -> BootstrapResult:
    """Fit ``n_replicates`` multinomial-bootstrap resamples as lanes of one
    batched solve and return percentile confidence intervals.

    ``problem`` should have ``variance_type=NONE``. ``normalization`` must
    be the context the reported model was trained with (each lane gets it,
    gathered to ``[B, D]``)."""
    n, b = batch.n_rows, n_replicates
    rng = np.random.default_rng(seed)
    counts = rng.multinomial(n, np.full(n, 1.0 / n), size=b)
    base_w = batch.weights.detach().cpu().numpy()
    rep_weights = torch.from_numpy(counts * base_w[None, :]).to(
        dtype=batch.weights.dtype, device=batch.weights.device)
    feats = SharedLaneFeatures(batch.features, b).with_accelerator_paths()
    lanes_batch = LabeledBatch(
        features=feats,
        labels=batch.labels.expand(b, n),
        offsets=batch.offsets.expand(b, n),
        weights=rep_weights,
    )
    d = batch.dim
    w0_lanes = torch.as_tensor(w0).to(batch.labels).expand(b, d).contiguous()
    mask = None
    if problem.reg_mask is not None:
        mask = problem.reg_mask.to(batch.labels).expand(b, d).contiguous()
    local = None
    if normalization is not None and not normalization.is_identity:
        proj = torch.arange(d, device=batch.labels.device).expand(b, d)
        local = project_context(normalization, proj, d)
    model, result = problem.run_lanes(lanes_batch, w0_lanes, reg_mask=mask,
                                      normalization=local)
    samples = model.coefficients.means.detach().cpu().numpy()
    reasons = result.converged_reason.detach().cpu().numpy()
    alpha = (1.0 - confidence) / 2.0
    lower, upper = np.quantile(samples, [alpha, 1.0 - alpha], axis=0)
    return BootstrapResult(
        lower=lower,
        upper=upper,
        mean=samples.mean(axis=0),
        std_error=samples.std(axis=0, ddof=1),
        samples=samples,
        # FUNCTION_VALUES_CONVERGED (2) / GRADIENT_CONVERGED (3); a replicate
        # stopped by the iteration cap is not converged.
        converged=reasons >= 2,
        confidence=confidence,
    )
