"""The fixed-effect objective over a row-sharded batch: value, gradient and
Hessian-vector products folded across a mesh.

Port of ``photon_tpu/parallel/spmd_objective.py``. Each shard of the batch
(``parallel/mesh.pad_and_shard_batch``: contiguous row blocks, each with
its own layouts on its own device) computes its partial value and gradient,
or its part of H·v, with the single-device objective's passes — the
kernels of ``ops/cuda_sparse.py`` on a card — and :func:`mesh.fold` sums
the partials in shard order (and, on a mesh that spans processes, in rank
order across them): the counterpart of one ``lax.psum`` an evaluation. The
L2 term and the prior are added once, after the fold, never per shard.
Per-row margins and the TRON curvature d2 stay on their shard.

:func:`fit_spmd` runs the port's optimizers over these closures —
``LBFGS(cfg).optimize(vg, w0)``, ``OWLQN(cfg).optimize(vg, w0, l1w)`` and
``TRON(cfg).optimize(vg, w0, hvp_at)`` — as the JAX function does; it also
takes a normalization context and computes variances, which the JAX package
leaves to its GSPMD ``fit_data_parallel`` (here the same implementation:
``parallel/data_parallel.py``). It does not take the single-device scored
L-BFGS path (one margin tensor), as JAX's does not; its result stays within
1e-12 of the scored single-device solve at f64.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from photon_tpu_torch.functions.objective import GLMObjective
from photon_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    RowShards,
    fold,
    pad_and_shard_batch,
    replicate,
)

Tensor = torch.Tensor

__all__ = ["SpmdGLMObjective", "fit_spmd"]


@dataclasses.dataclass(frozen=True, eq=False)
class SpmdGLMObjective:
    """One GLM objective bound to a row-sharded batch.

    ``value_and_grad`` and ``hvp_at`` have the signatures the optimizers
    take, so L-BFGS, OWL-QN and TRON run over the sharded data unchanged.
    ``shards`` is a :class:`~photon_tpu_torch.parallel.mesh.RowShards` of
    ``LabeledBatch`` blocks; results live on its first device."""

    obj: GLMObjective
    shards: RowShards

    @classmethod
    def build(cls, obj: GLMObjective, batch, mesh,
              data_axis=DATA_AXIS) -> "SpmdGLMObjective":
        return cls(obj=obj, shards=pad_and_shard_batch(batch, mesh, data_axis))

    @property
    def device(self) -> torch.device:
        return self.shards.device

    @property
    def _data_obj(self) -> GLMObjective:
        return GLMObjective(loss=self.obj.loss)

    def _fold(self, parts) -> Tensor:
        return fold(parts, self.shards.mesh, self.shards.axis, self.device)

    def _each(self, fn, *vectors):
        """``fn(shard, *vectors on its device)`` for every shard, in order."""
        per = [replicate(v, self.shards.devices) for v in vectors]
        return [fn(b, *(p[i] for p in per))
                for i, b in enumerate(self.shards.shards)]

    # -- the data term, folded ----------------------------------------------

    def data_value_and_grad(self, w: Tensor) -> tuple[Tensor, Tensor]:
        """Σ over shards of the data term's (value, gradient): one matvec
        and one rmatvec a shard."""
        parts = self._each(lambda b, wi: self._data_obj.value_and_grad(wi, b), w)
        return (self._fold([p[0] for p in parts]),
                self._fold([p[1] for p in parts]))

    def _d2(self, w: Tensor) -> list:
        """Each shard's curvature weights at ``w``, kept on the shard."""
        loss = self.obj.loss

        def d2(b, wi):
            z = b.features.matvec(wi) + b.offsets
            return b.weights * loss.d2(z, b.labels)

        return self._each(d2, w)

    # -- with the L2 term and the prior ---------------------------------------

    def value_and_grad(self, w: Tensor) -> tuple[Tensor, Tensor]:
        v, g = self.data_value_and_grad(w)
        lam = self.obj._l2_vec(w)
        v = v + 0.5 * torch.sum(lam * w * w)
        g = g + lam * w
        if self.obj.prior is not None:
            v = v + self.obj.prior.value(w)
            g = g + self.obj.prior.gradient(w)
        return v, g

    def bind(self) -> Callable[[Tensor], tuple[Tensor, Tensor]]:
        """``w ↦ (value, grad)`` for ``Optimizer.optimize``."""
        return self.value_and_grad

    def hvp_at(self, w: Tensor) -> Callable[[Tensor], Tensor]:
        """``w ↦ (v ↦ H(w)·v)``: the margins and d2 computed once per point
        on each shard, so every H·v is two passes a shard and one fold."""
        d2 = self._d2(w)

        def hv(v: Tensor) -> Tensor:
            vs = replicate(v, self.shards.devices)
            out = self._fold([b.features.rmatvec(d * b.features.matvec(vi))
                              for b, d, vi in zip(self.shards.shards, d2, vs)])
            out = out + self.obj._l2_vec(v) * v
            if self.obj.prior is not None:
                out = out + self.obj.prior.hessian_vector(v)
            return out

        return hv

    def hessian_vector(self, w: Tensor, v: Tensor) -> Tensor:
        """One-shot H(w)·v (three passes a shard); prefer ``hvp_at``."""
        return self.hvp_at(w)(v)

    def hessian_diagonal(self, w: Tensor) -> Tensor:
        """diag(H): one matvec and one sq_rmatvec a shard, folded."""
        diag = self._fold([b.features.sq_rmatvec(d)
                           for b, d in zip(self.shards.shards, self._d2(w))])
        diag = diag + self.obj._l2_vec(w)
        if self.obj.prior is not None:
            diag = diag + self.obj.prior.hessian_diagonal()
        return diag


def fit_spmd(problem, batch, w0: Tensor, mesh=None, data_axis=DATA_AXIS,
             reg_mask: Optional[Tensor] = None, normalization=None,
             prior=None):
    """The whole fixed-effect solve through the folded objective.

    ``batch`` is a ``LabeledBatch`` (padded and sharded over ``data_axis``
    of ``mesh`` here) or the ``RowShards`` of one (sharded already: a
    coordinate-descent step passes its shards with new offsets). The
    optimizer routing is ``GLMOptimizationProblem.run``'s (L-BFGS, OWL-QN,
    TRON; an L1 component needs OWL-QN), with ``normalization`` and the
    problem's variances as there. Returns ``(model, result)`` on the mesh's
    first device."""
    from photon_tpu_torch.functions.problem import _active
    from photon_tpu_torch.models.coefficients import Coefficients
    from photon_tpu_torch.models.glm import GeneralizedLinearModel
    from photon_tpu_torch.optim import LBFGS, OWLQN, TRON, OptimizerType

    shards = (batch if isinstance(batch, RowShards)
              else pad_and_shard_batch(batch, mesh, data_axis))
    obj = problem.objective(reg_mask, prior)
    if obj.reg_mask is not None:
        obj = dataclasses.replace(obj, reg_mask=obj.reg_mask.to(shards.device))
    rw = problem.reg_weight
    if (problem.optimizer_type != OptimizerType.OWLQN
            and problem.regularization.l1_weight(rw) > 0.0):
        raise ValueError(
            f"{problem.regularization.reg_type.name} regularization requires "
            f"OptimizerType.OWLQN, got {problem.optimizer_type.name}")
    full = SpmdGLMObjective(obj=obj, shards=shards)
    # The data term and the prior, without L2: under normalization the L2
    # term applies to the transformed coefficients.
    data = SpmdGLMObjective(obj=dataclasses.replace(obj, l2_weight=0.0),
                            shards=shards)
    w0 = w0.to(shards.device)
    norm = _active(normalization)
    if norm is None:
        vg, hvp_at = full.value_and_grad, full.hvp_at
    else:
        w0 = norm.coef_to_transformed(w0)
        inner = norm.wrap_value_and_grad(data.value_and_grad)
        inner_at = norm.wrap_hvp_at(data.hvp_at)

        def vg(wp: Tensor):
            v, g = inner(wp)
            lam = obj._l2_vec(wp)
            return v + 0.5 * torch.sum(lam * wp * wp), g + lam * wp

        def hvp_at(wp: Tensor):
            hv = inner_at(wp)
            return lambda vp: hv(vp) + obj._l2_vec(vp) * vp

    cfg = problem.optimizer_config
    if problem.optimizer_type == OptimizerType.LBFGS:
        result = LBFGS(cfg).optimize(vg, w0)
    elif problem.optimizer_type == OptimizerType.OWLQN:
        mask = obj.reg_mask if obj.reg_mask is not None else torch.ones_like(w0)
        l1w = problem.regularization.l1_weight(rw) * mask.to(w0)
        result = OWLQN(cfg).optimize(vg, w0, l1w)
    elif problem.optimizer_type == OptimizerType.TRON:
        result = TRON(cfg).optimize(vg, w0, hvp_at)
    else:  # pragma: no cover - enum is closed
        raise ValueError(f"unknown optimizer {problem.optimizer_type}")
    x = result.x if norm is None else norm.coef_to_original(result.x)
    variances = problem._variances(
        obj, x, None, norm, curvature=(data.hessian_diagonal, data.hvp_at))
    model = GeneralizedLinearModel(Coefficients(means=x, variances=variances),
                                   problem.task)
    return model, result
