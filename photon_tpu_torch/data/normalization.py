"""Feature normalization contexts: optimize in a scaled space, report back.

Port of ``photon_tpu/data/normalization.py``. Types: ``NONE`` (identity),
``SCALE_WITH_STANDARD_DEVIATION`` (factor 1/σⱼ), ``SCALE_WITH_MAX_MAGNITUDE``
(factor 1/max|xⱼ|) and ``STANDARDIZATION`` (factor 1/σⱼ and shift μⱼ; needs
an intercept).

The data is never transformed (that would densify sparse features). With
transformed features x' = (x − s)∘f, a transformed-space model w' scores
as the original-space model

    w = A·w' = w'∘f − e_i·((w'∘f)ᵀs),

e_i the intercept, so the coefficients are mapped around each evaluation
while the data passes run on the raw features. The intercept's factor is 1
and its shift 0.

The JAX package lifts gradients with ``jax.vjp``; here the adjoint of A is
written out: Aᵀg = f∘(g − s·g_i), and g_i = hᵀg for the one-hot h of a
local context. ``LocalNormalizationContext`` holds ``[E, P]`` leaves, one
row per random-effect lane, and maps ``[E, P]`` coefficients lane by lane.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional

import torch

from photon_tpu_torch.data.statistics import FeatureDataStatistics

Tensor = torch.Tensor


class NormalizationType(enum.Enum):
    NONE = "NONE"
    SCALE_WITH_STANDARD_DEVIATION = "SCALE_WITH_STANDARD_DEVIATION"
    SCALE_WITH_MAX_MAGNITUDE = "SCALE_WITH_MAX_MAGNITUDE"
    STANDARDIZATION = "STANDARDIZATION"

    @classmethod
    def parse(cls, s: str) -> "NormalizationType":
        return cls(s.strip().upper())


class _CoefficientMap:
    """The lifts shared by both contexts, from their ``coef_to_original``
    (the map A) and ``coef_adjoint`` (Aᵀ)."""

    def wrap_value_and_grad(
        self, vg: Callable[[Tensor], tuple[Tensor, Tensor]]
    ) -> Callable[[Tensor], tuple[Tensor, Tensor]]:
        """An original-space (value, grad) closure lifted to transformed
        space: the value at A·w', the gradient Aᵀ∇f."""
        if self.is_identity:
            return vg

        def wrapped(wp: Tensor) -> tuple[Tensor, Tensor]:
            v, g = vg(self.coef_to_original(wp))
            return v, self.coef_adjoint(g)

        return wrapped

    def wrap_hvp(
        self, hvp: Callable[[Tensor, Tensor], Tensor]
    ) -> Callable[[Tensor, Tensor], Tensor]:
        """The transformed-space H' = Aᵀ H A of an ``(x, v) ↦ H(x)·v``."""
        if self.is_identity:
            return hvp
        return lambda wp, vp: self.coef_adjoint(
            hvp(self.coef_to_original(wp), self.coef_to_original(vp)))

    def wrap_hvp_at(
        self, hvp_at: Callable[[Tensor], Callable[[Tensor], Tensor]]
    ) -> Callable[[Tensor], Callable[[Tensor], Tensor]]:
        """The transformed-space H' = Aᵀ H A in factory form: the
        original-space point is mapped and the inner factory called once per
        point, so its hoisting holds (TRON's CG loop calls only the returned
        ``v ↦ H'v``)."""
        if self.is_identity:
            return hvp_at

        def wrapped(wp: Tensor) -> Callable[[Tensor], Tensor]:
            hv = hvp_at(self.coef_to_original(wp))
            return lambda vp: self.coef_adjoint(hv(self.coef_to_original(vp)))

        return wrapped


@dataclasses.dataclass(frozen=True)
class NormalizationContext(_CoefficientMap):
    """``factors`` [D] / ``shifts`` [D] (either None = identity) of one
    feature shard; at ``intercept_index`` the factor is 1 and the shift 0."""

    factors: Optional[Tensor]
    shifts: Optional[Tensor]
    intercept_index: Optional[int] = None

    def __post_init__(self):
        if self.shifts is not None and self.intercept_index is None:
            raise ValueError(
                "shifts require an intercept to absorb them (the reference "
                "NormalizationContext invariant)")

    @property
    def is_identity(self) -> bool:
        return self.factors is None and self.shifts is None

    def _effective(self) -> tuple[Optional[Tensor], Optional[Tensor]]:
        """Factors and shifts with the intercept slot forced to (1, 0), so
        the two maps stay inverses for a directly built context. Made once
        and kept (a masked select, no host round trip)."""
        eff = self.__dict__.get("_eff")
        if eff is None:
            f, s = self.factors, self.shifts
            if self.intercept_index is not None:
                vec = f if f is not None else s
                at = torch.arange(vec.shape[-1], device=vec.device) == self.intercept_index
                f = None if f is None else torch.where(at, 1.0, f)
                s = None if s is None else torch.where(at, 0.0, s)
            eff = (f, s)
            object.__setattr__(self, "_eff", eff)
        return eff

    def coef_to_original(self, w: Tensor) -> Tensor:
        """w = w'∘f, the intercept absorbing −(w'∘f)ᵀs."""
        f, s = self._effective()
        out = w if f is None else w * f
        if s is not None:
            out = out - self._onehot(out) * torch.sum(out * s)
        return out

    def coef_to_transformed(self, w: Tensor) -> Tensor:
        """The inverse map."""
        f, s = self._effective()
        out = w
        if s is not None:
            out = out + self._onehot(out) * torch.sum(out * s)
        if f is not None:
            out = out / f
        return out

    def coef_adjoint(self, g: Tensor) -> Tensor:
        """Aᵀg = f∘(g − s·g_i)."""
        f, s = self._effective()
        out = g
        if s is not None:
            out = out - s * out[self.intercept_index]
        return out if f is None else out * f

    def _onehot(self, like: Tensor) -> Tensor:
        """e_i, the intercept's one-hot, in ``like``'s dtype."""
        h = self.__dict__.get("_h")
        if h is None or h.dtype != like.dtype:
            h = (torch.arange(like.shape[-1], device=like.device)
                 == self.intercept_index).to(like.dtype)
            object.__setattr__(self, "_h", h)
        return h


@dataclasses.dataclass(frozen=True)
class LocalNormalizationContext(_CoefficientMap):
    """A shard context gathered into random-effect lanes' subspaces: ``[E,
    P]`` factors / shifts and the intercept's one-hot h over each lane's
    local slots, so w = w'∘f − h·((w'∘f)ᵀs) lane by lane (the maps reduce
    over the last axis). Ghost slots carry factor 1 and shift 0. Built only
    for non-identity shard contexts."""

    factors: Optional[Tensor]
    shifts: Optional[Tensor]
    intercept_onehot: Optional[Tensor]

    @property
    def is_identity(self) -> bool:
        return self.factors is None and self.shifts is None

    def _effective(self) -> tuple[Optional[Tensor], Optional[Tensor]]:
        return self.factors, self.shifts

    def coef_to_original(self, w: Tensor) -> Tensor:
        f, s = self.factors, self.shifts
        out = w if f is None else w * f
        if s is not None:
            out = out - self.intercept_onehot * torch.sum(out * s, dim=-1,
                                                          keepdim=True)
        return out

    def coef_to_transformed(self, w: Tensor) -> Tensor:
        f, s = self.factors, self.shifts
        out = w
        if s is not None:
            out = out + self.intercept_onehot * torch.sum(out * s, dim=-1,
                                                          keepdim=True)
        if f is not None:
            out = out / f
        return out

    def coef_adjoint(self, g: Tensor) -> Tensor:
        """Aᵀg = f∘(g − s·(hᵀg))."""
        f, s = self.factors, self.shifts
        out = g
        if s is not None:
            out = out - s * torch.sum(out * self.intercept_onehot, dim=-1,
                                      keepdim=True)
        return out if f is None else out * f


def project_context(ctx: NormalizationContext, proj: Tensor,
                    global_dim: int) -> Optional[LocalNormalizationContext]:
    """Gather a shard context into local subspaces through ``proj``
    (``[..., P]`` local → global column map; ghost slots hold
    ``global_dim``). None for an identity context. The shard's intercept
    column becomes a one-hot over local slots."""
    if ctx.is_identity:
        return None
    f, s = ctx._effective()
    for vec in (f, s):
        if vec is not None and vec.shape[-1] != global_dim:
            raise ValueError(
                f"normalization context is {vec.shape[-1]}-dim but the "
                f"projection's global feature space is {global_dim}-dim")
    at = proj.long()

    def gather(vec: Optional[Tensor], ghost_fill: float) -> Optional[Tensor]:
        if vec is None:
            return None
        ext = torch.cat([vec, vec.new_full((1,), ghost_fill)])
        return ext[at]

    onehot = None
    if ctx.intercept_index is not None:
        onehot = (at == ctx.intercept_index).to(
            f.dtype if f is not None else s.dtype)
    return LocalNormalizationContext(
        factors=gather(f, 1.0), shifts=gather(s, 0.0), intercept_onehot=onehot)


def identity_context(intercept_index: Optional[int] = None) -> NormalizationContext:
    return NormalizationContext(factors=None, shifts=None,
                                intercept_index=intercept_index)


def context_from_statistics(
    stats: FeatureDataStatistics,
    ntype: NormalizationType,
    intercept_index: Optional[int] = None,
) -> NormalizationContext:
    """A context from the feature summary, as the reference's driver builds
    it. Zero-σ and zero-magnitude columns get factor 1."""
    if ntype == NormalizationType.NONE:
        return identity_context(intercept_index)

    def safe_inv(x: Tensor) -> Tensor:
        return torch.where(x > 0, 1.0 / torch.where(x > 0, x, 1.0), 1.0)

    shifts = None
    if ntype == NormalizationType.SCALE_WITH_STANDARD_DEVIATION:
        factors = safe_inv(stats.std())
    elif ntype == NormalizationType.SCALE_WITH_MAX_MAGNITUDE:
        factors = safe_inv(stats.max_magnitude())
    elif ntype == NormalizationType.STANDARDIZATION:
        if intercept_index is None:
            raise ValueError(
                "STANDARDIZATION shifts features and therefore requires an "
                "intercept column (reference invariant)")
        factors = safe_inv(stats.std())
        shifts = stats.mean.clone()
    else:  # pragma: no cover - enum is closed
        raise ValueError(f"unknown normalization type {ntype}")
    if intercept_index is not None:
        factors[intercept_index] = 1.0
        if shifts is not None:
            shifts[intercept_index] = 0.0
    return NormalizationContext(factors=factors, shifts=shifts,
                                intercept_index=intercept_index)
