"""Batched data as tensors: ELL sparse features and labeled batches.

Port of ``photon_tpu/data/batch.py``: ``DenseFeatures``, ``SparseFeatures``
with its three data passes and ``with_value_dtype``, ``LabeledBatch`` and
``ell_from_rows``, plus ``LaneFeatures``, the port's layout of a
random-effect bucket for its batched lane solves, and ``DenseLaneFeatures``,
the dense lanes of a factored random effect's latent step.

Values may be stored as bfloat16 (``with_value_dtype``, or
``PHOTON_VALUE_DTYPE=bfloat16`` through ``with_accelerator_paths`` on
CUDA): the passes then take and give float32 vectors (JAX's
``promote_types(bfloat16, float32)``), the kernels upcasting each value on
load. ``SparseFeatures.dtype`` is that compute dtype; ``val.dtype`` the
stored one.

``SparseFeatures`` is padded ELL: ``idx[N, K] int32`` / ``val[N, K]`` with
K = max nnz per row; padding slots point at column ``dim`` (the zero "ghost"
column) with value 0. On CUDA, ``with_accelerator_paths`` attaches the
column-sorted layout of the transposes (``build_transpose``) and, where it pays,
the panel layout of the matvec (``build_panels``). Then ``matvec`` launches
``ell_panel_matvec`` (else ``ell_matvec``) and ``rmatvec`` / ``sq_rmatvec``
launch ``csc_rmatvec`` / ``csc_sq_rmatvec`` (``ops/cuda_sparse.py``). Where
the route rule (``cuda_sparse.transpose_route``) sends bfloat16 values to
the transpose over row panels, the row-panel layout is attached in place
of the CSC one and the transposes launch ``csc_panel_rmatvec`` /
``csc_sq_panel_rmatvec``. On the CPU the plain versions run. A CUDA batch
without a transpose layout raises in ``rmatvec``: it never builds a layout
on the fly and never computes on the host. Each pass is recorded by
``ops/pass_counter.py``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from photon_tpu_torch.ops import pass_counter
from photon_tpu_torch.ops.cuda_sparse import (
    CscLayout,
    PanelLayout,
    RowPanelLayout,
    as_value_dtype,
    build_panels,
    build_transpose,
    compute_dtype,
    csc_panel_rmatvec,
    csc_rmatvec,
    ell_matvec,
    ell_panel_matvec,
    ell_rmatvec_plain,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DenseFeatures:
    """Row-major dense design matrix ``x[N, D]``. Its passes are
    ``torch.matmul``: the JAX package computes them outside any Pallas
    kernel too."""

    x: Tensor

    @property
    def device(self) -> torch.device:
        return self.x.device

    @property
    def dtype(self) -> torch.dtype:
        return self.x.dtype

    @property
    def n_rows(self) -> int:
        return self.x.shape[0]

    @property
    def dim(self) -> int:
        return self.x.shape[1]

    def with_accelerator_paths(self) -> "DenseFeatures":
        return self

    def with_matvec_layout(self) -> "DenseFeatures":
        return self

    def matvec(self, w: Tensor) -> Tensor:
        pass_counter.record("matvec")
        return self.x @ w

    def rmatvec(self, v: Tensor) -> Tensor:
        """Xᵀv — accumulate per-row coefficients ``v`` into feature space."""
        pass_counter.record("rmatvec")
        return self.x.T @ v

    def sq_rmatvec(self, v: Tensor) -> Tensor:
        """(X∘X)ᵀv — for Hessian diagonals: Σᵢ vᵢ·xᵢⱼ²."""
        pass_counter.record("sq_rmatvec")
        return (self.x * self.x).T @ v


@dataclasses.dataclass(frozen=True)
class SparseFeatures:
    """Padded ELL sparse matrix: per-row index/value lists of width K.

    ``idx[N, K]`` holds column ids in [0, dim]; id == dim marks padding (its
    value must be 0). ``dim`` is the true feature dimension D. ``panels``
    (the matvec's panel layout) and ``csc`` (the transposes' column-sorted
    layout) or ``row_panels`` (their row-panel layout, where the route takes
    it) hold the same entries, once attached.
    """

    idx: Tensor
    val: Tensor
    dim: int
    panels: Optional[PanelLayout] = None
    csc: Optional[CscLayout] = None
    row_panels: Optional[RowPanelLayout] = None

    @property
    def device(self) -> torch.device:
        return self.idx.device

    @property
    def dtype(self) -> torch.dtype:
        """The dtype of the passes' vectors and results: the values' own,
        float32 for bfloat16 values."""
        return compute_dtype(self.val.dtype)

    @property
    def n_rows(self) -> int:
        return self.idx.shape[0]

    def with_layouts(self) -> "SparseFeatures":
        """On CUDA, attach the transposes' layout (always: the one
        ``build_transpose`` picks, the CSC one or, where the route rule
        sends these values, the row-panel one) and the matvec's panel
        layout (see ``with_matvec_layout``), each built once; the values
        keep their dtype. On the CPU nothing is attached."""
        if self.device.type != "cuda" or self.csc is not None or \
                self.row_panels is not None:
            return self
        out = self.with_matvec_layout()
        t = build_transpose(self.idx, self.val, self.dim)
        if isinstance(t, RowPanelLayout):
            return dataclasses.replace(out, row_panels=t)
        return dataclasses.replace(out, csc=t)

    def with_accelerator_paths(self) -> "SparseFeatures":
        """Under ``PHOTON_VALUE_DTYPE`` (``bfloat16``) the values narrowed
        (``with_value_dtype``), as the JAX package narrows on its
        accelerators, then ``with_layouts``: a shard's batch for the GLM
        driver, the fixed effect and scoring. Random-effect lanes attach
        ``with_layouts`` and stay float32. On the CPU nothing is attached
        and nothing narrows."""
        if self.device.type != "cuda":
            return self
        vd = os.environ.get("PHOTON_VALUE_DTYPE")
        out = self.with_value_dtype(vd) if vd else self
        return out.with_layouts()

    def with_value_dtype(self, dtype) -> "SparseFeatures":
        """Store the values as ``dtype`` (``torch.bfloat16`` or
        ``"bfloat16"``; the current dtype is a no-op), the attached layouts'
        values too. The transposes' route is decided where their layout is
        built (``with_layouts``), so narrow first: an attached CSC layout
        keeps the merge path. Port of JAX's ``with_value_dtype``: only
        storage narrows; the kernels upcast each value on load and sum in
        float64, so the passes give float32 results (JAX keeps its
        accumulation in the operand precision). One-hot and small-integer
        values are exact in bfloat16; continuous values round to 8 mantissa
        bits. Only float32 data narrows: bfloat16 values go with float32
        vectors."""
        dt = as_value_dtype(dtype)
        if dt == self.val.dtype:
            return self
        if dt != torch.bfloat16 or self.val.dtype != torch.float32:
            raise TypeError(
                f"with_value_dtype narrows float32 values to bfloat16; got "
                f"{self.val.dtype} -> {dt}")
        out = dataclasses.replace(self, val=self.val.to(dt))

        def narrowed(layout):
            return dataclasses.replace(layout, vals=layout.vals.to(dt))

        if out.panels is not None:
            out = dataclasses.replace(out, panels=narrowed(out.panels))
        if out.row_panels is not None:
            out = dataclasses.replace(out, row_panels=narrowed(out.row_panels))
        if out.csc is not None:
            out = dataclasses.replace(out, csc=narrowed(out.csc))
        return out

    def with_matvec_layout(self) -> "SparseFeatures":
        """On CUDA, attach the matvec's panel layout, unless
        ``build_panels`` finds that reloading w per row tile costs more
        than its gathers. Scoring, which runs one matvec, needs no more."""
        if self.device.type != "cuda" or self.panels is not None:
            return self
        panels = build_panels(self.idx, self.val, self.dim)
        if panels is None:
            return self
        return dataclasses.replace(self, panels=panels)

    def matvec(self, w: Tensor) -> Tensor:
        """z = A·w: on CUDA the ``ell_panel_matvec`` kernel when a panel
        layout is attached, else ``ell_matvec``; their plain versions on the
        CPU."""
        pass_counter.record("matvec")
        if self.panels is not None:
            if w.data_ptr() % 16:
                # The panel kernel's bulk copies read w from a 16-byte
                # aligned address; a view into a larger tensor (a row of
                # an identity, say) may not be.
                w = w.clone()
            return ell_panel_matvec(self.panels, w)
        return ell_matvec(self.idx, self.val, w, self.dim)

    def rmatvec(self, v: Tensor) -> Tensor:
        """Aᵀ·v — accumulate per-row coefficients ``v`` into feature space:
        kernel ``csc_rmatvec`` (``csc_panel_rmatvec`` over row panels) on
        CUDA, its plain version on the CPU."""
        pass_counter.record("rmatvec")
        return self._transpose(v, square=False)

    def sq_rmatvec(self, v: Tensor) -> Tensor:
        """(A∘A)ᵀ·v — Σᵢ vᵢ·xᵢⱼ², for Hessian diagonals: kernel
        ``csc_sq_rmatvec`` on CUDA, its plain version on the CPU."""
        pass_counter.record("sq_rmatvec")
        return self._transpose(v, square=True)

    def _transpose(self, v: Tensor, square: bool) -> Tensor:
        if self.csc is not None:
            return csc_rmatvec(self.csc, v, square=square)
        if self.row_panels is not None:
            if v.data_ptr() % 16:
                v = v.clone()    # the panels of v come by 16-byte bulk copies
            return csc_panel_rmatvec(self.row_panels, v, square=square)
        if self.device.type != "cpu":
            raise RuntimeError(
                f"SparseFeatures on {self.device} has no transpose layout attached: "
                "call with_accelerator_paths() once before rmatvec / "
                "sq_rmatvec (the layout is built once per dataset, never "
                "per call)"
            )
        return ell_rmatvec_plain(self.idx, self.val, v, self.dim, square)


@dataclasses.dataclass(frozen=True)
class LabeledBatch:
    """A batch of labeled examples for one feature shard. ``weights``
    doubles as the validity mask: padded rows carry weight 0."""

    features: SparseFeatures     # or Dense(Lane)Features / LaneFeatures
    labels: Tensor               # [N] ([E, S] over LaneFeatures)
    offsets: Tensor              # [N]
    weights: Tensor              # [N]

    @property
    def n_rows(self) -> int:
        return self.labels.shape[0]

    @property
    def dim(self) -> int:
        return self.features.dim

    def with_offsets(self, offsets: Tensor) -> "LabeledBatch":
        return dataclasses.replace(self, offsets=offsets)

    def with_accelerator_paths(self, cache: Optional[dict] = None) -> "LabeledBatch":
        """The features attach their accelerator layouts (see
        ``SparseFeatures.with_accelerator_paths``). ``cache`` (id(features)
        -> attached features) lets a configuration sweep build each layout
        once per distinct feature object."""
        feats = self.features
        if cache is not None and id(feats) in cache:
            attached = cache[id(feats)]
        else:
            attached = feats.with_accelerator_paths()
            if cache is not None:
                cache[id(feats)] = attached
        if attached is feats:
            return self
        return dataclasses.replace(self, features=attached)


@dataclasses.dataclass(frozen=True)
class LaneFeatures:
    """A random-effect bucket's per-entity ELL blocks ``[E, S, K]`` (local
    columns, ghost = P) as one block-diagonal ``SparseFeatures``: entity e's
    sample s is row e·S + s, its local column c is column e·P + c, and every
    local ghost maps to the flat ghost column E·P.

    ``matvec`` takes per-lane coefficients ``[E, P]`` to margins ``[E, S]``
    and the transposes go back, each ONE pass over the whole bucket: on CUDA
    the kernels of ``ops/cuda_sparse.py`` once ``with_accelerator_paths``
    has attached the layouts. Each lane's sums are over its own rows and
    columns only, in an order fixed by the layout: no float atomics.
    """

    flat: SparseFeatures
    n_lanes: int
    n_samples: int
    dim: int                      # P, the local dimension of every lane

    @staticmethod
    def from_bucket(idx: Tensor, val: Tensor, dim: int) -> "LaneFeatures":
        e, s, k = idx.shape
        if e * dim >= 2**31:
            raise ValueError(
                f"{e} lanes x {dim} local columns exceed the int32 column ids "
                "of the block-diagonal layout")
        base = (torch.arange(e, dtype=torch.int32, device=idx.device)
                * dim)[:, None, None]
        ghost = torch.full_like(idx, e * dim)
        flat_idx = torch.where((idx >= 0) & (idx < dim), idx + base, ghost)
        return LaneFeatures(
            flat=SparseFeatures(idx=flat_idx.reshape(e * s, k).contiguous(),
                                val=val.reshape(e * s, k).contiguous(),
                                dim=e * dim),
            n_lanes=e, n_samples=s, dim=dim)

    @property
    def device(self) -> torch.device:
        return self.flat.device

    @property
    def dtype(self) -> torch.dtype:
        return self.flat.dtype

    def with_accelerator_paths(self) -> "LaneFeatures":
        """The flat layout's CSC and panels; the values stay as they are
        (never narrowed: the lanes' buckets are float32 or float64)."""
        return dataclasses.replace(self, flat=self.flat.with_layouts())

    def matvec(self, w: Tensor) -> Tensor:
        return self.flat.matvec(w.reshape(-1)).reshape(self.n_lanes, self.n_samples)

    def rmatvec(self, v: Tensor) -> Tensor:
        return self.flat.rmatvec(v.reshape(-1)).reshape(self.n_lanes, self.dim)

    def sq_rmatvec(self, v: Tensor) -> Tensor:
        return self.flat.sq_rmatvec(v.reshape(-1)).reshape(self.n_lanes, self.dim)


@dataclasses.dataclass(frozen=True)
class DenseLaneFeatures:
    """Dense per-lane designs ``x[E, S, p]``: the lanes of a factored random
    effect's latent step (each entity's rows projected to its ``p`` latent
    features), the counterpart of JAX's ``jax.vmap`` over ``DenseFeatures``.

    ``matvec`` takes per-lane coefficients ``[E, p]`` to margins ``[E, S]``
    and the transposes go back, each one batched product over the whole
    bucket (``torch.bmm``: cuBLAS on CUDA, as the JAX package computes these
    dense products outside any Pallas kernel too)."""

    x: Tensor

    @property
    def dim(self) -> int:
        return self.x.shape[2]

    def matvec(self, w: Tensor) -> Tensor:
        pass_counter.record("matvec")
        return torch.bmm(self.x, w.unsqueeze(-1)).squeeze(-1)

    def rmatvec(self, v: Tensor) -> Tensor:
        pass_counter.record("rmatvec")
        return torch.bmm(v.unsqueeze(1), self.x).squeeze(1)

    def sq_rmatvec(self, v: Tensor) -> Tensor:
        pass_counter.record("sq_rmatvec")
        return torch.bmm(v.unsqueeze(1), self.x * self.x).squeeze(1)


def ell_from_rows(
    rows: list[tuple],
    dim: int,
    *,
    dtype: torch.dtype,
    device: torch.device,
) -> SparseFeatures:
    """Pack per-row (indices, values) pairs into padded ELL arrays as wide
    as the longest row (built on the host, then placed on ``device``)."""
    n = len(rows)
    k = max(max((len(r[0]) for r in rows), default=1), 1)
    idx = np.full((n, k), dim, dtype=np.int32)
    val = np.zeros((n, k), dtype=np.float64)
    for i, (ri, rv) in enumerate(rows):
        idx[i, : len(ri)] = np.asarray(ri)
        val[i, : len(rv)] = np.asarray(rv)
    return SparseFeatures(
        idx=torch.from_numpy(idx).to(device),
        val=torch.from_numpy(val).to(device=device, dtype=dtype),
        dim=dim,
    )
