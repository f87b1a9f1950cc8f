"""Batched data as tensors: ELL sparse features and labeled batches.

Port of ``photon_tpu/data/batch.py`` (the scoring half:
``SparseFeatures.matvec``, ``LabeledBatch`` and ``ell_from_rows``).

``SparseFeatures`` is padded ELL: ``idx[N, K] int32`` / ``val[N, K]`` with
K = max nnz per row; padding slots point at column ``dim`` (the zero "ghost"
column) with value 0. On CUDA, ``with_accelerator_paths`` attaches the panel
layout (``build_panels``) where it pays, and ``matvec`` then launches the
``ell_panel_matvec`` kernel, else ``ell_matvec`` (``ops/cuda_sparse.py``); on
a CPU tensor it runs the plain version. ``rmatvec``/``sq_rmatvec`` come with
the training slice, which attaches the column-sorted layout they read in
``with_accelerator_paths`` too.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_tpu_torch.ops.cuda_sparse import (
    PanelLayout,
    build_panels,
    ell_matvec,
    ell_panel_matvec,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SparseFeatures:
    """Padded ELL sparse matrix: per-row index/value lists of width K.

    ``idx[N, K]`` holds column ids in [0, dim]; id == dim marks padding (its
    value must be 0). ``dim`` is the true feature dimension D. ``panels``
    is the matvec's panel layout of the same entries, once attached.
    """

    idx: Tensor
    val: Tensor
    dim: int
    panels: Optional[PanelLayout] = None

    @property
    def device(self) -> torch.device:
        return self.idx.device

    @property
    def dtype(self) -> torch.dtype:
        return self.val.dtype

    def with_accelerator_paths(self) -> "SparseFeatures":
        """On CUDA, attach the panel layout of the matvec (built once, on
        the card), unless ``build_panels`` finds that reloading w per row
        tile costs more than its gathers. On the CPU nothing is attached.
        The training slice attaches the transposes' column-sorted layout
        here too."""
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
        if self.panels is not None:
            return ell_panel_matvec(self.panels, w)
        return ell_matvec(self.idx, self.val, w, self.dim)


@dataclasses.dataclass(frozen=True)
class LabeledBatch:
    """A batch of labeled examples for one feature shard. ``weights``
    doubles as the validity mask: padded rows carry weight 0."""

    features: SparseFeatures
    labels: Tensor               # [N]
    offsets: Tensor              # [N]
    weights: Tensor              # [N]

    def with_accelerator_paths(self) -> "LabeledBatch":
        """The features attach their accelerator layouts (see
        ``SparseFeatures.with_accelerator_paths``)."""
        attached = self.features.with_accelerator_paths()
        if attached is self.features:
            return self
        return dataclasses.replace(self, features=attached)


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
