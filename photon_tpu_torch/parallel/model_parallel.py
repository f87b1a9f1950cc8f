"""Feature-sharded fixed effects: the 2D (``data`` x ``model``) mesh solve.

Port of ``photon_tpu/parallel/model_parallel.py``. The coefficient vector,
the gradient and the L-BFGS / OWL-QN / TRON state are sharded over the
``model`` axis: each model shard owns a contiguous block of ``d_full /
n_model`` columns (the dimension padded to a multiple of the shard count),
while the rows shard over the ``data`` axis (one axis or a tuple, e.g.
``("dcn", "data")``).

Each shard holds its own ELL cut of its rows: only the entries of its
column block, with indices local to the block, the pad at the ghost column
and K the per-row maximum within the block; the hand-written kernels
(``ell_matvec`` / ``ell_panel_matvec``, ``csc_rmatvec``, ``csc_sq_rmatvec``)
run on that cut through ``SparseFeatures``. Every fold is
``parallel/mesh.fold`` (f64, in shard order):

* margins: each shard's partial margins, folded over the ``model`` axis
  (only per-row vectors of its row block cross devices, never w);
* value and gradient: folded over the ``data`` axis (each gradient block
  stays with its column's shards);
* every coefficient-space inner product, TRON's CG included, and the
  normalization shift's scalar: each shard's partial, folded over the
  ``model`` axis (the optimizers' ``dot``).

The JAX function is one ``shard_map``-ped program; here each shard is a
thread running the same program on its own device, and the folds are the
collectives every thread calls in the same order (:class:`_Lockstep`):
every shard reads the same folded bits, so every shard takes the same
optimizer decisions. L-BFGS, OWL-QN and TRON; NONE and SIMPLE variances
(SIMPLE's Hessian diagonal per feature shard through ``csc_sq_rmatvec``);
a normalization context; ``reg_mask`` and the prior. FULL variance takes
the data-parallel path (a D x D Hessian does not fit the sharded state).
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from photon_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axes_size,
    axis_tuple,
    fold,
    spans_processes,
)

Tensor = torch.Tensor

MODEL_AXIS = "model"

__all__ = ["MODEL_AXIS", "fit_model_parallel"]


def _shard_grid(mesh, data_axes: tuple, model_axis: str) -> list:
    """This process's devices as ``grid[i][j]``: row block ``i`` (over the
    data axes, in mesh order) by column block ``j`` (over the model axis);
    any other axis is taken at its first entry."""
    local = [a for a in data_axes if a != mesh.process_axis]
    for a in local + [model_axis]:
        if a not in mesh.axis_names:
            raise ValueError(f"mesh {mesh.shape} has no axis {a!r}")
    order = [mesh.axis_names.index(a) for a in local + [model_axis]]
    rest = [k for k in range(len(mesh.axis_names)) if k not in order]
    arr = np.transpose(mesh.devices, order + rest)
    n_model = arr.shape[len(local)]
    arr = arr.reshape((-1, n_model, int(np.prod(arr.shape[len(local) + 1:],
                                                dtype=int))))[..., 0]
    return [list(row) for row in arr]


def _column_cut(idx: Tensor, val: Tensor, lo: int, width: int):
    """The ELL entries of columns ``[lo, lo + width)``: indices local to the
    block, each row's owned entries first in their original order, K the
    per-row maximum within the block, the rest at the ghost column
    ``width`` with value 0."""
    own = (idx >= lo) & (idx < lo + width)
    k = max(1, int(own.sum(dim=1).max())) if idx.shape[0] else 1
    order = torch.sort((~own).to(torch.int8), dim=1, stable=True).indices[:, :k]
    keep = torch.gather(own, 1, order)
    li = torch.where(keep, torch.gather(idx, 1, order) - lo, width)
    lv = torch.where(keep, torch.gather(val, 1, order), 0.0)
    return li.to(torch.int32).contiguous(), lv.contiguous()


class _Lockstep:
    """The collectives of the shard programs. Every program calls the same
    sequence of folds; at each, the programs leave their partials, one of
    them folds every group (``parallel/mesh.fold``: f64, in shard order;
    across processes, in rank order, the only thread that talks to the
    process group) and each takes its group's result on its own device.
    A failing program aborts the barrier, so no other program waits for
    good."""

    def __init__(self, grid: list, mesh, data_axes: tuple):
        self.grid = grid
        self.mesh = mesh
        self.data_axes = data_axes
        self.barrier = threading.Barrier(len(grid) * len(grid[0]))
        self.slots = [[None] * len(grid[0]) for _ in grid]
        self.out = None

    def _collect(self, i: int, j: int, part, combine):
        self.slots[i][j] = part
        if self.barrier.wait() == 0:
            self.out = combine(self.slots)
        self.barrier.wait()
        return self.out

    def model_sum(self, i: int, j: int, part: Tensor) -> Tensor:
        """Σ over the model axis of the row group of shard ``(i, j)``."""
        def combine(slots):
            return [fold(row, device=self.grid[r][0]) for r, row in enumerate(slots)]

        return self._collect(i, j, part, combine)[i].to(self.grid[i][j])

    def data_sum(self, i: int, j: int, parts: list) -> list:
        """Σ over the data axes of each of ``parts``, in the column group
        of shard ``(i, j)`` (across processes where the axes span them)."""
        def combine(slots):
            return [[fold([slots[r][c][k] for r in range(len(slots))],
                          self.mesh, self.data_axes, self.grid[0][c])
                     for k in range(len(parts))]
                    for c in range(len(slots[0]))]

        return [t.to(self.grid[i][j]) for t in self._collect(i, j, parts, combine)[j]]


def _cut_features(feats, lo: int, width: int, dev):
    """Shard ``[lo, lo + width)`` of one row block's features on ``dev``."""
    from photon_tpu_torch.data.batch import DenseFeatures, SparseFeatures

    if isinstance(feats, SparseFeatures):
        li, lv = _column_cut(feats.idx.long(), feats.val, lo, width)
        return SparseFeatures(idx=li.to(dev), val=lv.to(dev),
                              dim=width).with_accelerator_paths()
    if isinstance(feats, DenseFeatures):
        return DenseFeatures(feats.x[:, lo:lo + width].contiguous().to(dev))
    raise TypeError(f"unknown feature container {type(feats)}")


def fit_model_parallel(problem, batch, w0: Tensor, mesh,
                       data_axis=DATA_AXIS, model_axis: str = MODEL_AXIS,
                       normalization=None):
    """The whole solve with coefficients sharded over ``model_axis`` and
    rows over ``data_axis`` (one axis or a tuple). ``problem`` carries the
    ``reg_mask`` and the prior. Returns ``(GeneralizedLinearModel,
    OptimizerResult)`` with full-length coefficients on the mesh's first
    device."""
    from photon_tpu_torch.data.batch import DenseFeatures, SparseFeatures
    from photon_tpu_torch.models.coefficients import Coefficients
    from photon_tpu_torch.models.glm import GeneralizedLinearModel
    from photon_tpu_torch.ops.losses import loss_for_task
    from photon_tpu_torch.optim import LBFGS, OWLQN, TRON, OptimizerType

    if problem.optimizer_type not in (OptimizerType.LBFGS, OptimizerType.OWLQN,
                                      OptimizerType.TRON):
        raise ValueError(
            "model-parallel training supports LBFGS, OWLQN, and TRON "
            f"(got {problem.optimizer_type.name})")
    if problem.variance_type.name == "FULL":
        raise ValueError(
            "model-parallel training computes NONE/SIMPLE variances only "
            "(FULL materializes a DxD Hessian)")
    if normalization is not None and normalization.is_identity:
        normalization = None
    if normalization is not None and problem.prior is not None:
        raise ValueError(
            "model-parallel training does not combine a normalization "
            "context with an incremental-training prior")
    l2 = problem.regularization.l2_weight(problem.reg_weight)
    l1 = problem.regularization.l1_weight(problem.reg_weight)
    if l1 > 0.0 and problem.optimizer_type != OptimizerType.OWLQN:
        raise ValueError(
            f"{problem.regularization.reg_type.name} regularization requires "
            f"OptimizerType.OWLQN, got {problem.optimizer_type.name}")

    data_axes = axis_tuple(data_axis)
    grid = _shard_grid(mesh, data_axes, model_axis)
    n_data = axes_size(mesh, data_axes)
    n_model = mesh.shape[model_axis]
    d = batch.dim
    d_pad = -d % n_model
    d_full = d + d_pad
    shard_d = d_full // n_model
    dt = w0.dtype
    src = batch.labels.device

    # Rows: padded to the data axes' size with weight-0 rows at the ghost
    # column, then this process's block of them, cut into its row blocks.
    n_rows = -(-batch.n_rows // n_data) * n_data
    first, n_mine = 0, n_rows
    if spans_processes(mesh, data_axes):
        n_mine = n_rows // mesh.processes
        first = mesh.rank * n_mine
    r = n_mine // len(grid)

    def rows(a: Tensor, fill) -> Tensor:
        pad = n_rows - a.shape[0]
        if pad:
            a = torch.cat([a, a.new_full((pad,) + tuple(a.shape[1:]), fill)])
        return a[first:first + n_mine]

    feats = batch.features
    if isinstance(feats, SparseFeatures):
        # The ghost column moves from d to d_full: no block owns it.
        idx = rows(torch.where(feats.idx >= d, d_full, feats.idx.long()), d_full)
        val = rows(feats.val, 0)
        block_feats = [SparseFeatures(idx=idx[b * r:(b + 1) * r],
                                      val=val[b * r:(b + 1) * r], dim=d_full)
                       for b in range(len(grid))]
    elif isinstance(feats, DenseFeatures):
        x = rows(torch.nn.functional.pad(feats.x, (0, d_pad)), 0)
        block_feats = [DenseFeatures(x[b * r:(b + 1) * r]) for b in range(len(grid))]
    else:  # pragma: no cover - the union is closed
        raise TypeError(f"unknown feature container {type(feats)}")
    labels, offsets, weights = (rows(batch.labels, 0), rows(batch.offsets, 0),
                                rows(batch.weights, 0))

    def padded(v: Tensor, fill: float) -> Tensor:
        v = v.to(device=src, dtype=dt)
        return torch.cat([v, v.new_full((d_pad,), fill)]) if d_pad else v

    w0p = padded(w0, 0.0)
    mask = (padded(problem.reg_mask, 0.0) if problem.reg_mask is not None
            else padded(torch.ones(d, dtype=dt, device=src), 1.0))
    prior = problem.prior
    if prior is not None:
        prior = dataclasses.replace(prior, means=padded(prior.means, 0.0),
                                    precisions=padded(prior.precisions, 0.0))
    norm_f = norm_s = onehot = None
    if normalization is not None:
        nf, ns = normalization._effective()
        if nf is not None:
            norm_f = padded(nf, 1.0)
        if ns is not None:
            norm_s = padded(ns, 0.0)
            onehot = torch.zeros(d_full, dtype=dt, device=src)
            onehot[normalization.intercept_index] = 1.0
    use_norm = norm_f is not None or norm_s is not None

    loss = loss_for_task(problem.task)
    cfg = problem.optimizer_config
    ls = _Lockstep(grid, mesh, data_axes)

    def program(i: int, j: int):
        dev = grid[i][j]
        lo = j * shard_d

        def block(v):
            return None if v is None else v[lo:lo + shard_d].to(dev)

        f = _cut_features(block_feats[i], lo, shard_d, dev)
        y, off, wt = (a[i * r:(i + 1) * r].to(dev) for a in (labels, offsets, weights))
        lam, f_sh, s_sh, oh_sh = l2 * block(mask), block(norm_f), block(norm_s), block(onehot)
        prior_sh = (None if prior is None else dataclasses.replace(
            prior, means=block(prior.means), precisions=block(prior.precisions)))

        def msum(part: Tensor) -> Tensor:
            return ls.model_sum(i, j, part)

        def dot(a: Tensor, b: Tensor) -> Tensor:
            return msum(torch.sum(a * b, dim=-1))

        def margins(ws: Tensor) -> Tensor:
            return msum(f.matvec(ws))

        # The normalization's coefficient maps: elementwise on the shard,
        # the shift's scalar one model fold.
        #   to_original:  w = (I − e·sᵀ)·F·w'      (e = intercept one-hot)
        #   pullback:     ∇w' = F·(∇w − s·(eᵀ∇w))
        def to_original(wp: Tensor) -> Tensor:
            out = wp if f_sh is None else wp * f_sh
            if s_sh is not None:
                out = out - oh_sh * msum(torch.sum(out * s_sh))
            return out

        def pullback(g: Tensor) -> Tensor:
            if s_sh is not None:
                g = g - s_sh * msum(torch.sum(oh_sh * g))
            return g if f_sh is None else g * f_sh

        def to_transformed(w: Tensor) -> Tensor:
            if s_sh is not None:
                w = w + oh_sh * msum(torch.sum(w * s_sh))
            return w if f_sh is None else w / f_sh

        def vg(ws: Tensor):
            # The data term at the original-space point, the penalty on
            # the coefficients the optimizer sees (reference semantics).
            w_orig = to_original(ws) if use_norm else ws
            z = margins(w_orig) + off
            lv = torch.sum(wt * loss.loss(z, y))
            lv, g = ls.data_sum(i, j, [lv, f.rmatvec(wt * loss.d1(z, y))])
            if use_norm:
                g = pullback(g)
            lv = lv + msum(0.5 * torch.sum(lam * ws * ws))
            g = g + lam * ws
            if prior_sh is not None:
                lv = lv + msum(prior_sh.value(ws))
                g = g + prior_sh.gradient(ws)
            return lv, g

        def hvp_at(ws: Tensor):
            # H'v = Jᵀ(Xᵀ D X)(Jv) + λv (+ the prior's precisions), J the
            # normalization's linear map; margins and curvature once a point.
            w_orig = to_original(ws) if use_norm else ws
            d2w = wt * loss.d2(margins(w_orig) + off, y)

            def hv(v: Tensor) -> Tensor:
                zv = margins(to_original(v) if use_norm else v)
                (out,) = ls.data_sum(i, j, [f.rmatvec(d2w * zv)])
                if use_norm:
                    out = pullback(out)
                out = out + lam * v
                if prior_sh is not None:
                    out = out + prior_sh.hessian_vector(v)
                return out

            return hv

        w_start = block(w0p)
        if use_norm:
            w_start = to_transformed(w_start)
        if problem.optimizer_type == OptimizerType.OWLQN:
            result = OWLQN(cfg, dot=dot).optimize(vg, w_start, l1 * block(mask))
        elif problem.optimizer_type == OptimizerType.TRON:
            result = TRON(cfg, dot=dot).optimize(vg, w_start, hvp_at)
        else:
            result = LBFGS(cfg, dot=dot).optimize(vg, w_start)
        x_orig = to_original(result.x) if use_norm else result.x
        variances = None
        if problem.variance_type.name == "SIMPLE":
            # 1 / diag H of the trained objective; under normalization the
            # original-space penalty is λ/f².
            d2 = wt * loss.d2(margins(x_orig) + off, y)
            (diag,) = ls.data_sum(i, j, [f.sq_rmatvec(d2)])
            diag = diag + (lam if f_sh is None else lam / (f_sh * f_sh))
            if prior_sh is not None:
                diag = diag + prior_sh.hessian_diagonal()
            variances = 1.0 / torch.clamp(diag, min=1e-12)
        return x_orig, variances, result

    out = _run_programs(grid, ls, program)
    head = grid[0][0]
    x = torch.cat([out[0][j][0].to(head) for j in range(n_model)])[:d]
    variances = None
    if problem.variance_type.name == "SIMPLE":
        variances = torch.cat([out[0][j][1].to(head) for j in range(n_model)])[:d]
    result = dataclasses.replace(out[0][0][2], x=x)
    model = GeneralizedLinearModel(Coefficients(means=x, variances=variances),
                                   problem.task)
    return model, result


def _run_programs(grid: list, ls: _Lockstep, program) -> list:
    """``program(i, j)`` for every shard, each in its own thread (on its
    card, where the shard is on one); returns ``out[i][j]``, or raises the
    first program's error."""
    out = [[None] * len(grid[0]) for _ in grid]
    errors: list = []

    def run(i: int, j: int) -> None:
        dev = grid[i][j]
        try:
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    out[i][j] = program(i, j)
            else:
                out[i][j] = program(i, j)
        except threading.BrokenBarrierError:
            pass  # another program failed and aborted the barrier
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller
            errors.append(e)
            ls.barrier.abort()

    threads = [threading.Thread(target=run, args=(i, j), daemon=True,
                                name=f"photon-model-shard-{i}-{j}")
               for i in range(len(grid)) for j in range(len(grid[0]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out
