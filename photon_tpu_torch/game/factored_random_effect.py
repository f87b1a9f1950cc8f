"""Factored random effects: per-entity models in a learned latent space.

Port of ``photon_tpu/game/factored_random_effect.py``. Each entity's
coefficients are ``w_e = P · β_e`` with a SHARED projection ``P [D, p]`` and
per-entity latent vectors ``β_e [p]``; training alternates

  1. latent step — every entity's ``β_e`` against its rows projected through
     the current ``P``: one batched dense lane solve per bucket
     (``GLMOptimizationProblem.run_lanes`` over ``DenseLaneFeatures``, the
     counterpart of JAX's ``jax.vmap(problem.run)``), and
  2. projection step — ``P`` refit against the pooled data with every
     ``β_e`` fixed: one L-BFGS solve over ``vec(P)``.

The JAX package differentiates the projection step through the gather
``P_ext[bucket.proj][idx]``; the port writes the objective and its gradient
out through its sparse data passes instead. Each bucket is one
``SparseFeatures`` over GLOBAL columns (``bucket_design``: row ``e·S + s``,
column ``proj[e, idx[e, s, k]]``, local ghosts at the ghost column ``D``),
so with ``Xp[:, j] = A·P[:, j]`` the margins are ``z = Σ_j β_e[j]·Xp[:, j] +
offsets`` and ``∂/∂P[:, j] = Aᵀ(w ⊙ ℓ'(z) ⊙ β_{e(row)}[j]) + λ·P[:, j]``: ``p``
matvecs and ``p`` transposes a bucket per evaluation, on CUDA the kernels
``ell_matvec`` / ``ell_panel_matvec`` and ``csc_rmatvec`` (float64 sums, an
order fixed by the layout, no float atomics: an evaluation repeats bit for
bit). The latent features come from the same matvecs.

The start is spectral: one plain per-entity fit, then the top-``p``
``scipy.sparse.linalg.svds`` of its coefficients with the JAX package's
seeded start vector: ARPACK on the host, the coefficient matrix's products
through the port's sparse passes on the dataset's device (``svds`` over
scipy's own host products took 82% of a factored fit at 100,000 entities).
The final model also carries the EFFECTIVE per-entity coefficients
``P_local · β_e`` as a plain
:class:`RandomEffectModel`, so scoring, validation and export reuse the
random-effect machinery. Host-resident datasets upload their buckets once
per training call and hold them on the device for its length.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from photon_tpu_torch.data.batch import DenseLaneFeatures, LabeledBatch, SparseFeatures
from photon_tpu_torch.data.random_effect import EntityBucket, RandomEffectDataset
from photon_tpu_torch.functions.problem import GLMOptimizationProblem
from photon_tpu_torch.game.random_effect import RandomEffectModel, train_random_effects
from photon_tpu_torch.ops.losses import loss_for_task
from photon_tpu_torch.optim import LBFGS, OptimizerResult
from photon_tpu_torch.types import TaskType

Tensor = torch.Tensor


def _host(t: Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@dataclasses.dataclass(frozen=True)
class FactoredRandomEffectModel:
    """``w_e = P · β_e`` plus the materialized effective RE model.

    ``effective`` carries the per-entity coefficients in each entity's local
    subspace and serves every scoring and export path; ``projection`` and
    ``bucket_latent`` are kept for warm-starting further factored training.
    """

    re_type: str
    task: TaskType
    projection: Tensor                  # [D, p]
    bucket_latent: Sequence[Tensor]     # per bucket: [E, p]
    effective: RandomEffectModel

    @property
    def latent_dim(self) -> int:
        return self.projection.shape[1]

    @property
    def n_entities(self) -> int:
        return self.effective.n_entities

    def score_dataset(self, dataset: RandomEffectDataset) -> Tensor:
        return self.effective.score_dataset(dataset)

    def score_new_dataset(self, dataset: RandomEffectDataset) -> Tensor:
        return self.effective.score_new_dataset(dataset)

    def coefficients_for(self, entity_key) -> tuple[np.ndarray, np.ndarray]:
        """(global indices, effective coefficients) of one entity."""
        gi, gv, _ = self.effective.export_for(entity_key)
        return gi, gv


def bucket_design(bucket: EntityBucket, global_dim: int) -> SparseFeatures:
    """The bucket's rows over GLOBAL columns, as one ``SparseFeatures``:
    entity e's sample s is row e·S + s, and its entry (s, k) sits in column
    ``proj[e, idx[e, s, k]]``; local ghosts, and local slots that map to no
    global column, go to the ghost column ``global_dim`` with value 0. On
    CUDA its matvec and transpose layouts are attached."""
    e, s, k = bucket.idx.shape
    proj_ext = torch.cat(
        [bucket.proj, bucket.proj.new_full((e, 1), global_dim)], dim=1)
    cols = torch.gather(proj_ext, 1, bucket.idx.reshape(e, s * k).long())
    vals = bucket.val.reshape(e, s * k)
    vals = torch.where(cols < global_dim, vals, torch.zeros_like(vals))
    return SparseFeatures(
        idx=cols.reshape(e * s, k).to(torch.int32).contiguous(),
        val=vals.reshape(e * s, k).contiguous(),
        dim=global_dim).with_layouts()


def _designs(dataset: RandomEffectDataset,
             buckets: Sequence[EntityBucket]) -> list[SparseFeatures]:
    """Every bucket's global-column design: built once per bucket of the
    prepared data (kept beside its lane layouts), or, for a host-resident
    dataset, for this training call only."""
    out = []
    for b, bucket in enumerate(buckets):
        if bucket is not dataset.buckets[b]:
            out.append(bucket_design(bucket, dataset.global_dim))
            continue
        hit = dataset.lane_layouts.get(("factored", b))
        if hit is None or hit[0] is not bucket.idx:
            hit = (bucket.idx, bucket_design(bucket, dataset.global_dim))
            dataset.lane_layouts[("factored", b)] = hit
        out.append(hit[1])
    return out


def _project_bucket_features(P: Tensor, bucket: EntityBucket,
                             design: SparseFeatures) -> Tensor:
    """Latent features ``Xp[e, s, :] = Σ_k val[e,s,k] · P[col(e,s,k), :]``
    (``[E, S, p]``): one matvec of the bucket's global-column ``design`` a
    latent column (ghost entries contribute nothing)."""
    e, s = bucket.labels.shape
    pt = P.T.contiguous()
    return torch.stack([design.matvec(pt[j]) for j in range(P.shape[1])],
                       dim=-1).reshape(e, s, P.shape[1])


def _latent_step(problem: GLMOptimizationProblem, P: Tensor, bucket: EntityBucket,
                 design: SparseFeatures, offsets: Tensor, b0: Tensor):
    """Every latent vector of one bucket: one lane solve a entity over its
    projected rows."""
    base = bucket.local_batches(offsets)
    batch = LabeledBatch(
        features=DenseLaneFeatures(_project_bucket_features(P, bucket, design)),
        labels=base.labels, offsets=base.offsets, weights=base.weights)
    model, result = problem.run_lanes(batch, b0)
    return model.coefficients.means, result


def projection_value_and_grad(problem: GLMOptimizationProblem,
                              buckets: Sequence[EntityBucket],
                              designs: Sequence[SparseFeatures],
                              offsets: Tensor, lats: Sequence[Tensor],
                              shape: tuple[int, int]):
    """``vec(P) ↦ (value, grad)`` of the projection step with every β fixed:
    Σ over buckets of Σ w·ℓ(z, y), plus λ/2‖P‖², with its gradient written
    out (``p`` matvecs and ``p`` transposes a bucket)."""
    loss = loss_for_task(problem.task)
    lam = problem.regularization.l2_weight(problem.reg_weight)
    d, p = shape
    # Loop-invariant: the offset gather depends only on (buckets, offsets).
    bases = [b.local_batches(offsets) for b in buckets]

    def value_and_grad(p_flat: Tensor) -> tuple[Tensor, Tensor]:
        P = p_flat.reshape(shape)
        total = p_flat.new_zeros(())
        grad_t = p_flat.new_zeros((p, d))
        for bucket, design, base, beta in zip(buckets, designs, bases, lats):
            xp = _project_bucket_features(P, bucket, design)
            z = torch.bmm(xp, beta.unsqueeze(-1)).squeeze(-1) + base.offsets
            total = total + torch.sum(base.weights * loss.loss(z, base.labels))
            dz = base.weights * loss.d1(z, base.labels)
            for j in range(p):
                grad_t[j] += design.rmatvec((dz * beta[:, j:j + 1]).reshape(-1))
        value = total + 0.5 * lam * torch.sum(p_flat * p_flat)
        return value, grad_t.T.reshape(-1) + lam * p_flat

    return value_and_grad


def _projection_step(problem: GLMOptimizationProblem, n_iter: int, P: Tensor,
                     buckets, designs, offsets: Tensor, lats):
    """Refit ``P`` with every β fixed: L-BFGS over vec(P)."""
    vg = projection_value_and_grad(problem, buckets, designs, offsets, lats,
                                   tuple(P.shape))
    cfg = dataclasses.replace(problem.optimizer_config, max_iterations=n_iter)
    result = LBFGS(cfg).optimize(vg, P.reshape(-1))
    return result.x.reshape(P.shape), result


def _spectral_init(
    problem: GLMOptimizationProblem,
    dataset: RandomEffectDataset,
    offsets: Tensor,
    latent_dim: int,
    seed: int,
) -> tuple[Tensor, list[Tensor]]:
    """(P0, β0) from the top-``latent_dim`` SVD of the plain per-entity fit.

    The plain coefficients form a sparse [E, D] matrix (each entity's local
    subspace scattered to global columns); ``W ≈ U S Vᵀ`` gives ``P0 = V``
    (orthonormal) and ``β0 = U S`` — the best rank-p summary of what
    unconstrained per-entity fits learned.
    """
    if not dataset.buckets:
        return (torch.zeros((dataset.global_dim, latent_dim), dtype=torch.float64,
                            device=dataset.device), [])
    plain, _ = train_random_effects(problem, dataset, offsets)
    return _factor_model(plain, dataset, latent_dim, seed)


def coefficient_operator(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                         shape: tuple[int, int], device: torch.device):
    """The sparse matrix ``W`` of these (row, column, value) entries (each
    pair at most once) as a scipy ``LinearOperator`` whose products are the
    port's data passes over ``W``'s rows in float64 on ``device``: ``W·x``
    a matvec and ``Wᵀ·y`` a transpose (the kernels on CUDA, their plain
    versions on the CPU; the vectors cross to the host and back each
    product)."""
    from scipy.sparse.linalg import LinearOperator

    n, d = shape
    order = np.lexsort((cols, rows))
    r, c, v = rows[order], cols[order], vals[order]
    counts = np.bincount(r, minlength=n)
    width = max(int(counts.max(initial=0)), 1)
    slot = np.arange(r.size) - np.repeat(np.cumsum(counts) - counts, counts)
    idx = np.full((n, width), d, np.int32)
    val = np.zeros((n, width))
    idx[r, slot], val[r, slot] = c, v
    feats = SparseFeatures(torch.from_numpy(idx).to(device),
                           torch.from_numpy(val).to(device), d).with_layouts()

    def on_device(x) -> Tensor:
        return torch.from_numpy(
            np.ascontiguousarray(np.asarray(x, np.float64).reshape(-1))).to(device)

    return LinearOperator(
        shape, dtype=np.float64,
        matvec=lambda x: feats.matvec(on_device(x)).cpu().numpy(),
        rmatvec=lambda y: feats.rmatvec(on_device(y)).cpu().numpy())


def _factor_model(
    source: RandomEffectModel,
    dataset: RandomEffectDataset,
    latent_dim: int,
    seed: int,
) -> tuple[Tensor, list[Tensor]]:
    """Top-p SVD of ``source``'s sparse per-entity coefficients, with β rows
    matched to ``dataset``'s entities BY KEY (entities the source never saw
    start at 0). Used both for the spectral init and for re-factoring a
    loaded effective model (whose coefficient matrix is exactly rank-p).
    ARPACK runs on the host (scipy ``svds``, the seeded start vector of the
    JAX package) over ``coefficient_operator``: W's products in float64
    on the dataset's device. (P0, β0) come back in float64 there."""
    from scipy.sparse.linalg import svds

    rows, cols, vals = [], [], []
    for coefs, proj, eids in zip(
        source.bucket_coefs, source.bucket_proj, source.bucket_entity_ids
    ):
        c = _host(coefs).astype(np.float64)
        p = _host(proj)
        e = _host(eids)
        lane_ok = e >= 0
        col_ok = p < dataset.global_dim
        ok = lane_ok[:, None] & col_ok
        rows.append(np.broadcast_to(e[:, None], p.shape)[ok])
        cols.append(p[ok])
        vals.append(c[ok])
    n_src = source.n_entities
    W = coefficient_operator(np.concatenate(rows), np.concatenate(cols),
                             np.concatenate(vals), (n_src, source.global_dim),
                             dataset.device)
    k = min(latent_dim, min(W.shape) - 1)
    P0 = np.zeros((dataset.global_dim, latent_dim))
    B_src = np.zeros((n_src, latent_dim))
    if k >= 1:
        # deterministic ARPACK start vector (svds' random_state plumbing
        # varies across scipy versions)
        v0 = np.random.default_rng(seed).normal(size=min(W.shape))
        u, s, vt = svds(W, k=k, v0=v0)
        order = np.argsort(-s)
        u, s, vt = u[:, order], s[order], vt[order]
        P0[: source.global_dim, :k] = vt.T
        B_src[:, :k] = u * s
    # β rows matched by entity KEY (source == dataset for the fresh-init
    # path, where this reduces to the identity mapping).
    B0 = np.zeros((dataset.n_entities + 1, latent_dim))
    if source.entity_keys is dataset.entity_keys:
        B0[:-1] = B_src                              # fresh-init fast path
    else:
        key_to_src = source._key_to_dense
        for dense_new, key in enumerate(dataset.entity_keys):
            src = key_to_src.get(key)
            if src is not None:
                B0[dense_new] = B_src[src]
    dev = dataset.device
    lats = [
        torch.from_numpy(B0[_host(b.entity_ids)]).to(dev)   # -1 pad -> zero row
        for b in dataset.buckets
    ]
    return torch.from_numpy(P0).to(dev), lats


def train_factored_random_effects(
    problem: GLMOptimizationProblem,
    dataset: RandomEffectDataset,
    offsets: Tensor,
    latent_dim: int = 8,
    n_alternations: int = 2,
    seed: int = 0,
    init=None,
) -> tuple[FactoredRandomEffectModel, list[OptimizerResult]]:
    """Alternating factored-RE training over all buckets; returns the model
    and the final latent step's per-bucket results (per-lane tensors).

    ``problem`` configures both steps (its optimizer config drives the latent
    solves; the projection step reuses its L2 weight and iteration budget).
    ``init`` may be a :class:`FactoredRandomEffectModel` (same structure →
    resume its factors) or a plain :class:`RandomEffectModel` (a loaded
    warm start → its coefficients are re-factored spectrally). ``P`` and β
    take the dtype of the bucket values.
    """
    buckets = [dataset.bucket(i) for i in range(len(dataset.buckets))]
    dtype = buckets[0].val.dtype if buckets else torch.float32
    d = dataset.global_dim
    same_init = (
        isinstance(init, FactoredRandomEffectModel)
        and tuple(init.projection.shape) == (d, latent_dim)
        and len(init.bucket_latent) == len(buckets)
        and all(b.shape[0] == bk.n_entities
                for b, bk in zip(init.bucket_latent, buckets))
    )
    if same_init:
        P, lats = init.projection, list(init.bucket_latent)
    elif isinstance(init, RandomEffectModel) and init.global_dim == d and buckets:
        # Loaded effective model (the saved form of a factored coordinate,
        # or any plain RE warm start): re-factor ITS coefficients instead of
        # refitting the plain solve from scratch.
        P, lats = _factor_model(init, dataset, latent_dim, seed)
    else:
        # Spectral init: one plain per-entity solve, then the top-p SVD of
        # its sparse coefficient matrix seeds (P, β). A Gaussian random P
        # makes the alternation lock onto the random subspace; the plain
        # solution's principal subspace lands in the right basin.
        P, lats = _spectral_init(problem, dataset, offsets, latent_dim, seed)
    dev = dataset.device
    P = P.to(device=dev, dtype=dtype)
    lats = [b.to(device=dev, dtype=dtype) for b in lats]
    designs = _designs(dataset, buckets)

    def latent_steps() -> list[OptimizerResult]:
        results = []
        for i, bucket in enumerate(buckets):
            lats[i], res = _latent_step(problem, P, bucket, designs[i], offsets,
                                        lats[i])
            results.append(res)
        return results

    for _ in range(max(1, n_alternations)):
        latent_steps()
        P, _ = _projection_step(problem, problem.optimizer_config.max_iterations,
                                P, buckets, designs, offsets, lats)
    # Final latent refresh so β is optimal for the returned P.
    results = latent_steps()

    # Effective per-entity coefficients in each local subspace.
    P_ext = torch.cat([P, P.new_zeros((1, P.shape[1]))])
    eff_coefs = [
        torch.bmm(P_ext[b.proj.long()], lat.unsqueeze(-1)).squeeze(-1)
        for b, lat in zip(buckets, lats)
    ]
    effective = RandomEffectModel(
        re_type=dataset.re_type,
        task=problem.task,
        bucket_coefs=eff_coefs,
        bucket_proj=[b.proj for b in dataset.buckets],
        bucket_entity_ids=[b.entity_ids for b in dataset.buckets],
        entity_keys=dataset.entity_keys,
        entity_to_slot=dataset.entity_to_slot,
        global_dim=dataset.global_dim,
    )
    model = FactoredRandomEffectModel(
        re_type=dataset.re_type,
        task=problem.task,
        projection=P,
        bucket_latent=lats,
        effective=effective,
    )
    return model, results
