"""Random-effect datasets: per-entity data, bucketed and padded.

Port of ``photon_tpu/data/random_effect.py`` (the scoring half:
``EntityBucket.scores``, ``RandomEffectDataset.scatter_scores`` and
``build_random_effect_dataset`` as scoring calls it — every entity kept, no
active/passive split, no Pearson feature filter; those come with the
training slice).

Entities are grouped on the host and packed into buckets of identical
padded shape ``[E, S, K]`` (entities x max-samples x max-nnz), quantized to
powers of two. Each entity sees only the feature columns present in its own
rows: global ELL indices are remapped to a compact local space ``[0, P)``;
``proj[e, p]`` maps local slot p back to the global column (``global_dim``
for pad slots, the global ghost column). The bucket order, entity order and
padding match the JAX builder exactly, so bucket arrays compare equal.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

Tensor = torch.Tensor


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch floating dtype (float32 / float64)."""
    return np.dtype(str(dtype).removeprefix("torch."))


@dataclasses.dataclass(frozen=True)
class EntityBucket:
    """One padded bucket of entities with identical [E, S, K, P] shapes.

    ``idx``/``val`` are per-entity ELL in *local* feature space (ghost column
    = P). ``proj`` maps local→global columns (ghost slots hold
    ``global_dim``). ``row_ids`` maps each (entity, sample) slot back to the
    global row it came from (padding slots hold the global row count N, a
    ghost row). ``weights`` masks valid rows. ``entity_ids`` are dense REIds
    (padding: -1).
    """

    idx: Tensor           # [E, S, K] int32, local column ids
    val: Tensor           # [E, S, K]
    labels: Tensor        # [E, S]
    weights: Tensor       # [E, S] — 0 marks padded rows
    row_ids: Tensor       # [E, S] int32 into the global sample order; N = pad
    proj: Tensor          # [E, P] int32 local→global column map; dim = pad
    entity_ids: Tensor    # [E] int32 dense entity ids; -1 = padded entity

    @property
    def n_entities(self) -> int:
        return self.idx.shape[0]

    def scores(self, coefs: Tensor) -> Tensor:
        """Per-slot scores [E, S] from per-entity coefficients [E, P]
        (offsets NOT included — GAME composes scores additively)."""
        e = self.n_entities
        ext = torch.cat([coefs, coefs.new_zeros(e, 1)], dim=1)
        gathered = torch.gather(ext, 1, self.idx.reshape(e, -1).long())
        return (gathered.reshape(self.idx.shape) * self.val).sum(dim=-1)


@dataclasses.dataclass(frozen=True)
class RandomEffectDataset:
    """All buckets for one random-effect coordinate + host-side entity index.

    ``entity_to_slot`` maps dense REId → (bucket_index, lane); ``n_rows`` is
    the global sample count the ``row_ids`` refer to.
    """

    re_type: str
    buckets: Sequence[EntityBucket]
    entity_keys: Sequence             # dense REId -> original key
    entity_to_slot: dict              # dense REId -> (bucket, lane)
    n_rows: int
    global_dim: int
    device: torch.device

    def scatter_scores(
        self, per_bucket_scores: Sequence[Tensor], dtype: torch.dtype
    ) -> Tensor:
        """Assemble a global [n_rows] score vector from per-bucket [E, S]
        scores: an indexed copy into n_rows + 1 slots, whose last slot (the
        ghost row every padding slot points at) is dropped."""
        out = torch.zeros(self.n_rows + 1, dtype=dtype, device=self.device)
        for b, s in zip(self.buckets, per_bucket_scores):
            out.index_put_((b.row_ids.reshape(-1).long(),), s.reshape(-1).to(dtype))
        return out[: self.n_rows]


def build_random_effect_dataset(
    re_type: str,
    entity_keys_per_row: np.ndarray,
    idx: np.ndarray,
    val: np.ndarray,
    labels: np.ndarray,
    global_dim: int,
    weights: Optional[np.ndarray] = None,
    intercept_index: Optional[int] = None,
    *,
    dtype: torch.dtype,
    device: torch.device,
) -> RandomEffectDataset:
    """Host-side builder for a scoring dataset: group rows by entity,
    project features, bucket and pad, then place the buckets on ``device``.

    Inputs are global ELL arrays (``idx[N, K]`` with ghost == ``global_dim``)
    plus one entity key per row; every entity is kept.
    ``intercept_index``, when given, is force-included in every entity's
    subspace. Each size class makes one bucket.

    Vectorized over entities as the JAX builder is: per-entity subspaces
    come from uniques over (entity, column) pair keys, the local remap is a
    ``searchsorted`` against those keys, and bucket packing is flat
    fancy-index writes.
    """
    np_dt = numpy_dtype(dtype)
    n, k = idx.shape
    idx = np.asarray(idx)
    val = np.asarray(val)
    labels = np.asarray(labels, np_dt)
    weights = np.ones(n, np_dt) if weights is None else np.asarray(weights, np_dt)

    keys, inv = np.unique(entity_keys_per_row, return_inverse=True)
    inv = inv.reshape(-1).astype(np.int64)
    e_count = len(keys)
    if e_count == 0:
        return RandomEffectDataset(
            re_type=re_type, buckets=(), entity_keys=[], entity_to_slot={},
            n_rows=n, global_dim=global_dim, device=device,
        )
    dense_e = inv                                # [n] dense entity id
    counts = np.bincount(inv, minlength=e_count)  # [E] rows per entity

    # ---- per-entity column subspaces: distinct (entity, column) pairs,
    # found chunk by chunk so the temporaries stay bounded by a chunk.
    stride = global_dim + 1
    chunk_rows_ = max(1, min(n, 1 << 22))
    uniq_parts = []
    if intercept_index is not None:
        uniq_parts.append(
            np.arange(e_count, dtype=np.int64) * stride + intercept_index)
    nz_per_ent = np.zeros(e_count, np.int64)
    entry_pos_parts, ok_parts = [], []
    for lo in range(0, n, chunk_rows_):
        hi = min(lo + chunk_rows_, n)
        ee_c = np.repeat(dense_e[lo:hi], k)
        fi_c = idx[lo:hi].ravel().astype(np.int64)
        ok_c = fi_c < global_dim
        uniq_parts.append(_sorted_unique(ee_c[ok_c] * stride + fi_c[ok_c]))
        if intercept_index is None:  # counts only feed the empty-entity fix
            nz_per_ent += np.bincount(ee_c[ok_c], minlength=e_count)
    if intercept_index is None:
        # entities with no real entries still need a 1-column subspace ([0])
        empty = np.flatnonzero(nz_per_ent == 0)
        if len(empty):
            uniq_parts.append(empty.astype(np.int64) * stride)
    upairs = _sorted_unique(np.concatenate(uniq_parts))
    del uniq_parts
    ent_of_col = upairs // stride

    # each real entry's rank in upairs (its column's slot), chunked
    for lo in range(0, n, chunk_rows_):
        hi = min(lo + chunk_rows_, n)
        ee_c = np.repeat(dense_e[lo:hi], k)
        fi_c = idx[lo:hi].ravel().astype(np.int64)
        ok_c = fi_c < global_dim
        pairs_c = ee_c[ok_c] * stride + fi_c[ok_c]
        entry_pos_parts.append(np.searchsorted(upairs, pairs_c).astype(np.int32))
        ok_parts.append(ok_c)
    entry_pos = np.concatenate(entry_pos_parts)
    entry_ok = np.concatenate(ok_parts)
    del entry_pos_parts, ok_parts
    ee = np.repeat(dense_e.astype(np.int32), k)    # entity per ELL entry

    ncols = np.bincount(ent_of_col, minlength=e_count).astype(np.int64)
    col_off = np.zeros(e_count + 1, np.int64)
    np.cumsum(ncols, out=col_off[1:])

    # ---- local remap
    local_flat = ncols[ee].astype(np.int32)          # default: local ghost
    ok_ix = np.flatnonzero(entry_ok)
    local_flat[ok_ix] = (entry_pos - col_off[ee[ok_ix]]).astype(np.int32)
    local = local_flat.reshape(n, k)
    hit = np.zeros(n * k, bool)
    hit[ok_ix] = True
    val_eff = np.where(hit.reshape(n, k), val, 0.0).astype(val.dtype)

    # ---- bucket by (pow2 samples, pow2 local dim); dense ids in
    # (bucket-sorted, then ascending-entity) order
    s_pad_e = _next_pow2_vec(counts)
    p_pad_e = _next_pow2_vec(ncols)
    ent_sort = np.lexsort((np.arange(e_count), p_pad_e, s_pad_e))
    dense_of = np.empty(e_count, np.int64)
    dense_of[ent_sort] = np.arange(e_count)          # entity -> dense id

    sp_sorted = np.stack([s_pad_e[ent_sort], p_pad_e[ent_sort]], axis=1)
    bucket_break = np.any(np.diff(sp_sorted, axis=0) != 0, axis=1)
    bucket_starts = np.concatenate(
        [[0], np.flatnonzero(bucket_break) + 1, [e_count]])

    # rows re-sorted by dense id (stable keeps original row order per entity)
    row_dense = dense_of[dense_e]
    row_order = np.argsort(row_dense, kind="stable")
    rcounts = counts[ent_sort]                        # rows per dense id
    rstarts = np.zeros(e_count + 1, np.int64)
    np.cumsum(rcounts, out=rstarts[1:])
    within_row = np.arange(len(row_order)) - rstarts[row_dense[row_order]]

    # column entries re-sorted by dense id
    col_dense = dense_of[ent_of_col]
    col_order = np.argsort(col_dense, kind="stable")
    ccounts = ncols[ent_sort]
    cstarts = np.zeros(e_count + 1, np.int64)
    np.cumsum(ccounts, out=cstarts[1:])
    within_col = np.arange(len(col_order)) - cstarts[col_dense[col_order]]
    cols_flat = upairs % stride

    def put(a: np.ndarray) -> Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    buckets = []
    entity_keys_out = list(keys[ent_sort])
    entity_to_slot = {}
    for mb, me in zip(bucket_starts[:-1], bucket_starts[1:]):
        ecount = int(me - mb)
        s_pad = int(sp_sorted[mb, 0])
        p_pad = int(sp_sorted[mb, 1])
        b_idx = np.full((ecount, s_pad, k), p_pad, np.int32)
        b_val = np.zeros((ecount, s_pad, k), np_dt)
        b_lab = np.zeros((ecount, s_pad), np_dt)
        b_w = np.zeros((ecount, s_pad), np_dt)
        b_rows = np.full((ecount, s_pad), n, np.int32)
        b_proj = np.full((ecount, p_pad), global_dim, np.int32)

        rsl = slice(rstarts[mb], rstarts[me])
        rows_b = row_order[rsl]                       # original row ids
        lane_r = row_dense[rows_b] - mb
        wr = within_row[rsl]
        b_idx[lane_r, wr] = local[rows_b]
        b_val[lane_r, wr] = val_eff[rows_b]
        b_lab[lane_r, wr] = labels[rows_b]
        b_w[lane_r, wr] = weights[rows_b]
        b_rows[lane_r, wr] = rows_b

        csl = slice(cstarts[mb], cstarts[me])
        centries = col_order[csl]
        b_proj[col_dense[centries] - mb, within_col[csl]] = cols_flat[centries]

        bi = len(buckets)
        for lane in range(ecount):
            entity_to_slot[int(mb + lane)] = (bi, lane)
        buckets.append(EntityBucket(
            idx=put(b_idx), val=put(b_val), labels=put(b_lab),
            weights=put(b_w), row_ids=put(b_rows), proj=put(b_proj),
            entity_ids=put(np.arange(mb, me, dtype=np.int32)),
        ))

    return RandomEffectDataset(
        re_type=re_type,
        buckets=tuple(buckets),
        entity_keys=entity_keys_out,
        entity_to_slot=entity_to_slot,
        n_rows=n,
        global_dim=global_dim,
        device=device,
    )


def _sorted_unique(a: np.ndarray) -> np.ndarray:
    """Sorted distinct values of a 1-D integer array, by one sort. (NumPy
    2.3+ ``np.unique`` hashes first, which is an order of magnitude slower
    when most of millions of values are distinct, as (entity, column) pairs
    are.)"""
    s = np.sort(a)
    if len(s) < 2:
        return s
    keep = np.empty(len(s), bool)
    keep[0] = True
    np.not_equal(s[1:], s[:-1], out=keep[1:])
    return s[keep]


def _next_pow2_vec(x: np.ndarray) -> np.ndarray:
    x = np.maximum(np.asarray(x, np.int64), 1)
    return 1 << np.ceil(np.log2(x)).astype(np.int64)
