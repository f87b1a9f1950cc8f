"""Random-effect datasets: per-entity data, bucketed and padded.

Port of ``photon_tpu/data/random_effect.py``: ``EntityBucket`` (scores and
the per-entity training batches), ``RandomEffectDataset.scatter_scores``,
``pearson_scores`` and ``build_random_effect_dataset`` with its training
options (active/passive split, minimum rows per entity, the Pearson feature
filter and the bucket cap), host-resident buckets (the device sweep
cache's input) and ``down_sample_dataset``.

Entities are grouped on the host and packed into buckets of identical
padded shape ``[E, S, K]`` (entities x max-samples x max-nnz), quantized to
powers of two. Each entity sees only the feature columns present in its own
rows: global ELL indices are remapped to a compact local space ``[0, P)``;
``proj[e, p]`` maps local slot p back to the global column (``global_dim``
for pad slots, the global ghost column). Rows beyond ``active_bound`` per
entity keep their weight for scoring (``weights``) but carry 0 in
``train_weights``: scored, not trained on. The bucket order, entity order
and padding match the JAX builder exactly, so bucket arrays compare equal.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from photon_tpu_torch.data.batch import LabeledBatch, LaneFeatures, SparseFeatures
from photon_tpu_torch.utils import threefry

Tensor = torch.Tensor

# Buckets and bytes uploaded from host-resident datasets (``bucket(b)``),
# for the device sweep cache's measurements.
UPLOADS = {"buckets": 0, "bytes": 0}


def reset_uploads() -> None:
    UPLOADS.update(buckets=0, bytes=0)


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
    ghost row). ``weights`` masks valid rows; ``train_weights`` also zeroes
    passive rows. ``entity_ids`` are dense REIds (padding: -1).
    """

    idx: Tensor           # [E, S, K] int32, local column ids
    val: Tensor           # [E, S, K]
    labels: Tensor        # [E, S]
    weights: Tensor       # [E, S] — 0 marks padded rows
    train_weights: Tensor  # [E, S] — 0 marks padded AND passive rows
    row_ids: Tensor       # [E, S] int32 into the global sample order; N = pad
    proj: Tensor          # [E, P] int32 local→global column map; dim = pad
    entity_ids: Tensor    # [E] int32 dense entity ids; -1 = padded entity

    @property
    def n_entities(self) -> int:
        return self.idx.shape[0]

    @property
    def max_samples(self) -> int:
        return self.idx.shape[1]

    @property
    def local_dim(self) -> int:
        return self.proj.shape[1]

    def local_batches(self, global_offsets: Tensor) -> LabeledBatch:
        """Per-entity batches stacked on axis 0 (``[E, S, ...]`` leaves),
        offsets gathered from the global per-sample offset vector (the ghost
        row gathers 0) and ``train_weights`` as the weights."""
        g = global_offsets.to(self.val.dtype)
        ext = torch.cat([g, g.new_zeros(1)])
        return LabeledBatch(
            features=SparseFeatures(idx=self.idx, val=self.val, dim=self.local_dim),
            labels=self.labels,
            offsets=ext[self.row_ids.long()],
            weights=self.train_weights,
        )

    def to(self, device: torch.device) -> "EntityBucket":
        """This bucket with every array on ``device`` (copied without
        blocking from page-locked host memory)."""
        return EntityBucket(**{
            f.name: getattr(self, f.name).to(device, non_blocking=True)
            for f in dataclasses.fields(self)})

    @property
    def nbytes(self) -> int:
        return sum(getattr(self, f.name).nbytes for f in dataclasses.fields(self))

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
    the global sample count the ``row_ids`` refer to. ``device`` is where
    the solves and scores run; a host-resident dataset keeps its buckets
    in (page-locked) host memory and ``bucket(b)`` uploads one at a time.
    """

    re_type: str
    buckets: Sequence[EntityBucket]
    entity_keys: Sequence             # dense REId -> original key
    entity_to_slot: dict              # dense REId -> (bucket, lane)
    n_rows: int
    global_dim: int
    device: torch.device
    # buckets kept in host memory, uploaded by bucket(b) (or pinned on the
    # device by the sweep cache's mirror)
    host_resident: bool = False
    # bucket index -> (its idx tensor, its LaneFeatures with layouts): built
    # at a bucket's first vmapped solve, shared by every sweep and by the
    # down-sampled copies (which keep idx / val).
    lane_layouts: dict = dataclasses.field(default_factory=dict, compare=False,
                                           repr=False)

    @property
    def n_entities(self) -> int:
        return len(self.entity_keys)

    def bucket(self, b: int) -> EntityBucket:
        """Bucket ``b`` on the dataset's device: the bucket itself, or for a
        host-resident dataset a fresh upload (counted in ``UPLOADS``)."""
        bucket = self.buckets[b]
        if not self.host_resident:
            return bucket
        UPLOADS["buckets"] += 1
        UPLOADS["bytes"] += bucket.nbytes
        return bucket.to(self.device)

    def lane_features(self, b: int,
                      bucket: Optional[EntityBucket] = None) -> LaneFeatures:
        """Bucket ``b`` as one block-diagonal batch of lanes, with its
        accelerator layouts: built once per bucket of the prepared data.
        ``bucket`` is bucket ``b`` on the device where the dataset is
        host-resident (its layouts are then built for this use only)."""
        if bucket is not None and bucket is not self.buckets[b]:
            return LaneFeatures.from_bucket(
                bucket.idx, bucket.val, bucket.local_dim).with_accelerator_paths()
        bucket = self.buckets[b]
        hit = self.lane_layouts.get(b)
        if hit is None or hit[0] is not bucket.idx:
            hit = (bucket.idx, LaneFeatures.from_bucket(
                bucket.idx, bucket.val, bucket.local_dim).with_accelerator_paths())
            self.lane_layouts[b] = hit
        return hit[1]

    def scatter_scores(
        self, per_bucket_scores: Sequence[Tensor], dtype: torch.dtype
    ) -> Tensor:
        """Assemble a global [n_rows] score vector from per-bucket [E, S]
        scores: an indexed copy into n_rows + 1 slots, whose last slot (the
        ghost row every padding slot points at) is dropped."""
        out = torch.zeros(self.n_rows + 1, dtype=dtype, device=self.device)
        for b, s in zip(self.buckets, per_bucket_scores):
            rows = b.row_ids.to(self.device, non_blocking=True)
            out.index_put_((rows.reshape(-1).long(),), s.reshape(-1).to(dtype))
        return out[: self.n_rows]


def down_sample_dataset(dataset: RandomEffectDataset, sampler,
                        key: np.ndarray) -> RandomEffectDataset:
    """Down-sample the training weights of every bucket, bucket i with key
    ``fold_in(key, i)``. Only ``train_weights`` change: scoring weights and
    the active/passive split stay, and zero (padded, passive) slots stay
    zero."""
    buckets = tuple(
        dataclasses.replace(b, train_weights=sampler.down_sample_weights(
            threefry.fold_in(key, i), b.labels, b.train_weights))
        for i, b in enumerate(dataset.buckets))
    return dataclasses.replace(dataset, buckets=buckets)


def pearson_scores(
    local: np.ndarray,
    vals: np.ndarray,
    labels_e: np.ndarray,
    n_cols: int,
) -> np.ndarray:
    """|Pearson correlation| of each local feature column with the label over
    one entity's rows, treating absent entries as 0. Assumes each row
    indexes a column at most once. Zero-variance columns score 0 (the
    intercept is kept by the caller, not through its score)."""
    s = len(labels_e)
    flat = local.ravel()
    keep = flat < n_cols
    cols = flat[keep]
    v = vals.ravel()[keep]
    y_rep = np.repeat(labels_e, local.shape[1])[keep]
    sum_x = np.bincount(cols, weights=v, minlength=n_cols)
    sum_x2 = np.bincount(cols, weights=v * v, minlength=n_cols)
    sum_xy = np.bincount(cols, weights=v * y_rep, minlength=n_cols)
    sum_y = labels_e.sum()
    sum_y2 = (labels_e * labels_e).sum()
    num = s * sum_xy - sum_x * sum_y
    var_x = s * sum_x2 - sum_x * sum_x
    var_y = s * sum_y2 - sum_y * sum_y
    denom = np.sqrt(np.maximum(var_x, 0.0) * max(var_y, 0.0))
    with np.errstate(invalid="ignore", divide="ignore"):
        corr = np.where(denom > 0, np.abs(num) / np.maximum(denom, 1e-30), 0.0)
    return corr


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
    active_bound: Optional[int] = None,
    min_entity_rows: int = 1,
    max_features_per_entity: Optional[int] = None,
    max_bucket_entities: Optional[int] = None,
    host_resident: bool = False,
) -> RandomEffectDataset:
    """Host-side builder: group rows by entity, project features, bucket
    and pad, then place the buckets on ``device``.

    Inputs are global ELL arrays (``idx[N, K]`` with ghost == ``global_dim``)
    plus one entity key per row. Entities with fewer than
    ``min_entity_rows`` rows are dropped. ``intercept_index``, when given,
    is force-included in every entity's subspace. ``active_bound`` caps the
    rows each entity trains on (later rows are passive).
    ``max_features_per_entity`` keeps each entity's ``m`` features most
    |correlated| with the label (ties to the lower column id; the intercept
    kept on top of ``m``). ``max_bucket_entities`` splits each size class
    into buckets of at most that many entities. ``host_resident`` keeps the
    bucket arrays in host memory (page-locked when ``device`` is CUDA): the
    trainer then uploads one bucket at a time, and the device sweep cache
    can pin the whole dataset on the device after its first use.

    Vectorized over entities as the JAX builder is: per-entity subspaces
    come from uniques over (entity, column) pair keys, the local remap is
    each entry's rank among those keys (an argsort inverse per chunk, then
    one ordered ``searchsorted`` of the chunk's distinct keys), Pearson sums
    are global ``bincount``s, and bucket packing is flat fancy-index writes.
    The arrays equal the JAX builder's.
    """
    if max_bucket_entities is not None and max_bucket_entities < 1:
        raise ValueError(
            f"max_bucket_entities must be >= 1, got {max_bucket_entities}"
        )
    np_dt = numpy_dtype(dtype)
    n, k = idx.shape
    idx = np.asarray(idx)
    val = np.asarray(val)
    labels = np.asarray(labels, np_dt)
    weights = np.ones(n, np_dt) if weights is None else np.asarray(weights, np_dt)

    keys, inv = _unique_keys(entity_keys_per_row)
    counts_all = np.bincount(inv, minlength=len(keys))
    kept = np.flatnonzero(counts_all >= min_entity_rows)
    e_count = len(kept)
    if e_count == 0:
        return RandomEffectDataset(
            re_type=re_type, buckets=(), entity_keys=[], entity_to_slot={},
            n_rows=n, global_dim=global_dim, device=device,
        )
    new_id = np.full(len(keys), -1, np.int64)
    new_id[kept] = np.arange(e_count)
    dense_e = new_id[inv]                        # [n] dense entity id, -1 dropped
    row_kept = dense_e >= 0
    counts = counts_all[kept]                    # [E] rows per kept entity

    # ---- per-entity column subspaces: distinct (entity, column) pairs,
    # found chunk by chunk so the temporaries stay bounded by a chunk; each
    # chunk keeps its distinct pairs and every entry's index among them.
    stride = global_dim + 1
    chunk_rows_ = max(1, min(n, 1 << 22))
    uniq_parts, chunks = [], []
    if intercept_index is not None:
        uniq_parts.append(
            np.arange(e_count, dtype=np.int64) * stride + intercept_index)
    nz_per_ent = np.zeros(e_count, np.int64)
    for lo in range(0, n, chunk_rows_):
        hi = min(lo + chunk_rows_, n)
        ee_c = np.repeat(dense_e[lo:hi], k)
        fi_c = idx[lo:hi].ravel().astype(np.int64)
        ok_c = (ee_c >= 0) & (fi_c < global_dim)
        uniq_c, inv_c = _sorted_unique_inverse(ee_c[ok_c] * stride + fi_c[ok_c])
        uniq_parts.append(uniq_c)
        chunks.append((uniq_c, inv_c, ok_c))
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

    # each real entry's rank in upairs (its column's slot): a chunk's
    # distinct pairs are sorted, so one ordered search places them all
    entry_pos = np.concatenate([
        np.searchsorted(upairs, uniq_c).astype(np.int32)[inv_c]
        for uniq_c, inv_c, _ in chunks])
    entry_ok = np.concatenate([ok_c for _, _, ok_c in chunks])
    del chunks
    ee = np.repeat(dense_e.astype(np.int32), k)    # entity per ELL entry

    if max_features_per_entity is not None:
        chosen = _choose_pairs_by_pearson(
            upairs, ent_of_col, stride, entry_pos, entry_ok,
            val.ravel(), labels, dense_e, counts, e_count,
            max_features_per_entity, intercept_index,
        )
        # remap surviving pair ids to their rank in the filtered set
        new_pos = np.cumsum(chosen, dtype=np.int64) - 1
        survived = chosen[entry_pos]
        entry_pos = np.where(survived, new_pos[entry_pos], -1)
        upairs, ent_of_col = upairs[chosen], ent_of_col[chosen]
    ncols = np.bincount(ent_of_col, minlength=e_count).astype(np.int64)
    col_off = np.zeros(e_count + 1, np.int64)
    np.cumsum(ncols, out=col_off[1:])

    # ---- local remap
    ee_safe = np.maximum(ee, 0)
    local_flat = ncols[ee_safe].astype(np.int32)     # default: local ghost
    ok_ix = np.flatnonzero(entry_ok)
    hit_ok = entry_pos >= 0
    local_flat[ok_ix[hit_ok]] = (
        entry_pos[hit_ok] - col_off[ee[ok_ix[hit_ok]]]
    ).astype(np.int32)
    local = local_flat.reshape(n, k)
    hit = np.zeros(n * k, bool)
    hit[ok_ix[hit_ok]] = True
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
    row_dense = np.where(row_kept, dense_of[np.maximum(dense_e, 0)], e_count)
    row_order = np.argsort(row_dense, kind="stable")[: int(row_kept.sum())]
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
        t = torch.from_numpy(np.ascontiguousarray(a))
        if not host_resident:
            return t.to(device)
        return t.pin_memory() if device.type == "cuda" else t.clone()

    buckets = []
    entity_keys_out = list(keys[kept][ent_sort])
    entity_to_slot = {}
    for mb, me in zip(bucket_starts[:-1], bucket_starts[1:]):
        ecount = int(me - mb)
        s_pad = int(sp_sorted[mb, 0])
        p_pad = int(sp_sorted[mb, 1])
        b_idx = np.full((ecount, s_pad, k), p_pad, np.int32)
        b_val = np.zeros((ecount, s_pad, k), np_dt)
        b_lab = np.zeros((ecount, s_pad), np_dt)
        b_w = np.zeros((ecount, s_pad), np_dt)
        b_tw = np.zeros((ecount, s_pad), np_dt)
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
        tw = weights[rows_b].copy()
        if active_bound is not None:
            tw[wr >= active_bound] = 0.0              # passive rows
        b_tw[lane_r, wr] = tw
        b_rows[lane_r, wr] = rows_b

        csl = slice(cstarts[mb], cstarts[me])
        centries = col_order[csl]
        b_proj[col_dense[centries] - mb, within_col[csl]] = cols_flat[centries]

        cap = max_bucket_entities or ecount
        for lo in range(0, ecount, cap):
            hi = min(lo + cap, ecount)
            bi = len(buckets)
            for lane in range(lo, hi):
                entity_to_slot[int(mb + lane)] = (bi, lane - lo)
            buckets.append(EntityBucket(
                idx=put(b_idx[lo:hi]), val=put(b_val[lo:hi]),
                labels=put(b_lab[lo:hi]), weights=put(b_w[lo:hi]),
                train_weights=put(b_tw[lo:hi]), row_ids=put(b_rows[lo:hi]),
                proj=put(b_proj[lo:hi]),
                entity_ids=put(np.arange(mb + lo, mb + hi, dtype=np.int32)),
            ))

    return RandomEffectDataset(
        re_type=re_type,
        buckets=tuple(buckets),
        entity_keys=entity_keys_out,
        entity_to_slot=entity_to_slot,
        n_rows=n,
        global_dim=global_dim,
        device=device,
        host_resident=host_resident,
    )


def _choose_pairs_by_pearson(
    upairs, ent_of_col, stride, entry_pos, entry_ok, flat_val,
    labels, dense_e, counts, e_count, max_features, intercept_index,
):
    """Pearson top-m per entity over the (entity, col) pair keys; returns
    the keep mask over ``upairs``. Same scores as ``pearson_scores``
    (absent entries are zeros) from global bincounts; entities at or under
    the cap keep their whole subspace, ties break toward lower column ids,
    and the intercept is kept on top of ``m``."""
    pos = entry_pos
    v_raw = flat_val[entry_ok]
    v = np.asarray(v_raw, np.float64)
    y_row = np.asarray(labels, np.float64)
    k = len(entry_ok) // dense_e.shape[0]
    y_ent = np.repeat(y_row, k)[entry_ok]            # label of each entry's row
    npairs = len(upairs)
    sum_x = np.bincount(pos, weights=v, minlength=npairs)
    # v*v in the source dtype, so that scores (and so exact ties) are the
    # JAX builder's bit for bit.
    sum_x2 = np.bincount(pos, weights=np.asarray(v_raw * v_raw, np.float64),
                         minlength=npairs)
    sum_xy = np.bincount(pos, weights=v * y_ent, minlength=npairs)
    row_of_kept = dense_e >= 0
    sum_y_e = np.bincount(dense_e[row_of_kept], weights=y_row[row_of_kept],
                          minlength=e_count)
    sum_y2_e = np.bincount(dense_e[row_of_kept],
                           weights=y_row[row_of_kept] ** 2, minlength=e_count)
    s_e = counts.astype(np.float64)
    s, sy, sy2 = s_e[ent_of_col], sum_y_e[ent_of_col], sum_y2_e[ent_of_col]
    num = s * sum_xy - sum_x * sy
    var_x = s * sum_x2 - sum_x * sum_x
    var_y = s * sy2 - sy * sy
    denom = np.sqrt(np.maximum(var_x, 0.0) * np.maximum(var_y, 0.0))
    with np.errstate(invalid="ignore", divide="ignore"):
        score = np.where(denom > 0, np.abs(num) / np.maximum(denom, 1e-30), 0.0)

    cols = upairs % stride
    rank_order = np.lexsort((cols, -score, ent_of_col))
    off = np.zeros(e_count + 1, np.int64)
    np.cumsum(np.bincount(ent_of_col, minlength=e_count), out=off[1:])
    rank = np.empty(npairs, np.int64)
    rank[rank_order] = np.arange(npairs) - off[ent_of_col[rank_order]]
    over_cap = (off[1:] - off[:-1]) > max_features     # per entity
    chosen = ~over_cap[ent_of_col] | (rank < max_features)
    if intercept_index is not None:
        chosen |= cols == intercept_index
    return chosen


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


def _unique_keys(values) -> tuple[np.ndarray, np.ndarray]:
    """``np.unique(values, return_inverse=True)`` for object (string) keys:
    the distinct keys by one dict pass, only those sorted, then each row's
    key looked up, instead of sorting every row's Python object. Other
    arrays go to ``np.unique``."""
    values = np.asarray(values)
    if values.dtype != object:
        keys, inv = np.unique(values, return_inverse=True)
        return keys, inv.reshape(-1).astype(np.int64)
    flat = values.ravel().tolist()
    distinct = dict.fromkeys(flat)
    keys = np.empty(len(distinct), object)
    keys[:] = list(distinct)
    keys = keys[np.argsort(keys, kind="stable")]
    rank = {k: r for r, k in enumerate(keys.tolist())}
    return keys, np.fromiter(map(rank.__getitem__, flat), np.int64, len(flat))


def _sorted_unique_inverse(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``_sorted_unique(a)`` and each element's index in it (int32), by one
    argsort."""
    order = np.argsort(a)
    s = a[order]
    keep = np.empty(len(s), bool)
    keep[:1] = True
    np.not_equal(s[1:], s[:-1], out=keep[1:])
    inv = np.empty(len(a), np.int32)
    inv[order] = np.cumsum(keep, dtype=np.int64) - 1
    return s[keep], inv


def _next_pow2_vec(x: np.ndarray) -> np.ndarray:
    x = np.maximum(np.asarray(x, np.int64), 1)
    return 1 << np.ceil(np.log2(x)).astype(np.int64)
