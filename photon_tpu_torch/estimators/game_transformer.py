"""GameTransformer: score a dataset with a trained GameModel.

Port of ``photon_tpu/estimators/game_transformer.py``: ``transform``, ``transform_rows``, ``transform_and_evaluate``,
``evaluate_scored_arrays`` and the row-level scoring program
``additive_score_rows`` that ``transform_rows`` and the online scorer
(``photon_tpu_torch/serving``) share. Per coordinate, the data is scored and
the scores summed additively; rows whose entity was unseen at training fall
back to the zero model.

Fixed-effect scoring is one sparse matvec on the whole batch — on CUDA the
``ell_panel_matvec`` kernel over the attached panel layout (``ell_matvec``
where the layout does not pay). Random-effect scoring projects the trained
per-entity coefficients into the scoring dataset's bucket structure on the
host, then scores each bucket with one batched gather-dot.

With a ``mesh``, fixed-effect scoring shards the features alone (the row
columns are never read) over ``data_axis``: a matvec a shard on its device
(each shard's own matvec layout), the rows gathered in order and the
padding dropped.

``additive_score_rows`` scores padded rows instead: each fixed part is one
``ell_matvec`` (the kernel on CUDA), each random-effect part a batched
binary search of the row's columns in its entity's sorted subspace.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from photon_tpu_torch.estimators.config import (
    CoordinateDataConfig,
    FixedEffectDataConfig,
    RandomEffectDataConfig,
)
from photon_tpu_torch.estimators.game_estimator import (
    _factorize_group_ids,
    build_re_dataset_from_bundle,
)
from photon_tpu_torch.evaluation import EvaluationResults, EvaluationSuite
from photon_tpu_torch.game.coordinates import FixedEffectModel
from photon_tpu_torch.game.descent import GameModel
from photon_tpu_torch.game.random_effect import RandomEffectModel
from photon_tpu_torch.io.data_reader import GameDataBundle

from photon_tpu_torch.ops.cuda_sparse import ell_matvec

Tensor = torch.Tensor

SCORE_KERNEL_NAME = "additive_score_rows"
_NUMPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def additive_score_rows(offsets: Tensor, shard_idx, shard_val, fixed_ws,
                        re_proj, re_coef, *, fixed_parts, re_parts) -> Tensor:
    """The additive GAME score of B padded rows, the program shared by
    ``GameTransformer.transform_rows`` and the online scorer, so batch and
    online scores cannot drift. The arguments are the JAX program's.

    ``offsets [B]``; ``shard_idx/shard_val``: shard → ELL row arrays
    ``[B, K]`` (int32 columns, ghost column == the shard's dim, value 0).
    ``fixed_ws``: coordinate → extended coefficient vector ``[D+1]`` (the
    trailing zero is the ghost's). ``re_proj/re_coef``: coordinate → per-row
    entity subspace ``[B, P]``, sorted global columns (ghost pad == dim) and
    the entity's coefficients in those slots; an all-ghost row is the zero
    model (the unseen-entity fallback). ``fixed_parts``/``re_parts`` are
    ``((cid, shard), ...)`` tuples naming which arrays combine.

    A fixed part is ``ell_matvec(idx, val, w, D)`` over the vector without
    its ghost slot: the kernel on CUDA (it sums each row in float64 and
    rounds once, where the JAX program sums in float32), its plain version
    on CPU tensors. A random-effect part is plain torch: a batched
    ``searchsorted`` of the row's columns into the entity's subspace, the
    position clamped to ``P-1``, a hit mask, the products
    ``where(hit, coef·val, 0)`` in the coefficients' dtype and their row
    sum in float64, rounded once to that dtype.
    """
    total = offsets
    for cid, shard in fixed_parts:
        idx, val = shard_idx[shard], shard_val[shard]
        w_ext = fixed_ws[cid]
        dim = w_ext.shape[0] - 1
        if val.dtype not in (w_ext.dtype, torch.bfloat16):
            val = val.to(w_ext.dtype)
        total = total + ell_matvec(idx, val, w_ext[:dim], dim)
    for cid, shard in re_parts:
        proj, coef = re_proj[cid], re_coef[cid]
        if proj.shape[1] == 0:  # a model of width 0 adds nothing
            continue
        idx, val = shard_idx[shard], shard_val[shard]
        pos = torch.searchsorted(proj, idx)
        pos = pos.clamp_max_(proj.shape[1] - 1)
        hit = torch.take_along_dim(proj, pos, dim=1) == idx
        cv = torch.take_along_dim(coef, pos, dim=1)
        prod = torch.where(hit, cv * val.to(cv.dtype), cv.new_zeros(()))
        # Summed in float64 and rounded once (the kernel's rule): a row's
        # score then does not depend on the batch it rode in, so the front
        # line and the threaded server return the same bits.
        total = total + prod.double().sum(dim=1).to(cv.dtype)
    return total


@dataclasses.dataclass(frozen=True)
class GameTransformer:
    """Bind a trained model to the per-coordinate data configs it was
    trained with (shard names + entity columns)."""

    model: GameModel
    coordinate_data_configs: Mapping[str, CoordinateDataConfig]
    intercept_indices: Optional[Mapping[str, int]] = None
    mesh: Optional[object] = None
    data_axis: object = "data"

    def _intercept_for(self, shard: str) -> Optional[int]:
        if self.intercept_indices is None:
            return None
        return self.intercept_indices.get(shard)

    def _score_fixed(self, m: FixedEffectModel, batch) -> Tensor:
        if self.mesh is not None:
            from photon_tpu_torch.parallel.mesh import pad_and_shard_batch

            feats = pad_and_shard_batch(batch.features, self.mesh,
                                        self.data_axis, layouts="matvec")
            return feats.matvec(m.model.coefficients.means).to(
                batch.features.device)
        # Scoring runs one matvec, so only its layout attaches: on CUDA the
        # panel layout of ell_panel_matvec (see SparseFeatures). The
        # transposes' CSC layout is for training.
        feats = batch.features.with_matvec_layout()
        return feats.matvec(m.model.coefficients.means)

    def transform(self, data: GameDataBundle) -> Tensor:
        """Total additive score per row: offsets + Σ coordinate scores, on
        the device the bundle's features live on. Offsets enter as float32,
        as in the JAX transformer."""
        total = torch.as_tensor(data.offsets, dtype=torch.float32).to(data.device)
        for cid in self.model.keys():
            dcfg = self.coordinate_data_configs.get(cid)
            if dcfg is None:
                raise ValueError(
                    f"model coordinate {cid!r} has no data config; "
                    f"configs cover {sorted(self.coordinate_data_configs)}"
                )
            m = self.model[cid]
            if isinstance(dcfg, FixedEffectDataConfig):
                if not isinstance(m, FixedEffectModel):
                    raise TypeError(f"{cid!r}: fixed-effect config, {type(m)} model")
                total = total + self._score_fixed(
                    m, data.batch(dcfg.feature_shard)
                )
            elif isinstance(dcfg, RandomEffectDataConfig):
                if not isinstance(m, RandomEffectModel):
                    raise TypeError(f"{cid!r}: random-effect config, {type(m)} model")
                ds = build_re_dataset_from_bundle(
                    data, dcfg, self._intercept_for(dcfg.feature_shard),
                    for_scoring=True,
                )
                total = total + m.score_new_dataset(ds)
            else:  # pragma: no cover - union is closed
                raise TypeError(f"unknown data config {type(dcfg)}")
        return total

    def transform_rows(self, data: GameDataBundle) -> Tensor:
        """Row-level scoring through ``additive_score_rows``, the program the
        online scorer runs: the parity anchor between batch and online
        scores (held equal to ``transform``). Each row's entity
        coefficients are joined on the host, row by row, in the model's own
        coefficient dtype; large scans should prefer ``transform``'s
        bucketed path."""
        dev = data.device
        fixed_parts, re_parts = [], []
        fixed_ws, re_proj, re_coef = {}, {}, {}
        n = data.n_rows
        shard_idx = {s: f.idx for s, f in data.features.items()}
        shard_val = {s: f.val for s, f in data.features.items()}
        for cid in self.model.keys():
            dcfg = self.coordinate_data_configs.get(cid)
            if dcfg is None:
                raise ValueError(
                    f"model coordinate {cid!r} has no data config; "
                    f"configs cover {sorted(self.coordinate_data_configs)}"
                )
            m = self.model[cid]
            if isinstance(dcfg, FixedEffectDataConfig):
                w = m.model.coefficients.means
                fixed_ws[cid] = torch.cat([w, w.new_zeros(1)])
                fixed_parts.append((cid, dcfg.feature_shard))
            elif isinstance(dcfg, RandomEffectDataConfig):
                keys = data.id_tags[dcfg.re_type]
                dim = data.features[dcfg.feature_shard].dim
                rows, width, by_key = [], 1, {}
                for key in keys:
                    hit = by_key.get(key)
                    if hit is None:
                        hit = m.coefficients_for(key)
                        by_key[key] = hit
                    rows.append(hit)
                    width = max(width, len(hit[0]))
                proj = np.full((n, width), dim, np.int32)
                # The model's own precision: an f64 model scores through
                # this path as through ``transform``.
                cdt = (m.bucket_coefs[0].dtype if len(m.bucket_coefs)
                       else torch.float32)
                coef = np.zeros((n, width), _NUMPY_DTYPES[cdt])
                for r, (gi, gv) in enumerate(rows):
                    proj[r, : len(gi)] = gi
                    coef[r, : len(gi)] = gv
                re_proj[cid] = torch.from_numpy(proj).to(dev)
                re_coef[cid] = torch.from_numpy(coef).to(dev)
                re_parts.append((cid, dcfg.feature_shard))
            else:  # pragma: no cover - union is closed
                raise TypeError(f"unknown data config {type(dcfg)}")
        offsets = torch.as_tensor(data.offsets, dtype=torch.float32).to(dev)
        return additive_score_rows(
            offsets, shard_idx, shard_val, fixed_ws, re_proj, re_coef,
            fixed_parts=tuple(fixed_parts), re_parts=tuple(re_parts))

    def transform_and_evaluate(
        self, data: GameDataBundle, suite: EvaluationSuite
    ) -> tuple[Tensor, EvaluationResults]:
        """Score, then evaluate the scores with the suite (the scoring
        driver's ``--evaluators``)."""
        scores = self.transform(data)
        return scores, evaluate_scored_arrays(
            suite, scores, data.labels, data.weights, data.id_tags)


def evaluate_scored_arrays(suite: EvaluationSuite, scores: Tensor, labels,
                           weights, id_tags: Mapping,
                           factorized: Optional[Mapping] = None) -> EvaluationResults:
    """Evaluate precomputed scores: factorize each grouped evaluator's id
    column, cast to float32 on the scores' device, run the suite.
    ``factorized`` maps a group column to ``(codes, n_groups)`` already
    dense (the chunked scoring driver encodes them chunk by chunk)."""
    dev = scores.device
    gids, ngroups = {}, {}
    for col in {ev.group_column for ev in suite.evaluators if ev.group_column}:
        if factorized is not None and col in factorized:
            codes, n = factorized[col]
            gids[col] = torch.from_numpy(np.asarray(codes, np.int32)).to(dev)
            ngroups[col] = int(n)
        elif col not in id_tags:
            raise ValueError(f"grouped evaluator needs id column {col!r}")
        else:
            gids[col], ngroups[col] = _factorize_group_ids(id_tags[col], dev)

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

    return suite.evaluate(scores.to(torch.float32), f32(labels), f32(weights),
                          gids or None, ngroups or None)
