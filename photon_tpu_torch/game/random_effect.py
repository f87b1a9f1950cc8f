"""Random-effect models: per-entity GLMs for one coordinate.

Port of ``photon_tpu/game/random_effect.py`` (``RandomEffectModel`` with the
export and cross-dataset scoring paths; the bucket solvers come with the
training slice).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from photon_tpu_torch.data.random_effect import RandomEffectDataset
from photon_tpu_torch.types import TaskType

Tensor = torch.Tensor


def _host(t: Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@dataclasses.dataclass(frozen=True)
class RandomEffectModel:
    """Per-entity GLMs for one random-effect coordinate: a list of
    per-bucket coefficient stacks ``[E, P]`` in each entity's local feature
    subspace, plus the projection/slot structure to interpret them. Unseen
    entities score 0 (the zero-model fallback)."""

    re_type: str
    task: TaskType
    bucket_coefs: Sequence[Tensor]              # per bucket: [E, P]
    bucket_proj: Sequence[Tensor]               # per bucket: [E, P] -> global col
    bucket_entity_ids: Sequence[Tensor]         # per bucket: [E] dense REId
    entity_keys: Sequence                       # dense REId -> original key
    entity_to_slot: dict                        # dense REId -> (bucket, lane)
    global_dim: int
    bucket_variances: Optional[Sequence[Tensor]] = None

    @functools.cached_property
    def _key_to_dense(self) -> dict:
        return {k: i for i, k in enumerate(self.entity_keys)}

    def _sparse_for(
        self, entity_key, stacks: Sequence[Sequence[Tensor]]
    ) -> tuple[np.ndarray, list[np.ndarray]]:
        """(global_indices, [values per stack]) for one entity."""
        dense = self._key_to_dense.get(entity_key)
        if dense is None:
            return np.zeros(0, np.int64), [
                np.zeros(0, np.float32) for _ in stacks
            ]
        b, lane = self.entity_to_slot[dense]
        proj = _host(self.bucket_proj[b][lane])
        valid = proj < self.global_dim
        return proj[valid].astype(np.int64), [
            _host(s[b][lane])[valid] for s in stacks
        ]

    def export_for(
        self, entity_key
    ) -> tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """(indices, means, variances-or-None) in one slot lookup — the model
        export path's per-entity gather."""
        if self.bucket_variances is None:
            gi, (gv,) = self._sparse_for(entity_key, [self.bucket_coefs])
            return gi, gv, None
        gi, (gv, vv) = self._sparse_for(
            entity_key, [self.bucket_coefs, self.bucket_variances]
        )
        return gi, gv, vv

    def project_to(self, dataset: RandomEffectDataset) -> list[Tensor]:
        """Coefficient stacks re-projected into a *different* dataset's local
        subspaces (scoring data), on the dataset's device: a host-side
        per-entity remap (the model-RDD join by REId of the reference).
        Entities and columns unseen at training time get the zero model."""
        key_to_dense = self._key_to_dense
        old_proj = [_host(p) for p in self.bucket_proj]
        old_coef = [_host(c) for c in self.bucket_coefs]
        out: list[Tensor] = []
        for b in dataset.buckets:
            proj = _host(b.proj)
            eids = _host(b.entity_ids)
            coef = np.zeros(proj.shape, old_coef[0].dtype)
            for lane in range(b.n_entities):
                dense_new = eids[lane]
                if dense_new < 0:
                    continue
                dense_old = key_to_dense.get(dataset.entity_keys[dense_new])
                if dense_old is None:
                    continue
                bo, lo = self.entity_to_slot[dense_old]
                pv = old_proj[bo][lo]
                valid = pv < self.global_dim
                gi = pv[valid]
                if len(gi) == 0:
                    continue
                # match new local columns against the trained sparse vector
                cols_new = proj[lane]
                pos = np.clip(np.searchsorted(gi, cols_new), 0, len(gi) - 1)
                hit = gi[pos] == cols_new
                coef[lane][hit] = old_coef[bo][lo][valid][pos[hit]]
            out.append(torch.from_numpy(coef).to(dataset.device))
        return out

    def score_new_dataset(self, dataset: RandomEffectDataset) -> Tensor:
        """Scores for a dataset built from different rows (e.g. scoring)."""
        coef_stacks = self.project_to(dataset)
        per_bucket = [
            b.scores(c) for b, c in zip(dataset.buckets, coef_stacks)
        ]
        dtype = per_bucket[0].dtype if per_bucket else self.bucket_coefs[0].dtype
        return dataset.scatter_scores(per_bucket, dtype)
