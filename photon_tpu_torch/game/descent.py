"""Coordinate descent: the GAME outer loop.

Port of ``photon_tpu/game/descent.py`` (``GameModel``, ``CoordinateStepRecord``
and ``CoordinateDescent.run`` without validation, checkpoints, resume or
device-loss recovery, which come with later slices): for each sweep, for each
coordinate in the update sequence, remove the coordinate's own score from
the total, train against the residual as offset, and add the new score
back. Scores are [N] tensors in one global row order, so the residuals are
elementwise.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Mapping, Optional, Sequence

import torch

from photon_tpu_torch.game.coordinates import Coordinate, DatumScoringModel

Tensor = torch.Tensor

logger = logging.getLogger("photon_tpu_torch.game")


@dataclasses.dataclass(frozen=True)
class GameModel:
    """Composite model keyed by coordinate id."""

    models: Mapping[str, DatumScoringModel]

    def __getitem__(self, cid: str) -> DatumScoringModel:
        return self.models[cid]

    def keys(self):
        return self.models.keys()


@dataclasses.dataclass
class CoordinateStepRecord:
    """One (sweep, coordinate) step of the tracker. ``result`` is what the
    coordinate's training returned beside its model (a fixed effect's
    ``OptimizerResult``)."""

    sweep: int
    coordinate_id: str
    seconds: float
    result: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class CoordinateDescent:
    """Block-coordinate descent over an ordered update sequence."""

    update_sequence: Sequence[str]
    n_sweeps: int = 1

    def run(
        self,
        coordinates: Mapping[str, Coordinate],
        n_rows: int,
        base_offsets: Tensor,
        initial_models: Optional[Mapping[str, DatumScoringModel]] = None,
    ) -> tuple[GameModel, list[CoordinateStepRecord]]:
        """``base_offsets`` [n_rows] are the data's own offsets (float32 in
        the JAX package's estimator). Warm-start models in
        ``initial_models`` seed their coordinates' scores; those outside the
        update sequence are "locked": scored so the residuals are right,
        never retrained, kept in the output."""
        for cid in self.update_sequence:
            if cid not in coordinates:
                raise ValueError(f"update sequence names unknown coordinate {cid!r}")
        base = base_offsets

        models = dict(initial_models or {})
        scores: dict = {}
        for cid in self.update_sequence:
            if cid in models:
                scores[cid] = coordinates[cid].score(models[cid])
            else:
                scores[cid] = torch.zeros(n_rows, dtype=base.dtype, device=base.device)
        for cid in sorted(set(models) - set(self.update_sequence)):
            if cid not in coordinates:
                raise ValueError(
                    f"initial model {cid!r} is outside the update sequence "
                    "and has no coordinate to score it (locked coordinates "
                    "need a coordinate for residual bookkeeping)"
                )
            scores[cid] = coordinates[cid].score(models[cid])
        total = base + sum(scores.values())

        tracker: list[CoordinateStepRecord] = []
        for sweep in range(self.n_sweeps):
            for cid in self.update_sequence:
                t0 = time.perf_counter()
                residual_offset = total - scores[cid]
                model, result = coordinates[cid].train(
                    residual_offset, models.get(cid))
                new_score = coordinates[cid].score(model)
                total = residual_offset + new_score
                # One element to the host: the step's time covers completed
                # device work, not the enqueue.
                new_score[:1].cpu()
                scores[cid] = new_score
                models[cid] = model
                dt = time.perf_counter() - t0
                tracker.append(CoordinateStepRecord(sweep, cid, dt, result))
                logger.info("sweep %d coord %s done (%.2fs)", sweep, cid, dt)
        return GameModel(dict(models)), tracker
