"""Coordinate descent: the GAME outer loop.

Port of ``photon_tpu/game/descent.py`` (``GameModel``, ``ValidationData``,
``CoordinateStepRecord`` and ``CoordinateDescent.run`` with checkpoints and
resume; device-loss recovery comes with the runtime-guards slice): for each
sweep, for each coordinate in the update sequence, remove the coordinate's
own score from the total, train against the residual as offset, and add the
new score back; with validation data, evaluate after every coordinate step
and keep the best complete model seen. Scores are [N] tensors in one global
row order, so the residuals are elementwise. With a ``checkpointer`` the
whole state is saved after every step; ``resume`` restores such a snapshot
and skips the steps it covers, so a killed and resumed run ends where the
uninterrupted one does, bit for bit.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Mapping, Optional, Sequence

import torch

from photon_tpu_torch.evaluation import EvaluationResults, EvaluationSuite
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
    ``OptimizerResult``, a random effect's per-bucket results);
    ``validation`` the evaluation after the step, when there is validation
    data."""

    sweep: int
    coordinate_id: str
    seconds: float
    result: Optional[object] = None
    validation: Optional[EvaluationResults] = None


@dataclasses.dataclass(frozen=True)
class ValidationData:
    """Validation rows + per-coordinate scorers.

    ``scorers[cid](model) -> [n_rows]`` gives a coordinate's raw scores on
    the validation rows (fixed effect: matvec on the validation batch;
    random effect: projection into the validation dataset). Built by the
    estimator.
    """

    labels: Tensor
    weights: Tensor
    offsets: Tensor
    scorers: Mapping[str, object]
    group_ids_by_column: Optional[Mapping[str, Tensor]] = None
    num_groups_by_column: Optional[Mapping[str, int]] = None


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
        validation: Optional[ValidationData] = None,
        suite: Optional[EvaluationSuite] = None,
        initial_models: Optional[Mapping[str, DatumScoringModel]] = None,
        checkpointer=None,
        resume: Optional[dict] = None,
        step_base: int = 0,
        checkpoint_meta: Optional[dict] = None,
        extra_state: Optional[dict] = None,
    ) -> tuple[GameModel, list[CoordinateStepRecord]]:
        """``base_offsets`` [n_rows] are the data's own offsets (float32 in
        the JAX package's estimator). Warm-start models in
        ``initial_models`` seed their coordinates' scores; those outside the
        update sequence are "locked": scored so the residuals are right,
        never retrained, kept in the output. With ``validation`` the
        returned model is the best complete one by the suite's primary
        evaluator.

        ``checkpointer`` (a ``CheckpointManager``) snapshots the state after
        every step as step ``step_base + k``, with ``checkpoint_meta`` and
        ``extra_state`` added; ``resume`` is a payload of ``load_latest``
        (its tensors on this run's device) whose position is skipped."""
        for cid in self.update_sequence:
            if cid not in coordinates:
                raise ValueError(f"update sequence names unknown coordinate {cid!r}")
        if validation is not None and suite is None:
            raise ValueError("validation data provided without an evaluation suite")
        base = base_offsets

        resumed_pos = None
        if resume is not None:
            st = resume["state"]
            models = {cid: _adopt(coordinates.get(cid), m)
                      for cid, m in st["models"].items()}
            scores = dict(st["scores"])
            total = st["total"]
            v_cache = dict(st["v_cache"])
            best_metric = st["best_metric"]
            best_models = st["best_models"]
            tracker = list(st["tracker"])
            resumed_pos = (resume["meta"]["sweep"], resume["meta"]["coord_index"])
            logger.info("resuming after sweep %d coordinate %d", *resumed_pos)
        else:
            models = dict(initial_models or {})
            scores = {}
            for cid in self.update_sequence:
                if cid in models:
                    scores[cid] = coordinates[cid].score(models[cid])
                else:
                    scores[cid] = torch.zeros(n_rows, dtype=base.dtype,
                                              device=base.device)
            for cid in sorted(set(models) - set(self.update_sequence)):
                if cid not in coordinates:
                    raise ValueError(
                        f"initial model {cid!r} is outside the update sequence "
                        "and has no coordinate to score it (locked coordinates "
                        "need a coordinate for residual bookkeeping)"
                    )
                scores[cid] = coordinates[cid].score(models[cid])
            total = base + sum(scores.values())
            tracker = []
            best_metric = None
            best_models = None
            # Validation scores cached per coordinate: only the coordinate
            # just trained is re-scored (a random effect's projection is
            # host work).
            v_cache = ({cid: validation.scorers[cid](models[cid]) for cid in models}
                       if validation is not None else {})
        if validation is not None:
            need = set(self.update_sequence) | set(models)
            missing = sorted(c for c in need if c not in validation.scorers)
            if missing:
                raise ValueError(
                    f"validation scorers missing for coordinates {missing}")

        step = step_base
        for sweep in range(self.n_sweeps):
            for ci, cid in enumerate(self.update_sequence):
                if resumed_pos is not None and (sweep, ci) <= resumed_pos:
                    step += 1
                    continue
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
                record = CoordinateStepRecord(sweep, cid, dt, result)
                if validation is not None:
                    v_cache[cid] = validation.scorers[cid](model)
                    record.validation = suite.evaluate(
                        validation.offsets + sum(v_cache.values()),
                        validation.labels,
                        validation.weights,
                        validation.group_ids_by_column,
                        validation.num_groups_by_column,
                    )
                    primary = record.validation.primary
                    # Only a complete model (every coordinate trained at
                    # least once) may be the best.
                    complete = all(c in models for c in self.update_sequence)
                    if complete and (
                        best_metric is None
                        or suite.primary.better_than(primary, best_metric)
                    ):
                        best_metric = primary
                        best_models = dict(models)
                    logger.info("sweep %d coord %s: %s (%.2fs)", sweep, cid,
                                record.validation, dt)
                else:
                    logger.info("sweep %d coord %s done (%.2fs)", sweep, cid, dt)
                tracker.append(record)
                if checkpointer is not None:
                    checkpointer.save(
                        step,
                        state={
                            "models": models,
                            "scores": scores,
                            "total": total,
                            "v_cache": v_cache,
                            "best_metric": best_metric,
                            "best_models": best_models,
                            "tracker": tracker,
                            **(extra_state or {}),
                        },
                        meta={"phase": "step", "sweep": sweep,
                              "coord_index": ci, **(checkpoint_meta or {})},
                    )
                step += 1
        final = best_models if best_models is not None else models
        return GameModel(dict(final)), tracker


def _adopt(coordinate, model):
    """A restored model re-attached to its coordinate's data structures
    (``coordinate.adopt``, where the coordinate has one), so the resumed
    steps score it as the uninterrupted run scored the live model."""
    adopt = getattr(coordinate, "adopt", None)
    return model if adopt is None else adopt(model)
