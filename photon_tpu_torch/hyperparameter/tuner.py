"""GAME auto-tuning: Bayesian optimization of per-coordinate regularization.

Port of ``photon_tpu/hyperparameter/tuner.py`` over the port's
``GameEstimator``: each trial trains one GAME fit (on the bundle's device)
for a proposed vector of regularization weights and returns the primary
validation metric (SURVEY.md §6 config (4): "GAME per-user + per-item
random effects CTR with Bayesian hyperparameter auto-tuning"). The searches
themselves (``search.py``) are host numpy.

Parameters are named ``<coordinateId>.reg_weight``; log scale is the correct
default for regularization weights. With a ``CheckpointManager`` the search
state is snapshotted after every trial in the port's own framing
(``checkpoint.py``): a snapshot of the JAX package in the directory is
refused by its magic before anything is unpickled, and the run fingerprint
names the torch backend.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np

from photon_tpu_torch.estimators.config import (
    GameOptimizationConfiguration,
    reg_weight_sweep,
)
from photon_tpu_torch.estimators.game_estimator import GameEstimator, GameFitResult
from photon_tpu_torch.evaluation import EvaluationSuite
from photon_tpu_torch.hyperparameter.rescaling import ParamRange, VectorRescaling
from photon_tpu_torch.hyperparameter.search import (
    GaussianProcessSearch,
    RandomSearch,
    SearchResult,
)
from photon_tpu_torch.io.data_reader import GameDataBundle


@dataclasses.dataclass(frozen=True)
class TuningResult:
    search: SearchResult
    best_config: GameOptimizationConfiguration
    # The fully trained result for the best configuration: the model fitted
    # during the search, or, when the best trial predates a checkpoint
    # resume, one deterministic refit of it.
    best_result: Optional[GameFitResult] = None

    @property
    def best_params(self) -> np.ndarray:
        return self.search.best_point


def tune_regularization(
    estimator: GameEstimator,
    train: GameDataBundle,
    validation: GameDataBundle,
    base_config: GameOptimizationConfiguration,
    reg_ranges: Mapping[str, tuple[float, float]],
    n_iterations: int = 10,
    strategy: str = "gp",
    seed: int = 0,
    initial_model=None,
    checkpoint_manager=None,
) -> TuningResult:
    """Search per-coordinate reg weights; returns history + best config.

    ``reg_ranges``: coordinate id → (min, max) reg weight, searched on log
    scale. The objective is the estimator's primary evaluator on validation
    (negated internally when bigger is better — searches minimize).

    ``checkpoint_manager`` (``photon_tpu_torch.checkpoint.CheckpointManager``)
    enables TRIAL-level checkpoint/resume: the search state (evaluated
    trials, PRNG state, pending proposals) is snapshotted after every trial,
    and a restarted call with the same arguments fast-forwards past the
    completed trials and evaluates exactly the trials the uninterrupted run
    would have (bit-identical history; a changed configuration is refused).
    The best trial's model is refitted only if it predates the resume point.
    """
    if not estimator.evaluator_specs:
        raise ValueError("estimator needs evaluator_specs for tuning")
    suite = EvaluationSuite.parse(estimator.evaluator_specs)
    sign = -1.0 if suite.primary.bigger_is_better else 1.0

    cids = sorted(reg_ranges)
    rescaling = VectorRescaling(
        [ParamRange(f"{cid}.reg_weight", *reg_ranges[cid], scale="log")
         for cid in cids])

    def config_for(vec: np.ndarray) -> GameOptimizationConfiguration:
        # a one-configuration sweep: reg_weight_sweep's checks and build
        return reg_weight_sweep(
            base_config, {cid: [float(w)] for cid, w in zip(cids, vec)})[0]

    best: dict = {"value": np.inf, "result": None}

    def evaluate(vec: np.ndarray) -> float:
        result = estimator.fit(
            train, validation, [config_for(vec)], initial_model=initial_model)[0]
        v = sign * result.evaluation.primary
        if v < best["value"]:
            best["value"] = v
            best["result"] = result
        return v

    if strategy == "gp":
        search = GaussianProcessSearch(rescaling, seed=seed)
    elif strategy == "random":
        search = RandomSearch(rescaling, seed=seed)
    else:
        raise ValueError(f"strategy must be 'gp' or 'random', got {strategy!r}")

    resume_state, on_trial = None, None
    if checkpoint_manager is not None:
        from photon_tpu_torch.checkpoint import run_fingerprint

        fingerprint = run_fingerprint((
            "tuning", sorted(reg_ranges.items()), n_iterations, strategy,
            seed, repr(base_config), estimator.fingerprint_parts(),
        ))
        payload = checkpoint_manager.load_checked("tuning", fingerprint)
        if payload is not None:
            resume_state = payload["state"]

        def on_trial(state, trial_index):
            checkpoint_manager.save(
                trial_index, state, {"kind": "tuning", "fingerprint": fingerprint})

    history = search.search(evaluate, n_iterations, state=resume_state,
                            on_trial=on_trial)
    if best["result"] is None or \
            sign * best["result"].evaluation.primary > history.best_value:
        # The best trial predates the resume point; one deterministic refit
        # reproduces its model.
        best["result"] = estimator.fit(
            train, validation, [config_for(history.best_point)],
            initial_model=initial_model)[0]
    return TuningResult(search=history,
                        best_config=config_for(history.best_point),
                        best_result=best["result"])
