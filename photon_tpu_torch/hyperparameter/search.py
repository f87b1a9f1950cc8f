"""Search strategies: pure random and GP-guided Bayesian optimization.

Copy of ``photon_tpu/hyperparameter/search.py`` (numpy and scipy only, no
torch: the searches run on the host).

Parity: reference ⟦photon-lib/.../hyperparameter/search/RandomSearch.scala,
GaussianProcessSearch.scala, EvaluationFunction.scala⟧ (SURVEY.md §2.1): an
``EvaluationFunction`` maps a native-unit parameter vector to a scalar to
**minimize**; searches propose, evaluate, observe, repeat, and return the full
history. GaussianProcessSearch seeds with random points, then maximizes
Expected Improvement over a random candidate pool under the slice-sampled GP
posterior — the reference's exact loop, minus Spark plumbing.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional, Sequence

import numpy as np

from photon_tpu_torch.hyperparameter.acquisition import expected_improvement
from photon_tpu_torch.hyperparameter.gp import (
    GaussianProcessEstimator,
    predict_mean_var,
)
from photon_tpu_torch.hyperparameter.kernels import Matern52
from photon_tpu_torch.hyperparameter.rescaling import VectorRescaling

logger = logging.getLogger("photon_tpu_torch.hyperparameter")

# vector (native units) -> value to minimize
EvaluationFunction = Callable[[np.ndarray], float]


@dataclasses.dataclass(frozen=True)
class SearchResult:
    """Full history + incumbent."""

    points: np.ndarray     # [n, d] native units
    values: np.ndarray     # [n]

    @property
    def best_index(self) -> int:
        return int(np.argmin(self.values))

    @property
    def best_point(self) -> np.ndarray:
        return self.points[self.best_index]

    @property
    def best_value(self) -> float:
        return float(self.values[self.best_index])


# Trial-level search state for checkpoint/resume: everything the loop needs
# to continue exactly where it stopped — evaluated trials, the PRNG state,
# and proposals already drawn but not yet evaluated (so a resumed run
# evaluates the very same next point the uninterrupted run would have).
def _trial_state(pts, vals, rng, queue) -> dict:
    return {
        "points": [np.asarray(p) for p in pts],
        "values": [float(v) for v in vals],
        "rng_state": rng.bit_generator.state,
        "queue": [np.asarray(q) for q in queue],
    }


def _restore(state, rng, pts, vals, queue) -> None:
    pts.extend(np.asarray(p) for p in state["points"])
    vals.extend(float(v) for v in state["values"])
    queue.extend(np.asarray(q) for q in state["queue"])
    rng.bit_generator.state = state["rng_state"]


@dataclasses.dataclass
class RandomSearch:
    """Uniform search in the (scaled) range cube — reference ⟦RandomSearch⟧."""

    rescaling: VectorRescaling
    seed: int = 0

    def search(
        self,
        evaluate: EvaluationFunction,
        n: int,
        state: Optional[dict] = None,
        on_trial=None,
    ) -> SearchResult:
        rng = np.random.default_rng(self.seed)
        pts: list[np.ndarray] = []
        vals: list[float] = []
        queue: list[np.ndarray] = []
        if state is not None:
            _restore(state, rng, pts, vals, queue)
        deficit = n - len(pts) - len(queue)
        if deficit > 0:
            # Fresh start, or a resume asked for MORE trials than the saved
            # run: draw the shortfall from the restored generator (the
            # stream continues deterministically either way).
            queue.extend(self.rescaling.sample(rng, deficit))
        while len(pts) < n and queue:
            p = queue.pop(0)
            vals.append(float(evaluate(p)))
            pts.append(p)
            if on_trial is not None:
                on_trial(_trial_state(pts, vals, rng, queue), len(pts))
        points = (np.stack(pts) if pts
                  else np.zeros((0, self.rescaling.dim)))
        return SearchResult(points, np.asarray(vals, float))


@dataclasses.dataclass
class GaussianProcessSearch:
    """Sequential Bayesian optimization — reference ⟦GaussianProcessSearch⟧.

    ``n_seed`` random evaluations, then per iteration: slice-sample GP
    hyperparameters on the unit-cube observations, score a random candidate
    pool with Expected Improvement, evaluate the argmax.
    Prior observations can be injected with ``observe`` (the reference's
    warm-start from past sweeps).
    """

    rescaling: VectorRescaling
    n_seed: int = 3
    n_candidates: int = 512
    kernel_cls: type = Matern52
    n_gp_samples: int = 6
    seed: int = 0

    def __post_init__(self):
        self._obs_u: list[np.ndarray] = []
        self._obs_y: list[float] = []

    def observe(self, point_native: np.ndarray, value: float) -> None:
        self._obs_u.append(self.rescaling.to_unit(point_native)[0])
        self._obs_y.append(float(value))

    def search(
        self,
        evaluate: EvaluationFunction,
        n: int,
        state: Optional[dict] = None,
        on_trial=None,
    ) -> SearchResult:
        """``state``/``on_trial`` give trial-level checkpoint/resume: every
        completed trial calls ``on_trial(search_state, trial_index)``; a run
        restarted with the last saved state replays the history into the GP,
        restores the PRNG, and evaluates exactly the trials the
        uninterrupted run would have (bit-identical result — tested)."""
        rng = np.random.default_rng(self.seed)
        pts: list[np.ndarray] = []
        vals: list[float] = []
        queue: list[np.ndarray] = []

        if state is not None:
            _restore(state, rng, pts, vals, queue)
            # Warm-start observations injected via observe() before the
            # crashed run are part of the GP posterior; restore them BEFORE
            # replaying trial observations or the resumed proposals diverge.
            self._obs_u = [np.asarray(u) for u in state.get("pre_obs_u", [])]
            self._obs_y = [float(y) for y in state.get("pre_obs_y", [])]
            for p, v in zip(pts, vals):
                self.observe(p, v)
        pre_obs_u = [np.asarray(u) for u in self._obs_u[: len(self._obs_u)
                                                        - len(pts)]]
        pre_obs_y = [float(y) for y in self._obs_y[: len(self._obs_y)
                                                   - len(pts)]]

        def run(native: np.ndarray) -> None:
            v = float(evaluate(native))
            pts.append(native)
            vals.append(v)
            self.observe(native, v)
            logger.info(
                "hyperparameter eval %d: %s -> %.6g",
                len(pts), np.array2string(native, precision=4), v,
            )
            if on_trial is not None:
                s = _trial_state(pts, vals, rng, queue)
                s["pre_obs_u"] = pre_obs_u
                s["pre_obs_y"] = pre_obs_y
                on_trial(s, len(pts))

        if state is None:
            n_seed = min(self.n_seed, n) if not self._obs_y else min(
                max(0, self.n_seed - len(self._obs_y)), n
            )
            queue.extend(self.rescaling.sample(rng, n_seed))

        while len(pts) < n:
            while queue and len(pts) < n:
                run(queue.pop(0))
            if len(pts) >= n:
                break
            u = np.asarray(self._obs_u, float)
            y = np.asarray(self._obs_y, float)
            # Standardize observations for the GP (zero mean unit variance).
            y_std = float(y.std()) or 1.0
            y_n = (y - y.mean()) / y_std
            models = GaussianProcessEstimator(
                kernel_cls=self.kernel_cls,
                n_samples=self.n_gp_samples,
                seed=int(rng.integers(2**31)),
            ).fit(u, y_n)
            cand = rng.random((self.n_candidates, self.rescaling.dim))
            mu, var = predict_mean_var(models, cand)
            ei = expected_improvement(mu, var, best=float(y_n.min()))
            queue.append(
                self.rescaling.from_unit(cand[int(np.argmax(ei))][None, :])[0]
            )

        points = (np.stack(pts) if pts
                  else np.zeros((0, self.rescaling.dim)))
        return SearchResult(points, np.asarray(vals, float))
