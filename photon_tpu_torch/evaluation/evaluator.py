"""Evaluator objects, spec parsing and evaluation suites.

Port of ``photon_tpu/evaluation/evaluator.py``: an evaluator knows its name
and direction (is bigger better), a suite bundles several with the first as
primary, and specs parse from strings — "AUC", "RMSE", "LOGISTIC_LOSS",
"AUC:queryId" and "RMSE:queryId" for grouped forms, "PRECISION@5:queryId".

The score input is the additive GAME score (raw linear scale); each
evaluator applies whatever link it needs.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Mapping, Optional, Sequence

import torch

from photon_tpu_torch.evaluation import metrics

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Evaluator:
    """A named metric with an ordering. ``group_column`` marks grouped
    forms, which need per-row group ids at evaluate time."""

    name: str
    kind: str
    bigger_is_better: bool
    k: Optional[int] = None
    group_column: Optional[str] = None

    def evaluate(
        self,
        scores: Tensor,
        labels: Tensor,
        weights: Optional[Tensor] = None,
        group_ids: Optional[Tensor] = None,
        num_groups: Optional[int] = None,
    ) -> float:
        simple = {
            "AUC": metrics.auc, "RMSE": metrics.rmse,
            "SQUARED_LOSS": metrics.squared_loss,
            "LOGISTIC_LOSS": metrics.logistic_loss,
            "POISSON_LOSS": metrics.poisson_loss,
            "SMOOTHED_HINGE_LOSS": metrics.smoothed_hinge_loss,
        }
        if self.kind in simple:
            return float(simple[self.kind](scores, labels, weights))
        if group_ids is None:
            raise ValueError(f"{self.name} needs group_ids")
        if self.kind == "GROUPED_AUC":
            v = metrics.grouped_auc(scores, labels, group_ids, weights, num_groups)
        elif self.kind == "PRECISION_AT_K":
            v = metrics.grouped_precision_at_k(
                scores, labels, group_ids, self.k, weights, num_groups)
        elif self.kind.startswith("GROUPED_"):
            v = metrics.grouped_pointwise(
                self.kind[len("GROUPED_"):], scores, labels, group_ids,
                weights, num_groups)
        else:  # pragma: no cover - parse_evaluator keeps kinds closed
            raise ValueError(f"unknown evaluator kind {self.kind}")
        return float(v)

    def better_than(self, a: float, b: float) -> bool:
        """Is metric value ``a`` strictly better than ``b`` (NaN never wins)?"""
        if math.isnan(a):
            return False
        if math.isnan(b):
            return True
        return a > b if self.bigger_is_better else a < b


_PRECISION_RE = re.compile(r"^PRECISION@(\d+):(.+)$", re.IGNORECASE)

_SIMPLE_KINDS = {
    "AUC": True,                 # kind -> bigger_is_better
    "RMSE": False,
    "SQUARED_LOSS": False,
    "LOGISTIC_LOSS": False,
    "POISSON_LOSS": False,
    "SMOOTHED_HINGE_LOSS": False,
}


def parse_evaluator(spec: str) -> Evaluator:
    """Parse an evaluator spec: "AUC" | "RMSE" | "SQUARED_LOSS" |
    "LOGISTIC_LOSS" | "POISSON_LOSS" | "SMOOTHED_HINGE_LOSS" |
    "<one of those>:groupCol" | "PRECISION@k:groupCol"."""
    s = spec.strip()
    m = _PRECISION_RE.match(s)
    if m:
        k, col = int(m.group(1)), m.group(2)
        return Evaluator(
            name=f"PRECISION@{k}:{col}", kind="PRECISION_AT_K",
            bigger_is_better=True, k=k, group_column=col,
        )
    if ":" in s:
        head, col = s.split(":", 1)
        head = head.strip().upper()
        if head in _SIMPLE_KINDS:
            kind = "GROUPED_AUC" if head == "AUC" else f"GROUPED_{head}"
            return Evaluator(
                name=f"{head}:{col}", kind=kind,
                bigger_is_better=_SIMPLE_KINDS[head], group_column=col,
            )
        raise ValueError(f"unknown grouped evaluator {spec!r}")
    kind = s.upper()
    if kind not in _SIMPLE_KINDS:
        raise ValueError(f"unknown evaluator {spec!r}")
    return Evaluator(name=kind, kind=kind, bigger_is_better=_SIMPLE_KINDS[kind])


@dataclasses.dataclass(frozen=True)
class EvaluationResults:
    """Metric values keyed by evaluator name; ``primary_name`` is the
    suite's first."""

    values: Mapping[str, float]
    primary_name: str

    @property
    def primary(self) -> float:
        return self.values[self.primary_name]

    def __repr__(self) -> str:
        vals = ", ".join(f"{k}={v:.6g}" for k, v in self.values.items())
        return f"EvaluationResults({vals}; primary={self.primary_name})"


@dataclasses.dataclass(frozen=True)
class EvaluationSuite:
    """Several evaluators over one validation set; the first is primary."""

    evaluators: Sequence[Evaluator]

    @staticmethod
    def parse(specs: Sequence[str]) -> "EvaluationSuite":
        if not specs:
            raise ValueError("at least one evaluator spec required")
        return EvaluationSuite(tuple(parse_evaluator(s) for s in specs))

    @property
    def primary(self) -> Evaluator:
        return self.evaluators[0]

    def evaluate(
        self,
        scores: Tensor,
        labels: Tensor,
        weights: Optional[Tensor] = None,
        group_ids_by_column: Optional[Mapping[str, Tensor]] = None,
        num_groups_by_column: Optional[Mapping[str, int]] = None,
    ) -> EvaluationResults:
        values = {}
        for ev in self.evaluators:
            gid = ng = None
            if ev.group_column is not None:
                if not group_ids_by_column or ev.group_column not in group_ids_by_column:
                    raise ValueError(
                        f"evaluator {ev.name} needs group ids for column "
                        f"{ev.group_column!r}"
                    )
                gid = group_ids_by_column[ev.group_column]
                if num_groups_by_column:
                    ng = num_groups_by_column.get(ev.group_column)
            values[ev.name] = ev.evaluate(scores, labels, weights, gid, ng)
        return EvaluationResults(values, self.evaluators[0].name)
