"""Metric functions over score / label / weight tensors.

Port of ``photon_tpu/evaluation/metrics.py``: AUC, RMSE, the squared,
logistic, Poisson and smoothed-hinge losses, and the grouped ("sharded")
forms — AUC, precision@k and every pointwise metric by group. Each is a
function of ``(scores, labels, weights[, group_ids])`` tensors on any
device; weight 0 marks padding. Group sums (the JAX ``segment_sum``) sort
the rows by group once per grouping and reduce each segment in a fixed
order (``_Segments``), and prefix sums double in a fixed tree (``_cumsum``):
on CUDA an ``index_add_`` or a ``cumsum`` of floats adds in an order that
varies from run to run, and a checkpoint resume compares these metrics bit
for bit.
Each returns a 0-dim tensor in the promoted dtype of its inputs, as the
JAX functions do.

AUC is the weighted Mann-Whitney statistic with half credit for score ties
(trapezoidal ROC integration).
"""
from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor

_EPS = 1e-12


def _ones_like(scores: Tensor, weights: Optional[Tensor]) -> Tensor:
    return torch.ones_like(scores) if weights is None else weights


class _Segments:
    """Rows grouped by dense ids in [0, n): sorted once (stably), then each
    ``sum`` adds every segment in row order, the same on every run."""

    def __init__(self, ids: Tensor, n: int):
        self.order = torch.argsort(ids, stable=True)
        self.lengths = torch.bincount(ids, minlength=n)

    def sum(self, values: Tensor) -> Tensor:
        return torch.segment_reduce(values[self.order], "sum",
                                    lengths=self.lengths, unsafe=True)


def _cumsum(x: Tensor) -> Tensor:
    """Inclusive prefix sum by doubling (y[i] += y[i - k] for k = 1, 2, 4,
    ...): each element sums its predecessors in a tree fixed by its index,
    the same on every run and device. (A CUDA ``torch.cumsum`` of floats
    over a whole vector adds in an order that varies from run to run.)"""
    y, k, n = x, 1, x.shape[0]
    while k < n:
        y = torch.cat([y[:k], y[k:] + y[:-k]])
        k *= 2
    return y


def _segment_min(values: Tensor, ids: Tensor, n: int) -> Tensor:
    """Per-segment minimum; empty segments hold 0 (their value is never
    read)."""
    return torch.zeros(n, dtype=values.dtype, device=values.device).scatter_reduce_(
        0, ids, values, reduce="amin", include_self=False)


def _nan_like(x: Tensor) -> Tensor:
    return torch.full_like(x, float("nan"))


def _tie_group_ids(sorted_scores: Tensor) -> Tensor:
    """Dense ids of equal-score runs in an already-sorted score vector."""
    boundary = torch.cat([
        torch.zeros(1, dtype=torch.int64, device=sorted_scores.device),
        (sorted_scores[1:] != sorted_scores[:-1]).to(torch.int64)])
    return torch.cumsum(boundary, 0)


def auc(scores: Tensor, labels: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    """Weighted ROC AUC with average-rank (trapezoidal) tie handling:
    AUC = Σ_pos w⁺·(W⁻_below + ½·W⁻_tied) / (W⁺·W⁻). NaN when either class
    has zero total weight."""
    w = _ones_like(scores, weights)
    order = torch.argsort(scores, stable=True)
    s, y, w = scores[order], labels[order], w[order]
    pos_w = w * (y > 0.5)
    neg_w = w * (y <= 0.5)

    g = _tie_group_ids(s)
    n = s.shape[0]
    neg_per_group = _Segments(g, n).sum(neg_w)
    neg_below = _cumsum(neg_per_group) - neg_per_group  # exclusive

    credit = pos_w * (neg_below[g] + 0.5 * neg_per_group[g])
    w_pos = torch.sum(pos_w)
    w_neg = torch.sum(neg_w)
    val = torch.sum(credit) / torch.clamp(w_pos * w_neg, min=_EPS)
    return torch.where((w_pos > 0) & (w_neg > 0), val, _nan_like(val))


def rmse(scores: Tensor, labels: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    w = _ones_like(scores, weights)
    se = w * (scores - labels) ** 2
    return torch.sqrt(torch.sum(se) / torch.clamp(torch.sum(w), min=_EPS))


def squared_loss(scores: Tensor, labels: Tensor,
                 weights: Optional[Tensor] = None) -> Tensor:
    """Weighted mean squared error."""
    w = _ones_like(scores, weights)
    return torch.sum(w * (scores - labels) ** 2) / torch.clamp(torch.sum(w), min=_EPS)


def _softplus(s: Tensor) -> Tensor:
    return torch.logaddexp(torch.zeros_like(s), s)


def logistic_loss(scores: Tensor, labels: Tensor,
                  weights: Optional[Tensor] = None) -> Tensor:
    """Weighted mean logistic negative log-likelihood of raw scores."""
    w = _ones_like(scores, weights)
    ll = _softplus(scores) - labels * scores
    return torch.sum(w * ll) / torch.clamp(torch.sum(w), min=_EPS)


def poisson_loss(scores: Tensor, labels: Tensor,
                 weights: Optional[Tensor] = None) -> Tensor:
    """Weighted mean Poisson negative log-likelihood (dropping log y!)."""
    w = _ones_like(scores, weights)
    nll = torch.exp(scores) - labels * scores
    return torch.sum(w * nll) / torch.clamp(torch.sum(w), min=_EPS)


def _hinge(scores: Tensor, labels: Tensor) -> Tensor:
    t = torch.where(labels > 0.5, 1.0, -1.0).to(scores.dtype)
    z = t * scores
    return torch.where(z >= 1.0, torch.zeros_like(z),
                       torch.where(z <= 0.0, 0.5 - z, 0.5 * (1.0 - z) ** 2))


def smoothed_hinge_loss(scores: Tensor, labels: Tensor,
                        weights: Optional[Tensor] = None) -> Tensor:
    """Weighted mean Rennie smoothed hinge on ±1 targets (0/1 labels)."""
    w = _ones_like(scores, weights)
    return torch.sum(w * _hinge(scores, labels)) / torch.clamp(torch.sum(w), min=_EPS)


# -- grouped ("sharded"/Multi) metrics --------------------------------------


def _group_sort(group_ids: Tensor, scores: Tensor) -> Tensor:
    """Permutation sorting rows by (group, score descending): two stable
    sorts."""
    order1 = torch.argsort(-scores, stable=True)
    order2 = torch.argsort(group_ids[order1], stable=True)
    return order1[order2]


def grouped_auc(scores: Tensor, labels: Tensor, group_ids: Tensor,
                weights: Optional[Tensor] = None,
                num_groups: Optional[int] = None) -> Tensor:
    """Unweighted mean over groups of within-group AUC; groups lacking a
    positive or a negative are skipped. ``group_ids`` are dense ints in
    [0, num_groups)."""
    w = _ones_like(scores, weights)
    m = num_groups if num_groups is not None else scores.shape[0]
    group_ids = group_ids.long()
    order = _group_sort(group_ids, -scores)      # ascending score within group
    gsort, ssort, ysort, wsort = (group_ids[order], scores[order],
                                  labels[order], w[order])
    n = scores.shape[0]

    # Tie runs within (group, score): a run breaks when either changes.
    boundary = torch.cat([
        torch.zeros(1, dtype=torch.int64, device=scores.device),
        ((ssort[1:] != ssort[:-1]) | (gsort[1:] != gsort[:-1])).to(torch.int64)])
    tie = torch.cumsum(boundary, 0)

    pos_w = wsort * (ysort > 0.5)
    neg_w = wsort * (ysort <= 0.5)
    neg_per_tie = _Segments(tie, n).sum(neg_w)
    neg_cum_incl = _cumsum(neg_per_tie)

    # Exclusive prefix of negatives within the group: less the value at the
    # group's first tie run.
    first_tie_of_group = _segment_min(tie, gsort, m)
    neg_before_tie = neg_cum_incl - neg_per_tie
    group_base = neg_before_tie[first_tie_of_group]
    neg_below_in_group = neg_before_tie[tie] - group_base[gsort]

    credit = pos_w * (neg_below_in_group + 0.5 * neg_per_tie[tie])
    groups = _Segments(gsort, m)
    auc_num = groups.sum(credit)
    w_pos = groups.sum(pos_w)
    w_neg = groups.sum(neg_w)
    valid = (w_pos > 0) & (w_neg > 0)
    per_group = auc_num / torch.clamp(w_pos * w_neg, min=_EPS)
    n_valid = torch.sum(valid)
    val = (torch.sum(torch.where(valid, per_group, torch.zeros_like(per_group)))
           / torch.clamp(n_valid, min=1))
    return torch.where(n_valid > 0, val, _nan_like(val))


def grouped_precision_at_k(scores: Tensor, labels: Tensor, group_ids: Tensor,
                           k: int, weights: Optional[Tensor] = None,
                           num_groups: Optional[int] = None) -> Tensor:
    """Mean over groups of (# positives in the group's top-k scores) / k;
    groups with no valid rows are skipped, weight-0 rows ignored."""
    w = _ones_like(scores, weights)
    m = num_groups if num_groups is not None else scores.shape[0]
    group_ids = group_ids.long()
    valid_row = w > 0
    masked = torch.where(valid_row, scores, torch.full_like(scores, float("-inf")))
    order = _group_sort(group_ids, masked)
    gsort = group_ids[order]
    ysort = (labels[order] > 0.5) & valid_row[order]

    n = scores.shape[0]
    pos_idx = torch.arange(n, device=scores.device)
    group_start = _segment_min(pos_idx, gsort, m)
    rank = pos_idx - group_start[gsort]
    in_top_k = (rank < k) & valid_row[order]

    groups = _Segments(gsort, m)
    hits = groups.sum((ysort & in_top_k).to(scores.dtype))
    group_rows = groups.sum(valid_row[order].to(scores.dtype))
    has_rows = group_rows > 0
    per_group = hits / k
    n_valid = torch.sum(has_rows)
    val = (torch.sum(torch.where(has_rows, per_group, torch.zeros_like(per_group)))
           / torch.clamp(n_valid, min=1))
    return torch.where(n_valid > 0, val, _nan_like(val))


def _per_row_loss(kind: str, scores: Tensor, labels: Tensor) -> Tensor:
    if kind in ("RMSE", "SQUARED_LOSS"):
        return (scores - labels) ** 2
    if kind == "LOGISTIC_LOSS":
        return _softplus(scores) - labels * scores
    if kind == "POISSON_LOSS":
        return torch.exp(scores) - labels * scores
    if kind == "SMOOTHED_HINGE_LOSS":
        return _hinge(scores, labels)
    raise ValueError(f"no per-row loss for {kind}")


def grouped_pointwise(kind: str, scores: Tensor, labels: Tensor,
                      group_ids: Tensor, weights: Optional[Tensor] = None,
                      num_groups: Optional[int] = None) -> Tensor:
    """Grouped form of a pointwise metric: the within-group weighted mean of
    the per-row loss (root-mean for RMSE), then the unweighted mean over
    non-empty groups. NaN when every group is empty."""
    w = _ones_like(scores, weights)
    m = num_groups if num_groups is not None else scores.shape[0]
    group_ids = group_ids.long()
    per_row = _per_row_loss(kind, scores, labels)
    groups = _Segments(group_ids, m)
    num = groups.sum(w * per_row)
    den = groups.sum(w)
    val = num / torch.clamp(den, min=_EPS)
    if kind == "RMSE":
        val = torch.sqrt(val)
    valid = den > 0
    n_valid = torch.sum(valid)
    out = (torch.sum(torch.where(valid, val, torch.zeros_like(val)))
           / torch.clamp(n_valid, min=1))
    return torch.where(n_valid > 0, out, _nan_like(out))
