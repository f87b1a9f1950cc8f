"""Hosmer–Lemeshow goodness-of-fit test for logistic models.

Port of ``photon_tpu/diagnostics/hosmer_lemeshow.py``: decile-of-risk bins
(quantile edges of the predicted probabilities, numpy's "linear" method, and
``searchsorted`` to the right) and the per-bin weighted sums, on the scores'
device; the chi-square statistic and its p-value on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class HosmerLemeshowResult:
    """Chi-square calibration test over probability bins: ``p_value`` from
    the chi-square distribution with ``df`` degrees of freedom (small values
    reject "the model is well calibrated"). Bin arrays are [G]."""

    statistic: float
    df: int
    p_value: float
    bin_count: np.ndarray
    observed_positives: np.ndarray
    expected_positives: np.ndarray

    @property
    def n_bins(self) -> int:
        return self.bin_count.shape[0]


def _quantile_linear(x: Tensor, qs: Tensor) -> Tensor:
    """numpy's ``quantile(method="linear")`` of a 1-D tensor through a sort
    (``torch.quantile`` refuses inputs above 2^24 elements)."""
    srt = torch.sort(x).values
    pos = qs.double() * (x.shape[0] - 1)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=x.shape[0] - 1)
    frac = (pos - lo).to(x.dtype)
    a, b = srt[lo], srt[hi]
    return a + frac * (b - a)


def hosmer_lemeshow(scores, labels, n_bins: int = 10,
                    weights: Optional[Tensor] = None) -> HosmerLemeshowResult:
    """HL test from raw margins (pre-sigmoid scores) and 0/1 labels: the
    statistic Σ_g (O_g − E_g)² / (E_g (1 − E_g / n_g)) over ``n_bins``
    quantile bins of the predicted probability, df = n_bins − 2 (bins with
    rows). With ``weights`` the bin totals are weighted sums (the edges stay
    plain score quantiles)."""
    s = torch.as_tensor(scores)
    p = torch.sigmoid(s)
    w = torch.ones_like(p) if weights is None else torch.as_tensor(weights).to(p)
    y = torch.as_tensor(labels).to(p)
    qs = torch.linspace(0.0, 1.0, n_bins + 1, dtype=torch.float64)[1:-1]
    edges = _quantile_linear(p, qs.to(p.device))
    g = torch.searchsorted(edges, p, right=True)

    def bin_sum(v: Tensor) -> np.ndarray:
        out = torch.zeros(n_bins, dtype=torch.float64, device=p.device)
        return out.index_add_(0, g, v.double()).cpu().numpy()

    count, obs, exp = bin_sum(w), bin_sum(w * y), bin_sum(w * p)
    keep = count > 0
    denom = exp * (1.0 - exp / np.maximum(count, 1.0))
    terms = np.where(keep & (denom > 1e-12),
                     (obs - exp) ** 2 / np.maximum(denom, 1e-12), 0.0)
    stat = float(terms.sum())
    df = max(int(keep.sum()) - 2, 1)
    # p = 1 − chi2.cdf(stat, df) = Q(df/2, stat/2), the regularized upper
    # incomplete gamma function.
    from scipy.special import gammaincc

    return HosmerLemeshowResult(
        statistic=stat, df=df, p_value=float(gammaincc(df / 2.0, stat / 2.0)),
        bin_count=count, observed_positives=obs, expected_positives=exp)
