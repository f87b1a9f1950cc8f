"""The port's metrics and evaluators against ``photon_tpu/evaluation``.

Same numpy inputs, on the CPU: every metric function and every evaluator
spec form ("AUC", the five pointwise losses, "<metric>:col" grouped forms,
"PRECISION@k:col"), with score ties (scores rounded to a coarse grid),
weight-0 padding rows, groups with one class only, empty group ids, and
both float64 inputs and the validation path's mix (float64 scores, float32
labels and integer float32 weights, whose float32 sums are exact in any
order). Values agree to 1e-12 relative (NaN where JAX gives NaN), but
for the grouped AUC of float32 weights: its mean over groups adds float32
per-group AUCs, in another order in each package, so it agrees to 4
float32 ulps (5e-7); the plain AUC of the same float32 inputs is exact.
Parsing, names, directions and ``better_than`` agree exactly.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu.evaluation import EvaluationSuite as JaxSuite
from photon_tpu.evaluation import metrics as jm
from photon_tpu.evaluation import parse_evaluator as jax_parse
from photon_tpu_torch.evaluation import EvaluationSuite, parse_evaluator
from photon_tpu_torch.evaluation import metrics as tm

RTOL = {np.dtype(np.float64): 1e-12, np.dtype(np.float32): 5e-7}


def data(seed, n=300, n_groups=17, ties=True, mixed=False):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=n) * 1.5
    if ties:
        scores = np.round(scores * 4) / 4          # many tied scores
    labels = (rng.random(n) < 1 / (1 + np.exp(-scores))).astype(np.float64)
    # float32 weights (the validation path's) are small integers: their
    # float32 sums are exact in any order, so the two packages' different
    # summation orders cannot show; float64 weights are arbitrary.
    weights = (rng.integers(1, 3, size=n).astype(np.float64) if mixed
               else rng.uniform(0.5, 2.0, size=n))
    weights[rng.random(n) < 0.1] = 0.0              # padding rows
    groups = rng.integers(0, n_groups, size=n)
    groups[groups == 3] = 4                         # group 3 is empty
    labels[groups == 5] = 1.0                       # group 5 has one class
    lw = np.float32 if mixed else np.float64
    return scores, labels.astype(lw), weights.astype(lw), groups.astype(np.int32), n_groups


def both(a):
    return jnp.asarray(a), torch.from_numpy(np.asarray(a))


def close(got, want, dtype=None):
    """``dtype``: the result's dtype where ``want`` is a Python float."""
    rtol = RTOL[np.dtype(dtype or np.asarray(want).dtype)]
    got, want = float(got), float(want)
    if math.isnan(want):
        assert math.isnan(got)
    else:
        assert abs(got - want) <= rtol * max(abs(want), 1e-300), (got, want)


SIMPLE = ["auc", "rmse", "squared_loss", "logistic_loss", "poisson_loss",
          "smoothed_hinge_loss"]


@pytest.mark.parametrize("mixed", [False, True], ids=["f64", "f64_scores_f32_weights"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", SIMPLE)
def test_simple_metrics_match(name, seed, mixed):
    s, y, w, _, _ = data(seed, mixed=mixed)
    (js, ts), (jy, ty), (jw, tw) = both(s), both(y), both(w)
    close(getattr(tm, name)(ts, ty, tw), getattr(jm, name)(js, jy, jw))
    close(getattr(tm, name)(ts, ty), getattr(jm, name)(js, jy))


@pytest.mark.parametrize("mixed", [False, True], ids=["f64", "f64_scores_f32_weights"])
@pytest.mark.parametrize("num_groups", [None, 17])
def test_grouped_metrics_match(mixed, num_groups):
    s, y, w, g, _ = data(2, mixed=mixed)
    (js, ts), (jy, ty), (jw, tw), (jg, tg) = both(s), both(y), both(w), both(g)
    close(tm.grouped_auc(ts, ty, tg, tw, num_groups),
          jm.grouped_auc(js, jy, jg, jw, num_groups))
    for k in (1, 3, 50):
        close(tm.grouped_precision_at_k(ts, ty, tg, k, tw, num_groups),
              jm.grouped_precision_at_k(js, jy, jg, k, jw, num_groups))
    for kind in ("RMSE", "SQUARED_LOSS", "LOGISTIC_LOSS", "POISSON_LOSS",
                 "SMOOTHED_HINGE_LOSS"):
        close(tm.grouped_pointwise(kind, ts, ty, tg, tw, num_groups),
              jm.grouped_pointwise(kind, js, jy, jg, jw, num_groups))


def test_degenerate_inputs_give_nan_as_jax():
    s = np.array([0.1, 0.2, 0.2])
    y = np.ones(3)
    w = np.ones(3)
    g = np.zeros(3, np.int32)
    (js, ts), (jy, ty), (jw, tw), (jg, tg) = both(s), both(y), both(w), both(g)
    close(tm.auc(ts, ty, tw), jm.auc(js, jy, jw))
    close(tm.grouped_auc(ts, ty, tg, tw, 1), jm.grouped_auc(js, jy, jg, jw, 1))
    z = np.zeros(3)
    close(tm.grouped_precision_at_k(ts, ty, tg, 2, torch.from_numpy(z), 1),
          jm.grouped_precision_at_k(js, jy, jg, 2, jnp.asarray(z), 1))
    assert math.isnan(float(tm.auc(ts, ty, tw)))


SPECS = ["AUC", "rmse", "SQUARED_LOSS", "LOGISTIC_LOSS", "POISSON_LOSS",
         "SMOOTHED_HINGE_LOSS", "AUC:queryId", "RMSE:queryId",
         "LOGISTIC_LOSS:queryId", "PRECISION@3:queryId", "precision@1:queryId"]


@pytest.mark.parametrize("spec", SPECS)
def test_evaluator_specs_match(spec):
    je, te = jax_parse(spec), parse_evaluator(spec)
    assert (te.name, te.kind, te.bigger_is_better, te.k, te.group_column) == \
        (je.name, je.kind, je.bigger_is_better, je.k, je.group_column)
    s, y, w, g, m = data(3, mixed=True)
    (js, ts), (jy, ty), (jw, tw), (jg, tg) = both(s), both(y), both(w), both(g)
    close(te.evaluate(ts, ty, tw, tg, m), je.evaluate(js, jy, jw, jg, m),
          np.float32 if te.kind == "GROUPED_AUC" else np.float64)
    for a, b in ((0.5, 0.6), (0.6, 0.5), (float("nan"), 0.5), (0.5, float("nan")),
                 (0.5, 0.5)):
        assert te.better_than(a, b) == je.better_than(a, b)


def test_suite_matches_and_bad_specs_raise():
    specs = ["AUC", "LOGISTIC_LOSS", "AUC:queryId", "PRECISION@2:queryId"]
    s, y, w, g, m = data(4, mixed=True)
    (js, ts), (jy, ty), (jw, tw), (jg, tg) = both(s), both(y), both(w), both(g)
    want = JaxSuite.parse(specs).evaluate(js, jy, jw, {"queryId": jg}, {"queryId": m})
    got = EvaluationSuite.parse(specs).evaluate(ts, ty, tw, {"queryId": tg},
                                                {"queryId": m})
    assert list(got.values) == list(want.values) and got.primary_name == want.primary_name
    for k in want.values:
        close(got.values[k], want.values[k],
              np.float32 if k == "AUC:queryId" else np.float64)
    for bad in ("NOPE", "FOO:col", ""):
        with pytest.raises(ValueError):
            parse_evaluator(bad) if bad else EvaluationSuite.parse([])
    with pytest.raises(ValueError, match="group ids"):
        EvaluationSuite.parse(["AUC:queryId"]).evaluate(ts, ty, tw)


def _grouped_inputs(n=5000, groups=40, seed=3):
    rng = np.random.default_rng(seed)
    scores = torch.from_numpy(rng.normal(size=n))
    labels = torch.from_numpy((rng.random(n) < 0.4).astype(np.float64))
    weights = torch.from_numpy(rng.random(n))
    gids = torch.from_numpy(rng.integers(0, groups, size=n))
    return scores, labels, weights, gids, groups


def test_segment_sum_equals_index_add():
    """The sorted, segmented group sum equals the index_add_ it replaced,
    and the doubling prefix sum the cumsum it replaced (f64, within 1e-12
    of the largest)."""
    scores, _, weights, gids, m = _grouped_inputs()
    old = torch.zeros(m, dtype=torch.float64).index_add_(0, gids, weights * scores)
    new = tm._Segments(gids, m).sum(weights * scores)
    assert torch.abs(new - old).max() <= 1e-12 * torch.abs(old).max()
    for n in (1, 2, 7, 5000):
        old = torch.cumsum(weights[:n] * scores[:n], 0)
        new = tm._cumsum(weights[:n] * scores[:n])
        assert torch.abs(new - old).max() <= 1e-12 * torch.abs(old).max()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA paths have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_grouped_metrics_repeat_bit_equal_on_card(cuda_device):
    """Grouped metrics on the card repeat bit for bit (a resumed fit's
    tracker compares them so)."""
    scores, labels, weights, gids, m = (
        t.to(cuda_device) if isinstance(t, torch.Tensor) else t
        for t in _grouped_inputs(n=1 << 18, groups=1000))
    for fn in (lambda: tm.grouped_auc(scores, labels, gids, weights, m),
               lambda: tm.grouped_pointwise("LOGISTIC_LOSS", scores, labels,
                                            gids, weights, m)):
        first = fn()
        for _ in range(5):
            assert torch.equal(fn(), first)
