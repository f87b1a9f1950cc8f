"""The port's float32 solves against the JAX package's, on the CPU.

Equal float32 inputs go through both packages' fixed-effect L-BFGS and
primal Newton random-effect bucket solve (``scripts/f32_stopping_vs_jax.py``,
which prints the full table). The objective tracks differ in their last
bits from the first iteration on (the port's passes sum in float64 and round
once, and torch reduces in another order than XLA), by at most a few ulps.
Where the tolerance sits above that resolution (1e-5) the stopping
decisions are JAX's: the fixed effect's iterations, reason and data passes,
and every Newton lane's iterations. At the default 1e-7, which tests
one-ulp changes of the objective, they may stop an iteration apart; the
coefficients stay within 1e-3 of the largest (fixed effect) and 1e-4
(Newton lanes).
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

import f32_stopping_vs_jax as f32cmp  # noqa: E402


@pytest.mark.parametrize("seed", [0, 3])
def test_fixed_effect_f32_stops_as_jax_above_f32_resolution(seed):
    out = f32cmp.fixed_effect(seed, 1e-5)
    assert out["iterations"][0] == out["iterations"][1]
    assert out["reasons"][0] == out["reasons"][1]
    assert out["data_passes"][0] == out["data_passes"][1]
    assert out["max_value_ulps"] <= 4
    assert out["coef_rel_err"] <= 1e-6
    tight = f32cmp.fixed_effect(seed, 1e-7)
    assert tight["max_value_ulps"] <= 4
    assert abs(tight["iterations"][0] - tight["iterations"][1]) <= 2
    assert tight["coef_rel_err"] <= 1e-3


def test_newton_bucket_f32_lanes_stop_as_jax_above_f32_resolution():
    out = f32cmp.newton_bucket(0, 1e-5)
    assert out["iterations_apart"] == 0
    assert out["coef_rel_err"] <= 1e-4
    tight = f32cmp.newton_bucket(0, 1e-7)
    assert tight["iterations_apart"] <= 0.1 * tight["lanes"]
    assert tight["coef_rel_err"] <= 1e-4
