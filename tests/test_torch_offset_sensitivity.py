"""How far fit A's per-user coefficients move when the fixed effect's offsets
move by one float ulp, on the CPU at a small size.

Under the 4-shard mesh, fit A's f32 per-user coefficients end ~1e-3 of the
largest from the unsharded fit, while the f64 witness agrees to ~1e-16 and
the two fixed effects' coefficients differ by ~6e-7 (``ROADMAP.md`` Queue 3).
This measures the f32 per-user solve's own sensitivity, as phase ``mesh`` of
``chip_smoke.py`` does on the card (``chip_smoke.offset_ulp_sensitivity``):
fit A's random effect (the per-user effect over the global shard, 16 rows a
user, L2 weight 1, logistic, the Newton dual plan) solved alone at the
offsets of a fit's final fixed effect and at each offset's next float up.

* In float64 the coefficients move by ~1e-16 of the largest and every lane
  takes the same Newton iterations: the solve is smooth, and the offsets'
  one-ulp move comes through at its own size.
* In float32 a one-ulp move of the offsets (~6e-8 relative) moves the
  coefficients by ~1e-4 of the largest, and some lanes stop a Newton
  iteration earlier or later: their f32 stopping test turns on the last
  bits, and a lane that stops an iteration apart is apart by that
  iteration's step. So two f32 paths whose fixed effects round differently
  cannot be held to 1e-3 on the per-user coefficients; the f64 witness is
  the bar.

The CPU gives the same bits on every run, so the amplification shows
deterministically; the bounds below leave an order of magnitude each way.
"""
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
USERS = 800


def _sensitivity(dtype):
    sys.path.insert(0, REPO)
    import chip_smoke as smk
    from photon_tpu_torch.ops import cuda_sparse as cs

    cpu = torch.device("cpu")
    sizes = dict(smk.GAME, n_users=USERS)
    arrays = smk.game_arrays_bench(seed=2, **sizes)
    est = smk.game_estimator("global", 1, ())
    bundle = smk.game_bundle(torch, arrays, cpu, dtype)
    cfgs = smk.game_configs((1.0,), 6, "NONE")
    fit = smk.game_fit(torch, cs, est, bundle, None, cfgs)
    out = smk.offset_ulp_sensitivity(torch, est, bundle, fit, cfgs[0]["perUser"])
    assert {solver for solver, _ in out["plans"]} == {"newton_dual"}
    assert out["lanes"] == USERS
    return out


@pytest.fixture(scope="module")
def f32():
    return _sensitivity(torch.float32)


@pytest.fixture(scope="module")
def f64():
    return _sensitivity(torch.float64)


def test_f64_per_user_solve_moves_by_the_offsets_ulp(f64):
    assert f64["coef_rel_err"] <= 1e-12
    assert f64["lanes_iterations_differ"] == 0


def test_f32_per_user_solve_amplifies_one_ulp(f32, f64):
    # one f32 ulp of the offsets is ~6e-8 of each; the coefficients move
    # ~1e-4 of the largest, through lanes whose stopping decision flips
    assert 1e-5 <= f32["coef_rel_err"] <= 1e-2
    assert f32["lanes_iterations_differ"] >= 1
    assert f32["coef_rel_err"] >= 1e6 * max(f64["coef_rel_err"], 1e-17)
