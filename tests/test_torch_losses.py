"""The PyTorch port's pointwise losses against the JAX package's.

``loss``, ``d1``, ``d2`` and ``mean`` of all four losses, on the same
numpy-made margins and labels (``tests/test_losses.py``'s label kinds; the
margins add |z| ≥ 30 and the smoothed hinge's kinks to a normal grid), in
float64: ``rtol 1e-14``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu.ops import losses as jax_losses
from photon_tpu.types import TaskType as JaxTaskType
from photon_tpu_torch.ops import losses
from photon_tpu_torch.types import TaskType

NAMES = ["logistic", "squared", "poisson", "smoothed_hinge"]


def _grid(rng):
    return np.concatenate([
        rng.normal(size=64) * 2.0,
        [-100.0, -50.0, -35.0, -30.0, -20.0, -1e-3, 0.0, 1e-3, 20.0, 30.0,
         35.0, 50.0, 100.0],
        rng.uniform(0.1, 0.8, size=32),
        [-1.0, 0.5, 1.0, 1.5],
    ])


def _labels(name, rng, n):
    if name in ("logistic", "smoothed_hinge"):
        return rng.integers(0, 2, size=n).astype(np.float64)
    if name == "poisson":
        return rng.poisson(2.0, size=n).astype(np.float64)
    return rng.normal(size=n)


@pytest.mark.parametrize("name", NAMES)
def test_losses_match_jax(name):
    rng = np.random.default_rng(NAMES.index(name))
    z = _grid(rng)
    y = _labels(name, rng, len(z))
    ref, port = jax_losses.get_loss(name), losses.get_loss(name)
    zj, yj = jnp.asarray(z), jnp.asarray(y)
    zt, yt = torch.from_numpy(z), torch.from_numpy(y)
    for fn in ("loss", "d1", "d2"):
        got = getattr(port, fn)(zt, yt)
        assert got.dtype == torch.float64 and got.shape == zt.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(ref, fn)(zj, yj)),
                                   rtol=1e-14, atol=0, err_msg=f"{name}.{fn}")
    np.testing.assert_allclose(port.mean(zt).numpy(), np.asarray(ref.mean(zj)),
                               rtol=1e-14, atol=0, err_msg=f"{name}.mean")


def test_logistic_loss_is_exact_where_softplus_switches():
    """At z ≥ 20 ``torch.nn.functional.softplus`` returns z; the exact
    log(1 + e^z) differs from it by e^-z, which the port keeps."""
    z = torch.tensor([20.0, 25.0, 30.0], dtype=torch.float64)
    y = torch.zeros(3, dtype=torch.float64)
    got = losses.LogisticLoss.loss(z, y)
    np.testing.assert_allclose(got.numpy(), z.numpy() + np.log1p(np.exp(-z.numpy())),
                               rtol=1e-15, atol=0)
    assert (got > z).all()


@pytest.mark.parametrize("task", list(TaskType), ids=lambda t: t.name)
def test_loss_for_task_matches_jax(task):
    assert (losses.loss_for_task(task).name
            == jax_losses.loss_for_task(JaxTaskType[task.name]).name)
