"""Data-parallel fixed-effect training over a device mesh.

Port of ``photon_tpu/parallel/data_parallel.py``. The JAX package has two
implementations of the same program: ``fit_data_parallel`` (GSPMD: XLA
partitions ``problem.run`` and inserts the all-reduce) and
``spmd_value_and_grad`` (an explicit ``shard_map`` + ``psum``). PyTorch
has no partitioner, so in the port both names are thin entry points to the
one explicit implementation, ``parallel/spmd_objective.py``: the batch
cut into row blocks over the ``data`` axis, each block's partials computed
on its device by the hand-written kernels, and the deterministic fold of
``parallel/mesh.py`` in place of the all-reduce.
"""
from __future__ import annotations

from photon_tpu_torch.parallel.mesh import DATA_AXIS
from photon_tpu_torch.parallel.spmd_objective import SpmdGLMObjective, fit_spmd

__all__ = ["fit_data_parallel", "spmd_value_and_grad"]


def fit_data_parallel(problem, batch, w0, mesh, data_axis=DATA_AXIS,
                      normalization=None):
    """The full solve with the batch row-sharded over ``data_axis`` (one
    axis or a tuple such as ``("dcn", "data")``): ``fit_spmd``, with the
    problem's normalization context and variances. Rows that do not divide
    the axis size are padded with weight-0 rows. Returns
    ``(GeneralizedLinearModel, OptimizerResult)``."""
    return fit_spmd(problem, batch, w0, mesh, data_axis,
                    normalization=normalization)


def spmd_value_and_grad(obj, batch, mesh, data_axis=DATA_AXIS):
    """``w ↦`` the folded (value, grad) of ``obj`` over ``batch`` sharded on
    ``mesh``; the L2 term (and prior) added once, after the fold."""
    return SpmdGLMObjective.build(obj, batch, mesh, data_axis).value_and_grad
