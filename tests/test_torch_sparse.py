"""Kernel K1 of the PyTorch port against the JAX package, on the CPU.

``photon_tpu_torch.ops.cuda_sparse`` holds the Hopper kernels ``ell_matvec``
and ``csc_rmatvec`` (plain and squared) and their plain PyTorch versions.
Here the plain versions, which the wrappers run for CPU tensors, are held
against the JAX Pallas kernel in interpret mode (``matvec_pallas`` /
``rmatvec_pallas``), the JAX ``SparseFeatures`` plain path and a dense numpy
product, on the grid of ``tests/test_pallas_sparse.py``. Tolerance: f32
``atol 5e-5`` (the Pallas tests' own), f64 ``atol 1e-12`` against dense.

The kernels themselves run only on the card: ``test_kernels_match_plain_on_card``
is marked ``cuda`` and skips without one.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu.data.batch import SparseFeatures as JaxSparseFeatures
from photon_tpu.ops.pallas_sparse import (
    build_pallas_aux,
    matvec_pallas,
    rmatvec_pallas,
)
from photon_tpu_torch.data.batch import SparseFeatures, ell_from_rows
from photon_tpu_torch.ops import cuda_sparse as cs

ATOL_F32 = 5e-5
ATOL_F64 = 1e-12
CASES = ["300x200x4", "1000x700x6", "257x129x3", "hot_dup"]


def _random_ell(rng, n, d, k, ghost_frac=0.2):
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
    ghost = rng.random((n, k)) < ghost_frac
    idx = np.where(ghost, d, idx)
    val = np.where(idx < d, rng.normal(size=(n, k)), 0.0).astype(np.float32)
    return idx, val


def _dense(idx, val, d, square=False):
    n, k = idx.shape
    a = np.zeros((n, d), np.float64)
    v = val.astype(np.float64) ** 2 if square else val.astype(np.float64)
    rows = np.repeat(np.arange(n), k)
    keep = idx.ravel() < d
    np.add.at(a, (rows[keep], idx.ravel()[keep]), v.ravel()[keep])
    return a


@functools.lru_cache(maxsize=None)
def _case(name):
    """(idx, val, d, w, dz) for one grid case; the hot/duplicate case is the
    one of ``test_pallas_sparse.test_duplicate_and_skewed_columns``."""
    if name == "hot_dup":
        rng = np.random.default_rng(0)
        n, d, k = 400, 100, 5
        idx, val = _random_ell(rng, n, d, k, ghost_frac=0.0)
        idx[:, 0] = 7          # hot column in every row
        idx[:, 1] = idx[:, 2]  # duplicates within rows
        val = np.where(idx < d, val, 0.0).astype(np.float32)
    else:
        n, d, k = (int(x) for x in name.split("x"))
        rng = np.random.default_rng(n)
        idx, val = _random_ell(rng, n, d, k)
    w = rng.normal(size=d).astype(np.float32)
    dz = rng.normal(size=n).astype(np.float32)
    return idx, val, d, w, dz


@functools.lru_cache(maxsize=None)
def _jax_refs(name):
    """The JAX package's results: Pallas kernel (interpret mode) and the
    plain SparseFeatures path, for matvec, rmatvec and sq_rmatvec."""
    idx, val, d, w, dz = _case(name)
    aux = build_pallas_aux(idx, val, d)
    jw, jdz = jnp.asarray(w), jnp.asarray(dz)
    plain = JaxSparseFeatures(jnp.asarray(idx), jnp.asarray(val), d)
    return {
        "pallas": (
            np.asarray(matvec_pallas(aux, jw, interpret=True)),
            np.asarray(rmatvec_pallas(aux, jdz, interpret=True)),
            np.asarray(rmatvec_pallas(aux, jdz, square_vals=True, interpret=True)),
        ),
        "jax_plain": (
            np.asarray(plain.matvec(jw)),
            np.asarray(plain.rmatvec(jdz)),
            np.asarray(plain.sq_rmatvec(jdz)),
        ),
    }


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", CASES)
def test_ell_matvec_plain_matches_jax(name):
    idx, val, d, w, _ = _case(name)
    z = cs.ell_matvec_plain(_t(idx), _t(val), _t(w), d).numpy()
    assert z.dtype == np.float32 and z.shape == (idx.shape[0],)
    refs = _jax_refs(name)
    np.testing.assert_allclose(z, refs["pallas"][0], rtol=0, atol=ATOL_F32)
    np.testing.assert_allclose(z, refs["jax_plain"][0], rtol=0, atol=ATOL_F32)
    np.testing.assert_allclose(z, _dense(idx, val, d) @ w, rtol=0, atol=ATOL_F32)


@pytest.mark.parametrize("square", [False, True], ids=["rmatvec", "sq_rmatvec"])
@pytest.mark.parametrize("name", CASES)
def test_csc_rmatvec_plain_matches_jax(name, square):
    idx, val, d, _, dz = _case(name)
    csc = cs.build_csc(_t(idx), _t(val), d)
    g = cs.csc_rmatvec_plain(csc, _t(dz), square=square).numpy()
    assert g.dtype == np.float32 and g.shape == (d,)
    which = 2 if square else 1
    refs = _jax_refs(name)
    np.testing.assert_allclose(g, refs["pallas"][which], rtol=0, atol=ATOL_F32)
    np.testing.assert_allclose(g, refs["jax_plain"][which], rtol=0, atol=ATOL_F32)
    np.testing.assert_allclose(
        g, _dense(idx, val, d, square).T @ dz, rtol=0, atol=ATOL_F32
    )


@pytest.mark.parametrize("name", ["1000x700x6", "hot_dup"])
def test_plain_versions_float64_match_dense(name):
    idx, val, d, w, dz = _case(name)
    val64 = val.astype(np.float64)
    w64, dz64 = w.astype(np.float64), dz.astype(np.float64)
    z = cs.ell_matvec_plain(_t(idx), _t(val64), _t(w64), d).numpy()
    assert z.dtype == np.float64
    np.testing.assert_allclose(z, _dense(idx, val64, d) @ w64, rtol=0, atol=ATOL_F64)
    csc = cs.build_csc(_t(idx), _t(val64), d)
    for square in (False, True):
        g = cs.csc_rmatvec_plain(csc, _t(dz64), square=square).numpy()
        np.testing.assert_allclose(
            g, _dense(idx, val64, d, square).T @ dz64, rtol=0, atol=ATOL_F64
        )


def test_build_csc_is_column_sorted_and_stable():
    """Ghost entries drop out; columns come in order; within a column the
    entries keep their row-major ELL order (numpy's stable argsort, as the
    column-sorted table of ``photon_tpu/ops/fast_sparse.py``)."""
    idx, val, d, _, _ = _case("hot_dup")
    idx = idx.copy()
    idx[::7, 3] = d                      # some ghosts
    csc = cs.build_csc(_t(idx), _t(val), d)
    flat = idx.ravel()
    keep = flat < d
    rows = np.repeat(np.arange(idx.shape[0]), idx.shape[1])[keep]
    order = np.argsort(flat[keep], kind="stable")
    np.testing.assert_array_equal(csc.rows.numpy(), rows[order])
    np.testing.assert_array_equal(csc.vals.numpy(), val.ravel()[keep][order])
    np.testing.assert_array_equal(
        csc.colptr.numpy(),
        np.concatenate([[0], np.cumsum(np.bincount(flat[keep], minlength=d))]),
    )
    assert csc.colptr.dtype == torch.int64 and csc.rows.dtype == torch.int32
    assert (csc.n_rows, csc.dim, csc.nnz) == (idx.shape[0], d, int(keep.sum()))


def test_out_of_range_columns_contribute_zero():
    """Columns past dim (not only the ghost == dim) and negative columns
    read as 0 in the matvec and drop out of the CSC list."""
    idx = torch.tensor([[0, 3, 9, -2], [2, 2, 4, 1]], dtype=torch.int32)
    val = torch.tensor([[1.0, 2.0, 5.0, 7.0], [3.0, 4.0, 6.0, 0.5]])
    w = torch.tensor([1.0, 10.0, 100.0, 1000.0])
    np.testing.assert_array_equal(
        cs.ell_matvec(idx, val, w, 4).numpy(), [2001.0, 705.0]
    )
    csc = cs.build_csc(idx, val, 4)
    assert csc.nnz == 5
    np.testing.assert_array_equal(
        cs.csc_rmatvec(csc, torch.tensor([1.0, 2.0])).numpy(),
        [1.0, 1.0, 14.0, 2.0],
    )


def test_sparse_features_matvec_dispatches_plain_on_cpu():
    """On CPU tensors the port's ``SparseFeatures.matvec`` runs the plain
    version (no kernel launch is counted) and matches the JAX plain path."""
    idx, val, d, w, _ = _case("300x200x4")
    sf = SparseFeatures(_t(idx), _t(val), d)
    assert sf.with_accelerator_paths() is sf
    cs.reset_launch_counts()
    z = sf.matvec(_t(w))
    assert cs.launch_counts() == {name: 0 for name in cs.KERNELS}
    np.testing.assert_array_equal(
        z.numpy(), cs.ell_matvec_plain(_t(idx), _t(val), _t(w), d).numpy()
    )
    np.testing.assert_allclose(
        z.numpy(), _jax_refs("300x200x4")["jax_plain"][0], rtol=0, atol=ATOL_F32
    )


def test_ell_from_rows_matches_jax():
    from photon_tpu.data.batch import ell_from_rows as jax_ell_from_rows

    rows = [([0, 3], [1.5, -2.0]), ([], []), ([2, 2, 1], [0.1, 0.2, 0.3])]
    ours = ell_from_rows(rows, dim=4, dtype=torch.float32, device=torch.device("cpu"))
    ref = jax_ell_from_rows(rows, dim=4, dtype=jnp.float32)
    np.testing.assert_array_equal(ours.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(ours.val.numpy(), np.asarray(ref.val))
    assert ours.idx.dtype == torch.int32 and ours.val.dtype == torch.float32


@pytest.mark.parametrize("bad", ["idx_dtype", "val_shape", "w_len", "w_dtype",
                                 "non_contiguous", "v_len"])
def test_wrappers_reject_bad_inputs(bad):
    idx, val, d, w, dz = _case("257x129x3")
    idx, val, w, dz = _t(idx), _t(val), _t(w), _t(dz)
    csc = cs.build_csc(idx, val, d)
    if bad == "idx_dtype":
        call = lambda: cs.ell_matvec(idx.long(), val, w, d)  # noqa: E731
    elif bad == "val_shape":
        call = lambda: cs.ell_matvec(idx, val[:, :2].contiguous(), w, d)  # noqa: E731
    elif bad == "w_len":
        call = lambda: cs.ell_matvec(idx, val, w[:-1], d)  # noqa: E731
    elif bad == "w_dtype":
        call = lambda: cs.ell_matvec(idx, val, w.double(), d)  # noqa: E731
    elif bad == "non_contiguous":
        call = lambda: cs.ell_matvec(idx.t().contiguous().t(), val, w, d)  # noqa: E731
    else:
        call = lambda: cs.csc_rmatvec(csc, dz[:-1])  # noqa: E731
    with pytest.raises((TypeError, ValueError)):
        call()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernels_match_plain_on_card(name, cuda_device):
    """The kernels against their plain versions on the card, f32 at the
    Pallas tests' tolerance; two transpose runs are bit-equal."""
    idx, val, d, w, dz = _case(name)
    i, v = _t(idx).to(cuda_device), _t(val).to(cuda_device)
    cs.reset_launch_counts()
    z = cs.ell_matvec(i, v, _t(w).to(cuda_device), d)
    csc = cs.build_csc(i, v, d)
    g1 = cs.csc_rmatvec(csc, _t(dz).to(cuda_device))
    g2 = cs.csc_rmatvec(csc, _t(dz).to(cuda_device))
    gs = cs.csc_rmatvec(csc, _t(dz).to(cuda_device), square=True)
    torch.cuda.synchronize()
    assert cs.launch_counts() == {
        "ell_matvec": 1, "csc_rmatvec": 2, "csc_sq_rmatvec": 1}
    assert torch.equal(g1, g2)
    refs = _jax_refs(name)["pallas"]
    for got, ref in ((z, refs[0]), (g1, refs[1]), (gs, refs[2])):
        np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=0, atol=ATOL_F32)
