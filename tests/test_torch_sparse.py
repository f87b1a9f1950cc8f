"""Kernel K1 of the PyTorch port against the JAX package, on the CPU.

``photon_tpu_torch.ops.cuda_sparse`` holds the Hopper kernels ``ell_matvec``
and ``csc_rmatvec`` (plain and squared) and their plain PyTorch versions.
Here the plain versions, which the wrappers run for CPU tensors, are held
against the JAX Pallas kernel in interpret mode (``matvec_pallas`` /
``rmatvec_pallas``), the JAX ``SparseFeatures`` plain path and a dense numpy
product, on the grid of ``tests/test_pallas_sparse.py`` plus layouts that
stress the transpose kernel's merge-path tiles (a column over several tiles,
columns ending on tile boundaries, runs of empty columns, no entries).
Tolerance: f32 ``atol 5e-5`` (the Pallas tests' own), f64 ``atol 1e-12``
against dense.

The transpose kernel's tile partition is checked for its invariants, and
``_emulate_csc_kernel`` repeats the kernel's summation order (per-thread
walks, block segmented scan, fix-up of split columns) in plain torch: it is
held against the same references here, and the kernel must equal it bit for
bit on the card.

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
CASES = ["300x200x4", "1000x700x6", "257x129x3", "hot_dup",
         "long_col", "tile_edge", "empty_runs", "nnz0"]
TILE = cs.TILE_ITEMS
# tile_edge: column 0 ends on the last item of tile 0, column 1 fills tile 1
# and ends on the first item of tile 2, column 5 spans two more boundaries.
TILE_EDGE_LENGTHS = [TILE - 1, TILE, 7, 0, 0, 2 * TILE + 1, 3]


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
    elif name == "long_col":
        # column 5 in every row: 7,000 entries, more than three tiles; its
        # values scaled by 1/sqrt(n) keep its sum O(1), within reach of the
        # JAX plain path's float32 sum at the file's absolute tolerance
        rng = np.random.default_rng(1)
        n, d, k = 7000, 300, 3
        idx, val = _random_ell(rng, n, d, k)
        idx[:, 0] = 5
        val[:, 0] = rng.normal(size=n) / np.sqrt(n)
    elif name == "tile_edge":
        # one entry a row, rows grouped by column at the stated lengths;
        # values scaled by 1/64 as in long_col (columns of up to 4,097)
        rng = np.random.default_rng(2)
        d = len(TILE_EDGE_LENGTHS)
        idx = np.repeat(np.arange(d), TILE_EDGE_LENGTHS).astype(np.int32)[:, None]
        n = idx.shape[0]
        val = (rng.normal(size=(n, 1)) / 64).astype(np.float32)
    elif name == "empty_runs":
        # columns 100..3999 (more than a tile of column ends) and
        # 4100..5999 (trailing) are empty
        rng = np.random.default_rng(3)
        n, d, k = 500, 6000, 3
        idx, val = _random_ell(rng, n, 200, k)
        idx = np.where(idx >= 100, idx + 3900, idx)
        idx = np.where(idx == 4100, d, idx).astype(np.int32)
        val = np.where(idx < d, val, 0.0).astype(np.float32)
    elif name == "nnz0":
        # every entry a ghost: only column ends, over two tiles
        rng = np.random.default_rng(4)
        n, d, k = 50, 3000, 2
        idx = np.full((n, k), d, np.int32)
        val = np.zeros((n, k), np.float32)
    else:
        n, d, k = (int(x) for x in name.split("x"))
        rng = np.random.default_rng(n)
        idx, val = _random_ell(rng, n, d, k)
    w = rng.normal(size=d).astype(np.float32)
    dz = rng.normal(size=idx.shape[0]).astype(np.float32)
    return idx, val, d, w, dz


def _emulate_csc_kernel(csc, v, square=False):
    """The transpose kernel's summation order, in plain torch (float64).

    Per merge-path tile: each of ``CSC_THREADS`` threads walks
    ``CSC_ITEMS_PER_THREAD`` consecutive items, writing the columns that
    begin and end in its run; a segmented inclusive scan of the threads'
    open-column partials (within a warp by shuffles at distances 1..16, then
    the earlier warps' totals, nearest first) gives each thread the part of
    its first column summed before it; a column begun in an earlier tile
    leaves a head partial, and the column open at the tile's end a tail.
    Then each split column sums its tails lane-strided over 32 lanes, by a
    xor butterfly, and adds its head. Every addition is the kernel's, in
    the kernel's order, so the card must give the same bits.
    """
    nthreads, ipt, warp = cs.CSC_THREADS, cs.CSC_ITEMS_PER_THREAD, 32
    f64 = torch.float64
    x = csc.vals.double()
    if square:
        x = x * x
    rows = csc.rows.long()
    ok = (rows >= 0) & (rows < csc.n_rows)
    prod = torch.where(ok, x * v.double()[rows.clamp(0, max(csc.n_rows - 1, 0))],
                       torch.zeros((), dtype=f64))
    tiles = csc.tiles.tolist()
    colptr = csc.colptr
    g = torch.zeros(csc.dim, dtype=f64)
    partials = torch.zeros(2 * (len(tiles) - 1), dtype=f64)
    tid = torch.arange(nthreads)
    lane, wid = tid % warp, tid // warp
    zero = torch.zeros(nthreads, dtype=f64)
    for t in range(len(tiles) - 1):
        (i0, j0), (i1, j1) = tiles[t], tiles[t + 1]
        nc, ne = i1 - i0, j1 - j0
        n_items = nc + ne
        ends = colptr[i0 + 1:i1 + 1] - j0
        ends_ext = torch.cat([ends, torch.tensor([2**62])])
        p_ext = torch.cat([prod[j0:j1], torch.zeros(1, dtype=f64)])
        d = torch.clamp(tid * ipt, max=n_items)
        col = torch.searchsorted(ends + torch.arange(nc), d)
        y = d - col
        first = col.clone()
        run, head = zero.clone(), zero.clone()
        emitted = torch.zeros(nthreads, dtype=torch.bool)
        for i in range(ipt):
            active = d + i < n_items
            is_entry = active & (y < ends_ext[col])
            is_end = active & ~is_entry
            run = torch.where(is_entry, run + p_ext[torch.clamp(y, max=ne)], run)
            write = is_end & emitted
            g[i0 + col[write]] = run[write]
            take = is_end & ~emitted
            head = torch.where(take, run, head)
            emitted = emitted | take
            run = torch.where(is_end, zero, run)
            y = y + is_entry.long()
            col = col + is_end.long()
        s = run
        for off in (1, 2, 4, 8, 16):
            src = torch.clamp(tid - off, min=0)
            s = torch.where((lane >= off) & (col[src] == col), s[src] + s, s)
        wsum, wkey = s[warp - 1::warp], col[warp - 1::warp]
        carry, going = zero.clone(), torch.ones(nthreads, dtype=torch.bool)
        for m in range(1, nthreads // warp):
            u = torch.clamp(wid - m, min=0)
            going = going & (wid - m >= 0) & (wkey[u] == col)
            carry = torch.where(going, carry + wsum[u], carry)
        s = s + carry
        value = torch.cat([torch.zeros(1, dtype=f64), s[:-1]]) + head
        split_head = bool(nc > 0 and colptr[i0] < j0)
        for th in torch.nonzero(emitted).reshape(-1).tolist():
            if first[th] == 0 and split_head:
                partials[2 * t] = value[th]
            else:
                g[i0 + first[th]] = value[th]
        partials[2 * t + 1] = s[-1]
    for c, a, h in csc.splits.tolist():
        acc = torch.zeros(warp, dtype=f64)
        for tt in range(a, h):
            acc[(tt - a) % warp] += partials[2 * tt + 1]
        for off in (16, 8, 4, 2, 1):
            acc = acc + acc[torch.arange(warp) ^ off]
        g[c] = acc[0] + partials[2 * h]
    return g.to(v.dtype)


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


@pytest.mark.parametrize("name", CASES)
def test_merge_path_tiles_cover_every_item_once(name):
    """Tile t starts at merged item t·TILE: its (column, entry) coordinate
    sums to that, never decreases, and is a valid merge position (columns
    before it ended, entries of its column not past the column's end); the
    last coordinate is (dim, nnz). The split list names exactly the columns
    whose items span two tiles or more, with the tile holding their end as
    head and the first tile left open in that column as first tail."""
    idx, val, d, _, _ = _case(name)
    csc = cs.build_csc(_t(idx), _t(val), d)
    colptr, tiles = csc.colptr.numpy(), csc.tiles.numpy()
    total = d + csc.nnz
    n_tiles = -(-total // TILE)
    assert tiles.dtype == np.int64 and tiles.shape == (n_tiles + 1, 2)
    col, ent = tiles[:, 0], tiles[:, 1]
    np.testing.assert_array_equal(
        col + ent, np.minimum(np.arange(n_tiles + 1) * TILE, total))
    assert (np.diff(col) >= 0).all() and (np.diff(ent) >= 0).all()
    assert tuple(tiles[-1]) == (d, csc.nnz)
    inner = col < d
    assert (colptr[col[inner]] <= ent[inner]).all()
    assert (ent[inner] <= colptr[col[inner] + 1]).all()
    # brute force: the tile of each column's first item and of its end
    c = np.arange(d)
    first_tile = (colptr[:-1] + c) // TILE
    end_tile = (colptr[1:] + c) // TILE
    split = np.nonzero(first_tile < end_tile)[0]
    splits = csc.splits.numpy()
    assert splits.dtype == np.int64 and splits.shape == (len(split), 3)
    np.testing.assert_array_equal(splits[:, 0], split)
    np.testing.assert_array_equal(splits[:, 2], end_tile[split])
    for cc, a, h in splits:
        assert col[a + 1] == cc and (a == 0 or col[a] < cc) and a < h
        assert (col[a + 1:h + 1] == cc).all()
    if name == "tile_edge":
        ends = colptr[1:] + c
        assert (ends % TILE == TILE - 1).any() and (ends % TILE == 0).any()
        assert len(split) >= 2


@pytest.mark.parametrize("name", CASES)
def test_partition_depends_only_on_the_input(name):
    """Two layouts built from one input give equal partitions, and so the
    kernel's summation order (here: its emulation) gives equal bits."""
    idx, val, d, _, dz = _case(name)
    a = cs.build_csc(_t(idx), _t(val), d)
    b = cs.build_csc(_t(idx.copy()), _t(val.copy()), d)
    assert torch.equal(a.tiles, b.tiles) and torch.equal(a.splits, b.splits)
    assert torch.equal(_emulate_csc_kernel(a, _t(dz)), _emulate_csc_kernel(b, _t(dz)))


@pytest.mark.parametrize("square", [False, True], ids=["rmatvec", "sq_rmatvec"])
@pytest.mark.parametrize("name", CASES)
def test_csc_kernel_order_matches_jax(name, square):
    """The kernel's tile-and-carry summation order against the Pallas
    kernel (interpret mode), the JAX plain path and the dense product in
    f32, and against the dense product in f64."""
    idx, val, d, _, dz = _case(name)
    csc = cs.build_csc(_t(idx), _t(val), d)
    g = _emulate_csc_kernel(csc, _t(dz), square=square).numpy()
    assert g.dtype == np.float32 and g.shape == (d,)
    which = 2 if square else 1
    refs = _jax_refs(name)
    np.testing.assert_allclose(g, refs["pallas"][which], rtol=0, atol=ATOL_F32)
    np.testing.assert_allclose(g, refs["jax_plain"][which], rtol=0, atol=ATOL_F32)
    np.testing.assert_allclose(
        g, _dense(idx, val, d, square).T @ dz, rtol=0, atol=ATOL_F32
    )
    val64, dz64 = val.astype(np.float64), dz.astype(np.float64)
    csc64 = cs.build_csc(_t(idx), _t(val64), d)
    g64 = _emulate_csc_kernel(csc64, _t(dz64), square=square).numpy()
    assert g64.dtype == np.float64
    np.testing.assert_allclose(
        g64, _dense(idx, val64, d, square).T @ dz64, rtol=0, atol=ATOL_F64
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
    Pallas tests' tolerance; two transpose runs are bit-equal, and equal to
    the emulation of the kernel's summation order, in f32 and f64."""
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
    for dtype in (np.float32, np.float64):
        val_t, dz_t = _t(val.astype(dtype)), _t(dz.astype(dtype))
        host = cs.build_csc(_t(idx), val_t, d)
        dev = cs.build_csc(i, val_t.to(cuda_device), d)
        for square in (False, True):
            got = cs.csc_rmatvec(dev, dz_t.to(cuda_device), square=square)
            assert torch.equal(got.cpu(), _emulate_csc_kernel(host, dz_t, square))
