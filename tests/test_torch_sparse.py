"""Kernel K1 of the PyTorch port against the JAX package, on the CPU.

``photon_tpu_torch.ops.cuda_sparse`` holds the Hopper kernels
``ell_panel_matvec``, ``ell_matvec`` and ``csc_rmatvec`` (plain and squared)
and their plain PyTorch versions.
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
bit on the card. Likewise the panel matvec: ``build_panels``' tile-and-panel
layout is checked for its invariants on the grid and on edge layouts (dim
not a multiple of the panel, one panel, a short last tile, an empty panel,
a column in every row, no entries), its cost rule on both sides, and
``_emulate_panel_kernel`` repeats the kernel's chunked walks, block scans
and per-panel accumulation.

The row-tile matvec ``ell_matvec``: ``_emulate_ell_kernel`` repeats its
summation order (each row's G = ``ell_group(K)`` threads sum contiguous
slices in order, then a fixed pairwise tree) and is held against the same
references on the grid, on a block-diagonal lane layout
(``LaneFeatures.from_bucket``) and at the K edges of the group rule (K = 1,
G·ELL_ITEMS ± 1, 33, rows of 400 and 1,100 entries, the last longer than a
quarter stage); ``ell_tile_plan``'s rule is checked for its invariants.

The kernels themselves run only on the card: the tests marked ``cuda``
(``test_kernels_match_plain_on_card`` and the kernel-against-emulation
tests) skip without one.
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
from photon_tpu_torch.data.batch import (
    LabeledBatch,
    LaneFeatures,
    SparseFeatures,
    ell_from_rows,
)
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
    keep = (idx.ravel() >= 0) & (idx.ravel() < d)
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


def _emulate_block_scan(s, key):
    """The kernels' ``block_segmented_scan``: an inclusive scan of the
    threads' partials ``s`` segmented by ``key``, within a warp by shuffles
    at distances 1..16, then the earlier warps' totals, nearest first."""
    warp = 32
    nthreads = s.shape[0]
    tid = torch.arange(nthreads)
    lane, wid = tid % warp, tid // warp
    for off in (1, 2, 4, 8, 16):
        src = torch.clamp(tid - off, min=0)
        s = torch.where((lane >= off) & (key[src] == key), s[src] + s, s)
    wsum, wkey = s[warp - 1::warp], key[warp - 1::warp]
    carry = torch.zeros(nthreads, dtype=s.dtype)
    going = torch.ones(nthreads, dtype=torch.bool)
    for m in range(1, nthreads // warp):
        u = torch.clamp(wid - m, min=0)
        going = going & (wid - m >= 0) & (wkey[u] == key)
        if not going.any():
            break
        carry = torch.where(going, carry + wsum[u], carry)
    return s + carry


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
        s = _emulate_block_scan(run, col)
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


def _emulate_panel_kernel(panels, w):
    """The panel matvec's summation order, in plain torch (float64).

    Per tile, per panel with entries, per chunk of ``PANEL_THREADS`` x
    ``PANEL_ITEMS`` entries: each thread walks its consecutive entries from
    the key of the entry before them (-1 at a segment's start; thread 0 of
    a later chunk starts from the carried partial of the previous chunk's
    open row), closing a row where the key changes; the block scan gives
    each thread's first row the partial summed before it; the row still
    open at the segment's end is added by the last thread. Each row's panel
    partial is added to its float64 accumulator once, in panel order, and
    rounds once at the end. Every addition is the kernel's, in the kernel's
    order, so the card must give the same bits.
    """
    nthreads, items = cs.PANEL_THREADS, cs.PANEL_ITEMS
    chunk = nthreads * items
    f64 = torch.float64
    rows_t, cols_p = panels.tile_rows, panels.panel_cols
    code = panels.codes.long() & 0xFFFFFFFF
    lrow, lcol = code >> cs.CODE_SHIFT, code & ((1 << cs.CODE_SHIFT) - 1)
    vals, w64 = panels.vals.double(), w.double()
    z = torch.zeros(panels.n_rows, dtype=f64)
    d = torch.arange(nthreads) * items
    zero = torch.zeros(nthreads, dtype=f64)
    last = torch.tensor([nthreads - 1])

    def emit(acc, key, value, mask):
        m = mask & (key >= 0) & (key < rows_t)   # one emission per row
        acc[key[m]] = acc[key[m]] + value[m]

    off = panels.offsets.tolist()
    for t in range(panels.n_tiles):
        acc = torch.zeros(rows_t, dtype=f64)
        for p in range(panels.n_panels):
            s0, s1 = off[t][p], off[t][p + 1]
            wp = w64[p * cols_p:(p + 1) * cols_p]
            carry = torch.zeros((), dtype=f64)
            for pos in range(s0, s1, chunk):
                n = min(chunk, s1 - pos)
                prev = pos + torch.clamp(d, max=n) - 1
                key = torch.where(prev >= s0, lrow[prev.clamp(min=0)], -1)
                first = key.clone()
                run, head = zero.clone(), zero.clone()
                if pos > s0:
                    run[0] = carry
                emitted = torch.zeros(nthreads, dtype=torch.bool)
                for k in range(items):
                    active = d + k < n
                    e = pos + torch.clamp(d + k, max=n - 1)
                    row = lrow[e]
                    change = active & (row != key)
                    emit(acc, key, run, change & emitted)
                    take = change & ~emitted
                    head = torch.where(take, run, head)
                    emitted = emitted | take
                    run = torch.where(change, zero, run)
                    key = torch.where(change, row, key)
                    prod = vals[e] * wp[lcol[e].clamp(max=wp.shape[0] - 1)]
                    run = torch.where(active & (row != cs.PAD_ROW), run + prod, run)
                s = _emulate_block_scan(run, key)
                emit(acc, first, torch.cat([zero[:1], s[:-1]]) + head, emitted)
                carry = s[-1]
                if pos + n == s1:
                    emit(acc, key[last], s[last], torch.ones(1, dtype=torch.bool))
        r0 = t * rows_t
        z[r0:r0 + rows_t] = acc[:panels.n_rows - r0]
    return z.to(w.dtype)


def _pair_tree(p):
    """The kernels' pairwise tree over the last axis (a power of two):
    element x adds element x + m, at m = half the width down to 1."""
    m = p.shape[-1]
    while m > 1:
        m //= 2
        p = p[..., :m] + p[..., m:2 * m]
    return p[..., 0]


def _emulate_ell_kernel(idx, val, w, dim):
    """The row-tile matvec's summation order, in plain torch (float64).

    Each row of K entries is summed by G = ``ell_group(K)`` threads: thread
    g adds the products of its slice [g·L, (g+1)·L), L = ceil(K/G), in
    order from 0 (an entry outside [0, dim) adds nothing); the G partials
    combine by a pairwise tree within each warp of 32, then over the
    warps' sums for G > 32. Rounds once. Tiles, chunks and the grid do not
    enter: every addition is the kernel's, in the kernel's order, so the
    card must give the same bits.
    """
    n, k = idx.shape
    group = cs.ell_group(k)
    width = -(-k // group)
    f64 = torch.float64
    ok = (idx >= 0) & (idx < dim)
    w_ext = torch.cat([w.double(), torch.zeros(1, dtype=f64)])
    prod = torch.where(ok, val.double() * w_ext[torch.where(ok, idx, dim).long()],
                       torch.zeros((), dtype=f64))
    padded = torch.zeros((n, group * width), dtype=f64)
    padded[:, :k] = prod
    parts = padded.reshape(n, group, width)
    acc = torch.zeros((n, group), dtype=f64)
    for i in range(width):
        acc = acc + parts[:, :, i]
    if group > 32:
        acc = _pair_tree(acc.reshape(n, group // 32, 32))
    return _pair_tree(acc).to(val.dtype)


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
    assert cs.launch_counts() == {name: 0 for name in cs.ALL_KERNELS}
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
                                 "non_contiguous", "v_len", "panel_w_len",
                                 "panel_w_dtype", "panel_sizes"])
def test_wrappers_reject_bad_inputs(bad):
    idx, val, d, w, dz = _case("257x129x3")
    idx, val, w, dz = _t(idx), _t(val), _t(w), _t(dz)
    csc = cs.build_csc(idx, val, d)
    lay = cs.panel_layout(idx, val, d, 64, 64)
    if bad == "panel_w_len":
        call = lambda: cs.ell_panel_matvec(lay, w[:-1])  # noqa: E731
    elif bad == "panel_w_dtype":
        call = lambda: cs.ell_panel_matvec(lay, w.double())  # noqa: E731
    elif bad == "panel_sizes":
        call = lambda: cs.panel_layout(idx, val, d, 0, 1 << 17)  # noqa: E731
    elif bad == "idx_dtype":
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


# ------------------------------------------------------- row-tile matvec

# Layouts at the edges of ell_matvec's group rule (ELL_ITEMS = 12: K up to
# 24 takes G = 2, up to 48 G = 4), the block-diagonal lane layout of the
# vmapped random-effect tier, and long rows (400 entries: G = 64, a tree
# over two warps; 1,100: more than a quarter stage, a tile of its own).
ELL_CASES = ["k1", "k23", "k25", "k33", "k47", "k49", "lanes", "row400", "row1100"]


@functools.lru_cache(maxsize=None)
def _ell_case(name):
    """(idx, val, d, w) in float32 for one of ELL_CASES; ghosts at d."""
    rng = np.random.default_rng(21)
    if name == "lanes":
        # 6 lanes x S = 16 rows x K = 17 over P = 256 local columns, 20%
        # ghosts, as LaneFeatures.from_bucket lays a bucket out
        e, s_, k, p = 6, 16, 17, 256
        local = rng.integers(0, p, size=(e, s_, k)).astype(np.int32)
        local = np.where(rng.random((e, s_, k)) < 0.2, p, local).astype(np.int32)
        lv = np.where(local < p, rng.normal(size=(e, s_, k)), 0.0).astype(np.float32)
        flat = LaneFeatures.from_bucket(_t(local), _t(lv), p).flat
        idx, val, d = flat.idx.numpy(), flat.val.numpy(), flat.dim
        assert d == e * p and (idx == d).any()
    else:
        n, k, d = {"k1": (300, 1, 50), "k23": (150, 23, 400), "k25": (150, 25, 400),
                   "k33": (130, 33, 400), "k47": (70, 47, 500), "k49": (70, 49, 500),
                   "row400": (20, 400, 700), "row1100": (5, 1100, 900)}[name]
        idx, val = _random_ell(rng, n, d, k)
        # values scaled by 1/sqrt(K) keep the long rows' sums O(1), within
        # reach of the JAX plain path's float32 sum at the file's tolerance
        val = (val / np.sqrt(k)).astype(np.float32)
    w = rng.normal(size=d).astype(np.float32)
    return idx, val, d, w


@functools.lru_cache(maxsize=None)
def _ell_refs(name):
    """The JAX package's matvec on an ELL_CASES layout: the Pallas kernel
    (interpret mode) and the plain SparseFeatures path."""
    idx, val, d, w = _ell_case(name)
    aux = build_pallas_aux(idx, val, d)
    plain = JaxSparseFeatures(jnp.asarray(idx), jnp.asarray(val), d)
    return (np.asarray(matvec_pallas(aux, jnp.asarray(w), interpret=True)),
            np.asarray(plain.matvec(jnp.asarray(w))))


def _check_ell_order(idx, val, d, w, refs):
    """The row-tile kernel's summation order against the JAX references
    and the dense product in f32, and against the dense product in f64."""
    z = _emulate_ell_kernel(_t(idx), _t(val), _t(w), d).numpy()
    assert z.dtype == np.float32 and z.shape == (idx.shape[0],)
    for ref in refs:
        np.testing.assert_allclose(z, ref, rtol=0, atol=ATOL_F32)
    np.testing.assert_allclose(z, _dense(idx, val, d) @ w, rtol=0, atol=ATOL_F32)
    val64, w64 = val.astype(np.float64), w.astype(np.float64)
    z64 = _emulate_ell_kernel(_t(idx), _t(val64), _t(w64), d).numpy()
    assert z64.dtype == np.float64
    np.testing.assert_allclose(z64, _dense(idx, val64, d) @ w64, rtol=0, atol=ATOL_F64)


@pytest.mark.parametrize("name", CASES)
def test_ell_kernel_order_matches_jax(name):
    idx, val, d, w, _ = _case(name)
    refs = _jax_refs(name)
    _check_ell_order(idx, val, d, w, (refs["pallas"][0], refs["jax_plain"][0]))


@pytest.mark.parametrize("name", ELL_CASES)
def test_ell_kernel_order_matches_jax_at_k_edges(name):
    idx, val, d, w = _ell_case(name)
    k = idx.shape[1]
    group = cs.ell_group(k)
    if name in ("k23", "k25", "k47", "k49"):
        # one entry short of a group's items, or one over: a group twice as wide
        edge = {"k23": 2, "k25": 2, "k47": 4, "k49": 4}[name] * cs.ELL_ITEMS
        assert abs(k - edge) == 1 and group == (edge // cs.ELL_ITEMS) * (1 + (k > edge))
    if name == "row400":
        assert group > 32                       # the tree crosses warps
    if name == "row1100":
        assert cs.ell_tile_plan(k, torch.float32).tile_rows == 1
        assert k > cs.ELL_STAGE_ENTRIES // 4
    _check_ell_order(idx, val, d, w, _ell_refs(name))


def test_ell_emulation_is_the_slice_and_tree_order():
    """Hand-made rows: K = 33 gives G = 4 slices of 9, 9, 9, 6 entries
    summed in order and combined as (s0 + s2) + (s1 + s3), and the
    emulation reproduces those bits where the plain sum's order would
    not (values chosen so that order changes the float64 result)."""
    assert cs.ell_group(33) == cs.ell_tile_plan(33, torch.float64).group == 4
    rng = np.random.default_rng(23)
    vals = rng.normal(size=(8, 33)) * 10.0 ** rng.integers(-8, 17, size=(8, 33))
    idx = np.tile(np.arange(33, dtype=np.int32), (8, 1))
    w = np.ones(33)
    got = _emulate_ell_kernel(_t(idx), _t(vals), _t(w), 33).numpy()
    for row, value in zip(vals, got):
        s = [0.0] * 4
        for g in range(4):
            for x in row[9 * g:9 * g + 9]:
                s[g] = s[g] + x
        assert value == (s[0] + s[2]) + (s[1] + s[3])
    assert not np.array_equal(
        got, cs.ell_matvec_plain(_t(idx), _t(vals), _t(w), 33).numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [0, 1, 2, 3, 4, 5, 8, 16, 17, 31, 32, 33, 63, 64, 65,
                               256, 300, 1023, 1024, 1025, 5000])
def test_ell_tile_plan_rule(k, dtype):
    """R·K entries are a multiple of 16 bytes in both arrays and fit a
    stage (rows up to a quarter stage; a longer row is a tile alone); two
    stages fit the shared memory a block may use; G is a power of two that
    depends on K alone, the least with G·ELL_ITEMS ≥ K up to a block; and
    the tiles cover the H100's 132 SMs wherever the matrix holds 132
    stages of entries (132 rows, where a row is longer than a stage)."""
    plan = cs.ell_tile_plan(k, dtype)
    itemsize = torch.finfo(dtype).bits // 8
    assert plan.stage % 4 == 0
    if k <= plan.stage // 4:
        assert plan.tile_rows >= 1 and plan.tile_rows * k <= plan.stage
        assert plan.tile_rows * k * 4 % 16 == 0
        assert plan.tile_rows * k * itemsize % 16 == 0
        assert (plan.tile_rows + 4) * max(k, 1) > plan.stage    # as many as fit
    else:
        assert plan.tile_rows == 1
    assert cs.ell_smem_bytes(dtype, plan.stage) <= cs.ELL_SMEM_LIMIT
    g = plan.group
    assert g & (g - 1) == 0 and 1 <= g <= cs.ELL_THREADS
    assert g == cs.ell_group(k) == cs.ell_tile_plan(k, torch.float32).group
    assert g * cs.ELL_ITEMS >= k or g == cs.ELL_THREADS
    assert g == 1 or (g // 2) * cs.ELL_ITEMS < k
    assert -(-k // g) <= cs.ELL_ITEMS or g == cs.ELL_THREADS     # a slice in one load
    n = -(-cs.H100_SMS * plan.stage // max(k, 1)) if k <= plan.stage else cs.H100_SMS
    assert -(-n // plan.tile_rows) >= cs.H100_SMS


def test_ell_tile_plan_at_chip_smoke_shapes():
    """The layouts where the path runs ell_matvec: fit C's lanes (1.6M x
    17), the drivers' rows (32,768 x 33) and the 2^19 x 32 scoring layout
    all give at least 132 tiles."""
    for n, k in ((1_600_000, 17), (32_768, 33), (1 << 19, 32)):
        for dtype in (torch.float32, torch.float64):
            plan = cs.ell_tile_plan(k, dtype)
            assert -(-n // plan.tile_rows) >= cs.H100_SMS
    assert cs.ell_tile_plan(17, torch.float32).tile_rows == 240
    assert cs.ell_tile_plan(33, torch.float32).tile_rows == 124


def test_ell_matvec_takes_row_sliced_views_on_cpu():
    """A row-sliced view (its base 68 bytes into the array at K = 17) is
    contiguous and goes through the wrapper as any input: on the CPU to the
    plain version, equal to the same rows of the whole matrix."""
    idx, val, d, w = _ell_case("lanes")
    i, v = _t(idx)[3:], _t(val)[3:]
    assert i.is_contiguous() and i.data_ptr() % 16 == 12
    np.testing.assert_array_equal(cs.ell_matvec(i, v, _t(w), d).numpy(),
                                  cs.ell_matvec(_t(idx), _t(val), _t(w), d).numpy()[3:])


# ------------------------------------------------------------ panel matvec

# (tile_rows, panel_cols) for a layout of n rows: "small" cuts the test
# cases into many tiles and panels; "kernel" is build_panels' own choice;
# "wide" puts up to 8,192 rows in one tile, so long segments span several
# kernel chunks and carry a row from one chunk to the next.
EDGE_LAYOUTS = ["dim_not_multiple", "dim_below_panel", "rows_not_multiple",
                "empty_panel", "column_every_row", "nnz0"]


def _panel_sizes(shape, n, dtype=torch.float32):
    if shape == "small":
        return 64, 64
    if shape == "wide":
        return cs.MAX_TILE_ROWS, cs.panel_cols(dtype)
    return cs.tile_rows_for(n), cs.panel_cols(dtype)


@functools.lru_cache(maxsize=None)
def _edge_case(name):
    """(idx, val, d, w, tile_rows, panel_cols): small layouts at the edges
    of the tile and panel grid, cut with 16-row tiles and 8-column panels."""
    rng = np.random.default_rng(11)
    n, d, k = 40, 24, 3
    if name == "dim_below_panel":
        n, d, k = 30, 5, 4                      # one panel, narrower than C
    elif name == "rows_not_multiple":
        n = 37                                  # last tile holds 5 rows
    elif name == "dim_not_multiple":
        d = 21                                  # last panel holds 5 columns
    idx, val = _random_ell(rng, n, d, k)
    if name == "dim_not_multiple":
        idx[0, 0], idx[1, 1] = -2, d + 5        # out of range, value kept
        val[0, 0], val[1, 1] = 3.0, -4.0
    elif name == "empty_panel":
        idx = np.where((idx >= 8) & (idx < 16), idx + 8, idx).astype(np.int32)
    elif name == "column_every_row":
        idx[:, 0] = 7
        idx[:, 1] = idx[:, 2]                   # duplicates within rows
        val = np.where(idx < d, rng.normal(size=(n, k)), 0.0).astype(np.float32)
    elif name == "nnz0":
        idx = np.full((n, k), d, np.int32)
        val = np.zeros((n, k), np.float32)
    w = rng.normal(size=d).astype(np.float32)
    return idx, val, d, w, 16, 8


def _check_panel_layout(lay, idx, val, d):
    """The layout's invariants, against a numpy model of it: offsets are
    [T, P+1], monotone and chained tile to tile; each segment holds exactly
    its kept entries, stable by segment (so rows ascend and each row keeps
    its ELL order), each decoding back to its (row, column) and value, then
    fewer than SEGMENT_ALIGN skip entries of value 0; ghost and
    out-of-range entries are gone."""
    n, k = idx.shape
    rows_t, cols_p = lay.tile_rows, lay.panel_cols
    n_tiles, n_panels = -(-n // rows_t), -(-d // cols_p)
    off = lay.offsets.numpy()
    assert off.dtype == np.int64 and off.shape == (n_tiles, n_panels + 1)
    assert (np.diff(off, axis=1) >= 0).all()
    assert off[0, 0] == 0 and off[-1, -1] == lay.codes.shape[0]
    np.testing.assert_array_equal(off[1:, 0], off[:-1, -1])
    assert (np.diff(off, axis=1) % cs.SEGMENT_ALIGN == 0).all()
    assert lay.codes.dtype == torch.int32 and lay.vals.dtype == torch.from_numpy(val).dtype
    assert (lay.n_rows, lay.dim, lay.n_tiles, lay.n_panels) == (n, d, n_tiles, n_panels)

    flat = idx.ravel().astype(np.int64)
    pos = np.nonzero((flat >= 0) & (flat < d))[0]
    rows, cols = pos // k, flat[pos]
    seg = rows // rows_t * n_panels + cols // cols_p
    order = np.argsort(seg, kind="stable")
    counts = np.bincount(seg, minlength=n_tiles * n_panels)

    code = lay.codes.numpy().view(np.uint32).astype(np.int64)
    lrow, lcol = code >> cs.CODE_SHIFT, code & ((1 << cs.CODE_SHIFT) - 1)
    vals = lay.vals.numpy()
    got = ([], [], [])
    for t in range(n_tiles):
        for p in range(n_panels):
            a, b = off[t, p], off[t, p + 1]
            real = lrow[a:b] != cs.PAD_ROW
            m = int(real.sum())
            assert m == counts[t * n_panels + p] and real[:m].all()
            assert b - a - m < cs.SEGMENT_ALIGN
            assert (vals[a + m:b] == 0).all() and (lcol[a + m:b] == 0).all()
            assert (lrow[a:a + m] < rows_t).all() and (lcol[a:a + m] < cols_p).all()
            r = t * rows_t + lrow[a:a + m]
            assert (np.diff(r) >= 0).all()
            got[0].append(r)
            got[1].append(p * cols_p + lcol[a:a + m])
            got[2].append(vals[a:a + m])
    empty = np.zeros(0, np.int64)
    np.testing.assert_array_equal(np.concatenate(got[0] or [empty]), rows[order])
    np.testing.assert_array_equal(np.concatenate(got[1] or [empty]), cols[order])
    np.testing.assert_array_equal(
        np.concatenate(got[2] or [empty]).astype(val.dtype), val.ravel()[pos][order])


@pytest.mark.parametrize("shape", ["small", "kernel"])
@pytest.mark.parametrize("name", CASES)
def test_panel_layout_invariants(name, shape):
    idx, val, d, _, _ = _case(name)
    rows_t, cols_p = _panel_sizes(shape, idx.shape[0])
    lay = cs.panel_layout(_t(idx), _t(val), d, rows_t, cols_p)
    _check_panel_layout(lay, idx, val, d)
    again = cs.panel_layout(_t(idx.copy()), _t(val.copy()), d, rows_t, cols_p)
    assert torch.equal(lay.codes, again.codes) and torch.equal(lay.offsets, again.offsets)


@pytest.mark.parametrize("name", EDGE_LAYOUTS)
def test_panel_edge_layouts(name):
    """Edge layouts of the tile and panel grid: the layout's invariants,
    and the kernel's summation order against the dense product (f32 and
    f64) and the plain ELL version."""
    idx, val, d, w, rows_t, cols_p = _edge_case(name)
    n = idx.shape[0]
    lay = cs.panel_layout(_t(idx), _t(val), d, rows_t, cols_p)
    _check_panel_layout(lay, idx, val, d)
    off = lay.offsets.numpy()
    if name == "dim_not_multiple":
        assert lay.n_panels == 3 and d % cols_p == 5
    elif name == "dim_below_panel":
        assert lay.n_panels == 1 and d < cols_p
    elif name == "rows_not_multiple":
        assert lay.n_tiles == 3 and n % rows_t == 5
    elif name == "empty_panel":
        assert (off[:, 2] == off[:, 1]).all() and (off[:, 1] > off[:, 0]).all()
    elif name == "column_every_row":
        assert ((lay.codes.numpy() & 0xFFFF) == 7).sum() >= n
    elif name == "nnz0":
        assert lay.codes.shape[0] == 0
    z = _emulate_panel_kernel(lay, _t(w)).numpy()
    assert z.dtype == np.float32 and z.shape == (n,)
    np.testing.assert_allclose(z, _dense(idx, val, d) @ w, rtol=0, atol=ATOL_F32)
    np.testing.assert_array_equal(
        cs.ell_panel_matvec(lay, _t(w)).numpy(),
        cs.ell_matvec_plain(_t(idx), _t(val), _t(w), d).numpy())
    val64, w64 = val.astype(np.float64), w.astype(np.float64)
    lay64 = cs.panel_layout(_t(idx), _t(val64), d, rows_t, cols_p)
    np.testing.assert_allclose(_emulate_panel_kernel(lay64, _t(w64)).numpy(),
                               _dense(idx, val64, d) @ w64, rtol=0, atol=ATOL_F64)


@pytest.mark.parametrize("rule", ["reloads_cost_more", "gathers_cost_more",
                                  "chip_smoke_sizes"])
def test_build_panels_rule(rule):
    """build_panels gives None exactly where reloading w for every row tile
    moves more L2 bytes than one 32-byte sector per gathered entry, and
    otherwise a layout at the kernel's own tile and panel sizes."""
    if rule == "chip_smoke_sizes":
        # transformer phase: 2^19 rows x 32 entries, 327,680 columns;
        # driver phase: 32,768 rows, 327,681 columns
        assert cs.tile_rows_for(2**19) == 4096 and cs.tile_rows_for(32768) == 1024
        assert cs.tile_rows_for(0) == 1024 and cs.tile_rows_for(10**7) == 8192
        assert cs.panels_pay_off(2**19, 327680, 2**19 * 32, 4)
        assert not cs.panels_pay_off(32768, 327681, 32768 * 32, 4)
        assert cs.panel_cols(torch.float32) == 16384 and cs.panel_cols(torch.float64) == 8192
        return
    rng = np.random.default_rng(12)
    n, d, k = (300, 200_000, 2) if rule == "reloads_cost_more" else (2000, 1000, 8)
    idx, val = _random_ell(rng, n, d, k)
    nnz = int((idx < d).sum())
    for dtype in (np.float32, np.float64):
        lay = cs.build_panels(_t(idx), _t(val.astype(dtype)), d)
        pays = cs.panels_pay_off(n, d, nnz, np.dtype(dtype).itemsize)
        assert pays == (rule == "gathers_cost_more") == (lay is not None)
        assert pays == (-(-n // 1024) * d * np.dtype(dtype).itemsize < nnz * 32)
        if lay is not None:
            assert lay.tile_rows == cs.tile_rows_for(n) == 1024
            assert lay.panel_cols == cs.PANEL_BYTES // np.dtype(dtype).itemsize
            _check_panel_layout(lay, idx, val.astype(dtype), d)


@pytest.mark.parametrize("shape", ["small", "wide"])
@pytest.mark.parametrize("name", CASES)
def test_panel_kernel_order_matches_jax(name, shape):
    """The panel kernel's summation order against the Pallas kernel
    (interpret mode), the JAX plain path and the dense product in f32, and
    against the dense product in f64."""
    idx, val, d, w, _ = _case(name)
    rows_t, cols_p = _panel_sizes(shape, idx.shape[0])
    lay = cs.panel_layout(_t(idx), _t(val), d, rows_t, cols_p)
    if shape == "wide" and name == "long_col":
        chunk = cs.PANEL_THREADS * cs.PANEL_ITEMS
        assert lay.offsets.diff(dim=1).max() > chunk     # rows carried
    z = _emulate_panel_kernel(lay, _t(w)).numpy()
    assert z.dtype == np.float32 and z.shape == (idx.shape[0],)
    refs = _jax_refs(name)
    np.testing.assert_allclose(z, refs["pallas"][0], rtol=0, atol=ATOL_F32)
    np.testing.assert_allclose(z, refs["jax_plain"][0], rtol=0, atol=ATOL_F32)
    np.testing.assert_allclose(z, _dense(idx, val, d) @ w, rtol=0, atol=ATOL_F32)
    val64, w64 = val.astype(np.float64), w.astype(np.float64)
    lay64 = cs.panel_layout(_t(idx), _t(val64), d, *_panel_sizes(shape, idx.shape[0],
                                                                torch.float64))
    z64 = _emulate_panel_kernel(lay64, _t(w64)).numpy()
    assert z64.dtype == np.float64
    np.testing.assert_allclose(z64, _dense(idx, val64, d) @ w64, rtol=0, atol=ATOL_F64)


@pytest.mark.parametrize("name", CASES)
def test_panel_plain_matches_ell_plain(name):
    """The panel matvec's plain version (what its wrapper and
    ``SparseFeatures.matvec`` run for CPU tensors with a layout attached)
    against the plain ELL version: equal in f32, within 1e-12 in f64."""
    idx, val, d, w, _ = _case(name)
    for dtype in (np.float32, np.float64):
        v, ww = _t(val.astype(dtype)), _t(w.astype(dtype))
        lay = cs.panel_layout(_t(idx), v, d, cs.tile_rows_for(idx.shape[0]),
                              cs.panel_cols(v.dtype))
        ref = cs.ell_matvec_plain(_t(idx), v, ww, d).numpy()
        got = cs.ell_panel_matvec(lay, ww).numpy()
        attached = SparseFeatures(_t(idx), v, d, panels=lay)
        cs.reset_launch_counts()
        np.testing.assert_array_equal(attached.matvec(ww).numpy(), got)
        assert cs.launch_counts() == {name: 0 for name in cs.ALL_KERNELS}
        assert got.dtype == dtype
        if dtype == np.float32:
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL_F64)


def test_with_accelerator_paths_attaches_nothing_on_cpu():
    """On the CPU neither SparseFeatures nor LabeledBatch attaches a
    layout: the plain versions read the ELL arrays."""
    idx, val, d, _, _ = _case("1000x700x6")
    sf = SparseFeatures(_t(idx), _t(val), d)
    assert sf.with_accelerator_paths() is sf and sf.panels is None
    n = idx.shape[0]
    batch = LabeledBatch(sf, torch.zeros(n), torch.zeros(n), torch.ones(n))
    assert batch.with_accelerator_paths() is batch


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
    n = idx.shape[0]
    cs.reset_launch_counts()
    z = cs.ell_matvec(i, v, _t(w).to(cuda_device), d)
    lay = cs.panel_layout(i, v, d, cs.tile_rows_for(n), cs.panel_cols(v.dtype))
    zp = cs.ell_panel_matvec(lay, _t(w).to(cuda_device))
    csc = cs.build_csc(i, v, d)
    g1 = cs.csc_rmatvec(csc, _t(dz).to(cuda_device))
    g2 = cs.csc_rmatvec(csc, _t(dz).to(cuda_device))
    gs = cs.csc_rmatvec(csc, _t(dz).to(cuda_device), square=True)
    torch.cuda.synchronize()
    assert cs.launch_counts() == {**{name: 0 for name in cs.ALL_KERNELS},
                                  "ell_panel_matvec": 1, "ell_matvec": 1,
                                  "csc_rmatvec": 2, "csc_sq_rmatvec": 1}
    assert torch.equal(g1, g2)
    assert torch.equal(z, cs.ell_matvec(i, v, _t(w).to(cuda_device), d))
    refs = _jax_refs(name)["pallas"]
    for got, ref in ((z, refs[0]), (zp, refs[0]), (g1, refs[1]), (gs, refs[2])):
        np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=0, atol=ATOL_F32)
    for dtype in (np.float32, np.float64):
        val_t, dz_t, w_t = _t(val.astype(dtype)), _t(dz.astype(dtype)), _t(w.astype(dtype))
        host = cs.build_csc(_t(idx), val_t, d)
        dev = cs.build_csc(i, val_t.to(cuda_device), d)
        for square in (False, True):
            got = cs.csc_rmatvec(dev, dz_t.to(cuda_device), square=square)
            assert torch.equal(got.cpu(), _emulate_csc_kernel(host, dz_t, square))
        sizes = (cs.tile_rows_for(n), cs.panel_cols(val_t.dtype))
        host = cs.panel_layout(_t(idx), val_t, d, *sizes)
        dev = cs.panel_layout(i, val_t.to(cuda_device), d, *sizes)
        got = cs.ell_panel_matvec(dev, w_t.to(cuda_device))
        assert torch.equal(got, cs.ell_panel_matvec(dev, w_t.to(cuda_device)))
        assert torch.equal(got.cpu(), _emulate_panel_kernel(host, w_t))
        got = cs.ell_matvec(i, val_t.to(cuda_device), w_t.to(cuda_device), d)
        assert torch.equal(got.cpu(), _emulate_ell_kernel(_t(idx), val_t, w_t, d))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_panel_kernel_matches_emulation_on_card(dtype, cuda_device):
    """The panel kernel at its own tile and panel sizes (build_panels), on
    a layout of 3 tiles (the last one short) and 3 panels in f32 / 5 in f64
    (the last one's width not a multiple of 16 bytes), with a column in
    every row and duplicates: equal bit for bit to the emulation of its
    summation order, twice in a row, and within tolerance of the plain ELL
    version; the layout built on the card equals the host's."""
    rng = np.random.default_rng(13)
    n, d, k = 2500, 40001, 16
    idx, val = _random_ell(rng, n, d, k)
    idx[:, 0] = 7
    idx[:, 1] = idx[:, 2]
    val = np.where(idx < d, rng.normal(size=(n, k)), 0.0).astype(dtype)
    w = rng.normal(size=d).astype(dtype)
    host = cs.build_panels(_t(idx), _t(val), d)
    dev = cs.build_panels(_t(idx).to(cuda_device), _t(val).to(cuda_device), d)
    assert host is not None and dev is not None
    assert host.n_tiles == 3 and host.n_panels >= 3
    for a, b in ((host.codes, dev.codes), (host.vals, dev.vals),
                 (host.offsets, dev.offsets)):
        assert torch.equal(a, b.cpu())
    wd = _t(w).to(cuda_device)
    cs.reset_launch_counts()
    z1 = cs.ell_panel_matvec(dev, wd)
    z2 = cs.ell_panel_matvec(dev, wd)
    torch.cuda.synchronize()
    assert cs.launch_counts()["ell_panel_matvec"] == 2
    assert torch.equal(z1, z2)
    assert torch.equal(z1.cpu(), _emulate_panel_kernel(host, _t(w)))
    ref = cs.ell_matvec_plain(_t(idx), _t(val), _t(w), d).numpy()
    atol = ATOL_F32 if dtype == np.float32 else ATOL_F64
    np.testing.assert_allclose(z1.cpu().numpy(), ref, rtol=0, atol=atol)


def _ell_card_case(name):
    """(idx, val, d, w) for a card test of the row-tile kernel: the shape's
    rows against its tile (R = 240 at K = 17, 124 at K = 33)."""
    rng = np.random.default_rng(22)
    if name == "lanes":
        return _ell_case("lanes")
    n, k, d = {"rows_not_multiple": (3 * 240 + 7, 17, 5000),
               "rows_below_tile": (50, 33, 3000),
               "sliced_odd_k": (1000, 17, 4000),
               "row400": (40, 400, 2000), "row5000": (3, 5000, 9000)}[name]
    idx, val = _random_ell(rng, n, d, k)
    idx[::5, 0] = -3                        # out of range below, value kept
    idx[::7, 1] = d + 11                    # and above
    w = rng.normal(size=d).astype(np.float32)
    return idx, val, d, w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["rows_not_multiple", "rows_below_tile",
                                  "sliced_odd_k", "lanes", "row400", "row5000"])
def test_ell_kernel_matches_emulation_on_card(name, dtype, cuda_device):
    """The row-tile kernel equals the emulation of its summation order bit
    for bit, twice in a row: with N not a multiple of R, N < R, a row-sliced
    view at odd K (its base off 16-byte alignment, the short last tile
    with it), the block-diagonal lane layout, and rows of 400 and 5,000
    entries (the second in two stage-sized chunks); within tolerance of the
    plain version."""
    idx, val, d, w = _ell_card_case(name)
    val, w = val.astype(dtype), w.astype(dtype)
    i, v, wd = (_t(a).to(cuda_device) for a in (idx, val, w))
    if name == "sliced_odd_k":
        i, v, idx, val = i[5:-2], v[5:-2], idx[5:-2], val[5:-2]
        assert i.is_contiguous() and i.data_ptr() % 16 and v.data_ptr() % 16
    plan = cs.ell_tile_plan(idx.shape[1], v.dtype)
    if name == "rows_not_multiple":
        assert idx.shape[0] % plan.tile_rows
    elif name == "rows_below_tile":
        assert idx.shape[0] < plan.tile_rows
    elif name == "row5000":
        assert idx.shape[1] > plan.stage
    cs.reset_launch_counts()
    z1 = cs.ell_matvec(i, v, wd, d)
    z2 = cs.ell_matvec(i, v, wd, d)
    torch.cuda.synchronize()
    assert cs.launch_counts()["ell_matvec"] == 2
    assert torch.equal(z1, z2)
    assert torch.equal(z1.cpu(), _emulate_ell_kernel(_t(idx), _t(val), _t(w), d))
    ref = cs.ell_matvec_plain(_t(idx), _t(val), _t(w), d).numpy()
    atol = ATOL_F32 if dtype == np.float32 else ATOL_F64
    np.testing.assert_allclose(z1.cpu().numpy(), ref, rtol=0,
                               atol=atol * max(1.0, np.abs(ref).max()))
