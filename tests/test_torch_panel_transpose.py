"""The transpose over row panels (``csc_panel_rmatvec``) against the JAX
package, on the CPU.

``photon_tpu_torch.ops.cuda_sparse.row_panel_layout`` sorts an ELL
matrix's entries by (column tile, row panel) and cuts the segments into the
kernel's blocks and bands; ``csc_panel_rmatvec_plain`` is the kernel's
function on that layout in plain torch (the wrappers run it for CPU
tensors). Here it is held against the JAX Pallas kernel in interpret mode
(``rmatvec_pallas``, plain and ``square_vals``), as
``tests/test_pallas_sparse.py`` runs it, on the grid of
``tests/test_torch_sparse.py`` and on edge layouts of the new layout: an
empty column, a column in every row of three row panels, ghost entries and
rows, a width that is no multiple of the tile, a tile cut between blocks.
Values come as float32 and as bfloat16 (JAX is given the same values
rounded to bfloat16, as float32). Tolerance: ``atol 5e-5`` (the Pallas
tests' own), with every long column's values scaled by 1/sqrt(rows) so its
sum stays O(1) within reach of the Pallas kernel's float32 sums.

Also: the layout's invariants (16-byte-aligned segments, the sort order,
the entries kept exactly, the bands covering every segment once, equal
bits on repeat), the route rule on the layouts of ``PERF.md``'s kernel
table, the bfloat16 plain form bit-equal to the float32 one on the upcast
values, and ``SparseFeatures``' transposes through an attached row-panel
layout. The kernels run only on the card (``tests/test_torch_bf16.py``,
tests marked ``cuda``).
"""
import functools

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu.ops.pallas_sparse import build_pallas_aux, rmatvec_pallas
from photon_tpu_torch.data.batch import SparseFeatures
from photon_tpu_torch.ops import cuda_sparse as cs
from test_torch_sparse import _case, _random_ell, _t

ATOL_F32 = 5e-5
GRID = ["300x200x4", "1000x700x6", "hot_dup", "long_col", "empty_runs", "nnz0"]
EDGES = ["empty_col", "hot_col_panels", "ghosts", "dim_ragged", "band_split"]
CASES = GRID + EDGES


@functools.lru_cache(maxsize=None)
def _edge(name):
    """(idx, val, d, dz) for one edge layout of the row-panel transpose."""
    rng = np.random.default_rng(EDGES.index(name) + 40)
    if name == "empty_col":
        # columns 250..499 empty, and column 3 too
        n, d, k = 3000, 500, 3
        idx, val = _random_ell(rng, n, 250, k)
        idx = np.where(idx == 3, 4, idx)
        idx = np.where(idx == 250, d, idx).astype(np.int32)
        val = np.where(idx < d, val, 0.0).astype(np.float32)
    elif name == "hot_col_panels":
        # column 7 in every row of 40,000: three row panels
        n, d, k = 40000, 3000, 2
        idx, val = _random_ell(rng, n, d, k, ghost_frac=0.0)
        idx[:, 0] = 7
        val[:, 0] = rng.normal(size=n) / np.sqrt(n)
    elif name == "ghosts":
        # 30% ghost entries and every tenth row all ghosts
        n, d, k = 5000, 900, 4
        idx, val = _random_ell(rng, n, d, k, ghost_frac=0.3)
        idx[::10] = d
        val = np.where(idx < d, val, 0.0).astype(np.float32)
    elif name == "dim_ragged":
        # three tiles, the last 5 columns wide, over two panels
        n, d, k = 20000, 2 * cs.MAX_TILE_COLS + 5, 3
        idx, val = _random_ell(rng, n, d, k)
        idx[:, 0] = d - 1 - (np.arange(n) % 5)
    elif name == "band_split":
        # one tile's entries worth several blocks: cut between them
        n, d, k = 50000, 600, 3
        idx, val = _random_ell(rng, n, d, k, ghost_frac=0.05)
        idx[:, 1] = 11
        val[:, 1] = rng.normal(size=n) / np.sqrt(n)
    dz = rng.normal(size=n).astype(np.float32)
    return idx, val, d, dz


def _inputs(name):
    if name in GRID:
        idx, val, d, _, dz = _case(name)
        return idx, val, d, dz
    return _edge(name)


def _rounded(val):
    return val.astype(ml_dtypes.bfloat16).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax(name, bf16, square):
    idx, val, d, dz = _inputs(name)
    aux = build_pallas_aux(idx, _rounded(val) if bf16 else val, d)
    return np.asarray(rmatvec_pallas(aux, jnp.asarray(dz), square_vals=square,
                                     interpret=True))


def _layout(name, dtype):
    idx, val, d, _ = _inputs(name)
    return cs.row_panel_layout(_t(idx), _t(val).to(dtype), d)


@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", CASES)
def test_panel_plain_matches_jax_pallas(name, dtype, square):
    _, _, d, dz = _inputs(name)
    lay = _layout(name, getattr(torch, dtype))
    g = cs.csc_panel_rmatvec(lay, _t(dz), square=square)
    assert g.dtype == torch.float32 and g.shape == (d,)
    np.testing.assert_allclose(g.numpy(), _jax(name, dtype == "bfloat16", square),
                               rtol=0, atol=ATOL_F32)


@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_bf16_plain_is_f32_plain_on_upcast_values(name, square):
    idx, val, d, dz = _inputs(name)
    vb = _t(val).to(torch.bfloat16)
    lb = cs.row_panel_layout(_t(idx), vb, d)
    lf = cs.row_panel_layout(_t(idx), vb.float(), d)
    assert torch.equal(lb.codes, lf.codes) and torch.equal(lb.bands, lf.bands)
    got = cs.csc_panel_rmatvec_plain(lb, _t(dz), square)
    assert torch.equal(got, cs.csc_panel_rmatvec_plain(lf, _t(dz), square))
    # and the merge path's plain version, the same float64 sum rounded once
    ref = cs.ell_rmatvec_plain(_t(idx), vb, _t(dz), d, square)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)


def _decoded(lay):
    """Each stored real entry's (segment, column, row, value)."""
    lengths = lay.offsets.diff(dim=1).reshape(-1)
    seg = torch.repeat_interleave(torch.arange(lengths.numel()), lengths)
    code = lay.codes.long() & 0xFFFFFFFF
    col, row = code >> cs.CODE_SHIFT, code & 0xFFFF
    real = col != cs.PAD_COL
    n_panels = lay.n_panels
    return (seg[real], (seg[real] // n_panels) * lay.tile_cols + col[real],
            (seg[real] % n_panels) * lay.panel_rows + row[real], lay.vals[real])


@pytest.mark.parametrize("name", CASES)
def test_row_panel_layout_invariants(name):
    idx, val, d, _ = _inputs(name)
    lay = _layout(name, torch.float32)
    again = _layout(name, torch.float32)
    for a, b in ((lay.codes, again.codes), (lay.vals, again.vals),
                 (lay.offsets, again.offsets), (lay.bands, again.bands),
                 (lay.starts, again.starts), (lay.fixups, again.fixups)):
        assert torch.equal(a, b)                       # bit-equal on repeat
    off = lay.offsets
    assert lay.n_tiles == -(-d // lay.tile_cols)
    assert lay.n_panels == -(-idx.shape[0] // cs.PANEL_ROWS)
    assert lay.tile_cols == min(cs.MAX_TILE_COLS, max(d, 1))
    assert bool((off % cs.SEGMENT_ALIGN == 0).all())   # 16 bytes of codes
    assert bool((off.diff(dim=1) >= 0).all())
    assert torch.equal(off[1:, 0], off[:-1, -1]) and int(off[-1, -1]) == lay.codes.numel()
    seg, col, row, v = _decoded(lay)
    # exactly the ELL's real entries, each once
    n, k = idx.shape
    keep = (idx >= 0) & (idx < d)
    want = sorted(zip(np.repeat(np.arange(n), k)[keep.ravel()].tolist(),
                      idx[keep].tolist(), val[keep].tolist()))
    got = sorted(zip(row.tolist(), col.tolist(), v.tolist()))
    assert got == want
    # each entry in its (tile, panel) segment, by (column, row),
    # duplicates in their ELL order
    assert torch.equal(seg, (col // lay.tile_cols) * lay.n_panels + row // lay.panel_rows)
    key = (seg * lay.tile_cols + col % lay.tile_cols) * lay.panel_rows + row % lay.panel_rows
    assert bool((key.diff() >= 0).all())
    dup = (key.diff() == 0).nonzero().reshape(-1)
    flat = {}
    for r in range(n):
        for j in range(k):
            if keep[r, j]:
                flat.setdefault((r, int(idx[r, j])), []).append(float(val[r, j]))
    for i in dup.tolist():
        vals = flat[(int(row[i]), int(col[i]))]
        assert vals.index(float(v[i])) <= vals.index(float(v[i + 1]))
    # the bands: every segment once, in (tile, panel) order; the blocks'
    # runs consecutive; split tiles' slots consecutive
    bands = lay.bands.tolist()
    walk = [(t, p) for t, lo, hi, _ in bands for p in range(lo, hi)]
    assert walk == [(t, p) for t in range(lay.n_tiles) for p in range(lay.n_panels)]
    starts = lay.starts.tolist()
    assert starts[0] == 0 and starts[-1] == len(bands) and starts == sorted(starts)
    assert max(hi - lo for _, lo, hi, _ in bands) == lay.max_band_panels
    per_tile = {}
    for t, _, _, slot in bands:
        per_tile.setdefault(t, []).append(slot)
    split = {t: s for t, s in per_tile.items() if len(s) > 1}
    assert all(s == [-1] for t, s in per_tile.items() if t not in split)
    assert sorted(x for s in split.values() for x in s) == list(range(lay.n_slots))
    assert lay.fixups.tolist() == [[t, s[0], len(s)] for t, s in sorted(split.items())]
    assert all(s == list(range(s[0], s[0] + len(s))) for s in split.values())


def test_edge_layouts_reach_their_edges():
    """The edge layouts are what they are named for: three panels under one
    column; a ragged last tile; a tile cut between blocks; empty columns."""
    hot = _layout("hot_col_panels", torch.float32)
    assert hot.n_panels == 3 and hot.n_tiles == 1
    ragged = _layout("dim_ragged", torch.float32)
    assert ragged.n_tiles == 3 and ragged.dim - 2 * ragged.tile_cols == 5
    split = _layout("band_split", torch.float32)
    assert split.fixups.shape[0] >= 1 and split.starts.numel() - 1 >= 2
    idx, _, d, dz = _edge("empty_col")
    g = cs.csc_panel_rmatvec(_layout("empty_col", torch.float32), _t(dz))
    assert bool((g[250:] == 0).all()) and float(g[3]) == 0.0


# The layouts of PERF.md §6's kernel table and the GLM driver's
# (rows, columns, non-ghost entries; chip_smoke.py's phase bf16_kernels):
# where the bf16 transposes take the row panels.
TABLE_LAYOUTS = {
    "scoring 2^19 x 32": ((1 << 19), 327680, (1 << 19) * 32, True),
    "GLM in-core 2^19 x 33": ((1 << 19), 327681, (1 << 19) * 33, True),
    "out-of-core chunk 65,536 x 33": (65536, 327681, 65536 * 33, False),
    "fit C's lanes 1.6M x 17": (1_600_000, 25_600_000, 25_838_759, False),
    "drivers' 32,768 x 33": (32768, 327681, 32768 * 33, False),
}


@pytest.mark.parametrize("layout", sorted(TABLE_LAYOUTS))
def test_route_rule_on_the_table_layouts(layout):
    n, d, nnz, panel = TABLE_LAYOUTS[layout]
    assert cs.transpose_panels_pay_off(n, d, nnz) is panel


def test_route_takes_row_panels_for_bf16_only():
    """``transpose_route`` / ``build_transpose``: float32 and float64 values
    keep the merge path; bfloat16 values take the rule's route, counted on
    the layout's own non-empty segments, and ``build_transpose`` builds
    the layout of that route: the merge path's at 70,000 x 4 (too few
    entries to fill the card), row panels at 140,000 x 40 over 256
    columns."""
    rng = np.random.default_rng(3)
    for (n, d, k), route in (((70000, 9000, 4), "merge"), ((140000, 256, 40), "panel")):
        idx, val = _random_ell(rng, n, d, k)
        i, v = _t(idx), _t(val)
        assert cs.transpose_route(i, v, d) == "merge"
        assert cs.transpose_route(i, v.double(), d) == "merge"
        assert isinstance(cs.build_transpose(i, v, d), cs.CscLayout)
        nnz = int(((i >= 0) & (i < d)).sum())
        assert cs.transpose_panels_pay_off(n, d, nnz) is (route == "panel")
        vb = v.to(torch.bfloat16)
        assert cs.transpose_route(i[:0], vb[:0], d) == "merge"
        assert cs.transpose_route(i, vb, d) == route
        want = cs.RowPanelLayout if route == "panel" else cs.CscLayout
        assert isinstance(cs.build_transpose(i, vb, d), want)


@pytest.mark.parametrize("name", ["1000x700x6", "hot_col_panels"])
def test_sparse_features_transposes_through_row_panels(name):
    """An attached row-panel layout carries ``rmatvec`` and ``sq_rmatvec``
    (the plain panel version on the CPU, no launch counted), equal to the
    ELL plain transposes within f64 rounding once, bf16 values included."""
    idx, val, d, dz = _inputs(name)
    for dt in (torch.float32, torch.bfloat16):
        vals = _t(val).to(dt)
        sf = SparseFeatures(_t(idx), vals, d,
                            row_panels=cs.row_panel_layout(_t(idx), vals, d))
        assert sf.with_layouts() is sf
        cs.reset_launch_counts()
        got = (sf.rmatvec(_t(dz)), sf.sq_rmatvec(_t(dz)))
        assert cs.launch_counts() == {k: 0 for k in cs.ALL_KERNELS}
        for g, sq in zip(got, (False, True)):
            assert torch.equal(g, cs.csc_panel_rmatvec_plain(sf.row_panels, _t(dz), sq))
            ref = cs.ell_rmatvec_plain(_t(idx), vals, _t(dz), d, sq)
            np.testing.assert_allclose(g.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)


def test_panel_wrapper_checks():
    idx, val, d, dz = _inputs("300x200x4")
    lay = _layout("300x200x4", torch.float32)
    with pytest.raises(ValueError, match="v must be"):
        cs.csc_panel_rmatvec(lay, _t(dz)[:-1])
    with pytest.raises(TypeError):
        cs.csc_panel_rmatvec(lay, _t(dz).double())
    # no rows, and no columns: the layout builds, the transpose is zeros
    empty = cs.row_panel_layout(_t(idx[:0]), _t(val[:0]), d)
    assert torch.equal(cs.csc_panel_rmatvec(empty, torch.zeros(0)), torch.zeros(d))
    ghost = np.full_like(idx, 0)
    none = cs.row_panel_layout(_t(ghost), _t(val), 0)
    assert cs.csc_panel_rmatvec(none, _t(dz)).shape == (0,)
    # float64 values: the plain version runs on the CPU (the kernel takes
    # float32 and bfloat16 values only)
    l64 = cs.row_panel_layout(_t(idx), _t(val).double(), d)
    g = cs.csc_panel_rmatvec(l64, _t(dz).double())
    assert g.dtype == torch.float64


@pytest.mark.parametrize("fault", ["dropped", "misplaced_column", "misplaced_row"])
def test_chip_smoke_bound_catches_a_wrong_row_panel_layout(monkeypatch, fault):
    """``chip_smoke.check_bounded`` holds the transposes over row panels
    against the plain transpose of the ELL arrays as well as against their
    own plain version: a layout that drops an entry or puts it in the wrong
    column or row fails there, though kernel and plain version, reading the
    same layout, agree. The right layout passes."""
    import dataclasses
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    rng = np.random.default_rng(41)
    n, d = 3000, 50
    idx, val = _random_ell(rng, n, d, 4)
    cpu = torch.device("cpu")
    out = chip_smoke.check_bounded(torch, cs, cpu, idx, val, d, seed=42)
    for kernel in cs.PANEL_TRANSPOSES:
        assert out["float32"][kernel]["ell_plain"]["of_bound"] <= 1.0
    right = cs.row_panel_layout

    def wrong(i, v, dim):
        lay = right(i, v, dim)
        col, row, real = cs._decode(lay.codes, lay.offsets, lay.tile_cols, lay.panel_rows)
        e = int(torch.nonzero(real & (lay.vals.double().abs() > 1.0))[0])
        codes, vals = lay.codes.clone(), lay.vals.clone()
        c, r = int(col[e]) % lay.tile_cols, int(row[e]) % lay.panel_rows
        if fault == "dropped":
            vals[e] = 0
        elif fault == "misplaced_column":
            codes[e] = ((c + 1) % dim) << cs.CODE_SHIFT | r
        else:
            codes[e] = c << cs.CODE_SHIFT | (r + 1) % n
        return dataclasses.replace(lay, codes=codes, vals=vals)

    monkeypatch.setattr(cs, "row_panel_layout", wrong)
    with pytest.raises(AssertionError, match="csc_panel_rmatvec disagrees with the ELL"):
        chip_smoke.check_bounded(torch, cs, cpu, idx, val, d, seed=42)
