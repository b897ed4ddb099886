"""The per-slot results of the pair passes to particle rows
(``tpgsd_torch.sph.ops.slot_rows`` and ``window_rows``, whose CPU twin
runs here): for the column layout of every body that takes them, the
rows equal bit for bit what the steps composed before the row kernel:
the tiers and columns concatenated with the sentinel row and gathered
through the sort's inverse permutation
(:func:`~tpgsd_torch.sph.cells.gather_from_cells`), the slab step's
window gather with its ``where`` and ``index_copy_`` and the final
inverse permutation, and a decomposed step's core planes gathered with
its sentinel.  The card holds the kernel to this twin
(``tests/test_torch_cuda.py``).
"""

import numpy
import pytest
import torch

from tpgsd_torch.sph import dam_break, ops
from tpgsd_torch.sph.cells import (
    CellGrid,
    build_cells,
    build_cells_spill,
    cell_id,
    gather_from_cells,
    sorted_runs,
)
from tpgsd_torch.sph.distributed import _block_core, _fill, _local_cells, _rows

RHO0 = 1000.0

#: the pair kernels' launch-count keys, which the benchmark compares with
#: each configuration's ``launches_per_step``: the row kernel adds none
PAIR_KEYS = {
    "%s_%s" % (family, role)
    for family in ("density", "accel", "accel_drho", "accel_xsph",
                   "accel_drho_xsph", "st_normals", "st_force", "energy")
    for role in ("self", "cross", "wide")
}


def _planes(f, e, k, gen, live=None, like_rho=False):
    """``f`` random per-slot planes ``[f, e, k]``; ``like_rho``: as the
    floored density and pressure are, ``rho0`` and 0 in dead slots."""
    a = torch.randn((f, e, k), generator=gen) * 50.0
    if like_rho:
        a[0] = torch.where(live, a[0] + RHO0, RHO0)
        a[1] = torch.where(live, a[1], 0.0)
    return a


def _global_case(spill, continuity, xsph, energy, capacity):
    """The cells of a jittered dam break, per-slot planes of the body's
    columns, the row function's tiers and fill, and the bundle composition's
    (its own column order) with its sentinel and the column permutation
    that maps the row function's order onto it."""
    db = dam_break(n_side=9, capacity=capacity, device="cpu")
    gen = torch.Generator().manual_seed(5 + capacity)
    x = db.state.x + 0.01 * torch.randn(db.state.x.shape, generator=gen)
    grid = db.grid
    c, k = grid.n_cells, grid.capacity
    if spill:
        cells, sp = build_cells_spill(x, grid, k)
        masks = [cells.mask[:c], sp.mask[:c]]
    else:
        cells = build_cells(x, grid)
        masks = [cells.mask[:c]]
    n_mom = (4 if continuity else 3) + 3 * xsph
    tiers, bundled = [], []
    for m in masks:
        mom = _planes(n_mom, c, k, gen).permute(1, 2, 0)  # [C, K, F] view
        if energy:  # energy_rate's single du column
            du = _planes(1, c, k, gen)[0]
            tiers.append([du])
            bundled.append(du[..., None])
            continue
        if continuity:
            tiers.append([mom])
            bundled.append(mom)
            continue
        rho, p = _planes(2, c, k, gen, m, like_rho=True)
        tiers.append([mom, rho, p])
        cols = [mom[..., :3], rho[..., None], p[..., None]]
        if xsph:
            cols.append(mom[..., 3:])
        bundled.append(torch.cat(cols, dim=-1))
    f = bundled[0].shape[-1]
    sent = torch.zeros(f)
    if energy or continuity:
        perm = list(range(f))
    else:
        sent[3] = RHO0
        # rows: acc3 | (xsph3) | rho | p; bundle: acc3 | rho | p | (xsph3)
        perm = [0, 1, 2, f - 2, f - 1] + list(range(3, f - 2))
    fill = tuple(float(v) for v in sent[torch.argsort(torch.tensor(perm))])
    return cells, grid, tiers, fill, bundled, sent, perm


GLOBAL = {
    "spill-summation": (True, False, 0, False, 24),
    "spill-summation-xsph": (True, False, 1, False, 24),
    "spill-continuity": (True, True, 0, False, 24),
    "spill-continuity-xsph": (True, True, 1, False, 24),
    "spill-summation-dropped": (True, False, 1, False, 8),
    "spill-continuity-dropped": (True, True, 0, False, 8),
    "single-summation": (False, False, 0, False, 24),
    "single-summation-xsph": (False, False, 1, False, 24),
    "single-continuity-xsph": (False, True, 1, False, 24),
    "single-summation-dropped": (False, False, 0, False, 8),
    "single-energy": (False, False, 0, True, 24),
}


def _global(name):
    spill, continuity, xsph, energy, capacity = GLOBAL[name]
    cells, grid, tiers, fill, bundled, sent, perm = _global_case(
        spill, continuity, xsph, energy, capacity)
    bundle = torch.cat(bundled, dim=1)
    want = gather_from_cells(
        torch.cat([bundle, sent.expand(1, bundle.shape[1], -1)]), cells,
        grid, capacity=bundle.shape[1])
    got = ops.slot_rows(tiers, fill, cells, grid.dims)
    dropped = cells.slot >= bundle.shape[1]
    if name.endswith("dropped"):
        assert bool(dropped.any())
    # dropped particles read the fill row: rho0 in summation (so p = 0),
    # drho = 0 in continuity (they keep their carried density)
    fill_t = torch.tensor(fill)
    assert torch.equal(got[cells.order[dropped]],
                       fill_t.expand(int(dropped.sum()), -1))
    return got[:, perm], want


def _bundle_window(cols, live, order, cid_pad, slot_pad, starts_ext,
                   c0e, core0, s, nxl, nynz, c_ext, kt, w_rows, out):
    """The bundle composition's window gather of one slab into the sorted
    ``out [n + 1, 6]`` (acc3 | rho | p | live), as the slab step composed
    it before the row kernel."""
    n = order.shape[0]
    bundle = torch.cat([torch.cat(t + [m[..., None].float()], dim=-1)
                        for t, m in zip(cols, live)], dim=1)
    p0 = starts_ext[c0e + core0]
    rows = torch.clamp(p0 + torch.arange(w_rows), max=n)
    cw = cid_pad[rows] - (s * nxl - 2) * nynz
    sw = slot_pad[rows]
    flat = torch.clamp(cw, 0, c_ext - 1) * kt + torch.clamp(sw, 0, kt - 1)
    win = bundle.reshape(-1, bundle.shape[-1])[flat]
    win = torch.where((sw < kt)[:, None], win, 0.0)
    out.index_copy_(0, rows, win)
    return win


def _as_read(rows, continuity):
    """The columns the bundle composition's slab integration read:
    acc3 | drho, or acc3 | rho | p with ``rho0`` and 0 where not live."""
    if continuity:
        return rows[:, :4]
    live = rows[:, 5] > 0.5
    return torch.cat([rows[:, :3],
                      torch.where(live, rows[:, 3], RHO0)[:, None],
                      torch.where(live, rows[:, 4], 0.0)[:, None]], dim=1)


def _slab(name):
    """Every slab of a slab step's windows, against the bundle window
    composition (and its window rows with ``emit``: the slab's own rows,
    which its frame takes, and the fill row past them).  ``dirty``: the
    tiers' live slots are the cells' occupied ones, as the slab step lays
    them out, and the density and pressure of dead slots hold arbitrary
    values, which the composition masked with ``where(live, ...)``."""
    continuity = "continuity" in name
    spill = "single" not in name
    emit = "emit" in name
    dirty = "dirty" in name
    window = 16 if "overflow" in name else None
    db = dam_break(n_side=9, capacity=8 if "dropped" in name else 24,
                   device="cpu")
    gen = torch.Generator().manual_seed(11)
    x = db.state.x + 0.01 * torch.randn(db.state.x.shape, generator=gen)
    grid = db.grid
    n = x.shape[0]
    nx, ny, nz = grid.dims
    n_slabs, nynz, k = 2, ny * nz, grid.capacity
    nxl = nx // n_slabs
    ext = (nxl + 4, ny, nz)
    c_ext = ext[0] * nynz
    core0 = 2 * nynz
    kt = 2 * k if spill else k
    w_rows = window or -(-3 * n // n_slabs)
    order, cid_s, slot, starts = sorted_runs(cell_id(x, grid), grid.n_cells)
    cid_pad = torch.cat([cid_s, cid_s.new_full((1,), grid.n_cells)])
    slot_pad = torch.cat([slot, slot.new_zeros(1)])
    pad = starts.new_zeros(2 * nynz)
    starts_ext = torch.cat([pad, starts,
                            starts.new_full((2 * nynz,), n)])
    counts_ext = torch.cat([pad, torch.diff(starts, append=starts.new_full(
        (1,), n)), pad])
    fill = (0.0,) * 4 if continuity else (0.0,) * 3 + (RHO0, 0.0)
    sorted_old = torch.zeros((n + 1, 6))
    got = torch.tensor(fill).expand(n, len(fill)).clone()
    overflowed = False
    for s in range(n_slabs):
        c0e = s * nxl * nynz
        if dirty:
            ct = counts_ext[c0e:c0e + c_ext, None]
            live = [torch.arange(t * k, (t + 1) * k)[None, :] < ct
                    for t in range(kt // k)]
        else:
            live = [torch.rand((c_ext, k), generator=gen) < 0.7
                    for _ in range(kt // k)]
        row_cols, bundle_cols = [], []
        for m in live:
            if continuity:
                mom = _planes(4, c_ext, k, gen).permute(1, 2, 0)
                row_cols.append([mom])
                bundle_cols.append([mom[..., :3], mom[..., 3:4],
                                 torch.zeros((c_ext, k, 1))])
            else:
                acc = _planes(3, c_ext, k, gen).permute(1, 2, 0)
                rho, p = _planes(2, c_ext, k, gen, m, like_rho=not dirty)
                row_cols.append([acc, rho, p])
                bundle_cols.append([acc, rho[..., None], p[..., None]])
        win_bundle = _bundle_window(bundle_cols, live, order, cid_pad,
                                 slot_pad, starts_ext, c0e, core0, s, nxl,
                                 nynz, c_ext, kt, w_rows, sorted_old)
        p0 = starts_ext[c0e + core0]
        p1 = starts_ext[c0e + core0 + nxl * nynz]
        win = ops.window_rows(row_cols, fill, got, order, cid_pad, slot_pad,
                              p0, p1, w_rows, grid.dims, ext,
                              (2 - s * nxl, 0, 0), emit=emit)
        rows_s = int(p1 - p0)
        overflowed |= rows_s > w_rows
        own = min(rows_s, w_rows)  # the rows the slab's frame takes
        if emit:
            assert torch.equal(win[:own],
                               _as_read(win_bundle, continuity)[:own])
            assert torch.equal(win[own:], torch.tensor(fill).expand(
                w_rows - own, len(fill)))
        else:
            assert win is None
    assert overflowed == (window is not None)
    want = torch.empty((n, 6))
    want.index_copy_(0, order, sorted_old[:n])
    return got, _as_read(want, continuity)


SLAB = ["slab-summation", "slab-continuity", "slab-summation-emit",
        "slab-continuity-emit", "slab-single-summation-emit",
        "slab-summation-dropped-emit", "slab-summation-overflow-emit",
        "slab-summation-dirty-emit", "slab-single-summation-dirty-dropped"]


def _decomposed(name):
    """A shard's core planes of its extended grid (one ghost plane each
    side of the slab form, a ghost layer on x and y of the 2-D block form)
    to particle rows, dead slots and dropped particles included, against
    the bundle composition: the core planes gathered with the sentinel
    row."""
    form = name.split("-")[1]
    continuity = "continuity" in name
    xsph, energy = "options" in name, "options" in name
    bdims = (3, 4, 5)
    n_dec = 1 if form == "slab" else 2
    edims = tuple(b + 2 if a < n_dec else b for a, b in enumerate(bdims))
    k, n_tiers, cap = 4, 2, 400
    c, c_ext = int(numpy.prod(bdims)), int(numpy.prod(edims))
    gen = torch.Generator().manual_seed(3)
    x = torch.rand((cap, 3), generator=gen) * torch.tensor(bdims).float()
    alive = torch.rand(cap, generator=gen) < 0.8
    cells = _local_cells(x, alive, *bdims, n_tiers * k,
                         torch.zeros(3), 1.0)
    assert int(cells.overflow) > 0 and bool((~alive).any())
    fill = _fill(type("P", (), {"rho0": RHO0}), continuity, 0.5 * xsph,
                 energy)
    mom, rho_p, du, bundled = [], [], [], []
    for t in range(n_tiers):
        m = _planes((4 if continuity else 3) + 3 * xsph, c_ext, k, gen)
        mom.append(m.permute(1, 2, 0))
        cols = [mom[-1]]
        if not continuity:
            rho_p.append(tuple(_planes(2, c_ext, k, gen)))
            cols += [rho_p[-1][0][..., None], rho_p[-1][1][..., None]]
        if energy:
            du.append(_planes(1, c_ext, k, gen)[0])
            cols.append(du[-1][..., None])
        bundled.append(torch.cat(cols, dim=-1))
    ext_grid = CellGrid(lo=(0.0,) * 3, cell_size=1.0, dims=edims, capacity=k)
    local_grid = ext_grid._replace(dims=bdims)
    got = _rows(mom, None if continuity else rho_p, du if energy else None,
                cells, fill, local_grid, ext_grid)
    core = _block_core(torch.cat(bundled, dim=1), edims,
                       tuple(range(n_dec)), 0)
    sent = torch.tensor(fill).expand(1, n_tiers * k, len(fill))
    want = gather_from_cells(torch.cat([core, sent]), cells, local_grid,
                             capacity=n_tiers * k)
    return got, want


DECOMPOSED = ["decomposed-slab-summation", "decomposed-slab-continuity",
              "decomposed-slab-summation-options",
              "decomposed-2d-summation-options",
              "decomposed-2d-continuity-options"]


@pytest.mark.parametrize("case", list(GLOBAL) + SLAB + DECOMPOSED)
def test_rows_equal_the_composition_they_replace(case):
    """The twin's rows of each body's columns equal, bit for bit, those
    of the cat + sentinel + gather the step composed before."""
    if case in GLOBAL:
        got, want = _global(case)
    elif case in SLAB:
        got, want = _slab(case)
    else:
        got, want = _decomposed(case)
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_the_row_kernel_keeps_out_of_the_pair_launch_counts():
    """``ops.launch_counts`` keeps the pair kernels' keys; the row
    kernel's launches have a dict of their own, reset with them, and the
    CPU twin launches nothing."""
    assert set(ops.launch_counts) == PAIR_KEYS
    assert set(ops.row_launch_counts) == {"slot_rows"}
    ops.row_launch_counts["slot_rows"] = 3
    ops.reset_launch_counts()
    assert ops.row_launch_counts == {"slot_rows": 0}
    cells, grid, tiers, fill, *_ = _global_case(True, False, 0, False, 24)
    ops.slot_rows(tiers, fill, cells, grid.dims)
    assert ops.row_launch_counts == {"slot_rows": 0}
    assert not any(ops.launch_counts.values())


def test_column_sources_must_be_planes():
    """The kernel reads each column as an ``[E, K]`` plane: a contiguous
    plane and a ``[E, K, m]`` view of ``[m, E, K]`` SoA planes pass; any
    other layout raises, so no hidden copy runs beside the kernel."""
    e, k = 6, 4
    soa = torch.zeros((3, e, k))
    ptrs = ops._plane_pointers([soa.permute(1, 2, 0), soa[0]], e, k,
                               soa.device)
    step = soa.stride(0) * 4
    assert ptrs == [soa.data_ptr() + j * step for j in range(3)] + [
        soa.data_ptr()]
    for bad in (torch.zeros((e, k, 3)), soa[0].t().contiguous().t(),
                torch.zeros((e, k), dtype=torch.float64)):
        with pytest.raises(ValueError, match="planes"):
            ops._plane_pointers([bad], e, k, soa.device)
