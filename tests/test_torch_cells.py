"""Cell build and dam-break builder of the torch port against the JAX
package: every map must be EXACTLY equal (same stable sort, same run
starts), on live slots where the reference leaves dead slots unspecified."""

import numpy
import pytest
import torch

import jax.numpy as jnp

from tpgsd.sph import cells as ref
from tpgsd.sph import dam_break as ref_dam_break
from tpgsd_torch.sph import cells as port
from tpgsd_torch.sph import dam_break as port_dam_break
from tpgsd_torch.sph.convert import grid_from_reference, params_from_reference


def _dense_cloud():
    """Random cloud with a densified corner so cells exceed K=24 (the
    cloud of tests/test_spill.py)."""
    rng = numpy.random.default_rng(7)
    x = rng.uniform(0.05, 0.95, (2000, 3)).astype(numpy.float32)
    x[:500] = 0.05 + 0.22 * rng.uniform(0, 1, (500, 3)).astype(numpy.float32)
    return x


@pytest.fixture(scope="module", params=["cloud", "dam_break"])
def case(request):
    """``(x numpy [N, 3], reference grid)`` with an occupied spill tier."""
    if request.param == "cloud":
        return _dense_cloud(), ref.make_grid((0, 0, 0), (1, 1, 1), 0.12, 24)
    db = ref_dam_break(n_side=10, capacity=24)
    return numpy.asarray(db.state.x), db.grid


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else numpy.asarray(a)


def _assert_celllist_equal(got, want):
    for name in ("order", "cid", "slot", "gidx", "mask", "starts"):
        numpy.testing.assert_array_equal(
            _np(getattr(got, name)), _np(getattr(want, name)), err_msg=name
        )
    assert int(got.overflow) == int(want.overflow)


def test_build_cells_matches_reference(case):
    x, grid = case
    got = port.build_cells(torch.from_numpy(x), grid_from_reference(grid))
    _assert_celllist_equal(got, ref.build_cells(jnp.asarray(x), grid))


def test_build_cells_spill_matches_reference(case):
    x, grid = case
    k = grid.capacity
    got, got_sp = port.build_cells_spill(
        torch.from_numpy(x), grid_from_reference(grid), k
    )
    want, want_sp = ref.build_cells_spill(jnp.asarray(x), grid, k)
    _assert_celllist_equal(got, want)
    numpy.testing.assert_array_equal(_np(got_sp.gidx), _np(want_sp.gidx))
    numpy.testing.assert_array_equal(_np(got_sp.mask), _np(want_sp.mask))
    assert bool(want_sp.mask.any()), "the spill tier must be occupied"


def _values(n, f=6):
    return numpy.random.default_rng(1).normal(size=(n, f)).astype(numpy.float32)


@pytest.mark.parametrize("tier", ["main", "spill"])
def test_scatter_to_cells_matches_reference(case, tier):
    x, grid = case
    vals = _values(x.shape[0])
    cells_r, sp_r = ref.build_cells_spill(jnp.asarray(x), grid, grid.capacity)
    cells_p, sp_p = port.build_cells_spill(
        torch.from_numpy(x), grid_from_reference(grid), grid.capacity
    )
    gidx_r = sp_r.gidx if tier == "spill" else None
    gidx_p = sp_p.gidx if tier == "spill" else None
    want = ref.scatter_to_cells(jnp.asarray(vals), cells_r, grid, gidx=gidx_r)
    got = port.scatter_to_cells(
        torch.from_numpy(vals), cells_p, grid_from_reference(grid), gidx=gidx_p
    )
    numpy.testing.assert_array_equal(got.numpy(), numpy.asarray(want))


@pytest.mark.parametrize("tier", ["main", "spill"])
def test_scatter_to_cells_soa_matches_reference_on_live_slots(case, tier):
    x, grid = case
    k = grid.capacity
    vals = _values(x.shape[0])
    cells_r, sp_r = ref.build_cells_spill(jnp.asarray(x), grid, k)
    cells_p, _ = port.build_cells_spill(
        torch.from_numpy(x), grid_from_reference(grid), k
    )
    kw = {"slot_base": k, "capacity": k} if tier == "spill" else {}
    want = ref.scatter_to_cells_soa(jnp.asarray(vals), cells_r, grid, **kw)
    got = port.scatter_to_cells_soa(
        torch.from_numpy(vals), cells_p, grid_from_reference(grid), **kw
    )
    assert got.shape == (6, grid.n_cells, k) and got.is_contiguous()
    live = numpy.asarray((sp_r if tier == "spill" else cells_r).mask)[
        : grid.n_cells
    ]
    assert live.any()
    numpy.testing.assert_array_equal(
        got.numpy()[:, live], numpy.asarray(want)[:, live]
    )
    # the port zeroes dead slots
    assert not got.numpy()[:, ~live].any()


def test_gather_from_cells_matches_reference(case):
    x, grid = case
    k = grid.capacity
    cells_r, _ = ref.build_cells_spill(jnp.asarray(x), grid, k)
    cells_p, _ = port.build_cells_spill(
        torch.from_numpy(x), grid_from_reference(grid), k
    )
    dense = numpy.random.default_rng(2).normal(
        size=(grid.n_cells + 1, 2 * k, 5)
    ).astype(numpy.float32)
    want = ref.gather_from_cells(jnp.asarray(dense), cells_r, grid, capacity=2 * k)
    got = port.gather_from_cells(
        torch.from_numpy(dense), cells_p, grid_from_reference(grid),
        capacity=2 * k,
    )
    numpy.testing.assert_array_equal(got.numpy(), numpy.asarray(want))


def _scan_slot(cid_s):
    """The reference's slot map, written out: each sorted position less
    a ``cummax`` of the run starts."""
    iota = torch.arange(cid_s.shape[0], dtype=torch.int64)
    boundary = torch.ones_like(cid_s, dtype=torch.bool)
    boundary[1:] = cid_s[1:] != cid_s[:-1]
    return iota - torch.cummax(torch.where(boundary, iota, 0), dim=0).values


def _run_ids(kind):
    """``(cid, n_query, live_rows)`` of one pattern of cell ids."""
    g = torch.Generator().manual_seed(11)
    if kind == "random":  # cells 40-59 and the draw's gaps stay empty
        return torch.randint(0, 40, (500,), generator=g), 60, None
    if kind == "one_cell":
        return torch.full((300,), 3, dtype=torch.int64), 7, None
    if kind == "own_cell":
        return torch.randperm(64, generator=g), 64, None
    if kind == "single":
        return torch.tensor([2]), 5, None
    # a shard's slab: dead slots in the sentinel cell c = n_query - 1
    c = 30
    cid = torch.randint(0, c, (400,), generator=g)
    dead = torch.rand(400, generator=g) < 0.3
    return torch.where(dead, c, cid), c + 1, c


@pytest.mark.parametrize(
    "kind", ["random", "one_cell", "own_cell", "single", "sentinel"]
)
def test_sorted_runs_slot_equals_the_scan(kind):
    """``sorted_runs`` gathers each slot from its cell's start; the map
    is the reference's scan, bit for bit, and ``_sorted_slot_map`` hands
    it on unchanged."""
    cid, n_query, live_rows = _run_ids(kind)
    order, cid_s, slot, starts = port.sorted_runs(cid, n_query)
    numpy.testing.assert_array_equal(
        order.numpy(), numpy.argsort(cid.numpy(), kind="stable")
    )
    assert torch.equal(cid_s, cid[order])
    assert torch.equal(slot, _scan_slot(cid_s))
    want_starts = torch.tensor(
        [int((cid_s < q).sum()) for q in range(n_query)], dtype=torch.int64
    )
    assert torch.equal(starts, want_starts)
    assert all(t.dtype == torch.int64 for t in (order, cid_s, slot, starts))
    *_, slot_map, starts_map = port._sorted_slot_map(
        cid, n_query, 8, live_rows=live_rows
    )
    assert torch.equal(slot_map, slot) and torch.equal(starts_map, starts)


@pytest.mark.parametrize(
    "periodic", [False, True, (True, False, True), (False, False, True)],
    ids=["closed", "periodic", "wrap_xz", "wrap_z"],
)
def test_neighbor_table_matches_reference(case, periodic):
    """Equal tables, closed and wrapped (all axes with at least 3 cells,
    or the axes a 3-tuple selects)."""
    _, grid = case
    got = port.neighbor_table(grid_from_reference(grid), periodic=periodic)
    numpy.testing.assert_array_equal(
        got, ref.neighbor_table(grid, periodic=periodic)
    )
    assert got.dtype == numpy.int32
    # a wrapped table has no sentinel on its wrapped axes
    assert (got == grid.n_cells).any() == (periodic is not True)


def test_neighbor_table_leaves_axes_under_three_cells_closed():
    grid = ref.make_grid((0, 0, 0), (1.0, 1.0, 0.2), 0.1, 8)
    assert grid.dims[2] == 2
    got = port.neighbor_table(grid_from_reference(grid), periodic=True)
    numpy.testing.assert_array_equal(
        got, ref.neighbor_table(grid, periodic=True)
    )
    numpy.testing.assert_array_equal(
        got, port.neighbor_table(grid_from_reference(grid), (True, True, False))
    )
    assert (got == grid.n_cells).any()


@pytest.mark.parametrize(
    "capacity, headroom", [(64, 1.5), ("auto", 1.15), ("auto", 1.5)]
)
def test_dam_break_matches_reference(capacity, headroom):
    want = ref_dam_break(
        n_side=10, capacity=capacity, capacity_headroom=headroom
    )
    got = port_dam_break(
        n_side=10, capacity=capacity, capacity_headroom=headroom, device="cpu"
    )
    numpy.testing.assert_array_equal(got.state.x.numpy(), numpy.asarray(want.state.x))
    numpy.testing.assert_array_equal(got.state.v.numpy(), numpy.asarray(want.state.v))
    assert got.state.x.dtype == torch.float32
    assert got.grid == grid_from_reference(want.grid)
    assert tuple(got.grid) == tuple(want.grid)
    assert got.params == params_from_reference(want.params)
    assert tuple(got.params) == tuple(want.params)
    assert got.n == want.n and got.box == want.box
