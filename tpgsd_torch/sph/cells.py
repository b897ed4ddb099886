"""Fixed-capacity cell list for neighbor search (torch counterpart of
``tpgsd.sph.cells``).

The cell list is a dense ``[n_cells + 1, capacity]`` slot array built
with one stable sort: slot ``(c, j)`` holds the ``j``-th particle of
cell ``c`` in sorted order.  Slot overflow drops particles from
*neighbor interactions only* (they keep integrating ballistically) and
is counted in the returned ``overflow`` tensor, which stays on the
device.  Row ``n_cells`` is the sentinel that dropped particles read.

Linear cell index is x-major (``c = ix*ny*nz + iy*nz + iz``).  Every
map here equals the reference slot for slot (same stable sort, same
run starts); indices are int64, the torch index type.
"""

import functools
from typing import NamedTuple

import numpy as np
import torch


class CellGrid(NamedTuple):
    """Static cell-grid geometry."""

    lo: tuple  # domain lower corner (3,)
    cell_size: float  # == interaction support radius (2h)
    dims: tuple  # (nx, ny, nz)
    capacity: int  # max particles per cell

    @property
    def n_cells(self):
        nx, ny, nz = self.dims
        return nx * ny * nz


def make_grid(lo, hi, support, capacity):
    """Build a CellGrid covering [lo, hi] with cells >= ``support`` wide."""
    lo = tuple(float(v) for v in lo)
    hi = tuple(float(v) for v in hi)
    dims = tuple(max(1, int(np.floor((h - l) / support))) for l, h in zip(lo, hi))
    # stretch cells slightly so the grid tiles the domain exactly
    cell_size = max((h - l) / d for l, h, d in zip(lo, hi, dims))
    return CellGrid(lo=lo, cell_size=float(cell_size), dims=dims, capacity=int(capacity))


def auto_capacity(x, lo, hi, support, headroom=1.5):
    """Smallest multiple of 8 >= ``headroom`` x the densest cell of the
    host positions ``x`` (numpy, ``[N, 3]``).  Pair work scales with
    ``capacity^2`` per cell, so the capacity follows the occupancy."""
    x = np.asarray(x)
    lo_a = np.asarray(lo, np.float64)
    dims = tuple(
        max(1, int(np.floor((h - l) / support))) for l, h in zip(lo, hi)
    )
    cell = max((h - l) / d for l, h, d in zip(lo, hi, dims))
    idx = np.clip(
        np.floor((x - lo_a) / cell).astype(np.int64), 0, np.asarray(dims) - 1
    )
    cid = (idx[:, 0] * dims[1] + idx[:, 1]) * dims[2] + idx[:, 2]
    m0 = int(np.bincount(cid, minlength=1).max())
    return max(8, int(-(-headroom * m0 // 8) * 8))


def wrap_axes(grid, periodic):
    """``(3,)`` bool array of the axes that wrap: those ``periodic``
    selects (``True`` = all, or a 3-tuple of bools) that have at least 3
    cells.  The one wrap rule of every pair path."""
    dims = np.asarray(grid.dims)
    if periodic is True:
        return dims >= 3
    return np.asarray(periodic, bool) & (dims >= 3)


def neighbor_table(grid, periodic=False):
    """Host ``[n_cells, 27]`` int32 table of neighbor cell ids;
    out-of-range neighbors point at the sentinel row ``n_cells``.

    With ``periodic=True`` they wrap around instead, on every axis with
    at least 3 cells (fewer would make a cell its own neighbor through
    the seam and double-count pairs; such axes stay non-periodic, which
    is right for the collapsed-z 2-D layout).  A 3-tuple of bools
    selects the axes."""
    nx, ny, nz = grid.dims
    ix, iy, iz = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    coords = np.stack([ix.ravel(), iy.ravel(), iz.ravel()], axis=1)  # [C,3]
    offsets = np.array(
        [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
    )  # [27,3]
    nbr = coords[:, None, :] + offsets[None, :, :]  # [C,27,3]
    dims = np.array(grid.dims)
    nbr = np.where(wrap_axes(grid, periodic), nbr % dims, nbr)
    valid = ((nbr >= 0) & (nbr < dims)).all(axis=2)
    lin = nbr[..., 0] * (ny * nz) + nbr[..., 1] * nz + nbr[..., 2]
    lin = np.where(valid, lin, grid.n_cells)  # sentinel
    return lin.astype(np.int32)


@functools.lru_cache(maxsize=16)
def cell_bounds(grid, device, dtype):
    """``(lo [3] of dtype, last cell index per axis [3] int64)`` of
    ``grid`` on ``device``, made once per grid, device and dtype (callers
    must not write to them): a step builds its cells without a
    host-to-device copy, which on the card would wait for the device."""
    lo = torch.tensor(grid.lo, dtype=dtype, device=device)
    hi_idx = torch.tensor(
        [d - 1 for d in grid.dims], dtype=torch.int64, device=device
    )
    return lo, hi_idx


def cell_id(x, grid):
    """Linear (x-major) cell id of each position, clipped into the grid."""
    lo, hi_idx = cell_bounds(grid, x.device, x.dtype)
    idx3 = torch.floor((x - lo) / grid.cell_size).to(torch.int64)
    idx3 = torch.minimum(torch.clamp(idx3, min=0), hi_idx)
    _, ny, nz = grid.dims
    return idx3[:, 0] * (ny * nz) + idx3[:, 1] * nz + idx3[:, 2]


class CellList(NamedTuple):
    """Dense cell decomposition of one particle set.

    ``order`` sorts particles by cell; ``cid``/``slot`` are each sorted
    particle's dense coordinates; ``gidx`` maps each slot to its
    position in the sorted order (N for empty slots); ``mask`` marks
    live slots; ``overflow`` counts particles dropped from neighbor sums
    (a 0-d device tensor); ``starts`` is each cell's first sorted
    position.
    """

    order: torch.Tensor  # [N] particle index in sorted order
    cid: torch.Tensor  # [N] cell id per sorted particle
    slot: torch.Tensor  # [N] slot per sorted particle (== capacity if dropped)
    gidx: torch.Tensor  # [n_cells+1, capacity] sorted-order gather map
    mask: torch.Tensor  # [n_cells+1, capacity] bool
    overflow: torch.Tensor  # [] int32
    starts: torch.Tensor  # [n_cells] first sorted position of each cell


class SpillCells(NamedTuple):
    """Second-tier dense layout: slots ``[K, K + k_spill)`` of each cell
    (same ``[n_cells + 1, k_spill]`` conventions as the main layout)."""

    gidx: torch.Tensor
    mask: torch.Tensor


def sorted_runs(cid, n_query):
    """Stable sort by cell id and the runs of the sorted order, with no
    map of the dense layout: ``(order, cid_s, slot, starts)``, each
    int64.  ``starts`` is each cell's first sorted position
    (``[n_query]``) and ``slot`` each sorted particle's (unclamped) slot
    within its cell: its position less its cell's start, one gather of
    ``starts``.  The reference takes the run starts from a ``cummax``
    scan instead, the same map, which on the card walks the row almost
    serially.

    Requires ``0 <= cid < n_query`` (not checked): :func:`cell_id` clips
    into the grid, and a caller that sorts dead slots into a sentinel
    cell counts that cell in ``n_query``."""
    n = cid.shape[0]
    dev = cid.device
    cid_s, order = torch.sort(cid, stable=True)
    starts = torch.searchsorted(
        cid_s, torch.arange(n_query, dtype=cid_s.dtype, device=dev)
    )
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    return order, cid_s, iota - starts.index_select(0, cid_s), starts


def _sorted_slot_map(cid, n_query, capacity, live_rows=None):
    """:func:`sorted_runs` and the sorted-order gather map.

    Returns ``(order, cid_s, valid, gidx, slot, starts)`` as in the
    reference: ``gidx[q, k]`` is the sorted position filling slot
    ``(q, k)`` (``n`` = empty) and ``slot`` is each sorted particle's
    (unclamped) slot within its cell.  ``live_rows`` is the count of
    leading rows that may hold live slots: rows past it (sentinel cells,
    such as the dead slots of a slab) map to empty.
    """
    n = cid.shape[0]
    order, cid_s, slot, starts = sorted_runs(cid, n_query)
    counts = torch.diff(starts, append=starts.new_full((1,), n))
    kslots = torch.arange(capacity, dtype=torch.int64, device=cid.device)
    valid = kslots[None, :] < torch.clamp(counts, max=capacity)[:, None]
    if live_rows is not None and live_rows < n_query:
        valid[live_rows:] = False
    gidx = torch.where(valid, starts[:, None] + kslots[None, :], n)
    return order, cid_s, valid, gidx, slot, starts


def _with_sentinel(gidx, valid, n):
    """Append the sentinel row (empty gather, dead mask)."""
    k = gidx.shape[1]
    gidx = torch.cat([gidx, gidx.new_full((1, k), n)])
    mask = torch.cat([valid, valid.new_zeros((1, k))])
    return gidx, mask


def build_cells(x, grid):
    """Assign particles to cells (one stable sort) -> :class:`CellList`."""
    n = x.shape[0]
    k = grid.capacity
    cid = cell_id(x, grid)
    order, cid_s, valid, gidx, slot, starts = _sorted_slot_map(
        cid, grid.n_cells, k
    )
    gidx, mask = _with_sentinel(gidx, valid, n)
    dropped = slot >= k
    return CellList(
        order=order,
        cid=cid_s,
        slot=torch.where(dropped, k, slot),
        gidx=gidx,
        mask=mask,
        overflow=dropped.sum().to(torch.int32),
        starts=starts,
    )


def build_cells_spill(x, grid, k_spill):
    """Two-tier cell assignment: main layout (slots ``< K``) plus a spill
    layout (slots ``[K, K + k_spill)``), from one sort.  Overflow counts
    particles past ``K + k_spill``; their slots are clamped there so
    :func:`gather_from_cells` with ``capacity=K + k_spill`` routes every
    retained particle to its tier."""
    n = x.shape[0]
    k = grid.capacity
    cid = cell_id(x, grid)
    order, cid_s, valid, gidx, slot, starts = _sorted_slot_map(
        cid, grid.n_cells, k
    )
    gidx, mask = _with_sentinel(gidx, valid, n)

    counts = torch.diff(starts, append=starts.new_full((1,), n))
    ks2 = k + torch.arange(k_spill, dtype=torch.int64, device=x.device)
    valid2 = ks2[None, :] < torch.clamp(counts, max=k + k_spill)[:, None]
    gidx2 = torch.where(valid2, starts[:, None] + ks2[None, :], n)
    gidx2, mask2 = _with_sentinel(gidx2, valid2, n)

    dropped = slot >= k + k_spill
    cells = CellList(
        order=order,
        cid=cid_s,
        slot=torch.where(dropped, k + k_spill, slot),
        gidx=gidx,
        mask=mask,
        overflow=dropped.sum().to(torch.int32),
        starts=starts,
    )
    return cells, SpillCells(gidx=gidx2, mask=mask2)


def scatter_to_cells(values, cells, grid, fill=0.0, gidx=None):
    """Lay per-particle ``values`` (particle order) out in the dense
    ``[n_cells+1, capacity, ...]`` layout (sentinel row stays ``fill``).
    Pass ``gidx=spill.gidx`` to lay out the spill tier instead."""
    pad = values.new_full((1,) + tuple(values.shape[1:]), fill)
    vs = torch.cat([values[cells.order], pad])
    return vs[cells.gidx if gidx is None else gidx]


def scatter_to_cells_soa(values, cells, grid, slot_base=0, capacity=None):
    """Cell-dense SoA layout ``[F, n_cells, K]`` (float32, contiguous) of
    ``[N, F]`` per-particle ``values``: the slot window ``[slot_base,
    slot_base + K)`` of each cell's sorted run (the spill tier is
    ``slot_base=K, capacity=k_spill``).  One gather per call; dead slots
    hold 0 (the reference leaves masked neighbor-run values there; only
    live slots carry meaning in either)."""
    n = values.shape[0]
    k = grid.capacity if capacity is None else capacity
    vs = values[cells.order].to(torch.float32)
    vs_t = torch.cat([vs, vs.new_zeros((1, vs.shape[1]))]).t().contiguous()
    counts = torch.diff(cells.starts, append=cells.starts.new_full((1,), n))
    js = slot_base + torch.arange(k, dtype=torch.int64, device=values.device)
    idx = torch.where(
        js[None, :] < counts[:, None], cells.starts[:, None] + js[None, :], n
    )
    return vs_t[:, idx]


def gather_from_cells(dense, cells, grid, capacity=None):
    """Gather per-slot ``dense`` values (``[n_cells+1, K, ...]``) back to
    particle order; dropped particles read the sentinel row.  For the
    two-tier layout pass the concatenated ``[n_cells+1, K + k_spill,
    ...]`` array with ``capacity=K + k_spill``."""
    kc = grid.capacity if capacity is None else capacity
    slot = torch.clamp(cells.slot, max=kc - 1)
    cid = torch.where(cells.slot >= kc, grid.n_cells, cells.cid)
    sorted_vals = dense[cid, slot]
    # the inverse permutation as a scatter: exact on a permutation
    inv = torch.empty_like(cells.order)
    inv[cells.order] = torch.arange(
        cells.order.shape[0], dtype=cells.order.dtype, device=cells.order.device
    )
    return sorted_vals[inv]
