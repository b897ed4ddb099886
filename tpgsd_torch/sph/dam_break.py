"""Dam-break scenario (torch counterpart of ``tpgsd.sph.dam_break``).

A block of fluid at rest in one corner of a box collapses under gravity.
By default the lattice is built on the host exactly as the reference
builds its host lattice (bit-identical positions, grid and parameters)
and then placed on ``device``; ``on_device=True`` builds it on
``device`` from ``torch.arange``, as the reference builds its iota
lattice.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from .cells import auto_capacity, make_grid
from .step import SPHParams, SPHState


def _lattice_capacity(grid, counts, dx, headroom):
    """``capacity="auto"`` of the lattice without its positions
    (``tpgsd.sph.dam_break``'s on-device sizing): per axis, cell ``j``
    spans ``[j c, (j + 1) c)`` and holds the lattice planes ``(i + 0.5)
    dx`` inside it, so the densest cell is the product of each axis's
    largest plane count, scanned over a few hundred cells."""
    m0 = 1
    for d in range(3):
        j = np.arange(grid.dims[d], dtype=np.float64)
        lo_i = np.maximum(np.ceil(j * grid.cell_size / dx - 0.5), 0)
        hi_i = np.minimum(np.ceil((j + 1) * grid.cell_size / dx - 0.5),
                          counts[d])
        m0 *= int(np.maximum(hi_i - lo_i, 0).max())
    return max(8, int(-(-headroom * m0 // 8) * 8))


class DamBreak(NamedTuple):
    state: SPHState
    grid: object  # CellGrid
    params: SPHParams
    box: tuple  # (lx, ly, lz) domain size
    n: int  # particle count


def dam_break(
    n_side=20,
    box=(2.0, 1.0, 1.0),
    fill=(0.5, 1.0, 0.8),
    spacing=None,
    capacity=64,
    rho0=1000.0,
    c0=None,
    capacity_headroom=1.5,
    device="cuda",
    on_device=False,
):
    """Build a dam-break initial condition on ``device``.

    Args:
        n_side: particles along the z edge of the fluid block.
        box: domain extents (lx, ly, lz).
        fill: fluid block extents as fractions of the box.
        spacing: particle spacing (default: fluid height / n_side).
        capacity: cell-list slot capacity; ``"auto"`` sizes it to the
            initial lattice occupancy times ``capacity_headroom``.
        rho0: rest density.
        c0: artificial sound speed (default 10x the peak fall speed).
        capacity_headroom: safety factor for ``capacity="auto"`` (1.15
            sizes the main tier of the two-tier spill layout).
        device: where the state tensors live (the card unless the caller
            asks for ``"cpu"``).
        on_device: build the lattice on ``device`` (no host meshgrid and
            no host-to-device copy of the positions) and size
            ``capacity="auto"`` from the lattice geometry, an exact scan
            over the cells of each axis.  The positions are ``(i + 0.5)
            dx`` in float32 there, in float64 rounded to float32 on the
            host: equal within 1e-6, not bit for bit; the grid and the
            capacity are the same.

    Returns:
        :class:`DamBreak` with ``n = prod(block_dims)`` particles.
    """
    lz_fluid = box[2] * fill[2]
    dx = spacing if spacing is not None else lz_fluid / n_side
    h = 1.3 * dx
    support = 2.0 * h

    counts = [max(1, int(round(box[d] * fill[d] / dx))) for d in range(3)]
    n = counts[0] * counts[1] * counts[2]

    mass = rho0 * dx**3
    v_max = math.sqrt(2.0 * 9.81 * lz_fluid)
    if c0 is None:
        c0 = 10.0 * max(v_max, 1.0)
    dt = 0.25 * h / c0  # CFL on the sound speed

    if on_device:
        if capacity == "auto":
            capacity = _lattice_capacity(
                make_grid((0.0, 0.0, 0.0), box, support, 8), counts, dx,
                capacity_headroom,
            )
        # the reference's iota lattice: particle i at (ix, iy, iz) of the
        # x-major block, at (idx + 0.5) dx in float32
        cy, cz = counts[1], counts[2]
        i = torch.arange(n, dtype=torch.int32, device=device)
        ix = i // (cy * cz)
        rem = i - ix * (cy * cz)
        iy = rem // cz
        iz = rem - iy * cz
        x = (torch.stack([ix, iy, iz], dim=1).to(torch.float32) + 0.5) * dx
    else:
        axes = [(np.arange(c) + 0.5) * dx for c in counts]
        gx, gy, gz = np.meshgrid(*axes, indexing="ij")
        x0 = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1).astype(
            np.float32
        )
        if capacity == "auto":
            capacity = auto_capacity(
                x0, (0.0, 0.0, 0.0), box, support, headroom=capacity_headroom
            )
        x = torch.from_numpy(x0).to(device)
    state = SPHState(x=x, v=torch.zeros_like(x))

    grid = make_grid((0.0, 0.0, 0.0), box, support, capacity)
    params = SPHParams(
        mass=float(mass), h=float(h), dt=float(dt), rho0=float(rho0), c0=float(c0)
    )
    return DamBreak(state=state, grid=grid, params=params, box=box, n=n)
