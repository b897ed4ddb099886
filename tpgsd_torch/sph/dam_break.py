"""Dam-break scenario (torch counterpart of ``tpgsd.sph.dam_break``).

A block of fluid at rest in one corner of a box collapses under gravity.
The lattice is built on the host exactly as the reference builds it
(bit-identical positions, grid and parameters) and then placed on
``device``.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from .cells import auto_capacity, make_grid
from .step import SPHParams, SPHState


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
