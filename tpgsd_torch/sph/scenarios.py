"""SPH scenarios beyond the dam break (torch counterpart of
``tpgsd.sph.scenarios``).

Each scenario function returns initial state, grid, and parameters sized for a
stable run.  The lattices are built on the host exactly as the reference
builds them (bit-identical states, grids and parameters) and then placed
on ``device``.  ``hydrostatic_tank`` doubles as a quantitative physics
check: after settling, the pressure profile must match p(z) = rho0 * g *
(H - z).  ``still_box`` and ``taylor_green`` are the periodic workloads
(``make_step_fn(..., periodic=True)``).
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from .cells import auto_capacity, make_grid
from .step import SPHParams, SPHState


class Scenario(NamedTuple):
    state: SPHState
    grid: object  # CellGrid
    params: SPHParams
    box: tuple
    n: int
    n_fixed: int  # static boundary particles (first rows of state)


def _state(x0, v0, device):
    """Host float32 lattices as an :class:`SPHState` on ``device``."""
    return SPHState(
        x=torch.from_numpy(x0).to(device), v=torch.from_numpy(v0).to(device)
    )


def hydrostatic_tank(
    n_side=12,
    box=(1.0, 1.0, 1.0),
    fill_z=0.6,
    wall_layers=2,
    rho0=1000.0,
    capacity=64,
    device="cuda",
):
    """A tank of fluid at rest over a floor of boundary particles.

    The floor is ``wall_layers`` planes of static dummy particles below
    z=0 extended into the domain bottom; the fluid column settles into
    hydrostatic equilibrium.  Use with
    ``make_step_fn(..., n_fixed=scenario.n_fixed)``.

    Returns:
        :class:`Scenario`; boundary particles occupy the FIRST
        ``n_fixed`` rows of ``state.x``.
    """
    h_fluid = box[2] * fill_z
    dx = h_fluid / n_side
    h = 1.3 * dx
    support = 2.0 * h

    nx = max(1, int(round(box[0] / dx)))
    ny = max(1, int(round(box[1] / dx)))

    # floor: wall_layers planes at z = dx/2, 3dx/2, ... (inside the box)
    gx, gy = np.meshgrid(
        (np.arange(nx) + 0.5) * dx, (np.arange(ny) + 0.5) * dx, indexing="ij"
    )
    walls = []
    for layer in range(wall_layers):
        z = (layer + 0.5) * dx
        plane = np.stack(
            [gx.ravel(), gy.ravel(), np.full(gx.size, z)], axis=1
        )
        walls.append(plane)
    wall = np.concatenate(walls).astype(np.float32)

    # fluid column above the floor
    nz = max(1, int(round(h_fluid / dx)))
    gz = (np.arange(nz) + wall_layers + 0.5) * dx
    fx, fy, fz = np.meshgrid(
        (np.arange(nx) + 0.5) * dx, (np.arange(ny) + 0.5) * dx, gz,
        indexing="ij",
    )
    fluid = np.stack([fx.ravel(), fy.ravel(), fz.ravel()], axis=1).astype(
        np.float32
    )

    x0 = np.concatenate([wall, fluid])
    n_fixed = wall.shape[0]
    n = x0.shape[0]

    mass = rho0 * dx**3
    v_max = math.sqrt(2.0 * 9.81 * h_fluid)
    c0 = 10.0 * max(v_max, 1.0)
    dt = 0.25 * h / c0

    if capacity == "auto":
        capacity = auto_capacity(x0, (0.0, 0.0, 0.0), box, support)
    grid = make_grid((0.0, 0.0, 0.0), box, support, capacity)
    params = SPHParams(
        mass=float(mass),
        h=float(h),
        dt=float(dt),
        rho0=float(rho0),
        c0=float(c0),
        alpha=0.3,  # stronger damping settles the column faster
    )
    state = _state(x0, np.zeros_like(x0), device)
    return Scenario(
        state=state, grid=grid, params=params, box=box, n=n, n_fixed=n_fixed
    )


def still_box(n_side=8, box=(1.0, 1.0, 1.0), rho0=1000.0, capacity=64,
              device="cuda"):
    """A zero-gravity uniform lattice - the regression scenario for
    density normalization (interior density must come out near rho0)."""
    dx = box[2] / n_side
    h = 1.3 * dx
    support = 2.0 * h
    counts = [max(1, int(round(b / dx))) for b in box]
    axes = [(np.arange(c) + 0.5) * dx for c in counts]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    x0 = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1).astype(np.float32)

    mass = rho0 * dx**3
    if capacity == "auto":
        capacity = auto_capacity(x0, (0.0, 0.0, 0.0), box, support)
    grid = make_grid((0.0, 0.0, 0.0), box, support, capacity)
    params = SPHParams(
        mass=float(mass), h=float(h), dt=1e-4, rho0=float(rho0),
        gravity=(0.0, 0.0, 0.0),
    )
    state = _state(x0, np.zeros_like(x0), device)
    return Scenario(
        state=state, grid=grid, params=params, box=box, n=x0.shape[0], n_fixed=0
    )


def dam_break_2d(
    n_side=20,
    box=(2.0, 1.0),
    fill=(0.5, 0.8),
    capacity=64,
    rho0=1000.0,
    device="cuda",
):
    """Planar (2-D) dam break in the x-y plane, gravity along -y.

    State arrays stay ``[N, 3]`` (the framework's layout) with the z
    axis collapsed: every particle sits on the single z cell plane at
    ``z = cell/2`` and feels no z force (identical z coordinates =>
    zero z pair terms; gravity has no z component), so z is invariant.
    ``params.dim == 2`` switches the kernel normalizations to their
    2-D values; mass is per unit depth (``rho0 * dx^2``).
    """
    ly_fluid = box[1] * fill[1]
    dx = ly_fluid / n_side
    h = 1.3 * dx
    support = 2.0 * h

    counts = [max(1, int(round(box[d] * fill[d] / dx))) for d in range(2)]
    axes = [(np.arange(c) + 0.5) * dx for c in counts]
    gx, gy = np.meshgrid(*axes, indexing="ij")

    cap0 = 8 if capacity == "auto" else capacity
    grid = make_grid((0.0, 0.0, 0.0), (box[0], box[1], support), support, cap0)
    z0 = grid.cell_size / 2.0
    x0 = np.stack(
        [gx.ravel(), gy.ravel(), np.full(gx.size, z0)], axis=1
    ).astype(np.float32)
    if capacity == "auto":
        grid = grid._replace(
            capacity=auto_capacity(
                x0, (0.0, 0.0, 0.0), (box[0], box[1], support), support
            )
        )
    n = x0.shape[0]

    mass = rho0 * dx**2
    v_max = math.sqrt(2.0 * 9.81 * ly_fluid)
    c0 = 10.0 * max(v_max, 1.0)
    dt = 0.25 * h / c0

    params = SPHParams(
        mass=float(mass),
        h=float(h),
        dt=float(dt),
        rho0=float(rho0),
        c0=float(c0),
        gravity=(0.0, -9.81, 0.0),
        dim=2,
    )
    state = _state(x0, np.zeros_like(x0), device)
    return Scenario(
        state=state, grid=grid, params=params, box=box, n=n, n_fixed=0
    )


def still_box_2d(n_side=16, box=(1.0, 1.0), rho0=1000.0, capacity=64,
                 device="cuda"):
    """2-D zero-gravity uniform lattice - the density-normalization
    regression for ``dim=2`` (interior density must come out near rho0)."""
    dx = box[1] / n_side
    h = 1.3 * dx
    support = 2.0 * h
    counts = [max(1, int(round(b / dx))) for b in box]
    axes = [(np.arange(c) + 0.5) * dx for c in counts]
    gx, gy = np.meshgrid(*axes, indexing="ij")

    cap0 = 8 if capacity == "auto" else capacity
    grid = make_grid((0.0, 0.0, 0.0), (box[0], box[1], support), support, cap0)
    z0 = grid.cell_size / 2.0
    x0 = np.stack(
        [gx.ravel(), gy.ravel(), np.full(gx.size, z0)], axis=1
    ).astype(np.float32)
    if capacity == "auto":
        grid = grid._replace(
            capacity=auto_capacity(
                x0, (0.0, 0.0, 0.0), (box[0], box[1], support), support
            )
        )

    mass = rho0 * dx**2
    params = SPHParams(
        mass=float(mass), h=float(h), dt=1e-4, rho0=float(rho0),
        gravity=(0.0, 0.0, 0.0), dim=2,
    )
    state = _state(x0, np.zeros_like(x0), device)
    return Scenario(
        state=state, grid=grid, params=params, box=box, n=x0.shape[0], n_fixed=0
    )


def taylor_green(n_side=24, rho0=1000.0, U0=1.0, capacity=64, device="cuda"):
    """2-D Taylor-Green vortex in a fully periodic unit box.

    The classic smooth-decay validation flow: u = U0 sin(2 pi x)
    cos(2 pi y), v = -U0 cos(2 pi x) sin(2 pi y) on a periodic square.
    Run with ``make_step_fn(..., periodic=True)``; kinetic energy must
    decay monotonically (artificial viscosity) while the velocity
    field stays on the vortex mode, and density must hold ~rho0
    EVERYWHERE (no free surface, so any deficit is a periodic-pair
    bug, not physics).
    """
    dx = 1.0 / n_side
    h = 1.3 * dx
    support = 2.0 * h

    ax = (np.arange(n_side) + 0.5) * dx
    gx, gy = np.meshgrid(ax, ax, indexing="ij")

    cap0 = 8 if capacity == "auto" else capacity
    grid = make_grid((0.0, 0.0, 0.0), (1.0, 1.0, support), support, cap0)
    if grid.dims[0] < 3 or grid.dims[1] < 3:
        raise ValueError("n_side too small for a periodic grid")
    z0 = grid.cell_size / 2.0
    x0 = np.stack(
        [gx.ravel(), gy.ravel(), np.full(gx.size, z0)], axis=1
    ).astype(np.float32)
    if capacity == "auto":
        grid = grid._replace(
            capacity=auto_capacity(
                x0, (0.0, 0.0, 0.0), (1.0, 1.0, support), support
            )
        )

    two_pi = 2.0 * math.pi
    u = U0 * np.sin(two_pi * x0[:, 0]) * np.cos(two_pi * x0[:, 1])
    v = -U0 * np.cos(two_pi * x0[:, 0]) * np.sin(two_pi * x0[:, 1])
    v0 = np.stack([u, v, np.zeros_like(u)], axis=1).astype(np.float32)

    c0 = 10.0 * U0
    params = SPHParams(
        mass=float(rho0 * dx**2),
        h=float(h),
        dt=float(0.25 * h / c0),
        rho0=float(rho0),
        c0=float(c0),
        gravity=(0.0, 0.0, 0.0),
        dim=2,
    )
    state = _state(x0, v0, device)
    return Scenario(
        state=state, grid=grid, params=params, box=(1.0, 1.0),
        n=x0.shape[0], n_fixed=0,
    )
