"""Carry states, grids, parameters and scenarios over from the JAX
package.

The functions take the JAX package's ``SPHState``/``CellGrid``/
``SPHParams``/``Scenario`` (or anything with the same fields, numpy
arrays included)
by duck typing, so this module imports nothing of ``tpgsd.sph``.  They
let both packages step the same input.
"""

import numpy as np
import torch

from .cells import CellGrid
from .scenarios import Scenario
from .step import SPHParams, SPHState


def state_from_numpy(x, v, device, rho=None):
    """:class:`SPHState` on ``device`` from ``[N, 3]`` positions and
    velocities and, for continuity mode, ``[N]`` densities (numpy or any
    array ``numpy.asarray`` reads), as float32."""
    def put(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return SPHState(x=put(x), v=put(v), rho=None if rho is None else put(rho))


def grid_from_reference(grid):
    """The port's :class:`CellGrid` with the fields of ``grid``."""
    return CellGrid(
        lo=tuple(float(v) for v in grid.lo),
        cell_size=float(grid.cell_size),
        dims=tuple(int(d) for d in grid.dims),
        capacity=int(grid.capacity),
    )


def params_from_reference(params):
    """The port's :class:`SPHParams` with the fields of ``params``."""
    fields = {name: float(getattr(params, name)) for name in SPHParams._fields
              if name not in ("gravity", "dim")}
    return SPHParams(
        gravity=tuple(float(g) for g in params.gravity),
        dim=int(params.dim),
        **fields,
    )


def scenario_from_reference(scenario, device):
    """The port's :class:`Scenario` on ``device`` with the state, grid,
    parameters and sizes of ``scenario``."""
    return Scenario(
        state=state_from_numpy(scenario.state.x, scenario.state.v, device),
        grid=grid_from_reference(scenario.grid),
        params=params_from_reference(scenario.params),
        box=tuple(scenario.box),
        n=int(scenario.n),
        n_fixed=int(scenario.n_fixed),
    )
