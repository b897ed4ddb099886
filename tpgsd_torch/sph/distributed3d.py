"""3-D block decomposition of the SPH step over a ``(px, py, pz)`` mesh
(torch counterpart of ``tpgsd.sph.distributed3d``).

Shard ``(i, j, k)`` of a :func:`~tpgsd_torch.parallel.make_mesh3d` mesh
(shard ``(i * py + j) * pz + k``) owns the ``nxl x nyl x nzl`` cell block
at block coordinates ``(i, j, k)``.  It is the decomposition engine of
:mod:`tpgsd_torch.sph.distributed` cutting x, y and z: the halo
goes z, then y, then x, so all 26 neighbours' boundary cells arrive; a
particle hops x, then y, then z, so a corner mover arrives in one step;
every periodic axis wraps through its ring (no axis wraps locally, and
the pair passes see no wrap).
"""

from .distributed import _adaptive_step, _decomposed_step, _distribute
from .kernels import WendlandC2


def make_distributed3d_step_fn(
    grid,
    params,
    mesh,
    capacity=None,
    migrate_cap=None,
    kernel=WendlandC2,
    use_kernels="auto",
    n_fixed=0,
    periodic=False,
    compute_energy=False,
    xsph=0.0,
    density_renorm=False,
    surface_tension=0.0,
    spill="auto",
    density_mode="summation",
    delta_sph=0.1,
    _traced_dt=False,
):
    """Build the 3-D block-decomposed step over a ``(px, py, pz)`` mesh.

    As :func:`~tpgsd_torch.sph.distributed2d.make_distributed2d_step_fn`,
    with every entry of ``grid.dims`` a multiple of the mesh's extent on
    that axis, the policy resolved on the extended grid ``(nxl + 2, nyl
    + 2, nzl + 2)``, and ``periodic`` wrapping x, y and z through the
    rings (each needs at least 3 cells).

    Returns:
        ``step(state, dt=params.dt) -> (DistState, DistAux)`` with
        ``step.resolved``; no host sync.
    """
    return _decomposed_step(
        grid, params, mesh, (0, 1, 2), capacity=capacity,
        migrate_cap=migrate_cap, kernel=kernel, use_kernels=use_kernels,
        n_fixed=n_fixed, periodic=periodic, compute_energy=compute_energy,
        xsph=xsph, density_renorm=density_renorm,
        surface_tension=surface_tension, spill=spill,
        density_mode=density_mode, delta_sph=delta_sph,
        _traced_dt=_traced_dt,
    )


def make_adaptive_distributed3d_step_fn(grid, params, mesh, cfl=0.25,
                                        dt_min=0.0, dt_max=None, **kwargs):
    """CFL-adaptive variant of :func:`make_distributed3d_step_fn` (as the
    2-D one): ``step(state, dt) -> (DistState, DistAux, dt_next)``."""
    return _adaptive_step(
        make_distributed3d_step_fn(grid, params, mesh, _traced_dt=True,
                                   **kwargs),
        params, mesh, cfl, dt_min, dt_max)


def distribute_state_3d(state, grid, mesh, capacity=None):
    """Partition a global state onto a 3-D mesh by block ownership, as
    :func:`~tpgsd_torch.sph.distributed2d.distribute_state_2d` (shard
    ``(i * py + j) * pz + k`` holds block ``(i, j, k)``) -> ``(DistState,
    capacity)``."""
    return _distribute(state, grid, mesh, (0, 1, 2), capacity)
